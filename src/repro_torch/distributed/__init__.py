"""Placement across a device mesh for sharded int8 serving (see
``repro_torch.distributed.sharding``)."""
