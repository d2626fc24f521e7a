"""family → model implementation dispatch (the port's counterpart of
``repro.models.registry``)."""
from __future__ import annotations

from repro_torch.models import rglru, rwkv6, transformer

__all__ = ["get_model"]

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "audio": transformer,
    "vlm": transformer,
    "hybrid": rglru,
    "ssm": rwkv6,
}


def get_model(cfg):
    """The module implementing param_specs/forward/loss_fn/prefill/
    init_cache/decode_step for this config's family."""
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} "
                         f"(cnn lives in repro_torch.models.resnet)") from None
