"""Batched LM serving demo on the PyTorch port: prefill a prompt batch,
then greedy decode with the per-family caches (KV, ring-buffer KV +
RG-LRU state + conv tail, or the RWKV-6 matrix state), through
``repro_torch.launch.steps.generate``. The counterpart of
``examples/serve_lm.py``, on the tiny variant of the arch.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch rwkv6-7b] \\
        [--device cpu]

Runs on the card unless ``--device cpu``; without a card the default
raises. ``--model-parallel M`` serves over the JAX launcher's mesh,
``make_mesh_for(<devices>, M)``, of every card (or the CPU), or of
``--host-devices N`` logical devices laid over them.
"""
import argparse

from repro_torch.configs import ARCHS, tiny_variant
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import batch_at
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import logical_devices, make_mesh_for
from repro_torch.launch.steps import generate, init_lm_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="lay N logical devices over the cards (or the "
                         "CPU) for the mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = tiny_variant(ARCHS[args.arch])
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    run = RunConfig(model=cfg, seq_len=args.prompt_len + args.decode_len,
                    global_batch=args.batch)
    mesh = make_mesh_for(len(logical_devices(dev, args.host_devices)),
                         args.model_parallel, device=dev,
                         host_devices=args.host_devices)
    params = init_lm_params(cfg, 0, mesh=mesh)
    inputs = batch_at(cfg, args.prompt_len, args.batch, 0, mode="prefill",
                      device=dev)
    out = generate(run, params, inputs, args.decode_len, mesh=mesh)
    decode_s = sum(out["decode_ms"]) / 1e3
    print(f"[serve-lm] {cfg.name} on a {mesh.shape} mesh over {dev}: "
          f"prefill {args.prompt_len} tok × {args.batch} seqs in {out['prefill_ms']:.1f} ms; decode "
          f"{args.decode_len} steps in {decode_s * 1e3:.1f} ms "
          f"({args.decode_len * args.batch / max(decode_s, 1e-9):.1f} "
          f"tok/s; {out['timer']})")
    print("[serve-lm] sample continuation:", out["tokens"][0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
