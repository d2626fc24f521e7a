"""End-to-end LM training with the PyTorch port (the counterpart of
``examples/train_lm.py``): ``repro_torch.launch.train`` on synthetic
Markov tokens, with checkpoints and ``--resume``.

Default: the tiny llama3.2 variant. ``--full`` trains a ~100M-param
llama-family model (8 layers × 768, 12 heads, 32k vocab). Runs on the
card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py [--full] \\
        [--steps 300] [--resume] [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import ARCHS
from repro_torch.launch import train as train_launcher


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M-param model instead of the tiny variant")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)

    if args.full:
        # ~100M llama-family config (8L × 768 × 12H, 32k vocab)
        base = ARCHS["llama3.2-1b"]
        cfg = dataclasses.replace(
            base, name="llama-100m", n_layers=8, d_model=768, n_heads=12,
            n_kv_heads=4, d_head=64, d_ff=2048, vocab=32000,
            param_dtype="float32", tie_embeddings=True)
        ARCHS[cfg.name] = cfg        # registered so the launcher finds it
        argv = ["--arch", cfg.name, "--steps", str(args.steps or 300),
                "--seq", "512", "--batch", "8", "--checkpoint-dir",
                args.checkpoint_dir or "checkpoints/llama-100m"]
    else:
        argv = ["--arch", "llama3.2-1b", "--tiny",
                "--steps", str(args.steps or 100), "--seq", "128",
                "--batch", "8", "--checkpoint-dir",
                args.checkpoint_dir or "checkpoints/tiny-lm"]
    argv += ["--device", args.device, "--lr", str(args.lr)]
    if args.resume:
        argv.append("--resume")
    return train_launcher.main(argv)


if __name__ == "__main__":
    main()
