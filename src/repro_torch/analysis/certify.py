"""CLI: check the committed ``ANALYSIS_ranges.json`` with the port's
range certifier.

    PYTHONPATH=src python -m repro_torch.analysis.certify

The port's counterpart of ``repro.analysis.certify``, read-only: it
recomputes the report over the same sweep and reaches the same verdict
on the committed file, which the JAX package writes and this module
never does. Three checks, each of which fails the run:

1. **Coverage** — every served config (F(2,3)/F(4,3)/F(6,3) ×
   canonical/legendre × hadamard_bits {None, 8, 9} at the ResNet-18
   channel widths) is PROVED.
2. **Negative control** — the seeded overflow config (F(6,3) canonical
   at Cin = 2^18) comes back UNSAFE.
3. **Drift** — the recomputed report equals the committed one as parsed
   JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.ranges import amplifications, certify_config

__all__ = ["SWEEP_M", "SWEEP_BASES", "SWEEP_BITS", "SWEEP_CIN",
           "NEGATIVE_CONTROL", "build_report", "diff_reports", "main"]

DEFAULT_JSON = Path(__file__).resolve().parents[3] / "ANALYSIS_ranges.json"

SWEEP_M = (2, 4, 6)
SWEEP_R = 3
SWEEP_BASES = ("canonical", "legendre")
SWEEP_BITS = (None, 8, 9)
SWEEP_CIN = (64, 128, 256, 512)          # ResNet-18 channel widths
#: Past the int32 accumulator budget (Cin > (2^31 - 1) / 127^2): must be
#: refused.
NEGATIVE_CONTROL = {"m": 6, "r": 3, "base": "canonical",
                    "hadamard_bits": 8, "cin": 2 ** 18}
_AMP_KEYS = ("BT", "G", "AT", "CinvT", "input_composed", "weight_composed",
             "output_composed", "input_staged", "weight_staged",
             "output_staged")


def _row(m: int, r: int, base: str, bits, cin: int) -> dict:
    rep = certify_config(m, r, base, bits, cin)
    acc = rep.stage("gemm_accumulator")
    out = rep.stage("output")
    return {
        "m": m, "r": r, "base": base, "hadamard_bits": bits, "cin": cin,
        "int32_safe": rep.int32_safe,
        "hadamard_safe": rep.hadamard_safe,
        "proved": rep.proved,
        "acc_bound": int(acc.bound),
        "acc_bits": int(acc.bits),
        "output_log2_growth": round(out.bits, 4),
    }


def build_report() -> dict:
    """The report, in the committed file's schema (every value from
    exact rational arithmetic, so it is deterministic)."""
    amp_table = {}
    for m in SWEEP_M:
        for base in SWEEP_BASES:
            amp = amplifications(m, SWEEP_R, base)
            amp_table[f"F({m},{SWEEP_R})/{base}"] = {
                k: {"value": round(float(v), 6), "exact": str(v)}
                for k, v in sorted(amp.items()) if k in _AMP_KEYS}
    rows = [_row(m, SWEEP_R, base, bits, cin)
            for m in SWEEP_M for base in SWEEP_BASES
            for bits in SWEEP_BITS for cin in SWEEP_CIN]
    nc = NEGATIVE_CONTROL
    control = _row(nc["m"], nc["r"], nc["base"], nc["hadamard_bits"],
                   nc["cin"])
    return {"schema": 1, "amplification": amp_table, "rows": rows,
            "negative_control": control}


def diff_reports(committed, computed, path: str = "") -> list[str]:
    """Every place two parsed reports differ, as readable paths."""
    if type(committed) is not type(computed):
        return [f"{path}: type {type(committed).__name__} != "
                f"{type(computed).__name__}"]
    if isinstance(computed, dict):
        out = []
        for k in sorted(set(committed) | set(computed)):
            if k not in committed:
                out.append(f"{path}.{k}: missing from committed report")
            elif k not in computed:
                out.append(f"{path}.{k}: no longer computed")
            else:
                out.extend(diff_reports(committed[k], computed[k],
                                        f"{path}.{k}"))
        return out
    if isinstance(computed, list):
        if len(committed) != len(computed):
            return [f"{path}: length {len(committed)} != {len(computed)}"]
        return [d for i, (a, b) in enumerate(zip(committed, computed))
                for d in diff_reports(a, b, f"{path}[{i}]")]
    if committed != computed:
        return [f"{path}: committed {committed!r} != computed {computed!r}"]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.certify",
        description="Check the committed range report (read-only).")
    ap.add_argument("--json", type=Path, default=DEFAULT_JSON,
                    help=f"committed report (default {DEFAULT_JSON})")
    args = ap.parse_args(argv)

    report = build_report()
    rc = 0
    unproved = [r for r in report["rows"] if not r["proved"]]
    for r in unproved:
        print(f"certify: UNSAFE served config: F({r['m']},{r['r']}) "
              f"{r['base']} bits={r['hadamard_bits']} Cin={r['cin']}")
    if unproved:
        rc = 1
    if report["negative_control"]["proved"]:
        print(f"certify: BROKEN — the seeded overflow control "
              f"({NEGATIVE_CONTROL}) was proved safe")
        rc = 2
    if not args.json.exists():
        print(f"certify: {args.json} missing")
        return max(rc, 1)
    drift = diff_reports(json.loads(args.json.read_text()), report)
    for d in drift[:20]:
        print(f"certify: drift {d}")
    if drift:
        print(f"certify: {args.json} differs from the port's certifier "
              f"in {len(drift)} place(s)")
        return max(rc, 1)
    print(f"certify: {len(report['rows'])} served configs PROVED, "
          "negative control refused, committed report matches")
    return rc


if __name__ == "__main__":
    sys.exit(main())
