#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100, sm_90a) and the CUDA toolkit; imports
nothing of JAX and nothing of the JAX package. Phases, each of which
fails the run:

1. device   — name, capability (9, 0), power limit, nvcc and torch CUDA;
2. build    — compile every kernel under ``src/repro_torch/csrc`` with
              nvcc (``-Xptxas -v`` printed) and time it; count the
              tensor-core MMA (and dp4a) instructions in the SASS of K4
              and K5 (``cuobjdump -sass``), none allowed to have 0 MMA;
3. kernels  — each kernel against its plain PyTorch version on the card
              at the main path's shapes (ResNet-18 width 1.0, B = 256,
              F(4,3) Legendre, 9-bit Hadamard), plus F(6,3), F(2,3),
              canonical F(4,3), ragged Cin/T/Cout and K4 with the
              requant off: integer outputs and K4 bit for bit, K3 within
              1e-6 of its max; K5 at the llama3.2-1b projection shapes
              (prefill M = 2048 and decode M = 8), ragged shapes (the
              predicated path, with and without split K), bf16 outputs
              and saturated sums past 2^24: bit for bit;
4. main     — ``repro_torch.launch.infer_resnet`` at width 1.0, batch
              256, 2 calibration steps: pack → calibrate → checkpoint →
              restore → serve fused and staged, its fused-vs-staged gate
              against the fp32 ``winograd_fp`` network; launch counts read
              around it (K1–K4 > 0, K4 14 per fused forward); then
              ``ops.q8_linear`` over the seven projections of one
              llama3.2-1b layer at M = 2048, its K5 launches read around
              it and its error against fp32 ``x @ w`` gated;
5. times    — CUDA-event time of each kernel at each main-path shape
              beside its bound, its plain version and a library yardstick
              (cuDNN ``F.conv2d``, ``torch._int_mm``; the port calls
              neither), K4's epilogue floor (its bitwise fp32 sandwich
              operations at 33.5 T instructions/s), and fused images/s
              at B = 256;
6. train    — ``repro_torch.launch.train_resnet_qat`` at width 1.0, batch
              256, F(4,3) Legendre, flex, 9-bit Hadamard, 10 steps: every
              loss finite, every parameter, the flex matrices and the
              BatchNorm running statistics changed; ms per step, images/s
              and peak memory.

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_FLOP_S = 67e12
# fp32 instructions per second outside the tensor cores: an FMA counts as
# two of the 67 TFLOP/s, a lone multiply or add as one instruction
FP32_INSTR_S = FP32_FLOP_S / 2

FP32_REL = 1e-6
BATCH = 256
# The 14 Winograd convs of one ResNet-18 forward at width 1.0, 32x32:
# (name, tiles T, Cin, Cout, spatial H, count per forward)
LAYERS = [("stem", 64 * BATCH, 3, 64, 32, 1),
          ("s0", 64 * BATCH, 64, 64, 32, 4),
          ("s1", 16 * BATCH, 128, 128, 16, 3),
          ("s2", 4 * BATCH, 256, 256, 8, 3),
          ("s3", BATCH, 512, 512, 4, 3)]
TPU_KERNELS = {
    "input_transform": ("src/repro_torch/csrc/wino_transform.cu",
                        "src/repro/kernels/wino_transform.py:147"),
    "wino_gemm": ("src/repro_torch/csrc/wino_gemm.cu",
                  "src/repro/kernels/wino_gemm.py:222"),
    "output_transform": ("src/repro_torch/csrc/wino_transform.cu",
                         "src/repro/kernels/wino_transform.py:201"),
    "fused_gemm_output": ("src/repro_torch/csrc/fused_serve.cu",
                          "src/repro/kernels/fused_serve.py:152"),
    "q8_matmul": ("src/repro_torch/csrc/q8_matmul.cu",
                  "src/repro/kernels/q8_matmul.py:76"),
}
SERVING = ("input_transform", "wino_gemm", "output_transform",
           "fused_gemm_output")
# The seven projections of one llama3.2-1b decoder layer (d_model 2048,
# 32 query / 8 key-value heads of 64, d_ff 8192): name, K, N.
LLAMA_PROJ = [("q", 2048, 2048), ("k", 2048, 512), ("v", 2048, 512),
              ("o", 2048, 2048), ("gate", 2048, 8192), ("up", 2048, 8192),
              ("down", 8192, 2048)]
Q8_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
PREFILL_M, DECODE_M = 4 * 512, 8
TRAIN_STEPS = 10
# Tensor-core MMA and dp4a instructions in SASS (mma.sync s8 -> IMMA,
# wgmma -> *GMMA)
SASS_MMA = ("IMMA", "HMMA", "IGMMA", "HGMMA", "QGMMA")
SASS_DP4A = ("IDP.4A", "IDP4A")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time per call of ``fn()`` spent in kernels whose name holds
    ``kernel``, from the profiler: what back-to-back event timing hides
    where a call's host work outlasts its kernel (a decode-sized K5)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(v for k, v in device_ms_by_kernel(prof, iters).items()
               if kernel in k)


def device_ms_by_kernel(prof, per: int = 1) -> dict:
    """Device time by kernel name (ms, divided by ``per``) from a
    ``torch.profiler`` run: device events only, since a CPU op repeats
    its kernels' time."""
    from torch.autograd import DeviceType
    by_kernel: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3 / per
    return by_kernel


def sass_counts(lib: str) -> dict:
    """Per kernel function of a built library: its tensor-core MMA and
    dp4a instructions, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"mma": 0, "dp4a": 0}
        elif fn is not None and "/*" in line:
            ins = line.split("*/", 1)[-1]
            if any(f" {m}." in ins or f" {m} " in ins for m in SASS_MMA):
                counts[fn]["mma"] += 1
            if any(d in ins for d in SASS_DP4A):
                counts[fn]["dp4a"] += 1
    return counts


def epilogue_ops(n: int, m: int, changes_base: bool) -> int:
    """fp32 multiplies and adds K4's epilogue does per (tile, channel):
    the rq (or deq) scale of each position and the sandwiches in their
    bitwise order (unrolled for n <= 6, two contractions for n = 8),
    none fused."""
    def sandwich(ni, no):
        if ni <= 6:
            return no * no * (2 * ni * ni - 1)
        return no * ni * (2 * ni - 1) + no * no * (2 * ni - 1)
    return n * n + (sandwich(n, n) if changes_base else 0) + sandwich(n, m)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run it from the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.winograd import WinogradSpec
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_serve as fs
    from repro_torch.kernels import q8_matmul as q8
    from repro_torch.kernels import wino_gemm as wg
    from repro_torch.kernels import wino_transform as wt
    from repro_torch.launch import infer_resnet, train_resnet_qat

    report: dict = {}
    dev = torch.device("cuda")

    # 1. device -------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"device {name}, capability {cap}, count "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}")
    log(f"nvcc: {nvcc[-1]}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    if cap != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a")
    report["device"] = {"name": name, "smi": smi, "nvcc": nvcc[-1],
                        "torch": torch.__version__}

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {built} in {report['build_s']:.1f}s ({len(_build.SOURCES)} "
        f"nvcc processes in parallel)")
    spills = []
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():   # kernel, registers, smem, spills
            if any(w in line for w in ("entry function", "Used", "spill",
                                       "warning")):
                log(f"  {src}: {line.strip()}")
            if "spill stores" in line and "0 bytes spill stores, 0 bytes " \
                    "spill loads" not in line:
                spills.append(f"{src}: {line.strip()}")
    if spills:
        fail(f"register spills: {spills}")
    report["sass"] = {}
    for src, kernel in (("fused_serve", "fused_kernel"),
                        ("q8_matmul", "q8_wgmma_kernel")):
        counts = {f: c for f, c in
                  sass_counts(str(_build._target(src))).items()
                  if kernel in f}
        report["sass"][src] = counts
        for f, c in counts.items():
            log(f"  SASS {src} {f[-60:]}: {c['mma']} tensor-core MMA, "
                f"{c['dp4a']} dp4a")
        if not counts or any(c["mma"] == 0 for c in counts.values()):
            fail(f"{src}: a {kernel} instantiation has no tensor-core MMA "
                 f"instruction in its SASS ({counts})")

    # 3. kernels against their plain versions -------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in TPU_KERNELS}

    def inputs(spec, T, cin, cout):
        n = spec.n
        P = n * n
        tiles = torch.randn((T, cin, n, n), generator=gen, device=dev)
        in_s = ops.scales_from_abs_max(ops._tiles_abs_max(tiles, spec))
        uq = torch.randint(-127, 128, (P, cin, cout), generator=gen,
                           device=dev, dtype=torch.int8)
        w_s = torch.rand((P, 1), generator=gen, device=dev) * 1e-2 + 1e-3
        return tiles, in_s, uq, in_s * w_s

    def check(spec, T, cin, cout, bits, label):
        o = ops._operands(spec, dev)
        cb, m = spec.changes_base, spec.m
        tiles, in_s, uq, deq = inputs(spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s,
                                changes_base=cb)
        xq_p = wt.input_transform_plain(tiles, o["CinvT"], o["BPT"], in_s,
                                        changes_base=cb)
        acc = wg.wino_gemm(xq, uq)
        acc_p = wg.wino_gemm_plain(xq, uq)
        amax = (acc.float() * deq[:, :, None]).abs().amax(dim=(1, 2))
        rq = ops._hadamard_rq(amax, bits)
        hq = wg.wino_gemm(xq, uq, requant_bits=bits, deq=deq, rq=rq)
        hq_p = wg.wino_gemm_plain(xq, uq, bits, deq, rq)
        y3 = wt.output_transform(hq, rq, o["CinvT"], o["APT"], m=m,
                                 changes_base=cb)
        y3_p = wt.output_transform_plain(hq, rq, o["CinvT"], o["APT"], m=m,
                                         changes_base=cb)
        y4 = fs.fused_gemm_output(xq, uq, deq, rq, o["CinvT"], o["APT"], m=m,
                                  requant_bits=bits, changes_base=cb)
        y4_p = fs.fused_gemm_output_plain(xq, uq, deq, rq, o["CinvT"],
                                          o["APT"], m=m, requant_bits=bits,
                                          changes_base=cb)
        torch.cuda.synchronize()
        res = {}
        for k, (a, b) in {"input_transform": (xq, xq_p),
                          "wino_gemm": (acc, acc_p),
                          "wino_gemm_requant": (hq, hq_p)}.items():
            d = int((a.long() - b.long()).abs().max())
            res[k] = d
            if d != 0:
                fail(f"{label}: {k} differs from its plain version by {d}")
        for k, (a, b) in {"output_transform": (y3, y3_p),
                          "fused_gemm_output": (y4, y4_p),
                          "fused_vs_staged_kernels": (y4, y3)}.items():
            d = float((a - b).abs().max())
            r = d / max(float(b.abs().max()), 1e-30)
            res[k] = d
            res[k + "_rel"] = r
            if not r <= FP32_REL:
                fail(f"{label}: {k} max|kernel - plain| / max|plain| = {r}")
        errs["input_transform"] = max(errs["input_transform"],
                                      res["input_transform"])
        errs["wino_gemm"] = max(errs["wino_gemm"], res["wino_gemm"],
                                res["wino_gemm_requant"])
        errs["output_transform"] = max(errs["output_transform"],
                                       res["output_transform"])
        errs["fused_gemm_output"] = max(errs["fused_gemm_output"],
                                        res["fused_gemm_output"])
        if not torch.equal(y4, y4_p):
            fail(f"{label}: K4 is not bit for bit with its plain version")
        log(f"{label}: Xq, int32 GEMM, requant plane and K4 bitwise; fp32 "
            f"rel err K3 {res['output_transform_rel']:.3g}, K4 "
            f"{res['fused_gemm_output_rel']:.3g}, K4 vs staged kernels "
            f"{res['fused_vs_staged_kernels_rel']:.3g}")
        return res

    main_spec = WinogradSpec(m=4, r=3, base="legendre",
                             quant=QuantConfig(hadamard_bits=9))
    report["checks"] = {}
    for lname, T, cin, cout, _, _ in LAYERS:
        report["checks"][lname] = check(main_spec, T, cin, cout, 9,
                                        f"F(4,3) legendre {lname} T={T} "
                                        f"Cin={cin} Cout={cout}")
    report["checks"]["f63"] = check(WinogradSpec(m=6, r=3, base="legendre"),
                                    4 * BATCH, 128, 128, 9,
                                    "F(6,3) legendre T=1024 C=128")
    report["checks"]["canonical"] = check(
        WinogradSpec(m=4, r=3, base="canonical"), 16 * BATCH, 128, 128, 8,
        "F(4,3) canonical 8-bit T=4096 C=128")
    # K4's edges: ragged Cin, T and Cout; n = 4; the requant off
    report["checks"]["ragged"] = check(main_spec, 1000, 19, 45, 9,
                                       "F(4,3) legendre T=1000 Cin=19 "
                                       "Cout=45")
    report["checks"]["f23"] = check(WinogradSpec(m=2, r=3, base="legendre"),
                                    4 * BATCH, 64, 200, 9,
                                    "F(2,3) legendre T=1024 Cin=64 Cout=200")
    for spec, T, cin, cout in ((main_spec, 16 * BATCH, 128, 128),
                               (WinogradSpec(m=6, r=3, base="legendre"),
                                BATCH, 512, 100)):
        o = ops._operands(spec, dev)
        tiles, in_s, uq, deq = inputs(spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s)
        one = torch.ones_like(deq)
        y4 = fs.fused_gemm_output(xq, uq, deq, one, o["CinvT"], o["APT"],
                                  m=spec.m)
        y4_p = fs.fused_gemm_output_plain(xq, uq, deq, one, o["CinvT"],
                                          o["APT"], m=spec.m)
        torch.cuda.synchronize()
        label = f"K4 requant off F({spec.m},3) T={T} Cin={cin} Cout={cout}"
        d = float((y4 - y4_p).abs().max())
        errs["fused_gemm_output"] = max(errs["fused_gemm_output"], d)
        if not torch.equal(y4, y4_p):
            fail(f"{label}: differs from its plain version by {d}")
        log(f"{label}: bit for bit with its plain version")
        del tiles, xq, y4, y4_p

    def q8_inputs(M, K, N, saturated=False):
        if saturated:   # ±127, signs aligned: |acc| > 2^24, fp32 rounds
            xq = torch.where(torch.rand((M, K), generator=gen, device=dev)
                             < 0.02, -127, 127).to(torch.int8)
            xq[:, 0] = 126
            sign = torch.where(torch.arange(N, device=dev) % 2 == 1, -1, 1)
            wq = (torch.where(torch.rand((K, N), generator=gen, device=dev)
                              < 0.02, -127, 127) * sign).to(torch.int8)
            sx = torch.tensor([0.0137], device=dev)
            sw = torch.rand((N,), generator=gen, device=dev) * 0.02 + 1e-4
            return xq, wq, sx, sw
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((1,), generator=gen, device=dev) * 0.02 + 1e-3
        sw = torch.rand((N,), generator=gen, device=dev) * 0.02 + 1e-4
        return xq, wq, sx, sw

    q8_cases = [(M, K, N, torch.float32) for K, N in Q8_SHAPES
                for M in (PREFILL_M, DECODE_M)]
    q8_cases = [c + (False,) for c in q8_cases]
    # the predicated path (K, N not multiples of 16), with and without
    # split K; split K at N = 512; bf16; saturated sums past 2^24
    q8_cases += [(130, 100, 70, torch.float32, False),
                 (33, 1000, 24, torch.float32, False),
                 (PREFILL_M, 2048, 2048, torch.bfloat16, False),
                 (PREFILL_M, 2048, 512, torch.bfloat16, False),
                 (PREFILL_M, 8192, 2048, torch.float32, True),
                 (DECODE_M, 8192, 2048, torch.bfloat16, True)]
    report["checks"]["q8_matmul"] = {}
    for M, K, N, odt, sat in q8_cases:
        xq, wq, sx, sw = q8_inputs(M, K, N, sat)
        a = q8.q8_matmul(xq, wq, sx, sw, out_dtype=odt)
        b = q8.q8_matmul_plain(xq, wq, sx, sw, out_dtype=odt)
        torch.cuda.synchronize()
        d = float((a.float() - b.float()).abs().max())
        label = (f"K5 M={M} K={K} N={N} {str(odt).split('.')[-1]}"
                 f"{' saturated' if sat else ''} "
                 f"split {q8.q8_splits(M, N, K)}")
        report["checks"]["q8_matmul"][label] = d
        errs["q8_matmul"] = max(errs["q8_matmul"], d)
        if a.dtype != odt or not torch.equal(a, b):
            fail(f"{label}: differs from its plain version by {d}")
        log(f"{label}: bit for bit with its plain version")
    del gen

    # 4. main path ----------------------------------------------------------
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as ckpt:
        out = infer_resnet.main(["--width", "1.0", "--batch", str(BATCH),
                                 "--calib-steps", "2", "--ckpt-dir", ckpt,
                                 "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    report["main_path"] = out
    report["launches"] = launches
    log(f"serving path launches: {launches}")
    for k in SERVING:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    # 14 Winograd convs per forward: calibration and staged/dynamic serving
    # run K1 → K2 → K3, fused serving K1 → K4
    staged = out["calib_forwards"] + out["staged_forwards"] + \
        out["dynamic_forwards"]
    want = {"input_transform": 14 * (staged + out["fused_forwards"]),
            "wino_gemm": 14 * staged, "output_transform": 14 * staged,
            "fused_gemm_output": 14 * out["fused_forwards"], "q8_matmul": 0}
    if launches != want:
        fail(f"serving-path launches {launches}, expected {want}")

    # the q8_linear path: one llama3.2-1b layer's projections, prefill
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = {K: torch.randn((4, PREFILL_M // 4, K), generator=gen, device=dev)
          for K in {k for _, k, _ in LLAMA_PROJ}}
    ws = {nm: torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
          for nm, K, N in LLAMA_PROJ}
    _build.reset_launches()
    ys = {nm: ops.q8_linear(xs[K], ws[nm]) for nm, K, _ in LLAMA_PROJ}
    torch.cuda.synchronize()
    q8_launches = dict(_build.LAUNCHES)
    log(f"q8_linear path launches: {q8_launches}")
    if q8_launches["q8_matmul"] != len(LLAMA_PROJ) or \
            any(q8_launches[k] for k in SERVING):
        fail(f"q8_linear path launches {q8_launches}, expected "
             f"q8_matmul {len(LLAMA_PROJ)} and nothing else")
    launches["q8_matmul"] = q8_launches["q8_matmul"]
    report["q8_linear_rel"] = {}
    for nm, K, N in LLAMA_PROJ:
        ref = xs[K] @ ws[nm]
        y = ys[nm]
        r = float((y - ref).norm() / ref.norm())
        report["q8_linear_rel"][nm] = r
        if tuple(y.shape) != (4, PREFILL_M // 4, N) or \
                not bool(torch.isfinite(y).all()) or not r < 0.05:
            fail(f"q8_linear {nm}: shape {tuple(y.shape)}, rel error {r} "
                 f"against fp32 x @ w")
    log("q8_linear rel error vs fp32 x @ w: " + ", ".join(
        f"{k} {v:.4f}" for k, v in report["q8_linear_rel"].items()))
    del xs, ws, ys, gen

    # 5. times --------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    o = ops._operands(main_spec, dev)
    P, m = main_spec.n ** 2, main_spec.m
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0}
           for k in TPU_KERNELS}
    layer_times = {}
    for lname, T, cin, cout, hw, count in LAYERS:
        tiles, in_s, uq, deq = inputs(main_spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s)
        acc = wg.wino_gemm(xq, uq)
        amax = (acc.float() * deq[:, :, None]).abs().amax(dim=(1, 2))
        rq = ops._hadamard_rq(amax, 9)
        hq = wg.wino_gemm(xq, uq, requant_bits=9, deq=deq, rq=rq)
        n = main_spec.n
        # bytes each function must move; operations in the least-work
        # (separable) form of the sandwiches, or the GEMM's 2·M·K·N
        sand = lambda ni, no: 2 * (no * ni * ni + no * no * ni)  # noqa: E731
        calls = {
            "input_transform": (
                lambda: wt.input_transform(tiles, o["CinvT"], o["BPT"],
                                           in_s),
                lambda: wt.input_transform_plain(tiles, o["CinvT"],
                                                 o["BPT"], in_s),
                T * cin * n * n * 4 + P * T * cin,
                T * cin * 2 * sand(n, n), FP32_FLOP_S, None),
            "wino_gemm": (
                lambda: wg.wino_gemm(xq, uq, requant_bits=9, deq=deq, rq=rq),
                lambda: wg.wino_gemm_plain(xq, uq, 9, deq, rq),
                P * T * cin + P * cin * cout + 4 * P * T * cout,
                2 * P * T * cin * cout, INT8_OPS_S, "int_mm"),
            "output_transform": (
                lambda: wt.output_transform(hq, rq, o["CinvT"], o["APT"],
                                            m=m),
                lambda: wt.output_transform_plain(hq, rq, o["CinvT"],
                                                  o["APT"], m=m),
                4 * P * T * cout + 4 * T * cout * m * m,
                T * cout * (sand(n, n) + sand(n, m)), FP32_FLOP_S, None),
            "fused_gemm_output": (
                lambda: fs.fused_gemm_output(xq, uq, deq, rq, o["CinvT"],
                                             o["APT"], m=m, requant_bits=9),
                lambda: fs.fused_gemm_output_plain(
                    xq, uq, deq, rq, o["CinvT"], o["APT"], m=m,
                    requant_bits=9),
                P * T * cin + P * cin * cout + 4 * T * cout * m * m,
                2 * P * T * cin * cout, INT8_OPS_S, "conv2d"),
        }
        rows = {}
        for k, (kern, plain, nbytes, nops, peak, lib) in calls.items():
            t_k = time_ms(kern)
            t_p = time_ms(plain, iters=3, warmup=1)
            b_ms = nbytes / HBM_BYTES_S * 1e3
            o_ms = nops / peak * 1e3
            t_l = None
            if lib == "conv2d":
                x = torch.randn((BATCH, cin, hw, hw), generator=gen,
                                device=dev)
                w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                cudnn = torch.backends.cudnn
                with cudnn.flags(enabled=True, benchmark=False,
                                 deterministic=False, allow_tf32=False):
                    t_l = time_ms(lambda: F.conv2d(x, w, padding=1))
            elif lib == "int_mm":
                kp = -(-cin // 8) * 8        # _int_mm takes K % 8 == 0
                xa = torch.zeros((P, T, kp), dtype=torch.int8, device=dev)
                wa = torch.zeros((P, kp, cout), dtype=torch.int8,
                                 device=dev)
                xa[:, :, :cin] = xq
                wa[:, :cin, :] = uq

                def int_mm():
                    for p in range(P):
                        torch._int_mm(xa[p], wa[p])
                t_l = time_ms(int_mm)
            rows[k] = {"ms": t_k, "plain_ms": t_p, "bytes_ms": b_ms,
                       "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
                       "library_ms": t_l, "bytes": nbytes, "ops": nops}
            acc_row = per[k]
            for f in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                acc_row[f] += count * rows[k][f]
            if t_l is not None:
                acc_row["library_ms"] += count * t_l
            log(f"time {lname:4s} {k:17s}: kernel {t_k:.4f} ms, bound "
                f"{max(b_ms, o_ms):.4f} ms ({'bytes' if b_ms >= o_ms else 'operations'}), "
                f"plain {t_p:.3f} ms, library "
                f"{'-' if t_l is None else f'{t_l:.4f} ms'}")
        floor = T * cout * epilogue_ops(n, m, True) / FP32_INSTR_S * 1e3
        rows["fused_gemm_output"]["epilogue_floor_ms"] = floor
        per["fused_gemm_output"]["epilogue_floor_ms"] = \
            per["fused_gemm_output"].get("epilogue_floor_ms", 0.0) + \
            count * floor
        log(f"time {lname:4s} K4 epilogue floor (bitwise sandwiches, "
            f"{epilogue_ops(n, m, True)} fp32 ops per (t, c)): {floor:.4f} ms")
        layer_times[lname] = rows
        del tiles, xq, acc, hq
    report["layer_times"] = layer_times
    for k in SERVING:
        r = per[k]
        log(f"per fused forward {k:17s}: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.4f} ms"
            + (f", epilogue floor {r['epilogue_floor_ms']:.4f} ms"
               if "epilogue_floor_ms" in r else ""))

    # K5 at the llama3.2-1b projection shapes, prefill and decode
    gen = torch.Generator(device=dev).manual_seed(3)
    q8_rows = {}
    for M in (PREFILL_M, DECODE_M):
        for K, N in Q8_SHAPES:
            xq, wq, sx, sw = q8_inputs(M, K, N)
            nbytes = M * K + K * N + 4 + 4 * N + 4 * M * N
            b_ms = nbytes / HBM_BYTES_S * 1e3
            o_ms = 2 * M * K * N / INT8_OPS_S * 1e3
            t_k = time_ms(lambda: q8.q8_matmul(xq, wq, sx, sw))
            t_d = kernel_device_ms(lambda: q8.q8_matmul(xq, wq, sx, sw),
                                   "q8_wgmma_kernel")
            t_p = time_ms(lambda: q8.q8_matmul_plain(xq, wq, sx, sw),
                          iters=3, warmup=1)
            # torch._int_mm takes M > 16: a decode M is padded to 32 rows
            xa = torch.zeros((max(M, 32), K), dtype=torch.int8, device=dev)
            xa[:M] = xq
            t_l = time_ms(lambda: torch._int_mm(xa, wq))
            t_le = time_ms(lambda: torch._int_mm(xa, wq).float() * sx * sw)
            q8_rows[f"M={M} K={K} N={N}"] = {
                "ms": t_k, "device_ms": t_d, "plain_ms": t_p,
                "bytes_ms": b_ms, "ops_ms": o_ms,
                "bound_ms": max(b_ms, o_ms), "int_mm_ms": t_l,
                "int_mm_epilogue_ms": t_le}
            log(f"time K5 M={M:4d} K={K:4d} N={N:4d}: kernel {t_k:.4f} ms "
                f"(device {t_d:.4f} ms), bound {max(b_ms, o_ms):.4f} ms "
                f"({'bytes' if b_ms >= o_ms else 'operations'}), plain "
                f"{t_p:.3f} ms, _int_mm {t_l:.4f} ms, _int_mm + epilogue "
                f"{t_le:.4f} ms")
            del xq, wq, xa
    report["q8_times"] = q8_rows
    # K5 at the decode shapes under every split of K, the one q8_splits
    # picks among them (the wrapper with its split choice swapped): event
    # time of back-to-back calls and the kernel's device time per call
    sweep = {}
    for K, N in Q8_SHAPES:
        xq, wq, sx, sw = q8_inputs(DECODE_M, K, N)
        steps = -(-K // q8.TILE[2])
        row = {}
        for s_try in (1, 2, 4, 8, 16, 32):
            if s_try > steps:
                break
            with mock.patch.object(q8, "q8_splits", lambda *_: s_try):
                row[s_try] = {
                    "ms": time_ms(lambda: q8.q8_matmul(xq, wq, sx, sw)),
                    "device_ms": kernel_device_ms(
                        lambda: q8.q8_matmul(xq, wq, sx, sw),
                        "q8_wgmma_kernel")}
        sweep[f"M={DECODE_M} K={K} N={N}"] = row
        log(f"time K5 M={DECODE_M} K={K:4d} N={N:4d} by split of K "
            f"(chosen {q8.q8_splits(DECODE_M, N, K)}), events / device: "
            + ", ".join(f"{k}: {v['ms']:.4f} / {v['device_ms']:.4f} ms"
                        for k, v in row.items()))
        del xq, wq
    report["q8_split_sweep"] = sweep
    report["q8_layer_set"] = {}
    for M in (PREFILL_M, DECODE_M):
        tot = {f: sum(q8_rows[f"M={M} K={K} N={N}"][f]
                      for _, K, N in LLAMA_PROJ)
               for f in ("ms", "device_ms", "plain_ms", "bytes_ms", "ops_ms",
                         "bound_ms",
                         "int_mm_ms", "int_mm_epilogue_ms")}
        report["q8_layer_set"][M] = tot
        log(f"K5 over one llama3.2-1b layer's 7 projections at M={M}: "
            f"kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.3f} ms, _int_mm {tot['int_mm_ms']:.4f}"
            f" ms, _int_mm + epilogue {tot['int_mm_epilogue_ms']:.4f} ms")
    pre = report["q8_layer_set"][PREFILL_M]
    per["q8_matmul"] = {"ms": pre["ms"], "plain_ms": pre["plain_ms"],
                        "bound_ms": pre["bound_ms"],
                        "bytes_ms": pre["bytes_ms"], "ops_ms": pre["ops_ms"],
                        "library_ms": pre["int_mm_ms"]}
    del gen

    # fused serving throughput at B = 256, width 1.0
    from repro_torch.data.pipeline import cifar_batch_at
    from repro_torch.models import resnet as RN
    from repro_torch.models.param import init_params
    cfg = RN.ResNetConfig(width_mult=1.0, wino=main_spec)
    params = init_params(RN.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    state = init_params(RN.state_specs(cfg),
                        torch.Generator().manual_seed(1))
    eng = RN.make_engine(cfg, backend="winograd_int8", device=dev)
    model = RN.ResNet(cfg, params, state, eng)
    with torch.inference_mode():
        eng.prepare(RN.conv_layers(model))
        with eng.calibration():
            model(cifar_batch_at(0, BATCH, device=dev)["images"])
        images = cifar_batch_at(1, BATCH, device=dev)["images"]
        fwd_ms = time_ms(lambda: model(images), iters=10, warmup=2)
        # one traced forward: device time by kernel, and the busy share
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(images)
            torch.cuda.synchronize()
    report["fused_forward_ms"] = fwd_ms
    report["images_per_s"] = BATCH / (fwd_ms / 1e3)
    log(f"fused serving, width 1.0, B={BATCH}: {fwd_ms:.3f} ms per forward, "
        f"{report['images_per_s']:.0f} images/s")
    by_kernel = device_ms_by_kernel(prof)
    busy_ms = sum(by_kernel.values())
    report["trace"] = {"device_ms_by_kernel": by_kernel,
                       "device_busy_ms": busy_ms}
    if not by_kernel:
        log("trace: the profiler recorded no device time (not measured)")
    else:
        log(f"trace of one fused forward: device busy {busy_ms:.3f} ms of "
            f"{fwd_ms:.3f} ms event-timed forward "
            f"({100 * busy_ms / fwd_ms:.1f}% busy); top kernels:")
        for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
            log(f"  {v:8.3f} ms  {k[:100]}")

    # 6. train ---------------------------------------------------------------
    torch.cuda.empty_cache()
    tr = train_resnet_qat.main(["--width", "1.0", "--batch", str(BATCH),
                                "--steps", str(TRAIN_STEPS),
                                "--device", "cuda"])
    report["train"] = tr
    bad = [i for i, v in enumerate(tr["losses"]) if not math.isfinite(v)]
    if bad:
        fail(f"training losses not finite at steps {bad}: {tr['losses']}")
    still = [k for k, v in tr["param_change"].items() if not v > 0]
    flex = [k for k in tr["param_change"] if k.startswith("wino_flex.")]
    if still or len(flex) != 3:
        fail(f"parameters that did not change: {still}; flex {flex}")
    still = [k for k, v in tr["bn_change"].items() if not v > 0]
    if still:
        fail(f"BatchNorm running statistics that did not move: {still}")
    log(f"train, width 1.0, B={BATCH}, {TRAIN_STEPS} steps: losses "
        f"{[round(v, 4) for v in tr['losses']]}; {tr['step_ms']:.2f} ms per "
        f"step, {tr['images_per_s']:.0f} images/s trained, peak memory "
        f"{tr['peak_mem_bytes'] / 2**30:.2f} GiB; every parameter, the flex "
        f"matrices and the BN statistics changed")
    # where a training step's device time goes: two traced steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_resnet_qat.main(["--width", "1.0", "--batch", str(BATCH),
                               "--steps", "2", "--device", "cuda"])
        torch.cuda.synchronize()
    by_kernel = device_ms_by_kernel(prof, per=2)
    busy_ms = sum(by_kernel.values())
    report["train_trace"] = {"device_ms_by_kernel_per_step": by_kernel,
                             "device_busy_ms_per_step": busy_ms}
    if not by_kernel:
        log("train trace: the profiler recorded no device time "
            "(not measured)")
    else:
        log(f"train trace: device busy {busy_ms:.2f} ms per step against "
            f"{tr['step_ms']:.2f} ms per step "
            f"({100 * busy_ms / tr['step_ms']:.1f}% busy); top kernels per "
            f"step:")
        for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
            log(f"  {v:8.3f} ms  {k[:100]}")

    kernels = []
    for k, (src, replaces) in TPU_KERNELS.items():
        r = per[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": errs[k],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": r["library_ms"] if r["library_ms"] else None})
        if "epilogue_floor_ms" in r:
            kernels[-1]["epilogue_floor_ms"] = r["epilogue_floor_ms"]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
