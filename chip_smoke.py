#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100, sm_90a) and the CUDA toolkit; imports
nothing of JAX and nothing of the JAX package. Phases, each of which
fails the run:

1. device   — name, capability (9, 0), power limit, nvcc and torch CUDA;
2. build    — compile every kernel under ``src/repro_torch/csrc`` with
              nvcc (``-Xptxas -v`` printed) and time it;
3. kernels  — each kernel against its plain PyTorch version on the card
              at the main path's shapes (ResNet-18 width 1.0, B = 256,
              F(4,3) Legendre, 9-bit Hadamard), plus one F(6,3) and one
              canonical case: integer outputs bit for bit, fp32 outputs
              within 1e-6 of their max;
4. main     — ``repro_torch.launch.infer_resnet`` at width 1.0, batch
              256, 2 calibration steps: pack → calibrate → checkpoint →
              restore → serve fused and staged, its fused-vs-staged gate
              against the fp32 ``direct`` network; launch counts read
              around it (every kernel > 0, K4 14 per fused forward);
5. times    — CUDA-event time of each kernel at each main-path shape
              beside its bound, its plain version and a library yardstick
              (cuDNN ``F.conv2d``, ``torch._int_mm`` over the positions;
              the port calls neither), and fused images/s at B = 256.

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_FLOP_S = 67e12

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
}


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
    from repro_torch.kernels import wino_gemm as wg
    from repro_torch.kernels import wino_transform as wt
    from repro_torch.launch import infer_resnet

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
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():   # kernel, registers, smem, spills
            if any(w in line for w in ("entry function", "Used", "spill")):
                log(f"  {src}: {line.strip()}")

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
        log(f"{label}: Xq, int32 GEMM and requant plane bitwise; fp32 "
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
    log(f"main path launches: {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    # 14 Winograd convs per forward: calibration and staged/dynamic serving
    # run K1 → K2 → K3, fused serving K1 → K4
    staged = out["calib_forwards"] + out["staged_forwards"] + \
        out["dynamic_forwards"]
    want = {"input_transform": 14 * (staged + out["fused_forwards"]),
            "wino_gemm": 14 * staged, "output_transform": 14 * staged,
            "fused_gemm_output": 14 * out["fused_forwards"]}
    if launches != want:
        fail(f"main-path launches {launches}, expected {want}")

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
        layer_times[lname] = rows
        del tiles, xq, acc, hq
    report["layer_times"] = layer_times

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
    from torch.autograd import DeviceType
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:   # device events only: a CPU
            continue                            # op repeats its kernels' time
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
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
