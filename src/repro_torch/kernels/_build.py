"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The sources do
not include PyTorch's headers, so a build takes seconds. Libraries land
in ``build/repro_torch/`` at the root of the checkout, named by a hash of
their source and flags, so a changed source rebuilds and an unchanged
one is reused. The first call to ``load`` builds every source at once,
one ``nvcc`` process each, all started together.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: each
wrapper adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
import torch

__all__ = ["LAUNCHES", "BUILD_LOG", "reset_launches", "nvcc_path", "load",
           "build_all", "launch", "require", "stream", "cuda_device",
           "NVCC_FLAGS", "SOURCES", "BUILD_DIR", "SMS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: Streaming multiprocessors of one H100 SXM, which the wrappers' launch
#: choices fill.
SMS = 132

#: One shared library per source; the kernels each one holds.
SOURCES = {
    "wino_transform": ("input_transform", "output_transform"),
    "wino_gemm": ("wino_gemm",),
    "fused_serve": ("fused_gemm_output",),
    "q8_matmul": ("q8_matmul",),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {k: 0 for ks in SOURCES.values() for k in ks}

_LIBS: dict[str, ctypes.CDLL] = {}
# C entry points with their argument types set, by (source, name)
_FNS: dict = {}
#: ``-Xptxas -v`` output (registers, shared memory, spills) per source.
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "on PATH); the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        # every header can reach every source: hash them all
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> list[str]:
    """Compile every source that has no current library, in parallel.
    Returns the sources it built; raises on a failure."""
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = _target(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


PTR, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def launch(source: str, fn_name: str, argtypes: tuple, *args) -> None:
    """Call the C entry ``fn_name`` of ``csrc/<source>.cu`` and raise if
    it returns a CUDA error. Tensor arguments pass as device pointers,
    None as a null pointer."""
    fn = _FNS.get((source, fn_name))
    if fn is None:
        fn = getattr(load(source), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(source, fn_name)] = fn
    rc = fn(*(ptr(a) if isinstance(a, torch.Tensor) else a for a in args))
    if rc != 0:
        shapes = " ".join(str(tuple(a.shape)) for a in args
                          if isinstance(a, torch.Tensor))
        msg = load(source).repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg}) "
                           f"on {shapes}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device, aligned: bool = False) -> None:
    """Raise unless ``t`` is what a kernel takes: the device, dtype and
    shape given, contiguous, and 16-byte aligned where ``aligned`` (the
    kernel reads it with vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """The device's current CUDA stream as a pointer, from PyTorch's raw
    getter: it skips building a ``torch.cuda.Stream`` (several µs a call,
    which a decode-sized launch notices)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} takes CPU tensors (plain version) or "
                         f"CUDA tensors (kernel), got {t.device}")
    return t.device
