"""The PyTorch port's core against the JAX package, and the port's
independence from JAX.

Transform matrices must equal the JAX package's bit for bit: both are
the same exact-rational construction rounded once to fp32.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core import winograd as jw
from repro_torch.core import quantization as tq
from repro_torch.core import winograd as tw
from repro_torch.device import resolve_device

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


@pytest.mark.parametrize("m", [2, 4, 6])
@pytest.mark.parametrize("base", ["canonical", "legendre", "chebyshev"])
def test_make_matrices_bitwise_equal_to_jax(m, base):
    # r = 3: the 2-D convs; F(4,4) (r = 4): the hybrid LM's temporal conv
    for r in (3, 4) if m == 4 else (3,):
        ours = tw.make_matrices(tw.WinogradSpec(m=m, r=r, base=base))
        ref = jw.make_matrices(jw.WinogradSpec(m=m, r=r, base=base))
        for f in ("AT", "G", "BT", "C", "Cinv", "GP", "BPT", "APT",
                  "CinvT"):
            a, b = getattr(ours, f), np.asarray(getattr(ref, f))
            assert a.dtype == b.dtype == np.float32, (r, f)
            np.testing.assert_array_equal(a, b, err_msg=f"r={r} {f}")


def test_quantization_helpers_match_jax():
    for bits in (2, 8, 9, 16, 17, 32):
        assert tq.qmax(bits) == jq.qmax(bits)
        assert (str(tq.storage_dtype(bits)).split(".")[-1]
                == jnp.dtype(jq.storage_dtype(bits)).name)
    for bad in (1, 33):
        with pytest.raises(ValueError):
            tq.storage_dtype(bad)
    for ours, ref in ((tq.QuantConfig(), jq.QuantConfig()),
                      (tq.QuantConfig.off(), jq.QuantConfig.off())):
        for f in ("act_bits", "weight_bits", "trans_bits", "hadamard_bits",
                  "matrix_bits", "per_channel_weights",
                  "cast_between_stages", "position_scales"):
            assert getattr(ours, f) == getattr(ref, f), f
    assert tq.QuantConfig.off().is_off and not tq.QuantConfig().is_off


@pytest.mark.parametrize("size,padding", [(9, "same"), (16, "same"),
                                          (11, "valid")])
def test_pad_amounts_match_jax(size, padding):
    for m in (2, 4, 6):
        assert (tw._pad_amounts(size, m, 3, padding)
                == jw._pad_amounts(size, m, 3, padding))


def _port_modules():
    return sorted(".".join(p.relative_to(REPO / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_port_imports_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) >= 57
    assert {"repro_torch.kernels.q8_matmul", "repro_torch.optim.optimizer",
            "repro_torch.launch.train_resnet_qat",
            "repro_torch.core.quantization", "repro_torch.analysis.ranges",
            "repro_torch.analysis.certify", "repro_torch.conv.autotune",
            "repro_torch.conv.planner", "repro_torch.serving.loop",
            "repro_torch.serving.graphs", "repro_torch.serving.loadgen",
            "repro_torch.launch.serve", "repro_torch.launch.offline",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.resnet18_cifar10",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.rglru", "repro_torch.models.rwkv6",
            "repro_torch.models.registry", "repro_torch.launch.steps",
            "repro_torch.models.losses", "repro_torch.launch.train"
            } <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_sources_never_name_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for nm in names:
                top = nm.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{f.name}:{node.lineno}: {nm}")
    assert not offenders, offenders


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
