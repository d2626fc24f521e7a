"""The host-side launch choices of K4 and K5, as pure functions, on the
CPU: K4's block tile (its stash must fit shared memory and its grid fill
the H100's 132 SMs wherever the shape allows), K4's term tables, K5's
split of K across blocks, and the wrappers' alignment check."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_serve as fs
from repro_torch.kernels import q8_matmul as q8

BATCH = 256
# (tiles T, Cout) of the 14 Winograd convs of ResNet-18 at width 1.0,
# F(4,3) on 32x32 images (the main path), and of a ragged layer
MAIN_SHAPES = [(64 * BATCH, 64), (16 * BATCH, 128), (4 * BATCH, 256),
               (BATCH, 512), (37, 45)]
# M, K, N of the llama3.2-1b projections at prefill and decode
LLAMA_SHAPES = [(M, K, N) for M in (2048, 8)
                for K, N in ((2048, 2048), (2048, 512), (2048, 8192),
                             (8192, 2048))]


def _blocks(T, cout, tile):
    return math.ceil(T / tile[0]) * math.ceil(cout / tile[1])


@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("T,cout", MAIN_SHAPES)
def test_fused_tile_fits_shared_memory_and_fills_the_card(n, requant, T,
                                                          cout):
    tile = fs.fused_tile(n, T, cout, requant)
    assert tile in fs.TILES
    assert fs.fused_smem_bytes(n, *tile, requant) <= fs.SMEM_LIMIT
    most = max(_blocks(T, cout, t) for t in fs.TILES
               if fs.fused_smem_bytes(n, *t, requant) <= fs.SMEM_LIMIT)
    assert _blocks(T, cout, tile) >= min(fs.SMS, most)


def test_fused_smem_counts_the_stash_of_every_position():
    # F(4,3) Legendre, 9-bit requant, 32 x 32 tile: int16 stash of 36
    # positions; 4 stages of a 32 x 80 Xq slab and of 16 raw u_q bytes
    # for each of 256 threads, two 32 x 80 K-major u_q slabs
    tables = 4 * (6 ** 4 + 4 * 4 * 36 + 2 * 36)
    staging = 4 * (32 * 80 + 256 * 16) + 2 * 32 * 80
    assert fs.fused_smem_bytes(6, 32, 32, True) == \
        tables + staging + 36 * 32 * 32 * 2
    assert fs.fused_smem_bytes(6, 32, 32, False) == \
        tables + staging + 36 * 32 * 32 * 4


@pytest.mark.parametrize("n", [4, 6, 8])
def test_term_tables_are_the_fp32_products(n):
    rng = np.random.default_rng(n)
    L = rng.normal(size=(n - 2, n)).astype(np.float32)
    got = fs._terms(torch.from_numpy(L), n).numpy().reshape(-1)
    if n <= 6:
        # [j][k][a][b] = L[a][j] · L[b][k]
        want = np.einsum("aj,bk->jkab", L, L).reshape(-1)
    else:
        want = np.concatenate([L.reshape(-1), L.reshape(-1)])
    np.testing.assert_array_equal(got, want)
    assert got.size == fs._operand_floats(n, n - 2)


@pytest.mark.parametrize("M,K,N", LLAMA_SHAPES + [(130, 100, 70),
                                                  (33, 1000, 24)])
def test_q8_split_fills_the_card_with_whole_steps(M, K, N):
    bm, bn, bk = q8.TILE
    s = q8.q8_splits(M, N, K)
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    steps = math.ceil(K / bk)
    assert 1 <= s <= steps
    per = math.ceil(steps / s)
    assert math.ceil(steps / per) == s        # no block without a step
    if tiles < q8.SMS and steps > 1:
        # within one split of the card's SMs, or every step its own block
        assert tiles * s >= q8.SMS - tiles or s == steps
    else:
        assert s == 1


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_require_refuses_an_unaligned_view(offset):
    # the check the wrappers make before a kernel's vector loads
    flat = torch.zeros(64, dtype=torch.int8)
    cpu = torch.device("cpu")
    _build.require(flat[16:48], "t", torch.int8, (32,), cpu, aligned=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.require(flat[offset:offset + 32], "t", torch.int8, (32,),
                       cpu, aligned=True)


def test_q8_workspace_grows_and_is_reused_per_stream():
    cpu = torch.device("cpu")
    q8._WORKSPACES.clear()
    ws, counters = q8._workspace(cpu, 7, 100, 4)
    assert ws.numel() == 100 and counters.numel() == 4 and not ws.any()
    assert q8._workspace(cpu, 7, 50, 2)[0] is ws        # fits: reused
    grown = q8._workspace(cpu, 7, 60, 9)                # more tiles: grows
    assert grown[0].numel() == 100 and grown[1].numel() == 9
    assert q8._workspace(cpu, 8, 10, 1)[0] is not grown[0]   # other stream
    q8._WORKSPACES.clear()
