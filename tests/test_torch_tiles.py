"""The host-side launch choices of K2, K4 and K5, as pure functions, on
the CPU: K4's block tile and the positions a K2 block takes (they must
fit shared memory and their grids fill the H100's 132 SMs wherever the
shape allows), K2's grid limit, the [j][k][a][b] term tables of K1 and K4, K5's split of K across
blocks, and the wrappers' alignment check."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_serve as fs
from repro_torch.kernels import q8_matmul as q8
from repro_torch.kernels import wino_gemm as wg

BATCH = 256
# (tiles T, Cout) of the 14 Winograd convs of ResNet-18 at width 1.0,
# F(4,3) on 32x32 images (the main path), and of a ragged layer
MAIN_SHAPES = [(64 * BATCH, 64), (16 * BATCH, 128), (4 * BATCH, 256),
               (BATCH, 512), (37, 45)]
# M, K, N of the llama3.2-1b projections at prefill and decode
LLAMA_SHAPES = [(M, K, N) for M in (2048, 8)
                for K, N in ((2048, 2048), (2048, 512), (2048, 8192),
                             (8192, 2048))]


# (tiles T, Cin, Cout) of the 14 Winograd convs (the stem, s0-s3), and
# K1/K2's ragged edge shapes
GEMM_SHAPES = [(64 * BATCH, 3, 64), (64 * BATCH, 64, 64),
               (16 * BATCH, 128, 128), (4 * BATCH, 256, 256),
               (BATCH, 512, 512), (1000, 19, 45), (301, 64, 45), (37, 3, 45)]


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
@pytest.mark.parametrize("rows", ["output", "square"])
def test_term_tables_are_the_fp32_products(n, rows):
    # "output": K4's A_C operand (m x n); "square": K4's n x n operand of
    # the base change, as its wrapper makes it. K1 builds its tables of
    # the same layout on the card (common.cuh load_terms); only the
    # bitwise card tests hold those.
    rng = np.random.default_rng(n)
    no = n - 2 if rows == "output" else n
    L = rng.normal(size=(no, n)).astype(np.float32)
    got = fs._terms(torch.from_numpy(L), n).numpy().reshape(-1)
    if n <= 6:
        # [j][k][a][b] = L[a][j] · L[b][k]
        want = np.einsum("aj,bk->jkab", L, L).reshape(-1)
    else:
        want = np.concatenate([L.reshape(-1), L.reshape(-1)])
    np.testing.assert_array_equal(got, want)
    assert got.size == fs._operand_floats(n, no)


@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("T,cin,cout", GEMM_SHAPES)
def test_gemm_positions_fit_shared_memory_and_fill_the_card(n, T, cin,
                                                           cout):
    P = n * n
    pb = wg.gemm_positions(P, T, cout, cin)
    assert pb in wg.POSITIONS
    # two blocks an SM at the least, so one block's stores overlap
    # another's loads
    assert 2 * wg.mainloop_smem_bytes(*wg.TILE, wg.THREADS) <= fs.SMEM_LIMIT
    blocks = math.prod(wg.gemm_grid(P, T, cout, pb))
    if pb > 1:               # more positions a block only within the limits
        assert pb * cin <= wg.MAX_K
        assert blocks >= wg.MIN_BLOCKS
    # no more positions a block would still keep within both
    assert all(more * cin > wg.MAX_K or
               math.prod(wg.gemm_grid(P, T, cout, more)) < wg.MIN_BLOCKS
               for more in wg.POSITIONS if more > pb)
    assert blocks >= min(wg.SMS, math.prod(wg.gemm_grid(P, T, cout, 1)))
    wg._check_grid(P, T, cout, pb)        # within the grid: no refusal


def test_gemm_smem_counts_the_mainloop_ring():
    # 4 stages of a BT x 80 Xq slab and of 16 raw u_q bytes for each of
    # 256 threads (64 x 64 u_q bytes: 256 4 x 4 blocks, one a thread), two
    # 64 x 80 K-major u_q slabs (int8_mma.cuh mainloop_bytes)
    assert wg.TILE == (128, 64) and wg.THREADS == 256
    assert wg.mainloop_smem_bytes(*wg.TILE, wg.THREADS) == \
        4 * (128 * 80 + 256 * 16) + 2 * 64 * 80
    assert wg.mainloop_smem_bytes(64, 64, 128) == \
        4 * (64 * 80 + 2 * 128 * 16) + 2 * 64 * 80
    # K4 builds on the same mainloop
    assert fs.fused_smem_bytes(6, 32, 32, True) - \
        wg.mainloop_smem_bytes(32, 32, 256) == \
        4 * (6 ** 4 + 4 * 4 * 36 + 2 * 36) + 36 * 32 * 32 * 2


@pytest.mark.parametrize("M,N", [(2 ** 31 - 128, 8), (2 ** 31 - 1, 64),
                                 (1000, 2 ** 31 - 64)])
def test_gemm_refuses_shapes_past_its_grid(M, N):
    pb = wg.gemm_positions(36, M, N, 64)
    with pytest.raises(ValueError, match="grid"):
        wg._check_grid(36, M, N, pb)
    wg._check_grid(36, M - wg.TILE[0], 8, pb)  # a tile less: within it


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
