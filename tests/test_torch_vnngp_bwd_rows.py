"""Kernel 5's backward (``csrc/vnngp.cu`` ``block_conditional_bwd_kernel``)
on the CPU: its rows-a-lane order replayed in float32 with numpy.

- the right-looking Cholesky over a point's lanes (lane i holds row i; at
  step k the pivot comes from lane k, the lanes below scale their l_ik and
  column k goes round) gives the same bits as the one-thread-a-point
  factor (``cholesky<K>``: each a_ij subtracts l_ik l_jk for k = 0 ... j-1),
  with fused multiply-adds emulated, at K = 1, 5, 8 and 16;
- the whole replay (factor, the solves for w and v, dw from lane i's row
  and column, the outputs) against the closed form
  ``block_conditional_bwd_plain`` in float64, to float32 rounding;
- every element of dkzz, ds, dkxz and dmu is written by exactly one lane,
  at ragged n and K and on grids of one block, of whole waves and of many
  blocks, with the kernel's lane arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpzoo_tpu_torch.ops import vnngp_cuda

VNNGP_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "vnngp.cu"
WARP = 32
JITTER = np.float32(0.1)
f32 = np.float32


def _src():
    return VNNGP_CU.read_text()


BWD_WARPS = int(re.search(r"constexpr int BWD_WARPS = (\d+);", _src()).group(1))


def _lanes(K):
    """Rows<K>::G: K rounded up to a power of two."""
    return 1 if K <= 1 else 2 if K <= 2 else 4 if K <= 4 else 8 if K <= 8 else 16


def _fma(a, b, c):
    """A float32 fused multiply-add: the product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def _operands(n, K, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, K, K))
    b = rng.standard_normal((n, K, K)) * 0.3
    kzz = (a @ a.transpose(0, 2, 1) + 3 * np.eye(K)).astype(f32)
    s = (b @ b.transpose(0, 2, 1)).astype(f32)
    s = (s + (rng.standard_normal(s.shape) * 1e-3).astype(f32)).astype(f32)  # not bit-symmetric
    kxz = rng.standard_normal((n, K)).astype(f32)
    mu = rng.standard_normal((n, K)).astype(f32)
    gm = rng.standard_normal(n).astype(f32)
    gc = rng.standard_normal(n).astype(f32)
    return kzz, s, kxz, mu, gm, gc


def _cholesky_one_thread(kzz, K):
    """cholesky<K>: row by row, acc -= l[i][k] * l[j][k] (contracted)."""
    n = kzz.shape[0]
    l = np.zeros((n, K, K), f32)
    inv = np.zeros((n, K), f32)
    for i in range(K):
        for j in range(i + 1):
            acc = kzz[:, i, j].copy()
            if i == j:
                acc = (acc + JITTER).astype(f32)
            for k in range(j):
                acc = _fma(-l[:, i, k], l[:, j, k], acc)
            if i == j:
                l[:, i, i] = np.sqrt(acc)
                inv[:, i] = f32(1) / l[:, i, i]
            else:
                l[:, i, j] = (acc * inv[:, j]).astype(f32)
    return l, inv


def _cholesky_rows(kzz, K):
    """The kernel's right-looking factor: a[:, i] is lane i's row."""
    n = kzz.shape[0]
    a = kzz.copy()
    for i in range(K):
        a[:, i, i] = (a[:, i, i] + JITTER).astype(f32)
    l = np.zeros((n, K, K), f32)
    inv = np.zeros((n, K), f32)
    for k in range(K):
        lkk = np.sqrt(a[:, k, k])  # the pivot, from lane k
        l[:, k, k] = lkk
        inv[:, k] = f32(1) / lkk
        for row in range(k + 1, K):
            a[:, row, k] = (a[:, row, k] * inv[:, k]).astype(f32)
        for j in range(k + 1, K):
            l[:, j, k] = a[:, j, k]  # lane j's l_jk, by a shuffle
            for row in range(j, K):
                a[:, row, j] = _fma(-a[:, row, k], l[:, j, k], a[:, row, j])
    return l, inv


def _chol_solve(l, inv, b, K):
    """chol_solve<K>: forward then back substitution, in order."""
    y = np.zeros_like(b)
    for i in range(K):
        acc = b[:, i].copy()
        for k in range(i):
            acc = _fma(-l[:, i, k], y[:, k], acc)
        y[:, i] = (acc * inv[:, i]).astype(f32)
    x = np.zeros_like(b)
    for i in range(K - 1, -1, -1):
        acc = y[:, i].copy()
        for k in range(i + 1, K):
            acc = _fma(-l[:, k, i], x[:, k], acc)
        x[:, i] = (acc * inv[:, i]).astype(f32)
    return x


def _replay(kzz, s, kxz, mu, gm, gc, K):
    l, inv = _cholesky_rows(kzz, K)
    w = _chol_solve(l, inv, kxz, K)
    dw = np.zeros_like(w)
    for i in range(K):  # lane i: its row and (from L1) its column
        acc = (f32(-2) * JITTER * w[:, i]).astype(f32)
        for j in range(K):
            t = (((s[:, i, j] + s[:, j, i]).astype(f32) - kzz[:, i, j]).astype(f32)
                 - kzz[:, j, i]).astype(f32)
            acc = _fma(t, w[:, j], acc)
        dw[:, i] = _fma(gm, mu[:, i], (gc * acc).astype(f32))
    v = _chol_solve(l, inv, dw, K)
    gww = ((gc[:, None] * w)[:, :, None] * w[:, None, :]).astype(f32)
    inner = _fma(v[:, :, None], w[:, None, :], (w[:, :, None] * v[:, None, :]).astype(f32))
    dkzz = _fma(f32(-0.5), inner, -gww)
    return dkzz, gww, v, (gm[:, None] * w).astype(f32)


@pytest.mark.parametrize("K", [1, 5, 8, 16])
def test_right_looking_factor_is_the_one_thread_bits(K):
    kzz, *_ = _operands(257, K, K)
    l1, inv1 = _cholesky_one_thread(kzz, K)
    l2, inv2 = _cholesky_rows(kzz, K)
    tril = np.tril(np.ones((K, K), bool))
    assert np.array_equal(l1[:, tril].view(np.uint32), l2[:, tril].view(np.uint32))
    assert np.array_equal(inv1.view(np.uint32), inv2.view(np.uint32))
    src = _src()
    for line in ("const float lkk = sqrtf(__shfl_sync(FULL, a[k], base + k));",
                 "inv_diag[k] = 1.f / lkk;",
                 "if (row > k) a[k] = a[k] * inv_diag[k];",
                 "l[j][k] = __shfl_sync(FULL, a[k], base + j);",
                 "if (row >= j) a[j] -= a[k] * l[j][k];",
                 "for (int k = 0; k < j; ++k) acc -= l[i][k] * l[j][k];"):
        assert line in src, line


@pytest.mark.parametrize("n,K", [(1, 8), (33, 8), (257, 8), (130, 1), (77, 5), (64, 16),
                                 (5, 3), (40, 12)])
def test_replay_gives_the_closed_form(n, K):
    ops = _operands(n, K, 100 * K + n)
    got = _replay(*ops, K)
    ref = vnngp_cuda.block_conditional_bwd_plain(
        *(torch.from_numpy(t).double() for t in ops[:4]),
        *(torch.from_numpy(t).double() for t in ops[4:]), float(JITTER))
    for a, b in zip(got, ref[:4]):
        b = b.numpy()
        err = np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30)
        assert err < 2e-5, err
        assert np.isfinite(a).all()


def _grid(n, K, per_sm, sms=132):
    """launch_bwd: blocks of BWD_WARPS warps, at most a wave of them."""
    points = WARP // _lanes(K)
    blocks = (-(-n // points) + BWD_WARPS - 1) // BWD_WARPS
    return min(blocks, per_sm * sms)


@pytest.mark.parametrize("grid", [None, 1, 7])
@pytest.mark.parametrize("n,K", [(1, 8), (33, 8), (5000, 8), (5001, 8), (50000, 8), (130, 1),
                                 (1000, 5), (1000, 16), (77, 3), (500, 12)])
def test_every_output_element_is_written_by_one_lane(n, K, grid):
    G = _lanes(K)
    points = WARP // G
    grid = _grid(n, K, 5) if grid is None else grid
    groups = -(-n // points)
    stride = grid * BWD_WARPS
    rows = np.zeros((n, K), dtype=np.int64)  # a row of dkzz and ds, an element of dkxz, dmu
    lane = np.arange(WARP)
    for warp in range(grid * BWD_WARPS):
        for grp in range(warp, groups, stride):
            p = grp * points + lane // G
            row = lane % G
            mine = (p < n) & (row < K)
            np.add.at(rows, (p[mine], row[mine]), 1)
    assert (rows == 1).all()
    src = _src()
    assert "const int row = lane % G, base = lane - row;" in src
    assert "const long long p = grp * POINTS + lane / G;" in src
    assert "const bool mine = p < n && row < K;" in src
    assert "if (!mine) continue;" in src
