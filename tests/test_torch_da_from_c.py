"""Kernel 7 reading c: da of colsum((Luᵀa)²) for a per-factor a, on the CPU.

Where a takes a gradient (the MGGP W-form's a = W·Kzx, the hybrids'; a shared a
that trains), ``tri_cuda.TriSqColsum``'s backward takes da in one launch,
``tri_da_from_c``: on the card kernel 7 with its operands swapped (A = dcᵀ's
rows, read transposed from kernel 1's kept c, scaled by 2g and split in
registers; B = Lu's rows split once), so that dcᵀ is never written; here its
plain form ``tri_da_from_c_plain``. Held against ``jax.grad`` of
``gpzoo_tpu.ops.tri_blocked.tri_sq_colsum`` with respect to a per-factor a in
float64 at 1e-8 (M = 130 and 1,100, L = 1 and 3), bit for bit against the route
it replaces there (the scale pass, then kernel 7) and the route that recomputes
c; the Function's choice of route, by spies on the wrappers, for a shared and a
per-factor a, frozen and trained, Lu trained and frozen (the scale pass without
dcᵀ, and only where Lu trains; kernel 7 on a dc never), and in the MGGP W-form
loss; tri.cu's kDaC block decode, its transposed store (every element of da
written once, 32-byte sectors), its A fragments' index into c's tile and their
2g, and the bank conflicts of that read, replayed from the kernel's own
arithmetic; and the wrapper's guards on ``meta`` tensors.
"""

import contextlib
import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tri_decodes import B_REPLAY, M_REPLAY

from gpzoo_tpu.ops import tri_blocked as jtri

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.ops import tri_cuda

T = torch.tensor
B = 37  # off the 128 tile and off a 16-byte row: the kernel copies c's rows
CASES = [(m, l_dim) for m in (130, 1100) for l_dim in (1, 3)]
TILE, TK, C_BOX = 128, 32, 32
TRI_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "tri.cu"
ROUTES = ("tri_dlu_from_c", "tri_dc_from_c", "tri_dlu", "tri_da", "tri_da_from_c")


def _close(got, expect, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@functools.cache
def _case(m_dim, l_dim, shared=False):
    """Lower-triangular Lu (L, M, M), a ((M, B) shared, else (L, M, B)) and
    a cotangent g (L, B), numpy float64, with JAX's dLu and da of Σ g·colsum."""
    rng = np.random.default_rng(13 * m_dim + l_dim + 100 * shared)
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))) / np.sqrt(m_dim)
    a = rng.standard_normal((m_dim, B) if shared else (l_dim, m_dim, B))
    g = rng.standard_normal((l_dim, B))

    def f(u, x):
        return jnp.sum(jnp.asarray(g) * jtri.tri_sq_colsum(jnp.tril(u), x))
    dlu, da = jax.grad(f, argnums=(0, 1))(jnp.asarray(lu), jnp.asarray(a))
    return lu, a, g, np.asarray(dlu), np.asarray(da)


def _kept_c(lu, a):
    return tri_cuda.tri_sq_colsum_c_plain(T(lu), T(a))[1]


@pytest.mark.parametrize("m_dim,l_dim", CASES)
def test_plain_form_matches_jax_grad(m_dim, l_dim):
    """The plain form of kernel 7 reading c is JAX's da at 1e-8; the
    wrapper takes it on the CPU and counts no launch."""
    lu, a, g, _, da = _case(m_dim, l_dim)
    got = tri_cuda.tri_da_from_c_plain(T(lu), _kept_c(lu, a), T(g))
    assert got.shape == (l_dim, m_dim, B)
    _close(got, da, 1e-8)
    before = tri_cuda.tri_da_from_c.launches
    assert torch.equal(tri_cuda.tri_da_from_c(T(lu), _kept_c(lu, a), T(g)), got)
    assert tri_cuda.tri_da_from_c.launches == before


@pytest.mark.parametrize("m_dim,l_dim", CASES)
def test_plain_form_is_the_old_routes_bits(m_dim, l_dim):
    """The same bits as the scale pass followed by kernel 7 (the CPU route
    of each) and as the route that recomputed c (tri_dc_plain, then kernel
    7), per factor and summed over l for a shared a."""
    lu, a, g, _, _ = _case(m_dim, l_dim)
    c = _kept_c(lu, a)
    for shared in (False, True):
        got = tri_cuda.tri_da_from_c_plain(T(lu), c, T(g), shared=shared)
        scale_pass = tri_cuda.tri_dc_from_c(c, T(g))  # the CPU route: dc (L, M, B)
        assert torch.equal(got, tri_cuda.tri_da(T(lu), scale_pass, shared=shared))
        recompute = tri_cuda.tri_dc_plain(T(lu), T(a), T(g))
        assert torch.equal(got, tri_cuda.tri_da_plain(T(lu), recompute, shared=shared))
        assert torch.equal(tri_cuda.tri_da_from_c(T(lu), c, T(g), shared=shared), got)


@contextlib.contextmanager
def _routes():
    """Counts the calls of the backward's wrappers (ROUTES) by name, and
    records the scale pass's ``transposed``."""
    calls = dict.fromkeys(ROUTES, 0)
    transposed = []
    with contextlib.ExitStack() as stack:
        for name in ROUTES:
            inner = getattr(tri_cuda, name)

            def spy(*args, _inner=inner, _name=name, **kwargs):
                calls[_name] += 1
                if _name == "tri_dc_from_c":
                    transposed.append(kwargs.get("transposed", args[2] if len(args) > 2
                                                 else False))
                return _inner(*args, **kwargs)
            stack.enter_context(mock.patch.object(tri_cuda, name, spy))
        yield calls, transposed


def _old_route(lu, c, g, shared=False):
    """The route kernel 7 reading c replaces: the scale pass with dcᵀ, then
    kernel 7 on it (on the CPU each wrapper's plain form)."""
    return tri_cuda.tri_da(lu, tri_cuda.tri_dc_from_c(c, g, transposed=True), shared=shared)


@pytest.mark.parametrize("form,trained,route", [
    ("shared", "Lu", {"tri_dlu_from_c": 1}),
    ("shared", "both", {"tri_dc_from_c": 1, "tri_dlu": 1, "tri_da_from_c": 1}),
    ("shared", "a", {"tri_da_from_c": 1}),
    ("per-factor", "Lu", {"tri_dc_from_c": 1, "tri_dlu": 1}),
    ("per-factor", "both", {"tri_dc_from_c": 1, "tri_dlu": 1, "tri_da_from_c": 1}),
    ("per-factor", "a", {"tri_da_from_c": 1}),
])
def test_function_takes_kernel_7_reading_c_wherever_a_trains(form, trained, route):
    """TriSqColsum's backward: wherever a takes a gradient, da is kernel 7
    reading c, and kernel 7 on a dc never runs; the scale pass runs only
    where Lu trains, and without dcᵀ. The gradients are JAX's, and da the
    old route's bits."""
    lu, a, g, dlu, da = _case(130, 3, form == "shared")
    lu_t = T(lu, requires_grad=trained != "a")
    a_t = T(a, requires_grad=trained != "Lu")
    with _routes() as (calls, transposed):
        tri_cuda.tri_sq_colsum(lu_t, a_t).backward(T(g))
    assert calls == {**dict.fromkeys(ROUTES, 0), **route}
    assert transposed == [False] * calls["tri_dc_from_c"]
    if trained != "a":
        _close(lu_t.grad, np.tril(dlu), 1e-8)
    if trained == "Lu":
        assert a_t.grad is None
        return
    _close(a_t.grad, da, 1e-8)
    old = _old_route(T(lu), _kept_c(lu, a), T(g), shared=form == "shared")
    assert torch.equal(a_t.grad, old)


def _mggp_model():
    """A small MGGP W-form model (per-factor a = W·Kzx, every leaf trained)
    in float64, with the data and draws of one step."""
    n, d, l_dim, m_per, groups = 240, 12, 3, 10, 3
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.uniform(-2, 2, (n, 2)))
    g = torch.tensor(rng.integers(0, groups, n))
    y = torch.tensor(rng.poisson(3.0, (n, d)).astype(np.float64))  # spot-major
    cfg = gt.MGGPNSFConfig(D=d, N=n, L=l_dim, M_per_group=m_per, n_groups=groups,
                           batch_size=64)
    model = cfg.build(torch.Generator().manual_seed(0), x.float(), g).double()
    m = m_per * groups
    # per-factor μ and Lu, as bench.py's MGGP leg trains them
    model.gp.mu = torch.nn.Parameter(0.1 * torch.tensor(rng.standard_normal((l_dim, m))))
    model.gp.Lu_raw = torch.nn.Parameter(
        torch.tril(0.2 * torch.tensor(rng.standard_normal((l_dim, m, m)))))
    idx = torch.tensor(rng.choice(n, 64, replace=False))
    eps = torch.tensor(rng.standard_normal((1, l_dim, 64)))
    return model, x, y, g, idx, eps


def test_w_form_loss_takes_kernel_7_reading_c():
    """The MGGP W-form loss (train/fast.py: colsum((W·Lu)ᵀa)² with a = W·Kzx
    per factor, both trained) runs the scale pass without dcᵀ, kernel 6 on
    it and kernel 7 reading c once a chunk, never kernel 7 on a dc; every
    leaf's gradient is the old route's, bit for bit."""
    model, x, y, g, idx, eps = _mggp_model()

    def grads():
        model.zero_grad(set_to_none=True)
        gt.nsf_negative_elbo_batched(model, x, y, idx, eps, microbatch=32, factored=True,
                                     y_transposed=True, groups=g).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}

    with _routes() as (calls, transposed):
        new = grads()
    chunks = 2
    assert calls == {**dict.fromkeys(ROUTES, 0), "tri_dc_from_c": chunks, "tri_dlu": chunks,
                     "tri_da_from_c": chunks}
    assert transposed == [False] * chunks
    assert "gp.Lu_raw" in new and "gp.kernel.embedding" in new
    with mock.patch.object(tri_cuda, "tri_da_from_c", _old_route):
        old = grads()
    assert new.keys() == old.keys()
    assert all(torch.equal(new[k], old[k]) for k in new)


def _dac_block(bid, nrt, nct):
    """tri_mma_kernel<kDaC>'s block decode: (l, k tile, b tile), factor
    slowest, then the k tile (the longest m loop, kt = nrt - 1, first), then
    the b tiles."""
    l, r = divmod(bid, nct * nrt)
    return l, nrt - 1 - r // nct, r % nct


@pytest.mark.parametrize("b_dim", B_REPLAY)
@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_decode_visits_each_tile_once(m_dim, b_dim):
    """Every (k tile, b tile) of every factor once, factor slowest, a k
    tile's b tiles together, the k tiles from the last (the longest m loop)
    down; each block's m stages [0, 128 (kt + 1)) reach the k tile's
    diagonal, all that Lu's staged rows hold (m < the end of k's tile)."""
    l_dim = 2 if m_dim * b_dim < 10**6 else 1
    nrt, nct = -(-m_dim // TILE), -(-b_dim // TILE)
    order = [_dac_block(bid, nrt, nct) for bid in range(l_dim * nrt * nct)]
    assert sorted(order) == sorted((l, kt, bt) for l in range(l_dim) for kt in range(nrt)
                                   for bt in range(nct))
    assert [o[0] for o in order] == sorted(o[0] for o in order)
    for start in range(0, len(order), nct):
        group = order[start:start + nct]
        assert len({o[1] for o in group}) == 1 and [o[2] for o in group] == list(range(nct))
    assert [o[1] for o in order[:l_dim * nrt * nct:nct]][:nrt] == list(range(nrt))[::-1]
    for _, kt, _ in order:
        k_end = (kt + 1) * (TILE // TK)  # stages of 32 m
        assert k_end * TK == (kt + 1) * TILE  # k < 128 (kt + 1), and m <= k


def _fragments():
    """(row, col) of each consumer thread's accumulator elements in the
    128 x 128 tile, by (warp, lane, j, h, e), as tri.cu computes them."""
    warp, lane, j, h, e = np.meshgrid(np.arange(8), np.arange(32), np.arange(16),
                                      np.arange(2), np.arange(2), indexing="ij")
    row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * h
    col = 2 * (lane % 4) + 8 * j + e
    return row, col


def _ring():
    """The ring's 128 x 128 tile as the fragments write it: (b, k) counts."""
    row, col = _fragments()
    ring = np.zeros((TILE, TILE), np.int64)
    np.add.at(ring, (row.ravel(), col.ravel()), 1)
    return ring


def _stores(rt, ct, m_dim, b_dim):
    """kDaC's stores of tile (b tile rt, k tile ct) replayed: thread t (of
    256) takes bl = t % 128 and rows kl = t / 128, + 2, ... of the tile.
    Returns (k, b, the ring element read, t, kl) of each store taken."""
    t, i = np.meshgrid(np.arange(256), np.arange(TILE // 2), indexing="ij")
    bl, kl = t % TILE, t // TILE + 2 * i
    b, k = rt * TILE + bl, ct * TILE + kl
    taken = (b < b_dim) & (k < m_dim)
    return (k[taken], b[taken], (bl * (TILE + 1) + kl)[taken], t[taken], kl[taken])


@pytest.mark.parametrize("b_dim", B_REPLAY)
@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_store_writes_every_element_of_da_once(m_dim, b_dim):
    """Every tile's fragments fill the ring's 128 x 129 tile once each, and
    the stores write every element da[k, b] (k < M, b < B) once, from the
    ring's element (b, k) of the tile that holds it, and nothing else."""
    assert np.all(_ring() == 1)
    nrt, nct = -(-m_dim // TILE), -(-b_dim // TILE)
    writes = np.zeros((m_dim, b_dim), np.int64)
    for ct in range(nrt):
        for rt in range(nct):
            k, b, src, _, _ = _stores(rt, ct, m_dim, b_dim)
            assert np.all(src == (b - rt * TILE) * (TILE + 1) + (k - ct * TILE))
            np.add.at(writes, (k, b), 1)
    assert np.all(writes == 1)


@pytest.mark.parametrize("b_dim", [7000, 6000, 3500, 1283])
def test_a_warps_store_is_one_row_of_128_bytes_and_its_ring_reads_free(b_dim):
    """A warp's store (32 consecutive t, one kl) writes 32 consecutive b of
    one row k of da, 128 contiguous bytes, and reads the ring's tile with no
    bank conflict (stride 129 floats)."""
    k, b, src, t, kl = _stores(1, 2, 3010, b_dim)
    for key in set(zip(t // 32, kl)):
        mine = (t // 32 == key[0]) & (kl == key[1])
        assert len(set(k[mine])) == 1
        np.testing.assert_array_equal(np.diff(np.sort(b[mine])), 1)
        assert mine.sum() == 32 and len(set(src[mine] % 32)) == 32


def _c_tile(c, l_dim, m_dim, b_dim, l, kt, rt):
    """Stage kt of block (l, b tile rt) as TMA lands it: four 32 x 32 boxes
    of c's rows m in [32 kt, 32 kt + 32) (zeros past factor l's M: the map
    has a slab a factor) by the tile's b (zeros past B), 4 KB apart, each
    row m 128 bytes with 16-byte chunk q at q ^ (m % 8); as floats."""
    smem = np.full(TILE * TK, np.nan, np.float32)
    for j in range(TILE // C_BOX):
        for ml in range(TK):
            for bb in range(C_BOX):
                m, b = TK * kt + ml, rt * TILE + j * C_BOX + bb
                v = c[l, m, b] if m < m_dim and b < b_dim else 0.0
                addr = j * 4096 + ml * 128 + (((bb >> 2) ^ (ml & 7)) << 4) + (bb & 3) * 4
                smem[addr // 4] = v
    return smem


def _fragment_reads():
    """(wg, row, k, byte address) of each thread's A fragment reads, by
    (wg, warp % 4, lane, kk, e), as load_a computes them for kDaC."""
    wg, w, lane, kk, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                     np.arange(TK // 8), np.arange(4), indexing="ij")
    row = w * 16 + lane // 4 + 8 * (e & 1)
    k = 8 * kk + lane % 4 + 4 * (e >> 1)
    bb = row & (C_BOX - 1)
    addr = (wg * (TILE * TK * 4 // 2) + (row // C_BOX) * 4096 + k * 128
            + (((bb >> 2) ^ (k & 7)) << 4) + (bb & 3) * 4)
    return wg, row, k, addr


@pytest.mark.parametrize("m_dim,b_dim", [(257, 129), (130, 37), (33, 300)])
def test_a_fragments_hold_dct_split(m_dim, b_dim):
    """Each A fragment (row b = 64 wg + row, column m = 32 kt + k) reads c
    at (m, b) from the landed tile, 0 past M and past B; scaled by its
    row's 2g (2 g[l, b], 0 past B) and split, the fragments are the scale
    pass's dcᵀ hi and lo (tri_split_plain's rows_t) at (b, m)."""
    rng = np.random.default_rng(m_dim + b_dim)
    l_dim = 2
    c = rng.standard_normal((l_dim, m_dim, b_dim)).astype(np.float32)
    g = rng.standard_normal((l_dim, b_dim)).astype(np.float32)
    dct = tri_cuda.tri_split_plain(tri_cuda.tri_dc_from_c_plain(T(c), T(g)),
                                   transposed=True).rows_t  # (2, L, B, Mp)
    wg, row, k, addr = _fragment_reads()
    for l in range(l_dim):  # the last factor's last stage reads past c: zeros
        for rt in range(-(-b_dim // TILE)):
            b = rt * TILE + 64 * wg + row
            g2_row = np.where(b < b_dim, 2 * g[l, np.minimum(b, b_dim - 1)], 0).astype(np.float32)
            for kt in range(-(-m_dim // TK)):
                v = _c_tile(c, l_dim, m_dim, b_dim, l, kt, rt)[addr // 4]
                m = TK * kt + k
                want = np.where((m < m_dim) & (b < b_dim),
                                c[l, np.minimum(m, m_dim - 1), np.minimum(b, b_dim - 1)], 0)
                np.testing.assert_array_equal(v, want)
                hi, lo = tri_cuda.split_tf32(T(v) * T(g2_row))  # __fmul_rn, then the split
                inside = (b < b_dim) & (m < dct.shape[-1])
                for part, got in ((0, hi), (1, lo)):
                    ref = dct[part, l][np.minimum(b, b_dim - 1), np.minimum(m, dct.shape[-1] - 1)]
                    assert torch.equal(got[inside], ref[inside])
                    assert torch.all(got[~inside] == 0)


def test_fragment_reads_have_a_2_way_bank_conflict():
    """The transposed read, as the kernel's comment says: a warp's load
    (fixed kk, e) touches 4 rows m by 8 consecutive b, 16 banks, two lanes
    (two addresses) a bank."""
    wg, _, _, addr = _fragment_reads()
    for g_ in range(2):
        for w in range(4):
            for kk in range(TK // 8):
                for e in range(4):
                    a = addr[g_, w, :, kk, e]
                    assert len(set(a)) == 32
                    banks = (a // 4) % 32
                    _, counts = np.unique(banks, return_counts=True)
                    assert len(counts) == 16 and np.all(counts == 2)


def test_tri_cu_has_the_replayed_arithmetic():
    """The lines the replays above mirror are tri.cu's."""
    src = TRI_CU.read_text()
    for line in (
            "ct = nrt - 1 - r / nct;",
            "rt_begin = r % nct;",
            "if (kMode == kDaC) return 0;",
            "if (kMode == kDaC) return (ct + 1) * (TM / TK);",
            "if (mode == kDaC) return true;",
            "const int b = rt_begin * TM + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;",
            "g2_row[h] = b < p.B ? 2.f * p.g[(int64_t)l * p.B + b] : 0.f;",
            "const int bb = row & (C_BOX - 1);",
            "v = lds_f32(a32 + (row / C_BOX) * (TILE_BYTES / (TM / C_BOX)) + k * 128 +",
            "(((bb >> 2) ^ (k & 7)) << 4) + (bb & 3) * 4);",
            "v = __fmul_rn(g2_row[e & 1], v);",
            "const uint32_t a32 = tiles + s * kStageBytes + wg * (TILE_BYTES / 2);",
            "tma_load_3d(st + j * (TILE_BYTES / (TM / C_BOX)), &a_hi, rt * TM + j * C_BOX,",
            "kt * TK, l, bar);",
            "const uint64_t a_slabs = kMode == kDaC ? p.L : 0;",
            "const uint32_t a_box_rows = kMode == kDaC ? TK : TM;",
            "tile[(r0 + 8 * h) * (TN + 1) + c0 + 8 * j + e] = tot[4 * j + 2 * h + e];",
            "const int bl = t % TM, b = rt * TM + bl;",
            "float* da = p.out + ((int64_t)l * p.M + ct * TN) * p.B + b;",
            "for (int kl = t / TM; kl < TN && ct * TN + kl < p.M; kl += 2)",
            "da[(int64_t)kl * p.B] = tile[bl * (TN + 1) + kl];",
            "if constexpr (kMode == kDluC || kMode == kDaC) {",
            "stage_lu_rows_kernel<false><<<dim3((p.Mp + 255) / 256, p.Mp, L), 256, 0, st>>>("):
        assert line in src, line
    assert TRI_CU.read_text().count("C_BOX = 32;") == 1


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args,error", [
    ((_meta((2, 9, 9)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # no kernel for meta
    ((_meta((2, 9, 9), torch.float64), _meta((2, 9, 5), torch.float64),
      _meta((2, 5), torch.float64)), TypeError),  # float32 only
    ((_meta((2, 9, 9)).mT, _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # not contiguous
    ((_meta((9, 9)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # lu not (L, M, M)
    ((_meta((2, 9, 8)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # lu not square
    ((_meta((3, 9, 9)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # L differs
    ((_meta((2, 8, 8)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # M differs
    ((_meta((2, 9, 9)), _meta((2, 9, 5)), _meta((2, 4))), ValueError),  # g does not fit c
    ((_meta((2, 9, 9)), _meta((9, 5)), _meta((2, 5))), ValueError),  # c is not (L, M, B)
    ((torch.zeros(2, 9, 9), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # lu on the CPU
    ((torch.zeros(2, 9, 9), torch.zeros(2, 9, 5), _meta((2, 5))), ValueError),  # g not
])
def test_guards(args, error):
    """Off the CPU a tensor goes to the kernel or raises, and the counter
    does not move; shapes that do not fit raise on the CPU too."""
    before = tri_cuda.tri_da_from_c.launches
    with pytest.raises(error):
        tri_cuda.tri_da_from_c(*args)
    assert tri_cuda.tri_da_from_c.launches == before
