"""Kernel 6 reading c: the backward of colsum((Luᵀã)²) for a shared, frozen ã,
on the CPU.

Where ã is shared by the factors, (M, B), and takes no gradient (the north-star
projection; the fast leg's ã = K⁻¹Kzx with Z and the kernel frozen),
``tri_cuda.TriSqColsum``'s backward is one launch, ``tri_dlu_from_c``: on the
card kernel 6 with its operands swapped (A = c's rows, scaled by 2g and split in
registers; B = ã split once), so that dc = 2c·g is never written; here its plain
form ``tri_dlu_from_c_plain``. Held against ``jax.grad`` of
``gpzoo_tpu.ops.tri_blocked.tri_sq_colsum`` with respect to Lu in float64 at
1e-8 (M = 130 and 1,100, L = 1 and 3), bit for bit against the route it
replaces there (the scale pass, then kernel 6) and the route that recomputes c;
the Function's choice of route, by spies on the wrappers, for a shared and a
per-factor a, frozen and trained, and in the precomputed and blockwise losses;
tri.cu's kDluC block decode, its transposed store (every element of dLu written
once, zeros above the diagonal, whole 32-byte sectors) and its A fragments' b
index for g, replayed from the kernel's own arithmetic; and the wrapper's guards
on ``meta`` tensors.
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
from _tri_decodes import M_REPLAY

from gpzoo_tpu.ops import tri_blocked as jtri

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.ops import tri_cuda

T = torch.tensor
B = 37  # off the 128 tile and off a 16-byte row: the kernel copies c's rows
CASES = [(m, l_dim) for m in (130, 1100) for l_dim in (1, 3)]
TILE, TK = 128, 32
TRI_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "tri.cu"
ROUTES = ("tri_dlu_from_c", "tri_dc_from_c", "tri_dlu", "tri_da", "tri_da_from_c")


def _close(got, expect, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@functools.cache
def _case(m_dim, l_dim, shared=True):
    """Lower-triangular Lu (L, M, M), a ((M, B) shared, else (L, M, B)) and
    a cotangent g (L, B), numpy float64, with JAX's dLu of Σ g·colsum."""
    rng = np.random.default_rng(7 * m_dim + l_dim + 100 * shared)
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))) / np.sqrt(m_dim)
    a = rng.standard_normal((m_dim, B) if shared else (l_dim, m_dim, B))
    g = rng.standard_normal((l_dim, B))

    def f(u):
        return jnp.sum(jnp.asarray(g) * jtri.tri_sq_colsum(jnp.tril(u), jnp.asarray(a)))
    return lu, a, g, np.asarray(jax.grad(f)(jnp.asarray(lu)))


def _kept_c(lu, a):
    return tri_cuda.tri_sq_colsum_c_plain(T(lu), T(a))[1]


@pytest.mark.parametrize("m_dim,l_dim", CASES)
def test_plain_form_matches_jax_grad(m_dim, l_dim):
    """The plain form of kernel 6 reading c is JAX's dLu (tril) at 1e-8,
    exact zeros above the diagonal; the wrapper takes it on the CPU and
    counts no launch."""
    lu, a, g, dlu = _case(m_dim, l_dim)
    got = tri_cuda.tri_dlu_from_c_plain(T(a), _kept_c(lu, a), T(g))
    assert got.shape == (l_dim, m_dim, m_dim)
    _close(got, np.tril(dlu), 1e-8)
    assert torch.all(got.triu(1) == 0)
    before = tri_cuda.tri_dlu_from_c.launches
    assert torch.equal(tri_cuda.tri_dlu_from_c(T(a), _kept_c(lu, a), T(g)), got)
    assert tri_cuda.tri_dlu_from_c.launches == before


@pytest.mark.parametrize("m_dim,l_dim", CASES)
def test_plain_form_is_the_old_routes_bits(m_dim, l_dim):
    """The same bits as the scale pass followed by kernel 6 (plain forms)
    and as the route that recomputed c (tri_dc_plain, then kernel 6)."""
    lu, a, g, _ = _case(m_dim, l_dim)
    c = _kept_c(lu, a)
    got = tri_cuda.tri_dlu_from_c_plain(T(a), c, T(g))
    scale_pass = tri_cuda.tri_dc_from_c(c, T(g))  # the CPU route: dc (L, M, B)
    assert torch.equal(got, tri_cuda.tri_dlu(T(a), scale_pass))
    recompute = tri_cuda.tri_dc_plain(T(lu), T(a), T(g))
    assert torch.equal(got, tri_cuda.tri_dlu_plain(T(a), recompute))


@contextlib.contextmanager
def _routes():
    """Counts the calls of the backward's wrappers (ROUTES) by name."""
    calls = dict.fromkeys(ROUTES, 0)
    with contextlib.ExitStack() as stack:
        for name in ROUTES:
            inner = getattr(tri_cuda, name)

            def spy(*args, _inner=inner, _name=name, **kwargs):
                calls[_name] += 1
                return _inner(*args, **kwargs)
            stack.enter_context(mock.patch.object(tri_cuda, name, spy))
        yield calls


@pytest.mark.parametrize("form,trained,route", [
    ("shared", "Lu", {"tri_dlu_from_c": 1}),
    ("shared", "both", {"tri_dc_from_c": 1, "tri_dlu": 1, "tri_da_from_c": 1}),
    ("shared", "a", {"tri_da_from_c": 1}),
    ("per-factor", "Lu", {"tri_dc_from_c": 1, "tri_dlu": 1}),
    ("per-factor", "both", {"tri_dc_from_c": 1, "tri_dlu": 1, "tri_da_from_c": 1}),
])
def test_function_takes_the_new_route_only_for_a_shared_frozen_a(form, trained, route):
    """TriSqColsum's backward launches kernel 6 reading c exactly where a is
    (M, B) and takes no gradient, and the per-factor route elsewhere (the
    scale pass and kernel 6 where Lu trains, kernel 7 reading c where a
    does); the gradients are JAX's either way, and the new route's the old
    one's bits."""
    lu, a, g, dlu = _case(130, 3, form == "shared")
    lu_t = T(lu, requires_grad=trained != "a")
    a_t = T(a, requires_grad=trained != "Lu")
    with _routes() as calls:
        tri_cuda.tri_sq_colsum(lu_t, a_t).backward(T(g))
    assert calls == {**dict.fromkeys(ROUTES, 0), **route}
    if trained == "a":
        assert lu_t.grad is None
        return
    _close(lu_t.grad, np.tril(dlu), 1e-8)
    if route.get("tri_dlu_from_c"):
        c = _kept_c(lu, a)
        old = tri_cuda.tri_dlu_plain(T(a), tri_cuda.tri_dc_from_c_plain(c, T(g)))
        assert torch.equal(lu_t.grad, old)


def _north_star_model():
    cfg = gt.SlideseqNSFConfig(D=20, N=300, L=3, M=40, batch_size=64)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-2, 2, (300, 2)))
    y = torch.tensor(rng.poisson(3.0, (300, 20)).astype(np.float64))  # spot-major
    model = cfg.build(torch.Generator().manual_seed(0), x.float()).double()
    with torch.no_grad():
        model.prior.Lu_raw.copy_(torch.tril(0.2 * torch.tensor(rng.standard_normal((3, 40, 40)))))
    idx = torch.tensor(rng.choice(300, 64, replace=False))
    eps = torch.tensor(rng.standard_normal((1, 3, 64)))
    return model, x, y, idx, eps


def test_precomputed_loss_takes_kernel_6_reading_c():
    """The north-star loss (a frozen projection: ã shared, no gradient) runs
    kernel 6 reading c once a step and neither the scale pass nor kernel 6
    on a dc; its Lu gradient is the old route's, bit for bit."""
    model, x, y, idx, eps = _north_star_model()
    proj = gt.precompute_nsf_projection(model, x)

    def lu_grad():
        model.zero_grad(set_to_none=True)
        gt.nsf_negative_elbo_precomputed(model, proj, y, idx, eps,
                                         y_transposed=True).backward()
        return model.prior.Lu_raw.grad.clone()

    with _routes() as calls:
        new = lu_grad()
    assert calls == {**dict.fromkeys(ROUTES, 0), "tri_dlu_from_c": 1}

    def old_route(a, c, g):
        return tri_cuda.tri_dlu(a, tri_cuda.tri_dc_from_c(c, g))
    with mock.patch.object(tri_cuda, "tri_dlu_from_c", old_route):
        assert torch.equal(lu_grad(), new)


def test_blockwise_collapse_with_a_frozen_kernel_takes_kernel_6_reading_c():
    """The fast leg's blockwise collapse, Z and the kernel frozen: its ã =
    K⁻¹Kzx is shared and takes no gradient, so the new route runs, once a
    chunk."""
    model, x, y, idx, eps = _north_star_model()
    for p in (model.prior.Z, *model.prior.kernel.parameters()):
        p.requires_grad_(False)
    with _routes() as calls:
        gt.nsf_negative_elbo_batched(model, x, y, idx, eps, microbatch=32, factored=True,
                                     shared_kernel=True, remat=False,
                                     y_transposed=True).backward()
    assert calls == {**dict.fromkeys(ROUTES, 0), "tri_dlu_from_c": 2}


def _dluc_block(bid, nrt):
    """tri_mma_kernel<kDluC>'s block decode (kernel 8's): (l, rt, ct), the
    row (m) tile rt <= the column (k) tile ct, factor slowest."""
    pairs = nrt * (nrt + 1) // 2
    l, q = divmod(bid, pairs)
    ct = int((np.sqrt(np.float32(8 * q + 1), dtype=np.float32) - np.float32(1))
             * np.float32(0.5))
    while ct * (ct + 1) // 2 > q:
        ct -= 1
    while (ct + 1) * (ct + 2) // 2 <= q:
        ct += 1
    return l, q - ct * (ct + 1) // 2, ct


@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_decode_visits_each_pair_once(m_dim):
    """Every (m tile, k tile >= m tile) pair of every factor once, factor
    slowest, and no other tile."""
    nrt, l_dim = -(-m_dim // TILE), 3
    seen = [_dluc_block(bid, nrt) for bid in range(l_dim * nrt * (nrt + 1) // 2)]
    assert sorted(seen) == sorted((l, rt, ct) for l in range(l_dim) for ct in range(nrt)
                                  for rt in range(ct + 1))
    assert [s[0] for s in seen] == sorted(s[0] for s in seen)


def _fragments():
    """(row, col) offsets in the 128 x 128 tile of each consumer thread's
    stores, by (warp, lane, j, h, e), as tri.cu computes them."""
    warp, lane, j, h, e = np.meshgrid(np.arange(8), np.arange(32), np.arange(16),
                                      np.arange(2), np.arange(2), indexing="ij")
    row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4
    col = 2 * (lane % 4)
    return row, col, j, h, e


@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_store_writes_every_element_of_dlu_once(m_dim):
    """kDluC's epilogue replayed: tile (rt, ct) stores its element (m, k)
    at dLu[k, m] (the sum where k >= m, else 0) and, off the diagonal, 0 at
    its mirror; every element of dLu is written once, each sum where k >= m
    is the tile's element (m, k), and nothing else is written."""
    row, col, j, h, e = _fragments()
    nrt = -(-m_dim // TILE)
    writes = np.zeros((m_dim, m_dim), np.int64)
    source = np.full((m_dim, m_dim, 2), -1, np.int64)  # the (m, k) a sum came from
    for rt in range(nrt):
        for ct in range(rt, nrt):
            r, c = rt * TILE + row, ct * TILE + col
            m, k = r + 8 * h, c + 8 * j + e
            keep = (k < m_dim) & (m < m_dim)
            np.add.at(writes, (k[keep], m[keep]), 1)
            summed = keep & (k >= m)
            source[k[summed], m[summed]] = np.stack([m[summed], k[summed]], axis=-1)
            mirror_k = rt * TILE + (c - ct * TILE) + 8 * j + e
            mirror_m = ct * TILE + (r - rt * TILE) + 8 * h
            mirror = (ct > rt) & (mirror_k < m_dim) & (mirror_m < m_dim)
            np.add.at(writes, (mirror_k[mirror], mirror_m[mirror]), 1)
            assert np.all(mirror_k[mirror] < mirror_m[mirror])  # above the diagonal
    assert np.all(writes == 1)
    kk, mm = np.meshgrid(np.arange(m_dim), np.arange(m_dim), indexing="ij")
    lower = kk >= mm
    np.testing.assert_array_equal(source[lower][:, 0], mm[lower])
    np.testing.assert_array_equal(source[lower][:, 1], kk[lower])
    assert np.all(source[~lower] == -1)


@pytest.mark.parametrize("m_dim", [3000, 3010])
def test_a_warps_store_is_whole_sectors(m_dim):
    """Each store instruction of a warp (fixed warp, j, h, e) writes, for
    each lane % 4, 8 consecutive floats of one row k of dLu: 32 bytes, one
    sector where M is a multiple of 8 floats (the north-star M)."""
    row, col, j, h, e = _fragments()
    rt, ct = 1, 3
    addr = (ct * TILE + col + 8 * j + e) * m_dim + rt * TILE + row + 8 * h
    for w in range(8):
        for jj in range(16):
            for hh in range(2):
                for ee in range(2):
                    a = addr[w, :, jj, hh, ee]
                    for t in range(4):
                        run = np.sort(a[np.arange(32) % 4 == t])
                        np.testing.assert_array_equal(np.diff(run), 1)
                        if m_dim % 8 == 0:
                            assert (run[0] * 4) % 32 == 0


@pytest.mark.parametrize("b_dim", [1, 37, 129, 7000])
def test_a_fragments_read_g_at_their_b(b_dim):
    """A thread's fragment (kk, e) of stage kt holds column k = 8 kk +
    lane % 4 + 4 (e >> 1) of the stage, b = 32 kt + k; the 2g it is scaled
    by (g2[kk][e >> 1]) is slot k of the stage's 32, which the producer
    copies from 2g's row l at 32 kt (rows of Bp, 0 past B): 2g at that b;
    scaled and split, the A values are the scale pass's TF32 hi and lo
    rows."""
    lane, kk, e = np.meshgrid(np.arange(32), np.arange(TK // 8), np.arange(4),
                              indexing="ij")
    k_frag = 8 * kk + lane % 4 + 4 * (e >> 1)  # the fragment's column, as load_a reads c
    u = e >> 1  # it is scaled by g2[kk][u], read from slot 8 kk + lane % 4 + 4 u
    k_slot = 8 * kk + lane % 4 + 4 * u
    np.testing.assert_array_equal(k_frag, k_slot)
    assert sorted(set(k_frag.ravel())) == list(range(TK))
    rng = np.random.default_rng(b_dim)
    l_dim, m_dim = 2, 9
    c = torch.tensor(rng.standard_normal((l_dim, m_dim, b_dim)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((l_dim, b_dim)), dtype=torch.float32)
    bp = tri_cuda.padded_b(b_dim)
    g2 = torch.zeros((l_dim, bp))  # double_g_kernel: rows of Bp, 0 past B
    g2[:, :b_dim] = 2 * g
    c_rows = torch.zeros((l_dim, m_dim, bp))  # TMA reads past B as zeros
    c_rows[..., :b_dim] = c
    scaled = torch.zeros((l_dim, m_dim, bp))
    for kt in range(bp // TK):
        slot = g2[:, kt * TK:(kt + 1) * TK]  # the producer's 128-byte copy
        for k in k_frag.ravel():
            scaled[..., kt * TK + k] = slot[:, k, None] * c_rows[..., kt * TK + k]
    hi, lo = tri_cuda.split_tf32(scaled)
    rows = tri_cuda.tri_split_plain(tri_cuda.tri_dc_from_c_plain(c, g)).rows
    assert torch.equal(hi, rows[0]) and torch.equal(lo, rows[1])


def test_tri_cu_has_the_replayed_arithmetic():
    """The lines the replays above mirror are tri.cu's."""
    src = TRI_CU.read_text()
    for line in (
            "} else if constexpr (is_trace(kMode) || kMode == kDluC) {",
            "bulk_load(smem_u32(red) + s * TK * 4, p.g + (int64_t)l * p.Bp + kt * TK, TK * 4, bar);",
            "g2[kk][u] = lds_f32(g32 + (8 * kk + lane % 4 + 4 * u) * 4);",
            "g2[i] = b < B ? 2.f * g[(int64_t)l * B + b] : 0.f;",
            "if constexpr (kMode == kDluC) v = __fmul_rn(g2[kk][e >> 1], v);",
            "const int mirror_k = rt * TM + (col - ct * TN), mirror_m = ct * TN + (row - rt * TM);",
            "p.out[((int64_t)l * p.M + k) * p.M + m] = k >= m ? tot[4 * j + 2 * h + e] : 0.f;",
            "const int k2 = mirror_k + 8 * j + e, m2 = mirror_m + 8 * h;",
            "if (ct > rt && k2 < p.M && m2 < p.M) p.out[((int64_t)l * p.M + k2) * p.M + m2] = 0.f;",
            "return (kMode == kDlu || kMode == kDluC || is_da(kMode)) ? 0 : rt * (TM / TK);",
            "if (mode == kDluC) return true;",
            "int err = tri_split_f32(a, nullptr, a_rows, nullptr, 1, M, B, stream);"):
        assert line in src, line
    # the three products in kernel 6's order: a_lo dc_hi (A hi, B lo), then
    # a_hi dc_lo (A lo, B hi), then a_hi dc_hi
    body = src[src.index("if constexpr (kMode == kDluC || kMode == kDaC) {\n"
                         "            // kDlu's order"):]
    first = body.index("wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bl + off));")
    second = body.index("wgmma_tf32_ra<1>(acc, cur_lo[kk], smem_desc(bh + off));")
    third = body.index("wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bh + off));")
    assert first < second < third


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args,error", [
    ((_meta((9, 5)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # no kernel for meta
    ((_meta((9, 5), torch.float64), _meta((2, 9, 5), torch.float64),
      _meta((2, 5), torch.float64)), TypeError),  # float32 only
    ((_meta((5, 9)).mT, _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # not contiguous
    ((_meta((2, 9, 5)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # a per factor
    ((_meta((9, 6)), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # a does not fit c
    ((_meta((9, 5)), _meta((2, 9, 5)), _meta((2, 4))), ValueError),  # g does not fit c
    ((_meta((9, 5)), _meta((9, 5)), _meta((2, 5))), ValueError),  # c is not (L, M, B)
    ((torch.zeros(9, 5), _meta((2, 9, 5)), _meta((2, 5))), ValueError),  # a on the CPU
    ((torch.zeros(9, 5), torch.zeros(2, 9, 5), _meta((2, 5))), ValueError),  # g not
])
def test_guards(args, error):
    """Off the CPU a tensor goes to the kernel or raises, and the counter
    does not move; shapes that do not fit raise on the CPU too."""
    before = tri_cuda.tri_dlu_from_c.launches
    with pytest.raises(error):
        tri_cuda.tri_dlu_from_c(*args)
    assert tri_cuda.tri_dlu_from_c.launches == before
