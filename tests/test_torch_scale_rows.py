"""The scale pass's rows and the dLu of colsum((Luᵀa)²) for a per-factor a,
on the CPU.

Where Lu trains and a is per factor (the MGGP W-form's a = W·Kzx, the
hybrids'), or a shared a that trains, ``tri_cuda.TriSqColsum``'s backward takes
dLu from the scale pass (``tri_dc_from_c``: dc = 2c·g as TF32 hi and lo rows,
on the card ``scale_rows_kernel``, blocks of 512 16-byte chunks of a row)
and kernel 6 (``tri_dlu``). Held here: the Function's dLu and da against JAX's
``tri_pallas._fused_bwd`` (the vjp of the panel-blocked colsum) in float64 at
1e-8 for a per-factor a, and its route by spies; the pass's row and chunk plan
and its arithmetic, replayed in float32, against the plain scale's split
(``tri_split_plain`` of ``tri_dc_from_c_plain``), which the card's rows are
held to bit for bit; the lines of tri.cu those replay; and the card route's
refusal of dcᵀ, which kernel 7 reading c forms itself.
"""

import contextlib
import functools
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpzoo_tpu.ops import tri_pallas

from gpzoo_tpu_torch.ops import tri_cuda

T = torch.tensor
TRI_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "tri.cu"
ROUTES = ("tri_dlu_from_c", "tri_dc_from_c", "tri_dlu", "tri_da", "tri_da_from_c")
#: float64 on both sides: the port's parity tolerance, relative to max |JAX|
TOL_F64 = 1e-8
#: (L, M, B): M over two and three 128-tiles and over JAX's six panels
#: (M >= 1,024), B on and off a 16-byte row
JAX_CASES = [(3, 200, 129), (3, 300, 128), (3, 257, 129), (2, 1100, 37)]
#: (L, M, B) of the pass's replays: B on and off a 16-byte row, below one
#: warp's 128 floats and over several, and a single element
ROWS_CASES = [(2, 3, 7000), (3, 5, 129), (1, 9, 37), (2, 7, 720), (1, 1, 1)]


def _close(got, expect):
    got = got.detach().numpy()
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=TOL_F64 * max(np.max(np.abs(expect)), 1e-300))


@functools.cache
def _case(l_dim, m_dim, b_dim, shared=False):
    """Lower-triangular Lu (L, M, M), a ((M, B) shared, else (L, M, B)) and
    a cotangent g (L, B), numpy float64, from one seed."""
    rng = np.random.default_rng(11 * m_dim + 3 * b_dim + l_dim + 1000 * shared)
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))) / np.sqrt(m_dim)
    a = rng.standard_normal((m_dim, b_dim) if shared else (l_dim, m_dim, b_dim))
    g = rng.standard_normal((l_dim, b_dim))
    return lu, a, g


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


@pytest.mark.parametrize("l_dim,m_dim,b_dim", JAX_CASES)
def test_function_matches_jax_fused_bwd(l_dim, m_dim, b_dim):
    """TriSqColsum's dLu and da for a per-factor a, both trained, against
    JAX's ``_fused_bwd`` (its vjp of the panel-blocked colsum, on the saved
    float64 operands) at 1e-8; dLu through the scale pass and kernel 6, so
    the bits of their plain forms."""
    lu, a, g = _case(l_dim, m_dim, b_dim)
    want_dlu, want_da = tri_pallas._fused_bwd(True, None, None, None,
                                              (jnp.asarray(lu), jnp.asarray(a)), jnp.asarray(g))
    lu_t, a_t = T(lu, requires_grad=True), T(a, requires_grad=True)
    with _routes() as calls:
        tri_cuda.tri_sq_colsum(lu_t, a_t).backward(T(g))
    assert calls == {**dict.fromkeys(ROUTES, 0), "tri_dc_from_c": 1, "tri_dlu": 1,
                     "tri_da_from_c": 1}
    _close(lu_t.grad, np.tril(np.asarray(want_dlu)))
    assert torch.all(lu_t.grad.triu(1) == 0)
    _close(a_t.grad, want_da)
    c = tri_cuda.tri_sq_colsum_c_plain(T(lu), T(a))[1]
    assert torch.equal(lu_t.grad,
                       tri_cuda.tri_dlu_plain(T(a), tri_cuda.tri_dc_from_c_plain(c, T(g))))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("trained", ["Lu", "both"])
def test_backward_route(shared, trained):
    """Wherever Lu trains beside a per-factor a, or a shared a that trains,
    dLu is the scale pass (rows only) and kernel 6, and da kernel 7 reading
    c; a shared, frozen ã keeps kernel 6 reading c."""
    lu, a, g = _case(3, 130, 37, shared)
    lu_t = T(lu, requires_grad=True)
    a_t = T(a, requires_grad=trained == "both")
    transposed = []
    with _routes() as calls:
        counted = tri_cuda.tri_dc_from_c

        def scale_pass(c, g, transposed_=False):
            transposed.append(transposed_)
            return counted(c, g, transposed_)
        with mock.patch.object(tri_cuda, "tri_dc_from_c", scale_pass):
            tri_cuda.tri_sq_colsum(lu_t, a_t).backward(T(g))
    if shared and trained == "Lu":
        route = {"tri_dlu_from_c": 1}
    else:
        route = {"tri_dc_from_c": 1, "tri_dlu": 1,
                 **({"tri_da_from_c": 1} if trained == "both" else {})}
    assert calls == {**dict.fromkeys(ROUTES, 0), **route}
    assert transposed == [False] * route.get("tri_dc_from_c", 0)


#: tri.cu's SCALE_THREADS and SCALE_CHUNKS: a block's threads, and the
#: 16-byte chunks of a row each thread takes
THREADS, CHUNKS = 128, 4


def _rows_pass(l_dim, m_dim, b_dim):
    """scale_rows_kernel's plan replayed: ``parts`` blocks a row of Bp floats
    (block x: row x / parts, part x % parts), thread t the 16-byte chunks
    part·512 + 128 j + t, j < 4, those below Bp / 4; returns the times each
    element of the rows (L M, Bp) is written and the b each write reads from
    c (-1: a zero past B)."""
    bp = -(-b_dim // 32) * 32
    parts = -(-(bp // 4) // (THREADS * CHUNKS))
    writes = np.zeros((l_dim * m_dim, bp), np.int64)
    reads = np.full((l_dim * m_dim, bp), -2, np.int64)
    for x in range(l_dim * m_dim * parts):
        row, part = divmod(x, parts)
        for t in range(THREADS):
            for j in range(CHUNKS):
                b = 4 * (part * THREADS * CHUNKS + j * THREADS + t)
                if b >= bp:
                    break
                for e in range(4):
                    writes[row, b + e] += 1
                    reads[row, b + e] = b + e if b + e < b_dim else -1
    return writes, reads


@pytest.mark.parametrize("l_dim,m_dim,b_dim", ROWS_CASES)
def test_rows_pass_writes_every_element_once(l_dim, m_dim, b_dim):
    """The pass writes each element of dc's rows, padding included, once,
    from c's own (row, b) below B and a zero past it; its float4 loads of c
    and g start 16-byte aligned where B % 4 == 0, and a chunk is then wholly
    below B or wholly past it."""
    writes, reads = _rows_pass(l_dim, m_dim, b_dim)
    assert np.all(writes == 1)
    bp = writes.shape[1]
    assert np.array_equal(reads, np.where(np.arange(bp) < b_dim, np.arange(bp), -1)[None]
                          .repeat(l_dim * m_dim, 0))
    if b_dim % 4 == 0:
        for row in range(l_dim * m_dim):
            assert (row * b_dim * 4) % 16 == 0 and (row // m_dim * b_dim * 4) % 16 == 0
        assert all(b + 3 < b_dim or b >= b_dim for b in range(0, bp, 4))


def _rna(x):
    """cvt.rna.tf32.f32 on finite float32: half a TF32 ulp added to the
    magnitude's bits, the low 13 cleared (ties away from zero)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    return (((u + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("l_dim,m_dim,b_dim", ROWS_CASES)
def test_rows_pass_arithmetic_is_the_plain_split(l_dim, m_dim, b_dim):
    """Each element as the pass forms it, v = (2g)·c rounded once in
    float32 (``__fmul_rn``), then hi = tf32(v) and lo = tf32(v - hi), at the
    places its plan writes, is the plain scale's split bit for bit: the
    reference the card's rows are held to."""
    rng = np.random.default_rng(7 * b_dim + m_dim)
    c = (rng.standard_normal((l_dim, m_dim, b_dim))
         * 10.0 ** rng.integers(-20, 20, (l_dim, m_dim, b_dim))).astype(np.float32)
    g = rng.standard_normal((l_dim, b_dim)).astype(np.float32)
    _, reads = _rows_pass(l_dim, m_dim, b_dim)
    rows = np.zeros((2,) + reads.shape, np.float32)
    c_rows = c.reshape(l_dim * m_dim, b_dim)
    for row in range(l_dim * m_dim):
        b = reads[row] >= 0
        v = (np.float32(2) * g[row // m_dim, reads[row, b]]) * c_rows[row, reads[row, b]]
        rows[0, row, b] = _rna(v)
        rows[1, row, b] = _rna(v - rows[0, row, b])
    want = tri_cuda.tri_split_plain(tri_cuda.tri_dc_from_c_plain(T(c), T(g))).rows
    assert np.array_equal(rows.view(np.uint32),
                          want.reshape(2, l_dim * m_dim, -1).numpy().view(np.uint32))


def test_tri_cu_has_the_replayed_arithmetic():
    """The lines the replays above follow are tri.cu's, and the split pass
    scales only into rows."""
    src = TRI_CU.read_text()
    for line in (
            "constexpr int SCALE_THREADS = 128, SCALE_CHUNKS = 4;",
            "const int64_t row = blockIdx.x / parts;  // l M + m",
            "const int part = blockIdx.x % parts;",
            "const int b = 4 * (part * SCALE_PART + j * SCALE_THREADS + (int)threadIdx.x);",
            "if (b >= Bp) break;",
            "const float v = b + e < B ? __fmul_rn(2.f * gb[j][e], x[j][e]) : 0.f;",
            "h[e] = tf32_rna(v);",
            "lo[e] = tf32_rna(v - h[e]);",
            "const int parts = (p.Bp / 4 + SCALE_PART - 1) / SCALE_PART;  // blocks a row",
            "const unsigned blocks = (unsigned)((int64_t)L * M * parts);",
            "if (rows_t != nullptr) return (int)cudaErrorInvalidValue;  // dcT: kernel 7 reads c"):
        assert line in src, line
    assert "template <bool kScale>" not in src


def _meta(shape):
    return torch.zeros(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("l_dim,m_dim,b_dim", [(2, 9, 5), (1, 1, 1)])
def test_card_route_writes_rows_only(l_dim, m_dim, b_dim):
    """Off the CPU the scale pass writes dc's rows only: asked for dcᵀ it
    raises before any launch, and the counter does not move. On the CPU the
    flag changes nothing (the plain dc)."""
    before = tri_cuda.tri_dc_from_c.launches
    with pytest.raises(ValueError, match="rows only"):
        tri_cuda.tri_dc_from_c(_meta((l_dim, m_dim, b_dim)), _meta((l_dim, b_dim)),
                               transposed=True)
    assert tri_cuda.tri_dc_from_c.launches == before
    c = torch.randn((l_dim, m_dim, b_dim))
    g = torch.randn((l_dim, b_dim))
    assert torch.equal(tri_cuda.tri_dc_from_c(c, g, transposed=True),
                       tri_cuda.tri_dc_from_c_plain(c, g))
