#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gpzoo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel in gpzoo_tpu_torch/ops/csrc with nvcc
               (one process per source, all at once) and print each
               kernel's registers and spills;
  2. kernels — each kernel against its plain PyTorch version in float32, at
               the paths' shapes and at a ragged small shape, with the
               median time of each beside the plain version's, the bound
               (the least time the card could take) and, where one PyTorch
               call computes the same function, that call's time (kernels
               1-2 also with the MGGP step's per-factor a; kernel 4 at the
               MGGP step's Kzz and Kzx and under each α convention);
  3. main    — the north-star NSF training step at full width (N=45,000,
               D=4,000, L=20, M=3,000, batch 7,000): config build, the
               precomputed projection, warm-up and timed Adam steps, the
               held-out deviance, peak memory and each kernel's launch count,
               then one step with the kernels against the same step with the
               plain versions, and a small input against the float64 CPU path;
  4. vnngp   — NSF over a VNNGP at full width (N=100,000, D=500, L=10,
               M=1,000, K=8, batch 5,000): (a) the frozen-geometry tier,
               (b) the all-trainable step, with a profiled window and timed
               turns against kernel 5's plain version, (c) the 100k-spot
               posterior, held against the same posterior with kernel 5's
               plain version, and the held-out deviance, each with its
               kernels' launch counts; then one all-trainable step with kernel
               5 against the same step with its plain version, and a small
               input against the float64 CPU path;
  5. mggp    — the MGGP-NSF step of bench.py's MGGP leg at full width
               (N=45,000, D=4,000, L=20, M=3,010 = 215 x 14 groups, batch
               7,000, trainable kernels and embedding, Z frozen): build,
               warm-up and timed Adam steps, the held-out deviance from the
               posterior at the last 2,000 spots, peak memory, launches per
               step, a profiled window, one step with kernels 1 and 4
               against the same step with their plain versions, and a small
               two-chunk input against the float64 CPU path.
The last three lines are the card's name and power limit, one JSON line with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Without CUDA
the script exits 1 before doing anything else. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# Tolerances, each on max|got − ref| / max|ref| in float32:
# the tri kernels sum 3,000 products in another order than cuBLAS
# (relative rounding ~ sqrt(M)·2^-24 ≈ 3e-6), so 1e-4 leaves margin;
TOL_TRI = 1e-4
# the Gram's plain form expands ‖x‖² − 2x·z + ‖z‖², whose cancellation near
# d = 0 costs up to ~4·2^-24·(‖x‖² + ‖z‖²) ≈ 4e-6 at |coords| ≤ 2√2;
TOL_GRAM = 2e-5
# a whole step compounds the variance difference through sqrt, exp and the
# Poisson log-likelihood over 28M entries;
TOL_STEP_LOSS = 1e-4   # relative
TOL_STEP_GRAD = 1e-3
# float32 on the card against the float64 CPU path on a small input
# (Cholesky of Kzz + 0.1·I in float32 loses ~κ·2^-24 ≈ 1e-4).
TOL_SMALL = 2e-3
# kernel 5 factors each K x K block itself, in another order than the
# batched cuSOLVER Cholesky of the plain form: a block of condition number
# kappa <~ 10^2 loses about kappa * K * 2^-24 ~ 5e-5 of relative accuracy.
TOL_BLOCK = 1e-4

MAIN = dict(N=45_000, D=4_000, L=20, M=3_000, B=7_000)
# the MGGP-NSF step of bench.py's MGGP leg (benchmarks/mggp_anatomy.py):
# M = 215 inducing points x 14 groups
MGGP = dict(N=45_000, D=4_000, L=20, M_per_group=215, G=14, B=7_000)
HOLDOUT = 2_000
WARMUP_STEPS, TIMED_STEPS = 3, 10
VNNGP_WARMUP, VNNGP_TIMED, PROFILED_STEPS, AB_STEPS = 3, 30, 5, 10
MGGP_PROFILED_STEPS = 2

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s without
# tensor cores. TF32 is off, so every kernel here is held to the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def norm_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def bound(bytes_moved, flops):
    """(ms, resource): the least time the card could take to move the bytes
    at the HBM rate or do the FLOPs at the f32 rate, whichever is longer."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_flops(k):
    """FLOPs of one point of the K x K conditioning: the Cholesky
    (K^3/3 + K(K-1)/2 multiplies + K roots), two substitutions (2K^2),
    the mean (2K) and the cov quadratic form with its difference (3K^2+2K)."""
    return k ** 3 / 3 + k * (k - 1) / 2 + 5 * k * k + 5 * k


def median_ms(fn, reps):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Checks:
    def __init__(self):
        self.failed = []

    def le(self, what, value, tol):
        ok = math.isfinite(value) and value <= tol
        log(f"  {'ok  ' if ok else 'FAIL'} {what}: {value:.3e} (tol {tol:.0e})")
        if not ok:
            self.failed.append(what)

    def true(self, what, cond):
        log(f"  {'ok  ' if cond else 'FAIL'} {what}")
        if not cond:
            self.failed.append(what)


def phase_build():
    from gpzoo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"[build] {', '.join(f'{k}.cu {v:.1f}s' for k, v in seconds.items())}"
        f" — {time.perf_counter() - t0:.1f}s wall")
    for name in seconds:
        # ptxas reports each kernel as "Compiling entry function '<name>'",
        # then its stack/spill line and its "Used N registers" line
        entry = None
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                # the mangled name's last identifier that ends in "kernel"
                found = re.search(r"\d([A-Za-z_]+kernel)(?:ILi(\d+)E)?", line.split("'")[1])
                entry = found.group(1) + (f"<{found.group(2)}>" if found.group(2) else "")
            elif entry and ("spill" in line or "registers" in line):
                log(f"  ptxas {name}.cu {entry}: {line.split(':', 1)[-1].strip()}")


def _tri_case(checks, dev, g, L, M, B, label, timings=None, per_factor=False):
    """Kernels 1-2 against their plain versions with a shared a (M, B), the
    north-star projection, or a per-factor a (L, M, B), the MGGP step's
    a = W·Kzx (then da is checked as well)."""
    import torch
    from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / math.sqrt(M)
    a = torch.randn((L, M, B) if per_factor else (M, B), generator=g, device=dev)
    out = tri_cuda.tri_sq_colsum_fused(lu, a)
    ref = tri_blocked.tri_sq_colsum(lu, a)
    checks.le(f"tri_sq_colsum {label}", norm_err(out, ref), TOL_TRI)
    err1 = float((out - ref).abs().max())
    del out, ref
    c = tri_cuda.tri_t_matmul(lu, a)
    ref = tri_blocked.tri_t_matmul(lu, a)
    checks.le(f"tri_t_matmul {label}", norm_err(c, ref), TOL_TRI)
    err2 = float((c - ref).abs().max())
    del c, ref
    gout = torch.randn((L, B), generator=g, device=dev)
    lu_k = lu.clone().requires_grad_()
    a_k = a.clone().requires_grad_(per_factor)
    tri_cuda.tri_sq_colsum(lu_k, a_k).backward(gout)
    lu_p = lu.clone().requires_grad_()
    a_p = a.clone().requires_grad_(per_factor)
    tri_blocked.tri_sq_colsum(lu_p, a_p).backward(gout)
    checks.le(f"TriSqColsum dLu {label}",
              norm_err(lu_k.grad, torch.tril(lu_p.grad)), TOL_TRI)
    if per_factor:
        checks.le(f"TriSqColsum da {label}", norm_err(a_k.grad, a_p.grad), TOL_TRI)
    del lu_k, lu_p, a_k, a_p
    torch.cuda.synchronize()
    if timings is not None:
        # each input byte read once: Lu's lower triangle and a; the
        # triangle is L*B*M(M+1)/2 FMAs
        tri_bytes = 4 * (L * M * (M + 1) // 2 + a.numel())
        tri_flops = L * B * M * (M + 1)
        bound_ms, bound_by = bound(tri_bytes + 4 * L * B, tri_flops + 2 * L * M * B)
        timings["tri_sq_colsum"] = dict(
            max_abs_err=err1,
            ms=median_ms(lambda: tri_cuda.tri_sq_colsum_fused(lu, a), 5),
            plain_ms=median_ms(lambda: tri_blocked.tri_sq_colsum(lu, a), 5),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        bound_ms, bound_by = bound(tri_bytes + 4 * L * M * B, tri_flops)
        timings["tri_t_matmul"] = dict(
            max_abs_err=err2,
            ms=median_ms(lambda: tri_cuda.tri_t_matmul(lu, a), 5),
            plain_ms=median_ms(lambda: tri_blocked.tri_t_matmul(lu, a), 5),
            bound_ms=bound_ms, bound_by=bound_by,
            # one cuBLAS call computes the same c, Lu being lower-triangular
            library_ms=median_ms(lambda: torch.matmul(lu.mT, a), 5))
        fwd_bwd = dict(
            kernel=lambda: tri_cuda.tri_sq_colsum(lu.requires_grad_(), a).backward(gout),
            plain=lambda: tri_blocked.tri_sq_colsum(lu.requires_grad_(), a).backward(gout))
        for name, fn in fwd_bwd.items():
            ms = median_ms(fn, 3)
            lu.grad = None
            log(f"  time TriSqColsum fwd+bwd ({name}): {ms:.3f} ms")
        lu.requires_grad_(False)


def _gram_case(checks, dev, g, x, z, sigma, ell, label, timings=None):
    from gpzoo_tpu_torch.ops import gram_cuda

    out = gram_cuda.rbf_gram_fwd(x, z, sigma, ell)
    ref = gram_cuda.rbf_gram_plain(x, z, sigma, ell)
    checks.le(f"rbf_gram {label}", norm_err(out, ref), TOL_GRAM)
    if timings is not None:
        (n, dim), m, l_dim = x.shape, z.shape[0], sigma.shape[0]
        # d^2 costs 3 FLOP per coordinate, each of the L epilogues ~3
        bound_ms, bound_by = bound(4 * ((n + m) * dim + 2 * l_dim + l_dim * n * m),
                                   n * m * 3 * dim + l_dim * n * m * 3)
        timings["rbf_gram"] = dict(
            max_abs_err=float((out - ref).abs().max()),
            ms=median_ms(lambda: gram_cuda.rbf_gram_fwd(x, z, sigma, ell), 20),
            plain_ms=median_ms(lambda: gram_cuda.rbf_gram_plain(x, z, sigma, ell), 20),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _mggp_case(checks, dev, g, n, m, l_dim, n_groups, convention, label,
               timings=None, tail=None):
    """Kernel 4 against its plain version: x (n, 2), z (m, 2), the
    complete-graph embedding of n_groups gathered by random labels, α under
    ``convention`` (negative raw values for ABS and SQUARED). With ``tail``
    only the last ``tail`` columns are held against the plain version (the
    plain form of a 10 GB Gram would not fit beside it)."""
    import torch
    from gpzoo_tpu_torch.bijectors import GroupDiffConvention
    from gpzoo_tpu_torch.kernels.mggp import _default_embedding
    from gpzoo_tpu_torch.ops import mggp_cuda

    emb = _default_embedding(n_groups, torch.float32, dev)
    x = torch.rand((n, 2), generator=g, device=dev) * 4 - 2
    z = torch.rand((m, 2), generator=g, device=dev) * 4 - 2
    ex = emb[torch.randint(n_groups, (n,), generator=g, device=dev)]
    ez = emb[torch.randint(n_groups, (m,), generator=g, device=dev)]
    sign = 1.0 if convention == "RAW" else -1.0
    args = (x, z, ex, ez, torch.linspace(0.5, 1.5, l_dim, device=dev),
            torch.linspace(0.8, 2.0, l_dim, device=dev),
            GroupDiffConvention[convention].apply(
                sign * torch.linspace(0.2, 2.5, l_dim, device=dev)), 2)
    out = mggp_cuda.mggp_gram_fwd(*args)
    if tail:
        out = out[..., -tail:]
        ref = mggp_cuda.mggp_gram_plain(x, z[-tail:], ex, ez[-tail:], *args[4:])
    else:
        ref = mggp_cuda.mggp_gram_plain(*args)
    checks.le(f"mggp_gram {label} {convention}", norm_err(out, ref), TOL_GRAM)
    if timings is not None:
        e_dim = ex.shape[1]
        # d^2 and g^2 cost 3 FLOP per coordinate; each of the L epilogues ~8
        # (fma, divide, 2 mul, exp, 2 mul); the output dominates the bytes
        bound_ms, bound_by = bound(
            4 * ((n + m) * (2 + e_dim) + 3 * l_dim + l_dim * n * m),
            n * m * 3 * (2 + e_dim) + l_dim * n * m * 8)
        timings["mggp_gram"] = dict(
            max_abs_err=float((out - ref).abs().max()),
            ms=median_ms(lambda: mggp_cuda.mggp_gram_fwd(*args), 20),
            plain_ms=median_ms(lambda: mggp_cuda.mggp_gram_plain(*args), 5),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    del out, ref


def _block_operands(g, dev, n, k):
    """SPD blocks as in tests/test_pallas.py: kzz = aaᵀ + 3I, s = bbᵀ."""
    import torch

    a = torch.randn((n, k, k), generator=g, device=dev)
    b = torch.randn((n, k, k), generator=g, device=dev) * 0.3
    return (a @ a.mT + 3 * torch.eye(k, device=dev), b @ b.mT,
            torch.randn((n, k), generator=g, device=dev),
            torch.randn((n, k), generator=g, device=dev),
            torch.rand((n,), generator=g, device=dev) * 1.5 + 0.5)


def _block_case(checks, dev, g, n, k, label, timings=None):
    from gpzoo_tpu_torch.ops import vnngp_cuda

    ops = _block_operands(g, dev, n, k)
    jitter = 0.1
    mean, cov = vnngp_cuda.block_conditional_fwd(*ops, jitter)
    ref_mean, ref_cov = vnngp_cuda.block_conditional_plain(*ops, jitter)
    checks.le(f"block_conditional mean {label}", norm_err(mean, ref_mean), TOL_BLOCK)
    checks.le(f"block_conditional cov {label}", norm_err(cov, ref_cov), TOL_BLOCK)
    if timings is None:
        return
    ms = median_ms(lambda: vnngp_cuda.block_conditional_fwd(*ops, jitter), 20)
    plain_ms = median_ms(lambda: vnngp_cuda.block_conditional_plain(*ops, jitter), 5)
    # in: kzz and s (K*K each), kxz and mu (K each), kxx; out: mean, cov
    bound_ms, bound_by = bound(4 * n * (2 * k * k + 2 * k + 1) + 8 * n,
                               n * block_flops(k))
    log(f"  time block_conditional {label}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    timings[label] = dict(
        max_abs_err=max(float((mean - ref_mean).abs().max()),
                        float((cov - ref_cov).abs().max())),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)


def vnngp_full_shape():
    """bench.py's VNNGP leg at its published full width, VNNGP_SHAPES["full"]."""
    from gpzoo_tpu_torch import VNNGP_SHAPES

    return dict(zip(("N", "D", "L", "M", "K", "B"), VNNGP_SHAPES["full"]))


def _log_timings(timings, label=""):
    for name, t in timings.items():
        lib = "" if t["library_ms"] is None else f", library {t['library_ms']:.3f} ms"
        log(f"  time {name}{label}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms{lib}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")


def phase_kernels(checks, dev, vnngp):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    timings = {}
    log("[kernels] float32, kernel against plain on the same inputs")
    _tri_case(checks, dev, g, 3, 130, 140, "L=3 M=130 B=140")
    _tri_case(checks, dev, g, MAIN["L"], MAIN["M"], MAIN["B"],
              "L={L} M={M} B={B}".format(**MAIN), timings)
    torch.cuda.empty_cache()
    # the MGGP step's per-factor a = W·Kzx
    m_mggp = MGGP["M_per_group"] * MGGP["G"]
    per_factor = {}
    _tri_case(checks, dev, g, 3, 130, 140, "per-factor a L=3 M=130 B=140",
              per_factor=True)
    _tri_case(checks, dev, g, MGGP["L"], m_mggp, MGGP["B"],
              f"per-factor a L={MGGP['L']} M={m_mggp} B={MGGP['B']}", per_factor,
              per_factor=True)
    _log_timings(per_factor, " (per-factor a, the MGGP step's shape)")
    torch.cuda.empty_cache()

    one = torch.ones(1, device=dev)
    small_x = torch.rand((130, 2), generator=g, device=dev) * 4 - 2
    small_z = torch.rand((150, 2), generator=g, device=dev) * 4 - 2
    _gram_case(checks, dev, g, small_x, small_z,
               torch.tensor([0.5, 1.0, 2.0], device=dev),
               torch.tensor([0.3, 1.0, 3.0], device=dev), "L=3 130x150")
    xs = torch.rand((MAIN["N"], 2), generator=g, device=dev) * 4 - 2
    zs = xs[:MAIN["M"]].contiguous()
    _gram_case(checks, dev, g, zs, zs, one, one, "Kzz {M}x{M}".format(**MAIN))
    _gram_case(checks, dev, g, zs, xs, one, one, "Kzx {M}x{N}".format(**MAIN),
               timings)
    del xs, zs
    # the VNNGP path's shapes: a step's Kxz, and the posterior's
    # L-batched Kxz over every spot (L·N·M output elements)
    xs = torch.rand((vnngp["N"], 2), generator=g, device=dev) * 4 - 2
    zs = xs[:vnngp["M"]].contiguous()
    _gram_case(checks, dev, g, xs[:vnngp["B"]], zs, one, one,
               "Kxz {B}x{M}".format(**vnngp))
    _gram_case(checks, dev, g, xs, zs,
               torch.linspace(0.5, 2.0, vnngp["L"], device=dev),
               torch.linspace(0.3, 3.0, vnngp["L"], device=dev),
               "Kxz L={L} {N}x{M}".format(**vnngp))
    del xs, zs
    _log_timings(timings)
    torch.cuda.empty_cache()

    # kernel 4 at the MGGP step's Kzz and Kzx, and ragged under each convention
    for convention in ("ABS", "RAW", "SQUARED"):
        _mggp_case(checks, dev, g, 300, 270, 3, 5, convention, "L=3 300x270 G=5")
    _mggp_case(checks, dev, g, m_mggp, m_mggp, MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzz L={MGGP['L']} {m_mggp}x{m_mggp} G={MGGP['G']}")
    _mggp_case(checks, dev, g, m_mggp, MGGP["B"], MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzx L={MGGP['L']} {m_mggp}x{MGGP['B']} G={MGGP['G']}", timings)
    # Kzx over every spot: L*M*N outputs pass 2^31, so the last columns
    # check the kernel's 64-bit offsets
    _mggp_case(checks, dev, g, m_mggp, MGGP["N"], MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzx L={MGGP['L']} {m_mggp}x{MGGP['N']}, last 2,000 columns",
               tail=2000)
    _log_timings({"mggp_gram": timings["mggp_gram"]})
    torch.cuda.empty_cache()

    block = {}
    _block_case(checks, dev, g, 130, 5, "n=130 K=5")
    _block_case(checks, dev, g, 1_000, 16, "n=1000 K=16")
    _block_case(checks, dev, g, vnngp["B"], vnngp["K"], "step", block)
    _block_case(checks, dev, g, vnngp["L"] * vnngp["N"], vnngp["K"], "posterior", block)
    # the JSON line carries the posterior shape, where the bytes dominate
    timings["block_conditional"] = block["posterior"]
    torch.cuda.empty_cache()
    return timings


def _launch_counters(names):
    """{kernel name: its wrapper, whose ``launches`` counts its launches}."""
    from gpzoo_tpu_torch.ops import gram_cuda, mggp_cuda, tri_cuda, vnngp_cuda

    wrappers = {"tri_sq_colsum": tri_cuda.tri_sq_colsum_fused,
                "tri_t_matmul": tri_cuda.tri_t_matmul,
                "rbf_gram": gram_cuda.rbf_gram_fwd,
                "mggp_gram": mggp_cuda.mggp_gram_fwd,
                "block_conditional": vnngp_cuda.block_conditional_fwd}
    return {name: wrappers[name] for name in names}


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _step_loss_grad(model, proj, y, idx, eps):
    from gpzoo_tpu_torch.train import nsf_negative_elbo_precomputed

    model.zero_grad(set_to_none=True)
    loss = nsf_negative_elbo_precomputed(model, proj, y, idx, eps,
                                         y_transposed=True)
    loss.backward()
    return loss.detach(), model.prior.Lu_raw.grad.detach().clone()


def phase_main(checks, dev):
    import torch
    from gpzoo_tpu_torch import (SlideseqNSFConfig, make_batched_train_step,
                                 nsf_negative_elbo_precomputed,
                                 precompute_nsf_projection, run_steps)
    from gpzoo_tpu_torch.data import held_out_deviance
    from gpzoo_tpu_torch.ops import tri_blocked
    from gpzoo_tpu_torch.train import fast

    n, d, b = MAIN["N"], MAIN["D"], MAIN["B"]
    log(f"[main] north-star NSF step, N={n} D={d} L={MAIN['L']} "
        f"M={MAIN['M']} batch={b}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    counts_t = rng.poisson(3.0, size=(n, d)).astype(np.float32)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts_t).to(dev)
    del counts_t
    log(f"  synthetic data: {time.perf_counter() - t0:.1f}s")

    counters = _launch_counters(("tri_sq_colsum", "tri_t_matmul", "rbf_gram"))
    _zero(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cfg = SlideseqNSFConfig(N=n, D=d, L=MAIN["L"], M=MAIN["M"], batch_size=b)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = cfg.build(gen, x)
    proj = precompute_nsf_projection(model, x)
    torch.cuda.synchronize()
    log(f"  build + precompute: {time.perf_counter() - t0:.2f}s")

    n_train = n - HOLDOUT
    opt = cfg.optimizer(model)
    step = make_batched_train_step(nsf_negative_elbo_precomputed, opt,
                                   n_train, b, cfg.L, gen, E=cfg.E,
                                   loss_kwargs={"y_transposed": True})
    t0 = time.perf_counter()
    warm = run_steps(step, model, (proj, y), WARMUP_STEPS).cpu()
    log(f"  warm-up {WARMUP_STEPS} steps: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    losses = run_steps(step, model, (proj, y), TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = torch.cat([warm, losses.cpu()])
    dev_val = float(held_out_deviance(model, proj, y,
                                      torch.arange(n_train, n, device=dev)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = _read(counters)

    log(f"  losses: {[f'{v:.6e}' for v in losses.tolist()]}")
    log(f"  steps/s: {TIMED_STEPS / dt:.4f} ({dt / TIMED_STEPS * 1e3:.2f} ms/step, "
        f"host clock over {TIMED_STEPS} steps)")
    log(f"  held-out Poisson deviance (holdout {HOLDOUT}): {dev_val:.6f}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches on the main path: {launches}")
    checks.true("all losses finite", bool(torch.isfinite(losses).all()))
    checks.true("held-out deviance finite", math.isfinite(dev_val))
    for name, count in launches.items():
        checks.true(f"{name} launched on the main path ({count})", count > 0)

    # one step with the kernels against the same step with plain versions
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    loss_k, grad_k = _step_loss_grad(model, proj, y, idx, eps)
    with mock.patch.object(fast, "tri_sq_colsum", tri_blocked.tri_sq_colsum):
        loss_p, grad_p = _step_loss_grad(model, proj, y, idx, eps)
    checks.le("step loss, kernels vs plain (relative)",
              float(abs(loss_k - loss_p) / abs(loss_p)), TOL_STEP_LOSS)
    checks.le("step dLu_raw, kernels vs plain", norm_err(grad_k, grad_p),
              TOL_STEP_GRAD)
    del model, proj, opt, grad_k, grad_p
    torch.cuda.empty_cache()
    return launches


def phase_small_reference(checks, dev):
    """A small input through the card's float32 kernels and through the
    float64 plain CPU path, with the same parameters, idx and eps."""
    import torch
    from gpzoo_tpu_torch import SlideseqNSFConfig, precompute_nsf_projection
    from gpzoo_tpu_torch.convert import nsf_from_numpy, to_numpy

    n, d, l_dim, m, b = 2000, 200, 4, 300, 500
    rng = np.random.default_rng(3)
    coords = rng.uniform(-2, 2, size=(n, 2))
    counts = rng.poisson(3.0, size=(n, d)).astype(np.float64)
    cfg = SlideseqNSFConfig(N=n, D=d, L=l_dim, M=m, batch_size=b)
    cpu_model = cfg.build(torch.Generator().manual_seed(0),
                          torch.from_numpy(coords))
    params = to_numpy(cpu_model)
    params["prior.Lu_raw"] = np.tril(0.05 * rng.standard_normal((l_dim, m, m)))
    idx = rng.choice(n, size=b, replace=False)
    eps = rng.standard_normal((1, l_dim, b))
    out = {}
    for where, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        model = nsf_from_numpy(params, where, dtype, jitter=cfg.jitter)
        x = torch.tensor(coords, dtype=dtype, device=where)
        y = torch.tensor(counts, dtype=dtype, device=where)
        proj = precompute_nsf_projection(model, x)
        loss, grad = _step_loss_grad(
            model, proj, y, torch.as_tensor(idx, device=where),
            torch.tensor(eps, dtype=dtype, device=where))
        out[str(where)] = (loss.double().cpu(), grad.double().cpu())
    (l64, g64), (l32, g32) = out["cpu"], out[str(dev)]
    log(f"[small] float32 card vs float64 CPU, N={n} D={d} L={l_dim} M={m} B={b}")
    checks.le("small loss (relative)", float(abs(l32 - l64) / abs(l64)), TOL_SMALL)
    checks.le("small dLu_raw", norm_err(g32, g64), TOL_SMALL)


def profile_window(fn, steps):
    """Device split of ``steps`` calls of ``fn`` under torch.profiler: wall
    time, summed kernel time, the device's idle share of the wall time, and
    the kernels that took the most device time. A profiler that cannot
    trace the card is reported, not failed; a failing step propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:  # noqa: BLE001 - a report, not a check
        log(f"  profiler: unavailable ({type(exc).__name__}: {exc})")
        return
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    except BaseException:
        with contextlib.suppress(Exception):
            prof.stop()
        raise
    try:
        prof.stop()
        spans, by_name = [], {}
        for e in prof.events():
            # kernels and copies only: a user annotation on the device
            # timeline (the optimizer's step) spans idle gaps too
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                start, end = e.time_range.start, e.time_range.end
                spans.append((start, end))
                by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    except Exception as exc:  # noqa: BLE001 - a report, not a check
        log(f"  profiler: unavailable ({type(exc).__name__}: {exc})")
        return
    if not spans:
        log("  profiler: no device events recorded")
        return
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    log(f"  profile over {steps} steps: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, "
        f"{len(spans)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / steps / 1e3:9.4f} ms/step  {name[:110]}")


def _vnngp_loss_grad(model, x, y, idx, eps):
    """All-trainable loss and the gradient of every leaf, by dotted path."""
    from gpzoo_tpu_torch.train import vnngp_nsf_negative_elbo_batched

    model.zero_grad(set_to_none=True)
    loss = vnngp_nsf_negative_elbo_batched(model, x, y, idx, eps,
                                           shared_kernel=True, y_transposed=True)
    loss.backward()
    return loss.detach(), {name: p.grad.detach().clone()
                           for name, p in model.named_parameters()}


def _timed_steps(step, model, args, n_steps):
    """Losses of ``n_steps`` steps and their seconds on the host clock,
    ending in a synchronize."""
    import torch
    from gpzoo_tpu_torch import run_steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = run_steps(step, model, args, n_steps)
    torch.cuda.synchronize()
    return losses.cpu(), time.perf_counter() - t0


def plain_block_conditional(on):
    """Kernel 5 swapped for its plain version in the VNNGP prior while ``on``."""
    from gpzoo_tpu_torch.gps import vnngp as vnngp_module
    from gpzoo_tpu_torch.ops import vnngp_cuda

    return (mock.patch.object(vnngp_module, "block_conditional",
                              vnngp_cuda.block_conditional_plain)
            if on else contextlib.nullcontext())


def phase_vnngp(checks, dev, vnngp):
    """bench.py's VNNGP leg (run_vnngp_bench) on the port, at full width."""
    import torch
    from gpzoo_tpu_torch import (VNNGPConfig, latent_posterior,
                                 make_batched_train_step,
                                 precompute_vnngp_conditioning,
                                 vnngp_nsf_negative_elbo_batched,
                                 vnngp_nsf_negative_elbo_precomputed)
    from gpzoo_tpu_torch.data.metrics import posterior_mean_deviance

    n, d, b = vnngp["N"], vnngp["D"], vnngp["B"]
    log(f"[vnngp] NSF over VNNGP, N={n} D={d} L={vnngp['L']} M={vnngp['M']} "
        f"K={vnngp['K']} batch={b}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    counts_t = rng.poisson(2.0, size=(n, d)).astype(np.float32)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts_t).to(dev)
    del counts_t
    log(f"  synthetic data: {time.perf_counter() - t0:.1f}s")

    counters = _launch_counters(("block_conditional", "rbf_gram"))
    launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = VNNGPConfig(N=n, D=d, L=vnngp["L"], M=vnngp["M"], K=vnngp["K"], E=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x)
    n_train = n - HOLDOUT
    kw = {"y_transposed": True}
    ok = True

    # (a) frozen Z and kernel, on a copy of the pristine model (the
    # all-trainable leg below moves the per-factor hyperparameters apart)
    _zero(counters)
    frozen = copy.deepcopy(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cond = precompute_vnngp_conditioning(frozen, x)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    step = make_batched_train_step(vnngp_nsf_negative_elbo_precomputed,
                                   cfg.optimizer(frozen), n_train, b, cfg.L, gen,
                                   E=cfg.E, loss_kwargs=kw)
    warm, _ = _timed_steps(step, frozen, (cond, y), VNNGP_WARMUP)
    timed, dt = _timed_steps(step, frozen, (cond, y), VNNGP_TIMED)
    launches["a"] = _read(counters)
    frozen_losses = torch.cat([warm, timed])
    log(f"  (a) frozen tier: precompute {pre_s:.3f}s; {VNNGP_TIMED / dt:.3f} steps/s "
        f"({dt / VNNGP_TIMED * 1e3:.3f} ms/step, host clock over {VNNGP_TIMED} steps)")
    log(f"      loss mean, first {VNNGP_WARMUP}: {float(warm.mean()):.6e}; "
        f"last {VNNGP_WARMUP}: {float(timed[-VNNGP_WARMUP:].mean()):.6e}")
    ok &= bool(torch.isfinite(frozen_losses).all())
    del frozen, cond, step

    # (b) every leaf trains: Z, σ, ℓ, mu, Lu, W, V
    _zero(counters)
    all_kw = {"shared_kernel": True, **kw}
    step = make_batched_train_step(vnngp_nsf_negative_elbo_batched,
                                   cfg.optimizer(model), n_train, b, cfg.L, gen,
                                   E=cfg.E, loss_kwargs=all_kw)
    warm, _ = _timed_steps(step, model, (x, y), VNNGP_WARMUP)
    timed, dt = _timed_steps(step, model, (x, y), VNNGP_TIMED)
    launches["b"] = _read(counters)
    losses = torch.cat([warm, timed])
    log(f"  (b) all-trainable: {VNNGP_TIMED / dt:.3f} steps/s "
        f"({dt / VNNGP_TIMED * 1e3:.3f} ms/step, host clock over {VNNGP_TIMED} steps)")
    log(f"      loss mean, first {VNNGP_WARMUP}: {float(warm.mean()):.6e}; "
        f"last {VNNGP_WARMUP}: {float(timed[-VNNGP_WARMUP:].mean()):.6e}")
    ok &= bool(torch.isfinite(losses).all())
    profile_window(lambda: step(model, x, y), PROFILED_STEPS)

    turns = []
    for which in ("plain", "kernel", "kernel", "plain"):
        with plain_block_conditional(which == "plain"):
            _, dt = _timed_steps(step, model, (x, y), AB_STEPS)
        turns.append(f"{which} {dt / AB_STEPS * 1e3:.3f}")
    log(f"      ms/step in turns of {AB_STEPS} steps: {', '.join(turns)}")

    # (c) the full posterior and the held-out deviance
    _zero(counters)
    with torch.no_grad():
        latent_posterior(model.prior, x)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, scale = latent_posterior(model.prior, x)
        torch.cuda.synchronize()
        post_s = time.perf_counter() - t0
    launches["c"] = _read(counters)
    with torch.no_grad(), plain_block_conditional(True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_mean, plain_scale = latent_posterior(model.prior, x)
        torch.cuda.synchronize()
        plain_post_s = time.perf_counter() - t0
    dev_val = float(posterior_mean_deviance(model, mean, y,
                                            torch.arange(n_train, n, device=dev)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  (c) posterior over {n} spots: {post_s:.4f}s ({plain_post_s:.4f}s with "
        f"kernel 5's plain version); mean {tuple(mean.shape)}, "
        f"finite {bool(torch.isfinite(mean).all() and torch.isfinite(scale).all())}")
    log(f"      held-out Poisson deviance (holdout {HOLDOUT}): {dev_val:.6f}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches: (a) {launches['a']}, (b) {launches['b']}, (c) {launches['c']}")
    checks.true("vnngp losses finite, both tiers", ok)
    checks.true("vnngp posterior finite", bool(torch.isfinite(mean).all()
                                               and torch.isfinite(scale).all()))
    checks.true("vnngp posterior shape", tuple(mean.shape) == (cfg.L, n))
    checks.le("vnngp posterior mean, kernel 5 vs plain", norm_err(mean, plain_mean),
              TOL_BLOCK)
    checks.le("vnngp posterior scale, kernel 5 vs plain",
              norm_err(scale, plain_scale), TOL_BLOCK)
    checks.true("vnngp held-out deviance finite", math.isfinite(dev_val))
    for part in ("b", "c"):
        for name, count in launches[part].items():
            checks.true(f"{name} launched on vnngp ({part}) ({count})", count > 0)
    del mean, scale, plain_mean, plain_scale

    # one all-trainable step with kernel 5 against the same step with its
    # plain version, on the same idx and eps
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    loss_k, grad_k = _vnngp_loss_grad(model, x, y, idx, eps)
    with plain_block_conditional(True):
        loss_p, grad_p = _vnngp_loss_grad(model, x, y, idx, eps)
    checks.le("vnngp step loss, kernel vs plain (relative)",
              float(abs(loss_k - loss_p) / abs(loss_p)), TOL_STEP_LOSS)
    for name in ("prior.Z", "prior.kernel.sigma", "prior.kernel.lengthscale",
                 "prior.Lu_raw"):
        checks.le(f"vnngp step d{name}, kernel vs plain",
                  norm_err(grad_k[name], grad_p[name]), TOL_STEP_GRAD)
    del model, step, x, y
    torch.cuda.empty_cache()
    return {name: launches["a"][name] + launches["b"][name] + launches["c"][name]
            for name in counters}


def phase_small_vnngp(checks, dev):
    """A small VNNGP step through the card's float32 kernels and through the
    float64 plain CPU path, with the same parameters, idx and eps."""
    import torch
    from gpzoo_tpu_torch import VNNGPConfig
    from gpzoo_tpu_torch.convert import to_numpy, vnngp_from_numpy

    n, d, l_dim, m, k, b = 2000, 100, 4, 200, 8, 500
    rng = np.random.default_rng(4)
    coords = rng.uniform(-2, 2, size=(n, 2))
    counts = rng.poisson(2.0, size=(n, d)).astype(np.float64)
    cfg = VNNGPConfig(N=n, D=d, L=l_dim, M=m, K=k)
    params = to_numpy(cfg.build(torch.Generator().manual_seed(0),
                                torch.from_numpy(coords)))
    params["prior.mu"] = 0.3 * rng.standard_normal(m)
    params["prior.Lu_raw"] = np.tril(0.05 * rng.standard_normal((m, m)))
    idx = rng.choice(n, size=b, replace=False)
    eps = rng.standard_normal((1, l_dim, b))
    out = {}
    for where, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        model = vnngp_from_numpy(params, where, dtype, K=k, jitter=cfg.jitter)
        loss, grads = _vnngp_loss_grad(
            model, torch.tensor(coords, dtype=dtype, device=where),
            torch.tensor(counts, dtype=dtype, device=where),
            torch.as_tensor(idx, device=where),
            torch.tensor(eps, dtype=dtype, device=where))
        out[str(where)] = (loss.double().cpu(),
                           {key: g.double().cpu() for key, g in grads.items()})
    (l64, g64), (l32, g32) = out["cpu"], out[str(dev)]
    log(f"[small vnngp] float32 card vs float64 CPU, N={n} D={d} L={l_dim} "
        f"M={m} K={k} B={b}")
    checks.le("small vnngp loss (relative)", float(abs(l32 - l64) / abs(l64)),
              TOL_SMALL)
    for key in g64:
        checks.le(f"small vnngp d{key}", norm_err(g32[key], g64[key]), TOL_SMALL)


def _mggp_loss_grad(model, x, y, idx, eps, groups, microbatch):
    """The MGGP W-form loss and the gradient of every trained leaf."""
    from gpzoo_tpu_torch.train import nsf_negative_elbo_batched

    model.zero_grad(set_to_none=True)
    loss = nsf_negative_elbo_batched(model, x, y, idx, eps, microbatch=microbatch,
                                     factored=True, y_transposed=True,
                                     groups=groups, remat=False)
    loss.backward()
    return loss.detach(), {name: p.grad.detach().clone()
                           for name, p in model.named_parameters()
                           if p.grad is not None}


def plain_mggp_kernels():
    """Kernels 1 and 4 swapped for their plain versions on the MGGP path
    (kernel 2 runs only inside kernel 1's backward)."""
    from gpzoo_tpu_torch.ops import mggp_cuda, tri_blocked
    from gpzoo_tpu_torch.train import fast

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(mggp_cuda, "mggp_gram",
                                          mggp_cuda.mggp_gram_plain))
    stack.enter_context(mock.patch.object(fast, "tri_sq_colsum",
                                          tri_blocked.tri_sq_colsum))
    return stack


def phase_mggp(checks, dev):
    """bench.py's MGGP leg (benchmarks/mggp_anatomy.py measure_step) on the
    port, at full width: trainable per-factor MGGP kernels and the group
    embedding, Z frozen, one chunk of 7,000 (microbatch = batch)."""
    import torch
    from torch import nn
    from gpzoo_tpu_torch import (MGGPNSFConfig, make_batched_train_step,
                                 nsf_negative_elbo_batched)
    from gpzoo_tpu_torch.data import posterior_deviance

    n, d, b = MGGP["N"], MGGP["D"], MGGP["B"]
    cfg = MGGPNSFConfig(D=d, N=n, L=MGGP["L"], M_per_group=MGGP["M_per_group"],
                        n_groups=MGGP["G"], batch_size=b)
    log(f"[mggp] MGGP-NSF step, N={n} D={d} L={cfg.L} M={cfg.M} "
        f"({cfg.M_per_group} x {cfg.n_groups} groups) batch={b}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    counts_t = rng.poisson(3.0, size=(n, d)).astype(np.float32)
    groups = rng.integers(0, cfg.n_groups, size=n)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts_t).to(dev)
    g = torch.from_numpy(groups).to(dev)
    del counts_t
    log(f"  synthetic data: {time.perf_counter() - t0:.1f}s")

    counters = _launch_counters(("mggp_gram", "tri_sq_colsum", "tri_t_matmul"))
    _zero(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = cfg.build(gen, x, g)
    # the benchmark's init: per-factor mu = 0.1 N(0, 1) and Lu = I (the
    # config's random (M, M) Lu overflows exp(F) at this M)
    gp = model.gp
    gp.mu = nn.Parameter(0.1 * torch.randn((cfg.L, cfg.M), generator=gen, device=dev))
    gp.Lu_raw = nn.Parameter(torch.zeros((cfg.L, cfg.M, cfg.M), device=dev))
    torch.cuda.synchronize()
    log(f"  build: {time.perf_counter() - t0:.2f}s")

    n_train = n - HOLDOUT
    kw = dict(microbatch=b, factored=True, y_transposed=True, groups=g,
              remat=False)
    step = make_batched_train_step(nsf_negative_elbo_batched, cfg.optimizer(model),
                                   n_train, b, cfg.L, gen, E=cfg.E, loss_kwargs=kw)
    warm, warm_s = _timed_steps(step, model, (x, y), WARMUP_STEPS)
    timed, dt = _timed_steps(step, model, (x, y), TIMED_STEPS)
    launches = _read(counters)
    losses = torch.cat([warm, timed])
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_val = float(posterior_deviance(model, x, y, torch.arange(n_train, n, device=dev),
                                       g))
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    post_launches = _read(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    steps = WARMUP_STEPS + TIMED_STEPS
    log(f"  warm-up {WARMUP_STEPS} steps: {warm_s:.2f}s")
    log(f"  losses: {[f'{v:.6e}' for v in losses.tolist()]}")
    log(f"  steps/s: {TIMED_STEPS / dt:.4f} ({dt / TIMED_STEPS * 1e3:.2f} ms/step, "
        f"host clock over {TIMED_STEPS} steps)")
    log(f"  held-out Poisson deviance (holdout {HOLDOUT}, posterior at those "
        f"spots, {post_s:.3f}s): {dev_val:.6f}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches over {steps} steps: {launches} "
        f"(per step: { {k: v / steps for k, v in launches.items()} }); "
        f"held-out posterior: {post_launches}")
    checks.true("mggp losses finite", bool(torch.isfinite(losses).all()))
    checks.true("mggp held-out deviance finite", math.isfinite(dev_val))
    for name, count in launches.items():
        checks.true(f"{name} launched on the mggp step ({count})", count > 0)
    checks.true(f"mggp_gram launched on the mggp posterior "
                f"({post_launches['mggp_gram']})", post_launches["mggp_gram"] > 0)
    profile_window(lambda: step(model, x, y), MGGP_PROFILED_STEPS)

    # One step with kernels 1 and 4 against the same step with their plain
    # versions, on the same idx and eps. The gradients that reach the
    # kernel through Kzz⁻¹ (μ, σ, ℓ, α, the embedding) carry float32
    # rounding of the Gram amplified by Kzz's condition number (jitter 0.1
    # at M = 3,010), in the plain step as much as in the kernels' one; so
    # both are also held against the same step in float64 (plain versions),
    # and the kernels' step must be within TOL_STEP_GRAD of it or no
    # further from it than twice the plain float32 step.
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    _zero(counters)
    loss_k, grad_k = _mggp_loss_grad(model, x, y, idx, eps, g, b)
    kernel_step = _read(counters)
    _zero(counters)
    with plain_mggp_kernels():
        loss_p, grad_p = _mggp_loss_grad(model, x, y, idx, eps, g, b)
        model.zero_grad(set_to_none=True)
        model64 = copy.deepcopy(model).double()
        del step
        torch.cuda.empty_cache()
        loss_r, grad_r = _mggp_loss_grad(model64, x.double(), y.double(), idx,
                                         eps.double(), g, b)
    plain_steps = _read(counters)
    del model64
    # the swap must have taken effect, or the comparison is with itself
    log(f"  launches: kernels' step {kernel_step}, plain and float64 steps "
        f"{plain_steps}")
    for name in counters:
        checks.true(f"{name} launched on the kernels' step ({kernel_step[name]})",
                    kernel_step[name] > 0)
        checks.true(f"{name} not launched on the plain and float64 steps "
                    f"({plain_steps[name]})", plain_steps[name] == 0)
    checks.le("mggp step loss, kernels vs plain (relative)",
              float(abs(loss_k - loss_p) / abs(loss_p)), TOL_STEP_LOSS)
    log(f"  mggp step loss against float64: kernels "
        f"{float(abs(loss_k - loss_r) / abs(loss_r)):.3e}, plain "
        f"{float(abs(loss_p - loss_r) / abs(loss_r)):.3e} (relative)")
    for name in grad_p:
        ref = grad_r[name].float()
        err_k, err_p = norm_err(grad_k[name], ref), norm_err(grad_p[name], ref)
        log(f"  mggp step d{name}: kernels vs plain {norm_err(grad_k[name], grad_p[name]):.3e}; "
            f"against float64: kernels {err_k:.3e}, plain {err_p:.3e}")
        checks.le(f"mggp step d{name}, kernels against float64",
                  err_k, max(TOL_STEP_GRAD, 2 * err_p))
    del model, grad_k, grad_p, grad_r, x, y
    torch.cuda.empty_cache()
    return {name: launches[name] + post_launches[name] for name in counters}


def phase_small_mggp(checks, dev):
    """A small MGGP step (two chunks) through the card's float32 kernels and
    through the float64 plain CPU path, with the same parameters, idx and
    eps."""
    import torch
    from gpzoo_tpu_torch import MGGPNSFConfig
    from gpzoo_tpu_torch.convert import mggp_nsf_from_numpy, to_numpy

    n, d, l_dim, n_groups, m_per, b = 2000, 100, 4, 4, 40, 500
    rng = np.random.default_rng(5)
    coords = rng.uniform(-2, 2, size=(n, 2))
    counts = rng.poisson(3.0, size=(n, d)).astype(np.float64)
    groups = rng.integers(0, n_groups, size=n)
    cfg = MGGPNSFConfig(D=d, N=n, L=l_dim, M_per_group=m_per, n_groups=n_groups)
    params = to_numpy(cfg.build(torch.Generator().manual_seed(0),
                                torch.from_numpy(coords), groups))
    m = cfg.M
    params["gp.mu"] = 0.3 * rng.standard_normal((l_dim, m))
    params["gp.Lu_raw"] = np.tril(0.05 * rng.standard_normal((l_dim, m, m)))
    idx = rng.choice(n, size=b, replace=False)
    eps = rng.standard_normal((1, l_dim, b))
    out = {}
    for where, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        model = mggp_nsf_from_numpy(params, where, dtype, jitter=cfg.jitter)
        loss, grads = _mggp_loss_grad(
            model, torch.tensor(coords, dtype=dtype, device=where),
            torch.tensor(counts, dtype=dtype, device=where),
            torch.as_tensor(idx, device=where),
            torch.tensor(eps, dtype=dtype, device=where),
            torch.as_tensor(groups, device=where), b // 2)
        out[str(where)] = (loss.double().cpu(),
                           {key: v.double().cpu() for key, v in grads.items()})
    (l64, g64), (l32, g32) = out["cpu"], out[str(dev)]
    log(f"[small mggp] float32 card vs float64 CPU, N={n} D={d} L={l_dim} "
        f"M={m} ({m_per} x {n_groups} groups) B={b}, two chunks")
    checks.le("small mggp loss (relative)", float(abs(l32 - l64) / abs(l64)),
              TOL_SMALL)
    for key in g64:
        checks.le(f"small mggp d{key}", norm_err(g32[key], g64[key]), TOL_SMALL)


def main():
    # The smoke drives one card: show the process only the first visible one,
    # so that the device count it reports is the count it checked.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import gpzoo_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import gpzoo_tpu_torch ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    t_start = time.perf_counter()
    checks = Checks()

    phase_build()
    vnngp = vnngp_full_shape()
    timings = phase_kernels(checks, dev, vnngp)
    launches = phase_main(checks, dev)
    phase_small_reference(checks, dev)
    vnngp_launches = phase_vnngp(checks, dev, vnngp)
    phase_small_vnngp(checks, dev)
    mggp_launches = phase_mggp(checks, dev)
    phase_small_mggp(checks, dev)
    # a kernel that runs on several paths counts the sum of their runs
    launches["rbf_gram"] += vnngp_launches["rbf_gram"]
    launches["block_conditional"] = vnngp_launches["block_conditional"]
    for name in ("tri_sq_colsum", "tri_t_matmul"):
        launches[name] += mggp_launches[name]
    launches["mggp_gram"] = mggp_launches["mggp_gram"]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if checks.failed:
        print(f"chip_smoke: FAILED: {checks.failed}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sources = {
        "tri_sq_colsum": ("gpzoo_tpu_torch/ops/csrc/tri.cu",
                          "gpzoo_tpu/ops/tri_pallas.py:302"),
        "tri_t_matmul": ("gpzoo_tpu_torch/ops/csrc/tri.cu",
                         "gpzoo_tpu/ops/tri_pallas.py:151"),
        "rbf_gram": ("gpzoo_tpu_torch/ops/csrc/gram.cu",
                     "gpzoo_tpu/ops/gram_pallas.py:117"),
        "mggp_gram": ("gpzoo_tpu_torch/ops/csrc/mggp.cu",
                      "gpzoo_tpu/ops/gram_pallas.py:206"),
        "block_conditional": ("gpzoo_tpu_torch/ops/csrc/vnngp.cu",
                              "gpzoo_tpu/ops/vnngp_pallas.py:134"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **timings[name])
               for name, (src, rep) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
