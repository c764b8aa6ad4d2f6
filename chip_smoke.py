#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gpzoo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel in gpzoo_tpu_torch/ops/csrc with nvcc
               (one process per source, all at once) and print each
               kernel's registers and spills; then the SASS instruction mix
               (cuobjdump) of every kernel of tri.cu, gram.cu and vnngp.cu;
               the tri main loops must show the tensor-core HGMMA;
  2. kernels — each kernel against its plain PyTorch version in float32, at
               the paths' shapes and at ragged small shapes, with the
               median time of each beside the plain version's, the bound
               (the least time the card could take) and, where one PyTorch
               call computes the same function, that call's time (kernels
               1-2 also with the MGGP step's per-factor a, at M = 1 and at
               M, B off the 128 tile, with their staging pass held against
               its plain version and timed alone; kernel 3 timed at every
               shape the paths launch it at, and checked at M % 4 ≠ 0,
               N = 1 and D from 1 to 8; kernel 4 at the MGGP step's Kzz and
               Kzx and under each α convention; kernel 5 at n = 1 and one
               past a block's and the step's point count; kernels 1-4 also
               at the fast, Hybrid-NSF and Hybrid-MGGP legs' shapes, kernels 3 and 4 with their
               backward against autograd through the plain form; kernels
               3-5 forward and backward at the generic legs' shapes);
  3. main    — the north-star NSF training step at full width (N=45,000,
               D=4,000, L=20, M=3,000, batch 7,000): config build, the
               precomputed projection, warm-up and timed Adam steps, the
               held-out deviance, peak memory and each kernel's launch count,
               a profiled window (device idle share, kernels by time), then
               one step with the kernels against the same step with the
               plain versions (the loss and every leaf's gradient);
     nb      — the same leg with the negative-binomial head (bench.py's
               --likelihood nb: per-gene r_raw from r0 = 10, trained), its
               kernels-vs-plain step (r_raw included) and both against the
               same step in float64 on the card;
     lowrank — the same leg with the rank-64 LowRankWSVGP over the whitened
               precompute (bench.py's low-rank leg; no kernel per step), and
               that precompute with kernel 3 against it with its plain version;
     fast    — bench.py's --loss fast leg: the north-star model through the
               blockwise loss (shared-kernel collapse, shared-Cholesky K⁻¹),
               with the figures of every leg; its step against the
               precomputed step (the loss in float32, loss and gradients in
               float64) and against its plain kernels, both against float64;
     ngd     — natural-gradient VI (train/ngd.py) on the north-star model
               with benchmarks/ngd_ab.py's nat_lr 0.01, ramp 400, max_f 60:
               (a) the first step in float32 against float64 on the card (the
               loss, g_m, g_S, the head's gradients, Δm, ΔP), with a control
               step under TF32 products that must fail those limits; (b) 40
               steps through make_scan_runner in chunks of 10 (ms/step,
               peak memory, rejected factors, skipped steps, a profiled
               window), whose held-out deviance must be below that of 40 Adam
               steps from the same init; (c) ngd_to_model: the written-back
               S against P, and its precomputed loss against the NGD loss;
     snapshot — a PosteriorSnapshotter at the 2,000 held-out spots over
               three chunks of NGD steps, then extract_factors there and its
               Moran ranking;
     checkpoint — CheckpointHook(every=1, keep=2) over the north-star Adam
               step, then over the NGD state, in a temporary directory: async
               saves, .latest restored into a fresh state, the same steps
               resumed, whose losses and state must be bit-identical; the
               stall, write time, file size and restore time;
     small   — small inputs of the north-star, NB and rank-64 configurations,
               float32 on the card against the float64 CPU path;
     heads_small — the same for the whitened WSVGP loss, the normalized
               Poisson log-likelihood, HybridNSF over SVGP, WSVGP and
               LowRankWSVGP, HybridNSFExact (whitened and not), NBNSF over a
               VNNGP (both tiers), and the projection solved in blocks
               against all at once;
     blockwise_small — the same for the blockwise loss's branches: the
               collapse (both projection forms), whitened factored, not
               factored, and HybridNSF over an MGGP SVGP;
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
               two-chunk input against the float64 CPU path;
     hybrid_mggp — bench.py's Slideseq Hybrid-MGGP leg (N=45,000, D=4,000,
               L=10 + T=10, M=3,010, batch 6,000, E=3, jitter 1e-2, Z
               trained through kernel 4's backward), with the figures of
               every leg and one step against the plain kernels, both
               against float64;
     hybrid  — bench.py's Hybrid-NSF leg (N=800, L=4 + T=3, M=529, E=1,000,
               the full batch of 720 through make_train_step, ℓ and Z
               trained through kernel 3's backward), the same figures and
               comparison. In every step comparison (steps_vs_plain) the
               other steps take the kernels' step's variance-floor
               decisions (clamp_decisions), deciding at most MAX_FLIPS
               entries otherwise, and a control step whose Gram is rounded
               to TF32 must fail the comparison's limits;
     nsf_sweep, vnngp_sweep, pnmf, svgp_regression, warmstart — the generic
               ELBO path at the published widths: benchmarks/nsf_sweep.py's
               NSFConfig rows (N=800, D=80, L=4, E=20, M = 100, 250, 500,
               1,000) and its VNNGP row (N=5,000, D=200, L=10, M=1,000,
               K=8), bench.py's PNMF leg (N=800, D=80, L=4, E=20),
               examples/svgp_regression.py (n=10,000, M=500, E=20) and
               examples/slideseq_mggp_hybrid.py (1,500 PNMF steps, the
               Moran ranking, which must put the factors matching the
               simulated ones first, hybrid_mggp_from_pnmf, the
               kernel-frozen fine-tune; N=4,000,
               D=200, M=160, batch 1,000), each full batch through the
               generic losses except the fine-tune: 3 + 30 steps, the loss
               on fixed draws falling, the figures of every leg, then the
               step against the plain kernels and float64 over 4 sets of
               draws (kernel 3's legs also against a second plain form of
               the Gram; PNMF, which runs no kernel, against float64);
  6. device  — kernels 3 and 5 alone on the device at every path shape, and
               kernel 4 at the MGGP step's Kzx and the warm start's Kzz and
               Kzx, from torch.profiler; last, so that no profiler run
               precedes a timed step.
Kernels 3 and 5's launches on the paths are counted by shape, and a
summary gives each shape's launches, call and device time and bound, and
launches x (ms - bound); every launched shape must have been timed in
phase 2.
The last three lines are the card's name and power limit, one JSON line with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Without CUDA the script exits 1 before doing anything else. It
imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

# Tolerances, each on max|got − ref| / max|ref| in float32:
# the first NGD step from the init (P = S = I), float32 against float64 (g_m,
# g_S, the head's gradients, the updates Δm and ΔP): products over B = 7,000
# terms round at ~1e-6 in float32 and at ~1e-3 with TF32's 10 mantissa bits
TOL_NGD = 1e-4
# ngd_to_model's S against P: a backward-stable inverse leaves
# ‖S·P − I‖_F ≤ c·M·2^-24·‖S‖_F‖P‖_F; M·2^-24 = 1.8e-4 at M = 3,000
TOL_NGD_INVERSE = 3_000 * 2.0 ** -24
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
# Most variance entries of the MGGP legs sit at the 5e-2 floor, so a
# step's rounding (~1e-6 relative) puts a few of them on the other side of
# it than another step's. A step compared with another takes that step's
# floor decisions and may decide no more than this many entries otherwise
# in a set of draws: sound steps decide 1 ([mggp]) and up to 7
# ([hybrid_mggp]) otherwise, the other legs 0; a Gram rounded to 10-13
# mantissa bits (the control step) 301 to 5,687.
MAX_FLIPS = 16
# mantissa bits of the control step's Gram (steps_vs_plain): TF32's 10,
# then more where Kzz so rounded cannot be factored (2^-11 relative per
# entry is past the jitter of the regression's and Hybrid-MGGP's Kzz)
CONTROL_BITS = (10, 13, 16)
# float32 on the card against the float64 CPU path on a small input
# (Cholesky of Kzz + 0.1·I in float32 loses ~κ·2^-24 ≈ 1e-4).
TOL_SMALL = 2e-3
# kernel 5 factors each K x K block itself, in another order than the
# batched cuSOLVER Cholesky of the plain form: a block of condition number
# kappa <~ 10^2 loses about kappa * K * 2^-24 ~ 5e-5 of relative accuracy.
TOL_BLOCK = 1e-4

# the Gram's rounding (TOL_GRAM) passes through the whitened solve
# a = Lzz⁻¹Kzx, amplified at most by κ(Lzz) = sqrt(κ(Kzz)) ~ 10² at jitter
# 0.1 and M = 3,000 (largest eigenvalue ~ M·2π/16 ~ 10³): 2e-3 worst case;
TOL_PROJ = 2e-3
# the projection solved in blocks of columns against all at once: the same
# arithmetic per column, though cuBLAS may tile another way;
TOL_BLOCKED = 1e-5
# the gradients of a Gram (kernel 3's closed-form backward over the kernel's
# k, against autograd through the plain form) each sum N·M products of both
# signs per entry, in another order, and dx = w·z − rowsum(w)·x cancels:
# ~sqrt(N·M)·2^-24 relative to the largest term ≈ 4e-5 at 529 x 720;
TOL_GRAM_BWD = 1e-4

MAIN = dict(N=45_000, D=4_000, L=20, M=3_000, B=7_000)
# bench.py's low-rank certification leg (bench.py:894-909)
LOWRANK_RANK = 64
# the MGGP-NSF step of bench.py's MGGP leg (benchmarks/mggp_anatomy.py):
# M = 215 inducing points x 14 groups
MGGP = dict(N=45_000, D=4_000, L=20, M_per_group=215, G=14, B=7_000)
HOLDOUT = 2_000
# bench.py's Hybrid-NSF leg (HybridNSFConfig; full batch of the first 90% of
# the spots, E = 1,000) and Slideseq Hybrid-MGGP leg (SlideseqHybridMGGPConfig:
# M = 215 inducing points x 14 groups, E = 3, jitter 1e-2)
HYBRID = dict(N=800, D=80, L=4, T=3, M_grid=23, E=1000)
HYBRID_MGGP = dict(N=45_000, D=4_000, L=10, T=10, M_per_group=215, G=14, B=6_000)
# the generic ELBO legs: benchmarks/nsf_sweep.py's NSF M-sweep (run_nsf:
# NSFConfig, full batch, E = 20, the nsf-paper simulation) and its --vnngp row
# (run_vnngp: VNNGPConfig, full batch, E = 3, data simulated at 4 factors);
# bench.py's PNMF leg (run_pnmf_bench); examples/svgp_regression.py at
# SVGPRegressionConfig's defaults; examples/slideseq_mggp_hybrid.py's default
# widths and PNMF steps (its fine-tune's 2,000 steps cut as every leg's)
SWEEP = dict(N=800, D=80, L=4, M=(100, 250, 500, 1000))
VNNGP_SWEEP = dict(N=5_000, D=200, L=10, M=1_000, K=8)
PNMF = dict(N=800, D=80)
REGRESSION = dict(n=10_000, M=500)
WARMSTART = dict(N=4_000, D=200, L_total=8, L_spatial=4, M_per_group=40, G=4, B=1_000,
                 pnmf_steps=1_500)
WARMUP_STEPS, TIMED_STEPS = 3, 10
#: timed steps of the generic legs: their first Adam steps from the random
#: init move the loss by orders of magnitude either way
GENERIC_TIMED = 30
GENERIC_PROFILED_STEPS = 5
VNNGP_WARMUP, VNNGP_TIMED, PROFILED_STEPS, AB_STEPS = 3, 30, 5, 10
MGGP_PROFILED_STEPS = 2
MAIN_PROFILED_STEPS = 3
#: benchmarks/ngd_ab.py's defaults on the north-star model: ρ, its ramp and
#: the rate-overflow guard; 40 steps in chunks of 10, one host sync a chunk
NGD = dict(nat_lr=0.01, ramp=400, max_f=60.0, steps=40, chunk=10)
NGD_PROFILED_STEPS = 2
#: [snapshot]: chunks of NGD steps, a posterior snapshot after each
SNAPSHOT = dict(chunks=3, chunk=5)
#: [checkpoint]: chunks saved by the hook, then steps run twice (live, resumed)
CHECKPOINT = dict(chunks=3, chunk=2, more=3)
HYBRID_PROFILED_STEPS = 5

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s without
# tensor cores, dense TF32 tensor-core FLOP/s. TF32 is off for cuBLAS, so
# library and plain times are f32; kernels 1-2 run 3xTF32 on the tensor
# cores and are bounded at the TF32 rate (three products per product).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_TC_FLOP_PER_S = 495e12


def log(msg):
    print(msg, flush=True)


def norm_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def bound(bytes_moved, flops, rate=F32_FLOP_PER_S, ops="operations"):
    """(ms, resource): the least time the card could take to move the bytes
    at the HBM rate or do the FLOPs at ``rate`` (f32 by default), whichever
    is longer; ``ops`` names the second resource."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, ops)


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


def device_ms(fn, reps, kernel):
    """Mean device time of the CUDA kernels whose name contains ``kernel``,
    over ``reps`` calls of ``fn`` under torch.profiler (CUPTI), and how many
    such kernels it recorded per call; (None, 0) if the profiler
    cannot trace the card. Unlike :func:`median_ms`, it leaves out the
    host's time in the wrapper, which bounds a small call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    except Exception as exc:  # noqa: BLE001 - a report, not a check
        log(f"  profiler: unavailable ({type(exc).__name__}: {exc})")
        return None, 0
    if not spans:
        return None, 0
    # the mean over the spans recorded: the profiler may drop a few events
    return sum(spans) / len(spans) / 1e3, len(spans) / reps


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


def _kernel_name(mangled):
    """``name<args>`` of a mangled kernel symbol: its last identifier that
    ends in "kernel" and its integer or bool template arguments."""
    found = re.search(r"\d([A-Za-z_]+kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if found is None:
        return mangled
    args = [{"b": {"0": "false", "1": "true"}.get(v, v)}.get(kind, v)
            for kind, v in re.findall(r"L([ib])(\d+)E", found.group(2) or "")]
    return found.group(1) + (f"<{','.join(args)}>" if args else "")


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
                entry = _kernel_name(line.split("'")[1])
            elif entry and ("spill" in line or "registers" in line):
                log(f"  ptxas {name}.cu {entry}: {line.split(':', 1)[-1].strip()}")


def phase_sass(checks):
    """The instruction mix of every kernel of tri.cu, gram.cu and vnngp.cu,
    read from ``cuobjdump -sass`` of the built libraries. The tensor-core
    MMA (HGMMA) must be in both instances of the tri main loop,
    tri_mma_kernel<false> (kernel 2) and <true> (kernel 1)."""
    from gpzoo_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log(f"[sass] {tool} not in the toolkit: instruction mix not read")
        return
    mixes = {}
    for lib in ("tri", "gram", "vnngp"):
        out = subprocess.run([str(tool), "-sass", str(_build._lib_path(_build.CSRC / f"{lib}.cu"))],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            log(f"[sass] cuobjdump failed on {lib}.cu: {out.stderr.strip()[:300]}")
            continue
        log(f"[sass] {lib}.cu instruction mix (cuobjdump -sass)")
        lib_mixes, name = {}, None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                name = _kernel_name(line.split(":", 1)[1].strip())
                lib_mixes[name] = {}
            elif name is not None:
                op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)",
                              line)
                if op:
                    lib_mixes[name][op.group(1)] = lib_mixes[name].get(op.group(1), 0) + 1
        for name, mix in sorted(lib_mixes.items()):
            top = ", ".join(f"{k} {v}" for k, v in
                            sorted(mix.items(), key=lambda kv: -kv[1])[:10])
            log(f"  {name}: {sum(mix.values())} instructions; top: {top}")
        mixes.update(lib_mixes)
    for inst in ("tri_mma_kernel<false>", "tri_mma_kernel<true>"):
        checks.true(f"HGMMA in {inst}", mixes.get(inst, {}).get("HGMMA", 0) > 0)


def _tri_bounds(L, M, B, per_factor):
    """(bytes, FLOP) of kernels 1-2: each input byte read once (Lu's lower
    triangle and a), the staged hi/lo scratch that the MMA loop reads
    written once and read once, and the triangle's L·B·M(M+1) FLOP."""
    from gpzoo_tpu_torch.ops import tri_cuda

    mp, tile = tri_cuda.padded(M), tri_cuda._TILE
    lut_read = 2 * L * sum(tile * (mp - tile * i) for i in range(mp // tile))
    at = 2 * (L if per_factor else 1) * B * mp
    in_bytes = 4 * (L * M * (M + 1) // 2 + (L if per_factor else 1) * M * B)
    return in_bytes, 4 * (lut_read + at), L * B * M * (M + 1)


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
    # the staging pass alone, into zeroed scratch, against its plain
    # version: the same transpose and rounding, so equal to the bit
    scratch = tri_cuda._scratch(lu, a).zero_()
    staged = tri_cuda.stage(lu, a, scratch)
    for got, ref, what in zip(staged, tri_cuda.stage_plain(lu, a), ("LuT", "aT")):
        checks.le(f"stage {what} hi/lo {label}",
                  float((got - ref).abs().max()) if ref.numel() else 0.0, 0.0)
    del staged
    torch.cuda.synchronize()
    if timings is None:
        return
    in_bytes, scratch_bytes, tri_flops = _tri_bounds(L, M, B, per_factor)
    stage_ms = median_ms(lambda: tri_cuda.stage(lu, a, scratch), 5)
    del scratch
    for name, out_bytes, extra_flops in (("tri_sq_colsum", 4 * L * B, 2 * L * M * B),
                                         ("tri_t_matmul", 4 * L * M * B, 0)):
        # 3xTF32: three tensor-core products per product of the triangle
        bound_ms, bound_by = bound(in_bytes + 2 * scratch_bytes + out_bytes,
                                   3 * tri_flops, TF32_TC_FLOP_PER_S,
                                   "operations (3xTF32 tensor cores)")
        timings[name] = dict(
            bound_ms=bound_ms, bound_by=bound_by,
            # the bound of an FFMA design: f32 rate, no scratch
            f32_bound_ms=bound(in_bytes + out_bytes, tri_flops + extra_flops)[0],
            stage_ms=stage_ms)
    timings["tri_sq_colsum"].update(
        max_abs_err=err1,
        ms=median_ms(lambda: tri_cuda.tri_sq_colsum_fused(lu, a), 5),
        plain_ms=median_ms(lambda: tri_blocked.tri_sq_colsum(lu, a), 5),
        library_ms=None)
    timings["tri_t_matmul"].update(
        max_abs_err=err2,
        ms=median_ms(lambda: tri_cuda.tri_t_matmul(lu, a), 5),
        plain_ms=median_ms(lambda: tri_blocked.tri_t_matmul(lu, a), 5),
        # one cuBLAS call (f32, TF32 off) computes the same c, Lu being
        # lower-triangular
        library_ms=median_ms(lambda: torch.matmul(lu.mT, a), 5))
    fwd_bwd = dict(
        kernel=lambda: tri_cuda.tri_sq_colsum(lu.requires_grad_(), a).backward(gout),
        plain=lambda: tri_blocked.tri_sq_colsum(lu.requires_grad_(), a).backward(gout))
    for name, fn in fwd_bwd.items():
        ms = median_ms(fn, 3)
        lu.grad = None
        log(f"  time TriSqColsum fwd+bwd ({name}): {ms:.3f} ms")
    lu.requires_grad_(False)


def hybrid_shape():
    """(L, M, spots trained on, held-out spots) of the Hybrid-NSF leg."""
    n_train = HYBRID["N"] - HYBRID["N"] // 10
    return HYBRID["L"], HYBRID["M_grid"] ** 2, n_train, HYBRID["N"] - n_train


def gram_path_shapes(vnngp):
    """(label, (L, N, M), D) of every shape kernel 3 runs at on the paths,
    D the coordinates per point."""
    l_h, m_h, n_h, v_h = hybrid_shape()
    return [(label, shape, 2) for label, shape in (
            ("NSF Kzz", (1, MAIN["M"], MAIN["M"])),
            ("NSF Kzx", (1, MAIN["M"], MAIN["N"])),
            ("fast Kzx", (1, MAIN["M"], MAIN["B"])),
            ("hybrid Kzz", (l_h, m_h, m_h)),
            ("hybrid Kzx", (l_h, m_h, n_h)),
            ("hybrid posterior Kzx", (l_h, m_h, v_h)),
            ("VNNGP Kzz", (1, vnngp["M"], vnngp["M"])),
            ("VNNGP precompute Kxz", (1, vnngp["N"], vnngp["M"])),
            ("VNNGP step Kxz", (1, vnngp["B"], vnngp["M"])),
            ("VNNGP posterior Kzz", (vnngp["L"], vnngp["M"], vnngp["M"])),
            ("VNNGP posterior Kxz", (vnngp["L"], vnngp["N"], vnngp["M"])))
            ] + new_gram_shapes() + posterior_gram_shapes()


def posterior_gram_shapes():
    """(label, (L, N, M), D) of kernel 3 in the north-star SVGP's posterior
    at the held-out spots ([snapshot]'s snapshots and extract_factors): Kzz
    and Kzx of every factor."""
    return [("NSF posterior Kzz", (MAIN["L"], MAIN["M"], MAIN["M"]), 2),
            ("NSF posterior Kzx", (MAIN["L"], MAIN["M"], HOLDOUT), 2)]


def new_gram_shapes():
    """(label, (L, N, M), D) of kernel 3 on the generic ELBO legs: the NSF
    M-sweep's Kzz and Kzx, the VNNGP sweep's Kxz (its Kzz is the VNNGP
    posterior's shape) and the regression's Kzz and Kzx (D = 1)."""
    l_s, n_s = SWEEP["L"], SWEEP["N"]
    v = VNNGP_SWEEP
    out = []
    for m in SWEEP["M"]:
        out += [(f"sweep Kzz M={m}", (l_s, m, m), 2), (f"sweep Kzx M={m}", (l_s, m, n_s), 2)]
    return out + [("VNNGP sweep Kxz", (v["L"], v["N"], v["M"]), 2),
                  ("regression Kzz", (1, REGRESSION["M"], REGRESSION["M"]), 1),
                  ("regression Kzx", (1, REGRESSION["M"], REGRESSION["n"]), 1)]


def _gram_inputs(g, dev, l_dim, n, m, dim=2):
    """(x, z, sigma, lengthscale) at a path shape: coordinates as the paths
    draw them (``dim`` of them), z the first m rows; L factors with their
    own sigma and lengthscale, one factor with both 1."""
    import torch

    xs = torch.rand((max(n, m), dim), generator=g, device=dev) * 4 - 2
    if l_dim == 1:
        return xs[:n].contiguous(), xs[:m].contiguous(), *torch.ones((2, 1), device=dev)
    return (xs[:n].contiguous(), xs[:m].contiguous(),
            torch.linspace(0.5, 2.0, l_dim, device=dev),
            torch.linspace(0.3, 3.0, l_dim, device=dev))


def _gram_case(checks, dev, g, x, z, sigma, ell, label, timings=None):
    """Kernel 3 against its plain version; with ``timings``, its time, the
    plain version's and the bound go into timings[(L, N, M)]."""
    from gpzoo_tpu_torch.ops import gram_cuda

    out = gram_cuda.rbf_gram_fwd(x, z, sigma, ell)
    ref = gram_cuda.rbf_gram_plain(x, z, sigma, ell)
    checks.le(f"rbf_gram {label}", norm_err(out, ref), TOL_GRAM)
    if timings is not None:
        (n, dim), m, l_dim = x.shape, z.shape[0], sigma.shape[0]
        # d^2 costs 3 FLOP per coordinate, each of the L epilogues ~3
        bound_ms, bound_by = bound(4 * ((n + m) * dim + 2 * l_dim + l_dim * n * m),
                                   n * m * 3 * dim + l_dim * n * m * 3)
        t = timings[(l_dim, n, m)] = dict(
            max_abs_err=float((out - ref).abs().max()),
            ms=median_ms(lambda: gram_cuda.rbf_gram_fwd(x, z, sigma, ell), 20),
            plain_ms=median_ms(lambda: gram_cuda.rbf_gram_plain(x, z, sigma, ell), 10),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log(f"  time rbf_gram {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / t['ms']:.1%} of bound")
    del out, ref


def _mggp_args(g, dev, n, m, l_dim, n_groups, convention):
    """Kernel 4's operands: x (n, 2), z (m, 2), the complete-graph embedding
    of n_groups gathered by random labels, α under ``convention`` (negative
    raw values for ABS and SQUARED), p = 2."""
    import torch
    from gpzoo_tpu_torch.bijectors import GroupDiffConvention
    from gpzoo_tpu_torch.kernels.mggp import _default_embedding

    emb = _default_embedding(n_groups, torch.float32, dev)
    x = torch.rand((n, 2), generator=g, device=dev) * 4 - 2
    z = torch.rand((m, 2), generator=g, device=dev) * 4 - 2
    ex = emb[torch.randint(n_groups, (n,), generator=g, device=dev)]
    ez = emb[torch.randint(n_groups, (m,), generator=g, device=dev)]
    sign = 1.0 if convention == "RAW" else -1.0
    return (x, z, ex, ez, torch.linspace(0.5, 1.5, l_dim, device=dev),
            torch.linspace(0.8, 2.0, l_dim, device=dev),
            GroupDiffConvention[convention].apply(
                sign * torch.linspace(0.2, 2.5, l_dim, device=dev)), 2)


def _mggp_case(checks, dev, g, n, m, l_dim, n_groups, convention, label,
               timings=None, tail=None):
    """Kernel 4 against its plain version on :func:`_mggp_args`. With
    ``tail`` only the last ``tail`` columns are held against the plain
    version (the plain form of a 10 GB Gram would not fit beside it). With
    ``timings``, its time, the plain version's and the bound go into
    timings["mggp_gram"]."""
    from gpzoo_tpu_torch.ops import mggp_cuda

    args = _mggp_args(g, dev, n, m, l_dim, n_groups, convention)
    x, z, ex, ez = args[:4]
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


def _gram_bwd_case(checks, dev, g, l_dim, n, m, label, dim=2):
    """Kernel 3's differentiable Gram (the kernel forward, the closed-form
    backward over its k) against autograd through the plain form: the
    gradients of x, z, σ and ℓ for a random cotangent, and both times."""
    import torch
    from gpzoo_tpu_torch.ops import gram_cuda

    inputs = _gram_inputs(g, dev, l_dim, n, m, dim)
    gout = torch.randn((l_dim, n, m), generator=g, device=dev)

    def grads(gram):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        return torch.autograd.grad(gram(*leaves), leaves, gout)

    got, ref = grads(gram_cuda.rbf_gram), grads(gram_cuda.rbf_gram_plain)
    for what, a, b in zip(("dx", "dz", "dsigma", "dell"), got, ref):
        checks.le(f"rbf_gram backward {what} {label} L={l_dim} {n}x{m}",
                  norm_err(a, b), TOL_GRAM_BWD)
    ms = median_ms(lambda: grads(gram_cuda.rbf_gram), 10)
    plain_ms = median_ms(lambda: grads(gram_cuda.rbf_gram_plain), 10)
    log(f"  time rbf_gram forward+backward {label}: kernel forward and closed-form "
        f"backward {ms:.4f} ms, plain under autograd {plain_ms:.4f} ms")


def _mggp_bwd_case(checks, dev, g, m, n, l_dim, n_groups, label, both):
    """Kernel 4's differentiable Gram (the kernel forward, the backward by
    autograd of the plain recompute) against autograd through the plain
    form, for the gradient of the inducing points x (and of z with
    ``both``, as Kzz = k(Z, Z) has), the kernel frozen, and both times."""
    import torch
    from gpzoo_tpu_torch.kernels.mggp import _default_embedding
    from gpzoo_tpu_torch.ops import mggp_cuda

    emb = _default_embedding(n_groups, torch.float32, dev)
    x = torch.rand((m, 2), generator=g, device=dev) * 4 - 2
    z = x if both else torch.rand((n, 2), generator=g, device=dev) * 4 - 2
    ex = emb[torch.randint(n_groups, (m,), generator=g, device=dev)]
    ez = ex if both else emb[torch.randint(n_groups, (n,), generator=g, device=dev)]
    hyper = (torch.full((l_dim,), 1.0, device=dev), torch.full((l_dim,), 4.0, device=dev),
             torch.full((l_dim,), 0.49, device=dev))
    gout = torch.randn((l_dim, m, n), generator=g, device=dev)

    def grads(gram):
        leaves = [x.clone().requires_grad_()] + ([z.clone().requires_grad_()] if both else [])
        out = gram(leaves[0], leaves[-1] if both else z, ex, ez, *hyper, 2)
        return torch.autograd.grad(out, leaves, gout)

    got, ref = grads(mggp_cuda.mggp_gram), grads(mggp_cuda.mggp_gram_plain)
    for what, a, b in zip(("dx", "dz"), got, ref):
        checks.le(f"mggp_gram backward {what} {label} L={l_dim} {m}x{n}",
                  norm_err(a, b), TOL_GRAM_BWD)
    ms = median_ms(lambda: grads(mggp_cuda.mggp_gram), 5)
    plain_ms = median_ms(lambda: grads(mggp_cuda.mggp_gram_plain), 5)
    log(f"  time mggp_gram forward+backward {label}: kernel forward and plain "
        f"recompute backward {ms:.3f} ms, plain under autograd {plain_ms:.3f} ms")


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
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.1%} of bound")
    timings[label] = dict(
        max_abs_err=max(float((mean - ref_mean).abs().max()),
                        float((cov - ref_cov).abs().max())),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)


def _block_bwd_case(checks, dev, g, n, k, label):
    """Kernel 5's differentiable conditioning (the kernel forward, the
    backward by autograd of the plain recompute) against autograd through
    the plain form, for every operand, and both times."""
    import torch
    from gpzoo_tpu_torch.ops import vnngp_cuda

    ops = _block_operands(g, dev, n, k)
    cot = (torch.randn((n,), generator=g, device=dev), torch.randn((n,), generator=g, device=dev))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ops]
        return torch.autograd.grad(fn(*leaves, 0.1), leaves, cot)

    got = grads(vnngp_cuda.block_conditional)
    ref = grads(vnngp_cuda.block_conditional_plain)
    for what, a, b in zip(("dkzz", "ds", "dkxz", "dmu", "dkxx"), got, ref):
        checks.le(f"block_conditional backward {what} {label} n={n} K={k}",
                  norm_err(a, b), TOL_BLOCK)
    ms = median_ms(lambda: grads(vnngp_cuda.block_conditional), 5)
    plain_ms = median_ms(lambda: grads(vnngp_cuda.block_conditional_plain), 5)
    log(f"  time block_conditional forward+backward {label}: kernel forward and plain "
        f"recompute backward {ms:.3f} ms, plain under autograd {plain_ms:.3f} ms")


def vnngp_full_shape():
    """bench.py's VNNGP leg at its published full width, VNNGP_SHAPES["full"]."""
    from gpzoo_tpu_torch import VNNGP_SHAPES

    return dict(zip(("N", "D", "L", "M", "K", "B"), VNNGP_SHAPES["full"]))


def _log_timings(timings, label=""):
    for name, t in timings.items():
        lib = "" if t["library_ms"] is None else f", library {t['library_ms']:.3f} ms"
        extra = ("" if "stage_ms" not in t else
                 f"; staging pass {t['stage_ms']:.3f} ms of it, f32 bound "
                 f"{t['f32_bound_ms']:.4f} ms")
        log(f"  time {name}{label}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms{lib}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}){extra}")


def phase_kernels(checks, dev, vnngp):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    timings = {}
    log("[kernels] float32, kernel against plain on the same inputs")
    _tri_case(checks, dev, g, 3, 130, 140, "L=3 M=130 B=140")
    _tri_case(checks, dev, g, 2, 1, 70, "L=2 M=1 B=70")
    _tri_case(checks, dev, g, MAIN["L"], MAIN["M"], MAIN["B"],
              "L={L} M={M} B={B}".format(**MAIN), timings)
    torch.cuda.empty_cache()
    # the MGGP step's per-factor a = W·Kzx
    m_mggp = MGGP["M_per_group"] * MGGP["G"]
    per_factor = {}
    _tri_case(checks, dev, g, 3, 130, 140, "per-factor a L=3 M=130 B=140",
              per_factor=True)
    # neither M nor B a multiple of the 128 tile
    _tri_case(checks, dev, g, 2, 257, 129, "per-factor a L=2 M=257 B=129",
              per_factor=True)
    _tri_case(checks, dev, g, MGGP["L"], m_mggp, MGGP["B"],
              f"per-factor a L={MGGP['L']} M={m_mggp} B={MGGP['B']}", per_factor,
              per_factor=True)
    _log_timings(per_factor, " (per-factor a, the MGGP step's shape)")
    torch.cuda.empty_cache()
    # the per-factor a = W·Kzx of the Hybrid-NSF and Hybrid-MGGP steps
    l_h, m_h, n_h, _ = hybrid_shape()
    m_hm = HYBRID_MGGP["M_per_group"] * HYBRID_MGGP["G"]
    for leg, (l_dim, m, b) in (("hybrid", (l_h, m_h, n_h)),
                               ("hybrid_mggp", (HYBRID_MGGP["L"], m_hm, HYBRID_MGGP["B"]))):
        t = {}
        _tri_case(checks, dev, g, l_dim, m, b, f"per-factor a L={l_dim} M={m} B={b}",
                  t, per_factor=True)
        _log_timings(t, f" (per-factor a, the {leg} step's shape)")
        torch.cuda.empty_cache()

    # kernel 3 at ragged shapes: M % 4 in {1, 2, 3, 0}, N = 1, D from 1 to 8
    for dim, l_dim, n, m in ((2, 3, 130, 150), (2, 1, 1, 1), (2, 2, 1, 5),
                             (1, 1, 37, 1030), (3, 2, 7, 1025), (8, 3, 129, 1023),
                             (5, 1, 1, 4), (2, 1, 1, 45_000)):
        x = torch.rand((n, dim), generator=g, device=dev) * 4 - 2
        z = torch.rand((m, dim), generator=g, device=dev) * 4 - 2
        _gram_case(checks, dev, g, x, z, torch.linspace(0.5, 2.0, l_dim, device=dev),
                   torch.linspace(0.3, 3.0, l_dim, device=dev),
                   f"ragged L={l_dim} {n}x{m} D={dim}")
    # every shape of the paths, each timed
    gram = {}
    for label, (l_dim, n, m), dim in gram_path_shapes(vnngp):
        _gram_case(checks, dev, g, *_gram_inputs(g, dev, l_dim, n, m, dim),
                   f"{label} L={l_dim} {n}x{m}", gram)
        torch.cuda.empty_cache()
    # the JSON line carries NSF Kzx, the shape earlier PRs timed
    timings["rbf_gram"] = gram[1, MAIN["M"], MAIN["N"]]
    _log_timings(timings)
    # kernel 3's backward where ℓ and Z train: the Hybrid-NSF step's Kzz, Kzx
    for label, (l_dim, n, m), _ in gram_path_shapes(vnngp)[3:5]:
        _gram_bwd_case(checks, dev, g, l_dim, n, m, label)

    # kernel 4 at the MGGP step's Kzz and Kzx, and ragged under each convention
    for convention in ("ABS", "RAW", "SQUARED"):
        _mggp_case(checks, dev, g, 300, 270, 3, 5, convention, "L=3 300x270 G=5")
    _mggp_case(checks, dev, g, m_mggp, m_mggp, MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzz L={MGGP['L']} {m_mggp}x{m_mggp} G={MGGP['G']}")
    _mggp_case(checks, dev, g, m_mggp, MGGP["B"], MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzx L={MGGP['L']} {m_mggp}x{MGGP['B']} G={MGGP['G']}", timings)
    # kernel 4's shapes for the device phase: (its _mggp_args, its timings)
    mggp = {"MGGP Kzx": ((m_mggp, MGGP["B"], MGGP["L"], MGGP["G"], "SQUARED"),
                         timings["mggp_gram"])}
    # Kzx over every spot: L*M*N outputs pass 2^31, so the last columns
    # check the kernel's 64-bit offsets
    _mggp_case(checks, dev, g, m_mggp, MGGP["N"], MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzx L={MGGP['L']} {m_mggp}x{MGGP['N']}, last 2,000 columns",
               tail=2000)
    _log_timings({"mggp_gram": timings["mggp_gram"]})
    torch.cuda.empty_cache()
    # the Hybrid-MGGP step's Kzz and Kzx forward, and their backward where Z trains
    for n, label in ((m_hm, "Kzz"), (HYBRID_MGGP["B"], "Kzx")):
        _mggp_case(checks, dev, g, m_hm, n, HYBRID_MGGP["L"], HYBRID_MGGP["G"],
                   "SQUARED", f"hybrid_mggp {label} L={HYBRID_MGGP['L']} {m_hm}x{n} "
                   f"G={HYBRID_MGGP['G']}")
        _mggp_bwd_case(checks, dev, g, m_hm, n, HYBRID_MGGP["L"], HYBRID_MGGP["G"],
                       f"hybrid_mggp {label}", both=label == "Kzz")
        torch.cuda.empty_cache()

    block = {}
    _block_case(checks, dev, g, 130, 5, "n=130 K=5")
    _block_case(checks, dev, g, 1_000, 16, "n=1000 K=16")
    # ragged: one point, one past a 32-point block, one past the step's n
    for n in (1, 33, vnngp["B"] + 1):
        _block_case(checks, dev, g, n, vnngp["K"], f"n={n} K={vnngp['K']}")
    _block_case(checks, dev, g, vnngp["B"], vnngp["K"], "step", block)
    _block_case(checks, dev, g, vnngp["L"] * vnngp["N"], vnngp["K"], "posterior", block)
    # the JSON line carries the posterior shape, where the bytes dominate
    timings["block_conditional"] = block["posterior"]
    torch.cuda.empty_cache()

    # the generic ELBO legs, where Z and the kernel train (kernel 3's forward
    # is timed above at each of their shapes): kernel 3's backward at each,
    # kernel 4 at the warm start's fine-tune, forward and backward for Z, and
    # kernel 5 at the VNNGP sweep's point count (L x N folded), both ways
    log("[kernels] the generic ELBO legs' shapes, forward and backward")
    v = VNNGP_SWEEP
    for label, (l_dim, n, m), dim in new_gram_shapes() + [
            ("VNNGP sweep Kzz", (v["L"], v["M"], v["M"]), 2)]:
        _gram_bwd_case(checks, dev, g, l_dim, n, m, label, dim)
        torch.cuda.empty_cache()
    w = WARMSTART
    m_ws = w["M_per_group"] * w["G"]
    for n, label in ((m_ws, "Kzz"), (w["B"], "Kzx")):
        t = {}
        _mggp_case(checks, dev, g, m_ws, n, w["L_spatial"], w["G"], "SQUARED",
                   f"warmstart {label} L={w['L_spatial']} {m_ws}x{n} G={w['G']}", t)
        _log_timings(t, f" (warmstart {label})")
        mggp[f"warmstart {label}"] = ((m_ws, n, w["L_spatial"], w["G"], "SQUARED"),
                                      t["mggp_gram"])
        _mggp_bwd_case(checks, dev, g, m_ws, n, w["L_spatial"], w["G"],
                       f"warmstart {label}", both=label == "Kzz")
    n_fold = v["L"] * v["N"]
    _block_case(checks, dev, g, n_fold, v["K"], "VNNGP sweep", block)
    _block_bwd_case(checks, dev, g, n_fold, v["K"], "VNNGP sweep")
    torch.cuda.empty_cache()
    return timings, {"rbf_gram": gram, "mggp_gram": mggp,
                     "block_conditional": {(vnngp["B"], vnngp["K"]): block["step"],
                                           (vnngp["L"] * vnngp["N"], vnngp["K"]):
                                           block["posterior"],
                                           (n_fold, v["K"]): block["VNNGP sweep"]}}


def phase_device_times(dev, vnngp, shape_timings):
    """Kernels 3 and 5 alone on the device at every path shape, and kernel 4
    at the MGGP step's Kzx and the warm start's Kzz and Kzx, from the
    profiler: each shape's ``device_ms`` goes into ``shape_timings``. The
    kernel phase's times (CUDA events around one wrapper call, as earlier
    PRs measured them) also hold the wrapper's host work, which bounds a
    small call. This runs last, so the profiler never precedes a timed step."""
    import torch
    from gpzoo_tpu_torch.ops import gram_cuda, mggp_cuda, vnngp_cuda

    g = torch.Generator(device=dev).manual_seed(1)
    log("[device] kernels 3, 4 and 5 alone on the device (torch.profiler, 10 calls)")
    for label, shape, dim in gram_path_shapes(vnngp):
        args = _gram_inputs(g, dev, *shape, dim)
        ms, per_call = device_ms(lambda: gram_cuda.rbf_gram_fwd(*args), 10,
                                 "rbf_gram_kernel")
        _log_device(shape_timings["rbf_gram"][shape], ms, per_call,
                    f"rbf_gram {label} {shape}")
        del args
        torch.cuda.empty_cache()
    for (n, k), t in shape_timings["block_conditional"].items():
        ops = _block_operands(g, dev, n, k)
        ms, per_call = device_ms(lambda: vnngp_cuda.block_conditional_fwd(*ops, 0.1),
                                 10, "block_conditional_kernel")
        _log_device(t, ms, per_call, f"block_conditional {(n, k)}")
        del ops
    for label, (spec, t) in shape_timings["mggp_gram"].items():
        args = _mggp_args(g, dev, *spec)
        ms, per_call = device_ms(lambda: mggp_cuda.mggp_gram_fwd(*args), 10,
                                 "mggp_gram_kernel")
        _log_device(t, ms, per_call, f"mggp_gram {label} (L={spec[2]}, {spec[0]}x{spec[1]})")
        del args


def _log_device(t, ms, per_call, label):
    t["device_ms"] = ms
    if ms is None:
        log(f"  {label}: not measured")
        return
    log(f"  {label}: {ms:.4f} ms on the device ({per_call:g} kernels recorded a call), "
        f"bound {t['bound_ms']:.4f} ms, {t['bound_ms'] / ms:.1%} of bound; "
        f"call {t['ms']:.4f} ms")


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


@contextlib.contextmanager
def launch_shapes(seen):
    """While active, the differentiable entry points of kernels 3 and 5
    (``gram_cuda.rbf_gram``, as kernels/rbf.py calls it, and
    ``block_conditional`` as gps/vnngp.py imported it) are wrapped by
    spies that add the shape of each call that launched the kernel (its
    wrapper's counter rose) to ``seen[name]``, a Counter: (L, N, M) for
    rbf_gram, (n, K) for block_conditional."""
    from gpzoo_tpu_torch.gps import vnngp as vnngp_module
    from gpzoo_tpu_torch.ops import gram_cuda, vnngp_cuda

    def spy(module, attr, name, wrapper, shape_of):
        call = getattr(module, attr)

        def wrapped(*args):
            before = wrapper.launches
            out = call(*args)
            if wrapper.launches > before:
                seen.setdefault(name, collections.Counter())[shape_of(args)] += (
                    wrapper.launches - before)
            return out
        return mock.patch.object(module, attr, wrapped)

    with spy(gram_cuda, "rbf_gram", "rbf_gram", gram_cuda.rbf_gram_fwd,
             lambda a: (a[2].shape[0], a[0].shape[0], a[1].shape[0])), \
            spy(vnngp_module, "block_conditional", "block_conditional",
                vnngp_cuda.block_conditional_fwd, lambda a: tuple(a[0].shape[:2])):
        yield seen


def per_shape_summary(checks, seen, shape_timings):
    """Kernels 3 and 5 by shape: launches on the paths, the call's time (CUDA
    events) and the kernel's device time (profiler, where measured) beside
    the bound, and launches x (ms - bound), the time the paths lose against
    the bound, from each. Every shape the paths launched must have been timed."""
    for name, shapes in seen.items():
        lost = {"call": 0.0, "device": 0.0}
        measured = True
        log(f"[{name} by shape] launches on the paths; call ms, device ms, bound ms")
        for shape, count in sorted(shapes.items()):
            t = shape_timings[name].get(shape)
            checks.true(f"{name} {shape} timed in the kernel phase", t is not None)
            if t is None:
                continue
            dev_ms = t.get("device_ms")
            lost["call"] += count * (t["ms"] - t["bound_ms"])
            if dev_ms is None:
                measured = False
            else:
                lost["device"] += count * (dev_ms - t["bound_ms"])
            log(f"  {shape}: {count} launches; call {t['ms']:.4f} ms, device "
                f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, "
                f"bound {t['bound_ms']:.4f} ms")
        log(f"  sum of launches x (ms - bound): {lost['call']:.3f} ms from the calls, "
            + (f"{lost['device']:.3f} ms on the device" if measured else
               "on the device not measured"))


def _loss_grads(model, proj, y, idx, eps, **kw):
    """The precomputed loss and the gradient of every leaf it reaches."""
    from gpzoo_tpu_torch.train import nsf_negative_elbo_precomputed

    model.zero_grad(set_to_none=True)
    loss = nsf_negative_elbo_precomputed(model, proj, y, idx, eps,
                                         y_transposed=True, **kw)
    loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@functools.lru_cache(maxsize=1)
def nsf_data(dev):
    """bench.py's NSF data at MAIN's shape, on the device: coords
    U(−2, 2) (N, 2) and counts Poisson(3) stored spot-major (N, D), numpy
    seed 0; shared by the north-star, NB and low-rank legs."""
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(MAIN["N"], 2)).astype(np.float32)
    counts_t = rng.poisson(3.0, size=(MAIN["N"], MAIN["D"])).astype(np.float32)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts_t).to(dev)
    log(f"  synthetic data: {time.perf_counter() - t0:.1f}s")
    return x, y


def precomputed_leg(checks, dev, seen, tag, cfg, counter_names, profiled_steps):
    """One leg of bench.py's NSF benchmark on the precomputed loss at full
    width: config build, the precomputed projection, warm-up and timed
    Adam steps, the held-out deviance, peak memory and the launch counts
    of ``counter_names`` (each must be > 0), the precompute once more
    warm, and a profiled window. Launches of kernel 3 by shape go into
    ``seen``. Returns (model, proj, launches)."""
    import torch
    from gpzoo_tpu_torch import (make_batched_train_step,
                                 nsf_negative_elbo_precomputed,
                                 precompute_nsf_projection, run_steps)
    from gpzoo_tpu_torch.data import held_out_deviance

    n, b = cfg.N, cfg.batch_size
    x, y = nsf_data(dev)
    counters = _launch_counters(counter_names)
    _zero(counters)
    spies = contextlib.ExitStack()
    spies.enter_context(launch_shapes(seen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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
    spies.close()
    # the precompute once more, warm (not counted): the set-up metric
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    precompute_nsf_projection(model, x)
    torch.cuda.synchronize()
    log(f"  precompute alone, warm: {(time.perf_counter() - t0) * 1e3:.3f} ms")

    log(f"  losses: {[f'{v:.6e}' for v in losses.tolist()]}")
    log(f"  steps/s: {TIMED_STEPS / dt:.4f} ({dt / TIMED_STEPS * 1e3:.2f} ms/step, "
        f"host clock over {TIMED_STEPS} steps)")
    log(f"  held-out Poisson deviance (holdout {HOLDOUT}): {dev_val:.6f}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches on the {tag} path: {launches}; by shape: "
        f"{ {k: dict(v) for k, v in seen.items()} }")
    checks.true(f"{tag} losses finite", bool(torch.isfinite(losses).all()))
    checks.true(f"{tag} held-out deviance finite", math.isfinite(dev_val))
    for name, count in launches.items():
        checks.true(f"{name} launched on the {tag} path ({count})", count > 0)
    profile_window(lambda: step(model, proj, y), profiled_steps)
    del step, opt
    return model, proj, launches


def _blockwise_loss_grad(model, x, y, idx, eps, eps2=None, **kw):
    """The blockwise loss and the gradient of every trained leaf."""
    from gpzoo_tpu_torch.train import nsf_negative_elbo_batched

    model.zero_grad(set_to_none=True)
    loss = nsf_negative_elbo_batched(model, x, y, idx, eps, eps2, **kw)
    loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def train_leg(checks, tag, step, model, args, counter_names, deviance,
              profiled_steps, seen=None, timed_steps=TIMED_STEPS,
              quality="held-out Poisson deviance"):
    """Warm-up and ``timed_steps`` timed steps of ``step(model, *args)``,
    the quality metric ``deviance()`` (named by ``quality``), peak memory
    since the caller's reset, the launches of ``counter_names`` over the
    steps (each must be > 0) and in the deviance, and a profiled window.
    Launches of kernels 3 and 5 by shape go into ``seen`` when given.
    Returns (step launches, deviance launches)."""
    import torch

    counters = _launch_counters(counter_names)
    spies = contextlib.ExitStack()
    if seen is not None:
        spies.enter_context(launch_shapes(seen))
    _zero(counters)
    warm, warm_s = _timed_steps(step, model, args, WARMUP_STEPS)
    timed, dt = _timed_steps(step, model, args, timed_steps)
    launches = _read(counters)
    losses = torch.cat([warm, timed])
    _zero(counters)
    t0 = time.perf_counter()
    dev_val = float(deviance())
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    post = _read(counters)
    spies.close()
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + timed_steps
    log(f"  warm-up {WARMUP_STEPS} steps: {warm_s:.2f}s")
    log(f"  losses: {[f'{v:.6e}' for v in losses.tolist()]}")
    log(f"  steps/s: {timed_steps / dt:.4f} ({dt / timed_steps * 1e3:.2f} ms/step, "
        f"host clock over {timed_steps} steps)")
    log(f"  {quality} ({post_s:.3f}s): {dev_val:.6f}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches over {steps} steps: {launches} (per step: "
        f"{ {k: v / steps for k, v in launches.items()} }); held-out deviance: {post}"
        + ("" if seen is None else
           f"; kernel 3 by shape: { {k: dict(v) for k, v in seen.items()} }"))
    checks.true(f"{tag} losses finite", bool(torch.isfinite(losses).all()))
    checks.true(f"{tag} {quality} finite", math.isfinite(dev_val))
    for name, count in launches.items():
        checks.true(f"{name} launched on the {tag} step ({count})", count > 0)
    profile_window(lambda: step(model, *args), profiled_steps)
    return launches, post


def _step_batch(dev, cfg):
    """One fixed minibatch and its draws for the kernel-vs-plain steps."""
    import torch

    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(cfg.N - HOLDOUT, generator=g2, device=dev)[:cfg.batch_size]
    return idx, torch.randn((cfg.E, cfg.L, cfg.batch_size), generator=g2, device=dev)


def step_kernels_vs_plain(checks, tag, model, proj, y, idx, eps):
    """One step with kernels 1-2 against the same step with their plain
    versions: the loss and the gradient of every leaf it reaches. The
    kernels' step must launch kernels 1-2 and the plain one neither, or
    the comparison is with itself. Returns both steps' (loss, grads)."""
    from gpzoo_tpu_torch.ops import tri_blocked
    from gpzoo_tpu_torch.train import fast

    counters = _launch_counters(("tri_sq_colsum", "tri_t_matmul"))
    _zero(counters)
    loss_k, grad_k = _loss_grads(model, proj, y, idx, eps)
    kernel_step = _read(counters)
    _zero(counters)
    with mock.patch.object(fast, "tri_sq_colsum", tri_blocked.tri_sq_colsum):
        loss_p, grad_p = _loss_grads(model, proj, y, idx, eps)
    plain_step = _read(counters)
    checks.true(f"{tag} kernels' step launched kernels 1-2 ({kernel_step})",
                all(v > 0 for v in kernel_step.values()))
    checks.true(f"{tag} plain step launched neither ({plain_step})",
                not any(plain_step.values()))
    checks.le(f"{tag} step loss, kernels vs plain (relative)",
              float(abs(loss_k - loss_p) / abs(loss_p)), TOL_STEP_LOSS)
    checks.true(f"{tag} step: the same leaves reached", set(grad_k) == set(grad_p))
    for name in grad_p:
        checks.le(f"{tag} step d{name}, kernels vs plain",
                  norm_err(grad_k[name], grad_p[name]), TOL_STEP_GRAD)
    return (loss_k, grad_k), (loss_p, grad_p)


def phase_main(checks, dev, seen):
    import torch
    from gpzoo_tpu_torch import SlideseqNSFConfig

    log(f"[main] north-star NSF step, N={MAIN['N']} D={MAIN['D']} L={MAIN['L']} "
        f"M={MAIN['M']} batch={MAIN['B']}")
    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"])
    model, proj, launches = precomputed_leg(
        checks, dev, seen, "main", cfg, ("tri_sq_colsum", "tri_t_matmul", "rbf_gram"),
        MAIN_PROFILED_STEPS)
    step_kernels_vs_plain(checks, "main", model, proj, nsf_data(dev)[1],
                          *_step_batch(dev, cfg))
    del model, proj
    torch.cuda.empty_cache()
    return launches


def phase_fast(checks, dev, seen):
    """bench.py's ``--loss fast`` leg at full width: the north-star model
    trained by the blockwise loss (``factored``, ``shared_kernel``,
    ``remat=False``, one chunk of 7,000), which forms the Gram, its
    Cholesky and K⁻¹ every step (kernel 3 twice, kernels 1-2 once each on
    the shared ã = K⁻¹Kzx). Besides the figures of every leg: with Z and the
    kernel frozen the loss equals the precomputed north-star loss, so one
    step of each on the same model, idx and eps must agree: the loss in
    float32, and the loss and the gradients of μ, Lu, W and V in float64;
    and one step with kernels 1-3 against it with their plain versions,
    both against float64."""
    import torch
    from gpzoo_tpu_torch import (SlideseqNSFConfig, make_batched_train_step,
                                 nsf_negative_elbo_batched, precompute_nsf_projection)
    from gpzoo_tpu_torch.data import held_out_deviance

    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"])
    n, b = cfg.N, cfg.batch_size
    log(f"[fast] the blockwise loss on the north-star model, N={n} D={cfg.D} "
        f"L={cfg.L} M={cfg.M} batch={b}")
    x, y = nsf_data(dev)
    n_train = n - HOLDOUT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x)
    kw = dict(microbatch=b, factored=True, shared_kernel=True, remat=False,
              y_transposed=True)
    step = make_batched_train_step(nsf_negative_elbo_batched, cfg.optimizer(model),
                                   n_train, b, cfg.L, gen, E=cfg.E, loss_kwargs=kw)
    vidx = torch.arange(n_train, n, device=dev)
    launches, post = train_leg(
        checks, "fast", step, model, (x, y), ("tri_sq_colsum", "tri_t_matmul", "rbf_gram"),
        lambda: held_out_deviance(model, precompute_nsf_projection(model, x), y, vidx),
        MAIN_PROFILED_STEPS, seen)
    del step
    idx, eps = _step_batch(dev, cfg)
    loss_b, grad_b = _blockwise_loss_grad(model, x, y, idx, eps, **kw)
    loss_p, grad_p = _loss_grads(model, precompute_nsf_projection(model, x), y, idx, eps)
    checks.le("fast step loss against the precomputed north-star loss (relative)",
              float(abs(loss_b - loss_p) / abs(loss_p)), TOL_STEP_LOSS)
    checks.true(f"fast step reaches the north-star's leaves ({sorted(grad_b)})",
                set(grad_b) == set(grad_p) == {"prior.mu", "prior.Lu_raw", "W_raw", "V_raw"})
    # In float32 the two differ by the single-product ã = K⁻¹Kzx of the
    # blockwise form against the precompute's two triangular solves, whose
    # rounding K⁻¹'s condition number amplifies (O(κ²ε) against O(κε)):
    # printed here, and held as the same math in float64 below.
    log("  fast step against the north-star step in float32: " + ", ".join(
        f"d{name} {norm_err(grad_b[name], grad_p[name]):.3e}" for name in grad_p))
    del grad_b, grad_p
    x64, y64, eps64 = x.double(), y.double(), eps.double()
    with plain_rbf_kernels():
        model64 = copy.deepcopy(model).double()
        loss_b, grad_b = _blockwise_loss_grad(model64, x64, y64, idx, eps64, **kw)
        loss_p, grad_p = _loss_grads(model64, precompute_nsf_projection(model64, x64),
                                     y64, idx, eps64)
    del model64
    checks.le("fast step loss against the precomputed north-star loss in float64 "
              "(relative)", float(abs(loss_b - loss_p) / abs(loss_p)), TOL_STEP_LOSS)
    for name in grad_p:
        checks.le(f"fast step d{name} against the north-star step in float64",
                  norm_err(grad_b[name], grad_p[name]), TOL_STEP_GRAD)
    del grad_b, grad_p, x64, y64
    torch.cuda.empty_cache()
    names = ("tri_sq_colsum", "tri_t_matmul", "rbf_gram")
    steps_vs_plain(checks, "fast", names, plain_rbf_kernels,
                   lambda r: _blockwise_loss_grad(model, x, y, idx, eps, **kw),
                   lambda r: _blockwise_loss_grad(copy.deepcopy(model).double(), x.double(),
                                                  y.double(), idx, eps.double(), **kw))
    del model
    torch.cuda.empty_cache()
    return {name: launches[name] + post[name] for name in launches}


def phase_nb(checks, dev, seen):
    """bench.py's ``--likelihood nb`` leg on the port at full width: the
    north-star step with the negative-binomial head (per-gene r_raw from
    r₀ = 10, trained). Kernels 1-2 run every step, kernel 3 in the
    precompute. Besides the figures of every leg: one step with kernels 1-2
    against the same step with their plain versions (every leaf, r_raw
    included), and both against the same step in float64 on the card
    (plain versions): the NB log-likelihood's lgamma(x + r) − lgamma(r)
    and (x + r)·log(μ + r) cancel in float32."""
    import torch
    from gpzoo_tpu_torch import SlideseqNSFConfig
    from gpzoo_tpu_torch.ops import tri_blocked
    from gpzoo_tpu_torch.train import fast

    log(f"[nb] negative-binomial NSF step, N={MAIN['N']} D={MAIN['D']} "
        f"L={MAIN['L']} M={MAIN['M']} batch={MAIN['B']}, r0 = 10")
    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"], likelihood="nb")
    model, proj, launches = precomputed_leg(
        checks, dev, seen, "nb", cfg, ("tri_sq_colsum", "tri_t_matmul", "rbf_gram"),
        MAIN_PROFILED_STEPS)
    checks.true("nb leg trains r_raw", model.r_raw.requires_grad)
    y = nsf_data(dev)[1]
    idx, eps = _step_batch(dev, cfg)
    (loss_k, grad_k), (loss_p, grad_p) = step_kernels_vs_plain(
        checks, "nb", model, proj, y, idx, eps)
    checks.true("nb step reaches r_raw", "r_raw" in grad_k)
    # the same step in float64 (plain versions: the kernels are float32)
    model64 = copy.deepcopy(model).double()
    proj64 = _proj_as(proj, torch.float64)
    with mock.patch.object(fast, "tri_sq_colsum", tri_blocked.tri_sq_colsum):
        loss_r, grad_r = _loss_grads(model64, proj64, y.double(), idx, eps.double())
    del model64, proj64
    err_k = float(abs(loss_k - loss_r) / abs(loss_r))
    log(f"  nb step loss against float64: kernels {err_k:.3e}, plain "
        f"{float(abs(loss_p - loss_r) / abs(loss_r)):.3e} (relative)")
    checks.le("nb step loss, float32 kernels against float64 (relative)", err_k,
              TOL_STEP_LOSS)
    for name in grad_r:
        ref = grad_r[name].float()
        e_k, e_p = norm_err(grad_k[name], ref), norm_err(grad_p[name], ref)
        log(f"  nb step d{name} against float64: kernels {e_k:.3e}, plain {e_p:.3e}")
        checks.le(f"nb step d{name}, float32 kernels against float64", e_k,
                  max(TOL_STEP_GRAD, 2 * e_p))
    del model, proj, grad_k, grad_p, grad_r
    torch.cuda.empty_cache()
    return launches


def phase_lowrank(checks, dev, seen):
    """bench.py's rank-64 low-rank leg on the port at full width:
    LowRankWSVGP over the whitened precompute (kernel 3 twice); the step's
    variance term is two thin products, no kernel. Besides the figures of
    every leg: the whitened precompute with kernel 3 against it with kernel
    3's plain version."""
    import torch
    from gpzoo_tpu_torch import SlideseqNSFConfig, precompute_nsf_projection
    from gpzoo_tpu_torch.ops import gram_cuda

    log(f"[lowrank] rank-64 low-rank NSF step, N={MAIN['N']} D={MAIN['D']} "
        f"L={MAIN['L']} M={MAIN['M']} batch={MAIN['B']}")
    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"], rank=LOWRANK_RANK)
    model, proj, launches = precomputed_leg(checks, dev, seen, "lowrank", cfg,
                                            ("rbf_gram",), MAIN_PROFILED_STEPS)
    checks.true("lowrank projection whitened, no K⁻¹",
                proj.whitened and proj.k_inv is None)
    x = nsf_data(dev)[0]
    with mock.patch.object(gram_cuda, "rbf_gram_fwd", gram_cuda.rbf_gram_plain):
        plain = precompute_nsf_projection(model, x)
    for field in ("proj_t", "a2"):
        checks.le(f"lowrank whitened precompute {field}, kernel 3 vs plain",
                  norm_err(getattr(proj, field), getattr(plain, field)), TOL_PROJ)
    del model, proj, plain
    torch.cuda.empty_cache()
    return launches


def _ngd_copy(state, dtype):
    """A copy of an NGD state in ``dtype``, sharing its generator (the step
    core draws nothing)."""
    from gpzoo_tpu_torch.train.ngd import NGDTrainState

    opt = {"count": state.opt_state["count"].clone(),
           **{m: {k: v.to(dtype, copy=True) for k, v in state.opt_state[m].items()}
              for m in ("mu", "nu")}}
    return NGDTrainState(copy.deepcopy(state.model).to(dtype),
                         state.prec.to(dtype, copy=True),
                         state.prec_chol.to(dtype, copy=True), opt, state.generator,
                         state.step)


def _proj_as(proj, dtype):
    """A copy of an unwhitened projection with its tensors in ``dtype``."""
    out = copy.copy(proj)
    for field in ("proj_t", "a2", "kxx", "k_inv", "logdet_lzz"):
        setattr(out, field, getattr(proj, field).to(dtype))
    return out


def _ngd_one_step(state, proj, y, idx, eps, lr):
    """The NGD step's loss and gradients, then the step itself on ``state``
    (the [ngd] leg's ρ, ramp and guard): {quantity: value} with the update
    of the mean, Δm = m′ − m, and of the precision, ΔP = P′ − P."""
    from gpzoo_tpu_torch.train.ngd import HeadAdam, _ngd_loss_and_grads, ngd_step

    loss, g_m, g_s, g_head = _ngd_loss_and_grads(state, proj, y, idx, eps,
                                                 y_transposed=True)
    m0, p0 = state.model.prior.mu.detach().clone(), state.prec.clone()
    _, rejected = ngd_step(state, HeadAdam(lr), proj, y, idx, eps, NGD["nat_lr"],
                           NGD["ramp"], NGD["max_f"], y_transposed=True)
    out = {"loss": loss, "g_m": g_m, "g_S": g_s,
           **{f"d{k}": v for k, v in g_head.items()},
           "Δm": state.model.prior.mu.detach() - m0, "ΔP": state.prec - p0}
    return out, int(rejected)


def ngd_step_vs_float64(checks, state, proj, y, idx, eps, lr):
    """(a): the first NGD step from the init (P = S = I) in float32, on a
    copy of ``state``, against the same step in float64 on the card: the
    loss (relative), g_m, g_S, the head's gradients, Δm and ΔP, each within
    TOL_NGD of float64 (max|err| / max|float64|). A control step with TF32
    on for every cuBLAS product must fail at least one of those limits."""
    import torch

    ref, rej_r = _ngd_one_step(_ngd_copy(state, torch.float64), _proj_as(proj, torch.float64),
                               y.double(), idx, eps.double(), lr)
    got, rej = _ngd_one_step(_ngd_copy(state, torch.float32), proj, y, idx, eps, lr)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control, _ = _ngd_one_step(_ngd_copy(state, torch.float32), proj, y, idx, eps, lr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    diag = torch.linalg.cholesky(state.prec.double() + ref["ΔP"]).diagonal(dim1=-2, dim2=-1)
    log(f"  rejected factors: float32 {rej}, float64 {rej_r}; κ(P′) ≥ "
        f"{float((diag.amax(-1) / diag.amin(-1)).square().max()):.3e} (its Cholesky diagonal)")
    checks.true("ngd float32 and float64 steps reject the same factors", rej == rej_r)
    control_failed = []
    for what, r in ref.items():
        if what == "loss":
            err = [float(abs(o[what].double() - r) / abs(r)) for o in (got, control)]
            tol = TOL_STEP_LOSS
        else:
            err = [norm_err(o[what].double(), r) for o in (got, control)]
            tol = TOL_NGD
        log(f"  ngd step {what} against float64: float32 {err[0]:.3e}, TF32 control "
            f"{err[1]:.3e}")
        checks.le(f"ngd step {what}, float32 against float64"
                  + (" (relative)" if what == "loss" else ""), err[0], tol)
        if not err[1] <= tol:
            control_failed.append(what)
    checks.true(f"ngd: the control step, TF32 products, fails the limits "
                f"({', '.join(control_failed) or 'none'})", bool(control_failed))


def phase_ngd(checks, dev, seen):
    """Natural-gradient VI on the north-star model (benchmarks/ngd_ab.py's
    defaults: nat_lr 0.01 ramped over 400 steps, max_f 60, Adam(2e-3) on the
    head) at full width, on [main]'s data: (a) :func:`ngd_step_vs_float64`;
    (b) 40 steps through ``make_scan_runner`` in chunks of 10 (ms/step on the
    host clock over the last 30, peak memory, rejected factors and skipped
    steps, a profiled window), the held-out deviance against that of 40 Adam
    steps from the same init and data (kernels 1-2); (c) ``ngd_to_model``:
    the written-back S against P, and the precomputed loss of the
    written-back model against the NGD loss on the same draws. Kernel 3
    runs in the precompute. Returns (launches, the NGD state, its step, the
    projection) for the later phases."""
    import torch
    from gpzoo_tpu_torch import (SlideseqNSFConfig, make_batched_train_step,
                                 make_scan_runner, nsf_negative_elbo_precomputed,
                                 precompute_nsf_projection, run_steps)
    from gpzoo_tpu_torch.bijectors import lower_cholesky
    from gpzoo_tpu_torch.data import held_out_deviance
    from gpzoo_tpu_torch.train.ngd import (HeadAdam, _ngd_loss_and_grads,
                                           make_ngd_train_step, ngd_create, ngd_to_model)

    log(f"[ngd] natural-gradient VI, north-star NSF N={MAIN['N']} D={MAIN['D']} "
        f"L={MAIN['L']} M={MAIN['M']} batch={MAIN['B']}, nat_lr {NGD['nat_lr']}, ramp "
        f"{NGD['ramp']}, max_f {NGD['max_f']}")
    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"])
    n, b = cfg.N, cfg.batch_size
    n_train = n - HOLDOUT
    x, y = nsf_data(dev)
    vidx = torch.arange(n_train, n, device=dev)
    counters = _launch_counters(("rbf_gram", "tri_sq_colsum", "tri_t_matmul"))
    _zero(counters)
    spies = contextlib.ExitStack()
    spies.enter_context(launch_shapes(seen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = cfg.build(gen, x)
    mu0 = model.prior.mu.detach().clone()
    proj = precompute_nsf_projection(model, x)
    state, opt = ngd_create(model, HeadAdam(cfg.lr), gen)
    torch.cuda.synchronize()
    log(f"  build + precompute + ngd_create: {time.perf_counter() - t0:.2f}s")

    log("  (a) one step from the init, float32 against float64")
    idx, eps = _step_batch(dev, cfg)
    ngd_step_vs_float64(checks, state, proj, y, idx, eps, cfg.lr)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    log(f"  (b) {NGD['steps']} steps in chunks of {NGD['chunk']}")
    step = make_ngd_train_step(opt, n_train, b, NGD["nat_lr"], NGD["ramp"], E=cfg.E,
                               loss_kwargs={"y_transposed": True}, max_f=NGD["max_f"])
    runner = make_scan_runner(step, NGD["chunk"])
    t0 = time.perf_counter()
    state, first = runner(state, proj, y)
    log(f"  first chunk (warm-up): {time.perf_counter() - t0:.2f}s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = [first] + [runner(state, proj, y)[1]
                        for _ in range(NGD["steps"] // NGD["chunk"] - 1)]
    torch.cuda.synchronize()
    timed = NGD["steps"] - NGD["chunk"]
    dt = time.perf_counter() - t0
    losses = torch.cat(chunks)
    dev_ngd = float(held_out_deviance(state.model, proj, y, vidx))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = _read(counters)
    rejected, skipped = int(step.rejected), int((~torch.isfinite(losses)).sum())
    log(f"  losses: {[f'{v:.6e}' for v in losses.tolist()]}")
    log(f"  ms/step: {dt / timed * 1e3:.2f} (host clock over {timed} steps); "
        f"{timed / dt:.4f} steps/s")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  rejected factors (PD or max_f guard): {rejected}; skipped steps: {skipped}")
    log(f"  launches (build, precompute, {NGD['steps']} steps, deviance): {launches}")
    checks.true("ngd losses finite", bool(torch.isfinite(losses).all()))
    checks.true("ngd skipped no step", skipped == 0)
    checks.true(f"rbf_gram launched on the ngd path ({launches['rbf_gram']})",
                launches["rbf_gram"] > 0)

    # the Adam step from the same init (the same generator seed) and data
    _zero(counters)
    gen_a = torch.Generator(device=dev).manual_seed(0)
    adam = cfg.build(gen_a, x)
    checks.true("ngd and Adam arms start from the same Z and μ",
                torch.equal(adam.prior.Z, state.model.prior.Z)
                and torch.equal(adam.prior.mu, mu0))
    adam_step = make_batched_train_step(nsf_negative_elbo_precomputed, cfg.optimizer(adam),
                                        n_train, b, cfg.L, gen_a, E=cfg.E,
                                        loss_kwargs={"y_transposed": True})
    adam_losses = run_steps(adam_step, adam, (proj, y), NGD["steps"])
    dev_adam = float(held_out_deviance(adam, proj, y, vidx))
    adam_launches = _read(counters)
    spies.close()
    log(f"  held-out Poisson deviance after {NGD['steps']} steps (holdout {HOLDOUT}): "
        f"NGD {dev_ngd:.6f}, Adam {dev_adam:.6f}; Adam launches {adam_launches}")
    checks.true("ngd Adam arm losses finite", bool(torch.isfinite(adam_losses).all()))
    checks.true(f"ngd held-out deviance below Adam's at {NGD['steps']} steps",
                dev_ngd < dev_adam)
    for name in ("tri_sq_colsum", "tri_t_matmul"):
        checks.true(f"{name} launched on the ngd leg's Adam arm ({adam_launches[name]})",
                    adam_launches[name] > 0)
    del adam, adam_step
    torch.cuda.empty_cache()
    profile_window(lambda: step(state, proj, y), NGD_PROFILED_STEPS)

    log("  (c) ngd_to_model")
    loss_ngd = _ngd_loss_and_grads(state, proj, y, idx, eps, y_transposed=True)[0]
    model = ngd_to_model(state)
    with torch.no_grad():
        lu = lower_cholesky(model.prior.Lu_raw)
        s = lu @ lu.mT
        eye = torch.eye(cfg.M, device=dev)
        resid = torch.linalg.matrix_norm(s @ state.prec - eye) / (
            torch.linalg.matrix_norm(s) * torch.linalg.matrix_norm(state.prec))
        worst = float((s @ state.prec - eye).abs().max())
        loss_adam = nsf_negative_elbo_precomputed(model, proj, y, idx, eps, y_transposed=True)
    del lu, s, eye
    log(f"  S·P − I: max |entry| {worst:.3e}; ‖S·P − I‖_F / (‖S‖_F‖P‖_F) up to "
        f"{float(resid.max()):.3e}")
    checks.le("ngd_to_model ‖S·P − I‖_F / (‖S‖_F‖P‖_F), the worst factor",
              float(resid.max()), TOL_NGD_INVERSE)
    err = float(abs(loss_adam - loss_ngd) / abs(loss_ngd))
    log(f"  NGD loss {float(loss_ngd):.8e}, precomputed loss of the written-back model "
        f"{float(loss_adam):.8e}")
    checks.le("ngd_to_model: precomputed loss against the NGD loss (relative)", err,
              TOL_STEP_LOSS)
    torch.cuda.empty_cache()
    for name, count in adam_launches.items():
        launches[name] += count
    return launches, state, step, proj


def phase_snapshot(checks, dev, seen, state, step, proj):
    """A PosteriorSnapshotter on the held-out 2,000 spots over three chunks
    of 5 more [ngd] steps (its records: the posterior mean's and scale's
    percentiles), then ``extract_factors`` there (after ``ngd_to_model``)
    and its Moran ranking. Kernel 3 runs in each posterior (Kzz and Kzx,
    every factor)."""
    import torch
    from gpzoo_tpu_torch import PosteriorSnapshotter, extract_factors, make_scan_runner
    from gpzoo_tpu_torch.train.ngd import ngd_to_model
    from gpzoo_tpu_torch.utils import MetricLogger

    x, y = nsf_data(dev)
    probe = x[MAIN["N"] - HOLDOUT:]
    log(f"[snapshot] posterior snapshots at the {HOLDOUT} held-out spots over "
        f"{SNAPSHOT['chunks']} chunks of {SNAPSHOT['chunk']} NGD steps; extract_factors")
    counters = _launch_counters(("rbf_gram",))
    _zero(counters)
    spies = contextlib.ExitStack()
    spies.enter_context(launch_shapes(seen))
    logger = MetricLogger()
    snap = PosteriorSnapshotter(probe, logger=logger)
    runner = make_scan_runner(step, SNAPSHOT["chunk"], on_chunk=snap)
    start = state.step
    t0 = time.perf_counter()
    for _ in range(SNAPSHOT["chunks"]):
        state, losses = runner(state, proj, y)
    log(f"  {SNAPSHOT['chunks']} chunks with their snapshots: {time.perf_counter() - t0:.2f}s")
    for rec in snap.records:
        log("  " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                             for k, v in rec.items()))
    checks.true("snapshot steps", [r["step"] for r in snap.records]
                == [start + SNAPSHOT["chunk"] * (i + 1) for i in range(SNAPSHOT["chunks"])])
    checks.true("snapshot records finite",
                all(math.isfinite(v) for r in snap.records for v in r.values()))
    checks.true("snapshot frames (L, probe)",
                all(f.shape == (MAIN["L"], HOLDOUT) and np.isfinite(f).all()
                    for _, f in snap.history))
    checks.true("snapshot logger got every record", len(logger.history) == SNAPSHOT["chunks"])
    ngd_to_model(state)
    t0 = time.perf_counter()
    factors, order, moran = extract_factors(state.model, probe)
    log(f"  extract_factors at {HOLDOUT} spots: {time.perf_counter() - t0:.2f}s (posterior "
        f"on the card, Moran's I on the host); order {order.tolist()}, Moran's I "
        f"{[round(float(v), 4) for v in moran]}")
    launches = _read(counters)
    spies.close()
    log(f"  launches: {launches}; by shape: { {k: dict(v) for k, v in seen.items()} }")
    checks.true("extract_factors factors finite, (L, spots)",
                factors.shape == (MAIN["L"], HOLDOUT) and bool(np.isfinite(factors).all()))
    checks.true("extract_factors ranking is a permutation, Moran's I descending",
                sorted(order.tolist()) == list(range(MAIN["L"]))
                and bool(np.all(np.diff(moran) <= 0)))
    checks.true(f"rbf_gram launched on the snapshot path ({launches['rbf_gram']})",
                launches["rbf_gram"] > 0)
    return launches


def _state_tensors(state):
    """{path: a copy} of every tensor of a state's state dict, and its
    other entries as they are."""
    import torch

    out = {}

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            out[path] = tree.detach().clone()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        else:
            out[path] = tree

    walk(state.state_dict(), "")
    return out


def _resume_case(checks, tag, base, state, make_step, args):
    """Through ``make_scan_runner`` and ``CheckpointHook(every=1, keep=2)``:
    CHECKPOINT["chunks"] chunks of CHECKPOINT["chunk"] steps, each saved
    asynchronously, then CHECKPOINT["more"] more steps while the last write
    drains; ``.latest`` restored into ``make_restore_template(state)`` runs
    the same steps. The losses and every tensor of the state must be
    bit-identical, the files rotated to the newest two and ``.latest``, no
    ``.tmp`` left. ``make_step(state)`` builds the step over a state."""
    import torch
    from gpzoo_tpu_torch import (CheckpointHook, make_restore_template, make_scan_runner,
                                 restore_checkpoint)

    hook = CheckpointHook(os.path.join(base, tag), every=1, keep=2)
    joins, stalls, writes = [], [], []

    def timed_hook(s, losses):
        # the hook first joins the write in flight (timed apart), then the
        # stall: the step stream's time for the device copy
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        hook.wait()
        joins.append(time.perf_counter() - t0)
        writes.append(hook.write_seconds)  # the previous save's
        t0 = time.perf_counter()
        hook(s, losses)
        torch.cuda.current_stream().synchronize()
        stalls.append(time.perf_counter() - t0)

    runner = make_scan_runner(make_step(state), CHECKPOINT["chunk"], on_chunk=timed_hook)
    for _ in range(CHECKPOINT["chunks"]):
        state, _ = runner(state, *args)
    saved = state.step
    _, live = make_scan_runner(make_step(state), CHECKPOINT["more"])(state, *args)
    hook.wait()
    writes.append(hook.write_seconds)
    expect = _state_tensors(state)
    files = sorted(f for f in os.listdir(base) if f.startswith(tag + "."))
    size = os.path.getsize(hook.latest_path)
    template = make_restore_template(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = restore_checkpoint(hook.latest_path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    checks.true(f"{tag} restored at step {saved} ({restored.step})", restored.step == saved)
    _, resumed = make_scan_runner(make_step(restored), CHECKPOINT["more"])(restored, *args)
    got = _state_tensors(restored)
    differ = [k for k in expect if not (torch.equal(got[k], expect[k])
                                        if isinstance(expect[k], torch.Tensor)
                                        else got[k] == expect[k])]
    log(f"  {tag}: stall per save {[round(v, 4) for v in stalls]} s (after joining the "
        f"write in flight: {[round(v, 3) for v in joins]} s); write "
        f"{[round(v, 3) for v in writes[1:]]} s; file {size / 1e9:.3f} GB; restore "
        f"{restore_s:.3f} s; files {files}")
    log(f"  {tag}: losses after the save {live.tolist()}, resumed {resumed.tolist()}")
    checks.true(f"{tag} resumed losses bit-identical", torch.equal(live, resumed))
    checks.true(f"{tag} resumed state bit-identical ({len(expect)} entries; differ: "
                f"{differ[:5]})", not differ and got.keys() == expect.keys())
    steps = [CHECKPOINT["chunk"] * (i + 1) + saved - CHECKPOINT["chunk"] * CHECKPOINT["chunks"]
             for i in range(CHECKPOINT["chunks"])]
    checks.true(f"{tag} checkpoint files rotated to keep=2",
                files == sorted([f"{tag}.latest"] + [f"{tag}.step{s}" for s in steps[-2:]]))
    del expect, got, template, restored


def phase_checkpoint(checks, dev, ngd_state, ngd_step, proj):
    """Bit-identical resume at full width (:func:`_resume_case`): the
    north-star Adam step (kernels 1-2), then the NGD state, in a temporary
    directory that the phase removes."""
    import tempfile

    import torch
    from gpzoo_tpu_torch import (SlideseqNSFConfig, TrainState, make_batched_train_step,
                                 nsf_negative_elbo_precomputed)

    log(f"[checkpoint] CheckpointHook(every=1, keep=2) over {CHECKPOINT['chunks']} chunks of "
        f"{CHECKPOINT['chunk']} steps, {CHECKPOINT['more']} more, restore .latest, resume")
    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"])
    x, y = nsf_data(dev)
    counters = _launch_counters(("tri_sq_colsum", "tri_t_matmul"))
    _zero(counters)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x)  # Z as [ngd]'s: its projection serves
    state = TrainState(model, cfg.optimizer(model), gen)

    def adam_step(s):
        return make_batched_train_step(nsf_negative_elbo_precomputed, s.optimizer,
                                       cfg.N - HOLDOUT, cfg.batch_size, cfg.L, s.generator,
                                       E=cfg.E, loss_kwargs={"y_transposed": True})

    with tempfile.TemporaryDirectory(prefix="gpzoo_ckpt_") as base:
        _resume_case(checks, "adam", base, state, adam_step, (proj, y))
    launches = _read(counters)
    del state, model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="gpzoo_ckpt_") as base:
        _resume_case(checks, "ngd", base, ngd_state, lambda s: ngd_step, (proj, y))
    log(f"  launches: {launches}")
    for name, count in launches.items():
        checks.true(f"{name} launched on the checkpoint path ({count})", count > 0)
    torch.cuda.empty_cache()
    return launches


def _small_step(checks, dev, label, make, args, loss):
    """``loss(model, *args)`` and the gradient of every leaf it reaches, for
    ``make(device, dtype)`` on the card in float32 and on the CPU in float64
    with the same parameters and inputs (``args``: numpy arrays, the float
    ones cast to the dtype), held against each other at TOL_SMALL."""
    import torch

    out = {}
    for where, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        model = make(where, dtype)
        targs = [torch.as_tensor(a, device=where) for a in args]
        targs = [a.to(dtype) if a.is_floating_point() else a for a in targs]
        value = loss(model, *targs)
        value.backward()
        out[str(where)] = (value.detach().double().cpu(),
                           {name: p.grad.double().cpu()
                            for name, p in model.named_parameters()
                            if p.grad is not None})
    (l64, g64), (l32, g32) = out["cpu"], out[str(dev)]
    checks.le(f"{label} loss (relative)", float(abs(l32 - l64) / abs(l64)), TOL_SMALL)
    checks.true(f"{label}: the same leaves reached", set(g32) == set(g64))
    for key in g64:
        checks.le(f"{label} d{key}", norm_err(g32[key], g64[key]), TOL_SMALL)


def _precomputed_small(model, x, y, idx, *draws, **kw):
    """The precomputed loss of ``model`` with its projection built from x."""
    from gpzoo_tpu_torch import nsf_negative_elbo_precomputed, precompute_nsf_projection

    proj = precompute_nsf_projection(model, x)
    names = ("eps", "eps2")[:len(draws)]
    return nsf_negative_elbo_precomputed(model, proj, y, idx, y_transposed=True,
                                         **dict(zip(names, draws)), **kw)


def phase_small_reference(checks, dev):
    """Small inputs of the north-star, NB and rank-64 configurations through
    the card's float32 kernels and through the float64 plain CPU path, with
    the same parameters, idx and eps."""
    import torch
    from gpzoo_tpu_torch import SlideseqNSFConfig
    from gpzoo_tpu_torch.convert import (lowrank_nsf_from_numpy, nsf_from_numpy,
                                         to_numpy)

    n, d, l_dim, m, b = 2000, 200, 4, 300, 500
    rng = np.random.default_rng(3)
    coords = rng.uniform(-2, 2, size=(n, 2))
    counts = rng.poisson(3.0, size=(n, d)).astype(np.float64)
    idx = rng.choice(n, size=b, replace=False)
    eps = rng.standard_normal((1, l_dim, b))
    for tag, kw in (("small", {}), ("small nb", {"likelihood": "nb"}),
                    ("small lowrank", {"rank": LOWRANK_RANK})):
        cfg = SlideseqNSFConfig(N=n, D=d, L=l_dim, M=m, batch_size=b, **kw)
        params = to_numpy(cfg.build(torch.Generator().manual_seed(0),
                                    torch.from_numpy(coords)))
        if "prior.Lu_raw" in params:
            params["prior.Lu_raw"] = np.tril(0.05 * rng.standard_normal((l_dim, m, m)))
        else:
            params["prior.V"] = 0.1 * rng.standard_normal(params["prior.V"].shape)
        log(f"[{tag}] float32 card vs float64 CPU, N={n} D={d} L={l_dim} M={m} "
            f"B={b}{', rank ' + str(LOWRANK_RANK) if 'rank' in kw else ''}")
        from_numpy = lowrank_nsf_from_numpy if "rank" in kw else nsf_from_numpy
        _small_step(checks, dev, tag,
                    functools.partial(from_numpy, params, jitter=cfg.jitter),
                    (coords, counts, idx, eps), _precomputed_small)


def phase_blockwise_small(checks, dev):
    """The blockwise loss's branches at small shapes (two chunks), float32
    on the card against float64 on the CPU with the same parameters, idx
    and draws: the shared-kernel collapse with the shared-Cholesky K⁻¹ (the
    fast leg's branch, with its trainables: Z and the kernel frozen), the
    same in the stable two-sided form, the whitened factored branch, the
    non-factored solves and HybridNSF over an MGGP SVGP (the Hybrid-MGGP
    leg's W-form, with its trainables: the kernel and embedding frozen).
    Each case's launches of kernels 1, 3 and 4 are printed."""
    import torch
    from gpzoo_tpu_torch import (SlideseqHybridMGGPConfig, SlideseqNSFConfig, freeze_,
                                 nsf_negative_elbo_batched)
    from gpzoo_tpu_torch.convert import (hybrid_from_numpy, nsf_from_numpy, to_numpy,
                                         wsvgp_nsf_from_numpy)

    n, d, l_dim, m, b, t_mf, n_groups = 2000, 100, 4, 200, 500, 3, 4
    rng = np.random.default_rng(8)
    coords = rng.uniform(-2, 2, size=(n, 2))
    counts = rng.poisson(3.0, size=(n, d)).astype(np.float64)
    groups = rng.integers(0, n_groups, size=n)
    idx = rng.choice(n, size=b, replace=False)
    eps = rng.standard_normal((2, l_dim, b))
    eps2 = rng.standard_normal((2, t_mf, b))
    head = {"W_raw": rng.uniform(0, 1, (d, l_dim)), "V_raw": rng.normal(1, 0.2, n)}
    nsf = {**_small_gp_params(rng, "prior.", "svgp", l_dim, m, 0), **head}
    wsvgp = {**_small_gp_params(rng, "prior.", "wsvgp", l_dim, m, 0), **head}
    cfg = SlideseqHybridMGGPConfig(D=d, N=n, L=l_dim, T=t_mf, M_per_group=m // n_groups,
                                   n_groups=n_groups, jitter=1e-1)
    hp = to_numpy(cfg.build(torch.Generator().manual_seed(0), torch.from_numpy(coords),
                            torch.from_numpy(groups)))
    hp["sf.prior.mu"] = 0.5 * rng.standard_normal((l_dim, m))
    hp["sf.prior.Lu_raw"] = np.tril(0.05 * rng.standard_normal((l_dim, m, m)))
    hp["cf.prior.mean"] = 0.3 * rng.standard_normal((t_mf, n))

    def loss(**kw):
        return lambda model, x, y, i, *rest: nsf_negative_elbo_batched(
            model, x, y, i, *rest[:2], E=2, microbatch=b // 2, y_transposed=True,
            **({"groups": rest[2]} if len(rest) > 2 else {}), **kw)

    def fast_leg_model(where, dtype):
        """The fast leg's trainables: Z and the kernel frozen."""
        return freeze_(nsf_from_numpy(nsf, where, dtype),
                       SlideseqNSFConfig.trainable.__get__(SlideseqNSFConfig()))

    cases = [
        ("blockwise collapse, shared-Cholesky K⁻¹", fast_leg_model,
         (coords, counts, idx, eps), loss(factored=True, shared_kernel=True)),
        ("blockwise collapse, stable form", fast_leg_model, (coords, counts, idx, eps),
         loss(factored=True, shared_kernel=True, stable_projection=True)),
        ("blockwise whitened factored", functools.partial(wsvgp_nsf_from_numpy, wsvgp),
         (coords, counts, idx, eps), loss(factored=True)),
        ("blockwise not factored", functools.partial(nsf_from_numpy, nsf),
         (coords, counts, idx, eps), loss(factored=False)),
        ("blockwise HybridNSF over MGGPSVGP",
         lambda where, dtype: freeze_(hybrid_from_numpy(
             hp, where, dtype, prior="mggp", jitter=cfg.jitter, var_floor=5e-2),
             cfg.trainable),
         (coords, counts, idx, eps, eps2, groups), loss(factored=True)),
    ]
    counters = _launch_counters(("tri_sq_colsum", "rbf_gram", "mggp_gram"))
    log(f"[blockwise_small] float32 card vs float64 CPU, N={n} D={d} L={l_dim} M={m} "
        f"B={b} in two chunks, E=2, T={t_mf}, {n_groups} groups")
    for label, make, args, fn in cases:
        _zero(counters)
        _small_step(checks, dev, label, make, args, fn)
        log(f"  {label}: launches {_read(counters)}")


def _small_gp_params(rng, prefix, kind, l_dim, m, rank):
    """Leaves of a spatial prior of ``kind`` with a non-trivial q(u), under
    ``prefix``: per-factor mu and Lu (or V and d_raw), Z in U(−2, 2)²."""
    p = {prefix + "kernel.sigma": np.ones((l_dim, 1, 1)),
         prefix + "kernel.lengthscale": np.ones((l_dim, 1, 1)),
         prefix + "Z": rng.uniform(-2, 2, (m, 2)),
         prefix + "mu": 0.5 * rng.standard_normal((l_dim, m))}
    if kind == "lowrank":
        p[prefix + "V"] = 0.1 * rng.standard_normal((l_dim, m, rank))
        p[prefix + "d_raw"] = rng.normal(0.0, 0.3, (l_dim, m))
    else:
        p[prefix + "Lu_raw"] = np.tril(0.05 * rng.standard_normal((l_dim, m, m)))
    return p


def phase_heads_small(checks, dev):
    """The other heads at small shapes on the card in float32 against the
    float64 CPU path: the whitened WSVGP loss, the normalized Poisson
    log-likelihood, HybridNSF over SVGP, WSVGP and LowRankWSVGP,
    HybridNSFExact (whitened and not), NBNSF over a VNNGP (both tiers),
    and precompute_nsf_projection(block=) against the unblocked one. Each
    case's launches of kernels 1, 3 and 5 are printed."""
    import torch
    from gpzoo_tpu_torch import (VNNGPConfig, precompute_nsf_projection,
                                 precompute_vnngp_conditioning,
                                 vnngp_nsf_negative_elbo_batched,
                                 vnngp_nsf_negative_elbo_precomputed)
    from gpzoo_tpu_torch.bijectors import init_softplus
    from gpzoo_tpu_torch.convert import (hybrid_from_numpy, nsf_from_numpy,
                                         to_numpy, vnngp_from_numpy,
                                         wsvgp_nsf_from_numpy)

    n, d, l_dim, m, b, t_mf, rank = 2000, 100, 4, 200, 500, 3, 16
    rng = np.random.default_rng(6)
    coords = rng.uniform(-2, 2, size=(n, 2))
    counts = rng.poisson(3.0, size=(n, d)).astype(np.float64)
    idx = rng.choice(n, size=b, replace=False)
    eps = rng.standard_normal((2, l_dim, b))
    eps2 = rng.standard_normal((2, t_mf, b))
    head = {"W_raw": rng.uniform(0, 1, (d, l_dim)), "V_raw": rng.normal(1, 0.2, n)}
    mf = {"sf.W_raw": head["W_raw"], "V_raw": head["V_raw"],
          "cf.prior.mean": 0.3 * rng.standard_normal((t_mf, n)),
          "cf.prior.scale_raw": rng.uniform(-1, 0.5, (t_mf, n)),
          "cf.W_raw": rng.uniform(0, 1, (d, t_mf))}
    counters = _launch_counters(("tri_sq_colsum", "rbf_gram", "block_conditional"))
    log(f"[heads_small] float32 card vs float64 CPU, N={n} D={d} L={l_dim} M={m} "
        f"B={b}, E=2, T={t_mf}, rank {rank}")
    cases = []
    nsf = {**_small_gp_params(rng, "prior.", "svgp", l_dim, m, rank), **head}
    wsvgp = {**_small_gp_params(rng, "prior.", "wsvgp", l_dim, m, rank), **head}
    cases.append(("whitened WSVGP", functools.partial(wsvgp_nsf_from_numpy, wsvgp),
                  (coords, counts, idx, eps), _precomputed_small))
    cases.append(("normalized Poisson", functools.partial(nsf_from_numpy, nsf),
                  (coords, counts, idx, eps),
                  functools.partial(_precomputed_small, unnormalized=False)))
    for kind in ("svgp", "wsvgp", "lowrank"):
        hp = {**_small_gp_params(rng, "sf.prior.", kind, l_dim, m, rank), **mf}
        hybrid = functools.partial(hybrid_from_numpy, hp, prior=kind, scale_pf=0.7)
        cases.append((f"HybridNSF over {kind}", hybrid,
                      (coords, counts, idx, eps, eps2), _precomputed_small))
        if kind != "lowrank":
            cases.append((f"HybridNSFExact over {kind}",
                          functools.partial(hybrid, exact=True),
                          (coords, counts, idx), _precomputed_small))
    vcfg = VNNGPConfig(N=n, D=d, L=l_dim, M=m, K=8)
    vp = to_numpy(vcfg.build(torch.Generator().manual_seed(0), torch.from_numpy(coords)))
    vp["prior.mu"] = 0.3 * rng.standard_normal(m)
    vp["prior.Lu_raw"] = np.tril(0.05 * rng.standard_normal((m, m)))
    vp["r_raw"] = init_softplus(rng.uniform(2, 20, d))
    nb_vnngp = functools.partial(vnngp_from_numpy, vp, K=vcfg.K, jitter=vcfg.jitter)
    cases.append(("NBNSF over VNNGP, all-trainable", nb_vnngp,
                  (coords, counts, idx, eps[:1]),
                  lambda model, x, y, i, e: vnngp_nsf_negative_elbo_batched(
                      model, x, y, i, e, shared_kernel=True, y_transposed=True)))
    cases.append(("NBNSF over VNNGP, frozen tier", nb_vnngp,
                  (coords, counts, idx, eps[:1]),
                  lambda model, x, y, i, e: vnngp_nsf_negative_elbo_precomputed(
                      model, precompute_vnngp_conditioning(model, x), y, i, e,
                      y_transposed=True)))
    for label, make, args, loss in cases:
        _zero(counters)
        _small_step(checks, dev, label, make, args, loss)
        log(f"  {label}: launches {_read(counters)}")

    # the projection solved in blocks of 333 spots against all at once
    x = torch.tensor(coords, dtype=torch.float32, device=dev)
    for label, params, make in (("svgp", nsf, nsf_from_numpy),
                                ("wsvgp", wsvgp, wsvgp_nsf_from_numpy)):
        model = make(params, dev, torch.float32)
        whole = precompute_nsf_projection(model, x)
        part = precompute_nsf_projection(model, x, block=333)
        for field in ("proj_t", "a2"):
            checks.le(f"{label} precompute {field}, block=333 vs unblocked",
                      norm_err(getattr(part, field), getattr(whole, field)), TOL_BLOCKED)


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


def phase_vnngp(checks, dev, vnngp, seen):
    """bench.py's VNNGP leg (run_vnngp_bench) on the port, at full width.
    Kernel launches by shape go into seen["a"], seen["b"], seen["c"]."""
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
    spies = contextlib.ExitStack()
    spies.enter_context(launch_shapes(seen.setdefault("a", {})))
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
    spies.close()
    frozen_losses = torch.cat([warm, timed])
    log(f"  (a) frozen tier: precompute {pre_s:.3f}s; {VNNGP_TIMED / dt:.3f} steps/s "
        f"({dt / VNNGP_TIMED * 1e3:.3f} ms/step, host clock over {VNNGP_TIMED} steps)")
    log(f"      loss mean, first {VNNGP_WARMUP}: {float(warm.mean()):.6e}; "
        f"last {VNNGP_WARMUP}: {float(timed[-VNNGP_WARMUP:].mean()):.6e}")
    ok &= bool(torch.isfinite(frozen_losses).all())
    del frozen, cond, step

    # (b) every leaf trains: Z, σ, ℓ, mu, Lu, W, V
    _zero(counters)
    spies.enter_context(launch_shapes(seen.setdefault("b", {})))
    all_kw = {"shared_kernel": True, **kw}
    step = make_batched_train_step(vnngp_nsf_negative_elbo_batched,
                                   cfg.optimizer(model), n_train, b, cfg.L, gen,
                                   E=cfg.E, loss_kwargs=all_kw)
    warm, _ = _timed_steps(step, model, (x, y), VNNGP_WARMUP)
    timed, dt = _timed_steps(step, model, (x, y), VNNGP_TIMED)
    launches["b"] = _read(counters)
    spies.close()
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
    with torch.no_grad(), launch_shapes(seen.setdefault("c", {})):
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
    for part in "abc":
        log(f"  launches by shape, ({part}): "
            f"{ {k: dict(v) for k, v in seen[part].items()} }")
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
    return _blockwise_loss_grad(model, x, y, idx, eps, microbatch=microbatch,
                                factored=True, y_transposed=True, groups=groups,
                                remat=False)


def plain_mggp_kernels(gram=None):
    """Kernels 1 and 4 swapped for their plain versions on the MGGP path
    (kernel 4 for ``gram`` if given; kernel 2 runs only inside kernel 1's
    backward)."""
    from gpzoo_tpu_torch.ops import mggp_cuda, tri_blocked
    from gpzoo_tpu_torch.train import fast

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(mggp_cuda, "mggp_gram",
                                          gram or mggp_cuda.mggp_gram_plain))
    stack.enter_context(mock.patch.object(fast, "tri_sq_colsum",
                                          tri_blocked.tri_sq_colsum))
    return stack


@functools.lru_cache(maxsize=1)
def mggp_data(dev, n, d, n_groups):
    """The data of bench.py's MGGP and Slideseq Hybrid-MGGP legs, on the
    device: coords U(−2, 2) (n, 2), counts Poisson(3) stored spot-major
    (n, d) and group labels uniform over n_groups, numpy seed 0."""
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    counts_t = rng.poisson(3.0, size=(n, d)).astype(np.float32)
    groups = rng.integers(0, n_groups, size=n)
    out = (torch.from_numpy(coords).to(dev), torch.from_numpy(counts_t).to(dev),
           torch.from_numpy(groups).to(dev))
    log(f"  synthetic data: {time.perf_counter() - t0:.1f}s")
    return out


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
    x, y, g = mggp_data(dev, n, d, cfg.n_groups)

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
    # both are also held against the same step in float64 (plain versions).
    # Most variance entries sit at the 5e-2 floor, and one that the steps'
    # rounding puts on either side of it moves dLu by ~7.5e-3 of its
    # maximum: the other steps take the kernels' step's floor decisions,
    # within MAX_FLIPS (steps_vs_plain).
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    del step
    torch.cuda.empty_cache()
    steps_vs_plain(checks, "mggp", tuple(counters), plain_mggp_kernels,
                   lambda r: _mggp_loss_grad(model, x, y, idx, eps, g, b),
                   lambda r: _mggp_loss_grad(copy.deepcopy(model).double(), x.double(),
                                             y.double(), idx, eps.double(), g, b))
    del model, x, y
    torch.cuda.empty_cache()
    return {name: launches[name] + post_launches[name] for name in counters}


def plain_rbf_kernels(gram=None):
    """Kernels 1 and 3 swapped for their plain versions on the blockwise
    path (kernel 3's backward then comes from autograd through the plain
    form, or through ``gram`` if given; kernel 2 runs only inside kernel
    1's backward)."""
    from gpzoo_tpu_torch.ops import gram_cuda, tri_blocked
    from gpzoo_tpu_torch.train import fast

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(gram_cuda, "rbf_gram",
                                          gram or gram_cuda.rbf_gram_plain))
    stack.enter_context(mock.patch.object(fast, "tri_sq_colsum",
                                          tri_blocked.tri_sq_colsum))
    return stack


@contextlib.contextmanager
def clamp_decisions(masks):
    """While active, each call of the package's lower clamp ``clip_min(t,
    bound)`` in the priors and the losses either records its decision
    ``t >= bound`` into ``masks`` (a list, appended in call order) or, when
    ``masks`` already holds the decisions of a run of the same code, takes
    them: where(mask, t, bound), whose gradient reaches t where the mask
    holds, as the clamp's does above the bound. A loss's variance floor is the
    one discontinuity of its gradient; two steps that differ by rounding
    may put an entry lying at the floor on either side of it, and that one
    entry moves the gradients by far more than the rounding. Run under the
    first step's decisions, the steps differ by rounding alone. The entries
    a replaying run would have decided otherwise are counted into the
    yielded list's one item."""
    import torch
    from gpzoo_tpu_torch.gps import svgp, vnngp
    from gpzoo_tpu_torch.ops.clip import clip_min
    from gpzoo_tpu_torch.train import fast, fast_vnngp

    replay = iter(list(masks)) if masks else None
    flips = [0]

    def clamp(t, bound):
        mask = t >= bound
        if replay is None:
            masks.append(mask)
            return clip_min(t, bound)
        taken = next(replay)
        flips[0] += int((taken != mask).sum())
        return torch.where(taken, t, torch.full_like(t, bound))

    with contextlib.ExitStack() as stack:
        for module in (svgp, vnngp, fast, fast_vnngp):
            stack.enter_context(mock.patch.object(module, "clip_min", clamp))
        yield flips


def round_mantissa(t, bits):
    """``t`` (float32) rounded to nearest, ties to even, at ``bits``
    mantissa bits (TF32 keeps 10); the gradient passes through unchanged."""
    import torch

    drop = 23 - bits
    raw = t.detach().view(torch.int32)
    raw = (raw + (1 << (drop - 1)) - 1 + ((raw >> drop) & 1)) & -(1 << drop)
    return t + (raw.view(torch.float32) - t).detach()


def control_kernels(plain_kernels, bits):
    """The context ``plain_kernels()`` (:func:`plain_rbf_kernels`,
    :func:`plain_vnngp_kernels` or :func:`plain_mggp_kernels`) with each
    entry of its Gram's plain version rounded to ``bits`` mantissa bits
    (2^-(bits+1) relative): the control step of :func:`steps_vs_plain`."""
    from gpzoo_tpu_torch.ops import gram_cuda, mggp_cuda

    gram = (mggp_cuda.mggp_gram_plain if plain_kernels is plain_mggp_kernels
            else gram_cuda.rbf_gram_plain)
    return plain_kernels(lambda *args: round_mantissa(gram(*args), bits))


def steps_vs_plain(checks, tag, counter_names, plain, loss_grad, reference, *, repeats=1,
                   loss_vs="plain", plain2=None):
    """The step with the kernels against the same step with their plain
    versions (``plain()``, one of the plain_*_kernels contexts) and the same
    step in float64 (``reference``, run under ``plain()``), over ``repeats``
    sets of draws:
    ``loss_grad(r)`` and ``reference(r)`` give the r-th set's (loss, {leaf:
    gradient}). One step's rounding error through an ill-conditioned Kzz
    varies severalfold from draw to draw, so each error is the root mean
    square over the sets.

    Limits: every trained leaf's gradient must be within TOL_STEP_GRAD of
    float64 or no further from it than twice the plain step (float32
    rounding through Kzz⁻¹ is the plain step's as much as the kernels'). The
    loss is held against the plain step's at TOL_STEP_LOSS (``loss_vs`` =
    "plain") or, as the gradients, against float64 ("float64": an error in
    F through Kzz⁻¹ becomes a relative error of the exp-rate's loss, in the
    plain step too). With ``plain2``, a second plain form of the same
    functions, the plain step's error is the worse of the two forms':
    which float32 form lands nearer float64 is chance. The other steps
    take the kernels' step's variance-floor decisions
    (:func:`clamp_decisions`), and none may decide more than MAX_FLIPS
    entries otherwise in a set.

    A control step, ``plain()`` with its Gram's entries rounded to TF32's
    10 mantissa bits (:func:`control_kernels`), runs as the kernels' step
    and is judged by the same limits; it must fail at least one, or they
    cannot tell a Gram of that precision from the kernels'. Where Kzz so
    rounded cannot be factored, the control keeps more bits
    (CONTROL_BITS), and its check names the bits it ran at.

    The kernels' step must launch each kernel of ``counter_names`` and the
    other steps none, or the comparison is with itself."""
    import torch

    counters = _launch_counters(counter_names)
    kernel_step, plain_step = collections.Counter(), collections.Counter()
    others = {what: context for what, context in (("plain", plain), ("plain2", plain2))
              if context}
    err = collections.defaultdict(list)  # (step, against, leaf or "loss"): one per set
    flips = collections.defaultdict(list)  # step: one count per set
    control_bits, raised = set(), {}
    for r in range(repeats):
        masks = []
        _zero(counters)
        with clamp_decisions(masks):
            out = {"kernels": loss_grad(r)}
        kernel_step.update(_read(counters))
        _zero(counters)
        for what, context in others.items():
            with context(), clamp_decisions(masks) as n:
                out[what] = loss_grad(r)
            flips[what].append(n[0])
        for bits in CONTROL_BITS:
            try:
                with control_kernels(plain, bits), clamp_decisions(masks) as n:
                    out["control"] = loss_grad(r)
            except torch.linalg.LinAlgError as exc:
                raised[bits] = str(exc).splitlines()[0]
                continue
            control_bits.add(bits)
            flips["control"].append(n[0])
            break
        with plain(), clamp_decisions(masks) as n:
            loss_r, grad_r = reference(r)
        flips["float64"].append(n[0])
        plain_step.update(_read(counters))
        loss_p, grad_p = out["plain"]
        checks.true(f"{tag} step: the same leaves reached", set(out["kernels"][1]) == set(grad_p))
        for what, (loss, grads) in out.items():
            err[what, "plain", "loss"].append(float(abs(loss - loss_p) / abs(loss_p)))
            err[what, "float64", "loss"].append(float(abs(loss - loss_r) / abs(loss_r)))
            for name in grad_r:
                err[what, "plain", name].append(norm_err(grads[name], grad_p[name]))
                err[what, "float64", name].append(norm_err(grads[name],
                                                           grad_r[name].float()))
        del out, grad_p, grad_r, masks
    for name in counters:
        checks.true(f"{tag}: {name} launched on the kernels' step ({kernel_step[name]})",
                    kernel_step[name] > 0)
        checks.true(f"{tag}: {name} not launched on the plain steps ({plain_step[name]})",
                    plain_step[name] == 0)

    def rms(key):
        return math.sqrt(sum(v * v for v in err[key]) / len(err[key]))

    def limit(leaf):
        """(what the leaf is held against, its limit)."""
        if leaf == "loss" and loss_vs == "plain":
            return "plain", TOL_STEP_LOSS
        floor = TOL_STEP_LOSS if leaf == "loss" else TOL_STEP_GRAD
        return "float64", max(floor, 2 * max(rms((w, "float64", leaf))
                                             for w in ("plain", "plain2") if w in others))

    over = "" if repeats == 1 else f" (root mean square over {repeats} sets of draws)"
    most = "" if repeats == 1 else f" (the most over {repeats} sets of draws)"
    log(f"  launches: kernels' step {dict(kernel_step)}, plain steps {dict(plain_step)}; "
        f"variance-floor decisions of the kernels' step that each step would take "
        f"otherwise{most}: " + ", ".join(f"{w} {max(v)}" for w, v in flips.items()))
    stepped = [w for w in ("kernels", *others, "control") if (w, "plain", "loss") in err]
    for bits, msg in raised.items():
        log(f"  {tag}: the control step at {bits} mantissa bits raised: {msg}")
    control_failed = [] if control_bits else [f"raised at {sorted(raised)} bits"]
    for leaf in [k[2] for k in err if k[:2] == ("kernels", "float64")]:
        against, tol = limit(leaf)
        what = "loss" if leaf == "loss" else f"d{leaf}"
        log(f"  {tag} step {what}: kernels vs plain {rms(('kernels', 'plain', leaf)):.3e}; "
            f"against float64: " + ", ".join(f"{w} {rms((w, 'float64', leaf)):.3e}"
                                              for w in stepped) + over)
        relative = " (relative)" if leaf == "loss" else ""
        checks.le(f"{tag} step {what}, kernels "
                  f"{'vs plain' if against == 'plain' else 'against float64'}{relative}",
                  rms(("kernels", against, leaf)), tol)
        if "control" in stepped and not rms(("control", against, leaf)) <= tol:
            control_failed.append(what)
    for w in ("plain", "plain2", "float64"):
        if flips[w]:
            checks.true(f"{tag}: the kernels' floor decisions the {w} step would take "
                        f"otherwise{most}: {max(flips[w])} (at most {MAX_FLIPS})",
                        max(flips[w]) <= MAX_FLIPS)
    if flips["control"] and max(flips["control"]) > MAX_FLIPS:
        control_failed.append(f"floor decisions ({max(flips['control'])})")
    checks.true(f"{tag}: the control step, its Gram rounded to {sorted(control_bits)} "
                f"mantissa bits, fails the limits ({', '.join(control_failed) or 'none'})",
                bool(control_failed))


def phase_hybrid(checks, dev, seen):
    """bench.py's ``--workload hybrid`` leg (HybridNSFConfig) at its published
    size: full-batch steps over the first 720 spots (one chunk), E = 1,000
    draws, cell 15's trainables (ℓ and Z train, so kernel 3's backward
    runs), data from ``data.sim.simulate_nsf_counts``. Besides the figures of
    every leg: one step with kernels 1 and 3 against the same step with
    their plain versions."""
    import torch
    from gpzoo_tpu_torch import (HybridNSFConfig, make_train_step,
                                 nsf_negative_elbo_batched)
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance, simulate_nsf_counts

    cfg = HybridNSFConfig(**HYBRID)
    l_dim, m, n_train, _ = hybrid_shape()
    log(f"[hybrid] Hybrid-NSF full-batch step, N={cfg.N} D={cfg.D} L={cfg.L} "
        f"T={cfg.T} M={cfg.M} E={cfg.E}, trained on {n_train} spots")
    coords, counts, _ = simulate_nsf_counts(N=cfg.N, D=cfg.D, L=cfg.L)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts).to(dev)  # (D, N)
    idx = torch.arange(n_train, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen)
    kw = dict(E=cfg.E, microbatch=n_train, factored=True)
    step = make_train_step(nsf_negative_elbo_batched, cfg.optimizer(model), n_train,
                           cfg.L, gen, E=cfg.E, loss_kwargs=kw)
    names = ("tri_sq_colsum", "tri_t_matmul", "rbf_gram")
    launches, post = train_leg(
        checks, "hybrid", step, model, (x, y, idx), names,
        lambda: hybrid_posterior_deviance(model, x, y.T,
                                          torch.arange(n_train, cfg.N, device=dev)),
        HYBRID_PROFILED_STEPS, seen)
    g2 = torch.Generator(device=dev).manual_seed(2)
    eps = torch.randn((cfg.E, cfg.L, n_train), generator=g2, device=dev)
    eps2 = torch.randn((cfg.E, cfg.T, n_train), generator=g2, device=dev)
    steps_vs_plain(checks, "hybrid", names, plain_rbf_kernels,
                   lambda r: _blockwise_loss_grad(model, x, y, idx, eps, eps2, **kw),
                   lambda r: _blockwise_loss_grad(copy.deepcopy(model).double(), x.double(),
                                                  y.double(), idx, eps.double(),
                                                  eps2.double(), **kw))
    del model, step
    torch.cuda.empty_cache()
    return {name: launches[name] + post[name] for name in launches}


def phase_hybrid_mggp(checks, dev):
    """bench.py's ``--workload slideseq-hybrid`` leg
    (SlideseqHybridMGGPConfig) at its published size: the W-form with the
    hybrid head over an MGGP SVGP, the kernel frozen, Z, μ, Lu, V and both
    halves' loadings and mean-field parameters trained (so kernel 4's
    backward runs for Z), jitter 1e-2. Besides the figures of every leg: one
    step with kernels 1 and 4 against the same step with their plain
    versions, and both against the same step in float64 (plain versions):
    at jitter 1e-2 the float32 gradients through Kzz⁻¹ carry κ(Kzz)-amplified
    rounding in the plain step as much as in the kernels' one."""
    import torch
    from gpzoo_tpu_torch import (SlideseqHybridMGGPConfig, make_batched_train_step,
                                 nsf_negative_elbo_batched)
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance

    h = HYBRID_MGGP
    cfg = SlideseqHybridMGGPConfig(D=h["D"], N=h["N"], L=h["L"], T=h["T"],
                                   M_per_group=h["M_per_group"], n_groups=h["G"],
                                   batch_size=h["B"])
    n, b = cfg.N, cfg.batch_size
    log(f"[hybrid_mggp] Slideseq Hybrid-MGGP step, N={n} D={cfg.D} L={cfg.L} "
        f"T={cfg.T} M={cfg.M} ({cfg.M_per_group} x {cfg.n_groups} groups) batch={b} "
        f"E={cfg.E} jitter={cfg.jitter}")
    x, y, g = mggp_data(dev, n, cfg.D, cfg.n_groups)
    n_train = n - HOLDOUT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x, g)
    kw = dict(E=cfg.E, microbatch=b, factored=True, y_transposed=True, groups=g,
              remat=False)
    step = make_batched_train_step(nsf_negative_elbo_batched, cfg.optimizer(model),
                                   n_train, b, cfg.L, gen, E=cfg.E, loss_kwargs=kw)
    names = ("mggp_gram", "tri_sq_colsum", "tri_t_matmul")
    launches, post = train_leg(
        checks, "hybrid_mggp", step, model, (x, y), names,
        lambda: hybrid_posterior_deviance(model, x, y, torch.arange(n_train, n, device=dev),
                                          g),
        MGGP_PROFILED_STEPS)
    del step
    torch.cuda.empty_cache()
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    eps2 = torch.randn((cfg.E, cfg.T, b), generator=g2, device=dev)

    def reference(r):
        model64 = copy.deepcopy(model).double()
        out = _blockwise_loss_grad(model64, x.double(), y.double(), idx, eps.double(),
                                   eps2.double(), **kw)
        del model64
        return out

    steps_vs_plain(checks, "hybrid_mggp", names, plain_mggp_kernels,
                   lambda r: _blockwise_loss_grad(model, x, y, idx, eps, eps2, **kw),
                   reference)
    del model
    torch.cuda.empty_cache()
    return {name: launches[name] + post[name] for name in launches}


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


def _elbo_loss_grad(model, loss_fn, args, kw):
    """``loss_fn(model, *args, **kw)`` and the gradient of every trained leaf."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, *args, **kw)
    loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _as64(value):
    """A floating tensor in float64; anything else as it is."""
    import torch

    if torch.is_tensor(value) and value.is_floating_point():
        return value.double()
    return value


def plain_vnngp_kernels(gram=None):
    """Kernels 3 and 5 swapped for their plain versions on the VNNGP path
    (kernel 3 for ``gram`` if given)."""
    stack = plain_rbf_kernels(gram)
    stack.enter_context(plain_block_conditional(True))
    return stack


def rbf_gram_direct(x, z, sigma, lengthscale):
    """A second plain form of kernel 3's function: d² summed from the
    coordinates' differences, as the kernel forms it, where the plain
    version expands ‖x‖² − 2x·z + ‖z‖²."""
    import torch

    d2 = torch.sum(torch.square(x[:, None, :] - z[None, :, :]), dim=-1)
    scale = -0.5 / torch.square(lengthscale)
    return torch.square(sigma)[:, None, None] * torch.exp(d2 * scale[:, None, None])


#: sets of draws the generic legs' float32 steps are held against float64 on
STEP_REPEATS = 4


def generic_leg(checks, tag, model, step, args, names, quality, quality_label,
                loss_fn, fixed, plain, seen=None, plain2=None):
    """One leg of the generic ELBO path. ``fixed(r)`` gives (args, kwargs)
    of ``loss_fn`` on a fixed batch with the r-th set of fixed draws. The
    loss on set 0 before and after the steps, which must fall;
    :func:`train_leg` (ms/step, quality, peak memory, the launches of
    ``names``, a profiled window); then the step with the kernels against
    the same step with their plain versions (``plain()``) and in float64
    (:func:`steps_vs_plain`, over STEP_REPEATS sets of draws, with the
    second plain form ``plain2()`` where given). A leg with no
    kernel (``plain`` None) holds its float32 step against float64 at
    TOL_STEP_LOSS and TOL_STEP_GRAD (root mean square over the sets).
    Returns the launches of the steps and the quality metric."""
    import torch

    def fixed_loss():
        f_args, f_kw = fixed(0)
        with torch.no_grad():
            return float(loss_fn(model, *f_args, **f_kw))

    before = fixed_loss()
    launches, post = train_leg(checks, tag, step, model, args, names, quality,
                               GENERIC_PROFILED_STEPS, seen, GENERIC_TIMED, quality_label)
    after = fixed_loss()
    checks.true(f"{tag} loss falls on a fixed batch and draws ({before:.6e} -> "
                f"{after:.6e} over {WARMUP_STEPS + GENERIC_TIMED} steps)", after < before)

    def reference(r):
        f_args, f_kw = fixed(r)
        model64 = copy.deepcopy(model).double()
        out = _elbo_loss_grad(model64, loss_fn, [_as64(a) for a in f_args],
                              {k: _as64(v) for k, v in f_kw.items()})
        del model64
        return out

    def step32(r):
        return _elbo_loss_grad(model, loss_fn, *fixed(r))

    if plain is not None:
        steps_vs_plain(checks, tag, names, plain, step32, reference, repeats=STEP_REPEATS,
                       loss_vs="float64", plain2=plain2)
    else:
        sq, loss_err = {}, 0.0
        for r in range(STEP_REPEATS):
            (loss, grads), (loss_r, grads_r) = step32(r), reference(r)
            loss_err = max(loss_err, float(abs(loss - loss_r) / abs(loss_r)))
            for name in grads_r:
                sq[name] = sq.get(name, 0.0) + norm_err(
                    grads[name], grads_r[name].float()) ** 2 / STEP_REPEATS
        checks.le(f"{tag} step loss against float64 (relative, the largest over "
                  f"{STEP_REPEATS} sets of draws)", loss_err, TOL_STEP_LOSS)
        for name, v in sq.items():
            checks.le(f"{tag} step d{name} against float64 (root mean square over "
                      f"{STEP_REPEATS} sets of draws)", math.sqrt(v), TOL_STEP_GRAD)
    return {name: launches[name] + post[name] for name in launches}


def _fixed_draws(dev, shapes):
    """``draws(r)``: the r-th set of standard-normal tensors of ``shapes``,
    from a generator seeded 2 + r on the device."""
    import torch

    def draws(r):
        g = torch.Generator(device=dev).manual_seed(2 + r)
        return [torch.randn(shape, generator=g, device=dev) for shape in shapes]

    return draws


def phase_nsf_sweep(checks, dev, seen):
    """benchmarks/nsf_sweep.py's NSF rows (run_nsf) at their published
    widths: NSFConfig D = 80, N = 800, L = 4, E = 20, Adam 5e-3, full batch
    through negative_elbo, every leaf trained (Z and the kernel: kernel 3
    forward and backward), for each M. Quality: the Poisson deviance of the
    plug-in posterior-mean rate over the 800 spots trained on."""
    import torch
    from gpzoo_tpu_torch import NSFConfig, make_train_step, negative_elbo
    from gpzoo_tpu_torch.data import posterior_deviance, simulate_nsf_counts

    coords, counts, _ = simulate_nsf_counts(N=SWEEP["N"], D=SWEEP["D"], L=SWEEP["L"])
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts).to(dev)  # (D, N)
    every = torch.arange(SWEEP["N"], device=dev)
    launches = collections.Counter()
    for m in SWEEP["M"]:
        cfg = NSFConfig(D=SWEEP["D"], N=SWEEP["N"], L=SWEEP["L"], M=m)
        log(f"[nsf_sweep] NSFConfig full batch, N={cfg.N} D={cfg.D} L={cfg.L} M={m} "
            f"E={cfg.E}, every leaf trained")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cfg.build(gen, x)
        step = make_train_step(negative_elbo, cfg.optimizer(model), cfg.N, cfg.L, gen,
                               E=cfg.E)
        draws = _fixed_draws(dev, [(cfg.E, cfg.L, cfg.N)])
        launches.update(generic_leg(
            checks, f"nsf_sweep M={m}", model, step, (x, y), ("rbf_gram",),
            lambda: posterior_deviance(model, x, y.T, every),
            "Poisson deviance over the spots trained on", negative_elbo,
            lambda r: ((x, y, *draws(r)), {}), plain_rbf_kernels, seen,
            lambda: plain_rbf_kernels(rbf_gram_direct)))
        del model, step
        torch.cuda.empty_cache()
    return dict(launches)


def phase_vnngp_sweep(checks, dev, seen):
    """benchmarks/nsf_sweep.py's --vnngp row (run_vnngp) at its published
    width: VNNGPConfig D = 200, N = 5,000, L = 10, M = 1,000, K = 8, E = 3,
    Adam 5e-3, full batch through negative_elbo, every leaf trained (kernel 3
    forward and backward, kernel 5 over L x N points), data simulated at 4
    factors. Quality: as [nsf_sweep]."""
    import torch
    from gpzoo_tpu_torch import VNNGPConfig, make_train_step, negative_elbo
    from gpzoo_tpu_torch.data import posterior_deviance, simulate_nsf_counts

    v = VNNGP_SWEEP
    cfg = VNNGPConfig(D=v["D"], N=v["N"], L=v["L"], M=v["M"], K=v["K"])
    log(f"[vnngp_sweep] NSF over VNNGP, full batch, N={cfg.N} D={cfg.D} L={cfg.L} "
        f"M={cfg.M} K={cfg.K} E={cfg.E}, every leaf trained")
    coords, counts, _ = simulate_nsf_counts(N=cfg.N, D=cfg.D, L=4)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x)
    step = make_train_step(negative_elbo, cfg.optimizer(model), cfg.N, cfg.L, gen, E=cfg.E)
    draws = _fixed_draws(dev, [(cfg.E, cfg.L, cfg.N)])
    launches = generic_leg(
        checks, "vnngp_sweep", model, step, (x, y), ("rbf_gram", "block_conditional"),
        lambda: posterior_deviance(model, x, y.T, torch.arange(cfg.N, device=dev)),
        "Poisson deviance over the spots trained on", negative_elbo,
        lambda r: ((x, y, *draws(r)), {}), plain_vnngp_kernels, seen,
        lambda: plain_vnngp_kernels(rbf_gram_direct))
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_pnmf(checks, dev):
    """bench.py's PNMF leg (run_pnmf_bench) at its published width:
    PNMFConfig D = 80, N = 800, L = 4, E = 20, Adam 1e-2, full batch through
    pnmf_negative_elbo, data from simulate_nsf_counts. No kernel runs. Quality:
    the plug-in rate's Poisson deviance over the spots trained on."""
    import torch
    from gpzoo_tpu_torch import PNMFConfig, make_train_step, pnmf_negative_elbo
    from gpzoo_tpu_torch.data import simulate_nsf_counts
    from gpzoo_tpu_torch.data.metrics import plugin_rate_deviance

    cfg = PNMFConfig(D=PNMF["D"], N=PNMF["N"])
    log(f"[pnmf] PNMF full batch, N={cfg.N} D={cfg.D} L={cfg.L} E={cfg.E}")
    _, counts, _ = simulate_nsf_counts(N=cfg.N, D=cfg.D, L=cfg.L)
    y = torch.from_numpy(counts).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen)
    step = make_train_step(pnmf_negative_elbo, cfg.optimizer(model), cfg.N, cfg.L, gen,
                           E=cfg.E)
    draws = _fixed_draws(dev, [(cfg.E, cfg.L, cfg.N)])
    generic_leg(checks, "pnmf", model, step, (y,), (),
                lambda: plugin_rate_deviance(model.V_raw, [(model.W_raw, model.prior.mean)],
                                             y),
                "Poisson deviance over the spots trained on", pnmf_negative_elbo,
                lambda r: ((y, *draws(r)), {}), None)
    del model, step


def phase_svgp_regression(checks, dev, seen):
    """examples/svgp_regression.py at SVGPRegressionConfig's defaults:
    n = 10,000 points of 2 sin(2x) + ε (data.sim), M = 500 inducing points on
    a grid over [0, 6], RBF(σ = 1, ℓ = 5), a Gaussian likelihood, E = 20,
    Adam 1e-3, full batch through negative_elbo, every leaf trained (kernel
    3 with D = 1, forward and backward). Quality: the posterior mean's RMSE
    against 2 sin(2x)."""
    import torch
    from torch import nn

    from gpzoo_tpu_torch import SVGPRegressionConfig, make_train_step, negative_elbo
    from gpzoo_tpu_torch.data import simulate_1d_regression

    cfg = SVGPRegressionConfig(n=REGRESSION["n"], M=REGRESSION["M"])
    log(f"[svgp_regression] SVGP regression, n={cfg.n} M={cfg.M} E={cfg.E}, "
        f"GaussianLikelihood, every leaf trained")
    xs, ys = simulate_1d_regression(n=cfg.n)
    x = torch.from_numpy(xs).to(dev)
    y = torch.from_numpy(ys).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen)
    # inducing points on the data range, as the example places them
    model.gp.Z = nn.Parameter(torch.linspace(0.0, 6.0, cfg.M, device=dev)[:, None])
    step = make_train_step(negative_elbo, cfg.optimizer(model), cfg.n, None, gen, E=cfg.E)
    draws = _fixed_draws(dev, [(cfg.E, cfg.n)])

    def rmse():
        with torch.no_grad():
            qf, _, _ = model.gp(x)
            return torch.sqrt(torch.mean(torch.square(qf.mean - 2 * torch.sin(2 * x[:, 0]))))

    launches = generic_leg(checks, "svgp_regression", model, step, (x, y), ("rbf_gram",),
                           rmse, "posterior-mean RMSE against 2 sin(2x)", negative_elbo,
                           lambda r: ((x, y, *draws(r)), {}), plain_rbf_kernels, seen,
                           lambda: plain_rbf_kernels(rbf_gram_direct))
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_warmstart(checks, dev):
    """examples/slideseq_mggp_hybrid.py at its default widths (N = 4,000,
    D = 200, 8 PNMF factors, 4 spatial, 4 groups x 40 inducing points, batch
    1,000, E = 3): PNMF (E = 1, unnormalized, Adam 1e-2, full batch, the
    example's 1,500 steps), the Moran ranking (dims_autocorr, on the host),
    which must put first the PNMF factors that best match the 4 simulated
    spatial factors, hybrid_mggp_from_pnmf, then negative_elbo_hybrid_batched
    with the kernel frozen (Adam 1e-3; kernel 4 forward, and backward for
    Z). Quality: the hybrid's posterior-mean deviance over every spot."""
    import torch
    from gpzoo_tpu_torch import (PNMFConfig, freeze_, make_batched_train_step,
                                 make_train_step, negative_elbo_hybrid_batched,
                                 pnmf_negative_elbo, run_steps, warmstart)
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance, simulate_nsf_counts
    from gpzoo_tpu_torch.data.metrics import best_match_correlation

    w = WARMSTART
    log(f"[warmstart] PNMF -> Moran ranking -> Hybrid-MGGP fine-tune, N={w['N']} "
        f"D={w['D']} PNMF L={w['L_total']} spatial {w['L_spatial']} M={w['G']} x "
        f"{w['M_per_group']} batch={w['B']}")
    coords, counts, truth = simulate_nsf_counts(N=w["N"], D=w["D"], L=w["L_spatial"],
                                                seed=0)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts).to(dev)
    groups = torch.from_numpy(np.random.default_rng(0).integers(0, w["G"], w["N"])).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(509)
    cfg = PNMFConfig(D=w["D"], N=w["N"], L=w["L_total"], E=1)
    pnmf = cfg.build(gen)
    step = make_train_step(pnmf_negative_elbo, cfg.optimizer(pnmf), cfg.N, cfg.L, gen, E=1,
                           loss_kwargs={"unnormalized": True})
    _, _ = _timed_steps(step, pnmf, (y,), WARMUP_STEPS)
    losses, dt = _timed_steps(step, pnmf, (y,), w["pnmf_steps"] - WARMUP_STEPS)
    log(f"  PNMF: {w['pnmf_steps']} steps, {dt / (w['pnmf_steps'] - WARMUP_STEPS) * 1e3:.3f} "
        f"ms/step (host clock); loss {float(losses[0]):.6e} -> {float(losses[-1]):.6e}")
    checks.true("warmstart PNMF losses finite", bool(torch.isfinite(losses).all()))
    checks.true("warmstart PNMF loss falls", float(losses[-5:].mean()) < float(losses[:5].mean()))
    del step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, order, moran = warmstart.hybrid_mggp_from_pnmf(
        gen, pnmf, x, groups, L_spatial=w["L_spatial"], m_per_group=w["M_per_group"],
        n_groups=w["G"])
    torch.cuda.synchronize()
    log(f"  Moran ranking and assembly: {time.perf_counter() - t0:.3f}s (host); order "
        f"{order.tolist()}, Moran's I {[round(float(v), 4) for v in moran]}")
    checks.true("warmstart ranking is a permutation",
                sorted(order.tolist()) == list(range(w["L_total"])))
    # the matching of the simulated factors to all PNMF factors that
    # maximizes their summed correlation takes the top-ranked ones
    with torch.no_grad():
        factors = torch.softmax(pnmf.prior()[0].mean, dim=-1).double().cpu().numpy()
    top = best_match_correlation(truth, factors[order[:w["L_spatial"]]])
    best = best_match_correlation(truth, factors)
    log(f"  simulated factors' correlation with the top-ranked {w['L_spatial']} PNMF "
        f"factors {np.round(top, 4).tolist()}, with the best {w['L_spatial']} of all "
        f"{np.round(best, 4).tolist()}")
    checks.true("warmstart ranks the PNMF factors matching the simulated spatial ones "
                "first", top.sum() >= best.sum() - 1e-9)
    freeze_(model, lambda path: ".kernel." not in path)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-3)
    kw = {"groups_x": groups}
    step = make_batched_train_step(negative_elbo_hybrid_batched, opt, w["N"], w["B"],
                                   w["L_spatial"], gen, E=3, loss_kwargs=kw)
    idx = torch.randperm(w["N"], generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)[:w["B"]]
    draws = _fixed_draws(dev, [(3, w["L_spatial"], w["B"]),
                               (3, w["L_total"] - w["L_spatial"], w["B"])])
    launches = generic_leg(
        checks, "warmstart", model, step, (x, y), ("mggp_gram",),
        lambda: hybrid_posterior_deviance(model, x, y.T, torch.arange(w["N"], device=dev),
                                          groups),
        "Poisson deviance over every spot", negative_elbo_hybrid_batched,
        lambda r: ((x, y, idx, *draws(r)), kw), plain_mggp_kernels)
    del model, step, pnmf
    torch.cuda.empty_cache()
    return launches


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
    phase_sass(checks)
    vnngp = vnngp_full_shape()
    timings, shape_timings = phase_kernels(checks, dev, vnngp)
    seen = {"main": {}, "nb": {}, "lowrank": {}, "fast": {}, "hybrid": {}, "vnngp": {},
            "ngd": {}, "snapshot": {}}
    launches = phase_main(checks, dev, seen["main"])
    on_path = [phase_nb(checks, dev, seen["nb"]),
               phase_lowrank(checks, dev, seen["lowrank"]),
               phase_fast(checks, dev, seen["fast"])]
    ngd_launches, ngd_state, ngd_step, proj = phase_ngd(checks, dev, seen["ngd"])
    on_path += [ngd_launches,
                phase_snapshot(checks, dev, seen["snapshot"], ngd_state, ngd_step, proj),
                phase_checkpoint(checks, dev, ngd_state, ngd_step, proj)]
    del ngd_state, ngd_step, proj
    nsf_data.cache_clear()
    torch.cuda.empty_cache()
    phase_small_reference(checks, dev)
    phase_heads_small(checks, dev)
    phase_blockwise_small(checks, dev)
    on_path.append(phase_vnngp(checks, dev, vnngp, seen["vnngp"]))
    phase_small_vnngp(checks, dev)
    on_path.append(phase_mggp(checks, dev))
    phase_small_mggp(checks, dev)
    on_path.append(phase_hybrid_mggp(checks, dev))
    mggp_data.cache_clear()
    torch.cuda.empty_cache()
    on_path.append(phase_hybrid(checks, dev, seen["hybrid"]))
    generic = ("nsf_sweep", "vnngp_sweep", "svgp_regression")
    seen.update({leg: {} for leg in generic})
    on_path.append(phase_nsf_sweep(checks, dev, seen["nsf_sweep"]))
    on_path.append(phase_vnngp_sweep(checks, dev, seen["vnngp_sweep"]))
    phase_pnmf(checks, dev)
    on_path.append(phase_svgp_regression(checks, dev, seen["svgp_regression"]))
    on_path.append(phase_warmstart(checks, dev))
    phase_device_times(dev, vnngp, shape_timings)
    # a kernel that runs on several paths counts the sum of their runs
    for part in on_path:
        for name, count in part.items():
            launches[name] = launches.get(name, 0) + count
    on_paths = {}
    for part in ([seen[leg] for leg in ("main", "nb", "lowrank", "fast", "ngd", "snapshot",
                                        "hybrid") + generic]
                 + list(seen["vnngp"].values())):
        for name, shapes in part.items():
            on_paths.setdefault(name, collections.Counter()).update(shapes)
    per_shape_summary(checks, on_paths, shape_timings)
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
