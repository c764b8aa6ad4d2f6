#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gpzoo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel in gpzoo_tpu_torch/ops/csrc with nvcc
               (one process per source, all at once) and print each
               kernel's registers and spills; then the SASS instruction mix
               (cuobjdump) of every kernel of tri.cu, gram.cu, vnngp.cu and
               mggp.cu; the tri main loops must show the tensor-core HGMMA,
               and each instance's TMA (UTMALDG), shared-memory load and
               register handover (USETMAXREG) counts are printed, and for
               each instance of kernel 4's backward the instructions of its
               factor loop a pair (one MUFU.EX2 a pair);
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
               Kzx, under each α convention and at a ragged L = 37, p = 3,
               E = 17; kernel 5 at n = 1 and one past a block's and the
               step's point count; kernels 1-4 also at the fast, Hybrid-NSF
               and Hybrid-MGGP legs' shapes; kernel 1 keeping c (its
               colsum kernel 1's bits, its c kernel 2's) and kernel 1's
               backward: the scale pass dc = 2c·g from the kept c (the
               dc epilogue's bits), the dc epilogue of kernel 2 (on no
               path), kernels 6 (dLu) and 7 (the per-factor da on dcᵀ),
               kernel 7 reading c (da with dcᵀ formed from c in its loads,
               the route of every a that trains: the bits of the scale
               pass with dcᵀ and kernel 7, also with the last factor's c
               NaN) and, for a shared a, kernel 6 reading c (dLu with dc
               formed from c in its loads: the bits of the scale pass and
               kernel 6), each against its plain version at every path's
               shape, at M = 1 and at M, B off the tiles, with exact zeros
               in dLu's upper triangle and dc's padding, every element of
               dLu and da written, reruns bit for bit, call and device
               times; kernel 2's backward (JAX's _tri_bwd:
               tri_split, then kernels 6 and 7) on a CUDA tri_t_matmul's
               grad_fn against its plain panels at the north-star, MGGP and
               Hybrid-NSF shapes and ragged ones, the split bit for bit;
               kernel 3's backward kernel (rbf_gram_bwd) and kernel 5's
               (block_conditional_bwd) against their closed forms and,
               through their autograd Functions, against autograd of the
               plain forms, at every path shape where Z, σ, ℓ or the VNNGP
               state train and at ragged ones (kernel 3's: a grid of one
               block, a last round part-full, past 32 factors; kernel 5's:
               K = 5, a last round part-full); each backward rerun at a path
               shape must give the same bits, and each is timed (call,
               device, plain, bound); kernel 3's backward with its
               cotangent's planes transposed (as the SVGP's solve hands
               Kzx's back) read without a copy, the same bits as with a
               contiguous one, one kernel node a call; kernel 4's backward kernel,
               all seven gradients, against its closed form in plain
               PyTorch and against autograd through the plain form at the
               MGGP, Hybrid-MGGP and warm-start Kzz and Kzx and the ragged
               shape, timed with the gradients each path asks for, and the
               forward and backward against the plain form under autograd;
               kernels 3-5 forward and backward at the generic legs'
               shapes; kernel 8, the KL trace tr(K⁻¹·Lu·Luᵀ), each entry
               (the forward, the forward keeping P = K_s·Lu, the scale
               pass dLu = tril(2g·P) from it and the recomputing backward)
               against its closed forms (P's lower triangle; dLu handed
               NaN-filled memory: exact zeros above the diagonal; P handed
               NaN: nothing written above its diagonal, and the scale
               pass's zeros there; NaN above Lu's diagonal: the same
               bits), rerun bit for bit, the kept forward's trace the
               forward's bits and the scale pass's dLu the recompute's,
               and, through TriKLTrace, against
               autograd of the closed form, at M 1 to 1,025 with a shared
               K⁻¹, a per-factor one and one over one Lu (K⁻¹ not
               symmetric), and timed at the north-star, VNNGP, MGGP and
               Hybrid-MGGP widths beside its bound, the closed forms, the
               panels and the one-call einsum, with its kernels a call
               counted by the profiler);
  3. main    — the north-star NSF training step at full width (N=45,000,
               D=4,000, L=20, M=3,000, batch 7,000): config build, the
               precomputed projection, warm-up and timed Adam steps, the
               held-out deviance, peak memory and each kernel's launch count,
               a profiled window (device idle share, kernels by time and
               operators by input shape), the same window with the KL
               trace's panel form (the route before kernel 8), then one
               step with the kernels against the same step with the
               plain versions (the loss and every leaf's gradient); kernel
               1 keeping c and kernel 6 reading c once a step, never the
               scale pass or kernel 6 on a dc (ã is shared and a
               constant; so on [nb] and [fast]); kernel 8 once a step
               each way, forward keeping P and scale pass, and never the
               recompute;
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
               three chunks of NGD steps, each snapshot after ngd_to_model
               (its qf_scale_p50 must move from snapshot to snapshot), then
               extract_factors at all 45,000 spots and its Moran ranking on
               the card, held against the host route's (graph_vs_host);
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
               7,000, trainable kernels and embedding, Z frozen), as an
               A/B of two arms from one init on the same 56 minibatches:
               bench.py's precision and remat settings (BENCH: remat
               "save_proj", grad_precision "default", proj_precision
               "high", chol_precision auto) and every knob at "highest";
               each arm's ms/step (10 steps after 3), peak memory, held-out
               deviance from the posterior at the last 2,000 spots,
               launches and a profiled window with the GEMM kernels' names;
               both trajectories' largest gap, the deviances within
               TOL_AB_DEVIANCE; the must-differ check of each knob whose
               string maps to a reduced mode (MUST_DIFFER); one step with
               kernels 1 and 4 against the same step with their plain
               versions, every knob at "highest", and a small two-chunk
               input against the float64 CPU path;
     hybrid_mggp — bench.py's Slideseq Hybrid-MGGP leg (N=45,000, D=4,000,
               L=10 + T=10, M=3,010, batch 6,000, E=3, jitter 1e-2, Z
               trained through kernel 4's backward): bench.py's settings
               beside every knob at "highest" (13 steps each, the figures
               of every leg and both deviances), the must-differ check, and
               one step against the plain kernels at "highest", both
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
     warmstart_slideseq — the same example at its documented full Slideseq
               scale (N=45,000, D=4,000, 20 PNMF factors, 10 spatial,
               M=3,010, batch 6,000, E=3; the fine-tune cut to the generic
               legs' steps): the card's KNN graph at N=4,000 against the
               dense one (identical), the Moran ranking on the card against
               the host route on the same 45,000 coordinates (rows with
               another neighbour set, Moran's I, the top set, each within
               its limit, and a TF32 control that must fail them), the
               ranking check, the figures of every generic leg, and the
               fine-tuned spatial factors' posterior at every spot
               (extract_factors) and their Moran's I;
  6. parallel — the sharded paths of gpzoo_tpu_torch.parallel on two ranks
               of the one card (spawned processes, gloo over CUDA tensors:
               the split of work and memory, not multi-card scaling), each
               held against the unsharded run on the same init and draws:
               the north-star step under {"data": 2} (counts split by
               columns) and {"factor": 2}, 3 steps each (losses, the first
               step's gradients, the leaves after, replicated leaves
               bit-identical across ranks), a checkpoint of the
               factor-split state (one file a rank) and its bit-identical
               resume, 2 NGD steps, the VNNGP posterior over 100,000 spots
               and one MGGP step (under the unsharded step's floor
               decisions), all under {"data": 2}; under {"factor": 2},
               bench.py's --loss fast leg (the shared-kernel collapse, Z
               and the kernel frozen, 3 steps), the MGGP step (α and the
               embedding whole, bit-identical across ranks) and the VNNGP
               all-trainable leg (3 steps, σ and ℓ trained through the
               collapse: their gradient whole in global factor 0, exactly
               0 elsewhere), each under the unsharded run's floor
               decisions; each rank's step ms, peak memory, bytes
               all-reduced and launches; then 3 north-star steps in a
               1-rank NCCL group, which must equal the unsharded steps bit
               for bit. Kernels 1-5 are first held against their plain
               versions at a rank's shapes, kernel 4 also at a factor
               rank's MGGP Kzx;
  7. device  — kernels 3 and 5 alone on the device at every path shape, and
               kernel 4 and its backward kernel at the MGGP step's Kzz and
               Kzx, the Hybrid-MGGP step's (the full-scale warm start's) Kzz
               and Kzx and the warm start's Kzz and Kzx: DEVICE_REPS calls
               captured in one CUDA graph, its replay
               timed by CUDA events, with the launches the capture
               recorded (no time unless all were).
Every leg that trains Z, σ, ℓ or the VNNGP state ([vnngp] (b), [hybrid],
[nsf_sweep], [vnngp_sweep], [svgp_regression], [parallel]'s VNNGP factor
leg) must launch kernel 3's backward kernel, and kernel 5's where a VNNGP
trains; every leg whose KL takes the trace ([main], [nb], [fast], [ngd]'s
Adam arm, [checkpoint], [vnngp] (a) and (b), [parallel]'s north-star, fast
and VNNGP legs) kernel 8 both ways, its forward keeping P and the scale
pass (KL); and no step on the card may call the
plain backwards of kernels 3, 5 and 8 (a spy counts the calls). Kernels 3 and 5's launches on the paths are counted by shape, and a
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
# the same example at the full Slideseq scale its docstring documents (--N
# 45000 --D 4000 --L-total 20 --L-spatial 10 --m-per-group 215 --groups 14
# --batch 6000), the fine-tune's 2,000 steps cut as every generic leg's
WARMSTART_SLIDESEQ = dict(N=45_000, D=4_000, L_total=20, L_spatial=10, M_per_group=215,
                          G=14, B=6_000, pnmf_steps=1_500)
# The Moran graph built on the card against the host route on the same
# coordinates, fixed before the first run on the card. At most this share of
# the rows may have another neighbour set: 0.1%, 45 rows at N = 45,000, the
# scale of the 44 rows that float64 arithmetic moves against the float32
# expansion at that N (two float32 expansions that differ only in FMA
# contraction should move far fewer); Moran's I within TOL_GRAPH_MORAN
# (absolute: those 44 rows move it by at most 4.5e-5, on a noise factor),
# and the same top-ranked factors.
MAX_GRAPH_ROWS = 1e-3
TOL_GRAPH_MORAN = 1e-4
WARMUP_STEPS, TIMED_STEPS = 3, 10
# The blockwise loss's precision knobs (train/policy.py). HIGHEST: every
# product in IEEE float32, as the float32 step checks hold it. BENCH:
# benchmarks/mggp_anatomy.py measure_step's defaults, which bench.py's MGGP
# and Slideseq Hybrid-MGGP legs run (chol_precision on its auto rule).
HIGHEST = dict(grad_precision="highest", proj_precision="highest",
               chol_precision="highest")
BENCH = dict(remat="save_proj", grad_precision="default", proj_precision="high",
             chol_precision=None)
# [mggp]'s A/B: both arms take the same MGGP_AB_STEPS minibatches from one
# init; the held-out deviances must agree within TOL_AB_DEVIANCE (relative).
# Fixed before the first run on the card, never moved after.
MGGP_AB_STEPS = 56
TOL_AB_DEVIANCE = 1e-3
# The Hopper modes of JAX's own aliases for the precision strings (the
# jax.lax.Precision docstring), which ops/precision.py's table starts from:
# for each string the table maps elsewhere, [mggp] runs each knob alone at
# its bench.py string under its alias's mode, to show what moved it.
ALIAS_MODES = {"highest": "ieee", "high": "tf32", "default": "bf16"}
# A knob whose string maps to a reduced mode must move its first step (the
# loss or a gradient leaf) by more than MUST_DIFFER times the gap between two
# runs of the "highest" step, or it is a no-op.
MUST_DIFFER = 10
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
#: [snapshot]'s extract_factors at every spot: spots of one posterior block
EXTRACT_CHUNK = 9_000
#: [checkpoint]: chunks saved by the hook, then steps run twice (live, resumed)
CHECKPOINT = dict(chunks=3, chunk=2, more=3)
HYBRID_PROFILED_STEPS = 5
# Kernel 1 and its backward on a path: wherever Lu trains, kernel 1 keeping c
# (tri_sq_colsum_c), then one of two routes. Where ã is shared and a
# constant (the north-star projection; the fast leg's ã = K⁻¹Kzx, Z and the
# kernel frozen: [main], [nb], [fast], [ngd]'s Adam arm, [checkpoint],
# [parallel]'s north-star and fast ranks), kernel 6 reading c
# (tri_dlu_from_c), which forms dc = 2c·g in its own loads: TRI, and the
# scale pass and kernel 6 on a DcOperand must not run there (OFF_SHARED).
# Where a per-factor a trains (the MGGP W-form and the hybrids' a = W·Kzx),
# the scale pass dc = 2c·g (tri_dc_from_c, rows only: scale_rows_kernel),
# kernel 6 (tri_dlu) and kernel 7 reading c (tri_da_from_c), which forms
# dcᵀ = 2g·cᵀ in its own loads: TRI_DA, and kernel 6 reading c, kernel 7 on
# a DcOperand's dcᵀ (tri_da, the backward of kernel 2 only) and any dcᵀ
# written ("dcT written": a DcOperand made with rows_t, counted by
# _rows_t_counter) must not run there (OFF_PER_FACTOR). The dc epilogue of
# kernel 2 (tri_dc), which reran the triangle for c, runs on no path since
# kernel 1 keeps c:
# both count it, and every leg expects it at 0 (off_path, launch_ok).
# Kernel 1 without c (tri_sq_colsum) runs where the loss is evaluated with
# no gradient recorded (step_kernels_vs_plain holds that), not in a step;
# the held-out deviance and the posterior do not call kernel 1.
OFF_SHARED = ("tri_dc_from_c", "tri_dlu", "tri_dc")
OFF_PER_FACTOR = ("tri_dlu_from_c", "tri_dc", "tri_da", "dcT written")
TRI = ("tri_sq_colsum_c", "tri_dlu_from_c") + OFF_SHARED
TRI_DA = ("tri_sq_colsum_c", "tri_dc_from_c", "tri_dlu", "tri_da_from_c") + OFF_PER_FACTOR
# Kernel 8, the KL trace tr(K⁻¹·Lu·Luᵀ), and its backward: every step whose
# KL takes the trace (the precomputed NSF loss, the blockwise collapse, both
# VNNGP losses) trains a per-factor Lu, so runs the forward that keeps P and
# the scale pass from it; the MGGP W-form's KL is ‖W·Lu‖² and takes no
# trace. The forward without P (no gradient recorded, or K⁻¹ alone trained)
# and the recomputing backward (one Lu under a per-factor K⁻¹) run on no
# path: KL_ALL names all four entries.
KL = ("tri_kl_trace_p", "tri_kl_trace_scale")
KL_ALL = ("tri_kl_trace",) + KL + ("tri_kl_trace_bwd",)

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


def device_ms(fn, reps, wrapper):
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the graph replayed between two CUDA events, divided by ``reps``;
    and the launches of ``wrapper`` (the kernel's launch-counting wrapper)
    that the capture recorded. Unlike :func:`median_ms`, it leaves out the
    host's time in the wrapper, which bounds a small call, and holds any
    small device work the wrapper does beside the kernel. The time
    is None, and the reason is printed, when the capture fails or recorded
    another count of launches than ``reps``: no mean over dropped calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = wrapper.launches
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception as exc:  # noqa: BLE001 - a report, not a check
        log(f"  CUDA graph capture failed ({type(exc).__name__}: {exc})")
        return None, wrapper.launches - before
    count = wrapper.launches - before
    if count != reps:
        return None, count
    graph.replay()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms, count


class Checks:
    def __init__(self):
        self.failed = []
        self.findings = []

    def le(self, what, value, tol):
        ok = math.isfinite(value) and value <= tol
        log(f"  {'ok  ' if ok else 'FAIL'} {what}: {value:.3e} (tol {tol:.0e})")
        if not ok:
            self.failed.append(what)

    def true(self, what, cond):
        log(f"  {'ok  ' if cond else 'FAIL'} {what}")
        if not cond:
            self.failed.append(what)

    def report(self, what, cond):
        """A check whose failure is a finding that the run reports and does
        not fail on: it fails in the JAX reference too."""
        log(f"  {'ok  ' if cond else 'FINDING'} {what}")
        if not cond:
            self.findings.append(what)


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


# The instances of tri.cu's main loop, by its template argument (kMode), and
# kernel 8 keeping P's persistent kernel (the same loop, walking its tiles)
TRI_MMA = {"tri_mma_kernel<0>": "kernel 1", "tri_mma_kernel<1>": "kernel 2",
           "tri_mma_kernel<2>": "kernel 2, the dc epilogue",
           "tri_mma_kernel<3>": "kernel 6, dLu", "tri_mma_kernel<4>": "kernel 7, da",
           "tri_mma_kernel<5>": "kernel 7, da, a grid of one wave",
           "tri_mma_kernel<6>": "kernel 8, the KL trace",
           "tri_mma_kernel<7>": "kernel 8's backward, dLu",
           "trace_p_kernel<0>": "kernel 8 keeping P, the persistent grid, a per-factor K⁻¹",
           "trace_p_kernel<1>": "kernel 8 keeping P, the persistent grid, a shared K⁻¹",
           "tri_mma_kernel<9>": "kernel 1 keeping c",
           "tri_mma_kernel<10>": "kernel 6 reading c, dLu",
           "tri_mma_kernel<11>": "kernel 7 reading c, da"}


def _factor_loop(body):
    """(instructions, MUFU.EX2) of the longest loop of ``body`` ((address,
    instruction) pairs of one kernel's SASS) that holds a MUFU.EX2, or None:
    kernel 4's backward runs one MUFU.EX2 a pair in its factor loop."""
    addrs = [a for a, _ in body]
    best = None
    for i, (addr, ins) in enumerate(body):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m is None or int(m.group(1), 16) >= addr or int(m.group(1), 16) not in addrs:
            continue
        loop = body[addrs.index(int(m.group(1), 16)):i + 1]
        ex2 = sum("MUFU.EX2" in x for _, x in loop)
        if ex2 and (best is None or len(loop) > best[0]):
            best = (len(loop), ex2)
    return best


def phase_sass(checks):
    """The instruction mix of every kernel of tri.cu, gram.cu, vnngp.cu and
    mggp.cu, read from ``cuobjdump -sass`` of the built libraries, and the
    instructions a pair of the factor loop of kernel 4's backward. The
    tensor-core MMA (HGMMA) must be in every instance of the tri main loop
    (TRI_MMA)."""
    from gpzoo_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log(f"[sass] {tool} not in the toolkit: instruction mix not read")
        return
    mixes, loops = {}, {}
    for lib in ("tri", "gram", "vnngp", "mggp"):
        out = subprocess.run([str(tool), "-sass", str(_build._lib_path(_build.CSRC / f"{lib}.cu"))],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            log(f"[sass] cuobjdump failed on {lib}.cu: {out.stderr.strip()[:300]}")
            continue
        log(f"[sass] {lib}.cu instruction mix (cuobjdump -sass)")
        lib_mixes, name, bodies = {}, None, {}
        for line in out.stdout.splitlines():
            if "Function :" in line:
                name = _kernel_name(line.split(":", 1)[1].strip())
                lib_mixes[name], bodies[name] = {}, []
            elif name is not None:
                op = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)",
                              line)
                if op:
                    lib_mixes[name][op.group(2)] = lib_mixes[name].get(op.group(2), 0) + 1
                    bodies[name].append((int(op.group(1), 16), line))
        for name, body in bodies.items():
            if name.startswith("mggp_gram_bwd_kernel"):
                loops[name] = _factor_loop(body)
        for name, mix in sorted(lib_mixes.items()):
            top = ", ".join(f"{k} {v}" for k, v in
                            sorted(mix.items(), key=lambda kv: -kv[1])[:10])
            log(f"  {name}: {sum(mix.values())} instructions; top: {top}")
        mixes.update(lib_mixes)
    # kernel 4's backward: <VEC, p == 2, outputs (1 dd2, 6 dg2 and the sums,
    # 7 any)>; the static count of the loop's instructions over its pairs
    for name, loop in sorted(loops.items()):
        log(f"  {name}: factor loop " + (f"{loop[0]} instructions, {loop[1]} pairs, "
                                         f"{loop[0] / loop[1]:.1f} a pair" if loop else
                                         "not found"))
    for inst, what in TRI_MMA.items():
        checks.true(f"HGMMA in {inst} ({what})", mixes.get(inst, {}).get("HGMMA", 0) > 0)
        # TMA loads (UTMALDG: three a stage in the dc epilogue and kernels 6,
        # 6 reading c, 7 and 8, whose A comes in f32 and is split in
        # registers (LDS), six in kernel 7 reading c (c's tile in four
        # boxes), four elsewhere), kernel 6 reading c's bulk copy of
        # 2g (UBLKCP) and the register handover (USETMAXREG)
        ops = {op: n for op, n in sorted(mixes.get(inst, {}).items())
               if op.startswith(("UTMA", "UBLKCP", "LDS", "USETMAXREG"))}
        log(f"  {inst} ({what}): TMA, shared-memory load and register-handover "
            f"instructions {', '.join(f'{op} {n}' for op, n in ops.items()) or 'none'}")


def _tri_bounds(L, M, B, per_factor):
    """(input bytes, FLOP) of kernels 1-2: Lu's lower triangle and a, each
    read once, and the triangle's L·B·M(M+1) FLOP. The kernels' own hi/lo
    staging is their design, not the function's, and is not counted."""
    in_bytes = 4 * (L * M * (M + 1) // 2 + (L if per_factor else 1) * M * B)
    return in_bytes, L * B * M * (M + 1)


def _tri_case(checks, dev, g, L, M, B, label, timings=None, per_factor=False):
    """Kernels 1-2 against their plain versions with a shared a (M, B), the
    north-star projection, or a per-factor a (L, M, B), the MGGP step's
    a = W·Kzx, and TriSqColsum's dLu and da against autograd of the plain
    form."""
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
    a_k = a.clone().requires_grad_()
    tri_cuda.tri_sq_colsum(lu_k, a_k).backward(gout)
    lu_p = lu.clone().requires_grad_()
    a_p = a.clone().requires_grad_()
    tri_blocked.tri_sq_colsum(lu_p, a_p).backward(gout)
    checks.le(f"TriSqColsum dLu {label}",
              norm_err(lu_k.grad, torch.tril(lu_p.grad)), TOL_TRI)
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
    in_bytes, tri_flops = _tri_bounds(L, M, B, per_factor)
    stage_ms = median_ms(lambda: tri_cuda.stage(lu, a, scratch), 5)
    del scratch
    for name, out_bytes, extra_flops in (("tri_sq_colsum", 4 * L * B, 2 * L * M * B),
                                         ("tri_t_matmul", 4 * L * M * B, 0)):
        # 3xTF32: three tensor-core products per product of the triangle
        bound_ms, bound_by = bound(in_bytes + out_bytes, 3 * tri_flops, TF32_TC_FLOP_PER_S,
                                   "operations (3xTF32 tensor cores)")
        timings[name] = dict(
            bound_ms=bound_ms, bound_by=bound_by,
            # the bound of an FFMA design: f32 rate
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


def _tri_bwd_bounds(L, M, B, per_factor):
    """{kernel: (bytes, FLOP)} of the backward's functions: each input read
    once and each output written once, in float32 (the dc epilogue reads
    Lu's lower triangle, a and g and writes dc; kernel 6 reads a and dc and
    writes dLu (L, M, M); kernel 6 reading c reads a, c and g and writes
    dLu; kernel 7 reads Lu's lower triangle and dc and writes da; kernel 7
    reading c reads Lu's lower triangle, c and g and writes da), and the
    triangle's L·B·M(M+1) FLOP.
    The kernels' hi/lo split, dcᵀ and staging are their design, not the
    function's, and are not counted."""
    lu_bytes = 4 * L * M * (M + 1) // 2
    a_bytes = 4 * (L if per_factor else 1) * M * B
    dc_bytes = 4 * L * M * B
    flops = L * B * M * (M + 1)
    return {"tri_sq_colsum_c": (lu_bytes + a_bytes + 4 * L * B + dc_bytes, flops),
            "tri_dc": (lu_bytes + a_bytes + 4 * L * B + dc_bytes, flops),
            "tri_dlu": (a_bytes + dc_bytes + 4 * L * M * M, flops),
            # kernel 6 reading c: a, c and g read, dLu written
            "tri_dlu_from_c": (a_bytes + dc_bytes + 4 * L * B + 4 * L * M * M, flops),
            "tri_da": (lu_bytes + dc_bytes + a_bytes, flops),
            "tri_da_from_c": (lu_bytes + dc_bytes + 4 * L * B + a_bytes, flops)}


def _scale_bound(L, M, B):
    """(bytes, FLOP) of the scale pass's function dc = 2c·g: c (L, M, B)
    and g (L, B) read once, dc (L, M, B) written once, in float32; two
    multiplies an element (2g, then times c). The TF32 hi/lo split, dcᵀ and
    the padding are the layout kernels 6 and 7 read, not the function's:
    :func:`_scale_layout_bytes` counts them apart."""
    return 8 * L * M * B + 4 * L * B, 2 * L * M * B


def _scale_layout_bytes(L, M, B):
    """The bytes the scale pass moves in the layout it writes on the paths:
    c and g read, dc's hi and lo parts written as rows (no dcᵀ since kernel
    7 reads c; the padding not counted). Reported beside the bound as
    ``layout_bound_ms``, not in it."""
    return 4 * L * M * B * 3 + 4 * L * B


def _tri_bwd_case(checks, dev, g, L, M, B, label, per_factor, timings=None,
                  device=False):
    """Kernel 1's backward on the card against its plain versions: kernel 1
    keeping c (its colsum the bits of kernel 1 without c, its c those of
    kernel 2's c store and within TOL_TRI of the panel product), the scale
    pass dc = 2c·g from that c (rows only, on NaN-filled memory, the bits of
    the plain scale split in plain PyTorch and of the dc epilogue's rows at
    the same g; dcᵀ refused, a rerun the same bits), the dc
    epilogue (dc = 2c·g, split and laid out for kernels 6-7; on no path,
    held here), kernel 6 (dLu) and kernel 7 (da per factor, or summed over l
    for a shared a), each at TOL_TRI, with exact zeros in dc's padding and
    above dLu's diagonal (dLu's buffer is handed NaN-filled memory first, so
    an element the kernel misses cannot pass as a zero), and reruns bit for
    bit; for a shared a, kernel 6 reading c (tri_dlu_from_c): the bits of
    the scale pass followed by kernel 6, within TOL_TRI of its plain form,
    every element written (NaN-filled memory again), exact zeros above the
    diagonal, a rerun the same bits; kernel 7 reading c (tri_da_from_c, per
    factor, or summed over l for a shared a): the bits of the dc epilogue's
    dcᵀ followed by kernel 7, within TOL_TRI of its plain form, every
    element written (NaN-filled memory), a rerun the same bits, and with L >
    1 the factors before the last the same bits where the last factor's c is
    NaN (the last m stage of each factor reads the next factor's first rows
    of c, which must not reach its sums). With ``timings``: each kernel's
    call time (and with ``device``, its device time), bound, plain and
    library times."""
    import torch
    from gpzoo_tpu_torch.ops import tri_cuda

    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / math.sqrt(M)
    a = torch.randn((L, M, B) if per_factor else (M, B), generator=g, device=dev)
    gout = torch.randn((L, B), generator=g, device=dev)
    colsum, c = tri_cuda.tri_sq_colsum_fwd_c(lu, a)
    checks.true(f"tri_sq_colsum_c {label}: the colsum is kernel 1's bits without c",
                bool(torch.equal(colsum, tri_cuda.tri_sq_colsum_fused(lu, a))))
    c2 = tri_cuda.tri_t_matmul_fwd(lu, a)
    checks.true(f"tri_sq_colsum_c {label}: c is kernel 2's c, bit for bit",
                bool(torch.equal(c, c2)))
    del c2
    ref_c = tri_cuda.tri_sq_colsum_c_plain(lu, a)[1]
    err = {"tri_sq_colsum_c": float((c - ref_c).abs().max())}
    checks.le(f"tri_sq_colsum_c {label}: c against the panels", norm_err(c, ref_c), TOL_TRI)
    ref_scaled = tri_cuda.tri_dc_from_c_plain(c, gout)
    del ref_c
    dc = tri_cuda.tri_dc(lu, a, gout, transposed=True)
    ref_dc = tri_cuda.tri_dc_plain(lu, a, gout)
    err["tri_dc"] = float((dc.dense() - ref_dc).abs().max())
    checks.le(f"tri_dc {label}", norm_err(dc.dense(), ref_dc), TOL_TRI)
    checks.true(f"tri_dc {label}: zeros in the padding b >= B",
                bool((dc.rows[..., B:] == 0).all()))
    checks.true(f"tri_dc {label}: dcT holds dc's parts, zeros at m >= M",
                bool((dc.rows_t[..., M:] == 0).all())
                and bool((dc.rows_t[..., :M] == dc.rows[..., :B].mT).all()))
    # the scale pass writes rows only (scale_rows_kernel), into NaN-filled
    # memory: every element written
    torch.full((2, L, M, tri_cuda.padded_b(B)), math.nan, device=dev)  # freed: reused
    op = tri_cuda.tri_dc_from_c(c, gout)
    err["tri_dc_from_c"] = float((op.dense() - ref_dc).abs().max())
    plain_op = tri_cuda.tri_split_plain(ref_scaled)
    checks.true(f"tri_dc_from_c {label}: rows only, the plain scale's split bit for bit "
                "(zeros in the padding b >= B)", op.rows_t is None
                and bool(torch.equal(op.rows, plain_op.rows)))
    checks.true(f"tri_dc_from_c {label}: the rows are the dc epilogue's bits",
                bool(torch.equal(op.rows, dc.rows)))
    try:
        tri_cuda.tri_dc_from_c(c, gout, transposed=True)
        refused = False
    except ValueError:
        refused = True
    checks.true(f"tri_dc_from_c {label}: dcT is refused (kernel 7 reading c forms it)", refused)
    del plain_op, ref_scaled
    again = tri_cuda.tri_sq_colsum_fwd_c(lu, a)
    checks.true(f"tri_sq_colsum_c {label}: a rerun gives the same bits (colsum, c)",
                bool(torch.equal(again[0], colsum)) and bool(torch.equal(again[1], c)))
    again = tri_cuda.tri_dc_from_c(c, gout)
    checks.true(f"tri_dc_from_c {label}: a rerun gives the same bits",
                bool(torch.equal(again.rows, op.rows)))
    del again, op, colsum
    torch.full((L, M, M), math.nan, device=dev)  # freed: tri_dlu's buffer reuses it
    dlu = tri_cuda.tri_dlu(a, dc)
    ref = tri_cuda.tri_dlu_plain(a, ref_dc)
    err["tri_dlu"] = float((dlu - ref).abs().max())
    checks.le(f"tri_dlu {label}", norm_err(dlu, ref), TOL_TRI)
    upper = torch.ones((M, M), dtype=torch.bool, device=dev).triu(1)
    checks.true(f"tri_dlu {label}: exact zeros above the diagonal",
                bool((dlu[:, upper] == 0).all()))
    del ref, upper
    # each output element is summed in one CTA in a fixed order: a rerun of
    # the dc epilogue and of kernel 6 gives the same bits (the steps' floor
    # replays rely on it)
    again = tri_cuda.tri_dc(lu, a, gout, transposed=True)
    checks.true(f"tri_dc {label}: a rerun gives the same bits (dc, dcT, hi and lo)",
                bool(torch.equal(again.rows, dc.rows))
                and bool(torch.equal(again.rows_t, dc.rows_t)))
    checks.true(f"tri_dlu {label}: a rerun gives the same bits",
                bool(torch.equal(tri_cuda.tri_dlu(a, again), dlu)))
    del again, dlu
    if not per_factor:
        # kernel 6 reading c, the route of a shared ã that takes no gradient
        old = tri_cuda.tri_dlu(a, tri_cuda.tri_dc_from_c(c, gout))
        torch.full((L, M, M), math.nan, device=dev)  # freed: the new dLu's buffer reuses it
        new = tri_cuda.tri_dlu_from_c(a, c, gout)
        checks.true(f"tri_dlu_from_c {label}: the bits of the scale pass, then kernel 6",
                    bool(torch.equal(new, old)))
        if not torch.equal(new, old):
            diff = (new - old).abs()
            log(f"  tri_dlu_from_c {label}: {int((diff > 0).sum())} elements differ from the "
                f"old route's, largest {float(diff.max()):.3e} at "
                f"{[int(i) for i in torch.nonzero(diff == diff.max())[0]]}")
        del old
        ref = tri_cuda.tri_dlu_from_c_plain(a, c, gout)
        err["tri_dlu_from_c"] = float((new - ref).abs().max())
        checks.le(f"tri_dlu_from_c {label}", norm_err(new, ref), TOL_TRI)
        del ref
        upper = torch.ones((M, M), dtype=torch.bool, device=dev).triu(1)
        checks.true(f"tri_dlu_from_c {label}: every element written, exact zeros above "
                    "the diagonal", bool(torch.isfinite(new).all())
                    and bool((new[:, upper] == 0).all()))
        del upper
        checks.true(f"tri_dlu_from_c {label}: a rerun gives the same bits",
                    bool(torch.equal(tri_cuda.tri_dlu_from_c(a, c, gout), new)))
        del new
    da = tri_cuda.tri_da(lu, dc, shared=not per_factor)
    ref = tri_cuda.tri_da_plain(lu, ref_dc, shared=not per_factor)
    err["tri_da"] = float((da - ref).abs().max())
    checks.le(f"tri_da {label}", norm_err(da, ref), TOL_TRI)
    del ref
    # kernel 7 reading c, the route of every a that takes a gradient
    torch.full((L, M, B), math.nan, device=dev)  # freed: the new da's buffer reuses it
    new = tri_cuda.tri_da_from_c(lu, c, gout, shared=not per_factor)
    checks.true(f"tri_da_from_c {label}: the bits of the dc epilogue's dcT, then kernel 7",
                bool(torch.equal(new, da)))
    if not torch.equal(new, da):
        diff = (new - da).abs()
        log(f"  tri_da_from_c {label}: {int((diff > 0).sum())} elements differ from the old "
            f"route's, largest {float(diff.max()):.3e} at "
            f"{[int(i) for i in torch.nonzero(diff == diff.max())[0]]}")
    ref = tri_cuda.tri_da_from_c_plain(lu, c, gout, shared=not per_factor)
    err["tri_da_from_c"] = float((new - ref).abs().max())
    checks.le(f"tri_da_from_c {label}", norm_err(new, ref), TOL_TRI)
    del ref
    checks.true(f"tri_da_from_c {label}: every element written",
                bool(torch.isfinite(new).all()))
    checks.true(f"tri_da_from_c {label}: a rerun gives the same bits",
                bool(torch.equal(tri_cuda.tri_da_from_c(lu, c, gout, shared=not per_factor),
                                 new)))
    del new
    if L > 1:
        old = da if per_factor else tri_cuda.tri_da(lu, dc)
        c_nan = c.clone()
        c_nan[-1] = math.nan
        got = tri_cuda.tri_da_from_c(lu, c_nan, gout)
        checks.true(f"tri_da_from_c {label}: NaN in the last factor's c leaves the others' "
                    "da the same bits", bool(torch.equal(got[:-1], old[:-1])))
        del old, c_nan, got
    del da
    torch.cuda.synchronize()
    if timings is None:
        return
    calls = {
        "tri_sq_colsum_c": (tri_cuda.tri_sq_colsum_fwd_c,
                            lambda: tri_cuda.tri_sq_colsum_fwd_c(lu, a),
                            lambda: tri_cuda.tri_sq_colsum_c_plain(lu, a), None),
        # as the path runs it: rows only (kernel 7 reads c)
        "tri_dc_from_c": (tri_cuda.tri_dc_from_c,
                          lambda: tri_cuda.tri_dc_from_c(c, gout),
                          lambda: tri_cuda.tri_dc_from_c_plain(c, gout),
                          lambda: torch.mul(c, (2 * gout)[:, None, :])),
        "tri_dc": (tri_cuda.tri_dc, lambda: tri_cuda.tri_dc(lu, a, gout, per_factor),
                   lambda: tri_cuda.tri_dc_plain(lu, a, gout), None),
        # one cuBLAS call (f32, TF32 off) with the tril it implies
        "tri_dlu": (tri_cuda.tri_dlu, lambda: tri_cuda.tri_dlu(a, dc),
                    lambda: tri_cuda.tri_dlu_plain(a, ref_dc),
                    lambda: torch.matmul(a, ref_dc.mT).tril_())}
    if per_factor:
        calls["tri_da"] = (tri_cuda.tri_da, lambda: tri_cuda.tri_da(lu, dc),
                           lambda: tri_cuda.tri_da_plain(lu, ref_dc),
                           lambda: torch.matmul(lu, ref_dc))
        # one cuBLAS call (f32, TF32 off) on dc formed by one multiply, with
        # the tril it implies
        calls["tri_da_from_c"] = (
            tri_cuda.tri_da_from_c, lambda: tri_cuda.tri_da_from_c(lu, c, gout),
            lambda: tri_cuda.tri_da_from_c_plain(lu, c, gout),
            lambda: torch.matmul(lu.tril(), c * (2 * gout)[:, None, :]))
    else:
        # one cuBLAS call (f32, TF32 off) on dc formed by one multiply, with
        # the tril it implies
        calls["tri_dlu_from_c"] = (
            tri_cuda.tri_dlu_from_c, lambda: tri_cuda.tri_dlu_from_c(a, c, gout),
            lambda: tri_cuda.tri_dlu_from_c_plain(a, c, gout),
            lambda: torch.matmul(a, (c * (2 * gout)[:, None, :]).mT).tril_())
    bounds = {name: bound(bytes_moved, 3 * flops, TF32_TC_FLOP_PER_S,
                          "operations (3xTF32 tensor cores)")
              for name, (bytes_moved, flops) in _tri_bwd_bounds(L, M, B, per_factor).items()}
    bounds["tri_dc_from_c"] = bound(*_scale_bound(L, M, B))
    for name, (bound_ms, bound_by) in bounds.items():
        if name not in calls:
            continue
        wrapper, kernel, plain, library = calls[name]
        t = timings[name] = dict(
            shape=[L, M, B], max_abs_err=err[name], ms=median_ms(kernel, 5),
            plain_ms=median_ms(plain, 3), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None if library is None else median_ms(library, 3))
        if name == "tri_dc_from_c":
            t["layout_bound_ms"] = bound(_scale_layout_bytes(L, M, B), 0)[0]
        if device:
            ms, count = device_ms(kernel, TRI_DEVICE_REPS, wrapper)
            _log_device(t, ms, count, f"{name} {label}", TRI_DEVICE_REPS)
            if name == "tri_dc_from_c" and ms is not None:
                log(f"  {name} {label}: the bytes of its layout (hi and lo rows) take "
                    f"{t['layout_bound_ms']:.4f} ms, "
                    f"{t['layout_bound_ms'] / ms:.1%} of the device time")
        torch.cuda.empty_cache()


def _tri_t_bwd_case(checks, dev, g, L, M, B, label, per_factor, timings=None,
                    device=False):
    """Kernel 2's backward (JAX's ``_tri_bwd``) on the card: ``tri_t_matmul``
    on CUDA tensors has a grad_fn, and its dLu (exact zeros above the
    diagonal) and da match ``tri_t_matmul_bwd_plain`` at TOL_TRI; the split
    of the cotangent (``tri_split``, with gᵀ) equals ``tri_split_plain`` bit
    for bit. With ``timings``: the backward run twice gives the same bits;
    the split's call time (and with ``device``, its device time), plain time
    and bound go into timings["tri_split"], and the whole backward (split,
    kernels 6 and 7) is timed against the plain panels beside its bound."""
    import torch
    from gpzoo_tpu_torch.ops import tri_cuda

    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / math.sqrt(M)
    a = torch.randn((L, M, B) if per_factor else (M, B), generator=g, device=dev)
    gout = torch.randn((L, M, B), generator=g, device=dev)
    lu_k, a_k = lu.clone().requires_grad_(), a.clone().requires_grad_()
    c = tri_cuda.tri_t_matmul(lu_k, a_k)
    checks.true(f"tri_t_matmul {label}: a CUDA result has a grad_fn", c.grad_fn is not None)
    c.backward(gout)
    del c
    ref = tri_cuda.tri_t_matmul_bwd_plain(lu, a, gout)
    for what, got, want in (("dLu", lu_k.grad, ref[0]), ("da", a_k.grad, ref[1])):
        checks.le(f"tri_t_matmul backward {what} {label}", norm_err(got, want), TOL_TRI)
    upper = torch.ones((M, M), dtype=torch.bool, device=dev).triu(1)
    checks.true(f"tri_t_matmul backward {label}: exact zeros above dLu's diagonal",
                bool((lu_k.grad[:, upper] == 0).all()))
    del upper, ref
    op, op_plain = tri_cuda.tri_split(gout, True), tri_cuda.tri_split_plain(gout, True)
    checks.true(f"tri_split {label}: rows and rows_t equal to tri_split_plain's, bit for bit",
                bool(torch.equal(op.rows, op_plain.rows))
                and bool(torch.equal(op.rows_t, op_plain.rows_t)))
    err = float((op.rows - op_plain.rows).abs().max())
    del op, op_plain
    torch.cuda.synchronize()
    if timings is None:
        return
    again = tri_cuda.tri_t_matmul_bwd(lu, a, gout)
    checks.true(f"tri_t_matmul backward {label}: a rerun gives the same bits",
                bool(torch.equal(again[0], lu_k.grad)) and bool(torch.equal(again[1], a_k.grad)))
    del again, lu_k, a_k
    torch.cuda.empty_cache()
    # the split as a function: g read once, its hi and lo parts written once as
    # rows and once as rows_t (the padding is the layout's, not counted)
    bound_ms, bound_by = bound(4 * L * M * B * 5, 6 * L * M * B)
    t = timings["tri_split"] = dict(
        shape=[L, M, B], max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
        ms=median_ms(lambda: tri_cuda.tri_split(gout, True), 5),
        plain_ms=median_ms(lambda: tri_cuda.tri_split_plain(gout, True), 3), library_ms=None)
    if device:
        ms, count = device_ms(lambda: tri_cuda.tri_split(gout, True), TRI_DEVICE_REPS,
                              tri_cuda.tri_split)
        _log_device(t, ms, count, f"tri_split {label}", TRI_DEVICE_REPS)
    torch.cuda.empty_cache()
    lu_bytes, a_bytes = 4 * L * M * (M + 1) // 2, 4 * (L if per_factor else 1) * M * B
    whole_ms, whole_by = bound(2 * lu_bytes + 2 * a_bytes + 4 * L * M * B,
                               2 * 3 * L * B * M * (M + 1), TF32_TC_FLOP_PER_S,
                               "operations (3xTF32 tensor cores)")
    ms = median_ms(lambda: tri_cuda.tri_t_matmul_bwd(lu, a, gout), 3)
    plain_ms = median_ms(lambda: tri_cuda.tri_t_matmul_bwd_plain(lu, a, gout), 3)
    log(f"  time tri_split {label}: call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); the whole backward (split, kernels 6 and "
        f"7) {ms:.3f} ms, plain panels {plain_ms:.3f} ms, bound {whole_ms:.3f} ms "
        f"({whole_by})")
    torch.cuda.empty_cache()


def _kl_trace_bounds(L, M, form):
    """{entry: (bytes, FLOP, FLOP/s, resource)} of kernel 8's entries: the
    forward reads K⁻¹ once (whole: its two triangles make K_s) and Lu's lower
    triangle once and writes the trace (L,), the forward keeping P writes P's
    lower triangle too (nothing above the diagonal is written); the exact
    triangle, output i >= j and contraction k >= j, M(M+1)(2M+1)/3 FLOP a
    factor (about 2/3 M³), three TF32 products each; the recomputing
    backward reads K⁻¹, Lu and g and writes dLu whole, its FLOP for one Lu
    under a per-factor K⁻¹ only once (K_c = Σ_l g_l K_s,l); the scale pass
    reads P's lower triangle and g and writes dLu whole, M(M+1)/2 f32
    multiplies a factor. The kernels' staging (LuT, K_s hi and lo) and
    partial sums are their design and not counted."""
    l_k = 1 if form == "shared" else L
    l_lu = 1 if form == "one Lu" else L
    flops = M * (M + 1) * (2 * M + 1) // 3
    k_bytes, lu_bytes, full = 4 * l_k * M * M, 4 * l_lu * M * (M + 1) // 2, 4 * l_lu * M * M
    tc = (TF32_TC_FLOP_PER_S, "operations (3xTF32 tensor cores)")
    return {"tri_kl_trace": (k_bytes + lu_bytes + 4 * L, 3 * L * flops) + tc,
            "tri_kl_trace_p": (k_bytes + 2 * lu_bytes + 4 * L, 3 * L * flops) + tc,
            "tri_kl_trace_scale": (lu_bytes + 4 * L + full, L * M * (M + 1) // 2,
                                   F32_FLOP_PER_S, "operations (f32)"),
            "tri_kl_trace_bwd": (k_bytes + lu_bytes + 4 * L + full, 3 * l_lu * flops) + tc}


def _kl_trace_operands(g, dev, L, M, form):
    """K⁻¹ and Lu of a kernel 8 case: K⁻¹ = W·Wᵀ/M + I plus a part that is
    not symmetric (0.1/√M·N(0, 1)), (M, M) for ``form`` "shared", else
    (L, M, M); Lu lower-triangular N(0, 1/M), (L, M, M), or (1, M, M) for
    "one Lu" (one Lu under a per-factor K⁻¹)."""
    import torch

    k_shape = (M, M) if form == "shared" else (L, M, M)
    w = torch.randn(k_shape, generator=g, device=dev)
    k_inv = (torch.matmul(w, w.mT) / M + torch.eye(M, device=dev)
             + 0.1 / math.sqrt(M) * torch.randn(k_shape, generator=g, device=dev))
    del w
    lu = torch.tril(torch.randn((1 if form == "one Lu" else L, M, M), generator=g,
                                device=dev)) / math.sqrt(M)
    return k_inv, lu


def _kernels_a_call(fn, tries=3):
    """The names of the CUDA kernels one call of ``fn`` launches, from a
    profile (copies and fills left out), after one call unprofiled. A
    profile that recorded no kernel at all is taken again, up to ``tries``
    in all: the profiler has been seen (H100 80GB HBM3) to record no kernel
    for one call of kernel 8's scale pass, a lone short kernel that the
    Function's profile in the same check did record. A call that launches
    none still gives an empty list."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if names:
            break
    return names


def _trace_p_into(k_inv, lu, p):
    """Kernel 8 keeping P through its C entry (``tri_kl_trace_f32``, as
    ``tri_cuda`` calls it) into the caller's P buffer (L, M, M), for a
    per-factor Lu and a contiguous K⁻¹; returns the trace (L,)."""
    import torch
    from gpzoo_tpu_torch.ops import _build, tri_cuda

    l_dim, m_dim = p.shape[0], p.shape[1]
    l_k = k_inv.shape[0] if k_inv.ndim == 3 else 1
    mp = tri_cuda.padded(m_dim)
    # room for either layout: LuT or Lu's staged rows, K_s hi and lo, the partials
    scratch = torch.empty((l_dim + 2 * l_k) * mp * mp + 2 * l_dim * tri_cuda._pairs(m_dim),
                          dtype=torch.float32, device=lu.device)
    out = torch.empty((l_dim,), dtype=torch.float32, device=lu.device)
    tickets = _build.tickets(lu.device, l_dim + 2, "tri_kl_trace_f32")
    _build.check(tri_cuda._entry("tri_kl_trace_f32", tri_cuda._TRACE_ARGTYPES)(
        k_inv.data_ptr(), lu.data_ptr(), out.data_ptr(), p.data_ptr(), tickets.data_ptr(),
        l_dim, m_dim, l_k, l_dim, scratch.data_ptr(), tri_cuda._stream(lu)), "tri_kl_trace_f32")
    return out


def _kl_trace_case(checks, dev, g, L, M, form, label, timings=None, device=False):
    """Kernel 8 on the card against its closed forms at TOL_TRI, each entry
    rerun bit for bit: the forward (``tri_kl_trace_plain``) and the
    recomputing backward (``tri_kl_trace_bwd_plain``, its buffer handed
    NaN-filled memory first: exact zeros above the diagonal); where Lu is per
    factor, the forward keeping P (the trace and P's lower triangle against
    ``tri_kl_trace_p_plain``, the trace the forward's bits; into a P filled
    with NaN, its upper triangle left so; from an Lu with NaN above its
    diagonal, the same bits) and the scale pass from it (dLu the
    recompute's bits, exact zeros above the diagonal from P's NaN); through
    :class:`TriKLTrace` (Lu and K⁻¹ trained), dLu and dK⁻¹ against autograd
    of the closed form. With ``timings``: each entry's call (and with
    ``device``, device) time, its closed form's, the bound, the library call
    (the forward's one-call einsum; the scale pass's one ``torch.mul`` of P
    by 2g, the same bytes, not dLu above the diagonal), each way's and the
    Function's kernels a call counted by the profiler, and forward and
    backward under autograd beside the panel form's and the einsum's."""
    import torch
    from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

    k_inv, lu = _kl_trace_operands(g, dev, L, M, form)
    gout = torch.randn((L,), generator=g, device=dev)
    keeps = form != "one Lu"  # the Function keeps P for a per-factor Lu
    upper = torch.ones((M, M), dtype=torch.bool, device=dev).triu(1)
    out = tri_cuda.tri_kl_trace_fwd(k_inv, lu)
    ref = tri_cuda.tri_kl_trace_plain(k_inv, lu)
    err = {"tri_kl_trace": float((out - ref).abs().max())}
    checks.le(f"tri_kl_trace {label}", norm_err(out, ref), TOL_TRI)
    checks.true(f"tri_kl_trace {label}: a rerun gives the same bits",
                bool(torch.equal(tri_cuda.tri_kl_trace_fwd(k_inv, lu), out)))
    del ref
    torch.full(lu.shape, math.nan, device=dev)  # freed: the backward's buffer reuses it
    dlu = tri_cuda.tri_kl_trace_bwd(k_inv, lu, gout)
    ref = tri_cuda.tri_kl_trace_bwd_plain(k_inv, lu, gout)
    err["tri_kl_trace_bwd"] = float((dlu - ref).abs().max())
    checks.le(f"tri_kl_trace_bwd {label}", norm_err(dlu, ref), TOL_TRI)
    checks.true(f"tri_kl_trace_bwd {label}: exact zeros above the diagonal",
                bool((dlu[:, upper] == 0).all()))
    checks.true(f"tri_kl_trace_bwd {label}: a rerun gives the same bits",
                bool(torch.equal(tri_cuda.tri_kl_trace_bwd(k_inv, lu, gout), dlu)))
    p = None
    if keeps:
        torch.full((L, M, M), math.nan, device=dev)  # freed: P's buffer reuses it
        trace_p, p = tri_cuda.tri_kl_trace_fwd_p(k_inv, lu)
        ref_trace, ref_p = tri_cuda.tri_kl_trace_p_plain(k_inv, lu)
        lower = ~upper
        # P is written below and on the diagonal only: its upper triangle
        # keeps the NaN it was handed
        p_low = p[:, lower]
        err["tri_kl_trace_p"] = float((p_low - ref_p[:, lower]).abs().max())
        checks.le(f"tri_kl_trace_p {label}: the trace", norm_err(trace_p, ref_trace), TOL_TRI)
        checks.le(f"tri_kl_trace_p {label}: P's lower triangle",
                  norm_err(p_low, ref_p[:, lower]), TOL_TRI)
        del ref_trace, ref_p
        checks.true(f"tri_kl_trace_p {label}: the trace has the forward's bits",
                    bool(torch.equal(trace_p, out)))
        # the C entry into a P filled with NaN: nothing is written above its
        # diagonal, the wrapper's bits below it
        p_nan = torch.full((L, M, M), math.nan, device=dev)
        trace_n = _trace_p_into(k_inv, lu, p_nan)
        checks.true(f"tri_kl_trace_p {label}: nothing written above P's diagonal (NaN as "
                    f"handed), the same bits below it",
                    bool(torch.isnan(p_nan[:, upper]).all())
                    and bool(torch.equal(p_nan[:, lower], p_low))
                    and bool(torch.equal(trace_n, trace_p)))
        del trace_n
        again = tri_cuda.tri_kl_trace_fwd_p(k_inv, lu)
        checks.true(f"tri_kl_trace_p {label}: a rerun gives the same bits",
                    bool(torch.equal(again[0], trace_p))
                    and bool(torch.equal(again[1][:, lower], p_low)))
        del again
        # Lu is read as lower-triangular: NaN above its diagonal (and so in
        # the rows past a factor's M that a map without a slab a factor
        # would read from the next factor) changes no bit
        lu_nan = lu.masked_fill(upper, math.nan)
        again = tri_cuda.tri_kl_trace_fwd_p(k_inv, lu_nan)
        checks.true(f"tri_kl_trace_p {label}: NaN above Lu's diagonal, the same bits",
                    bool(torch.equal(again[0], trace_p))
                    and bool(torch.equal(again[1][:, lower], p_low)))
        del again, lu_nan, trace_p, p_low
        torch.full((L, M, M), math.nan, device=dev)  # freed: dLu's buffer reuses it
        scaled = tri_cuda.tri_kl_trace_scale(p, gout)
        err["tri_kl_trace_scale"] = float((scaled - ref).abs().max())
        checks.le(f"tri_kl_trace_scale {label}", norm_err(scaled, ref), TOL_TRI)
        checks.true(f"tri_kl_trace_scale {label}: dLu has the recompute's bits",
                    bool(torch.equal(scaled, dlu)))
        # from the P with NaN above its diagonal: exact zeros there
        scaled_n = tri_cuda.tri_kl_trace_scale(p_nan, gout)
        checks.true(f"tri_kl_trace_scale {label}: from P's NaN above the diagonal, exact "
                    f"zeros there and the recompute's bits",
                    bool((scaled_n[:, upper] == 0).all()) and bool(torch.equal(scaled_n, dlu)))
        checks.true(f"tri_kl_trace_scale {label}: a rerun gives the same bits",
                    bool(torch.equal(tri_cuda.tri_kl_trace_scale(p, gout), scaled)))
        del scaled, scaled_n, p_nan, lower
    del out, dlu, ref, upper
    if M <= 1100:  # autograd of the closed form holds several (L, M, M) products
        got, want = {}, {}
        for into, fn in ((got, tri_cuda.tri_kl_trace), (want, tri_cuda.tri_kl_trace_plain)):
            k_g, lu_g = k_inv.clone().requires_grad_(), lu.clone().requires_grad_()
            fn(k_g, lu_g).backward(gout)
            into.update(dLu=lu_g.grad, dK=k_g.grad)
        checks.le(f"TriKLTrace dLu {label}", norm_err(got["dLu"], torch.tril(want["dLu"])),
                  TOL_TRI)
        checks.le(f"TriKLTrace dK⁻¹ {label}", norm_err(got["dK"], want["dK"]), TOL_TRI)
        del got, want
    torch.cuda.synchronize()
    if timings is None:
        return
    spec = "ij,ljk,lik->l" if form == "shared" else "lij,ljk,lik->l"
    lu_e = lu.expand(L, M, M)
    calls = {
        "tri_kl_trace": (tri_cuda.tri_kl_trace_fwd, lambda: tri_cuda.tri_kl_trace_fwd(k_inv, lu),
                         lambda: tri_cuda.tri_kl_trace_plain(k_inv, lu),
                         lambda: torch.einsum(spec, k_inv, lu_e, lu_e)),
        "tri_kl_trace_bwd": (tri_cuda.tri_kl_trace_bwd,
                             lambda: tri_cuda.tri_kl_trace_bwd(k_inv, lu, gout),
                             lambda: tri_cuda.tri_kl_trace_bwd_plain(k_inv, lu, gout), None)}
    if keeps:
        g2 = (2 * gout)[:, None, None]
        calls.update({
            "tri_kl_trace_p": (tri_cuda.tri_kl_trace_fwd_p,
                               lambda: tri_cuda.tri_kl_trace_fwd_p(k_inv, lu),
                               lambda: tri_cuda.tri_kl_trace_p_plain(k_inv, lu), None),
            "tri_kl_trace_scale": (tri_cuda.tri_kl_trace_scale,
                                   lambda: tri_cuda.tri_kl_trace_scale(p, gout),
                                   lambda: tri_cuda.tri_kl_trace_scale_plain(p, gout),
                                   lambda: torch.mul(p, g2))})
    bounds = _kl_trace_bounds(L, M, form)
    for name, (wrapper, kernel, plain, library) in calls.items():
        bound_ms, bound_by = bound(*bounds[name])
        t = timings[name] = dict(
            shape=[L, M, form], max_abs_err=err[name], ms=median_ms(kernel, 5),
            plain_ms=median_ms(plain, 3), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None if library is None else median_ms(library, 3),
            kernels_a_call=len(_kernels_a_call(kernel)))
        if device:
            ms, count = device_ms(kernel, TRI_DEVICE_REPS, wrapper)
            _log_device(t, ms, count, f"{name} {label}", TRI_DEVICE_REPS)
        torch.cuda.empty_cache()
    # each way's kernels a call, and the Function's with Lu trained: the
    # forward keeping P and the scale pass where P is kept, else the
    # forward and the recompute
    fwd, bwd = ("tri_kl_trace_p", "tri_kl_trace_scale") if keeps else (
        "tri_kl_trace", "tri_kl_trace_bwd")
    lu_g = lu.clone().requires_grad_()

    def function():
        tri_cuda.tri_kl_trace(k_inv, lu_g).backward(gout)
        lu_g.grad = None
    function = _kernels_a_call(function)
    del lu_g
    log(f"  kernel 8 {label}, kernels a call: forward {timings[fwd]['kernels_a_call']}, "
        f"backward {timings[bwd]['kernels_a_call']}; the Function under autograd "
        f"{len(function)} ({', '.join(n[:40] for n in function)})")
    # the forward keeping P stages K_s, then runs the persistent kernel, with
    # Lu's rows staged between them where a row is off 16 bytes (M % 4 != 0)
    fwd_kernels = 3 if keeps and M % 4 else 2
    checks.true(f"kernel 8 {label}: {fwd_kernels} kernels a forward, 1 a backward from P (2 "
                f"recomputing), {fwd_kernels + 1} for the Function "
                f"({timings[fwd]['kernels_a_call']}, {timings[bwd]['kernels_a_call']}, "
                f"{len(function)})",
                timings[fwd]["kernels_a_call"] == fwd_kernels
                and timings[bwd]["kernels_a_call"] == (1 if keeps else 2)
                and len(function) == fwd_kernels + (1 if keeps else 2))
    del p
    torch.cuda.empty_cache()
    # forward and backward under autograd, Lu trained (and K⁻¹ where it is
    # per factor): kernel 8, the panel form (the route before it) and the
    # one-call einsum
    fwd_bwd = {}
    for what, fn in (("kernels", tri_cuda.tri_kl_trace), ("panels", tri_blocked.tri_kl_trace),
                     ("einsum", lambda k, u: torch.einsum(spec, k, u.expand(L, M, M),
                                                          u.expand(L, M, M)))):
        k_g, lu_g = k_inv.clone().requires_grad_(form != "shared"), lu.clone().requires_grad_()

        def both(fn=fn, k_g=k_g, lu_g=lu_g):
            fn(k_g, lu_g).backward(gout)
            lu_g.grad = k_g.grad = None
        fwd_bwd[what] = median_ms(both, 3)
        del k_g, lu_g
        torch.cuda.empty_cache()
    timings["tri_kl_trace"]["fwd_bwd_ms"] = fwd_bwd
    log(f"  time kernel 8 forward+backward {label} under autograd: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in fwd_bwd.items()))


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
    ([snapshot]): Kzz and Kzx of every factor, at the held-out spots (the
    snapshots) and at a block of extract_factors' spots."""
    return [("NSF posterior Kzz", (MAIN["L"], MAIN["M"], MAIN["M"]), 2),
            ("NSF posterior Kzx", (MAIN["L"], MAIN["M"], HOLDOUT), 2),
            ("NSF extract_factors Kzx", (MAIN["L"], MAIN["M"], EXTRACT_CHUNK), 2)]


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


def _mggp_args(g, dev, n, m, l_dim, n_groups, convention, input_dim=2):
    """Kernel 4's operands: x (n, 2), z (m, 2), the complete-graph embedding
    of n_groups gathered by random labels, α under ``convention`` (negative
    raw values for ABS and SQUARED), p = ``input_dim``."""
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
                sign * torch.linspace(0.2, 2.5, l_dim, device=dev)), input_dim)


def _mggp_case(checks, dev, g, n, m, l_dim, n_groups, convention, label,
               timings=None, tail=None, input_dim=2):
    """Kernel 4 against its plain version on :func:`_mggp_args`. With
    ``tail`` only the last ``tail`` columns are held against the plain
    version (the plain form of a 10 GB Gram would not fit beside it). With
    ``timings``, its time, the plain version's and the bound go into
    timings["mggp_gram"]."""
    from gpzoo_tpu_torch.ops import mggp_cuda

    args = _mggp_args(g, dev, n, m, l_dim, n_groups, convention, input_dim)
    x, z, ex, ez = args[:4]
    out = mggp_cuda.mggp_gram_fwd(*args)
    if tail:
        out = out[..., -tail:]
        ref = mggp_cuda.mggp_gram_plain(x, z[-tail:], ex, ez[-tail:], *args[4:])
    else:
        ref = mggp_cuda.mggp_gram_plain(*args)
    checks.le(f"mggp_gram {label} {convention} p={input_dim}", norm_err(out, ref), TOL_GRAM)
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


def _gram_bwd_bound(l_dim, n, m, dim):
    """Kernel 3's backward as a function: g and k read once, the coordinates
    and σ, ℓ read and the four gradients written once; ~5 FLOP an element of
    g (g·k, two sums, w) and 7 a coordinate of a pair (d², dx, dz)."""
    return bound(4 * (2 * l_dim * n * m + 2 * (n + m) * dim + 4 * l_dim),
                 5 * l_dim * n * m + 7 * dim * n * m)


def _gram_bwd_case(checks, dev, g, l_dim, n, m, label, dim=2, timings=None, device=False):
    """Kernel 3's backward kernel (``gram_cuda.rbf_gram_bwd``) against its
    closed form (``rbf_gram_bwd_plain``) on the kernel's k, all four
    gradients, then the differentiable Gram (kernel forward, kernel
    backward) against autograd through the plain form. With ``timings``:
    the backward run twice must give the same bits, its call time (and with
    ``device``, its device time), the closed form's time and the bound go
    into timings[(L, N, M)], and the forward and backward are timed against
    the plain form under autograd."""
    import torch
    from gpzoo_tpu_torch.ops import gram_cuda

    inputs = _gram_inputs(g, dev, l_dim, n, m, dim)
    gout = torch.randn((l_dim, n, m), generator=g, device=dev)
    k = gram_cuda.rbf_gram_fwd(*inputs)
    got = gram_cuda.rbf_gram_bwd(gout, *inputs, k)
    closed = gram_cuda.rbf_gram_bwd_plain(gout, *inputs, k)
    shape = f"{label} L={l_dim} {n}x{m} D={dim}"
    for what, a, b in zip(("dx", "dz", "dsigma", "dell"), got, closed):
        checks.le(f"rbf_gram_bwd {what} {shape}, vs the closed form", norm_err(a, b),
                  TOL_GRAM_BWD)

    def grads(gram):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        return torch.autograd.grad(gram(*leaves), leaves, gout)

    auto_k, ref = grads(gram_cuda.rbf_gram), grads(gram_cuda.rbf_gram_plain)
    for what, a, b in zip(("dx", "dz", "dsigma", "dell"), auto_k, ref):
        checks.le(f"rbf_gram backward {what} {shape}, vs autograd of the plain form",
                  norm_err(a, b), TOL_GRAM_BWD)
    del auto_k, ref
    if timings is None:
        return
    again = gram_cuda.rbf_gram_bwd(gout, *inputs, k)
    checks.true(f"rbf_gram_bwd {shape}: a rerun gives the same bits",
                all(bool(torch.equal(a, b)) for a, b in zip(got, again)))
    bound_ms, bound_by = _gram_bwd_bound(l_dim, n, m, dim)
    t = timings[(l_dim, n, m)] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, closed)),
        ms=median_ms(lambda: gram_cuda.rbf_gram_bwd(gout, *inputs, k), 20),
        plain_ms=median_ms(lambda: gram_cuda.rbf_gram_bwd_plain(gout, *inputs, k), 10),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    if device:
        ms, count = device_ms(lambda: gram_cuda.rbf_gram_bwd(gout, *inputs, k), DEVICE_REPS,
                              gram_cuda.rbf_gram_bwd)
        _log_device(t, ms, count, f"rbf_gram_bwd {shape}")
    fb_ms = median_ms(lambda: grads(gram_cuda.rbf_gram), 10)
    fb_plain_ms = median_ms(lambda: grads(gram_cuda.rbf_gram_plain), 10)
    log(f"  time rbf_gram_bwd {shape}: call {t['ms']:.4f} ms, closed form "
        f"{t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / t['ms']:.1%} of bound; forward+backward (kernels) {fb_ms:.4f} ms, "
        f"plain under autograd {fb_plain_ms:.4f} ms")


def graph_kernel_nodes(fn):
    """(kernel nodes, all nodes) of a CUDA graph that captured one call of
    ``fn``, read back through libcuda (cuGraphGetNodes, cuGraphNodeGetType)."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    return sum(kind == 0 for kind in kinds), len(kinds)  # CU_GRAPH_NODE_TYPE_KERNEL = 0


def _gram_bwd_layout_case(checks, dev, g, l_dim, n, m):
    """Kernel 3's backward with the cotangent's planes stored transposed (as
    the SVGP's cholesky_solve hands Kzx's back): read in place, no copy, the
    same bits as with the contiguous cotangent; and one kernel node a call."""
    import torch
    from gpzoo_tpu_torch.ops import gram_cuda

    inputs = _gram_inputs(g, dev, l_dim, n, m)
    gout = torch.randn((l_dim, n, m), generator=g, device=dev)
    gout_t = gout.mT.contiguous().mT
    k = gram_cuda.rbf_gram_fwd(*inputs)
    copies = gram_cuda.rbf_gram_bwd.copies
    got = gram_cuda.rbf_gram_bwd(gout_t, *inputs, k)
    want = gram_cuda.rbf_gram_bwd(gout, *inputs, k)
    shape = f"L={l_dim} {n}x{m}"
    checks.true(f"rbf_gram_bwd {shape}, cotangent's planes transposed: read in place "
                f"({gram_cuda.rbf_gram_bwd.copies - copies} copies)",
                gram_cuda.rbf_gram_bwd.copies == copies)
    checks.true(f"rbf_gram_bwd {shape}, cotangent's planes transposed: the same bits as "
                f"contiguous", all(bool(torch.equal(a, b)) for a, b in zip(got, want)))
    kernels, nodes = graph_kernel_nodes(lambda: gram_cuda.rbf_gram_bwd(gout_t, *inputs, k))
    checks.true(f"rbf_gram_bwd {shape}: one kernel node a call ({kernels} kernel of "
                f"{nodes} nodes)", kernels == 1)


MGGP_LEAVES = ("x", "z", "ex", "ez", "sigma", "lengthscale", "alpha_eff")
# the gradients kernel 4's backward gives on the paths: [mggp] trains σ, ℓ,
# α and the embedding with Z frozen; the Hybrid-MGGP leg and the warm start's
# fine-tune train Z with the kernel frozen (Kzz = k(Z, Z), Kzx = k(Z, X))
MGGP_NEEDS = (False, False, True, True, True, True, True)


def z_needs(label):
    return (True, label == "Kzz") + (False,) * 5


def _mggp_bwd_operands(g, dev, n, m, l_dim, n_groups, kzz, input_dim):
    """:func:`_mggp_args` under the SQUARED convention; for ``kzz`` (m = n)
    z is x and ez is ex, as in Kzz = k(Z, Z)."""
    args = _mggp_args(g, dev, n, m, l_dim, n_groups, "SQUARED", input_dim)
    if kzz:
        args = (args[0], args[0], args[2], args[2], *args[4:])
    return args[:7], args[7]


def _mggp_bwd_bound(n, m, l_dim, e_dim, needs):
    """The backward's bound for the gradients ``needs``: the cotangent read
    once and the planes dd², dg² it writes; ~20 FLOP an element of the
    cotangent and 3 a coordinate of a pair."""
    planes = int(needs[0] or needs[1]) + int(needs[2] or needs[3])
    return bound(4 * (l_dim * n * m + planes * n * m + (n + m) * (2 + e_dim) + 6 * l_dim),
                 l_dim * n * m * 20 + n * m * 3 * (2 + e_dim))


def _mggp_bwd_case(checks, dev, g, n, m, l_dim, n_groups, label, kzz=False, input_dim=2,
                   path_needs=None):
    """Kernel 4's backward kernel (``mggp_cuda.mggp_gram_bwd``) against the
    closed form in plain PyTorch (``mggp_gram_bwd_plain``) and against
    autograd of ``mggp_gram_plain``, all seven gradients for a random
    cotangent. With ``path_needs``, the gradients the path asks for at this
    shape: the backward's call time with them beside its bound and the
    closed form's time, then the forward and backward as the path runs them
    (one leaf for Kzz's x and z) against the plain form under autograd.
    Returns (timings, the operands' spec for the device phase) or None."""
    import torch
    from gpzoo_tpu_torch.ops import mggp_cuda

    ops, p = _mggp_bwd_operands(g, dev, n, m, l_dim, n_groups, kzz, input_dim)
    gout = torch.randn((l_dim, n, m), generator=g, device=dev)
    got = mggp_cuda.mggp_gram_bwd(gout, *ops, p)
    closed = mggp_cuda.mggp_gram_bwd_plain(gout, *ops, p)
    leaves = [t.detach().clone().requires_grad_() for t in ops]
    auto = torch.autograd.grad(mggp_cuda.mggp_gram_plain(*leaves, p), leaves, gout)
    del leaves
    for name, a, b, c in zip(MGGP_LEAVES, got, closed, auto):
        checks.le(f"mggp_gram_bwd d{name} {label} L={l_dim} {n}x{m} p={p}, vs the closed "
                  "form", norm_err(a, b), TOL_GRAM_BWD)
        checks.le(f"mggp_gram_bwd d{name} {label} L={l_dim} {n}x{m} p={p}, vs autograd of "
                  "the plain form", norm_err(a, c), TOL_GRAM_BWD)
    err = max(float((a - b).abs().max()) for a, b in zip(got, closed))
    del got, closed, auto
    if path_needs is None:
        return None
    needs = tuple(path_needs)
    ms = median_ms(lambda: mggp_cuda.mggp_gram_bwd(gout, *ops, p, needs), 20)
    plain_ms = median_ms(lambda: mggp_cuda.mggp_gram_bwd_plain(gout, *ops, p, needs), 5)
    bound_ms, bound_by = _mggp_bwd_bound(n, m, l_dim, ops[2].shape[1], needs)
    # the two finishes of the planes' gradients on the planes the path writes:
    # the card's (one pass over a plane a side) and the closed form's (two)
    planes = [(ops[i], ops[i + 1], w, needs[i], needs[i + 1]) for w, i in
              zip(mggp_cuda.mggp_gram_bwd_planes(gout, *ops, p, needs)[:2], (0, 2))
              if w is not None]
    finish_ms = [median_ms(lambda: [finish(*plane) for plane in planes], 20)
                 for finish in (mggp_cuda._from_plane_fused, mggp_cuda._from_plane)]
    del planes

    def fwd_bwd(gram):
        leaves = [t.detach().clone().requires_grad_(need) for t, need in zip(ops, needs)]
        if kzz:
            leaves[1] = leaves[0]
        wanted = [t for i, t in enumerate(leaves) if needs[i] and not (kzz and i == 1)]
        return torch.autograd.grad(gram(*leaves, p), wanted, gout)

    fb_ms = median_ms(lambda: fwd_bwd(mggp_cuda.mggp_gram), 5)
    fb_plain_ms = median_ms(lambda: fwd_bwd(mggp_cuda.mggp_gram_plain), 5)
    asked = ", ".join(name for name, need in zip(MGGP_LEAVES, needs) if need)
    log(f"  time mggp_gram_bwd {label} (the path's gradients: {asked}): call {ms:.4f} ms, "
        f"closed form {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.1%} of bound; forward+backward as the path runs them "
        f"{fb_ms:.3f} ms, plain under autograd {fb_plain_ms:.3f} ms; the planes' finish "
        f"{finish_ms[0]:.4f} ms, as the closed form finishes them {finish_ms[1]:.4f} ms")
    timings = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
    return timings, (n, m, l_dim, n_groups, kzz, input_dim, needs)


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


def block_bwd_flops(k):
    """FLOPs of one point of kernel 5's backward: the Cholesky, four
    substitutions (w and v), dw from (diff + diffᵀ)w (5K² + 2K), dkzz (4K²),
    ds (2K²) and dmu (K)."""
    return k ** 3 / 3 + k * (k - 1) / 2 + 15 * k * k + 3 * k


def _block_bwd_case(checks, dev, g, n, k, label, timings=None, device=False):
    """Kernel 5's backward kernel (``vnngp_cuda.block_conditional_bwd``)
    against its closed form (``block_conditional_bwd_plain``), then the
    differentiable conditioning (kernel forward, kernel backward) against
    autograd through the plain form, for every operand. With ``timings``:
    the backward run twice must give the same bits, its call time (and with
    ``device``, its device time), the closed form's time and the bound go
    into timings[(n, K)], and the forward and backward are timed against the
    plain form under autograd."""
    import torch
    from gpzoo_tpu_torch.ops import vnngp_cuda

    ops = _block_operands(g, dev, n, k)
    cot = (torch.randn((n,), generator=g, device=dev), torch.randn((n,), generator=g, device=dev))
    got = vnngp_cuda.block_conditional_bwd(*ops[:4], *cot, 0.1)
    closed = vnngp_cuda.block_conditional_bwd_plain(*ops[:4], *cot, 0.1)
    for what, a, b in zip(("dkzz", "ds", "dkxz", "dmu", "dkxx"), got, closed):
        checks.le(f"block_conditional_bwd {what} {label} n={n} K={k}, vs the closed form",
                  norm_err(a, b), TOL_BLOCK)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ops]
        return torch.autograd.grad(fn(*leaves, 0.1), leaves, cot)

    auto_k = grads(vnngp_cuda.block_conditional)
    ref = grads(vnngp_cuda.block_conditional_plain)
    for what, a, b in zip(("dkzz", "ds", "dkxz", "dmu", "dkxx"), auto_k, ref):
        checks.le(f"block_conditional backward {what} {label} n={n} K={k}",
                  norm_err(a, b), TOL_BLOCK)
    del auto_k, ref
    if timings is None:
        return
    again = vnngp_cuda.block_conditional_bwd(*ops[:4], *cot, 0.1)
    checks.true(f"block_conditional_bwd {label}: a rerun gives the same bits",
                all(bool(torch.equal(a, b)) for a, b in zip(got, again)))
    # in: kzz, s, kxz, mu and both cotangents; out: dkzz, ds, dkxz, dmu (dkxx
    # is the cov cotangent itself)
    bound_ms, bound_by = bound(4 * n * (2 * k * k + 2 * k + 2) + 4 * n * (2 * k * k + 2 * k),
                               n * block_bwd_flops(k))
    t = timings[(n, k)] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, closed)),
        ms=median_ms(lambda: vnngp_cuda.block_conditional_bwd(*ops[:4], *cot, 0.1), 20),
        plain_ms=median_ms(lambda: vnngp_cuda.block_conditional_bwd_plain(*ops[:4], *cot,
                                                                          0.1), 5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    if device:
        ms, count = device_ms(lambda: vnngp_cuda.block_conditional_bwd(*ops[:4], *cot, 0.1),
                              DEVICE_REPS, vnngp_cuda.block_conditional_bwd)
        _log_device(t, ms, count, f"block_conditional_bwd {label} n={n} K={k}")
    ms = median_ms(lambda: grads(vnngp_cuda.block_conditional), 5)
    plain_ms = median_ms(lambda: grads(vnngp_cuda.block_conditional_plain), 5)
    log(f"  time block_conditional_bwd {label} n={n} K={k}: call {t['ms']:.4f} ms, closed "
        f"form {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / t['ms']:.1%} of bound; forward+backward (kernels) {ms:.3f} ms, "
        f"plain under autograd {plain_ms:.3f} ms")


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

    # kernel 1 keeping c and its backward (the scale pass, the dc epilogue,
    # kernels 6 and 7, and for a shared a kernel 6 reading c) at each path's
    # shape, timed; ragged and M = 1 untimed. The JSON line carries the
    # north-star shape (kernel 1 keeping c, the scale pass, dc, dLu, kernel 6
    # reading c) and the MGGP one (da).
    log("[kernels] kernel 1 keeping c and its backward: the scale pass, the dc epilogue, "
        "kernel 6 (dLu), kernel 6 reading c, kernel 7 (da)")
    _tri_bwd_case(checks, dev, g, 2, 257, 129, "per-factor a L=2 M=257 B=129", True)
    # kernel 7 reading c's register route off the tiles (a grid of more than
    # one wave): B % 4 = 3 (c's rows copied with the row stride Bp), M off the
    # 128 tile and off the 32-row stage
    _tri_bwd_case(checks, dev, g, 3, 1033, 1283, "per-factor a L=3 M=1033 B=1283", True)
    # kernel 6 reading c off the tiles: B % 4 = 1 and 2 (c's rows copied with
    # the row stride Bp), M off the 128 tile
    _tri_bwd_case(checks, dev, g, 2, 257, 129, "shared a L=2 M=257 B=129", False)
    _tri_bwd_case(checks, dev, g, 3, 130, 142, "shared a L=3 M=130 B=142", False)
    for per_factor in (False, True):
        _tri_bwd_case(checks, dev, g, 2, 1, 64, f"{'per-factor' if per_factor else 'shared'} "
                      "a L=2 M=1 B=64", per_factor)
    world = 2  # [parallel]'s ranks
    for leg, (l_dim, m, b), per_factor, device in (
            ("north-star", (MAIN["L"], MAIN["M"], MAIN["B"]), False, True),
            ("mggp", (MGGP["L"], m_mggp, MGGP["B"]), True, True),
            ("hybrid_mggp", (HYBRID_MGGP["L"], m_hm, HYBRID_MGGP["B"]), True, False),
            ("parallel factor rank", (MGGP["L"] // world, m_mggp, MGGP["B"]), True, False),
            ("parallel data rank", (MGGP["L"], m_mggp, MGGP["B"] // world), True, False),
            ("hybrid", (l_h, m_h, n_h), True, False)):
        t = {}
        _tri_bwd_case(checks, dev, g, l_dim, m, b, f"{'per-factor' if per_factor else 'shared'}"
                      f" a L={l_dim} M={m} B={b}", per_factor, t, device)
        _log_timings(t, f" (kernel 1's backward, the {leg} step's shape)")
        if leg == "north-star":
            timings.update(t)
        elif leg == "mggp":
            # kernel 7 and the scale pass at the shape of the paths that run them
            for name in ("tri_da", "tri_da_from_c", "tri_dc_from_c"):
                timings[name] = t[name]
        torch.cuda.empty_cache()

    # kernel 2's backward (JAX's _tri_bwd): the split of the cotangent, then
    # kernels 6 and 7, at the paths' shapes of kernels 1-2 (no path
    # differentiates c itself) and ragged ones; the JSON line carries the
    # split at the north-star shape
    log("[kernels] kernel 2's backward: tri_split, kernels 6 (dLu) and 7 (da)")
    for l_dim, m, b, per_factor in ((2, 1, 64, False), (2, 1, 64, True), (2, 257, 129, True),
                                    (1, 130, 33, False)):
        _tri_t_bwd_case(checks, dev, g, l_dim, m, b, f"{'per-factor' if per_factor else 'shared'}"
                        f" a L={l_dim} M={m} B={b}", per_factor)
    for leg, (l_dim, m, b), per_factor, device in (
            ("north-star", (MAIN["L"], MAIN["M"], MAIN["B"]), False, True),
            ("mggp", (MGGP["L"], m_mggp, MGGP["B"]), True, False),
            ("hybrid", (l_h, m_h, n_h), True, False)):
        t = {}
        _tri_t_bwd_case(checks, dev, g, l_dim, m, b, f"{'per-factor' if per_factor else 'shared'}"
                        f" a L={l_dim} M={m} B={b} ({leg})", per_factor, t, device)
        if leg == "north-star":
            timings["tri_split"] = t["tri_split"]
        torch.cuda.empty_cache()

    # kernel 8, the KL trace, each entry: ragged (M 1, 127, 129, 257, 1,025,
    # whose rows start at every offset from a 16-byte boundary; L 1, 2, 3;
    # the three forms) untimed, then the paths' shapes timed: the north-star
    # KL (the JSON line's), the VNNGP KL (one Lu, L = 1, M = 1,000: the
    # Function against the one-call einsum) and the VNNGP sweep's width with
    # L = 10, and the MGGP and Hybrid-MGGP widths with a per-factor K⁻¹
    # (their W-form KL takes no trace; timed for the form's sake)
    log("[kernels] kernel 8: the KL trace tr(K⁻¹·Lu·Luᵀ), P kept, and its backward")
    for l_dim, m, form in ((1, 1, "shared"), (3, 1, "per-factor"), (3, 127, "per-factor"),
                           (1, 129, "shared"), (3, 129, "one Lu"), (2, 257, "per-factor"),
                           (3, 1025, "shared"), (3, 1025, "one Lu")):
        _kl_trace_case(checks, dev, g, l_dim, m, form, f"{form} L={l_dim} M={m}")
    for leg, (l_dim, m), form, device in (
            ("north-star", (MAIN["L"], MAIN["M"]), "shared", True),
            ("vnngp", (1, vnngp["M"]), "shared", False),
            ("vnngp L=10", (vnngp["L"], vnngp["M"]), "shared", False),
            ("mggp", (MGGP["L"], m_mggp), "per-factor", True),
            ("hybrid_mggp", (HYBRID_MGGP["L"], m_hm), "per-factor", False)):
        t = {}
        _kl_trace_case(checks, dev, g, l_dim, m, form, f"{form} L={l_dim} M={m} ({leg})", t,
                       device)
        _log_timings(t, f" (kernel 8, the {leg} shape)")
        if leg == "north-star":
            timings.update(t)
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
    # kernel 3's backward where ℓ and Z train, timed at each shape: the
    # Hybrid-NSF step's Kzz and Kzx, the VNNGP all-trainable step's Kzz and
    # Kxz (the generic legs' below); ragged untimed: N = 1, M % 4 ≠ 0, D 1,
    # 3 and 8, L = 1
    log("[kernels] kernel 3's backward")
    for dim, l_dim, n, m in ((2, 1, 1, 1), (3, 2, 33, 1), (2, 3, 130, 150), (1, 1, 37, 1030),
                             (3, 2, 7, 1025), (8, 3, 129, 1023)):
        _gram_bwd_case(checks, dev, g, l_dim, n, m, "ragged", dim)
    # a grid of one block (one item), a grid whose items leave its last round
    # part-full, past 32 factors, and a cotangent with its planes transposed
    for dim, l_dim, n, m in ((2, 3, 16, 256), (2, 10, 5001, 998), (2, 37, 300, 270)):
        _gram_bwd_case(checks, dev, g, l_dim, n, m, "ragged plan", dim)
    _gram_bwd_layout_case(checks, dev, g, 4, 250, 800)
    _gram_bwd_layout_case(checks, dev, g, 3, 130, 150)
    gram_bwd = {}
    paths = dict((label, shape) for label, shape, _ in gram_path_shapes(vnngp))
    for label in ("hybrid Kzz", "hybrid Kzx", "VNNGP Kzz", "VNNGP step Kxz"):
        _gram_bwd_case(checks, dev, g, *paths[label], label, timings=gram_bwd, device=True)
        torch.cuda.empty_cache()

    # kernel 4 at the MGGP step's Kzz and Kzx, and ragged under each convention
    for convention in ("ABS", "RAW", "SQUARED"):
        _mggp_case(checks, dev, g, 300, 270, 3, 5, convention, "L=3 300x270 G=5")
    # ragged, p = 3 (den^-p/2 through the exponent) and E = 17 embedding columns
    _mggp_case(checks, dev, g, 300, 270, 37, 17, "SQUARED", "L=37 300x270 G=17",
               input_dim=3)
    _mggp_bwd_case(checks, dev, g, 300, 270, 37, 17, "ragged G=17", input_dim=3)
    t = {}
    _mggp_case(checks, dev, g, m_mggp, m_mggp, MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzz L={MGGP['L']} {m_mggp}x{m_mggp} G={MGGP['G']}", t)
    _log_timings(t, " (mggp Kzz)")
    _mggp_case(checks, dev, g, m_mggp, MGGP["B"], MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzx L={MGGP['L']} {m_mggp}x{MGGP['B']} G={MGGP['G']}", timings)
    # kernel 4's shapes for the device phase: (its _mggp_args, its timings)
    mggp = {"MGGP Kzx": ((m_mggp, MGGP["B"], MGGP["L"], MGGP["G"], "SQUARED"),
                         timings["mggp_gram"]),
            "MGGP Kzz": ((m_mggp, m_mggp, MGGP["L"], MGGP["G"], "SQUARED"), t["mggp_gram"])}
    # its backward where [mggp] trains the kernel and the embedding (Z frozen):
    # (timings, operands) for the device phase; the JSON line carries the Kzx
    mggp_bwd = {}
    for n, label in ((m_mggp, "Kzz"), (MGGP["B"], "Kzx")):
        mggp_bwd[f"MGGP {label}"] = _mggp_bwd_case(
            checks, dev, g, m_mggp, n, MGGP["L"], MGGP["G"], f"mggp {label}",
            kzz=label == "Kzz", path_needs=MGGP_NEEDS)
        torch.cuda.empty_cache()
    timings["mggp_gram_bwd"] = mggp_bwd["MGGP Kzx"][0]
    # Kzx over every spot: L*M*N outputs pass 2^31, so the last columns
    # check the kernel's 64-bit offsets
    _mggp_case(checks, dev, g, m_mggp, MGGP["N"], MGGP["L"], MGGP["G"], "SQUARED",
               f"Kzx L={MGGP['L']} {m_mggp}x{MGGP['N']}, last 2,000 columns",
               tail=2000)
    _log_timings({"mggp_gram": timings["mggp_gram"]})
    torch.cuda.empty_cache()
    # the Hybrid-MGGP step's Kzz and Kzx forward, and their backward where Z
    # trains: the shapes of the full-scale warm start's fine-tune and posterior
    # blocks too (L_spatial 10, M 3,010, batch 6,000), timed for both
    for n, label in ((m_hm, "Kzz"), (HYBRID_MGGP["B"], "Kzx")):
        t = {}
        _mggp_case(checks, dev, g, m_hm, n, HYBRID_MGGP["L"], HYBRID_MGGP["G"],
                   "SQUARED", f"hybrid_mggp {label} L={HYBRID_MGGP['L']} {m_hm}x{n} "
                   f"G={HYBRID_MGGP['G']}", t)
        _log_timings(t, f" (hybrid_mggp and warmstart_slideseq {label})")
        mggp[f"hybrid_mggp {label}"] = ((m_hm, n, HYBRID_MGGP["L"], HYBRID_MGGP["G"],
                                         "SQUARED"), t["mggp_gram"])
        mggp_bwd[f"hybrid_mggp {label}"] = _mggp_bwd_case(
            checks, dev, g, m_hm, n, HYBRID_MGGP["L"], HYBRID_MGGP["G"],
            f"hybrid_mggp {label}", kzz=label == "Kzz", path_needs=z_needs(label))
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
        _gram_bwd_case(checks, dev, g, l_dim, n, m, label, dim, gram_bwd, device=True)
        torch.cuda.empty_cache()
    # the JSON line carries the VNNGP sweep's Kxz, the largest g and k read
    timings["rbf_gram_bwd"] = gram_bwd[v["L"], v["N"], v["M"]]
    w = WARMSTART
    m_ws = w["M_per_group"] * w["G"]
    for n, label in ((m_ws, "Kzz"), (w["B"], "Kzx")):
        t = {}
        _mggp_case(checks, dev, g, m_ws, n, w["L_spatial"], w["G"], "SQUARED",
                   f"warmstart {label} L={w['L_spatial']} {m_ws}x{n} G={w['G']}", t)
        _log_timings(t, f" (warmstart {label})")
        mggp[f"warmstart {label}"] = ((m_ws, n, w["L_spatial"], w["G"], "SQUARED"),
                                      t["mggp_gram"])
        mggp_bwd[f"warmstart {label}"] = _mggp_bwd_case(
            checks, dev, g, m_ws, n, w["L_spatial"], w["G"], f"warmstart {label}",
            kzz=label == "Kzz", path_needs=z_needs(label))
    n_fold = v["L"] * v["N"]
    _block_case(checks, dev, g, n_fold, v["K"], "VNNGP sweep", block)
    # kernel 5's backward: ragged (one point, one past a block, one past the
    # step's n; K = 1 and 16), then the all-trainable step's n and the
    # sweep's, timed; the JSON line carries the sweep's
    log("[kernels] kernel 5's backward")
    for n, k in ((1, vnngp["K"]), (33, vnngp["K"]), (vnngp["B"] + 1, vnngp["K"]), (130, 1),
                 (1_000, 16)):
        _block_bwd_case(checks, dev, g, n, k, "ragged")
    # K = 5 (three idle lanes a point) and a grid whose groups leave its
    # last round part-full
    for n, k in ((1_000, 5), (20_001, vnngp["K"])):
        _block_bwd_case(checks, dev, g, n, k, "ragged plan")
    block_bwd = {}
    _block_bwd_case(checks, dev, g, vnngp["B"], vnngp["K"], "step", block_bwd, device=True)
    _block_bwd_case(checks, dev, g, n_fold, v["K"], "VNNGP sweep", block_bwd, device=True)
    timings["block_conditional_bwd"] = block_bwd[n_fold, v["K"]]
    torch.cuda.empty_cache()
    return timings, {"rbf_gram": gram, "mggp_gram": mggp, "mggp_gram_bwd": mggp_bwd,
                     "block_conditional": {(vnngp["B"], vnngp["K"]): block["step"],
                                           (vnngp["L"] * vnngp["N"], vnngp["K"]):
                                           block["posterior"],
                                           (n_fold, v["K"]): block["VNNGP sweep"]}}


DEVICE_REPS = 20
# kernel 1's backward takes 5-20 ms a call at the paths' shapes, and each
# captured call holds its own outputs and scratch (GBs) in the graph's pool
TRI_DEVICE_REPS = 5


def phase_device_times(dev, vnngp, shape_timings):
    """Kernels 3 and 5 alone on the device at every path shape, and kernel 4
    and its backward kernel at the MGGP step's Kzz and Kzx, the Hybrid-MGGP
    step's (and the full-scale warm start's) Kzz and Kzx and the warm start's
    Kzz and Kzx (``device_ms``:
    DEVICE_REPS calls captured in one CUDA graph): each shape's time goes
    into ``shape_timings``. The kernel phase's times (CUDA events around one
    wrapper call, as earlier PRs measured them) also hold the wrapper's host
    work, which bounds a small call."""
    import torch
    from gpzoo_tpu_torch.ops import gram_cuda, mggp_cuda, vnngp_cuda

    g = torch.Generator(device=dev).manual_seed(1)
    log(f"[device] kernels 3, 4 (and its backward) and 5 alone on the device ({DEVICE_REPS} calls "
        "in one CUDA graph, its replay timed by CUDA events)")
    for label, shape, dim in gram_path_shapes(vnngp):
        args = _gram_inputs(g, dev, *shape, dim)
        ms, count = device_ms(lambda: gram_cuda.rbf_gram_fwd(*args), DEVICE_REPS,
                              gram_cuda.rbf_gram_fwd)
        _log_device(shape_timings["rbf_gram"][shape], ms, count,
                    f"rbf_gram {label} {shape}")
        del args
        torch.cuda.empty_cache()
    for (n, k), t in shape_timings["block_conditional"].items():
        ops = _block_operands(g, dev, n, k)
        ms, count = device_ms(lambda: vnngp_cuda.block_conditional_fwd(*ops, 0.1),
                              DEVICE_REPS, vnngp_cuda.block_conditional_fwd)
        _log_device(t, ms, count, f"block_conditional {(n, k)}")
        del ops
    for label, (spec, t) in shape_timings["mggp_gram"].items():
        args = _mggp_args(g, dev, *spec)
        ms, count = device_ms(lambda: mggp_cuda.mggp_gram_fwd(*args), DEVICE_REPS,
                              mggp_cuda.mggp_gram_fwd)
        _log_device(t, ms, count, f"mggp_gram {label} (L={spec[2]}, {spec[0]}x{spec[1]})")
        del args
    # the backward kernel alone (its launch; the thin products after it are
    # PyTorch's), with the gradients the path asks for at each shape
    for label, (t, (n, m, l_dim, n_groups, kzz, p, needs)) in (
            shape_timings["mggp_gram_bwd"].items()):
        ops, p = _mggp_bwd_operands(g, dev, n, m, l_dim, n_groups, kzz, p)
        gout = torch.randn((l_dim, n, m), generator=g, device=dev)
        ms, count = device_ms(
            lambda: mggp_cuda.mggp_gram_bwd_planes(gout, *ops, p, needs), DEVICE_REPS,
            mggp_cuda.mggp_gram_bwd)
        _log_device(t, ms, count, f"mggp_gram_bwd {label} (L={l_dim}, {n}x{m})")
        del ops, gout
        torch.cuda.empty_cache()


def _log_device(t, ms, count, label, reps=DEVICE_REPS):
    t["device_ms"] = ms
    if ms is None:
        log(f"  {label}: not measured ({count} launches captured of {reps})")
        return
    log(f"  {label}: {ms:.4f} ms on the device ({count} launches captured of "
        f"{reps}), bound {t['bound_ms']:.4f} ms, {t['bound_ms'] / ms:.1%} of "
        f"bound; call {t['ms']:.4f} ms")


class _Counter:
    """A count read and zeroed as a wrapper's ``launches`` is."""

    launches = 0


@functools.cache
def _rows_t_counter():
    """A :class:`_Counter` of the DcOperands made with dcᵀ (rows_t) on the
    card, by the scale pass or the split of kernel 2's cotangent (every one
    goes through ``tri_cuda._split_run``, spied on from the first call on
    for the rest of the process): "dcT written" in the launch counters."""
    from gpzoo_tpu_torch.ops import tri_cuda

    counter, inner = _Counter(), tri_cuda._split_run

    def spy(name, x, g, transposed):
        counter.launches += bool(transposed)
        return inner(name, x, g, transposed)
    tri_cuda._split_run = spy
    return counter


def _launch_counters(names):
    """{kernel name: its wrapper, whose ``launches`` counts its launches};
    "dcT written" counts the DcOperands made with dcᵀ."""
    from gpzoo_tpu_torch.ops import gram_cuda, mggp_cuda, tri_cuda, vnngp_cuda

    wrappers = {"tri_sq_colsum": tri_cuda.tri_sq_colsum_fused,
                "tri_sq_colsum_c": tri_cuda.tri_sq_colsum_fwd_c,
                "tri_dc_from_c": tri_cuda.tri_dc_from_c,
                "tri_dlu_from_c": tri_cuda.tri_dlu_from_c,
                "tri_t_matmul": tri_cuda.tri_t_matmul,
                "tri_dc": tri_cuda.tri_dc,
                "tri_dlu": tri_cuda.tri_dlu,
                "tri_da": tri_cuda.tri_da,
                "tri_da_from_c": tri_cuda.tri_da_from_c,
                "rbf_gram": gram_cuda.rbf_gram_fwd,
                "mggp_gram": mggp_cuda.mggp_gram_fwd,
                "mggp_gram_bwd": mggp_cuda.mggp_gram_bwd,
                "block_conditional": vnngp_cuda.block_conditional_fwd,
                "rbf_gram_bwd": gram_cuda.rbf_gram_bwd,
                "block_conditional_bwd": vnngp_cuda.block_conditional_bwd,
                "tri_split": tri_cuda.tri_split,
                "tri_kl_trace": tri_cuda.tri_kl_trace_fwd,
                "tri_kl_trace_p": tri_cuda.tri_kl_trace_fwd_p,
                "tri_kl_trace_scale": tri_cuda.tri_kl_trace_scale,
                "tri_kl_trace_bwd": tri_cuda.tri_kl_trace_bwd}
    return {name: _rows_t_counter() if name == "dcT written" else wrappers[name]
            for name in names}


@contextlib.contextmanager
def plain_backward_calls():
    """While active, every call of the plain backwards of kernels 3, 5 and 8
    (``gram_cuda.rbf_gram_bwd_plain``, ``vnngp_cuda.block_conditional_bwd_plain``,
    ``tri_cuda.tri_kl_trace_bwd_plain``: their autograd Functions' CPU route)
    is counted into the yielded Counter, by name. A path on the card must
    make none."""
    from gpzoo_tpu_torch.ops import gram_cuda, tri_cuda, vnngp_cuda

    calls = collections.Counter()

    def spy(module, name):
        plain = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return plain(*args, **kwargs)
        return mock.patch.object(module, name, counted)

    with spy(gram_cuda, "rbf_gram_bwd_plain"), \
            spy(vnngp_cuda, "block_conditional_bwd_plain"), \
            spy(tri_cuda, "tri_kl_trace_bwd_plain"):
        yield calls


def plain_tri():
    """Kernel 1 and kernel 8 swapped for their plain versions in the losses
    (``tri_sq_colsum`` and ``tri_kl_trace`` as train/fast.py and
    train/fast_vnngp.py call them: the panel forms, under autograd): the
    plain steps of every comparison and the float64 steps on the card,
    which no float32 kernel takes."""
    from gpzoo_tpu_torch.ops import tri_blocked
    from gpzoo_tpu_torch.train import fast, fast_vnngp

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fast, "tri_sq_colsum", tri_blocked.tri_sq_colsum))
    for module in (fast, fast_vnngp):
        stack.enter_context(mock.patch.object(module, "tri_kl_trace",
                                              tri_blocked.tri_kl_trace))
    return stack


def off_path(names):
    """The kernels of a leg's counter ``names`` that it must not launch: the
    route of kernel 1's backward it does not take. A leg that counts kernel
    7 reading c (TRI_DA) trains a per-factor a: OFF_PER_FACTOR; any other
    (TRI, or no tri kernel): OFF_SHARED."""
    return OFF_PER_FACTOR if "tri_da_from_c" in names else OFF_SHARED


def launch_ok(name, count, names):
    """A path's launch count as it must be: 0 for a kernel of
    ``off_path(names)``, more than 0 for any other counted there."""
    return count == 0 if name in off_path(names) else count > 0


def check_launches(checks, launches, where):
    """Each kernel of ``launches`` ({name: count}) launched on ``where``,
    those of its ``off_path`` not at all."""
    off = off_path(launches)
    for name, count in launches.items():
        checks.true(f"{name} {'not ' if name in off else ''}launched on {where} ({count})",
                    launch_ok(name, count, launches))


def check_shared_route(checks, tag, launches, steps):
    """A leg whose ã is shared and a constant: kernel 1 keeping c and kernel
    6 reading c once a step each over ``steps`` steps, and neither the scale
    pass nor kernel 6 on a DcOperand nor the dc epilogue."""
    once = {name: launches[name] for name in ("tri_sq_colsum_c", "tri_dlu_from_c")}
    off = {name: launches[name] for name in OFF_SHARED}
    checks.true(f"{tag}: kernel 1 keeping c and kernel 6 reading c once a step ({once} over "
                f"{steps} steps), never the scale pass, kernel 6 on a dc or the dc epilogue "
                f"({off})", all(v == steps for v in once.values()) and not any(off.values()))


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "copies"):
            fn.copies = 0


def _read(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _copies(counters):
    """{kernel name: the operands its wrapper copied to make them contiguous
    since the last :func:`_zero`}, for the wrappers that count them
    (``mggp_gram_bwd``: its cotangent)."""
    return {name: fn.copies for name, fn in counters.items() if hasattr(fn, "copies")}


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
    events) and the kernel's device time (a CUDA graph of DEVICE_REPS calls,
    where measured) beside the bound, and launches x (ms - bound), the time
    the paths lose against the bound, from each. Every shape the paths
    launched must have been timed."""
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
    return nsf_arrays(MAIN["N"], MAIN["D"], dev)


def nsf_arrays(n, d, dev):
    """:func:`nsf_data` at (n, d), uncached."""
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    counts_t = rng.poisson(3.0, size=(n, d)).astype(np.float32)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts_t).to(dev)
    log(f"  synthetic data: {time.perf_counter() - t0:.1f}s")
    return x, y


def precomputed_leg(checks, dev, seen, tag, cfg, counter_names, profiled_steps,
                    trace_before=False):
    """One leg of bench.py's NSF benchmark on the precomputed loss at full
    width: config build, the precomputed projection, warm-up and timed
    Adam steps, the held-out deviance, peak memory and the launch counts
    of ``counter_names`` (each must be > 0), the precompute once more
    warm, and a profiled window; with ``trace_before``, the window by
    operator and input shape, then the same window with the KL trace's
    panel form (the route before kernel 8). Launches of kernel 3 by shape
    go into ``seen``. Returns (model, proj, launches)."""
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
    with plain_backward_calls() as plain_calls:
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
    check_launches(checks, launches, f"the {tag} path")
    checks.true(f"no plain backward called on the {tag} steps ({dict(plain_calls)})",
                not plain_calls)
    # every GEMM by name: dLu is kernel 6's, not a cuBLAS product
    profile_window(lambda: step(model, proj, y), profiled_steps, gemms=True,
                   by_shape=trace_before)
    if trace_before:
        from gpzoo_tpu_torch.ops import tri_blocked
        from gpzoo_tpu_torch.train import fast

        log("  the same window with the KL trace's panel form (tri_blocked.tri_kl_trace, "
            "the route before kernel 8):")
        with mock.patch.object(fast, "tri_kl_trace", tri_blocked.tri_kl_trace):
            profile_window(lambda: step(model, proj, y), profiled_steps, gemms=True,
                           by_shape=True)
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
              quality="held-out Poisson deviance", no_copies=False, gemms=False):
    """Warm-up and ``timed_steps`` timed steps of ``step(model, *args)``,
    the quality metric ``deviance()`` (named by ``quality``), peak memory
    since the caller's reset, the launches of ``counter_names`` over the
    steps (each must be > 0) and in the deviance, the operands their
    wrappers copied over the steps (with ``no_copies``, there must be none),
    and a profiled window (with ``gemms``, every GEMM kernel by name).
    Launches of kernels 3 and 5 by shape go into ``seen`` when given.
    Returns (step launches, deviance launches)."""
    import torch

    counters = _launch_counters(counter_names)
    spies = contextlib.ExitStack()
    if seen is not None:
        spies.enter_context(launch_shapes(seen))
    _zero(counters)
    with plain_backward_calls() as plain_calls:
        warm, warm_s = _timed_steps(step, model, args, WARMUP_STEPS)
        timed, dt = _timed_steps(step, model, args, timed_steps)
    launches, copies = _read(counters), _copies(counters)
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
           f"; kernel 3 by shape: { {k: dict(v) for k, v in seen.items()} }")
        + ("" if not copies else f"; operands copied to be contiguous: {copies}"))
    checks.true(f"{tag} losses finite", bool(torch.isfinite(losses).all()))
    checks.true(f"{tag} {quality} finite", math.isfinite(dev_val))
    check_launches(checks, launches, f"the {tag} step")
    checks.true(f"no plain backward called on the {tag} steps ({dict(plain_calls)})",
                not plain_calls)
    if no_copies:
        for name, count in copies.items():
            checks.true(f"{name} copied no operand on the {tag} step ({count})", count == 0)
    profile_window(lambda: step(model, *args), profiled_steps, gemms)
    return launches, post


def _step_batch(dev, cfg):
    """One fixed minibatch and its draws for the kernel-vs-plain steps."""
    import torch

    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(cfg.N - HOLDOUT, generator=g2, device=dev)[:cfg.batch_size]
    return idx, torch.randn((cfg.E, cfg.L, cfg.batch_size), generator=g2, device=dev)


def step_kernels_vs_plain(checks, tag, model, proj, y, idx, eps):
    """One step with kernel 1 keeping c and its backward (the scale pass,
    kernel 6) and kernel 8 (the KL trace) and its backward against the same step with
    their plain versions: the loss and the gradient of every leaf it
    reaches. The kernels' step must launch each and the plain one none, or
    the comparison is with itself. The same loss evaluated under
    ``torch.no_grad`` must take kernel 1 without c, keep no c and give the
    step's loss. Returns both steps' (loss, grads)."""
    import torch
    from gpzoo_tpu_torch.train import nsf_negative_elbo_precomputed

    counters = _launch_counters(TRI + KL)
    _zero(counters)
    loss_k, grad_k = _loss_grads(model, proj, y, idx, eps)
    kernel_step = _read(counters)
    colsum = _launch_counters(("tri_sq_colsum", "tri_sq_colsum_c", "tri_dc_from_c",
                               "tri_dlu_from_c"))
    _zero(colsum)
    with torch.no_grad():
        loss_ng = nsf_negative_elbo_precomputed(model, proj, y, idx, eps, y_transposed=True)
    no_grad = _read(colsum)
    checks.true(f"{tag} loss under no_grad: kernel 1 without c, no c kept and no backward "
                f"({no_grad})", no_grad["tri_sq_colsum"] > 0
                and no_grad["tri_sq_colsum_c"] == no_grad["tri_dc_from_c"]
                == no_grad["tri_dlu_from_c"] == 0)
    checks.le(f"{tag} loss under no_grad vs the step's (relative)",
              float(abs(loss_ng - loss_k) / abs(loss_k)), TOL_STEP_LOSS)
    _zero(counters)
    with plain_tri():
        loss_p, grad_p = _loss_grads(model, proj, y, idx, eps)
    plain_step = _read(counters)
    checks.true(f"{tag} kernels' step launched kernels 1 and 8 and their backwards (kernel "
                f"6 reading c), not the scale pass, kernel 6 on a dc or the dc epilogue "
                f"({kernel_step})",
                all(launch_ok(k, v, kernel_step) for k, v in kernel_step.items()))
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
    kl_off = _launch_counters(tuple(n for n in KL_ALL if n not in KL))
    _zero(kl_off)
    model, proj, launches = precomputed_leg(
        checks, dev, seen, "main", cfg, TRI + KL + ("rbf_gram",),
        MAIN_PROFILED_STEPS, trace_before=True)
    off, steps = _read(kl_off), WARMUP_STEPS + TIMED_STEPS
    check_shared_route(checks, "main", launches, steps)
    checks.true(f"main: kernel 8 once a step each way, forward keeping P and scale pass "
                f"({launches['tri_kl_trace_p']} and {launches['tri_kl_trace_scale']} over "
                f"{steps} steps), never the recompute or the forward without P ({off} over "
                f"the leg)", launches["tri_kl_trace_p"] == launches["tri_kl_trace_scale"] == steps
                and not any(off.values()))
    step_kernels_vs_plain(checks, "main", model, proj, nsf_data(dev)[1],
                          *_step_batch(dev, cfg))
    del model, proj
    torch.cuda.empty_cache()
    return launches


#: bench.py's ``--loss fast`` settings (the microbatch is the whole batch)
FAST_KW = dict(factored=True, shared_kernel=True, remat=False, y_transposed=True)


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
    kw = dict(FAST_KW, microbatch=b)
    step = make_batched_train_step(nsf_negative_elbo_batched, cfg.optimizer(model),
                                   n_train, b, cfg.L, gen, E=cfg.E, loss_kwargs=kw)
    vidx = torch.arange(n_train, n, device=dev)
    launches, post = train_leg(
        checks, "fast", step, model, (x, y), TRI + KL + ("rbf_gram",),
        lambda: held_out_deviance(model, precompute_nsf_projection(model, x), y, vidx),
        MAIN_PROFILED_STEPS, seen)
    del step
    # Z and the kernel frozen: the chunk's ã = K⁻¹Kzx is a constant
    check_shared_route(checks, "fast", launches, WARMUP_STEPS + TIMED_STEPS)
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
    names = TRI + KL + ("rbf_gram",)
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

    log(f"[nb] negative-binomial NSF step, N={MAIN['N']} D={MAIN['D']} "
        f"L={MAIN['L']} M={MAIN['M']} batch={MAIN['B']}, r0 = 10")
    cfg = SlideseqNSFConfig(N=MAIN["N"], D=MAIN["D"], L=MAIN["L"], M=MAIN["M"],
                            batch_size=MAIN["B"], likelihood="nb")
    model, proj, launches = precomputed_leg(
        checks, dev, seen, "nb", cfg, TRI + KL + ("rbf_gram",),
        MAIN_PROFILED_STEPS)
    checks.true("nb leg trains r_raw", model.r_raw.requires_grad)
    check_shared_route(checks, "nb", launches, WARMUP_STEPS + TIMED_STEPS)
    y = nsf_data(dev)[1]
    idx, eps = _step_batch(dev, cfg)
    (loss_k, grad_k), (loss_p, grad_p) = step_kernels_vs_plain(
        checks, "nb", model, proj, y, idx, eps)
    checks.true("nb step reaches r_raw", "r_raw" in grad_k)
    # the same step in float64 (plain versions: the kernels are float32)
    model64 = copy.deepcopy(model).double()
    proj64 = _proj_as(proj, torch.float64)
    with plain_tri():
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
    counters = _launch_counters(("rbf_gram",) + TRI + KL)
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
    check_launches(checks, {name: adam_launches[name] for name in TRI + KL},
                   "the ngd leg's Adam arm")
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
    percentiles), then ``extract_factors`` at all 45,000 spots (after
    ``ngd_to_model``, EXTRACT_CHUNK spots a block) and its Moran ranking on
    the card, held against the host route's (:func:`graph_vs_host`). Kernel
    3 runs in each posterior (Kzz and Kzx, every factor)."""
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

    def on_chunk(state, losses):
        # the NGD step keeps q(u)'s covariance in P, not in the model: write
        # it into Lu_raw (which the step never reads) before the snapshot
        ngd_to_model(state)
        snap(state, losses)

    runner = make_scan_runner(step, SNAPSHOT["chunk"], on_chunk=on_chunk)
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
    scales = [r["qf_scale_p50"] for r in snap.records]
    checks.true(f"snapshot qf_scale_p50 moves from snapshot to snapshot ({scales})",
                all(a != b for a, b in zip(scales, scales[1:])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    factors, order, moran = extract_factors(state.model, x, chunk_size=EXTRACT_CHUNK)
    torch.cuda.synchronize()
    log(f"  extract_factors at all {MAIN['N']} spots, {EXTRACT_CHUNK} a block: "
        f"{time.perf_counter() - t0:.2f}s (posterior and Moran's I on the card), peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; order {order.tolist()}, "
        f"Moran's I {[round(float(v), 4) for v in moran]}")
    launches = _read(counters)
    spies.close()
    log(f"  launches: {launches}; by shape: { {k: dict(v) for k, v in seen.items()} }")
    checks.true("extract_factors factors finite, (L, spots)",
                factors.shape == (MAIN["L"], MAIN["N"]) and bool(np.isfinite(factors).all()))
    checks.true("extract_factors ranking is a permutation, Moran's I descending",
                sorted(order.tolist()) == list(range(MAIN["L"]))
                and bool(np.all(np.diff(moran) <= 0)))
    checks.true(f"rbf_gram launched on the snapshot path ({launches['rbf_gram']})",
                launches["rbf_gram"] > 0)
    graph_vs_host(checks, "snapshot extract_factors", x, factors.T, order, moran, 10)
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
    counters = _launch_counters(TRI + KL)
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
    check_launches(checks, launches, "the checkpoint path")
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
            **({"groups": rest[2]} if len(rest) > 2 else {}), **HIGHEST, **kw)

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
    counters = _launch_counters(TRI_DA + KL + ("rbf_gram", "mggp_gram", "mggp_gram_bwd"))
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
    counters = _launch_counters(TRI_DA + KL + ("rbf_gram", "block_conditional"))
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


def _gemm_class(name):
    """The arithmetic of a cuBLAS/CUTLASS GEMM kernel, read off its name, or
    None for a kernel that is not a GEMM."""
    low = name.lower()
    if "gemm" not in low and "xmma" not in low:
        return None
    if "simt" in low or "ffma" in low:
        return "SIMT float32"
    if "bf16" in low or "s16816" in low:
        return "tensor cores, bf16"
    if "tf32" in low or "s1688" in low or "tensorop" in low:
        return "tensor cores, tf32"
    return "other"


def _device_us(evt):
    """An operator's self device time in µs (the attribute's name differs
    between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_window(fn, steps, gemms=False, by_shape=False):
    """Device split of ``steps`` calls of ``fn`` under torch.profiler: wall
    time, summed kernel time, the device's idle share of the wall time, and
    the kernels that took the most device time; with ``gemms``, every GEMM
    kernel with its arithmetic (:func:`_gemm_class`); with ``by_shape``,
    the operators with the most self device time, by their input shapes.
    Returns {"wall_ms", "busy_ms", "idle_share"} over the window. A profiler
    that cannot trace the card is reported, not failed (None); a failing
    step propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=by_shape)
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
    if gemms:
        log("  GEMM kernels (ms/step, arithmetic, name):")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
            if _gemm_class(name):
                log(f"    {us / steps / 1e3:9.4f}  {_gemm_class(name):18s}  {name[:100]}")
    if by_shape:
        log("  operators by self device time and input shapes:")
        ops = [(_device_us(evt), evt.key, str(evt.input_shapes))
               for evt in prof.key_averages(group_by_input_shape=True)
               if evt.device_type != torch.autograd.DeviceType.CUDA]
        for us, op, shapes in sorted((op for op in ops if op[0] > 0),
                                     key=lambda op: -op[0])[:12]:
            log(f"    {us / steps / 1e3:9.4f} ms/step  {op}  {shapes[:140]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us}


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


#: bench.py's VNNGP all-trainable leg (run_vnngp_bench) on spot-major counts
VNNGP_STEP_KW = {"shared_kernel": True, "y_transposed": True}


def vnngp_leg(dev, vnngp):
    """[vnngp]'s configuration, model, (b)'s step, its arguments (x, y) and
    the generator (seed 0) that built the model and draws every step's
    batch and samples. (b) is bench.py's all-trainable leg: every leaf
    trained over the first N − HOLDOUT spots in batches of vnngp["B"]."""
    import torch
    from gpzoo_tpu_torch import make_batched_train_step, vnngp_nsf_negative_elbo_batched

    gen = torch.Generator(device=dev).manual_seed(0)
    cfg, model, x, y = _vnngp_setup({"VNNGP": vnngp}, dev, counts=True, gen=gen)
    step = make_batched_train_step(vnngp_nsf_negative_elbo_batched,
                                   cfg.optimizer(model), cfg.N - HOLDOUT, vnngp["B"],
                                   cfg.L, gen, E=cfg.E, loss_kwargs=VNNGP_STEP_KW)
    return cfg, model, step, (x, y), gen


def phase_vnngp(checks, dev, vnngp, seen):
    """bench.py's VNNGP leg (run_vnngp_bench) on the port, at full width.
    Kernel launches by shape go into seen["a"], seen["b"], seen["c"]."""
    import torch
    from gpzoo_tpu_torch import (latent_posterior, make_batched_train_step,
                                 precompute_vnngp_conditioning,
                                 vnngp_nsf_negative_elbo_precomputed)
    from gpzoo_tpu_torch.data.metrics import posterior_mean_deviance

    n, d, b = vnngp["N"], vnngp["D"], vnngp["B"]
    log(f"[vnngp] NSF over VNNGP, N={n} D={d} L={vnngp['L']} M={vnngp['M']} "
        f"K={vnngp['K']} batch={b}")
    counters = _launch_counters(("block_conditional", "rbf_gram", "block_conditional_bwd",
                                 "rbf_gram_bwd") + KL)
    launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, all_trainable, (x, y), gen = vnngp_leg(dev, vnngp)
    log(f"  synthetic data and model: {time.perf_counter() - t0:.1f}s")
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
    step = all_trainable
    with plain_backward_calls() as plain_calls:
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
    # (b) trains every leaf through both kernels' backwards; (c) is forward
    # only and has no KL; (a)'s KL takes the trace, kernel 8 both ways
    for part in ("b", "c"):
        for name, count in launches[part].items():
            if part == "b" or not (name.endswith("_bwd") or name in KL):
                checks.true(f"{name} launched on vnngp ({part}) ({count})", count > 0)
    for name in KL:
        checks.true(f"{name} launched on vnngp (a) ({launches['a'][name]})",
                    launches["a"][name] > 0)
    checks.true(f"no plain backward called on the vnngp (b) steps ({dict(plain_calls)})",
                not plain_calls)
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
    """The MGGP W-form loss and the gradient of every trained leaf, every
    product in IEEE float32."""
    return _blockwise_loss_grad(model, x, y, idx, eps, microbatch=microbatch,
                                factored=True, y_transposed=True, groups=groups,
                                remat=False, **HIGHEST)


def plain_mggp_kernels(gram=None):
    """Kernels 1 and 4 swapped for their plain versions on the MGGP path
    (kernel 4 for ``gram`` if given; kernel 1's backward, the scale pass
    and kernels 6-7, runs only inside kernel 1's autograd Function)."""
    from gpzoo_tpu_torch.ops import mggp_cuda

    stack = plain_tri()
    stack.enter_context(mock.patch.object(mggp_cuda, "mggp_gram",
                                          gram or mggp_cuda.mggp_gram_plain))
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


def _ab_arm(tag, init, make_step, args, counters, deviance, snapshot_at=None,
            profile=True):
    """One arm of an A/B: a copy of ``init`` trained MGGP_AB_STEPS steps of
    ``make_step(model)`` (whose generator starts where the other arm's
    does, so that every arm takes the same idx and eps), ms/step on the host clock over
    TIMED_STEPS steps after WARMUP_STEPS, the peak memory over those steps,
    the launches of ``counters`` over all steps and over ``deviance(model)``,
    and (with ``profile``) a profiled window with the GEMM kernels' names.
    Returns its record; with ``snapshot_at``, a copy of the model after that
    many steps."""
    import torch

    model = copy.deepcopy(init)
    step = make_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    warm, warm_s = _timed_steps(step, model, args, WARMUP_STEPS)
    timed, dt = _timed_steps(step, model, args, TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    done = WARMUP_STEPS + TIMED_STEPS
    snapshot = copy.deepcopy(model) if snapshot_at == done else None
    rest, _ = _timed_steps(step, model, args, MGGP_AB_STEPS - done)
    launches, copies = _read(counters), _copies(counters)
    losses = torch.cat([warm, timed, rest])
    _zero(counters)
    t0 = time.perf_counter()
    dev_val = float(deviance(model))
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    post = _read(counters)
    log(f"  [{tag}] warm-up {WARMUP_STEPS} steps: {warm_s:.2f}s; {TIMED_STEPS / dt:.4f} "
        f"steps/s ({dt / TIMED_STEPS * 1e3:.2f} ms/step, host clock over {TIMED_STEPS} "
        f"steps); peak device memory over them {peak / 2**30:.3f} GiB")
    log(f"  [{tag}] losses over {MGGP_AB_STEPS} steps: "
        f"{[f'{v:.6e}' for v in losses.tolist()]}")
    log(f"  [{tag}] held-out Poisson deviance (holdout {HOLDOUT}, {post_s:.3f}s): "
        f"{dev_val:.6f}")
    log(f"  [{tag}] launches over {MGGP_AB_STEPS} steps: {launches}; held-out "
        f"posterior: {post}; operands copied to be contiguous over the steps: {copies}")
    if profile:
        profile_window(lambda: step(model, *args), MGGP_PROFILED_STEPS, gemms=True)
    del step, model
    torch.cuda.empty_cache()
    return dict(losses=losses, ms=dt / TIMED_STEPS * 1e3, peak=peak, deviance=dev_val,
                launches=launches, copies=copies, post=post, snapshot=snapshot)


def ab_compare(checks, tag, bench, highest, deviance_limit=None):
    """The A/B's figures: both trajectories' largest relative gap and both
    deviances, each finite; with ``deviance_limit``, the deviances must
    agree within it (relative to "highest")."""
    import torch

    gap = float(((bench["losses"] - highest["losses"]).abs()
                 / highest["losses"].abs()).max())
    rel = abs(bench["deviance"] - highest["deviance"]) / abs(highest["deviance"])
    log(f"  {tag} A/B: ms/step bench {bench['ms']:.2f}, highest {highest['ms']:.2f}; "
        f"peak bench {bench['peak'] / 2**30:.3f}, highest {highest['peak'] / 2**30:.3f} "
        f"GiB; largest relative gap of the losses {gap:.3e}; deviance bench "
        f"{bench['deviance']:.6f}, highest {highest['deviance']:.6f} "
        f"(relative difference {rel:.3e})")
    for arm, rec in (("bench", bench), ("highest", highest)):
        checks.true(f"{tag} {arm} arm: losses finite",
                    bool(torch.isfinite(rec["losses"]).all()))
        checks.true(f"{tag} {arm} arm: held-out deviance finite",
                    math.isfinite(rec["deviance"]))
    if deviance_limit is not None:
        checks.le(f"{tag} A/B: held-out deviance, bench vs highest (relative)", rel,
                  deviance_limit)


def must_differ(checks, tag, loss_grad, knobs, jitter):
    """Each precision knob whose string (bench.py's, resolved as the loss
    resolves it) maps to a reduced mode, set alone, against the step with
    every knob at "highest": it must move the loss or a gradient leaf by more
    than MUST_DIFFER times the gap between two runs of the "highest" step.
    ``loss_grad(knobs)`` gives the first step's (loss, {leaf: gradient})."""
    from gpzoo_tpu_torch.ops.precision import MODES
    from gpzoo_tpu_torch.train import resolve_policy

    pol = resolve_policy(jitter, whitened=False, factored=True, per_factor_chol=True,
                         **{k: knobs[k] for k in HIGHEST})
    base = loss_grad(HIGHEST)
    again = loss_grad(HIGHEST)

    def moves(out):
        got = {"loss": float(abs(out[0] - base[0]) / abs(base[0]))}
        got.update({leaf: norm_err(g, base[1][leaf]) for leaf, g in out[1].items()})
        return got

    gap = moves(again)
    log(f"  {tag} must-differ: two runs of the highest step differ by "
        + ", ".join(f"{k} {v:.2e}" for k, v in gap.items()))
    for knob in HIGHEST:
        value = getattr(pol, knob)
        if MODES[value] == "ieee":
            log(f"  {tag} must-differ: {knob}={value!r} maps to IEEE; nothing to show")
            continue
        moved = moves(loss_grad({**HIGHEST, knob: value}))
        live = [k for k, v in moved.items() if v > MUST_DIFFER * gap[k]]
        log(f"  {tag} must-differ {knob}={value!r} ({MODES[value]}) alone moves "
            + ", ".join(f"{k} {v:.2e}" for k, v in moved.items()))
        checks.true(f"{tag}: {knob}={value!r} moves the first step by more than "
                    f"{MUST_DIFFER}x the highest step's own gap ({', '.join(live) or 'nothing'})",
                    bool(live))


def phase_mggp(checks, dev):
    """bench.py's MGGP leg (benchmarks/mggp_anatomy.py measure_step) on the
    port, at full width: trainable per-factor MGGP kernels and the group
    embedding, Z frozen, one chunk of 7,000 (microbatch = batch). Two arms
    from one init take the same MGGP_AB_STEPS minibatches: bench.py's
    precision and remat settings (BENCH, the main path) and every knob at
    "highest" (remat "save_proj" too). Then the must-differ checks and one
    step with kernels 1 and 4 against the same step with their plain
    versions, every knob at "highest"."""
    import torch
    from torch import nn
    from gpzoo_tpu_torch import (MGGPNSFConfig, make_batched_train_step,
                                 nsf_negative_elbo_batched)
    from gpzoo_tpu_torch.data import posterior_deviance
    from gpzoo_tpu_torch.ops import precision
    from gpzoo_tpu_torch.train import resolve_policy

    n, d, b = MGGP["N"], MGGP["D"], MGGP["B"]
    cfg = MGGPNSFConfig(D=d, N=n, L=MGGP["L"], M_per_group=MGGP["M_per_group"],
                        n_groups=MGGP["G"], batch_size=b)
    log(f"[mggp] MGGP-NSF step, N={n} D={d} L={cfg.L} M={cfg.M} "
        f"({cfg.M_per_group} x {cfg.n_groups} groups) batch={b}; the precision "
        f"strings' modes: {precision.MODES}")
    x, y, g = mggp_data(dev, n, d, cfg.n_groups)

    counters = _launch_counters(("mggp_gram", "mggp_gram_bwd") + TRI_DA)
    torch.cuda.synchronize()
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
    base_kw = dict(microbatch=b, factored=True, y_transposed=True, groups=g)

    draws = gen.get_state()  # each arm's minibatches and draws start here

    def make_step(knobs):
        def build(m):
            generator = torch.Generator(device=dev)
            generator.set_state(draws)
            return make_batched_train_step(
                nsf_negative_elbo_batched, cfg.optimizer(m), n_train, b, cfg.L,
                generator, E=cfg.E, loss_kwargs={**base_kw, **knobs})
        return build

    def deviance(m):
        return posterior_deviance(m, x, y, torch.arange(n_train, n, device=dev), g)

    arms = {}
    for arm, knobs in (("bench", BENCH), ("highest", dict(remat="save_proj", **HIGHEST))):
        log(f"  [mggp {arm}] {knobs}")
        arms[arm] = _ab_arm(f"mggp {arm}", model, make_step(knobs), (x, y),
                            counters, deviance,
                            snapshot_at=WARMUP_STEPS + TIMED_STEPS if arm == "highest"
                            else None)
    bench, highest = arms["bench"], arms["highest"]
    # The evidence for each string the table moved off its JAX alias's mode
    # (ALIAS_MODES): each knob that takes that string in bench.py's settings,
    # alone at it, the others at "highest", the string under its alias's mode.
    pol = resolve_policy(cfg.jitter, whitened=False, factored=True, per_factor_chol=True,
                         **{k: BENCH[k] for k in HIGHEST})
    for knob in HIGHEST:
        value = getattr(pol, knob)
        if ALIAS_MODES[value] == precision.MODES[value]:
            continue
        with mock.patch.dict(precision.MODES, {value: ALIAS_MODES[value]}):
            alone = _ab_arm(f"mggp {knob}={value!r} alone ({ALIAS_MODES[value]})", model,
                            make_step({**HIGHEST, "remat": "save_proj", knob: value}),
                            (x, y), counters, deviance, profile=False)
        log(f"  mggp {knob}={value!r} alone under {ALIAS_MODES[value]}: deviance "
            f"{alone['deviance']:.6f}, relative to highest "
            f"{abs(alone['deviance'] - highest['deviance']) / abs(highest['deviance']):.3e} "
            f"(limit of the bench arm {TOL_AB_DEVIANCE:.0e}); largest relative gap of the "
            "losses " + f"{float(((alone['losses'] - highest['losses']).abs() / highest['losses'].abs()).max()):.3e}")
    check_launches(checks, bench["launches"], "the mggp step")
    for arm in ("bench", "highest"):
        for name, count in arms[arm]["copies"].items():
            checks.true(f"{name} copied no operand on the mggp {arm} step ({count})",
                        count == 0)
    checks.true(f"mggp_gram launched on the mggp posterior "
                f"({bench['post']['mggp_gram']})", bench["post"]["mggp_gram"] > 0)
    # the chunk is checkpointed (remat "save_proj"): kernel 1 keeping c runs
    # in its first run, whose c is dropped at the end of the forward, and in
    # the recompute, whose c the scale pass reads
    kept = {name: bench["launches"][name]
            for name in ("tri_sq_colsum_c", "tri_dc_from_c", "tri_da_from_c")}
    checks.true(f"mggp: kernel 1 keeping c twice a step (first run and recompute), the "
                f"scale pass and kernel 7 reading c once ({kept} over {MGGP_AB_STEPS} steps)",
                kept["tri_sq_colsum_c"] == 2 * kept["tri_dc_from_c"]
                == 2 * kept["tri_da_from_c"] == 2 * MGGP_AB_STEPS)
    ab_compare(checks, "mggp", bench, highest, TOL_AB_DEVIANCE)

    # The must-differ checks and the kernels-vs-plain step on one fixed idx
    # and eps. The gradients that reach the kernel through Kzz⁻¹ (μ, σ, ℓ,
    # α, the embedding) carry float32 rounding of the Gram amplified by
    # Kzz's condition number (jitter 0.1 at M = 3,010), in the plain step as
    # much as in the kernels' one; so both are also held against the same
    # step in float64 (plain versions). Most variance entries sit at the
    # 5e-2 floor, and one that the steps' rounding puts on either side of it
    # moves dLu by ~7.5e-3 of its maximum: the other steps take the kernels'
    # step's floor decisions, within MAX_FLIPS (steps_vs_plain).
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    must_differ(checks, "mggp", lambda knobs: _blockwise_loss_grad(
        model, x, y, idx, eps, **base_kw, remat=BENCH["remat"], **knobs), BENCH,
        cfg.jitter)
    launches = {name: bench["launches"][name] + bench["post"][name] for name in counters}
    model = highest["snapshot"]  # after the timed steps, as the plain step held it
    del arms, bench, highest
    torch.cuda.empty_cache()
    steps_vs_plain(checks, "mggp", tuple(counters), plain_mggp_kernels,
                   lambda r: _mggp_loss_grad(model, x, y, idx, eps, g, b),
                   lambda r: _mggp_loss_grad(copy.deepcopy(model).double(), x.double(),
                                             y.double(), idx, eps.double(), g, b))
    del model, x, y
    torch.cuda.empty_cache()
    return launches


def plain_rbf_kernels(gram=None):
    """Kernels 1 and 3 swapped for their plain versions on the blockwise
    path (kernel 3's backward then comes from autograd through the plain
    form, or through ``gram`` if given; kernel 1's backward, kernel 6
    reading c or the scale pass and kernels 6-7, runs only inside kernel
    1's autograd Function)."""
    from gpzoo_tpu_torch.ops import gram_cuda

    stack = plain_tri()
    stack.enter_context(mock.patch.object(gram_cuda, "rbf_gram",
                                          gram or gram_cuda.rbf_gram_plain))
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
    off = off_path(counter_names)
    for name in counters:
        checks.true(f"{tag}: {name} {'not ' if name in off else ''}launched on the "
                    f"kernels' step ({kernel_step[name]})",
                    launch_ok(name, kernel_step[name], counter_names))
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


def hybrid_leg(dev):
    """[hybrid]'s configuration, model (seed 0), step, its arguments (x, y,
    idx) and the loss's keywords: bench.py's ``--workload hybrid`` leg, data
    from ``data.sim.simulate_nsf_counts``, full batch over the first
    hybrid_shape() spots."""
    import torch
    from gpzoo_tpu_torch import HybridNSFConfig, make_train_step, nsf_negative_elbo_batched
    from gpzoo_tpu_torch.data import simulate_nsf_counts

    cfg = HybridNSFConfig(**HYBRID)
    n_train = hybrid_shape()[2]
    coords, counts, _ = simulate_nsf_counts(N=cfg.N, D=cfg.D, L=cfg.L)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts).to(dev)  # (D, N)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen)
    kw = dict(E=cfg.E, microbatch=n_train, factored=True)
    step = make_train_step(nsf_negative_elbo_batched, cfg.optimizer(model), n_train,
                           cfg.L, gen, E=cfg.E, loss_kwargs=kw)
    return cfg, model, step, (x, y, torch.arange(n_train, device=dev)), kw


def phase_hybrid(checks, dev, seen):
    """bench.py's ``--workload hybrid`` leg (HybridNSFConfig) at its published
    size: full-batch steps over the first 720 spots (one chunk), E = 1,000
    draws, cell 15's trainables (ℓ and Z train, so kernel 3's backward
    runs), data from ``data.sim.simulate_nsf_counts``. Besides the figures of
    every leg: one step with kernels 1 and 3 against the same step with
    their plain versions."""
    import torch
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, step, (x, y, idx), kw = hybrid_leg(dev)
    n_train = len(idx)
    log(f"[hybrid] Hybrid-NSF full-batch step, N={cfg.N} D={cfg.D} L={cfg.L} "
        f"T={cfg.T} M={cfg.M} E={cfg.E}, trained on {n_train} spots")
    names = TRI_DA + ("rbf_gram", "rbf_gram_bwd")
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
    backward runs for Z), jitter 1e-2. Two arms from one init on the same
    draws, each with the figures of every leg: bench.py's settings (BENCH,
    bench.py:614-621, the main path) and every knob at "highest"; then the
    must-differ checks, and one step with kernels 1 and 4 against the same
    step with their plain versions, and both against the same step in
    float64 (plain versions), every knob at "highest": at jitter 1e-2 the
    float32 gradients through Kzz⁻¹ carry κ(Kzz)-amplified rounding in the
    plain step as much as in the kernels' one."""
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
    gen = torch.Generator(device=dev).manual_seed(0)
    init = cfg.build(gen, x, g)
    draws = gen.get_state()  # each arm's minibatches and draws start here
    base_kw = dict(E=cfg.E, microbatch=b, factored=True, y_transposed=True, groups=g)
    names = ("mggp_gram", "mggp_gram_bwd") + TRI_DA
    arms = {}
    for arm, knobs in (("bench", BENCH), ("highest", dict(remat="save_proj", **HIGHEST))):
        log(f"  [hybrid_mggp {arm}] {knobs}")
        model = copy.deepcopy(init)
        generator = torch.Generator(device=dev)
        generator.set_state(draws)
        step = make_batched_train_step(nsf_negative_elbo_batched, cfg.optimizer(model),
                                       n_train, b, cfg.L, generator, E=cfg.E,
                                       loss_kwargs={**base_kw, **knobs})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches, post = train_leg(
            checks, f"hybrid_mggp {arm}", step, model, (x, y), names,
            lambda: hybrid_posterior_deviance(
                model, x, y, torch.arange(n_train, n, device=dev), g),
            MGGP_PROFILED_STEPS, no_copies=True, gemms=True)
        arms[arm] = (model, launches, post)
        del step
        torch.cuda.empty_cache()
    g2 = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randperm(n_train, generator=g2, device=dev)[:b]
    eps = torch.randn((cfg.E, cfg.L, b), generator=g2, device=dev)
    eps2 = torch.randn((cfg.E, cfg.T, b), generator=g2, device=dev)
    must_differ(checks, "hybrid_mggp", lambda knobs: _blockwise_loss_grad(
        init, x, y, idx, eps, eps2, **base_kw, remat=BENCH["remat"], **knobs), BENCH,
        cfg.jitter)
    model, launches, post = arms["highest"][0], arms["bench"][1], arms["bench"][2]
    del arms, init
    torch.cuda.empty_cache()
    kw = dict(base_kw, remat=False, **HIGHEST)

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
    eps. Returns the card step's launches of kernel 4 and its backward."""
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
    counters = _launch_counters(("mggp_gram", "mggp_gram_bwd"))
    for where, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        model = mggp_nsf_from_numpy(params, where, dtype, jitter=cfg.jitter)
        _zero(counters)
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
    launches = _read(counters)
    for name, count in launches.items():
        checks.true(f"{name} launched on the small mggp step ({count})", count > 0)
    return launches


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
                loss_fn, fixed, plain, seen=None, plain2=None, no_copies=False):
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
    With ``no_copies``, no wrapper may copy an operand on the steps.
    Returns the launches of the steps and the quality metric."""
    import torch

    def fixed_loss():
        f_args, f_kw = fixed(0)
        with torch.no_grad():
            return float(loss_fn(model, *f_args, **f_kw))

    before = fixed_loss()
    launches, post = train_leg(checks, tag, step, model, args, names, quality,
                               GENERIC_PROFILED_STEPS, seen, GENERIC_TIMED, quality_label,
                               no_copies=no_copies)
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
            checks, f"nsf_sweep M={m}", model, step, (x, y), ("rbf_gram", "rbf_gram_bwd"),
            lambda: posterior_deviance(model, x, y.T, every),
            "Poisson deviance over the spots trained on", negative_elbo,
            lambda r: ((x, y, *draws(r)), {}), plain_rbf_kernels, seen,
            lambda: plain_rbf_kernels(rbf_gram_direct),
            # Kzx's cotangent comes from the SVGP's cholesky_solve with its
            # planes transposed: kernel 3's backward reads it in place
            no_copies=True))
        del model, step
        torch.cuda.empty_cache()
    return dict(launches)


def vnngp_sweep_leg(dev):
    """[vnngp_sweep]'s configuration, model (seed 0), step and its arguments
    (x, y): benchmarks/nsf_sweep.py's --vnngp row, full batch, every leaf
    trained, data simulated at 4 factors."""
    import torch
    from gpzoo_tpu_torch import VNNGPConfig, make_train_step, negative_elbo
    from gpzoo_tpu_torch.data import simulate_nsf_counts

    v = VNNGP_SWEEP
    cfg = VNNGPConfig(D=v["D"], N=v["N"], L=v["L"], M=v["M"], K=v["K"])
    coords, counts, _ = simulate_nsf_counts(N=cfg.N, D=cfg.D, L=4)
    x = torch.from_numpy(coords).to(dev)
    y = torch.from_numpy(counts).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x)
    step = make_train_step(negative_elbo, cfg.optimizer(model), cfg.N, cfg.L, gen, E=cfg.E)
    return cfg, model, step, (x, y)


def phase_vnngp_sweep(checks, dev, seen):
    """benchmarks/nsf_sweep.py's --vnngp row (run_vnngp) at its published
    width: VNNGPConfig D = 200, N = 5,000, L = 10, M = 1,000, K = 8, E = 3,
    Adam 5e-3, full batch through negative_elbo, every leaf trained (kernel 3
    forward and backward, kernel 5 over L x N points), data simulated at 4
    factors. Quality: as [nsf_sweep]."""
    import torch
    from gpzoo_tpu_torch import negative_elbo
    from gpzoo_tpu_torch.data import posterior_deviance

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, step, (x, y) = vnngp_sweep_leg(dev)
    log(f"[vnngp_sweep] NSF over VNNGP, full batch, N={cfg.N} D={cfg.D} L={cfg.L} "
        f"M={cfg.M} K={cfg.K} E={cfg.E}, every leaf trained")
    draws = _fixed_draws(dev, [(cfg.E, cfg.L, cfg.N)])
    launches = generic_leg(
        checks, "vnngp_sweep", model, step, (x, y),
        ("rbf_gram", "block_conditional", "rbf_gram_bwd", "block_conditional_bwd"),
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

    launches = generic_leg(checks, "svgp_regression", model, step, (x, y),
                           ("rbf_gram", "rbf_gram_bwd"),
                           rmse, "posterior-mean RMSE against 2 sin(2x)", negative_elbo,
                           lambda r: ((x, y, *draws(r)), {}), plain_rbf_kernels, seen,
                           lambda: plain_rbf_kernels(rbf_gram_direct))
    del model, step
    torch.cuda.empty_cache()
    return launches


def _warmstart_pnmf(checks, dev, tag, w):
    """The data of examples/slideseq_mggp_hybrid.py at the widths ``w``
    (simulate_nsf_counts at the spatial factor count, seed 0; group labels
    from default_rng(0)) and its PNMF (E = 1, unnormalized, Adam 1e-2, full
    batch, w["pnmf_steps"] steps), on the card. Returns (x, y, groups, the
    simulated factors, the PNMF, the generator)."""
    import torch
    from gpzoo_tpu_torch import PNMFConfig, make_train_step, pnmf_negative_elbo
    from gpzoo_tpu_torch.data import simulate_nsf_counts

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
        f"ms/step (host clock); loss {float(losses[0]):.6e} -> {float(losses[-1]):.6e}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    checks.true(f"{tag} PNMF losses finite", bool(torch.isfinite(losses).all()))
    checks.true(f"{tag} PNMF loss falls", float(losses[-5:].mean()) < float(losses[:5].mean()))
    return x, y, groups, truth, pnmf, gen


def _warmstart_assemble(checks, tag, w, gen, pnmf, x, groups, truth, judge=None):
    """hybrid_mggp_from_pnmf, timed, whose Moran ranking runs on x's card;
    the ranking must be a permutation that puts first the PNMF factors that
    best match the simulated spatial ones (judged by ``judge``, by default
    ``checks.true``). Returns (model, order, Moran's I, the ranked factors
    (N, L_total) on the card)."""
    import torch
    from gpzoo_tpu_torch import warmstart
    from gpzoo_tpu_torch.data.metrics import best_match_correlation

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, order, moran = warmstart.hybrid_mggp_from_pnmf(
        gen, pnmf, x, groups, L_spatial=w["L_spatial"], m_per_group=w["M_per_group"],
        n_groups=w["G"])
    torch.cuda.synchronize()
    log(f"  Moran ranking (on the card) and assembly: {time.perf_counter() - t0:.3f}s; order "
        f"{order.tolist()}, Moran's I {[round(float(v), 4) for v in moran]}")
    checks.true(f"{tag} ranking is a permutation",
                sorted(order.tolist()) == list(range(w["L_total"])))
    # the matching of the simulated factors to all PNMF factors that
    # maximizes their summed correlation takes the top-ranked ones
    with torch.no_grad():
        factors = torch.softmax(pnmf.prior()[0].mean, dim=-1)
    host = factors.double().cpu().numpy()
    top = best_match_correlation(truth, host[order[:w["L_spatial"]]])
    best = best_match_correlation(truth, host)
    log(f"  simulated factors' correlation with the top-ranked {w['L_spatial']} PNMF "
        f"factors {np.round(top, 4).tolist()} (sum {top.sum():.4f}), with the best "
        f"{w['L_spatial']} of all {np.round(best, 4).tolist()} (sum {best.sum():.4f})")
    (judge or checks.true)(
        f"{tag} ranks the PNMF factors matching the simulated spatial ones first",
        top.sum() >= best.sum() - 1e-9)
    return model, order, moran, factors.T


def _warmstart_finetune(checks, dev, tag, w, gen, model, x, y, groups, deviance):
    """The hybrid's fine-tune with the kernel frozen (Adam 1e-3, batch
    w["B"], E = 3, ``groups_x``; kernel 4 forward, and backward for Z)
    through :func:`generic_leg`, ``deviance()`` its quality. Returns the
    launches."""
    import torch
    from gpzoo_tpu_torch import freeze_, make_batched_train_step, negative_elbo_hybrid_batched

    freeze_(model, lambda path: ".kernel." not in path)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-3)
    kw = {"groups_x": groups}
    step = make_batched_train_step(negative_elbo_hybrid_batched, opt, w["N"], w["B"],
                                   w["L_spatial"], gen, E=3, loss_kwargs=kw)
    idx = torch.randperm(w["N"], generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)[:w["B"]]
    draws = _fixed_draws(dev, [(3, w["L_spatial"], w["B"]),
                               (3, w["L_total"] - w["L_spatial"], w["B"])])
    return generic_leg(
        checks, tag, model, step, (x, y), ("mggp_gram", "mggp_gram_bwd"), deviance,
        "Poisson deviance over every spot", negative_elbo_hybrid_batched,
        lambda r: ((x, y, idx, *draws(r)), kw), plain_mggp_kernels)


def phase_warmstart(checks, dev):
    """examples/slideseq_mggp_hybrid.py at its default widths (N = 4,000,
    D = 200, 8 PNMF factors, 4 spatial, 4 groups x 40 inducing points, batch
    1,000, E = 3): PNMF (E = 1, unnormalized, Adam 1e-2, full batch, the
    example's 1,500 steps), the Moran ranking (dims_autocorr, on the card),
    which must put first the PNMF factors that best match the 4 simulated
    spatial factors, hybrid_mggp_from_pnmf, then negative_elbo_hybrid_batched
    with the kernel frozen (Adam 1e-3; kernel 4 forward, and backward for
    Z). Quality: the hybrid's posterior-mean deviance over every spot."""
    import torch
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance

    w = WARMSTART
    log(f"[warmstart] PNMF -> Moran ranking -> Hybrid-MGGP fine-tune, N={w['N']} "
        f"D={w['D']} PNMF L={w['L_total']} spatial {w['L_spatial']} M={w['G']} x "
        f"{w['M_per_group']} batch={w['B']}")
    x, y, groups, truth, pnmf, gen = _warmstart_pnmf(checks, dev, "warmstart", w)
    model, _, _, _ = _warmstart_assemble(checks, "warmstart", w, gen, pnmf, x, groups, truth)
    launches = _warmstart_finetune(
        checks, dev, "warmstart", w, gen, model, x, y, groups,
        lambda: hybrid_posterior_deviance(model, x, y.T, torch.arange(w["N"], device=dev),
                                          groups))
    del model, pnmf
    torch.cuda.empty_cache()
    return launches


def graph_vs_host(checks, tag, x, factors, order, moran, top):
    """The Moran ranking an entry point made on the card (``order``,
    ``moran``: dims_autocorr's result for factors (N, P) over the
    coordinates x on the card) against the host route's on the same factors
    and coordinates: the rows whose KNN neighbour set differs between the
    card's graph and the host's (at most MAX_GRAPH_ROWS of the rows),
    Moran's I (within TOL_GRAPH_MORAN, absolute) and the top ``top``
    factors (the same set). A control graph, the card's with its product's
    operands rounded to TF32's 10 mantissa bits, must fail those limits.
    (The card's graph with TF32 allowed is printed beside it: cuBLAS keeps
    the K = 2 product off the tensor cores, so TF32 allowed leaves the
    graph as it is.) Prints each build's seconds and the graph's entries."""
    import torch
    from gpzoo_tpu_torch.data import metrics
    from gpzoo_tpu_torch.ops import precision

    def build(coords):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbr = metrics._knn_neighbours(coords)
        graph = metrics._symmetrize(nbr)
        torch.cuda.synchronize()
        return nbr.cpu().numpy(), graph, time.perf_counter() - t0

    host_nbr, host_graph, host_s = build(x.cpu().numpy())
    card_nbr, card_graph, card_s = build(x)
    with mock.patch.dict(precision.MODES, {"highest": "tf32"}):
        tf32_nbr, tf32_graph, tf32_s = build(x)
    mm = precision.mm
    with mock.patch.object(precision, "mm", lambda a, b, *rest: mm(
            round_mantissa(a, 10), round_mantissa(b, 10), *rest)):
        control_nbr, control_graph, _ = build(x)
    host_i = metrics.morans_i(factors, weights=host_graph)
    card_i = np.empty_like(host_i)
    card_i[order] = moran
    limit = MAX_GRAPH_ROWS * x.shape[0]

    def against_host(nbr, i_vals):
        rows = int((np.sort(nbr, axis=1) != np.sort(host_nbr, axis=1)).any(axis=1).sum())
        same = set(np.argsort(-i_vals)[:top].tolist()) == set(np.argsort(-host_i)[:top].tolist())
        return rows, float(np.abs(i_vals - host_i).max()), same

    log(f"  KNN graph of {x.shape[0]} spots: host route {host_s:.3f}s, card "
        f"{card_s:.3f}s (TF32 allowed {tf32_s:.3f}s); {len(card_graph[0])} entries on the "
        f"card, {len(host_graph[0])} on the host")
    results = {}
    for what, nbr, i_vals in (
            ("card", card_nbr, card_i),
            ("TF32 allowed", tf32_nbr, metrics.morans_i(factors, weights=tf32_graph)),
            ("control (TF32 operands)", control_nbr,
             metrics.morans_i(factors, weights=control_graph))):
        rows, gap, same = results[what] = against_host(nbr, i_vals)
        log(f"  {what} against host: {rows} rows with another neighbour set, Moran's I "
            f"{gap:.3e} apart at most, top-{top} set {'the same' if same else 'differs'}")
    rows, gap, same = results["card"]
    checks.true(f"{tag} card's graph: rows whose neighbour set differs from the host "
                f"route's {rows} (at most {limit:.0f})", rows <= limit)
    checks.le(f"{tag} Moran's I on the card against the host route (absolute)", gap,
              TOL_GRAPH_MORAN)
    checks.true(f"{tag} the same top-{top} factors on the card and the host route", same)
    rows, gap, same = results["control (TF32 operands)"]
    checks.true(f"{tag} control: the graph from TF32-rounded operands fails those limits",
                rows > limit or not gap <= TOL_GRAPH_MORAN or not same)


def dense_vs_card(checks, dev, n):
    """The card's KNN graph of the [warmstart] coordinates (the first n of
    simulate_nsf_counts' seed-0 draws) against the dense ``_knn_weights``
    on the host: identical."""
    import torch
    from gpzoo_tpu_torch.data import metrics, simulate_nsf_counts

    coords = simulate_nsf_counts(N=n, D=WARMSTART["D"], L=WARMSTART["L_spatial"], seed=0)[0]
    rows, cols, vals = (t.cpu().numpy() for t in
                        metrics._knn_graph(torch.from_numpy(coords).to(dev)))
    dense = metrics._knn_weights(coords)
    card = np.zeros_like(dense)
    card[rows, cols] = vals
    checks.true(f"KNN graph on the card at N = {n} identical to the dense _knn_weights "
                f"({int((card != dense).sum())} entries differ)", np.array_equal(card, dense))


def phase_warmstart_slideseq(checks, dev):
    """examples/slideseq_mggp_hybrid.py at its documented full Slideseq
    scale (N = 45,000, D = 4,000, 20 PNMF factors, 10 spatial, 14 groups x
    215 inducing points = M 3,010, batch 6,000, E = 3; jitter 1e-2, ℓ 4.0,
    α 0.7): first the card's KNN graph at N = 4,000 against the dense one;
    then PNMF (the example's 1,500 steps), hybrid_mggp_from_pnmf, whose
    Moran ranking runs on the card, held against the host route on the same
    factors and coordinates (:func:`graph_vs_host`) and checked as
    [warmstart] checks it; the kernel-frozen fine-tune through
    :func:`generic_leg` (the example's 2,000 steps cut to the generic legs'
    3 warm-up and 30 timed steps and a profiled window; kernel 4 at Kzz
    10 x 3,010² and Kzx 10 x 3,010 x 6,000, forward and backward for Z);
    then, as the example's last lines, the fine-tuned spatial half's
    posterior at all 45,000 spots (extract_factors, 6,000 spots a block:
    kernel 4 at Kzx 10 x 3,010 x 6,000) and its Moran's I. Quality: the
    posterior-mean deviance over every spot."""
    import torch
    from gpzoo_tpu_torch import extract_factors
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance

    w, tag = WARMSTART_SLIDESEQ, "warmstart_slideseq"
    log(f"[{tag}] PNMF -> Moran ranking on the card -> Hybrid-MGGP fine-tune at full "
        f"Slideseq scale, N={w['N']} D={w['D']} PNMF L={w['L_total']} spatial "
        f"{w['L_spatial']} M={w['G']} x {w['M_per_group']} batch={w['B']}")
    dense_vs_card(checks, dev, WARMSTART["N"])
    x, y, groups, truth, pnmf, gen = _warmstart_pnmf(checks, dev, tag, w)
    torch.cuda.reset_peak_memory_stats()
    # At 20 PNMF factors over 10 simulated ones the JAX reference fails the
    # ranking check too (tools/warmstart_ranking.py at N = 4,000, D = 200):
    # reported here, not failed on.
    model, order, moran, factors = _warmstart_assemble(checks, tag, w, gen, pnmf, x, groups,
                                                       truth, checks.report)
    log(f"  peak device memory of the ranking and assembly: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    graph_vs_host(checks, tag, x, factors, order, moran, w["L_spatial"])
    del pnmf, factors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    every = torch.arange(w["N"], device=dev)
    launches = _warmstart_finetune(
        checks, dev, tag, w, gen, model, x, y, groups,
        lambda: hybrid_posterior_deviance(model, x, y.T, every, groups, chunk_size=w["B"]))
    counters = _launch_counters(("mggp_gram", "mggp_gram_bwd"))
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spatial, order, moran = extract_factors(model.sf, x, groups=groups, chunk_size=w["B"])
    torch.cuda.synchronize()
    posterior = _read(counters)
    log(f"  fine-tuned spatial factors at all {w['N']} spots (extract_factors, "
        f"{w['B']} spots a block): {time.perf_counter() - t0:.3f}s, launches {posterior}; "
        f"Moran's I {[round(float(v), 4) for v in moran]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    checks.true(f"{tag} fine-tuned spatial factors finite, (L, N)",
                spatial.shape == (w["L_spatial"], w["N"]) and bool(np.isfinite(spatial).all()))
    checks.true(f"{tag} their Moran's I finite and descending",
                bool(np.isfinite(moran).all()) and bool(np.all(np.diff(moran) <= 0)))
    checks.true(f"mggp_gram launched in the {tag} posterior ({posterior['mggp_gram']})",
                posterior["mggp_gram"] > 0)
    del model, spatial
    torch.cuda.empty_cache()
    return {name: launches[name] + posterior[name] for name in launches}


# --- [parallel]: the sharded paths on two ranks of the one card ---------------
#
# The card is one H100 and NCCL takes one rank per card, so the two ranks run
# over gloo with CUDA tensors (gloo copies each reduced buffer through the
# host), and a second run drives a 1-rank NCCL group. What these runs measure
# is the split of the work and the memory over ranks, not multi-card scaling.

PARALLEL = dict(world=2, steps=3, ngd_steps=2, timeout=600)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


@functools.lru_cache(maxsize=1)
def _ns_arrays(n, d, dev):
    """:func:`nsf_arrays`, made once a process for [parallel]'s north-star
    runs (cleared before the parent spawns the ranks)."""
    return nsf_arrays(n, d, dev)


def _ns_setup(shapes, dev):
    """The north-star configuration, its model from seed 0 and [main]'s data."""
    import torch
    from gpzoo_tpu_torch import SlideseqNSFConfig

    m = shapes["MAIN"]
    cfg = SlideseqNSFConfig(N=m["N"], D=m["D"], L=m["L"], M=m["M"], batch_size=m["B"])
    x, y = _ns_arrays(m["N"], m["D"], dev)
    return cfg, cfg.build(torch.Generator(device=dev).manual_seed(0), x), x, y


def _first_grads(opt, model, into):
    """Keep the gradients that ``opt`` applies at its first step (after a
    sharded step's reductions) in ``into``, by parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}

    def hook(optimizer, args, kwargs):
        if not into:
            into.update({names[id(p)]: p.grad.detach().clone()
                         for g in optimizer.param_groups for p in g["params"]
                         if p.grad is not None})

    return opt.register_step_pre_hook(hook)


def _mggp_setup(shapes, dev):
    """[mggp]'s configuration, data and init (seed 0)."""
    import torch
    from torch import nn
    from gpzoo_tpu_torch import MGGPNSFConfig

    m = shapes["MGGP"]
    cfg = MGGPNSFConfig(D=m["D"], N=m["N"], L=m["L"], M_per_group=m["M_per_group"],
                        n_groups=m["G"], batch_size=m["B"])
    x, y, g = mggp_data(dev, m["N"], m["D"], m["G"])
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cfg.build(gen, x, g)
    model.gp.mu = nn.Parameter(0.1 * torch.randn((cfg.L, cfg.M), generator=gen, device=dev))
    model.gp.Lu_raw = nn.Parameter(torch.zeros((cfg.L, cfg.M, cfg.M), device=dev))
    kw = dict(microbatch=m["B"], factored=True, y_transposed=True, groups=g, remat=False,
              **HIGHEST)
    return cfg, model, x, y, kw


def _vnngp_setup(shapes, dev, counts=False, gen=None):
    """[vnngp]'s configuration, its model built from ``gen`` (default a
    generator seeded 0), its coordinates and, with ``counts``, its counts
    (N, D), numpy seed 0 as [vnngp] draws them."""
    import torch
    from gpzoo_tpu_torch import VNNGPConfig

    v = shapes["VNNGP"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-2, 2, size=(v["N"], 2)).astype(np.float32)).to(dev)
    y = (torch.from_numpy(rng.poisson(2.0, size=(v["N"], v["D"])).astype(np.float32))
         .to(dev) if counts else None)
    cfg = VNNGPConfig(N=v["N"], D=v["D"], L=v["L"], M=v["M"], K=v["K"], E=1)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, cfg.build(gen, x), x, y


def _host(tree):
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def parallel_references(shapes, dev, workdir):
    """The unsharded runs that the ranks are held against, on the same init
    and draws, saved to ``workdir``: PARALLEL["steps"] north-star Adam steps
    (losses, the first step's gradients, the leaves after), PARALLEL
    ["ngd_steps"] NGD steps, the VNNGP posterior, one MGGP step with its
    variance-floor decisions, and PARALLEL["steps"] steps each of [fast]'s
    blockwise loss and of the VNNGP all-trainable loss, with theirs."""
    import torch
    from gpzoo_tpu_torch import (latent_posterior, make_batched_train_step,
                                 make_ngd_train_step, nsf_negative_elbo_batched,
                                 nsf_negative_elbo_precomputed,
                                 precompute_nsf_projection,
                                 vnngp_nsf_negative_elbo_batched)
    from gpzoo_tpu_torch.train.ngd import HeadAdam, ngd_create

    steps, n_train = shapes["PARALLEL"]["steps"], shapes["MAIN"]["N"] - shapes["HOLDOUT"]
    cfg, model, x, y = _ns_setup(shapes, dev)
    proj = precompute_nsf_projection(model, x)
    opt, grads = cfg.optimizer(model), {}
    _first_grads(opt, model, grads)
    step = make_batched_train_step(nsf_negative_elbo_precomputed, opt, n_train,
                                   cfg.batch_size, cfg.L,
                                   torch.Generator(device=dev).manual_seed(1), E=cfg.E,
                                   loss_kwargs={"y_transposed": True})
    losses = [float(step(model, proj, y)) for _ in range(steps)]
    torch.save({"losses": losses, "grads": _host(grads),
                "final": _host(dict(model.named_parameters()))},
               os.path.join(workdir, "ns_ref.pt"))
    del model, opt, step, grads

    ngd = shapes["NGD"]
    _, model, _, _ = _ns_setup(shapes, dev)
    state, head = ngd_create(model, HeadAdam(cfg.lr),
                             torch.Generator(device=dev).manual_seed(1))
    mu0, prec0 = model.prior.mu.detach().cpu().clone(), state.prec.cpu().clone()
    step = make_ngd_train_step(head, n_train, cfg.batch_size, ngd["nat_lr"], ngd["ramp"],
                               E=cfg.E, loss_kwargs={"y_transposed": True},
                               max_f=ngd["max_f"])
    ngd_losses = [float(state.advance(step, (proj, y)))
                  for _ in range(shapes["PARALLEL"]["ngd_steps"])]
    torch.save({"losses": ngd_losses, "mu0": mu0, "prec0": prec0,
                "mu": model.prior.mu.detach().cpu(), "prec": state.prec.cpu(),
                "W_raw": model.W_raw.detach().cpu(), "V_raw": model.V_raw.detach().cpu(),
                "rejected": int(step.rejected)}, os.path.join(workdir, "ngd_ref.pt"))
    del state, model, step, proj

    cfg, model, _, _ = _ns_setup(shapes, dev)
    kw = dict(FAST_KW, microbatch=cfg.batch_size)
    model64 = copy.deepcopy(model).double()
    ref = _unsharded_steps(dev, nsf_negative_elbo_batched, cfg, model, (x, y), kw, n_train,
                           cfg.batch_size, steps)
    del model
    ref.update(_float64_first_step(dev, cfg, model64, x, y, kw, ref, n_train,
                                   plain_rbf_kernels))
    torch.save(ref, os.path.join(workdir, "fast_ref.pt"))
    del model64, x, y, ref
    _ns_arrays.cache_clear()

    vcfg, vmodel, vx, vy = _vnngp_setup(shapes, dev, counts=True)
    torch.save(_unsharded_steps(dev, vnngp_nsf_negative_elbo_batched, vcfg,
                                copy.deepcopy(vmodel), (vx, vy), VNNGP_STEP_KW,
                                shapes["VNNGP"]["N"] - shapes["HOLDOUT"],
                                shapes["VNNGP"]["B"], steps),
               os.path.join(workdir, "vnngp_step_ref.pt"))
    del vy
    with torch.no_grad():
        mean, scale = latent_posterior(vmodel.prior, vx)
    torch.save({"mean": mean.cpu(), "scale": scale.cpu()},
               os.path.join(workdir, "vnngp_ref.pt"))
    del vmodel, vx, mean, scale

    mcfg, mmodel, mx, my, kw = _mggp_setup(shapes, dev)
    model64 = copy.deepcopy(mmodel).double()
    n_train = shapes["MGGP"]["N"] - shapes["HOLDOUT"]
    ref = _unsharded_steps(dev, nsf_negative_elbo_batched, mcfg, mmodel, (mx, my), kw,
                           n_train, mcfg.batch_size, 1)
    del mmodel
    ref.update(_float64_first_step(dev, mcfg, model64, mx, my, kw, ref, n_train,
                                   plain_mggp_kernels))
    torch.save(ref, os.path.join(workdir, "mggp_ref.pt"))
    del model64, mx, my, kw, ref
    mggp_data.cache_clear()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _unsharded_steps(dev, loss_fn, cfg, model, args, kw, n_train, batch, steps):
    """``steps`` unsharded Adam steps of ``loss_fn`` over ``cfg``'s optimizer
    and batch from draws seeded 1: the losses, the first step's gradients,
    the leaves after and every variance-floor decision, on the host."""
    import torch
    from gpzoo_tpu_torch import make_batched_train_step

    opt, grads, masks = cfg.optimizer(model), {}, []
    _first_grads(opt, model, grads)
    step = make_batched_train_step(loss_fn, opt, n_train, batch, cfg.L,
                                   torch.Generator(device=dev).manual_seed(1), E=cfg.E,
                                   loss_kwargs=kw)
    with clamp_decisions(masks):
        losses = [float(step(model, *args)) for _ in range(steps)]
    return {"losses": losses, "grads": _host(grads),
            "final": _host(dict(model.named_parameters())),
            "masks": [m.cpu() for m in masks]}


def _float64_first_step(dev, cfg, model64, x, y, kw, ref, n_train, plain):
    """[mggp]'s reference for the first step of a run ``ref`` of
    :func:`_unsharded_steps`: the blockwise loss's gradients in float64 on
    ``model64`` (the init) with the kernels' plain versions (``plain``), on
    the first step's draws and floor decisions. Float32 rounding through
    Kzz⁻¹ moves some leaves' gradients in any float32 step; this is what
    both the unsharded and the sharded step are held against."""
    import torch

    g1 = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randperm(n_train, generator=g1, device=dev)[:cfg.batch_size]
    eps = torch.randn((cfg.E, cfg.L, cfg.batch_size), generator=g1, device=dev)
    first = ref["masks"][:len(ref["masks"]) // len(ref["losses"])]
    with plain(), clamp_decisions([m.to(dev) for m in first]) as flips:
        _, grads64 = _blockwise_loss_grad(model64, x.double(), y.double(), idx,
                                          eps.double(), **kw)
    return {"grads64": _host({k: v.float() for k, v in grads64.items()}),
            "flips64": flips[0]}


def _split_block(model, sh):
    """(``block``, the names of ``model``'s parameters that ``sh`` splits):
    ``block(name, t)`` is the rows of a full tensor ``t`` that this rank
    holds of parameter ``name`` if it is split, else ``t``."""
    split = {n for n, p in model.named_parameters()
             if sh is not None and sh.sharded(n.split(".")[-1], p, local=True)}

    def block(name, t):
        return sh.placement.block(t) if name in split else t

    return block, split


def _float64_rule(grads, ref, block):
    """[mggp]'s rule for a rank's first-step gradients ``grads``: within
    TOL_STEP_GRAD of float64 (``ref["grads64"]``), or no further from it
    than twice the unsharded float32 step is, each over this rank's
    block."""
    err64 = {n: _rel(block(n, ref["grads"][n]), block(n, ref["grads64"][n]))
             for n in grads}
    return dict(grad64_rel={n: _rel(g, block(n, ref["grads64"][n]))
                            for n, g in grads.items()},
                err64=err64, limit64={n: max(TOL_STEP_GRAD, 2 * err64[n]) for n in grads},
                flips64=ref["flips64"])


def _rel(a, b):
    """max|a − b| / max|b| as a float (0 for two empty tensors)."""
    return norm_err(a.float(), b.to(a.device).float()) if b.numel() else 0.0


def _bitwise_same_as_rank0(t):
    """Whether ``t`` equals rank 0's tensor of the same name bit for bit (a
    broadcast of rank 0's copy)."""
    import torch
    from gpzoo_tpu_torch.parallel.collectives import broadcast

    theirs = broadcast(t.detach().clone())
    return bool(torch.equal(theirs.view(torch.uint8) if theirs.is_floating_point() else theirs,
                            t.detach().view(torch.uint8) if t.is_floating_point() else t))


def _timed_run(dev, counters, run, steps):
    """Zero the launch counts and the all-reduce byte count, run ``steps``
    calls of ``run()`` (each synchronised), and read both back: (losses, ms
    per call, launches, bytes all-reduced per call, peak GiB)."""
    from gpzoo_tpu_torch.parallel.collectives import all_reduce

    _sync(dev)
    _reset_peak(dev)
    _zero(counters)
    bytes0 = all_reduce.bytes
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(run()))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return (losses, ms, _read(counters), (all_reduce.bytes - bytes0) / steps,
            _peak_gib(dev))


def _rank_north_star(shapes, dev, workdir, mesh_spec):
    """The north-star Adam step under ``mesh_spec`` (every rank builds the
    same model; rank 0's is broadcast; under a factor axis each rank keeps
    its block of the per-factor leaves). Under a data axis the counts are
    split by columns (the step gathers each minibatch's columns); under a
    factor axis they stay whole. Returns (record, state, make_step, args):
    ``make_step(state)`` builds the step over a state's optimizer and
    generator."""
    import torch
    from gpzoo_tpu_torch import nsf_negative_elbo_precomputed, precompute_nsf_projection
    from gpzoo_tpu_torch.parallel import (create_mesh, make_sharded_batched_train_step,
                                          replicate, shard_columns, shard_factor_params)
    from gpzoo_tpu_torch.train import TrainState

    mesh = create_mesh(mesh_spec, dev.type)
    cfg, model, x, y = _ns_setup(shapes, dev)
    replicate(mesh, model)
    state = TrainState(model, cfg.optimizer(model), torch.Generator(device=dev).manual_seed(1))
    if mesh_spec.get("factor", 1) > 1:
        state, _ = shard_factor_params(mesh, state, cfg.L)
    proj = precompute_nsf_projection(model, x)
    if mesh_spec.get("data", 1) > 1:
        y, kw = shard_columns(mesh, y.T.contiguous()), {}
    else:
        kw = {"y_transposed": True}
    n_train = shapes["MAIN"]["N"] - shapes["HOLDOUT"]

    def make_step(st):
        return make_sharded_batched_train_step(
            nsf_negative_elbo_precomputed, st.optimizer, n_train, cfg.batch_size, cfg.L,
            st.generator, mesh, E=cfg.E, loss_kwargs=kw, state_shardings=st.shardings)

    grads = {}
    hook = _first_grads(state.optimizer, model, grads)
    step = make_step(state)
    counters = _launch_counters(TRI + KL)
    losses, ms, launches, reduced, peak = _timed_run(
        dev, counters, lambda: state.advance(step, (proj, y)), shapes["PARALLEL"]["steps"])
    hook.remove()
    rec = _compare_leaves(state, torch.load(os.path.join(workdir, "ns_ref.pt")), grads,
                          losses)
    rec.update(ms=ms, launches=launches, bytes_per_step=reduced, peak_gib=peak)
    return rec, state, make_step, (proj, y)


def _compare_leaves(state, ref, grads, losses):
    """Losses, the first step's gradients and the leaves after the steps
    against the unsharded run's (a factor-split leaf against its rows), and
    whether every leaf that is not split equals rank 0's bit for bit."""
    sh = state.shardings
    rec = {"losses": losses, "ref_losses": ref["losses"],
           "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
           "grad_rel": {}, "leaf_rel": {}, "replicated_same": True}
    for name, p in state.model.named_parameters():
        split = sh is not None and sh.sharded(name.split(".")[-1], p, local=True)

        def block(t, split=split):
            return sh.placement.block(t) if split else t

        if name in grads:
            rec["grad_rel"][name] = _rel(grads[name], block(ref["grads"][name]))
        if p.requires_grad:
            rec["leaf_rel"][name] = _rel(p.detach(), block(ref["final"][name]))
        if not split:
            rec["replicated_same"] &= _bitwise_same_as_rank0(p)
    return rec


def _rank_checkpoint(workdir, state, make_step, args):
    """Save the factor-split state (one file a rank), restore it with its
    placement into a fresh template, take one more step from both, and
    compare the two runs bit for bit."""
    import torch
    from gpzoo_tpu_torch.parallel.sharding import named_leaves
    from gpzoo_tpu_torch.train import (make_restore_template, restore_checkpoint,
                                       save_checkpoint)

    path = os.path.join(workdir, "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(path, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = restore_checkpoint(path, make_restore_template(state))
    restore_s = time.perf_counter() - t0
    live = float(state.advance(make_step(state), args))
    resumed = float(restored.advance(make_step(restored), args))
    pairs = list(zip(named_leaves(state), named_leaves(restored)))
    same = all(torch.equal(a, b) for (_, _, a), (_, _, b) in pairs
               if isinstance(a, torch.Tensor))
    return dict(save_s=save_s, restore_s=restore_s, live=live, resumed=resumed,
                same=same and len(pairs) > 0,
                files=sorted(f for f in os.listdir(workdir) if f.startswith("ckpt")),
                file_bytes=os.path.getsize(f"{path}.shard0"))


def _rank_ngd(shapes, dev, workdir):
    """PARALLEL["ngd_steps"] NGD steps under {"data": 2}: the losses, Δμ and
    ΔP against the unsharded run's, the head's leaves (reported), the
    rejected count, and μ, P, W and V bit-identical across the ranks."""
    import torch
    from gpzoo_tpu_torch import precompute_nsf_projection
    from gpzoo_tpu_torch.parallel import create_mesh, replicate
    from gpzoo_tpu_torch.train.ngd import HeadAdam, make_ngd_train_step, ngd_create

    ngd = shapes["NGD"]
    mesh = create_mesh({"data": shapes["PARALLEL"]["world"]}, dev.type)
    cfg, model, x, y = _ns_setup(shapes, dev)
    replicate(mesh, model)
    state, head = ngd_create(model, HeadAdam(cfg.lr),
                             torch.Generator(device=dev).manual_seed(1))
    proj = precompute_nsf_projection(model, x)
    step = make_ngd_train_step(head, shapes["MAIN"]["N"] - shapes["HOLDOUT"],
                               cfg.batch_size, ngd["nat_lr"], ngd["ramp"], E=cfg.E,
                               loss_kwargs={"y_transposed": True}, mesh=mesh,
                               max_f=ngd["max_f"])
    losses, ms, _, reduced, peak = _timed_run(
        dev, {}, lambda: state.advance(step, (proj, y)), shapes["PARALLEL"]["ngd_steps"])
    ref = torch.load(os.path.join(workdir, "ngd_ref.pt"))
    mu = model.prior.mu.detach()
    return dict(
        losses=losses, ref_losses=ref["losses"],
        loss_rel=max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        dmu_rel=_rel(mu - ref["mu0"].to(dev), ref["mu"] - ref["mu0"]),
        dprec_rel=_rel(state.prec - ref["prec0"].to(dev), ref["prec"] - ref["prec0"]),
        head_rel={n: _rel(getattr(model, n).detach(), ref[n]) for n in ("W_raw", "V_raw")},
        rejected=int(step.rejected), ref_rejected=ref["rejected"],
        replicated_same=all(_bitwise_same_as_rank0(t) for t in
                            (mu, state.prec, model.W_raw, model.V_raw)),
        ms=ms, bytes_per_step=reduced, peak_gib=peak)


def _rank_vnngp(shapes, dev, workdir):
    """The VNNGP posterior over every spot under {"data": 2} against the
    unsharded one."""
    import torch
    from gpzoo_tpu_torch import latent_posterior
    from gpzoo_tpu_torch.parallel import create_mesh, replicate

    mesh = create_mesh({"data": shapes["PARALLEL"]["world"]}, dev.type)
    _, model, x, _ = _vnngp_setup(shapes, dev)
    replicate(mesh, model)
    counters = _launch_counters(("rbf_gram", "block_conditional"))

    def run():
        with torch.no_grad():
            run.out = latent_posterior(model.prior, x, mesh=mesh)
        return 0.0

    _, ms, launches, reduced, peak = _timed_run(dev, counters, run, 1)
    ref = torch.load(os.path.join(workdir, "vnngp_ref.pt"))
    mean, scale = run.out
    return dict(mean_rel=_rel(mean, ref["mean"]), scale_rel=_rel(scale, ref["scale"]),
                shape=list(mean.shape), ms=ms, launches=launches,
                bytes_per_call=reduced, peak_gib=peak)


def _rank_masks(masks, mesh, batch, n_factors, dev):
    """This rank's part of an unsharded run's variance-floor decisions: its
    block of the batch's columns under a data axis, its factor rows under a
    factor axis (a decision without a factor axis, such as the collapsed
    VNNGP marginal's (B,), is the same on every factor rank)."""
    from gpzoo_tpu_torch.parallel.mesh import axis_size

    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for m in masks:
        if "data" in coords and m.shape[-1] == batch:
            part = batch // axis_size(mesh, "data")
            m = m[..., coords["data"] * part:(coords["data"] + 1) * part]
        if "factor" in coords and m.ndim >= 2 and m.shape[-2] == n_factors:
            rows = n_factors // axis_size(mesh, "factor")
            m = m[..., coords["factor"] * rows:(coords["factor"] + 1) * rows, :]
        out.append(m.to(dev))
    return out


def _rank_mggp(shapes, dev, workdir, mesh_spec):
    """One MGGP step under ``mesh_spec`` against the unsharded step, under
    that step's variance-floor decisions (this rank's columns of them under
    {"data": 2}, its factor rows under {"factor": 2}, where σ, ℓ, μ and Lu
    are split and α (L, 1, 1) and the embedding stay whole)."""
    import torch
    from gpzoo_tpu_torch import nsf_negative_elbo_batched
    from gpzoo_tpu_torch.parallel import (create_mesh, make_sharded_batched_train_step,
                                          replicate, shard_factor_params)

    mesh = create_mesh(mesh_spec, dev.type)
    cfg, model, x, y, kw = _mggp_setup(shapes, dev)
    replicate(mesh, model)
    sh = None
    if mesh_spec.get("factor", 1) > 1:
        model, sh = shard_factor_params(mesh, model, cfg.L)
    opt, grads = cfg.optimizer(model), {}
    _first_grads(opt, model, grads)
    step = make_sharded_batched_train_step(
        nsf_negative_elbo_batched, opt, shapes["MGGP"]["N"] - shapes["HOLDOUT"],
        cfg.batch_size, cfg.L, torch.Generator(device=dev).manual_seed(1), mesh,
        E=cfg.E, loss_kwargs=kw, state_shardings=sh)
    ref = torch.load(os.path.join(workdir, "mggp_ref.pt"))
    masks = _rank_masks(ref["masks"], mesh, cfg.batch_size, cfg.L, dev)
    counters = _launch_counters(("mggp_gram", "mggp_gram_bwd") + TRI_DA)
    with clamp_decisions(masks) as flips:
        losses, ms, launches, reduced, peak = _timed_run(
            dev, counters, lambda: step(model, x, y), 1)
    params, (block, split) = dict(model.named_parameters()), _split_block(model, sh)
    return dict(losses=losses, ref_losses=ref["losses"],
                loss_rel=abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
                grad_rel={n: _rel(g, block(n, ref["grads"][n])) for n, g in grads.items()},
                **_float64_rule(grads, ref, block),
                replicated_same=all(_bitwise_same_as_rank0(p) for n, p in params.items()
                                    if n not in split),
                whole_kernel_same=all(_bitwise_same_as_rank0(params[f"gp.kernel.{n}"])
                                      for n in ("group_diff_param", "embedding")),
                flips=flips[0], ms=ms, launches=launches, bytes_per_step=reduced,
                peak_gib=peak)


def _rank_factor_steps(shapes, dev, workdir, leg):
    """PARALLEL["steps"] Adam steps under {"factor": 2} of bench.py's
    ``--loss fast`` leg (``leg`` "fast": the north-star model, Z and the
    kernel frozen) or of its VNNGP all-trainable leg ("vnngp": σ and ℓ
    trained through the collapse), under the unsharded run's floor
    decisions, against that run (``parallel_references``). The VNNGP record
    also says whether the collapsed σ and ℓ got their whole first-step
    gradient in global factor 0 and exactly 0 in every other row."""
    import torch
    from gpzoo_tpu_torch import nsf_negative_elbo_batched, vnngp_nsf_negative_elbo_batched
    from gpzoo_tpu_torch.parallel import (create_mesh, make_sharded_batched_train_step,
                                          replicate, shard_factor_params)
    from gpzoo_tpu_torch.train import TrainState

    mesh = create_mesh({"factor": shapes["PARALLEL"]["world"]}, dev.type)
    if leg == "fast":
        cfg, model, x, y = _ns_setup(shapes, dev)
        loss_fn, kw, batch = (nsf_negative_elbo_batched,
                              dict(FAST_KW, microbatch=cfg.batch_size), cfg.batch_size)
        n_train, names = shapes["MAIN"]["N"] - shapes["HOLDOUT"], TRI + KL + ("rbf_gram",)
    else:
        cfg, model, x, y = _vnngp_setup(shapes, dev, counts=True)
        loss_fn, kw, batch = vnngp_nsf_negative_elbo_batched, VNNGP_STEP_KW, \
            shapes["VNNGP"]["B"]
        n_train = shapes["VNNGP"]["N"] - shapes["HOLDOUT"]
        names = ("rbf_gram", "block_conditional", "rbf_gram_bwd",
                 "block_conditional_bwd") + KL
    replicate(mesh, model)
    state = TrainState(model, cfg.optimizer(model),
                       torch.Generator(device=dev).manual_seed(1))
    state, sh = shard_factor_params(mesh, state, cfg.L)
    grads = {}
    hook = _first_grads(state.optimizer, model, grads)
    step = make_sharded_batched_train_step(
        loss_fn, state.optimizer, n_train, batch, cfg.L, state.generator, mesh, E=cfg.E,
        loss_kwargs=kw, state_shardings=sh)
    ref = torch.load(os.path.join(workdir, {"fast": "fast_ref.pt",
                                            "vnngp": "vnngp_step_ref.pt"}[leg]))
    masks = _rank_masks(ref["masks"], mesh, batch, cfg.L, dev)
    with clamp_decisions(masks) as flips, plain_backward_calls() as plain_calls:
        losses, ms, launches, reduced, peak = _timed_run(
            dev, _launch_counters(names), lambda: state.advance(step, (x, y)),
            shapes["PARALLEL"]["steps"])
    hook.remove()
    rec = _compare_leaves(state, ref, grads, losses)
    rec.update(ms=ms, launches=launches, bytes_per_step=reduced, peak_gib=peak,
               flips=flips[0], plain_backward_calls=dict(plain_calls))
    if "grads64" in ref:
        rec.update(_float64_rule(grads, ref, _split_block(model, sh)[0]))
    if leg == "vnngp":
        first = sh.placement.index == 0
        rec["collapse_routed"] = all(
            bool(torch.all(g.reshape(g.shape[0], -1)[1:] == 0))
            and bool(torch.all(g.reshape(g.shape[0], -1)[0] != 0) if first
                     else torch.all(g == 0))
            for g in (grads["prior.kernel.sigma"], grads["prior.kernel.lengthscale"]))
    return rec


def parallel_rank(rank, world, workdir, shapes, backend):
    """One rank of [parallel]: joins the group (``backend`` over CUDA
    tensors on the one card, or the CPU), runs each sharded path, and
    writes its records to ``workdir/rank<rank>.json``."""
    import torch
    import torch.distributed as dist
    from gpzoo_tpu_torch.parallel import initialize_distributed

    dev = torch.device(shapes["device"], 0) if shapes["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend=backend, device_type=dev.type,
                           init_method="file://" + os.path.join(workdir, f"store{world}"),
                           rank=rank, world_size=world)
    out = {}
    try:
        if world == 1:
            rec, state, _, _ = _rank_north_star(shapes, dev, workdir, {"data": 1})
            ref = torch.load(os.path.join(workdir, "ns_ref.pt"))
            rec["bit_identical"] = rec["losses"] == ref["losses"] and all(
                torch.equal(p.detach().cpu(), ref["final"][n])
                for n, p in state.model.named_parameters())
            out["nccl"] = rec
        else:
            out["main_data"] = _rank_north_star(shapes, dev, workdir,
                                                {"data": world})[0]
            _empty(dev)
            rec, state, make_step, args = _rank_north_star(shapes, dev, workdir,
                                                           {"factor": world})
            out["main_factor"] = rec
            out["checkpoint"] = _rank_checkpoint(workdir, state, make_step, args)
            del state, make_step, args
            _empty(dev)
            out["ngd"] = _rank_ngd(shapes, dev, workdir)
            _empty(dev)
            out["vnngp"] = _rank_vnngp(shapes, dev, workdir)
            _empty(dev)
            out["mggp"] = _rank_mggp(shapes, dev, workdir, {"data": world})
            _empty(dev)
            out["fast_factor"] = _rank_factor_steps(shapes, dev, workdir, "fast")
            _empty(dev)
            out["mggp_factor"] = _rank_mggp(shapes, dev, workdir, {"factor": world})
            _empty(dev)
            out["vnngp_factor"] = _rank_factor_steps(shapes, dev, workdir, "vnngp")
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _empty(dev):
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def spawn_ranks(world, workdir, shapes, backend, timeout):
    """Run :func:`parallel_rank` on ``world`` processes (the ``spawn``
    method) and return their records; a rank that fails raises here with
    its traceback, and every process is ended before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(parallel_rank, args=(world, workdir, shapes, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"[parallel] ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(30)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _parallel_kernels(checks, dev, vnngp, world):
    """Kernels 1-5, and kernel 4's backward, against their plain versions at
    the shapes a rank of [parallel] gives them, each timed beside its bound."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    for l_dim, b, what in ((MAIN["L"] // world, MAIN["B"], "factor block"),
                           (MAIN["L"], MAIN["B"] // world, "data block")):
        t = {}
        _tri_case(checks, dev, g, l_dim, MAIN["M"], b,
                  f"{what} L={l_dim} M={MAIN['M']} B={b}", t)
        _log_timings(t, f" ({what} L={l_dim} M={MAIN['M']} B={b})")
        del t
        _empty(dev)
    n = vnngp["N"] // world
    _gram_case(checks, dev, g, *_gram_inputs(g, dev, vnngp["L"], n, vnngp["M"]),
               f"VNNGP posterior Kxz, a rank's block L={vnngp['L']} {n}x{vnngp['M']}", {})
    _empty(dev)
    m_mggp = MGGP["M_per_group"] * MGGP["G"]
    for l_dim, b, what in ((MGGP["L"], MGGP["B"] // world, "data block"),
                           (MGGP["L"] // world, MGGP["B"], "factor block")):
        t = {}
        label = f"MGGP Kzx, a rank's {what} L={l_dim} {m_mggp}x{b}"
        _mggp_case(checks, dev, g, m_mggp, b, l_dim, MGGP["G"], "SQUARED", label, t)
        _log_timings(t, f" ({label})")
        _empty(dev)
        # kernel 4's backward there, with the gradients the rank's MGGP step asks for
        _mggp_bwd_case(checks, dev, g, m_mggp, b, l_dim, MGGP["G"],
                       f"mggp Kzx, a rank's {what}", path_needs=MGGP_NEEDS)
        _empty(dev)
        # kernels 1-2 on the same rank's per-factor a = W·Kzx
        t = {}
        label = f"MGGP per-factor a, a rank's {what} L={l_dim} M={m_mggp} B={b}"
        _tri_case(checks, dev, g, l_dim, m_mggp, b, label, t, per_factor=True)
        _log_timings(t, f" ({label})")
        del t
        _empty(dev)
    _block_case(checks, dev, g, vnngp["L"] * n, vnngp["K"],
                f"posterior, a rank's n={vnngp['L'] * n}", {})
    _empty(dev)
    # kernel 8 at a factor rank's north-star KL
    _kl_trace_case(checks, dev, g, MAIN["L"] // world, MAIN["M"], "shared",
                   f"shared, a rank's factor block L={MAIN['L'] // world} M={MAIN['M']}")
    _empty(dev)


def _log_rank_run(checks, tag, recs, tol_grad=TOL_STEP_GRAD):
    """Report and check one Adam run's records, one per rank: the losses
    against the unsharded run's at TOL_STEP_LOSS, the first step's
    gradients against it at ``tol_grad`` (or, for a record with float64
    gradients, as [mggp] holds them), the leaves after the steps
    (reported), the replicated leaves bit for bit, and the launches."""
    for r, rec in enumerate(recs):
        log(f"  rank {r}: losses {[f'{v:.6e}' for v in rec['losses']]} (unsharded "
            f"{[f'{v:.6e}' for v in rec['ref_losses']]}); step ms "
            f"{[round(v, 2) for v in rec['ms']]}; peak {rec['peak_gib']:.3f} GiB; "
            f"all-reduced {rec['bytes_per_step'] / 1e6:.2f} MB a step; launches "
            f"{rec['launches']}")
        checks.le(f"{tag} rank {r} losses vs unsharded (relative)", rec["loss_rel"],
                  TOL_STEP_LOSS)
        if "grad64_rel" in rec:
            # [mggp]'s rule: within TOL_STEP_GRAD of float64, or no further
            # from it than twice the unsharded float32 step
            for name, err in rec["grad64_rel"].items():
                log(f"  rank {r} first step d{name}: vs unsharded "
                    f"{rec['grad_rel'][name]:.3e}; against float64 {err:.3e}, "
                    f"the unsharded step {rec['err64'][name]:.3e}")
                checks.le(f"{tag} rank {r} first step d{name} against float64", err,
                          rec["limit64"][name])
        else:
            for name, err in rec["grad_rel"].items():
                checks.le(f"{tag} rank {r} first step d{name} vs unsharded", err, tol_grad)
        if rec.get("leaf_rel"):
            log(f"  rank {r}: leaves after the steps vs unsharded, max|Δ|/max|ref| "
                f"(Adam's first steps move each entry by about lr whatever the "
                f"gradient's size, so this is reported, not held): "
                + ", ".join(f"{k} {v:.3e}" for k, v in rec["leaf_rel"].items()))
        if "replicated_same" in rec:
            checks.true(f"{tag} rank {r} replicated leaves bit-identical to rank 0's",
                        rec["replicated_same"])
        check_launches(checks, rec.get("launches", {}), f"the {tag} path, rank {r}")


def phase_parallel(checks, dev, vnngp):
    """The sharded paths (gpzoo_tpu_torch.parallel) on PARALLEL["world"]
    ranks of the one card over gloo with CUDA tensors, each held against the
    unsharded run on the same init and draws: the north-star step under
    {"data": 2} (counts split by columns) and under {"factor": 2}, a
    checkpoint of the factor-split state and its bit-identical resume, the
    NGD step under {"data": 2}, the VNNGP posterior over every spot and one
    MGGP step, both under {"data": 2}; under {"factor": 2}, bench.py's
    ``--loss fast`` leg (the shared-kernel collapse), one MGGP step and the
    VNNGP all-trainable leg (σ and ℓ through the collapse); then 3
    north-star steps in a 1-rank NCCL group, bit-identical to the unsharded
    ones. Kernels 1-5 are first held against their plain versions at a
    rank's shapes. Returns the ranks' kernel launches on these paths,
    summed."""
    import tempfile

    world = PARALLEL["world"]
    log(f"[parallel] {world} ranks on the one card over gloo with CUDA tensors, and "
        f"a 1-rank NCCL group: the split of work and memory over ranks, not "
        f"multi-card scaling")
    _parallel_kernels(checks, dev, vnngp, world)
    shapes = dict(MAIN=dict(MAIN), MGGP=dict(MGGP), NGD=dict(NGD), VNNGP=dict(vnngp),
                  HOLDOUT=HOLDOUT, PARALLEL=dict(PARALLEL), device=dev.type)
    with tempfile.TemporaryDirectory(prefix="gpzoo-parallel-") as workdir:
        t0 = time.perf_counter()
        parallel_references(shapes, dev, workdir)
        log(f"  the unsharded runs: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        ranks = spawn_ranks(world, workdir, shapes, "gloo", PARALLEL["timeout"])
        log(f"  {world} ranks: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        nccl = spawn_ranks(1, workdir, shapes, "nccl" if dev.type == "cuda" else "gloo",
                           PARALLEL["timeout"])[0]["nccl"]
        log(f"  the 1-rank group: {time.perf_counter() - t0:.1f}s")

    log(f"  north-star step, {{'data': {world}}}, {PARALLEL['steps']} steps "
        "(counts split by columns):")
    _log_rank_run(checks, "parallel data", [r["main_data"] for r in ranks])
    log(f"  north-star step, {{'factor': {world}}}, {PARALLEL['steps']} steps:")
    _log_rank_run(checks, "parallel factor", [r["main_factor"] for r in ranks])
    for r, rank in enumerate(ranks):
        c = rank["checkpoint"]
        log(f"  rank {r} checkpoint of the factor-split state: files {c['files']}, "
            f"{c['file_bytes'] / 1e9:.3f} GB a file, save {c['save_s']:.2f}s, restore "
            f"{c['restore_s']:.2f}s; the next step {c['live']:.6e} live, "
            f"{c['resumed']:.6e} resumed")
        checks.true(f"parallel checkpoint rank {r}: one file a rank",
                    c["files"] == [f"ckpt.shard{i}" for i in range(world)])
        checks.true(f"parallel checkpoint rank {r}: resume bit-identical",
                    c["live"] == c["resumed"] and c["same"])
    log(f"  NGD step, {{'data': {world}}}, {PARALLEL['ngd_steps']} steps:")
    for r, rank in enumerate(ranks):
        n = rank["ngd"]
        log(f"  rank {r}: losses {[f'{v:.6e}' for v in n['losses']]} (unsharded "
            f"{[f'{v:.6e}' for v in n['ref_losses']]}); Δμ {n['dmu_rel']:.3e}, ΔP "
            f"{n['dprec_rel']:.3e}; head leaves after the steps "
            f"{ {k: float(f'{v:.3e}') for k, v in n['head_rel'].items()} }; rejected "
            f"{n['rejected']} (unsharded {n['ref_rejected']}); step ms "
            f"{[round(v, 2) for v in n['ms']]}; peak {n['peak_gib']:.3f} GiB; all-reduced "
            f"{n['bytes_per_step'] / 1e6:.2f} MB a step")
        checks.le(f"parallel ngd rank {r} losses vs unsharded", n["loss_rel"], TOL_STEP_LOSS)
        checks.le(f"parallel ngd rank {r} Δμ vs unsharded", n["dmu_rel"], TOL_NGD)
        checks.le(f"parallel ngd rank {r} ΔP vs unsharded", n["dprec_rel"], TOL_NGD)
        checks.true(f"parallel ngd rank {r} rejected as unsharded",
                    n["rejected"] == n["ref_rejected"])
        checks.true(f"parallel ngd rank {r} μ, P, W, V bit-identical to rank 0's",
                    n["replicated_same"])
    for r, rank in enumerate(ranks):
        v = rank["vnngp"]
        log(f"  rank {r} VNNGP posterior over {v['shape'][-1]} spots, {{'data': {world}}}: "
            f"{v['ms'][0]:.1f} ms, peak {v['peak_gib']:.3f} GiB, all-reduced "
            f"{v['bytes_per_call'] / 1e6:.2f} MB; launches {v['launches']}")
        checks.le(f"parallel vnngp rank {r} posterior mean vs unsharded", v["mean_rel"],
                  TOL_BLOCK)
        checks.le(f"parallel vnngp rank {r} posterior scale vs unsharded", v["scale_rel"],
                  TOL_BLOCK)
        for name, count in v["launches"].items():
            checks.true(f"{name} launched on the parallel vnngp posterior, rank {r} "
                        f"({count})", count > 0)
    log(f"  MGGP step, {{'data': {world}}}, under the unsharded step's floor decisions:")
    _log_rank_run(checks, "parallel mggp", [r["mggp"] for r in ranks])
    for r, rank in enumerate(ranks):
        checks.le(f"parallel mggp rank {r} floor decisions taken otherwise",
                  rank["mggp"]["flips"], MAX_FLIPS)
    for run in ("mggp", "fast_factor"):
        checks.le(f"parallel {run.replace('_', ' ')} float64 step: floor decisions taken "
                  "otherwise", ranks[0][run]["flips64"], MAX_FLIPS)
    log(f"  bench.py's --loss fast leg, {{'factor': {world}}}, {PARALLEL['steps']} steps "
        "(the collapse; Z and the kernel frozen), under the unsharded run's floor "
        "decisions:")
    _log_rank_run(checks, "parallel fast factor", [r["fast_factor"] for r in ranks])
    log(f"  MGGP step, {{'factor': {world}}} (σ, ℓ, μ, Lu split; α and the embedding "
        "whole), under the unsharded step's floor decisions:")
    _log_rank_run(checks, "parallel mggp factor", [r["mggp_factor"] for r in ranks])
    log(f"  VNNGP all-trainable step, {{'factor': {world}}}, {PARALLEL['steps']} steps (σ "
        "and ℓ trained through the collapse), under the unsharded run's floor decisions:")
    _log_rank_run(checks, "parallel vnngp factor", [r["vnngp_factor"] for r in ranks])
    for r, rank in enumerate(ranks):
        for run in ("mggp", "mggp_factor"):
            checks.true(f"parallel {run.replace('_', ' ')} rank {r}: α and the embedding "
                        "bit-identical to rank 0's", rank[run]["whole_kernel_same"])
        checks.true(f"parallel vnngp factor rank {r}: the collapsed σ and ℓ gradients "
                    "whole in global factor 0 and exactly 0 in every other row",
                    rank["vnngp_factor"]["collapse_routed"])
        calls = rank["vnngp_factor"]["plain_backward_calls"]
        checks.true(f"parallel vnngp factor rank {r}: no plain backward called ({calls})",
                    not calls)
        for run in ("fast_factor", "mggp_factor", "vnngp_factor"):
            checks.le(f"parallel {run.replace('_', ' ')} rank {r} floor decisions taken "
                      "otherwise", rank[run]["flips"], MAX_FLIPS)
    log("  1-rank NCCL group, north-star step:")
    _log_rank_run(checks, "parallel nccl", [nccl])
    checks.true("parallel nccl: losses and leaves bit-identical to the unsharded step",
                nccl["bit_identical"])
    launches = collections.Counter()
    for rank in ranks:
        for run in ("main_data", "main_factor", "vnngp", "mggp", "fast_factor",
                    "mggp_factor", "vnngp_factor"):
            launches.update(rank[run]["launches"])
    launches.update(nccl["launches"])
    log(f"  launches on the [parallel] paths, all ranks: {dict(launches)}")
    return dict(launches)


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
    on_path.append(phase_small_mggp(checks, dev))
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
    on_path.append(phase_warmstart_slideseq(checks, dev))
    torch.cuda.empty_cache()
    on_path.append(phase_parallel(checks, dev, vnngp))
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
    for finding in checks.findings:
        log(f"finding (reported, not failed on): {finding}")
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
        "mggp_gram_bwd": ("gpzoo_tpu_torch/ops/csrc/mggp.cu",
                          "gpzoo_tpu/ops/gram_pallas.py:264"),
        "block_conditional": ("gpzoo_tpu_torch/ops/csrc/vnngp.cu",
                              "gpzoo_tpu/ops/vnngp_pallas.py:134"),
        # kernel 1 keeping c for its backward, the paths' forward where a
        # gradient is taken
        "tri_sq_colsum_c": ("gpzoo_tpu_torch/ops/csrc/tri.cu",
                            "gpzoo_tpu/ops/tri_pallas.py:302"),
        # kernel 1's backward: JAX's _fused_bwd, the vjp of the panel colsum;
        # dc = 2c·g by the scale pass from the kept c, or (on no path) by the
        # dc epilogue, which reruns the triangle
        "tri_dc_from_c": ("gpzoo_tpu_torch/ops/csrc/tri.cu",
                          "gpzoo_tpu/ops/tri_pallas.py:320"),
        "tri_dc": ("gpzoo_tpu_torch/ops/csrc/tri.cu", "gpzoo_tpu/ops/tri_pallas.py:320"),
        "tri_dlu": ("gpzoo_tpu_torch/ops/csrc/tri.cu", "gpzoo_tpu/ops/tri_pallas.py:320"),
        # kernel 6 reading c: dLu with dc = 2c·g formed from the kept c in
        # its loads, the route of a shared ã that takes no gradient
        "tri_dlu_from_c": ("gpzoo_tpu_torch/ops/csrc/tri.cu",
                           "gpzoo_tpu/ops/tri_pallas.py:320"),
        "tri_da": ("gpzoo_tpu_torch/ops/csrc/tri.cu", "gpzoo_tpu/ops/tri_pallas.py:320"),
        # kernel 7 reading c: da with dcᵀ = 2g·cᵀ formed from the kept c in
        # its loads, the route of every a that trains; kernel 7 on a dcᵀ
        # (tri_da) runs only in kernel 2's backward, on no path
        "tri_da_from_c": ("gpzoo_tpu_torch/ops/csrc/tri.cu",
                          "gpzoo_tpu/ops/tri_pallas.py:320"),
        # the backwards of kernels 3, 5 and 2 (JAX's _rbf_gram_bwd, _bwd, _tri_bwd)
        "rbf_gram_bwd": ("gpzoo_tpu_torch/ops/csrc/gram.cu",
                         "gpzoo_tpu/ops/gram_pallas.py:132"),
        "block_conditional_bwd": ("gpzoo_tpu_torch/ops/csrc/vnngp.cu",
                                  "gpzoo_tpu/ops/vnngp_pallas.py:195"),
        "tri_split": ("gpzoo_tpu_torch/ops/csrc/tri.cu", "gpzoo_tpu/ops/tri_pallas.py:176"),
        # kernel 8: the KL trace that JAX leaves to XLA (no Pallas kernel)
        **{name: ("gpzoo_tpu_torch/ops/csrc/tri.cu", "gpzoo_tpu/ops/tri_blocked.py:75")
           for name in KL_ALL},
    }
    # kernel 2's c store (tri_t_matmul) runs on no path (kernel 1 keeping c
    # stores the same c), nor does the dc epilogue (tri_dc): their counts
    # are 0; no path differentiates c, so kernel 2's backward (tri_split,
    # then kernels 6 and 7) runs only in [kernels] and tri_split and kernel
    # 7 on a dcᵀ (tri_da) count 0 too; so do kernel 8's forward without P
    # and its recomputing backward
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches.get(name, 0), **timings[name])
               for name, (src, rep) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
