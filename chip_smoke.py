#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gpzoo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel in gpzoo_tpu_torch/ops/csrc with nvcc;
  2. kernels — each kernel against its plain PyTorch version in float32, at
               the main path's shapes and at a ragged small shape, with the
               median time of each beside the plain version's;
  3. main path — the north-star NSF training step at full width (N=45,000,
               D=4,000, L=20, M=3,000, batch 7,000): config build, the
               precomputed projection, warm-up and timed Adam steps, the
               held-out deviance, peak memory and each kernel's launch count,
               then one step with the kernels against the same step with the
               plain versions, and a small input against the float64 CPU path.
The last three lines are the card's name and power limit, one JSON line with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Without CUDA
the script exits 1 before doing anything else. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
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

MAIN = dict(N=45_000, D=4_000, L=20, M=3_000, B=7_000)
HOLDOUT = 2_000
WARMUP_STEPS, TIMED_STEPS = 3, 10


def log(msg):
    print(msg, flush=True)


def norm_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


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


def _tri_case(checks, dev, g, L, M, B, label, timings=None):
    import torch
    from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / math.sqrt(M)
    a = torch.randn((M, B), generator=g, device=dev)
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
    tri_cuda.tri_sq_colsum(lu_k, a).backward(gout)
    lu_p = lu.clone().requires_grad_()
    tri_blocked.tri_sq_colsum(lu_p, a).backward(gout)
    checks.le(f"TriSqColsum dLu {label}",
              norm_err(lu_k.grad, torch.tril(lu_p.grad)), TOL_TRI)
    del lu_k, lu_p
    torch.cuda.synchronize()
    if timings is not None:
        timings["tri_sq_colsum"] = dict(
            max_abs_err=err1,
            ms=median_ms(lambda: tri_cuda.tri_sq_colsum_fused(lu, a), 5),
            plain_ms=median_ms(lambda: tri_blocked.tri_sq_colsum(lu, a), 5))
        timings["tri_t_matmul"] = dict(
            max_abs_err=err2,
            ms=median_ms(lambda: tri_cuda.tri_t_matmul(lu, a), 5),
            plain_ms=median_ms(lambda: tri_blocked.tri_t_matmul(lu, a), 5))
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
        timings["rbf_gram"] = dict(
            max_abs_err=float((out - ref).abs().max()),
            ms=median_ms(lambda: gram_cuda.rbf_gram_fwd(x, z, sigma, ell), 20),
            plain_ms=median_ms(lambda: gram_cuda.rbf_gram_plain(x, z, sigma, ell), 20))


def phase_kernels(checks, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    timings = {}
    log("[kernels] float32, kernel against plain on the same inputs")
    _tri_case(checks, dev, g, 3, 130, 140, "L=3 M=130 B=140")
    _tri_case(checks, dev, g, MAIN["L"], MAIN["M"], MAIN["B"],
              "L={L} M={M} B={B}".format(**MAIN), timings)
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
    for name, t in timings.items():
        log(f"  time {name}: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return timings


def _launch_counters():
    from gpzoo_tpu_torch.ops import gram_cuda, tri_cuda

    return {"tri_sq_colsum": tri_cuda.tri_sq_colsum_fused,
            "tri_t_matmul": tri_cuda.tri_t_matmul,
            "rbf_gram": gram_cuda.rbf_gram_fwd}


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

    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in counters.items()}

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
    timings = phase_kernels(checks, dev)
    launches = phase_main(checks, dev)
    phase_small_reference(checks, dev)
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
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **timings[name])
               for name, (src, rep) in sources.items()]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
