#!/usr/bin/env python3
"""A tri.cu kernel in the training steps (the subject): each leg's step
time, peak memory, kernel launches a step and profile by operator and input
shape, and the subject's entries alone at the paths' shapes. Subjects
(``--subject``): ``trace``, the KL trace tr(K⁻¹·Lu·Luᵀ) (kernel 8; the
default), ``keepc``, kernel 1 keeping c = Luᵀã for its backward,
``dluc``, kernel 6 reading c (the backward of a shared, frozen ã in one
launch, no dc written), ``dac``, kernel 7 reading c (the per-factor legs'
da in one launch, no dcᵀ written), and ``scale``, the per-factor legs' dLu:
the scale pass (rows only, a pass of 16-byte rows) and kernel 6.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/kl_trace_steps.py [--subject S] [--package-root DIR] [--out FILE]
                                    [--steps-out FILE]
    python3 tools/kl_trace_steps.py [--subject S] --against DIR [--out FILE] [--pairs N]

The first form measures one tree in this process: ``--package-root``
imports ``gpzoo_tpu_torch`` from DIR instead of this checkout (for example
a ``git archive`` of another commit unpacked in a gitignored directory);
chip_smoke.py always comes from this checkout and sets up each leg on its
data and seeds: [main] (the north-star precomputed step), [mggp] and
[hybrid_mggp] (bench.py's settings, ``chip_smoke.BENCH``) and, for the
trace, [vnngp] (b) (the VNNGP all-trainable step) (SUBJECTS). For each
leg: the calls of the trace a step (a spy on the name ``tri_kl_trace`` in
``train/fast.py`` and ``train/fast_vnngp.py``, with their operands'
shapes), ms/step on the host clock over STEPS steps after WARMUP, the peak
device memory over those steps, the launches a step of each of kernels 1
and 8's entries that the tree has (ENTRIES: kernel 1 with and without c,
the scale pass, the dc epilogue, kernels 6, 6 reading c and 7; kernel 8's
forward with and without P, its scale pass and its recompute), and a profiled window of
PROFILED[leg] steps: wall, device busy,
idle share, the kernels with the most device time and the operators with
the most self device time by input shapes (``record_shapes=True``). Then
[main] (for dac, [mggp]; for scale, [mggp] and [hybrid_mggp]) once more
from its seed: the loss and every leaf's gradient of BIT_STEPS steps, saved
with ``torch.save`` to ``--steps-out`` where given (one file a leg, the
leg's name appended, where a subject compares several).

Then, for the trace, the trace alone at the paths' shapes (SHAPES): forward, and forward
and backward under autograd (Lu trained; K⁻¹ too for a per-factor K⁻¹),
each a CUDA-event median of REPS calls, for the tree's entry point
(``tri_cuda.tri_kl_trace`` where the tree has it, else the panel form
``tri_blocked.tri_kl_trace``), the panel form and the one-call dense
einsum (``"ij,ljk,lik->l"``, or ``"lij,…"`` for a per-factor K⁻¹), and the
host's time in one forward and backward (a host-clock median of HOST_REPS
calls, each begun on an idle card and timed to its return, not to the
device's end); and a profile of the entry point's forward and backward at
the north-star shape, kernel by kernel. For keepc, kernel 1 and dc = 2c·g
alone at COLSUM_SHAPES, each entry's device time (``chip_smoke.device_ms``:
REPS calls in one CUDA graph): kernel 1 without c and, where the tree has
it, keeping c; dc by the dc epilogue and, where the tree has it, by the
scale pass from the kept c (with dcᵀ where the path runs kernel 7); and
``TriSqColsum`` forward and backward under autograd as the path
differentiates it (a CUDA-event median of REPS calls). For dluc, the
backward of a shared, frozen ã alone at DLUC_SHAPES, device ms of each
entry: kernel 6 reading c where the tree has it, the scale pass, kernel 6
on its dc, and the two in turn (the route kernel 6 reading c replaces);
the Function's forward and backward as the path runs it; and one [main]
step's memory (``torch.cuda.memory._snapshot``): the allocated bytes at its
start, its peak, and the largest blocks live at the peak that the step
allocated, each with the port's frame that allocated it. For dac, the
per-factor backward alone at DAC_SHAPES, device ms of each entry: the scale
pass with dcᵀ and rows only, kernel 6 on its rows, kernel 7 on the dcᵀ,
kernel 7 reading c where the tree has it, and the backward as the tree's
path runs it (the scale pass, kernel 6, and kernel 7 reading c, or the
scale pass with dcᵀ and kernel 7), in one graph; the Function's forward and
backward with Lu and a trained; and the snapshot of one [mggp] step. For
scale, the same at DAC_SHAPES: the scale pass (rows only), kernel 6 on its
rows, the two in turn, kernel 7 reading c, and the backward as the path
runs it (the scale pass, kernel 6 and kernel 7 reading c) in one graph; the
Function's forward and backward; and the snapshot of one [mggp] step.

The second form is the A/B: PAIRS pairs of runs, each a process of the
first form, DIR's package against this checkout's, the order alternating
(DIR first in even pairs); it prints every run, then each leg's ms/step,
peak and launches a step of both sides and the pairs' differences (this −
DIR), whether the [main] losses and leaf gradients of BIT_STEPS steps are
the same bits in both trees (and in every run of a tree), each leaf's
largest difference where not, and the subject's entries alone. The last line is one JSON object with the figures; ``--out``
writes it to FILE too. Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WARMUP = 3
STEPS = 10
PROFILED = {"main": 3, "mggp": 1, "hybrid_mggp": 1, "vnngp (b)": 1}
# {subject: its legs}
SUBJECTS = {"trace": tuple(PROFILED), "keepc": ("main", "mggp", "hybrid_mggp"),
            "dluc": ("main", "mggp", "hybrid_mggp"), "dac": ("main", "mggp", "hybrid_mggp"),
            "scale": ("main", "mggp", "hybrid_mggp")}
# {subject: the leg whose step is snapshotted, and whose first BIT_STEPS
# steps are compared bit for bit}
SNAPSHOT_LEG = {"dluc": "main", "dac": "mggp", "scale": "mggp"}
BITS_LEG = {"dac": "mggp", "scale": ("mggp", "hybrid_mggp")}
# kernels 1 and 8's entries by counter name: the tri_cuda wrapper that counts them
ENTRIES = {"tri_sq_colsum": "tri_sq_colsum_fused", "tri_sq_colsum_c": "tri_sq_colsum_fwd_c",
           "tri_dc_from_c": "tri_dc_from_c", "tri_dc": "tri_dc", "tri_dlu": "tri_dlu",
           "tri_dlu_from_c": "tri_dlu_from_c", "tri_da": "tri_da",
           "tri_da_from_c": "tri_da_from_c", "tri_kl_trace": "tri_kl_trace_fwd",
           "tri_kl_trace_p": "tri_kl_trace_fwd_p", "tri_kl_trace_scale": "tri_kl_trace_scale",
           "tri_kl_trace_bwd": "tri_kl_trace_bwd"}
REPS = 5
HOST_REPS = 21
BIT_STEPS = 3
PAIRS = 1
TOP = 25
# the SHAPES whose entries are also timed on the device
DEVICE_SHAPES = ("north-star", "mggp", "vnngp (b)")
# (label, L, M, K⁻¹ per factor): the north-star and VNNGP KLs (shared K⁻¹;
# the VNNGP step's is L = 1, the sweep's width L = 10) and the MGGP and
# Hybrid-MGGP shapes with a per-factor K⁻¹
SHAPES = (("north-star", 20, 3000, False), ("mggp", 20, 3010, True),
          ("hybrid_mggp", 10, 3010, True), ("vnngp", 10, 1000, False),
          ("vnngp (b)", 1, 1000, False))
# kernel 1 alone: (label, L, M, B, a per factor): the north-star shape (a
# shared ã, a constant: no dcᵀ), the MGGP, Hybrid-MGGP and Hybrid-NSF
# steps' (a per factor trains: dcᵀ for kernel 7)
COLSUM_SHAPES = (("north-star", 20, 3000, 7000, False), ("mggp", 20, 3010, 7000, True),
                 ("hybrid_mggp", 10, 3010, 6000, True), ("hybrid", 4, 529, 720, True))
# kernel 6 reading c alone: (label, L, M, B), a shared ã: the north-star
# shape and its [parallel] data and factor ranks'
DLUC_SHAPES = (("north-star", 20, 3000, 7000), ("data rank", 20, 3000, 3500),
               ("factor rank", 10, 3000, 7000))
# the per-factor backward alone: (label, L, M, B), a per-factor a: the MGGP
# and Hybrid-MGGP steps' and [parallel]'s MGGP factor and data ranks'
DAC_SHAPES = (("mggp", 20, 3010, 7000), ("hybrid_mggp", 10, 3010, 6000),
              ("factor rank", 10, 3010, 7000), ("data rank", 20, 3010, 3500))
# the live blocks of [main]'s peak that the snapshot lists
SNAPSHOT_TOP = 12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def trace_calls():
    """Counts the calls of ``tri_kl_trace`` made by the training losses, by
    the shapes of (K⁻¹, Lu), into the yielded Counter."""
    from gpzoo_tpu_torch.train import fast, fast_vnngp

    calls = collections.Counter()

    def spy(module):
        inner = module.tri_kl_trace

        def counted(k_inv, lu):
            calls[tuple(k_inv.shape), tuple(lu.shape)] += 1
            return inner(k_inv, lu)
        return mock.patch.object(module, "tri_kl_trace", counted)

    with spy(fast), spy(fast_vnngp):
        yield calls


def profile(fn, steps):
    """Wall, device busy and idle share of ``steps`` calls of ``fn``, its
    kernels by device time and its operators by self device time and input
    shapes, each per call."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, kernels = [], collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            spans.append((e.time_range.start, e.time_range.end))
            kernels[e.name] += e.time_range.end - e.time_range.start
    busy, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    log(f"  profile over {steps} calls: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}")
    log("  kernels by device time (ms a call, launches a call, name):")
    counts = collections.Counter(e.name for e in prof.events()
                                 if e.device_type == torch.autograd.DeviceType.CUDA)
    for name, us in kernels.most_common(TOP):
        log(f"    {us / steps / 1e3:9.4f}  {counts[name] / steps:6.1f}  {name[:120]}")
    log("  operators by self device time and input shapes (ms a call, calls a call):")
    ops = []
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            continue
        us = next((getattr(evt, a) for a in ("self_device_time_total", "self_cuda_time_total")
                   if hasattr(evt, a)), 0.0)
        if us > 0:
            ops.append((us, evt.count, evt.key, str(evt.input_shapes)))
    for us, count, key, shapes in sorted(ops, key=lambda o: -o[0])[:TOP]:
        log(f"    {us / steps / 1e3:9.4f}  {count / steps:6.1f}  {key}  {shapes[:150]}")
    return {"wall_ms": wall_us / 1e3 / steps, "busy_ms": busy / 1e3 / steps,
            "idle_share": 1 - busy / wall_us,
            "kernels_ms": {k: v / steps / 1e3 for k, v in kernels.most_common(TOP)}}


def _legs(cs, dev):
    """{leg: a function returning (step, model, args)} set up as
    chip_smoke.py sets up each leg."""
    import torch
    from torch import nn

    from gpzoo_tpu_torch import (MGGPNSFConfig, SlideseqHybridMGGPConfig, SlideseqNSFConfig,
                                 make_batched_train_step, nsf_negative_elbo_batched,
                                 nsf_negative_elbo_precomputed, precompute_nsf_projection)

    def main():
        m = cs.MAIN
        cfg = SlideseqNSFConfig(N=m["N"], D=m["D"], L=m["L"], M=m["M"], batch_size=m["B"])
        x, y = cs.nsf_data(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cfg.build(gen, x)
        proj = precompute_nsf_projection(model, x)
        step = make_batched_train_step(nsf_negative_elbo_precomputed, cfg.optimizer(model),
                                       cfg.N - cs.HOLDOUT, cfg.batch_size, cfg.L, gen,
                                       E=cfg.E, loss_kwargs={"y_transposed": True})
        return step, model, (proj, y)

    def mggp():
        m = cs.MGGP
        cfg = MGGPNSFConfig(D=m["D"], N=m["N"], L=m["L"], M_per_group=m["M_per_group"],
                            n_groups=m["G"], batch_size=m["B"])
        x, y, g = cs.mggp_data(dev, cfg.N, cfg.D, cfg.n_groups)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cfg.build(gen, x, g)
        model.gp.mu = nn.Parameter(0.1 * torch.randn((cfg.L, cfg.M), generator=gen,
                                                     device=dev))
        model.gp.Lu_raw = nn.Parameter(torch.zeros((cfg.L, cfg.M, cfg.M), device=dev))
        step = make_batched_train_step(
            nsf_negative_elbo_batched, cfg.optimizer(model), cfg.N - cs.HOLDOUT,
            cfg.batch_size, cfg.L, gen, E=cfg.E,
            loss_kwargs=dict(microbatch=cfg.batch_size, factored=True, y_transposed=True,
                             groups=g, **cs.BENCH))
        return step, model, (x, y)

    def hybrid_mggp():
        h = cs.HYBRID_MGGP
        cfg = SlideseqHybridMGGPConfig(D=h["D"], N=h["N"], L=h["L"], T=h["T"],
                                       M_per_group=h["M_per_group"], n_groups=h["G"],
                                       batch_size=h["B"])
        x, y, g = cs.mggp_data(dev, cfg.N, cfg.D, cfg.n_groups)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cfg.build(gen, x, g)
        step = make_batched_train_step(
            nsf_negative_elbo_batched, cfg.optimizer(model), cfg.N - cs.HOLDOUT,
            cfg.batch_size, cfg.L, gen, E=cfg.E,
            loss_kwargs=dict(E=cfg.E, microbatch=cfg.batch_size, factored=True,
                             y_transposed=True, groups=g, **cs.BENCH))
        return step, model, (x, y)

    def vnngp():
        _, model, step, args, _ = cs.vnngp_leg(dev, cs.vnngp_full_shape())
        return step, model, args

    return {"main": main, "mggp": mggp, "hybrid_mggp": hybrid_mggp, "vnngp (b)": vnngp}


def host_ms(fn):
    """Median host-clock time of ``fn`` over HOST_REPS calls, each begun on
    an idle card and timed to its return (the host's part of the call)."""
    import torch

    fn()
    times = []
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main_steps(setup, path, leg="main"):
    """The loss and every leaf's gradient (on the host) of BIT_STEPS steps of
    ``leg`` ([main] unless said) from the leg's seed, saved to ``path`` where
    given."""
    import torch

    step, model, args = setup()
    record = []
    for _ in range(BIT_STEPS):
        loss = step(model, *args)
        record.append({"loss": loss.cpu(), **{name: p.grad.cpu() for name, p in
                                              model.named_parameters() if p.grad is not None}})
    log(f"[{leg}] {BIT_STEPS} steps from the seed: losses "
        f"{[float(r['loss']) for r in record]}, leaves with a gradient "
        f"{sorted(k for k in record[0] if k != 'loss')}")
    if path:
        torch.save(record, path)


def entry_device_ms(cs, tri_cuda, k_inv, lu, gout):
    """{entry: device ms of one call} of each of kernel 8's entries the tree
    has (``chip_smoke.device_ms``: REPS calls in one CUDA graph), None where
    the capture failed: the forward and the recomputing backward, and the
    forward keeping P and the scale pass from it."""
    calls = {"forward": (tri_cuda.tri_kl_trace_fwd,
                         lambda: tri_cuda.tri_kl_trace_fwd(k_inv, lu)),
             "recompute": (tri_cuda.tri_kl_trace_bwd,
                           lambda: tri_cuda.tri_kl_trace_bwd(k_inv, lu, gout))}
    if hasattr(tri_cuda, "tri_kl_trace_fwd_p"):
        p = tri_cuda.tri_kl_trace_fwd_p(k_inv, lu)[1]
        calls["forward keeping P"] = (tri_cuda.tri_kl_trace_fwd_p,
                                      lambda: tri_cuda.tri_kl_trace_fwd_p(k_inv, lu))
        calls["scale"] = (tri_cuda.tri_kl_trace_scale,
                          lambda: tri_cuda.tri_kl_trace_scale(p, gout))
    return {name: cs.device_ms(fn, REPS, wrapper)[0] for name, (wrapper, fn) in calls.items()}


def _trace_alone(cs, dev):
    """The trace alone at SHAPES: the tree's entry point, the panel form and
    the one-call einsum, forward and forward+backward; a profile of the entry
    point at the north-star shape."""
    import torch

    from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

    entry = getattr(tri_cuda, "tri_kl_trace", None)
    forms = {"entry": entry or tri_blocked.tri_kl_trace, "panels": tri_blocked.tri_kl_trace}
    log(f"[trace alone] entry point: "
        f"{'tri_cuda.tri_kl_trace' if entry else 'tri_blocked.tri_kl_trace (panels)'}")
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for label, l_dim, m, per_factor in SHAPES:
        lu = (torch.tril(torch.randn((l_dim, m, m), generator=g, device=dev)) / m ** 0.5)
        w = torch.randn((l_dim, m, m) if per_factor else (m, m), generator=g,
                        device=dev) / m ** 0.5
        k_inv = w @ w.mT + torch.eye(m, device=dev)
        del w
        spec = "lij,ljk,lik->l" if per_factor else "ij,ljk,lik->l"
        forms["einsum"] = lambda k, u, s=spec: torch.einsum(s, k, u, u)
        gout = torch.randn((l_dim,), generator=g, device=dev)
        rec = {}
        for name, fn in forms.items():
            fwd = cs.median_ms(lambda: fn(k_inv, lu), REPS)
            lu_g = lu.clone().requires_grad_()
            k_g = k_inv.clone().requires_grad_(per_factor)

            def both():
                fn(k_g, lu_g).backward(gout)
                lu_g.grad = k_g.grad = None
            rec[name] = {"fwd_ms": fwd, "fwd_bwd_ms": cs.median_ms(both, REPS),
                         "host_fwd_bwd_ms": host_ms(both)}
            del lu_g, k_g
            torch.cuda.empty_cache()
            log(f"  {label} (L={l_dim}, M={m}, K⁻¹ {'per factor' if per_factor else 'shared'})"
                f" {name}: forward {rec[name]['fwd_ms']:.3f} ms, forward+backward "
                f"{rec[name]['fwd_bwd_ms']:.3f} ms, the host's part "
                f"{rec[name]['host_fwd_bwd_ms']:.3f} ms")
        if label in DEVICE_SHAPES and entry:
            rec["device_ms"] = entry_device_ms(cs, tri_cuda, k_inv, lu, gout)
            log(f"  {label}: device ms a call of each entry: "
                + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                            for k, v in rec["device_ms"].items()))
        out[label] = rec
        if label == "north-star":
            lu_g = lu.clone().requires_grad_()

            def both():
                forms["entry"](k_inv, lu_g).backward(gout)
                lu_g.grad = None
            log(f"  {label}: the entry point's forward and backward, profiled")
            profile(both, 3)
            del lu_g
        del lu, k_inv
        torch.cuda.empty_cache()
    return out


def _colsum_alone(cs, dev):
    """Kernel 1 and dc = 2c·g alone at COLSUM_SHAPES, device ms a call of
    each entry the tree has, and the Function's forward and backward."""
    import torch

    from gpzoo_tpu_torch.ops import tri_cuda

    g = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for label, l_dim, m, b, per_factor in COLSUM_SHAPES:
        lu = torch.tril(torch.randn((l_dim, m, m), generator=g, device=dev)) / m ** 0.5
        a = torch.randn((l_dim, m, b) if per_factor else (m, b), generator=g, device=dev)
        gout = torch.randn((l_dim, b), generator=g, device=dev)
        calls = {"kernel 1": (tri_cuda.tri_sq_colsum_fused,
                              lambda: tri_cuda.tri_sq_colsum_fused(lu, a)),
                 "dc epilogue": (tri_cuda.tri_dc,
                                 lambda: tri_cuda.tri_dc(lu, a, gout, per_factor))}
        if hasattr(tri_cuda, "tri_sq_colsum_fwd_c"):
            c = tri_cuda.tri_sq_colsum_fwd_c(lu, a)[1]
            calls["kernel 1 keeping c"] = (tri_cuda.tri_sq_colsum_fwd_c,
                                           lambda: tri_cuda.tri_sq_colsum_fwd_c(lu, a))
            calls["scale pass"] = (tri_cuda.tri_dc_from_c,
                                   lambda: tri_cuda.tri_dc_from_c(c, gout, per_factor))
        rec = {}
        for name, (wrapper, fn) in calls.items():
            rec[name] = cs.device_ms(fn, REPS, wrapper)[0]
            torch.cuda.empty_cache()
        lu_g = lu.clone().requires_grad_()
        a_g = a.clone().requires_grad_(per_factor)

        def both():
            tri_cuda.tri_sq_colsum(lu_g, a_g).backward(gout)
            lu_g.grad = a_g.grad = None
        rec["Function forward+backward"] = cs.median_ms(both, REPS)
        del lu_g, a_g
        out[label] = rec
        log(f"  {label} (L={l_dim}, M={m}, B={b}, a {'per factor' if per_factor else 'shared'})"
            ": " + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} not measured"
                             for k, v in rec.items()))
        del lu, a, gout
        calls.clear()
        torch.cuda.empty_cache()
    return out


def _dluc_alone(cs, dev):
    """The backward of a shared, frozen ã alone at DLUC_SHAPES: device ms a
    call of each entry the tree has, and the Function's forward and
    backward."""
    import torch

    from gpzoo_tpu_torch.ops import tri_cuda

    g = torch.Generator(device=dev).manual_seed(29)
    out = {}
    for label, l_dim, m, b in DLUC_SHAPES:
        lu = torch.tril(torch.randn((l_dim, m, m), generator=g, device=dev)) / m ** 0.5
        a = torch.randn((m, b), generator=g, device=dev)
        gout = torch.randn((l_dim, b), generator=g, device=dev)
        c = tri_cuda.tri_sq_colsum_fwd_c(lu, a)[1]
        dc = tri_cuda.tri_dc_from_c(c, gout)
        calls = {"scale pass": (tri_cuda.tri_dc_from_c, lambda: tri_cuda.tri_dc_from_c(c, gout)),
                 "kernel 6": (tri_cuda.tri_dlu, lambda: tri_cuda.tri_dlu(a, dc)),
                 "scale pass and kernel 6": (
                     tri_cuda.tri_dlu, lambda: tri_cuda.tri_dlu(a, tri_cuda.tri_dc_from_c(c, gout)))}
        if hasattr(tri_cuda, "tri_dlu_from_c"):
            calls["kernel 6 reading c"] = (tri_cuda.tri_dlu_from_c,
                                           lambda: tri_cuda.tri_dlu_from_c(a, c, gout))
        rec = {}
        for name, (wrapper, fn) in calls.items():
            rec[name] = cs.device_ms(fn, REPS, wrapper)[0]
            torch.cuda.empty_cache()
        lu_g = lu.clone().requires_grad_()

        def both():
            tri_cuda.tri_sq_colsum(lu_g, a).backward(gout)
            lu_g.grad = None
        rec["Function forward+backward"] = cs.median_ms(both, REPS)
        del lu_g
        out[label] = rec
        log(f"  {label} (L={l_dim}, M={m}, B={b}, a shared): "
            + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} not measured"
                        for k, v in rec.items()))
        del lu, a, gout, c, dc
        calls.clear()
        torch.cuda.empty_cache()
    return out


def _dac_alone(cs, dev):
    """The per-factor backward alone at DAC_SHAPES: device ms a call of each
    entry the tree has and of the backward as its path runs it, and the
    Function's forward and backward."""
    import torch

    from gpzoo_tpu_torch.ops import tri_cuda

    g = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for label, l_dim, m, b in DAC_SHAPES:
        lu = torch.tril(torch.randn((l_dim, m, m), generator=g, device=dev)) / m ** 0.5
        a = torch.randn((l_dim, m, b), generator=g, device=dev)
        gout = torch.randn((l_dim, b), generator=g, device=dev)
        c = tri_cuda.tri_sq_colsum_fwd_c(lu, a)[1]
        dc = tri_cuda.tri_dc(lu, a, gout, True)  # the scale pass's bits, with dcT
        new = hasattr(tri_cuda, "tri_da_from_c")

        def backward():
            if new:
                tri_cuda.tri_dlu(a, tri_cuda.tri_dc_from_c(c, gout))
                tri_cuda.tri_da_from_c(lu, c, gout)
            else:
                op = tri_cuda.tri_dc_from_c(c, gout, True)
                tri_cuda.tri_dlu(a, op)
                tri_cuda.tri_da(lu, op)
        calls = {"scale pass rows only": (tri_cuda.tri_dc_from_c,
                                          lambda: tri_cuda.tri_dc_from_c(c, gout)),
                 "kernel 6": (tri_cuda.tri_dlu, lambda: tri_cuda.tri_dlu(a, dc)),
                 "kernel 7": (tri_cuda.tri_da, lambda: tri_cuda.tri_da(lu, dc))}
        if new:
            calls["kernel 7 reading c"] = (tri_cuda.tri_da_from_c,
                                           lambda: tri_cuda.tri_da_from_c(lu, c, gout))
        calls["backward as the path runs it"] = (tri_cuda.tri_dlu, backward)
        rec = {}
        for name, (wrapper, fn) in calls.items():
            rec[name] = cs.device_ms(fn, REPS, wrapper)[0]
            torch.cuda.empty_cache()
        del dc
        lu_g, a_g = lu.clone().requires_grad_(), a.clone().requires_grad_()

        def both():
            tri_cuda.tri_sq_colsum(lu_g, a_g).backward(gout)
            lu_g.grad = a_g.grad = None
        rec["Function forward+backward"] = cs.median_ms(both, REPS)
        del lu_g, a_g
        out[label] = rec
        log(f"  {label} (L={l_dim}, M={m}, B={b}, a per factor): "
            + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} not measured"
                        for k, v in rec.items()))
        del lu, a, gout, c
        calls.clear()
        torch.cuda.empty_cache()
    return out


def _scale_alone(cs, dev):
    """The per-factor backward alone at DAC_SHAPES, dLu's route taken
    apart: device ms a call of the scale pass (rows only), of kernel 6, of
    the two in turn, of kernel 7 reading c and of the backward as the path
    runs it, and the Function's forward and backward."""
    import torch

    from gpzoo_tpu_torch.ops import tri_cuda

    g = torch.Generator(device=dev).manual_seed(37)
    out = {}
    for label, l_dim, m, b in DAC_SHAPES:
        lu = torch.tril(torch.randn((l_dim, m, m), generator=g, device=dev)) / m ** 0.5
        a = torch.randn((l_dim, m, b), generator=g, device=dev)
        gout = torch.randn((l_dim, b), generator=g, device=dev)
        c = tri_cuda.tri_sq_colsum_fwd_c(lu, a)[1]
        dc = tri_cuda.tri_dc_from_c(c, gout)

        def backward():
            tri_cuda.tri_dlu(a, tri_cuda.tri_dc_from_c(c, gout))
            tri_cuda.tri_da_from_c(lu, c, gout)
        calls = {"scale pass rows only": (tri_cuda.tri_dc_from_c,
                                          lambda: tri_cuda.tri_dc_from_c(c, gout)),
                 "kernel 6": (tri_cuda.tri_dlu, lambda: tri_cuda.tri_dlu(a, dc)),
                 "scale pass and kernel 6": (
                     tri_cuda.tri_dlu, lambda: tri_cuda.tri_dlu(a, tri_cuda.tri_dc_from_c(c, gout)))}
        calls["kernel 7 reading c"] = (tri_cuda.tri_da_from_c,
                                       lambda: tri_cuda.tri_da_from_c(lu, c, gout))
        calls["backward as the path runs it"] = (tri_cuda.tri_da_from_c, backward)
        rec = {}
        for name, (wrapper, fn) in calls.items():
            rec[name] = cs.device_ms(fn, REPS, wrapper)[0]
            torch.cuda.empty_cache()
        del dc
        lu_g, a_g = lu.clone().requires_grad_(), a.clone().requires_grad_()

        def both():
            tri_cuda.tri_sq_colsum(lu_g, a_g).backward(gout)
            lu_g.grad = a_g.grad = None
        rec["Function forward+backward"] = cs.median_ms(both, REPS)
        del lu_g, a_g
        out[label] = rec
        log(f"  {label} (L={l_dim}, M={m}, B={b}, a per factor): "
            + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} not measured"
                        for k, v in rec.items()))
        del lu, a, gout, c
        calls.clear()
        torch.cuda.empty_cache()
    return out


def _bits_legs(subject):
    """The legs whose first BIT_STEPS steps are compared bit for bit."""
    legs = BITS_LEG.get(subject, "main")
    return (legs,) if isinstance(legs, str) else legs


def _frame(frames):
    """The first frame of an allocation's stack in the port's sources (or,
    without one, the first frame), as "file:line function"."""
    for f in frames or ():
        if "gpzoo_tpu_torch" in f.get("filename", ""):
            return f"{f['filename'].split('gpzoo_tpu_torch', 1)[1]}:{f['line']} {f['name']}"
    f = (frames or [{}])[0]
    return f"{f.get('filename', '?')}:{f.get('line', '?')} {f.get('name', '?')}"


def step_snapshot(step, model, args):
    """One step under ``torch.cuda.memory._record_memory_history``: the
    bytes allocated when it starts, its peak, and the SNAPSHOT_TOP largest
    blocks live at the peak among those the step allocated (the trace's
    alloc and free events replayed), each with its size and frame."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    try:
        torch.cuda.memory._record_memory_history(max_entries=200_000, stacks="python")
        step(model, *args)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    except Exception as exc:  # noqa: BLE001 - a report, not a check
        log(f"  memory snapshot failed ({type(exc).__name__}: {exc})")
        return None
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, now, peak, at_peak = {}, 0, 0, {}
    for event in (snap.get("device_traces") or [[]])[0]:
        action, addr = event.get("action"), event.get("addr")
        if action == "alloc":
            live[addr] = (event["size"], _frame(event.get("frames")))
            now += event["size"]
            if now > peak:
                peak, at_peak = now, dict(live)
        elif action == "free_completed" and addr in live:
            now -= live.pop(addr)[0]
    blocks = sorted(at_peak.values(), key=lambda v: -v[0])[:SNAPSHOT_TOP]
    log(f"  one step's memory: {start / 2**30:.3f} GiB allocated at its start, peak "
        f"{(start + peak) / 2**30:.3f} GiB; the largest blocks the step allocated, live at "
        "the peak (GiB, frame):")
    for size, frame in blocks:
        log(f"    {size / 2**30:8.4f}  {frame}")
    return {"start_gib": start / 2**30, "peak_gib": (start + peak) / 2**30,
            "blocks": [[size / 2**30, frame] for size, frame in blocks]}


def measure(package_root, subject, steps_out=None):
    """Each of the subject's legs' figures, [main]'s first steps (to
    ``steps_out``) and the subject's entries alone, ``gpzoo_tpu_torch``
    imported from ``package_root``."""
    sys.path.insert(0, package_root)
    import torch

    import gpzoo_tpu_torch
    from gpzoo_tpu_torch.ops import _build, tri_cuda

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"package {os.path.dirname(gpzoo_tpu_torch.__file__)}; {smi}; torch "
        f"{torch.__version__}")
    log(f"build: {_build.build_all()}")
    record = {"package_root": package_root, "device": smi, "subject": subject}
    counters = {name: getattr(tri_cuda, attr) for name, attr in ENTRIES.items()
                if hasattr(tri_cuda, attr)}
    legs = _legs(cs, dev)
    for name in SUBJECTS[subject]:
        log(f"[{name}]")
        step, model, args = legs[name]()
        with trace_calls() as calls:
            cs._timed_steps(step, model, args, WARMUP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs._zero(counters)
        losses, seconds = cs._timed_steps(step, model, args, STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: v / STEPS for k, v in cs._read(counters).items() if v}
        ms = seconds / STEPS * 1e3
        log(f"  {ms:.3f} ms/step over {STEPS} steps, peak {peak:.3f} GiB over them; losses "
            f"finite {bool(torch.isfinite(losses).all())}; trace calls over {WARMUP} steps "
            f"by (K⁻¹, Lu) shape: {dict(calls)}; launches a step {launches}")
        window = profile(lambda: step(model, *args), PROFILED[name])
        record[name] = {"ms_per_step": ms, "peak_gib": peak, "launches_per_step": launches,
                        "trace_calls_per_step": sum(calls.values()) / WARMUP, **window}
        if SNAPSHOT_LEG.get(subject) == name:
            record[name]["snapshot"] = step_snapshot(step, model, args)
        del step, model, args
        cs.nsf_data.cache_clear()
        cs.mggp_data.cache_clear()
        torch.cuda.empty_cache()
    bits_legs = _bits_legs(subject)
    for bits_leg in bits_legs:
        main_steps(legs[bits_leg], steps_out and (
            steps_out if len(bits_legs) == 1 else f"{steps_out}.{bits_leg}"), bits_leg)
        cs.nsf_data.cache_clear()
        cs.mggp_data.cache_clear()
        torch.cuda.empty_cache()
    if subject == "trace":
        record["trace_alone"] = _trace_alone(cs, dev)
    else:
        log("[alone] device ms a call (REPS calls in a CUDA graph); the Function's forward "
            "and backward, CUDA-event median")
        if subject == "keepc":
            record["colsum_alone"] = _colsum_alone(cs, dev)
        elif subject == "dac":
            record["dac_alone"] = _dac_alone(cs, dev)
        elif subject == "scale":
            record["scale_alone"] = _scale_alone(cs, dev)
        else:
            record["dluc_alone"] = _dluc_alone(cs, dev)
    return record


def _spread(values):
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def compare_steps(files):
    """{"same_bits": bool, "leaves": {leaf: largest |difference|}} of the
    [main] step records in ``files`` (side, path) against the first one."""
    import torch

    (_, first), *rest = files
    ref = torch.load(first)
    worst = {}
    for _, path in rest:
        got = torch.load(path)
        for want_step, got_step in zip(ref, got):
            for leaf, want in want_step.items():
                d = float((got_step[leaf].double() - want.double()).abs().max())
                worst[leaf] = max(worst.get(leaf, 0.0), d)
    return {"same_bits": all(
        all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()
        for _, path in rest for a, b in zip(ref, torch.load(path))),
        "leaves": worst}


def against(other, subject, pairs, scratch):
    """``pairs`` pairs of runs of ``other``'s package and this checkout's,
    each in its own process, the order alternating; the [main] step records
    go to ``scratch``."""
    runs, steps = [], []
    for i in range(pairs):
        order = (("other", other), ("this", ROOT))
        for side, root in order if i % 2 == 0 else order[::-1]:
            log(f"=== pair {i + 1}, {side}: {root}")
            path = os.path.join(scratch, f"main_steps_pair{i + 1}_{side}.pt")
            steps.append((side, path))
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--subject", subject, "--package-root", root,
                                   "--steps-out", path],
                                  capture_output=True, text=True, timeout=1500)
            print(proc.stdout + proc.stderr, end="", flush=True)
            if proc.returncode != 0:
                raise RuntimeError(f"pair {i + 1}, {side}: exit {proc.returncode}")
            runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                             side=side, pair=i + 1))
    summary = {}
    for leg in SUBJECTS[subject]:
        by_side = {side: [r[leg] for r in runs if r["side"] == side]
                   for side in ("other", "this")}
        summary[leg] = {side: {key: _spread([r[key] for r in rs])
                               for key in ("ms_per_step", "busy_ms", "peak_gib")}
                        for side, rs in by_side.items()}
        summary[leg]["this_minus_other_ms"] = _spread(
            [t["ms_per_step"] - o["ms_per_step"]
             for o, t in zip(by_side["other"], by_side["this"])])
        for side in ("other", "this"):
            s = summary[leg][side]
            log(f"[{leg}] {side}: ms/step median {s['ms_per_step']['median']:.3f} "
                f"({s['ms_per_step']['min']:.3f}-{s['ms_per_step']['max']:.3f}), busy "
                f"{s['busy_ms']['median']:.3f}, peak {s['peak_gib']['max']:.3f} GiB; "
                f"launches a step {by_side[side][0].get('launches_per_step')}")
            snap = by_side[side][0].get("snapshot")
            if snap:
                log(f"[{leg}] {side}: one step's memory, peak {snap['peak_gib']:.3f} GiB "
                    f"({snap['start_gib']:.3f} at its start); largest blocks live at the "
                    f"peak: " + ", ".join(f"{size:.3f} {frame}"
                                          for size, frame in snap["blocks"][:6]))
        d = summary[leg]["this_minus_other_ms"]
        log(f"[{leg}] this - other within a pair: median {d['median']:+.3f} ms/step "
            f"({d['min']:+.3f} to {d['max']:+.3f}); each pair "
            + ", ".join(f"{t['ms_per_step'] - o['ms_per_step']:+.3f}"
                        for o, t in zip(by_side["other"], by_side["this"])))
    bits = {}
    bits_legs = _bits_legs(subject)
    for leg in bits_legs:
        files = [(side, path if len(bits_legs) == 1 else f"{path}.{leg}")
                 for side, path in steps]
        tag = "" if len(bits_legs) == 1 else f"{leg}: "
        bits.update({f"{tag}this vs other": compare_steps(
            sorted(files, key=lambda f: f[0] != "other")),
            **{f"{tag}{side} runs": compare_steps([f for f in files if f[0] == side])
               for side in ("other", "this")}})
    for what, b in bits.items():
        log(f"[{'/'.join(bits_legs)}] {BIT_STEPS} steps' losses and leaf gradients, "
            f"{what}: "
            f"{'the same bits' if b['same_bits'] else 'NOT the same bits'}; largest "
            f"|difference| by leaf {b['leaves']}")
    alone = {"keepc": ("colsum_alone", COLSUM_SHAPES),
             "dluc": ("dluc_alone", DLUC_SHAPES),
             "dac": ("dac_alone", DAC_SHAPES),
             "scale": ("scale_alone", DAC_SHAPES)}.get(subject, (None, ()))
    for label, *_ in alone[1]:
        for side in ("other", "this"):
            rec = [r[alone[0]][label] for r in runs if r["side"] == side]
            for entry in rec[0]:
                ms = [r[entry] for r in rec if r[entry] is not None]
                log(f"[alone, {label}] {side} {entry}: "
                    + (f"{statistics.median(ms):.4f} ms ({min(ms):.4f}-{max(ms):.4f}, "
                       f"{len(ms)} runs)" if ms else "not measured"))
    for label in DEVICE_SHAPES if subject == "trace" else ():
        for side in ("other", "this"):
            rec = [r["trace_alone"][label] for r in runs if r["side"] == side]
            for form in ("entry", "panels", "einsum"):
                log(f"[trace alone, {label}] {side} {form}: forward+backward "
                    f"{statistics.median(r[form]['fwd_bwd_ms'] for r in rec):.3f} ms, the "
                    f"host's part {statistics.median(r[form]['host_fwd_bwd_ms'] for r in rec):.3f}"
                    f" ms (medians of {len(rec)} runs)")
            for entry in rec[0].get("device_ms", {}):
                ms = [r["device_ms"][entry] for r in rec if r["device_ms"][entry] is not None]
                log(f"[trace alone, {label}] {side} {entry}: device "
                    + (f"{statistics.median(ms):.4f} ms ({min(ms):.4f}-{max(ms):.4f}, "
                       f"{len(ms)} runs)" if ms else "not measured"))
    return {"other": other, "this": ROOT, "subject": subject, "pairs": pairs, "runs": runs,
            "summary": summary, "main_steps_bits": bits}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--subject", default="trace", choices=sorted(SUBJECTS))
    parser.add_argument("--package-root", default=ROOT)
    parser.add_argument("--against", default=None)
    parser.add_argument("--pairs", type=int, default=PAIRS)
    parser.add_argument("--out", default=None)
    parser.add_argument("--steps-out", default=None)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kl_trace_steps: no CUDA device", file=sys.stderr)
        return 1
    if opts.against:
        with tempfile.TemporaryDirectory() as scratch:
            record = against(os.path.abspath(opts.against), opts.subject, opts.pairs, scratch)
    else:
        record = measure(os.path.abspath(opts.package_root), opts.subject, opts.steps_out)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(record, fh)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
