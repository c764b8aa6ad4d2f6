#!/usr/bin/env python3
"""Device time and bits of mggp.cu's backward (``mggp_gram_bwd_f32``, the
subject), one tree against another, with the forward (``mggp_gram_f32``)
as control, at the paths' shapes: the MGGP step's Kzx and Kzz, the
Hybrid-MGGP step's Kzx and Kzz, and a data rank's Kzx, each with the
outputs its path asks for.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/mggp_bwd_ab.py [--package-root DIR] [--out FILE]
    python3 tools/mggp_bwd_ab.py --against DIR [--out FILE] [--pairs N]

Each tree's ``gpzoo_tpu_torch/ops/csrc/mggp.cu`` is compiled with this
checkout's nvcc flags (``ops/_build.NVCC_FLAGS``) into ``ops/build/``
(gitignored) and loaded with ctypes; the kernels are called through their C
entry points on the same seeded inputs (as ``chip_smoke.py`` makes them:
coordinates in [-2, 2]², the complete-graph embedding of 14 groups, σ, ℓ,
α from linspaces, a standard normal cotangent G), so the Python wrappers of
neither tree take part. ``--package-root`` names the tree measured as
"this" (the checkout by default), ``--against`` the other one, for example
a ``git archive`` of the parent commit unpacked in a gitignored directory.

For each shape: whether the planes dd² and dg² of the two trees are equal
bit for bit, the per-factor sums' (dσ, dℓ, dα) largest difference relative
to the other tree's largest, whether this tree's planes and sums are the
same bits on a rerun, and PAIRS pairs of device times, each REPS calls
captured in one CUDA graph and its replay timed by CUDA events, the order
within a pair alternating (the other tree first in even pairs), after
WARMUP_S seconds of the first shape. Then the bits alone at ragged shapes
that run the other instances (every output asked for, M odd and even, p =
3). It prints the medians, the pairs' differences (this - other), in how
many pairs this tree was faster and the bound (G read once and the planes
written once over 3.35 TB/s); the last line is one JSON object with all
of it, and ``--out`` writes it to FILE too. Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPS = 20
PAIRS = 10
WARMUP_S = 10.0
SEED = 19
GROUPS = 14
HBM_BYTES_PER_S = 3.35e12
D, G_, S_ = (True, False, False), (False, True, True), (True, True, True)
# (L, N, M, Kzz, the outputs asked for (dd2, dg2, the sums), p): the paths'
SHAPES = {"MGGP Kzx": (20, 3010, 7000, False, G_, 2),
          "MGGP Kzz": (20, 3010, 3010, True, G_, 2),
          "Hybrid-MGGP Kzx": (10, 3010, 6000, False, D, 2),
          "Hybrid-MGGP Kzz": (10, 3010, 3010, True, D, 2),
          "data rank Kzx": (20, 3010, 3500, False, G_, 2)}
# bits only: the other instances (every output, p = 3, M % 4 = 1, 2, 0)
RAGGED = {"L=37 300x270 p=3, all": (37, 300, 270, False, S_, 3),
          "L=4 160x529, all": (4, 160, 529, False, S_, 2),
          "L=3 45x7000, all": (3, 45, 7000, False, S_, 2),
          "L=5 33x33 Kzz, dd2 and sums": (5, 33, 33, True, (True, False, True), 2)}
SIDES = ("other", "this")


def _build_module():
    spec = importlib.util.spec_from_file_location(
        "_mggp_ab_build", os.path.join(ROOT, "gpzoo_tpu_torch", "ops", "_build.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(trees):
    """{label: ctypes library} of each tree's mggp.cu, compiled in parallel
    with this checkout's flags; prints ptxas's registers of the backward."""
    b = _build_module()
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, procs = {}, {}
    for label, root in trees.items():
        src = os.path.join(root, "gpzoo_tpu_torch", "ops", "csrc", "mggp.cu")
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:12]
        out = b.BUILD_DIR / f"libmggp_ab-{digest}.so"
        if not out.exists() and out not in procs:  # one build for two equal sources
            procs[out] = subprocess.Popen([b._nvcc(), *b.NVCC_FLAGS, "-o", str(out), src],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
        jobs[label] = (procs.get(out), out, src)
    libs = {}
    for label, (proc, out, src) in jobs.items():
        if proc is not None and proc.returncode is None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            entry = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1]
                elif entry and "mggp_gram_bwd_kernel" in entry and (
                        "registers" in line or "spill" in line):
                    inst = entry.split("mggp_gram_bwd_kernel", 1)[1].split("EEEv", 1)[0]
                    print(f"  ptxas {label} mggp_gram_bwd_kernel{inst}: "
                          f"{line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(out))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, args, res in (
                ("mggp_gram_f32", [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr], i32),
                ("mggp_gram_bwd_f32", [ptr] * 12 + [i32] * 5 + [ctypes.c_float, ptr], i32),
                ("mggp_gram_bwd_blocks", [i32] * 5, ctypes.c_longlong)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        libs[label] = lib
        print(f"  {label}: {src} -> {out.name}", flush=True)
    return libs


class Case:
    """One shape's operands and, for each tree, its outputs and scratch."""

    def __init__(self, torch, dev, L, N, M, kzz, wants, p, seed):
        sys.path.insert(0, ROOT)
        from gpzoo_tpu_torch.kernels.mggp import _default_embedding

        self.torch, self.dev = torch, dev
        self.L, self.N, self.M, self.wants, self.half_p = L, N, M, wants, 0.5 * p
        g = torch.Generator(device=dev).manual_seed(seed)
        emb = _default_embedding(GROUPS, torch.float32, dev)
        self.x = torch.rand((N, 2), generator=g, device=dev) * 4 - 2
        self.z = self.x if kzz else torch.rand((M, 2), generator=g, device=dev) * 4 - 2
        self.ex = emb[torch.randint(GROUPS, (N,), generator=g, device=dev)].contiguous()
        self.ez = self.ex if kzz else emb[torch.randint(GROUPS, (M,), generator=g,
                                                         device=dev)].contiguous()
        self.E = self.ex.shape[1]
        self.sigma = torch.linspace(0.5, 1.5, L, device=dev)
        self.ell = torch.linspace(0.8, 2.0, L, device=dev)
        self.alpha = torch.square(torch.linspace(0.2, 2.5, L, device=dev))
        self.G = torch.randn((L, N, M), generator=g, device=dev)
        self.gram = torch.empty((L, N, M), device=dev)

    def outputs(self, lib):
        """{dd2, dg2, hyper: a buffer or None, partials: the scratch}."""
        t, (want_d, want_g, want_h) = self.torch, self.wants
        blocks = lib.mggp_gram_bwd_blocks(self.N, self.M, 2, self.E, self.L)
        return {"dd2": t.empty((self.N, self.M), device=self.dev) if want_d else None,
                "dg2": t.empty((self.N, self.M), device=self.dev) if want_g else None,
                "hyper": t.empty((3, self.L), device=self.dev) if want_h else None,
                "partials": t.empty((3, self.L, blocks), device=self.dev) if want_h else None}

    def bwd(self, lib, out):
        t = self.torch
        ptrs = [None if out[k] is None else out[k].data_ptr()
                for k in ("dd2", "dg2", "hyper", "partials")]
        return lambda: lib.mggp_gram_bwd_f32(
            self.G.data_ptr(), self.x.data_ptr(), self.z.data_ptr(), self.ex.data_ptr(),
            self.ez.data_ptr(), self.sigma.data_ptr(), self.ell.data_ptr(),
            self.alpha.data_ptr(), *ptrs, self.N, self.M, 2, self.E, self.L, self.half_p,
            t.cuda.current_stream().cuda_stream)

    def fwd(self, lib):
        t = self.torch
        return lambda: lib.mggp_gram_f32(
            self.x.data_ptr(), self.z.data_ptr(), self.ex.data_ptr(), self.ez.data_ptr(),
            self.sigma.data_ptr(), self.ell.data_ptr(), self.alpha.data_ptr(),
            self.gram.data_ptr(), self.N, self.M, 2, self.E, self.L, self.half_p,
            t.cuda.current_stream().cuda_stream)

    def bound_ms(self):
        planes = int(self.wants[0]) + int(self.wants[1])
        return 1e3 * 4 * (self.L * self.N * self.M + planes * self.N * self.M) / HBM_BYTES_PER_S

    def fwd_bound_ms(self):
        return 1e3 * 4 * self.L * self.N * self.M / HBM_BYTES_PER_S


def run_once(torch, fn):
    status = fn()
    torch.cuda.synchronize()
    if status != 0:
        raise RuntimeError(f"launch failed with error {status}")


def graph(torch, fn):
    """A CUDA graph of REPS calls of ``fn`` (each must return 0)."""
    run_once(torch, fn)
    gr = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gr):
        for _ in range(REPS):
            if fn() != 0:
                raise RuntimeError("launch failed during capture")
    gr.replay()
    torch.cuda.synchronize()
    return gr


def replay_ms(torch, gr):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    gr.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def compare(torch, case, libs):
    """Bits of the planes against the other tree's, the sums' relative
    difference, and whether a rerun of this tree gives the same bits."""
    outs = {side: case.outputs(libs[side]) for side in SIDES}
    for side in SIDES:
        run_once(torch, case.bwd(libs[side], outs[side]))
    again = case.outputs(libs["this"])
    run_once(torch, case.bwd(libs["this"], again))
    rec = {}
    for k in ("dd2", "dg2"):
        if outs["this"][k] is not None:
            rec[f"{k}_bits_equal"] = bool(torch.equal(outs["this"][k], outs["other"][k]))
    if outs["this"]["hyper"] is not None:
        this, other = outs["this"]["hyper"], outs["other"]["hyper"]
        rec["sums_rel_diff"] = [
            float((this[q] - other[q]).abs().max() / other[q].abs().max().clamp_min(1e-30))
            for q in range(3)]
        rec["sums_bits_equal"] = bool(torch.equal(this, other))
    rec["rerun_bits_equal"] = all(
        bool(torch.equal(outs["this"][k], again[k])) for k in ("dd2", "dg2", "hyper")
        if again[k] is not None)
    return rec, outs


def pairs(torch, fns, n_pairs):
    graphs = {side: graph(torch, fns[side]) for side in SIDES}
    times = {side: [] for side in SIDES}
    for i in range(n_pairs):
        for side in (SIDES if i % 2 == 0 else SIDES[::-1]):
            times[side].append(replay_ms(torch, graphs[side]))
    diffs = [t - o for o, t in zip(times["other"], times["this"])]
    med = {side: statistics.median(v) for side, v in times.items()}
    return {"device_ms": times, "median_ms": med, "this_minus_other_ms": diffs,
            "this_faster_pairs": sum(d < 0 for d in diffs)}


def _line(what, rec, bound):
    n_pairs = len(rec["this_minus_other_ms"])
    med = rec["median_ms"]
    return (f"{what}: device ms other {med['other']:.4f}, this {med['this']:.4f} "
            f"({med['this'] / med['other'] - 1:+.2%}); this - other "
            f"{' '.join(f'{d:+.4f}' for d in rec['this_minus_other_ms'])}; this faster in "
            f"{rec['this_faster_pairs']} of {n_pairs}; bound {bound:.4f} ms, "
            f"{bound / med['this']:.1%} of it (other {bound / med['other']:.1%})")


def measure(this_root, other_root, n_pairs=PAIRS):
    import torch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"this: {this_root}; other: {other_root}", flush=True)
    libs = build({"this": this_root, "other": other_root})
    case = Case(torch, dev, *next(iter(SHAPES.values())), SEED)
    warm = {side: case.bwd(libs[side], case.outputs(libs[side])) for side in SIDES}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        for fn in warm.values():
            run_once(torch, fn)
    del case, warm
    torch.cuda.empty_cache()
    record = {"device": smi, "this": this_root, "other": other_root, "pairs": n_pairs,
              "reps": REPS, "shapes": {}, "ragged": {}}
    for index, (label, spec) in enumerate(SHAPES.items()):
        L, N, M, kzz, wants, p = spec
        case = Case(torch, dev, *spec, SEED + index)
        rec, outs = compare(torch, case, libs)
        rec.update(shape=[L, N, M], kzz=kzz, wants=list(wants), p=p)
        rec["bwd"] = pairs(torch, {side: case.bwd(libs[side], outs[side]) for side in SIDES},
                           n_pairs)
        rec["fwd"] = pairs(torch, {side: case.fwd(libs[side]) for side in SIDES}, n_pairs)
        rec["bound_ms"], rec["fwd_bound_ms"] = case.bound_ms(), case.fwd_bound_ms()
        record["shapes"][label] = rec
        bits = {k: v for k, v in rec.items() if "bits" in k or "rel_diff" in k}
        print(f"[{label} L={L} N={N} M={M} dd2/dg2/sums {wants}] {bits}", flush=True)
        print("  " + _line("subject mggp_gram_bwd_f32", rec["bwd"], rec["bound_ms"]),
              flush=True)
        print("  " + _line("control mggp_gram_f32", rec["fwd"], rec["fwd_bound_ms"]),
              flush=True)
        del case, outs
        torch.cuda.empty_cache()
    for index, (label, spec) in enumerate(RAGGED.items()):
        case = Case(torch, dev, *spec, SEED + 100 + index)
        rec, _ = compare(torch, case, libs)
        record["ragged"][label] = rec
        print(f"[ragged {label}] {rec}", flush=True)
        del case
    return record


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package-root", default=ROOT)
    parser.add_argument("--against", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--pairs", type=int, default=PAIRS)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mggp_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    this = os.path.abspath(opts.package_root)
    record = measure(this, os.path.abspath(opts.against or this), opts.pairs)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(record, fh)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
