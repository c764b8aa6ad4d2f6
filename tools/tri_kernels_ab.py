#!/usr/bin/env python3
"""Device time and bits of tri.cu's main-loop kernels, one tree against
another: kernel 6 reading c (``tri_dlu_from_c_f32``, the subject,
``SUBJECTS``: dLu of a shared a from kernel 1's kept c; in a tree without
it, the route it replaces, the scale pass ``tri_split_f32`` given g and
then ``tri_dlu_f32``, in the same graph), with the dc epilogue
(``tri_dc_f32``), kernels 6 (``tri_dlu_f32``) and 7 (``tri_da_f32``),
kernels 1 (``tri_sq_colsum_c_f32`` with c null; ``tri_sq_colsum_f32`` in a
tree from before kernel 1 kept c) and 2 (``tri_t_matmul_f32``) as
controls, at the north-star shape and its [parallel] ranks' (a shared a),
two shapes off the tiles with a shared a, and the MGGP, Hybrid-MGGP, a
factor rank's, a data rank's and the Hybrid-NSF shapes (a per-factor a).

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/tri_kernels_ab.py [--package-root DIR] [--out FILE]
    python3 tools/tri_kernels_ab.py --against DIR [--out FILE]
        [--pairs N] [--kernels da,dlu,...] [--shapes north-star,MGGP,...]

Each tree's ``gpzoo_tpu_torch/ops/csrc/tri.cu`` is compiled with this
checkout's nvcc flags (``ops/_build.NVCC_FLAGS``) into ``ops/build/``
(gitignored) and loaded with ctypes; the kernels are called through their C
entry points on the same seeded inputs, so the Python wrappers of neither
tree take part. ``--package-root`` names the tree measured as "this" (the
checkout by default), ``--against`` the other one, for example a ``git
archive`` of the parent commit unpacked in a gitignored directory. Without
``--against`` the tree is held against itself.

After WARMUP_S seconds of the first shape's kernels (the card's clocks and
temperature settle), for each shape and kernel: whether the two trees'
outputs, each handed NaN-filled memory (so an element left unwritten
cannot pass), are equal bit for bit (the dc epilogue's dc and dcT, hi and
lo; kernels 6 and 7 read the other tree's dc and kernel 6 reading c the
other tree's kernel 2 c, so both get the same operands),
and PAIRS pairs of device times, each REPS calls captured in one CUDA graph
and its replay timed by CUDA events, the order within a pair alternating
(the other tree first in even pairs). It prints the medians, the pairs'
differences (this - other), in how many pairs this tree was faster, and
each kernel's 3xTF32 bound; the last line is one JSON object with all of
it, and ``--out`` writes it to FILE too; each line says whether its kernel
is a subject or a control. About 8 minutes on an H100; ``--pairs`` and
``--kernels`` (a subset of ``KERNELS``; the dc epilogue runs wherever
kernel 6 or 7 does, its dc is their operand, but is timed only if named)
and ``--shapes`` (a subset of ``SHAPES``' labels) cut it short.
Without CUDA it exits 1.
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

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPS = 20
PAIRS = 10
WARMUP_S = 10.0
SEED = 18
TILE, B_ALIGN = 128, 32  # tri.cu TM, B_ALIGN
TF32_TC_FLOP_PER_S, HBM_BYTES_PER_S = 495e12, 3.35e12
# (L, M, B, a per factor): the paths' shapes of kernel 1's backward, and
# two with a shared a off the tiles (B % 4 = 1 and 2: kernel 6 reading c
# copies c's rows with the row stride Bp)
SHAPES = {"north-star": (20, 3000, 7000, False),
          "north-star data rank": (20, 3000, 3500, False),
          "north-star factor rank": (10, 3000, 7000, False),
          "ragged shared 1": (2, 257, 129, False),
          "ragged shared 2": (3, 130, 142, False),
          "MGGP": (20, 3010, 7000, True),
          "Hybrid-MGGP": (10, 3010, 6000, True),
          "factor rank": (10, 3010, 7000, True),
          "data rank": (20, 3010, 3500, True),
          "Hybrid-NSF": (4, 529, 720, True)}
# the dc epilogue first: its dc is kernels 6 and 7's operand
KERNELS = ("dc", "dlu", "dluc", "colsum", "c", "da")
SUBJECTS = ("dluc",)  # the kernels the tree under test changed; the rest are controls
NAMES = {"dc": "tri_dc_f32 (dc epilogue)", "dlu": "tri_dlu_f32 (kernel 6)",
         "dluc": "kernel 6 reading c (tri_dlu_from_c_f32; without it, the scale pass and "
                 "tri_dlu_f32)",
         "colsum": "tri_sq_colsum_c_f32, c null (kernel 1)", "c": "tri_t_matmul_f32 (kernel 2)",
         "da": "tri_da_f32 (kernel 7)"}


def _pad(x, to):
    return -(-x // to) * to


def _build_module():
    spec = importlib.util.spec_from_file_location(
        "_tri_ab_build", os.path.join(ROOT, "gpzoo_tpu_torch", "ops", "_build.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(trees):
    """{label: ctypes library} of each tree's tri.cu, compiled in parallel
    with this checkout's flags; prints ptxas's registers of the main loop."""
    b = _build_module()
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, procs = {}, {}
    for label, root in trees.items():
        src = os.path.join(root, "gpzoo_tpu_torch", "ops", "csrc", "tri.cu")
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:12]
        out = b.BUILD_DIR / f"libtri_ab-{digest}.so"
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
                elif entry and "tri_mma_kernel" in entry and ("registers" in line
                                                              or "spill" in line):
                    inst = entry.split("tri_mma_kernelILi", 1)[1].split("E", 1)[0]
                    print(f"  ptxas {label} tri_mma_kernel<{inst}>: "
                          f"{line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(out))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # kernel 1 as "colsum": the entry that takes c where the tree has it
        keeps_c = hasattr(lib, "tri_sq_colsum_c_f32")
        lib.colsum = lib.tri_sq_colsum_c_f32 if keeps_c else lib.tri_sq_colsum_f32
        lib.colsum_args = (None,) if keeps_c else ()
        lib.reads_c = hasattr(lib, "tri_dlu_from_c_f32")
        for name, args in (("colsum", [ptr] * (4 if keeps_c else 3) + [i32] * 3
                            + [i64, ptr, ptr]),
                           ("tri_t_matmul_f32", [ptr] * 3 + [i32] * 3 + [i64, ptr, ptr]),
                           ("tri_dc_f32", [ptr] * 5 + [i32] * 3 + [i64, ptr, ptr]),
                           ("tri_dlu_f32", [ptr] * 3 + [i32] * 3 + [i64, ptr, ptr]),
                           ("tri_da_f32", [ptr] * 3 + [i32] * 3 + [ptr, ptr]),
                           ("tri_split_f32", [ptr] * 4 + [i32] * 3 + [ptr]),
                           ("tri_dlu_from_c_f32", [ptr] * 4 + [i32] * 3 + [ptr, ptr])):
            if name == "tri_dlu_from_c_f32" and not lib.reads_c:
                continue
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        libs[label] = lib
        print(f"  {label}: {src} -> {out.name}", flush=True)
    return libs


def bound_ms(L, M, B, per_factor, kernel):
    """The least time of the kernel's function on an H100: the larger of
    its bytes (each input read once, each output written once, float32) over
    3.35 TB/s and its L·B·M(M+1) FLOP, three TF32 products each, over 495
    TFLOP/s (as chip_smoke.py bounds them)."""
    lu, a, dc = 4 * L * M * (M + 1) // 2, 4 * (L if per_factor else 1) * M * B, 4 * L * M * B
    moved = {"colsum": lu + a + 4 * L * B, "c": lu + a + dc, "dc": lu + a + 4 * L * B + dc,
             "dlu": a + dc + 4 * L * M * M, "dluc": a + dc + 4 * L * B + 4 * L * M * M,
             "da": lu + dc + a}[kernel]
    return 1e3 * max(moved / HBM_BYTES_PER_S, 3 * L * B * M * (M + 1) / TF32_TC_FLOP_PER_S)


class Case:
    """One shape's inputs and, for each tree, its outputs and scratch."""

    def __init__(self, torch, dev, L, M, B, per_factor, seed):
        self.torch, self.L, self.M, self.B, self.per_factor = torch, L, M, B, per_factor
        self.mp, self.bp = _pad(M, TILE), _pad(B, B_ALIGN)
        self.la = L if per_factor else 1
        g = torch.Generator(device=dev).manual_seed(seed)
        self.lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
        self.a = torch.randn((self.la, M, B) if per_factor else (M, B), generator=g, device=dev)
        self.g = torch.randn((L, B), generator=g, device=dev)
        self.a_stride = M * B if per_factor else 0
        self.dev = dev
        self.dc_in = None  # the other tree's dc, kernels 6 and 7's operand on both sides
        self.c = None  # the other tree's kernel 2 c: kernel 1's kept c, both sides' operand

    def outputs(self, kernel):
        t, L, M, B = self.torch, self.L, self.M, self.B
        shape = {"colsum": [(L, B)], "c": [(L, M, B)], "dlu": [(L, M, M)], "da": [(L, M, B)],
                 "dluc": [(L, M, M)],
                 "dc": [(2, L, M, self.bp)] + ([(2, L, B, self.mp)] if self.per_factor else [])}
        return [t.full(s, float("nan"), device=self.dev) for s in shape[kernel]]

    def scratch(self, kernel):
        # as much as any tree's entry points take (kernels 1-2's staging;
        # kernel 6 reading c's split a and c copy, or the scale pass's rows
        # and kernel 6's copy of a)
        L, M, B, mp, bp, la = self.L, self.M, self.B, self.mp, self.bp, self.la
        n = {"dlu": 2 * la * M * bp, "da": 2 * L * mp * mp,
             "dluc": (2 * L + 2 + L) * M * bp}.get(kernel, 2 * L * mp * mp + 2 * la * B * mp)
        return self.torch.empty(n, device=self.dev)

    def call(self, lib, kernel, out, scratch):
        """A function that launches ``kernel`` of ``lib`` once on the current
        stream (returns its status)."""
        t = self.torch
        L, M, B = self.L, self.M, self.B
        lu, a, g, s = self.lu.data_ptr(), self.a.data_ptr(), self.g.data_ptr(), scratch.data_ptr()
        o = out[0].data_ptr()

        def stream():
            return t.cuda.current_stream().cuda_stream
        if kernel == "colsum":
            return lambda: lib.colsum(lu, a, o, *lib.colsum_args, L, M, B, self.a_stride, s,
                                      stream())
        if kernel == "c":
            return lambda: lib.tri_t_matmul_f32(lu, a, o, L, M, B, self.a_stride, s, stream())
        if kernel == "dc":
            ot = out[1].data_ptr() if len(out) > 1 else None
            return lambda: lib.tri_dc_f32(lu, a, g, o, ot, L, M, B, self.a_stride, s, stream())
        if kernel == "dluc":
            c = self.c.data_ptr()
            if lib.reads_c:
                return lambda: lib.tri_dlu_from_c_f32(a, c, g, o, L, M, B, s, stream())
            # the route it replaces: the scale pass into dc's rows (L, M, Bp),
            # hi and lo, at the start of the scratch, then kernel 6 on them
            rows, rest = s, s + 4 * 2 * L * M * self.bp

            def old():
                status = lib.tri_split_f32(c, g, rows, None, L, M, B, stream())
                return status or lib.tri_dlu_f32(a, rows, o, L, M, B, 0, rest, stream())
            return old
        rows, rows_t = self.dc_in
        if kernel == "dlu":
            return lambda: lib.tri_dlu_f32(a, rows.data_ptr(), o, L, M, B, self.a_stride, s,
                                           stream())
        return lambda: lib.tri_da_f32(lu, rows_t.data_ptr(), o, L, M, B, s, stream())


def graph(torch, fn):
    """A CUDA graph of REPS calls of ``fn`` (each must return 0)."""
    status = fn()
    torch.cuda.synchronize()
    if status != 0:
        raise RuntimeError(f"launch failed with error {status}")
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


def warm_up(torch, libs, dev):
    """Both trees' dc epilogues at the first shape for WARMUP_S seconds."""
    import time

    case = Case(torch, dev, *next(iter(SHAPES.values())), SEED)
    out, scratch = case.outputs("dc"), case.scratch("dc")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        for lib in libs.values():
            if case.call(lib, "dc", out, scratch)() != 0:
                raise RuntimeError("warm-up launch failed")
        torch.cuda.synchronize()


def measure(this_root, other_root, pairs=PAIRS, kernels=KERNELS, shapes=tuple(SHAPES)):
    import torch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"this: {this_root}; other: {other_root}", flush=True)
    libs = build({"this": this_root, "other": other_root})
    warm_up(torch, libs, dev)
    torch.cuda.empty_cache()
    record = {"device": smi, "this": this_root, "other": other_root, "pairs": pairs,
              "reps": REPS, "shapes": {}}
    for index, (label, (L, M, B, per_factor)) in enumerate(SHAPES.items()):
        if label not in shapes:
            continue
        case = Case(torch, dev, L, M, B, per_factor, SEED + index)
        rec = record["shapes"][label] = {"shape": [L, M, B], "per_factor": per_factor}
        for kernel in KERNELS:
            if kernel == "da" and not per_factor:
                continue  # a shared a's da runs on no path
            if kernel == "dluc" and per_factor:
                continue  # kernel 6 reading c takes a shared a
            if kernel not in kernels and not (kernel == "dc" and {"dlu", "da"} & set(kernels)):
                continue
            if kernel == "dluc" and case.c is None:  # kernel 1's kept c: kernel 2's bits
                case.c = torch.empty((L, M, B), device=dev)
                if libs["other"].tri_t_matmul_f32(case.lu.data_ptr(), case.a.data_ptr(),
                                                  case.c.data_ptr(), L, M, B, 0,
                                                  case.scratch("c").data_ptr(),
                                                  torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError(f"{label}: kernel 2 failed")
            out = {side: case.outputs(kernel) for side in ("other", "this")}
            scratch = case.scratch(kernel)
            for side in ("other", "this"):
                if case.call(libs[side], kernel, out[side], scratch)() != 0:
                    raise RuntimeError(f"{label} {kernel} {side}: launch failed")
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(out["other"], out["this"]))
            if kernel == "dc":  # (rows, rows_t or None)
                case.dc_in = (out["other"][0], out["other"][1] if per_factor else None)
            if kernel not in kernels:  # the dc epilogue, run for its dc alone
                rec[kernel] = {"bits_equal": same}
                print(f"[{label} L={L} M={M} B={B}] {NAMES[kernel]}: bits equal {same} "
                      "(not timed)", flush=True)
                del out, scratch
                continue
            graphs = {side: graph(torch, case.call(libs[side], kernel, out[side], scratch))
                      for side in ("other", "this")}
            times = {"other": [], "this": []}
            for i in range(pairs):
                for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
                    times[side].append(replay_ms(torch, graphs[side]))
            del graphs
            diffs = [t - o for o, t in zip(times["other"], times["this"])]
            bound = bound_ms(L, M, B, per_factor, kernel)
            med = {side: statistics.median(v) for side, v in times.items()}
            rec[kernel] = {"bits_equal": same, "device_ms": times, "median_ms": med,
                           "this_minus_other_ms": diffs, "this_faster_pairs":
                           sum(d < 0 for d in diffs), "bound_ms": bound}
            role = rec[kernel]["role"] = "subject" if kernel in SUBJECTS else "control"
            print(f"[{label} L={L} M={M} B={B}] {role} {NAMES[kernel]}: bits equal {same}; "
                  f"device ms other {med['other']:.4f}, this {med['this']:.4f} "
                  f"({med['this'] / med['other'] - 1:+.2%}); this - other "
                  f"{' '.join(f'{d:+.4f}' for d in diffs)}; this faster in "
                  f"{rec[kernel]['this_faster_pairs']} of {pairs}; bound {bound:.4f} ms, "
                  f"{bound / med['this']:.1%} of it (other {bound / med['other']:.1%})",
                  flush=True)
            del out, scratch
            torch.cuda.empty_cache()
        del case
        torch.cuda.empty_cache()
    return record


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package-root", default=ROOT)
    parser.add_argument("--against", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--pairs", type=int, default=PAIRS)
    parser.add_argument("--kernels", default=",".join(KERNELS))
    parser.add_argument("--shapes", default=",".join(SHAPES))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tri_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    this = os.path.abspath(opts.package_root)
    record = measure(this, os.path.abspath(opts.against or this), opts.pairs,
                     tuple(opts.kernels.split(",")), tuple(opts.shapes.split(",")))
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(record, fh)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
