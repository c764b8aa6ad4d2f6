#!/usr/bin/env python3
"""Device time and bits of kernel 3's backward (gram.cu ``rbf_gram_bwd_f32``)
and kernel 5's backward (vnngp.cu ``block_conditional_bwd_f32``), the
subjects, one tree against another, with the forwards of kernels 3 and 5
(``rbf_gram_f32``, ``block_conditional_f32``) and kernel 1 (this
checkout's ``tri_cuda.tri_sq_colsum_fused``) as controls.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/gram_vnngp_bwd_ab.py [--package-root DIR] [--out FILE]
    python3 tools/gram_vnngp_bwd_ab.py --against DIR [--out FILE] [--pairs N]

Each tree's ``gpzoo_tpu_torch/ops/csrc/{gram,vnngp}.cu`` is compiled with
this checkout's nvcc flags (``ops/_build.NVCC_FLAGS``) into ``ops/build/``
(gitignored) and loaded with ctypes; the kernels are called through their C
entry points on the same seeded inputs (as ``chip_smoke.py`` makes them:
coordinates in [-2, 2]^D, z the first M of them, σ and ℓ from linspaces, k
the forward's Gram, a standard normal cotangent; SPD blocks kzz = aaᵀ + 3I,
s = bbᵀ, jitter 0.1), so the Python wrappers of neither tree take part.
``--package-root`` names the tree measured as "this" (the checkout by
default), ``--against`` the other one, for example a ``git archive`` of the
parent commit unpacked in a gitignored directory. A tree whose gram.cu
exports ``rbf_gram_bwd_counters`` is called with a zeroed counter buffer.

For each path shape: whether each output (dx, dz, dσ and dℓ; dkzz, ds, dkxz,
dmu) of the two trees is equal bit for bit, whether this tree's are the same
bits on a rerun and with kernel 3's cotangent given with its planes
transposed (read in place), the kernel nodes one call of this tree adds to a CUDA graph
(read back through libcuda's ``cuGraphGetNodes``), and PAIRS pairs of
device times, each REPS calls captured in one CUDA graph and its replay
timed by CUDA events, the order within a pair alternating (the other tree
first in even pairs), after WARMUP_S seconds of the first shape. Then the
bits alone at ragged shapes. It prints the medians, the pairs' differences
(this - other), in how many pairs this tree was faster, this tree's plan
(grid, blocks an SM) and the bound (g and k read once; a point's inputs read
and outputs written once; over 3.35 TB/s); the last line is one JSON
object with all of it, and ``--out`` writes it to FILE too. Without CUDA it
exits 1.
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
SEED = 20
JITTER = 0.1
HBM_BYTES_PER_S = 3.35e12
# kernel 3's backward at the paths' shapes (L, N, M, D)
GRAM_SHAPES = {"VNNGP sweep Kxz": (10, 5000, 1000, 2), "VNNGP sweep Kzz": (10, 1000, 1000, 2),
               "VNNGP step Kxz": (1, 5000, 1000, 2), "VNNGP step Kzz": (1, 1000, 1000, 2),
               **{f"NSF sweep Kzz M={m}": (4, m, m, 2) for m in (100, 250, 500, 1000)},
               **{f"NSF sweep Kzx M={m}": (4, m, 800, 2) for m in (100, 250, 500, 1000)},
               "Hybrid Kzz": (4, 529, 529, 2), "Hybrid Kzx": (4, 529, 720, 2),
               "regression Kzz": (1, 500, 500, 1), "regression Kzx": (1, 500, 10000, 1)}
# bits only: N and M odd and even (VEC 1, 2, 4), D = 1, 2 and 8, L = 1 and
# 10, a grid of one block (one item), L past the 32 factors summed at once
GRAM_RAGGED = {"L=1 1x1 D=2 (one item)": (1, 1, 1, 2), "L=3 16x256 D=2 (one item)": (3, 16, 256, 2),
               "L=2 33x1 D=3": (2, 33, 1, 3), "L=3 130x150 D=2": (3, 130, 150, 2),
               "L=1 37x1030 D=1": (1, 37, 1030, 1), "L=2 7x1025 D=3": (2, 7, 1025, 3),
               "L=3 129x1023 D=8": (3, 129, 1023, 8), "L=10 5001x998 D=2": (10, 5001, 998, 2),
               "L=37 300x270 D=2": (37, 300, 270, 2), "L=1 4097x45000 D=2": (1, 4097, 45000, 2)}
# kernel 5's backward at the paths' (n, K), then ragged: n = 1, 33, 5,001;
# K = 1, 5 and 16
VNNGP_SHAPES = {"VNNGP sweep": (50000, 8), "VNNGP step": (5000, 8)}
VNNGP_RAGGED = {"n=1 K=8": (1, 8), "n=33 K=8": (33, 8), "n=5001 K=8": (5001, 8),
                "n=130 K=1": (130, 1), "n=1000 K=5": (1000, 5), "n=1000 K=16": (1000, 16),
                "n=77 K=3": (77, 3), "n=500 K=12": (500, 12)}
SIDES = ("other", "this")


def _build_module():
    spec = importlib.util.spec_from_file_location(
        "_gram_vnngp_ab_build", os.path.join(ROOT, "gpzoo_tpu_torch", "ops", "_build.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(trees):
    """{(label, source): ctypes library} of each tree's gram.cu and
    vnngp.cu, compiled in parallel with this checkout's flags; prints
    ptxas's registers and spills of the backward kernels."""
    b = _build_module()
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, procs = {}, {}
    for label, root in trees.items():
        for source in ("gram", "vnngp"):
            src = os.path.join(root, "gpzoo_tpu_torch", "ops", "csrc", f"{source}.cu")
            with open(src, "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()[:12]
            out = b.BUILD_DIR / f"lib{source}_ab-{digest}.so"
            if not out.exists() and out not in procs:  # one build for two equal sources
                procs[out] = subprocess.Popen(
                    [b._nvcc(), *b.NVCC_FLAGS, "-o", str(out), src], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            jobs[label, source] = (procs.get(out), out, src)
    libs = {}
    for (label, source), (proc, out, src) in jobs.items():
        if proc is not None and proc.returncode is None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            entry = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1]
                elif entry and ("rbf_gram_bwd_kernelILi2ELi4E" in entry or
                                "block_conditional_bwd_kernelILi8E" in entry) and (
                        "registers" in line or "spill" in line):
                    print(f"  ptxas {label} {entry}: {line.split(':', 1)[-1].strip()}",
                          flush=True)
        libs[label, source] = ctypes.CDLL(str(out))
        print(f"  {label}: {src} -> {out.name}", flush=True)
    return libs


def _fn(lib, name, args, res=ctypes.c_int):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = args, res
    return fn


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class GramCase:
    """Kernel 3's backward at one shape: shared inputs, each tree's outputs."""

    def __init__(self, torch, dev, L, N, M, D, seed, forward):
        self.torch, self.dev, self.shape = torch, dev, (L, N, M, D)
        g = torch.Generator(device=dev).manual_seed(seed)
        xs = torch.rand((max(N, M), D), generator=g, device=dev) * 4 - 2
        self.x, self.z = xs[:N].contiguous(), xs[:M].contiguous()
        self.sigma = (torch.linspace(0.5, 2.0, L, device=dev) if L > 1
                      else torch.ones(1, device=dev))
        self.ell = (torch.linspace(0.3, 3.0, L, device=dev) if L > 1
                    else torch.ones(1, device=dev))
        self.k = torch.empty((L, N, M), device=dev)
        if self.forward_call(forward)() != 0:
            raise RuntimeError("rbf_gram_f32 failed")
        self.g = torch.randn((L, N, M), generator=g, device=dev)

    def forward_call(self, lib):
        fn = _fn(lib, "rbf_gram_f32", [P] * 5 + [I32] * 4 + [P])
        L, N, M, D = self.shape
        return lambda: fn(self.x.data_ptr(), self.z.data_ptr(), self.sigma.data_ptr(),
                          self.ell.data_ptr(), self.k.data_ptr(), N, M, D, L,
                          _stream(self.torch))

    def outputs(self, lib):
        t, (L, N, M, D) = self.torch, self.shape
        floats = _fn(lib, "rbf_gram_bwd_scratch", [I32] * 4, I64)(N, M, D, L)
        out = {"dx": t.empty((N, D), device=self.dev), "dz": t.empty((M, D), device=self.dev),
               "hyper": t.empty((2, L), device=self.dev),
               "scratch": t.empty((max(floats, 1),), device=self.dev)}
        if hasattr(lib, "rbf_gram_bwd_counters"):
            count = _fn(lib, "rbf_gram_bwd_counters", [I32] * 4, I64)(N, M, D, L)
            out["counters"] = t.zeros((max(count, 1),), dtype=t.int32, device=self.dev)
        return out

    def bwd(self, lib, out, g=None):
        """The call; ``g`` another cotangent (this tree only: one whose
        planes are stored transposed, passed with g_transposed = 1)."""
        L, N, M, D = self.shape
        ptrs = [out[k].data_ptr() for k in ("dx", "dz", "hyper", "scratch")]
        g = self.g if g is None else g
        if "counters" in out:
            fn = _fn(lib, "rbf_gram_bwd_f32", [P] * 11 + [I32] * 5 + [P])
            ptrs.append(out["counters"].data_ptr())
            ints = (N, M, D, L, int(not g.is_contiguous()))
        else:
            fn = _fn(lib, "rbf_gram_bwd_f32", [P] * 10 + [I32] * 4 + [P])
            ints = (N, M, D, L)
        return lambda: fn(g.data_ptr(), self.k.data_ptr(), self.x.data_ptr(),
                          self.z.data_ptr(), self.sigma.data_ptr(), self.ell.data_ptr(),
                          *ptrs, *ints, _stream(self.torch))

    def plan(self, lib):
        if not hasattr(lib, "rbf_gram_bwd_plan"):
            return None
        L, N, M, D = self.shape
        out = (I64 * 10)()
        if _fn(lib, "rbf_gram_bwd_plan", [I32] * 4 + [ctypes.POINTER(I64)])(N, M, D, L,
                                                                            out) != 0:
            return None
        return dict(zip(("vec", "strips", "chunks", "tiles", "items", "grid", "per_sm", "sms",
                         "ring_bytes", "helpers"), list(out)))

    def keys(self):
        return ("dx", "dz", "hyper")

    def bound_ms(self):
        L, N, M, _ = self.shape
        return 1e3 * 8 * L * N * M / HBM_BYTES_PER_S

    def fwd_bound_ms(self):
        L, N, M, _ = self.shape
        return 1e3 * 4 * L * N * M / HBM_BYTES_PER_S


class VnngpCase:
    """Kernel 5's backward at one (n, K): shared inputs, each tree's outputs."""

    def __init__(self, torch, dev, n, K, seed):
        self.torch, self.dev, self.shape = torch, dev, (n, K)
        g = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn((n, K, K), generator=g, device=dev)
        b = torch.randn((n, K, K), generator=g, device=dev) * 0.3
        self.ins = (a @ a.mT + 3 * torch.eye(K, device=dev), b @ b.mT,
                    torch.randn((n, K), generator=g, device=dev),
                    torch.randn((n, K), generator=g, device=dev))
        self.kxx = torch.rand((n,), generator=g, device=dev) * 1.5 + 0.5
        self.cot = (torch.randn((n,), generator=g, device=dev),
                    torch.randn((n,), generator=g, device=dev))
        self.mean, self.cov = torch.empty((n,), device=dev), torch.empty((n,), device=dev)

    def outputs(self, lib):
        return dict(zip(self.keys(), (self.torch.empty_like(t) for t in self.ins)))

    def bwd(self, lib, out):
        n, K = self.shape
        fn = _fn(lib, "block_conditional_bwd_f32", [P] * 10 + [I64, I32, ctypes.c_float, P])
        ptrs = [t.data_ptr() for t in self.ins + self.cot] + [out[k].data_ptr()
                                                             for k in self.keys()]
        return lambda: fn(*ptrs, n, K, JITTER, _stream(self.torch))

    def forward_call(self, lib):
        n, K = self.shape
        fn = _fn(lib, "block_conditional_f32", [P] * 7 + [I64, I32, ctypes.c_float, P])
        ptrs = [t.data_ptr() for t in self.ins + (self.kxx, self.mean, self.cov)]
        return lambda: fn(*ptrs, n, K, JITTER, _stream(self.torch))

    def plan(self, lib):
        if not hasattr(lib, "block_conditional_bwd_plan"):
            return None
        n, K = self.shape
        out = (I64 * 4)()
        if _fn(lib, "block_conditional_bwd_plan", [I64, I32, ctypes.POINTER(I64)])(
                n, K, out) != 0:
            return None
        return dict(zip(("points_a_warp", "grid", "per_sm", "sms"), list(out)))

    def keys(self):
        return ("dkzz", "ds", "dkxz", "dmu")

    def bound_ms(self):
        n, K = self.shape
        return 1e3 * 4 * n * (2 * K * K + 2 * K + 2 + 2 * K * K + 2 * K) / HBM_BYTES_PER_S

    def fwd_bound_ms(self):
        n, K = self.shape
        return 1e3 * 4 * n * (2 * K * K + 2 * K + 1 + 2) / HBM_BYTES_PER_S


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


def kernel_nodes(torch, fn):
    """(kernel nodes, all nodes) of a CUDA graph that captured one call of
    ``fn``, from libcuda (cuGraphGetNodes, cuGraphNodeGetType)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    run_once(torch, fn)
    gr = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(gr):
        if fn() != 0:
            raise RuntimeError("launch failed during capture")
    handle = ctypes.c_void_p(gr.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del gr
    return sum(kind == 0 for kind in kinds), len(kinds)  # CU_GRAPH_NODE_TYPE_KERNEL = 0


def compare(torch, case, libs, source):
    """Bits of every output against the other tree's, and whether a rerun
    of this tree gives the same bits."""
    outs = {side: case.outputs(libs[side, source]) for side in SIDES}
    for side in SIDES:
        run_once(torch, case.bwd(libs[side, source], outs[side]))
    again = case.outputs(libs["this", source])
    run_once(torch, case.bwd(libs["this", source], again))
    rec = {f"{k}_bits_equal": bool(torch.equal(outs["this"][k], outs["other"][k]))
           for k in case.keys()}
    rec["rerun_bits_equal"] = all(bool(torch.equal(outs["this"][k], again[k]))
                                  for k in case.keys())
    if isinstance(case, GramCase):  # g with its planes transposed, read in place
        g_t = case.g.mT.contiguous().mT
        moved = case.outputs(libs["this", source])
        run_once(torch, case.bwd(libs["this", source], moved, g_t))
        rec["transposed_g_bits_equal"] = all(bool(torch.equal(outs["this"][k], moved[k]))
                                             for k in case.keys())
    rec["max_abs_diff"] = max(float((outs["this"][k] - outs["other"][k]).abs().max())
                              for k in case.keys())
    rec["finite"] = all(bool(torch.isfinite(outs["this"][k]).all()) for k in case.keys())
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


def kernel1_control(torch, dev, n_pairs):
    """Kernel 1 (this checkout's wrapper) at the north-star shape, the same
    code on both sides: its spread is the noise of the pairs."""
    sys.path.insert(0, ROOT)
    from gpzoo_tpu_torch.ops import tri_cuda

    L, M, B = 20, 3000, 7000
    g = torch.Generator(device=dev).manual_seed(SEED)
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    a = torch.randn((L, M, B), generator=g, device=dev)

    def call():
        tri_cuda.tri_sq_colsum_fused(lu, a)
        return 0
    rec = pairs(torch, {side: call for side in SIDES}, n_pairs)
    del lu, a
    torch.cuda.empty_cache()
    return rec


def measure(this_root, other_root, n_pairs=PAIRS):
    import torch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"this: {this_root}; other: {other_root}", flush=True)
    libs = build({"this": this_root, "other": other_root})
    case = GramCase(torch, dev, *GRAM_SHAPES["VNNGP sweep Kxz"], SEED, libs["this", "gram"])
    warm = {side: case.bwd(libs[side, "gram"], case.outputs(libs[side, "gram"]))
            for side in SIDES}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        for fn in warm.values():
            run_once(torch, fn)
    del case, warm
    torch.cuda.empty_cache()
    record = {"device": smi, "this": this_root, "other": other_root, "pairs": n_pairs,
              "reps": REPS, "gram": {}, "vnngp": {}, "ragged": {}}
    for source, shapes in (("gram", GRAM_SHAPES), ("vnngp", VNNGP_SHAPES)):
        for index, (label, spec) in enumerate(shapes.items()):
            case = (GramCase(torch, dev, *spec, SEED + index, libs["this", "gram"])
                    if source == "gram" else VnngpCase(torch, dev, *spec, SEED + index))
            rec, outs = compare(torch, case, libs, source)
            rec.update(shape=list(spec), plan=case.plan(libs["this", source]))
            rec["kernel_nodes"] = {side: kernel_nodes(torch, case.bwd(libs[side, source],
                                                                     outs[side]))
                                   for side in SIDES}
            rec["bwd"] = pairs(torch, {side: case.bwd(libs[side, source], outs[side])
                                       for side in SIDES}, n_pairs)
            rec["fwd"] = pairs(torch, {side: case.forward_call(libs[side, source])
                                       for side in SIDES}, n_pairs)
            rec["bound_ms"], rec["fwd_bound_ms"] = case.bound_ms(), case.fwd_bound_ms()
            if label.startswith("NSF sweep Kzx"):  # the path's cotangent: planes transposed
                g_t = case.g.mT.contiguous().mT
                rec["bwd_transposed_g"] = pairs(torch, {
                    "other": case.bwd(libs["this", source], outs["this"]),
                    "this": case.bwd(libs["this", source], outs["this"], g_t)}, n_pairs)
                print("  " + _line("this tree, g contiguous (other) and planes transposed "
                                   "(this)", rec["bwd_transposed_g"], rec["bound_ms"]),
                      flush=True)
            record[source][label] = rec
            bits = {k: v for k, v in rec.items() if "bits" in k or k in ("max_abs_diff",
                                                                          "finite")}
            print(f"[{source} {label} {tuple(spec)}] {bits}; plan {rec['plan']}; kernel "
                  f"nodes a call (kernel, all): {rec['kernel_nodes']}", flush=True)
            name = "rbf_gram" if source == "gram" else "block_conditional"
            print("  " + _line(f"subject {name}_bwd_f32", rec["bwd"], rec["bound_ms"]),
                  flush=True)
            print("  " + _line(f"control {name}_f32", rec["fwd"], rec["fwd_bound_ms"]),
                  flush=True)
            del case, outs
            torch.cuda.empty_cache()
    for source, shapes in (("gram", GRAM_RAGGED), ("vnngp", VNNGP_RAGGED)):
        for index, (label, spec) in enumerate(shapes.items()):
            case = (GramCase(torch, dev, *spec, SEED + 100 + index, libs["this", "gram"])
                    if source == "gram" else VnngpCase(torch, dev, *spec, SEED + 100 + index))
            rec, _ = compare(torch, case, libs, source)
            rec.update(shape=list(spec), plan=case.plan(libs["this", source]))
            record["ragged"][f"{source} {label}"] = rec
            print(f"[ragged {source} {label}] {rec}", flush=True)
            del case
            torch.cuda.empty_cache()
    record["kernel1"] = kernel1_control(torch, dev, n_pairs)
    print("  " + _line("control kernel 1 (20, 3000, 7000), the same code both sides",
                       record["kernel1"], float("nan")), flush=True)
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
        print("gram_vnngp_bwd_ab: no CUDA device", file=sys.stderr)
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
