#!/usr/bin/env python3
"""What holds kernel 7 (tri.cu ``tri_da_f32``) and kernel 4's backward
(mggp.cu ``mggp_gram_bwd_f32``) back: throwaway variants of a tree's
sources, each timed on the card against the source as it stands.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/kernel_anatomy.py [--tree DIR] [--set step1|design] [--out FILE]

``--tree`` names the tree whose ``gpzoo_tpu_torch/ops/csrc/{tri,mggp}.cu``
are patched (this checkout by default; for the measurements before a
redesign, a ``git archive`` of the commit before it). Each variant is the
source with a few lines replaced (``VARIANTS``: every anchor must be found,
else the variant is reported and skipped), compiled with this checkout's
nvcc flags into ``ops/build/`` (gitignored) and loaded with ctypes:

The set ``step1`` (the default) takes the sources as they were before the
redesign apart:

kernel 7 (the 3xTF32 main loop, instance ``tri_mma_kernel<4>``):
  a  as it stands;
  b  loads only: the consumers wait for each stage and release it, no wgmma;
  c  MMA only: the producer fills the ring once, the consumers never wait
     again (the products read stale tiles);
  s  the pass that stages Lu's rows alone (no main loop).
kernel 4's backward (``mggp_gram_bwd_kernel``, with the reduction after it):
  a  as it stands;
  b  G read and the planes written, no arithmetic (each element adds G);
  c  the arithmetic with G held in registers: no loads of G after the first;
  d  without the per-factor sums (no shuffles, no partials);
  r  ``__frcp_rn(den)`` for ``1.f / den`` (its outputs' bits against (a)).

The set ``design`` tries the pieces of the redesigned sources one by one:
kernel 7 ``reg`` (the register split at every grid), ``split`` (the split
staging and kernels 1-2's loop at every grid); kernel 4's backward
``depth2``, ``depth3``, ``depth4`` (the ring of G two, three or four
factors deep at every VEC), ``blocks2`` (two blocks an SM: 128 registers),
``ls8`` (the sums reduced every eight factors), ``ieee`` (the IEEE division
everywhere).

For each variant it prints ptxas's registers and spills of the kernel, the
SASS instructions of the kernel's factor loop (cuobjdump) and how many of
them are per element (one MUFU.EX2 an element), and TURNS turns of device
times, REPS calls captured in one CUDA graph, the variants' order reversed
in odd turns. Last, kernel 2's call at the Hybrid-NSF shape taken apart
through this checkout's wrapper (``ops/tri_cuda.py``): the wrapper, the
autograd Function's forward alone, the C entry point with its buffers made
beforehand, the allocations and the stream lookup, and ``torch.matmul``.
The last line is one JSON object with all of it. Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPS = 20
TURNS = 2
SEED = 19
TILE = 128
TF32_TC_FLOP_PER_S, HBM_BYTES_PER_S = 495e12, 3.35e12
# kernel 7's shapes (L, M, B) as tools/tri_kernels_ab.py has them
TRI_SHAPES = {"MGGP": (20, 3010, 7000), "Hybrid-MGGP": (10, 3010, 6000),
              "factor rank": (10, 3010, 7000), "data rank": (20, 3010, 3500),
              "Hybrid-NSF": (4, 529, 720)}
# kernel 4's backward: (L, N, M, Kzz, the outputs the path asks for:
# planes dd2 and dg2, the per-factor sums)
MGGP_SHAPES = {"MGGP Kzx": (20, 3010, 7000, False, (False, True, True)),
               "MGGP Kzz": (20, 3010, 3010, True, (False, True, True)),
               "Hybrid-MGGP Kzx": (10, 3010, 6000, False, (True, False, False)),
               "Hybrid-MGGP Kzz": (10, 3010, 3010, True, (True, False, False)),
               "data rank Kzx": (20, 3010, 3500, False, (False, True, True))}
MGGP_GROUPS = 14

_BWD_BODY = """        const float den = fmaf(al, g2[r][v], 1.f);
        const float inv = recip(den);
        const float u = d2[r][v] * inv;
        const float e = kern_e<P2>(c, d2[r][v], inv, den, half_p);
        const float ge = cur[r][v] * e;  // 0 for a pair past N or M
        const float tk = s2 * ge;
        const float ti = tk * inv;
        const float q = ti * fmaf(-c, u, -half_p);
        s_e += ge;
        s_tu = fmaf(tk, u, s_tu);
        s_ta = fmaf(q, g2[r][v], s_ta);
        acc_g[r][v] = fmaf(q, al, acc_g[r][v]);
        acc_d[r][v] = fmaf(ti, c, acc_d[r][v]);
"""
# {set: {source: {variant: [(regex, replacement), ...]}}}
VARIANTS = {"step1": {
    "tri": {
        "a": [],
        "b": [(r"for \(int kk = 0; kk < TK / 8; \+\+kk\) \{\n(\s+)const uint32_t off",
               r"for (int kk = 0; kk < 0; ++kk) {\n\1const uint32_t off")],
        "c": [(r"if \(round > 0\) mbar_wait\(empty \+ 8 \* s, \(round - 1\) & 1\);",
               "if (round > 0) continue;"),
              (r"(\n\s+)mbar_wait\(full \+ 8 \* s, \((i|it) / kStages\) & 1\);",
               r"\1if (\2 < kStages) mbar_wait(full + 8 * s, (\2 / kStages) & 1);")],
        "s": [(r"return launch<kDa>\(", "if (L > 0) return (int)cudaGetLastError();\n"
               "  return launch<kDa>(")],
    },
    "mggp": {
        "a": [],
        "b": [(re.escape(_BWD_BODY),
               "        s_e += cur[r][v];\n        s_tu += cur[r][v];\n"
               "        s_ta += cur[r][v];\n        acc_g[r][v] += cur[r][v];\n"
               "        acc_d[r][v] += cur[r][v];\n")],
        "c": [(r"cur\[r\]\[v\] = gv\[r\]\[v\];\n\s+gv\[r\]\[v\] = 0\.f;",
               "cur[r][v] = gv[r][v];"),
              (r"if \(l \+ 1 < L\) \{", "if (l + 1 < 0) {")],
        "d": [(r"if \(partials != nullptr\) \{", "if (false) {")],
        "r": [(r"float recip\(float den\) \{ return 1\.f / den; \}",
               "float recip(float den) { return __frcp_rn(den); }")],
    },
}, "design": {
    "tri": {
        "a": [],
        "reg": [(r"if \(\(int\)grid\.x <= sms\) \{", "if (false) {")],
        "split": [(r"if \(\(int\)grid\.x <= sms\) \{", "if (true) {")],
    },
    "mggp": {
        "a": [],
        "depth2": [(r"return vec == 4 \? 2 : 3;", "return 2;")],
        "depth3": [(r"return vec == 4 \? 2 : 3;", "return 3;")],
        "depth4": [(r"return vec == 4 \? 2 : 3;", "return 4;")],
        "blocks2": [(r"constexpr int BWD_MIN_BLOCKS = 3;", "constexpr int BWD_MIN_BLOCKS = 2;")],
        "ls8": [(r"constexpr int LS = 4;", "constexpr int LS = 8;")],
        "ieee": [(r"if \(al >= 0\.f && al \* g2max <= 0x1p100f\)", "if (false)")],
    },
}}
TRI_KERNEL = "tri_mma_kernelILi4E"  # kernel 7's instance
MGGP_KERNEL = "mggp_gram_bwd_kernel"


def _build_module():
    spec = importlib.util.spec_from_file_location(
        "_anatomy_build", os.path.join(ROOT, "gpzoo_tpu_torch", "ops", "_build.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def patched(text, patches):
    """``text`` with each (regex, replacement) applied; None if an anchor
    is missing."""
    for pattern, repl in patches:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            return None
    return text


def build(tree, variant_set):
    """{(source, variant): (ctypes library, ptxas log, library path)}, every
    variant of the set compiled in parallel."""
    b = _build_module()
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, variants in VARIANTS[variant_set].items():
        with open(os.path.join(tree, "gpzoo_tpu_torch", "ops", "csrc", f"{source}.cu")) as fh:
            text = fh.read()
        for variant, patches in variants.items():
            src = patched(text, patches)
            if src is None:
                print(f"  {source}.cu ({variant}): an anchor is missing, skipped", flush=True)
                continue
            digest = hashlib.sha256(src.encode()).hexdigest()[:12]
            cu = b.BUILD_DIR / f"anatomy_{source}_{variant}-{digest}.cu"
            cu.write_text(src)
            out = cu.with_suffix(".so")
            procs[source, variant] = (subprocess.Popen(
                [b._nvcc(), *b.NVCC_FLAGS, "-o", str(out), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = (ctypes.CDLL(str(out)), log, out)
    return libs, b


def ptxas(log, kernel):
    """{instance: 'N registers, S spill bytes'} of the entries whose name
    holds ``kernel``."""
    found, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and kernel in entry:
            if "spill" in line:
                found.setdefault(entry, {})["spills"] = line.split(":", 1)[-1].strip()
            elif "registers" in line:
                found.setdefault(entry, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    return found


def sass_loops(b, lib_path, kernel):
    """{instance: {"loop": instructions in its longest loop that holds a
    MUFU.EX2, "ex2": its MUFU.EX2, "per_element": their ratio, "total": all
    its instructions}} from ``cuobjdump -sass``; {} without cuobjdump."""
    tool = os.path.join(os.path.dirname(b._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    result, name, body = {}, None, []

    def close():
        if name is None or kernel not in name:
            return
        addrs = [a for a, _ in body]
        best = None
        for i, (addr, ins) in enumerate(body):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
            if m is None:
                continue
            target = int(m.group(1), 16)
            if target >= addr or target not in addrs:
                continue
            loop = body[addrs.index(target):i + 1]
            ex2 = sum("MUFU.EX2" in ins2 for _, ins2 in loop)
            if ex2 and (best is None or len(loop) > best["loop"]):
                best = {"loop": len(loop), "ex2": ex2}
        entry = {"total": len(body)}
        if best is not None:
            entry.update(best, per_element=best["loop"] / best["ex2"])
        result[name] = entry

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, body = line.split(":", 1)[1].strip(), []
        else:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
            if m and name is not None:
                body.append((int(m.group(1), 16), m.group(2)))
    close()
    return result


def graph(torch, fn):
    if fn() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
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


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def tri_case(torch, dev, L, M, B, seed):
    """Kernel 7's operands, output and scratch, and a launcher per library."""
    mp = -(-M // TILE) * TILE
    g = torch.Generator(device=dev).manual_seed(seed)
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    dct = torch.randn((2, L, B, mp), generator=g, device=dev)
    da = torch.empty((L, M, B), device=dev)
    scratch = torch.empty(2 * L * mp * mp, device=dev)

    def launcher(lib):
        fn = lib.tri_da_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        return lambda: fn(lu.data_ptr(), dct.data_ptr(), da.data_ptr(), L, M, B,
                          scratch.data_ptr(), _stream(torch))
    bound = 1e3 * max(4 * (L * M * (M + 1) // 2 + 2 * L * M * B) / HBM_BYTES_PER_S,
                      3 * L * B * M * (M + 1) / TF32_TC_FLOP_PER_S)
    return launcher, (lu, dct, da, scratch), bound


def mggp_case(torch, dev, L, N, M, kzz, wants, seed):
    """Kernel 4's backward operands and outputs (as chip_smoke.py makes
    them), and a launcher per library that returns its outputs' buffers."""
    sys.path.insert(0, ROOT)
    from gpzoo_tpu_torch.kernels.mggp import _default_embedding

    g = torch.Generator(device=dev).manual_seed(seed)
    emb = _default_embedding(MGGP_GROUPS, torch.float32, dev)
    x = torch.rand((N, 2), generator=g, device=dev) * 4 - 2
    z = x if kzz else torch.rand((M, 2), generator=g, device=dev) * 4 - 2
    ex = emb[torch.randint(MGGP_GROUPS, (N,), generator=g, device=dev)].contiguous()
    ez = ex if kzz else emb[torch.randint(MGGP_GROUPS, (M,), generator=g,
                                          device=dev)].contiguous()
    sigma = torch.linspace(0.5, 1.5, L, device=dev)
    ell = torch.linspace(0.8, 2.0, L, device=dev)
    alpha = torch.square(torch.linspace(0.2, 2.5, L, device=dev))
    G = torch.randn((L, N, M), generator=g, device=dev)
    E = ex.shape[1]
    want_d, want_g, want_h = wants
    outs = {"dd2": torch.empty((N, M), device=dev) if want_d else None,
            "dg2": torch.empty((N, M), device=dev) if want_g else None,
            "hyper": torch.empty((3, L), device=dev) if want_h else None}

    def launcher(lib, outs=outs):
        blocks = lib.mggp_gram_bwd_blocks
        blocks.argtypes, blocks.restype = [ctypes.c_int] * 5, ctypes.c_longlong
        parts = torch.empty((3, L, blocks(N, M, 2, E, L)), device=dev) if want_h else None
        fn = lib.mggp_gram_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptr = [None if t is None else t.data_ptr() for t in
               (outs["dd2"], outs["dg2"], outs["hyper"], parts)]
        return lambda: fn(G.data_ptr(), x.data_ptr(), z.data_ptr(), ex.data_ptr(),
                          ez.data_ptr(), sigma.data_ptr(), ell.data_ptr(), alpha.data_ptr(),
                          *ptr, N, M, 2, E, L, 1.0, _stream(torch))
    planes = int(want_d) + int(want_g)
    bound = 1e3 * 4 * (L * N * M + planes * N * M) / HBM_BYTES_PER_S
    return launcher, outs, bound


def time_variants(torch, launchers):
    """{variant: [ms of each turn]}: one graph each, TURNS turns."""
    graphs = {v: graph(torch, fn) for v, fn in launchers.items()}
    times = {v: [] for v in graphs}
    order = list(graphs)
    for turn in range(TURNS):
        for v in (order if turn % 2 == 0 else order[::-1]):
            times[v].append(replay_ms(torch, graphs[v]))
    return times


def kernel2_call(torch, dev):
    """Kernel 2's call at the Hybrid-NSF shape taken apart (CUDA events
    around each call, median of 50 after 10 unmeasured)."""
    sys.path.insert(0, ROOT)
    from gpzoo_tpu_torch.ops import _build, tri_cuda

    L, M, B = 4, 529, 720
    g = torch.Generator(device=dev).manual_seed(SEED)
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    a = torch.randn((L, M, B), generator=g, device=dev)
    out = torch.empty((L, M, B), device=dev)
    scratch = tri_cuda._scratch(lu, a)
    fn = tri_cuda._entry("tri_t_matmul_f32", tri_cuda._ARGTYPES)
    stream = tri_cuda._stream(lu)

    def median_ms(f, n=50):
        for _ in range(10):
            f()
        ts = []
        for _ in range(n):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)
    parts = {
        "wrapper tri_t_matmul": lambda: tri_cuda.tri_t_matmul(lu, a),
        "tri_t_matmul_fwd": lambda: tri_cuda.tri_t_matmul_fwd(lu, a),
        "_launch with buffers made": lambda: tri_cuda._launch("tri_t_matmul_f32", lu, a, out,
                                                              scratch),
        "C entry alone": lambda: fn(lu.data_ptr(), a.data_ptr(), out.data_ptr(), L, M, B,
                                    M * B, scratch.data_ptr(), stream),
        "out and scratch allocated": lambda: (torch.empty((L, M, B), device=dev),
                                              tri_cuda._scratch(lu, a)),
        "stream lookup": lambda: tri_cuda._stream(lu),
        "operand checks": lambda: _build.check_operands("t", lu=lu, a=a, scratch=scratch),
        "torch.matmul(lu.mT, a)": lambda: torch.matmul(lu.mT, a),
    }
    return {k: median_ms(f) for k, f in parts.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--set", default="step1", choices=sorted(VARIANTS))
    parser.add_argument("--out", default=None)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_anatomy: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    tree = os.path.abspath(opts.tree)
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; tree {tree}",
          flush=True)
    libs, b = build(tree, opts.set)
    record = {"device": smi, "tree": tree, "set": opts.set, "reps": REPS, "turns": TURNS,
              "build": {}, "kernel7": {}, "mggp_bwd": {}}
    for (source, variant), (_, log, path) in libs.items():
        kernel = TRI_KERNEL if source == "tri" else MGGP_KERNEL
        regs = ptxas(log, kernel)
        loops = sass_loops(b, path, kernel) if source == "mggp" else {}
        record["build"][f"{source} {variant}"] = {"ptxas": regs, "sass": loops}
        for inst, r in sorted(regs.items()):
            s = loops.get(inst, {})
            print(f"  [{source} {variant}] {inst}: {r.get('registers')} registers, "
                  f"{r.get('spills', '')}" + (
                      f"; SASS {s['total']} instructions, factor loop {s['loop']}, "
                      f"{s['ex2']} MUFU.EX2, {s['per_element']:.1f} an element"
                      if "loop" in s else ""), flush=True)
    # a warm-up: the first shape's kernel 7 for ~10 s
    launch, keep, _ = tri_case(torch, dev, *TRI_SHAPES["MGGP"], SEED)
    warm = launch(libs["tri", "a"][0])
    import time
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 10:
        warm()
        torch.cuda.synchronize()
    del keep, warm
    torch.cuda.empty_cache()
    for i, (label, (L, M, B)) in enumerate(TRI_SHAPES.items()):
        launch, keep, bound = tri_case(torch, dev, L, M, B, SEED + i)
        times = time_variants(torch, {v: launch(libs[s, v][0]) for s, v in libs
                                      if s == "tri"})
        record["kernel7"][label] = {"shape": [L, M, B], "bound_ms": bound, "ms": times}
        print(f"[kernel 7 {label} L={L} M={M} B={B}] bound {bound:.4f} ms; " + "; ".join(
            f"({v}) {' '.join(f'{t:.4f}' for t in ts)}" for v, ts in times.items()), flush=True)
        del keep
        torch.cuda.empty_cache()
    for i, (label, (L, N, M, kzz, wants)) in enumerate(MGGP_SHAPES.items()):
        launch, outs, bound = mggp_case(torch, dev, L, N, M, kzz, wants, SEED + i)
        variants = [v for s, v in libs if s == "mggp"]
        # bits of (r) against (a): both write into their own buffers
        bits = {}
        if "r" in variants and "a" in variants:
            got = {}
            for v in ("a", "r"):
                mine = {k: None if t is None else torch.empty_like(t) for k, t in outs.items()}
                if launch(libs["mggp", v][0], mine)() != 0:
                    raise RuntimeError("launch failed")
                torch.cuda.synchronize()
                got[v] = mine
            bits = {k: bool(torch.equal(got["a"][k], got["r"][k]))
                    for k in outs if outs[k] is not None}
            del got
        times = time_variants(torch, {v: launch(libs["mggp", v][0]) for v in variants})
        record["mggp_bwd"][label] = {"shape": [L, N, M], "wants": wants, "bound_ms": bound,
                                     "ms": times, "frcp_bits_equal": bits}
        print(f"[kernel 4 backward {label} L={L} N={N} M={M} dd2/dg2/sums {wants}] bound "
              f"{bound:.4f} ms; " + "; ".join(
                  f"({v}) {' '.join(f'{t:.4f}' for t in ts)}" for v, ts in times.items())
              + f"; __frcp_rn bits equal to 1.f/den: {bits}", flush=True)
        del outs
        torch.cuda.empty_cache()
    record["kernel2_call"] = kernel2_call(torch, dev)
    print("[kernel 2's call, Hybrid-NSF (4, 529, 720), ms] " + "; ".join(
        f"{k} {v:.4f}" for k, v in record["kernel2_call"].items()), flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(record, fh)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
