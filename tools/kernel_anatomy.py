#!/usr/bin/env python3
"""What holds a kernel back: throwaway variants of a tree's sources, each
timed on the card against the source as it stands. Kernel 7 (tri.cu
``tri_da_f32``) and kernel 4's backward (mggp.cu ``mggp_gram_bwd_f32``);
kernel 3's backward (gram.cu ``rbf_gram_bwd_f32``) and kernel 5's (vnngp.cu
``block_conditional_bwd_f32``) as they were before their redesign.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/kernel_anatomy.py [--tree DIR] [--against DIR]
                                    [--set step1|design|keepc|dluc|dac|scale|trace]
                                    [--sources tri,mggp,gram,vnngp] [--turns N]
                                    [--out FILE]

``--tree`` names the tree whose ``gpzoo_tpu_torch/ops/csrc/*.cu`` are
patched (this checkout by default; for the measurements before a
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

kernel 3's backward (``rbf_gram_bwd_kernel`` and the launch of
``rbf_gram_bwd_reduce_kernel`` after it), at its sixteen path shapes:
  a  as it stands;
  p  the pass alone, without the reduction launch;
  r  the reduction launch alone;
  b  the pass's loads only: no partials written, no reduction;
  w  the pass with the next factor's g and k loaded before this factor's sums.
kernel 5's backward (``block_conditional_bwd_kernel``), n = 50,000 and 5,000:
  a  as it stands;  b  the inputs' staging only;  c  the arithmetic on the
  staged inputs, no output written;  u  the outputs' unstaging alone.
Each of those two sources also reports how many blocks of its path
instance fit on an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
and an empty kernel is timed the same way as the floor of one graph node.
``--sources`` picks the sources of the set (all by default).

The set ``design`` tries the pieces of the redesigned sources one by one:
kernel 7 ``reg`` (the register split at every grid), ``split`` (the split
staging and kernels 1-2's loop at every grid); kernel 4's backward
``depth2``, ``depth3``, ``depth4`` (the ring of G two, three or four
factors deep at every VEC), ``blocks2`` (two blocks an SM: 128 registers),
``ls8`` (the sums reduced every eight factors), ``ieee`` (the IEEE division
everywhere).

The set ``keepc`` (source ``tri`` alone) takes kernel 1 keeping c
(``tri_mma_kernel<9>``, entry ``tri_sq_colsum_c_f32``) apart, at the
north-star shape and the MGGP one (KEEPC_SHAPES):
  a        as it stands;
  nostore  the store's code kept, its stores never taken (a runtime guard
           the shapes never meet): the code's cost without the bytes;
  stcs     streaming stores (``__stcs``, evict first) for the plain ones;
  scalar   one float a store, never two;
and, from (a)'s library, ``c0``: the same entry with c null, kernel 1
without c (``tri_mma_kernel<0>``). It prints the SASS counts of
local-memory loads and stores (LDL, STL) and of global stores (STG) of
instances <0> and <9>, and whether each variant's colsum and c are (a)'s
bits (c handed NaN-filled memory first).

The set ``dluc`` (source ``tri`` alone) takes kernel 6 reading c
(``tri_mma_kernel<10>``, entry ``tri_dlu_from_c_f32``) apart, at the
north-star shape and its factor rank's (DLUC_SHAPES):
  a        as it stands (2g in a shared-memory slot of each stage, copied by
           the producer);
  ldg      2g read from L2 by each consumer thread (8 loads a stage, issued
           before the stage's wait), the slot not copied;
  noscale  c not scaled: kernel 6 on c (wrong bits; the cost of the scaling);
  k6order  kernel 6's order of the three products (A lo B hi first);
  nostore  the epilogue's stores never taken (a runtime guard);
  prep     the entry's preparation alone: a's split and 2g's rows, no main
           loop;
and, from (a)'s library, ``k6``: kernel 6 (``tri_dlu_f32``) on the scale
pass's dc, and ``old``: the scale pass (``tri_split_f32`` given g), then
kernel 6, the route kernel 6 reading c replaces. Each variant's dLu (handed
NaN-filled memory) is held against (a)'s and the old route's bit for bit.

The set ``dac`` (source ``tri`` alone) takes kernel 7 reading c
(``tri_mma_kernel<11>``, entry ``tri_da_from_c_f32``) apart, at the MGGP,
Hybrid-MGGP and Hybrid-NSF shapes (DAC_SHAPES):
  a         as it stands;
  noscale   c not scaled by 2g (wrong bits; the cost of the scaling);
  straight  the tile read as if it were (b, m), the other modes' fragment
            address (wrong bits, no bank conflict; the cost of the
            transposed read);
  nostore   the epilogue's stores never taken (a runtime guard);
  ordb      kernel 7's tile order, the b tile before the k tiles;
and, from (a)'s library, ``k7``: kernel 7 (``tri_da_f32``) on the scale
pass's dcT, and ``old``: the scale pass with dcT, then kernel 7, the route
kernel 7 reading c replaces. Each variant's da (handed NaN-filled memory) is
held against (a)'s and the old route's bit for bit.

The set ``scale`` (source ``tri`` alone) takes the scale pass apart
(``tri_split_f32`` given g: ``scale_rows_kernel``, 512 16-byte chunks of a
row a block), at SCALE_SHAPES: ``a`` as it stands, ``nosplit`` c
and 2g stored as hi and lo with no arithmetic (wrong bits: the pass's loads
and stores alone), ``cs`` c read and the rows written with the streaming
hints (``__ldcs``, ``__stcs``), ``stcs`` the streaming stores alone, ``c8``
eight chunks a thread, ``t256`` 256 threads a block, and, with ``--against
DIR``, ``parent``: DIR's tri.cu as it stands (for 4f4e4bb, the scale pass as
split_kernel's 32 x 32 tile through shared memory), each against the bytes
of its layout (c and g read, hi and lo written), rows handed NaN-filled
memory and held against (a)'s bit for bit; beside them the card's own rates
for such bytes, each a PyTorch call with its TB/s: ``fill`` (the rows
written alone, ``fill_``), ``copy`` (c copied, ``copy_``) and ``mix`` (c
read once and two arrays of its size written, ``torch.frexp``: the pass's
read 1 : write 2); and the pass in the per-factor backward's chain, one
graph each: ``a+6+7c`` and ``parent+6+7c`` (the pass, then kernel 6 on its
rows and kernel 7 reading c, both from (a)'s library) and ``6+7c`` (the two
alone), all interleaved turn by turn.

The set ``trace`` (source ``tri`` alone) takes kernel 8's forward keeping P
(entry ``tri_kl_trace_f32`` given a P buffer) apart, at TRACE_SHAPES (the
north-star KL, a per-factor K⁻¹ at the MGGP width, the VNNGP KL and the
VNNGP sweep's): ``a`` the whole call as it stands; ``stage`` its staging
pass alone (in a tree before the persistent kernel, LuT written whole and
K_s split; after it, K_s split and, where M % 4 != 0, Lu's padded rows);
``nomirror`` (before the persistent kernel) the loop without the zeros of
the mirror tile above P's diagonal; ``nostore`` (the persistent kernel)
its P stores never taken; ``o0``, ``o1`` (the persistent kernel) its
other list (``trace_tile``'s order: the old grid's for a shared K⁻¹ too,
rt slowest for a per-factor one); ``straight``, ``noA``, ``noB`` (wrong
bits) operand A read without the transpose, or A's or B's loads gone;
``rows7``, ``stage7`` (where M % 4 != 0) Lu's rows copied by kernel 7's
staging instead, the call and its staging alone; and, from (a)'s library,
``noP``: the
same entry
with P null, the forward without P (``tri_mma_kernel<6>``). With
``--against DIR``, ``parent`` and ``parent noP``: DIR's call as it stands.
Each variant's trace and P's lower triangle (P handed NaN-filled memory)
are held against (a)'s and the parent's bit for bit.

For each variant it prints ptxas's registers and spills of the kernel, the
SASS instructions of the kernel's factor loop (cuobjdump) and how many of
them are per element (one MUFU.EX2 an element), and TURNS turns of device
times (``--turns``, 2 by default), REPS calls captured in one CUDA graph,
the variants' order reversed in odd turns. Last, kernel 2's call at the Hybrid-NSF shape taken apart
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
# kernel 3's backward (gram.cu rbf_gram_bwd_f32: the pass, then the reduction
# launch) and kernel 5's (vnngp.cu block_conditional_bwd_f32), as they were
# before their redesign
_GRAM_LOADS = """    for (int l = 0; l < L; ++l) {
      float gv[BWD_ROWS][VEC], kv[BWD_ROWS][VEC];
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) {
        const int64_t at = l * plane + (int64_t)(n0 + r) * M + m0;
        if (live[r]) {
          load_cs<VEC>(gv[r], g + at);
          load_cs<VEC>(kv[r], k + at);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) gv[r][v] = kv[r][v] = 0.f;
        }
      }
"""
# (w): the next factor's g and k loaded before this factor's sums
_GRAM_LOADS_AHEAD = """    float gn[BWD_ROWS][VEC], kn[BWD_ROWS][VEC];
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) {
      const int64_t at = (int64_t)(n0 + r) * M + m0;
      if (live[r]) {
        load_cs<VEC>(gn[r], g + at);
        load_cs<VEC>(kn[r], k + at);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) gn[r][v] = kn[r][v] = 0.f;
      }
    }
    for (int l = 0; l < L; ++l) {
      float gv[BWD_ROWS][VEC], kv[BWD_ROWS][VEC];
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) gv[r][v] = gn[r][v], kv[r][v] = kn[r][v];
        const int64_t at = (int64_t)(l + 1) * plane + (int64_t)(n0 + r) * M + m0;
        if (live[r] && l + 1 < L) {
          load_cs<VEC>(gn[r], g + at);
          load_cs<VEC>(kn[r], k + at);
        }
      }
"""
_NO_REDUCE = (r"if \(grid == 0\) return 0;", "if (grid >= 0) return 0;")


def _vnngp_bwd_only(old, new):
    """Replace ``old`` by ``new`` in vnngp.cu's backward kernel only (the
    forward shares its staging lines)."""
    def patch(text):
        head, sep, tail = text.partition("block_conditional_bwd_kernel(const float")
        return None if not sep or old not in tail else head + sep + tail.replace(old, new)
    return patch


_VNNGP_NO_COMPUTE = [
    (r"if \(active\) \{\n    cholesky<K>", "if (active && n < 0) {\n    cholesky<K>"),
    (r"// s\n  __syncwarp\(\);\n  if \(active\) \{\n    // dw",
     "// s\n  __syncwarp();\n  if (active && n < 0) {\n    // dw")]
VARIANTS["step1"].update({
    "gram": {
        "a": [],
        "p": [_NO_REDUCE],
        "r": [(r"rbf_gram_bwd_kernel<DV, VEC><<<", "if (N < 0) rbf_gram_bwd_kernel<DV, VEC><<<")],
        "b": [_NO_REDUCE, (r"if \(phyper != nullptr\) \{",
                           "if (s_gk == 1.2345e-30f && phyper != nullptr) {"),
              (r"if \(pdx != nullptr\) \{", "if (N < 0) {"),
              (r"if \(pdz != nullptr\) \{", "if (N < 0) {")],
        "w": [(re.escape(_GRAM_LOADS), _GRAM_LOADS_AHEAD.replace("\\", "\\\\"))],
    },
    "vnngp": {
        "a": [],
        "b": [_VNNGP_NO_COMPUTE[0], (r"// s\n  __syncwarp\(\);\n  if \(active\) \{\n    // dw",
                                     "// s\n  __syncwarp();\n  if (n > 0) return;\n"
                                     "  if (active) {\n    // dw")],
        "c": [(r"if \((\w+) != nullptr\) unstage<", r"if (jitter == -12345.f && \1 != nullptr) unstage<")],
        "u": [*_VNNGP_NO_COMPUTE, _vnngp_bwd_only("  stage_async<", "  if (n < 0) stage_async<")],
    },
})
# the redesigned backwards taken apart: kernel 3's ring three steps deep,
# 32 helpers, one block an SM (the grid, or the registers of one block),
# the helpers not waiting (wrong sums: their time alone), polling with
# no pause or 256 ns ones, no per-factor partials; kernel 5's
# without the prefetch of the next group's inputs, the registers bounded
# for 3, 4, 5, 6 or 8 blocks an SM, no output stored (the arithmetic kept),
# the columns for dw not loaded
VARIANTS["design"].update({
    "gram": {
        "a": [],
        "stages3": [(r"constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
        "helpers32": [(r"const int most = sms > 1 \? sms - 1 : 1;", "const int most = 32;")],
        "grid1": [(r"const int64_t wave = \(int64_t\)per_sm \* p.sms;",
                   "const int64_t wave = p.sms;")],
        "lb1": [(r"__launch_bounds__\(THREADS, D <= 2 \? 2 : 1\)", "__launch_bounds__(THREADS, 1)")],
        "nowait": [(r"while \(load_acquire\(counters \+ DONE\) < gridDim.x\) __nanosleep\(32\);",
                    ";")],
        "sleep0": [(r"__nanosleep\(32\);", ";")],
        "sleep256": [(r"__nanosleep\(32\);", "__nanosleep(256);")],
        "nohyper": [(r"if \(phyper != nullptr\) \{\n          s_gk = warp_sum",
                     "if (false) {\n          s_gk = warp_sum")],
    },
    "vnngp": {
        "a": [],
        "lb0": [(r"__launch_bounds__\(BWD_WARPS \* WARP, 3\)",
                 "__launch_bounds__(BWD_WARPS * WARP)")],
        "noprefetch": [(r"    const Inputs cur = next;\n    load\(next, grp \+ stride\);",
                        "    load(next, grp);\n    const Inputs cur = next;")],
        "nostore": [(r"if \((\w+) != nullptr\) (store_row<K>|\w+\[p \* K \+ row\] =)",
                     r"if (\1 != nullptr && jitter == -12345.f) \2")],
        "nocols": [(r"mine \? __ldg\(s \+ p \* KK \+ j \* K \+ row\) : 0\.f", "srow[j]"),
                   (r"mine \? __ldg\(kzz \+ p \* KK \+ j \* K \+ row\) : 0\.f", "krow[j]")],
    },
})
VARIANTS["keepc"] = {"tri": {
    "a": [],
    "nostore": [(r"if \(row \+ 8 \* h >= p\.M\) continue;",
                 "if (row + 8 * h >= p.M || p.M > 0) continue;")],
    "stcs": [(r"\*reinterpret_cast<float2\*>\(c_row \+ b\) = make_float2\(v0, v1\);",
              "__stcs(reinterpret_cast<float2*>(c_row + b), make_float2(v0, v1));"),
             (r"c_row\[b\] = v0;", "__stcs(c_row + b, v0);"),
             (r"c_row\[b \+ 1\] = v1;", "__stcs(c_row + b + 1, v1);")],
    "scalar": [(r"const bool pairs = \(p\.B & 1\) == 0;", "const bool pairs = false;")],
}}
# kernel 1 keeping c: (L, M, B, a per factor), the north-star and MGGP steps'
KEEPC_SHAPES = {"north-star": (20, 3000, 7000, False), "mggp": (20, 3010, 7000, True)}
_DLUC_G_SLOT = """    mbar_wait(full + 8 * s, (i / kStages) & 1);
    [[maybe_unused]] float g2[TK / 8][2];
    if constexpr (kMode == kDluC) {
      const uint32_t g32 = smem_u32(red) + s * TK * 4;
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u) g2[kk][u] = lds_f32(g32 + (8 * kk + lane % 4 + 4 * u) * 4);
    }
"""
# (ldg): each thread loads its 8 values of 2g from L2 before the stage's
# wait; a block's stages run from kt = 0, so stage i is kt = i
_DLUC_G_LDG = """    [[maybe_unused]] float g2[TK / 8][2];
    if constexpr (kMode == kDluC) {
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          g2[kk][u] = __ldg(p.g + (int64_t)l * p.Bp + i * TK + 8 * kk + lane % 4 + 4 * u);
    }
    mbar_wait(full + 8 * s, (i / kStages) & 1);
"""
_DLUC_K6_ORDER = """            if (kk == 0)
              wgmma_tf32_ra<0>(acc, cur_lo[kk], smem_desc(bh + off));
            else
              wgmma_tf32_ra<1>(acc, cur_lo[kk], smem_desc(bh + off));
            wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bl + off));
"""
VARIANTS["dluc"] = {"tri": {
    "a": [],
    "ldg": [(re.escape(_DLUC_G_SLOT), _DLUC_G_LDG.replace("\\", "\\\\")),
            (r"mbar_expect_tx\(bar, kStageBytes \+ \(kMode == kDluC \? TK \* 4 : 0\)\);",
             "mbar_expect_tx(bar, kStageBytes);"),
            (r"if constexpr \(kMode == kDluC\)\n\s+bulk_load\(", "if constexpr (false)\n  bulk_load(")],
    "noscale": [(r"if constexpr \(kMode == kDluC\) v = __fmul_rn\(g2\[kk\]\[e >> 1\], v\);",
                 "")],
    "k6order": [(r"(            if \(kk == 0\)\n              wgmma_tf32_ra<0>\(acc, cur_hi\[kk\], "
                 r"smem_desc\(bl \+ off\)\);\n            else\n              wgmma_tf32_ra<1>"
                 r"\(acc, cur_hi\[kk\], smem_desc\(bl \+ off\)\);\n            wgmma_tf32_ra<1>"
                 r"\(acc, cur_lo\[kk\], smem_desc\(bh \+ off\)\);\n)", _DLUC_K6_ORDER)],
    "nostore": [(r"if \(k < p\.M && m < p\.M\)\n(\s+)p\.out\[\(\(int64_t\)l \* p\.M \+ k\) "
                 r"\* p\.M \+ m\] = k >= m",
                 r"if (k < p.M && m < p.M && p.M < 0)\n\1p.out[((int64_t)l * p.M + k) * p.M + m] "
                 r"= k >= m"),
                (r"if \(ct > rt && k2 < p\.M && m2 < p\.M\)", "if (ct > rt && k2 < p.M && p.M < 0)")],
    "prep": [(r"return launch<kDluC>\(", "if (L > 0) return (int)cudaGetLastError();\n  "
              "return launch<kDluC>(")],
}}
# kernel 6 reading c: (L, M, B), a shared a: the north-star step's and its
# [parallel] factor rank's
DLUC_SHAPES = {"north-star": (20, 3000, 7000), "factor rank": (10, 3000, 7000)}
DLUC_INSTANCES = ("tri_mma_kernelILi3E", "tri_mma_kernelILi10E")
_DAC_READ = (r"v = lds_f32\(a32 \+ \(row / C_BOX\) \* \(TILE_BYTES / \(TM / C_BOX\)\) "
             r"\+ k \* 128 \+\n"
             r"\s+\(\(\(bb >> 2\) \^ \(k & 7\)\) << 4\) \+ \(bb & 3\) \* 4\);")
VARIANTS["dac"] = {"tri": {
    "a": [],
    "noscale": [(r"v = __fmul_rn\(g2_row\[e & 1\], v\);", "")],
    "straight": [(_DAC_READ, "v = lds_f32(a32 + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + "
                             "(k & 3) * 4);")],
    "nostore": [(r"const int bl = t % TM, b = rt \* TM \+ bl;\n      if \(b < p\.B\) \{",
                 "const int bl = t % TM, b = rt * TM + bl;\n      if (b < p.B && p.M < 0) {")],
    "ordb": [(r"    ct = nrt - 1 - r / nct;\n    rt_begin = r % nct;\n",
              "    rt_begin = r / nrt;\n    ct = nrt - 1 - r % nrt;\n")],
}}
# kernel 7 reading c: (L, M, B), a per-factor a: the MGGP, Hybrid-MGGP and
# Hybrid-NSF steps' (the last one wave: 120 blocks)
DAC_SHAPES = {"MGGP": (20, 3010, 7000), "Hybrid-MGGP": (10, 3010, 6000),
              "Hybrid-NSF": (4, 529, 720)}
DAC_INSTANCES = ("tri_mma_kernelILi4E", "tri_mma_kernelILi5E", "tri_mma_kernelILi11E")
# the scale pass, rows only (scale_rows_kernel)
_SCALE_CS = [(r"const float4 xv = \*reinterpret_cast<const float4\*>\(c_row \+ b\);",
              "const float4 xv = __ldcs(reinterpret_cast<const float4*>(c_row + b));"),
             (r"\*reinterpret_cast<float4\*>\((hi|lo)_row \+ b\) = (make_float4\([^;]*\));",
              r"__stcs(reinterpret_cast<float4*>(\1_row + b), \2);")]
VARIANTS["scale"] = {"tri": {
    "a": [],
    # c and 2 g stored as hi and lo with no arithmetic (wrong bits): the
    # pass's own loads and stores alone
    "nosplit": [(r"h\[e\] = tf32_rna\(v\);\n\s+lo\[e\] = tf32_rna\(v - h\[e\]\);",
                 "h[e] = x[j][e], lo[e] = gb[j][e];")],
    "cs": _SCALE_CS,
    "stcs": _SCALE_CS[1:],
    # eight chunks a thread (1,024 a block), or 256 threads a block
    "c8": [(r"SCALE_CHUNKS = 4;", "SCALE_CHUNKS = 8;")],
    "t256": [(r"SCALE_THREADS = 128,", "SCALE_THREADS = 256,")],
}}
def _either(*patches):
    """A patch that applies the first of ``patches`` ((regex, replacement)
    pairs) whose anchor is found, for a variant that has one anchor in one
    tree and another in the next; None where none is found."""
    def patch(text):
        for pattern, repl in patches:
            out, n = re.subn(pattern, repl, text)
            if n:
                return out
        return None
    return patch


# kernel 8's forward keeping P (entry tri_kl_trace_f32 given a P buffer)
VARIANTS["trace"] = {"tri": {
    "a": [],
    # the staging pass alone: LuT whole and K_s split (4f4e4bb), or K_s
    # split and, where M % 4 != 0, Lu's padded rows (the persistent kernel)
    "stage": [_either(
        (r"  if \(p_out != nullptr\)\n    return launch<kTraceP>\(",
         "  if (L > 0) return (int)cudaGetLastError();\n"
         "  if (p_out != nullptr)\n    return launch<kTraceP>("),
        (r"return launch_trace_p\(", "if (L > 0) return (int)cudaGetLastError();\n"
         "  return launch_trace_p("))],
    # 4f4e4bb's loop without the zeros of the mirror tile above P's diagonal
    "nomirror": [(r"if \(ct > rt && j2 < p\.M\)", "if (ct > rt && j2 < p.M && p.M < 0)"),
                 (r"kMode == kTraceP \? v : g2 \* v", "kMode == kTraceP ? v : g2 * v")],
    # the persistent kernel with its P stores never taken (a runtime guard)
    "nostore": [(r"if \(i < p\.M && j <= i\) out_l", "if (i < p.M && j <= i && p.M < 0) out_l")],
    # the persistent kernel's other list (trace_tile's order): the old
    # grid's for a shared K⁻¹ too (o0), rt slowest for a per-factor one (o1)
    "o0": [(r"const int order = p\.b_slab != 0 \? 0 : 1;", "const int order = 0;")],
    "o1": [(r"const int order = p\.b_slab != 0 \? 0 : 1;", "const int order = 1;")],
    # the persistent kernel's operand A read straight, not transposed (wrong
    # bits: the cost of the transposed read), or not loaded at all (A or B:
    # wrong bits, the cost of their loads)
    "straight": [(r"float v = lds_f32\(a32 \+ \(row / C_BOX\) \* \(TILE_BYTES / \(TM / C_BOX\)\) "
                  r"\+ k \* 128 \+\n\s+\(\(\(bb >> 2\) \^ \(k & 7\)\) << 4\) \+ \(bb & 3\) \* 4\);",
                  "float v = lds_f32(a32 + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4);")],
    "noA": [(r"for \(int j = 0; j < TM / C_BOX; \+\+j\)\n(\s+)tma_load_3d\(st \+ j \* "
             r"\(TILE_BYTES / \(TM / C_BOX\)\), &lu_map",
             r"for (int j = 0; j < 0; ++j)\n\1tma_load_3d(st + j * (TILE_BYTES / (TM / C_BOX)), &lu_map"),
            (r"mbar_expect_tx\(bar, kStageBytes\);", "mbar_expect_tx(bar, kStageBytes - TILE_BYTES);")],
    "noB": [(r"(\s+)tma_load\(st \+ TILE_BYTES, &k_hi, kt \* TK, b_row, bar\);\n\s+tma_load\(st "
             r"\+ 2 \* TILE_BYTES, &k_lo, kt \* TK, b_row, bar\);", r"\1;"),
            (r"mbar_expect_tx\(bar, kStageBytes\);", "mbar_expect_tx(bar, TILE_BYTES);")],
}}
# where M % 4 != 0: Lu's rows copied by kernel 7's staging (a block a
# quarter row, one float a thread) instead of a block a row, 16 bytes a
# thread; the call (rows7) and its staging alone (stage7)
_ROWS7 = (r"trace_lu_rows_kernel<<<dim3\(p\.Mp, L\), 256, 0, st>>>\(lu, rows, M, p\.Mp\);",
          "stage_lu_rows_kernel<true><<<dim3((p.Mp + 255) / 256, p.Mp, L), 256, 0, st>>>("
          "lu, rows, nullptr, M, p.Mp);")
VARIANTS["trace"]["tri"].update(rows7=[_ROWS7],
                                stage7=[*VARIANTS["trace"]["tri"]["stage"], _ROWS7])
# kernel 8 keeping P: (L, M, K⁻¹ per factor): the north-star KL (a shared
# K⁻¹), a per-factor K⁻¹ at the MGGP width (M % 4 != 0), and the VNNGP KL
# (one factor; the VNNGP sweep's ten)
TRACE_SHAPES = {"north-star": (20, 3000, False), "per-factor": (20, 3010, True),
                "VNNGP": (1, 1000, False), "VNNGP L=10": (10, 1000, False),
                "per-factor M=3000": (20, 3000, True), "shared M=3010": (20, 3010, False)}
TRACE_INSTANCES = ("tri_mma_kernelILi6E", "tri_mma_kernelILi8E", "trace_p_kernel",
                   "stage_trace_kernel", "stage_a_rows_kernel")
# the scale pass: (L, M, B), a per-factor a: the MGGP, Hybrid-MGGP, [parallel]
# factor and data rank and Hybrid-NSF steps'
SCALE_SHAPES = {"MGGP": (20, 3010, 7000), "Hybrid-MGGP": (10, 3010, 6000),
                "factor rank": (10, 3010, 7000), "data rank": (20, 3010, 3500),
                "Hybrid-NSF": (4, 529, 720)}
# appended to every variant of a source: the blocks of the backward's path
# instance that fit on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
APPEND = {"step1": {
    "gram": """
extern "C" int anatomy_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rbf_gram_bwd_kernel<2, 4>, THREADS, 0);
}
""",
    "vnngp": """
extern "C" int anatomy_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, block_conditional_bwd_kernel<8>, WARP, Shape<8>::SMEM);
}
""",
}}
# an empty kernel: the floor of one kernel node of a CUDA graph on this card
EMPTY_CU = """#include <cuda_runtime.h>
__global__ void anatomy_empty_kernel() {}
extern "C" int anatomy_empty(void* stream) {
  anatomy_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
TRI_KERNEL = "tri_mma_kernelILi4E"  # kernel 7's instance
# the instances whose registers are printed: the paths' (D = 2, VEC = 4; K = 8)
PRINTED = {"gram": ("ILi2ELi4E", "reduce"), "vnngp": ("ILi8E",)}
# kernel 1 without c and keeping c, for the set keepc
KEEPC_INSTANCES = ("tri_mma_kernelILi0E", "tri_mma_kernelILi9E")
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
    for patch in patches:
        if callable(patch):
            text = patch(text)
            if text is None:
                return None
            continue
        text, n = re.subn(*patch, text)
        if n == 0:
            return None
    return text


def build(tree, variant_set, sources, against=None):
    """{(source, variant): (ctypes library, ptxas log, library path)}, every
    variant of the set's ``sources`` compiled in parallel, the sources of
    the tree ``against`` as they stand as (source, "parent"), and the empty
    kernel as ("empty", "")."""
    b = _build_module()
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    empty = b.BUILD_DIR / f"anatomy_empty-{hashlib.sha256(EMPTY_CU.encode()).hexdigest()[:12]}.cu"
    empty.write_text(EMPTY_CU)
    procs["empty", ""] = (subprocess.Popen(
        [b._nvcc(), *b.NVCC_FLAGS, "-o", str(empty.with_suffix(".so")), str(empty)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), empty.with_suffix(".so"))
    for source, variants in VARIANTS[variant_set].items():
        if source not in sources:
            continue
        with open(os.path.join(tree, "gpzoo_tpu_torch", "ops", "csrc", f"{source}.cu")) as fh:
            text = fh.read()
        if against:
            with open(os.path.join(against, "gpzoo_tpu_torch", "ops", "csrc",
                                   f"{source}.cu")) as fh:
                variants = dict(variants, parent=None)
                parent = fh.read()
        for variant, patches in variants.items():
            src = parent if patches is None else patched(text, patches)
            if src is None:
                print(f"  {source}.cu ({variant}): an anchor is missing, skipped", flush=True)
                continue
            src += APPEND.get(variant_set, {}).get(source, "")
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
    its instructions, "LDL", "STL", "STG": its local loads and stores and
    global stores}} from ``cuobjdump -sass``; {} without cuobjdump."""
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
        ops = [re.match(r"(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", ins) for _, ins in body]
        ops = [m.group(1) for m in ops if m]
        entry = {"total": len(body), **{op: ops.count(op) for op in ("LDL", "STL", "STG")}}
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


def keepc_case(torch, dev, L, M, B, per_factor, seed):
    """Kernel 1's operands, outputs and scratch, and a launcher per library
    (keeping c, or with c null), and the 3xTF32 bound of kernel 1 keeping
    c (its colsum and c written)."""
    mp = -(-M // TILE) * TILE
    g = torch.Generator(device=dev).manual_seed(seed)
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    a = torch.randn((L, M, B) if per_factor else (M, B), generator=g, device=dev)
    out = torch.empty((L, B), device=dev)
    c = torch.empty((L, M, B), device=dev)
    scratch = torch.empty(2 * L * mp * mp + 2 * (L if per_factor else 1) * B * mp, device=dev)
    stride = M * B if per_factor else 0

    def launcher(lib, keep):
        fn = lib.tri_sq_colsum_c_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return lambda: fn(lu.data_ptr(), a.data_ptr(), out.data_ptr(),
                          c.data_ptr() if keep else None, L, M, B, stride,
                          scratch.data_ptr(), _stream(torch))
    bound = 1e3 * max(4 * (L * M * (M + 1) // 2 + (L if per_factor else 1) * M * B
                           + L * B + L * M * B) / HBM_BYTES_PER_S,
                      3 * L * B * M * (M + 1) / TF32_TC_FLOP_PER_S)
    return launcher, (lu, a, out, c, scratch), bound


def keepc_bits(torch, fns, out, c):
    """{variant: {"colsum": bool, "c": bool}}: each variant's outputs against
    (a)'s, c handed NaN-filled memory first."""
    fns["a"]()
    torch.cuda.synchronize()
    want = (out.clone(), c.clone())
    bits = {}
    for v, fn in fns.items():
        c.fill_(float("nan"))
        fn()
        torch.cuda.synchronize()
        bits[v] = {"colsum": bool(torch.equal(out, want[0])), "c": bool(torch.equal(c, want[1]))}
    return bits


def dluc_case(torch, dev, L, M, B, seed):
    """Kernel 6 reading c's operands (a (M, B), c (L, M, B), g (L, B)), its
    dLu and scratch, a launcher per library, the controls from a library
    (kernel 6 on the scale pass's dc, and the scale pass then kernel 6), and
    the 3xTF32 bound (a, c and g read, dLu written)."""
    bp = -(-B // 32) * 32
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, B), generator=g, device=dev)
    c = torch.randn((L, M, B), generator=g, device=dev)
    gout = torch.randn((L, B), generator=g, device=dev)
    dlu = torch.empty((L, M, M), device=dev)
    scratch = torch.empty((3 * L + 2) * M * bp + L * bp, device=dev)
    rows = torch.empty((2, L, M, bp), device=dev)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def launcher(lib):
        fn = lib.tri_dlu_from_c_f32
        fn.argtypes, fn.restype = [ptr] * 4 + [i32] * 3 + [ptr, ptr], i32
        return lambda: fn(a.data_ptr(), c.data_ptr(), gout.data_ptr(), dlu.data_ptr(), L, M, B,
                          scratch.data_ptr(), _stream(torch))

    def controls(lib):
        split, k6 = lib.tri_split_f32, lib.tri_dlu_f32
        split.argtypes, split.restype = [ptr] * 4 + [i32] * 3 + [ptr], i32
        k6.argtypes, k6.restype = [ptr] * 3 + [i32] * 3 + [ctypes.c_longlong, ptr, ptr], i32

        def scale():
            return split(c.data_ptr(), gout.data_ptr(), rows.data_ptr(), None, L, M, B,
                         _stream(torch))

        def kernel6():
            return k6(a.data_ptr(), rows.data_ptr(), dlu.data_ptr(), L, M, B, 0,
                      scratch.data_ptr(), _stream(torch))
        if scale() != 0:
            raise RuntimeError("the scale pass failed")
        return {"k6": kernel6, "old": lambda: scale() or kernel6()}
    bound = 1e3 * max(4 * (M * B + L * M * B + L * B + L * M * M) / HBM_BYTES_PER_S,
                      3 * L * B * M * (M + 1) / TF32_TC_FLOP_PER_S)
    return launcher, controls, (a, c, gout, dlu, scratch, rows), bound


def dluc_bits(torch, fns, dlu):
    """{variant: {"a": bool, "old": bool}}: each variant's output (dLu, or
    kernel 7 reading c's da) against (a)'s and the old route's, handed
    NaN-filled memory first."""
    want = {}
    for v in ("a", "old"):
        dlu.fill_(float("nan"))
        fns[v]()
        torch.cuda.synchronize()
        want[v] = dlu.clone()
    bits = {}
    for v, fn in fns.items():
        dlu.fill_(float("nan"))
        fn()
        torch.cuda.synchronize()
        bits[v] = {w: bool(torch.equal(dlu, ref)) for w, ref in want.items()}
    return bits


def scale_case(torch, dev, L, M, B, seed):
    """The scale pass's operands (c (L, M, B), g (L, B)), its rows (2, L, M,
    Bp), a launcher per library (``tri_split_f32`` given g, rows only) and
    the bound of its layout's bytes (c and g read, hi and lo written)."""
    bp = -(-B // 32) * 32
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randn((L, M, B), generator=g, device=dev)
    gout = torch.randn((L, B), generator=g, device=dev)
    rows = torch.empty((2, L, M, bp), device=dev)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def launcher(lib):
        fn = lib.tri_split_f32
        fn.argtypes, fn.restype = [ptr] * 4 + [i32] * 3 + [ptr], i32
        return lambda: fn(c.data_ptr(), gout.data_ptr(), rows.data_ptr(), None, L, M, B,
                          _stream(torch))
    bound = 1e3 * 4 * (3 * L * M * B + L * B) / HBM_BYTES_PER_S
    return launcher, (c, gout, rows), bound


def scale_chain(torch, dev, c, gout, rows, L, M, B, seed):
    """The per-factor backward as the paths run it after the scale pass:
    kernel 6 (``tri_dlu_f32``, a per-factor a) on the pass's rows, then
    kernel 7 reading c (``tri_da_from_c_f32``), both from one library, so
    that a chain of (a variant's pass, 6, 7c) differs from another only in
    its pass. Returns a launcher of the two and the buffers it keeps."""
    mp, bp = -(-M // TILE) * TILE, -(-B // 32) * 32
    g = torch.Generator(device=dev).manual_seed(seed)
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    a = torch.randn((L, M, B), generator=g, device=dev)
    dlu = torch.empty((L, M, M), device=dev)
    da = torch.empty((L, M, B), device=dev)
    scratch = torch.empty(2 * L * mp * mp + max(2 * L * B * mp, L * M * bp), device=dev)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def launcher(lib):
        k6, k7 = lib.tri_dlu_f32, lib.tri_da_from_c_f32
        k6.argtypes, k6.restype = [ptr] * 3 + [i32] * 3 + [ctypes.c_longlong, ptr, ptr], i32
        k7.argtypes, k7.restype = [ptr] * 4 + [i32] * 3 + [ptr, ptr], i32
        return lambda: (k6(a.data_ptr(), rows.data_ptr(), dlu.data_ptr(), L, M, B, M * B,
                           scratch.data_ptr(), _stream(torch))
                        or k7(lu.data_ptr(), c.data_ptr(), gout.data_ptr(), da.data_ptr(), L, M,
                              B, scratch.data_ptr(), _stream(torch)))
    return launcher, (lu, a, dlu, da, scratch)


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


def dac_case(torch, dev, L, M, B, seed):
    """Kernel 7 reading c's operands (Lu (L, M, M), c (L, M, B), g (L, B)),
    its da and scratch, a launcher per library, the controls from a library
    (kernel 7 on the scale pass's dcT, and the scale pass with dcT then
    kernel 7: c scaled by 2g in PyTorch, the pass's product, then split with
    dcT), and the 3xTF32 bound (Lu's lower triangle, c and g read, da
    written)."""
    mp, bp = -(-M // TILE) * TILE, -(-B // 32) * 32
    g = torch.Generator(device=dev).manual_seed(seed)
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    c = torch.randn((L, M, B), generator=g, device=dev)
    gout = torch.randn((L, B), generator=g, device=dev)
    da = torch.empty((L, M, B), device=dev)
    scratch = torch.empty(2 * L * mp * mp + max(2 * L * B * mp, L * M * bp), device=dev)
    rows = torch.empty((2, L, M, bp), device=dev)
    rows_t = torch.empty((2, L, B, mp), device=dev)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def launcher(lib):
        fn = lib.tri_da_from_c_f32
        fn.argtypes, fn.restype = [ptr] * 4 + [i32] * 3 + [ptr, ptr], i32
        return lambda: fn(lu.data_ptr(), c.data_ptr(), gout.data_ptr(), da.data_ptr(), L, M, B,
                          scratch.data_ptr(), _stream(torch))

    def controls(lib):
        split, k7 = lib.tri_split_f32, lib.tri_da_f32
        split.argtypes, split.restype = [ptr] * 4 + [i32] * 3 + [ptr], i32
        k7.argtypes, k7.restype = [ptr] * 3 + [i32] * 3 + [ptr, ptr], i32
        g2 = (2 * gout)[:, None, :]
        v = torch.empty_like(c)

        def scale():
            torch.mul(c, g2, out=v)
            return split(v.data_ptr(), None, rows.data_ptr(), rows_t.data_ptr(), L, M, B,
                         _stream(torch))

        def kernel7():
            return k7(lu.data_ptr(), rows_t.data_ptr(), da.data_ptr(), L, M, B,
                      scratch.data_ptr(), _stream(torch))
        if scale() != 0:
            raise RuntimeError("the scale pass failed")
        return {"k7": kernel7, "old": lambda: scale() or kernel7()}
    bound = 1e3 * max(4 * (L * M * (M + 1) // 2 + L * M * B + L * B + L * M * B)
                      / HBM_BYTES_PER_S, 3 * L * B * M * (M + 1) / TF32_TC_FLOP_PER_S)
    return launcher, controls, (lu, c, gout, da, scratch, rows, rows_t), bound


def trace_case(torch, dev, L, M, per_factor, seed):
    """Kernel 8's operands (K⁻¹ = W·Wᵀ/M + I, (M, M) or (L, M, M); Lu
    lower-triangular N(0, 1/M), (L, M, M)), its trace, P, tickets and
    scratch (enough for either tree's layout), a launcher per library (P
    kept, or with ``keep`` False P null: the forward without P), and the
    3xTF32 bound (K⁻¹ and Lu's lower triangle read, the trace and P's lower
    triangle written)."""
    mp = -(-M // TILE) * TILE
    nrt = mp // TILE
    pairs = nrt * (nrt + 1) // 2
    lk = L if per_factor else 1
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((L, M, M) if per_factor else (M, M), generator=g, device=dev)
    k_inv = w @ w.mT / M + torch.eye(M, device=dev)
    del w
    lu = torch.tril(torch.randn((L, M, M), generator=g, device=dev)) / M ** 0.5
    out = torch.empty((L,), device=dev)
    p = torch.empty((L, M, M), device=dev)
    tickets = torch.zeros((L + 2,), dtype=torch.int32, device=dev)
    scratch = torch.empty((L + 2 * lk) * mp * mp + L * M * -(-M // 32) * 32 + 2 * L * pairs,
                          device=dev)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def launcher(lib, keep=True):
        fn = lib.tri_kl_trace_f32
        fn.argtypes, fn.restype = [ptr] * 5 + [i32] * 4 + [ptr, ptr], i32
        return lambda: fn(k_inv.data_ptr(), lu.data_ptr(), out.data_ptr(),
                          p.data_ptr() if keep else None, tickets.data_ptr(), L, M, lk, L,
                          scratch.data_ptr(), _stream(torch))
    flops = M * (M + 1) * (2 * M + 1) // 3
    bound = 1e3 * max(4 * (lk * M * M + 2 * L * M * (M + 1) // 2 + L) / HBM_BYTES_PER_S,
                      3 * L * flops / TF32_TC_FLOP_PER_S)
    return launcher, (k_inv, lu, out, p, tickets, scratch), bound


def trace_bits(torch, fns, out, p):
    """{variant: {"trace": bool, "P": bool}}: each variant's trace and P's
    lower triangle against (a)'s (and, where built, the parent's), P handed
    NaN-filled memory first; the variants that make no P (the staging alone,
    no stores, the forward without P) compare their trace only where they
    make one."""
    lower = torch.ones(p.shape[1:], dtype=torch.bool, device=p.device).tril()
    got = {}
    for v, fn in fns.items():
        out.fill_(float("nan"))
        p.fill_(float("nan"))
        if fn() != 0:
            raise RuntimeError(f"launch failed ({v})")
        torch.cuda.synchronize()
        got[v] = (out.clone(), p[:, lower].clone())
    bits = {}
    for v, (t, pl) in got.items():
        bits[v] = {ref: {"trace": bool(torch.equal(t, got[ref][0])),
                         "P": bool(torch.equal(pl, got[ref][1]))}
                   for ref in ("a", "parent") if ref in got}
    return bits


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


def gram_case(torch, dev, L, N, M, D, seed, forward):
    """Kernel 3's backward operands (as chip_smoke.py makes them), k from
    ``forward`` (a library's ``rbf_gram_f32``), and a launcher per library."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.rand((max(N, M), D), generator=g, device=dev) * 4 - 2
    x, z = xs[:N].contiguous(), xs[:M].contiguous()
    sigma = torch.linspace(0.5, 2.0, L, device=dev) if L > 1 else torch.ones(1, device=dev)
    ell = torch.linspace(0.3, 3.0, L, device=dev) if L > 1 else torch.ones(1, device=dev)
    k = torch.empty((L, N, M), device=dev)
    fwd = forward.rbf_gram_f32
    fwd.argtypes, fwd.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p], ctypes.c_int
    if fwd(x.data_ptr(), z.data_ptr(), sigma.data_ptr(), ell.data_ptr(), k.data_ptr(), N, M,
           D, L, _stream(torch)) != 0:
        raise RuntimeError("rbf_gram_f32 failed")
    cot = torch.randn((L, N, M), generator=g, device=dev)
    outs = (torch.empty((N, D), device=dev), torch.empty((M, D), device=dev),
            torch.empty((2, L), device=dev))
    keep = []  # each library's scratch and counters

    def launcher(lib):
        floats = lib.rbf_gram_bwd_scratch
        floats.argtypes, floats.restype = [ctypes.c_int] * 4, ctypes.c_longlong
        ptrs = [torch.empty((max(int(floats(N, M, D, L)), 1),), device=dev)]
        if hasattr(lib, "rbf_gram_bwd_counters"):  # the one-launch design's counters
            count = lib.rbf_gram_bwd_counters
            count.argtypes, count.restype = [ctypes.c_int] * 4, ctypes.c_longlong
            ptrs.append(torch.zeros((int(count(N, M, D, L)),), dtype=torch.int32, device=dev))
        keep.append(ptrs)
        ints = (N, M, D, L) + ((0,) if len(ptrs) > 1 else ())  # g_transposed = 0
        fn = lib.rbf_gram_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * (9 + len(ptrs)) + [ctypes.c_int] * len(ints) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return lambda: fn(cot.data_ptr(), k.data_ptr(), x.data_ptr(), z.data_ptr(),
                          sigma.data_ptr(), ell.data_ptr(), *(t.data_ptr() for t in outs),
                          *(t.data_ptr() for t in ptrs), *ints, _stream(torch))
    return launcher, (x, z, k, cot, outs, keep), 1e3 * 8 * L * N * M / HBM_BYTES_PER_S


def vnngp_case(torch, dev, n, K, seed):
    """Kernel 5's backward operands (as chip_smoke.py makes them: kzz = aaᵀ
    + 3I, s = bbᵀ), every output asked for, and a launcher per library."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((n, K, K), generator=g, device=dev)
    b = torch.randn((n, K, K), generator=g, device=dev) * 0.3
    ins = (a @ a.mT + 3 * torch.eye(K, device=dev), b @ b.mT,
           torch.randn((n, K), generator=g, device=dev),
           torch.randn((n, K), generator=g, device=dev),
           torch.randn((n,), generator=g, device=dev), torch.randn((n,), generator=g, device=dev))
    outs = tuple(torch.empty_like(t) for t in ins[:4])

    def launcher(lib):
        fn = lib.block_conditional_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return lambda: fn(*(t.data_ptr() for t in ins + outs), n, K, 0.1, _stream(torch))
    bound = 1e3 * 4 * n * (2 * K * K + 2 * K + 2 + 2 * K * K + 2 * K) / HBM_BYTES_PER_S
    return launcher, (ins, outs), bound


# kernel 3's backward at the paths' shapes (L, N, M, D), as PERF.md names them
GRAM_SHAPES = {"VNNGP sweep Kxz": (10, 5000, 1000, 2), "VNNGP sweep Kzz": (10, 1000, 1000, 2),
               "VNNGP step Kxz": (1, 5000, 1000, 2), "VNNGP step Kzz": (1, 1000, 1000, 2),
               **{f"NSF sweep Kzz M={m}": (4, m, m, 2) for m in (100, 250, 500, 1000)},
               **{f"NSF sweep Kzx M={m}": (4, m, 800, 2) for m in (100, 250, 500, 1000)},
               "Hybrid Kzz": (4, 529, 529, 2), "Hybrid Kzx": (4, 529, 720, 2),
               "regression Kzz": (1, 500, 500, 1), "regression Kzx": (1, 500, 10000, 1)}
VNNGP_SHAPES = {"VNNGP sweep": (50000, 8), "VNNGP step": (5000, 8)}


def _occupancy(lib):
    fn = getattr(lib, "anatomy_occupancy", None)
    if fn is None:
        return None
    blocks = ctypes.c_int(0)
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    return blocks.value if fn(ctypes.byref(blocks)) == 0 else None


def _print_times(label, bound, times):
    print(f"[{label}] bound {bound:.4f} ms; " + "; ".join(
        f"({v}) {' '.join(f'{t:.4f}' for t in ts)}" for v, ts in times.items()), flush=True)


def main():
    global TURNS
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--against", default=None,
                        help="a tree whose sources, as they stand, are built beside the "
                             "variants as the variant 'parent' (the set scale)")
    parser.add_argument("--set", default="step1", choices=sorted(VARIANTS))
    parser.add_argument("--sources", default=None,
                        help="comma-separated sources of the set to take apart (default all)")
    parser.add_argument("--turns", type=int, default=TURNS)
    parser.add_argument("--out", default=None)
    opts = parser.parse_args()
    TURNS = opts.turns
    import time

    import torch

    if not torch.cuda.is_available():
        print("kernel_anatomy: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    tree = os.path.abspath(opts.tree)
    sources = (opts.sources.split(",") if opts.sources else list(VARIANTS[opts.set]))
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; tree {tree}",
          flush=True)
    libs, b = build(tree, opts.set, sources,
                    opts.against and os.path.abspath(opts.against))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keepc, dluc, dac = opts.set == "keepc", opts.set == "dluc", opts.set == "dac"
    scale, trace = opts.set == "scale", opts.set == "trace"
    record = {"device": smi, "tree": tree, "set": opts.set, "reps": REPS, "turns": TURNS,
              "sms": sms, "build": {}, "kernel7": {}, "mggp_bwd": {}, "gram_bwd": {},
              "vnngp_bwd": {}, "keepc": {}, "dluc": {}, "dac": {}, "scale": {}, "trace": {}}
    whole = keepc or dluc or dac or trace  # the sets that print several tri instances
    kernels = {"tri": ("" if trace else "tri_mma_kernel") if whole else TRI_KERNEL,
               "mggp": MGGP_KERNEL, "gram": "rbf_gram_bwd",
               "vnngp": "block_conditional_bwd_kernel"}
    printed = dict(PRINTED, **({"tri": KEEPC_INSTANCES} if keepc else {}),
                   **({"tri": DLUC_INSTANCES} if dluc else {}),
                   **({"tri": DAC_INSTANCES} if dac else {}),
                   **({"tri": TRACE_INSTANCES} if trace else {}))
    for (source, variant), (lib, log, path) in libs.items():
        if source == "empty":
            continue
        regs = ptxas(log, kernels[source])
        loops = (sass_loops(b, path, kernels[source])
                 if source == "mggp" or whole else {})
        record["build"][f"{source} {variant}"] = {"ptxas": regs, "sass": loops,
                                                  "blocks_per_sm": _occupancy(lib)}
        for inst, r in sorted(regs.items()):
            if not any(mark in inst for mark in printed.get(source, ("",))):
                continue  # the JSON line keeps every instance
            s = loops.get(inst, {})
            print(f"  [{source} {variant}] {inst}: {r.get('registers')} registers, "
                  f"{r.get('spills', '')}" + (
                      f"; SASS {s['total']} instructions, factor loop {s['loop']}, "
                      f"{s['ex2']} MUFU.EX2, {s['per_element']:.1f} an element"
                      if "loop" in s else "") + (
                      f"; SASS LDL {s['LDL']}, STL {s['STL']}, STG {s['STG']}"
                      if whole and s else ""), flush=True)
        if record["build"][f"{source} {variant}"]["blocks_per_sm"] is not None:
            print(f"  [{source} {variant}] the path instance's resident blocks an SM: "
                  f"{record['build'][f'{source} {variant}']['blocks_per_sm']}", flush=True)
    # a warm-up of ~10 s on the first source's (a)
    first = next(s for s in sources if (s, "a") in libs)
    if first == "tri" and dluc:
        make, _, keep, _ = dluc_case(torch, dev, *DLUC_SHAPES["north-star"], SEED)
        launch = make
    elif first == "tri" and dac:
        launch, _, keep, _ = dac_case(torch, dev, *DAC_SHAPES["MGGP"], SEED)
    elif first == "tri" and scale:
        launch, keep, _ = scale_case(torch, dev, *SCALE_SHAPES["MGGP"], SEED)
    elif first == "tri" and trace:
        launch, keep, _ = trace_case(torch, dev, *TRACE_SHAPES["north-star"], SEED)
    elif first == "tri":
        launch, keep, _ = tri_case(torch, dev, *TRI_SHAPES["MGGP"], SEED)
    elif first == "mggp":
        launch, keep, _ = mggp_case(torch, dev, *MGGP_SHAPES["MGGP Kzx"], SEED)
    elif first == "gram":
        launch, keep, _ = gram_case(torch, dev, *GRAM_SHAPES["VNNGP sweep Kxz"], SEED,
                                    libs["gram", "a"][0])
    else:
        launch, keep, _ = vnngp_case(torch, dev, *VNNGP_SHAPES["VNNGP sweep"], SEED)
    warm = launch(libs[first, "a"][0])
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 10:
        warm()
        torch.cuda.synchronize()
    del keep, warm
    torch.cuda.empty_cache()
    empty = libs["empty", ""][0].anatomy_empty
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    record["empty_node_ms"] = time_variants(torch, {"empty": lambda: empty(_stream(torch))})[
        "empty"]
    print(f"[an empty kernel node, {REPS} in a graph] "
          f"{' '.join(f'{t:.4f}' for t in record['empty_node_ms'])} ms", flush=True)
    if "tri" in sources and dluc:
        for i, (label, (L, M, B)) in enumerate(DLUC_SHAPES.items()):
            launch, controls, keep, bound = dluc_case(torch, dev, L, M, B, SEED + i)
            fns = {v: launch(libs[s, v][0]) for s, v in libs if s == "tri"}
            fns.update(controls(libs["tri", "a"][0]))
            bits = dluc_bits(torch, fns, keep[3])
            print(f"  {label}: the same bits as (a) and as the old route: {bits}", flush=True)
            times = time_variants(torch, fns)
            record["dluc"][label] = {"shape": [L, M, B], "bound_ms": bound, "ms": times,
                                     "bits": bits}
            _print_times(f"kernel 6 reading c, {label} L={L} M={M} B={B}", bound, times)
            del keep, fns
            torch.cuda.empty_cache()
    elif "tri" in sources and dac:
        for i, (label, (L, M, B)) in enumerate(DAC_SHAPES.items()):
            launch, controls, keep, bound = dac_case(torch, dev, L, M, B, SEED + i)
            fns = {v: launch(libs[s, v][0]) for s, v in libs if s == "tri"}
            fns.update(controls(libs["tri", "a"][0]))
            bits = dluc_bits(torch, fns, keep[3])
            print(f"  {label}: the same bits as (a) and as the old route: {bits}", flush=True)
            times = time_variants(torch, fns)
            record["dac"][label] = {"shape": [L, M, B], "bound_ms": bound, "ms": times,
                                    "bits": bits}
            _print_times(f"kernel 7 reading c, {label} L={L} M={M} B={B}", bound, times)
            del keep, fns
            torch.cuda.empty_cache()
    elif "tri" in sources and scale:
        for i, (label, (L, M, B)) in enumerate(SCALE_SHAPES.items()):
            launch, keep, bound = scale_case(torch, dev, L, M, B, SEED + i)
            fns = {v: launch(libs[s, v][0]) for s, v in libs if s == "tri"}
            rows, bits = keep[2], {}
            c, c2 = keep[0], torch.empty_like(keep[0])
            e2 = torch.empty(c.shape, dtype=torch.int32, device=dev)
            # the card's own rates for these bytes: rows written alone (a
            # fill), c copied (read once, written once), and c read once
            # and two arrays of its size written (frexp: the pass's read 1 :
            # write 2 mix)
            ceilings = {"fill": lambda: rows.fill_(0.0) is None,
                        "copy": lambda: c2.copy_(c) is None,
                        "mix": lambda: torch.frexp(c, out=(c2, e2)) is None}
            for v, fn in fns.items():
                rows.fill_(float("nan"))
                if fn() != 0:
                    raise RuntimeError("launch failed")
                torch.cuda.synchronize()
                bits[v] = rows.clone() if v == "a" else bool(torch.equal(rows, bits["a"]))
            bits["a"] = True
            print(f"  {label}: the same bits as (a): {bits}", flush=True)
            # the pass in the backward's chain: (a)'s pass or the parent's,
            # then kernels 6 and 7c from (a)'s library, interleaved turn by
            # turn with the passes alone, and 6 and 7c alone
            rest, chain_keep = scale_chain(torch, dev, c, keep[1], rows, L, M, B, SEED + i)
            after = rest(libs["tri", "a"][0])
            chains = {f"{v}+6+7c": (lambda fn=fns[v]: fn() or after())
                      for v in ("a", "parent") if v in fns}
            chains["6+7c"] = after
            times = time_variants(torch, {**fns, **ceilings, **chains})
            record["scale"][label] = {"shape": [L, M, B], "bound_ms": bound, "ms": times,
                                      "bits": bits}
            for v, nbytes in (("fill", 8 * L * M * -(-B // 32) * 32), ("copy", 8 * L * M * B),
                              ("mix", 12 * L * M * B)):
                print(f"  {v}: {nbytes / 1e9:.3f} GB at "
                      f"{nbytes / (statistics.median(times[v]) * 1e-3) / 1e12:.3f} TB/s", flush=True)
            del c, c2, e2, ceilings, chains, after, rest, chain_keep
            _print_times(f"the scale pass, rows only, {label} L={L} M={M} B={B}", bound, times)
            del keep, fns
            torch.cuda.empty_cache()
    elif "tri" in sources and trace:
        for i, (label, (L, M, per_factor)) in enumerate(TRACE_SHAPES.items()):
            launch, keep, bound = trace_case(torch, dev, L, M, per_factor, SEED + i)
            fns = {v: launch(libs[s, v][0]) for s, v in libs if s == "tri"}
            # the forward without P, from each tree's library as it stands
            fns["noP"] = launch(libs["tri", "a"][0], False)
            if ("tri", "parent") in libs:
                fns["parent noP"] = launch(libs["tri", "parent"][0], False)
            bits = trace_bits(torch, fns, keep[2], keep[3])
            print(f"  {label}: the same bits as (a) and the parent's (trace, P's lower "
                  f"triangle): {bits}", flush=True)
            times = time_variants(torch, fns)
            record["trace"][label] = {"shape": [L, M, per_factor], "bound_ms": bound,
                                      "ms": times, "bits": bits}
            _print_times(f"kernel 8 keeping P, {label} L={L} M={M} K⁻¹ "
                         f"{'per factor' if per_factor else 'shared'}", bound, times)
            del keep, fns
            torch.cuda.empty_cache()
    elif "tri" in sources and keepc:
        for i, (label, (L, M, B, per_factor)) in enumerate(KEEPC_SHAPES.items()):
            launch, keep, bound = keepc_case(torch, dev, L, M, B, per_factor, SEED + i)
            fns = {v: launch(libs[s, v][0], True) for s, v in libs if s == "tri"}
            fns["c0"] = launch(libs["tri", "a"][0], False)
            bits = keepc_bits(torch, fns, keep[2], keep[3])
            print(f"  {label}: the same bits as (a): {bits}", flush=True)
            times = time_variants(torch, fns)
            record["keepc"][label] = {"shape": [L, M, B], "per_factor": per_factor,
                                      "bound_ms": bound, "ms": times, "bits": bits}
            _print_times(f"kernel 1 keeping c, {label} L={L} M={M} B={B}", bound, times)
            del keep, fns
            torch.cuda.empty_cache()
    elif "tri" in sources:
        for i, (label, (L, M, B)) in enumerate(TRI_SHAPES.items()):
            launch, keep, bound = tri_case(torch, dev, L, M, B, SEED + i)
            times = time_variants(torch, {v: launch(libs[s, v][0]) for s, v in libs
                                          if s == "tri"})
            record["kernel7"][label] = {"shape": [L, M, B], "bound_ms": bound, "ms": times}
            _print_times(f"kernel 7 {label} L={L} M={M} B={B}", bound, times)
            del keep
            torch.cuda.empty_cache()
    if "mggp" in sources:
        for i, (label, (L, N, M, kzz, wants)) in enumerate(MGGP_SHAPES.items()):
            launch, outs, bound = mggp_case(torch, dev, L, N, M, kzz, wants, SEED + i)
            variants = [v for s, v in libs if s == "mggp"]
            # bits of (r) against (a): both write into their own buffers
            bits = {}
            if "r" in variants and "a" in variants:
                got = {}
                for v in ("a", "r"):
                    mine = {k: None if t is None else torch.empty_like(t)
                            for k, t in outs.items()}
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
            _print_times(f"kernel 4 backward {label} L={L} N={N} M={M} dd2/dg2/sums {wants}",
                         bound, times)
            print(f"  __frcp_rn bits equal to 1.f/den: {bits}", flush=True)
            del outs
            torch.cuda.empty_cache()
        record["kernel2_call"] = kernel2_call(torch, dev)
        print("[kernel 2's call, Hybrid-NSF (4, 529, 720), ms] " + "; ".join(
            f"{k} {v:.4f}" for k, v in record["kernel2_call"].items()), flush=True)
    if "gram" in sources:
        for i, (label, (L, N, M, D)) in enumerate(GRAM_SHAPES.items()):
            launch, keep, bound = gram_case(torch, dev, L, N, M, D, SEED + i,
                                            libs["gram", "a"][0])
            times = time_variants(torch, {v: launch(libs[s, v][0]) for s, v in libs
                                          if s == "gram"})
            record["gram_bwd"][label] = {"shape": [L, N, M, D], "bound_ms": bound, "ms": times}
            _print_times(f"kernel 3 backward {label} L={L} N={N} M={M} D={D}", bound, times)
            del keep
            torch.cuda.empty_cache()
    if "vnngp" in sources:
        for i, (label, (n, K)) in enumerate(VNNGP_SHAPES.items()):
            launch, keep, bound = vnngp_case(torch, dev, n, K, SEED + i)
            times = time_variants(torch, {v: launch(libs[s, v][0]) for s, v in libs
                                          if s == "vnngp"})
            per_sm = record["build"].get("vnngp a", {}).get("blocks_per_sm")
            blocks = -(-n // 32)
            record["vnngp_bwd"][label] = {"shape": [n, K], "bound_ms": bound, "ms": times,
                                          "blocks": blocks, "waves": (
                                              blocks / (per_sm * sms) if per_sm else None)}
            _print_times(f"kernel 5 backward {label} n={n} K={K}", bound, times)
            if per_sm:
                print(f"  {blocks} one-warp blocks, {per_sm} an SM: "
                      f"{blocks / (per_sm * sms):.2f} waves", flush=True)
            del keep
            torch.cuda.empty_cache()
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(record, fh)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
