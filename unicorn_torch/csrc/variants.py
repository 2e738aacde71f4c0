"""Time breakdowns of seven kernels on the card, from edited copies of their
sources.

    python3 -m unicorn_torch.csrc.variants [--csrc DIR] [bwd_i] [bwd_j]
        [fwd_lse] [correlation] [dw7x7] [msda] [convnext_block]
    python3 -m unicorn_torch.csrc.variants --sass dwconv7x7 msda convnext_block
    python3 -m unicorn_torch.csrc.variants --same DIR

--same builds dwconv7x7_nhwc from DIR (another checkout's csrc/, e.g. a
parent) and from this one and runs both on the same inputs: the seven
shapes of a frame at B = 1 and 4, bf16 and fp32, taps drawn in fp32. It
prints, per case, the outputs where the two differ and where this one
differs from the plain version (cuDNN, TF32 off).

--sass prints the instruction mix of each named source's kernels as built
(cuobjdump): the most frequent opcodes and the FFMA share of the main loop.

Builds the copies, one nvcc each in parallel, and times each twice with
CUDA-graph replays, in a process of its own. The cut copies give wrong results;
their times bound what each part costs. Each copy's registers and spills
come from `nvcc -Xptxas -v`. `--csrc DIR` takes the sources (and headers)
from another checkout's csrc/ directory, e.g. an unpacked parent commit, so
that one call splits both designs; the C interfaces must be the same.

bwd_i (csrc/correlation_train.cu) at (B, N, C, K) = (2, 16000, 128, 1):
    as_built   the source as it is (checked against the plain version)
    no_scores  the score product cut to 4 of its C channels
    no_de0     the dE0 product cut to 4 of the 64 target rows of a half
    rest       both cut: the softmax, dS, dV, loads and barriers
    score_u2   the score loop unrolled by 2 (built: 1)
    de0_u1     the dE0 loop unrolled by 1 (built: 2)
    no_loads   the ring filled once, then reused without loads

bwd_j (the same file, the same shape):
    as_built, no_scores, rest, no_loads as for bwd_i
    no_de1     the dE1 product cut to 4 of the 64 source rows of a half

fwd_lse (the same file, the same shape):
    as_built, no_scores, no_loads, score_u2 as above
    no_softmax the online softmax and P . v cut: the scores are only summed

The score and dS products are helpers that the three training kernels
share, so a copy cut there is cut in all three; each copy times one.

correlation (csrc/correlation.cu, bf16 dots) at (1, 16000, 128, 1):
    as_built   the source as it is (checked against the plain version)
    no_loads   the ring filled by TMA once, then reused without loads
    no_softmax the softmax cut: the products and the ring alone
    no_mma     the products cut: the softmax and the ring alone

dw7x7 (csrc/dwconv7x7.cu), bf16, B = 1, at each of the seven shapes of an
800x1280 frame (ops/dwconv7x7.py PATH_SHAPES), and their sum over the 27
launches of a frame:
    as_built   the source as it is (checked against the plain version)
    no_loads   the ring's first two groups of rows loaded, then reused
               (first design: the tile filled from registers, no loads)
    no_unpack  no bf16 -> fp32 shifts: the words taken as fp32 (inputs, and
               the taps the compiler keeps packed)
    no_fma     the sum cut to one tap

convnext_block (csrc/convnext_block.cu), bf16, erf GELU, B = 1, at each of
the seven shapes of a frame on the route its plan picks, and their sum over
the 27 calls of a frame:
    as_built    the source as it is (checked against the plain version)
    no_ln       the A tile left as it is: no LayerNorm prologue
    no_gelu     the GELU cut to the identity (b1 still added)
    no_product2 the second product's wgmmas cut (its pieces still loaded)
    no_loads    the ring filled by TMA once, then reused without loads
    no_s        the first product's wgmmas cut
    no_epilogue the second product's epilogue (and its stores) cut
    ln_only     the first product's kernel ends after its LayerNorm
    one_chunk   each block of the first product walks one hidden chunk
The four-launch design before it (--csrc on an older checkout) splits as
as_built, no_ln (the LayerNorm launch cut), no_gelu, no_product2 (the
second product's launch cut).

msda (csrc/msda.cu), factored mode, at the served shape (1, 2, 50, 80, 8,
32, 8000, 4) in bf16 and in fp32:
    as_built          the source as it is (checked against the plain version)
    no_weights        fixed weights and no location arithmetic: the four
                      cells around the query's own cell, a quarter each
    no_gather         every corner read from one fixed cell
    one_thread_per_qm one thread walks all channel vectors of a (b, q, m)
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from . import build

SCORES = "void score_tile("
SCORE_LOOP = "#pragma unroll 1\n  for (int c = 0; c < C; c += 4) {"
DS_PRODUCT = "void ds_product("
DS_LOOP = "#pragma unroll 2\n  for (int j = 0; j < TH; j += 4) {"
LOAD_HALF = "  auto load_half = [&](int h) {\n"
FWD_SOFTMAX = "      float tmax = NEG;\n"
TMA_TILE = """        mbar_expect_tx(&full[s], L::E0_BYTES + K * BIT * 4);
        for (int ch = 0; ch < NCH; ++ch)"""
SOFTMAX = """    const int s = t % STAGES;
    const int valid = N - t * BIT - cq;  // columns of mine that exist"""
MMA = """      wgmma_m64n128k16(d, a_desc"""


def _edit(src: str, *subs) -> str:
    """src with each (anchor, old, new): the first `old` after `anchor`
    replaced by `new`."""
    for anchor, old, new in subs:
        head, body = src.split(anchor, 1)
        assert old in body, f"moved: {old[:60]!r}"
        src = head + anchor + body.replace(old, new, 1)
    return src


CUT_SCORES = (SCORES, SCORE_LOOP, SCORE_LOOP.replace("c < C", "c < 4"))
CUT_DS = (DS_PRODUCT, DS_LOOP, DS_LOOP.replace("j < TH", "j < 4"))


def _no_loads(kernel: str):
    return (kernel, LOAD_HALF, LOAD_HALF + "    if (h >= 2) return;\n")


def _bwd_i_variants(src: str) -> dict[str, str]:
    return {"as_built": src, "no_scores": _edit(src, CUT_SCORES),
            "no_de0": _edit(src, CUT_DS),
            "rest": _edit(src, CUT_SCORES, CUT_DS),
            "score_u2": _edit(src, (SCORES, SCORE_LOOP, SCORE_LOOP.replace(
                "unroll 1", "unroll 2"))),
            "de0_u1": _edit(src, (DS_PRODUCT, DS_LOOP, DS_LOOP.replace(
                "unroll 2", "unroll 1"))),
            "no_loads": _edit(src, _no_loads("bwd_i_kernel(const float*"))}


def _bwd_j_variants(src: str) -> dict[str, str]:
    return {"as_built": src, "no_scores": _edit(src, CUT_SCORES),
            "no_de1": _edit(src, CUT_DS),
            "rest": _edit(src, CUT_SCORES, CUT_DS),
            "no_loads": _edit(src, _no_loads("bwd_j_kernel(const float*"))}


def _fwd_lse_variants(src: str) -> dict[str, str]:
    a = "fwd_lse_kernel(const float*"
    no_softmax = (a, FWD_SOFTMAX, "      if (N > 0) {\n#pragma unroll\n        "
                  "for (int q = 0; q < RQ; ++q) acc[r] += p[r][q];\n        "
                  "continue;\n      }\n" + FWD_SOFTMAX)
    return {"as_built": src, "no_scores": _edit(src, CUT_SCORES),
            "no_softmax": _edit(src, no_softmax),
            "no_loads": _edit(src, _no_loads(a)),
            "score_u2": _edit(src, (SCORES, SCORE_LOOP, SCORE_LOOP.replace(
                "unroll 1", "unroll 2")))}


def _correlation_variants(src: str) -> dict[str, str]:
    a = "corr_tc_kernel(const __grid_constant__"
    no_loads = (TMA_TILE, "        if (t >= STAGES) { mbar_arrive(&full[s]);"
                " continue; }\n" + TMA_TILE)
    no_softmax = (SOFTMAX, SOFTMAX + "\n    if (N > 0) { __syncwarp(); if "
                  "(lane == 0) mbar_arrive(&empty[s]); return; }")
    no_mma = (MMA, "      if (N < 0) " + MMA.lstrip())
    return {"as_built": src, "no_loads": _edit(src, (a, *no_loads)),
            "no_softmax": _edit(src, (a, *no_softmax)),
            "no_mma": _edit(src, (a, *no_mma))}


DW_KERNEL = "dw7x7_nhwc_kernel(const T*"
DW_LOAD = "  auto load_group = [&](int i0, int h) {\n"
DW_NO_LOADS = (DW_KERNEL, DW_LOAD,
               DW_LOAD + "    if (i0 >= 2 * GROUP) { cp_commit(); return; }\n")
DW_NO_UNPACK = ("struct Two<__nv_bfloat16> {",
                "v[0] = __uint_as_float(w << 16);\n"
                "    v[1] = __uint_as_float(w & 0xffff0000u);",
                "v[0] = __uint_as_float(w);\n    v[1] = __uint_as_float(w);")
DW_NO_FMA = ((DW_KERNEL, "for (int dy = 0; dy < KS; ++dy) {\n          const int s",
              "for (int dy = 0; dy < 1; ++dy) {\n          const int s"),
             ("input row i feeds", "for (int dx = 0; dx < KS; ++dx)",
              "for (int dx = 0; dx < 1; ++dx)"))
MS_KERNEL = "msda_kernel(const T*"
MS_SLOT = "    const int slot = lp * istr + it;\n"
MS_NO_WEIGHTS = ((MS_KERNEL, MS_SLOT, MS_SLOT + """\
    if (N_FIXED) {
      const int c0 = (int)(((g0 + it) / M) % Lq) % (H * W);
      const int cl = (l * H + min(c0 / W, H - 2)) * W + min(c0 % W, W - 2);
      cells[slot] = make_int4(cl, cl + 1, cl + W, cl + W + 1);
      wts[slot] = make_float4(0.25f, 0.25f, 0.25f, 0.25f);
      continue;
    }
"""),)
MS_NO_GATHER = ((MS_KERNEL, "const int4 c = cells[(lp0 + j) * istr + it];",
                 "const int4 c = make_int4(0, 0, 0, 0);"),)
MS_ONE_THREAD = (("int launch(", "const int tpi = dv < THREADS ? dv : THREADS;",
                  "const int tpi = 1;"),)


# dw7x7 and msda in their first designs (one tile per block; one thread per
# channel vector), so that an older checkout splits the same way
DW_OLD = "tile[SH][SW][CV]"
DW_OLD_LOAD = ("dw7x7_nhwc_kernel(const T*", "      q = __ldg(",
               "      q = make_uint4(gx, gy, gcv, 0x3f803f80u); (void)(")
DW_OLD_UNPACK = ("dw7x7_nhwc_kernel(const T*",
                 "Vec<T>::unpack(tile[r0 + i][col + dx][cv], v);",
                 "{ const uint4 q_ = tile[r0 + i][col + dx][cv];\n"
                 "        const uint32_t w_[4] = {q_.x, q_.y, q_.z, q_.w};\n"
                 "        for (int k = 0; k < V; ++k) v[k] = "
                 "__uint_as_float(w_[k % 4]); }")
DW_OLD_FMA = (("dw7x7_nhwc_kernel(const T*", "for (int dx = 0; dx < KS; ++dx)",
               "for (int dx = 0; dx < 1; ++dx)"),
              ("dw7x7_nhwc_kernel(const T*", "if (dy >= 0 && dy < KS)",
               "if (dy == 0)"))


def _dw7x7_variants(src: str) -> dict[str, str]:
    if DW_OLD in src:
        return {"as_built": src, "no_loads": _edit(src, DW_OLD_LOAD),
                "no_unpack": _edit(src, DW_OLD_UNPACK),
                "no_fma": _edit(src, *DW_OLD_FMA)}
    return {"as_built": src, "no_loads": _edit(src, DW_NO_LOADS),
            "no_unpack": _edit(src, DW_NO_UNPACK),
            "no_fma": _edit(src, *DW_NO_FMA)}


MS_OLD = "one thread per (b, q, m, channel vector)"
MS_OLD_P = "    for (int p = 0; p < P; ++p) {\n"
MS_OLD_NO_WEIGHTS = ("msda_kernel(const T*", MS_OLD_P, MS_OLD_P + """\
      if (N_FIXED) {
        const int c0 = (int)((g / M) % Lq) % (H * W);
        const int cy = min(c0 / W, H - 2), cx = min(c0 % W, W - 2);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          float val[V];
          Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
              vb + ((long long)(cy + k4 / 2) * W + cx + k4 % 2) * cell)), val);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(0.25f, val[k], acc[k]);
        }
        continue;
      }
""")
MS_OLD_NO_GATHER = ("msda_kernel(const T*",
                    "vb + ((long long)(iy + dy) * W + (ix + dx)) * cell)", "vb)")
MS_OLD_ONE_THREAD = (
    ("msda_kernel(const T*", "const int v = (int)(idx % dv);\n"
     "  const long long g = idx / dv;",
     "const long long g = idx;\n  for (int v = 0; v < dv; ++v) {"),
    ("msda_kernel(const T*", "  *reinterpret_cast<uint4*>(out + idx * V) = "
     "Vec<T>::pack(acc);\n",
     "  *reinterpret_cast<uint4*>(out + (g * dv + v) * V) = "
     "Vec<T>::pack(acc);\n  }\n"),
    ("int launch(", "const long long total = (long long)B * Lq * M * "
     "(D / Vec<T>::N);", "const long long total = (long long)B * Lq * M;"))


def _msda_variants(src: str) -> dict[str, str]:
    fixed = "#define N_FIXED 1\n"
    if MS_OLD in src:
        return {"as_built": src,
                "no_weights": fixed + _edit(src, MS_OLD_NO_WEIGHTS),
                "no_gather": _edit(src, MS_OLD_NO_GATHER),
                "one_thread_per_qm": _edit(src, *MS_OLD_ONE_THREAD)}
    return {"as_built": src,
            "no_weights": fixed + _edit(src, *MS_NO_WEIGHTS),
            "no_gather": _edit(src, *MS_NO_GATHER),
            "one_thread_per_qm": _edit(src, *MS_ONE_THREAD)}


# convnext_block (csrc/convnext_block.cu): the redesign (plan, mlp_kernel,
# p2_kernel) and the four-launch design before it
CB_GELU = "__device__ __forceinline__ float gelu(float x) {\n"
CB_NO_GELU = ("template <bool EXACT>\n", CB_GELU,
              CB_GELU + "  if (x == x) return x;\n")
CB_NO_LN = ("mlp_kernel(const __grid_constant__",
            "  ln_tile<M, NV, R>(sums, ln_s, ln_b, As, m0, P, C, eps, tid / 32, "
            "lane);\n", "")
CB_NO_P2 = (("mlp_kernel(const __grid_constant__",
             "          wgmma_m64n64k16_rs<32 * I>(",
             "          if (C < 0) wgmma_m64n64k16_rs<32 * I>("),
            ("mlp_kernel(const __grid_constant__",
             "          wgmma_m64n32k16_rs<32 * (NJ / 2)>(",
             "          if (C < 0) wgmma_m64n32k16_rs<32 * (NJ / 2)>("),
            ("p2_kernel(const __grid_constant__",
             "          wgmma_m64n64k16_ss<32 * I>(Y,",
             "          if (C < 0) wgmma_m64n64k16_ss<32 * I>(Y,"))
CB_PUT = "        const int s = t % stages;\n        mbar_wait(&empty[s]"
CB_P2_PUT = "        mbar_expect_tx(&full[s], STAGE);\n"
CB_NO_LOADS = (("mlp_kernel(const __grid_constant__", CB_PUT,
                "        if (t >= stages) { mbar_wait(&empty[t % stages], "
                "((t / stages) & 1) ^ 1); mbar_arrive(&full[t % stages]); ++t;"
                " return; }\n" + CB_PUT),
               ("p2_kernel(const __grid_constant__", CB_P2_PUT,
                "        if (p >= stages) { mbar_arrive(&full[s]); continue; }"
                "\n" + CB_P2_PUT))
CB_MLP = "mlp_kernel(const __grid_constant__"
CB_NO_S = ((CB_MLP, "        wgmma_m64n64k16_ss<0>(S,",
            "        if (C < 0) wgmma_m64n64k16_ss<0>(S,"),)
CB_NO_EPI = ((CB_MLP, "    residual_epilogue<NJ>(Y, Xs",
              "    if (C < 0) residual_epilogue<NJ>(Y, Xs"),
             ("p2_kernel(const __grid_constant__", "  residual_epilogue<2 * NB>(Y,",
              "  if (C < 0) residual_epilogue<2 * NB>(Y,"))
CB_LN_ONLY = ((CB_MLP, "    if (tid == CONS * WG) {", "    if (tid == CONS * WG && C < 0) {"),
              (CB_MLP, "  wg_sync(1 + wg);\n", "  wg_sync(1 + wg);\n  if (C > 0) return;\n"))
CB_ONE_CHUNK = ((CB_MLP, "  const int j1 = min(nch, j0 + chunks);",
                 "  const int j1 = min(nch, j0 + 1);"),)
CB_OLD = "layernorm_kernel<T><<<"
CB_OLD_NO_LN = ("int launch_dw_ln(", "  layernorm_kernel<T><<<",
                "  if (C < 0) layernorm_kernel<T><<<")
CB_OLD_NO_P2 = ("int launch_products(", "    return launch_product_bf16<1, EXACT>(",
                "    if (C > 0) return 0;\n    return launch_product_bf16<1, EXACT>(")


def _convnext_block_variants(src: str) -> dict[str, str]:
    if CB_OLD in src:
        return {"as_built": src, "no_ln": _edit(src, CB_OLD_NO_LN),
                "no_gelu": _edit(src, CB_NO_GELU),
                "no_product2": _edit(src, CB_OLD_NO_P2)}
    return {"as_built": src, "no_ln": _edit(src, CB_NO_LN),
            "no_gelu": _edit(src, CB_NO_GELU),
            "no_product2": _edit(src, *CB_NO_P2),
            "no_loads": _edit(src, *CB_NO_LOADS),
            "no_s": _edit(src, *CB_NO_S),
            "no_epilogue": _edit(src, *CB_NO_EPI),
            "ln_only": _edit(src, *CB_LN_ONLY),
            "one_chunk": _edit(src, *CB_ONE_CHUNK)}


def _inline_headers(src: str, csrc: str, names) -> str:
    """src with each `#include "<name>"` replaced by that header of csrc,
    so that edits reach a kernel kept in a header."""
    for name in names:
        path = os.path.join(csrc, name)
        mark = f'#include "{name}"'
        if mark in src and os.path.exists(path):
            line = next(x for x in src.splitlines() if x.startswith(mark))
            with open(path) as f:
                src = src.replace(line, f.read())
    return src


def _compile(args):
    name, text, tmp, fn_mark, csrc = args
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(tmp, f"{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           csrc, "-o", so, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    info = next((" ".join(x.strip() for x in lines[i + 1:i + 3])
                 for i, x in enumerate(lines)
                 if "Compiling" in x and fn_mark in x), "")
    return name, so, info


def _graph_ms(fn, iters=3, reps=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _setup_dw7x7(g, stream, ptr, i32):
    import torch

    from ..ops import dwconv7x7 as dw

    inputs = []
    for (H, W, C), n in dw.PATH_SHAPES:
        x = torch.randn(1, H, W, C, device="cuda", generator=g).bfloat16()
        k = (0.1 * torch.randn(7, 7, C, device="cuda", generator=g)).bfloat16()
        b = (0.1 * torch.randn(C, device="cuda", generator=g)).bfloat16()
        inputs.append((f"{H}x{W}x{C}", n, (x, k, b, torch.empty_like(x)),
                       dw.dwconv7x7_plain(x, k, b)))

    def make(fn):
        return [(label, n, (lambda a=args: fn(
            *(t.data_ptr() for t in a), *a[0].shape, 1, stream())),
            args[3], ref, 2.0 ** -6) for label, n, args, ref in inputs]
    return ("dwconv7x7.cu", _dw7x7_variants, "dw7x7_nhwc_kernelI13__nv_bf",
            "dwconv7x7_nhwc", [ptr] * 4 + [i32] * 5 + [ptr], make)


def _setup_msda(g, stream, ptr, i32):
    import torch

    from ..ops import deform_attn as da

    B, L, H, W, M, D, Lq, P = 1, 2, 50, 80, 8, 32, 8000, 4
    ys = (torch.arange(H, device="cuda") + 0.5) / H
    xs = (torch.arange(W, device="cuda") + 0.5) / W
    ref_pts = torch.stack([xs[None].expand(H, W), ys[:, None].expand(H, W)],
                          -1).reshape(H * W, 2).repeat(L, 1)
    off = 3.0 * torch.randn(B, Lq, M, L, P, 2, device="cuda", generator=g)
    locs = (ref_pts[None, :, None, None, None] + off / torch.tensor(
        [W, H], device="cuda")).contiguous()
    attw = torch.softmax(torch.randn(B, Lq, M, L * P, device="cuda",
                                     generator=g), -1).reshape(B, Lq, M, L, P)
    value = torch.randn(B, L, H, W, M, D, device="cuda", generator=g)
    inputs = []
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        v, a = value.to(dt), attw.to(dt)
        out = torch.empty((B, Lq, M * D), dtype=dt, device="cuda")
        inputs.append((str(dt)[6:], code, (v, locs, a, out),
                       da.ms_deform_attn_plain(v, locs, a, "factored")))

    def make(fn):
        return [(label, 1, (lambda a=args, c=code: fn(
            *(t.data_ptr() for t in a), B, L, H, W, M, D, Lq, P, c, c, 0,
            stream())), args[3], ref, 2.0 ** -6)
            for label, code, args, ref in inputs]
    return ("msda.cu", _msda_variants, "msda_kernelI13__nv_bfloat16Li0E",
            "msda_forward", [ptr] * 4 + [i32] * 11 + [ptr], make)


def _setup_convnext_block(g, stream, ptr, i32, csrc):
    import torch

    from ..ops import convnext_block as cb
    from ..ops import dwconv7x7 as dw

    old = CB_OLD in open(os.path.join(csrc, "convnext_block.cu")).read()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    inputs = []
    for (H, W, C), n in dw.PATH_SHAPES:
        x = torch.randn(1, H, W, C, device="cuda", generator=g).bfloat16()
        p = {"dwconv": {"weight": 0.1 * torch.randn(C, 1, 7, 7, device="cuda",
                                                    generator=g),
                        "bias": 0.1 * torch.randn(C, device="cuda", generator=g)},
             "norm": {"weight": 1 + 0.1 * torch.randn(C, device="cuda",
                                                      generator=g),
                      "bias": 0.1 * torch.randn(C, device="cuda", generator=g)},
             "pwconv1": {"weight": C ** -0.5 * torch.randn(
                 4 * C, C, device="cuda", generator=g),
                 "bias": 0.1 * torch.randn(4 * C, device="cuda", generator=g)},
             "pwconv2": {"weight": (4 * C) ** -0.5 * torch.randn(
                 C, 4 * C, device="cuda", generator=g),
                 "bias": 0.1 * torch.randn(C, device="cuda", generator=g)},
             "gamma": 0.5 + 0.1 * torch.randn(C, device="cuda", generator=g)}
        prepared = cb.prepare(x, p)
        y = torch.empty_like(x)
        sums = torch.empty(x.shape, device="cuda", dtype=torch.float32)
        hid = torch.empty(1, H, W, 4 * C, device="cuda", dtype=x.dtype)
        if old:       # scratch acc, yn, h; no plan
            args = (x, *prepared, sums, torch.empty_like(x), hid, y)
            extra = ()
        else:
            pl = cb.plan(1, H, W, C, x.dtype, n_sm)
            args = (x, *prepared, sums, hid, y)
            extra = ((ctypes.c_int * len(cb.PLAN_KEYS))(*pl["ints"]),)
        inputs.append((f"{H}x{W}x{C}", n, args, extra,
                       cb.convnext_block_plain(x, p, True)))

    def make(fn):
        return [(label, n, (lambda a=args, e=extra: fn(
            *(t.data_ptr() for t in a), *a[0].shape, 1, 1, 1e-6, *e,
            stream())), args[-1], ref, 2.0 ** -6)
            for label, n, args, extra, ref in inputs]
    n_ptr = 14 if old else 13
    return ("convnext_block.cu", _convnext_block_variants,
            "mlp_kernelILi2ELi3ELb1E" if not old else "product_bf16_kernelILi1ELb1E",
            "convnext_block_forward",
            [ptr] * n_ptr + [i32] * 6 + [ctypes.c_float]
            + ([] if old else [ptr]) + [ptr], make)


def _setup(kernel, csrc=build.CSRC):
    """(source file, variants, ptxas mark, C function name, its argument
    types, make(fn) -> [(label, launches a frame, call, result, reference,
    relative tolerance of the source as built)])."""
    import torch

    from ..ops import correlation_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(5)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if kernel == "dw7x7":
        return _setup_dw7x7(g, stream, ptr, i32)
    if kernel == "msda":
        return _setup_msda(g, stream, ptr, i32)
    if kernel == "convnext_block":
        return _setup_convnext_block(g, stream, ptr, i32, csrc)
    if kernel in ("bwd_i", "bwd_j", "fwd_lse"):
        B, N, C, K = 2, 16000, 128, 1
        e0, e1 = (0.3 * torch.randn(B, N, C, device="cuda", generator=g)
                  for _ in range(2))
        v = torch.rand(B, K, N, device="cuda", generator=g)
        dout = torch.randn(B, K, N, device="cuda", generator=g)
        out, lse = ck.correlation_fwd_lse_plain(e0, e1, v)
        c = (out * dout).sum(1, keepdim=True)
        if kernel == "fwd_lse":
            res, ref = torch.empty_like(out), out
            args = (e0, e1, v, res, torch.empty_like(lse))
            variants_of, mark = _fwd_lse_variants, "fwd_lse_kernelILi1EE"
        elif kernel == "bwd_i":
            ref, _ = ck.correlation_bwd_i_plain(e0, e1, v, lse, dout, c)
            res = torch.empty_like(e0)
            args = (e0, e1, v, lse, dout, c, res, torch.empty_like(v))
            variants_of, mark = _bwd_i_variants, "bwd_i_kernelILi1ELi2E"
        else:
            ref = ck.correlation_bwd_j_plain(e0, e1, v, lse, dout, c)
            res = torch.empty_like(e1)
            args = (e0, e1, v, lse, dout, c, res)
            variants_of, mark = _bwd_j_variants, "bwd_j_kernelILi1ELi2E"

        def make(fn):     # args are kept alive by this closure
            return [("", 1, lambda: fn(*(t.data_ptr() for t in args), B, N,
                                       C, K, stream()), res, ref, 1e-4)]
        return ("correlation_train.cu", variants_of, mark,
                f"correlation_{kernel}", [ptr] * len(args) + [i32] * 4 + [ptr],
                make)
    B, N, C, K = 1, 16000, 128, 1
    e0, e1 = (0.3 * torch.randn(B, N, C, device="cuda", generator=g)
              for _ in range(2))
    v = torch.rand(B, K, N, device="cuda", generator=g)
    ref = ck.correlation_propagate_plain(e0, e1, v, bf16_dots=True)
    out = torch.empty_like(ref)
    ws = torch.empty(ck._lib().correlation_workspace_bytes(B, N, C, K, 1),
                     dtype=torch.uint8, device="cuda")
    args = (e0, e1, v, out, ws)

    def make(fn):
        return [("", 1, lambda: fn(*(t.data_ptr() for t in args), B, N, C, K,
                                   1, stream()), out, ref, 1e-4)]
    return ("correlation.cu", _correlation_variants,
            "corr_tc_kernelILi2ELi1E", "correlation_forward",
            [ptr] * 5 + [i32] * 5 + [ptr], make)


def time_one(kernel: str, name: str, so: str, csrc: str = build.CSRC) -> None:
    """Check and time one built copy (in a process of its own, so that a
    cut copy that faults takes no other copy's numbers with it). A kernel
    with several cases prints each and, where launches a frame are given,
    their sum over a frame."""
    import torch

    _, _, _, cname, argtypes, make = _setup(kernel, csrc)
    fn = getattr(ctypes.CDLL(so), cname)
    fn.argtypes = argtypes
    cases = make(fn)
    frame = [0.0, 0.0]
    for label, n, call, res, ref, tol in cases:
        if call():
            raise RuntimeError(f"{kernel} {name} {label}: launch failed")
        torch.cuda.synchronize()
        rel = ((res.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        if name == "as_built" and rel > tol:
            raise AssertionError(f"{label}: the source as built disagrees "
                                 "with plain")
        ts = [_graph_ms(call) for _ in range(2)]
        frame = [f + n * t for f, t in zip(frame, ts)]
        print(f"{kernel} {name:12s} {label:12s} vs plain {rel:.1e}  "
              + " ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
    if len(cases) > 1 and kernel in ("dw7x7", "convnext_block"):
        print(f"{kernel} {name:12s} {'per frame':12s} "
              + " ".join(f"{t:.4f}" for t in frame) + " ms", flush=True)


def run(kernel: str, csrc: str = build.CSRC) -> None:
    fname, variants_of, mark, *_ = _setup(kernel, csrc)
    with open(os.path.join(csrc, fname)) as f:
        variants = variants_of(_inline_headers(f.read(), csrc,
                                               ["dw7x7_strip.cuh"]))
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{kernel}_variants_", dir=build.BUILD_DIR)
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(_compile, [(n, t, tmp, mark, csrc) for n, t in
                                       variants.items()]))
    print(f"{kernel}: sources from {os.path.relpath(csrc)}", flush=True)
    for name, so, info in built:
        print(f"{kernel} {name:12s} {info}", flush=True)
    for name, so, _ in built:
        proc = subprocess.run([sys.executable, "-m",
                               "unicorn_torch.csrc.variants", "--time",
                               kernel, name, so, csrc], capture_output=True,
                              text=True)
        print(proc.stdout.strip() or
              f"{kernel} {name:12s} failed: {proc.stderr.strip()[-300:]}",
              flush=True)


def sass(name: str) -> None:
    """The instruction mix of each kernel of csrc/<name>.cu as built: static
    counts of the most frequent opcodes of each function, and the share of
    FFMAs between its first and last FFMA (the unrolled main loop)."""
    import collections
    import re

    lib = build._compile(name)
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        ops = [m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn)]
        ffma = [i for i, op in enumerate(ops) if op == "FFMA"]
        loop = ops[ffma[0]:ffma[-1] + 1] if ffma else []
        top = collections.Counter(ops).most_common(8)
        print(f"{name} {fn.splitlines()[0][:100]}\n  {len(ops)} instructions, "
              + ", ".join(f"{op} {n}" for op, n in top)
              + (f"; main loop {len(loop)}, FFMA {len(ffma)} "
                 f"({len(ffma) / len(loop):.0%})" if loop else ""), flush=True)


def same(other: str) -> None:
    """dwconv7x7_nhwc from the sources in `other` against this checkout's
    (module docstring, --same)."""
    import torch

    from ..ops import dwconv7x7 as dw

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dw7x7_same_", dir=build.BUILD_DIR)
    jobs = []
    for name, csrc in (("other", other), ("this", build.CSRC)):
        with open(os.path.join(csrc, "dwconv7x7.cu")) as f:
            jobs.append((name, f.read(), tmp, "dw7x7_nhwc_kernel", csrc))
    with ThreadPoolExecutor(2) as ex:
        fns = {}
        for name, so, _ in ex.map(_compile, jobs):
            fns[name] = ctypes.CDLL(so).dwconv7x7_nhwc
            fns[name].argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                  + [ctypes.c_void_p])
    print(f"dw7x7 --same: {os.path.relpath(other)} against "
          f"{os.path.relpath(build.CSRC)}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(9)
    stream = torch.cuda.current_stream().cuda_stream
    total = 0
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 4):
            for (H, W, C), _ in dw.PATH_SHAPES:
                x = torch.randn(B, H, W, C, device="cuda",
                                generator=g).to(dtype)
                k = 0.1 * torch.randn(7, 7, C, device="cuda", generator=g)
                b = 0.1 * torch.randn(C, device="cuda", generator=g)
                kt, bt = k.to(dtype), b.to(dtype)
                ys = {}
                for name, fn in fns.items():
                    ys[name] = torch.empty_like(x)
                    if fn(x.data_ptr(), kt.data_ptr(), bt.data_ptr(),
                          ys[name].data_ptr(), B, H, W, C,
                          dw._DTYPE_CODE[dtype], stream):
                        raise RuntimeError(f"dw7x7 {name}: launch failed")
                yp = dw.dwconv7x7_plain(x, k, b)
                n = int((ys["this"] != ys["other"]).sum())
                total += n
                print(f"dw7x7 {str(dtype)[6:]:8s} {B}x{H}x{W}x{C}: "
                      f"{n} of {x.numel()} outputs differ from the other "
                      f"sources; {int((ys['this'] != yp).sum())} differ "
                      f"from plain, by at most "
                      f"{(ys['this'].float() - yp.float()).abs().max():.3e}",
                      flush=True)
    print(f"dw7x7 --same: {total} outputs differ in all", flush=True)


def main(argv=None) -> int:
    import torch

    args = list(argv if argv is not None else sys.argv[1:])
    if not torch.cuda.is_available():
        print("variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args[:1] == ["--time"]:
        time_one(*args[1:5])
        return 0
    if args[:1] == ["--sass"]:
        for name in args[1:]:
            sass(name)
        return 0
    if args[:1] == ["--same"]:
        same(os.path.abspath(args[1]))
        return 0
    csrc = build.CSRC
    if args[:1] == ["--csrc"]:
        csrc, args = os.path.abspath(args[1]), args[2:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for k in args or ["bwd_i"]:
        run(k, csrc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
