"""Time breakdowns of four kernels on the card, from edited copies of their
sources.

    python3 -m unicorn_torch.csrc.variants [bwd_i] [bwd_j] [fwd_lse] [correlation]

Builds the copies, one nvcc each in parallel, and times each twice with
CUDA-graph replays, in a process of its own. The cut copies give wrong results;
their times bound what each part costs. Each copy's registers and spills
come from `nvcc -Xptxas -v`.

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


def _compile(args):
    name, text, tmp, fn_mark = args
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(tmp, f"{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           build.CSRC, "-o", so, path],
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


def _setup(kernel):
    """(source file, variants, ptxas mark, C function name, its argument
    types, make(fn) -> (call, result, reference))."""
    import torch

    from ..ops import correlation_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(5)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
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
            return (lambda: fn(*(t.data_ptr() for t in args), B, N, C, K,
                               stream())), res, ref
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
        return (lambda: fn(*(t.data_ptr() for t in args), B, N, C, K, 1,
                           stream())), out, ref
    return ("correlation.cu", _correlation_variants,
            "corr_tc_kernelILi2ELi1E", "correlation_forward",
            [ptr] * 5 + [i32] * 5 + [ptr], make)


def time_one(kernel: str, name: str, so: str) -> None:
    """Check and time one built copy (in a process of its own, so that a
    cut copy that faults takes no other copy's numbers with it)."""
    import torch

    _, _, _, cname, argtypes, make = _setup(kernel)
    fn = getattr(ctypes.CDLL(so), cname)
    fn.argtypes = argtypes
    call, res, ref = make(fn)
    if call():
        raise RuntimeError(f"{kernel} {name}: launch failed")
    torch.cuda.synchronize()
    rel = ((res - ref).abs().max() / ref.abs().max()).item()
    if name == "as_built" and rel > 1e-4:
        raise AssertionError("the source as built disagrees with plain")
    ts = [_graph_ms(call) for _ in range(2)]
    print(f"{kernel} {name:12s} vs plain {rel:.1e}  "
          + " ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)


def run(kernel: str) -> None:
    fname, variants_of, mark, *_ = _setup(kernel)
    with open(os.path.join(build.CSRC, fname)) as f:
        variants = variants_of(f.read())
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{kernel}_variants_", dir=build.BUILD_DIR)
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(_compile, [(n, t, tmp, mark) for n, t in
                                       variants.items()]))
    for name, so, info in built:
        print(f"{kernel} {name:12s} {info}", flush=True)
    for name, so, _ in built:
        proc = subprocess.run([sys.executable, "-m", "unicorn_torch.csrc.variants", "--time",
                               kernel, name, so], capture_output=True,
                              text=True)
        print(proc.stdout.strip() or
              f"{kernel} {name:12s} failed: {proc.stderr.strip()[-300:]}",
              flush=True)


def main(argv=None) -> int:
    import torch

    args = argv if argv is not None else sys.argv[1:]
    if not torch.cuda.is_available():
        print("variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args[:1] == ["--time"]:
        time_one(*args[1:4])
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for k in args or ["bwd_i"]:
        run(k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
