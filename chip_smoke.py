#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unicorn_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as the port's quickest proof

Phases (each must pass, else the exit code is 1):
  build      the card's name and power limit; every CUDA source of csrc/
             built with nvcc (dwconv7x7, msda, correlation,
             correlation_train), in parallel
  kernels    each kernel against its plain PyTorch version at the main
             paths' shapes and at ragged ones, in bf16 and fp32, with times
             of kernel, plain version and the PyTorch library call that
             computes the same function, and the bound; the gradients of
             the dw7x7 and MSDA autograd Functions against autograd of
             their plain versions
  model      the ConvNeXt-Tiny Unicorn at 800x1280 in bf16 (seeded random
             weights): forward_whole through the dw7x7 kernel vs the same
             model through the plain version, on the card
  main       the MOT path: MOTDriver.update over synthetic 1080x1920 uint8
             frames, letterboxed on the card; frames/s, per-stage ms, dets
             and tracks per frame, launch counts (27 dw7x7 per frame)
  sot_model  the served model (bf16 trunk, bf16 interaction): one SOT frame
             through the three kernels vs through their plain versions
  sot        the SOT path: SOTDriver.initialize, 16 track calls, one
             track_window of 8 frames (window 4), then 4 track calls with
             the MSDA kernel's direct mode; frames/s, per-stage ms, launch
             counts (27 dw7x7, 1 msda, 1 correlation per frame or chunk)
  train_model  the model as trained (bf16 trunk, fp32 interaction): one
             uni_loss_fn forward + backward on a mixed SOT/MOT batch through
             the kernels vs through their plain versions; loss and every
             parameter's gradient
  train      the training path: ExpTrack.get_train_step / get_optimizer
             with TrainState (AdamW, gradient accumulation, EMA) at B = 2
             pairs of 800x1280 on synthetic batches: 2 warm-up and 8 timed
             steps alternating an SOT and a MOT batch, 6 steps on one SOT
             batch (the loss must fall), 2 steps with their stages timed
             apart; ms/step, peak memory, launch counts per step (36 dw7x7,
             1 msda, 2 each of the three correlation training kernels)
`--only profile` adds a torch.profiler breakdown of the three paths.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the rest of the
repo beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

FRAME_HW = (1080, 1920)   # the synthetic uint8 frames of both paths
N_FRAMES = 16             # MOTDriver.update calls of the MOT path
N_TRACK = 16              # SOTDriver.track calls of the SOT path
N_WINDOW = 8              # frames of its one track_window call
WINDOW = 4                # frames per chunk of that call
N_DIRECT = 4              # track calls with the MSDA kernel's direct mode
INIT_BOX = [800.0, 400.0, 240.0, 180.0]   # x, y, w, h in the first frame

# published peaks by card name: (memory bytes/s, fp32 FLOP/s outside the
# tensor cores, bf16 FLOP/s of the tensor cores); NVIDIA data sheets, dense,
# at the full power limit
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),   # SXM5 (name "NVIDIA H100 80GB HBM3")
}


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks for card {name!r}")


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn: `iters` calls captured in a CUDA graph
    and replayed `reps` times between CUDA events, so that the host's
    per-call overhead (larger than these kernels) leaves no gaps. Inputs
    stay warm in L2, as they are on the path, where each map was just
    written by the op before."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                 # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


@contextlib.contextmanager
def tf32_off():
    """fp32 plain versions are references only with TF32 off (cuDNN has it
    on by default); the phases that time a path run with PyTorch's own
    settings, as a caller's program would."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def bf16_ulp(t):
    """One bf16 ulp of each element's magnitude (8 significant bits)."""
    import torch

    a = t.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# ---------------------------------------------------------------- phase 1
def phase_card_and_build(report):
    import torch

    from unicorn_torch.csrc import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    name = torch.cuda.get_device_name(0)
    key, (bw, fp32, bf16) = peaks_for(name)
    print(f"card: {name} | power: {card} | peaks ({key}): "
          f"{bw / 1e12:.2f} TB/s, {fp32 / 1e12:.0f} TFLOP/s fp32, "
          f"{bf16 / 1e12:.0f} TFLOP/s bf16 | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build.build(["dwconv7x7", "msda", "correlation",
                        "correlation_train"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for n, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {n}: {line}")
    report["card"] = card
    report["peaks"] = (bw, fp32, bf16)


def roofline(nbytes, flops, bw, peak):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- phase 2
def phase_kernels(report):
    """Every kernel against its plain version; all three are checked even
    when one disagrees."""
    bad = []
    with tf32_off():
        for check in (kernels_dw7x7, kernels_msda, kernels_correlation,
                      kernels_correlation_train, kernels_backward):
            if not check(report):
                bad.append(check.__name__)
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def dw_beyond_tolerance_bf16(x, k, b, yk, yp) -> int:
    """How many bf16 outputs of the dw7x7 kernel (yk) lie further from the
    plain version's (yp) than one bf16 ulp of the output plus the bound on
    two fp32 sums of the same 50 terms taken in different orders
    (50 * 2^-24 * sum|x*w|), which decides outputs near zero."""
    import torch

    from unicorn_torch.ops import dwconv7x7 as dw

    mag = dw.dwconv7x7_plain(x.float().abs(), k.to(x.dtype).abs(),
                             b.to(x.dtype).abs())
    tol = (bf16_ulp(torch.maximum(yk.float().abs(), yp.float().abs()))
           + 50 * 2.0 ** -24 * mag)
    return int(((yk.float() - yp.float()).abs() > tol).sum().item())


def kernels_dw7x7(report) -> bool:
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import dwconv7x7 as dw

    bw, fp32_peak, _ = report["peaks"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    print("dw7x7  H x W x C     dtype  n  max|err|  tol      kernel_ms "
          "plain_ms  conv2d_ms bound_ms bound_by")
    for dtype in (torch.bfloat16, torch.float32):
        for (H, W, C), n in dw.PATH_SHAPES:
            x = torch.randn(1, H, W, C, device=dev, generator=g).to(dtype)
            k = (0.1 * torch.randn(7, 7, C, device=dev, generator=g))
            b = (0.1 * torch.randn(C, device=dev, generator=g))
            yk = dw.dwconv7x7_cuda(x, k, b)
            yp = dw.dwconv7x7_plain(x, k, b)
            torch.cuda.synchronize()
            diff = (yk.float() - yp.float()).abs()
            err = diff.max().item()
            if dtype == torch.bfloat16:
                tol_desc = "1ulp+sum"
                nbad = dw_beyond_tolerance_bf16(x, k, b, yk, yp)
                good = nbad == 0
                if nbad:
                    print(f"       {nbad} elements beyond tolerance")
            else:
                tol_desc = "1e-4"
                good = err <= 1e-4
            good = good and bool(torch.isfinite(yk.float()).all().item())
            ok &= good
            max_err[dtype] = max(max_err[dtype], err)
            esz = x.element_size()
            nbytes = (2 * x.numel() + 50 * C) * esz
            flops = 2 * 49 * x.numel()
            t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32_peak * 1e3
            bound = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            taps, bt, y = k.to(dtype), b.to(dtype), torch.empty_like(x)
            t_k = graph_time_ms(lambda: dw.launch(x, taps, bt, y))
            t_p = graph_time_ms(lambda: dw.dwconv7x7_plain(x, k, b))
            xc = x.permute(0, 3, 1, 2)        # NCHW view, channels_last
            wl = taps.permute(2, 0, 1).unsqueeze(1).contiguous()
            t_l = graph_time_ms(
                lambda: F.conv2d(xc, wl, bt, padding=3, groups=C))
            print(f"       {H:3d}x{W:3d}x{C:<4d} {str(dtype)[6:]:8s} {n} "
                  f"{err:.2e}  {tol_desc:7s}  {t_k:.4f}    {t_p:.4f}   "
                  f"{t_l:.4f}    {bound:.4f}   {bound_by}"
                  f"{'' if good else '  FAIL'}")
            if dtype == torch.bfloat16:
                tot["ms"] += n * t_k
                tot["plain_ms"] += n * t_p
                tot["library_ms"] += n * t_l
                tot["bound_ms"] += n * bound
                tot["bytes_ms"] += n * t_bytes
                tot["ops_ms"] += n * t_ops
    # the SOT window path runs the same shapes at its batch of WINDOW frames
    for (H, W, C), _ in dw.PATH_SHAPES:
        x = torch.randn(WINDOW, H, W, C, device=dev,
                        generator=g).to(torch.bfloat16)
        k = 0.1 * torch.randn(7, 7, C, device=dev, generator=g)
        b = 0.1 * torch.randn(C, device=dev, generator=g)
        yk, yp = dw.dwconv7x7_cuda(x, k, b), dw.dwconv7x7_plain(x, k, b)
        nbad = dw_beyond_tolerance_bf16(x, k, b, yk, yp)
        if nbad:
            print(f"       B={WINDOW} {H}x{W}x{C} bf16: {nbad} elements "
                  "beyond tolerance  FAIL")
        ok &= nbad == 0
    print(f"       the 7 shapes at B={WINDOW} (bf16, 1ulp+sum): "
          f"{'ok' if ok else 'FAIL'}")
    print(f"dw7x7 per frame (bf16, 27 launches): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms")
    report.setdefault("kernels", {})["dwconv7x7"] = dict(
        name="dwconv7x7", route="cuda",
        source="unicorn_torch/csrc/dwconv7x7.cu",
        replaces="unicorn_tpu/ops/pallas_convnext.py:196",
        launches=None, max_abs_err=max_err[torch.bfloat16],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                  else "operations"),
        library_ms=tot["library_ms"])
    return ok


def _msda_inputs(shape, dtype, g, served):
    """value, locations, weights for one MSDA check. served: the reference
    points of the SOT path (every cell centre of both levels) plus offsets
    of a few cells, as its offset bias gives; else uniform locations that
    reach outside [0, 1]."""
    import torch

    B, L, H, W, M, D, Lq, P = shape
    dev = torch.device("cuda")
    value = torch.randn(B, L, H, W, M, D, device=dev, generator=g).to(dtype)
    if served:
        ys = (torch.arange(H, device=dev) + 0.5) / H
        xs = (torch.arange(W, device=dev) + 0.5) / W
        ref = torch.stack([xs[None].expand(H, W), ys[:, None].expand(H, W)],
                          -1).reshape(H * W, 2).repeat(L, 1)
        off = 3.0 * torch.randn(B, Lq, M, L, P, 2, device=dev, generator=g)
        locs = ref[None, :, None, None, None] + off / torch.tensor(
            [W, H], device=dev, dtype=torch.float32)
    else:
        locs = torch.rand(B, Lq, M, L, P, 2, device=dev,
                          generator=g) * 1.4 - 0.2
    attw = torch.softmax(torch.randn(B, Lq, M, L * P, device=dev,
                                     generator=g), -1)
    return value, locs.contiguous(), attw.reshape(B, Lq, M, L, P).to(dtype)


def kernels_msda(report) -> bool:
    """Kernel A in both modes against each mode's plain version. Tolerance,
    set before the first run: kernel and plain version compute the same
    corner weights bit for bit (each product and difference rounded apart),
    so they differ by two fp32 orders of the same L*P*4 terms,
    L*P*4 * 2^-24 * sum|w*v|, and in bf16 by one ulp of the output where
    that moves the final rounding."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import deform_attn as da

    bw, fp32_peak, _ = report["peaks"]
    g = torch.Generator(device="cuda").manual_seed(1)
    served = (1, 2, 50, 80, 8, 32, 8000, 4)
    window = (WINDOW,) + served[1:]           # a track_window chunk
    ragged = (2, 2, 13, 17, 3, 8, 29, 4)
    ok = True
    print("msda   mode     shape (B,L,H,W,M,D,Lq,P)          dtype    "
          "max|err|  kernel_ms plain_ms  grid_sample_ms bound_ms bound_by")
    for mode in ("factored", "direct"):
        for shape in (served, window, ragged):
            for dtype in (torch.bfloat16, torch.float32):
                value, locs, attw = _msda_inputs(shape, dtype, g,
                                                 shape is not ragged)
                B, L, H, W, M, D, Lq, P = shape
                yk = da.ms_deform_attn_cuda(value, locs, attw, mode)
                yp = da.ms_deform_attn_plain(value, locs, attw, mode)
                torch.cuda.synchronize()
                diff = (yk.float() - yp.float()).abs()
                err = diff.max().item()
                mag = da.ms_deform_attn_plain(value.float().abs(), locs,
                                              attw.float(), "direct")
                tol = L * P * 4 * 2.0 ** -24 * mag + 1e-7
                if dtype == torch.bfloat16:
                    tol = tol + bf16_ulp(torch.maximum(yk.float().abs(),
                                                       yp.float().abs()))
                nbad = int((diff > tol).sum().item())
                good = nbad == 0 and bool(torch.isfinite(yk.float()).all())
                ok &= good
                nbytes = (value.numel() * value.element_size()
                          + locs.numel() * 4
                          + attw.numel() * attw.element_size()
                          + yk.numel() * yk.element_size())
                flops = 2 * B * Lq * M * L * P * 4 * D
                bound, bound_by = roofline(nbytes, flops, bw, fp32_peak)
                out = torch.empty_like(yk)
                t_k = graph_time_ms(
                    lambda: da.launch(value, locs, attw, out, mode))
                t_p = graph_time_ms(
                    lambda: da.ms_deform_attn_plain(value, locs, attw, mode),
                    iters=5)
                # library yardstick: F.grid_sample per level over (B*M, D,
                # H, W), then the weighted sum; in fp32, because grid_sample
                # wants input and grid in one dtype and bf16 locations would
                # lose the sub-cell position (the casts are not timed)
                vf = value.float().permute(0, 1, 4, 5, 2, 3).reshape(
                    B, L, M, D, H, W)
                grid = (2 * locs - 1).permute(0, 2, 3, 1, 4, 5).reshape(
                    B * M, L, Lq, P, 2)
                wf = attw.float().permute(0, 2, 1, 3, 4).reshape(
                    B * M, 1, Lq, L * P)

                def library():
                    s = torch.cat([F.grid_sample(
                        vf[:, l].reshape(B * M, D, H, W), grid[:, l],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False) for l in range(L)], -1)
                    return (s * wf).sum(-1).reshape(B, M * D, Lq).transpose(
                        1, 2)

                lib_err = (library().float() - yp.float()).abs().max().item()
                t_l = graph_time_ms(library, iters=5)
                print(f"       {mode:8s} {str(shape):34s} {str(dtype)[6:]:8s} "
                      f"{err:.2e}  {t_k:.4f}    {t_p:.4f}   {t_l:.4f}"
                      f"         {bound:.4f}   {bound_by}  (grid_sample vs "
                      f"plain {lib_err:.1e}){'' if good else '  FAIL'}")
                if nbad:
                    print(f"       {nbad} elements beyond tolerance")
                if shape is served and dtype == torch.bfloat16:
                    src = {"factored": "unicorn_tpu/ops/deform_attn.py:294",
                           "direct": "unicorn_tpu/ops/deform_attn.py:204"}
                    report.setdefault("kernels", {})[f"msda_{mode}"] = dict(
                        name=f"msda_{mode}", route="cuda",
                        source="unicorn_torch/csrc/msda.cu",
                        replaces=src[mode], launches=None, max_abs_err=err,
                        ms=t_k, plain_ms=t_p, bound_ms=bound,
                        bound_by=bound_by, library_ms=t_l)
    return ok


def kernels_correlation(report) -> bool:
    """Kernel B against its plain version, both bf16_dots settings.
    Tolerance, set before the first run: the outputs are averages of labels
    in [0, 1); kernel and plain version take the same scores (exact bf16
    products, or fp32 products) in other summation orders, and another exp:
    rtol 1e-4, atol 1e-5. With embeddings scaled x10 the scores reach
    several hundred, an fp32 ulp of a score is 3e-5 and enters the
    exponential: rtol 1e-3 there, and every output finite."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import correlation_kernel as ck

    bw, fp32_peak, bf16_peak = report["peaks"]
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    # (B, N, C, K, scale, rtol); the first is the SOT path's shape, the
    # second a track_window chunk's
    cases = ((1, 16000, 128, 1, 0.3, 1e-4), (WINDOW, 16000, 128, 1, 0.3, 1e-4),
             (1, 1000, 128, 3, 0.3, 1e-4), (2, 77, 16, 16, 1.0, 1e-4),
             (1, 1000, 16, 3, 10.0, 1e-3))
    ok = True
    print("corr   B N     C   K  scale bf16_dots max|err|  kernel_ms plain_ms "
          " sdpa_ms  bound_ms bound_by")
    for B, N, C, K, scale, rtol in cases:
        e0 = scale * torch.randn(B, N, C, device=dev, generator=g)
        e1 = scale * torch.randn(B, N, C, device=dev, generator=g)
        v = torch.rand(B, K, N, device=dev, generator=g)
        for bf16_dots in (True, False):
            yk = ck.correlation_propagate_cuda(e0, e1, v, bf16_dots=bf16_dots)
            yp = ck.correlation_propagate_plain(e0, e1, v,
                                                bf16_dots=bf16_dots)
            torch.cuda.synchronize()
            diff = (yk - yp).abs()
            err = diff.max().item()
            nbad = int((diff > 1e-5 + rtol * yp.abs()).sum().item())
            good = nbad == 0 and bool(torch.isfinite(yk).all())
            ok &= good
            nbytes = (e0.numel() + e1.numel() + v.numel() + yk.numel()) * 4
            flops = 2 * B * N * N * (C + K)
            bound, bound_by = roofline(
                nbytes, flops, bw, bf16_peak if bf16_dots else fp32_peak)
            out = torch.empty_like(yk)
            t_k = graph_time_ms(
                lambda: ck.launch(e0, e1, v, out, bf16_dots), iters=5)
            t_p = graph_time_ms(
                lambda: ck.correlation_propagate_plain(
                    e0, e1, v, bf16_dots=bf16_dots), iters=3)
            t_l = None
            if bf16_dots:
                # library yardstick: attention with q = e1, k = e0, scale 1,
                # in bf16; the value v^T is zero-padded from K to C columns,
                # the head width the fused backends take
                q = e1.bfloat16()[:, None]
                k = e0.bfloat16()[:, None]
                vv = torch.zeros(B, 1, N, C, device=dev, dtype=torch.bfloat16)
                vv[:, 0, :, :K] = v.transpose(1, 2).bfloat16()
                lib = F.scaled_dot_product_attention(q, k, vv, scale=1.0)
                lib_err = (lib[:, 0, :, :K].transpose(1, 2).float()
                           - yp).abs().max()
                t_l = graph_time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, vv,
                                                           scale=1.0),
                    iters=5)
            print(f"       {B} {N:<5d} {C:<3d} {K:<2d} {scale:<5.1f} "
                  f"{str(bf16_dots):9s} {err:.2e}  {t_k:.4f}    {t_p:.4f}   "
                  + (f"{t_l:.4f}" if t_l is not None else "  -   ")
                  + f"   {bound:.4f}   {bound_by}"
                  + (f"  (sdpa vs plain {lib_err.item():.1e})"
                     if t_l is not None else "")
                  + ("" if good else "  FAIL"))
            if nbad:
                print(f"       {nbad} elements beyond tolerance")
            if (B, N) == (1, 16000) and bf16_dots:
                report.setdefault("kernels", {})["correlation"] = dict(
                    name="correlation", route="cuda",
                    source="unicorn_torch/csrc/correlation.cu",
                    replaces="unicorn_tpu/ops/pallas_correlation.py:24",
                    launches=None, max_abs_err=err, ms=t_k, plain_ms=t_p,
                    bound_ms=bound, bound_by=bound_by, library_ms=t_l)
    return ok


def event_time_ms(fn, iters: int = 3) -> float:
    """Device time of one call of fn between CUDA events, eager: for calls
    of several ms (autograd backward passes), where the host's overhead is
    small beside the device's work."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


TRAIN_SHAPE = (2, 16000, 128, 1)   # B, N, C, K of one 800x1280 training step


def kernels_correlation_train(report) -> bool:
    """The three training kernels (forward with logsumexp, bwd_i, bwd_j)
    against their plain versions in fp32, and correlation_propagate_train
    under autograd against the plain streaming version under autograd.
    Tolerances, set before the first run. out: the serving kernel's (rtol
    1e-4, atol 1e-5; rtol 1e-3 with embeddings x10, where an fp32 ulp of a
    score of several hundred is 3e-5 and enters the exponential). lse: 1e-5
    + 2e-6 |lse| (16 fp32 ulps: two orders of the same N-term sum). dE0, dE1,
    dV: every entry within 1e-4 (x10: 1e-3) of the tensor's largest
    magnitude (plus 1e-6: with a nearly one-hot softmax dE0 and dE1 are all
    cancellation); each is a sum of N products of P, which carries the
    exponential's relative error, taken in another order. Both backward
    kernels and their plain versions get the kernel forward's lse and c."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops.correlation import correlation_propagate

    bw, fp32_peak, _ = report["peaks"]
    g = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")
    # (B, N, C, K, scale, rtol): the training step's shape, a ragged one, a
    # sharp one, and a width that fills only part of the channel tile
    cases = (TRAIN_SHAPE + (0.3, 1e-4), (2, 77, 16, 16, 1.0, 1e-4),
             (2, 1000, 16, 3, 10.0, 1e-3), (1, 300, 96, 2, 1.0, 1e-4))
    ok = True
    print("corr_train B N     C   K  scale  d_out    d_lse    d_dE0/max "
          "d_dE1/max d_dV/max  vjp_vs_autograd")
    for B, N, C, K, scale, rtol in cases:
        e0 = scale * torch.randn(B, N, C, device=dev, generator=g)
        e1 = scale * torch.randn(B, N, C, device=dev, generator=g)
        v = torch.rand(B, K, N, device=dev, generator=g)
        dout = torch.randn(B, K, N, device=dev, generator=g)
        n0 = dict(ck.train_launches)
        out, lse = ck.correlation_fwd_lse_cuda(e0, e1, v)
        c = (out * dout).sum(1, keepdim=True)
        de0, dv = ck.correlation_bwd_i_cuda(e0, e1, v, lse, dout, c)
        de1 = ck.correlation_bwd_j_cuda(e0, e1, v, lse, dout, c)
        assert ck.train_launches == {k: n + 1 for k, n in n0.items()}
        out_p, lse_p = ck.correlation_fwd_lse_plain(e0, e1, v)
        de0_p, dv_p = ck.correlation_bwd_i_plain(e0, e1, v, lse, dout, c)
        de1_p = ck.correlation_bwd_j_plain(e0, e1, v, lse, dout, c)
        torch.cuda.synchronize()
        good = all(bool(torch.isfinite(t).all())
                   for t in (out, lse, de0, de1, dv))
        d_out = (out - out_p).abs()
        good &= not bool((d_out > 1e-5 + rtol * out_p.abs()).any())
        d_lse = (lse - lse_p).abs()
        good &= not bool((d_lse > 1e-5 + 2e-6 * lse_p.abs()).any())
        rels = []
        for a, b in ((de0, de0_p), (de1, de1_p), (dv, dv_p)):
            rels.append(((a - b).abs().max() / b.abs().max()).item())
            good &= bool((a - b).abs().max() <= rtol * b.abs().max() + 1e-6)
        vjp = "-"
        if N <= 1000:
            # the Function's gradients against autograd of the plain
            # streaming version (its own softmax, its own order): 10 x rtol
            leaves = [t.clone().requires_grad_() for t in (e0, e1, v)]
            y = ck.correlation_propagate_train(*leaves)
            gk = torch.autograd.grad(y, leaves, dout)
            leaves_p = [t.clone().requires_grad_() for t in (e0, e1, v)]
            gp = torch.autograd.grad(correlation_propagate(*leaves_p),
                                     leaves_p, dout)
            worst = max(((a - b).abs().max()
                         / (b.abs().max() + 1e-3)).item()
                        for a, b in zip(gk, gp))
            good &= worst <= 10 * rtol
            vjp = f"{worst:.1e}"
        ok &= good
        print(f"           {B} {N:<5d} {C:<3d} {K:<2d} {scale:<5.1f}  "
              f"{d_out.max().item():.2e} {d_lse.max().item():.2e} "
              f"{rels[0]:.2e}  {rels[1]:.2e}  {rels[2]:.2e}  {vjp}"
              f"{'' if good else '  FAIL'}")
        if (B, N, C, K) != TRAIN_SHAPE:
            continue

        # times, bounds and the library yardstick at the training shape
        nb_in = (e0.numel() + e1.numel() + v.numel()) * 4
        nb_bwd = nb_in + (lse.numel() + dout.numel() + c.numel()) * 4
        work = {   # name: (bytes, operations, launch, plain)
            "fwd_lse": (nb_in + (out.numel() + lse.numel()) * 4,
                        2 * B * N * N * (C + K),
                        lambda: ck.launch_train("fwd_lse", e0, e1, v,
                                                out, lse),
                        lambda: ck.correlation_fwd_lse_plain(e0, e1, v)),
            "bwd_i": (nb_bwd + (de0.numel() + dv.numel()) * 4,
                      2 * B * N * N * (2 * C + 2 * K),
                      lambda: ck.launch_train("bwd_i", e0, e1, v, lse,
                                              dout, c, de0, dv),
                      lambda: ck.correlation_bwd_i_plain(e0, e1, v, lse, dout,
                                                         c)),
            "bwd_j": (nb_bwd + de1.numel() * 4,
                      2 * B * N * N * (2 * C + K),
                      lambda: ck.launch_train("bwd_j", e0, e1, v, lse,
                                              dout, c, de1),
                      lambda: ck.correlation_bwd_j_plain(e0, e1, v, lse, dout,
                                                         c)),
        }
        # library yardstick: fp32 attention with q = e1, k = e0, scale 1, the
        # value v^T zero-padded from K to C columns; its backward through
        # autograd gives dq, dk, dv: the two backward kernels together
        q = e1[:, None].clone().requires_grad_()
        kk = e0[:, None].clone().requires_grad_()
        vv = torch.zeros(B, 1, N, C, device=dev)
        vv[:, 0, :, :K] = v.transpose(1, 2)
        vv.requires_grad_()
        gg = torch.zeros(B, 1, N, C, device=dev)
        gg[:, 0, :, :K] = dout.transpose(1, 2)
        lib = F.scaled_dot_product_attention(q, kk, vv, scale=1.0)
        lib_err = (lib[:, 0, :, :K].transpose(1, 2) - out_p).abs().max().item()
        dq, dk, _ = torch.autograd.grad(lib, (q, kk, vv), gg,
                                        retain_graph=True)
        lib_gerr = max(((dq[:, 0] - de1_p).abs().max()
                        / de1_p.abs().max()).item(),
                       ((dk[:, 0] - de0_p).abs().max()
                        / de0_p.abs().max()).item())
        with torch.no_grad():
            t_lib_f = graph_time_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, scale=1.0), iters=3)
        t_lib_b = event_time_ms(lambda: torch.autograd.grad(
            lib, (q, kk, vv), gg, retain_graph=True))
        print(f"           sdpa fp32 at {TRAIN_SHAPE}: forward {t_lib_f:.3f} "
              f"ms (vs plain {lib_err:.1e}), backward {t_lib_b:.3f} ms (dq, "
              f"dk vs plain, share of max {lib_gerr:.1e})")
        errs = {"fwd_lse": d_out.max().item(),
                "bwd_i": (de0 - de0_p).abs().max().item(),
                "bwd_j": (de1 - de1_p).abs().max().item()}
        lines = {"fwd_lse": 156, "bwd_i": 191, "bwd_j": 231}
        for name, (nbytes, flops, launch, plain) in work.items():
            bound, bound_by = roofline(nbytes, flops, bw, fp32_peak)
            t_k = graph_time_ms(launch, iters=3)
            t_p = graph_time_ms(plain, iters=2, reps=3)
            print(f"           {name:8s} B={B}: kernel {t_k:.3f} ms, plain "
                  f"{t_p:.3f} ms, bound {bound:.3f} ms ({bound_by}), "
                  f"{flops / t_k / 1e9:.1f} TFLOP/s fp32")
            entry = dict(
                name=f"correlation_{name}", route="cuda",
                source="unicorn_torch/csrc/correlation_train.cu",
                replaces=f"unicorn_tpu/ops/pallas_correlation.py:{lines[name]}",
                launches=None, max_abs_err=errs[name], ms=t_k, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by,
                library_ms=t_lib_f if name == "fwd_lse" else t_lib_b)
            if name != "fwd_lse":
                entry["library_covers"] = "sdpa backward: bwd_i and bwd_j"
            report.setdefault("kernels", {})[f"correlation_{name}"] = entry
    return ok


def kernels_backward(report) -> bool:
    """The dw7x7 and MSDA autograd Functions (forward = kernel, backward =
    autograd of the plain version) against autograd of their plain versions,
    at one served shape each, with the time of the plain backward.
    Tolerance: the forwards differ as the forward checks allow, the
    backwards are the same plain code on the same saved inputs: every
    gradient within 1e-5 of its largest magnitude in fp32 (scatter-adds in
    another order), within 2^-7 (one bf16 ulp of the largest) in bf16."""
    import torch

    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    ok = True

    def grads_of(fn, inputs, needs, gy=None):
        leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
        y = fn(*leaves)
        if gy is None:
            gy = torch.randn(y.shape, device=dev, generator=g).to(y.dtype)
        wanted = [t for t, n in zip(leaves, needs) if n]
        return y, wanted, gy

    def compare(label, fn_k, fn_p, inputs, needs, tol):
        nonlocal ok
        y_k, in_k, gy = grads_of(fn_k, inputs, needs)
        y_p, in_p, _ = grads_of(fn_p, inputs, needs, gy)
        g_k = torch.autograd.grad(y_k, in_k, gy, retain_graph=True)
        g_p = torch.autograd.grad(y_p, in_p, gy)
        worst = max(((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item()
                    for a, b in zip(g_k, g_p))
        t_b = event_time_ms(lambda: torch.autograd.grad(
            y_k, in_k, gy, retain_graph=True), iters=5)
        good = worst <= tol
        ok &= good
        print(f"backward {label}: worst gradient difference, share of max "
              f"{worst:.2e} (tol {tol:.1e}); plain backward {t_b:.3f} ms"
              f"{'' if good else '  FAIL'}")

    for dtype, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        x = torch.randn(2, 50, 80, 384, device=dev, generator=g).to(dtype)
        k = 0.1 * torch.randn(7, 7, 384, device=dev, generator=g)
        b = 0.1 * torch.randn(384, device=dev, generator=g)
        n0 = dw.launches
        compare(f"dw7x7 2x50x80x384 {str(dtype)[6:]}", dw.dwconv7x7,
                dw.dwconv7x7_plain, (x, k, b), (True, True, True), tol)
        assert dw.launches == n0 + 1, "dwconv7x7 did not launch its kernel"
    value, locs, attw = _msda_inputs((2, 2, 50, 80, 8, 32, 8000, 4),
                                     torch.float32, g, True)
    for method, mode in (("auto", "factored"), ("pallas", "direct")):
        n0 = da.launches_by_mode[mode]
        compare(f"msda {mode} fp32 B=2 50x80", lambda v, l, a: da.ms_deform_attn(
            v, l, a, method), lambda v, l, a: da.ms_deform_attn_plain(
                v, l, a, mode), (value, locs, attw), (True, True, True), 1e-5)
        assert da.launches_by_mode[mode] == n0 + 1
    return ok


def _model(report):
    """The unicorn_track_tiny Unicorn (ConvNeXt-Tiny, bf16) on the card,
    seeded random weights; built once per run."""
    import torch

    from unicorn_torch.exp.unicorn_track_tiny import Exp

    if "model" not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0))
        report["model"] = (exp, model.to(DEVICE).eval())
    return report["model"]


# ---------------------------------------------------------------- phase 3
def phase_model(report):
    """forward_whole through the kernel vs through the plain version, on the
    same bf16 model and image. Tolerance, set before the first run: the two
    dw7x7 forms differ by at most about an ulp at each of 27 blocks of
    random weights, so the decoded scores (sigmoids) may move by up to
    0.05, and the raw logits by up to 5% of their largest magnitude (the
    bound the CPU tests hold bf16 PyTorch against bf16 JAX to)."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.models import blocks
    from unicorn_torch.models.heads import decode_for_inference
    from unicorn_torch.ops import dwconv7x7 as dw

    exp, model = _model(report)
    H, W = exp.test_size
    rng = np.random.RandomState(0)
    img = torch.from_numpy((rng.rand(1, H, W, 3) * 255).round()
                           .astype(np.float32)).to(DEVICE)
    x = img.permute(0, 3, 1, 2)
    with torch.inference_mode():
        n0 = dw.launches
        raw_k = model.forward_whole(x)[0]
        n_k = dw.launches - n0
        with mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain):
            raw_p = model.forward_whole(x)[0]
        dec_k = decode_for_inference(raw_k, (8, 16, 32))
        dec_p = decode_for_inference(raw_p, (8, 16, 32))
        torch.cuda.synchronize()
    d_raw = max(
        ((lk[key].float() - lp[key].float()).abs().max()
         / lp[key].float().abs().max()).item()
        for lk, lp in zip(raw_k, raw_p) for key in ("_cls_packed",
                                                     "_reg_packed"))
    A = (H // 8) * (W // 8) + (H // 16) * (W // 16) + (H // 32) * (W // 32)
    assert tuple(dec_k.shape) == (1, A, 5 + exp.num_classes), dec_k.shape
    assert bool(torch.isfinite(dec_k).all()) and bool(
        torch.isfinite(dec_p).all())
    d_scores = (dec_k[..., 4:] - dec_p[..., 4:]).abs().max().item()
    d_boxes = ((dec_k[..., :4] - dec_p[..., :4]).abs()
               / dec_p[..., :4].abs().clamp_min(1.0)).max().item()
    print(f"forward_whole {H}x{W} bf16: decoded {tuple(dec_k.shape)}, "
          f"kernel vs plain: max |d score| {d_scores:.3e} (tol 0.05), "
          f"max rel |d box| {d_boxes:.3e}, raw logits max |d| / max|plain| "
          f"{d_raw:.3e} (tol 0.05); dw7x7 launches {n_k}")
    assert n_k == 27, n_k
    assert d_scores <= 0.05 and d_raw <= 0.05


# ---------------------------------------------------------------- phase 4
def phase_main(report):
    """MOTDriver.update over N_FRAMES synthetic 1080x1920 uint8 frames (a
    panning random texture), letterboxed on the card, conf_thre 0.0 so that
    NMS sees its 512 candidates. The obj/cls prediction biases are raised
    so that the random-weight detector's scores clear ByteTrack's
    thresholds and the tracker has work to do."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.mot import MOTDriver
    from unicorn_torch.ops import dwconv7x7 as dw

    exp, model = _model(report)
    with torch.no_grad():
        for name, p in model.head.named_parameters():
            if name.startswith(("obj_preds.", "cls_preds.")) and \
                    name.endswith(".bias"):
                p.add_(6.0)
    driver = MOTDriver(model, input_size=exp.test_size,
                       num_classes=exp.num_classes, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    rng = np.random.RandomState(1)
    fh, fw = FRAME_HW
    base = (rng.rand(fh, fw + 4 * N_FRAMES, 3) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 4 * t:4 * t + fw])
              for t in range(N_FRAMES)]
    for f in frames[:3]:                       # warm-up, not counted
        driver.update(f)
    driver.reset()
    torch.cuda.synchronize()

    dw.launches = 0
    tracks = []
    t0 = time.perf_counter()
    for f in frames:
        tracks.append(driver.update(f))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dw.launches
    fps = N_FRAMES / wall
    print(f"main path: {N_FRAMES} frames {fh}x{fw} -> {exp.test_size}, "
          f"{fps:.2f} frames/s ({wall / N_FRAMES * 1e3:.2f} ms/frame); "
          f"dw7x7 launches {launches} (27 x {N_FRAMES} = {27 * N_FRAMES})")
    report.setdefault("kernels", {}).setdefault(
        "dwconv7x7", {})["launches"] = launches
    report["fps"] = fps

    # per-stage times: the same stages as update(), synchronised apart
    driver.reset()
    stages = {"letterbox": [], "forward": [], "decode+nms": [],
              "fetch+tracker": []}
    dets_n, tracks_n = [], []
    for f in frames:
        t = [time.perf_counter()]
        img, r = driver.preprocess(f)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        raw = driver.forward(img)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        dets, valid = driver.postprocess(raw)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        views = driver.track(dets, valid, r)
        t.append(time.perf_counter())
        for k, name in enumerate(stages):
            stages[name].append((t[k + 1] - t[k]) * 1e3)
        dets_n.append(int(valid.sum()))
        tracks_n.append(len(views))
    print("per-stage ms (median of %d, synchronised): " % N_FRAMES + ", ".join(
        f"{k} {np.median(v):.3f}" for k, v in stages.items()))
    print(f"dets/frame mean {np.mean(dets_n):.1f} (min {min(dets_n)}, "
          f"max {max(dets_n)}); tracks/frame mean {np.mean(tracks_n):.1f} "
          f"(first {tracks_n[0]}, last {tracks_n[-1]}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ids = sorted({v.track_id for views in tracks for v in views})
    assert launches == 27 * N_FRAMES, launches
    assert all(np.isfinite(v.tlbr).all() for vs in tracks for v in vs)
    assert min(dets_n) > 0 and ids, "the main path produced no tracks"


# ------------------------------------------------------------ SOT phases
def _sot_model(report, msda_method="auto"):
    """The served unicorn_track_tiny Unicorn (bf16 trunk and head, bf16
    interaction) on the card, seeded random weights; one per MSDA method,
    with the same weights."""
    import torch

    from unicorn_torch.exp.unicorn_track_tiny import Exp

    key = f"sot_model_{msda_method}"
    if key not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0), serve=True,
                              msda_method=msda_method)
        report[key] = (exp, model.to(DEVICE).eval())
    return report[key]


def _sot_frames(n, seed):
    """n + 1 synthetic 1080x1920 uint8 frames: a panning random texture."""
    import numpy as np

    rng = np.random.RandomState(seed)
    fh, fw = FRAME_HW
    base = (rng.rand(fh, fw + 4 * (n + 1), 3) * 255).astype(np.uint8)
    return [np.ascontiguousarray(base[:, 4 * t:4 * t + fw])
            for t in range(n + 1)]


def _kernel_counts():
    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    return dict(dwconv7x7=dw.launches, msda_factored=da.launches_by_mode[
        "factored"], msda_direct=da.launches_by_mode["direct"],
        correlation=ck.launches)


def _reset_kernel_counts():
    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    dw.launches = da.launches = ck.launches = 0
    da.launches_by_mode.update(factored=0, direct=0)


def phase_sot_model(report):
    """One SOT frame on the served model through the three kernels vs the
    same through their plain versions (the wrappers patched out).
    Tolerances, set before the first run: the two dw7x7 forms differ by
    about a bf16 ulp at each of 27 blocks and the two MSDA forms by an ulp
    of their output, so the bf16 embeddings and the SOT branch's raw logits
    may move by up to 5% of their largest magnitude (the bound of phase
    model); the propagated prior is an average of labels in [0, 1] under a
    softmax of scores that move with the embeddings: up to 0.05."""
    from unittest import mock

    import torch

    from unicorn_torch.drivers import sot as sot_mod
    from unicorn_torch.drivers.sot import SOTDriver
    from unicorn_torch.models import blocks, interaction
    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    exp, model = _sot_model(report)
    driver = SOTDriver(model, input_size=exp.test_size, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    frames = _sot_frames(1, seed=3)
    driver.initialize(frames[0], INIT_BOX)
    img, _ = driver.preprocess(frames[1])

    def one_frame():
        fpn_outs, feat_cur = driver.backbone(img)
        emb_ref, emb_cur = driver.embed(feat_cur)
        priors = driver.propagate(emb_ref, emb_cur, fpn_outs)
        raw = driver.head(fpn_outs, priors)
        torch.cuda.synchronize()
        return emb_ref, emb_cur, priors[0], raw

    _reset_kernel_counts()
    out_k = one_frame()
    counts = _kernel_counts()
    with mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain), \
            mock.patch.object(
                interaction, "ms_deform_attn",
                lambda v, l, a, method: da.ms_deform_attn_plain(
                    v, l, a, "factored")), \
            mock.patch.object(
                sot_mod, "correlation_propagate_auto",
                lambda e0, e1, v: ck.correlation_propagate_plain(
                    e0, e1, v, bf16_dots=True)):
        out_p = one_frame()
    assert _kernel_counts() == counts, "a plain version launched a kernel"

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    H, W = exp.test_size
    d_emb = max(rel(out_k[0], out_p[0]), rel(out_k[1], out_p[1]))
    d_prior = (out_k[2].float() - out_p[2].float()).abs().max().item()
    d_raw = max(rel(lk[key], lp[key]) for lk, lp in zip(out_k[3], out_p[3])
                for key in ("cls_sot", "reg_sot", "obj_sot"))
    assert tuple(out_k[1].shape) == (1, exp.embed_dim, H // 8, W // 8)
    assert out_k[1].dtype == torch.bfloat16
    assert tuple(out_k[2].shape) == (1, 1, H // 8, W // 8)
    for t in (*out_k[:3], *(lv[k] for lv in out_k[3]
                            for k in ("cls_sot", "reg_sot", "obj_sot"))):
        assert bool(torch.isfinite(t.float()).all())
    print(f"sot frame {H}x{W}, bf16 trunk + bf16 interaction, kernel vs "
          f"plain: embeddings max |d| / max|plain| {d_emb:.3e} (tol 0.05), "
          f"prior max |d| {d_prior:.3e} (tol 0.05; prior in "
          f"[{out_k[2].min().item():.3f}, {out_k[2].max().item():.3f}]), "
          f"sot raw logits max |d| / max|plain| {d_raw:.3e} (tol 0.05); "
          f"launches {counts}")
    assert counts == dict(dwconv7x7=27, msda_factored=1, msda_direct=0,
                          correlation=1), counts
    assert d_emb <= 0.05 and d_prior <= 0.05 and d_raw <= 0.05


def phase_sot(report):
    """The SOT path: SOTDriver.initialize on a synthetic 1080x1920 uint8
    frame with a box, N_TRACK track calls on the panning frames, one
    track_window of N_WINDOW frames; then N_DIRECT track calls on the same
    weights with the MSDA kernel's direct mode (method "pallas").
    conf_thre is 0.0 so that the random-weight SOT branch always yields a
    box and NMS sees its 256 candidates."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.sot import SOTDriver

    exp, model = _sot_model(report)
    kw = dict(input_size=exp.test_size, conf_thre=0.0, nms_thre=exp.nmsthre,
              device=DEVICE)
    driver = SOTDriver(model, **kw)
    frames = _sot_frames(N_TRACK + N_WINDOW, seed=4)
    fh, fw = FRAME_HW
    driver.initialize(frames[0], INIT_BOX)
    for f in frames[1:3]:                      # warm-up, not counted
        driver.track(f)
    driver.track_window(frames[1:1 + WINDOW], window=WINDOW)
    driver.initialize(frames[0], INIT_BOX)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_kernel_counts()
    t0 = time.perf_counter()
    boxes = [driver.track(f)["target_bbox"] for f in frames[1:1 + N_TRACK]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    boxes += [o["target_bbox"] for o in driver.track_window(
        frames[1 + N_TRACK:], window=WINDOW)]
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    counts = _kernel_counts()
    n_chunks = N_WINDOW // WINDOW
    calls = N_TRACK + n_chunks
    print(f"sot path: track x {N_TRACK}, {fh}x{fw} -> {exp.test_size}: "
          f"{N_TRACK / wall:.2f} frames/s ({wall / N_TRACK * 1e3:.2f} "
          f"ms/frame); track_window {N_WINDOW} frames in chunks of {WINDOW}: "
          f"{N_WINDOW / wall_w:.2f} frames/s; launches {counts} "
          f"(27 / 1 / 1 per frame or chunk x {calls})")
    report["sot_fps"] = N_TRACK / wall
    ker = report.setdefault("kernels", {})
    for name in ("msda_factored", "correlation"):
        ker.setdefault(name, {}).update(
            launches=counts[name], launches_by_path={"sot": counts[name]})
    dwk = ker.setdefault("dwconv7x7", {})
    dwk["launches_by_path"] = {"mot": dwk.get("launches"),
                               "sot": counts["dwconv7x7"]}
    dwk["launches"] = (dwk.get("launches") or 0) + counts["dwconv7x7"]

    # per-stage times: the stages of track(), synchronised apart
    stages = {"letterbox": [], "backbone": [], "interaction+upsample": [],
              "correlation+priors": [], "head": [], "decode+nms": [],
              "fetch": []}
    for f in frames[1:1 + N_TRACK]:
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        img, _ = driver.preprocess(f)
        lap()
        fpn_outs, feat_cur = driver.backbone(img)
        lap()
        emb_ref, emb_cur = driver.embed(feat_cur)
        lap()
        priors = driver.propagate(emb_ref, emb_cur, fpn_outs)
        lap()
        raw = driver.head(fpn_outs, priors)
        lap()
        packed = driver.postprocess(raw)
        lap()
        packed = packed.cpu().numpy()
        lap()
        for k, name in enumerate(stages):
            stages[name].append((t[k + 1] - t[k]) * 1e3)
    print("sot per-stage ms (median of %d, synchronised): " % N_TRACK
          + ", ".join(f"{k} {np.median(v):.3f}" for k, v in stages.items()))
    print(f"sot peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; last packed row {np.round(packed[0, 0], 3).tolist()}")

    # the same weights with MSDA method "pallas": the kernel's direct mode
    _, model_d = _sot_model(report, msda_method="pallas")
    driver_d = SOTDriver(model_d, **kw)
    driver_d.initialize(frames[0], INIT_BOX)
    driver_d.track(frames[1])                  # warm-up, not counted
    driver_d.initialize(frames[0], INIT_BOX)
    _reset_kernel_counts()
    boxes_d = [driver_d.track(f)["target_bbox"]
               for f in frames[1:1 + N_DIRECT]]
    torch.cuda.synchronize()
    counts_d = _kernel_counts()
    ker.setdefault("msda_direct", {})["launches"] = counts_d["msda_direct"]
    print(f"sot path, msda method 'pallas' x {N_DIRECT}: launches {counts_d};"
          f" box of frame 1 {np.round(boxes_d[0], 2).tolist()} vs factored "
          f"{np.round(boxes[0], 2).tolist()}")

    assert counts == dict(dwconv7x7=27 * calls, msda_factored=calls,
                          msda_direct=0, correlation=calls), counts
    assert counts_d == dict(dwconv7x7=27 * N_DIRECT, msda_factored=0,
                            msda_direct=N_DIRECT,
                            correlation=N_DIRECT), counts_d
    # boxes are finite, have a positive size and lie inside the letterboxed
    # canvas taken back to frame coordinates (the frame plus its padding)
    H, W = exp.test_size
    r = min(H / fh, W / fw)
    assert len(boxes) == N_TRACK + N_WINDOW
    for x, y, w, h in boxes + boxes_d:
        assert np.isfinite([x, y, w, h]).all() and w > 0 and h > 0
        assert x >= 0 and y >= 0 and x + w <= W / r + 1e-3 \
            and y + h <= H / r + 1e-3, (x, y, w, h)


# -------------------------------------------------------- training phases
TRAIN_B = 2               # image pairs per training batch
TRAIN_LABELS = 100        # padded gt slots per frame (the JAX exp's max_labels)
TRAIN_WARMUP = 2          # training steps before the timed ones
TRAIN_STEPS = 8           # timed steps, alternating an SOT and a MOT batch
TRAIN_REPEAT = 6          # further steps on one repeated SOT batch
TRAIN_ITERS_PER_EPOCH = 8  # so that the schedule's warm-up ends within the run
# kernel launches of one training step with mhs: the correlation runs for the
# main and for the mhs priors; dw7x7 18 trunk blocks (the 2B frames as one
# batch) + 9 head blocks for each of the two head calls; one interaction
TRAIN_LAUNCHES = dict(dwconv7x7=36, msda_factored=1, msda_direct=0,
                      correlation=0, correlation_fwd_lse=2,
                      correlation_bwd_i=2, correlation_bwd_j=2)


def _train_model(report):
    """The unicorn_track_tiny Unicorn as trained (bf16 trunk and head, fp32
    interaction and embeddings) on the card, seeded random weights."""
    import torch

    from unicorn_torch.exp.unicorn_track_tiny import Exp

    if "train_model" not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0))
        report["train_model"] = (exp, model.to(DEVICE).train())
    return report["train_model"]


def _train_batch(exp, task: int, seed: int, n_obj: int):
    """One synthetic batch on the card from a numpy seed: images
    (B, 2, 3, H, W) float32 in [0, 255] (a random texture, the second frame
    shifted by 4 px), targets (B, 2, M, 6) [cls, cx, cy, w, h, track id] with
    n_obj boxes that drift by a few px between the frames, task_ids (B,)."""
    import numpy as np
    import torch

    H, W = exp.input_size
    rng = np.random.RandomState(seed)
    base = (rng.rand(TRAIN_B, 3, H, W + 4) * 255).round().astype(np.float32)
    images = np.stack([base[..., :W], base[..., 4:]], 1)
    targets = np.zeros((TRAIN_B, 2, TRAIN_LABELS, 6), np.float32)
    for b in range(TRAIN_B):
        wh = rng.uniform(40, 240, (n_obj, 2))
        cxy = rng.uniform(0.15, 0.85, (n_obj, 2)) * [W, H]
        cls = rng.randint(0, exp.num_classes, n_obj) if task == 2 else 0
        for f in range(2):
            targets[b, f, :n_obj, 0] = cls
            targets[b, f, :n_obj, 1:3] = cxy + f * rng.uniform(-6, 6, (n_obj, 2))
            targets[b, f, :n_obj, 3:5] = wh * (1 + f * rng.uniform(
                -0.05, 0.05, (n_obj, 2)))
            targets[b, f, :n_obj, 5] = np.arange(1, n_obj + 1)
    return (torch.from_numpy(images).to(DEVICE),
            torch.from_numpy(targets).to(DEVICE),
            torch.full((TRAIN_B,), task, dtype=torch.int64, device=DEVICE))


def _all_counts():
    from unicorn_torch.ops import correlation_kernel as ck

    return dict(_kernel_counts(), **{f"correlation_{k}": n for k, n
                                     in ck.train_launches.items()})


def _reset_all_counts():
    from unicorn_torch.ops import correlation_kernel as ck

    _reset_kernel_counts()
    for k in ck.train_launches:
        ck.train_launches[k] = 0


def _uni_loss_kwargs(exp):
    """The arguments ExpTrack.get_train_step gives uni_loss_fn."""
    return dict(img_size=exp.input_size, mot_weight=float(exp.mot_weight)
                if exp.scale_all_mot else 1.0, bidirect=exp.bidirect,
                use_l1=exp.always_l1, num_classes=exp.num_classes,
                mhs=exp.mhs)


def phase_train_model(report):
    """One uni_loss_fn forward + backward of the full-width model on one
    mixed batch (an SOT and a MOT sample) through the kernels, and again with
    every wrapper pointed at its plain version. Compared: the total loss and
    the gradient of every parameter, each leaf's largest difference as a
    share of that leaf's largest magnitude. Bounds, set before the first
    run: the bf16 trunk turns the kernels' one-ulp differences into about
    1e-2 of a gradient leaf, and SimOTA may hand an anchor to another gt, so
    the worst leaf may reach 0.1 and the loss 0.02 of its value; the median
    leaf stays under 0.02. TF32 is off for both runs: with it the fp32
    plain dw7x7 is no reference (worst leaf 0.15, median 0.04)."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.core.train_step import uni_loss_fn
    from unicorn_torch.losses import uni as uni_mod
    from unicorn_torch.models import blocks, interaction
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw
    from unicorn_torch.ops.correlation import correlation_propagate

    exp, model = _train_model(report)
    images, targets, task_ids = _train_batch(exp, 2, seed=10, n_obj=8)
    task_ids[0] = 1
    kw = _uni_loss_kwargs(exp)

    def run():
        model.zero_grad(set_to_none=True)
        total, loss_dict = uni_loss_fn(model, images, targets, task_ids, **kw)
        total.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        return total.item(), {k: v.item() for k, v in loss_dict.items()}, grads

    _reset_all_counts()
    with tf32_off():
        loss_k, dict_k, grads_k = run()
    counts = _all_counts()
    with tf32_off(), \
            mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain), \
            mock.patch.object(
                interaction, "ms_deform_attn",
                lambda v, l, a, method: da.ms_deform_attn_plain(
                    v, l, a, "factored")), \
            mock.patch.object(uni_mod, "correlation_propagate_train",
                              correlation_propagate):
        loss_p, dict_p, grads_p = run()
    assert _all_counts() == counts, "a plain version launched a kernel"
    model.zero_grad(set_to_none=True)

    shares = {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        assert bool(torch.isfinite(gk).all()), name
        shares[name] = ((gk - gp).abs().max()
                        / gp.abs().max().clamp_min(1e-30)).item()
    worst = max(shares, key=shares.get)
    median = float(np.median(list(shares.values())))
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    H, W = exp.input_size
    print(f"train model {H}x{W}, B={TRAIN_B} pairs, bf16 trunk + fp32 "
          f"interaction, kernels vs plain: total_loss {loss_k:.5f} vs "
          f"{loss_p:.5f} (rel {d_loss:.2e}, bound 0.02); {len(shares)} "
          f"gradient leaves, worst {shares[worst]:.3e} of its max at "
          f"{worst} (bound 0.1), median {median:.3e} (bound 0.02); "
          f"launches {counts}")
    print("  loss dict (kernels): " + ", ".join(
        f"{k} {v:.4f}" for k, v in dict_k.items()))
    assert counts == TRAIN_LAUNCHES, counts
    assert np.isfinite(loss_k) and d_loss <= 0.02
    assert shares[worst] <= 0.1 and median <= 0.02


def phase_train(report):
    """The training path: ExpTrack.get_train_step / get_optimizer on the
    card, AdamW with gradient accumulation over 2 micro-steps and EMA;
    TRAIN_WARMUP steps, then TRAIN_STEPS timed steps alternating an all-SOT
    and an all-MOT batch, then TRAIN_REPEAT steps on the SOT batch alone,
    then two steps with their stages synchronised apart."""
    import numpy as np
    import torch

    from unicorn_torch.core.train_state import TrainState
    from unicorn_torch.core.train_step import uni_loss_fn

    exp, model = _train_model(report)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    step = exp.get_train_step(TRAIN_B)
    batches = [_train_batch(exp, 1, seed=11, n_obj=1),
               _train_batch(exp, 2, seed=12, n_obj=12)]
    for t in range(TRAIN_WARMUP):
        step(state, *batches[t % 2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_all_counts()
    t0 = time.perf_counter()
    dicts = [step(state, *batches[t % 2])[1] for t in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    H, W = exp.input_size
    print(f"train path: {TRAIN_STEPS} steps, B={TRAIN_B} pairs of {H}x{W}, "
          f"mhs, AdamW, grad_accum {state.tx.grad_accum}, EMA: "
          f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step "
          f"({TRAIN_STEPS * TRAIN_B / wall:.2f} pairs/s); peak memory "
          f"{peak:.2f} GiB; launches {counts} = {TRAIN_STEPS} x "
          f"{TRAIN_LAUNCHES}; lr of the next update {state.lr():.3e}; TF32 "
          f"for fp32 convs {torch.backends.cudnn.allow_tf32}, for fp32 "
          f"matmuls {torch.backends.cuda.matmul.allow_tf32}")
    for t, d in enumerate(dicts):
        print(f"  step {t} ({'SOT' if t % 2 == 0 else 'MOT'}): " + ", ".join(
            f"{k} {v.item():.4f}" for k, v in d.items()))
    ker = report.setdefault("kernels", {})
    for name in ("correlation_fwd_lse", "correlation_bwd_i",
                 "correlation_bwd_j"):
        ker.setdefault(name, {})["launches"] = counts[name]
    for name in ("dwconv7x7", "msda_factored"):
        k = ker.setdefault(name, {})
        by_path = k.setdefault("launches_by_path", {})
        by_path["train"] = counts[name]
        k["launches"] = (k.get("launches") or 0) + counts[name]

    finite = all(bool(torch.isfinite(v).all()) for d in dicts
                 for v in d.values())

    rep = [step(state, *batches[0])[1]["total_loss"].item()
           for _ in range(TRAIN_REPEAT)]
    print(f"  {TRAIN_REPEAT} further steps on the SOT batch: total_loss "
          + " ".join(f"{v:.4f}" for v in rep))

    # the stages of a step, synchronised apart, over the two micro-steps of
    # one optimizer update; every parameter that got a gradient must move
    kw = _uni_loss_kwargs(exp)
    stages = {"forward+loss": [], "backward": [], "optimizer+ema": []}
    assert state.mini_step == 0
    names = [n for n, _ in state.model.named_parameters()]
    before = [p.detach().clone() for p in state.model.parameters()]
    ema_before = [p.detach().clone() for p in state.ema_model.parameters()]
    grad_norms = torch.zeros(len(names), device=DEVICE)
    for t in range(2):
        state.model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        ts = [time.perf_counter()]
        total, _ = uni_loss_fn(state.model, *batches[t % 2], **kw)
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        total.backward()
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        grad_norms += torch.stack([
            p.grad.float().abs().sum() if p.grad is not None
            else grad_norms.new_zeros(()) for p in state.model.parameters()])
        torch.cuda.synchronize()
        ts[-1] = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        for k, name in enumerate(stages):
            stages[name].append((ts[k + 1] - ts[k]) * 1e3)
    has_grad = (grad_norms > 0).tolist()
    stuck = [n for n, g, p, b in zip(names, has_grad,
                                     state.model.parameters(), before)
             if g and torch.equal(p, b)]
    ema_stuck = [n for n, g, p, b in zip(
        names, has_grad, state.ema_model.parameters(), ema_before)
        if g and torch.equal(p, b)]
    no_grad = [n for n, g in zip(names, has_grad) if not g]
    print(f"  one optimizer update: {sum(has_grad)} of {len(names)} "
          f"parameters got a gradient, {len(stuck)} of them did not move "
          f"(EMA: {len(ema_stuck)}); zero gradient (no fg anchor at that "
          f"level): {no_grad}")
    print("  per-stage ms (SOT step, MOT step; the MOT step runs the "
          "optimizer): " + ", ".join(
              f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in stages.items()))
    report["train_ms_per_step"] = wall / TRAIN_STEPS * 1e3

    assert finite, "a loss is not finite"
    assert counts == {k: n * TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()}, \
        counts
    assert not stuck, f"parameters that did not move: {stuck[:8]}"
    assert not ema_stuck, f"EMA tensors that did not move: {ema_stuck[:8]}"
    assert np.isfinite(rep).all() and rep[-1] < rep[0], rep


# ------------------------------------------------------ opt-in: profile
def _profile(label, step, frames):
    """torch.profiler over step(frame) for each frame: CUDA time by kernel
    and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            step(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {label}: {n} frames, wall {wall * 1e3:.1f} ms, device "
          f"busy {dev_ms:.1f} ms ({dev_ms / (wall * 10):.1f}% of wall), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/frame")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / (n * 1e3):8.3f} ms/frame "
              f"{e.count / n:6.1f}/frame  {e.key[:100]}")


def phase_profile(report):
    """torch.profiler over 4 frames of the MOT path and 4 of the SOT path.
    Opt-in: --only profile."""
    import numpy as np

    from unicorn_torch.drivers.mot import MOTDriver
    from unicorn_torch.drivers.sot import SOTDriver

    exp, model = _model(report)
    driver = MOTDriver(model, input_size=exp.test_size,
                       num_classes=exp.num_classes, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    rng = np.random.RandomState(2)
    frames = [(rng.rand(*FRAME_HW, 3) * 255).astype(np.uint8)
              for _ in range(6)]
    for f in frames[:2]:
        driver.update(f)
    _profile("mot", driver.update, frames[2:])

    exp, model = _sot_model(report)
    sot = SOTDriver(model, input_size=exp.test_size, conf_thre=0.0,
                    nms_thre=exp.nmsthre, device=DEVICE)
    sot.initialize(frames[0], INIT_BOX)
    for f in frames[:2]:
        sot.track(f)
    _profile("sot", sot.track, frames[2:])

    from unicorn_torch.core.train_state import TrainState

    exp, model = _train_model(report)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    step = exp.get_train_step(TRAIN_B)
    batches = [_train_batch(exp, 1, seed=11, n_obj=1),
               _train_batch(exp, 2, seed=12, n_obj=12)]
    for b in batches:
        step(state, *b)
    _profile("train (per step: SOT, MOT, SOT, MOT)",
             lambda b: step(state, *b), batches * 2)


PHASES = {
    "build": phase_card_and_build,
    "kernels": phase_kernels,
    "model": phase_model,
    "main": phase_main,
    "sot_model": phase_sot_model,
    "sot": phase_sot,
    "train_model": phase_train_model,
    "train": phase_train,
    "profile": phase_profile,
}
DEFAULT_PHASES = ("build", "kernels", "model", "main", "sot_model", "sot",
                  "train_model", "train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these phases (debugging)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import unicorn_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    report = {}
    failed = []
    wanted = DEFAULT_PHASES if args.only is None else ("build", *args.only)
    for name, fn in PHASES.items():
        if name not in wanted:
            continue
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(report)
        except Exception as e:  # report every phase, fail at the end
            import traceback

            traceback.print_exc()
            failed.append(name)
            print(f"== phase {name} FAILED: {type(e).__name__}: {e}")
            if name == "build":
                break
        print(f"== phase {name} {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = list(report.get("kernels", {}).values())
    print(json.dumps({"kernels": kernels}))
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
