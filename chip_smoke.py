#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unicorn_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as the port's quickest proof

Phases (each must pass, else the exit code is 1):
  build      the card's name and power limit; every CUDA kernel of csrc/
             built with nvcc (dwconv7x7, msda, correlation), in parallel
  kernels    each kernel against its plain PyTorch version at the main
             paths' shapes and at ragged ones, in bf16 and fp32, with times
             of kernel, plain version and the PyTorch library call that
             computes the same function, and the bound
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
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the rest of the
repo beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
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
    logs = build.build(["dwconv7x7", "msda", "correlation"])
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
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = []
    for check in (kernels_dw7x7, kernels_msda, kernels_correlation):
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
        ker.setdefault(name, {})["launches"] = counts[name]
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


PHASES = {
    "build": phase_card_and_build,
    "kernels": phase_kernels,
    "model": phase_model,
    "main": phase_main,
    "sot_model": phase_sot_model,
    "sot": phase_sot,
    "profile": phase_profile,
}
DEFAULT_PHASES = ("build", "kernels", "model", "main", "sot_model", "sot")


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
