#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unicorn_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as the port's quickest proof

Phases (each must pass, else the exit code is 1):
  1. the card's name and power limit; build every CUDA kernel from csrc/
  2. each kernel against its plain PyTorch version at the main path's
     shapes, in bf16 and fp32, with times of kernel, plain version and the
     PyTorch library call that computes the same function, and the bound
  3. the ConvNeXt-Tiny Unicorn at 800x1280 in bf16 (seeded random weights):
     forward_whole through the kernel vs the same model through the plain
     version, on the card
  4. the main path: MOTDriver.update over synthetic 1080x1920 uint8 frames,
     letterboxed on the card; frames/s, per-stage ms, dets and tracks per
     frame, and the kernels' launch counts (27 dw7x7 launches per frame)
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

# published peaks by card name: (memory bytes/s, fp32 FLOP/s outside the
# tensor cores); NVIDIA data sheets, dense, at the full power limit
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),      # SXM5 (name "NVIDIA H100 80GB HBM3")
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
    key, (bw, fp32) = peaks_for(name)
    print(f"card: {name} | power: {card} | peaks ({key}): "
          f"{bw / 1e12:.2f} TB/s, {fp32 / 1e12:.0f} TFLOP/s fp32 | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build.build(["dwconv7x7"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for n, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {n}: {line}")
    report["card"] = card
    report["peaks"] = (bw, fp32)


# ---------------------------------------------------------------- phase 2
def phase_kernels(report):
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import dwconv7x7 as dw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bw, fp32_peak = report["peaks"]
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
                # one bf16 ulp of the output, plus the bound on two fp32
                # sums of the same 50 terms taken in different orders
                # (50 * 2^-24 * sum|x*w|), which decides outputs near zero
                tol_desc = "1ulp+sum"
                mag = dw.dwconv7x7_plain(x.float().abs(), k.to(dtype).abs(),
                                         b.to(dtype).abs())
                tol = (bf16_ulp(torch.maximum(yk.float().abs(),
                                              yp.float().abs()))
                       + 50 * 2.0 ** -24 * mag)
                nbad = int((diff > tol).sum().item())
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
    print(f"dw7x7 per frame (bf16, 27 launches): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms")
    report["kernels"] = {"dwconv7x7": dict(
        name="dwconv7x7", route="cuda",
        source="unicorn_torch/csrc/dwconv7x7.cu",
        replaces="unicorn_tpu/ops/pallas_convnext.py:196",
        launches=None, max_abs_err=max_err[torch.bfloat16],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                  else "operations"),
        library_ms=tot["library_ms"])}
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")


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
N_FRAMES = 32
FRAME_HW = (1080, 1920)


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


# ------------------------------------------------------ opt-in: profile
def phase_profile(report):
    """torch.profiler over 4 frames of the main path: CUDA time by kernel
    and the device's busy share. Opt-in: --only profile."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicorn_torch.drivers.mot import MOTDriver

    exp, model = _model(report)
    driver = MOTDriver(model, input_size=exp.test_size,
                       num_classes=exp.num_classes, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    rng = np.random.RandomState(2)
    frames = [(rng.rand(*FRAME_HW, 3) * 255).astype(np.uint8)
              for _ in range(6)]
    for f in frames[:2]:
        driver.update(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[2:]:
            driver.update(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: 4 frames, wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_ms:.1f} ms ({dev_ms / (wall * 10):.1f}% of wall), "
          f"{sum(e.count for e in kernels) / 4:.0f} kernels/frame")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / 4e3:8.3f} ms/frame "
              f"{e.count / 4:6.1f}/frame  {e.key[:100]}")


PHASES = {
    "build": phase_card_and_build,
    "kernels": phase_kernels,
    "model": phase_model,
    "main": phase_main,
    "profile": phase_profile,
}
DEFAULT_PHASES = ("build", "kernels", "model", "main")


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
