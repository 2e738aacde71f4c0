"""What the per-layer metric files share: each file under metrics/ is a
`read(ctx)` that returns a number or None (nothing to read), from the
context its cell's kind hands over after a --trace 1 run:

- "spans": {stage: [ms a tick or step]} from the harness's host clocks
  around synchronised stages;
- "trace": the profiled stretch reduced by trace.reduce;
- "rate": the untraced start of the window: {"frames_per_s"} (its first
  third) or {"steps_per_s"} (its first half);
- "flops_per_frame" / "flops_per_step": flops.py's count;
- "peak_mem_bytes_window": torch.cuda.max_memory_allocated over the window;
- "counters": the program's own counters over the window, with "ticks";
- "exp", "batch", "mode": the shapes; "peaks": the card's (peaks.py).
"""
from __future__ import annotations

import statistics

from . import roofline
from .trace import kernel_time


def median_span(ctx, stage):
    xs = ctx.get("spans", {}).get(stage) or []
    return statistics.median(xs) if xs else None


def mfu_pct(ctx, flops_key, rate_key):
    flops, rate = ctx.get(flops_key), ctx.get("rate", {}).get(rate_key)
    if not flops or not rate:
        return None
    return 100.0 * flops * rate / ctx["peaks"]["bf16_flops"]


def idle_pct(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_mem_gib(ctx):
    b = ctx.get("peak_mem_bytes_window")
    return b / 2 ** 30 if b else None


DW7X7_SYMBOLS = ("dw7x7_nhwc_kernel",)


def dw7x7_roofline_pct(ctx):
    n, t = kernel_time(ctx["trace"], DW7X7_SYMBOLS)
    if n == 0 or t <= 0:
        return None
    calls = roofline.dw7x7_calls(ctx["exp"], ctx["batch"], ctx["mode"])
    return 100.0 * n * roofline.dw7x7_bound_per_launch(
        calls, ctx["peaks"]) / t


CORRELATION_TRAIN_SYMBOLS = {"fwd_lse": "fwd_lse_kernel",
                             "bwd_i": "bwd_i_kernel",
                             "bwd_j": "bwd_j_kernel"}


def correlation_train_roofline_pct(ctx):
    bounds = roofline.correlation_train_bounds(ctx["exp"], ctx["batch"],
                                               ctx["peaks"])
    bound = t = 0.0
    for k, sym in CORRELATION_TRAIN_SYMBOLS.items():
        n_k, t_k = kernel_time(ctx["trace"], (sym,))
        bound += n_k * bounds[k]
        t += t_k
    return 100.0 * bound / t if t > 0 else None


def per_tick(ctx, counter):
    c = ctx.get("counters") or {}
    return c[counter] / c["ticks"] if c.get("ticks") else None
