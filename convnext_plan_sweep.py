"""Times the fused ConvNeXt block kernels under other plans than
`unicorn_torch.ops.convnext_block.plan` picks, at the seven shapes of an
800x1280 frame (ops/dwconv7x7.py PATH_SHAPES), B = 1, erf GELU: the sweeps
behind the plan's constants (PERF.md §6). Needs an NVIDIA card.

    python3 convnext_plan_sweep.py [bf16] [fp32]

bf16, at each shape: the plan as picked; the other route where C <=
FUSED_MAX_C; on the split route the first product's row tile (128, 64) and
hidden groups (the most that keep one wave of blocks, and two waves), the
second product's block (64 x 64, 128 x 128) and ring stages (3, 4, 6).
fp32: every (rows, columns) block of 128 or 64 for each of the two
products. Each plan comes from `plan` with its overrides, is checked
against the plain version (chip_smoke.cb_disagreement) and timed with
CUDA-graph replays.
"""
from __future__ import annotations

import itertools
import subprocess
import sys


def sweep(dtype_name: str) -> None:
    import torch

    import chip_smoke as cs
    from unicorn_torch.ops import convnext_block as cb
    from unicorn_torch.ops import dwconv7x7 as dw

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for (H, W, C), n in dw.PATH_SHAPES:
        x = torch.randn(1, H, W, C, device=dev, generator=g).to(dtype)
        p = cs._cb_params(C, g, dev)
        prepared, y = cb.prepare(x, p), torch.empty_like(x)
        yp = cb.convnext_block_plain(x, p, True)
        default = cb.device_plan(x)
        plans = [("as planned", {})]
        if dtype == torch.float32:
            for (m1, n1), (m2, n2) in itertools.product(
                    itertools.product((128, 64), (128, 64)), repeat=2):
                plans.append((f"p1 {m1} x {n1}, p2 {m2} x {n2}",
                              dict(m1=m1, n1=n1, m2=m2, n2=n2)))
        else:
            if C <= cb.FUSED_MAX_C:
                other = "split" if default["route"] == "fused" else "fused"
                plans.append((f"{other} route", dict(route=other)))
            if default["route"] == "split":
                for m1, waves in ((128, 2), (64, 1), (64, 2)):
                    plans.append((f"p1 {m1} rows, {waves} waves",
                                  dict(m1=m1, waves=waves)))
                for m2, st in ((64, 3), (64, 6), (128, 4), (64, 4)):
                    plans.append((f"p2 {m2} x {m2}, {st} stages",
                                  dict(m2=m2, stages2=st)))
        for label, kw in plans:
            try:
                pl = cb.device_plan(x, **kw)
            except ValueError as e:
                print(f"{dtype_name} {H}x{W}x{C} {label:26s} no plan: {e}")
                continue
            buf = cb.scratch(x, pl)
            cb.launch(x, prepared, buf, y, True, pl)
            nbad, _, _ = cs.cb_disagreement(x, p, True, y, yp)
            t = cs.graph_time_ms(
                lambda: cb.launch(x, prepared, buf, y, True, pl), iters=5)
            print(f"{dtype_name} {H}x{W}x{C} {label:26s} {t:.4f} ms  "
                  f"beyond tolerance {nbad}  blocks {pl['grid1']} "
                  f"{pl['grid2']}  plan {pl['ints']}", flush=True)


def main(argv=None) -> int:
    import torch

    args = list(argv if argv is not None else sys.argv[1:]) or ["bf16",
                                                                 "fp32"]
    if not torch.cuda.is_available():
        print("convnext_plan_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name in args:
        sweep(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
