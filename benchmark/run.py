"""Run one cell of the benchmark of unicorn_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. Looks up the cell in BENCHMARK.json, runs its
traffic mix's kind (set-up, warm-up, then a window of --seconds), checks
what the window produced against the plain reference, and prints as the
last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `checks` (each number compared, with its limit). The checks are
also the last lines of standard error. Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), or when JAX or the
JAX package is loaded in the process once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# caches at fixed paths inside the checkout (the nvcc builds live in the
# program's own unicorn_torch/csrc/_build/)
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(_HERE, ".cache", "triton"))
os.environ.setdefault("USE_FLAX", "0")

from benchmark import harness, peaks  # noqa: E402


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or what it said."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi: {e!r}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    cell = harness.Cell(args.workload, harness.manifest())
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), this "
              f"machine has {n}", file=sys.stderr)
        return 3
    out = cell.kind().run(cell, args, device=torch.device("cuda", 0),
                          start_wall=harness.process_start_wall())
    banned = harness.banned_modules()
    if banned:
        print(f"benchmark: modules of {banned} are loaded in the process",
              file=sys.stderr)
        return 4

    if args.trace:
        ctx = out["layer_ctx"]
        ctx["peaks"] = peaks.peaks_for(torch.cuda.get_device_name(0))
        print(f"card: {card_line()}; shares of the peaks {ctx['peaks']}",
              file=sys.stderr)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    checks = out["checks"]
    correct = out["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if args.trace:
        tr = out["layer_ctx"]["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}"
              f"{'' if v <= lim else '  FAIL'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
