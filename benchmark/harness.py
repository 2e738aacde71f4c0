"""What every cell shares: finding a cell's files by the names in
BENCHMARK.json, the program's experiment and model with a configuration's
fields, the ban on JAX in the process, and the set-up clock.

Files are found by name, so a later change adds a cell, a traffic mix, a
configuration, a per-layer metric or a cell's limits as new files and new
entries in BENCHMARK.json, and edits nothing here:

- configs/<config>.json            a configuration (BENCHMARK.json `file`)
- traffic/<traffic>.json           a traffic mix; its `kind` names ...
- kinds/<kind>.py                  ... the generator and driver that runs it
- metrics/<metric>.py              a per-layer metric's reader, `read(ctx)`
- limits/<workload>.json           the limits that decide `correct`
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
BANNED = ("jax", "jaxlib", "flax", "unicorn_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def entry(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: str):
    """A Python file as a module of its own (names may hold dots)."""
    key = "benchmark_file_" + os.path.relpath(path, BENCH).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of the manifest with its configuration, traffic mix,
    kind, limits and metrics, all found by name under `bench`."""

    def __init__(self, name: str, man: dict, bench: str = BENCH,
                 root: str = ROOT):
        self.name = name
        self.bench, self.root = bench, root
        self.workload = entry(man["workloads"], name, "workload")
        conf = entry(man["configs"], self.workload["config"], "config")
        self.cfg = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(
            bench, "traffic", self.workload["traffic"] + ".json"))
        self.kind_path = os.path.join(bench, "kinds",
                                      self.traffic["kind"] + ".py")
        self.limits = load_json(os.path.join(bench, "limits", name + ".json"))
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in man["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def kind(self):
        return load_module(self.kind_path)

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench, "metrics",
                                        metric + ".py"))


def program_exp(cfg: dict):
    """The program's experiment `cfg["exp"]` with every field of the
    configuration set on it (a field the experiment lacks is an error)."""
    from unicorn_torch.exp.base import get_exp

    exp = get_exp(exp_name=cfg["exp"])
    for k, v in cfg["exp_fields"].items():
        if not hasattr(exp, k):
            raise AttributeError(f"{cfg['exp']} has no field {k!r}")
        setattr(exp, k, tuple(v) if isinstance(v, list) else v)
    return exp


def program_model(exp, device, serve: bool):
    """The experiment's Unicorn built on `device` (its own initialisation
    runs there, from a generator on the device, before the harness loads
    the seeded weights over it)."""
    import torch

    with torch.device(device):
        return exp.get_model(torch.Generator(device=device), serve=serve)


def banned_modules() -> list:
    """Modules in this process whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's (whole names: `unicorn_torch` is not
    `unicorn_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def process_start_wall() -> float:
    """The wall-clock time this process started, from /proc (a clock tick's
    resolution); the harness's import time where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()

