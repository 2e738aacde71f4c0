"""No module of JAX, jaxlib, flax or the JAX package (`unicorn_tpu`) in a
run's process or the reference's, compared by whole top-level names, and
nothing of the program (`unicorn_torch`) in the reference's."""
from __future__ import annotations

import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT


def _modules_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    `code`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    mods = _modules_after(
        "from benchmark.reference import model, plain, postprocess, losses, "
        "train, tracker, precision\nfrom benchmark import flops, roofline, "
        "weights, synth, trace, readers, peaks")
    assert not mods & set(harness.BANNED)
    assert "unicorn_torch" not in mods


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import torch\ntorch.set_num_threads(2)\n"
        "from benchmark.tests.tiny import tiny_cell, run_cpu\n"
        "out = run_cpu(tiny_cell('mot.tiny.s8'), seconds=1.0, trace=1)\n"
        "out = run_cpu(tiny_cell('train.large.b2'), seconds=1.0, trace=1)\n"
        "from benchmark import harness\nassert not harness.banned_modules()")
    assert "unicorn_torch" in mods
    assert not mods & set(harness.BANNED)


def test_banned_names_are_whole(monkeypatch):
    fake = {"unicorn_torch.ops": 1, "jaxtyping": 1, "flaxen.x": 1,
            "unicorn_tpu_like": 1}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert harness.banned_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"jax.numpy": 1,
                                                      "unicorn_tpu.ops": 1}))
    assert harness.banned_modules() == ["jax", "unicorn_tpu"]
