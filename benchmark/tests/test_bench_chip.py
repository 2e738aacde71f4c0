"""On the card only (marked `cuda`; each test skips without one): every
cell's control comes out not correct at the cell's own size, and a short
run of every cell comes out correct."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cells():
    return [w["name"] for w in harness.manifest()["workloads"]]


def _run(args, timeout):
    return subprocess.run([sys.executable, *args], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=harness.ROOT))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_control_is_not_correct(workload):
    _need_card()
    out = _run(["benchmark/control.py", "--workload", workload, "--seeds",
                "2147483001"], 1200)
    assert out.returncode == 0, out.stderr[-4000:]
    readings = json.loads(out.stdout.strip().splitlines()[-1])["readings"]
    limits = harness.Cell(workload, harness.manifest()).limits
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_a_short_run_is_correct(workload):
    _need_card()
    out = _run(["benchmark/run.py", "--workload", workload, "--seed",
                "2147483002", "--seconds", "5", "--trace", "0"], 1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
