"""The port's training entry points, tools/train.py and
tools/launch_uni.py, on the CPU.

train: tests/test_cli_e2e.py's TRAIN_EXP (its fake SOT / MOT datasets, a
tiny CSPDarknet, one epoch of two iterations at batch 2), importing the
port's exps, runs an epoch and writes `latest`; `--resume` picks it up
(the epoch counter and the optimizer step carry over, nothing more runs);
`-c` without --resume loads its weights for fine-tuning. launch_uni:
subprocess.call patched: each model's stages in the reference's order,
each a `python -m unicorn_torch.tools.train -n <exp> -b B --resume`
process naming an exp of unicorn_torch/exp/, and the chain stops with a
failing stage's exit code.
"""
import os
from unittest import mock

import pytest
import torch

import test_cli_e2e as cli
from unicorn_torch.core.checkpoint import load_checkpoint
from unicorn_torch.exp.base import get_exp
from unicorn_torch.tools import launch_uni
from unicorn_torch.tools import train as ttrain


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_train_one_epoch_then_resume(tmp_path):
    exp_file = tmp_path / "exp_cli_train.py"
    exp_file.write_text(
        cli.TRAIN_EXP.replace("__OUTDIR__", str(tmp_path))
        .replace("unicorn_tpu.", "unicorn_torch.")
        .replace("def pull_item_omni(self, seq_id, num_frames=2):",
                 "def pull_item_omni(self, seq_id, num_frames=2, rng=None):"))
    tr = ttrain.main(["-f", str(exp_file), "-b", "2", "--device", "cpu"])
    out = tmp_path / "cli_train_tiny"
    latest = load_checkpoint(str(out), "latest")
    assert latest["epoch"] == 1 and tr.state.step == 2 == latest["step"]
    resumed = ttrain.main(["-f", str(exp_file), "-b", "2", "--device",
                           "cpu", "--resume"])
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, latest["model"][k]), k
    # -c without --resume: the weights only, a fresh run of one epoch
    tuned = ttrain.main(["-f", str(exp_file), "-b", "2", "--device", "cpu",
                         "-c", str(out / "latest"), "--seed", "3"])
    assert tuned.start_epoch == 0 and tuned.state.step == 2
    assert tuned.exp.seed == 3


def test_launch_uni_stages(capsys):
    calls = []

    def call(cmd):
        calls.append(cmd)
        return 0

    with mock.patch.object(launch_uni.subprocess, "call", call):
        launch_uni.main(["--model", "tiny", "-b", "4"])
        launch_uni.main(["--model", "r50", "--stage", "track"])
    names = [c[c.index("-n") + 1] for c in calls]
    assert names == ["unicorn_det_convnext_tiny_800x1280",
                     "unicorn_inst_convnext_tiny_800x1280",
                     "unicorn_track_tiny", "unicorn_track_tiny_mask",
                     "unicorn_track_r50"]
    for c in calls:
        assert c[1:3] == ["-m", "unicorn_torch.tools.train"]
        assert c[-3:] == ["-b", c[-2], "--resume"]
    assert [c[-2] for c in calls] == ["4"] * 4 + ["16"]
    for stages in launch_uni.STAGES.values():
        for name in stages.values():
            assert get_exp(exp_name=name).exp_name
    assert "launching:" in capsys.readouterr().out


def test_launch_uni_stops_at_a_failing_stage():
    codes = iter([0, 3, 0])
    calls = []

    def call(cmd):
        calls.append(cmd)
        return next(codes)

    with mock.patch.object(launch_uni.subprocess, "call", call):
        with pytest.raises(SystemExit) as e:
            launch_uni.main(["--model", "large"])
    assert e.value.code == 3 and len(calls) == 2
