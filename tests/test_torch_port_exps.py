"""The port's experiment loader and its copies of every exps/default/*.py
(unicorn_torch/exp/base.py, unicorn_torch/exp/*.py) against the JAX
package's, on the CPU: get_exp(exp_name=...) for all 18 names (every field
the two share equal; the fields only one side has are listed below with
their reason), loading them with JAX blocked, merge's coercion, get_exp's
other entries, and the dataset groups of the sot_only / mot_only
ablations (ExpTrack.get_dataset, which ExpTrackMask inherits through its
_sot / _mot_dataset_specs).
"""
import glob
import os
import subprocess
import sys

import pytest

from unicorn_torch.exp import base
from unicorn_tpu.exp import base as jbase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(os.path.basename(f)[:-3] for f in
               glob.glob(os.path.join(ROOT, "exps", "default", "*.py")))

# fields only the JAX exps have, and why the port has none
JAX_ONLY = {
    "grid_sample": "set at unicorn_tpu/exp/track.py:82 and read nowhere",
}
# fields only the port's exps have
PORT_ONLY = {}


def test_all_default_exps_are_ported():
    assert len(NAMES) == 18
    ported = {os.path.basename(f)[:-3] for f in glob.glob(
        os.path.join(base.EXP_DIR, "unicorn_*.py"))}
    assert ported == set(NAMES)


def _fields(exp):
    return {k for k in vars(exp) if not k.startswith("_")}


@pytest.mark.parametrize("name", NAMES)
def test_get_exp_matches_jax(name):
    j = jbase.get_exp(exp_name=name)
    t = base.get_exp(exp_name=name)
    assert isinstance(t, base.BaseExp)
    assert type(t).__mro__[1].__name__ == type(j).__mro__[1].__name__
    keys = _fields(j) | _fields(t)
    only_j = {k for k in keys if not hasattr(t, k)}
    only_t = {k for k in keys if not hasattr(j, k)}
    assert only_j <= set(JAX_ONLY) and only_t <= set(PORT_ONLY)
    for k in sorted(keys - only_j - only_t):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("seed", "output_dir", "print_interval", "eval_interval"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.exp_name == name


BLOCKED = r"""
import sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "unicorn_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
from unicorn_torch.exp.base import get_exp
for name in sys.argv[1:]:
    assert get_exp(exp_name=name).exp_name == name
print(len(sys.argv) - 1)
"""


def test_get_exp_loads_every_name_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", BLOCKED, *NAMES], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "18"


MERGE = ["--max_epoch", "3", "input_size", "(640, 640)", "exp_name", "x",
         "--no_such_field", "1", "seed", "5", "data_dir", "/data",
         "bf16", "False", "basic_lr_per_img", "1e-4", "print_interval",
         "often", "in_channels", "[512, 1024, 2048]"]


def test_merge_coerces_as_jax():
    """literal_eval to the field's type, "--" stripped, unknown keys
    ignored, None and string fields kept as strings, an unparsable value
    kept as given."""
    t = base.get_exp(exp_name="unicorn_track_tiny")
    j = jbase.get_exp(exp_name="unicorn_track_tiny")
    t.merge(MERGE)
    j.merge(MERGE)
    assert t.max_epoch == 3 and t.input_size == (640, 640)
    assert t.exp_name == "x" and t.seed == "5" and t.data_dir == "/data"
    assert t.bf16 is False and t.basic_lr_per_img == 1e-4
    assert t.print_interval == "often"
    assert t.in_channels == [512, 1024, 2048]
    assert not hasattr(t, "no_such_field")
    for k in _fields(t):
        assert getattr(t, k) == getattr(j, k), k
    with pytest.raises(ValueError):
        t.merge(["max_epoch"])
    assert "max_epoch                : 3" in repr(t)


def test_get_exp_by_file_and_errors(tmp_path):
    f = tmp_path / "my_exp.py"
    f.write_text("from unicorn_torch.exp.track import ExpTrack\n\n\n"
                 "class Exp(ExpTrack):\n"
                 "    def __init__(self):\n"
                 "        super().__init__()\n"
                 "        self.exp_name = 'mine'\n"
                 "        self.backbone_name = 'resnet50'\n")
    exp = base.get_exp(exp_file=str(f))
    assert exp.exp_name == "mine" and exp.backbone_name == "resnet50"
    assert base.get_exp(exp_name="unicorn-track-r50").exp_name == \
        "unicorn_track_r50"
    with pytest.raises(FileNotFoundError):
        base.get_exp(exp_name="unicorn_track_huge")
    with pytest.raises(ValueError):
        base.get_exp()


class _Seqs:
    """An in-memory sub-dataset: its length is all the groups read."""

    def __len__(self):
        return 5

    def pull_item_omni(self, seq_id, num_frames, *, rng=None):
        raise AssertionError("no item is drawn here")


@pytest.mark.parametrize("name,kw,jkw,groups", [
    ("unicorn_track_tiny_sot_only", "sot", "sot", (True, False)),
    ("unicorn_track_tiny_mot_only", "mot", "mot", (False, True)),
    # JAX's mask exp names its groups vos_datasets / mots_datasets
    ("unicorn_track_tiny_vos_only", "sot", "vos", (True, False)),
    ("unicorn_track_tiny_mots_only", "mot", "mots", (False, True)),
])
def test_ablation_groups_match_jax(name, kw, jkw, groups, tmp_path,
                                   monkeypatch):
    """The ablation drops the other group before anything is built (the
    data root is empty): the port's groups (task 1 SOT / VOS, task 2 MOT /
    MOTS) as JAX's, in JAX's mode."""
    monkeypatch.setenv("UNICORN_DATADIR", str(tmp_path))
    t = base.get_exp(exp_name=name)
    j = jbase.get_exp(exp_name=name)
    got = t.get_dataset(**{f"{kw}_datasets": [_Seqs()]})
    want = j.get_dataset(**{f"{jkw}_datasets": [_Seqs()]})
    assert (got.sot_dataset is not None, got.mot_dataset is not None) == \
        groups == (want.sot_dataset is not None,
                   want.mot_dataset is not None)
    assert got.mode == want.mode == "alter"
    assert len(got) == len(want) == t.samples_per_epoch
