"""Data parallelism in the port (unicorn_torch/parallel/, the Trainer and the
train steps) against one process and against the JAX package's mesh step,
on the CPU.

The JAX package's tests/test_multihost.py cases: a single process forms no
group; `local_batch_slice` gives the whole batch to one process and raises
on a batch that does not divide over the processes, and so does the
Trainer.

One data-parallel uni step (tests/test_multihost.py:29's model: the tiny
CSPDarknet Unicorn, 8 classes, 64x64 pairs; mhs and L1 on) over two gloo
processes that meet in a FileStore: a global batch of 4 pairs whose halves
differ in their SOT / MOT counts (2 / 0 against 1 / 1) and in their
foreground counts, so that a rank that normalised by its own counts would
step elsewhere. Held against the port's one-process step on the whole
batch and against JAX's make_uni_train_step on a 2-device "data" mesh,
with the bounds of the train-step parity tests
(tests/test_torch_port_train_step.py):
  * the two ranks end with equal weights, EMA and loss dicts;
  * the summed gradients within 1e-3 of each leaf's largest magnitude of
    the one-process step's, the loss dict within rtol 1e-4;
  * the loss dict against JAX's within rtol 1e-4, and the weights after
    the AdamW update within 2.01 lr of JAX's, within 2e-2 lr where the
    gradient is at least 1e-2 of its leaf's largest;
and the average of the halves' own steps (a DDP average of per-rank
normalised losses) is shown to miss the global gradient by more than that
bound, so that the comparison can see the normalisers.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from unicorn_torch.convert import to_flax
from unicorn_torch.core.trainer import Trainer
from unicorn_torch.parallel import mesh
from unicorn_torch.parallel.multihost import (initialize_multihost,
                                              local_batch_slice)
from unicorn_tpu.core import train_state as jts
from unicorn_tpu.core.train_step import make_uni_train_step as j_make_step
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the model, optimizer and global batch, run as they are by the workers and
# by this test
COMMON = r'''
import numpy as np
import torch

from unicorn_torch.core import train_state as tts
from unicorn_torch.core.train_step import make_uni_train_step
from unicorn_torch.models.unicorn import Unicorn

H = W = 64
CFG = dict(num_classes=8, backbone_name="csp_darknet", depth=0.33,
           width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
           n_layer_att=0, use_attention=False)
LOSS_KW = dict(use_l1=True, num_classes=8, mhs=True)
TASKS = (1, 1, 1, 2)


def lr_fn(count):
    return 1e-3 * (1.0 + count)


def global_batch():
    """4 pairs: SOT pairs of one box (sizes differ, so do their foreground
    counts), a MOT pair of 4 boxes with shuffled ids."""
    rng = np.random.RandomState(0)
    images = (rng.rand(4, 2, H, W, 3) * 255).astype(np.float32)
    targets = np.zeros((4, 2, 6, 6), np.float32)
    for b, task in enumerate(TASKS):
        n = 1 if task == 1 else 4
        cxy = rng.uniform(0.3, 0.7, (n, 2)) * [W, H]
        wh = rng.uniform(10, 40, (n, 2)) * (1 + b)
        wh = np.minimum(wh, 56)
        for f in range(2):
            targets[b, f, :n, 0] = rng.randint(0, 8, n) if task == 2 else 0
            targets[b, f, :n, 1:3] = cxy + f * rng.uniform(-2, 2, (n, 2))
            targets[b, f, :n, 3:5] = wh
            targets[b, f, :n, 5] = np.arange(1, n + 1)
        if task == 2:
            targets[b, 1, :n, 5] = np.roll(targets[b, 1, :n, 5], 1)
    return images, targets, np.asarray(TASKS, np.int32)


def torch_batch(images, targets, tasks):
    return (torch.from_numpy(images).permute(0, 1, 4, 2, 3).contiguous(),
            torch.from_numpy(targets), torch.from_numpy(tasks).long())


def one_step(batch):
    """A fresh seeded model's uni step on `batch` -> the gradients it
    applied, its weights and EMA after the update, its loss dict."""
    torch.set_num_threads(1)
    model = Unicorn(**CFG, generator=torch.Generator().manual_seed(0))
    tx = tts.make_optimizer(lr_fn, kind="adamw", weight_decay=5e-4,
                            no_decay_mask_fn=tts.default_wd_mask)
    state = tts.TrainState.create(model.train(), tx, device="cpu")
    grads, apply = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
        return apply()

    state.apply_gradients = capture
    _, loss_dict = make_uni_train_step((H, W), **LOSS_KW)(state, *batch)
    return dict(grads=grads, params=dict(state.model.state_dict()),
                ema=dict(state.ema_model.state_dict()),
                loss={k: float(v) for k, v in loss_dict.items()})
'''

WORKER = COMMON + r'''
import sys

from unicorn_torch.parallel import initialize_multihost, shard_batch

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_multihost(num_processes=2, process_id=rank, device="cpu",
                     init_method="file://" + store, timeout_s=100)
torch.save(one_step(torch_batch(*shard_batch(global_batch()))), out)
torch.distributed.destroy_process_group()
'''

common = types.ModuleType("dp_common")
exec(COMMON, common.__dict__)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_initialize_multihost_noops_single_process():
    assert initialize_multihost(device="cpu") is None
    assert not torch.distributed.is_initialized()
    assert (mesh.world(), mesh.rank()) == (1, 0)


def test_local_batch_slice(monkeypatch):
    assert local_batch_slice(16) == (0, 16)
    monkeypatch.setattr(mesh, "world", lambda: 4)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    with pytest.raises(ValueError, match="divide evenly"):
        local_batch_slice(30)
    assert local_batch_slice(32) == (8, 8)
    x = np.arange(32)
    (got,) = mesh.shard_batch((x,))
    np.testing.assert_array_equal(got, x[8:16])


def test_trainer_rejects_indivisible_batch(monkeypatch, tmp_path):
    import unicorn_torch.core.trainer as trainer_mod

    exp = types.SimpleNamespace(max_epoch=1, input_size=(64, 64),
                                output_dir=str(tmp_path), exp_name="dp",
                                samples_per_epoch=24)
    for mod in (trainer_mod, mesh):
        monkeypatch.setattr(mod, "world", lambda: 4)
    with pytest.raises(ValueError, match="divide evenly"):
        Trainer(exp, {"batch_size": 6}, device="cpu")
    tr = Trainer(exp, {"batch_size": 8}, device="cpu")
    assert (tr.world, tr.local_batch_size, tr.iters_per_epoch) == (4, 2, 3)


def _leaf_shares(got, ref):
    return {n: float((got[n] - g).abs().max() / g.abs().max().clamp_min(
        1e-12)) for n, g in ref.items()}


def _jax_mesh_step():
    jm = JUnicorn(**common.CFG)
    tm = common.Unicorn(**common.CFG,
                        generator=torch.Generator().manual_seed(0))
    params = {"params": to_flax(tm.state_dict())}
    tx = jts.make_optimizer(common.lr_fn, kind="adamw", weight_decay=5e-4,
                            no_decay_mask_fn=jts.default_wd_mask)
    state = jts.TrainState.create(params, tx)
    dmesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    repl, sh = NamedSharding(dmesh, P()), NamedSharding(dmesh, P("data"))
    state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl) if hasattr(x, "shape") else x,
        state)
    batch = [jax.device_put(jnp.asarray(a), sh)
             for a in common.global_batch()]
    step = j_make_step(jm, (common.H, common.W), donate=False,
                       **common.LOSS_KW)
    with dmesh:
        state, loss_dict = step(state, *batch)
    return state, {k: float(v) for k, v in loss_dict.items()}


def test_two_process_dp_uni_step(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(tmp_path / "store"),
         outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(tmp_path)) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    ranks = [torch.load(o) for o in outs]

    # the two ranks hold one state
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for key in ("grads", "params", "ema"):
        for n, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][n]), (key, n)

    batch = common.torch_batch(*common.global_batch())
    one = common.one_step(batch)
    dp = ranks[0]
    assert set(dp["grads"]) == set(one["grads"])
    shares = _leaf_shares(dp["grads"], one["grads"])
    worst = max(shares, key=shares.get)
    assert shares[worst] <= 1e-3, (worst, shares[worst])
    assert set(dp["loss"]) == set(one["loss"])
    for k, v in one["loss"].items():
        np.testing.assert_allclose(dp["loss"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    # a rank normalising by its own half would step elsewhere
    halves = [common.one_step(tuple(t[h * 2:h * 2 + 2] for t in batch))
              for h in range(2)]
    naive = {n: (halves[0]["grads"][n] + halves[1]["grads"][n]) / 2
             for n in one["grads"]}
    assert max(_leaf_shares(naive, one["grads"]).values()) > 1e-2

    jstate, jloss = _jax_mesh_step()
    assert set(jloss) == set(dp["loss"])
    for k, v in jloss.items():
        np.testing.assert_allclose(dp["loss"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    got = {"/".join(str(p.key) for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_leaves_with_path(
               to_flax(dp["params"]))}
    grads = {"/".join(str(p.key) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(
                 to_flax(dp["grads"]))}
    lr = common.lr_fn(0)
    for path, v in jax.tree_util.tree_leaves_with_path(
            jstate.params["params"]):
        name = "/".join(str(p.key) for p in path)
        d = np.abs(got[name] - np.asarray(v))
        assert d.max() <= 2.01 * lr, (name, d.max())
        g = np.abs(grads[name])
        sure = g >= 1e-2 * max(g.max(), 1e-30)
        if sure.any():
            assert d[sure].max() <= 2e-2 * lr + 1e-6 * np.abs(
                np.asarray(v)[sure]).max(), (name, d[sure].max())
