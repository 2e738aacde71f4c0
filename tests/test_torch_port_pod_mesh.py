"""The (dcn, data) pod mesh in the port (unicorn_torch/parallel/multihost.py
`make_pod_mesh`, parallel/mesh.py's meshes of several axes and the
hierarchical gradient sum of the train steps) against one process and
against the JAX package's pod-mesh step (tests/test_multihost.py:29), on
the CPU.

In-process: a single process gives a (1, 1) mesh without groups; ranks
group by torchrun's GROUP_RANK, else by host name, and nodes of unequal
sizes raise.

Four gloo processes that meet in a FileStore, with torchrun's node
variables set as two nodes of two ranks (GROUP_RANK = rank % 2, so that
the nodes hold ranks {0, 2} and {1, 3} and the mesh must reorder them),
form the (2, 2) pod mesh and run one uni step of tests/test_multihost.py's
model (the tiny CSPDarknet Unicorn, 8 classes, 64x64 pairs; mhs and L1
on) on a global batch of 8 pairs, SOT and MOT mixed, two pairs a rank.
Checked: each rank's coordinates and per-axis groups; the
gradient sums run over "data" first, then "dcn"; the ranks end with equal
weights, EMA and loss dicts; against the port's one-process step on the
whole batch, the gradients within 1e-3 of each leaf's largest magnitude
and the loss dict within rtol 1e-4; against JAX's make_uni_train_step on
a 2x4 ("dcn", "data") CPU mesh, the bounds of
tests/test_torch_port_data_parallel.py (the loss dict within rtol 1e-4,
the weights after the AdamW update within 2.01 lr, within 2e-2 lr where
the gradient is at least 1e-2 of its leaf's largest).
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
from unicorn_torch.parallel import make_pod_mesh, multihost
from unicorn_tpu.core import train_state as jts
from unicorn_tpu.core.train_step import make_uni_train_step as j_make_step
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

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
TASKS = (1, 2, 1, 1, 2, 1, 2, 2)


def lr_fn(count):
    return 1e-3 * (1.0 + count)


def global_batch():
    """8 pairs: SOT pairs of one box, MOT pairs of 3 boxes with shuffled
    ids, of sizes that differ from pair to pair (so do the ranks'
    foreground and task counts)."""
    rng = np.random.RandomState(1)
    images = (rng.rand(8, 2, H, W, 3) * 255).astype(np.float32)
    targets = np.zeros((8, 2, 5, 6), np.float32)
    for b, task in enumerate(TASKS):
        n = 1 if task == 1 else 3
        cxy = rng.uniform(0.3, 0.7, (n, 2)) * [W, H]
        wh = np.minimum(rng.uniform(10, 30, (n, 2)) * (1 + b % 3), 56)
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


def one_step(batch, mesh=None):
    """A fresh seeded model's uni step on `batch` (given `mesh`) -> the
    gradients it applied, its weights and EMA after the update, its loss
    dict."""
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
    step = make_uni_train_step((H, W), mesh=mesh, **LOSS_KW)
    _, loss_dict = step(state, *batch)
    return dict(grads=grads, params=dict(state.model.state_dict()),
                ema=dict(state.ema_model.state_dict()),
                loss={k: float(v) for k, v in loss_dict.items()})
'''

WORKER = COMMON + r'''
import os
import sys

import torch.distributed as dist

from unicorn_torch.parallel import (initialize_multihost, make_pod_mesh,
                                    shard_batch)

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
initialize_multihost(num_processes=world, process_id=rank, device="cpu",
                     init_method="file://" + store, timeout_s=100)
mesh = make_pod_mesh(device="cpu")
res = dict(shape=mesh.shape, coords={a: mesh.coord(a) for a in
                                     mesh.axis_names},
           groups={a: dist.get_process_group_ranks(mesh.group_of(a))
                   for a in mesh.axis_names})
# the groups of the all-reduces of the step's one gradient buffer (the
# largest it sums)
reduced, real = [], dist.all_reduce


def spy(t, *args, group=None, **kwargs):
    reduced.append((t.numel(), dist.get_process_group_ranks(
        group or dist.group.WORLD)))
    return real(t, *args, group=group, **kwargs)


dist.all_reduce = spy
res.update(one_step(torch_batch(*shard_batch(global_batch())), mesh))
dist.all_reduce = real
n = max(k for k, _ in reduced)
res["grad_sums"] = [g for k, g in reduced if k == n]
torch.save(res, out)
dist.destroy_process_group()
'''

common = types.ModuleType("pod_common")
exec(COMMON, common.__dict__)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------ in-process
def test_make_pod_mesh_one_process(monkeypatch):
    """A single process (JAX's single slice): a (1, 1) mesh, groups None,
    with torchrun's node variables or without them."""
    for env in ({}, {"GROUP_RANK": "0", "LOCAL_WORLD_SIZE": "1"}):
        for k in ("GROUP_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        m = make_pod_mesh(device="cpu")
        assert (m.axis_names, m.shape, m.group) == (
            ("dcn", "data"), {"dcn": 1, "data": 1}, None)
        assert [(m.coord(a), m.group_of(a)) for a in m.axis_names] == \
            [(0, None), (0, None)]
    assert make_pod_mesh(("x", "y"), device="cpu").axis_names == ("x", "y")


@pytest.mark.parametrize("env, every, want", [
    ({"GROUP_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     [(1, 2), (0, 2), (1, 2), (0, 2)], [1, 0, 1, 0]),
    ({}, [("b", None), ("a", None), ("b", None), ("a", None)],
     [0, 1, 0, 1]),
    ({"GROUP_RANK": "0", "LOCAL_WORLD_SIZE": "2"},
     [(0, 2), (0, 2), (1, 2)], ValueError),
    ({"GROUP_RANK": "0", "LOCAL_WORLD_SIZE": "3"},
     [(0, 3), (0, 3), (1, 3), (1, 3)], ValueError),
    ({}, [("a", None), ("a", None), ("b", None)], ValueError)])
def test_pod_mesh_nodes(monkeypatch, env, every, want):
    """Every rank's node: torchrun's GROUP_RANK in its order, else the host
    names in the order of their lowest rank; unequal nodes, or nodes that
    disagree with LOCAL_WORLD_SIZE, raise."""
    for k in ("GROUP_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(multihost, "_group_up", lambda: True)
    monkeypatch.setattr(multihost, "world", lambda: len(every))

    def gather(out, mine):
        assert mine == ((int(env["GROUP_RANK"]), int(env["LOCAL_WORLD_SIZE"]))
                        if env else (multihost.socket.gethostname(), None))
        out[:] = every

    monkeypatch.setattr(multihost.dist, "all_gather_object", gather)
    if want is ValueError:
        with pytest.raises(ValueError, match="unequal"):
            multihost._nodes()
    else:
        assert multihost._nodes() == want


# ------------------------------------------------------- four processes
def _jax_pod_step():
    """JAX's uni step on a 2x4 ("dcn", "data") CPU mesh, the batch over both
    axes, as tests/test_multihost.py runs it, on the port's seeded
    weights."""
    jm = JUnicorn(**common.CFG)
    tm = common.Unicorn(**common.CFG,
                        generator=torch.Generator().manual_seed(0))
    params = {"params": to_flax(tm.state_dict())}
    tx = jts.make_optimizer(common.lr_fn, kind="adamw", weight_decay=5e-4,
                            no_decay_mask_fn=jts.default_wd_mask)
    state = jts.TrainState.create(params, tx)
    pmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                 ("dcn", "data"))
    repl = NamedSharding(pmesh, P())
    sh = NamedSharding(pmesh, P(("dcn", "data")))
    state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl) if hasattr(x, "shape") else x,
        state)
    batch = [jax.device_put(jnp.asarray(a), sh)
             for a in common.global_batch()]
    step = j_make_step(jm, (common.H, common.W), donate=False,
                       **common.LOSS_KW)
    with pmesh:
        state, loss_dict = step(state, *batch)
    return state, {k: float(v) for k, v in loss_dict.items()}


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """The four ranks' results, spawned once; the one-process step and
    JAX's pod-mesh step are made while they run."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("pod")
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, OMP_NUM_THREADS="1", GROUP_RANK=str(r % 2),
                   LOCAL_RANK=str(r // 2), LOCAL_WORLD_SIZE="2",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(r), str(WORLD),
             str(tmp / "store"), outs[r]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp)))
    try:
        one = common.one_step(common.torch_batch(*common.global_batch()))
        jax_ref = _jax_pod_step()
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(o) for o in outs], one, jax_ref


def test_pod_mesh_groups(pod):
    """Node 0 holds ranks 0 and 2, node 1 ranks 1 and 3: mesh rows
    [[0, 2], [1, 3]]; "data" runs along a node, "dcn" across."""
    ranks, _, _ = pod
    rows_ = [[0, 2], [1, 3]]
    for r, res in enumerate(ranks):
        i, j = r % 2, r // 2
        assert res["shape"] == {"dcn": 2, "data": 2}
        assert res["coords"] == {"dcn": i, "data": j}
        assert res["groups"] == {"data": rows_[i],
                                 "dcn": sorted(row[j] for row in rows_)}


def test_pod_mesh_sums_data_then_dcn(pod):
    ranks, _, _ = pod
    for res in ranks:
        assert res["grad_sums"] == [res["groups"]["data"],
                                    res["groups"]["dcn"]]


def test_pod_mesh_ranks_agree(pod):
    ranks, _, _ = pod
    for res in ranks[1:]:
        assert res["loss"] == ranks[0]["loss"]
        for key in ("grads", "params", "ema"):
            for n, v in ranks[0][key].items():
                assert torch.equal(v, res[key][n]), (key, n)


def _leaf_shares(got, ref):
    return {n: float((got[n] - g).abs().max() / g.abs().max().clamp_min(
        1e-12)) for n, g in ref.items()}


def test_pod_mesh_step_matches_one_process(pod):
    ranks, one, _ = pod
    dp = ranks[0]
    assert set(dp["grads"]) == set(one["grads"])
    shares = _leaf_shares(dp["grads"], one["grads"])
    worst = max(shares, key=shares.get)
    assert shares[worst] <= 1e-3, (worst, shares[worst])
    assert set(dp["loss"]) == set(one["loss"])
    for k, v in one["loss"].items():
        np.testing.assert_allclose(dp["loss"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_pod_mesh_step_matches_jax(pod):
    ranks, _, (jstate, jloss) = pod
    dp = ranks[0]
    assert set(jloss) == set(dp["loss"])
    for k, v in jloss.items():
        np.testing.assert_allclose(dp["loss"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    def by_path(tree):
        return {"/".join(str(p.key) for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}

    got, grads = by_path(to_flax(dp["params"])), by_path(to_flax(dp["grads"]))
    lr = common.lr_fn(0)
    for name, v in by_path(jstate.params["params"]).items():
        d = np.abs(got[name] - v)
        assert d.max() <= 2.01 * lr, (name, d.max())
        g = np.abs(grads[name])
        sure = g >= 1e-2 * max(g.max(), 1e-30)
        if sure.any():
            assert d[sure].max() <= 2e-2 * lr + 1e-6 * np.abs(
                v[sure]).max(), (name, d[sure].max())
