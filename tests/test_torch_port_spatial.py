"""Spatial partitioning in the port (unicorn_torch/parallel/spatial.py and
rows.py) against the JAX package's spatial_detect_fn
(unicorn_tpu/parallel/spatial.py) on a 4-device CPU mesh, on the CPU.

In-process: the row plan (whole 32-row units, the first ranks taking one
more; its raises), the halo assembly with the exchange replaced by the
stacked edge strips of every rank, against slicing the padded full tensor
(halos deeper than a rank's block, fill 0 and -inf), the halo rows of a
window, make_mesh in one process (one axis and two), a Swin block under
row_sharded on every rank of a plan (the exchange replaced by every rank's
stacked edge strips) against the whole-map block, and the detector at sp =
1 (one process, no group) against the one-card detector.

Four gloo processes that meet in a FileStore, spawned once for the module,
each run spatial_detect_fn on its rows of the frames of four cases:
  * "csp": JAX's fixture (tests/test_spatial.py: CSPDarknet depth 0.33
    width 0.25, H = 128, W = 64, 2 frames): one unit a rank, so the SPP
    pools' 6-row halo comes from several ranks;
  * "csp160": the same model at H = 160, units 2 / 1 / 1 / 1;
  * "convnext": ConvNeXt-Tiny under a width-0.5 PAFPN and head with one
    attention block a level, H = 128: dw7x7's 3-row halo spans three ranks
    at stride 32;
  * "resnet": a ResNet-50 trunk of one block a stage at H = 128 (the 7x7/2
    stem conv and the 3x3/2 max pool), held against the port's one-card
    detector (the JAX Unicorn builds only the full ResNet-50);
  * "swin": the Swin-T trunk under a width-0.5 PAFPN and head, H = 128:
    at stride 4 shifted windows of 7 over 8 rows a rank, at stride 8 over
    4 rows a rank with the wrap-around band holding pad rows, at stride 16
    and 32 windows clamped to the map's width (shift 0) across two ranks.
The weights are the port's seeded init with the obj / cls prediction biases
raised by 6, so that most candidates clear conf_thre; JAX gets them through
unicorn_torch.convert.to_flax, checked against jax.eval_shape of the JAX
model's init_all tree. Bounds, JAX's own (tests/test_spatial.py:59-61):
valid bits equal, dets within rtol 2e-4, atol 2e-3, with every valid
candidate's score clear of conf_thre by 1e-4; every rank returns the same.
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
from jax.sharding import Mesh

from unicorn_torch.convert import to_flax
from unicorn_torch.models.heads import decode_for_inference
from unicorn_torch.ops.nms import postprocess_device
from unicorn_torch.parallel import make_mesh, rows
from unicorn_torch.parallel.mesh import ProcessMesh
from unicorn_torch.parallel.spatial import spatial_detect_fn, spatial_rows
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.parallel import spatial as jspatial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP = 4

# the cases, run as they are by the workers and by this test
COMMON = r'''
import numpy as np
import torch

from unicorn_torch.models.blocks import init_weights
from unicorn_torch.models.resnet import ResNet50
from unicorn_torch.models.unicorn import Unicorn

CSP = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
           width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
           n_layer_att=0, use_attention=False)
CNX = dict(num_classes=1, backbone_name="convnext_tiny", width=0.5,
           in_channels=(192, 384, 768), interact_mode="conv", n_layer_att=1)
R50 = dict(num_classes=1, backbone_name="resnet50", width=0.5,
           in_channels=(512, 1024, 2048), interact_mode="conv",
           n_layer_att=0, use_attention=False)
SWIN = dict(num_classes=1, backbone_name="swin_tiny", width=0.5,
            in_channels=(192, 384, 768), interact_mode="conv", n_layer_att=1)
CASES = {"csp": (CSP, 128, 64, 0), "csp160": (CSP, 160, 64, 0),
         "convnext": (CNX, 128, 64, 1), "resnet": (R50, 128, 64, 2),
         "swin": (SWIN, 128, 64, 3)}
DETECT = dict(num_classes=1, conf_thre=0.01, nms_thre=0.8, n_cand=32,
              max_out=16)


def model(name):
    cfg, _, _, seed = CASES[name]
    torch.set_num_threads(1)
    m = Unicorn(**cfg, generator=torch.Generator().manual_seed(seed))
    if name == "resnet":
        m.backbone.backbone = ResNet50(layers=(1, 1, 1, 1))
        init_weights(m.backbone.backbone,
                     torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for n, p in m.head.named_parameters():
            if n.startswith(("obj_preds.", "cls_preds.")) and \
                    n.endswith(".bias"):
                p.add_(6.0)
    return m.eval()


def frames(name):
    """(2, H, W, 3) float32 in [0, 255)."""
    _, H, W, seed = CASES[name]
    rng = np.random.RandomState(3 + seed)
    return (rng.rand(2, H, W, 3) * 255).astype(np.float32)
'''

WORKER = COMMON + r'''
import sys

from unicorn_torch.parallel import initialize_multihost, make_mesh
from unicorn_torch.parallel.spatial import spatial_detect_fn, spatial_rows

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
initialize_multihost(num_processes=world, process_id=rank, device="cpu",
                     init_method="file://" + store, timeout_s=100)
mesh = make_mesh((world,), ("sp",), device="cpu")
res = {}
for name in CASES:
    x = torch.from_numpy(frames(name)).permute(0, 3, 1, 2)
    start, stop = spatial_rows(mesh, x.shape[2])
    fn = spatial_detect_fn(model(name), mesh, **DETECT)
    dets, valid = fn(x[:, :, start:stop])
    res[name] = dict(dets=dets, valid=valid, rows=(start, stop))
torch.save(res, out)
torch.distributed.destroy_process_group()
'''

common = types.ModuleType("spatial_common")
exec(COMMON, common.__dict__)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------ in-process
@pytest.mark.parametrize("H, n, units", [
    (800, 4, (7, 6, 6, 6)), (800, 2, (13, 12)), (128, 4, (1, 1, 1, 1)),
    (160, 4, (2, 1, 1, 1)), (64, 1, (2,))])
def test_split_units(H, n, units):
    assert rows.split_units(H, n) == units


@pytest.mark.parametrize("H, n, match", [(100, 2, "multiple"),
                                         (64, 4, "fewer")])
def test_split_units_raises(H, n, match):
    with pytest.raises(ValueError, match=match):
        rows.split_units(H, n)


def test_spatial_rows():
    got = [spatial_rows(ProcessMesh(("sp",), {"sp": 4}, object(), r,
                                    torch.device("cpu")), 800)
           for r in range(4)]
    assert got == [(0, 224), (224, 416), (416, 608), (608, 800)]
    plan = rows.RowPlan((7, 6, 6, 6), 1)
    assert plan.bounds(48) == [(0, 56), (56, 104), (104, 152), (152, 200)]
    with pytest.raises(ValueError, match="does not split"):
        plan.bounds(50)


@pytest.mark.parametrize("k, s, p, want", [
    (3, 1, 1, (1, 1)), (3, 2, 1, (1, 0)), (7, 2, 3, (3, 2)),
    (1, 2, 0, (0, 0)), (2, 2, 0, (0, 0)), (13, 1, 6, (6, 6))])
def test_window_rows(k, s, p, want):
    assert rows.window_rows(k, s, p) == want


@pytest.mark.parametrize("H, S, h", [
    (128, 4, 3), (128, 4, 6), (160, 4, 6), (96, 2, 5), (64, 2, 13),
    (800, 4, 3)])
def test_halo_assembly(H, S, h):
    """Every rank's halo from the stacked edge strips of all ranks equals
    the rows around its block in the padded full tensor, on maps of 1, 2, 4
    and 32 rows a unit, for halos above, below and both."""
    units = rows.split_units(H, S)
    gen = torch.Generator().manual_seed(H + S + h)
    for q in (1, 2, 4, 32):
        x = torch.randn((2, 5, H // 32 * q, 7), generator=gen)
        plans = [rows.RowPlan(units, r) for r in range(S)]
        bounds = plans[0].bounds(units[0] * q)
        shards = [x[:, :, s:e] for s, e in bounds]
        strips = torch.stack([rows.edge_strips(b, h) for b in shards])
        for fill in (0.0, float("-inf")):
            xp = torch.nn.functional.pad(x, (0, 0, h, h), value=fill)
            for r, (s, e) in enumerate(bounds):
                for above, below in ((h, h), (h, 0), (0, h), (1, h)):
                    got = rows.halo(shards[r], above, below, fill, plans[r],
                                    gather=lambda _: strips)
                    assert torch.equal(
                        got, xp[:, :, s + h - above:e + h + below]), \
                        (q, fill, r, above, below)


def test_exchange_one_rank_keeps_bits():
    """The int32 exchange keeps every bit of a float: -0.0, a NaN payload,
    denormals, in fp32 and bf16 (a length that is no multiple of 4
    bytes)."""
    x = torch.tensor([-0.0, 1e-40, float("nan"), -3.5, float("-inf")])
    x = x.view(torch.int32)
    x[2] = 0x7FC01234
    x = x.view(torch.float32)
    plan = rows.RowPlan((1,), 0)
    for t in (x, x.to(torch.bfloat16)[:3]):
        got = rows.exchange(t, plan)
        assert got.shape == (1,) + t.shape
        assert torch.equal(got[0].view(torch.uint8), t.view(torch.uint8))


def test_make_mesh_one_process():
    m = make_mesh(device="cpu")
    assert (m.axis_names, m.shape, m.rank, m.group) == (("data",),
                                                       {"data": 1}, 0, None)
    assert (m.coord("data"), m.group_of("data")) == (0, None)
    assert make_mesh((1,), ("sp",), device="cpu").size("sp") == 1
    with pytest.raises(ValueError, match="processes"):
        make_mesh((2,), ("sp",), device="cpu")
    with pytest.raises(ValueError, match="processes"):
        make_mesh((1, 2), ("dcn", "data"), device="cpu")
    m = make_mesh((1, 1), ("dcn", "data"), device="cpu")
    assert (m.axis_names, m.shape, m.rank, m.group) == (
        ("dcn", "data"), {"dcn": 1, "data": 1}, 0, None)
    assert [(m.coord(a), m.group_of(a)) for a in m.axis_names] == \
        [(0, None), (0, None)]
    with pytest.raises(ValueError, match="no axis"):
        m.group_of("sp")


def _rows_of_every_rank(fn, shards, units):
    """fn(shard) on every rank of a plan of `units`, in one process: a first
    pass records what each rank hands the exchange (its outputs dropped),
    a second gives each rank every rank's stacked strips."""
    sent = {}

    def exchange(local, ranks):
        sent[ranks.rank] = local
        if len(sent) < ranks.world:
            return local.new_zeros((ranks.world,) + tuple(local.shape))
        return torch.stack([sent[r] for r in range(ranks.world)])

    out = []
    real = rows.exchange
    rows.exchange = exchange
    try:
        for pass_ in range(2):
            for r, shard in enumerate(shards):
                with rows.row_sharded(rows.RowPlan(units, r)):
                    y = fn(shard)
                if pass_:
                    out.append(y)
    finally:
        rows.exchange = real
    return out


@pytest.mark.parametrize("units, q, W, shift, geometry", [
    ((1, 1, 1, 1), 1, 8, 2, (4, 0, 0)),     # the window clamped to H
    ((1, 1, 1, 1), 4, 8, 3, (7, 3, 5)),     # a wrap band of pad rows
    ((1, 1, 1, 1), 2, 16, 3, (7, 3, 6)),    # a band over all four ranks
    ((7, 6, 6, 6), 1, 40, 3, (7, 3, 3)),    # stride 32 of 800 rows
    ((2, 1, 1, 1), 8, 16, 3, (7, 3, 2)),    # frame rows in the wrap band
    ((1,), 20, 24, 3, (7, 3, 1))])          # one rank: every band its own
def test_swin_block_under_row_sharding(units, q, W, shift, geometry):
    """A SwinBlock on each rank's rows (units of q rows) inside
    row_sharded, every rank's rows together, equals the whole-map block,
    bit for bit, in fp32; `geometry` is the frame's (window, shift, bottom
    pad)."""
    from unicorn_torch.models.swin import SwinBlock

    gen = torch.Generator().manual_seed(q * W + shift)
    blk = SwinBlock(16, 2, 7, shift).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    H = sum(units) * q
    ws, ss, pad_b, _ = blk._geometry(H, W)
    assert (ws, ss, pad_b) == geometry
    x = torch.randn((2, H, W, 16), generator=gen)
    bounds = rows.RowPlan(units, 0).bounds(units[0] * q)
    with torch.no_grad():
        want = blk(x)
        got = _rows_of_every_rank(blk, [x[:, s:e] for s, e in bounds], units)
    assert torch.equal(torch.cat(got, 1), want)


def _one_card(m, x):
    raw, _ = m.forward_whole(x)
    dec = decode_for_inference(raw, (8, 16, 32), mode="mot")
    return postprocess_device(dec, class_agnostic=True, **common.DETECT)


def _assert_matches(dets, valid, dets_1, valid_1):
    """JAX's bounds (tests/test_spatial.py:54-61)."""
    dets, valid = np.asarray(dets), np.asarray(valid)
    dets_1, valid_1 = np.asarray(dets_1), np.asarray(valid_1)
    score = dets_1[..., 4] * dets_1[..., 5]
    thre = common.DETECT["conf_thre"]
    assert (~valid_1.astype(bool) | (np.abs(score - thre) > 1e-4)).all()
    assert valid_1.sum() >= 8
    np.testing.assert_array_equal(valid, valid_1)
    m = valid_1.astype(bool)
    np.testing.assert_allclose(dets[m], dets_1[m], rtol=2e-4, atol=2e-3)


def test_spatial_detect_sp1_matches_one_card():
    """One process, no group: a mesh of one rank runs the exchange code
    (every halo row is the frame's padding; the Swin blocks take every
    band of the frame) and equals the one-card detector, for the
    CSPDarknet and the Swin-T cases."""
    mesh = make_mesh((1,), ("sp",), device="cpu")
    for name in ("csp", "swin"):
        m = common.model(name)
        x = torch.from_numpy(common.frames(name)).permute(0, 3, 1, 2)
        dets, valid = spatial_detect_fn(m, mesh, **common.DETECT)(x)
        with torch.inference_mode():
            _assert_matches(dets, valid, *_one_card(m, x))


# ------------------------------------------------------- four processes
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' outputs, spawned once; the JAX references are made
    while they run."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("spatial")
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp / f"rank{r}.pt") for r in range(SP)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(SP), str(tmp / "store"),
         outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(tmp)) for r in range(SP)]
    try:
        refs = _references()
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(o) for o in outs], refs


def _references():
    """JAX's spatial_detect_fn on a 4-device "sp" mesh for the JAX cases,
    the port's one-card detector for every case."""
    mesh = Mesh(np.asarray(jax.devices()[:SP]), ("sp",))
    refs = {}
    for name, (cfg, H, W, _) in common.CASES.items():
        tm = common.model(name)
        f = common.frames(name)
        with torch.inference_mode():
            one = _one_card(tm, torch.from_numpy(f).permute(0, 3, 1, 2))
        refs[name] = {"one_card": one}
        if name == "resnet":
            continue
        jm = JUnicorn(**cfg)
        params = {"params": to_flax(tm.state_dict())}
        if name != "csp160":      # csp's tree
            shapes = jax.eval_shape(lambda x: jm.init(
                jax.random.PRNGKey(0), x, method=JUnicorn.init_all),
                jnp.zeros((1, H, W, 3)))
            assert jax.tree_util.tree_structure(shapes) == \
                jax.tree_util.tree_structure(params)
        fn = jspatial.spatial_detect_fn(jm, mesh, **common.DETECT)
        refs[name]["jax"] = jax.tree_util.tree_map(np.asarray, fn(
            params, jax.device_put(f, jspatial.spatial_sharding(mesh))))
    return refs


@pytest.mark.parametrize("name", ["csp", "csp160", "convnext", "swin"])
def test_spatial_matches_jax(ranks, name):
    outs, refs = ranks
    _assert_matches(outs[0][name]["dets"], outs[0][name]["valid"],
                    *refs[name]["jax"])


@pytest.mark.parametrize("name", ["csp", "csp160", "convnext", "resnet",
                                  "swin"])
def test_spatial_matches_one_card(ranks, name):
    outs, refs = ranks
    _assert_matches(outs[0][name]["dets"], outs[0][name]["valid"],
                    *refs[name]["one_card"])


@pytest.mark.parametrize("name", ["csp", "csp160", "convnext", "resnet",
                                  "swin"])
def test_ranks_hold_their_rows_and_agree(ranks, name):
    outs, _ = ranks
    H = common.CASES[name][1]
    units = rows.split_units(H, SP)
    starts = np.cumsum((0,) + units) * 32
    assert [o[name]["rows"] for o in outs] == \
        [(int(starts[r]), int(starts[r + 1])) for r in range(SP)]
    for o in outs[1:]:
        assert torch.equal(o[name]["dets"], outs[0][name]["dets"])
        assert torch.equal(o[name]["valid"], outs[0][name]["valid"])
