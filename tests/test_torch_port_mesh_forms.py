"""The port's serving and eval forms over a process mesh (MultiStreamMOT
over a "stream" mesh, the three seq-parallel functions and both lockstep
runners over a "seq" mesh, COCOEvaluator over a "data" mesh) against the
JAX package's mesh forms on a 2-device CPU mesh (tests/test_stream.py:41,
tests/test_seq_parallel.py, tests/test_coco_evaluator_e2e.py:99), on the
CPU.

Two gloo processes that meet in a FileStore, spawned once for the module,
each make the meshes with unicorn_torch.parallel.make_mesh and run every
form; the JAX references and the port's one-card forms are made while they
run. Models: the JAX seq-parallel tests' tiny Unicorn (CSPDarknet depth
0.33 width 0.25, "conv" interaction, 64x64), for VOS with the mask head
and the RAFT up-mask at rate 4, from the port's seeded init (the obj / cls
biases raised by 6 for the streams, so that tracks form); JAX gets the same
weights through unicorn_torch.convert.to_flax.

Cases and bounds.
  * MultiStreamMOT, 4 streams over 2 ranks, 4 ticks: each rank's 2
    streams equal the port's one-card MultiStreamMOT at 2 streams on the
    same frames; all 4 against JAX's tick over a 2-device "stream" mesh
    at the streaming parity bounds (tests/test_torch_port_parallel_
    stream.py `_compare`: valid rows and ids equal, boxes within rtol 1e-4
    + 5e-4 px, scores within 1e-4);
  * the seq-parallel functions, 4 sequences over 2 ranks: each rank
    returns all 4, its 2 equal to the port's one-card function at batch 2;
    against JAX's at the port's SOT / VOS driver parity bounds (boxes
    within 1e-2 px, scores within 1e-4, class ids and valid equal, mask
    probabilities within 1e-4);
  * the runners, 2 slots (one a rank) over SOT sequences of 3, 5, 4 and 1
    frames and VOS sequences of 3, 4 (a mask every frame), 3 (an object
    entering on frame 2), 1 and 5 frames: boxes within 1e-2 px of JAX's
    mesh runner, label maps equal to JAX's on at least 99% of each frame's
    pixels (tests/test_torch_port_harness_runners.py's bounds); every
    sequence's file written once, by its rank;
  * COCOEvaluator, 7 images, batch 4 over 2 ranks (shares of 4 and 3, a
    short last batch): AP within 1e-9 of JAX's mesh eval (8 devices, batch
    8, the last batch padded), tests/test_coco_evaluator_e2e.py:99's bound;
and the two ranks return the same from every form.
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

import test_coco_evaluator_e2e as coco_cases
from unicorn_torch.convert import to_flax
from unicorn_torch.data.image_io import read_indexed_mask
from unicorn_torch.drivers.seq_parallel import make_sot_seq_parallel_fn
from unicorn_torch.drivers.stream import MultiStreamMOT as TMulti
from unicorn_torch.harness import running as trun
from unicorn_torch.parallel import ProcessMesh
from unicorn_tpu.drivers import seq_parallel as jsp
from unicorn_tpu.drivers.sot import SOTDriver as JSOTDriver
from unicorn_tpu.drivers.stream import MultiStreamMOT as JMulti
from unicorn_tpu.drivers.vos import VOSDriver as JVOSDriver
from unicorn_tpu.evaluators.coco_evaluator import COCOEvaluator as JCOCO
from unicorn_tpu.harness import datasets as jds
from unicorn_tpu.harness import running as jrun
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_RANKS = 2

# models, inputs and sequences, made as they are by the workers and by
# this test
COMMON = r'''
import os

import numpy as np
import torch

from unicorn_torch.drivers.sot import SOTDriver
from unicorn_torch.drivers.vos import VOSDriver
from unicorn_torch.harness.datasets import Sequence
from unicorn_torch.models.unicorn import Unicorn

H = W = 64
S, K, TICKS = 4, 3, 4
TINY = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
            width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
            n_layer_att=0, use_attention=False)
MASK = dict(TINY, use_mask=True, use_raft=True, up_rate=4)
KW = dict(input_size=(H, W), num_classes=1, conf_thre=0.3, nms_thre=0.65,
          track_thresh=0.5, max_dets=16, max_tracks=16, n_cand=32)
VOS_DRV = dict(conf_thre=0.0, use_raft=True, up_rate=4)
SOT_LENGTHS = (3, 5, 4, 1)
VOS_SEQS = ((3, False, False), (4, False, True), (3, True, False),
            (1, False, False), (5, False, False))  # frames, entry, davis
COCO_IMAGES, COCO_BATCH, TEST_SIZE = 7, 4, (64, 64)


def model(cfg, seed, raised=False):
    torch.set_num_threads(1)
    m = Unicorn(**cfg, generator=torch.Generator().manual_seed(seed))
    if raised:
        with torch.no_grad():
            for n, p in m.head.named_parameters():
                if n.startswith(("obj_preds.", "cls_preds.")) and \
                        n.endswith(".bias"):
                    p.add_(6.0)
    return m.eval()


def stream_frames():
    """(S, TICKS, H, W, 3) float32 panning textures."""
    out = []
    for s in range(S):
        rng = np.random.RandomState(10 + s)
        base = (rng.rand(H, W + 3 * TICKS, 3) * 255).astype(np.uint8)
        out.append(np.stack([base[:, 3 * t:3 * t + W]
                             for t in range(TICKS)]))
    return np.stack(out).astype(np.float32)


def sot_inputs():
    """S (first frame, cxcywh box, next frame), uint8."""
    rng = np.random.RandomState(0)
    out = []
    for s in range(S):
        f0 = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        box = (20.0 + 4 * s, 24.0 + 3 * s, 16.0, 12.0)
        out.append((f0, box, (rng.rand(H, W, 3) * 255).astype(np.uint8)))
    return out


def vos_inputs():
    """S (first frame, (K, H, W) masks, next frame)."""
    rng = np.random.RandomState(1)
    out = []
    for s in range(S):
        f0 = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        masks = np.zeros((K, H, W), np.float32)
        masks[0, 8 + s:28 + s, 10:30] = 1.0
        masks[1, 36:56, 30 - s:50 - s] = 1.0
        masks[2, 20:32, 40 + s:56] = 1.0
        out.append((f0, masks, (rng.rand(H, W, 3) * 255).astype(np.uint8)))
    return out


def sot_driver(m):
    return SOTDriver(m, input_size=(H, W), conf_thre=0.0, max_inst=3,
                     device="cpu")


def vos_driver(m):
    return VOSDriver(m, input_size=(H, W), max_objects=K, device="cpu",
                     **VOS_DRV)


def sot_refs(dt):
    """The stacked references and the preprocessed next frames."""
    refs, imgs = [], []
    for f0, (cx, cy, w, h), f1 in sot_inputs():
        refs.append(dt.init_refs(f0, [cx - w / 2, cy - h / 2, w, h]))
        imgs.append(dt.preprocess(f1)[0])
    return (torch.stack([r[0] for r in refs]),
            torch.stack([r[1] for r in refs]), torch.cat(imgs))


def vos_refs(dt):
    refs, imgs = [], []
    for f0, masks, f1 in vos_inputs():
        refs.append(dt.init_fn(dt.preprocess(f0)[0], torch.from_numpy(masks)))
        imgs.append(dt.preprocess(f1)[0])
    return (torch.stack([r[0] for r in refs]),
            torch.stack([r[1] for r in refs]), torch.cat(imgs))


def sot_seqs(root, write=False):
    """Sequences of JPEGs at the input size (so that the two packages'
    letterboxes are the identity): over 2 slots a refill, and a sequence
    that ends at its first frame."""
    rng = np.random.RandomState(3)
    seqs = []
    for si, n in enumerate(SOT_LENGTHS):
        paths = []
        for t in range(n):
            img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
            x, y = 8 + 3 * t + 2 * si, 6 + 2 * t
            img[y:y + 14, x:x + 16] = [240, 200, 60]
            paths.append(os.path.join(root, f"s{si}_f{t}.jpg"))
            if write:
                import cv2
                cv2.imwrite(paths[-1], img)
        seqs.append(Sequence(name=f"seq{si}", frames=paths,
                             ground_truth_rect=np.array(
                                 [[8.0 + 2 * si, 6.0, 16.0, 14.0]])))
    return seqs


def vos_seqs(root, write=False):
    rng = np.random.RandomState(4)
    seqs = []
    for si, (n, mid_entry, davis_gt) in enumerate(VOS_SEQS):
        fdir = os.path.join(root, f"v{si}")
        frames, masks = [], []
        if write:
            import cv2
            os.makedirs(fdir)
        for t in range(n):
            img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
            x, y = 8 + 2 * t + 2 * si, 6 + t
            img[y:y + 14, x:x + 16] = [240, 200, 60]
            frames.append(os.path.join(fdir, f"f{t}.jpg"))
            if write:
                cv2.imwrite(frames[-1], img)
        ann = np.zeros((H, W), np.uint8)
        ann[6:20, 8 + 2 * si:24 + 2 * si] = 1
        ann[30:44, 30:46] = 2
        masks.append(os.path.join(fdir, "m0.png"))
        if write:
            cv2.imwrite(masks[-1], ann)
        if davis_gt:
            for t in range(1, n):
                masks.append(os.path.join(fdir, f"f{t}.png"))
                if write:
                    cv2.imwrite(masks[-1], ann)
        if mid_entry:
            ann2 = np.zeros((H, W), np.uint8)
            ann2[20:32, 10:24] = 3
            masks.append(os.path.join(fdir, "f2.png"))
            if write:
                cv2.imwrite(masks[-1], ann2)
        seqs.append(Sequence(name=f"vseq{si}", frames=frames,
                             ground_truth_rect=np.zeros((1, 4)),
                             masks=masks))
    return seqs


def coco_rows(root):
    """Image index -> (8, 7) decoded rows at its gt boxes in letterbox
    coordinates (tests/test_coco_evaluator_e2e.py `_mock_forward`)."""
    import json
    d = json.load(open(os.path.join(root, "annotations", "val.json")))
    r = min(TEST_SIZE[0] / 96, TEST_SIZE[1] / 128)
    rows = np.zeros((COCO_IMAGES, 8, 7), np.float32)
    seen = {}
    for a in d["annotations"]:
        i = a["image_id"] - 1
        k = seen[i] = seen.get(i, -1) + 1
        x, y, w, h = a["bbox"]
        rows[i, k, :4] = [(x + w / 2) * r, (y + h / 2) * r, w * r, h * r]
        rows[i, k, 4] = 0.95
        rows[i, k, 5 + a["category_id"] - 1] = 0.9
    return rows
'''

WORKER = COMMON + r'''
import sys

from unicorn_torch.data.datasets.coco import COCODataset
from unicorn_torch.data.transforms import ValTransform
from unicorn_torch.drivers.seq_parallel import (
    make_sot_seq_parallel_fn, make_vos_seq_parallel_fn,
    make_vos_shared_seq_parallel_fn)
from unicorn_torch.drivers.stream import MultiStreamMOT
from unicorn_torch.evaluators.coco_evaluator import COCOEvaluator
from unicorn_torch.harness.running import (run_dataset_sot_parallel,
                                           run_dataset_vos_parallel)
from unicorn_torch.parallel import initialize_multihost, make_mesh

rank, world, root, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
initialize_multihost(num_processes=world, process_id=rank, device="cpu",
                     init_method="file://" + os.path.join(root, "store"),
                     timeout_s=100)


def mesh(axis):
    return make_mesh((world,), (axis,), device="cpu")


res = {}
multi = MultiStreamMOT(model(TINY, 0, raised=True), S, mesh=mesh("stream"),
                       **KW)
mine = torch.from_numpy(stream_frames()[multi.first:
                                        multi.first + multi.local_streams])
res["stream"] = torch.stack([multi.tick(mine[:, t]) for t in range(TICKS)],
                            1)
res["stream_first"] = multi.first

dt = sot_driver(model(TINY, 0))
res["sot"] = make_sot_seq_parallel_fn(dt, mesh("seq"))(*sot_refs(dt))
dv = vos_driver(model(MASK, 1))
feat1, lbs, imgs = vos_refs(dv)
res["general"] = make_vos_seq_parallel_fn(dv, mesh("seq"))(
    feat1.expand(-1, K, -1, -1, -1), lbs, imgs)
res["shared"] = make_vos_shared_seq_parallel_fn(dv, mesh("seq"))(
    feat1, lbs, imgs)

res["sot_runner"] = run_dataset_sot_parallel(
    dt, sot_seqs(root), 2, result_dir=os.path.join(root, "sot_out"),
    verbose=False, mesh=mesh("seq"))
res["vos_runner"] = run_dataset_vos_parallel(
    dv, vos_seqs(root), 2,
    result_dir=os.path.join(root, "vos_out"), verbose=False,
    mesh=mesh("seq"))

ds = COCODataset(root, "val.json", "val", img_size=TEST_SIZE,
                 preproc=ValTransform())
known = [torch.from_numpy(ds[i][0]) for i in range(len(ds))]
rows = torch.from_numpy(coco_rows(root))


def forward(images):
    """The gt rows of each image, found by its pixels."""
    nhwc = images.permute(0, 2, 3, 1)
    return torch.stack([rows[next(i for i, k in enumerate(known)
                                  if torch.equal(k, x))] for x in nhwc])


res["coco"] = COCOEvaluator(ds, TEST_SIZE, conf_thre=0.3, nms_thre=0.65,
                            num_classes=2, batch_size=COCO_BATCH,
                            device="cpu", mesh=mesh("data")).evaluate(
                                forward)
torch.save(res, out)
torch.distributed.destroy_process_group()
'''

common = types.ModuleType("mesh_forms_common")
exec(COMMON, common.__dict__)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jmesh(axis, n=W_RANKS):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _jax_seq(seq):
    return jds.Sequence(name=seq.name, frames=seq.frames,
                        ground_truth_rect=seq.ground_truth_rect,
                        masks=seq.masks)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs, the references, the data root)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("mesh_forms")
    common.sot_seqs(str(root), write=True)
    common.vos_seqs(str(root), write=True)
    coco_cases._make_dataset(root, n_images=common.COCO_IMAGES)
    worker = root / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [str(root / f"rank{r}.pt") for r in range(W_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(W_RANKS), str(root),
         outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(root)) for r in range(W_RANKS)]
    try:
        refs = _references(str(root))
        logs = [p.communicate(timeout=200)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(o, weights_only=False) for o in outs], refs, root


def _references(root):
    c = common
    refs = {}
    # MultiStreamMOT: JAX over a 2-device "stream" mesh; the port at 2
    # streams on one card, for each rank's streams
    tm = c.model(c.TINY, 0, raised=True)
    frames = c.stream_frames()
    jm, params = JUnicorn(**c.TINY), {"params": to_flax(tm.state_dict())}
    jmesh = _jmesh("stream")
    jmulti = JMulti(jm, params, n_streams=c.S, mesh=jmesh, approx_topk=False,
                    **c.KW)
    with jmesh:
        refs["stream_j"] = np.stack([np.asarray(jmulti.tick(
            jnp.asarray(frames[:, t]))) for t in range(c.TICKS)], 1)
    per = c.S // W_RANKS
    refs["stream_one"] = []
    for r in range(W_RANKS):
        one = TMulti(tm, per, device="cpu", **c.KW)
        mine = torch.from_numpy(frames[r * per:(r + 1) * per])
        refs["stream_one"].append(torch.stack(
            [one.tick(mine[:, t]) for t in range(c.TICKS)], 1))

    # seq-parallel: JAX over a 2-device "seq" mesh; the port at batch S / W
    tm = c.model(c.TINY, 0)
    dt = c.sot_driver(tm)
    params = {"params": to_flax(tm.state_dict())}
    dj = JSOTDriver(JUnicorn(**c.TINY), params, input_size=(c.H, c.W),
                    conf_thre=0.0, max_inst=3)
    jrefs = [dj._init_fn(params, jnp.asarray(f0[None], jnp.float32),
                         jnp.asarray([box], jnp.float32))
             for f0, box, _ in c.sot_inputs()]
    refs["sot_j"] = np.asarray(jsp.make_sot_seq_parallel_fn(
        dj, _jmesh("seq"))(params, jnp.stack([r[0] for r in jrefs]),
                           jnp.stack([r[1] for r in jrefs]),
                           jnp.asarray(np.stack(
                               [f1 for _, _, f1 in c.sot_inputs()]))))
    feat, lbs, imgs = c.sot_refs(dt)
    refs["sot_one"] = torch.cat([make_sot_seq_parallel_fn(dt)(
        feat[lo:lo + per], lbs[lo:lo + per], imgs[lo:lo + per])
        for lo in range(0, c.S, per)])

    tm = c.model(c.MASK, 1)
    dv = c.vos_driver(tm)
    params = {"params": to_flax(tm.state_dict())}
    dvj = JVOSDriver(JUnicorn(**c.MASK), params, input_size=(c.H, c.W),
                     max_objects=c.K, **c.VOS_DRV)
    jrefs = [dvj._init_fn(params, jnp.asarray(f0[None], jnp.float32),
                          jnp.asarray(m)) for f0, m, _ in c.vos_inputs()]
    f1 = jnp.stack([r[0] for r in jrefs])
    lb = jnp.stack([r[1] for r in jrefs])
    fr = jnp.asarray(np.stack([f for _, _, f in c.vos_inputs()]),
                     jnp.float32)
    refs["general_j"] = [np.asarray(o) for o in jsp.make_vos_seq_parallel_fn(
        dvj, _jmesh("seq"))(params, jnp.broadcast_to(
            f1, (c.S, c.K) + f1.shape[2:]), lb, fr)]
    refs["shared_j"] = [np.asarray(o) for o in
                        jsp.make_vos_shared_seq_parallel_fn(
                            dvj, _jmesh("seq"))(params, f1, lb, fr)]
    feat1, lbs, imgs = c.vos_refs(dv)
    from unicorn_torch.drivers import seq_parallel as tsp
    for form, fn, feat in (
            ("general", tsp.make_vos_seq_parallel_fn(dv),
             feat1.expand(-1, c.K, -1, -1, -1)),
            ("shared", tsp.make_vos_shared_seq_parallel_fn(dv), feat1)):
        parts = [fn(feat[lo:lo + per], lbs[lo:lo + per], imgs[lo:lo + per])
                 for lo in range(0, c.S, per)]
        refs[form + "_one"] = [torch.cat(o) for o in zip(*parts)]

    # the runners: JAX's over a 2-device "seq" mesh, on the drivers above
    refs["sot_runner_j"] = jrun.run_dataset_sot_parallel(
        dj, [_jax_seq(s) for s in c.sot_seqs(root)], _jmesh("seq"),
        verbose=False)
    refs["vos_runner_j"] = jrun.run_dataset_vos_parallel(
        dvj, [_jax_seq(s) for s in c.vos_seqs(root)], _jmesh("seq"),
        verbose=False)

    # COCO: JAX's mesh eval (tests/test_coco_evaluator_e2e.py:99)
    from unicorn_tpu.data.datasets.coco import COCODataset as JCOCODataset
    from unicorn_tpu.data.transforms import ValTransform as JValTransform
    ds = JCOCODataset(root, "val.json", "val", img_size=c.TEST_SIZE,
                      preproc=JValTransform())
    dmesh = _jmesh("data", 8)
    rows = np.zeros((8, 8, 7), np.float32)
    rows[:c.COCO_IMAGES] = c.coco_rows(root)
    p = jax.device_put(jnp.asarray(rows), NamedSharding(dmesh, P()))

    @jax.jit
    def forward(p, images):
        return p[:images.shape[0]] + 0.0 * jnp.mean(images)

    refs["coco_j"] = JCOCO(ds, c.TEST_SIZE, conf_thre=0.3, nms_thre=0.65,
                           num_classes=2, batch_size=8,
                           mesh=dmesh).evaluate(forward, p)
    return refs


def _assert_close_to_jax(dets_t, dets_j, atol_box=1e-2):
    """Packed rows [x1, y1, x2, y2, scores ..., class id, valid]."""
    dets_t, dets_j = np.asarray(dets_t), np.asarray(dets_j)
    assert dets_t.shape == dets_j.shape
    np.testing.assert_allclose(dets_t[..., :4], dets_j[..., :4],
                               atol=atol_box)
    np.testing.assert_allclose(dets_t[..., 4:6], dets_j[..., 4:6], atol=1e-4)
    np.testing.assert_array_equal(dets_t[..., 6:], dets_j[..., 6:])


def _compare_tracks(out_t, out_j):
    """tests/test_torch_port_parallel_stream.py `_compare`."""
    out_t, out_j = out_t.numpy(), np.asarray(out_j)
    assert out_t.shape == out_j.shape
    valid = out_j[..., 6] > 0.5
    np.testing.assert_array_equal(out_t[..., 6] > 0.5, valid)
    np.testing.assert_array_equal(out_t[valid][:, 5], out_j[valid][:, 5])
    np.testing.assert_allclose(out_t[valid][:, :4], out_j[valid][:, :4],
                               rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(out_t[valid][:, 4], out_j[valid][:, 4],
                               atol=1e-4)
    return int(valid.sum())


# ------------------------------------------------------------ in-process
def _fake_mesh(n, axis="seq"):
    return ProcessMesh((axis,), {axis: n}, object(), 0, torch.device("cpu"))


def test_mesh_forms_refuse_indivisible_shares():
    c = common
    dt = c.sot_driver(c.model(c.TINY, 0))
    with pytest.raises(ValueError, match="do not divide"):
        make_sot_seq_parallel_fn(dt, _fake_mesh(3))(*c.sot_refs(dt))
    with pytest.raises(ValueError, match="do not divide"):
        trun.run_dataset_sot_parallel(dt, [], 3, mesh=_fake_mesh(2))
    with pytest.raises(ValueError, match="do not divide"):
        TMulti(c.model(c.TINY, 0), 3, mesh=_fake_mesh(2, "stream"), **c.KW)
    from unicorn_torch.evaluators.coco_evaluator import COCOEvaluator
    with pytest.raises(ValueError, match="does not divide"):
        COCOEvaluator(None, (64, 64), 0.3, 0.65, 2, batch_size=3,
                      mesh=_fake_mesh(2, "data"))


# ------------------------------------------------------------ two ranks
def test_multistream_over_mesh(run):
    outs, refs, _ = run
    per = common.S // W_RANKS
    for r, o in enumerate(outs):
        assert o["stream_first"] == r * per
        assert tuple(o["stream"].shape) == (per, common.TICKS, 16, 7)
        assert torch.equal(o["stream"], refs["stream_one"][r])
    both = torch.cat([o["stream"] for o in outs])
    assert _compare_tracks(both, refs["stream_j"]) > 0


def test_sot_seq_parallel_over_mesh(run):
    outs, refs, _ = run
    for o in outs:
        assert torch.equal(o["sot"], refs["sot_one"])
    assert (refs["sot_one"][..., 7] > 0.5).any()
    _assert_close_to_jax(outs[0]["sot"], refs["sot_j"])


@pytest.mark.parametrize("form", ["general", "shared"])
def test_vos_seq_parallel_over_mesh(run, form):
    outs, refs, _ = run
    for o in outs:
        for got, want in zip(o[form], refs[form + "_one"]):
            assert torch.equal(got, want)
    dets, valid, masks = (t.numpy() for t in outs[0][form])
    assert masks.shape == (common.S, common.K, common.H, common.W)
    assert valid.any()
    dets_j, valid_j, masks_j = refs[form + "_j"]
    np.testing.assert_array_equal(valid, valid_j)
    _assert_close_to_jax(dets, dets_j)
    np.testing.assert_allclose(masks, masks_j, atol=1e-4)


def test_sot_runner_over_mesh(run):
    outs, refs, root = run
    seqs = common.sot_seqs(str(root))
    ref = refs["sot_runner_j"]
    for o in outs:
        res = o["sot_runner"]
        assert list(res) == [s.name for s in seqs]
        for s in seqs:
            assert res[s.name].shape == (len(s.frames), 4)
            np.testing.assert_allclose(res[s.name], ref[s.name], atol=1e-2)
            np.testing.assert_array_equal(
                np.loadtxt(root / "sot_out" / f"{s.name}.txt",
                           delimiter="\t").reshape(-1, 4),
                res[s.name].astype(np.int64))
        np.testing.assert_array_equal(
            np.concatenate(list(res.values())),
            np.concatenate(list(outs[0]["sot_runner"].values())))


def test_vos_runner_over_mesh(run):
    outs, refs, root = run
    seqs = common.vos_seqs(str(root))
    ref = refs["vos_runner_j"]
    for o in outs:
        res = o["vos_runner"]
        assert list(res) == [s.name for s in seqs]
        for s in seqs:
            assert len(res[s.name]) == len(ref[s.name]) == len(s.frames)
            for t, (a, b) in enumerate(zip(res[s.name], ref[s.name])):
                assert (a == np.asarray(b)).mean() >= 0.99, (s.name, t)
                np.testing.assert_array_equal(
                    a, outs[0]["vos_runner"][s.name][t])
                png = root / "vos_out" / s.name / f"f{t}.png"
                np.testing.assert_array_equal(read_indexed_mask(str(png)), a)
    assert set(np.unique(np.stack(outs[0]["vos_runner"]["vseq2"]))) >= \
        {1, 2, 3}


def test_coco_eval_over_mesh(run):
    outs, refs, _ = run
    m_j = refs["coco_j"]
    assert m_j["n_images"] == common.COCO_IMAGES
    for o in outs:
        m = o["coco"]
        assert m["n_images"] == common.COCO_IMAGES
        assert abs(m["AP"] - m_j["AP"]) < 1e-9
        assert m["AP50"] > 0.99
        for k, v in m.items():
            if k != "infer_time_s":
                assert v == outs[0]["coco"][k], k
