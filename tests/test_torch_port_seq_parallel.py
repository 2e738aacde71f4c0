"""The port's sequence-parallel SOT / VOS (unicorn_torch/drivers/
seq_parallel.py) and lockstep runners (unicorn_torch/harness/
_parallel_runners.py) against the port's sequential driver and runners and
against the JAX package's make_*_seq_parallel_fn on a 4-device CPU mesh.

Model: the JAX seq-parallel tests' tiny Unicorn (tests/test_seq_parallel.py
:21-25, CSPDarknet depth 0.33 width 0.25, "conv" interaction, 64x64), for
VOS with the mask head and the RAFT up-mask at rate 4, from the port's
seeded init; JAX gets the same weights through
unicorn_torch.convert.to_flax. S = 4 sequences, each with its own
reference frame, box or masks, and frame.

Tolerances.
  * each slot of the S-sequence step against the sequential driver on that
    sequence alone: tests/test_seq_parallel.py:28,61's rtol 2e-4, atol
    2e-3 (a batch of S against a batch of 1);
  * against JAX's S-sequence step: the port's SOT / VOS driver parity
    bounds (tests/test_torch_port_vos.py): boxes within 1e-2 px, scores
    within 1e-4, class ids and `valid` equal, mask probabilities within
    1e-4;
  * the runners against the sequential runners, tests/test_seq_parallel.py
    :100,148's: boxes within 1e-2 px; label maps equal.
Distinct references on one shared frame must give distinct outputs: a
step that read the driver's cached reference would give every slot slot
0's target.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from unicorn_torch.convert import to_flax
from unicorn_torch.drivers.seq_parallel import (
    make_sot_seq_parallel_fn, make_vos_seq_parallel_fn,
    make_vos_shared_seq_parallel_fn)
from unicorn_torch.drivers.sot import SOTDriver as TSOTDriver
from unicorn_torch.drivers.vos import VOSDriver as TVOSDriver
from unicorn_torch.harness import running as trun
from unicorn_torch.harness._parallel_runners import _introduces_new_ids
from unicorn_torch.harness.datasets import Sequence
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.drivers import seq_parallel as jsp
from unicorn_tpu.drivers.sot import SOTDriver as JSOTDriver
from unicorn_tpu.drivers.vos import VOSDriver as JVOSDriver
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
S = 4
K = 2
TINY = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
            width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
            n_layer_att=0, use_attention=False)
MASK = dict(TINY, use_mask=True, use_raft=True, up_rate=4)
VOS_DRV = dict(conf_thre=0.001, use_raft=True, up_rate=4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(cfg, seed):
    tm = TUnicorn(**cfg, generator=torch.Generator().manual_seed(seed))
    return tm.eval(), JUnicorn(**cfg), {"params": to_flax(tm.state_dict())}


def _u8(rng):
    return (rng.rand(H, W, 3) * 255).astype(np.uint8)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:S]), ("seq",))


def _cat(driver, frames):
    return torch.cat([driver.preprocess(f)[0] for f in frames])


def _assert_close_to_jax(dets_t, dets_j, atol_box=1e-2):
    """Packed rows [x1, y1, x2, y2, scores ..., class id, valid]."""
    dets_t, dets_j = np.asarray(dets_t), np.asarray(dets_j)
    assert dets_t.shape == dets_j.shape
    np.testing.assert_allclose(dets_t[..., :4], dets_j[..., :4],
                               atol=atol_box)
    np.testing.assert_allclose(dets_t[..., 4:6], dets_j[..., 4:6], atol=1e-4)
    np.testing.assert_array_equal(dets_t[..., 6:], dets_j[..., 6:])


@pytest.fixture(scope="module")
def sot():
    torch.set_num_threads(1)
    tm, jm, params = _models(TINY, 0)
    dt = TSOTDriver(tm, input_size=(H, W), conf_thre=0.001, max_inst=3,
                    device="cpu")
    dj = JSOTDriver(jm, params, input_size=(H, W), conf_thre=0.001,
                    max_inst=3)
    rng = np.random.RandomState(0)
    refs_t, refs_j, frames = [], [], []
    for s in range(S):
        f0 = _u8(rng)
        cx, cy, w, h = 20.0 + 4 * s, 24.0 + 3 * s, 16.0, 12.0
        fr, lr, _ = dt.init_refs(f0, [cx - w / 2, cy - h / 2, w, h])
        refs_t.append((fr, lr))
        refs_j.append(dj._init_fn(params, jnp.asarray(f0[None], jnp.float32),
                                  jnp.asarray([[cx, cy, w, h]], jnp.float32)))
        frames.append(_u8(rng))
    feat_t = torch.stack([r[0] for r in refs_t])
    lbs_t = torch.stack([r[1] for r in refs_t])
    out = {"dt": dt, "refs": refs_t, "frames": frames, "feat": feat_t,
           "lbs": lbs_t}
    out["packed"] = make_sot_seq_parallel_fn(dt)(feat_t, lbs_t,
                                                 _cat(dt, frames)).numpy()
    fn_j = jsp.make_sot_seq_parallel_fn(dj, _mesh())
    out["packed_j"] = np.asarray(fn_j(
        params, jnp.stack([r[0] for r in refs_j]),
        jnp.stack([r[1] for r in refs_j]), jnp.asarray(np.stack(frames))))
    return out


def test_sot_seq_parallel_matches_sequential(sot):
    dt, packed = sot["dt"], sot["packed"]
    assert packed.shape == (S, 3, 8) and (packed[..., 7] > 0.5).any()
    for s, ((fr, lr), f) in enumerate(zip(sot["refs"], sot["frames"])):
        dt.feat_ref, dt.lbs_ref = fr, lr
        ref = dt.postprocess(dt.forward(dt.preprocess(f)[0]))[0].numpy()
        np.testing.assert_allclose(packed[s], ref, rtol=2e-4, atol=2e-3)


def test_sot_seq_parallel_matches_jax(sot):
    _assert_close_to_jax(sot["packed"], sot["packed_j"])


def test_sot_slots_read_their_own_references(sot):
    """One frame for every slot, each slot's own reference: the outputs
    differ from slot to slot; the cached reference would make them equal."""
    dt = sot["dt"]
    dt.feat_ref, dt.lbs_ref = sot["refs"][0]
    frame = _cat(dt, sot["frames"][:1]).expand(S, -1, -1, -1)
    packed = make_sot_seq_parallel_fn(dt)(sot["feat"], sot["lbs"], frame)
    for s in range(1, S):
        assert not torch.allclose(packed[s], packed[0]), s
    cached = dt.postprocess(dt.forward(frame))
    assert torch.allclose(cached[1], cached[0])


@pytest.fixture(scope="module")
def vos():
    torch.set_num_threads(1)
    tm, jm, params = _models(MASK, 1)
    dt = TVOSDriver(tm, input_size=(H, W), max_objects=K, device="cpu",
                    **VOS_DRV)
    dj = JVOSDriver(jm, params, input_size=(H, W), max_objects=K, **VOS_DRV)
    rng = np.random.RandomState(1)
    refs_t, refs_j, frames = [], [], []
    for s in range(S):
        f0 = _u8(rng)
        masks = np.zeros((K, H, W), np.float32)
        masks[0, 8 + s:28 + s, 10:30] = 1.0
        masks[1, 36:56, 30 - s:50 - s] = 1.0
        img0, _ = dt.preprocess(f0)
        refs_t.append(dt.init_fn(img0, torch.from_numpy(masks)))
        refs_j.append(dj._init_fn(params, jnp.asarray(f0[None], jnp.float32),
                                  jnp.asarray(masks)))
        frames.append(_u8(rng))
    out = {"dt": dt, "refs": refs_t, "frames": frames}
    feat1 = torch.stack([r[0] for r in refs_t])             # (S, 1, C, h, w)
    lbs = torch.stack([r[1] for r in refs_t])               # (S, K, 1, N8)
    feat_k = feat1.expand(-1, K, -1, -1, -1)
    imgs = _cat(dt, frames)
    out["general"] = [o.numpy() for o in make_vos_seq_parallel_fn(dt)(
        feat_k, lbs, imgs)]
    out["shared"] = [o.numpy() for o in make_vos_shared_seq_parallel_fn(dt)(
        feat1, lbs, imgs)]
    feat1_j = jnp.stack([r[0] for r in refs_j])
    lbs_j = jnp.stack([r[1] for r in refs_j])
    frames_j = jnp.asarray(np.stack(frames), jnp.float32)
    out["general_j"] = [np.asarray(o) for o in jsp.make_vos_seq_parallel_fn(
        dj, _mesh())(params, jnp.broadcast_to(
            feat1_j, (S, K) + feat1_j.shape[2:]), lbs_j, frames_j)]
    out["shared_j"] = [np.asarray(o) for o in
                       jsp.make_vos_shared_seq_parallel_fn(dj, _mesh())(
                           params, feat1_j, lbs_j, frames_j)]
    return out


@pytest.mark.parametrize("form", ["general", "shared"])
def test_vos_seq_parallel_matches_sequential_and_jax(vos, form):
    dt = vos["dt"]
    dets, valid, masks = vos[form]
    assert dets.shape[:2] == (S, K) and valid.shape == (S, K, 8)
    assert masks.shape == (S, K, H, W) and valid.any()
    for s, ((fr1, lr), f) in enumerate(zip(vos["refs"], vos["frames"])):
        img = dt.preprocess(f)[0]
        if form == "general":
            ref = dt.track_fn(img, fr1.expand(K, -1, -1, -1), lr)
        else:
            ref = dt.track_fn_shared(img, fr1, lr)
        for got, want in zip((dets[s], valid[s], masks[s]), ref):
            np.testing.assert_allclose(got, want.numpy(), rtol=2e-4,
                                       atol=2e-3)
    dets_j, valid_j, masks_j = vos[form + "_j"]
    np.testing.assert_array_equal(valid, valid_j)
    _assert_close_to_jax(dets, dets_j)
    np.testing.assert_allclose(masks, masks_j, atol=1e-4)
    # each sequence's slots follow its own label maps
    assert np.abs(masks[0] - masks[1]).max() > 1e-3


def _write_sot_seqs(root, rng):
    """Sequences of 3, 5, 4 and 1 frames (52x60 JPEGs): over 2 slots a
    refill, and a sequence that ends at its first frame."""
    seqs = []
    for si, n_frames in enumerate((3, 5, 4, 1)):
        paths = []
        for t in range(n_frames):
            img = (rng.rand(52, 60, 3) * 255).astype(np.uint8)
            x, y = 8 + 3 * t + 2 * si, 6 + 2 * t
            img[y:y + 14, x:x + 16] = [240, 200, 60]
            paths.append(str(root / f"s{si}_f{t}.jpg"))
            cv2.imwrite(paths[-1], img)
        seqs.append(Sequence(name=f"seq{si}", frames=paths,
                             ground_truth_rect=np.array(
                                 [[8.0 + 2 * si, 6.0, 16.0, 14.0]])))
    return seqs


def test_run_dataset_sot_parallel_matches_sequential(tmp_path):
    tm, _, _ = _models(TINY, 3)
    seqs = _write_sot_seqs(tmp_path, np.random.RandomState(3))

    def factory():
        return TSOTDriver(tm, input_size=(H, W), conf_thre=0.0, max_inst=3,
                          device="cpu")

    ref = trun.run_dataset_sot(factory, seqs, verbose=False)
    res = trun.run_dataset_sot_parallel(factory(), seqs, 2,
                                        result_dir=str(tmp_path / "out"),
                                        verbose=False)
    assert set(res) == set(ref) == {"seq0", "seq1", "seq2", "seq3"}
    for s in seqs:
        assert res[s.name].shape == (len(s.frames), 4)
        np.testing.assert_allclose(res[s.name], ref[s.name], atol=1e-2)
        np.testing.assert_array_equal(
            np.loadtxt(tmp_path / "out" / f"{s.name}.txt",
                       delimiter="\t").reshape(-1, 4),
            res[s.name].astype(np.int64))


def _write_vos_seq(root, rng, si, n_frames, mid_entry=False, davis_gt=False):
    fdir = root / f"s{si}"
    fdir.mkdir()
    frames, masks = [], []
    for t in range(n_frames):
        img = (rng.rand(52, 60, 3) * 255).astype(np.uint8)
        x, y = 8 + 2 * t + 2 * si, 6 + t
        img[y:y + 14, x:x + 16] = [240, 200, 60]
        frames.append(str(fdir / f"f{t}.jpg"))
        cv2.imwrite(frames[-1], img)
    ann = np.zeros((52, 60), np.uint8)
    ann[6:20, 8 + 2 * si:24 + 2 * si] = 1
    ann[30:44, 30:46] = 2
    masks.append(str(fdir / "m0.png"))
    cv2.imwrite(masks[-1], ann)
    if davis_gt:       # a mask every frame, the same ids: stays in lockstep
        for t in range(1, n_frames):
            masks.append(str(fdir / f"f{t}.png"))
            cv2.imwrite(masks[-1], ann)
    if mid_entry:      # object 3 enters on frame 2 (matched by file stem)
        ann2 = np.zeros((52, 60), np.uint8)
        ann2[20:32, 10:24] = 3
        masks.append(str(fdir / "f2.png"))
        cv2.imwrite(masks[-1], ann2)
    return Sequence(name=f"vseq{si}", frames=frames,
                    ground_truth_rect=np.zeros((1, 4)), masks=masks)


def test_run_dataset_vos_parallel_matches_sequential(tmp_path):
    tm, _, _ = _models(MASK, 4)
    rng = np.random.RandomState(4)
    seqs = [_write_vos_seq(tmp_path, rng, 0, 3),
            _write_vos_seq(tmp_path, rng, 1, 4, davis_gt=True),
            _write_vos_seq(tmp_path, rng, 2, 3, mid_entry=True),
            _write_vos_seq(tmp_path, rng, 3, 1),
            _write_vos_seq(tmp_path, rng, 4, 5)]
    assert [_introduces_new_ids(s) for s in seqs] == \
        [False, False, True, False, False]

    def fresh():
        return TVOSDriver(tm, input_size=(H, W), max_objects=3,
                          device="cpu", conf_thre=0.0, use_raft=True,
                          up_rate=4)

    ref = {s.name: trun.run_sequence_vos(fresh(), s) for s in seqs}
    res = trun.run_dataset_vos_parallel(fresh(), seqs, 2,
                                        result_dir=str(tmp_path / "out"),
                                        verbose=False)
    assert set(res) == set(ref)
    for s in seqs:
        assert len(res[s.name]) == len(ref[s.name]) == len(s.frames)
        for a, b in zip(res[s.name], ref[s.name]):
            np.testing.assert_array_equal(a, b)
    assert set(np.unique(np.stack(res["vseq2"]))) >= {1, 2, 3}
    assert len(set(np.unique(np.stack(res["vseq4"])).tolist())) > 1
