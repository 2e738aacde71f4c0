"""The port's MOT path (unicorn_torch) against the JAX package's, on the CPU:
device letterbox vs the host cv2 letterbox, the copied ByteTracker vs the
JAX package's, and MOTDriver end to end."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.drivers.mot import MOTDriver as TMOTDriver
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.convert import from_flax
from unicorn_torch.ops.letterbox import letterbox_device
from unicorn_torch.tracker.byte_tracker import ByteTracker as TByteTracker
from unicorn_tpu.data.preproc import letterbox
from unicorn_tpu.drivers.mot import MOTDriver as JMOTDriver
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.tracker.byte_tracker import ByteTracker as JByteTracker


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((100, 200), (128, 128)),     # downscale, pad below
    ((54, 96), (96, 160)),        # upscale, pad right (1080x1920 / 20)
    ((96, 160), (96, 160)),       # identity
])
def test_letterbox_device_matches_cv2(src_hw, dst_hw):
    rng = np.random.RandomState(0)
    img = (rng.rand(*src_hw, 3) * 255).astype(np.uint8)
    host, r_host = letterbox(img, dst_hw)
    dev, r_dev = letterbox_device(torch.from_numpy(img), dst_hw)
    dev = dev.numpy()
    assert dev.shape == host.shape and dev.dtype == np.float32
    assert abs(r_host - r_dev) < 1e-12
    rh, rw = int(src_hw[0] * r_host), int(src_hw[1] * r_host)
    # padding identical, content within cv2's fixed-point rounding
    np.testing.assert_array_equal(dev[rh:], host[rh:])
    np.testing.assert_array_equal(dev[:, rw:], host[:, rw:])
    diff = np.abs(dev[:rh, :rw] - host[:rh, :rw])
    assert diff.mean() < 1.0 and diff.max() <= 2.0
    assert np.array_equal(dev, np.round(dev))  # uint8-valued, as cv2's


def _detection_stream(n_frames=40, n_obj=6, seed=0):
    """Moving boxes with jitter, dropouts, low-score frames, a crossing pair
    and clutter, with classes."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(50, 400, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    vel[1] = (pos[0] - pos[1]) / 20.0      # object 1 crosses object 0
    size = rng.uniform(30, 80, (n_obj, 2))
    cls = rng.randint(0, 3, n_obj)
    for t in range(n_frames):
        boxes, scores, classes = [], [], []
        for i in range(n_obj):
            if rng.rand() < 0.1:           # missed detection
                continue
            tl = pos[i] + t * vel[i] + rng.randn(2) * 1.5
            boxes.append(np.r_[tl, tl + size[i]])
            scores.append(rng.choice([0.95, 0.8, 0.4, 0.2]))
            classes.append(cls[i])
        for _ in range(rng.randint(0, 3)):  # clutter
            tl = rng.uniform(0, 450, 2)
            boxes.append(np.r_[tl, tl + rng.uniform(20, 60, 2)])
            scores.append(rng.uniform(0.05, 0.7))
            classes.append(rng.randint(0, 3))
        yield (np.asarray(boxes, np.float64).reshape(-1, 4),
               np.asarray(scores), np.asarray(classes))


def _views(views):
    return [(v.track_id, v.cls, round(v.score, 9),
             tuple(np.round(v.tlbr, 6))) for v in views]


@pytest.mark.parametrize("kw", [dict(), dict(track_thresh=0.5,
                                             track_buffer=5,
                                             match_thresh=0.8)])
def test_byte_tracker_copy_matches_jax_package(kw):
    tj, tt = JByteTracker(**kw), TByteTracker(**kw)
    n_tracks = 0
    for boxes, scores, classes in _detection_stream():
        vj = _views(tj.update(boxes, scores, classes))
        vt = _views(tt.update(boxes, scores, classes))
        assert vt == vj
        assert tt.last_matches == tj.last_matches
        n_tracks += len(vt)
    assert n_tracks > 50


H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5)


def test_mot_driver_matches_jax_driver():
    """Frames already at the input size (the letterbox is the identity), the
    same parameters with obj/cls prediction biases raised so that detections
    clear the tracker's thresholds: identical per-frame tracks."""
    rng = np.random.RandomState(5)
    base = (rng.rand(H, W + 16, 3) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 2 * t:2 * t + W])
              for t in range(5)]
    jm = JUnicorn(**CFG)
    init = jax.jit(functools.partial(jm.init, method=JUnicorn.init_all))
    params = init(jax.random.PRNGKey(1), jnp.asarray(frames[0][None],
                                                    jnp.float32))

    def raise_prior(path, v):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("Conv_0/bias") and ("/obj_pred" in name
                                             or "/cls_pred" in name):
            return v + 6.0
        return v

    params = jax.tree_util.tree_map_with_path(raise_prior, params)
    state = from_flax(params)
    tm = TUnicorn(**CFG)
    tm.load_state_dict(state)
    kw = dict(input_size=(H, W), num_classes=8, conf_thre=0.3,
              track_thresh=0.5, max_out=32)
    dj = JMOTDriver(jm, params, **kw)
    dt_ = TMOTDriver(tm, device="cpu", **kw)
    n_tracks = 0
    for f in frames:
        vj, vt = _views(dj.update(f)), _views(dt_.update(f))
        assert [v[:2] for v in vt] == [v[:2] for v in vj]
        for a, b in zip(vt, vj):
            np.testing.assert_allclose(a[2], b[2], atol=1e-4)
            np.testing.assert_allclose(a[3], b[3], atol=1e-2)
        n_tracks += len(vt)
    assert n_tracks > 0
