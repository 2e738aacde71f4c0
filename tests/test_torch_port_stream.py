"""The port's StreamingMOTPipeline (unicorn_torch/drivers/stream.py) against
the JAX package's (unicorn_tpu/drivers/stream.py), on the CPU, at the tiny
ConvNeXt-Tiny width-0.5 model of the port's MOT test with the flax weights
carried over by `from_flax`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax
from unicorn_torch.drivers import stream as ts_mod
from unicorn_torch.drivers.stream import StreamingMOTPipeline as TStream
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.parallel import ProcessMesh
from unicorn_tpu.drivers import stream as js_mod
from unicorn_tpu.drivers.stream import StreamingMOTPipeline as JStream
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5)
KW = dict(input_size=(H, W), num_classes=8, conf_thre=0.3, nms_thre=0.65,
          track_thresh=0.5, max_dets=32, max_tracks=32, n_cand=64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(seed, n):
    """n frames of a panning random texture, (n, H, W, 3) float32."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(H, W + 2 * n, 3) * 255).astype(np.uint8)
    return np.stack([base[:, 2 * t:2 * t + W] for t in range(n)]).astype(
        np.float32)


@pytest.fixture(scope="module")
def models():
    """The JAX model and parameters (obj/cls prediction biases raised so
    that detections clear the tracker's thresholds) and the port's model
    with the same weights."""
    jm = JUnicorn(**CFG)
    init = jax.jit(functools.partial(jm.init, method=JUnicorn.init_all))
    params = init(jax.random.PRNGKey(1), jnp.asarray(_frames(5, 1)))

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
    return jm, params, tm


def _compare(out_t, out_j):
    """Packed rows (..., T, 7) [x1, y1, x2, y2, score, id, valid]: the valid
    mask and the ids of valid rows equal, their boxes within 5e-4 px and
    scores within 1e-4."""
    out_t, out_j = out_t.numpy(), np.asarray(out_j)
    assert out_t.shape == out_j.shape
    valid = out_j[..., 6] > 0.5
    np.testing.assert_array_equal(out_t[..., 6] > 0.5, valid)
    np.testing.assert_array_equal(out_t[valid][:, 5], out_j[valid][:, 5])
    np.testing.assert_allclose(out_t[valid][:, :4], out_j[valid][:, :4],
                               atol=5e-4)
    np.testing.assert_allclose(out_t[valid][:, 4], out_j[valid][:, 4],
                               atol=1e-4)
    return int(valid.sum())


def test_push_frame_then_run_chunk_match_jax(models):
    jm, params, tm = models
    frames = _frames(5, 5)
    pj = JStream(jm, params, approx_topk=False, **KW)
    pt = TStream(tm, device="cpu", **KW)
    out_j = pj.push_frame(jnp.asarray(frames[:1]))
    out_t = pt.push_frame(torch.from_numpy(frames[:1]))
    assert tuple(out_t.shape) == (32, 7)
    n = _compare(out_t, out_j)
    # chunk mode continues from the same carry
    outs_j = pj.run_chunk(jnp.asarray(frames[1:]))
    outs_t = pt.run_chunk(torch.from_numpy(frames[1:]))
    assert tuple(outs_t.shape) == (4, 32, 7)
    n += _compare(outs_t, outs_j)
    assert n > 0, "no track was emitted: the comparison is empty"
    assert int(pt.ts.frame_id[0]) == int(pj.ts.frame_id) == 5
    assert int(pt.ts.next_id[0]) == int(pj.ts.next_id)
    np.testing.assert_array_equal(pt.ts.track_id[0].numpy(),
                                  np.asarray(pj.ts.track_id))
    np.testing.assert_array_equal(pt.ts.state[0].numpy(),
                                  np.asarray(pj.ts.state))
    pt.reset()
    assert int(pt.ts.frame_id[0]) == 0 and int(pt.ts.next_id[0]) == 1


def test_frame_batch_2_equals_1(models):
    _, _, tm = models
    frames = torch.from_numpy(_frames(6, 4))
    o1 = TStream(tm, device="cpu", frame_batch=1, **KW).run_chunk(frames)
    o2 = TStream(tm, device="cpu", frame_batch=2, **KW).run_chunk(frames)
    assert o1[..., 6].sum() > 0
    torch.testing.assert_close(o1, o2, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="not divisible"):
        TStream(tm, device="cpu", frame_batch=2, **KW).run_chunk(frames[:3])


def test_n_streams_2_equals_two_pipelines(models):
    _, _, tm = models
    fa, fb = _frames(7, 3), _frames(8, 3)
    pm = TStream(tm, device="cpu", n_streams=2, **KW)
    om = pm.run_chunk(torch.from_numpy(np.stack([fa, fb])))
    assert tuple(om.shape) == (2, 3, 32, 7)
    for i, f in enumerate((fa, fb)):
        o1 = TStream(tm, device="cpu", **KW).run_chunk(torch.from_numpy(f))
        assert o1[..., 6].sum() > 0
        torch.testing.assert_close(om[i], o1, rtol=1e-3, atol=1e-3)
    assert pm.ts.frame_id.tolist() == [3, 3]
    with pytest.raises(ValueError, match="one stream"):
        pm.push_frame(torch.from_numpy(fa[:1]))


def test_packed_frames_equal_raw_frames(models):
    _, _, tm = models
    frames = _frames(9, 3)
    packed = ts_mod.pack_frames_np(frames)
    assert packed.shape == (3, H // 4, W // 4, 48)
    np.testing.assert_array_equal(packed, js_mod.pack_frames_np(frames))
    u8 = frames.astype(np.uint8)
    np.testing.assert_array_equal(ts_mod.pack_frames_np(u8),
                                  js_mod.pack_frames_np(u8))
    outs = [TStream(tm, device="cpu", **KW).run_chunk(torch.from_numpy(f))
            for f in (frames, packed, ts_mod.pack_frames_np(u8))]
    assert outs[0][..., 6].sum() > 0
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0], outs[2], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divisible by 4"):
        ts_mod.pack_frames_np(frames[:, :-2])


def test_arguments_that_raise(models):
    jm, params, tm = models
    for kw in (dict(n_streams=2, frame_batch=2),
               dict(n_streams=2, pipelined=True)):
        with pytest.raises(ValueError, match="n_streams > 1 supports neither"):
            TStream(tm, device="cpu", **kw, **KW)
        with pytest.raises(ValueError, match="n_streams > 1 supports neither"):
            JStream(jm, params, **kw, **KW)
    # pipelined and MultiStreamMOT run (tests/test_torch_port_parallel_
    # stream.py holds them against JAX); MultiStreamMOT over a mesh whose
    # ranks the streams do not divide over raises
    frames = torch.from_numpy(_frames(10, 2))
    a = TStream(tm, device="cpu", **KW).run_chunk(frames)
    assert torch.equal(TStream(tm, device="cpu", pipelined=True,
                               **KW).run_chunk(frames), a)
    multi = ts_mod.MultiStreamMOT(tm, n_streams=2, device="cpu", **KW)
    assert tuple(multi.tick(torch.stack([frames[0], frames[0]])).shape) == (
        2, 32, 7)
    with pytest.raises(ValueError, match="do not divide"):
        ts_mod.MultiStreamMOT(tm, n_streams=2, mesh=ProcessMesh(
            ("stream",), {"stream": 4}, object(), 0, torch.device("cpu")),
            **KW)
    # the knobs of the XLA program are accepted and change nothing
    b = TStream(tm, device="cpu", compiler_options=None, unroll=2,
                approx_topk=False, **KW).run_chunk(frames)
    assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            TStream(tm, **KW)      # the default device is the card
