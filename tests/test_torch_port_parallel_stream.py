"""The port's pipelined streaming and MultiStreamMOT (unicorn_torch/drivers/
stream.py) against the port's own plain paths and against the JAX
package's StreamingMOTPipeline(pipelined=True) and MultiStreamMOT(mesh=
None), on the CPU.

Model: the JAX stream tests' tiny Unicorn (tests/test_stream.py:14-22,
CSPDarknet depth 0.33 width 0.25, "conv" interaction, 64x64 frames) from
the port's seeded init, the obj / cls prediction biases raised by 6 so that
detections clear the tracker's thresholds; JAX gets the same weights
through unicorn_torch.convert.to_flax.

Tolerances.
  * pipelined against the port's plain run_chunk, over two chunks (the
    carried state continues): equal, as the tracker steps run in the same
    order on the same detections;
  * against JAX: valid rows and their ids equal, scores within 1e-4,
    boxes within rtol 1e-4 + 5e-4 px: the port's streaming parity bounds
    (tests/test_torch_port_stream.py `_compare`) with the relative 1e-4 to
    which the two frameworks' activations agree
    (tests/test_torch_port_model.py), as the Kalman filter carries the
    detections' fp32 differences from frame to frame (measured: 6.0e-4 px,
    5.5e-5 relative, after 9 frames). JAX's own pipelined-vs-plain bound
    (tests/test_stream.py:149, 1e-5) holds inside one framework;
  * MultiStreamMOT.tick over 4 ticks: equal to the port's
    run_chunk(n_streams=S); S independent single-stream pipelines within
    tests/test_stream.py:107's rtol 1e-3, atol 1e-3; JAX's tick at the
    bounds above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.drivers.stream import MultiStreamMOT as TMulti
from unicorn_torch.drivers.stream import StreamingMOTPipeline as TStream
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.parallel import ProcessMesh, make_mesh
from unicorn_tpu.drivers.stream import MultiStreamMOT as JMulti
from unicorn_tpu.drivers.stream import StreamingMOTPipeline as JStream
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
TINY = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
            width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
            n_layer_att=0, use_attention=False)
KW = dict(input_size=(H, W), num_classes=1, conf_thre=0.3, nms_thre=0.65,
          track_thresh=0.5, max_dets=16, max_tracks=16, n_cand=32)
S = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(seed, n):
    """n frames of a panning random texture, (n, H, W, 3) float32."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(H, W + 3 * n, 3) * 255).astype(np.uint8)
    return np.stack([base[:, 3 * t:3 * t + W] for t in range(n)]).astype(
        np.float32)


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    tm = TUnicorn(**TINY, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.startswith(("head.obj_preds.", "head.cls_preds.")) \
                    and name.endswith(".bias"):
                p += 6.0
    return tm, JUnicorn(**TINY), {"params": to_flax(tm.state_dict())}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _compare(out_t, out_j):
    """Packed rows (..., T, 7) [x1, y1, x2, y2, score, id, valid]: the valid
    mask and the ids of valid rows equal, their boxes within rtol 1e-4 +
    5e-4 px and scores within 1e-4; returns the number of valid rows."""
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


def test_pipelined_equals_plain_and_jax(models):
    tm, jm, params = models
    chunks = [_frames(1, 5), _frames(2, 4)]
    plain = TStream(tm, device="cpu", **KW)
    piped = TStream(tm, device="cpu", pipelined=True, frame_batch=2, **KW)
    jpiped = JStream(jm, params, pipelined=True, approx_topk=False, **KW)
    n_valid = 0
    for c in chunks:
        o_plain, o_piped = plain.run_chunk(_t(c)), piped.run_chunk(_t(c))
        assert tuple(o_piped.shape) == (len(c), 16, 7)
        assert torch.equal(o_piped, o_plain)
        n_valid += _compare(o_piped, jpiped.run_chunk(jnp.asarray(c)))
    assert n_valid > 0, "no track was emitted: the comparison is empty"
    for a, b in zip(piped.ts, plain.ts):
        assert torch.equal(a, b)
    assert int(piped.ts.frame_id[0]) == int(jpiped.ts.frame_id) == 9
    # push_frame stays the one-frame step
    f = _t(_frames(3, 1))
    assert torch.equal(piped.push_frame(f), plain.push_frame(f))


def test_multistream_tick_equals_run_chunk_pipelines_and_jax(models):
    tm, jm, params = models
    frames = np.stack([_frames(10 + s, 4) for s in range(S)])  # (S, N, ...)
    multi = TMulti(tm, n_streams=S, device="cpu", **KW)
    jmulti = JMulti(jm, params, n_streams=S, mesh=None, approx_topk=False,
                    **KW)
    ticks, jticks = [], []
    for t in range(frames.shape[1]):
        ticks.append(multi.tick(_t(frames[:, t])))
        jticks.append(np.asarray(jmulti.tick(jnp.asarray(frames[:, t]))))
    out = torch.stack(ticks, 1)                                # (S, N, T, 7)
    assert tuple(out.shape) == (S, 4, 16, 7)
    assert int((out[..., 6] > 0.5).sum()) > 0
    chunk = TStream(tm, device="cpu", n_streams=S, **KW).run_chunk(
        _t(frames))
    assert torch.equal(out, chunk)
    assert _compare(out, np.stack(jticks, 1)) > 0
    for s in range(S):
        one = TStream(tm, device="cpu", **KW).run_chunk(_t(frames[s]))
        torch.testing.assert_close(out[s], one, rtol=1e-3, atol=1e-3)
    assert multi.states.frame_id.tolist() == [4] * S
    multi.pipe.reset()
    assert multi.states.frame_id.tolist() == [0] * S
    with pytest.raises(ValueError, match="streams given"):
        multi.tick(_t(frames[:2, 0]))
    # a mesh of one process serves every stream; streams that do not
    # divide over the mesh's ranks raise
    mesh1 = make_mesh((1,), ("stream",), device="cpu")
    one_rank = TMulti(tm, n_streams=S, mesh=mesh1, **KW)
    assert torch.equal(torch.stack([one_rank.tick(_t(frames[:, t]))
                                    for t in range(4)], 1), out)
    with pytest.raises(ValueError, match="do not divide"):
        TMulti(tm, n_streams=S, mesh=ProcessMesh(
            ("stream",), {"stream": S + 1}, object(), 0,
            torch.device("cpu")), **KW)
