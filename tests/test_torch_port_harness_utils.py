"""The port's host utilities (unicorn_torch/utils/{model_utils, profiling,
setup_env, label_ops}.py) and its native space-to-depth packer
(csrc/pack.cpp through csrc/native.py, used by drivers/stream.py
pack_frames_np) against the JAX package's and their plain forms, on the CPU.

- count_params equals JAX's count of the same model's parameter tree (from
  jax.eval_shape of its init).
- count_flops counts one ConvNeXt block exactly as a hand count: the
  depthwise 7x7 kernel's 2 * 49 per output element, counted from its shape
  (its plain version on the CPU not counted again), and the two Linear
  layers' 2 * C * 4C each per pixel; LayerNorm, GELU, the scale and the
  residual count 0.
- Against XLA's cost analysis (the JAX package's get_model_info) on the
  JAX tests' tiny model (CSPDarknet 0.33 / 0.25) at 64x64, XLA counts 0.845
  of the port's figure: XLA leaves out the multiply-adds on a
  convolution's zero padding, which FlopCounterMode counts, and adds the
  elementwise operations, which it does not (the test's docstring has the
  numbers; it holds the ratio in [0.8, 0.9] and the elementwise share of
  XLA's count, XLA's less the port's padding-free multiply-adds, in
  (0, 5%]).
- seed_everything draws what JAX's does; convert_to_onehot is JAX's
  exactly (ties to the lowest index); adjust_labels_sz resizes within
  1e-6 of jax.image.resize (the antialiased shrink agrees within 1.2e-7
  on 0/1 maps, tests/test_torch_port_mask_losses.py; here on random maps)
  and one-hots equally wherever the top two resized values differ by more
  than 1e-5.
- The native packer equals the numpy form and JAX's pack_frames_np bit for
  bit, at 800x1280x3 among others; a packer that cannot be built raises
  (no fallback to numpy). trace (a Chrome trace holding a span's range,
  and the span's record, the records emptied on entry) and
  device_memory_stats ({} without a card) on the CPU.
"""
import glob
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unicorn_torch.convert import to_flax
from unicorn_torch.csrc import build, native
from unicorn_torch.drivers import stream as tstream
from unicorn_torch.models import blocks
from unicorn_torch.models.blocks import ConvNeXtBlock
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.ops.dwconv7x7 import dwconv7x7
from unicorn_torch.utils import label_ops as tlabel
from unicorn_torch.utils import model_utils as tmu
from unicorn_torch.utils import profiling as tprof
from unicorn_torch.utils import setup_env as tenv
from unicorn_tpu.drivers import stream as jstream
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.utils import label_ops as jlabel
from unicorn_tpu.utils import model_utils as jmu
from unicorn_tpu.utils import setup_env as jenv

TINY = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
            width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
            n_layer_att=0, use_attention=False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("cfg", [TINY, dict(TINY, use_mask=True,
                                            use_raft=True, up_rate=4)])
def test_count_params_matches_jax(cfg):
    tm = TUnicorn(**cfg)
    jm = JUnicorn(**cfg)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                              method=JUnicorn.init_all),
                            jnp.zeros((1, 64, 64, 3)))
    assert tmu.count_params(tm) == jmu.count_params(shapes)
    assert tmu.count_params(tm) == jmu.count_params(to_flax(tm.state_dict()))


@pytest.mark.parametrize("B,C,H,W", [(1, 8, 6, 10), (2, 20, 5, 7)])
def test_count_flops_convnext_block_hand_count(B, C, H, W):
    block = ConvNeXtBlock(C).eval()
    x = torch.randn(B, C, H, W)
    hand = 2 * B * H * W * C * 49 + 2 * (2 * B * H * W * C * 4 * C)
    assert tmu.count_flops(block, x) == hand
    # the kernel site is restored after the count
    assert blocks.dwconv7x7 is dwconv7x7


def _valid_tap_flops(model, imgs):
    """2 * the multiply-adds of the model's convolutions whose kernel tap
    falls inside the input, not on its zero padding."""
    total = [0]

    def hook(m, inp, out):
        x = inp[0]
        taps = F.conv2d(torch.ones(1, 1, *x.shape[2:]),
                        torch.ones(1, 1, *m.kernel_size), stride=m.stride,
                        padding=m.padding, dilation=m.dilation).sum().item()
        total[0] += 2 * taps * m.out_channels * m.in_channels // m.groups \
            * x.shape[0]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(imgs)
    for h in hooks:
        h.remove()
    return total[0]


def test_get_model_info_against_xla_cost_analysis():
    """XLA's cost analysis counts a convolution's multiply-adds only where
    the kernel overlaps the input, and every elementwise operation besides;
    FlopCounterMode counts every tap, the zero padding's too, and no
    elementwise operation. At 64x64, where the 3x3 taps of the 2x2 to 8x8
    maps fall mostly on padding, XLA counts 0.845 of the port's figure
    (measured on this build: 78543056 against 92928000); XLA's count less
    the port's padding-free multiply-adds, the elementwise share, is 2.6% of
    XLA's."""
    tm = TUnicorn(**TINY, generator=torch.Generator().manual_seed(0)).eval()
    jm = JUnicorn(**TINY)
    params = {"params": to_flax(tm.state_dict())}
    shape = (1, 64, 64, 3)
    info_t = tmu.get_model_info(tm, shape)

    def fwd(p, x):
        return jm.apply(p, x, method=JUnicorn.forward_whole)

    info_j = jmu.get_model_info(fwd, params, shape)
    assert info_t.split(",")[0] == info_j.split(",")[0]     # Params
    assert info_t.endswith("@ 64x64")
    cost = jax.jit(fwd).lower(params, jnp.zeros(shape)).compile() \
        .cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)
                ["flops"])
    imgs = torch.zeros(1, 3, 64, 64)
    port = tmu.count_flops(tm, imgs)
    assert 0.8 <= xla / port <= 0.9, xla / port
    elementwise = xla - _valid_tap_flops(tm, imgs)
    assert 0 < elementwise <= 0.05 * xla, elementwise / xla


def test_step_timer_and_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(tmp_path / "first")):
        with tprof.span("stale"):
            pass
    with tprof.trace(str(log_dir)):
        with tprof.span("harness_frame"):
            (torch.randn(16, 16) @ torch.randn(16, 16)).sum()
    assert [r.name for r in tprof.spans()] == ["harness_frame"]
    r = tprof.spans()[0]
    assert r.parent == -1 and r.root == 0 and r.end_ns > r.start_ns
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    frame = [e for e in events if e.get("name") == "harness_frame"]
    assert len(frame) == 1 and frame[0].get("cat") == "cpu_op"
    tprof.clear_spans()
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}


def test_seed_everything_draws_like_jax():
    draws = []
    for env in (tenv, jenv):
        env.seed_everything(2 ** 31 + 7)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]


def test_configure_omp_keeps_set_variables(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    monkeypatch.delenv("MKL_NUM_THREADS", raising=False)
    tenv.configure_omp(5)
    assert os.environ["OMP_NUM_THREADS"] == "3"
    assert os.environ["MKL_NUM_THREADS"] == "5"


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_convert_to_onehot_matches_jax(axis):
    x = np.random.RandomState(1).randint(0, 3, (3, 4, 5)).astype(np.float32)
    got = tlabel.convert_to_onehot(torch.from_numpy(x), axis)
    ref = np.asarray(jlabel.convert_to_onehot(jnp.asarray(x), axis))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tlabel.convert_to_onehot(torch.from_numpy(x), axis - 3).numpy(), ref)


@pytest.mark.parametrize("dh,dw", [(5, 7), (24, 20), (9, 31)])
def test_adjust_labels_sz_matches_jax(dh, dw):
    lbs = np.random.RandomState(2).rand(2, 3, 12, 16).astype(np.float32)
    got = tlabel.adjust_labels_sz(torch.from_numpy(lbs), dh, dw).numpy()
    ref = np.asarray(jlabel.adjust_labels_sz(jnp.asarray(lbs), dh, dw))
    resized_t = tlabel.resize_antialias(torch.from_numpy(lbs), dh, dw)
    resized_j = np.asarray(jax.image.resize(jnp.asarray(lbs),
                                            (2, 3, dh, dw), "bilinear"))
    np.testing.assert_allclose(resized_t.numpy(), resized_j, atol=1e-6)
    top2 = np.sort(resized_j, axis=1)
    clear = (top2[:, -1] - top2[:, -2]) > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(1)[clear], ref.argmax(1)[clear])
    assert got.shape == ref.shape == (2, 3, dh, dw)
    np.testing.assert_array_equal(got.sum(1), 1.0)


@pytest.mark.parametrize("shape", [(1, 800, 1280, 3), (2, 8, 12, 3),
                                   (3, 4, 4, 1), (1, 16, 8, 4)])
def test_native_pack_equals_numpy_form(shape):
    frames = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
    got = native.pack_frames_s2d4(frames)
    plain = tstream.pack_frames_plain(frames)
    assert got.shape == (shape[0], shape[1] // 4, shape[2] // 4,
                         16 * shape[3]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(tstream.pack_frames_np(frames), plain)
    np.testing.assert_array_equal(plain, jstream.pack_frames_np(frames))
    # a strided view is packed as its contiguous copy
    view = np.concatenate([frames, frames], 2)[:, :, ::2]
    np.testing.assert_array_equal(native.pack_frames_s2d4(view),
                                  tstream.pack_frames_plain(view))


def test_pack_refuses_and_raises(monkeypatch, tmp_path):
    u8 = np.zeros((1, 8, 6, 3), np.uint8)
    with pytest.raises(ValueError, match="divisible by 4"):
        tstream.pack_frames_np(u8)
    with pytest.raises(ValueError, match="uint8"):
        native.pack_frames_s2d4(u8.astype(np.float32))
    # floats take the numpy form
    f = np.random.RandomState(4).rand(1, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(tstream.pack_frames_np(f),
                                  jstream.pack_frames_np(f))
    # a packer that cannot be built raises: no quiet numpy fallback
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed for pack.cpp"):
        tstream.pack_frames_np(np.zeros((1, 8, 8, 3), np.uint8))


def test_fuse_conv_norm_is_the_identity():
    m = ConvNeXtBlock(8)
    assert tmu.fuse_conv_norm(m) is m
