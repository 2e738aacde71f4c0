"""dw7x7 as the registered op `unicorn_torch::dwconv7x7`
(unicorn_torch/ops/dwconv7x7.py) and the export tool
(unicorn_torch/tools/export_model.py), on the CPU.

The op: forward and gradients bit-equal to autograd of the plain version
(what the CPU path computed before the op existed) and to the autograd
Function the op replaces (its forward the plain version here, as the card
is not there), with torch.utils.checkpoint's recompute too;
torch.library.opcheck on CPU tensors, contiguous and permuted. The export:
tools/export_model.py on tests/test_torch_port_tools_cli.py's exp (3 dw7x7
a frame) in both modes; the saved program reloads, holds one
`unicorn_torch.dwconv7x7` node per dw7x7 call of the eager forward (the
calls counted through the wrapper), and gives the eager model's outputs
within 1e-5 and JAX's forward_whole (same weights) within the fp32 parity
tolerance of tests/test_torch_port_tiny_model.py, 1e-4 (the raw outputs),
or the drivers' (decoded boxes within 1e-2 px, scores within 1e-4).
"""
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

import test_cli_e2e as cli
import test_torch_port_tools_cli as tc
from unicorn_torch.convert import to_flax
from unicorn_torch.exp.base import get_exp
from unicorn_torch.models import blocks
from unicorn_torch.ops import dwconv7x7 as dw
from unicorn_torch.tools import export_model as ex
from unicorn_torch.tools.common import load_model

OP = torch.ops.unicorn_torch.dwconv7x7.default


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _PlainFunction(torch.autograd.Function):
    """The autograd Function the op replaces, its forward the plain
    version: forward saves (x, kdw, bias), backward is plain_backward."""

    @staticmethod
    def forward(ctx, x, kdw, bias):
        ctx.save_for_backward(x, kdw, bias)
        return dw.dwconv7x7_plain(x, kdw, bias)

    @staticmethod
    def backward(ctx, grad_out):
        return dw.plain_backward(dw.dwconv7x7_plain, ctx.saved_tensors,
                                 ctx.needs_input_grad, grad_out)


def _inputs(seed, dtype, taps4, shape=(2, 9, 13, 20)):
    g = torch.Generator().manual_seed(seed)
    B, H, W, C = shape
    x = torch.randn(B, H, W, C, generator=g).to(dtype)
    k = 0.1 * torch.randn((7, 7, 1, C) if taps4 else (7, 7, C), generator=g)
    b = 0.1 * torch.randn(C, generator=g)
    return x, k, b


def _grads(fn, inputs, needs, seed):
    leaves = [t.detach().clone().requires_grad_(n)
              for t, n in zip(inputs, needs)]
    y = fn(*leaves)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
        seed)).to(y.dtype)
    want = [t for t in leaves if t.requires_grad]
    return y.detach(), torch.autograd.grad(y, want, gy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("taps4", [False, True])
@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)])
def test_op_equals_plain_autograd_bit_for_bit(dtype, taps4, needs):
    inputs = _inputs(1, dtype, taps4)
    y, g = _grads(dw.dwconv7x7, inputs, needs, 2)
    for ref in (dw.dwconv7x7_plain, _PlainFunction.apply):
        y_ref, g_ref = _grads(ref, inputs, needs, 2)
        assert y.dtype == dtype and torch.equal(y, y_ref)
        assert y.is_contiguous()
        assert len(g) == len(g_ref) and all(
            torch.equal(a, b) for a, b in zip(g, g_ref))


def test_op_under_checkpoint():
    """torch.utils.checkpoint recomputes the op in the backward (remat
    True / "dw"): the same gradients as without."""
    x, k, b = _inputs(3, torch.float32, False)

    def f(x, k, b):
        return (dw.dwconv7x7(x, k, b) * 1.5).tanh()

    _, want = _grads(f, (x, k, b), (True, True, True), 4)
    _, got = _grads(lambda *a: checkpoint(f, *a, use_reentrant=False),
                    (x, k, b), (True, True, True), 4)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_opcheck_and_fake():
    x, k, b = _inputs(5, torch.float32, False)
    torch.library.opcheck(OP, (x, k, b))
    xt = torch.randn(1, 20, 9, 13).permute(0, 2, 3, 1)   # NCHW data
    torch.library.opcheck(OP, (xt, k, b))
    torch.library.opcheck(OP, (x.requires_grad_(), k.requires_grad_(), b))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        xf = torch.empty(2, 9, 13, 20, dtype=torch.bfloat16)
        y = dw.dwconv7x7(xf, torch.empty(7, 7, 20), torch.empty(20))
    assert y.shape == (2, 9, 13, 20) and y.dtype == torch.bfloat16
    assert y.stride() == (9 * 13 * 20, 13 * 20, 20, 1)


def test_the_function_is_gone_and_other_devices_raise():
    assert not hasattr(dw, "_DwConv7x7")
    x = torch.zeros(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dw.dwconv7x7(x, torch.zeros(7, 7, 16), torch.zeros(16))


@pytest.mark.cuda
def test_op_launches_the_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    x, k, b = (t.cuda() for t in _inputs(6, torch.float32, False))
    n0 = dw.launches
    y, g = _grads(dw.dwconv7x7, (x, k, b), (True, True, True), 7)
    assert dw.launches == n0 + 1
    y_ref, g_ref = _grads(dw.dwconv7x7_plain, (x, k, b), (True, True, True),
                          7)
    assert (y - y_ref).abs().max().item() <= 1e-4
    assert all(torch.allclose(a, c, atol=1e-4) for a, c in zip(g, g_ref))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tools_export")
    return {"root": root,
            **tc.write_weights(str(root), cli.TRACK_EXP, "track")}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy()


@pytest.mark.parametrize("mode", ["whole", "decode"])
def test_export_model_reloads_with_its_dw7x7_nodes(weights, mode):
    import jax.numpy as jnp

    from unicorn_tpu.exp.base import get_exp as jget_exp
    from unicorn_tpu.models.heads import decode_for_inference as jdecode
    from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

    out = str(weights["root"] / f"tiny_{mode}.pt2")
    program, _ = ex.main(["-f", weights["torch_exp"], "-c",
                          weights["torch_ckpt"], "--out", out, "--mode",
                          mode, "--device", "cpu"])
    loaded = torch.export.load(out)
    assert ex.dw_nodes(program) == ex.dw_nodes(loaded) == 3
    exp = get_exp(weights["torch_exp"])
    eager = ex.ExportForward(load_model(exp, weights["torch_ckpt"]),
                             mode == "decode")
    calls = [0]
    real = blocks.dwconv7x7

    def counted(*a):
        calls[0] += 1
        return real(*a)

    rng = np.random.RandomState(0)
    img = rng.rand(1, *exp.test_size, 3).astype(np.float32) * 255
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = loaded.module()(x)
        blocks.dwconv7x7 = counted
        try:
            want = eager(x)
        finally:
            blocks.dwconv7x7 = real
    assert calls[0] == ex.dw_nodes(loaded)
    got_l, spec = pytree.tree_flatten(got)
    want_l, spec_w = pytree.tree_flatten(want)
    assert spec == spec_w
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    # JAX's forward_whole on the same weights
    jexp = jget_exp(weights["jax_exp"])
    params = {"params": to_flax(torch.load(weights["torch_ckpt"])["model"])}
    raw, _ = jexp.get_model().apply(params, jnp.asarray(img),
                                    method=JUnicorn.forward_whole)
    if mode == "decode":
        dec = np.asarray(jdecode(raw, (8, 16, 32), mode="mot"))
        np.testing.assert_allclose(got[..., :4].numpy(), dec[..., :4],
                                   atol=1e-2, rtol=0)
        np.testing.assert_allclose(got[..., 4:].numpy(), dec[..., 4:],
                                   atol=1e-4, rtol=0)
        return
    assert len(raw) == len(got) == 3
    for level_t, level_j in zip(got, raw):
        for key, value in level_j.items():
            np.testing.assert_allclose(_nhwc(level_t[key]),
                                       np.asarray(value), atol=1e-4,
                                       err_msg=key)
