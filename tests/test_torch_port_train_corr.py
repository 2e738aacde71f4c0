"""The port's training ops (unicorn_torch/ops) against the JAX package's, on
the CPU: the plain versions of the three correlation training kernels, the
differentiable dispatch `correlation_propagate_train`, and the gradients of
`dwconv7x7` and `ms_deform_attn`.

On the CPU the port runs its plain PyTorch versions; the CUDA kernels are
compared with them in the card-gated tests at the end (and in
chip_smoke.py's kernel phase).

Tolerances. Correlation: out, lse, dE0, dE1, dV against the Pallas custom-VJP
kernels in interpret mode and against jax.grad of the dense form: rtol 1e-4,
atol 1e-5, the bounds tests/test_pallas.py holds the Pallas kernels to (all
take the same fp32 softmax in other orders). dw7x7 and MSDA gradients:
rtol 1e-4, atol 1e-5 in fp32 (another order of the same 49-term and
32-term sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.ops import correlation_kernel as ck
from unicorn_torch.ops import deform_attn as tda
from unicorn_torch.ops import dwconv7x7 as tdw
from unicorn_tpu.ops import deform_attn as jda
from unicorn_tpu.ops import pallas_convnext as jdw
from unicorn_tpu.ops import pallas_correlation as jpc
from unicorn_tpu.ops.correlation import correlation_propagate_dense

# B, N, C, K: and the edges of the bwd_i kernel's tiling (N one below and
# above its half tiles of 64 and tiles of 128 rows, C of one and two channel
# groups of 64, K above 1)
SHAPES = {"n200": (1, 200, 16, 2), "ragged77": (2, 77, 16, 3),
          "n63c16": (1, 63, 16, 2), "n65c48": (1, 65, 48, 3),
          "n127c96": (1, 127, 96, 2), "n129c16": (2, 129, 16, 4)}
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(shape, seed=0, scale=1.0):
    B, N, C, K = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, C).astype(np.float32) * scale,
            rng.randn(B, N, C).astype(np.float32) * scale,
            rng.rand(B, K, N).astype(np.float32),
            rng.randn(B, K, N).astype(np.float32))


def _plain_all(e0, e1, v, dout, chunk):
    """out, lse, dE0, dE1, dV through the three plain versions."""
    t = [torch.from_numpy(a) for a in (e0, e1, v, dout)]
    out, lse = ck.correlation_fwd_lse_plain(*t[:3], chunk=chunk)
    c = (out * t[3]).sum(1, keepdim=True)
    de0, dv = ck.correlation_bwd_i_plain(*t[:3], lse, t[3], c, chunk=chunk)
    de1 = ck.correlation_bwd_j_plain(*t[:3], lse, t[3], c, chunk=chunk)
    return [x.numpy() for x in (out, lse, de0, de1, dv)]


@pytest.mark.parametrize("name", SHAPES)
def test_plain_kernels_match_pallas_vjp_and_dense_grad(name):
    shape = SHAPES[name]
    N = shape[1]
    e0, e1, v, dout = _inputs(shape)
    j = [jnp.asarray(a) for a in (e0, e1, v)]
    out_j, lse_j = jpc._corr_fwd_lse(*j, 128, 128, True)
    _, vjp_p = jax.vjp(lambda a, b, c: jpc.correlation_propagate_pallas_vjp(
        a, b, c, 128, 128, True), *j)
    out_d, vjp_d = jax.vjp(correlation_propagate_dense, *j)
    names = ("out", "lse", "dE0", "dE1", "dV")
    for chunk in (64, 1024):     # several chunks with a ragged last, and one
        got = _plain_all(e0, e1, v, dout, chunk)
        for ref in ((out_j, lse_j[:, :, :N]) + vjp_p(jnp.asarray(dout)),
                    (out_d, None) + vjp_d(jnp.asarray(dout))):
            for n, a, b in zip(names, got, ref):
                if b is not None:
                    np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                               atol=ATOL, err_msg=n)


def test_plain_kernels_sharp_softmax():
    """Embeddings x10: scores of several hundred, where an fp32 ulp of a
    score is 3e-5 and enters the exponential: rtol 1e-3 on out, atol 1e-3 on
    lse; gradients within 5e-3 of each tensor's largest magnitude (P carries
    the exponential's relative error of ~1e-4 and dE0, dE1 multiply it by
    embeddings of magnitude ~30; measured 1.2e-3)."""
    e0, e1, v, dout = _inputs((1, 256, 16, 1), seed=1, scale=10.0)
    j = [jnp.asarray(a) for a in (e0, e1, v)]
    out_d, vjp_d = jax.vjp(correlation_propagate_dense, *j)
    got = _plain_all(e0, e1, v, dout, 100)
    assert all(np.isfinite(a).all() for a in got)
    np.testing.assert_allclose(got[0], np.asarray(out_d), rtol=1e-3, atol=ATOL)
    lse_d = jax.nn.logsumexp(jnp.einsum("bnc,bmc->bnm", j[0], j[1]), axis=1)
    np.testing.assert_allclose(got[1][:, 0], np.asarray(lse_d), atol=1e-3)
    for a, b in zip(got[2:], vjp_d(jnp.asarray(dout))):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 5e-3 * np.abs(b).max()


@pytest.mark.parametrize("name", SHAPES)
def test_propagate_train_cpu_matches_jax_train(name):
    """The CPU dispatch (plain streaming version under autograd) against the
    JAX dispatch off the TPU and its gradients."""
    e0, e1, v, dout = _inputs(SHAPES[name], seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (e0, e1, v)]
    before = dict(ck.train_launches)
    out = ck.correlation_propagate_train(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    assert ck.train_launches == before     # a plain version is not a launch
    out_j, vjp = jax.vjp(jpc.correlation_propagate_train,
                         *(jnp.asarray(a) for a in (e0, e1, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_train_wrappers_check_their_inputs():
    e0, e1, v, dout = (torch.from_numpy(a) for a in _inputs((1, 64, 16, 2)))
    out, lse = ck.correlation_fwd_lse_plain(e0, e1, v)
    c = (out * dout).sum(1, keepdim=True)
    with pytest.raises(ValueError, match="CUDA"):    # the kernels: CUDA only
        ck.correlation_fwd_lse_cuda(e0, e1, v)
    with pytest.raises(ValueError, match="CUDA"):
        ck.correlation_bwd_i_cuda(e0, e1, v, lse, dout, c)
    with pytest.raises(ValueError, match="CUDA"):
        ck.correlation_bwd_j_cuda(e0, e1, v, lse, dout, c)
    with pytest.raises(ValueError, match="expected lse"):
        ck.correlation_bwd_i_plain(e0, e1, v, lse[:, 0], dout, c)
    with pytest.raises(ValueError, match="expected e0, e1"):
        ck.correlation_propagate_train(e0, e1[:, :32], v)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.correlation_propagate_train(e0.to("meta"), e1.to("meta"),
                                       v.to("meta"))


def test_dwconv7x7_gradients_match_jax():
    """On the CPU dwconv7x7 is the plain version under autograd; jax.grad of
    `dwconv7x7` goes through the JAX package's custom VJP (`_dw_bwd`)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    k = (0.2 * rng.randn(7, 7, 8)).astype(np.float32)
    b = (0.2 * rng.randn(8)).astype(np.float32)
    g = rng.randn(2, 9, 11, 8).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    before = tdw.launches
    y = tdw.dwconv7x7(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    assert tdw.launches == before
    y_j, vjp = jax.vjp(jdw.dwconv7x7, jnp.asarray(x),
                       jnp.asarray(k)[:, :, None, :], jnp.asarray(b))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=RTOL,
                               atol=ATOL)
    dx, dk, db = vjp(jnp.asarray(g))
    for a, ref in zip(grads, (dx, dk[:, :, 0, :], db)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("method", ["auto", "pallas_factored", "pallas",
                                    "gather"])
def test_ms_deform_attn_gradients_match_jax_gather(method):
    """Every method's CPU form under autograd against jax.grad of
    ms_deform_attn("gather"): dvalue, dlocations, dweights. Locations stay
    clear of cell borders by 1e-3 of a cell, where the bilinear weights'
    derivative jumps."""
    rng = np.random.RandomState(4)
    B, L, H, W, M, D, Lq, P = 2, 2, 6, 7, 2, 4, 11, 3
    value = rng.randn(B, L, H, W, M, D).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    px = locs * np.array([W, H], np.float32) - 0.5
    near = np.abs(px - np.round(px)) < 1e-3
    locs = np.where(near, locs + 0.01, locs).astype(np.float32)
    attw = rng.rand(B, Lq, M, L, P).astype(np.float32)
    g = rng.randn(B, Lq, M * D).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (value, locs, attw)]
    out = tda.ms_deform_attn(*leaves, method=method)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    out_j, vjp = jax.vjp(
        lambda v, l, a: jda.ms_deform_attn(v, l, a, method="gather"),
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attw))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    for a, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=1e-4)


# ------------------------------------------------------------ on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


CARD_SHAPES = {"train": ((2, 16000, 128, 1), 0.3), "ragged": ((2, 77, 16, 16), 1.0),
               "sharp": ((2, 1000, 16, 3), 10.0), "c96": ((1, 300, 96, 2), 1.0),
               "n63c16": ((1, 63, 16, 2), 1.0), "n65c48": ((1, 65, 48, 3), 1.0),
               "n127c96": ((1, 127, 96, 2), 1.0), "n129c16": ((2, 129, 16, 4), 1.0),
               "n129c128k16": ((1, 129, 128, 16), 1.0),
               "n257c64": ((2, 257, 64, 1), 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_SHAPES)
def test_training_kernels_match_plain_on_card(name):
    """Each of the three kernels against its plain version on the same
    inputs (both backward passes get the kernel forward's lse and c): out
    rtol 1e-4 (sharp: 1e-3), atol 1e-5; lse 1e-5 + 2e-6 |lse|; gradients
    within 1e-4 (sharp: 1e-3) of the tensor's largest magnitude, plus
    1e-6."""
    _need_card()
    shape, scale = CARD_SHAPES[name]
    rtol = 1e-3 if scale > 1 else 1e-4
    e0, e1, v, dout = (torch.from_numpy(a).cuda()
                       for a in _inputs(shape, seed=5, scale=scale))
    before = dict(ck.train_launches)
    out, lse = ck.correlation_fwd_lse_cuda(e0, e1, v)
    c = (out * dout).sum(1, keepdim=True)
    de0, dv = ck.correlation_bwd_i_cuda(e0, e1, v, lse, dout, c)
    de1 = ck.correlation_bwd_j_cuda(e0, e1, v, lse, dout, c)
    assert ck.train_launches == {k: n + 1 for k, n in before.items()}
    out_p, lse_p = ck.correlation_fwd_lse_plain(e0, e1, v)
    de0_p, dv_p = ck.correlation_bwd_i_plain(e0, e1, v, lse, dout, c)
    de1_p = ck.correlation_bwd_j_plain(e0, e1, v, lse, dout, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_p, rtol=rtol, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=2e-6, atol=1e-5)
    for a, b in ((de0, de0_p), (de1, de1_p), (dv, dv_p)):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max() <= rtol * b.abs().max() + 1e-6


@pytest.mark.cuda
def test_functions_launch_kernels_and_return_gradients_on_card():
    """On a CUDA tensor the three wrappers launch their kernels in the
    forward, with gradients on, and return the plain versions' gradients
    (fp32: within 1e-4 of each tensor's largest magnitude)."""
    _need_card()
    rng = np.random.RandomState(6)

    def check(fn_k, fn_p, arrays, count):
        leaves = [torch.from_numpy(a).cuda().requires_grad_() for a in arrays]
        n0 = count()
        y = fn_k(*leaves)
        assert count() == n0 + 1
        gy = torch.randn_like(y)
        gk = torch.autograd.grad(y, leaves, gy)
        leaves_p = [torch.from_numpy(a).cuda().requires_grad_() for a in arrays]
        gp = torch.autograd.grad(fn_p(*leaves_p), leaves_p, gy)
        for a, b in zip(gk, gp):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-6

    e0, e1, v, _ = _inputs((2, 300, 32, 2), seed=7)
    check(ck.correlation_propagate_train,
          lambda a, b, c: ck.correlation_propagate_plain(a, b, c), (e0, e1, v),
          lambda: ck.train_launches["fwd_lse"])
    x = rng.randn(2, 20, 24, 16).astype(np.float32)
    k = (0.2 * rng.randn(7, 7, 16)).astype(np.float32)
    b = (0.2 * rng.randn(16)).astype(np.float32)
    check(tdw.dwconv7x7, tdw.dwconv7x7_plain, (x, k, b), lambda: tdw.launches)
    value = rng.randn(2, 2, 6, 7, 2, 8).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (2, 11, 2, 2, 3, 2)).astype(np.float32)
    attw = rng.rand(2, 11, 2, 2, 3).astype(np.float32)
    check(tda.ms_deform_attn,
          lambda a, l, w: tda.ms_deform_attn_plain(a, l, w, "factored"),
          (value, locs, attw), lambda: tda.launches)
