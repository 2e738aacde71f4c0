"""The correlation wrappers over groups of label maps and padded channels
(unicorn_torch/ops/correlation_kernel.py: `propagate_grouped`,
`fwd_lse_grouped`, `bwd_grouped`, `propagate_train_grouped`) against the JAX
package, which takes any K and C.

The kernels take at most 16 label maps a call and C a multiple of 16
(serving) or 4 (training); the wrappers zero-pad C and split K into groups.
On the CPU the grouping runs on the plain per-group versions with group
sizes 16 and 5, so its arithmetic is tested here; the card-marked tests at
the end hold the grouped kernels against the plain versions.

Tolerances: those of tests/test_torch_port_train_corr.py (training: rtol
1e-4, atol 1e-5 against the Pallas custom VJP in interpret mode and against
jax.vjp of the dense form) and tests/test_torch_port_correlation.py
(serving with bf16 dots: rtol 1e-4, atol 1e-5 against the Pallas kernel in
interpret mode). Every form takes the same fp32 softmax in another order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.ops import correlation_kernel as ck
from unicorn_tpu.ops import pallas_correlation as jpc
from unicorn_tpu.ops.correlation import correlation_propagate_dense

RTOL, ATOL = 1e-4, 1e-5
N_TRAIN, C_TRAIN = 130, 16
PLAIN = (ck.correlation_fwd_lse_plain, ck.correlation_bwd_i_plain,
         ck.correlation_bwd_j_plain)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(B, N, C, K, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, C).astype(np.float32) * scale,
            rng.randn(B, N, C).astype(np.float32) * scale,
            rng.rand(B, K, N).astype(np.float32),
            rng.randn(B, K, N).astype(np.float32))


@functools.cache
def _jax_train(K, C=C_TRAIN):
    """Inputs and the JAX references at (1, N_TRAIN, C, K): out, lse and
    (dE0, dE1, dV) from the Pallas custom VJP in interpret mode, and out and
    the gradients from jax.vjp of the dense form."""
    e0, e1, v, dout = _inputs(1, N_TRAIN, C, K, seed=K + C)
    j = [jnp.asarray(a) for a in (e0, e1, v)]
    out_p, lse_p = jpc._corr_fwd_lse(*j, 128, 128, True)
    _, vjp_p = jax.vjp(lambda a, b, c: jpc.correlation_propagate_pallas_vjp(
        a, b, c, 128, 128, True), *j)
    out_d, vjp_d = jax.vjp(correlation_propagate_dense, *j)
    g = jnp.asarray(dout)
    refs = ((out_p, lse_p[:, :, :N_TRAIN], *vjp_p(g)),
            (out_d, None, *vjp_d(g)))
    return (e0, e1, v, dout), [[None if a is None else np.asarray(a)
                                for a in ref] for ref in refs]


def _recording(op, seen):
    """op, recording the (C, K) of every call."""
    def run(e0, e1, v, *rest):
        seen.append((e0.shape[2], v.shape[1]))
        return op(e0, e1, v, *rest)
    return run


def _grouped_train(arrays, group, ops=PLAIN):
    """out, lse, dE0, dE1, dV of the grouped Function on the given ops."""
    e0, e1, v, dout = (torch.from_numpy(a) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (e0, e1, v)]
    out = ck.propagate_train_grouped(*leaves, ops=ops, group=group)
    grads = torch.autograd.grad(out, leaves, dout)
    _, lse = ck.fwd_lse_grouped(ck.correlation_fwd_lse_plain, e0, e1, v, group)
    return [t.detach().numpy() for t in (out, lse, *grads)]


def _assert_matches(got, refs):
    for ref in refs:
        for name, a, b in zip(("out", "lse", "dE0", "dE1", "dV"), got, ref):
            if b is not None:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                           err_msg=name)


@pytest.mark.parametrize("K,group", [(17, 16), (17, 5), (33, 16), (33, 5)])
def test_train_grouping_matches_jax(K, group):
    arrays, refs = _jax_train(K)
    seen = []
    ops = tuple(_recording(op, seen) for op in PLAIN)
    _assert_matches(_grouped_train(arrays, group, ops), refs)
    sizes = [group] * (K // group) + ([K % group] if K % group else [])
    # the forward, then the backward (bwd_i and bwd_j a group)
    calls = sizes + [k for k in sizes for _ in range(2)]
    assert seen == [(C_TRAIN, k) for k in calls]


def test_train_grouping_with_the_full_c_fails():
    """The trap: each group must take its own c_g = sum over its maps of
    out_k dO_k. A grouping that passes the full c to every group subtracts
    it once per group, and the comparison above catches it."""
    arrays, refs = _jax_train(17)
    e0, e1, v, dout = (torch.from_numpy(a) for a in arrays)
    out, lse = ck.fwd_lse_grouped(ck.correlation_fwd_lse_plain, e0, e1, v, 5)
    c_full = (out * dout).sum(dim=1, keepdim=True)
    de0 = de1 = 0
    for vg, dg in zip(v.split(5, dim=1), dout.split(5, dim=1)):
        de0 = de0 + ck.correlation_bwd_i_plain(e0, e1, vg, lse, dg, c_full)[0]
        de1 = de1 + ck.correlation_bwd_j_plain(e0, e1, vg, lse, dg, c_full)
    for got, ref in ((de0, refs[0][2]), (de1, refs[0][3])):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # the same groups with their own c pass
    _assert_matches(_grouped_train(arrays, 5), refs)


def test_train_pads_channels():
    """C = 10: the ops get e0, e1 zero-padded to 12 channels; dE0 and dE1
    come back with 10."""
    arrays, refs = _jax_train(3, C=10)
    seen = []
    ops = tuple(_recording(op, seen) for op in PLAIN)
    got = _grouped_train(arrays, 16, ops)
    assert {c for c, _ in seen} == {12}
    assert got[2].shape == got[3].shape == (1, N_TRAIN, 10)
    _assert_matches(got, refs)


def _serving_plain(e0, e1, v):
    return ck.correlation_propagate_plain(e0, e1, v, bf16_dots=True)


@pytest.mark.parametrize("K,C,group", [(17, 32, 16), (17, 32, 5),
                                       (3, 24, 16)])
def test_serving_grouping_matches_pallas_bf16(K, C, group):
    """Groups of label maps, and C = 24 zero-padded to 32, through the plain
    bf16-dots version against the Pallas kernel in interpret mode."""
    e0, e1, v, _ = _inputs(2, 77, C, K, seed=K + C)
    seen = []
    out = ck.propagate_grouped(_recording(_serving_plain, seen),
                               *map(torch.from_numpy, (e0, e1, v)),
                               group).numpy()
    ref = np.asarray(jpc.correlation_propagate_pallas(
        *map(jnp.asarray, (e0, e1, v)), block_i=128, block_j=128,
        interpret=True, bf16_dots=True))
    sizes = [group] * (K // group) + ([K % group] if K % group else [])
    assert seen == [(-(-C // 16) * 16, k) for k in sizes]
    assert out.shape == (2, K, 77) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_grouped_function_checks_shapes():
    e0, e1, v, _ = (torch.from_numpy(a) for a in _inputs(1, 40, 8, 20))
    with pytest.raises(ValueError, match="expected e0, e1"):
        ck.propagate_train_grouped(e0, e1[:, :32], v, ops=PLAIN)


# ------------------------------------------------------------ on the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close_grads(got, ref, rtol):
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max() <= rtol * b.abs().max() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,K", [(2, 300, 128, 17), (1, 257, 128, 33),
                                     (1, 300, 10, 17)])
def test_grouped_training_kernels_match_plain_on_card(B, N, C, K):
    """ceil(K/16) launches of each kernel, no plain code: out at rtol 1e-4,
    atol 1e-5, and the Function's gradients within 1e-4 of each tensor's
    largest magnitude of autograd through the plain version; C above 128
    raises."""
    _need_card()
    e0, e1, v, dout = (torch.from_numpy(a).cuda()
                       for a in _inputs(B, N, C, K, seed=8))
    leaves = [t.clone().requires_grad_() for t in (e0, e1, v)]
    before = dict(ck.train_launches)
    y = ck.correlation_propagate_train(*leaves)
    grads = torch.autograd.grad(y, leaves, dout)
    groups = -(-K // ck.K_MAX)
    assert ck.train_launches == {k: n + groups for k, n in before.items()}
    leaves_p = [t.clone().requires_grad_() for t in (e0, e1, v)]
    y_p = ck.correlation_propagate_plain(*leaves_p)
    grads_p = torch.autograd.grad(y_p, leaves_p, dout)
    torch.testing.assert_close(y, y_p, rtol=RTOL, atol=ATOL)
    _close_grads(grads, grads_p, RTOL)
    wide = torch.zeros(1, 40, ck.C_MAX_TRAIN + 2, device="cuda")
    with pytest.raises(ValueError, match="at most 128"):
        ck.correlation_propagate_train(wide, wide, v[:1, :, :40].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,K", [(2, 1000, 128, 17), (1, 257, 128, 33),
                                     (2, 300, 24, 17)])
def test_grouped_serving_kernel_matches_plain_on_card(B, N, C, K):
    _need_card()
    e0, e1, v, _ = (torch.from_numpy(a).cuda()
                    for a in _inputs(B, N, C, K, seed=9, scale=0.3))
    for bf16_dots in (True, False):
        n0 = ck.launches
        yk = ck.correlation_propagate_cuda(e0, e1, v, bf16_dots=bf16_dots)
        assert ck.launches == n0 + -(-K // ck.K_MAX)
        yp = ck.correlation_propagate_plain(e0, e1, v, bf16_dots=bf16_dots)
        assert bool(torch.isfinite(yk).all())
        torch.testing.assert_close(yk, yp, rtol=RTOL, atol=ATOL)
    wide = torch.zeros(1, 40, ck.C_MAX + 1, device="cuda")
    with pytest.raises(ValueError, match="kernel takes 1 to 192"):
        ck.correlation_propagate_cuda(wide, wide, v[:1, :, :40].contiguous())


# the edges of the 128-row tiles and 64-row half tiles of the redesigned
# fwd_lse and bwd_j (tests/test_torch_port_train_corr.py SHAPES), and K = 16
EDGES = {"n200": (1, 200, 16, 2), "ragged77": (2, 77, 16, 3),
         "n63c16": (1, 63, 16, 2), "n65c48": (1, 65, 48, 3),
         "n127c96": (1, 127, 96, 2), "n129c16": (2, 129, 16, 4),
         "n129c128k16": (1, 129, 128, 16), "n300c64k16": (2, 300, 64, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGES)
def test_fwd_lse_and_bwd_j_match_plain_on_card(name):
    """out rtol 1e-4, atol 1e-5; lse 1e-5 + 2e-6 |lse|; dE1 within 1e-4 of
    its largest magnitude, plus 1e-6."""
    _need_card()
    e0, e1, v, dout = (torch.from_numpy(a).cuda()
                       for a in _inputs(*EDGES[name], seed=10))
    out, lse = ck.correlation_fwd_lse_cuda(e0, e1, v)
    out_p, lse_p = ck.correlation_fwd_lse_plain(e0, e1, v)
    c = (out * dout).sum(1, keepdim=True)
    de1 = ck.correlation_bwd_j_cuda(e0, e1, v, lse, dout, c)
    de1_p = ck.correlation_bwd_j_plain(e0, e1, v, lse, dout, c)
    torch.testing.assert_close(out, out_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lse, lse_p, rtol=2e-6, atol=1e-5)
    _close_grads([de1], [de1_p], RTOL)
