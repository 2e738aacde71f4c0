"""The port's correlation label propagation and its helpers
(unicorn_torch/ops/correlation.py, ops/correlation_kernel.py) against the
JAX package's XLA functions and its Pallas kernel in interpret mode.

On the CPU the port runs its plain PyTorch versions; the CUDA kernel is
compared with its plain version in the card-gated test at the end (and in
chip_smoke.py's kernel phase).

Tolerances. fp32 scores: all forms take the same fp32 softmax in other
orders: rtol 1e-4, atol 1e-5, and rtol 1e-3 for the sharp softmax (scores
of magnitude ~400, where an fp32 ulp of a score is 3e-5 and enters the
exponential), as tests/test_pallas.py holds the Pallas kernel. bf16 dots:
both sides round the embeddings to bf16 first and sum exact products in
fp32, so the same bounds hold between them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.ops import correlation as tc
from unicorn_torch.ops import correlation_kernel as ck
from unicorn_tpu.ops import correlation as jc
from unicorn_tpu.ops.pallas_correlation import correlation_propagate_pallas

# (N, C, K, scale of the embeddings, Pallas block, rtol): the cases of
# tests/test_pallas.py, a ragged N that no chunk or block divides, and the
# edges of the CUDA kernel's tiling: N one below and above its tiles of 64
# and 128 rows, C that its padding to 64 channels touches, K above 1
CASES = {
    "n512": (512, 32, 2, 1.0, 128, 1e-4),
    "sharp": (256, 16, 1, 10.0, 64, 1e-3),
    "ragged200": (200, 16, 2, 1.0, 128, 1e-4),
    "ragged77": (77, 48, 3, 1.0, 128, 1e-4),
    "n63c16": (63, 16, 2, 1.0, 64, 1e-4),
    "n65c48": (65, 48, 3, 1.0, 64, 1e-4),
    "n127c96": (127, 96, 2, 1.0, 128, 1e-4),
    "n129c16": (129, 16, 5, 1.0, 128, 1e-4),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(N, C, K, scale, seed=0, B=1):
    rng = np.random.RandomState(seed)
    e0 = rng.randn(B, N, C).astype(np.float32) * scale
    e1 = rng.randn(B, N, C).astype(np.float32) * scale
    v = rng.rand(B, K, N).astype(np.float32)
    return e0, e1, v


@pytest.mark.parametrize("case", CASES)
def test_propagate_matches_jax_and_pallas_fp32(case):
    N, C, K, scale, blk, rtol = CASES[case]
    e0, e1, v = _inputs(N, C, K, scale)
    t = tuple(map(torch.from_numpy, (e0, e1, v)))
    j = tuple(map(jnp.asarray, (e0, e1, v)))
    dense_j = np.asarray(jc.correlation_propagate_dense(*j))
    chunk_j = np.asarray(jc.correlation_propagate(*j, chunk=128))
    pallas = np.asarray(correlation_propagate_pallas(
        *j, block_i=blk, block_j=blk, interpret=True))
    outs = {
        "dense": tc.correlation_propagate_dense(*t),
        "chunked": tc.correlation_propagate(*t, chunk=128),
        "plain": ck.correlation_propagate_plain(*t, bf16_dots=False),
        "auto": ck.correlation_propagate_auto(*t),
    }
    for name, out in outs.items():
        out = out.numpy()
        assert out.shape == (1, K, N) and np.all(np.isfinite(out)), name
        for ref in (dense_j, chunk_j, pallas):
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_bf16_dots(case):
    N, C, K, scale, blk, rtol = CASES[case]
    e0, e1, v = _inputs(N, C, K, scale, seed=1)
    out = ck.correlation_propagate_plain(
        *map(torch.from_numpy, (e0, e1, v)), bf16_dots=True).numpy()
    pallas = np.asarray(correlation_propagate_pallas(
        *map(jnp.asarray, (e0, e1, v)), block_i=blk, block_j=blk,
        interpret=True, bf16_dots=True))
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, pallas, rtol=rtol, atol=1e-5)
    # rounding the embeddings is what moves the result, not the streaming
    exact = ck.correlation_propagate_plain(
        *map(torch.from_numpy, (e0, e1, v)), bf16_dots=False).numpy()
    assert np.abs(out - exact).max() > 1e-4


def test_wrapper_checks_its_inputs():
    e0, e1, v = map(torch.from_numpy, _inputs(64, 16, 2, 1.0))
    with pytest.raises(ValueError, match="expected e0, e1"):
        ck.correlation_propagate_auto(e0, e1[:, :32], v)
    with pytest.raises(ValueError, match="expected e0, e1"):
        ck.correlation_propagate_plain(e0, e1, v[:, :, :32])
    with pytest.raises(ValueError, match="CUDA"):   # the kernel: CUDA only
        ck.correlation_propagate_cuda(e0, e1, v)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.correlation_propagate_auto(e0.to("meta"), e1.to("meta"),
                                      v.to("meta"))
    before = ck.launches
    ck.correlation_propagate_auto(e0, e1, v)
    assert ck.launches == before      # the plain version is not a launch


def test_box_label_map_matches_jax():
    """Half-integer edges (round half to even), boxes that cross each border
    and one that lies outside."""
    H, W = 24, 40
    boxes = np.array([
        [10.0, 8.0, 5.0, 3.0],      # edges at 7.5 / 12.5 / 6.5 / 9.5
        [10.5, 8.5, 4.0, 4.0],      # edges at 8.5 / 12.5 / 6.5 / 10.5
        [2.0, 3.0, 10.0, 12.0],     # crosses the left and top borders
        [38.0, 22.0, 9.0, 9.0],     # crosses the right and bottom borders
        [-20.0, -20.0, 4.0, 4.0],   # outside
        [20.25, 12.75, 7.3, 5.9],
    ], np.float32)
    out = tc.box_label_map(torch.from_numpy(boxes), H, W).numpy()
    ref = np.asarray(jc.box_label_map(jnp.asarray(boxes), H, W))
    np.testing.assert_array_equal(out, ref)
    assert out[0].sum() == 4 * 4 and out[4].sum() == 0 and out[2].sum() > 0


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_bilinear_matches_jax(factor):
    rng = np.random.RandomState(factor)
    x = rng.rand(2, 24, 40, 1).astype(np.float32)
    h, w = 24 // factor, 40 // factor
    out = tc.resize_bilinear_torch(
        torch.from_numpy(x).permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)
    ref = np.asarray(jc.resize_bilinear_torch(jnp.asarray(x), h, w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_grid_sample_at_points_matches_jax():
    rng = np.random.RandomState(3)
    feat = rng.randn(9, 11, 5).astype(np.float32)
    pts = rng.uniform(-2, 13, (40, 2)).astype(np.float32)   # incl. outside
    pts[:4] = [[0, 0], [10, 8], [10.5, 8.5], [3.0, 4.0]]
    out = tc.grid_sample_at_points(torch.from_numpy(feat),
                                   torch.from_numpy(pts)).numpy()
    ref = np.asarray(jc.grid_sample_at_points(jnp.asarray(feat),
                                              jnp.asarray(pts)))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_dots", [True, False])
def test_kernel_matches_plain_on_card(bf16_dots):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for N, C, K, scale in ((16000, 128, 1, 0.3), (1000, 48, 3, 1.0),
                           (77, 16, 16, 1.0), (300, 32, 2, 10.0),
                           (63, 16, 2, 1.0), (65, 48, 3, 1.0),
                           (127, 96, 2, 1.0), (129, 16, 5, 1.0),
                           (129, 192, 16, 1.0), (257, 64, 1, 1.0)):
        e0, e1, v = (torch.from_numpy(a).cuda()
                     for a in _inputs(N, C, K, scale, seed=4))
        n0 = ck.launches
        yk = ck.correlation_propagate_cuda(e0, e1, v, bf16_dots=bf16_dots)
        assert ck.launches == n0 + 1
        yp = ck.correlation_propagate_plain(e0, e1, v, bf16_dots=bf16_dots)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(yk).all())
        torch.testing.assert_close(yk, yp, rtol=1e-3 if scale > 1 else 1e-4,
                                   atol=1e-5)
