"""The port's deformable-attention sampling (unicorn_torch/ops/deform_attn.py)
against the JAX package's: the float64 loop oracle, the XLA gather and the
two Pallas kernels in interpret mode.

On the CPU the port's wrapper runs a plain PyTorch version whose arithmetic
is the CUDA kernel's; the kernel itself is compared with it in the
card-gated test at the end (and in chip_smoke.py's kernel phase).

Tolerances. fp32: every form computes the same 32 products per output in
another order and association: rtol 1e-4, atol 1e-5, as tests/test_ops.py
holds the Pallas kernels to the oracle. bf16: both sides round each corner
weight to bf16 (2^-9 relative), may round the fraction lx differently by one
bf16 ulp where XLA contracts `loc * W - 0.5` into one FMA (another 2^-8 on
that weight), and the Pallas kernels round the sum of two weights that fall
on one cell where the port rounds each; all of it is bounded by
2^-7 * sum|w * v|, plus one bf16 ulp of the output for the final rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.ops import deform_attn as da
from unicorn_tpu.ops.deform_attn import (_msda_pallas, _msda_pallas_factored,
                                         ms_deform_attn as j_msda,
                                         ms_deform_attn_reference)

# (B, L, H, W, M, D, Lq, P): the shape of tests/test_ops.py (odd H, W and
# Lq), and a second one with one level and Lq below the Pallas query block
SHAPES = [(2, 2, 7, 9, 3, 8, 29, 4), (1, 1, 5, 6, 2, 16, 8, 2)]
PALLAS = {"factored": _msda_pallas_factored, "direct": _msda_pallas}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(shape, seed):
    """Values, locations that reach outside [0, 1], normalised weights."""
    B, L, H, W, M, D, Lq, P = shape
    rng = np.random.RandomState(seed)
    value = rng.randn(B, L, H, W, M, D).astype(np.float32)
    locs = rng.rand(B, Lq, M, L, P, 2).astype(np.float32) * 1.2 - 0.1
    attw = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attw /= attw.reshape(B, Lq, M, -1).sum(-1).reshape(B, Lq, M, 1, 1)
    return value, locs, attw


def _ulp_bf16(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_plain_matches_oracle_and_pallas_fp32(mode, shape):
    value, locs, attw = _inputs(shape, 2)
    out = da.ms_deform_attn_plain(*map(torch.from_numpy, (value, locs, attw)),
                                  mode=mode).numpy()
    ref = ms_deform_attn_reference(value, locs, attw)
    pal = np.asarray(PALLAS[mode](jnp.asarray(value), jnp.asarray(locs),
                                  jnp.asarray(attw), interpret=True))
    gat = np.asarray(j_msda(jnp.asarray(value), jnp.asarray(locs),
                            jnp.asarray(attw), method="gather"))
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, pal, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, gat, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_plain_matches_pallas_bf16(mode, shape):
    value, locs, attw = _inputs(shape, 5)
    vb = torch.from_numpy(value).bfloat16()
    ab = torch.from_numpy(attw).bfloat16()       # the served path's types
    lt = torch.from_numpy(locs)
    out = da.ms_deform_attn_plain(vb, lt, ab, mode=mode)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    pal = np.asarray(PALLAS[mode](
        jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(locs),
        jnp.asarray(ab.float().numpy()).astype(jnp.bfloat16),
        interpret=True)).astype(np.float32)
    mag = da.ms_deform_attn_plain(vb.float().abs(), lt, ab.float(),
                                  mode="direct").numpy()
    tol = 2.0 ** -7 * mag + _ulp_bf16(np.maximum(np.abs(out), np.abs(pal)))
    assert np.all(np.abs(out - pal) <= tol)
    # and against the exact sum, within the same bound
    ref = ms_deform_attn_reference(vb.float().numpy(), locs,
                                   ab.float().numpy())
    assert np.all(np.abs(out - ref) <= tol)


def test_the_two_modes_round_differently_only_in_bf16():
    value, locs, attw = _inputs(SHAPES[0], 7)
    args = tuple(map(torch.from_numpy, (value, locs, attw)))
    f32 = [da.ms_deform_attn_plain(*args, mode=m) for m in ("factored",
                                                            "direct")]
    np.testing.assert_allclose(f32[0].numpy(), f32[1].numpy(), rtol=1e-5,
                                atol=1e-6)
    b16 = [da.ms_deform_attn_plain(args[0].bfloat16(), args[1], args[2],
                                   mode=m) for m in ("factored", "direct")]
    assert not torch.equal(b16[0], b16[1])


def test_locations_stay_fp32_and_far_outside_is_zero():
    value, locs, attw = _inputs(SHAPES[1], 8)
    far = np.full_like(locs, 1e30)
    far[..., 1] = -1e30
    for mode in ("factored", "direct"):
        out = da.ms_deform_attn_plain(torch.from_numpy(value),
                                      torch.from_numpy(far),
                                      torch.from_numpy(attw), mode=mode)
        assert torch.count_nonzero(out) == 0
    with pytest.raises(TypeError):
        da.ms_deform_attn(torch.from_numpy(value),
                          torch.from_numpy(locs).bfloat16(),
                          torch.from_numpy(attw))


@pytest.mark.parametrize("method,mode", [
    ("auto", "direct"), ("gather", "direct"), ("pallas", "direct"),
    ("pallas_factored", "factored")])
def test_method_routing_on_the_cpu(method, mode):
    """On a CPU tensor each method name takes its plain version: the gather
    (direct rounding) for "auto", as the JAX package does off the TPU."""
    value, locs, attw = _inputs(SHAPES[0], 3)
    args = (torch.from_numpy(value).bfloat16(), torch.from_numpy(locs),
            torch.from_numpy(attw))
    before = da.launches
    out = da.ms_deform_attn(*args, method=method)
    assert torch.equal(out, da.ms_deform_attn_plain(*args, mode=mode))
    assert da.launches == before     # the plain version is not a launch


@pytest.mark.parametrize("method", ["onehot", "onehot_factored"])
def test_xla_formulations_raise(method):
    args = tuple(map(torch.from_numpy, _inputs(SHAPES[1], 0)))
    with pytest.raises(NotImplementedError, match="one-hot"):
        da.ms_deform_attn(*args, method=method)


def test_wrapper_checks_its_inputs():
    value, locs, attw = map(torch.from_numpy, _inputs(SHAPES[1], 0))
    with pytest.raises(ValueError, match="unknown MSDA method"):
        da.ms_deform_attn(value, locs, attw, method="palas")
    with pytest.raises(ValueError, match="do not match"):  # other M
        da.ms_deform_attn(value, locs[:, :, :1], attw[:, :, :1])
    with pytest.raises(ValueError, match="do not match"):  # other P
        da.ms_deform_attn(value, locs, attw[..., :1])
    with pytest.raises(ValueError, match="expected value"):
        da.ms_deform_attn(value[0], locs, attw)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel: CUDA only
        da.ms_deform_attn_cuda(value, locs, attw)
    with pytest.raises(ValueError, match="unknown mode"):
        da.ms_deform_attn_cuda(value, locs, attw, mode="onehot")
    with pytest.raises(ValueError, match="no kernel for device"):
        da.ms_deform_attn(value.to("meta"), locs.to("meta"), attw.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_kernel_matches_plain_on_card(mode, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in SHAPES + [(1, 2, 50, 80, 8, 32, 8000, 4)]:
        value, locs, attw = (torch.from_numpy(a).cuda()
                             for a in _inputs(shape, 11))
        value, attw = value.to(dtype), attw.to(dtype)
        n0 = da.launches
        yk = da.ms_deform_attn_cuda(value, locs, attw, mode)
        assert da.launches == n0 + 1 and yk.dtype == dtype
        yp = da.ms_deform_attn_plain(value, locs, attw, mode)
        torch.cuda.synchronize()
        diff = (yk.float() - yp.float()).abs()
        # the same weights bit for bit; two fp32 orders of 32 terms, then
        # one rounding
        mag = da.ms_deform_attn_plain(value.float().abs(), locs, attw.float(),
                                      "direct")
        tol = 32 * 2.0 ** -24 * mag + 1e-7
        if dtype == torch.bfloat16:
            a = torch.maximum(yk.float().abs(), yp.float().abs())
            tol = tol + torch.exp2(torch.floor(torch.log2(
                a.clamp_min(2.0 ** -126))) - 7)
        assert bool((diff <= tol).all())
