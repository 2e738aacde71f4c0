"""The port's fused ConvNeXt block op (unicorn_torch/ops/convnext_block.py)
against the JAX package's (unicorn_tpu/ops/pallas_convnext.py), on the CPU:
the plain version of the CUDA kernel against the Pallas kernel run in
interpret mode, the reference composition against the JAX reference and the
port's ConvNeXtBlock module, the flax parameter map, and the gradient of the
op against the JAX custom VJP. Inputs come from numpy seeds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch import convert
from unicorn_torch.models.blocks import ConvNeXtBlock
from unicorn_torch.ops import convnext_block as cb
from unicorn_tpu.ops import pallas_convnext as pc


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flax_params(rng, C, gamma=0.5):
    """The parameter tree of the JAX package's own test
    (tests/test_pallas_convnext.py `_params`), as numpy."""
    f = np.float32
    return {
        "Conv_0": {"kernel": (rng.randn(7, 7, 1, C) * 0.1).astype(f),
                   "bias": (rng.randn(C) * 0.1).astype(f)},
        "LayerNorm_0": {"scale": (1 + 0.1 * rng.randn(C)).astype(f),
                        "bias": (0.1 * rng.randn(C)).astype(f)},
        "Dense_0": {"kernel": (rng.randn(C, 4 * C) * 0.05).astype(f),
                    "bias": (rng.randn(4 * C) * 0.1).astype(f)},
        "Dense_1": {"kernel": (rng.randn(4 * C, C) * 0.05).astype(f),
                    "bias": (rng.randn(C) * 0.1).astype(f)},
        "gamma": (gamma + 0.1 * rng.randn(C)).astype(f),
    }


def _case(seed, shape, gamma=0.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    fp = _flax_params(rng, shape[-1], gamma)
    return x, fp, convert.convnext_block_params(fp)


def _jax_kernel(x, fp, exact_gelu, dtype=jnp.float32):
    """The Pallas kernel as the JAX package's own test runs it on the CPU."""
    out = pc.convnext_block_pallas(jnp.asarray(x, dtype), fp,
                                   exact_gelu=exact_gelu, row_block=8,
                                   interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _ulps(a, b, x):
    """|a - b| in bf16 ulps (8 significant bits) of the largest of |a|, |b|
    and |x|: the output is x + gamma * y, so where the two terms cancel the
    rounding steps of the terms, not of the small result, are the scale."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     np.maximum(np.abs(x), 2.0 ** -126))
    return np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("exact_gelu", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 24, 96), (2, 25, 40, 192)])
def test_fp32_plain_and_ref_match_jax(shape, exact_gelu):
    """fp32, at the JAX test's shapes and its tolerance (2e-5): in fp32 the
    kernel's places of rounding do not show, so the plain version, the
    composition, the interpreted Pallas kernel and the JAX reference agree
    to summation order."""
    x, fp, p = _case(0, shape)
    xt = torch.from_numpy(x)
    plain = cb.convnext_block_plain(xt, p, exact_gelu).numpy()
    ref = cb.convnext_block_ref(xt, p, exact_gelu).numpy()
    j_kernel = _jax_kernel(x, fp, exact_gelu)
    j_ref = np.asarray(pc.convnext_block_ref(jnp.asarray(x), fp, exact_gelu))
    for a, b in ((plain, j_kernel), (ref, j_ref), (plain, j_ref)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    auto = cb.convnext_block(xt, p, exact_gelu).numpy()   # CPU: plain
    np.testing.assert_array_equal(auto, plain)


@pytest.mark.parametrize("exact_gelu", [False, True])
def test_bf16_plain_matches_interpreted_kernel(exact_gelu):
    """bf16: the plain version rounds where the Pallas body rounds (fp32
    taps, LayerNorm on the unrounded sum, yn, the GELU output and the result
    rounded once each). The two differ only by the variance's form and by
    summation order, which now and then move one rounding of yn or of the
    hidden map. Bound: at most one output in a thousand differs at all, and
    none by more than 2 bf16 ulps (measured: about 30 of 192,000 differ, the
    furthest by 2 ulps). The composition, which rounds in five more places,
    is further from the kernel (measured: a quarter of the outputs differ,
    by 0.29 ulp on average and by up to 98): that is shown too, and is why
    the plain version is not the composition."""
    x, fp, p = _case(1, (2, 25, 40, 96))
    xt = torch.from_numpy(x).bfloat16()
    xb = xt.float().numpy()                     # the bf16 values, as fp32
    j_kernel = _jax_kernel(xb, fp, exact_gelu, jnp.bfloat16)
    plain = cb.convnext_block_plain(xt, p, exact_gelu).float().numpy()
    ref = cb.convnext_block_ref(xt, p, exact_gelu).float().numpy()
    u_plain, u_ref = _ulps(plain, j_kernel, xb), _ulps(ref, j_kernel, xb)
    print(f"bf16 ulps vs the interpreted kernel: plain max {u_plain.max():.2f}"
          f" mean {u_plain.mean():.5f}, {(u_plain > 0).sum()} of "
          f"{u_plain.size} differ; composition max {u_ref.max():.2f} mean "
          f"{u_ref.mean():.4f}, {(u_ref > 0).sum()} differ")
    assert u_plain.max() <= 2.0 and (u_plain > 0).mean() <= 1e-3
    assert 10 * u_plain.mean() < u_ref.mean()
    assert (u_plain > 0).sum() * 10 < (u_ref > 0).sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 13, 17, 24), (2, 9, 11, 40)])
def test_padded_channels_and_ragged_tiles(shape, dtype):
    """C that the TPU kernel pads to 128 lanes (24, 40) and H, W that are
    multiples of no tile: the port pads nothing and must agree all the same."""
    x, fp, p = _case(2, shape)
    if dtype == "float32":
        plain = cb.convnext_block_plain(torch.from_numpy(x), p, True).numpy()
        np.testing.assert_allclose(plain, _jax_kernel(x, fp, True),
                                   rtol=2e-5, atol=2e-5)
    else:
        xt = torch.from_numpy(x).bfloat16()
        plain = cb.convnext_block_plain(xt, p, True).float().numpy()
        xb = xt.float().numpy()
        u = _ulps(plain, _jax_kernel(xb, fp, True, jnp.bfloat16), xb)
        assert u.max() <= 2.0 and (u > 0).mean() <= 1e-3


@pytest.mark.parametrize("exact_gelu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_equals_module(dtype, exact_gelu):
    """convnext_block_ref is the ConvNeXtBlock module with the same weights
    (the module takes NCHW, the op NHWC), bit for bit."""
    C = 32
    block = ConvNeXtBlock(C, 0.5, dtype=dtype, exact_gelu=exact_gelu)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for t in block.parameters():
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
        block.norm.weight.add_(1.0)
    x = torch.randn(2, 8, 10, C, generator=g).to(dtype)
    with torch.no_grad():
        want = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = cb.convnext_block(x, cb.block_params(block), exact_gelu, "ref")
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flax_parameter_map_round_trips():
    _, fp, p = _case(4, (1, 4, 4, 16))
    assert tuple(p["dwconv"]["weight"].shape) == (16, 1, 7, 7)
    assert tuple(p["pwconv1"]["weight"].shape) == (64, 16)
    assert tuple(p["pwconv2"]["weight"].shape) == (16, 64)
    np.testing.assert_array_equal(
        p["dwconv"]["weight"][5, 0, 2, 3].numpy(),
        fp["Conv_0"]["kernel"][2, 3, 0, 5])
    np.testing.assert_array_equal(p["pwconv1"]["weight"][7, 3].numpy(),
                                  fp["Dense_0"]["kernel"][3, 7])
    back = convert.convnext_block_params_to_flax(p)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(fp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(fp)):
        np.testing.assert_array_equal(a, b)
    # the nine leaves flatten and unflatten in one order
    again = cb.unflatten_params(cb.flatten_params(p))
    assert all(a is b for a, b in zip(cb.flatten_params(again),
                                      cb.flatten_params(p)))


@pytest.mark.parametrize("exact_gelu", [False, True])
def test_gradients_match_jax_custom_vjp(exact_gelu, monkeypatch):
    """d loss / d (x and the nine leaves) through the port's autograd
    Function (forward: the plain version here; backward: autograd of the
    composition) against jax.grad through the JAX op's custom VJP
    (`convnext_block(method="pallas")`, its kernel run in interpret mode as
    the JAX package's tests run it on the CPU). fp32; every leaf within
    rtol 1e-4 of the JAX gradient, with atol 1e-4 of the leaf's largest
    magnitude for entries that cancel to nearly zero."""
    monkeypatch.setattr(pc, "convnext_block_pallas", functools.partial(
        pc.convnext_block_pallas, row_block=8, interpret=True))
    monkeypatch.setattr(pc, "_block_vjp_tanh", pc._make_vjp(False))
    monkeypatch.setattr(pc, "_block_vjp_exact", pc._make_vjp(True))
    x, fp, p = _case(5, (2, 9, 12, 24))
    rng = np.random.RandomState(6)
    w = rng.randn(*x.shape).astype(np.float32)     # cotangent

    def loss(x_, p_):
        y = pc.convnext_block(x_, p_, exact_gelu, method="pallas")
        return jnp.sum(y * jnp.asarray(w))

    gx_j, gp_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), fp)

    xt = torch.from_numpy(x).requires_grad_()
    leaves = [t.clone().requires_grad_() for t in cb.flatten_params(p)]
    y = cb.convnext_block(xt, cb.unflatten_params(leaves), exact_gelu)
    (y * torch.from_numpy(w)).sum().backward()
    gp_t = convert.convnext_block_params_to_flax(
        cb.unflatten_params([t.grad for t in leaves]))

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)

    close(xt.grad.numpy(), gx_j, "x")
    flat_j = jax.tree_util.tree_leaves_with_path(gp_j)
    flat_t = jax.tree_util.tree_leaves(gp_t)
    assert len(flat_j) == len(flat_t) == 9
    for (path, want), got in zip(flat_j, flat_t):
        close(got, want, jax.tree_util.keystr(path))


def test_methods():
    x, _, p = _case(7, (1, 6, 7, 8))
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="pallas"):
        cb.convnext_block(xt, p, method="pallas")
    with pytest.raises(ValueError, match="unknown method"):
        cb.convnext_block(xt, p, method="xla")
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cb.convnext_block_cuda(xt, p)
    bad = dict(p, gamma=torch.ones(9))
    with pytest.raises(ValueError, match="gamma"):
        cb.convnext_block(xt, bad)
    np.testing.assert_array_equal(
        cb.convnext_block(xt, p, True, "ref").numpy(),
        cb.convnext_block_ref(xt, p, True).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_the_card(dtype):
    """The CUDA kernels against the plain version at a served shape and at
    ragged and wide ones; chip_smoke.py holds all seven served shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # a served shape, ragged ones (C below one K chunk, maps smaller
        # than a dw tile) and the width of ConvNeXt-Large's last stage
        for shape in ((1, 50, 80, 384), (2, 13, 17, 24), (1, 3, 5, 8),
                      (1, 7, 33, 1536)):
            x, _, p = _case(8, shape)
            p = cb.unflatten_params([t.cuda() for t in cb.flatten_params(p)])
            xt = torch.from_numpy(x).cuda().to(dtype)
            for exact_gelu in (False, True):
                n0 = cb.launches
                yk = cb.convnext_block(xt, p, exact_gelu, "pallas").float()
                assert cb.launches == n0 + 1
                yp = cb.convnext_block_plain(xt, p, exact_gelu).float()
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    torch.testing.assert_close(yk, yp, rtol=5e-5, atol=5e-5)
                else:
                    # 2 ulps, plus 2^-7 of the root-sum-square of product
                    # 2's terms: every hidden value moved by one ulp
                    h = cb.plain_hidden(xt, p, exact_gelu).float()
                    w2 = p["pwconv2"]["weight"].cuda().bfloat16().float()
                    rss = (torch.sqrt((h * h) @ (w2 * w2).t())
                           * p["gamma"].cuda().abs())
                    d = (yk - yp).abs()
                    mag = torch.maximum(torch.maximum(yk.abs(), yp.abs()),
                                        xt.float().abs())
                    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                    assert bool((d <= 2 * ulp + 2.0 ** -7 * rss).all())
                    # the share of outputs that differ at all grows with
                    # the number of terms: under 1% up to C = 768
                    share = (d > 0).float().mean().item()
                    assert share <= (0.05 if shape[-1] > 768 else 0.01), share
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
