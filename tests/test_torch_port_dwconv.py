"""The port's dw7x7 (unicorn_torch/ops/dwconv7x7.py) against the JAX
package's Pallas kernel (interpret mode) and its XLA reference.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is compared with it in the card-gated test at the end (and, on the
card's machine, which has no JAX for this file to import, in
chip_smoke.py's kernel phase).

Tolerances. fp32: the three compute the same fp32 sum in other orders
(2e-6, as tests/test_pallas_convnext.py holds the Pallas kernel). bf16:
taps and bias are rounded to bf16 first by all three; the Pallas kernel and
the port round the fp32 sum once, so they agree to one bf16 ulp of the
output plus the bound on two fp32 orders of the same sum (the port is in
fact within half an ulp of the exact sum, and equal to the Pallas kernel).
The XLA reference's bf16 conv on the CPU rounds in bf16 along the sum, so
against it the bound is 2^-6 of sum|x*w| (measured: at most 0.0065 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.ops import dwconv7x7 as dw
from unicorn_tpu.ops.pallas_convnext import dwconv7x7_pallas, dwconv7x7_ref

SHAPES = [(1, 16, 24, 8), (2, 13, 17, 96), (1, 25, 40, 200), (1, 9, 11, 20)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    B, H, W, C = shape
    x = rng.randn(B, H, W, C).astype(np.float32)
    k = (rng.randn(7, 7, 1, C) * 0.1).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    return x, k, b


def _ulp_bf16(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_ref_fp32(shape):
    x, k, b = _inputs(shape, 0)
    out = dw.dwconv7x7(torch.from_numpy(x), torch.from_numpy(k),
                       torch.from_numpy(b)).numpy()
    pal = np.asarray(dwconv7x7_pallas(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(b), row_block=8,
                                      interpret=True))
    ref = np.asarray(dwconv7x7_ref(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(b)))
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(out, pal, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_ref_bf16(shape):
    x, k, b = _inputs(shape, 1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = dw.dwconv7x7(xb, torch.from_numpy(k), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape
    out = out.float().numpy()
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    pal = np.asarray(dwconv7x7_pallas(xj, jnp.asarray(k), jnp.asarray(b),
                                      row_block=8, interpret=True)
                     ).astype(np.float32)
    ref = np.asarray(dwconv7x7_ref(xj, jnp.asarray(k), jnp.asarray(b))
                     ).astype(np.float32)
    # fp32 sums of the same 50 terms in two orders: 50 * 2^-24 * sum|x w|
    kb = torch.from_numpy(k).to(torch.bfloat16).float()
    bb = torch.from_numpy(b).to(torch.bfloat16).float()
    mag = dw.dwconv7x7_plain(xb.float().abs(), kb.abs(), bb.abs()).numpy()
    order = 50 * 2.0 ** -24 * mag
    ulp = _ulp_bf16(np.maximum(np.abs(out), np.abs(pal)))
    assert np.all(np.abs(out - pal) <= ulp + order)
    assert np.all(np.abs(out - ref) <= 2.0 ** -6 * mag)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError):
        dw.dwconv7x7(x, torch.zeros(7, 7, 8), torch.zeros(16))
    with pytest.raises(ValueError):
        dw.dwconv7x7(x, torch.zeros(7, 7, 16), torch.zeros(8))
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        dw.dwconv7x7_cuda(x, torch.zeros(7, 7, 16), torch.zeros(16))
    before = dw.launches
    dw.dwconv7x7(x, torch.zeros(7, 7, 16), torch.zeros(16))
    assert dw.launches == before  # the plain version is not a launch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for (H, W, C), _ in dw.PATH_SHAPES[:4] + (((13, 17, 40), 1),):
        x = torch.randn(1, H, W, C, device="cuda", generator=g).to(dtype)
        k = 0.1 * torch.randn(7, 7, C, device="cuda", generator=g)
        b = 0.1 * torch.randn(C, device="cuda", generator=g)
        n0 = dw.launches
        yk = dw.dwconv7x7(x, k, b)
        assert dw.launches == n0 + 1
        yp = dw.dwconv7x7_plain(x, k, b)
        torch.cuda.synchronize()
        diff = (yk.float() - yp.float()).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-4
        else:
            mag = dw.dwconv7x7_plain(x.float().abs(), k.to(dtype).abs(),
                                     b.to(dtype).abs())
            a = torch.maximum(yk.float().abs(), yp.float().abs())
            ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(2.0 ** -126)))
                             - 7)
            assert bool((diff <= ulp + 50 * 2.0 ** -24 * mag).all())


def test_build_key_covers_source_headers_and_flags(tmp_path, monkeypatch):
    """The cached library's name changes with the kernel's source and with
    any header of csrc/ that it may include."""
    from unicorn_torch.csrc import build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    first = build._target("k", "nvcc")
    assert build._target("k", "nvcc") == first
    (tmp_path / "h.cuh").write_text("// b\n")
    second = build._target("k", "nvcc")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// c\n')
    third = build._target("k", "nvcc")
    assert len({first, second, third, build._target("k", "other")}) == 4
