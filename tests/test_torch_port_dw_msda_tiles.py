"""The channel padding of the dw7x7 and MSDA wrappers, and the tilings of
their CUDA kernels (csrc/dwconv7x7.cu, csrc/msda.cu).

CPU: the padding helpers (`dwconv7x7.pad_channels`,
`deform_attn.pad_head_width`) take the op as an argument, so they run here
on the plain versions at widths the kernels do not read (C = 12, 20; D = 6)
and are held against the JAX package's Pallas kernels in interpret mode,
which take any width. Tolerances as in test_torch_port_dwconv.py and
test_torch_port_msda.py: fp32 2e-6 (dw7x7) and rtol 1e-4 / atol 1e-5
(MSDA); bf16 one ulp of the output plus the bound on two fp32 orders of the
same sum (dw7x7) or 2^-7 * sum|w * v| plus one ulp (MSDA).

Card (marked `cuda`, skipped without one): the kernels against their plain
versions over every tiling the dw7x7 launcher can pick, maps that end
mid-tile and mid-strip, maps below the kernel's reach (H or W < 7, 1 x 1),
batches, the narrowest and widest C, the padded widths; MSDA over a query
count that is no multiple of a block's, locations far outside the map,
queries in random order, both modes and both dtypes. Tolerances as in
chip_smoke.py's kernels phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.ops import deform_attn as da
from unicorn_torch.ops import dwconv7x7 as dw
from unicorn_tpu.ops.deform_attn import _msda_pallas, _msda_pallas_factored
from unicorn_tpu.ops.pallas_convnext import dwconv7x7_pallas

PALLAS = {"factored": _msda_pallas_factored, "direct": _msda_pallas}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ulp_bf16(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _dw_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    B, H, W, C = shape
    return (rng.randn(B, H, W, C).astype(np.float32),
            (rng.randn(7, 7, 1, C) * 0.1).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32))


def _msda_inputs(shape, seed):
    B, L, H, W, M, D, Lq, P = shape
    rng = np.random.RandomState(seed)
    value = rng.randn(B, L, H, W, M, D).astype(np.float32)
    locs = rng.rand(B, Lq, M, L, P, 2).astype(np.float32) * 1.2 - 0.1
    attw = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attw /= attw.reshape(B, Lq, M, -1).sum(-1).reshape(B, Lq, M, 1, 1)
    return value, locs, attw


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [12, 20])
def test_dw_padding_matches_pallas(C, dtype):
    """C = 12 and 20, padded to 16 / 24 (bf16) or left (fp32: multiples of
    4 already, so fp32 is held unpadded and with a forced 8), against the
    Pallas kernel, which pads C to 128 itself."""
    x, k, b = _dw_inputs((1, 9, 11, C), C)
    xt = torch.from_numpy(x).to(dtype)
    calls = []

    def plain(*a):
        calls.append(a[0].shape[-1])
        return dw.dwconv7x7_plain(*a)
    out = dw.pad_channels(plain, xt, torch.from_numpy(k), torch.from_numpy(b),
                          8).float().numpy()
    assert calls == [-C % 8 + C] and out.shape == x.shape
    xj = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    pal = np.asarray(dwconv7x7_pallas(xj, jnp.asarray(k), jnp.asarray(b),
                                      row_block=8, interpret=True)
                     ).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, pal, rtol=2e-6, atol=2e-6)
        return
    kb = torch.from_numpy(k[:, :, 0]).to(dtype).float()
    bb = torch.from_numpy(b).to(dtype).float()
    mag = dw.dwconv7x7_plain(xt.float().abs(), kb.abs(), bb.abs()).numpy()
    ulp = _ulp_bf16(np.maximum(np.abs(out), np.abs(pal)))
    assert np.all(np.abs(out - pal) <= ulp + 50 * 2.0 ** -24 * mag)


def test_dw_padding_leaves_a_multiple_alone():
    """A C that is a multiple goes to the op as it is: the same tensor, no
    copy."""
    x = torch.randn(1, 5, 6, 16)
    k, b = torch.randn(7, 7, 16), torch.randn(16)
    seen = []
    y = dw.pad_channels(lambda *a: (seen.append(a[0]), a[0])[1], x, k, b, 8)
    assert seen[0] is x and y is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_msda_padding_matches_pallas(mode, dtype):
    """D = 6 padded to 8 on the plain version in each mode, against that
    mode's Pallas kernel at D = 6."""
    shape = (2, 2, 7, 9, 3, 6, 29, 4)
    value, locs, attw = _msda_inputs(shape, 21)
    vt = torch.from_numpy(value).to(dtype)
    at = torch.from_numpy(attw).to(dtype)
    lt = torch.from_numpy(locs)
    widths = []

    def plain(v, l, a):
        widths.append(v.shape[-1])
        return da.ms_deform_attn_plain(v, l, a, mode)
    out = da.pad_head_width(plain, vt, lt, at, 8)
    assert widths == [8] and tuple(out.shape) == (2, 29, 3 * 6)
    assert out.is_contiguous() and out.dtype == dtype
    out = out.float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pal = np.asarray(PALLAS[mode](
        jnp.asarray(vt.float().numpy()).astype(jdt), jnp.asarray(locs),
        jnp.asarray(at.float().numpy()).astype(jdt),
        interpret=True)).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, pal, rtol=1e-4, atol=1e-5)
        return
    mag = da.ms_deform_attn_plain(vt.float().abs(), lt, at.float(),
                                  mode="direct").numpy()
    tol = 2.0 ** -7 * mag + _ulp_bf16(np.maximum(np.abs(out), np.abs(pal)))
    assert np.all(np.abs(out - pal) <= tol)


def test_msda_padding_leaves_a_multiple_alone():
    value, locs, attw = map(torch.from_numpy,
                            _msda_inputs((1, 1, 5, 6, 2, 16, 8, 2), 0))
    seen = []
    y = da.pad_head_width(lambda *a: (seen.append(a[0]), a[0])[1], value,
                          locs, attw, 8)
    assert seen[0] is value and y is value


# ------------------------------------------------------------------ card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _dw_check(shape, dtype, seed=0):
    B, H, W, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    k = 0.1 * torch.randn(7, 7, C, device="cuda", generator=g)
    b = 0.1 * torch.randn(C, device="cuda", generator=g)
    n0 = dw.launches
    yk = dw.dwconv7x7(x, k, b)
    assert dw.launches == n0 + 1 and yk.shape == x.shape
    yp = dw.dwconv7x7_plain(x, k, b)
    torch.cuda.synchronize()
    diff = (yk.float() - yp.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4, shape
        return
    mag = dw.dwconv7x7_plain(x.float().abs(), k.to(dtype).abs(),
                             b.to(dtype).abs())
    a = torch.maximum(yk.float().abs(), yp.float().abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    assert bool((diff <= ulp + 50 * 2.0 ** -24 * mag).all()), shape


# (B, H, W, C): both channel-pair widths (C/2 a multiple of 32, or of 16
# only, or neither), maps that end mid-tile (W not a multiple of 8 or 16)
# and mid-strip (H a prime), maps below the kernel's 7 x 7 reach, 1 x 1,
# the window batch and the training batch, the narrowest and widest C
DW_TILE_SHAPES = [
    (1, 13, 17, 40), (1, 5, 3, 16), (1, 1, 1, 8), (1, 29, 37, 64),
    (1, 31, 23, 96), (1, 6, 6, 48), (1, 3, 40, 24), (1, 41, 5, 200),
    (4, 25, 40, 256), (4, 50, 80, 96), (1, 7, 9, 8), (1, 9, 7, 1536),
    (2, 100, 160, 192), (3, 17, 19, 72),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_over_tilings_on_card(dtype):
    _card()
    pairs = set()
    for shape in DW_TILE_SHAPES:
        pairs.add(dw.plan(*shape)["pairs"])
        _dw_check(shape, dtype)
    assert pairs == {16, 32}      # both tilings the launcher has


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [12, 20, 6, 2])
def test_dw_kernel_padded_widths_on_card(C, dtype):
    _card()
    _dw_check((2, 13, 17, C), dtype)


@pytest.mark.cuda
def test_dw_plan_fills_the_card_on_the_path_shapes():
    """Each of the seven shapes of a frame gives at least one block per SM
    and keeps at least 85% of the lanes of its tiles busy."""
    _card()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for (H, W, C), _ in dw.PATH_SHAPES:
        p = dw.plan(1, H, W, C)
        blocks = p["grid_x"] * p["grid_y"] * p["grid_z"]
        lanes = (p["grid_x"] * p["columns"] * p["strips"] * p["rows"]
                 * p["grid_z"] * p["pairs"] * 2)
        assert blocks >= n_sm, (H, W, C, p)
        assert H * W * C / lanes >= 0.85, (H, W, C, p)


def _msda_check(value, locs, attw, mode):
    n0 = da.launches
    yk = da.ms_deform_attn_cuda(value, locs, attw, mode)
    assert da.launches == n0 + 1 and yk.dtype == value.dtype
    yp = da.ms_deform_attn_plain(value, locs, attw, mode)
    torch.cuda.synchronize()
    B, L, H, W, M, D = value.shape
    P = locs.shape[4]
    diff = (yk.float() - yp.float()).abs()
    mag = da.ms_deform_attn_plain(value.float().abs(), locs, attw.float(),
                                  "direct")
    tol = L * P * 4 * 2.0 ** -24 * mag + 1e-7
    if value.dtype == torch.bfloat16:
        a = torch.maximum(yk.float().abs(), yp.float().abs())
        tol = tol + torch.exp2(torch.floor(torch.log2(
            a.clamp_min(2.0 ** -126))) - 7)
    assert bool((diff <= tol).all()), tuple(value.shape)
    return yk


# (B, L, H, W, M, D, Lq, P): query counts that end a block part-way (a
# block holds 256 / (D / vector) heads), one level, many points, one head
MSDA_SHAPES = [(2, 2, 13, 17, 3, 8, 29, 4), (1, 1, 5, 6, 2, 16, 9, 2),
               (1, 2, 50, 80, 8, 32, 8001, 4), (3, 3, 7, 9, 1, 64, 33, 6),
               (1, 2, 11, 13, 8, 32, 127, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_msda_kernel_over_block_edges_on_card(mode, dtype):
    _card()
    for shape in MSDA_SHAPES:
        value, locs, attw = (torch.from_numpy(a).cuda()
                             for a in _msda_inputs(shape, 3))
        _msda_check(value.to(dtype), locs, attw.to(dtype), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_msda_kernel_far_outside_and_random_order_on_card(mode, dtype):
    """Locations far outside the map (every corner out: zeros), points with
    some corners out, and the served queries in random order instead of
    raster order, so that a block's samples spread over the whole map."""
    _card()
    shape = (1, 2, 50, 80, 8, 32, 8000, 4)
    value, locs, attw = (torch.from_numpy(a).cuda()
                         for a in _msda_inputs(shape, 4))
    value, attw = value.to(dtype), attw.to(dtype)
    far = torch.full_like(locs, 1e30)
    far[..., 1] = -1e30
    out = _msda_check(value, far, attw, mode)
    assert torch.count_nonzero(out) == 0
    edge = locs.clone()
    edge[..., 0] = torch.where(edge[..., 0] > 0.5, 1.0 + 0.2 / 80, -0.2 / 80)
    _msda_check(value, edge, attw, mode)
    perm = torch.randperm(8000, generator=torch.Generator().manual_seed(0))
    _msda_check(value, locs[:, perm.cuda()].contiguous(), attw, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [6, 12, 2])
def test_msda_kernel_padded_head_width_on_card(D, dtype):
    _card()
    value, locs, attw = (torch.from_numpy(a).cuda()
                         for a in _msda_inputs((2, 2, 7, 9, 3, D, 29, 4), 5))
    for mode in ("factored", "direct"):
        _msda_check(value.to(dtype), locs, attw.to(dtype), mode)
