"""The fused ConvNeXt block kernels' plan (unicorn_torch/ops/convnext_block.py
`plan`) on the CPU, and on the card the kernels it plans against the plain
version.

CPU: the route, tiles, ring stages, grids and shared memory `plan` picks at
the seven shapes of an 800x1280 frame (ops/dwconv7x7.py PATH_SHAPES) and at
edge shapes, in bf16 and fp32: every plan fits in a block's 227 KB, keeps
the fused route's accumulators within a thread's registers, fills the card
wherever the pixels and channels allow, and every C the op takes gets one;
its keyword overrides (the plan sweeps) replace its choices. The C entry
(csrc/convnext_block.cu) reads the same fields in the same order, sizes
each launch's shared memory from them and refuses a plan it cannot run.

Card (`-m cuda`, skipped here): the kernels on each route against
`convnext_block_plain` under chip_smoke.py's `cb_disagreement` tolerance;
now that its strip kernel lives in a header both sources share, the dw7x7
kernel bit for bit against its own FMA order and against its plain version
at the served shapes; and the serving correlation after its TMA / wgmma
helpers moved into a shared header."""
import os
import re

import pytest
import torch

from unicorn_torch.ops import convnext_block as cb
from unicorn_torch.ops.dwconv7x7 import PATH_SHAPES

N_SM = 132           # an H100 SXM
BF16, FP32 = torch.bfloat16, torch.float32
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "unicorn_torch", "csrc", "convnext_block.cu")


def _blocks(grid):
    return grid[0] * grid[1]


def _check_plan(B, H, W, C, dtype, pl, n_sm=N_SM):
    """The invariants every plan keeps on a card of n_sm SMs."""
    P = B * H * W
    nch = -(-4 * C // 64)
    assert pl["smem1"] <= cb.MAX_SMEM and pl["smem2"] <= cb.MAX_SMEM
    assert len(pl["ints"]) == len(cb.PLAN_KEYS)
    assert pl["ints"][1:] == tuple(pl[k] for k in cb.PLAN_KEYS[1:])
    assert pl["ints"][0] == (0 if pl["route"] == "fused" else 1)
    assert pl["launches"] == (2 if pl["route"] == "fused" else 3)
    if dtype == FP32:
        assert pl["route"] == "split" and pl["stages1"] == pl["stages2"] == 3
        # product 1: the column tile that pads least; product 2: 64 columns;
        # 128-row tiles where they fill the card, else 64-row ones
        assert -(-4 * C // pl["n1"]) * pl["n1"] == min(
            -(-4 * C // 64) * 64, -(-4 * C // 128) * 128)
        assert pl["n2"] == 64
        for m, n, n_cols, grid in ((pl["m1"], pl["n1"], 4 * C, pl["grid1"]),
                                   (pl["m2"], pl["n2"], C, pl["grid2"])):
            assert m in (64, 128) and n in (64, 128)
            assert _blocks(grid) >= min(n_sm, -(-P // 64) * -(-n_cols // n))
        assert pl["acc_regs"] == 32
        return
    if pl["route"] == "fused":
        nj = -(-C // 32)
        assert C <= 192 and pl["m1"] == 128 and pl["n1"] == 64 * nch
        # each consumer holds Y (64 x C: C / 2 fp32), S (32) and h (16)
        assert pl["acc_regs"] == 16 * nj + 48 <= 144
        # the W2 pieces of one chunk and the next chunk's first W1 piece
        assert pl["stages1"] >= -(-nj // 2) + 1
        assert pl["grid1"] == (-(-P // 128), 1) and pl["grid2"] is None
        return
    assert pl["m1"] in (64, 128) and pl["n1"] % 64 == 0
    assert pl["stages1"] >= 2 and pl["stages2"] >= 2
    assert pl["m2"] == pl["n2"] in (64, 128)
    assert pl["acc_regs"] <= 128
    # product 1: one wave of blocks, as many hidden groups as fit in it
    tiles, groups = pl["grid1"]
    assert tiles == -(-P // pl["m1"]) and groups * pl["n1"] >= 64 * nch
    assert groups == 1 or tiles * groups <= n_sm
    more = -(-nch // (pl["n1"] // 64 - 1)) if pl["n1"] > 64 else None
    assert more is None or tiles * more > n_sm
    # product 2 fills the card wherever its tiles allow
    assert _blocks(pl["grid2"]) >= min(
        n_sm, -(-P // pl["m2"]) * -(-C // pl["n2"]))


@pytest.mark.parametrize("dtype", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("hwc", [s for s, _ in PATH_SHAPES],
                         ids=[f"{h}x{w}x{c}" for (h, w, c), _ in PATH_SHAPES])
def test_plan_served_shapes(hwc, dtype):
    """The frame's shapes: bf16 keeps h on the chip at 200x320x96 and
    100x160x192 (500 and 125 blocks of 128 pixels) and splits at C = 256
    (the fused route would spill) and above (Y would need C / 2 > 128
    registers a thread); fp32 always splits."""
    H, W, C = hwc
    pl = cb.plan(1, H, W, C, dtype, N_SM)
    _check_plan(1, H, W, C, dtype, pl)
    fused = dtype == BF16 and C in (96, 192)
    assert pl["route"] == ("fused" if fused else "split")
    assert pl["launches"] == (2 if fused else 3)


EDGES = [(1, 3, 5, 8), (1, 13, 17, 24), (1, 9, 70, 40), (1, 7, 33, 1536),
         (1, 1, 1, 8), (1, 1, 1, 768), (1, 13, 17, 96), (2, 50, 80, 384),
         (2, 13, 17, 24), (4, 25, 40, 256)]


@pytest.mark.parametrize("dtype", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", EDGES, ids=["x".join(map(str, s))
                                              for s in EDGES])
def test_plan_edge_shapes(shape, dtype):
    """C below one K piece (8, 24, 40), ConvNeXt-Large's last width (1536),
    one pixel, P no multiple of any tile, B = 2 and 4."""
    _check_plan(*shape, dtype, cb.plan(*shape, dtype, N_SM))


@pytest.mark.parametrize("dtype,step,top", [(BF16, 8, 1664), (FP32, 4, 3072)],
                         ids=["bf16", "fp32"])
def test_every_width_gets_a_plan(dtype, step, top):
    """Every C the op takes (a multiple of the 16-byte vector; in bf16 up
    to 1664, where 64 rows of A and two ring stages fill 227 KB) has a plan
    on a small and a large map; a wider bf16 C raises."""
    for C in range(step, top + 1, step):
        for B, H, W in ((1, 5, 7), (1, 100, 160)):
            _check_plan(B, H, W, C, dtype, cb.plan(B, H, W, C, dtype, N_SM))
    if dtype == BF16:
        with pytest.raises(ValueError, match="too wide"):
            cb.plan(1, 5, 7, top + step, dtype, N_SM)


def test_forced_routes():
    """`route` forces a route where the kernels take it, and raises where
    they do not: the fused route takes C <= 192."""
    pl = cb.plan(1, 100, 160, 256, BF16, N_SM, route="split")
    assert pl["route"] == "split"
    _check_plan(1, 100, 160, 256, BF16, pl)
    pl = cb.plan(1, 50, 80, 192, BF16, N_SM, route="fused")
    assert pl["route"] == "fused"
    _check_plan(1, 50, 80, 192, BF16, pl)
    for C in (200, 256, 384):
        with pytest.raises(ValueError, match="C <= 192"):
            cb.plan(1, 50, 80, C, BF16, N_SM, route="fused")
    with pytest.raises(ValueError, match="no fused route"):
        cb.plan(1, 50, 80, 96, FP32, N_SM, route="fused")
    with pytest.raises(ValueError, match="unknown route"):
        cb.plan(1, 50, 80, 96, BF16, N_SM, route="both")
    with pytest.raises(ValueError, match="no kernel"):
        cb.plan(1, 50, 80, 12, BF16, N_SM)
    with pytest.raises(ValueError, match="not supported"):
        cb.plan(1, 50, 80, 16, torch.float16, N_SM)


def test_smaller_card_plans_fewer_blocks_a_group():
    """The plan follows the SM count: on a card of 66 SMs the first
    product's groups of hidden chunks are no smaller than on 132."""
    big = cb.plan(1, 50, 80, 384, BF16, 132)
    small = cb.plan(1, 50, 80, 384, BF16, 66)
    assert small["n1"] >= big["n1"]
    _check_plan(1, 50, 80, 384, BF16, small, 66)


OVERRIDES = [
    (BF16, (1, 50, 80, 384), dict(m1=64), dict(m1=64, grid1=(63, 2))),
    (BF16, (1, 50, 80, 384), dict(waves=2), dict(n1=192, grid1=(32, 8))),
    (BF16, (1, 50, 80, 384), dict(m2=128, stages2=6),
     dict(m2=128, n2=128, stages2=6, grid2=(32, 3))),
    (FP32, (1, 50, 80, 384), dict(m1=64, n1=64, m2=128, n2=128),
     dict(m1=64, n1=64, m2=128, n2=128, grid1=(63, 24), grid2=(32, 3))),
]


@pytest.mark.parametrize("dtype,shape,kw,want", OVERRIDES,
                         ids=["bf16-m1", "bf16-waves", "bf16-p2", "fp32-tiles"])
def test_plan_overrides(dtype, shape, kw, want):
    """The keyword arguments of `plan` (the plan sweeps' variants) replace
    the plan's own choices, and the rest of the plan follows from them."""
    pl = cb.plan(*shape, dtype, N_SM, **kw)
    assert max(pl["smem1"], pl["smem2"]) <= cb.MAX_SMEM
    for k, v in want.items():
        assert pl[k] == v, k
    assert pl["ints"] == tuple(int(pl["route"] == "split") if k == "route"
                               else pl[k] for k in cb.PLAN_KEYS)


def test_plan_override_that_does_not_fit_raises():
    """128 rows of A at C = 1536 take more than a block's shared memory."""
    with pytest.raises(ValueError, match="exceed"):
        cb.plan(1, 7, 33, 1536, BF16, N_SM, m1=128)


def test_c_entry_reads_the_fields_in_plan_order():
    """The C entry's enum of plan fields names PLAN_KEYS in their order."""
    with open(CSRC) as f:
        src = f.read()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\bPL_([A-Z0-9_]+)\b", body)
    assert names[-1] == "LEN"
    assert [n.lower() for n in names[:-1]] == list(cb.PLAN_KEYS)


# ------------------------------------------------------------------ card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.fixture
def fp32_references():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


CARD_CASES = (
    [((1, h, w, c), BF16, None) for (h, w, c), _ in PATH_SHAPES]
    + [((1, 100, 160, 256), BF16, "split"), ((1, 200, 320, 96), BF16, "fused"),
       ((1, 50, 80, 192), BF16, "fused"), ((1, 9, 70, 40), BF16, "split"),
       ((2, 13, 17, 24), BF16, None), ((1, 9, 70, 40), BF16, None),
       ((1, 7, 33, 1536), BF16, None), ((2, 50, 80, 384), BF16, None),
       ((1, 3, 5, 8), BF16, None),
       ((1, 50, 80, 384), FP32, None), ((2, 13, 17, 24), FP32, None),
       ((1, 25, 40, 256), FP32, None), ((1, 7, 33, 1536), FP32, None)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,route", CARD_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{str(d)[6:]}-{r}"
                              for s, d, r in CARD_CASES])
def test_kernel_matches_plain_on_the_card(shape, dtype, route,
                                          fp32_references):
    _card()
    import chip_smoke

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(*shape, device=dev, generator=g).to(dtype)
    p = chip_smoke._cb_params(shape[-1], g, dev)
    for exact_gelu in (False, True):
        n0 = cb.launches
        if route is None:
            yk = cb.convnext_block_cuda(x, p, exact_gelu)
        else:
            pl = cb.device_plan(x, route)
            assert pl["route"] == route
            yk = torch.empty_like(x)
            cb.launch(x, cb.prepare(x, p), cb.scratch(x, pl), yk, exact_gelu,
                      pl)
        assert cb.launches == n0 + 1
        yp = cb.convnext_block_plain(x, p, exact_gelu)
        torch.cuda.synchronize()
        nbad, share, _ = chip_smoke.cb_disagreement(x, p, exact_gelu, yk, yp)
        assert nbad == 0 and bool(torch.isfinite(yk.float()).all())
        assert dtype == FP32 or share <= 0.02


@pytest.mark.cuda
def test_refused_plan_raises_on_the_card():
    """A plan the C entry cannot run raises before any launch."""
    _card()
    import chip_smoke

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(1, 13, 17, 96, device=dev, generator=g).bfloat16()
    p = chip_smoke._cb_params(96, g, dev)
    pl = cb.device_plan(x)
    bad = dict(pl, ints=(pl["ints"][0], 96) + pl["ints"][2:])
    with pytest.raises(RuntimeError, match="launch failed"):
        cb.launch(x, cb.prepare(x, p), cb.scratch(x, pl), torch.empty_like(x),
                  True, bad)


def _dw_fma_order(x, k, b):
    """The dw7x7 kernel's sum, element by element: the bias, then the 49
    taps in (row, column) order, each an fp32 FMA (an fp64 sum of the exact
    product, rounded once to fp32), then one rounding to x.dtype."""
    import torch.nn.functional as F

    dt = x.dtype
    k, b = k.to(dt).double(), b.to(dt).float()
    B, H, W, C = x.shape
    xp = F.pad(x.double(), (0, 0, 3, 3, 3, 3))
    acc = b.expand(B, H, W, C).clone()
    for dy in range(7):
        for dx in range(7):
            acc = (acc.double() + xp[:, dy:dy + H, dx:dx + W] * k[dy, dx]
                   ).float()
    return acc.to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, FP32], ids=["bf16", "fp32"])
def test_dwconv7x7_bit_for_bit_after_the_move(dtype):
    """dwconv7x7_nhwc's strip kernel now sits in csrc/dw7x7_strip.cuh,
    templated on the tap and output types. Its output is, bit for bit, its
    own order of FMAs (bias, then taps by row and column) emulated here, on
    both tilings of the launcher, ragged maps and B = 2. (cuDNN's plain
    version sums in another order at these shapes; a double rounding in the
    emulation is a one-in-1e9 event a tap, and these maps have under 1e6
    taps.)"""
    _card()
    from unicorn_torch.ops import dwconv7x7 as dw

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    for shape in ((2, 13, 17, 40), (1, 9, 70, 16), (1, 12, 20, 256),
                  (1, 5, 3, 96)):
        x = torch.randn(*shape, device=dev, generator=g).to(dtype)
        k = 0.1 * torch.randn(7, 7, shape[-1], device=dev, generator=g)
        b = 0.1 * torch.randn(shape[-1], device=dev, generator=g)
        assert torch.equal(dw.dwconv7x7_cuda(x, k, b), _dw_fma_order(x, k, b))


DW_SHAPES = [(B, h, w, c) for B in (1, 4) for (h, w, c), _ in PATH_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", DW_SHAPES,
                         ids=["x".join(map(str, s)) for s in DW_SHAPES])
def test_dwconv7x7_equals_plain_on_exact_sums(shape, dtype, fp32_references):
    """dwconv7x7_nhwc equals its plain version (cuDNN, TF32 off) bit for
    bit at the frame's seven shapes, one frame and the training step's
    four, on inputs whose 49-tap sums are exact in fp32 (x a multiple of
    1/8 up to 1, taps of 1/64 up to 1/8, bias of 1/8): any order of the sum
    gives the same fp32 value, so this holds the taps, bias, borders and
    tiling of the strip kernel in its header against cuDNN, and the test
    above holds its order."""
    _card()
    from unicorn_torch.ops import dwconv7x7 as dw

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    C = shape[-1]

    def grid(size, step, top):
        return torch.randint(-top, top + 1, size, device=dev,
                             generator=g).float() * step

    x = grid(shape, 1 / 8, 8).to(dtype)
    k, b = grid((7, 7, C), 1 / 64, 8), grid((C,), 1 / 8, 8)
    assert torch.equal(dw.dwconv7x7_cuda(x, k, b), dw.dwconv7x7_plain(x, k, b))


@pytest.mark.cuda
def test_serving_correlation_after_the_move(fp32_references):
    """The serving correlation, whose TMA / wgmma helpers moved into
    csrc/tma_wgmma.cuh, against its plain version at the served shape and
    the tolerance of its own card test (rtol 1e-4, atol 1e-5)."""
    _card()
    from unicorn_torch.ops import correlation_kernel as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    e0, e1 = (0.3 * torch.randn(1, 16000, 128, device=dev, generator=g)
              for _ in range(2))
    v = torch.rand(1, 1, 16000, device=dev, generator=g)
    out = ck.correlation_propagate_auto(e0, e1, v)
    ref = ck.correlation_propagate_plain(e0, e1, v, bf16_dots=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
