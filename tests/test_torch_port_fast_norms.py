"""Fast-norm serving in the port (`set_fast_norms`, unicorn_torch/models/
blocks.py) against the port without it and against the JAX package's
switch of the same name (unicorn_tpu/models/blocks.py), on the CPU; and the
port's `letterbox_batch_device` against JAX's.

Under the switch a norm of a bf16 model takes its bf16 input without an
fp32 copy and writes bf16 rounded once from fp32 arithmetic with the fp32
affine: a GroupNorm32 through `group_norm_fast`, a ConvNeXt LayerNorm
through `layer_norm_fast` (both flax's E[x^2] - E[x]^2 from fp32 sums).
The norms' weights are also perturbed away from flax's init (scale 1,
bias 0, which bf16 holds exactly), so that an affine rounded to bf16
would show.

Tolerances.
  * fp32 models: bit-identical with and without the switch (JAX's test).
  * bf16 fast against bf16 exact, decoded outputs: scores within 2e-2,
    boxes within 1.0 px (JAX's test_fast_norms_serving_drift_bounded), at
    flax's init affine and at a perturbed one.
  * each norm's fast output against its exact one on the same bf16 input:
    within one bf16 step of the larger of the two (both are roundings of
    the same value up to fp32 error), plus 1e-5; a slightly wrong norm
    (eps 1e-2 for 1e-3, a bias off by 1e-2) fails it.
  * the port's bf16 fast against JAX's bf16 fast, the head's packed
    outputs: the largest difference within 5% and the mean within 1.5% of
    the output's |max| (the bf16 bound of tests/test_torch_port_model.py).
  * the interaction's and Swin's norms: bit-identical with the switch.
  * letterbox: equal to JAX's at r = 1; at r != 1 within 0.5 of it (the
    port rounds the resize to uint8 levels as cv2 does, JAX does not), and
    equal to the port's letterbox_device frame by frame.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.models import blocks
from unicorn_torch.models.blocks import (ConvNeXtBlock, GroupNorm32,
                                         LayerNorm32)
from unicorn_torch.models.convnext import ConvNeXt
from unicorn_torch.models.heads import decode_for_inference
from unicorn_torch.models.swin import SwinTransformer
from unicorn_torch.models.unicorn import Unicorn
from unicorn_torch.ops.letterbox import (letterbox_batch_device,
                                         letterbox_device)
from unicorn_torch.parallel import rows
from unicorn_tpu.models import blocks as jblocks
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.ops.letterbox import \
    letterbox_batch_device as j_letterbox_batch


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def fast_on():
    blocks.set_fast_norms(True)
    yield
    blocks.set_fast_norms(False)


def _perturb_norms(model, seed=1):
    """Every GroupNorm32 / LayerNorm32 affine: scale 1 + 0.2 N(0, 1), bias
    0.2 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (GroupNorm32, LayerNorm32)):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return model


def _nchw(imgs):
    return torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


# JAX's test: ConvNeXt-Tiny at full width, the conv interaction, no
# attention blocks, 64x96
DRIFT_CFG = dict(num_classes=1, backbone_name="convnext_tiny",
                 in_channels=(192, 384, 768), interact_mode="conv",
                 n_layer_att=0, use_attention=False)


@pytest.fixture(scope="module")
def drift_models():
    torch.set_num_threads(1)
    m32 = Unicorn(**DRIFT_CFG, generator=torch.Generator().manual_seed(0))
    state = m32.state_dict()
    m16 = Unicorn(**DRIFT_CFG, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0))
    m16.load_state_dict(state)
    return m32.eval(), m16.eval(), state


@pytest.mark.parametrize("affine", ["init", "perturbed"])
def test_fast_norms_serving_drift_bounded(drift_models, affine):
    m32, m16, state = drift_models
    for m in (m32, m16):
        m.load_state_dict(state)
        if affine == "perturbed":
            _perturb_norms(m)
    imgs = _nchw((np.random.RandomState(0).rand(1, 64, 96, 3) * 255)
                 .astype(np.float32))

    def run(m, fast):
        blocks.set_fast_norms(fast)
        try:
            with torch.no_grad():
                raw, _ = m.forward_whole(imgs)
            return decode_for_inference(raw, (8, 16, 32), mode="mot") \
                .float().numpy()
        finally:
            blocks.set_fast_norms(False)

    f32 = run(m32, False)
    np.testing.assert_array_equal(f32, run(m32, True))
    exact, fast = run(m16, False), run(m16, True)
    np.testing.assert_allclose(fast[..., 4:], exact[..., 4:], atol=2e-2)
    np.testing.assert_allclose(fast[..., :4], exact[..., :4], atol=1.0)


def _within_a_step(a, b):
    """Elementwise: |a - b| within one bf16 step at the larger of |a|,
    |b| (8 bits of mantissa), plus 1e-5."""
    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return bool(((a - b).abs() <= step + 1e-5).all())


H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5)


def test_fast_bf16_matches_jax_fast_bf16():
    """The width-0.5 Unicorn's forward_whole in bf16 with the switch on in
    both packages, the same (perturbed) weights through to_flax."""
    model = _perturb_norms(Unicorn(
        **CFG, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0))).eval()
    params = {"params": to_flax({k: v.detach() for k, v in
                                 model.state_dict().items()})}
    imgs = (np.random.RandomState(2).rand(1, H, W, 3) * 255).astype(
        np.float32)
    jm = JUnicorn(**CFG, dtype=jnp.bfloat16)
    jblocks.set_fast_norms(True)
    try:
        raw_j, _ = jax.jit(functools.partial(
            jm.apply, method=JUnicorn.forward_whole))(params,
                                                      jnp.asarray(imgs))
    finally:
        jblocks.set_fast_norms(False)
    blocks.set_fast_norms(True)
    try:
        with torch.no_grad():
            raw_t, _ = model.forward_whole(_nchw(imgs))
    finally:
        blocks.set_fast_norms(False)
    for lj, lt in zip(raw_j, raw_t):
        for key in ("_cls_packed", "_reg_packed"):
            assert lt[key].dtype == torch.bfloat16
            a = np.asarray(lj[key]).astype(np.float32)
            d = np.abs(lt[key].float().permute(0, 2, 3, 1).numpy() - a)
            scale = np.abs(a).max()
            assert d.max() <= 0.05 * scale and d.mean() <= 0.015 * scale


def _norm_outputs(model, x_by_norm):
    """Each norm's bf16 output on its input, with the switch off and on."""
    out = {}
    for fast in (False, True):
        blocks.set_fast_norms(fast)
        try:
            with torch.no_grad():
                out[fast] = {n: m(x_by_norm[n]) for n, m in
                             model.named_modules() if n in x_by_norm}
        finally:
            blocks.set_fast_norms(False)
    return out[False], out[True]


def _norm_inputs(model, seed=3):
    """A bf16 input of each norm's width: (2, 5, 7, C) for a LayerNorm32
    over the last axis, NCHW channels_last otherwise."""
    g = torch.Generator().manual_seed(seed)
    xs = {}
    for n, m in model.named_modules():
        if isinstance(m, (GroupNorm32, LayerNorm32)):
            C = m.weight.shape[0]
            if isinstance(m, LayerNorm32) and not m.channels_first:
                x = torch.randn(2, 5, 7, C, generator=g)
            else:
                x = torch.randn(2, C, 5, 7, generator=g).contiguous(
                    memory_format=torch.channels_last)
            xs[n] = (3 * x + 1).to(torch.bfloat16)
    return xs


def test_switch_acts_only_at_jax_sites(monkeypatch):
    """In a bf16 Unicorn with the deform interaction in bf16, and a Swin
    trunk: the interaction's and Swin's LayerNorm32s give the same bits
    with the switch; every GroupNorm32 takes `group_norm_fast` and the
    ConvNeXt trunk's and blocks' LayerNorm32s `layer_norm_fast`, each
    within a bf16 step of the exact form."""
    fast_gn, fast_ln = [], []
    gn, ln = blocks.group_norm_fast, blocks.layer_norm_fast
    monkeypatch.setattr(blocks, "group_norm_fast",
                        lambda x, *a: fast_gn.append(1) or gn(x, *a))
    monkeypatch.setattr(blocks, "layer_norm_fast",
                        lambda x, *a: fast_ln.append(1) or ln(x, *a))
    uni = _perturb_norms(Unicorn(**CFG, dtype=torch.bfloat16,
                                 interact_dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0)))
    swin = _perturb_norms(SwinTransformer(
        embed_dim=24, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24),
        dtype=torch.bfloat16))
    for model in (uni, swin):
        sites = {id(n) for m in model.modules()
                 if isinstance(m, (ConvNeXt, ConvNeXtBlock))
                 for n in m.modules() if isinstance(n, LayerNorm32)}
        xs = _norm_inputs(model)
        kept = 0
        fast_gn.clear()
        fast_ln.clear()
        exact, fast = _norm_outputs(model, xs)
        n_gn = sum(isinstance(m, GroupNorm32) for m in model.modules())
        assert len(fast_gn) == n_gn
        assert len(fast_ln) == len(sites)
        for n, m in model.named_modules():
            if n not in xs:
                continue
            honours = isinstance(m, GroupNorm32) or m.fast_norms
            assert honours == (isinstance(m, GroupNorm32)
                               or id(m) in sites), n
            assert fast[n].dtype == torch.bfloat16, n
            if honours:
                assert _within_a_step(fast[n], exact[n]), n
            else:
                assert torch.equal(fast[n], exact[n]), n
                kept += 1
        assert kept > 0
    # and whole: the Swin trunk's outputs keep their bits
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = swin(x)
        blocks.set_fast_norms(True)
        try:
            got = swin(x)
        finally:
            blocks.set_fast_norms(False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_one_step_check_fails_a_wrong_norm():
    """The one-bf16-step check that holds each fast norm to its exact form
    (here and in chip_smoke.py `_norm_sites`) passes the fast forms and
    fails a norm that is slightly wrong: a GroupNorm with eps 1e-2 for
    1e-3, a LayerNorm with a bias off by 1e-2."""
    g = torch.Generator().manual_seed(7)
    gn = _perturb_norms(GroupNorm32(64, dtype=torch.bfloat16))
    ln = _perturb_norms(LayerNorm32(96, dtype=torch.bfloat16,
                                    fast_norms=True))
    x = (torch.randn(2, 64, 9, 11, generator=g) * 3 + 1).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    t = (torch.randn(2, 9, 11, 96, generator=g) * 3 + 1).to(torch.bfloat16)
    with torch.no_grad():
        exact_gn, exact_ln = gn(x), ln(t)
        w, b = gn.weight, gn.bias
        assert _within_a_step(blocks.group_norm_fast(x, 16, w, b, 1e-3),
                              exact_gn)
        assert not _within_a_step(blocks.group_norm_fast(x, 16, w, b, 1e-2),
                                  exact_gn)
        assert _within_a_step(
            blocks.layer_norm_fast(t, ln.weight, ln.bias, 1e-6), exact_ln)
        assert not _within_a_step(
            blocks.layer_norm_fast(t, ln.weight, ln.bias + 1e-2, 1e-6),
            exact_ln)


def test_row_split_group_norm_fast_form(monkeypatch):
    """The row split's GroupNorm32 under the switch takes `group_norm_fast`
    with the sums over the whole frame: at one rank the same bits as the
    whole map's fast form and within a bf16 step of the row split's exact
    form; at two ranks (the collective replaced by adding the other rank's
    sums) each rank's rows within a bf16 step of the whole map's."""
    m = _perturb_norms(GroupNorm32(32, dtype=torch.bfloat16))
    x = (torch.randn(2, 32, 8, 6, generator=torch.Generator().manual_seed(5))
         * 3 + 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    plan = rows.RowPlan((1,), 0)
    with torch.no_grad():
        with rows.row_sharded(plan):
            exact = m(x)
        blocks.set_fast_norms(True)
        try:
            whole = m(x)
            with rows.row_sharded(plan):
                split = m(x)
            halves = x[:, :, :4], x[:, :, 4:]
            monkeypatch.setattr(rows, "all_reduce", lambda t, p: t.add_(
                blocks._sums(halves[1 - p.rank], (2, 3))))
            two = []
            for r in (0, 1):
                with rows.row_sharded(rows.RowPlan((1, 1), r, object())):
                    two.append(m(halves[r]))
        finally:
            blocks.set_fast_norms(False)
    assert split.dtype == torch.bfloat16
    assert split.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(split, whole)
    assert _within_a_step(split, exact)
    assert _within_a_step(torch.cat(two, 2), whole)


@pytest.mark.parametrize("src_hw,dst_hw", [((96, 160), (96, 160)),
                                           ((100, 200), (128, 128)),
                                           ((70, 50), (96, 160))])
def test_letterbox_batch_matches_jax(src_hw, dst_hw):
    frames = (np.random.RandomState(6).rand(3, *src_hw, 3) * 255).astype(
        np.uint8)
    got = letterbox_batch_device(torch.from_numpy(frames), dst_hw)
    assert got.dtype == torch.float32 and got.shape == (3, *dst_hw, 3)
    want = np.asarray(j_letterbox_batch(jnp.asarray(frames), src_hw, dst_hw))
    if src_hw == dst_hw:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=0.5 + 1e-4)
    for f, g in zip(frames, got):
        torch.testing.assert_close(letterbox_device(torch.from_numpy(f),
                                                    dst_hw)[0], g,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="uint8"):
        letterbox_batch_device(torch.from_numpy(frames).float(), dst_hw)
