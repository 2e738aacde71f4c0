"""The restructured dw7x7 backward of the port (`set_dw_custom_vjp`,
unicorn_torch/ops/dwconv7x7.py) against the JAX package's
(`dw_grads_restructured`, `dwconv7x7_cvjp`, unicorn_tpu/ops/
pallas_convnext.py), on the CPU, where the op's backward runs the filter
gradient's plain version `dw7x7_wgrad_plain` and dx through the forward's
plain version on flipped taps.

Tolerances.
  * the op and its pieces against JAX's, fp32: JAX's own test of
    `dw_grads_restructured` (tests/test_pallas_convnext.py): rtol 1e-5 and
    atol 1e-4 on dW, 1e-5 on dx and dbias.
  * the forward: bit-equal with and without the flag (the same op runs).
  * the uni loss of a width-0.5 ConvNeXt-Tiny Unicorn with the flag on in
    both packages, the same weights through convert.to_flax: the loss dict
    at rtol 1e-4 and every gradient leaf within 1e-3 of its largest
    magnitude, the bounds of tests/test_torch_port_train_step.py.
  * remat True / "dw" against False with the flag on: the loss within 1e-6
    of its value, every gradient entry within 1e-6 of its leaf's largest
    (the recomputation repeats the same ops), as tests/
    test_torch_port_remat.py holds them with the flag off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.core.train_step import det_loss_fn, uni_loss_fn
from unicorn_torch.models.blocks import DepthwiseConv7x7, init_weights
from unicorn_torch.models.convnext import ConvNeXt
from unicorn_torch.models.unicorn import Unicorn, YOLOXDet
from unicorn_torch.ops import dwconv7x7 as dw
from unicorn_tpu.core.train_step import uni_loss_fn as j_uni_loss_fn
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.ops import pallas_convnext as pc


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def flag_on():
    dw.set_dw_custom_vjp(True)
    yield
    dw.set_dw_custom_vjp(False)


def _case(C, seed=0, B=2, H=12, W=16):
    """JAX's own case (tests/test_pallas_convnext.py): x, taps (7,7,1,C),
    bias, dy."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            (rng.randn(7, 7, 1, C) * 0.1).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=atol)


# C = 6: no multiple of the 16-byte vector (4 fp32 channels)
@pytest.mark.parametrize("C", [8, 6])
def test_wgrad_plain_matches_jax(C):
    x, k, _, dy = _case(C)
    _, dk_j, db_j = pc.dw_grads_restructured(jnp.asarray(x), jnp.asarray(k),
                                             jnp.asarray(dy))
    dk, db = dw.dw7x7_wgrad(torch.from_numpy(x), torch.from_numpy(dy))
    assert dk.dtype == db.dtype == torch.float32
    assert tuple(dk.shape) == (7, 7, C) and tuple(db.shape) == (C,)
    _close(dk.numpy(), np.asarray(dk_j)[:, :, 0], 1e-4)
    _close(db.numpy(), db_j, 1e-5)


def _op_grads(x, k, b, gy):
    """Gradients of dwconv7x7(x, k, b) against gy, taps (7,7,1,C)."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    y = dw.dwconv7x7(*leaves)
    return y, torch.autograd.grad(y, leaves, torch.from_numpy(gy))


@pytest.mark.parametrize("C", [8, 6])
def test_flagged_backward_matches_jax(C, flag_on):
    x, k, b, dy = _case(C, seed=1)
    dx_j, dk_j, db_j = pc.dw_grads_restructured(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(dy))
    _, (dx, dk, db) = _op_grads(x, k, b, dy)
    assert dk.shape == (7, 7, 1, C) and dk.dtype == torch.float32
    _close(dx.numpy(), dx_j, 1e-5)
    _close(dk.numpy(), dk_j, 1e-4)
    _close(db.numpy(), db_j, 1e-5)


def test_flagged_loss_grads_match_jax_cvjp(flag_on):
    """JAX's end-to-end case: grad of sum(sin(y)) through dwconv7x7_cvjp
    against the flagged op's."""
    x, k, b, _ = _case(8, seed=2)
    g_j = jax.grad(lambda *a: jnp.sum(jnp.sin(pc.dwconv7x7_cvjp(*a))),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    torch.sin(dw.dwconv7x7(*leaves)).sum().backward()
    for t, j in zip(leaves, g_j):
        _close(t.grad.numpy(), j, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flagged_forward_is_bit_equal(dtype):
    x, k, b, _ = _case(8, seed=3)
    xt = torch.from_numpy(x).to(dtype)
    y0 = dw.dwconv7x7(xt, torch.from_numpy(k), torch.from_numpy(b))
    dw.set_dw_custom_vjp(True)
    try:
        y1 = dw.dwconv7x7(xt, torch.from_numpy(k), torch.from_numpy(b))
    finally:
        dw.set_dw_custom_vjp(False)
    assert torch.equal(y0, y1)


def test_flag_is_read_at_the_forward(monkeypatch):
    """A forward run with the flag on keeps the restructured backward when
    the flag is off by the backward, and the other way round."""
    calls = []
    wgrad = dw.dw7x7_wgrad
    monkeypatch.setattr(dw, "dw7x7_wgrad",
                        lambda *a: calls.append(1) or wgrad(*a))
    x, k, b, dy = _case(4, seed=4)
    for on in (True, False):
        dw.set_dw_custom_vjp(on)
        try:
            leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
            y = dw.dwconv7x7(*leaves)
        finally:
            dw.set_dw_custom_vjp(not on)
        y.backward(torch.from_numpy(dy))
        dw.set_dw_custom_vjp(False)
    assert len(calls) == 1


# ------------------------------------------------------------ models
def _count_wgrad(monkeypatch):
    """[wgrad calls, dw7x7 module calls], counted while the test runs."""
    counts = [0, 0]
    wgrad = dw.dw7x7_wgrad

    def spy(*a):
        counts[0] += 1
        return wgrad(*a)

    fwd = DepthwiseConv7x7.forward_nhwc

    def fwd_spy(self, x):
        counts[1] += 1
        return fwd(self, x)

    monkeypatch.setattr(dw, "dw7x7_wgrad", spy)
    monkeypatch.setattr(DepthwiseConv7x7, "forward_nhwc", fwd_spy)
    return counts


def _loss_and_grads(model, loss):
    model.zero_grad(set_to_none=True)
    total = loss()
    total.backward()
    return total.item(), {n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None}


def _assert_grads(got, want, share):
    assert got.keys() == want.keys()
    for name, g in want.items():
        bound = share * float(g.abs().max()) + 1e-30
        assert float((got[name] - g).abs().max()) <= bound, name


DEPTHS, DIMS = (1, 1, 2, 1), (16, 32, 48, 64)
OFFSETS = [np.random.RandomState(5).randn(c).astype(np.float32)
           for c in DIMS[1:]]


def _trunk(remat):
    m = ConvNeXt(DEPTHS, DIMS, remat=remat)
    init_weights(m, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.3 + 0.4 * torch.rand(p.shape, generator=g))
    return m.train()


def _trunk_loss(outs):
    return sum(((o.float() + torch.from_numpy(w)[:, None, None]) ** 2).mean()
               for o, w in zip(outs, OFFSETS))


@pytest.mark.parametrize("remat", [True, "dw"])
def test_trunk_remat_equal_with_flag(remat, flag_on, monkeypatch):
    img = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32)
    x = torch.from_numpy(img * 255).permute(0, 3, 1, 2)
    want = _loss_and_grads(m := _trunk(False), lambda: _trunk_loss(m(x)))
    counts = _count_wgrad(monkeypatch)
    model = _trunk(remat)
    got = _loss_and_grads(model, lambda: _trunk_loss(model(x)))
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    _assert_grads(got[1], want[1], 1e-6)
    # every block's dw7x7 took the restructured backward (remat True runs
    # each block's forward twice, the recomputation's is the one used)
    assert counts[0] == sum(DEPTHS)
    assert counts[1] == sum(DEPTHS) * (2 if remat is True else 1)


def test_trunk_flag_matches_default_backward(flag_on):
    """The restructured backward against the default one on the same
    trunk: every gradient entry within 1e-5 of its leaf's largest (fp32
    sums in other orders)."""
    img = np.random.RandomState(6).rand(2, 64, 96, 3).astype(np.float32)
    x = torch.from_numpy(img * 255).permute(0, 3, 1, 2)
    got = _loss_and_grads(m := _trunk(False), lambda: _trunk_loss(m(x)))
    dw.set_dw_custom_vjp(False)
    want = _loss_and_grads(m, lambda: _trunk_loss(m(x)))
    assert got[0] == want[0]
    _assert_grads(got[1], want[1], 1e-5)


H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5,
           n_layer_att=1)
LOSS_KW = dict(mot_weight=3.0, sot_weight=1.0, bidirect=True, use_l1=True,
               num_classes=8, mhs=True, mhs_weight=0.5)


def _uni_batch(seed=0):
    """One SOT and one MOT pair, numpy (B, 2, H, W, 3) as JAX takes them."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(2, 2, H, W, 3) * 255).astype(np.float32)
    targets = np.zeros((2, 2, 6, 6), np.float32)
    tasks = (1, 2)
    for b in range(2):
        n = 1 if tasks[b] == 1 else 4
        cxy = rng.uniform(0.2, 0.8, (n, 2)) * [W, H]
        wh = rng.uniform(16, 56, (n, 2))
        for f in range(2):
            targets[b, f, :n, 0] = rng.randint(0, 8, n) if tasks[b] == 2 else 0
            targets[b, f, :n, 1:3] = cxy + f * rng.uniform(-3, 3, (n, 2))
            targets[b, f, :n, 3:5] = wh
            targets[b, f, :n, 5] = np.arange(1, n + 1)
    return images, targets, np.asarray(tasks, np.int32)


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_uni_loss_with_flag_matches_jax(flag_on, monkeypatch):
    """uni_loss_fn with the flag on in both packages: the loss dict and
    every gradient leaf; every dw7x7 call of the step took the
    restructured backward."""
    model = Unicorn(**CFG, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    # layer scales near 0.5, so that every block counts; the interaction's
    # zero-initialised offsets and attention logits made small but not
    # zero, as tests/test_torch_port_train_step.py does, so that their
    # inputs' gradients are not hidden
    scales = {"gamma": None, "sampling_offsets.weight": 0.05,
              "attention_weights.weight": 0.5}
    with torch.no_grad():
        for name, p in model.named_parameters():
            for key, s in scales.items():
                if name.endswith(key):
                    p.copy_(0.3 + 0.4 * torch.rand(p.shape, generator=g)
                            if s is None else
                            s * torch.randn(p.shape, generator=g))
    model.train()
    params = {"params": to_flax({k: v.detach() for k, v in
                                 model.state_dict().items()})}
    images, targets, tasks = _uni_batch()

    jm = JUnicorn(**CFG)
    pc.set_dw_custom_vjp(True)
    try:
        @jax.jit
        def loss_and_grads(p, images, targets, tasks):
            def loss(p_):
                return j_uni_loss_fn(jm, p_, images, targets, tasks, (H, W),
                                     *LOSS_KW.values())
            (_, loss_dict), grads = jax.value_and_grad(
                loss, has_aux=True)(p)
            return loss_dict, grads

        ref_dict, ref_grads = loss_and_grads(
            params, *map(jnp.asarray, (images, targets, tasks)))
    finally:
        pc.set_dw_custom_vjp(False)

    counts = _count_wgrad(monkeypatch)
    total, loss_dict = uni_loss_fn(
        model, torch.from_numpy(images).permute(0, 1, 4, 2, 3).contiguous(),
        torch.from_numpy(targets), torch.from_numpy(tasks).long(), (H, W),
        **LOSS_KW)
    total.backward()
    assert counts[0] == counts[1] > 0
    assert set(loss_dict) == set(ref_dict)
    for k, v in ref_dict.items():
        np.testing.assert_allclose(loss_dict[k].item(), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = _leaves(to_flax({n: p.grad for n, p in model.named_parameters()}))
    ref = _leaves(ref_grads["params"])
    assert set(got) == set(ref)
    bad = {}
    for path, g_ref in ref.items():
        scale = max(np.abs(g_ref).max(), 1e-12)
        worst = np.abs(got[path] - g_ref).max() / scale
        if worst > 1e-3:
            bad[path] = worst
    assert not bad, bad


def test_det_step_takes_the_flag(flag_on, monkeypatch):
    """det_loss_fn (the det and inst stages' loss) backward with the flag
    on: every dw7x7 call, trunk and head, took the restructured backward."""
    counts = _count_wgrad(monkeypatch)
    model = YOLOXDet(backbone_name="convnext_tiny", width=0.5,
                     use_attention=True, n_layer_att=1,
                     generator=torch.Generator().manual_seed(0)).train()
    rng = np.random.RandomState(3)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, :5, 0] = rng.randint(0, 80, (2, 5))
    labels[:, :5, 1:3] = rng.uniform(0.2, 0.8, (2, 5, 2)) * (96, 64)
    labels[:, :5, 3:5] = rng.uniform(8, 30, (2, 5, 2))
    images = torch.from_numpy(rng.rand(2, 3, 64, 96).astype(np.float32)
                              * 255)
    det_loss_fn(model, images, torch.from_numpy(labels), (64, 96))[0] \
        .backward()
    assert counts[0] == counts[1] == 18 + 3
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for n, p in model.named_parameters() if "dwconv" in n)
