"""The port's training loop (unicorn_torch/core/trainer.py), checkpoints
(core/checkpoint.py), TrainState's state_dict and rewind, and the exps'
load_pretrained, on the CPU with the JAX tests' tiny model: CSPDarknet
depth 0.33 width 0.25, the "conv" interaction, fp32, 64x64 pairs from
in-memory omni datasets (as tests/test_trainer.py).

The cases of tests/test_trainer.py, on the port; then against the JAX
package in the same process:
  * JAX's uni step as its Trainer builds it and the port's Trainer on the
    same weights (the port's init through convert.to_flax) and the same
    fixed batches: every loss of the first three steps within rtol 1e-4,
    atol 1e-6 (the loss tolerance of test_torch_port_train_step.py), and
    the port's metrics.jsonl records carry the JAX step's loss keys;
  * ExpTrack.load_pretrained and ExpDetMask.load_pretrained against JAX's
    surgery on the same detector weights (the port's seeded tensors
    through convert.to_flax): every tensor equal.
A resumed run is bit-identical to an uninterrupted one (weights, EMA,
AdamW moments and step counts, the accumulator).
"""
import json
import logging
import os
import signal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.core import checkpoint as ck
from unicorn_torch.core.train_state import (TrainState, make_optimizer,
                                            rewind_opt_counts)
from unicorn_torch.core.trainer import Trainer
from unicorn_torch.exp.det_mask import ExpDetMask
from unicorn_torch.exp.track import ExpTrack

H = W = 64
TINY = dict(backbone_name="csp_darknet", depth=0.33, width=0.25,
            in_channels=[256, 512, 1024], use_attention=False, n_layer_att=0,
            bf16=False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class FakeSOT:
    def __init__(self):
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return 20

    def pull_item_omni(self, seq_id, num_frames=2, rng=None):
        return [((self.rng.rand(48, 56, 3) * 255).astype(np.uint8),
                 np.array([[10, 10, 40, 40, 0]], np.float32))
                for _ in range(num_frames)]


class FakeMOT(FakeSOT):
    def pull_item_omni(self, seq_id, num_frames=2, rng=None):
        return [((self.rng.rand(48, 56, 3) * 255).astype(np.uint8),
                 np.array([[10, 10, 30, 30, 0, 1], [25, 20, 50, 45, 1, 2]],
                          np.float32))
                for _ in range(num_frames)]


def _tiny_fields(exp, out_dir):
    for k, v in TINY.items():
        setattr(exp, k, v)
    exp.exp_name = "tiny_test"
    exp.output_dir = out_dir
    exp.interact_mode = "conv"
    exp.input_size = (H, W)
    exp.max_labels = 5
    exp.samples_per_epoch = 6
    exp.max_epoch = 1
    exp.multiscale_range = 0
    exp.ema = True
    exp.use_grad_acc = False
    exp.eval_interval = 100  # no in-training eval
    exp.print_interval = 2
    exp.pretrain_name = None


class TinyExp(ExpTrack):
    def __init__(self, out_dir):
        super().__init__()
        _tiny_fields(self, out_dir)

    def get_dataset(self, sot_datasets=None, mot_datasets=None):
        return super().get_dataset([FakeSOT()], [FakeMOT()])


def _trainer(out_dir, args=None, **fields):
    exp = TinyExp(str(out_dir))
    for k, v in fields.items():
        setattr(exp, k, v)
    return Trainer(exp, {"batch_size": 2, **(args or {})}, device="cpu")


def _fixed_uni_batches(n, bs=2, m=5):
    """Deterministic synthetic uni batches (images, targets, task_ids) in
    the loader's layout."""
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(n):
        images = (rng.rand(bs, 2, H, W, 3) * 255).astype(np.float32)
        t = np.zeros((bs, m, 6), np.float32)
        t[:, 0] = [0, H // 2, W // 2, 20, 20, 1]
        targets = np.stack([t, t], 1)
        task_ids = np.asarray(([1, 2] * bs)[:bs], np.int32)
        batches.append((images, targets, task_ids))
    return batches


def _run_steps(trainer, batches):
    dicts = []
    for b in batches:
        trainer.state, d = trainer.step_fn(trainer.state,
                                           *trainer.device_batch(b))
        dicts.append({k: float(v) for k, v in d.items()})
    return dicts


def _assert_states_equal(a: TrainState, b: TrainState):
    for x, y in ((a.model, b.model), (a.ema_model, b.ema_model)):
        for (n, p), q in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(p, q), n
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert (a.step, a.opt_count, a.mini_step) == \
        (b.step, b.opt_count, b.mini_step)


def test_trainer_end_to_end(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.train()
    out = tmp_path / "tiny_test"
    assert (out / "latest").is_file() and (out / "train_log.txt").is_file()
    assert not [f for f in os.listdir(out) if ".tmp" in f]
    assert trainer.state.step == 3
    assert trainer.meters["data_time"].global_avg > 0
    assert trainer.meters["step_time"]._count == 3
    # metrics.jsonl: one record every print_interval iterations, under the
    # step's loss keys (JAX's: test_trainer_matches_jax_trainer)
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    keys = set(_run_steps(trainer, _fixed_uni_batches(1))[0])
    assert [(r["epoch"], r["iter"]) for r in recs] == [(0, 2)]
    assert all(set(r) == {"epoch", "iter"} | keys for r in recs)
    t2 = _trainer(tmp_path, {"resume": True})
    t2.before_train()
    assert t2.start_epoch == 1  # == max_epoch: nothing left to train


def test_trainer_no_aug_transition(tmp_path):
    """At max_epoch - no_aug_epochs the trainer closes mosaic, enables L1
    and writes a checkpoint, once."""
    trainer = _trainer(tmp_path, max_epoch=2, no_aug_epochs=1)
    closed = []

    class _Loader:
        dataset = None

        def close_mosaic(self):
            closed.append(True)

    trainer.before_train()
    trainer.exp.always_l1 = False
    trainer.loader = _Loader()
    trainer.epoch = 0
    trainer.before_epoch()
    assert not trainer.no_aug and not closed  # too early
    trainer.epoch = 1
    trainer._step_fns["sentinel"] = object()
    trainer.before_epoch()
    assert trainer.no_aug and closed == [True] and trainer.exp.always_l1
    assert "sentinel" not in trainer._step_fns  # rebuilt with L1
    ck.wait_for_checkpoints()
    assert (tmp_path / "tiny_test" / "last_mosaic_epoch").is_file()
    trainer.before_epoch()
    assert closed == [True]


def test_before_epoch_no_aug_flips_always_l1():
    tr = object.__new__(Trainer)
    tr.exp = SimpleNamespace(no_aug_epochs=2, always_l1=False)
    tr.no_aug = False
    tr.epoch = 8
    tr.max_epoch = 10
    tr.logger = logging.getLogger("test")
    tr.loader = SimpleNamespace()
    tr._step_fns = {(64, 64): object()}
    tr.save_ckpt = lambda name, **kw: None
    tr.before_epoch()
    assert tr.no_aug and tr.exp.always_l1 is True and tr._step_fns == {}


def test_resume_restores_optimizer_state_bit_identical(tmp_path):
    """A checkpoint mid-accumulation (mini_step 1) and a resume reproduce
    the uninterrupted run bit for bit: weights, EMA, AdamW moments and
    per-parameter steps, the counters and the accumulator."""
    def make(subdir, resume=False):
        tr = _trainer(tmp_path / subdir, {"resume": resume},
                      use_grad_acc=True, grad_acc_step=2)
        tr.before_train()
        return tr

    batches = _fixed_uni_batches(6)
    tr_a = make("a")
    _run_steps(tr_a, batches)

    tr_b = make("b")
    _run_steps(tr_b, batches[:3])
    tr_b.epoch = 2
    tr_b.best_ap = 0.375
    tr_b.save_ckpt("latest")
    ck.wait_for_checkpoints()

    tr_c = make("b", resume=True)
    assert tr_c.start_epoch == 3 and tr_c.best_ap == 0.375
    assert tr_c.state.mini_step == 1 and tr_c.state._acc is not None
    _assert_states_equal(tr_b.state, tr_c.state)
    for a, c in zip(tr_b.state._acc, tr_c.state._acc):
        assert torch.equal(a, c)
    _run_steps(tr_c, batches[3:])
    _assert_states_equal(tr_a.state, tr_c.state)
    assert tr_a.state.step == tr_c.state.step == 6
    assert tr_c.state.opt_count == 3


def test_resume_without_opt_state_falls_back(tmp_path, caplog):
    """A checkpoint with weights, EMA and counters only resumes with fresh
    optimizer moments and a warning; step 5 lies past the epoch-1
    boundary (3 iterations an epoch) and rewinds to it."""
    tr = _trainer(tmp_path)
    tr.before_train()
    sd = tr.state.state_dict()
    ck.save_checkpoint(str(tmp_path / "tiny_test"), {
        "model": sd["model"], "ema_model": sd["ema_model"], "epoch": 1,
        "step": 5}, "latest")
    tr2 = _trainer(tmp_path, {"resume": True})
    with caplog.at_level(logging.WARNING, logger="unicorn_torch"):
        tr2.logger.propagate = True
        try:
            tr2.before_train()
        finally:
            tr2.logger.propagate = False
    assert "fresh optimizer moments" in caplog.text
    assert tr2.start_epoch == 1 and tr2.state.step == 3
    assert tr2.state.opt_count == 3 and not tr2.state.optimizer.state


def test_async_checkpoint_roundtrip_and_atomic_write(tmp_path, monkeypatch):
    """A non-blocking save equals a blocking one once waited for; saves
    land in issue order; a write that fails leaves the previous file
    whole and raises from wait_for_checkpoints."""
    state = {"model": {"w": torch.arange(12.0).reshape(3, 4)}, "epoch": 3}
    ck.save_checkpoint(str(tmp_path), state, "async_ck", blocking=False)
    state["model"]["w"] += 1  # the copy was taken at the call
    ck.save_checkpoint(str(tmp_path), {"epoch": 4}, "order", blocking=False)
    ck.save_checkpoint(str(tmp_path), {"epoch": 5}, "order", blocking=False)
    ck.wait_for_checkpoints()
    loaded = ck.load_checkpoint(str(tmp_path), "async_ck")
    assert torch.equal(loaded["model"]["w"], torch.arange(12.0).reshape(3, 4))
    assert loaded["epoch"] == 3
    assert ck.load_checkpoint(str(tmp_path), "order")["epoch"] == 5
    assert ck.load_checkpoint(str(tmp_path / "order"))["epoch"] == 5

    def torn(obj, f):
        open(f, "wb").write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", torn)
    ck.save_checkpoint(str(tmp_path), {"epoch": 6}, "order", blocking=False)
    with pytest.raises(OSError):
        ck.wait_for_checkpoints()
    monkeypatch.undo()
    assert ck.load_checkpoint(str(tmp_path), "order")["epoch"] == 5
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(tmp_path), "missing")


def test_load_matching_copies_name_and_shape_matches():
    sd = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    out = ck.load_matching(sd, {"a": torch.ones(2), "b": torch.ones(4),
                                "x": torch.ones(1)})
    assert torch.equal(out["a"], torch.ones(2))
    assert torch.equal(out["b"], torch.zeros(3)) and out["c"] is sd["c"]
    assert set(out) == set(sd)


def test_resume_from_explicit_ckpt_and_start_epoch(tmp_path):
    tr = _trainer(tmp_path / "x")
    tr.before_train()
    tr.epoch = 4
    tr.best_ap = 0.5
    tr.save_ckpt("special")
    ck.wait_for_checkpoints()
    path = str(tmp_path / "x" / "tiny_test" / "special")
    tr2 = _trainer(tmp_path / "y", {"resume": True, "ckpt": path})
    tr2.before_train()
    assert tr2.start_epoch == 5 and tr2.best_ap == 0.5
    tr3 = _trainer(tmp_path / "z", {"resume": True, "ckpt": path,
                                    "start_epoch": 3})
    tr3.before_train()
    assert tr3.start_epoch == 2  # the reference's start_epoch - 1


def test_finetune_ckpt_without_resume_loads_params_only(tmp_path):
    """ckpt without resume: the weights load where name and shape match
    (a detector's 80-class head is skipped), epoch, optimizer and
    counters start fresh."""
    tr = _trainer(tmp_path / "src")
    tr.before_train()
    _run_steps(tr, _fixed_uni_batches(2))
    tr.epoch = 7
    tr.save_ckpt("latest")
    ck.wait_for_checkpoints()
    path = tmp_path / "src" / "tiny_test" / "latest"
    loaded = ck.load_checkpoint(str(path))
    loaded["model"]["head.cls_preds.0.weight"] = torch.zeros(80, 16, 1, 1)
    ck.save_checkpoint(str(path.parent), loaded, "with_det_head")

    tr2 = _trainer(tmp_path / "dst", {"ckpt": str(path.parent /
                                                  "with_det_head")})
    tr2.before_train()
    assert tr2.start_epoch == 0 and tr2.state.step == 0
    assert not tr2.state.optimizer.state
    fresh = _trainer(tmp_path / "fresh")
    fresh.before_train()
    for (n, p), q in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        if n == "head.cls_preds.0.weight":
            assert torch.equal(q, fresh.model.state_dict()[n])
        else:
            assert torch.equal(p, q), n


def test_resume_missing_explicit_ckpt_raises(tmp_path):
    tr = _trainer(tmp_path, {"resume": True,
                             "ckpt": str(tmp_path / "nope" / "latest")})
    with pytest.raises(FileNotFoundError):
        tr.before_train()


def test_resume_keeps_ema_disabled(tmp_path):
    tr = _trainer(tmp_path, ema=False)
    tr.before_train()
    assert tr.state.ema_model is None
    tr.save_ckpt("latest")
    ck.wait_for_checkpoints()
    tr2 = _trainer(tmp_path, {"resume": True}, ema=False)
    tr2.before_train()
    assert tr2.state.ema_model is None


def test_preemption_sigterm_checkpoints_and_stops(tmp_path):
    """SIGTERM mid-epoch: one blocking `latest` at the next step boundary
    holding the unfinished epoch, the loop stops, the handlers come back;
    resume replays that epoch with every counter at its boundary."""
    class PreemptedTrainer(Trainer):
        def _get_step_fn(self, size):
            fn = super()._get_step_fn(size)

            def wrapped(*a):
                out = fn(*a)
                if self.epoch == 0 and self.iter == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            return wrapped

    exp = TinyExp(str(tmp_path))
    exp.max_epoch = 3
    exp.samples_per_epoch = 8
    exp.use_grad_acc = True  # 2: iteration 3 leaves mini_step at 1
    before = signal.getsignal(signal.SIGTERM)
    trainer = PreemptedTrainer(exp, {"batch_size": 2}, device="cpu")
    trainer.train()
    assert trainer._preempted == signal.SIGTERM
    assert trainer.epoch == 0 and trainer.iter == 2
    assert signal.getsignal(signal.SIGTERM) is before

    saved = ck.load_checkpoint(trainer.output_dir, "latest")
    assert saved["epoch"] == 0
    assert (saved["step"], saved["opt_count"], saved["mini_step"]) == (3, 1, 1)

    exp2 = TinyExp(str(tmp_path))
    exp2.samples_per_epoch = 8
    exp2.use_grad_acc = True
    t2 = Trainer(exp2, {"batch_size": 2, "resume": True}, device="cpu")
    t2.before_train()
    assert t2.start_epoch == 0
    st = t2.state
    assert (st.step, st.opt_count, st.mini_step) == (0, 0, 0)
    assert all(float(s["step"]) == 0 for s in st.optimizer.state.values())
    assert all(not a.any() for a in st._acc)
    for n, p in st.model.state_dict().items():
        assert torch.equal(p, saved["model"][n]), n


def test_rewind_opt_counts():
    """The rewind sets opt_count, every AdamW per-parameter step, step,
    mini_step and the accumulator."""
    model = torch.nn.Linear(3, 2)
    state = TrainState.create(model, make_optimizer(lambda c: 1e-3,
                                                    grad_accum=2),
                              device="cpu")
    for _ in range(5):  # 5 micro-steps: 2 updates, mini_step 1
        model(torch.ones(1, 3)).sum().backward()
        state.apply_gradients()
    assert (state.step, state.opt_count, state.mini_step) == (5, 2, 1)
    assert all(float(s["step"]) == 2 for s in state.optimizer.state.values())
    rewind_opt_counts(state, 1, 2)
    assert (state.step, state.opt_count, state.mini_step) == (2, 1, 0)
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert len(steps) == 2 and all(float(s) == 1 for s in steps)
    assert all(s.dtype == torch.float32 for s in steps)
    assert all(not a.any() for a in state._acc)


def test_grad_accum_lr_schedule_in_iteration_units():
    """With accumulation 2, inner update n reads lr_fn(2n): 0, 2, 4."""
    w = torch.nn.Parameter(torch.zeros(1))
    model = torch.nn.Module()
    model.w = w
    state = TrainState.create(model, make_optimizer(
        lambda c: float(c), weight_decay=0.0, grad_accum=2), use_ema=False,
        device="cpu")
    vals = []
    for _ in range(6):
        w.grad = torch.ones(1)
        state.apply_gradients()
        vals.append(float(w.detach()))
    inner = np.diff([0.0] + vals)[1::2]
    np.testing.assert_allclose(-inner, [0.0, 2.0, 4.0], atol=1e-4)


def test_trainer_needs_the_card_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TinyExp(str(tmp_path)), {"batch_size": 2})


def test_eval_skipped_without_evaluator_and_best_ckpt(tmp_path):
    """An exp without an evaluator (get_trainer_evaluator raises
    NotImplementedError): after_epoch skips eval and goes on. With one,
    evaluate gets the EMA model's decoded forward and max_images=1000,
    and a better AP writes `best`."""
    from unicorn_torch.models.heads import decode_for_inference

    tr = _trainer(tmp_path, eval_interval=1)
    tr.before_train()

    def no_evaluator(batch_size=1, device="cuda"):
        raise NotImplementedError("no evaluator")

    tr.exp.get_trainer_evaluator = no_evaluator
    tr.after_epoch()
    ck.wait_for_checkpoints()
    out = tmp_path / "tiny_test"
    assert not (out / "best").exists() and (out / "latest").is_file()

    seen = []
    img = torch.from_numpy(np.random.RandomState(0).rand(
        1, 3, H, W).astype(np.float32) * 255)

    class Evaluator:
        def evaluate(self, forward, max_images=None):
            seen.append((forward(img), max_images))
            return {"AP": 0.25, "AP50": 0.5}

    tr.exp.get_trainer_evaluator = lambda batch_size=1, device="cuda": \
        Evaluator()
    tr.after_epoch()
    ck.wait_for_checkpoints()
    with torch.no_grad():
        want = decode_for_inference(tr.state.ema_model.eval()(img)[0],
                                    (8, 16, 32))
    (dec, max_images), = seen
    assert max_images == 1000 and torch.equal(dec, want)
    assert tr.best_ap == 0.25
    assert ck.load_checkpoint(str(out), "best")["best_ap"] == 0.25
    tr.loader.stop()


def test_debug_only_and_on_disk_data_raise(tmp_path, monkeypatch):
    """debug_only draws the first uni batch to <output_dir>/debug_data (one
    PNG a frame) and stops before any step; the on-disk mixes under a data
    root that holds none of their datasets raise FileNotFoundError naming
    the root (each dataset skipped with a warning first), detection's
    mosaic loader among them."""
    from unicorn_torch.exp.det import ExpDet

    tr = _trainer(tmp_path, debug_only=True)
    tr.train()
    assert tr.state.step == 0 and tr.iter == 0
    out = os.path.join(tr.output_dir, "debug_data")
    names = sorted(os.listdir(out))
    assert [n[:len("batch_b0_f0_task")] for n in names] == [
        f"batch_b{b}_f{f}_task" for b in (0, 1) for f in (0, 1)]
    assert {n[len("batch_b0_f0_task"):] for n in names} <= {"0.png", "1.png"}
    assert not os.path.exists(os.path.join(tr.output_dir, "latest"))
    monkeypatch.setenv("UNICORN_DATADIR", str(tmp_path / "none"))
    exp = ExpTrack()
    with pytest.raises(FileNotFoundError, match="none"):
        exp.get_dataset()
    exp.sot_only = True  # the ablation drops the MOT group, specs unread
    plus = exp.get_dataset(sot_datasets=[FakeSOT()])
    assert plus.mot_dataset is None and plus.sot_dataset is not None
    with pytest.raises(FileNotFoundError, match="none"):
        ExpDetMask().get_data_loader(2)
    with pytest.raises(FileNotFoundError, match="none"):
        ExpDet().get_data_loader(2)


def test_build_group_skips_missing_and_empty(caplog):
    def missing():
        raise FileNotFoundError("no such dir")

    def broken():
        raise ValueError("bad json")

    ds, w = ExpTrack._build_group([("A", 2, missing), ("B", 3, lambda: []),
                                   ("C", 5, lambda: [1, 2])])
    assert ds == [[1, 2]] and w == [5]
    assert ExpTrack._build_group([("A", 2, missing)]) == ([], None)
    with pytest.raises(ValueError):
        ExpTrack._build_group([("D", 1, broken)])


# ---------------------------------------------------------------- vs JAX
def _jax_tiny_exp(out_dir):
    from unicorn_tpu.exp.track import ExpTrack as JExpTrack

    exp = JExpTrack()
    _tiny_fields(exp, out_dir)
    return exp


def test_trainer_matches_jax_trainer(tmp_path):
    """JAX's uni step, built as JAX's Trainer.before_train builds it (the
    exp's get_optimizer and get_train_step, TrainState.create with EMA),
    and the port's Trainer from the same weights (the port's seeded init
    through convert.to_flax) on the same three batches: the loss dicts
    agree at rtol 1e-4, atol 1e-6; the port's logged record carries the
    same keys (test_trainer_end_to_end: the records carry the step's)."""
    import jax
    import jax.numpy as jnp

    from unicorn_tpu.core.train_state import TrainState as JTrainState

    tr = _trainer(tmp_path / "port")
    tr.before_train()
    jexp = _jax_tiny_exp(str(tmp_path / "jax"))
    params = jax.tree_util.tree_map(
        jnp.asarray, {"params": to_flax(tr.state.model.state_dict())})
    jstate = JTrainState.create(
        params, jexp.get_optimizer(tr.batch_size, tr.iters_per_epoch),
        use_ema=jexp.ema)
    jstep = jexp.get_train_step(tr.batch_size)
    batches = _fixed_uni_batches(3)
    jdicts = []
    for b in batches:
        jstate, d = jstep(jstate, *map(jnp.asarray, b))
        jdicts.append({k: float(v) for k, v in d.items()})

    pdicts = _run_steps(tr, batches)
    for t, (jd, pd) in enumerate(zip(jdicts, pdicts)):
        assert set(jd) == set(pd)
        for k in jd:
            np.testing.assert_allclose(pd[k], jd[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {t} {k}")


def _det_state_dict(num_classes):
    from unicorn_torch.models.unicorn import YOLOXDet

    exp = ExpDetMask()
    for k, v in TINY.items():
        setattr(exp, k, v)
    exp.num_classes = num_classes
    det = YOLOXDet(**exp._model_fields(), use_mask=True,
                   generator=torch.Generator().manual_seed(5))
    return exp, {k: v + 1.0 for k, v in det.state_dict().items()}


def test_track_load_pretrained_matches_jax(tmp_path, monkeypatch):
    """ExpTrack's detector -> tracker surgery on the same 80-class
    detector weights: the port's result equals JAX's through from_flax,
    the cls_preds gathered [0, 0, 2, 7, 5, 6, 3, 1], the *_sot branches
    duplicated from obj_preds / reg_preds."""
    from unicorn_tpu.core.checkpoint import save_checkpoint as jsave
    from unicorn_tpu.exp.track import ExpTrack as JExpTrack

    _, det = _det_state_dict(80)
    det = {k: v for k, v in det.items()
           if "controllers" not in k and "mask_branch" not in k}
    exp = TinyExp(str(tmp_path))
    exp.pretrain_name = "det_tiny"
    uni = exp.get_model(torch.Generator().manual_seed(1)).state_dict()
    monkeypatch.chdir(tmp_path)
    ck.save_checkpoint(str(tmp_path / "Unicorn_outputs" / "det_tiny"),
                       {"model": det, "ema_model": det})
    jsave(str(tmp_path / "Unicorn_outputs" / "det_tiny_jax"),
          {"params": to_flax(det)}, "latest")
    jexp = JExpTrack()
    jexp.pretrain_name = "det_tiny_jax"

    out = exp.load_pretrained(uni)
    ref = from_flax(jexp.load_pretrained(to_flax(uni)))
    assert set(out) == set(ref) == set(uni)
    for k in uni:
        assert torch.equal(out[k].float(), ref[k]), k
    g = [0, 0, 2, 7, 5, 6, 3, 1]
    for lv in range(3):
        w = f"head.cls_preds.{lv}.weight"
        assert torch.equal(out[w], det[w][g])
        for src in ("obj_preds", "reg_preds"):
            name = f"head.{src}_sot.{lv}.weight"
            assert torch.equal(out[name], det[f"head.{src}.{lv}.weight"])
    assert torch.equal(out["backbone.backbone.stem.conv.conv.weight"],
                       det["backbone.backbone.stem.conv.conv.weight"])


def test_det_mask_load_pretrained_matches_jax(tmp_path, monkeypatch):
    """ExpDetMask copies every name- and shape-matching tensor of the
    detector checkpoint's EMA weights; its CondInst branch stays at init
    where the shapes differ. Equal to JAX's on the same tensors."""
    from unicorn_tpu.core.checkpoint import save_checkpoint as jsave
    from unicorn_tpu.exp.det_mask import ExpDetMask as JExpDetMask

    exp, det = _det_state_dict(2)
    exp.pretrain_name = "det_mask_tiny"
    own = exp.get_model(torch.Generator().manual_seed(1)).state_dict()
    bad = dict(det, **{"head.controllers.0.weight": torch.zeros(3, 3)})
    ema = {k: v * 2 for k, v in det.items()}
    monkeypatch.chdir(tmp_path)
    ck.save_checkpoint(str(tmp_path / "Unicorn_outputs" / "det_mask_tiny"),
                       {"model": bad, "ema_model": dict(
                           ema, **{"head.controllers.0.weight":
                                   torch.zeros(3, 3)})})
    out = exp.load_pretrained(own)
    for k in own:
        want = own[k] if k == "head.controllers.0.weight" else ema[k]
        assert torch.equal(out[k], want), k

    # JAX's on the same tensors, the mismatched one left out (to_flax
    # names flax layouts, which a (3, 3) tensor has none of)
    del ema["head.controllers.0.weight"]
    jsave(str(tmp_path / "Unicorn_outputs" / "det_mask_tiny_jax"),
          {"params": to_flax(det), "ema_params": to_flax(ema)}, "latest")
    jexp = JExpDetMask()
    jexp.pretrain_name = "det_mask_tiny_jax"
    ref = from_flax(jexp.load_pretrained(to_flax(own)))
    for k in own:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("which", ["track", "track_mask", "det_mask"])
def test_exp_trainer_fields_match_jax(which):
    """The fields the trainer and the loaders read equal JAX's defaults."""
    import importlib

    names = ["exp_name", "output_dir", "seed", "max_epoch", "no_aug_epochs",
             "print_interval", "eval_interval", "multiscale_range",
             "max_labels", "flip_prob", "hsv_prob", "data_num_workers",
             "pretrain_name", "debug_only", "ema", "always_l1", "task",
             "input_size"]
    if which != "det_mask":
        names += ["samples_per_epoch", "alter_step", "train_mode", "sot_only",
                  "mot_only", "mot_test_name"]
    cls = {"track": "ExpTrack", "track_mask": "ExpTrackMask",
           "det_mask": "ExpDetMask"}[which]
    mine = getattr(importlib.import_module(f"unicorn_torch.exp.{which}"),
                   cls)()
    ref = getattr(importlib.import_module(f"unicorn_tpu.exp.{which}"), cls)()
    for n in names:
        assert getattr(mine, n) == getattr(ref, n), n
