"""The evaluators through models, the Trainer's in-training eval, the eval
tool and the exps' evaluator factories, on the CPU.

  * COCOEvaluator on the JAX tests' tiny Unicorn (CSPDarknet depth 0.33,
    width 0.5, the "conv" interaction, fp32, 72x100 images letterboxed to
    64x96), the port's seeded weights carried to JAX by
    unicorn_torch.convert.to_flax: the port's result list against JAX's
    (COCOEvaluator with its jitted decode forward) as seeded, and with the
    obj / cls biases raised by 6 so that detections exist; boxes within
    1e-4 of the image size, scores within 1e-5, the metrics within the
    same bounds.
  * Trainer.train on the tiny track exp with eval_interval 1 over a
    two-image COCO-format val set: the eval record in metrics.jsonl,
    `best`, max_images=1000 passed; an eval leaves every module's mode as
    it found it, and the next step's loss equals the loss without the
    eval; a failure inside the evaluation propagates.
  * unicorn_torch.tools.eval.main on that set with --device cpu, without
    and with a checkpoint, and on the inst exp.
  * For each of the 18 exps, get_evaluator and get_trainer_evaluator give
    JAX's evaluator class with JAX's thresholds.
"""
import ast
import glob
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import test_torch_port_trainer as trainer_cases
from unicorn_torch.convert import to_flax
from unicorn_torch.core import checkpoint as ck
from unicorn_torch.core.trainer import Trainer
from unicorn_torch.data import transforms as ttr
from unicorn_torch.data.datasets import coco as tcoco_ds
from unicorn_torch.evaluators import coco_evaluator as tcoco
from unicorn_torch.exp import base as tbase
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.tools import eval as teval
from unicorn_tpu.data import transforms as jtr
from unicorn_tpu.data.datasets import coco as jcoco_ds
from unicorn_tpu.evaluators import coco_evaluator as jcoco
from unicorn_tpu.evaluators import coco_map as jmap
from unicorn_tpu.exp import base as jbase
from unicorn_tpu.models.heads import decode_for_inference as j_decode
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

HW, TEST = (72, 100), (64, 96)
CFG = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
           width=0.5, in_channels=(256, 512, 1024), n_layer_att=0,
           use_attention=False, interact_mode="conv")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def write_val_set(root, n=2, hw=HW, json_name="val.json", name="val",
                  masks=False):
    """A COCO-format val set of n seeded images with boxes of 8 to 40 px,
    on the strides' grid (so that a random detector's boxes can match)."""
    from unicorn_torch.evaluators import rle

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, name), exist_ok=True)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(n):
        fname = f"{i:04d}.jpg"
        cv2.imwrite(os.path.join(root, name, fname),
                    (rng.rand(*hw, 3) * 255).astype(np.uint8))
        images.append({"id": i + 1, "file_name": fname, "height": hw[0],
                       "width": hw[1], "frame_id": i + 1, "video_id": 1})
        for s in (8, 16, 32):
            for _ in range(3):
                x = int(rng.randint(0, (hw[1] - s) // s)) * s
                y = int(rng.randint(0, (hw[0] - s) // s)) * s
                a = {"id": len(anns) + 1, "image_id": i + 1,
                     "category_id": 1, "bbox": [x, y, s, s],
                     "area": s * s, "iscrowd": 0}
                if masks:
                    m = np.zeros(hw, np.uint8)
                    m[y:y + s, x:x + s] = 1
                    a["segmentation"] = rle.encode(m)
                anns.append(a)
    with open(os.path.join(root, "annotations", json_name), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "pedestrian"}]}, f)
    return root


def raise_priors(model, classes=None):
    """The obj and cls prediction biases (of `classes` only, when given)
    raised by 6, so that the random detector's scores clear the test
    threshold."""
    with torch.no_grad():
        for name, p in model.head.named_parameters():
            if not name.endswith(".bias"):
                continue
            if name.startswith("obj_preds."):
                p.add_(6.0)
            elif name.startswith("cls_preds."):
                p[slice(None) if classes is None else classes] += 6.0


class _Recorder:
    def __init__(self, base, store):
        self.base, self.store = base, store

    def __call__(self, gt, iou_type="bbox"):
        inner = self.base(gt, iou_type)
        store = self.store

        class Rec:
            def evaluate(self, detections, img_ids=None):
                store.extend(dict(d) for d in detections)
                return inner.evaluate(detections, img_ids)
        return Rec()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(1)
    root = write_val_set(str(tmp_path_factory.mktemp("coco")), n=3)
    tm = TUnicorn(**CFG, generator=torch.Generator().manual_seed(0)).eval()
    jm = JUnicorn(**CFG)

    @jax.jit
    def j_forward(params, images):
        raw = jm.apply(params, images)
        if isinstance(raw, tuple):
            raw = raw[0]
        return j_decode(raw, (8, 16, 32), mode="mot")
    return root, tm, j_forward


@pytest.mark.parametrize("raised", [False, True])
def test_coco_evaluator_through_the_tiny_model_matches_jax(tiny, raised,
                                                           monkeypatch):
    root, tm, j_forward = tiny
    if raised:
        tm = TUnicorn(**CFG, generator=torch.Generator().manual_seed(0))
        raise_priors(tm.eval())
    params = {"params": to_flax(tm.state_dict())}
    got, want = [], []
    monkeypatch.setattr(tcoco, "COCOMeanAP", _Recorder(tcoco.COCOMeanAP, got))
    monkeypatch.setattr(jmap, "COCOMeanAP", _Recorder(jmap.COCOMeanAP, want))
    kw = dict(conf_thre=0.01, nms_thre=0.65, num_classes=1, batch_size=2)
    tds = tcoco_ds.COCODataset(root, "val.json", "val", img_size=TEST,
                               preproc=ttr.ValTransform())
    jds = jcoco_ds.COCODataset(root, "val.json", "val", img_size=TEST,
                               preproc=jtr.ValTransform())
    mt = tcoco.COCOEvaluator(tds, TEST, device="cpu", **kw).evaluate(
        tcoco.decode_forward(tm))
    mj = jcoco.COCOEvaluator(jds, TEST, **kw).evaluate(j_forward, params)
    assert len(got) == len(want)
    assert (len(got) > 100) == raised
    scale = max(HW)
    for a, b in zip(got, want):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-4 * scale)
        assert abs(a["score"] - b["score"]) <= 1e-5
    for k in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR"):
        assert abs(mt[k] - mj[k]) <= 1e-4, k
    assert mt["n_images"] == mj["n_images"] == 3
    if raised:
        assert mt["AP50"] > 0


# ------------------------------------------------------------ the Trainer
class EvalExp(trainer_cases.TinyExp):
    """The tiny track exp, its in-training eval over a COCO-format val set
    at 64x64 (the model's obj and class-0 biases raised, so that its boxes
    score)."""

    def __init__(self, out_dir, val_dir):
        super().__init__(out_dir)
        self.test_data_dir = val_dir
        self.test_ann, self.test_name = "val.json", "val"
        self.test_size = (64, 64)
        self.eval_interval = 1
        self.samples_per_epoch = 2
        self.seen_max_images = []

    def get_model(self, generator=None, serve=False, msda_method="auto"):
        model = super().get_model(generator, serve, msda_method)
        raise_priors(model, classes=[0])   # the val set's one category
        return model

    def get_trainer_evaluator(self, batch_size=1, device="cuda"):
        ev = super().get_trainer_evaluator(batch_size, device)
        evaluate, seen = ev.evaluate, self.seen_max_images

        def recording(forward, max_images=None):
            seen.append(max_images)
            return evaluate(forward, max_images=max_images)
        ev.evaluate = recording
        return ev


def test_trainer_evaluates_and_writes_best(tmp_path):
    val = write_val_set(str(tmp_path / "val"), hw=(64, 64))
    exp = EvalExp(str(tmp_path / "out"), val)
    tr = Trainer(exp, {"batch_size": 2}, device="cpu")
    tr.train()
    out = tmp_path / "out" / "tiny_test"
    records = [json.loads(x) for x in open(out / "metrics.jsonl")]
    ev = [r for r in records if r.get("eval")]
    assert len(ev) == 1 and ev[0]["n_images"] == 2 and ev[0]["epoch"] == 0
    assert {"AP", "AP50", "AR", "infer_time_s"} <= set(ev[0])
    assert exp.seen_max_images == [1000]
    assert ev[0]["AP"] > 0 and (out / "best").is_file()
    assert ck.load_checkpoint(str(out), "best")["best_ap"] == ev[0]["AP"]
    assert all(m.training for m in tr.state.model.modules())


def test_eval_leaves_modes_and_next_loss_unchanged(tmp_path):
    """Without EMA the trained model itself is evaluated: after the eval
    every module is back in train mode, no tensor is an inference tensor,
    and the next step's loss equals the loss of a twin trainer that did
    not evaluate."""
    val = write_val_set(str(tmp_path / "val"), hw=(64, 64))
    trainers = []
    for k in range(2):
        exp = EvalExp(str(tmp_path / f"out{k}"), val)
        exp.ema = False
        tr = Trainer(exp, {"batch_size": 2}, device="cpu")
        tr.before_train()
        tr.loader.stop()
        trainers.append(tr)
    batch = trainer_cases._fixed_uni_batches(1)
    first = [trainer_cases._run_steps(tr, batch)[0] for tr in trainers]
    assert first[0] == first[1]
    model = trainers[0].state.model
    model.head.eval()      # a mixed state, to be restored as found
    trainers[0].evaluate_and_save_best()
    assert not any(m.training for m in model.head.modules())
    assert all(m.training for m in model.backbone.modules())
    model.head.train()
    assert not any(p.is_inference() for p in model.parameters())
    assert not any(b.is_inference() for b in model.buffers())
    second = [trainer_cases._run_steps(tr, batch)[0] for tr in trainers]
    assert second[0] == second[1]


def test_eval_failure_propagates_and_no_evaluator_skips(tmp_path):
    """Only get_trainer_evaluator's NotImplementedError skips the eval; one
    raised inside the evaluation (a reader refusing a file) propagates."""
    val = write_val_set(str(tmp_path / "val"), hw=(64, 64))
    exp = EvalExp(str(tmp_path / "out"), val)
    tr = Trainer(exp, {"batch_size": 2}, device="cpu")
    tr.before_train()
    tr.loader.stop()

    def refuse(*a, **k):
        raise NotImplementedError("interlaced PNG is not supported")

    tr.exp.get_trainer_evaluator = refuse
    tr.after_epoch()                          # skipped
    ck.wait_for_checkpoints()
    assert not (tmp_path / "out" / "tiny_test" / "best").exists()

    class Refusing:
        def evaluate(self, forward, max_images=None):
            raise NotImplementedError("interlaced PNG is not supported")

    tr.exp.get_trainer_evaluator = lambda batch_size=1, device="cuda": \
        Refusing()
    with pytest.raises(NotImplementedError, match="interlaced"):
        tr.after_epoch()
    ck.wait_for_checkpoints()


# ---------------------------------------------------------- tools/eval.py
TOOL_EXP = '''
from unicorn_torch.exp.{mod} import {cls}


class Exp({cls}):
    def __init__(self):
        super().__init__()
        self.backbone_name = "csp_darknet"
        self.depth, self.width = 0.33, 0.25
        self.in_channels = [256, 512, 1024]
        self.use_attention, self.n_layer_att, self.bf16 = False, 0, False
        self.num_classes = 1
        self.test_size = (64, 64)
        self.data_dir = {root!r}
        self.val_ann, self.val_name = "val.json", "val"
'''


@pytest.mark.parametrize("mod,cls", [("det", "ExpDet"),
                                     ("det_mask", "ExpDetMask")])
def test_eval_tool_runs_on_the_cpu(tmp_path, capsys, mod, cls):
    root = write_val_set(str(tmp_path / "coco"), hw=(64, 64),
                         masks=cls == "ExpDetMask")
    f = tmp_path / "exp_tool.py"
    f.write_text(TOOL_EXP.format(mod=mod, cls=cls, root=root))
    m0 = teval.main(["-f", str(f), "--device", "cpu", "-b", "2",
                     "--conf", "0.001"])
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[
        -1])
    assert printed.keys() == m0.keys() and m0["n_images"] == 2
    if cls == "ExpDetMask":
        assert {"box_AP", "mask_AP"} <= set(m0)
        return
    # a checkpoint's EMA weights (here the seeded init with raised biases)
    exp = tbase.get_exp(str(f))
    model = exp.get_model(torch.Generator().manual_seed(0))
    raise_priors(model)
    ck.save_checkpoint(str(tmp_path / "ck"), {"model": {},
                                              "ema_model": model.state_dict()},
                       "best")
    m1 = teval.main(["-f", str(f), "--device", "cpu", "-c",
                     str(tmp_path / "ck" / "best"), "--max-images", "1",
                     "nmsthre", "0.5"])
    assert m1["n_images"] == 1 and m1["AR"] != m0["AR"]


# ------------------------------------------------------------------ exps
NAMES = sorted(os.path.basename(f)[:-3] for f in glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "exps",
    "default", "*.py")))


def _fields(ev):
    return {k: v for k, v in vars(ev).items()
            if k not in ("dataset", "device", "mesh", "exp")}


def test_exps_evaluators_match_jax(tmp_path, monkeypatch):
    for sub, ann, name in (("coco", "instances_val2017.json", "val2017"),
                           ("mot", "test.json", "test")):
        write_val_set(str(tmp_path / sub), n=1, json_name=ann, name=name)
    monkeypatch.setenv("UNICORN_DATADIR", str(tmp_path))
    assert len(NAMES) == 18
    for n in NAMES:
        t, j = tbase.get_exp(exp_name=n), jbase.get_exp(exp_name=n)
        for tev, jev in ((t.get_evaluator(batch_size=2, device="cpu"),
                          j.get_evaluator(batch_size=2)),
                         (t.get_trainer_evaluator(2, device="cpu"),
                          j.get_trainer_evaluator(2))):
            assert type(tev).__name__ == type(jev).__name__, n
            assert _fields(tev) == _fields(jev), n
            if hasattr(jev, "dataset") and jev.dataset is not None:
                assert tev.dataset.json_file == jev.dataset.json_file
                assert tev.dataset.img_size == jev.dataset.img_size
            assert tev.device.type == "cpu"


# ------------------------------------------ callables built from drivers
UNI_MASK = dict(CFG, width=0.25, use_mask=True)


class RandomFrames:
    """Two videos of 4 letterboxed 64x64 frames of a panning texture, as
    MOTEvalDataset gives them through ValTransform."""

    img_size = (64, 64)

    def __init__(self):
        rng = np.random.RandomState(3)
        self.base = (rng.rand(64, 76, 3) * 255).round().astype(np.float32)

    def __len__(self):
        return 8

    def __getitem__(self, i):
        v, t = divmod(i, 4)
        img = np.ascontiguousarray(self.base[:, 3 * t:3 * t + 64])
        return (img, np.zeros((0, 5), np.float32),
                (64, 64, t + 1, v, f"vid{v}/{t + 1:06d}.jpg"), np.array([i]))


def test_driver_built_callables_run_the_mot_evaluator():
    """mot_step_fn(MOTDriver) and omni_fns(MOTOmniDriver) return what the
    drivers' stages return, and drive MOTEvaluator's three paths."""
    from unicorn_torch.device import images_to_device
    from unicorn_torch.drivers.mot import MOTDriver, MOTOmniDriver
    from unicorn_torch.evaluators import mot_evaluator as tmot

    tm = TUnicorn(**UNI_MASK, generator=torch.Generator().manual_seed(2))
    raise_priors(tm.eval())
    frames = RandomFrames()
    x = images_to_device(frames[0][0][None], torch.device("cpu"))
    drv = MOTDriver(tm, input_size=(64, 64), num_classes=1, device="cpu")
    step = tmot.mot_step_fn(drv)
    with torch.inference_mode():
        dets, valid = step(x)
        d_ref, v_ref = drv.postprocess(drv.forward(x))
    assert torch.equal(dets, d_ref[0]) and torch.equal(valid, v_ref[0])
    assert int(valid.sum()) > 0
    ev = tmot.MOTEvaluator(dataset=frames, min_box_area=1, device="cpu")
    res = ev.evaluate(step)
    assert set(res) == {"vid0", "vid1"} and sum(len(f[1]) for f in
                                                res["vid1"]) > 0

    qd = dict(init_score_thr=0.5, obj_score_thr=0.3)
    kw = dict(num_classes=1, conf_thre=0.3, qd_params=qd, device="cpu")
    omni = MOTOmniDriver(tm, (64, 64), with_mask=True, **kw)
    whole, embed = tmot.omni_fns(omni)
    with torch.inference_mode():
        d, v, feat, masks = whole(x)
        fpn, feat_ref = omni.backbone(x)
        flat, d_ref, v_ref, idx = omni.detect(omni.head(fpn))
        assert torch.equal(d, d_ref[0]) and torch.equal(v, v_ref[0])
        assert torch.equal(feat, feat_ref)
        assert torch.equal(masks, omni.mask_decode(fpn, flat, idx))
        centers = (d[v, :2] + d[v, 2:4]) / 2
        np.testing.assert_array_equal(
            embed(feat, feat, centers).numpy(),
            omni.embed(feat, feat, d_ref)[v].numpy())
    res = ev.evaluate_omni(*tmot.omni_fns(
        MOTOmniDriver(tm, (64, 64), **kw)), qd_params=qd)
    assert sum(len(f[1]) for f in res["vid0"]) > 0
    res = ev.evaluate_omni_mots(whole, embed, dataset=frames, qd_params=qd)
    rles = [r for f in res["vid1"] for r in f[4]]
    assert rles and all(r["size"] == [64, 64] for r in rles)
