"""MOT / MOTS evaluation with embedding association (the port's
tools/track_omni.py; the reference's tools/track_omni.py).

  python -m unicorn_torch.tools.track_omni -n unicorn_track_tiny \
      [-c ckpt] [--tracker qd|deepsort] [--result-dir track_omni_results]
  python -m unicorn_torch.tools.track_omni -n unicorn_track_tiny_mask \
      --mots [--score-gt <dir of MOTS-Challenge gt txts>]
  python -m unicorn_torch.tools.track_omni -n unicorn_track_tiny_mask \
      --dataset bdd [--mots] [--device cpu] [key value ...]

MOTOmniDriver on the exp's served model (the interaction in bf16 where the
exp sets serve_interact_bf16) with QDTrack or DeepSORT on the model's
embeddings. --dataset motchallenge (default) reads the COCO-format video
test set under <$UNICORN_DATADIR>/mot and writes one MOT txt a video; with
--mots, one MOTS-Challenge txt a video (class 2, ids 2000 + track, masks
merged overlap-free in ascending id order and resized to the frame), and
with --score-gt the sMOTSA / MOTSA / IDF1 against the gt txts there
(mots_scores.json). --dataset bdd reads BDD100K under
<$UNICORN_DATADIR>/bdd100k and writes the scalabel results and
scores.json (MOT: mMOTA, mIDF1) or, with --mots, the seg_track bitmasks
and seg_scores.json (mMOTSA, mIDF1). -f / -n / -c as tools/eval.py.
"""
import argparse
import json
import os
from collections import defaultdict

import numpy as np

from ..data.datasets.bdd import BDDEvalDataset
from ..data.datasets.mot import MOTEvalDataset
from ..drivers.mot import MOTOmniDriver
from ..evaluators.bdd_evaluator import (BDDEvaluator, score_scalabel,
                                        score_scalabel_seg)
from ..evaluators.mot_evaluator import merge_mots_masks, write_mot_results
from ..evaluators.mots_metrics import score_mots_txt, write_mots_txt
from ..exp.base import get_exp
from ..exp.det import get_unicorn_datadir
from .common import load_model


def make_parser():
    p = argparse.ArgumentParser("unicorn_torch track_omni (QDTrack)")
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("--mots", action="store_true")
    p.add_argument("--dataset", default="motchallenge",
                   choices=["motchallenge", "bdd"],
                   help="eval set: MOT17-style COCO json or BDD100K scalabel")
    p.add_argument("--mask_thres", type=float, default=0.3)
    p.add_argument("--tracker", default="qd", choices=["qd", "deepsort"],
                   help="association: qd (QDTrack, default) or the legacy "
                        "DeepSORT baseline on the same embeddings")
    p.add_argument("--result-dir", default="track_omni_results")
    p.add_argument("--score-gt", default=None,
                   help="dir of MOTS-Challenge gt txts ({video}.txt); with "
                        "--mots, scores sMOTSA/MOTSA/IDF1 after writing")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def _bdd(exp, driver, args):
    dataset = BDDEvalDataset(
        data_dir=os.path.join(get_unicorn_datadir(), "bdd100k"),
        split=exp.test_name if exp.test_name != "test" else "val",
        img_size=exp.test_size)
    evaluator = BDDEvaluator(dataset, exp.test_size, conf_thre=exp.test_conf,
                             nms_thre=exp.nmsthre, device=args.device)
    os.makedirs(args.result_dir, exist_ok=True)
    gt = dataset.gt_frames()
    if args.max_frames is not None:
        gt = gt[:args.max_frames]
    if args.mots:
        # BDD seg_track: bitmask PNGs + seg_track.json, mask-IoU mMOTSA
        # when the gt labels carry RLEs (the seg_track_20 split)
        _, pred_frames = evaluator.evaluate_seg_mot(
            driver, out_dir=args.result_dir, max_frames=args.max_frames,
            mask_thres=args.mask_thres)
        scores = score_scalabel_seg(pred_frames, gt)
        name = "seg_scores.json"
        line = (f"BDD seg_track: mMOTSA={scores['mMOTSA']:.4f} "
                f"mIDF1={scores['mIDF1']:.4f}")
    else:
        _, pred_frames = evaluator.evaluate_mot(
            driver, out_dir=args.result_dir, max_frames=args.max_frames)
        scores = score_scalabel(pred_frames, gt)
        name = "scores.json"
        line = (f"BDD {args.dataset}: mMOTA={scores['mMOTA']:.4f} "
                f"mIDF1={scores['mIDF1']:.4f}")
    with open(os.path.join(args.result_dir, name), "w") as f:
        json.dump(scores, f, default=float, indent=1)
    print(f"{line} over {len(scores['per_class'])} classes")
    return scores


def main(argv=None):
    """Returns {video: [(frame_id, ids, tlwhs, scores)]} (MOT17-style sets)
    or the BDD scores."""
    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    model = load_model(exp, args.ckpt, serve=True)
    driver = MOTOmniDriver(model, exp.test_size, num_classes=exp.num_classes,
                           conf_thre=exp.test_conf, nms_thre=exp.nmsthre,
                           with_mask=args.mots, tracker=args.tracker,
                           device=args.device)
    if args.dataset == "bdd":
        return _bdd(exp, driver, args)

    dataset = MOTEvalDataset(
        data_dir=os.path.join(get_unicorn_datadir(), "mot"),
        json_file=exp.test_ann, name=exp.test_name, img_size=exp.test_size)
    results = defaultdict(list)
    mots_frames = defaultdict(list)
    cur_video = None
    n = len(dataset) if args.max_frames is None else min(args.max_frames,
                                                          len(dataset))
    for i in range(n):
        img, _, info, _ = dataset.pull_item(i)
        h, w, frame_id, video_id, file_name = info
        video = file_name.split("/")[0]
        if video != cur_video:
            cur_video = video
            driver.reset()
        if args.mots:
            bboxes, labels, ids, masks = driver.update(img)
            out_ids, _, out_scores, tlwhs, rles = merge_mots_masks(
                ids, labels,
                bboxes[:, 4] if len(bboxes) else np.zeros((0,)), bboxes,
                masks, args.mask_thres, driver.last_scale, (h, w),
                exp.test_size)
            results[video].append((frame_id, out_ids, tlwhs, out_scores))
            # MOTS-Challenge encoding: pedestrians are class 2, object id =
            # 2000 + track (the reference's mot_evaluator.py:890+)
            mots_frames[video].append(
                (frame_id, [2000 + int(t) for t in out_ids],
                 [2] * len(out_ids), rles))
        else:
            bboxes, labels, ids = driver.update(img)
            tlwhs = [(b[0], b[1], b[2] - b[0], b[3] - b[1]) for b in bboxes]
            results[video].append(
                (frame_id, ids.tolist(), tlwhs,
                 bboxes[:, 4].tolist() if len(bboxes) else []))
    os.makedirs(args.result_dir, exist_ok=True)
    if not args.mots:
        for video, res in results.items():
            write_mot_results(os.path.join(args.result_dir, f"{video}.txt"),
                              res)
        print(f"wrote {len(results)} videos to {args.result_dir}")
        return dict(results)
    for video, frames in mots_frames.items():
        write_mots_txt(os.path.join(args.result_dir, f"{video}.txt"), frames)
    print(f"wrote {len(mots_frames)} MOTS-Challenge txt videos to "
          f"{args.result_dir}")
    if args.score_gt:
        # gt txts named {video}.txt: the mask-IoU CLEAR-MOT scoring the
        # reference leaves to the MOTChallenge devkit
        gt_txts = {v: os.path.join(args.score_gt, f"{v}.txt")
                   for v in mots_frames
                   if os.path.exists(os.path.join(args.score_gt, f"{v}.txt"))}
        scores = score_mots_txt(args.result_dir, gt_txts, class_id=2)
        with open(os.path.join(args.result_dir, "mots_scores.json"), "w") as f:
            json.dump(scores, f, default=float, indent=1)
        print(f"MOTS: sMOTSA={scores['sMOTSA']:.4f} "
              f"MOTSA={scores['MOTSA']:.4f} IDF1={scores['IDF1']:.4f} "
              f"over {len(gt_txts)} videos")
    return dict(results)


if __name__ == "__main__":
    main()
