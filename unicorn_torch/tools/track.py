"""MOT17-style ByteTrack evaluation (the port's tools/track.py; the
reference's tools/track.py).

  python -m unicorn_torch.tools.track -n unicorn_track_tiny \
      -c Unicorn_outputs/unicorn_track_tiny/best [--fused --chunk 32] \
      [--tracker byte|sort] [--result-dir track_results] [--device cpu]

Runs the model over the exp's COCO-format video test set
(<$UNICORN_DATADIR>/mot/annotations/<test_ann>, frames under
mot/<test_name>/), each frame letterboxed to test_size by ValTransform,
and writes one MOT txt a video ({video}.txt, boxes divided back by the
letterbox scale). The host path is MOTEvaluator.evaluate over MOTDriver
(forward, decode and NMS on the card, the host ByteTracker or, with
--tracker sort, SORT); --fused runs StreamingMOTPipeline: chunks of
--chunk frames, NMS and ByteTrack on the card, the last chunk of a video
padded by repeating its last frame. Prints MOTEvaluator.score where the
set has ground truth. -f / -n / -c as tools/eval.py.
"""
import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from ..data.datasets.mot import MOTEvalDataset
from ..data.transforms import ValTransform
from ..device import resolve_device, to_host
from ..drivers.mot import MOTDriver
from ..drivers.stream import StreamingMOTPipeline
from ..evaluators.mot_evaluator import (MOTEvaluator, mot_step_fn,
                                        write_mot_results)
from ..exp.base import get_exp
from ..exp.det import get_unicorn_datadir
from .common import load_model


def make_parser():
    p = argparse.ArgumentParser("unicorn_torch track (MOT17 ByteTrack)")
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("--result-dir", default="track_results")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--track-thresh", type=float, default=0.6)
    p.add_argument("--match-thresh", type=float, default=0.9)
    p.add_argument("--track-buffer", type=int, default=30)
    p.add_argument("--tracker", default="byte", choices=["byte", "sort"],
                   help="association: byte (default) or the legacy SORT "
                        "baseline. Ignored with --fused (ByteTrack on the "
                        "card).")
    p.add_argument("--chunk", type=int, default=32,
                   help="frames per run_chunk call in --fused mode")
    p.add_argument("--fused", action="store_true",
                   help="the streaming pipeline: NMS and ByteTrack on the "
                        "card, chunks of --chunk frames. Honours "
                        "--track-thresh / --match-thresh / --track-buffer "
                        "globally; the host path also applies the "
                        "reference's per-MOT17-video overrides.")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def load_gt_from_dataset(dataset):
    """{video: [(frame_id, ids, tlwhs, ignore_tlwhs)]} from the eval
    dataset's json; ignore / iscrowd annotations are the MOT ignore
    regions, which MOTEvaluator.score suppresses predictions on."""
    gts = defaultdict(lambda: defaultdict(lambda: ([], [], [])))
    for img_id in dataset.ids:
        im = dataset.coco.imgs[img_id]
        video = im["file_name"].split("/")[0]
        fid = im.get("frame_id", 0)
        for a in dataset.coco.load_anns_for_img(img_id):
            x, y, w, h = a["bbox"]
            if a.get("ignore", 0) or a.get("iscrowd", 0):
                gts[video][fid][2].append((x, y, w, h))
                continue
            tid = a.get("track_id", -1)
            if tid < 0:
                continue
            gts[video][fid][0].append(tid)
            gts[video][fid][1].append((x, y, w, h))
    return {video: [(fid, ids, tlwhs, ign) for fid, (ids, tlwhs, ign)
                    in sorted(frames.items())]
            for video, frames in gts.items()}


def run_fused(exp, model, dataset, args, chunk=32, min_box_area=100.0):
    """The streaming pipeline over the eval set: letterboxed frames in
    chunks of `chunk` on the card, the tracker state on the card, the
    packed (T, 7) rows fetched a chunk at a time. Returns {video: [(frame_id,
    tids, tlwhs, scores)]}."""
    device = resolve_device(args.device)
    pipe = StreamingMOTPipeline(
        model, input_size=exp.test_size, num_classes=exp.num_classes,
        conf_thre=exp.test_conf, nms_thre=exp.nmsthre, max_dets=256,
        max_tracks=256, track_thresh=args.track_thresh,
        match_thresh=args.match_thresh, n_cand=512,
        track_buffer=args.track_buffer, chunk=chunk, approx_topk=False,
        device=device)
    img_size = dataset.img_size
    # the 1.6 vertical-aspect filter is MOTChallenge-pedestrian-specific
    # (the reference's mot_evaluator.py:881-882 omits it for BDD)
    max_aspect = 1.6 if exp.num_classes == 1 else float("inf")
    results = defaultdict(list)
    buf, metas = [], []

    def flush():
        if not buf:
            return
        n_real = len(buf)
        while len(buf) < chunk:   # pad the video's last chunk; the padded
            buf.append(buf[-1])   # frames come after every real one
        frames = torch.from_numpy(np.stack(buf)).to(device)
        outs = to_host(pipe.run_chunk(frames))
        for rows, (video, fid, scale) in zip(outs[:n_real], metas):
            rows = rows[rows[:, 6] > 0]
            tlwhs, tids, scores = [], [], []
            for r in rows:
                w_ = (r[2] - r[0]) / scale
                h_ = (r[3] - r[1]) / scale
                if w_ * h_ > min_box_area and w_ / max(h_, 1e-6) <= max_aspect:
                    tlwhs.append((r[0] / scale, r[1] / scale, w_, h_))
                    tids.append(int(r[5]))
                    scores.append(float(r[4]))
            results[video].append((fid, tids, tlwhs, scores))
        buf.clear()
        metas.clear()

    cur_video = None
    n = len(dataset) if args.max_frames is None else min(args.max_frames,
                                                         len(dataset))
    for i in range(n):
        img, _, info, _ = dataset[i]
        h, w, frame_id, video_id, file_name = info
        video = file_name.split("/")[0]
        if video != cur_video:
            flush()
            pipe.reset()
            cur_video = video
        buf.append(img)
        metas.append((video, frame_id,
                      min(img_size[0] / float(h), img_size[1] / float(w))))
        if len(buf) == chunk:
            flush()
    flush()
    return dict(results)


def main(argv=None):
    """Returns {video: [(frame_id, tids, tlwhs, scores)]}."""
    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    model = load_model(exp, args.ckpt)
    dataset = MOTEvalDataset(
        data_dir=os.path.join(get_unicorn_datadir(), "mot"),
        json_file=exp.test_ann, name=exp.test_name, img_size=exp.test_size,
        # letterboxed to test_size: both paths take letterbox-coordinate
        # frames and divide the output boxes by the letterbox scale
        preproc=ValTransform())
    if args.fused:
        results = run_fused(exp, model, dataset, args, chunk=args.chunk)
        if args.result_dir:
            for vname, res in results.items():
                write_mot_results(
                    os.path.join(args.result_dir, f"{vname}.txt"), res)
    else:
        driver = MOTDriver(model, exp.test_size, num_classes=exp.num_classes,
                           conf_thre=exp.test_conf, nms_thre=exp.nmsthre,
                           max_out=256, device=args.device)
        evaluator = MOTEvaluator(
            exp=exp, dataset=dataset, track_thresh=args.track_thresh,
            track_buffer=args.track_buffer, match_thresh=args.match_thresh,
            device=args.device)
        results = evaluator.evaluate(mot_step_fn(driver),
                                     result_dir=args.result_dir,
                                     max_frames=args.max_frames,
                                     tracker=args.tracker)
    gts = load_gt_from_dataset(dataset)
    if any(gts.values()):
        print(MOTEvaluator.score(results, gts))
    else:
        print(f"wrote results for {len(results)} videos to {args.result_dir}")
    return results


if __name__ == "__main__":
    main()
