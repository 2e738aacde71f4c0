"""Dataset converters to COCO-format video jsons (the port's copy of
tools/convert_datasets.py; it writes the same files): the MOT17 / MOT20,
CrowdHuman, MOTS-Challenge (RLE), CityPersons / ETHZ and omni jsons that
the datasets of data/datasets read, and the TrackingNet unpacking.

  python -m unicorn_torch.tools.convert_datasets mot17 --root datasets/mot
  python -m unicorn_torch.tools.convert_datasets mots --root datasets/MOTS
  python -m unicorn_torch.tools.convert_datasets crowdhuman \
      --root datasets/crowdhuman
"""
import argparse
import json
import os

import numpy as np

from ..evaluators import rle as rle_codec


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def convert_mot(root, split="train", out_name=None, mot20=False):
    """MOT17/MOT20 gt.txt -> COCO video json with track ids."""
    out = {"images": [], "annotations": [],
           "categories": [{"id": 1, "name": "pedestrian"}], "videos": []}
    split_dir = os.path.join(root, split)
    img_id = ann_id = 1
    for vid, video in enumerate(sorted(os.listdir(split_dir)), start=1):
        vdir = os.path.join(split_dir, video)
        ini = os.path.join(vdir, "seqinfo.ini")
        if not os.path.exists(ini):
            continue
        info = dict(l.strip().split("=") for l in open(ini)
                    if "=" in l)
        width, height = int(info["imWidth"]), int(info["imHeight"])
        n_frames = int(info["seqLength"])
        out["videos"].append({"id": vid, "name": video})
        frame_to_img = {}
        for f in range(1, n_frames + 1):
            out["images"].append({
                "id": img_id, "video_id": vid, "frame_id": f,
                "file_name": f"{video}/img1/{f:06d}.jpg",
                "width": width, "height": height,
            })
            frame_to_img[f] = img_id
            img_id += 1
        gt_path = os.path.join(vdir, "gt", "gt.txt")
        if os.path.exists(gt_path):
            gt = np.loadtxt(gt_path, delimiter=",").reshape(-1, 9)
            for row in gt:
                frame, tid, x, y, w, h, mark, cls = row[:8]
                vis = float(row[8]) if len(row) > 8 else 1.0
                box = [float(x), float(y), float(w), float(h)]
                if mark == 0 or int(cls) != 1:
                    # ignore regions (reference evaluation.py:144-175:
                    # classes {2,7,8,12} = static person/distractor/
                    # reflection, or vis<0): kept as iscrowd entries so the
                    # scorer can suppress predictions matched to them;
                    # loaders skip iscrowd, so they never become train gt.
                    # MOT20 drops ignored-person rows entirely instead
                    # (reference convert_mot20_to_coco.py `continue`s where
                    # the MOT17 converter emits category_id=-1)
                    if not mot20 and (int(cls) in (2, 7, 8, 12) or vis < 0):
                        out["annotations"].append({
                            "id": ann_id, "image_id": frame_to_img[int(frame)],
                            "category_id": 1, "track_id": -1, "bbox": box,
                            "area": float(w * h), "iscrowd": 1, "ignore": 1,
                        })
                        ann_id += 1
                    continue
                out["annotations"].append({
                    "id": ann_id, "image_id": frame_to_img[int(frame)],
                    "category_id": 1, "track_id": int(tid),
                    "bbox": box, "area": float(w * h), "iscrowd": 0,
                })
                ann_id += 1
    out_path = os.path.join(root, "annotations",
                            out_name or f"{split}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    _dump(out, out_path)
    print(f"wrote {out_path}: {len(out['images'])} images, "
          f"{len(out['annotations'])} annotations")


def convert_crowdhuman(root, split="train"):
    """CrowdHuman .odgt -> COCO json (static images; track_id = -1)."""
    odgt = os.path.join(root, f"annotation_{split}.odgt")
    out = {"images": [], "annotations": [],
           "categories": [{"id": 1, "name": "pedestrian"}]}
    img_id = ann_id = 1
    for line in open(odgt):
        rec = json.loads(line)
        out["images"].append({
            "id": img_id, "file_name": f"{rec['ID']}.jpg",
            "width": -1, "height": -1,
        })
        for gtbox in rec.get("gtboxes", []):
            if gtbox.get("tag") != "person":
                continue
            x, y, w, h = gtbox["fbox"]
            out["annotations"].append({
                "id": ann_id, "image_id": img_id, "category_id": 1,
                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                "track_id": -1,
            })
            ann_id += 1
        img_id += 1
    out_path = os.path.join(root, "annotations", f"{split}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    _dump(out, out_path)
    print(f"wrote {out_path}")


def convert_mots(root, split="train"):
    """MOTS-Challenge gt.txt (frame id class_id img_h img_w rle) -> COCO
    video json with RLE segmentations (reference convert_mots_to_coco.py)."""
    out = {"images": [], "annotations": [],
           "categories": [{"id": 1, "name": "pedestrian"}], "videos": []}
    split_dir = os.path.join(root, split)
    img_id = ann_id = 1
    for vid, video in enumerate(sorted(os.listdir(split_dir)), start=1):
        gt_path = os.path.join(split_dir, video, "gt", "gt.txt")
        if not os.path.exists(gt_path):
            continue
        out["videos"].append({"id": vid, "name": video})
        frame_to_img = {}
        rows = [l.split() for l in open(gt_path)]
        n_frames = max(int(r[0]) for r in rows) if rows else 0
        h = int(rows[0][3]) if rows else 0
        w = int(rows[0][4]) if rows else 0
        for f in range(1, n_frames + 1):
            out["images"].append({
                "id": img_id, "video_id": vid, "frame_id": f,
                "file_name": f"{video}/img1/{f:06d}.jpg",
                "width": w, "height": h,
            })
            frame_to_img[f] = img_id
            img_id += 1
        for r in rows:
            frame, oid, cls = int(r[0]), int(r[1]), int(r[2])
            if cls != 2:   # pedestrians only (class 2 in MOTS)
                continue
            seg = {"size": [int(r[3]), int(r[4])], "counts": r[5]}
            mask = rle_codec.decode(seg)
            ys, xs = mask.nonzero()
            if len(xs) == 0:
                continue
            out["annotations"].append({
                "id": ann_id, "image_id": frame_to_img[frame],
                "category_id": 1, "track_id": oid % 1000,
                "bbox": [float(xs.min()), float(ys.min()),
                         float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)],
                "area": float(mask.sum()), "iscrowd": 0,
                "segmentation": seg,
            })
            ann_id += 1
    out_path = os.path.join(root, "annotations", f"{split}_mots.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    _dump(out, out_path)
    print(f"wrote {out_path}")


def convert_cityscapes_like(root, ann_json, split="train"):
    """CityPersons / ETHZ style: already COCO-ish jsons from the ByteTrack
    data kit — normalize track_id/video fields for the omni loader."""
    d = json.load(open(os.path.join(root, ann_json)))
    for a in d.get("annotations", []):
        a.setdefault("track_id", -1)
        a.setdefault("iscrowd", 0)
    for im in d.get("images", []):
        im.setdefault("video_id", -1)
        im.setdefault("frame_id", 0)
    out_path = os.path.join(root, "annotations", f"{split}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    _dump(d, out_path)
    print(f"wrote {out_path}")


def convert_mot17_to_omni(root, ori_json="train.json",
                          new_json="train_omni.json"):
    """COCO-video json -> omni json keyed by video/frame
    (reference tools/convert_mot17_to_omni.py): {video_id: {frame_id:
    {res (N,6), img_info, file_name}}} for random 2-frame access."""
    ann_dir = os.path.join(root, "annotations")
    coco = json.load(open(os.path.join(ann_dir, ori_json)))
    anns_by_img = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)
    cat_ids = sorted(c["id"] for c in coco.get("categories", []))
    omni = {}
    for im in coco["images"]:
        vid = im.get("video_id", -1)
        fid = im.get("frame_id", 0)
        res = []
        for a in anns_by_img.get(im["id"], []):
            if a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            res.append([x, y, x + w, y + h, cat_ids.index(a["category_id"]),
                        a.get("track_id", -1)])
        omni.setdefault(str(vid), {})[str(fid)] = {
            "res": res,
            "img_info": [im["height"], im["width"], fid, vid,
                         im["file_name"]],
            "file_name": im["file_name"],
        }
    out = os.path.join(ann_dir, new_json)
    _dump(omni, out)
    print(f"wrote {out}: {len(omni)} videos")


def process_trackingnet(root, n_chunks=4):
    """Unpack TRAIN_{0..n}.zip chunks into the TrackingNet layout
    (reference tools/process_trackingnet.py) using zipfile, no shell."""
    import zipfile

    for i in range(n_chunks):
        zp = os.path.join(root, f"TRAIN_{i}.zip")
        chunk = os.path.join(root, f"TRAIN_{i}")
        if not os.path.exists(zp):
            print(f"skip missing {zp}")
            continue
        os.makedirs(chunk, exist_ok=True)
        with zipfile.ZipFile(zp) as z:
            z.extractall(chunk)
        zdir = os.path.join(chunk, "zips")
        frames = os.path.join(chunk, "frames")
        os.makedirs(frames, exist_ok=True)
        if os.path.isdir(zdir):
            for sub in sorted(os.listdir(zdir)):
                if not sub.endswith(".zip"):
                    continue
                seq = sub[:-4]
                with zipfile.ZipFile(os.path.join(zdir, sub)) as z:
                    z.extractall(os.path.join(frames, seq))
            import shutil

            shutil.rmtree(zdir)
        print(f"TRAIN_{i} done")
    tn = os.path.join(root, "TrackingNet")
    os.makedirs(tn, exist_ok=True)
    for i in range(n_chunks):
        chunk = os.path.join(root, f"TRAIN_{i}")
        if os.path.isdir(chunk):
            os.rename(chunk, os.path.join(tn, f"TRAIN_{i}"))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["mot17", "mot20", "crowdhuman", "mots",
                                       "cityperson", "ethz", "mot17-omni",
                                       "trackingnet"])
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--ann-json", default=None)
    args = p.parse_args()
    if args.dataset in ("mot17", "mot20"):
        convert_mot(args.root, args.split, mot20=args.dataset == "mot20")
    elif args.dataset == "mot17-omni":
        convert_mot17_to_omni(args.root, args.ann_json or "train.json")
    elif args.dataset == "trackingnet":
        process_trackingnet(args.root)
    elif args.dataset == "mots":
        convert_mots(args.root, args.split)
    elif args.dataset in ("cityperson", "ethz"):
        convert_cityscapes_like(args.root, args.ann_json or "annotations.json",
                                args.split)
    else:
        convert_crowdhuman(args.root, args.split)


if __name__ == "__main__":
    main()
