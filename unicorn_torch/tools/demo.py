"""Image / video demo (the port's tools/demo.py; the reference's
tools/demo.py).

  python -m unicorn_torch.tools.demo image -n unicorn_track_tiny -c ckpt \
      --path img_or_dir --save-dir demo_out [--conf 0.3] [--nms 0.65]
  python -m unicorn_torch.tools.demo video -n unicorn_track_tiny -c ckpt \
      --path frame_dir --save-dir demo_out [--fps 30] [--device cpu]

Each frame is letterboxed to test_size on the host, run through
forward_whole, decoded and NMSed on the card; the boxes are divided back
by the letterbox scale and drawn (utils/visualize.py draw_detections).
`image` takes a file or a directory of .jpg / .png files and writes
<save-dir>/<stem>.png for each; `video` takes a directory of frames
(utils/demo_utils.py VideoReader: the port has no video codec) and writes
the drawn frames as numbered PNGs into <save-dir>/demo_out/; `webcam`
raises NotImplementedError. -f / -n / -c as tools/eval.py.
"""
import argparse
import os

import numpy as np
import torch

from ..data.image_io import imread, write_png
from ..data.preproc import letterbox
from ..device import images_to_device, resolve_device, to_host
from ..exp.base import get_exp
from ..models.heads import decode_for_inference
from ..ops.nms import postprocess_device
from ..utils.demo_utils import FRAME_EXTS, VideoReader, VideoWriter
from ..utils.visualize import draw_detections
from .common import load_model


def make_parser():
    p = argparse.ArgumentParser("unicorn_torch demo")
    p.add_argument("demo", choices=["image", "video", "webcam"])
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("--path", default="./assets")
    p.add_argument("--save-dir", default="demo_out")
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--nms", type=float, default=0.65)
    p.add_argument("--fps", type=float, default=30,
                   help="frame rate of a video's frame directory")
    p.add_argument("--device", default="cuda")
    # not argparse.REMAINDER: after a leading positional (the demo mode)
    # REMAINDER would swallow every following option
    p.add_argument("opts", nargs="*")
    return p


def main(argv=None):
    """Returns {image path or frame index: (N, 7) detections in image
    coordinates}."""
    args = make_parser().parse_args(argv)
    if args.demo == "webcam":
        raise NotImplementedError(
            "demo webcam: the port has no camera capture; give the frames "
            "as a directory to `video`")
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    device = resolve_device(args.device)
    model = load_model(exp, args.ckpt).to(device)

    @torch.inference_mode()
    def predict(img):
        padded, r = letterbox(img, exp.test_size)
        raw, _ = model.forward_whole(images_to_device(padded[None], device))
        dets, valid = postprocess_device(
            decode_for_inference(raw, (8, 16, 32), mode="mot"),
            num_classes=exp.num_classes, conf_thre=args.conf,
            nms_thre=args.nms, n_cand=512, max_out=128)
        d = to_host(dets[0])[to_host(valid[0]).astype(bool)]
        if len(d):
            d[:, :4] /= r
        return d

    os.makedirs(args.save_dir, exist_ok=True)
    out = {}
    if args.demo == "image":
        paths = ([os.path.join(args.path, f)
                  for f in sorted(os.listdir(args.path))
                  if f.lower().endswith(FRAME_EXTS)]
                 if os.path.isdir(args.path) else [args.path])
        for p in paths:
            img = imread(p)
            out[p] = d = predict(img)
            stem = os.path.splitext(os.path.basename(p))[0]
            write_png(os.path.join(args.save_dir, f"{stem}.png"),
                      np.ascontiguousarray(draw_detections(img, d)[..., ::-1]))
            print(f"{p}: {len(d)} detections")
        return out
    reader = VideoReader(args.path, fps=args.fps)
    out_dir = os.path.join(args.save_dir, "demo_out")
    writer = VideoWriter(out_dir, reader.fps, (reader.width, reader.height))
    for i, frame in enumerate(reader):
        out[i] = d = predict(frame)
        writer.write(draw_detections(frame, d))
    writer.release()
    print(f"wrote {writer.n} frames to {out_dir}")
    return out


if __name__ == "__main__":
    main()
