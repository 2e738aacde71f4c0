"""COCO detection / instance-segmentation evaluation (the port's
tools/eval.py; the reference's tools/eval.py).

  python -m unicorn_torch.tools.eval -n unicorn_det_convnext_tiny_800x1280 \
      -c Unicorn_outputs/unicorn_det_convnext_tiny_800x1280/best \
      [--max-images N] [--conf 0.01] [--nms 0.65] [-b 4] [key value ...]

-f takes an experiment file, -n the name of one of unicorn_torch/exp/.
The checkpoint is one the port's Trainer wrote (its EMA weights, else its
weights); without -c the weights are the exp's seeded init (seed 0). The
data is the exp's val set under $UNICORN_DATADIR. Runs on the card unless
--device cpu. Prints the metrics dict.
"""
import argparse

from ..exp.base import get_exp
from .common import load_model


def make_parser():
    p = argparse.ArgumentParser("unicorn_torch eval")
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=4)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--conf", type=float, default=None)
    p.add_argument("--nms", type=float, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nmsthre = args.nms

    model = load_model(exp, args.ckpt)
    evaluator = exp.get_evaluator(batch_size=args.batch_size,
                                  device=args.device)
    # the det exps through the head's decode, the inst exp through the
    # CondInst mask decode (box + mask AP)
    metrics = exp.eval(model, evaluator, max_images=args.max_images)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
