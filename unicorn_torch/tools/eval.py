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

Under torchrun (WORLD_SIZE > 1) the processes form a group
(parallel/multihost.py) and a "data" mesh, under JAX's conditions
(tools/eval.py:50-52): the batch divides over the W ranks and the exp's
task is "det". Each rank forwards its share of the images on its card
and every rank scores all of them; rank 0 prints. Otherwise it raises,
rather than run the whole eval on every rank.

  torchrun --nproc_per_node 4 -m unicorn_torch.tools.eval -n <exp> -b 16
"""
import argparse

from ..exp.base import get_exp
from ..parallel import initialize_multihost, make_mesh
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
    kw = {}
    if initialize_multihost(device=args.device) is not None:
        kw["mesh"] = mesh = make_mesh(axis_names=("data",),
                                      device=args.device)
        w = mesh.size("data")
        if args.batch_size % w or getattr(exp, "task", "det") != "det":
            raise ValueError(
                f"eval over {w} processes needs a batch that "
                f"divides over them (-b {args.batch_size}) and a det exp "
                f"(task {getattr(exp, 'task', 'det')!r})")
    evaluator = exp.get_evaluator(batch_size=args.batch_size,
                                  device=args.device, **kw)
    # the det exps through the head's decode, the inst exp through the
    # CondInst mask decode (box + mask AP)
    metrics = exp.eval(model, evaluator, max_images=args.max_images)
    if "mesh" not in kw or kw["mesh"].rank == 0:
        print(metrics)
    return metrics


if __name__ == "__main__":
    main()
