"""Training entry point (the port's tools/train.py; the reference's
tools/train.py).

  python -m unicorn_torch.tools.train -n unicorn_track_tiny -b 16 [--resume]
  python -m unicorn_torch.tools.train -f my_exp.py -b 8 [-c ckpt] \
      [--start_epoch N] [--seed S] [--device cpu] [key value ...]

  torchrun --nproc_per_node W -m unicorn_torch.tools.train -n ... -b 16

-f takes an experiment file, -n the name of one of unicorn_torch/exp/.
`Trainer(exp, {...}).train()` on one card, or data-parallel over W cards
under torchrun: `initialize_multihost` forms the NCCL group from torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT),
each process trains on the card of its LOCAL_RANK, and -b is the global
batch, split over the ranks. On the CPU with --device cpu (gloo between
CPU processes). With --resume the run resumes from -c, else from
<output_dir>/<exp_name>/latest; without it, -c is a checkpoint whose
weights start a fine-tuning run. Trailing `key value` pairs override the
exp's fields.
"""
import argparse

from ..core.trainer import Trainer
from ..exp.base import get_exp
from ..parallel.multihost import initialize_multihost, local_device


def make_parser():
    parser = argparse.ArgumentParser("unicorn_torch train")
    parser.add_argument("-f", "--exp_file", default=None, type=str)
    parser.add_argument("-n", "--name", default=None, type=str)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("-c", "--ckpt", default=None, type=str,
                        help="checkpoint path: with --resume, resume from it "
                             "instead of <output>/latest; without, load its "
                             "weights for fine-tuning")
    parser.add_argument("--start_epoch", default=None, type=int,
                        help="override the resumed start epoch")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="exp config overrides: key value ...")
    return parser


def main(argv=None):
    """Returns the Trainer after its run."""
    args = make_parser().parse_args(argv)
    # under torchrun: the process group over the ranks (nothing in a single
    # process), before anything touches the card
    initialize_multihost(device=args.device)
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if args.seed is not None:
        exp.seed = args.seed
    trainer = Trainer(exp, {"batch_size": args.batch_size,
                            "resume": args.resume, "ckpt": args.ckpt,
                            "start_epoch": args.start_epoch},
                      device=local_device(args.device))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
