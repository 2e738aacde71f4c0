"""Multi-stage training launcher (the port's launch_uni.py; the
reference's launch_uni.py): detection pretraining -> (inst) -> the uni
tracking stage -> the mask stage, each stage a process of
`python -m unicorn_torch.tools.train -n <exp> -b B --resume`, so that a
stage resumes from its own latest checkpoint and the next picks up the
previous stage's weights through its exp's load_pretrained. A stage that
fails stops the chain with its exit code.

  python -m unicorn_torch.tools.launch_uni --stage all --model tiny -b 16
  python -m unicorn_torch.tools.launch_uni --stage track --model large -b 16
  torchrun --nproc_per_node W -m unicorn_torch.tools.launch_uni ... -b 16

Under torchrun every rank runs this launcher, and each stage's process
inherits torchrun's environment, so the W processes of a stage train it
data-parallel (tools/train.py), -b the global batch; each stage forms a
process group of its own in the agent's store (parallel/multihost.py).
"""
import argparse
import subprocess
import sys

STAGES = {
    "tiny": {
        "det": "unicorn_det_convnext_tiny_800x1280",
        "inst": "unicorn_inst_convnext_tiny_800x1280",
        "track": "unicorn_track_tiny",
        "mask": "unicorn_track_tiny_mask",
    },
    "large": {
        "det": "unicorn_det_convnext_large_800x1280",
        "track": "unicorn_track_large",
        "mask": "unicorn_track_large_mask",
    },
    "r50": {
        "det": "unicorn_det_r50_800x1280",
        "track": "unicorn_track_r50",
        "mask": "unicorn_track_r50_mask",
    },
}


def main(argv=None):
    p = argparse.ArgumentParser("unicorn_torch launch_uni")
    p.add_argument("--model", default="tiny", choices=sorted(STAGES))
    p.add_argument("--stage", default="all",
                   choices=["all", "det", "inst", "track", "mask"])
    p.add_argument("-b", "--batch-size", type=int, default=16)
    args = p.parse_args(argv)

    stages = STAGES[args.model]
    order = [args.stage] if args.stage != "all" else \
        [s for s in ("det", "inst", "track", "mask") if s in stages]
    for stage in order:
        cmd = [sys.executable, "-m", "unicorn_torch.tools.train", "-n",
               stages[stage], "-b", str(args.batch_size), "--resume"]
        print("launching:", " ".join(cmd))
        ret = subprocess.call(cmd)
        if ret != 0:
            sys.exit(ret)


if __name__ == "__main__":
    main()
