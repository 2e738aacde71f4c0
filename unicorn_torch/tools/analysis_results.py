"""SOT result analysis (the port's tools/analysis_results.py): reads the
per-sequence result txts that tools/test.py wrote and scores OPE AUC /
precision against the dataset's ground truth.

  python -m unicorn_torch.tools.analysis_results --dataset lasot \
      --result-dir test_results/unicorn_sot/lasot [--plot out.png]

--plot draws the success and precision plots with matplotlib, which it
imports then; without matplotlib installed it raises ImportError.
"""
import argparse
import os

import numpy as np

from ..harness.analysis import evaluate_sot, plot_results
from ..harness.datasets import get_dataset


def main(argv=None):
    p = argparse.ArgumentParser("unicorn_torch SOT analysis")
    p.add_argument("--dataset", default="lasot")
    p.add_argument("--result-dir", required=True)
    p.add_argument("--plot", default=None,
                   help="save success/precision plots to this PNG path")
    args = p.parse_args(argv)

    sequences = get_dataset(args.dataset)
    gts = {s.name: s.ground_truth_rect for s in sequences
           if len(s.ground_truth_rect) > 1}
    results = {}
    for f in os.listdir(args.result_dir):
        if f.endswith(".txt"):
            results[f[:-4]] = np.loadtxt(
                os.path.join(args.result_dir, f), delimiter="\t")
    metrics = evaluate_sot(results, gts)
    print(metrics)
    if args.plot:
        plot_results({"unicorn_torch": results}, gts, args.plot,
                     title=args.dataset)
        print(f"plots saved to {args.plot}")
    return metrics


if __name__ == "__main__":
    main()
