"""DTI track interpolation of MOT txt results (the port's
tools/interpolation.py; the reference's tools/interpolation.py:66).

  python -m unicorn_torch.tools.interpolation --txt-dir track_results \
      --out-dir track_results_dti [--n-min 25] [--n-dti 20] [--copy-1to3]

Fills the short gaps of each track by linear interpolation of its rows;
numpy only. The written files are byte-equal to the JAX package's.
"""
import argparse
import glob
import os
import shutil

import numpy as np


def dti(txt_path, save_path, n_min=25, n_dti=20):
    data = np.loadtxt(txt_path, delimiter=",")
    if data.ndim == 1:
        data = data.reshape(1, -1)
    out = []
    for tid in np.unique(data[:, 1]):
        tracklet = data[data[:, 1] == tid]
        tracklet = tracklet[np.argsort(tracklet[:, 0])]
        n = len(tracklet)
        # reference gates: only tracks LONGER than n_min get interpolated
        # (short tracklets are likely false positives), and a gap must be
        # strictly under n_dti (interpolation.py:82,92)
        if n <= max(2, n_min):
            out.append(tracklet)
            continue
        frames = tracklet[:, 0]
        rows = [tracklet[0]]
        for i in range(1, n):
            gap = int(frames[i] - frames[i - 1])
            if 1 < gap < n_dti:
                for g in range(1, gap):
                    a = g / gap
                    interp = tracklet[i - 1] * (1 - a) + tracklet[i] * a
                    interp[0] = frames[i - 1] + g
                    interp[1] = tid
                    # synthesized rows: conf 1, tail -1 (interpolation.py:
                    # 108); only the box is interpolated
                    if interp.shape[0] >= 7:
                        interp[6] = 1.0
                        interp[7:] = -1.0
                    rows.append(interp)
            rows.append(tracklet[i])
        out.append(np.stack(rows))
    merged = np.concatenate(out)
    merged = merged[np.lexsort((merged[:, 1], merged[:, 0]))]
    np.savetxt(save_path, merged, fmt="%d,%d,%.1f,%.1f,%.1f,%.1f,%.2f,%d,%d,%d"
               if merged.shape[1] == 10 else "%.1f", delimiter=",")


def copy_1to3(src_dir, des_dir):
    """Duplicate MOT17 FRCNN result files as DPM / SDP variants (the MOT17
    submission format expects all three detector splits; the reference's
    tools/copy_1to3.py)."""
    os.makedirs(des_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(src_dir)):
        if "FRCNN" not in f:
            continue
        src = os.path.join(src_dir, f)
        for det in ("FRCNN", "DPM", "SDP"):
            shutil.copyfile(src, os.path.join(des_dir,
                                              f.replace("FRCNN", det)))
            n += 1
    print(f"copy_1to3: wrote {n} files to {des_dir}")


def main(argv=None):
    p = argparse.ArgumentParser("unicorn_torch interpolation")
    p.add_argument("--txt-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-dti", type=int, default=20,
                   help="only gaps strictly shorter than this are filled")
    p.add_argument("--n-min", type=int, default=25,
                   help="only tracks longer than this get interpolated "
                        "(short tracklets are likely false positives)")
    p.add_argument("--copy-1to3", action="store_true",
                   help="also expand FRCNN txts to DPM/SDP for submission")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for txt in glob.glob(os.path.join(args.txt_dir, "*.txt")):
        dti(txt, os.path.join(args.out_dir, os.path.basename(txt)),
            n_min=args.n_min, n_dti=args.n_dti)
        print("interpolated", os.path.basename(txt))
    if args.copy_1to3:
        copy_1to3(args.out_dir, args.out_dir + "_1to3")


if __name__ == "__main__":
    main()
