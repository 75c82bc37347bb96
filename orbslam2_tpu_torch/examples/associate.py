"""Timestamp association tool, as ORB-SLAM2's Examples/RGB-D/associate.py.

    python -m orbslam2_tpu_torch.examples.associate rgb.txt depth.txt [--max-dt 0.02]

Prints "ts_a file_a ts_b file_b" lines like the original script.
"""

import argparse

from ..utils.datasets import _read_tum_list, associate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("first")
    ap.add_argument("second")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)
    a = _read_tum_list(args.first)
    b = _read_tum_list(args.second)
    b_by_path = {p: t for t, p in b}
    for ta, pa, pb in associate(a, b, args.max_dt):
        print(f"{ta:.6f} {pa} {b_by_path[pb]:.6f} {pb}")


if __name__ == "__main__":
    main()
