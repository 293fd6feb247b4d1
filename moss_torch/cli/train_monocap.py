"""Train avatars on MonoCap sequences with the port (the counterpart of the
repository's train_monocap.py, after the reference's train_monocap.py).

train_zju's loop over MonoCap sequences read at full resolution (1024x1024
for the DeepCap captures), the loss crop autosized to the split's bound
rects, the test split decoded lazily at each eval; the metrics go to
result/monocap.txt. The flags are train_zju's: the saves, --resume,
--tensorboard, --gui_port, --debug_nans, --dispatch, --rasterizer, --quiet,
--device, and
the ranks' --coordinator/--num_processes/--process_id/--n_data/--n_tile.

    python -m moss_torch.cli.train_monocap --data_root /data/monocap \\
        --sequences olek_images0812
"""
from __future__ import annotations

import argparse
import os

from ..data.readers import read_monocap
from . import train_zju


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    train_zju.add_training_args(p, "output/monocap", "result/monocap.txt")
    p.add_argument("--sequences", nargs="+", default=["olek_images0812"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return train_zju.run(args, [(s, os.path.join(args.data_root, s), read_monocap, f"monocap/{s}")
                                for s in args.sequences])


if __name__ == "__main__":
    main()
