"""Serve trained MonoCap avatars with the port (the counterpart of the
repository's render_monocap.py): render_zju with the MonoCap reader, its
sequences and their best iterations, unless the arguments name others.

    python -m moss_torch.cli.render_monocap --data_root /data/monocap --iterations -1 -1 -1 -1
"""
from __future__ import annotations

import sys

from . import render_zju


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reader" not in argv:
        argv += ["--reader", "monocap"]
    if "--subjects" not in argv:
        argv += ["--subjects", "olek_images0812", "lan_images620", "marc_images35000",
                 "vlad_images1011"]
    if "--iterations" not in argv:
        argv += ["--iterations", "3000", "3000", "2500", "2500"]
    if "--output" not in argv:
        argv += ["--output", "output/monocap"]
    return render_zju.main(argv)


if __name__ == "__main__":
    main()
