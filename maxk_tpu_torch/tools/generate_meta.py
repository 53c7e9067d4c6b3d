"""Offline warp4 metadata generator — the port's counterpart of
``tools/generate_meta.py``, a CLI replica of the reference's
kernels/generate_meta.py: it walks ``--graphs`` for
``<name>.indptr``/``<name>.indices`` binaries and writes
``w12_nz64_warp_4/<name>.warp4`` under ``--out``.

  python -m maxk_tpu_torch.tools.generate_meta --graphs ./graphs/ --out .

The port's kernels do not read these files (K2 and K5 build their
segment plan at graph load, ``ops/graph.py::SegmentPlan``); the tool keeps
benchmark setups that expect ``.warp4`` dumps working. Host only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from maxk_tpu_torch.data.loaders import available_graphs, load_csr_binary
from maxk_tpu_torch.data.warp4 import META_DIRNAME, generate_warp4, save_warp4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", default="./graphs/",
                    help="dir with <name>.indptr/.indices binaries")
    ap.add_argument("--out", default=".",
                    help=f"parent dir for {META_DIRNAME}/")
    args = ap.parse_args(argv)

    names = available_graphs(args.graphs)
    print(f"generating metadata, save to {Path(args.out) / META_DIRNAME}")
    for i, name in enumerate(names, 1):
        csr = load_csr_binary(args.graphs, name)
        save_warp4(generate_warp4(csr), args.out, name)
        print(f"{i} {name} finish")
    return 0


if __name__ == "__main__":
    sys.exit(main())
