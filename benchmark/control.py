#!/usr/bin/env python3
"""Reads a cell's control and planted faults on the card, at the cell's
own size, with no measured window: the readings that set the upper end of
each compared number's limit.

    python3 benchmark/control.py --workload garden.view --seeds 11 12 13

The control is the reference put in the program's place, computed in the
precision below the configuration's float32: bfloat16 (the render has no
tensor-core work, so TF32 changes almost nothing; it is read beside it).
The fault, planted in the reference put in the program's place: each
answer replaced by the one before it. The cell's kind
(``kinds/<kind>.py``) reads both, in its ``control_readings``. Prints one
JSON line per seed; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402

PRECISIONS = ("bf16", "tf32")


def readings(cfg, mix, seed, dev, precisions=PRECISIONS) -> dict:
    """The control's and the fault's compared numbers of one seed."""
    return H.load_kind(mix["kind"]).control_readings(cfg, mix, seed, dev, precisions)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell, cfg, mix, limits = H.cell_files(H.load_spec(), args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cfg, mix, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, "limits": limits,
                          "readings": got, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
