#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``splat_one_tpu_torch`` once, on the
card of the machine it starts on, and prints the result as the last line
of standard output.

    python3 benchmark/run.py --workload garden.view --seed 7 --seconds 45 --trace 0

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
same window, then a few units of work under ``torch.profiler``, and
reports the cell's per-layer metrics, the device's busy and window seconds
and a breakdown. Every run then compares what the timed path produced with
the plain reference (``benchmark/reference``) and prints each compared
number beside its limit. It exits with 2, printing no result, where there
is no CUDA card or fewer than the cell asks for, or where the JAX stack or
the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness as H

    try:
        import torch

        spec = H.load_spec()
        cell = H.cell_files(spec, args.workload)[0]
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise H.Refused(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                            f"this machine has {torch.cuda.device_count()}")
        # one process, few threads: the host work is the program's Python
        # loop and copies, which intra-op threads only add jitter to
        torch.set_num_threads(1)
        H.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), _T0)
        return 0
    except H.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
