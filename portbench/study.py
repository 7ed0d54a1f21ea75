"""The readings that a cell's limits are set from, on the card:

    python3 portbench/study.py --workload <name> --seeds 12 --controls 3 [--first-seed n]

For each seed, the port as a run drives it, then the reference: the port's
gaps (the lower readings). For the first ``--controls`` seeds also the
control, the reference in fp8 put in the port's place, and for a training
cell the faults of a batch cut to its first half and, for Mamba2, of a scan
whose state does not cross between chunks: their gaps (the upper
readings). A training state left unchanged reads 1 and needs no run. One
JSON line per reading; the driver of the cell's traffic says what each
holds.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_200_000_000)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench

    cell = bench.cell(args.workload)
    driver = bench.driver(cell)
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        for line in driver.study(cell, seed, "cuda", k < args.controls):
            print(json.dumps({"seed": seed, **line, "seconds": time.perf_counter() - t}),
                  flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
