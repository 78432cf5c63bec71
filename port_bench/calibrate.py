"""Readings of the correctness check over many seeds, for setting its limits.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--quant w8]

Each seed draws its own checkpoint, serves ``--requests`` requests of the
cell's traffic through the program (with ``--quant``, one of the program's
int8 tiers: the control) and checks the cell's number of sampled images
against the plain reference.  One JSON line a seed.  Not part of a
benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, quant: str, n_requests: int, device="cuda"):
    from port_bench import harness, traffic

    server, run = harness.setup(cell, seed, device, time.perf_counter(), quant=quant)
    words = traffic.words()
    outputs = {}
    for i in range(n_requests):
        req = traffic.request(cell.mix, seed, i, words)
        outputs[i] = (req, server(req))
    del server
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    picks = harness.sample(run, outputs, seed)
    return harness.check(cell, outputs, picks, seed, device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--quant", default="none")
    ap.add_argument("--requests", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(cell, seed, args.quant, args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed, "quant": args.quant,
                          "readings": got, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
