"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Runs one cell of ``BENCHMARK.json``: set-up,
a closed loop of whole requests for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or the traced passes (``--trace 1``: its
per-layer metrics), then the check of the images against the plain
reference.  The last line of standard output is the result object; the
numbers compared, each beside its limit, are the last lines of standard
error.  Set-up parts and the peak memory are printed on earlier lines.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    # every cache of a run stays in the checkout, at fixed paths (the
    # program builds its kernels into build/kernels/ there itself)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    from port_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.execute(cell, seed=args.seed, seconds=args.seconds,
                             traced=bool(args.trace), device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules loaded that a run may not load: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
