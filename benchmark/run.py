"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`) from the root of a checkout.  The cell is
looked up in BENCHMARK.json.  The last line on standard output is the result,
one JSON object; the numbers the check compared, each with its limit, are the
last lines on standard error and the result's last key.  Without a card, or
with fewer cards than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if not __package__:  # run as a file: import the harness from the checkout's root
    sys.path[0] = str(ROOT)

# Kernel caches at fixed paths in the checkout, so that only a checkout's first run builds: the program keeps its
# nvcc and g++ builds in snappytpu_torch/_build/; these catch what torch, Triton or the CUDA driver would cache.
CACHE = ROOT / ".bench_cache"
THREADS = 4  # torch's host threads, fixed whatever the machine's cores

import torch  # noqa: E402

from benchmark import cells, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)  # read when CUDA starts or a kernel is first built, after this
    torch.set_num_threads(THREADS)
    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    emit(harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START))
    return 0


def emit(result: dict, out=None, err=None) -> None:
    """The numbers compared as the last lines on standard error, the result
    as the last line on standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
