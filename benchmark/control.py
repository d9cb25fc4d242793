"""Read the check's numbers for the program and for the control (or a
planted fault) over many seeds, in one process, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 5 \
        [--modes program,control,flip,half,unchanged] [--out FILE]

Each (seed, mode) is a whole run of the cell (set-up, a window of
`--seconds`, the check); a mode other than `program` plants
`faults.planted(mode, op)` for all of it.  Prints one JSON line per run with
its checks and `correct`, and writes them all to `--out` if given.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if not __package__:
    sys.path[0] = str(ROOT)

from benchmark import cells, faults, harness  # noqa: E402


def readings(cell, seeds, seconds, modes, device) -> list[dict]:
    rows = []
    for mode in modes:
        for seed in seeds:
            plant = contextlib.nullcontext() if mode == "program" else faults.planted(mode, cell.traffic["op"])
            with plant:
                r = harness.run_cell(cell, seed, seconds, False, device, time.perf_counter())
            rows.append({"workload": cell.name, "mode": mode, "seed": seed, "correct": r["correct"],
                         "attempted": r["attempted"], "checks": r["checks"], "metrics": r["metrics"]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.load(ROOT, args.workload)
    rows = readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds, args.modes.split(","), "cuda")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
