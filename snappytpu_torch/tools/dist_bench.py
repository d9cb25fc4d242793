"""Repeated-run distribution series at the reference's size grid — the
counterpart of the JAX package's tools/dist_bench.py: one CSV row per run,
so a series' spread is comparable with the reference's repeated-run CSVs.

    python -m snappytpu_torch.tools.dist_bench --out DIR [--sizes 500,10000,...]
        [--backends cpu,device] [--profiles fast,dense] [--cpu-reps 1000]
        [--dev-reps 100] [--device cuda]

  cpu     the port's native C++ codec (snappytpu_torch.cpu), --cpu-reps runs
          per size and phase, series `hash`;
  device  the port's encoder (encode_block_core) and block decoder
          (decode_vm.decode_blocks_vm) on --device, --dev-reps runs per size,
          phase and profile, on blocks staged on the device once per size.
          Each run is timed by the host clock and ends in a synchronise, so
          small sizes measure the per-call latency (thousands of launches
          for the encoder), as the reference's small-size rows measure its
          per-call overhead.

The input of a size is corpus.mixed(size, seed=size % 97).  Rows go to
<out>/{compression,decompression}_results_<backend>_<profile>_dist.csv
(metrics.write_result_csv's schema); the flags are the JAX tool's
SNAPPYTPU_DIST_* variables with their defaults.  A device row's backend
column names the device the series ran on (`device` on the card, `cpu`
for the plain versions under --device cpu).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import cpu
from ..bench import corpus, metrics
from ..kernels.decode_vm import decode_blocks_vm
from ..kernels.encode_v2 import encode_block_core
from ..stream import framing
from ._staged import device_of, make_log

SIZES = "500,10000,50000,100000,500000,1000000"


def rows_path(out: str, phase: str, backend: str, profile: str) -> str:
    return os.path.join(out, f"{'compression' if phase == 'compress' else 'decompression'}"
                             f"_results_{backend}_{profile}_dist.csv")


def cpu_series(out: str, sizes, reps: int, log) -> None:
    if not cpu.available:
        log("native backend unavailable; skipping cpu series")
        return
    for size in sizes:
        data = corpus.mixed(size, seed=size % 97)
        comp = cpu.compress(data)
        for _ in range(reps):
            t1 = time.perf_counter()
            c = cpu.compress(data)
            dt = time.perf_counter() - t1
            metrics.write_result_csv(rows_path(out, "compress", "cpu", "hash"),
                                     metrics.Result("compress", size, len(c), dt, "cpu"))
        for _ in range(reps):
            t1 = time.perf_counter()
            d = cpu.decompress(comp)
            dt = time.perf_counter() - t1
            metrics.write_result_csv(rows_path(out, "decompress", "cpu", "hash"),
                                     metrics.Result("decompress", len(comp), len(d), dt, "cpu"))
        log(f"cpu {size}: {2 * reps} rows")


def device_series(out: str, sizes, profiles, reps: int, dev, log) -> None:
    label = "device" if dev.type == "cuda" else "cpu"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    log(f"device backend: {dev}")
    for profile in profiles:
        dense = profile == "dense"
        for size in sizes:
            data = np.frombuffer(corpus.mixed(size, seed=size % 97), np.uint8)
            blocks, lens = framing.pack_blocks(data)
            bb = torch.from_numpy(blocks).to(dev)
            ll = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
            comp, totals = encode_block_core(bb, ll, dense)  # also the warm-up
            out_size = int(totals.sum())
            if bool((totals < 0).any()):
                raise RuntimeError(f"{profile} {size}: the encoder poisoned a block")
            for _ in range(reps):
                sync()
                t1 = time.perf_counter()
                encode_block_core(bb, ll, dense)
                sync()
                dt = time.perf_counter() - t1
                metrics.write_result_csv(rows_path(out, "compress", "device", profile),
                                         metrics.Result("compress", size, out_size, dt, label))
            dec, ok = decode_blocks_vm(comp, totals, ll)  # warm-up and check
            if not bool(ok.all()) or not torch.equal(dec, bb):
                raise RuntimeError(f"{profile} {size}: the device round trip failed")
            for _ in range(reps):
                sync()
                t1 = time.perf_counter()
                decode_blocks_vm(comp, totals, ll)
                sync()
                dt = time.perf_counter() - t1
                metrics.write_result_csv(rows_path(out, "decompress", "device", profile),
                                         metrics.Result("decompress", out_size, size, dt, label))
            log(f"device {profile} {size}: {2 * reps} rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the *_dist.csv series")
    ap.add_argument("--sizes", default=SIZES)
    ap.add_argument("--backends", default="cpu,device")
    ap.add_argument("--profiles", default="fast,dense", help="the device series' profiles")
    ap.add_argument("--cpu-reps", type=int, default=1000)
    ap.add_argument("--dev-reps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backends = args.backends.split(",")
    dev = device_of(args.device) if "device" in backends else None
    sizes = [int(s) for s in args.sizes.split(",")]
    log = make_log()
    os.makedirs(args.out, exist_ok=True)
    if "cpu" in backends:
        cpu_series(args.out, sizes, args.cpu_reps, log)
    if "device" in backends:
        device_series(args.out, sizes, args.profiles.split(","), args.dev_reps, dev, log)
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
