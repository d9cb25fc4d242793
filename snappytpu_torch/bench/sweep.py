"""Benchmark sweeps producing reference-style CSV series — the port's
counterpart of snappytpu.bench.sweep.

The reference's Test_results/ holds 4 repeated-run CSV series (hash, alt,
BST compressors and decompression) over a 500 B..1 MB size grid
(snappy_test.c:7, result.c:67-95).  This module reproduces that shape for
any backend/profile so new numbers are directly comparable, and adds a
--mesh mode that measures the block-parallel mesh codec
(snappytpu_torch.mesh.sharding) over every visible card, or over
--mesh-shards slots of the one CPU device: sharding overhead as a number.
The mesh encodes with --profile, as its series' tag says (the JAX sweep's
mesh mode encoded dense whatever the tag).

The `device` backend and the mesh run on --device (default cuda; they
refuse to run without a card unless the caller names the CPU).  The JAX
sweep's --real-file-mb point reads the Silesia stand-in, whose files the
port's bench/corpus.py leaves out (F2 in ROADMAP.md): it raises here.  The
caller names the output directory (the JAX sweep defaulted to
Test_results_tpu/, which holds the TPU's history).

Run: python -m snappytpu_torch.bench.sweep --backend device --profile dense \
         --out results_h100
"""

from __future__ import annotations

import argparse
import functools
import os
import time

from . import corpus
from .metrics import Result, write_result_csv

SIZES = [500, 1000, 5000, 10000, 50000, 100000, 500000, 1000000]


def _codec(backend: str, profile: str, device):
    if backend == "device":
        from .. import api

        return (functools.partial(api.compress, profile=profile, device=device),
                functools.partial(api.decompress, device=device))
    if backend == "cpu":
        from .. import cpu

        if not cpu.available:
            raise RuntimeError("native backend unavailable")
        return cpu.compress, cpu.decompress
    from .. import model

    return model.compress, model.decompress


def _mesh_codec(profile: str, device, n_shards):
    """End-to-end mesh compress/decompress over the mesh's shards."""
    import numpy as np

    from .. import cpu
    from ..format import constants as C
    from ..format.varint import encode_varint
    from ..mesh import sharding
    from ..stream import framing

    mesh = sharding.make_mesh(n_shards, device)

    def _compact(rows: np.ndarray, lens: np.ndarray) -> bytes:
        if cpu.available:
            return cpu.compact(rows, lens)
        return b"".join(rows[i, : int(lens[i])].tobytes() for i in range(rows.shape[0]))

    def compress(data: bytes) -> bytes:
        arr = np.frombuffer(data, np.uint8)
        blocks, lens = framing.pack_blocks(arr)
        comp, totals = sharding.encode_mesh(mesh, blocks, lens, profile)
        return encode_varint(arr.size) + _compact(comp, totals)

    def decompress(stream: bytes) -> bytes:
        arr = np.frombuffer(stream, np.uint8)
        out_len, start = framing.read_preamble(arr)
        if cpu.available:
            offs, out_lens = cpu.scan_ops(arr[start:], out_len)
            padded, comp_lens = cpu.split_rows(
                arr[start:], offs, C.MAX_COMPRESSED_BLOCK_SIZE
            )
            out_lens = out_lens.astype(np.int32)
        else:
            chunks, out_lens_list = framing.split_ops_stream(arr[start:], out_len)
            padded, comp_lens = framing.pad_chunks(chunks)
            out_lens = np.asarray(out_lens_list, np.int32)
        out, ok = sharding.decode_mesh(mesh, padded, comp_lens, out_lens)
        if not ok.all():
            raise RuntimeError("mesh decode flagged corrupt blocks")
        return _compact(out, out_lens)

    return compress, decompress, len(mesh)


def _best_of(fn, reps):
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def run_sweep(out_dir: str, backend: str = "cpu", profile: str = "dense", reps: int = 5,
              sizes=SIZES, real_file_mb: int = 0, mesh: bool = False, n_hosts: int = 1,
              *, device="cuda", mesh_shards: int | None = None) -> list[Result]:
    """Compress and decompress mixed-corpus inputs of each size (best of
    reps), appending a row per phase to compression_results_<tag>.csv and
    decompression_results_<tag>.csv under out_dir; round trips asserted.
    mesh_shards: the mesh's width (default every visible card, or one CPU
    slot)."""
    if real_file_mb:
        raise ValueError("--real-file-mb needs the Silesia stand-in, whose reference-checkout files are absent "
                         "(F2 in ROADMAP.md) and which the port's bench/corpus.py leaves out")
    os.makedirs(out_dir, exist_ok=True)
    n_chips = 1
    if mesh:
        compress, decompress, n_chips = _mesh_codec(profile, device, mesh_shards)
        tag = f"mesh{n_chips}_{profile}"
    else:
        compress, decompress = _codec(backend, profile, device)
        tag = f"{backend}_{profile}"
    comp_csv = os.path.join(out_dir, f"compression_results_{tag}.csv")
    dec_csv = os.path.join(out_dir, f"decompression_results_{tag}.csv")

    results = []
    for size in sizes:
        data = corpus.mixed(size, seed=size)
        compress(data)  # warm (allocator, native library)
        comp, best_c = _best_of(lambda: compress(data), reps)
        r = Result("compress", size, len(comp), best_c, backend, n_chips, n_hosts)
        write_result_csv(comp_csv, r)
        results.append(r)

        out = decompress(comp)
        if out != data:
            raise AssertionError(f"round trip mismatch at size {size}")
        out, best_d = _best_of(lambda: decompress(comp), reps)
        r = Result("decompress", len(comp), size, best_d, backend, n_chips, n_hosts)
        write_result_csv(dec_csv, r)
        results.append(r)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backend", default="cpu", choices=["device", "cpu", "model"])
    p.add_argument("--profile", default="dense", choices=["dense", "fast"])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", required=True, help="directory for the CSV series")
    p.add_argument("--real-file-mb", type=int, default=0,
                   help="a Silesia-stand-in point of this many MB: refused (its files are absent)")
    p.add_argument("--mesh", action="store_true",
                   help="measure the mesh codec over every visible card (or --mesh-shards)")
    p.add_argument("--mesh-shards", type=int, default=None, help="the mesh's width")
    p.add_argument("--device", default="cuda", help="torch device of the device backend and the mesh (default cuda)")
    args = p.parse_args(argv)
    for r in run_sweep(args.out, args.backend, args.profile, args.reps, real_file_mb=args.real_file_mb,
                       mesh=args.mesh, device=args.device, mesh_shards=args.mesh_shards):
        print(r.report())
        print()


if __name__ == "__main__":
    main()
