"""What a one-device mesh call costs beyond the codec — the counterpart of
the JAX package's tools/mesh_device_bench.py: the same encoder and block
decoder timed twice on identical resident batches, called directly and
through the mesh's sharded calls on make_mesh(1), with a reference-schema
mesh1-device row per phase.

    python -m snappytpu_torch.tools.mesh_device_bench --out DIR [--b 128]
        [--nq 4] [--profile fast] [--device cuda]

The batches are corpus.mixed(B * 64 KiB, seed=100 + q), staged once on the
mesh's device.  Direct: `encode_block_core` and `decode_blocks_vm` per
batch; mesh: `sharded_encode(mesh, dense)` and `sharded_decode(mesh)` per
batch, each given one-shard lists of the same tensors.  Each side's ms per
batch is the best of 3 passes (CUDA events on the card, the host clock on
the CPU; _staged.best_per_batch), and the difference is the mesh's
overhead: its per-shard slicing, calls and concatenation (a one-device
mesh gathers nothing).  The mesh's rows, totals, outputs and flags must
equal the direct calls', and the decode must give the input back, or the
tool raises.  Rows of compression_results_mesh1_device_<profile>.csv and
decompression_results_mesh1_device_<profile>.csv (metrics.write_result_csv's
schema, backend `device-mesh1`, the mesh's time for all NQ batches) go
only to --out.  The flags are the JAX tool's SNAPPYTPU_MESH_* variables and
its B with their defaults.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..bench import metrics
from ..format import constants as C
from ..kernels.decode_vm import decode_blocks_vm
from ..kernels.encode_v2 import encode_block_core
from ..mesh import sharding
from ._staged import best_per_batch, device_of, encoder_sets, make_log

LABEL = "device-mesh1"


def _compare(log, what: str, td: float, tm: float, nbytes: int) -> None:
    mb = nbytes / 1e6
    log(f"{what}: direct {td * 1000:8.2f} ms/batch ({mb / td:6.1f} MB/s)  mesh1 {tm * 1000:8.2f} ms/batch "
        f"({mb / tm:6.1f} MB/s)  overhead {(tm - td) * 1000:+6.2f} ms ({(tm / td - 1) * 100:+.1f}%)")


def _same(what: str, direct, mesh) -> None:
    """Raise unless every mesh output (one-shard lists) equals the direct one."""
    if len(direct) != len(mesh):
        raise AssertionError(f"{what}: {len(mesh)} mesh batches against {len(direct)} direct ones")
    for q, (d, m) in enumerate(zip(direct, mesh)):
        if len(d) != len(m) or any(len(y) != 1 for y in m):
            raise AssertionError(f"{what}, batch {q}: the mesh gave {[len(y) for y in m]} shards of "
                                 f"{len(m)} outputs against {len(d)} direct outputs")
        if not all(torch.equal(x, y[0]) for x, y in zip(d, m)):
            raise AssertionError(f"{what}, batch {q}: the mesh's outputs differ from the direct call's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the CSV rows")
    ap.add_argument("--b", type=int, default=128, help="blocks per batch")
    ap.add_argument("--nq", type=int, default=4, help="batches")
    ap.add_argument("--profile", default="fast", choices=["fast", "dense"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    log = make_log()
    B, NQ, dense = args.b, args.nq, args.profile != "fast"
    mesh = sharding.make_mesh(1, dev)
    log(f"device {dev}; mesh {mesh}")
    batches = encoder_sets(B, NQ, mesh[0])
    log("inputs staged")
    nbytes = B * C.MAX_BLOCK_SIZE

    # ---- encode: direct against sharded_encode over mesh(1) ----
    enc_mesh = sharding.sharded_encode(mesh, dense)
    mesh_batches = [([b], [n]) for b, n in batches]
    td = best_per_batch(lambda b, n: encode_block_core(b, n, dense), batches)
    tm = best_per_batch(enc_mesh, mesh_batches)
    _compare(log, f"encode {args.profile}", td, tm, nbytes)
    comp_dev = [encode_block_core(b, n, dense) for b, n in batches]
    _same(f"encode {args.profile}", comp_dev, [enc_mesh(*a) for a in mesh_batches])
    if any(bool((t < 0).any()) for _c, t in comp_dev):
        raise RuntimeError(f"{args.profile}: the encoder poisoned a block")
    tot = sum(int(t.sum()) for _c, t in comp_dev)
    os.makedirs(args.out, exist_ok=True)
    r = metrics.Result("compress", NQ * nbytes, tot, tm * NQ, LABEL)
    metrics.write_result_csv(os.path.join(args.out, f"compression_results_mesh1_device_{args.profile}.csv"), r)

    # ---- decode: direct against sharded_decode over mesh(1) ----
    dec_mesh = sharding.sharded_decode(mesh)
    dec_sets = [(c, t, n) for (c, t), (_b, n) in zip(comp_dev, batches)]
    mesh_sets = [tuple([x] for x in s) for s in dec_sets]
    td = best_per_batch(decode_blocks_vm, dec_sets)
    tm = best_per_batch(dec_mesh, mesh_sets)
    _compare(log, "decode", td, tm, nbytes)
    direct = [decode_blocks_vm(*s) for s in dec_sets]
    _same("decode", direct, [dec_mesh(*s) for s in mesh_sets])
    for q, ((out, ok), (b, _n)) in enumerate(zip(direct, batches)):
        if not (bool(ok.all()) and torch.equal(out, b)):
            raise AssertionError(f"decode, batch {q}: the round trip does not give the input back")
    r = metrics.Result("decompress", tot, NQ * nbytes, tm * NQ, LABEL)
    metrics.write_result_csv(os.path.join(args.out, f"decompression_results_mesh1_device_{args.profile}.csv"), r)
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
