"""Which encoder stage grows under the mesh — the counterpart of the JAX
package's tools/mesh_stage_probe.py: progressively longer encoder prefixes
(find / +inherit+elect / +reglue / full) timed on the same resident
batches, called directly and through the mesh's per-shard call on
make_mesh(1).

    python -m snappytpu_torch.tools.mesh_stage_probe [--b 128] [--nq 4]
        [--profile fast] [--device cuda]

The batches are corpus.mixed(B * 64 KiB, seed=100 + q), staged once on the
mesh's device.  Each prefix ends in a reduction per block (int64) of the
JAX tool's samples of its last stage's outputs, so that the mesh can
concatenate it: the mesh side is sharding._each_shard, the call under
sharded_encode, on one-shard lists.  Each side's ms per batch is the best
of 3 passes (_staged.best_per_batch); the mesh's reductions must equal the
direct ones.  The prefix whose mesh/direct difference jumps is where the
mesh costs time.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import encode_v2 as E
from ..mesh import sharding
from ._staged import best_per_batch, device_of, encoder_sets, make_log

PREFIXES = ("find", "elect", "reglue", "full")
_I64 = torch.int64


def prefix_fn(upto: str, dense: bool):
    """The encoder run up to `upto`, reduced per block -> ((B,) int64,)."""

    def f(b, n):
        tiers = E._find_matches(b, n, dense=dense)
        if upto == "find":
            return (sum(t[0][:, ::97].sum(1, dtype=_I64) for t in tiers),)
        is_copy, ad, lead, tail = E._elect(tiers, E._inherit(tiers, n), n)
        if upto == "elect":
            return (ad[:, ::17].sum(1, dtype=_I64) + lead.sum(1, dtype=_I64) + tail.sum(1, dtype=_I64),)
        is_copy, ad, lead, tail = E._reglue(b, is_copy, ad, lead, tail, n)
        if upto == "reglue":
            return (ad[:, ::17].sum(1, dtype=_I64) + lead.sum(1, dtype=_I64) + tail.sum(1, dtype=_I64),)
        comp, totals = E._emit(b, is_copy, ad, lead, tail, n)
        return (totals.to(_I64) + comp[:, ::997].sum(1, dtype=_I64),)

    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128, help="blocks per batch")
    ap.add_argument("--nq", type=int, default=4, help="batches")
    ap.add_argument("--profile", default="fast", choices=["fast", "dense"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    log = make_log()
    dense = args.profile != "fast"
    mesh = tuple(sharding.make_mesh(1, dev))
    log(f"device {dev}; mesh {list(mesh)}; profile {args.profile}")
    batches = encoder_sets(args.b, args.nq, mesh[0])
    mesh_batches = [([b], [n]) for b, n in batches]
    log("staged")
    for upto in PREFIXES:
        f = prefix_fn(upto, dense)

        def meshy(blocks, lens, f=f):
            return sharding._each_shard(mesh, f, (blocks, lens), (((), _I64),))

        td = best_per_batch(f, batches)
        tm = best_per_batch(meshy, mesh_batches)
        for q, (a, m) in enumerate(zip(batches, mesh_batches)):
            if not torch.equal(f(*a)[0], meshy(*m)[0][0]):
                raise AssertionError(f"{upto}, batch {q}: the mesh's reduction differs from the direct call's")
        log(f"{upto:7s} direct {td * 1000:8.2f} ms  mesh1 {tm * 1000:8.2f} ms  "
            f"delta {(tm - td) * 1000:+7.2f} ms ({(tm / td - 1) * 100:+.1f}%)")
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
