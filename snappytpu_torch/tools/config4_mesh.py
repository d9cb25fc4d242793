"""BASELINE config 4 on the port: 100 MB of text-heavy (enwik8-analog) input
through encode_mesh/decode_mesh, the counterpart of the JAX tool
tools/config4_mesh.py's `cpu8` check.

    python -m snappytpu_torch.tools.config4_mesh [--mb 100] [--shards N] [--device cuda|cpu]

The input is corpus.text(MB << 20, seed=8).  The mesh's dense stream must
equal api.compress(..., "dense") on the same device byte for byte, and
decode_mesh must give the input back; any difference raises.  On the card
the mesh has every visible card (--shards to choose); on the CPU
(--device cpu --shards 8) it is the JAX check's eight-way mesh.  The times
printed here are wall clock around each host-array call, with the device
synchronised; the JAX tool's `tpu1` rows (the sharded calls on
device-resident shards) are taken by chip_smoke.py's phase 15 through
mesh.sharded_encode / sharded_decode.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def check(mb: int = 100, shards: int | None = None, *, device="cuda", log=print) -> dict:
    """Run the check; returns the stream's size, the mesh's width, the wall
    seconds of the mesh encode, api.compress and the mesh decode, and the
    arrays: `input` (blocks, lens) and `rows` (the mesh's comp, totals)."""
    from .. import api
    from ..bench import corpus
    from ..mesh import sharding
    from ..stream import framing

    def timed(fn):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    data = np.frombuffer(corpus.text(mb << 20, seed=8), np.uint8)[: mb << 20]
    blocks, lens = framing.pack_blocks(data)
    B = blocks.shape[0]
    mesh = sharding.make_mesh(shards, device)
    log(f"[config4] {data.size} bytes of text packed in {B} blocks ({time.perf_counter() - t0:.1f} s); "
        f"mesh of {len(mesh)} shard(s) on {mesh[0]}")
    (comp, totals), enc_s = timed(lambda: sharding.encode_mesh(mesh, blocks, lens, profile="dense"))
    stream = framing.assemble_stream(comp, totals, int(data.size))
    single, api_s = timed(lambda: api.compress(data, "dense", device=device))
    if stream != single:
        raise AssertionError("mesh-assembled stream != single-path api.compress stream")
    log(f"[config4] mesh encode {enc_s * 1e3:.1f} ms ({data.size / 1e6 / enc_s:.1f} MB/s); assembled stream "
        f"byte-identical to api.compress ({len(stream)} B, ratio {data.size / len(stream):.3f}; api.compress "
        f"{api_s * 1e3:.1f} ms)")
    (out, ok), dec_s = timed(lambda: sharding.decode_mesh(mesh, comp, totals, lens))
    if not ok.all():
        raise AssertionError("mesh decode flagged corrupt blocks")
    if out.reshape(-1)[: data.size].tobytes() != data.tobytes():
        raise AssertionError("mesh round trip mismatch")
    log(f"[config4] mesh decode {dec_s * 1e3:.1f} ms ({data.size / 1e6 / dec_s:.1f} MB/s); "
        f"{len(mesh)}-shard ordered-gather round trip exact: CONFIG-4 OK")
    return dict(bytes=int(data.size), blocks=B, stream_bytes=len(stream), shards=len(mesh),
                encode_s=enc_s, api_compress_s=api_s, decode_s=dec_s, input=(blocks, lens), rows=(comp, totals))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mb", type=int, default=100)
    p.add_argument("--shards", type=int, default=None, help="mesh width (default every card, or 1 CPU slot)")
    p.add_argument("--device", default="cuda", help="torch device type of the mesh (default cuda)")
    args = p.parse_args(argv)
    check(args.mb, args.shards, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
