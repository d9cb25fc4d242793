"""Large-input single-card benchmark (BASELINE config 3's analog) — the
counterpart of the JAX package's tools/bigfile_bench.py: device compute on
resident data, per profile the encode and the device-resident decode of
the whole input, best of 2 passes each, with the round trip checked on the
device.

    python -m snappytpu_torch.tools.bigfile_bench --out DIR [--mb 128]
        [--profiles dense,fast] [--device cuda]

The input is corpus.silesia_standin(MB << 20), as in the JAX tool: the
synthetic corpus.mixed(MB << 20, seed=99), as the JAX one's is without the
reference checkout.  It is staged once as
batches of 128 blocks (the last one shorter when the input is not a
multiple of 8 MiB); the encoder's rows stay on the device for the decode.
The round trip is checked there: every block's ok flag and every block
equal to the input, or the tool raises.  On the card each pass is timed
by CUDA events around its queued calls.  Rows of
compression_results_device_<profile>.csv and
decompression_results_device_<profile>.csv (metrics.write_result_csv's
schema; decompression speed on the compressed bytes, as the reference's)
go to --out; a row's backend column names the device (`device` on the
card, `cpu` for the plain versions under --device cpu).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..bench import corpus, metrics
from ..kernels.decode_vm import decode_blocks_vm
from ..kernels.encode_v2 import encode_block_core
from ..stream import framing
from ._staged import best_per_batch, device_of, make_log

CHUNK = 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the CSV rows")
    ap.add_argument("--mb", type=int, default=128, help="input size in MiB")
    ap.add_argument("--profiles", default="dense,fast")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    label = "device" if dev.type == "cuda" else "cpu"
    log = make_log()
    os.makedirs(args.out, exist_ok=True)

    log(f"device {dev}; building {args.mb} MB silesia stand-in")
    data = np.frombuffer(corpus.silesia_standin(args.mb << 20)[: args.mb << 20], np.uint8)
    blocks_np, lens_np = framing.pack_blocks(data)
    B = blocks_np.shape[0]
    starts = range(0, B, CHUNK)
    bl = [torch.from_numpy(blocks_np[s : s + CHUNK]).to(dev) for s in starts]
    ll = [torch.from_numpy(np.asarray(lens_np[s : s + CHUNK], np.int32)).to(dev) for s in starts]
    log(f"staged {len(bl)} batches of up to {CHUNK} blocks")

    for profile in args.profiles.split(","):
        dense = profile != "fast"

        def enc(b, n, dense=dense):
            return encode_block_core(b, n, dense)

        batches = list(zip(bl, ll))
        best = best_per_batch(enc, batches, 2) * len(batches)
        comp_dev = [enc(b, n) for b, n in batches]
        if any(bool((t < 0).any()) for _c, t in comp_dev):
            raise RuntimeError(f"{profile}: the encoder poisoned a block")
        tot = sum(int(t.sum()) for _c, t in comp_dev)
        r = metrics.Result("compress", int(data.size), tot, best, label)
        metrics.write_result_csv(os.path.join(args.out, f"compression_results_device_{profile}.csv"), r)
        log(f"encode {profile}: {best * 1000:.1f} ms, {r.speed_mbps:.1f} MB/s, ratio {r.comp_ratio:.3f}")

        dec_sets = [(c, t, n) for (c, t), n in zip(comp_dev, ll)]
        okc = mc = 0
        for (c, t, n), b in zip(dec_sets, bl):
            out, ok = decode_blocks_vm(c, t, n)
            okc += int(ok.sum())
            mc += int((out == b).all(dim=1).sum())
        if okc != B:
            raise AssertionError(f"{profile}: decode flagged {B - okc} blocks corrupt")
        if mc != B:
            raise AssertionError(f"{profile}: round trip mismatch on {B - mc} blocks")
        best = best_per_batch(decode_blocks_vm, dec_sets, 2) * len(dec_sets)
        r = metrics.Result("decompress", tot, int(data.size), best, label)
        metrics.write_result_csv(os.path.join(args.out, f"decompression_results_device_{profile}.csv"), r)
        log(f"decode {profile}: {best * 1000:.1f} ms, {r.speed_mbps:.1f} MB/s (comp-byte basis), "
            f"uncompressed {int(data.size) / best / 1e6:.1f} MB/s, blocks exact {mc}/{B}")
        del comp_dev, dec_sets
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
