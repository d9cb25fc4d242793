"""Dense-profile tier-B/tier-A configuration matrix — the counterpart of the
JAX package's tools/enc_variants.py: each configuration of CONFIGS threaded
through encode_block_core's knobs on --device, and its dense size on every
fixture of tools/enc_sizes.py.

    python -m snappytpu_torch.tools.enc_variants [--configs base16,k12samp]
        [--ref-cli PATH] [--real-dir DIR] [--device cuda]

With --ref-cli (a built reference binary) each configuration reads PASS or
FAIL against the strict-size contract (dense <= min(reference -c, -b) per
fixture), with its worst margin and every margin under 200 bytes, as in the
JAX tool.  Without it the tool prints each configuration's sizes alone.
--configs stands for the JAX tool's ENCVAR (default: all).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..format.varint import encode_varint
from ..kernels.encode_v2 import encode_block_core
from ..stream import framing
from ._staged import device_of
from .enc_sizes import fixtures, ref_best

K12SAMP = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15)
K10SAMP = (0, 1, 2, 3, 4, 6, 8, 10, 12, 14)

CONFIGS = {
    "base16": dict(),
    "k12": dict(dense_keys=tuple(range(12))),
    "k10": dict(dense_keys=tuple(range(10))),
    "k8": dict(dense_keys=tuple(range(8))),
    "k8+a5": dict(dense_keys=tuple(range(8)), a_ranks=(1, 2, 3, 4, 5)),
    "k8+a6": dict(dense_keys=tuple(range(8)), a_ranks=(1, 2, 3, 4, 5, 6)),
    "k8+b3": dict(dense_keys=tuple(range(8)), b_ranks=(1, 2, 3)),
    "k10samp": dict(dense_keys=K10SAMP),
    "k10samp+b3": dict(dense_keys=K10SAMP, b_ranks=(1, 2, 3)),
    "k12samp": dict(dense_keys=K12SAMP),
    "k12samp+a5": dict(dense_keys=K12SAMP, a_ranks=(1, 2, 3, 4, 5)),
    "k12samp+a6": dict(dense_keys=K12SAMP, a_ranks=(1, 2, 3, 4, 5, 6)),
    "k10samp+a6": dict(dense_keys=K10SAMP, a_ranks=(1, 2, 3, 4, 5, 6)),
    "k13samp": dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 15)),
    "k14": dict(dense_keys=tuple(range(14))),
    "k14samp": dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 15)),
}


def dense_size(data: bytes, device, **kw) -> int:
    """The dense stream's size of data under the matcher knobs kw (one
    encoder call: every fixture is at most 128 blocks)."""
    arr = np.frombuffer(data, np.uint8)
    if arr.size == 0:
        return 1
    blocks, lens = framing.pack_blocks(arr)
    _comp, totals = encode_block_core(torch.from_numpy(blocks).to(device),
                                      torch.from_numpy(np.asarray(lens, np.int32)).to(device), True, **kw)
    t = totals.cpu().numpy()
    if (t < 0).any():
        raise RuntimeError("capacity overflow")
    return len(encode_varint(arr.size)) + int(t.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", help="comma list of CONFIGS names (default: all)")
    ap.add_argument("--ref-cli", help="a built reference binary")
    ap.add_argument("--real-dir", help="a directory of real files to add")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    configs = CONFIGS
    if args.configs:
        unknown = set(args.configs.split(",")) - set(CONFIGS)
        if unknown:
            raise ValueError(f"unknown configurations {sorted(unknown)}")
        configs = {k: v for k, v in CONFIGS.items() if k in args.configs.split(",")}
    fix = sorted(fixtures(args.real_dir).items())
    ref = {name: ref_best(args.ref_cli, data) for name, data in fix} if args.ref_cli else None
    for cname, kw in configs.items():
        sizes = [(name, dense_size(data, dev, **kw)) for name, data in fix]
        if ref is None:
            print(f"{cname:12s} " + " ".join(f"{n}:{s}" for n, s in sizes), flush=True)
            continue
        margins = [(n, ref[n] - s) for n, s in sizes]
        worst = min(margins, key=lambda m: m[1])
        tag = "PASS" if worst[1] >= 0 else "FAIL"
        detail = " ".join(f"{n}:{m:+d}" for n, m in margins if m < 200)
        print(f"{tag} {cname:12s} worst {worst[0]}:{worst[1]:+d} | {detail}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
