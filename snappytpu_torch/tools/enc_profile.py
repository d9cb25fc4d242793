"""Full-encoder timing A/B — the counterpart of the JAX package's
tools/enc_profile.py: stages the bench corpus once, then times
encode_block_core for each (profile, nsec[, preset]) configuration, best of
3 passes over the NQ batches, and prints ms per batch, MB/s (input bytes),
the ratio and the compressed bytes of all batches.

    python -m snappytpu_torch.tools.enc_profile [--cfgs fast:16,fast:32,dense:16,dense:32]
        [--nq 4] [--b 128] [--device cuda]

A configuration is `profile:nsec` with an optional third token naming a
matcher preset of PRESETS (`dense:64:k12samp`).  The flags are the JAX
tool's SNAPPYTPU_ENC_CFGS and SNAPPYTPU_ENC_NQ with their defaults, its B,
and the device.  Wire bytes do not depend on nsec, so within a profile and
preset the ratio is the same at every nsec.  On the card the time comes from
CUDA events around each pass's queued calls.
"""

from __future__ import annotations

import argparse
import sys

from ..format import constants as C

from ..kernels import encode_v2 as E
from ._staged import best_per_batch, device_of, encoder_sets, make_log
from .enc_variants import CONFIGS

# the optional third token selects a matcher-kwarg preset: the configurations
# of tools/enc_variants.py that the JAX tool timed
PRESETS = {"": {}, **{k: CONFIGS[k] for k in ("k12samp", "k12samp+a5", "k10samp+a6", "k14samp", "k13samp")}}


def parse_cfg(cfg: str):
    """`profile:nsec[:preset]` -> (dense, nsec, matcher kwargs)."""
    parts = cfg.split(":")
    if len(parts) not in (2, 3) or parts[0] not in ("fast", "dense"):
        raise ValueError(f"a configuration is fast|dense:nsec[:preset], got {cfg!r}")
    return parts[0] == "dense", int(parts[1]), PRESETS[parts[2] if len(parts) > 2 else ""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfgs", default="fast:16,fast:32,dense:16,dense:32")
    ap.add_argument("--nq", type=int, default=4, help="batches")
    ap.add_argument("--b", type=int, default=128, help="blocks per batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    cfgs = [(cfg, *parse_cfg(cfg)) for cfg in args.cfgs.split(",")]
    log = make_log()
    B = args.b
    log(f"device {dev}")
    batches = encoder_sets(B, args.nq, dev)
    log("inputs staged")
    nbytes = args.nq * B * C.MAX_BLOCK_SIZE
    for cfg, dense, nsec, kw in cfgs:

        def run(b, n, dense=dense, nsec=nsec, kw=kw):
            return E.encode_block_core(b, n, dense, nsec=nsec, **kw)

        totals = [run(*a)[1] for a in batches]
        if any(bool((t < 0).any()) for t in totals):
            raise RuntimeError(f"{cfg}: the encoder poisoned a block (a section overflowed)")
        tot = sum(int(t.sum()) for t in totals)
        best = best_per_batch(run, batches, 3)
        prof, _, rest = cfg.partition(":")
        log(f"encode {prof}:{rest:>3s}  {best * 1000:8.2f} ms/batch  {B * C.MAX_BLOCK_SIZE / 1e6 / best:7.1f} MB/s  "
            f"ratio {nbytes / max(tot, 1):.3f}  ({tot} bytes)")
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
