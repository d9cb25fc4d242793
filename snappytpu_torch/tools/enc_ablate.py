"""Fast-encoder ablation timing — the counterpart of the JAX package's
tools/enc_ablate.py: nine variants of the fast encoder, each with one piece
taken out or one knob turned, timed on the same staged batches, best of 3
passes over the NQ batches, with each variant's difference from the full
encoder.  The variants that take a piece out produce wire-invalid rows
(measurement only).

    python -m snappytpu_torch.tools.enc_ablate [--b 128] [--nq 4] [--device cuda]

On the card the time comes from CUDA events around each pass's queued calls.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import encode_v2 as E
from ._staged import best_per_batch, device_of, encoder_sets, make_log


def pipe(b, n, *, tier_b=True, run_tiers=True, use_reglue=True, use_inherit=True, a_ranks=None, nsec=None):
    """The fast encoder with the ablation's levers.  A tier taken out is
    not computed (the JAX tool dropped it from the tier list and XLA
    eliminated its code; torch runs what it is given)."""
    mw = E._match_words(b, n)
    tiers = [E._tier_a(mw, False, a_ranks)]
    if tier_b:
        tiers.append(E._tier_b(mw, False))
    if run_tiers:
        tiers.extend(E._run_tier(b, n))
    if use_inherit:
        inh = E._inherit(tiers, n)
    else:  # no inherited match anywhere (reach -1, dist 0, start -1)
        shape = (b.shape[0], E.NA)
        inh = (torch.full(shape, -1, dtype=torch.int32, device=b.device),
               torch.zeros(shape, dtype=torch.int32, device=b.device),
               torch.full(shape, -1, dtype=torch.int32, device=b.device))
    ic, ad, ld, tl = E._elect(tiers, inh, n)
    if use_reglue:
        ic, ad, ld, tl = E._reglue(b, ic, ad, ld, tl, n)
    return E._emit(b, ic, ad, ld, tl, n, nsec=nsec)


VARIANTS = {
    "full fast": {},
    "no reglue": dict(use_reglue=False),
    "no inherit": dict(use_inherit=False),
    "no run tiers": dict(run_tiers=False),
    "no tier B": dict(tier_b=False),
    "a_ranks (1,2)": dict(a_ranks=(1, 2)),
    "a_ranks (1,2,3,4)": dict(a_ranks=(1, 2, 3, 4)),
    "nsec 32": dict(nsec=32),
    "nsec 128": dict(nsec=128),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128, help="blocks per batch")
    ap.add_argument("--nq", type=int, default=4, help="batches")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    log = make_log()
    log(f"device {dev}")
    batches = encoder_sets(args.b, args.nq, dev)
    log("staged")
    full = None
    for name, kw in VARIANTS.items():
        best = best_per_batch(lambda b, n, kw=kw: pipe(b, n, **kw), batches, 3)
        full = best if full is None else full
        log(f"{name:28s} {best * 1000:8.2f} ms/batch  ({(best - full) * 1000:+8.2f} ms against full fast)")
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
