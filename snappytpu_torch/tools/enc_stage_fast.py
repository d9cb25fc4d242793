"""Fast-profile encoder stage breakdown — the counterpart of the JAX
package's tools/enc_stage_fast.py: the fast stages, `_emit` whole and its
geometry alone (the "total-only" line), the full fast encoder, then the
port's own sorts and sort-back at the match tiers' shapes, as ms per batch and MB/s
(input bytes), best of 3 passes over the NQ batches.

    python -m snappytpu_torch.tools.enc_stage_fast [--b 128] [--nq 4] [--device cuda]

The JAX tool timed `lax.sort` at the tiers' shapes; the port orders its
tiers with stable `torch.sort` passes and gathers, and inverts the order by
a scatter, so its lines time those, on int64 data (the port's key words)
from a seeded torch.Generator, each labelled with the JAX line it stands
for.  On the card the time comes from CUDA events around each pass's
queued calls.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import encode_v2 as E
from . import stage_profile
from ._staged import device_of, encoder_sets, make_log


def prof(log, name: str, fn, argsets, B: int) -> float:
    return stage_profile.prof(log, name, fn, argsets, B, reps=3, width=58)


def sort_sets(B: int, NQ: int, device, seed: int = 0):
    """Random int64 words in [0, 2^30) at the tiers' shapes, per batch q:
    tier A (key + 3 carried words, 64 Ki columns), tier B fast (6 keys + 11
    words, 16 Ki), tier B trim (6 keys + 1 word, 16 Ki), and for the
    sort-back a random permutation of 64 Ki columns per row with int32
    lengths and candidates, the positions and full block lengths."""
    g = torch.Generator().manual_seed(seed)
    W = E.BS

    def rnd(w, k):
        return [torch.randint(0, 1 << 30, (B, w), generator=g, dtype=torch.int64).to(device) for _ in range(k)]

    sets = {"A": [], "B": [], "Btrim": [], "back": []}
    for _ in range(NQ):
        sets["A"].append(tuple(rnd(W, 4)))
        sets["B"].append((rnd(W // 4, 6), rnd(W // 4, 11)))
        sets["Btrim"].append((rnd(W // 4, 6), rnd(W // 4, 1)))
        perm = torch.randint(0, 1 << 30, (B, W), generator=g).argsort(dim=1).to(device)
        blen, bcand = (x.to(torch.int32) for x in rnd(W, 2))
        pos = torch.arange(W, dtype=torch.int32, device=device).expand(B, W)
        sets["back"].append((perm, blen, bcand, pos, torch.full((B,), W, dtype=torch.int32, device=device)))
    return sets


def tier_a(key, *words):
    """Tier A's order: one stable sort, then the key and its carried words gathered."""
    order = torch.sort(key, dim=1, stable=True).indices
    return [torch.gather(x, 1, order) for x in (key, *words)]


def tier_b(keys, words):
    """Tier B's order: `_lex_order` over the keys, then the words gathered."""
    order = E._lex_order(keys)
    return [torch.gather(x, 1, order) for x in words]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128, help="blocks per batch")
    ap.add_argument("--nq", type=int, default=4, help="batches")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    log = make_log()
    B = args.b
    log(f"device {dev}")
    batches = encoder_sets(B, args.nq, dev)
    log("inputs staged")

    prof(log, "find fast", lambda b, n: E._find_matches(b, n, False), batches, B)
    tier_sets = [E._find_matches(b, n, False) for b, n in batches]
    prof(log, "inherit", E._inherit, [(t, n) for t, (_b, n) in zip(tier_sets, batches)], B)
    el_args = [(t, E._inherit(t, n), n) for t, (_b, n) in zip(tier_sets, batches)]
    prof(log, "elect", E._elect, el_args, B)
    rg_args = [(b, *E._elect(*a), n) for a, (b, n) in zip(el_args, batches)]
    del tier_sets, el_args
    prof(log, "reglue", E._reglue, rg_args, B)
    em_args = [(b, *E._reglue(*a), n) for a, (b, n) in zip(rg_args, batches)]
    del rg_args
    prof(log, "emit full", E._emit, em_args, B)
    prof(log, "emit total-only (geometry: _emit_geometry)", E._emit_geometry, em_args, B)
    del em_args
    prof(log, "encode full fast", lambda b, n: E.encode_block_core(b, n, False), batches, B)

    sets = sort_sets(B, args.nq, dev)
    prof(log, "sort tierA shape (1key+4ops, 64k): sort + 4 gathers", tier_a, sets["A"], B)
    prof(log, "sort tierB fast (6key+11ops, 16k): _lex_order + 11 gathers", tier_b, sets["B"], B)
    prof(log, "sort tierB-trim (6key+1op, 16k): _lex_order + 1 gather", tier_b, sets["Btrim"], B)
    prof(log, "sort sortback (1key+1op, 64k): _sort_back, a scatter + 2 gathers", E._sort_back, sets["back"], B)
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
