"""The benchmark's objects, made from the seed in a few large torch calls.

`rdg` is the synthetic sample of zstd's benchmark (`zstd -b -P50`: zstd's
`programs/datagen.c`, `RDG_genBuffer`): a run of operations, each a match
with probability `match_proba` and a literal run otherwise.  As in
`RDG_genBlock`:

  length    with probability 3/4 uniform in 0-15, else uniform in 15-526;
            a match adds 4;
  match     with probability 1/16 the previous match's offset, else an
            offset uniform in 1-32,768, cut to the bytes written so far;
            the match copies forward, so an offset below its length repeats;
  literal   each byte drawn from an 8,192-entry table that holds '0' the
            most often, then '1', '2' ... '}', '(' ... with weights falling
            as `RDG_fillLiteralDistrib` sets them from `lit_proba`
            (`match_proba / 4.5` when 0);
  byte 0    a literal.

The C program draws its operations one at a time from one 32-bit stream;
here each random field has its own draws from a torch generator, so the
bytes differ from the C program's for any seed while every distribution is
its own.  An object's operations (kind, length, offset) are drawn once,
from a generator fixed for the object; the seed shuffles them and draws
the literals, so every seed gives the same amount of work.  A match's bytes are resolved by pointer jumping: every byte
points at the byte it copies, and the pointers are squared until each
names a literal.

The harness and the reference both call `make_object`, so each rebuilds the
same bytes from the seed on the same kind of device.  Nothing here imports
the program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

LT_LOG = 13  # the literal table holds 2**13 entries
SHORT_SHARE = 3  # (rand >> 7) & 3 != 0: a short length, 3 times in 4
REPEAT_CODE = 2  # (rand & 15) == 2: the previous match's offset
MAX_ROUNDS = 64  # pointer-jumping rounds before a chain is called broken: 2**64 bytes


def subseed(seed: int, *keys: str) -> int:
    """A 63-bit seed for one object, from the run's seed and the object's names."""
    h = hashlib.sha256(":".join([str(int(seed)), *keys]).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def literal_table(lit_proba: float) -> torch.Tensor:
    """`RDG_fillLiteralDistrib` with its fixed-point weight (24.8 bits)."""
    ld = int(lit_proba * 256 + 0.001)
    first, last, ch = (0, 255, 0) if ld <= 0 else (ord("("), ord("}"), ord("0"))
    size, u, table = 1 << LT_LOG, 0, []
    while u < size:
        end = min(u + (((size - u) * ld) >> 8) + 1, size)
        table += [ch] * (end - u)
        u, ch = end, (first if ch + 1 > last else ch + 1)
    return torch.tensor(table, dtype=torch.uint8)


@dataclass
class Plan:
    """The operations of one sample, each covering [start, end) of its bytes."""

    is_match: torch.Tensor  # bool
    length: torch.Tensor  # int64, as drawn (the last one may pass n)
    repeat: torch.Tensor  # bool: a match that takes the previous match's offset
    drawn: torch.Tensor  # int64: the offset drawn, 1-32,768, before the cut
    start: torch.Tensor  # int64
    end: torch.Tensor
    offset: torch.Tensor  # int64, read for matches only
    literals: torch.Tensor  # uint8: a drawn literal for every byte position


def plan(n: int, match_proba: float, lit_proba: float, g, device, layout=None) -> Plan:
    """Draw the operations and literals that cover n bytes.  The operations
    (kind, length, offset) come from `layout` (`g` where it is None) and
    their order and the literals from `g`: a layout fixed for an object
    gives every seed the same operations in another order, and a shuffled
    run of independent draws is such a run itself."""
    layout = g if layout is None else layout
    m = n // 40 + 64
    while True:
        r = torch.randint(0, 1 << 15, (6, m), generator=layout, device=device)
        is_match = r[0] < int(32768 * match_proba)
        short = (r[1] & SHORT_SHARE) != 0
        length = torch.where(short, r[2] & 15, (r[3] & 511) + 15) + 4 * is_match
        end = 1 + torch.cumsum(length, 0)
        if int(end[-1]) >= n:
            break
        m *= 2
    k = int(torch.searchsorted(end, n)) + 1  # the operations that cover the n bytes
    order = torch.randperm(k, generator=g, device=device)
    is_match, length, r = is_match[:k][order], length[:k][order], r[4:, :k][:, order]
    end = (1 + torch.cumsum(length, 0)).clamp(max=n)
    start = (1 + torch.cumsum(length, 0) - length).clamp(max=n)
    repeat = (r[0] & 15) == REPEAT_CODE
    fresh = is_match & ~repeat
    own = torch.minimum(r[1] + 1, start)
    last = torch.cummax(torch.where(fresh, torch.arange(k, device=device), -1), 0).values
    offset = torch.where(last >= 0, own[last.clamp(min=0)], 1)
    if lit_proba <= 0:
        lit_proba = match_proba / 4.5
    table = literal_table(lit_proba).to(device)
    literals = table[torch.randint(0, 1 << LT_LOG, (n,), generator=g, device=device)]
    return Plan(is_match, length, repeat, r[1] + 1, start, end, offset, literals)


def materialise(p: Plan, n: int) -> torch.Tensor:
    """The n bytes of a plan: each match byte takes the byte `offset` before it."""
    pos = torch.arange(n, device=p.literals.device)
    op = torch.searchsorted(p.end, pos, right=True).clamp(max=p.end.numel() - 1)
    copy = p.is_match[op] & (pos >= 1)
    src = torch.where(copy, pos - p.offset[op], pos)
    for _ in range(MAX_ROUNDS):
        nxt = src[src]
        if torch.equal(nxt, src):
            return p.literals[src]
        src = nxt
    raise RuntimeError("a match chain did not end in a literal")


def rdg(n: int, g, device, match_proba: float = 0.5, lit_proba: float = 0.0, layout=None) -> torch.Tensor:
    """n bytes of `RDG_genBuffer(n, match_proba, lit_proba)`'s distribution."""
    return materialise(plan(n, match_proba, lit_proba, g, device, layout), n)


CONTENTS = {"rdg": rdg}


def make_object(config: dict, name: str, seed: int, device) -> torch.Tensor:
    """The object `name` of a configuration, as a uint8 tensor on `device`.
    Configurations with the same contents give the same bytes for a seed."""
    g = _generator(subseed(seed, config["contents"], name), device)
    layout = _generator(subseed(0, "layout", config["contents"], name), device)
    return CONTENTS[config["contents"]](int(config["objects"][name]), g, device,
                                        float(config["match_proba"]), float(config["lit_proba"]), layout)


def make_objects(config: dict, seed: int, device) -> dict[str, np.ndarray]:
    """Every object of a configuration, made on `device` and copied to host
    memory as read-only arrays, in the configuration's order."""
    out = {}
    for name in config["objects"]:
        arr = make_object(config, name, seed, device).cpu().numpy()
        arr.setflags(write=False)
        out[name] = arr
    return out
