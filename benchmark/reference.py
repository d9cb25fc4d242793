"""The plain reference: a raw-Snappy decoder in plain torch operations.

It decodes a whole stream at once, on any device, without a loop over ops or
bytes, so that it can judge a Silesia-sized pass on the card in about a
second, where a loop in Python would take minutes:

  1. every byte position is read as if an op started there, giving the op's
     kind, header size, length, copy offset and the position after it;
  2. the positions reachable from the first byte are the op starts; they are
     found by doubling (after round k the marked set holds the first 2^(k+1)
     ops of the chain);
  3. each output byte gets its source: a literal byte of the stream, or the
     output byte `offset` before it; chains of copies are followed by
     pointer jumping until every byte points at a literal.

It rejects (raises `Rejected`) every stream that is not valid raw Snappy:
a preamble longer than five bytes or over 2^32 - 1, an op that runs past the
stream's end, a total output other than the preamble's, a copy with offset 0
or reaching before the output's start.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


class Rejected(ValueError):
    """The stream is not valid raw Snappy."""


def read_preamble(data: bytes) -> tuple[int, int]:
    """(uncompressed length, bytes the varint takes)."""
    value = 0
    for i in range(min(len(data), 5)):
        value |= (data[i] & 0x7F) << (7 * i)
        if data[i] < 0x80:
            if value >= 1 << 32:
                raise Rejected("preamble over 2^32 - 1")
            return value, i + 1
    raise Rejected("preamble truncated or longer than 5 bytes")


def _ops_at_every_position(b: torch.Tensor):
    """For each position p, the op that would start there:
    (kind, header bytes, output length, copy offset, stream bytes)."""
    n = b.numel()
    pad = torch.cat([b, b.new_zeros(5)]).long()
    tag = pad[:n]
    b1, b2, b3, b4 = (pad[i : n + i] for i in range(1, 5))
    kind, hi = tag & 3, tag >> 2
    extra = (hi - 59).clamp(min=0)  # a literal's length bytes after its tag, 0-4
    word = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)
    lit_len = torch.where(hi < 60, hi, word & ((1 << (8 * extra)) - 1)) + 1
    header = torch.stack([1 + extra, torch.full_like(tag, 2), torch.full_like(tag, 3), torch.full_like(tag, 5)])
    length = torch.stack([lit_len, ((tag >> 2) & 7) + 4, hi + 1, hi + 1])
    offset = torch.stack([torch.zeros_like(tag), ((tag >> 5) << 8) | b1, b1 | (b2 << 8), word])
    pick = kind.unsqueeze(0)
    header, length, offset = (t.gather(0, pick).squeeze(0) for t in (header, length, offset))
    size = header + torch.where(kind == 0, length, torch.zeros_like(length))
    return kind, header, length, offset, size


def _op_starts(size: torch.Tensor) -> torch.Tensor:
    """The positions of the chain 0, next(0), next(next(0)), ... below n."""
    n = size.numel()
    nxt = torch.cat([(torch.arange(n, device=size.device) + size).clamp(max=n), size.new_full((1,), n)])
    marked = torch.zeros(n + 1, dtype=torch.bool, device=size.device)
    marked[0] = True
    reach = 1
    while reach < n + 1:
        marked[nxt[marked]] = True
        nxt = nxt[nxt]
        reach *= 2
    return marked[:n].nonzero().squeeze(1)


def decode(stream, device) -> torch.Tensor:
    """The bytes a raw Snappy stream decodes to, as a uint8 tensor on
    `device`; `Rejected` if the stream is not valid."""
    data = bytes(stream)
    out_len, head = read_preamble(data)
    ops = torch.from_numpy(np.frombuffer(data, np.uint8, offset=head).copy()).to(device)
    n = ops.numel()
    if n == 0:
        if out_len:
            raise Rejected("no ops for a nonempty output")
        return ops
    kind, header, length, offset, size = _ops_at_every_position(ops)
    starts = _op_starts(size)
    kind, header, length, offset, size = (t[starts] for t in (kind, header, length, offset, size))
    if bool((starts + size > n).any()):
        raise Rejected("an op runs past the end of the stream")
    if int(length.sum()) != out_len:
        raise Rejected(f"ops give {int(length.sum())} bytes, the preamble says {out_len}")
    first = torch.cumsum(length, 0) - length
    copy = kind != 0
    if bool((copy & ((offset == 0) | (offset > first))).any()):
        raise Rejected("a copy with offset 0 or before the output's start")
    op = torch.repeat_interleave(torch.arange(starts.numel(), device=ops.device), length)
    q = torch.arange(out_len, device=ops.device)
    literal = kind[op] == 0
    src = (starts + header)[op] + q - first[op]
    value = torch.where(literal, ops[src.clamp(max=n - 1)].long(), torch.zeros_like(q))
    ptr = torch.where(literal, q, q - offset[op])
    del op, src, literal
    while True:
        jumped = ptr[ptr]
        if torch.equal(jumped, ptr):
            break
        ptr = jumped
    return value[ptr].to(torch.uint8)
