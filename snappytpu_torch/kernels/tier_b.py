"""Tier B of the encoder's match finder on a card — K7.

`encode_v2._tier_b` calls `tier_b` on a CUDA tensor and runs its torch chain
on a CPU tensor: the chain is the CPU route and what the tests hold K7 to,
and nothing else chooses between them.  K7 (csrc/tier_b.cu, its body in
csrc/tier_b.cuh) takes the call's parameters, so every profile and every
knob of the encoder tools runs it: the stride (1 dense, 4 fast), the
sort-key words `key_ids` (an ordered set of the 16 carried words) and the
neighbour ranks `b_ranks` (each 1 to 4).

Counters (profiling's registry, `count_launch` as K1 counts): `tier_b.launches`,
K7's launches that run at once; a launch recorded into the encoder's CUDA
graph counts `tier_b.recorded`, and each replay of that graph counts it as
`tier_b.graph_runs` (encode_v2).  So over any run of encoder calls on a
card, launches plus graph runs are the calls.
"""

from __future__ import annotations

import ctypes

import torch

from ..format import constants as C
from ..profiling import count_launch

BS = C.MAX_BLOCK_SIZE
KEY_WORDS = 16
MAX_RANK = 4


def params(stride: int, key_ids, b_ranks) -> tuple[int, int, int]:
    """K7's (nkeys, key_ids packed four bits a word, rank mask); ValueError
    outside what it takes: stride 1 or 4, 1 to 16 distinct key words of
    0-15, ranks of 1-4."""
    key_ids, b_ranks = tuple(key_ids), tuple(b_ranks)
    if stride not in (1, 4):
        raise ValueError(f"tier B's stride must be 1 or 4, got {stride!r}")
    if not key_ids or len(set(key_ids)) != len(key_ids) or any(j not in range(KEY_WORDS) for j in key_ids):
        raise ValueError(f"tier B's key words must be 1 to {KEY_WORDS} distinct of 0-{KEY_WORDS - 1}, got {key_ids!r}")
    if any(r not in range(1, MAX_RANK + 1) for r in b_ranks):
        raise ValueError(f"tier B's ranks must each be 1 to {MAX_RANK}, got {b_ranks!r}")
    packed = sum(j << (4 * t) for t, j in enumerate(key_ids))
    return len(key_ids), packed, sum(1 << (r - 1) for r in set(b_ranks))


def tier_b(blocks_u8: torch.Tensor, n: torch.Tensor, stride: int, key_ids, b_ranks):
    """K7 over (B, BS) uint8 blocks on a CUDA device and their (B,) lengths:
    per position the tier-B match's length and distance, (B, BS) each, as
    `_tier_b`'s chain returns them (the length in n's promoted type, the
    distance int32; 0 where none, and off the stride)."""
    from .._build import check, library

    nkeys, packed, mask = params(stride, key_ids, b_ranks)
    dev, B = blocks_u8.device, blocks_u8.shape[0]
    blocks = blocks_u8.contiguous()
    if blocks.data_ptr() % 16:  # the kernel stages a block by 16-byte loads
        blocks = blocks.clone()
    lens = n.to(torch.int32).contiguous()
    scratch = torch.empty((B, BS // stride), dtype=torch.int16, device=dev)  # a merge level's order, as uint16
    out_len = torch.empty((B, BS), dtype=torch.int32, device=dev)
    out_dist = torch.empty((B, BS), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = library().snappy_tier_b_matches(
                blocks.data_ptr(), lens.data_ptr(), scratch.data_ptr(), out_len.data_ptr(), out_dist.data_ptr(),
                B, stride, nkeys, packed, mask, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            )
        check(rc, "tier_b")
        count_launch("tier_b")
    return out_len.to(torch.promote_types(torch.int32, n.dtype)), out_dist
