"""Block encoder v2 as torch ops — the counterpart of snappytpu.kernels.encode_v2.

The stages, their names and their output arrays are those of the JAX
encoder, so every stage can be diffed against it (tests/test_torch_encode*.py).
What the JAX module explains about WHY each stage exists (match tiers,
inheritance, hysteresis election, re-gluing, sectioned emission) holds here
unchanged; this docstring only records how the port differs.

  * Unsigned 32-bit key words are carried as int64 (torch has no uint32
    shifts, compares or scans on every backend), so the 0xFFFFFFFF tail
    fill and all key compares keep unsigned order.
  * `lax.sort(..., num_keys=k)` is a STABLE lexicographic sort whose ties
    keep position order (load-bearing for tier A's nearest-occurrence
    property).  `_lex_order` reproduces it with stable `torch.sort` passes
    from the last key to the first, two u32 keys packed into one int64 per
    pass as ((hi - 2**31) << 32) | lo, which keeps unsigned order: tier B's
    CPU route takes 8 passes for `dense` (16 keys) and 3 for `fast` (6 keys).
  * The sort-back of the match tiers is a permutation inverse; the JAX
    encoder does it as a sort because scatters are slow on the TPU.  Here
    it is one scatter of the slot indices and two gathers.
  * The emitted slots are still compacted with a per-section sort (their
    keys are unique apart from the empty-slot fill), and the section heads
    are assembled by the hand-written concat kernel (kernels/concat.py).

Every tensor stays on the device of the input blocks.  The encoder's own
array code is plain PyTorch, but for two hand-written kernels: the concat
(K1) and, on a CUDA tensor, tier B of the match finder (K7,
kernels/tier_b.py: the order, the neighbour LCPs and the best match of a
block in one thread block, in place of `_tier_b`'s sorts and gathers, which
stay the CPU route).  The carried key words are built where a stage first
reads them, so on a card only tier A's are.

The served entry, `encode_blocks_v2`, runs the unchanged chain
`encode_block_core` as one CUDA graph per (device, B, profile): the chain is
about 2,200 small launches whose shapes B and the profile fix, and no stage
syncs with the host, so a replay puts the whole call on the card in one
launch.  The gain rests on call shapes that recur, as the served path's
do: a stream is calls of 128 blocks and one tail call.  A key's first call
runs eagerly (the warm-up that capture needs: CUB's workspaces, the
allocator's blocks, K1's library), its second captures (`GraphCache`),
every later one copies the caller's inputs into the device's static
buffers, replays, and returns clones of the static outputs, which the
caller owns.  Every graph is kept: B is at most 128 (`GRAPH_MAX_BLOCKS`),
so a device has at most 256 keys and captures each once at most.  A tensor
on any other device, a batch of no blocks or of more than 128, and a call
inside someone else's capture run the chain eagerly.  Nothing else chooses
between the paths.  Counters (profiling's registry): `encode.graph_replays`,
`encode.graph_captures`, `encode.eager_calls` (one of the three per call),
`encode.graph_fallbacks` (a capture that raised: its key runs eagerly from
then on, with a warning), `encode.graph_waits` (a keyed call that found the
cache's lock held by another thread; the wait is the span
`snappy.graph_wait`), `concat.graph_runs` and `tier_b.graph_runs` (K1's
and K7's runs inside the replays).  `encode_block_core` and the stages stay
eager for the tools that time them.
"""

from __future__ import annotations

import threading
import warnings
from typing import NamedTuple

import torch

from ..format import constants as C
from ..profiling import count, counters, span

from .concat import concat_rows
from .tier_b import tier_b as tier_b_kernel

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
LCP_CAP = 64          # exact-match cap from the carried sort-key words
KW = LCP_CAP // 4     # carried 4-byte words per position
NEIGHBORS = (1, 2)    # sorted-order predecessor/successor ranks examined
G = 4                 # anchor tile width (== MIN_MATCH_LEN)
NA = BS // G          # anchors per block

_I32 = torch.int32
_I64 = torch.int64


def _pos(B, n, device):
    return torch.arange(n, dtype=_I32, device=device).expand(B, n)


def _zeros(B, n, like, dtype=None):
    return torch.zeros((B, n), dtype=dtype or like.dtype, device=like.device)


def _full(B, n, fill, like, dtype=None):
    return torch.full((B, n), fill, dtype=dtype or like.dtype, device=like.device)


def _words(blocks_u8: torch.Tensor) -> torch.Tensor:
    """Big-endian u32 word starting at every byte (zero-padded tail), as int64."""
    B = blocks_u8.shape[0]
    b = torch.cat([blocks_u8.to(_I64), _zeros(B, 3, blocks_u8, _I64)], dim=1)
    return (
        (b[:, :BS] << 24)
        | (b[:, 1 : BS + 1] << 16)
        | (b[:, 2 : BS + 2] << 8)
        | b[:, 3 : BS + 3]
    )


def _shift_words(w: torch.Tensor, k: int) -> torch.Tensor:
    """w advanced k bytes: word starting at p+k (zero-padded)."""
    return torch.cat([w[:, k:], _zeros(w.shape[0], k, w)], dim=1)


def _word_lcp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Common-prefix bytes (0..4) of two big-endian u32 words."""
    d = x ^ y
    return torch.where(
        d == 0, 4,
        torch.where(d < (1 << 8), 3,
                    torch.where(d < (1 << 16), 2, torch.where(d < (1 << 24), 1, 0))),
    ).to(_I32)


def _shifted(a, sh, fill):
    B, W = a.shape
    return torch.cat([_full(B, sh, fill, a), a[:, : W - sh]], dim=1)


def _neighbor_lcp(ks, sh: int):
    """LCP (<= 4*len(ks) bytes) between each sorted slot and the slot `sh`
    earlier, from the carried 4-byte words."""
    B, W = ks[0].shape
    lcp = _zeros(B, W, ks[0], _I32)
    alive = torch.ones((B, W), dtype=torch.bool, device=ks[0].device)
    for kw in ks:
        wl = _word_lcp(kw, _shifted(kw, sh, 0))
        lcp = lcp + torch.where(alive, wl, 0)
        alive = alive & (wl == 4)
    return lcp


def _tier_best(spos, ks, pred_ranks, succ_ranks=()):
    """Best (lcp, cand_pos) per sorted slot against the given neighbor ranks
    (the JAX `_tier_best`: tail positions are excluded positionally)."""
    B, W = spos.shape
    best_len = _zeros(B, W, spos, _I32)
    best_cand = _full(B, W, -1, spos, _I32)

    def consider(cpos, clcp):
        nonlocal best_len, best_cand
        ok = (cpos >= 0) & (cpos < spos) & (clcp >= G)
        better = ok & ((clcp > best_len) | ((clcp == best_len) & (cpos > best_cand)))
        best_len = torch.where(better, clcp, best_len)
        best_cand = torch.where(better, cpos, best_cand)

    lcp_by_sh = {sh: _neighbor_lcp(ks, sh) for sh in dict.fromkeys(pred_ranks + tuple(succ_ranks))}
    for sh in pred_ranks:
        consider(_shifted(spos, sh, -1), lcp_by_sh[sh])
    for sh in succ_ranks:
        npos = torch.cat([spos[:, sh:], _full(B, sh, -1, spos)], dim=1)
        nlcp = torch.cat([lcp_by_sh[sh][:, sh:], _zeros(B, sh, spos, _I32)], dim=1)
        consider(npos, nlcp)
    return best_len, best_cand


_RUN_DISTS = (1, 2, 3, 4, 8)  # short periods probed with exact reach


def _rev_cummin(x):
    """Suffix minimum along dim 1 (the JAX `cummin(x[:, ::-1])[:, ::-1]`)."""
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def _run_tier(blocks_u8: torch.Tensor, n: torch.Tensor):
    """Exact-reach matches at short periodic distances (no sort)."""
    B = blocks_u8.shape[0]
    pos = _pos(B, BS, blocks_u8.device)
    x = blocks_u8.to(_I32)
    nn = n[:, None]
    tiers = []
    for d in _RUN_DISTS:
        eq = torch.cat([_zeros(B, d, x, torch.bool), x[:, d:] == x[:, : BS - d]], dim=1)
        stop = torch.where(eq, BS + 1, pos)
        run_end = _rev_cummin(stop)
        mlen = torch.where(eq, torch.minimum(run_end, nn) - pos, 0)
        mlen = torch.where(mlen >= G, mlen, 0)
        tiers.append((mlen, torch.where(mlen >= G, d, 0).to(_I32)))
    return tiers


def _lex_order(keys):
    """Stable lexicographic sort order over u32 key rows (int64 tensors),
    ties in position order — `lax.sort(keys, num_keys=len(keys))`'s order.
    Two keys share one int64 per pass; passes run from the last key."""
    packed = [
        ((keys[i] - (1 << 31)) << 32) | keys[i + 1] if i + 1 < len(keys) else keys[i]
        for i in range(0, len(keys), 2)
    ]
    perm = None
    for key in reversed(packed):
        k = key if perm is None else torch.gather(key, 1, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else torch.gather(perm, 1, idx)
    return perm


class _KeyWords:
    """The KW carried key words at every position, kws[j] starting 4j bytes
    later, each built at its first read and kept: K7 reads tier B's from the
    bytes, so on a card only tier A's are built.  Indexing and slicing as a
    tuple's."""

    def __init__(self, w: torch.Tensor):
        self._built = {0: w}

    def __len__(self):
        return KW

    def __getitem__(self, j):
        if isinstance(j, slice):
            return tuple(self[i] for i in range(*j.indices(KW)))
        if j not in self._built:
            self._built[j] = _shift_words(self._built[0], 4 * j)
        return self._built[j]


class _MatchWords(NamedTuple):
    """What the match tiers share: the lengths, the positions, the 16
    carried key words at every position (kws[j] starts 4j bytes later), the
    first word with the tail positions forced to the top, and the blocks."""

    n: torch.Tensor
    pos: torch.Tensor
    kws: _KeyWords
    w0p: torch.Tensor
    blocks: torch.Tensor


def _match_words(blocks_u8: torch.Tensor, n: torch.Tensor) -> _MatchWords:
    pos = _pos(blocks_u8.shape[0], BS, blocks_u8.device)
    kws = _KeyWords(_words(blocks_u8))
    tail = pos > (n - G)[:, None]
    return _MatchWords(n, pos, kws, torch.where(tail, 0xFFFFFFFF, kws[0]), blocks_u8)


def _sort_back(order, blen, bcand, pos_sub, n):
    """A sorted tier's best matches back in position order, clipped to n:
    order[:, i] is the (sub)position index of sorted slot i, and its inverse
    (one scatter) brings each slot's (len, cand) back."""
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order)
    )
    blen, bcand = torch.gather(blen, 1, inv), torch.gather(bcand, 1, inv)
    mlen = torch.minimum(blen, torch.clamp_min(n[:, None] - pos_sub, 0))
    dist = torch.where(mlen >= G, pos_sub - bcand, 0)
    return torch.where(mlen >= G, mlen, 0), dist


def _tier_a(mw: _MatchWords, dense: bool, a_ranks=None, a_words: int = 4):
    """Tier A: one stable key, so each 4-gram group is in position order and
    its sorted predecessors are the nearest previous occurrences."""
    orderA = torch.sort(mw.w0p, dim=1, stable=True).indices
    aks = (torch.gather(mw.w0p, 1, orderA),) + tuple(torch.gather(kw, 1, orderA) for kw in mw.kws[1:a_words])
    if a_ranks is None:
        a_ranks = (1, 2, 3, 4) if dense else (1, 2, 3, 4, 5, 6)
    lenA, candA = _tier_best(orderA.to(_I32), aks, pred_ranks=tuple(a_ranks))
    return _sort_back(orderA, lenA, candA, mw.pos, mw.n)


def _tier_b_params(dense: bool, b_ranks=None, dense_keys=None):
    """Tier B's (stride, sort-key words, neighbour ranks) for a profile and
    its knobs: dense sorts every position by `dense_keys` (default all 16
    words), fast every 4th by 6 of them."""
    if dense:
        key_ids = tuple(range(KW)) if dense_keys is None else tuple(dense_keys)
    else:
        key_ids = (0, 1, 4, 8, 12, 15)
    return 1 if dense else 4, key_ids, NEIGHBORS if b_ranks is None else tuple(b_ranks)


def _tier_b(mw: _MatchWords, dense: bool, b_ranks=None, dense_keys=None):
    """Tier B: suffix adjacency over the sorted key words; fast samples
    every 4th position.  On a CUDA tensor K7 computes it (kernels/tier_b.py);
    elsewhere the torch chain does."""
    stride, key_ids, b_ranks = _tier_b_params(dense, b_ranks, dense_keys)
    if mw.blocks.device.type == "cuda":
        return tier_b_kernel(mw.blocks, mw.n, stride, key_ids, b_ranks)
    return _tier_b_chain(mw, stride, key_ids, b_ranks)


def _tier_b_chain(mw: _MatchWords, stride: int, key_ids, b_ranks):
    """Tier B as torch ops on any device: the CPU route, and what K7 is
    held to on a card."""
    B = mw.pos.shape[0]
    sub = (lambda x: x) if stride == 1 else (lambda x: x[:, ::stride])
    kw_eff = (mw.w0p,) + mw.kws[1:]
    orderB = _lex_order([sub(kw_eff[j]) for j in key_ids])
    bpos = (orderB * stride).to(_I32)
    bks = tuple(torch.gather(sub(kw_eff[j]), 1, orderB) for j in range(KW))
    lenB, candB = _tier_best(bpos, bks, pred_ranks=b_ranks, succ_ranks=b_ranks)
    mlenB, distB = _sort_back(orderB, lenB, candB, sub(mw.pos), mw.n)
    if stride > 1:
        # interleave back to byte resolution (off-stride: no tier-B match)
        def expand(x):
            z = _zeros(B, BS, x).view(B, BS // stride, stride)
            z[:, :, 0] = x
            return z.view(B, BS)

        mlenB, distB = expand(mlenB), expand(distB)
    return mlenB, distB


def _find_matches(blocks_u8: torch.Tensor, n: torch.Tensor, dense: bool = True, *,
                  a_ranks=None, b_ranks=None, dense_keys=None, a_words: int = 4):
    """Per-position (match_len, dist >= 1); len 0 where no match.  Tier A,
    tier B (dense: all 16 key words at byte resolution; fast: 6 sampled key
    words at stride 4), then the run tiers — the JAX `_find_matches`.

    The keyword knobs are the JAX encoder's A/B levers for the profiling
    tools; the defaults are the tested configuration.  Tier A carries
    kws[1:a_words] beside its key and examines the in-group predecessors
    `a_ranks` (default 1-4 dense, 1-6 fast); tier B sorts by the key words
    `dense_keys` when dense (fast keeps (0, 1, 4, 8, 12, 15)) and examines
    `b_ranks` (default NEIGHBORS) as predecessors and successors.  The JAX
    `pos16` (positions riding the TPU's sorts as u16) is not taken: here the
    order is torch.sort's indices and _sort_back inverts it by a scatter, so
    no byte depends on the positions' width."""
    mw = _match_words(blocks_u8, n)
    return [_tier_a(mw, dense, a_ranks, a_words), _tier_b(mw, dense, b_ranks, dense_keys)] + _run_tier(blocks_u8, n)


def _prefix_winner(key, payloads):
    """Prefix-argmax over each row with payload recovery from cummax scans
    (the JAX `_prefix_winner`; payloads wider than 14 bits are split so the
    packed (pos << bits) | value stays inside int32).
    Returns (prefix_max_key, winner_pos (-1 where no winner), [values], rec)."""
    B, N = key.shape
    m = torch.cummax(key, dim=1).values
    prev_m = torch.cat([_full(B, 1, torch.iinfo(_I32).min, key), m[:, : N - 1]], dim=1)
    rec = key > prev_m
    pos = _pos(B, N, key.device)
    wpos = torch.cummax(torch.where(rec, pos, -1), dim=1).values

    def fill(val, bits):
        f = torch.cummax(torch.where(rec, (pos << bits) | val, -1), dim=1).values
        return torch.where(f >= 0, f & ((1 << bits) - 1), 0)

    vals = []
    for pval, bits in payloads:
        if bits <= 14:
            vals.append(fill(pval, bits))
        else:
            lo = fill(pval & 0x3FFF, 14)
            hi = fill(pval >> 14, bits - 14)
            vals.append((hi << 14) | lo)
    return m, wpos, vals, rec


def _chain_start(rec, dist, f_dist, f_reach):
    """Start position of the winner's same-distance record chain."""
    B, N = rec.shape
    pos = _pos(B, N, rec.device)
    pd = torch.cat([_zeros(B, 1, f_dist), f_dist[:, : N - 1]], dim=1)
    pr = torch.cat([_full(B, 1, -1, f_reach), f_reach[:, : N - 1]], dim=1)
    brk = rec & ((dist != pd) | (pos > pr))
    return torch.cummax(torch.where(brk, pos, -1), dim=1).values


def _best_tier(tiers):
    """Merge per-position tier results: longest match, then smallest dist."""
    mlen, dist = tiers[0]
    for ml, dd in tiers[1:]:
        better = (ml > mlen) | ((ml == mlen) & (dd < dist))
        mlen = torch.where(better, ml, mlen)
        dist = torch.where(better, dd, dist)
    return mlen, dist


def _inherit(tiers, n: torch.Tensor):
    """Per-anchor inherited match (reach, dist, start): the max-reach match
    over starts s <= 4k (first achiever on ties), sampled at the anchors."""
    mlen, dist = _best_tier(tiers)
    B = mlen.shape[0]
    pos = _pos(B, BS, mlen.device)
    reach = torch.where(mlen >= G, pos + mlen, -1)
    m, wpos, (d,), rec = _prefix_winner(reach, [(dist, 17)])
    sc = _chain_start(rec, dist, d, m)
    return m[:, ::G], d[:, ::G], sc[:, ::G]


def _prop_pack(val, start, bits, idx=None):
    """Segmented forward fill via one cummax of (index << bits) | val.
    Requires val in [0, 2^bits) and index < 2^(31-bits)."""
    if idx is None:
        idx = _pos(val.shape[0], val.shape[1], val.device)
    packed = torch.where(start, (idx << bits) | val, -1)
    return torch.cummax(packed, dim=1).values


def _prop_val(packed, bits):
    return torch.where(packed >= 0, packed & ((1 << bits) - 1), 0)


_HYST_Q = 16  # reach quantum: winners switch only across 16-byte bands


def _elect(tiers, inh, n):
    """Anchor parse: quantized max-reach election with hysteresis.
    Returns per-anchor (is_copy, d, lead_avail, tail_avail)."""
    mlen, dist = _best_tier(tiers)
    B = mlen.shape[0]
    dev = mlen.device
    pos = _pos(B, BS, dev)
    has = mlen >= G
    reach = torch.where(has, pos + mlen, -1)
    rq = torch.div(reach, _HYST_Q, rounding_mode="floor")
    key = torch.where(has, (rq << 17) | (BS - pos), -1)
    _, s1, (d1, r1v), rec = _prefix_winner(key, [(dist, 17), (torch.clamp_min(reach, 0), 17)])
    r1 = torch.where(s1 >= 0, r1v, -1)
    sc1 = _chain_start(rec, dist, d1, r1)
    s1a, d1a, r1a = sc1[:, ::G], d1[:, ::G], r1[:, ::G]
    r2a, d2a, s2a = inh

    a_pos = _pos(B, NA, dev) * G
    n_ok = (a_pos + G) <= n[:, None]
    use1 = (r1a >= a_pos + G) & (d1a >= 1) & (d1a <= a_pos)
    use2 = (r2a >= a_pos + G) & (d2a >= 1) & (d2a <= a_pos)
    is_copy = n_ok & (use1 | use2)
    ad = torch.where(use1, d1a, torch.where(use2, d2a, 0))
    sel_r = torch.where(use1, r1a, r2a)
    sel_s = torch.where(use1, s1a, s2a)
    lead = torch.where(is_copy, torch.clamp_min(a_pos - sel_s, 0), 0)
    tail = torch.where(is_copy, torch.clamp_min(sel_r - (a_pos + G), 0), 0)
    return is_copy, torch.where(is_copy, ad, 0), lead, tail


def _reglue(blocks_u8, is_copy, ad, lead, tail, n):
    """Two bounded gather rounds: adopt a neighbor's distance where this
    anchor's 4 bytes verifiably also match at it (left round, then right)."""
    B = is_copy.shape[0]
    a_pos = _pos(B, NA, is_copy.device) * G
    w = _words(blocks_u8)
    w_a = w[:, ::G]
    z = _zeros(B, 1, ad)

    for direction in ("left", "right"):
        left_d = torch.cat([z, ad[:, : NA - 1]], dim=1)
        right_d = torch.cat([ad[:, 1:], z], dim=1)
        nb_d, other = (left_d, right_d) if direction == "left" else (right_d, left_d)
        # only anchors that do not already continue a run on the other side
        # may switch (adopting would otherwise split an existing run)
        loose = ~is_copy | (ad != other)
        cand_ok = (
            loose & (nb_d >= 1) & (nb_d <= a_pos) & ((a_pos + G) <= n[:, None]) & (nb_d != ad)
        )
        src = torch.where(cand_ok, a_pos - nb_d, 0)
        glue = cand_ok & (torch.gather(w, 1, src.to(_I64)) == w_a)
        is_copy = is_copy | glue
        ad = torch.where(glue, nb_d, ad)
        lead = torch.where(glue, 0, lead)
        tail = torch.where(glue, 0, tail)
    return is_copy, ad, lead, tail


# Emission sections per block: the JAX encoder's default.  Wire bytes are
# section-count invariant (sections own disjoint, contiguous dest ranges);
# the count sets K1's shape: S sections of _section_capacity(BS // S) bytes.
_NSEC = 64


def _section_capacity(sp: int) -> int:
    """Per-section slot capacity: the worst-case emitted bytes of one
    section's sp positions plus headroom (derivation in the JAX module)."""
    return ((sp + sp // 4 + 128 + 511) // 512) * 512


class _Geometry(NamedTuple):
    """What `_emit`'s compaction needs from its geometry: per position the
    emitted size and dest offset, the op and literal-header fields, and per
    block the total."""

    size: torch.Tensor
    off: torch.Tensor
    total: torch.Tensor
    op_start: torch.Tensor
    two: torch.Tensor
    op_len: torch.Tensor
    d_b: torch.Tensor
    lstart: torch.Tensor
    hdr: torch.Tensor
    rlen: torch.Tensor


def _emit_geometry(blocks_u8, is_copy, ad, lead, tail, n) -> _Geometry:
    """The first half of `_emit`: runs stretched into byte intervals, ops
    chunked, literal runs, and every position's emitted size, offset and
    the block's total — all that the total depends on (the JAX
    tools/enc_stage_fast.py got this half by XLA's dead-code elimination)."""
    B = blocks_u8.shape[0]
    dev = blocks_u8.device
    pos = _pos(B, BS, dev)
    a_pos = _pos(B, NA, dev) * G
    nn = n[:, None]
    zb = _zeros(B, 1, is_copy)
    zi = _zeros(B, 1, ad)
    neg = _full(B, 1, -1, ad)

    # ---- run geometry over anchors ----
    prev_is = torch.cat([zb, is_copy[:, : NA - 1]], dim=1)
    prev_d = torch.cat([zi, ad[:, : NA - 1]], dim=1)
    run_start = is_copy & ~(prev_is & (prev_d == ad))
    nxt_is = torch.cat([is_copy[:, 1:], zb], dim=1)
    nxt_d = torch.cat([ad[:, 1:], zi], dim=1)
    run_end = is_copy & ~(nxt_is & (nxt_d == ad))

    def rev(x):
        return torch.flip(x, [1])

    # ---- stretch: tails first (into the following literal gap) ----
    next_start_p = rev(_prop_pack(rev(torch.where(run_start, a_pos, 0)), rev(run_start), 17))
    nxt_exists = torch.cat([next_start_p[:, 1:] >= 0, zb], dim=1)
    next_start_at_end = torch.where(
        nxt_exists, torch.cat([_prop_val(next_start_p, 17)[:, 1:], zi], dim=1), nn
    )
    gap_next = torch.clamp_min(torch.minimum(next_start_at_end, nn) - (a_pos + G), 0)
    tail_fin = torch.where(run_end, torch.minimum(tail, gap_next), 0)

    # ---- leads second (into what the previous tail left over) ----
    pc_p = _prop_pack(torch.where(run_end, a_pos + G + tail_fin, 0), run_end, 17)
    pc_p = torch.cat([neg, pc_p[:, : NA - 1]], dim=1)
    prev_cover = _prop_val(pc_p, 17)
    lead_fin = torch.where(run_start, torch.minimum(lead, a_pos - prev_cover), 0)

    # ---- byte-level run intervals from anchor-level fills ----
    ivs = torch.where(run_start, a_pos - lead_fin, 0)
    ive_p = rev(_prop_pack(rev(torch.where(run_end, a_pos + G + tail_fin, 0)), rev(run_end), 17))
    ive = _prop_val(ive_p, 17)

    def afwd(val):
        return _prop_pack(val, run_start, 17)

    def arev(val):
        p = rev(_prop_pack(rev(val), rev(run_start), 17))
        return torch.cat([p[:, 1:], neg], dim=1)

    def expand(x):
        return x[:, :, None].expand(B, NA, G).reshape(B, BS)

    p_s, p_e, p_d = afwd(ivs), afwd(ive), afwd(ad)
    n_s, n_e, n_d = arev(ivs), arev(ive), arev(ad)
    sP, hasP = expand(_prop_val(p_s, 17)), expand(p_s >= 0)
    eP, dP = expand(_prop_val(p_e, 17)), expand(_prop_val(p_d, 17))
    sN, hasN = expand(_prop_val(n_s, 17)), expand(n_s >= 0)
    eN, dN = expand(_prop_val(n_e, 17)), expand(_prop_val(n_d, 17))

    cov_next = hasN & (pos >= sN)
    cov_prev = hasP & (pos >= sP) & (pos < eP)
    covered = cov_next | cov_prev
    s_b = torch.where(cov_next, sN, torch.where(cov_prev, sP, -1))
    e_b = torch.where(cov_next, eN, eP)
    d_b = torch.where(covered, torch.where(cov_next, dN, dP), 0)

    # ---- op chunking (64s, with the 60-split for remainders 65..67) ----
    q = pos - s_b
    remq = e_b - pos
    on64 = (q % C.MAX_COPY_LEN) == 0
    on60 = (q % C.MAX_COPY_LEN) == 60
    op_start = covered & ((on64 & (remq >= 4)) | (on60 & (remq >= 5) & (remq <= 7)))
    op_len = torch.where(
        remq <= C.MAX_COPY_LEN, remq, torch.where(remq <= 67, 60, C.MAX_COPY_LEN)
    )
    op_len = torch.where(op_start, op_len, 0)
    two = op_start & (op_len <= C.COPY1_MAX_LEN) & (d_b < C.COPY1_MAX_OFFSET)
    opb = torch.where(op_start, torch.where(two, 2, 3), 0).to(_I32)

    # ---- literal geometry ----
    lit = (~covered) & (pos < nn)
    lit_prev = torch.cat([zb, lit[:, : BS - 1]], dim=1)
    lstart = lit & ~lit_prev
    lit_next = torch.cat([lit[:, 1:], zb], dim=1)
    lend = lit & ~lit_next
    ls = torch.cummax(torch.where(lstart, pos, -1), dim=1).values
    le = _rev_cummin(torch.where(lend, pos, BS + 1))
    rlen = torch.where(lit, le - ls + 1, 0)
    hdr = torch.where(
        rlen > 0,
        1 + (rlen > C.LITERAL_MAX_INLINE_LEN).to(_I32) + (rlen > 256).to(_I32),
        0,
    )

    # ---- per-byte emitted size -> offsets ----
    size = opb + lit.to(_I32) + torch.where(lstart, hdr, 0)
    off = torch.cumsum(size, dim=1, dtype=_I32) - size
    total = torch.sum(size, dim=1, dtype=_I32)
    return _Geometry(size, off, total, op_start, two, op_len, d_b, lstart, hdr, rlen)


def _emit_compact(blocks_u8, g: _Geometry, nsec: int, seccap=None):
    """The second half of `_emit`: every emitted byte pair becomes a slot,
    nsec per-section sorts compact them and K1 concatenates the sections."""
    size, off, total, op_start, two, op_len, d_b, lstart, hdr, rlen = g
    sp = BS // nsec
    seccap = _section_capacity(sp) if seccap is None else seccap
    B = blocks_u8.shape[0]
    zi = _zeros(B, 1, size)

    def rev(x):
        return torch.flip(x, [1])

    # ---- slots: two wire bytes per int32 ----
    d_lo, d_hi = d_b & 0xFF, d_b >> 8
    b0 = torch.where(
        two,
        (d_hi << 5) | ((op_len - 4) << 2) | C.TAG_COPY1,
        ((op_len - 1) << 2) | C.TAG_COPY2,
    )
    m = rlen - 1
    h0 = torch.where(
        hdr == 1,
        m << 2,
        torch.where(hdr == 2, C.LITERAL_CODE_1BYTE << 2, C.LITERAL_CODE_2BYTE << 2),
    )

    # byte values in order of each emitting position: e0..e3
    bu = blocks_u8.to(_I32)
    e0 = torch.where(op_start, b0, torch.where(lstart, h0, bu))
    e1 = torch.where(op_start, d_lo, torch.where(hdr >= 2, m & 0xFF, bu))
    e2 = torch.where(op_start, d_hi, torch.where(hdr == 3, m >> 8, bu))
    e3 = bu  # reached only for hdr-3 literal starts (size 4)

    # a slot carries a PAIR of dest bytes: (pair_index << 16) | even << 8 | odd,
    # pair_index relative to the section's first dest byte
    sec_base = off.view(B, nsec, sp)[:, :, :1].expand(B, nsec, sp).reshape(B, BS)
    rel = off - sec_base
    emit = size > 0
    nxt_p = rev(_prop_pack(rev(e0 & 0xFF), rev(emit), 8))
    nf = torch.cat([_prop_val(nxt_p, 8)[:, 1:], zi], dim=1)
    q = rel & 1
    INFK = 1 << 30

    def lane(j_even, ev, od):
        active = emit & (size > j_even)
        P = (rel + j_even) >> 1
        return torch.where(active, (P << 16) | ((ev & 0xFF) << 8) | (od & 0xFF), INFK)

    v0 = lane(
        q,
        torch.where(q == 0, e0, e1),
        torch.where(q == 0, torch.where(size > 1, e1, nf), torch.where(size > 2, e2, nf)),
    )
    v1 = lane(
        q + 2,
        torch.where(q == 0, e2, e3),
        torch.where((q == 0) & (size > 3), e3, nf),
    )

    # section compaction: valid pair slots have unique keys, so the sorted
    # row holds pair P at rank P; the empty-slot fill sorts last
    slots = torch.stack([v0.reshape(B, nsec, sp), v1.reshape(B, nsec, sp)], dim=3)
    ss = torch.sort(slots.reshape(B * nsec, 2 * sp), dim=1).values
    paircap = (seccap + 1) // 2 + ((seccap + 1) // 2 & 1)  # even # of pairs
    sp2 = ss[:, :paircap]
    # pair slot -> its two wire bytes, in dest order
    pieces = torch.stack([(sp2 >> 8) & 0xFF, sp2 & 0xFF], dim=2).to(torch.uint8)
    sec_cnt = torch.sum(size.view(B, nsec, sp), dim=2, dtype=_I32)
    # capacity guard: a section needing more than seccap bytes would be
    # truncated by the take above — poison the block's total instead
    overflow = torch.any(sec_cnt > seccap, dim=1)
    total = torch.where(overflow, -1, total)
    out = concat_rows(pieces.view(B, nsec, 2 * paircap), torch.clamp_max(sec_cnt, seccap), PAD_OUT)
    return out, total


def _emit(blocks_u8, is_copy, ad, lead, tail, n, nsec=None, seccap=None):
    """Byte-granular interval emission + sectioned compaction over nsec
    sections (default _NSEC; it must divide 65536).  Returns ((B, PAD_OUT)
    uint8 rows, (B,) int32 totals), total -1 where a section overflowed its
    capacity (seccap is overridable only to test that)."""
    nsec = _NSEC if nsec is None else nsec
    if not isinstance(nsec, int) or nsec <= 0 or BS % nsec:
        raise ValueError(f"nsec must be a positive divisor of {BS}, got {nsec!r}")
    return _emit_compact(blocks_u8, _emit_geometry(blocks_u8, is_copy, ad, lead, tail, n), nsec, seccap)


def encode_block_core(blocks_u8: torch.Tensor, n: torch.Tensor, dense: bool = True, *, nsec=None, **match_kw):
    """The encoder's stages in order; `nsec` goes to `_emit`, the other
    knobs to `_find_matches` (the defaults are the tested configuration)."""
    tiers = _find_matches(blocks_u8, n, dense=dense, **match_kw)
    inh = _inherit(tiers, n)
    is_copy, ad, lead, tail = _elect(tiers, inh, n)
    is_copy, ad, lead, tail = _reglue(blocks_u8, is_copy, ad, lead, tail, n)
    return _emit(blocks_u8, is_copy, ad, lead, tail, n, nsec=nsec)


def check_blocks(blocks_u8: torch.Tensor, lens: torch.Tensor) -> None:
    """ValueError unless blocks are (B, BS) uint8 and lens (B,) on their device."""
    if blocks_u8.dtype != torch.uint8 or blocks_u8.dim() != 2 or blocks_u8.shape[1] != BS:
        raise ValueError(f"blocks must be (B, {BS}) uint8, got {tuple(blocks_u8.shape)} {blocks_u8.dtype}")
    if lens.shape != (blocks_u8.shape[0],) or lens.device != blocks_u8.device:
        raise ValueError("lens must be (B,) on the blocks' device")


# The largest call that runs as a graph: api.DEVICE_BATCH, the served path's
# device call.  A device's keys are then at most 128 batch sizes x 2
# profiles, and the cache keeps every graph it captures: traffic of many
# object sizes (a tail call of every size from 1 to 127 blocks) costs at
# most one capture a key over the process's life, and no graph is evicted
# to be captured again.  The pool keeps no graph's outputs and starts from
# the full batch's graph (_CudaGraphs), so the 256 graphs share one 128-block
# graph's working set.
GRAPH_MAX_BLOCKS = 128


def graph_key(blocks_u8: torch.Tensor, dense: bool):
    """(device index, B, dense) of a call that may run as a CUDA graph: a
    CUDA tensor of 1 to GRAPH_MAX_BLOCKS blocks outside another capture.
    Else None."""
    dev, B = blocks_u8.device, blocks_u8.shape[0]
    if dev.type != "cuda" or not 0 < B <= GRAPH_MAX_BLOCKS or torch.cuda.is_current_stream_capturing():
        return None
    return (dev.index, B, bool(dense))


class GraphCache:
    """Which calls replay a graph.  `capture(key, *args)` returns a function
    of the same arguments that replays the key's graph (the CUDA one is
    `_CudaGraphs`); `run(key, eager, *args)` runs a key's first call through
    `eager`, captures on its second and replays after that.  The gain rests
    on call shapes that recur: a key called once is never captured, and a
    captured one is kept for the cache's life (graph_key bounds the keys).
    A capture that raises marks its key eager for the cache's life and
    counts `encode.graph_fallbacks`.  A lock keeps the bookkeeping, a
    capture and a replay whole between threads, so replays run one at a
    time: a keyed call waits for it in the span `snappy.graph_wait`, and
    one that finds it held by another thread counts `encode.graph_waits`."""

    def __init__(self, capture):
        self.capture = capture
        self.graphs: dict = {}  # key -> replay
        self.seen: set = set()  # keys run at least once
        self.eager: set = set()  # keys whose capture raised
        self._lock = threading.Lock()

    def run(self, key, eager, *args):
        if key is None:
            count("encode.eager_calls")
            return eager(*args)
        with span("snappy.graph_wait"):
            if not self._lock.acquire(blocking=False):
                count("encode.graph_waits")
                self._lock.acquire()
        try:
            replay = self._replay(key, args)
            if replay is not None:
                return replay(*args)
            count("encode.eager_calls")
        finally:
            self._lock.release()
        return eager(*args)

    def _replay(self, key, args):
        """The key's replay (captured now on its second call), or None to run eagerly."""
        if key in self.graphs:
            count("encode.graph_replays")
            return self.graphs[key]
        if key not in self.seen or key in self.eager:
            self.seen.add(key)
            return None
        try:
            replay = self.capture(key, *args)
        except RuntimeError as err:  # CUDA's and K1's errors: the key stays on the eager chain, counted and said
            self.eager.add(key)
            count("encode.graph_fallbacks")
            warnings.warn(f"encoder graph capture failed for {key}; it runs eagerly: {err!r}", RuntimeWarning)
            return None
        self.graphs[key] = replay
        count("encode.graph_captures")
        return replay


class _Device:
    """What a device's graphs share: the memory pool, the capture stream,
    and the static inputs and outputs allocated outside the pool, for
    GRAPH_MAX_BLOCKS blocks, of which a graph of B blocks uses the first B.
    So a graph holds nothing in the pool between replays, and every capture
    reuses the blocks the others' intermediates take while they run."""

    def __init__(self, dev: int):
        with torch.cuda.device(dev):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
            self.blocks = torch.empty((GRAPH_MAX_BLOCKS, BS), dtype=torch.uint8, device="cuda")
            self.lens = torch.empty((GRAPH_MAX_BLOCKS,), dtype=_I32, device="cuda")
            self.rows = torch.empty((GRAPH_MAX_BLOCKS, PAD_OUT), dtype=torch.uint8, device="cuda")
            self.totals = torch.empty((GRAPH_MAX_BLOCKS,), dtype=_I32, device="cuda")
        self.last = None  # the stream of the device's last replay


def _record(blocks, lens, dense, rows, totals) -> None:
    """The chain on the static inputs, its answer copied into the static
    outputs; its own tensors are freed when it returns, inside the capture."""
    got_rows, got_totals = encode_block_core(blocks, lens, dense)
    rows.copy_(got_rows)
    totals.copy_(got_totals)


# The hand kernels a capture records: each replay counts their recorded
# launches as `<kernel>.graph_runs` (profiling.count_launch).
_HAND_KERNELS = ("concat", "tier_b")


class _CudaGraphs:
    """GraphCache's capture on CUDA: `encode_block_core` captured on the
    device's capture stream into its one graph memory pool, from the
    device's static inputs into its static outputs (`_record`).  Unlike
    `torch.cuda.graph`, a capture neither syncs the device nor empties the
    allocator's cache: a capture records and runs nothing, and the eager
    calls of keys not yet captured keep their cached blocks.

    Sharing the pool and the inputs is safe because replays run one after
    another on the caller's stream (the GraphCache lock; a replay on another
    stream than the device's last first waits for that stream) and each
    replay's outputs are cloned before any other replay can start: a later
    replay may overwrite the static inputs and outputs, never a caller's
    clone.  The hand kernels' launches recorded in a graph are counted at
    each of its replays (`_HAND_KERNELS`)."""

    def __init__(self):
        self.devices: dict = {}  # device index -> _Device
        self.full: dict = {}  # (device index, GRAPH_MAX_BLOCKS, dense) -> its replay

    def __call__(self, key, _blocks_u8, _lens):
        """The key's replay.  A device's first capture in a profile captures
        that profile's full batch first, and keeps it for when its key
        comes: the pool then holds the largest graph's blocks, which every
        smaller graph's capture splits.  With it, and no graph's outputs in
        the pool, all 256 keys of an H100 took 3.01 GB of pool, the dense
        128-block graph's working set; captured from the smallest up with
        their outputs in the pool, 10.8 GB."""
        dev, _, dense = key
        full = (dev, GRAPH_MAX_BLOCKS, dense)
        if full not in self.full:
            self.full[full] = self._capture(full)
        return self.full[full] if key == full else self._capture(key)

    def _capture(self, key):
        dev, B, dense = key
        if dev not in self.devices:
            self.devices[dev] = _Device(dev)
        d = self.devices[dev]
        blocks, lens, rows, totals = d.blocks[:B], d.lens[:B], d.rows[:B], d.totals[:B]
        graph = torch.cuda.CUDAGraph()
        before = counters()
        with torch.cuda.device(dev), torch.cuda.stream(d.stream):
            graph.capture_begin(pool=d.pool, capture_error_mode="thread_local")
            try:
                _record(blocks, lens, dense, rows, totals)
            finally:
                graph.capture_end()
        after = counters()
        runs = [(f"{k}.graph_runs", after.get(f"{k}.recorded", 0) - before.get(f"{k}.recorded", 0))
                for k in _HAND_KERNELS]

        def replay(blocks_u8, lens_in):
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream()
                if d.last is not None and d.last != stream:
                    stream.wait_stream(d.last)
                d.last = stream
                blocks.copy_(blocks_u8)
                lens.copy_(lens_in)
                graph.replay()
                for name, k in runs:
                    count(name, k)
                return rows.clone(), totals.clone()

        return replay


_GRAPHS = GraphCache(_CudaGraphs())


def encode_blocks_v2(blocks_u8: torch.Tensor, lens: torch.Tensor, dense: bool = True):
    """Batched block encode: (B, BS) uint8 + (B,) int32 ->
    ((B, PAD_OUT) uint8, (B,) int32), on the device of the inputs.
    dense=False is the `fast` profile.  On CUDA a repeated (B, profile)
    replays a graph of `encode_block_core` (module docstring)."""
    check_blocks(blocks_u8, lens)
    return _GRAPHS.run(graph_key(blocks_u8, dense),
                       lambda b, n: encode_block_core(b.contiguous(), n.to(_I32), dense), blocks_u8, lens)
