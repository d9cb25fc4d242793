"""The v1 research encoder as torch ops — the counterpart of
snappytpu.kernels.encode_jax (the fused pointer-doubling encoder).

The JAX module's docstring explains the algorithm; its phases are the
functions here, under the same names:

  candidates   5 gram tiers, each a (validity, hash, position) sort whose
               sorted predecessors are the nearest previous occurrences
               (_gram_hashes, _sort_tier, _pred, _tier_candidates)
  best match   every candidate scored by its hash-quantized LCP estimate,
               then one exact LCP on the winner by stride-4 word compares
               (_score, _pick, _lcp, _best_match)
  greedy parse pointer doubling of the jump table J[p] = p + step(p) with a
               scatter-max reachability mask (_greedy_path, _doubling)
  refinement   4 rounds of cost-aware copy dropping (_refine)
  emission     per-op sizes -> exclusive prefix sum -> scattered tag,
               header and payload bytes (_emit_layout, _emit_bytes)

How the port differs from the JAX module:

  * Batched over (B, BS) from the start; the JAX module is per block under
    `vmap`.  `encode_block_device` keeps the per-block signature.
  * Unsigned 32-bit words and hashes are carried as int64 and masked to 32
    bits after each multiply and shift (torch has no uint32 arithmetic on
    every backend).
  * The 3-key `lax.sort((flag, h, pos))` is one `torch.sort` of the int64
    key flag << 48 | h << 16 | pos; the positions are unique, so no
    stability is needed.
  * Gather and scatter indices are int64.  JAX clamps an out-of-range
    gather index and drops an out-of-range scatter; here gathers clamp
    explicitly and scatters write a sink slot past the row, sliced off.
  * The JAX `.at[].set(..., mode="drop")` emission writes each output byte
    at most once, so the staged pipeline's `.add` into a padded buffer
    gives the same bytes; both modules share `_emit_bytes`.

The arithmetic is shared with the staged pipeline (kernels/pipeline.py),
which differs only in its profile's gram tiers (encode_core's argument).
Every tensor stays on the device of the input blocks.
"""

from __future__ import annotations

import torch

from ..format import constants as C
from .encode_v2 import check_blocks

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
BSP = BS + 128  # greedy jump table with its sentinel region
# 2^17 > BSP, and > the decoder's walk table and block: every pointer-doubling
# loop (greedy parse, op walk, copy chain) has saturated after 17 rounds, so
# the JAX pipeline's 3 x 6 gives the same result
_ROUNDS = 17
_LCP_WORDS = C.MAX_COPY_LEN // 4 + 1  # 17 stride-4 compares cover 64+3 bytes

_MIX1 = 0x9E3779B1
_MIX2 = 0x85EBCA77
_M32 = 0xFFFFFFFF

GRAM_TIERS = ((4, 2), (8, 1), (16, 1), (32, 1), (64, 1))
_SCORE_GRAMS = (4, 8, 16, 32, 64)  # the estimate always uses every hash

_I64 = torch.int64


def _pos(B: int, N: int, device) -> torch.Tensor:
    return torch.arange(N, dtype=_I64, device=device).expand(B, N)


def _zeros(B: int, N: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((B, N), dtype=_I64, device=like.device)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[b, idx[b, i]] for idx >= 0, an index past the row clamped to its
    last element as JAX clamps it."""
    return torch.gather(arr, 1, idx.clamp_max(arr.shape[1] - 1))


def _ahead(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, clip(i + k, 0, N - 1)]: k ahead, the last column repeated."""
    if k == 0:
        return x
    return torch.cat([x[:, k:], x[:, -1:].expand(x.shape[0], k)], dim=1)


def _scatter_max(N: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """zeros(N).at[idx].max(val, mode="drop") per row for idx >= 0: an index
    past the row lands in a sink slot that is sliced off."""
    out = torch.zeros((idx.shape[0], N + 1), dtype=val.dtype, device=val.device)
    return out.scatter_reduce_(1, idx.clamp_max(N), val, "amax")[:, :N]


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """cummin(x[:, ::-1])[:, ::-1]: the suffix minimum along dim 1."""
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=1).values


# ------------------------------------------------------------ candidates ---


def _word32(blocks_u8: torch.Tensor) -> torch.Tensor:
    """Big-endian 4-byte word at every position (zero-padded tail), int64."""
    B = blocks_u8.shape[0]
    b = torch.cat([blocks_u8.to(_I64), _zeros(B, 3, blocks_u8)], dim=1)
    return (b[:, :BS] << 24) | (b[:, 1 : BS + 1] << 16) | (b[:, 2 : BS + 2] << 8) | b[:, 3 : BS + 3]


def _hash_step(h: torch.Tensor, g: int) -> torch.Tensor:
    """One level of the hierarchical hash: gram g -> 2g, in uint32."""
    s = torch.cat([h[:, g:], _zeros(h.shape[0], g, h)], dim=1)
    return ((h * _MIX1) & _M32) ^ (((s * _MIX2) & _M32) >> 3) ^ ((s << 13) & _M32)


def _gram_hashes(words: torch.Tensor, gram_len: int) -> torch.Tensor:
    """Hierarchical uint32 gram hash (as int64); identical to
    model.encode.gram_hashes."""
    h, g = words, 4
    while g < gram_len:
        h, g = _hash_step(h, g), 2 * g
    return h


def _all_hashes(words: torch.Tensor) -> dict:
    """{4: words, 8: ..., 64: ...}: each level built on the one below."""
    hashes = {4: words}
    for g in (4, 8, 16, 32):
        hashes[2 * g] = _hash_step(hashes[g], g)
    return hashes


def _sort_tier(h: torch.Tensor, limit: torch.Tensor):
    """Sort (validity flag, hash, position) per row; limit = n - gram_len.
    Returns (sflag, sh, spos), each (B, BS) int64."""
    pos = _pos(h.shape[0], BS, h.device)
    flag = (pos > limit.to(_I64)[:, None]).to(_I64)
    skey = torch.sort((flag << 48) | (h << 16) | pos, dim=1).values
    return skey >> 48, (skey >> 16) & _M32, skey & 0xFFFF


def _pred(sflag, sh, spos, k: int) -> torch.Tensor:
    """The k-th sorted predecessor (same hash, both valid) as a candidate
    array in position order, -1 = none."""
    B = sh.shape[0]
    ok = sflag == 0
    same1 = torch.zeros_like(ok)
    same1[:, 1:] = (sh[:, 1:] == sh[:, :-1]) & ok[:, 1:] & ok[:, :-1]
    same = same1
    for j in range(1, k):
        same = same & torch.cat([torch.zeros_like(same1[:, :j]), same1[:, : BS - j]], dim=1)
    prev = torch.cat([torch.full((B, k), -1, dtype=_I64, device=sh.device), spos[:, : BS - k]], dim=1)
    # spos is a permutation of each row, so every slot is written once
    return torch.empty_like(spos).scatter_(1, spos, torch.where(same, prev, -1))


def _tier_candidates(hashes: dict, n: torch.Tensor, tiers=GRAM_TIERS):
    """Every candidate array of the tiers, in order (a generator, so only
    one tier's sort lives at a time)."""
    for g, n_pred in tiers:
        sflag, sh, spos = _sort_tier(hashes[g], n - g)
        for k in range(1, n_pred + 1):
            yield _pred(sflag, sh, spos, k)


# ------------------------------------------------------------ best match ---


def _score(cand: torch.Tensor, hashes: dict, n: torch.Tensor) -> torch.Tensor:
    """Hash-quantized LCP estimate of one candidate array: the largest gram
    whose hashes match at both ends (both in range); -1 where no candidate."""
    valid = cand >= 0
    c = cand.clamp_min(0)
    pos = _pos(cand.shape[0], BS, cand.device)
    est = torch.zeros_like(cand)
    for g in _SCORE_GRAMS:
        h = hashes[g]
        lim = (n.to(_I64) - g)[:, None]
        ok = (torch.gather(h, 1, c) == h) & (pos <= lim) & (c <= lim)
        est = torch.where(ok, g, est)
    return torch.where(valid, est, -1)


def _pick(scored):
    """The best candidate per position over (est, cand) pairs in order: the
    largest estimate, ties to the smallest distance.  -> (cand, dist)."""
    best_est = best_cand = best_dist = None
    for est, cand in scored:
        if best_est is None:
            best_est = torch.full_like(est, -1)
            best_cand = torch.full_like(cand, -1)
            best_dist = torch.zeros_like(cand)
            pos = _pos(cand.shape[0], BS, cand.device)
        dist = pos - cand
        better = (cand >= 0) & ((est > best_est) | ((est == best_est) & (dist < best_dist)))
        best_est = torch.where(better, est, best_est)
        best_cand = torch.where(better, cand, best_cand)
        best_dist = torch.where(better, dist, best_dist)
    return best_cand, best_dist


def _lcp(words: torch.Tensor, cand: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Exact common-prefix length against the candidate, capped at
    MAX_COPY_LEN and the block end: _LCP_WORDS stride-4 big-endian word
    compares, then the byte tail at the first mismatching word."""
    valid = cand >= 0
    c = cand.clamp_min(0)
    nfull = torch.zeros_like(cand)
    extra = torch.zeros_like(cand)
    alive = valid
    for j in range(_LCP_WORDS):
        x = _ahead(words, 4 * j) ^ _take(words, c + 4 * j)
        eq = x == 0
        e = torch.where(x < (1 << 8), 3, torch.where(x < (1 << 16), 2, torch.where(x < (1 << 24), 1, 0)))
        extra = torch.where(alive & ~eq, e, extra)
        alive = alive & eq
        nfull = nfull + alive
    lcp = 4 * nfull + torch.where(alive, 0, extra)
    cap = torch.clamp_max(n.to(_I64)[:, None] - _pos(cand.shape[0], BS, cand.device), C.MAX_COPY_LEN)
    return torch.where(valid, torch.minimum(lcp, cap.clamp_min(0)), 0)


def _best_match(words: torch.Tensor, n: torch.Tensor, tiers=GRAM_TIERS):
    """Per-position (best_len, best_dist): every candidate of the tiers
    scored by estimate, one exact LCP on the winner; dist 0 where no match."""
    hashes = _all_hashes(words)
    cand, dist = _pick((_score(c, hashes, n), c) for c in _tier_candidates(hashes, n, tiers))
    del hashes
    mlen = _lcp(words, cand, n)
    return mlen, torch.where(mlen > 0, dist, 0)


# ---------------------------------------------------------- greedy parse ---


def _greedy_init(best_len: torch.Tensor):
    """Jump table J[p] = p + step(p), clamped to the sentinel BS (positions
    past BS self-trap there), and the mask R with only position 0 set."""
    B = best_len.shape[0]
    step = torch.where(best_len >= C.MIN_MATCH_LEN, best_len, 1)
    step = torch.cat([step, torch.ones((B, BSP - BS), dtype=_I64, device=step.device)], dim=1)
    J = torch.clamp_max(_pos(B, BSP, step.device) + step, BS)
    R = torch.zeros((B, BSP), dtype=torch.int32, device=step.device)
    R[:, 0] = 1
    return J, R


def _doubling(J: torch.Tensor, R: torch.Tensor, rounds: int):
    """`rounds` of reachability doubling: R |= R scattered (max) through J,
    then J = J[J].  After round k, R holds every position reachable from 0
    in fewer than 2^k steps.  Shared by the greedy parse and the decoder's
    op walk."""
    N = J.shape[1]
    for _ in range(rounds):
        R = R | _scatter_max(N, J, R)
        J = _take(J, J)
    return J, R


def _reached(R: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Positions of the block on the walked path."""
    return (R[:, :BS] == 1) & (_pos(R.shape[0], BS, R.device) < n.to(_I64)[:, None])


def _greedy_path(best_len: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reachability mask of the greedy parse by pointer doubling."""
    _J, R = _doubling(*_greedy_init(best_len), _ROUNDS)
    return _reached(R, n)


# ------------------------------------------------------------ refinement ---


def _hdr_or0(gap: torch.Tensor) -> torch.Tensor:
    """Literal header bytes for a run of `gap` bytes; 0 for an empty run."""
    return torch.where(gap > 0, 1 + (gap > C.LITERAL_MAX_INLINE_LEN).to(_I64) + (gap > 256).to(_I64), 0)


def _copy_op_bytes(length: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    two = (length <= C.COPY1_MAX_LEN) & (dist < C.COPY1_MAX_OFFSET)
    return torch.where(two, 2, 3).to(_I64)


def _refine(is_copy: torch.Tensor, L: torch.Tensor, D: torch.Tensor, n: torch.Tensor, rounds: int = 4):
    """Drop net-negative copies given realized literal-gap contexts;
    `rounds` simultaneous-drop rounds, mirroring model.encode.refine_parse."""
    B = is_copy.shape[0]
    pos = _pos(B, BS, is_copy.device)
    nn = n.to(_I64)[:, None]
    for _ in range(rounds):
        pce = torch.cat([_zeros(B, 1, L), _cummax(torch.where(is_copy, pos + L, 0))[:, : BS - 1]], dim=1)
        ncs = _rev_cummin(torch.where(is_copy, pos, BS + 1))
        ncs = torch.cat([ncs[:, 1:], torch.full((B, 1), BS + 1, dtype=_I64, device=L.device)], dim=1)
        left = pos - pce
        right = torch.minimum(ncs, nn) - (pos + L)
        benefit = L + _hdr_or0(left + L + right) - _copy_op_bytes(L, D) - _hdr_or0(left) - _hdr_or0(right)
        is_copy = is_copy & (benefit >= 0)
    return is_copy


# -------------------------------------------------------------- emission ---


def _emit_layout(is_copy, L, D, n):
    """Literal coverage, run geometry, op sizes, output offsets, total ->
    (lit, run_start, rs, rlen, hdr, opb, out_off, total)."""
    B = is_copy.shape[0]
    pos = _pos(B, BS, is_copy.device)
    one = is_copy.to(_I64)
    delta = torch.zeros((B, BS + 1), dtype=_I64, device=pos.device)
    delta.scatter_add_(1, torch.where(is_copy, pos, BS), one)
    delta.scatter_add_(1, torch.where(is_copy, (pos + L).clamp_max(BS), BS), -one)
    covered = torch.cumsum(delta[:, :BS], dim=1) > 0
    lit = ~covered & (pos < n.to(_I64)[:, None])
    zb = torch.zeros_like(lit[:, :1])
    run_start = lit & ~torch.cat([zb, lit[:, : BS - 1]], dim=1)
    rs = _cummax(torch.where(run_start, pos, -1))
    run_end = lit & ~torch.cat([lit[:, 1:], zb], dim=1)
    rlen = torch.where(lit, _rev_cummin(torch.where(run_end, pos, BS + 1)) - rs + 1, 0)
    hdr = _hdr_or0(rlen)
    opb = _copy_op_bytes(L, D)
    size = torch.where(is_copy, opb, 0) + torch.where(run_start, hdr + rlen, 0)
    out_off = torch.cumsum(size, dim=1) - size
    total = size.sum(dim=1).to(torch.int32)
    return lit, run_start, rs, rlen, hdr, opb, out_off, total


def _emit_bytes(blocks_u8, is_copy, L, D, lit, run_start, rs, rlen, hdr, opb, out_off):
    """Scatter tag, header and payload bytes into the (B, PAD_OUT) rows;
    every output byte is written at most once, and one past the row is
    dropped (a sink slot)."""
    B = is_copy.shape[0]
    pos = _pos(B, BS, is_copy.device)
    out = torch.zeros((B, PAD_OUT + 1), dtype=_I64, device=pos.device)

    def put(mask, idx, val):
        out.scatter_(1, torch.where(mask, idx.clamp_max(PAD_OUT), PAD_OUT), val)

    # copy ops
    two = opb == 2
    b0 = torch.where(two, ((D >> 8) << 5) | ((L - 4) << 2) | C.TAG_COPY1, ((L - 1) << 2) | C.TAG_COPY2)
    put(is_copy, out_off, b0)
    put(is_copy, out_off + 1, D & 0xFF)
    put(is_copy & ~two, out_off + 2, D >> 8)
    # literal run headers
    m = rlen - 1
    h0 = torch.where(hdr == 1, m << 2,
                     torch.where(hdr == 2, C.LITERAL_CODE_1BYTE << 2, C.LITERAL_CODE_2BYTE << 2))
    put(run_start, out_off, h0)
    put(run_start & (hdr >= 2), out_off + 1, m & 0xFF)
    put(run_start & (hdr >= 3), out_off + 2, m >> 8)
    # literal payload
    run_off = _cummax(torch.where(run_start, out_off + hdr, -1))
    put(lit, run_off + (pos - rs.clamp_min(0)), blocks_u8.to(_I64))
    return out[:, :PAD_OUT].to(torch.uint8)


def _emit(blocks_u8, is_copy, L, D, n):
    """Serialize the parse: sizes -> prefix sum -> scattered bytes."""
    *layout, total = _emit_layout(is_copy, L, D, n)
    return _emit_bytes(blocks_u8, is_copy, L, D, *layout), total


# ----------------------------------------------------------------- entry ---


def encode_core(blocks_u8: torch.Tensor, n: torch.Tensor, tiers=GRAM_TIERS):
    """The v1 encoder's phases in order over a (B, BS) batch, with the
    candidates of `tiers`."""
    words = _word32(blocks_u8)
    best_len, best_dist = _best_match(words, n, tiers)
    del words
    is_copy = _greedy_path(best_len, n) & (best_len >= C.MIN_MATCH_LEN)
    is_copy = _refine(is_copy, best_len, best_dist, n)
    return _emit(blocks_u8, is_copy, best_len, best_dist, n)


def encode_blocks(blocks_u8: torch.Tensor, lens: torch.Tensor):
    """Batched block encode: (B, BS) uint8 + (B,) int32 -> ((B, PAD_OUT)
    uint8, (B,) int32), on the device of the inputs."""
    check_blocks(blocks_u8, lens)
    return encode_core(blocks_u8, lens.to(_I64))


def encode_block_device(block_u8: torch.Tensor, n):
    """Encode one zero-padded (BS,) uint8 block with valid length n ->
    ((PAD_OUT,) uint8, int32 scalar tensor)."""
    lens = torch.as_tensor([int(n)], dtype=_I64, device=block_u8.device)
    comp, total = encode_blocks(block_u8[None], lens)
    return comp[0], total[0]
