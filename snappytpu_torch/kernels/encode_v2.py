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
    pass as ((hi - 2**31) << 32) | lo, which keeps unsigned order: tier B
    takes 8 passes for `dense` (16 keys) and 3 for `fast` (6 keys).
  * The sort-back of the match tiers is a permutation inverse; the JAX
    encoder does it as a sort because scatters are slow on the TPU.  Here
    it is one scatter of the slot indices and two gathers.
  * The emitted slots are still compacted with a per-section sort (their
    keys are unique apart from the empty-slot fill), and the section heads
    are assembled by the hand-written concat kernel (kernels/concat.py).

Every tensor stays on the device of the input blocks.  The encoder's own
array code is plain PyTorch; only the concat is a kernel.
"""

from __future__ import annotations

import torch

from snappytpu.format import constants as C

from .concat import concat_rows

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


def _find_matches(blocks_u8: torch.Tensor, n: torch.Tensor, dense: bool = True):
    """Per-position (match_len, dist >= 1); len 0 where no match.  Tier A,
    tier B (dense: all 16 key words at byte resolution; fast: 6 sampled key
    words at stride 4), then the run tiers — the JAX `_find_matches` with
    its default knobs."""
    B = blocks_u8.shape[0]
    dev = blocks_u8.device
    pos = _pos(B, BS, dev)
    w = _words(blocks_u8)
    kws = tuple(_shift_words(w, 4 * j) if j else w for j in range(KW))
    tail = pos > (n - G)[:, None]
    w0p = torch.where(tail, 0xFFFFFFFF, kws[0])

    def finish(blen, bcand, pos_sub):
        mlen = torch.minimum(blen, torch.clamp_min(n[:, None] - pos_sub, 0))
        dist = torch.where(mlen >= G, pos_sub - bcand, 0)
        return torch.where(mlen >= G, mlen, 0), dist

    def sort_back(order, blen, bcand, pos_sub):
        # order[:, i] is the (sub)position index of sorted slot i; its
        # inverse brings each slot's best match back to position order
        inv = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=dev).expand_as(order)
        )
        return finish(torch.gather(blen, 1, inv), torch.gather(bcand, 1, inv), pos_sub)

    # tier A: one stable key, so each 4-gram group is in position order
    orderA = torch.sort(w0p, dim=1, stable=True).indices
    apos = orderA.to(_I32)
    aks = (torch.gather(w0p, 1, orderA),) + tuple(torch.gather(kws[j], 1, orderA) for j in (1, 2, 3))
    a_ranks = (1, 2, 3, 4) if dense else (1, 2, 3, 4, 5, 6)
    lenA, candA = _tier_best(apos, aks, pred_ranks=a_ranks)
    tiers = [sort_back(orderA, lenA, candA, pos)]

    # tier B: suffix adjacency; fast samples every 4th position
    stride = 1 if dense else 4
    sub = (lambda x: x) if stride == 1 else (lambda x: x[:, ::stride])
    key_ids = tuple(range(KW)) if dense else (0, 1, 4, 8, 12, 15)
    kw_eff = (w0p,) + kws[1:]
    orderB = _lex_order([sub(kw_eff[j]) for j in key_ids])
    bpos = (orderB * stride).to(_I32)
    bks = tuple(torch.gather(sub(kw_eff[j]), 1, orderB) for j in range(KW))
    lenB, candB = _tier_best(bpos, bks, pred_ranks=NEIGHBORS, succ_ranks=NEIGHBORS)
    mlenB, distB = sort_back(orderB, lenB, candB, sub(pos))
    if stride > 1:
        # interleave back to byte resolution (off-stride: no tier-B match)
        def expand(x):
            z = _zeros(B, BS, x).view(B, BS // stride, stride)
            z[:, :, 0] = x
            return z.view(B, BS)

        mlenB, distB = expand(mlenB), expand(distB)
    tiers.append((mlenB, distB))

    tiers.extend(_run_tier(blocks_u8, n))
    return tiers


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


# Emission sections per block (wire bytes are section-count invariant; 64
# is the JAX encoder's choice and fixes the concat kernel's shape).
_NSEC = 64


def _section_capacity(sp: int) -> int:
    """Per-section slot capacity: the worst-case emitted bytes of one
    section's sp positions plus headroom (derivation in the JAX module)."""
    return ((sp + sp // 4 + 128 + 511) // 512) * 512


def _emit(blocks_u8, is_copy, ad, lead, tail, n, seccap=None):
    """Byte-granular interval emission + sectioned compaction.  Returns
    ((B, PAD_OUT) uint8 rows, (B,) int32 totals), total -1 where a section
    overflowed its capacity (seccap is overridable only to test that)."""
    nsec = _NSEC
    sp = BS // nsec
    seccap = _section_capacity(sp) if seccap is None else seccap
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


def encode_block_core(blocks_u8: torch.Tensor, n: torch.Tensor, dense: bool = True):
    tiers = _find_matches(blocks_u8, n, dense=dense)
    inh = _inherit(tiers, n)
    is_copy, ad, lead, tail = _elect(tiers, inh, n)
    is_copy, ad, lead, tail = _reglue(blocks_u8, is_copy, ad, lead, tail, n)
    return _emit(blocks_u8, is_copy, ad, lead, tail, n)


def encode_blocks_v2(blocks_u8: torch.Tensor, lens: torch.Tensor, dense: bool = True):
    """Batched block encode: (B, BS) uint8 + (B,) int32 ->
    ((B, PAD_OUT) uint8, (B,) int32), on the device of the inputs.
    dense=False is the `fast` profile."""
    if blocks_u8.dtype != torch.uint8 or blocks_u8.dim() != 2 or blocks_u8.shape[1] != BS:
        raise ValueError(f"blocks must be (B, {BS}) uint8, got {tuple(blocks_u8.shape)} {blocks_u8.dtype}")
    if lens.shape != (blocks_u8.shape[0],) or lens.device != blocks_u8.device:
        raise ValueError("lens must be (B,) on the blocks' device")
    return encode_block_core(blocks_u8.contiguous(), lens.to(_I32), dense)
