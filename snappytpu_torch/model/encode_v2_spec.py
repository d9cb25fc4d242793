"""Executable numpy spec of the v2 device encoder — the port's own copy of
snappytpu.model.encode_v2_spec, held against it and against the port's
encoder (kernels/encode_v2.py) by tests/test_torch_encode_v2_spec.py.

This is the SEMANTIC contract of the production encoder, written as plain
sequential numpy/Python — dict chains, explicit loops, no clever packing —
so a human can check it against the Snappy format and the device encoder
can be diffed against it stage by stage (intermediate-array equality AND
byte-identical output).

Pipeline (single <=64 KiB block):
  1. matches   per-position best (len<=LCP_CAP, dist):
               tier A: the 4 nearest previous occurrences of the position's
               exact 4-gram (the reference's hash chain with perfect
               collision resolution, snappy_compression.c:303-307), LCP
               capped at TIER_A_CAP bytes;
               tier B (dense): ranks 1-2 neighbors in 32-byte-prefix sort
               order, both directions (suffix-array adjacency).
               Preference: longer, then smaller distance.
  2. inherit   per anchor a=4k: the max-reach match over starts s<=a
               (FIRST achiever on reach ties).
  3. elect     per anchor: quantized hysteresis election — winner is the
               max (reach // 16, earliest start) match; the anchor is a
               copy tile if either winner covers [a, a+4) with a valid
               distance (quantized winner preferred).
  4. reglue    anchors adopt a neighbor's distance when their own 4 bytes
               verifiably match at it (left then right round).
  5. emit      same-d anchor runs stretch into adjacent literal slack by
               the winners' verified lead/tail bytes; runs chunk into ops
               with the 60/64 remainder rule (snappy_compression.c:153-165);
               literals fill the gaps.
"""

from __future__ import annotations

import numpy as np

from ..format import constants as C

BS = C.MAX_BLOCK_SIZE
G = C.MIN_MATCH_LEN
LCP_CAP = 64
TIER_A_CAP = 16
HYST_Q = 16
RUN_DISTS = (1, 2, 3, 4, 8)


def _lcp_padded(padded: np.ndarray, a: int, b: int, cap: int) -> int:
    """Common prefix length of the zero-extended suffixes at a and b, capped.

    Matches the device, which compares carried key words built from the
    zero-padded block: candidate PREFERENCE uses this raw padded LCP; the
    final match length is clipped to the real data (n - p) afterwards."""
    l = 0
    while l < cap and padded[a + l] == padded[b + l]:
        l += 1
    return l


def spec_matches(block: np.ndarray, n: int, dense: bool = True):
    """Stage 1: per-position (mlen, dist) with the device tiers' exact
    candidate sets; 0 where no match of >= G bytes exists.

    Selection WITHIN a tier prefers raw padded LCP (then smaller distance);
    tier results are clipped to the real data and MERGED on clipped length
    (then smaller distance) — the exact order of operations of the device's
    per-tier `finish` + `_best_tier`."""
    data = block[:n]
    padded = np.zeros(BS + LCP_CAP, np.uint8)
    padded[:n] = data

    def clip(raw, dist):
        mlen = np.minimum(raw, np.maximum(n - np.arange(BS), 0)).astype(np.int32)
        mlen = np.where(mlen >= G, mlen, 0)
        return mlen, np.where(mlen >= G, dist, 0).astype(np.int32)

    # tier A: nearest 4 previous occurrences of the exact 4-gram
    rawA = np.zeros(BS, np.int32)
    distA = np.zeros(BS, np.int32)

    def consider(raw, dist, p, cand, cap):
        l = _lcp_padded(padded, cand, p, cap)
        if l >= G:
            d = p - cand
            if l > raw[p] or (l == raw[p] and d < dist[p]):
                raw[p] = l
                dist[p] = d

    chains: dict[bytes, list[int]] = {}
    for p in range(max(n - G + 1, 0)):
        gram = data[p : p + G].tobytes()
        for cand in chains.get(gram, ())[-4:]:
            consider(rawA, distA, p, cand, TIER_A_CAP)
        chains.setdefault(gram, []).append(p)
    mlen, dist = clip(rawA, distA)

    if dense:
        # tier B (dense): full-LCP_CAP-prefix sort order (ties position-
        # ordered by sort stability), ranks 1..2 both directions; candidate
        # LCP exact to LCP_CAP bytes.  (The fast profile instead samples
        # key words at stride 4 — not modeled here; the spec covers the
        # dense contract profile.)
        rawB = np.zeros(BS, np.int32)
        distB = np.zeros(BS, np.int32)
        valid = [p for p in range(BS) if p <= n - G]
        keys = {p: bytes(padded[p : p + LCP_CAP]) for p in valid}
        order = sorted(valid, key=lambda p: (keys[p], p))
        for i, p in enumerate(order):
            for j in (i - 2, i - 1, i + 1, i + 2):
                if 0 <= j < len(order):
                    cand = order[j]
                    if cand < p:
                        consider(rawB, distB, p, cand, LCP_CAP)
        mlenB, distB = clip(rawB, distB)
        better = (mlenB > mlen) | ((mlenB == mlen) & (distB < dist))
        mlen = np.where(better, mlenB, mlen)
        dist = np.where(better, distB, dist)

    # run tier: exact-reach periodic matches at short distances — byte q
    # continues a period-d copy iff data[q] == data[q-d]; the match at p
    # runs to the first break (true, uncapped reach)
    for d in RUN_DISTS:
        eq = np.zeros(n, bool)
        eq[d:] = data[d:] == data[: n - d]
        nxt_false = n  # first position >= p where the period breaks
        for p in range(n - 1, -1, -1):
            if not eq[p]:
                nxt_false = p
                continue
            l = nxt_false - p
            if l >= G and (l > mlen[p] or (l == mlen[p] and d < dist[p])):
                mlen[p] = l
                dist[p] = d

    return mlen, dist


def spec_inherit(mlen, dist, n: int):
    """Stage 2: per-anchor max-reach prefix winner.

    The winner start is the first record of the current SAME-DISTANCE record
    chain (records with equal dist starting within the previous record's
    reach cover one contiguous region — the chain head is the verified
    region start, which restores lead slack under LCP capping)."""
    na = BS // G
    r2 = np.full(na, -1, np.int32)
    d2 = np.zeros(na, np.int32)
    s2 = np.full(na, -1, np.int32)
    best_r, best_d, chain_s = -1, 0, -1
    for k in range(na):
        for p in range(G * k - G + 1, G * k + 1):  # positions (4(k-1), 4k]
            if p < 0:
                continue
            reach = p + mlen[p] if mlen[p] >= G else -1
            if reach > best_r:  # new record
                if dist[p] != best_d or p > best_r:
                    chain_s = p  # chain break: new contiguous region
                best_r, best_d = reach, dist[p]
        r2[k], d2[k], s2[k] = best_r, best_d, chain_s
    return r2, d2, s2


def spec_elect(mlen, dist, inh, n: int):
    """Stage 3: quantized hysteresis election at anchors."""
    na = BS // G
    r2, d2, s2 = inh
    is_copy = np.zeros(na, bool)
    ad = np.zeros(na, np.int32)
    lead = np.zeros(na, np.int32)
    tail = np.zeros(na, np.int32)

    best_key, best_d, best_r, chain_s = (-1, -1), 0, -1, -1
    for k in range(na):
        a = G * k
        for p in range(a - G + 1, a + 1):
            if p < 0:
                continue
            if mlen[p] >= G:
                reach = p + mlen[p]
                key = (reach // HYST_Q, -p)   # highest band, earliest start
                if key > best_key:  # new record
                    if dist[p] != best_d or p > best_r:
                        chain_s = p  # chain break: new contiguous region
                    best_key, best_d, best_r = key, dist[p], reach
        n_ok = a + G <= n
        use1 = best_r >= a + G and 1 <= best_d <= a
        use2 = r2[k] >= a + G and 1 <= d2[k] <= a
        if n_ok and (use1 or use2):
            is_copy[k] = True
            ad[k] = best_d if use1 else d2[k]
            sel_r = best_r if use1 else r2[k]
            sel_s = chain_s if use1 else s2[k]
            lead[k] = max(a - sel_s, 0)
            tail[k] = max(sel_r - (a + G), 0)
    return is_copy, ad, lead, tail


def spec_reglue(block, is_copy, ad, lead, tail, n: int):
    """Stage 4: two byte-verified distance-adoption rounds."""
    na = BS // G
    data = block
    for direction in ("left", "right"):
        left_d = np.concatenate([[0], ad[: na - 1]])
        right_d = np.concatenate([ad[1:], [0]])
        nb_d, other = (left_d, right_d) if direction == "left" else (right_d, left_d)
        new_is, new_ad = is_copy.copy(), ad.copy()
        for k in range(na):
            a = G * k
            loose = not is_copy[k] or ad[k] != other[k]
            if (
                loose
                and 1 <= nb_d[k] <= a
                and a + G <= n
                and nb_d[k] != ad[k]
                and np.array_equal(data[a - nb_d[k] : a - nb_d[k] + G], data[a : a + G])
            ):
                new_is[k] = True
                new_ad[k] = nb_d[k]
                lead[k] = 0
                tail[k] = 0
        is_copy, ad = new_is, new_ad
    return is_copy, ad, lead, tail


def spec_intervals(is_copy, ad, lead, tail, n: int):
    """Stage 5a: stretched copy intervals [(start, end, d)] in byte space."""
    na = BS // G
    runs = []  # (first_anchor, last_anchor, d)
    k = 0
    while k < na:
        if is_copy[k]:
            j = k
            while j + 1 < na and is_copy[j + 1] and ad[j + 1] == ad[k]:
                j += 1
            runs.append([k, j, int(ad[k])])
            k = j + 1
        else:
            k += 1

    ivals = []
    prev_cover = 0
    for i, (ks, ke, d) in enumerate(runs):
        a_s, a_e = G * ks, G * ke
        next_start = G * runs[i + 1][0] if i + 1 < len(runs) else n
        tail_fin = min(int(tail[ke]), max(min(next_start, n) - (a_e + G), 0))
        lead_fin = min(int(lead[ks]), a_s - prev_cover)
        start = a_s - lead_fin
        end = a_e + G + tail_fin
        prev_cover = end
        ivals.append((start, end, d))
    return ivals


def _chunk_ops(start: int, end: int, d: int):
    """60/64 chunking of one interval (snappy_compression.c:153-165)."""
    ops = []
    q = start
    while q < end:
        rem = end - q
        if rem <= C.MAX_COPY_LEN:
            ln = rem
        elif rem <= 67:
            ln = 60
        else:
            ln = C.MAX_COPY_LEN
        ops.append((q, ln, d))
        q += ln
    return ops


def spec_emit(block, ivals, n: int) -> bytes:
    """Stage 5b: serialize intervals + literal gaps into the element
    stream."""
    out = bytearray()
    pos = 0

    def emit_literal(lo, hi):
        ln = hi - lo
        if ln <= 0:
            return
        m = ln - 1
        if ln <= C.LITERAL_MAX_INLINE_LEN:
            out.append(m << 2)
        elif m < (1 << 8):
            out.append(C.LITERAL_CODE_1BYTE << 2)
            out.append(m & 0xFF)
        else:
            out.append(C.LITERAL_CODE_2BYTE << 2)
            out.append(m & 0xFF)
            out.append(m >> 8)
        out.extend(block[lo:hi].tobytes())

    for start, end, d in ivals:
        emit_literal(pos, start)
        for q, ln, dd in _chunk_ops(start, end, d):
            if C.COPY1_MIN_LEN <= ln <= C.COPY1_MAX_LEN and dd < C.COPY1_MAX_OFFSET:
                out.append((dd >> 8) << 5 | (ln - 4) << 2 | C.TAG_COPY1)
                out.append(dd & 0xFF)
            else:
                out.append((ln - 1) << 2 | C.TAG_COPY2)
                out.append(dd & 0xFF)
                out.append(dd >> 8)
        pos = end
    emit_literal(pos, n)
    return bytes(out)


def spec_encode_block(block: np.ndarray, n: int, dense: bool = True):
    """Full single-block spec encode; returns (bytes, intermediates dict)."""
    block = np.asarray(block, np.uint8)
    assert block.shape == (BS,)
    mlen, dist = spec_matches(block, n, dense)
    inh = spec_inherit(mlen, dist, n)
    is_copy, ad, lead, tail = spec_elect(mlen, dist, inh, n)
    is_copy, ad, lead, tail = spec_reglue(block, is_copy, ad, lead, tail, n)
    ivals = spec_intervals(is_copy, ad, lead, tail, n)
    stream = spec_emit(block, ivals, n)
    return stream, {
        "mlen": mlen,
        "dist": dist,
        "inherit": inh,
        "is_copy": is_copy,
        "ad": ad,
        "lead": lead,
        "tail": tail,
        "intervals": ivals,
    }
