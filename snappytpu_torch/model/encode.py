"""Numpy model encoder — the executable specification of the TPU encoder.

This is not a port of the reference C encoder; it is the *spec* for the
TPU-native algorithm, written in numpy so every intermediate array can be
diffed against the JAX/Pallas kernels:

  phase 1  grams:      the 4/8/16-byte grams starting at every position
  phase 2  candidates: for each gram tier, the nearest (and for 4-grams also
                       the second-nearest) previous position holding the same
                       gram — collision-free, computed by stable sort, so
                       strictly denser than the reference's 4096-entry hash
                       table (snappy_compression.c:81-84) and at least as dense
                       as its BST variant (snappy_compression_tree.c:174-180).
                       Longer-gram tiers anchor long phrase continuations the
                       way the reference's sparse path-only table insertions do
                       implicitly (snappy_compression.c:303-307).
  phase 3  best match: exact LCP (capped at MAX_COPY_LEN and block end)
                       against every candidate; keep the longest, breaking
                       ties toward the smallest offset (cheaper copy ops)
  phase 4  greedy parse: walk the block, taking every best match of length
                       >= 4 (no skip heuristic — every position is scanned;
                       the reference skips for CPU speed,
                       snappy_compression.c:277-282)
  phase 5  refinement: drop copies whose realized net benefit is negative
                       (a short far copy splitting a long literal run costs
                       more in headers than it saves), iterated to fixpoint —
                       all drops evaluated simultaneously per round so the
                       device kernel can replicate the pass exactly
  phase 6  emission:   literal runs + copy ops in the Snappy wire format
                       (tag layout per snappy_compression.c:95-165)

Blocks are MAX_BLOCK_SIZE bytes and fully independent, matching the reference's
block discipline (snappy_compression.c:419-425), so output remains decodable by
any Snappy decoder and block-parallel on the mesh.
"""

from __future__ import annotations

import numpy as np

from ..format import constants as C
from ..format.varint import encode_varint

# Gram tiers used for candidate generation.  (tier_len, n_predecessors)
# A tier-t hit guarantees a match of length >= t, so with the LCP cap at
# MAX_COPY_LEN=64 the 64-gram tier finds a cap-achieving match whenever one
# exists, and every true best match of length L is found at >= L/2 length by
# the tier just below it.
GRAM_TIERS = ((4, 2), (8, 1), (16, 1), (32, 1), (64, 1))

_MIX1 = np.uint32(0x9E3779B1)  # golden-ratio multiplier (Knuth)
_MIX2 = np.uint32(0x85EBCA77)  # murmur3 finalizer constant


def gram_hashes(words: np.ndarray, gram_len: int) -> np.ndarray:
    """uint32 hash of the gram_len-byte gram at each position, built
    hierarchically: h_{2g}[p] = mix(h_g[p], h_g[p+g]), h_4 = the exact word.
    Collisions only produce extra candidates (discarded by exact LCP
    verification), never wrong output.  Device kernels use the same function
    so (hash, position) sorts match the model bit-for-bit."""
    h = words
    g = 4
    n = words.shape[0]
    while g < gram_len:
        shifted = np.zeros(n, dtype=np.uint32)
        if g < n:
            shifted[: n - g] = h[g:]
        with np.errstate(over="ignore"):
            h = (h * _MIX1) ^ ((shifted * _MIX2) >> np.uint32(3)) ^ (shifted << np.uint32(13))
        g *= 2
    return h


def word32(block: np.ndarray) -> np.ndarray:
    """Big-endian 4-byte word starting at each position; positions past
    n-4 read zero padding (callers mask them out)."""
    n = block.shape[0]
    padded = np.zeros(n + 3, dtype=np.uint32)
    padded[:n] = block
    return (
        (padded[:n] << 24)
        | (padded[1 : n + 1] << 16)
        | (padded[2 : n + 2] << 8)
        | padded[3 : n + 3]
    )


def nearest_prev_occurrences(
    keys: tuple[np.ndarray, ...], n_valid: int, n_pred: int
) -> list[np.ndarray]:
    """For each position p < n_valid, the n_pred largest positions p' < p whose
    key tuple equals p's, or -1.  Stable sort by (keys..., position); the k-th
    predecessor of an element in sorted order shares its key iff all elements
    between them do."""
    n = keys[0].shape[0]
    out = [np.full(n, -1, dtype=np.int64) for _ in range(n_pred)]
    if n_valid <= 0:
        return out
    ks = [k[:n_valid] for k in keys]
    order = np.lexsort(tuple(reversed(ks)))  # primary = keys[0], ties by pos
    sorted_keys = [k[order] for k in ks]
    same_as_prev = np.ones(n_valid, dtype=bool)
    same_as_prev[0] = False
    for k in sorted_keys:
        same_as_prev[1:] &= k[1:] == k[:-1]
    run_same = same_as_prev.copy()
    for j in range(n_pred):
        prev = np.full(n_valid, -1, dtype=np.int64)
        idx = np.nonzero(run_same)[0]
        prev[idx] = order[idx - (j + 1)]
        out[j][order] = prev
        if j + 1 < n_pred:
            shifted = np.zeros(n_valid, dtype=bool)
            shifted[1:] = same_as_prev[:-1]
            run_same = run_same & shifted
    return out


def candidate_set(block: np.ndarray, n: int,
                  hashes: dict[int, np.ndarray] | None = None,
                  tiers_spec=GRAM_TIERS) -> np.ndarray:
    """(K, n) candidate positions per position (-1 = none)."""
    if hashes is None:
        words = word32(block)
        hashes = {g: gram_hashes(words, g) for g, _ in GRAM_TIERS}
    tiers: list[np.ndarray] = []
    for gram_len, n_pred in tiers_spec:
        h = hashes[gram_len]
        n_valid = max(n - (gram_len - 1), 0)
        tiers.extend(nearest_prev_occurrences((h,), n_valid, n_pred))
    return np.stack(tiers, axis=0)


def lcp_lengths(block: np.ndarray, cand: np.ndarray, n: int) -> np.ndarray:
    """Exact common-prefix length (capped at MAX_COPY_LEN and block end)
    between each position and a candidate array; 0 where cand < 0."""
    mlen = np.zeros(block.shape[0], dtype=np.int64)
    valid = cand >= 0
    pos = np.nonzero(valid)[0]
    if pos.size == 0:
        return mlen
    src = cand[pos]
    alive = np.ones(pos.size, dtype=bool)
    length = np.zeros(pos.size, dtype=np.int64)
    for j in range(C.MAX_COPY_LEN):
        in_range = pos + j < n
        eq = np.zeros(pos.size, dtype=bool)
        sel = alive & in_range
        eq[sel] = block[pos[sel] + j] == block[src[sel] + j]
        alive = alive & eq
        length += alive
    mlen[pos] = length
    return mlen


def quantized_lcp(words: np.ndarray, cand: np.ndarray, n: int,
                  hashes: dict[int, np.ndarray]) -> np.ndarray:
    """Hash-quantized LCP estimate: the largest gram tier whose hash matches
    between each position and its candidate (0 if none).  5 cheap gathers per
    candidate instead of a 17-round exact LCP; the winner is verified exactly
    afterwards, so hash collisions can only cost density, never correctness."""
    size = words.shape[0]
    est = np.zeros(size, dtype=np.int64)
    valid = cand >= 0
    pos = np.nonzero(valid)[0]
    if pos.size == 0:
        return est
    c = cand[pos]
    for gram_len, _ in GRAM_TIERS:
        h = hashes[gram_len]
        ok = (h[pos] == h[c]) & (pos <= n - gram_len) & (c <= n - gram_len)
        est[pos] = np.where(ok, gram_len, est[pos])
    return est


def best_match(block: np.ndarray, n: int,
               tiers_spec=GRAM_TIERS) -> tuple[np.ndarray, np.ndarray]:
    """Per-position best (length, distance).

    Selection is two-stage, mirroring the device pipeline: every candidate is
    scored by its hash-quantized LCP estimate (ties toward the smallest
    distance), then the single winner's exact LCP is computed."""
    size = block.shape[0]
    words = word32(block)
    hashes = {g: gram_hashes(words, g) for g, _ in GRAM_TIERS}
    cands = candidate_set(block, n, hashes, tiers_spec)
    positions = np.arange(size, dtype=np.int64)
    best_est = np.full(size, -1, dtype=np.int64)
    best_cand = np.full(size, -1, dtype=np.int64)
    best_dist = np.zeros(size, dtype=np.int64)
    for k in range(cands.shape[0]):
        est = quantized_lcp(words, cands[k], n, hashes)
        dist = positions - cands[k]
        valid = cands[k] >= 0
        better = valid & (
            (est > best_est) | ((est == best_est) & (dist < best_dist))
        )
        best_est = np.where(better, est, best_est)
        best_cand = np.where(better, cands[k], best_cand)
        best_dist = np.where(better, dist, best_dist)
    mlen = lcp_lengths(block, best_cand, n)
    return mlen, np.where(mlen > 0, best_dist, 0)


def greedy_parse(mlen: np.ndarray, dist: np.ndarray, n: int):
    """Greedy left-to-right parse.  Returns list of ops:
    ('lit', start, length) / ('copy', length, offset)."""
    ops = []
    p = 0
    lit_start = 0
    while p < n:
        l = int(mlen[p])
        if l >= C.MIN_MATCH_LEN:
            if p > lit_start:
                ops.append(("lit", lit_start, p - lit_start))
            ops.append(("copy", l, int(dist[p])))
            p += l
            lit_start = p
        else:
            p += 1
    if p > lit_start:
        ops.append(("lit", lit_start, p - lit_start))
    return ops


def refine_parse(ops):
    """Drop copies whose net benefit, given realized literal-run neighbors, is
    negative.  All candidates in a round are evaluated against the same parse
    and dropped simultaneously (device-kernel replicable); iterate to fixpoint.
    """
    ops = list(ops)
    for _ in range(4):
        drops = []
        for i, op in enumerate(ops):
            if op[0] != "copy":
                continue
            length, offset = op[1], op[2]
            left = ops[i - 1][2] if i > 0 and ops[i - 1][0] == "lit" else 0
            right = ops[i + 1][2] if i + 1 < len(ops) and ops[i + 1][0] == "lit" else 0
            benefit = (
                length
                + C.literal_header_len(left + length + right)
                - C.copy_op_len(length, offset)
                - (C.literal_header_len(left) if left else 0)
                - (C.literal_header_len(right) if right else 0)
            )
            if benefit < 0:
                drops.append(i)
        if not drops:
            return ops
        # rebuild: dropped copies become literal coverage; merge adjacent runs
        drop_set = set(drops)
        intervals = []  # (kind, start, len, offset) in input-coverage order
        pos = 0
        for i, op in enumerate(ops):
            if op[0] == "lit":
                intervals.append(["lit", op[1], op[2], 0])
                pos = op[1] + op[2]
            else:
                if i in drop_set:
                    intervals.append(["lit", pos, op[1], 0])
                else:
                    intervals.append(["copy", pos, op[1], op[2]])
                pos += op[1]
        merged = []
        for item in intervals:
            if merged and item[0] == "lit" and merged[-1][0] == "lit":
                merged[-1][2] += item[2]
            else:
                merged.append(item)
        ops = [
            ("lit", s, l) if k == "lit" else ("copy", l, o) for k, s, l, o in merged
        ]
    return ops


def emit_ops(ops, block: np.ndarray) -> bytes:
    """Serialize a parse into Snappy wire bytes (no preamble)."""
    out = bytearray()
    for op in ops:
        if op[0] == "lit":
            _, start, length = op
            n = length - 1
            if length <= C.LITERAL_MAX_INLINE_LEN:
                out.append(n << 2)
            elif n < (1 << 8):
                out.append(C.LITERAL_CODE_1BYTE << 2)
                out.append(n)
            elif n < (1 << 16):
                out.append(C.LITERAL_CODE_2BYTE << 2)
                out += n.to_bytes(2, "little")
            elif n < (1 << 24):
                out.append(C.LITERAL_CODE_3BYTE << 2)
                out += n.to_bytes(3, "little")
            else:
                out.append(C.LITERAL_CODE_4BYTE << 2)
                out += n.to_bytes(4, "little")
            out += block[start : start + length].tobytes()
        else:
            _, length, offset = op
            if (
                C.COPY1_MIN_LEN <= length <= C.COPY1_MAX_LEN
                and offset < C.COPY1_MAX_OFFSET
            ):
                out.append(((offset >> 8) << 5) | ((length - 4) << 2) | C.TAG_COPY1)
                out.append(offset & 0xFF)
            else:
                out.append(((length - 1) << 2) | C.TAG_COPY2)
                out += offset.to_bytes(2, "little")
    return bytes(out)


def encode_block(block: np.ndarray, tiers_spec=GRAM_TIERS) -> bytes:
    """Encode one block (<= MAX_BLOCK_SIZE bytes of uint8) to Snappy ops."""
    block = np.ascontiguousarray(block, dtype=np.uint8)
    n = block.shape[0]
    if n == 0:
        return b""
    if n > C.MAX_BLOCK_SIZE:
        raise ValueError("block larger than MAX_BLOCK_SIZE")
    mlen, dist = best_match(block, n, tiers_spec)
    ops = refine_parse(greedy_parse(mlen, dist, n))
    return emit_ops(ops, block)


def compress(data: bytes | np.ndarray, block_size: int = C.MAX_BLOCK_SIZE,
             tiers_spec=GRAM_TIERS) -> bytes:
    """Full Snappy stream: varint preamble + concatenated block ops
    (block boundaries are invisible in the stream, matching the reference,
    snappy_compression.c:414-428)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    out = bytearray(encode_varint(arr.shape[0]))
    for start in range(0, arr.shape[0], block_size):
        out += encode_block(arr[start : start + block_size], tiers_spec)
    return bytes(out)
