"""Host-side stream framing: block packing, stream assembly, raw-stream
splitting.

A Snappy stream is a varint preamble + one op stream with invisible block
boundaries (snappy_compression.c:414-428).  The device works on fixed-shape
independent blocks, so this layer:

  * packs input bytes into (B, BS) zero-padded blocks + length vector,
  * assembles per-block compressed outputs (padded + lengths) into one
    contiguous wire stream,
  * splits an incoming raw stream back into per-block op chunks by walking op
    lengths and cutting where cumulative output crosses a BS multiple — valid
    for streams from the reference and from any block-disciplined encoder
    (google/snappy included); streams whose ops straddle block boundaries
    fall back to the sequential model/C++ decoder.
"""

from __future__ import annotations

import numpy as np

from ..format import constants as C
from ..format.varint import decode_varint, encode_varint
from ..model.decode import CorruptError, parse_op


def pack_blocks(data: np.ndarray, block_size: int = C.MAX_BLOCK_SIZE):
    """bytes -> ((B, block_size) uint8 zero-padded, (B,) int32 lengths)."""
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    n = arr.shape[0]
    nblocks = max((n + block_size - 1) // block_size, 1)
    blocks = np.zeros((nblocks, block_size), dtype=np.uint8)
    flat = blocks.reshape(-1)
    flat[:n] = arr
    lens = np.full(nblocks, block_size, dtype=np.int32)
    lens[-1] = n - (nblocks - 1) * block_size
    return blocks, lens


def assemble_stream(
    comp: np.ndarray, comp_lens: np.ndarray, total_uncompressed: int
) -> bytes:
    """Per-block padded outputs + true lengths -> wire stream with preamble.

    Host-side compaction of the device's fixed-size outputs (the
    variable-length gather SURVEY.md §5.8 calls for)."""
    out = bytearray(encode_varint(total_uncompressed))
    for i in range(comp.shape[0]):
        out += comp[i, : int(comp_lens[i])].tobytes()
    return bytes(out)


def split_ops_stream(ops: np.ndarray, out_len: int, block_size: int = C.MAX_BLOCK_SIZE):
    """Split an op stream (no preamble) into per-block chunks.

    Returns (chunks, out_lens): chunks[i] is a uint8 array of the ops that
    produce out_lens[i] bytes, with every chunk's output <= block_size and
    aligned so no op straddles a block boundary.  Raises CorruptError if the
    stream cannot be split that way (then use the sequential decoder)."""
    chunks: list[np.ndarray] = []
    out_lens: list[int] = []
    p = 0
    w = 0
    chunk_start = 0
    chunk_out = 0
    n = ops.shape[0]
    while w < out_len:
        if p >= n:
            raise CorruptError("stream ended before output complete")
        kind, length, payload, p_next = parse_op(ops, p)
        if chunk_out + length > block_size:
            raise CorruptError("op straddles block boundary; cannot split")
        p = p_next
        w += length
        chunk_out += length
        if chunk_out == block_size or w == out_len:
            chunks.append(ops[chunk_start:p])
            out_lens.append(chunk_out)
            chunk_start = p
            chunk_out = 0
    if p != n:
        raise CorruptError("trailing garbage after output complete")
    if not chunks:
        chunks.append(np.zeros(0, dtype=np.uint8))
        out_lens.append(0)
    return chunks, out_lens


def split_ops_windowed(ops: np.ndarray, out_len: int,
                       block_size: int = C.MAX_BLOCK_SIZE,
                       comp_cap: int = C.MAX_COMPRESSED_BLOCK_SIZE):
    """Split an op stream at ARBITRARY op boundaries for the windowed
    (sliding-context) device decoder — for valid streams whose ops straddle
    64 KiB output boundaries and so fail split_ops_stream.

    Returns (chunks, out_lens, ctx_lens): chunk i produces out_lens[i]
    (<= block_size) bytes and its copies may reach ctx_lens[i] =
    min(previous output, 64 KiB) bytes back past its own start.  Raises
    CorruptError when no such split exists (a single op larger than a
    window — e.g. a >64 KiB literal — or a malformed stream); callers then
    use the sequential host decoder."""
    chunks: list[np.ndarray] = []
    out_lens: list[int] = []
    p = 0
    w = 0
    chunk_start = 0
    chunk_out = 0
    n = ops.shape[0]
    while w < out_len:
        if p >= n:
            raise CorruptError("stream ended before output complete")
        kind, length, payload, p_next = parse_op(ops, p)
        if length > block_size or (p_next - p) > comp_cap:
            raise CorruptError("single op exceeds window bounds")
        if w + length > out_len:
            raise CorruptError("op output overruns declared length")
        if chunk_out + length > block_size or (p_next - chunk_start) > comp_cap:
            chunks.append(ops[chunk_start:p])
            out_lens.append(chunk_out)
            chunk_start = p
            chunk_out = 0
        p = p_next
        w += length
        chunk_out += length
    if p != n:
        raise CorruptError("trailing garbage after output complete")
    chunks.append(ops[chunk_start:p])
    out_lens.append(chunk_out)
    starts = np.concatenate([[0], np.cumsum(out_lens)[:-1]])
    ctx_lens = np.minimum(starts, C.MAX_BLOCK_SIZE).astype(np.int32)
    return chunks, out_lens, ctx_lens


def pad_chunks(chunks, pad_to: int = C.MAX_COMPRESSED_BLOCK_SIZE):
    """Variable-length chunks -> ((B, pad_to) uint8, (B,) int32)."""
    B = len(chunks)
    out = np.zeros((B, pad_to), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, ch in enumerate(chunks):
        if ch.shape[0] > pad_to:
            raise CorruptError("compressed chunk exceeds worst-case bound")
        out[i, : ch.shape[0]] = ch
        lens[i] = ch.shape[0]
    return out, lens


def read_preamble(data: np.ndarray) -> tuple[int, int]:
    """-> (uncompressed_length, ops_start_offset)."""
    return decode_varint(data)
