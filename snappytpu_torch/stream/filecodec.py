"""Bounded-memory file-to-file codec on the port — the counterpart of
snappytpu.stream.filecodec, on an explicit torch device.

A window of blocks is staged, encoded or decoded on `device`, written out
and dropped, so resident memory is O(window), independent of file size.

  * compress_file: the varint preamble comes from the file's size, then
    windows are encoded independently; the output is byte-identical to
    api.compress of the whole file (and to the JAX package's).
  * decompress_file: the native op-boundary scan walks the stream through a
    read-only memmap, and each window of blocks is copied, decoded by the
    tape decoder (host tapes, device moves), checked and appended.  Streams
    the scan cannot split, blocks wider than a compressed row, and installs
    without the native runtime go to the in-memory api.decompress.
"""

from __future__ import annotations

import os

import numpy as np

from .. import api
from ..format import constants as C
from ..format.varint import encode_varint
from ..kernels.decode_tape import decode_blocks_tape
from ..model.decode import CorruptError
from . import framing

# 32 MiB of input blocks per staged window: 4 device batches of 128 blocks
_DEF_WINDOW_BLOCKS = 512


def compress_file(src: str | os.PathLike, dst: str | os.PathLike, profile: str = "dense",
                  window_blocks: int = _DEF_WINDOW_BLOCKS, *, device) -> int:
    """Stream-compress a file on `device`; returns the compressed size."""
    size = os.path.getsize(src)
    window = window_blocks * C.MAX_BLOCK_SIZE
    with open(src, "rb") as r, open(dst, "wb") as w:
        written = w.write(encode_varint(size))
        while chunk := r.read(window):
            for piece in api.encode_array_pieces(np.frombuffer(chunk, np.uint8), profile, device=device):
                written += w.write(piece)
    return written


def _in_memory(m: np.ndarray, dst, device) -> int:
    data = api.decompress(np.asarray(m), device=device)
    with open(dst, "wb") as w:
        w.write(data)
    return len(data)


def decompress_file(src: str | os.PathLike, dst: str | os.PathLike,
                    window_blocks: int = _DEF_WINDOW_BLOCKS, *, device) -> int:
    """Stream-decompress a raw Snappy file on `device`; returns the output
    size.  CorruptError (or NativeError) if the stream is malformed."""
    from .. import cpu

    m = np.memmap(src, dtype=np.uint8, mode="r")
    out_len, start = framing.read_preamble(np.asarray(m[:32]).copy())
    if out_len == 0:
        if m.size != start:
            raise CorruptError("trailing garbage after empty stream")
        open(dst, "wb").close()
        return 0
    if not cpu.available:
        return _in_memory(m, dst, device)
    ops = m[start:]
    try:
        offs, lens = cpu.scan_ops(ops, out_len)
    except cpu.NativeError:
        return _in_memory(m, dst, device)  # windowed / sequential routes
    ends = np.concatenate([offs[1:], [ops.size]])
    if (ends - offs > C.MAX_COMPRESSED_BLOCK_SIZE).any():
        # a valid stream (e.g. all 1-byte literals) may carry more than a
        # compressed row per 64 KiB block; the windowed route decodes it
        return _in_memory(m, dst, device)
    written = 0
    with open(dst, "wb") as w:
        for g0 in range(0, offs.size, window_blocks):
            g1 = min(g0 + window_blocks, offs.size)
            base = int(offs[g0])
            comp_win = np.array(ops[base : int(ends[g1 - 1])])  # window copy
            rows, comp_lens = cpu.split_rows(comp_win, offs[g0:g1] - base, C.MAX_COMPRESSED_BLOCK_SIZE)
            win_lens = lens[g0:g1].astype(np.int32)
            for b0 in range(0, rows.shape[0], 128):
                b1 = b0 + 128
                out, ok = decode_blocks_tape(rows[b0:b1], comp_lens[b0:b1], win_lens[b0:b1], device=device)
                out, ok = out.cpu().numpy(), ok.cpu().numpy()
                if not ok.all():
                    raise CorruptError(f"malformed block(s) {(g0 + b0 + np.nonzero(~ok)[0]).tolist()}")
                written += w.write(cpu.compact(out, win_lens[b0:b1]))
    if written != out_len:
        raise CorruptError(f"decoded {written} bytes, preamble said {out_len}")
    return written
