"""Bounded-memory file-to-file codec on the port — the counterpart of
snappytpu.stream.filecodec, on an explicit torch device.

A window of blocks is staged, encoded or decoded on `device`, written out
and dropped, so resident memory is O(window), independent of file size.

  * compress_file: the varint preamble comes from the file's size, then
    windows are encoded independently; the output is byte-identical to
    api.compress of the whole file (and to the JAX package's).
  * decompress_file: the native op-boundary scan walks the stream through a
    read-only memmap; each window of blocks is split from it and decoded by
    api.decompress's block route (K2 on a CUDA device, K5's host tapes
    elsewhere) into a window-sized buffer and appended.  Streams the scan
    cannot split, blocks wider than a compressed row, a block the route
    flags not ok (a copy reaching back across the 64 KiB grid, which raw
    Snappy allows, or a malformed block), and installs without the native
    runtime go to the in-memory api.decompress, which decodes a valid
    stream and raises CorruptError on a malformed one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import api, cpu, hostbuf
from ..format import constants as C
from ..format.varint import encode_varint
from ..model.decode import CorruptError
from . import framing

# 32 MiB of input blocks per staged window: 4 full device calls (api.DEVICE_BATCH)
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
    size.  CorruptError if the stream is malformed."""
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
    lens, written, n = lens.astype(np.int32), 0, 0
    with open(dst, "wb") as w:
        for g0 in range(0, offs.size, window_blocks):
            g1 = min(g0 + window_blocks, offs.size)
            base, end = int(offs[g0]), int(offs[g1]) if g1 < offs.size else ops.size
            out = hostbuf.take("filecodec.out", (int(lens[g0:g1].sum()),), torch.uint8).numpy()
            try:  # NativeError: a block wider than a compressed row (tiny ops, or corrupt)
                n = api.decode_rows(*api.split_blocks(ops[base:end], offs[g0:g1] - base, device=device),
                                    lens[g0:g1], out, device=device)
            except cpu.NativeError:
                n = None
            if n is None:
                break
            written += w.write(out[:n])
    if n is None:  # api.decompress decides, as for a stream in memory
        return _in_memory(m, dst, device)
    if written != out_len:
        raise CorruptError(f"decoded {written} bytes, preamble said {out_len}")
    return written
