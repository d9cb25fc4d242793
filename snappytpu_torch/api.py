"""High-level codec API on the port: compress/decompress raw Snappy streams
with host framing, on an explicit torch device.

The counterpart of snappytpu.api, producing byte-identical streams.  Two
differences from the JAX package:

  * Host-resident block-splittable streams decode through the block decoder
    (K2).  The JAX package sends them to its tape kernel when the native
    runtime is present, a route chosen for the TPU's scalar latency; whether
    it pays on Hopper is for a measured later change.
  * A valid stream that is not block-splittable needs the windowed decoder
    (K4), which is not ported yet: `decompress` raises NotImplementedError
    for it rather than decoding on the host.  Streams with single ops wider
    than a window go to the native host decoder, as in the JAX package.

There is no power-of-two batch bucketing (it bounded jit recompiles only);
a device call takes at most 128 blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from snappytpu import cpu
from snappytpu.format import constants as C
from snappytpu.format.varint import encode_varint
from snappytpu.model.decode import CorruptError, decode_ops
from snappytpu.stream import framing

from .kernels.decode_vm import decode_blocks_vm as decode_blocks
from .kernels.encode_v2 import encode_blocks_v2

_MAX_DEVICE_BATCH = 128  # blocks per device call (8 MiB input per call)


def encode_blocks(blocks, lens, profile="dense"):
    return encode_blocks_v2(blocks, lens, dense=(profile != "fast"))


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def encode_array_pieces(arr: np.ndarray, profile: str, *, device):
    """Encode a byte array on `device`, yielding compacted wire pieces (no
    preamble) one device batch at a time."""
    blocks, lens = framing.pack_blocks(arr)
    for start in range(0, blocks.shape[0], _MAX_DEVICE_BATCH):
        bb = torch.from_numpy(blocks[start : start + _MAX_DEVICE_BATCH]).to(device)
        bl = torch.from_numpy(lens[start : start + _MAX_DEVICE_BATCH]).to(device)
        comp, totals = encode_blocks(bb, bl, profile)
        comp, totals = comp.cpu().numpy(), totals.cpu().numpy()
        if (totals < 0).any():
            # the emission-capacity guard poisoned a block: unreachable for
            # legal geometry, but never emit a truncated stream
            raise RuntimeError(
                f"encoder capacity overflow in block(s) {(start + np.nonzero(totals < 0)[0]).tolist()}"
            )
        if cpu.available:
            yield cpu.compact(comp, totals)
        else:
            for i in range(comp.shape[0]):
                yield comp[i, : totals[i]].tobytes()


def compress(data: bytes | np.ndarray, profile: str = "dense", *, device) -> bytes:
    """Encode a byte string into a raw Snappy stream on `device`.

    profile: "dense" (default) or "fast", as in snappytpu.api.compress."""
    arr = _as_u8(data)
    if arr.size == 0:
        return encode_varint(0)
    return b"".join([encode_varint(arr.size), *encode_array_pieces(arr, profile, device=device)])


def _unsplittable(arr: np.ndarray, ops: np.ndarray, out_len: int) -> bytes:
    """A stream whose ops straddle 64 KiB output blocks."""
    try:
        framing.split_ops_windowed(ops, out_len)
    except CorruptError:
        # giant-op stream, or one no window can prove valid: the sequential
        # host decoder decodes the valid ones and raises on the corrupt ones
        if cpu.available:
            return cpu.decompress(arr)
        return decode_ops(ops, out_len).tobytes()
    raise NotImplementedError(
        "stream is valid but not block-splittable; it needs the windowed "
        "decoder (TPU kernel K4, decode_vm2.decode_stream_vm), which is not ported yet"
    )


def decompress(data: bytes | np.ndarray, *, device) -> bytes:
    """Decode a raw Snappy stream, its blocks on `device` through the
    block decoder; CorruptError if a block is malformed."""
    arr = _as_u8(data)
    out_len, ops_start = framing.read_preamble(arr)
    if out_len == 0:
        if arr.size != ops_start:
            raise CorruptError("trailing garbage after empty stream")
        return b""
    ops = arr[ops_start:]
    if cpu.available:
        try:
            offs, out_lens = cpu.scan_ops(ops, out_len)
            padded, comp_lens = cpu.split_rows(ops, offs, C.MAX_COMPRESSED_BLOCK_SIZE)
        except cpu.NativeError:
            return _unsplittable(arr, ops, out_len)
    else:
        try:
            chunks, out_lens = framing.split_ops_stream(ops, out_len)
        except CorruptError:
            return _unsplittable(arr, ops, out_len)
        padded, comp_lens = framing.pad_chunks(chunks)
    out_lens = np.asarray(out_lens, np.int32)
    pieces = []
    for start in range(0, padded.shape[0], _MAX_DEVICE_BATCH):
        end = start + _MAX_DEVICE_BATCH
        out, ok = decode_blocks(
            torch.from_numpy(padded[start:end]).to(device),
            torch.from_numpy(comp_lens[start:end]).to(device),
            torch.from_numpy(out_lens[start:end]).to(device),
        )
        out, ok = out.cpu().numpy(), ok.cpu().numpy()
        if not ok.all():
            raise CorruptError(f"malformed block(s) {(start + np.nonzero(~ok)[0]).tolist()}")
        if cpu.available:
            pieces.append(cpu.compact(out, out_lens[start:end]))
        else:
            pieces.extend(out[i, : out_lens[start + i]].tobytes() for i in range(out.shape[0]))
    return b"".join(pieces)
