"""High-level codec API on the port: compress/decompress raw Snappy streams
with host framing, on an explicit torch device.

The counterpart of snappytpu.api, producing byte-identical streams and
taking the same decode routes:

  * a block-splittable stream decodes as independent blocks: through the
    tape decoder K5 (host-built movement tapes, kernels/decode_tape.py) when
    the native runtime is present, else through the block decoder K2;
  * a valid stream whose ops straddle the 64 KiB grid decodes through the
    windowed decoder K4 (kernels/decode_vm2.py), in batches of
    _WINDOWED_BATCH chunks with the 64 KiB tail carried between calls;
  * a stream no window can hold (a single op wider than 64 KiB, a copy
    reaching past the window, or a corrupt one) goes to the sequential
    host decoder, native or model, which decodes or rejects it.

There is no power-of-two batch bucketing (it bounded jit recompiles only);
a device call takes at most 128 blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cpu
from .format import constants as C
from .format.varint import encode_varint
from .kernels.decode_tape import decode_blocks_tape
from .kernels.decode_vm import decode_blocks_vm as decode_blocks
from .kernels.decode_vm2 import decode_stream_vm
from .kernels.encode_v2 import encode_blocks_v2
from .model.decode import CorruptError, decode_ops
from .stream import framing

DEVICE_BATCH = 128    # blocks per device call (8 MiB input; the encoder's peak memory is per call)
_WINDOWED_BATCH = 64  # chunks per decode_stream_vm call (~4.6 MB comp)

host_fallbacks = 0  # unsplittable streams the windowed decoder refused, decoded on the host


class CapacityError(RuntimeError, ValueError):
    """The encoder poisoned a block's total (-1): its emission-capacity guard
    fired.  Unreachable for legal geometry, but never emit a truncated
    stream.  The JAX package raises RuntimeError from its api and ValueError
    from its mesh; this is both."""


def encode_blocks(blocks, lens, profile="dense"):
    return encode_blocks_v2(blocks, lens, dense=(profile != "fast"))


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def launch_batches(fn, arrays, device, first: int = 0) -> list:
    """Copy host block-major `arrays` to `device`, then launch fn on each run
    of at most DEVICE_BATCH blocks without waiting for it -> [(first +
    offset, fn's outputs)].  Every input is copied before the first launch:
    a copy from pageable memory waits for its card's queue."""
    staged = [(s, [torch.from_numpy(a[s : s + DEVICE_BATCH]).to(device) for a in arrays])
              for s in range(0, arrays[0].shape[0], DEVICE_BATCH)]
    return [(first + s, fn(*args)) for s, args in staged]


def fetch_batches(calls, bufs: list) -> list:
    """Copy the outputs of launch_batches' calls into the host arrays `bufs`
    at their offsets; returns bufs."""
    for start, outs in calls:
        for buf, out in zip(bufs, outs):
            buf[start : start + out.shape[0]] = out.cpu().numpy()
    return bufs


def check_totals(totals: np.ndarray, first: int = 0) -> None:
    """CapacityError naming every block (first + index) with a negative total."""
    if (totals < 0).any():
        bad = first + np.nonzero(totals < 0)[0]
        raise CapacityError(
            f"encoder capacity overflow: block(s) {bad.tolist()} exceeded the emission capacity bound; "
            f"incompressible data this adversarial must be stored raw"
        )


def encode_rows(blocks: np.ndarray, lens: np.ndarray, profile: str = "dense", *, device, first: int = 0):
    """Encode (B, BS) host blocks on `device` in calls of at most DEVICE_BATCH
    blocks -> host ((B, PAD_OUT) uint8, (B,) int32).  CapacityError on a
    poisoned block, named as first + its index."""
    B = blocks.shape[0]
    comp, totals = fetch_batches(
        launch_batches(lambda b, n: encode_blocks(b, n, profile), (blocks, lens), device),
        [np.empty((B, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8), np.empty(B, np.int32)],
    )
    check_totals(totals, first)
    return comp, totals


def encode_array_pieces(arr: np.ndarray, profile: str, *, device):
    """Encode a byte array on `device`, yielding compacted wire pieces (no
    preamble) one device batch at a time."""
    blocks, lens = framing.pack_blocks(arr)
    for start in range(0, blocks.shape[0], DEVICE_BATCH):
        stop = start + DEVICE_BATCH
        comp, totals = encode_rows(blocks[start:stop], lens[start:stop], profile, device=device, first=start)
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


def _decompress_windowed(split, *, device) -> bytes:
    """Decode a valid stream that is not block-splittable: its chunks, cut at
    op boundaries, run through the windowed decoder K4 in bounded batches,
    each call seeded with the 64 KiB tail of the output so far (ctx0).
    CorruptError if a chunk is malformed."""
    chunks, out_lens, ctx_lens = split
    pieces = []
    tail = b""  # last <= 64 KiB of decoded output so far
    for k0 in range(0, len(chunks), _WINDOWED_BATCH):
        k1 = min(k0 + _WINDOWED_BATCH, len(chunks))
        padded, comp_lens = framing.pad_chunks(chunks[k0:k1])
        ctx0 = np.zeros(C.MAX_BLOCK_SIZE, np.uint8)
        if tail:
            ctx0[C.MAX_BLOCK_SIZE - len(tail):] = np.frombuffer(tail, np.uint8)
        out, ok = decode_stream_vm(
            torch.from_numpy(padded).to(device),
            torch.from_numpy(comp_lens).to(device),
            torch.tensor(out_lens[k0:k1], dtype=torch.int32, device=device),
            torch.from_numpy(np.asarray(ctx_lens[k0:k1], np.int32)).to(device),
            torch.from_numpy(ctx0).to(device),
        )
        out, ok = out.cpu().numpy(), ok.cpu().numpy()
        if not ok.all():
            raise CorruptError(f"malformed chunk(s) {(k0 + np.nonzero(~ok)[0]).tolist()} (windowed)")
        batch = b"".join(out[i, : out_lens[k0 + i]].tobytes() for i in range(k1 - k0))
        pieces.append(batch)
        tail = (tail + batch)[-C.MAX_BLOCK_SIZE:]
    return b"".join(pieces)


def _unsplittable(arr: np.ndarray, ops: np.ndarray, out_len: int, device) -> bytes:
    """A stream whose ops straddle 64 KiB output blocks."""
    global host_fallbacks
    try:
        return _decompress_windowed(framing.split_ops_windowed(ops, out_len), device=device)
    except CorruptError:
        # giant-op stream, or one no window can prove valid: the sequential
        # host decoder decodes the valid ones and raises on the corrupt ones
        host_fallbacks += 1
        if cpu.available:
            return cpu.decompress(arr)
        return decode_ops(ops, out_len).tobytes()


def decompress(data: bytes | np.ndarray, *, device) -> bytes:
    """Decode a raw Snappy stream on `device` by the routes in the module
    docstring; CorruptError (or the native decoder's NativeError) if the
    stream is malformed."""
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
            return _unsplittable(arr, ops, out_len, device)
    else:
        try:
            chunks, out_lens = framing.split_ops_stream(ops, out_len)
        except CorruptError:
            return _unsplittable(arr, ops, out_len, device)
        padded, comp_lens = framing.pad_chunks(chunks)
    out_lens = np.asarray(out_lens, np.int32)
    pieces = []
    for start in range(0, padded.shape[0], DEVICE_BATCH):
        rows, cl, ol = (a[start : start + DEVICE_BATCH] for a in (padded, comp_lens, out_lens))
        if cpu.available:  # host-built tapes, the device only moves bytes
            out, ok = decode_blocks_tape(rows, cl, ol, device=device)
        else:
            out, ok = decode_blocks(*(torch.from_numpy(a).to(device) for a in (rows, cl, ol)))
        out, ok = out.cpu().numpy(), ok.cpu().numpy()
        if not ok.all():
            raise CorruptError(f"malformed block(s) {(start + np.nonzero(~ok)[0]).tolist()}")
        if cpu.available:
            pieces.append(cpu.compact(out, ol))
        else:
            pieces.extend(out[i, : ol[i]].tobytes() for i in range(out.shape[0]))
    return b"".join(pieces)
