"""High-level codec API on the port: compress/decompress raw Snappy streams
with host framing, on an explicit torch device.

The counterpart of snappytpu.api, producing byte-identical streams and
taking the same decode routes:

  * a block-splittable stream decodes as independent blocks, split into
    rows on the host (by the native runtime where present, else in Python).
    On a CUDA device the block decoder K2 parses and moves the rows on the
    card (kernels/decode_vm4.py), where the JAX package builds host tapes
    for its tape decoder: the output, the ok flags and the accept set are
    the same (PERF.md §6 times both routes by call size).  On another
    device, with the native runtime, the tape decoder K5 runs host-built
    movement tapes (kernels/decode_tape.py), the JAX package's route;
    without it, K2;
  * a valid stream whose ops straddle the 64 KiB grid decodes through the
    windowed decoder K4 (kernels/decode_vm2.py), in batches of
    _WINDOWED_BATCH chunks with the 64 KiB tail carried between calls;
    so does a splittable stream in which the block route flags a block
    not ok: raw Snappy lets a copy reach back across the grid, which no
    block alone can decode, so the whole stream is decoded again here
    (the JAX package rejects such a stream);
  * a stream no window can hold (a single op wider than 64 KiB, a copy
    reaching past the window, or a corrupt one) goes to the sequential
    host decoder, native or model, which decodes it or raises CorruptError.

The host arrays of both routes are the calling thread's reused buffers
(hostbuf.py), pinned where they cross to a CUDA device, so a call's time
does not follow the allocator's: compress's staged blocks and lengths, its
compressed rows and totals; the block route's rows, tapes, decoded rows and
stream.
The file codec (stream/filecodec.py) takes the same route window by
window: split_blocks, then decode_rows into a window-sized buffer.

There is no power-of-two batch bucketing (it bounded jit recompiles only);
a device call takes at most 128 blocks.  On a CUDA device the encoder's call
replays one CUDA graph per (device, blocks in the call, profile) from the
third call of that shape on (kernels/encode_v2.py): a stream of full
batches and its tail needs two graphs a profile, and objects of many sizes
one a tail size, each captured once.

Each step of a call runs in a `profiling.span` named `snappy.<step>`
(recorded only under a torch profiler).  compress: `snappy.compress` holds
`pack`, then per device call `h2d`, `encode`, `d2h`, `rows`, `compact`,
then `join`, which tile it.  decompress: `snappy.decompress` holds `scan`,
`split`, per device call `tape` (K5's route only), `h2d`, `decode`, `d2h`,
`compact`, then `join` (without the native runtime two `split`s and no
`scan`); or `windowed` (K4, with its own `split`, `h2d`, `decode`, `d2h`),
or `host_decode`.  Counters: `compress.d2h_bytes` and
`compress.stream_bytes` (the encoder's output copied to the host, and the
stream in it); `decompress.device_calls` and `decompress.blocks` (per
block-route device call, and its blocks), `decompress.k2_calls` (the
block-route calls K2 parsed), `decompress.reroutes` (streams the block
route handed to the windowed route), `decompress.windowed_calls` (K4
calls) and `decompress.host_fallbacks`; and the encoder's
`encode.graph_replays`, `encode.graph_captures`, `encode.eager_calls` and
`encode.graph_fallbacks` (one of the first three per device call),
`encode.graph_waits` (a device call that waited for another thread's, span
`snappy.graph_wait` inside `encode`), and `concat.graph_runs` and
`tier_b.graph_runs`, K1's and K7's runs inside the replays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cpu, hostbuf, profiling
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


def check_totals(totals: np.ndarray, first: int = 0) -> None:
    """CapacityError naming every block (first + index) with a negative total."""
    if (totals < 0).any():
        bad = first + np.nonzero(totals < 0)[0]
        raise CapacityError(
            f"encoder capacity overflow: block(s) {bad.tolist()} exceeded the emission capacity bound; "
            f"incompressible data this adversarial must be stored raw"
        )


def _to_device(name: str, a: np.ndarray, device) -> torch.Tensor:
    """The host array `a` on `device`.  For a CUDA device it is first copied
    into this thread's kept pinned buffer `name`, so that the copy to the
    card is the copy engine's alone and does not wait for the card's queue."""
    if not hostbuf.pinned_for(device):
        return torch.from_numpy(a).to(device)
    staged = hostbuf.take(name, a.shape, torch.from_numpy(a[:0]).dtype, pinned=True)
    staged.numpy()[...] = a
    return staged.to(device, non_blocking=True)


def encode_rows(blocks: np.ndarray, lens: np.ndarray, profile: str = "dense", *, device, first: int = 0):
    """Encode (B, BS) host blocks on `device` in calls of at most DEVICE_BATCH
    blocks -> host ((B, PAD_OUT) uint8, (B,) int32).  CapacityError on a
    poisoned block, named as first + its index.

    The answer lies in this thread's kept buffers (hostbuf.py), pinned for a
    CUDA device, as do the staged inputs: the caller is done with it before
    the thread's next call here, or copies it out.  On a CUDA device the
    call waits on an event behind its own copies back: a blocking copy would
    wait for the whole stream, so callers on other threads, whose replays
    queue behind each other on it, would all wake only when it drained."""
    B = blocks.shape[0]
    pinned = hostbuf.pinned_for(device)
    # every input is copied before the first launch
    with profiling.span("snappy.h2d"):
        blocks_d, lens_d = (_to_device(name, np.ascontiguousarray(a), device)
                            for name, a in (("api.enc_blocks", blocks), ("api.enc_lens", lens)))
        staged = [(s, blocks_d[s : s + DEVICE_BATCH], lens_d[s : s + DEVICE_BATCH]) for s in range(0, B, DEVICE_BATCH)]
    with profiling.span("snappy.encode"):
        calls = [(s, encode_blocks(b, n, profile)) for s, b, n in staged]
    comp = hostbuf.take("api.comp", (B, C.MAX_COMPRESSED_BLOCK_SIZE), torch.uint8, pinned=pinned)
    totals = hostbuf.take("api.totals", (B,), torch.int32, pinned=pinned)
    with profiling.span("snappy.d2h"):
        for s, (c, t) in calls:
            comp[s : s + c.shape[0]].copy_(c, non_blocking=pinned)
            totals[s : s + t.shape[0]].copy_(t, non_blocking=pinned)
        if pinned:  # wait for this call's copies, not for what other threads queued on the stream since
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(device))
            landed.synchronize()
    comp, totals = comp.numpy(), totals.numpy()
    with profiling.span("snappy.rows"):
        check_totals(totals, first)
        profiling.count("compress.d2h_bytes", sum(c.nbytes + t.nbytes for _, (c, t) in calls))
        profiling.count("compress.stream_bytes", int(totals.sum(dtype=np.int64)))
    return comp, totals


def encode_array_pieces(arr: np.ndarray, profile: str, *, device):
    """Encode a byte array on `device`, yielding compacted wire pieces (no
    preamble) one device batch at a time."""
    with profiling.span("snappy.pack"):
        blocks, lens = framing.pack_blocks(arr)
    yield from _encode_packed(blocks, lens, profile, device)


def _encode_packed(blocks: np.ndarray, lens: np.ndarray, profile: str, device):
    """encode_array_pieces after pack_blocks.  No span is open at a yield."""
    for start in range(0, blocks.shape[0], DEVICE_BATCH):
        stop = start + DEVICE_BATCH
        comp, totals = encode_rows(blocks[start:stop], lens[start:stop], profile, device=device, first=start)
        with profiling.span("snappy.compact"):
            if cpu.available:
                pieces = [cpu.compact(comp, totals)]
            else:
                pieces = [comp[i, : totals[i]].tobytes() for i in range(comp.shape[0])]
        yield from pieces


def compress(data: bytes | np.ndarray, profile: str = "dense", *, device) -> bytes:
    """Encode a byte string into a raw Snappy stream on `device`.

    profile: "dense" (default) or "fast", as in snappytpu.api.compress."""
    with profiling.span("snappy.compress"):
        with profiling.span("snappy.pack"):
            arr = _as_u8(data)
            packed = framing.pack_blocks(arr) if arr.size else None
        if packed is None:
            return encode_varint(0)
        pieces = [encode_varint(arr.size), *_encode_packed(*packed, profile, device)]
        with profiling.span("snappy.join"):
            return b"".join(pieces)


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
        with profiling.span("snappy.split"):
            padded, comp_lens = framing.pad_chunks(chunks[k0:k1])
            ctx0 = np.zeros(C.MAX_BLOCK_SIZE, np.uint8)
            if tail:
                ctx0[C.MAX_BLOCK_SIZE - len(tail):] = np.frombuffer(tail, np.uint8)
        with profiling.span("snappy.h2d"):
            args = (
                torch.from_numpy(padded).to(device),
                torch.from_numpy(comp_lens).to(device),
                torch.tensor(out_lens[k0:k1], dtype=torch.int32, device=device),
                torch.from_numpy(np.asarray(ctx_lens[k0:k1], np.int32)).to(device),
                torch.from_numpy(ctx0).to(device),
            )
        with profiling.span("snappy.decode"):
            out, ok = decode_stream_vm(*args)
        profiling.count("decompress.windowed_calls")
        with profiling.span("snappy.d2h"):
            out, ok = out.cpu().numpy(), ok.cpu().numpy()
        if not ok.all():
            raise CorruptError(f"malformed chunk(s) {(k0 + np.nonzero(~ok)[0]).tolist()} (windowed)")
        with profiling.span("snappy.compact"):
            batch = b"".join(out[i, : out_lens[k0 + i]].tobytes() for i in range(k1 - k0))
            pieces.append(batch)
            tail = (tail + batch)[-C.MAX_BLOCK_SIZE:]
    with profiling.span("snappy.join"):
        return b"".join(pieces)


def _unsplittable(arr: np.ndarray, ops: np.ndarray, out_len: int, device) -> bytes:
    """A stream whose ops straddle 64 KiB output blocks."""
    try:
        with profiling.span("snappy.windowed"):
            with profiling.span("snappy.split"):
                split = framing.split_ops_windowed(ops, out_len)
            return _decompress_windowed(split, device=device)
    except CorruptError:
        # giant-op stream, or one no window can prove valid: the sequential
        # host decoder decodes the valid ones and raises on the corrupt ones
        profiling.count("decompress.host_fallbacks")
        with profiling.span("snappy.host_decode"):
            if not cpu.available:
                return decode_ops(ops, out_len).tobytes()
            try:
                return cpu.decompress(arr)
            except cpu.NativeError as e:
                raise CorruptError(str(e)) from e


def decompress(data: bytes | np.ndarray, *, device) -> bytes:
    """Decode a raw Snappy stream on `device` by the routes in the module
    docstring; CorruptError if the stream is malformed."""
    with profiling.span("snappy.decompress"):
        return _decompress(data, device)


def _decompress(data, device) -> bytes:
    arr = _as_u8(data)
    out_len, ops_start = framing.read_preamble(arr)
    if out_len == 0:
        if arr.size != ops_start:
            raise CorruptError("trailing garbage after empty stream")
        return b""
    ops = arr[ops_start:]
    if not cpu.available:
        return _decompress_k2(arr, ops, out_len, device)
    try:
        with profiling.span("snappy.scan"):
            offs, out_lens = cpu.scan_ops(ops, out_len)
    except cpu.NativeError:
        return _unsplittable(arr, ops, out_len, device)
    try:
        padded, comp_lens = split_blocks(ops, offs, device=device)
    except cpu.NativeError:  # a row wider than a padded one: a valid stream of tiny ops, or a corrupt one
        return _unsplittable(arr, ops, out_len, device)
    return _block_route(arr, ops, out_len, padded, comp_lens, out_lens.astype(np.int32), device)


def parses_on_card(device) -> bool:
    """Whether the block route hands a host stream's split rows to K2, which
    parses and moves them on the card, rather than building K5's tapes on
    the host: on a CUDA device.  K2's call took less time than the tape
    route's at every call size timed, 1 to 128 blocks (PERF.md §6)."""
    return torch.device(device).type == "cuda"


def _decode_k2(rows, comp_lens, out_lens, *, device):
    """K2 on host rows: the rows and lengths copied to `device`, where the
    card parses and moves each block."""
    with profiling.span("snappy.h2d"):
        args = [torch.from_numpy(a).to(device) for a in (rows, comp_lens, out_lens)]
    with profiling.span("snappy.decode"):
        out, ok = decode_blocks(*args)
    profiling.count("decompress.k2_calls")
    return out, ok


def _compact_into(rows: np.ndarray, lens: np.ndarray, out: np.ndarray) -> int:
    """Each row's first lens[i] bytes, in order, into the front of `out`;
    returns the bytes written."""
    if cpu.available:
        return cpu.compact_into(rows, lens, out)
    written = 0
    for row, n in zip(rows, lens.tolist()):
        out[written : written + n] = row[:n]
        written += n
    return written


def split_blocks(ops: np.ndarray, offs: np.ndarray, *, device):
    """`ops` split natively at the block offsets `offs` into this thread's kept
    rows: (rows, comp_lens).  NativeError on a block wider than a row."""
    with profiling.span("snappy.split"):
        return cpu.split_rows(ops, offs, C.MAX_COMPRESSED_BLOCK_SIZE, out=(
            hostbuf.take("api.rows", (offs.size, C.MAX_COMPRESSED_BLOCK_SIZE), torch.uint8,
                         pinned=hostbuf.pinned_for(device)).numpy(),
            hostbuf.take("api.row_lens", (offs.size,), torch.int32).numpy()))


def decode_rows(padded, comp_lens, out_lens, out: np.ndarray, *, device) -> int | None:
    """The block route, compacted into the front of `out`: calls of at most
    DEVICE_BATCH blocks, through K2 where parses_on_card(device) or without
    the native runtime (K5's tapes need it), else K5; the bytes written, or
    None at the first call with a block not ok (a copy reaching back across
    the 64 KiB grid, or a malformed block)."""
    decode = _decode_k2 if parses_on_card(device) or not cpu.available else decode_blocks_tape
    written = 0
    for start in range(0, padded.shape[0], DEVICE_BATCH):
        rows, cl, ol = (a[start : start + DEVICE_BATCH] for a in (padded, comp_lens, out_lens))
        out_d, ok = decode(rows, cl, ol, device=device)  # its own `h2d` and `decode` spans
        profiling.count("decompress.device_calls")
        profiling.count("decompress.blocks", rows.shape[0])
        with profiling.span("snappy.d2h"):
            host = hostbuf.take("api.d2h", tuple(out_d.shape), torch.uint8, pinned=hostbuf.pinned_for(device))
            host.copy_(out_d)
            ok = ok.cpu().numpy()
        if not ok.all():
            return None
        with profiling.span("snappy.compact"):
            written += _compact_into(host.numpy(), ol, out[written:])
    return written


def _block_route(arr, ops, out_len, padded, comp_lens, out_lens, device) -> bytes:
    """decode_rows into a kept buffer; a block not ok reroutes the stream."""
    decoded = hostbuf.take("api.decoded", (out_len,), torch.uint8).numpy()
    written = decode_rows(padded, comp_lens, out_lens, decoded, device=device)
    if written is None:
        profiling.count("decompress.reroutes")
        return _unsplittable(arr, ops, out_len, device)
    with profiling.span("snappy.join"):
        return decoded[:written].tobytes()


def _decompress_k2(arr: np.ndarray, ops: np.ndarray, out_len: int, device) -> bytes:
    """The block route without the native runtime: the split in Python, then
    K2 parses each block."""
    try:
        with profiling.span("snappy.split"):
            chunks, out_lens = framing.split_ops_stream(ops, out_len)
    except CorruptError:
        return _unsplittable(arr, ops, out_len, device)
    with profiling.span("snappy.split"):
        padded, comp_lens = framing.pad_chunks(chunks)
    return _block_route(arr, ops, out_len, padded, comp_lens, np.asarray(out_lens, np.int32), device)
