"""Host buffers that the API's routes reuse from call to call, one set a thread.

A call's host arrays (compress: the staged blocks and lengths, the
compressed rows and totals; decompress: the padded rows, the tapes, the
decoded rows, the decoded stream) take the same few sizes call after call.
Made afresh, each large one comes from mmap, or from a heap that may have
been trimmed since, and the call pays for its pages again: the allocator's
state then sets much of a call's time, and of its spread from process to
process.  So each thread keeps one grow-only buffer a name.  A buffer that
crosses to a CUDA device is pinned, so its copy is the copy engine's alone.
A request above KEEP_BYTES gets a fresh pageable buffer, so that one huge
stream neither holds its size for the thread's life nor pins it afresh each
call.

A buffer's contents are whatever its last user left, and a caller is done
with it when its call returns: every copy out of the card into it has
landed by then (a blocking copy, or compress's wait on an event behind its
copies), and each asynchronous copy into the card (compress's staged
inputs) is on the stream ahead of those of the same call.
"""

from __future__ import annotations

import math
import threading

import torch

KEEP_BYTES = 64 << 20

_local = threading.local()


def take(name: str, shape: tuple[int, ...], dtype: torch.dtype, *, pinned: bool = False) -> torch.Tensor:
    """A contiguous CPU tensor of `shape` and `dtype` over this thread's
    buffer `name`, pinned if `pinned` (and kept)."""
    nbytes = math.prod(shape) * dtype.itemsize
    if nbytes > KEEP_BYTES:
        return torch.empty(shape, dtype=dtype)
    bufs = _local.__dict__.setdefault("bufs", {})
    buf = bufs.get((name, pinned))
    if buf is None or buf.numel() < nbytes:
        buf = bufs[(name, pinned)] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=pinned)
    return buf[:nbytes].view(dtype).view(shape)


def pinned_for(device) -> bool:
    """Whether buffers bound for `device` are pinned: on a CUDA device."""
    return torch.device(device).type == "cuda"
