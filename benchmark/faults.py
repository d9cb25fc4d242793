"""The control and the faults the check must catch, planted in the program.

Each is a context manager that patches `snappytpu_torch.api` for one op and
restores it on exit.  They exist for `benchmark/control.py` and the tests;
the benchmark's own runs plant nothing.

  control    the program with its one guarantee broken in the smallest way
             the check has to see: the round trip loses the object's last
             byte (compress encodes all but it, into a valid stream;
             decompress drops it from its output);
  flip       one byte of the answer altered where it is produced (a byte of
             the first block's compressed row, or of its decoded row);
  half       half of each device batch left out (its blocks' compressed
             lengths set to 0, or its decoded rows zeroed);
  unchanged  a step that returns its input unchanged (the raw blocks as the
             compressed rows, or the compressed rows as the output).

A fault of the exchange between chips does not apply: every cell runs on one
chip.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

NAMES = ("control", "flip", "half", "unchanged")


def _encode_fault(name, encode_rows):
    def patched(blocks, lens, profile="dense", *, device, first=0):
        comp, totals = encode_rows(blocks, lens, profile, device=device, first=first)
        comp, totals = comp.copy(), totals.copy()
        if name == "flip":
            comp[0, totals[0] // 2] ^= 0x5A
        elif name == "half":
            totals[totals.size // 2 :] = 0
        elif name == "unchanged":
            comp[:] = 0
            comp[:, : blocks.shape[1]] = blocks
            totals = lens.astype(np.int32)
        return comp, totals
    return patched


def _decode_fault(name, decode):
    def patched(*args, **kwargs):
        out, ok = decode(*args, **kwargs)
        out = out.clone()
        if name == "flip":
            out[0, 0] ^= 0x5A
        elif name == "half":
            out[out.shape[0] // 2 :] = 0
        elif name == "unchanged":
            rows = args[0] if isinstance(args[0], torch.Tensor) else torch.from_numpy(np.asarray(args[0]))
            out = torch.zeros_like(out)
            width = min(out.shape[1], rows.shape[1])
            out[:, :width] = rows[:, :width].to(out.device)
        return out, ok
    return patched


@contextlib.contextmanager
def planted(name: str, op: str):
    """Plant `name` (one of NAMES) in the program's `op` path."""
    from snappytpu_torch import api

    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    saved = {k: getattr(api, k) for k in ("compress", "decompress", "encode_rows", "decode_blocks_tape", "decode_blocks")}
    compress, decompress = saved["compress"], saved["decompress"]
    if name == "control" and op == "compress":
        api.compress = lambda data, profile="dense", *, device: compress(np.asarray(data)[:-1], profile, device=device)
    elif name == "control":
        api.decompress = lambda data, *, device: decompress(data, device=device)[:-1]
    elif op == "compress":
        api.encode_rows = _encode_fault(name, saved["encode_rows"])
    else:
        api.decode_blocks_tape = _decode_fault(name, saved["decode_blocks_tape"])
        api.decode_blocks = _decode_fault(name, saved["decode_blocks"])
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(api, k, v)
