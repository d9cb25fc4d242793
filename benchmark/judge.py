"""The check that decides `correct`, run once the window has closed.

The reference rebuilds the configuration's objects from the seed and cuts
them into the traffic's units itself, and judges the answers the window
kept:

  compress    each stream returned is decoded by the plain reference
              decoder; it must be valid raw Snappy and give the unit's bytes;
  decompress  each output returned must be the unit's bytes; the streams the
              set-up handed to the program are decoded by the reference too,
              and must give the unit's bytes, so that the input was sound.

The harness hands over each distinct answer of a unit once, with the number
of times it came; each counts that many times, so that every answer of the
window is judged while the reference decodes each distinct stream once.
Every number compared is exact, so every limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import datagen, reference, traffic

LIMITS = {"failed": 0, "rejected": 0, "wrong_bytes": 0, "bad_inputs": 0}


def wrong_bytes(got: torch.Tensor, want: torch.Tensor) -> int:
    """Bytes that differ between two byte strings, a difference in length counting each missing byte."""
    m = min(got.numel(), want.numel())
    return int((got[:m] != want[:m]).sum()) + abs(got.numel() - want.numel())


def _tensor(data, device) -> torch.Tensor:
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    return torch.from_numpy(arr.copy()).to(device)


def _decoded_wrong(stream: bytes, want: torch.Tensor, device) -> tuple[int, int]:
    """(1 if the reference rejects the stream else 0, wrong bytes of its decode)."""
    try:
        got = reference.decode(stream, device)
    except reference.Rejected:
        return 1, want.numel()
    return 0, wrong_bytes(got, want)


def judge(cell, seed: int, answers, inputs: list | None, failed: int, device) -> dict:
    """{number: (value, limit)} for the window's answers, given as
    (unit index, bytes, count) for each distinct answer of a unit."""
    objects = datagen.make_objects(cell.config, seed, device)
    units = traffic.units(cell.traffic, objects)
    checks = {"failed": failed}
    if cell.traffic["op"] == "compress":
        rejected = wrong = 0
        for i, stream, count in answers:
            r, w = _decoded_wrong(stream, _tensor(units[i], device), device)
            rejected += r * count
            wrong += w * count
        checks |= {"rejected": rejected, "wrong_bytes": wrong}
    else:
        bad = 0
        for i in sorted({i for i, _, _ in answers}):
            r, w = _decoded_wrong(inputs[i], _tensor(units[i], device), device)
            bad += r + (w > 0)
        wrong = sum(wrong_bytes(_tensor(out, device), _tensor(units[i], device)) * count for i, out, count in answers)
        checks |= {"wrong_bytes": wrong, "bad_inputs": bad}
    return {k: (v, LIMITS[k]) for k, v in checks.items()}


def correct(checks: dict, judged: int) -> bool:
    return judged > 0 and all(v <= limit for v, limit in checks.values())
