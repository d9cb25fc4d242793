"""Staged inputs for the profiling tools — the harness of the JAX package's
tools/dec_profile.py:43-104, shared by dec_profile, dec_anatomy and
tape_probe, and the encoder tools' batches (`encoder_sets`).

A staged set is one batch of B blocks of a corpus (seed 300 + q for set q),
encoded with the dense profile by the port's encoder on the given device, as
(comp, totals, lens); in tape form it is (tapes, nrecs, comp), with tapes
from the native builder.  The compressed batches are cached as
`decprof_<tag>_<corpus>_<q>_<B>.npz` (keys comp, totals, lens) in the
temporary directory, where the tag hashes the port's encoder source, so a
cached batch never outlives a change of the encoder.  `load_staged` reads
such a file, the JAX tools' included, into the port's tensors.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np
import torch

from ..bench import corpus
from ..format import constants as C
from ..stream import framing

from ..kernels import decode_tape
from ..kernels import encode_v2 as E

MAKERS = {
    "mixed": corpus.mixed,
    "text": corpus.text,
    "runs": corpus.low_entropy,
    "random": corpus.random_bytes,
}


def cache_tag() -> str:
    with open(E.__file__, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12] + "-dense"


def device_of(name: str) -> torch.device:
    """The device a tool runs on; asking for CUDA without it raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is false")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for device {dev}")
    return dev


def load_staged(path, device="cpu"):
    """A cached batch (.npz with comp, totals, lens) -> (comp (B, 73728)
    uint8, totals (B,) int32, lens (B,) int32) tensors on `device`."""
    with np.load(path) as z:
        comp, totals, lens = z["comp"], z["totals"], z["lens"]
    return (torch.from_numpy(np.ascontiguousarray(comp, np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(totals, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(device))


def encoded_batch(which: str, q: int, B: int, device, cache_dir: str | None = None):
    """Set q of corpus `which`: B blocks encoded dense on `device`, through
    the cache -> (comp, totals, lens) host numpy arrays."""
    path = os.path.join(cache_dir or tempfile.gettempdir(), f"decprof_{cache_tag()}_{which}_{q}_{B}.npz")
    if os.path.exists(path):
        comp, totals, lens = (t.numpy() for t in load_staged(path))
        return comp, totals, lens
    data = np.frombuffer(MAKERS[which](B * C.MAX_BLOCK_SIZE, seed=300 + q), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = E.encode_blocks_v2(torch.from_numpy(blocks[:B]).to(device),
                                      torch.from_numpy(np.asarray(lens[:B], np.int32)).to(device), True)
    comp, totals = comp.cpu().numpy(), totals.cpu().numpy()
    lens = np.asarray(lens[:B], np.int32)
    if (totals < 0).any():
        raise RuntimeError(f"{which} set {q}: the encoder poisoned blocks {np.nonzero(totals < 0)[0].tolist()}")
    np.savez_compressed(path, comp=comp, totals=totals, lens=lens)
    return comp, totals, lens


def stage_sets(which: str, B: int, NQ: int, device, tape: bool = False, cache_dir: str | None = None):
    """NQ staged sets of corpus `which` on `device`: (comp, totals, lens)
    each, or (tapes, nrecs, comp) with tape=True (tapes cut to the longest
    tape's records, decode_tape.stage)."""
    sets = []
    for q in range(NQ):
        comp, totals, lens = encoded_batch(which, q, B, device, cache_dir)
        if tape:
            tapes, nrecs = decode_tape.build_tapes(comp, totals, lens)
            if (nrecs < 0).any():
                raise RuntimeError(f"{which} set {q}: tape overflow/malformed {nrecs.min()}")
            sets.append(decode_tape.stage(comp, tapes, nrecs, device=device))
        else:
            sets.append(tuple(torch.from_numpy(a).to(device) for a in (comp, totals, lens)))
    return sets


def encoder_sets(B: int, NQ: int, device):
    """The encoder tools' inputs (the JAX tools/stage_profile.py's): NQ
    batches of B full blocks of corpus.mixed(B * 64 KiB, seed=100 + q), as
    ((B, 65536) uint8 blocks, (B,) int32 lengths) on `device`."""
    sets = []
    for q in range(NQ):
        data = np.frombuffer(corpus.mixed(B * C.MAX_BLOCK_SIZE, seed=100 + q), np.uint8)
        blocks, lens = framing.pack_blocks(data)
        sets.append((torch.from_numpy(blocks[:B]).to(device),
                     torch.from_numpy(np.asarray(lens[:B], np.int32)).to(device)))
    return sets


def make_log():
    """A tool's log: each line stamped with the seconds since this call."""
    t0 = time.time()

    def log(m):
        print(f"[{time.time() - t0:6.1f}s] {m}", flush=True)

    return log


def _first_tensor(x):
    """The first tensor in x: a tensor, or nested lists and tuples of them."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def best_per_batch(fn, sets, reps: int = 3) -> float:
    """Seconds per batch of fn over the sets (each a tuple of arguments,
    tensors or lists and tuples of them), best of `reps` passes after one
    warm-up pass.  On the card, CUDA events around each pass's queued
    calls; on the CPU, the host clock."""
    for a in sets:
        fn(*a)
    cuda = _first_tensor(sets[0]).device.type == "cuda"
    best = float("inf")
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for a in sets:
                fn(*a)
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for a in sets:
                fn(*a)
            s = time.perf_counter() - t0
        best = min(best, s / len(sets))
    return best
