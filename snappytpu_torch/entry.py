"""Entry points of the port: the hot path with example arguments, and a
multi-device dry run — the counterparts of __graft_entry__.py.  Both run
on the card unless the caller names another device."""

from __future__ import annotations

import numpy as np
import torch

from .bench import corpus
from .format import constants as C


def entry(device="cuda"):
    """(fn, example_args): the flagship pipeline's forward step — a batched
    block encode (the codec's hot path) — with two 64 KiB blocks of the
    mixed corpus on `device`."""
    from .kernels.encode_v2 import encode_blocks_v2

    data = np.frombuffer(corpus.mixed(2 * C.MAX_BLOCK_SIZE, seed=0), np.uint8)
    blocks = data.reshape(2, C.MAX_BLOCK_SIZE)
    lens = np.full(2, C.MAX_BLOCK_SIZE, dtype=np.int32)
    return encode_blocks_v2, (torch.from_numpy(blocks.copy()).to(device), torch.from_numpy(lens).to(device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Full codec step (encode + decode round trip) over an n_devices-wide
    block-data-parallel mesh; one step on n_devices blocks."""
    from .mesh import decode_mesh, encode_mesh, make_mesh
    from .stream import framing

    mesh = make_mesh(n_devices, device)
    n = len(mesh)
    data = np.frombuffer(corpus.mixed(n * C.MAX_BLOCK_SIZE, seed=1), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = encode_mesh(mesh, blocks, lens)
    padded, comp_lens = framing.pad_chunks(
        [comp[i, : totals[i]] for i in range(comp.shape[0])]
    )
    out, ok = decode_mesh(mesh, padded, comp_lens, lens)
    if not ok.all():
        raise RuntimeError("multichip decode flagged corrupt blocks")
    rec = b"".join(out[i, : lens[i]].tobytes() for i in range(out.shape[0]))
    if rec != data.tobytes():
        raise RuntimeError("multichip round trip mismatch")
    print(
        f"dryrun_multichip ok: {n} devices ({', '.join(map(str, mesh))}), "
        f"{data.size} bytes -> {int(totals.sum())} compressed"
    )

