"""Per-shard output manifests for multi-host encode sweeps — the port's
counterpart of snappytpu.stream.manifest.

SURVEY.md §5.3/§5.4: the reference has no failure handling or checkpointing
(jobs are sub-second); at pod scale the natural unit of recovery is the
64 KiB block.  A multi-host encode writes one shard file + JSON manifest per
host; a failed/restarted host finds its completed manifest and skips the
work (idempotent reruns), and final assembly concatenates shards in block
order once every manifest is present — no host ever holds the whole stream.

The default encoder is api.encode_rows (dense, the bytes of api.compress)
on an explicit torch device; the files are the JAX module's, byte for
byte.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os

import numpy as np

from .. import api
from ..format import constants as C
from ..format.varint import encode_varint


def _manifest_path(out_dir: str, shard_id: int) -> str:
    return os.path.join(out_dir, f"shard_{shard_id:05d}.json")


def _shard_path(out_dir: str, shard_id: int) -> str:
    return os.path.join(out_dir, f"shard_{shard_id:05d}.snappy_part")


def shard_block_range(total_bytes: int, shard_id: int, n_shards: int,
                      block_size: int = C.MAX_BLOCK_SIZE):
    """Contiguous block range [first, last) owned by a shard."""
    n_blocks = max((total_bytes + block_size - 1) // block_size, 1)
    per = (n_blocks + n_shards - 1) // n_shards
    first = min(shard_id * per, n_blocks)
    return first, min(first + per, n_blocks)


def encode_shard(data: np.ndarray, out_dir: str, shard_id: int, n_shards: int,
                 encode_fn=None, block_size: int = C.MAX_BLOCK_SIZE, *, device="cuda") -> dict:
    """Encode this shard's block range to a part file + manifest, with
    encode_fn(blocks, lens) or, by default, api.encode_rows on `device`.

    Idempotent: if a complete manifest matching the input digest exists, the
    shard is skipped (restart-after-failure costs nothing but a hash)."""
    os.makedirs(out_dir, exist_ok=True)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    first, last = shard_block_range(data.size, shard_id, n_shards, block_size)
    span = data[first * block_size : min(last * block_size, data.size)]
    digest = hashlib.sha256(span.tobytes()).hexdigest()

    mpath = _manifest_path(out_dir, shard_id)
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        if m.get("complete") and m.get("input_sha256") == digest:
            return m  # already done — idempotent restart

    if encode_fn is None:
        encode_fn = functools.partial(api.encode_rows, device=device)

    from . import framing

    if span.size:
        blocks, lens = framing.pack_blocks(span, block_size)
        comp, totals = encode_fn(blocks, lens)
    else:
        blocks = np.zeros((0, block_size), np.uint8)
        lens = np.zeros(0, np.int32)
        comp = np.zeros((0, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
        totals = np.zeros(0, np.int32)

    part = _shard_path(out_dir, shard_id)
    block_lens = []
    with open(part + ".tmp", "wb") as f:
        for i in range(comp.shape[0]):
            f.write(comp[i, : int(totals[i])].tobytes())
            block_lens.append(int(totals[i]))
    os.replace(part + ".tmp", part)

    manifest = {
        "shard_id": shard_id,
        "n_shards": n_shards,
        "first_block": first,
        "last_block": last,
        "block_size": block_size,
        "uncompressed_bytes": int(span.size),
        "compressed_bytes": int(sum(block_lens)),
        "block_comp_lens": block_lens,
        "input_sha256": digest,
        "complete": True,
    }
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    return manifest


def missing_shards(out_dir: str, n_shards: int) -> list[int]:
    """Shards without a complete manifest — the failure-detection signal."""
    missing = []
    for s in range(n_shards):
        p = _manifest_path(out_dir, s)
        if not os.path.exists(p):
            missing.append(s)
            continue
        try:
            with open(p) as f:
                if not json.load(f).get("complete"):
                    missing.append(s)
        except (json.JSONDecodeError, OSError):
            missing.append(s)
    return missing


def assemble(out_dir: str, n_shards: int, output_path: str) -> int:
    """Concatenate shard parts in block order into a full raw stream."""
    bad = missing_shards(out_dir, n_shards)
    if bad:
        raise RuntimeError(f"shards incomplete: {bad}")
    manifests = []
    for s in range(n_shards):
        with open(_manifest_path(out_dir, s)) as f:
            manifests.append(json.load(f))
    total_unc = sum(m["uncompressed_bytes"] for m in manifests)
    with open(output_path + ".tmp", "wb") as out:
        out.write(encode_varint(total_unc))
        for m in manifests:
            with open(_shard_path(out_dir, m["shard_id"]), "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    out.write(chunk)
    os.replace(output_path + ".tmp", output_path)
    return total_unc
