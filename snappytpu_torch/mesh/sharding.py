"""Mesh-parallel codec: block data parallelism over torch devices — the
counterpart of snappytpu.mesh.sharding.

The reference has no parallelism at all (single thread, SURVEY.md §2); its
64 KiB blocks share no state, which is exactly the property exploited here:
blocks are the data-parallel axis (AXIS).  PyTorch has no `shard_map` and
no `NamedSharding`, so the blocks are sharded by hand, with the JAX
module's contracts kept:

  * a mesh is an ordered list of shard devices (`make_mesh`);
  * a sharded array is a list with one tensor per mesh device, shard j on
    mesh[j], the shards in block order;
  * `sharded_encode(mesh, dense)` / `sharded_decode(mesh)` (cached per mesh
    and profile, as the JAX module's jitted shard_maps are) take and return
    such lists: each shard is encoded or decoded where it lies, in device
    calls of at most 128 blocks (the encoder's peak memory is per call),
    every shard's calls launched before anything waits, and poisoned
    totals left to the caller.  A shard may also lie in host memory, as a
    jitted JAX function takes host arrays: it is copied to its device just
    before its calls, so card j computes while shard j + 1 is copied.  An
    empty shard gives empty outputs;
  * `encode_mesh`/`decode_mesh` take host arrays: the batch is padded with
    zero-length blocks to a multiple of the global shard count (every
    process's shards), each shard takes one contiguous block range, handed
    to the sharded call in host memory, and the outputs come back as
    host arrays in block order, sliced back to the caller's batch; under a
    process group every rank passes the whole batch, encodes its own range
    on its local shards, and the padded rows come back to every rank in
    rank order by `all_gather` (the counterpart of `process_allgather`);
    every rank's mesh must be as wide, and a rank on CUDA holds only its
    own cards (torchrun's LOCAL_RANK of LOCAL_WORLD_SIZE).

The bytes do not depend on the number of processes or shards: they equal
one device's (tests/test_torch_mesh.py, tests/test_torch_distributed.py,
tests/test_torch_research.py).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..format import constants as C
from ..kernels.decode_vm import decode_blocks_vm as decode_blocks
from ..kernels.encode_v2 import encode_blocks_v2 as encode_blocks

AXIS = "blocks"


def _local_cards(have: int, local_rank: int, local_world: int) -> range:
    """The cards of one process when local_world processes share a host's
    `have` cards (torchrun's LOCAL_RANK, LOCAL_WORLD_SIZE): an equal
    contiguous share each, never a card of another process."""
    if not 0 <= local_rank < local_world:
        raise RuntimeError(f"LOCAL_RANK {local_rank} outside LOCAL_WORLD_SIZE {local_world}")
    per = have // local_world
    if per < 1:
        raise RuntimeError(f"torch sees {have} CUDA device(s) for {local_world} process(es) on this host")
    return range(local_rank * per, (local_rank + 1) * per)


def make_mesh(n_devices: int | None = None, device="cuda") -> list[torch.device]:
    """1-D mesh over the block axis: an ordered list of shard devices.

    On CUDA the shards are this process's cards (default: all of them), and
    asking for more raises.  A process has every card torch sees, or, when
    torchrun starts LOCAL_WORLD_SIZE processes on a host, its LOCAL_RANK's
    equal share.  On the CPU they are n slots (default 1) on the one CPU
    device, the counterpart of XLA's virtual host devices."""
    device = torch.device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count()
        cards = _local_cards(have, int(os.environ.get("LOCAL_RANK", 0)), int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        n = len(cards) if n_devices is None else n_devices
        if not 1 <= n <= len(cards):
            raise RuntimeError(f"a mesh of {n} CUDA devices asked for; this process has {len(cards)} "
                               f"of the {have} torch sees")
        return [torch.device("cuda", i) for i in cards[:n]]
    if device.type != "cpu":
        raise ValueError(f"no mesh on device type {device.type!r}")
    n = 1 if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return [torch.device("cpu")] * n


def _pad_batch(nblocks: int, n_shards: int) -> int:
    """Blocks per mesh call must divide evenly over the global shards."""
    return ((nblocks + n_shards - 1) // n_shards) * n_shards


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _group() -> tuple[int, int]:
    return (dist.get_rank(), dist.get_world_size()) if _grouped() else (0, 1)


_HOST = torch.device("cpu")
# the outputs' per-block shapes and dtypes, for an empty shard
_ENCODED = (((C.MAX_COMPRESSED_BLOCK_SIZE,), torch.uint8), ((), torch.int32))
_DECODED = (((C.MAX_BLOCK_SIZE,), torch.uint8), ((), torch.bool))


def _each_shard(mesh: tuple, fn, shards, out_specs) -> list:
    """fn over every shard on its own device, in calls of at most
    api.DEVICE_BATCH blocks, all launched before anything waits -> fn's
    outputs as sharded lists.  A shard in host memory is copied to its
    device just before its calls; an empty shard gives empty outputs of
    out_specs' shapes and dtypes without a call."""
    if any(len(s) != len(mesh) for s in shards):
        raise ValueError(f"a sharded array needs one tensor per mesh device ({len(mesh)})")
    per_shard = []
    for j, dev in enumerate(mesh):
        args = [s[j] for s in shards]
        if any(a.device not in (dev, _HOST) for a in args):
            raise ValueError(f"shard {j} is on {[str(a.device) for a in args]}, not on its mesh device {dev}")
        args = [a.to(dev) for a in args]
        B = args[0].shape[0]
        calls = [fn(*(a[i : i + api.DEVICE_BATCH] for a in args)) for i in range(0, B, api.DEVICE_BATCH)]
        per_shard.append(calls or [[torch.empty((0, *shape), dtype=dtype, device=dev) for shape, dtype in out_specs]])
    return [[torch.cat([out[k] for out in calls]) for calls in per_shard] for k in range(len(out_specs))]


@functools.lru_cache(maxsize=8)
def _sharded_encode(mesh: tuple, dense: bool):
    def run(blocks: list, lens: list):
        return _each_shard(mesh, lambda b, n: encode_blocks(b, n, dense=dense), (blocks, lens), _ENCODED)

    return run


@functools.lru_cache(maxsize=8)
def _sharded_decode(mesh: tuple):
    def run(comp: list, comp_lens: list, out_lens: list):
        return _each_shard(mesh, decode_blocks, (comp, comp_lens, out_lens), _DECODED)

    return run


def sharded_encode(mesh, dense: bool = True):
    """The batched encoder over the mesh: (blocks, lens) sharded lists, shard
    j a (b_j, BS) uint8 and (b_j,) int32 tensor on mesh[j] -> (comp, totals)
    sharded lists, ((b_j, PAD_OUT) uint8, (b_j,) int32) on mesh[j].  A
    shard may lie in host memory instead.  A negative total is the
    encoder's capacity poison; the caller checks."""
    return _sharded_encode(tuple(mesh), dense)


def sharded_decode(mesh):
    """The batched block decoder (K2) over the mesh: (comp, comp_lens,
    out_lens) sharded lists -> (out, ok) sharded lists, ((b_j, BS) uint8,
    (b_j,) bool) on mesh[j]."""
    return _sharded_decode(tuple(mesh))


def _run_sharded(mesh, sharded_fn, arrays):
    """Pad `arrays` (host, block-major) to the global shard count, cut
    this rank's block range into the mesh's shards, run sharded_fn on them
    (it copies each shard to its device just before launching it) and
    return its outputs for every block, in block order, as host arrays of
    the padded batch.  Under a process group every rank's mesh must be as
    wide."""
    B = arrays[0].shape[0]
    rank, world = _group()
    if world > 1:
        widths = _all_gather(np.array([len(mesh)], np.int64), mesh[0])
        if (widths != len(mesh)).any():
            raise ValueError(f"the ranks' meshes differ in width: {widths.tolist()}")
    Bp = _pad_batch(B, world * len(mesh))
    per = Bp // (world * len(mesh))
    lo = rank * len(mesh) * per  # this rank's first block
    shards = []
    for a in arrays:
        p = np.zeros((Bp, *a.shape[1:]), a.dtype)
        p[:B] = a
        shards.append([torch.from_numpy(p[lo + j * per : lo + (j + 1) * per]) for j in range(len(mesh))])
    local = [np.concatenate([t.cpu().numpy() for t in out]) for out in sharded_fn(*shards)]
    if not _grouped() or Bp == 0:  # every rank has the empty batch
        return local
    return [_all_gather(buf, mesh[0]) for buf in local]


def _all_gather(local: np.ndarray, dev: torch.device) -> np.ndarray:
    """Every rank's equal-shaped block range, concatenated in rank order."""
    gather_dev = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.from_numpy(local.view(np.uint8) if local.dtype == np.bool_ else local).to(gather_dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    out = torch.cat(parts).cpu().numpy()
    return out.view(np.bool_) if local.dtype == np.bool_ else out


def encode_mesh(mesh, blocks: np.ndarray, lens: np.ndarray, profile: str = "dense"):
    """Encode (B, BS) blocks data-parallel over the mesh.

    Pads the batch to a multiple of the global shard count with zero-length
    blocks (which compress to zero bytes) and returns order-preserving
    ((B, PAD_OUT) uint8, (B,) int32) host arrays; api.CapacityError (a
    ValueError) if the encoder poisoned a block."""
    B = blocks.shape[0]
    comp, totals = _run_sharded(
        mesh,
        sharded_encode(mesh, profile != "fast"),
        (np.asarray(blocks, np.uint8), np.asarray(lens, np.int32)),
    )
    comp, totals = comp[:B], totals[:B]
    api.check_totals(totals)  # no silent truncation
    return comp, totals


def decode_mesh(mesh, comp: np.ndarray, comp_lens: np.ndarray, out_lens: np.ndarray):
    """Decode padded per-block op chunks data-parallel over the mesh ->
    ((B, BS) uint8, (B,) bool) host arrays in block order."""
    B = comp.shape[0]
    out, ok = _run_sharded(
        mesh,
        sharded_decode(mesh),
        (np.asarray(comp, np.uint8), np.asarray(comp_lens, np.int32), np.asarray(out_lens, np.int32)),
    )
    return out[:B], ok[:B]


def init_distributed(device="cuda") -> tuple[int, int]:
    """Multi-process entry: initialise torch.distributed from torchrun's
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) when it is
    present, with NCCL for a mesh on CUDA and gloo on the CPU; a no-op for a
    single-process run.  On CUDA the process's current device becomes the
    first of its own cards (make_mesh), so NCCL never sees two ranks on one
    card.  After this, encode_mesh/decode_mesh shard blocks over every
    rank's shards.  Returns (rank, world_size)."""
    if not dist.is_initialized() and all(
        k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    ):
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(make_mesh(1, device)[0])
            dist.init_process_group("nccl", init_method="env://")
        else:
            dist.init_process_group("gloo", init_method="env://")
    return _group()
