"""Worker process for the port's 2-process torch.distributed test.

Launched by tests/test_torch_distributed.py with torchrun's environment
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) and argv:
    torch_distributed_worker.py <outdir>

init_distributed() makes a gloo process group; each process owns 4 CPU
shards, so the mesh spans 8.  The worker encodes a shared deterministic
corpus data-parallel over every rank's shards (encode_mesh all-gathers the
padded rows), round-trips them through the mesh decoder, and writes a
digest of the compressed bytes so the parent can assert host-count
invariance against a single-process encode.  Then each rank offers a mesh
of another width (rank + 1 shards), which every rank must refuse.  Imports
neither jax nor the JAX package.
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from snappytpu_torch.bench import corpus  # noqa: E402
from snappytpu_torch.mesh import sharding  # noqa: E402
from snappytpu_torch.stream import framing  # noqa: E402

outdir = sys.argv[1]
rank, world = sharding.init_distributed("cpu")
if (rank, world) != (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])) or dist.get_backend() != "gloo":
    raise SystemExit(f"init_distributed gave rank {rank} of {world} on {dist.get_backend()}")

data = np.frombuffer(corpus.mixed(300_000, seed=77), np.uint8)
blocks, lens = framing.pack_blocks(data)
mesh = sharding.make_mesh(4, "cpu")
comp, totals = sharding.encode_mesh(mesh, blocks, lens)

# mesh decode round trip over the same ranks and shards
out, ok = sharding.decode_mesh(mesh, comp, totals, lens)
if not ok.all():
    raise SystemExit("mesh decode flagged corrupt blocks")
rec = b"".join(out[i, : lens[i]].tobytes() for i in range(len(lens)))
if rec != data.tobytes():
    raise SystemExit("multi-process mesh round trip mismatch")

digest = hashlib.sha256(comp.tobytes() + totals.tobytes()).hexdigest()  # whole rows, padding too

# every rank's mesh must be as wide: rank r offers r + 1 shards, and every rank refuses
try:
    sharding.encode_mesh(sharding.make_mesh(rank + 1, "cpu"), blocks[:2], lens[:2])
except ValueError as e:
    refused = str(e)
else:
    raise SystemExit("meshes of unequal widths were not refused")

dist.barrier()
dist.destroy_process_group()
with open(os.path.join(outdir, f"digest_{rank}.txt"), "w") as f:
    f.write(digest)
with open(os.path.join(outdir, f"refused_{rank}.txt"), "w") as f:
    f.write(refused)
print(f"rank {rank} OK", flush=True)
