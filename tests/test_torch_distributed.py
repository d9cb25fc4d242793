"""The port's multi-process mesh (torch.distributed, gloo on the CPU): two
worker processes with four CPU shards each encode one corpus over the
8-shard mesh, all-gather the padded rows and round-trip them through the
mesh decoder.  Both must agree, and equal a single-process port encode_mesh
and the JAX encoder's rows byte for byte (host-count invariance,
SURVEY.md §4, §5.8).  Ranks whose meshes differ in width are refused."""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode_blocks
from snappytpu_torch.bench import corpus
from snappytpu_torch.mesh import sharding
from snappytpu_torch.stream import framing

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _digest(comp, totals) -> str:
    return hashlib.sha256(np.asarray(comp, np.uint8).tobytes() + np.asarray(totals, np.int32).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both workers' output directory and logs, with the single-process and
    JAX digests made while they ran."""
    tmp_path = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(tmp_path)], env=dict(env, RANK=str(i)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    try:
        # the references, while the workers run
        data = np.frombuffer(corpus.mixed(300_000, seed=77), np.uint8)
        blocks, lens = framing.pack_blocks(data)
        single = _digest(*sharding.encode_mesh(sharding.make_mesh(8, "cpu"), blocks, lens))
        jax_rows = _digest(*jax_encode_blocks(blocks, lens))
        outs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
    return tmp_path, single, jax_rows


def test_two_process_mesh_encode_matches_single_process(run):
    tmp_path, single, jax_rows = run
    digests = [(tmp_path / f"digest_{i}.txt").read_text().strip() for i in range(2)]
    assert digests[0] == digests[1], "processes disagree on compressed bytes"
    assert digests[0] == single, "2-process rows differ from the single-process mesh"
    assert single == jax_rows, "the port's mesh rows differ from the JAX encoder's"


def test_ranks_with_meshes_of_unequal_width_are_refused(run):
    """Rank 0 offers one shard and rank 1 two: both raise, naming the widths,
    rather than encode overlapping or missing block ranges."""
    tmp_path = run[0]
    for i in range(2):
        assert (tmp_path / f"refused_{i}.txt").read_text() == "the ranks' meshes differ in width: [1, 2]"
