"""The port's block-parallel mesh on a CPU mesh of 8 shards against the JAX
mesh on the conftest's 8 virtual devices and against the port's single
call: the same rows and totals, zero padding included, in block order
(tolerance 0).  Also the mesh's own contracts: padding of an uneven batch,
contiguous shard ranges in calls of at most 128 blocks, the refusal of a
negative total, make_mesh's refusals, and the config-4 tool at 1 MB."""

import jax
import numpy as np
import pytest
import torch

from snappytpu.mesh import decode_mesh as jax_decode_mesh
from snappytpu.mesh import encode_mesh as jax_encode_mesh
from snappytpu.mesh import make_mesh as jax_make_mesh
from snappytpu_torch.bench import corpus
from snappytpu_torch.format import constants as C
from snappytpu_torch.kernels.encode_v2 import encode_blocks_v2
from snappytpu_torch.mesh import decode_mesh, encode_mesh, make_mesh, sharding
from snappytpu_torch.stream import framing

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, "cpu")


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8)


def _single(blocks, lens, profile="dense"):
    c, t = encode_blocks_v2(torch.from_numpy(blocks), torch.from_numpy(lens), dense=(profile != "fast"))
    return c.numpy(), t.numpy()


@pytest.mark.parametrize("profile", ["dense", "fast"])
def test_mesh_encode_matches_single_device_and_jax(mesh8, jax_mesh8, profile):
    data = np.frombuffer(corpus.mixed(9 * C.MAX_BLOCK_SIZE + 1234, seed=3), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp_m, tot_m = encode_mesh(mesh8, blocks, lens, profile)
    comp_s, tot_s = _single(blocks, lens, profile)
    comp_j, tot_j = jax_encode_mesh(jax_mesh8, blocks, lens, profile)
    assert comp_m.dtype == np.uint8 and tot_m.dtype == np.int32 and comp_m.shape == (10, C.MAX_COMPRESSED_BLOCK_SIZE)
    np.testing.assert_array_equal(tot_m, tot_s)
    np.testing.assert_array_equal(comp_m, comp_s)
    np.testing.assert_array_equal(tot_m, tot_j)
    np.testing.assert_array_equal(comp_m, comp_j)


def test_mesh_roundtrip_order_preserved(mesh8, jax_mesh8):
    data = np.frombuffer(corpus.mixed(17 * C.MAX_BLOCK_SIZE, seed=7), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = encode_mesh(mesh8, blocks, lens)
    chunks = [comp[i, : totals[i]] for i in range(comp.shape[0])]
    padded, comp_lens = framing.pad_chunks(chunks)
    out, ok = decode_mesh(mesh8, padded, comp_lens, lens)
    assert ok.dtype == np.bool_ and ok.all()
    rec = b"".join(out[i, : lens[i]].tobytes() for i in range(out.shape[0]))
    assert rec == data.tobytes()
    out_j, ok_j = jax_decode_mesh(jax_mesh8, padded, comp_lens, lens)
    np.testing.assert_array_equal(out, out_j)
    np.testing.assert_array_equal(ok, ok_j)


def test_mesh_decode_flags_match_jax_on_mutated_rows(mesh8, jax_mesh8):
    """Mutated rows: per-block ok flags equal the JAX mesh's, in block order."""
    data = np.frombuffer(corpus.mixed(5 * C.MAX_BLOCK_SIZE, seed=21), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = encode_mesh(mesh8, blocks, lens, "fast")
    rng = np.random.default_rng(5)
    bad = comp.copy()
    for i in (1, 3):
        bad[i, rng.integers(0, totals[i], 4)] ^= 0x5A
    out, ok = decode_mesh(mesh8, bad, totals, lens)
    out_j, ok_j = jax_decode_mesh(jax_mesh8, bad, totals, lens)
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(out[ok], out_j[ok])
    assert ok[[0, 2, 4]].all()


def test_mesh_uneven_batch(mesh8, jax_mesh8):
    # 3 blocks over 8 shards: padding blocks must be invisible in output
    data = np.frombuffer(corpus.text(2 * C.MAX_BLOCK_SIZE + 77), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = encode_mesh(mesh8, blocks, lens)
    comp_s, tot_s = _single(blocks, lens)
    assert comp.shape[0] == totals.shape[0] == 3
    np.testing.assert_array_equal(comp, comp_s)
    np.testing.assert_array_equal(totals, tot_s)
    comp_j, tot_j = jax_encode_mesh(jax_mesh8, blocks, lens)
    np.testing.assert_array_equal(comp, comp_j)
    np.testing.assert_array_equal(totals, tot_j)


def _spy(monkeypatch):
    """Replace the mesh's encoder by a cheap stand-in that records each
    call's (device, first block's length, blocks); block b carries length b."""
    calls = []

    def fake(b, n, dense=True):
        calls.append((b.device.type, int(n[0]), b.shape[0]))
        comp = torch.zeros((b.shape[0], C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8)
        comp[:, 0] = (n % 251).to(torch.uint8)
        return comp, n.clone()

    monkeypatch.setattr(sharding, "encode_blocks", fake)
    return calls


@pytest.mark.parametrize("B,n,calls_want", [
    (3, 8, [(0, 1), (1, 1), (2, 1), (0, 1), (0, 1), (0, 1), (0, 1), (0, 1)]),  # padded with zero-length blocks
    (300, 2, [(0, 128), (128, 22), (150, 128), (278, 22)]),                  # calls of at most 128
    (257, 1, [(0, 128), (128, 128), (256, 1)]),
])
def test_shards_take_contiguous_ranges_in_bounded_calls(monkeypatch, B, n, calls_want):
    calls = _spy(monkeypatch)
    blocks = np.zeros((B, C.MAX_BLOCK_SIZE), np.uint8)
    lens = np.arange(B, dtype=np.int32)
    comp, totals = encode_mesh(make_mesh(n, "cpu"), blocks, lens)
    assert [(first, nb) for _dev, first, nb in calls] == calls_want
    np.testing.assert_array_equal(totals, lens)  # block order, sliced back to B
    np.testing.assert_array_equal(comp[:, 0], lens % 251)


def test_negative_total_raises(monkeypatch, mesh8):
    """No silent truncation: a block whose total the encoder poisoned (-1)
    makes encode_mesh raise ValueError naming it."""
    real = sharding.encode_blocks

    def poisoned(b, n, dense=True):
        comp, totals = real(b, n, dense=dense)
        return comp, torch.where(n == 777, -1, totals)

    monkeypatch.setattr(sharding, "encode_blocks", poisoned)
    data = np.frombuffer(corpus.text(2 * C.MAX_BLOCK_SIZE + 777), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    with pytest.raises(ValueError, match=r"block\(s\) \[2\] exceeded the emission capacity bound"):
        encode_mesh(mesh8, blocks, lens)


def test_make_mesh():
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert make_mesh(device="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    with pytest.raises(ValueError):
        make_mesh(1, "meta")


def test_make_mesh_refuses_more_cards_than_torch_sees():
    """Never a repeated card and never the CPU in place of a card: on this
    box (no card) even make_mesh(1, "cuda") raises."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"torch sees {have}"):
        make_mesh(have + 1, "cuda")
    if have == 0:
        with pytest.raises(RuntimeError):
            make_mesh(1, "cuda")
        with pytest.raises(RuntimeError):
            make_mesh(device="cuda")


@pytest.mark.parametrize("have,local_rank,local_world,want", [
    (4, 0, 1, range(0, 4)),
    (4, 1, 2, range(2, 4)),
    (8, 3, 4, range(6, 8)),
    (3, 1, 2, range(1, 2)),  # a card no process can own an equal share of stays unused
    (1, 0, 1, range(0, 1)),
])
def test_local_cards_are_an_equal_share(have, local_rank, local_world, want):
    assert sharding._local_cards(have, local_rank, local_world) == want


@pytest.mark.parametrize("have,local_rank,local_world", [(1, 0, 2), (0, 0, 1), (4, 2, 2), (4, -1, 2)])
def test_local_cards_refused(have, local_rank, local_world):
    with pytest.raises(RuntimeError):
        sharding._local_cards(have, local_rank, local_world)


def test_cuda_mesh_under_torchrun_holds_only_its_own_cards(monkeypatch):
    """Two processes on a host of four cards (torchrun's LOCAL_RANK,
    LOCAL_WORLD_SIZE): rank 1's mesh is cuda:2, cuda:3, and never wider."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert make_mesh(device="cuda") == [torch.device("cuda", 2), torch.device("cuda", 3)]
    assert make_mesh(1, "cuda") == [torch.device("cuda", 2)]
    with pytest.raises(RuntimeError, match="this process has 2 of the 4 torch sees"):
        make_mesh(3, "cuda")


def test_init_distributed_on_cuda_pins_the_rank_to_its_card(monkeypatch):
    """Under torchrun on CUDA the process's current device is its first own
    card before NCCL starts (recorded, not run: this box has no card)."""
    done = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: done.append(("set_device", d)))
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda b, **k: done.append(("init", b)))
    monkeypatch.setattr(sharding, "_group", lambda: (3, 4))
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="1", RANK="3", WORLD_SIZE="4", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    assert sharding.init_distributed("cuda") == (3, 4)
    assert done == [("set_device", torch.device("cuda", 2)), ("init", "nccl")]


def test_init_distributed_without_environment_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert sharding.init_distributed("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


def test_config4_tool_on_a_cpu_mesh():
    from snappytpu_torch.tools import config4_mesh

    lines = []
    r = config4_mesh.check(1, 4, device="cpu", log=lines.append)
    assert r["shards"] == 4 and r["blocks"] == 16 and r["bytes"] == 1 << 20
    assert "CONFIG-4 OK" in lines[-1]
