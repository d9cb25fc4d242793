"""T1's probe bodies, checked from their own source without a GPU, and the
batch's plan and CPU route.

snappytpu_torch/csrc/probe_scalar.cuh holds the bodies of T1's probes
(probe_scalar.cu runs them, one warp per SM).  It is host+device code: here
g++ builds it under the host warp policy of test_torch_decode_host.py
(PipeWarp: the 32 lanes one by one, in reverse, so that a probe whose lanes
depend on each other's order would show; its sync() is counted), and every
configuration of the JAX tool's five sections runs against the plain
version (`probe_scalar.plain`) at a small N.  rmw_chain_same must close a
group (one sync) before every step's reads, and no other probe syncs.
Each shape's shared memory in the header must be the one the launcher asks
for (`Probe.smem`).  `run_all`'s CPU route gives the plain tiles, and its
plan names each configuration once, one block each.
Tolerance: exact (integer chains).
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snappytpu_torch import _build
from snappytpu_torch.tools import probe_scalar as port
from test_torch_decode_host import HARNESS

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

PROBES = r"""
#include "probe_scalar.cuh"

namespace {
constexpr int kMaxWords = snappy_probe::kTile + 6 * snappy_probe::kScr;

// probe_scalar.cu's probe_block without the clocks: the input staged and
// the scratch zeroed after it (or, given scr0, set to it), the rest of
// shared memory garbage.
template <class P>
int probe_one(const int32_t* in, int32_t* out, int n, int64_t* syncs, const int32_t* scr0) {
  static int32_t smem[kMaxWords];
  for (int i = 0; i < kMaxWords; ++i) smem[i] = 0x5A5A5A5A;
  int32_t* tile = smem;
  int32_t* s = smem + snappy_probe::kTile;
  for (int i = 0; i < P::kStage; ++i) s[i] = in[i];
  for (int i = 0; i < P::kZero; ++i) s[P::kStage + i] = scr0 ? scr0[i] : 0;
  for (int i = 0; i < snappy_probe::kTile; ++i) tile[i] = 0;
  PipeWarp w{syncs};
  P::run(w, in, s, n, tile);
  for (int i = 0; i < snappy_probe::kTile; ++i) out[i] = P::kScalar ? tile[0] : tile[i];
  return 0;
}
}  // namespace

// The probe of (kind, a, b) for n steps into out (1024 words), its scratch
// zeroed or scr0; syncs counts its w.sync() calls.  -1: a shape the header
// does not build.
extern "C" int probe_scalar_host(int kind, int a, int b, const int32_t* in, int32_t* out, int n, int64_t* syncs,
                                 const int32_t* scr0) {
#define SNAPPY_HOST(k, A, B, ...) \
  if (kind == k && a == A && b == B) return probe_one<__VA_ARGS__>(in, out, n, syncs, scr0);
  SNAPPY_PROBE_SHAPES(SNAPPY_HOST)
#undef SNAPPY_HOST
  return -1;
}

// The dynamic shared memory probe_scalar.cu's block of (kind, a, b) needs
// (its tile, staged input and scratch), or -1.
extern "C" int probe_scalar_smem_host(int kind, int a, int b) {
#define SNAPPY_SMEM(k, A, B, ...)          \
  if (kind == k && a == A && b == B)      \
    return 4 * (snappy_probe::kTile + __VA_ARGS__::kStage + __VA_ARGS__::kZero);
  SNAPPY_PROBE_SHAPES(SNAPPY_SMEM)
#undef SNAPPY_SMEM
  return -1;
}
"""

N = 320  # a multiple of every unroll factor and of 10
CONFIGS = [p for g in sorted(port.GROUPS) for p in port.GROUPS[g]]
# every shape Probe.check accepts: the sections' 61 and the sweeps' others
SHAPES = ([port.Probe("smem_chase"), port.Probe("vmem_scalar"), port.Probe("dynrow_chain")]
          + [port.Probe(k, a) for k in ("alu_chain", "smem_par") for a in port._PAR]
          + [port.Probe(k, u) for k, us in port._UNROLL.items() if k != "vec_chain" for u in us]
          + [port.Probe(k, a, s) for k in ("dynrow_par", "dynrmw_par") for a in port._PAR for s in (0, 1)]
          + [port.Probe("bigstate_par", a, ns) for a, ns in ((1, 7), (1, 14), (6, 7), (6, 14))]
          + [port.Probe("vec_chain", u, r) for u in (2, 8) for r in (0, 1)])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("probe_scalar_host")
    src, so = d / "harness.cc", d / "libprobe_scalar.so"
    src.write_text(HARNESS + PROBES)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_scalar_host.argtypes = [I, I, I, P, P, I, P, P]
    lib.probe_scalar_host.restype = I
    lib.probe_scalar_smem_host.argtypes = [I, I, I]
    lib.probe_scalar_smem_host.restype = I
    return lib


def _host(lib, p, n, scr0=None):
    """The probe's body on the host, its scratch zeroed or scr0 -> ((8,
    128) tile, syncs)."""
    inp = np.ascontiguousarray(port.inputs(p))
    out = np.zeros((8, 128), np.int32)
    syncs = np.zeros(1, np.int64)
    rc = lib.probe_scalar_host(port.KINDS.index(p.kind), p.a, p.b, inp.ctypes.data, out.ctypes.data, n,
                               syncs.ctypes.data, None if scr0 is None else scr0.ctypes.data)
    assert rc == 0, f"{p.name}: not built"
    return out, int(syncs[0])


@pytest.mark.parametrize("n", [N, 333])
@pytest.mark.parametrize("p", CONFIGS, ids=lambda p: p.name)
def test_body_equals_plain_lanes_reversed(lib, p, n):
    got, syncs = _host(lib, p, n)
    np.testing.assert_array_equal(got, port.plain(p, port.inputs(p), n), err_msg=p.name)
    # rmw_chain_same closes a group before each step's reads and once before the tile
    assert syncs == (n // p.a * p.a + 1 if p.kind == "rmw_chain_same" else 0)


def _seeded_ref(p, scr0, n):
    """The tile of a probe with scratch whose scratch starts as scr0 (kZero
    words) instead of zeros: `plain`'s row moves on seeded refs, so that a
    word moved from the wrong column shows (from zeros every column of a ref
    holds the same value)."""
    refs = list(scr0.astype(np.int64).reshape(-1, 66, 128))
    k, a, b = p.kind, p.a, p.b
    x = 0
    if k == "dynrow_par" or k == "dynrmw_par":
        xs = list(range(a))
        acc = np.zeros((2, 128), np.int64)
        for _ in range(n):
            for j in range(a):
                x = xs[j] = (port._lcg(xs[j]) + j) & 63
                ref = refs[0 if b else j]
                if k == "dynrow_par":
                    acc ^= ref[x : x + 2]
                else:
                    ref[x : x + 2] ^= x + j
        return port._rows(acc if k == "dynrow_par" else refs[0][0:2], xs[0])
    for _ in range(n // a * a):
        x = port._lcg(x) & 63
        y = (x * 7) & 63
        if k == "dynrow_write":
            refs[0][x : x + 2] ^= x
        elif k == "rmw_chain_same":
            refs[0][y : y + 2] = refs[0][x : x + 2] ^ x
        else:
            refs[1][y : y + 2] = refs[0][x : x + 2] + x
    return port._rows(refs[-1][0:2], x)


SCRATCH = [p for p in CONFIGS if p.kind in ("dynrow_write", "split_ref_chain", "rmw_chain_same")
           or (p.kind in ("dynrow_par", "dynrmw_par") and p.a in (2, 6))]


@pytest.mark.parametrize("p", SCRATCH, ids=lambda p: p.name)
def test_body_moves_seeded_scratch_as_plain(lib, p):
    """Every column of the scratch differs: a lane that reads or writes
    another column than its model's, or (rmw_chain_same) a rotation on one
    side of the move only, changes the tile."""
    rng = np.random.default_rng(1300 + CONFIGS.index(p))
    words = p.smem // 4 - port.TILE  # these probes stage nothing: all scratch
    scr0 = rng.integers(-2**31, 2**31, words, dtype=np.int64).astype(np.int32)
    got, _ = _host(lib, p, N, scr0)
    np.testing.assert_array_equal(got, _seeded_ref(p, scr0, N), err_msg=p.name)


def test_sections_are_61_configurations_of_65_shapes(lib):
    assert len(CONFIGS) == 61 and len(set(CONFIGS)) == 61 and len(set(SHAPES)) == 65
    assert set(CONFIGS) <= set(SHAPES)
    for p in SHAPES:
        p.check()
    assert lib.probe_scalar_host(port.KINDS.index("alu_unroll"), 3, 0, None, None, 0, None, None) == -1


@pytest.mark.parametrize("p", SHAPES, ids=lambda p: p.name)
def test_shared_memory_is_the_headers(lib, p):
    assert p.smem == lib.probe_scalar_smem_host(port.KINDS.index(p.kind), p.a, p.b)
    assert p.smem <= max(q.smem for q in CONFIGS) == 4 * (port.TILE + 6 * port.SCR) == 4096 + 202_752


@functools.cache
def _run_all_cpu():
    return port.run_all(CONFIGS, N, device="cpu")


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=lambda i: CONFIGS[i].name)
def test_run_all_cpu_route_is_plain(i):
    tiles, clk = _run_all_cpu()
    assert tuple(tiles.shape) == (61, 8, 128) and tiles.dtype == torch.int32
    assert tuple(clk.shape) == (61, 2) and not clk.any()
    p = CONFIGS[i]
    np.testing.assert_array_equal(tiles[i].numpy(), port.plain(p, port.inputs(p), N))


def test_plan_names_each_configuration_once():
    launches, buf = port.plan(CONFIGS)
    rows = np.concatenate([li.table for li in launches])
    named = [port.Probe(port.KINDS[k], a, b) for k, a, b, _off in rows.tolist()]
    assert len(named) == 61 <= port.SMS and sorted(named, key=str) == sorted(CONFIGS, key=str)
    assert sorted(i for li in launches for i in li.index) == list(range(61))
    for li in launches:
        for i, (k, a, b, off) in zip(li.index, li.table.tolist()):
            p = CONFIGS[i]
            assert (port.KINDS[k], a, b) == (p.kind, p.a, p.b)
            np.testing.assert_array_equal(buf[off : off + port.inputs(p).size], port.inputs(p).reshape(-1))
            assert li.smem >= max(p.smem, port.ALONE)
    # one block per SM: two blocks of any launch overflow an SM's 228 KiB
    assert all(2 * (li.smem + 1024) > 228 * 1024 for li in launches)
    main, l1 = launches
    assert main.smem == 4096 + 202_752
    assert [CONFIGS[i].kind for i in l1.index] == ["vmem_scalar"] and l1.smem == port.ALONE


def test_plan_refuses_what_one_launch_cannot_hold():
    with pytest.raises(ValueError, match="twice"):
        port.plan([port.Probe("smem_chase"), port.Probe("smem_chase")])
    with pytest.raises(ValueError, match="one per SM"):
        port.plan(CONFIGS, sms=60)
    with pytest.raises(ValueError):
        port.plan([port.Probe("alu_unroll", 3)])
    launches, _ = port.plan([port.Probe("alu_chain", 1)])
    assert len(launches) == 1 and launches[0].smem == port.ALONE
