"""K7's header, checked from its own source without a GPU.

snappytpu_torch/csrc/tier_b.cuh holds the kernel's body: the staged key
words, the comparator, a merge level's share of a thread and a sorted slot's
match.  Here g++ builds it into a host harness that runs a block as the
kernel does: the block staged, each merge level over the kernel's 1024
threads in reverse order into a scratch row, copied back, then every slot's
match, thread by thread in reverse, the order laid out in shared memory and
in the scratch row as the kernel lays it.  The harness fails a case on a
level output, a scratch entry copied back or a position not written
exactly once, on two entries at one padded index, or on an order that is no
permutation.  Every (length, distance) must equal the reference's, tier B
of the JAX package's `_find_matches` (its tier 1) run on the CPU, and the
CPU route's, `encode_v2._tier_b`'s torch chain, byte for byte, in both
profiles and under
the encoder tools' knobs (`dense_keys` k8 and k12samp, `b_ranks=(1, 2, 3)`),
on blocks of zeros, of 0xFF (word 0's tail override ties with real
0xFFFFFFFF words), of periods 1, 2, 3, 7 and 64, of seeded noise and of the
zstd 50 % sample, at lengths from 0 to a full block; and the sorted order
must be `_lex_order`'s.
"""

import ctypes
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import datagen
from snappytpu.kernels import encode_v2 as J
from snappytpu_torch import _build
from snappytpu_torch.kernels import encode_v2 as E
from snappytpu_torch.kernels import tier_b as K
from snappytpu_torch.tools.enc_variants import K12SAMP

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

HARNESS = r"""
#include <string.h>
#include <algorithm>
#include <vector>
#include "tier_b.cuh"

namespace {
using namespace snappy_tier_b;

struct CheckedStore {  // a merge level's outputs, to the scratch row at scratch_index, each written once
  uint16_t* row;
  int32_t* writes;
  int32_t shift;
  void operator()(int32_t k, int32_t q) {
    row[scratch_index(k, shift)] = static_cast<uint16_t>(q);
    ++writes[k];
  }
};
}  // namespace

extern "C" int32_t tier_b_threads() { return kThreads; }

// K7's thread block on the host, each step over its threads in reverse
// order, the order in shared memory and in the scratch row laid out as the
// kernel lays them.  order_out (N entries, or null) gets the sorted
// sub-positions.  stats = {merge levels, level outputs not written exactly
// once, positions not written exactly once, sub-positions not exactly once
// in the order, shared entries not at a distinct order_index below the
// padded size, scratch entries copied back not exactly once}.
extern "C" void tier_b_host(const uint8_t* block, int32_t n, int32_t stride, int32_t nkeys, const uint8_t* key_ids,
                            int32_t rank_mask, int32_t* out_len, int32_t* out_dist, uint16_t* order_out,
                            int64_t* stats) {
  std::vector<uint32_t> T(kTextWords, 0u);
  for (int32_t k = 0; k < kBlock / 4; ++k) {
    uint32_t w;
    memcpy(&w, block + 4 * k, 4);
    T[k] = be32(w);
  }
  Params P{stride, nkeys, rank_mask, {}};
  for (int32_t t = 0; t < nkeys; ++t) P.key_ids[t] = key_ids[t];
  const int32_t N = kBlock / stride, share = N / kThreads;
  int32_t shift = 0;
  while ((1 << shift) < share) ++shift;
  std::vector<uint16_t> pad(N + 2 * kThreads, 0xEEEE), scratch(N);
  std::vector<int32_t> writes(N), at(N + 2 * kThreads, 0), copied(N);
  for (int32_t t = kThreads - 1; t >= 0; --t) {
    for (int32_t k = range_lo(N, t); k < range_lo(N, t) + share; ++k) {
      pad[order_index(k, shift)] = static_cast<uint16_t>(k);
      ++at[order_index(k, shift)];
    }
  }
  for (int32_t i = 0; i < N + 2 * kThreads; ++i) stats[4] += at[i] > 1;
  const Order order{pad.data(), shift};
  for (int32_t R = 1; R < N; R <<= 1) {
    std::fill(writes.begin(), writes.end(), 0);
    std::fill(copied.begin(), copied.end(), 0);
    std::fill(scratch.begin(), scratch.end(), 0xEEEE);
    CheckedStore st{scratch.data(), writes.data(), shift};
    for (int32_t t = kThreads - 1; t >= 0; --t) {
      const int32_t lo = range_lo(N, t);
      merge_range(T.data(), P, n, order, R, lo, lo + share, st);
    }
    for (int32_t k = 0; k < N; ++k) stats[1] += writes[k] != 1;
    for (int32_t t = kThreads - 1; t >= 0; --t) {  // the copy back, as the kernel's threads make it
      for (int32_t j = 0; j < share; ++j) {
        pad[order_index(range_lo(N, t) + j, shift)] = scratch[j * kThreads + t];
        ++copied[j * kThreads + t];
      }
    }
    for (int32_t k = 0; k < N; ++k) stats[5] += copied[k] != 1;
    ++stats[0];
  }
  std::vector<int32_t> seen(N, 0), pw(kBlock, 0);
  for (int32_t k = 0; k < N; ++k) ++seen[order(k)];
  for (int32_t q = 0; q < N; ++q) stats[3] += seen[q] != 1;
  if (order_out) {
    for (int32_t k = 0; k < N; ++k) order_out[k] = static_cast<uint16_t>(order(k));
  }
  for (int32_t t = kThreads - 1; t >= 0; --t) {
    for (int32_t i = t; i < N; i += kThreads) {
      int32_t s;
      const Match m = slot_match(T.data(), P, n, order, N, i, &s);
      for (int32_t j = 0; j < stride; ++j) {
        out_len[s + j] = j ? 0 : m.len;
        out_dist[s + j] = j ? 0 : m.dist;
        ++pw[s + j];
      }
    }
  }
  for (int32_t p = 0; p < kBlock; ++p) stats[2] += pw[p] != 1;
}
"""

BS = E.BS
# (dense, _tier_b's knobs): the two profiles and the encoder tools' tier-B knobs
VARIANTS = {
    "dense": (True, {}),
    "fast": (False, {}),
    "k8": (True, dict(dense_keys=tuple(range(8)))),
    "k12samp": (True, dict(dense_keys=K12SAMP)),
    "b_ranks_1_2_3": (True, dict(b_ranks=(1, 2, 3))),
}
KINDS = ["zero", "ff", "period1", "period2", "period3", "period7", "period64", "random", "zstd50"]
LENGTHS = [0, 1, 3, 4, 5, 63, 64, 65, 4097, 65536]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("tier_b_host")
    src, so = d / "harness.cc", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I32 = ctypes.c_void_p, ctypes.c_int32
    lib.tier_b_host.argtypes = [P, I32, I32, I32, P, I32, P, P, P, P]
    lib.tier_b_host.restype = None
    lib.tier_b_threads.argtypes = []
    lib.tier_b_threads.restype = I32
    return lib


@functools.cache
def _block(kind):
    """One 64 KiB block of the kind, the same for every length."""
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "zero":
        return np.zeros(BS, np.uint8)
    if kind == "ff":
        return np.full(BS, 0xFF, np.uint8)
    if kind.startswith("period"):
        return np.resize(rng.integers(0, 256, int(kind[6:]), dtype=np.uint8), BS)
    if kind == "random":
        return rng.integers(0, 256, BS, dtype=np.uint8)
    assert kind == "zstd50"
    return datagen.rdg(BS, datagen._generator(24, "cpu"), "cpu").numpy()


def _settings(variant):
    """(dense, knobs, stride, key_ids, b_ranks) as `_tier_b` sets them."""
    dense, kw = VARIANTS[variant]
    return (dense, kw, *E._tier_b_params(dense, **kw))


@functools.cache
def _cpu(variant, kind):
    """The CPU route over the kind's block at every length: (mlen, dist), (len(LENGTHS), BS) each."""
    dense, kw, *_ = _settings(variant)
    blocks = torch.from_numpy(np.tile(_block(kind), (len(LENGTHS), 1)))
    n = torch.tensor(LENGTHS, dtype=torch.int32)
    mlen, dist = E._tier_b(E._match_words(blocks, n), dense, **kw)
    return mlen.numpy(), dist.numpy()


@functools.cache
def _jax(variant, kind):
    """The reference's tier B over the kind's block at every length: tier 1
    of the JAX `_find_matches` under the variant's knobs, jitted once a
    variant, run on the CPU; (mlen, dist), (len(LENGTHS), BS) each."""
    blocks = jnp.asarray(np.tile(_block(kind), (len(LENGTHS), 1)))
    mlen, dist = _jax_tier_b(variant)(blocks, jnp.asarray(np.array(LENGTHS, np.int32)))
    return np.asarray(mlen), np.asarray(dist)


@functools.cache
def _jax_tier_b(variant):
    dense, kw = VARIANTS[variant]
    return jax.jit(lambda blocks, n: J._find_matches(blocks, n, dense=dense, **kw)[1])


def _host(lib, variant, block, n, want_order=False):
    _, _, stride, key_ids, b_ranks = _settings(variant)
    nkeys, _, mask = K.params(stride, key_ids, b_ranks)
    ids = np.array(key_ids, np.uint8)
    out_len, out_dist = np.full(BS, -7, np.int32), np.full(BS, -7, np.int32)
    order = np.zeros(BS // stride, np.uint16) if want_order else None
    stats = np.zeros(6, np.int64)
    lib.tier_b_host(block.ctypes.data, n, stride, nkeys, ids.ctypes.data, mask, out_len.ctypes.data,
                    out_dist.ctypes.data, None if order is None else order.ctypes.data, stats.ctypes.data)
    levels = int(np.log2(BS // stride))
    assert stats.tolist() == [levels, 0, 0, 0, 0, 0], "levels; not written once; order; layouts"
    return out_len, out_dist, order


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_equal_the_cpu_route(lib, variant, kind, n):
    block = np.ascontiguousarray(_block(kind))
    got_len, got_dist, _ = _host(lib, variant, block, n)
    want_len, want_dist = (x[LENGTHS.index(n)] for x in _cpu(variant, kind))
    np.testing.assert_array_equal(got_len, want_len, err_msg="mlen")
    np.testing.assert_array_equal(got_dist, want_dist, err_msg="dist")


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_equal_the_jax_tier_b(lib, variant, kind, n):
    """The harness's (length, distance) and the CPU route's both equal the
    reference's: JAX's tier B on the same block, length and knobs."""
    block = np.ascontiguousarray(_block(kind))
    got_len, got_dist, _ = _host(lib, variant, block, n)
    i = LENGTHS.index(n)
    want_len, want_dist = (x[i] for x in _jax(variant, kind))
    np.testing.assert_array_equal(got_len, want_len, err_msg="mlen, K7's header against JAX")
    np.testing.assert_array_equal(got_dist, want_dist, err_msg="dist, K7's header against JAX")
    cpu_len, cpu_dist = (x[i] for x in _cpu(variant, kind))
    np.testing.assert_array_equal(cpu_len, want_len, err_msg="mlen, the CPU route against JAX")
    np.testing.assert_array_equal(cpu_dist, want_dist, err_msg="dist, the CPU route against JAX")


@pytest.mark.parametrize("n", [3, 4097, 65536])
@pytest.mark.parametrize("kind", ["ff", "period7", "zstd50"])
@pytest.mark.parametrize("variant", ["dense", "fast", "k12samp"])
def test_order_is_the_stable_lexicographic_one(lib, variant, kind, n):
    """The merge sort's order is `_lex_order`'s over the same key words:
    ties (equal keys over all the sort words) in position order."""
    dense, _, stride, key_ids, _ = _settings(variant)
    block = np.ascontiguousarray(_block(kind))
    mw = E._match_words(torch.from_numpy(block[None]), torch.tensor([n], dtype=torch.int32))
    kw_eff = (mw.w0p,) + mw.kws[1:]
    want = E._lex_order([kw_eff[j][:, ::stride] for j in key_ids])[0].numpy()
    np.testing.assert_array_equal(_host(lib, variant, block, n, want_order=True)[2].astype(np.int64), want)


def test_harness_runs_the_kernels_block_shape(lib):
    """The harness walks the block by the header's constants, the kernel's
    1024 threads with 64 (dense) or 16 (fast) outputs each a level."""
    assert lib.tier_b_threads() == 1024 and BS % (16 * 1024) == 0


@pytest.mark.parametrize("stride, key_ids, b_ranks, nkeys, packed, mask", [
    (1, range(16), (1, 2), 16, 0xFEDCBA9876543210, 0b11),
    (4, (0, 1, 4, 8, 12, 15), (1, 2), 6, 0xFC8410, 0b11),
    (1, (15, 0), (4, 1, 1), 2, 0x0F, 0b1001),
    (1, (3,), (), 1, 3, 0),
])
def test_params_pack_what_the_kernel_reads(stride, key_ids, b_ranks, nkeys, packed, mask):
    assert K.params(stride, key_ids, b_ranks) == (nkeys, packed, mask)


@pytest.mark.parametrize("stride, key_ids, b_ranks, match", [
    (2, (0,), (1,), "stride must be 1 or 4"),
    (1, (), (1,), "key words must be"),
    (1, (0, 0), (1,), "key words must be"),
    (1, (16,), (1,), "key words must be"),
    (1, (-1,), (1,), "key words must be"),
    (4, (0,), (0,), "ranks must each be 1 to 4"),
    (4, (0,), (5,), "ranks must each be 1 to 4"),
])
def test_params_refuse_what_the_kernel_does_not_take(stride, key_ids, b_ranks, match):
    with pytest.raises(ValueError, match=match):
        K.params(stride, key_ids, b_ranks)
