"""T3 (tape probe): the port's plain versions against the JAX package's
tools/tape_probe.py, run with Pallas in interpret mode.  Only the tool's
definitions are executed (its source up to `enc = jax.jit(`, from a string,
so nothing is written under tools/), with `pl` replaced by a namespace whose
pallas_call passes interpret=True.

Inputs: tapes from the native builder (snappytpu.cpu.build_tapes) for
dense-encoded text and mixed blocks, a malformed block (-10) and a pad.  The
exact modes (full-D1, full-D3, acc, rowbatch2, rowbatch4) give the JAX
tool's `run_mode(mode)` bytes, unpacked to uint8, and those of
snappytpu.kernels.decode_tape._run_tape; loads and const-dst give its ok
flags.  Tolerance: exact.
"""

import functools
import os
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from snappytpu import cpu
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels import decode_tape as jax_tape
from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
from snappytpu_torch import cpu as port_cpu
from snappytpu_torch.kernels import decode_tape
from snappytpu_torch.tools import tape_probe as port

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = C.MAX_BLOCK_SIZE


@pytest.fixture(autouse=True)
def _native():
    if not (cpu.available and port_cpu.available):
        pytest.skip("the tape builders need the native runtimes")


@functools.cache
def _jax_tool():
    path = os.path.join(ROOT, "tools", "tape_probe.py")
    with open(path) as f:
        src = f.read()
    ns = {"__file__": path, "__name__": "jax_tape_probe"}
    exec(compile(src[: src.index("enc = jax.jit(")], path, "exec"), ns)
    fake = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    fake.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = fake
    return ns


@functools.cache
def _batch():
    """Text and mixed blocks, a comp_len one short (-10) and a pad, in the
    JAX kernels' full-width tapes."""
    samples = [corpus.text(BS, seed=51), corpus.mixed(BS, seed=52), corpus.text(7_000, seed=53),
               corpus.low_entropy(30_000, seed=54)]
    blocks = np.zeros((len(samples), BS), np.uint8)
    lens = np.zeros(len(samples), np.int32)
    for i, s in enumerate(samples):
        blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    comp, totals = map(np.array, jax_encode(blocks, lens, True))
    comp = np.concatenate([comp, comp[:1], np.zeros((1, comp.shape[1]), np.uint8)])
    totals = np.concatenate([totals, [totals[0] - 1, 0]]).astype(np.int32)
    lens = np.concatenate([lens, [lens[0], 0]]).astype(np.int32)
    tapes, nrecs = decode_tape.build_tapes(comp, totals, lens)
    assert (nrecs == -10).any() and (nrecs == 0).any() and (nrecs > 1000).any()
    return tapes, nrecs, comp


def _port(mode, tapes, nrecs, comp):
    return [t.numpy() for t in port.probe(mode, *(torch.from_numpy(a) for a in (tapes, nrecs, comp)))]


@pytest.mark.parametrize("mode", ["full-D1", "full-D3", "acc", "rowbatch2", "rowbatch4"])
def test_exact_modes_equal_jax(mode):
    tapes, nrecs, comp = _batch()
    out, ok, aux = _port(mode, tapes, nrecs, comp)
    out_w, ok_tile = _jax_tool()["run_mode"](mode)(tapes, nrecs, comp)
    jout = np.ascontiguousarray(np.asarray(out_w)).view(np.uint8).reshape(len(nrecs), BS)
    jok = np.asarray(ok_tile)[:, 0, 0] == 1
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(ok, nrecs >= 0)
    np.testing.assert_array_equal(out[ok], jout[ok])
    kout, kok = map(np.asarray, jax_tape._run_tape(tapes, nrecs, comp))
    np.testing.assert_array_equal(ok, kok)
    np.testing.assert_array_equal(out[ok], kout[ok])
    assert not aux.any()


@pytest.mark.parametrize("mode", ["loads", "const-dst"])
def test_stripped_modes_flags_equal_jax(mode):
    tapes, nrecs, comp = _batch()
    out, ok, aux = _port(mode, tapes, nrecs, comp)
    _out_w, ok_tile = _jax_tool()["run_mode"](mode)(tapes, nrecs, comp)
    np.testing.assert_array_equal(ok, np.asarray(ok_tile)[:, 0, 0] == 1)
    assert not out.any()  # neither mode writes the image
    assert aux[ok & (nrecs > 0)].any() and not aux[nrecs == 0].any()


def test_stripped_modes_plain_values():
    """loads folds each record into word 0; const-dst leaves the scratch
    holding, at every offset, the byte of the last record that reached it."""
    tapes, nrecs, comp = _batch()
    args = tuple(torch.from_numpy(a) for a in (tapes[:1], nrecs[:1], comp[:1]))
    recs, ok = decode_tape.records(tapes[0].tolist(), int(nrecs[0]), tapes.shape[1] // 2)
    assert ok and len(recs) == nrecs[0]
    _, _, aux = port.probe("loads", *args)
    f = 0
    for src, dst, ln, p in recs:
        f ^= (src ^ (dst << 4) ^ (ln << 20) ^ (p << 28)) & 0xFFFFFFFF
    assert int(aux[0, 0]) & 0xFFFFFFFF == f and not aux[0, 1:].any()
    _, _, aux = port.probe("const-dst", *args)
    scr = aux[0].numpy().view(np.uint8)
    img = decode_tape.image(comp[0].tobytes())
    src, dst, ln, p = recs[-1]
    last = bytes(img[dst - p : dst] * (ln // p + 1))[:ln] if p else bytes(img[src : src + ln])
    assert scr[:ln].tobytes() == last


def test_hazard_batch_is_exact_in_every_mode():
    """The hand tape whose records read and overwrite each other's bytes
    within a rowbatch step: every accepted mode route equals K5's plain walk
    (on the card, chip_smoke.py holds the kernels to the same)."""
    tapes, nrecs, rows = port.hazard_batch()
    want, wok = decode_tape.run_tape_ref(*(torch.from_numpy(a) for a in (tapes, nrecs, rows)))
    assert wok.all() and want.any()
    for mode in port.EXACT:
        out, ok, _ = _port(mode, tapes, nrecs, rows)
        assert ok.all() and (out == want.numpy()).all(), mode


def test_modes_are_checked():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        port.probe("rowbatch3", torch.zeros((1, 2), dtype=torch.int32), z,
                   torch.zeros((1, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8))
