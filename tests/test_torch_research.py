"""The port's research codecs and the mesh's sharded calls against the JAX
package on the CPU, exactly (integer codec: the tolerance is equality of
every byte, total, row and ok flag):

  * encode_jax.encode_blocks (the v1 encoder) and pipeline.encode_pipeline
    (both profiles) on the edge-case corpus cut to one block each and on a
    3-block batch, whole rows and totals, and some stages on their own;
  * decode_jax.decode_blocks and pipeline.decode_pipeline (one function in
    the port) against each JAX module on those streams, on a bad-offset
    stream, on mutated streams (whole rows, flags, and the model decoder's
    verdict), and at comp_len 73,728 and past it, where the two JAX modules
    clip the landing index differently (to one flag);
  * config.PROFILES and CodecConfig;
  * sharded_encode / sharded_decode on an 8-shard CPU mesh against
    encode_mesh / decode_mesh and the JAX sharded_encode on one device.

Every fixture's blocks ride one batch per codec, so JAX compiles once.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappytpu import config as jax_config
from snappytpu.kernels import decode_jax as JD
from snappytpu.kernels import encode_jax as JE
from snappytpu.kernels import pipeline as JP
from snappytpu.mesh import make_mesh as jax_make_mesh
from snappytpu.mesh import sharded_encode as jax_sharded_encode
from snappytpu_torch import config
from snappytpu_torch.bench import corpus
from snappytpu_torch.format import constants as C
from snappytpu_torch.kernels import decode_blocks, encode_blocks
from snappytpu_torch.kernels import decode_jax as TD
from snappytpu_torch.kernels import encode_jax as TE
from snappytpu_torch.kernels import pipeline as TP
from snappytpu_torch.mesh import AXIS, decode_mesh, encode_mesh, make_mesh, sharded_decode, sharded_encode
from snappytpu_torch.model import compress as model_compress
from snappytpu_torch.model import encode_block
from snappytpu_torch.model.decode import CorruptError, decode_ops
from snappytpu_torch.stream import framing

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

BS, PAD_OUT = C.MAX_BLOCK_SIZE, C.MAX_COMPRESSED_BLOCK_SIZE
EDGE = {k: v[:BS] for k, v in corpus.edge_case_corpus().items()}
NAMES = sorted(EDGE)
BATCH3 = [corpus.text(30000), corpus.constant(65536), corpus.mixed(65536, seed=3)]
CODECS = ("v1", "fast", "dense")  # encode_blocks, encode_pipeline per profile


def _pad(datas):
    blocks = np.zeros((len(datas), BS), np.uint8)
    for i, d in enumerate(datas):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
    return blocks, np.array([len(d) for d in datas], np.int32)


@functools.cache
def _inputs():
    """The edge cases' blocks, then the 3-block batch's, in one batch."""
    return _pad([EDGE[k] for k in NAMES] + BATCH3)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.cache
def _encoded(codec):
    """(jax rows, jax totals, port rows, port totals) of the whole batch."""
    blocks, lens = _inputs()
    if codec == "v1":
        j = JE.encode_blocks(blocks, lens)
        t = encode_blocks(*_t(blocks, lens))
    else:
        j = JP.encode_pipeline(blocks, lens, profile=codec)
        t = TP.encode_pipeline(*_t(blocks, lens), profile=codec)
    return np.asarray(j[0]), np.asarray(j[1]), t[0].numpy(), t[1].numpy()


def _row(name):
    return NAMES.index(name) if name in EDGE else len(NAMES) + int(name[-1])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", NAMES + ["batch3_0", "batch3_1", "batch3_2"])
def test_encode_rows_equal_jax(codec, name):
    jc, jt, tc, tt = _encoded(codec)
    i = _row(name)
    assert tc.dtype == np.uint8 and tt.dtype == np.int32
    assert tt[i] == jt[i]
    np.testing.assert_array_equal(tc[i], jc[i])  # all 73,728 bytes, padding included


def test_pipeline_dense_equals_encode_blocks():
    _, _, c1, t1 = _encoded("v1")
    _, _, c2, t2 = _encoded("dense")
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("profile", ["fast", "dense"])
def test_pipeline_equals_the_model(profile):
    """One mixed block byte for byte against the port's numpy model with the
    profile's tiers (the JAX test_pipeline's check, both profiles)."""
    data = corpus.mixed(BS, seed=77)
    comp, total = TP.encode_pipeline(*_t(*_pad([data])), profile=profile)
    got = comp[0, : int(total[0])].numpy().tobytes()
    assert got == encode_block(np.frombuffer(data, np.uint8), tiers_spec=config.PROFILES[profile])
    assert decode_ops(np.frombuffer(got, np.uint8), len(data)).tobytes() == data


@functools.cache
def _stage_jax():
    """The JAX per-block stages under vmap on the 3-block batch."""
    blocks, lens = _pad(BATCH3)
    u32 = jnp.asarray(blocks).astype(jnp.uint32)
    n = jnp.asarray(lens)
    mlen, dist = jax.jit(jax.vmap(JE._best_match))(u32, n)
    mark = jax.jit(jax.vmap(JE._greedy_path))(mlen, n)
    return blocks, lens, np.array(mlen), np.array(dist), np.array(mark)


def test_best_match_and_greedy_path_equal_jax():
    blocks, lens, mlen, dist, mark = _stage_jax()
    b, n = _t(blocks, lens)
    t_mlen, t_dist = TE._best_match(TE._word32(b), n.long())
    np.testing.assert_array_equal(t_mlen.numpy(), mlen)
    np.testing.assert_array_equal(t_dist.numpy(), dist)
    np.testing.assert_array_equal(TE._greedy_path(t_mlen, n.long()).numpy(), mark)


def test_pipeline_stages_equal_jax():
    """s_sort_tier, s_pred (the JAX pipeline's -2-initialised scatter-max),
    s_score, s_pick (its best_dist is not zeroed where the exact LCP is 0,
    as encode_jax._best_match's is; the parse reads no distance there) and
    exact_lcp: the port's 17 words give the JAX pipeline's 18 words' lengths."""
    blocks, lens = _pad(BATCH3)
    jw = JP.s_words(jnp.asarray(blocks))
    jh = {4: jw, **{g: JP.s_hash(jw, g) for g in (8, 16, 32, 64)}}
    n = jnp.asarray(lens)
    b, tn = _t(blocks, lens)
    tw = TP.s_words(b)
    th = {4: tw, **{g: TP.s_hash(tw, g) for g in (8, 16, 32, 64)}}
    for g in (8, 64):
        np.testing.assert_array_equal(th[g].numpy(), np.asarray(jh[g]).astype(np.int64))
    j_cands, t_cands = [], []
    for g, k in ((4, 1), (4, 2), (16, 1)):
        js = JP.s_sort_tier(jh[g], n - g)
        ts = TP.s_sort_tier(th[g], tn.long() - g)
        for a, b_ in zip(js, ts):
            np.testing.assert_array_equal(b_.numpy(), np.asarray(a).astype(np.int64))
        j_cands.append(JP.s_pred(*js, k))
        t_cands.append(TP.s_pred(*ts, k))
        np.testing.assert_array_equal(t_cands[-1].numpy(), np.asarray(j_cands[-1]))
    j_ests = [JP.s_score(c, jh[4], jh[8], jh[16], jh[32], jh[64], n) for c in j_cands]
    t_ests = [TP.s_score(c, th[4], th[8], th[16], th[32], th[64], tn.long()) for c in t_cands]
    for a, b_ in zip(j_ests, t_ests):
        np.testing.assert_array_equal(b_.numpy(), np.asarray(a))
    jc, jd = JP.s_pick(tuple(j_ests), tuple(j_cands), n)
    tc, td = TP.s_pick(t_ests, t_cands, tn.long())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(TP.exact_lcp(tw, tc, tn.long()).numpy(), np.asarray(JP.exact_lcp(jw, jc, n)))


def _eq(port, jax_arr, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_arr).astype(port.numpy().dtype), err_msg=what)


def test_pipeline_parse_and_emit_stages_equal_jax():
    """s_greedy_init, s_doubling (the port's 17 rounds in one call against
    the JAX pipeline's 3 x 6: both saturated), s_greedy_final, s_refine,
    s_emit_layout and s_emit_bytes on the JAX per-block stages' best
    matches."""
    blocks, lens, mlen, dist, _ = _stage_jax()
    n, jm, jd = jnp.asarray(lens), jnp.asarray(mlen), jnp.asarray(dist)
    tn, tm, td = (torch.from_numpy(a).long() for a in (lens, mlen, dist))
    J, R = JP.s_greedy_init(jm)
    tJ, tR = TP.s_greedy_init(tm)
    _eq(tJ, J, "J")
    _eq(tR, R, "R")
    for _ in range(3):
        J, R = JP.s_doubling(J, R, 6)
    tJ, tR = TP.s_doubling(tJ, tR, TE._ROUNDS)
    _eq(tJ, J, "doubled J")
    _eq(tR, R, "reached")
    jc, tc = JP.s_greedy_final(R, jm, n), TP.s_greedy_final(tR, tm, tn)
    _eq(tc, jc, "greedy copies")
    jc, tc = JP.s_refine(jc, jm, jd, n), TP.s_refine(tc, tm, td, tn)
    _eq(tc, jc, "refined copies")
    jl, tl = JP.s_emit_layout(jc, jm, jd, n), TP.s_emit_layout(tc, tm, td, tn)
    for name, a, b in zip(("lit", "run_start", "rs", "rlen", "hdr", "opb", "out_off", "total"), tl, jl):
        _eq(a, b, name)
    jb = JP.s_emit_bytes(jnp.asarray(blocks), jc, jm, jd, *jl[:-1])
    _eq(TP.s_emit_bytes(torch.from_numpy(blocks), tc, tm, td, *tl[:-1]), jb, "bytes")


def test_pipeline_decode_stages_equal_jax():
    """d_op_table, d_walk_init, s_doubling, d_walk_final, d_layout,
    d_op_at, d_chain_init, d_chain (the port's 17 walk and chain rounds
    against the JAX pipeline's 3 x 6) and d_final on the fast pipeline's
    16 streams."""
    rows, comp_lens = _research_streams("fast")
    _, lens = _inputs()
    cl, ol = jnp.asarray(comp_lens), jnp.asarray(lens)
    trows, tcl, tol = _t(rows, comp_lens, lens)
    jt, tt = JP.d_op_table(jnp.asarray(rows)), TP.d_op_table(trows)
    for name, a, b in zip(("jump", "out_len", "hdr", "kind", "dist"), tt, jt):
        _eq(a, b, name)
    J, R = JP.d_walk_init(jt[0], cl)
    tJ, tR = TP.d_walk_init(tt[0], tcl)
    _eq(tJ, J, "walk J")
    for _ in range(3):
        J, R = JP.s_doubling(J, R, 6)
    tJ, tR = TP.s_doubling(tJ, tR, TE._ROUNDS)
    _eq(tR, R, "walked")
    (js, jland), (ts, tland) = JP.d_walk_final(R, cl), TP.d_walk_final(tR, tcl)
    _eq(ts, js, "starts")
    _eq(tland, jland, "landed")
    (joff, jlen), (toff, tlen) = JP.d_layout(js, jt[1], ol), TP.d_layout(ts, tt[1], tol)
    _eq(toff, joff, "out_off")
    _eq(tlen, jlen, "ok_len")
    jat, tat = JP.d_op_at(js, joff), TP.d_op_at(ts, toff)
    _eq(tat, jat, "op_at")
    jc, tc = JP.d_chain_init(jat, jt[3], jt[4], jt[2], joff, ol), TP.d_chain_init(tat, tt[3], tt[4], tt[2], toff, tol)
    for name, a, b in zip(("ptr", "lit_src", "bad_ref"), tc, jc):
        _eq(a, b, name)
    jp = jc[0]
    for _ in range(3):
        jp = JP.d_chain(jp, 6)
    tp = TP.d_chain(tc[0])
    _eq(tp, jp, "roots")
    jo, to = JP.d_final(jnp.asarray(rows), jc[1], jp, ol, jland, jlen, jc[2]), \
        TP.d_final(trows, tc[1], tp, tol, tland, tlen, tc[2])
    _eq(to[0], jo[0], "rows")
    _eq(to[1], jo[1], "ok")
    assert to[1].all()


# ----------------------------------------------------------------- decode ---

DECODERS = {"v1": (JD.decode_blocks, decode_blocks), "pipeline": (JP.decode_pipeline, TP.decode_pipeline)}


DECODE_B = 16  # every decode call's batch, padded with empty rows, so JAX compiles once


def _decode_both(decoder, rows, comp_lens, out_lens):
    jfn, tfn = DECODERS[decoder]
    B = rows.shape[0]
    pad = [np.zeros((DECODE_B - B, *a.shape[1:]), a.dtype) for a in (rows, comp_lens, out_lens)]
    rows, comp_lens, out_lens = (np.concatenate([a, p]) for a, p in zip((rows, comp_lens, out_lens), pad))
    jo, jk = jfn(rows, comp_lens, out_lens)
    to, tk = tfn(*_t(rows, comp_lens, out_lens))
    assert to.dtype == torch.uint8 and tk.dtype == torch.bool
    assert tk[B:].all()  # an empty row is an empty block
    return np.asarray(jo)[:B], np.asarray(jk)[:B], to.numpy()[:B], tk.numpy()[:B]


@functools.cache
def _research_streams(codec):
    jc, jt, _, _ = _encoded(codec)
    return framing.pad_chunks([jc[i, : jt[i]] for i in range(jc.shape[0])])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_decode_research_streams(decoder, codec):
    rows, comp_lens = _research_streams(codec)
    blocks, lens = _inputs()
    jo, jk, to, tk = _decode_both(decoder, rows, comp_lens, lens)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(to, jo)
    assert tk.all()
    np.testing.assert_array_equal(to, blocks)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_decode_rejects_bad_offset(decoder):
    ops = bytes([0 << 2, ord("A"), (3 << 2) | C.TAG_COPY2, 0x0F, 0x27])
    rows, comp_lens = framing.pad_chunks([np.frombuffer(ops, np.uint8)])
    jo, jk, to, tk = _decode_both(decoder, rows, comp_lens, np.array([5], np.int32))
    assert not jk[0] and not tk[0]
    np.testing.assert_array_equal(to, jo)


@functools.cache
def _mutated():
    """8 single-block model streams with 3 op bytes mutated each (the JAX
    test_fuzz_decode's construction) and the model decoder's verdicts."""
    chunks, out_lens, verdicts = [], [], []
    for seed in range(8):
        rng = np.random.default_rng(200 + seed)
        data = corpus.mixed(int(rng.integers(100, 60000)), seed=seed)
        stream = bytearray(model_compress(data))
        for _ in range(3):
            stream[int(rng.integers(4, len(stream)))] = int(rng.integers(0, 256))
        arr = np.frombuffer(bytes(stream), np.uint8)
        out_len, start = framing.read_preamble(arr)
        assert out_len <= BS and arr.size - start <= PAD_OUT
        chunks.append(arr[start:])
        out_lens.append(out_len)
        try:
            verdicts.append(decode_ops(arr[start:], out_len).tobytes())
        except (CorruptError, ValueError):
            verdicts.append(None)
    rows, comp_lens = framing.pad_chunks(chunks)
    return rows, comp_lens, np.array(out_lens, np.int32), verdicts


@functools.cache
def _mutated_decoded(decoder):
    rows, comp_lens, out_lens, _ = _mutated()
    return _decode_both(decoder, rows, comp_lens, out_lens)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_decode_mutated_streams(decoder, seed):
    _, _, out_lens, verdicts = _mutated()
    jo, jk, to, tk = _mutated_decoded(decoder)
    assert tk[seed] == jk[seed]
    np.testing.assert_array_equal(to[seed], jo[seed])  # the whole row, ok or not
    assert tk[seed] == (verdicts[seed] is not None)
    if tk[seed]:
        assert to[seed, : out_lens[seed]].tobytes() == verdicts[seed]


def test_mutations_give_both_verdicts():
    verdicts = _mutated()[3]
    assert any(v is None for v in verdicts) and any(v is not None for v in verdicts)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_decode_at_and_past_the_row_end(decoder):
    """comp_len 73,728 (a full row) and past it, up to beyond the walk's
    sentinel region, and negative: decode_jax clips the landing index to
    PAD_OUT, the JAX pipeline to PAD_OUT + 127; the port's one decoder
    gives each module's rows and flags."""
    rng = np.random.default_rng(11)
    data = corpus.text(BS, seed=5)
    lit = np.frombuffer(model_compress(data), np.uint8)
    lit = lit[framing.read_preamble(lit)[1] :]
    comp_lens = np.array([PAD_OUT, PAD_OUT, PAD_OUT + 1, PAD_OUT + 100, PAD_OUT + 127, PAD_OUT + 128,
                          90_000, -5, lit.size, lit.size], np.int32)
    rows = rng.integers(0, 256, (comp_lens.size, PAD_OUT), dtype=np.uint8)
    rows[0] = 0  # 73,728 bytes of one-byte literals' tags and payload
    rows[0, 1::2] = 7
    rows[-2:] = 0
    rows[-2:, : lit.size] = lit
    rows[-1, lit.size - 1] ^= 0x40
    out_lens = np.array([PAD_OUT // 2, 0, 0, 0, 0, 0, 0, 0, BS, BS], np.int32)
    jo, jk, to, tk = _decode_both(decoder, rows, comp_lens, out_lens)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(to, jo)
    assert tk[0] and tk[-2]  # a full row of 36,864 one-byte literals; the text block


def test_the_landing_clips_give_the_same_flags():
    """The walk's sentinel offsets PAD_OUT.. are reached only through
    PAD_OUT and step forward to comp_len, so clipping the landing index to
    PAD_OUT (decode_jax) or to PAD_OUT + 127 (pipeline) gives one flag: the
    two JAX decoders agree past the row end, which is why the port has one."""
    assert TP.decode_pipeline is decode_blocks
    rows = np.zeros((6, PAD_OUT), np.uint8)
    rows[3:, 1::2] = 9
    rows[4:, 5] = 0xFC  # a 4-byte-length literal whose jump leaves the row
    comp_lens = np.array([PAD_OUT + 1, PAD_OUT + 128, 100_000, PAD_OUT + 64, PAD_OUT + 300, PAD_OUT], np.int32)
    out_lens = np.array([PAD_OUT // 2, PAD_OUT // 2, 0, PAD_OUT // 2, 2, 2], np.int32)
    v1, pipe = (_decode_both(d, rows, comp_lens, out_lens) for d in ("v1", "pipeline"))
    for a, b in zip(v1, pipe):  # JAX rows, JAX flags, port rows, port flags
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(v1[3], v1[1])
    np.testing.assert_array_equal(v1[2], v1[0])


@pytest.mark.parametrize("fn,args", [
    (encode_blocks, (torch.zeros((2, BS), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))),
    (encode_blocks, (torch.zeros((2, BS), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32))),
    (TP.encode_pipeline, (torch.zeros((2, 100), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32))),
    (decode_blocks, (torch.zeros((2, BS), dtype=torch.uint8),) + (torch.zeros(2, dtype=torch.int32),) * 2),
    (TP.decode_pipeline, (torch.zeros((2, PAD_OUT), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32))),
])
def test_shapes_are_checked(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def test_per_block_entry_points():
    blocks, lens = _pad(BATCH3[:1])
    comp, total = TE.encode_block_device(torch.from_numpy(blocks[0]), int(lens[0]))
    _, jt, tc, tt = _encoded("v1")
    i = _row("batch3_0")
    assert int(total) == tt[i] == jt[i] and torch.equal(comp, torch.from_numpy(tc[i]))
    out, ok = TD.decode_block_device(comp, total, int(lens[0]))
    assert bool(ok) and torch.equal(out, torch.from_numpy(blocks[0]))


# ----------------------------------------------------------------- config ---


def test_profiles_and_codec_config_equal_jax():
    assert config.PROFILES == jax_config.PROFILES
    assert dataclasses.asdict(config.DEFAULT) == dataclasses.asdict(jax_config.DEFAULT)
    assert config.CodecConfig().validate() == config.DEFAULT
    for p in config.PROFILES:
        assert config.CodecConfig(profile=p).gram_tiers == jax_config.CodecConfig(profile=p).gram_tiers


@pytest.mark.parametrize("kw", [dict(block_size=8), dict(block_size=BS + 1), dict(profile="tiny"),
                                dict(backend="tpu")])
def test_codec_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_config.CodecConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        config.CodecConfig(**kw).validate()
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- mesh ---


@functools.cache
def _mesh_input():
    data = np.frombuffer(corpus.mixed(9 * BS + 1234, seed=3), np.uint8)
    return framing.pack_blocks(data)  # 10 blocks: padded to 16 over 8 shards


def _shard(mesh, arrays):
    """Host arrays cut into the mesh's equal shards, padded with zero-length
    blocks, as sharded lists."""
    B = arrays[0].shape[0]
    per = -(-B // len(mesh))
    out = []
    for a in arrays:
        p = np.zeros((per * len(mesh), *a.shape[1:]), a.dtype)
        p[:B] = a
        out.append([torch.from_numpy(p[j * per : (j + 1) * per]).to(d) for j, d in enumerate(mesh)])
    return out


@pytest.mark.parametrize("profile", ["fast", "dense"])
def test_sharded_encode_and_decode_on_a_cpu_mesh(profile):
    mesh = make_mesh(8, "cpu")
    blocks, lens = _mesh_input()
    B = blocks.shape[0]
    enc = sharded_encode(mesh, profile != "fast")
    assert enc is sharded_encode(mesh, profile != "fast")  # cached per (mesh, dense)
    comp_s, tot_s = enc(*_shard(mesh, (blocks, lens)))
    assert len(comp_s) == len(tot_s) == 8 and all(c.shape == (2, PAD_OUT) for c in comp_s)
    comp, totals = torch.cat(comp_s).numpy(), torch.cat(tot_s).numpy()
    comp_m, tot_m = encode_mesh(mesh, blocks, lens, profile)
    np.testing.assert_array_equal(comp[:B], comp_m)
    np.testing.assert_array_equal(totals[:B], tot_m)
    assert (totals[B:] == 0).all() and not comp[B:].any()
    if profile == "dense":  # the JAX sharded encoder on one device (one compile)
        jc, jt = jax_sharded_encode(jax_make_mesh(1), True)(jnp.asarray(blocks), jnp.asarray(lens))
        np.testing.assert_array_equal(comp[:B], np.asarray(jc))
        np.testing.assert_array_equal(totals[:B], np.asarray(jt))
    # decode the shards where they lie
    rows, comp_lens = framing.pad_chunks([comp[i, : totals[i]] for i in range(comp.shape[0])])
    dec = sharded_decode(mesh)
    out_s, ok_s = dec(*_shard(mesh, (rows, comp_lens, np.concatenate([lens, np.zeros(6, np.int32)]))))
    out, ok = torch.cat(out_s).numpy(), torch.cat(ok_s).numpy()
    out_m, ok_m = decode_mesh(mesh, rows[:B], comp_lens[:B], lens)
    assert ok.all() and ok_m.all()
    np.testing.assert_array_equal(out[:B], out_m)
    np.testing.assert_array_equal(out[:B], blocks)


def test_sharded_calls_are_bounded_and_refuse_misplaced_shards(monkeypatch):
    from snappytpu_torch.mesh import sharding

    calls = []

    def fake(b, n, dense=True):
        calls.append((int(n[0]), b.shape[0]))
        return torch.zeros((b.shape[0], PAD_OUT), dtype=torch.uint8), -n

    monkeypatch.setattr(sharding, "encode_blocks", fake)
    mesh = make_mesh(2, "cpu")
    lens = torch.arange(300, dtype=torch.int32)
    blocks = torch.zeros((300, 8), dtype=torch.uint8)
    comp, totals = sharded_encode(mesh)([blocks[:150], blocks[150:]], [lens[:150], lens[150:]])
    assert calls == [(0, 128), (128, 22), (150, 128), (278, 22)]
    assert torch.equal(torch.cat(totals), -lens)  # poisoned totals are the caller's to check
    with pytest.raises(ValueError, match="one tensor per mesh device"):
        sharded_encode(mesh)([blocks], [lens])
    with pytest.raises(ValueError, match="not on its mesh device"):
        sharded_encode(mesh)([blocks[:150].to("meta"), blocks[150:]], [lens[:150], lens[150:]])
    assert AXIS == "blocks"


def test_host_shards_are_staged_on_their_devices(monkeypatch):
    """Shards in host memory, as encode_mesh hands them over, are copied to
    their mesh device before their calls."""
    from snappytpu_torch.mesh import sharding

    seen = []

    def fake(b, n, dense=True):
        seen.append((b.device.type, n.device.type, b.shape[0]))
        return torch.zeros((b.shape[0], PAD_OUT), dtype=torch.uint8, device=b.device), n

    monkeypatch.setattr(sharding, "encode_blocks", fake)
    mesh = [torch.device("meta")] * 2
    blocks, lens = torch.zeros((5, 8), dtype=torch.uint8), torch.arange(5, dtype=torch.int32)
    comp, totals = sharded_encode(mesh)([blocks[:3], blocks[3:]], [lens[:3], lens[3:].to("meta")])
    assert seen == [("meta", "meta", 3), ("meta", "meta", 2)]
    assert [c.device.type for c in comp + totals] == ["meta"] * 4


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_empty_shards_give_empty_outputs(kind):
    """An empty shard, or an empty batch, gives empty outputs of the right
    shapes and dtypes without a call; the other shards are run as usual."""
    mesh = make_mesh(3, "cpu")
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    if kind == "encode":
        blocks, lens = _mesh_input()
        comp, totals = sharded_encode(mesh)([torch.from_numpy(blocks[:0]), torch.from_numpy(blocks[:1]),
                                             torch.from_numpy(blocks[:0])],
                                            [i32(), torch.from_numpy(lens[:1]), i32()])
        assert [tuple(c.shape) for c in comp] == [(0, PAD_OUT), (1, PAD_OUT), (0, PAD_OUT)]
        assert [tuple(t.shape) for t in totals] == [(0,), (1,), (0,)]
        assert comp[0].dtype == torch.uint8 and totals[2].dtype == torch.int32
        np.testing.assert_array_equal(comp[1].numpy(), encode_mesh(make_mesh(1, "cpu"), blocks[:1], lens[:1])[0])
        got = encode_mesh(mesh, np.zeros((0, BS), np.uint8), np.zeros(0, np.int32))
        want = ((0, PAD_OUT), np.uint8), ((0,), np.int32)
    else:
        out, ok = sharded_decode(mesh)([torch.zeros((0, PAD_OUT), dtype=torch.uint8)] * 3, [i32()] * 3, [i32()] * 3)
        assert [tuple(o.shape) for o in out] == [(0, BS)] * 3 and all(k.dtype == torch.bool for k in ok)
        got = decode_mesh(mesh, np.zeros((0, PAD_OUT), np.uint8), np.zeros(0, np.int32), np.zeros(0, np.int32))
        want = ((0, BS), np.uint8), ((0,), np.bool_)
    assert [(a.shape, a.dtype) for a in got] == list(want)
