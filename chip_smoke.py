#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (snappytpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each against its plain PyTorch version on the card, and
drives the port's paths at full size, each with its kernels' launch counts
set to 0 just before it and read just after:

  1-2   environment, build
  3     K1 (concat, output tiles) against its plain version on six length
        sets, edges and rows outside the contract among them; K1 and a copy_
        moving as many bytes (the card's copy floor) timed by CUDA graph
        replay on cold inputs
  4     K2 (the pipelined block decoder) against its plain version
  5     the main path: a 32 MB mixed corpus (512 blocks of 64 KiB) encoded on
        the card with both profiles in batches of 128 blocks (torch ops + K1),
        decoded on the card by K2, compared block by block on the device;
        then K1 on the sections and lengths the encoder handed it in the
        first batch of each profile, checked and timed as in phase 3
  6     the user API with device="cuda"
  7     K3 (the op-by-op block decoder) against its plain version; its path is
        the A/B twin of phase 5's decode (the fast batches through K3); then
        K2 and K3 timed in turns (K2, K3, K3, K2) on phase 5's batches of
        both profiles
  8     K5 (the tape decoder on K2's grouped mover) and K6 (the record-by-
        record walk) against their plain versions on a 128-block host batch
        (own, native-compressor, mutated, tape-overflow and pad blocks) and
        on 128 tapes of random records whose batches are not forward; the
        tape route with its K2 fallback against K2; K5 and K6 timed in turns
        (K5, K6, K6, K5) on the check batch
  9     K4 (K4a, the parallel parse, then K4b, the serial mover) against its
        plain version on three calls of 64 chunks: the first, the second
        seeded (ctx0) with the first call's last 64 KiB of output, and the
        first with mutated chunks (flags and every row); K4a, K4b and the
        whole call timed
  10    the host-resident path: the 32 MB corpus through compress_file and
        decompress_file (the tape route, K5) on the card, the CLI once each
        way, both host routes (tape, K2) timed part by part, K5 and K6 timed
        in turns on the stream's host rows, and K6's path, the A/B twin of
        the tape route
  11    the windowed path: an unaligned 8 MB stream through api.decompress
        (two or more K4 calls of 64 chunks, and no chunk refused to the
        host decoder)
  12    the decode profiling path (snappytpu_torch.tools) at the JAX tools'
        sizes: T2 (decode anatomy), T3 (tape probe) and T1 (scalar probes)
        against their plain versions, then dec_profile's four decoders,
        T2's variants and T3's modes on four 128-block sets of text and
        mixed, and T1's 16 probes at N = 200,000, timed
  14    the port's benchmark: the runner (snappytpu_torch.bench.run) in
        process on the 32 MB mixed corpus (3 reps, fast headline, dense
        companion), its ratios held to phase 5's; then
        `python -m snappytpu_torch.bench.run` once as a subprocess (1 rep),
        its last stdout line parsed and its keys checked
  15    the mesh path: make_mesh(1) on cuda:0; the config-4 check (100 MB of
        text through encode_mesh/decode_mesh, dense, equal to api.compress on
        the card and round-tripped); the same encode under an NCCL process
        group of world size 1 made by init_distributed (the same rows);
        make_mesh past the card count raises; two manifest shards with the
        default encoder on the card, assembled, equal to api.compress;
        entry()'s function on the card equal to its CPU result;
        dryrun_multichip(1); the mesh sweep at two sizes; then, outside
        the path's counts, config 4's encode and decode taken apart into
        copies in, device calls and copies out (CUDA events)
  13    report (run last)

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON line with each kernel's launches on its path (and on every
path that launched it), error against its plain version, times and bound:
the bytes its timed call must move (each input byte read once, each output
byte written once) over the card's 3.35 TB/s; the last line is
{"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero; it refuses to run without
CUDA.  Needs no JAX.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
BATCH = 128
MAIN_MB = 32
WIN_MB = 8  # the windowed path's stream: 128+ chunks, so two K4 calls of 64
# a kernel's measurements beyond the contract's keys: K4's two launches; K1's
# time by events around wrapper calls, the copy floor and its main-path times
K_EXTRAS = ("parse_ms", "move_ms", "events_ms", "copy_floor_ms", "main_path_ms", "main_path_bound_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream, by CUDA events
    around `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, copies: int, reps: int = 20) -> float:
    """Device milliseconds per call of fn(i): the calls i = 0 .. copies - 1
    captured in turn into one CUDA graph, so no host time lies between the
    launches, replayed once to warm up and then `reps` times between CUDA
    events.  fn(i) works on the i-th copy of its inputs, and what it returns
    is kept through the replays, so each call also writes its own output;
    copies that together exceed the 50 MB L2 find each call's inputs and
    outputs out of the cache."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(copies):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(i) for i in range(copies)]
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del outs  # held until the replays are done
    return start.elapsed_time(end) / (reps * copies)


def k1_bytes(lens: torch.Tensor, cap: int, out_cap: int) -> int:
    """K1's bytes: the sections' clamped lengths read, the lengths, the rows
    written."""
    return int(lens.to(torch.int64).clamp(0, cap).sum()) + 4 * lens.numel() + lens.shape[0] * out_cap


def k1_sets(rng, present: np.ndarray, cap: int, out_cap: int) -> dict:
    """Phase 3's (128, 64) length sets: the present random set, then edges:
    every section 1 byte long (16 sections in a window); lengths 16k - 1,
    16k, 16k + 1; sections that end within 15 bytes of a multiple of 512 (a
    warp's stores; every 2 KiB tile edge is one), so that they straddle warp
    and tile edges; rows that sum to out_cap exactly; and rows outside the
    contract (negative lengths, above cap, the int32 extremes, sums past
    out_cap), which the kernel clamps as the plain version does."""
    B, S = present.shape
    ar_s, ar_b = np.arange(S)[None, :], np.arange(B)[:, None]
    edges = 16 * (1 + (ar_s * 5 + ar_b * 3) % (out_cap // S // 16 - 1)) + (ar_s + ar_b) % 3 - 1
    straddle = np.zeros((B, S), np.int64)
    for b in range(B):
        cur = 0
        for s in range(S):
            edge = (cur // 512 + 1) * 512
            j = int(rng.integers(1, 16)) * (1 if rng.random() < 0.5 else -1)
            end = edge + j if edge + j > cur else edge + 512 + j
            if end > out_cap:
                break
            straddle[b, s] = min(end - cur, cap)
            cur += straddle[b, s]
    exact = np.full((B, S), out_cap // S, np.int64)
    for b in range(1, B):  # row 0 an even split, the others bytes moved between random pairs
        for _ in range(4 * S):
            i, k = rng.integers(0, S, 2)
            x = int(rng.integers(0, min(exact[b, i], cap - exact[b, k]) + 1)) if i != k else 0
            exact[b, i] -= x
            exact[b, k] += x
    broken = rng.integers(-2 * cap, 2 * cap, (B, S))
    broken[0, :2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    broken[1::3] = cap
    broken[2::3] = rng.integers(out_cap // S, 2 * cap, (len(broken[2::3]), S))
    sets = {"present": present, "one": np.ones((B, S)), "edges": edges, "straddle": straddle, "exact": exact,
            "broken": broken}
    sets = {k: np.asarray(v).astype(np.int32) for k, v in sets.items()}
    assert (sets["exact"].sum(1) == out_cap).all() and (sets["straddle"] > 0).any()
    return sets


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn by the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move nbytes through its memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def block_bytes(comp_lens, n: int) -> int:
    """A block decoder's bytes: the compressed bytes its ops can read (each
    row up to comp_len), the two length vectors, the rows and flags out."""
    from snappytpu_torch.format import constants as C

    cl = np.clip(np.asarray(comp_lens, np.int64), 0, C.MAX_COMPRESSED_BLOCK_SIZE)
    return int(cl.sum()) + 8 * n + n * C.MAX_BLOCK_SIZE + n


def _counters():
    """Every kernel's launch count: name -> (module, attribute)."""
    from snappytpu_torch.kernels import concat, decode_tape, decode_vm2, decode_vm4
    from snappytpu_torch.tools import dec_anatomy, probe_scalar, tape_probe

    return {
        "concat": (concat, "launches"),
        "decode_block": (decode_vm4, "launches"),
        "decode_block_vm2": (decode_vm2, "launches"),
        "decode_stream": (decode_vm2, "stream_launches"),
        "decode_tape": (decode_tape, "launches"),
        "decode_tape_k": (decode_tape, "k_launches"),
        "dec_anatomy": (dec_anatomy, "launches"),
        "tape_probe": (tape_probe, "launches"),
        "probe_scalar": (probe_scalar, "launches"),
    }


def zero_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def golden_streams():
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "*.snappy"))):
        with open(path, "rb") as f:
            comp = f.read()
        with open(path[: -len(".snappy")] + ".raw", "rb") as f:
            raw = f.read()
        out.append((os.path.basename(path), comp, raw))
    if not out:
        raise RuntimeError("no golden streams under tests/golden")
    return out


def host_rows(stream: bytes):
    """A block-splittable stream -> its (rows, comp_lens, out_lens) on the
    host, by the native scan and split, as the API's block route cuts it."""
    from snappytpu_torch import cpu
    from snappytpu_torch.format import constants as C
    from snappytpu_torch.stream import framing

    arr = np.frombuffer(stream, np.uint8)
    n, start = framing.read_preamble(arr)
    offs, lens = cpu.scan_ops(arr[start:], n)
    rows, comp_lens = cpu.split_rows(arr[start:], offs, C.MAX_COMPRESSED_BLOCK_SIZE)
    return rows, comp_lens, lens.astype(np.int32)


def tape_check_batch(rng, base, base_cl, base_ol):
    """128 host rows for K5: phase 4's own and golden streams, the native
    compressor's streams, one all-1-byte-literal block (tape overflow, -9),
    one pad block, and mutated copies (the first one a byte short, -10)."""
    from snappytpu_torch import cpu
    from snappytpu_torch.bench import corpus
    from snappytpu_torch.format import constants as C

    rows, cls, ols = [base], list(base_cl), list(base_ol)
    nrows, ncl, nol = host_rows(cpu.compress(corpus.mixed(16 * C.MAX_BLOCK_SIZE + 777, seed=19)))
    rows.append(nrows)
    cls += ncl.tolist()
    ols += nol.tolist()
    lit = corpus.mixed(24_000, seed=33)
    over = np.zeros((2, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)  # the -9 block and a pad block
    over[0, : 2 * len(lit)] = np.frombuffer(bytes(b for x in lit for b in (0x00, x)), np.uint8)
    rows.append(over)
    cls += [2 * len(lit), 0]
    ols += [len(lit), 0]
    good = np.concatenate(rows)
    src = rng.integers(0, good.shape[0] - 2, BATCH - good.shape[0])
    mutated = good[src].copy()
    for i, j in enumerate(src):
        for _ in range(1 + i % 4):
            mutated[i, int(rng.integers(0, max(cls[j], 1)))] ^= int(rng.integers(1, 256))
    mcl = [cls[j] for j in src]
    mcl[0] -= 1
    valid = np.array([True] * good.shape[0] + [False] * len(src))
    return (np.concatenate([good, mutated]), np.array(cls + mcl, np.int32),
            np.array(ols + [ols[j] for j in src], np.int32), valid)


def random_tapes(rng, B: int, S: int):
    """B tapes of S random records (the host tests' fuzz): dsts anywhere,
    sources after their dsts, overlapping copies and records that leave the
    image among them, so that K5's batches are not forward; nrecs in
    [-10, S + 2]."""
    from snappytpu_torch.kernels import decode_tape

    img = decode_tape.IMAGE_BYTES
    src = rng.integers(0, 1 << 18, (B, S))
    src = np.where(rng.random((B, S)) < 0.9, src % img, src)
    dst = np.where(rng.random((B, S)) < 0.95, rng.integers(0, img, (B, S)), rng.integers(-600, img + 600, (B, S)))
    ln = np.where(rng.random((B, S)) < 0.95, rng.integers(0, decode_tape.PIECE_MAX + 1, (B, S)),
                  rng.integers(0, 4096, (B, S)))
    pk2 = rng.integers(0, 4, (B, S))
    tapes = np.stack([(src | pk2 << 18 | ln << 20).astype(np.uint32).view(np.int32), dst.astype(np.int32)], -1)
    return tapes.reshape(B, 2 * S), rng.integers(-10, S + 3, B).astype(np.int32)


def tape_turns(batches, reps: int) -> dict:
    """K5 and K6 (K=4) timed in turns K5, K6, K6, K5 over the staged tape
    batches -> {"K5": [ms, ms], "K6": [ms, ms]}, ms per batch."""
    from snappytpu_torch.kernels import decode_tape

    fns = {"K5": decode_tape._run_tape, "K6": lambda *a: decode_tape._run_tape_k(*a, K=4)}
    turns = {"K5": [], "K6": []}
    for who in ("K5", "K6", "K6", "K5"):
        fn = fns[who]
        turns[who].append(event_ms(lambda: [fn(*b) for b in batches], reps) / len(batches))
    return turns


def host_routes(stream: bytes, raw: bytes, dev) -> dict:
    """Decode a host-resident stream's blocks by the tape route and by the
    block-decoder route, 128 blocks at a time, timing each part on the host
    clock with the card synchronised; both outputs must equal `raw`.  Each
    route makes two whole passes, in the order tape, K2, K2, tape; the
    second pass of each is reported, so neither route pays the other's
    first-touch host allocations."""
    from snappytpu_torch import cpu
    from snappytpu_torch.kernels import decode_tape, decode_vm4

    rows, cls, ols = host_rows(stream)
    batches = [(rows[b0 : b0 + BATCH], cls[b0 : b0 + BATCH], ols[b0 : b0 + BATCH])
               for b0 in range(0, rows.shape[0], BATCH)]

    def timed(parts, part, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        parts[part] = parts.get(part, 0.0) + time.perf_counter() - t0
        return r

    def tape_pass(parts):
        pieces = []
        for r, c, o in batches:
            tapes, nrecs = timed(parts, "tape build", lambda: decode_tape.build_tapes(r, c, o))
            if (nrecs < 0).any():
                raise AssertionError(f"tape build refused blocks of a valid stream: {sorted(set(nrecs.tolist()))[:4]}")
            staged = timed(parts, "host->device", lambda: decode_tape.stage(r, tapes, nrecs, device=dev))
            out, ok = timed(parts, "K5", lambda: decode_tape._run_tape(*staged))
            pieces.append(timed(parts, "device->host+compact", lambda: cpu.compact(out.cpu().numpy(), o)))
            if not bool(ok.all()):
                raise AssertionError("K5 rejected a block of a valid stream")
        return pieces

    def k2_pass(parts):
        pieces = []
        for r, c, o in batches:
            dev_args = timed(parts, "host->device", lambda: tuple(torch.from_numpy(a).to(dev) for a in (r, c, o)))
            out, ok = timed(parts, "K2", lambda: decode_vm4.decode_blocks_vm4(*dev_args))
            pieces.append(timed(parts, "device->host+compact", lambda: cpu.compact(out.cpu().numpy(), o)))
            if not bool(ok.all()):
                raise AssertionError("K2 rejected a block of a valid stream")
        return pieces

    passes = {"tape": tape_pass, "K2": k2_pass}
    reported = {}
    for route in ("tape", "K2", "K2", "tape"):
        parts = {}
        if b"".join(passes[route](parts)) != raw:
            raise AssertionError(f"the {route} route did not give back the input")
        reported[route] = parts
    return reported


def run_tape_k_path(stream: bytes, raw: bytes, dev) -> None:
    """The host-resident stream's tapes through K6 with K=4, batches padded
    to a multiple of 4 with zero-length blocks; the output must equal `raw`."""
    from snappytpu_torch import cpu
    from snappytpu_torch.kernels import decode_tape

    rows, cls, ols = host_rows(stream)
    pieces = []
    for b0 in range(0, rows.shape[0], BATCH):
        r, c, o = rows[b0 : b0 + BATCH], cls[b0 : b0 + BATCH], ols[b0 : b0 + BATCH]
        pad = -r.shape[0] % 4
        r, c, o = (np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) for a in (r, c, o))
        tapes, nrecs = decode_tape.build_tapes(r, c, o)
        out, ok = decode_tape._run_tape_k(*decode_tape.stage(r, tapes, nrecs, device=dev), K=4)
        if not bool(ok.all()):
            raise AssertionError("K6 rejected a block of a valid stream")
        pieces.append(cpu.compact(out.cpu().numpy(), o))
    if b"".join(pieces) != raw:
        raise AssertionError("K6 did not decode the stream to the input")


def profiling_path(dev) -> tuple[dict, dict]:
    """Phase 12: the decode profiling path at the JAX tools' sizes (128-block
    sets, four per corpus, dense profile, text and mixed).  First each of
    T1-T3 is held against its plain version, exactly; then, with the launch
    counts at 0, the path runs: dec_profile's four decoders, T2's variants
    and T3's modes on all sets, T1's 16 probes at N = 200,000.  Returns
    (kernels entries, launch counts of the path)."""
    from snappytpu_torch.format.constants import MAX_BLOCK_SIZE as BS
    from snappytpu_torch.kernels import decode_tape, decode_vm4
    from snappytpu_torch.tools import _staged, dec_anatomy, dec_profile, probe_scalar, tape_probe

    corpora = ("text", "mixed")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cache:
        staged = {w: _staged.stage_sets(w, BATCH, 4, dev, cache_dir=cache) for w in corpora}
        taped = {w: _staged.stage_sets(w, BATCH, 4, dev, tape=True, cache_dir=cache) for w in corpora}
    torch.cuda.synchronize()
    log(f"[12 profiling] staged 4 sets of {BATCH} dense blocks per corpus, as rows and as tapes, "
        f"in {time.perf_counter() - t0:.1f} s")

    def max_err(got, want) -> int:
        torch.cuda.synchronize()
        return max(int((g.cpu().to(torch.int64) - r.to(torch.int64)).abs().max()) for g, r in zip(got, want))

    # checks: T2's variants and T3's modes on set 0, T1's probes once each
    t2_err = t3_err = t1_err = 0
    t2_plain = t3_plain = t1_plain = 0.0
    for w in corpora:
        c, t, n = staged[w][0]
        t0 = time.perf_counter()
        ref = dec_anatomy.walk_ref(c.cpu(), t.cpu(), n.cpu())
        t2_plain = max(t2_plain, (time.perf_counter() - t0) * 1e3)
        for v in dec_anatomy.VARIANTS:
            got = dec_anatomy.anatomy(v, c, t, n)
            err = max_err(got, ref[v])
            if err != 0:
                raise AssertionError(f"T2 {v} on {w} differs from its plain walk (max abs err {err})")
            t2_err = max(t2_err, err)
        k2_img, k2_ok = decode_vm4.decode_blocks_ref(c, t, n)
        got = dec_anatomy.anatomy("full", c, t, n)
        if max_err(got[:2], (k2_img.cpu(), k2_ok.cpu())) != 0 or not bool(k2_ok.all()):
            raise AssertionError(f"T2 full on {w} differs from K2's plain version")
        args = taped[w][0]
        cpu_args = tuple(a.cpu() for a in args)
        t0 = time.perf_counter()
        exact = decode_tape.run_tape_ref(*cpu_args)
        t3_plain = max(t3_plain, (time.perf_counter() - t0) * 1e3)
        zero_aux = torch.zeros((BATCH, tape_probe.AUX), dtype=torch.int32)
        for mode in tape_probe.MODES:
            ref = (*exact, zero_aux) if mode in tape_probe.EXACT else tape_probe.probe_ref(mode, *cpu_args)
            err = max_err(tape_probe.probe(mode, *args), ref)
            if err != 0:
                raise AssertionError(f"T3 {mode} on {w} differs from its plain version (max abs err {err})")
            t3_err = max(t3_err, err)
        log(f"[12 check] {w} set 0: T2's four variants equal the plain walk (images, flags, cursors, folds) and "
            f"full equals K2's plain version; T3's {len(tape_probe.MODES)} modes equal their plain versions "
            f"(the exact modes K5's plain walk)")
    hazard = tuple(torch.from_numpy(a).to(dev) for a in tape_probe.hazard_batch())
    want = decode_tape.run_tape_ref(*(a.cpu() for a in hazard))
    for mode in tape_probe.EXACT:
        err = max_err(tape_probe.probe(mode, *hazard)[:2], want)
        if err != 0:
            raise AssertionError(f"T3 {mode} differs from K5's plain walk on the hand tape of in-step hazards")
    log("[12 check] T3's exact modes equal K5's plain walk on the hand tape whose records read and rewrite "
        "each other's bytes within a step")
    for p in probe_scalar.SMOKE:
        inp = probe_scalar.inputs(p)
        tile, _clk = probe_scalar.run(p, torch.from_numpy(inp).to(dev), probe_scalar.N)
        t0 = time.perf_counter()
        want = torch.from_numpy(probe_scalar.plain(p, inp, probe_scalar.N))
        t1_plain += (time.perf_counter() - t0) * 1e3
        err = max_err([tile], [want])
        if err != 0:
            raise AssertionError(f"T1 {p.name} differs from its plain chain (max abs err {err})")
        t1_err = max(t1_err, err)
    log(f"[12 check] T1's {len(probe_scalar.SMOKE)} probes at N = {probe_scalar.N}: every tile equals its plain "
        f"chain ({t1_plain / 1e3:.1f} s of plain chains)")

    # the path, with the counts at 0
    zero_counts()
    mbs = BATCH * (1 << 16) / 1e6
    for vm in ("dispatch", "2", "4", "tape"):
        cells = []
        for w in corpora:
            sec = dec_profile.profile(vm, taped[w] if vm == "tape" else staged[w])
            cells.append(f"{w} {sec * 1e3:.4f} ms/batch {mbs / sec:.1f} MB/s")
        log(f"[12 dec_profile] vm={vm}: " + "; ".join(cells))
    t2_ms, t3_ms = {}, {}
    for w in corpora:
        t2_ms[w] = ms = {v: dec_anatomy.anatomy_ms(v, staged[w]) for v in dec_anatomy.VARIANTS}
        log(f"[12 T2] {w} ms/batch: " + ", ".join(f"{v} {m:.4f}" for v, m in ms.items()) + "; attribution: "
            + ", ".join(f"{k} {m:.4f}" for k, m in dec_anatomy.attribution(ms).items()))
    for w in corpora:
        t3_ms[w] = ms = {m: tape_probe.probe_ms(m, taped[w]) for m in tape_probe.MODES}
        log(f"[12 T3] {w} ms/batch: " + ", ".join(f"{m} {v:.4f}" for m, v in ms.items()))
    t1_ms = 0.0
    for p in probe_scalar.SMOKE:
        m = probe_scalar.measure(p, dev, probe_scalar.N)
        t1_ms += m["event_ns_per_step"] * p.steps(probe_scalar.N) / 1e6
        log(f"[12 T1] {p.name:22s} {m['ns_per_step']:8.3f} ns/step by the chain's clock "
            f"({m['cycles_per_step']:.2f} cycles), {m['event_ns_per_step']:8.3f} ns/step by events")
    launches = read_counts()
    log(f"[12 profiling] kernel launches on the path: {launches}")
    # bounds: bytes in and out of one timed call (a 128-block text set for
    # T2 and T3, the 16 probes' tiles for T1); a probe is timed for its
    # dependent chain, not its bandwidth, so its bound only says how far
    # from moving bytes the chain is
    text = list(zip(staged["text"], taped["text"]))
    t2_bytes = np.mean([int(t.sum()) for (_c, t, _n), _tp in text]) + BATCH * (8 + BS + 1 + 4 + 4)
    t3_bytes = np.mean([int(t.sum()) + 8 * int(nr.clamp(min=0).sum()) for (_c, t, _n), (_tp, nr, _cp) in text]) \
        + BATCH * (4 + BS + 1 + 4 * tape_probe.AUX)
    t1_bytes = sum(probe_scalar.inputs(p).nbytes + 8 * 128 * 4 + 16 for p in probe_scalar.SMOKE)  # tiles, clocks
    kernels = {
        "dec_anatomy": dict(err=t2_err, ms=t2_ms["text"]["full"], plain_ms=t2_plain, bound_ms=bound_ms(t2_bytes)),
        "tape_probe": dict(err=t3_err, ms=t3_ms["text"]["full-D1"], plain_ms=t3_plain, bound_ms=bound_ms(t3_bytes)),
        "probe_scalar": dict(err=t1_err, ms=t1_ms, plain_ms=t1_plain, bound_ms=bound_ms(t1_bytes)),
    }
    return kernels, launches


def bench_path(dev, kind: str, results: dict) -> dict:
    """Phase 14: the runner's measuring function in process (32 MB mixed,
    3 reps, fast headline, dense companion) with the launch counts at 0,
    its ratios held to phase 5's; then the runner once as a subprocess.
    Returns the launch counts of the path."""
    from snappytpu_torch.bench import run as bench_run

    zero_counts()
    bench = bench_run.measure("mixed", MAIN_MB, 3, dense=False, device=dev)
    launches = read_counts()
    log(f"[14 bench] {json.dumps(bench)}")
    log(f"[14 bench] kernel launches on the path: {launches}")
    if min(launches["concat"], launches["decode_block"]) <= 0:
        raise AssertionError(f"a kernel of the bench path never launched: {launches}")
    want = (round(results["fast"]["ratio"], 4), round(results["dense"]["ratio"], 4))
    if (bench["ratio"], bench["companion_ratio"]) != want:
        raise AssertionError(f"the runner's ratios {bench['ratio']}, {bench['companion_ratio']} differ from "
                             f"phase 5's {want}")
    if (bench["backend"], bench["device_name"]) != ("cuda", kind):
        raise AssertionError(f"the runner ran on {bench['backend']} {bench['device_name']}")
    f, d = results["fast"], results["dense"]
    log(f"[14 bench] runner (best of 3): encode {bench['encode_gbps'] * 1e3:.1f} MB/s fast, "
        f"{bench['companion_encode_gbps'] * 1e3:.1f} dense, decode {bench['decode_gbps'] * 1e3:.1f} MB/s, combined "
        f"{bench['value'] * 1e3:.1f} MB/s; phase 5 (one pass): encode {f['encode_MBps']:.1f} fast, "
        f"{d['encode_MBps']:.1f} dense, decode {f['decode_MBps']:.1f}, combined {f['combined_MBps']:.1f}; "
        f"ratios equal to phase 5's ({want[0]}, {want[1]})")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SNAPPYTPU_BENCH_")}
    env["SNAPPYTPU_BENCH_REPS"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.run(["timeout", "-k", "10", "300", sys.executable, "-m", "snappytpu_torch.bench.run"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=330)
    if proc.returncode != 0:
        raise AssertionError(f"python -m snappytpu_torch.bench.run exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if tuple(line) != bench_run.KEYS or (line["backend"], line["device_name"]) != ("cuda", kind) \
            or (line["ratio"], line["companion_ratio"]) != want:
        raise AssertionError(f"the runner's line is not as expected: {line}")
    log(f"[14 bench] python -m snappytpu_torch.bench.run (1 rep, {time.perf_counter() - t0:.1f} s): its last line "
        f"has the {len(line)} keys, backend cuda, the card's name and phase 5's ratios: {json.dumps(line)}")
    return launches


def mesh_split(dev, mesh, blocks, lens, comp, totals, e_wall: float) -> None:
    """Phase 15's config-4 calls taken apart, after the path's launch counts
    are read (so these launches count on no path): for encode_mesh and
    decode_mesh, the copies in, the device calls and the copies out of their
    13 calls, each timed by CUDA events around all of its kind, beside the
    wall time of the whole mesh call (e_wall ms for the encode, from the
    config-4 check); the rest is host work (padding, numpy slicing).  The
    outputs are held to the mesh's."""
    from snappytpu_torch import api
    from snappytpu_torch.kernels.decode_vm import decode_blocks_vm
    from snappytpu_torch.kernels.encode_v2 import encode_blocks_v2
    from snappytpu_torch.mesh import sharding

    def parts(fn, arrays):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        staged = [[torch.from_numpy(a[s : s + api.DEVICE_BATCH]).to(dev) for a in arrays]
                  for s in range(0, arrays[0].shape[0], api.DEVICE_BATCH)]
        ev[1].record()
        outs = [fn(*args) for args in staged]
        ev[2].record()
        host = [[o.cpu().numpy() for o in out] for out in outs]
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], [np.concatenate(x) for x in zip(*host)]

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    (e_in, e_calls, e_out), (c, t) = parts(lambda b, n: encode_blocks_v2(b, n, dense=True), (blocks, lens))
    if not (np.array_equal(c, comp) and np.array_equal(t, totals)):
        raise AssertionError("the timed encode calls differ from encode_mesh's rows")
    log(f"[15 split] encode_mesh of config 4: wall {e_wall:.1f} ms = copies in {e_in:.1f} + encoder calls "
        f"{e_calls:.1f} + copies out {e_out:.1f} + host rest {e_wall - e_in - e_calls - e_out:.1f} ms (CUDA events; "
        f"the calls' wall taken from the config-4 check)")
    for turn in range(2):
        d_wall = wall(lambda: sharding.decode_mesh(mesh, comp, totals, lens))
        (d_in, d_calls, d_out), (out, ok) = parts(decode_blocks_vm, (comp, totals, lens))
        if not (ok.all() and np.array_equal(out, blocks)):
            raise AssertionError("the timed decode calls do not give the input back")
        log(f"[15 split] decode_mesh of config 4, turn {turn}: wall {d_wall:.1f} ms; its parts apart: copies in "
            f"{d_in:.1f} + K2 calls {d_calls:.1f} + copies out {d_out:.1f} = {d_in + d_calls + d_out:.1f} ms, "
            f"host rest {d_wall - d_in - d_calls - d_out:.1f} ms")


def mesh_path(dev) -> dict:
    """Phase 15: the block-parallel path on the card with the launch counts
    at 0 (see the module docstring).  Returns the launch counts."""
    import socket

    import torch.distributed as dist

    from snappytpu_torch import api, entry
    from snappytpu_torch.bench import corpus, sweep
    from snappytpu_torch.mesh import sharding
    from snappytpu_torch.stream import manifest
    from snappytpu_torch.tools import config4_mesh

    zero_counts()
    mesh = sharding.make_mesh(1)
    if mesh != [dev]:
        raise AssertionError(f"make_mesh(1) gave {mesh}")
    c4 = config4_mesh.check(100, 1, device="cuda", log=log)
    blocks, lens = c4["input"]
    comp, totals = c4["rows"]

    # the same encode under an NCCL process group of world size 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist_env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1")
    saved = {k: os.environ.get(k) for k in dist_env}
    os.environ.update(dist_env)
    try:
        if sharding.init_distributed("cuda") != (0, 1) or dist.get_backend() != "nccl":
            raise AssertionError("init_distributed did not make an NCCL group of world size 1")
        nccl_s = []  # the first call also makes the NCCL communicator
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comp_d, totals_d = sharding.encode_mesh(mesh, blocks, lens, profile="dense")
            nccl_s.append(time.perf_counter() - t0)
            if not (np.array_equal(comp_d, comp) and np.array_equal(totals_d, totals)):
                raise AssertionError("encode_mesh under NCCL (world size 1) differs from the plain mesh")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"[15 mesh] encode_mesh under an NCCL group of world size 1 (all_gather of the rows): the same "
        f"{len(totals)} rows and totals, twice ({nccl_s[0] * 1e3:.1f} ms, the NCCL communicator made on the "
        f"first all_gather; then {nccl_s[1] * 1e3:.1f} ms; the plain mesh {c4['encode_s'] * 1e3:.1f} ms)")
    n_bad = torch.cuda.device_count() + 1
    try:
        sharding.make_mesh(n_bad)
    except RuntimeError as e:
        log(f"[15 mesh] make_mesh({n_bad}) raises: {e}")
    else:
        raise AssertionError(f"make_mesh({n_bad}) did not raise")

    data = corpus.mixed(4 * (1 << 20) + 777, seed=77)
    with tempfile.TemporaryDirectory() as tmp:
        for s in range(2):
            manifest.encode_shard(np.frombuffer(data, np.uint8), tmp, s, 2, device=dev)
        manifest.assemble(tmp, 2, os.path.join(tmp, "full.snappy"))
        with open(os.path.join(tmp, "full.snappy"), "rb") as f:
            if f.read() != api.compress(data, "dense", device=dev):
                raise AssertionError("the manifest-assembled stream differs from api.compress")
    log(f"[15 mesh] two manifest shards of {len(data)} bytes, default encoder on the card, assembled: equal to "
        f"api.compress")

    fn, args = entry.entry()
    if any(a.device != dev for a in args):
        raise AssertionError(f"entry() put its arguments on {[a.device for a in args]}")
    got = [t.cpu() for t in fn(*args)]
    cfn, cargs = entry.entry("cpu")
    want = cfn(*cargs)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("entry()'s function on the card differs from its CPU result")
    log(f"[15 mesh] entry(): encode of its two example blocks on the card equals the CPU result "
        f"(totals {got[1].tolist()})")
    entry.dryrun_multichip(1)

    with tempfile.TemporaryDirectory() as tmp:
        rows = sweep.run_sweep(tmp, sizes=[100_000, 1_000_000], reps=2, mesh=True, device="cuda")
        names = sorted(os.listdir(tmp))
    for r in rows:
        log(f"[15 sweep] mesh1 dense {r.phase} {r.input_size} -> {r.output_size} B: {r.time_taken * 1e3:.3f} ms, "
            f"{r.speed_mbps:.1f} MB/s")
    log(f"[15 sweep] wrote {names}")
    launches = read_counts()
    log(f"[15 mesh] kernel launches on the path: {launches}")
    if min(launches["concat"], launches["decode_block"]) <= 0:
        raise AssertionError(f"a kernel of the mesh path never launched: {launches}")
    mesh_split(dev, mesh, blocks, lens, comp, totals, c4["encode_s"] * 1e3)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from snappytpu_torch import _build, api, cli, cpu
    from snappytpu_torch.bench import corpus
    from snappytpu_torch.format import constants as C
    from snappytpu_torch.format.varint import encode_varint
    from snappytpu_torch.kernels import concat, decode_tape, decode_vm2, decode_vm4, encode_v2
    from snappytpu_torch.kernels.decode_vm import decode_blocks_vm
    from snappytpu_torch.kernels.encode_v2 import encode_blocks_v2
    from snappytpu_torch.stream import filecodec, framing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    BS, PAD_OUT = C.MAX_BLOCK_SIZE, C.MAX_COMPRESSED_BLOCK_SIZE

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    log(f"[1 env] nvidia-smi: {smi}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    log(f"[2 build] kernels built and loaded in {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "smem" in line:
            log(f"[2 build] {line.strip()}")
    log("[2 build] K2 is decode_blocks_kernel (parse -> move pipeline), K3 decode_blocks_vm2_kernel (op by op), "
        "both in decode_block.cu; K4 is stream_parse_kernel (K4a) then stream_move_kernel (K4b), in "
        "decode_stream.cu; K5 is run_tape_kernel (producer -> grouped mover), K6 run_tape_k_kernel (record by "
        "record), both in decode_tape.cu")

    rng = np.random.default_rng(7)
    kernels = {}

    # ---- 3. K1 concat against its plain version, main-path shape ----
    S, CAPW = 64, 384
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (BATCH, S, CAPW), dtype=np.int64).astype(np.int32)).to(dev)
    lens_np = rng.integers(0, CAPW * 4 + 1, (BATCH, S)).astype(np.int32)
    lens_np[0, :] = 0
    lens_np[1, :] = 1
    lens_np[2, :] = np.arange(S) * 2 + 1            # odd lengths
    lens_np[3, :47] = CAPW * 4                       # sum 72192, within 1536 of the row
    lens_np[3, 47:] = 0
    lens_np[4, :] = PAD_OUT // S                     # sums exactly 73728
    lens_np[5:] = np.minimum(lens_np[5:], 1100)
    assert (lens_np.sum(1) <= PAD_OUT).all()
    k1_err = 0
    for name, set_np in k1_sets(rng, lens_np, 4 * CAPW, PAD_OUT).items():
        set_lens = torch.from_numpy(set_np).to(dev)
        got = concat.concat_rows_words(words, set_lens, PAD_OUT)
        ref = concat.concat_rows_ref(words.view(torch.uint8), set_lens, PAD_OUT)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        if err != 0 or not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its plain version on the {name} lengths (max abs err {err})")
        k1_err = max(k1_err, err)
    log("[3 K1] concat (128,64,384) words equals its plain version on the present lengths, all-1-byte sections, "
        "lengths 16k-1/16k/16k+1, sections straddling warp and tile edges, rows summing to 73728 exactly and "
        "rows outside the contract (max abs err 0)")
    lens = torch.from_numpy(lens_np).to(dev)
    k1_events = event_ms(lambda: concat.concat_rows_words(words, lens, PAD_OUT), 50)
    k1_plain = event_ms(lambda: concat.concat_rows_ref(words.view(torch.uint8), lens, PAD_OUT), 20)
    # device time: five copies of the inputs (110 MB with the rows) in turn, each cold in L2
    word_copies = [words] + [words.clone() for _ in range(4)]
    k1_ms = graph_ms(lambda i: concat.concat_rows_words(word_copies[i], lens, PAD_OUT), len(word_copies))
    nbytes = k1_bytes(lens, 4 * CAPW, PAD_OUT)
    src = [torch.empty(nbytes // 2, dtype=torch.uint8, device=dev) for _ in range(5)]
    dst = [torch.empty_like(s) for s in src]
    copy_ms = graph_ms(lambda i: dst[i].copy_(src[i]), len(src))
    # the split: K1 with every length 0 (the scan and the zero stores, no
    # reads) and zero_ of as many rows (the card's store floor)
    no_lens = torch.zeros_like(lens)
    k1_zero_ms = graph_ms(lambda i: concat.concat_rows_words(word_copies[i], no_lens, PAD_OUT), len(word_copies))
    rows = [torch.empty((BATCH, PAD_OUT), dtype=torch.uint8, device=dev) for _ in range(5)]
    fill_ms = graph_ms(lambda i: rows[i].zero_(), len(rows))
    del word_copies, src, dst, rows
    log(f"[3 K1] kernel {k1_ms:.4f} ms by CUDA graph replay (cold inputs), {k1_events:.4f} ms by events around "
        f"50 wrapper calls (warm inputs, host launch time included); plain torch {k1_plain:.4f} ms; bound "
        f"{bound_ms(nbytes):.4f} ms for {nbytes} bytes (K1 at {bound_ms(nbytes) / k1_ms * 100:.1f} %); copy floor: "
        f"copy_ of {nbytes // 2} bytes (as many bytes moved) {copy_ms:.4f} ms "
        f"({nbytes / copy_ms / 1e9:.3f} TB/s); split: K1 with all lengths 0 {k1_zero_ms:.4f} ms, zero_ of the "
        f"{BATCH * PAD_OUT}-byte rows {fill_ms:.4f} ms")
    kernels["concat"] = dict(err=k1_err, ms=k1_ms, plain_ms=k1_plain, bound_ms=bound_ms(nbytes), events_ms=k1_events,
                             copy_floor_ms=copy_ms)

    # ---- 4. K2 block decoder against its plain version ----
    samples = [
        corpus.text(BS, seed=11), corpus.text(BS - 1, seed=12), corpus.low_entropy(BS, seed=13),
        corpus.random_bytes(BS, seed=14), corpus.mixed(BS, seed=15), corpus.structured_binary(BS, seed=16),
        corpus.constant(BS, 0xAB), corpus.text(5000, seed=17),
    ]
    blocks = np.zeros((len(samples), BS), np.uint8)
    blens = np.zeros(len(samples), np.int32)
    for i, s in enumerate(samples):
        blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
        blens[i] = len(s)
    rows, comp_lens, out_lens, valid = [], [], [], []
    for dense in (False, True):
        c, t = encode_blocks_v2(torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev), dense)
        rows.append(c.cpu().numpy())
        comp_lens += t.cpu().tolist()
        out_lens += blens.tolist()
        valid += [True] * len(samples)
    for _name, comp, raw in golden_streams():
        arr = np.frombuffer(comp, np.uint8)
        n, start = framing.read_preamble(arr)
        chunks, olens = framing.split_ops_stream(arr[start:], n)
        padded, clens = framing.pad_chunks(chunks)
        rows.append(padded)
        comp_lens += clens.tolist()
        out_lens += list(olens)
        valid += [True] * len(olens)
    base = np.concatenate(rows)
    # fill the main path's batch of 128 with mutated copies (either verdict;
    # flags must agree) and one zero-length pad block
    src = rng.integers(0, base.shape[0], BATCH - base.shape[0] - 1)
    mutated = base[src].copy()
    for i, j in enumerate(src):
        for _ in range(1 + i % 4):
            mutated[i, int(rng.integers(0, max(comp_lens[j], 1)))] ^= int(rng.integers(1, 256))
    zero = np.zeros((1, PAD_OUT), np.uint8)
    comp_all = np.concatenate([base, mutated, zero])
    comp_lens += [comp_lens[j] for j in src] + [0]
    out_lens += [out_lens[j] for j in src] + [0]
    valid += [None] * len(src) + [True]
    ct = torch.from_numpy(comp_all).to(dev)
    cl = torch.tensor(comp_lens, dtype=torch.int32, device=dev)
    ol = torch.tensor(out_lens, dtype=torch.int32, device=dev)
    out_k, ok_k = decode_vm4.decode_blocks_vm4(ct, cl, ol)
    out_p, ok_p = decode_vm4.decode_blocks_ref(ct, cl, ol)
    if not torch.equal(ok_k, ok_p):
        raise AssertionError(f"K2 ok flags differ from plain: {torch.nonzero(ok_k != ok_p).flatten().tolist()}")
    okm = ok_k.cpu().numpy()
    for i, v in enumerate(valid):
        if v and not okm[i]:
            raise AssertionError(f"K2 rejected valid block {i}")
    k2_err = int((out_k[ok_k].int() - out_p[ok_p].int()).abs().max())
    if k2_err != 0:
        raise AssertionError(f"K2 rows differ from plain where ok (max abs err {k2_err})")
    nb = ct.shape[0]
    if nb != BATCH:
        raise AssertionError(f"K2 check batch has {nb} blocks, not {BATCH}")
    k2_ms = event_ms(lambda: decode_vm4.decode_blocks_vm4(ct, cl, ol), 10)
    k2_plain = host_ms(lambda: decode_vm4.decode_blocks_ref(ct, cl, ol), 1)
    log(f"[4 K2] {nb} blocks ({int(okm.sum())} ok, {nb - int(okm.sum())} rejected, flags and ok rows equal to plain); "
        f"kernel {k2_ms:.4f} ms per batch, plain {k2_plain:.1f} ms per batch ({k2_plain / nb:.2f} ms/block)")
    chk_bound = bound_ms(block_bytes(comp_lens, nb))
    kernels["decode_block"] = dict(err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=chk_bound)

    # ---- 5. the main path: 32 MB, encode -> decode -> check, on the card ----
    raw = corpus.mixed(MAIN_MB << 20, seed=42)
    data = np.frombuffer(raw, np.uint8)
    blocks_np, lens_np = framing.pack_blocks(data)
    nbat = (blocks_np.shape[0] + BATCH - 1) // BATCH
    bl = [torch.from_numpy(blocks_np[i * BATCH : (i + 1) * BATCH]).to(dev) for i in range(nbat)]
    ll = [torch.from_numpy(lens_np[i * BATCH : (i + 1) * BATCH]).to(dev) for i in range(nbat)]
    torch.cuda.synchronize()
    log(f"[5 main] {data.size} bytes = {blocks_np.shape[0]} blocks in {nbat} device batches of {BATCH}")
    # K1's inputs on the main path: the encoder's first call per profile
    # (its first batch) hands them to the timing after this phase
    k1_inputs = {}

    def concat_capturing(pieces, lens, out_cap):
        k1_inputs.setdefault(profile, (pieces, lens, out_cap))  # `profile`: the loop's, at call time
        return concat.concat_rows(pieces, lens, out_cap)

    encode_v2.concat_rows = concat_capturing
    zero_counts()
    results, encs = {}, {}
    for profile in ("fast", "dense"):
        dense = profile == "dense"
        encode_blocks_v2(bl[0], ll[0], dense)  # warm-up (allocator, sort workspaces)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = [encode_blocks_v2(b, n, dense) for b, n in zip(bl, ll)]
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        totals = torch.cat([t for _c, t in enc])
        if bool((totals < 0).any()):
            raise AssertionError(f"{profile}: capacity poison in blocks {torch.nonzero(totals < 0).flatten().tolist()}")
        decode_blocks_vm(enc[0][0], enc[0][1], ll[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = [decode_blocks_vm(c, t, n) for (c, t), n in zip(enc, ll)]
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        ok_count = sum(int(ok.sum()) for _o, ok in dec)
        match = sum(int((o == b).all(dim=1).sum()) for (o, _ok), b in zip(dec, bl))
        nblk = blocks_np.shape[0]
        if ok_count != nblk or match != nblk:
            raise AssertionError(f"{profile}: {nblk - ok_count} blocks not ok, {nblk - match} blocks differ")
        k2_batch = event_ms(lambda: decode_blocks_vm(enc[0][0], enc[0][1], ll[0]), 5)
        comp_bytes = int(totals.sum())
        mb = data.size / 1e6
        results[profile] = dict(encode_MBps=mb / enc_s, decode_MBps=mb / dec_s, combined_MBps=mb / (enc_s + dec_s),
                                ratio=data.size / comp_bytes, encode_peak_GiB=peak)
        log(f"[5 main] {profile}: encode {mb / enc_s:.1f} MB/s ({enc_s * 1e3:.1f} ms), decode {mb / dec_s:.1f} MB/s "
            f"({dec_s * 1e3:.1f} ms; K2 {k2_batch:.3f} ms per 128-block batch), ratio {data.size / comp_bytes:.4f}, "
            f"all {nblk} blocks ok and equal on the device; encode peak memory {peak:.2f} GiB")

        # the card's rows equal the port's CPU path on the first 4 blocks
        c_cpu, t_cpu = encode_blocks_v2(bl[0][:4].cpu(), ll[0][:4].cpu(), dense)
        if not (torch.equal(c_cpu, enc[0][0][:4].cpu()) and torch.equal(t_cpu, enc[0][1][:4].cpu())):
            raise AssertionError(f"{profile}: card rows differ from the CPU path on the first 4 blocks")
        log(f"[5 main] {profile}: first 4 rows equal the port's CPU path")

        encs[profile] = enc
        if profile == "fast":
            comp_np = torch.cat([c for c, _t in enc]).cpu().numpy()
            tot_np = totals.cpu().numpy()
            stream = encode_varint(data.size) + b"".join(comp_np[i, : tot_np[i]].tobytes() for i in range(len(tot_np)))
            if cpu.available:
                if cpu.decompress(stream) != raw:
                    raise AssertionError("native C++ decoder disagrees on the fast stream")
                log("[5 main] fast: the native C++ decoder decodes the stream to the input")
            else:
                log("[5 main] fast: native C++ runtime did not build; independent decode skipped")
    paths = {"main": read_counts()}
    encode_v2.concat_rows = concat.concat_rows
    log(f"[5 main] kernel launches on the main path: {paths['main']}")
    log(f"[5 main] summary {json.dumps(results)}")
    if min(paths["main"]["concat"], paths["main"]["decode_block"]) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {paths['main']}")
    # K1 on the main path's own inputs, against its plain version, timed as in phase 3
    main_ms, main_bound = {}, {}
    for profile, (pieces, lens, out_cap) in k1_inputs.items():
        if pieces.device != dev:
            raise AssertionError(f"{profile}: the encoder's first concat ran on {pieces.device}")
        got = concat.concat_rows(pieces, lens, out_cap)
        err = int((got.int() - concat.concat_rows_ref(pieces, lens, out_cap).int()).abs().max())
        if err != 0:
            raise AssertionError(f"{profile}: K1 differs from its plain version on the main path's inputs ({err})")
        copies = [pieces] + [pieces.clone() for _ in range(4)]
        main_ms[profile] = graph_ms(lambda i: concat.concat_rows(copies[i], lens, out_cap), len(copies))
        main_bound[profile] = bound_ms(k1_bytes(lens, pieces.shape[2], out_cap))
        log(f"[5 K1] {profile}: the main path's {tuple(pieces.shape)} sections and lengths (row sums "
            f"{int(lens.sum(1).min())}-{int(lens.sum(1).max())} bytes): equal to plain; kernel {main_ms[profile]:.4f} "
            f"ms by CUDA graph replay (cold inputs), bound {main_bound[profile]:.4f} ms "
            f"(K1 at {main_bound[profile] / main_ms[profile] * 100:.1f} %)")
    del k1_inputs, copies
    kernels["concat"].update(main_path_ms=main_ms, main_path_bound_ms=main_bound)

    # ---- 6. the user API on the card ----
    small = corpus.mixed(3 << 20, seed=5)
    for profile in ("fast", "dense"):
        s = api.compress(small, profile, device="cuda")
        if api.decompress(s, device="cuda") != small:
            raise AssertionError(f"api round trip failed ({profile})")
        log(f"[6 api] {profile}: {len(small)} -> {len(s)} bytes, round trip ok")
    if api.compress(small[: 4 * BS], "fast", device="cuda") != api.compress(small[: 4 * BS], "fast", device="cpu"):
        raise AssertionError("api.compress on the card differs from the CPU path")
    for name, comp, golden_raw in golden_streams():
        if api.decompress(comp, device="cuda") != golden_raw:
            raise AssertionError(f"api.decompress failed on golden stream {name}")
    log("[6 api] card output equals the CPU path; golden google/snappy streams decode")

    # ---- 7. K3, the op-by-op decoder; K2 against K3 on the main path's batches ----
    out3, ok3 = decode_vm2.decode_blocks_vm2(ct, cl, ol)
    if not torch.equal(ok3, ok_p):
        raise AssertionError(f"K3 ok flags differ from plain: {torch.nonzero(ok3 != ok_p).flatten().tolist()}")
    k3_err = int((out3[ok3].int() - out_p[ok_p].int()).abs().max())
    if k3_err != 0:
        raise AssertionError(f"K3 rows differ from plain where ok (max abs err {k3_err})")
    k3_ms = event_ms(lambda: decode_vm2.decode_blocks_vm2(ct, cl, ol), 10)
    k3_plain = host_ms(lambda: decode_vm4.decode_blocks_ref(ct, cl, ol), 1)
    kernels["decode_block_vm2"] = dict(err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=chk_bound)
    # its path: the A/B twin of phase 5's decode, on the fast profile's batches
    zero_counts()
    dec3 = [decode_vm2.decode_blocks_vm2(c, t, n) for (c, t), n in zip(encs["fast"], ll)]
    paths["main_ab_k3"] = read_counts()
    ok_count = sum(int(ok.sum()) for _o, ok in dec3)
    match = sum(int((o == b).all(dim=1).sum()) for (o, _ok), b in zip(dec3, bl))
    if ok_count != blocks_np.shape[0] or match != blocks_np.shape[0]:
        raise AssertionError("K3 did not decode phase 5's fast batches to the input")
    log(f"[7 K3] check batch: flags and ok rows equal to plain; kernel {k3_ms:.4f} ms (K2 {k2_ms:.4f} ms), "
        f"plain {k3_plain:.1f} ms; A/B path: phase 5's fast batches decode to the input in "
        f"{paths['main_ab_k3']['decode_block_vm2']} launches")
    # K2 against K3 on phase 5's batches, in one call, in turns K2, K3, K3, K2
    decoders = {"K2": decode_vm4.decode_blocks_vm4, "K3": decode_vm2.decode_blocks_vm2}
    ab = {}
    for profile, enc in encs.items():
        per = {"K2": [], "K3": []}
        for who in ("K2", "K3", "K3", "K2"):
            fn = decoders[who]
            per[who].append(event_ms(lambda: [fn(c, t, n) for (c, t), n in zip(enc, ll)], 5) / len(enc))
        batch_bound = bound_ms(sum(block_bytes(t.cpu().numpy(), t.shape[0]) for _c, t in enc)) / len(enc)
        ms = {who: sum(v) / len(v) for who, v in per.items()}
        ab[profile] = dict(per, bound_ms=batch_bound)
        mb = data.size / 1e6
        log(f"[7 K2/K3] {profile}: ms per 128-block batch K2 {per['K2'][0]:.4f}, K3 {per['K3'][0]:.4f}, "
            f"K3 {per['K3'][1]:.4f}, K2 {per['K2'][1]:.4f}; decode {mb / (ms['K2'] * nbat / 1e3):.1f} MB/s through "
            f"K2, {mb / (ms['K3'] * nbat / 1e3):.1f} MB/s through K3; K2/K3 = {ms['K2'] / ms['K3']:.3f}; "
            f"bound {batch_bound:.4f} ms per batch (K2 at {batch_bound / ms['K2'] * 100:.2f} % of it)")
    log(f"[7 K2/K3] summary {json.dumps(ab)}")

    # ---- 8. K5 / K6 on a 128-block host batch ----
    nbase = base.shape[0]  # phase 4's own streams of both profiles and golden streams, all valid
    tape_rows, tape_cl, tape_ol, tape_valid = tape_check_batch(rng, base, comp_lens[:nbase], out_lens[:nbase])
    tapes_np, nrecs_np = decode_tape.build_tapes(tape_rows, tape_cl, tape_ol)
    if not ((nrecs_np == -9).any() and (nrecs_np == -10).any() and (nrecs_np == 0).any()):
        raise AssertionError(f"K5 check batch lacks a -9, a -10 or a pad block: {sorted(set(nrecs_np.tolist()))[:8]}")
    tp, nr, rw = decode_tape.stage(tape_rows, tapes_np, nrecs_np, device=dev)
    out5, ok5 = decode_tape._run_tape(tp, nr, rw)
    out5p, ok5p = decode_tape.run_tape_ref(tp, nr, rw)
    torch.cuda.synchronize()
    if not torch.equal(ok5, ok5p) or not torch.equal(ok5.cpu(), torch.from_numpy(nrecs_np >= 0)):
        raise AssertionError(f"K5 ok flags differ from plain: {torch.nonzero(ok5 != ok5p).flatten().tolist()}")
    k5_err = int((out5.int() - out5p.int()).abs().max())
    if k5_err != 0:
        raise AssertionError(f"K5 rows differ from plain (max abs err {k5_err})")
    # the whole route (-9 block through K2 on the card) against K2 on the same rows
    outt, okt = decode_tape.decode_blocks_tape(tape_rows, tape_cl, tape_ol, device=dev)
    cl5, ol5 = torch.from_numpy(tape_cl).to(dev), torch.from_numpy(tape_ol).to(dev)
    out2, ok2 = decode_vm4.decode_blocks_vm4(rw, cl5, ol5)
    if not torch.equal(okt, ok2) or not torch.equal(outt[okt], out2[ok2]):
        raise AssertionError("the tape route differs from K2 on the check batch")
    if not all(okt.cpu().numpy()[tape_valid]):
        raise AssertionError("the tape route rejected a valid block")
    k5_plain = host_ms(lambda: decode_tape.run_tape_ref(tp, nr, rw), 1)
    k6_err = 0
    for K in (2, 4):
        o6, k6ok = decode_tape._run_tape_k(tp, nr, rw, K=K)
        if not torch.equal(k6ok, ok5p):
            raise AssertionError(f"K6 (K={K}) ok flags differ from plain")
        k6_err = max(k6_err, int((o6.int() - out5p.int()).abs().max()))
        if k6_err != 0 or not torch.equal(o6, out5):
            raise AssertionError(f"K6 (K={K}) rows differ from plain or K5 (max abs err {k6_err})")
    # random records whose batches are not forward: K5 moves them one by one
    rt, rn = random_tapes(rng, BATCH, 64)
    r_args = tuple(torch.from_numpy(a).to(dev) for a in (rt, rn, rng.integers(0, 256, (BATCH, PAD_OUT), np.uint8)))
    r_out, r_ok = decode_tape.run_tape_ref(*r_args)
    for who, (o, k) in (("K5", decode_tape._run_tape(*r_args)), ("K6", decode_tape._run_tape_k(*r_args, K=4))):
        err = int((o.int() - r_out.int()).abs().max())
        if not torch.equal(k, r_ok) or err != 0:
            raise AssertionError(f"{who} differs from plain on random records (max abs err {err})")
        if who == "K5":
            k5_err = max(k5_err, err)
        else:
            k6_err = max(k6_err, err)
    nrok = int(r_ok.sum())
    if not 0 < nrok < BATCH:
        raise AssertionError(f"the random tapes gave {nrok} ok blocks of {BATCH}")
    turns8 = tape_turns([(tp, nr, rw)], 10)
    k5_ms, k6_ms = (sum(v) / len(v) for v in (turns8["K5"], turns8["K6"]))
    # K5's bytes: the records (8 bytes each), the counts, the compressed
    # bytes the literal records read (each row up to comp_len), rows and flags
    k5_bytes = 8 * int(np.maximum(nrecs_np, 0).sum()) + 4 * len(nrecs_np) + int(np.asarray(tape_cl).sum()) \
        + tape_rows.shape[0] * (BS + 1)
    kernels["decode_tape"] = dict(err=k5_err, ms=k5_ms, plain_ms=k5_plain, bound_ms=bound_ms(k5_bytes))
    kernels["decode_tape_k"] = dict(err=k6_err, ms=k6_ms, plain_ms=k5_plain, bound_ms=bound_ms(k5_bytes))
    log(f"[8 K5] {tape_rows.shape[0]} host blocks ({int(ok5.sum())} ok; nrecs max {int(nrecs_np.max())}, "
        f"{int((nrecs_np == -9).sum())} -9, "
        f"{int((nrecs_np == -10).sum())} -10): equal to plain; the route with its K2 fallback equals K2; "
        f"plain {k5_plain:.1f} ms; {BATCH} random tapes ({nrok} ok, not forward): K5 and K6 equal plain")
    log(f"[8 K5/K6] K6 with K=2 and K=4 equals K5; ms per batch in turns K5 {turns8['K5'][0]:.4f}, "
        f"K6 {turns8['K6'][0]:.4f}, K6 {turns8['K6'][1]:.4f}, K5 {turns8['K5'][1]:.4f}; K5/K6 = {k5_ms / k6_ms:.3f}")

    # ---- 9. K4 on one windowed call of 64 chunks ----
    # a short literal phase-shifts an encoded tail, so that its ops straddle
    # the 64 KiB grid (the construction of tests/test_torch_api.py)
    wdata = corpus.mixed(WIN_MB << 20, seed=8)
    shift = 7
    tail = np.frombuffer(api.compress(wdata[shift:], "fast", device=dev), np.uint8)
    wops = np.concatenate([np.frombuffer(bytes([(shift - 1) << 2]) + wdata[:shift], np.uint8),
                           tail[framing.read_preamble(tail)[1] :]])
    wstream = encode_varint(len(wdata)) + wops.tobytes()
    t0 = time.perf_counter()
    chunks, wol, wxl = framing.split_ops_windowed(wops, len(wdata))
    split_s = time.perf_counter() - t0
    padded, wcl = framing.pad_chunks(chunks[:64])
    w_args = (torch.from_numpy(padded).to(dev), torch.from_numpy(wcl).to(dev),
              torch.tensor(wol[:64], dtype=torch.int32, device=dev), torch.from_numpy(wxl[:64]).to(dev),
              torch.zeros(BS, dtype=torch.uint8, device=dev))
    out4, ok4 = decode_vm2.decode_stream_vm(*w_args)
    out4p, ok4p = decode_vm2.decode_stream_ref(*w_args)
    torch.cuda.synchronize()
    if not (bool(ok4.all()) and torch.equal(ok4, ok4p)):
        raise AssertionError("K4 flags: not all ok, or differ from plain")
    k4_err = int((out4.int() - out4p.int()).abs().max())
    out4_np = out4.cpu().numpy()
    got = b"".join(out4_np[i, : wol[i]].tobytes() for i in range(out4_np.shape[0]))
    if k4_err != 0 or got != wdata[: len(got)]:
        raise AssertionError(f"K4 rows differ from plain or the input (max abs err {k4_err})")
    k4_ms = event_ms(lambda: decode_vm2.decode_stream_vm(*w_args), 3)
    k4_plain = host_ms(lambda: decode_vm2.decode_stream_ref(*w_args), 1)
    # its two launches apart: K4a's parse of all 64 chunks, K4b's moves
    recs, nrecs, _ok = decode_vm2._stream_parse(*w_args[:4])
    k4a_ms = event_ms(lambda: decode_vm2._stream_parse(*w_args[:4]), 3)
    k4b_ms = event_ms(lambda: decode_vm2._stream_move(*w_args[:3], w_args[4], recs, nrecs), 3)
    # the first call with mutated chunks: flags and every row against plain
    rng_w = np.random.default_rng(9)
    bad = padded.copy()
    for i in rng_w.choice(bad.shape[0], 12, replace=False):
        for _ in range(int(rng_w.integers(1, 4))):
            bad[i, int(rng_w.integers(0, max(int(wcl[i]), 1)))] ^= int(rng_w.integers(1, 256))
    w_args3 = (torch.from_numpy(bad).to(dev), *w_args[1:])
    out4c, ok4c = decode_vm2.decode_stream_vm(*w_args3)
    out4cp, ok4cp = decode_vm2.decode_stream_ref(*w_args3)
    torch.cuda.synchronize()
    k4c_err = int((out4c.int() - out4cp.int()).abs().max())
    if not torch.equal(ok4c, ok4cp) or k4c_err != 0 or bool(ok4c.all()):
        raise AssertionError(f"K4 on mutated chunks differs from plain (max abs err {k4c_err}) or refused none")
    # the next 64 chunks, seeded with the card's last 64 KiB of output (ctx0)
    padded2, wcl2 = framing.pad_chunks(chunks[64:128])
    w_args2 = (torch.from_numpy(padded2).to(dev), torch.from_numpy(wcl2).to(dev),
               torch.tensor(wol[64:128], dtype=torch.int32, device=dev), torch.from_numpy(wxl[64:128]).to(dev),
               torch.from_numpy(np.frombuffer(got[-BS:], np.uint8).copy()).to(dev))
    out4b, ok4b = decode_vm2.decode_stream_vm(*w_args2)
    out4bp, ok4bp = decode_vm2.decode_stream_ref(*w_args2)
    torch.cuda.synchronize()
    if not (bool(ok4b.all()) and torch.equal(ok4b, ok4bp)):
        raise AssertionError("K4 flags with a nonzero ctx0: not all ok, or differ from plain")
    k4_err = max(k4_err, int((out4b.int() - out4bp.int()).abs().max()))
    out4b_np = out4b.cpu().numpy()
    got2 = b"".join(out4b_np[i, : wol[64 + i]].tobytes() for i in range(out4b_np.shape[0]))
    if k4_err != 0 or got2 != wdata[len(got) : len(got) + len(got2)]:
        raise AssertionError(f"K4 rows with a nonzero ctx0 differ from plain or the input (max abs err {k4_err})")
    k4_bytes = block_bytes(wcl, len(wcl)) + 4 * len(wcl) + BS  # + ctx_lens and ctx0
    k4_err = max(k4_err, k4c_err)
    kernels["decode_stream"] = dict(err=k4_err, ms=k4_ms, plain_ms=k4_plain, bound_ms=bound_ms(k4_bytes),
                                    parse_ms=k4a_ms, move_ms=k4b_ms)
    log(f"[9 K4] chunks 0-63 ({len(got)} bytes, zero ctx0) and 64-127 ({len(got2)} bytes, ctx0 = the card's last "
        f"64 KiB) of a {len(wdata)}-byte unaligned stream ({len(chunks)} chunks; host split {split_s * 1e3:.1f} ms): "
        f"equal to plain and the input; chunks 0-63 mutated ({int(ok4c.sum())} of 64 ok): flags and every row equal "
        f"to plain; kernel {k4_ms:.3f} ms per call (K4a parse {k4a_ms:.3f} ms, K4b move {k4b_ms:.3f} ms, "
        f"{int(nrecs.sum())} records), plain {k4_plain:.1f} ms")

    # ---- 10. the host-resident path: file codec, 32 MB, on the card ----
    with tempfile.TemporaryDirectory() as tmp:
        src, comp_f, out_f = (os.path.join(tmp, n) for n in ("in.raw", "c.snappy", "out.raw"))
        with open(src, "wb") as f:
            f.write(raw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = filecodec.compress_file(src, comp_f, "fast", device=dev)
        torch.cuda.synchronize()
        cfile_s = time.perf_counter() - t0
        with open(comp_f, "rb") as f:
            fstream = f.read()
        if fstream != api.compress(raw, "fast", device=dev) or nbytes != len(fstream):
            raise AssertionError("compress_file differs from api.compress")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filecodec.decompress_file(comp_f, out_f, device=dev)
        torch.cuda.synchronize()
        dfile_s = time.perf_counter() - t0
        paths["host"] = read_counts()
        with open(out_f, "rb") as f:
            if f.read() != raw:
                raise AssertionError("decompress_file did not give back the input")
        # the port's CLI, once each way, on a small file
        with open(src, "wb") as f:
            f.write(raw[: 3 << 20])
        if cli.main(["-c", src, comp_f]) != 0 or cli.main(["-d", comp_f, out_f]) != 0:
            raise AssertionError("the CLI failed")
        with open(out_f, "rb") as f:
            if f.read() != raw[: 3 << 20]:
                raise AssertionError("the CLI round trip differs from its input")
    mb = len(raw) / 1e6
    log(f"[10 host] compress_file {mb / cfile_s:.1f} MB/s, bytes equal api.compress ({len(fstream)} bytes); "
        f"decompress_file {mb / dfile_s:.1f} MB/s through the tape route ({paths['host']['decode_tape']} K5 "
        f"launches, {paths['host']['decode_block']} K2 fallback launches), output equals the input; CLI -c/-d round trip ok")
    routes = host_routes(fstream, raw, dev)
    for name, parts in routes.items():
        total = sum(parts.values())
        log(f"[10 host] {name} route: {mb / total:.1f} MB/s ({total * 1e3:.1f} ms; "
            + ", ".join(f"{k} {v * 1e3:.1f} ms = {mb / v:.0f} MB/s" for k, v in parts.items()) + ")")
    # K5 against K6 on the stream's host rows, in turns
    hrows, hcl, hol = host_rows(fstream)
    staged = []
    for b0 in range(0, hrows.shape[0], BATCH):
        r, c, o = hrows[b0 : b0 + BATCH], hcl[b0 : b0 + BATCH], hol[b0 : b0 + BATCH]
        pad = -r.shape[0] % 4
        r, c, o = (np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) for a in (r, c, o))
        staged.append(decode_tape.stage(r, *decode_tape.build_tapes(r, c, o), device=dev))
    turns10 = tape_turns(staged, 5)
    t5, t6 = (sum(v) / len(v) for v in (turns10["K5"], turns10["K6"]))
    log(f"[10 host] K5/K6 on the stream's {len(staged)} batches of host rows, ms per batch in turns K5 "
        f"{turns10['K5'][0]:.4f}, K6 {turns10['K6'][0]:.4f}, K6 {turns10['K6'][1]:.4f}, K5 {turns10['K5'][1]:.4f}; "
        f"K5/K6 = {t5 / t6:.3f}")
    # K6's path: the A/B twin of the tape route, on the same host rows
    zero_counts()
    run_tape_k_path(fstream, raw, dev)
    paths["host_ab_k6"] = read_counts()
    log(f"[10 host] A/B path: the 32 MB stream's tapes through K6 (K=4) decode to the input in "
        f"{paths['host_ab_k6']['decode_tape_k']} launches")

    # ---- 11. the windowed path: an unaligned 8 MB stream through api.decompress ----
    zero_counts()
    api.host_fallbacks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if api.decompress(wstream, device=dev) != wdata:
        raise AssertionError("api.decompress of the unaligned stream differs from its input")
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    paths["windowed"] = read_counts()
    if api.host_fallbacks != 0:
        raise AssertionError("K4 refused the unaligned stream; the host decoder decoded it")
    if paths["windowed"]["decode_stream"] < 2:
        raise AssertionError(f"the windowed path ran {paths['windowed']['decode_stream']} K4 calls, fewer than 2")
    log(f"[11 windowed] {len(wdata)} bytes, {len(chunks)} chunks in {paths['windowed']['decode_stream']} K4 calls: "
        f"{len(wdata) / 1e6 / win_s:.1f} MB/s ({win_s * 1e3:.1f} ms, K4 {k4_ms:.1f} ms per 64-chunk call), "
        f"output equals the input")

    # ---- 12. the decode profiling path ----
    t0 = time.perf_counter()
    prof_kernels, paths["profiling"] = profiling_path(dev)
    kernels.update(prof_kernels)
    log(f"[12 profiling] phase time {time.perf_counter() - t0:.1f} s")

    # ---- 14. the port's benchmark ----
    t0 = time.perf_counter()
    paths["bench"] = bench_path(dev, kind, results)
    log(f"[14 bench] phase time {time.perf_counter() - t0:.1f} s")

    # ---- 15. the mesh path ----
    t0 = time.perf_counter()
    paths["mesh"] = mesh_path(dev)
    log(f"[15 mesh] phase time {time.perf_counter() - t0:.1f} s")

    # ---- 13. report ----
    info = {  # name -> (source, TPU kernel it replaces, the path it runs on)
        "concat": ("snappytpu_torch/csrc/concat.cu", "snappytpu/kernels/concat.py:64", "main"),
        "decode_block": ("snappytpu_torch/csrc/decode_block.cu", "snappytpu/kernels/decode_vm4.py:259", "main"),
        "decode_block_vm2": ("snappytpu_torch/csrc/decode_block.cu", "snappytpu/kernels/decode_vm2.py:378",
                             "main_ab_k3"),
        "decode_stream": ("snappytpu_torch/csrc/decode_stream.cu", "snappytpu/kernels/decode_vm2.py:492", "windowed"),
        "decode_tape": ("snappytpu_torch/csrc/decode_tape.cu", "snappytpu/kernels/decode_tape.py:109", "host"),
        "decode_tape_k": ("snappytpu_torch/csrc/decode_tape.cu", "snappytpu/kernels/decode_tape.py:214",
                          "host_ab_k6"),
        "dec_anatomy": ("snappytpu_torch/csrc/dec_anatomy.cu", "tools/dec_anatomy.py:128", "profiling"),
        "tape_probe": ("snappytpu_torch/csrc/tape_probe.cu", "tools/tape_probe.py:346", "profiling"),
        "probe_scalar": ("snappytpu_torch/csrc/probe_scalar.cu", "tools/probe_scalar.py:41-497", "profiling"),
    }
    missing = [name for name, (_s, _r, path) in info.items() if paths[path][name] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}; {paths}")
    log(f"[13 report] launches by path: {json.dumps(paths)}")
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": info[name][0], "replaces": info[name][1],
         "launches": paths[info[name][2]][name],
         "launches_by_path": {path: c[name] for path, c in paths.items() if c[name]},
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": "bytes", "library_ms": None, **{x: k[x] for x in K_EXTRAS if x in k}}
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
