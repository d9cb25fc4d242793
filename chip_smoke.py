#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (snappytpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each against its plain PyTorch version on the card, and
drives the port's paths at full size, each with its kernels' launch counts
set to 0 just before it and read just after:

  1-2   environment, build
  3-4   K1 (concat) and K2 (block decoder) against their plain versions
  5     the main path: a 32 MB mixed corpus (512 blocks of 64 KiB) encoded on
        the card with both profiles in batches of 128 blocks (torch ops + K1),
        decoded on the card by K2, compared block by block on the device
  6     the user API with device="cuda"
  7     K3 against its plain version; its path is the A/B twin of phase 5's
        decode (the fast batches through K3)
  8     K5 and K6 against their plain versions on a 128-block host batch
        (own, native-compressor, mutated, tape-overflow and pad blocks); the
        tape route with its K2 fallback against K2
  9     K4 against its plain version on two calls of 64 chunks, the second
        seeded (ctx0) with the first call's last 64 KiB of output
  10    the host-resident path: the 32 MB corpus through compress_file and
        decompress_file (the tape route, K5) on the card, the CLI once each
        way, both host routes (tape, K2) timed part by part, and K6's path,
        the A/B twin of the tape route
  11    the windowed path: an unaligned 8 MB stream through api.decompress
        (two or more K4 calls of 64 chunks, and no chunk refused to the
        host decoder)

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON line with each kernel's launches on its path, error against its
plain version and times; the last line is {"ok": true, "device": {...}}.
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
BATCH = 128
MAIN_MB = 32
WIN_MB = 8  # the windowed path's stream: 128+ chunks, so two K4 calls of 64


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


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn by the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


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
    from snappytpu import cpu
    from snappytpu.format import constants as C
    from snappytpu.stream import framing

    arr = np.frombuffer(stream, np.uint8)
    n, start = framing.read_preamble(arr)
    offs, lens = cpu.scan_ops(arr[start:], n)
    rows, comp_lens = cpu.split_rows(arr[start:], offs, C.MAX_COMPRESSED_BLOCK_SIZE)
    return rows, comp_lens, lens.astype(np.int32)


def tape_check_batch(rng, base, base_cl, base_ol):
    """128 host rows for K5: phase 4's own and golden streams, the native
    compressor's streams, one all-1-byte-literal block (tape overflow, -9),
    one pad block, and mutated copies (the first one a byte short, -10)."""
    from snappytpu import cpu
    from snappytpu.bench import corpus
    from snappytpu.format import constants as C

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


def host_routes(stream: bytes, raw: bytes, dev) -> dict:
    """Decode a host-resident stream's blocks by the tape route and by the
    block-decoder route, 128 blocks at a time, timing each part on the host
    clock with the card synchronised; both outputs must equal `raw`.  Each
    route makes two whole passes, in the order tape, K2, K2, tape; the
    second pass of each is reported, so neither route pays the other's
    first-touch host allocations."""
    from snappytpu import cpu
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
    from snappytpu import cpu
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from snappytpu import cpu
    from snappytpu.bench import corpus
    from snappytpu.format import constants as C
    from snappytpu.format.varint import encode_varint
    from snappytpu.stream import framing
    from snappytpu_torch import _build, api, cli
    from snappytpu_torch.kernels import concat, decode_tape, decode_vm2, decode_vm4
    from snappytpu_torch.stream import filecodec
    from snappytpu_torch.kernels.decode_vm import decode_blocks_vm
    from snappytpu_torch.kernels.encode_v2 import encode_blocks_v2

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
    lens = torch.from_numpy(lens_np).to(dev)
    got = concat.concat_rows_words(words, lens, PAD_OUT)
    ref = concat.concat_rows_ref(words.view(torch.uint8), lens, PAD_OUT)
    torch.cuda.synchronize()
    k1_err = int((got.int() - ref.int()).abs().max())
    if k1_err != 0 or not torch.equal(got, ref):
        raise AssertionError(f"K1 differs from its plain version (max abs err {k1_err})")
    k1_ms = event_ms(lambda: concat.concat_rows_words(words, lens, PAD_OUT), 50)
    k1_plain = event_ms(lambda: concat.concat_rows_ref(words.view(torch.uint8), lens, PAD_OUT), 20)
    log(f"[3 K1] concat (128,64,384) words: equal to plain; kernel {k1_ms:.4f} ms, plain torch {k1_plain:.4f} ms")
    kernels["concat"] = dict(err=k1_err, ms=k1_ms, plain_ms=k1_plain)

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
    kernels["decode_block"] = dict(err=k2_err, ms=k2_ms, plain_ms=k2_plain)

    # ---- 5. the main path: 32 MB, encode -> decode -> check, on the card ----
    raw = corpus.mixed(MAIN_MB << 20, seed=42)
    data = np.frombuffer(raw, np.uint8)
    blocks_np, lens_np = framing.pack_blocks(data)
    nbat = (blocks_np.shape[0] + BATCH - 1) // BATCH
    bl = [torch.from_numpy(blocks_np[i * BATCH : (i + 1) * BATCH]).to(dev) for i in range(nbat)]
    ll = [torch.from_numpy(lens_np[i * BATCH : (i + 1) * BATCH]).to(dev) for i in range(nbat)]
    torch.cuda.synchronize()
    log(f"[5 main] {data.size} bytes = {blocks_np.shape[0]} blocks in {nbat} device batches of {BATCH}")
    concat.launches = 0
    decode_vm4.launches = 0
    results = {}
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

        if profile == "fast":
            enc_fast = enc
            comp_np = torch.cat([c for c, _t in enc]).cpu().numpy()
            tot_np = totals.cpu().numpy()
            stream = encode_varint(data.size) + b"".join(comp_np[i, : tot_np[i]].tobytes() for i in range(len(tot_np)))
            if cpu.available:
                if cpu.decompress(stream) != raw:
                    raise AssertionError("native C++ decoder disagrees on the fast stream")
                log("[5 main] fast: the native C++ decoder decodes the stream to the input")
            else:
                log("[5 main] fast: native C++ runtime did not build; independent decode skipped")
    launches = {"concat": concat.launches, "decode_block": decode_vm4.launches}
    log(f"[5 main] kernel launches on the main path: {launches}")
    log(f"[5 main] summary {json.dumps(results)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

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

    # ---- 7. K3: a second entry onto K2's kernel ----
    out3, ok3 = decode_vm2.decode_blocks_vm2(ct, cl, ol)
    if not torch.equal(ok3, ok_p):
        raise AssertionError(f"K3 ok flags differ from plain: {torch.nonzero(ok3 != ok_p).flatten().tolist()}")
    k3_err = int((out3[ok3].int() - out_p[ok_p].int()).abs().max())
    if k3_err != 0:
        raise AssertionError(f"K3 rows differ from plain where ok (max abs err {k3_err})")
    k3_ms = event_ms(lambda: decode_vm2.decode_blocks_vm2(ct, cl, ol), 10)
    k3_plain = host_ms(lambda: decode_vm4.decode_blocks_ref(ct, cl, ol), 1)
    kernels["decode_block_vm2"] = dict(err=k3_err, ms=k3_ms, plain_ms=k3_plain)
    # its path: the A/B twin of phase 5's decode, on the fast profile's batches
    decode_vm2.launches = 0
    dec3 = [decode_vm2.decode_blocks_vm2(c, t, n) for (c, t), n in zip(enc_fast, ll)]
    launches["decode_block_vm2"] = decode_vm2.launches
    ok_count = sum(int(ok.sum()) for _o, ok in dec3)
    match = sum(int((o == b).all(dim=1).sum()) for (o, _ok), b in zip(dec3, bl))
    if ok_count != blocks_np.shape[0] or match != blocks_np.shape[0]:
        raise AssertionError("K3 did not decode phase 5's fast batches to the input")
    log(f"[7 K3] check batch: flags and ok rows equal to plain; kernel {k3_ms:.4f} ms, plain {k3_plain:.1f} ms; "
        f"A/B path: phase 5's fast batches decode to the input in {launches['decode_block_vm2']} launches")

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
    k5_ms = event_ms(lambda: decode_tape._run_tape(tp, nr, rw), 10)
    k5_plain = host_ms(lambda: decode_tape.run_tape_ref(tp, nr, rw), 1)
    k6, k6_err = {}, 0
    for K in (2, 4):
        o6, k6ok = decode_tape._run_tape_k(tp, nr, rw, K=K)
        if not torch.equal(k6ok, ok5p):
            raise AssertionError(f"K6 (K={K}) ok flags differ from plain")
        k6_err = max(k6_err, int((o6.int() - out5p.int()).abs().max()))
        if k6_err != 0 or not torch.equal(o6, out5):
            raise AssertionError(f"K6 (K={K}) rows differ from plain or K5 (max abs err {k6_err})")
        k6[K] = event_ms(lambda: decode_tape._run_tape_k(tp, nr, rw, K=K), 10)
    kernels["decode_tape"] = dict(err=k5_err, ms=k5_ms, plain_ms=k5_plain)
    kernels["decode_tape_k"] = dict(err=k6_err, ms=k6[4], plain_ms=k5_plain)
    log(f"[8 K5] {tape_rows.shape[0]} host blocks ({int(ok5.sum())} ok; nrecs max {int(nrecs_np.max())}, "
        f"{int((nrecs_np == -9).sum())} -9, "
        f"{int((nrecs_np == -10).sum())} -10): equal to plain; the route with its K2 fallback equals K2; "
        f"kernel {k5_ms:.4f} ms, plain {k5_plain:.1f} ms")
    log(f"[8 K6] K=2 and K=4 equal K5; kernel {k6[2]:.4f} ms (K=2), {k6[4]:.4f} ms (K=4)")

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
    kernels["decode_stream"] = dict(err=k4_err, ms=k4_ms, plain_ms=k4_plain)
    log(f"[9 K4] chunks 0-63 ({len(got)} bytes, zero ctx0) and 64-127 ({len(got2)} bytes, ctx0 = the card's last "
        f"64 KiB) of a {len(wdata)}-byte unaligned stream ({len(chunks)} chunks; host split {split_s * 1e3:.1f} ms): "
        f"equal to plain and the input; kernel {k4_ms:.3f} ms per call, plain {k4_plain:.1f} ms")

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
        decode_tape.launches = decode_tape.k_launches = decode_vm4.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filecodec.decompress_file(comp_f, out_f, device=dev)
        torch.cuda.synchronize()
        dfile_s = time.perf_counter() - t0
        launches["decode_tape"] = decode_tape.launches
        k2_fallback = decode_vm4.launches
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
        f"decompress_file {mb / dfile_s:.1f} MB/s through the tape route ({launches['decode_tape']} K5 launches, "
        f"{k2_fallback} K2 fallback launches), output equals the input; CLI -c/-d round trip ok")
    routes = host_routes(fstream, raw, dev)
    for name, parts in routes.items():
        total = sum(parts.values())
        log(f"[10 host] {name} route: {mb / total:.1f} MB/s ({total * 1e3:.1f} ms; "
            + ", ".join(f"{k} {v * 1e3:.1f} ms = {mb / v:.0f} MB/s" for k, v in parts.items()) + ")")
    # K6's path: the A/B twin of the tape route, on the same host rows
    decode_tape.k_launches = 0
    run_tape_k_path(fstream, raw, dev)
    launches["decode_tape_k"] = decode_tape.k_launches
    log(f"[10 host] A/B path: the 32 MB stream's tapes through K6 (K=4) decode to the input in "
        f"{launches['decode_tape_k']} launches")

    # ---- 11. the windowed path: an unaligned 8 MB stream through api.decompress ----
    decode_vm2.stream_launches = api.host_fallbacks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if api.decompress(wstream, device=dev) != wdata:
        raise AssertionError("api.decompress of the unaligned stream differs from its input")
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    launches["decode_stream"] = decode_vm2.stream_launches
    if api.host_fallbacks != 0:
        raise AssertionError("K4 refused the unaligned stream; the host decoder decoded it")
    if launches["decode_stream"] < 2:
        raise AssertionError(f"the windowed path ran {launches['decode_stream']} K4 calls, fewer than 2")
    log(f"[11 windowed] {len(wdata)} bytes, {len(chunks)} chunks in {launches['decode_stream']} K4 calls: "
        f"{len(wdata) / 1e6 / win_s:.1f} MB/s ({win_s * 1e3:.1f} ms, K4 {k4_ms:.1f} ms per 64-chunk call), "
        f"output equals the input")

    # ---- 12. report ----
    info = {
        "concat": ("snappytpu_torch/csrc/concat.cu", "snappytpu/kernels/concat.py:64"),
        "decode_block": ("snappytpu_torch/csrc/decode_block.cu", "snappytpu/kernels/decode_vm4.py:259"),
        "decode_block_vm2": ("snappytpu_torch/csrc/decode_block.cu", "snappytpu/kernels/decode_vm2.py:378"),
        "decode_stream": ("snappytpu_torch/csrc/decode_stream.cu", "snappytpu/kernels/decode_vm2.py:492"),
        "decode_tape": ("snappytpu_torch/csrc/decode_tape.cu", "snappytpu/kernels/decode_tape.py:109"),
        "decode_tape_k": ("snappytpu_torch/csrc/decode_tape.cu", "snappytpu/kernels/decode_tape.py:214"),
    }
    if min(launches[name] for name in info) <= 0:
        raise AssertionError(f"a kernel never launched on its path: {launches}")
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": info[name][0], "replaces": info[name][1],
         "launches": launches[name], "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
