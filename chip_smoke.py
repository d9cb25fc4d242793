#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (snappytpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, then drives the port's main path at full size:
a 32 MB mixed corpus (512 blocks of 64 KiB) encoded on the card with both
profiles in batches of 128 blocks (torch ops + the concat kernel K1), decoded
on the card by the block decoder K2, and compared block by block with the
input on the device.  It then runs the user API with device="cuda".

Phases print their own lines.  Before the last line it prints the card's
name and power limit (nvidia-smi) and one JSON line with each kernel's
launches on the main path, error against its plain version and times; the
last line is {"ok": true, "device": {...}}.  Any failure raises and the
script exits non-zero; it refuses to run without CUDA.  Needs no JAX.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 128
MAIN_MB = 32


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
    from snappytpu_torch import _build, api
    from snappytpu_torch.kernels import concat, decode_vm4
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

    # ---- 7. report ----
    info = {
        "concat": ("snappytpu_torch/csrc/concat.cu", "snappytpu/kernels/concat.py:64"),
        "decode_block": ("snappytpu_torch/csrc/decode_block.cu", "snappytpu/kernels/decode_vm4.py:259"),
    }
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
