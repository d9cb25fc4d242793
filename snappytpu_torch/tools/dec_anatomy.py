"""Decode anatomy probe (T2) — the counterpart of the JAX package's
tools/dec_anatomy.py: times stripped variants of the block decoder's op walk
(K3's, one op at a time; K2 pipelines the same rules) to attribute its
per-batch time to the parse, the window read, the write and dynamic
addressing.

    python -m snappytpu_torch.tools.dec_anatomy [--b 128] [--nq 4]
        [--corpus text] [--variants parse,window,full,fixed] [--device cuda]

csrc/dec_anatomy.cu says what each variant strips.  `anatomy` is the entry:
on a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
walk `anatomy_ref`; both return, per block, the output image after the walk,
K2's ok flag, the final output cursor (the TPU tool's ok tile) and the fold
of the bytes read.  The inputs are dec_profile's staged sets (_staged.py),
keyed by the encoder's hash, which replaces the JAX tool's
SNAPPYTPU_DEC_CACHETAG.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from ..format import constants as C

from ..kernels.decode_vm4 import BS, PAD_OUT, _parse_at, checked
from ._staged import MAKERS, best_per_batch, device_of, stage_sets

VARIANTS = ("parse", "window", "full", "fixed")
FIXED_SRC = 64  # fixed's source: compressed byte 64 (the TPU tool's COMP_OFF + 64)

launches = 0  # kernel launches by anatomy (the CUDA route only)


def _lane_fold(b: np.ndarray) -> int:
    """XOR of bytes b[j] << 8 * (j & 3): the fold of bytes read for
    destinations 0, 1, ..."""
    sh = (8 * (np.arange(b.size) & 3)).astype(np.uint32)
    return int(np.bitwise_xor.reduce(b.astype(np.uint32) << sh, initial=0))


def _walk(row: bytes, comp_len: int, out_len: int):
    """One block under every variant at once -> (full image, fixed image,
    ok, final cursor, window fold, fixed fold)."""
    full = bytearray(BS)
    fixed = bytearray(BS)
    comp = np.frombuffer(row, np.uint8)
    src = comp[FIXED_SRC:]
    pre = np.concatenate([[0], np.bitwise_xor.accumulate(
        src[:BS].astype(np.uint32) << (8 * (np.arange(BS) & 3)).astype(np.uint32))])
    lit = np.zeros(BS, bool)
    ffold = 0
    ip = opc = 0
    ok = 0 <= comp_len <= PAD_OUT and 0 <= out_len <= BS
    while ok and opc < out_len and ip < comp_len:
        hdr, ln, d, bad = _parse_at(row, ip, opc, comp_len, out_len)
        if bad:
            ok = False
            break
        if d == 0:
            full[opc : opc + ln] = row[ip + hdr : ip + hdr + ln]
            lit[opc : opc + ln] = True
            ip += hdr + ln
        else:
            period = full[opc - d : opc - d + min(d, ln)]
            full[opc : opc + ln] = (period * (ln // len(period) + 1))[:ln]
            ip += hdr
        if d == 0 or d >= ln:
            fixed[:ln] = src[:ln].tobytes()
            ffold ^= int(pre[ln])
        else:
            b = src[np.arange(ln) % d]
            fixed[:ln] = b.tobytes()
            ffold ^= _lane_fold(b)
        opc += ln
    ok = ok and ip == comp_len and opc == out_len
    words = np.where(lit, np.frombuffer(full, np.uint8), 0).astype(np.uint8).view("<u4")
    wfold = int(np.bitwise_xor.reduce(words, initial=0))
    return full, fixed, ok, opc, wfold, ffold


def walk_ref(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor) -> dict:
    """Plain version of every variant from one Python walk over each
    block's ops, on a host copy of the rows -> {variant: (image (B, BS)
    uint8, ok (B,) bool, opc (B,) int32, fold (B,) int32)} on the input's
    device.  The image is zero for parse and window, the decoded row for
    full and the fixed area for fixed; the fold is the XOR of every byte
    read at byte lane (destination & 3), zero for parse and full."""
    rows = comp_u8.cpu().numpy()
    cl, ol = comp_lens.tolist(), out_lens.tolist()
    B = rows.shape[0]
    full = np.zeros((B, BS), np.uint8)
    fixed = np.zeros((B, BS), np.uint8)
    ok = np.zeros(B, bool)
    opc = np.zeros(B, np.int32)
    folds = np.zeros((2, B), np.uint32)
    for b in range(B):
        f, x, ok[b], opc[b], folds[0, b], folds[1, b] = _walk(rows[b].tobytes() + bytes(8), cl[b], ol[b])
        full[b] = np.frombuffer(f, np.uint8)
        fixed[b] = np.frombuffer(x, np.uint8)
    dev = comp_u8.device
    zero_img, zero_fold = np.zeros_like(full), np.zeros(B, np.uint32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return {v: (t(img), t(ok), t(opc), t(fold.view(np.int32)))
            for v, img, fold in (("parse", zero_img, zero_fold), ("window", zero_img, folds[0]),
                                 ("full", full, zero_fold), ("fixed", fixed, folds[1]))}


def anatomy_ref(variant: str, comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """Plain version of one variant (see walk_ref)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return walk_ref(comp_u8, comp_lens, out_lens)[variant]


def anatomy(variant: str, comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """One variant of the walk over a batch, on the device of the inputs
    (see anatomy_ref for the outputs)."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    comp_u8, comp_lens, out_lens = checked(comp_u8, comp_lens, out_lens)
    if comp_u8.device.type == "cpu":
        return anatomy_ref(variant, comp_u8, comp_lens, out_lens)
    from .._build import check, library

    B, dev = comp_u8.shape[0], comp_u8.device
    img = torch.empty((B, BS), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    opc = torch.empty(B, dtype=torch.int32, device=dev)
    fold = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return img, ok, opc, fold
    if comp_u8.data_ptr() % 16:  # the kernel stages rows with 16-byte loads
        comp_u8 = comp_u8.clone()
    with torch.cuda.device(dev):
        rc = library().snappy_dec_anatomy(
            comp_u8.data_ptr(), comp_lens.data_ptr(), out_lens.data_ptr(), img.data_ptr(), ok.data_ptr(),
            opc.data_ptr(), fold.data_ptr(), B, VARIANTS.index(variant),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, f"dec_anatomy {variant}")
    launches += 1
    return img, ok, opc, fold


def anatomy_ms(variant: str, sets) -> float:
    """Milliseconds per batch of one variant over staged sets, best of 3."""
    return best_per_batch(lambda c, t, n: anatomy(variant, c, t, n), sets) * 1e3


def attribution(ms: dict) -> dict:
    """The differences that attribute the full walk's time (ms per batch)."""
    return {"parse": ms["parse"], "window - parse": ms["window"] - ms["parse"],
            "full - window": ms["full"] - ms["window"], "full - fixed": ms["full"] - ms["fixed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128, help="blocks per set")
    ap.add_argument("--nq", type=int, default=4, help="sets per corpus")
    ap.add_argument("--corpus", default="text", help=f"comma list of {', '.join(MAKERS)}")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t0 = time.time()

    def log(m):
        print(f"[{time.time() - t0:6.1f}s] {m}", flush=True)

    log(f"device {dev} ({args.device})")
    for which in args.corpus.split(","):
        sets = stage_sets(which, args.b, args.nq, dev)
        log(f"{which}: staged")
        ms = {}
        for variant in args.variants.split(","):
            ms[variant] = anatomy_ms(variant, sets)
            best = ms[variant] / 1e3
            log(f"{which:7s} {variant:7s} {best * 1000:8.2f} ms/batch  "
                f"{args.b * C.MAX_BLOCK_SIZE / 1e6 / best:7.1f} MB/s")
        if set(VARIANTS) <= set(ms):
            log(f"{which:7s} " + ", ".join(f"{k} {v:.3f}" for k, v in attribution(ms).items()) + " ms/batch")
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
