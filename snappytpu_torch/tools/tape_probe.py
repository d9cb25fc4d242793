"""Tape probe (T3) — the counterpart of the JAX package's
tools/tape_probe.py: times K5, the tape decoder that ships (a producer warp
that loads, checks and hands over 32 records a step, and K2's mover warp),
with one part changed per mode, to find what sets K5's pace: the
producer's record loads, the mover's reads, its writes or its group syncs.

    python -m snappytpu_torch.tools.tape_probe [--modes full-D3] [--device cuda]

Modes (csrc/tape_probe.cu says what each changes): full-D1 (K5 exactly)
and full-D3 (the producer's loads three steps ahead), loads (the producer
alone: the mover folds each batch's records and moves nothing), const-dst
(the mover's reads and syncs, every record landing in one scratch area),
acc (a staged write window) and rowbatchK (the mover's groups cut every K
records, reads within a group resolved by address; K = 2, 4 or 8,
`rowbatch` is K = 4).  `probe` is the entry: on a CUDA tensor it launches
the kernel, on a CPU tensor it runs the plain version `probe_ref`; both
return per block the output region, the ok flag and 128 auxiliary words
(the record fold of `loads`, the scratch area of `const-dst`).  The exact
modes give K5's bytes, so their plain version is K5's (`run_tape_ref`).
The inputs are the text and mixed corpora's staged sets in tape form
(B = 128, four sets), as the JAX tool's; --modes is its
SNAPPYTPU_TAPE_MODE, and the verification it made by default runs here too
(exact modes against K5's plain version on set 0).
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ..format import constants as C
from ..profiling import count  # tape_probe.launches: kernel launches by probe (the CUDA route only)

from ..kernels.decode_tape import BS, OUT_BASE, PAD_OUT, _checked, image, records, run_tape_ref
from ._staged import best_per_batch, device_of, make_log, stage_sets

EXACT = ("full-D1", "full-D3", "acc", "rowbatch2", "rowbatch4", "rowbatch8")
MODES = EXACT + ("loads", "const-dst")
AUX = 128       # auxiliary words per block
SCRATCH = 512   # const-dst's fixed destination
B, NQ = 128, 4  # the JAX tool's batch and sets



def _mode(mode: str) -> tuple[int, int]:
    """A mode's (index, K) for the kernel."""
    if mode == "rowbatch":
        mode = "rowbatch4"
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} or 'rowbatch', got {mode!r}")
    if mode.startswith("rowbatch"):
        return 5, int(mode[8:])
    return ("full-D1", "full-D3", "loads", "const-dst", "acc").index(mode), 0


def _fold(src: int, dst: int, ln: int, p: int) -> int:
    """One record folded into a word (tape_probe.cu `fold_record`)."""
    return (src ^ (dst << 4) ^ (ln << 20) ^ (p << 28)) & 0xFFFFFFFF


def probe_ref(mode: str, tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor):
    """Plain version -> (out (B, BS) uint8, ok (B,) bool, aux (B, 128) int32)
    on the input's device.  Exact modes: K5's plain walk and zero aux.
    loads: no byte moves (a zero output region) and the XOR of the records'
    folds in aux word 0.  const-dst: no byte moves; aux holds the 512-byte
    scratch area after every record wrote its bytes, read from the image
    as staged, at the scratch's start."""
    _mode(mode)
    if mode not in ("loads", "const-dst"):
        out, ok = run_tape_ref(tapes, nrecs, comp_u8)
        return out, ok, torch.zeros((out.shape[0], AUX), dtype=torch.int32, device=out.device)
    tp = tapes.cpu().numpy()
    nr = nrecs.tolist()
    rows = comp_u8.cpu().numpy()
    cap = tp.shape[1] // 2
    n = rows.shape[0]
    ok = np.zeros(n, bool)
    aux = np.zeros((n, AUX), np.uint32)
    for b in range(n):
        m = min(max(nr[b], 0), cap)
        recs, ok[b] = records(tp[b, : 2 * m].tolist(), nr[b], cap)
        if mode == "loads":
            f = 0
            for r in recs:
                f ^= _fold(*r)
            aux[b, 0] = f
        else:
            img = image(rows[b].tobytes())
            scr = bytearray(SCRATCH)
            for src, dst, ln, p in recs:
                scr[:ln] = (img[dst - p : dst] * (ln // p + 1))[:ln] if p else img[src : src + ln]
            aux[b] = np.frombuffer(bytes(scr), "<u4")
    dev = comp_u8.device
    return (torch.zeros((n, BS), dtype=torch.uint8, device=dev), torch.from_numpy(ok).to(dev),
            torch.from_numpy(aux.view(np.int32)).to(dev))


def hazard_batch():
    """One block whose hand-made tape has records that, two to eight to a
    step, read or overwrite bytes an earlier record of the step wrote or
    read, and that move the write window backwards -> (tapes, nrecs, rows)
    numpy arrays.  The exact modes must decode it as K5's plain walk does."""
    rows = np.arange(PAD_OUT, dtype=np.uint64).astype(np.uint8).reshape(1, -1)
    ob = OUT_BASE

    def rec(src, dst, ln, pk2=0):
        return [src | (pk2 << 18) | (ln << 20), dst]

    tape = (rec(512, ob, 40) + rec(ob + 3, ob + 40, 30) + rec(0, ob + 70, 20, pk2=3)  # chained reads
            + rec(600, ob + 10, 8) + rec(ob + 8, ob + 200, 16)                        # a rewrite, then a read
            + rec(ob + 205, ob + 100, 5) + rec(700, ob + 205, 5)                      # a read, then its rewrite
            + rec(0, ob + 300, 9, pk2=1) + rec(ob + 520, ob + 1030, 60) + rec(ob + 1000, ob + 40, 12))
    return np.array([tape], np.int32), np.array([len(tape) // 2], np.int32), rows


def probe(mode: str, tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor):
    """One mode of the record walk over a batch, on the device of the inputs
    (see probe_ref for the outputs)."""
    idx, k = _mode(mode)
    tapes, nrecs, comp_u8 = _checked(tapes, nrecs, comp_u8)
    if comp_u8.device.type == "cpu":
        return probe_ref(mode, tapes, nrecs, comp_u8)
    from .._build import check, library

    n, dev = comp_u8.shape[0], comp_u8.device
    out = torch.empty((n, BS), dtype=torch.uint8, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    aux = torch.empty((n, AUX), dtype=torch.int32, device=dev)
    if n == 0:
        return out, ok, aux
    # rows are staged with 16-byte loads, records with 8-byte loads
    comp_u8 = comp_u8 if comp_u8.data_ptr() % 16 == 0 else comp_u8.clone()
    tapes = tapes if tapes.data_ptr() % 8 == 0 else tapes.clone()
    with torch.cuda.device(dev):
        rc = library().snappy_tape_probe(
            tapes.data_ptr(), nrecs.data_ptr(), comp_u8.data_ptr(), out.data_ptr(), ok.data_ptr(), aux.data_ptr(),
            n, tapes.shape[1] // 2, idx, k, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, f"tape_probe {mode}")
    count("tape_probe.launches")
    return out, ok, aux


def k5_split(ms: dict) -> dict:
    """K5's time per batch split by the modes (ms per batch, full-D1 is K5):
    `loads` is the producer (loads, checks, conversion, hand-over) with a
    mover that moves nothing; const-dst − loads the mover's reads and group
    syncs; full-D1 − const-dst its writes at the records' addresses (with
    what joining saves: const-dst moves every record of a run that K5
    joins); full-D1 − full-D3 what loading three steps ahead saves;
    full-D1 − rowbatch8 what a sync per 8 records instead of per group
    saves."""
    return {"producer + hand-over (loads)": ms["loads"],
            "mover reads+syncs (const-dst - loads)": ms["const-dst"] - ms["loads"],
            "mover writes (full-D1 - const-dst)": ms["full-D1"] - ms["const-dst"],
            "load-ahead 3 saves (full-D1 - full-D3)": ms["full-D1"] - ms["full-D3"],
            "syncs every 8 save (full-D1 - rowbatch8)": ms["full-D1"] - ms["rowbatch8"]}


def probe_ms(mode: str, sets) -> float:
    """Milliseconds per batch of one mode over staged tape sets, best of 3."""
    return best_per_batch(lambda t, n, c: probe(mode, t, n, c), sets) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="full-D3", help=f"comma list of {', '.join(MODES)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    modes = args.modes.split(",")
    for m in modes:
        _mode(m)
    log = make_log()

    log(f"device {dev} ({args.device}) modes={args.modes}")
    for which in ("text", "mixed"):
        sets = stage_sets(which, B, NQ, dev, tape=True)
        log(f"{which}: staged")
        ref = None
        ms = {}
        for mode in modes:
            if mode not in ("loads", "const-dst"):
                out, ok, _ = probe(mode, *sets[0])
                if ref is None:
                    ref = run_tape_ref(*sets[0])
                if not (torch.equal(ok, ref[1]) and torch.equal(out, ref[0])):
                    raise AssertionError(f"{which}/{mode}: output differs from K5's plain version")
                log(f"{which} {mode}: byte-equal to K5's plain version")
            best = probe_ms(mode, sets) / 1e3
            ms[mode] = best * 1e3
            log(f"{which:6s} {mode:9s} {best * 1000:8.2f} ms/batch  {B * C.MAX_BLOCK_SIZE / 1e6 / best:7.1f} MB/s")
        if set(MODES) <= set(ms):
            log(f"{which:6s} " + ", ".join(f"{k} {v:.3f}" for k, v in k5_split(ms).items()) + " ms/batch")
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
