"""Movement-only tape decoder — K5 and K6, the counterparts of
snappytpu.kernels.decode_tape.

The host tape builder (cpu.build_tapes, the port's copy of the JAX
package's native runtime) parses and validates each block and writes the
byte movements the decoder would make as records; the device only executes them.  The records
address the JAX package's unified image (COMP_OFF, OUT_BASE below), and
csrc/decode_tape.cuh states their format.

  build_tapes         host tapes for a padded batch: ((B, 2*TAPE_MAX) int32,
                      (B,) int32 nrecs); nrecs -9 = tape overflow (a legal
                      stream), -10 = malformed
  _run_tape (K5)      (B, 2*S) int32 tapes + (B,) nrecs + (B, 73728) uint8
                      rows -> ((B, 65536) uint8, (B,) bool ok = nrecs >= 0)
  _run_tape_k (K6)    the same with the JAX package's K blocks per grid step;
                      B % K == 0.  On Hopper independent blocks already run
                      in separate thread blocks, so K is only checked; its
                      kernel keeps the record-by-record walk, K5's A/B
                      yardstick
  decode_blocks_tape  host rows -> tapes -> the device; -9 blocks are decoded
                      by K2 on the same device, -10 blocks report not ok

On a CUDA tensor the kernels in csrc/decode_tape.cu run (K5 on K2's grouped
mover, K6 record by record); on a CPU tensor the plain version below does.  A record that leaves the image, or a copy whose
source overlaps its destination, stops the walk and the block reports not
ok (never the builder's records; csrc/decode_tape.cuh says why).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..format import constants as C

from .decode_vm import decode_blocks_vm

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
COMP_OFF = 512                       # snappytpu/kernels/decode_vm2.py COMP_OFF
OUT_BASE = COMP_OFF + PAD_OUT        # 74240, decode_vm2.py OUT_BASE
IMAGE_BYTES = OUT_BASE + BS
PIECE_MAX = 504                      # the builder's longest record
TAPE_MAX = 12288                     # records per block, as the JAX package

launches = 0    # kernel launches by _run_tape (the CUDA route only)
k_launches = 0  # kernel launches by _run_tape_k (the CUDA route only)


def build_tapes(comp_np: np.ndarray, comp_lens: np.ndarray, out_lens: np.ndarray):
    """Host tape build for a padded batch -> (tapes, nrecs) numpy arrays."""
    from .. import cpu

    if not cpu.available:
        raise RuntimeError("native runtime unavailable; use decode_blocks_vm")
    return cpu.build_tapes(comp_np, comp_lens, out_lens, COMP_OFF, OUT_BASE, TAPE_MAX)


def records(tape: list, nr: int, cap: int):
    """One block's records as decode_tape.cuh's walk accepts them -> (list of
    (src, dst, len, period), ok): the records before the first one outside
    the image (or an overlapping copy), and whether there was none and
    0 <= nr <= cap."""
    if not 0 <= nr <= cap:
        return [], False
    out = []
    for r in range(nr):
        w0, dst = tape[2 * r] & 0xFFFFFFFF, tape[2 * r + 1]
        src, ln, p = w0 & 0x3FFFF, w0 >> 20, (0, 1, 2, 4)[(w0 >> 18) & 3]
        if ln > PIECE_MAX or dst < 0 or dst + ln > IMAGE_BYTES:
            return out, False
        if p and dst < p:
            return out, False
        if not p and (src + ln > IMAGE_BYTES or (src < dst + ln and dst < src + ln)):  # outside, or overlapping
            return out, False
        out.append((src, dst, ln, p))
    return out, True


def image(row: bytes) -> bytearray:
    """A block's unified image before its first record."""
    img = bytearray(IMAGE_BYTES)
    img[COMP_OFF:OUT_BASE] = row
    return img


def _run_row(tape: list, nr: int, row: bytes, cap: int):
    """One block's records in order -> (bytearray of BS bytes, ok)."""
    img = image(row)
    recs, ok = records(tape, nr, cap)
    for src, dst, ln, p in recs:
        if p:
            img[dst : dst + ln] = (img[dst - p : dst] * (ln // p + 1))[:ln]
        else:
            img[dst : dst + ln] = img[src : src + ln]
    return img[OUT_BASE:], ok


def run_tape_ref(tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor):
    """Plain version: each block's records in a Python loop over a host copy
    of its image, moving bytes by slice copies; results land on the input's
    device."""
    tp = tapes.cpu().numpy()
    nr = nrecs.tolist()
    rows = comp_u8.cpu().numpy()
    cap = tp.shape[1] // 2
    out = np.zeros((rows.shape[0], BS), np.uint8)
    ok = np.zeros(rows.shape[0], bool)
    for b in range(rows.shape[0]):
        n = min(max(nr[b], 0), cap)
        data, ok[b] = _run_row(tp[b, : 2 * n].tolist(), nr[b], rows[b].tobytes(), cap)
        out[b] = np.frombuffer(data, np.uint8)
    dev = comp_u8.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(ok).to(dev)


def _checked(tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor):
    if comp_u8.dtype != torch.uint8 or comp_u8.dim() != 2 or comp_u8.shape[1] != PAD_OUT:
        raise ValueError(f"comp must be (B, {PAD_OUT}) uint8, got {tuple(comp_u8.shape)} {comp_u8.dtype}")
    B = comp_u8.shape[0]
    if tapes.dtype != torch.int32 or tapes.dim() != 2 or tapes.shape[0] != B or tapes.shape[1] % 2:
        raise ValueError(f"tapes must be ({B}, 2*S) int32, got {tuple(tapes.shape)} {tapes.dtype}")
    if nrecs.shape != (B,):
        raise ValueError(f"nrecs must be ({B},)")
    if not (tapes.device == nrecs.device == comp_u8.device):
        raise ValueError("tapes, nrecs and rows must be on one device")
    if comp_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no tape route for device {comp_u8.device}")
    return tapes.contiguous(), nrecs.to(torch.int32).contiguous(), comp_u8.contiguous()


def _launch(tapes, nrecs, comp_u8, what: str, entry: str):
    """Run the CUDA tape kernel `entry` on a checked batch; an empty batch
    launches nothing.  The caller counts launches."""
    from .._build import check, library

    B = comp_u8.shape[0]
    out = torch.empty((B, BS), dtype=torch.uint8, device=comp_u8.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp_u8.device)
    if B == 0:
        return out, ok
    # rows are staged with 16-byte loads, records with 8-byte loads
    comp_u8 = comp_u8 if comp_u8.data_ptr() % 16 == 0 else comp_u8.clone()
    tapes = tapes if tapes.data_ptr() % 8 == 0 else tapes.clone()
    with torch.cuda.device(comp_u8.device):
        rc = getattr(library(), entry)(
            tapes.data_ptr(), nrecs.data_ptr(), comp_u8.data_ptr(), out.data_ptr(), ok.data_ptr(),
            B, tapes.shape[1] // 2, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, what)
    return out, ok


def _run_tape(tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor):
    """K5: execute each block's tape, on the device of the inputs."""
    global launches
    tapes, nrecs, comp_u8 = _checked(tapes, nrecs, comp_u8)
    if comp_u8.device.type == "cpu":
        return run_tape_ref(tapes, nrecs, comp_u8)
    out = _launch(tapes, nrecs, comp_u8, "_run_tape", "snappy_run_tape")
    if comp_u8.shape[0]:
        launches += 1
    return out


def _run_tape_k(tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor, K: int = 4):
    """K6: _run_tape with blocks taken K at a time; B must be a multiple of K."""
    global k_launches
    tapes, nrecs, comp_u8 = _checked(tapes, nrecs, comp_u8)
    if K < 1 or comp_u8.shape[0] % K:
        raise ValueError(f"batch of {comp_u8.shape[0]} blocks is not a multiple of K={K}")
    if comp_u8.device.type == "cpu":
        return run_tape_ref(tapes, nrecs, comp_u8)
    out = _launch(tapes, nrecs, comp_u8, "_run_tape_k", "snappy_run_tape_k")
    if comp_u8.shape[0]:
        k_launches += 1
    return out


def stage(comp_np: np.ndarray, tapes: np.ndarray, nrecs: np.ndarray, *, device):
    """Copy a batch's rows, its tapes cut to the longest tape's records, and
    nrecs to `device`."""
    S = max(int(nrecs.max(initial=0)), 1)
    return (torch.from_numpy(np.ascontiguousarray(tapes[:, : 2 * S])).to(device),
            torch.from_numpy(nrecs).to(device),
            torch.from_numpy(comp_np).to(device))


def decode_blocks_tape(comp_u8, comp_lens, out_lens, *, device):
    """Batched host-tape decode: (B, PAD_OUT) uint8 host rows + (B,) lens ->
    ((B, BS) uint8, (B,) bool) on `device`.  Blocks whose tape overflows
    TAPE_MAX are decoded by the block decoder K2 on the same device;
    malformed blocks report not ok.  Equal to decode_blocks_vm."""
    comp_np = np.ascontiguousarray(comp_u8, dtype=np.uint8)
    cl = np.ascontiguousarray(comp_lens, dtype=np.int32)
    ol = np.ascontiguousarray(out_lens, dtype=np.int32)
    tapes, nrecs = build_tapes(comp_np, cl, ol)
    tp, nr, rows = stage(comp_np, tapes, nrecs, device=device)
    out, ok = _run_tape(tp, nr, rows)
    fb = np.nonzero(nrecs == -9)[0]
    if fb.size:
        idx = torch.from_numpy(fb).to(device)
        out[idx], ok[idx] = decode_blocks_vm(rows[idx], torch.from_numpy(cl[fb]).to(device),
                                             torch.from_numpy(ol[fb]).to(device))
    return out, ok
