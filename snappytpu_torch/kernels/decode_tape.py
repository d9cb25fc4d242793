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
                      kernel, K5's A/B twin, resolves every byte's source
                      chain by pointer jumping instead of walking the records
  decode_blocks_tape  host rows -> tapes -> the device; -9 blocks are decoded
                      by K2 on the same device, -10 blocks report not ok

On a CUDA tensor the kernels in csrc/decode_tape.cu run (K5 on K2's grouped
mover, K6 on csrc/decode_resolve.cuh's resolver, with the record walk for
a hand-made tape whose records are not in ascending order); on a CPU
tensor the plain version below does.  A record that leaves the image, or a
copy whose source overlaps its destination, stops the walk and the block
reports not ok (never the builder's records; csrc/decode_tape.cuh says
why).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import hostbuf, profiling
from ..format import constants as C

from .decode_vm import decode_blocks_vm

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
COMP_OFF = 512                       # snappytpu/kernels/decode_vm2.py COMP_OFF
OUT_BASE = COMP_OFF + PAD_OUT        # 74240, decode_vm2.py OUT_BASE
IMAGE_BYTES = OUT_BASE + BS
PIECE_MAX = 504                      # the builder's longest record
TAPE_MAX = 12288                     # records per block, as the JAX package

# Counters (profiling.count), the CUDA route only: decode_tape.launches and
# decode_tape.k_launches, kernel launches by _run_tape and by _run_tape_k.


def build_tapes(comp_np: np.ndarray, comp_lens: np.ndarray, out_lens: np.ndarray, out=None):
    """Host tape build for a padded batch -> (tapes, nrecs) numpy arrays,
    written into `out`, a (tapes, nrecs) pair, where given."""
    from .. import cpu

    if not cpu.available:
        raise RuntimeError("native runtime unavailable; use decode_blocks_vm")
    return cpu.build_tapes(comp_np, comp_lens, out_lens, COMP_OFF, OUT_BASE, TAPE_MAX, out)


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


def _aligned(tapes, comp_u8):
    """Rows are read with 16-byte loads, records with 8-byte loads."""
    return (tapes if tapes.data_ptr() % 8 == 0 else tapes.clone(),
            comp_u8 if comp_u8.data_ptr() % 16 == 0 else comp_u8.clone())


def _launch(tapes, nrecs, comp_u8):
    """K5's kernel on a checked CUDA batch; an empty batch launches nothing.
    The caller counts launches."""
    from .._build import check, library

    B = comp_u8.shape[0]
    out = torch.empty((B, BS), dtype=torch.uint8, device=comp_u8.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp_u8.device)
    if B == 0:
        return out, ok
    tapes, comp_u8 = _aligned(tapes, comp_u8)
    with torch.cuda.device(comp_u8.device):
        rc = library().snappy_run_tape(
            tapes.data_ptr(), nrecs.data_ptr(), comp_u8.data_ptr(), out.data_ptr(), ok.data_ptr(),
            B, tapes.shape[1] // 2, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, "_run_tape")
    return out, ok


def _run_tape(tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor):
    """K5: execute each block's tape, on the device of the inputs."""
    tapes, nrecs, comp_u8 = _checked(tapes, nrecs, comp_u8)
    if comp_u8.device.type == "cpu":
        return run_tape_ref(tapes, nrecs, comp_u8)
    out = _launch(tapes, nrecs, comp_u8)
    if comp_u8.shape[0]:
        profiling.count("decode_tape.launches")
    return out


def _resolve_tapes(tapes, nrecs, comp_u8):
    """K6's kernel on a checked CUDA batch -> ((B, BS) uint8, (B,) bool ok,
    (B,) int32 rounds: the resolver's round count, -1 where the block ran
    the record walk); an empty batch launches nothing.  The caller counts
    launches."""
    from .._build import check, library

    B = comp_u8.shape[0]
    out = torch.empty((B, BS), dtype=torch.uint8, device=comp_u8.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp_u8.device)
    rounds = torch.empty(B, dtype=torch.int32, device=comp_u8.device)
    if B == 0:
        return out, ok, rounds
    tapes, comp_u8 = _aligned(tapes, comp_u8)
    with torch.cuda.device(comp_u8.device):
        rc = library().snappy_run_tape_k(
            tapes.data_ptr(), nrecs.data_ptr(), comp_u8.data_ptr(), out.data_ptr(), ok.data_ptr(),
            rounds.data_ptr(), B, tapes.shape[1] // 2, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, "_run_tape_k")
    return out, ok, rounds


def _run_tape_k(tapes: torch.Tensor, nrecs: torch.Tensor, comp_u8: torch.Tensor, K: int = 4):
    """K6: _run_tape with blocks taken K at a time; B must be a multiple of K."""
    tapes, nrecs, comp_u8 = _checked(tapes, nrecs, comp_u8)
    if K < 1 or comp_u8.shape[0] % K:
        raise ValueError(f"batch of {comp_u8.shape[0]} blocks is not a multiple of K={K}")
    if comp_u8.device.type == "cpu":
        return run_tape_ref(tapes, nrecs, comp_u8)
    out, ok, _rounds = _resolve_tapes(tapes, nrecs, comp_u8)
    if comp_u8.shape[0]:
        profiling.count("decode_tape.k_launches")
    return out, ok


def stage(comp_np: np.ndarray, tapes: np.ndarray, nrecs: np.ndarray, *, device):
    """Copy a batch's rows, its tapes cut to the longest tape's records, and
    nrecs to `device`, the tapes through this thread's staging buffer
    (hostbuf; pinned for a CUDA device).  Every copy is a new tensor."""
    S = max(int(nrecs.max(initial=0)), 1)
    staged = hostbuf.take("decode_tape.tapes", (tapes.shape[0], 2 * S), torch.int32, pinned=hostbuf.pinned_for(device))
    np.copyto(staged.numpy(), tapes[:, : 2 * S])
    return (staged.to(device, copy=True),
            torch.from_numpy(nrecs).to(device, copy=True),
            torch.from_numpy(comp_np).to(device, copy=True))


def decode_blocks_tape(comp_u8, comp_lens, out_lens, *, device):
    """Batched host-tape decode: (B, PAD_OUT) uint8 host rows + (B,) lens ->
    ((B, BS) uint8, (B,) bool) on `device`.  Blocks whose tape overflows
    TAPE_MAX are decoded by the block decoder K2 on the same device;
    malformed blocks report not ok.  Equal to decode_blocks_vm.  The tapes
    are built into this thread's host buffers (hostbuf)."""
    comp_np = np.ascontiguousarray(comp_u8, dtype=np.uint8)
    cl = np.ascontiguousarray(comp_lens, dtype=np.int32)
    ol = np.ascontiguousarray(out_lens, dtype=np.int32)
    B = comp_np.shape[0]
    with profiling.span("snappy.tape"):
        tapes, nrecs = build_tapes(comp_np, cl, ol, out=(
            hostbuf.take("decode_tape.build", (B, 2 * TAPE_MAX), torch.int32).numpy(),
            hostbuf.take("decode_tape.nrecs", (B,), torch.int32).numpy()))
    with profiling.span("snappy.h2d"):
        tp, nr, rows = stage(comp_np, tapes, nrecs, device=device)
    with profiling.span("snappy.decode"):
        out, ok = _run_tape(tp, nr, rows)
        fb = np.nonzero(nrecs == -9)[0]
        if fb.size:
            idx = torch.from_numpy(fb).to(device)
            out[idx], ok[idx] = decode_blocks_vm(rows[idx], torch.from_numpy(cl[fb]).to(device),
                                                 torch.from_numpy(ol[fb]).to(device))
    return out, ok
