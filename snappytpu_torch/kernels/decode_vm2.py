"""Decode VM v2 — K3 and K4, the counterparts of snappytpu.kernels.decode_vm2.

`decode_blocks_vm2` (K3) is the JAX package's unpipelined block decoder,
kept there for A/B against K2.  It computes the same function as K2; on
Hopper it is K2's walk without the pipeline (one warp, one op at a time,
csrc/decode_block.cu `decode_blocks_vm2_kernel`), with its own launch
count; its plain version is K2's.

`decode_stream_vm` (K4) decodes N op chunks of a stream whose ops straddle
the 64 KiB output grid, in order, with a sliding 64 KiB context:
(N, 73728) uint8 rows + (N,) int32 comp_lens, out_lens (<= 65536) and
ctx_lens (bytes of earlier output chunk i's copies may reach) + (65536,)
uint8 ctx0 (the output before chunk 0, right-aligned) -> ((N, 65536) uint8
rows, (N,) bool ok).  On a CUDA tensor the two kernels in
csrc/decode_stream.cu run, one call each: K4a parses every chunk at once
into records (_stream_parse), K4b moves them chunk by chunk
(_stream_move); on a CPU tensor the plain version below does.

Contract (the JAX kernel's): a chunk is ok under K2's rule, with copies
allowed ctx_lens[i] bytes before the chunk's output; the window slides by
out_len after every chunk with 0 < out_len <= 65536, ok or not.  ctx_lens
are clamped to [0, 65536], the context the window holds.  An ok row is
zero past out_len; a row is part of the contract where its chunk and every
chunk before it are ok.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .decode_vm4 import BS, PAD_OUT, _decode_into, _launch, checked, decode_blocks_ref

launches = 0         # kernel launches by decode_blocks_vm2 (the CUDA route only)
stream_launches = 0  # kernel launches by decode_stream_vm (the CUDA route only)


def decode_blocks_vm2(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """Batched block decode on the v2 entry point: (B, PAD_OUT) uint8 +
    (B,) int32 x2 -> ((B, BS) uint8, (B,) bool); equal to decode_blocks_vm4."""
    global launches
    comp_u8, comp_lens, out_lens = checked(comp_u8, comp_lens, out_lens)
    if comp_u8.device.type == "cpu":
        return decode_blocks_ref(comp_u8, comp_lens, out_lens)
    out = _launch(comp_u8, comp_lens, out_lens, "decode_blocks_vm2", "snappy_decode_blocks_vm2")
    if comp_u8.shape[0]:
        launches += 1
    return out


def decode_stream_ref(comp_u8, comp_lens, out_lens, ctx_lens, ctx0_u8):
    """Plain version: the chunks' ops in a Python loop over a host buffer of
    the 64 KiB window followed by the chunk's output; results land on the
    input's device."""
    rows = comp_u8.cpu().numpy()
    cl, ol, xl = comp_lens.tolist(), out_lens.tolist(), ctx_lens.tolist()
    window = bytearray(ctx0_u8.cpu().numpy().tobytes())
    out = np.zeros((rows.shape[0], BS), np.uint8)
    ok = np.zeros(rows.shape[0], bool)
    for i in range(rows.shape[0]):
        buf = window + bytearray(BS)
        ok[i] = _decode_into(buf, BS, rows[i].tobytes() + bytes(8), cl[i], ol[i], min(max(xl[i], 0), BS))
        out[i] = np.frombuffer(buf, np.uint8, count=BS, offset=BS)
        if 0 < ol[i] <= BS:
            window = buf[ol[i] : ol[i] + BS]
    dev = comp_u8.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(ok).to(dev)


REC_CAP = PAD_OUT // 2  # records per chunk: an op takes two comp bytes or more


def _stream_parse(comp_u8, comp_lens, out_lens, ctx_lens):
    """K4a on a checked call of N > 0 chunks -> ((N, REC_CAP, 4) int32
    records, (N,) int32 counts, (N,) bool ok)."""
    from .._build import check, library

    N, dev = comp_u8.shape[0], comp_u8.device
    recs = torch.empty((N, REC_CAP, 4), dtype=torch.int32, device=dev)
    nrecs = torch.empty(N, dtype=torch.int32, device=dev)
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = library().snappy_decode_stream_parse(
            comp_u8.data_ptr(), comp_lens.data_ptr(), out_lens.data_ptr(), ctx_lens.data_ptr(), recs.data_ptr(),
            nrecs.data_ptr(), ok.data_ptr(), N, REC_CAP, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, "decode_stream_vm (parse)")
    return recs, nrecs, ok


def _stream_move(comp_u8, comp_lens, out_lens, ctx0_u8, recs, nrecs):
    """K4b: _stream_parse's records of a checked call moved chunk by chunk
    -> (N, BS) uint8 rows."""
    from .._build import check, library

    N = comp_u8.shape[0]
    out = torch.empty((N, BS), dtype=torch.uint8, device=comp_u8.device)
    with torch.cuda.device(comp_u8.device):
        rc = library().snappy_decode_stream_move(
            comp_u8.data_ptr(), comp_lens.data_ptr(), out_lens.data_ptr(), ctx0_u8.data_ptr(), recs.data_ptr(),
            nrecs.data_ptr(), out.data_ptr(), N, REC_CAP, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, "decode_stream_vm (move)")
    return out


def _launch_stream(comp_u8, comp_lens, out_lens, ctx_lens, ctx0_u8):
    """Run K4a then K4b on a checked call; no chunks launch nothing.  The
    caller counts launches."""
    N = comp_u8.shape[0]
    if N == 0:
        return (torch.empty((0, BS), dtype=torch.uint8, device=comp_u8.device),
                torch.empty(0, dtype=torch.bool, device=comp_u8.device))
    # the kernels stage rows and ctx0 with 16-byte loads
    comp_u8 = comp_u8 if comp_u8.data_ptr() % 16 == 0 else comp_u8.clone()
    ctx0_u8 = ctx0_u8 if ctx0_u8.data_ptr() % 16 == 0 else ctx0_u8.clone()
    recs, nrecs, ok = _stream_parse(comp_u8, comp_lens, out_lens, ctx_lens)
    return _stream_move(comp_u8, comp_lens, out_lens, ctx0_u8, recs, nrecs), ok


def decode_stream_vm(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor,
                     ctx_lens: torch.Tensor, ctx0_u8: torch.Tensor):
    """Sequential windowed decode of N op chunks, on the device of the
    inputs (see the module docstring for the contract)."""
    global stream_launches
    comp_u8, comp_lens, out_lens = checked(comp_u8, comp_lens, out_lens)
    N = comp_u8.shape[0]
    if ctx_lens.shape != (N,) or ctx_lens.device != comp_u8.device:
        raise ValueError(f"ctx_lens must be ({N},) on the rows' device")
    if ctx0_u8.dtype != torch.uint8 or ctx0_u8.shape != (BS,) or ctx0_u8.device != comp_u8.device:
        raise ValueError(f"ctx0 must be ({BS},) uint8 on the rows' device")
    ctx_lens = ctx_lens.to(torch.int32).contiguous()
    ctx0_u8 = ctx0_u8.contiguous()
    if comp_u8.device.type == "cpu":
        return decode_stream_ref(comp_u8, comp_lens, out_lens, ctx_lens, ctx0_u8)
    out = _launch_stream(comp_u8, comp_lens, out_lens, ctx_lens, ctx0_u8)
    if N:
        stream_launches += 1
    return out
