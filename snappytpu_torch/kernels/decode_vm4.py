"""Block decoder — K2, the counterpart of snappytpu.kernels.decode_vm4.

`decode_blocks_vm4` decodes a batch of independent Snappy blocks:
(B, 73728) uint8 compressed rows + (B,) int32 comp_lens + (B,) int32 out_lens
-> ((B, 65536) uint8 rows, (B,) bool ok).  On a CUDA tensor the hand-written
kernel in csrc/decode_block.cu runs (the parse -> move pipeline of
csrc/decode_pipe.cuh: a sizer, a judge and a mover warp handing windows and
records over in batches, the Hopper form of the JAX kernel's software
pipeline); on a CPU tensor the plain version below does, and nothing else
chooses between them.  A failed build or launch raises.

Contract (the JAX decoder's): a block is ok iff no op is malformed and its
ops end exactly at comp_len and out_len; zero-length pad blocks are ok; the
bytes of an ok row past out_len are zero.  For a block that is not ok only
the flag is part of the contract.  csrc/decode_block.cuh lists the accept
set; `_parse_at` below is the same rules in Python, and serves the
windowed decoder (decode_vm2.py) too, with ctx_len > 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..format import constants as C

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE

launches = 0  # kernel launches by decode_blocks_vm4 (the CUDA route only)


def _parse_at(row: bytes, ip: int, opc: int, comp_len: int, out_len: int, ctx_len: int = 0):
    """Op at comp byte ip -> (hdr, len, dist [0 => literal], bad).  `row`
    carries 8 zero bytes past the 73728-byte row, so reads never run off.
    A copy may reach ctx_len bytes before the block's output."""
    tag, b1, b2, b3, b4 = row[ip : ip + 5]
    kind, code = tag & 3, tag >> 2
    if kind == C.TAG_LITERAL:
        extra = max(code - (C.LITERAL_CODE_1BYTE - 1), 0)
        hdr = 1 + extra
        ln = (code if extra == 0 else int.from_bytes(bytes([b1, b2, b3, b4 & 0x3F][:extra]), "little")) + 1
        bad = ip + hdr + ln > comp_len or (extra == 4 and b4 & 0xC0 != 0)
        d = 0
    else:
        if kind == C.TAG_COPY1:
            hdr, ln, d = 2, (code & 7) + 4, ((code >> 3) << 8) | b1
        elif kind == C.TAG_COPY2:
            hdr, ln, d = 3, code + 1, b1 | (b2 << 8)
        else:
            hdr, ln, d = 5, code + 1, b1 | (b2 << 8) | (b3 << 16)
        bad = d < 1 or d > opc + ctx_len or (kind == C.TAG_COPY4 and b4 != 0)
    bad = bad or ip + hdr > comp_len or opc + ln > out_len
    return hdr, ln, d, bad


def _decode_into(out: bytearray, base: int, row: bytes, comp_len: int, out_len: int, ctx_len: int = 0) -> bool:
    """One block's ops in order, writing out[base:base + out_len]; copies may
    read ctx_len bytes before base.  Returns the ok flag."""
    if not (0 <= comp_len <= PAD_OUT and 0 <= out_len <= BS):
        return False
    ip = opc = 0
    while opc < out_len and ip < comp_len:
        hdr, ln, d, bad = _parse_at(row, ip, opc, comp_len, out_len, ctx_len)
        if bad:
            return False
        at = base + opc
        if d == 0:
            out[at : at + ln] = row[ip + hdr : ip + hdr + ln]
            ip += hdr + ln
        else:
            period = out[at - d : at - d + min(d, ln)]
            out[at : at + ln] = (period * (ln // len(period) + 1))[:ln]
            ip += hdr
        opc += ln
    return ip == comp_len and opc == out_len


def _decode_row(row: bytes, comp_len: int, out_len: int):
    """One block, op by op -> (bytearray of BS bytes, ok)."""
    out = bytearray(BS)
    return out, _decode_into(out, 0, row, comp_len, out_len)


def decode_blocks_ref(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """Plain version: a Python loop over each block's ops on a host copy of
    the rows, moving bytes by slice copies.  Slow but clear; results land
    on the input's device."""
    rows = comp_u8.cpu().numpy()
    cl = comp_lens.cpu().tolist()
    ol = out_lens.cpu().tolist()
    out = np.zeros((rows.shape[0], BS), np.uint8)
    ok = np.zeros(rows.shape[0], bool)
    for b in range(rows.shape[0]):
        data, ok[b] = _decode_row(rows[b].tobytes() + bytes(8), cl[b], ol[b])
        out[b] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(out).to(comp_u8.device), torch.from_numpy(ok).to(comp_u8.device)


def _launch(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor, what: str,
            entry: str = "snappy_decode_blocks"):
    """Run a CUDA block decoder of csrc/decode_block.cu (`entry`: K2's
    pipelined kernel, or K3's) on a checked batch; an empty batch launches
    nothing.  The caller counts launches."""
    from .._build import check, library

    B = comp_u8.shape[0]
    out = torch.empty((B, BS), dtype=torch.uint8, device=comp_u8.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp_u8.device)
    if B == 0:
        return out, ok
    if comp_u8.data_ptr() % 16:  # the kernel stages rows with 16-byte loads
        comp_u8 = comp_u8.clone()
    with torch.cuda.device(comp_u8.device):
        rc = getattr(library(), entry)(
            comp_u8.data_ptr(), comp_lens.data_ptr(), out_lens.data_ptr(),
            out.data_ptr(), ok.data_ptr(), B,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, what)
    return out, ok


def checked(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """Validate a block batch and make it contiguous int32/uint8."""
    if comp_u8.dtype != torch.uint8 or comp_u8.dim() != 2 or comp_u8.shape[1] != PAD_OUT:
        raise ValueError(f"comp must be (B, {PAD_OUT}) uint8, got {tuple(comp_u8.shape)} {comp_u8.dtype}")
    B = comp_u8.shape[0]
    for name, t in (("comp_lens", comp_lens), ("out_lens", out_lens)):
        if t.shape != (B,) or t.device != comp_u8.device:
            raise ValueError(f"{name} must be ({B},) on the rows' device")
    if comp_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode route for device {comp_u8.device}")
    return comp_u8.contiguous(), comp_lens.to(torch.int32).contiguous(), out_lens.to(torch.int32).contiguous()


def decode_blocks_vm4(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """Batched block decode: (B, PAD_OUT) uint8 + (B,) int32 x2 ->
    ((B, BS) uint8, (B,) bool), on the device of the inputs."""
    global launches
    comp_u8, comp_lens, out_lens = checked(comp_u8, comp_lens, out_lens)
    if comp_u8.device.type == "cpu":
        return decode_blocks_ref(comp_u8, comp_lens, out_lens)
    out = _launch(comp_u8, comp_lens, out_lens, "decode_blocks_vm4")
    if comp_u8.shape[0]:
        launches += 1
    return out
