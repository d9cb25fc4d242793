"""The v1 parallel-scan block decoder as torch ops — the counterpart of
snappytpu.kernels.decode_jax.

The JAX module's docstring explains the algorithm: a speculative op parse at
every byte offset (_op_table), a pointer-doubling walk of the true op chain
from offset 0 whose landing on comp_len is the validity check (_op_starts),
and a pointer-doubling resolution of every output byte to its literal
origin (_chain).  The port is batched over (B, PAD_OUT) from the start (the
JAX module is per block under `vmap`), carries every index as int64, clamps
gathers and sinks out-of-range scatters as JAX does (encode_jax.py), and
splits decode_block_device's body into the stages the staged pipeline
(kernels/pipeline.py) names.  The JAX pipeline's decoder does 3 x 6 walk
and chain rounds where decode_jax does 17, and clips the landing index to
PAD_OUT + 127 where decode_jax clips it to PAD_OUT; neither changes a row
or a flag (both loops have saturated after 17 rounds, and the sentinel
offsets past PAD_OUT are reached only through PAD_OUT), so the port's two
decoders are one function.  Every tensor stays on the device of the input
rows.
"""

from __future__ import annotations

import torch

from ..format import constants as C
from .decode_vm4 import checked
from .encode_jax import _ROUNDS, _ahead, _cummax, _doubling, _pos, _scatter_max

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
POP = PAD_OUT + 128  # the op walk's table with its sentinel region

_I64 = torch.int64


def _op_table(comp_u8: torch.Tensor):
    """Speculative op parse at every byte offset -> (jump, out_len, hdr,
    kind, dist), each (B, PAD_OUT) int64: what the op starting at p would
    be.  Lengths are clamped so malformed bytes stay deterministic; a bad
    stream fails the landing check."""
    t = comp_u8.to(_I64)
    pos = _pos(t.shape[0], PAD_OUT, t.device)
    b1, b2, b3, b4 = (_ahead(t, k) for k in (1, 2, 3, 4))
    kind = t & 3
    code = t >> 2

    extra = torch.clamp(code - (C.LITERAL_CODE_1BYTE - 1), 0, 4)
    lit_len = torch.where(
        extra == 0, code + 1,
        torch.where(extra == 1, b1 + 1,
                    torch.where(extra == 2, (b1 | (b2 << 8)) + 1,
                                torch.where(extra == 3, (b1 | (b2 << 8) | (b3 << 16)) + 1,
                                            (b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3F) << 24)) + 1))))
    lit_len = torch.clamp(lit_len, 1, BS + 1)
    c4_dist = torch.clamp(b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3F) << 24), 0, 1 << 28)

    is_lit = kind == C.TAG_LITERAL
    c1, c2 = kind == C.TAG_COPY1, kind == C.TAG_COPY2
    hdr = torch.where(is_lit, 1 + extra, torch.where(c1, 2, torch.where(c2, 3, 5)))
    out_len = torch.where(is_lit, lit_len, torch.where(c1, (code & 0x7) + 4, code + 1))
    dist = torch.where(c1, ((code >> 3) << 8) | b1, torch.where(c2, b1 | (b2 << 8), c4_dist))
    jump = pos + hdr + torch.where(is_lit, lit_len, 0)
    return jump, out_len, hdr, kind, dist


def _walk_init(jump: torch.Tensor, comp_len: torch.Tensor):
    """The op walk's jump table over POP offsets (offsets at or past
    comp_len self-loop, every other one moves forward) and its mask with
    offset 0 set."""
    B = jump.shape[0]
    pos = _pos(B, POP, jump.device)
    J = torch.cat([jump, torch.full((B, POP - PAD_OUT), PAD_OUT, dtype=_I64, device=jump.device)], dim=1)
    J = J.clamp_max(PAD_OUT)
    cl = comp_len.to(_I64)[:, None]
    J = torch.where(pos >= cl, pos, J)
    J = torch.maximum(J, pos + (pos < cl).to(_I64))
    R = torch.zeros((B, POP), dtype=torch.int32, device=jump.device)
    R[:, 0] = 1
    return J, R


def _walk_final(R: torch.Tensor, comp_len: torch.Tensor):
    """(op starts, landing bit): the walk's offsets before comp_len, and
    whether it reached comp_len (clipped to [0, PAD_OUT]) exactly."""
    cl = comp_len.to(_I64)
    starts = (R[:, :PAD_OUT] == 1) & (_pos(R.shape[0], PAD_OUT, R.device) < cl[:, None])
    landed = torch.gather(R, 1, cl.clamp(0, PAD_OUT)[:, None])[:, 0] == 1
    return starts, landed


def _op_starts(jump: torch.Tensor, comp_len: torch.Tensor):
    """Mark the true op starts by pointer doubling from offset 0; also
    return the landing bit (the walk reaches exactly comp_len)."""
    _J, R = _doubling(*_walk_init(jump, comp_len), _ROUNDS)
    return _walk_final(R, comp_len)


def _layout(starts: torch.Tensor, op_out: torch.Tensor, out_len: torch.Tensor):
    """Each op's output offset, and whether the ops' output adds up to
    out_len."""
    osize = torch.where(starts, op_out, 0)
    out_off = torch.cumsum(osize, dim=1) - osize
    return out_off, osize.sum(dim=1) == out_len.to(_I64)


def _op_at(starts: torch.Tensor, out_off: torch.Tensor) -> torch.Tensor:
    """For every output byte, the stream offset of the op that writes it:
    each op's offset scattered (max) at its output offset, then a cummax."""
    pos = _pos(starts.shape[0], PAD_OUT, starts.device)
    idx = torch.where(starts & (out_off < BS), out_off, BS)
    return _cummax(_scatter_max(BS, idx, torch.where(starts, pos, 0)))


def _chain_init(op_at, kind, dist, hdr, out_off, out_len):
    """Per output byte: its back-pointer (itself for a literal byte, q -
    offset for a copy byte, clipped to the block), its literal source in
    the stream, and per block whether any copy byte points before the
    block or has offset 0."""
    q = _pos(op_at.shape[0], BS, op_at.device)
    opk, opd, opo, oph = (torch.gather(a, 1, op_at) for a in (kind, dist, out_off, hdr))
    is_lit_byte = opk == C.TAG_LITERAL
    lit_src = op_at + oph + (q - opo)
    ptr = torch.where(is_lit_byte, q, q - opd)
    in_out = q < out_len.to(_I64)[:, None]
    bad_ref = torch.any(~is_lit_byte & ((ptr < 0) | (opd == 0)) & in_out, dim=1)
    return ptr.clamp(0, BS - 1), lit_src, bad_ref


def _chain(ptr: torch.Tensor) -> torch.Tensor:
    """_ROUNDS of ptr = ptr[ptr]: every byte resolved to its literal root."""
    for _ in range(_ROUNDS):
        ptr = torch.gather(ptr, 1, ptr)
    return ptr


def _final(comp_u8, lit_src, ptr, out_len, landed, ok_len, bad_ref):
    """Output bytes read from the stream at the roots' literal sources,
    zero past out_len, and the ok flag."""
    ol = out_len.to(_I64)
    src = torch.gather(lit_src, 1, ptr).clamp(0, PAD_OUT - 1)
    out = torch.gather(comp_u8, 1, src)
    out = torch.where(_pos(ptr.shape[0], BS, ptr.device) < ol[:, None], out, 0).to(torch.uint8)
    return out, landed & ok_len & ~bad_ref & (ol >= 0)


def decode_blocks(comp_u8: torch.Tensor, comp_lens: torch.Tensor, out_lens: torch.Tensor):
    """Batched block decode: (B, PAD_OUT) uint8 + (B,) int32 x2 ->
    ((B, BS) uint8, (B,) bool), on the device of the inputs.  ok is False
    for malformed input (bad landing, output-length mismatch, out-of-range
    copy offset); the bytes are then unspecified."""
    comp_u8, comp_lens, out_lens = checked(comp_u8, comp_lens, out_lens)
    jump, op_out, hdr, kind, dist = _op_table(comp_u8)
    starts, landed = _op_starts(jump, comp_lens)
    out_off, ok_len = _layout(starts, op_out, out_lens)
    ptr, lit_src, bad_ref = _chain_init(_op_at(starts, out_off), kind, dist, hdr, out_off, out_lens)
    return _final(comp_u8, lit_src, _chain(ptr), out_lens, landed, ok_len, bad_ref)


def decode_block_device(comp_u8: torch.Tensor, comp_len, out_len):
    """Decode one zero-padded (PAD_OUT,) uint8 op stream -> ((BS,) uint8,
    bool scalar tensor)."""
    lens = [torch.as_tensor([int(x)], dtype=_I64, device=comp_u8.device) for x in (comp_len, out_len)]
    out, ok = decode_blocks(comp_u8[None], *lens)
    return out[0], ok[0]
