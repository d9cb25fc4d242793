"""Variable-length row concatenation — K1, the encoder's last step.

Per block, concatenates the first lens[b, s] bytes of S pieces into one
row and zero-pads it to out_cap: the counterpart of
snappytpu.kernels.concat (its Pallas `_concat_kernel`).  On a CUDA tensor the
hand-written kernel in csrc/concat.cu runs; on a CPU tensor the plain
PyTorch version below does, and nothing else chooses between them.

The JAX kernel reads little-endian int32 words with funnel shifts because
the TPU has no byte refs; on the GPU the words are their bytes in memory
order, so `concat_rows_words` is a reinterpreting view onto `concat_rows`.
"""

from __future__ import annotations

import ctypes

import torch

from ..profiling import count_launch  # concat.launches / .recorded / .graph_runs (the CUDA route only)


def concat_rows_ref(pieces: torch.Tensor, lens: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Plain PyTorch concat: a cumulative sum of the lengths gives every
    piece byte its destination, and one masked scatter places them."""
    B, S, CAP = pieces.shape
    ln = lens.to(torch.int64).clamp(0, CAP)
    off = torch.cumsum(ln, dim=1) - ln
    k = torch.arange(CAP, device=pieces.device)
    dest = off[:, :, None] + k
    keep = (k < ln[:, :, None]) & (dest < out_cap)
    flat = dest + torch.arange(B, device=pieces.device)[:, None, None] * out_cap
    out = torch.zeros(B * out_cap, dtype=torch.uint8, device=pieces.device)
    out[flat[keep]] = pieces[keep]
    return out.view(B, out_cap)


def check_aligned(cap: int, out_cap: int, *ptrs: int) -> None:
    """The CUDA route's contract: the kernel reads its sections and writes
    its rows as aligned 16-byte words, so cap and out_cap must be multiples
    of 16 and the data pointers 16-byte aligned.  Raises ValueError if not."""
    if cap % 16 or out_cap % 16:
        raise ValueError(f"concat on CUDA needs cap and out_cap that are multiples of 16, got {cap}, {out_cap}")
    if any(p % 16 for p in ptrs):
        raise ValueError("concat on CUDA needs 16-byte aligned pieces and output (a storage offset breaks it)")


def _launch(pieces: torch.Tensor, lens: torch.Tensor, out_cap: int) -> torch.Tensor:
    from .._build import check, library

    B, S, CAP = pieces.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=pieces.device)
    check_aligned(CAP, out_cap, pieces.data_ptr(), out.data_ptr())
    if B:
        with torch.cuda.device(pieces.device):
            rc = library().snappy_concat_rows(
                pieces.data_ptr(), lens.data_ptr(), out.data_ptr(),
                B, S, CAP, out_cap, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            )
        check(rc, "concat_rows")
        count_launch("concat")
    return out


def concat_rows(pieces: torch.Tensor, lens: torch.Tensor, out_cap: int) -> torch.Tensor:
    """(B, S, CAP) uint8 pieces + (B, S) int32 lens -> (B, out_cap) uint8
    where row b is the concatenation of its S pieces' first lens[b, s]
    bytes, zero-padded.  Requires 0 <= lens <= CAP and sum(lens[b]) <=
    out_cap; the kernel clamps both, so it never writes past out_cap.  On
    CUDA it also requires the alignment of check_aligned."""
    if pieces.dtype != torch.uint8 or pieces.dim() != 3:
        raise ValueError(f"pieces must be (B, S, CAP) uint8, got {tuple(pieces.shape)} {pieces.dtype}")
    if lens.shape != pieces.shape[:2] or lens.device != pieces.device:
        raise ValueError("lens must be (B, S) on the pieces' device")
    lens = lens.to(torch.int32).contiguous()
    pieces = pieces.contiguous()
    if pieces.device.type == "cpu":
        ln = lens.to(torch.int64)
        if bool((ln < 0).any() | (ln > pieces.shape[2]).any() | (ln.sum(dim=1) > out_cap).any()):
            raise ValueError("concat lengths outside [0, CAP] or rows longer than out_cap")
        return concat_rows_ref(pieces, lens, out_cap)
    if pieces.device.type != "cuda":
        raise ValueError(f"no concat route for device {pieces.device}")
    return _launch(pieces, lens, out_cap)


def concat_rows_words(words: torch.Tensor, lens: torch.Tensor, out_cap: int) -> torch.Tensor:
    """concat_rows for (B, S, CAP/4) int32 little-endian words, the JAX
    entry's layout: the words are viewed as their bytes."""
    if words.dtype != torch.int32 or words.dim() != 3:
        raise ValueError(f"words must be (B, S, CAP/4) int32, got {tuple(words.shape)} {words.dtype}")
    return concat_rows(words.contiguous().view(torch.uint8), lens, out_cap)
