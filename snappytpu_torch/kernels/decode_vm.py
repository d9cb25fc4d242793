"""Block decode dispatch — the counterpart of snappytpu.kernels.decode_vm.

The JAX module also holds the funnel-window copy helpers and the word
packing that the TPU's layout needs; the GPU kernels address bytes
directly, so only the dispatch is ported.
"""

from __future__ import annotations

from .decode_vm4 import decode_blocks_vm4


def decode_blocks_vm(comp_u8, comp_lens, out_lens):
    """Batched block decode: (B, PAD_OUT) uint8 + (B,) int32 x2 ->
    ((B, BS) uint8, (B,) bool).  Dispatches to the K2 block decoder
    (decode_vm4.py); zero-length pad blocks report ok."""
    return decode_blocks_vm4(comp_u8, comp_lens, out_lens)
