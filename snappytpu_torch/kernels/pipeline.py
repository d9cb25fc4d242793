"""The staged research pipeline as torch ops — the counterpart of
snappytpu.kernels.pipeline: `encode_pipeline(blocks, lens, profile)` and
`decode_pipeline(comp, comp_lens, out_lens)`, same contract as
encode_jax.encode_blocks / decode_jax.decode_blocks.

The JAX module splits the v1 codecs into small jitted stages, fences every
gather round with an optimization barrier and runs its doubling and LCP
loops as 3 x 6 rounds: workarounds for XLA:TPU's compile and fusion cliffs,
which Hopper does not have.  The port keeps the function, not the
workaround: one torch implementation of the arithmetic, shared with
encode_jax.py and decode_jax.py.  The encoder differs from encode_blocks
only in its candidate tiers, the profile's (config.PROFILES; the estimate
still uses all five hashes, 4-64).  The JAX module's 3 x 6 rounds and its
decoder's landing clip at POP - 1 give the rows and flags of the v1
modules' 17 rounds and decode_jax's clip at PAD_OUT (decode_jax.py says
why), so decode_pipeline is decode_jax.decode_blocks.

The stage names of the JAX module map onto the shared functions below, so a
stage can be diffed against its JAX counterpart; s_lcp_rounds/s_lcp_final
are one exact_lcp here, and the 3 x 6 doubling and chain loops one call.
"""

from __future__ import annotations

from ..config import PROFILES
from ..format import constants as C
from . import decode_jax as D
from . import encode_jax as E

BS = E.BS
PAD_OUT = E.PAD_OUT
BSP = E.BSP      # greedy jump table with its sentinel region
POP = D.POP      # decode boundary walk sentinel region

# ----------------------------------------------------------------- encode ---

s_words = E._word32
s_hash = E._gram_hashes
s_sort_tier = E._sort_tier
s_pred = E._pred
s_greedy_init = E._greedy_init
s_doubling = E._doubling
s_refine = E._refine
s_emit_layout = E._emit_layout
s_emit_bytes = E._emit_bytes


def s_score(cand, h4, h8, h16, h32, h64, n):
    """Hash-quantized LCP estimate for one candidate array (5 gathers)."""
    return E._score(cand, {4: h4, 8: h8, 16: h16, 32: h32, 64: h64}, n)


def s_pick(ests, cands, n):
    """Best candidate per position: max est, ties to smallest dist."""
    return E._pick(zip(ests, cands))


def exact_lcp(words, cand, n):
    return E._lcp(words, cand, n)


def s_greedy_final(R, best_len, n):
    return E._reached(R, n) & (best_len >= C.MIN_MATCH_LEN)


def encode_pipeline(blocks_u8, lens, profile: str = "dense"):
    """Staged batch encode: (B, BS) uint8 + (B,) int32 tensors -> ((B,
    PAD_OUT) uint8, (B,) int32), on the device of the inputs.  Same bytes
    as encode_jax.encode_blocks for `dense`.

    profile selects the candidate tier set (config.PROFILES): "dense" is the
    default quality tier, "fast" searches fewer gram tiers."""
    tiers = PROFILES[profile]
    E.check_blocks(blocks_u8, lens)
    return E.encode_core(blocks_u8, lens.to(E._I64), tiers)


# ----------------------------------------------------------------- decode ---

d_op_table = D._op_table
d_walk_init = D._walk_init
d_layout = D._layout
d_op_at = D._op_at
d_chain_init = D._chain_init
d_chain = D._chain
d_walk_final = D._walk_final
d_final = D._final

decode_pipeline = D.decode_blocks  # the staged batch decode: the same function
