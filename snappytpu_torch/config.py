"""Configuration — the counterpart of snappytpu.config, with the same values
and the same validate() errors.

The reference exposes getopt flags plus compile-time constants
(MAX_BLOCK_SIZE/MAX_HTABLE_SIZE/BUFFER_DIM, snappy_compression.c:9-10,
snappy_decompression.c:15).  Here the equivalent knobs are a dataclass; the
two encoder profiles correspond to the reference's two match-finder quality
tiers (hash table = fast, BST = dense, snappy_compression.c vs
snappy_compression_tree.c) — except both of ours are collision-free, the
fast profile just searches fewer gram tiers.
"""

from __future__ import annotations

from dataclasses import dataclass

from .format import constants as C

# v2 production encoder profiles (kernels/encode_v2.py):
#   dense — byte-resolution tier B with full-depth sort keys
#   fast  — sampled-key tier B at stride 4
#
# gram tiers per profile (read by the research pipeline, kernels/pipeline.py):
# (gram_len, n_predecessors)
PROFILES: dict[str, tuple[tuple[int, int], ...]] = {
    "dense": ((4, 2), (8, 1), (16, 1), (32, 1), (64, 1)),
    "fast": ((4, 1), (8, 1), (64, 1)),
}


@dataclass(frozen=True)
class CodecConfig:
    """The JAX package's settings record, kept for parity: no module of
    either package reads its fields, so setting one changes nothing.  The
    refinement always runs 4 rounds (kernels/encode_jax._refine), a device
    call takes api.DEVICE_BATCH blocks, and the profile is an argument of
    each entry point.  Only PROFILES (gram_tiers) is read."""

    block_size: int = C.MAX_BLOCK_SIZE
    profile: str = "dense"          # "dense" | "fast"
    refine_rounds: int = 4           # not read: _refine runs 4 rounds
    backend: str = "device"          # "device" | "cpu" | "model"
    device_batch: int = 128          # not read: api.DEVICE_BATCH
    mesh_axis: str = "blocks"

    @property
    def gram_tiers(self) -> tuple[tuple[int, int], ...]:
        return PROFILES[self.profile]

    def validate(self) -> "CodecConfig":
        if self.block_size < 16 or self.block_size > C.MAX_BLOCK_SIZE:
            raise ValueError("block_size must be in [16, 65536]")
        if self.profile not in PROFILES:
            raise ValueError(f"unknown profile {self.profile!r}")
        if self.backend not in ("device", "cpu", "model"):
            raise ValueError(f"unknown backend {self.backend!r}")
        return self


DEFAULT = CodecConfig()
