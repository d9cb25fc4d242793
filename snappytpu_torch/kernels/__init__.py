"""Device code of the port.

  encode_blocks_v2     sort/scan block encoder as torch ops (encode_v2.py),
                       ending in the K1 concat kernel (concat.py)
  decode_blocks_vm     block decoder, K2 (decode_vm4.py via decode_vm.py)
  decode_blocks_vm2    K3, K2's A/B twin: K4a's parse, then the resolver (decode_vm2.py)
  decode_stream_vm     windowed stream decoder, K4 (decode_vm2.py)
  decode_blocks_tape   host-tape movement decoder, K5 / K6 (decode_tape.py)

Research paths, torch ops without a kernel (the JAX package's v1 codecs):
  encode_blocks        v1 pointer-doubling encoder (encode_jax.py)
  decode_blocks        v1 parallel-scan decoder (decode_jax.py)
  pipeline             the same codecs per profile (encode_pipeline,
                       decode_pipeline)

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors.  The CUDA library is built on the
first launch, not on import.
"""

from .concat import concat_rows, concat_rows_words  # noqa: F401
from .decode_jax import decode_blocks  # noqa: F401
from .decode_tape import decode_blocks_tape  # noqa: F401
from .decode_vm import decode_blocks_vm  # noqa: F401
from .decode_vm2 import decode_blocks_vm2, decode_stream_vm  # noqa: F401
from .encode_jax import encode_blocks  # noqa: F401
from .encode_v2 import encode_blocks_v2  # noqa: F401
