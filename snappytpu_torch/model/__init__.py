from .decode import CorruptError, decode_ops, decompress  # noqa: F401
from .encode import compress, encode_block  # noqa: F401
