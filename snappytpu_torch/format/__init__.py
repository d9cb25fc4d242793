from . import constants  # noqa: F401
from .varint import decode_varint, encode_varint, varint_len  # noqa: F401
