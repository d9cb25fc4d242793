from .sharding import (  # noqa: F401
    AXIS,
    decode_mesh,
    encode_mesh,
    init_distributed,
    make_mesh,
    sharded_decode,
    sharded_encode,
)
