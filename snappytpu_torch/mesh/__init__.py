from .sharding import (  # noqa: F401
    decode_mesh,
    encode_mesh,
    init_distributed,
    make_mesh,
)
