from . import corpus  # noqa: F401
