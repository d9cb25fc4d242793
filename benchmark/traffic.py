"""The one generator of requests: a traffic mix's file says what it sends.

Keys of a traffic file (`traffic/<name>.json`), and no others:

  op    "compress" or "decompress": which call of the API each request
        makes, one request per object of the configuration;
  why   what the mix stands for.

The harness runs one closed-loop client.  Every pass over the objects goes
in an order drawn from the seed; every seed sends the same objects, so a
seed changes the order and the contents, never the amount of work.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

OPS = ("compress", "decompress")
KEYS = ("op", "why")


def check(traffic: dict) -> dict:
    """`traffic`, refused where it holds a key or an op the harness cannot run."""
    unknown = sorted(set(traffic) - set(KEYS))
    if unknown:
        raise ValueError(f"traffic keys the harness does not read: {unknown}")
    if traffic.get("op") not in OPS:
        raise ValueError(f"unknown op {traffic.get('op')!r}")
    return traffic


def units(traffic: dict, objects: dict[str, np.ndarray]) -> list[np.ndarray]:
    """The bytes of each request's unit, in the configuration's order."""
    check(traffic)
    return list(objects.values())


def passes(n_units: int, seed: int) -> Iterator[np.ndarray]:
    """An endless run of passes, each a permutation of the units drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield rng.permutation(n_units)
