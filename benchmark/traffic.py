"""The one generator of requests: a traffic mix's file says what it sends.

Keys of a traffic file (`traffic/<name>.json`), and no others:

  op       "compress" or "decompress": which call of the API each request
           makes, one request per object of the configuration;
  clients  how many closed-loop callers send at once over the one card, a
           whole number from 1 to 16; 1 where the key is absent;
  why      what the mix stands for.

Each client sends its own passes over the objects, each pass in an order
drawn from the seed and the client's index; every seed sends the same
objects, so a seed changes the order and the contents, never the amount of
work.  Client 0 draws the order one client has always drawn.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

OPS = ("compress", "decompress")
KEYS = ("op", "clients", "why")
MAX_CLIENTS = 16


def check(traffic: dict) -> dict:
    """`traffic`, refused where it holds a key or an op the harness cannot run."""
    unknown = sorted(set(traffic) - set(KEYS))
    if unknown:
        raise ValueError(f"traffic keys the harness does not read: {unknown}")
    if traffic.get("op") not in OPS:
        raise ValueError(f"unknown op {traffic.get('op')!r}")
    n = traffic.get("clients", 1)
    if type(n) is not int or not 1 <= n <= MAX_CLIENTS:
        raise ValueError(f"clients must be a whole number from 1 to {MAX_CLIENTS}, not {n!r}")
    return traffic


def clients(traffic: dict) -> int:
    """How many closed-loop clients the mix runs at once."""
    return check(traffic).get("clients", 1)


def units(traffic: dict, objects: dict[str, np.ndarray]) -> list[np.ndarray]:
    """The bytes of each request's unit, in the configuration's order."""
    check(traffic)
    return list(objects.values())


def passes(n_units: int, seed: int, client: int = 0) -> Iterator[np.ndarray]:
    """An endless run of passes, each a permutation of the units drawn from
    the seed and, for a client other than the first, the client's index."""
    rng = np.random.default_rng([int(seed), 1] + ([client] if client else []))
    while True:
        yield rng.permutation(n_units)
