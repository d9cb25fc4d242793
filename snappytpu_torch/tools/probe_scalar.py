"""Scalar-chain probes (T1) — the counterpart of the JAX package's
tools/probe_scalar.py: microbenchmarks of the primitives a decoder's serial
chain is made of (dependent shared- and global-memory loads, ALU steps,
dynamic row reads and writes, lane rotates), each one chain of N steps in one
warp, timed as ns per step.

    python -m snappytpu_torch.tools.probe_scalar [--groups 1] [--n 200000] [--device cuda]

The groups are the JAX tool's PROBE1..PROBE5 sections (group 1 alone by
default, as there).  csrc/probe_scalar.cu says how each TPU primitive maps
onto Hopper.  `run` is the entry: given the probe's input (its table or
seeds, as the JAX probe makes them) on the card it launches the kernel and
returns the (8, 128) int32 tile and {cycles, ns} of the chain; on the CPU it
returns the plain version's tile.  Every probe's scratch starts zeroed; the
JAX kernels leave theirs uninitialised (their tiles' rows 0-1 depend on it).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ._staged import device_of

N = 200_000
SM = 16384  # words of the chased permutation

KINDS = ("smem_chase", "vmem_scalar", "dynrow_chain", "alu_chain", "alu_unroll", "smem_unroll", "while_unroll",
         "dynrow_noextract", "dynrow_write", "smem_par", "dynrow_par", "dynrmw_par", "bigstate_par", "vec_chain",
         "split_ref_chain", "rmw_chain_same")
_PERM = ("smem_chase", "vmem_scalar", "smem_unroll", "while_unroll", "smem_par", "bigstate_par")
_UNROLL = {"alu_unroll": (1, 2, 4, 8, 16, 32), "smem_unroll": (1, 2, 4, 8, 16, 32),
           "while_unroll": (1, 2, 4, 8, 16, 32), "dynrow_noextract": (2, 8, 16), "dynrow_write": (2, 8, 16),
           "split_ref_chain": (2, 8, 16), "rmw_chain_same": (2, 8, 16), "vec_chain": (2, 8)}
_PAR = (1, 2, 4, 6)

launches = 0  # kernel launches by run (the CUDA route only)


@dataclass(frozen=True)
class Probe:
    kind: str
    a: int = 0  # u (unroll) or par
    b: int = 0  # ns (bigstate_par), shared (dynrow_par, dynrmw_par) or rollit (vec_chain)

    @property
    def name(self) -> str:
        args = {"alu_chain": (self.a,), "smem_par": (self.a,), "bigstate_par": (self.a, self.b),
                "dynrow_par": (self.a, bool(self.b)), "dynrmw_par": (self.a, bool(self.b)),
                "vec_chain": (self.a, bool(self.b))}.get(self.kind, (self.a,) if self.kind in _UNROLL else ())
        return f"{self.kind}({', '.join(map(str, args))})" if args else self.kind

    def steps(self, n: int) -> int:
        """Chain steps the time is divided by (the JAX tool's N; dynrow_chain
        runs n // 10 steps, where the JAX tool scaled its time by 10)."""
        return n // 10 if self.kind == "dynrow_chain" else n

    def check(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown probe {self.kind!r}")
        if self.kind in _UNROLL and self.a not in _UNROLL[self.kind]:
            raise ValueError(f"{self.kind}: unroll {self.a} not in {_UNROLL[self.kind]}")
        if self.kind in ("alu_chain", "smem_par", "dynrow_par", "dynrmw_par") and self.a not in _PAR:
            raise ValueError(f"{self.kind}: par {self.a} not in {_PAR}")
        if self.kind == "bigstate_par" and (self.a, self.b) not in ((1, 7), (1, 14), (6, 7), (6, 14)):
            raise ValueError(f"bigstate_par({self.a}, {self.b}) is not one of the swept shapes")


# The JAX tool's sections PROBE1..PROBE5, in its order.
GROUPS = {
    1: [Probe("alu_chain", 1), Probe("alu_chain", 6), Probe("smem_chase"), Probe("vmem_scalar"),
        Probe("dynrow_chain")],
    2: [Probe(k, u) for u in (1, 2, 4, 8, 16, 32) for k in ("alu_unroll", "smem_unroll", "while_unroll")]
       + [Probe(k, u) for u in (2, 8, 16) for k in ("dynrow_noextract", "dynrow_write")],
    3: [Probe("smem_par", p) for p in _PAR] + [Probe("dynrow_par", p, s) for p in _PAR for s in (0, 1)],
    4: [Probe("dynrmw_par", p, s) for p in _PAR for s in (0, 1)]
       + [Probe("bigstate_par", p, ns) for p in (1, 6) for ns in (7, 14)],
    5: [Probe("vec_chain", u, r) for u in (2, 8) for r in (0, 1)]
       + [Probe(k, u) for u in (2, 8) for k in ("split_ref_chain", "rmw_chain_same")],
}

# One shape of each of the 16 probes.
SMOKE = [Probe("smem_chase"), Probe("vmem_scalar"), Probe("dynrow_chain"), Probe("alu_chain", 1),
         Probe("alu_unroll", 8), Probe("smem_unroll", 8), Probe("while_unroll", 8), Probe("dynrow_noextract", 8),
         Probe("dynrow_write", 8), Probe("smem_par", 4), Probe("dynrow_par", 4), Probe("dynrmw_par", 4),
         Probe("bigstate_par", 6, 7), Probe("vec_chain", 8, 1), Probe("split_ref_chain", 8),
         Probe("rmw_chain_same", 8)]


def inputs(p: Probe) -> np.ndarray:
    """The probe's input as the JAX probe makes it: a permutation of SM words
    from numpy seed 0, a (128, 128) table from seed 0, or the seeds
    arange(par) / arange(1)."""
    rng = np.random.default_rng(0)
    if p.kind in _PERM:
        return rng.permutation(SM).astype(np.int32)
    if p.kind == "dynrow_chain":
        return rng.integers(0, 64, (128, 128)).astype(np.int32)
    if p.kind == "dynrow_noextract":
        return rng.integers(0, 100, (128, 128)).astype(np.int32)
    return np.arange(p.a if p.kind == "alu_chain" else 1, dtype=np.int32)


# ---- plain versions: Python integers for the scalar chains, numpy rows ----

def _i32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _lcg(x: int) -> int:
    return x * 1103515245 + 12345


def _full(v: int) -> np.ndarray:
    """A tile of one value (int32 wrap)."""
    return np.full((8, 128), _i32(v), np.int32)


def _rows(acc: np.ndarray, x: int) -> np.ndarray:
    """A tile whose rows 0-1 are acc + x (int32 wrap) and rows 2-7 zero."""
    t = np.zeros((8, 128), np.int64)
    t[0:2] = acc.astype(np.int64) + x
    return ((t + 2**31) % 2**32 - 2**31).astype(np.int32)


def plain(p: Probe, inp: np.ndarray, n: int) -> np.ndarray:
    """The probe's (8, 128) int32 tile after n steps, in Python and numpy."""
    p.check()
    k, a, b = p.kind, p.a, p.b
    tab = inp.reshape(-1).tolist()
    if k in ("smem_chase", "vmem_scalar", "smem_unroll"):
        x = 0
        for _ in range(n // a * a if k == "smem_unroll" else n):
            x = tab[x]
        return _full(x)
    if k == "while_unroll":
        i = x = 0
        while i < n // a and x >= 0:
            for _ in range(a):
                x = tab[x]
            i += 1
        return _full(x)
    if k == "dynrow_chain":
        t = inp.reshape(128, 128)
        x = 0
        for _ in range(n // 10):
            x = int(t[x, 0]) & 63
        return _full(x)
    if k == "alu_chain":
        xs = tab[:a]
        for _ in range(n):
            xs = [_lcg(x) & 0x7FFFFFFF for x in xs]
        return _full(sum(xs))
    if k == "alu_unroll":
        x = tab[0]
        for _ in range(n // a * a):
            x = _lcg(x) & 0x7FFFFFFF
        return _full(x)
    if k == "smem_par":
        xs = [17 * j for j in range(a)]
        for _ in range(n):
            xs = [tab[x] for x in xs]
        return _full(sum(xs))
    if k == "bigstate_par":
        st = [[j * b + i for i in range(b)] for j in range(a)]
        for _ in range(n):
            for s in st:
                s[0] = tab[s[0]]
                for i in range(1, b):
                    s[i] = (s[i] * 29 + s[i - 1] + i) & 0x3FFF
        return _full(sum(map(sum, st)))
    if k == "dynrow_noextract":
        t = inp.reshape(128, 128)
        x, acc = 0, np.zeros((2, 128), np.int32)
        for _ in range(n // a * a):
            x = _lcg(x) & 63
            acc ^= t[x : x + 2]
        return _rows(acc, x)
    if k in ("dynrow_write", "rmw_chain_same", "split_ref_chain"):
        scr = np.zeros((128, 128), np.int64)
        src = np.zeros((128, 128), np.int64)
        x = tab[0]
        for _ in range(n // a * a):
            x = _lcg(x) & 63
            if k == "dynrow_write":
                scr[x : x + 2] ^= x
            elif k == "rmw_chain_same":
                scr[(x * 7) & 63 : ((x * 7) & 63) + 2] = scr[x : x + 2] ^ x
            else:
                scr[(x * 7) & 63 : ((x * 7) & 63) + 2] = src[x : x + 2] + x
        return _rows(scr[0:2], x)
    if k == "dynrow_par":
        scr = [np.zeros((128, 128), np.int32) for _ in range(1 if b else a)]
        xs = list(range(a))
        accs = [np.zeros((2, 128), np.int32) for _ in range(a)]
        for _ in range(n):
            for j in range(a):
                xs[j] = (_lcg(xs[j]) + j) & 63
                accs[j] ^= scr[0 if b else j][xs[j] : xs[j] + 2]
        acc = accs[0]
        for j in range(1, a):
            acc = acc ^ accs[j]
        return _rows(acc, xs[0])
    if k == "dynrmw_par":
        scr = [np.zeros((128, 128), np.int64) for _ in range(1 if b else a)]
        xs = list(range(a))
        for _ in range(n):
            for j in range(a):
                x = xs[j] = (_lcg(xs[j]) + j) & 63
                scr[0 if b else j][x : x + 2] ^= x + j
        return _rows(scr[0][0:2], xs[0])
    if k == "vec_chain":
        x, h = tab[0], np.zeros((8, 128), np.int64)
        for _ in range(n // a * a):
            x = _lcg(x) & 31
            h = (np.roll(h, x, axis=1) + 1) if b else ((h ^ (h + x)) | 1)
            h = (h + 2**31) % 2**32 - 2**31
        return ((h + x + 2**31) % 2**32 - 2**31).astype(np.int32)
    raise AssertionError(k)


def _checked(p: Probe, inp: torch.Tensor, n: int) -> None:
    p.check()
    want = inputs(p)
    if inp.dtype != torch.int32 or tuple(inp.shape) != want.shape or not inp.is_contiguous():
        raise ValueError(f"{p.name}: input must be a contiguous int32 tensor of shape {want.shape}")
    if inp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe route for device {inp.device}")
    if p.kind in _PERM and not (int(inp.min()) >= 0 and int(inp.max()) < SM):
        raise ValueError(f"{p.name}: the chased table's words must lie in [0, {SM})")
    if n < 0:
        raise ValueError("n must be >= 0")


def _launch(p: Probe, inp: torch.Tensor, n: int):
    """Launch the probe's kernel on a checked CUDA input."""
    global launches
    from .._build import check, library

    tile = torch.empty((8, 128), dtype=torch.int32, device=inp.device)
    clk = torch.empty(2, dtype=torch.int64, device=inp.device)
    with torch.cuda.device(inp.device):
        rc = library().snappy_probe_scalar(
            KINDS.index(p.kind), p.a, p.b, inp.data_ptr(), tile.data_ptr(), clk.data_ptr(), n,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    check(rc, f"probe_scalar {p.name}")
    launches += 1
    return tile, clk


def run(p: Probe, inp: torch.Tensor, n: int = N):
    """The probe on the device of its input -> ((8, 128) int32 tile, (2,)
    int64 {cycles, ns} of the chain; zeros on the CPU, where nothing is
    timed)."""
    _checked(p, inp, n)
    if inp.device.type == "cpu":
        return torch.from_numpy(plain(p, inp.numpy(), n)), torch.zeros(2, dtype=torch.int64)
    return _launch(p, inp, n)


def measure(p: Probe, dev, n: int = N, reps: int = 3) -> dict:
    """The probe on the card: its tile, and ns per step from the chain's own
    clocks (cycles and %globaltimer, best of reps) and from CUDA events around
    `reps` launches."""
    inp = torch.from_numpy(inputs(p)).to(dev)
    if inp.device.type != "cuda":
        raise ValueError(f"measure needs a CUDA device, not {dev}")
    _checked(p, inp, n)
    tile, _ = _launch(p, inp, n)
    clks = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        clks.append(_launch(p, inp, n)[1])
    end.record()
    end.synchronize()
    steps = p.steps(n)
    cyc, ns = min(c.tolist() for c in clks)
    return {"tile": tile, "cycles_per_step": cyc / steps, "ns_per_step": ns / steps,
            "event_ns_per_step": start.elapsed_time(end) * 1e6 / reps / steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default="1", help="comma list of the JAX tool's sections 1-5")
    ap.add_argument("--n", type=int, default=N, help="chain steps")
    ap.add_argument("--check", action="store_true", help="hold each tile against its plain version")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(f"device {dev} ({args.device}), n={args.n}", flush=True)
    for g in map(int, args.groups.split(",")):
        print(f"--- section {g} ---", flush=True)
        for p in GROUPS[g]:
            inp = inputs(p)
            if dev.type == "cpu":
                tile, _ = run(p, torch.from_numpy(inp), args.n)
                print(f"{p.name:26s} plain tile[0, 0] {int(tile[0, 0])}", flush=True)
                continue
            m = measure(p, dev, args.n)
            line = (f"{p.name:26s} {m['ns_per_step']:8.3f} ns/step (chain clock; {m['cycles_per_step']:7.2f} "
                    f"cycles), {m['event_ns_per_step']:8.3f} ns/step (events)")
            if args.check:
                same = np.array_equal(m["tile"].cpu().numpy(), plain(p, inp, args.n))
                line += ", equal to plain" if same else ", DIFFERS from plain"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
