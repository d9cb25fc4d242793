"""Scalar-chain probes (T1) — the counterpart of the JAX package's
tools/probe_scalar.py: microbenchmarks of the primitives a decoder's serial
chain is made of (dependent shared- and global-memory loads, ALU steps,
dynamic row reads and writes, lane rotates), each one chain of N steps in one
warp, timed as ns and cycles per step.

    python -m snappytpu_torch.tools.probe_scalar [--groups 1] [--n 200000] [--check] [--device cuda]

The groups are the JAX tool's PROBE1..PROBE5 sections (group 1 alone by
default, as there).  On the card the tool runs the chosen sections' probes
batched, all in one launch of one warp per SM (`measure_all`), then each
alone (`measure`), and prints both per probe.  csrc/probe_scalar.cuh says how
each TPU primitive maps onto Hopper, csrc/probe_scalar.cu how the batch keeps
one probe per SM.  `run` runs one probe, `run_all` a list of them in one
launch: given the probes' inputs (tables or seeds, as the JAX probe makes
them) on the card they launch the kernel and return the (8, 128) int32
tiles and {cycles, ns} of each chain; on the CPU the plain versions' tiles.
Every probe's scratch starts zeroed; the JAX kernels leave theirs
uninitialised (their tiles' rows 0-1 depend on it).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..profiling import count  # probe_scalar.launches: kernel launches by run (the CUDA route only)
from ._staged import device_of

N = 200_000
SM = 16384  # words of the chased permutation
TILE = 8 * 128  # words of a probe's output tile, the first of its shared memory
SCR = 66 * 128  # words of one zeroed scratch ref (rows 0-65)
# The least dynamic shared memory that keeps a block alone on its SM: two
# blocks of this (each with the SM's 1 KiB reserve) exceed an H100 SM's
# 228 KiB.  Every block of a batch asks for at least this.
ALONE = 114 * 1024
SMS = 132  # an H100 SXM's SMs: the most probes one batch runs (the card's own count on CUDA)
L1_KINDS = ("vmem_scalar",)  # chases global memory: launched apart, so that L1 keeps its table

KINDS = ("smem_chase", "vmem_scalar", "dynrow_chain", "alu_chain", "alu_unroll", "smem_unroll", "while_unroll",
         "dynrow_noextract", "dynrow_write", "smem_par", "dynrow_par", "dynrmw_par", "bigstate_par", "vec_chain",
         "split_ref_chain", "rmw_chain_same")
_PERM = ("smem_chase", "vmem_scalar", "smem_unroll", "while_unroll", "smem_par", "bigstate_par")
_UNROLL = {"alu_unroll": (1, 2, 4, 8, 16, 32), "smem_unroll": (1, 2, 4, 8, 16, 32),
           "while_unroll": (1, 2, 4, 8, 16, 32), "dynrow_noextract": (2, 8, 16), "dynrow_write": (2, 8, 16),
           "split_ref_chain": (2, 8, 16), "rmw_chain_same": (2, 8, 16), "vec_chain": (2, 8)}
_PAR = (1, 2, 4, 6)



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

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory a block of this probe needs: its
        tile, its staged input and its zeroed scratch (probe_scalar.cuh
        kStage and kZero)."""
        stage = SM if self.kind in _PERM and self.kind != "vmem_scalar" else 0
        stage = 128 * 128 if self.kind in ("dynrow_chain", "dynrow_noextract") else stage
        scr = {"dynrow_write": 1, "rmw_chain_same": 1, "split_ref_chain": 2}.get(self.kind, 0)
        if self.kind in ("dynrow_par", "dynrmw_par"):
            scr = 1 if self.b else self.a
        return 4 * (TILE + stage + scr * SCR)

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


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a batch: the probes (indices into the batch's
    list) it runs, one block each, its table of (kind, a, b, input offset in
    words) rows and the dynamic shared memory every block asks for."""
    index: tuple
    table: np.ndarray
    smem: int


def plan(probes, sms: int = SMS):
    """The launches of a batch and its inputs in one int32 buffer: every
    probe but L1_KINDS in one launch whose blocks ask for the largest
    probe's shared memory (at least ALONE), L1_KINDS in a second with
    ALONE.  Each probe is one block; a probe named twice, or more probes
    than `sms`, is refused."""
    probes = list(probes)
    for p in probes:
        p.check()
    if len(set(probes)) != len(probes):
        raise ValueError("a probe is named twice in one batch")
    if not 0 < len(probes) <= sms:
        raise ValueError(f"a batch runs 1 to {sms} probes, one per SM, not {len(probes)}")
    ins = [inputs(p).reshape(-1) for p in probes]
    offs = np.cumsum([0] + [a.size for a in ins])
    launches = []
    for l1 in (False, True):
        index = tuple(i for i, p in enumerate(probes) if (p.kind in L1_KINDS) == l1)
        if index:
            table = np.array([(KINDS.index(probes[i].kind), probes[i].a, probes[i].b, offs[i]) for i in index],
                             np.int32)
            launches.append(Launch(index, table, max([ALONE] + [probes[i].smem for i in index])))
    return launches, np.concatenate(ins)


def _launch(table: torch.Tensor, inp: torch.Tensor, n: int, smem: int, tiles: torch.Tensor, clk: torch.Tensor,
            stream) -> None:
    """Launch the kernel on a checked CUDA input: block i runs table row i
    into tiles[i] and clk[i]."""
    from .._build import check, library

    rc = library().snappy_probe_scalar(table.data_ptr(), table.shape[0], smem, inp.data_ptr(), tiles.data_ptr(),
                                       clk.data_ptr(), n, ctypes.c_void_p(stream.cuda_stream))
    check(rc, f"probe_scalar ({table.shape[0]} blocks)")
    count("probe_scalar.launches")


def _outputs(blocks: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((blocks, 8, 128), dtype=torch.int32, device=dev),
            torch.empty((blocks, 4), dtype=torch.int64, device=dev))


def _check_clocks(probes, clk: torch.Tensor) -> None:
    """Refuse a run whose block had too little shared memory or no body
    (cycles -1, -2), or in which two blocks ran on one SM."""
    rows = clk.tolist()
    for p, (cyc, *_rest) in zip(probes, rows):
        if cyc < 0:
            raise RuntimeError(f"{p.name}: the kernel ran no chain (code {cyc})")
    on = {}
    for p, (_c, _ns, sm, _t0) in zip(probes, rows):
        on.setdefault(sm, []).append(p.name)
    shared = {sm: names for sm, names in on.items() if len(names) > 1}
    if shared:
        raise RuntimeError(f"probes shared an SM, which changes what their chains measure: {shared}")


def run(p: Probe, inp: torch.Tensor, n: int = N):
    """The probe on the device of its input, alone in one launch with its
    own shared memory -> ((8, 128) int32 tile, (2,) int64 {cycles, ns} of the
    chain; zeros on the CPU, where nothing is timed)."""
    _checked(p, inp, n)
    if inp.device.type == "cpu":
        return torch.from_numpy(plain(p, inp.numpy(), n)), torch.zeros(2, dtype=torch.int64)
    tiles, clk = _lone(p, inp, n, _table(p, inp.device))
    return tiles[0], clk[0, :2]


def _table(p: Probe, dev) -> torch.Tensor:
    return torch.tensor([[KINDS.index(p.kind), p.a, p.b, 0]], dtype=torch.int32, device=dev)


def _lone(p: Probe, inp: torch.Tensor, n: int, table: torch.Tensor):
    """One launch of one block with the probe's own shared memory."""
    tiles, clk = _outputs(1, inp.device)
    with torch.cuda.device(inp.device):
        _launch(table, inp, n, p.smem, tiles, clk, torch.cuda.current_stream())
    return tiles, clk


def measure(p: Probe, dev, n: int = N, reps: int = 3) -> dict:
    """The probe alone on the card: its tile, and ns and cycles per step from
    the chain's own clocks (best of reps) and ns per step from CUDA events
    around `reps` launches."""
    inp = torch.from_numpy(inputs(p)).to(dev)
    if inp.device.type != "cuda":
        raise ValueError(f"measure needs a CUDA device, not {dev}")
    _checked(p, inp, n)
    table = _table(p, inp.device)
    tile, clk = _lone(p, inp, n, table)
    _check_clocks([p], clk)
    clks = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        clks.append(_lone(p, inp, n, table)[1])
    end.record()
    end.synchronize()
    for c in clks:
        _check_clocks([p], c)
    steps = p.steps(n)
    cyc, ns = min(c[0, :2].tolist() for c in clks)
    return {"tile": tile[0], "cycles_per_step": cyc / steps, "ns_per_step": ns / steps,
            "event_ns_per_step": start.elapsed_time(end) * 1e6 / reps / steps}


class Batch:
    """A list of probes staged on the card for `plan`'s launches: its tables
    and inputs uploaded once, so that a timed run moves nothing."""

    def __init__(self, probes, dev):
        self.probes = list(probes)
        self.dev = torch.device(dev)
        if self.dev.type != "cuda":
            raise ValueError(f"a batch runs on a CUDA device, not {dev}")
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        self.launches, buf = plan(self.probes, sms)
        self.inp = torch.from_numpy(buf).to(self.dev)
        self.tables = [torch.from_numpy(li.table).to(self.dev) for li in self.launches]
        self.order = [i for li in self.launches for i in li.index]  # block b runs probe order[b]
        self.back = torch.tensor(np.argsort(self.order), dtype=torch.int64, device=self.dev)
        self.side = torch.cuda.Stream(self.dev)

    def launch(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One run: the L1 probes' launch on a side stream first, then the
        main launch on the current stream beside it, joined -> (tiles (B, 8,
        128), clocks (B, 4) {cycles, ns, SM, start ns}) in block order.  The
        side block starts first, so no main block that ends early can free
        an SM for it."""
        with torch.cuda.device(self.dev):
            cur = torch.cuda.current_stream()
            tiles, clk = _outputs(len(self.order), self.dev)
            bounds = np.cumsum([0] + [len(li.index) for li in self.launches])
            if len(self.launches) > 1:
                self.side.wait_stream(cur)
            for k in [*range(1, len(self.launches)), 0]:
                lo, hi = bounds[k], bounds[k + 1]
                _launch(self.tables[k], self.inp, n, self.launches[k].smem, tiles[lo:hi], clk[lo:hi],
                        self.side if k else cur)
            if len(self.launches) > 1:
                cur.wait_stream(self.side)
        return tiles, clk

    def check(self, clk: torch.Tensor) -> None:
        _check_clocks([self.probes[i] for i in self.order], clk)


def run_all(probes, n: int = N, device="cuda"):
    """Every probe of the list in one batch, one block per SM, on `device`
    -> ((B, 8, 128) int32 tiles, (B, 2) int64 {cycles, ns} per chain), in
    the list's order; on the CPU the plain tiles and zero clocks.  Raises if
    two probes ran on one SM."""
    probes = list(probes)
    dev = torch.device(device)
    if n < 0:
        raise ValueError("n must be >= 0")
    if dev.type == "cpu":
        plan(probes)
        tiles = np.stack([plain(p, inputs(p), n) for p in probes])
        return torch.from_numpy(tiles), torch.zeros((len(probes), 2), dtype=torch.int64)
    batch = Batch(probes, dev)
    tiles, clk = batch.launch(n)
    batch.check(clk)
    return tiles.index_select(0, batch.back), clk.index_select(0, batch.back)[:, :2]


def measure_all(probes, dev, n: int = N, reps: int = 3) -> dict:
    """The probes batched on the card, `reps` runs: the tiles (the last
    run's, in the list's order), the batch's ms by CUDA events (best run),
    each chain's ns and cycles per step (best of reps), the SM each ran on
    and how far apart the blocks started (µs, the best run's)."""
    probes = list(probes)
    batch = Batch(probes, dev)
    best, clks = None, []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        start.record()
        tiles, clk = batch.launch(n)
        end.record()
        end.synchronize()
        batch.check(clk)
        clk = clk.index_select(0, batch.back).cpu()
        ms = start.elapsed_time(end)
        if best is None or ms < best[0]:
            best = (ms, clk)
        clks.append(clk)
    cyc = torch.stack([c[:, 0] for c in clks]).min(0).values.tolist()
    ns = torch.stack([c[:, 1] for c in clks]).min(0).values.tolist()
    steps = [p.steps(n) for p in probes]
    t0 = best[1][:, 3]
    return {"tiles": tiles.index_select(0, batch.back), "ms": best[0],
            "cycles_per_step": [c / s for c, s in zip(cyc, steps)], "ns_per_step": [t / s for t, s in zip(ns, steps)],
            "sms": best[1][:, 2].tolist(), "start_spread_us": int(t0.max() - t0.min()) / 1e3,
            "launches_per_run": len(batch.launches)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default="1", help="comma list of the JAX tool's sections 1-5")
    ap.add_argument("--n", type=int, default=N, help="chain steps")
    ap.add_argument("--check", action="store_true", help="hold each tile against its plain version")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(f"device {dev} ({args.device}), n={args.n}", flush=True)
    groups = [int(g) for g in args.groups.split(",")]
    if dev.type == "cpu":
        for g in groups:
            print(f"--- section {g} ---", flush=True)
            for p in GROUPS[g]:
                tile, _ = run(p, torch.from_numpy(inputs(p)), args.n)
                print(f"{p.name:26s} plain tile[0, 0] {int(tile[0, 0])}", flush=True)
        return 0
    probes = [p for g in groups for p in GROUPS[g]]
    batched = measure_all(probes, dev, args.n)
    print(f"batched: {len(probes)} probes, one per SM ({len(set(batched['sms']))} SMs), "
          f"{batched['launches_per_run']} launches a run, {batched['ms']:.4f} ms (best of 3, CUDA events), "
          f"blocks started within {batched['start_spread_us']:.1f} us", flush=True)
    k = 0
    for g in groups:
        print(f"--- section {g} --- ns/step and cycles/step: batched, alone (chain clocks); alone by events", flush=True)
        for p in GROUPS[g]:
            m = measure(p, dev, args.n)
            bns, bcyc = batched["ns_per_step"][k], batched["cycles_per_step"][k]
            line = (f"{p.name:26s} {bns:8.3f} ns {bcyc:8.2f} cyc batched, {m['ns_per_step']:8.3f} ns "
                    f"{m['cycles_per_step']:8.2f} cyc alone (cycles {bcyc / m['cycles_per_step']:.3f}x), "
                    f"{m['event_ns_per_step']:8.3f} ns/step by events")
            if args.check:
                want = plain(p, inputs(p), args.n)
                same = all(np.array_equal(t.cpu().numpy(), want) for t in (m["tile"], batched["tiles"][k]))
                line += ", equal to plain" if same else ", DIFFERS from plain"
            print(line, flush=True)
            k += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
