"""T1 (scalar-chain probes): the port's plain versions against the JAX
package's tools/probe_scalar.py, run with Pallas in interpret mode at a small
N.  The JAX tool is loaded from its source (nothing is written under
tools/) and three of its names are replaced: N, `pl` (a namespace whose
pallas_call passes interpret=True) and `_time` (which returns the kernel's
tile instead of its time; dynrow_chain's `* 10` is undone).

dynrow_write, dynrow_par, dynrmw_par, split_ref_chain and rmw_chain_same
read VMEM scratch that the JAX kernels never initialise, so rows 0-1 of
their tiles are undefined there (interpret mode fills int32 scratch with
-2**31).  For those probes the test compares the JAX probe as written on
its defined rows 2-7 only, and the whole tile against the JAX probe with
its scratch zeroed first by the harness, as the port zeroes it.  Tolerance:
exact (integer chains).
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from snappytpu_torch.tools import probe_scalar as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 320  # a multiple of every unroll factor and of 10
SCRATCH = ("dynrow_write", "dynrow_par", "dynrmw_par", "split_ref_chain", "rmw_chain_same")

# the JAX call of each probe shape, as its tool's sections make it
CALLS = {
    "smem_chase": lambda m, p: m.smem_chase(),
    "vmem_scalar": lambda m, p: m.vmem_scalar(),
    "dynrow_chain": lambda m, p: m.dynrow_chain() // 10,
    "alu_chain": lambda m, p: m.alu_chain(p.a),
    "alu_unroll": lambda m, p: m.alu_unroll(p.a),
    "smem_unroll": lambda m, p: m.smem_unroll(p.a),
    "while_unroll": lambda m, p: m.while_unroll(p.a),
    "dynrow_noextract": lambda m, p: m.dynrow_noextract(p.a),
    "dynrow_write": lambda m, p: m.dynrow_write(p.a),
    "smem_par": lambda m, p: m.smem_par(p.a),
    "dynrow_par": lambda m, p: m.dynrow_par(p.a, shared=bool(p.b)),
    "dynrmw_par": lambda m, p: m.dynrmw_par(p.a, shared=bool(p.b)),
    "bigstate_par": lambda m, p: m.bigstate_par(p.a, p.b),
    "vec_chain": lambda m, p: m.vec_chain(p.a, rollit=bool(p.b)),
    "split_ref_chain": lambda m, p: m.split_ref_chain(p.a),
    "rmw_chain_same": lambda m, p: m.rmw_chain_same(p.a),
}

# every probe of the port's smoke list, plus the other shapes of its sweeps
# that a parameter changes in kind (parallel chains, shared refs, no roll)
SHAPES = port.SMOKE + [port.Probe("alu_chain", 6), port.Probe("alu_unroll", 1), port.Probe("smem_par", 1),
                       port.Probe("dynrow_par", 2, 1), port.Probe("dynrmw_par", 6, 1),
                       port.Probe("bigstate_par", 1, 14), port.Probe("vec_chain", 2, 0)]


def _interpret_pl(zero_scratch: bool):
    fake = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})

    def pallas_call(kernel, **kw):
        nscr = len(kw.get("scratch_shapes", ()))
        if zero_scratch and nscr:
            def zeroed(*refs, _k=kernel):
                for r in refs[-nscr:]:
                    r[...] = jnp.zeros(r.shape, r.dtype)
                _k(*refs)
            kernel = zeroed
        return pl.pallas_call(kernel, interpret=True, **kw)

    fake.pallas_call = pallas_call
    return fake


@functools.cache
def _jax_tool(zero_scratch: bool):
    path = os.path.join(ROOT, "tools", "probe_scalar.py")
    spec = importlib.util.spec_from_file_location(f"jax_probe_scalar_{int(zero_scratch)}", path)
    mod = importlib.util.module_from_spec(spec)
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), mod.__dict__)  # from source: no bytecode under tools/
    mod.N = N
    mod.pl = _interpret_pl(zero_scratch)
    mod._time = lambda fn, *args: np.asarray(jax.block_until_ready(fn(*args)))[0]
    return mod


def _port_tile(p):
    tile, clk = port.run(p, torch.from_numpy(port.inputs(p)), N)
    assert tuple(tile.shape) == (8, 128) and tile.dtype == torch.int32 and not clk.any()
    return tile.numpy()


@pytest.mark.parametrize("p", SHAPES, ids=lambda p: p.name)
def test_plain_probe_equals_jax(p):
    got = _port_tile(p)
    if p.kind in SCRATCH:
        as_written = CALLS[p.kind](_jax_tool(False), p)
        np.testing.assert_array_equal(got[2:], as_written[2:], err_msg="defined rows 2-7")
        np.testing.assert_array_equal(got, CALLS[p.kind](_jax_tool(True), p), err_msg="zeroed scratch")
    else:
        np.testing.assert_array_equal(got, CALLS[p.kind](_jax_tool(False), p))


def test_every_kind_has_a_smoke_shape():
    assert sorted(p.kind for p in port.SMOKE) == sorted(port.KINDS) and len(port.KINDS) == 16


def test_sections_are_the_jax_tools():
    sizes = {g: len(ps) for g, ps in port.GROUPS.items()}
    assert sizes == {1: 5, 2: 24, 3: 12, 4: 12, 5: 8}
    for ps in port.GROUPS.values():
        for p in ps:
            p.check()


@pytest.mark.parametrize("bad", [port.Probe("alu_unroll", 3), port.Probe("smem_par", 5),
                                 port.Probe("bigstate_par", 2, 7), port.Probe("nope")], ids=str)
def test_unbuilt_shapes_are_refused(bad):
    with pytest.raises(ValueError):
        port.run(bad, torch.zeros(1, dtype=torch.int32), 10)


def test_inputs_are_checked():
    p = port.Probe("smem_chase")
    with pytest.raises(ValueError, match="shape"):
        port.run(p, torch.zeros(5, dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="lie in"):
        port.run(p, torch.full((port.SM,), port.SM, dtype=torch.int32), 10)
