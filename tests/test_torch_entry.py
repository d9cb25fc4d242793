"""The port's entry points (snappytpu_torch.entry) against __graft_entry__:
entry()'s function on its own example blocks gives the JAX entry's rows and
totals byte for byte (tolerance 0), and dryrun_multichip round-trips over a
CPU mesh."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry  # the repo root, on the path by conftest.py
from snappytpu_torch import entry as port_entry

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


@pytest.fixture(scope="module")
def both():
    fn, args = port_entry.entry("cpu")
    jfn, jargs = jax_entry.entry()
    return fn, args, jfn, jargs


def test_example_blocks_equal(both):
    _fn, (blocks, lens), _jfn, (jblocks, jlens) = both
    assert blocks.device.type == "cpu" and blocks.dtype == torch.uint8 and lens.dtype == torch.int32
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_entry_rows_equal_jax(both):
    fn, args, jfn, jargs = both
    comp, totals = fn(*args)
    jcomp, jtotals = jfn(*jargs)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jtotals))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))


def test_entry_defaults_to_the_card(monkeypatch):
    """entry() puts its example arguments on the card unless asked for the
    CPU: without one, it raises."""
    seen = []
    real = torch.Tensor.to

    def spy(self, *a, **k):
        seen.append(torch.device(a[0]) if a else k.get("device"))
        return real(self, "cpu")

    monkeypatch.setattr(torch.Tensor, "to", spy)
    port_entry.entry()
    assert [d.type for d in seen] == ["cuda", "cuda"]


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_cpu(capsys, n):
    port_entry.dryrun_multichip(n, device="cpu")
    assert f"dryrun_multichip ok: {n} devices" in capsys.readouterr().out
