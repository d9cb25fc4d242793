"""CPU tests of the benchmark: `python -m pytest benchmark/tests -q` from the
repository's root.  They run the harness's functions with the CPU named
explicitly, at tiny sizes; nothing here needs a card."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cells  # noqa: E402

torch.set_num_threads(1)  # tiny tensors; several test workers share the cores


def _tiny(workload: str, divisor: int = 400, keep: int = 3, op: str | None = None) -> cells.Cell:
    """The cell `workload` with its first `keep` objects cut to 1/divisor of
    their size; `op` puts a traffic mix of that op in place of the cell's
    own (the harness's decompress path, which no cell of BENCHMARK.json runs
    yet)."""
    cell = cells.load(ROOT, workload)
    if op is not None:
        cell = dataclasses.replace(cell, traffic={"op": op, "why": "test"})
    objects = {k: v // divisor for k, v in list(cell.config["objects"].items())[:keep]}
    return dataclasses.replace(cell, config=cell.config | {"objects": objects})


@pytest.fixture
def tiny():
    """tiny(workload, divisor=400, keep=3, op=None): `_tiny`."""
    return _tiny


@pytest.fixture
def no_card():
    """Skips where a CUDA card is present: the test checks the refusal without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
