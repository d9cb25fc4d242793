"""The check against the control and the planted faults: each comes out not
correct, on every op the cells run; the program comes out correct."""

import contextlib
import time

import pytest

import json
from pathlib import Path

from benchmark import faults, harness

WORKLOADS = [w["name"] for w in json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("mode", ("program",) + faults.NAMES)
@pytest.mark.parametrize("workload,op", [(w, None) for w in WORKLOADS] + [(WORKLOADS[0], "decompress")])
def test_control_and_faults_fail_the_check(workload, op, mode, tiny):
    cell = tiny(workload, divisor=50, op=op)  # a sample of 200,000 B, 4 blocks
    plant = contextlib.nullcontext() if mode == "program" else faults.planted(mode, cell.traffic["op"])
    with plant:
        result = harness.run_cell(cell, 2**36 + 1, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] is (mode == "program"), result["checks"]
    if mode == "control":  # the control loses one byte of each answer, and nothing else
        assert result["checks"]["wrong_bytes"]["value"] >= 1
        assert sum(c["value"] for k, c in result["checks"].items() if k != "wrong_bytes") == 0


def test_planted_restores_the_program():
    from snappytpu_torch import api

    before = (api.compress, api.decompress, api.encode_rows, api.decode_blocks_tape, api.decode_blocks)
    for name in faults.NAMES:
        with contextlib.suppress(RuntimeError), faults.planted(name, "compress"):
            raise RuntimeError
    assert (api.compress, api.decompress, api.encode_rows, api.decode_blocks_tape, api.decode_blocks) == before
