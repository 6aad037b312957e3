"""The control comes out not correct, and the command refuses a machine
without a card.

The control is the reference put in the program's place and computed in
float8 e4m3 where the configuration states bfloat16 (convolutions and
matmuls): at a size a test run holds, on the CPU, its numbers are read
against the float32 reference and judged by the cell's own limits.  The
card-size readings that set the limits are ``portbench/control.py``'s.
"""

import subprocess
import sys

import pytest

from portbench import harness, spec
from portbench.tests.test_portbench_faults import CELLS, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_is_not_correct(name):
    cell = small_cell(name)
    out = harness.run_cell(cell, 4242, 0.0, False, device="cpu",
                           variants=("program", "control"), measure=False)
    limits = cell.limits
    control = out["numbers"]["control"]
    over = [k for k, v in control.items() if k in limits and v > limits[k]]
    assert over, (control, limits)


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "apex-dqn.host-actors", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=spec.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
