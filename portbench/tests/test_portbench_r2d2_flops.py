"""``r2d2-84x84``'s FLOP count against torch's own counter on the
reference net, its gather's byte count, and the reference's frozen copy
beside the test suite's."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import spec
from portbench.flops import trunk_macs
from portbench.reference import r2d2 as net

NAME = "r2d2-84x84"


def _flops_module():
    return spec._module(os.path.join(spec.HERE, "configs", f"{NAME}.py"),
                        "test_flops_" + spec._ident(NAME))


def _config():
    with open(os.path.join(spec.HERE, "configs", f"{NAME}.json")) as fh:
        return json.load(fh)


def _params(config):
    sh = config["shapes"]
    h, w, c = sh["frame"]
    _, flat = trunk_macs(h, w, c, sh["trunk"])
    lstm, head, a = sh["lstm_features"], sh["head_width"], sh["actions"]
    shapes = {}
    for i, (feats, k, _) in enumerate(sh["trunk"]):
        shapes |= {f"Conv_{i}.weight": (feats, c, k, k),
                   f"Conv_{i}.bias": (feats,)}
        c = feats
    shapes |= {"lstm.weight_ih": (4 * lstm, flat + a + 1),
               "lstm.weight_hh": (4 * lstm, lstm),
               "lstm.bias_hh": (4 * lstm,)}
    for name, out in (("advantage", a), ("value", 1)):
        shapes |= {f"{name}_hidden.weight": (head, lstm),
                   f"{name}_hidden.bias": (head,),
                   f"{name}_out.weight": (out, head),
                   f"{name}_out.bias": (out,)}
    g = torch.Generator().manual_seed(0)
    return {k: torch.randn(s, generator=g) * 0.02 for k, s in shapes.items()}


def test_forward_flops_match_the_counter():
    """Three frames of one sequence through trunk, LSTM (input and
    recurrent matmuls) and heads."""
    m, config = _flops_module(), _config()
    p = _params(config)
    h, w, c = config["shapes"]["frame"]
    obs = torch.randint(0, 255, (1, 3, h, w, c), dtype=torch.uint8)
    carry = (torch.zeros(1, 512), torch.zeros(1, 512))
    prev = (torch.zeros(1, 3, dtype=torch.long), torch.zeros(1, 3))
    with FlopCounterMode(display=False) as fc:
        net.q_values(p, obs, carry, prev)
    assert fc.get_total_flops() == 3 * m.forward_flops_per_sample(config)


def test_a_step_is_420_forwards_a_sequence():
    """Online and target over T = 125 steps, the online net's backward
    over the 85 after the burn-in at twice a forward: 714 GFLOP at batch
    64."""
    m, config = _flops_module(), _config()
    assert m.forward_flops_per_sample(config) == 2 * 13_285_376
    assert m.flops_per_step(config) == 64 * 420 * 2 * 13_285_376
    assert m.flops_per_step(config) / 1e9 == pytest.approx(714.22, abs=0.01)


def test_gather_bytes_meet_the_bound():
    """8000 frame rows of 7056 B read and written, and their int32 ids:
    112.9 MB, 33.71 us at 3.35 TB/s."""
    from portbench.peaks import peaks
    _, rate = peaks("NVIDIA H100 80GB HBM3")
    m = _flops_module()
    assert m.gather_bytes_per_step(_config()) == 2 * 8000 * 7056 + 4 * 8000
    assert m.gather_bytes_per_step(_config()) / rate * 1e6 == pytest.approx(
        33.710, abs=5e-4)


def test_the_frozen_reference_is_the_suites():
    """``portbench/reference/r2d2.py`` is a copy of ``tests/plain_r2d2.py``,
    the reference the CPU tests hold the port to."""
    with open(os.path.join(spec.ROOT, "tests", "plain_r2d2.py")) as fh:
        suite = fh.read()
    with open(os.path.join(spec.HERE, "reference", "r2d2.py")) as fh:
        assert fh.read() == suite
