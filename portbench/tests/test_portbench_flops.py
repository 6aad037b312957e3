"""The configuration's FLOP count against torch's own counter on the
reference net, and the gather's byte count against its published bound."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import spec
from portbench.flops import trunk_macs
from portbench.reference.nets import dueling_q

NAME = "apex-dqn-84x84"


def _flops_module():
    return spec._module(os.path.join(spec.HERE, "configs", f"{NAME}.py"),
                        "test_flops_" + spec._ident(NAME))


def _config():
    with open(os.path.join(spec.HERE, "configs", f"{NAME}.json")) as fh:
        return json.load(fh)


def _dueling_params(config):
    sh = config["shapes"]
    h, w, c = sh["frame"]
    c *= config["settings"]["env"]["frame_stack"]
    _, flat = trunk_macs(h, w, c, sh["trunk"])
    g = torch.Generator().manual_seed(0)
    shapes = {}
    for i, (feats, k, _) in enumerate(sh["trunk"]):
        shapes |= {f"Conv_{i}.weight": (feats, c, k, k),
                   f"Conv_{i}.bias": (feats,)}
        c = feats
    for name, out in (("advantage", sh["actions"]), ("value", 1)):
        shapes |= {f"{name}_hidden.weight": (sh["head_width"], flat),
                   f"{name}_hidden.bias": (sh["head_width"],),
                   f"{name}_out.weight": (out, sh["head_width"]),
                   f"{name}_out.bias": (out,)}
    return {k: torch.randn(s, generator=g) * 0.05 for k, s in shapes.items()}


def test_forward_flops_match_the_counter():
    m, config = _flops_module(), _config()
    p = _dueling_params(config)
    h, w, _ = config["shapes"]["frame"]
    x = torch.randint(0, 255, (3, h, w, 4), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        dueling_q(p, x)
    assert fc.get_total_flops() == 3 * m.forward_flops_per_sample(config)


def test_a_step_is_five_batches_of_forwards():
    m, config = _flops_module(), _config()
    b = config["settings"]["learner"]["batch_size"]
    assert m.flops_per_step(config) == 5 * b * m.forward_flops_per_sample(
        config)
    assert m.forward_flops_per_sample(config) == 2 * 8_540_672


@pytest.mark.parametrize("batch", [1, 64, 512])
def test_the_count_follows_the_configured_batch(batch):
    m, config = _flops_module(), _config()
    config["settings"]["learner"]["batch_size"] = batch
    assert m.flops_per_step(config) == 5 * batch * 2 * 8_540_672
    assert m.gather_bytes_per_step(config) == 2 * batch * 4 * (2 * 7056 + 4)


def test_gather_bytes_meet_the_published_bound():
    """PERF.md's bound of ``gather_stacks`` at ids [1024, 4]: 17.259 us at
    3.35 TB/s."""
    from portbench.peaks import peaks
    _, rate = peaks("NVIDIA H100 80GB HBM3")
    m = _flops_module()
    assert m.gather_bytes_per_step(_config()) / rate * 1e6 == pytest.approx(
        17.259, abs=5e-4)
