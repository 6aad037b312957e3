"""The port stands alone: no JAX, no gymnasium, no ``apex_tpu`` imports.

A scan of the source (``ast``), not of ``sys.modules``: the test process
has JAX loaded already (the image imports it at interpreter start, and
the parity tests import it), so what is loaded proves nothing.
"""

import ast
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gymnasium", "gym", "msgpack",
             "apex_tpu"}


def _port_files():
    files = sorted((REPO / "apex_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax_gym_or_apex_tpu():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_scan_sees_every_import_form(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nimport jax.numpy as jnp\n"
                     "from apex_tpu.ops import tree\n"
                     "def f():\n    import gymnasium\n"
                     "from apex_tpu_torch.ops import tree as t\n")
    roots = {root for _, root in _imported_roots(probe)}
    assert roots & FORBIDDEN == {"jax", "apex_tpu", "gymnasium"}


def test_entry_points_refuse_cuda_without_a_card(monkeypatch, tmp_path):
    from apex_tpu_torch import resolve_device
    from apex_tpu_torch.config import small_test_config
    from apex_tpu_torch.training.apex import ApexTrainer
    from apex_tpu_torch.training.checkpoint import evaluate_checkpoint
    from apex_tpu_torch.training.dqn import DQNTrainer

    path = DQNTrainer(small_test_config(), checkpoint_dir=str(tmp_path),
                      device="cpu").save_checkpoint()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ApexTrainer()                        # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DQNTrainer(small_test_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_checkpoint(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_gather_refuses_non_cuda_devices_it_cannot_serve():
    from apex_tpu_torch.ops.gather import gather_rows

    frames = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows(frames, torch.zeros(2, dtype=torch.int32, device="meta"))
