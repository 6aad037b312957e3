"""PyTorch/CUDA port of :mod:`apex_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``apex_tpu_torch/ops/tree.py`` is the counterpart of
``apex_tpu/ops/tree.py``, and so on) and imports only ``torch`` and
``numpy``.  The TPU kernel of the frame-ring gather is a hand-written CUDA
kernel here (:mod:`apex_tpu_torch.ops.gather`), and so is the segment
trees' update (:mod:`apex_tpu_torch.ops.tree`), which has no TPU kernel.

Entry points take ``device`` (default ``"cuda"``) and raise when no card is
present unless the caller asks for the CPU (:func:`resolve_device`).

Importing the package itself is stdlib-only, as ``import apex_tpu`` is:
torch loads inside :func:`resolve_device` and in the modules that hold
tensors, so the stdlib tools (``python -m apex_tpu_torch.analysis``, the
launcher, the soak, the ``--role status`` client) never pay for it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device: "str | torch.device" = "cuda") -> "torch.device":
    """The torch device an entry point runs on.  A CUDA request with no
    card present raises: there is no silent CPU path."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
