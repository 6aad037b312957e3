"""Device-resident prioritized replay: the stateful twin of
:class:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay`.

Counterpart of :mod:`apex_tpu.ondevice.replay`.  The frame pool is a spec
of three in-place methods (add, sample, priority update) that drivers call
with a state; :class:`DeviceFramePool` binds them to one resident
:class:`~apex_tpu_torch.replay.frame_pool.FramePoolState`, its own
generator for the sample's per-stratum uniforms (where the JAX pool keeps
a PRNG key chain) and host counters.  There is no second implementation:
every method is the spec's.

Durability: :meth:`DeviceFramePool.snapshot` writes the whole pool (state,
generator, counters, spec pins) with
:func:`~apex_tpu_torch.training.checkpoint.save_bundle` (atomic
tmp + rename), and :meth:`DeviceFramePool.restore` refuses a snapshot that
a different spec wrote, naming the field, before it overwrites anything.
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.checkpoint import restore_bundle, save_bundle


class DeviceFramePool:
    """One device-resident frame pool driven from the host.

    ``spec`` is the :class:`FramePoolReplay`; the pool owns the state on
    ``device`` (default the card), the generator (seeded ``seed``) and the
    counters."""

    def __init__(self, spec: FramePoolReplay, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.state = spec.init(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.adds = 0
        self.samples = 0
        self.updates = 0
        self.ingested = 0

    # -- the three methods -------------------------------------------------

    def add(self, chunk: dict, priorities) -> None:
        self.state = self.spec.add(self.state, chunk, priorities)
        self.adds += 1
        self.ingested += int(chunk["n_trans"])

    def sample(self, batch_size: int, beta: float,
               offsets: torch.Tensor | None = None):
        """``(batch, weights, idx)``; the uniforms come from the pool's
        generator unless ``offsets`` (f32[batch_size]) are given."""
        if offsets is None:
            offsets = stratified_offsets(batch_size, self.generator,
                                         self.device)
        self.samples += 1
        return self.spec.sample(self.state, offsets.to(self.device), beta)

    def update_priorities(self, idx, priorities) -> None:
        self.state = self.spec.update_priorities(
            self.state, torch.as_tensor(idx, device=self.device),
            torch.as_tensor(priorities, dtype=torch.float32,
                            device=self.device))
        self.updates += 1

    # -- snapshots ---------------------------------------------------------

    def _spec_pins(self) -> dict:
        s = self.spec
        return dict(capacity=s.capacity, frame_shape=list(s.frame_shape),
                    frame_stack=s.frame_stack, frame_capacity=s.f_capacity,
                    frame_dtype=s.frame_dtype, alpha=s.alpha, eps=s.eps)

    def _bundle(self) -> dict:
        return dict(state={f.name: getattr(self.state, f.name)
                           for f in dataclasses.fields(self.state)},
                    generator=self.generator.get_state())

    def snapshot(self, path: str) -> str:
        """Write the whole pool to ``path`` (atomic tmp + rename)."""
        meta = dict(counters=dict(adds=self.adds, samples=self.samples,
                                  updates=self.updates,
                                  ingested=self.ingested),
                    **self._spec_pins())
        return save_bundle(path, self._bundle(), meta)

    def restore(self, path: str) -> None:
        """Restore state, generator and counters in place.  A snapshot
        written by a different spec is refused before anything is
        overwritten, with the field that differs."""
        pins = self._spec_pins()

        def same_spec(meta: dict) -> None:
            for k, want in pins.items():
                got = meta.get(k)
                if got != want:
                    raise ValueError(
                        f"snapshot {path!r} was written by a different "
                        f"pool spec: {k}={got!r} != {want!r}; restore "
                        f"into a matching FramePoolReplay or discard the "
                        f"snapshot")

        bundle, meta = restore_bundle(path, self._bundle(), check=same_spec)
        for name, value in bundle["state"].items():
            setattr(self.state, name, value)
        self.generator.set_state(bundle["generator"])
        c = meta.get("counters", {})
        self.adds = int(c.get("adds", 0))
        self.samples = int(c.get("samples", 0))
        self.updates = int(c.get("updates", 0))
        self.ingested = int(c.get("ingested", 0))

    def counters(self) -> dict:
        return {"adds": self.adds, "samples": self.samples,
                "updates": self.updates, "ingested": self.ingested,
                "size": self.state.size, "hbm_bytes": self.spec.hbm_bytes()}
