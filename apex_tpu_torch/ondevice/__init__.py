"""The on-device replay plane: the rollout, ingest, prioritized sample,
train and priority write-back cycle with the host only in its epilogue.

Counterpart of :mod:`apex_tpu.ondevice` at dp = 1:

* :mod:`apex_tpu_torch.ondevice.replay` -- :class:`DeviceFramePool`, the
  stateful twin of the frame-pool replay (its own sample generator, host
  counters, snapshots through the checkpoint format).
* :mod:`apex_tpu_torch.ondevice.fused` -- :class:`FusedStep` (the macro
  step) and :class:`FusedApexTrainer` (its ``train()`` driver).
"""
