"""The observability plane, counterpart of :mod:`apex_tpu.obs`.

* :mod:`~apex_tpu_torch.obs.spans` — chunk lineage spans stamped into
  chunk-message metadata at each hop (sealed -> send -> recv -> merge ->
  stage -> consume -> prio_wb), never into the payload, and the
  learner-side join into frame-age-at-train and param-propagation-lag.
* :mod:`~apex_tpu_torch.obs.trace` — a bounded, sampled, host-only
  trace-event ring per process, dumped as Chrome trace JSON, and the
  program spans (``span``) that land in it and in a running profiler's
  trace;
  :mod:`~apex_tpu_torch.obs.merge` aligns the per-process files into one
  fleet timeline.
* :mod:`~apex_tpu_torch.obs.metrics` — Prometheus text exposition served
  from the learner's fleet-status socket.
* :mod:`~apex_tpu_torch.obs.slo` — the fleet SLO engine judging those
  signals with burn-rate windows.

* :mod:`~apex_tpu_torch.obs.soak` — the saturation soak: a loadgen-fed
  fleet started through :mod:`apex_tpu_torch.runtime.launch`, the SLO
  engine sampled off the learner's status port, one ``SOAK_*.json``.

All of it is stdlib: host clock reads and deque appends, no device wait.
"""
