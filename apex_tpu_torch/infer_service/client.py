"""Actor-side half of the inference plane.

Counterpart of :mod:`apex_tpu.infer_service.client`.  One DEALER per
worker, driven by the worker's thread alone.  :meth:`InferClient.submit`
ships one half-group's policy inputs and returns a :class:`PendingInfer`
without blocking, so a vector step submits both half-groups before it
waits for either and the two land in one server batch.

Fallback: :meth:`InferClient.collect` waits at most ``comms.infer_wait_s``
for the reply, then runs the local policy on the same inputs and the
same generator (a fallback changes scheduling, not the trajectory, on
one backend).  A timeout marks the server down: later submits skip the
wire and act locally, and one real request re-probes the server every
``comms.infer_reprobe_s``, so a respawned server gets its traffic back.
A ``dry`` reply (the server has no params yet) falls back at once.

Epoch fencing: every reply carries the learner epoch the server acted
under; one stamped with an older epoch than the newest seen is counted
and discarded.  Replies go through the restricted wire unpickler.

Lineage: a request is born with a span (``infer_send``), which the reply
brings back stamped ``infer_reply``; each answered round trip is an
``infer_rt`` event on the ``infer-client`` track of the trace ring.

Tenancy: a worker of a non-default tenant (``APEX_TENANT``) stamps its
tenant on every request, so a shared server answers it under that
tenant's params (:mod:`apex_tpu_torch.tenancy.namespace`).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import zmq

from apex_tpu_torch.config import CommsConfig
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import get_ring
from apex_tpu_torch.runtime import wire
from apex_tpu_torch.serving import fence
from apex_tpu_torch.tenancy import namespace as tenancy_ns


class Window:
    """The last ``n`` observations, with their percentiles (the JAX
    package's ``LatencyHistogram`` without its spans)."""

    def __init__(self, n: int = 1024):
        self._values: deque = deque(maxlen=n)

    def record(self, value: float) -> None:
        self._values.append(float(value))

    def __len__(self) -> int:
        return len(self._values)

    def percentile(self, q: float) -> float:
        if not self._values:
            return 0.0
        return float(np.percentile(np.asarray(self._values), q))


class PendingInfer:
    """One in-flight half-group request; :meth:`materialize` is where the
    step blocks, as the local path blocks on its result."""

    __slots__ = ("client", "rid", "sent", "fallback", "t0")

    def __init__(self, client: "InferClient", rid: int, sent: bool,
                 fallback, t0: float):
        self.client = client
        self.rid = rid
        self.sent = sent
        self.fallback = fallback
        self.t0 = t0

    def materialize(self) -> tuple:
        return self.client.collect(self)


class InferClient:
    """Submit/collect over one DEALER, with the local fallback and the
    down-marker and re-probe."""

    def __init__(self, comms: CommsConfig, identity: str,
                 wait_s: float | None = None,
                 reprobe_s: float | None = None, port: int | None = None):
        self.comms = comms
        self.identity = identity
        # this worker's tenant, stamped on every request so a shared
        # server dispatches it under this tenant's params; the default
        # tenant's requests stay unstamped (the single-tenant schema)
        self.tenant = tenancy_ns.current_tenant()
        self.shard = 0              # home shard (serving/shard.py stamps it)
        self.sock = zmq.Context.instance().socket(zmq.DEALER)
        self.sock.setsockopt(zmq.IDENTITY, f"{identity}-infer".encode())
        # a bounded send queue: requests to a dead server fail fast into
        # the fallback
        self.sock.setsockopt(zmq.SNDHWM, 16)
        self.sock.connect(
            f"tcp://{comms.infer_ip}:{port or comms.infer_port}")
        self.wait_s = (comms.infer_wait_s if wait_s is None
                       else float(wait_s))
        self.reprobe_s = (comms.infer_reprobe_s if reprobe_s is None
                          else float(reprobe_s))
        self._rid = 0
        self._replies: dict[int, dict | None] = {}
        self._outstanding: set[int] = set()
        self._down_since: float | None = None
        self.remote_steps = 0
        self.fallbacks = 0
        # fallbacks after the first remote reply: the share that says
        # whether a running server actually serves this worker
        self.late_fallbacks = 0
        self.stale_epoch = 0
        self.rejected = 0
        self.reprobes = 0
        # round trips, a timed-out request's included at its wait
        self.round_trip = Window(1024)
        self.epoch_seen = 0         # newest learner epoch in a reply
        self.last_version = 0       # newest param version in a reply
        self._ring = get_ring()

    # -- submit/collect ------------------------------------------------------

    def _remote_ok(self) -> bool:
        """False while the server is marked down, except for one real
        probe per re-probe period."""
        if self._down_since is None:
            return True
        if self.reprobe_s > 0 and (time.monotonic() - self._down_since
                                   >= self.reprobe_s):
            self._down_since = time.monotonic()
            self.reprobes += 1
            return True
        return False

    def submit(self, obs, eps, seed: int, group: int,
               fallback) -> PendingInfer:
        """Ship one half-group request and return its handle.  ``seed``
        and ``group`` name the step's group generator
        (:func:`~apex_tpu_torch.actors.vector.group_generator`);
        ``fallback`` is the zero-argument local policy call giving the
        same ``(actions, q)``."""
        rid = self._rid
        self._rid += 1
        t0 = time.monotonic()
        sent = False
        if self._remote_ok():
            msg = {"rid": rid, "obs": np.asarray(obs),
                   "eps": np.asarray(eps, np.float32), "seed": int(seed),
                   "group": int(group)}
            if not tenancy_ns.is_default(self.tenant):
                msg["tenant"] = self.tenant
            if obs_spans.enabled():
                msg[obs_spans.SPAN_KEY] = [
                    obs_spans.new_span(hop="infer_send")]
            try:
                self.sock.send(wire.dumps(("infer", msg)), zmq.DONTWAIT)
                sent = True
                self._outstanding.add(rid)
            except zmq.Again:
                pass            # a full send queue is a down server
        return PendingInfer(self, rid, sent, fallback, t0)

    def collect(self, pending: PendingInfer) -> tuple:
        """The reply within ``wait_s``, else the local fallback (and the
        down-marker, so later steps skip the wait)."""
        rid = pending.rid
        if pending.sent:
            deadline = pending.t0 + self.wait_s
            while True:
                self._drain()
                if rid in self._replies:
                    rep = self._replies.pop(rid)
                    self._outstanding.discard(rid)
                    if rep is not None:
                        self._down_since = None
                        self.remote_steps += 1
                        rt = time.monotonic() - pending.t0
                        self.round_trip.record(rt)
                        self._ring.complete("infer_rt",
                                            time.perf_counter() - rt, rt,
                                            track="infer-client")
                        return (np.asarray(rep["actions"]),
                                np.asarray(rep["q"]))
                    break       # dry reply: the server has no params yet
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._outstanding.discard(rid)
                    self.round_trip.record(time.monotonic() - pending.t0)
                    if self._down_since is None:
                        self._down_since = time.monotonic()
                    break
                self.sock.poll(min(50.0, remaining * 1000.0), zmq.POLLIN)
        self.fallbacks += 1
        if self.remote_steps:
            self.late_fallbacks += 1
        return tuple(np.asarray(x) for x in pending.fallback())

    def _drain(self) -> None:
        """Decode every queued reply and file it by request id; a reply
        from an older learner life is counted and discarded."""
        while self.sock.poll(0, zmq.POLLIN):
            try:
                got = wire.restricted_loads(self.sock.recv())
            except wire.WireRejected:
                self.rejected += 1
                continue
            if not (isinstance(got, tuple) and len(got) == 2
                    and isinstance(got[1], dict)):
                self.rejected += 1
                continue
            kind, body = got
            if kind == "dry":
                rid = int(body.get("rid", -1))
                if rid in self._outstanding:
                    self._replies[rid] = None
                continue
            if kind != "act":
                self.rejected += 1
                continue
            epoch = int(body.get("epoch", 0))
            if epoch and fence.stale_epoch(epoch, self.epoch_seen):
                self.stale_epoch += 1
                continue
            if epoch:
                self.epoch_seen = epoch
            self.last_version = max(self.last_version, int(body.get("pv", 0)))
            rid = int(body.get("rid", -1))
            if rid not in self._outstanding:
                continue        # a timed-out request's late reply
            spans = body.get(obs_spans.SPAN_KEY)
            if spans:
                obs_spans.stamp_spans(spans, "infer_reply")
            self._replies[rid] = body

    # -- observability -------------------------------------------------------

    def gauges(self) -> dict:
        """The worker's remote-policy health, for its heartbeats."""
        rt = self.round_trip
        return {"infer_shard": self.shard,
                "infer_remote": self.remote_steps,
                "infer_fallbacks": self.fallbacks,
                "infer_late_fallbacks": self.late_fallbacks,
                "infer_stale_epoch": self.stale_epoch,
                "infer_epoch_seen": self.epoch_seen,
                "infer_reprobes": self.reprobes,
                "infer_rt_ms_p50": round(rt.percentile(50) * 1000.0, 3),
                "infer_rt_ms_p90": round(rt.percentile(90) * 1000.0, 3),
                "infer_rt_ms_p99": round(rt.percentile(99) * 1000.0, 3)}

    def close(self) -> None:
        self.sock.close(linger=0)
