"""Learner-side client of the sharded replay service.

Counterpart of :mod:`apex_tpu.replay_service.client`.  One DEALER per
shard, all driven by one thread: the ingest pipeline's staging thread
when the pipeline is on, else the trainer's.  The sockets are made on the
caller's thread and handed over once, which zmq tolerates.

Protocol per shard (DEALER to the shard's ROUTER,
:mod:`apex_tpu_torch.replay_service.service`):

* ``("pull", epoch)`` -> ``("batch", msg)`` or ``("dry", info)``
* ``("prio", seq, idx, prios, epoch)`` -> no reply

A non-default tenant's learner (``APEX_TENANT``) appends its tenant to
both, so the shard routes them to that tenant's partition, and qualifies
its DEALER identities, so two tenants' learners never collide on one
shard's ROUTER.

At most one pull is outstanding per shard, re-sent after
:data:`RETRY_S`.
Replies go through the restricted wire unpickler.  Round-robin starts at
a rotating cursor, so no shard starves behind a busy one, and a shard
that stops answering stops contributing batches.  A received batch's
lineage spans are stamped ``recv``.  Under ``CHAOS_SEED`` an
``epoch_skew`` entry for the client's identity shifts the epoch its
write-backs carry (a negative skew makes them stale: the shards must
reject and count them).
"""

from __future__ import annotations

import time

import numpy as np
import zmq

from apex_tpu_torch.config import CommsConfig
from apex_tpu_torch.fleet.chaos import chaos_from_env
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.runtime import wire
from apex_tpu_torch.tenancy import namespace as tenancy_ns

#: seconds before an unanswered pull is sent again (a shard that died
#: mid-request is probed, not trusted)
RETRY_S = 2.0


class ReplayServiceClient:
    """Round-robin batch puller and priority write-back router."""

    def __init__(self, comms: CommsConfig, identity: str = "learner"):
        self.comms = comms
        self.n_shards = comms.replay_shards
        if self.n_shards <= 0:
            raise ValueError("ReplayServiceClient needs replay_shards > 0")
        self.tenant = tenancy_ns.current_tenant()
        identity = tenancy_ns.qualify(self.tenant, identity)
        ctx = zmq.Context.instance()
        self.socks = []
        for s in range(self.n_shards):
            sock = ctx.socket(zmq.DEALER)
            sock.setsockopt(zmq.IDENTITY, f"{identity}-{s}".encode())
            # pulls and write-backs to a dead shard are counted below,
            # not queued without bound
            sock.setsockopt(zmq.SNDHWM, 64)
            sock.connect(
                f"tcp://{comms.replay_ip}:{comms.replay_port_base + s}")
            self.socks.append(sock)
        self._poller = zmq.Poller()
        for sock in self.socks:
            self._poller.register(sock, zmq.POLLIN)
        self._rr = 0
        self._outstanding = [False] * self.n_shards
        self._last_pull = [0.0] * self.n_shards
        self._ingested = [0] * self.n_shards
        self._stale_wb = [0] * self.n_shards
        self._restored = [0] * self.n_shards
        self.batches = 0
        self.batch_bytes = 0        # wire bytes of the batches received
        self.pull_s = 0.0           # pull-to-reply seconds, summed
        self.rejected = 0           # replies outside the wire allowlist
        self.prio_sent = 0
        self.prio_dropped = 0       # write-backs a full send queue refused
        self.unanswered = [0] * self.n_shards   # consecutive pull retries
        # the trainer stamps its epoch here before training; 0 sends
        # unstamped pulls (fencing off)
        self.learner_epoch = 0
        chaos = chaos_from_env()
        self.epoch_skew = (chaos.plan_for(identity).epoch_skew
                           if chaos is not None else 0)

    # -- pulls ---------------------------------------------------------------

    def _ensure_pull(self, s: int, now: float) -> None:
        if self._outstanding[s] and now - self._last_pull[s] < RETRY_S:
            return
        if self._outstanding[s]:
            self.unanswered[s] += 1     # the last pull went unanswered
        if not tenancy_ns.is_default(self.tenant):
            # a tenant's pull always names it (its epoch may be 0)
            msg = ("pull", self.learner_epoch, self.tenant)
        else:
            msg = (("pull", self.learner_epoch) if self.learner_epoch
                   else ("pull",))
        try:
            self.socks[s].send(wire.dumps(msg), zmq.DONTWAIT)
            self._outstanding[s] = True
            self._last_pull[s] = now
        except zmq.Again:
            pass

    def _recv(self, s: int):
        """Drain replies off shard ``s``; a batch message or None."""
        while self.socks[s].poll(0, zmq.POLLIN):
            payload = self.socks[s].recv()
            self._outstanding[s] = False
            try:
                msg = wire.restricted_loads(payload)
                kind, body = msg[0], msg[1]
            except (wire.WireRejected, TypeError, IndexError, KeyError):
                self.rejected += 1
                continue
            self.unanswered[s] = 0
            if kind == "batch":
                body["shard"] = s
                self._ingested[s] = max(self._ingested[s],
                                        int(body.get("ingested", 0)))
                obs_spans.stamp(body, "recv")
                self.batches += 1
                self.batch_bytes += len(payload)
                self.pull_s += time.monotonic() - self._last_pull[s]
                return body
            if kind == "dry":
                self._ingested[s] = max(self._ingested[s],
                                        int(body.get("ingested", 0)))
                self._stale_wb[s] = max(self._stale_wb[s],
                                        int(body.get("stale_wb", 0)))
                self._restored[s] = max(self._restored[s],
                                        int(body.get("restored", 0)))
        return None

    def poll_batch(self, timeout: float = 0.0) -> dict | None:
        """The next pre-sampled batch, round-robin over the shards; None
        when no shard served one within ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            now = time.monotonic()
            for off in range(self.n_shards):
                s = (self._rr + off) % self.n_shards
                self._ensure_pull(s, now)
                got = self._recv(s)
                if got is not None:
                    self._rr = (s + 1) % self.n_shards
                    return got
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self._poller.poll(min(50.0, remaining * 1000.0))

    # -- write-backs ---------------------------------------------------------

    def push_priorities(self, shard: int, seq: int, idx,
                        priorities) -> bool:
        """Ship one batch's TD priorities to its shard, stamped with the
        learner epoch (plus any chaos skew).  Never blocks: a full send
        queue (a dead shard) counts the write-back as dropped."""
        epoch = (max(0, self.learner_epoch + self.epoch_skew)
                 if self.learner_epoch else 0)
        msg = ("prio", int(seq), np.asarray(idx),
               np.asarray(priorities, np.float32), int(epoch))
        if not tenancy_ns.is_default(self.tenant):
            msg = msg + (self.tenant,)
        try:
            self.socks[int(shard)].send(wire.dumps(msg), zmq.DONTWAIT)
            self.prio_sent += 1
            return True
        except zmq.Again:
            self.prio_dropped += 1
            return False

    # -- observability -------------------------------------------------------

    def ingested_total(self) -> int:
        """Sum of the shards' last reported ingest counts: the service
        mode's input to the trainer's replay-ratio budget."""
        return sum(self._ingested)

    def shard_status(self) -> list[dict]:
        return [{"shard": s, "ingested": self._ingested[s],
                 "unanswered": self.unanswered[s],
                 "stale_wb": self._stale_wb[s],
                 "restored": self._restored[s]}
                for s in range(self.n_shards)]

    def close(self) -> None:
        for sock in self.socks:
            sock.close(linger=0)
