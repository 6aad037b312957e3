"""Chunk lineage spans: timestamp metadata following one chunk fleet-wide.

Counterpart of :mod:`apex_tpu.obs.spans`, the same hops, keys and
histograms, and the port's own per-hop histograms and set-up milestones
(stdlib only).

A span is a tiny dict riding OUTSIDE the tensor payload on the chunk
message (``msg[SPAN_KEY]`` is a list of spans — one per source chunk
after merges), so the ingest path's bit-parity contracts
(``merge_chunk_messages`` compares payloads field for field) never see it:

    {"pv": <param version the chunk was acted under>,
     "hops": {hop: (monotonic, wall), ...}}

Hops, in stream order (all optional — a transport that skips one just
leaves the histogram that needs it un-fed):

    sealed   actor: chunk materialized by the FrameChunkBuilder drain
    send     actor: handed to the chunk queue / socket sender
    recv     learner: decoded off the wire (or polled off the mp queue)
    merge    learner: coalesced into a merged/stacked ingest payload
    stage    learner: host-to-device staged by the ingest pipeline
    consume  learner: fused/ingest dispatch issued with this chunk
    prio_wb  learner: dispatch returned (the priority write-back is
             part of that dispatch — this is its host issue-complete
             time, the closest host-observable proxy)

Both clocks are stamped because neither alone survives the fleet:
monotonic is comparable only within one process (frame-age across the
actor->learner boundary uses wall), wall is comparable across hosts only
up to skew (the heartbeat-derived offsets in
:mod:`apex_tpu_torch.fleet.registry` measure that skew; ``obs.merge`` applies
it).  Stamping is first-wins per hop, so a double-instrumented path
(socket recv + pipeline poll) keeps the earlier, truer time.

The learner-side join lives in :class:`LearnerObs`: a bounded
publish-time ledger (version -> publish clocks) plus the two headline
:class:`LatencyHistogram`\\ s — *frame-age-at-train* (consume wall -
sealed wall) and *param-propagation-lag* (consume mono - publish mono of
the version the chunk was ACTED under: how long a published policy takes
to come back as trainable experience, the Ape-X staleness loop measured
end to end) — and one more per consecutive pair of present hops
(``send→recv``: a chunk's wait between the actor's put and the learner's
poll), read off ``summary()["hops_s"]``.

:class:`SetupClock` stamps the set-up milestones of one ``train()`` call.

Everything is stdlib + host clocks, and never waits for the device: safe
on hot loops.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, deque

from apex_tpu_torch.utils.metrics import percentile

#: chunk-message metadata key (a LIST of span dicts)
SPAN_KEY = "obs_spans"

#: canonical hop order (lineage trace events pair consecutive present
#: hops).  The three shard_* hops exist only on the sharded replay
#: service path (apex_tpu_torch/replay_service): chunk decoded on the shard
#: socket -> folded into a pre-sampled batch -> batch handed to the
#: learner's pull — so frame-age-at-train stays measurable across the
#: extra network hop (a batch carries the spans of the freshest source
#: chunks folded into it since the previous sample).  The three infer_*
#: hops ride POLICY-REQUEST messages on the inference plane
#: (apex_tpu_torch/infer_service): request shipped by the actor -> coalesced
#: into a server batch -> reply issued — they precede ``sealed`` because
#: acting happens before the transition is recorded, and they keep the
#: extra acting-time network hop visible in the same span vocabulary.
HOPS = ("infer_send", "infer_batch", "infer_reply",
        "sealed", "send", "shard_recv", "shard_sample", "batch_send",
        "recv", "merge", "stage", "consume", "prio_wb")


def enabled() -> bool:
    """Span stamping is on by default; ``APEX_OBS_SPANS=0`` disables it
    (the A/B for "does stamping cost anything on this box")."""
    return os.environ.get("APEX_OBS_SPANS", "1").lower() not in (
        "0", "false", "no")


def _now() -> tuple[float, float]:
    return (time.monotonic(), time.time())


def new_span(param_version: int = 0, hop: str = "sealed") -> dict:
    return {"pv": int(param_version), "hops": {hop: _now()}}


def spans_of(msg) -> list:
    """The message's span list ([] when unstamped/disabled)."""
    if isinstance(msg, dict):
        return msg.get(SPAN_KEY) or []
    return []


def stamp_spans(spans, hop: str) -> None:
    """Stamp ``hop`` on every span that lacks it (first wins: pipeline
    order is monotone, so the earliest stamp is the true hop time)."""
    if not spans:
        return
    t = _now()
    for span in spans:
        span["hops"].setdefault(hop, t)


def stamp(msg, hop: str) -> None:
    """Stamp ``hop`` on a chunk message's spans; no-op when unstamped."""
    stamp_spans(spans_of(msg), hop)


def mark_send(msg, param_version: int = 0) -> None:
    """Actor-side send site: ensure the message carries a span (sealed is
    stamped by ``drain_builder_chunks``; a bare message gets one here),
    record the param version the chunk was acted under, and stamp
    ``send``.  One call per chunk put, both worker loops."""
    if not enabled() or not isinstance(msg, dict):
        return
    spans = msg.get(SPAN_KEY)
    if not spans:
        spans = msg[SPAN_KEY] = [new_span(param_version, hop="sealed")]
    t = _now()
    for span in spans:
        span["pv"] = int(param_version)
        span["hops"].setdefault("send", t)


def merge_spans(msgs: list, hop: str = "merge") -> list:
    """Flatten the span lists of ``msgs`` (merge/stack/aggregate sites)
    and stamp ``hop`` — the merged message carries one span per SOURCE
    chunk, so per-chunk ages survive coalescing."""
    out: list = []
    for m in msgs:
        out.extend(spans_of(m))
    stamp_spans(out, hop)
    return out


class LatencyHistogram:
    """Bounded sliding-window histogram (seconds): record floats, read
    nearest-rank percentiles.  Pure host bookkeeping."""

    def __init__(self, window: int = 4096):
        self._vals: deque[float] = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, v: float) -> None:
        v = float(v)
        self._vals.append(v)
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    def snapshot(self) -> dict:
        s = sorted(self._vals)
        return {
            "count": self.count,
            "mean_s": round(self.total / self.count, 6) if self.count else 0.0,
            "p50_s": round(percentile(s, 0.50), 6),
            "p90_s": round(percentile(s, 0.90), 6),
            "p99_s": round(percentile(s, 0.99), 6),
            "max_s": round(self.max, 6),
        }


class TimedHistogram(LatencyHistogram):
    """A :class:`LatencyHistogram` that keeps each value's wall time too,
    so that a snapshot can keep to the values recorded between two
    times."""

    def __init__(self, window: int = 4096):
        super().__init__(window)
        self._at: deque[float] = deque(maxlen=window)

    def record(self, v: float, at: float = 0.0) -> None:
        super().record(v)
        self._at.append(at)

    def snapshot(self, between: tuple[float, float] | None = None) -> dict:
        """The whole window's snapshot, or with ``between = (lo, hi)``
        that of the values recorded at ``lo <= at <= hi``."""
        if between is None:
            return super().snapshot()
        lo, hi = between
        part = LatencyHistogram(max(1, len(self._vals)))
        for v, at in zip(self._vals, self._at):
            if lo <= at <= hi:
                part.record(v)
        return part.snapshot()


class LearnerObs:
    """Learner-side span join: publish ledger + the two headline
    histograms + one histogram per hop pair (``hops``) + sampled
    chunk-lineage trace events.

    Call order per consumed slot (both the pipelined and serial drains):
    :meth:`pre_consume` immediately before the dispatch (stamps
    ``consume``), :meth:`post_consume` right after the dispatch call
    returns (stamps ``prio_wb``, feeds the histograms, emits lineage
    events).  :meth:`note_publish` records each version's publish time —
    the join key for param-propagation-lag.
    """

    def __init__(self, ring=None, max_versions: int = 1024,
                 clock=time.monotonic, wall=time.time):
        self.frame_age = LatencyHistogram()
        self.param_lag = LatencyHistogram()
        # one per consecutive pair of present hops, "sealed→send", ...,
        # each value at its chunk's consume wall time
        self.hops: dict[str, TimedHistogram] = {}
        self._pub: OrderedDict[int, tuple[float, float]] = OrderedDict()
        self._max_versions = max_versions
        self.ring = ring
        self._clock = clock
        self._wall = wall
        self.spans_consumed = 0

    # -- publish ledger ----------------------------------------------------

    def note_publish(self, version: int) -> None:
        self._pub[int(version)] = (self._clock(), self._wall())
        while len(self._pub) > self._max_versions:
            self._pub.popitem(last=False)

    # -- consume join ------------------------------------------------------

    def pre_consume(self, spans) -> None:
        stamp_spans(spans, "consume")

    def post_consume(self, spans) -> None:
        if not spans:
            return
        stamp_spans(spans, "prio_wb")
        now_mono, now_wall = self._clock(), self._wall()
        for span in spans:
            self.spans_consumed += 1
            hops = span.get("hops", {})
            sealed = hops.get("sealed")
            if sealed is not None:
                # wall clocks: the only pair comparable across the
                # actor->learner process (or host) boundary
                age = now_wall - sealed[1]
                if age >= 0:
                    self.frame_age.record(age)
            pub = self._pub.get(int(span.get("pv", -1)))
            if pub is not None:
                # mono clocks: publish and consume both happen HERE
                self.param_lag.record(max(0.0, now_mono - pub[0]))
            self._join_hops(span, now_wall)

    def _join_hops(self, span: dict, now_wall: float) -> None:
        """Each consecutive pair of present hops, on the wall clock (the
        pairs cross processes): into its histogram in :attr:`hops` at
        ``now_wall``, and
        with a ring, one trace event on the learner ring's wall timebase
        — the chunk's whole journey renders as one stacked track in the
        merged perfetto timeline."""
        hops = span.get("hops", {})
        present = [(h, hops[h]) for h in HOPS if h in hops]
        for (h1, t1), (h2, t2) in zip(present, present[1:]):
            dur = t2[1] - t1[1]
            if dur < 0:          # cross-host wall skew can invert a hop
                continue
            pair = f"{h1}→{h2}"
            hist = self.hops.get(pair)
            if hist is None:
                hist = self.hops[pair] = TimedHistogram(1 << 14)
            hist.record(dur, now_wall)
            if self.ring is not None:
                self.ring.complete_wall(pair, t1[1], dur,
                                        track="chunk-lineage",
                                        args={"pv": span.get("pv", 0)})

    # -- read surface ------------------------------------------------------

    def scalars(self) -> dict:
        """The ``obs_*`` learner scalar set (logged at the trainer's log
        cadence)."""
        fa, pl = self.frame_age.snapshot(), self.param_lag.snapshot()
        return {
            "obs_frame_age_p50_s": fa["p50_s"],
            "obs_frame_age_p99_s": fa["p99_s"],
            "obs_param_lag_p50_s": pl["p50_s"],
            "obs_param_lag_p99_s": pl["p99_s"],
            "obs_spans_consumed": self.spans_consumed,
        }

    def summary(self, between: tuple[float, float] | None = None) -> dict:
        """The e2e bench ``latency`` section body; with ``between`` (wall
        seconds), ``hops_s`` holds only the chunks consumed within it."""
        return {
            "frame_age_at_train_s": self.frame_age.snapshot(),
            "param_propagation_lag_s": self.param_lag.snapshot(),
            "spans_consumed": self.spans_consumed,
            "hops_s": {pair: hist.snapshot(between)
                       for pair, hist in dict(self.hops).items()},
        }


class SetupClock:
    """The set-up milestones of one ``train()`` call on ``clock``, each
    stamped once, in :attr:`MILESTONES` order: the call's entry (at
    construction), the pool started, the first chunk ingested, the replay
    warm, the first learner step returned.  With an enabled ``ring``,
    each milestone is also one ``apex.setup.<name>`` event on ``track``
    lasting from the milestone before it."""

    MILESTONES = ("train", "pool_started", "first_ingest", "warm",
                  "first_step")

    def __init__(self, ring=None, track: str | None = None,
                 clock=time.monotonic):
        self._clock = clock
        self.ring = ring
        self.track = track
        self.stamps: dict[str, float] = {}
        self.pending = True
        self.stamp("train")

    def stamp(self, name: str) -> None:
        if name in self.stamps:
            return
        t = self._clock()
        if self.ring is not None and self.ring.enabled and self.stamps:
            dur = t - max(self.stamps.values())
            self.ring.complete(f"apex.setup.{name}",
                               time.perf_counter() - dur, dur,
                               track=self.track)
        self.stamps[name] = t
        self.pending = len(self.stamps) < len(self.MILESTONES)

    def observe(self, ingested: bool, warm: bool, stepped: bool) -> None:
        """The hot loop's milestones, checked once an iteration while any
        is pending."""
        if ingested:
            self.stamp("first_ingest")
        if warm:
            self.stamp("warm")
        if stepped:
            self.stamp("first_step")

    def durations(self) -> dict:
        """Seconds between consecutive stamped milestones
        (``"pool_started_to_first_ingest"``, ...) and from the call's entry
        to the first step (``"train_to_first_step"``)."""
        got = [(n, self.stamps[n]) for n in self.MILESTONES
               if n in self.stamps]
        out = {f"{a}_to_{b}": tb - ta
               for (a, ta), (b, tb) in zip(got, got[1:])}
        if "first_step" in self.stamps:
            out["train_to_first_step"] = (self.stamps["first_step"]
                                          - self.stamps["train"])
        return out
