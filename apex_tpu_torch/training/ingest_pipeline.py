"""Async ingest pipeline: chunk polling, merging and host-to-device staging
off the learner thread.

Counterpart of :mod:`apex_tpu.training.ingest_pipeline` on its
single-shard plan (read its module docstring for the contract).  One
background staging thread:

* drains ``pool.poll_chunks`` (the shm ring's decode moves off the hot
  loop with it);
* groups chunks by what the trainer will do with them, predicted from the
  live counters (``state_fn``): train-eligible chunks become ``"single"``
  slots, or ``"scan"`` slots of up to ``scan_steps`` chunks for
  :meth:`~apex_tpu_torch.training.learner.LearnerCore.fused_multi_step`;
  ingest-only chunks (warm-up fill, replay-ratio cap) merge into one
  ``"merged"`` payload (:func:`merge_chunk_messages`), one ingest where
  the serial drain makes m;
* stages each slot for the device and hands it over through a bounded
  FIFO ring of ``depth`` slots, whose blocking put backpressures the pool
  (and so the actors) as the serial drain's queue does;
* serves param publishes: the trainer hands over a copy of its weights and
  this thread makes the device-to-host copy the actors need, or, for a
  pool that ``accepts_device_params`` (on-device rollouts), hands the
  device copy on after its stream has waited for it.

Staging.  On a CUDA device each of a slot's arrays is copied into pinned
host memory (``Tensor.pin_memory()``) and from there to the device with
a ``non_blocking`` copy on a side stream that the pipeline owns.  The
caching host allocator records that copy on the side stream, so a
pinned block is not handed out again while a copy from it is in flight.
An event recorded after the slot's copies rides with the slot.  When the
trainer takes the slot (:meth:`poll_slot`), its current stream waits on
the event and each staged tensor is recorded on that stream, so the
caching allocator cannot give it back to the side stream while the step
still reads it.  The staging thread sets the trainer's device and the
side stream as its own once, when it starts (both are per thread).  The
counts of :data:`HOST_SCALARS` stay host ints: the replays read them on
the host.  On the CPU a slot's arrays are wrapped with
``torch.as_tensor``, without a copy (the JAX pipeline's
``put_device=False``).

Ordering and numerics: chunks enter slots in poll order and the ring is
FIFO, so the replay sees the serial drain's stream; a merged ingest writes
the same cells, priorities and epochs as the chunks one by one (the frame
pool's ``epoch_off`` and duplicate-pad-write contract), so the pipelined
and serial trainers are bit-identical (``tests/test_torch_ingest_pipeline.py``).

Replay service mode (``replay_client``, ``ingest_pipeline.py:344-351,
647-681``): the staging thread also pulls pre-sampled batches round-robin
from the shards (the client's sockets are driven by this thread alone)
and stages each as a ``"batch"`` slot, the batch and its IS weights put on
the device ahead of the dispatch.  The trainer hands each trained batch's
priorities back through :meth:`IngestPipeline.write_back`; this thread
makes their device-to-host copy and sends them to the shard, so the copy
never lands on the hot loop.  Pending write-backs are flushed when the
thread stops, since a strict shard waits on them.

Lineage spans (:mod:`apex_tpu_torch.obs.spans`) ride message metadata,
never the payload: the staging thread stamps ``recv`` on each polled
message (first wins, so the socket receiver's earlier stamp survives),
``merge`` on a scan or merged group and ``stage`` on every slot, whose
``spans`` the trainer stamps ``consume`` and ``prio_wb`` on.  Each staged
slot, publish and write-back is one program span (``apex.ingest.stage``,
``.publish``, ``.writeback``; :func:`~apex_tpu_torch.obs.trace.span`) on
the ``ingest-staging`` track.

Sharded plan (``n_dp`` > 1, ``ingest_pipeline.py:55-74``): the pool is a
:class:`~apex_tpu_torch.parallel.aggregate.ChunkAggregator`, so each polled
message is one whole round-robin group of ``n_dp`` chunks stacked on a
leading dp axis, and the pipeline stages group-granular slots:

* a train-eligible group stages as a ``"single"`` slot; an ingest-only
  run of groups merges per shard (:func:`merge_group_messages`: shard s's
  chunks merge as the single-shard merge does, then the merged payloads
  restack on the dp axis), so the bit-parity contract holds per shard;
* staging splits each group by rank: rank 0's part goes to the device as
  above, the other ranks' parts are pickled for the host group
  (``StagedSlot.remote``), so neither lands on the hot loop;
* the per-rank PER uniforms are drawn ahead by a
  :class:`UniformPrefetcher` (the role of JAX's ``KeyPrefetcher``: one
  generator per rank, drawn in dispatch order, refilled on this thread,
  so pipelined and serial runs consume the same draws; a checkpoint
  keeps its generators and queue);
* a replay-service ``"batch"`` slot splits into contiguous per-rank
  blocks of ``batch / n_dp`` rows
  (:func:`~apex_tpu_torch.parallel.learner.split_batch`): rank 0's block
  is staged, the others' are pickled into ``StagedSlot.remote`` for the
  trainer's ``batch`` op, and the write-back takes the priorities of the
  whole batch, gathered in sample order.
"""

from __future__ import annotations

import queue as queue_lib
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import STAGING_TRACK, span
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.parallel.aggregate import (split_group, tree_index,
                                               tree_stack)
from apex_tpu_torch.parallel.learner import split_batch
from apex_tpu_torch.runtime import wire

#: payload keys that identify a self-contained frame chunk
#: (replay/frame_chunks.py), the only schema merge_chunk_messages takes
FRAME_CHUNK_KEYS = frozenset((
    "frames", "n_frames", "n_trans", "action", "reward", "discount",
    "obs_ref", "next_ref"))

#: message fields the replays read on the host (a frame chunk's counts, a
#: pooled sequence message's n_frames and n_seqs); staging keeps them ints
HOST_SCALARS = frozenset(("n_frames", "n_trans", "n_seqs"))

#: how long the staging thread's poll of an empty pool waits, seconds
POLL_TIMEOUT = 0.01


def is_frame_chunk(payload) -> bool:
    return isinstance(payload, dict) and FRAME_CHUNK_KEYS <= payload.keys()


def merge_chunk_messages(msgs: list[dict]) -> dict:
    """Merge m frame-chunk messages into one ingest message
    (``apex_tpu/training/ingest_pipeline.py:104-185``).

    Real rows of every chunk are compacted front to back (frames and
    transitions separately), ``obs_ref``/``next_ref`` are rebased by each
    chunk's cumulative real frame offset, and ``epoch_off`` carries that
    offset per transition, so the pool stamps the epochs a sequential
    ingest would.  Per-transition sidecars (``extras``, the AQL family's
    candidate sets) are concatenated as the transition fields are.  The
    tail pads by repeating the last real row, priorities included.
    Output shapes are ``[m*K]`` / ``[m*Kf, D]``.
    """
    if len(msgs) == 1:
        return msgs[0]
    payloads = [m["payload"] for m in msgs]
    k = payloads[0]["action"].shape[0]
    kf, d = payloads[0]["frames"].shape
    stack = payloads[0]["obs_ref"].shape[1]
    for p in payloads[1:]:
        if (p["action"].shape[0] != k or p["frames"].shape != (kf, d)
                or p["obs_ref"].shape[1] != stack):
            raise ValueError("merge_chunk_messages needs uniform chunk "
                             "shapes (one builder config per pool)")
    m = len(msgs)
    n_tr = [int(p["n_trans"]) for p in payloads]
    n_fr = [int(p["n_frames"]) for p in payloads]
    tot_tr, tot_fr = sum(n_tr), sum(n_fr)
    out_k, out_kf = m * k, m * kf
    cum_fr = np.concatenate(([0], np.cumsum(n_fr)[:-1])).astype(np.int64)

    frames = np.empty((out_kf, d), payloads[0]["frames"].dtype)
    off = 0
    for p, nf in zip(payloads, n_fr):
        frames[off:off + nf] = p["frames"][:nf]
        off += nf
    frames[tot_fr:] = frames[tot_fr - 1]

    def cat(rows: list[np.ndarray], dtype) -> np.ndarray:
        arr = np.concatenate(rows).astype(dtype, copy=False)
        out = np.empty((out_k,) + arr.shape[1:], dtype)
        out[:tot_tr] = arr
        out[tot_tr:] = arr[tot_tr - 1]
        return out

    def real(name: str) -> list[np.ndarray]:
        return [p[name][:nt] for p, nt in zip(payloads, n_tr)]

    payload = dict(
        frames=frames,
        n_frames=np.int32(tot_fr),
        n_trans=np.int32(tot_tr),
        action=cat(real("action"), np.int32),
        reward=cat(real("reward"), np.float32),
        discount=cat(real("discount"), np.float32),
        obs_ref=cat([r + c for r, c in zip(real("obs_ref"), cum_fr)],
                    np.int32),
        next_ref=cat([r + c for r, c in zip(real("next_ref"), cum_fr)],
                     np.int32),
        epoch_off=cat([np.full(nt, c) for nt, c in zip(n_tr, cum_fr)],
                      np.int32),
    )
    if "extras" in payloads[0]:
        payload["extras"] = {
            name: cat([p["extras"][name][:nt]
                       for p, nt in zip(payloads, n_tr)], np.float32)
            for name in payloads[0]["extras"]}
    prios = cat([np.asarray(msg["priorities"])[:nt]
                 for msg, nt in zip(msgs, n_tr)], np.float32)
    out = {"payload": payload, "priorities": prios, "n_trans": tot_tr}
    # lineage spans ride the message, never the payload, which the
    # bit-parity contract above compares field for field
    spans = obs_spans.merge_spans(msgs)
    if spans:
        out[obs_spans.SPAN_KEY] = spans
    return out


def merge_group_messages(msgs: list[dict], n_dp: int) -> dict:
    """Merge m stacked round-robin group messages into one sharded ingest
    message (``apex_tpu/training/ingest_pipeline.py:188-223``).  Shard s
    takes chunk s of every group, in group order, so its m chunks merge
    with :func:`merge_chunk_messages` and the ``n_dp`` merged payloads
    restack on the dp axis: ``add(merge(g1..gm)) == add(g1); ...;
    add(gm)`` on every shard."""
    if len(msgs) == 1:
        return msgs[0]
    per_shard = []
    for s in range(n_dp):
        shard_msgs = [
            {"payload": tree_index(m["payload"], s),
             "priorities": np.asarray(m["priorities"])[s],
             "n_trans": int(np.asarray(m["payload"]["n_trans"])[s])}
            for m in msgs]
        per_shard.append(merge_chunk_messages(shard_msgs))
    payload = tree_stack([p["payload"] for p in per_shard])
    prios = np.stack([np.asarray(p["priorities"], np.float32)
                      for p in per_shard])
    out = {"payload": payload, "priorities": prios,
           "n_trans": sum(int(p["n_trans"]) for p in per_shard)}
    spans = obs_spans.merge_spans(msgs)    # metadata, not payload
    if spans:
        out[obs_spans.SPAN_KEY] = spans
    return out


class UniformPrefetcher:
    """Pre-drawn per-rank PER uniforms for the sharded plan, in dispatch
    order: the role of JAX's ``KeyPrefetcher`` (``ingest_pipeline.py:
    225-268``), which pre-splits the dispatch key chain into per-chip
    keys.  ``generators`` holds one host ``torch.Generator`` per rank;
    entry i is one ``f32[per_rank]`` draw from each, the i-th dispatch's.
    The staging thread refills between polls; an empty queue draws inline
    under the same lock, so the sequence never forks."""

    def __init__(self, generators: list, per_rank: int, depth: int = 4):
        self.generators = list(generators)
        self.per_rank = per_rank
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._queue: deque = deque()

    def _gen(self) -> None:
        self._queue.append([stratified_offsets(self.per_rank, g, "cpu")
                            .numpy() for g in self.generators])

    def refill(self) -> None:
        """Top the queue up to ``depth`` (staging-thread side)."""
        with self._lock:
            while len(self._queue) < self.depth:
                self._gen()

    def take(self) -> list:
        """The next dispatch's uniforms, one array per rank."""
        with self._lock:
            if not self._queue:
                self._gen()
            return self._queue.popleft()

    def state(self) -> dict:
        """A checkpoint's record, taken under the lock: each generator's
        state (``uniform_generators``, ``u8[dp, n]``) and the draws queued
        but not taken (``uniform_queue``, ``f32[q, dp, per_rank]``), so a
        restored prefetcher hands out the same sequence."""
        with self._lock:
            queue = (np.stack([np.stack(e) for e in self._queue])
                     if self._queue else np.zeros(
                         (0, len(self.generators), self.per_rank),
                         np.float32))
            return {"uniform_generators": torch.stack(
                        [g.get_state() for g in self.generators]),
                    "uniform_queue": torch.from_numpy(queue)}

    def set_state(self, state: dict) -> None:
        """Take a :meth:`state` record."""
        gens, queue = state["uniform_generators"], state["uniform_queue"]
        if (tuple(gens.shape[:1]) != (len(self.generators),)
                or tuple(queue.shape[1:]) != (len(self.generators),
                                              self.per_rank)):
            raise ValueError(
                f"uniforms of {tuple(gens.shape)} / {tuple(queue.shape)} "
                f"for {len(self.generators)} ranks of {self.per_rank}")
        with self._lock:
            for g, st in zip(self.generators, gens):
                g.set_state(st.clone())
            self._queue = deque([list(row) for row in
                                 np.array(queue, np.float32)])


@dataclass
class PipelineState:
    """Trainer-counter snapshot the staging thread groups by.  ``behind``
    mirrors the replay-ratio floor (pause draining); ``train_eligible``
    predicts whether the next chunk will be trained on or absorbed
    ingest-only, from :meth:`IngestPipeline.polled_total` (and
    :meth:`IngestPipeline.staged_train_steps` on the budget side);
    ``pull_eligible`` says whether the ratio budget allows pulling one more
    pre-sampled batch (service mode)."""

    behind: bool = False
    train_eligible: bool = True
    pull_eligible: bool = True


@dataclass
class StagedSlot:
    """One staged unit of ingest work, in stream order.

    kind: ``"single"`` (one chunk, the fused-step shape), ``"scan"``
    (``payload``/``prios`` are lists of j chunks and ``n_per`` their
    transition counts), ``"merged"`` (m chunks in one ingest payload) or
    ``"batch"`` (a shard-sampled batch: ``payload`` the batch, ``prios``
    its IS weights, ``idx``/``shard``/``seq`` where its priorities go).
    ``planned_steps`` is the train steps the slot was staged to take.
    On the card, ``ready`` is the event recorded after the slot's copies
    and ``tensors`` holds its device tensors.  ``spans`` are the lineage
    spans of the slot's source chunks.  In the sharded plan ``payload`` /
    ``prios`` are rank 0's part of the group and ``remote`` the other
    ranks' ``(payload, priorities)``, pickled for the host group;
    ``n_trans`` counts the whole group.
    """

    kind: str
    payload: object
    prios: object
    n_trans: int
    n_per: tuple[int, ...] = ()
    chunks: int = 1
    planned_steps: int = 0
    ready: torch.cuda.Event | None = None
    tensors: tuple = ()
    idx: np.ndarray | None = None
    shard: int = 0
    seq: int = 0
    spans: tuple = ()
    remote: tuple = ()


def _pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1)."""
    return 1 << (max(1, n).bit_length() - 1)


class IngestPipeline:
    """The background staging stage (module docstring).  Construction
    starts nothing; drive it with :meth:`start` / :meth:`stop`.  One
    producer (the staging thread), one consumer (the trainer loop).
    ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for.  ``n_dp`` > 1 stages the sharded plan's group
    slots (no scan slots) and refills ``uniforms``, a
    :class:`UniformPrefetcher`, between polls."""

    def __init__(self, pool, *, device: torch.device | str = "cuda",
                 depth: int = 2, scan_steps: int = 1, merge_max: int = 8,
                 state_fn=None, capacity: int | None = None,
                 frame_capacity: int | None = None, replay_client=None,
                 n_dp: int = 1, uniforms: UniformPrefetcher | None = None):
        self.pool = pool
        self.n_dp = max(1, int(n_dp))
        self.uniforms = uniforms
        self.client = replay_client
        self._wb_lock = threading.Lock()
        self._wb_q: deque = deque()
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        # the side stream the staging copies run on; None on the CPU
        self._stream = None
        if self.device.type == "cuda":
            if self.device.index is None:         # "cuda": the current card
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self.device)
        # the sharded plan has no multi-step dispatch: group merging is
        # its ingest-side batching
        self.scan_steps = 1 if self.n_dp > 1 else max(1, int(scan_steps))
        self.merge_max = max(1, int(merge_max))
        self.state_fn = state_fn or PipelineState
        self.capacity = capacity
        self.frame_capacity = frame_capacity
        self._ring: queue_lib.Queue = queue_lib.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        # set while the staging thread holds nothing: poll_slot treats
        # "ring empty + staging idle" as dry, and otherwise waits for the
        # slot in flight
        self._idle = threading.Event()
        self._idle.set()
        self._error: Exception | None = None
        self._pub_lock = threading.Lock()
        self._pub: tuple | None = None
        self._ahead_lock = threading.Lock()
        self._polled_total = 0          # transitions ever polled (monotone)
        self._staged_steps = 0          # planned train steps not consumed
        self.stats = {"slots": 0, "scan_slots": 0, "merged_slots": 0,
                      "merged_chunks": 0, "publishes": 0}
        if replay_client is not None:
            self.stats |= {"batch_slots": 0, "writebacks": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="apex-ingest-staging")

    # -- trainer side ------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def polled_total(self) -> int:
        """Transitions ever polled off the pool.  Monotone, so when the
        staging thread asks ``state_fn`` about the next chunk this is the
        transition count before it in the (order-preserved) stream: what
        the serial drain's warm gate would see for that chunk."""
        return self._polled_total

    def staged_train_steps(self) -> int:
        """Train steps staged but not consumed yet; the budget prediction
        adds them to the live step counter."""
        return self._staged_steps

    def publish(self, version: int, params: dict) -> None:
        """Latest-wins param publish through the staging thread, which
        makes the device-to-host copy and calls ``pool.publish_params``.
        ``params`` maps names to tensors the caller will not write again
        (a copy of the weights, made on the caller's stream); on the card
        an event recorded on that stream tells the staging thread when the
        copy is done."""
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        with self._pub_lock:
            self._pub = (version, params, ready)

    def write_back(self, shard: int, seq: int, idx, priorities) -> None:
        """Hand one trained batch's priorities (a device tensor the
        caller will not write again) to the staging thread, which copies
        them to the host and sends them to ``shard``."""
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        with self._wb_lock:
            self._wb_q.append((shard, seq, idx, priorities, ready))

    def poll_slot(self, timeout: float = 0.0) -> StagedSlot | None:
        """Next slot in stream order, ready for the caller's stream, or
        None when the pipeline is dry (no slot staged, none in flight) and
        ``timeout`` has passed.  Raises if the staging thread died."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                slot = self._ring.get(timeout=0.005)
            except queue_lib.Empty:
                if self._error is not None:
                    raise RuntimeError(
                        "ingest pipeline staging thread died"
                    ) from self._error
                if self._stop.is_set():
                    return None
                if self._idle.is_set() and time.monotonic() >= deadline:
                    return None
                continue
            with self._ahead_lock:
                self._staged_steps -= slot.planned_steps
            if slot.ready is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(slot.ready)
                for t in slot.tensors:
                    t.record_stream(current)
            return slot

    # -- staging thread ----------------------------------------------------

    def _run(self) -> None:
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
                torch.cuda.set_stream(self._stream)
            while not self._stop.is_set():
                self._serve_publish()
                if self.uniforms is not None:
                    self.uniforms.refill()
                st = self.state_fn()
                if self.client is not None:
                    # service mode: send the queued write-backs, then
                    # prefer a pre-sampled batch; the chunk path below
                    # stays live for the actors' fallback chunks
                    self._serve_writebacks()
                    if st.pull_eligible:
                        item = self.client.poll_batch(timeout=0)
                        if item is not None:
                            self._idle.clear()
                            with span("apex.ingest.stage", STAGING_TRACK):
                                slot = self._build_batch_slot(item)
                            self._put(slot)
                            continue
                if st.behind:
                    # replay-ratio floor: pause draining so the bounded
                    # pool queue backpressures the actors
                    self._idle.set()
                    time.sleep(0.002)
                    continue
                msgs = self._poll(1, timeout=POLL_TIMEOUT)
                if not msgs:
                    self._idle.set()
                    continue
                self._idle.clear()
                with span("apex.ingest.stage", STAGING_TRACK):
                    slot = self._build_slot(msgs[0], st)
                self._put(slot)
        except Exception as exc:        # surfaces in poll_slot
            self._error = exc
            self._idle.set()
            return
        # a clean stop: strict shards wait on the last write-backs
        if self.client is not None:
            self._serve_writebacks()

    def _poll(self, n: int, timeout: float = 0.0) -> list:
        msgs = self.pool.poll_chunks(n, timeout=timeout)
        if msgs:
            n_trans = sum(int(m["n_trans"]) for m in msgs)
            with self._ahead_lock:
                self._polled_total += n_trans
            for m in msgs:
                # first wins: the socket receiver's decode stamp survives;
                # an in-host pool's chunks get their recv time here
                obs_spans.stamp(m, "recv")
        return msgs

    def _build_slot(self, first: dict, st: PipelineState) -> StagedSlot:
        """Group ``first`` with the chunks available right after it into
        one slot, in stream order, by the predicted consume mode."""
        if st.train_eligible and self.scan_steps > 1:
            return self._build_scan_slot(first)
        if not st.train_eligible and self._merge_cap(first["payload"]) > 1:
            return self._build_merged_slot(first)
        return self._single_slot(first,
                                 planned=1 if st.train_eligible else 0)

    def _build_scan_slot(self, first: dict) -> StagedSlot:
        msgs = [first] + self._poll(self.scan_steps - 1, timeout=0)
        # power-of-two widths, as the JAX pipeline's compiled scans; the
        # rest follow as singles, in order
        j = _pow2_floor(len(msgs))
        take, rest = msgs[:j], msgs[j:]
        if j == 1:
            slot = self._single_slot(take[0])
        else:
            spans = obs_spans.merge_spans(take)     # scan stack = merge hop
            obs_spans.stamp_spans(spans, "stage")
            slot = self._stage(StagedSlot(
                kind="scan", payload=[m["payload"] for m in take],
                prios=[m["priorities"] for m in take],
                n_trans=sum(int(m["n_trans"]) for m in take),
                n_per=tuple(int(m["n_trans"]) for m in take), chunks=j,
                planned_steps=j, spans=tuple(spans)))
            with self._ahead_lock:
                self._staged_steps += j
            self.stats["scan_slots"] += 1
            self.stats["slots"] += 1
        for msg in rest:
            self._put(slot)
            slot = self._single_slot(msg, planned=1)
        return slot

    def _build_merged_slot(self, first: dict) -> StagedSlot:
        cap = self._merge_cap(first["payload"])
        msgs = [first]
        # extend only while the next chunk is still predicted ingest-only:
        # a merge group never straddles the warm-up (or budget) boundary
        while len(msgs) < cap:
            if self.state_fn().train_eligible:
                break
            more = self._poll(1, timeout=0)
            if not more:
                break
            msgs.extend(more)
        slot = None
        while msgs:
            j = _pow2_floor(min(len(msgs), cap))
            take, msgs = msgs[:j], msgs[j:]
            if slot is not None:
                self._put(slot)
            if j == 1:
                slot = self._single_slot(take[0], planned=0)
                continue
            merged = (merge_group_messages(take, self.n_dp)
                      if self.n_dp > 1 else merge_chunk_messages(take))
            self.stats["merged_slots"] += 1
            self.stats["merged_chunks"] += j
            self.stats["slots"] += 1
            spans = obs_spans.spans_of(merged)      # merge hop stamped there
            obs_spans.stamp_spans(spans, "stage")
            slot = self._stage(StagedSlot(
                kind="merged", payload=merged["payload"],
                prios=merged["priorities"], n_trans=int(merged["n_trans"]),
                chunks=j, spans=tuple(spans)))
        return slot

    def _single_slot(self, msg: dict, planned: int = 1) -> StagedSlot:
        self.stats["slots"] += 1
        if planned:
            with self._ahead_lock:
                self._staged_steps += planned
        spans = obs_spans.spans_of(msg)
        obs_spans.stamp_spans(spans, "stage")
        return self._stage(StagedSlot(
            kind="single", payload=msg["payload"], prios=msg["priorities"],
            n_trans=int(msg["n_trans"]), planned_steps=planned,
            spans=tuple(spans)))

    def _build_batch_slot(self, item: dict) -> StagedSlot:
        """Stage one pulled batch: the batch and its IS weights go to the
        device; the tree rows stay on the host (they only go back to the
        shard with the new priorities)."""
        spans = obs_spans.spans_of(item)
        obs_spans.stamp_spans(spans, "stage")
        with self._ahead_lock:
            self._staged_steps += 1
        self.stats["batch_slots"] += 1
        self.stats["slots"] += 1
        return self._stage(StagedSlot(
            kind="batch", payload=item["batch"], prios=item["weights"],
            n_trans=0, planned_steps=1, idx=np.asarray(item["idx"]),
            shard=int(item.get("shard", 0)), seq=int(item["seq"]),
            spans=tuple(spans)))

    def _serve_writebacks(self) -> None:
        while True:
            with self._wb_lock:
                if not self._wb_q:
                    return
                shard, seq, idx, prios, ready = self._wb_q.popleft()
            with span("apex.ingest.writeback", STAGING_TRACK):
                if ready is not None:
                    ready.synchronize()
                # the event's wait above makes this copy's wait deliberate
                self.client.push_priorities(
                    shard, seq, np.asarray(idx),
                    prios.detach().cpu().numpy())  # apexlint: disable=T006
            self.stats["writebacks"] += 1

    def _merge_cap(self, payload) -> int:
        """Max chunks mergeable with ``payload`` first: a frame chunk, and
        merged shapes within the pool's bounds (m*K <= capacity keeps the
        transition scatter duplicate-free, m*Kf <= frame_capacity the ring
        write in bounds).  A sharded group's shapes carry the dp axis in
        front; the bounds are each shard's."""
        if not is_frame_chunk(payload):
            return 1
        ax = 1 if self.n_dp > 1 else 0
        cap = self.merge_max
        if self.capacity is not None:
            cap = min(cap, self.capacity
                      // max(1, payload["action"].shape[ax]))
        if self.frame_capacity is not None:
            cap = min(cap, self.frame_capacity
                      // max(1, payload["frames"].shape[ax]))
        return max(1, cap)

    # -- staging -----------------------------------------------------------

    def _stage(self, slot: StagedSlot) -> StagedSlot:
        """Replace the slot's host arrays (its payload's and priorities')
        with tensors for the device; the chunk scalars become ints.  A
        sharded group is split by rank first: rank 0's part is staged, the
        others' are pickled into ``slot.remote``."""
        if self.n_dp > 1:
            parts = (split_batch(slot.payload, slot.prios, self.n_dp)
                     if slot.kind == "batch"
                     else split_group(slot.payload, slot.prios, self.n_dp))
            slot.payload, slot.prios = parts[0]
            slot.remote = tuple(wire.dumps(p) for p in parts[1:])
        scan = slot.kind == "scan"
        payloads = [dict(p) for p in (slot.payload if scan
                                      else [slot.payload])]
        prios = [np.asarray(p, np.float32)
                 for p in (slot.prios if scan else [slot.prios])]
        arrays = []                       # (container, key, host array)
        for payload in payloads:
            for name, x in payload.items():
                if name in HOST_SCALARS:
                    payload[name] = int(x)
                elif isinstance(x, dict):      # sidecars: {name: [K, ...]}
                    payload[name] = inner = dict(x)
                    arrays += [(inner, k, np.asarray(v))
                               for k, v in inner.items()]
                else:
                    arrays.append((payload, name, np.asarray(x)))
        arrays += [(prios, i, p) for i, p in enumerate(prios)]
        if self._stream is None:
            for box, key, x in arrays:
                box[key] = torch.as_tensor(x)
        else:
            self._copy_to_device(arrays, slot)
        slot.payload = payloads if scan else payloads[0]
        slot.prios = prios if scan else prios[0]
        return slot

    def _copy_to_device(self, arrays: list, slot: StagedSlot) -> None:
        """Copy each of ``arrays`` through pinned memory to the device on
        the side stream, and put the device tensors in their containers."""
        staged = []
        for box, key, x in arrays:
            t = torch.from_numpy(x).pin_memory().to(self.device,
                                                    non_blocking=True)
            box[key] = t
            staged.append(t)
        slot.ready = torch.cuda.Event()
        slot.ready.record(self._stream)
        slot.tensors = tuple(staged)

    def _put(self, slot: StagedSlot) -> None:
        """Blocking put: the ring's bound is the backpressure.  Publishes
        are served while it is full, so they never starve behind it."""
        while not self._stop.is_set():
            try:
                self._ring.put(slot, timeout=0.1)
                return
            except queue_lib.Full:
                self._serve_publish()

    def _serve_publish(self) -> None:
        with self._pub_lock:
            req, self._pub = self._pub, None
        if req is None:
            return
        version, params, ready = req
        with span("apex.ingest.publish", STAGING_TRACK):
            if getattr(self.pool, "accepts_device_params", False):
                # on-device rollouts take the device copy: this thread's
                # stream (where the pool's engine loads it) waits for the
                # copy's event instead of the host, and owns the tensors'
                # later reads
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for t in params.values():
                        t.record_stream(stream)
                self.pool.publish_params(version, params)
            else:
                if ready is not None:
                    ready.synchronize()
                self.pool.publish_params(
                    version, {name: t.cpu().numpy()
                              for name, t in params.items()})
        self.stats["publishes"] += 1
