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

Not ported: the sharded plan (``merge_group_messages``, ``KeyPrefetcher``),
replay-service batch slots and write-backs, obs spans and the trace ring.
"""

from __future__ import annotations

import queue as queue_lib
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch import resolve_device

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
    return {"payload": payload, "priorities": prios, "n_trans": tot_tr}


@dataclass
class PipelineState:
    """Trainer-counter snapshot the staging thread groups by.  ``behind``
    mirrors the replay-ratio floor (pause draining); ``train_eligible``
    predicts whether the next chunk will be trained on or absorbed
    ingest-only, from :meth:`IngestPipeline.polled_total` (and
    :meth:`IngestPipeline.staged_train_steps` on the budget side)."""

    behind: bool = False
    train_eligible: bool = True


@dataclass
class StagedSlot:
    """One staged unit of ingest work, in stream order.

    kind: ``"single"`` (one chunk, the fused-step shape), ``"scan"``
    (``payload``/``prios`` are lists of j chunks and ``n_per`` their
    transition counts) or ``"merged"`` (m chunks in one ingest payload).
    ``planned_steps`` is the train steps the slot was staged to take.
    On the card, ``ready`` is the event recorded after the slot's copies
    and ``tensors`` holds its device tensors.
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


def _pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1)."""
    return 1 << (max(1, n).bit_length() - 1)


class IngestPipeline:
    """The background staging stage (module docstring).  Construction
    starts nothing; drive it with :meth:`start` / :meth:`stop`.  One
    producer (the staging thread), one consumer (the trainer loop).
    ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for."""

    def __init__(self, pool, *, device: torch.device | str = "cuda",
                 depth: int = 2, scan_steps: int = 1, merge_max: int = 8,
                 state_fn=None, capacity: int | None = None,
                 frame_capacity: int | None = None):
        self.pool = pool
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        # the side stream the staging copies run on; None on the CPU
        self._stream = None
        if self.device.type == "cuda":
            if self.device.index is None:         # "cuda": the current card
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self.device)
        self.scan_steps = max(1, int(scan_steps))
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
                st = self.state_fn()
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
                self._put(self._build_slot(msgs[0], st))
        except Exception as exc:        # surfaces in poll_slot
            self._error = exc
            self._idle.set()

    def _poll(self, n: int, timeout: float = 0.0) -> list:
        msgs = self.pool.poll_chunks(n, timeout=timeout)
        if msgs:
            n_trans = sum(int(m["n_trans"]) for m in msgs)
            with self._ahead_lock:
                self._polled_total += n_trans
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
            slot = self._stage(StagedSlot(
                kind="scan", payload=[m["payload"] for m in take],
                prios=[m["priorities"] for m in take],
                n_trans=sum(int(m["n_trans"]) for m in take),
                n_per=tuple(int(m["n_trans"]) for m in take), chunks=j,
                planned_steps=j))
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
            merged = merge_chunk_messages(take)
            self.stats["merged_slots"] += 1
            self.stats["merged_chunks"] += j
            self.stats["slots"] += 1
            slot = self._stage(StagedSlot(
                kind="merged", payload=merged["payload"],
                prios=merged["priorities"], n_trans=int(merged["n_trans"]),
                chunks=j))
        return slot

    def _single_slot(self, msg: dict, planned: int = 1) -> StagedSlot:
        self.stats["slots"] += 1
        if planned:
            with self._ahead_lock:
                self._staged_steps += planned
        return self._stage(StagedSlot(
            kind="single", payload=msg["payload"], prios=msg["priorities"],
            n_trans=int(msg["n_trans"]), planned_steps=planned))

    def _merge_cap(self, payload) -> int:
        """Max chunks mergeable with ``payload`` first: a frame chunk, and
        merged shapes within the pool's bounds (m*K <= capacity keeps the
        transition scatter duplicate-free, m*Kf <= frame_capacity the ring
        write in bounds)."""
        if not is_frame_chunk(payload):
            return 1
        cap = self.merge_max
        if self.capacity is not None:
            cap = min(cap, self.capacity // max(1, payload["action"].shape[0]))
        if self.frame_capacity is not None:
            cap = min(cap, self.frame_capacity
                      // max(1, payload["frames"].shape[0]))
        return max(1, cap)

    # -- staging -----------------------------------------------------------

    def _stage(self, slot: StagedSlot) -> StagedSlot:
        """Replace the slot's host arrays (its payload's and priorities')
        with tensors for the device; the chunk scalars become ints."""
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
