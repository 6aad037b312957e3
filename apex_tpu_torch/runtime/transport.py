"""Socket transport of the multi-host plane.

Counterpart of :mod:`apex_tpu.runtime.transport`, with the same wire
format (``tests/test_torch_transport.py`` drives a JAX sender into this
module's receiver).  The reference's fabric is ZeroMQ over TCP with three
patterns kept here: PUB/SUB + CONFLATE for params
(``origin_repo/learner.py:57-68``, ``actor.py:40-49``), DEALER/ROUTER with
a bounded window of unacked sends for transition chunks
(``actor.py:105-115``, ``learner.py:117-131``) and REQ/ROUTER for the
startup barrier (``learner.py:30-54``, ``actor.py:28-37``).  The chunk
stream ends at one ROUTER on the learner, or, with replay shards, at each
shard's (:mod:`apex_tpu_torch.replay_service`, whose sender points a
:class:`ChunkSender` at a shard):

* :class:`ParamPublisher` / :class:`ParamSubscriber` -- version-stamped,
  latest-wins param broadcast, dense or as sparse deltas against a
  keyframe (:mod:`apex_tpu_torch.runtime.codec`).
* :class:`ChunkSender` / :class:`ChunkReceiver` -- actor-to-learner chunks
  with an ack-credit window; stats ride the same pipe.
* :func:`barrier_release` / :func:`barrier_wait` / :class:`RejoinBarrier`
  -- the startup handshake, and its standing re-admission service.
* :class:`RemotePool` -- the learner's socket pool behind the
  :class:`~apex_tpu_torch.training.apex.ConcurrentTrainer` loop.

The wire format is pickle, as the reference's cPickle, but every receive
goes through :func:`apex_tpu_torch.runtime.wire.restricted_loads`: a
payload naming a global outside the allowlist is counted and dropped,
never run.

The receiver stamps each decoded chunk's lineage spans ``recv``
(:mod:`apex_tpu_torch.obs.spans`).  Under ``CHAOS_SEED``
(:mod:`apex_tpu_torch.fleet.chaos`, identity ``learner``) the receiver
withholds the acks of a scheduled chunk window for a while (delayed,
never dropped) and :class:`RemotePool`'s publisher runs the learner's
kill/stall schedule.

Tenant topics: a non-default tenant's publisher prefixes every param
frame with its :func:`~apex_tpu_torch.tenancy.namespace.param_topic` tag,
and its subscribers subscribe that prefix and strip it, so a shared infer
shard attributes each publish to its tenant.  The default tenant's topic
is empty: its frames are the single-tenant frames, byte for byte.
"""

from __future__ import annotations

import pickle
import queue as queue_lib
import threading
import time
from dataclasses import dataclass

import zmq

from apex_tpu_torch.config import CommsConfig
from apex_tpu_torch.fleet.chaos import chaos_from_env, maybe_wrap_publisher
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.runtime import codec as wire_codec
from apex_tpu_torch.runtime import wire
from apex_tpu_torch.tenancy import namespace as tenancy_ns


def _ctx() -> zmq.Context:
    return zmq.Context.instance()


def _bind(sock: zmq.Socket, endpoint: str, retry_s: float = 2.0) -> None:
    """Bind, closing the socket if it fails.  zmq closes sockets on its
    I/O thread, so a port this process has just released may still be
    held for a moment: EADDRINUSE is retried for ``retry_s``."""
    deadline = time.monotonic() + retry_s
    while True:
        try:
            sock.bind(endpoint)
            return
        except zmq.ZMQError as exc:
            if exc.errno != zmq.EADDRINUSE or time.monotonic() > deadline:
                sock.close(linger=0)
                raise
            time.sleep(0.05)


# -- param plane -----------------------------------------------------------

class ParamPublisher:
    """Learner-side PUB socket (``learner.py:57-68``): send-and-forget with
    a small high-water mark; slow subscribers see only the latest version.

    ``epoch``: when nonzero, every dense publish carries the learner's
    epoch as a third tuple element, so a parked actor can tell a restarted
    learner from a stalled one; zero keeps the 2-tuple.

    ``delta`` (default ``comms.param_delta``): publish keyframes and
    sparse deltas against the last keyframe instead of dense trees; a
    keyframe at least every ``keyframe_every`` publishes, on the first
    publish, on every epoch change and after :meth:`force_keyframe`.

    ``topic`` prefixes every frame (module docstring); None takes this
    process's tenant from ``APEX_TENANT``, and the default tenant's topic
    is empty."""

    def __init__(self, comms: CommsConfig, bind_ip: str = "*",
                 delta: bool | None = None,
                 keyframe_every: int | None = None,
                 topic: bytes | None = None):
        self.sock = _ctx().socket(zmq.PUB)
        self.sock.setsockopt(zmq.SNDHWM, comms.param_hwm)
        _bind(self.sock, f"tcp://{bind_ip}:{comms.param_port}")
        self.topic = (tenancy_ns.param_topic(tenancy_ns.current_tenant())
                      if topic is None else topic)
        self.epoch = 0
        self.delta = comms.param_delta if delta is None else bool(delta)
        self.keyframe_every = max(1, int(
            comms.param_keyframe_every if keyframe_every is None
            else keyframe_every))
        self._key_bytes: dict | None = None   # leaf bytes @ last keyframe
        self._key_seq = -1
        self._seq = 0
        self._last_epoch: int | None = None
        self._want_key = False
        self.param_publishes = 0
        self.param_keyframes = 0
        self.param_deltas = 0
        self.param_bytes_out = 0      # PUB frame bytes (delta mode)
        self.param_bytes_raw = 0      # dense leaf bytes (delta mode)
        self.param_delta_bytes = 0    # cumulative delta-frame bytes
        self.keyframes_forced = 0

    def force_keyframe(self) -> None:
        """Make the next publish dense: the trainer calls this when a
        subscriber's :class:`~apex_tpu_torch.runtime.codec.KeyframeRequest`
        arrives on the stat plane."""
        self.keyframes_forced += 1
        self._want_key = True

    def publish(self, version: int, params) -> None:
        self.param_publishes += 1
        if self.delta:
            self._publish_delta(int(version), params)
            return
        msg = ((version, params, self.epoch) if self.epoch
               else (version, params))
        self._send(self.topic + pickle.dumps(msg, protocol=5))

    def _send(self, payload: bytes) -> None:
        # Reading ZMQ_EVENTS makes libzmq take in the commands its I/O
        # thread has queued for this socket, among them how many messages
        # each subscriber pipe has passed on.  Without it a PUB that sends
        # rarely keeps counting delivered messages against its small
        # SNDHWM and drops every third publish as if the pipe were full
        # (tests/test_torch_transport.py).
        self.sock.getsockopt(zmq.EVENTS)
        self.sock.send(payload)

    def _publish_delta(self, version: int, params) -> None:
        """Keyframe/delta frames (dicts tagged ``pdelta``) instead of the
        dense tuples."""
        epoch = self.epoch
        keyframe = (self._key_bytes is None or self._want_key
                    or epoch != self._last_epoch
                    or (self._seq - self._key_seq) >= self.keyframe_every)
        frame = {"pdelta": 1, "v": version, "epoch": epoch,
                 "seq": self._seq}
        if keyframe:
            _, self._key_bytes, raw_total = wire_codec.diff_tree(params, {})
            frame["key"] = True
            frame["crc"] = wire_codec.bytes_checksum(self._key_bytes)
            frame["params"] = params
            self._key_seq = self._seq
            self._want_key = False
            self.param_keyframes += 1
        else:
            updates, new_bytes, raw_total = wire_codec.diff_tree(
                params, self._key_bytes)
            frame["key"] = False
            frame["base"] = self._key_seq
            frame["crc"] = wire_codec.bytes_checksum(new_bytes)
            frame["updates"] = updates
            self.param_deltas += 1
        payload = self.topic + pickle.dumps(frame, protocol=5)
        self._send(payload)
        self._last_epoch = epoch
        self._seq += 1
        self.param_bytes_out += len(payload)
        self.param_bytes_raw += raw_total
        if not keyframe:
            self.param_delta_bytes += len(payload)

    def close(self) -> None:
        self.sock.close(linger=0)


class ParamSubscriber:
    """Actor/evaluator-side SUB with CONFLATE=1: the socket keeps exactly
    the newest message (``actor.py:40-49``), no drain loop needed.

    ``topic``: a non-default tenant's subscriber subscribes its tenant's
    frame prefix and strips it before decoding, so CONFLATE keeps the
    newest frame of this tenant; None takes the tenant from
    ``APEX_TENANT``, and the default tenant subscribes everything."""

    def __init__(self, comms: CommsConfig, learner_ip: str | None = None,
                 topic: bytes | None = None):
        self.topic = (tenancy_ns.param_topic(tenancy_ns.current_tenant())
                      if topic is None else topic)
        self.sock = _ctx().socket(zmq.SUB)
        self.sock.setsockopt(zmq.CONFLATE, 1)
        self.sock.setsockopt(zmq.SUBSCRIBE, self.topic)
        ip = learner_ip or comms.learner_ip
        self.sock.connect(f"tcp://{ip}:{comms.param_port}")
        self.rejected = 0           # payloads outside the wire allowlist
        # epoch of the newest stamped publish (0 until one lands); the
        # ParkController reads it to tell a restart from a stall
        self.learner_epoch = 0
        # delta reassembly: the stored keyframe every delta applies to
        self._key_tree = None
        self._key_seq = -1
        self.keyframes_seen = 0
        self.deltas_applied = 0
        self.delta_mismatches = 0
        self.want_keyframe = False
        # the roles wire this to a KeyframeRequest send on the stat plane;
        # called (best effort) whenever a delta cannot be applied
        self.on_mismatch = None

    def poll(self, timeout_ms: int = 0):
        """Newest ``(version, params)`` or None.  An epoch-stamped
        publish updates :attr:`learner_epoch`; ``pdelta`` frames
        reassemble to the same 2-tuple."""
        if not self.sock.poll(timeout_ms, zmq.POLLIN):
            return None
        payload = tenancy_ns.strip_topic(self.topic, self.sock.recv())
        if payload is None:
            self.rejected += 1          # a frame outside this topic
            return None
        try:
            got = wire.restricted_loads(payload)
        except wire.WireRejected:
            self.rejected += 1      # one bad publish costs one poll
            return None
        if isinstance(got, dict) and got.get("pdelta") == 1:
            return self._apply_pdelta(got)
        if isinstance(got, tuple) and len(got) == 3:
            self.learner_epoch = int(got[2])
            return got[:2]
        return got

    def _apply_pdelta(self, frame: dict):
        """Keyframe: store and return.  Delta: apply against the stored
        keyframe and verify the tree checksum; a frame that does not
        reassemble bit-exactly (missed keyframe, corrupt frame) is
        dropped, counted and answered through :attr:`on_mismatch`."""
        version = -1
        try:
            version = int(frame["v"])
            epoch = frame.get("epoch")
            if epoch:
                self.learner_epoch = int(epoch)
            if frame.get("key"):
                params = frame["params"]
                if wire_codec.tree_checksum(params) != int(frame["crc"]):
                    raise wire_codec.CodecError("keyframe checksum")
                self._key_tree = params
                self._key_seq = int(frame["seq"])
                self.keyframes_seen += 1
                self.want_keyframe = False
                return (version, params)
            if self._key_tree is None or int(frame["base"]) != self._key_seq:
                raise wire_codec.CodecError("no keyframe base")
            tree = wire_codec.apply_delta(self._key_tree, frame["updates"])
            if wire_codec.tree_checksum(tree) != int(frame["crc"]):
                raise wire_codec.CodecError("delta checksum")
            self.deltas_applied += 1
            return (version, tree)
        except (wire_codec.CodecError, KeyError, TypeError, ValueError):
            self.delta_mismatches += 1
            self.want_keyframe = True
            cb = self.on_mismatch
            if cb is not None:
                try:
                    cb(version)
                except Exception:
                    pass            # telemetry must never kill the poll
            return None

    def wait_first(self, stop_event=None, timeout_ms: int = 500):
        """Block (interruptibly) for the first publish
        (``actor.py:72-74``)."""
        while stop_event is None or not stop_event.is_set():
            got = self.poll(timeout_ms)
            if got is not None:
                return got
        return None

    def close(self) -> None:
        self.sock.close(linger=0)


# -- chunk/stat plane ------------------------------------------------------

class ChunkSender:
    """Actor-side DEALER with an ack-credit window: at most
    ``comms.max_outstanding_sends`` chunks in flight
    (``actor.py:110-114``).  Stats go on the same socket, fire and forget
    (no credit).  ``codec`` picks the chunk codec; None falls back to
    ``comms.wire_codec``, then the ``APEX_WIRE_CODEC`` env twin, then
    ``raw``."""

    def __init__(self, comms: CommsConfig, identity: str,
                 learner_ip: str | None = None, codec: str | None = None,
                 ip: str | None = None, port: int | None = None):
        self.sock = _ctx().socket(zmq.DEALER)
        self.sock.setsockopt(zmq.IDENTITY, identity.encode())
        # ip/port point the same windowed DEALER at a replay shard
        # (replay_service/sender.py) instead of the learner
        target = ip or learner_ip or comms.learner_ip
        self.sock.connect(f"tcp://{target}:{port or comms.batch_port}")
        self.max_outstanding = comms.max_outstanding_sends
        self._in_flight = 0
        self.codec = wire_codec.resolve_codec(codec or comms.wire_codec
                                              or None)
        # cumulative wire counters, shipped in heartbeats; ``resends``
        # counts bounded-wait sends that found no credit and were retried
        self.chunks_sent = 0
        self.acks_received = 0
        self.resends = 0
        # codec byte counters: what rode the wire, what raw would cost
        self.wire_bytes_out = 0
        self.wire_bytes_raw = 0

    def wire_gauges(self) -> dict:
        """Heartbeat gauges: the codec byte counters and the realised
        compression ratio."""
        out = self.wire_bytes_out
        return {"wire_bytes_out": out,
                "wire_bytes_raw": self.wire_bytes_raw,
                "codec_ratio": (self.wire_bytes_raw / out) if out else 1.0}

    def note_resend(self) -> None:
        """The caller's retry loop re-attempted a send that timed out on
        credit (the chunk was never on the wire, so nothing is lost)."""
        self.resends += 1

    def _drain_acks(self, timeout_ms: int) -> None:
        while self.sock.poll(timeout_ms, zmq.POLLIN):
            self.sock.recv()
            self._in_flight = max(0, self._in_flight - 1)
            self.acks_received += 1
            timeout_ms = 0

    def reset_credits(self) -> None:
        """Forget the outstanding window (the rejoin after a learner
        death: the dead learner took the pending acks with it).  Late
        acks from a fast restart land on an empty window."""
        self._in_flight = 0

    def send_chunk(self, msg: dict, stop_event=None,
                   max_wait_s: float | None = None) -> bool:
        """Blocks while the credit window is exhausted; False if stopped,
        or, with ``max_wait_s``, if no credit arrived in time."""
        self._drain_acks(0)
        deadline = (None if max_wait_s is None
                    else time.monotonic() + max_wait_s)
        while self._in_flight >= self.max_outstanding:
            if stop_event is not None and stop_event.is_set():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            self._drain_acks(100)
        payload, raw_n, wire_n = wire_codec.encode_chunk(msg, self.codec)
        self.sock.send(payload)
        self.wire_bytes_raw += raw_n
        self.wire_bytes_out += wire_n
        self._in_flight += 1
        self.chunks_sent += 1
        return True

    def send_stat(self, stat) -> None:
        """Best effort and never blocks: stats are droppable telemetry,
        and a blocking send would wedge the actor if the learner dies."""
        try:
            self.sock.send(pickle.dumps(("stat", stat), protocol=5),
                           zmq.DONTWAIT)
        except zmq.Again:
            pass

    def close(self, drain_s: float = 2.0) -> None:
        """Wait up to ``drain_s`` for the in-flight window's acks, then
        close.  ``linger=0`` discards what is still queued, and an ack
        proves the learner filed the chunk, so waiting for the window to
        empty makes a clean shutdown lossless; on timeout (the learner is
        gone) the rest is dropped."""
        deadline = time.monotonic() + drain_s
        while self._in_flight > 0 and time.monotonic() < deadline:
            self._drain_acks(50)
        self.sock.close(linger=0)


class ChunkReceiver:
    """Learner-side ROUTER and decode pipeline: the socket thread receives
    and acks, ``n_decoders`` threads (default ``comms.n_recv_batch_procs``,
    the reference's ``recv_batch`` pullers, ``learner.py:71-114``) unpickle
    through the allowlist, decode compressed chunks and enqueue.

    An ack grants the sender's next credit and is sent only once the chunk
    is in the bounded ``chunks`` queue, so a full queue backpressures the
    fleet end to end: decoders block, the decode queue fills, the socket
    thread stops receiving, the senders' windows run dry.  A payload
    outside the wire allowlist (:attr:`rejected`) or a compressed chunk
    that does not decode (:attr:`codec_rejected`) is counted and dropped
    without an ack, so garbage never earns its sender another credit.
    A chaos ``ack_withhold`` window parks the acks of chunks ``[at,
    at+n)`` for ``hold_s`` (:attr:`acks_withheld`)."""

    def __init__(self, comms: CommsConfig, bind_ip: str = "*",
                 queue_depth: int = 64, n_decoders: int | None = None):
        self.sock = _ctx().socket(zmq.ROUTER)
        _bind(self.sock, f"tcp://{bind_ip}:{comms.batch_port}")
        self.chunks: queue_lib.Queue = queue_lib.Queue(maxsize=queue_depth)
        self.stats: queue_lib.Queue = queue_lib.Queue(maxsize=1024)
        # last arrival per peer; membership = CHUNK senders (evaluators
        # send one stat per episode, which a silence threshold misreads)
        self.last_seen: dict[str, float] = {}
        self._chunk_senders: set[str] = set()
        self._peers_lock = threading.Lock()
        self._stop = threading.Event()
        self.n_decoders = (n_decoders if n_decoders is not None
                           else comms.n_recv_batch_procs)
        self._decode_q: queue_lib.Queue = queue_lib.Queue(
            maxsize=max(2 * self.n_decoders, 8))
        self._ack_q: queue_lib.Queue = queue_lib.Queue()
        # messages handed to decoders and not yet filed: while any are in
        # flight the socket loop polls on a short timeout, so an ack
        # leaves within ~5 ms instead of after an idle poll
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.rejected = 0          # foreign: outside the allowlist, or
        #                            not one part
        self.codec_chunks = 0      # compressed chunks decoded
        self.codec_rejected = 0    # codec payloads that did not decode
        self.chunks_filed = 0      # chunks queued for the learner
        self.chunk_wire_bytes = 0  # their payload bytes as they came in
        # ingress chaos (identity "learner"): the acks of a scheduled
        # chunk window are parked until their release time, so sender
        # credit windows run dry and their retries are exercised
        chaos = chaos_from_env()
        self._chaos = (chaos.plan_for("learner")
                       if chaos is not None else None)
        self._ack_count = 0            # chunks acked or withheld so far
        self._withheld: list = []      # (release_monotonic, ident)
        self._withhold_lock = threading.Lock()
        self.acks_withheld = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="apex-chunk-receiver")
        self._decoders = [
            threading.Thread(target=self._decode_loop, daemon=True,
                             name=f"apex-chunk-decoder-{i}")
            for i in range(self.n_decoders)]

    def start(self) -> None:
        self._thread.start()
        for d in self._decoders:
            d.start()

    def _send_pending_acks(self) -> None:
        if self._withheld:
            now = time.monotonic()
            with self._withhold_lock:
                due = [i for t, i in self._withheld if t <= now]
                self._withheld = [(t, i) for t, i in self._withheld
                                  if t > now]
            for ident in due:          # delayed, never dropped
                self.sock.send_multipart([ident, b"ack"])
        try:
            while True:
                ident = self._ack_q.get_nowait()
                self.sock.send_multipart([ident, b"ack"])
        except queue_lib.Empty:
            pass

    def _enqueue_ack(self, ident: bytes) -> None:
        """Decoder-side ack routing: a scheduled ack-withhold window parks
        the ack until its release time; every other ack goes out now."""
        plan = self._chaos
        if plan is not None and plan.ack_withhold_at is not None:
            with self._withhold_lock:
                i = self._ack_count
                self._ack_count += 1
                if (plan.ack_withhold_at <= i
                        < plan.ack_withhold_at + plan.ack_withhold_n):
                    self.acks_withheld += 1
                    self._withheld.append(
                        (time.monotonic() + plan.ack_withhold_s, ident))
                    return
        self._ack_q.put(ident)

    def _run(self) -> None:
        """Socket thread: the only thread touching the ROUTER (zmq sockets
        are not thread-safe); receives, hands payloads to the decoders,
        sends the acks they enqueue."""
        while not self._stop.is_set():
            self._send_pending_acks()
            with self._inflight_lock:
                busy = self._inflight > 0
            if not self.sock.poll(5 if busy else 100, zmq.POLLIN):
                continue
            frames = self.sock.recv_multipart()
            if len(frames) != 2:           # not a DEALER's one-part send
                self.rejected += 1
                continue
            ident, payload = frames
            with self._peers_lock:
                self.last_seen[ident.decode(errors="replace")] = \
                    time.monotonic()
            while not self._stop.is_set():
                try:
                    self._decode_q.put((ident, payload), timeout=0.1)
                    with self._inflight_lock:
                        self._inflight += 1
                    break
                except queue_lib.Full:     # decoders backed up: keep acks
                    self._send_pending_acks()   # flowing for what's done

    def _decode_loop(self) -> None:
        while not self._stop.is_set():
            try:
                ident, payload = self._decode_q.get(timeout=0.1)
            except queue_lib.Empty:
                continue
            try:
                self._file(ident, payload)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def _file(self, ident: bytes, payload: bytes) -> None:
        try:
            kind, body = wire.restricted_loads(payload)
        except wire.WireRejected:
            self.rejected += 1
            return
        if kind == "chunkc":
            try:
                body = wire_codec.decode_chunk(body)
            except wire_codec.CodecError:
                self.codec_rejected += 1
                return
            self.codec_chunks += 1
            kind = "chunk"
        if kind == "chunk":
            obs_spans.stamp(body, "recv")      # lineage: wire arrival
            with self._peers_lock:
                self._chunk_senders.add(ident.decode(errors="replace"))
            # enqueue BEFORE acking: the ack is the credit grant
            while not self._stop.is_set():
                try:
                    self.chunks.put(body, timeout=0.1)
                    self._enqueue_ack(ident)
                    with self._peers_lock:
                        self.chunks_filed += 1
                        self.chunk_wire_bytes += len(payload)
                    return
                except queue_lib.Full:
                    continue
        elif kind == "stat":
            try:
                self.stats.put_nowait(body)
            except queue_lib.Full:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # tolerate never-started
            self._thread.join(timeout=5)
        for d in self._decoders:
            if d.ident is not None:
                d.join(timeout=5)
        self.sock.close(linger=0)


# -- startup barrier -------------------------------------------------------

def barrier_release(comms: CommsConfig, n_peers: int, bind_ip: str = "*",
                    stop_event=None, timeout_s: float = 120.0) -> int:
    """Learner side (``learner.py:30-54``): collect ``n_peers`` hellos on a
    ROUTER, then release them all.  Returns the peers that checked in.
    All or nothing: a partial fleet is not released, so its peers time
    out in :func:`barrier_wait` and exit cleanly."""
    sock = _ctx().socket(zmq.ROUTER)
    _bind(sock, f"tcp://{bind_ip}:{comms.barrier_port}")
    try:
        idents = []
        deadline = time.monotonic() + timeout_s
        while len(idents) < n_peers and time.monotonic() < deadline:
            if stop_event is not None and stop_event.is_set():
                break
            if sock.poll(100, zmq.POLLIN):
                frames = sock.recv_multipart()
                if len(frames) == 3 and frames[0] not in idents:
                    idents.append(frames[0])     # a REQ's hello
        if len(idents) == n_peers:
            for ident in idents:
                sock.send_multipart([ident, b"", b"go"])
        return len(idents)
    finally:
        sock.close(linger=0)


def barrier_wait(comms: CommsConfig, identity: str,
                 learner_ip: str | None = None, stop_event=None,
                 timeout_s: float = 120.0, rejoin_sub=None) -> bool:
    """Actor/evaluator side (``actor.py:28-37``): REQ hello, block for go.

    ``rejoin_sub``: a connected :class:`ParamSubscriber` polled beside the
    barrier's reply.  The barrier runs once, at fleet start; a peer
    restarted later finds it gone, but a running learner republishes
    params at least every ``10 * publish_min_seconds``, so a publish
    proves the learner is past the barrier.  Whichever signal comes first
    wins; the publish read here is dropped, and the caller takes the
    next one."""
    sock = _ctx().socket(zmq.REQ)
    try:
        sock.setsockopt(zmq.IDENTITY, identity.encode())
        ip = learner_ip or comms.learner_ip
        sock.connect(f"tcp://{ip}:{comms.barrier_port}")
        sock.send(b"hello")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if stop_event is not None and stop_event.is_set():
                return False
            if sock.poll(100, zmq.POLLIN):
                sock.recv()
                return True
            if rejoin_sub is not None and rejoin_sub.poll(0) is not None:
                return True
        return False
    finally:
        sock.close(linger=0)


class RejoinBarrier:
    """The startup barrier re-run as a standing service: after the
    one-shot release (:func:`barrier_release`), the learner keeps a ROUTER
    on the barrier port whose thread answers every hello with ``go``, so
    late or restarted peers re-admit in one round trip.  ``admitted``
    counts them."""

    def __init__(self, comms: CommsConfig, bind_ip: str = "*"):
        self.sock = _ctx().socket(zmq.ROUTER)
        # the one-shot release has just closed this port in this process
        _bind(self.sock, f"tcp://{bind_ip}:{comms.barrier_port}")
        self.admitted = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="apex-rejoin-barrier")

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.sock.poll(200, zmq.POLLIN):
                continue
            frames = self.sock.recv_multipart()
            if len(frames) == 3:                 # a REQ's hello
                self.sock.send_multipart([frames[0], b"", b"go"])
                self.admitted += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)
        self.sock.close(linger=0)


@dataclass
class RemotePool:
    """The socket pool behind the
    :class:`~apex_tpu_torch.training.apex.ConcurrentTrainer` loop, in
    place of :class:`~apex_tpu_torch.actors.pool.ActorPool`: the same
    ``start``/``publish_params``/``poll_chunks``/``poll_stats``/``cleanup``
    surface, so one learner serves the in-host and the multi-host fleet.

    ``n_peers`` is the barrier's head count (actors + evaluators,
    ``learner.py:48-49``).  The chunk ROUTER binds at construction, the
    PUB socket and the barrier in :meth:`start`; a failed start unbinds
    everything, so a retry in the same process can bind the same ports.

    Thread affinity under the ingest pipeline
    (:mod:`apex_tpu_torch.training.ingest_pipeline`): ``poll_chunks`` and
    ``publish_params`` are both driven by the one staging thread.
    ``poll_chunks`` reads a plain queue the receiver's threads feed, and
    the PUB socket is built in :meth:`start` (the caller's thread), then
    used only by the staging thread (every publish goes through the
    pipeline, the first and the warm-up republishes included), then closed
    in :meth:`cleanup` after the trainer has joined that thread.  zmq
    sockets tolerate that hand-over; they do not tolerate use from two
    threads at once.
    """

    comms: CommsConfig
    n_peers: int
    queue_depth: int = 64
    barrier_timeout_s: float = 120.0

    # the trainer republishes before its first step (a SUB socket that
    # joins after a publish never sees it: the zmq slow joiner)
    needs_warmup_republish = True

    def __post_init__(self):
        self.receiver = ChunkReceiver(self.comms,
                                      queue_depth=self.queue_depth)
        self.publisher: ParamPublisher | None = None
        self.rejoin_barrier: RejoinBarrier | None = None
        self.procs: list = []           # nothing local to supervise
        self._epoch = 0

    def start(self) -> None:
        try:
            self.receiver.start()
            # chaos (identity "learner"): the publish kill/stall schedule
            self.publisher = maybe_wrap_publisher(ParamPublisher(self.comms))
            self.publisher.epoch = self._epoch
            released = barrier_release(self.comms, self.n_peers,
                                       timeout_s=self.barrier_timeout_s)
            if released < self.n_peers:
                raise TimeoutError(
                    f"startup barrier: {released}/{self.n_peers} peers")
        except BaseException:
            # leave no bound port or live thread behind a failed start
            self.cleanup()
            raise
        try:
            # respawned or late peers re-admit in one round trip; losing
            # this service is a degradation (the param-stream race still
            # works), never a dead learner
            self.rejoin_barrier = RejoinBarrier(self.comms)
            self.rejoin_barrier.start()
        except zmq.ZMQError:
            self.rejoin_barrier = None

    def set_learner_epoch(self, epoch: int) -> None:
        """Stamp every later publish with the learner's epoch."""
        self._epoch = int(epoch)
        if self.publisher is not None:
            self.publisher.epoch = self._epoch

    def rejoin_admitted(self) -> int:
        rb = self.rejoin_barrier
        return rb.admitted if rb is not None else 0

    def acks_withheld(self) -> int:
        """Acks the chaos schedule withheld since start."""
        return self.receiver.acks_withheld

    def cleanup(self) -> None:
        self.receiver.stop()
        if self.rejoin_barrier is not None:
            self.rejoin_barrier.stop()
            self.rejoin_barrier = None
        if self.publisher is not None:
            # closed, but kept: its counters stay readable (wire_summary)
            self.publisher.close()

    def publish_params(self, version: int, params) -> None:
        if self.publisher is None:
            raise RuntimeError("RemotePool.publish_params before start(): "
                               "the PUB socket binds in start()")
        self.publisher.publish(version, params)

    def poll_chunks(self, max_chunks: int, timeout: float = 0.0) -> list:
        out = []
        for _ in range(max_chunks):
            try:
                msg = (self.receiver.chunks.get(timeout=timeout) if timeout
                       else self.receiver.chunks.get_nowait())
            except queue_lib.Empty:
                break
            out.append(msg)
        return out

    def poll_stats(self) -> list:
        out = []
        try:
            while True:
                out.append(self.receiver.stats.get_nowait())
        except queue_lib.Empty:
            pass
        return out

    def peer_seen(self) -> dict[str, float]:
        """Last message arrival (monotonic clock) per wire identity."""
        with self.receiver._peers_lock:
            return dict(self.receiver.last_seen)

    def wire_rejected(self) -> int:
        """Messages dropped as foreign since construction: payloads
        outside the wire allowlist, and multi-part sends."""
        return self.receiver.rejected

    def force_keyframe(self) -> None:
        """Relay a subscriber's KeyframeRequest: the next delta-mode
        publish goes dense."""
        if self.publisher is not None:
            self.publisher.force_keyframe()

    def wire_summary(self) -> dict:
        """Wire counters: the chunks filed and their wire bytes, the
        receiver's decode counts and the publisher's counters."""
        rc = self.receiver
        with rc._peers_lock:
            out = {"chunks": rc.chunks_filed,
                   "chunk_wire_bytes": rc.chunk_wire_bytes}
        out |= {"codec_chunks": rc.codec_chunks,
                "codec_rejected": rc.codec_rejected}
        pub = self.publisher
        if pub is not None:
            for key in ("param_publishes", "param_keyframes",
                        "param_deltas", "param_delta_bytes",
                        "param_bytes_out", "param_bytes_raw",
                        "keyframes_forced"):
                out[key] = int(getattr(pub, key))
        return out

    def silent_peers(self, threshold_s: float = 60.0) -> list[str]:
        """Chunk-sending peers (actors) silent for ``threshold_s``: a
        remote actor's death shows here (the learner cannot respawn a
        remote process, but it can say so).  Sustained backpressure can
        trip it too: the signal means "look at this actor"."""
        now = time.monotonic()
        with self.receiver._peers_lock:
            senders = set(self.receiver._chunk_senders)
            seen = list(self.receiver.last_seen.items())
        return sorted(ident for ident, t in seen
                      if ident in senders and now - t > threshold_s)
