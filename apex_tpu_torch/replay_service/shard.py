"""One replay shard's compute: ingest -> prioritized sample -> write-back.

Counterpart of :mod:`apex_tpu.replay_service.shard` (read its module
docstring for the contract).  A shard owns one
:class:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay` on its device
and runs the three programs the learner's fused step is made of, as
separate calls:

* ``add`` -- the learner's ingest;
* ``sample`` -- the stratified PER sample, whose stacks come from one
  :func:`~apex_tpu_torch.ops.gather.gather_stacks` launch: on the card
  the hand-written gather kernel runs here, in the shard process;
* ``update_priorities`` -- the learner's TD priorities written back to
  the rows the batch was sampled from.

Where the JAX shard keeps a key chain (``chain, k = split(chain)`` per
batch), this one keeps a ``torch.Generator`` on its device and draws each
batch's per-stratum uniforms with
:func:`~apex_tpu_torch.ops.tree.stratified_offsets`, as the trainer's
``_offsets`` draws them.  So with ``strict_order=True`` and one shard,
``ingest(c1); b1 = next_batch(); write_back(b1); ingest(c2); ...`` leaves
params, every replay field and the generator state bit-identical to the
learner's serial loop over the same chunks (the beta of each sample is
taken from the ingest count before the chunk, as the trainer's
``_beta()`` is before its fused step).

Ordering modes: strict (default) samples batch j+1 only after batch j's
write-back and defers ingest behind an outstanding write-back
(:meth:`ReplayShardCore.can_ingest`: once the ring wraps, ingest and
write-back do not commute); loose pre-samples up to ``presample_depth``
batches and never defers.

Learner-epoch fencing: a write-back stamped with an older learner epoch
than the newest seen is counted and dropped; a pull with a newer epoch
forgives the old life's outstanding batches.

Lineage: the spans of the chunks ingested since the last sample (at
most :data:`MAX_BATCH_SPANS`, the freshest) ride the next sampled batch,
stamped ``shard_sample``.

Tenant quota: a tenant partition's core holds at most ``quota``
resident transitions (0: unlimited, the default partition's setting);
:meth:`ReplayShardCore.over_quota` is what the server refuses ingest on.
Residency saturates at the ring's capacity, so the quota is judged on
:meth:`ReplayShardCore.resident`, never on the cumulative ingest count.

Left out against the JAX shard: the AQL update key (the shards serve the
DQN family only).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.serving import fence

#: batch keys shipped to the learner; ``obs``/``next_obs`` are the two
#: halves of ``obs_pair`` and are rebuilt as views on arrival
BATCH_KEYS = ("obs_pair", "action", "reward", "discount")

#: most source-chunk lineage spans carried onto one sampled batch (the
#: batch mixes many chunks; the freshest few keep frame-age measurable)
MAX_BATCH_SPANS = 8


def batch_from_wire(batch: dict) -> dict:
    """A shipped batch (``obs_pair``, action, reward, discount) as the
    learner's batch dict: ``obs``/``next_obs`` as the two halves of
    ``obs_pair``, as :meth:`FramePoolReplay.sample` returns them."""
    out = dict(batch)
    pair = out["obs_pair"]
    half = pair.shape[0] // 2
    out["obs"], out["next_obs"] = pair[:half], pair[half:]
    return out


class ReplayShardCore:
    """State and programs of one replay shard (module docstring).

    ``generator`` draws the sample uniforms; it must live on ``device``.
    ``warmup`` is per shard; ``beta_anneal`` and ``n_shards`` estimate
    the fleet's ingest count for the beta schedule (local count x
    ``n_shards``, exact at N = 1).
    """

    #: spec fields a snapshot pins: a restore into a differently shaped
    #: shard is refused
    _SNAP_PINS = ("batch_size", "warmup", "n_shards", "strict_order")

    def __init__(self, replay: FramePoolReplay, generator: torch.Generator,
                 *, batch_size: int, warmup: int, beta: float = 0.4,
                 beta_anneal: int = 500_000, n_shards: int = 1,
                 strict_order: bool = True, presample_depth: int = 2,
                 device: torch.device | str = "cuda", quota: int = 0):
        self.replay = replay
        self.device = torch.device(device)
        self.state = replay.init(self.device)
        self.generator = generator
        self.batch_size = int(batch_size)
        self.warmup = int(warmup)
        self.beta0 = float(beta)
        self.beta_anneal = int(beta_anneal)
        self.n_shards = max(1, int(n_shards))
        self.strict_order = bool(strict_order)
        self.presample_depth = max(1, int(presample_depth))
        # a tenant partition's bound on resident transitions (0 =
        # unlimited); the server refuses (acks and counts) ingest past it
        self.quota = max(0, int(quota))
        self.quota_dropped = 0
        self.ingested = 0               # transitions ever ingested
        self.chunks = 0
        self.sampled = 0                # batches ever sampled
        self.wb_applied = 0             # write-backs applied (next seq)
        self.dup_wb = 0                 # duplicate or late write-backs
        self.learner_epoch = 0          # newest epoch seen (0 = unstamped)
        self.stale_wb = 0               # stale-epoch write-backs dropped
        self.epoch_forgiven = 0         # batches forgiven on epoch bumps
        self.restored = 0               # transitions resident at restore
        self._outbox: deque[dict] = deque()
        self._pending_spans: deque = deque(maxlen=MAX_BATCH_SPANS)

    # -- gating --------------------------------------------------------------

    @property
    def warm(self) -> bool:
        return self.ingested >= self.warmup

    def outstanding(self) -> int:
        """Batches sampled whose priorities have not come back."""
        return self.sampled - self.wb_applied

    def resident(self) -> int:
        """Transitions resident now: the ring overwrites past its
        capacity, so residency saturates there."""
        return min(self.ingested, self.replay.capacity)

    def over_quota(self) -> bool:
        """The partition holds its tenant's quota: further ingest is
        refused."""
        return self.quota > 0 and self.resident() >= self.quota

    def can_ingest(self) -> bool:
        """Strict mode defers ingest behind an outstanding write-back."""
        return not self.strict_order or self.outstanding() == 0

    def _can_sample(self) -> bool:
        if not self.warm:
            return False
        if self.strict_order:
            return self.outstanding() == 0 and not self._outbox
        return self.outstanding() < self.presample_depth

    def beta(self, ingested: int | None = None) -> float:
        """The trainer's ``_beta`` on the estimated fleet ingest count."""
        n = (self.ingested if ingested is None else ingested) * self.n_shards
        frac = min(1.0, n / max(1, self.beta_anneal))
        return self.beta0 + (1.0 - self.beta0) * frac

    # -- ingest --------------------------------------------------------------

    def ingest_msg(self, msg: dict) -> None:
        """Ingest one chunk message (``{"payload", "priorities",
        "n_trans"}``).  When the shard was warm before this chunk, one
        batch is pre-sampled with the pre-ingest beta: the fused step's
        sample half."""
        warm_pre = self.warm
        beta_pre = self.beta()
        self.state = self.replay.add(
            self.state, msg["payload"],
            torch.as_tensor(np.asarray(msg["priorities"], np.float32)))
        self.ingested += int(msg["n_trans"])
        self.chunks += 1
        spans = obs_spans.spans_of(msg)
        if spans:
            self._pending_spans.extend(spans)
        if warm_pre and self._can_sample():
            self._outbox.append(self._sample_batch(beta_pre))

    # -- sampling ------------------------------------------------------------

    def _offsets(self) -> torch.Tensor:
        """One batch's per-stratum uniforms, as the trainer draws them."""
        return stratified_offsets(self.batch_size, self.generator,
                                  self.device)

    def _sample_batch(self, beta: float) -> dict:
        batch, weights, idx = self.replay.sample(self.state, self._offsets(),
                                                 beta)
        seq = self.sampled
        self.sampled += 1
        out = {
            "kind": "batch",
            "seq": seq,
            "batch": {k: batch[k].cpu().numpy() for k in BATCH_KEYS},
            "weights": weights.cpu().numpy(),
            "idx": idx.cpu().numpy(),
            "ingested": self.ingested,
            "sampled": self.sampled,
        }
        spans = list(self._pending_spans)
        self._pending_spans.clear()
        if spans:
            obs_spans.stamp_spans(spans, "shard_sample")
            out[obs_spans.SPAN_KEY] = spans
        return out

    def next_batch(self) -> dict | None:
        """The next pre-sampled batch, or one sampled now (the learner
        pulls faster than chunks arrive), or None when the shard cannot
        serve one (cold, or strict mode waiting on a write-back)."""
        if self._outbox:
            return self._outbox.popleft()
        if self._can_sample():
            return self._sample_batch(self.beta())
        return None

    # -- write-back ----------------------------------------------------------

    def note_epoch(self, epoch: int) -> int:
        """A pull stamped with a newer learner epoch proves a restart:
        the old life's outstanding batches are forgiven now.  Returns the
        number forgiven."""
        if not fence.newer_epoch(epoch, self.learner_epoch):
            return 0
        forgiven = 0
        if self.learner_epoch and self.outstanding() > 0:
            forgiven = self.forgive_outstanding()
            self.epoch_forgiven += forgiven
        self.learner_epoch = int(epoch)
        return forgiven

    def write_back(self, seq: int, idx, priorities, epoch: int = 0) -> bool:
        """Apply one batch's TD priorities to the rows it was sampled
        from.  A duplicate (``seq`` below the next expected) or a
        stale-epoch write-back is counted and dropped; one whose rows do
        not fit the batch and the tree raises ``ValueError``."""
        if epoch and self.learner_epoch \
                and fence.stale_epoch(epoch, self.learner_epoch):
            self.stale_wb += 1
            return False
        if fence.newer_epoch(epoch, self.learner_epoch):
            self.learner_epoch = int(epoch)
        if seq < self.wb_applied:
            self.dup_wb += 1
            return False
        idx = np.asarray(idx)
        priorities = np.asarray(priorities, np.float32)
        # rows from the wire: an index past the tree would be a device
        # assert on the card, so a malformed write-back raises here
        if (idx.shape != (self.batch_size,) or priorities.shape != idx.shape
                or not np.issubdtype(idx.dtype, np.integer)
                or idx.min() < 0 or idx.max() >= self.replay.capacity):
            raise ValueError(f"write-back of idx {idx.shape} {idx.dtype}, "
                             f"priorities {priorities.shape} does not fit "
                             f"batch {self.batch_size} over capacity "
                             f"{self.replay.capacity}")
        self.state = self.replay.update_priorities(
            self.state, torch.as_tensor(idx).to(self.device),
            torch.as_tensor(priorities).to(self.device))
        self.wb_applied = int(seq) + 1
        return True

    def forgive_outstanding(self) -> int:
        """Abandon write-backs that will never come; a late one lands as
        a counted duplicate.  Returns the number forgiven."""
        n = self.outstanding()
        self.wb_applied = self.sampled
        return n

    # -- snapshots -----------------------------------------------------------

    def quiescent(self) -> bool:
        """A snapshot now resumes the strict lockstep: nothing in flight
        and nothing pre-sampled.  Loose mode snapshots anywhere."""
        if not self.strict_order:
            return True
        return self.outstanding() == 0 and not self._outbox

    def snapshot_meta(self) -> dict:
        meta = {p: getattr(self, p) for p in self._SNAP_PINS}
        meta.update(
            capacity=self.replay.capacity, ingested=self.ingested,
            chunks=self.chunks, sampled=self.sampled,
            wb_applied=self.wb_applied, dup_wb=self.dup_wb,
            stale_wb=self.stale_wb, epoch_forgiven=self.epoch_forgiven,
            learner_epoch=self.learner_epoch)
        return meta

    def _bundle(self) -> dict:
        rs = self.state
        return {"state": {name: getattr(rs, name)
                          for name in rs.__dataclass_fields__},
                "generator": self.generator.get_state()}

    def save_snapshot(self, path: str) -> str:
        """Write the whole shard (replay state, generator, counters)
        atomically through :func:`~apex_tpu_torch.training.checkpoint.
        save_bundle`."""
        from apex_tpu_torch.training.checkpoint import save_bundle
        return save_bundle(path, self._bundle(), self.snapshot_meta())

    def _check_pins(self, meta: dict) -> None:
        for pin in self._SNAP_PINS + ("capacity",):
            want = (self.replay.capacity if pin == "capacity"
                    else getattr(self, pin))
            if meta.get(pin) != want:
                raise ValueError(
                    f"snapshot {pin}={meta.get(pin)!r} != live shard "
                    f"{pin}={want!r}: refusing the restore")

    def restore_snapshot(self, path: str) -> dict:
        """Resume from a snapshot: replay state, generator and counters
        bit-exact; batches in flight when it was taken are forgiven.
        Raises ``ValueError`` on a spec mismatch, before anything is
        overwritten."""
        from apex_tpu_torch.training.checkpoint import restore_bundle
        bundle, meta = restore_bundle(path, self._bundle(),
                                      check=self._check_pins)
        for name, value in bundle["state"].items():
            setattr(self.state, name, value)
        self.generator.set_state(bundle["generator"])
        for name in ("ingested", "chunks", "sampled", "dup_wb", "stale_wb",
                     "epoch_forgiven", "learner_epoch"):
            setattr(self, name, int(meta[name]))
        self.wb_applied = self.sampled
        self._outbox.clear()
        self._pending_spans.clear()
        self.restored = self.ingested
        return meta

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        return {
            "ingested": self.ingested,
            "chunks": self.chunks,
            "sampled": self.sampled,
            "wb_applied": self.wb_applied,
            "dup_wb": self.dup_wb,
            "stale_wb": self.stale_wb,
            "epoch_forgiven": self.epoch_forgiven,
            "learner_epoch": self.learner_epoch,
            "restored": self.restored,
            "outbox": len(self._outbox),
            "warm": self.warm,
            "quota": self.quota,
            "quota_dropped": self.quota_dropped,
        }
