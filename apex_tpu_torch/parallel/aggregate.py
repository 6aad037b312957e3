"""Chunk aggregation for the dp-sharded learner.

Counterpart of :mod:`apex_tpu.parallel.aggregate`.  Frame chunks are
self-contained (their frame refs are chunk-relative), so one chunk is
never split across replay shards: whole chunks round-robin onto the
ranks.  The aggregator buffers the pool's messages until it holds one per
rank, then stacks them on a leading dp axis; chunk i of a group goes to
rank i, so consecutive chunks, which come from different actors, land on
different shards (the interleaved stream behind each shard's local
sampling, :mod:`apex_tpu_torch.parallel.learner`).
"""

from __future__ import annotations

import numpy as np

from apex_tpu_torch.obs import spans as obs_spans


def tree_stack(trees: list):
    """Stack same-structured trees (dicts of arrays, nested dicts, numbers)
    leaf by leaf with ``np.stack``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def tree_index(tree, i: int):
    """Row ``i`` of every leaf of a :func:`tree_stack`-ed tree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def stack_chunk_messages(msgs: list) -> tuple:
    """``(payload, priorities, total_n_trans)`` of K chunk messages stacked
    on a new leading axis, on the host (``aggregate.py:17-32``).  Payloads
    may nest (frame chunks carry an ``extras`` dict of sidecars)."""
    payload = tree_stack([m["payload"] for m in msgs])
    prios = np.stack([np.asarray(m["priorities"]) for m in msgs])
    return payload, prios, sum(int(m["n_trans"]) for m in msgs)


def split_group(payload, prios, n_dp: int) -> list[tuple]:
    """The ``(payload, priorities)`` of each rank of a stacked group."""
    return [(tree_index(payload, r), np.asarray(prios[r]))
            for r in range(n_dp)]


class ChunkAggregator:
    """Pool wrapper: groups ``n_dp`` chunk messages into one stacked
    message; every other pool method delegates, so the trainer's loop
    drives it unchanged."""

    def __init__(self, pool, n_dp: int):
        self.pool = pool
        self.n_dp = n_dp
        self._buf: list[dict] = []

    # -- delegation ---------------------------------------------------------

    def start(self) -> None:
        self.pool.start()

    def cleanup(self) -> None:
        self.pool.cleanup()

    def publish_params(self, version: int, params) -> None:
        self.pool.publish_params(version, params)

    def poll_stats(self):
        return self.pool.poll_stats()

    @property
    def procs(self):
        return self.pool.procs

    @property
    def needs_warmup_republish(self):
        return getattr(self.pool, "needs_warmup_republish", False)

    # failure detection, the socket pool's fleet surface and an on-device
    # pool's device-params flag and counters pass through, so a sharded run
    # keeps respawn-on-death and publishes to an AnakinPool as the
    # unsharded one does (the trainer feature-detects them with hasattr)

    def __getattr__(self, name):
        if name in ("dead_workers", "respawn_worker", "worker_deaths",
                    "silent_peers", "peer_seen", "wire_rejected",
                    "set_learner_epoch", "rejoin_admitted",
                    "acks_withheld", "wire_summary", "force_keyframe",
                    "accepts_device_params", "ondevice_counters"):
            return getattr(self.pool, name)
        raise AttributeError(name)

    # -- aggregation --------------------------------------------------------

    def poll_chunks(self, max_chunks: int, timeout: float = 0.0) -> list:
        """One stacked message per ``n_dp`` buffered chunks."""
        out = []
        for _ in range(max_chunks):
            need = self.n_dp - len(self._buf)
            if need > 0:
                self._buf.extend(self.pool.poll_chunks(need, timeout))
            if len(self._buf) < self.n_dp:
                break
            msgs, self._buf = self._buf[:self.n_dp], self._buf[self.n_dp:]
            payload, prios, n_trans = stack_chunk_messages(msgs)
            group = {"payload": payload, "priorities": prios,
                     "n_trans": n_trans}
            # lineage spans ride the message through the stacking: one
            # span per source chunk, the "merge" hop stamped here
            spans = obs_spans.merge_spans(msgs)
            if spans:
                group[obs_spans.SPAN_KEY] = spans
            out.append(group)
        return out
