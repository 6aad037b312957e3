"""Frame-dedup prioritized SEQUENCE replay for the recurrent (R2D2) family.

Counterpart of :mod:`apex_tpu.replay.seq_pool` (read its module docstring
for the layout, the self-contained message contract and the staleness
redirect; the semantics here are the same): a frame ring ``[F, D]``
stores every env frame once, each sequence stores a ``[T]`` table of ring
rows (``obs_ids``) beside its per-step leaves and its stored recurrent
state, and sampling gathers the ``B*T`` rows into ``[B, T,
*frame_shape]``.

Differences, as in :mod:`apex_tpu_torch.replay.frame_pool`:

* The ring is stored unpadded, ``[F, D]`` (the JAX ring pads rows to
  whole (8, 128) tiles for the TPU's DMAs).
* The state is mutable: :meth:`SequenceFramePoolReplay.add` and the
  priority update write in place.  The cursors ``pos``/``f_epoch``/
  ``size`` are host integers, and so are a message's ``n_frames`` and
  ``n_seqs``: ingest and sample need no host sync.
* ``sample`` takes the per-stratum uniforms (``offsets``) where the JAX
  method takes a PRNG key.
* The ``B*T`` rows come from one :func:`~apex_tpu_torch.ops.gather.
  gather_rows` call: the CUDA kernel on the card (which raises rather
  than fall back), its plain version on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from apex_tpu_torch.ops import tree as tree_ops
from apex_tpu_torch.ops.gather import gather_rows
from apex_tpu_torch.replay.base import PERMethods
from apex_tpu_torch.replay.frame_pool import _BORN_STALE, _wrap_i32


#: the per-sequence leaves of ``prev_inputs``, with their dtypes
PREV_KEYS = {"prev_action": torch.int32, "prev_reward": torch.float32}


@dataclass
class SequenceFramePoolState:
    """Mutable state of one pooled sequence replay."""

    frames: torch.Tensor        # u8[F, D] frame ring
    action: torch.Tensor        # i32[C, T]
    reward: torch.Tensor        # f32[C, T]
    discount: torch.Tensor      # f32[C, T]
    mask: torch.Tensor          # f32[C, T]
    state_c: torch.Tensor       # f32[C, H] stored recurrent state (cell)
    state_h: torch.Tensor       # f32[C, H]
    obs_ids: torch.Tensor       # i32[C, T] frame-ring rows, in step order
    frame_epoch: torch.Tensor   # i32[C] frame cursor at ingest (staleness)
    sum_tree: torch.Tensor      # f32[2C]
    min_tree: torch.Tensor      # f32[2C]
    pos: int                    # next sequence write index
    f_epoch: int                # frames ever written, wrapped to int32
    size: int                   # live sequence count
    max_priority: torch.Tensor  # f32 scalar
    # with ``prev_inputs``: ``prev_action`` i32[C] and ``prev_reward``
    # f32[C], the action and reward of the step before each sequence
    extras: dict = field(default_factory=dict)


@dataclass(frozen=True)
class SequenceFramePoolReplay(PERMethods):
    """Static spec + methods over a :class:`SequenceFramePoolState`.

    ``t_total`` is the stored sequence length (burn_in + unroll +
    n_steps), ``lstm_features`` the recurrent state width and
    ``frame_shape`` one single frame (the family acts without a frame
    stack).  ``prev_inputs`` stores beside each sequence's stored state
    the action and reward of the step before it (:data:`PREV_KEYS`), for
    a model fed the previous action and reward.
    """

    capacity: int                                 # sequences
    t_total: int
    lstm_features: int
    frame_shape: tuple[int, ...] = (84, 84, 1)
    frame_capacity: int | None = None
    frame_dtype: str = "uint8"
    alpha: float = 0.6
    eps: float = 1e-6
    prev_inputs: bool = False

    def __post_init__(self):
        tree_ops._check_capacity(self.capacity)
        # the ring is plain modular arithmetic: any positive row count
        if self.f_capacity <= 0:
            raise ValueError(f"frame_capacity must be positive, "
                             f"got {self.f_capacity}")
        if self.f_capacity < self.t_total:
            raise ValueError(
                f"frame_capacity={self.f_capacity} cannot hold one "
                f"{self.t_total}-step sequence window")

    @property
    def f_capacity(self) -> int:
        return (self.frame_capacity if self.frame_capacity is not None
                else 4 * self.capacity)

    @property
    def frame_dim(self) -> int:
        return math.prod(self.frame_shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"uint8": torch.uint8, "float32": torch.float32}[self.frame_dtype]

    def hbm_bytes(self) -> int:
        """Device footprint of one state, checked against the budget
        before :meth:`init` allocates."""
        c, t, h = self.capacity, self.t_total, self.lstm_features
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        frame_bytes = self.f_capacity * self.frame_dim * itemsize
        per_seq = 4 * (5 * t + 2 * h + 1)   # 4 [T] leaves + ids, state, epoch
        if self.prev_inputs:
            per_seq += 4 * len(PREV_KEYS)
        tree_bytes = 2 * (2 * c) * 4
        return frame_bytes + c * per_seq + tree_bytes

    # -- construction ------------------------------------------------------

    def init(self, device: torch.device | str) -> SequenceFramePoolState:
        c, t, h = self.capacity, self.t_total, self.lstm_features
        dev = torch.device(device)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return SequenceFramePoolState(
            frames=zeros(self.f_capacity, self.frame_dim,
                         dtype=self.torch_dtype),
            action=zeros(c, t, dtype=torch.int32),
            reward=zeros(c, t), discount=zeros(c, t), mask=zeros(c, t),
            state_c=zeros(c, h), state_h=zeros(c, h),
            obs_ids=zeros(c, t, dtype=torch.int32),
            frame_epoch=torch.full((c,), _BORN_STALE, dtype=torch.int32,
                                   device=dev),
            sum_tree=tree_ops.init_sum_tree(c, dev),
            min_tree=tree_ops.init_min_tree(c, dev),
            pos=0, f_epoch=0, size=0,
            max_priority=torch.tensor(1.0, device=dev),
            extras={name: zeros(c, dtype=dtype)
                    for name, dtype in PREV_KEYS.items()}
            if self.prev_inputs else {},
        )

    # -- mutation (in place) -----------------------------------------------

    def add(self, state: SequenceFramePoolState, chunk: dict,
            priorities) -> SequenceFramePoolState:
        """Ingest one self-contained pooled sequence message in place.

        ``chunk`` keys: ``frames`` u8[Kf, D], ``n_frames``, ``n_seqs``,
        ``obs_ref`` i32[G, T] (message-relative), ``action`` i32[G, T],
        ``reward``/``discount``/``mask`` f32[G, T], ``state_c``/``state_h``
        f32[G, H], and with ``prev_inputs`` ``prev_action`` i32[G] and
        ``prev_reward`` f32[G]; numpy arrays or tensors.  ``priorities``
        f32[G].  Pad
        frame rows (>= n_frames) are all-zero and land on row 0's slot,
        the message's shared zero frame; pad sequences (>= n_seqs) repeat
        the last real one: identical duplicate writes either way.
        """
        dev = state.frames.device
        f, c, t = self.f_capacity, self.capacity, self.t_total

        def put(x, dtype):
            return torch.as_tensor(x).to(device=dev, dtype=dtype)

        kf = chunk["frames"].shape[0]
        g = priorities.shape[0]
        if kf > f:
            raise ValueError(
                f"message carries {kf} frame rows > frame_capacity={f}")
        if g > c:
            raise ValueError(
                f"message carries {g} sequences > capacity={c}")
        if chunk["frames"].shape[1] != self.frame_dim:
            raise ValueError(
                f"message frame_dim {chunk['frames'].shape[1]} != spec "
                f"frame_dim {self.frame_dim}")
        if tuple(chunk["obs_ref"].shape) != (g, t):
            raise ValueError(
                f"message obs_ref shape {tuple(chunk['obs_ref'].shape)} "
                f"!= ({g}, {t})")
        n_frames, n_seqs = int(chunk["n_frames"]), int(chunk["n_seqs"])
        fpos = state.f_epoch % f

        ar = torch.arange(kf, device=dev)
        frow = torch.where(ar < n_frames, ar, 0)
        state.frames[(fpos + frow) % f] = put(chunk["frames"],
                                              self.torch_dtype)
        tidx = (state.pos + torch.arange(g, device=dev)
                .clamp_max(n_seqs - 1)) % c
        obs_ids = (fpos + put(chunk["obs_ref"], torch.int64)) % f

        prios = put(priorities, torch.float32)
        tree_ops.update_both(state.sum_tree, state.min_tree, tidx,
                             self._to_tree_priority(prios))
        state.action[tidx] = put(chunk["action"], torch.int32)
        for name in ("reward", "discount", "mask", "state_c", "state_h"):
            getattr(state, name)[tidx] = put(chunk[name], torch.float32)
        for name, dtype in PREV_KEYS.items() if self.prev_inputs else ():
            state.extras[name][tidx] = put(chunk[name], dtype)
        state.obs_ids[tidx] = obs_ids.int()
        state.frame_epoch[tidx] = state.f_epoch
        state.pos = (state.pos + n_seqs) % c
        state.f_epoch = _wrap_i32(state.f_epoch + n_frames)
        state.size = min(state.size + n_seqs, c)
        state.max_priority = torch.maximum(state.max_priority, prios.max())
        return state

    # update_priorities / is_weights / _to_tree_priority: PERMethods.

    # -- sampling ----------------------------------------------------------

    def sample(self, state: SequenceFramePoolState, offsets: torch.Tensor,
               beta: float, group=None):
        """Stratified PER sample with one uniform per stratum
        (``offsets`` f32[B] in [0, 1)); returns ``(batch, weights, idx)``
        in the stacked sequence layout's schema, ``obs`` gathered
        ``[B, T, *frame_shape]`` from the ring.  Sequences whose frames
        have aged out of the ring redirect to the newest slot."""
        idx = tree_ops.stratified_sample(state.sum_tree, offsets, state.size)
        age = state.f_epoch - state.frame_epoch[idx]
        newest = (state.pos - 1) % self.capacity
        idx = torch.where(age <= self.f_capacity, idx,
                          torch.full_like(idx, newest))
        batch = dict(
            obs=self._gather_sequences(state, state.obs_ids[idx]),
            action=state.action[idx],
            reward=state.reward[idx],
            discount=state.discount[idx],
            mask=state.mask[idx],
            state_c=state.state_c[idx],
            state_h=state.state_h[idx],
            **{name: leaf[idx] for name, leaf in state.extras.items()},
        )
        weights = self.is_weights(state, idx, beta, group)
        return batch, weights, idx

    def _gather_sequences(self, state: SequenceFramePoolState,
                          ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ring rows -> (B, T, *frame_shape), in step order, with one
        :func:`gather_rows` call over the ``B*T`` ids."""
        b, t = ids.shape
        rows = gather_rows(state.frames, ids.reshape(-1))
        return rows.view(b, t, *self.frame_shape)
