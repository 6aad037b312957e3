"""Frame-pool prioritized replay: stacks rebuilt on the device at sample time.

Counterpart of :mod:`apex_tpu.replay.frame_pool` (read its module docstring
for the storage layout, the self-contained chunk contract and the
staleness redirect; the semantics here are the same).  Differences:

* The ring is stored unpadded, ``[F, D]``.  The JAX ring pads rows to
  whole (8, 128) tiles and views them ``[F, 8, D/8]``, a constraint of
  the TPU's Mosaic DMAs that the CUDA gather does not have.
* The state is mutable: :meth:`FramePoolReplay.add` and the priority
  update write into preallocated tensors in place and return the state.
  The cursors ``pos``/``f_epoch``/``size`` are host integers (a chunk's
  counts come from the host anyway), so ingest and sample need no host
  sync.
* ``sample`` takes the per-stratum uniforms (``offsets``) where the JAX
  method takes a PRNG key: the learner draws them from a
  ``torch.Generator``, and the parity tests feed the ones JAX drew.
* Sampled stacks come back in the JAX layout, ``[B, H, W, S*c]`` (NHWC,
  oldest frame first), contiguous.  One
  :func:`~apex_tpu_torch.ops.gather.gather_stacks` call writes obs and
  next_obs together, as the two halves of one ``[2B, H, W, S*c]`` tensor,
  which the batch also carries as ``obs_pair`` (the loss's online pass
  reads it whole).
* Per-transition sidecars (``extra_spec``): f32 ``[C, *shape]`` tensors
  written in place by ``add`` at the transition's cells, from the chunk's
  ``extras`` dict, and returned by ``sample`` as top-level batch keys,
  gathered with plain indexing (outside the kernel).  The AQL family
  stores its candidate set ``a_mu [T, a_dim]`` there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from apex_tpu_torch.ops import tree as tree_ops
from apex_tpu_torch.ops.gather import gather_stacks
from apex_tpu_torch.replay.base import PERMethods

_BORN_STALE = -(2 ** 30)


def _wrap_i32(x: int) -> int:
    """Two's-complement int32 wraparound, as the JAX cursor's i32 does."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


@dataclass
class FramePoolState:
    """Mutable state of one frame pool (field meanings as in the JAX one)."""

    frames: torch.Tensor        # u8[F, D] flattened frame ring
    action: torch.Tensor        # i32[C]
    reward: torch.Tensor        # f32[C] pre-accumulated n-step return
    discount: torch.Tensor      # f32[C] bootstrap coefficient
    obs_ids: torch.Tensor       # i32[C, S] frame-ring rows, oldest first
    next_ids: torch.Tensor      # i32[C, S]
    frame_epoch: torch.Tensor   # i32[C] frame cursor epoch at ingest
    sum_tree: torch.Tensor      # f32[2C]
    min_tree: torch.Tensor      # f32[2C]
    pos: int                    # next transition write index
    f_epoch: int                # frames ever written, wrapped to int32
    size: int                   # live transition count
    max_priority: torch.Tensor  # f32 scalar
    extras: dict = field(default_factory=dict)  # f32[C, ...] sidecars


@dataclass(frozen=True)
class FramePoolReplay(PERMethods):
    """Static spec + methods over a :class:`FramePoolState`.

    ``frame_shape`` is one frame's shape, (H, W, c) for pixels or (D,) for
    vectors.  Sampled observations are ``(B, *frame_shape[:-1],
    S * frame_shape[-1])`` in ``frame_dtype``, oldest frame first.
    """

    capacity: int
    frame_shape: tuple[int, ...] = (84, 84, 1)
    frame_stack: int = 4
    frame_capacity: int | None = None
    frame_dtype: str = "uint8"
    alpha: float = 0.6
    eps: float = 1e-6
    # per-transition f32 sidecars: ((name, trailing_shape), ...)
    extra_spec: tuple[tuple[str, tuple[int, ...]], ...] = ()

    def __post_init__(self):
        tree_ops._check_capacity(self.capacity)
        tree_ops._check_capacity(self.f_capacity)
        if self.f_capacity < self.frame_stack:
            raise ValueError(
                f"frame_capacity={self.f_capacity} cannot hold one "
                f"{self.frame_stack}-frame stack")
        reserved = {"obs", "action", "reward", "next_obs", "discount",
                    "obs_pair"}
        for name, _ in self.extra_spec:
            if name in reserved:
                raise ValueError(f"extra_spec name {name!r} collides with "
                                 f"a builtin batch key")

    @property
    def f_capacity(self) -> int:
        return (self.frame_capacity if self.frame_capacity is not None
                else 2 * self.capacity)

    @property
    def frame_dim(self) -> int:
        return math.prod(self.frame_shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"uint8": torch.uint8, "float32": torch.float32}[self.frame_dtype]

    def hbm_bytes(self) -> int:
        """Device footprint of one :class:`FramePoolState`, checked against
        the budget before :meth:`init` allocates."""
        c, s = self.capacity, self.frame_stack
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        frame_bytes = self.f_capacity * self.frame_dim * itemsize
        # action/reward/discount/frame_epoch i32|f32 + 2 id tables + 2 trees
        per_trans = 4 * 4 + 2 * 4 * s
        per_trans += sum(4 * math.prod(shape) for _, shape in self.extra_spec)
        tree_bytes = 2 * (2 * c) * 4
        return frame_bytes + c * per_trans + tree_bytes

    # -- construction ------------------------------------------------------

    def init(self, device: torch.device | str) -> FramePoolState:
        c, s = self.capacity, self.frame_stack
        dev = torch.device(device)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return FramePoolState(
            frames=zeros(self.f_capacity, self.frame_dim,
                         dtype=self.torch_dtype),
            action=zeros(c, dtype=torch.int32),
            reward=zeros(c),
            discount=zeros(c),
            obs_ids=zeros(c, s, dtype=torch.int32),
            next_ids=zeros(c, s, dtype=torch.int32),
            frame_epoch=torch.full((c,), _BORN_STALE, dtype=torch.int32,
                                   device=dev),
            sum_tree=tree_ops.init_sum_tree(c, dev),
            min_tree=tree_ops.init_min_tree(c, dev),
            pos=0, f_epoch=0, size=0,
            max_priority=torch.tensor(1.0, device=dev),
            extras={name: zeros(c, *shape) for name, shape in self.extra_spec},
        )

    # -- mutation (in place) -----------------------------------------------

    def add(self, state: FramePoolState, chunk: dict,
            priorities, valid=None) -> FramePoolState:
        """Ingest one self-contained chunk in place.

        ``chunk`` keys: ``frames`` u8[Kf, D], ``n_frames``, ``n_trans``,
        ``action``/``reward``/``discount`` [K], ``obs_ref``/``next_ref``
        i32[K, S] (chunk-relative), optional ``epoch_off`` i32[K] and,
        with an ``extra_spec``, ``extras`` {name: [K, *shape]}; numpy
        arrays or tensors.  ``priorities`` f32[K].

        Pad rows (>= n_frames / n_trans, repeats of the last real row) land
        on the last real row's slot: identical duplicate writes.

        ``valid`` masks the whole ingest: False leaves the state untouched,
        True is the unmasked call.  It is read on the host (one sync when
        it is a device tensor).
        """
        dev = state.frames.device
        f, c = self.f_capacity, self.capacity

        def put(x, dtype):
            return torch.as_tensor(x).to(device=dev, dtype=dtype)

        kf = chunk["frames"].shape[0]
        k = priorities.shape[0]
        if kf > f:
            raise ValueError(
                f"chunk carries {kf} frame rows > frame_capacity={f}")
        if k > c:
            raise ValueError(
                f"chunk carries {k} transition rows > capacity={c}")
        if chunk["frames"].shape[1] != self.frame_dim:
            raise ValueError(
                f"chunk frame_dim {chunk['frames'].shape[1]} != spec "
                f"frame_dim {self.frame_dim}")
        for ref in ("obs_ref", "next_ref"):
            if tuple(chunk[ref].shape) != (k, self.frame_stack):
                raise ValueError(
                    f"chunk {ref} shape {tuple(chunk[ref].shape)} != "
                    f"({k}, {self.frame_stack})")
        epoch_off = chunk.get("epoch_off")
        if epoch_off is not None and tuple(epoch_off.shape) != (k,):
            raise ValueError(
                f"chunk epoch_off shape {tuple(epoch_off.shape)} != ({k},)")
        for name, shape in self.extra_spec:
            got = tuple(chunk["extras"][name].shape)
            if got != (k,) + tuple(shape):
                raise ValueError(
                    f"chunk extras[{name!r}] shape {got} != "
                    f"{(k,) + tuple(shape)}")
        if valid is not None and not bool(valid):
            return state
        n_frames, n_trans = int(chunk["n_frames"]), int(chunk["n_trans"])
        fpos = state.f_epoch % f

        frow = torch.arange(kf, device=dev).clamp_max(n_frames - 1)
        state.frames[(fpos + frow) % f] = put(chunk["frames"],
                                              self.torch_dtype)
        tidx = (state.pos + torch.arange(k, device=dev)
                .clamp_max(n_trans - 1)) % c
        obs_ids = (fpos + put(chunk["obs_ref"], torch.int64)) % f
        next_ids = (fpos + put(chunk["next_ref"], torch.int64)) % f
        epoch = torch.full((k,), state.f_epoch, dtype=torch.int32, device=dev)
        if epoch_off is not None:
            epoch = epoch + put(epoch_off, torch.int32)

        prios = put(priorities, torch.float32)
        tree_ops.update_both(state.sum_tree, state.min_tree, tidx,
                             self._to_tree_priority(prios))
        state.action[tidx] = put(chunk["action"], torch.int32)
        state.reward[tidx] = put(chunk["reward"], torch.float32)
        state.discount[tidx] = put(chunk["discount"], torch.float32)
        state.obs_ids[tidx] = obs_ids.int()
        state.next_ids[tidx] = next_ids.int()
        state.frame_epoch[tidx] = epoch
        for name, _ in self.extra_spec:
            state.extras[name][tidx] = put(chunk["extras"][name],
                                           torch.float32)
        state.pos = (state.pos + n_trans) % c
        state.f_epoch = _wrap_i32(state.f_epoch + n_frames)
        state.size = min(state.size + n_trans, c)
        state.max_priority = torch.maximum(state.max_priority, prios.max())
        return state

    # update_priorities / is_weights / _to_tree_priority: PERMethods.

    # -- sampling ----------------------------------------------------------

    def sample(self, state: FramePoolState, offsets: torch.Tensor,
               beta: float):
        """Stratified PER sample with one uniform per stratum
        (``offsets`` f32[B] in [0, 1)); returns ``(batch, weights, idx)``
        with stacks gathered from the frame ring.

        Staleness guard: transitions whose chunk's frames have aged out of
        the ring are redirected to the newest slot.  The int32 epoch
        difference wraps like the JAX one, safe for ages < 2^31.
        """
        idx = tree_ops.stratified_sample(state.sum_tree, offsets, state.size)
        age = state.f_epoch - state.frame_epoch[idx]
        newest = (state.pos - 1) % self.capacity
        idx = torch.where(age <= self.f_capacity, idx,
                          torch.full_like(idx, newest))
        b = idx.shape[0]
        ids = torch.cat([state.obs_ids[idx], state.next_ids[idx]])
        stacks = gather_stacks(state.frames, ids, self.frame_shape)
        batch = dict(
            obs=stacks[:b],
            action=state.action[idx],
            reward=state.reward[idx],
            next_obs=stacks[b:],
            discount=state.discount[idx],
            obs_pair=stacks,
            **{name: state.extras[name][idx] for name, _ in self.extra_spec},
        )
        weights = self.is_weights(state, idx, beta)
        return batch, weights, idx
