"""Host-side builder of self-contained frame chunks for the frame pool.

A numpy copy of :mod:`apex_tpu.replay.frame_chunks` (the port imports
nothing of ``apex_tpu``), plus :func:`drain_builder_chunks`, the
chunk-to-message wrapping of ``apex_tpu/actors/pool.py:85-103``.

The actor-side counterpart of :class:`apex_tpu_torch.replay.frame_pool.FramePoolReplay`:
consumes SINGLE frames straight from the un-stacked env (FrameStack moves to
device sample time), maintains the acting stack for the policy, runs the same
n-step window semantics as :class:`apex_tpu.replay.nstep.NStepAccumulator`
(full-window ``gamma**n`` bootstrap, ``discount=0`` terminated tails,
``gamma**k`` truncated tails bootstrapping from the final frame —
``memory.py:393-478`` with the truncation correction), and emits fixed-shape
chunks:

    frames   u8[Kf, D]   flattened frames, first ``n_frames`` rows real
    n_frames i32         rows the device frame cursor advances by
    n_trans  i32         rows the device transition cursor advances by
    action/reward/discount  [K]
    obs_ref/next_ref        i32[K, S]  chunk-relative, oldest frame first
    priorities              f32[K]

with initial priorities from the Q-values observed while acting
(``memory.py:451-464`` — no extra network pass).  Pad rows (beyond
``n_trans``/``n_frames``) repeat the last real row INCLUDING its priority:
the device redirects them onto the last real row's ring slot, where
identical duplicate writes are deterministic no-ops (see the frame_pool
module docstring).  Chunks always carry at least one transition — a flush
with frames but no transitions keeps only the carry frames and ships
nothing.

Episode stacks pad at the start by repeating the reset frame, exactly like
``FrameStack.reset`` (``wrappers.py:202-206``, reference ``wrapper.py:231-236``).
"""

from __future__ import annotations

from collections import deque

import numpy as np

# Extra frame rows per chunk beyond one per transition (episode carry +
# reset frames).
FRAME_MARGIN = 16


def drain_builder_chunks(builder: "FrameChunkBuilder") -> list[dict]:
    """Builder chunks -> learner messages ``{"payload", "priorities",
    "n_trans"}``, the one message shape the learner's consume path reads
    (``apex_tpu/actors/pool.py:drain_builder_chunks``, without the
    observability spans, which the port has not taken over yet)."""
    return [{"payload": chunk,
             "priorities": chunk.pop("priorities"),
             "n_trans": int(chunk["n_trans"])}
            for chunk in builder.poll()]


class FrameChunkBuilder:
    """One builder per env slot (like the per-actor BatchStorage)."""

    def __init__(self, n_steps: int, gamma: float, frame_stack: int,
                 frame_shape: tuple[int, ...],
                 chunk_transitions: int = 64,
                 frame_margin: int = FRAME_MARGIN,
                 frame_dtype=np.uint8,
                 extra_shapes: dict | None = None):
        self.n = n_steps
        self.gamma = gamma
        self.s = frame_stack
        self.frame_shape = tuple(frame_shape)
        self.frame_dtype = np.dtype(frame_dtype)
        self.frame_dim = int(np.prod(frame_shape))
        self.K = chunk_transitions
        self.Kf = chunk_transitions + frame_margin
        # per-transition float32 sidecars captured at the acting step and
        # emitted with the window HEAD (FramePoolReplay.extra_spec twin:
        # the AQL family ships its a_mu candidate set here)
        self.extra_shapes = dict(extra_shapes or {})

        # episode state
        self._window: deque = deque()   # (ep_idx, action, reward, q_values)
        self._ep_step = -1              # ep index of the newest frame
        # recent (ep_idx, frame) pairs, newest last — sized to cover the
        # widest span a flush carry can need: window head's stack start
        # (ep_step - window_len - (S-1)) through ep_step, window_len <= n+1.
        self._recent: deque = deque(maxlen=frame_stack + n_steps + 1)
        self._ep2chunk: dict[int, int] = {}

        # view-backed acting-stack mode (bind_acting_view): the stack the
        # policy reads is maintained in place inside a caller-owned buffer,
        # rebuilt each step from rotating refs to the last S frames
        self._acting_view: np.ndarray | None = None
        self._view_frames: list[np.ndarray] = []

        self._chunks: list[dict] = []
        self._reset_chunk()

    # -- view-backed acting stack ------------------------------------------

    def stacked_shape(self) -> tuple[int, ...]:
        """Shape of the policy's acting stack: S frames channel-concatenated
        on the last axis (matches :meth:`current_stack`)."""
        return self.frame_shape[:-1] + (self.s * self.frame_shape[-1],)

    def bind_acting_view(self, view: np.ndarray) -> None:
        """Maintain the acting stack IN PLACE inside ``view`` (typically one
        row of a vector family's preallocated ``[B, *stacked]`` buffer).
        After binding, :meth:`current_stack` returns ``view`` without
        copying: ``begin_episode`` fills all S positions with the reset
        frame and ``add_step`` rolls the channel window forward — no
        per-step concatenate, no per-step allocation.  Callers must treat
        the returned stack as read-only."""
        want = self.stacked_shape()
        if tuple(view.shape) != want or view.dtype != self.frame_dtype:
            raise ValueError(
                f"acting view must be {want} {self.frame_dtype}, got "
                f"{tuple(view.shape)} {view.dtype}")
        self._acting_view = view

    def _view_reset(self, frame: np.ndarray) -> None:
        f = np.asarray(frame, self.frame_dtype).reshape(self.frame_shape)
        self._view_frames = [f] * self.s
        self._view_write()

    def _view_push(self, frame: np.ndarray) -> None:
        f = np.asarray(frame, self.frame_dtype).reshape(self.frame_shape)
        self._view_frames = self._view_frames[1:] + [f]
        self._view_write()

    def _view_write(self) -> None:
        """Rewrite all S channel slots from the rotating frame refs.  S
        small strided writes beat the in-place channel shift ~6x: the
        overlapping ``v[..., :-c] = v[..., c:]`` move forces numpy through
        its overlap-safe buffered path."""
        v = self._acting_view
        c = self.frame_shape[-1]
        for j, f in enumerate(self._view_frames):
            v[..., j * c:(j + 1) * c] = f

    # -- chunk buffer ------------------------------------------------------

    def _reset_chunk(self) -> None:
        self._frames: list[np.ndarray] = []
        self._trans: dict[str, list] = {
            k: [] for k in ("action", "reward", "discount", "obs_ref",
                            "next_ref", "q0", "qn")}
        self._extra_rows: dict[str, list] = {
            name: [] for name in self.extra_shapes}

    def _register_frame(self, ep_idx: int, frame: np.ndarray) -> None:
        self._ep2chunk[ep_idx] = len(self._frames)
        self._frames.append(np.asarray(frame, self.frame_dtype).reshape(-1))

    def _maybe_flush_for_frames(self, incoming: int = 1) -> None:
        if len(self._frames) + incoming > self.Kf:
            self._flush()

    def _stack_refs(self, end: int) -> list[int]:
        """Chunk refs of the S-stack ending at episode frame ``end``,
        oldest first, clamped to the episode start (repeat frame 0)."""
        return [self._ep2chunk[max(end - i, 0)]
                for i in range(self.s - 1, -1, -1)]

    # -- episode protocol --------------------------------------------------

    def begin_episode(self, frame: np.ndarray) -> None:
        """Register the reset observation."""
        self._window.clear()
        self._ep_step = -1              # no active episode while flushing
        self._maybe_flush_for_frames()
        self._ep_step = 0
        self._recent.clear()
        self._recent.append((0, np.asarray(frame, self.frame_dtype)))
        self._ep2chunk = {}
        self._register_frame(0, frame)
        if self._acting_view is not None:
            self._view_reset(frame)

    def current_stack(self) -> np.ndarray:
        """The policy's input: last S frames (oldest first, channel concat),
        padded at episode start by repeating the reset frame."""
        assert self._ep_step >= 0, "begin_episode first"
        if self._acting_view is not None:
            return self._acting_view
        by_idx = dict(self._recent)
        frames = [by_idx[max(self._ep_step - i, 0)]
                  for i in range(self.s - 1, -1, -1)]
        return np.concatenate([f.reshape(self.frame_shape) for f in frames],
                              axis=-1)

    def add_step(self, action: int, reward: float, q_values: np.ndarray,
                 new_frame: np.ndarray, terminated: bool,
                 truncated: bool, extras: dict | None = None) -> None:
        """Record one env step: the policy acted on the stack ending at the
        current newest frame; ``new_frame`` is the observation the env
        returned (on truncation it IS the final observation to bootstrap
        from — no separate argument needed).  ``extras`` must carry one
        array per declared ``extra_shapes`` name; they ship with the
        transition whose acting step this is (the window head)."""
        assert self._ep_step >= 0, "begin_episode first"
        self._maybe_flush_for_frames()
        obs_idx = self._ep_step
        self._ep_step += 1
        self._recent.append((self._ep_step, np.asarray(new_frame, self.frame_dtype)))
        self._register_frame(self._ep_step, new_frame)
        if self._acting_view is not None:
            self._view_push(new_frame)
        ex = {name: np.asarray((extras or {})[name], np.float32)
              for name in self.extra_shapes}
        self._window.append((obs_idx, action, float(reward),
                             np.asarray(q_values, np.float32), ex))

        if len(self._window) == self.n + 1:
            self._emit_full()
            self._window.popleft()
        if terminated:
            while self._window:
                self._emit_tail(bootstrap=False)
                self._window.popleft()
        elif truncated:
            while self._window:
                self._emit_tail(bootstrap=True)
                self._window.popleft()
        if terminated or truncated:
            self._ep_step = -1

    # -- emission ----------------------------------------------------------

    def _emit_full(self) -> None:
        w = self._window
        i0 = w[0][0]
        ret = sum((self.gamma ** i) * w[i][2] for i in range(self.n))
        self._push(w[0], ret, next_end=i0 + self.n,
                   discount=self.gamma ** self.n, qn=w[self.n][3])

    def _emit_tail(self, bootstrap: bool) -> None:
        w = self._window
        i0, k = w[0][0], len(w)
        ret = sum((self.gamma ** i) * w[i][2] for i in range(k))
        # terminated: next stack is a masked placeholder (the obs stack);
        # truncated: stack ends at the final frame i0 + k.
        self._push(w[0], ret, next_end=(i0 + k) if bootstrap else i0,
                   discount=(self.gamma ** k) if bootstrap else 0.0,
                   qn=w[-1][3])

    def _push(self, head: tuple, ret: float, next_end: int, discount: float,
              qn: np.ndarray) -> None:
        obs_idx, action, _, q0, extras = head
        t = self._trans
        t["action"].append(action)
        t["reward"].append(np.float32(ret))
        t["discount"].append(np.float32(discount))
        t["obs_ref"].append(self._stack_refs(obs_idx))
        t["next_ref"].append(self._stack_refs(next_end))
        t["q0"].append(q0)
        t["qn"].append(qn)
        for name in self.extra_shapes:
            self._extra_rows[name].append(extras[name])
        if len(t["action"]) == self.K:
            self._flush()

    # -- flush / carry -----------------------------------------------------

    def _flush(self) -> None:
        """Materialize the chunk (if it has transitions — frame-only chunks
        are dropped, their useful frames survive via the carry), then carry
        the frames the live window and acting stack still need."""
        if self._trans["action"]:
            self._chunks.append(self._materialize())
        elif not self._frames:
            return
        self._reset_chunk()
        if self._ep_step >= 0:
            head = self._window[0][0] if self._window else self._ep_step
            oldest_needed = max(head - (self.s - 1), 0)
            by_idx = dict(self._recent)
            self._ep2chunk = {}
            for ep_idx in range(oldest_needed, self._ep_step + 1):
                self._register_frame(ep_idx, by_idx[ep_idx])

    def _materialize(self) -> dict:
        t = self._trans
        n_trans = len(t["action"])
        n_frames = len(self._frames)
        assert n_trans >= 1 and n_frames >= 1

        def pad_to(rows: list, count: int, dtype):
            arr = np.asarray(rows, dtype)
            if len(arr) < count:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], count - len(arr), axis=0)])
            return arr

        chunk = dict(
            frames=pad_to(self._frames, self.Kf, self.frame_dtype),
            n_frames=np.int32(n_frames),
            n_trans=np.int32(n_trans),
            action=pad_to(t["action"], self.K, np.int32),
            reward=pad_to(t["reward"], self.K, np.float32),
            discount=pad_to(t["discount"], self.K, np.float32),
            obs_ref=pad_to(t["obs_ref"], self.K, np.int32),
            next_ref=pad_to(t["next_ref"], self.K, np.int32),
        )
        if self.extra_shapes:
            chunk["extras"] = {
                name: pad_to(self._extra_rows[name], self.K, np.float32)
                for name in self.extra_shapes}
        q0 = np.stack(t["q0"])
        qn = np.stack(t["qn"])
        q_taken = q0[np.arange(n_trans), chunk["action"][:n_trans]]
        target = (chunk["reward"][:n_trans]
                  + chunk["discount"][:n_trans] * qn.max(1))
        real = np.abs(target - q_taken).astype(np.float32) + 1e-6
        chunk["priorities"] = pad_to(real, self.K, np.float32)
        return chunk

    # -- consumption -------------------------------------------------------

    def poll(self) -> list[dict]:
        """Completed chunks accumulated since the last poll."""
        out, self._chunks = self._chunks, []
        return out

    def force_flush(self) -> list[dict]:
        """Flush any partial chunk (padded) and return everything pending.
        The in-flight n-step window is NOT emitted — flush at episode end
        (or after a truncated step) for exact coverage."""
        self._flush()
        return self.poll()
