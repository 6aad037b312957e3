"""What the host actors draw, written plainly.

A fleet of ``n_actors`` worker processes of ``B`` env slots each has
``N = n_actors * B`` slots; worker ``i`` owns slots ``i*B .. i*B + B-1``.

* Slot ``s`` runs its own Catch, seeded with ``env_seed + 1000 * (s + 1)``:
  a NumPy generator of that seed draws every new ball's column
  (``integers(0, grid)``), at each reset and whenever a ball lands with
  balls left.
* Slot ``s`` explores with probability ``eps_base ** (1 + s / (N - 1) *
  eps_alpha)``, held in float32.
* A worker steps all its slots once a vector step.  Its torch generator,
  seeded with its first slot's seed, draws one step seed ``randint(0,
  2**62)`` a vector step; each half-group ``g`` (the first ``ceil(B/2)``
  slots, then the rest) draws from a torch generator seeded with
  ``(step_seed + 0x9E3779B97F4A7C15 * (g + 1)) mod 2**64`` its random
  actions ``randint(0, A, [n_g])`` and then its uniforms ``rand([n_g])``.
  A slot takes its random action where its uniform is below its epsilon,
  else its greedy one.
"""

from __future__ import annotations

import numpy as np
import torch

GOLDEN = 0x9E3779B97F4A7C15


def epsilons(total: int, base: float, alpha: float) -> np.ndarray:
    if total == 1:
        return np.asarray([base], np.float32)
    i = np.arange(total, dtype=np.float64)
    return (base ** (1.0 + i / (total - 1) * alpha)).astype(np.float32)


def slot_seed(env_seed: int, slot: int) -> int:
    return int(env_seed) + 1000 * (slot + 1)


def lane_steps(env, seed: int, actions) -> tuple[tuple, list]:
    """The starting state of a slot seeded ``seed`` and its steps
    ``[(action, drop, reset)]`` under ``actions``: the columns are drawn
    from the slot's generator only where a ball is dropped or an episode
    starts, as the env draws them."""
    rng = np.random.default_rng(seed)

    def column() -> int:
        return int(rng.integers(0, env.grid))

    state = env.fresh(column())
    start, steps = state, []
    for a in actions:
        _, _, by, remaining = state
        drop = reset = 0
        if by + 1 == env.grid - 1:
            if remaining == 1:
                reset = column()
            else:
                drop = column()
        steps.append((int(a), drop, reset))
        state = env.step(state, a, drop, reset)[0]
    return start, steps


def worker_draws(first_seed: int, n_slots: int, n_steps: int,
                 eps: np.ndarray, n_actions: int):
    """``(random_actions, explore)``, each ``[n_steps, n_slots]``, of one
    worker over its first ``n_steps`` vector steps; ``eps`` are its slots'
    epsilons."""
    gen = torch.Generator().manual_seed(int(first_seed))
    half = (n_slots + 1) // 2
    groups = [sl for sl in (slice(0, half), slice(half, n_slots))
              if sl.stop > sl.start]
    eps_t = torch.from_numpy(np.asarray(eps, np.float32))
    rand_a = np.zeros((n_steps, n_slots), np.int64)
    explore = np.zeros((n_steps, n_slots), bool)
    for v in range(n_steps):
        step_seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        for g, sl in enumerate(groups):
            gg = torch.Generator().manual_seed(
                (step_seed + GOLDEN * (g + 1)) % 2 ** 64)
            n = sl.stop - sl.start
            rand_a[v, sl] = torch.randint(0, n_actions, (n,),
                                          generator=gg).numpy()
            explore[v, sl] = (torch.rand((n,), generator=gg)
                              < eps_t[sl]).numpy()
    return rand_a, explore
