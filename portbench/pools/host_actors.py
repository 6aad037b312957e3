"""Host actor processes as the cell's pool: the trainer's own
``ActorPool`` (``n_actors`` processes of ``n_envs_per_actor`` envs over
the shared-memory ring), set by the traffic's ``settings.actor``.

The actors run in processes of their own, so nothing of them is wrapped.
What they ship is judged against what their seeds and draws make
(:mod:`portbench.reference.actors`): the learner's queue reads are
wrapped to learn which worker sent each captured message, each message
is given to the one env slot of that worker whose replayed Catch stands
where the message starts, and each slot is replayed from its seed with
the actions it shipped (:func:`judge`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.check import greedy_gap
from portbench.reference.actors import (epsilons, lane_steps, slot_seed,
                                        worker_draws)
from portbench.reference.catch import Catch, lane_transitions
from portbench.reference.follow import tf32_off
from portbench.reference.nets import dueling_q, fp8_quant


def build(cfg, traffic: dict, device):
    """None: the trainer makes its own actor pool from the config."""
    return None


def install(probe, traffic: dict) -> None:
    """Once the pool has started, wrap its chunk queue's reads so that
    each polled message's worker is known (``probe.sender``)."""
    pool = probe.trainer.pool
    start = pool.start

    def started():
        start()
        q = pool.chunk_queue
        for name in ("get", "get_nowait"):
            read = getattr(q, name)

            def tagged(*args, _read=read, **kwargs):
                item = _read(*args, **kwargs)
                probe.sender[id(item[2])] = item[1]
                return item

            object.__setattr__(q, name, tagged)

    object.__setattr__(pool, "start", started)
    cfg = probe.trainer.cfg
    if cfg.actor.max_episode_length is not None or cfg.actor.eps_anneal_steps:
        raise ValueError("the actors' judge replays Catch's own episodes "
                         "at a constant epsilon ladder")
    probe.pool_record = dict(
        env_seed=cfg.env.seed, n_actors=cfg.actor.n_actors,
        n_envs=cfg.actor.n_envs_per_actor, eps_base=cfg.actor.eps_base,
        eps_alpha=cfg.actor.eps_alpha, n=cfg.learner.n_steps,
        gamma=cfg.learner.gamma)


def record(probe) -> dict:
    """The messages the reference reads, with their worker and the param
    version they were acted under, and the first version published."""
    out = dict(probe.pool_record)
    out["messages"] = [(p, pr, meta["actor"], meta["pv"])
                       for (p, pr), meta in zip(probe.messages,
                                                probe.message_meta)]
    out["first_version"] = (min(probe.publishes) if probe.publishes
                            else None)
    return out


def _acting_stacks(env: Catch, seed: int, actions: list) -> list:
    """The acting stack of every step of a slot seeded ``seed`` under
    ``actions``, and of the step after them."""
    start, steps = lane_steps(env, seed, list(actions) + [0])
    return lane_transitions(env, start, steps, 1, 1.0)[1]


class _Lane:
    """One slot: its seed and the actions it has shipped so far."""

    def __init__(self, env: Catch, seed: int):
        self.env, self.seed, self.actions = env, seed, []
        self._next = None

    def stacks(self, more: list) -> list:
        """Acting stacks from the next step on, under ``more`` actions."""
        k0 = len(self.actions)
        return _acting_stacks(self.env, self.seed, self.actions + more)[k0:]

    def acting(self) -> np.ndarray:
        if self._next is None:
            self._next = self.stacks([])[0]
        return self._next

    def advance(self, actions: list) -> None:
        self.actions = self.actions + actions
        self._next = None


def _unpack(payload: dict, pixels: int) -> list:
    frames = np.asarray(payload["frames"]).reshape(-1, pixels, pixels)
    out = []
    for t in range(int(payload["n_trans"])):
        out.append((frames[np.asarray(payload["obs_ref"][t])],
                    int(payload["action"][t]),
                    np.float32(payload["reward"][t]),
                    np.float32(payload["discount"][t]),
                    frames[np.asarray(payload["next_ref"][t])]))
    return out


def _owner(lanes: list, trans: list):
    """The lane that stands where the message starts; where several do,
    the first that acts on every stack of the message under its
    actions."""
    cands = [ln for ln in lanes if np.array_equal(ln.acting(), trans[0][0])]
    if len(cands) > 1:
        actions = [t[1] for t in trans]
        full = [ln for ln in cands
                if all(np.array_equal(st, t[0])
                       for st, t in zip(ln.stacks(actions), trans))]
        cands = full or cands
    return cands[0] if cands else None


def judge(rec: dict, init: dict, device, variants) -> dict:
    """The host actors' captured messages against Catch replayed from each
    slot's seed under the actions it shipped.

    ``actor_mismatch`` counts the shipped transitions' elements (stacks,
    n-step return, discount) that differ from the replay's, the messages
    no slot of their worker replays, and the exploring steps whose action
    is not the drawn one.  Over the steps acted under the first published
    weights (the run's initial ones): ``actor_prio_gap``, the acting
    priorities ``|R + discount * max Q(next) - Q(obs, a)| + 1e-6`` against
    float32 Q-values, ``|p - p_ref| / |p_ref|`` over every such
    transition; ``actor_action_gap``, the widest gap by which a greedy
    action lies below its stack's best float32 Q-value.  The control acts
    and prices in the program's place in float8."""
    tf32_off()
    env = Catch()
    b_per, n_slots = rec["n_envs"], rec["n_actors"] * rec["n_envs"]
    eps = epsilons(n_slots, rec["eps_base"], rec["eps_alpha"])
    lanes = [_Lane(env, slot_seed(rec["env_seed"], s))
             for s in range(n_slots)]
    shipped = {s: [] for s in range(n_slots)}
    bad = 0
    for payload, prios, actor, pv in rec["messages"]:
        trans = _unpack(payload, env.pixels)
        own = (None if actor is None else
               _owner(lanes[actor * b_per:(actor + 1) * b_per], trans))
        if own is None:
            bad += len(trans)
            continue
        s = lanes.index(own)
        own.advance([t[1] for t in trans])
        prios = np.asarray(prios, np.float32)
        shipped[s].extend((t, float(prios[i]), pv)
                          for i, t in enumerate(trans))
    first = rec["first_version"]
    checked, greedy_stacks, greedy_actions = [], [], []
    for a in range(rec["n_actors"]):
        slots = range(a * b_per, (a + 1) * b_per)
        n_steps = max(len(lanes[s].actions) for s in slots)
        rand_a, explore = worker_draws(
            slot_seed(rec["env_seed"], a * b_per), b_per, n_steps,
            eps[list(slots)], init["advantage_out.weight"].shape[0])
        for j, s in enumerate(slots):
            start, steps = lane_steps(env, lanes[s].seed, lanes[s].actions)
            ref, acting = lane_transitions(env, start, steps, rec["n"],
                                           rec["gamma"])
            for k, ((got, p, pv), want) in enumerate(zip(shipped[s], ref)):
                bad += int((got[0] != want[0]).sum())
                bad += int((got[4] != want[4]).sum())
                bad += int(got[2] != want[2]) + int(got[3] != want[3])
                if explore[k, j]:
                    bad += int(got[1] != rand_a[k, j])
                elif pv == first:
                    greedy_stacks.append(acting[k])
                    greedy_actions.append(got[1])
                if pv == first:
                    checked.append((got, p))
    params = {k: v.to(device=device, dtype=torch.float32)
              for k, v in init.items()}
    out = {}
    for name in variants:
        if name not in ("program", "control"):
            continue
        quant = fp8_quant if name == "control" else None
        out[name] = {
            "actor_prio_gap": _prio_gap(params, checked, device, quant,
                                        name == "control"),
            "actor_action_gap": greedy_gap(params, greedy_stacks,
                                           greedy_actions, device, quant)}
    if "program" in out:
        out["program"]["actor_mismatch"] = bad
    return out


def _priorities(params, trans: list, device, quant=None) -> torch.Tensor:
    obs = np.stack([t[0] for t in trans])
    nxt = np.stack([t[4] for t in trans])
    x = torch.as_tensor(np.concatenate([obs, nxt])).to(device).permute(
        0, 2, 3, 1).contiguous()
    q = dueling_q(params, x, quant)
    q0, qn = q[:len(trans)], q[len(trans):]
    a = torch.as_tensor([t[1] for t in trans], device=device)
    r = torch.as_tensor(np.asarray([t[2] for t in trans]), device=device)
    d = torch.as_tensor(np.asarray([t[3] for t in trans]), device=device)
    target = r + d * qn.max(dim=1).values
    return (target - q0.gather(1, a[:, None])[:, 0]).abs() + 1e-6


def _prio_gap(params, checked: list, device, quant, control: bool) -> float:
    """``|p - p_ref| / |p_ref|`` over the checked transitions; ``p`` the
    shipped priorities, or the control's own."""
    if not checked:
        return float("nan")
    num = den = 0.0
    with torch.no_grad():
        for lo in range(0, len(checked), 512):
            part = checked[lo:lo + 512]
            trans = [t for t, _ in part]
            ref = _priorities(params, trans, device).double()
            got = (_priorities(params, trans, device, quant).double()
                   if control else torch.as_tensor(
                       [p for _, p in part], device=device).double())
            num += float(((got - ref) ** 2).sum())
            den += float((ref ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5
