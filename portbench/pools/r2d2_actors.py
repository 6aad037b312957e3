"""Host actor processes of the recurrent family as the cell's pool: the
trainer's own ``ActorPool`` of vector R2D2 workers (``n_actors``
processes of ``n_envs_per_actor`` env slots, one batched CPU policy call
of the recurrent net a vector step), set by the traffic's
``settings.actor``.

The actors run in processes of their own, so nothing of them is wrapped;
the learner's queue reads are wrapped to learn which worker sent each
captured message.  What they shipped is judged against what their seeds
and draws make (:func:`judge`): each shipped sequence is given to the
env slot of its worker whose replayed Catch, under the actions shipped so
far, reproduces its frames, and each slot's game is replayed from its
seed with the actions it shipped.  The recurrent worker steps all its
slots behind one generator a vector step (one group: its carry cannot be
split), so its exploring draws are those of
:func:`portbench.reference.actors.worker_draws`' first half-group taken
over every slot.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import r2d2 as net
from portbench.reference.actors import GOLDEN, epsilons, slot_seed
from portbench.reference.catch import Catch
from portbench.reference.nets import fp8_quant
from portbench.reference.r2d2_follow import bf16_quant

# Catch's geometry by env id (apex_tpu_torch/envs/registry.py)
CATCH = {"ApexCatch-v0": (21, 84, 5), "ApexCatchLong-v0": (21, 84, 50),
         "ApexCatchSmall-v0": (7, 42, 3)}


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
    if (cfg.actor.max_episode_length is not None or cfg.actor.eps_anneal_steps
            or cfg.actor.n_envs_per_actor < 2 or not cfg.replay.frame_pool):
        raise ValueError("the actors' judge replays Catch's own games in "
                         "vector workers at a constant epsilon ladder, "
                         "shipping pooled sequence messages")
    rc, lc = cfg.r2d2, cfg.learner
    probe.pool_record = dict(
        env_seed=cfg.env.seed, catch=CATCH[cfg.env.env_id],
        n_actors=cfg.actor.n_actors, n_envs=cfg.actor.n_envs_per_actor,
        eps_base=cfg.actor.eps_base, eps_alpha=cfg.actor.eps_alpha,
        burn_in=rc.burn_in, unroll=rc.unroll,
        stride=rc.stride or max(1, rc.unroll // 2), n=lc.n_steps,
        gamma=lc.gamma, rescale_eps=rc.value_rescale_eps or None)


def record(probe) -> dict:
    """The messages the reference reads, with their worker and the param
    version they were sent under, and the first version published."""
    out = dict(probe.pool_record)
    out["messages"] = [(p, pr, meta["actor"], meta["pv"])
                       for (p, pr), meta in zip(probe.messages,
                                                probe.message_meta)]
    out["first_version"] = (min(probe.publishes) if probe.publishes
                            else None)
    return out


class Lane:
    """One env slot's Catch, replayed from its seed: the games so far
    (each a list of frames ``f_0..f_n`` and of ``(action, reward,
    done)`` steps, the last one open) and the generator that draws its
    balls' columns, as the env draws them; and where its next shipped
    sequence should start (``game``, ``start``)."""

    def __init__(self, env: Catch, seed: int):
        self.env, self.seed = env, seed
        self.rng = np.random.default_rng(seed)
        self.state = env.fresh(self._column(self.rng))
        self.games = [([env.render(self.state)], [])]
        self.game, self.start = 0, 0

    def _column(self, rng) -> int:
        return int(rng.integers(0, self.env.grid))

    def _run(self, state, rng, actions):
        """Frames and steps of ``actions`` from ``state``, drawing from
        ``rng``; a game's end starts the next game's frame list."""
        env, frames, steps, games = self.env, [], [], []
        for a in actions:
            _, _, by, remaining = state
            drop = reset = 0
            if by + 1 == env.grid - 1:
                if remaining == 1:
                    reset = self._column(rng)
                else:
                    drop = self._column(rng)
            state, final, first, reward, done = env.step(state, a, drop,
                                                         reset)
            frames.append(final)
            steps.append((int(a), np.float32(reward), done))
            if done:
                games.append((frames, steps))
                frames, steps = [first], []
        games.append((frames, steps))
        return state, games

    def game_after(self, actions, commit: bool):
        """``(frames, steps)`` of the open game after ``actions`` more
        (past its end, the game they end); with ``commit`` the lane keeps
        them and opens the next game."""
        rng = np.random.default_rng()
        rng.bit_generator.state = self.rng.bit_generator.state
        state, games = self._run(self.state, rng, actions)
        frames = self.games[-1][0] + games[0][0]
        steps = self.games[-1][1] + games[0][1]
        if commit:
            self.state, self.rng = state, rng
            self.games[-1] = (frames, steps)
            self.games.extend(games[1:])
        return frames, steps

    def advance(self, rec: dict) -> None:
        """Past the sequence at ``start``: the next one starts ``stride``
        later, or at the next game's start once no loss step is left."""
        self.start += rec["stride"]
        steps = self.games[self.game][1]
        ended = self.game < len(self.games) - 1
        if ended and self.start + rec["burn_in"] >= len(steps):
            self.game, self.start = self.game + 1, 0

    @property
    def total_steps(self) -> int:
        return sum(len(s) for _, s in self.games)


def _sequences(payload: dict, prios):
    g, frames = int(payload["n_seqs"]), np.asarray(payload["frames"])
    for i in range(g):
        yield dict(frames=frames[np.asarray(payload["obs_ref"][i])],
                   **{k: np.asarray(payload[k])[i]
                      for k in ("action", "reward", "discount", "mask",
                                "state_c", "state_h", "prev_action",
                                "prev_reward")},
                   priority=float(np.asarray(prios)[i]))


def _check(lane: Lane, seq: dict, rec: dict):
    """``(mismatched elements, real steps)`` of ``seq`` given to
    ``lane`` at its next start, or None when the lane's game does not
    reproduce the sequence's frames there under its actions."""
    real = int(seq["mask"].sum())
    st = lane.start
    shipped = [int(a) for a in seq["action"][:real]]
    frames, steps = lane.games[lane.game]
    known = len(steps)
    if [x[0] for x in steps[st:st + real]] != shipped[:max(0, known - st)]:
        return None
    if st + real > known:
        if lane.game != len(lane.games) - 1 or known < st:
            return None
        frames, steps = lane.game_after(shipped[known - st:], commit=False)
    if len(steps) < st + real:
        return None
    want = np.stack(frames[st:st + real]).reshape(
        (real,) + seq["frames"].shape[1:])
    if not np.array_equal(seq["frames"][:real], want):
        return None
    pad = seq["action"].shape[0] - real
    window = steps[st:st + real]
    rewards = np.asarray([x[1] for x in window], np.float32)
    disc = np.asarray([0.0 if x[2] else rec["gamma"] for x in window],
                      np.float32)
    bad = int(np.count_nonzero(seq["frames"][real:]))
    bad += int((seq["reward"] != np.pad(rewards, (0, pad))).sum())
    bad += int((seq["discount"] != np.pad(disc, (0, pad))).sum())
    bad += int((seq["mask"] != np.pad(np.ones(real, np.float32),
                                      (0, pad))).sum())
    bad += int(np.count_nonzero(seq["action"][real:]))
    prev_a, prev_r = (steps[st - 1][0], steps[st - 1][1]) if st else (0, 0.0)
    bad += int(int(seq["prev_action"]) != prev_a)
    bad += int(np.float32(seq["prev_reward"]) != np.float32(prev_r))
    return bad, real


def worker_draws(first_seed: int, n_slots: int, n_steps: int, eps,
                 n_actions: int):
    """``(random_actions, explore)``, each ``[n_steps, n_slots]``: one
    step seed a vector step from the worker's generator, one group
    generator of it for all the slots, actions then uniforms."""
    gen = torch.Generator().manual_seed(int(first_seed))
    eps_t = torch.from_numpy(np.asarray(eps, np.float32))
    rand_a = np.zeros((n_steps, n_slots), np.int64)
    explore = np.zeros((n_steps, n_slots), bool)
    for v in range(n_steps):
        step_seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        gg = torch.Generator().manual_seed((step_seed + GOLDEN) % 2 ** 64)
        rand_a[v] = torch.randint(0, n_actions, (n_slots,),
                                  generator=gg).numpy()
        explore[v] = (torch.rand((n_slots,), generator=gg) < eps_t).numpy()
    return rand_a, explore


def judge(rec: dict, init: dict, device, variants) -> dict:
    """The captured sequences against Catch replayed from each slot's seed
    under the actions it shipped.

    ``actor_mismatch`` counts the shipped sequences' elements (frames,
    rewards, discounts, masks, padding, the previous action and reward)
    that differ from the replay's, the sequences no slot of their worker
    replays, and the exploring steps whose action is not the drawn one.
    Over the sequences sent under the first published weights (the run's
    initial ones; their games were acted wholly under them up to their
    end): ``actor_state_gap``, the stored ``(c, h)`` at their starts
    against the float32 reference LSTM unrolled from the game's reset,
    ``|s - s_ref| / |s_ref|`` over all of them; ``actor_prio_gap``, the
    acting priorities (1-step TDs in the value-rescaled space, mixed over
    each loss region) against float32 Q-values, likewise;
    ``actor_action_gap``, the widest gap by which a greedy action lies
    below its step's best float32 Q-value.  Where the control (or
    ``half_batch``) is asked for, the control acts, prices and carries in
    float8 in the program's place, and ``lstm_bf16`` with its recurrence
    in bfloat16 (its trunk and heads reading bfloat16, as configured);
    ``zero_state`` reads the stored states as zeros (1 by construction:
    the state lost on its way to the burn-in)."""
    net.tf32_off()
    grid, pixels, balls = rec["catch"]
    env = Catch(grid=grid, pixels=pixels, balls=balls)
    b_per, n_slots = rec["n_envs"], rec["n_actors"] * rec["n_envs"]
    eps = epsilons(n_slots, rec["eps_base"], rec["eps_alpha"])
    lanes = [Lane(env, slot_seed(rec["env_seed"], s)) for s in range(n_slots)]
    bad, checked = 0, []
    first = rec["first_version"]
    for payload, prios, actor, pv in rec["messages"]:
        for seq in _sequences(payload, prios):
            own = got = None
            if actor is not None:
                for s in range(actor * b_per, (actor + 1) * b_per):
                    got = _check(lanes[s], seq, rec)
                    if got is not None:
                        own = s
                        break
            if own is None:
                bad += int(seq["action"].shape[0])
                continue
            lane = lanes[own]
            n_bad, real = got
            bad += n_bad
            known = len(lane.games[lane.game][1])
            if lane.start + real > known:
                lane.game_after([int(a) for a in
                                 seq["action"][known - lane.start:real]],
                                commit=True)
            if pv == first:
                checked.append((own, lane.game, lane.start, real, seq))
            lane.advance(rec)
    n_actions = init["advantage_out.weight"].shape[0]
    # the steps of each checked game acted under the first weights: up to
    # the end of its last sequence sent under them
    under = {}
    for s, game, st, real, _ in checked:
        under[(s, game)] = max(under.get((s, game), 0), st + real)
    greedy = []
    for a in range(rec["n_actors"]):
        slots = list(range(a * b_per, (a + 1) * b_per))
        n_steps = max(lanes[s].total_steps for s in slots)
        rand_a, explore = worker_draws(
            slot_seed(rec["env_seed"], a * b_per), b_per, n_steps,
            eps[slots], n_actions)
        for j, s in enumerate(slots):
            g0 = 0
            for game, (_, steps) in enumerate(lanes[s].games):
                for k, (act, _, _) in enumerate(steps):
                    v = g0 + k
                    if explore[v, j]:
                        bad += int(act != rand_a[v, j])
                    elif k < under.get((s, game), 0):
                        greedy.append((s, game, k))
                g0 += len(steps)
    params = {k: v.to(device=device, dtype=torch.float32)
              for k, v in init.items()}
    keys = sorted(under)
    ref = _unroll(params, lanes, keys, device, None, torch.float32)
    names = [n for n in ("program",) if n in variants]
    planted = bool({"control", "half_batch"} & set(variants))
    if planted:
        names += ["control", "lstm_bf16"]
    out = {}
    if planted and checked:
        # the stored state lost between the actor's carry and the burn-in
        out["zero_state"] = {"actor_state_gap": _rms(
            [(torch.zeros_like(want), want) for want in
             (torch.cat([ref[(s, g)][1][st], ref[(s, g)][2][st]]).double()
              .cpu() for s, g, st, _, _ in checked)])}
    for name in names:
        alt = None
        if name != "program":
            alt = _unroll(params, lanes, keys, device,
                          fp8_quant if name == "control" else bf16_quant,
                          torch.bfloat16 if name == "lstm_bf16"
                          else torch.float32)
        out[name] = _gaps(ref, alt, lanes, checked, greedy, rec)
    if "program" in out:
        out["program"]["actor_mismatch"] = bad
    return out


def _unroll(params, lanes, keys, device, quant, lstm_dtype):
    """``{(slot, game): (q [n+1, A], c [n+1, H], h [n+1, H])}``: the
    reference net over each game's frames from its reset with a zero
    carry, the previous action and reward fed; row ``t`` of the carries
    is the carry before step ``t``."""
    out = {}
    with torch.no_grad():
        for s, game in keys:
            frames, steps = lanes[s].games[game]
            x = torch.as_tensor(np.stack(frames)).to(device)
            x = x.reshape((1, len(frames)) + tuple(x.shape[1:]))
            if x.dim() == 4:
                x = x[..., None]
            prev_a = torch.tensor([[0] + [st[0] for st in steps]],
                                  device=device)[:, :x.shape[1]]
            prev_r = torch.tensor([[0.0] + [float(st[1]) for st in steps]],
                                  device=device)[:, :x.shape[1]]
            h_dim = params["lstm.weight_hh"].shape[1]
            carry = (torch.zeros(1, h_dim, device=device),
                     torch.zeros(1, h_dim, device=device))
            feats = net.trunk(params, x[0], quant)[None]
            n_actions = params["advantage_out.weight"].shape[0]
            onehot = torch.nn.functional.one_hot(prev_a, n_actions).float()
            feats = torch.cat([feats, onehot, prev_r[..., None]], -1)
            cs, hs = [carry[0][0]], [carry[1][0]]
            w_ih = params["lstm.weight_ih"].to(lstm_dtype)
            w_hh = params["lstm.weight_hh"].to(lstm_dtype)
            b = params["lstm.bias_hh"].to(lstm_dtype)
            c, h = (t.to(lstm_dtype) for t in carry)
            seq = []
            for t in range(feats.shape[1]):
                gates = feats[:, t].to(lstm_dtype) @ w_ih.T + h @ w_hh.T + b
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                seq.append(h.float())
                cs.append(c[0].float())
                hs.append(h[0].float())
            q = net.heads(params, torch.cat(seq), quant)
            out[(s, game)] = (q, torch.stack(cs), torch.stack(hs))
    return out


def _rms(pairs) -> float:
    num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    den = sum(float((b ** 2).sum()) for _, b in pairs)
    return (num / den) ** 0.5 if den > 0 else float("nan")


def _gaps(ref: dict, alt: dict | None, lanes, checked, greedy,
          rec: dict) -> dict:
    """The three gaps against the float32 reference's unroll ``ref``: of
    what was shipped, or, given the unroll ``alt`` of a variant, of that
    variant acting, pricing and carrying in the program's place."""
    if not checked:
        nan = float("nan")
        return dict(actor_state_gap=nan, actor_prio_gap=nan,
                    actor_action_gap=nan)
    state_pairs, prio_pairs = [], []
    for s, game, st, real, seq in checked:
        q_ref, c_ref, h_ref = ref[(s, game)]
        want = torch.cat([c_ref[st], h_ref[st]]).double().cpu()
        steps = lanes[s].games[game][1]
        if alt is None:
            got = torch.from_numpy(np.concatenate(
                [seq["state_c"], seq["state_h"]])).double()
            p_got = seq["priority"]
        else:
            q_alt, c_alt, h_alt = alt[(s, game)]
            got = torch.cat([c_alt[st], h_alt[st]]).double().cpu()
            p_got = _priority(q_alt, steps, st, real, rec)
        state_pairs.append((got, want))
        prio_pairs.append((torch.tensor(p_got, dtype=torch.float64),
                           torch.tensor(_priority(q_ref, steps, st, real,
                                                  rec),
                                        dtype=torch.float64)))
    gap = 0.0
    for s, game, k in greedy:
        q = ref[(s, game)][0][k]
        a = (lanes[s].games[game][1][k][0] if alt is None
             else int(alt[(s, game)][0][k].argmax()))
        gap = max(gap, float(q.max() - q[a]))
    return dict(actor_state_gap=_rms(state_pairs),
                actor_prio_gap=_rms(prio_pairs), actor_action_gap=gap)


def _priority(q, steps, st: int, real: int, rec: dict) -> float:
    """The acting priority of the sequence at ``st`` of a game with
    Q-values ``q [n+1, A]``: 1-step TDs ``|h(r + disc h^-1(max q')) -
    q[a]|`` (0 past the game's end), mixed over the loss region."""
    n = len(steps)
    maxq = torch.cat([q[1:n].max(dim=1).values.float().cpu(),
                      torch.zeros(1)])
    r = torch.tensor([float(x[1]) for x in steps])
    d = torch.tensor([0.0 if x[2] else rec["gamma"] for x in steps])
    a = torch.tensor([x[0] for x in steps])
    eps = rec["rescale_eps"]
    if eps is None:
        target = r + d * maxq
    else:
        target = net.value_rescale(
            r + d * net.inverse_value_rescale(maxq, eps), eps)
    taken = q[:n].float().cpu().gather(1, a[:, None])[:, 0]
    td = (target - taken).abs()
    lo = st + rec["burn_in"]
    part = td[lo:min(lo + rec["unroll"], st + real)]
    return float(0.9 * part.max() + 0.1 * part.sum() / len(part) + 1e-6)
