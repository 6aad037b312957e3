"""The on-device rollout engine as the cell's pool (``AnakinPool``).

The traffic gives the lanes (``n_envs``) and the steps a dispatch
(``rollout_len``).  While the first learner steps are captured, every
dispatch's actions, env draws, sealed chunk counts and messages are
recorded from the lanes' starting states on; the reference replays Catch
from those states with the engine's draws and actions and checks every
shipped transition and every action (:func:`judge`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.check import greedy_gap
from portbench.harness import host_copy
from portbench.reference.catch import Catch, lane_transitions
from portbench.reference.follow import tf32_off
from portbench.reference.nets import fp8_quant


def build(cfg, traffic: dict, device):
    from apex_tpu_torch.training.anakin import AnakinPool, make_anakin_engine
    engine = make_anakin_engine(cfg, rollout_len=traffic["rollout_len"],
                                device=device, n_envs=traffic["n_envs"])
    return AnakinPool(cfg, engine=engine, device=device)


def install(probe, traffic: dict) -> None:
    """Wrap the engine instance: its frame count after every dispatch
    (``probe.acting_ticks``), and while capturing, each dispatch's
    record."""
    engine = probe.trainer.pool.engine
    env_state = engine.carry.env
    rec_all = dict(
        start=[tuple(int(x[b]) for x in env_state) for b in range(engine.B)],
        dispatches=[], n=engine.n, gamma=probe.trainer.cfg.learner.gamma,
        lanes=engine.B, eps_base=probe.trainer.cfg.actor.eps_base,
        eps_alpha=probe.trainer.cfg.actor.eps_alpha)
    probe.pool_record = rec_all
    rollout, dispatch, env_step = (engine.rollout, engine.dispatch,
                                   engine.env.step)
    current: dict = {}

    def recorded_step(state, action, draws):
        rec = current.get("rec")
        if rec is not None:
            rec["actions"].append(action.detach().cpu().clone())
            rec["draws"].append({k: v.detach().cpu().clone()
                                 for k, v in draws.items()})
        return env_step(state, action, draws)

    def recorded_dispatch(model=None):
        if not probe.captured.is_set():
            current["rec"] = dict(actions=[], draws=[])
        out = dispatch(model)
        rec = current.pop("rec", None)
        if rec is not None:
            rec["sealed"] = out["sealed"].detach().cpu().clone()
            current["done"] = rec
        return out

    def counted_rollout():
        msgs, stats = rollout()
        rec = current.pop("done", None)
        if rec is not None:
            rec["msgs"] = [(host_copy(m["payload"]),
                            np.asarray(m["priorities"]).copy())
                           for m in msgs]
            rec_all["dispatches"].append(rec)
        probe.acting_ticks.append((time.perf_counter(), engine.frames))
        return msgs, stats

    engine.env.step = recorded_step
    engine.dispatch = recorded_dispatch
    engine.rollout = counted_rollout


def record(probe) -> dict:
    return probe.pool_record


def timers(pool, note) -> None:
    """``anakin.rollout``: the wall time of one engine dispatch,
    synchronised (traced runs only)."""
    engine = pool.engine
    rollout = engine.rollout

    def timed_rollout():
        t0 = time.perf_counter()
        got = rollout()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        note("anakin.rollout", t0)
        return got

    engine.rollout = timed_rollout


def _lane_messages(dispatch: dict, lanes: int) -> list[list]:
    """A dispatch's messages by lane: lane-major, ``sealed[b]`` each."""
    msgs, out, i = dispatch["msgs"], [], 0
    for b in range(lanes):
        k = int(dispatch["sealed"][b])
        out.append(msgs[i:i + k])
        i += k
    return out


def judge(rollout: dict, init: dict, device, variants) -> dict:
    """The rollout engine's first dispatches against Catch and the
    transition rules, driven by the engine's own draws and actions.
    ``rollout_mismatch`` counts the shipped transitions' elements that
    differ from the reference's and the exploring steps whose action is
    not the drawn one; ``action_gap`` is the widest gap by which a greedy
    step's action lies below the best Q-value of the reference net (the
    weights the engine acted with) on the reference's acting stack.  The
    control acts in the program's place: its own greedy choices are
    judged."""
    tf32_off()
    env = Catch()
    lanes, n, gamma = rollout["lanes"], rollout["n"], rollout["gamma"]
    i = np.arange(lanes, dtype=np.float64)
    eps = (rollout["eps_base"] ** (1.0 + i / max(lanes - 1, 1)
                                   * rollout["eps_alpha"])).astype(np.float32)
    bad, greedy_stacks, greedy_actions = 0, [], []
    for b in range(lanes):
        steps, explore_act = [], []
        for d in rollout["dispatches"]:
            for act, dr in zip(d["actions"], d["draws"]):
                steps.append((int(act[b]), int(dr["int"][b]),
                              int(dr["reset_int"][b])))
                explore_act.append((float(dr["explore"][b]) < eps[b],
                                    int(dr["action"][b])))
        ref, acting = lane_transitions(env, rollout["start"][b], steps, n,
                                       gamma)
        for (explore, drawn), (action, _, _), stack in zip(
                explore_act, steps, acting):
            if explore:
                bad += int(action != drawn)
            else:
                greedy_stacks.append(stack)
                greedy_actions.append(action)
        shipped = []
        for d in rollout["dispatches"]:
            for payload, _ in _lane_messages(d, lanes)[b]:
                frames = np.asarray(payload["frames"]).reshape(
                    -1, env.pixels, env.pixels)
                for t in range(int(payload["n_trans"])):
                    obs = frames[np.asarray(payload["obs_ref"][t])]
                    nxt = frames[np.asarray(payload["next_ref"][t])]
                    shipped.append((obs, int(payload["action"][t]),
                                    np.float32(payload["reward"][t]),
                                    np.float32(payload["discount"][t]), nxt))
        if len(shipped) > len(ref):
            bad += len(shipped) - len(ref)
        for got, want in zip(shipped, ref):
            bad += int((got[0] != want[0]).sum()) + int((got[4] != want[4])
                                                        .sum())
            bad += sum(int(g != w) for g, w in zip(got[1:4], want[1:4]))
    params = {k: v.to(device=device, dtype=torch.float32)
              for k, v in init.items()}
    out = {}
    for name in variants:
        if name not in ("program", "control"):
            continue
        quant = fp8_quant if name == "control" else None
        out[name] = {"action_gap": greedy_gap(params, greedy_stacks,
                                              greedy_actions, device, quant)}
    if "program" in out:
        out["program"]["rollout_mismatch"] = bad
    return out

