"""A run with its timed path broken underneath comes out not correct.

Each case drives the harness's run on the CPU at a small size (the look
for a card is the command's, not the run's) with one fault planted in the
program, and judges it with the cell's own limits: a learner step that
leaves the weights and optimizer state unchanged; half of every batch
left out of the loss, the mean taken over the rest; one sampled frame
altered where the replay produces it; a reward altered where the actors
produce it (as the learner receives their messages, the actors being
processes of their own) or where the card's env produces it; actions
taken on negated Q-values on the card.  One chip has no exchange between
chips to leave out.
"""

import copy

import numpy as np
import pytest
import torch

from portbench import check, harness, spec

CELLS = ("apex-dqn.host-actors", "apex-dqn.anakin")


def small_cell(name: str) -> spec.Cell:
    """The cell at a size a test run holds: two actor processes of 2
    envs or 4 lanes, small replay and batch, every width as configured."""
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    s = c.config["settings"]
    s["replay"].update(capacity=2 ** 12, warmup=256)
    s["learner"].update(batch_size=16)
    if c.traffic["pool"] == "anakin":
        c.traffic = dict(c.traffic, n_envs=4, rollout_len=32,
                         open_after_steps=4)
    else:
        settings = copy.deepcopy(c.traffic["settings"])
        settings["actor"].update(n_actors=2, n_envs_per_actor=2)
        c.traffic = dict(c.traffic, settings=settings, open_after_steps=4)
    return c


def unchanged_state(trainer):
    opt = trainer.core.optimizer

    def step(params, grads, state):
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))

    object.__setattr__(opt, "step", step)


def half_batch(monkeypatch):
    import apex_tpu_torch.training.learner as learner

    def halved(loss_fn):
        def loss(online, target, batch, weights, **kw):
            w = weights.clone()
            half = w.shape[0] // 2
            w[half:] = 0.0
            w[:half] *= 2.0
            return loss_fn(online, target, batch, w, **kw)
        return loss

    monkeypatch.setattr(learner, "double_dqn_loss",
                        halved(learner.double_dqn_loss))
    return None


def altered_frame(trainer):
    replay = trainer.replay
    sample = replay.sample

    def wrong(state, offsets, beta, group=None):
        batch, weights, idx = sample(state, offsets, beta, group)
        obs = batch.get("obs_pair", batch["obs"])
        obs.view(-1)[0] ^= 1
        return batch, weights, idx

    object.__setattr__(replay, "sample", wrong)


def altered_reward(trainer):
    env = trainer.pool.engine.env
    step = env.step

    def wrong(state, action, draws):
        state, obs, reward, done, final = step(state, action, draws)
        return state, obs, reward + (reward != 0).float() * 0.5, done, final

    env.step = wrong


def altered_actor_reward(trainer):
    pool = trainer.pool
    poll = pool.poll_chunks

    def wrong(max_chunks, timeout=0.0):
        msgs = poll(max_chunks, timeout=timeout)
        for m in msgs:
            reward = np.array(m["payload"]["reward"])
            reward[0] += 0.5
            m["payload"]["reward"] = reward
        return msgs

    object.__setattr__(pool, "poll_chunks", wrong)


def negated_policy(trainer):
    engine = trainer.pool.engine
    model = engine.model
    forward = model.forward
    model.forward = lambda x: -forward(x)


def _run(name, plant):
    cell = small_cell(name)
    out = harness.run_cell(cell, 20261018, 1.0, False, device="cpu",
                           plant=plant)
    return check.verdict(out["numbers"]["program"], cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_matches_exactly(name):
    """At this size the gaps' limits, set on the card at the cell's size,
    do not apply; what is exact must be."""
    _, shown = _run(name, None)
    for key, v in shown.items():
        if v["limit"] == 0:
            assert v["value"] == 0, (key, shown)
    assert all(v["value"] == v["value"] for v in shown.values())


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_changes_nothing_is_caught(name):
    correct, shown = _run(name, unchanged_state)
    assert not correct
    assert shown["update_gap"]["value"] > shown["update_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_half_a_batch_is_caught(name, monkeypatch):
    half_batch(monkeypatch)
    correct, shown = _run(name, None)
    assert not correct, shown


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_frame_is_caught(name):
    correct, shown = _run(name, altered_frame)
    assert not correct
    assert shown["batch_mismatch"]["value"] > 0


def test_an_altered_reward_is_caught():
    correct, shown = _run("apex-dqn.anakin", altered_reward)
    assert not correct
    assert shown["rollout_mismatch"]["value"] > 0


def test_an_altered_actor_reward_is_caught():
    correct, shown = _run("apex-dqn.host-actors", altered_actor_reward)
    assert not correct
    assert shown["actor_mismatch"]["value"] > 0


def test_acting_against_the_policy_is_caught():
    correct, shown = _run("apex-dqn.anakin", negated_policy)
    assert not correct
    assert shown["action_gap"]["value"] > shown["action_gap"]["limit"]
