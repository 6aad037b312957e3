"""A run of the recurrent cell with its timed path broken underneath comes
out not correct.

Each case drives the harness's run on the CPU at a small size (LSTM and
heads of 32, burn-in 4 + unroll 8 + n 2, batch 8, two actor processes of
two envs of 7x7 Catch; every setting of the recipe as configured) with
one fault planted in the program, and judges it with the cell's own
limits: a learner step that changes nothing; a sampled frame altered; a
reward altered where the actors produce it; the stored states zeroed
where the replay hands them to the burn-in; targets without the value
rescaling; the previous action and reward left out of the learner's
LSTM input.  Then the readings that set the limits: the fp8 control and
the four faults of the reference (``zero_state``, ``no_rescale``,
``no_prev``, ``lstm_bf16``), each read against the float32 reference,
fail the cell's limits too.
"""

import copy

import numpy as np
import pytest
import torch

from portbench import check, harness, spec

CELL = "r2d2.host-actors"


def small_cell() -> spec.Cell:
    c = spec.cell(CELL)
    c.config = copy.deepcopy(c.config)
    s = c.config["settings"]
    s["env"]["env_id"] = "ApexCatchSmall-v0"
    s["replay"].update(capacity=2 ** 10, warmup=256)
    s["learner"].update(batch_size=8, n_steps=2)
    s["r2d2"].update(burn_in=4, unroll=8, stride=4, lstm_features=32,
                     head_width=32)
    c.config["shapes"].update(frame=[42, 42, 1], lstm_features=32,
                              head_width=32)
    settings = copy.deepcopy(c.traffic["settings"])
    settings["actor"].update(n_actors=2, n_envs_per_actor=2)
    c.traffic = dict(c.traffic, settings=settings, open_after_steps=4)
    return c


def _run(plant=None, variants=("program",)):
    cell = small_cell()
    out = harness.run_cell(cell, 20261018, 1.0, False, device="cpu",
                           plant=plant, variants=variants)
    return cell, out["numbers"]


def _verdict(plant=None):
    cell, numbers = _run(plant)
    return check.verdict(numbers["program"], cell.limits)


def unchanged_state(trainer):
    opt = trainer.core.optimizer

    def step(params, grads, state):
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))

    object.__setattr__(opt, "step", step)


def _wrap_sample(trainer, edit):
    replay = trainer.replay
    sample = replay.sample

    def wrong(state, offsets, beta, group=None):
        batch, weights, idx = sample(state, offsets, beta, group)
        edit(batch)
        return batch, weights, idx

    object.__setattr__(replay, "sample", wrong)


def altered_frame(trainer):
    def edit(batch):
        batch["obs"].view(-1)[0] ^= 1
    _wrap_sample(trainer, edit)


def zeroed_state(trainer):
    def edit(batch):
        batch["state_c"].zero_()
        batch["state_h"].zero_()
    _wrap_sample(trainer, edit)


def altered_actor_reward(trainer):
    pool = trainer.pool
    poll = pool.poll_chunks

    def wrong(max_chunks, timeout=0.0):
        msgs = poll(max_chunks, timeout=timeout)
        for m in msgs:
            reward = np.array(m["payload"]["reward"])
            reward[0, 0] += 0.5
            m["payload"]["reward"] = reward
        return msgs

    object.__setattr__(pool, "poll_chunks", wrong)


def no_rescaling(trainer):
    object.__setattr__(trainer.core, "rescale_eps", None)


def test_a_sound_run_matches_exactly():
    """At this size the gaps' limits, set on the card at the cell's size,
    do not apply; what is exact must be."""
    _, shown = _verdict()
    for key, v in shown.items():
        if v["limit"] == 0:
            assert v["value"] == 0, (key, shown)
    assert all(v["value"] == v["value"] for v in shown.values())


def test_a_step_that_changes_nothing_is_caught():
    correct, shown = _verdict(unchanged_state)
    assert not correct
    assert shown["update_gap"]["value"] > shown["update_gap"]["limit"]


def test_an_altered_frame_is_caught():
    correct, shown = _verdict(altered_frame)
    assert not correct
    assert shown["batch_mismatch"]["value"] > 0


def test_a_zeroed_stored_state_is_caught():
    correct, shown = _verdict(zeroed_state)
    assert not correct
    assert shown["batch_mismatch"]["value"] > 0


def test_an_altered_actor_reward_is_caught():
    correct, shown = _verdict(altered_actor_reward)
    assert not correct
    assert shown["actor_mismatch"]["value"] > 0


def test_targets_without_rescaling_are_caught():
    correct, shown = _verdict(no_rescaling)
    assert not correct
    assert shown["loss_gap"]["value"] > shown["loss_gap"]["limit"]


def test_the_previous_action_and_reward_left_out_are_caught(monkeypatch):
    import apex_tpu_torch.models.recurrent as recurrent
    inputs = recurrent.prev_inputs
    monkeypatch.setattr(recurrent, "prev_inputs",
                        lambda prev, n: torch.zeros_like(inputs(prev, n)))
    correct, shown = _verdict()
    assert not correct, shown


@pytest.fixture(scope="module")
def readings():
    return _run(variants=("program", "control"))


@pytest.mark.parametrize("variant", ["control", "zero_state", "no_rescale",
                                     "no_prev", "lstm_bf16"])
def test_the_control_and_the_faults_fail_the_limits(readings, variant):
    cell, numbers = readings
    limits = {k: v for k, v in cell.limits.items() if k in numbers[variant]}
    correct, shown = check.verdict(numbers[variant], limits)
    assert not correct, shown
