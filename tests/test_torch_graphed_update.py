"""The DQN learner's update as one CUDA graph (``LearnerCore.
update_from_batch``), what of it the CPU can hold.

The graph itself is captured and replayed on the card only
(``chip_smoke.py`` phase 3b holds it bit for bit against the eager
update); here: the CPU and a dp group stay on the eager update, unchanged
and counted; the learning rate as a 0-d tensor against ``apex_tpu``'s
optax chain across a staircase boundary; the graph key following the
batch's layout and the storage of the state, not the batch's data; and
the static batch keeping ``obs``/``next_obs`` as views of ``obs_pair``.
"""

import copy
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.ops import losses as jl
from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.ops.losses import double_dqn_loss, make_optimizer
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.training import learner
from apex_tpu_torch.training.learner import (GRAPH_COUNTS, LearnerCore,
                                             graph_engages, graph_key,
                                             static_batch, td_update)
from apex_tpu_torch.training.state import create_train_state

B = 8


def _batch(seed: int, b: int = B) -> tuple[dict, torch.Tensor]:
    """A frame-pool-shaped batch: obs and next_obs the halves of
    ``obs_pair``."""
    rng = np.random.default_rng(seed)
    pair = torch.from_numpy(rng.integers(0, 255, (2 * b, 36, 36, 2),
                                         dtype=np.uint8))
    batch = dict(obs=pair[:b],
                 action=torch.from_numpy(rng.integers(0, 3, b)
                                         .astype(np.int32)),
                 reward=torch.from_numpy(rng.normal(size=b)
                                         .astype(np.float32)),
                 next_obs=pair[b:],
                 discount=torch.full((b,), 0.97),
                 obs_pair=pair)
    weights = torch.from_numpy(rng.uniform(0.2, 1.0, b).astype(np.float32))
    return batch, weights


def _learner(interval: int = 2):
    opt = make_optimizer(lr=1e-2, lr_decay_steps=2, lr_decay_rate=0.5)
    core = LearnerCore(replay=DeviceReplay(capacity=16), optimizer=opt,
                       batch_size=B, target_update_interval=interval)
    model = DuelingDQN(3, (36, 36, 2), compute_dtype=torch.float32,
                       trunk_features=(4, 4, 4), head_width=8,
                       generator=torch.Generator().manual_seed(0))
    return core, create_train_state(model, opt)


def _tensors(ts) -> list:
    return [*ts.params.parameters(), *ts.target_params.parameters(),
            *ts.opt_state.mu, *ts.opt_state.nu, ts.opt_state.lr_held[1]]


class _OneRank:
    """A dp group of one rank: the mean over it leaves every tensor as
    it is."""

    def all_reduce_mean_(self, tensors):
        pass


@pytest.mark.parametrize("group", [None, _OneRank()],
                         ids=["no_group", "dp_group"])
def test_the_cpu_update_stays_eager_and_equals_td_update(group):
    """Three updates on CPU tensors, with and without a dp group: every
    one eager and counted so, bit-equal to ``td_update`` (weights, target,
    moments, learning rate, priorities, metrics), with no graph key kept;
    the rate halved at count 2."""
    core, ts = _learner()
    ref = copy.deepcopy(ts)
    before = dict(GRAPH_COUNTS)
    for seed in range(3):
        batch, weights = _batch(seed)
        _, prios, metrics = core.update_from_batch(ts, batch, weights,
                                                   group=group)

        def loss_fn():
            return double_dqn_loss(ref.params, ref.target_params, batch,
                                   weights)

        _, want_prios, want = td_update(core.optimizer,
                                        core.target_update_interval, ref,
                                        loss_fn, group)
        assert torch.equal(prios, want_prios)
        assert metrics.keys() == want.keys() == set(learner.METRICS)
        assert all(torch.equal(metrics[k], want[k]) for k in want)
    assert {k: GRAPH_COUNTS[k] - before[k] for k in GRAPH_COUNTS} == {
        "capture": 0, "replay": 0, "eager": 3}
    assert core._graph == {}
    assert ts.step == ts.opt_state.count == ref.step == 3
    assert all(torch.equal(a, b) for a, b in zip(_tensors(ts), _tensors(ref)))
    assert ts.opt_state.lr_held[1].item() == pytest.approx(1e-2 * 0.5)


def test_the_graph_engages_on_cuda_parameters_without_a_group():
    def state(cuda: bool):
        param = SimpleNamespace(is_cuda=cuda)
        return SimpleNamespace(params=SimpleNamespace(
            parameters=lambda: iter([param])))

    assert graph_engages(state(True), None)
    assert not graph_engages(state(True), _OneRank())
    assert not graph_engages(state(False), None)
    assert not graph_engages(state(False), _OneRank())


def _set_count(opt_state, count: int):
    """optax's chain state with every schedule count set to ``count``."""
    if hasattr(opt_state, "_fields"):
        fields = {f: _set_count(getattr(opt_state, f), count)
                  for f in opt_state._fields}
        if "count" in fields:
            fields["count"] = jnp.asarray(count, jnp.int32)
        return type(opt_state)(**fields)
    if isinstance(opt_state, tuple):
        return tuple(_set_count(s, count) for s in opt_state)
    return opt_state


@pytest.mark.parametrize("centered", [True, False])
def test_the_tensor_learning_rate_crosses_a_staircase_boundary_as_optax(
        centered):
    """``ClipRMSprop`` with the rate as a 0-d tensor against
    ``apex_tpu``'s ``make_optimizer`` from count 998 to 1001 (the stage
    changes at 1000; norms above and below ``max_grad_norm``): weights
    within the optax test's rtol 1e-6; the held rate written once, at the
    boundary, to the rate of the new stage."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(lr=1e-2, decay=0.95, eps=1.5e-7, centered=centered,
              max_grad_norm=2.0, lr_decay_steps=1000, lr_decay_rate=0.5)
    jopt = jl.make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = _set_count(jopt.init(jparams), 998)
    topt = make_optimizer(**kw)
    tparams = [torch.tensor(init[k]) for k in shapes]
    tstate = topt.init(tparams)
    tstate.count = 998
    held = []
    for scale in (0.1, 3.0, 0.5, 10.0):
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v)
                                       for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        count = tstate.count
        topt.step(tparams, [torch.tensor(grads[k]) for k in shapes], tstate)
        held.append((count, tstate.lr_held[1].data_ptr(),
                     tstate.lr_held[1].item()))
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    assert tstate.count == 1002
    lr0, lr1 = (float(np.float32(1e-2 * 0.5 ** k)) for k in (0, 1))
    at = held[0][1]
    assert held == [(998, at, lr0), (999, at, lr0), (1000, at, lr1),
                    (1001, at, lr1)]


def test_the_held_rate_keeps_its_storage_and_follows_count_and_base_rate():
    """A restored count and a swapped base rate (population training's
    live ``lr``, ``ConcurrentTrainer.apply_hparams``) each rewrite the
    held rate in place."""
    opt = make_optimizer(lr=1.0, lr_decay_steps=10, lr_decay_rate=0.5)
    state = opt.init([torch.zeros(3)])
    lr = opt.lr_tensor(state, torch.device("cpu"))
    assert lr.dim() == 0 and lr.dtype == torch.float32 and lr.item() == 1.0
    state.count = 25                         # as a checkpoint restores it
    assert opt.lr_tensor(state, torch.device("cpu")) is lr
    assert lr.item() == 0.25
    swapped = dataclasses.replace(opt, lr=0.5)
    assert swapped.lr_tensor(state, torch.device("cpu")) is lr
    assert lr.item() == 0.125


def test_the_graph_key_follows_layout_and_storage_not_batch_data():
    core, ts = _learner()
    batch, weights = _batch(0)
    core.optimizer.lr_tensor(ts.opt_state, torch.device("cpu"))
    key = graph_key(ts, batch, weights)
    assert graph_key(ts, *_batch(1)) == key          # new data, same layout
    assert graph_key(ts, *_batch(1, b=B // 2)) != key  # another shape
    split = dict(batch, obs=batch["obs"].clone(),
                 next_obs=batch["next_obs"].clone())
    assert graph_key(ts, split, weights) != key      # no longer views
    cast = dict(batch, reward=batch["reward"].double())
    assert graph_key(ts, cast, weights) != key       # another dtype
    for tensors in (lambda: ts.params.parameters(),
                    lambda: ts.target_params.parameters(),
                    lambda: ts.opt_state.mu, lambda: ts.opt_state.nu):
        leaf = next(iter(tensors()))
        old = leaf.data
        leaf.data = old.clone()                      # rebound storage
        assert graph_key(ts, batch, weights) != key
        leaf.data = old
        assert graph_key(ts, batch, weights) == key
    ts.opt_state.lr_held = (0, ts.opt_state.lr_held[1].clone())
    assert graph_key(ts, batch, weights) != key


def test_the_static_batch_keeps_the_halves_as_views_of_its_pair():
    batch, _ = _batch(0)
    inputs, static = static_batch(batch)
    assert sorted(inputs) == ["action", "discount", "obs_pair", "reward"]
    assert list(static) == list(batch)
    for name, t in batch.items():
        assert torch.equal(static[name], t)
        assert static[name].data_ptr() != t.data_ptr()
    other, _ = _batch(1)
    for name, t in inputs.items():
        t.copy_(other[name])
    assert all(torch.equal(static[name], other[name]) for name in batch)
    assert static["next_obs"].data_ptr() == (
        inputs["obs_pair"].data_ptr() + batch["next_obs"].storage_offset())
