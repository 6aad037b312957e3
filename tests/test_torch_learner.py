"""Port of the learner step against ``apex_tpu``'s ``LearnerCore`` over the
frame-pool replay, plus the port's Ape-X consume path.

Both learners start from the same weights (carried from flax), ingest the
same chunks and sample with the same uniforms, at f32.  Tolerances: the
networks agree to f32 round-off (loss and metrics rtol 1e-5, the
gradient norm rtol 1e-4); the trees hold ``priority ** alpha`` from
those losses (rtol 1e-5); three RMSprop updates keep the weights within
atol 1e-6 of each other.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
from apex_tpu.ops.losses import make_optimizer as jax_make_optimizer
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.replay.frame_pool import FramePoolReplay as JaxPool
from apex_tpu.training.learner import LearnerCore as JaxCore
from apex_tpu.training.state import create_train_state as jax_train_state
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig)
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.ops.gather import LAUNCH_COUNTS
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.apex import ApexTrainer, dqn_env_specs
from apex_tpu_torch.training.learner import LearnerCore
from apex_tpu_torch.training.state import create_train_state

SHAPE, S, B = (42, 42, 1), 4, 16


def _chunks(seed, n):
    rng = np.random.default_rng(seed)
    b = JaxBuilder(3, 0.99, S, SHAPE, chunk_transitions=24)
    out = []
    while len(out) < n:
        b.begin_episode(rng.integers(0, 255, SHAPE).astype(np.uint8))
        for t in range(30):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, SHAPE).astype(np.uint8),
                       t == 29, False)
        out.extend(b.poll())
    return out[:n]


def _port_core(opt_kw, interval=2):
    pool = FramePoolReplay(capacity=128, frame_shape=SHAPE, frame_stack=S)
    return LearnerCore(replay=pool, optimizer=make_optimizer(**opt_kw),
                       batch_size=B, target_update_interval=interval)


def test_three_fused_steps_match_jax_learner_core():
    opt_kw = dict(lr=1e-3, lr_decay_steps=2, lr_decay_rate=0.5)
    jpool = JaxPool(capacity=128, frame_shape=SHAPE, frame_stack=S)
    flax_model = FlaxDQN(num_actions=3, compute_dtype=jnp.float32)
    jopt = jax_make_optimizer(**opt_kw)
    jts = jax_train_state(flax_model, jopt, jax.random.key(0),
                          jnp.zeros((1, 42, 42, S), jnp.uint8))
    jcore = JaxCore(apply_fn=flax_model.apply, replay=jpool, optimizer=jopt,
                    batch_size=B, target_update_interval=2)
    jrs = jpool.init()

    core = _port_core(opt_kw)
    model = DuelingDQN(3, (42, 42, S), compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(jax.device_get(jts.params)))
    ts = create_train_state(model, core.optimizer)
    rs = core.replay.init("cpu")

    chunks = _chunks(0, 5)
    ingest = jcore.jit_ingest()
    for chunk in chunks[:2]:
        prios = chunk.pop("priorities")
        jrs = ingest(jrs, chunk, jnp.asarray(prios))
        core.ingest(rs, chunk, prios)

    fused = jcore.jit_fused_step()
    keys = jax.random.split(jax.random.key(11), 3)
    for i, chunk in enumerate(chunks[2:]):
        prios = chunk.pop("priorities")
        offsets = np.array(jax.random.uniform(keys[i], (B,), jnp.float32))
        jts, jrs, jm = fused(jts, jrs, chunk, jnp.asarray(prios), keys[i],
                             jnp.float32(0.4))
        ts, rs, m = core.fused_step(ts, rs, chunk, prios,
                                    torch.from_numpy(offsets), 0.4)
        assert ts.step == int(jts.step) == i + 1
        for name in ("loss", "q_mean", "td_mean"):
            np.testing.assert_allclose(m[name].item(), float(jm[name]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(rs.sum_tree.numpy(),
                                   np.asarray(jrs.sum_tree), rtol=1e-5)
        assert (rs.pos, rs.size) == (int(jrs.pos), int(jrs.size))

    want = params_from_flax(jax.device_get(jts.params))
    want_target = params_from_flax(jax.device_get(jts.target_params))
    for name, p in ts.params.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    for name, p in ts.target_params.state_dict().items():       # synced at 2
        np.testing.assert_allclose(p.numpy(), want_target[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_target_syncs_on_the_interval():
    core = _port_core(dict(lr=1e-3), interval=2)
    ts = create_train_state(
        DuelingDQN(3, (42, 42, S), generator=torch.Generator().manual_seed(0)),
        core.optimizer)
    rs = core.replay.init("cpu")
    gen = torch.Generator().manual_seed(0)
    for step, chunk in enumerate(_chunks(1, 4), start=1):
        prios = chunk.pop("priorities")
        core.fused_step(ts, rs, chunk, prios, torch.rand(B, generator=gen), 0.4)
        same = all(torch.equal(a, b) for a, b in
                   zip(ts.params.parameters(), ts.target_params.parameters()))
        assert same == (step % 2 == 0), step


def test_fused_multi_step_equals_sequential_fused_steps():
    core = _port_core(dict(lr=1e-3))
    ts_a = create_train_state(
        DuelingDQN(3, (42, 42, S), generator=torch.Generator().manual_seed(1)),
        core.optimizer)
    rs_a = core.replay.init("cpu")
    chunks = _chunks(2, 4)
    prios = [c.pop("priorities") for c in chunks]
    core.ingest(rs_a, chunks[0], prios[0])
    ts_b, rs_b = copy.deepcopy(ts_a), copy.deepcopy(rs_a)
    offsets = torch.rand(3, B, generator=torch.Generator().manual_seed(2))
    betas = [0.4, 0.5, 0.6]
    for i in range(3):
        core.fused_step(ts_a, rs_a, chunks[i + 1], prios[i + 1], offsets[i],
                        betas[i])
    _, _, stacked = core.fused_multi_step(ts_b, rs_b, chunks[1:], prios[1:],
                                          offsets, betas)
    assert stacked["loss"].shape == (3,)
    assert torch.equal(rs_a.sum_tree, rs_b.sum_tree)
    assert torch.equal(rs_a.frames, rs_b.frames)
    for a, b in zip(ts_a.params.parameters(), ts_b.params.parameters()):
        assert torch.equal(a, b)


def _small_cfg():
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatchSmall-v0", seed=5),
        replay=ReplayConfig(capacity=256, warmup=48),
        learner=LearnerConfig(batch_size=B, target_update_interval=3,
                              compute_dtype="float32"),
        actor=ActorConfig(send_interval=24))


def test_env_specs_match_jax_driver():
    from apex_tpu.config import ApexConfig as JaxApexConfig
    from apex_tpu.config import EnvConfig as JaxEnvConfig
    from apex_tpu.training.apex import dqn_env_specs as jax_specs

    for env_id in ("ApexCatch-v0", "ApexCatchSmall-v0"):
        jcfg = JaxApexConfig(env=JaxEnvConfig(env_id=env_id))
        cfg = ApexConfig(env=EnvConfig(env_id=env_id))
        jspec, jshape, jdtype, jstack = jax_specs(jcfg)
        spec, shape, dtype, stack = dqn_env_specs(cfg)
        assert (shape, np.dtype(dtype), stack) == (jshape, np.dtype(jdtype),
                                                   jstack)
        assert spec["num_actions"] == jspec["num_actions"]
        assert spec["obs_is_image"] == jspec["obs_is_image"]
        assert spec["scale_uint8"] == jspec["scale_uint8"]
        assert spec["compute_dtype"] == torch.bfloat16
        assert spec["obs_shape"] == shape[:-1] + (stack * shape[-1],)


def _messages(trainer, n, seed=0):
    from apex_tpu_torch.envs.registry import make_env

    env = make_env(trainer.cfg.env.env_id, trainer.cfg.env, seed=seed)
    b = FrameChunkBuilder(3, 0.99, S, trainer.replay.frame_shape,
                          chunk_transitions=trainer.cfg.actor.send_interval)
    b.begin_episode(env.reset()[0])
    gen = torch.Generator().manual_seed(seed)
    msgs = []
    while len(msgs) < n:
        a, q = trainer.policy(torch.from_numpy(b.current_stack()[None]), 0.5,
                              gen)
        frame, r, term, trunc, _ = env.step(int(a[0]))
        b.add_step(int(a[0]), r, q[0].numpy(), frame, term, trunc)
        if term or trunc:
            b.begin_episode(env.reset()[0])
        msgs.extend(drain_builder_chunks(b))
    return msgs[:n]


def test_apex_trainer_consume_ingests_until_warm_then_trains():
    trainer = ApexTrainer(_small_cfg(), device="cpu")
    msgs = _messages(trainer, 6)
    LAUNCH_COUNTS["gather_rows"] = 0
    for i, msg in enumerate(msgs):
        metrics = trainer.consume([msg])
        warm_before = 24 * i >= trainer.cfg.replay.warmup
        assert (metrics is not None) == warm_before, i
    assert trainer.ingested == 6 * 24 and trainer.replay_state.size == 144
    assert trainer.steps == trainer.train_state.step == 4
    assert np.isfinite(metrics["loss"].item())
    assert LAUNCH_COUNTS["gather_rows"] == 0       # CPU: the plain version
    assert 0.4 < trainer._beta() < 1.0


def test_apex_trainer_train_ratio_caps_steps():
    """train_ratio 0.25 at batch 16: the step budget is ingested / 64
    transitions, checked before each chunk (the replay-ratio cap of
    ``_drain_serial``).  Warm from 48: chunks 3, 4 and 7 train (budgets
    0.75, 1.125, 2.25), the others only ingest."""
    trainer = ApexTrainer(_small_cfg(), train_ratio=0.25, device="cpu")
    msgs = _messages(trainer, 8, seed=1)
    trained = [trainer.consume([msg]) is not None for msg in msgs]
    assert trained == [False, False, True, True, False, False, True, False]
    assert trainer.steps == trainer.train_state.step == 3


def test_apex_trainer_refuses_an_oversized_replay():
    cfg = _small_cfg()
    cfg = cfg.replace(replay=ReplayConfig(capacity=2 ** 20,
                                          hbm_budget_gb=0.5))
    with pytest.raises(ValueError, match="budget"):
        ApexTrainer(cfg, device="cpu")
