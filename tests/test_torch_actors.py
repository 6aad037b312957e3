"""The port's actor workers against ``apex_tpu.actors``.

* The epsilon ladder and the vector slot bands equal the JAX functions.
* The vector DQN family, at ``eps_base = 0`` (greedy, so no random draw
  decides an action), f32 compute and the same weights carried from flax,
  makes the same chunks as the JAX family over 100 vector steps on
  ``ApexCatchSmall-v0``: frames, refs, actions, rewards and discounts
  bit-equal; priorities, computed from each side's Q-values, within
  rtol 1e-5 / atol 1e-6 (f32 round-off of two conv stacks).
* ``double_buffer`` on and off are bit-identical per slot in the port
  with exploration on.
* The worker loops count the stats they drop on a full stat queue and
  emit ActorTimingStats.
"""

import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.actors.pool import actor_epsilons as jax_actor_epsilons
from apex_tpu.actors.vector import VectorDQNWorkerFamily as JaxVectorFamily
from apex_tpu.actors.vector import worker_slots as jax_worker_slots
from apex_tpu.config import ActorConfig as JaxActorConfig
from apex_tpu.config import ApexConfig as JaxApexConfig
from apex_tpu.config import EnvConfig as JaxEnvConfig
from apex_tpu.config import LearnerConfig as JaxLearnerConfig
from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
from apex_tpu.training.apex import dqn_env_specs as jax_env_specs
from apex_tpu_torch.actors.pool import (ActorTimingStat, DQNWorkerFamily,
                                        EpisodeStat, actor_epsilons,
                                        worker_loop)
from apex_tpu_torch.actors.vector import (VectorDQNWorkerFamily, step_seed,
                                          vector_worker_loop, worker_slots)
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig)
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.dueling import host_params, DuelingDQN
from apex_tpu_torch.training.apex import dqn_env_specs

ENV = "ApexCatchSmall-v0"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores: this
    file's torch ops take one thread each (single-threaded ops compute
    the same values)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(eps_base=0.0, n_actors=2, n_envs=4, **actor):
    actor = dict(n_actors=n_actors, n_envs_per_actor=n_envs,
                 send_interval=16, eps_base=eps_base, **actor)
    learner = dict(batch_size=16, compute_dtype="float32")
    jcfg = JaxApexConfig(env=JaxEnvConfig(env_id=ENV, seed=7),
                         learner=JaxLearnerConfig(**learner),
                         actor=JaxActorConfig(**actor))
    cfg = ApexConfig(env=EnvConfig(env_id=ENV, seed=7),
                     learner=LearnerConfig(**learner),
                     actor=ActorConfig(**actor))
    return jcfg, cfg


@pytest.mark.parametrize("n", [1, 2, 5, 32, 256])
@pytest.mark.parametrize("eps_base,eps_alpha", [(0.4, 7.0), (0.0, 7.0),
                                                (0.9, 3.0)])
def test_epsilon_ladder_equals_jax(n, eps_base, eps_alpha):
    np.testing.assert_array_equal(actor_epsilons(n, eps_base, eps_alpha),
                                  jax_actor_epsilons(n, eps_base, eps_alpha))


@pytest.mark.parametrize("n_actors,n_envs", [(1, 1), (2, 3), (4, 8),
                                             (8, 32)])
def test_worker_slots_equal_jax(n_actors, n_envs):
    jcfg, cfg = _cfgs(eps_base=0.4, n_actors=n_actors, n_envs=n_envs)
    for actor_id in range(n_actors):
        slots, seeds, eps = worker_slots(cfg, actor_id)
        jslots, jseeds, jeps = jax_worker_slots(jcfg, actor_id)
        assert slots == jslots and seeds == jseeds
        np.testing.assert_array_equal(eps, jeps)


def _flax_params(jcfg):
    spec, shape, dtype, stack = jax_env_specs(jcfg)
    model = FlaxDQN(**spec)
    stacked = shape[:-1] + (stack * shape[-1],)
    return model.init(jax.random.key(3), jnp.zeros((1,) + stacked, dtype))


def _drive_jax(jcfg, params, n_steps):
    spec = jax_env_specs(jcfg)[0]
    slots, seeds, eps = jax_worker_slots(jcfg, 0)
    fam = JaxVectorFamily(jcfg, spec, seeds=seeds, slot_ids=slots,
                          epsilons=eps, chunk_transitions=16)
    fam.reset_all()
    key = jax.random.key(0)
    stats, msgs = [], []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        stats.extend(fam.step_all(params, k))
        msgs.extend(fam.poll_msgs())
    fam.close()
    return stats, msgs


def _drive_port(cfg, params, n_steps, actor_id=0):
    spec = dqn_env_specs(cfg)[0]
    slots, seeds, eps = worker_slots(cfg, actor_id)
    fam = VectorDQNWorkerFamily(cfg, spec, seeds=seeds, slot_ids=slots,
                                epsilons=eps, chunk_transitions=16)
    fam.load_params(params)
    fam.reset_all()
    gen = torch.Generator().manual_seed(0)
    stats, msgs = [], []
    for _ in range(n_steps):
        stats.extend(fam.step_all(step_seed(gen)))
        msgs.extend(fam.poll_msgs())
    fam.close()
    return stats, msgs


EXACT = ("frames", "n_frames", "n_trans", "action", "reward", "discount",
         "obs_ref", "next_ref")


def test_vector_family_chunks_equal_jax_at_eps_zero():
    jcfg, cfg = _cfgs(eps_base=0.0)
    fparams = _flax_params(jcfg)
    jstats, jmsgs = _drive_jax(jcfg, fparams, 100)
    stats, msgs = _drive_port(cfg, params_from_flax(jax.device_get(fparams)),
                              100)
    assert len(msgs) == len(jmsgs) >= 20
    for i, (got, want) in enumerate(zip(msgs, jmsgs)):
        assert got["n_trans"] == want["n_trans"]
        assert set(got["payload"]) == set(want["payload"])
        for key in EXACT:
            np.testing.assert_array_equal(got["payload"][key],
                                          want["payload"][key],
                                          err_msg=f"chunk {i} {key}")
            assert got["payload"][key].dtype == want["payload"][key].dtype
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"chunk {i} priorities")
    assert [(s.actor_id, s.reward, s.length) for s in stats] == \
        [(s.actor_id, s.reward, s.length) for s in jstats]
    assert len(stats) >= 8


def test_scalar_family_steps_equal_jax_at_eps_zero():
    from apex_tpu.actors.pool import DQNWorkerFamily as JaxScalarFamily

    jcfg, cfg = _cfgs(eps_base=0.0, n_envs=1)
    fparams = _flax_params(jcfg)
    jfam = JaxScalarFamily(jcfg, jax_env_specs(jcfg)[0], seed=11,
                           chunk_transitions=16)
    fam = DQNWorkerFamily(cfg, dqn_env_specs(cfg)[0], seed=11,
                          chunk_transitions=16)
    fam.load_params(params_from_flax(jax.device_get(fparams)))
    for f in (jfam, fam):
        obs, _ = f.env.reset(seed=11)
        f.begin_episode(obs)
    gen, key = torch.Generator().manual_seed(0), jax.random.key(0)
    jmsgs, msgs = [], []
    for _ in range(60):
        key, k = jax.random.split(key)
        want = jfam.step(fparams, None, 0.0, k)
        got = fam.step(0.0, gen)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if got[2] or got[3]:
            for f in (jfam, fam):
                f.begin_episode(f.env.reset()[0])
        jmsgs.extend(jfam.poll_msgs())
        msgs.extend(fam.poll_msgs())
    assert len(msgs) == len(jmsgs) >= 3
    for got, want in zip(msgs, jmsgs):
        for key in EXACT:
            np.testing.assert_array_equal(got["payload"][key],
                                          want["payload"][key])
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=1e-5, atol=1e-6)


def test_double_buffer_on_and_off_are_bit_identical_per_slot():
    runs = {}
    for on in (True, False):
        _, cfg = _cfgs(eps_base=0.4, n_envs=5, double_buffer=on)
        params = host_params(DuelingDQN(
            **dqn_env_specs(cfg)[0],
            generator=torch.Generator().manual_seed(1)))
        stats, msgs = _drive_port(cfg, params, 60, actor_id=1)
        runs[on] = stats, msgs
    (stats_on, msgs_on), (stats_off, msgs_off) = runs[True], runs[False]
    assert len(msgs_on) == len(msgs_off) >= 10
    for got, want in zip(msgs_on, msgs_off):
        for key in EXACT:
            np.testing.assert_array_equal(got["payload"][key],
                                          want["payload"][key])
        np.testing.assert_array_equal(got["priorities"], want["priorities"])
    assert stats_on == stats_off and stats_on
    # exploration really was on: a greedy policy would not show all three
    actions = np.concatenate([m["payload"]["action"] for m in msgs_on])
    assert set(actions.tolist()) == {0, 1, 2}


def _run_loop(target, args, stat_queue, stop, want):
    """Run a worker loop on a thread, reading its depth-1 stat queue
    slowly (so the worker drops stats), until ``want(stats)`` holds.
    A drop needs two episode ends between reads, so the pause between
    reads outlasts a few CartPole episodes on a loaded host."""
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    stats = []
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and not want(stats):
        time.sleep(0.25)
        try:
            stats.append(stat_queue.get(timeout=0.2))
        except queue.Empty:
            pass
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    return stats


def _queues(params):
    chunk_queue: queue.Queue = queue.Queue()
    param_queue: queue.Queue = queue.Queue()
    stat_queue: queue.Queue = queue.Queue(maxsize=1)   # forces drops
    param_queue.put((1, params))
    return chunk_queue, param_queue, stat_queue, threading.Event()


def test_vector_worker_loop_counts_dropped_stats_and_emits_timing():
    _, cfg = _cfgs(eps_base=0.4, n_envs=3, timing_interval=8)
    spec = dqn_env_specs(cfg)[0]
    params = host_params(DuelingDQN(**spec,
                                    generator=torch.Generator().manual_seed(0)))
    slots, seeds, eps = worker_slots(cfg, 0)
    fam = VectorDQNWorkerFamily(cfg, spec, seeds=seeds, slot_ids=slots,
                                epsilons=eps, chunk_transitions=16)
    chunk_queue, param_queue, stat_queue, stop = _queues(params)

    def want(stats):
        return (any(isinstance(s, EpisodeStat) and s.dropped_stats > 0
                    for s in stats)
                and any(isinstance(s, ActorTimingStat) for s in stats))

    stats = _run_loop(vector_worker_loop,
                      (0, cfg, fam, chunk_queue, param_queue, stat_queue,
                       stop), stat_queue, stop, want)
    assert any(isinstance(s, EpisodeStat) and s.dropped_stats > 0
               and s.param_version == 1 for s in stats)
    timing = [s for s in stats if isinstance(s, ActorTimingStat)]
    assert timing and timing[0].vector_steps == 8
    assert timing[0].frames_per_sec > 0 and timing[0].double_buffer
    fracs = (timing[0].policy_wait_frac, timing[0].env_step_frac,
             timing[0].drain_frac)
    assert all(0.0 <= f <= 1.0 for f in fracs) and sum(fracs) <= 1.0
    assert chunk_queue.qsize() > 0


def test_scalar_worker_loop_counts_dropped_stats():
    _, cfg = _cfgs(eps_base=0.4, n_envs=1)
    spec = dqn_env_specs(cfg)[0]
    params = host_params(DuelingDQN(**spec,
                                    generator=torch.Generator().manual_seed(0)))
    fam = DQNWorkerFamily(cfg, spec, seed=5, chunk_transitions=16)
    chunk_queue, param_queue, stat_queue, stop = _queues(params)
    stats = _run_loop(worker_loop,
                      (0, cfg, fam, chunk_queue, param_queue, stat_queue,
                       stop, 0.4), stat_queue, stop,
                      lambda s: any(x.dropped_stats > 0 for x in s))
    assert any(s.dropped_stats > 0 and s.param_version == 1 for s in stats)
    assert chunk_queue.qsize() > 0


def test_worker_loops_pick_up_newer_params():
    """A publish after the first replaces the worker's weights at its next
    poll, and only the newest of several queued publishes is loaded."""
    from apex_tpu_torch.actors.pool import _latest_params

    _, cfg = _cfgs(eps_base=0.4, n_envs=1)
    spec = dqn_env_specs(cfg)[0]
    fam = DQNWorkerFamily(cfg, spec, seed=5, chunk_transitions=16)
    q: queue.Queue = queue.Queue()
    newer = [host_params(DuelingDQN(
        **spec, generator=torch.Generator().manual_seed(s))) for s in (1, 2)]
    q.put((2, newer[0]))
    q.put((3, newer[1]))
    assert _latest_params(q, 1, fam) == 3
    for name, value in fam.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), newer[1][name])
    assert _latest_params(q, 3, fam) == 3          # nothing new queued


def test_respawn_never_hands_over_a_version_older_than_a_publish(
        monkeypatch):
    """A publish from another thread (the ingest pipeline's staging
    thread) lands while a respawn hands the newest params to the new
    worker: the worker's queue must end with the newest version, and an
    older entry behind a newer one is never loaded."""
    from apex_tpu_torch.actors.pool import ActorPool, _latest_params

    class DeadProcess:
        def is_alive(self):
            return False

        def join(self, timeout=None):
            pass

    cfg = ApexConfig(actor=ActorConfig(n_actors=1))
    pool = ActorPool(cfg, {}, chunk_transitions=16)
    pool.procs = [DeadProcess()]
    pool.param_queues = [queue.Queue(maxsize=2)]
    monkeypatch.setattr(pool, "_process", lambda i: DeadProcess())
    monkeypatch.setattr(pool, "_spawn", lambda procs: None)
    pool.publish_params(1, "v1")
    pool.param_queues[0].get_nowait()        # the dead worker had taken it

    publisher = threading.Thread(target=pool.publish_params,
                                 args=(2, "v2"))
    real_put = ActorPool._put_latest

    def put_during_a_publish(q, version, params):
        # the respawn's handover: let the other thread's publish run now
        if threading.current_thread() is threading.main_thread():
            publisher.start()
            publisher.join(timeout=0.5)
        real_put(q, version, params)

    monkeypatch.setattr(ActorPool, "_put_latest",
                        staticmethod(put_during_a_publish))
    assert pool.respawn_worker(0)
    publisher.join(timeout=10)
    assert not publisher.is_alive()
    versions = []
    while not pool.param_queues[0].empty():
        versions.append(pool.param_queues[0].get_nowait()[0])
    assert versions == sorted(versions) and versions[-1] == 2

    class Family:
        loaded = []

        def load_params(self, params):
            self.loaded.append(params)

    q = queue.Queue()
    q.put((1, "v1"))                         # stale entry behind the newest
    fam = Family()
    assert _latest_params(q, 2, fam) == 2 and fam.loaded == []


def test_pool_respawns_dead_workers_within_its_rate_limit():
    """Workers that die are respawned on their slots until the slot's
    budget for the window is spent; cleanup then leaves nothing alive.
    The worker body here (``os._exit`` called with the pool's nine
    arguments) fails at once."""
    import os

    from apex_tpu_torch.actors.pool import ActorPool

    cfg = ApexConfig(actor=ActorConfig(n_actors=2, shm_data_plane=False))
    pool = ActorPool(cfg, {}, chunk_transitions=16, worker_fn=os._exit)
    pool.max_respawns_per_slot = 1
    pool.start()
    try:
        def wait_dead(n):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                dead = pool.dead_workers()
                if len(dead) == n:
                    return dead
                time.sleep(0.05)
            return pool.dead_workers()

        assert wait_dead(2) == [0, 1]
        pool.publish_params(1, {"w": np.zeros(2, np.float32)})
        assert all(pool.respawn_worker(i) for i in (0, 1))
        assert pool.worker_deaths == 2
        deadline = time.monotonic() + 60
        while (any(p.is_alive() for p in pool.procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert pool.dead_workers() == []            # budget spent
        assert not pool.respawn_worker(0)
        assert pool.param_queues[0].get(timeout=5)[0] == 1   # re-queued
    finally:
        pool.cleanup()
    assert not any(p.is_alive() for p in pool.procs)
