"""The port's four AQL worker families against ``apex_tpu``'s.

Each family acts from the same weights with the draws JAX's family makes
from its step keys (:class:`tests.test_torch_aql.JaxAQLDraws`; the vector
families' per-group keys are ``fold_in(step_key, group)``), on a ladder
that greedy-acts, explores half the time and always explores.  The
messages they ship must agree: candidate indices, frames, discounts and
chunk references bit-equal; the continuous env's observations and
rewards, the candidate sets and the Q-derived priorities to f32
round-off (rtol 1e-5, atol 1e-6: the proposal means and the scores come
out of matmuls, and the env integrates the actions).  A discrete
candidate set repeats action values, and repeats score alike but for
the matmul's round-off, so where the chosen indices differ the chosen
candidates must be the same action.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.actors import aql as jax_actors
from apex_tpu.config import small_test_config as jax_small_config
from apex_tpu.envs.registry import unstacked_env_spec as jax_env_spec
from apex_tpu.models.aql import AQLNetwork as FlaxAQL
from apex_tpu.training import aql as jax_aql
from apex_tpu_torch.actors import aql as port_actors
from apex_tpu_torch.actors import vector as port_vector
from apex_tpu_torch.config import small_test_config
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.training import aql as port_aql
from tests.test_torch_aql import JaxAQLDraws, _init_params

EPSILONS = [0.0, 0.5, 1.0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _setup(env_id):
    """Both configs, both model specs, the flax model, its params and
    their host form."""
    out = []
    for small in (small_test_config, jax_small_config):
        cfg = small(capacity=256, batch_size=8, n_actors=1, env_id=env_id)
        out.append(cfg.replace(
            aql=dataclasses.replace(cfg.aql, propose_sample=6,
                                    uniform_sample=10),
            env=dataclasses.replace(cfg.env, frame_stack=4),
            learner=dataclasses.replace(cfg.learner, n_steps=1)))
    cfg, jcfg = out
    from apex_tpu.envs.registry import make_env as jax_make_env
    probe = jax_make_env(env_id, jcfg.env, seed=0, stack_frames=False)
    jspec = jax_aql.aql_model_spec(jcfg, probe)
    frame_shape, _, stack = jax_env_spec(probe, jcfg.env)
    obs_shape = (frame_shape[:-1] + (stack * frame_shape[-1],)
                 if len(frame_shape) == 3 else frame_shape)
    from apex_tpu_torch.envs.registry import make_env
    spec = port_aql.aql_model_spec(cfg, make_env(env_id, seed=0), obs_shape)
    jm = FlaxAQL(**jspec)
    a_dim = 1 if jm.discrete else jm.action_dim
    dtype = jnp.uint8 if jspec["scale_uint8"] else jnp.float32
    params = _init_params(jm, jnp.zeros((1,) + obs_shape, dtype),
                          jnp.zeros((1, jm.total_sample, a_dim)))
    return cfg, jcfg, spec, jspec, jm, params, params_from_flax(
        jax.device_get(params))


def _assert_messages_equal(jmsgs, msgs):
    assert len(jmsgs) == len(msgs) >= 2
    close = {"obs", "next_obs", "a_mu", "reward"}
    for jm, m in zip(jmsgs, msgs):
        assert jm["n_trans"] == m["n_trans"]
        np.testing.assert_allclose(m["priorities"], jm["priorities"],
                                   rtol=1e-5, atol=1e-6)
        for k, v in m["payload"].items():
            want = jm["payload"][k]
            if k == "action" and "extras" in m["payload"]:
                rows = np.arange(len(v))
                np.testing.assert_array_equal(
                    m["payload"]["extras"]["a_mu"][rows, v],
                    jm["payload"]["extras"]["a_mu"][rows, want])
            elif k == "extras":
                np.testing.assert_allclose(v["a_mu"], want["a_mu"],
                                           rtol=1e-5, atol=1e-6)
            elif k in close and np.asarray(v).dtype == np.float32:
                np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("env_id", ["ApexContinuousNav-v0",
                                    "ApexCatchSmall-v0"],
                         ids=["continuous", "pixels"])
def test_scalar_families_ship_jax_messages(env_id, monkeypatch):
    monkeypatch.setenv("APEX_OBS_SPANS", "0")     # the port ships no spans
    cfg, jcfg, spec, jspec, jm, params, host = _setup(env_id)
    pixels = env_id.startswith("ApexCatch")
    jcls = (jax_actors.AQLPixelWorkerFamily if pixels
            else jax_actors.AQLWorkerFamily)
    cls = (port_actors.AQLPixelWorkerFamily if pixels
           else port_actors.AQLWorkerFamily)
    jfam = jcls(jcfg, jspec, seed=7, chunk_transitions=8)
    fam = cls(cfg, spec, seed=7, chunk_transitions=8)
    fam.load_params(host)
    jobs = jfam.env.reset(seed=7)[0]
    jfam.begin_episode(jobs)
    fam.begin_episode(fam.env.reset(seed=7)[0])
    for step in range(48):
        eps = EPSILONS[step % 3]
        key = jax.random.key(100 + step)
        jobs, reward, term, trunc = jfam.step(params, jobs, eps, key)
        fam.draws_from = lambda g, k=key: JaxAQLDraws.policy(jm, params, k)
        got = fam.step(eps, torch.Generator())
        np.testing.assert_allclose(got[1], reward, rtol=1e-5, atol=1e-6)
        assert (got[2], got[3]) == (term, trunc)
        if term or trunc:
            jobs = jfam.env.reset()[0]
            jfam.begin_episode(jobs)
            fam.begin_episode(fam.env.reset()[0])
    _assert_messages_equal(jfam.poll_msgs(), fam.poll_msgs())


@pytest.mark.parametrize("env_id", ["ApexContinuousNav-v0",
                                    "ApexCatchSmall-v0"],
                         ids=["continuous", "pixels"])
def test_vector_families_ship_jax_messages(env_id, monkeypatch):
    monkeypatch.setenv("APEX_OBS_SPANS", "0")
    cfg, jcfg, spec, jspec, jm, params, host = _setup(env_id)
    pixels = env_id.startswith("ApexCatch")
    jcls = (jax_actors.VectorAQLPixelWorkerFamily if pixels
            else jax_actors.VectorAQLWorkerFamily)
    cls = (port_actors.VectorAQLPixelWorkerFamily if pixels
           else port_actors.VectorAQLWorkerFamily)
    seeds, slots = [7, 8, 9], [0, 1, 2]
    jfam = jcls(jcfg, jspec, seeds, slots, EPSILONS, chunk_transitions=8)
    fam = cls(cfg, spec, seeds, slots, EPSILONS, chunk_transitions=8)
    fam.load_params(host)
    # the port's per-group generator stands for JAX's fold_in(key, group)
    monkeypatch.setattr(port_vector, "group_generator",
                        lambda seed, group: (seed, group))
    fam.draws_from = lambda tok: JaxAQLDraws.policy(
        jm, params, jax.random.fold_in(jax.random.key(tok[0]), tok[1]))
    jfam.reset_all()
    fam.reset_all()
    for step in range(24):
        jstats = jfam.step_all(params, jax.random.key(step))
        stats = fam.step_all(step)
        assert [(s.actor_id, s.length) for s in stats] == [
            (s.actor_id, s.length) for s in jstats]
    _assert_messages_equal(jfam.poll_msgs(), fam.poll_msgs())


def test_worker_bodies_pick_the_family_of_the_observations():
    assert port_actors.vector_aql_worker_main.is_vector is True
    assert not getattr(port_actors.aql_worker_main, "is_vector", False)
