"""The port's AQL family against ``apex_tpu``'s.

Replayed draws: flax draws the candidate sets from a ``'sample'`` key and
the NoisyNet noise inside each noisy layer's scope from a ``'noise'``
key; :class:`JaxAQLDraws` recovers those per-scope keys
(``nn.apply(lambda m: m.advantage1.make_rng("noise"), model)``, then the
layer's own split) and hands the port the very numbers JAX drew.

* The env: ``ApexContinuousNav-v0`` bit-equal to the gymnasium env.
* The model: ``NoisyDense`` and every ``AQLNetwork`` method, continuous
  and discrete, within f32 round-off (rtol 1e-5, atol 1e-6), the discrete
  candidate sets exactly; the policy at eps 0 and eps 1.
* The losses: both values and both groups' gradients (rtol 1e-5, atol
  1e-6); the labels; the two-group clip + Adam and the cosine schedule
  against optax over six steps (atol 1e-7 on the weights, rtol 1e-6 on
  the schedule).
* ``AQLTransitionBuilder`` rows bit-equal; the model spec equal.
* ``AQLCore.fused_step`` and ``fused_multi_step`` against JAX's
  ``AQLCore``, stacked continuous and frame-pool pixels (the sidecar
  sampled beside the ``gather_stacks`` call): losses and norms within
  rtol 1e-4, trees within rtol 1e-5, weights within atol 1e-5 (1% of
  one Adam step of lr 1e-3).
* Drivers on the CPU: ``AQLTrainer`` (continuous and discrete),
  ``AQLApexTrainer.train`` with one spawned actor process on pixels (one
  ``gather_stacks`` per learner step), its ``scan_steps`` dispatch on
  stacked messages (serial and pipelined), a checkpoint round trip that
  stays bit-equal, ``evaluate_checkpoint`` on the bundle, and the entry
  points' refusal of a missing card.
"""

import copy
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from apex_tpu.config import small_test_config as jax_small_config
from apex_tpu.envs.registry import make_env as jax_make_env
from apex_tpu.models.aql import AQLNetwork as FlaxAQL
from apex_tpu.models.aql import make_aql_policy_fn as jax_policy_fn
from apex_tpu.models.noisy import NoisyDense as FlaxNoisy
from apex_tpu.ops import losses as jax_losses
from apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.replay.frame_pool import FramePoolReplay as JaxPool
from apex_tpu.training import aql as jax_aql
from apex_tpu.training.state import TrainState as JaxTrainState
from apex_tpu_torch.config import small_test_config
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.envs.registry import make_env
from apex_tpu_torch.models.aql import (NOISY_LAYERS, AQLDraws, AQLNetwork,
                                       make_aql_policy_fn)
from apex_tpu_torch.models.noisy import NoisyDense
from apex_tpu_torch.native.ring import SEGMENT_PREFIX
from apex_tpu_torch.ops import losses
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay import frame_pool as frame_pool_module
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.replay.frame_chunks import drain_builder_chunks
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training import aql as port_aql
from apex_tpu_torch.training.checkpoint import evaluate_checkpoint
from apex_tpu_torch.training.state import TrainState

A, T_P, T_U = 2, 8, 16
T = T_P + T_U
N_DISCRETE = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores: this
    file's torch ops take one thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# -- replayed JAX draws ------------------------------------------------------

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class JaxAQLDraws(AQLDraws):
    """The draws JAX's AQL model makes from its keys: the proposal's from
    ``sample`` (root scope), one NoisyNet draw per key of ``noise`` (one
    per :meth:`noise` call, in order, each layer's key recovered from its
    scope) and the epsilon-greedy draws from ``eps``/``rand``."""

    def __init__(self, jmodel, params, sample=None, noise=(), eps=None,
                 rand=None):
        self.jmodel, self.params = jmodel, params
        self.k_sample, self.noise_keys = sample, list(noise)
        self.k_eps, self.k_rand = eps, rand
        self.generator, self.device = None, torch.device("cpu")

    @classmethod
    def policy(cls, jmodel, params, key):
        """``make_aql_policy_fn``'s split of its step key."""
        k_sample, k_noise, k_eps, k_rand = jax.random.split(key, 4)
        return cls(jmodel, params, k_sample, [k_noise], k_eps, k_rand)

    def _scope_key(self, fn, collection, key):
        return nn.apply(fn, self.jmodel)(self.params,
                                         rngs={collection: key})

    def proposal(self, model, b):
        root = self._scope_key(lambda m: m.make_rng("sample"), "sample",
                               self.k_sample)
        k_u, k_p = jax.random.split(root)
        if model.discrete:
            n = model.action_dim
            perm = jax.vmap(lambda k: jax.random.permutation(k, n))(
                jax.random.split(k_u, b))
            return {"perm": _t(perm).long(),
                    "gumbel": _t(jax.random.gumbel(
                        k_p, (model.propose_sample, b, n), jnp.float32))}
        return {"uniform": _t(jax.random.uniform(
                    k_u, (b, model.uniform_sample, model.action_dim))),
                "normal": _t(jax.random.normal(
                    k_p, (b, model.propose_sample, model.action_dim)))}

    def noise(self, model):
        key = self.noise_keys.pop(0)
        out = {}
        for name in NOISY_LAYERS:
            layer_key = self._scope_key(
                lambda m, n=name: getattr(m, n).make_rng("noise"), "noise",
                key)
            k_in, k_out = jax.random.split(layer_key)
            layer = getattr(model, name)
            out[name] = (_t(jax.random.normal(k_in, (layer.in_features,))),
                         _t(jax.random.normal(k_out, (layer.features,))))
        return out

    def explore(self, b, t):
        return (_t(jax.random.uniform(self.k_eps, (b,))),
                _t(jax.random.randint(self.k_rand, (b,), 0, t)).long())


def update_draws(jmodel, params, keys):
    """``AQLCore.train_step``'s splits of each step key: the PER sample's
    uniforms ``[K, B]`` and a draw source replaying the online and target
    noise of every step in order."""
    offsets, noise = [], []
    for key in keys:
        k_sample, k_update = jax.random.split(key)
        offsets.append(k_sample)
        noise.extend(jax.random.split(k_update))
    return offsets, JaxAQLDraws(jmodel, params, noise=noise)


# -- models -------------------------------------------------------------------

def _init_params(jm, obs, a_mu):
    """``jm``'s params from the fixed init keys, through one compiled
    init (eagerly, flax's orthogonal inits compile op by op)."""
    init = jax.jit(lambda o, a: jm.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "sample": jax.random.key(2)}, o, a, method=FlaxAQL.full_init))
    return init(obs, a_mu)


def _models(discrete=False, obs_shape=(3,), **kw):
    """A flax AQLNetwork, its params and the port's model carrying them."""
    a = N_DISCRETE if discrete else A
    u = 4 if discrete else T_U
    spec = dict(action_dim=a, propose_sample=T_P, uniform_sample=u,
                discrete=discrete, **kw)
    jm = FlaxAQL(**spec)
    a_dim = 1 if discrete else a
    obs = jnp.zeros((1,) + obs_shape,
                    jnp.uint8 if kw.get("scale_uint8") else jnp.float32)
    params = _init_params(jm, obs, jnp.zeros((1, jm.total_sample, a_dim)))
    pm = AQLNetwork(**spec, obs_shape=obs_shape,
                    generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, pm


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def test_continuous_nav_matches_the_gymnasium_env():
    jenv = jax_make_env("ApexContinuousNav-v0", seed=4)
    env = make_env("ApexContinuousNav-v0", seed=4)
    assert env.action_space.shape == jenv.action_space.shape == (2,)
    assert (env.action_space.low, env.action_space.high) == (-1.0, 1.0)
    assert env.observation_space.shape == (2,)
    actions = np.random.default_rng(0).uniform(-1.5, 1.5, (100, 2))
    for episode in range(3):
        want, _ = jenv.reset(seed=20 + episode)
        got, _ = env.reset(seed=20 + episode)
        np.testing.assert_array_equal(got, want)
        for t, a in enumerate(actions):
            w, g = jenv.step(a.astype(np.float32)), env.step(
                a.astype(np.float32))
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:4] == w[1:4]
            if g[3]:
                assert t == 29                  # truncation at 30 steps
                break


def test_noisy_dense_matches_flax():
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    layer = FlaxNoisy(3)
    params = layer.init({"params": jax.random.key(0),
                         "noise": jax.random.key(1)}, x)
    port = NoisyDense(7, 3, generator=torch.Generator().manual_seed(0))
    port.load_state_dict({k: _t(v) for k, v in
                          jax.device_get(params)["params"].items()})
    key = jax.random.key(5)
    layer_key = nn.apply(lambda m: m.make_rng("noise"), layer)(
        params, rngs={"noise": key})
    k_in, k_out = jax.random.split(layer_key)
    noise = (_t(jax.random.normal(k_in, (7,))),
             _t(jax.random.normal(k_out, (3,))))
    _close(port(torch.from_numpy(x), noise),
           # apexlint: disable=J004 -- parity test: the port replays the draws JAX makes from this same key
           layer.apply(params, x, rngs={"noise": key}), what="noisy")
    _close(port(torch.from_numpy(x), None),
           FlaxNoisy(3, deterministic=True).apply(params, x), what="mu-only")
    # the init's ranges: mu ~ U(+-1/sqrt(in)), sigma = 0.4/sqrt(in)
    fresh = NoisyDense(7, 3, generator=torch.Generator().manual_seed(1))
    assert fresh.w_mu.abs().max() <= 1 / np.sqrt(7)
    torch.testing.assert_close(fresh.b_sigma,
                               torch.full((3,), 0.4 / np.sqrt(7)))


@pytest.mark.parametrize("discrete", [False, True],
                         ids=["continuous", "discrete"])
def test_network_methods_match_flax(discrete):
    jm, params, pm = _models(discrete)
    assert set(pm.state_dict()) == set(params_from_flax(
        jax.device_get(params)))                # full_init covers every layer
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(4, 3)).astype(np.float32)
    tobs = torch.from_numpy(obs)
    _close(pm.embed(tobs), jm.apply(params, obs, method=FlaxAQL.embed))
    _close(pm.proposal_mean(tobs),
           jm.apply(params, obs, method=FlaxAQL.proposal_mean))

    key = jax.random.key(7)
    # apexlint: disable=J004 -- parity test: the port replays the draws JAX makes from this same key
    draws = JaxAQLDraws(jm, params, sample=key, noise=[key])
    a_mu = pm.propose(tobs, draws.proposal(pm, 4))
    # apexlint: disable=J004 -- parity test: the port replays the draws JAX makes from this same key
    want = jm.apply(params, obs, method=FlaxAQL.propose,
                    rngs={"sample": key})
    assert a_mu.shape == want.shape
    if discrete:
        np.testing.assert_array_equal(a_mu.numpy(), np.asarray(want))
        assert all(len(set(row[:4, 0].tolist())) == 4 for row in a_mu)
    else:
        _close(a_mu, want, what="propose")
    q = pm.score(tobs, _t(want), draws.noise(pm))
    # apexlint: disable=J004 -- parity test: the port replayed the same key's draws above
    _close(q, jm.apply(params, obs, want, rngs={"noise": key}), what="score")
    _close(pm.score(tobs, _t(want), None),
           jm.clone(noisy_deterministic=True).apply(params, obs, want),
           what="mu-only score")
    actions = np.asarray(want)[:, 3]
    lp, ent = pm.proposal_log_prob(tobs, _t(actions))
    jlp, jent = jm.apply(params, obs, actions,
                         method=FlaxAQL.proposal_log_prob)
    _close(lp, jlp, what="log_prob")
    _close(ent, jent, what="entropy")


def test_image_observations_flatten_and_scale():
    jm, params, pm = _models(False, obs_shape=(6, 6, 2), obs_is_image=True,
                             scale_uint8=True)
    obs = np.random.default_rng(2).integers(0, 255, (3, 6, 6, 2)).astype(
        np.uint8)
    _close(pm.embed(torch.from_numpy(obs)),
           jm.apply(params, obs, method=FlaxAQL.embed))


@pytest.mark.parametrize("discrete", [False, True],
                         ids=["continuous", "discrete"])
@pytest.mark.parametrize("eps", [0.0, 1.0])
def test_policy_matches_jax(discrete, eps):
    jm, params, pm = _models(discrete)
    obs = np.random.default_rng(3).normal(size=(6, 3)).astype(np.float32)
    key = jax.random.key(11)
    want = jax_policy_fn(jm)(params, obs, jnp.float32(eps), key)
    got = make_aql_policy_fn(pm)(
        torch.from_numpy(obs), eps,
        # apexlint: disable=J004 -- parity test: the port replays the draws JAX makes from this same key
        JaxAQLDraws.policy(jm, params, key))
    for g, w, name in zip(got, want, ("actions", "idx", "a_mu", "q")):
        assert g.shape == w.shape, name
        if name == "idx" or discrete and name in ("actions", "a_mu"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            _close(g, w, what=name)
    if discrete:
        assert got[0].dtype == torch.int32


def _batch(rng, b, discrete=False):
    a_dim = 1 if discrete else A
    t = T_P + (4 if discrete else T_U)
    a_mu = (rng.integers(0, N_DISCRETE, (b, t, 1)).astype(np.float32)
            if discrete else rng.uniform(-1, 1, (b, t, a_dim)).astype(
                np.float32))
    return dict(obs=rng.normal(size=(b, 3)).astype(np.float32),
                next_obs=rng.normal(size=(b, 3)).astype(np.float32),
                action=rng.integers(0, t, b).astype(np.int32),
                reward=rng.normal(size=b).astype(np.float32),
                discount=(rng.random(b) < 0.8).astype(np.float32) * 0.99,
                a_mu=a_mu)


@pytest.mark.parametrize("discrete", [False, True],
                         ids=["continuous", "discrete"])
def test_losses_and_grads_match_jax(discrete):
    jm, params, pm = _models(discrete)
    target = copy.deepcopy(pm).requires_grad_(False)
    rng = np.random.default_rng(4)
    batch = _batch(rng, 16, discrete)
    weights = rng.uniform(0.2, 1.0, 16).astype(np.float32)
    k_on, k_tg = jax.random.split(jax.random.key(9))

    def score(p, obs, a_mu, k):
        return jm.apply(p, obs, a_mu, rngs={"noise": k})

    def log_prob(p, obs, actions):
        return jm.apply(p, obs, actions, method=FlaxAQL.proposal_log_prob)

    (jloss, jaux), jq_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_losses.aql_q_loss(score, p, params, batch, weights,
                                        k_on, k_tg), has_aux=True))(params)
    jloss_p, jp_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_losses.aql_proposal_loss(log_prob, p, batch,
                                               jaux.best_idx, 0.01)))(params)

    # apexlint: disable=J004 -- parity test: the port replays the draws JAX makes from these same keys
    draws = JaxAQLDraws(jm, params, noise=[k_on, k_tg])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = losses.aql_q_loss(pm, target, tbatch, torch.from_numpy(
        weights), draws.noise(pm), draws.noise(pm))
    groups = losses.aql_param_groups(pm)
    q_grads = torch.autograd.grad(loss, groups["q"])
    np.testing.assert_array_equal(aux.best_idx.numpy(),
                                  np.asarray(jaux.best_idx))
    loss_p = losses.aql_proposal_loss(pm, tbatch, aux.best_idx, 0.01)
    p_grads = torch.autograd.grad(loss_p, groups["proposal"])
    _close(loss, jloss, what="q loss")
    _close(loss_p, jloss_p, what="proposal loss")
    for name in ("td_abs", "priorities", "q_taken"):
        _close(getattr(aux, name), getattr(jaux, name), what=name)
    names = {g: [n for n, _ in pm.named_parameters()
                 if losses.aql_param_labels(pm)[n] == g] for g in groups}
    jq_grads, jp_grads = jax.device_get((jq_grads, jp_grads))
    for group, grads, jgrads in (("q", q_grads, jq_grads),
                                 ("proposal", p_grads, jp_grads)):
        want = params_from_flax(jgrads)
        for name, g in zip(names[group], grads):
            _close(g, want[name], what=name)
    # the labels: the embedding trunk rides with the proposal head
    jlabels = jax_losses.aql_param_labels(params)["params"]
    for name, label in losses.aql_param_labels(pm).items():
        assert set(jlabels[name.split(".")[0]].values()) == {label}, name


@pytest.mark.parametrize("cosine_steps", [None, 4])
def test_two_group_adam_and_cosine_match_optax(cosine_steps):
    jm, params, pm = _models()
    jopt = jax_losses.make_aql_optimizer(q_lr=3e-3, proposal_lr=1e-3,
                                         max_grad_norm=0.5,
                                         cosine_steps=cosine_steps)
    opt = losses.make_aql_optimizer(q_lr=3e-3, proposal_lr=1e-3,
                                    max_grad_norm=0.5,
                                    cosine_steps=cosine_steps)
    jstate, state = jopt.init(params), opt.init(pm)
    groups = losses.aql_param_groups(pm)
    labels = losses.aql_param_labels(pm)
    rng = np.random.default_rng(5)

    @jax.jit
    def jstep(grads, jstate, params):
        updates, jstate = jopt.update(grads, jstate, params)
        return optax.apply_updates(params, updates), jstate

    for step in range(6):
        # small grads stay under the clip, large ones are clipped
        scale = 0.01 if step % 2 else 1.0
        jgrads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(
                np.float32) * scale), params)
        params, jstate = jstep(jgrads, jstate, params)
        # apexlint: disable=J006 -- parity test: each step's grads and weights are compared on the host
        tg = params_from_flax(jax.device_get(jgrads))
        opt.step(pm, {g: [tg[n] for n, _ in pm.named_parameters()
                          if labels[n] == g] for g in groups}, state)
        # apexlint: disable=J006 -- parity test: each step's grads and weights are compared on the host
        want = params_from_flax(jax.device_get(params))
        for name, p in pm.state_dict().items():
            _close(p, want[name], rtol=0, atol=1e-7, what=f"{step} {name}")
    assert state.q.count == state.proposal.count == 6
    sched = losses.cosine_annealing(1e-3, 50, 1e-6)
    jsched = jax_losses.cosine_annealing(1e-3, 50, 1e-6)
    for count in (0, 1, 7, 25, 49, 50, 80):
        np.testing.assert_allclose(sched(count), float(jsched(count)),
                                   rtol=1e-6)


def test_transition_builder_rows_are_bit_equal():
    rng = np.random.default_rng(6)
    jb = jax_aql.AQLTransitionBuilder(0.97)
    pb = port_aql.AQLTransitionBuilder(0.97)
    for t in range(60):
        args = (rng.normal(size=3).astype(np.float32),
                int(rng.integers(0, T)), float(rng.normal()),
                rng.normal(size=3).astype(np.float32),
                rng.normal(size=(T, A)).astype(np.float32),
                rng.normal(size=T).astype(np.float32),
                bool(rng.random() < 0.1), bool(rng.random() < 0.05))
        jb.add_step(*args)
        pb.add_step(*args)
    assert len(jb) == len(pb) > 40
    (jbatch, jprio), (batch, prio) = jb.drain(40), pb.drain(40)
    np.testing.assert_array_equal(prio, jprio)
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k], k)
        assert batch[k].dtype == jbatch[k].dtype


@pytest.mark.parametrize("env_id", ["ApexContinuousNav-v0",
                                    "ApexCartPole-v0", "ApexCatch-v0"])
def test_model_spec_matches_jax(env_id):
    cfg = small_test_config(env_id=env_id)
    jcfg = jax_small_config(env_id=env_id)
    env, jenv = make_env(env_id, seed=0), jax_make_env(env_id, seed=0,
                                                       stack_frames=False)
    spec = port_aql.aql_model_spec(cfg, env, (2,))
    jspec = jax_aql.aql_model_spec(jcfg, jenv)
    assert spec.pop("obs_shape") == (2,)
    assert spec.pop("compute_dtype") == torch.float32
    assert jspec.pop("compute_dtype") == jnp.float32
    assert spec == jspec


# -- the learner core ---------------------------------------------------------

def _pixel_chunks(n, rng, shape=(6, 6, 1), k=8, t=T):
    builder = JaxBuilder(1, 0.99, 4, shape, chunk_transitions=k,
                         extra_shapes={"a_mu": (t, A)})
    msgs = []
    while len(msgs) < n:
        builder.begin_episode(rng.integers(0, 255, shape).astype(np.uint8))
        length = int(rng.integers(3, 20))
        for i in range(length):
            builder.add_step(int(rng.integers(0, t)), float(rng.normal()),
                             rng.normal(size=t).astype(np.float32),
                             rng.integers(0, 255, shape).astype(np.uint8),
                             i == length - 1, False,
                             extras={"a_mu": rng.uniform(-1, 1, (t, A))
                                     .astype(np.float32)})
        msgs.extend(drain_builder_chunks(builder))
    return msgs[:n]


def _stacked_chunks(n, rng, k=8):
    out = []
    for _ in range(n):
        batch = _batch(rng, k)
        out.append({"payload": batch,
                    "priorities": rng.uniform(0.1, 2, k).astype(np.float32),
                    "n_trans": k})
    return out


@pytest.mark.parametrize("pixels", [False, True],
                         ids=["stacked-continuous", "frame-pool-pixels"])
def test_fused_steps_match_the_jax_core(pixels, monkeypatch):
    b, k_steps = 8, 3
    shape = (6, 6, 1)
    kw = (dict(obs_shape=(6, 6, 4), obs_is_image=True, scale_uint8=True)
          if pixels else {})
    jm, params, pm = _models(False, **kw)
    jopt = jax_losses.make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
    opt = losses.make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
    rng = np.random.default_rng(7)
    if pixels:
        pool_kw = dict(capacity=32, frame_shape=shape, frame_stack=4,
                       extra_spec=(("a_mu", (T, A)),))
        jreplay, replay = JaxPool(**pool_kw), FramePoolReplay(**pool_kw)
        jrs, rs = jreplay.init(), replay.init("cpu")
        msgs = _pixel_chunks(2 + 2 * k_steps, rng, shape)
    else:
        jreplay, replay = JaxDeviceReplay(capacity=32), DeviceReplay(32)
        example = {k: v[0] for k, v in _batch(rng, 1).items()}
        jrs = jreplay.init(jax.tree.map(jnp.asarray, example))
        rs = replay.init(example, "cpu")
        msgs = _stacked_chunks(2 + 2 * k_steps, rng)
    jcore = jax_aql.AQLCore(model=jm, replay=jreplay, optimizer=jopt,
                            batch_size=b, target_update_interval=2)
    # the jitted steps donate the state: the draws keep their own params
    jts = JaxTrainState(params=jax.tree.map(jnp.copy, params),
                        target_params=jax.tree.map(jnp.copy, params),
                        opt_state=jopt.init(params), step=jnp.int32(0))
    ts = TrainState(params=pm,
                    target_params=copy.deepcopy(pm).requires_grad_(False),
                    opt_state=opt.init(pm), step=0)
    calls = []
    real = frame_pool_module.gather_stacks
    monkeypatch.setattr(frame_pool_module, "gather_stacks",
                        lambda *a: calls.append(a[1].shape) or real(*a))

    def jchunk(msg):
        return jax.tree.map(jnp.asarray, msg["payload"])

    for msg in msgs[:2]:
        jrs = jcore.ingest(jrs, jchunk(msg), jnp.asarray(msg["priorities"]))
        replay.add(rs, msg["payload"], msg["priorities"])
    keys = jax.random.split(jax.random.key(13), 2 * k_steps)
    fused = jcore.jit_fused_step()
    k_samples, draws = update_draws(jm, params, keys)
    port_core = port_aql.AQLCore(replay=replay, optimizer=opt, batch_size=b,
                                 target_update_interval=2, draws=draws)
    jmetrics, metrics = [], []
    for i, msg in enumerate(msgs[2:2 + k_steps]):          # one by one
        jts, jrs, jm_ = fused(jts, jrs, jchunk(msg),
                              jnp.asarray(msg["priorities"]), keys[i],
                              jnp.float32(0.4))
        offsets = _t(jax.random.uniform(k_samples[i], (b,), jnp.float32))
        ts, rs, m = port_core.fused_step(ts, rs, msg["payload"],
                                         msg["priorities"], offsets, 0.4)
        jmetrics.append(jm_)
        metrics.append(m)
    rest = msgs[2 + k_steps:]                          # one scan dispatch
    stack = jax.tree.map(lambda *x: jnp.stack(x), *[jchunk(m) for m in rest])
    jts, jrs, jstacked = jcore.jit_fused_multi_step()(
        jts, jrs, stack, jnp.stack([jnp.asarray(m["priorities"])
                                    for m in rest]), keys[k_steps:],
        jnp.float32(0.4))
    offsets = torch.stack([_t(jax.random.uniform(k, (b,), jnp.float32))
                           for k in k_samples[k_steps:]])
    ts, rs, stacked = port_core.fused_multi_step(
        ts, rs, [m["payload"] for m in rest],
        [m["priorities"] for m in rest], offsets, 0.4)
    assert not draws.noise_keys                       # every draw consumed
    assert ts.step == int(jts.step) == 2 * k_steps
    for name in ("loss", "loss_proposal", "grad_norm", "q_mean", "td_mean"):
        got = [m[name].item() for m in metrics] + stacked[name].tolist()
        want = ([float(m[name]) for m in jmetrics]
                + np.asarray(jstacked[name]).tolist())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(rs.sum_tree.numpy(), np.asarray(jrs.sum_tree),
                               rtol=1e-5)
    assert (rs.pos, rs.size) == (int(jrs.pos), int(jrs.size))
    if pixels:
        assert calls == [(2 * b, 4)] * (2 * k_steps)
        np.testing.assert_array_equal(rs.extras["a_mu"].numpy(),
                                      np.asarray(jrs.extras["a_mu"]))
    # Adam normalizes each step to about lr (1e-3) whatever the gradient's
    # size, so f32 round-off in a near-zero gradient element shows in the
    # weights at a small fraction of one step: atol 1e-5
    jparams, jtarget = jax.device_get((jts.params, jts.target_params))
    for mod, tree in ((ts.params, jparams), (ts.target_params, jtarget)):
        want = params_from_flax(tree)
        for name, p in mod.state_dict().items():
            _close(p, want[name], rtol=0, atol=1e-5, what=name)


# -- drivers on the CPU -------------------------------------------------------

def _cfg(env_id="ApexContinuousNav-v0", capacity=512, batch_size=16,
         **aql):
    cfg = small_test_config(capacity=capacity, batch_size=batch_size,
                            n_actors=1, env_id=env_id)
    return cfg.replace(
        aql=dataclasses.replace(cfg.aql, propose_sample=T_P,
                                uniform_sample=T_U, **aql),
        env=dataclasses.replace(cfg.env, frame_stack=4),
        learner=dataclasses.replace(cfg.learner, ingest_chunk=16))


@pytest.mark.parametrize("env_id", ["ApexContinuousNav-v0",
                                    "ApexCartPole-v0"])
def test_aql_trainer_mechanics(env_id):
    t = port_aql.AQLTrainer(_cfg(env_id, cosine_lr_steps=100), device="cpu")
    assert t.model.discrete == (env_id == "ApexCartPole-v0")
    t.train(total_frames=200, log_every=10)
    assert t.frames_rate.total == 200
    assert t.steps_rate.total == t.train_state.step > 0
    assert t.train_state.opt_state.q.count == t.steps_rate.total
    assert t.ingested == t.replay_state.size > 0
    for name in ("loss", "loss_proposal", "grad_norm", "q_mean", "td_mean"):
        values = [v for _, v in t.log.history[f"learner/{name}"]]
        assert values and np.all(np.isfinite(values)), name
    assert np.isfinite(t.evaluate(episodes=1, max_steps=50))


def _learner_steps(trainer, k):
    for _ in range(k):
        trainer.train_state, trainer.replay_state, _ = \
            trainer.core.train_step(
                trainer.train_state, trainer.replay_state,
                stratified_offsets(trainer.core.batch_size,
                                   trainer.generator, trainer.device), 0.5)


def assert_aql_learners_equal(a, b):
    for mod_a, mod_b in ((a.train_state.params, b.train_state.params),
                         (a.train_state.target_params,
                          b.train_state.target_params)):
        for (name, x), y in zip(mod_a.state_dict().items(),
                                mod_b.state_dict().values()):
            assert torch.equal(x, y), name
    assert a.train_state.step == b.train_state.step
    for group in ("q", "proposal"):
        oa = getattr(a.train_state.opt_state, group)
        ob = getattr(b.train_state.opt_state, group)
        assert oa.count == ob.count
        for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
            assert torch.equal(x, y), group
    for f in dataclasses.fields(a.replay_state):
        x, y = getattr(a.replay_state, f.name), getattr(b.replay_state,
                                                        f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys() and all(
                torch.equal(x[k], y[k]) for k in x), f.name
        else:
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_aql_trainer_checkpoint_round_trip_and_evaluate(tmp_path):
    cfg = _cfg()
    t1 = port_aql.AQLTrainer(cfg, device="cpu", checkpoint_dir=str(tmp_path))
    t1.train(total_frames=150, log_every=10 ** 9)
    assert t1.steps_rate.total > 0
    path = t1.save_checkpoint()
    t2 = port_aql.AQLTrainer(cfg, device="cpu")
    t2.restore(path)
    assert (t2.steps_rate.total, t2.ingested, t2.frames_rate.total) == (
        t1.steps_rate.total, t1.ingested, t1.frames_rate.total)
    assert_aql_learners_equal(t1, t2)
    for t in (t1, t2):
        _learner_steps(t, 3)
    assert_aql_learners_equal(t1, t2)
    score = evaluate_checkpoint(path, episodes=2, max_steps=30, device="cpu")
    assert -150.0 < score <= 0.0                   # -|position| per step


def _segments():
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-"))


def test_aql_apex_trainer_trains_on_pixels_with_an_actor_process(
        monkeypatch):
    """One spawned vector worker (2 envs) ships frame chunks with ``a_mu``
    sidecars over the shm ring; the pipelined learner samples each batch
    with one ``gather_stacks`` call and the sidecar rows beside it."""
    calls = []
    real = frame_pool_module.gather_stacks
    monkeypatch.setattr(frame_pool_module, "gather_stacks",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    cfg = _cfg("ApexCatchSmall-v0", capacity=1024)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, publish_interval=3),
        actor=dataclasses.replace(cfg.actor, n_envs_per_actor=2,
                                  update_interval=8, timing_interval=16))
    t = port_aql.AQLApexTrainer(cfg, device="cpu", publish_min_seconds=0.05)
    from apex_tpu_torch.actors.aql import vector_aql_worker_main
    assert t.pool._worker_fn is vector_aql_worker_main
    assert isinstance(t.replay, FramePoolReplay)
    assert t.replay.extra_spec == (("a_mu", (T_P + 3, 1)),)   # clamped U
    # Merging is opportunistic: the staging thread merges the chunks that
    # wait when it polls.  Hold its first poll until two chunks wait, so
    # the warm-up merge does not hang on the actor outrunning the thread.
    real_poll = t.pool.poll_chunks
    held, primed = [], []

    def poll_chunks(max_chunks, timeout=0.0):
        if not primed:
            deadline = time.monotonic() + 60.0
            while len(held) < 2 and time.monotonic() < deadline:
                held.extend(real_poll(2 - len(held), timeout=0.05))
            primed.append(True)
        out = held[:max_chunks]
        del held[:len(out)]
        if len(out) < max_chunks:
            out += real_poll(max_chunks - len(out),
                             timeout=0.0 if out else timeout)
        return out

    monkeypatch.setattr(t.pool, "poll_chunks", poll_chunks)
    t.train(total_steps=8, max_seconds=120)
    assert t.steps == t.train_state.step == 8
    assert calls == [(2 * 16, 4)] * 8
    assert t.pool.chunk_plane == "shm"
    assert t.param_version >= 2
    assert t._pipeline_last_stats["merged_chunks"] >= 2
    a_mu = t.replay_state.extras["a_mu"][:t.replay_state.size]
    assert bool((a_mu[:, :3, 0].sort(dim=1).values
                 == torch.arange(3.0)).all())      # distinct uniform draws
    assert not any(p.is_alive() for p in t.pool.procs)
    assert _segments() == []
    assert np.isfinite(t.evaluate(episodes=1, max_steps=50))


class ListPool:
    """Messages ready from the start, with the pool interface the
    trainers drive; an empty poll waits out its timeout."""

    def __init__(self, msgs):
        self._msgs = list(msgs)
        self.procs = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        pass

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        if not out and timeout:
            time.sleep(timeout)
        return out


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_aql_apex_trainer_scan_dispatch(pipelined):
    """``scan_steps`` 4 on stacked continuous messages: once warm, the
    trainer runs ``fused_multi_step`` dispatches of four AQL updates, on
    the serial drain and through the staging thread alike."""
    cfg = _cfg(capacity=1024)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, scan_steps=4,
                                    ingest_pipeline=pipelined))
    rng = np.random.default_rng(8)
    msgs = []
    for _ in range(24):
        batch = _batch(rng, 16)
        batch["obs"] = rng.uniform(-2, 2, (16, 2)).astype(np.float32)
        batch["next_obs"] = rng.uniform(-2, 2, (16, 2)).astype(np.float32)
        msgs.append({"payload": batch, "n_trans": 16,
                     "priorities": rng.uniform(0.1, 2, 16).astype(
                         np.float32)})
    t = port_aql.AQLApexTrainer(cfg, pool=ListPool(msgs), device="cpu",
                                publish_min_seconds=10.0,
                                respawn_workers=False)
    t.train(total_steps=12, max_seconds=60, log_every=1)
    assert t.steps == t.train_state.step == 12
    assert t.dispatches["scan"] >= 2
    assert t.train_state.opt_state.proposal.count == 12
    assert np.isfinite(t.log.history["learner/loss_proposal"][-1][1])


def test_aql_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (port_aql.AQLTrainer, port_aql.AQLApexTrainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(_cfg())


@pytest.mark.slow
def test_aql_learns_continuous_nav():
    """The counterpart of ``tests/test_aql.py``'s learning test (slow
    there too): the port's AQL beats random play on ContinuousNav
    (random returns about -40; competent proposals reach > -20)."""
    cfg = small_test_config(capacity=8192, batch_size=64,
                            env_id="ApexContinuousNav-v0")
    cfg = cfg.replace(aql=dataclasses.replace(
        cfg.aql, propose_sample=16, uniform_sample=32,
        q_lr=1e-3, proposal_lr=1e-3))
    t = port_aql.AQLTrainer(cfg, device="cpu")
    t.epsilon.decay = 1500.0
    before = t.evaluate(episodes=5, max_steps=50)
    t.train(total_frames=6000)
    after = t.evaluate(episodes=5, max_steps=50)
    assert after > -20.0, f"eval {before} -> {after}: AQL not learning"
    assert after > before + 5.0, f"no improvement: {before} -> {after}"
