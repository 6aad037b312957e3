"""AQL: proposal-action Q-learning as a torch ``nn.Module``.

Counterpart of :class:`apex_tpu.models.aql.AQLNetwork` and
:func:`apex_tpu.models.aql.make_aql_policy_fn` (``aql.py:50-241``; read
the JAX module docstring for the method).  A state embedding feeds a
Gaussian proposal head (a Categorical one for discrete actions); each
state's candidate set is ``uniform_sample`` uniform draws followed by
``propose_sample`` proposal draws, scored by a Q head whose advantage MLP
is two :class:`~apex_tpu_torch.models.noisy.NoisyDense` layers.  Acting is
the argmax over the candidate scores, epsilon-greedy over the candidate
index.  Discrete candidates are ``[B, T, 1]`` float index values, the
same tensor contract as the continuous ``[B, T, A]``.

Kept from the JAX model, so both take the same inputs and weights:

* Layer names (``embed_hidden``, ``proposal_{hidden,mu}``,
  ``q_feature{1,2}``, ``action_embed{1,2}``, ``advantage{1,2}``); the
  ``embed``/``proposal`` prefixes name the proposal optimizer group
  (:func:`apex_tpu_torch.ops.losses.aql_param_labels`).
* Orthogonal init with ReLU gain and zero bias for the dense layers.
* Image observations are flattened in NHWC order (no conv trunk,
  ``aql.py:140-148``); u8 observations are scaled by 1/255 with
  ``scale_uint8``.
* ``compute_dtype`` matmuls (bf16 on the card) with f32 params; the
  proposal mean and the candidate scores come back in f32.

Where flax draws from the ``'sample'`` and ``'noise'`` PRNG collections,
this model takes its draws as tensors: :meth:`AQLNetwork.propose` a dict
of the proposal's raw draws, :meth:`AQLNetwork.score` the NoisyNet
normals of each noisy layer (``None``: mu-only).  :class:`AQLDraws` makes
them from a ``torch.Generator``; the parity tests replace it with one that
replays JAX's keyed draws.  Torch layers need their input widths up front,
so the constructor takes ``obs_shape`` (one stacked observation).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.models.dueling import _RELU_GAIN
from apex_tpu_torch.models.noisy import NoisyDense

#: the NoisyNet layers, in the order their noise is drawn
NOISY_LAYERS = ("advantage1", "advantage2")


class AQLNetwork(nn.Module):
    """Embedding trunk + proposal head + candidate-scoring Q head.

    ``action_dim`` is the Box action dimensionality, or the action count
    when ``discrete``; ``action_low``/``action_high`` bound the uniform
    candidates.  ``generator`` draws the init.
    """

    def __init__(self, action_dim: int, obs_shape: Sequence[int],
                 action_low: float = -1.0, action_high: float = 1.0,
                 discrete: bool = False, propose_sample: int = 100,
                 uniform_sample: int = 400, action_var: float = 0.25,
                 obs_is_image: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 scale_uint8: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        if discrete and uniform_sample > action_dim:
            # aql_model_spec clamps this (model.py:180-184)
            raise ValueError(
                f"discrete uniform_sample={uniform_sample} > action count "
                f"{action_dim}: distinct uniform draws are impossible — "
                f"clamp to the action count")
        self.action_dim = action_dim
        self.obs_shape = tuple(obs_shape)
        self.action_low, self.action_high = action_low, action_high
        self.discrete = discrete
        self.propose_sample, self.uniform_sample = propose_sample, \
            uniform_sample
        self.action_var = action_var
        self.obs_is_image = obs_is_image
        self.compute_dtype = compute_dtype
        self.scale_uint8 = scale_uint8
        obs_dim = math.prod(self.obs_shape)
        self.embed_hidden = nn.Linear(obs_dim, 128)
        self.proposal_hidden = nn.Linear(128, 128)
        self.proposal_mu = nn.Linear(128, action_dim)
        self.q_feature1 = nn.Linear(obs_dim, 64)
        self.q_feature2 = nn.Linear(64, 64)
        self.action_embed1 = nn.Linear(self.candidate_dim, 128)
        self.action_embed2 = nn.Linear(128, 64)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                nn.init.orthogonal_(module.weight, gain=_RELU_GAIN,
                                    generator=generator)
                nn.init.zeros_(module.bias)
        self.advantage1 = NoisyDense(128, 64, compute_dtype=compute_dtype,
                                     generator=generator)
        self.advantage2 = NoisyDense(64, 1, compute_dtype=compute_dtype,
                                     generator=generator)

    @property
    def total_sample(self) -> int:
        return self.propose_sample + self.uniform_sample

    @property
    def candidate_dim(self) -> int:
        """A candidate's trailing width: an index value (1) when
        ``discrete``, else the action dimensionality."""
        return 1 if self.discrete else self.action_dim

    # -- pieces ------------------------------------------------------------

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def _prep(self, obs: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if obs.dtype == torch.uint8 and self.scale_uint8:
            obs = obs.to(dt) / 255.0
        else:
            obs = obs.to(dt)
        if self.obs_is_image:
            obs = obs.reshape(obs.shape[0], -1)
        return obs

    def embed(self, obs: torch.Tensor) -> torch.Tensor:
        """128-d state embedding (``Q_Network.embedding_feature``)."""
        return torch.relu(self._dense(self.embed_hidden, self._prep(obs)))

    def proposal_mean(self, obs: torch.Tensor) -> torch.Tensor:
        """Gaussian mean of the proposal ``[B, A]``, f32; Categorical
        logits ``[B, n]`` when ``discrete``."""
        h = torch.relu(self._dense(self.proposal_hidden, self.embed(obs)))
        return self._dense(self.proposal_mu, h).float()

    def propose(self, obs: torch.Tensor, draws: dict) -> torch.Tensor:
        """The candidate set, uniform candidates first
        (``model.py:361-376`` order): ``[B, T, A]`` box points, or ``[B,
        T, 1]`` float index values when ``discrete``.  ``draws`` is
        :meth:`AQLDraws.proposal`'s dict: unit ``uniform [B, U, A]`` and
        ``normal [B, P, A]``; discrete, ``perm [B, n]`` (one permutation
        per row, its first U entries the distinct uniform indices) and
        ``gumbel [P, B, n]`` (the Categorical draw is the argmax of
        Gumbel noise plus logits, as ``jax.random.categorical``)."""
        mu = self.proposal_mean(obs)
        if self.discrete:
            a_uniform = draws["perm"][:, :self.uniform_sample]
            a_prop = (draws["gumbel"] + mu[None]).argmax(dim=-1).T
            a_mu = torch.cat([a_uniform, a_prop], dim=1)
            return a_mu.float()[..., None]
        low, high = self.action_low, self.action_high
        a_uniform = (draws["uniform"] * (high - low) + low).clamp_min(low)
        sigma = torch.tensor(self.action_var, dtype=torch.float32).sqrt()
        a_prop = mu[:, None, :] + sigma.item() * draws["normal"]
        return torch.cat([a_uniform, a_prop], dim=1)

    def score(self, obs: torch.Tensor, a_mu: torch.Tensor,
              noise: dict | None) -> torch.Tensor:
        """Q-values of every candidate, ``[B, T]`` f32 (the reference's
        ``repeat``/``reshape`` tiling as a broadcast, ``model.py:294-320``).
        ``noise`` maps each of :data:`NOISY_LAYERS` to its ``(z_in,
        z_out)`` normals (:meth:`AQLDraws.noise`); ``None`` scores with
        the mu weights."""
        b, t, _ = a_mu.shape
        qf = torch.relu(self._dense(self.q_feature2, torch.relu(
            self._dense(self.q_feature1, self._prep(obs)))))       # [B, 64]
        af = torch.relu(self._dense(self.action_embed2, torch.relu(
            self._dense(self.action_embed1, a_mu.reshape(b * t, -1)))))
        x = torch.cat([af.reshape(b, t, -1),
                       qf[:, None, :].expand(b, t, qf.shape[-1])], dim=-1)
        x = torch.relu(x).reshape(b * t, -1)
        adv = self.advantage2(
            torch.relu(self.advantage1(
                x, None if noise is None else noise["advantage1"])),
            None if noise is None else noise["advantage2"])
        return adv.reshape(b, t).float()

    def forward(self, obs: torch.Tensor, a_mu: torch.Tensor,
                noise: dict | None) -> torch.Tensor:
        return self.score(obs, a_mu, noise)

    def proposal_log_prob(self, obs: torch.Tensor, actions: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(log N(actions | mu(obs), action_var * I), entropy)`` per row;
        the Categorical log-pmf and entropy when ``discrete``
        (``AQL_dis.py:79-86``).  Continuous, the entropy is a constant:
        the covariance is fixed."""
        mu = self.proposal_mean(obs)
        if self.discrete:
            logp = torch.log_softmax(mu, dim=-1)                  # [B, n]
            idx = actions.reshape(actions.shape[0]).long()
            log_prob = logp.gather(1, idx[:, None])[:, 0]
            entropy = -(logp.exp() * logp).sum(dim=-1)
            return log_prob, entropy
        var = torch.tensor(self.action_var, dtype=torch.float32,
                           device=mu.device)
        d = self.action_dim
        log_prob = (-0.5 * ((actions - mu) ** 2).sum(dim=-1) / var
                    - 0.5 * d * torch.log(2 * math.pi * var))
        entropy = 0.5 * d * (1.0 + torch.log(2 * math.pi * var))
        return log_prob, entropy.expand(log_prob.shape)


class AQLDraws:
    """The AQL model's and policy's random draws from an explicit
    ``torch.Generator`` on its device: the proposal's raw draws, the
    NoisyNet normals and the epsilon-greedy draws.  A test replays
    another framework's draws by overriding the three methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def proposal(self, model: AQLNetwork, b: int) -> dict:
        """:meth:`AQLNetwork.propose`'s ``draws`` for a batch of ``b``."""
        g, dev = self.generator, self.device
        p, u = model.propose_sample, model.uniform_sample
        if model.discrete:
            n = model.action_dim
            perm = torch.rand((b, n), generator=g, device=dev).argsort(dim=1)
            tiny = torch.finfo(torch.float32).tiny
            unit = torch.rand((p, b, n), generator=g,
                              device=dev).clamp_min(tiny)
            return {"perm": perm, "gumbel": -torch.log(-torch.log(unit))}
        a = model.action_dim
        return {"uniform": torch.rand((b, u, a), generator=g, device=dev),
                "normal": torch.randn((b, p, a), generator=g, device=dev)}

    def noise(self, model: AQLNetwork) -> dict:
        """One NoisyNet draw: ``(z_in, z_out)`` standard normals per layer
        of :data:`NOISY_LAYERS`."""
        g, dev = self.generator, self.device
        out = {}
        for name in NOISY_LAYERS:
            layer = getattr(model, name)
            out[name] = (
                torch.randn(layer.in_features, generator=g, device=dev),
                torch.randn(layer.features, generator=g, device=dev))
        return out

    def explore(self, b: int, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The epsilon-greedy draws: ``u`` f32 ``[b]`` in [0, 1) (explore
        where ``u < epsilon``) and a random candidate index in ``[0, t)``
        per row."""
        g, dev = self.generator, self.device
        return (torch.rand(b, generator=g, device=dev),
                torch.randint(0, t, (b,), generator=g, device=dev))


def make_aql_policy_fn(model: AQLNetwork, deterministic: bool = False):
    """The acting step (``AQL.act``, ``model.py:198-205``): propose,
    score, epsilon-greedy over the candidate index.  ``policy(obs,
    epsilon, draws) -> (actions, idx, a_mu, q)`` with ``draws`` an
    :class:`AQLDraws` on the model's device; ``epsilon`` a float or a
    ``[B]`` tensor.  ``actions`` is the chosen candidate ``[B, A]``, or
    ``int32 [B]`` when ``discrete``; the actor stores ``idx`` and ``a_mu``
    so the learner re-scores the same set.  ``deterministic`` scores with
    the mu weights (the JAX evaluator's ``noisy_deterministic`` clone)."""

    @torch.no_grad()
    def policy(obs: torch.Tensor, epsilon, draws: AQLDraws):
        b = obs.shape[0]
        a_mu = model.propose(obs, draws.proposal(model, b))
        noise = None if deterministic else draws.noise(model)
        q = model.score(obs, a_mu, noise)
        greedy = q.argmax(dim=1)
        u, rand = draws.explore(b, model.total_sample)
        idx = torch.where(u < epsilon, rand, greedy)
        actions = a_mu[torch.arange(b, device=a_mu.device), idx]
        if model.discrete:
            actions = actions[:, 0].to(torch.int32)
        return actions, idx, a_mu, q

    return policy
