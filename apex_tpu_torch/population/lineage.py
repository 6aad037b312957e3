"""Lineage = tenant + a mutable hyperparameter vector.

Counterpart of :mod:`apex_tpu.population.lineage` (stdlib only).  The
Ape-X epsilon ladder is a degenerate population: one lineage, a spectrum
of exploration hyperparameters.  The general form adds TASKS (the roster
assigns env ids per lineage, so one fleet mixes Catch, Rally, ...) and
LINEAGES (each with its own learner fleet, whose hyperparameters evolve
through the exploit/explore decisions of
:mod:`apex_tpu_torch.population.controller`).

:class:`LineageSpec` extends :class:`~apex_tpu_torch.tenancy.namespace.
TenantSpec`, so a lineage IS a tenant: its roles qualify their wire
identities, chunk ids and param topics off ``APEX_TENANT=<lineage>``, the
shared replay shards build it a quota-bounded partition, the infer shards
hold its params and the registry labels its peers.  The extra fields are
the mutable vector (lr, n-step, priority exponent and beta, epsilon base)
and the ``parent``/``generation`` bookkeeping.

A population lineage is not a chunk lineage: :mod:`apex_tpu_torch.obs.
spans` calls the per-chunk trail of hop stamps a "lineage" too, as the
JAX package does.  The two share the word and nothing else.

A hyperparameter left ``None`` inherits the config, so a roster of one
lineage with no overrides configures exactly the plain single-tenant run.
``APEX_POPULATION`` carries the roster as JSON (a list of
:class:`LineageSpec` dicts); :func:`apex_tpu_torch.tenancy.namespace.
load_roster` folds it in, so lineages are admitted tenants everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

from apex_tpu_torch.tenancy import namespace

#: the mutable hyperparameter vector and its clamp bands — the space the
#: controller's perturb/resample explore moves through.  Bands follow
#: the PBT paper's practice (wide enough to matter, clamped so a run of
#: x1.2 perturbations cannot walk into a divergent regime); integer
#: bands (n_steps) perturb by +-1 instead of a factor.
HPARAM_BANDS: dict[str, tuple[float, float]] = {
    "lr": (1e-5, 1e-2),
    "n_steps": (1, 5),
    "prio_alpha": (0.4, 0.9),
    "prio_beta": (0.2, 0.8),
    "eps_base": (0.05, 0.7),
}

#: vector fields a LIVE learner absorbs mid-run
#: (:meth:`apex_tpu_torch.training.apex.ConcurrentTrainer.apply_hparams`:
#: lr swaps the optimizer's base rate, prio_beta re-points the IS-weight
#: anneal).  The rest shape acting-side programs — n-step chunk
#: assembly, insert-time priority exponents, the epsilon ladder — and
#: apply at role (re)spawn via :func:`apply_lineage`.
LIVE_HPARAMS = ("lr", "prio_beta")


@dataclass(frozen=True)
class LineageSpec(namespace.TenantSpec):
    """One lineage's admission record: the TenantSpec base (name, env
    id, family, learner endpoint, replay quota, band weight) plus the
    mutable hyperparameter vector and lineage ancestry."""

    # env_id redeclared with an INHERIT default ("" = the launching
    # config's env) so a no-override lineage spec leaves a plain run
    # untouched; as_tenant() restores the TenantSpec default for the
    # shared planes, which need a concrete env to size partitions
    env_id: str = ""
    lr: float | None = None
    n_steps: int | None = None
    prio_alpha: float | None = None
    prio_beta: float | None = None
    eps_base: float | None = None
    parent: str = ""
    generation: int = 0

    def hparams(self) -> dict:
        """The mutable vector (None = inherit the config default)."""
        return {k: getattr(self, k) for k in HPARAM_BANDS}

    def as_tenant(self) -> "LineageSpec":
        """The admission-plane view: the inherited env id defaulted so
        partition sizing never sees an empty one.  Still a LineageSpec
        (a LineageSpec IS a TenantSpec) — the replay shards read the
        hyperparameter vector too, so a lineage's partition is built
        with ITS priority exponent/beta, not the shared default's."""
        if self.env_id:
            return self
        return dataclasses.replace(self,
                                   env_id=namespace.TenantSpec.env_id)


def parse_population(raw: str) -> dict[str, LineageSpec]:
    """``name -> LineageSpec`` from the roster JSON (duplicate lineage
    names are a config error, the roster discipline)."""
    specs = [LineageSpec.from_dict(d) for d in json.loads(raw)]
    out: dict[str, LineageSpec] = {}
    for spec in specs:
        if spec.name in out:
            raise ValueError(
                f"duplicate lineage {spec.name!r} in population roster")
        out[spec.name] = spec
    return out


def load_population(environ=None) -> dict[str, LineageSpec]:
    """The fleet's lineage roster (``APEX_POPULATION``, JSON list of
    :class:`LineageSpec` dicts); empty when unset.  The default tenant
    MAY carry an entry — that is how a plain fleet joins a population
    as lineage zero."""
    e = os.environ if environ is None else environ
    raw = str(e.get("APEX_POPULATION", "")).strip()
    if not raw:
        return {}
    return parse_population(raw)


def apply_lineage(cfg, spec: LineageSpec):
    """The lineage's config: env id + hyperparameter vector applied to
    the role's :class:`~apex_tpu_torch.config.ApexConfig` — after this,
    ``make_env`` (host and on-device rollout paths alike), the n-step chunk assembly, the priority exponents, and the
    epsilon ladder all dispatch off the lineage.  A spec with no
    overrides returns ``cfg`` UNCHANGED (population-of-1 parity)."""
    out = cfg
    if spec.env_id and spec.env_id != cfg.env.env_id:
        out = out.replace(env=dataclasses.replace(out.env,
                                                  env_id=spec.env_id))
    learner = {}
    if spec.lr is not None:
        learner["lr"] = float(spec.lr)
    if spec.n_steps is not None:
        learner["n_steps"] = int(spec.n_steps)
    if learner:
        out = out.replace(learner=dataclasses.replace(out.learner,
                                                      **learner))
    replay = {}
    if spec.prio_alpha is not None:
        replay["alpha"] = float(spec.prio_alpha)
    if spec.prio_beta is not None:
        replay["beta"] = float(spec.prio_beta)
    if replay:
        out = out.replace(replay=dataclasses.replace(out.replay,
                                                     **replay))
    if spec.eps_base is not None:
        out = out.replace(actor=dataclasses.replace(
            out.actor, eps_base=float(spec.eps_base)))
    return out
