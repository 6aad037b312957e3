"""THE tenant namespace: qualified ids, param topics, and TenantSpec.

Counterpart of :mod:`apex_tpu.tenancy.namespace` (stdlib only).  Every
plane the fleet shares — replay shards hashing chunk ids, infer shards
coalescing requests, the registry keying peers, the param channel
tagging publishes — agrees on ONE id grammar::

    peer identity   tenant/actor-3          (default tenant: actor-3)
    chunk id        tenant/actor-3:17       (identity + ":" + sequence)
    param topic     apxt/tenant|<pickle>    (default tenant: bare pickle)

and this module is the one place that grammar is constructed: a plane
that wants a tenant-qualified id calls :func:`qualify` /
:func:`chunk_id` / :func:`param_topic`, and a plane that wants the
tenant back calls :func:`split` / :func:`tenant_of`.  The grammar can
never fork, so the crc32 chunk hash partitions per tenant for free (a
tenant prefix makes every tenant's chunk-id population disjoint) and
"which tenant does this peer belong to" is a parse, not a lookup.

Default-tenant transparency: the default tenant ``"t0"`` qualifies to
the BARE id and the EMPTY topic — a fleet that never sets
``APEX_TENANT`` produces byte-identical wire traffic, identities and
chunk ids to a single-tenant fleet.

Its readers in the port: the fleet registry and the SLO engine's
``@tenant`` signal paths, the param channel's tenant topics
(:mod:`apex_tpu_torch.runtime.transport`), the replay shards' tenant
partitions, the infer server's tenant entries, the roles' qualified
identities and the placement scheduler
(:mod:`apex_tpu_torch.tenancy.scheduler`, ``--role tenant-ctl``).
:func:`load_roster` folds the ``APEX_POPULATION`` lineages
(:mod:`apex_tpu_torch.population.lineage`) into the roster.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from dataclasses import dataclass

#: the implicit tenant every single-tenant fleet runs as: qualifies to the
#: bare id / empty topic, so single-tenant paths stay byte-identical
DEFAULT_TENANT = "t0"

#: id grammar separators (module docstring); names may use neither
_SEP = "/"
_TOPIC_HEAD = "apxt" + _SEP
_TOPIC_TAIL = "|"
_FORBIDDEN = (_SEP, _TOPIC_TAIL, ":")


def valid_name(tenant: str) -> bool:
    """A usable tenant name: nonempty, and free of the grammar's own
    separators (a tenant named ``a/b`` would parse as someone else)."""
    return bool(tenant) and not any(c in tenant for c in _FORBIDDEN)


def _check(tenant: str) -> str:
    if not valid_name(tenant):
        raise ValueError(f"invalid tenant name {tenant!r} — names must be "
                         f"nonempty and contain none of {_FORBIDDEN}")
    return tenant


def current_tenant(environ=None) -> str:
    """This process's tenant (``APEX_TENANT``; empty/unset = the default
    tenant) — env-driven like the chaos config, so a whole tenant's
    roles opt in with one export and zero flag plumbing."""
    e = os.environ if environ is None else environ
    t = str(e.get("APEX_TENANT", "")).strip()
    return _check(t) if t else DEFAULT_TENANT


def is_default(tenant: str) -> bool:
    return tenant == DEFAULT_TENANT


def qualify(tenant: str, base: str) -> str:
    """Tenant-qualified peer identity.  THE construction site for the
    ``tenant/base`` join; default tenant passes through so
    single-tenant identities — and everything hashed off them — stay
    bit-identical."""
    if is_default(tenant):
        return base
    return _check(tenant) + _SEP + base


def split(identity: str) -> tuple[str, str]:
    """``(tenant, base)`` of a possibly-qualified identity; unqualified
    ids belong to the default tenant."""
    if _SEP in identity:
        tenant, base = identity.split(_SEP, 1)
        if valid_name(tenant):
            return tenant, base
    return DEFAULT_TENANT, identity


def tenant_of(id_str: str) -> str:
    """The owning tenant of a peer identity OR a chunk id (chunk ids are
    ``identity:seq``, so the identity parse covers both)."""
    return split(id_str)[0]


def base_of(identity: str) -> str:
    return split(identity)[1]


def chunk_id(identity: str, seq: int) -> str:
    """Canonical chunk id: ``identity:seq``.  The identity is already
    tenant-qualified (or default-bare), so the crc32 shard hash sees
    per-tenant-disjoint id populations with no extra machinery — and
    the replay shards recover the tenant with :func:`tenant_of`."""
    return f"{identity}:{seq}"


def param_topic(tenant: str) -> bytes:
    """Param-channel frame prefix for a tenant's publishes
    (``apxt/<tenant>|`` + pickle).  The default tenant publishes BARE
    pickles — byte-identical to the single-tenant wire — and non-default
    SUB sockets subscribe exactly this prefix, so a subscriber pointed
    at the wrong tenant's endpoint receives NOTHING rather than
    silently acting on another tenant's params."""
    if is_default(tenant):
        return b""
    return (_TOPIC_HEAD + _check(tenant) + _TOPIC_TAIL).encode()


def strip_topic(topic: bytes, payload: bytes) -> bytes | None:
    """The pickle bytes behind a topic-tagged frame, or None when the
    frame is not this topic's (a mis-wired endpoint's traffic — the
    caller counts and drops).  The ``apxt/`` head is RESERVED: a
    bare-topic (default tenant) subscriber drops tagged frames by
    grammar instead of feeding another tenant's prefix to the
    unpickler."""
    head = _TOPIC_HEAD.encode()
    if not topic:
        return None if payload.startswith(head) else payload
    if payload.startswith(topic):
        return payload[len(topic):]
    return None


def shard_in_band(key: str, band) -> int:
    """Stable hash of ``key`` onto an explicit shard band (the placement
    scheduler's weighted assignments): same crc32 the unbanded planes
    use, modulo the band instead of the whole tier."""
    band = list(band)
    if not band:
        raise ValueError("empty shard band")
    return band[zlib.crc32(key.encode()) % len(band)]


# -- the admission unit ------------------------------------------------------


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's admission record (module docstring).

    ``replay_quota`` bounds the tenant's RESIDENT transitions per replay
    shard (0 = unlimited): a full partition refuses further ingest
    (counted, acked — the sender's credit window never wedges the shared
    plane) instead of letting one tenant starve the others' device memory.
    ``weight`` sizes the tenant's shard/infer bands in the scheduler's
    weighted assignment; ``accel`` marks conv-heavy tenants the
    placement brain prefers to land on accelerator-backed hosts (toy
    tenants fill the CPU spares).  ``learner_ip``/``param_port``/
    ``status_port`` locate the tenant's OWN learner (0 = the shared
    config's default port): the infer shards subscribe its param channel
    there, and tenant-ctl probes its status port for liveness and SLO
    state."""

    name: str
    env_id: str = "ApexCartPole-v0"
    family: str = "dqn"
    learner_ip: str = "127.0.0.1"
    param_port: int = 0
    status_port: int = 0
    replay_quota: int = 0
    weight: float = 1.0
    accel: bool = False

    def __post_init__(self) -> None:
        _check(self.name)
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown TenantSpec fields {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_roster(environ=None) -> dict[str, TenantSpec]:
    """The fleet's tenant roster (``APEX_TENANTS``, JSON list of
    :class:`TenantSpec` dicts) as ``name -> spec``; empty when unset.
    The default tenant needs no roster entry — it is the fleet that was
    already there — but MAY carry one (quota/weight for the shared
    planes).

    Population lineages (``APEX_POPULATION``,
    :mod:`apex_tpu_torch.population.lineage`) fold in as tenants: each
    lineage is a tenant, so the shared planes admit a population with
    one export; an explicit ``APEX_TENANTS`` entry of the same name
    wins."""
    e = os.environ if environ is None else environ
    raw = str(e.get("APEX_TENANTS", "")).strip()
    out: dict[str, TenantSpec] = {}
    if raw:
        specs = [TenantSpec.from_dict(d) for d in json.loads(raw)]
        for spec in specs:
            if spec.name in out:
                raise ValueError(
                    f"duplicate tenant {spec.name!r} in roster")
            out[spec.name] = spec
    pop_raw = str(e.get("APEX_POPULATION", "")).strip()
    if pop_raw:
        # imported here: population builds on this module (a LineageSpec
        # is a TenantSpec), so the dependency runs at call time only
        from apex_tpu_torch.population.lineage import parse_population
        for name, lineage in parse_population(pop_raw).items():
            out.setdefault(name, lineage.as_tenant())
    return out


def tenant_comms(comms, spec: TenantSpec):
    """The shared config re-pointed at one tenant's learner endpoint
    (spec ports of 0 inherit the shared defaults) — what the infer
    shards' per-tenant param subscribers and tenant-ctl's status probes
    connect through."""
    return dataclasses.replace(
        comms, learner_ip=spec.learner_ip,
        param_port=spec.param_port or comms.param_port,
        status_port=spec.status_port or comms.status_port)
