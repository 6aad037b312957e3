"""The infer-server role: request coalescing, one batched forward on the
card, params off the learner's channel, heartbeats.

Counterpart of :mod:`apex_tpu.infer_service.service`.  One ROUTER at
``infer_port + server_id`` takes every remote-policy actor's requests:

* ``("infer", msg)``: one half-group's stacked observations ``[n, ...]``,
  its epsilons, the vector step's seed and the group id.  The reply is
  ``("act", {...})`` with that group's actions and Q-values, stamped
  with the param version and learner epoch they were computed under.  A
  request that arrives while the server has no params gets
  ``("dry", {"rid": ...})``, so the client acts locally at once.

Coalescing: the first decoded request opens a window; the server keeps
reading until ``infer_batch_max`` requests are queued or
``infer_window_ms`` passed, groups the requests by observation shape
and runs each group as one forward of the
:class:`~apex_tpu_torch.models.dueling.DuelingDQN` on the card, over the
requests concatenated.  The request count pads to a power of two
(:func:`quantize_pow2`, repeating the last request; the padding's outputs
are dropped), so the forward sees a bounded set of batch shapes.

The exploration draws do not run on the card: for each request the
server rebuilds the group's generator from the step's seed and group id
(:func:`~apex_tpu_torch.actors.vector.group_generator`) and draws the
random actions and the epsilon coins on the CPU, in the order the actor's
local policy draws them (:func:`~apex_tpu_torch.models.dueling.
epsilon_greedy`).  The forward runs in the dtype of the actor's local
policy (the learner config's ``compute_dtype``).  On the CPU the remote
actions equal local acting bit for bit (``tests/test_torch_infer.py``);
on the card the Q-values differ from the actor's CPU forward in the last
places, so the greedy action can differ where the top two Q-values are
that close.

Params come from the learner's param channel (a CONFLATE subscriber, like
an actor's).  With ``comms.infer_device_params`` each publish is loaded
into the model on the card when it arrives; otherwise at the next
dispatch.  Replies carry the subscriber's ``learner_epoch`` so clients can
drop a dead life's stragglers.  The server beats heartbeats (role
``"infer"``) with its queue-depth and batch-size gauges to the learner.

Lineage and chaos: a request's spans are stamped ``infer_batch`` when it
joins a batch and ``infer_reply`` on the reply, which carries them back.
Under ``CHAOS_SEED`` the server's identity (``infer-<s>``) draws one
fate per request from its seeded stream (:class:`_RequestChaos`: a kill,
or a drop the client times out on), and a ``mute`` entry drops its
replies (``chaos_dropped`` / ``chaos_muted`` in its stats).

The version gate (:meth:`InferServer.apply_ctl`): the serving tier's
deployment controller (:mod:`apex_tpu_torch.serving.deploy`, ``--role
serve-ctl``) sends ``("ctl", body)`` frames on the same ROUTER, answered
``("ctl_ok", state)``.  A pinned shard holds (counts) every install
beyond its fence and serves what it has; ``freeze`` and ``canary`` keep a
copy of the weights the shard serves, and ``rollback`` loads that copy
back, bit for bit.  The model is loaded in place, so the copy is of the
loaded tensors (a pending publish is loaded first), never a reference.

Tenants: a roster tenant (``APEX_TENANTS``, population lineages
included) gets an entry of its own, with its own model, its own
subscriber on its learner's topic and its own pending publish.  Requests
coalesce by (tenant, observation shape), so a batch never runs under
another tenant's params; an unknown tenant is counted and answered dry.
The gate governs the default tenant only, as in the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import zmq

from apex_tpu_torch import resolve_device
from apex_tpu_torch.actors.vector import group_generator
from apex_tpu_torch.config import ApexConfig, CommsConfig
from apex_tpu_torch.fleet.chaos import _die, chaos_from_env
from apex_tpu_torch.infer_service.client import Window
from apex_tpu_torch.models.dueling import epsilon_greedy, load_host_params
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import get_ring, set_process_label
from apex_tpu_torch.runtime import transport, wire
from apex_tpu_torch.serving import fence
from apex_tpu_torch.tenancy import namespace as tenancy_ns


def quantize_pow2(n: int, cap: int) -> int:
    """Requests in one forward for ``n`` queued: the next power of two,
    capped at ``cap``."""
    n = max(1, min(int(n), int(cap)))
    p = 1
    while p < n:
        p *= 2
    return min(p, int(cap))


def make_batched_policy(model: torch.nn.Module):
    """``batched(obs, eps, seeds, groups) -> [(actions, q), ...]``: one
    forward of ``model`` over the requests' observations concatenated
    (``obs`` a list of ``[n_r, ...]`` arrays), then per request the
    epsilon-greedy draws from ``group_generator(seeds[r], groups[r])`` on
    the CPU.  Returns host arrays: int64 actions, f32 Q-values."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def batched(obs: list, eps: list, seeds: list, groups: list) -> list:
        stacked = torch.from_numpy(np.concatenate(obs))
        if device.type == "cuda":
            stacked = stacked.pin_memory().to(device, non_blocking=True)
        q_all = model(stacked).cpu()
        out, off = [], 0
        for o, e, seed, group in zip(obs, eps, seeds, groups):
            q = q_all[off:off + len(o)]
            off += len(o)
            actions = epsilon_greedy(q, torch.from_numpy(e),
                                     group_generator(seed, group))
            out.append((actions.numpy(), q.numpy()))
        return out

    return batched


class _RequestChaos:
    """The server's fault gate: one draw per decoded request off the
    seeded per-identity stream (:mod:`apex_tpu_torch.fleet.chaos`), so the
    server's kills and drops replay exactly, run after run."""

    def __init__(self, plan):
        self.plan = plan
        self._rng = plan.rng() if plan is not None else None
        self._n = 0
        self.dropped = 0

    def on_request(self) -> str:
        """"ok" or "drop"; a scheduled kill never returns."""
        if self.plan is None:
            return "ok"
        i = self._n
        self._n += 1
        if self.plan.kill_at is not None and i >= self.plan.kill_at:
            _die(self.plan.identity, i)
        if self._rng.random() < self.plan.drop_frac:
            self.dropped += 1
            return "drop"
        return "ok"


class InferServer:
    """The socket loop around one batched policy (module docstring).  One
    thread owns the ROUTER, the param subscriber and the dispatches."""

    def __init__(self, comms: CommsConfig, model: torch.nn.Module,
                 server_id: int = 0, bind_ip: str = "*",
                 heartbeat: bool = True, sub=None, port: int | None = None,
                 obs_shape: tuple | None = None):
        self.comms = comms
        # one stacked observation; a request of another shape is rejected
        # (None: the model's first layer decides)
        self.obs_shape = None if obs_shape is None else tuple(obs_shape)
        self.server_id = int(server_id)
        self.identity = f"infer-{server_id}"
        self.model = model
        self.device = next(model.parameters()).device
        self.batched = make_batched_policy(model)
        self.port = int(port) if port is not None else comms.infer_port
        self.sock = zmq.Context.instance().socket(zmq.ROUTER)
        transport._bind(self.sock, f"tcp://{bind_ip}:{self.port}")
        self.sub = sub
        self.has_params = False
        self._pending_params = None     # a publish not loaded yet
        self.param_version = 0
        self.learner_epoch = 0
        self.param_loads = 0
        # the version gate: while ``_pin`` holds a model fence, installs
        # beyond it are held; ``_incumbent`` is (version, weights, epoch),
        # a copy of the weights served when the gate stashed them
        self._pin: tuple | None = None
        self._incumbent: tuple | None = None
        self.held = 0                   # installs refused by the pin
        self.gate_rollbacks = 0         # restores that changed the model
        self.ctl_cmds = 0
        # non-default tenants: tenant -> entry (add_tenant)
        self.tenants: dict[str, dict] = {}
        self.unknown_tenant = 0
        self.requests = 0
        self.replies = 0
        self.dry_replies = 0            # requests answered before params
        self.rejected = 0               # payloads outside the allowlist
        self.dispatches = 0
        self.batch_hist = Window(4096)      # requests per dispatch
        self.coalesce_hist = Window(4096)   # receive -> reply, seconds
        self.dispatch_hist = Window(4096)   # forward + draws, seconds
        self._queue_depth = 0
        chaos = chaos_from_env()
        plan = chaos.plan_for(self.identity) if chaos is not None else None
        self.chaos = _RequestChaos(plan)
        self._mute = bool(plan is not None and plan.mute_replies)
        self.chaos_muted = 0
        self._hb = None
        self._hb_sender = None
        if heartbeat:
            from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
            self._hb_sender = transport.ChunkSender(comms, self.identity)
            self._hb = HeartbeatEmitter(
                self.identity, role="infer",
                interval_s=comms.heartbeat_interval_s,
                counters_fn=lambda: {"chunks_sent": self.replies,
                                     "acks_received": self.requests},
                gauges_fn=self.gauges)

    # -- params --------------------------------------------------------------

    def set_params(self, version: int, params, epoch: int = 0) -> None:
        """Install a host state dict (subscriber-fed, or direct from a
        test or a co-located trainer).  The gate acts here, before the
        pending slot is overwritten: a pinned shard holds (counts) an
        install beyond its fence."""
        eff_epoch = int(epoch) if epoch else self.learner_epoch
        if self._pin is not None and fence.beyond(eff_epoch, version,
                                                  self._pin):
            self.held += 1
            return
        self._pending_params = params
        self.has_params = True
        self.param_version = int(version)
        if epoch:
            self.learner_epoch = int(epoch)
        if self.comms.infer_device_params:
            self._load_pending()

    def _load_pending(self) -> None:
        if self._pending_params is not None:
            load_host_params(self.model, self._pending_params)
            self._pending_params = None
            self.param_loads += 1

    def _poll_params(self) -> None:
        if self.sub is not None:
            got = self.sub.poll(0)
            if got is not None:
                version, params = got
                self.set_params(version, params,
                                epoch=getattr(self.sub, "learner_epoch", 0))
        for tenant, entry in self.tenants.items():
            sub = entry["sub"]
            if sub is None:
                continue
            got = sub.poll(0)
            if got is not None:
                version, params = got
                self.set_tenant_params(tenant, version, params,
                                       epoch=getattr(sub, "learner_epoch",
                                                     0))

    # -- the serving tier's version gate (serving/deploy.py) ------------------

    def _serving_copy(self) -> dict:
        """A copy of the weights this shard serves: a pending publish is
        loaded first (the next dispatch would serve it), then the model's
        tensors are cloned."""
        self._load_pending()
        return {name: t.detach().clone()
                for name, t in self.model.state_dict().items()}

    def apply_ctl(self, body: dict) -> dict:
        """One deployment-controller command, applied on the socket
        thread.  Every command is idempotent: the controller reconciles
        each tick, so a respawned shard re-converges.

        * ``freeze``: stash the served weights (once) and pin at the
          shard's own fence.
        * ``pin``: hold installs beyond an explicit (epoch, version).
        * ``canary``: stash the served weights (once) and track the
          stream.
        * ``rollback``: load the stash back and pin at its fence; a shard
          with no stash serving beyond the given fence (a respawn that
          took the candidate) drops to dry replies, so clients act
          locally rather than on the rejected model.
        * ``promote``: clear the pin and the stash.
        * anything else: report the state only.
        """
        cmd = body.get("cmd")
        self.ctl_cmds += 1
        f = None
        if "epoch" in body or "version" in body:
            f = fence.fence_key(body.get("epoch"), body.get("version"))
        if cmd == "freeze":
            if self.has_params and self._incumbent is None:
                self._incumbent = (self.param_version, self._serving_copy(),
                                   self.learner_epoch)
            self._pin = fence.fence_key(self.learner_epoch,
                                        self.param_version)
        elif cmd == "pin" and f is not None:
            self._pin = f
        elif cmd == "canary":
            if self._incumbent is None and self.has_params:
                self._incumbent = (self.param_version, self._serving_copy(),
                                   self.learner_epoch)
            self._pin = None
        elif cmd == "rollback":
            if self._incumbent is not None:
                v, weights, e = self._incumbent
                if fence.beyond(self.learner_epoch, self.param_version,
                                (e, v)):
                    self.gate_rollbacks += 1    # the restore changed
                self._pending_params = None     # something
                self.model.load_state_dict(weights)
                self.has_params = True
                self.param_version, self.learner_epoch = int(v), int(e)
                self._incumbent = None
                self._pin = fence.fence_key(e, v)
            elif self._pin is not None and fence.at_or_before(
                    self.learner_epoch, self.param_version, self._pin):
                pass        # already rolled back, or frozen pre-candidate
            elif f is not None and self.has_params \
                    and fence.beyond(self.learner_epoch,
                                     self.param_version, f):
                self.has_params = False
                self._pending_params = None
                self._pin = f
            elif f is not None and self._pin is None:
                self._pin = f
        elif cmd == "promote":
            self._pin = None
            self._incumbent = None
        return self.ctl_state(rid=body.get("rid"))

    def ctl_state(self, rid=None) -> dict:
        """The gate's state for ctl replies and stats: plain builtins."""
        out = {"shard": self.server_id,
               "epoch": self.learner_epoch,
               "version": self.param_version,
               "pinned": self._pin is not None,
               "pin": list(self._pin) if self._pin is not None else None,
               "held": self.held,
               "rollbacks": self.gate_rollbacks,
               "has_incumbent": self._incumbent is not None,
               "has_params": self.has_params}
        if rid is not None:
            out["rid"] = rid
        return out

    # -- tenants -------------------------------------------------------------

    def add_tenant(self, tenant: str, model: torch.nn.Module,
                   sub=None) -> None:
        """Serve one more tenant: its own model (its env's geometry and
        action count) and, optionally, a subscriber on its learner's
        param topic.  Direct installs go through
        :meth:`set_tenant_params`."""
        if tenancy_ns.is_default(tenant):
            return                  # the default tenant is the server
        self.tenants[tenant] = {
            "model": model, "batched": make_batched_policy(model),
            "obs_shape": getattr(model, "obs_shape", None), "sub": sub,
            "pending": None, "has_params": False, "version": 0,
            "epoch": 0}

    def set_tenant_params(self, tenant: str, version: int, params,
                          epoch: int = 0) -> None:
        entry = self.tenants[tenant]
        entry["pending"] = params
        entry["has_params"] = True
        entry["version"] = int(version)
        if epoch:
            entry["epoch"] = int(epoch)
        if self.comms.infer_device_params:
            self._load_tenant(entry)

    def _load_tenant(self, entry: dict) -> None:
        if entry["pending"] is not None:
            load_host_params(entry["model"], entry["pending"])
            entry["pending"] = None
            self.param_loads += 1

    # -- serving -------------------------------------------------------------

    def step(self, timeout_ms: int = 100) -> int:
        """One poll, coalesce and dispatch round; returns requests
        served."""
        self._poll_params()
        if self._hb is not None:
            hb = self._hb.maybe_beat(self.param_version)
            if hb is not None:
                self._hb_sender.send_stat(hb)
        if not self.sock.poll(timeout_ms, zmq.POLLIN):
            return 0
        pending = self._coalesce()
        served = 0
        for group in self._group_by_shape(pending):
            served += self._dispatch(group)
        return served

    def _coalesce(self) -> list:
        """Read requests until ``infer_batch_max`` are queued or
        ``infer_window_ms`` passed since the first.  Returns
        ``[(ident, msg, recv_time), ...]``."""
        deadline = None
        out: list = []
        while len(out) < self.comms.infer_batch_max:
            wait_ms = 0
            if deadline is not None:
                wait_ms = max(0, int((deadline - time.monotonic()) * 1000))
            if not self.sock.poll(wait_ms, zmq.POLLIN):
                break
            frames = self.sock.recv_multipart()
            if len(frames) != 2:
                self.rejected += 1
                continue
            ident, payload = frames
            try:
                got = wire.restricted_loads(payload)
            except wire.WireRejected:
                self.rejected += 1      # counted, dropped, no reply
                continue
            if (isinstance(got, tuple) and len(got) == 2
                    and got[0] == "ctl" and isinstance(got[1], dict)):
                # a deployment-controller command: applied here, on the
                # socket thread, outside the batch window and the chaos
                # request stream
                self._reply(ident, ("ctl_ok", self.apply_ctl(got[1])))
                continue
            if not self._well_formed(got):
                self.rejected += 1
                continue
            if self.chaos.on_request() == "drop":
                continue                # unanswered: the client falls back
            self.requests += 1
            obs_spans.stamp(got[1], "infer_batch")
            out.append((ident, got[1], time.monotonic()))
            if deadline is None:
                deadline = (time.monotonic()
                            + self.comms.infer_window_ms / 1000.0)
        self._queue_depth = len(out)
        return out

    def _well_formed(self, got) -> bool:
        """An ``("infer", msg)`` whose fields the forward and the draws
        can take: an ``[n, *obs_shape]`` array (the tenant's shape), n
        epsilons, integer seed and group, and a tenant name if any."""
        if not (isinstance(got, tuple) and len(got) == 2
                and got[0] == "infer" and isinstance(got[1], dict)):
            return False
        msg = got[1]
        if not {"rid", "obs", "eps", "seed", "group"} <= msg.keys():
            return False
        tenant = msg.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            return False
        shape = self.obs_shape
        if tenant is not None and not tenancy_ns.is_default(tenant):
            entry = self.tenants.get(tenant)
            shape = None if entry is None else entry["obs_shape"]
        obs, eps = msg["obs"], msg["eps"]
        return (isinstance(obs, np.ndarray) and obs.ndim >= 2
                and (shape is None or obs.shape[1:] == shape)
                and isinstance(eps, np.ndarray)
                and eps.shape == (obs.shape[0],)
                and all(isinstance(msg[k], (int, np.integer))
                        for k in ("rid", "seed", "group")))

    @staticmethod
    def _tenant(msg: dict) -> str:
        return str(msg.get("tenant") or tenancy_ns.DEFAULT_TENANT)

    @staticmethod
    def _group_by_shape(pending: list) -> list[list]:
        """Requests of one tenant and one observation shape share a
        forward (one set of weights, one stacked geometry)."""
        by_key: dict[tuple, list] = {}
        for item in pending:
            by_key.setdefault((InferServer._tenant(item[1]),
                               item[1]["obs"].shape), []).append(item)
        return list(by_key.values())

    def _dry_group(self, group: list) -> int:
        """No params for this group's tenant: its clients act locally
        now rather than waiting out their timeout."""
        for ident, msg, _ in group:
            self.dry_replies += 1
            self._reply(ident, ("dry", {"rid": msg["rid"]}))
        return len(group)

    def _dispatch(self, group: list) -> int:
        """One forward over ``group`` (one tenant, one shape), padded to
        a power-of-two request count by repeating the last request."""
        tenant = self._tenant(group[0][1])
        if tenancy_ns.is_default(tenant):
            if not self.has_params:
                return self._dry_group(group)
            self._load_pending()
            batched = self.batched
            pv, epoch = self.param_version, self.learner_epoch
        else:
            entry = self.tenants.get(tenant)
            if entry is None:
                self.unknown_tenant += 1    # unadmitted: clients act
                return self._dry_group(group)   # locally
            if not entry["has_params"]:
                return self._dry_group(group)
            self._load_tenant(entry)
            batched = entry["batched"]
            pv, epoch = entry["version"], entry["epoch"]
        t0 = time.monotonic()
        n = len(group)
        width = quantize_pow2(n, self.comms.infer_batch_max)
        idx = list(range(n)) + [n - 1] * (width - n)
        msgs = [group[i][1] for i in idx]
        out = batched([m["obs"] for m in msgs],
                           [np.asarray(m["eps"], np.float32) for m in msgs],
                           [int(m["seed"]) for m in msgs],
                           [int(m["group"]) for m in msgs])
        now = time.monotonic()
        self.dispatches += 1
        self.batch_hist.record(n)
        self.dispatch_hist.record(now - t0)
        for (ident, msg, t_recv), (actions, q) in zip(group, out):
            self.coalesce_hist.record(max(0.0, now - t_recv))
            reply = {"rid": msg["rid"], "actions": actions, "q": q,
                     "pv": pv, "epoch": epoch}
            spans = msg.get(obs_spans.SPAN_KEY)
            if spans:
                obs_spans.stamp_spans(spans, "infer_reply")
                reply[obs_spans.SPAN_KEY] = spans
            self.replies += 1
            self._reply(ident, ("act", reply))
        return n

    def _reply(self, ident: bytes, msg) -> None:
        if self._mute:
            self.chaos_muted += 1       # the reply dies on the down link
            return
        try:
            self.sock.send_multipart([ident, wire.dumps(msg)], zmq.DONTWAIT)
        except zmq.Again:
            pass        # a gone client's reply may be dropped

    # -- lifecycle and observability -----------------------------------------

    def run(self, stop_event=None, max_seconds: float | None = None) -> dict:
        deadline = (None if max_seconds is None
                    else time.monotonic() + max_seconds)
        while not (stop_event is not None and stop_event.is_set()):
            if deadline is not None and time.monotonic() > deadline:
                break
            self.step()
        return self.stats()

    def gauges(self) -> dict:
        b = self.batch_hist
        return {"tenants": 1 + len(self.tenants),
                "backend_accel": float(self.device.type != "cpu"),
                "queue_depth": self._queue_depth,
                "batch_p50": b.percentile(50), "batch_p90": b.percentile(90),
                "coalesce_ms_p50": round(
                    self.coalesce_hist.percentile(50) * 1000.0, 3),
                "dispatch_ms_p50": round(
                    self.dispatch_hist.percentile(50) * 1000.0, 3),
                "requests": self.requests, "replies": self.replies,
                "dry_replies": self.dry_replies, "rejected": self.rejected,
                "serve_epoch": self.learner_epoch,
                "serve_version": self.param_version,
                "serve_pinned": int(self._pin is not None),
                "serve_held": self.held,
                "serve_rollbacks": self.gate_rollbacks}

    def stats(self) -> dict:
        return {"server": self.server_id,
                "param_version": self.param_version,
                "learner_epoch": self.learner_epoch,
                "param_loads": self.param_loads,
                "dispatches": self.dispatches,
                "chaos_dropped": self.chaos.dropped,
                "chaos_muted": self.chaos_muted,
                "ctl_cmds": self.ctl_cmds,
                "unknown_tenant": self.unknown_tenant,
                "dispatch_ms_mean": round(
                    1000.0 * float(np.mean(self.dispatch_hist._values))
                    if len(self.dispatch_hist) else 0.0, 3),
                "peak_bytes": (int(torch.cuda.max_memory_allocated(
                    self.device)) if self.device.type == "cuda" else 0),
                **self.gauges()}

    def close(self) -> None:
        self.sock.close(linger=0)
        if self._hb_sender is not None:
            self._hb_sender.close(drain_s=0.0)
        if self.sub is not None:
            self.sub.close()
        for entry in self.tenants.values():
            if entry["sub"] is not None:
                entry["sub"].close()


def dqn_policy_model(cfg: ApexConfig, device: torch.device | str = "cuda"):
    """The Q-network the server runs: the actors' spec
    (:func:`~apex_tpu_torch.training.apex.dqn_env_specs`, so the learner's
    ``compute_dtype``) on ``device``, its weights replaced by the first
    publish; ``model.obs_shape`` is the stacked observation it takes."""
    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.training.apex import dqn_env_specs

    spec = dqn_env_specs(cfg)[0]
    model = DuelingDQN(**spec, generator=torch.Generator().manual_seed(
        cfg.env.seed))
    model.obs_shape = tuple(spec["obs_shape"])
    model = model.to(resolve_device(device)).requires_grad_(False)
    # one forward before serving: the card's first call sets its
    # libraries up, which would otherwise cost the first requests their
    # wait
    with torch.no_grad():
        model(torch.zeros((1,) + tuple(spec["obs_shape"]), dtype=torch.uint8,
                          device=next(model.parameters()).device))
    return model


def run_infer_server(cfg: ApexConfig, family: str = "dqn",
                     server_id: int = 0, stop_event=None,
                     max_seconds: float | None = None, bind_ip: str = "*",
                     device: torch.device | str = "cuda") -> dict:
    """The ``--role infer`` entry point: the policy on ``device`` (the
    card by default), the param subscriber, serve until stopped.  Needs
    no startup barrier: actors act locally until it answers.  Returns the
    final stats."""
    from apex_tpu_torch.serving.shard import shard_port

    if family != "dqn":
        raise NotImplementedError(
            f"the inference plane serves the dqn family only (got "
            f"{family!r}); aql/r2d2 actors keep their local policies")
    n_shards = max(1, cfg.comms.infer_shards)
    set_process_label(f"infer-{server_id}")
    get_ring()                      # arm the trace ring's dump triggers
    if not 0 <= server_id < n_shards:
        raise ValueError(
            f"infer shard id {server_id} outside [0, {n_shards}): set "
            f"--infer-shards/APEX_INFER_SHARDS fleet-wide")
    model = dqn_policy_model(cfg, device)
    # the base subscriber serves the default tenant's channel (an explicit
    # empty topic, whatever APEX_TENANT says)
    sub = transport.ParamSubscriber(cfg.comms, topic=b"")
    try:
        server = InferServer(cfg.comms, model, server_id=server_id,
                             bind_ip=bind_ip, sub=sub,
                             port=shard_port(cfg.comms, server_id),
                             obs_shape=model.obs_shape)
    except BaseException:
        sub.close()
        raise
    # one model and one subscriber per roster tenant, on that tenant's
    # own learner endpoint and topic
    import dataclasses
    try:
        for tenant, spec in sorted(tenancy_ns.load_roster().items()):
            if spec.family != "dqn":
                print(f"infer-{server_id}: tenant {tenant!r} skipped "
                      f"(family {spec.family!r} is not served)", flush=True)
                continue
            tcfg = cfg.replace(env=dataclasses.replace(cfg.env,
                                                       env_id=spec.env_id))
            server.add_tenant(tenant, dqn_policy_model(tcfg, device),
                              sub=transport.ParamSubscriber(
                                  tenancy_ns.tenant_comms(cfg.comms, spec),
                                  topic=tenancy_ns.param_topic(tenant)))
    except BaseException:
        server.close()
        raise
    print(f"infer-{server_id}: serving on port {server.port} (shard "
          f"{server_id}/{n_shards}, tenants=1+{len(server.tenants)}, "
          f"batch_max={cfg.comms.infer_batch_max}, "
          f"window_ms={cfg.comms.infer_window_ms}, device={server.device}, "
          f"device_params={cfg.comms.infer_device_params})", flush=True)
    try:
        return server.run(stop_event=stop_event, max_seconds=max_seconds)
    finally:
        server.close()
