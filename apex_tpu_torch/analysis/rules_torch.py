"""T-series rules: eager-torch hazards, in place of ``rules_jax.py``.

Each T-rule stands for the J-rule of the same number in
:mod:`apex_tpu.analysis.rules_jax`, where the hazard exists in eager
torch on a CUDA card:

* T004 (J004, PRNG key reuse) — a random draw without an explicit
  ``generator=``: the port draws from explicit ``torch.Generator``\\ s (and
  numpy ``Generator``\\ s), so a draw from the global stream breaks the
  replayable seeding every parity test relies on.
* T006 (J006, host sync in a hot loop) — ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``float()``/``int()`` of a reduction, or
  ``torch.cuda.synchronize()`` inside a host loop: each drains the CUDA
  stream, serializing launches against the host.
* T008 (J008, eager materialize) — a step's result copied to the host
  more than one statement before its first use, in a loop: the sync runs
  before host work that could overlap the card.
* T009 (J009, a device array on an mp queue) — a CUDA tensor put on a
  multiprocessing queue: the pickle ships a CUDA IPC handle (or forces a
  copy), tying the consumer to the producer's allocation.
* T014 (J014, host numpy in a scanned env) — host numpy, ``.item()``,
  ``.cpu()`` or ``float()`` inside a device env's ``step``/``reset`` or
  the rollout engine's step (``envs/device_envs.py``,
  ``training/anakin.py``): a host round trip per env step.

The J-rules with no eager-torch counterpart today:

* J001 (jit without donation) — torch does not donate; the optimizer
  updates the parameters in place.
* J002 (host sync inside compiled code) — the port compiles nothing;
  its eager syncs are T006's.
* J003 (Python branch on a traced value) — an eager tensor is concrete;
  branching on it is a host sync, which T006 sees in loops.
* J005 (jit inside a loop) — no ``jax.jit`` and no ``torch.compile``.
* J007 (device_put inside jit) — no traced scope; ``.to()`` in eager
  code is an ordinary copy.
* J010 (host clock inside a jitted step) — eager code reads the clock
  when it runs, not once at trace time.
* J011 (sharding-annotation drift) — the port's sharded learner
  annotates nothing: each rank holds whole tensors and its collectives
  are explicit calls (:mod:`apex_tpu_torch.parallel.mesh`).

Each rule's behavioral contract is its fixture pair in
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import ast
import re

from apex_tpu_torch.analysis.core import (Finding, ModuleContext, Rule,
                                          call_name, register)

# -- shared helpers ---------------------------------------------------------

_NUMPY_ALIASES = {"np", "numpy", "onp"}
_TIMING_CALLS = {"perf_counter", "monotonic", "perf_counter_ns",
                 "monotonic_ns", "time", "time_ns"}
#: zero-argument tensor methods that copy a device value to the host
_HOST_METHODS = {"item", "cpu", "tolist", "numpy"}
#: reductions whose result ``float()``/``int()`` typically syncs
_REDUCTIONS = {"sum", "mean", "max", "min", "norm", "any", "all", "argmax",
               "argmin", "prod", "std", "var", "count_nonzero"}


def _attr_root(node: ast.AST) -> str | None:
    """Leftmost name of an attribute chain: ``torch.cuda.x`` -> torch."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _loops_between(ctx: ModuleContext, node: ast.AST):
    """Enclosing For/While nodes of ``node`` up to the enclosing function.
    A For whose ``iter``/``target`` holds the node doesn't count — that
    expression evaluates once, not per iteration."""
    out = []
    child = node
    for a in ctx.ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(a, (ast.For, ast.AsyncFor)):
            if child is not a.iter and child is not a.target:
                out.append(a)
        elif isinstance(a, ast.While):
            out.append(a)
        child = a
    return out


def _is_trace_context(expr: ast.AST) -> bool:
    """``with trace(...)`` / ``profiling.trace(...)`` / ``phase(...)`` —
    the sanctioned profiling and wait-accounting scopes."""
    if not isinstance(expr, ast.Call):
        return False
    name = call_name(expr) or ""
    return name in ("trace", "phase", "profile") or name.endswith("_trace")


def _in_scope(ctx: ModuleContext, node: ast.AST) -> bool:
    """Lexically under a profiling/timing ``with`` in its function."""
    for a in ctx.ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(a, (ast.With, ast.AsyncWith)):
            if any(_is_trace_context(item.context_expr) for item in a.items):
                return True
    return False


def _host_copy(call: ast.Call) -> str | None:
    """The spelling of a device->host copy, or None: ``x.item()``,
    ``x.cpu()``, ``x.tolist()``, ``x.numpy()``, ``float(<reduction>)`` /
    ``int(<reduction>)``, ``torch.cuda.synchronize()``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in _HOST_METHODS and not call.args and not call.keywords:
            return f".{f.attr}()"
        if f.attr == "synchronize" and _attr_root(f) == "torch":
            return "torch.cuda.synchronize()"
        return None
    if (isinstance(f, ast.Name) and f.id in ("float", "int")
            and len(call.args) == 1):
        for n in ast.walk(call.args[0]):
            if not isinstance(n, ast.Call):
                continue
            g = n.func
            if isinstance(g, ast.Attribute) and (
                    g.attr in _REDUCTIONS or _attr_root(g) == "torch"):
                return f"{f.id}() of a tensor reduction"
    return None


def _is_step_name(name: str) -> bool:
    """The learner's step family: names that run a training/fused/ingest
    step and return its device results."""
    n = name.lower().lstrip("_")
    if "ingest" in n:
        return True
    return "step" in n and any(t in n for t in
                               ("train", "fused", "update", "multi"))


# -- T004 -------------------------------------------------------------------

#: torch functions that draw from a random stream (all take generator=)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like"}
#: in-place tensor draws (all take generator=)
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
#: ``torch.nn.init`` draws (generator= since torch 2.4)
_INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "kaiming_uniform_",
               "kaiming_normal_", "xavier_uniform_", "xavier_normal_",
               "orthogonal_", "sparse_"}
#: ``np.random`` attributes that are not draws from the global stream
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "SFC64", "MT19937", "BitGenerator",
                 "RandomState"}


@register
class UnseededDraw(Rule):
    id = "T004"
    name = "draw-without-generator"
    why = ("A draw from the global stream cannot be replayed from the "
           "run's seed.")
    fix = ("Pass generator= (a torch.Generator seeded from the config), or "
           "draw from a numpy Generator.")
    description = ("a random draw without an explicit generator: "
                   "torch.rand/randn/randint/randperm/normal/bernoulli/"
                   "multinomial/poisson(_like), the in-place x.uniform_()/"
                   "normal_()/bernoulli_()... and torch.nn.init draws "
                   "without generator=, or a module-level np.random.* "
                   "draw.  The port draws from explicit torch.Generators "
                   "(JAX's explicit keys, J004's discipline): a draw from "
                   "the global stream is not replayable from the seed and "
                   "couples every module that touches it")

    @staticmethod
    def _kind(call: ast.Call) -> str | None:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        if any(k.arg == "generator" for k in call.keywords):
            return None
        root = _attr_root(f)
        chain = []
        n = f.value
        while isinstance(n, ast.Attribute):
            chain.append(n.attr)
            n = n.value
        if f.attr in _INIT_DRAWS and ("init" in chain or root == "init"):
            return f"nn.init.{f.attr}()"
        if f.attr in _TORCH_DRAWS and root == "torch" and not chain:
            return f"torch.{f.attr}()"
        if f.attr in _INPLACE_DRAWS and root != "torch":
            return f".{f.attr}()"
        if (root in _NUMPY_ALIASES and chain == ["random"]
                and f.attr not in _NP_RANDOM_OK):
            return f"np.random.{f.attr}()"
        return None

    def check(self, ctx: ModuleContext) -> list[Finding]:
        out = []
        for node in ctx.nodes(ast.Call):
            kind = self._kind(node)
            if kind is not None:
                out.append(ctx.finding(
                    self, node,
                    f"{kind} draws from the global random stream — pass "
                    f"generator= (an explicit torch.Generator) so the draw "
                    f"replays from the run's seed"))
        return out


# -- T006 -------------------------------------------------------------------


@register
class HostSyncInHotLoop(Rule):
    id = "T006"
    name = "host-sync-in-hot-loop"
    why = ("A device->host read in a loop drains the CUDA stream every "
           "iteration.")
    fix = ("Keep the value on the card; read it at log/episode boundaries "
           "or behind a PhaseTimer/trace scope.")
    description = (".item()/.cpu()/.tolist()/.numpy(), float()/int() of a "
                   "tensor reduction, or torch.cuda.synchronize() inside a "
                   "host loop outside profiling scopes and timing "
                   "harnesses: each one waits for every queued kernel, so "
                   "the host cannot run ahead of the card (the hazard "
                   "J006 names for block_until_ready/device_get)")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        out = []
        for node in ctx.nodes(ast.Call):
            kind = _host_copy(node)
            if kind is None:
                continue
            loops = _loops_between(ctx, node)
            if not loops or _in_scope(ctx, node):
                continue
            # a measurement harness: a loop that reads the clock fences
            # the card on purpose
            if any(isinstance(sub, ast.Call)
                   and call_name(sub) in _TIMING_CALLS
                   for loop in loops for sub in ast.walk(loop)):
                continue
            out.append(ctx.finding(
                self, node,
                f"{kind} inside a host loop — a device sync per "
                f"iteration; keep the value on the card and read it at a "
                f"log boundary, or wrap a deliberate wait in a "
                f"PhaseTimer.phase/trace scope"))
        return out


# -- T008 -------------------------------------------------------------------


@register
class EagerStepMaterialize(Rule):
    id = "T008"
    name = "eager-step-materialize"
    why = ("Copying a step's result to the host early blocks on the card "
           "before host work that could overlap it.")
    fix = "Materialize at the consumption site, not right after the step."
    description = (".item()/.cpu()/.tolist()/.numpy()/np.asarray()/"
                   "float()/int() of a train/fused/ingest step's result in "
                   "a loop, with the value first used more than one "
                   "statement later: the copy waits for the step's kernels "
                   "while the host work between could have run beside "
                   "them (the hazard J008 names for jitted results)")

    @staticmethod
    def _materializes(call: ast.Call, device_vars: set[str]) -> bool:
        f = call.func
        if (isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS
                and not call.args):
            srcs = [f.value]
        elif ((isinstance(f, ast.Attribute) and f.attr in ("asarray", "array")
               and _attr_root(f) in _NUMPY_ALIASES)
              or (isinstance(f, ast.Name) and f.id in ("float", "int"))):
            srcs = list(call.args)
        else:
            return False
        return any((isinstance(n, ast.Name) and n.id in device_vars)
                   or (isinstance(n, ast.Call)
                       and _is_step_name(call_name(n) or ""))
                   for s in srcs for n in ast.walk(s))

    @staticmethod
    def _position(ctx: ModuleContext, stmt: ast.AST):
        parent = ctx.parents.get(stmt)
        for field in ("body", "orelse", "finalbody"):
            seq = getattr(parent, field, None)
            if isinstance(seq, list) and stmt in seq:
                return seq, seq.index(stmt)
        return None, None

    def check(self, ctx: ModuleContext) -> list[Finding]:
        out: list[Finding] = []
        for fn in ctx.functions:
            device_vars: set[str] = set()
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and _is_step_name(call_name(node.value) or "")):
                    for t in node.targets:
                        device_vars.update(n.id for n in ast.walk(t)
                                           if isinstance(n, ast.Name))
            for stmt in ast.walk(fn):
                if (isinstance(stmt, ast.Assign)
                        and ctx.enclosing_function(stmt) is fn):
                    got = self._check_assign(ctx, stmt, device_vars)
                    if got is not None:
                        out.append(got)
        return out

    def _check_assign(self, ctx, stmt: ast.Assign, device_vars):
        values = (stmt.value.elts
                  if isinstance(stmt.value, (ast.Tuple, ast.List))
                  else [stmt.value])
        sync = next((c for c in values if isinstance(c, ast.Call)
                     and self._materializes(c, device_vars)), None)
        if sync is None or _in_scope(ctx, stmt):
            return None
        targets = {n.id for t in stmt.targets for n in ast.walk(t)
                   if isinstance(n, ast.Name)}
        seq, idx = self._position(ctx, stmt)
        if seq is None:
            return None
        for dist, later in enumerate(seq[idx + 1:], start=1):
            if any(isinstance(n, ast.Name) and n.id in targets
                   for n in ast.walk(later)):
                break
        else:
            return None
        if dist <= 1:
            return None                  # materialized at the use site
        if not (_loops_between(ctx, stmt)
                or isinstance(later, (ast.For, ast.AsyncFor, ast.While))):
            return None
        return ctx.finding(
            self, sync,
            f"step result copied to the host {dist} statements before its "
            f"first use — the copy waits on the card before host work it "
            f"could overlap; move it to the consumption site (or wrap a "
            f"deliberate wait in a PhaseTimer.phase scope)")


# -- T009 -------------------------------------------------------------------

_QUEUE_NAME_RE = re.compile(r"(queue|_q$|^q$)", re.IGNORECASE)
#: calls whose result is host data: putting it on a queue is fine
_T009_HOST = {"asarray", "array", "int", "float", "bool", "tolist", "item",
              "cpu", "numpy"}


def _makes_device_tensor(call: ast.Call) -> bool:
    """``x.cuda()``, ``x.to("cuda"...)``/``x.to(device)``, a torch factory
    with ``device=`` other than "cpu", or a step call's result."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "cuda":
        return True
    if isinstance(f, ast.Attribute) and f.attr == "to" and call.args:
        a = call.args[0]
        return not (isinstance(a, ast.Constant) and a.value == "cpu")
    dev = next((k.value for k in call.keywords if k.arg == "device"), None)
    if dev is not None and _attr_root(f) == "torch":
        return not (isinstance(dev, ast.Constant) and dev.value == "cpu")
    return _is_step_name(call_name(call) or "")


@register
class CudaTensorOnMpQueue(Rule):
    id = "T009"
    name = "cuda-tensor-on-mp-queue"
    why = ("Queue.put of a CUDA tensor ships an IPC handle tied to the "
           "producer's allocation, or a hidden copy.")
    fix = ".cpu() (or .numpy()) the tensor at the producer and enqueue host "
    "data."
    description = ("mp.Queue put of a tensor made on the card (.cuda(), "
                   ".to(device), a torch factory with device=, a step's "
                   "result) without a host copy: the pickle either sends "
                   "a CUDA IPC handle that keeps the producer's block "
                   "alive and breaks when the producer exits, or forces a "
                   "device->host copy and sync inside the worker loop "
                   "(the hazard J009 names for device arrays)")

    @staticmethod
    def _queue_put(call: ast.Call) -> bool:
        f = call.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("put", "put_nowait")):
            return False
        recv = f.value
        name = (recv.id if isinstance(recv, ast.Name)
                else recv.attr if isinstance(recv, ast.Attribute) else None)
        return bool(name and _QUEUE_NAME_RE.search(name))

    @staticmethod
    def _hosted(ctx: ModuleContext, name: ast.AST, put: ast.Call) -> bool:
        for a in ctx.ancestors(name):
            if a is put:
                return False
            if isinstance(a, ast.Call) and call_name(a) in _T009_HOST:
                return True
        return False

    def check(self, ctx: ModuleContext) -> list[Finding]:
        out = []
        for fn in ctx.functions:
            device_vars: set[str] = set()
            hosted: set[str] = set()
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                names = {n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)}
                if call_name(node.value) in _T009_HOST:
                    hosted |= names
                elif _makes_device_tensor(node.value):
                    device_vars |= names
            if not device_vars:
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call) and self._queue_put(node)):
                    continue
                bad = sorted({n.id for arg in node.args for n in ast.walk(arg)
                              if isinstance(n, ast.Name)
                              and n.id in device_vars - hosted
                              and not self._hosted(ctx, n, node)})
                if bad:
                    out.append(ctx.finding(
                        self, node,
                        f"tensor(s) {', '.join(bad)} made on the card put "
                        f"on an mp queue without a host copy — .cpu() at "
                        f"the producer and ship host data"))
        return out


# -- T014 -------------------------------------------------------------------

#: the modules whose env/rollout steps run on the card
_DEVICE_STEP_MODULES = ("envs/device_envs.py", "training/anakin.py")
#: the step entry points there; their same-module callees are in scope
_DEVICE_STEP_ROOTS = {"step", "_step", "reset"}


@register
class HostOpInDeviceEnvStep(Rule):
    id = "T014"
    name = "host-op-in-device-env-step"
    why = ("Host numpy or a host copy inside a device env step costs a "
           "round trip per env step.")
    fix = ("Express the step in torch ops on the env's device; hoist "
           "genuine host work out of the step.")
    description = ("np.* on data, .item()/.cpu()/.tolist()/.numpy(), or "
                   "float()/int()/bool() of a non-constant inside step/"
                   "_step/reset (or what they call) in the device env and "
                   "rollout modules (envs/device_envs.py, "
                   "training/anakin.py): the batched env and the rollout "
                   "engine run every lane on the card, and one host op "
                   "per step stalls all of them (the hazard J014 names "
                   "for scanned bodies)")

    _BUILTINS = {"float", "int", "bool"}

    @staticmethod
    def _static_arg(a: ast.AST) -> bool:
        """Constants, attribute chains (``self.grid``: static config) and
        tuples thereof."""
        if isinstance(a, ast.Constant):
            return True
        if isinstance(a, ast.Attribute):
            return _attr_root(a) is not None
        if isinstance(a, (ast.Tuple, ast.List)):
            return all(HostOpInDeviceEnvStep._static_arg(e) for e in a.elts)
        if isinstance(a, ast.UnaryOp):
            return HostOpInDeviceEnvStep._static_arg(a.operand)
        return False

    def _in_scope(self, ctx: ModuleContext) -> set:
        by_name: dict[str, list] = {}
        for fn in ctx.functions:
            by_name.setdefault(fn.name, []).append(fn)
        scoped = {fn for fn in ctx.functions
                  if fn.name in _DEVICE_STEP_ROOTS}
        todo = list(scoped)
        while todo:
            fn = todo.pop()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    for cand in by_name.get(call_name(node) or "", []):
                        if cand not in scoped:
                            scoped.add(cand)
                            todo.append(cand)
        return scoped

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if not ctx.path.replace("\\", "/").endswith(_DEVICE_STEP_MODULES):
            return []
        out = []
        seen: set = set()
        for fn in self._in_scope(ctx):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or node in seen:
                    continue
                seen.add(node)
                f = node.func
                what = None
                if (isinstance(f, ast.Attribute)
                        and _attr_root(f) in _NUMPY_ALIASES
                        and not all(self._static_arg(a) for a in node.args)):
                    what = f"np.{f.attr}()"
                elif (isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS
                        and not node.args):
                    what = f".{f.attr}()"
                elif (isinstance(f, ast.Name) and f.id in self._BUILTINS
                        and node.args
                        and not all(self._static_arg(a) for a in node.args)):
                    what = f"{f.id}()"
                if what is not None:
                    out.append(ctx.finding(
                        self, node,
                        f"{what} in '{fn.name}', a device env/rollout step "
                        f"— a host round trip per env step; keep it a "
                        f"torch op on the env's device"))
        return out
