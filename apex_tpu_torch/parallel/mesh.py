"""The dp group of the sharded learner: its ranks, their devices, their
collectives and, on rank 0, the processes of the other ranks.

Counterpart of :mod:`apex_tpu.parallel.mesh`.  The JAX learner is one
program over a ``Mesh`` whose collectives (``pmean``, ``pmax``) ride ICI
inside the compiled step.  Here each rank is a process with its own
replay shard and its own copy of the weights, and the collectives are
explicit calls on two ``torch.distributed`` process groups:

* the **dp group** carries the collectives over the learner's device
  tensors: one SUM all-reduce of one flat bucket per update (the
  gradients and the step's metrics, divided by the world size after it)
  in place of the pytree ``pmean`` that XLA fuses into one all-reduce, a
  MAX all-reduce of the IS normalizer in place of ``pmax``, and
  broadcasts of rank 0's state.  Its backend is the caller's choice:
  ``"nccl"`` with one card per rank (rank r on ``cuda:r``), or
  ``"gloo"``, with which every rank takes rank 0's card (gloo stages CUDA
  tensors through host memory, so ranks can share one device, which NCCL
  refuses);
* the **host group** is always gloo, over host tensors: rank 0's ops and
  the chunks of the other ranks (:meth:`DpGroup.send_ops`).

The collectives call the process group objects' own ``allreduce`` /
``broadcast`` / ``scatter`` / ``allgather`` / ``send`` / ``recv`` and wait
on their ``Work``, so the same code
runs on groups :func:`init_dp` builds over a store and on bare groups
built by several threads of one process over a ``HashStore`` (the tests'
ranks).  No group is registered with ``torch.distributed``'s default-group
machinery: one process may hold several.

Replay shards move between ranks as tensors, never through the op
channel: :meth:`DpGroup.gather_tensors` streams every rank's tensors into
rank 0's host tensors, and :meth:`DpGroup.scatter_tensors` streams rank
0's host tensors into each rank's, one tensor and one slice of at most
:data:`TRANSFER_BYTES` at a time over the host group, so neither side
holds a second copy of a shard (checkpoints of a sharded learner).

A group never picks a backend or a device its caller did not ask for:
NCCL with fewer cards than ranks raises, naming gloo, and only a caller
that passes ``device="cpu"`` runs on the CPU.

:class:`RankProcesses` is rank 0's handle on ranks 1..N-1: spawned
processes that rendezvous on a ``TCPStore`` hosted by rank 0 on a free
port, report readiness, errors and final stats through it, and are
stopped (terminated if they do not exit) by :meth:`RankProcesses.stop`.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.runtime import wire

#: seconds a collective waits for a peer before it raises (both groups)
DEFAULT_TIMEOUT_S = 120.0
#: loopback: every rank of a group runs on rank 0's host
HOST = "127.0.0.1"
#: bytes of one slice of a shard transfer (a send / recv of the host group)
TRANSFER_BYTES = 64 * 2 ** 20
#: seconds between a parked rank's looks at the store
PARK_POLL_S = 0.05


def check_backend(world: int, backend: str,
                  device: str | torch.device) -> None:
    """Raise unless ``backend`` can run ``world`` ranks from rank 0's
    ``device``: gloo anywhere, NCCL on cards only and with a card per
    rank.  No other backend is picked in its place."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown dp backend {backend!r} (nccl or gloo)")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"dp backend {backend!r} on the CPU: only gloo "
                             f"runs on host tensors (backend='gloo', "
                             f"--dp-backend gloo)")
        return
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"dp backend 'nccl' puts each of the {world} ranks on a card "
            f"of its own and sees {torch.cuda.device_count()}; NCCL refuses "
            f"two ranks on one device.  Pass backend='gloo' "
            f"(--dp-backend gloo) to run the ranks on one card")


def rank_device(rank: int, backend: str,
                base: str | torch.device = "cuda") -> torch.device:
    """The device of ``rank``: the CPU only when ``base`` is the CPU (the
    caller asked for it), else ``cuda:rank`` under NCCL and ``base``, rank
    0's card, under gloo."""
    base = torch.device(base)
    if base.type == "cpu" or backend == "gloo":
        return base
    return torch.device("cuda", rank)


@dataclass
class DpGroup:
    """One rank's view of the dp group: ``rank`` of ``world``, on
    ``device``, with the ``dp`` process group (device-tensor collectives)
    and the ``host`` one (gloo, host tensors).  ``stats`` counts the
    update all-reduces and their host-clock seconds (the wait included,
    so on a card it also holds the time the step's backward pass took to
    drain), and the bytes rank 0 scattered."""

    rank: int
    world: int
    device: torch.device
    dp: Any
    host: Any
    store: Any = None
    stats: dict = field(default_factory=lambda: {
        "allreduce_calls": 0, "allreduce_s": 0.0, "allreduce_bytes": 0,
        "max_calls": 0, "ops_sent": 0, "op_bytes": 0,
        "transfer_bytes": 0})

    # -- the dp group ------------------------------------------------------

    def _all_reduce(self, tensor: torch.Tensor, op) -> None:
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        self.dp.allreduce([tensor], opts).wait()

    @torch.no_grad()
    def all_reduce_mean_(self, tensors: list[torch.Tensor]) -> None:
        """Replace each of ``tensors`` (f32, on this rank's device) by its
        mean over the ranks: one flat bucket, one SUM all-reduce, one
        divide by the world size, copied back in place."""
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("all_reduce_mean_ takes f32 tensors, got "
                             f"{sorted({str(t.dtype) for t in tensors})}")
        t0 = time.perf_counter()
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(flat, dist.ReduceOp.SUM)
        flat.div_(self.world)
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
        self.stats["allreduce_calls"] += 1
        self.stats["allreduce_s"] += time.perf_counter() - t0
        self.stats["allreduce_bytes"] += 4 * off

    @torch.no_grad()
    def all_reduce_max_(self, scalar: torch.Tensor) -> torch.Tensor:
        """``scalar`` replaced in place by its max over the ranks (the IS
        weights' normalizer); returned for chaining."""
        self._all_reduce(scalar.reshape(1), dist.ReduceOp.MAX)
        self.stats["max_calls"] += 1
        return scalar

    @torch.no_grad()
    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` on every rank with ``src``'s, one flat
        bucket per dtype."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            opts = dist.BroadcastOptions()
            opts.rootRank = src
            opts.rootTensor = 0
            self.dp.broadcast([flat], opts).wait()
            if self.rank != src:
                off = 0
                for t in group:
                    n = t.numel()
                    t.copy_(flat[off:off + n].view_as(t))
                    off += n

    @torch.no_grad()
    def all_gather_blocks(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's ``block`` (same shape and dtype on each), concatenated
        in rank order on every rank: each rank writes its block into zeros
        at its offset and one SUM all-reduce adds them.  Adding zeros is
        exact, and a SUM all-reduce runs on gloo's device tensors too."""
        n = block.shape[0]
        full = torch.zeros((self.world * n,) + tuple(block.shape[1:]),
                           dtype=block.dtype, device=block.device)
        full[self.rank * n:(self.rank + 1) * n] = block
        self._all_reduce(full, dist.ReduceOp.SUM)
        return full

    def broadcast_module_(self, module: nn.Module, src: int = 0) -> None:
        """``src``'s parameters and buffers into ``module`` on every rank."""
        self.broadcast_(list(module.state_dict().values()), src)

    def close(self) -> None:
        """Release both groups' resources (NCCL's communicators among
        them); the group takes no collective after this."""
        for pg in (self.dp, self.host):
            shutdown = getattr(pg, "shutdown", None)
            if shutdown is not None:
                shutdown()

    # -- the host group: rank 0's ops --------------------------------------

    def _host_broadcast(self, tensor: torch.Tensor) -> None:
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        opts.rootTensor = 0
        self.host.broadcast([tensor], opts).wait()

    def send_ops(self, msgs: list) -> None:
        """Rank 0: hand ``msgs[r]`` to rank r, for r >= 1 (``msgs[0]`` is
        not sent).  A message is a dict of numbers, strings, numpy arrays
        and bytes (the wire's pickle, which :meth:`recv_op` reads with the
        wire's allowlist).  Two collectives: the lengths, then one scatter
        of byte buffers padded to the longest."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 sends ops")
        bufs = [b""] + [wire.dumps(m) for m in msgs[1:]]
        lens = torch.tensor([len(b) for b in bufs], dtype=torch.int64)
        self._host_broadcast(lens)
        width = int(lens.max())
        inputs = []
        for b in bufs:
            t = torch.zeros(width, dtype=torch.uint8)
            if b:
                t[:len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
            inputs.append(t)
        out = torch.empty(width, dtype=torch.uint8)
        opts = dist.ScatterOptions()
        opts.rootRank = 0
        self.host.scatter([out], [inputs], opts).wait()
        self.stats["ops_sent"] += 1
        self.stats["op_bytes"] += int(lens.sum())

    def all_gather_host(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's host ``tensor`` (same shape and dtype on each),
        stacked ``[world, ...]`` in rank order, on every rank (one gloo
        all-gather of the host group)."""
        tensor = tensor.contiguous()
        out = [torch.empty_like(tensor) for _ in range(self.world)]
        self.host.allgather([out], [tensor]).wait()
        return torch.stack(out)

    def _slices(self, t: torch.Tensor):
        if not t.is_contiguous():
            raise ValueError("a shard transfer takes contiguous tensors")
        flat = t.reshape(-1)
        step = max(1, TRANSFER_BYTES // max(1, t.element_size()))
        for a in range(0, flat.numel(), step):
            yield a, min(flat.numel(), a + step)

    @torch.no_grad()
    def gather_tensors(self, tensors: list[torch.Tensor],
                       out: list[torch.Tensor] | None = None) -> None:
        """Every rank's ``tensors`` (same shapes and dtypes, in the same
        order, on any device) into rank 0's ``out``: host tensors shaped
        ``[world, *t.shape]``, row r rank r's.  Tensor by tensor, slice by
        slice over the host group: a rank copies one slice to the host and
        sends it, rank 0 receives it into its place in ``out`` and copies
        its own rows in place, so no side holds a second copy."""
        for i, t in enumerate(tensors):
            if self.rank == 0:
                dst = out[i]
                if tuple(dst.shape) != (self.world,) + tuple(t.shape):
                    raise ValueError(
                        f"gather_tensors: out[{i}] of shape "
                        f"{tuple(dst.shape)} for a tensor of shape "
                        f"{tuple(t.shape)} on {self.world} ranks")
                for a, b in self._slices(t):
                    dst[0].reshape(-1)[a:b].copy_(t.reshape(-1)[a:b])
                for r in range(1, self.world):
                    row = dst[r].reshape(-1)
                    for a, b in self._slices(t):
                        part = row[a:b]
                        self.host.recv([part], r, i).wait()
                        self.stats["transfer_bytes"] += (
                            part.numel() * part.element_size())
            else:
                for a, b in self._slices(t):
                    part = t.reshape(-1)[a:b].to("cpu").contiguous()
                    self.host.send([part], 0, i).wait()

    @torch.no_grad()
    def scatter_tensors(self, tensors: list[torch.Tensor],
                        stacked: list[torch.Tensor] | None = None) -> None:
        """The reverse of :meth:`gather_tensors`: rank 0's host
        ``stacked[i][r]`` into rank r's ``tensors[i]`` for r >= 1, in place
        on its device, slice by slice.  Rank 0's own ``tensors`` only give
        the shapes; row 0 stays where it is."""
        for i, t in enumerate(tensors):
            if self.rank == 0:
                src = stacked[i]
                if tuple(src.shape) != (self.world,) + tuple(t.shape):
                    raise ValueError(
                        f"scatter_tensors: stacked[{i}] of shape "
                        f"{tuple(src.shape)} for a tensor of shape "
                        f"{tuple(t.shape)} on {self.world} ranks")
                for r in range(1, self.world):
                    row = src[r].reshape(-1)
                    for a, b in self._slices(t):
                        part = row[a:b].contiguous()
                        self.host.send([part], r, i).wait()
                        self.stats["transfer_bytes"] += (
                            part.numel() * part.element_size())
            else:
                flat = t.reshape(-1)
                for a, b in self._slices(t):
                    part = torch.empty(b - a, dtype=t.dtype)
                    self.host.recv([part], 0, i).wait()
                    flat[a:b].copy_(part)

    # -- parking: ranks between rank 0's sessions -------------------------

    def park(self, gen: int, record: str) -> None:
        """Ranks >= 1: leave ``record`` under ``parked/<gen>/<rank>`` in the
        group's store, then wait for rank 0's :meth:`wake` of ``gen``,
        polling the store.  A parked rank waits in no collective, so it
        waits as long as rank 0 pleases; if rank 0's store goes away the
        poll raises."""
        self.store.set(f"parked/{gen}/{self.rank}", record)
        key = f"wake/{gen}"
        while not self.store.check([key]):
            time.sleep(PARK_POLL_S)

    def parked_records(self, gen: int, timeout_s: float,
                       check: Callable[[], None] | None = None
                       ) -> dict[int, str]:
        """Rank 0: wait until every other rank has parked under ``gen``
        (``check()``, when given, runs between looks and may raise) and
        return their records."""
        keys = [f"parked/{gen}/{r}" for r in range(1, self.world)]
        deadline = time.monotonic() + timeout_s
        while not self.store.check(keys):
            if check is not None:
                check()
            if time.monotonic() > deadline:
                raise TimeoutError(f"dp ranks not parked after {timeout_s} s")
            time.sleep(PARK_POLL_S / 5)
        return {r: self.store.get(k).decode()
                for r, k in enumerate(keys, start=1)}

    def wake(self, gen: int) -> None:
        """Rank 0: send the ranks parked under ``gen`` back to their op
        loop."""
        self.store.set(f"wake/{gen}", "1")

    def recv_op(self) -> dict:
        """Ranks >= 1: the next message of :meth:`send_ops`."""
        lens = torch.empty(self.world, dtype=torch.int64)
        self._host_broadcast(lens)
        out = torch.empty(int(lens.max()), dtype=torch.uint8)
        opts = dist.ScatterOptions()
        opts.rootRank = 0
        self.host.scatter([out], [], opts).wait()
        n = int(lens[self.rank])
        return wire.restricted_loads(out[:n].numpy().tobytes())


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def _gloo(store, rank: int, world: int, timeout_s: float):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = _timeout(timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=HOST)]
    return dist.ProcessGroupGloo(store, rank, world, opts)


def _nccl(store, rank: int, world: int, timeout_s: float):
    pg_nccl = getattr(dist, "ProcessGroupNCCL", None)
    if pg_nccl is None:
        raise RuntimeError("this torch build has no NCCL: pass "
                           "backend='gloo' (--dp-backend gloo)")
    opts = pg_nccl.Options()
    opts._timeout = _timeout(timeout_s)
    return pg_nccl(store, rank, world, opts)


def init_dp(world: int, rank: int, *, backend: str = "nccl", store=None,
            timeout: float = DEFAULT_TIMEOUT_S,
            device: str | torch.device | None = None) -> DpGroup:
    """Join the dp group as ``rank`` of ``world`` over ``store`` (a
    ``TCPStore`` every rank reaches, or one ``HashStore`` shared by the
    threads of one process; world 1 may omit it).  ``backend`` is the dp
    group's: ``"nccl"`` puts rank r on ``cuda:r`` and raises when there
    are fewer cards than ranks; ``"gloo"`` puts every rank on ``device``
    (default ``"cuda"``, the current card).  ``device="cpu"`` runs on
    host tensors (gloo only).  ``timeout`` is each collective's, in
    seconds.  Blocks until every rank has joined."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    base = torch.device("cuda" if device is None else device)
    check_backend(world, backend, base)
    if base.type == "cuda":
        from apex_tpu_torch import resolve_device
        base = resolve_device(base)
    dev = rank_device(rank, backend, base)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if store is None:
        if world != 1:
            raise ValueError(f"a world of {world} needs a store every rank "
                             f"reaches")
        store = dist.HashStore()
    dp_store = dist.PrefixStore("apex-dp", store)
    host_store = dist.PrefixStore("apex-host", store)
    dp_pg = (_nccl(dp_store, rank, world, timeout) if backend == "nccl"
             else _gloo(dp_store, rank, world, timeout))
    host_pg = _gloo(host_store, rank, world, timeout)
    return DpGroup(rank=rank, world=world, device=dev, dp=dp_pg,
                   host=host_pg, store=store)


# -- rank processes ----------------------------------------------------------

def _rank_main(target: Callable, args: tuple, rank: int, world: int,
               port: int, timeout_s: float) -> None:
    """A spawned rank's entry: connect to rank 0's store and run
    ``target(store, rank, world, *args)``; an exception is written to the
    store for rank 0 to raise, then re-raised (exit code 1)."""
    store = dist.TCPStore(HOST, port, world, False,
                          timeout=_timeout(timeout_s))
    try:
        target(store, rank, world, *args)
    except BaseException as exc:
        store.set(f"error/{rank}", f"{type(exc).__name__}: {exc}"[:4000])
        raise


class RankProcesses:
    """Rank 0's handle on ranks 1..``world``-1: a ``TCPStore`` hosted
    here on a free port and one spawned process per rank running
    ``target(store, rank, world, *args)`` (a module-level function).  A
    rank sets ``ready/<rank>`` when it is about to join the groups, and
    may leave ``stats/<rank>`` (JSON) before it exits."""

    def __init__(self, world: int, target: Callable, args: tuple = (),
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.world = world
        self.store = dist.TCPStore(HOST, 0, world, True,
                                   timeout=_timeout(timeout_s),
                                   wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, name=f"apex-dp-rank{rank}",
                        args=(target, args, rank, world, self.store.port,
                              timeout_s), daemon=True)
            for rank in range(1, world)]
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.stop(0.0)          # the ones already started
            raise

    def failures(self) -> list[str]:
        """One line per rank process that exited or reported an error."""
        out = []
        for rank, p in enumerate(self.procs, start=1):
            key = f"error/{rank}"
            if self.store.check([key]):
                out.append(f"dp rank {rank}: "
                           f"{self.store.get(key).decode(errors='replace')}")
            elif not p.is_alive():
                out.append(f"dp rank {rank} exited (code {p.exitcode})")
        return out

    def check(self) -> None:
        """Raise when a rank process is gone or failed."""
        bad = self.failures()
        if bad:
            raise RuntimeError("; ".join(bad))

    def wait_ready(self, timeout_s: float) -> None:
        """Block until every rank is ready to join; raise if one fails or
        ``timeout_s`` passes first."""
        keys = [f"ready/{rank}" for rank in range(1, self.world)]
        deadline = time.monotonic() + timeout_s
        while not self.store.check(keys):
            self.check()
            if time.monotonic() > deadline:
                raise TimeoutError(f"dp ranks not ready after {timeout_s} s")
            time.sleep(0.05)

    def rank_stats(self) -> dict[int, dict]:
        """The ``stats/<rank>`` records the ranks left."""
        out = {}
        for rank in range(1, self.world):
            key = f"stats/{rank}"
            if self.store.check([key]):
                out[rank] = json.loads(self.store.get(key))
        return out

    def stop(self, timeout_s: float = 30.0) -> None:
        """Join every rank process, terminating (then killing) those still
        alive after ``timeout_s``; none outlives this call."""
        deadline = time.monotonic() + timeout_s
        started = [p for p in self.procs if p.pid is not None]
        for p in started:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in started:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)

    def alive(self) -> list[int]:
        return [rank for rank, p in enumerate(self.procs, start=1)
                if p.is_alive()]


def per_rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generators, derived from the run's:
    rank 0 keeps ``seed``, the others get seeds of their own."""
    return (int(seed) + 1_000_003 * rank) % 2 ** 64
