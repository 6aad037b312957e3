"""The reference's own run of a recurrent learner's first steps.

Replay rebuilt from the pooled sequence messages the actors shipped:
each message carries its frames once (``frames [Kf, D]``, row 0 the zero
frame every padded step names) and, per sequence, its ``[T]`` frame
rows (``obs_ref``), actions, rewards, discounts, masks, the stored state
``state_c``/``state_h`` and, for a model fed them, ``prev_action``/
``prev_reward``.  Sequences take replay slots in arrival order from the
cursor, modulo the capacity; a sequence is read from its own message.
A sequence whose frames have left the ring (more than ``f_capacity``
frame rows written since its message) is redirected to the newest
slot, as the program's ring would.

The follow mirrors :mod:`portbench.reference.follow` for the recurrent
family: the same messages, trees, stratified sample (its own draw at the
first step, the program's rows after), batch and IS weights; then the
sequence loss (:func:`portbench.reference.r2d2.sequence_loss`) and clip
+ Adam.  ``variant`` puts one of the planted faults in the reference.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from portbench.reference import r2d2 as net
from portbench.reference.per import (Trees, is_weights, stratified_sample,
                                     tree_priority)

BATCH_KEYS = ("obs", "action", "reward", "discount", "mask", "state_c",
              "state_h", "prev_action", "prev_reward")


class SeqReplay:
    """Sequence slots filled from messages in order."""

    def __init__(self, capacity: int, f_capacity: int, frame_shape,
                 alpha: float, eps: float, device):
        self.capacity, self.f_capacity = capacity, f_capacity
        self.frame_shape = tuple(frame_shape)
        self.alpha, self.eps, self.device = alpha, eps, device
        self.trees = Trees(capacity, device)
        self.slots: dict[int, tuple[int, int, int]] = {}
        self.messages: list[dict] = []
        self.pos = self.size = self.f_epoch = 0

    def ingest(self, payload: dict, priorities) -> None:
        j = len(self.messages)
        self.messages.append(payload)
        n = int(payload["n_seqs"])
        slots = [(self.pos + i) % self.capacity for i in range(n)]
        for i, s in enumerate(slots):
            self.slots[s] = (j, i, self.f_epoch)
        prios = torch.as_tensor(np.asarray(priorities, np.float32)[:n])
        self.trees.set(torch.tensor(slots),
                       tree_priority(prios, self.alpha, self.eps))
        self.pos = (self.pos + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        self.f_epoch += int(payload["n_frames"])

    def resolve(self, idx) -> list[int]:
        """Sampled slots, stale ones redirected to the newest."""
        newest = (self.pos - 1) % self.capacity
        return [i if self.f_epoch - self.slots[i][2] <= self.f_capacity
                else newest for i in (int(x) for x in np.asarray(idx))]

    def batch(self, idx) -> dict:
        """The sequences at slots ``idx`` as device tensors, ``obs [B, T,
        *frame]`` u8."""
        cols: dict[str, list] = {k: [] for k in BATCH_KEYS}
        for s in self.resolve(idx):
            j, i, _ = self.slots[s]
            m = self.messages[j]
            frames = np.asarray(m["frames"])[np.asarray(m["obs_ref"][i])]
            cols["obs"].append(frames.reshape((-1,) + self.frame_shape))
            for k in BATCH_KEYS[1:]:
                if k in m:
                    cols[k].append(np.asarray(m[k])[i])
        out = {k: torch.as_tensor(np.stack(v)).to(self.device)
               for k, v in cols.items() if v}
        for k in ("reward", "discount", "mask", "state_c", "state_h",
                  "prev_reward"):
            if k in out:
                out[k] = out[k].float()
        return out


def _replay(run: dict, device) -> SeqReplay:
    hp = run["hp"]
    return SeqReplay(hp["capacity"], hp["f_capacity"], run["frame_shape"],
                     hp["alpha"], hp["eps"], device)


def bf16_quant(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to bfloat16, straight through for the gradient: what
    autocast hands a bfloat16 matmul or convolution."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


def _catch_up(rep: SeqReplay, msgs, st: dict, k: int) -> None:
    """Ingest messages until the replay's cursor and size are the
    program's at step ``k``'s sample (``st["ingested"]`` is its cursor)."""
    while (rep.pos, rep.size) != (st["ingested"], st["size"]):
        try:
            payload, prios = next(msgs)
        except StopIteration:
            raise ValueError(f"step {k + 1}: the messages end before the "
                             f"cursor {st['ingested']}") from None
        rep.ingest(payload, prios)


def faulty(batch: dict, params: dict, target: dict, variant: str | None):
    """The batch and weights a planted fault hands the loss:
    ``zero_state`` burns in from a zeroed stored state, ``no_prev``
    leaves the previous action and reward out of the LSTM's input (their
    columns of ``weight_ih`` dropped: as if they were zeros)."""
    if variant == "zero_state":
        batch = dict(batch, state_c=torch.zeros_like(batch["state_c"]),
                     state_h=torch.zeros_like(batch["state_h"]))
    elif variant == "no_prev":
        batch = {k: v for k, v in batch.items()
                 if k not in ("prev_action", "prev_reward")}
        n_extra = params["advantage_out.weight"].shape[0] + 1
        params = dict(params)
        target = dict(target)
        for p in (params, target):
            p["lstm.weight_ih"] = p["lstm.weight_ih"][:, :-n_extra]
    return batch, params, target


def follow(run: dict, device, variant: str | None = None,
           quant=None) -> dict:
    """Replay ``run``'s first steps (``run`` as in
    :func:`portbench.reference.follow.follow`, its ``hp`` also holding
    the recurrent settings).  ``variant``: None (the float32 reference),
    or a planted fault, ``zero_state``, ``no_rescale``, ``no_prev`` or
    ``lstm_bf16`` (the recurrence computed and carried in bfloat16, the
    trunk and heads reading bfloat16 as the configuration has them);
    ``quant`` rounds the trunk's and heads' inputs (the control).
    Returns per-step ``loss`` and ``batch``, the first step's ``prios``,
    ``idx`` and clipped ``grads``, and the ``params`` after the last
    step."""
    net.tf32_off()
    hp = run["hp"]
    rep = _replay(run, device)
    params = {k: v.detach().to(device=device, dtype=torch.float32).clone()
              for k, v in run["init"].items()}
    target = copy.deepcopy(params)
    names = list(params)
    for v in params.values():
        v.requires_grad_(True)
    mu = [torch.zeros_like(params[k]) for k in names]
    nu = [torch.zeros_like(params[k]) for k in names]
    rescale = None if variant == "no_rescale" else hp["rescale_eps"]
    lstm_dtype = torch.float32
    if variant == "lstm_bf16":
        # the program with its recurrence in bfloat16: the trunk and heads
        # as configured (bfloat16 inputs, float32 sums), the LSTM too
        lstm_dtype, quant = torch.bfloat16, bf16_quant
    msgs = iter(run["messages"])
    out = {"loss": [], "batch": []}
    for k, st in enumerate(run["steps"]):
        _catch_up(rep, msgs, st, k)
        sum_tree, min_tree = rep.trees.sum_tree(), rep.trees.min_tree()
        if k == 0:
            idx = stratified_sample(sum_tree, st["offsets"].to(device),
                                    rep.size)
            idx = torch.as_tensor(rep.resolve(idx.cpu()), device=device)
            out["idx"] = idx.cpu()
        else:
            idx = torch.as_tensor(st["idx"]).to(device)
        batch = rep.batch(idx.cpu())
        out["batch"].append(batch)
        weights = is_weights(sum_tree, min_tree, idx, rep.size, st["beta"])
        b, p, tp = faulty(batch, params, target, variant)
        loss, prios, _ = net.sequence_loss(
            p, tp, b, weights, hp["burn_in"], hp["n_steps"], rescale, quant,
            lstm_dtype)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        clipped = net.adam([params[n] for n in names], list(grads), mu, nu,
                           k, hp["lr"], hp["adam_eps"], hp["max_grad_norm"])
        if (k + 1) % hp["target_update_interval"] == 0:
            target = {n: params[n].detach().clone() for n in names}
        out["loss"].append(float(loss.detach()))
        if k == 0:
            out["prios"] = prios.detach().cpu()
            out["grads"] = {n: g.detach().cpu()
                            for n, g in zip(names, clipped)}
        rep.trees.set(idx, tree_priority(prios.detach(), hp["alpha"],
                                         hp["eps"]))
    out["params"] = {n: params[n].detach().cpu() for n in names}
    return out


def write_back_trees(run: dict, writes: list, device):
    """The trees after the run's messages and the program's own
    written-back priorities ``writes`` [(idx, priorities)], one per step,
    in the program's order."""
    hp = run["hp"]
    rep = _replay(run, device)
    msgs = iter(run["messages"])
    for st, (idx, prios) in zip(run["steps"], writes):
        _catch_up(rep, msgs, st, 0)
        rep.trees.set(torch.as_tensor(idx),
                      tree_priority(torch.as_tensor(prios), hp["alpha"],
                                    hp["eps"]))
    return rep.trees.sum_tree().cpu(), rep.trees.min_tree().cpu()
