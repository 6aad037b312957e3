"""The reference's own run of the first learner steps.

Given the weights the run started from, the chunk messages in arrival
order, and for each step the replay cursor at its sample, its per-stratum
uniforms and IS exponent, the reference ingests the same messages,
samples its own trees, builds the batch from the messages, and takes the
update in float32 (or in a lower precision, for the control), writing its
own priorities back.  Where its trees have legitimately drifted from the
program's (the priorities written back carry the program's rounding), a
later step's sample would pick other rows by round-off alone, so from the
second step on it takes the rows the program drew; its own draw of the
first step is what checks the sample.
"""

from __future__ import annotations

import copy

import torch

from portbench.reference import losses
from portbench.reference.per import (is_weights, stratified_sample,
                                     tree_priority)
from portbench.reference.replay import Replay


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def follow(run: dict, device, quant=None, keep_rows=None) -> dict:
    """Replay ``run``'s first steps.  ``run`` holds ``hp``
    (the config's numbers), ``frame_shape``, ``init`` {name: tensor},
    ``messages`` [(payload, priorities)] and ``steps`` [{ingested,
    size, offsets, beta, idx}].  Returns per-step ``loss``, the first step's
    ``prios`` and clipped ``grads``, the ``params`` after the last step,
    the first step's own ``idx`` and each step's ``batch``."""
    tf32_off()
    hp = run["hp"]
    rep = Replay(hp["capacity"], run["frame_shape"], hp["alpha"], hp["eps"],
                 device)
    params = {k: v.detach().to(device=device, dtype=torch.float32).clone()
              for k, v in run["init"].items()}
    target = copy.deepcopy(params)
    names = list(params)
    for v in params.values():
        v.requires_grad_(True)
    mu = [torch.zeros_like(params[k]) for k in names]
    nu = [torch.zeros_like(params[k]) for k in names]
    msgs = iter(run["messages"])
    out = {"loss": [], "batch": []}
    ingested = 0
    for k, st in enumerate(run["steps"]):
        while ingested < st["ingested"]:
            payload, prios = next(msgs)
            rep.ingest(payload, prios)
            ingested += int(payload["n_trans"])
            if ingested > st["ingested"]:
                raise ValueError(f"step {k + 1}: the messages overshoot "
                                 f"the {st['ingested']} items ingested")
        sum_tree, min_tree = rep.trees.sum_tree(), rep.trees.min_tree()
        if k == 0:
            idx = stratified_sample(sum_tree, st["offsets"].to(device),
                                    rep.size)
            out["idx"] = idx.cpu()
        else:
            idx = torch.as_tensor(st["idx"]).to(device)
        batch = rep.batch(idx.cpu())
        out["batch"].append(batch)
        weights = is_weights(sum_tree, min_tree, idx, rep.size, st["beta"])
        loss, prios = losses.dqn_loss(params, target, batch, weights, quant,
                                      keep_rows)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        clipped = losses.clip_rmsprop([params[n] for n in names], list(grads),
                                      mu, nu, k, hp)
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
    """The sum and min trees after the run's messages and the program's
    own written-back priorities ``writes`` [(idx, priorities)], one per
    step, applied in the program's order: the write-back stage alone."""
    hp = run["hp"]
    rep = Replay(hp["capacity"], run["frame_shape"], hp["alpha"], hp["eps"],
                 device)
    msgs = iter(run["messages"])
    ingested = 0
    for st, (idx, prios) in zip(run["steps"], writes):
        while ingested < st["ingested"]:
            payload, p = next(msgs)
            rep.ingest(payload, p)
            ingested += int(payload["n_trans"])
        rep.trees.set(torch.as_tensor(idx),
                      tree_priority(torch.as_tensor(prios), hp["alpha"],
                                    hp["eps"]))
    return rep.trees.sum_tree().cpu(), rep.trees.min_tree().cpu()
