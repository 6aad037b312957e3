"""The comparisons that decide ``correct``.

A family's judge (``families/<family>.py``) has the reference
(:mod:`portbench.reference`) follow the run's first learner steps from
the same weights and messages and reads the program against it with
:func:`judge_learner`; a pool's judge (``pools/<pool>.py``) reads what
was acted.  The learner's numbers:

``idx_mismatch``
    rows of the first step's sample that differ from the reference's own
    draw over the same trees and uniforms (exact: limit 0);
``batch_mismatch``
    elements of the three sampled batches (frames as gathered, actions,
    returns, discounts) that differ from the reference's, built from the messages at the same
    rows (exact: limit 0);
``tree_mismatch``
    nodes of the sum and min trees after the third step that differ from
    the trees of the same messages with the program's written-back
    priorities (the write-back alone; exact: limit 0);
``loss_gap``
    the largest of the three steps' ``|loss - loss_ref| / |loss_ref|``;
``td_gap``
    the first step's per-item TD magnitudes behind the new priorities
    (``|td|``, recovered from ``0.9 max|td| + 0.1 |td| + 1e-6``),
    ``|t - t_ref| / |t_ref|`` over the batch: the forward pass's
    precision, item by item;
``grad_gap``
    the worst leaf's ``| |g| - |g_ref| |`` of the first gradient as the
    optimizer got it (the clipped gradient, from the first moment after
    one step: ``mu / (1 - decay)``), over the larger of that leaf's
    ``|g_ref|`` and the median leaf's;
``grad_angle``
    ``1 - cos`` between that gradient and the reference's, all leaves as
    one vector: what a batch left half out turns;
``update_gap``
    the same as ``grad_gap`` for the weights' change over the three steps,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's (they move by round-off alone).

A cell's limits (``limits/<cell>.json``) name the numbers it compares;
each limit lies between the largest reading of sound runs and the
smallest of the control's or a fault's; an exact number's limit is 0.

``variants`` adds the control (the reference in float8 e4m3 for what the
configuration computes in bfloat16, put in the program's place) and the
planted faults, each read against the float32 reference.
"""

from __future__ import annotations

import statistics

import torch

import numpy as np

from portbench.reference.follow import follow, write_back_trees
from portbench.reference.nets import dueling_q, fp8_quant


def _leaf_gap(a: dict, b: dict, names) -> float:
    """Worst leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    ref = {n: float(b[n].float().norm()) for n in names}
    med = statistics.median(ref.values()) if ref else 0.0
    worst = 0.0
    for n in names:
        gap = abs(float(a[n].float().norm()) - ref[n])
        worst = max(worst, gap / max(ref[n], med, 1e-30))
    return worst


def _angle(a: dict, b: dict, names) -> float:
    """``1 - cos`` between all the named leaves of ``a`` and of ``b``,
    taken as one vector each (1 where either is zero)."""
    dot = sum(float((a[n].double() * b[n].double()).sum()) for n in names)
    na = sum(float((a[n].double() ** 2).sum()) for n in names) ** 0.5
    nb = sum(float((b[n].double() ** 2).sum()) for n in names) ** 0.5
    if na == 0.0 or nb == 0.0:
        return 1.0
    return 1.0 - dot / (na * nb)


def item_errors(prios: torch.Tensor) -> torch.Tensor:
    """Per-item TD magnitudes behind the first step's new priorities,
    recovered from ``0.9 max|td| + 0.1 |td| + 1e-6``."""
    p = prios.double()
    top = p.max() - 1e-6
    return (p - 1e-6 - 0.9 * top) / 0.1


def gaps(traj: dict, ref: dict, init: dict) -> dict:
    names = list(ref["grads"])
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(traj["loss"], ref["loss"]))
    t, t_ref = item_errors(traj["prios"]), item_errors(ref["prios"])
    td = float((t - t_ref).norm() / t_ref.norm().clamp_min(1e-30))
    gnorm = {n: float(ref["grads"][n].float().norm()) for n in names}
    med = statistics.median(gnorm.values())
    moving = [n for n in names if gnorm[n] >= 1e-3 * med]
    delta = {n: traj["params"][n].float() - init[n].float() for n in names}
    delta_ref = {n: ref["params"][n].float() - init[n].float()
                 for n in names}
    return dict(loss_gap=loss, td_gap=td,
                grad_gap=_leaf_gap(traj["grads"], ref["grads"], names),
                grad_angle=_angle(traj["grads"], ref["grads"], names),
                update_gap=_leaf_gap(delta, delta_ref, moving))


def program_trajectory(record: dict, program: dict) -> dict:
    d = record["hp"]["rmsprop_decay"]
    return dict(loss=program["loss"], prios=program["writes"][0][1],
                grads={n: m / (1.0 - d)
                       for n, m in zip(program["names"], program["mu1"])},
                params=program["params"])


def _batch_mismatch(record: dict, ref: dict) -> int:
    bad = 0
    for st, rb in zip(record["steps"], ref["batch"]):
        pb = st["batch"]
        for key, want in rb.items():
            got = pb[key]
            want = want.cpu()
            if got.shape != want.shape:
                bad += want.numel()
                continue
            bad += int((got.to(want.dtype) != want).sum())
    return bad


def judge_learner(record: dict, program: dict, device,
                  variants=("program",)) -> dict:
    """``{variant: {number: value}}`` for ``program`` and any of
    ``control`` and ``half_batch``."""
    ref = follow(record, device)
    out = {}
    if "program" in variants:
        nums = gaps(program_trajectory(record, program), ref, record["init"])
        nums["idx_mismatch"] = int((record["steps"][0]["idx"].long()
                                    != ref["idx"].long()).sum())
        nums["batch_mismatch"] = _batch_mismatch(record, ref)
        trees = write_back_trees(record, program["writes"], device)
        nums["tree_mismatch"] = sum(
            int((a[1:] != b[1:]).sum()) for a, b in zip(program["trees"],
                                                        trees))
        out["program"] = nums
    planted = {"control": dict(quant=fp8_quant),
               "half_batch": dict(keep_rows=None)}
    for name in variants:
        if name == "program":
            continue
        kw = dict(planted[name])
        if name == "half_batch":
            kw["keep_rows"] = record["steps"][0]["offsets"].shape[0] // 2
        alt = follow(record, device, **kw)
        out[name] = gaps(alt, ref, record["init"])
    return out


def greedy_gap(params: dict, stacks: list, actions: list, device,
               quant=None) -> float:
    """The widest gap by which a greedy action lies below the best
    float32 Q-value of its stack ``[S, H, W]``; with ``quant`` the
    actions are the lower precision's own argmax."""
    gap = 0.0
    with torch.no_grad():
        for lo in range(0, len(stacks), 1024):
            x = torch.as_tensor(np.stack(stacks[lo:lo + 1024])).to(
                device).permute(0, 2, 3, 1).contiguous()
            q = dueling_q(params, x)
            if quant is None:
                a = torch.as_tensor(actions[lo:lo + 1024], device=device)
            else:
                a = dueling_q(params, x, quant).argmax(dim=1)
            taken = q.gather(1, a[:, None].long())[:, 0]
            gap = max(gap, float((q.max(dim=1).values - taken).max()))
    return gap


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit: every number the
    cell's limits name, in their order; a number not read fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        good = value == value and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
