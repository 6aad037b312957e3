"""The recurrent (R2D2) family: ``R2D2ApexTrainer`` over the cell's pool,
judged by the reference's following of its first learner steps
(:mod:`portbench.reference.r2d2_follow`).

The probe's run record carries the replay's and the optimizer's common
settings only, so the family keeps the configuration it built the
trainer from and its judge reads the recurrent ones there.  The
learner's numbers are those of :mod:`portbench.check` (``idx_mismatch``,
``batch_mismatch`` over frames, actions, rewards, discounts, masks, the
stored states and the previous action and reward, ``tree_mismatch``,
``loss_gap``, ``grad_gap``, ``grad_angle``, ``update_gap``) with
``td_gap`` read on the sequences' own priorities
(``0.9 max|td| + 0.1 mean|td| + 1e-6`` over each loss region):
``|p - p_ref| / |p_ref|`` over the first step's batch.

``variants``: the control (the reference in float8 e4m3 where the
configuration computes in bfloat16) and the four planted faults, each
read against the float32 reference: ``zero_state`` (burn-in from a
zeroed stored state), ``no_rescale`` (value rescaling left out),
``no_prev`` (the previous action and reward left out) and
``lstm_bf16`` (the recurrence in bfloat16).  ``python -m
portbench.control --planted`` asks for the control and ``half_batch``;
either name runs all five here.
"""

from __future__ import annotations

from portbench.check import _angle, _batch_mismatch, _leaf_gap
from portbench.reference.nets import fp8_quant
from portbench.reference.r2d2_follow import follow, write_back_trees

FAULTS = ("zero_state", "no_rescale", "no_prev", "lstm_bf16")
ADAM_B1 = 0.9

_BUILT: dict = {}      # the latest trainer's configuration and ring size


def build_trainer(cfg, pool, device):
    from apex_tpu_torch.training.r2d2 import R2D2ApexTrainer
    trainer = R2D2ApexTrainer(cfg, pool=pool, device=device)
    _BUILT.update(cfg=trainer.cfg, f_capacity=trainer.replay.f_capacity)
    return trainer


def _record(record: dict) -> dict:
    """The run record with the recurrent settings in its ``hp``."""
    cfg = _BUILT["cfg"]
    lc, rc = cfg.learner, cfg.r2d2
    if lc.optimizer != "adam":
        raise ValueError("the recurrent reference follows clip + Adam")
    hp = dict(record["hp"], f_capacity=_BUILT["f_capacity"],
              burn_in=rc.burn_in, adam_eps=lc.adam_eps,
              rescale_eps=rc.value_rescale_eps or None)
    return dict(record, hp=hp)


def gaps(traj: dict, ref: dict, init: dict) -> dict:
    names = list(ref["grads"])
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(traj["loss"], ref["loss"]))
    p, p_ref = traj["prios"].double(), ref["prios"].double()
    td = float((p - p_ref).norm() / p_ref.norm().clamp_min(1e-30))
    gnorm = {n: float(ref["grads"][n].float().norm()) for n in names}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moving = [n for n in names if gnorm[n] >= 1e-3 * med]
    delta = {n: traj["params"][n].float() - init[n].float() for n in names}
    delta_ref = {n: ref["params"][n].float() - init[n].float()
                 for n in names}
    return dict(loss_gap=loss, td_gap=td,
                grad_gap=_leaf_gap(traj["grads"], ref["grads"], names),
                grad_angle=_angle(traj["grads"], ref["grads"], names),
                update_gap=_leaf_gap(delta, delta_ref, moving))


def judge(record: dict, program: dict, device,
          variants=("program",)) -> dict:
    """``{variant: {number: value}}`` for ``program`` and, where the
    control (or ``half_batch``) is asked for, the control and the four
    faults."""
    record = _record(record)
    ref = follow(record, device)
    out = {}
    if "program" in variants:
        traj = dict(loss=program["loss"], prios=program["writes"][0][1],
                    grads={n: m / (1.0 - ADAM_B1)
                           for n, m in zip(program["names"],
                                           program["mu1"])},
                    params=program["params"])
        nums = gaps(traj, ref, record["init"])
        nums["idx_mismatch"] = int((record["steps"][0]["idx"].long()
                                    != ref["idx"].long()).sum())
        nums["batch_mismatch"] = _batch_mismatch(record, ref)
        trees = write_back_trees(record, program["writes"], device)
        nums["tree_mismatch"] = sum(
            int((a[1:] != b[1:]).sum()) for a, b in zip(program["trees"],
                                                        trees))
        out["program"] = nums
    if {"control", "half_batch"} & set(variants):
        out["control"] = gaps(follow(record, device, quant=fp8_quant), ref,
                              record["init"])
        for name in FAULTS:
            out[name] = gaps(follow(record, device, variant=name), ref,
                             record["init"])
    return out
