"""The n-step double-DQN family: ``ApexTrainer`` over the cell's pool (its
own actor pool where the pool module gives none), judged by the
reference's following of its first learner steps
(:func:`portbench.check.judge_learner`)."""

from portbench.check import judge_learner as judge  # noqa: F401


def build_trainer(cfg, pool, device):
    from apex_tpu_torch.training.apex import ApexTrainer
    return ApexTrainer(cfg, pool=pool, device=device)
