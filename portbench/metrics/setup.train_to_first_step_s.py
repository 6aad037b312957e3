"""Seconds from the entry of ``train()`` to its first learner step's
return, from the trainer's set-up milestones
(``latency_summary()["setup_s"]``)."""


def read(run):
    summary = run.trainer.latency_summary() or {}
    return (summary.get("setup_s") or {}).get("train_to_first_step")
