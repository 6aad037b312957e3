"""The share of the run's DQN updates that were CUDA graph replays:
``replay / (replay + eager)`` of the program's counter
``apex_tpu_torch.training.learner.GRAPH_COUNTS`` (absent from a program
without the graphed update)."""


def read(run):
    from apex_tpu_torch.training import learner
    counts = getattr(learner, "GRAPH_COUNTS", None)
    if counts is None:
        return None
    n = counts["replay"] + counts["eager"]
    return counts["replay"] / n if n else None
