"""Model FLOPs of ``apex-dqn-84x84``: the dueling DQN on frame stacks,
every width read from the configuration file.

A learner step runs the online net over obs and next_obs (2B samples) and
the target net over next_obs (B), and back-propagates the online pass of
obs (B): 5 B forward-equivalents.
"""

from portbench.flops import dueling_heads_macs, trunk_macs


def _shapes(config: dict) -> tuple:
    sh, st = config["shapes"], config["settings"]
    h, w, c = sh["frame"]
    return (h, w, c, st["env"]["frame_stack"], sh["actions"],
            sh["head_width"], tuple(tuple(x) for x in sh["trunk"]),
            st["learner"]["batch_size"])


def forward_flops_per_sample(config: dict) -> int:
    h, w, c, stack, actions, head, trunk, _ = _shapes(config)
    macs, feats = trunk_macs(h, w, c * stack, trunk)
    return 2 * (macs + dueling_heads_macs(feats, head, actions))


def flops_per_step(config: dict) -> int:
    batch = _shapes(config)[-1]
    return 5 * batch * forward_flops_per_sample(config)


def gather_bytes_per_step(config: dict) -> int:
    """Bytes the step's one stack gather reads once and writes once: the
    int32 ids ``[2B, S]``, the frame rows they name, the stacks."""
    h, w, c, stack, _, _, _, batch = _shapes(config)
    ids = 2 * batch * stack
    return 2 * ids * h * w * c + 4 * ids
