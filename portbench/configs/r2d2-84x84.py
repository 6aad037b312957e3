"""Model FLOPs of ``r2d2-84x84``: the recurrent dueling DQN on single
frames, every width read from the configuration file.

A frame's forward pass is the trunk, the LSTM's input and recurrent
matmuls (the trunk's features, the previous action one-hot and the
previous reward in; ``4H`` gates out) and the dueling heads.  A learner
step runs both nets over each sequence's ``T = burn_in + unroll +
n_steps`` stored steps and back-propagates the online net's pass over
the ``T - burn_in`` steps after the burn-in at twice a forward's cost:
``2 T + 2 (T - burn_in)`` forward-equivalents a sequence.
"""

from portbench.flops import dueling_heads_macs, trunk_macs


def _shapes(config: dict) -> tuple:
    sh, st = config["shapes"], config["settings"]
    rc = st["r2d2"]
    t_total = rc["burn_in"] + rc["unroll"] + st["learner"]["n_steps"]
    return (tuple(sh["frame"]), sh["actions"], sh["lstm_features"],
            sh["head_width"], bool(sh["prev_action_reward"]),
            tuple(tuple(x) for x in sh["trunk"]),
            st["learner"]["batch_size"], t_total, rc["burn_in"])


def forward_flops_per_sample(config: dict) -> int:
    (h, w, c), actions, lstm, head, prev, trunk, _, _, _ = _shapes(config)
    macs, feats = trunk_macs(h, w, c, trunk)
    lstm_in = feats + (actions + 1 if prev else 0)
    macs += 4 * lstm * (lstm_in + lstm)
    return 2 * (macs + dueling_heads_macs(lstm, head, actions))


def flops_per_step(config: dict) -> int:
    batch, t_total, burn_in = _shapes(config)[-3:]
    per_seq = 2 * t_total + 2 * (t_total - burn_in)
    return batch * per_seq * forward_flops_per_sample(config)


def gather_bytes_per_step(config: dict) -> int:
    """Bytes the step's one row gather reads once and writes once: the
    int32 ids ``[B*T]``, the frame rows they name and the batch."""
    (h, w, c), *_, batch, t_total, _ = _shapes(config)
    rows = batch * t_total
    return 2 * rows * h * w * c + 4 * rows
