"""Model FLOPs per second on the card as a share of its bf16 peak, in
percent: the configuration's count per learner step times the learner's
rate (with the rollout engine, its policy forwards per frame times the
engine's rate), over the untraced head of the traced run's window, so
the profiler's own cost is left out."""

from portbench.peaks import peaks


def read(run):
    if run.card is None or not run.untraced_steps_per_s:
        return None
    config = run.cell.config
    flops = run.flops.flops_per_step(config) * run.untraced_steps_per_s
    if run.untraced_frames_per_s:
        flops += (run.flops.forward_flops_per_sample(config)
                  * run.untraced_frames_per_s)
    peak, _ = peaks(run.card)
    return 100.0 * flops / peak
