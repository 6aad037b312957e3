"""The frame-ring gather kernel's share of its memory roofline, in
percent: the bytes its launches read once and write once at the card's
published rate, over the kernel's device time in the traced window."""

from portbench.devtrace import GATHER_KERNELS
from portbench.peaks import peaks


def read(run):
    if run.trace is None or run.card is None:
        return None
    ops = [op for op in run.trace.ops if GATHER_KERNELS.search(op[2])]
    if not ops:
        return None
    _, rate = peaks(run.card)
    busy_ns = sum(t - s for s, t, _, _ in ops)
    bound_ns = (len(ops) * run.flops.gather_bytes_per_step(run.cell.config)
                / rate * 1e9)
    return 100.0 * bound_ns / busy_ns
