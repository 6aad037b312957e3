"""Device milliseconds per learner step of the LSTM's own work, forward
and backward: the device operations launched inside the host operators
that run cuDNN's RNN (``aten::_cudnn_rnn``, the forward of every burn-in
and unroll, and ``aten::_cudnn_rnn_backward``, on whichever thread runs
it), their GEMMs and weight copies included; every other operation is
left out.  None where no such operator ran (an LSTM not on cuDNN)."""

import re
from collections import defaultdict

from portbench.devtrace import _union

CUDNN_RNN = re.compile(r"^aten::_cudnn_rnn(_backward)?$")


def read(run):
    trace = run.trace
    if trace is None or run.steps <= 0:
        return None
    by_thread = defaultdict(list)
    for name, thread, s, t in trace.host_ops:
        if CUDNN_RNN.match(name):
            by_thread[thread].append((s, t))
    if not by_thread:
        return None
    ns = 0
    for thread, spans in by_thread.items():
        ns += sum(t - s for s, t, _, _ in
                  trace._launched(_union(spans), thread))
    return ns * 1e-6 / run.steps
