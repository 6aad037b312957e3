"""Reduction of a ``torch.profiler`` trace to device numbers.

Reads the profiler's raw events (no per-event Python objects are built
beyond one tuple each): device operations (kernels, copies, sets) with
their correlation ids, the host launch call behind each, the harness's
``portbench.*`` ranges and the host operators.  From them: the device's
busy time (the union of its operations), the operations launched inside
a range, the operations that took most time, and the longest gaps in
which the device ran nothing, each labelled by what the learner thread
was doing.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

OPEN, CLOSE = "portbench.mark.open", "portbench.mark.close"
# the frame-ring gather's kernels (apex_tpu_torch/ops/csrc/gather.cu)
GATHER_KERNELS = re.compile(
    r"\b(bulk_kernel|rows_reg_kernel|stacks_reg_kernel)\b")


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


class DeviceTrace:
    """Device operations ``(start_ns, end_ns, name, corr)``, launches
    ``{corr: (thread, start_ns)}``, ranges ``[(name, thread, start_ns,
    end_ns)]`` and host operators likewise, inside a window of
    ``window_s`` seconds."""

    def __init__(self, ops, launches, ranges, host_ops, window_s: float):
        self.ops = sorted(ops)
        self.window_s = window_s
        self.launches = launches
        self.ranges = ranges
        self.host_ops = host_ops
        self._busy = _union((s, t) for s, t, _, _ in self.ops)
        self.open_ns = 0
        self.streams: dict = {}      # corr -> the device stream it ran on

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        """The events between the harness's open and close marks.  Host
        events are told apart by name: the harness's ranges are user
        annotations, CUDA API calls (``cuda*``, ``cu*``) are launches, the
        rest are operators."""
        events = prof.profiler.kineto_results.events()
        marks = {e.name(): e.start_ns() for e in events
                 if e.name() in (OPEN, CLOSE)}
        if OPEN not in marks or CLOSE not in marks:
            raise RuntimeError("the trace lacks the window's marks")
        lo, hi = marks[OPEN], marks[CLOSE]
        ops, launches, ranges, host_ops, streams = [], {}, [], [], {}
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if end < lo or start > hi:
                continue
            cuda = str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
            name = e.name()
            if e.is_user_annotation():
                if not cuda and not name.startswith("portbench.mark."):
                    ranges.append((name, e.start_thread_id(), start, end))
            elif cuda:
                corr = e.linked_correlation_id() or e.correlation_id()
                ops.append((max(start, lo), min(end, hi), name, corr))
                streams[corr] = e.device_resource_id()
            elif name.startswith("cu"):
                for corr in (e.correlation_id(), e.linked_correlation_id()):
                    if corr:
                        launches[corr] = (e.start_thread_id(), start)
            else:
                host_ops.append((name, e.start_thread_id(), start, end))
        out = cls(ops, launches, ranges, host_ops, (hi - lo) * 1e-9)
        out.open_ns = lo
        out.streams = streams
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy) * 1e-9

    def _spans(self, prefix: str) -> dict:
        """``{thread: merged intervals}`` of the ranges named ``prefix*``."""
        spans = defaultdict(list)
        for name, thread, s, t in self.ranges:
            if name.startswith(prefix):
                spans[thread].append((s, t))
        return {th: _union(iv) for th, iv in spans.items()}

    def _inside(self, prefix: str) -> list:
        """Operations whose launch call ran inside a ``prefix*`` range, on
        the range's thread."""
        out = []
        for thread, merged in self._spans(prefix).items():
            out += self._launched(merged, thread)
        return out

    def home_streams(self, prefix: str) -> set:
        """The streams whose operations were launched mostly inside the
        ``prefix*`` ranges.  The profiler can give another thread's
        launches the range's thread id; a stream that thread works on
        outside the ranges (the staging thread's) is not the range's."""
        inside = defaultdict(int)
        for op in self._inside(prefix):
            inside[self.streams.get(op[3])] += 1
        total = defaultdict(int)
        for op in self.ops:
            total[self.streams.get(op[3])] += 1
        return {st for st, n in inside.items() if 2 * n > total[st]}

    def launched_in(self, prefix: str) -> list:
        """Operations launched inside the ``prefix*`` ranges on the range's
        thread, on the ranges' own streams (:meth:`home_streams`)."""
        home = self.home_streams(prefix)
        return [op for op in self._inside(prefix)
                if self.streams.get(op[3]) in home]

    def launched_during(self, intervals, exclude_streams=()) -> list:
        """Operations off ``exclude_streams`` whose launch call fell inside
        one of ``intervals`` ``[(start_ns, end_ns)]``: the work of a thread
        the profiler records no ranges on."""
        return [op for op in self._launched(_union(intervals))
                if self.streams.get(op[3]) not in exclude_streams]

    def _launched(self, merged: list, thread=None) -> list:
        """Operations whose launch (on ``thread``, or any) fell inside the
        sorted, disjoint ``merged`` intervals."""
        starts = [s for s, _ in merged]
        out = []
        for op in self.ops:
            launch = self.launches.get(op[3])
            if launch is None or (thread is not None and launch[0] != thread):
                continue
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and launch[1] <= merged[i][1]:
                out.append(op)
        return out

    def top_ops(self, n: int) -> list:
        total = defaultdict(int)
        for s, t, name, _ in self.ops:
            total[name] += t - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int) -> list:
        """The ``n`` longest intervals between device operations, each
        named by the harness range and the host operator that overlapped it
        most on the learner thread."""
        gaps = [(b[0] - a[1], a[1], b[0])
                for a, b in zip(self._busy, self._busy[1:])]
        gaps.sort(reverse=True)
        learner = {th for name, th, _, _ in self.ranges
                   if name == "portbench.learner"}
        out = []
        for length, s, t in gaps[:n]:
            out.append([self._label(s, t, learner), length * 1e-9])
        return out

    def _label(self, s: int, t: int, learner: set) -> str:
        def best(items):
            top, key = None, None
            for name, th, a, b in items:
                ov = min(b, t) - max(a, s)
                if ov <= 0 or (learner and th not in learner):
                    continue
                k = (ov, -(b - a))
                if key is None or k > key:
                    top, key = name, k
            return top

        where = best(self.ranges) or "outside the learner's dispatches"
        op = best(self.host_ops)
        return f"{where}: {op}" if op else where
