"""The readers of the DQN update's span and graph counter on synthetic
runs: the learner thread's ``apex.learner.update`` spans over a window
of [10 000, 30 000) ns, and the program's ``GRAPH_COUNTS``; each reads
None where the program has neither, as a program without the graphed
update leaves them."""

from types import SimpleNamespace

import pytest

from portbench.devtrace import DeviceTrace
from portbench.spec import metric_reader

LEARNER, STAGING = 1, 2
OPEN, CLOSE = 10_000, 30_000


def _run(ranges, steps=2):
    trace = DeviceTrace([], {}, ranges, [], (CLOSE - OPEN) * 1e-9)
    trace.open_ns = OPEN
    return SimpleNamespace(trace=trace, steps=steps)


UPDATES = [("apex.learner.update", LEARNER, 9_000, 10_500),   # 500 inside
           ("apex.learner.update", LEARNER, 12_000, 14_000),
           ("apex.learner.loss", LEARNER, 12_100, 13_900),
           ("apex.learner.update", LEARNER, 20_000, 21_500),
           ("apex.learner.poll", LEARNER, 22_000, 25_000)]


def test_update_host_ms_clips_the_update_spans_to_the_window():
    read = metric_reader("learner.update_host_ms_per_step").read
    assert read(_run(UPDATES)) == pytest.approx(
        (500 + 2_000 + 1_500) * 1e-6 / 2)
    assert read(_run(UPDATES, steps=4)) == pytest.approx(
        (500 + 2_000 + 1_500) * 1e-6 / 4)


def test_update_host_ms_reads_nothing_without_the_update_span():
    read = metric_reader("learner.update_host_ms_per_step").read
    parent = [r for r in UPDATES if r[0] != "apex.learner.update"]
    assert read(_run(parent)) is None
    assert read(_run(UPDATES, steps=0)) is None
    assert read(SimpleNamespace(trace=None, steps=2)) is None


def test_graph_share_reads_replays_over_updates(monkeypatch):
    from apex_tpu_torch.training import learner

    read = metric_reader("learner.update_graph_share").read
    run = SimpleNamespace(trace=None, steps=0)
    monkeypatch.setattr(learner, "GRAPH_COUNTS",
                        {"capture": 1, "replay": 199, "eager": 1})
    assert read(run) == pytest.approx(199 / 200)
    monkeypatch.setattr(learner, "GRAPH_COUNTS",
                        {"capture": 0, "replay": 0, "eager": 7})
    assert read(run) == 0.0
    monkeypatch.setattr(learner, "GRAPH_COUNTS",
                        {"capture": 0, "replay": 0, "eager": 0})
    assert read(run) is None
    monkeypatch.delattr(learner, "GRAPH_COUNTS")
    assert read(run) is None
