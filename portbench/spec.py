"""The cells of ``BENCHMARK.json`` and the files each one names.

A cell is found by its workload name; its configuration file, its
traffic file (``traffic/<traffic>.json``), its FLOP count
(``configs/<config>.py``), the limits of its ``correct``
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``) are found by the names the cell carries.  The
configuration names its learner family (``families/<family>.py``: the
trainer and the judge of its learner steps) and the traffic its pool
(``pools/<pool>.py``: what acts, what is recorded of it and its judge),
so a new cell, metric, traffic mix, family or pool is new files and
entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _json(path: str) -> dict:
    with open(os.path.join(ROOT, path), encoding="utf-8") as fh:
        return json.load(fh)


_LOADED: dict = {}


def _module(path: str, name: str):
    """The module at ``path``, loaded once."""
    if path in _LOADED:
        return _LOADED[path]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod


@dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict             # the configuration file
    traffic_name: str
    traffic: dict            # the traffic file
    limits: dict = field(default_factory=dict)   # limits of ``correct``
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def flops(self):
        """The configuration's FLOP-count module; its functions take the
        configuration file's contents."""
        return _module(os.path.join(HERE, "configs", f"{self.config_name}.py"),
                       "portbench_flops_" + _ident(self.config_name))

    def family(self):
        """``families/<family>.py`` of the configuration."""
        name = self.config["family"]
        return _module(os.path.join(HERE, "families", f"{name}.py"),
                       "portbench_family_" + _ident(name))

    def pool(self):
        """``pools/<pool>.py`` of the traffic."""
        name = self.traffic["pool"]
        return _module(os.path.join(HERE, "pools", f"{name}.py"),
                       "portbench_pool_" + _ident(name))


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json(conf["file"]), traffic_name=w["traffic"],
                traffic=_json(os.path.join("portbench", "traffic",
                                           f"{w['traffic']}.json")),
                limits=_json(os.path.join("portbench", "limits",
                                          f"{name}.json"))["limits"],
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """``metrics/<name>.py``: its ``read(run)`` gives the metric's value
    or None when the run has nothing for it to read."""
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   "portbench_metric_" + _ident(name))
