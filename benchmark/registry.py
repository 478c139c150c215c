"""Finds a cell, its configuration, its traffic driver and its metric readers
by the names BENCHMARK.json gives them.  Nothing here knows a cell:

  benchmark/configs/<config>.json   the deployment (the file BENCHMARK.json
                                    names for the configuration)
  benchmark/workloads/<cell>.json   the cell: config, traffic kind, the
                                    traffic's parameters and the limits of
                                    its correctness check
  benchmark/traffic/<kind>.py       the window driver of a traffic kind
  benchmark/metrics/<metric>.py     the reader of a per-layer metric; one
                                    split by the end-to-end metric it moves
                                    (<name>.<part>, as device.idle.map) may
                                    share the reader <name>.py

so a later change adds a configuration, a cell or a metric with new files
and new entries in BENCHMARK.json alone.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root = root
        self.dir = bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json lists no {key[:-1]} named {name!r}")

    def cell(self, name: str) -> dict:
        """The BENCHMARK.json entry merged over workloads/<name>.json."""
        entry = self._entry("workloads", name)
        with open(os.path.join(self.dir, "workloads", name + ".json")) as f:
            cell = json.load(f)
        cell.update(entry)
        return cell

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            cfg = json.load(f)
        cfg["name"] = name
        return cfg

    def _module(self, sub: str, name: str, path: str = None) -> ModuleType:
        path = path or os.path.join(self.dir, sub, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark.{sub}.{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def traffic(self, kind: str) -> ModuleType:
        return self._module("traffic", kind)

    def reader(self, metric: str) -> ModuleType:
        """metrics/<metric>.py, else the reader its split shares:
        metrics/<metric less its last dotted part>.py."""
        path = os.path.join(self.dir, "metrics", metric + ".py")
        if not os.path.isfile(path):
            path = os.path.join(self.dir, "metrics",
                                metric.rpartition(".")[0] + ".py")
        return self._module("metrics", metric, path)

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of `cell` prints: its end-to-end metrics with
        --trace 0, its per-layer metrics with --trace 1.  A metric without a
        "workloads" key belongs to every cell (a per-layer one: every cell
        that reports the end-to-end metric it moves)."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell])
                and ("workloads" in m or m["moves"] in names)]
