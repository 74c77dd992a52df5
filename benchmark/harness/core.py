"""The benchmark's data: the manifest, the cells, the configurations, and
the modules a cell names (its traffic driver, its metric readers), all
found by name.

- ``BENCHMARK.json`` at the checkout's root: cells, metrics, bounds.
- ``benchmark/workloads/<cell>.json``: the cell's traffic kind and its
  parameters, and the limits of its correctness comparison.
- ``benchmark/configs/<config>.json``: the model configuration as run.
- ``benchmark/traffic/<kind>.py``: the driver of a traffic kind.
- ``benchmark/metrics/<metric>.py``: one metric's reader,
  ``read(run) -> float or None``.
"""

from __future__ import annotations

import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those whose ``workloads`` list names it, or that have no list."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclass
class Ctx:
    """What a traffic driver gets: the cell's parameters, the model
    configuration, the seed, the window and the device."""
    cell: str
    params: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


@dataclass
class Compare:
    """One number of the correctness comparison beside its limit: the
    run is correct only while ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    """What the window produced, for the metric readers: its requests (or
    steps) with their times, counters, the trace summary and the
    driver's own records (``info``: the groups' spans, the work done)."""
    window_s: float
    records: List[dict]
    counters: Dict[str, Any]
    trace: Optional[dict] = None
    info: Dict[str, Any] = field(default_factory=dict)


def now() -> float:
    return time.perf_counter()
