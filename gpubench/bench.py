"""The harness's core: find a cell's configuration, traffic, driver and
metrics by name, run the cell once, and print its result line.

Nothing here is particular to one cell. A later change adds a cell, a
configuration or a metric by adding files (``configs/<config>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``) and entries in
``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Bench", "Run", "FORBIDDEN", "forbidden_modules", "main"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the benchmark's process may never hold: JAX and the
# JAX package the port was made from (compared whole: ``repro_torch`` is not
# ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in ``modules`` (default ``sys.modules``) that are
    in :data:`FORBIDDEN`."""
    tops = {name.partition(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


class Bench:
    """The benchmark's files, found by name: ``spec`` is ``BENCHMARK.json``,
    ``folder`` the directory that holds ``configs/``, ``workloads/`` and
    ``metrics/``."""

    def __init__(self, spec: dict | None = None, folder: Path = HERE):
        self.spec = spec if spec is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
        self.folder = Path(folder)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        return json.loads((self.folder / "configs" / f"{name}.json").read_text())

    def traffic(self, cell: str) -> dict:
        return json.loads((self.folder / "workloads" / f"{cell}.json").read_text())

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py`` (metric names hold dots, so it
        is loaded from its path)."""
        path = self.folder / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics with ``trace`` off, its per-layer metrics with it on. A
        metric with ``workloads`` is reported in those cells; a per-layer
        metric without it in every cell that reports the end-to-end metric
        it moves."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]


@dataclass
class Run:
    """What one run of a cell recorded, for the metric readers. Times are
    host ``time.perf_counter()`` seconds."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace_on: bool
    setup_s: float = 0.0
    window: tuple[float, float] = (0.0, 0.0)    # (opened, closed)
    requests: list = field(default_factory=list)  # serving: one dict per request
    steps: list = field(default_factory=list)     # one dict per step in the window
    spans: dict = field(default_factory=dict)     # name -> list of dicts (traced runs)
    trace: object = None                          # gpubench.timeline.Trace (traced runs)
    extra: dict = field(default_factory=dict)     # driver-specific readings
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    compared: dict = field(default_factory=dict)  # name -> {"value", "limit"}
    correct: bool = False

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _number(x) -> float:
    x = float(x)
    if not math.isfinite(x):
        raise ValueError(f"a metric read {x}")
    return x


def result_line(bench: Bench, run: Run, device: dict) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``, the
    metrics, ``device``, with the trace on ``breakdown``, and last the
    numbers compared with their limits."""
    metrics = {}
    for m in bench.metrics(run.cell, run.trace_on):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    out = {"correct": bool(run.correct), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace is not None:
        out["device"] = {**device, "busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        out["breakdown"] = run.extra["breakdown"]
    out["compared"] = run.compared
    return out


def _parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _refuse(msg: str) -> int:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, t0: float | None = None) -> int:
    """Run a cell on the card and print its result as the last line of
    standard output. Exits non-zero, printing no result, without a card (or
    with fewer than the cell asks for) and when JAX or the JAX package was
    loaded."""
    import time
    t0 = time.perf_counter() if t0 is None else t0
    args = _parse(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return _refuse(f"the cell needs {cell['chips']} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    traffic = bench.traffic(cell["name"])
    run = Run(cell["name"], bench.config(cell["config"]), traffic, args.seed, args.seconds,
              bool(args.trace))
    driver = importlib.import_module(f"gpubench.drivers.{traffic['driver']}")
    device = driver.run(run, t0=t0, device="cuda")
    found = forbidden_modules()
    if found:
        return _refuse(f"the process loaded {found} (JAX or the JAX package); no result")
    line = result_line(bench, run, device)
    for name, c in run.compared.items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
