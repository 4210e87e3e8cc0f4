"""The benchmark's machinery, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (a file of sizes under
``sagebench/configs``, with the plain reference it names under
``sagebench/reference``) and a traffic mix (``sagebench/workloads/
<traffic>.json``, which names the driver under ``sagebench/drivers`` that
runs it).  Its limits are ``sagebench/limits/<cell>.json``, and each
metric is read by ``sagebench/metrics/<metric>.py``, whose ``read(rec)``
returns a number or None.  Adding a configuration, a mix, a cell or a
metric adds files; nothing here names one.

``run`` builds the cell's inputs from the seed, has the driver set up,
warm up and run its measured window, reads the metrics, then has the
driver compare what the timed path produced with the reference, and
returns the result line's object.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = bench or load_json(CHECKOUT / "BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(work)})")
        self.name = name
        self.entry = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(CHECKOUT / conf["file"])
        self.traffic = load_json(BENCH_DIR / "workloads"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH_DIR / "limits" / f"{name}.json")

        def mine(metric):
            return name in metric.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def reference(self):
        return importlib.import_module(
            f"sagebench.reference.{self.config['reference']}")

    def port_config(self):
        from repro_torch.configs import get_config
        return get_config(self.config["arch"]).scaled(**self.model)


def read_metric(name: str, rec) -> Optional[float]:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sagebench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


@contextlib.contextmanager
def store_under(root: Path):
    """The program's Clovis puts its NVRAM tier in ``/dev/shm`` where it
    can write there.  While open, ``make_tier_pools`` (the program's own)
    places any device that it would put outside the pools' root inside
    it, as it does where ``/dev/shm`` is missing, so that a run writes
    nothing outside its directories."""
    from repro_torch.core import clovis as clovis_mod
    from repro_torch.core import tiers

    make, device = clovis_mod.make_tier_pools, tiers.TierDevice

    def pools(pool_root, *a, **kw):
        inside = Path(pool_root).resolve()

        class Inside(device):
            def __init__(self, name, tier, dev_root, *b, **k):
                if not Path(dev_root).resolve().is_relative_to(inside):
                    dev_root = inside / name
                super().__init__(name, tier, dev_root, *b, **k)

        tiers.TierDevice = Inside
        try:
            return make(pool_root, *a, **kw)
        finally:
            tiers.TierDevice = device

    clovis_mod.make_tier_pools = pools
    try:
        yield root
    finally:
        clovis_mod.make_tier_pools = make


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver is given."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, root: Path, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.root = trace, device, root
        self.t_start = t_start          # the process's start (host clock)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: Optional[float] = None) -> Dict:
    """One run of ``cell`` -> the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    from sagebench.reference.common import exact_f32
    exact_f32()
    driver = importlib.import_module(
        f"sagebench.drivers.{cell.traffic['driver']}")
    tmp = Path(tempfile.mkdtemp(prefix="sagebench-",
                                dir=os.environ.get("TMPDIR")))
    try:
        with store_under(tmp):
            ctx = Context(cell, seed, seconds, trace, device, tmp, t_start)
            rec = driver.measure(ctx)
            checks = driver.check(ctx, rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(rec.units), "failed": 0, "metrics": metrics,
           "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(),
                            "idle_gaps": rec.trace.idle_gaps()}
    out["checks"] = checks
    return out


class Record:
    """What a run measured, for the metric readers.

    ``units``: one dict per unit of the window (a step or a request),
    with its host-clock figures and, in a traced run, its probes' ms.
    ``window_s``: the window's length; ``setup_s``: from the process's
    start to the window's; ``trace``: the device trace's summary (traced
    runs); ``traced``: how many of the first units it covers;
    ``launches``: the program's kernel launches over those units."""

    @property
    def steady(self) -> List[Dict]:
        """The units the profiler did not slow: those after the traced
        ones (all of them in an untraced run)."""
        return self.units[self.traced:] or self.units

    def __init__(self, cell: Cell):
        self.cell = cell
        self.model = cell.model
        self.traffic = cell.traffic
        self.units: List[Dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.trace = None
        self.traced = 0
        self.launches: Dict[str, int] = {}
