"""The benchmark's files: every cell, configuration and metric loads by
name, ``BENCHMARK.json`` keeps its contract's shape, the counts give the
hand-worked numbers, and nothing loads JAX or the JAX package."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

from sagebench import counts, harness  # noqa: E402
from sagebench import traffic  # noqa: E402
from sagebench.reference import mamba2  # noqa: E402

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.Cell(cell)
    assert c.traffic["driver"] in ("train", "serve")
    assert c.reference() is mamba2
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:          # each moves a metric the cell reports
        assert m["moves"] in e2e
    assert c.entry["chips"] == 1
    cfg = c.port_config()
    for k, v in c.model.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    path = harness.BENCH_DIR / "metrics" / f"{metric}.py"
    spec = harness.importlib.util.spec_from_file_location("m", path)
    mod = harness.importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize("config", BENCH["configs"])
def test_config_parameter_count(config):
    from repro_torch.configs import get_config
    from repro_torch.models import model as mdl
    from repro_torch.tree import leaves
    conf = harness.load_json(CHECKOUT / config["file"])
    cfg = get_config(conf["arch"]).scaled(**conf["model"])
    assert sum(t.numel() for t in leaves(mdl.params_like(cfg))) \
        == conf["parameters"]
    assert conf["reduced"] == config["reduced"]


def test_counts_by_hand():
    # B6 at (b, s, h, p, n) = (1, 2, 1, 2, 3): per row 2n + 2p + 4np = 34
    assert counts.ssd_flops(1, 2, 1, 2, 3) == 68
    # x, y 2*4, dt 2, A 1, B, C 2*6, state out 6 (+ in 6): words * 4 bytes
    assert counts.ssd_bytes(1, 2, 1, 2, 1, 3, False) == 4 * 29
    assert counts.ssd_bytes(1, 2, 1, 2, 1, 3, True) == 4 * 35
    assert counts.bound_s(494.7e12, 0, "float32") == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)


def test_model_flops_by_hand():
    m = harness.Cell("mamba2-train").model
    # in_proj 768 x 3352, out_proj 1536 x 768, conv 4 x 1792, the scan's
    # 24 heads x (2*128 + 2*64 + 4*128*64)
    per = 2 * 768 * 3352 + 2 * 1536 * 768 + 2 * 4 * 1792 + 24 * 33152
    assert mamba2.layer_flops_per_token(m) == per == 8_317_952
    head = 2 * 768 * 50280
    assert mamba2.model_flops(m, 8, 2048, train=True) \
        == 3 * 8 * 2048 * (24 * per + head)
    assert mamba2.model_flops(m, 4, 100, 4) == 4 * (104 * 24 * per
                                                    + 5 * head)


SERVE_MIXES = [w["traffic"] for w in BENCH["workloads"]
               if harness.Cell(w["name"]).traffic["driver"] == "serve"]


@pytest.mark.parametrize("seed", [5, 2**31 + 99, 2**33 + 7])
@pytest.mark.parametrize("traffic_name", SERVE_MIXES)
def test_serving_mix_is_a_stratified_sample(traffic_name, seed):
    """A round's lengths are the middle quantiles of the cut log-normal,
    its gaps average 1 / rate, and every seed's round holds the same
    lengths and gaps in another order."""
    from statistics import NormalDist
    mix = harness.load_json(harness.BENCH_DIR / "workloads"
                            / f"{traffic_name}.json")
    p, k = mix["prompt_len"], mix["strata"]
    lens, gaps = traffic.lengths(mix), traffic.gaps(mix)
    assert len(lens) == len(gaps) == k
    assert p["min"] <= lens[0] and lens == sorted(lens) \
        and lens[-1] <= p["max"]
    z, mu = NormalDist(), traffic.math.log(p["median"])
    lo, hi = (z.cdf((traffic.math.log(x) - mu) / p["sigma"])
              for x in (p["min"], p["max"]))
    for j, n in enumerate(lens):      # the share below each stratum's middle
        share = (z.cdf((traffic.math.log(n) - mu) / p["sigma"]) - lo) \
            / (hi - lo)
        assert share == pytest.approx((j + 0.5) / k, abs=0.5 / k / 20)
    assert sum(gaps) / k == pytest.approx(1 / mix["arrivals"]["rate"])
    got = [traffic.request(mix, seed, i) for i in range(k, 2 * k)]
    assert sorted(n for n, _ in got) == lens
    assert sorted(g for _, g in got) == gaps
    assert [traffic.request(mix, seed, i) for i in range(k)] \
        != [traffic.request(mix, seed + 1, i) for i in range(k)]


@pytest.mark.parametrize("per_tier", [1, 2, 3])
def test_store_keeps_every_tier_inside_its_root(tmp_path, per_tier):
    """Under ``store_under`` the program's ``make_tier_pools`` places
    every device, the NVRAM tier's too, under the pools' root."""
    from repro_torch.core import clovis as clovis_mod
    with harness.store_under(tmp_path):
        pools = clovis_mod.make_tier_pools(tmp_path / "tiers", per_tier)
    roots = [d.root for pool in pools.values() for d in pool.devices]
    assert len(roots) == per_tier * len(pools) == len(set(roots))
    assert all(r.is_relative_to(tmp_path / "tiers") and r.is_dir()
               for r in roots)


def test_first_gradient_from_the_moments_by_hand():
    """A stretch's first gradient is worked out from AdamW's first moment
    before and after its first step: (m1 - beta1 m0) / (1 - beta1)."""
    import torch
    from sagebench.drivers import train
    m0 = {"w": torch.tensor([1.0, 2.0])}
    g = torch.tensor([3.0, -4.0])
    m1 = {"w": 0.9 * m0["w"] + 0.1 * g}
    p0 = {"w": torch.tensor([0.0, 0.0])}
    start = {"params": p0, "m": m0, "v": None, "step": 7}
    got = train._stretch(start, 3, [torch.tensor(2.5)], m1,
                         {"w": torch.tensor([3.0, 4.0])}, 0.9)
    assert got["grad_norms"]["w"] == pytest.approx(5.0)
    assert got["change_norms"]["w"] == pytest.approx(5.0)
    assert got["losses"] == [2.5] and got["first"] == 3


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path[0:0] = [%r, %r]\n"
            "import sagebench.harness, sagebench.control\n"
            "import sagebench.drivers.serve, sagebench.drivers.train\n"
            "import sagebench.reference.mamba2\n"
            "from sagebench import harness\n"
            "for c in %r: harness.Cell(c).port_config()\n"
            "import repro_torch.launch.serve, repro_torch.launch.train\n"
            "print(harness.forbidden_modules())"
            % (str(CHECKOUT), str(CHECKOUT / "src"), CELLS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        src = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(repro_torch|repro|jax)\b",
                             src, re.M), path.name


def test_run_without_the_program_exits_nonzero(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    import shutil
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "sagebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "sagebench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
