"""The ``qwen2-moe-prefill`` cell at CPU sizes: the plain reference
against the program's prefill and decode through its cache (with
capacity dropping tokens), whole runs that read correct, planted faults
that do not, the control departing further than the program, and the
three MoE readers on records made by hand, None where they have nothing
to read."""
import copy
import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from small_cells import SEED
from sagebench import harness
from sagebench.drivers import serve as serve_driver
from sagebench.reference import qwen2_moe
from sagebench.weights import make_params

CPU = torch.device("cpu")
CELL = "qwen2-moe-prefill"
# qwen2-moe's SMOKE widths (the registry's), with the cell's own keys
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             vocab_size=256, n_experts=8, top_k=2, d_expert=32,
             d_shared_expert=128)
# f32 sums in another order over 2 layers, the routes equal: ~1e-6
LOGIT_RTOL = 1e-5


def small_cell(**traffic) -> harness.Cell:
    c = harness.Cell(CELL)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(SMALL)
    t = copy.deepcopy(c.traffic)
    t.update(prompt_len={"median": 30, "sigma": 0.6, "min": 16, "max": 64},
             arrivals={"shape": 0.5, "rate": 1000.0}, strata=4, gen=3,
             checked_tokens=12, trace_units=2)
    t.update(traffic)
    c.traffic = t
    return c


@pytest.mark.parametrize("prompt,gen,norm", [(21, 5, False), (40, 4, False),
                                             (9, 6, True)])
def test_reference_matches_prefill_then_decode(prompt, gen, norm):
    """The reference's logits at the served positions against the
    program's prefill and ``decode_step`` through its cache, fed the
    program's greedy tokens, on the benchmark's seeded weights; the
    longer prompts drop tokens at capacity."""
    from repro_torch import trace
    from repro_torch.models import model as mdl
    cell = small_cell()
    m = dict(cell.model, norm_topk_prob=norm)
    cfg = cell.port_config().scaled(norm_topk_prob=norm)
    params = make_params(mdl.params_like(cfg), SEED + prompt, CPU)
    tokens = torch.as_tensor(np.random.default_rng(prompt).integers(
        0, m["vocab_size"], (1, prompt)))
    cache = mdl.init_decode_state(cfg, 1, prompt + gen, dtype=torch.float32,
                                  device=CPU)
    trace.drop_device_counts(CPU)
    with trace.unit("test.serve") as u:
        logits, cache = mdl.prefill(params, {"tokens": tokens}, cfg, cache)
        trace.settle_device_counts(CPU)
    got = [logits]
    for i in range(gen - 1):
        logits, cache = mdl.decode_step(params, got[-1].argmax(-1)[:, None],
                                        prompt + i, cfg, cache)
        got.append(logits)
    got = torch.stack(got, dim=1)
    served = got.argmax(-1)
    h = qwen2_moe.serve_hidden(params, tokens, served, m, False)
    want = qwen2_moe.head(params, h[:, prompt - 1:], m, False)
    err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(err.max()) <= LOGIT_RTOL
    if prompt >= 21:
        assert u.counts["moe.assignments_dropped"] > 0


def test_reference_drops_as_the_capacity_rule_says():
    """Each expert keeps its C highest gates of a group, equal gates to
    the lower position; groups of one keep every choice."""
    gates = torch.tensor([[0.5, 0.1], [0.5, 0.2], [0.4, 0.3], [0.6, 0.0]])
    chosen = torch.ones_like(gates, dtype=torch.bool)
    chosen[3, 1] = False
    # 4 tokens, k 1, E 2: C = round(4 * 1.25 / 2) = 2
    kept = qwen2_moe.kept_mask(gates, chosen, [(0, 4)], 1)
    assert kept[:, 0].tolist() == [True, False, False, True]
    assert kept[:, 1].tolist() == [False, True, True, False]
    alone = qwen2_moe.kept_mask(gates, chosen, [(i, i + 1) for i in
                                                range(4)], 1)
    assert torch.equal(alone, chosen)


def test_model_flops_by_hand():
    m = harness.Cell(CELL).model
    d, hd, h = 2048, 128, 16
    per = (2 * d * 4 * h * hd + 2 * d * 60 + 4 * 6 * d * 1408
           + 6 * d * 5632 + 2 * d)
    assert qwen2_moe.layer_flops_per_token(m) == per
    head = 2 * d * 151936
    # prompt 3, gen 2: queries at positions 0-4 see 1-5 keys
    attn = 24 * 4 * h * hd * 15
    assert qwen2_moe.model_flops(m, 1, 3, 2) == 5 * 24 * per + 3 * head \
        + attn


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    cell = small_cell()
    out = harness.run(cell, SEED, 0.5, trace, CPU)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    if trace:      # on the CPU no device-trace reader finds anything
        assert {m["name"] for m in cell.per_layer
                if m["source"] != "device_trace"} <= got
        assert 0 < out["metrics"]["moe_drop_share.serve"]["value"] < 100
    else:
        assert got == {m["name"] for m in cell.end_to_end}


def test_control_departs_further_than_the_program(tmp_path):
    """The reference at TF32 in the program's place departs from the f32
    reference by far more than the program does.  (At these widths it
    stays inside the full-width cell's limits, which the card's readings
    set: PERF.md section 2.)"""
    from sagebench import control
    cell = small_cell()
    with harness.store_under(tmp_path):
        ctx = harness.Context(cell, SEED, 0.5, False, CPU, tmp_path, 0.0)
        rec = serve_driver.measure(ctx)
        got = control.serve_control(ctx, rec)
        sound = serve_driver.check(ctx, rec)
    assert sound["logit_err"]["value"] < 1e-5
    assert got["logit_err"] > 100 * sound["logit_err"]["value"]


def _all_dropped(monkeypatch):
    """Every routed assignment dropped: the routed experts' output lost."""
    from repro_torch.models import moe
    route = moe._route

    def lost(*a, **kw):
        tok_idx, weight, experts, slot, aux = route(*a, **kw)
        return tok_idx, weight * 0, experts, slot * 0 - 1, aux
    monkeypatch.setattr(moe, "_route", lost)


def _token_altered(monkeypatch):
    from repro_torch.models import model as mdl
    step = mdl.decode_step

    def altered(*a, **kw):
        logits, cache = step(*a, **kw)
        return logits.roll(1, dims=-1), cache
    monkeypatch.setattr(mdl, "decode_step", altered)


@pytest.mark.parametrize("fault", [_all_dropped, _token_altered])
def test_broken_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = harness.run(small_cell(), SEED, 0.5, False, CPU)
    assert not out["correct"], out["checks"]


# ---------------------------------------------------------------------------
# the readers on records made by hand
# ---------------------------------------------------------------------------

def _reader(name):
    path = harness.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Span:
    def __init__(self, name, id, parent, unit, ms=None, counts=None):
        self.name, self.id, self.parent, self.unit = name, id, parent, unit
        self.device_ms, self.counts = ms, counts or {}


M = {"n_layers": 2, "d_model": 4, "d_expert": 8, "n_experts": 3,
     "dtype": "float32"}


def _records(monkeypatch, with_spans=True, with_counts=True):
    """Two traced requests then one steady: each a prefill of 2 layers
    (``moe.block`` 3 ms, ``moe.experts`` 2 ms each) and a decode span
    with its own MoE spans, which no prefill reader counts."""
    from repro_torch import trace
    units, spans, sid = [], [], 100
    for j, (plen, routed, dropped) in enumerate([(10, 40, 4), (20, 80, 0),
                                                 (5, 20, 1)]):
        u = trace.Unit("serve.generate", {"batch": 1, "prompt_len": plen,
                                          "gen": 2})
        u.start_ns = 10 + j
        u.counts = ({"moe.assignments_routed": routed + 16,
                     "moe.assignments_dropped": dropped}
                    if with_counts else {})
        units.append(u)
        pre = _Span("serve.prefill", sid, u.id, u.id, counts=(
            {"moe.assignments_routed": routed,
             "moe.assignments_dropped": dropped} if with_counts else {}))
        spans.append(pre)
        if with_spans:
            for layer in range(2):
                blk = _Span("moe.block", sid + 1 + 2 * layer, pre.id, u.id,
                            3.0)
                spans += [blk, _Span("moe.experts", blk.id + 1, blk.id, u.id,
                                     2.0)]
            spans.append(_Span("moe.block", sid + 9, None, u.id, 50.0))
        sid += 10
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return SimpleNamespace(trace=SimpleNamespace(lo=5), traced=2,
                           units=[{}, {}, {}], model=M)


def test_moe_ms_per_ktok_reads_the_prefills(monkeypatch):
    rec = _records(monkeypatch)
    # 2 prefills x 2 layers x 3 ms over 30 prompt tokens
    assert _reader("moe_ms_per_ktok.serve").read(rec) == pytest.approx(
        1e3 * 12.0 / 30)


def test_moe_roofline_reads_the_prefills(monkeypatch):
    from sagebench.counts import HBM_BYTES_PER_S, PEAK_FLOPS
    rec = _records(monkeypatch)
    weights = 2 * 3 * 4 * 8 * 3 * 4              # 2 layers, 3 experts, f32
    least = sum(max(kept * 6 * 4 * 8 / PEAK_FLOPS["float32"],
                    weights / HBM_BYTES_PER_S) for kept in (36, 80))
    assert _reader("moe_roofline.serve").read(rec) == pytest.approx(
        100.0 * least / (2 * 2 * 2.0 / 1e3))


def test_moe_drop_share_reads_every_window_unit(monkeypatch):
    rec = _records(monkeypatch)
    assert _reader("moe_drop_share.serve").read(rec) == pytest.approx(
        100.0 * 5 / (140 + 3 * 16))


@pytest.mark.parametrize("reader", ["moe_ms_per_ktok.serve",
                                    "moe_roofline.serve",
                                    "moe_drop_share.serve"])
@pytest.mark.parametrize("missing", ["spans", "counts", "trace", "events"])
def test_moe_readers_read_none_without_their_records(monkeypatch, reader,
                                                     missing):
    rec = _records(monkeypatch, with_spans=missing != "spans",
                   with_counts=missing != "counts")
    if missing == "trace":
        rec.trace = None
    if missing == "events":             # spans kept without CUDA events
        from repro_torch import trace
        for s in trace.spans():
            s.device_ms = None
    got = _reader(reader).read(rec)
    reads_spans = reader != "moe_drop_share.serve"
    if missing == "trace" or missing == "counts" and reader != \
            "moe_ms_per_ktok.serve" or missing in ("spans", "events") \
            and reads_spans:
        assert got is None
    else:
        assert isinstance(got, float)
