"""The ``deepseek-v3-longqa`` cell at CPU sizes: the plain reference
against the program's prefill and absorbed decode through its latent
cache (group-limited routing over the router's experts, a share of them
held, capacity dropping tokens, YaRN past the original positions), whole
runs that read correct, planted MLA and routing faults that do not, and
the three MLA readers on records made by hand, None where they have
nothing to read."""
import copy
import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from small_cells import SEED
from sagebench import harness
from sagebench.reference import deepseek_v3
from sagebench.weights import make_params

CPU = torch.device("cpu")
CELL = "deepseek-v3-longqa"
# deepseek-v3's SMOKE widths, 1 dense and 2 MoE layers; the router's 16
# experts in 4 groups (top 2 kept), 4 of them held from expert 4 on; YaRN
# from 16 original positions, so that the prompts reach past them
SMALL = dict(n_layers=3, n_dense_layers=1, d_model=64, n_heads=4,
             n_kv_heads=4, head_dim=24, q_lora_rank=32, kv_lora_rank=16,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             vocab_size=256, dense_d_ff=128, d_ff=32, d_expert=32,
             d_shared_expert=32, n_experts=4, router_experts=16,
             first_expert=4, top_k=4, n_group=4, topk_group=2,
             yarn_original_max_position=16)
# f32 sums in another order over 3 layers, the routes equal: ~1e-6
LOGIT_RTOL = 1e-5


def small_cell(**traffic) -> harness.Cell:
    c = harness.Cell(CELL)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(SMALL)
    t = copy.deepcopy(c.traffic)
    t.update(prompt_len={"median": 30, "sigma": 0.6, "min": 16, "max": 64},
             arrivals={"shape": 0.5, "rate": 1000.0}, strata=4, gen=4,
             checked_tokens=16, trace_units=2)
    t.update(traffic)
    c.traffic = t
    return c


def _served(cell, params, prompt, gen):
    """The program's prefill and greedy decode through its cache ->
    (logits (1, gen, vocab), the unit's counts)."""
    from repro_torch import trace
    from repro_torch.models import model as mdl
    cfg = cell.port_config()
    tokens = torch.as_tensor(np.random.default_rng(prompt).integers(
        0, cell.model["vocab_size"], (1, prompt)))
    cache = mdl.init_decode_state(cfg, 1, prompt + gen, dtype=torch.float32,
                                  device=CPU)
    trace.drop_device_counts(CPU)
    with trace.unit("test.earlier"):    # takes what earlier tests counted
        pass                            # outside any unit
    with trace.unit("test.serve") as u:
        logits, cache = mdl.prefill(params, {"tokens": tokens}, cfg, cache)
        got = [logits]
        for i in range(gen - 1):
            logits, cache = mdl.decode_step(
                params, got[-1].argmax(-1)[:, None], prompt + i, cfg, cache)
            got.append(logits)
        trace.settle_device_counts(CPU)
    return tokens, torch.stack(got, dim=1), u.counts


@pytest.mark.parametrize("prompt,gen", [(21, 5), (40, 4), (9, 6)])
def test_reference_matches_prefill_then_decode(prompt, gen):
    """The reference's logits at the served positions against the
    program's prefill and absorbed ``decode_step`` through its latent
    cache, fed the program's greedy tokens, on the benchmark's seeded
    weights; the longer prompts drop tokens at capacity."""
    from repro_torch.models import model as mdl
    cell = small_cell()
    m = cell.model
    params = make_params(mdl.params_like(cell.port_config()), SEED + prompt,
                         CPU)
    tokens, got, counts = _served(cell, params, prompt, gen)
    served = got.argmax(-1)
    h = deepseek_v3.serve_hidden(params, tokens, served, m, False)
    want = deepseek_v3.head(params, h[:, prompt - 1:], m, False)
    err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(err.max()) <= LOGIT_RTOL
    assert counts["mla.prefill_layers"] == m["n_layers"]
    assert 0 < counts["moe.assignments_routed"] < 2 * (prompt + gen) * 4
    if prompt >= 40:
        assert counts["moe.assignments_dropped"] > 0


def test_reference_gate_limits_groups_and_scales():
    """An excluded group keeps out its best expert; the gates are the
    unbiased scores renormalised and scaled."""
    m = dict(small_cell().model)
    d, e = 4, 16
    p = {"router": torch.zeros((d, e)), "router_bias": torch.full((e,),
                                                                  -0.4)}
    p["router_bias"][0] = 0.45            # group 0's top 2: 1.05
    p["router_bias"][4:6] = 0.2           # group 1's: 1.4
    p["router_bias"][8:10] = 0.1          # group 2's: 1.2
    chosen, w, _ = deepseek_v3.gate(p, torch.zeros((2, d)), m, False)
    assert 0 not in chosen.flatten().tolist()
    assert set(chosen[0].tolist()) <= set(range(4, 12))
    assert torch.allclose(w.sum(-1), torch.full((2,), 2.5))


def test_model_flops_by_hand():
    m = harness.Cell(CELL).model
    d, h = 7168, 128
    mla = 2 * (d * 1536 + 1536 * h * 192 + d * 576 + 512 * h * 256
               + h * 128 * d)
    assert mla == 374_210_560
    moe = 2 * d * 256 + 8 * 8 * 6 * d * 2048 // 256 + 6 * d * 2048
    body = 9 * mla + 6 * d * 18432 + 8 * moe
    assert deepseek_v3.layer_flops_per_token(m) == body
    head = 2 * d * 129280
    # prompt 3, gen 2: queries at positions 0-4 see 1-5 keys
    attn = 9 * 2 * h * 320 * 15
    assert deepseek_v3.model_flops(m, 1, 3, 2) == 5 * body + 3 * head + attn


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    cell = small_cell()
    out = harness.run(cell, SEED, 0.5, trace, CPU)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    if trace:      # on the CPU no device-trace reader finds anything
        assert {m["name"] for m in cell.per_layer
                if m["source"] != "device_trace"} <= got
        assert 0 < out["metrics"]["mla_decode_read_share.serve"]["value"] \
            < 100
    else:
        assert got == {m["name"] for m in cell.end_to_end}


# ---------------------------------------------------------------------------
# planted faults (patched before the Server is built)
# ---------------------------------------------------------------------------

def _yarn_off(monkeypatch):
    from repro_torch.models import common, mla
    monkeypatch.setattr(mla, "rope_inv_freq", lambda cfg, dim, device:
                        common.rope_frequencies(dim, cfg.rope_theta,
                                                device=device))


def _mscale_off(monkeypatch):
    from repro_torch.models import mla
    monkeypatch.setattr(mla, "_scale", lambda cfg: (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5)


def _decode_ahead(monkeypatch):
    from repro_torch.models import mla
    decode = mla.mla_decode
    monkeypatch.setattr(mla, "mla_decode", lambda p, x, position, cfg,
                        cache: decode(p, x, position + 1, cfg, cache))


def _stale_latent(monkeypatch):
    """A decode step's latent slot keeps what it held before the step
    (the new latent is read by that step but never stored)."""
    from repro_torch.models import mla
    decode = mla._decode

    def stale(p, x, position, cfg, cache):
        slot = min(position, cache["ckv"].shape[1] - 1)
        old = cache["ckv"][:, slot].clone()
        out, cache = decode(p, x, position, cfg, cache)
        cache["ckv"][:, slot] = old
        return out, cache
    monkeypatch.setattr(mla, "_decode", stale)


def _groups_unlimited(monkeypatch):
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "group_limited", lambda sel, cfg: sel)


def _unscaled(monkeypatch):
    from repro_torch.models import moe
    gates = moe._selected_gates
    monkeypatch.setattr(moe, "_selected_gates", lambda g, m, cfg: gates(
        g, m, cfg) / cfg.routed_scaling_factor)


def _absent_added(monkeypatch):
    """Every expert's assignments folded onto the held expert of the same
    index modulo the share: the absent experts' gates added to the held
    ones' (their outputs computed with the held weights)."""
    from repro_torch.models import moe

    def folded(t, cfg):
        f = t.reshape(*t.shape[:-1], -1, cfg.n_experts)
        return f.any(-2) if t.dtype == torch.bool else f.sum(-2)
    monkeypatch.setattr(moe, "_held", folded)


FAULTS = [_yarn_off, _mscale_off, _decode_ahead, _stale_latent,
          _groups_unlimited, _unscaled, _absent_added]


@pytest.mark.parametrize("fault", FAULTS)
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


M = {"n_layers": 2, "n_heads": 2, "qk_nope_head_dim": 3,
     "qk_rope_head_dim": 1, "v_head_dim": 2, "dtype": "float32"}


def _records(monkeypatch, with_spans=True, with_counts=True):
    """Two traced requests then one steady: each a prefill of 2 layers
    (``mla.block`` 3 ms, ``mla.attention`` 2 ms each) and a decode span
    with its own MLA block, which no prefill reader counts; each unit
    counts its decode slots."""
    from repro_torch import trace
    units, spans, sid = [], [], 100
    for j, (plen, read, valid) in enumerate([(10, 60, 33), (20, 60, 63),
                                             (5, 60, 18)]):
        u = trace.Unit("serve.generate", {"batch": 1, "prompt_len": plen,
                                          "gen": 2})
        u.start_ns = 10 + j
        u.counts = ({"mla.decode_slots_read": read,
                     "mla.decode_slots_valid": valid}
                    if with_counts else {})
        units.append(u)
        pre = _Span("serve.prefill", sid, u.id, u.id)
        spans.append(pre)
        if with_spans:
            for layer in range(2):
                blk = _Span("mla.block", sid + 1 + 2 * layer, pre.id, u.id,
                            3.0)
                spans += [blk, _Span("mla.attention", blk.id + 1, blk.id,
                                     u.id, 2.0)]
            spans.append(_Span("mla.block", sid + 9, None, u.id, 50.0))
        sid += 10
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return SimpleNamespace(trace=SimpleNamespace(lo=5), traced=2,
                           units=[{}, {}, {}], model=M)


def test_mla_ms_per_ktok_reads_the_prefills(monkeypatch):
    rec = _records(monkeypatch)
    # 2 prefills x 2 layers x 3 ms over 30 prompt tokens
    assert _reader("mla_ms_per_ktok.serve").read(rec) == pytest.approx(
        1e3 * 12.0 / 30)


def test_mla_attn_roofline_reads_the_prefills(monkeypatch):
    from sagebench.counts import HBM_BYTES_PER_S, PEAK_FLOPS
    rec = _records(monkeypatch)
    least = 0.0
    for s in (10, 20):      # h s (s + 1) / 2 keys x 2 (4 + 2); q/k/v/o
        flops = 2 * s * (s + 1) // 2 * 2 * 6
        nbytes = s * 2 * 2 * 6 * 4
        least += 2 * max(flops / PEAK_FLOPS["float32"],
                         nbytes / HBM_BYTES_PER_S)
    assert _reader("mla_attn_roofline.serve").read(rec) == pytest.approx(
        100.0 * least / (2 * 2 * 2.0 / 1e3))


def test_mla_decode_read_share_reads_every_window_unit(monkeypatch):
    rec = _records(monkeypatch)
    assert _reader("mla_decode_read_share.serve").read(rec) == \
        pytest.approx(100.0 * 114 / 180)


@pytest.mark.parametrize("reader", ["mla_ms_per_ktok.serve",
                                    "mla_attn_roofline.serve",
                                    "mla_decode_read_share.serve"])
@pytest.mark.parametrize("missing", ["spans", "counts", "trace", "events"])
def test_mla_readers_read_none_without_their_records(monkeypatch, reader,
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
    reads_spans = reader != "mla_decode_read_share.serve"
    if missing == "trace" or (missing == "counts" and not reads_spans) \
            or (missing in ("spans", "events") and reads_spans):
        assert got is None
    else:
        assert isinstance(got, float)
