"""Whole runs of every cell at CPU sizes (the program's plain versions):
untouched they read correct, with the reference agreeing; with the timed
path broken underneath, once for each fault the cell can have, they read
not correct.  The control (the reference at TF32 in the program's place)
fails a limit too."""
import copy
import json

import pytest
import torch

from small_cells import SEED, small_cell
from sagebench import harness
from sagebench.drivers import serve as serve_driver
from sagebench.drivers import train as train_driver

CPU = torch.device("cpu")
TRAIN = ["mamba2-train"]
SERVE = ["mamba2-longprompt"]


def run(cell, trace=False):
    out = harness.run(cell, SEED, 0.5, trace, CPU)
    json.dumps(out)
    return out


@pytest.mark.parametrize("name", TRAIN + SERVE)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    cell = small_cell(name)
    out = run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    got = set(out["metrics"])
    if trace:      # on the CPU no reader finds a device trace to read;
        # a tail needs ten requests (ttft_p90_s.saturated reads none below)
        few = {"ttft_p90_s.saturated"} if out["attempted"] < 10 else set()
        assert {m["name"] for m in cell.per_layer
                if m["source"] != "device_trace"} - few <= got \
            <= {m["name"] for m in cell.per_layer}
    else:
        assert got == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"


def _frozen_optimizer(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.launch import steps

    def frozen(params, grads, state, run):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(steps, "adamw_update", frozen)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.launch.train import Trainer
    from sagebench.control import halved
    monkeypatch.setattr(Trainer, "step", halved(Trainer.step))


def _setup_steps(name):
    t = small_cell(name).traffic
    return t["checked_steps"] + t["warmup_steps"]


def _after_setup(monkeypatch, name, fault):
    """``Trainer.step`` whose calls after the set-up's go through
    ``fault(step, self, params, opt, batch)``."""
    from repro_torch.launch.train import Trainer
    step, calls = Trainer.step, []

    def counted(self, params, opt, batch):
        calls.append(1)
        if len(calls) <= _setup_steps(name):
            return step(self, params, opt, batch)
        return fault(step, self, params, opt, batch)
    monkeypatch.setattr(Trainer, "step", counted)


def _frozen_after_setup(monkeypatch, name):
    """Steps that return the state unchanged once the window opens (the
    loss still worked out)."""
    from sagebench.weights import clone_tree

    def frozen(step, self, params, opt, batch):
        _, _, met = step(self, clone_tree(params),
                         type(opt)(*(clone_tree(x) for x in opt)), batch)
        return params, opt, met
    _after_setup(monkeypatch, name, frozen)


def _stale_batch_after_setup(monkeypatch, name):
    """Steps that keep re-reading the first batch of the window."""
    seen = []

    def stale(step, self, params, opt, batch):
        seen.append(batch)
        return step(self, params, opt, seen[0])
    _after_setup(monkeypatch, name, stale)


def _decode_state_unchanged(monkeypatch):
    """A decode step that returns the state it was given."""
    from repro_torch.models import model as mdl
    step = mdl.decode_step

    def stale(params, token, position, cfg, cache):
        logits, _ = step(params, token, position, cfg, copy.deepcopy(cache))
        return logits, cache
    monkeypatch.setattr(mdl, "decode_step", stale)


def _token_altered(monkeypatch):
    """A decode step whose logits, and so its token, come out altered."""
    from repro_torch.models import model as mdl
    step = mdl.decode_step

    def altered(*a, **kw):
        logits, cache = step(*a, **kw)
        return logits.roll(1, dims=-1), cache
    monkeypatch.setattr(mdl, "decode_step", altered)


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in TRAIN for f in (_frozen_optimizer, _half_batch)] + [
    (n, f) for n in SERVE for f in (_decode_state_unchanged,
                                    _token_altered)])
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(small_cell(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault,number", [
    (_frozen_after_setup, "change_gap"),
    (_stale_batch_after_setup, "loss_gap")])
def test_fault_after_setup_is_not_correct(name, fault, number, monkeypatch):
    """A fault that sets in once the window opens, after the set-up's
    checked steps passed, fails the check of the window's steps."""
    fault(monkeypatch, name)
    out = run(small_cell(name))
    assert not out["correct"], out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_open_loop_waits_for_arrivals(name):
    """Below the knee the server idles until each request arrives: a
    window serves about rate x seconds requests, and reads correct."""
    cell = small_cell(name, arrivals={"shape": 0.5, "rate": 8.0})
    out = harness.run(cell, SEED, 1.0, False, CPU)
    assert out["correct"], out["checks"]
    assert 3 <= out["attempted"] <= 20


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_fails_a_limit(name, tmp_path):
    """The reference at TF32, read in the program's place, fails one of
    the cell's limits."""
    from sagebench import control
    cell = small_cell(name)
    driver = train_driver if name in TRAIN else serve_driver
    with harness.store_under(tmp_path):
        ctx = harness.Context(cell, SEED, 0.5, False, CPU, tmp_path, 0.0)
        rec = driver.measure(ctx)
        if driver is train_driver:
            got = control.train_control(ctx, rec)
        else:
            got = control.serve_control(ctx, rec)
    assert any(v > cell.limits[k] for k, v in got.items()), got
