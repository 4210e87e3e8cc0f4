"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's cases and bytes, on the CPU.

Leaf names come from ``repro_torch.tree`` and must be
``jax.tree_util``'s for the same tree; with the clock pinned the two
packages write the same manifest and leaf bytes, and each restores what
the other wrote, for every strategy.  Restored leaves are compared bit
for bit.
"""
import time
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.core.addb import Addb as RefAddb
from repro.core.clovis import Clovis as RefClovis
from repro.optim import AdamWState as RefAdamWState
from repro_torch.checkpoint import CKPT_CONTAINER, CheckpointManager
from repro_torch.core import Addb, Clovis
from repro_torch.optim import AdamWState
from repro_torch.tree import flatten_with_names, leaves, tree_map

STRATEGIES = ["collective", "window", "stream"]


@pytest.fixture()
def cl(tmp_path):
    return Clovis(tmp_path / "sage", addb=Addb(), devices_per_tier=3,
                  device="cpu")


def _state():
    return {"params": {"w": torch.arange(24.0).reshape(4, 6),
                       "b": torch.full((6,), 0.5)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _like(state):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)


def _equal(a, b):
    fa, fb = flatten_with_names(a), flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert x.tobytes() == y.tobytes(), n


class Pair(NamedTuple):
    first: object
    second: object


def _numpy_tree():
    """One tree of numpy leaves both packages flatten: dicts, a list, a
    None, an AdamW-like NamedTuple and a scalar."""
    rng = np.random.default_rng(0)
    return {"params": {"zeta": rng.standard_normal((3, 5)).astype(np.float32),
                       "alpha": [rng.integers(0, 9, (4,)).astype(np.int32),
                                 None,
                                 rng.standard_normal((2,)).astype(np.float32)]},
            "opt": Pair(np.int32(7), {"m": np.ones((2, 2), np.float32)}),
            "step": np.int32(11)}


def test_leaf_names_are_jax_tree_util_names():
    tree = _numpy_tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx",
                                                   getattr(p, "name", "x"))))
                     for p in path) for path, _ in flat]
    assert [n for n, _ in flatten_with_names(tree)] == want
    assert want[0] == "opt/first" and "params/alpha/2" in want
    state = AdamWState(torch.zeros((), dtype=torch.int32),
                       {"a": torch.ones(2)}, {"a": torch.ones(2)})
    ref = RefAdamWState(np.int32(0), {"a": np.ones(2)}, {"a": np.ones(2)})
    assert [n for n, _ in flatten_with_names(state)] == [
        "/".join(str(getattr(p, "name", getattr(p, "key", None)))
                 for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_roundtrip(cl, strategy):
    cm = CheckpointManager(cl, strategy=strategy)
    st = _state()
    info = cm.save(10, st)
    assert info.n_leaves == 3
    out = cm.restore(10, like=_like(st))
    assert out["params"]["w"].device == torch.device("cpu")
    _equal(out, st)
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 3
    cm.close()


def test_crash_mid_checkpoint_preserves_previous(cl):
    cm = CheckpointManager(cl, strategy="collective")
    st = _state()
    cm.save(10, st)
    txn = cl.transaction([cm._oid(20, "params/w"), cm._manifest_oid(20)])
    txn.__enter__()
    cm._write_leaf(cm._oid(20, "params/w"), np.zeros((4, 6), np.float32),
                   txn=txn)
    assert cl.store.recover() >= 0
    assert cm.latest_step() == 10
    _equal(cm.restore(like=_like(st)), st)
    cm.close()


def test_retirement_keeps_last_k(cl):
    cm = CheckpointManager(cl, strategy="window", keep=2)
    st = _state()
    paths = []
    for step in (1, 2, 3, 4):
        cm.save(step, st)
        manifest = cl.get(cm._manifest_oid(step))
        paths.append(__import__("json").loads(manifest)["leaves"]
                     ["params/w"]["window"])
    assert cm.latest_step() == 4
    assert not cl.exists(cm._manifest_oid(1))
    assert cl.exists(cm._manifest_oid(3)) and cl.exists(cm._manifest_oid(4))
    exists = [__import__("os").path.exists(p) for p in paths]
    assert exists == [False, False, True, True]
    cm.close()


def test_stream_checkpoint_overlaps(cl):
    cm = CheckpointManager(cl, strategy="stream")
    st = {"params": {"w": torch.ones((256, 256))}}
    cm.save(7, st, block=False)
    assert cm.wait(7)
    assert float(cm.restore(7, like=_like(st))["params"]["w"].sum()) == \
        256 * 256
    cm.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_async_save_then_in_place_update_restores_the_saved_values(
        cl, strategy):
    """The port's optimizer updates in place: a save must have copied
    every leaf before it returns, a non-blocking stream save included."""
    cm = CheckpointManager(cl, strategy=strategy)
    st = {"params": {"w": torch.arange(4096.0).reshape(64, 64)},
          "opt": AdamWState(torch.tensor(5, dtype=torch.int32),
                            {"w": torch.ones(64, 64)},
                            {"w": torch.full((64, 64), 2.0)})}
    want = tree_map(lambda t: t.clone(), st)
    cm.save(5, st, block=False)
    for t in leaves(st):
        t.add_(1)                           # the next step, at once
    assert cm.wait()
    _equal(cm.restore(5, like=_like(st)), want)
    cm.close()


# ---------------------------------------------------------------------------
# the two packages' bytes
# ---------------------------------------------------------------------------

def _pin_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)


def _objects(store):
    return {oid: store.get(oid) for oid in store.container(CKPT_CONTAINER)}


def test_manifest_and_leaf_bytes_equal_the_references(tmp_path,
                                                      monkeypatch):
    _pin_clock(monkeypatch)
    tree = _numpy_tree()
    ref = RefClovis(tmp_path / "ref", addb=RefAddb(), devices_per_tier=3)
    port = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                  device="cpu")
    RefManager(ref, strategy="collective").save(3, tree)
    CheckpointManager(port, strategy="collective").save(3, tree)
    want, got = _objects(ref), _objects(port)
    assert sorted(got) == sorted(want)
    assert "ckpt/3/manifest" in got and "ckpt/3/h0/opt/first" in got
    assert got == want


def _ref_like(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a),
                                                       np.asarray(a).dtype),
                        tree)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_reference_checkpoint_restores_in_the_port(tmp_path, strategy):
    tree = _numpy_tree()
    root = tmp_path / "shared"
    ref = RefClovis(root, addb=RefAddb(), devices_per_tier=3)
    cm = RefManager(ref, strategy=strategy)
    cm.save(4, tree)
    cm.close()
    port = Clovis(root, addb=Addb(), devices_per_tier=3, device="cpu")
    pm = CheckpointManager(port, strategy=strategy)
    assert pm.latest_step() == 4
    _equal(pm.restore(like=tree), tree)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_port_checkpoint_restores_in_the_reference(tmp_path, strategy):
    tree = _numpy_tree()
    torch_tree = tree_map(torch.as_tensor, tree)
    root = tmp_path / "shared"
    port = Clovis(root, addb=Addb(), devices_per_tier=3, device="cpu")
    pm = CheckpointManager(port, strategy=strategy)
    pm.save(4, torch_tree)
    pm.close()
    ref = RefClovis(root, addb=RefAddb(), devices_per_tier=3)
    out = RefManager(ref, strategy=strategy).restore(like=_ref_like(tree))
    _equal(jax.tree.map(np.asarray, out), tree)
