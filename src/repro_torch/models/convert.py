"""Carry the reference's parameters into the port.

``params_from_jax`` takes the JAX package's parameter tree with every
leaf converted to a numpy array (``jax.tree.map(np.asarray, params)``, so
this module needs no JAX) and returns the port's tree on ``device``.  The
reference stacks the repeated layers for ``lax.scan`` when the pattern
repeats more than once (its ``"scan"`` layout: one tree per pattern
position, each leaf with a leading ``reps`` axis); the port keeps one
dict per layer, so those are unstacked in layer order.  The
``"unrolled"``, ``"extra"`` and ``"prefix"`` lists map one for one, and
so does deepseek's ``"mtp"`` subtree (one block, never stacked).
Whisper's ``"encoder"`` subtree holds a stack of its own (32 layers of
pattern ``("encoder",)``, so scanned at full depth), unstacked by the
encoder's plan.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import _encoder_cfg
from repro_torch.models.transformer import check_config, stack_plan


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def _stack(stack: Dict[str, Any], cfg: ModelConfig, leaf) -> Dict:
    """One stack of the reference (prefix, scan or unrolled, extra) as
    the port's per-layer lists."""
    prefix, reps, pattern, _ = stack_plan(cfg)
    if "scan" in stack:
        body = [_tree(stack["scan"][pos], lambda a, r=r: np.asarray(a)[r])
                for r in range(reps) for pos in range(len(pattern))]
    else:
        body = stack["unrolled"]
    out = {"prefix": _tree(stack["prefix"], leaf),
           "unrolled": _tree(body, leaf),
           "extra": _tree(stack["extra"], leaf)}
    if len(out["unrolled"]) != reps * len(pattern) or \
            len(out["prefix"]) != prefix:
        raise ValueError(f"the parameter tree does not fit {cfg.name}'s "
                         f"stack plan")
    return out


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameters (numpy leaves) as the port's tree."""
    check_config(cfg)
    dev = resolve_device(device)
    extra = sorted(set(tree) - {"embed", "decoder", "ln_f", "lm_head",
                                "mtp", "encoder"})
    if extra:
        raise ValueError(f"unknown parameters {extra}")

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    out = {k: _tree(v, leaf) for k, v in tree.items()
           if k not in ("decoder", "encoder")}
    out["decoder"] = _stack(tree["decoder"], cfg, leaf)
    if "encoder" in tree:
        out["encoder"] = {
            "stack": _stack(tree["encoder"]["stack"], _encoder_cfg(cfg),
                            leaf),
            "ln_f": _tree(tree["encoder"]["ln_f"], leaf)}
    return out


def _stacks(cfg: ModelConfig):
    """(key path, stack config) of each layer stack of a parameter tree."""
    out = [(("decoder",), cfg)]
    if cfg.is_encoder_decoder:
        out.append((("encoder", "stack"), _encoder_cfg(cfg)))
    return out


def _scanned(stack_cfg: ModelConfig) -> bool:
    """Whether the reference's default (``scan_layers=True``) layout
    stacks this stack's body: it does when the pattern repeats."""
    return stack_plan(stack_cfg)[1] > 1


def _replace(tree: Dict, path, fn) -> Dict:
    if len(path) == 1:
        return {**tree, path[0]: fn(tree[path[0]])}
    return {**tree, path[0]: _replace(tree[path[0]], path[1:], fn)}


def to_scan_layout(params: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The port's parameter tree (tensors, ``meta`` ones included) in the
    reference's default layout: each repeated body stacked under
    ``"scan"``, one tree per pattern position with a leading ``reps``
    axis (the names its checkpoints carry)."""
    from repro_torch.tree import tree_map
    for path, scfg in _stacks(cfg):
        if not _scanned(scfg):
            continue
        _, reps, pattern, _ = stack_plan(scfg)
        period = len(pattern)

        def stack(st, reps=reps, period=period):
            body = st["unrolled"]
            scan = [tree_map(lambda *ls: torch.stack(ls),
                             *[body[r * period + pos] for r in range(reps)])
                    for pos in range(period)]
            return {k: v for k, v in st.items() if k != "unrolled"} | {
                "scan": scan}
        params = _replace(params, path, stack)
    return params


def from_scan_layout(params: Dict[str, Any], cfg: ModelConfig
                     ) -> Dict[str, Any]:
    """``to_scan_layout`` undone: one dict per layer under
    ``"unrolled"``."""
    from repro_torch.tree import tree_map
    for path, scfg in _stacks(cfg):
        if not _scanned(scfg):
            continue
        _, reps, pattern, _ = stack_plan(scfg)

        def unstack(st, reps=reps, period=len(pattern)):
            body = [tree_map(lambda a, r=r: a[r], st["scan"][pos])
                    for r in range(reps) for pos in range(period)]
            return {k: v for k, v in st.items() if k != "scan"} | {
                "unrolled": body}
        params = _replace(params, path, unstack)
    return params
