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
