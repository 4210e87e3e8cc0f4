"""Carry the reference's parameters into the port.

``params_from_jax`` takes the JAX package's parameter tree with every
leaf converted to a numpy array (``jax.tree.map(np.asarray, params)``, so
this module needs no JAX) and returns the port's tree on ``device``.  The
reference stacks the repeated layers for ``lax.scan`` when the pattern
repeats more than once (its ``"scan"`` layout: one tree per pattern
position, each leaf with a leading ``reps`` axis); the port keeps one
dict per layer, so those are unstacked in layer order.  The
``"unrolled"``, ``"extra"`` and ``"prefix"`` lists map one for one.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import check_config, stack_plan


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameters (numpy leaves) as the port's tree."""
    check_config(cfg)
    dev = resolve_device(device)
    extra = sorted(set(tree) - {"embed", "decoder", "ln_f", "lm_head"})
    if extra:
        raise NotImplementedError(f"parameters {extra} belong to families "
                                  f"not ported yet (ROADMAP A11)")

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    dec = tree["decoder"]
    prefix, reps, pattern, _ = stack_plan(cfg)
    if "scan" in dec:
        body = [_tree(dec["scan"][pos], lambda a, r=r: np.asarray(a)[r])
                for r in range(reps) for pos in range(len(pattern))]
    else:
        body = dec["unrolled"]
    out = {k: _tree(v, leaf) for k, v in tree.items() if k != "decoder"}
    out["decoder"] = {"prefix": _tree(dec["prefix"], leaf),
                      "unrolled": _tree(body, leaf),
                      "extra": _tree(dec["extra"], leaf)}
    if len(out["decoder"]["unrolled"]) != reps * len(pattern) or \
            len(out["decoder"]["prefix"]) != prefix:
        raise ValueError(f"the parameter tree does not fit {cfg.name}'s "
                         f"stack plan")
    return out
