"""The weights of a cell, drawn on the device from the run's seed.

The tree has the program's layout (its names and shapes, read from the
program's parameter tree on the ``meta`` device, where nothing is drawn),
but every value is the benchmark's: one ``torch.randn`` on a generator on
the device fills one flat float32 buffer, every random leaf is a view of
it, scaled in place by 1/sqrt(fan-in).  Leaves with a published
initialisation take it instead: norm scales and D at one, Mamba-2's A in
[1, 16] and its dt bias from dt log-uniform in [0.001, 0.1].  Both the
program and the reference read the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# leaves set to one: norm scales and Mamba-2's skip D
ONES = ("scale", "norm", "d_skip", "q_norm", "k_norm")
# the axes whose product is a random leaf's fan-in (default: the first)
FAN_IN_AXES = {"embed": (1,), "wo": (0, 1), "w_gate": (1,), "w_up": (1,),
               "w_down": (1,)}
# biases, drawn at a small fixed scale
BIASES = ("bq", "bk", "bv", "conv_b")
BIAS_STD = 0.02
DT_RANGE = (1e-3, 1e-1)


def _paths(tree, prefix=()) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _fan_in(name: str, shape) -> int:
    axes = FAN_IN_AXES.get(name, (0,))
    return math.prod(shape[a] for a in axes)


def make_params(like, seed: int, device: torch.device) -> Dict:
    """A tree shaped as ``like`` (the program's tree on ``meta``) with
    float32 values drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves = _paths(like)
    rand = [(p, t) for p, t in leaves
            if p[-1] not in ONES + ("a_log", "dt_bias")]
    flat = torch.randn(sum(t.numel() for _, t in rand), generator=gen,
                       device=device)
    out = like
    off = 0
    for path, t in rand:
        leaf = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        leaf.mul_(BIAS_STD if path[-1] in BIASES
                  else _fan_in(path[-1], t.shape) ** -0.5)
        _set(out, path, leaf)
    for path, t in leaves:
        name = path[-1]
        if name in ONES:
            _set(out, path, torch.ones(t.shape, device=device))
        elif name == "a_log":
            _set(out, path, torch.log(torch.linspace(1.0, 16.0, t.numel(),
                                                     device=device)))
        elif name == "dt_bias":
            lo, hi = (math.log(v) for v in DT_RANGE)
            dt = torch.exp(torch.rand(t.shape, generator=gen, device=device)
                           * (hi - lo) + lo)
            _set(out, path, dt + torch.log(-torch.expm1(-dt)))
    return out


def clone_tree(tree):
    """A copy of every leaf (the state before training moves it)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


def leaf_list(tree) -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) in the tree's order."""
    return [("/".join(map(str, p)), t) for p, t in _paths(tree)]
