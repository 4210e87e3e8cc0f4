"""Sharding rules: parameter / cache / batch specs, and their placement
as ``DTensor``s (the port of ``repro.distributed.sharding``).

Name-driven rules (megatron TP + optional ZeRO-3 FSDP over the data axis):

  * attention: q/o heads -> 'model'; kv heads -> 'model' when divisible,
    replicated otherwise (GQA with kv < tp); biases follow.
  * MLP: hidden dim -> 'model'.
  * MoE: expert dim -> 'model' (expert parallelism); router replicated.
  * MLA: per-head projections -> 'model' on the head dim; latents FSDP'd.
  * embedding / lm_head: vocab -> 'model'.
  * SSM (mamba2-scale models): replicated weights, DP only.
  * FSDP: after TP assignment, the largest remaining divisible dim of any
    >=2D parameter is sharded over 'data'.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, each None, a mesh-axis name, or a tuple of names that
split the dim together (major first, in mesh order).  The port keeps one
parameter dict per layer (``"unrolled"``), where the reference stacks
repeated layers under ``"scan"`` with a leading ``reps`` axis that it
never shards; so a port spec is the reference's with that leading None
dropped, and the FSDP search starts at dim 0 where the reference's
started at dim 1.

``placements(spec, mesh)`` turns a spec into the ``Shard``/``Replicate``
list of a ``DeviceMesh``, and ``distribute(tree, specs, mesh)`` places a
tree.  A mesh is a ``DeviceMesh`` or a ``launch.mesh.MeshShape``; a
mesh dim named ``"pod+data"`` holds those two axes flattened (the dry
run's two-pod mesh: ``launch.dryrun``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MeshLike, MeshShape, mesh_axis_sizes
from repro_torch.models.common import AxisRules
from repro_torch.tree import flatten_with_names, tree_map, unflatten

Spec = Tuple[object, ...]

# parameter-name -> (tp_dim, kind) where tp_dim counts from the *right*.
# kind 'kv' shards only when the dim divides tp; 'always' requires
# divisibility (padding guarantees it).
_TP_RULES: Dict[str, Tuple[int, str]] = {
    # attention
    "wq": (-2, "always"), "bq": (-2, "always"),
    "wk": (-2, "kv"), "bk": (-2, "kv"),
    "wv": (-2, "kv"), "bv": (-2, "kv"),
    "wo": (-3, "always"),           # (h, hd, d) / mlp wo handled below
    # mlp
    "wi_gate": (-1, "always"), "wi_up": (-1, "always"), "wi": (-1, "always"),
    "bi": (-1, "always"),
    # moe (expert dim) + shared experts
    "w_gate": (-3, "always"), "w_up": (-3, "always"), "w_down": (-3, "always"),
    "ws_gate": (-1, "always"), "ws_up": (-1, "always"), "ws_down": (-2, "always"),
    # mla
    "wq_a": (-1, "kv"), "wq_b": (-2, "always"), "wkv_b": (-2, "always"),
    # rglru
    "w_x": (-1, "always"), "w_y": (-1, "always"),
    "b_x": (-1, "always"), "b_y": (-1, "always"),
    "conv_w": (-1, "kv"), "conv_b": (-1, "kv"), "lam": (-1, "kv"),
    "w_input_gate": (-3, "always"), "b_input_gate": (-2, "always"),
    "w_a_gate": (-3, "always"), "b_a_gate": (-2, "always"),
    "w_out": (-2, "always"),
    # heads
    "embed": (-2, "always"), "lm_head": (-1, "always"),
}

_REPLICATED = {"router", "router_bias", "shared_gate", "scale", "bias",
               "q_norm", "k_norm", "kv_norm", "gate", "mlp_gate", "norm",
               "a_log", "dt_bias", "d_skip", "b_out", "proj",
               "in_proj", "out_proj"}

_EXPERT_PARAMS = ("w_gate", "w_up", "w_down")


def _tp_spec(leaf: str, shape: Tuple[int, ...], tp: int,
             cfg: ModelConfig) -> list:
    """The spec as a list with the TP axis assigned (or all None)."""
    spec: list = [None] * len(shape)
    if leaf in _REPLICATED or tp <= 1 or cfg.family == "ssm":
        return spec                       # mamba2: DP only
    rule = _TP_RULES.get(leaf)
    if leaf == "wo":
        # attention wo (h, hd, d) vs mlp wo (f, d)
        rule = (-2, "always") if len(shape) == 2 else (-3, "always")
    if rule is None:
        return spec
    dim = len(shape) + rule[0]
    if 0 <= dim < len(shape) and shape[dim] % tp == 0:
        spec[dim] = "model"
    return spec


def _dp_axes(axes: Dict[str, int], names: Sequence[str]):
    """-> (the DP axes present, their product, their spec entry)."""
    present = tuple(a for a in names if a in axes)
    dp = 1
    for a in present:
        dp *= axes[a]
    entry = present if len(present) > 1 else (present[0] if present
                                              else None)
    return present, dp, entry


def _leaf_name(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def make_param_specs(params_tree, cfg: ModelConfig, mesh: MeshLike,
                     fsdp: bool = True, serving: bool = False):
    """A tree of specs matching ``params_tree`` (tensors, ``meta`` or
    not).  ``serving=True`` is the inference layout: routed-expert
    weights shard their expert dim over ('data', 'model') and every other
    parameter is TP-sharded but not FSDP'd."""
    axes = mesh_axis_sizes(mesh)
    tp = axes.get("model", 1)
    # FSDP shards over every data-parallel axis (pod x data)
    fsdp_axes, dp, fsdp_spec = _dp_axes(axes, ("pod", "data"))
    if serving:
        fsdp = False

    def spec_one(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        spec = _tp_spec(name, shape, tp, cfg)
        if serving and name in _EXPERT_PARAMS and dp > 1:
            edim = len(shape) - 3
            if edim >= 0 and shape[edim] % (dp * tp) == 0:
                spec[edim] = fsdp_axes + ("model",)
        # GQA kv projections that cannot shard over 'model': FSDP them on
        # the head_dim (last) axis, never on the contraction axis
        if (name in ("wk", "wv", "bk", "bv") and tp > 1
                and all(s is None for s in spec)):
            if fsdp and dp > 1 and shape[-1] % dp == 0:
                spec[-1] = fsdp_spec
            return tuple(spec)
        if fsdp and dp > 1 and len(shape) >= 2:
            # largest remaining divisible dim -> 'data'
            cand = [(shape[i], i) for i in range(len(shape))
                    if spec[i] is None and shape[i] % dp == 0]
            if cand:
                spec[max(cand)[1]] = fsdp_spec
        return tuple(spec)

    named = flatten_with_names(params_tree)
    return unflatten(params_tree, [spec_one(p, l) for p, l in named])


def make_cache_specs(cache_tree, cfg: ModelConfig, mesh: MeshLike,
                     batch_axes: Tuple[str, ...] = ("pod", "data")):
    """Decode/prefill cache specs: batch dim -> DP axes when divisible,
    kv-head / width dims -> 'model' when divisible."""
    axes = mesh_axis_sizes(mesh)
    tp = axes.get("model", 1)
    _, dp, dp_spec = _dp_axes(axes, batch_axes)

    def spec_one(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        spec: list = [None] * len(shape)
        if name == "pos":
            return tuple(spec)
        if shape and shape[0] % dp == 0 and dp > 1:
            spec[0] = dp_spec
        if tp > 1 and cfg.family != "ssm":
            if name in ("k", "v", "xk", "xv") and len(shape) >= 4:
                if shape[2] % tp == 0:
                    spec[2] = "model"            # kv heads
            elif name == "h" and shape[-1] % tp == 0:
                spec[-1] = "model"               # rglru width
        return tuple(spec)

    named = flatten_with_names(cache_tree)
    return unflatten(cache_tree, [spec_one(p, l) for p, l in named])


def make_batch_specs(batch_tree, mesh: MeshLike,
                     batch_axes: Tuple[str, ...] = ("pod", "data")):
    """Batch inputs: dim 0 over the DP axes when divisible."""
    _, dp, dp_spec = _dp_axes(mesh_axis_sizes(mesh), batch_axes)

    def spec_one(leaf) -> Spec:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if shape and shape[0] % dp == 0 and dp > 1:
            spec[0] = dp_spec
        return tuple(spec)

    return tree_map(spec_one, batch_tree)


def spec_leaves(tree, specs) -> list:
    """The specs of ``tree``'s leaves, in leaf order (a spec tree cannot
    be flattened on its own: its specs are tuples)."""
    out: list = []
    tree_map(lambda _, spec: out.append(spec), tree, specs)
    return out


def default_axis_rules(mesh, sequence_parallel: bool = False,
                       serving: bool = False) -> AxisRules:
    """The activation rules of ``mesh`` (a ``DeviceMesh``), enabled."""
    axes = {a for dim in _dim_axes(mesh) for a in dim}
    batch = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    expert = model
    if serving and "data" in axes and model:
        # serving layout: dispatch follows the 1-expert-per-chip weights
        expert = ("data", "model")
    return AxisRules(batch=batch, heads=model, ff=model, vocab=model,
                     expert=expert,
                     seq=model if sequence_parallel else None,
                     enabled=True, mesh=mesh)


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

def _dim_axes(mesh) -> Tuple[Tuple[str, ...], ...]:
    """The logical axes of each mesh dim: a dim named ``"pod+data"`` is
    those two axes flattened into one, major first (the dry run's form of
    the two-pod mesh)."""
    names = (mesh.axis_names if isinstance(mesh, MeshShape)
             else mesh.mesh_dim_names)
    return tuple(tuple(n.split("+")) for n in names)


def placements(spec: Spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d names its axes, else ``Replicate()``.
    A dim split over several mesh axes must name them in mesh order (the
    reference's major-to-minor order, which is DTensor's)."""
    dims = _dim_axes(mesh)
    out = [Replicate() for _ in dims]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        pos = 0
        for i, axes in enumerate(dims):
            if pos < len(group) and group[pos:pos + len(axes)] == axes:
                if isinstance(out[i], Shard):
                    raise ValueError(f"spec {spec} uses mesh dim {axes} "
                                     f"twice")
                out[i] = Shard(d)
                pos += len(axes)
        if pos != len(group):
            raise ValueError(f"spec {spec}: dim {d}'s axes {group} are not "
                             f"mesh dims of {dims} in the mesh's order")
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh: MeshLike
                ) -> Tuple[int, ...]:
    """The shape one device holds of a tensor of ``shape`` under
    ``spec`` (the specs only shard divisible dims)."""
    sizes = (mesh.shape if isinstance(mesh, MeshShape)
             else tuple(mesh.shape))
    out = list(shape)
    for size, pl in zip(sizes, placements(spec, mesh)):
        if isinstance(pl, Shard):
            if out[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over {size}")
            out[pl.dim] //= size
    return tuple(out)


def distribute(tree, specs, mesh, *, src_data_rank: Optional[int] = None):
    """Place every tensor of ``tree`` on ``mesh`` as a ``DTensor`` by
    its spec.  ``src_data_rank=None`` takes each rank's own copy (every
    rank holds the same values, as after a seeded init); an int scatters
    the values of that rank (a batch only rank 0 read).  ``meta`` tensors
    become ``meta`` ``DTensor``s, with no communication."""
    def one(t, spec):
        pl = placements(spec, mesh)
        if t.device.type == "meta":
            return DTensor.from_local(
                torch.empty(local_shape(t.shape, spec, mesh),
                            dtype=t.dtype, device="meta"),
                mesh, pl, run_check=False, shape=t.shape,
                stride=torch.empty(t.shape, device="meta").stride())
        return distribute_tensor(t, mesh, pl, src_data_rank=src_data_rank)
    return tree_map(one, tree, specs)

