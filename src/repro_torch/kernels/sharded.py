"""The model kernels on ``DTensor`` inputs: one launch per rank on its
local shard (``torch.distributed.tensor.experimental.local_map``).

B5's heads, B6's heads and B7's width are independent, and so is every
batch row, so a kernel launched on a rank's rows and heads computes
exactly its part of the whole.  Each wrapper names, per argument, the
logical axis of each dim that may stay sharded (``"b"`` batch, ``"h"``
heads or width; None: the dim must be whole).  The first ``DTensor``
argument decides which mesh dim shards which logical axis; every other
argument is redistributed to match (a kv head dim that the mesh splits
must divide evenly, which ``apply_tp_padding`` guarantees), any other
sharding or a ``Partial`` sum is made whole first, and the outputs come
back sharded the same way.  An input that is whole on a mesh dim that
splits the work gets its gradient as a ``Partial`` sum of the ranks'.  The ctypes launchers themselves take local
tensors only: ``require_local`` raises on a ``DTensor``, whose
``data_ptr`` is no address of its values.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Labels = Tuple[Optional[str], ...]


def is_distributed(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def require_local(*tensors):
    """Raise where a ``DTensor`` reached a ctypes launcher."""
    if is_distributed(*tensors):
        raise TypeError("a DTensor reached a kernel launcher: launch on its "
                        "local shard (kernels.sharded.run_local)")


def _mesh_axes(t: DTensor, labels: Labels) -> Tuple[Optional[str], ...]:
    """Per mesh dim, the logical axis it shards in ``t`` (or None)."""
    out = []
    for pl in t.placements:
        out.append(labels[pl.dim] if isinstance(pl, Shard) else None)
    return tuple(out)


def _placements(axes, labels: Labels, shape, mesh) -> list:
    out = []
    for i, ax in enumerate(axes):
        if ax is None or ax not in labels:
            out.append(Replicate())
            continue
        d = labels.index(ax)
        out.append(Shard(d))
        if shape is not None and shape[d] % mesh.size(i):
            raise ValueError(f"dim {d} of size {shape[d]} does not divide "
                             f"over mesh dim {i} ({mesh.size(i)})")
    return out


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    local gradient leaves ``local_map`` as a ``DTensor`` whose global
    strides are computed from the local ones, and a strided local
    gradient (the plain attention's k is read transposed) would give
    strides that a later ``view`` in the backward cannot take."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local(fn: Callable, kw):
    def call(*args):
        return fn(*(a if a is None or not a.requires_grad
                    else _ContiguousGrad.apply(a) for a in args), **kw)
    return call


def run_local(fn: Callable, args: Sequence, in_labels: Sequence[Labels],
              out_labels: Sequence[Labels], **kw):
    """``fn(*args, **kw)`` on each rank's local shards of the ``DTensor``
    ``args`` (None entries pass through) -> the outputs as ``DTensor``s
    (a tuple when ``out_labels`` has more than one entry)."""
    from torch.distributed.tensor.experimental import local_map
    i = next(i for i, a in enumerate(args) if isinstance(a, DTensor))
    mesh = args[i].device_mesh
    axes = _mesh_axes(args[i], in_labels[i])
    in_pl = tuple(None if a is None else
                  _placements(axes, lab, tuple(a.shape), mesh)
                  for a, lab in zip(args, in_labels))
    args = [a if a is None or isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False) for a in args]
    out_pl = [_placements(axes, lab, None, mesh) for lab in out_labels]
    # an input whole on a mesh dim that splits the work (a_log over the
    # batch rows) gets a partial gradient from each rank: a sum
    grad_pl = tuple(None if pl is None else
                    [Partial() if ax is not None and isinstance(p, Replicate)
                     else p for ax, p in zip(axes, pl)] for pl in in_pl)
    wrapped = local_map(
        _local(fn, kw),
        out_placements=out_pl[0] if len(out_pl) == 1 else tuple(out_pl),
        in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh,
        redistribute_inputs=True)
    return wrapped(*args)
