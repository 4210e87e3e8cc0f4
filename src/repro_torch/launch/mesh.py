"""Meshes (the port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group the caller has initialised (gloo on the CPU, NCCL on the
card): ``make_host_mesh`` names its dims ``("data", "model")``.
Importing this module starts no process group and touches no device, the
reference's rule: ``make_production_mesh`` only describes the pod meshes
(16 x 16, and 2 x 16 x 16 for two pods) as a ``MeshShape``, and the dry
run (``launch.dryrun``) builds a ``DeviceMesh`` of that shape over a fake
process group.

``mesh_axis_sizes`` and ``n_chips`` take either kind.  The reference's
``mesh_context`` has no counterpart: a ``DTensor`` carries its mesh, and
the activation rules (``models.common.axis_rules``) carry theirs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class MeshShape(NamedTuple):
    """A mesh's dims and their names, with no devices behind it."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


MeshLike = Union[DeviceMesh, MeshShape]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 chips per pod; 2 pods for the multi-pod dry run."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = None) -> DeviceMesh:
    """A ``data x model`` mesh over the initialised process group, whose
    world size must be ``data * model``; ``device_type`` defaults to
    ``cuda`` where a card is usable, else ``cpu``."""
    if not torch.distributed.is_initialized():
        raise RuntimeError(
            f"a {data} x {model} mesh needs an initialised process group "
            f"(torch.distributed.init_process_group, or torchrun)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def n_chips(mesh: MeshLike) -> int:
    n = 1
    for s in mesh_axis_sizes(mesh).values():
        n *= s
    return n
