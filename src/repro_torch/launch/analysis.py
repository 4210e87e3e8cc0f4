"""Roofline analysis of a step (the port of ``repro.launch.analysis``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_device / peak FLOP/s of the step's dtype
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_bytes_per_device / link bandwidth

The reference reads XLA's ``cost_analysis`` of a compiled program and
parses collectives out of its HLO text.  PyTorch compiles nothing, so
the port counts a step as it runs, in one ``TorchDispatchMode``
(``StepCounter``):

  * FLOPs by the formulas of ``torch.utils.flop_counter`` (the
    registry ``FlopCounterMode`` uses), per aten op;
  * bytes as every aten op's tensor operands and outputs, each charged
    once per op (views excepted): the analogue of XLA's unfused "bytes
    accessed" of the reference's CPU-lowered programs, an upper bound on
    what a fused step moves;
  * collective bytes as the operand bytes of every c10d collective
    (functional or not), by kind.

Two things ``FlopCounterMode`` gets wrong here, and what the counter
does instead (ROADMAP C24, C25):

  * it counts a ``DTensor`` op at its global shape, so a step on a
    16 x 16 mesh counts 256 times the work of one device.  The counter
    declines ``DTensor`` ops (``NotImplemented``), so ``DTensor``'s own
    dispatch runs and the counter sees the local ops each rank launches
    and the collectives between them: per-device counts.  Ops that
    ``DTensor``'s sharding propagation runs on ``FakeTensor``s to learn
    shapes are not counted.
  * the hand-written kernels (B5, B6, B7) launch through ctypes and are
    no aten op, so on the card they would count 0.  Count a step on the
    ``meta`` device instead: there the kernel wrappers take their plain
    versions (a ``meta`` tensor is no CUDA tensor), whose aten ops are
    counted.  So a count is the plain versions' work, not the kernels'.

Peak rates are a ``Hardware`` record; ``H100_SXM`` (NVIDIA's data sheet,
dense) is the default.  The port's GEMMs run in f32 without TF32, so an
f32 step's compute term uses the f32 rate, 67 TFLOP/s.  The reference's
TPU constants are the reference's; a test passes them in as a
``Hardware`` to hold the formulas to the reference's.

Argument and output bytes are the local shards' bytes of a step's
inputs and outputs.  Temporaries would need the card's allocator: a
count made without a card leaves ``temp_bytes`` unknown (None), and the
lower memory bound then covers arguments and outputs only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


@dataclass(frozen=True)
class Hardware:
    """Per-chip peak rates: FLOP/s by compute dtype, HBM and link B/s."""
    name: str
    peak_flops: Dict[str, float]
    hbm_bw: float
    link_bw: float

    def peak(self, dtype: str) -> float:
        if dtype not in self.peak_flops:
            raise ValueError(f"{self.name} has no peak rate for {dtype!r} "
                             f"(it has {sorted(self.peak_flops)})")
        return self.peak_flops[dtype]


# NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet);
# NVLink 4: 900 GB/s both ways, 450 GB/s each way
H100_SXM = Hardware(
    name="NVIDIA H100 SXM",
    peak_flops={"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989.4e12},
    hbm_bw=3.35e12, link_bw=450e9)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op name (functional and in-place forms) -> the reference's kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}

# ops that move no bytes of their own
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "_local_scalar_dense", "wait_tensor",
         "_wrap_tensor_autograd", "set_", "resize_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(*trees):
    """The tensors of an op's arguments or outputs (nested lists and
    tuples, kwargs dicts), without the cost of a general pytree walk:
    the counter runs on every op of a step."""
    out, todo = [], list(trees)
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _is_fake(xs) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(x, FakeTensor) for x in xs)


class StepCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes and collective bytes of what runs under it
    (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor dispatches; its local ops
        out = func(*args, **kwargs)   # come back here
        ins, outs = _tensors(args, kwargs), _tensors(out)
        if _is_fake(ins) or _is_fake(outs):
            return out                # DTensor's shape propagation
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "c10d"):
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                # the operand: the first argument's tensor(s)
                self.collectives[kind] += sum(
                    _nbytes(t) for t in _tensors(args[:1]))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and name not in _FREE:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    @property
    def collective_bytes(self) -> int:
        return sum(self.collectives.values())


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Per-collective-kind byte totals of one call of ``fn`` on this
    device."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return dict(c.collectives)


def local_bytes(tree) -> int:
    """Bytes this device holds of a tree of tensors (a ``DTensor``'s
    local shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += _nbytes(t)
    return total


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0          # 6*N*D useful flops (global)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: Optional[int] = None  # unknown without the card
    hardware: Hardware = H100_SXM
    compute_dtype: str = "float32"

    @property
    def peak_flops(self) -> float:
        return self.hardware.peak(self.compute_dtype)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        """Upper bound: every operand of every (unfused) op is charged
        once per consumer."""
        return self.bytes_per_device / self.hardware.hbm_bw

    @property
    def t_memory_lower(self) -> float:
        """Lower bound: every resident byte of the step (arguments +
        outputs + temporaries where known) is read or written once."""
        return (self.argument_bytes + self.output_bytes +
                (self.temp_bytes or 0)) / self.hardware.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / self.hardware.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Pessimistic: useful compute time over the dominant term with
        the unfused upper-bound memory term."""
        t_useful = (self.model_flops / self.chips) / self.peak_flops
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / bound if bound else 0.0

    @property
    def roofline_fraction_fused(self) -> float:
        """Fused estimate: the memory term replaced by its lower bound."""
        t_useful = (self.model_flops / self.chips) / self.peak_flops
        bound = max(self.t_compute, self.t_memory_lower, self.t_collective)
        return t_useful / bound if bound else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "t_memory_lower_s": self.t_memory_lower,
            "roofline_fraction_fused": self.roofline_fraction_fused,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "hardware": self.hardware.name,
            "compute_dtype": self.compute_dtype,
        }


def model_flops_estimate(cfg, shape_kind: str, seq: int, batch: int,
                         n_params_active: int, n_params_embed: int) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N per token (decode)."""
    n = n_params_active - n_params_embed
    tokens = seq * batch
    if shape_kind == "train":
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * batch            # decode: one token per sequence


def analyze(fn: Callable, args, *, arch: str, shape: str, mesh_name: str,
            chips: int, model_flops: float,
            hardware: Hardware = H100_SXM,
            compute_dtype: str = "float32") -> RooflineReport:
    """Run ``fn(*args)`` once under a ``StepCounter`` -> its report (on
    ``meta`` tensors for the plain versions' count; see above)."""
    arg_bytes = local_bytes(args)
    with StepCounter() as c:
        out: Any = fn(*args)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(c.flops), bytes_per_device=float(c.bytes),
        coll_bytes_per_device=float(c.collective_bytes),
        coll_breakdown=dict(c.collectives), model_flops=model_flops,
        argument_bytes=arg_bytes, output_bytes=local_bytes(out),
        hardware=hardware, compute_dtype=compute_dtype)
