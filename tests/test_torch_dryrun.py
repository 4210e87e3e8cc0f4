"""The port's roofline (``repro_torch.launch.analysis``) and dry run
(``repro_torch.launch.dryrun``) against the reference, on the CPU.

* ``model_flops_estimate`` from each package's own parameter counts is
  equal for every arch x shape, and given the same FLOPs, bytes and
  collective bytes, with the reference's TPU constants passed in as a
  ``Hardware``, every ``RooflineReport`` property equals the
  reference's.
* On 2 gloo ranks (``tests/torch_dist.py``): the collective bytes
  counted for a column-sharded matmul gathered whole are the
  all-gather's operand, 8 x 16 f32 = 512 B; the FLOPs counted per device
  of a data-parallel step are the one-device count / 2 exactly.
* The reference's mini dry run (``tests/test_distributed.py``: reduced
  qwen2.5 on 2 x 4, a train and a decode step) on an 8-rank fake process
  group reports FLOPs and argument bytes; qwen2.5-32b x train_4k on
  16 x 16 holds, per device, the parameter bytes that the reference's
  own specs give.  ``sweep`` holds every arch x shape cell OK or SKIP as
  ``shape_applicable`` says (``test_torch_dryrun_16x16.py`` and
  ``test_torch_dryrun_multipod.py`` run it on the two production
  meshes), each model cut to its prefix and one period of its pattern
  (the FLOPs of more layers add nothing to the check).
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import apply_tp_padding as japply
from repro.distributed import sharding as jsh
from repro.launch import analysis as jan
from repro.models import model as jmdl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analysis as an
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import model as mdl
from repro_torch.models.transformer import stack_plan

REF_HW = an.Hardware("the reference's TPU constants",
                     {"bfloat16": jan.PEAK_FLOPS}, jan.HBM_BW, jan.ICI_BW)


def cut_depth(arch: str) -> int:
    """The prefix and one period of the arch's pattern."""
    prefix, _, pattern, _ = stack_plan(get_config(arch))
    return prefix + len(pattern)


def sweep(arch: str, multi_pod: bool):
    """Every shape of ``arch`` on a production mesh: OK or SKIP as
    ``shape_applicable`` says, and an OK row's counts."""
    for name, shape in SHAPES.items():
        row = dryrun.run_cell(arch, name, multi_pod=multi_pod,
                              n_layers_override=cut_depth(arch),
                              verbose=False)
        ok, _ = dryrun.shape_applicable(arch, shape, get_config(arch))
        assert row["status"] == ("OK" if ok else "SKIP"), row
        if ok:
            assert row["flops_per_device"] > 0 and row["argument_bytes"] > 0
            assert row["bytes_per_device"] > 0
            assert row["scan_corrected"] is False
            assert row["temp_bytes"] is None
            assert row["chips"] == (512 if multi_pod else 256)


def test_arch_and_shape_lists_are_the_references():
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)
    assert sorted(SHAPES) == sorted(JSHAPES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_the_references(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    n_j = jmdl.count_params_analytic(jcfg, active_only=True)
    n_t = mdl.count_params_analytic(cfg, active_only=True)
    assert n_t == n_j
    embed = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    for name, shape in SHAPES.items():
        want = jan.model_flops_estimate(jcfg, shape.kind, shape.seq_len,
                                        shape.global_batch, n_j, embed)
        got = an.model_flops_estimate(cfg, shape.kind, shape.seq_len,
                                      shape.global_batch, n_t, embed)
        assert got == want, name


@pytest.mark.parametrize("case", [
    dict(flops=3.2e15, bytes_=9.1e13, coll=4.4e11, model=7.7e17, chips=256,
         args=2**34, out=2**33, temp=2**35),
    dict(flops=1.0e12, bytes_=5.0e12, coll=0.0, model=2.0e14, chips=512,
         args=10, out=0, temp=0),
    dict(flops=4.0e13, bytes_=1.0e11, coll=8.0e12, model=0.0, chips=1,
         args=0, out=0, temp=0),
])
def test_roofline_report_equals_the_references(case):
    kw = dict(arch="a", shape="s", mesh="m", chips=case["chips"],
              flops_per_device=case["flops"],
              bytes_per_device=case["bytes_"],
              coll_bytes_per_device=case["coll"],
              coll_breakdown={"all-gather": int(case["coll"])},
              model_flops=case["model"], argument_bytes=case["args"],
              output_bytes=case["out"], temp_bytes=case["temp"])
    want = jan.RooflineReport(**kw).row()
    got = an.RooflineReport(**kw, hardware=REF_HW,
                            compute_dtype="bfloat16").row()
    assert got.pop("hardware") == REF_HW.name
    assert got.pop("compute_dtype") == "bfloat16"
    assert got == want


def test_h100_rates_follow_the_compute_dtype():
    rep = an.RooflineReport(arch="a", shape="s", mesh="m", chips=1,
                            flops_per_device=67e12, bytes_per_device=3.35e12,
                            coll_bytes_per_device=450e9)
    assert rep.hardware is an.H100_SXM and rep.compute_dtype == "float32"
    assert rep.t_compute == pytest.approx(1.0)
    assert rep.t_memory == pytest.approx(1.0)
    assert rep.t_collective == pytest.approx(1.0)
    rep.compute_dtype = "bfloat16"
    assert rep.t_compute == pytest.approx(67e12 / 989.4e12)
    with pytest.raises(ValueError):
        rep.compute_dtype = "float8"
        rep.t_compute


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    return torch_dist.spawn("roofline", 2, tmp_path_factory.mktemp("roof"),
                            arch="internlm2-20b")


def test_collective_bytes_of_a_sharded_matmul(counted):
    coll = counted["matmul_collectives"]
    assert coll["all-gather"] == counted["matmul_all_gather_operand"] == 512
    assert sum(coll.values()) == 512


def test_step_flops_count_local_shards(counted):
    """FlopCounterMode would count a DTensor op at its global shape; the
    counter counts each device's local work: a data-parallel step's FLOPs
    are half the one-device count on 2 ranks, and a tensor-parallel
    step's at most the one-device count (its replicated parts run on
    both ranks)."""
    dp = counted["step_flops"]["data"]
    assert dp["one_device"] > 0
    assert 2 * dp["per_device"] == dp["one_device"]
    assert dp["collective_bytes"] > 0           # the gradient reductions
    tp = counted["step_flops"]["model"]
    assert tp["one_device"] / 2 <= tp["per_device"] < tp["one_device"]


def test_counter_sees_no_dtensor_global_shape():
    """On one device the counter agrees with FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode
    a, b = torch.randn(8, 32), torch.randn(32, 16, requires_grad=True)
    with FlopCounterMode(display=False) as ref, an.StepCounter() as c:
        (a @ b).sum().backward()
    # the forward and the gradient of b (a needs none)
    assert c.flops == ref.get_total_flops() == 2 * 2 * 8 * 32 * 16


def test_mini_dryrun_train_and_decode():
    """The reference's mini dry run: a reduced qwen2.5 on a 2 x 4 mesh
    over an 8-rank fake process group, a train and a decode step."""
    cfg = get_smoke_config("qwen2.5-32b").scaled(
        n_heads=8, n_kv_heads=2, d_ff=128, vocab_size=256)
    logical = MeshShape((2, 4), ("data", "model"))
    with dryrun.fake_world(logical) as mesh:
        for shape in (ShapeConfig("mini_train", 32, 8, "train"),
                      ShapeConfig("mini_decode", 64, 8, "decode")):
            rep = dryrun.count_cell("qwen2.5-32b", shape, mesh=mesh,
                                    mesh_name="2x4", cfg=cfg)
            assert rep.flops_per_device > 0, shape
            assert rep.argument_bytes > 0 and rep.chips == 8
            assert rep.temp_bytes is None


def _ref_local_bytes(tree, specs, sizes) -> int:
    """Per-device bytes of a reference tree under the reference's specs."""
    total = 0
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(leaves, spec_leaves):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for ax in spec:
            for a in (() if ax is None else
                      (ax if isinstance(ax, tuple) else (ax,))):
                n //= sizes[a]
        total += n
    return total


def test_qwen32b_train_4k_param_bytes_are_the_specs_shards():
    """qwen2.5-32b x train_4k on 16 x 16, full depth: the bytes each
    device holds of the parameters and of AdamW's moments equal what the
    reference's specs give its own (bf16 parameters, f32 moments)."""
    logical = make_production_mesh()
    sizes = dict(zip(logical.axis_names, logical.shape))

    class RefMesh:
        axis_names = logical.axis_names
        devices = np.empty(logical.shape, np.int8)
    jcfg = japply(jget_config("qwen2.5-32b"), 16)
    jtree = jax.eval_shape(lambda: jmdl.init_params(
        jax.random.key(0), jcfg, dtype=jax.numpy.bfloat16))
    jspecs = jsh.make_param_specs(jtree, jcfg, RefMesh(), fsdp=True)
    want = _ref_local_bytes(jtree, jspecs, sizes)
    with dryrun.fake_world(logical) as mesh:
        _, (params, opt, batch), cfg, _, _ = dryrun.build_cell(
            "qwen2.5-32b", "train_4k", mesh=mesh)
        got = an.local_bytes(params)
        moments = an.local_bytes((opt.m, opt.v))
        batch_bytes = an.local_bytes(batch)
    assert cfg.n_layers == 64
    assert got == want
    assert moments == 4 * want               # two f32 moments of bf16
    assert batch_bytes == 2 * 4 * 4096 * 256 // 16


def test_dryrun_cli_summarises(capsys):
    rows = dryrun.main(["--arch", "mamba2-130m", "--both-meshes",
                        "--layers", "1"])
    assert [r["status"] for r in rows].count("OK") == 8
    assert "dry-run summary: 8 OK, 0 SKIP, 0 FAIL" in capsys.readouterr().out
