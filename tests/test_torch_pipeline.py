"""GPipe over a stage axis (``repro_torch.distributed.pipeline``) on 4
gloo ranks against sequential execution, the reference's case
(``tests/test_pipeline.py``): reps 8, d 16, a batch of 16 in 8
microbatches.  The forward within atol 1e-5 of the sequential stack's
and the gradients within 1e-4, each held both to the port's sequential
stack in the ranks and to JAX's sequential forward and ``jax.grad`` on
the same numpy arrays here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from repro_torch.distributed.pipeline import split_stages

REPS, D, BATCH, STAGES, MICRO = 8, 16, 16, 4, 8


def _inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((REPS, D, D)) * 0.2).astype(np.float32),
            "b": (rng.standard_normal((REPS, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((BATCH, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    (tmp / "dist_pipeline").mkdir()
    arrays = _inputs()
    np.savez(tmp / "dist_pipeline" / "inputs.npz", **arrays)
    got = torch_dist.spawn("pipeline", STAGES, tmp, n_microbatches=MICRO)
    return got, torch_dist.load_arrays(tmp, "pipeline"), arrays


def _jax_reference(arrays):
    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def seq(ps, x):
        for r in range(REPS):
            x = stage_fn(jax.tree.map(lambda a: a[r], ps), x)
        return x

    ps = {"w": jnp.asarray(arrays["w"]), "b": jnp.asarray(arrays["b"])}
    x = jnp.asarray(arrays["x"])
    grads = jax.grad(lambda p: jnp.sum(seq(p, x) ** 2))(ps)
    return np.asarray(seq(ps, x)), jax.tree.map(np.asarray, grads)


def test_pipeline_forward_matches_sequential(piped):
    got, arrays, inputs = piped
    assert got["fwd_err"] <= 1e-5
    want, _ = _jax_reference(inputs)
    np.testing.assert_allclose(arrays["out"], want, atol=1e-5)


def test_pipeline_gradients_match_sequential(piped):
    got, arrays, inputs = piped
    assert max(got["grad_err"].values()) <= 1e-4
    _, grads = _jax_reference(inputs)
    np.testing.assert_allclose(arrays["gw"], grads["w"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(arrays["gb"], grads["b"], atol=1e-4,
                               rtol=1e-4)


def test_split_stages():
    staged = split_stages({"w": torch.zeros(REPS, D, D)}, STAGES)
    assert staged["w"].shape == (STAGES, REPS // STAGES, D, D)
    with pytest.raises(ValueError):
        split_stages({"w": torch.zeros(6, D)}, STAGES)
