"""``repro_torch.sharding.pipeline`` against the JAX sequential scan: the
JAX test's sizes (R 8 layers of tanh(h @ w + b), B 8, S 4, D 16, M 4
microbatches) on 4 ``gloo`` ranks, one stage each.  Every stage leaves
with the whole output (within 1e-5 of ``jax.lax.scan`` over the layers),
and the gradients of sum(y ** 2), each stage contributing its own layers'
(zero elsewhere), add up to the sequential scan's within 1e-4.  The rank
function lives in ``tests/torch_train_ranks.py`` (no JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_train_ranks as ranks
from repro.sharding.pipeline import stage_scan as jstage_scan
from repro_torch.launch.mesh import run_ranks
from repro_torch.sharding.pipeline import stage_scan

R, B, S, D, M, P = 8, 8, 4, 16, 4, 4


def _apply_layer(lp, h):
    return jnp.tanh(h @ lp["w"] + lp["b"])


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((R, D, D)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((R, D)) * 0.1).astype(np.float32)}
    h0 = rng.standard_normal((B, S, D)).astype(np.float32)
    seq = jstage_scan(_apply_layer)  # the JAX stage body over every layer
    jp = jax.tree.map(jnp.asarray, params)
    y = seq(jp, jnp.asarray(h0))
    g = jax.grad(lambda p: jnp.sum(seq(p, jnp.asarray(h0)) ** 2))(jp)
    got = run_ranks(ranks.pipeline, P, (dict(params=params, h0=h0,
                                             microbatches=M),), timeout=60)
    return dict(y=np.asarray(y), g=jax.tree.map(np.asarray, g), got=got)


def test_every_stage_leaves_with_the_sequential_output(run):
    assert [r["stage"] for r in run["got"]] == list(range(P))
    for r in run["got"]:
        np.testing.assert_allclose(r["y"], run["y"], rtol=0, atol=1e-5)


def test_stage_gradients_add_up_to_the_sequential_scans(run):
    per = R // P
    for k, want in run["g"].items():
        total = sum(r["grads"][k] for r in run["got"])
        np.testing.assert_allclose(total, want, rtol=0, atol=1e-4,
                                   err_msg=k)
        for r in run["got"]:  # a stage differentiates only its own layers
            mine = slice(r["stage"] * per, (r["stage"] + 1) * per)
            rest = np.delete(r["grads"][k], np.arange(R)[mine], axis=0)
            assert not np.any(rest), k
            assert np.any(r["grads"][k][mine]), k


def test_stage_scan_runs_the_layers_in_order():
    import torch

    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 4, 4)).astype(np.float32)
    h = rng.standard_normal((2, 4)).astype(np.float32)
    f = stage_scan(lambda lp, x: x @ lp["w"] + 1)
    got = f({"w": torch.tensor(w)}, torch.tensor(h)).numpy()
    want = h
    for i in range(3):
        want = want @ w[i] + 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
