"""The port's MoE path against the JAX package's, on the CPU.

* ``plain.gmm_ref`` (what a CPU tensor runs, and what the Hopper ``gmm``
  kernel is held to on the card) against ``ref.gmm_ref`` and the Pallas
  ``moe_gmm.gmm`` in interpret mode: float32 within 2e-5, bfloat16 within
  2e-2 (``tests/test_kernels.py``'s tolerances), ragged C, D and F
  included.
* ``models/moe.py``'s ``MoE`` against ``apply_moe``: output and aux loss
  within 1e-4 (float32; the frameworks sum in different orders) with
  lossless capacity, a capacity that drops tokens, two dispatch groups,
  a shared expert, and a router whose logits tie.
* granite-moe-smoke end to end: the port's ``Transformer`` against the JAX
  forward (logits and ``moe_loss``, prefill continuation and per-slot
  decode), ``memcom.compress``'s O^i, all within 1e-4, and the
  compressor's parameters carried across and back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.kernels import moe_gmm as jgmm
from repro.kernels import ref
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.config import MoEConfig
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import moe_gmm, ops, plain
from repro_torch.models import moe

ARCH = "granite-moe-3b-a800m"
TOL = 1e-4
GMM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# gmm
# ---------------------------------------------------------------------------

GMM_CASES = [
    # (E, C, D, F)
    (3, 16, 32, 48),
    (5, 8, 96, 64),     # the smoke decode capacity, granite-smoke widths
    (4, 13, 40, 24),    # ragged C
    (2, 37, 19, 7),     # ragged C, D and F, none a multiple of 8
    (1, 1, 5, 3),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES)
def test_plain_gmm_matches_ref_and_pallas(rng, case, dtype):
    E, C, D, F = case
    x = (rng.standard_normal((E, C, D)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * 0.5).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = ref.gmm_ref(jnp.asarray(x, jd), jnp.asarray(w, jd))
    pallas = jgmm.gmm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                      block_c=8, block_d=16, block_f=16, interpret=True)
    td = getattr(torch, dtype)
    got = plain.gmm_ref(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td and tuple(got.shape) == (E, C, F)
    _close(got.float(), want, GMM_TOL[dtype])
    _close(got.float(), pallas, GMM_TOL[dtype])
    # the wrapper and the dispatcher take the plain version on the CPU
    before = moe_gmm.launches
    assert torch.equal(moe_gmm.gmm(torch.from_numpy(x).to(td),
                                   torch.from_numpy(w).to(td)), got)
    assert torch.equal(ops.gmm(torch.from_numpy(x).to(td),
                               torch.from_numpy(w).to(td)), got)
    assert moe_gmm.launches == before


def test_gmm_cuda_impl_is_refused_on_cpu_tensors():
    x = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):
        ops.gmm(x, torch.zeros((2, 4, 3)), impl="cuda")


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def _moe_cfgs(**moe_kw):
    """The JAX and port granite-moe-smoke configs with the MoE settings
    replaced the same way."""
    from repro.config import MoEConfig as JMoEConfig
    base = dict(num_experts=5, top_k=2, expert_d_ff=64)
    base.update(moe_kw)
    cfg = get_smoke_config(ARCH)
    pcfg = port_smoke_config(ARCH)
    return (cfg.replace(moe=JMoEConfig(**base)),
            pcfg.replace(moe=MoEConfig(**base)))


def _moe_params(rng, cfg, tie=False):
    d, m = cfg.d_model, cfg.moe
    E, F = m.num_experts, m.expert_d_ff
    p = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "wg": rng.standard_normal((E, d, F)) * d ** -0.5,
         "wi": rng.standard_normal((E, d, F)) * d ** -0.5,
         "wo": rng.standard_normal((E, F, d)) * F ** -0.5}
    if tie:  # experts 1 and 3 get the same router column: their logits tie
        p["router"][:, 3] = p["router"][:, 1]
    if m.num_shared_experts:
        fs = m.num_shared_experts * m.shared_ff()
        p["shared"] = {"mlp": {"wg": rng.standard_normal((d, fs)) * d ** -0.5,
                               "wi": rng.standard_normal((d, fs)) * d ** -0.5,
                               "wo": rng.standard_normal((fs, d)) * fs ** -0.5}}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _port_moe(pcfg, p):
    layer = moe.MoE(pcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in layer.named_parameters():
            node = p
            for key in name.split("."):
                node = node[key]
            t.copy_(torch.from_numpy(node))
    return layer


def _dispatch_keep(layer, x):
    """How many of the (token, choice) assignments the port keeps."""
    kept = []
    orig = moe._dispatch

    def spy(*a):
        out = orig(*a)
        kept.append(out[1][0])
        return out

    moe._dispatch = spy
    try:
        with torch.no_grad():
            layer(x)
    finally:
        moe._dispatch = orig
    return int(kept[0].sum()), kept[0].numel()


MOE_CASES = {
    # name: (MoEConfig overrides, tied router logits)
    "lossless": (dict(capacity_factor=5.0), False),   # C >= N*k / 2
    "drops": (dict(capacity_factor=0.5), False),
    "groups2": (dict(dispatch_groups=2, capacity_factor=0.75), False),
    "shared": (dict(num_shared_experts=1, shared_d_ff=32), False),
    "tied_logits": (dict(), True),
}


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_layer_matches_apply_moe(rng, name):
    overrides, tie = MOE_CASES[name]
    cfg, pcfg = _moe_cfgs(**overrides)
    p = _moe_params(rng, cfg, tie=tie)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y, aux = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x))
    layer = _port_moe(pcfg, p)
    with torch.no_grad():
        got, got_aux = layer(torch.from_numpy(x))
    _close(got, y)
    _close(float(got_aux), float(aux))
    kept, total = _dispatch_keep(layer, torch.from_numpy(x))
    if name == "lossless":
        assert kept == total
    if name in ("drops", "groups2"):
        assert kept < total  # the capacity binds
    if tie:
        probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model)
                              @ layer.router, -1)
        assert torch.equal(probs[:, 1], probs[:, 3])
        _, ids = moe._top_k(probs, cfg.moe.top_k)
        both = (ids == 1).any(-1) & (ids == 3).any(-1)
        assert bool(both.any())  # the tie is inside the top k somewhere
        pos = lambda e: (ids == e).float().argmax(-1)  # noqa: E731
        assert bool((pos(1)[both] < pos(3)[both]).all())  # lower id first


def test_capacity_is_the_reference_arithmetic():
    cfg, pcfg = _moe_cfgs()
    big = port_smoke_config(ARCH).replace(
        moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512))
    from repro.configs import get_config
    jbig = get_config(ARCH).moe
    for n in (1, 4, 12, 16, 17, 33, 64, 512, 3072):
        assert moe._capacity(pcfg.moe, n) == jmoe._capacity(cfg.moe, n)
        assert moe._capacity(big.moe, n) == jmoe._capacity(jbig, n)
    # granite's capacities on the main path: source, memory, prompt/decode
    assert [moe._capacity(big.moe, n) for n in (3072, 512, 16, 4)] == \
        [768, 128, 8, 8]


# ---------------------------------------------------------------------------
# granite-moe-smoke end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(ARCH)
    model = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    compressor = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                        device="cpu")
    return dict(cfg=cfg, pcfg=pcfg, params=params, mc=mc, model=model,
                compressor=compressor)


def test_granite_forward_logits_and_moe_loss_match(granite, rng):
    cfg, model = granite["cfg"], granite["model"]
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, jaux = jtfm.forward(granite["params"], cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = model(tokens=torch.as_tensor(toks, dtype=torch.long))
    _close(got, want)
    assert float(aux["moe_loss"]) > 0
    _close(float(aux["moe_loss"]), float(jaux["moe_loss"]))


def test_granite_prefill_continuation_and_per_slot_decode_match(granite, rng):
    """A 6-token prefill into a 24-row cache, then continued by 5 tokens
    behind it, then one decode step per slot at lengths 11 and 9."""
    cfg, pcfg, model, params = (granite[k] for k in
                                ("cfg", "pcfg", "model", "params"))
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    from repro_torch.models import transformer as tfm
    jc = jtfm.init_cache(cfg, 2, 24)
    pc = tfm.init_cache(pcfg, 2, 24, device="cpu")
    _, ja = jtfm.forward(params, cfg, tokens=jnp.asarray(toks[:, :6]),
                         cache=jc, cache_index=0)
    want, ja = jtfm.forward(params, cfg, tokens=jnp.asarray(toks[:, 6:]),
                            cache=ja["cache"], cache_index=6, mask_offset=6)
    with torch.no_grad():
        model(tokens=torch.as_tensor(toks[:, :6], dtype=torch.long), cache=pc,
              cache_index=0)
        got, _ = model(tokens=torch.as_tensor(toks[:, 6:], dtype=torch.long),
                       cache=pc, cache_index=6, mask_offset=6)
    _close(got, want)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    lengths = np.array([11, 9], np.int32)
    want, jd = jtfm.forward(params, cfg, tokens=jnp.asarray(step),
                            cache=ja["cache"], cache_index=jnp.asarray(lengths),
                            decode=True)
    with torch.no_grad():
        got, aux = model(tokens=torch.as_tensor(step, dtype=torch.long),
                         cache=pc, cache_index=torch.as_tensor(lengths),
                         decode=True)
    _close(got, want)
    _close(float(aux["moe_loss"]), float(jd["moe_loss"]))


def test_granite_compress_matches_every_layer(granite, rng):
    cfg, pcfg = granite["cfg"], granite["pcfg"]
    src = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    jprefix, _ = jmc.compress(granite["mc"], cfg, jnp.asarray(src))
    prefix, _ = memcom.compress(granite["compressor"], pcfg,
                                torch.as_tensor(src, dtype=torch.long))
    want = bridge.layerwise_to_list(cfg, jprefix)
    assert len(prefix) == len(want) == cfg.num_layers
    for got, w in zip(prefix, want):
        _close(got["h"], w["h"])


def test_granite_memcom_round_trips_bit_for_bit(granite):
    tree = jax.tree.map(np.asarray, granite["mc"])
    back = bridge.to_numpy(granite["compressor"])
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    names = [n for n, _ in granite["compressor"].named_parameters()]
    assert any(n.endswith(".moe.wo") for n in names)
