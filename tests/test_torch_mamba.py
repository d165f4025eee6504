"""The port's Mamba2 path against the JAX package's, on the CPU.

* ``plain.ssd_ref`` (what a CPU tensor runs, and what the Hopper ``ssd``
  kernel is held to on the card) against the sequential oracle
  ``ref.ssd_ref`` and the Pallas ``ssd_scan.ssd`` in interpret mode at
  ``tests/test_kernels.py``'s cases, with and without an initial state,
  within 5e-5 (float32; the chunked and sequential forms sum in other
  orders).  A case whose dt·|A| sums past 100 within a chunk must stay
  finite: the upper triangle of the decay is never exponentiated.
* ``ssd_decode_step`` token by token against the chunked scan, 5e-5.
* ``models/mamba2.py``'s ``Mamba`` against ``apply_mamba`` (prefill,
  chained prefill, decode, and the cache it leaves), and the
  mamba2-370m-smoke forward, all within 1e-4; the parameters carried
  across and back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels import jnp_impl, ref, ssd_scan as jssd
from repro.models import mamba2 as jmamba
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.kernels import ops, plain, ssd_scan
from repro_torch.models import transformer as tfm
from repro_torch.models.mamba2 import Mamba, init_mamba_cache
from repro_torch.models.param import initialize

ARCH = "mamba2-370m"
SSD_TOL = 5e-5
TOL = 1e-4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _ssd_inputs(rng, B, S, H, P, G, N, *, init=False, dt_scale=0.2):
    """tests/test_kernels.py's SSD inputs, as numpy."""
    f = np.float32
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(f)
    dt = (np.abs(rng.standard_normal((B, S, H)) * 0.5) * dt_scale).astype(f)
    A = -np.abs(rng.standard_normal(H)).astype(f)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(f)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(f)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(f) if init else None
    return x, dt, A, Bm, Cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


SSD_CASES = [
    # (B, S, H, P, G, N, chunk) — tests/test_kernels.py:246-252
    (1, 32, 2, 8, 1, 8, 8),
    (2, 70, 4, 16, 2, 8, 16),
    (1, 64, 4, 32, 4, 16, 32),
    (2, 33, 2, 8, 1, 4, 16),  # ragged
]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("with_init", [False, True])
def test_plain_ssd_matches_ref_and_pallas(rng, case, with_init):
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, B, S, H, P, G, N, init=with_init)
    j = [jnp.asarray(a) if a is not None else None
         for a in (x, dt, A, Bm, Cm, h0)]
    y_ref, hf_ref = ref.ssd_ref(*j[:5], init_state=j[5])
    y_pal, hf_pal = jssd.ssd(*j[:5], init_state=j[5], chunk=chunk,
                             interpret=True)
    y, hf = plain.ssd_ref(*map(_t, (x, dt, A, Bm, Cm)), init_state=_t(h0),
                          chunk=chunk)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(hf.shape) == (B, H, P, N)
    for got, want in ((y, y_ref), (y, y_pal), (hf, hf_ref), (hf, hf_pal)):
        _close(got, want, SSD_TOL)
    # the result does not depend on the chunk length
    y2, hf2 = plain.ssd_ref(*map(_t, (x, dt, A, Bm, Cm)), init_state=_t(h0),
                            chunk=256)
    _close(y2, y_ref, SSD_TOL)
    _close(hf2, hf_ref, SSD_TOL)
    # the wrapper and the dispatcher take the plain version on the CPU
    before = ssd_scan.launches
    for fn in (ssd_scan.ssd, ops.ssd):
        got_y, got_hf = fn(*map(_t, (x, dt, A, Bm, Cm)), init_state=_t(h0),
                           chunk=chunk)
        assert torch.equal(got_y, y) and torch.equal(got_hf, hf)
    assert ssd_scan.launches == before


def test_plain_ssd_keeps_bf16_inputs_type(rng):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, 1, 40, 4, 16, 2, 8, init=True)
    bf = [_t(a).bfloat16() for a in (x, Bm, Cm)]
    y, hf = plain.ssd_ref(bf[0], _t(dt), _t(A), bf[1], bf[2],
                          init_state=_t(h0), chunk=16)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    xj, bj, cj = (jnp.asarray(a.float().numpy()) for a in bf)
    want, want_hf = ref.ssd_ref(xj, jnp.asarray(dt), jnp.asarray(A), bj, cj,
                                init_state=jnp.asarray(h0))
    _close(y.float(), want, 2e-2)
    _close(hf, want_hf, SSD_TOL)


def test_plain_ssd_stays_finite_when_decay_sums_past_100(rng):
    """dt·|A| of ~25 per token sums past 100 within a few tokens of a
    chunk: e^{cum_i - cum_j} above the diagonal would overflow to inf, and
    a 0/1 mask would turn it into NaN.  The plain version agrees with the
    sequential oracle and stays finite."""
    B, S, H, P, G, N = 1, 48, 2, 8, 1, 8
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, B, S, H, P, G, N, init=True)
    dt = np.full_like(dt, 5.0)
    A = np.full_like(A, -5.0)
    y, hf = plain.ssd_ref(*map(_t, (x, dt, A, Bm, Cm)), init_state=_t(h0),
                          chunk=16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    y_ref, hf_ref = ref.ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                init_state=jnp.asarray(h0))
    _close(y, y_ref, SSD_TOL)
    _close(hf, hf_ref, SSD_TOL)


def test_ssd_decode_step_matches_the_chunked_scan(rng):
    """Token-by-token recurrent decode == the chunked scan, on both
    packages' decode steps."""
    B, S, H, P, G, N = 2, 20, 4, 8, 2, 8
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, B, S, H, P, G, N, init=True)
    y_scan, hf_scan = plain.ssd_ref(*map(_t, (x, dt, A, Bm, Cm)),
                                    init_state=_t(h0), chunk=8)
    state, jstate = _t(h0), jnp.asarray(h0)
    for t in range(S):
        args = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        y, state = ops.ssd_decode_step(state, *map(_t, args))
        jy, jstate = jnp_impl.ssd_decode_step(jstate,
                                              *map(jnp.asarray, args))
        _close(y, y_scan[:, t], SSD_TOL)
        _close(y, jy, SSD_TOL)
    _close(state, hf_scan, SSD_TOL)
    _close(state, jstate, SSD_TOL)


def test_ssd_cuda_impl_is_refused_on_cpu_tensors(rng):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(rng, 1, 8, 2, 4, 1, 4)
    with pytest.raises(ValueError):
        ops.ssd(*map(_t, (x, dt, A, Bm, Cm)), impl="cuda")


# ---------------------------------------------------------------------------
# The Mamba2 mixer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixer():
    """Layer 0's JAX mamba params of the smoke config, with dt_bias, conv_b
    and D made non-trivial, and the port's Mamba holding them."""
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 3)
    tree = {k: np.asarray(v)[0]  # layer 0 of the stacked period
            for k, v in params["period"]["l0"]["mamba"].items()}
    rng = np.random.default_rng(5)
    tree["dt_bias"] = (rng.standard_normal(tree["dt_bias"].shape) * 0.5
                       ).astype(np.float32)
    tree["conv_b"] = (rng.standard_normal(tree["conv_b"].shape) * 0.1
                      ).astype(np.float32)
    tree["D"] = (1 + rng.standard_normal(tree["D"].shape) * 0.1
                 ).astype(np.float32)
    pcfg = port_smoke_config(ARCH)
    mod = Mamba(pcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(tree[name])))
    return cfg, pcfg, tree, mod


def _jcache(c):
    return {k: jnp.asarray(v.numpy()) for k, v in c.items()}


def test_mamba_prefill_chained_prefill_and_decode_match(mixer):
    cfg, pcfg, tree, mod = mixer
    p = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    B, d = 2, cfg.d_model
    x = (rng.standard_normal((B, 23, d)) * 0.5).astype(np.float32)
    # prefill without a cache
    want, _ = jmamba.apply_mamba(p, cfg, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    _close(got, want)
    # prefill of 2 then 21 tokens (S < W - 1 first), then 3 decode steps,
    # against the reference's caches at each step
    cache = init_mamba_cache(pcfg, B, torch.float32, "cpu")
    jcache = jmamba.init_mamba_cache(cfg, B, jnp.float32)
    for lo, hi in ((0, 2), (2, 23)):
        want, jcache = jmamba.apply_mamba(p, cfg, jnp.asarray(x[:, lo:hi]),
                                          cache=jcache)
        with torch.no_grad():
            got = mod(torch.from_numpy(x[:, lo:hi]), cache=cache)
        _close(got, want)
        _close(cache["conv"], jcache["conv"])
        _close(cache["ssm"], jcache["ssm"])
    step = (rng.standard_normal((B, 3, d)) * 0.5).astype(np.float32)
    for t in range(3):
        want, jcache = jmamba.apply_mamba(p, cfg, jnp.asarray(step[:, t:t + 1]),
                                          cache=jcache, decode=True)
        with torch.no_grad():
            got = mod(torch.from_numpy(step[:, t:t + 1]), cache=cache,
                      decode=True)
        _close(got, want)
        _close(cache["conv"], jcache["conv"])
        _close(cache["ssm"], jcache["ssm"])


def test_mamba_writes_the_rows_it_was_handed(mixer):
    """The engine hands the mixer views of its slot rows and discards the
    returned cache: the update must land in those views."""
    _, pcfg, _, mod = mixer
    cache = init_mamba_cache(pcfg, 3, torch.float32, "cpu")
    row = {k: v[1:2] for k, v in cache.items()}
    x = torch.randn(1, 5, pcfg.d_model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod(x, cache=row)
    assert float(cache["ssm"][1].abs().sum()) > 0
    assert float(cache["conv"][1].abs().sum()) > 0
    assert float(cache["ssm"][0].abs().sum()) == 0
    assert float(cache["ssm"][2].abs().sum()) == 0


def test_seeded_mamba_params_keep_the_reference_types_and_kinds():
    cfg = port_smoke_config(ARCH).replace(dtype="bfloat16")
    model = tfm.init_params(cfg, 0, device="cpu")
    mix = model.layers[0].mamba
    for name in ("A_log", "dt_bias", "D"):
        assert getattr(mix, name).dtype == torch.float32
    for name in ("in_proj", "conv_w", "conv_b", "norm", "out_proj"):
        assert getattr(mix, name).dtype == torch.bfloat16
    a = mix.A_log
    assert float(a.min()) >= -1 and float(a.max()) <= 1 and float(a.std()) > 0.2
    assert torch.equal(mix.dt_bias, torch.zeros_like(mix.dt_bias))
    assert torch.equal(mix.D, torch.ones_like(mix.D))
    assert not hasattr(model.layers[0], "norm2")
    again = initialize(tfm.Transformer(cfg, device="cpu",
                                       dtype=torch.bfloat16), 0)
    assert torch.equal(again.layers[0].mamba.A_log, a)


# ---------------------------------------------------------------------------
# mamba2-370m-smoke end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    pcfg = port_smoke_config(ARCH)
    model = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, pcfg, model


def test_bridge_round_trips_bit_for_bit(pair):
    _, params, _, model = pair
    want = jax.tree.map(np.asarray, params)
    got = bridge.to_numpy(model)
    flat_w = dict(bridge._flatten(want))
    flat_g = dict(bridge._flatten(got))
    assert flat_w.keys() == flat_g.keys()
    for key, arr in flat_w.items():
        assert flat_g[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(flat_g[key], arr, err_msg=key)


def test_forward_prefill_continuation_and_decode_match(pair):
    cfg, params, pcfg, model = pair
    rng = np.random.default_rng(17)
    B, S = 2, 40  # more than two of the smoke config's 16-token chunks
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jtfm.forward(params, cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _ = model(tokens=torch.from_numpy(toks).long())
    _close(got, want)
    # prefill 29 tokens into a cache, then 11 one-token decode steps with
    # per-slot lengths, against the reference's cache path
    jcache = jtfm.init_cache(cfg, B, 64)
    cache = tfm.init_cache(pcfg, B, 64, device="cpu")
    want, aux = jtfm.forward(params, cfg, tokens=jnp.asarray(toks[:, :29]),
                             cache=jcache, cache_index=0)
    jcache = aux["cache"]
    with torch.no_grad():
        got, _ = model(tokens=torch.from_numpy(toks[:, :29]).long(),
                       cache=cache, cache_index=0)
    _close(got, want)
    for t in range(29, S):
        lens = np.full((B,), t, np.int32)
        want, aux = jtfm.forward(params, cfg,
                                 tokens=jnp.asarray(toks[:, t:t + 1]),
                                 cache=jcache, cache_index=jnp.asarray(lens),
                                 decode=True)
        jcache = aux["cache"]
        with torch.no_grad():
            got, _ = model(tokens=torch.from_numpy(toks[:, t:t + 1]).long(),
                           cache=cache, cache_index=torch.from_numpy(lens),
                           decode=True)
        _close(got, want)
    jlist = bridge.layerwise_to_list(cfg, jax.tree.map(np.asarray, jcache))
    for c, jc in zip(cache, jlist):
        _close(c["conv"], jc["conv"])
        _close(c["ssm"], jc["ssm"])


def test_paged_cache_keeps_mamba_state_per_slot():
    pcfg = port_smoke_config(ARCH)
    cache = tfm.init_paged_cache(pcfg, num_blocks=9, block_size=4, slots=3,
                                 device="cpu")
    mb = pcfg.mamba
    conv_dim = mb.d_inner(pcfg.d_model) + 2 * mb.ngroups * mb.d_state
    assert len(cache) == pcfg.num_layers
    for c in cache:
        assert set(c) == {"conv", "ssm"}
        assert tuple(c["conv"].shape) == (3, mb.conv_width - 1, conv_dim)
        assert tuple(c["ssm"].shape) == (3, mb.nheads(pcfg.d_model),
                                         mb.headdim, mb.d_state)
        assert c["ssm"].dtype == torch.float32


def test_blocks_the_port_lacks_still_raise():
    """The enc-dec block (Whisper's decoder layer, ported since the
    Mamba2 slice) against ``apply_block`` on whisper-medium-smoke, on each
    of its cross-attention's three paths: to ``encoder_out``, to the
    cache's ``ck`` / ``cv`` (here written by the first call), and with
    neither the fall-through (a causal self-attention with the cross
    weights); a mixer the port has no module for still raises."""
    from repro.models.blocks import apply_block
    from repro_torch.config import LayerDesc
    from repro_torch.models.blocks import Block

    arch = "whisper-medium"
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    model = bridge.from_jax_params(port_smoke_config(arch),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    desc = cfg.layout.period[0]
    jp = jax.tree.map(lambda x: x[0], params["period"]["l0"])
    block = model.layers[0]
    rng = np.random.default_rng(12)
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    zeros = np.zeros((2, 7, cfg.num_heads, cfg.hd), np.float32)
    jcache = {"ck": jnp.asarray(zeros), "cv": jnp.asarray(zeros)}
    pcache = {"ck": torch.zeros(zeros.shape), "cv": torch.zeros(zeros.shape)}
    want, jnew, _ = apply_block(jp, cfg, desc, jnp.asarray(h),
                                positions=jnp.asarray(pos),
                                encoder_out=jnp.asarray(enc), cache=jcache)
    got, _, _ = block(torch.from_numpy(h), positions=torch.from_numpy(pos),
                      encoder_out=torch.from_numpy(enc), cache=pcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for key in ("ck", "cv"):  # the frames' K/V, written into the cache
        np.testing.assert_allclose(pcache[key].numpy(),
                                   np.asarray(jnew[key]), atol=1e-5)
    want2, _, _ = apply_block(jp, cfg, desc, jnp.asarray(h),
                              positions=jnp.asarray(pos), cache=jnew)
    got2, _, _ = block(torch.from_numpy(h), positions=torch.from_numpy(pos),
                       cache=pcache)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)
    want3, _, _ = apply_block(jp, cfg, desc, jnp.asarray(h),
                              positions=jnp.asarray(pos))
    got3, _, _ = block(torch.from_numpy(h), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), atol=1e-4,
                               rtol=1e-4)
    assert float(np.abs(got3.numpy() - got.numpy()).max()) > 1e-3
    pcfg = port_smoke_config(ARCH)
    with pytest.raises(NotImplementedError):
        Block(pcfg, LayerDesc("ssm", "dense"), device="cpu",
              dtype=torch.float32)
