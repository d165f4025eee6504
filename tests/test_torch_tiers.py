"""The port's tiered prefix store against the JAX package's, on the CPU.

Both packages run in one process on the same seeded inputs, the port on
parameters carried across by ``repro_torch.bridge`` and its plain kernels,
the JAX engine in its classic loop.  Serving cases run the same requests
(explicit uids) through both engines on a ``VirtualClock`` and require
identical tokens, ``trace`` (park / promote / promoted / wake events) and
``request_log``, and equal tier counters:

* codecs: the port's ``compress_bytes`` output decodes in the JAX
  package and the reverse;
* demote → spill → promote leaves a row bit-identical (dense and paged:
  the pool-block gather), on gemma2-2b-smoke, mistral-7b-smoke and
  smollm-135m;
* tokens identical from HBM, host, disk and a fresh compile;
* raw shots promote rather than recompile; parked requests wake in
  arrival order; a seated prefix is never demoted; the paged LRU demotes;
  host pressure spills (or drops, counted); shards survive a restart; an
  install defers behind queued work; an unknown prefix still raises;
* shards: one written by the JAX store is promoted by the port and
  serves the JAX engine's tokens, and the reverse.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import compress_bytes as jcompress
from repro.checkpoint.store import decompress_bytes as jdecompress
from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.checkpoint.store import compress_bytes, decompress_bytes
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.serving import (PrefixSeatedError, Request, ServingEngine,
                                 VirtualClock, materialize_prefix,
                                 take_prefix_row)

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist

_SETUPS = {}


def _setup(arch="smollm-135m"):
    if arch not in _SETUPS:
        cfg = get_smoke_config(arch)
        params = jtfm.init_params(cfg, 0)
        mc = jmc.init_memcom(cfg, params, 1)
        pcfg = port_smoke_config(arch)
        target = bridge.from_jax_params(
            pcfg, jax.tree.map(np.asarray, params), device="cpu")
        comp = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                      device="cpu")
        rng = np.random.default_rng(41)
        shots = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
                 for n in (40, 40, 48)]
        prompt = rng.integers(4, cfg.vocab_size, 5).astype(np.int32)
        s = dict(cfg=cfg, params=params, mc=mc, pcfg=pcfg, target=target,
                 comp=comp, shots=shots, prompt=prompt,
                 m=cfg.memcom.num_memory_tokens)
        s["kv"] = [_offline(s, x) for x in shots]
        _SETUPS[arch] = s
    return _SETUPS[arch]


def _offline(s, shots):
    jkv = jmaterialize(s["params"], s["cfg"],
                       jmc.compress(s["mc"], s["cfg"],
                                    jnp.asarray(shots[None]))[0])
    kv = materialize_prefix(s["target"], s["pcfg"], memcom.compress(
        s["comp"], s["pcfg"], torch.as_tensor(shots[None]))[0])
    return jkv, kv


def _engines(s, tmp=None, compressor=False, **kw):
    """A JAX and a port engine; ``tmp`` gives each its own disk tier."""
    jkw, pkw = dict(kw), dict(kw)
    if tmp is not None:
        jkw["disk_dir"], pkw["disk_dir"] = str(tmp / "jax"), str(tmp / "port")
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(),
                  compressor=s["mc"] if compressor else None, **jkw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(),
                      compressor=s["comp"] if compressor else None, **pkw)
    return j, p


def _both(j, p, fn):
    """``fn(engine)`` on the JAX engine, then on the port's."""
    for eng in (j, p):
        fn(eng)


def _add(j, p, name, t):
    j.add_prefix(name, t[0])
    p.add_prefix(name, t[1])


def _serve_both(j, p, specs):
    want = j.serve([JRequest(**x) for x in specs])
    got = p.serve([Request(**x) for x in specs])
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace
    assert p.request_log == j.request_log
    return got


def _same_tiers(j, p, names):
    for n in names:
        assert p.store.tier_of(n) == j.store.tier_of(n), n
    want = j.stats()["prefix_tiers"]
    assert p.stats()["prefix_tiers"] == want
    return want


def _assert_rows_bit_exact(a, b):
    """Two per-layer port rows: same keys, dtypes, shapes and bytes."""
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert sorted(ea) == sorted(eb)
        for key in ea:
            assert ea[key].dtype == eb[key].dtype
            assert torch.equal(ea[key], eb[key]), key


# ---------------------------------------------------------------------------
# Codecs (tests/test_tiers.py:56, :67)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["zstd", "zlib", "raw"])
def test_codec_round_trip_across_packages(codec):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    payload = np.random.default_rng(0).bytes(4096) + b"\x00" * 4096
    tag, blob = compress_bytes(payload, codec)
    assert tag == codec and decompress_bytes(blob, tag) == payload
    assert jdecompress(blob, tag) == payload
    assert decompress_bytes(jcompress(payload, codec)[1], codec) == payload
    if codec != "raw":
        assert len(blob) < len(payload)
    with pytest.raises(ValueError, match="unknown checkpoint codec"):
        compress_bytes(b"", "lz4")


# ---------------------------------------------------------------------------
# Bit-exact round trips (tests/test_tiers.py:82, :111, :141)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma2-2b", "mistral-7b", "smollm-135m"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_round_trip_bit_exact_and_serves_like_jax(arch, layout, tmp_path):
    """warm serve → unseat → demote (paged: gathered out of the pool) →
    spill → promote one layer a step: the row comes back byte-identical
    and the request's tokens, trace and counters equal the JAX engine's."""
    s = _setup(arch)
    ref = take_prefix_row(s["kv"][0][1], 0)
    j, p = _engines(s, tmp_path, slots=2, max_len=s["m"] + 24,
                    kv_layout=layout, host_capacity=4,
                    promote_layer_budget=1)
    _add(j, p, "t", s["kv"][0])
    req = dict(tokens=s["prompt"], max_new=5, prefix="t")
    warm = _serve_both(j, p, [dict(req, uid=1)])[1]
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=1, uid=2)])
    _both(j, p, lambda e: e.store.demote("t"))
    _assert_rows_bit_exact(ref, p.store._host["t"])
    _both(j, p, lambda e: e.store.spill("t"))
    _same_tiers(j, p, ["t"])
    assert p.store.tier_of("t") == "disk" and "t" not in p.store
    out = _serve_both(j, p, [dict(req, uid=3)])
    np.testing.assert_array_equal(out[3], warm)
    # nothing else decodes: the whole promotion runs in one step
    assert p.trace[:3] == [("park", 3, "t"),
                           ("promote", s["pcfg"].num_layers), ("promoted", "t")]
    ts = _same_tiers(j, p, ["t"])
    assert ts["demotes"] == ts["spills"] == ts["disk_loads"] == 1
    assert ts["host_promotes"] == 1
    assert ts["promote_chunks"] == s["pcfg"].num_layers
    # gathered back out of the promoted copy: still byte-identical
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=1, uid=4)])
    _both(j, p, lambda e: e.store.demote("t"))
    _assert_rows_bit_exact(ref, p.store._host["t"])


def test_promote_step_api_bit_exact(tmp_path):
    """The store's own API, as tests/test_tiers.py:82 drives it."""
    s = _setup()
    ref = take_prefix_row(s["kv"][0][1], 0)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu", slots=1,
                      max_len=s["m"] + 24, host_capacity=4,
                      disk_dir=str(tmp_path))
    p.add_prefix("t", s["kv"][0][1])
    p.store.demote("t")
    assert p.store.tier_of("t") == "host"
    p.store.spill("t")
    job = p.store.submit_promotion("t")
    assert job.source == "disk" and job.total_chunks == s["pcfg"].num_layers
    assert p.store.submit_promotion("t") is job  # single-flight
    assert p.store.promote_step(None) == ["t"]
    _assert_rows_bit_exact(ref, p.store.promoted_row("t"))
    p.store.put_row("t", p.store.promoted_row("t"))
    p.store.mark_promoted("t")
    _assert_rows_bit_exact(ref, p.store.get("t"))
    assert not os.listdir(tmp_path)  # the install dropped the cold copy


# ---------------------------------------------------------------------------
# Tokens identical across tiers (tests/test_tiers.py:176)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tokens_identical_across_tiers_like_jax(layout, tmp_path):
    s = _setup()
    j, p = _engines(s, tmp_path, compressor=True, slots=2,
                    max_len=s["m"] + 24, kv_layout=layout,
                    compile_token_budget=16, host_capacity=4,
                    promote_layer_budget=1)
    _add(j, p, "t", s["kv"][0])
    uid = iter(range(100, 200))

    def one(prefix="t", raw=None):
        out = _serve_both(j, p, [dict(tokens=s["prompt"], max_new=5,
                                      prefix=prefix, raw_shots=raw,
                                      uid=next(uid))])
        return next(iter(out.values()))

    def unseat():
        _serve_both(j, p, [dict(tokens=s["prompt"], max_new=1,
                                uid=next(uid))])

    warm = one()
    unseat()
    _both(j, p, lambda e: e.store.demote("t"))
    host_hit = one()
    unseat()
    _both(j, p, lambda e: e.store.demote("t"))
    _both(j, p, lambda e: e.store.spill("t"))
    disk_hit = one()
    fresh = one(prefix=None, raw=s["shots"][0])
    for got in (host_hit, disk_hit, fresh):
        np.testing.assert_array_equal(got, warm)
    ts = _same_tiers(j, p, ["t"])
    assert ts["host_promotes"] == 2 and ts["disk_loads"] == 1
    assert p.stats()["compiler"] == j.stats()["compiler"]
    assert p.stats()["compiler"]["compiled"] == 1


def test_raw_shots_prefer_promotion_like_jax():
    s = _setup()
    j, p = _engines(s, compressor=True, slots=1, max_len=s["m"] + 24,
                    host_capacity=4)
    shots = s["shots"][0]
    name = Request(tokens=[1], max_new=1, raw_shots=shots).prefix
    first = _serve_both(j, p, [dict(tokens=s["prompt"], max_new=3,
                                    raw_shots=shots, uid=1)])
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=1, uid=2)])
    _both(j, p, lambda e: e.store.demote(name))
    again = _serve_both(j, p, [dict(tokens=s["prompt"], max_new=3,
                                    raw_shots=shots.copy(), uid=3)])
    np.testing.assert_array_equal(again[3], first[1])
    assert p.stats()["compiler"]["jobs"] == 1
    assert _same_tiers(j, p, [name])["host_promotes"] == 1


# ---------------------------------------------------------------------------
# Scheduling around cold prefixes (tests/test_tiers.py:219, :247, :284)
# ---------------------------------------------------------------------------


def test_park_wake_fifo_like_jax():
    """Requests parked on a promoting prefix wake in arrival order; warm
    traffic runs meanwhile; one promotion for both."""
    s = _setup()
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, host_capacity=4,
                    promote_layer_budget=1)
    _add(j, p, "A", s["kv"][0])
    _add(j, p, "B", s["kv"][1])
    _both(j, p, lambda e: e.store.demote("B"))
    _serve_both(j, p, [
        dict(tokens=s["prompt"], max_new=2, prefix="B", uid=1),
        dict(tokens=s["prompt"], max_new=2, prefix="A", uid=2),
        dict(tokens=s["prompt"], max_new=2, prefix="B", uid=3)])
    assert [e[1] for e in p.trace if e[0] == "park"] == [1, 3]
    assert [e[1] for e in p.trace if e[0] == "admit"] == [2, 1, 3]
    assert _same_tiers(j, p, ["A", "B"])["host_promotes"] == 1


def test_decode_continues_during_promotion_like_jax():
    s = _setup()
    j, p = _engines(s, slots=2, max_len=s["m"] + 40, host_capacity=4,
                    promote_layer_budget=1)
    _add(j, p, "A", s["kv"][0])
    _add(j, p, "B", s["kv"][2])
    _both(j, p, lambda e: e.store.demote("B"))
    _serve_both(j, p, [
        dict(tokens=s["prompt"], max_new=12, prefix="A", uid=1),
        dict(tokens=s["prompt"], max_new=3, prefix="B", uid=2)])
    idx = [i for i, e in enumerate(p.trace) if e[0] == "promote"]
    assert len(idx) >= 2
    assert any(e[0] == "decode" for e in p.trace[idx[0]:idx[-1]])
    eng = p.stats()["engine"]
    for key in ("decode_steps_during_promote", "promote_steps_interleaved"):
        assert eng[key] == j.stats()["engine"][key] >= 2


# ---------------------------------------------------------------------------
# Guards and pressure (tests/test_tiers.py:324-472)
# ---------------------------------------------------------------------------


def test_seated_prefix_is_never_demoted():
    s = _setup()
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, kv_layout="paged",
                    host_capacity=4)
    _add(j, p, "t", s["kv"][0])
    for eng in (j, p):
        eng.seat_prefix(0, "t")
        with pytest.raises(Exception) as err:
            eng.store.demote("t")
        assert type(err.value).__name__ == "PrefixSeatedError"
        assert eng.store.tier_of("t") == "hbm"
        assert not eng.store.host_names()
    assert isinstance(err.value, PrefixSeatedError)


def test_paged_lru_demotes_like_jax():
    """prefix_capacity=1: registering B demotes A to host; serving A
    promotes it back (no compressor) and demotes B in turn."""
    s = _setup()
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, kv_layout="paged",
                    prefix_capacity=1, host_capacity=4)
    _add(j, p, "A", s["kv"][0])
    _add(j, p, "B", s["kv"][1])
    assert p.store.tier_of("A") == "host" and p.store.tier_of("B") == "hbm"
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=4, prefix="A",
                            uid=1)])
    assert _same_tiers(j, p, ["A", "B"])["demotes"] == 2
    assert p.store.tier_of("B") == "host"
    assert p.alloc.snapshot() == j.alloc.snapshot()


def test_dense_lru_capacity_demotes():
    s = _setup()
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, prefix_capacity=2,
                    host_capacity=4)
    for name in "ABC":
        _add(j, p, name, s["kv"][0])
    assert sorted(p.store.hbm.names()) == ["B", "C"]
    assert _same_tiers(j, p, "ABC")["demotes"] == 1


@pytest.mark.parametrize("disk", [True, False])
def test_host_pressure_spills_or_drops_like_jax(disk, tmp_path):
    s = _setup()
    j, p = _engines(s, tmp_path if disk else None, slots=1,
                    max_len=s["m"] + 24, host_capacity=1)
    for name in "ABC":
        _add(j, p, name, s["kv"][0])
        _both(j, p, lambda e: e.store.demote(name))
    ts = _same_tiers(j, p, "ABC")
    assert p.store.tier_of("C") == "host"
    if disk:
        assert {p.store.tier_of(n) for n in "AB"} == {"disk"}
        assert ts["spills"] == 2
        assert len(os.listdir(tmp_path / "port")) == 2
    else:
        assert p.store.tier_of("A") is None and ts["host_drops"] == 2


def test_disk_shards_survive_a_restart_like_jax(tmp_path):
    s = _setup()
    kw = dict(slots=1, max_len=s["m"] + 24, host_capacity=0)
    j, p = _engines(s, tmp_path, **kw)
    _add(j, p, "t", s["kv"][0])
    req = dict(tokens=s["prompt"], max_new=4, prefix="t")
    want = _serve_both(j, p, [dict(req, uid=1)])[1]
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=1, uid=2)])
    _both(j, p, lambda e: e.store.demote("t"))  # straight to disk
    j2, p2 = _engines(s, tmp_path, **kw)
    assert p2.store.tier_of("t") == j2.store.tier_of("t") == "disk"
    out = _serve_both(j2, p2, [dict(req, uid=3)])
    np.testing.assert_array_equal(out[3], want)
    assert p2.stats()["compiler"] is None


def test_install_defers_on_queued_work_like_jax():
    """A promoted prefix whose install cannot evict (the sole resident
    entry is pinned by a queued request) waits instead of raising."""
    s = _setup()
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, prefix_capacity=1,
                    host_capacity=4, promote_layer_budget=1)
    _add(j, p, "A", s["kv"][0])
    _add(j, p, "C", s["kv"][1])  # demotes A
    _both(j, p, lambda e: e.store.demote("C"))
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=2, prefix="A",
                            uid=1)])
    out = _serve_both(j, p, [
        dict(tokens=s["prompt"], max_new=8, prefix="A", uid=2),
        dict(tokens=s["prompt"], max_new=2, prefix="C", uid=3),
        dict(tokens=s["prompt"], max_new=2, prefix="A", uid=4)])
    assert len(out) == 3 and all(len(v) for v in out.values())
    assert p.store.tier_of("C") == "hbm"
    _same_tiers(j, p, ["A", "C"])


def test_unknown_cold_prefix_still_raises():
    s = _setup()
    j, p = _engines(s, slots=1, max_len=32, host_capacity=4)
    for eng, R in ((j, JRequest), (p, Request)):
        with pytest.raises(KeyError, match="nope"):
            eng.serve([R(tokens=[5], max_new=1, prefix="nope")])
    with pytest.raises(ValueError, match="host_capacity"):
        ServingEngine(s["pcfg"], s["target"], device="cpu", slots=1,
                      max_len=32, host_capacity=-1)


# ---------------------------------------------------------------------------
# Shards written by one package, read by the other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_shard_interop(writer, layout, tmp_path):
    """One package spills a prefix to disk; a fresh engine of each
    package indexes the shard and serves from it: the same tokens, trace
    and request log, and the port's promoted row is the shard's bytes."""
    s = _setup()
    shard_dir = tmp_path / "shards"
    kw = dict(slots=1, max_len=s["m"] + 24, kv_layout=layout,
              host_capacity=0, disk_dir=str(shard_dir))
    if writer == "jax":
        eng = JaxEngine(s["cfg"], s["params"], **kw)
        eng.add_prefix("t", s["kv"][0][0])
    else:
        eng = ServingEngine(s["pcfg"], s["target"], device="cpu", **kw)
        eng.add_prefix("t", s["kv"][0][1])
    eng.store.demote("t")
    (shard,) = os.listdir(shard_dir)
    raw = (shard_dir / shard).read_bytes()
    assert raw[:4] == b"MCPF"
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(), **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), **kw)
    assert p.store.tier_of("t") == j.store.tier_of("t") == "disk"
    assert p.store.cold_base_len("t") == s["m"]
    # the port reads the shard's leaves as the JAX reader does
    jrow = j.store._read_shard(str(shard_dir / shard))
    prow = p.store._read_shard(str(shard_dir / shard))
    want = bridge.layerwise_to_list(s["pcfg"], jrow)
    for w, g in zip(want, prow):
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), w[key])
    # both serve from the same shard (each engine deletes its copy on
    # install, so the port serves first from a copy of the directory)
    import shutil

    shutil.copytree(shard_dir, tmp_path / "copy")
    p2 = ServingEngine(s["pcfg"], s["target"], device="cpu",
                       clock=VirtualClock(),
                       **dict(kw, disk_dir=str(tmp_path / "copy")))
    _serve_both(j, p2, [dict(tokens=s["prompt"], max_new=5, prefix="t",
                             uid=7)])
    assert p2.stats()["prefix_tiers"] == j.stats()["prefix_tiers"]
    assert p.store.tier_of("t") == "disk"
