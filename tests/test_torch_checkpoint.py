"""The port's checkpoints and trainer lifecycle (as
tests/test_fault_tolerance.py checks the reference's): round trip, restart
reproducing the loss curve bit for bit, preemption flag, rotation, atomic
save, seekable stream, straggler watchdog; and the format shared with the
JAX package: a port checkpoint loads in ``repro.checkpoint.store.load_tree``
to equal arrays, a JAX one in the port's, and the port's own manifest
encoder writes ``msgpack.packb``'s bytes.
"""

import os

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import load_tree as jload
from repro.checkpoint import save_tree as jsave
from repro.data import PretrainStream as JStream
from repro.data import SyntheticVocab as JVocab
from repro_torch.checkpoint import CheckpointManager, load_tree, save_tree
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.data import (Prefetcher, PretrainStream, SyntheticVocab,
                              host_slice)
from repro_torch.launch.steps import build_lm_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import warmup_cosine
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


def _stream(seed=7):
    return PretrainStream(SyntheticVocab(), batch=4, seq_len=32,
                          split_choices=(16, 20), seed=seed)


def _setup(tmp_path, num_steps=12, ckpt_every=4):
    cfg = get_smoke_config("smollm-135m").replace(
        vocab_size=SyntheticVocab().size)
    model = tfm.init_params(cfg, 0, device="cpu")
    step, opt, params = build_lm_train_step(
        cfg, model, remat=False, lr=warmup_cosine(1e-3, 2, 20))
    stream = _stream()

    def batch_at(i):
        b = stream.batch_at(i)
        toks = np.concatenate([b["source"], b["target"]], axis=1)
        return {"tokens": torch.from_numpy(toks).long()}

    tc = TrainerConfig(num_steps=num_steps, ckpt_every=ckpt_every,
                       log_every=1)
    return Trainer(step, params, opt.init(params), batch_at, str(tmp_path),
                   tc)


def _tree(rng):
    return {"a": torch.from_numpy(rng.standard_normal((4, 8)).astype(
                np.float32)),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "c": torch.from_numpy(rng.standard_normal(3).astype(
                           np.float32)).to(torch.bfloat16),
                       "d": torch.tensor(3, dtype=torch.int32)},
            "list": [torch.ones(2, dtype=torch.int8), None,
                     torch.zeros((2, 3), dtype=torch.float32)]}


@pytest.mark.parametrize("codec", ["zlib", "raw", None])
def test_checkpoint_roundtrip(tmp_path, rng, codec):
    tree = _tree(rng)
    save_tree(str(tmp_path / "t"), tree, meta={"step": 3}, codec=codec,
              shard_bytes=40)
    flat, meta = load_tree(str(tmp_path / "t"))
    assert meta == {"step": 3}
    assert set(flat) == {"a", "nested/b", "nested/c", "nested/d", "list/0",
                         "list/2"}
    out, _ = load_tree(str(tmp_path / "t"), tree)
    for (na, a), (nb, b) in zip(store.flatten(tree), store.flatten(out)):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b)
    assert out["list"][1] is None


def test_restart_reproduces_loss_curve(tmp_path):
    """Stop at step 6 of 12 and restart from its checkpoint: the losses of
    steps 7-12 and the final parameters equal the uninterrupted run's, bit
    for bit."""
    full = _setup(tmp_path / "full")
    full.run()
    first = _setup(tmp_path / "resume", ckpt_every=6)
    first.tc = TrainerConfig(num_steps=6, ckpt_every=6, log_every=1)
    first.run()
    second = _setup(tmp_path / "resume", ckpt_every=6)
    assert second.restore_if_available() == 6
    assert second.run()["step"] == 12
    assert [second.losses[s] for s in range(7, 13)] == \
        [full.losses[s] for s in range(7, 13)]
    for name, p in full.params.items():
        assert torch.equal(p, second.params[name]), name
    assert int(second.opt_state["count"]) == 12


def test_restore_a_named_step(tmp_path):
    t = _setup(tmp_path, num_steps=4, ckpt_every=2)
    t.run()
    snap = {n: p.detach().clone() for n, p in t.params.items()}
    again = _setup(tmp_path, num_steps=4, ckpt_every=2)
    assert again.restore_if_available(step=2) == 2
    assert int(again.opt_state["count"]) == 2
    again.run()
    assert again.losses[4] == t.losses[4]
    for n, p in again.params.items():
        assert torch.equal(p, snap[n]), n


def test_preemption_flag_saves_and_exits(tmp_path):
    trainer = _setup(tmp_path, num_steps=50, ckpt_every=100)
    trainer.mgr.flag_preemption()
    out = trainer.run()
    assert out.get("preempted_at") == 0
    assert not trainer.mgr.preempted()
    step, _, _ = trainer.mgr.restore_latest()
    assert step == 0


def test_rotation_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(2)})
    assert mgr.available_steps() == [3, 4]


def test_atomic_save_ignores_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.arange(4, dtype=torch.float32)})
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("x")
    step, out, _ = mgr.restore_latest()
    assert step == 1 and torch.equal(out["x"], torch.arange(4.0))


def test_data_stream_seekable_and_equal_to_the_reference():
    a, b = _stream(seed=3).batch_at(10), _stream(seed=3).batch_at(10)
    ref = JStream(JVocab(), batch=4, seq_len=32, split_choices=(16, 20),
                  seed=3).batch_at(10)
    for k in ("source", "target", "target_mask"):
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], ref[k])


def test_prefetcher_runs_ahead_in_order_and_surfaces_errors():
    stream = _stream(seed=5)
    pf = Prefetcher(stream.batch_at, start_step=3, depth=2)
    try:
        for want in (3, 4, 5):
            step, batch = pf.get()
            assert step == want
            np.testing.assert_array_equal(batch["source"],
                                          stream.batch_at(want)["source"])
    finally:
        pf.stop()

    def producer(step):
        if step == 1:
            raise ValueError("bad shard")
        return {"step": step}

    pf = Prefetcher(producer)
    try:
        assert pf.get() == (0, {"step": 0})
        with pytest.raises(ValueError, match="bad shard"):
            pf.get()
    finally:
        pf.stop()
    assert [host_slice(8, h, 4) for h in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]


def test_straggler_watchdog_counts(tmp_path, monkeypatch):
    trainer = _setup(tmp_path, num_steps=6, ckpt_every=100)
    seq = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 1.0, 10.0, 10.1, 10.2]
    state = {"i": -1}

    def fake_monotonic():
        state["i"] += 1
        i = min(state["i"], len(seq) - 1)
        return seq[i] + max(0, state["i"] - len(seq) + 1) * 0.05

    import repro_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod.time, "monotonic", fake_monotonic)
    assert trainer.run()["stragglers"] >= 1


def test_port_checkpoint_loads_in_the_reference(tmp_path, rng):
    tree = _tree(rng)
    save_tree(str(tmp_path / "p"), tree, meta={"step": 5, "note": "x"},
              codec="zlib")
    arrays, meta = jload(str(tmp_path / "p"))
    assert meta == {"step": 5, "note": "x"}
    for name, t in store.flatten(tree):
        got = arrays[name]
        if t.dtype == torch.bfloat16:
            assert got.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(got.astype(np.float32),
                                          t.float().numpy())
        else:
            assert got.dtype == t.numpy().dtype
            np.testing.assert_array_equal(got, t.numpy())


@pytest.mark.parametrize("codec", ["zlib", "raw"])
def test_reference_checkpoint_loads_in_the_port(tmp_path, rng, codec):
    tree = {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
            "opt": {"count": jnp.asarray(4, jnp.int32),
                    "mu": [jnp.asarray(rng.standard_normal(6), jnp.bfloat16)]}}
    jsave(str(tmp_path / "j"), tree, meta={"step": 4}, codec=codec)
    arrays, meta = load_tree(str(tmp_path / "j"))
    assert meta == {"step": 4}
    assert arrays["opt/mu/0"].dtype == torch.bfloat16
    np.testing.assert_array_equal(arrays["opt/mu/0"].float().numpy(),
                                  np.asarray(tree["opt"]["mu"][0], np.float32))
    np.testing.assert_array_equal(arrays["w"].numpy(), np.asarray(tree["w"]))
    assert arrays["opt/count"].dtype == torch.int32 and int(
        arrays["opt/count"]) == 4


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=40)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_manifest_encoder_writes_msgpacks_bytes(value):
    assert store.packb(value) == msgpack.packb(value)
    assert store.unpackb(msgpack.packb(value)) == msgpack.unpackb(
        msgpack.packb(value))


def test_manifest_encoder_on_a_real_manifest(tmp_path, rng):
    save_tree(str(tmp_path / "m"), _tree(rng), meta={"step": 70000,
                                                     "loss": 1.5})
    raw = (tmp_path / "m" / "manifest.msgpack").read_bytes()
    manifest = msgpack.unpackb(raw)
    assert store.packb(manifest) == raw == msgpack.packb(manifest)
    assert store.unpackb(raw) == manifest
    ext = {"zstd": ".bin.zst", "zlib": ".bin.zz"}[store.default_codec()]
    assert manifest["codec"] == store.default_codec()
    assert os.path.exists(tmp_path / "m" / f"shard_00000{ext}")
