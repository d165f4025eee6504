"""The port's analytic cost model (``repro_torch.launch.costs``) and cell
helpers (``repro_torch.launch.steps``: ``shape_by_name``,
``cell_is_skipped``, ``default_objective``, ``input_specs``) against the
JAX package's.

Every cost is a float that must equal the reference's bit for bit, for
every arch x shape x objective and both MemCom phases (the port keeps the
reference's evaluation order); where the reference raises, the port
raises the same type of error.  ``input_specs`` gives the reference's
shapes and dtypes without its shardings.  The reference's own cost tests
(``tests/test_layers_and_costs.py``) are mirrored on the port, and a
sanity band holds the analytic prefill FLOPs to what torch's FLOP counter
sees in the plain CPU forward.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.flop_counter import FlopCounterMode

from repro.config import SHAPES as JSHAPES
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import costs as jcosts
from repro.launch import steps as jsteps
from repro_torch.config import SHAPES, ShapeSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import costs, steps
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist

ARCHS = sorted(ARCH_IDS)
SHAPE_NAMES = [s.name for s in JSHAPES]
# (cost function, extra keyword arguments): both MemCom phases, and
# cell_cost's four objectives
COSTS = [("memcom_train_cost", {"phase": 1}),
         ("memcom_train_cost", {"phase": 2}),
         ("lm_train_cost", {}), ("prefill_cost", {}), ("decode_cost", {}),
         ("cell_cost", {"objective": "memcom_train"}),
         ("cell_cost", {"objective": "lm_train"}),
         ("cell_cost", {"objective": "prefill"}),
         ("cell_cost", {"objective": "decode"})]


def _shape(name, shapes=SHAPES):
    return next(s for s in shapes if s.name == name)


def _run(fn):
    """(result, None) or (None, the exception's type)."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 -- compared with the reference's
        return None, type(e)


def _same(got, want):
    """CellCost fields equal as floats (bit for bit), detail too."""
    for f in ("flops", "hbm_bytes", "model_flops"):
        a, b = getattr(got, f), getattr(want, f)
        assert type(a) is type(b) and a == b, (f, a, b)
    assert got.detail == want.detail


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("fn,kw", COSTS,
                         ids=[f"{f}-{'-'.join(map(str, k.values()))}"
                              for f, k in COSTS])
def test_costs_equal_the_references_bit_for_bit(arch, shape_name, fn, kw):
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape, jshape = _shape(shape_name), _shape(shape_name, JSHAPES)
    assert costs.train_split(shape) == jcosts.train_split(jshape)
    got, got_err = _run(lambda: getattr(costs, fn)(cfg, shape, **kw))
    want, want_err = _run(lambda: getattr(jcosts, fn)(jcfg, jshape, **kw))
    assert got_err is want_err
    if want_err is None:
        _same(got, want)


def test_memcom_train_on_an_attention_free_arch_raises_as_the_reference():
    shape = _shape("train_4k")
    with pytest.raises(AttributeError):
        jcosts.memcom_train_cost(jax_config("mamba2-370m"),
                                 _shape("train_4k", JSHAPES))
    with pytest.raises(AttributeError):
        costs.memcom_train_cost(get_config("mamba2-370m"), shape)
    for mod, cfg in ((costs, get_config("gemma2-2b")),
                     (jcosts, jax_config("gemma2-2b"))):
        with pytest.raises(ValueError):
            mod.cell_cost(cfg, shape, "compress")


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-medium",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("phase", [1, 2])
def test_split_keyword(arch, phase):
    """``split=None`` is the default split; an explicit split is the
    reference's cost at a shape whose 75/25 split is that split (seq 4096
    splits at 3072 + 1024)."""
    cfg = get_config(arch)
    shape = _shape("train_4k")
    _same(costs.memcom_train_cost(cfg, shape, phase, split=None),
          costs.memcom_train_cost(cfg, shape, phase))
    got = costs.memcom_train_cost(cfg, shape, phase, split=(3072, 1024))
    _same(got, jcosts.memcom_train_cost(jax_config(arch),
                                        _shape("train_4k", JSHAPES), phase))
    other = costs.memcom_train_cost(cfg, shape, phase, split=(3584, 512))
    assert other.detail["split"] == (3584, 512)
    assert other.flops != got.flops and other.model_flops == got.model_flops


# -- the reference's cost tests, on the port --------------------------------


def test_lm_train_flops_close_to_6nd():
    """Dense LM training ~ 6·N·D·tokens (attention adds the seq term)."""
    cc = costs.lm_train_cost(get_config("smollm-360m"), _shape("train_4k"))
    ratio = cc.flops / cc.model_flops
    assert 1.0 <= ratio < 1.6, ratio


def test_memcom_train_flops_exceed_lm_train():
    cfg, shape = get_config("smollm-360m"), _shape("train_4k")
    lm = costs.lm_train_cost(cfg, shape)
    mc = costs.memcom_train_cost(cfg, shape, phase=2)
    assert mc.flops > lm.flops
    assert costs.memcom_train_cost(cfg, shape, phase=1).flops < mc.flops


def test_decode_is_low_intensity():
    cc = costs.decode_cost(get_config("mistral-nemo-12b"), _shape("decode_32k"))
    assert cc.flops / cc.hbm_bytes < 10


def test_moe_active_vs_total_params():
    cfg = get_config("deepseek-v2-236b")
    assert cfg.active_param_count() < cfg.param_count() / 5
    dense = get_config("mistral-nemo-12b")
    assert dense.param_count() == dense.active_param_count()


@pytest.mark.parametrize("kind", ["memcom_train", "lm_train", "prefill",
                                  "decode"])
def test_cell_cost_positive(kind):
    shape = _shape("train_4k" if "train" in kind else "decode_32k")
    cc = costs.cell_cost(get_config("jamba-1.5-large-398b"), shape, kind)
    assert cc.flops > 0 and cc.hbm_bytes > 0 and cc.model_flops > 0


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-medium"])
def test_prefill_flops_against_torchs_counter(arch):
    """``prefill_cost``'s FLOPs against ``FlopCounterMode`` over the port's
    plain CPU prefill (``build_prefill_step``; whisper with its frames, so
    the encoder runs) at batch 2 x 64 tokens: measured 1.249 (gemma2-2b-
    smoke) and 1.085 (whisper-medium-smoke).  The counter sees more than
    the model counts: the plain attention forms full score matrices where
    the model counts the causal half (ctx = S / 2), and the forward
    projects every row to logits where the model counts the last row's.
    The band is 0.5-2x."""
    cfg = get_smoke_config(arch)
    model = tfm.init_params(cfg, 0, device="cpu")
    B, S = 2, 64
    rng = np.random.default_rng(0)
    batch = {"source": torch.as_tensor(rng.integers(4, cfg.vocab_size,
                                                    (B, S)))}
    if cfg.encoder is not None:
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((B, cfg.encoder.num_frames, cfg.d_model))
            * 0.1, dtype=torch.float32)
    with FlopCounterMode(display=False) as counter:
        steps.build_prefill_step(cfg, S)(model, batch)
    want = costs.prefill_cost(cfg, ShapeSpec("p", S, B, "prefill")).flops
    assert 0.5 <= counter.get_total_flops() / want <= 2.0


# -- the cell helpers of launch/steps.py ------------------------------------


def test_shape_by_name_and_cell_is_skipped_equal_the_references():
    for name in SHAPE_NAMES:
        assert steps.shape_by_name(name) == _shape(name)
        for arch in ARCHS:
            assert steps.cell_is_skipped(arch, name) \
                == jsteps.cell_is_skipped(arch, name)
            assert steps.default_objective(arch, _shape(name)) \
                == jsteps.default_objective(arch, _shape(name, JSHAPES))
    with pytest.raises(KeyError):
        steps.shape_by_name("train_8k")
    assert steps.ATTENTION_FREE == jsteps.ATTENTION_FREE
    assert steps.SUBQUADRATIC == jsteps.SUBQUADRATIC


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references(arch):
    """Every shape's default objective and every objective the reference
    takes: the same keys, shapes and dtypes (whisper-medium's frames
    (B, 1500, 1024) in bf16 on its train and compress / prefill cells)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for name in SHAPE_NAMES:
        for obj in (None, "memcom_train", "lm_train", "compress", "prefill",
                    "decode", "decode_compressed", "nonsense"):
            got, got_err = _run(lambda: steps.input_specs(arch, name, obj))
            want, want_err = _run(lambda: jsteps.input_specs(arch, name, mesh,
                                                             obj))
            assert got_err is want_err, (name, obj)
            if want_err is not None:
                continue
            assert set(got) == set(want)
            for k, w in want.items():
                assert tuple(got[k].shape) == tuple(w.shape), (name, obj, k)
                assert str(got[k].dtype).removeprefix("torch.") \
                    == str(w.dtype), (name, obj, k)
            if arch == "whisper-medium" and (obj or "").endswith(
                    ("train", "compress", "prefill")):
                B = _shape(name).global_batch
                assert got["frames"] == steps.TensorSpec(
                    (B, 1500, 1024), torch.bfloat16)
