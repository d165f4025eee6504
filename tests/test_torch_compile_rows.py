"""A compress slice of any width gives the one-shot compress's rows.

On the card two things made a slice's rows differ from the one-shot's
in their last bits, which a random-weight 26-layer Source-LLM amplifies
to ~8e-2 of a row's scale (``scripts/compile_width_drift.py``): the
slice's flash call split its KV walk where the one-shot call does not,
and matmuls of fewer than 128 rows take other GEMM kernels.  So a slice's
flash call runs unsplit (``variant="unsplit"``) and, on the card, for
attention-only stacks with dense MLPs, its rows are padded to a multiple
of ``memcom.CHUNK_ROWS`` with token 0 (``_pads_chunks``).

Here, on the CPU, with the padding forced on: the padded slices give the
unpadded slices' O^i and the one-shot's (float32), the padding rows leave
no trace in the cache the next slice reads, and the slice's flash call
asks for ``"unsplit"``.  On the card (``cuda``): an unsplit slice call
gives the one-shot call's rows bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("arch,pads", [
    ("gemma2-2b", True), ("mistral-7b", True), ("smollm-135m", True),
    ("granite-moe-3b-a800m", False), ("mamba2-370m", False)])
def test_which_stacks_pad_their_slices(arch, pads):
    cfg = get_smoke_config(arch)
    assert memcom._pads_chunks(cfg, CUDA) is pads
    assert memcom._pads_chunks(cfg, CPU) is False


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("gemma2-2b")
    target = tfm.init_params(cfg, 0, device="cpu")
    mc = memcom.init_memcom(cfg, target, 1)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(4, cfg.vocab_size, (1, 70)),
                           dtype=torch.long)
    return cfg, mc, toks


def _chunked(cfg, mc, toks, widths):
    state = memcom.begin_compress(cfg, 1, toks.shape[1], mc=mc)
    lo, i = 0, 0
    while lo < toks.shape[1]:
        w = widths[min(i, len(widths) - 1)]
        state = memcom.compress_chunk(mc, cfg, state, toks[:, lo:lo + w])
        lo += w
        i += 1
    return memcom.finish_compress(mc, cfg, state)[0], state


@pytest.mark.parametrize("widths", [[1], [5], [16], [37], [32, 16, 8, 4, 2,
                                                          1, 2, 4]])
def test_padded_slices_give_the_unpadded_and_one_shot_rows(
        model, monkeypatch, widths):
    cfg, mc, toks = model
    want, _ = _chunked(cfg, mc, toks, widths)
    one_shot = memcom.compress(mc, cfg, toks)[0]
    monkeypatch.setattr(memcom, "CHUNK_ROWS", 16)
    monkeypatch.setattr(memcom, "_pads_chunks", lambda cfg, device: True)
    got, state = _chunked(cfg, mc, toks, widths)
    # room for the last slice's padding rows
    assert state.cache[0]["k"].shape[1] == toks.shape[1] + 15
    for g, w, o in zip(got, want, one_shot):
        torch.testing.assert_close(g["h"], w["h"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(g["h"], o["h"], rtol=1e-4, atol=1e-4)


def test_a_slice_asks_the_flash_kernel_for_one_walk(model, monkeypatch):
    cfg, mc, toks = model
    seen = []
    real = ops.attention

    def spy(q, k, v, **kw):
        seen.append(kw.get("variant"))
        return real(q, k, v, **kw)

    state = memcom.begin_compress(cfg, 1, toks.shape[1], mc=mc)
    monkeypatch.setattr(ops, "attention", spy)
    for lo in (0, 32, 64):
        state = memcom.compress_chunk(mc, cfg, state, toks[:, lo:lo + 32])
    assert len(seen) == 3 * cfg.num_layers and set(seen) == {"unsplit"}


@pytest.mark.cuda
@pytest.mark.parametrize("offset,w", [(0, 64), (700, 1), (700, 37),
                                      (513, 200), (960, 64)])
def test_an_unsplit_slice_call_gives_the_one_shot_rows_on_the_card(
        offset, w):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    T, Hq, Hkv, D = 1024, 8, 4, 256
    q, k, v = (torch.randn(1, T, h, D, generator=g, device="cuda")
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    full = fa.flash_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                              softcap=50.0)
    end = offset + w
    part = fa.flash_attention(
        q[:, offset:end].contiguous(), k[:, :end].contiguous(),
        v[:, :end].contiguous(), q_pos=pos[:, offset:end].contiguous(),
        kv_pos=pos[:, :end].contiguous(), causal=True, softcap=50.0,
        variant="unsplit")
    assert torch.equal(part, full[:, offset:end])
