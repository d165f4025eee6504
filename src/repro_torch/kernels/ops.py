"""Public kernel entry points with backend dispatch (``repro/kernels/ops.py``).

Two implementations per op:

* ``torch`` — the plain PyTorch versions in :mod:`.plain`;
* ``cuda``  — the hand-written Hopper kernels (:mod:`.flash_attention`,
  :mod:`.memcom_xattn`, :mod:`.paged_attention`, :mod:`.moe_gmm`,
  :mod:`.ssd_scan`).

The paged-KV index ops ``paged_scatter``/``paged_gather`` and the Mamba2
one-token update ``ssd_decode_step`` are plain torch operations on every
device (they have no kernel).

``impl="auto"`` (the default) sends a CPU tensor to the plain version and a
CUDA tensor to the kernel, always — there is no "small problem → dense"
route, which would hide the kernel at decode shapes (nor the JAX ``ssd``'s
route of S <= 64 to the sequential oracle, which would hide it at short
prompts).
``set_default_impl("torch")`` forces the plain versions everywhere (the
kernel-vs-plain comparisons on the card use it).

Gradients: a CPU call (or a forced plain one) is differentiated by the
plain versions' own autograd; a CUDA call to ``attention`` (and the calls
built on it) or ``memcom_xattn`` whose inputs need a gradient goes
through the wrapper's ``autograd.Function``, whose backward is a
hand-written kernel (``flash_attention_bwd``, ``memcom_xattn_bwd``) with
no fallback.  With no gradient needed the CUDA call is the kernel call
alone, as serving makes it.  The paged, MoE and SSD kernels have no
backward yet: a CUDA call to ``gmm`` or ``ssd`` made with gradients
enabled where an input requires grad raises ``NotImplementedError``
rather than return an output without a ``grad_fn`` (serving and
compression run them under ``torch.no_grad``); a CPU call still goes to
the plain version and its autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import memcom_xattn as _mx
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import plain
from repro_torch.kernels import ssd_scan as _ssd

_FORCED_IMPL: Optional[str] = None


def set_default_impl(impl: Optional[str]) -> None:
    """Force an implementation globally ("torch" | "cuda"; None = auto)."""
    global _FORCED_IMPL
    if impl not in (None, "torch", "cuda"):
        raise ValueError(f"impl must be None, 'torch' or 'cuda', got {impl!r}")
    _FORCED_IMPL = impl


def _plain(impl: str, x: torch.Tensor) -> bool:
    """True when the plain version must run instead of the kernel wrapper
    (which itself takes the plain version for a CPU tensor)."""
    if impl == "auto":
        impl = _FORCED_IMPL or "auto"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "torch"


def _positions(offset, n: int, batch: int, device) -> torch.Tensor:
    pos = offset + torch.arange(n, dtype=torch.int32, device=device)
    return pos.expand(batch, n).contiguous()


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention(q, k, v, *, q_pos, kv_pos, causal=True, softcap=0.0,
              scale=None, impl="auto", return_lse=False, variant=None):
    """General position-masked GQA attention (prefix / decode / cross).
    ``variant`` goes to the flash kernel (``"unsplit"``: one KV split);
    the plain version has none."""
    kw = dict(q_pos=q_pos.to(torch.int32).contiguous(),
              kv_pos=kv_pos.to(torch.int32).contiguous(), causal=causal,
              softcap=softcap, scale=scale, return_lse=return_lse)
    if _plain(impl, q):
        return plain.attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), variant=variant, **kw)


def self_attention_causal(q, k, v, *, offset=0, softcap=0.0, scale=None,
                          impl="auto", return_lse=False):
    """Pure causal self-attention (q_pos = kv_pos = offset + arange(S))."""
    B, S = q.shape[:2]
    pos = _positions(offset, S, B, q.device)
    return attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                     softcap=softcap, scale=scale, impl=impl,
                     return_lse=return_lse)


def decode_attention(q, k, v, *, lengths, softcap=0.0, scale=None,
                     impl="auto"):
    """Per-slot length-aware decode attention (continuous batching).

    ``q`` (B, S, Hq, D) holds each slot's last S tokens; ``k``/``v``
    (B, L, Hkv, D) are the full fixed-size caches; ``lengths`` (B,) int is
    each slot's total valid length *including* the S new tokens.  Slot
    ``b`` attends causally within cache positions ``[0, lengths[b])``."""
    B, S = q.shape[:2]
    L = k.shape[1]
    kv_pos = _positions(0, L, B, q.device)
    q_pos = (lengths.to(torch.int32)[:, None] - S
             + torch.arange(S, dtype=torch.int32, device=q.device)[None, :])
    return attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                     softcap=softcap, scale=scale, impl=impl)


def attention_with_prefix(q, k_self, v_self, k_pre, v_pre, *, pre_pos=None,
                          offset=None, softcap=0.0, scale=None, impl="auto"):
    """Causal self-attention plus a fully-visible KV prefix (MemCom
    memory), as two partials merged exactly through their log-sum-exp.
    ``offset`` defaults to the prefix length."""
    B, S = q.shape[:2]
    m = k_pre.shape[1]
    if offset is None:
        offset = m
    if pre_pos is None:
        pre_pos = _positions(0, m, B, q.device)
    o_self, l_self = self_attention_causal(
        q, k_self, v_self, offset=offset, softcap=softcap, scale=scale,
        impl=impl, return_lse=True)
    q_pos = _positions(offset, S, B, q.device)
    o_pre, l_pre = attention(
        q, k_pre, v_pre, q_pos=q_pos, kv_pos=pre_pos, causal=False,
        softcap=softcap, scale=scale, impl=impl, return_lse=True)
    return plain.combine_attention_partials([(o_self, l_self),
                                             (o_pre, l_pre)])


# ---------------------------------------------------------------------------
# Paged KV cache (block pool + per-slot block tables)
# ---------------------------------------------------------------------------

paged_scatter = plain.paged_scatter
paged_gather = plain.paged_gather


def paged_decode_attention(q, k_pool, v_pool, *, block_tables, lengths,
                           softcap=0.0, scale=None, impl="auto"):
    """Per-slot decode attention over a paged KV cache: ``q`` (B, S, Hq,
    D) holds each slot's last S tokens, ``k_pool``/``v_pool`` (N, bs, Hkv,
    D) are the shared pools, ``block_tables`` (B, nb) maps slot ``b``'s
    logical block ``j`` to a pool block and ``lengths`` (B,) is each
    slot's valid length *including* the S new tokens.  The semantics of
    :func:`decode_attention` on each slot's materialized view, but a
    prefix block shared by several slots is stored (and read) once."""
    fn = (plain.paged_decode_attention_ref if _plain(impl, q)
          else _pa.paged_flash_decode)
    return fn(q.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
              block_tables=block_tables.to(torch.int32).contiguous(),
              lengths=lengths.to(torch.int32).contiguous(), softcap=softcap,
              scale=scale)


# ---------------------------------------------------------------------------
# MemCom layer-wise cross-attention (the paper's compressor hot spot)
# ---------------------------------------------------------------------------


def memcom_xattn(q, k, v, *, scale=None, impl="auto"):
    """1-head cross-attention, head width = d_model: (B,M,D)x(B,T,D)->(B,M,D)."""
    fn = plain.memcom_xattn_ref if _plain(impl, q) else _mx.memcom_xattn
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)


# ---------------------------------------------------------------------------
# Grouped matmul (MoE expert compute)
# ---------------------------------------------------------------------------


def gmm(x, w, *, impl="auto"):
    """(E,C,D) x (E,D,F) -> (E,C,F) per-expert matmul.  Unlike the JAX
    dispatcher, a small problem (decode's C = 8) still goes to a kernel
    on the card: ``moe_gmm.variant_for`` sends few rows to the rows
    kernel (F fills the MMA rows) and the prefill's and the Memory-LLM's
    rows to the wgmma kernel."""
    fn = plain.gmm_ref if _plain(impl, x) else _gmm.gmm
    return fn(x.contiguous(), w.contiguous())


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def ssd(x, dt, A, Bm, Cm, *, init_state=None, chunk=256, impl="auto"):
    """Mamba2 SSD chunked scan: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32,
    Bm/Cm (B,S,G,N), init_state (B,H,P,N) f32 or None -> (y, final state
    f32).  Every CUDA tensor goes to the kernel, a 1-token prompt too;
    ``chunk`` is the plain version's chunk length (the kernel has its own)."""
    fn = plain.ssd_ref if _plain(impl, x) else _ssd.ssd
    return fn(x.contiguous(), dt.contiguous(), A.contiguous(),
              Bm.contiguous(), Cm.contiguous(),
              init_state=(None if init_state is None
                          else init_state.contiguous()), chunk=chunk)


ssd_decode_step = plain.ssd_decode_step
