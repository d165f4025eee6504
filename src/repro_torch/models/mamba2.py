"""Mamba2 (SSD — state-space duality) mixer (``repro/models/mamba2.py``).

in_proj -> [z | x | B | C | dt] (widths di, di, G·N, G·N, H); a causal
depthwise conv over concat(x, B, C); the SSD scan over heads
(:func:`ops.ssd`, the Hopper kernel on the card); ``y + x·D``; a gated
RMSNorm; out_proj.  A prefill continues from the cache's conv window and
SSM state; decode is the one-token recurrent update.

Kept as the reference has them:

* ``conv_w`` is (W, conv_dim), the JAX layout, and the conv is a float32
  sum of W shifted products — not ``F.conv1d``, which would take another
  weight layout and, on the card, cuDNN's TF32 for float32 inputs.
* Types: the conv runs in float32 and is cast to x's type; ``dt =
  softplus(dt_r + dt_bias)`` in float32; ``y + x·D`` in y's type; the gated
  norm in float32.  ``A_log``, ``dt_bias`` and ``D`` stay float32 in a
  bf16 model.
* The cache ``{"conv": (B, W-1, conv_dim), "ssm": (B, H, P, N) float32}``
  is written in place (``copy_``) into the rows it was handed: the engine
  passes views of its slots and discards the returned cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.param import Init, make


def _dims(cfg: ModelConfig):
    mb = cfg.mamba
    di = mb.d_inner(cfg.d_model)
    nh = mb.nheads(cfg.d_model)
    conv_dim = di + 2 * mb.ngroups * mb.d_state
    return mb, di, nh, conv_dim


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        mb, di, nh, conv_dim = _dims(cfg)
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        make(self, "in_proj", (d, 2 * di + 2 * mb.ngroups * mb.d_state + nh),
             axes=("embed", "mamba_inner"), **kw)
        make(self, "conv_w", (mb.conv_width, conv_dim),
             Init("normal", scale=mb.conv_width ** -0.5),
             axes=(None, "mamba_inner"), **kw)
        make(self, "conv_b", (conv_dim,), Init("zeros"),
             axes=("mamba_inner",), **kw)
        make(self, "A_log", (nh,), Init("uniform"), axes=("mamba_heads",),
             **f32)
        make(self, "dt_bias", (nh,), Init("zeros"), axes=("mamba_heads",),
             **f32)
        make(self, "D", (nh,), Init("ones"), axes=("mamba_heads",), **f32)
        make(self, "norm", (di,), Init("ones"), axes=("mamba_inner",), **kw)
        make(self, "out_proj", (di, d), axes=("mamba_inner", "embed"), **kw)

    def forward(self, x, *, cache=None, decode: bool = False,
                init_state=None):
        """x (B, S, D) -> (B, S, D).  ``cache`` (or None) is updated in
        place; decode takes S == 1.  ``init_state`` (B, H, P, N) float32
        seeds the recurrence in place of the cache's state (the hybrid
        MemCom's handoff of the source context's final state)."""
        cfg = self.cfg
        mb, di, nh, _ = _dims(cfg)
        B, S, _ = x.shape
        W = mb.conv_width
        gn = mb.ngroups * mb.d_state

        z, xr, Bm_r, Cm_r, dt_r = (x @ self.in_proj).split(
            [di, di, gn, gn, nh], dim=-1)
        xbc = torch.cat([xr, Bm_r, Cm_r], dim=-1)  # (B, S, conv_dim)
        w = self.conv_w.float()
        if decode:
            window = torch.cat([cache["conv"], xbc], dim=1)  # (B, W, conv)
            conv = torch.einsum("bwc,wc->bc", window.float(), w)[:, None]
            new_conv = window[:, 1:]
        else:
            if cache is not None:
                # a chained prefill continues from the cached last W-1 raw
                # inputs (zeros on a cleared slot)
                padded = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
            else:
                padded = F.pad(xbc, (0, 0, W - 1, 0))
            conv = sum(padded[:, i:i + S].float() * w[i] for i in range(W))
            new_conv = padded[:, S:S + W - 1]  # the last W-1 raw inputs
        conv = F.silu(conv + self.conv_b.float()).to(x.dtype)

        xs, Bm, Cm = conv.split([di, gn, gn], dim=-1)
        dt = F.softplus(dt_r.float() + self.dt_bias)  # (B, S, H)
        A = -torch.exp(self.A_log)
        xh = xs.reshape(B, S, nh, mb.headdim)
        Bg = Bm.reshape(B, S, mb.ngroups, mb.d_state)
        Cg = Cm.reshape(B, S, mb.ngroups, mb.d_state)
        state0 = init_state
        if state0 is None and cache is not None:
            state0 = cache["ssm"]  # decode step or chained prefill
        if decode:
            y1, new_ssm = ops.ssd_decode_step(state0, xh[:, 0], dt[:, 0], A,
                                              Bg[:, 0], Cg[:, 0])
            y = y1[:, None]
        else:
            y, new_ssm = ops.ssd(xh, dt, A, Bg, Cg, init_state=state0,
                                 chunk=mb.chunk_size)
        y = y + xh * self.D.to(y.dtype)[None, None, :, None]
        y = _gated_norm(y.reshape(B, S, di), z, self.norm, cfg.norm_eps)
        if cache is not None and torch.is_grad_enabled() and (
                new_ssm.requires_grad or new_conv.requires_grad):
            # training (the hybrid compressor's Phase 2): the handed-off
            # state is a node of the graph, not written over a tensor that
            # this pass read
            cache["conv"] = new_conv.to(cache["conv"].dtype)
            cache["ssm"] = new_ssm.to(cache["ssm"].dtype)
        elif cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(new_ssm)
        return y @ self.out_proj


def _gated_norm(y, z, scale, eps):
    g = y.float() * F.silu(z.float())
    out = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(y.dtype)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Per-slot recurrent state: the conv window in the model's type and
    the SSM state in float32."""
    mb, _, nh, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((batch, mb.conv_width - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, nh, mb.headdim, mb.d_state),
                               dtype=torch.float32, device=device)}
