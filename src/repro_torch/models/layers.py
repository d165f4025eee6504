"""Norms, positional embeddings (RoPE, Qwen2-VL's M-RoPE, Whisper's
sinusoidal encoder positions) and MLPs (``repro/models/layers.py``).

Traps the JAX originals set, kept here on purpose:

* RMSNorm multiplies by ``scale`` (initialised to ones), not ``1 + scale``.
* RoPE rotates split halves ``[x1, x2]``, not interleaved pairs.
* ``jax.nn.gelu`` is the tanh approximation, so the port uses
  ``F.gelu(approximate="tanh")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.param import Init, make
from repro_torch.sharding.serving import matmul_reduce


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, dim: int | None = None, *, device,
                 dtype):
        super().__init__()
        self.cfg = cfg
        d = dim or cfg.d_model
        make(self, "scale", (d,), Init("ones"), device=device, dtype=dtype,
             axes=("embed",))
        if cfg.norm_type == "layernorm":
            make(self, "bias", (d,), Init("zeros"), device=device,
                 dtype=dtype, axes=("embed",))

    def forward(self, x):
        return apply_norm(self, self.cfg, x)


def apply_norm(p: Norm, cfg: ModelConfig, x):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p.scale.float()
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, mrope_sections=()):
    """x (B, S, H, Dh); positions (B, S), or (3, B, S) for M-RoPE
    (Qwen2-VL): the Dh/2 frequency slots are cut into (temporal, height,
    width) sections of ``mrope_sections`` slots, and each section takes
    the angle of its own position stream.  Text tokens carry equal t, h
    and w positions, which is plain RoPE."""
    Dh = x.shape[-1]
    freqs = rope_freqs(Dh, theta, device=x.device)
    if positions.dim() == 3:
        if not mrope_sections:
            raise ValueError("3-D positions need mrope_sections")
        sec = torch.repeat_interleave(
            torch.arange(len(mrope_sections), device=x.device),
            torch.as_tensor(mrope_sections, device=x.device))
        if sec.numel() != Dh // 2:
            raise ValueError(f"mrope sections {mrope_sections} do not sum "
                             f"to head_dim / 2 = {Dh // 2}")
        # angle[b, s, f] = positions[sec(f), b, s] * freqs[f]
        angles = positions.float()[sec].permute(1, 2, 0) * freqs
    else:
        angles = positions.float()[..., None] * freqs  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_embed(num_pos: int, dim: int, device=None) -> torch.Tensor:
    """(num_pos, dim) float32: sin of pos / 10000^(2i / dim) in the first
    half, cos in the second (Whisper's encoder positions)."""
    pos = torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000 ** (2 * i / dim))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class MLP(nn.Module):
    tp = None  # this rank's ModelShard where ff splits (shard_module)

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None,
                 mlp_type: str | None = None, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.mlp_type = mlp_type or cfg.mlp_type
        d, f = cfg.d_model, d_ff or cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        if self.mlp_type == "gelu_mlp":
            make(self, "wi", (d, f), axes=("embed", "ff"), **kw)
            make(self, "bi", (f,), Init("zeros"), axes=("ff",), **kw)
            make(self, "wo", (f, d), axes=("ff", "embed"), **kw)
            make(self, "bo", (d,), Init("zeros"), axes=("embed",), **kw)
        else:  # swiglu / geglu
            make(self, "wg", (d, f), axes=("embed", "ff"), **kw)
            make(self, "wi", (d, f), axes=("embed", "ff"), **kw)
            make(self, "wo", (f, d), axes=("ff", "embed"), **kw)

    def forward(self, x):
        return apply_mlp(self, self.cfg, x, self.mlp_type)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: MLP, cfg: ModelConfig, x, mlp_type: str | None = None):
    """Under a mesh ``wg`` / ``wi`` are column slices and ``wo`` a row
    slice of ff: the product is summed over the "model" ranks, and the
    bias ``bo`` added once, after the sum."""
    t = mlp_type or cfg.mlp_type
    if t == "gelu_mlp":
        h = _gelu(x @ p.wi + p.bi)
        return matmul_reduce(h, p.wo, p.tp) + p.bo
    act = F.silu if t == "swiglu" else _gelu
    return matmul_reduce(act(x @ p.wg) * (x @ p.wi), p.wo, p.tp)


def softcap(x, cap: float):
    if cap:
        return cap * torch.tanh(x / cap)
    return x
