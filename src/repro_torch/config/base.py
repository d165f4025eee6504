"""Model / technique configuration dataclasses (the port's own copy of
``repro/config/base.py``; the port imports nothing of ``repro``).

Every architecture in ``repro/configs`` instantiates a :class:`ModelConfig`.
The layer stack is described explicitly by a :class:`LayerLayout` —
an irregular ``prefix`` (unrolled) followed by a ``period`` of layer
descriptors scanned ``repeats`` times.  This keeps HLO size O(period)
regardless of depth and is how hybrid patterns (Jamba's 1-attn-per-8 with
MoE every other layer) are expressed without per-layer Python loops.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Layer descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerDesc:
    """One transformer block: a sequence mixer + a channel MLP."""

    mixer: str = "attn"  # "attn" | "mla" | "mamba"
    mlp: str = "dense"  # "dense" | "moe"
    cross_attn: bool = False  # enc-dec decoder blocks

    def tag(self) -> str:
        c = "+x" if self.cross_attn else ""
        return f"{self.mixer}/{self.mlp}{c}"


@dataclass(frozen=True)
class LayerLayout:
    """prefix (unrolled) + period × repeats (scanned)."""

    period: Tuple[LayerDesc, ...]
    repeats: int
    prefix: Tuple[LayerDesc, ...] = ()

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.period) * self.repeats

    def descriptors(self) -> Tuple[LayerDesc, ...]:
        return self.prefix + self.period * self.repeats

    @staticmethod
    def uniform(desc: LayerDesc, num_layers: int) -> "LayerLayout":
        return LayerLayout(period=(desc,), repeats=num_layers)


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0  # d_ff of the shared expert(s); defaults to expert_d_ff
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"
    # Dispatch locality: tokens are argsorted/capacitied within G
    # independent groups instead of one global sort.  With G = number of
    # data shards the whole dispatch (sort, cumsum, scatter) carries a
    # leading sharded group axis — no cross-shard gathers.  G=1 is the
    # single-group (global-sort) baseline; the launcher sets G to the
    # data-shard count (see EXPERIMENTS.md §Perf hillclimb 1).
    dispatch_groups: int = 1

    def shared_ff(self) -> int:
        return self.shared_d_ff or self.expert_d_ff


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder operating on precomputed frame embeddings
    (the conv frontend is a stub per the assignment)."""

    num_layers: int = 24
    num_frames: int = 1500
    num_heads: int = 16
    d_ff: int = 4096


@dataclass(frozen=True)
class MemComConfig:
    """The paper's technique, as a first-class model feature."""

    num_memory_tokens: int = 512
    xattn_kind: str = "1head"  # "1head" | "mha" | "mqa"
    xattn_heads: int = 1  # used when kind != 1head
    # Hybrid archs: attention layers get MemCom xattn; mamba layers hand
    # off the exact post-source SSM state (beyond-paper adaptation).
    ssm_state_handoff: bool = True


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    layout: LayerLayout
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    memcom: Optional[MemComConfig] = None

    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()  # Qwen2-VL M-RoPE (t, h, w)
    pos_embed: str = "rope"  # "rope" | "learned" | "none"
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"  # "swiglu" | "gelu_mlp" | "geglu"
    attn_qkv_bias: bool = False
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    embed_scale: bool = False  # gemma: h *= sqrt(d_model)
    tie_embeddings: bool = True
    max_seq: int = 8192
    dtype: str = "bfloat16"
    source: str = ""  # provenance note [source; verified-tier]

    # ---- derived -----------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return self.layout.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), used for
        MODEL_FLOPS = 6*N*D roofline accounting."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for desc in self.layout.descriptors():
            n += self._mixer_params(desc) + self._mlp_params(desc)
            n += (2 if desc.mlp != "none" else 1) * self.d_model  # norms
        n += self.d_model  # final norm
        if self.encoder is not None:
            e = self.encoder
            per = 4 * self.d_model * self.d_model + 2 * self.d_model * e.d_ff + 2 * self.d_model
            n += e.num_layers * per + self.d_model
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for desc in self.layout.descriptors():
            n += self._mixer_params(desc)
            if desc.mlp == "moe":
                m = self.moe
                per_expert = 3 * self.d_model * m.expert_d_ff
                n += m.top_k * per_expert + m.num_shared_experts * 3 * self.d_model * m.shared_ff()
                n += self.d_model * m.num_experts  # router
            else:
                n += self._mlp_params(desc)
            n += 2 * self.d_model
        n += self.d_model
        return n

    def _mixer_params(self, desc: LayerDesc) -> int:
        d = self.d_model
        if desc.mixer == "attn":
            n = d * self.num_heads * self.hd  # q
            n += 2 * d * self.num_kv_heads * self.hd  # k, v
            n += self.num_heads * self.hd * d  # o
            if desc.cross_attn:
                n *= 2
            return n
        if desc.mixer == "mla":
            m = self.mla
            n = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * m.qk_head_dim
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.num_heads * m.v_head_dim * d
            return n
        if desc.mixer == "mamba":
            mb = self.mamba
            di, ns, hd = mb.d_inner(d), mb.d_state, mb.headdim
            nh, ng = mb.nheads(d), mb.ngroups
            n = d * (2 * di + 2 * ng * ns + nh)  # in_proj (z, x, B, C, dt)
            n += mb.conv_width * (di + 2 * ng * ns)  # conv
            n += nh * 2 + di  # A_log, dt_bias? (nh each) + D (di? per-head) -> keep nh*3
            n += di * d  # out_proj
            return n
        raise ValueError(desc.mixer)

    def _mlp_params(self, desc: LayerDesc) -> int:
        d = self.d_model
        if desc.mlp == "none":
            return 0
        if desc.mlp == "moe":
            m = self.moe
            n = m.num_experts * 3 * d * m.expert_d_ff
            n += m.num_shared_experts * 3 * d * m.shared_ff()
            n += d * m.num_experts
            return n
        if self.mlp_type == "gelu_mlp":
            return 2 * d * self.d_ff
        return 3 * d * self.d_ff  # swiglu / geglu

    # ---- validation / (de)serialization ------------------------------

    def validate(self) -> None:
        assert self.layout.num_layers > 0
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0 or self.mla is not None
        for desc in self.layout.descriptors():
            if desc.mixer == "mamba":
                assert self.mamba is not None, f"{self.name}: mamba desc needs MambaConfig"
            if desc.mixer == "mla":
                assert self.mla is not None
            if desc.mlp == "moe":
                assert self.moe is not None
        if self.mrope_sections:
            assert sum(self.mrope_sections) == self.hd // 2, (
                f"mrope sections {self.mrope_sections} must sum to head_dim/2={self.hd // 2}"
            )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Assigned input shapes (same four for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    subquadratic_only: bool = False


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode", subquadratic_only=True),
)
