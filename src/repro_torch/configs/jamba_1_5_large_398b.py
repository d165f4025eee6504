"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

72L = 9 periods of 8 (attention at in-period index 4, Mamba elsewhere —
the Jamba paper's placement), MoE every other layer (16 experts top-2,
expert d_ff = dense d_ff = 24576), d_model=8192, 64 heads (GQA kv=8,
head_dim=128), vocab=65536.  Analytic total ≈ 398B params.

MemCom hybrid adaptation: attention layers take per-layer compressed KV;
Mamba layers hand off the source's exact SSM state.
"""

from repro_torch.config import (LayerDesc, LayerLayout, MambaConfig,
                                MemComConfig, MoEConfig, ModelConfig)

_M, _A = "mamba", "attn"


def _period():
    descs = []
    for i in range(8):
        mixer = _A if i == 4 else _M
        mlp = "moe" if i % 2 == 1 else "dense"
        descs.append(LayerDesc(mixer, mlp))
    return tuple(descs)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        layout=LayerLayout(period=_period(), repeats=9),
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        mamba=MambaConfig(d_state=128, headdim=64, expand=2, chunk_size=256),
        moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq=1_048_576,
        memcom=MemComConfig(num_memory_tokens=1024),
        source="[arXiv:2403.19887; hf]",
    )


def smoke_config() -> ModelConfig:
    period = tuple(
        LayerDesc(_A if i == 2 else _M, "moe" if i % 2 == 1 else "dense")
        for i in range(4)
    )
    return config().replace(
        name="jamba-smoke",
        layout=LayerLayout(period=period, repeats=2),
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512,
        mamba=MambaConfig(d_state=16, headdim=16, expand=2, chunk_size=16),
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128),
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
