"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L, d_model=1536, 24 heads (GQA kv=8), expert d_ff=512, vocab=49155,
MoE 40e top-8, no shared experts.  The MoE family's config of the port:
plain GQA attention plus a sort-based capacity MoE in every layer, so
MemCom compress → compressed-cache serving runs through the attention
kernels and the grouped matmul ``gmm``.
"""

from repro_torch.config import (LayerDesc, LayerLayout, MemComConfig,
                                MoEConfig, ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        layout=LayerLayout.uniform(LayerDesc("attn", "moe"), 32),
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=512),
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="granite-moe-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "moe"), 3),
        d_model=96, num_heads=6, num_kv_heads=2, d_ff=64, vocab_size=515,
        moe=MoEConfig(num_experts=5, top_k=2, expert_d_ff=64),
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
