"""gemma2-2b — the paper's smaller target model [arXiv:2408.00118].

26L, d_model=2304, 8 heads (GQA kv=4, head_dim=256), d_ff=9216 (GeGLU),
vocab=256128, attn/final logit softcaps 50/30, embeddings scaled by
sqrt(d).  (Alternating sliding-window attention simplified to global —
noted deviation.)  Paper setting: 3k-token many-shots,
m ∈ {1024, 512, 384}.
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 26),
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256128,
        mlp_type="geglu",
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        embed_scale=True,
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=512),
        source="[arXiv:2408.00118; hf] (paper's model)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="gemma2-2b-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=96, num_heads=4, num_kv_heads=2, head_dim=24, d_ff=192,
        vocab_size=512, max_seq=256,
        memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
