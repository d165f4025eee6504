"""mistral-7b (v0.3) — the paper's larger target model [arXiv:2310.06825].

32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=14336,
vocab=32768 (v0.3).  Paper setting: 6k-token many-shots,
m ∈ {2048, 1024, 768}.
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 32),
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32768,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=768),
        source="[arXiv:2310.06825; hf] (paper's model)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="mistral-7b-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512, max_seq=256,
        memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
