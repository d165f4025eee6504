"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified].

24L, d_model=2048, 32 heads (MHA: kv=32), d_ff=5632, vocab=100352.
StableLM-2 uses LayerNorm; its 25%-partial rotary embedding is simplified
to full RoPE here (noted deviation; unverified-tier source).
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 24),
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        norm_type="layernorm",
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=512),
        source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="stablelm-1.6b-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=128, num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
