"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152.
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 32),
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=512),
        source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="smollm-360m-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=96, num_heads=3, num_kv_heads=1, d_ff=192, vocab_size=512,
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
