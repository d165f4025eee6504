"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L, d_model=576, 9 heads (GQA kv=3), d_ff=1536, vocab=49152.
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 30),
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=512),
        source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="smollm-135m-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=96, num_heads=3, num_kv_heads=3, d_ff=192, vocab_size=512,
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
