"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L, d_model=5120, 32 heads (GQA kv=8), head_dim=128 (model card),
d_ff=14336, vocab=131072, rope theta=1e6.
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 40),
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        max_seq=131_072,
        memcom=MemComConfig(num_memory_tokens=1024),
        source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="mistral-nemo-12b-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=128, num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256,
        vocab_size=512, max_seq=256,
        memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
