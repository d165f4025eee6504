"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L backbone, d_model=1536, 12 heads (GQA kv=2), head_dim=128,
d_ff=8960, vocab=151936, qkv bias, M-RoPE sections (t,h,w)=(16,24,24).
The vision frontend is the assignment's stub: ``input_specs`` provides
precomputed patch embeddings merged into the token stream, with 3-D
position ids.
"""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 28),
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        mrope_sections=(16, 24, 24),
        attn_qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        max_seq=40_960,
        memcom=MemComConfig(num_memory_tokens=512),
        source="[arXiv:2409.12191; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen2-vl-smoke",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 3),
        d_model=96, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=192,
        vocab_size=512, mrope_sections=(4, 6, 6),
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
