"""whisper-medium [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified].

24 decoder layers (cross-attending to a 24-layer encoder over 1500
precomputed frame embeddings — the conv frontend is the assignment's
modality stub), d_model=1024, 16 heads (kv=16), d_ff=4096, vocab=51865.
Whisper uses learned absolute decoder positions and LayerNorm+GELU MLPs.
MemCom applies to the decoder's many-shot prefix (DESIGN.md §4).
"""

from repro_torch.config import (
    EncoderConfig, LayerDesc, LayerLayout, MemComConfig, ModelConfig,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense", cross_attn=True), 24),
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        encoder=EncoderConfig(num_layers=24, num_frames=1500, num_heads=16,
                              d_ff=4096),
        pos_embed="learned",
        norm_type="layernorm",
        mlp_type="gelu_mlp",
        tie_embeddings=True,
        max_seq=40_960,  # covers decode_32k; long_500k skipped (full attention)
        memcom=MemComConfig(num_memory_tokens=512),
        source="[arXiv:2212.04356; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke",
        family="audio",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense", cross_attn=True), 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        encoder=EncoderConfig(num_layers=2, num_frames=24, num_heads=4, d_ff=128),
        pos_embed="learned",
        norm_type="layernorm",
        mlp_type="gelu_mlp",
        tie_embeddings=True,
        max_seq=256,
        memcom=MemComConfig(num_memory_tokens=8),
        dtype="float32",
        source="reduced smoke",
    )
