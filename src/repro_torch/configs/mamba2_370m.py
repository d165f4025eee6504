"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L, d_model=1024, attention-free mixer-only blocks (d_ff=0),
vocab=50280, ssm_state=128, headdim=64 (d_inner=2048 → 32 heads).

MemCom is inapplicable (no KV / cross-attention target), so the config
has no ``memcom`` and serving takes the plain many-shot prompt: each slot
keeps the post-prompt conv window and SSM state, a fixed size whatever
the prompt's length.  Every prefill runs the SSD scan ``ssd``.
"""

from repro_torch.config import LayerDesc, LayerLayout, MambaConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        layout=LayerLayout.uniform(LayerDesc("mamba", "none"), 48),
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        mamba=MambaConfig(d_state=128, headdim=64, expand=2, chunk_size=256),
        pos_embed="none",
        tie_embeddings=True,
        max_seq=1_048_576,
        memcom=None,  # inapplicable — see module docstring
        source="[arXiv:2405.21060; unverified]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="mamba2-370m-smoke",
        layout=LayerLayout.uniform(LayerDesc("mamba", "none"), 3),
        d_model=64, vocab_size=512,
        mamba=MambaConfig(d_state=16, headdim=16, expand=2, chunk_size=16),
        max_seq=256, dtype="float32",
        source="reduced smoke",
    )
