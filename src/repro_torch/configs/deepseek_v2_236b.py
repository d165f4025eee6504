"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L, d_model=5120, 128 heads (MLA: qk 128 nope + 64 rope, v 128,
kv_lora_rank=512, q_lora_rank=1536), expert d_ff=1536, vocab=102400.
First layer is a dense-FFN MLA block (d_ff=12288), layers 2..60 are MoE
— expressed as layout prefix + 59-repeat period.
"""

from repro_torch.config import (LayerDesc, LayerLayout, MLAConfig,
                                MemComConfig, MoEConfig, ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        layout=LayerLayout(
            prefix=(LayerDesc("mla", "dense"),),
            period=(LayerDesc("mla", "moe"),),
            repeats=59,
        ),
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=12288,  # dense first-layer FFN
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                      num_shared_experts=2, shared_d_ff=1536),
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq=131_072,
        memcom=MemComConfig(num_memory_tokens=1024),
        source="[arXiv:2405.04434; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-smoke",
        layout=LayerLayout(
            prefix=(LayerDesc("mla", "dense"),),
            period=(LayerDesc("mla", "moe"),),
            repeats=2,
        ),
        d_model=96, num_heads=4, num_kv_heads=4, d_ff=192, vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                      num_shared_experts=2, shared_d_ff=48),
        max_seq=256, memcom=MemComConfig(num_memory_tokens=8), dtype="float32",
        source="reduced smoke",
    )
