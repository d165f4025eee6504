"""The tiny target that ``benchmarks/`` pretrains and commits under
``artifacts/bench/target/`` (``benchmarks/common.py``'s ``VOCAB`` and
``target_config``, ``TASKS``): 4 dense layers of width 128, float32, on a
synthetic vocabulary of 64 keys, 64 labels and 256 words.  Not in ``ARCH_IDS``: no
launcher builds it from seeds; :func:`repro_torch.bridge.load_params`
loads its trained weights."""

from repro_torch.config import LayerDesc, LayerLayout, MemComConfig, ModelConfig
from repro_torch.data.icl_tasks import ICLTaskSpec
from repro_torch.data.synthetic import SyntheticVocab

VOCAB = SyntheticVocab(num_keys=64, num_labels=64, num_words=256)
CHECKPOINT = "artifacts/bench/target"  # relative to the repository root
SOURCE_LEN = 96  # the many-shot budget the target was trained on
# the evaluation suite: label-set sizes scaled from the paper's Table 1
TASKS = {
    "trec-coarse-like": ICLTaskSpec(VOCAB, num_labels=6, keys_per_label=8),
    "hwu64-like": ICLTaskSpec(VOCAB, num_labels=16, keys_per_label=4),
    "banking77-like": ICLTaskSpec(VOCAB, num_labels=32, keys_per_label=2),
}


def config(m_tokens: int = 32) -> ModelConfig:
    return ModelConfig(
        name="bench-target",
        family="dense",
        layout=LayerLayout.uniform(LayerDesc("attn", "dense"), 4),
        d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=VOCAB.size, max_seq=512, dtype="float32",
        memcom=MemComConfig(num_memory_tokens=m_tokens),
        source="tiny-scale reproduction target",
    )
