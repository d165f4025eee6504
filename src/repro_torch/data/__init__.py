from repro_torch.data.synthetic import SyntheticVocab
from repro_torch.data.icl_tasks import (ICLTaskSpec, build_manyshot_prompt,
                                        make_episode, make_query)

__all__ = [
    "SyntheticVocab",
    "ICLTaskSpec",
    "make_episode",
    "build_manyshot_prompt",
    "make_query",
]
