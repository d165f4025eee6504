from repro_torch.data.pipeline import Prefetcher, host_slice
from repro_torch.data.synthetic import PretrainStream, SyntheticVocab
from repro_torch.data.icl_tasks import (ICLTaskSpec, build_manyshot_prompt,
                                        eval_accuracy, make_episode,
                                        make_query)

__all__ = [
    "SyntheticVocab",
    "PretrainStream",
    "Prefetcher",
    "host_slice",
    "ICLTaskSpec",
    "make_episode",
    "build_manyshot_prompt",
    "make_query",
    "eval_accuracy",
]
