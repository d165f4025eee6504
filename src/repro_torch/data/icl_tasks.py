"""Downstream ICL tasks (the port's copy of ``repro/data/icl_tasks.py``).

A task instance is a random key→label mapping with a large label set;
prompts are built with the paper's class-balanced round-robin procedure:
iterate over labels, append one random shot of that label, repeat until
the token budget is (nearly) filled, drop the overflowing shot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.data.synthetic import SyntheticVocab


@dataclass(frozen=True)
class ICLTaskSpec:
    vocab: SyntheticVocab
    num_labels: int  # labels used by this task (<= vocab.num_labels)
    keys_per_label: int = 2
    shot_tokens: int = 4  # [SEP key ARROW label]


def make_episode(task: ICLTaskSpec, rng: np.random.Generator) -> dict:
    """Sample a task instance: an injective-ish key→label mapping."""
    v = task.vocab
    n_keys = task.num_labels * task.keys_per_label
    assert n_keys <= v.num_keys, (n_keys, v.num_keys)
    keys = rng.permutation(v.num_keys)[:n_keys]
    labels = np.repeat(np.arange(task.num_labels), task.keys_per_label)
    return {"keys": keys, "labels": labels}


def build_manyshot_prompt(task: ICLTaskSpec, episode: dict,
                          rng: np.random.Generator, budget: int) -> np.ndarray:
    """Class-balanced round-robin shots within a token budget (App. A.3)."""
    v = task.vocab
    by_label = [episode["keys"][episode["labels"] == c]
                for c in range(task.num_labels)]
    toks: list[int] = []
    while True:
        added = False
        order = rng.permutation(task.num_labels)
        for c in order:
            if len(toks) + task.shot_tokens > budget:
                return np.asarray(toks, np.int32)
            k = int(rng.choice(by_label[c]))
            toks.extend([v.SEP, v.key(k), v.ARROW, v.label(c)])
            added = True
        if not added:
            return np.asarray(toks, np.int32)


def make_query(task: ICLTaskSpec, episode: dict, prompt: np.ndarray,
               rng: np.random.Generator) -> tuple[np.ndarray, int]:
    """A query over a key that appears in the *full* prompt; answer label."""
    v = task.vocab
    seen_keys = prompt.reshape(-1, task.shot_tokens)[:, 1] - v.key_base
    k = int(rng.choice(seen_keys))
    label = int(episode["labels"][np.where(episode["keys"] == k)[0][0]])
    return np.asarray([v.SEP, v.key(k), v.ARROW], np.int32), label


def eval_accuracy(predict_label: Callable[[np.ndarray, np.ndarray], int],
                  task: ICLTaskSpec, *, budget: int, n_episodes: int = 20,
                  queries_per_episode: int = 20, seed: int = 0,
                  query_budget: Optional[int] = None) -> float:
    """predict_label(context_tokens, query_tokens) -> label index.

    ``query_budget`` (when given) builds queries against the full-budget
    prompt but shows the model a context truncated to ``budget``: the
    fewer-shots baseline's protocol (a query may then be unanswerable from
    what the model sees, which is the failure it measures)."""
    rng = np.random.default_rng(seed)
    full_budget = query_budget or budget
    correct = total = 0
    for _ in range(n_episodes):
        episode = make_episode(task, rng)
        full_prompt = build_manyshot_prompt(task, episode, rng, full_budget)
        context = full_prompt[:budget] if budget < full_budget else full_prompt
        # drop a trailing partial shot
        context = context[: (len(context) // task.shot_tokens)
                          * task.shot_tokens]
        for _ in range(queries_per_episode):
            q, label = make_query(task, episode, full_prompt, rng)
            correct += int(predict_label(context, q) == label)
            total += 1
    return correct / max(total, 1)
