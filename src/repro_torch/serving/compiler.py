"""Online prefix compiler: many-shot compression inside the serving loop
(``repro/serving/compiler.py``).

A :class:`~repro_torch.serving.scheduler.Request` may carry its raw shot
tokens (``raw_shots``); the engine compiles an unseen task *on the
serving path* —

    raw shots ──compress_chunk×N──▶ prefix O^i ──materialize_prefix──▶
    PrefixStore / PagedPrefixStore ──▶ waiting requests wake

— in chunks of at most ``compile_token_budget`` source tokens between
decode steps, so seated slots keep emitting tokens while a cold task
compiles (``None`` compiles a whole task in one chunk: decode stalls
for it).

Jobs are keyed by prefix name, single-flight: requests naming one task
(or carrying byte-identical shots, which hash to one auto name) share one
compilation.  A mid-flight job runs to completion first, so one source
cache lives at a time; among queued jobs the best ``(priority, submission
order)`` starts next.

The compiler owns no engine state.  The engine drives it (``step``),
installs finished prefixes into its store and wakes the parked requests.
Each chunk is an eager call of :func:`~repro_torch.core.memcom.
compress_chunk` on a source cache of exactly the task's length: the JAX
compiler's per-geometry program caches and power-of-two cache lengths
exist to bound jit compilations, which eager PyTorch does not have.
:meth:`PrefixCompiler.chunk_body` is that chunk's computation without the
bookkeeping: the engine's fused step runs it in its own window
(:meth:`peek_chunk`, the chunk, :meth:`absorb_chunk`), and :meth:`step`
runs it between decode steps.  Either way a chunk writes its K/V and makes
one causal flash call over the cached keys, so the online O^i are the
offline compress's bit for bit on the card.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import memcom
from repro_torch.models.transformer import Transformer
from repro_torch.serving.prefix_store import materialize_prefix


def pow2_bucket(n: int, floor: int) -> int:
    """``n`` snapped up to a power of two, at least ``floor`` (the engine's
    prefill widths)."""
    return max(floor, 1 << (max(1, n) - 1).bit_length())


@dataclass
class CompileJob:
    """One task's compilation: raw shot tokens → materialized prefix.

    ``status``: ``queued`` (no chunk run yet) → ``compiling`` (source
    cache live, ``consumed`` of ``len(tokens)`` processed) → ``compiled``
    (materialized prefix ready, not yet in the engine's store: a paged
    install can be deferred) → ``installed``."""

    name: str
    tokens: np.ndarray                         # (T,) int32 shot tokens
    status: str = "queued"
    consumed: int = 0
    state: Optional[memcom.CompressionState] = None
    materialized: Optional[list] = None        # set when status >= compiled
    widths: List[int] = field(default_factory=list)  # chunk widths run
    priority: int = 0                          # best class waiting on it
    seq: int = 0                               # submission order (FIFO ties)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError(f"job {self.name!r}: empty shot set")

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.consumed


class PrefixCompiler:
    """Compiles raw many-shot prompts into materialized prefixes, a
    token-budgeted chunk at a time, with single-flight dedup per task.
    ``step(budget)`` is the only compute entry point: the serving loop
    calls it between decode steps."""

    def __init__(self, compressor: memcom.MemCom, cfg: ModelConfig,
                 target: Transformer):
        if cfg.memcom is None:
            raise ValueError(f"{cfg.name}: ModelConfig.memcom is unset — "
                             "nothing to compile prefixes with")
        self.compressor = compressor
        self.cfg = cfg
        self.target = target
        self._jobs: "OrderedDict[str, CompileJob]" = OrderedDict()
        self._seq = itertools.count()
        self.stats: Dict[str, int] = {
            "jobs": 0,          # distinct compilations started
            "deduped": 0,       # submits that joined an in-flight job
            "chunks": 0,        # compress_chunk calls
            "tokens": 0,        # source tokens consumed
            "compiled": 0,      # jobs finished (materialized)
        }

    # ---- queue side ----

    def submit(self, name: str, raw_shots, priority: int = 0) -> CompileJob:
        """Request compilation of ``raw_shots`` under ``name``.  A second
        submit for a name whose job is not yet installed joins it (first
        writer wins on the tokens; the job takes the best class any
        joiner asked for).  Installed jobs are dropped, so a name the
        store has since evicted is compiled afresh."""
        job = self._jobs.get(name)
        if job is not None:
            self.stats["deduped"] += 1
            job.priority = min(job.priority, priority)
            return job
        job = CompileJob(name=name, tokens=raw_shots, priority=priority,
                         seq=next(self._seq))
        self._jobs[name] = job
        self.stats["jobs"] += 1
        return job

    def job(self, name: str) -> CompileJob:
        return self._jobs[name]

    def has_compile_work(self) -> bool:
        """Any job still consuming source tokens?"""
        return any(j.status in ("queued", "compiling")
                   for j in self._jobs.values())

    def ready(self) -> List[str]:
        """Names compiled but not yet installed into the engine's store."""
        return [n for n, j in self._jobs.items() if j.status == "compiled"]

    def pending(self) -> bool:
        """Anything between submission and store residency?"""
        return any(j.status != "installed" for j in self._jobs.values())

    def mark_installed(self, name: str) -> None:
        """Drop a job once its prefix is store-resident (with its tokens
        and its copy of the prefix)."""
        job = self._jobs.pop(name)
        if job.status != "compiled":
            raise RuntimeError(f"job {name!r} is {job.status}, not compiled")
        job.status = "installed"
        job.materialized = None
        job.state = None

    # ---- compute side ----

    def _live_job(self) -> Optional[CompileJob]:
        job = next((j for j in self._jobs.values()
                    if j.status == "compiling"), None)
        if job is None:
            queued = [j for j in self._jobs.values() if j.status == "queued"]
            job = (min(queued, key=lambda j: (j.priority, j.seq))
                   if queued else None)
        return job

    def chunk_body(self, offset: int):
        """One chunk's computation at source offset ``offset``:
        ``(compressor, cache, tokens) -> (cache, hiddens)``, the cache
        updated in place and ``hiddens`` the chunk's per-layer H^i."""
        cfg = self.cfg

        def run(compressor, cache, tokens):
            state = memcom.compress_chunk(
                compressor, cfg,
                memcom.CompressionState(cache=cache, offset=offset), tokens)
            return state.cache, state.hiddens[0]

        return run

    def peek_chunk(self, token_budget: Optional[int] = None
                   ) -> Optional[Tuple[CompileJob, int, int, int]]:
        """The chunk the next :meth:`step` would run, ``(job, offset,
        width, cache_len)``, or None when no job has source tokens left.
        Opens the job's source cache (``begin_compress``) on first use."""
        job = self._live_job()
        if job is None:
            return None
        if job.state is None:
            job.state = memcom.begin_compress(self.cfg, 1, len(job.tokens),
                                              mc=self.compressor)
            job.status = "compiling"
        w = (job.remaining if token_budget is None
             else min(job.remaining, token_budget))
        return job, job.consumed, w, len(job.tokens)

    def chunk_tokens(self, job: CompileJob, width: int) -> torch.Tensor:
        """The (1, width) token slice the next chunk consumes."""
        return torch.as_tensor(
            job.tokens[None, job.consumed:job.consumed + width],
            dtype=torch.long, device=self.compressor.mem_tokens.device)

    def absorb_chunk(self, job: CompileJob, cache: list, hid: list,
                     width: int) -> List[str]:
        """Fold one chunk's result (:meth:`chunk_body`'s) into the job and,
        after the last source token, run the Memory-LLM and materialize
        the prefix.  Returns ``[job.name]`` if the job just compiled, else
        ``[]``."""
        job.state = replace(job.state, cache=cache,
                            offset=job.consumed + width,
                            hiddens=job.state.hiddens + [hid])
        job.consumed += width
        job.widths.append(width)
        self.stats["chunks"] += 1
        self.stats["tokens"] += width
        if job.remaining:
            return []
        prefix, _ = memcom.finish_compress(self.compressor, self.cfg,
                                           job.state)
        job.materialized = materialize_prefix(self.target, self.cfg, prefix)
        job.state = None  # free the source cache
        job.status = "compiled"
        self.stats["compiled"] += 1
        return [job.name]

    def step(self, token_budget: Optional[int] = None) -> List[str]:
        """Advance compilation by up to ``token_budget`` source tokens
        (``None``: the head job's remaining tokens in one chunk).
        Returns the names that finished this call."""
        finished: List[str] = []
        budget = token_budget
        while budget is None or budget > 0:
            nxt = self.peek_chunk(budget)
            if nxt is None:
                break
            job, offset, w, _ = nxt
            cache, hid = self.chunk_body(offset)(
                self.compressor, job.state.cache, self.chunk_tokens(job, w))
            finished += self.absorb_chunk(job, cache, hid, w)
            if budget is not None:
                budget -= w
            elif finished:
                break  # None = one whole job, not the whole queue
        return finished
