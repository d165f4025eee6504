"""Production-traffic workload model: Zipf catalogs, timed arrivals, SLOs
(the port's own copy of ``repro/serving/traffic.py``).

The serving value of compressed many-shot prefixes only shows up under
*load* — hundreds of ICL tasks contending for ``prefix_capacity`` and
``host_capacity`` so the online compiler and the tier hierarchy actually
churn.  This module builds that load deterministically:

* **catalog** — ``num_tasks`` synthetic many-shot ICL tasks (the same
  ``repro_torch/data/icl_tasks.py`` construction the eval path uses), each rendered
  to a raw shot-token context.  Requests carry these as ``raw_shots``,
  so a task's first request triggers an online compile and later
  requests dedup onto the stored prefix (or its cold-tier copy).
* **popularity** — task picks are Zipf(``zipf_alpha``) distributed: a
  hot head that stays HBM-resident and a long tail that churns through
  the demote/spill/promote path.
* **arrivals** — Poisson (``process="poisson"``) or bursty ON-OFF
  (``process="onoff"``: exponential ON/OFF phases, arrivals only while
  ON) at ``rate_rps``; each request gets an ``arrival_s`` offset the
  engine replays against its injected clock.
* **SLO metrics** — :func:`slo_metrics` reduces the engine's
  ``request_log`` to TTFT p50/p99, end-to-end latency percentiles,
  goodput (requests/s that met the TTFT SLO), decode-gap p99, and
  tokens/s/device.

Everything is a pure function of ``(config, seed)``: two calls with the
same arguments produce byte-identical traces, and under a
:class:`~repro_torch.serving.clock.VirtualClock` the whole simulation —
arrivals, preemptions, metrics — is reproducible.
Requests are greedy (temperature 0) so per-request token output is
independent of request uids and admission interleaving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.icl_tasks import (ICLTaskSpec, build_manyshot_prompt,
                                        make_episode, make_query)
from repro_torch.data.synthetic import SyntheticVocab
from repro_torch.serving.scheduler import Request
from repro_torch.serving.telemetry import Histogram

__all__ = ["TrafficConfig", "Trace", "generate_trace", "make_catalog",
           "zipf_weights", "slo_metrics"]


@dataclass(frozen=True)
class TrafficConfig:
    """Knobs of one traffic scenario (all drawing is seeded elsewhere)."""

    num_tasks: int = 32            # catalog size (≫ capacity ⇒ churn)
    zipf_alpha: float = 1.1        # popularity skew (larger = hotter head)
    context_tokens: int = 48       # raw many-shot context budget per task
    num_requests: int = 64
    process: str = "poisson"       # "poisson" | "onoff"
    rate_rps: float = 200.0        # arrival rate (while ON, for onoff)
    on_mean_s: float = 0.05        # onoff: mean burst duration
    off_mean_s: float = 0.05       # onoff: mean silence duration
    prompt_len: Tuple[int, int] = (3, 8)   # per-request query length range
    max_new: Tuple[int, int] = (2, 5)      # per-request decode budget range
    priority_classes: int = 1
    # class draw weights (defaults to uniform); index = class
    priority_weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.process not in ("poisson", "onoff"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.num_tasks < 1 or self.num_requests < 1:
            raise ValueError("need at least one task and one request")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be positive")
        if self.zipf_alpha <= 0:
            raise ValueError("zipf_alpha must be positive")
        if self.context_tokens < 4:
            raise ValueError("context_tokens must hold at least one shot (4)")
        if self.priority_classes < 1:
            raise ValueError("priority_classes must be >= 1")
        if self.priority_weights is not None and \
                len(self.priority_weights) != self.priority_classes:
            raise ValueError("priority_weights length must equal "
                             "priority_classes")


@dataclass
class Trace:
    """One generated scenario: the task catalog plus the timed requests.

    ``task_ids[i]`` is the catalog index request ``requests[i]`` draws
    its ``raw_shots`` from — tests use it to replay single requests
    offline and to check the popularity skew."""

    catalog: List[np.ndarray]
    requests: List[Request]
    task_ids: List[int]


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """P(task k) ∝ (k+1)^-alpha, normalized — rank 0 is the hot head."""
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-float(alpha))
    return w / w.sum()


def make_catalog(cfg: TrafficConfig, vocab: SyntheticVocab,
                 rng: np.random.Generator) -> List[np.ndarray]:
    """``num_tasks`` distinct many-shot contexts.  Distinct *bytes*
    matter: the content-addressed prefix names must not collide, or two
    catalog entries would silently share one compiled prefix."""
    task = ICLTaskSpec(vocab, num_labels=min(8, vocab.num_labels),
                       keys_per_label=2)
    catalog: List[np.ndarray] = []
    seen = set()
    while len(catalog) < cfg.num_tasks:
        episode = make_episode(task, rng)
        shots = build_manyshot_prompt(task, episode, rng, cfg.context_tokens)
        key = shots.tobytes()
        if key in seen:
            continue  # resample (vanishingly rare for real budgets)
        seen.add(key)
        catalog.append(shots)
    return catalog


def _arrival_times(cfg: TrafficConfig,
                   rng: np.random.Generator) -> List[float]:
    """Arrival offsets in seconds.  Poisson: exponential inter-arrival
    gaps.  ON-OFF: the same gaps, but the process only accumulates them
    while an exponential ON phase lasts; crossing into an OFF phase
    inserts an exponential silence — the bursty open-loop model."""
    times: List[float] = []
    t = 0.0
    if cfg.process == "poisson":
        for _ in range(cfg.num_requests):
            t += rng.exponential(1.0 / cfg.rate_rps)
            times.append(t)
        return times
    on_left = rng.exponential(cfg.on_mean_s)
    for _ in range(cfg.num_requests):
        gap = rng.exponential(1.0 / cfg.rate_rps)
        while gap > on_left:
            gap -= on_left
            t += on_left + rng.exponential(cfg.off_mean_s)
            on_left = rng.exponential(cfg.on_mean_s)
        t += gap
        on_left -= gap
        times.append(t)
    return times


def generate_trace(cfg: TrafficConfig, seed: int,
                   vocab: Optional[SyntheticVocab] = None) -> Trace:
    """Build the full scenario from ``(cfg, seed)`` alone — same inputs,
    byte-identical trace (arrival times, task picks, prompts, priorities,
    budgets).  Prompts are valid queries over the picked task's context
    (``make_query``), so a served answer is an actual ICL prediction."""
    vocab = vocab if vocab is not None else SyntheticVocab()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7AF1C]))
    catalog = make_catalog(cfg, vocab, rng)
    weights = zipf_weights(cfg.num_tasks, cfg.zipf_alpha)
    times = _arrival_times(cfg, rng)
    if cfg.priority_weights is not None:
        pw = np.asarray(cfg.priority_weights, np.float64)
        pw = pw / pw.sum()
    else:
        pw = np.full((cfg.priority_classes,),
                     1.0 / cfg.priority_classes)
    task = ICLTaskSpec(vocab, num_labels=min(8, vocab.num_labels),
                       keys_per_label=2)
    requests: List[Request] = []
    task_ids: List[int] = []
    lo_p, hi_p = cfg.prompt_len
    lo_n, hi_n = cfg.max_new
    for t in times:
        tid = int(rng.choice(cfg.num_tasks, p=weights))
        shots = catalog[tid]
        # a real query against this task's shots, padded with extra SEP/
        # key tokens up to the drawn prompt length (ragged prompts are
        # what exercises the bucketing)
        episode = {"keys": (shots.reshape(-1, task.shot_tokens)[:, 1]
                            - vocab.key_base),
                   "labels": (shots.reshape(-1, task.shot_tokens)[:, 3]
                              - vocab.label_base)}
        query, _label = make_query(task, episode, shots, rng)
        plen = int(rng.integers(lo_p, hi_p + 1))
        if plen > len(query):
            pad = rng.integers(vocab.word_base, vocab.size,
                               size=plen - len(query))
            prompt = np.concatenate([pad.astype(np.int32), query])
        else:
            prompt = query[-plen:] if plen else query
        cls = (int(rng.choice(cfg.priority_classes, p=pw))
               if cfg.priority_classes > 1 else 0)
        requests.append(Request(
            tokens=prompt, max_new=int(rng.integers(lo_n, hi_n + 1)),
            raw_shots=shots, priority=cls, arrival_s=float(t)))
        task_ids.append(tid)
    return Trace(catalog=catalog, requests=requests, task_ids=task_ids)


def _pct(values: Sequence[float], q: float) -> float:
    """Percentile with numpy's default linear interpolation: for sorted
    x of length n, index = (n-1) * q/100, linearly interpolated between
    the straddling samples.  Kept as an explicit helper so the SLO
    arithmetic test can hand-compute expectations against the formula."""
    if len(values) == 0:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


def slo_metrics(request_log: Dict[int, dict], *, slo_ttft_s: float,
                devices: int = 1,
                gap_samples: Sequence[float] = ()) -> dict:
    """Reduce an engine ``request_log`` to the SLO scoreboard.

    * TTFT = first token time − arrival; latency = finish − arrival.
    * goodput = completed requests whose TTFT met ``slo_ttft_s``, per
      second of makespan (first arrival → last finish).
    * tokens/s/device = generated tokens over the same makespan, split
      across ``devices``.
    * decode-gap aggregates come from a registry
      :class:`~repro_torch.serving.telemetry.Histogram` over the engine's
      per-step gap samples: ``decode_gap_p50/p95/p99_s`` are
      bucket-interpolated quantiles (the estimator of a Prometheus
      ``histogram_quantile``), and ``decode_gap_hist`` carries the raw
      buckets.

    Per-class sub-scoreboards let the priority tests assert class 0's
    TTFT beats class 1's under overload.
    """
    entries = list(request_log.values())
    done = [e for e in entries if e["finish_s"] is not None]
    ttfts = [e["first_token_s"] - e["arrival_s"] for e in done]
    lats = [e["finish_s"] - e["arrival_s"] for e in done]
    if done:
        t0 = min(e["arrival_s"] for e in entries)
        t1 = max(e["finish_s"] for e in done)
        duration = max(t1 - t0, 1e-9)
    else:
        # no completions → no makespan: report zero rates rather than
        # dividing by a sentinel and emitting astronomical figures
        duration = 0.0
    tokens = sum(e["tokens"] for e in done)
    attained = sum(1 for t in ttfts if t <= slo_ttft_s)
    gap_hist = Histogram("decode_gap_seconds")
    for g in gap_samples:
        gap_hist.observe(float(g))
    out = {
        "requests": len(entries),
        "completed": len(done),
        "duration_s": float(duration),
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "latency_p50_s": _pct(lats, 50),
        "latency_p99_s": _pct(lats, 99),
        "slo_ttft_s": float(slo_ttft_s),
        "slo_attained": int(attained),
        "goodput_rps": float(attained / duration) if duration else 0.0,
        "offered_rps": float(len(entries) / duration) if duration else 0.0,
        "tokens_generated": int(tokens),
        "tokens_per_s_per_device": (
            float(tokens / duration / max(devices, 1)) if duration else 0.0),
        "decode_gap_p50_s": gap_hist.percentile(50),
        "decode_gap_p95_s": gap_hist.percentile(95),
        "decode_gap_p99_s": gap_hist.percentile(99),
        "decode_gap_hist": gap_hist.snapshot(),
        "preemptions": int(sum(e["preemptions"] for e in entries)),
    }
    classes = sorted({e["priority"] for e in entries})
    per_class = {}
    for cls in classes:
        ce = [e for e in entries if e["priority"] == cls]
        cd = [e for e in ce if e["finish_s"] is not None]
        ct = [e["first_token_s"] - e["arrival_s"] for e in cd]
        per_class[str(cls)] = {
            "requests": len(ce),
            "completed": len(cd),
            "ttft_p50_s": _pct(ct, 50),
            "ttft_p99_s": _pct(ct, 99),
            "slo_attained": int(sum(1 for t in ct if t <= slo_ttft_s)),
            "preemptions": int(sum(e["preemptions"] for e in ce)),
        }
    out["per_class"] = per_class
    return out
