"""Tiered prefix cache: HBM ↔ pinned host ↔ disk for compressed prefixes
(``repro/serving/tiers.py``).

A task's many-shots compress once into a small per-layer prefix that
every request for the task reuses; an HBM store that simply drops an
evicted prefix forces a recompile on the task's next request.
:class:`TieredPrefixStore` turns eviction into *demotion*::

    HBM (PrefixStore / PagedPrefixStore)      seat-ready device tensors
      │ evict ──▶ demote                 ▲ promote (per-layer chunks)
      ▼                                  │
    host tier (pinned CPU tensors)  ─────┘
      │ over host_capacity ──▶ spill     ▲ load (counted ``disk_loads``)
      ▼                                  │
    disk tier (one compressed shard per prefix) ──────────┘

* **Demote** — the stores' ``demote_hook`` fires on every evict: a dense
  row is copied to host; a paged entry's K/V is gathered back out of its
  pool blocks (:func:`~repro_torch.kernels.ops.paged_gather`) *before*
  the store releases them.  The device→host copies go into pinned memory
  without blocking and the hook waits on one event after the last, so
  the host never reads a row still in flight and a later prefill that
  reuses the released blocks is ordered after the gather on the stream.
  A prefix seated in a live slot still raises ``PrefixSeatedError``.
* **Spill** — past ``host_capacity`` the LRU host row is written to
  ``disk_dir`` as one shard in the JAX package's format (magic ``MCPF``,
  version 1, a little-endian u32 header length, a msgpack header with
  ``name`` / ``codec`` / ``base_len`` / ``structure`` / ``entries``, then
  one blob compressed by :func:`~repro_torch.checkpoint.store.
  compress_bytes`; leaves at ``prefix/<i>/<key>`` and, stacked over the
  repeats, ``period/l<j>/<key>``; bfloat16 as ``"bfloat16"``), so a shard
  written by either package is read by the other.  Shards are committed
  by an atomic rename and indexed on start-up (:meth:`_scan_disk`).
* **Promote** — a request naming a cold prefix parks while the engine
  copies the row host→device one layer per chunk, at most
  ``promote_layer_budget`` chunks between decode steps.  Each chunk is a
  ``non_blocking`` copy from pinned memory, which PyTorch's pinned-memory
  allocator keeps alive until the copy is done; the job holds the host
  row until its install as well.

Tiers are exclusive (a name lives in one) and moves are bit-exact: the
row that comes back up is byte-identical to the one that went down.  The
class fronts the HBM store: residency checks and the seat-path lookups
delegate to it.

Under a mesh each rank fronts its own store: its rows are its slices (K/V
of its heads, O^i whole), demoted to its own host tier and spilled under
its own directory (the engine passes ``disk_dir/rank<r>``: two ranks
would otherwise write one file), so a promoted leaf lands as the rank's
slice directly, with no gather and no second copy.  The byte counter
``promote_bytes`` counts the rank's bytes, not the whole row's; the
other counters (entries, chunks, promotions) are the same on every rank.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import struct
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.store import (_leaf_bytes, _leaf_tensor,
                                          compress_bytes, decompress_bytes,
                                          packb, unpackb)
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.serving.prefix_store import (KV_KEYS, PagedPrefixStore,
                                              _row_base_len)

__all__ = ["TieredPrefixStore", "PromotionJob"]

_SHARD_SUFFIX = ".prefix"
_MAGIC = b"MCPF"  # MemCom prefix shard
_VERSION = 1


def _row_nbytes(entry: dict) -> int:
    return sum(x.numel() * x.element_size() for x in entry.values())


@dataclass
class PromotionJob:
    """One prefix's host→device copy: ``pending`` holds (layer, host
    entry) chunks, drained up to ``promote_layer_budget`` between decode
    steps; when the last lands the device row is assembled and the job
    turns ``ready`` for the engine to install."""

    name: str
    source: str                       # "host" | "disk"
    host_row: list                    # the full host row
    base_len: int
    pending: deque = field(default_factory=deque)
    dev: Dict[int, dict] = field(default_factory=dict)
    status: str = "promoting"         # -> "ready" (installed jobs are dropped)
    row: Optional[list] = None        # assembled device row when ready
    total_chunks: int = 0
    priority: int = 0                 # best class waiting on it
    seq: int = 0                      # submission order (FIFO ties)

    @property
    def remaining(self) -> int:
        return len(self.pending)


class TieredPrefixStore:
    """HBM store front with pinned-host and disk tiers behind it.

    Wraps a :class:`~repro_torch.serving.prefix_store.PrefixStore` or
    :class:`~repro_torch.serving.prefix_store.PagedPrefixStore` (``hbm``)
    on ``device``.  ``host_capacity`` bounds the host tier (``None``:
    unbounded; ``0``: demotions go straight to disk); past it the LRU host
    row spills to ``disk_dir`` or, with no disk tier, is dropped
    (counted).  ``cache_ref()`` returns the engine's cache, which a paged
    demotion reads."""

    def __init__(self, hbm, *, host_capacity: Optional[int] = None,
                 disk_dir: Optional[str] = None, cache_ref=None,
                 device=None):
        if host_capacity is not None and host_capacity < 0:
            raise ValueError("host_capacity must be >= 0 (or None)")
        self.hbm = hbm
        self.cfg: ModelConfig = hbm.cfg
        self.host_capacity = host_capacity
        self.disk_dir = disk_dir
        self.device = torch.device(device if device is not None else "cpu")
        self._cache_ref = cache_ref
        self._host: "OrderedDict[str, list]" = OrderedDict()
        self._host_base: Dict[str, int] = {}
        self._disk: Dict[str, str] = {}       # name -> shard path
        self._disk_base: Dict[str, int] = {}
        self._jobs: "OrderedDict[str, PromotionJob]" = OrderedDict()
        self._job_seq = itertools.count()
        self.tier_stats: Dict[str, int] = {
            "hbm_hits": 0,        # serve-path lookups answered from HBM
            "host_promotes": 0,   # completed promotions
            "disk_loads": 0,      # shards read (disk→promotion path)
            "demotes": 0,         # HBM evictions captured into the host tier
            "spills": 0,          # host rows written to disk
            "promote_bytes": 0,   # bytes copied host→device
            "promote_chunks": 0,  # per-layer chunks copied host→device
            "host_drops": 0,      # host-pressure casualties with no disk tier
        }
        hbm.demote_hook = self._demote
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            self._scan_disk()

    # ------------------------------------------------------------------
    # HBM front (the engine's store API)
    # ------------------------------------------------------------------

    def __getattr__(self, attr):
        # everything not overridden behaves as the HBM store
        if attr == "hbm":  # never recurse before __init__ ran
            raise AttributeError(attr)
        return getattr(self.hbm, attr)

    def __contains__(self, name) -> bool:
        return name in self.hbm  # residency == seatable == HBM

    def __len__(self) -> int:
        return len(self.hbm)

    @property
    def stats(self):
        return self.hbm.stats

    @property
    def pinned(self):
        return self.hbm.pinned

    @pinned.setter
    def pinned(self, names):
        self.hbm.pinned = names

    def names(self) -> Tuple[str, ...]:
        """Every tier's names, hottest tier first (HBM, host, disk)."""
        return tuple(dict.fromkeys(
            tuple(self.hbm.names()) + tuple(self._host) + tuple(self._disk)))

    def lookup(self, name: str) -> bool:
        if name in self.hbm:
            self.tier_stats["hbm_hits"] += 1
        return self.hbm.lookup(name)

    def put(self, name: str, materialized, *args, **kwargs):
        out = self.hbm.put(name, materialized, *args, **kwargs)
        self._forget_cold(name)  # fresh content supersedes any cold copy
        return out

    def put_row(self, name: str, row, *args, **kwargs):
        out = self.hbm.put_row(name, row, *args, **kwargs)
        self._forget_cold(name)
        return out

    # ------------------------------------------------------------------
    # Cold residency
    # ------------------------------------------------------------------

    def tier_of(self, name: str) -> Optional[str]:
        """"hbm" | "host" | "disk" | "promoting" | None."""
        if name in self.hbm:
            return "hbm"
        if name in self._jobs:
            return "promoting"
        if name in self._host:
            return "host"
        if name in self._disk:
            return "disk"
        return None

    def cold_resident(self, name: str) -> bool:
        """True when ``name`` is recoverable without recompiling."""
        return self.tier_of(name) in ("host", "disk", "promoting")

    def cold_base_len(self, name: str) -> int:
        """base_len of a not-yet-promoted prefix (request validation)."""
        if name in self._jobs:
            return self._jobs[name].base_len
        if name in self._host:
            return self._host_base[name]
        if name in self._disk:
            return self._disk_base[name]
        raise KeyError(f"prefix {name!r} is not in a cold tier")

    def host_names(self) -> Tuple[str, ...]:
        return tuple(self._host)

    def disk_names(self) -> Tuple[str, ...]:
        return tuple(self._disk)

    def _forget_cold(self, name: str) -> None:
        self._host.pop(name, None)
        self._host_base.pop(name, None)
        self._jobs.pop(name, None)
        path = self._disk.pop(name, None)
        self._disk_base.pop(name, None)
        if path is not None and os.path.exists(path):
            os.remove(path)

    # ------------------------------------------------------------------
    # Downward path: demote (HBM→host) and spill (host→disk)
    # ------------------------------------------------------------------

    def demote(self, name: str) -> None:
        """Evict ``name`` from HBM into the host tier (raises
        ``PrefixSeatedError`` while a slot is seated on it)."""
        self.hbm.evict(name)

    def _demote(self, name: str, payload) -> None:
        """The stores' ``demote_hook``: dense hands its row, paged its
        ``{"blocks", "base_len", "state"}`` entry (blocks still held)."""
        if isinstance(self.hbm, PagedPrefixStore):
            row = self._gather_paged(payload)
        else:
            row = payload
        self._host_insert(name, self._to_host(row))
        self.tier_stats["demotes"] += 1

    def _gather_paged(self, entry: dict) -> list:
        """A paged prefix read back out of its pool blocks into the dense
        store's row layout: positions [0, base_len) of each layer."""
        cache = self._cache_ref()
        base = int(entry["base_len"])
        ids = torch.as_tensor(list(entry["blocks"]), dtype=torch.int32,
                              device=self.device)[None]
        row = [{key: ops.paged_gather(c[key], ids)[0, :base]
                for key in KV_KEYS if key in c} if base else {}
               for c in cache]
        for layer, extra in zip(row, entry.get("state") or ()):
            layer.update(extra)
        return row

    def _to_host(self, row: list) -> list:
        """A host copy of a device row: pinned tensors filled without
        blocking, then one wait for the last copy (the host reads these
        bytes when it spills)."""
        on_card = any(x.is_cuda for e in row for x in e.values())
        out = []
        for e in row:
            host = {}
            for key, x in e.items():
                if x.is_cuda:
                    host[key] = torch.empty(x.shape, dtype=x.dtype,
                                            pin_memory=True)
                    host[key].copy_(x, non_blocking=True)
                else:
                    host[key] = x.clone()
            out.append(host)
        if on_card:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return out

    def _host_insert(self, name: str, row: list) -> None:
        self._host[name] = row
        self._host.move_to_end(name)
        self._host_base[name] = _row_base_len(row)
        while self.host_capacity is not None and \
                len(self._host) > self.host_capacity:
            if not self._spill_lru():
                break  # everything left is mid-promotion; run over budget

    def _spill_lru(self) -> bool:
        for name in self._host:  # oldest first
            if name in self._jobs:
                continue  # a promotion is reading this row; skip it
            row = self._host.pop(name)
            base = self._host_base.pop(name)
            if self.disk_dir:
                self.spill_row(name, row, base)
            else:
                self.tier_stats["host_drops"] += 1
            return True
        return False

    def spill(self, name: str) -> str:
        """Move one host row to disk; returns the shard path."""
        if name not in self._host:
            raise KeyError(f"prefix {name!r} is not in the host tier")
        row = self._host.pop(name)
        base = self._host_base.pop(name)
        return self.spill_row(name, row, base)

    def spill_row(self, name: str, row: list, base_len: int) -> str:
        if not self.disk_dir:
            raise ValueError("no disk tier configured (disk_dir is unset)")
        path = self._shard_path(name)
        self._write_shard(path, name, row, base_len)
        self._disk[name] = path
        self._disk_base[name] = base_len
        self.tier_stats["spills"] += 1
        return path

    # ------------------------------------------------------------------
    # Upward path: budgeted, per-layer promotion
    # ------------------------------------------------------------------

    def submit_promotion(self, name: str, priority: int = 0) -> PromotionJob:
        """Start (or join: single-flight per name) the host→device copy of
        a cold prefix.  A disk-resident prefix is read into the job first
        (counted ``disk_loads``); its shard stays until the install."""
        job = self._jobs.get(name)
        if job is not None:
            job.priority = min(job.priority, priority)
            return job
        if name in self._host:
            row, source = self._host[name], "host"
            self._host.move_to_end(name)
        elif name in self._disk:
            row = self._read_shard(self._disk[name])
            self.tier_stats["disk_loads"] += 1
            source = "disk"
        else:
            raise KeyError(f"prefix {name!r} is not in a cold tier; "
                           f"tiers: {self.names() or '(none)'}")
        job = PromotionJob(name=name, source=source, host_row=row,
                           base_len=_row_base_len(row), priority=priority,
                           seq=next(self._job_seq))
        job.pending.extend((i, e) for i, e in enumerate(row) if e)
        job.total_chunks = len(job.pending)
        self._jobs[name] = job
        return job

    def has_promote_work(self) -> bool:
        return any(j.status == "promoting" for j in self._jobs.values())

    def ready_promotions(self) -> List[str]:
        return [n for n, j in self._jobs.items() if j.status == "ready"]

    def promoted_row(self, name: str) -> list:
        job = self._jobs[name]
        if job.status != "ready":
            raise RuntimeError(f"promotion of {name!r} is {job.status}")
        return job.row

    def promote_step(self, chunk_budget: Optional[int] = None) -> List[str]:
        """Copy up to ``chunk_budget`` per-layer chunks host→device
        (``None``: the head job to completion).  Jobs advance in
        ``(priority, submission order)``.  Returns the names turned
        ready."""
        finished: List[str] = []
        budget = chunk_budget
        while True:
            promoting = [j for j in self._jobs.values()
                         if j.status == "promoting"]
            job = (min(promoting, key=lambda j: (j.priority, j.seq))
                   if promoting else None)
            if job is None or (budget is not None and budget <= 0):
                break
            n = job.remaining if budget is None else min(job.remaining, budget)
            for _ in range(n):
                self._copy_chunk(job, *job.pending.popleft())
            if budget is not None:
                budget -= n
            if not job.pending:
                job.row = [job.dev.get(i, {})
                           for i in range(len(job.host_row))]
                job.status = "ready"
                finished.append(job.name)
                if budget is None:
                    break  # None = one whole job, not the whole queue
        return finished

    def mark_promoted(self, name: str) -> None:
        """Count a completed promotion (the install's ``put_row`` already
        dropped the job and the cold copies)."""
        self._jobs.pop(name, None)
        self.tier_stats["host_promotes"] += 1

    def _copy_chunk(self, job: PromotionJob, layer: int, entry: dict) -> None:
        job.dev[layer] = {k: v.to(self.device, non_blocking=True)
                          for k, v in entry.items()}
        self.tier_stats["promote_chunks"] += 1
        self.tier_stats["promote_bytes"] += _row_nbytes(entry)

    # ------------------------------------------------------------------
    # Disk shards (the JAX package's format, one file per prefix)
    # ------------------------------------------------------------------

    def _shard_path(self, name: str) -> str:
        digest = hashlib.sha1(name.encode()).hexdigest()[:16]
        return os.path.join(self.disk_dir, digest + _SHARD_SUFFIX)

    def _write_shard(self, path: str, name: str, row: list,
                     base_len: int) -> None:
        entries, raws, offset = [], [], 0
        for leaf_path, x in _flatten_row(self.cfg, row):
            raw, shape, dtype = _leaf_bytes(x)
            entries.append({"path": leaf_path, "shape": shape,
                            "dtype": dtype, "offset": offset,
                            "nbytes": len(raw)})
            raws.append(raw)
            offset += len(raw)
        codec, blob = compress_bytes(b"".join(raws))
        header = packb({"version": _VERSION, "name": name, "codec": codec,
                        "base_len": base_len,
                        "structure": _structure(self.cfg),
                        "entries": entries})
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_MAGIC + struct.pack("<I", len(header)))
            f.write(header)
            f.write(blob)
        os.replace(tmp, path)  # atomic commit

    @staticmethod
    def _read_header(f) -> dict:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{f.name}: not a prefix shard "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        return unpackb(f.read(hlen))

    def _read_shard(self, path: str) -> list:
        with open(path, "rb") as f:
            header = self._read_header(f)
            data = decompress_bytes(f.read(), header["codec"])
        leaves = {}
        for e in header["entries"]:
            raw = data[e["offset"]:e["offset"] + e["nbytes"]]
            x = _leaf_tensor(raw, e["shape"], e["dtype"])
            leaves[e["path"]] = x.pin_memory() if self.device.type == "cuda" \
                else x
        return _unflatten_row(self.cfg, leaves)

    def _scan_disk(self) -> None:
        """Index shards already on disk, so a restarted server promotes
        them instead of recompiling."""
        for fname in sorted(os.listdir(self.disk_dir)):
            if not fname.endswith(_SHARD_SUFFIX):
                continue
            path = os.path.join(self.disk_dir, fname)
            try:
                with open(path, "rb") as f:
                    header = self._read_header(f)
            except (ValueError, struct.error):
                continue  # foreign file; leave it alone
            self._disk[header["name"]] = path
            self._disk_base[header["name"]] = int(header["base_len"])

    # ------------------------------------------------------------------
    # Introspection (ServingEngine.stats())
    # ------------------------------------------------------------------

    def tier_snapshot(self) -> Dict[str, int]:
        out = dict(self.tier_stats)
        out["hbm_resident"] = len(self.hbm)
        out["host_resident"] = len(self._host)
        out["disk_resident"] = len(self._disk)
        out["promotions_in_flight"] = len(self._jobs)
        return out


# ---------------------------------------------------------------------------
# Rows and the JAX package's Layerwise leaf paths
# ---------------------------------------------------------------------------


def _layer_index(cfg: ModelConfig, j: int, r: int) -> int:
    return len(cfg.layout.prefix) + r * len(cfg.layout.period) + j


def _structure(cfg: ModelConfig) -> dict:
    """The Layerwise sections a materialized prefix of ``cfg`` has."""
    n_pre = len(cfg.layout.prefix)
    return {"prefix_len": n_pre if n_pre else None,
            "period_keys": (sorted(f"l{j}" for j in
                                   range(len(cfg.layout.period)))
                            if cfg.layout.repeats and cfg.layout.period
                            else None)}


def _flatten_row(cfg: ModelConfig, row: list) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a per-layer row in the JAX shard's order:
    ``prefix/<i>/<key>``, then ``period/l<j>/<key>`` (sorted lkeys) with
    the period's layers stacked over the repeats."""
    st = _structure(cfg)
    flat = []
    for i in range(st["prefix_len"] or 0):
        for key in sorted(row[i]):
            flat.append((f"prefix/{i}/{key}", row[i][key]))
    for lkey in st["period_keys"] or ():
        j = int(lkey[1:])
        layers = [row[_layer_index(cfg, j, r)]
                  for r in range(cfg.layout.repeats)]
        for key in sorted(layers[0]):
            flat.append((f"period/{lkey}/{key}",
                         torch.stack([e[key] for e in layers])))
    return flat


def _unflatten_row(cfg: ModelConfig, leaves: Dict[str, torch.Tensor]) -> list:
    row: list = [{} for _ in range(cfg.num_layers)]
    for path, x in leaves.items():
        section, mid, key = path.split("/")
        if section == "prefix":
            row[int(mid)][key] = x
        else:
            for r in range(cfg.layout.repeats):
                row[_layer_index(cfg, int(mid[1:]), r)][key] = x[r]
    return row
