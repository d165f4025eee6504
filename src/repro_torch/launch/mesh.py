"""Meshes of ``torch.distributed`` ranks (``repro/launch/mesh.py``) and the
helper that starts them.

The JAX package builds a ``jax.sharding.Mesh`` over the devices of one
controller.  The port runs one process per rank (multi-controller SPMD):
a mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")`` over the ranks of an initialised process group,
and every rank calls the same functions in the same order.

* :func:`make_serving_mesh` takes the *first* ``data * model`` ranks, so
  that a serving engine can run a 2-way model mesh where more ranks
  exist; one rank gives a real 1x1 mesh (inside :func:`one_rank_group`
  where no group runs), so the mesh-aware path runs the same way
  everywhere.  ``nccl`` needs a card per rank; ``gloo`` serves the CPU,
  and ranks that share one card only when the caller names it.
* :func:`make_host_mesh` and :func:`make_production_mesh` (16x16 and
  2x16x16) take every rank of the group, or raise.
* :func:`run_ranks` starts ``n`` ranks of a function: ``spawn`` children
  (no inherited CUDA context) meeting at a file store in a temporary
  directory (no network), a timeout on the group and on the whole run, the
  group torn down on exit.  The launcher, the tests and ``chip_smoke.py``
  share it.

Every rank of a mesh above one rank also gets a ``gloo`` group over the
mesh's ranks, ``mesh.control_group``, for the control plane's host values
(the serving clock, the engine's agreement check), whatever backend the
tensors use.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

from multiprocessing.connection import wait

import torch
import torch.distributed as dist

from repro_torch import resolve_device

_START_HINT = ("start them with launch/serve.py --mesh (which spawns its "
               "ranks) or torchrun --nproc-per-node N")


def _init_group(backend: str, store_dir: str, rank: int, world: int,
                timeout: float) -> None:
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))


@contextlib.contextmanager
def one_rank_group(backend: str = "gloo", timeout: float = 600.0):
    """A process group of this process alone, destroyed on exit (the
    launcher's 1x1 mesh without torchrun)."""
    with tempfile.TemporaryDirectory(prefix="repro-group-") as tmp:
        _init_group(backend, tmp, 0, 1, timeout)
        try:
            yield
        finally:
            dist.destroy_process_group()


def default_backend(device: torch.device) -> str:
    """``nccl`` on the card (one card a rank), ``gloo`` on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _make_mesh(shape: Sequence[int], names: Sequence[str], device,
               backend: Optional[str]):
    """The mesh of ``shape`` over the first ranks (module docstring).
    ``backend`` is None unless the caller named one."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    need = 1
    for n in shape:
        need *= n
    named = backend is not None
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else default_backend(device))
    if backend == "nccl" and need > torch.cuda.device_count():
        raise ValueError(
            f"nccl needs one card per rank: {need} ranks, "
            f"{torch.cuda.device_count()} card(s); ranks that share a card "
            "use backend='gloo'")
    if not dist.is_initialized():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{need} rank(s) and no process group is "
                         f"initialised: {_START_HINT}, or one_rank_group() "
                         "for a 1x1 mesh")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the mesh asks for {backend}")
    world = dist.get_world_size()
    if need > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} "
                         f"ranks, the group has {world}: {_START_HINT}")
    if device.type == "cuda" and backend != "nccl" and need > 1 \
            and not named:
        raise ValueError("ranks on the card through gloo: pass "
                         "backend='gloo' to share one card between ranks")
    mesh = DeviceMesh(device.type, torch.arange(need).reshape(*shape),
                      mesh_dim_names=tuple(names))
    mesh.control_group = (dist.new_group(ranks=list(range(need)),
                                         backend="gloo")
                          if need > 1 else None)
    return mesh


def make_serving_mesh(model: int = 1, data: int = 1, *, device=None,
                      backend: Optional[str] = None):
    """A ("data", "model") mesh over the first ``data * model`` ranks.
    Every rank of the group calls it (the sub-groups are made
    collectively); a rank past the mesh gets a mesh it is not part of.
    ``backend`` defaults to the group's, else ``nccl`` on the card and
    ``gloo`` on the CPU; ``backend="gloo"`` on the card lets ranks share
    one card."""
    if model < 1 or data < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    return _make_mesh((data, model), ("data", "model"), device, backend)


def make_host_mesh(model: int = 1, data: Optional[int] = None, *,
                   device=None, backend: Optional[str] = None):
    """A ("data", "model") mesh over every rank of the group."""
    if not dist.is_initialized():
        raise ValueError(f"no process group is initialised: {_START_HINT}")
    world = dist.get_world_size()
    data = data or world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} does not cover {world} ranks")
    return make_serving_mesh(model=model, data=data, device=device,
                             backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: Optional[str] = None):
    """The fleet's mesh: 16x16 ("data", "model"), or 2x16x16 ("pod",
    "data", "model") with ``multi_pod``.  Raises unless that many ranks
    exist."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized() or dist.get_world_size() < need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"the production mesh {'x'.join(map(str, shape))} "
                         f"needs {need} ranks, have {have}: {_START_HINT}")
    return _make_mesh(shape, names, device, backend)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def _rank_entry(fn, rank, world, backend, store_dir, timeout, device, args):
    ok, payload = False, None
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _init_group(backend, store_dir, rank, world, timeout)
        payload = fn(rank, world, *args)
        ok = True
    except BaseException:  # reported to the parent, which raises
        payload = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = os.path.join(store_dir, f"result{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump((ok, payload), f)
    os.replace(path + ".tmp", path)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if ok else 1)  # skip interpreter teardown of CUDA / gloo


def run_ranks(fn: Callable, n: int, args: tuple = (), *,
              backend: str = "gloo", timeout: float = 120.0,
              device=None) -> List[object]:
    """Run ``fn(rank, n, *args)`` in ``n`` spawned ranks of one process
    group and return their results in rank order (each must pickle).
    ``fn`` must be importable by name (a module-level function).  The
    group meets at a file store in a temporary directory, and its
    collectives time out after ``timeout`` seconds; the whole run is
    stopped at ``timeout`` too, every child killed, and a
    ``TimeoutError`` raised.  A rank that raises has its traceback raised
    here as a ``RuntimeError`` (the other ranks are killed at once).
    ``device`` "cuda" sets each rank's card (rank modulo the cards)."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(fn, r, n, backend, tmp, timeout,
                                   None if device is None else str(device),
                                   args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout  # reprolint: ignore[wall-clock] -- a supervisor's deadline, nothing replays it
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None:
                    break
                if time.monotonic() > deadline:  # reprolint: ignore[wall-clock] -- the supervisor's deadline
                    raise TimeoutError(
                        f"{n} rank(s) of {getattr(fn, '__name__', fn)} did "
                        f"not finish within {timeout:g} s (a hung "
                        "collective?)")
                wait([p.sentinel for p in procs if p.is_alive()], 0.1)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        results = []
        for r in range(n):
            path = os.path.join(tmp, f"result{r}.pkl")
            if not os.path.exists(path):  # killed, or died before writing
                continue
            with open(path, "rb") as f:
                ok, payload = pickle.load(f)
            if not ok:
                raise RuntimeError(f"rank {r} of {n} failed:\n{payload}")
            results.append(payload)
        if failed is not None or len(results) < n:
            raise RuntimeError(f"rank {failed} exited with code "
                               f"{procs[failed or 0].exitcode} and no "
                               "result")
        return results
