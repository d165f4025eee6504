"""Training launcher of the port: mesh + sharded MemCom Phase-1/2 step +
fault-tolerant Trainer (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 4 --device cpu --data 2 --model 1

Without ``--device`` it runs on the card.  Under ``--smoke`` the
vocabulary shrinks to the synthetic stream's 388 ids, as the reference
launcher's does; at full width the published vocabulary stays (the
synthetic ids lie inside it).

The mesh is ("data", "model") over every rank of the process group, as
the reference's ``make_host_mesh``: ``--data`` defaults to the ranks over
``--model``.  Started without a group, the launcher starts its own
ranks: ``--data * --model`` of them (one rank runs in this process),
over ``gloo`` on the CPU or where the ranks outnumber the cards (they
share a card), else ``nccl``; under ``torchrun`` it joins the group
torchrun made.  Each rank holds its slices of the seeded target (seed 0)
and compressor (seed 1) placed by ``FSDP_RULES`` (``default_rules_for``),
reads its ``host_slice`` of every ``PretrainStream`` batch, so the global
batch is the one-rank run's, and runs the Trainer under the residual
stream's placement (``act_sharding_for``).  Rank 0 alone prints and writes
the checkpoints and the metrics.  Families under a model axis above 1
are the dense attention stacks (``sharding.serving.shard_module`` raises
for the others); under the data axis every family trains.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import memcom
from repro_torch.data import PretrainStream, SyntheticVocab, host_slice
from repro_torch.launch.mesh import (default_backend, make_host_mesh,
                                     one_rank_group, run_ranks)
from repro_torch.launch.steps import (act_sharding_for,
                                      build_memcom_train_step,
                                      default_rules_for)
from repro_torch.models import transformer as tfm
from repro_torch.sharding.ctx import act_sharding
from repro_torch.sharding.rules import axis_sizes
from repro_torch.train import Trainer, TrainerConfig

_RANKS_TIMEOUT_S = 3600.0  # the spawned run's limit, its collectives' too
#: the launcher's checkpoint shards are written uncompressed: a
#: full-width run's trained tensors and AdamW state are many GB (7.7 at
#: gemma2-2b Phase 1), which zlib takes minutes to compress (PERF.md)
CKPT_CODEC = "raw"


def build(cfg, *, phase: int = 1, batch: int = 4, seq: int = 64,
          split: int | None = None, steps: int = 50, ckpt: str,
          ckpt_every: int = 25, device=None, lr=None, codec=None,
          log_every: int = 10, mesh=None, rules=None):
    """The launcher's run without its loop: seeded target (seed 0) and
    compressor (seed 1) on ``device``, the phase's step, a PretrainStream
    (seed 0) split at ``split`` (default 3/4 of ``seq``) and a Trainer.
    With ``mesh`` every rank of it calls this: the models are placed by
    ``rules`` (default ``default_rules_for``) one parameter at a time,
    the rank reads its data shard of each global batch of ``batch`` rows,
    and the step and Trainer run on the placement (``step.placement``).
    Returns a namespace (trainer, mc, target, stream, params, opt, step,
    batch_at, act)."""
    device = resolve_device(device)
    split = int(seq * 0.75) if split is None else split
    act, rows = None, slice(None)
    if mesh is None:
        target = tfm.init_params(cfg, 0, device=device)
        mc = memcom.init_memcom(cfg, target, 1)
    else:
        rules = rules or default_rules_for(cfg, mesh)
        target = tfm.init_params(cfg, 0, device=device, mesh=mesh,
                                 rules=rules)
        mc = memcom.init_memcom(cfg, target, 1, mesh=mesh, rules=rules)
        act = act_sharding_for(mesh, cfg, batch, seq)
        n_data = axis_sizes(mesh).get("data", 1)
        if batch % n_data:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{n_data} data ranks")
        rows = host_slice(batch, mesh.get_local_rank("data"), n_data)
    step, opt, params = build_memcom_train_step(
        cfg, mc, target, phase=phase, remat=False, lr=lr, mesh=mesh, act=act)
    stream = PretrainStream(SyntheticVocab(), batch=batch, seq_len=seq,
                            split_choices=(split,), seed=0)

    def batch_at(i):
        b = stream.batch_at(i)
        return {k: torch.as_tensor(b[k][rows]).to(device)
                for k in ("source", "target", "target_mask")}

    trainer = Trainer(step, params, opt.init(params), batch_at, ckpt,
                      TrainerConfig(num_steps=steps, ckpt_every=ckpt_every,
                                    log_every=log_every, codec=codec,
                                    metrics_path=os.path.join(
                                        ckpt, "metrics.jsonl")),
                      placement=step.placement)
    return SimpleNamespace(trainer=trainer, mc=mc, target=target,
                           stream=stream, params=params, opt=opt, step=step,
                           batch_at=batch_at, act=act)


def _backend(device: torch.device, ranks: int) -> str:
    """``nccl`` where every rank has a card of its own, else ``gloo``
    (the CPU, or ranks that share a card)."""
    if device.type == "cuda" and ranks > torch.cuda.device_count():
        return "gloo"
    return default_backend(device)


def _rank_main(rank, world, argv):
    return main(argv)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--phase", type=int, default=1, choices=(1, 2))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=None,
                    help="data axis (default: the ranks over --model)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel axis (default 1)")
    ap.add_argument("--ckpt", default="artifacts/launch_train_torch")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cpu for the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.model < 1 or (args.data is not None and args.data < 1):
        ap.error("--data and --model must be >= 1")
    device = resolve_device(args.device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(default_backend(device))  # torchrun
            try:
                return main(argv)
            finally:
                dist.destroy_process_group()
        ranks = (args.data or 1) * args.model
        backend = _backend(device, ranks)
        if ranks == 1:
            with one_rank_group(backend, timeout=_RANKS_TIMEOUT_S):
                return main(argv)
        return run_ranks(_rank_main, ranks, (argv,), backend=backend,
                         timeout=_RANKS_TIMEOUT_S, device=device)[0]

    mesh = make_host_mesh(model=args.model, data=args.data, device=device,
                          backend=dist.get_backend())
    lead = dist.get_rank() == 0
    vocab = SyntheticVocab()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = cfg.replace(vocab_size=vocab.size)
    if cfg.memcom is None:
        raise SystemExit(f"{args.arch}: MemCom inapplicable (attention-free)")
    run = build(cfg, phase=args.phase, batch=args.batch, seq=args.seq,
                steps=args.steps, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                device=device, codec=CKPT_CODEC, mesh=mesh)
    if lead:
        n_train = sum(p.numel() for p in run.params.values())
        print(f"mesh: {axis_sizes(mesh)}, arch: {cfg.name}, phase "
              f"{args.phase}, device {device}, {n_train / 1e6:.2f}M trained "
              "parameters on rank 0")
    with act_sharding(run.act):
        resumed = run.trainer.restore_if_available()
        if resumed and lead:
            print(f"resumed from step {resumed}")
        last = run.trainer.run()
    if lead:
        print(f"done: {last}")
    return last


if __name__ == "__main__":
    main()
