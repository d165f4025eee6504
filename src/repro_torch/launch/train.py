"""Training launcher of the port: MemCom Phase-1/2 step + fault-tolerant
Trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 4 --device cpu

Without ``--device`` it runs on the card.  Under ``--smoke`` the
vocabulary shrinks to the synthetic stream's 388 ids, as the reference
launcher's does; at full width the published vocabulary stays (the
synthetic ids lie inside it).  The reference's ``--data``/``--model``
mesh flags wait for the training half of the port's sharding (``ctx``,
``pipeline``, the sharded steps and FSDP: ROADMAP Queue 1 step 5); the
serving half runs (``launch/serve.py --mesh``).
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import memcom
from repro_torch.data import PretrainStream, SyntheticVocab
from repro_torch.launch.steps import build_memcom_train_step
from repro_torch.models import transformer as tfm
from repro_torch.train import Trainer, TrainerConfig


def build(cfg, *, phase: int = 1, batch: int = 4, seq: int = 64,
          split: int | None = None, steps: int = 50, ckpt: str,
          ckpt_every: int = 25, device=None, lr=None, codec=None,
          log_every: int = 10):
    """The launcher's run without its loop: seeded target (seed 0) and
    compressor (seed 1) on ``device``, the phase's step, a PretrainStream
    (seed 0) split at ``split`` (default 3/4 of ``seq``) and a Trainer.
    Returns a namespace (trainer, mc, target, stream, params, opt)."""
    device = resolve_device(device)
    target = tfm.init_params(cfg, 0, device=device)
    mc = memcom.init_memcom(cfg, target, 1)
    step, opt, params = build_memcom_train_step(cfg, mc, target, phase=phase,
                                                remat=False, lr=lr)
    split = int(seq * 0.75) if split is None else split
    stream = PretrainStream(SyntheticVocab(), batch=batch, seq_len=seq,
                            split_choices=(split,), seed=0)

    def batch_at(i):
        b = stream.batch_at(i)
        return {k: torch.as_tensor(b[k]).to(device)
                for k in ("source", "target", "target_mask")}

    trainer = Trainer(step, params, opt.init(params), batch_at, ckpt,
                      TrainerConfig(num_steps=steps, ckpt_every=ckpt_every,
                                    log_every=log_every, codec=codec,
                                    metrics_path=os.path.join(
                                        ckpt, "metrics.jsonl")))
    return SimpleNamespace(trainer=trainer, mc=mc, target=target,
                           stream=stream, params=params, opt=opt, step=step,
                           batch_at=batch_at)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--phase", type=int, default=1, choices=(1, 2))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="artifacts/launch_train_torch")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path on the CPU (default: the "
                         "card).  The reference's --data/--model mesh "
                         "flags wait for the training half of the port's "
                         "sharding (serve.py --mesh serves split)")
    args = ap.parse_args(argv)

    vocab = SyntheticVocab()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = cfg.replace(vocab_size=vocab.size)
    if cfg.memcom is None:
        raise SystemExit(f"{args.arch}: MemCom inapplicable (attention-free)")
    device = resolve_device(args.device)
    run = build(cfg, phase=args.phase, batch=args.batch, seq=args.seq,
                steps=args.steps, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                device=device)
    n_train = sum(p.numel() for p in run.params.values())
    print(f"arch: {cfg.name}, phase {args.phase}, device {device}, "
          f"{n_train / 1e6:.2f}M trained parameters")
    resumed = run.trainer.restore_if_available()
    if resumed:
        print(f"resumed from step {resumed}")
    last = run.trainer.run()
    print(f"done: {last}")
    return last


if __name__ == "__main__":
    main()
