"""MemCom Phase 1 of whisper-medium (enc-dec, with encoder frames in every
batch) and qwen2-vl-2b (M-RoPE) through the port's ``Trainer``, against
the JAX package's ``build_memcom_train_step`` on the same bridged
parameters (their smoke configs, float32, on the CPU).

Two Trainer steps with a checkpoint after each: each step's loss within
1e-4 of the JAX step's on the same batch (the JAX step run twice from
its initial compressor and AdamW state, jitted, the lr schedule the
reference's); then a second Trainer restored from step 1 reproduces step
2's loss and trained tensors bit for bit.  Batches are made with numpy
from a seed per step; whisper's carry ``frames`` (B, num_frames, d_model)
as ``launch.steps.input_specs`` gives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.launch import steps
from repro_torch.train import Trainer, TrainerConfig

TOL = 1e-4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
B, T, S = 2, 24, 12


def _batch(cfg, i):
    rng = np.random.default_rng(100 + i)
    b = {"source": rng.integers(4, cfg.vocab_size, (B, T)).astype(np.int32),
         "target": rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32),
         "target_mask": (rng.random((B, S)) > 0.2).astype(np.int32)}
    if cfg.encoder is not None:
        b["frames"] = (rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)) * 0.1).astype(
                np.float32)
    return b


def _port_run(pcfg, np_params, np_mc, ckpt):
    target = bridge.from_jax_params(pcfg, np_params, device="cpu")
    mc = bridge.from_jax_memcom(pcfg, np_mc, device="cpu")
    step, opt, params = steps.build_memcom_train_step(pcfg, mc, target,
                                                      phase=1, remat=False)

    def batch_at(i):
        return {k: torch.from_numpy(v) for k, v in _batch(pcfg, i).items()}

    trainer = Trainer(step, params, opt.init(params), batch_at, ckpt,
                      TrainerConfig(num_steps=2, ckpt_every=1, log_every=1))
    return trainer, mc


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_phase1_trainer_matches_the_jax_step_and_restarts_exactly(tmp_path,
                                                                  arch):
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    np_params = jax.tree.map(np.asarray, params)
    np_mc = jax.tree.map(np.asarray, mc)

    jstep = jax.jit(jsteps.build_memcom_train_step(cfg, phase=1,
                                                   remat=False)[0])
    opt_state = JAdamW(lr=jwarmup_cosine(2e-4, 500, 20_000),
                       mask=jmc.trainable_mask(mc, 1)).init(mc)
    jlosses = {}
    jmc_ = mc
    for i in range(2):
        batch = jax.tree.map(jnp.asarray, _batch(cfg, i))
        jmc_, opt_state, metrics = jstep(jmc_, opt_state, params, batch)
        jlosses[i + 1] = float(metrics["loss"])

    pcfg = port_smoke_config(arch)
    assert (pcfg.encoder is not None) == (arch == "whisper-medium")
    trainer, pmc = _port_run(pcfg, np_params, np_mc, str(tmp_path))
    frozen = {n: p.detach().clone() for n, p in pmc.named_parameters()
              if n not in trainer.params}
    start = {n: p.detach().clone() for n, p in trainer.params.items()}
    trainer.run()
    assert sorted(trainer.losses) == [1, 2]
    for s in (1, 2):
        np.testing.assert_allclose(trainer.losses[s], jlosses[s], rtol=TOL,
                                   atol=TOL, err_msg=f"step {s}")
    assert trainer.losses[1] != trainer.losses[2]
    assert all(not torch.equal(p, start[n])
               for n, p in trainer.params.items())
    assert all(torch.equal(p, frozen[n]) for n, p in pmc.named_parameters()
               if n in frozen)
    final = {n: p.detach().clone() for n, p in trainer.params.items()}

    again, _ = _port_run(pcfg, np_params, np_mc, str(tmp_path))
    assert again.restore_if_available(step=1) == 1
    again.run()
    assert again.losses == {2: trainer.losses[2]}
    assert all(torch.equal(p, final[n]) for n, p in again.params.items())
