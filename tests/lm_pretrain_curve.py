"""The reference's and the port's loss curves at ``examples/lm_pretrain.py``'s
settings, on the CPU, from one set of parameters (the reference's
``init_params``, seed 0, converted with ``lm_params_from_jax``).

    PYTHONPATH=src python tests/lm_pretrain_curve.py --steps 100

Each step feeds ``make_batch(TokenStreamSpec(vocab=8192, batch=8,
seq_len=256), step)`` to the reference's ``jax.value_and_grad`` of
``lm.loss_fn`` + ``adam_update`` (jitted) and to the port's
``build_train_step`` (no remat, as the example's ``TrainerConfig``), and
prints both losses every ``--every`` steps. ~9 s a step for the two here
(88 M parameters in f32). Not collected by pytest: too long for the suite;
tests/test_torch_lm_training.py holds the same step at a reduced size.
"""
import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data import tokens as jtokens
from repro.models import lm as jlm
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed.steps import build_train_step
from repro_torch.optim.adam import AdamConfig, adam_init

# examples/lm_pretrain.py
EXAMPLE = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
               vocab=8192, head_dim=64, dtype="float32")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args()
    jcfg = dataclasses.replace(jconfigs.get("llama3-8b"), **EXAMPLE)
    tcfg = dataclasses.replace(tconfigs.get("llama3-8b"), **EXAMPLE)
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jopt = JAdamConfig(lr=3e-4, grad_clip=1.0)
    j_state, t_state = jadam_init(jp), adam_init(tp)

    @jax.jit
    def ref_step(params, state, tokens):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, {"tokens": tokens}),
            has_aux=True)(params)
        params, state = jadam_update(jopt, params, grads, state)
        return params, state, loss

    port_step = build_train_step(tcfg, AdamConfig(lr=3e-4, grad_clip=1.0),
                                 remat=False, device="cpu")
    spec = jtokens.TokenStreamSpec(vocab=EXAMPLE["vocab"], batch=8,
                                   seq_len=256)
    t0 = time.perf_counter()
    for step in range(args.steps):
        toks = jtokens.make_batch(spec, step)
        jp, j_state, loss_j = ref_step(jp, j_state, jnp.asarray(toks))
        tp, t_state, m = port_step(tp, t_state,
                                   {"tokens": torch.from_numpy(toks)})
        if (step + 1) % args.every == 0:
            print(f"step {step + 1}: reference {float(loss_j):.6f}, port "
                  f"{float(m['loss']):.6f} ({time.perf_counter() - t0:.0f} "
                  "s)", flush=True)


if __name__ == "__main__":
    main()
