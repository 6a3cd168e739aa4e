"""Port parity: the LM on a (data × model) mesh (``distributed/lm_mesh``,
the mesh half of ``distributed/steps``, ``Trainer(mesh=)``, and the mesh
paths of ``models/layers``, ``models/lm``, ``optim/adam`` and
``distributed/compression``).

The reference's own mesh tests fail on JAX 0.9, so the mesh paths are held
to the port's single-device paths (which ``test_torch_lm_training.py`` and
``test_torch_lm_serving.py`` hold to the reference), and the first step's
loss and gradients directly to the reference's
``jax.value_and_grad(lm.loss_fn)`` on one CPU device. Each mesh shape runs
in one spawned gloo group on the CPU (``tests/torch_mesh_ranks.py``, which
imports only torch, numpy and ``repro_torch``), reduced configs in f32:
losses, gradients and parameters within 1e-5 of one device; against the
reference within 3× ``tests/oracle.py`` TOLS["f32"]; greedy tokens
identical. Every family of the zoo runs a first step, a prefill and 6
decode steps on each mesh shape too.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro import configs as jconfigs
from repro import tuning as jtuning
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import VISION_DIM

FLAGS = dict(q_block=8, kv_block=8)
BATCH, SEQ, STEPS = 4, 16, 6
CASES = [dict(zero1=True, fsdp=False, compress=False, mb=1),
         dict(zero1=False, fsdp=False, compress=False, mb=2),
         dict(zero1=True, fsdp=True, compress=False, mb=2),
         dict(zero1=True, fsdp=False, compress=True, mb=1)]
CLIP = 0.05          # below the gradient norm: clipping is active


@functools.cache
def _params(arch: str, seed: int = 0, **fields):
    """The reference's parameters of the reduced ``arch`` as the port's tree
    of numpy arrays, and the reference's own."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **fields)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), **fields)
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    port = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return tree.tree_map(lambda t: t.numpy(), port), jp, jcfg, tcfg


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@functools.cache
def _payload():
    np_params, jp, jcfg, tcfg = _params("llama3-8b")
    batches = [{"tokens": _tokens((BATCH, SEQ), 10 + i)}
               for i in range(STEPS)]
    first = {"tokens": jnp.asarray(batches[0]["tokens"])}
    with jtuning.use_flags(**FLAGS):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, first, remat=True),
            has_aux=True))(jp)
    ref_grads = tree.tree_map(lambda t: t.numpy(), lm_params_from_jax(
        jax.tree.map(np.asarray, grads), tcfg, device="cpu"))
    return {"arch": "llama3-8b", "fields": {}, "flags": FLAGS,
            "params": np_params, "batches": batches,
            "ref_loss": float(loss), "ref_grads": ref_grads,
            "cases": CASES, "clip": CLIP,
            "prompt": _tokens((BATCH, 5), 3), "new_tokens": 8,
            "zoo": tconfigs.ARCHS}


def _moe_payload():
    mix, *_ = _params("mixtral-8x22b")
    llava, *_ = _params("llava-next-34b")
    llama = _payload()["params"]
    toks = _tokens((BATCH, SEQ), 7)
    patches = np.random.default_rng(8).normal(
        size=(BATCH, 4, VISION_DIM)).astype(np.float32)
    mask = (np.random.default_rng(9).random((BATCH, SEQ)) < [
        [0.9], [0.5], [0.2], [0.7]]).astype(np.float32)
    out = {}
    for dispatch in ("grouped", "scatter"):
        out[f"mixtral {dispatch}"] = dict(
            arch="mixtral-8x22b", fields={}, params=mix,
            batch={"tokens": toks},
            flags=dict(FLAGS, moe_dispatch=dispatch, capacity_factor=0.5))
    out["llava patches"] = dict(
        arch="llava-next-34b", fields={}, params=llava, flags=FLAGS,
        batch={"tokens": toks, "patch_embeds": patches})
    out["llama3 loss_mask"] = dict(
        arch="llama3-8b", fields={}, params=llama, flags=FLAGS,
        batch={"tokens": toks, "loss_mask": mask})
    return out


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_lm_mesh_matches_single_device(shape, tmp_path):
    payload = dict(_payload())
    if shape == (2, 1):
        payload["moe"] = _moe_payload()
    out = ranks.run_ranks(ranks.lm_mesh, shape[0] * shape[1], tmp_path,
                          payload, shape=shape)
    for r in out:
        assert r["shape"] == shape
        assert set(r["losses"]) == {str(c) for c in CASES}
        assert r["grad_vs_ref"] <= 3e-4
        serve = r["serve"]
        toks = serve["constrain_decode=True"]["tokens"]
        assert len(toks) == payload["new_tokens"]
        assert toks == serve["constrain_decode=False"]["tokens"]
        assert toks == out[0]["serve"]["constrain_decode=True"]["tokens"]
    # each rank holds only its shards: on a model axis of 2, the split
    # leaves (and the caches' sequence axis) are halved
    if shape[1] == 2:
        k_shape = out[0]["serve"]["constrain_decode=True"]["k_shape"]
        assert k_shape[2] == 128 // 2, k_shape
    n_full = sum(a.nbytes for a in tree.leaves(payload["params"]))
    assert out[0]["param_bytes"] < n_full if shape[1] > 1 else \
        out[0]["param_bytes"] == n_full
    if shape == (2, 1):
        assert set(out[0]["moe"]) == set(payload["moe"])
    assert set(out[0]["zoo"]) == set(tconfigs.ARCHS)


def test_lm_checkpoint_resumes_on_another_mesh(tmp_path):
    """A run saved on 1x2 resumes on 2x1 and on one device, each matching
    an unbroken single-device run."""
    base = dict(arch="llama3-8b", fields={}, root=str(tmp_path), stop=2,
                steps=4, batch=BATCH, seq=SEQ)
    for d in ("s", "r"):
        (tmp_path / d).mkdir()
    saved = ranks.run_ranks(ranks.lm_resume, 2, tmp_path / "s",
                            dict(base, phase="save"), shape=(1, 2))
    assert saved[0]["steps"] == [2]
    out = ranks.run_ranks(ranks.lm_resume, 2, tmp_path / "r",
                          dict(base, phase="resume", tag="2x1"),
                          shape=(2, 1))
    assert sorted(out[0]["resumed"]) == [3, 4]
    alone = ranks.lm_resume(0, None, dict(base, phase="resume",
                                          tag="alone"))
    assert alone["resumed"].keys() == out[0]["resumed"].keys()
