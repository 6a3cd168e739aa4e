"""Port parity: LM training (``models/lm.loss_fn`` and remat,
``distributed/compression``, ``distributed/steps.build_train_step``,
``data/tokens.token_stream``, the LM ``Trainer``, ``launch/specs`` and
``launch/train``) against the JAX reference on the CPU.

The reference's own ``Trainer`` needs a mesh that fails in this JAX, so
the oracle is a step composed of the reference functions that run here:
``jax.value_and_grad`` of ``lm.loss_fn`` per microbatch, the f32 mean,
``ef_int8_compress_decompress`` and ``adam_update``. The same numpy
parameters (the reference's ``init_params`` through ``lm_params_from_jax``)
and tokens go through both packages at the reduced sizes. Tolerances:
``tests/oracle.py`` TOLS (f32 (1e-4, 1e-5), bf16 (8e-2, 2e-2)); the loss of
a step within 1e-3; remat against no remat in the port, and the
compression and the token stream against the reference, bit for bit.
"""
import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro import configs as jconfigs
from repro import tuning as jtuning
from repro.checkpoint import CheckpointManager as JManager
from repro.data import tokens as jtokens
from repro.distributed import compression as jcomp
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch import tuning as ttuning
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import tokens as ttokens
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import steps as tsteps
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.training.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
BLOCKS = dict(q_block=8, kv_block=8)
POLICIES = (None, "full", "dots", "none")      # None: remat=False


def _close(got, want, what, tol="f32", atol=None):
    a, r = TOLS[tol]
    np.testing.assert_allclose(np.asarray(got.detach().float(), np.float32),
                               np.asarray(want, np.float32),
                               atol=a if atol is None else atol, rtol=r,
                               err_msg=what)


@functools.cache
def _ref_params(jcfg, seed):
    """The reference's ``init_params`` (immutable arrays), drawn once per
    config and seed in a process."""
    return jlm.init_params(jax.random.key(seed), jcfg)


def _pair(arch, seed=0, **kw):
    """(reference config, port config, the reference's parameters, a fresh
    port copy of them)."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **kw)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), **kw)
    jp = _ref_params(jcfg, seed)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              tcfg, device="cpu")


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _port_value_and_grad(tp, tcfg, batch, remat, policy):
    live = [t.detach().requires_grad_() for t in tree.leaves(tp)]
    flags = dict(BLOCKS, remat_policy=policy or "full")
    with ttuning.use_flags(**flags):
        loss, metrics = tlm.loss_fn(tree.unflatten(tp, live), tcfg, batch,
                                    remat=remat)
    # the backward (and so the recompute) runs outside the flags' context
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


_TOKS = _tokens((2, 20), 256, seed=5)
_MASK = np.tile((np.arange(20) % 3 > 0).astype(np.float32), (2, 1))


@functools.cache
def _ref_loss(dtype):
    """The reference's loss, metrics and gradients on llama4's reduced
    config (its (attn_dense, attn_moe) block), with ``_MASK`` as the loss
    mask; jitted, once per dtype in a process. Its remat recomputes the
    same function, so the port under each policy is held to this."""
    jcfg, _, jp, _ = _pair("llama4-maverick-400b-a17b", dtype=dtype)
    batch = {"tokens": jnp.asarray(_TOKS), "loss_mask": jnp.asarray(_MASK)}
    with jtuning.use_flags(**BLOCKS):
        return jax.jit(jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, batch), has_aux=True))(jp)


@functools.cache
def _port_no_remat(dtype):
    """The port's loss, metrics and gradients of ``_ref_loss``'s case
    without remat, once per dtype in a process."""
    _, tcfg, _, tp = _pair("llama4-maverick-400b-a17b", dtype=dtype)
    batch = {"tokens": torch.from_numpy(_TOKS),
             "loss_mask": torch.from_numpy(_MASK)}
    return _port_value_and_grad(tp, tcfg, batch, False, None)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_loss_fn_and_gradients_match_reference_under_remat(dtype, policy):
    """llama4's (attn_dense, attn_moe) block, a loss mask on 2 of every 3
    positions: loss, metrics and every gradient against the reference; the
    port's remat under each policy bitwise its no-remat."""
    _, tcfg, _, tp = _pair("llama4-maverick-400b-a17b", dtype=dtype)
    (loss_j, m_j), g_j = _ref_loss(dtype)
    remat = policy is not None
    batch = {"tokens": torch.from_numpy(_TOKS),
             "loss_mask": torch.from_numpy(_MASK)}
    loss_t, m_t, g_t = _port_value_and_grad(tp, tcfg, batch, remat, policy)
    tol = "f32" if dtype == "float32" else "bf16"
    _close(loss_t, loss_j, "loss")
    for k in ("nll", "aux", "tokens"):
        _close(m_t[k], m_j[k], f"metric {k}")
    assert float(m_t["tokens"]) == _MASK[:, 1:].sum() and float(
        m_t["aux"]) > 0
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(g_j)[0]]
    for name, g, w in zip(names, g_t, jax.tree.leaves(g_j), strict=True):
        assert g.dtype == tlm._dtype(tcfg) or g.dtype == torch.float32
        _close(g, np.asarray(w, np.float32), f"d{name}", tol=tol)
    if remat:
        loss_0, m_0, g_0 = _port_no_remat(dtype)
        assert torch.equal(loss_t, loss_0)
        assert all(torch.equal(m_t[k], m_0[k]) for k in m_0)
        for name, a, b in zip(names, g_t, g_0):
            assert torch.equal(a, b), f"remat {policy}: d{name} differs"


def test_dots_policy_recomputes_all_but_the_weight_products():
    """Ops run in the backward: "full" recomputes the block's weight
    products (``aten.mm``) and attention's batched products (``aten.bmm``),
    "dots" only the batched ones, "none" neither."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy

    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert tlm._dots_policy(None, mm) == CheckpointPolicy.MUST_SAVE
    assert tlm._dots_policy(None, torch.ops.aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (bmm, torch.ops.aten.exp.default):
        assert tlm._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {mm: 0, bmm: 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in self.n:
                self.n[func] += 1
            return func(*args, **(kwargs or {}))

    _, tcfg, _, tp = _pair("llama3-8b")
    batch = {"tokens": torch.from_numpy(_tokens((2, 16), tcfg.vocab, 1))}
    runs = {}
    for policy in ("none", "full", "dots"):
        live = [t.detach().requires_grad_() for t in tree.leaves(tp)]
        with ttuning.use_flags(remat_policy=policy, **BLOCKS):
            loss, _ = tlm.loss_fn(tree.unflatten(tp, live), tcfg, batch,
                                  remat=True)
        with Count() as count:
            torch.autograd.grad(loss, live)
        runs[policy] = (count.n[mm], count.n[bmm])
    assert runs["dots"][0] == runs["none"][0] < runs["full"][0], runs
    assert runs["none"][1] < runs["dots"][1] == runs["full"][1], runs


def _grads_tree(seed, scale):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(0, scale, (7, 5)).astype(np.float32),
         "b": {"c": rng.normal(0, scale, (33,)).astype(np.float32),
               "z": np.zeros((4,), np.float32)},
         # values on the .5 boundaries of the int8 grid: round half to even
         "h": (np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0])
               * scale).astype(np.float32)}
    return g


def test_ef_int8_compress_decompress_is_bitwise_the_reference():
    err_j = jcomp.ef_init(_grads_tree(0, 1.0))
    err_t = tcomp.ef_init(jax.tree.map(torch.from_numpy, _grads_tree(0, 1.0)))
    assert all(float(t.abs().sum()) == 0 for t in tree.leaves(err_t))
    for step, scale in enumerate((1.0, 3e-3, 250.0)):
        g = _grads_tree(step, scale)
        deq_j, err_j = jcomp.ef_int8_compress_decompress(
            jax.tree.map(jnp.asarray, g), err_j)
        deq_t, err_t = tcomp.ef_int8_compress_decompress(
            jax.tree.map(torch.from_numpy, g), err_t)
        for a, b in zip(jax.tree.leaves((deq_j, err_j)),
                        tree.leaves((deq_t, err_t)), strict=True):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a bf16 gradient goes through f32 first, in both
    gb = np.asarray(_grads_tree(5, 0.7)["a"], ml_dtypes.bfloat16)
    want, _ = jcomp._quant(jnp.asarray(gb), jnp.zeros((7, 5)))
    got, _ = tcomp._quant(torch.from_numpy(gb.astype(np.float32)).to(
        torch.bfloat16), torch.zeros((7, 5)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.cache
def _ref_value_and_grad(jcfg):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` (remat on, as
    the step's default), jitted once per config in a process."""
    return jax.jit(jax.value_and_grad(
        lambda p, tokens: jlm.loss_fn(p, jcfg, {"tokens": tokens},
                                      remat=True), has_aux=True))


def _ref_step(jcfg, opt, microbatches, compress):
    """The reference's train step without its mesh, composed of the
    functions that run here; returns the gradients before compression."""
    value_and_grad = _ref_value_and_grad(jcfg)

    @jax.jit
    def update(params, opt_state, grads):
        if compress:
            grads, err = jcomp.ef_int8_compress_decompress(
                grads, opt_state["ef_err"])
            opt_state = {**opt_state, "ef_err": err}
        return jadam_update(opt, params, grads, opt_state)

    def step(params, opt_state, tokens):
        mbs = tokens.reshape((microbatches, -1) + tokens.shape[1:])
        acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        loss_sum = 0.0
        for i in range(microbatches):
            (loss, _), g = value_and_grad(params, mbs[i])
            acc = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), acc, g)
            loss_sum = loss_sum + loss
        grads = jax.tree.map(lambda g: g / microbatches, acc)
        params, opt_state = update(params, opt_state, grads)
        return params, opt_state, loss_sum / microbatches, grads

    return step


@pytest.mark.parametrize("compress", (False, True))
def test_build_train_step_matches_the_composed_reference_step(compress):
    jcfg, tcfg, jp, tp = _pair("mixtral-8x22b", seed=3)
    lr = 3e-5            # a sign flip of a ~0 gradient moves Adam by 2·lr
    jopt, topt = (JAdamConfig(lr=lr, grad_clip=1.0),
                  AdamConfig(lr=lr, grad_clip=1.0))
    j_state = jadam_init(jp)
    t_state = adam_init(tp)
    if compress:
        j_state["ef_err"] = jcomp.ef_init(jp)
        t_state["ef_err"] = tcomp.ef_init(tp)
    ref = _ref_step(jcfg, jopt, 2, compress)
    port = tsteps.build_train_step(tcfg, topt, microbatches=2,
                                   compress_grads=compress, device="cpu")
    for step in range(3):
        toks = _tokens((4, 16), tcfg.vocab, seed=10 + step)
        batch = {"tokens": torch.from_numpy(toks)}
        if step == 0:
            _, g_t = tsteps.loss_and_grads(tcfg, tp, batch, microbatches=2)
        with jtuning.use_flags(**BLOCKS):
            jp, j_state, loss_j, g_j = ref(jp, j_state, jnp.asarray(toks))
        with ttuning.use_flags(**BLOCKS):
            tp, t_state, m = port(tp, t_state, batch)
        assert abs(float(m["loss"]) - float(loss_j)) < 1e-3, step
        if step == 0:       # the gradients before compression
            for g, w in zip(tree.leaves(g_t), jax.tree.leaves(g_j),
                            strict=True):
                assert g.dtype == torch.float32
                _close(g, w, "first-step gradient")
            for p, w in zip(tree.leaves(tp), jax.tree.leaves(jp),
                            strict=True):
                _close(p, w, "params after the first step")
    assert int(t_state["step"]) == int(j_state["step"]) == 3
    assert ("ef_err" in t_state) == compress


def test_one_microbatch_keeps_the_parameter_dtype_in_its_grads():
    _, tcfg, _, tp = _pair("llama3-8b", dtype="bfloat16")
    batch = {"tokens": torch.from_numpy(_tokens((2, 8), tcfg.vocab, 0))}
    _, g1 = tsteps.loss_and_grads(tcfg, tp, batch, microbatches=1)
    _, g2 = tsteps.loss_and_grads(tcfg, tp, batch, microbatches=2)
    assert {g.dtype for g in tree.leaves(g1)} == {torch.bfloat16,
                                                  torch.float32}
    assert tree.leaves(g1)[0].dtype == torch.bfloat16          # embed
    assert {g.dtype for g in tree.leaves(g2)} == {torch.float32}
    with pytest.raises(ValueError, match="does not split into 3"):
        tsteps.loss_and_grads(tcfg, tp, batch, microbatches=3)


def test_flash_attention_under_grad_raises_on_the_cpu():
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    want = flash_attention(q, k, v)
    k.requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, k, v)
    with torch.no_grad():
        torch.testing.assert_close(flash_attention(q, k, v), want)
    with torch.inference_mode():
        flash_attention(q, k.detach(), v)
    _, tcfg, _, tp = _pair("llama3-8b")
    batch = {"tokens": torch.from_numpy(_tokens((1, 8), tcfg.vocab, 0))}
    live = tree.tree_map(lambda t: t.detach().requires_grad_(), tp)
    with ttuning.use_flags(attention_impl="pallas"):
        with pytest.raises(RuntimeError, match="no gradient"):
            tlm.loss_fn(live, tcfg, batch)
        with torch.no_grad():          # serving and prefill still run it
            tlm.prefill(live, tcfg, batch)


@pytest.mark.parametrize("start", (0, 3))
def test_token_stream_is_bitwise_make_batch_and_resumes(start):
    spec = dict(vocab=300, batch=3, seq_len=11, seed=4)
    stream = ttokens.token_stream(ttokens.TokenStreamSpec(**spec),
                                  start_step=start, device="cpu")
    for step in range(start, start + 4):
        got = next(stream)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        want = jtokens.make_batch(jtokens.TokenStreamSpec(**spec), step)
        np.testing.assert_array_equal(got.numpy(), want)
    stream.close()
    bad = ttokens.token_stream(ttokens.TokenStreamSpec(vocab=0, batch=1,
                                                       seq_len=2),
                               device="cpu")
    with pytest.raises(ValueError):
        next(bad)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_lm_checkpoints_restore_in_both_packages(tmp_path, dtype):
    jcfg, tcfg, jp, tp = _pair("mixtral-8x22b", seed=4, dtype=dtype)
    t_state = adam_init(tp)
    t_state["step"] += 7
    t_state["m"]["embed"] += 0.25
    CheckpointManager(str(tmp_path / "t")).save(7, (tp, t_state))
    like = (_ref_params(jcfg, 0), jadam_init(_ref_params(jcfg, 0)))
    restored = JManager(str(tmp_path / "t")).restore(7, like)
    for a, t in zip(jax.tree.leaves(restored), tree.leaves((tp, t_state)),
                    strict=True):
        if t.dtype == torch.bfloat16:      # the reference reads raw bf16
            assert a.dtype == np.dtype("V2")
            a = a.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      t.float().numpy())
    j_state = jadam_init(jp)
    j_state = {**j_state, "step": j_state["step"] + 5}
    JManager(str(tmp_path / "j")).save(5, (jp, j_state))
    t_like = (tlm.init_params(tcfg, device="cpu"), adam_init(tp))
    back = CheckpointManager(str(tmp_path / "j")).restore(5, t_like)
    for t, a, ref in zip(tree.leaves(back), jax.tree.leaves((jp, j_state)),
                         tree.leaves(t_like), strict=True):
        assert t.dtype == ref.dtype
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a).astype(np.float32))


_RESUME = """
import sys
from repro_torch import configs
from repro_torch.launch.train import synthetic_data
from repro_torch.optim.adam import AdamConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def fit(ckpt, steps):
    tcfg = TrainerConfig(checkpoint_dir=ckpt, total_steps=steps,
                         checkpoint_every=5, log_every=5, microbatches=2,
                         compress_grads=True, remat=True)
    trainer = Trainer(configs.get("llama3-8b").reduced(),
                      AdamConfig(lr=1e-3, grad_clip=1.0), tcfg, device="cpu")
    start = trainer.manager.latest_step() or 0
    trainer.fit(synthetic_data(trainer.cfg, 4, 16, start_step=start,
                               device="cpu"))


if __name__ == "__main__":
    fit(sys.argv[1], int(sys.argv[2]))
"""


def _records(ckpt):
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_resumes_in_a_second_process(tmp_path):
    """10 steps in this process, 5 more in a second one that resumes from
    the step-10 checkpoint: the same state as 15 steps without a stop."""
    scope = {}
    exec(_RESUME, scope)
    ckpt, whole = str(tmp_path / "resumed"), str(tmp_path / "whole")
    scope["fit"](ckpt, 10)
    proc = subprocess.Popen([sys.executable, "-c", _RESUME, ckpt, "15"],
                            env=dict(os.environ,
                                     PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        scope["fit"](whole, 15)        # meanwhile, the uninterrupted run
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert [r["step"] for r in _records(ckpt)] == [5, 10, 15]
    assert [r["loss"] for r in _records(ckpt)] == [
        r["loss"] for r in _records(whole)]
    cfg = tconfigs.get("llama3-8b").reduced()
    trainer = Trainer(cfg, AdamConfig(), TrainerConfig(
        checkpoint_dir=ckpt, compress_grads=True), device="cpu")
    like = trainer.init_state()
    assert trainer.manager.steps() == [5, 10, 15]
    a = trainer.manager.restore(15, like)
    b = CheckpointManager(whole).restore(15, like)
    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True):
        assert torch.equal(x, y)


def test_trainer_sigterm_writes_a_final_checkpoint(tmp_path):
    cfg = tconfigs.get("mixtral-8x22b").reduced()
    tcfg = TrainerConfig(checkpoint_dir=str(tmp_path), total_steps=50,
                         checkpoint_every=100, log_every=3)
    trainer = Trainer(cfg, AdamConfig(lr=1e-3), tcfg, device="cpu")

    def on_metrics(step, rec):
        if step == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    params, state = trainer.fit(
        tlaunch.synthetic_data(cfg, 2, 12, device="cpu"),
        on_metrics=on_metrics)
    assert signal.getsignal(signal.SIGTERM) is handler
    assert trainer.manager.steps() == [6] and int(state["step"]) == 6
    assert [r["step"] for r in _records(str(tmp_path))] == [3, 6]
    restored = trainer.manager.restore(6, trainer.init_state())
    for x, y in zip(tree.leaves(restored), tree.leaves((params, state))):
        assert torch.equal(x, y)
    assert trainer.restore_or_init()[2] == 6


@pytest.mark.parametrize("arch", ("llama3-8b", "mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"))
def test_launch_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for name, cell in jconfigs.SHAPE_CELLS.items():
        assert tspecs.cell_supported(tcfg, tconfigs.SHAPE_CELLS[name]) == \
            jspecs.cell_supported(jcfg, cell)
        if not jspecs.cell_supported(jcfg, cell)[0]:
            with pytest.raises(ValueError, match=name):
                tspecs.make_inputs(tcfg, tconfigs.SHAPE_CELLS[name])
            continue
        kind_j, want = jspecs.make_inputs(jcfg, cell, dp_size=4)
        kind_t, got = tspecs.make_inputs(tcfg, tconfigs.SHAPE_CELLS[name],
                                         dp_size=4)
        assert kind_t == kind_j
        shapes_j = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype))
                                if hasattr(a, "shape") else a, want)
        shapes_t = tree.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            if isinstance(t, torch.Tensor) else t, got)
        assert shapes_t == shapes_j, name
        assert all(t.device.type == "meta" for t in tree.leaves(got)
                   if isinstance(t, torch.Tensor))
    small = tcfg.reduced()
    tokens, caches, pos = tspecs.make_decode_inputs(small, 2, 16, True,
                                                    device="cpu")
    assert int(pos) == 16 and float(tokens.abs().sum()) == 0
    assert sorted(caches) == [str(i) for i in range(len(small.block_pattern))]
    batch = tspecs.make_train_batch(small, 2, 8, True, device="cpu")
    assert batch["tokens"].shape == (2, 8) and batch["tokens"].device.type \
        == "cpu"


def test_launch_train_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    tlaunch.main(["--arch", "llama4-maverick-400b-a17b", "--reduced",
                  "--steps", "3", "--batch", "2", "--seq", "8",
                  "--checkpoint-dir", ckpt, "--checkpoint-every", "3",
                  "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("step 3: loss ")
    assert CheckpointManager(ckpt).steps() == [3]
    # --mesh 1x2: two spawned ranks on the CPU (gloo), rank 0 prints
    mesh_ckpt = str(tmp_path / "mesh")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--reduced", "--steps", "2", "--batch", "2", "--seq",
         "8", "--checkpoint-dir", mesh_ckpt, "--checkpoint-every", "2",
         "--mesh", "1x2", "--device", "cpu"], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        line for line in out.stdout.splitlines() if line.startswith("step ")]
    assert [line.split(":")[0] for line in out.stdout.splitlines()] == [
        "step 2"]
    assert CheckpointManager(mesh_ckpt).steps() == [2]
    assert not [f for f in os.listdir(mesh_ckpt) if f.startswith(".store")]
    # the production meshes need 256 / 512 ranks: the dry-run is not ported
    with pytest.raises(RuntimeError, match="queue 1: launch/dryrun"):
        tlaunch.main(["--arch", "llama3-8b", "--reduced", "--mesh",
                      "production", "--checkpoint-dir", ckpt, "--device",
                      "cpu"])
