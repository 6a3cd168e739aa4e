"""Port parity: the rest of the LM zoo (RWKV-6, the Zamba2 hybrid, Whisper's
encoder and cross-attention, LLaVA's vision tiles) against the JAX
reference on the CPU, through the entry points: ``param_shapes``,
``forward``, ``loss_fn`` (LLaVA's loss mask, Whisper's frames), first-step
gradients (with and without remat), ``prefill``'s ``(last_logits,
enc_out)``, ``decode_step`` and ``ServeEngine`` at temperature 0;
``launch/specs.make_inputs`` for every (arch × shape cell) on ``meta``;
every arch through every entry point, ``Trainer`` and the launcher.

One numpy state (the reference's ``init_params`` through
``lm_params_from_jax``) and numpy inputs made from a seed feed both
packages, at the reduced (f32) configs. Tolerance: ``tests/oracle.py``
TOLS["f32"], gradients 3x; a port's decode against its own forward 2e-3,
the reference test's (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro import configs as jconfigs
from repro import tuning as jtuning
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch import tuning as ttuning
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ref as tref
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim.adam import AdamConfig
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.training.trainer import Trainer, TrainerConfig

ATOL, RTOL = TOLS["f32"]
ZOO = ("rwkv6-1.6b", "zamba2-7b", "whisper-small", "llava-next-34b")
B, T, FRAMES, PATCHES = 2, 16, 24, 4
SERVE = dict(batch=2, max_len=32)
DECODE_STEPS = 12
PROMPTS = [([5, 9, 200, 3], 6), ([17], 4), ([250, 250, 7], 5)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small tensors: the test
    workers share the cores, and a thread pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _batch(cfg, seed=3):
    """Numpy inputs of ``cfg``'s family: tokens, Whisper's frames, LLaVA's
    patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal((B, FRAMES, jlm.AUDIO_DIM)) \
            .astype(np.float32)
    if cfg.frontend == "vision_tiles":
        out["patch_embeds"] = rng.standard_normal(
            (B, PATCHES, jlm.VISION_DIM)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ZOO)
def model(request):
    """(arch, jcfg, tcfg, reference params, port params, numpy batch, the
    reference's engine, the reference's outputs): built once per arch for
    the module; the engine's jitted decode step serves the decode test
    too, and one jitted value-and-grad gives the forward test its logits
    and the gradient test its gradients."""
    arch = request.param
    jcfg, tcfg = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        logits, aux = jlm.forward(p, jcfg, jb)
        total, metrics = jlm.loss_fn(p, jcfg, jb)
        return total, (metrics, logits, aux)

    (j_loss, (j_m, j_logits, j_aux)), j_grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(jp)
    ref = {"loss": j_loss, "metrics": j_m, "logits": j_logits, "aux": j_aux,
           "grads": tree.leaves(jax.tree.map(np.asarray, j_grads))}
    return (arch, jcfg, tcfg, jp, tp, batch, JEngine(jp, jcfg, **SERVE),
            ref)


def _split(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _shapes(tree_):
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree_)


def _port_shapes(tree_):
    return jax.tree.map(
        lambda s: (tuple(s[0]), str(s[1]).replace("torch.", "")), tree_,
        is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("arch", ZOO + ("zamba2-7b tail",))
def test_param_shapes_match_reference(arch):
    """Names, shapes and dtypes at the reduced and the full config (Zamba2
    also reduced to 5 layers: a tail after its groups, as the full 81 = 13
    x 6 + 3)."""
    name = arch.split()[0]
    fields = {"n_layers": 5} if arch.endswith("tail") else {}
    for full in ((False,) if fields else (False, True)):
        jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
        if not full:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jcfg = dataclasses.replace(jcfg, **fields)
        tcfg = dataclasses.replace(tcfg, **fields)
        want = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0),
                                                      jcfg))
        assert _port_shapes(tlm.param_shapes(tcfg)) == _shapes(want), \
            (arch, full)
    if fields:
        assert tlm.param_shapes(tcfg)["tail"]["ln"]["scale"][0] == (
            1, tcfg.d_model)


def test_forward_and_loss_match_reference(model):
    arch, jcfg, tcfg, jp, tp, batch, _, ref = model
    _, tb = _split(batch)
    got, aux = tlm.forward(tp, tcfg, tb)
    assert got.shape == (B, T, tcfg.vocab) and float(aux) == float(ref["aux"])
    _close(got, ref["logits"], f"{arch} forward logits")
    loss, m = tlm.loss_fn(tp, tcfg, tb)
    _close(loss, ref["loss"], f"{arch} loss")
    _close(m["nll"], ref["metrics"]["nll"], f"{arch} nll")
    assert float(m["tokens"]) == float(ref["metrics"]["tokens"]) == B * (
        T - 1 - (PATCHES if tcfg.frontend == "vision_tiles" else 0))


def test_first_step_gradients_match_reference(model):
    """The gradients of ``loss_fn`` at every leaf, without remat and with a
    full remat of each block (each Zamba2 group), against the
    reference's."""
    arch, jcfg, tcfg, jp, tp, batch, _, ref = model
    _, tb = _split(batch)
    leaves = tree.leaves(tp)
    for remat in (False, True):
        live = [t.detach().requires_grad_() for t in leaves]
        loss, _ = tlm.loss_fn(tree.unflatten(tp, live), tcfg, tb,
                              remat=remat)
        grads = torch.autograd.grad(loss, live)
        for i, (g, w) in enumerate(zip(grads, ref["grads"], strict=True)):
            _close(g, w, f"{arch} remat={remat} gradient leaf {i}",
                   3 * ATOL, 3 * RTOL)


def test_prefill_matches_reference(model):
    """``prefill``'s (last_logits, enc_out) under each attention impl
    against the reference's through its flash kernel (interpret mode):
    Whisper's cross-attention reaches the kernel with Tq != Tk, not
    causal."""
    arch, jcfg, tcfg, jp, tp, batch, _, _ = model
    jb, tb = _split(batch)
    with jtuning.use_flags(attention_impl="pallas"):
        want, j_enc = jax.jit(jlm.prefill, static_argnums=1)(jp, jcfg, jb)
    for impl in ("pallas", "xla_packed", "xla_chunked"):
        with ttuning.use_flags(attention_impl=impl, q_block=8, kv_block=8), \
                torch.inference_mode():
            got, enc = tlm.prefill(tp, tcfg, tb)
        assert got.shape == (B, 1, tcfg.vocab)
        _close(got, want, f"{arch} prefill {impl}")
        if j_enc is None:
            assert enc is None
        else:
            assert enc.shape == (B, FRAMES, tcfg.d_model)
            _close(enc, j_enc, f"{arch} prefill {impl} enc_out")


def test_decode_steps_match_reference(model):
    """12 ``decode_step``s through the reference's jitted step and the
    port's, caches written in place; the port's against its own forward
    where the two compute the same (not Whisper, whose decode cross-attends
    to the zero cache nothing fills, nor LLaVA's patch positions)."""
    arch, jcfg, tcfg, jp, tp, batch, jengine, _ = model
    toks = batch["tokens"][:, :DECODE_STEPS]
    jc = jlm.init_decode_state(jcfg, B, SERVE["max_len"])
    tc = tlm.init_decode_state(tcfg, B, SERVE["max_len"], device="cpu")
    assert _shapes(jc) == jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tc)
    got = []
    for i in range(DECODE_STEPS):
        want, jc = jengine._decode(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                                   jnp.asarray(i, jnp.int32))
        with torch.inference_mode():
            logits, tc = tlm.decode_step(tp, tcfg,
                                         torch.from_numpy(toks[:, i:i + 1]),
                                         tc, i)
        _close(logits, want, f"{arch} decode step {i}")
        got.append(logits[:, 0])
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jc),
                            tree.leaves(tc), strict=True):
        _close(t, j, f"{arch} cache {jax.tree_util.keystr(path)}")
    if tcfg.encoder_layers:
        return
    full, _ = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(torch.stack(got, dim=1), full.detach(),
           f"{arch} decode vs forward", 2e-3, 2e-3)


def test_serve_engine_matches_reference(model):
    arch, jcfg, tcfg, jp, tp, _, jengine, _ = model
    want = [JRequest(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS]
    jengine.run(want)
    got = [Request(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS]
    ServeEngine(tp, tcfg, device="cpu", **SERVE).run(got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.out, g.done, g.truncated) == (w.out, w.done,
                                                w.truncated), (arch, i)


def test_zamba2_tail_matches_reference():
    """Zamba2 at 5 layers (2 groups of 2 and a tail of 1): forward against
    the reference's, and 8 decode steps against the port's forward."""
    fields = {"n_layers": 5}
    jcfg = dataclasses.replace(jconfigs.get("zamba2-7b").reduced(), **fields)
    tcfg = dataclasses.replace(tconfigs.get("zamba2-7b").reduced(), **fields)
    jp = jlm.init_params(jax.random.key(1), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = _batch(tcfg, seed=5)["tokens"][:, :8]
    want, _ = jax.jit(jlm.forward, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks)})
    full, _ = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(full, want, "zamba2 tail forward")
    caches = tlm.init_decode_state(tcfg, B, 8, device="cpu")
    assert caches["tail_mamba"]["ssm"].shape[0] == 1
    with torch.inference_mode():
        got = torch.cat([tlm.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, i:i + 1]), caches, i)[0] for i in range(8)], dim=1)
    _close(got, full.detach(), "zamba2 tail decode vs forward", 2e-3, 2e-3)


def test_cross_attention_flash_plain_matches_reference():
    """The flash kernel's plain version at a cross-attention shape (Tq 24
    against Tk 72, neither a multiple of the 64-key tile; not causal;
    GQA 4 / 2) against the reference's kernel in interpret mode."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 72, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(lambda q, k, v: jflash(
        q, k, v, causal=False, q_block=8, kv_block=16, interpret=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tref.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                     causal=False)
    _close(got, want, "flash plain, Tq 24 vs Tk 72, not causal", 2e-5, 2e-5)


@pytest.mark.parametrize("cell", sorted(jconfigs.SHAPE_CELLS))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_make_inputs_shapes_match_reference(arch, cell):
    """Every (arch × shape cell) at full size: the port's inputs on
    ``meta`` (nothing allocated) have the reference's tree, shapes and
    dtypes; a cell the config does not support raises in both."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jcell, tcell = jconfigs.SHAPE_CELLS[cell], tconfigs.SHAPE_CELLS[cell]
    if not jspecs.cell_supported(jcfg, jcell)[0]:
        for specs, cfg, c in ((jspecs, jcfg, jcell), (tspecs, tcfg, tcell)):
            with pytest.raises(ValueError, match="out of scope|meaningless"):
                specs.make_inputs(cfg, c)
        return
    j_kind, want = jspecs.make_inputs(jcfg, jcell)
    kind, got = tspecs.make_inputs(tcfg, tcell)
    assert kind == j_kind
    assert jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
        if isinstance(t, torch.Tensor) else t, got) == jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype))
        if hasattr(s, "shape") else s, want)
    assert all(t.device.type == "meta" for t in tree.leaves(got)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_arch_runs_every_entry_point(arch, tmp_path):
    """``init_params``, ``forward``, ``loss_fn``, ``prefill``,
    ``decode_step``, ``ServeEngine`` and two ``Trainer`` steps over
    ``synthetic_data`` (its batches carry the family's frames or patch
    embeddings) at the reduced config: finite, of the right shapes."""
    cfg = tconfigs.get(arch).reduced()
    params = tlm.init_params(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    logits, aux = tlm.forward(params, cfg, batch)
    loss, _ = tlm.loss_fn(params, cfg, batch)
    with torch.inference_mode():
        last, _ = tlm.prefill(params, cfg, batch)
        caches = tlm.init_decode_state(cfg, B, 4, device="cpu")
        step, _ = tlm.decode_step(params, cfg, batch["tokens"][:, :1],
                                  caches, 0)
    assert logits.shape == (B, T, cfg.vocab) and last.shape == step.shape \
        == (B, 1, cfg.vocab)
    assert all(bool(torch.isfinite(x).all()) for x in (logits, aux, loss,
                                                       last, step))
    reqs = [Request(prompt=[3, 1, 4], max_new_tokens=2)]
    ServeEngine(params, cfg, batch=2, max_len=16, device="cpu").run(reqs)
    assert reqs[0].done and len(reqs[0].out) == 2
    trainer = Trainer(cfg, AdamConfig(lr=1e-3), TrainerConfig(
        str(tmp_path), total_steps=2, checkpoint_every=2), device="cpu")
    data = tlaunch.synthetic_data(cfg, 2, 16, device="cpu")
    try:
        _, state = trainer.fit(data)
    finally:
        data.close()
    assert int(state["step"]) == 2
    assert trainer.manager.steps() == [2]


@pytest.mark.parametrize("arch", ZOO)
def test_launch_train_cli_runs_the_zoo(arch, tmp_path, capsys):
    tlaunch.main(["--arch", arch, "--reduced", "--steps", "2", "--batch",
                  "2", "--seq", "16", "--checkpoint-dir", str(tmp_path),
                  "--checkpoint-every", "2", "--remat", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("step 2: loss ")
    assert np.isfinite(float(lines[0].split()[-1]))
