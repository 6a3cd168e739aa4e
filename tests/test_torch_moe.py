"""Port parity: the MoE sublayer and the MoE LMs (mixtral-8x22b, top-2
``("attn_moe",)``, and llama4-maverick, top-1 with a shared expert,
``("attn_dense", "attn_moe")``) against the JAX reference on the CPU.

The same numpy parameters and inputs go through both packages at the
configs' reduced sizes: ``moe_apply`` under the three dispatches at
capacity factor 1.25 (a router scaled so that pairs are dropped) and 16
(nothing dropped), outputs, aux and gradients; equal router
probabilities (top-k ties); ``init_moe``'s tree; ``forward``, ``loss_fn``,
``prefill``, ``decode_step`` (one cache per pattern position) and
``ServeEngine``'s greedy tokens; ``lm_params_from_jax`` on the MoE trees in
f32 and bf16. Tolerances: ``tests/oracle.py`` TOLS, f32 (1e-4, 1e-5) and
bf16 (8e-2, 2e-2); a port's decode against its own forward 2e-3, as in
tests/test_torch_lm.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro import configs as jconfigs
from repro import tuning as jtuning
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch import tuning as ttuning
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Request, ServeEngine

ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b")
DISPATCHES = ("grouped", "scatter", "sharded_scatter")
BLOCKS = dict(q_block=8, kv_block=8)


def _close(got, want, what, tol="f32"):
    atol, rtol = TOLS[tol]
    np.testing.assert_allclose(np.asarray(got.detach().float(), np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get(arch).reduced(), **kw))


def _moe_params(cfg, seed, router_std=1.0):
    """MoE leaves drawn by numpy; expert 0's router column points along
    ``_SKEW`` (see :func:`_skewed_x`)."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    router = rng.normal(0, router_std, (d, e))
    router[:, 0] += 0.5 * _SKEW[:d]
    p = {"router": router,
         "w_gate": rng.normal(0, 0.1, (e, d, f)),
         "w_up": rng.normal(0, 0.1, (e, d, f)),
         "w_down": rng.normal(0, 0.1, (e, f, d))}
    if cfg.shared_expert:
        p["shared"] = {"w_gate": rng.normal(0, 0.1, (d, f)),
                       "w_up": rng.normal(0, 0.1, (d, f)),
                       "w_down": rng.normal(0, 0.1, (f, d))}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


_SKEW = np.random.default_rng(99).normal(size=512)


def _skewed_x(shape, seed):
    """Tokens with a common component along ``_SKEW``: most of them route
    to expert 0 first, so capacity 1.25 drops pairs there."""
    x = np.random.default_rng(seed).normal(size=shape)
    return (x + 0.5 * _SKEW[:shape[-1]]).astype(np.float32)


def _ref_moe(p, cfg, x, dispatch, cf):
    with jtuning.use_flags(moe_dispatch=dispatch):
        def f(p, x):
            out, aux = jlayers.moe_apply(p, cfg, x, capacity_factor=cf)
            return jnp.sum(out * jnp.cos(out)) + aux, (out, aux)
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return out, aux, grads


def _port_moe(p, cfg, x, dispatch, cf):
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    with ttuning.use_flags(moe_dispatch=dispatch):
        out, aux = tlayers.moe_apply(tp, cfg, tx, capacity_factor=cf)
    loss = torch.sum(out * torch.cos(out)) + aux
    leaves = tree.leaves(tp) + [tx]
    grads = torch.autograd.grad(loss, leaves)
    return out, aux, grads


@pytest.mark.parametrize("cf", (1.25, 16.0))
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dispatch, cf):
    jcfg, tcfg = _cfgs(arch)
    p = _moe_params(tcfg, seed=len(arch))
    x = _skewed_x((2, 40, tcfg.d_model), seed=7)
    want, aux_w, (gp, gx) = _ref_moe(p, jcfg, x, dispatch, cf)
    got, aux_g, grads = _port_moe(p, tcfg, x, dispatch, cf)
    _close(got, want, f"{arch} {dispatch} cf {cf} out")
    _close(aux_g, aux_w, f"{arch} {dispatch} cf {cf} aux")
    for name, g, w in zip(["/".join(map(str, k)) for k, _ in
                           jax.tree_util.tree_flatten_with_path(gp)[0]]
                          + ["x"], grads, jax.tree.leaves(gp) + [gx]):
        _close(g, w, f"{arch} {dispatch} cf {cf} d{name}")
    if cf == 1.25:
        # the skewed routing drops pairs here: the output is not cf 16's
        full, _, _ = _port_moe(p, tcfg, x, dispatch, 16.0)
        assert not torch.allclose(got, full)


@pytest.mark.parametrize("dispatch", ("grouped", "scatter"))
def test_moe_apply_bf16_matches_reference(dispatch):
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    p = _moe_params(tcfg, seed=3, router_std=0.3)
    x = np.random.default_rng(8).normal(size=(2, 24, tcfg.d_model))
    bf = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), p)
    bf["router"] = p["router"]
    xb = x.astype(ml_dtypes.bfloat16)
    with jtuning.use_flags(moe_dispatch=dispatch):
        want, aux_w = jax.jit(lambda p, x: jlayers.moe_apply(p, jcfg, x))(
            jax.tree.map(jnp.asarray, bf), jnp.asarray(xb))
    tp = jax.tree.map(lambda a: torch.from_numpy(a), p)
    tp = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    with ttuning.use_flags(moe_dispatch=dispatch):
        got, aux_g = tlayers.moe_apply(
            tp, tcfg, torch.from_numpy(xb.astype(np.float32)).to(
                torch.bfloat16))
    assert got.dtype == torch.bfloat16 and aux_g.dtype == torch.float32
    _close(got, want, f"bf16 {dispatch}", tol="bf16")
    _close(aux_g, aux_w, f"bf16 {dispatch} aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_equal_router_probabilities_pick_the_lower_experts(arch):
    """A zero router gives every expert the same probability: the top k
    are the lowest ids in both packages (``lax.top_k``'s tie order)."""
    jcfg, tcfg = _cfgs(arch)
    p = _moe_params(tcfg, seed=1)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(2).normal(
        size=(1, 12, tcfg.d_model)).astype(np.float32)
    want, aux_w, _ = _ref_moe(p, jcfg, x, "grouped", 16.0)
    got, aux_g, _ = _port_moe(p, tcfg, x, "grouped", 16.0)
    _close(got, want, f"{arch} tied router")
    _close(aux_g, aux_w, f"{arch} tied router aux")
    _, eids, _ = tlayers._route({"router": torch.zeros(
        (tcfg.d_model, tcfg.n_experts))}, tcfg, torch.zeros((3, tcfg.d_model)))
    assert eids.tolist() == [list(range(tcfg.top_k))] * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    want = jlayers.init_moe(jax.random.key(0), jcfg, jnp.bfloat16)
    got = tlayers.init_moe(tcfg, torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), want) == \
        tree.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).replace("torch.", "")), got)
    assert 0.015 < float(got["w_up"].float().std()) < 0.025


@functools.cache
def _ref_params(jcfg, seed):
    """The reference's ``init_params`` (immutable arrays), drawn once per
    config and seed in a process."""
    return jlm.init_params(jax.random.key(seed), jcfg)


def _lm_pair(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = _ref_params(jcfg, seed)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              tcfg, device="cpu")


@pytest.mark.parametrize("dispatch", ("grouped", "scatter"))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_forward_loss_and_prefill_match_reference(arch, dispatch):
    jcfg, tcfg, jp, tp = _lm_pair(arch)
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 21))
    bj = {"tokens": jnp.asarray(tokens, jnp.int32)}
    bt = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    with jtuning.use_flags(moe_dispatch=dispatch, **BLOCKS):
        (want, aux_j), (loss_j, m_j), (last_j, _) = jax.jit(
            lambda p, b: (jlm.forward(p, jcfg, b), jlm.loss_fn(p, jcfg, b),
                          jlm.prefill(p, jcfg, b)))(jp, bj)
    with ttuning.use_flags(moe_dispatch=dispatch, **BLOCKS):
        got, aux_t = tlm.forward(tp, tcfg, bt)
        loss_t, m_t = tlm.loss_fn(tp, tcfg, bt)
        last_t, enc = tlm.prefill(tp, tcfg, bt)
    assert enc is None and float(aux_t) > 0
    _close(got, want, f"{arch} forward")
    _close(aux_t, aux_j, f"{arch} aux")
    _close(last_t, last_j, f"{arch} prefill")
    _close(loss_t, loss_j, f"{arch} loss")
    for k in ("nll", "aux", "tokens"):
        _close(m_t[k], m_j[k], f"{arch} metric {k}")


SERVE = dict(batch=2, max_len=24)


@functools.cache
def _ref_engine(jcfg):
    """The reference's ``ServeEngine`` of ``jcfg`` (its jitted decode step
    compiled once in a process: the decode test steps through it too)."""
    return JEngine(None, jcfg, **SERVE)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_decode_steps_match_reference_and_own_forward(arch):
    jcfg, tcfg, jp, tp = _lm_pair(arch, seed=1)
    t = 10
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab, (2, t))
    jc = jlm.init_decode_state(jcfg, 2, SERVE["max_len"])
    tc = tlm.init_decode_state(tcfg, 2, SERVE["max_len"], device="cpu")
    assert sorted(tc) == [str(i) for i in range(len(tcfg.block_pattern))]
    assert jax.tree.map(np.shape, jc) == tree.tree_map(
        lambda x: tuple(x.shape), tc)
    step_j = _ref_engine(jcfg)._decode
    got = []
    for i in range(t):
        tok = tokens[:, i:i + 1]
        lj, jc = step_j(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(i, jnp.int32))
        lt, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc, i)
        _close(lt, lj, f"{arch} decode step {i}")
        got.append(lt[:, 0])
    for key in tc:
        _close(tc[key]["k"], jc[key]["k"], f"{arch} cache {key}")
    want, _ = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(),
                               want.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_engine_greedy_tokens_equal_the_reference(arch):
    jcfg, tcfg, jp, tp = _lm_pair(arch, seed=2)
    prompts = [([5, 9, 200, 3], 5), ([17], 3), ([42, 7, 99], 4)]
    want = [JRequest(prompt=list(p), max_new_tokens=n) for p, n in prompts]
    engine = _ref_engine(jcfg)
    engine.params = jp
    engine.run(want)
    got = [Request(prompt=list(p), max_new_tokens=n) for p, n in prompts]
    ServeEngine(tp, tcfg, device="cpu", **SERVE).run(got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.out, g.done, g.truncated) == (w.out, w.done, w.truncated), i


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_jax_carries_the_moe_leaves(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(3), jcfg))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    key = f"{len(tcfg.block_pattern) - 1}_attn_moe"
    moe_j, moe_t = jp["blocks"][key]["moe"], tp["blocks"][key]["moe"]
    assert moe_t["router"].dtype == torch.float32
    assert moe_t["w_gate"].dtype == tlm._dtype(tcfg)
    assert ("shared" in moe_t) == tcfg.shared_expert
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tree.leaves(tp)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32), err_msg=str(path))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda s: s[0], tlm.param_shapes(tcfg),
        is_leaf=lambda s: isinstance(s, tuple))
    bad = jax.tree.map(lambda a: a, jp)
    bad["blocks"][key]["moe"]["router"] = moe_j["router"].astype(
        ml_dtypes.bfloat16)
    with pytest.raises(ValueError, match="router: dtype bfloat16"):
        lm_params_from_jax(bad, tcfg, device="cpu")
    bad = jax.tree.map(lambda a: a, jp)
    del bad["blocks"][key]["moe"]["w_up"]
    with pytest.raises(ValueError, match="moe: leaves"):
        lm_params_from_jax(bad, tcfg, device="cpu")
