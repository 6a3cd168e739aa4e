"""Port parity: the LM zoo's attention-free mixers (``models/ssm``:
RWKV-6 and Mamba2 with its chunked SSD form) against the JAX reference on
the CPU.

The reference's ``init_rwkv`` / ``init_mamba`` parameters (reduced rwkv6 and
zamba2 configs, f32) and the same numpy inputs and non-zero starting states
go through both packages: ``rwkv_apply``, and ``mamba_apply`` by its scan and
at chunks 8, 16 and 32, outputs and new states within ``tests/oracle.py``
TOLS["f32"]. Also: the leaves' shapes, dtypes and initializers, the state
shapes, the ``mamba_chunk`` flag's rule, and the serving loop (grad mode off,
preallocated outputs) against the training loop bit for bit.
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
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import tuning as ttuning
from repro_torch.models import ssm as tssm

ATOL, RTOL = TOLS["f32"]
B, T = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small tensors: the test
    workers share the cores, and a thread pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _mixer(arch, init, state_init, seed):
    """(cfg, reference params, port params, x, state as numpy) for one
    mixer: random inputs and a random (non-zero) starting state."""
    cfg = tconfigs.get(arch).reduced()
    jcfg = jconfigs.get(arch).reduced()
    jp = jax.jit(init, static_argnums=(1, 2))(jax.random.key(seed), jcfg,
                                              jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    state = {k: 0.5 * rng.standard_normal(np.shape(v)).astype(np.float32)
             for k, v in state_init(jcfg, B).items()}
    return jcfg, cfg, jp, _torch(jax.tree.map(np.asarray, jp)), x, state


@pytest.fixture(scope="module")
def rwkv():
    return _mixer("rwkv6-1.6b", jssm.init_rwkv, jssm.rwkv_state_init, 0)


@pytest.fixture(scope="module")
def mamba():
    return _mixer("zamba2-7b", jssm.init_mamba, jssm.mamba_state_init, 1)


def _check(got, want, what):
    out, state = got
    j_out, j_state = want
    _close(out, j_out, f"{what}: out")
    assert sorted(state) == sorted(j_state)
    for k in j_state:
        assert state[k].dtype == torch.float32, k
        _close(state[k], j_state[k], f"{what}: state {k}")


def test_rwkv_apply_matches_reference(rwkv):
    jcfg, cfg, jp, tp, x, state = rwkv
    want = jax.jit(jssm.rwkv_apply, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    got = tssm.rwkv_apply(tp, cfg, torch.from_numpy(x), _torch(state))
    _check(got, want, "rwkv_apply")


@pytest.mark.parametrize("chunk", (0, 8, 16, 32))
def test_mamba_apply_matches_reference(mamba, chunk):
    jcfg, cfg, jp, tp, x, state = mamba
    want = jax.jit(jssm.mamba_apply, static_argnums=1,
                   static_argnames="chunk")(
        jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state),
        chunk=chunk)
    got = tssm.mamba_apply(tp, cfg, torch.from_numpy(x), _torch(state),
                           chunk=chunk)
    _check(got, want, f"mamba_apply chunk={chunk}")


def test_mamba_chunk_flag_is_read_where_it_divides(mamba):
    """The flag picks the chunked form only where it divides T > 1: the
    results equal an explicit ``chunk`` bit for bit, else the scan's; and
    the reference reads it the same way."""
    jcfg, cfg, jp, tp, x, state = mamba
    xt, st = torch.from_numpy(x), _torch(state)
    for t, flag, chunk in ((T, 8, 8), (T, 12, 0), (1, 8, 0)):
        want = tssm.mamba_apply(tp, cfg, xt[:, :t], st, chunk=chunk)
        with ttuning.use_flags(mamba_chunk=flag):
            got = tssm.mamba_apply(tp, cfg, xt[:, :t], st)
        assert torch.equal(got[0], want[0]), (t, flag)
        assert torch.equal(got[1]["ssm"], want[1]["ssm"]), (t, flag)
    with jtuning.use_flags(mamba_chunk=8):
        j_got = jax.jit(jssm.mamba_apply, static_argnums=1)(
            jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    with ttuning.use_flags(mamba_chunk=8):
        got = tssm.mamba_apply(tp, cfg, xt, st)
    _check(got, j_got, "mamba_apply under mamba_chunk=8")


def test_chunked_and_scan_agree_and_serving_loop_is_the_training_loop(
        rwkv, mamba):
    """The chunked SSD form against the port's own scan (f32 tolerance: the
    sums run in other orders), and each loop where autograd records
    nothing (preallocated outputs, as in serving) against the same loop
    under grad (Mamba2's stacked outputs, RWKV's ``_WKV``), bit for
    bit."""
    _, cfg, _, tp, x, state = mamba
    xt, st = torch.from_numpy(x), _torch(state)
    scan = tssm.mamba_apply(tp, cfg, xt.clone().requires_grad_(), st)
    scan = (scan[0].detach(), {k: v.detach() for k, v in scan[1].items()})
    chunked = tssm.mamba_apply(tp, cfg, xt, st, chunk=16)
    _check(chunked, (scan[0].numpy(), {k: v.numpy()
                                       for k, v in scan[1].items()}),
           "chunk 16 vs scan")
    with torch.inference_mode():
        served = tssm.mamba_apply(tp, cfg, xt, st)
    assert torch.equal(served[0], scan[0])
    assert torch.equal(served[1]["ssm"], scan[1]["ssm"])
    _, rcfg, _, rp, rx, rstate = rwkv
    xr = torch.from_numpy(rx).requires_grad_()
    trained = tssm.rwkv_apply(rp, rcfg, xr, _torch(rstate))
    with torch.inference_mode():
        served = tssm.rwkv_apply(rp, rcfg, torch.from_numpy(rx),
                                 _torch(rstate))
    assert torch.equal(served[0], trained[0].detach())
    assert torch.equal(served[1]["wkv"], trained[1]["wkv"].detach())
    # the loop under grad differentiates through the carried state
    trained[0].sum().backward()
    assert xr.grad is not None and bool(torch.isfinite(xr.grad).all())


@pytest.mark.parametrize("kind", ("rwkv", "mamba"))
def test_leaves_states_and_initializers_match_reference(kind):
    arch = {"rwkv": "rwkv6-1.6b", "mamba": "zamba2-7b"}[kind]
    jinit = {"rwkv": jssm.init_rwkv, "mamba": jssm.init_mamba}[kind]
    tinit = {"rwkv": tssm.init_rwkv, "mamba": tssm.init_mamba}[kind]
    jstate = {"rwkv": jssm.rwkv_state_init,
              "mamba": jssm.mamba_state_init}[kind]
    tstate = {"rwkv": tssm.rwkv_state_init,
              "mamba": tssm.mamba_state_init}[kind]
    for cfg_t, cfg_j in ((tconfigs.get(arch).reduced(),
                          jconfigs.get(arch).reduced()),
                         (dataclasses.replace(tconfigs.get(arch), dtype=
                                              "float32", vocab=8),
                          dataclasses.replace(jconfigs.get(arch), dtype=
                                              "float32", vocab=8))):
        for dt_j, dt_t in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
            want = jax.eval_shape(lambda: jinit(jax.random.key(0), cfg_j,
                                                dt_j))
            shapes = {"rwkv": tssm.rwkv_shapes,
                      "mamba": tssm.mamba_shapes}[kind](cfg_t, dt_t)
            assert jax.tree.map(lambda s: (s.shape, str(s.dtype)), want) == \
                jax.tree.map(lambda s: (s[0], str(s[1]).replace(
                    "torch.", "")), shapes, is_leaf=lambda s: isinstance(
                        s, tuple)), (kind, cfg_t.name, dt_t)
        assert jax.tree.map(np.shape, jstate(cfg_j, 3)) == jax.tree.map(
            lambda t: tuple(t.shape), tstate(cfg_t, 3, device="meta"))
    cfg_t, cfg_j = tconfigs.get(arch).reduced(), jconfigs.get(arch).reduced()
    got = tinit(cfg_t, torch.float32,
                generator=torch.Generator().manual_seed(0), device="cpu")
    ref = jax.jit(jinit, static_argnums=(1, 2))(jax.random.key(0), cfg_j,
                                                jnp.float32)
    if kind == "rwkv":
        assert torch.equal(got["w0"], torch.full_like(got["w0"], -6.0))
        for name, lo, hi in (("mu", 0, 1), ("cm_mu", 0, 1), ("u", -0.5, 0.5)):
            assert lo <= float(got[name].min()) < float(got[name].max()) < hi
        assert torch.equal(got["ln_x"]["scale"],
                           torch.ones_like(got["ln_x"]["scale"]))
    else:
        np.testing.assert_allclose(got["a_log"].numpy(),
                                   np.asarray(ref["a_log"]), rtol=1e-6)
        assert torch.equal(got["dt_bias"], torch.zeros_like(got["dt_bias"]))
        assert torch.equal(got["d_skip"], torch.ones_like(got["d_skip"]))
    w = got["wr" if kind == "rwkv" else "in_proj_zx"]
    assert 0.015 < float(w.std()) < 0.025


def test_chunked_gradient_is_finite_where_the_reference_is_nan(mamba):
    """The chunked SSD's masked factor: the reference's ``where(causal,
    exp(rel), 0)`` overflows above the diagonal and its gradient is NaN
    (a_log, dt_bias, in_proj_dt); the port's ``exp`` of the masked
    exponent has the same values and finite gradients, those of the scan
    (3x TOLS["f32"])."""
    jcfg, cfg, jp, tp, x, state = mamba
    x = 4.0 * x                   # decays far enough apart to overflow
    j_grad = jax.jit(jax.grad(lambda p: jssm.mamba_apply(
        p, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state),
        chunk=16)[0].sum()))(jp)
    assert bool(jnp.isnan(j_grad["a_log"]).any())
    grads = {}
    for chunk in (0, 16):
        live = {k: v.clone().requires_grad_() if k != "norm" else v
                for k, v in tp.items()}
        out, _ = tssm.mamba_apply(live, cfg, torch.from_numpy(x),
                                  _torch(state), chunk=chunk)
        out.sum().backward()
        grads[chunk] = {k: v.grad for k, v in live.items() if k != "norm"}
    for k, g in grads[16].items():
        assert bool(torch.isfinite(g).all()), k
        np.testing.assert_allclose(g.numpy(), grads[0][k].numpy(),
                                   atol=3 * ATOL, rtol=3 * RTOL, err_msg=k)


def test_rwkv_gradients_match_reference(rwkv):
    """Gradients through the recurrence (the port's backward walks the
    steps in reverse by hand): of every parameter, the input and the
    starting wkv state, with a loss on the output and on the new state,
    against ``jax.grad`` of the reference (3x TOLS["f32"])."""
    jcfg, cfg, jp, tp, x, state = rwkv

    def j_loss(p, x, wkv):
        out, new = jssm.rwkv_apply(p, jcfg, x, {**jax.tree.map(
            jnp.asarray, state), "wkv": wkv})
        return jnp.sum(out * jnp.cos(out)) + jnp.sum(new["wkv"] ** 2)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(x), jnp.asarray(state["wkv"]))
    live = {k: (v.clone().requires_grad_() if isinstance(v, torch.Tensor)
                else {kk: vv.clone().requires_grad_()
                      for kk, vv in v.items()}) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    st = _torch(state)
    st["wkv"].requires_grad_()
    out, new = tssm.rwkv_apply(live, cfg, xt, st)
    (torch.sum(out * torch.cos(out)) + torch.sum(new["wkv"] ** 2)).backward()
    got_p = {k: (v.grad if isinstance(v, torch.Tensor)
                 else {kk: vv.grad for kk, vv in v.items()})
             for k, v in live.items()}
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want[0]),
                            jax.tree.leaves(got_p), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3 * ATOL,
                                   rtol=3 * RTOL,
                                   err_msg=jax.tree_util.keystr(path))
    for g, w, name in ((xt.grad, want[1], "x"), (st["wkv"].grad, want[2],
                                                  "wkv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3 * ATOL,
                                   rtol=3 * RTOL, err_msg=name)
