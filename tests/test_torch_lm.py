"""Port parity: the LM zoo's decoder-only dense path (``configs``,
``tuning``, ``data/tokens``, ``models/layers``, ``models/lm``,
``convert.lm_params_from_jax``) against the JAX reference on the CPU.

The same numpy parameters (the reference's ``init_params`` converted with
``lm_params_from_jax``) and the same numpy inputs go through both packages,
at the configs' reduced (f32) sizes: the norms and RoPE, the two plain
attention impls, ``attention_apply`` under all three ``attention_impl``s
(the reference's flash kernel in interpret mode, the port's plain version)
and in decode with a window ring buffer, ``forward``, ``prefill`` and a
sequence of ``decode_step``s for llama3-8b and qwen3-14b (qk-norm). Small
attention blocks (``q_block = kv_block = 16``) put several blocks in play.
Tolerance: ``tests/oracle.py`` f32 (1e-4, 1e-5), for outputs whose sums the
two packages take in other orders; a port's decode against its own forward
2e-3, the reference test's.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from oracle import TOLS
from repro import configs as jconfigs
from repro import tuning as jtuning
from repro.data import tokens as jtokens
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import tuning as ttuning
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import tokens as ttokens
from repro_torch.distributed import lm_mesh as tlm_mesh
from repro_torch.distributed import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ATOL, RTOL = TOLS["f32"]
IMPLS = ("xla_packed", "xla_chunked", "pallas")
BLOCKS = dict(q_block=16, kv_block=16)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _cfg(arch, **kw):
    """The reduced config in both packages (equal fields)."""
    j = dataclasses.replace(jconfigs.get(arch).reduced(), **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(), **kw)
    return j, t


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")


# ---------------------------------------------------------------------------
# configs, tuning, tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.n_blocks, t.sub_quadratic) == (j.n_blocks, j.sub_quadratic)


def test_registry_shape_cells_and_tune_flags_match_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPE_CELLS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPE_CELLS.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("gpt-2")
    assert dataclasses.asdict(ttuning.TuneFlags()) == dataclasses.asdict(
        jtuning.TuneFlags())
    pairs = ["q_block=256", "constrain_decode=false", "capacity_factor=2.5",
             "attention_impl=pallas"]
    assert ttuning.parse_tune_args(pairs) == jtuning.parse_tune_args(pairs)
    with pytest.raises(KeyError, match="unknown tune flag"):
        ttuning.parse_tune_args(["nope=1"])
    with ttuning.use_flags(attention_impl="pallas", q_block=8) as fl:
        assert fl.attention_impl == ttuning.flags().attention_impl == "pallas"
    assert ttuning.flags() == ttuning.TuneFlags()
    # every field has a reader: none raises. fsdp splits the mesh train
    # step's parameters over "data" (constrain_decode's reader, the
    # sequence-parallel decode, runs in tests/test_torch_lm_mesh.py)
    assert ttuning.UNPORTED == {}
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    cfg = tconfigs.get("llama3-8b").reduced()
    data_split = []
    for pair in ("constrain_decode=false", "fsdp=true", "fsdp=false"):
        with ttuning.use_flags(**ttuning.parse_tune_args([pair])) as fl:
            assert ttuning.flags() == fl
            specs = tsteps.train_shards(cfg, mesh).params
            data_split.append(sum(isinstance(p[0], Shard) for p in
                                  tlm_mesh.spec_leaves(specs)))
    assert data_split[1] > 0 == data_split[0] == data_split[2], data_split
    assert ttuning.flags() == ttuning.TuneFlags()
    # the Mamba2 mixer reads mamba_chunk: set, it takes the chunked form
    cfg = tconfigs.get("zamba2-7b").reduced()
    mixer = tssm.init_mamba(cfg, torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    state = tssm.mamba_state_init(cfg, 1, device="cpu")
    x = torch.randn((1, 128, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    chunks, ssd = [], tssm._ssd_chunked
    tssm._ssd_chunked = lambda *a: chunks.append(a[-1]) or ssd(*a)
    try:
        with ttuning.use_flags(**ttuning.parse_tune_args(["mamba_chunk=64"])):
            assert ttuning.flags().mamba_chunk == 64
            flagged = tssm.mamba_apply(mixer, cfg, x, state)[0]
        assert chunks == [64]
        tssm.mamba_apply(mixer, cfg, x, state)          # the scan
        assert chunks == [64]
    finally:
        tssm._ssd_chunked = ssd
    assert torch.equal(flagged,
                       tssm.mamba_apply(mixer, cfg, x, state, chunk=64)[0])
    assert ttuning.flags() == ttuning.TuneFlags()
    with ttuning.use_flags(moe_dispatch="grouped", fsdp=False):
        assert ttuning.flags() == ttuning.TuneFlags()
    # LM training and MoE read theirs
    with ttuning.use_flags(**ttuning.parse_tune_args(
            ["remat_policy=dots", "moe_dispatch=scatter",
             "capacity_factor=2.5"])) as fl:
        assert (fl.remat_policy, fl.moe_dispatch, fl.capacity_factor) == (
            "dots", "scatter", 2.5)


@pytest.mark.parametrize("spec", [
    dict(vocab=256, batch=3, seq_len=40, seed=0),
    dict(vocab=128256, batch=2, seq_len=64, seed=5, noise=0.3, shard=1,
         num_shards=2),
])
def test_make_batch_is_bitwise_the_reference(spec):
    for step in (0, 7):
        want = jtokens.make_batch(jtokens.TokenStreamSpec(**spec), step)
        got = ttokens.make_batch(ttokens.TokenStreamSpec(**spec), step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=(16,)).astype(np.float32),
         "bias": rng.normal(size=(16,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(tlayers.rms_norm(tp, torch.from_numpy(x), 1e-6),
           jlayers.rms_norm(p, jnp.asarray(x), 1e-6), "rms_norm")
    _close(tlayers.layer_norm(tp, torch.from_numpy(x)),
           jlayers.layer_norm(p, jnp.asarray(x)), "layer_norm")
    pos = rng.integers(0, 5000, size=(2, 9)).astype(np.int32)
    for theta in (1e4, 5e5):
        _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta),
               f"rope theta {theta}", atol=1e-4, rtol=1e-4)
    for fn in ("init_rms_norm", "init_layer_norm"):
        want = getattr(jlayers, fn)(16)
        got = getattr(tlayers, fn)(16)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("causal,window,q_offset,tq", [
    (True, 0, 0, 40), (True, 12, 0, 37), (False, 0, 0, 21),
    (True, 0, 9, 23), (False, 10, 0, 40)])
def test_chunked_attention_matches_reference(causal, window, q_offset, tq):
    rng = np.random.default_rng(tq + window)
    q = rng.normal(size=(2, tq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, **BLOCKS)
    want = jlayers.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tlayers.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want, "chunked_attention")


@pytest.mark.parametrize("window,t,block", [(0, 40, 16), (12, 45, 8),
                                            (0, 30, 0), (20, 64, 16)])
def test_packed_causal_attention_matches_reference(window, t, block):
    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(size=(2, t, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = jlayers.packed_causal_attention(
        *map(jnp.asarray, (q, k, v)), window=window, block=block)
    got = tlayers.packed_causal_attention(
        *map(torch.from_numpy, (q, k, v)), window=window, block=block)
    _close(got, want, "packed_causal_attention")
    # and the same function as the plain blocked loop
    chunked = tlayers.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True, window=window,
        q_block=block or 1024, kv_block=block or 1024)
    _close(got, chunked.numpy(), "packed vs chunked")


def _attn_params(tcfg, seed):
    rng = np.random.default_rng(seed)
    d, h, kv, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    p = {"wq": rng.normal(0, 0.2, (d, h * hd)), "wk": rng.normal(0, 0.2, (d, kv * hd)),
         "wv": rng.normal(0, 0.2, (d, kv * hd)), "wo": rng.normal(0, 0.2, (h * hd, d))}
    if tcfg.qk_norm:
        p["q_norm"] = {"scale": rng.normal(1, 0.1, (hd,))}
        p["k_norm"] = {"scale": rng.normal(1, 0.1, (hd,))}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return p, jax.tree.map(torch.from_numpy, p)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch,window", [("llama3-8b", 0), ("qwen3-14b", 0),
                                         ("llama3-8b", 16)])
def test_attention_apply_matches_reference(arch, window, impl):
    jcfg, tcfg = _cfg(arch, window=window)
    jp, tp = _attn_params(tcfg, seed=window + len(arch))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(37), (2, 37)).astype(np.int32)
    with jtuning.use_flags(attention_impl=impl, **BLOCKS):
        want, _ = jlayers.attention_apply(jp, jcfg, jnp.asarray(x),
                                          positions=jnp.asarray(pos))
    with ttuning.use_flags(attention_impl=impl, **BLOCKS):
        got, cache = tlayers.attention_apply(tp, tcfg, torch.from_numpy(x),
                                             positions=torch.from_numpy(pos))
    assert cache is None
    _close(got, want, f"{arch} window {window} {impl}")


def test_decode_attention_ring_buffer_matches_reference():
    """Decode through a window ring buffer of 8 slots (window 5) for 20
    steps: the wrap-around, the slot ages and the cache itself."""
    jcfg, tcfg = _cfg("llama3-8b", window=5)
    jp, tp = _attn_params(tcfg, seed=3)
    rng = np.random.default_rng(2)
    shape = (2, 8, tcfg.n_kv_heads, tcfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    step_j = jax.jit(lambda x, pos, c, i: jlayers.attention_apply(
        jp, jcfg, x, positions=pos, kv_cache=c, cache_pos=i))
    for step in range(20):
        x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        pos = np.full((2, 1), step, np.int32)
        want, jc = step_j(jnp.asarray(x), jnp.asarray(pos), jc,
                          jnp.asarray(step, jnp.int32))
        got, tc2 = tlayers.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
            kv_cache=tc, cache_pos=step)
        assert tc2 is tc                  # written in place
        _close(got, want, f"decode step {step}")
        _close(tc["k"], jc["k"], f"cache k after step {step}")
        _close(tc["v"], jc["v"], f"cache v after step {step}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-14b"])
def test_forward_and_prefill_match_reference(arch, impl):
    jcfg, tcfg = _cfg(arch)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 21))
    batch_j = {"tokens": jnp.asarray(tokens, jnp.int32)}
    batch_t = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    with jtuning.use_flags(attention_impl=impl, **BLOCKS):
        want, aux_j = jlm.forward(jp, jcfg, batch_j)
        last_j, enc_j = jlm.prefill(jp, jcfg, batch_j)
    with ttuning.use_flags(attention_impl=impl, **BLOCKS):
        got, aux_t = tlm.forward(tp, tcfg, batch_t)
        last_t, enc_t = tlm.prefill(tp, tcfg, batch_t)
    assert got.shape == want.shape and last_t.shape == last_j.shape == (
        2, 1, tcfg.vocab)
    assert enc_t is None and enc_j is None
    assert float(aux_t) == float(aux_j) == 0.0
    _close(got, want, f"{arch} {impl} forward")
    _close(last_t, last_j, f"{arch} {impl} prefill")


@pytest.mark.parametrize("arch,window", [("llama3-8b", 0), ("qwen3-14b", 0),
                                         ("llama3-8b", 4)])
def test_decode_steps_match_reference_and_own_forward(arch, window):
    jcfg, tcfg = _cfg(arch, window=window)
    jp, tp = _params(jcfg, tcfg, seed=1)
    t = 12
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab, (2, t))
    jc = jlm.init_decode_state(jcfg, 2, t)
    tc = tlm.init_decode_state(tcfg, 2, t, device="cpu")
    assert jax.tree.map(np.shape, jc) == {
        k: {kk: tuple(vv.shape) for kk, vv in v.items()} for k, v in tc.items()}
    step_j = jax.jit(lambda p, tok, c, i: jlm.decode_step(p, jcfg, tok, c, i))
    got = []
    for i in range(t):
        tok = tokens[:, i:i + 1]
        lj, jc = step_j(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(i, jnp.int32))
        lt, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc, i)
        _close(lt, lj, f"{arch} decode step {i}")
        got.append(lt[:, 0])
    _close(tc["0"]["k"], jc["0"]["k"], "caches")
    want, _ = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    _close(torch.stack(got, dim=1), want.numpy(), "decode vs forward",
           atol=2e-3, rtol=2e-3)


def test_lm_params_from_jax_checks_names_shapes_and_keeps_bf16_exact():
    jcfg = jconfigs.get("qwen3-14b").reduced()
    tcfg = tconfigs.get("qwen3-14b").reduced()
    bf = dataclasses.replace(jcfg, dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(2), bf))
    tp = lm_params_from_jax(jp, dataclasses.replace(tcfg, dtype="bfloat16"),
                            device="cpu")
    wq = jp["blocks"]["0_attn_dense"]["attn"]["wq"]
    assert wq.dtype == ml_dtypes.bfloat16
    got = tp["blocks"]["0_attn_dense"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), wq.astype(np.float32))
    assert tp["final_norm"]["scale"].dtype == torch.float32
    shapes = tlm.param_shapes(tcfg)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda s: s[0], shapes, is_leaf=lambda s: isinstance(s, tuple))
    bad = dict(jp, lm_hed=jp["lm_head"])
    del bad["lm_head"]
    with pytest.raises(ValueError, match="lm_hed"):
        lm_params_from_jax(bad, tcfg, device="cpu")
    tbf = dataclasses.replace(tcfg, dtype="bfloat16")
    bad = jax.tree.map(lambda a: a, jp)
    bad["blocks"]["0_attn_dense"]["ffn"]["w_up"] = wq
    with pytest.raises(ValueError, match="w_up: shape"):
        lm_params_from_jax(bad, tbf, device="cpu")
    # a tree cast to f32 does not pass for the bf16 config, nor a bf16 norm
    with pytest.raises(ValueError, match="embed: dtype float32, expected "
                                         "torch.bfloat16"):
        lm_params_from_jax(jax.tree.map(lambda a: a.astype(np.float32), jp),
                           tbf, device="cpu")
    bad = jax.tree.map(lambda a: a, jp)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"].astype(
        ml_dtypes.bfloat16)
    with pytest.raises(ValueError, match="final_norm.scale: dtype bfloat16"):
        lm_params_from_jax(bad, tbf, device="cpu")
    no_qk = jax.tree.map(np.asarray, jlm.init_params(
        jax.random.key(0), jconfigs.get("llama3-8b").reduced()))
    with pytest.raises(ValueError, match="q_norm"):
        lm_params_from_jax(no_qk, tcfg, device="cpu")


def test_init_params_module_and_unported_paths():
    tcfg = tconfigs.get("llama3-8b").reduced()
    p = tlm.init_params(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    jp = jlm.init_params(jax.random.key(0), jconfigs.get("llama3-8b").reduced())
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), p)
    assert jax.tree.map(lambda a: str(np.asarray(a).dtype), jp) == \
        jax.tree.map(lambda t: str(t.dtype).replace("torch.", ""), p)
    assert torch.equal(p["final_norm"]["scale"], torch.ones(tcfg.d_model))
    assert 0.015 < float(p["embed"].std()) < 0.025
    again = tlm.init_params(tcfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(again["lm_head"], p["lm_head"])
    model = tlm.LM(tcfg, p)
    names = dict(model.named_parameters())
    assert "blocks.0_attn_dense.attn.wq" in names and "embed" in names
    tokens = torch.randint(0, tcfg.vocab, (2, 5))
    torch.testing.assert_close(model(tokens),
                               tlm.forward(p, tcfg, {"tokens": tokens})[0])
    # the zoo's other families: the same trees as the reference's
    # (parameters and decode caches), drawn by each leaf's initializer
    for arch in ("rwkv6-1.6b", "zamba2-7b", "whisper-small",
                 "llava-next-34b"):
        cfg = tconfigs.get(arch).reduced()
        jcfg = jconfigs.get(arch).reduced()
        params = tlm.init_params(cfg, device="cpu")
        want = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0),
                                                      jcfg))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                       .replace("torch.", "")), params) == \
            jax.tree.map(lambda a: (a.shape, str(a.dtype)), want), arch
        caches = tlm.init_decode_state(cfg, 2, 8, 20, device="cpu")
        j_caches = jax.eval_shape(lambda: jlm.init_decode_state(jcfg, 2, 8,
                                                                20))
        assert jax.tree.map(lambda t: tuple(t.shape), caches) == \
            jax.tree.map(lambda a: a.shape, j_caches), arch
    for arch in ("mixtral-8x22b", "llama4-maverick-400b-a17b"):
        cfg = tconfigs.get(arch).reduced()
        assert sorted(tlm.init_decode_state(cfg, 2, 8, device="cpu")) == [
            str(i) for i in range(len(cfg.block_pattern))]
    # cross-attention (whisper's decoder): K and V from the source without
    # RoPE, unmasked, under each impl; and over a static cache (read_all)
    jcfg, ccfg = _cfg("whisper-small")
    jattn = jax.jit(jlayers.init_attention, static_argnums=(1, 2))(
        jax.random.key(4), jcfg, jnp.float32)
    tattn = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jattn)
    rng = np.random.default_rng(8)
    x, xa = (rng.standard_normal((2, n, ccfg.d_model)).astype(np.float32)
             for n in (5, 11))
    pos = np.zeros((2, 5), np.int32)
    for impl in IMPLS:
        with jtuning.use_flags(attention_impl=impl, **BLOCKS):
            want, _ = jax.jit(lambda p, x, pos, xa: jlayers.attention_apply(
                p, jcfg, x, positions=pos, causal=False, xa=xa))(
                jattn, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(xa))
        with ttuning.use_flags(attention_impl=impl, **BLOCKS):
            got, _ = tlayers.attention_apply(
                tattn, ccfg, torch.from_numpy(x),
                positions=torch.from_numpy(pos), causal=False,
                xa=torch.from_numpy(xa))
        _close(got, want, f"cross-attention {impl}")
    cache = {k: rng.standard_normal((2, 16, ccfg.n_kv_heads,
                                     ccfg.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    want, _ = jlayers.attention_apply(
        jattn, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        causal=False, kv_cache=jax.tree.map(jnp.asarray, cache),
        cache_mode="read_all")
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, back = tlayers.attention_apply(
        tattn, ccfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        causal=False, kv_cache=t_cache, cache_mode="read_all")
    _close(got, want, "cross-attention over a static cache")
    assert back is t_cache and all(np.array_equal(t_cache[k].numpy(),
                                                  cache[k]) for k in cache)
