"""Port parity: the LM ``ServeEngine`` against the reference's on the CPU,
from one numpy state (the reference's ``init_params`` through
``lm_params_from_jax``), on the reduced llama3-8b (f32): greedy tokens equal
token for token over waves with left padding, a zero budget and a
truncation, for each ``attention_impl`` (the engine decodes by the plain
single-token attention, so the impl does not change its tokens), and the
reference's own serving tests, run against the port. Sampling at a
temperature draws from a seeded ``torch.Generator``, whose draws are not
``jax.random``'s: it is held to determinism and range only.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import tuning
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Request, ServeEngine

PROMPTS = [([5, 9, 200, 3], 6), ([17], 4), ([1, 2, 3, 4, 5, 6, 7], 0),
           ([250, 250], 9), ([8, 8, 8], 500), ([42, 7, 99], 3)]


@pytest.fixture(scope="module")
def state():
    jcfg = jconfigs.get("llama3-8b").reduced()
    tcfg = tconfigs.get("llama3-8b").reduced()
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _engine(state, **kw):
    _, tcfg, _, tp = state
    kw = {"batch": 3, "max_len": 48, **kw}
    return ServeEngine(tp, tcfg, device="cpu", **kw), tcfg


@pytest.fixture(scope="module")
def ref_served(state):
    """The reference engine's greedy requests over PROMPTS, served once for
    the module (its decode attends by plain products under any impl)."""
    jcfg, _, jp, _ = state
    want = [JRequest(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS]
    JEngine(jp, jcfg, batch=3, max_len=48).run(want)
    return want


@pytest.mark.parametrize("impl", ("xla_packed", "pallas"))
def test_greedy_tokens_equal_the_reference(state, ref_served, impl):
    jcfg, tcfg, jp, tp = state
    want = ref_served
    got = [Request(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS]
    with tuning.use_flags(attention_impl=impl):
        ServeEngine(tp, tcfg, batch=3, max_len=48, device="cpu").run(got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.out, g.done, g.truncated) == (w.out, w.done, w.truncated), i


def test_serves_all_requests_exact_lengths(state):
    engine, _ = _engine(state)
    reqs = [Request(prompt=[1 + i, 5], max_new_tokens=3 + i)
            for i in range(7)]          # 3 waves of ≤3 slots
    engine.run(reqs)
    assert all(r.done for r in reqs)
    for i, r in enumerate(reqs):
        assert len(r.out) == 3 + i, (i, r.out)


def test_greedy_decode_is_deterministic_and_batch_invariant(state):
    engine, _ = _engine(state)
    r1 = Request(prompt=[3, 7, 11], max_new_tokens=6)
    engine.run([r1])
    r2 = Request(prompt=[3, 7, 11], max_new_tokens=6)
    others = [Request(prompt=[9, 2, 4], max_new_tokens=6) for _ in range(2)]
    engine.run([r2] + others)
    assert r1.out == r2.out, (r1.out, r2.out)


def test_truncated_and_zero_budget_requests(state):
    engine, _ = _engine(state)            # max_len=48
    long = Request(prompt=[1, 2], max_new_tokens=500)
    short = Request(prompt=[3, 4], max_new_tokens=4)
    zero = Request(prompt=[1, 2], max_new_tokens=0)
    engine.run([long, short, zero])
    assert short.done and not short.truncated and len(short.out) == 4
    assert long.truncated and not long.done
    assert 4 < len(long.out) <= engine.max_len
    assert zero.done and not zero.truncated and zero.out == []


@pytest.mark.parametrize("impl", ("xla_packed", "xla_chunked", "pallas"))
def test_greedy_matches_prefill_argmax(state, impl):
    """The first sampled token is the argmax of the full-prompt logits,
    through each attention impl of ``prefill``."""
    engine, tcfg = _engine(state)
    prompt = [2, 9, 14]
    r = Request(prompt=list(prompt), max_new_tokens=1)
    engine.run([r])
    with tuning.use_flags(attention_impl=impl):
        last, _ = tlm.prefill(engine.params, tcfg,
                              {"tokens": torch.tensor([prompt])})
    assert r.out[0] == int(torch.argmax(last[0, -1]))


def test_temperature_sampling_is_seeded(state):
    outs = []
    for seed in (0, 0, 1):
        engine, tcfg = _engine(state, temperature=1.0, seed=seed)
        reqs = [Request(prompt=[3, 7], max_new_tokens=12) for _ in range(3)]
        engine.run(reqs)
        outs.append([r.out for r in reqs])
        assert all(0 <= t < tcfg.vocab for r in reqs for t in r.out)
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_engine_defaults_to_the_gpu_and_rejects_unported_families(state):
    _, tcfg, _, tp = state
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(tp, tcfg)
    # the zoo's other families are served too (tests/test_torch_lm_zoo.py
    # holds their tokens to the reference's)
    rcfg = tconfigs.get("rwkv6-1.6b").reduced()
    engine = ServeEngine(tlm.init_params(rcfg, device="cpu"), rcfg,
                         device="cpu")
    assert engine.device.type == "cpu" and engine.cfg is rcfg
    req = Request(prompt=[3, 1], max_new_tokens=2)
    engine.run([req])
    assert req.done and len(req.out) == 2
