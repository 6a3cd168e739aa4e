"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip without
them. On the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Each test seeds torch's generators with a fresh seed and prints it (shown
with a failure); ``REPRO_TEST_SEED=<seed>`` replays those inputs.
The fused kernel's row buckets (integer atomics order a row's slots) add
in a run-dependent order, so those are held to the f32 tolerance (1e-4,
1e-5), not bitwise; the COO, CSR, ELL, hybrid and GEMM kernels (their
large-matrix entries too, which give their batched entries' bits), the
fused kernel's large-matrix branch and the grouped matmul have no float
atomics and give identical bits twice.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.batching import plan_hybrid
from repro_torch.core.formats import coo_from_lists, coo_to_csr, \
    coo_to_dense, coo_to_ell, csr_transpose, max_row_degree, \
    narrow_col_ids, quantize_values_i8, random_batch, random_powerlaw_batch
from repro_torch.core.gcn import GCNConfig, init_gcn
from repro_torch.core.graph_conv import stack_channels
from repro_torch.data.graphs import GraphDatasetSpec, generate
from repro_torch.kernels import _build, ref
from repro_torch.kernels.batched_gemm import batched_gemm
from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
from repro_torch.kernels.batched_spmm_hybrid import batched_spmm_hybrid, \
    hybrid_launch, hybrid_operands
from repro_torch.kernels.fused_graph_conv import fused_forward, \
    fused_hybrid_forward, runtime_chunks
from repro_torch.serving.engine import GraphRequest, GraphServeEngine

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-5)
# a bf16 entry against its plain version: both round the same f32 sum to
# bf16 once, so they differ by at most one bf16 ulp (2^-7 of the value)
# where the two f32 sums straddle a rounding boundary, plus f32 noise
BF16_TOL = dict(atol=1e-4, rtol=8e-3)
REGIMES = ("uniform", "skewed", "zero_nnz")
HYBRID_REGIMES = REGIMES + ("powerlaw",)


@pytest.fixture(autouse=True)
def _torch_seed():
    seed = os.environ.get("REPRO_TEST_SEED")
    seed = int(seed) if seed else int.from_bytes(os.urandom(4), "little")
    torch.manual_seed(seed)
    print(f"torch seed {seed}: replay with REPRO_TEST_SEED={seed}")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _regime(name):
    rng = np.random.default_rng(11)
    if name == "powerlaw":
        coo, m_pad = random_powerlaw_batch(rng, batch=6, dim=256, avg_deg=8)
        return coo.with_values(torch.where(
            coo.values != 0, torch.randn(coo.values.shape), 0.0)), m_pad
    if name == "uniform":
        coo, m_pad = random_batch(rng, batch=4, dim=24, nnz_per_row=3)
        return coo.with_values(torch.where(
            coo.values != 0, torch.randn(coo.values.shape), 0.0)), m_pad
    empty = (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
    if name == "zero_nnz":
        return coo_from_lists([empty, empty], [16, 16]), 16
    heavy_r = np.repeat(np.arange(4, dtype=np.int32), 8)
    heavy_c = rng.integers(0, 24, heavy_r.size).astype(np.int32)
    return coo_from_lists(
        [(heavy_r, heavy_c, rng.normal(size=32).astype(np.float32)),
         (np.array([0, 5], np.int32), np.array([1, 2], np.int32),
          np.ones(2, np.float32)), empty], [24, 24, 24]), 24


@pytest.mark.parametrize("name", REGIMES)
def test_spmm_kernels_match_plain(dev, name):
    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    b = torch.randn((coo.batch, m_pad, 48), device=dev)
    k_pad = max(1, int(max_row_degree(coo, m_pad).max()))
    e = coo_to_ell(coo, m_pad, k_pad)
    torch.testing.assert_close(
        batched_spmm_ell(e.col_ids, e.values, b),
        ref.batched_spmm_ell_plain(e.col_ids, e.values, b), **TOL)
    torch.testing.assert_close(
        batched_spmm_coo(coo.row_ids, coo.col_ids, coo.values, b),
        ref.batched_spmm_coo_plain(coo.row_ids, coo.col_ids, coo.values, b),
        **TOL)


@pytest.mark.parametrize("name", REGIMES)
@pytest.mark.parametrize("n_in,n_out", [(12, 40), (512, 300)])
def test_fused_kernel_matches_plain(dev, name, n_in, n_out):
    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    perm = torch.randperm(coo.nnz_pad, device=dev)
    adj = [coo, coo.__class__(coo.row_ids[:, perm], coo.col_ids[:, perm],
                              coo.values[:, perm], coo.nnz, coo.n_rows)]
    rid, cid, val, nnz = stack_channels(adj)
    chunks = runtime_chunks(nnz)
    x = torch.randn((coo.batch, m_pad, n_in), device=dev)
    w = torch.randn((2, n_in, n_out), device=dev) / n_in ** 0.5
    bias = torch.randn((2, n_out), device=dev)
    res = torch.randn((coo.batch, m_pad, n_out), device=dev)
    for epi, r in (("none", None), ("relu", res)):
        torch.testing.assert_close(
            fused_forward(rid, cid, val, chunks, x, w, bias, r, epilogue=epi),
            ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w, bias, r,
                                       epi), **TOL)


@pytest.mark.parametrize("name", REGIMES)
def test_csr_kernel_matches_plain_and_is_bitwise_repeatable(dev, name):
    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    b = torch.randn((coo.batch, m_pad, 48), device=dev)
    for csr in (coo_to_csr(coo, m_pad), csr_transpose(coo_to_csr(coo, m_pad))):
        got = batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, b)
        torch.testing.assert_close(
            got, ref.batched_spmm_csr_plain(csr.rpt, csr.col_ids, csr.values,
                                            b), **TOL)
        again = batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, b)
        assert torch.equal(got, again)


def _csr_contract(name):
    """The regime's CSR arrays (on the CPU) with the cases the CSR kernel's
    contracts name: a tenth of the slots with an out-of-range column id
    (-1, m_pad, 1000) and a tenth real 0.0-valued edges."""
    coo, m_pad = _regime(name)
    c = coo_to_csr(coo, m_pad)
    cid, val = c.col_ids.clone(), c.values.clone()
    slot = torch.arange(cid.shape[1])
    valid = slot[None, :] < c.rpt[:, -1:]
    bad = torch.tensor([-1, m_pad, 1000], dtype=torch.int32)[
        torch.randint(0, 3, cid.shape)]
    oob = (torch.rand(cid.shape) < 0.1) & valid
    cid = torch.where(oob, bad, cid)
    val = torch.where((torch.rand(cid.shape) < 0.1) & valid & ~oob, 0.0,
                      val)
    return c.rpt, cid, val, m_pad


def _csr_entries_hold(rpt, cid, val, m_pad, n_b, dev, corners):
    """Every CSR entry on these operands against its plain version, each
    twice for identical bits: f32 (also through the large-matrix wrapper,
    and for the first matrix alone, which the kernel splits into other row
    blocks: the same bits), bf16 with int16 ids (and int32 ids through the
    large wrapper: the same bits), i8 codes, and the g-SpMM entry on
    ``corners`` with scalar and vector edges (max bitwise against the plain
    version). At planner case 3 (m_pad past LARGE_M) only the large-matrix
    wrappers take the operands; they launch the same entries."""
    from repro_torch.core.batching import LARGE_M
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr_bf16, \
        batched_spmm_csr_i8, batched_spmm_csr_large, \
        batched_spmm_csr_large_bf16, batched_spmm_csr_large_i8

    large = m_pad > LARGE_M
    f32 = batched_spmm_csr_large if large else batched_spmm_csr
    bf16 = batched_spmm_csr_large_bf16 if large else batched_spmm_csr_bf16
    i8 = batched_spmm_csr_large_i8 if large else batched_spmm_csr_i8
    rpt, cid, val = (t.to(dev) for t in (rpt, cid, val))
    batch = rpt.shape[0]
    b = torch.randn((batch, m_pad, n_b), device=dev)
    got = f32(rpt, cid, val, b)
    torch.testing.assert_close(
        got, ref.batched_spmm_csr_plain(rpt, cid, val, b), **TOL)
    assert torch.equal(got, f32(rpt, cid, val, b))
    assert torch.equal(got, batched_spmm_csr_large(rpt, cid, val, b))
    assert torch.equal(got[:1], f32(rpt[:1], cid[:1], val[:1], b[:1]))
    c16 = cid.clamp(-32768, 32767).to(torch.int16)
    c32 = c16.to(torch.int32)
    vh, bh = val.to(torch.bfloat16), b.to(torch.bfloat16)
    g16 = bf16(rpt, c16, vh, bh)
    torch.testing.assert_close(
        g16.float(), ref.batched_spmm_csr_plain(rpt, c16, vh, bh).float(),
        **BF16_TOL)
    assert torch.equal(g16, bf16(rpt, c16, vh, bh))
    assert torch.equal(g16, batched_spmm_csr_large_bf16(rpt, c32, vh, bh))
    codes, scale = quantize_values_i8(val)
    gq = i8(rpt, c16, codes, scale, b)
    torch.testing.assert_close(
        gq, ref.batched_spmm_csr_plain(rpt, c16, codes, b, scale), **TOL)
    assert torch.equal(gq, i8(rpt, c16, codes, scale, b))
    slot = torch.arange(cid.shape[1], device=dev)
    # vector edges as large as the slot's value, so that a long row's sum
    # stays as small as its scalar one
    vec = torch.randn(tuple(cid.shape) + (n_b,), device=dev) * (
        val.abs() * (slot[None, :] < rpt[:, -1:]))[..., None]
    for values in (val, vec):
        for op, red in corners:
            kw = dict(op=op, reduce=red)
            what = f"({op}, {red}) {values.dim()}-D edges"
            want = ref.batched_gspmm_csr_plain(rpt, cid, values, b, **kw)
            g = f32(rpt, cid, values, b, **kw)
            if red == "max":
                assert torch.equal(g, want), what
            else:
                torch.testing.assert_close(g, want, **TOL, msg=what)
            assert torch.equal(g, f32(rpt, cid, values, b, **kw)), what
    return got


@pytest.mark.parametrize("n_b", (1, 7, 48, 64, 65, 512))
@pytest.mark.parametrize("name", HYBRID_REGIMES)
def test_csr_kernel_entries_match_plain_and_are_bitwise(dev, name, n_b):
    """The CSR entries (f32, bf16 with int16 and int32 ids, i8, g-SpMM on
    every (op, reduce) corner with scalar and vector edges) against their
    plain versions on the regimes, the powerlaw batch's hub rows among
    them, with out-of-range column ids and real 0.0 edges; identical bits
    twice and under another row-block split. n_b 1, 7 and 65 read B one
    column at a time, 48, 64 and 512 four (512: four 128-column panels);
    empty rows store 0.0."""
    from repro_torch.kernels.ops import GSPMM_OPS, GSPMM_REDUCES

    rpt, cid, val, m_pad = _csr_contract(name)
    corners = [(op, red) for op in GSPMM_OPS for red in GSPMM_REDUCES]
    got = _csr_entries_hold(rpt, cid, val, m_pad, n_b, dev, corners)
    empty = (rpt[:, 1:] == rpt[:, :-1]).to(dev)
    assert bool((got[empty] == 0).all())


def test_csr_kernel_streams_past_one_run(dev):
    """Blocks whose slots outgrow the 4,096 the CSR kernel stages at a time:
    2 matrices of 64 rows, rows 3 and 40 of each with 5,000 and 4,500
    slots (the rest 0-10), so that a row's sum runs through two runs of
    the stream; then a case-3 shape (2 x 9,000 rows, 3 edges a row and a
    hub row of 64) through the same checks. A row's values are N(0, 1) /
    sqrt(its degree), so that every sum stays O(1) and the plain
    version's other order of 5,000 terms stays within the f32 tolerance."""
    rng = np.random.default_rng(5)
    lists = []
    for _ in range(2):
        deg = rng.integers(0, 11, 64)
        deg[3], deg[40] = 5_000, 4_500
        r = np.repeat(np.arange(64, dtype=np.int32), deg)
        v = rng.normal(size=r.size) / np.sqrt(np.maximum(deg, 1))[r]
        lists.append((r, rng.integers(0, 64, r.size).astype(np.int32),
                      v.astype(np.float32)))
    c = coo_to_csr(coo_from_lists(lists, [64, 64]), 64)
    corners = [("mul", "sum"), ("copy_lhs", "mean"), ("add", "max")]
    _csr_entries_hold(c.rpt, c.col_ids, c.values, 64, 64, dev, corners)
    c = coo_to_csr(_case3_coo(9000, 2), 9000)
    _csr_entries_hold(c.rpt, c.col_ids, c.values, 9000, 64, dev, corners)


@pytest.mark.parametrize("name", REGIMES)
@pytest.mark.parametrize("impl", ("pallas_ell", "pallas_csr", "pallas_coo"))
def test_spmm_backward_kernels_match_ref(dev, name, impl):
    """dValues and dB of each kernel impl on the card (dB runs the COO or
    CSR kernel on the swapped ids) against impl="ref"."""
    from repro_torch.kernels import ops

    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    k_pad = max(1, int(max_row_degree(coo, m_pad).max()))
    b0 = torch.randn((coo.batch, m_pad, 48), device=dev)
    grads = {}
    for i in (impl, "ref"):
        v = coo.values.clone().requires_grad_()
        b = b0.clone().requires_grad_()
        c = ops.batched_spmm(coo.with_values(v), b, impl=i, k_pad=k_pad)
        torch.tanh(c).sum().backward()
        grads[i] = (c.detach(), v.grad, b.grad)
    for got, want in zip(grads[impl], grads["ref"]):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("name", REGIMES)
def test_fused_backward_on_the_card_matches_plain(dev, name):
    """The fused layer's gradients on the card (dU through the COO kernel)
    against the same layer on the CPU, at 3x the f32 tolerance."""
    from repro_torch.kernels.fused_graph_conv import fused_graph_conv

    coo, m_pad = _regime(name)
    perm = torch.randperm(coo.nnz_pad)
    adj = [coo, coo.__class__(coo.row_ids[:, perm], coo.col_ids[:, perm],
                              coo.values[:, perm], coo.nnz, coo.n_rows)]
    rid, cid, val, nnz = stack_channels(adj)
    x = torch.randn((coo.batch, m_pad, 12))
    w = torch.randn((2, 12, 40)) / 4
    bias = torch.randn((2, 40))
    res = torch.randn((coo.batch, m_pad, 40))
    grads = {}
    for where in ("cpu", dev):
        leaves = [t.detach().to(where, copy=True).requires_grad_()
                  for t in (val, x, w, bias, res)]
        y = fused_graph_conv(rid.to(where), cid.to(where), leaves[0],
                             nnz.to(where), *leaves[1:4], epilogue="relu",
                             residual=leaves[4])
        torch.tanh(y).sum().backward()
        grads[str(where)] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-5)


def test_engine_kernels_match_ref_on_gpu(dev):
    spec = GraphDatasetSpec.tox21_like(n_samples=40, seed=4)
    params = init_gcn(GCNConfig.tox21(), generator=torch.Generator()
                      .manual_seed(0), device=dev)
    logits = {}
    for impl in ("ref", "fused", "pallas_ell", "pallas_coo"):
        reqs = [GraphRequest(rows=list(s.rows), cols=list(s.cols),
                             features=s.features, n_nodes=s.n_nodes)
                for s in generate(spec)]
        GraphServeEngine(params, GCNConfig.tox21(impl=impl, bn_mode="sample"),
                         batch=16, device=dev).run(reqs)
        assert all(r.done for r in reqs)
        logits[impl] = np.stack([r.logits for r in reqs])
    for impl in ("fused", "pallas_ell", "pallas_coo"):
        np.testing.assert_allclose(logits[impl], logits["ref"], atol=1e-4)


# each kernel impl and precision variant, the large-matrix wrapper it
# reaches at planner case 3, and whether it is case 3 already at m_pad
# 2000, n_b 32 (f32 B or the COO class's f32 accumulator; a bf16 B panel
# of 2000 rows still fits a block)
CASE3_ENTRIES = {
    "pallas_coo": ("batched_spmm_coo", "batched_spmm_coo_large", True),
    "pallas_ell": ("batched_spmm_ell", "batched_spmm_ell_large", True),
    "pallas_csr": ("batched_spmm_csr", "batched_spmm_csr_large", True),
    "pallas_hybrid": ("batched_spmm_csr", "batched_spmm_csr_large", True),
    "pallas_gemm": ("batched_gemm", "batched_gemm_large", True),
    "pallas_coo_bf16": ("batched_spmm_coo", "batched_spmm_coo_large_bf16",
                        True),
    "pallas_ell_i8": ("batched_spmm_ell", "batched_spmm_ell_large_i8", True),
    "pallas_csr_i8": ("batched_spmm_csr", "batched_spmm_csr_large_i8", True),
    "pallas_ell_bf16": ("batched_spmm_ell", "batched_spmm_ell_large_bf16",
                        False),
    "pallas_csr_bf16": ("batched_spmm_csr", "batched_spmm_csr_large_bf16",
                        False),
    "pallas_hybrid_bf16": ("batched_spmm_csr",
                           "batched_spmm_csr_large_bf16", False),
}
# (impl, m_pad, batch): m_pad 9000 is past LARGE_M, case 3 for every
# variant; the dense adjacency of pallas_gemm is held to m_pad 2000; at
# m_pad 33,792, past int16's range, the bf16 and i8 variants keep int32
# ids, which only their large-matrix entries take
CASE3_RUNS = [(i, 2000, 1) for i, e in sorted(CASE3_ENTRIES.items())
              if e[2]] + [(i, 9000, 2) for i in sorted(CASE3_ENTRIES)
                          if i != "pallas_gemm"] + [
    (i, 33_792, 1) for i in ("pallas_coo_bf16", "pallas_csr_bf16",
                             "pallas_ell_i8", "pallas_hybrid_bf16")]


def _large_wrapper(module: str, name: str):
    import importlib

    return getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                   name)


def _case3_coo(m_pad, batch, seed=0):
    """``batch`` matrices of m_pad rows, 3 N(0, 1) edges a row and a hub
    row of 64, as numpy from a seed."""
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(batch):
        r = np.concatenate([np.repeat(np.arange(m_pad, dtype=np.int32), 3),
                            np.full(64, 7, np.int32)])
        lists.append((r, rng.integers(0, m_pad, r.size).astype(np.int32),
                      rng.normal(size=r.size).astype(np.float32)))
    return coo_from_lists(lists, [m_pad] * batch)


def _forward_and_grads(coo, b0, impl, where, **kw):
    from repro_torch.kernels import ops

    v = coo.values.to(where, copy=True).requires_grad_()
    b = b0.to(where, copy=True).requires_grad_()
    c = ops.batched_spmm(coo.to(where).with_values(v), b, impl=impl, **kw)
    torch.tanh(c).sum().backward()
    return [t.detach().float().cpu() for t in (c, v.grad, b.grad)]


@pytest.mark.parametrize("impl,m_pad,batch", CASE3_RUNS)
def test_case3_kernel_impls_run_their_large_entries_on_the_card(
        dev, impl, m_pad, batch):
    """Planner case 3 on the card: each kernel impl (and the precision
    variants that are case 3 at their element size) runs its kernel's
    large-matrix entry, forward and first-step gradients, against the same
    impl on the CPU, where it takes the reference's plain per-sample path.
    f32 and i8 at (1e-4, 1e-5) and gradients at 3x (the kernels and the
    CPU's scatter-add sum in other orders), bf16 at tests/oracle.py's bf16
    tolerance."""
    coo = _case3_coo(m_pad, batch)
    b0 = torch.randn((batch, m_pad, 32))
    module, name, _ = CASE3_ENTRIES[impl]
    large = _large_wrapper(module, name)
    before = large.launches
    got = _forward_and_grads(coo, b0, impl, dev, k_pad=80)
    assert large.launches > before, f"{impl}: {name} did not launch"
    want = _forward_and_grads(coo, b0, impl, "cpu", k_pad=80)
    bf16 = impl.endswith("bf16")
    tols = ((BF16_TOL, dict(atol=8e-2, rtol=2e-2)) if bf16
            else (TOL, dict(atol=3e-4, rtol=3e-5)))
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, **tols[min(i, 1)],
                                   msg=f"{impl} output/grad {i}")


@pytest.mark.parametrize("impl", ("pallas_coo", "pallas_ell", "pallas_csr"))
def test_case3_gspmm_runs_the_large_entries_on_the_card(dev, impl):
    """g-SpMM (copy_lhs, mean) and (mul, max) with vector edges at case 3
    (m_pad 2000, then 9000 x 2): the large-matrix entries against the CPU's
    oracle; max bitwise (an exact maximum in any order)."""
    from repro_torch.kernels import ops

    module, name, _ = CASE3_ENTRIES[impl]
    large = _large_wrapper(module, name)
    for m_pad, batch in ((2000, 1), (9000, 2)):
        coo = _case3_coo(m_pad, batch, seed=1)
        b = torch.randn((batch, m_pad, 32))
        vec = coo.with_values(torch.randn(coo.values.shape + (32,)))
        for a, op, red in ((coo, "copy_lhs", "mean"), (vec, "mul", "max")):
            before = large.launches
            got = ops.batched_gspmm(a.to(dev), b.to(dev), op=op, reduce=red,
                                    impl=impl, k_pad=80)
            assert large.launches == before + 1
            want = ops.batched_gspmm(a, b, op=op, reduce=red, impl=impl,
                                     k_pad=80)
            if red == "max":
                assert torch.equal(got.cpu(), want), (impl, m_pad)
            else:
                torch.testing.assert_close(got.cpu(), want, **TOL)


def test_case3_large_entries_match_their_batched_entries(dev):
    """A large-matrix entry is the same function as its batched entry: at a
    shape both take (Tox21-like, 64 x 56), ELL, CSR, COO and GEMM give the
    same bits (one fixed-order sum per output)."""
    from repro_torch.kernels.batched_gemm import batched_gemm_large
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo_large
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr_large
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell_large

    coo, m_pad = _regime("uniform")
    coo = coo.to(dev)
    b = torch.randn((coo.batch, m_pad, 200), device=dev)
    e = coo_to_ell(coo, m_pad, 3)
    c = coo_to_csr(coo, m_pad)
    assert torch.equal(batched_spmm_ell_large(e.col_ids, e.values, b),
                       batched_spmm_ell(e.col_ids, e.values, b))
    assert torch.equal(batched_spmm_csr_large(c.rpt, c.col_ids, c.values, b),
                       batched_spmm_csr(c.rpt, c.col_ids, c.values, b))
    assert torch.equal(
        batched_spmm_coo_large(coo.row_ids, coo.col_ids, coo.values, b),
        batched_spmm_coo(coo.row_ids, coo.col_ids, coo.values, b))
    a = coo_to_dense(coo, m_pad).contiguous()
    assert torch.equal(batched_gemm_large(a, b), batched_gemm(a, b))


def test_trainer_steps_on_the_card_match_ref(dev, tmp_path):
    """Three GCNTrainer steps per kernel impl on the card, from one set of
    parameters: the loss curve within 1e-4 relative of impl="ref"."""
    from repro_torch.data.graphs import batches
    from repro_torch.training.trainer import GCNTrainer, TrainerConfig

    spec = GraphDatasetSpec.tox21_like(n_samples=48, seed=2)
    data = list(batches(generate(spec), spec, 16))
    curves = {}
    for impl in ("ref", "fused", "pallas_ell", "pallas_csr", "pallas_coo"):
        tr = GCNTrainer(GCNConfig.tox21(impl=impl), tcfg=TrainerConfig(
            checkpoint_dir=str(tmp_path / impl), checkpoint_every=1000),
            device=dev)
        losses = []
        tr.fit(lambda e: [data[e]], epochs=3,
               on_metrics=lambda _, rec: losses.append(rec["loss"]))
        curves[impl] = np.asarray(losses)
    for impl, curve in curves.items():
        np.testing.assert_allclose(curve, curves["ref"], rtol=1e-4,
                                   err_msg=impl)


@pytest.mark.parametrize("name", HYBRID_REGIMES)
@pytest.mark.parametrize("n_b", (48, 64, 200))
def test_hybrid_kernel_matches_plain_and_is_bitwise_repeatable(dev, name,
                                                               n_b):
    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    b = torch.randn((coo.batch, m_pad, n_b), device=dev)
    hp = plan_hybrid(batch=coo.batch, m_pad=m_pad, n_b=n_b,
                     nnz_pad=coo.nnz_pad)
    ops_ = hybrid_operands(coo.row_ids, coo.col_ids, coo.values, coo.nnz,
                           m_pad, hp)
    got = hybrid_launch(*ops_, b, plan=hp)
    torch.testing.assert_close(got, ref.batched_spmm_hybrid_plain(*ops_, b),
                               **TOL)
    assert torch.equal(got, hybrid_launch(*ops_, b, plan=hp))
    torch.testing.assert_close(
        batched_spmm_hybrid(coo.row_ids, coo.col_ids, coo.values, coo.nnz, b,
                            plan=hp),
        ref.batched_spmm_coo_ref(coo, b, m_pad), **TOL)


def _hub_batch():
    """Three 64-row matrices (dmin 16, nnz_pad 128, so d_pad 8) with 0, 1
    and d_pad hub rows: light rows of 1-3 N(0, 1) slots, a hub of 20 slots,
    eight hubs of 16 slots."""
    rng = np.random.default_rng(5)

    def rows(degs):
        r = np.repeat(np.asarray(list(degs), np.int32)[:, 0],
                      [d for _, d in degs])
        return (r, rng.integers(0, 64, r.size).astype(np.int32),
                rng.normal(size=r.size).astype(np.float32))

    light = [(r, 1 + r % 3) for r in range(0, 64, 2)]
    one = [(5, 20)] + [(r, 2) for r in range(10, 60, 3)]
    full = [(r, 16) for r in range(3, 64, 8)]
    return coo_from_lists([rows(light), rows(one), rows(full)], [64] * 3,
                          nnz_pad=128)


@pytest.mark.parametrize("n_b", (7, 16, 30, 48, 64, 200))
@pytest.mark.parametrize("bf16", (False, True))
def test_hybrid_kernel_hub_counts_in_one_batch(dev, n_b, bf16):
    """Hub counts 0, 1 and d_pad (the whole slab) in one batch, at the
    planner's panel widths for n_b 7-200 (2 to 32 lanes a row, one or two
    panels; n_b 7 and 30 load a column at a time), f32 and bf16: the head,
    bounded by each sample's count, against the plain version, and
    identical bits twice."""
    coo = _hub_batch().to(dev)
    dt = torch.bfloat16 if bf16 else torch.float32
    hp = plan_hybrid(batch=3, m_pad=64, n_b=n_b, nnz_pad=coo.nnz_pad,
                     itemsize=2 if bf16 else 4)
    assert (hp.dmin, hp.d_pad) == (16, 8)
    ops_ = hybrid_operands(coo.row_ids, coo.col_ids, coo.values.to(dt),
                           coo.nnz, 64, hp)
    assert ops_[6].tolist() == [0, 1, hp.d_pad]
    if bf16:
        ops_ = ops_[:3] + (narrow_col_ids(ops_[3], 64),) + ops_[4:]
    b = torch.randn((3, 64, n_b), device=dev).to(dt)
    got = hybrid_launch(*ops_, b, plan=hp)
    torch.testing.assert_close(
        got.float(), ref.batched_spmm_hybrid_plain(*ops_, b).float(),
        **(BF16_TOL if bf16 else TOL))
    assert torch.equal(got, hybrid_launch(*ops_, b, plan=hp))


def test_hybrid_kernel_without_slab(dev):
    """d_pad == 0 (nnz_pad below dmin): the kernel takes no slab."""
    rows = np.array([0, 1, 2], np.int32)
    coo = coo_from_lists([(rows, rows + 5, np.ones(3, np.float32))] * 2,
                         [64, 64]).to(dev)
    hp = plan_hybrid(batch=2, m_pad=64, n_b=16, nnz_pad=coo.nnz_pad)
    assert hp.d_pad == 0
    b = torch.randn((2, 64, 16), device=dev)
    torch.testing.assert_close(
        batched_spmm_hybrid(coo.row_ids, coo.col_ids, coo.values, coo.nnz, b,
                            plan=hp),
        ref.batched_spmm_coo_ref(coo, b, 64), **TOL)


@pytest.mark.parametrize("batch,m,k,n", [(512, 56, 56, 64), (7, 24, 40, 300),
                                         (3, 200, 200, 33), (2, 5, 3, 1)])
def test_gemm_kernel_matches_plain_and_library(dev, batch, m, k, n):
    a = torch.randn((batch, m, k), device=dev)
    b = torch.randn((batch, k, n), device=dev)
    got = batched_gemm(a, b)
    torch.testing.assert_close(got, ref.batched_gemm_plain(a, b), **TOL)
    torch.testing.assert_close(got, torch.bmm(a, b), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, batched_gemm(a, b))


@pytest.mark.parametrize("m", (55, 56, 57, 63, 64, 65, 127, 128, 129, 143, 144,
                               145))
@pytest.mark.parametrize("k", (3, 5, 9))
def test_gemm_tile_edges_match_plain_and_the_large_entry(dev, m, k):
    """m just below, at and above the row tiles (56, 64, 128, 144 rows), k 3, 5
    and 9 (A's rows not 16-byte aligned: 4-byte copies), n 70 (a ragged
    second panel), and 150 matrices (more tiles than the card has SMs):
    against the plain version and torch.bmm; the large-matrix entry gives
    the same bits, and a second call too."""
    from repro_torch.kernels.batched_gemm import batched_gemm_large

    a = torch.randn((150, m, k), device=dev)
    b = torch.randn((150, k, 70), device=dev)
    got = batched_gemm(a, b)
    torch.testing.assert_close(got, ref.batched_gemm_plain(a, b), **TOL)
    torch.testing.assert_close(got, torch.bmm(a, b), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, batched_gemm(a, b))
    assert torch.equal(got, batched_gemm_large(a, b))


@pytest.mark.parametrize("name,n_in,n_out", [
    (name, n_in, n_out) for name in HYBRID_REGIMES
    for n_in, n_out in ((12, 40), (512, 300))])
def test_fused_hybrid_kernel_matches_plain(dev, name, n_in, n_out):
    """fused_hybrid_forward on the card (the kernel's hybrid branch) against
    the same call on the CPU (the plain version), with ReLU and a
    residual, and against the plain fused layer."""
    coo, m_pad = _regime(name)
    perm = torch.randperm(coo.nnz_pad)
    adj = [coo, coo.__class__(coo.row_ids[:, perm], coo.col_ids[:, perm],
                              coo.values[:, perm], coo.nnz, coo.n_rows)]
    rid, cid, val, nnz = stack_channels(adj)
    x = torch.randn((coo.batch, m_pad, n_in))
    w = torch.randn((2, n_in, n_out)) / n_in ** 0.5
    bias = torch.randn((2, n_out))
    res = torch.randn((coo.batch, m_pad, n_out))
    hp = plan_hybrid(batch=coo.batch, m_pad=m_pad, n_b=n_out,
                     nnz_pad=2 * coo.nnz_pad)
    args = (rid, cid, val, nnz, x, w, bias, res)
    want = fused_hybrid_forward(*args, hplan=hp, epilogue="relu")
    before = fused_hybrid_forward.launches
    got = fused_hybrid_forward(*(t.to(dev) for t in args), hplan=hp,
                               epilogue="relu")
    assert fused_hybrid_forward.launches == before + (hp.d_pad > 0)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    torch.testing.assert_close(
        got, fused_forward(*(t.to(dev) for t in (rid, cid, val)),
                           runtime_chunks(nnz).to(dev),
                           *(t.to(dev) for t in (x, w, bias, res)),
                           epilogue="relu"), **TOL)


@pytest.mark.parametrize("entry", ("f32", "hybrid", "bf16"))
@pytest.mark.parametrize("m_pad", (1024, 3072))
def test_fused_large_entries_match_plain(dev, m_pad, entry):
    """Matrices whose U_ch and accumulator panels do not fit a block (the
    kernel's kLarge branch: the panels in a global scratch) against the
    plain version on the same card, each entry counted once: four
    channels of the case-3 matrices above (row 7 a hub of the hybrid
    split at m_pad 1024)."""
    from repro_torch.core.batching import plan_fused_graph_conv
    from repro_torch.kernels.fused_graph_conv import fused_forward_bf16, \
        fused_hybrid_operands

    rid, cid, val, nnz = stack_channels(
        [_case3_coo(m_pad, 2, seed=c).to(dev) for c in range(4)])
    x = torch.randn((2, m_pad, 62), device=dev)
    w = torch.randn((4, 62, 40), device=dev) / 62 ** 0.5
    bias = torch.randn((4, 40), device=dev)
    res = torch.randn((2, m_pad, 40), device=dev)
    plan = plan_fused_graph_conv(batch=2, m_pad=m_pad, n_in=62, n_out=40,
                                 itemsize=2 if entry == "bf16" else 4)
    assert plan.large and plan.case != 3
    chunks = runtime_chunks(nnz)
    if entry == "bf16":
        bf = torch.bfloat16
        args = (narrow_col_ids(rid, m_pad), narrow_col_ids(cid, m_pad),
                val.to(bf), chunks, x.to(bf), w.to(bf), bias.to(bf),
                res.to(bf))
        before = fused_forward_bf16.launches
        got = fused_forward_bf16(*args, epilogue="relu")
        assert fused_forward_bf16.launches == before + 1
        torch.testing.assert_close(
            got, ref.fused_graph_conv_plain(*args, "relu"), **BF16_TOL)
        return
    if entry == "hybrid":
        hp = plan_hybrid(batch=2, m_pad=m_pad, n_b=40,
                         nnz_pad=4 * rid.shape[2])
        rid, cid, val, chunks, rank, slab, hubs = fused_hybrid_operands(
            rid, cid, val, m_pad, hp)
        assert hubs.tolist() == ([1, 1] if m_pad == 1024 else [0, 0])
        extra, counted = (rank, slab), fused_hybrid_forward
    else:
        extra, hubs, counted = (), None, fused_forward
    before = counted.launches
    got = fused_forward(rid, cid, val, chunks, x, w, bias, res, *extra,
                        epilogue="relu", hubs=hubs)
    assert counted.launches == before + 1
    torch.testing.assert_close(
        got, ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w, bias,
                                        res, "relu", *extra, hubs), **TOL)
    assert torch.equal(got, fused_forward(rid, cid, val, chunks, x, w, bias,
                                          res, *extra, epilogue="relu",
                                          hubs=hubs))


@pytest.mark.parametrize("entry", ("f32", "hybrid", "bf16"))
@pytest.mark.parametrize("m_pad,batch,n_in,channels", [
    (1024, 8, 512, 4), (3072, 2, 62, 4), (1024, 2, 62, 8)])
def test_fused_large_branch_matches_plain_and_is_bitwise(dev, m_pad, batch,
                                                         n_in, channels,
                                                         entry):
    """The large-matrix branch at chip_smoke.py's FUSED_LARGE shapes (8 x
    1024 rows, n_in 512; 2 x 3072, n_in 62; n_out 64), each sample's rows
    spread over many row blocks of the aggregation, and with 8 channels,
    whose U the scratch holds a group at a time (the accumulator kept
    between the groups): every entry against its plain version with a
    residual and ReLU, one launch a call, identical bits twice. The
    matrices' rows are shuffled (slots in any order, a hub row among
    them) and a tenth of the slots are out-of-range or 0.0."""
    from repro_torch.core.batching import fused_large_scratch, \
        plan_fused_graph_conv
    from repro_torch.kernels.fused_graph_conv import fused_forward_bf16, \
        fused_hybrid_operands

    n_out = 64
    adj = []
    for c in range(channels):
        coo = _case3_coo(m_pad, batch, seed=c)
        p = torch.randperm(coo.nnz_pad)
        rid, cid = coo.row_ids[:, p], coo.col_ids[:, p]
        val = coo.values[:, p]
        val = torch.where(torch.rand(val.shape) < 0.05, 0.0, val)
        cid = torch.where(torch.rand(cid.shape) < 0.05, m_pad + 3, cid)
        adj.append(coo.__class__(rid, cid, val, coo.nnz, coo.n_rows).to(dev))
    rid, cid, val, nnz = stack_channels(adj)
    x = torch.randn((batch, m_pad, n_in), device=dev)
    w = torch.randn((channels, n_in, n_out), device=dev) / n_in ** 0.5
    bias = torch.randn((channels, n_out), device=dev)
    res = torch.randn((batch, m_pad, n_out), device=dev)
    bf16 = entry == "bf16"
    plan = plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=n_in,
                                 n_out=n_out, itemsize=2 if bf16 else 4)
    assert plan.large and plan.case != 3
    _, group = fused_large_scratch(batch=batch, channels=channels,
                                   m_pad=m_pad, n_out=n_out,
                                   n_block=plan.n_block)
    assert (group < channels) == (channels == 8)
    chunks = runtime_chunks(nnz)
    if bf16:
        b = torch.bfloat16
        args = (narrow_col_ids(rid, m_pad), narrow_col_ids(cid, m_pad),
                val.to(b), chunks, x.to(b), w.to(b), bias.to(b), res.to(b))

        def run():
            return fused_forward_bf16(*args, epilogue="relu")

        want, tol, counted = ref.fused_graph_conv_plain(*args, "relu"), \
            BF16_TOL, fused_forward_bf16
    else:
        extra, hubs, counted = (), None, fused_forward
        if entry == "hybrid":
            hp = plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_out,
                             nnz_pad=channels * rid.shape[2])
            rid, cid, val, chunks, rank, slab, hubs = fused_hybrid_operands(
                rid, cid, val, m_pad, hp)
            if channels == 8:   # row 7: ~500 live slots, past dmin 256
                assert bool((hubs > 0).all())
            extra, counted = (rank, slab), fused_hybrid_forward

        def run():
            return fused_forward(rid, cid, val, chunks, x, w, bias, res,
                                 *extra, epilogue="relu", hubs=hubs)

        want, tol = ref.fused_graph_conv_plain(
            rid, cid, val, chunks, x, w, bias, res, "relu", *extra,
            hubs), TOL
    before = counted.launches
    got = run()
    assert counted.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, run())


def test_fused_hybrid_hub_bound_on_the_card(dev):
    """A batch in which one sample has hub rows and the others none (one
    empty): the head bounded by each sample's hub count gives the result
    of the head over all d_pad rows, in one launch each, and both match
    the plain version."""
    from repro_torch.kernels.fused_graph_conv import fused_hybrid_operands

    m_pad, rng = 64, np.random.default_rng(5)
    hub_r = np.repeat(np.arange(3, dtype=np.int32), 24)      # 3 hub rows
    hub_c = rng.integers(0, m_pad, hub_r.size).astype(np.int32)
    tail_r = rng.integers(0, m_pad, 40).astype(np.int32)
    tail_c = rng.integers(0, m_pad, 40).astype(np.int32)
    empty = (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
    adj = []
    for _ in range(2):
        samples = [(np.concatenate([hub_r, tail_r]),
                    np.concatenate([hub_c, tail_c]),
                    rng.normal(size=hub_r.size + 40).astype(np.float32)),
                   (tail_r, tail_c, rng.normal(size=40).astype(np.float32)),
                   empty]
        adj.append(coo_from_lists(samples, [m_pad] * 3).to(dev))
    rid, cid, val, nnz = stack_channels(adj)
    hp = plan_hybrid(batch=3, m_pad=m_pad, n_b=48, nnz_pad=2 * rid.shape[2])
    ops_ = fused_hybrid_operands(rid, cid, val, m_pad, hp)
    hubs = ops_[6]
    assert hubs.tolist()[1:] == [0, 0] and 0 < hubs[0] < hp.d_pad
    x = torch.randn((3, m_pad, 12), device=dev)
    w = torch.randn((2, 12, 48), device=dev) / 12 ** 0.5
    bias = torch.randn((2, 48), device=dev)
    before = fused_hybrid_forward.launches
    bounded = fused_forward(*ops_[:4], x, w, bias, None, *ops_[4:6],
                            hubs=hubs)
    full = fused_forward(*ops_[:4], x, w, bias, None, *ops_[4:6])
    assert fused_hybrid_forward.launches == before + 2
    torch.testing.assert_close(bounded, full, **TOL)
    torch.testing.assert_close(
        bounded, ref.fused_graph_conv_plain(rid, cid, val,
                                            runtime_chunks(nnz), x, w, bias),
        **TOL)


def test_fused_bf16_entry_at_reaction100_width(dev):
    """The bf16 entry at Reaction100 layer-2 width (512 -> 512, 56 rows)
    runs its transform on the tensor cores (HMMA in every bf16 instance's
    SASS, none in the f32 ones): within one bf16 ulp of its plain version
    on N(0, 1) edge values, bias and features, and within TOLS["bf16"] of
    the f32 plain layer on the Reaction100 model's own layer-2 parameters
    and unit edge values, as the model runs it. (On the N(0, 1) data the
    bf16 storage itself moves a rare output whose ~10-sized terms cancel
    by more than TOLS["bf16"], in the plain version as much as in the
    kernel.)"""
    from repro_torch.kernels.fused_graph_conv import fused_forward_bf16

    coo, m_pad = random_batch(np.random.default_rng(9), batch=32, dim=56,
                              nnz_per_row=2)
    adj = [coo.with_values(torch.where(coo.values != 0,
                                       torch.randn(coo.values.shape),
                                       0.0)).to(dev) for _ in range(4)]
    rid, cid, val, nnz = stack_channels(adj)
    chunks = runtime_chunks(nnz)
    x = torch.randn((32, m_pad, 512), device=dev)
    w = torch.randn((4, 512, 512), device=dev) / 512 ** 0.5
    bias = torch.randn((4, 512), device=dev)
    bf = torch.bfloat16
    r16, c16 = narrow_col_ids(rid, m_pad), narrow_col_ids(cid, m_pad)
    args = (r16, c16, val.to(bf), chunks, x.to(bf), w.to(bf), bias.to(bf))
    torch.testing.assert_close(
        fused_forward_bf16(*args, epilogue="relu"),
        ref.fused_graph_conv_plain(*args, None, "relu"), **BF16_TOL)
    conv = init_gcn(GCNConfig.reaction100(), generator=torch.Generator()
                    .manual_seed(0), device=dev)["convs"][1]
    unit = (val != 0).float()
    got = fused_forward_bf16(r16, c16, unit.to(bf), chunks, x.to(bf),
                             conv["w"].to(bf), conv["b"].to(bf),
                             epilogue="relu")
    want = ref.fused_graph_conv_plain(rid, cid, unit, chunks, x, conv["w"],
                                      conv["b"], None, "relu")
    torch.testing.assert_close(got.float(), want, atol=8e-2, rtol=2e-2)
    hmma = _build.sass_count("fused_graph_conv", "fused_kernel", "HMMA")
    bf16 = {k: v for k, v in hmma.items() if "bfloat16" in k}
    assert bf16 and all(v > 0 for v in bf16.values())
    assert not any(v for k, v in hmma.items() if "bfloat16" not in k)


@pytest.mark.parametrize("impl", ("pallas_hybrid", "pallas_gemm"))
@pytest.mark.parametrize("name", HYBRID_REGIMES)
def test_new_spmm_impls_backward_match_ref(dev, name, impl):
    from repro_torch.kernels import ops

    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    b0 = torch.randn((coo.batch, m_pad, 48), device=dev)
    # (the dense 256 x 256 powerlaw A tile does not fit a block: pallas_gemm
    # runs the K-tiled entry there)
    grads = {}
    for i in (impl, "ref"):
        v = coo.values.clone().requires_grad_()
        b = b0.clone().requires_grad_()
        c = ops.batched_spmm(coo.with_values(v), b, impl=i)
        torch.tanh(c).sum().backward()
        grads[i] = (c.detach(), v.grad, b.grad)
    for got, want in zip(grads[impl], grads["ref"]):
        torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-5)


def test_new_impls_serve_and_train_on_the_card(dev, tmp_path):
    """The engine and three trainer steps with each new impl on the card:
    logits within 1e-4 and the loss curve within 1e-4 relative of ref."""
    from repro_torch.data.graphs import batches
    from repro_torch.training.trainer import GCNTrainer, TrainerConfig

    spec = GraphDatasetSpec.tox21_like(n_samples=48, seed=2)
    params = init_gcn(GCNConfig.tox21(), generator=torch.Generator()
                      .manual_seed(0), device=dev)
    data = list(batches(generate(spec), spec, 16))
    logits, curves = {}, {}
    for impl in ("ref", "hybrid", "pallas_hybrid", "pallas_gemm",
                 "fused_hybrid"):
        reqs = [GraphRequest(rows=list(s.rows), cols=list(s.cols),
                             features=s.features, n_nodes=s.n_nodes)
                for s in generate(spec)]
        GraphServeEngine(params, GCNConfig.tox21(impl=impl, bn_mode="sample"),
                         batch=16, device=dev).run(reqs)
        assert all(r.done for r in reqs)
        logits[impl] = np.stack([r.logits for r in reqs])
        tr = GCNTrainer(GCNConfig.tox21(impl=impl), tcfg=TrainerConfig(
            checkpoint_dir=str(tmp_path / impl), checkpoint_every=1000),
            device=dev)
        losses = []
        tr.fit(lambda e: [data[e]], epochs=3,
               on_metrics=lambda _, rec: losses.append(rec["loss"]))
        curves[impl] = np.asarray(losses)
    for impl in logits:
        np.testing.assert_allclose(logits[impl], logits["ref"], atol=1e-4)
        np.testing.assert_allclose(curves[impl], curves["ref"], rtol=1e-4,
                                   err_msg=impl)


def test_dense_adjacency_gemm_matches_bmm(dev):
    coo, m_pad = _regime("uniform")
    coo = coo.to(dev)
    a = coo_to_dense(coo, m_pad).contiguous()
    b = torch.randn((coo.batch, m_pad, 64), device=dev)
    torch.testing.assert_close(batched_gemm(a, b), torch.bmm(a, b), **TOL)


GSPMM_CORNERS = [(op, red) for op in ("mul", "add", "copy_lhs")
                 for red in ("sum", "max", "mean")]


def _vector_values(coo, n_b):
    """(batch, nnz_pad, n_b) N(0, 1) edge vectors, 0.0 at the padding."""
    slot = torch.arange(coo.nnz_pad, device=coo.nnz.device)
    valid = (slot[None, :] < coo.nnz[:, None])[..., None]
    vv = torch.randn(tuple(coo.values.shape) + (n_b,), device=valid.device)
    return torch.where(valid, vv, 0.0)


@pytest.mark.parametrize("edges", ("scalar", "vector"))
@pytest.mark.parametrize("name", REGIMES)
def test_gspmm_kernels_match_plain(dev, name, edges):
    """The g-SpMM entries of the ELL, CSR and COO kernels against their
    plain versions on every (op, reduce) corner: max corners bitwise (max
    is exact in any order, the atomics of COO included), the rest to the
    f32 tolerance; the ELL and CSR entries give identical bits twice."""
    from repro_torch.core.formats import row_degrees

    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    n_b = 48
    if edges == "vector":
        coo = coo.with_values(_vector_values(coo, n_b))
    b = torch.randn((coo.batch, m_pad, n_b), device=dev)
    k_pad = max(1, int(max_row_degree(coo, m_pad).max()))
    rlen = row_degrees(coo, m_pad)
    e = coo_to_ell(coo, m_pad, k_pad)
    csr = coo_to_csr(coo, m_pad)
    for op, red in GSPMM_CORNERS:
        kw = dict(op=op, reduce=red)
        runs = [
            ("ell", lambda: batched_spmm_ell(e.col_ids, e.values, b,
                                             rlen=rlen, **kw),
             lambda: ref.batched_gspmm_ell_plain(e.col_ids, e.values, rlen,
                                                 b, **kw), True),
            ("csr", lambda: batched_spmm_csr(csr.rpt, csr.col_ids,
                                             csr.values, b, **kw),
             lambda: ref.batched_gspmm_csr_plain(csr.rpt, csr.col_ids,
                                                 csr.values, b, **kw), True),
            ("coo", lambda: batched_spmm_coo(coo.row_ids, coo.col_ids,
                                             coo.values, b, nnz=coo.nnz,
                                             **kw),
             lambda: ref.batched_gspmm_coo_plain(coo.row_ids, coo.col_ids,
                                                 coo.values, coo.nnz, b,
                                                 **kw), False)]
        for kname, kern, plain, repeatable in runs:
            got, want = kern(), plain()
            what = f"{kname} ({op}, {red}) {edges} on {name}"
            if red == "max":
                assert torch.equal(got, want), what
            else:
                torch.testing.assert_close(got, want, **TOL, msg=what)
            if repeatable:
                assert torch.equal(got, kern()), f"{what}: two calls differ"
            # every kernel agrees with the oracle on the COO batch
            torch.testing.assert_close(
                got, ref.batched_gspmm_ref(coo, b, m_pad, **kw), **TOL,
                msg=f"{what} vs the oracle")


@pytest.mark.parametrize("sizes,k,n", [
    ((7168,) * 4, 62, 64),          # R-GCN Tox21 serving: aligned tiles
    ((2800,) * 4, 64, 64),          # Tox21 training: straddling tiles
    ((2800,) * 4, 64, 62),          # a dx at N 62: 8-byte rows of w and out
    ((5, 70, 1, 0, 300), 33, 20),   # ragged, an empty group, rows past sum
    ((10,) * 5 + (28_622,), 33, 64),  # 6 groups in one 64-row kernel tile
    ((2, 3), 33, 20),               # M below one tile (5 rows)
    ((1024,) * 4, 62, 512),         # R-GCN Reaction100 layer 1 (K 62)
    ((1024,) * 4, 512, 512),        # R-GCN at Reaction100 width
])
def test_grouped_matmul_kernel_matches_plain_and_is_bitwise(dev, sizes, k,
                                                            n):
    """The kernel against its plain version and twice for identical bits,
    and its dx role (the same kernel on the transposed weights). K 33 and
    62 copy x 4 or 8 bytes at a time, N 20 and 62 copy w and store out so;
    the 6-group case puts groups 0-4 and the start of group 5 in the first
    64-row tile of the kernel itself, whose rows past group 3 come out 0,
    as in the reference."""
    from repro_torch.kernels.grouped_matmul import _gmm, _row_groups, \
        _visited_groups, gmm_tile

    m = sum(sizes) + (17 if sizes[0] == 5 else 0)
    if len(sizes) == 6:
        assert gmm_tile(m, n)[0] == 8
    x = torch.randn((m, k), device=dev)
    w = torch.randn((len(sizes), k, n), device=dev) / k ** 0.5
    rg = _row_groups(torch.tensor(sizes, dtype=torch.int32, device=dev), m,
                     len(sizes))
    # a 128-row tile of the reference visits at most 4 groups: the rows of
    # a fifth group there come out 0
    visited = _visited_groups(rg, 128, 4)
    assert bool((visited < 0).any()) == (len(sizes) > 4)
    got = _gmm(x, w, rg)
    torch.testing.assert_close(got, ref.grouped_matmul_ref(x, visited, w),
                               **TOL)
    assert bool((got[visited < 0] == 0).all())
    assert torch.equal(got, _gmm(x, w, rg))
    # dx: the same kernel on the transposed weights
    wt = w.transpose(1, 2).contiguous()
    d = torch.randn((m, n), device=dev)
    dx = _gmm(d, wt, rg)
    torch.testing.assert_close(dx, ref.grouped_matmul_ref(d, visited, wt),
                               **TOL)
    assert torch.equal(dx, _gmm(d, wt, rg))


@pytest.mark.parametrize("k_pad", (1, 3, 8, 16))
@pytest.mark.parametrize("n_b", (1, 7, 48, 64, 65, 512))
def test_ell_kernel_entries_match_plain_and_are_bitwise(dev, k_pad, n_b):
    """The f32, bf16 (int16 ids) and i8 (int16 ids, per-matrix scale)
    entries of the ELL kernel against their plain versions, on 6 matrices
    of 40 rows: a third of the slots padding (id 0, value 0.0), a tenth
    out-of-range ids (-1, m_pad, 1000: skipped), one matrix with no
    non-zero. k_pad 1 and 3 read the slots one at a time, 8 and 16 as
    vectors; n_b 1, 7 and 65 read B one column at a time, 48, 64 and 512
    four (512: four 128-column panels). Each entry gives identical bits
    twice, and its large-matrix entry the same bits (with int16 and int32
    ids)."""
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell_bf16, \
        batched_spmm_ell_i8, batched_spmm_ell_large, \
        batched_spmm_ell_large_bf16, batched_spmm_ell_large_i8

    batch, m_pad = 6, 40
    shape = (batch, m_pad, k_pad)
    cid = torch.randint(0, m_pad, shape, dtype=torch.int32)
    val = torch.randn(shape)
    pad = torch.rand(shape) < 1 / 3
    cid[pad], val[pad] = 0, 0.0
    oob = torch.rand(shape) < 0.1
    cid[oob] = torch.tensor([-1, m_pad, 1000], dtype=torch.int32)[
        torch.randint(0, 3, (int(oob.sum()),))]
    cid[2], val[2] = 0, 0.0
    codes, scale = quantize_values_i8(val)
    cid, val, codes, scale = (t.to(dev) for t in (cid, val, codes, scale))
    c16 = cid.to(torch.int16)
    b = torch.randn((batch, m_pad, n_b), device=dev)
    bh, vh = b.to(torch.bfloat16), val.to(torch.bfloat16)
    checks = [
        (lambda: batched_spmm_ell(cid, val, b),
         ref.batched_spmm_ell_plain(cid, val, b), TOL,
         [lambda: batched_spmm_ell_large(cid, val, b)]),
        (lambda: batched_spmm_ell_bf16(c16, vh, bh),
         ref.batched_spmm_ell_plain(c16, vh, bh), BF16_TOL,
         [lambda: batched_spmm_ell_large_bf16(c16, vh, bh),
          lambda: batched_spmm_ell_large_bf16(cid, vh, bh)]),
        (lambda: batched_spmm_ell_i8(c16, codes, scale, b),
         ref.batched_spmm_ell_plain(c16, codes, b, scale), TOL,
         [lambda: batched_spmm_ell_large_i8(c16, codes, scale, b),
          lambda: batched_spmm_ell_large_i8(cid, codes, scale, b)])]
    for kern, want, tol, large in checks:
        got = kern()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert bool((got[2] == 0).all())
        assert torch.equal(got, kern())
        for other in large:
            assert torch.equal(got, other())


def test_gnn_layers_on_the_card_match_the_cpu(dev):
    """GAT and R-GCN ChemGCN logits and first-step gradients on the card
    (kernels) against the same model on the CPU (plain versions)."""
    from repro_torch import tree
    from repro_torch.core.gcn import apply_gcn, gcn_loss
    from repro_torch.data.graphs import batches

    spec = GraphDatasetSpec.tox21_like(n_samples=24, seed=5)
    batch = next(batches(generate(spec), spec, 24))
    for layer in ("gat", "rgcn"):
        params = init_gcn(GCNConfig.tox21(layer=layer), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        for impl in ("pallas_ell", "pallas_csr", "pallas_coo"):
            cfg = GCNConfig.tox21(layer=layer, impl=impl, bn_mode="sample")
            out = {}
            for where in ("cpu", dev):
                p = tree.tree_map(
                    lambda t: t.detach().to(where).requires_grad_(), params)
                adj = [a.to(where) for a in batch["adj"]]
                leaves = tree.leaves(p)
                logits = apply_gcn(p, cfg, adj, batch["x"].to(where),
                                   batch["n_nodes"].to(where))
                loss, _ = gcn_loss(p, cfg, adj, batch["x"].to(where),
                                   batch["n_nodes"].to(where),
                                   batch["labels"].to(where))
                out[str(where)] = [logits.detach().cpu()] + [
                    g.cpu() for g in torch.autograd.grad(loss, leaves)]
            for i, (got, want) in enumerate(zip(out[str(dev)], out["cpu"])):
                torch.testing.assert_close(
                    got, want, atol=3e-4, rtol=3e-5,
                    msg=f"{layer} {impl} leaf {i}")


def test_pallas_ell_gspmm_raises_past_k_pad_on_the_card(dev):
    from repro_torch.kernels import ops

    coo, m_pad = _regime("skewed")
    coo = coo.to(dev)
    b = torch.randn((coo.batch, m_pad, 16), device=dev)
    with pytest.raises(ValueError, match="max row degree"):
        ops.batched_gspmm(coo, b, op="copy_lhs", reduce="mean",
                          impl="pallas_ell", k_pad=2)


@pytest.mark.parametrize("name", HYBRID_REGIMES)
def test_coo_gspmm_max_is_bitwise(dev, name):
    """The COO kernel's max corners (fmaxf over a row's slots) equal the
    plain version bitwise, also over the long rows of hubs (the powerlaw
    regime)."""
    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    b = torch.randn((coo.batch, m_pad, 64), device=dev)
    for values in (coo.values, _vector_values(coo, 64)):
        for op in ("mul", "add", "copy_lhs"):
            got = batched_spmm_coo(coo.row_ids, coo.col_ids, values, b,
                                   nnz=coo.nnz, op=op, reduce="max")
            want = ref.batched_gspmm_coo_plain(coo.row_ids, coo.col_ids,
                                               values, coo.nnz, b, op=op,
                                               reduce="max")
            assert torch.equal(got, want), f"({op}, max) {values.dim()}-D"


def _coo_contract_slots(name):
    """The regime's COO operands (on the CPU) with every case the COO
    kernel's contracts name: each matrix's first nnz[s] slots shuffled (the
    dB / dU calls swap the ids, so the rows arrive in any order), a tenth
    of them with an out-of-range row or column id (-1, m_pad: the
    sentinel, 1000), a tenth real 0.0-valued edges, and half the padding
    slots (value 0.0) on the m_pad sentinel row, the rest on row 0."""
    coo, m_pad = _regime(name)
    rid, cid, val = (t.clone() for t in (coo.row_ids, coo.col_ids,
                                         coo.values))
    for s in range(coo.batch):
        k = int(coo.nnz[s])
        p = torch.randperm(k)
        rid[s, :k], cid[s, :k], val[s, :k] = rid[s, p], cid[s, p], val[s, p]
    slot = torch.arange(coo.nnz_pad)
    valid = slot[None, :] < coo.nnz[:, None]
    oob = (torch.rand(rid.shape) < 0.1) & valid
    bad = torch.tensor([-1, m_pad, 1000], dtype=torch.int32)[
        torch.randint(0, 3, rid.shape)]
    on_row = torch.rand(rid.shape) < 0.5
    rid = torch.where(oob & on_row, bad, rid)
    cid = torch.where(oob & ~on_row, bad, cid)
    val = torch.where((torch.rand(rid.shape) < 0.1) & valid & ~oob, 0.0, val)
    rid = torch.where(~valid & (slot[None, :] % 2 == 0), m_pad, rid)
    return rid, cid, val, coo.nnz, m_pad


def _narrow_plan(batch, m_pad, n_b):
    """A plan of 8-column panels: the COO kernel then splits a block's
    rows over 128 sub-warps of 2 lanes instead of 8-64 (and, where the
    stream is longer than one run, takes 128 rows a block), another split
    of the same sums."""
    from repro_torch.core.batching import BatchPlan

    n_block = min(n_b, 8)
    p = -(-n_b // n_block)
    return BatchPlan(batch, m_pad, n_b, n_block, p, 1 if p == 1 else 2, 0)


def _coo_entries_hold(rid, cid, val, nnz, m_pad, n_b, dev, corners):
    """Every COO entry against its plain version on these operands; the
    batched entries twice for identical bits and under another block
    split for the same bits; each large-matrix entry (bf16 with int16 and
    int32 ids) the same bits as its batched entry, twice and under another
    panel and tile split; max corners bitwise against the plain version;
    the g-SpMM entries on ``corners`` with scalar and vector edges."""
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo_bf16, \
        batched_spmm_coo_large, batched_spmm_coo_large_bf16

    rid, cid, val, nnz = (t.to(dev) for t in (rid, cid, val, nnz))
    batch = rid.shape[0]
    b = torch.randn((batch, m_pad, n_b), device=dev)
    narrow = _narrow_plan(batch, m_pad, n_b)
    got = batched_spmm_coo(rid, cid, val, b)
    torch.testing.assert_close(
        got, ref.batched_spmm_coo_plain(rid, cid, val, b), **TOL)
    assert torch.equal(got, batched_spmm_coo(rid, cid, val, b))
    assert torch.equal(got, batched_spmm_coo(rid, cid, val, b, plan=narrow))
    _same_bits_as(got, lambda **kw: batched_spmm_coo_large(rid, cid, val, b,
                                                            **kw), narrow,
                  "f32")
    r16, c16 = rid.to(torch.int16), cid.to(torch.int16)
    vh, bh = val.to(torch.bfloat16), b.to(torch.bfloat16)
    want16 = ref.batched_spmm_coo_plain(r16, c16, vh, bh).float()
    got16 = batched_spmm_coo_bf16(r16, c16, vh, bh)
    torch.testing.assert_close(got16.float(), want16, **BF16_TOL)
    assert torch.equal(got16, batched_spmm_coo_bf16(r16, c16, vh, bh))
    assert torch.equal(got16, batched_spmm_coo_bf16(r16, c16, vh, bh,
                                                    plan=narrow))
    for ids in ((r16, c16), (rid, cid)):
        _same_bits_as(got16, lambda **kw: batched_spmm_coo_large_bf16(
            *ids, vh, bh, **kw), narrow, f"bf16, {ids[0].dtype} ids")
    slot = torch.arange(rid.shape[1], device=dev)
    vec = torch.randn(tuple(rid.shape) + (n_b,), device=dev) * (
        slot[None, :] < nnz[:, None])[..., None]
    for values in (val, vec):
        for op, red in corners:
            kw = dict(nnz=nnz, op=op, reduce=red)
            what = f"({op}, {red}) {values.dim()}-D edges"
            want = ref.batched_gspmm_coo_plain(rid, cid, values, nnz, b,
                                               op=op, reduce=red)
            g = batched_spmm_coo(rid, cid, values, b, **kw)
            if red == "max":
                assert torch.equal(g, want), what
            else:
                torch.testing.assert_close(g, want, **TOL, msg=what)
            assert torch.equal(g, batched_spmm_coo(rid, cid, values, b,
                                                   **kw)), what
            assert torch.equal(g, batched_spmm_coo(rid, cid, values, b,
                                                   plan=narrow, **kw)), what
            _same_bits_as(g, lambda **k: batched_spmm_coo_large(
                rid, cid, values, b, **kw, **k), narrow, what)
    return got


def _same_bits_as(want, large, narrow, what):
    """``large()`` (a large-matrix entry) gives ``want``'s bits (its batched
    entry's), twice, and under the ``narrow`` plan's panels and tiles."""
    got = large()
    assert torch.equal(got, want), f"{what}: large entry != batched entry"
    assert torch.equal(large(), got), f"{what}: large entry differs twice"
    assert torch.equal(large(plan=narrow), got), f"{what}: narrow plan"


@pytest.mark.parametrize("n_b", (1, 7, 48, 64, 65, 512))
@pytest.mark.parametrize("name", HYBRID_REGIMES)
def test_coo_kernel_entries_match_plain_and_are_bitwise(dev, name, n_b):
    """The six COO entries (f32, bf16 with int16 ids, g-SpMM, and their
    large-matrix entries, bf16 there with int16 and int32 ids) against
    their plain versions on the regimes with shuffled slots, out-of-range
    ids, sentinel rows and real 0.0 edges, every (op, reduce) corner with
    scalar and vector edges. n_b 1, 7 and 65 read B one column at a time,
    48, 64 and 512 four (512: four 128-column panels); the batched entries
    give identical bits twice and under another block split, and store
    0.0 in rows with no live slot."""
    from repro_torch.kernels.ops import GSPMM_OPS, GSPMM_REDUCES

    rid, cid, val, nnz, m_pad = _coo_contract_slots(name)
    corners = [(op, red) for op in GSPMM_OPS for red in GSPMM_REDUCES]
    got = _coo_entries_hold(rid, cid, val, nnz, m_pad, n_b, dev, corners)
    live = ((val != 0) & (rid >= 0) & (rid < m_pad) & (cid >= 0)
            & (cid < m_pad))
    has = torch.zeros((rid.shape[0], m_pad + 1), dtype=torch.bool)
    has[torch.arange(rid.shape[0])[:, None].expand_as(rid),
        torch.where(live, rid, m_pad).long()] = True
    assert bool((got[~has[:, :m_pad].to(dev)] == 0).all())


@pytest.mark.parametrize("n_b", (64, 512))
def test_coo_kernel_streams_past_one_run(dev, n_b):
    """Streams longer than the 4,096 slots the COO kernel buckets at a
    time: 3 matrices of 384 rows, 4,100-9,000 slots each in random order
    (a third of them on 8 hub rows), so that a row's sum runs through two
    or three runs of the stream (each block takes one column panel at n_b
    512), with the contracts' out-of-range ids, sentinel padding and 0.0
    edges."""
    rng = np.random.default_rng(7)
    lists = []
    for nnz in (4_100, 9_000, 6_500):
        hub = rng.integers(0, 8, nnz // 3)
        rows = np.concatenate([hub, rng.integers(0, 384, nnz - hub.size)])
        perm = rng.permutation(nnz)
        lists.append((rows[perm].astype(np.int32),
                      rng.integers(0, 384, nnz).astype(np.int32),
                      rng.normal(size=nnz).astype(np.float32)))
    coo = coo_from_lists(lists, [384] * 3)
    rid, cid, val = coo.row_ids, coo.col_ids, coo.values
    oob = torch.rand(rid.shape) < 0.05
    rid = torch.where(oob, 1000, rid)
    val = torch.where(torch.rand(rid.shape) < 0.05, 0.0, val)
    slot = torch.arange(coo.nnz_pad)
    rid = torch.where(slot[None, :] >= coo.nnz[:, None], 384, rid)
    _coo_entries_hold(rid, cid, val, coo.nnz, 384, n_b, dev,
                      [("mul", "sum"), ("copy_lhs", "mean"), ("add", "max")])


def test_coo_kernel_entries_hold_on_wide_matrices_in_one_run(dev):
    """140 matrices of 500 rows, up to 4,096 slots each (one run of the
    stream): a batch large enough that the COO kernel would take a whole
    matrix a block, whose buckets (500 rows) would outgrow a block's
    default 48 KB of shared memory; it splits such a matrix into row
    blocks of at most 256 rows. Every entry against its plain version, with
    the contracts' out-of-range ids, sentinel padding and 0.0 edges."""
    rng = np.random.default_rng(11)
    m_pad, lists = 500, []
    for s in range(140):
        nnz = 4_096 if s == 0 else int(rng.integers(3_000, 4_097))
        lists.append((rng.integers(0, m_pad, nnz).astype(np.int32),
                      rng.integers(0, m_pad, nnz).astype(np.int32),
                      rng.normal(size=nnz).astype(np.float32)))
    coo = coo_from_lists(lists, [m_pad] * len(lists))
    assert coo.nnz_pad == 4_096
    rid, cid, val = coo.row_ids, coo.col_ids, coo.values
    oob = torch.rand(rid.shape) < 0.05
    rid = torch.where(oob, 1000, rid)
    val = torch.where(torch.rand(rid.shape) < 0.05, 0.0, val)
    slot = torch.arange(coo.nnz_pad)
    rid = torch.where(slot[None, :] >= coo.nnz[:, None], m_pad, rid)
    _coo_entries_hold(rid, cid, val, coo.nnz, m_pad, 64, dev,
                      [("mul", "sum"), ("copy_lhs", "mean"), ("add", "max")])


def _tier_block(m_pad, live, fanout, seed):
    """A sampled block of the giant-graph tier as one matrix: its first
    ``live`` rows (the destinations) ``fanout`` N(0, 1) slots each, in row
    order, at columns drawn over all ``m_pad`` rows, as numpy from a
    seed."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(live, dtype=np.int32), fanout)
    return coo_from_lists([(r, rng.integers(0, m_pad, r.size).astype(
        np.int32), rng.normal(size=r.size).astype(np.float32))], [m_pad])


def test_coo_large_entries_at_the_tier_block(dev):
    """The giant-graph tier's first sampled block (batch 1, 33,792 rows past
    int16's range, 3,072 live rows x 10 slots, n_b 64), and its transpose
    (the dB call: rows in column order): the bf16 large-matrix entry on
    int32 ids, the f32 one and the g-SpMM (copy_lhs, mean) and (mul, max)
    corners against their plain versions (max bitwise), each the same bits
    twice."""
    from repro_torch.kernels.batched_spmm_coo import \
        batched_spmm_coo_large, batched_spmm_coo_large_bf16

    coo = _tier_block(33_792, 3_072, 10, seed=3).to(dev)
    assert coo.nnz_pad == 30_720
    b = torch.randn((1, 33_792, 64), device=dev)
    vh, bh = coo.values.to(torch.bfloat16), b.to(torch.bfloat16)
    for rid, cid in ((coo.row_ids, coo.col_ids), (coo.col_ids, coo.row_ids)):
        got = batched_spmm_coo_large_bf16(rid, cid, vh, bh)
        torch.testing.assert_close(
            got.float(), ref.batched_spmm_coo_plain(rid, cid, vh, bh).float(),
            **BF16_TOL)
        assert torch.equal(got, batched_spmm_coo_large_bf16(rid, cid, vh, bh))
        got = batched_spmm_coo_large(rid, cid, coo.values, b)
        torch.testing.assert_close(
            got, ref.batched_spmm_coo_plain(rid, cid, coo.values, b), **TOL)
        assert torch.equal(got, batched_spmm_coo_large(rid, cid, coo.values,
                                                       b))
        for op, red in (("copy_lhs", "mean"), ("mul", "max")):
            kw = dict(nnz=coo.nnz, op=op, reduce=red)
            got = batched_spmm_coo_large(rid, cid, coo.values, b, **kw)
            want = ref.batched_gspmm_coo_plain(rid, cid, coo.values, coo.nnz,
                                               b, op=op, reduce=red)
            if red == "max":
                assert torch.equal(got, want), (op, red)
            else:
                torch.testing.assert_close(got, want, **TOL)
            assert torch.equal(got, batched_spmm_coo_large(
                rid, cid, coo.values, b, **kw)), (op, red)


@pytest.mark.parametrize("m_pad,live,fanout", [(1_024, 1_024, 126),
                                                (33_792, 3_072, 25)])
def test_coo_large_entries_sort_streams_past_65536_slots(dev, m_pad, live,
                                                         fanout):
    """One matrix of more than 65,536 slots, so that the large-matrix
    branch's sort takes runs longer than 256 slots (255 runs at 1,024 rows,
    near its 256 a matrix): its first ``live`` rows ``fanout`` N(0, 1)
    slots each and row 7 1,500 more (a row longer than the 1,024 slots a
    walk block stages at once), all in random order, with the contracts'
    0.0 edges, out-of-range row ids and sentinel padding, n_b 64. At 1,024
    rows (planner case 2) every large entry gives its batched entry's bits
    (``_coo_entries_hold``); at 33,792 rows (case 3, which the batched
    entries do not take) each large entry (f32, bf16 on int32 ids, g-SpMM
    corners with scalar and vector edges) against its plain version (max
    bitwise), the same bits twice and under another panel and tile
    split."""
    from repro_torch.core.batching import plan_batched_spmm
    from repro_torch.kernels.batched_spmm_coo import \
        batched_spmm_coo_large, batched_spmm_coo_large_bf16

    rng = np.random.default_rng(13)
    rows = np.concatenate([np.repeat(np.arange(live), fanout),
                           np.full(1_500, 7)])
    perm = rng.permutation(rows.size)
    coo = coo_from_lists([(rows[perm].astype(np.int32),
                           rng.integers(0, m_pad, rows.size).astype(np.int32),
                           rng.normal(size=rows.size).astype(np.float32))],
                         [m_pad])
    assert coo.nnz_pad > 65_536
    rid, cid, val = coo.row_ids, coo.col_ids, coo.values
    rid = torch.where(torch.rand(rid.shape) < 0.02, m_pad + 1_000, rid)
    val = torch.where(torch.rand(rid.shape) < 0.02, 0.0, val)
    slot = torch.arange(coo.nnz_pad)
    rid = torch.where(slot[None, :] >= coo.nnz[:, None], m_pad, rid)
    corners = [("mul", "sum"), ("copy_lhs", "mean"), ("add", "max")]
    case = plan_batched_spmm(batch=1, m_pad=m_pad, n_b=64).case
    if case != 3:
        _coo_entries_hold(rid, cid, val, coo.nnz, m_pad, 64, dev, corners)
        return
    rid, cid, val, nnz = (t.to(dev) for t in (rid, cid, val, coo.nnz))
    b = torch.randn((1, m_pad, 64), device=dev)
    narrow = _narrow_plan(1, m_pad, 64)
    got = batched_spmm_coo_large(rid, cid, val, b)
    torch.testing.assert_close(
        got, ref.batched_spmm_coo_plain(rid, cid, val, b), **TOL)
    _same_bits_as(got, lambda **kw: batched_spmm_coo_large(rid, cid, val, b,
                                                            **kw), narrow,
                  "f32")
    vh, bh = val.to(torch.bfloat16), b.to(torch.bfloat16)
    got = batched_spmm_coo_large_bf16(rid, cid, vh, bh)
    torch.testing.assert_close(
        got.float(), ref.batched_spmm_coo_plain(rid, cid, vh, bh).float(),
        **BF16_TOL)
    _same_bits_as(got, lambda **kw: batched_spmm_coo_large_bf16(
        rid, cid, vh, bh, **kw), narrow, "bf16, int32 ids")
    slot = torch.arange(rid.shape[1], device=dev)
    vec = torch.randn(tuple(rid.shape) + (64,), device=dev) * (
        slot[None, :] < nnz[:, None])[..., None]
    for values in (val, vec):
        for op, red in corners:
            kw = dict(nnz=nnz, op=op, reduce=red)
            what = f"({op}, {red}) {values.dim()}-D edges"
            want = ref.batched_gspmm_coo_plain(rid, cid, values, nnz, b,
                                               op=op, reduce=red)
            g = batched_spmm_coo_large(rid, cid, values, b, **kw)
            if red == "max":
                assert torch.equal(g, want), what
            else:
                torch.testing.assert_close(g, want, **TOL, msg=what)
            _same_bits_as(g, lambda **k: batched_spmm_coo_large(
                rid, cid, values, b, **kw, **k), narrow, what)


@pytest.mark.parametrize("k,n", [(62, 64), (33, 20), (64, 512)])
def test_grouped_matmul_non_finite_w_stays_in_its_group(dev, k, n):
    """An inf in one group's w and a NaN in another's, each group in a
    64-row kernel tile that it shares with other groups, and an inf in the
    w of a group past the fourth of a 128-row reference tile (its rows come
    out 0): the kernel puts inf and NaN where its plain version does, only
    in rows of the bad groups, and matches it on every other row, finite
    (0 where the reference leaves 0), in the forward and in dx."""
    from repro_torch.kernels.grouped_matmul import _gmm, _row_groups, \
        _visited_groups

    # rows 0-9 g0, 10-39 g1 (inf), 40-44 g2, 45-51 g3, 52-60 g4 (inf, not
    # visited), 61-63 g5, 64-163 g6 (visited from row 128; NaN), 164-223 g7
    sizes = (10, 30, 5, 7, 9, 3, 100, 60)
    m = sum(sizes)
    rg = _row_groups(torch.tensor(sizes, dtype=torch.int32, device=dev), m,
                     len(sizes))
    visited = _visited_groups(rg, 128, 4)
    w = torch.randn((len(sizes), k, n)) / k ** 0.5
    w[1, 3, n // 2] = float("inf")
    w[4, 0, 0] = float("inf")
    w[6, k - 1, n - 1] = float("nan")
    w = w.to(dev)
    bad = ((rg == 1) | (rg == 6)) & (visited >= 0)
    assert bool((visited < 0).any()) and bool(bad.any())
    for what, a, ww in (
            ("forward", torch.randn((m, k), device=dev), w),
            ("dx", torch.randn((m, n), device=dev),
             w.transpose(1, 2).contiguous())):
        got = _gmm(a, ww, rg)
        want = ref.grouped_matmul_ref(a, visited, ww)
        assert bool((~torch.isfinite(want[bad])).any()), what
        torch.testing.assert_close(got, want, equal_nan=True, **TOL,
                                   msg=what)
        assert bool(torch.isfinite(got[~bad]).all()), what
        assert bool((got[visited < 0] == 0).all()), what
        assert torch.equal(torch.nan_to_num(got),
                           torch.nan_to_num(_gmm(a, ww, rg))), what


# (b, tq, tk, h, kv, hd, causal, window): the reference test's five corners,
# then Llama-3 heads at a ragged length, StableLM's hd 160, a bidirectional
# window and a query shorter than the keys; then head widths the f32 entry
# runs padded (48, 80, zamba2's 112), 72 (padded in both entries, to 96 /
# 80) and the widest, 256
FLASH_SHAPES = [
    (2, 64, 64, 4, 4, 32, True, 0), (1, 128, 128, 8, 2, 16, True, 0),
    (2, 96, 96, 4, 1, 32, True, 0), (1, 128, 128, 4, 4, 32, True, 48),
    (2, 64, 64, 4, 2, 32, False, 0), (1, 300, 300, 32, 8, 128, True, 0),
    (1, 200, 200, 4, 4, 160, True, 0), (2, 130, 130, 4, 2, 64, False, 70),
    (1, 50, 120, 4, 2, 64, False, 0), (1, 150, 150, 4, 2, 48, True, 0),
    (1, 150, 150, 4, 2, 72, True, 0), (1, 150, 150, 4, 2, 80, True, 0),
    (1, 150, 150, 4, 2, 112, True, 0), (1, 150, 150, 4, 2, 256, True, 0)]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain_and_is_bitwise(dev, shape,
                                                             dtype):
    """Tolerance: the reference test's, 2e-5 (f32) and 3e-2 (bf16)."""
    from repro_torch.kernels.flash_attention import KV_TILE, flash_attention

    b, tq, tk, h, kv, hd, causal, window = shape
    dt = getattr(torch, dtype)
    q = torch.randn((b, tq, h, hd), device=dev).to(dt)
    k, v = (torch.randn((b, tk, kv, hd), device=dev).to(dt) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_block=KV_TILE)
    tol = 2e-5 if dt == torch.float32 else 3e-2
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                            window=window))


def test_flash_attention_bf16_entry_runs_on_wgmma(dev):
    """The bf16 entry's SASS holds HGMMA (warpgroup MMA) instructions."""
    from repro_torch.kernels import _build

    counts = _build.sass_count("flash_attention", "flash_wgmma_kernel",
                               "HGMMA")
    assert counts and all(n > 0 for n in counts.values()), counts


def test_reduced_lm_on_the_card_matches_the_cpu(dev):
    """The reduced llama3-8b and qwen3-14b (f32) on the card against the
    same parameters on the CPU: forward under the three attention impls
    (the kernel once per layer under "pallas"), decode steps and greedy
    serving. Tolerance: f32 (1e-4, 1e-5)."""
    from repro_torch import configs, tree, tuning
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServeEngine

    for arch in ("llama3-8b", "qwen3-14b"):
        cfg = configs.get(arch).reduced()
        p = lm.init_params(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        pd = tree.tree_map(lambda t: t.to(dev), p)
        tokens = torch.randint(0, cfg.vocab, (2, 70))
        for impl in ("xla_packed", "xla_chunked", "pallas"):
            with tuning.use_flags(attention_impl=impl, q_block=32,
                                  kv_block=32):
                want = lm.forward(p, cfg, {"tokens": tokens})[0]
                before = flash_attention.launches
                got = lm.forward(pd, cfg, {"tokens": tokens.to(dev)})[0]
            launched = flash_attention.launches - before
            assert launched == (cfg.n_layers if impl == "pallas" else 0)
            torch.testing.assert_close(got.cpu(), want, **TOL,
                                       msg=f"{arch} {impl}")
        caches = {"cpu": lm.init_decode_state(cfg, 2, 16, device="cpu"),
                  "dev": lm.init_decode_state(cfg, 2, 16, device=dev)}
        for i in range(6):
            want, caches["cpu"] = lm.decode_step(p, cfg, tokens[:, i:i + 1],
                                                 caches["cpu"], i)
            got, caches["dev"] = lm.decode_step(
                pd, cfg, tokens[:, i:i + 1].to(dev), caches["dev"], i)
            torch.testing.assert_close(got.cpu(), want, **TOL)
        reqs = {w: [Request(prompt=[3, 1, 4, 1, 5][:n], max_new_tokens=5)
                    for n in (5, 2, 3)] for w in ("cpu", "dev")}
        ServeEngine(p, cfg, batch=3, max_len=32, device="cpu").run(
            reqs["cpu"])
        ServeEngine(pd, cfg, batch=3, max_len=32, device=dev).run(
            reqs["dev"])
        assert all(r.done and len(r.out) == 5 for r in reqs["dev"])
        assert [r.out for r in reqs["dev"]] == [r.out for r in reqs["cpu"]]


@pytest.mark.parametrize("name", HYBRID_REGIMES)
def test_precision_kernels_match_plain(dev, name):
    """The seven reduced-precision entries against their plain versions:
    bf16 within one bf16 ulp, i8 at the f32 tolerance (shared codes); the
    CSR and hybrid entries also give identical bits twice."""
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo_bf16
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr_bf16, \
        batched_spmm_csr_i8
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell_bf16, \
        batched_spmm_ell_i8
    from repro_torch.kernels.batched_spmm_hybrid import \
        batched_spmm_hybrid_bf16
    from repro_torch.kernels.fused_graph_conv import fused_forward_bf16

    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    k_pad = max(1, int(max_row_degree(coo, m_pad).max()))
    b = torch.randn((coo.batch, m_pad, 48), device=dev)
    bh = b.to(torch.bfloat16)
    h = coo.with_values(coo.values.to(torch.bfloat16))
    codes, scale = quantize_values_i8(coo.values)
    q = coo.with_values(codes)

    def same(got, want, tol):
        torch.testing.assert_close(got.float(), want.float(), **tol)

    e, eq = coo_to_ell(h, m_pad, k_pad), coo_to_ell(q, m_pad, k_pad)
    c, cq = coo_to_csr(h, m_pad), coo_to_csr(q, m_pad)
    ce, ceq = (narrow_col_ids(t.col_ids, m_pad) for t in (e, eq))
    cc, ccq = (narrow_col_ids(t.col_ids, m_pad) for t in (c, cq))
    same(batched_spmm_ell_bf16(ce, e.values, bh),
         ref.batched_spmm_ell_plain(ce, e.values, bh), BF16_TOL)
    same(batched_spmm_ell_i8(ceq, eq.values, scale, b),
         ref.batched_spmm_ell_plain(ceq, eq.values, b, scale), TOL)
    for kern, plain, tol in (
            (lambda: batched_spmm_csr_bf16(c.rpt, cc, c.values, bh),
             lambda: ref.batched_spmm_csr_plain(c.rpt, cc, c.values, bh),
             BF16_TOL),
            (lambda: batched_spmm_csr_i8(cq.rpt, ccq, cq.values, scale, b),
             lambda: ref.batched_spmm_csr_plain(cq.rpt, ccq, cq.values, b,
                                                scale), TOL)):
        got = kern()
        same(got, plain(), tol)
        assert torch.equal(got, kern())
    rid16, cid16 = (narrow_col_ids(t, m_pad) for t in (h.row_ids, h.col_ids))
    same(batched_spmm_coo_bf16(rid16, cid16, h.values, bh),
         ref.batched_spmm_coo_plain(rid16, cid16, h.values, bh), BF16_TOL)
    m8 = -(-m_pad // 8) * 8
    if m8 == m_pad:
        hp = plan_hybrid(batch=coo.batch, m_pad=m_pad, n_b=48,
                         nnz_pad=coo.nnz_pad, itemsize=2)
        ops_ = hybrid_operands(h.row_ids, h.col_ids, h.values, h.nnz, m_pad,
                               hp)
        h_args = ops_[:3] + (narrow_col_ids(ops_[3], m_pad),) + ops_[4:]
        got = hybrid_launch(*h_args, bh, plan=hp)
        same(got, ref.batched_spmm_hybrid_plain(*h_args, bh), BF16_TOL)
        assert torch.equal(got, hybrid_launch(*h_args, bh, plan=hp))
        same(batched_spmm_hybrid_bf16(h.row_ids, h.col_ids, h.values, h.nnz,
                                      bh, plan=hp), got, dict(atol=0, rtol=0))
    perm = torch.randperm(coo.nnz_pad, device=dev)
    adj = [h, h.__class__(h.row_ids[:, perm], h.col_ids[:, perm],
                          h.values[:, perm], h.nnz, h.n_rows)]
    rid, cid, val, nnz = stack_channels(adj)
    rid, cid = narrow_col_ids(rid, m_pad), narrow_col_ids(cid, m_pad)
    chunks = runtime_chunks(nnz)
    # 512 wide only where the bf16 X tile fits a block (not at m_pad 256)
    for n_in, n_out in ((12, 40), (512, 300))[:2 if m_pad <= 56 else 1]:
        x = torch.randn((coo.batch, m_pad, n_in), device=dev).bfloat16()
        w = (torch.randn((2, n_in, n_out), device=dev)
             / n_in ** 0.5).bfloat16()
        bias = torch.randn((2, n_out), device=dev).bfloat16()
        res = torch.randn((coo.batch, m_pad, n_out), device=dev).bfloat16()
        for epi, r in (("none", None), ("relu", res)):
            same(fused_forward_bf16(rid, cid, val, chunks, x, w, bias, r,
                                    epilogue=epi),
                 ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w,
                                            bias, r, epi), BF16_TOL)


@pytest.mark.parametrize("name", HYBRID_REGIMES)
@pytest.mark.parametrize("impl", ("pallas_ell_bf16", "pallas_csr_bf16",
                                  "pallas_coo_bf16", "pallas_ell_i8",
                                  "pallas_csr_i8", "pallas_hybrid_bf16"))
def test_precision_impls_forward_and_backward_match_the_cpu(dev, name, impl):
    """Each kernel variant's output and both gradients on the card against
    the same variant on the CPU (its plain versions): the bf16 output
    within one bf16 ulp and its gradients at tests/oracle.py's bf16
    tolerance (a one-ulp output step moves tanh's cotangent by up to one
    ulp of the output, and dB is rounded to bf16 again); i8 at the f32
    tolerance and its gradients at 3x it (the gradient rule)."""
    from repro_torch.kernels import ops

    coo, m_pad = _regime(name)
    if impl == "pallas_hybrid_bf16" and m_pad % 8:
        pytest.skip("the hybrid split takes m_pad a multiple of 8")
    k_pad = max(1, int(max_row_degree(coo, m_pad).max()))
    b0 = torch.randn((coo.batch, m_pad, 48))
    out = {}
    for where in ("cpu", dev):
        v = coo.values.to(where, copy=True).requires_grad_()
        b = b0.to(where, copy=True).requires_grad_()
        c = ops.batched_spmm(coo.to(where).with_values(v), b, impl=impl,
                             k_pad=k_pad)
        torch.tanh(c).sum().backward()
        out[str(where)] = [t.cpu() for t in (c.detach(), v.grad, b.grad)]
    bf16 = impl.endswith("bf16")
    tols = ((BF16_TOL, dict(atol=8e-2, rtol=2e-2)) if bf16
            else (TOL, dict(atol=3e-4, rtol=3e-5)))
    for i, (got, want) in enumerate(zip(out[str(dev)], out["cpu"])):
        torch.testing.assert_close(got, want, **tols[min(i, 1)])


def test_precision_case3_runs_the_large_entries_on_the_card(dev):
    """Case 3 judged at the variant's element size: m_pad 3000 fits a bf16
    B panel (planner case 1) but not an f32 one, so pallas_csr_bf16 runs
    its batched entry there while pallas_csr_i8 (f32 B), pallas_ell_i8 and
    pallas_coo_bf16 (f32 accumulator) run their large-matrix entries; each
    against the same variant on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr_bf16

    m_pad = 3000
    rows = np.array([0, 2999, 7], np.int32)
    coo = coo_from_lists([(rows, rows[::-1].copy(),
                           np.ones(3, np.float32))], [m_pad]).to(dev)
    b = torch.randn((1, m_pad, 32), device=dev)
    before = batched_spmm_csr_bf16.launches
    got = ops.batched_spmm(coo, b, impl="pallas_csr_bf16")
    assert batched_spmm_csr_bf16.launches == before + 1
    torch.testing.assert_close(got, ops.batched_spmm(
        coo.to("cpu"), b.cpu(), impl="pallas_csr_bf16").to(dev), **BF16_TOL)
    for impl in ("pallas_csr_i8", "pallas_ell_i8", "pallas_coo_bf16"):
        module, name, _ = CASE3_ENTRIES[impl]
        large = _large_wrapper(module, name)
        before = large.launches
        got = ops.batched_spmm(coo, b, impl=impl, k_pad=1)
        assert large.launches == before + 1, impl
        want = ops.batched_spmm(coo.to("cpu"), b.cpu(), impl=impl, k_pad=1)
        torch.testing.assert_close(
            got.cpu(), want, **(BF16_TOL if impl.endswith("bf16") else TOL))


@pytest.mark.parametrize("layer", (False, True))
def test_auto_on_the_card_ranks_kernels_and_matches_plain(dev, layer):
    """impl="auto" on CUDA tensors ranks the kernel impls (the CPU posture
    ranks none), runs the impl it resolved to, and agrees with the same
    call's plain version on the CPU within the f32 tolerance."""
    from repro_torch.core.graph_conv import graph_conv_batched, \
        resolve_graph_conv_impl
    from repro_torch.kernels import ops

    coo, m_pad = _regime("uniform")
    b = torch.randn((coo.batch, m_pad, 48))
    if layer:
        adj = [coo, coo]
        params = {"w": torch.randn((2, 48, 40)), "b": torch.randn((2, 40))}
        d = resolve_graph_conv_impl([a.to(dev) for a in adj], b.to(dev), 40,
                                    k_pad=8)
        d_cpu = resolve_graph_conv_impl(adj, b, 40, k_pad=8)

        def run(where):
            return graph_conv_batched(
                {k: v.to(where) for k, v in params.items()},
                [a.to(where) for a in adj], b.to(where), k_pad=8)
    else:
        d = ops.resolve_impl(coo.to(dev), b.to(dev), k_pad=8)
        d_cpu = ops.resolve_impl(coo, b, k_pad=8)

        def run(where):
            return ops.batched_spmm(coo.to(where), b.to(where), k_pad=8)
    ranked = {i for i, _ in d.scores}
    assert ranked & {"pallas_coo", "pallas_csr", "pallas_ell"}
    assert not {i for i, _ in d_cpu.scores} & {"pallas_coo", "pallas_csr",
                                                 "pallas_ell", "fused"}
    assert d.source == "model" and d.impl == d.scores[0][0]
    torch.testing.assert_close(run(dev).cpu(), run("cpu"), **TOL)


def test_measure_workload_times_every_kernel_impl_on_the_card(dev):
    """measure_workload on the card: a positive time for every kernel impl
    asked for, SpMM and layer workloads alike."""
    from repro_torch.autotune import Workload, measure_workload

    spmm = ("pallas_ell", "pallas_csr", "pallas_coo", "pallas_hybrid",
            "pallas_gemm", "pallas_csr_bf16", "pallas_ell_i8")
    w = Workload(batch=8, m_pad=24, nnz_pad=64, k_pad=8, n_b=32)
    times = measure_workload(w, spmm, device=dev, iters=2)
    assert set(times) == set(spmm) and min(times.values()) > 0
    layer = Workload(batch=8, m_pad=24, nnz_pad=64, k_pad=8, n_b=32,
                     channels=4, n_in=16)
    times = measure_workload(layer, ("fused", "fused_hybrid", "fused_bf16",
                                     "pallas_coo"), device=dev, iters=2)
    assert len(times) == 4 and min(times.values()) > 0


# -- the continuous-batching scheduler's ladder ------------------------------

SCHED_KERNELS = ("fused", "pallas_ell", "pallas_coo", "pallas_csr",
                 "gspmm_coo", "grouped_matmul")


def _sched_traffic():
    """The skewed Tox21 traffic of chip_smoke's scheduler phase: 512
    requests and the 3-rung ladder ``TierPolicy.from_requests`` gives it
    at 128-slot waves."""
    from repro_torch.scheduler import TierPolicy

    data = generate(GraphDatasetSpec.tox21_like(512, size_dist="skewed",
                                                seed=0))
    reqs = [GraphRequest(rows=list(s.rows), cols=list(s.cols),
                         features=s.features, n_nodes=s.n_nodes)
            for s in data]
    policy = TierPolicy.from_requests(
        [(s.n_nodes, max(len(r) for r in s.rows)) for s in data], levels=3,
        batch=128)
    return reqs, policy


@pytest.mark.parametrize("kernel", SCHED_KERNELS)
@pytest.mark.parametrize("rung", (0, 1, 2))
def test_kernels_at_the_scheduler_ladder_match_plain(dev, rung, kernel):
    """Kernels 1-4 and 7 on the wave each rung's own requests make (m_pad
    16 to 56, nnz_pad 32 to 88), against their plain versions: the fused
    layer, the stacked ELL, COO and CSR SpMMs, the COO kernel's g-SpMM
    entry at R-GCN's (copy_lhs, mean) and R-GCN's grouped matmul; all but
    the fused kernel twice for identical bits."""
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.kernels.grouped_matmul import _gmm, _row_groups

    reqs, policy = _sched_traffic()
    tier = policy.tiers[rung]
    cfg = GCNConfig.tox21(impl="fused", bn_mode="sample")
    params = init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                      device=dev)
    wave = GraphServeEngine(
        params, cfg, batch=tier.batch, m_pad=tier.m_pad,
        nnz_pad=tier.nnz_pad, device=dev).assemble(
        [r for r in reqs if policy.assign(r) == tier][:tier.batch])
    m, conv = tier.m_pad, params["convs"][0]
    a = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m, 64).contiguous()
    if kernel == "fused":
        rid, cid, val, nnz = stack_channels(wave.adj)
        chunks = runtime_chunks(nnz)
        torch.testing.assert_close(
            fused_forward(rid, cid, val, chunks, wave.x, conv["w"],
                          conv["b"]),
            ref.fused_graph_conv_plain(rid, cid, val, chunks, wave.x,
                                       conv["w"], conv["b"]), **TOL)
        return
    e = coo_to_ell(a, m, cfg.k_pad)
    c = coo_to_csr(a, m)
    r = cfg.channels                            # R-GCN's relations
    xt = wave.x.reshape(1, -1, 62).expand(r, -1, -1).reshape(-1, 62) \
        .contiguous()
    rg = _row_groups(torch.full((r,), xt.shape[0] // r, dtype=torch.int32,
                                device=dev), xt.shape[0], r)
    w = torch.randn((r, 62, 64), device=dev) / 8
    gs = dict(nnz=a.nnz, op="copy_lhs", reduce="mean")
    kern, plain = {
        "pallas_ell": (
            lambda: batched_spmm_ell(e.col_ids, e.values, u),
            lambda: ref.batched_spmm_ell_plain(e.col_ids, e.values, u)),
        "pallas_coo": (
            lambda: batched_spmm_coo(a.row_ids, a.col_ids, a.values, u),
            lambda: ref.batched_spmm_coo_plain(a.row_ids, a.col_ids,
                                               a.values, u)),
        "pallas_csr": (
            lambda: batched_spmm_csr(c.rpt, c.col_ids, c.values, u),
            lambda: ref.batched_spmm_csr_plain(c.rpt, c.col_ids, c.values,
                                               u)),
        "gspmm_coo": (
            lambda: batched_spmm_coo(a.row_ids, a.col_ids, a.values, u,
                                     **gs),
            lambda: ref.batched_gspmm_coo_plain(
                a.row_ids, a.col_ids, a.values, a.nnz, u, op="copy_lhs",
                reduce="mean")),
        "grouped_matmul": (lambda: _gmm(xt, w, rg),
                           lambda: ref.grouped_matmul_ref(xt, rg, w)),
    }[kernel]
    want = plain()
    got = kern()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, kern())


@pytest.mark.parametrize("impl", ("auto", "pallas_coo", "pallas_csr"))
def test_scheduler_drain_on_the_card_matches_per_request_engines(dev, impl):
    """A Scheduler on the default device (the card) drains the skewed
    traffic; each request's logits are within the f32 tolerance of the
    same request scored alone by a ``ref`` engine of the tier it rode, and
    the program cache holds one engine per tier used."""
    from repro_torch.scheduler import Scheduler, VirtualClock

    reqs, policy = _sched_traffic()
    cfg = GCNConfig.tox21(impl=impl)
    params = init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                      device=dev)
    sched = Scheduler(params, cfg, tiers=policy, clock=VirtualClock(),
                      service_model=lambda tier, n: 1e-3)
    assert sched.device.type == "cuda"
    sched.serve(reqs)
    assert all(r.done and not r.failed for r in reqs)
    used = {w.tier_key for w in sched.metrics.waves}
    assert sched.metrics.compile_count == len(used)
    assert sched.programs.jit_cache_sizes() == {}
    engines = {}
    for p in sched.completed[::7]:
        tier = p.served_tier
        if tier not in engines:
            engines[tier] = GraphServeEngine(
                params, GCNConfig.tox21(impl="ref", bn_mode="sample"),
                batch=tier.batch, m_pad=tier.m_pad, nnz_pad=tier.nnz_pad,
                device=dev)
        solo = GraphRequest(rows=p.request.rows, cols=p.request.cols,
                            features=p.request.features,
                            n_nodes=p.request.n_nodes)
        engines[tier].run_wave([solo])
        np.testing.assert_allclose(p.request.logits, solo.logits,
                                   atol=TOL["atol"], rtol=TOL["rtol"])
