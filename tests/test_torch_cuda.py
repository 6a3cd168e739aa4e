"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip without
them. On the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Atomics in the COO and fused kernels add in a run-dependent order, so the
kernels are held to the f32 tolerance (1e-4, 1e-5), not bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import coo_from_lists, coo_to_ell, \
    max_row_degree, random_batch
from repro_torch.core.gcn import GCNConfig, init_gcn
from repro_torch.core.graph_conv import stack_channels
from repro_torch.data.graphs import GraphDatasetSpec, generate
from repro_torch.kernels import ref
from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
from repro_torch.kernels.fused_graph_conv import fused_forward, \
    runtime_chunks
from repro_torch.serving.engine import GraphRequest, GraphServeEngine

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-5)
REGIMES = ("uniform", "skewed", "zero_nnz")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _regime(name):
    rng = np.random.default_rng(11)
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


def test_case3_kernel_impls_raise_on_the_card(dev):
    """Planner case 3: the kernel impls raise on the card instead of taking
    the reference's plain per-sample path."""
    from repro_torch.kernels import ops

    m_pad = 2000
    rows = np.array([0, 1999, 7], np.int32)
    coo = coo_from_lists([(rows, rows[::-1].copy(),
                           np.ones(3, np.float32))], [m_pad]).to(dev)
    b = torch.randn((1, m_pad, 32), device=dev)
    for impl in ("pallas_coo", "pallas_ell"):
        with pytest.raises(ValueError, match="case 3"):
            ops.batched_spmm(coo, b, impl=impl, k_pad=1)
