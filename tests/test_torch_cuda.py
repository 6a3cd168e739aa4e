"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip without
them. On the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Each test seeds torch's generators with a fresh seed and prints it (shown
with a failure); ``REPRO_TEST_SEED=<seed>`` replays those inputs.
Atomics in the COO and fused kernels add in a run-dependent order, so the
kernels are held to the f32 tolerance (1e-4, 1e-5), not bitwise; the CSR,
hybrid and GEMM kernels have no atomics and give identical bits twice.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.batching import plan_hybrid
from repro_torch.core.formats import coo_from_lists, coo_to_csr, \
    coo_to_dense, coo_to_ell, csr_transpose, max_row_degree, random_batch, \
    random_powerlaw_batch
from repro_torch.core.gcn import GCNConfig, init_gcn
from repro_torch.core.graph_conv import stack_channels
from repro_torch.data.graphs import GraphDatasetSpec, generate
from repro_torch.kernels import ref
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


def test_case3_kernel_impls_raise_on_the_card(dev):
    """Planner case 3: the kernel impls raise on the card instead of taking
    the reference's plain per-sample path."""
    from repro_torch.kernels import ops

    m_pad = 2000
    rows = np.array([0, 1999, 7], np.int32)
    coo = coo_from_lists([(rows, rows[::-1].copy(),
                           np.ones(3, np.float32))], [m_pad]).to(dev)
    b = torch.randn((1, m_pad, 32), device=dev)
    for impl in ("pallas_coo", "pallas_ell", "pallas_csr"):
        with pytest.raises(ValueError, match="case 3"):
            ops.batched_spmm(coo, b, impl=impl, k_pad=1)


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
    rank, st, rl, cid, val, slab = hybrid_operands(
        coo.row_ids, coo.col_ids, coo.values, coo.nnz, m_pad, hp)
    got = hybrid_launch(rank, st, rl, cid, val, slab, b, plan=hp)
    torch.testing.assert_close(
        got, ref.batched_spmm_hybrid_plain(rank, st, rl, cid, val, slab, b),
        **TOL)
    assert torch.equal(got, hybrid_launch(rank, st, rl, cid, val, slab, b,
                                          plan=hp))
    torch.testing.assert_close(
        batched_spmm_hybrid(coo.row_ids, coo.col_ids, coo.values, coo.nnz, b,
                            plan=hp),
        ref.batched_spmm_coo_ref(coo, b, m_pad), **TOL)


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


@pytest.mark.parametrize("name,n_in,n_out", [
    (name, n_in, n_out) for name in HYBRID_REGIMES
    for n_in, n_out in ((12, 40), (512, 300))
    # an X tile of 256 x 512 does not fit a block (fused planner case 3)
    if (name, n_in) != ("powerlaw", 512)])
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


@pytest.mark.parametrize("impl", ("pallas_hybrid", "pallas_gemm"))
@pytest.mark.parametrize("name", HYBRID_REGIMES)
def test_new_spmm_impls_backward_match_ref(dev, name, impl):
    from repro_torch.kernels import ops

    coo, m_pad = _regime(name)
    coo = coo.to(dev)
    b0 = torch.randn((coo.batch, m_pad, 48), device=dev)
    if impl == "pallas_gemm" and m_pad == 256:
        # the dense 256 x 256 A tile does not fit a block: case 3 raises
        with pytest.raises(ValueError, match="case 3"):
            ops.batched_spmm(coo, b0, impl=impl)
        return
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
