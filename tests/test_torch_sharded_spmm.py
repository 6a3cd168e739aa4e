"""Port parity: the data-parallel GCN path on a device mesh
(``repro_torch.distributed.spmm``, ``launch.mesh``, ``distributed.sharding``
and ``mesh=`` through the ops, layers, engine, trainer and scheduler).

The rule functions (``Workload.shard``, ``pad_batch``, ``shard_count``,
``batch_specs``) run in-process against the reference's on the same
shapes. The mesh paths run in spawned gloo groups on the CPU (world sizes 2
and 3; 3 makes batch 16 uneven too), one spawn per test, joined through a
``FileStore`` under ``tmp_path``. This process computes the reference's
SINGLE-device results with JAX (its own mesh paths raise at uneven batches
on JAX 0.9, and its tests call its sharded paths the same sums as the
single-device ones) and hands numpy arrays to the ranks, which import only
torch and ``repro_torch`` (``tests/torch_mesh_ranks.py``). Port-sharded is
held to port-local bitwise, but for the all-reduced parameter gradients;
port against the reference within ``tests/oracle.py`` TOLS["f32"]; the
trainer's loss and gradients within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.autotune import Workload as JWorkload
from repro.core import formats as jf
from repro.core import gcn as jgcn
from repro.core.graph_conv import stack_channels as j_stack
from repro.data import graphs as jgraphs
from repro.distributed import sharding as jsharding
from repro.distributed import spmm as jspmm
from repro.kernels import ops as j_ops
from repro.kernels.fused_graph_conv import fused_graph_conv as j_fused
from repro.serving.engine import GraphRequest as JRequest
from repro.serving.engine import GraphServeEngine as JEngine
from repro_torch.autotune import Workload
from repro_torch.distributed import sharding, spmm
from test_torch_formats import to_np, torch_coo

WORLDS = (2, 3)


class _FakeMesh:
    """The axis names and shape a rule function reads, in both packages'
    spellings."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.devices = np.empty(self.shape)


def _fields(coo) -> dict:
    return {f.name: to_np(getattr(coo, f.name))
            for f in dataclasses.fields(jf.BatchedCOO)}


def _params(cfg: dict, seed: int):
    """Seed-``seed`` parameters of a port config as a numpy tree (drawn by
    the port's ``init_gcn``: the reference's op-by-op init takes seconds)
    and the same tree as the reference's."""
    from repro_torch.core.gcn import GCNConfig, init_gcn
    from repro_torch import tree

    prm = init_gcn(GCNConfig(**cfg), device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    np_prm = tree.tree_map(lambda t: t.numpy(), prm)
    return np_prm, jax.tree.map(jnp.asarray, np_prm)


# -- in-process: the rule functions ----------------------------------------


@pytest.mark.parametrize("batch,n", [(13, 8), (16, 3), (16, 1), (5, 4)])
def test_workload_shard_matches_reference(batch, n):
    kw = dict(batch=batch, m_pad=56, nnz_pad=256, k_pad=4, n_b=64,
              channels=4, n_in=62, dtype="bf16")
    got, want = Workload(**kw).shard(n), JWorkload(**kw).shard(n)
    assert got.key() == want.key()
    assert got.batch == -(-batch // n) and got.m_pad == 56


@pytest.mark.parametrize("batch,n", [(5, 4), (13, 3), (16, 2), (7, 7)])
def test_pad_batch_matches_reference(batch, n):
    rng = np.random.default_rng(batch)
    a_j, m_pad = jf.random_batch(rng, batch=batch, dim=8, nnz_per_row=2)
    b = rng.standard_normal((batch, m_pad, 4)).astype(np.float32)
    a2_j, b2_j, pad_j = jspmm.pad_batch(a_j, jnp.asarray(b), n)
    a2, b2, pad = spmm.pad_batch(torch_coo(a_j), torch.from_numpy(b), n)
    assert pad == pad_j == (-batch) % n
    np.testing.assert_array_equal(b2.numpy(), to_np(b2_j))
    for f, arr in _fields(a2_j).items():
        np.testing.assert_array_equal(getattr(a2, f).numpy(), arr, err_msg=f)


def test_shard_count_and_its_error_match_reference():
    for names, shape in ((("data",), (4,)), (("data", "model"), (2, 8)),
                         (("pod", "data", "model"), (2, 16, 16))):
        m = _FakeMesh(names, shape)
        assert spmm.shard_count(m) == jspmm.shard_count(m)
    m = _FakeMesh(("model",), (4,))
    with pytest.raises(ValueError) as want:
        jspmm.shard_count(m)
    with pytest.raises(ValueError) as got:
        spmm.shard_count(m)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("names,shape", [
    (("data",), (4,)), (("data", "model"), (4, 2)),
    (("pod", "data", "model"), (2, 2, 2)), (("model",), (8,))])
def test_batch_specs_match_reference(names, shape):
    from jax.sharding import PartitionSpec as P
    from torch.distributed.tensor import Replicate, Shard

    m = _FakeMesh(names, shape)
    leaves = {"x": np.zeros((16, 5)), "odd": np.zeros((6, 3)),
              "small": np.zeros((2,)), "scalar": np.zeros(()),
              "nested": [np.zeros((8, 2, 2))]}
    want = jsharding.batch_specs(leaves, m)
    got = sharding.batch_specs(leaves, m)
    for (k, w), g in zip(jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, P))[0],
            [got["nested"][0], got["odd"], got["scalar"], got["small"],
             got["x"]]):
        sharded = len(w) > 0 and w[0] not in (None, ())
        assert len(g) == len(names)
        if sharded:
            dp = w[0] if isinstance(w[0], tuple) else (w[0],)
            assert all(isinstance(p, Shard) and p.dim == 0
                       for p, a in zip(g, names) if a in dp), (k, g)
            assert all(isinstance(p, Replicate)
                       for p, a in zip(g, names) if a not in dp), (k, g)
        else:
            assert all(isinstance(p, Replicate) for p in g), (k, g)
    pairs = sharding.named(m, got)
    assert pairs["x"][0] is m and pairs["x"][1] == list(got["x"])


@pytest.mark.parametrize("n", [2, 3])
def test_forced_sharded_decisions_match_reference(n):
    """A pinned impl's per-shard Decision: the reference's workload key,
    case and note, for the SpMM, g-SpMM and layer resolvers."""
    from repro.core.graph_conv import resolve_graph_conv_impl as j_layer
    from repro_torch.core.graph_conv import resolve_graph_conv_impl
    from repro_torch.core.message_passing import (
        resolve_message_passing_impl,
    )

    rng = np.random.default_rng(n)
    a_j, m_pad = jf.random_batch(rng, batch=13, dim=24, nnz_per_row=3)
    a = torch_coo(a_j)
    b = np.zeros((13, m_pad, 32), np.float32)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    m = _FakeMesh(("data",), (n,))
    pairs = [(spmm.resolve_sharded_impl(a, bt, m, impl="pallas_csr",
                                        k_pad=8),
              jspmm.resolve_sharded_impl(a_j, bj, m, impl="pallas_csr",
                                         k_pad=8)),
             (resolve_message_passing_impl(a, bt, op="copy_lhs",
                                           reduce="mean", impl="pallas_coo",
                                           mesh=m),
              jspmm.resolve_sharded_gspmm_impl(a_j, bj, m, op="copy_lhs",
                                               reduce="mean",
                                               impl="pallas_coo")),
             (resolve_graph_conv_impl([a, a], bt, 16, impl="fused",
                                      k_pad=8, mesh=m),
              j_layer([a_j, a_j], bj, 16, impl="fused", k_pad=8, mesh=m))]
    for got, want in pairs:
        assert got.workload.key() == want.workload.key()
        assert got.workload.batch == -(-13 // n)
        assert (got.impl, got.source) == (want.impl, want.source)
        assert got.reason == want.reason


# -- spawned gloo groups -----------------------------------------------------


def _vjp(f, args, g):
    @jax.jit
    def fwd_bwd(args, g):
        out, vjp = jax.vjp(f, *args)
        return (out, *vjp(g))

    return tuple(map(to_np, fwd_bwd(tuple(args), jnp.asarray(g))))


@functools.lru_cache(maxsize=None)
def _ops_payload():
    rng = np.random.default_rng(0)
    spmm_cases, gspmm_cases, fused_cases = {}, {}, {}
    for batch in (16, 13):
        a, m_pad = jf.random_batch(rng, batch=batch, dim=24, nnz_per_row=3)
        b = rng.standard_normal((batch, m_pad, 32)).astype(np.float32)
        g = rng.standard_normal((batch, m_pad, 32)).astype(np.float32)
        want = _vjp(lambda v, bb: j_ops.batched_spmm(
            dataclasses.replace(a, values=v), bb, impl="ref"),
            (a.values, jnp.asarray(b)), g)
        spmm_cases[batch] = dict(a=_fields(a), b=b, g=g, want=want)

        corners = []
        live = to_np(a.values)[..., None]
        for op, reduce, edges in (("copy_lhs", "mean", "scalar"),
                                  ("mul", "max", "scalar"),
                                  ("mul", "sum", "vector"),
                                  ("add", "max", "vector")):
            n_b = 8
            shape = (batch, a.nnz_pad) + ((n_b,) if edges == "vector"
                                          else ())
            e = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            e = e * (live if edges == "vector" else live[..., 0])
            ae = dataclasses.replace(a, values=jnp.asarray(e))
            bb = rng.standard_normal((batch, m_pad, n_b)).astype(np.float32)
            gg = rng.standard_normal((batch, m_pad, n_b)).astype(np.float32)
            want = _vjp(lambda v, x, ae=ae, op=op, reduce=reduce:
                        j_ops.batched_gspmm(
                            dataclasses.replace(ae, values=v), x, op=op,
                            reduce=reduce, impl="ref"),
                        (ae.values, jnp.asarray(bb)), gg)
            corners.append(dict(op=op, reduce=reduce, edges=edges,
                                a=_fields(ae), b=bb, g=gg, want=want))
        gspmm_cases[batch] = corners

        adj = [jf.random_batch(rng, batch=batch, dim=(8, 24),
                               nnz_per_row=(1, 3))[0] for _ in range(3)]
        rids, cids, vals, nnz = j_stack(adj)
        x = rng.standard_normal((batch, 24, 10)).astype(np.float32)
        w = (rng.standard_normal((3, 10, 16)) / 4).astype(np.float32)
        bias = rng.standard_normal((3, 16)).astype(np.float32)
        gy = rng.standard_normal((batch, 24, 16)).astype(np.float32)
        want = _vjp(lambda v, xx, ww, bb_: j_fused(
            rids, cids, v, nnz, xx, ww, bb_, interpret=True),
            (vals, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)), gy)
        fused_cases[batch] = dict(rids=to_np(rids), cids=to_np(cids),
                                  vals=to_np(vals), nnz=to_np(nnz), x=x, w=w,
                                  bias=bias, g=gy, want=want)
    return dict(spmm=spmm_cases, gspmm=gspmm_cases, fused=fused_cases,
                spmm_impls=("ref", "pallas_ell", "pallas_csr", "pallas_coo",
                            "pallas_hybrid", "pallas_gemm", "auto"),
                gspmm_impls=("ref", "pallas_ell", "pallas_csr",
                             "pallas_coo"))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ops_match_local_and_reference(world, tmp_path):
    """batched_spmm(mesh=) for every kernel impl and auto, four g-SpMM
    corners (scalar and vector edges) through message_passing(mesh=), the
    fused and fused_hybrid layers: forward and every gradient at batch 16
    and 13."""
    (r0, *rest) = ranks.run_ranks(ranks.ops, world, tmp_path,
                                  _ops_payload())
    assert all(r == r0 for r in rest)
    assert len(r0["checked"]) == 2 * (7 + 4 * 4 + 2)


GCN_CFG = dict(n_features=8, channels=2, conv_widths=(16, 16), n_tasks=4)
SPEC = dict(n_samples=20, max_nodes=14, n_features=8, channels=2,
            n_tasks=4)


def _requests_raw(data):
    return [dict(rows=[np.asarray(r, np.int32) for r in s.rows],
                 cols=[np.asarray(c, np.int32) for c in s.cols],
                 features=np.asarray(s.features, np.float32),
                 n_nodes=int(s.n_nodes)) for s in data]


def _geometry(data, batch):
    nnz = max(len(r) for s in data for r in s.rows)
    return dict(batch=batch, m_pad=16, nnz_pad=-(-nnz // 8) * 8)


@functools.lru_cache(maxsize=None)
def _serve_payload():
    jcfg = jgcn.GCNConfig(**GCN_CFG, impl="ref")
    np_params, params = _params(GCN_CFG, 0)
    data = jgraphs.generate(jgraphs.GraphDatasetSpec(**SPEC))
    geo = _geometry(data, 8)
    reqs = [JRequest(rows=s.rows, cols=s.cols, features=s.features,
                     n_nodes=s.n_nodes) for s in data]
    JEngine(params, jcfg, **geo).run(reqs)

    gnn = {}
    spec = jgraphs.GraphDatasetSpec(**SPEC)
    batch = next(jgraphs.batches(data, spec, 13, seed=1))
    for layer, cfg in (("gat", dict(GCN_CFG, conv_widths=(8,), layer="gat",
                                     heads=2, impl="pallas_csr")),
                       ("rgcn", dict(GCN_CFG, conv_widths=(8,),
                                     layer="rgcn", impl="pallas_coo"))):
        jc = jgcn.GCNConfig(**dict(cfg, impl="ref"))
        np_prm, prm = _params(cfg, 1)
        want = jax.jit(lambda p, a, x, n, jc=jc: jgcn.apply_gcn(
            p, jc, a, x, n))(prm, batch["adj"], batch["x"], batch["n_nodes"])
        gnn[layer] = dict(cfg=cfg, params=np_prm,
                          adj=[_fields(a) for a in batch["adj"]],
                          x=to_np(batch["x"]),
                          n_nodes=to_np(batch["n_nodes"]), want=to_np(want))

    skew = jgraphs.generate(jgraphs.GraphDatasetSpec(
        **dict(SPEC, n_samples=24, size_dist="skewed", seed=3)))
    arrivals = np.cumsum(np.random.default_rng(5).exponential(0.004, 24))
    return dict(cfg=GCN_CFG, params=np_params, geometry=geo,
                requests=_requests_raw(data),
                logits=[np.asarray(r.logits) for r in reqs],
                serve_impls=("auto", "fused", "pallas_coo", "fused_hybrid"),
                gnn=gnn,
                sched=dict(requests=_requests_raw(skew),
                           arrivals=arrivals.tolist(), batch=8,
                           impl="pallas_coo"))


@pytest.mark.parametrize("world", WORLDS)
def test_engine_gnn_layers_and_scheduler_on_a_mesh(world, tmp_path):
    """GraphServeEngine(mesh=) waves under four impls against the
    single-device engine and the reference's; a wave that differs between
    ranks raises on every rank; device= conflicts and the production mesh
    raise; GAT and R-GCN forwards; Scheduler(mesh=) under a VirtualClock
    composes the single-device scheduler's waves."""
    out = ranks.run_ranks(ranks.serve, world, tmp_path, _serve_payload())
    assert all(o == out[0] for o in out)
    assert out[0]["sched_summary_equal"]
    assert out[0]["sched_waves"] >= 3
    assert out[0]["decision/fused"] == -(-8 // world)


@functools.lru_cache(maxsize=None)
def _train_payload():
    spec_kw = dict(SPEC, n_samples=33)
    jcfg = jgcn.GCNConfig(**GCN_CFG, impl="ref")
    np_params, params = _params(GCN_CFG, 0)
    spec = jgraphs.GraphDatasetSpec(**spec_kw)
    first = next(jgraphs.batches(jgraphs.generate(spec), spec, 10,
                                 drop_remainder=False, seed=0))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jgcn.gcn_loss(p, jcfg, b["adj"], b["x"], b["n_nodes"],
                                   b["labels"]),
        has_aux=True))(params, first)
    return dict(cfg=GCN_CFG, params=np_params, spec=spec_kw,
                batch=10, loss=float(loss),
                grads=[to_np(g) for g in jax.tree.leaves(grads)],
                grad_impls=("fused", "pallas_coo", "auto"),
                fit_impls=("fused", "pallas_csr"))


@pytest.mark.parametrize("world", WORLDS)
def test_gcn_trainer_on_a_mesh(world, tmp_path):
    """gcn_loss(mesh=) loss and gradients against the single-device step
    (1e-5) and the reference's; GCNTrainer(mesh=).fit over batches of 10,
    10, 10, 3 against the single-device fit, parameters bitwise equal
    across ranks, a resume from step 2 bitwise the uninterrupted run;
    fit_sampled raises on a mesh."""
    payload = dict(_train_payload(), tmp=str(tmp_path))
    out = ranks.run_ranks(ranks.train, world, tmp_path, payload)
    assert all(o == out[0] for o in out)
    assert out[0]["batches"] == [10, 10, 10, 3]
    assert out[0]["world"] == world
