"""Rank programs of ``tests/test_torch_sharded_spmm.py``: each runs in a
process of its own, one rank of a gloo group on the CPU, and imports only
torch, numpy and ``repro_torch``.

:func:`run_ranks` (called by the test in the parent) writes the payload the
parent computed (inputs and the JAX reference's single-device results, as
numpy arrays) under ``tmp``, spawns ``world`` ranks joined through a
``FileStore`` there, and returns each rank's result. A rank checks as it
goes and raises on the first disagreement, which fails the spawn.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from pathlib import Path

import numpy as np
import torch

F32_TOL = (1e-4, 1e-5)          # tests/oracle.py TOLS["f32"]: (atol, rtol)
TRAIN_TOL = 1e-5                # the reference's mesh-trainer test


def run_ranks(fn, world: int, tmp: Path, payload, *,
              device_type: str = "cpu") -> list:
    """Run ``fn(rank, mesh, payload)`` on ``world`` spawned ranks (on the
    CPU, or on the card: ranks sharing it take gloo); returns the ranks'
    results in rank order."""
    tmp = Path(tmp)
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    torch.multiprocessing.spawn(
        _entry, args=(world, str(tmp), fn.__name__, device_type),
        nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(tmp / f"result{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank: int, world: int, tmp: str, name: str,
           device_type: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, make_mesh

    torch.set_num_threads(1)
    backend = init_ranks(rank, world, f"file://{tmp}/store",
                         device_type=device_type)
    if device_type == "cpu" or torch.cuda.device_count() < world:
        assert backend == "gloo", backend
    mesh = make_mesh((world,), ("data",), device_type=device_type)
    with open(Path(tmp) / "payload.pkl", "rb") as f:
        payload = pickle.load(f)
    result = globals()[name](rank, mesh, payload)
    dist.destroy_process_group()
    with open(Path(tmp) / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


# -- checks --------------------------------------------------------------


def same(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Bitwise equal (NaN where NaN)."""
    got, want = got.detach(), want.detach()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)):
        diff = float((got - want).abs().nan_to_num().max())
        raise AssertionError(f"{what}: not bitwise equal (max diff {diff})")


def close(what: str, got: torch.Tensor, want, tol=F32_TOL) -> None:
    atol, rtol = tol
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


def _coo(d: dict):
    from repro_torch.core.formats import BatchedCOO

    return BatchedCOO(*(torch.from_numpy(np.array(d[f.name]))
                        for f in dataclasses.fields(BatchedCOO)))


def _vjp(f, values, b, g):
    """(out, dvalues, db) of ``sum(f(values, b) * g)``."""
    v = values.clone().requires_grad_()
    bb = b.clone().requires_grad_()
    out = f(v, bb)
    dv, db = torch.autograd.grad((out * g).sum(), (v, bb))
    return out.detach(), dv, db


# -- the sharded ops -----------------------------------------------------


def ops(rank: int, mesh, p: dict) -> dict:
    """``sharded_batched_spmm`` (through ``batched_spmm(mesh=)``), the
    g-SpMM corners (``message_passing(mesh=)``) and the fused layer, forward
    and every gradient at each batch of the payload: against the port's
    local call bitwise (the fused dW and dbias, all-reduced, within
    F32_TOL) and against the reference's single-device results within
    F32_TOL."""
    from repro_torch.core.message_passing import message_passing
    from repro_torch.distributed.spmm import sharded_fused_graph_conv
    from repro_torch.kernels.fused_graph_conv import fused_graph_conv
    from repro_torch.kernels.ops import batched_spmm

    checked = []
    for batch, case in p["spmm"].items():
        a = _coo(case["a"])
        b, g = torch.from_numpy(case["b"]), torch.from_numpy(case["g"])
        for impl in p["spmm_impls"]:
            res = [_vjp(lambda v, bb, m=m: batched_spmm(
                dataclasses.replace(a, values=v), bb, impl=impl, k_pad=8,
                mesh=m), a.values, b, g) for m in (None, mesh)]
            for name, loc, sh, want in zip(("C", "dValues", "dB"), *res,
                                           case["want"]):
                tag = f"spmm {impl} batch {batch} {name}"
                if impl != "auto":      # auto may pick per shard
                    same(tag, sh, loc)
                close(tag, sh, want)
            checked.append(f"spmm/{impl}/{batch}")
    for batch, corners in p["gspmm"].items():
        for c in corners:
            a = _coo(c["a"])
            b, g = torch.from_numpy(c["b"]), torch.from_numpy(c["g"])
            for impl in p["gspmm_impls"]:
                res = [_vjp(lambda v, bb, m=m: message_passing(
                    dataclasses.replace(a, values=v), bb, op=c["op"],
                    reduce=c["reduce"], impl=impl, k_pad=8, mesh=m),
                    a.values, b, g) for m in (None, mesh)]
                for name, loc, sh, want in zip(("C", "dValues", "dB"), *res,
                                               c["want"]):
                    tag = (f"gspmm {c['op']}-{c['reduce']} {c['edges']} "
                           f"{impl} batch {batch} {name}")
                    same(tag, sh, loc)
                    close(tag, sh, want)
                checked.append(f"gspmm/{c['op']}-{c['reduce']}/{impl}/"
                               f"{batch}")
    for batch, case in p["fused"].items():
        t = {k: torch.from_numpy(v) for k, v in case.items()
             if isinstance(v, np.ndarray)}
        ids = (t["rids"], t["cids"])
        for impl in ("fused", "fused_hybrid"):
            res = []
            for sharded in (False, True):
                leaves = [t[k].clone().requires_grad_()
                          for k in ("vals", "x", "w", "bias")]
                if sharded:
                    y = sharded_fused_graph_conv(*ids, leaves[0], t["nnz"],
                                                 *leaves[1:], mesh=mesh,
                                                 impl=impl)
                else:
                    y = fused_graph_conv(*ids, leaves[0], t["nnz"],
                                         *leaves[1:], impl=impl)
                grads = torch.autograd.grad((y * t["g"]).sum(), leaves)
                res.append((y.detach(), *grads))
            for name, loc, sh, want in zip(
                    ("Y", "dValues", "dX", "dW", "dbias"), *res,
                    case["want"]):
                tag = f"{impl} batch {batch} {name}"
                if name in ("dW", "dbias"):
                    close(tag, sh, loc.numpy())
                else:
                    same(tag, sh, loc)
                close(tag, sh, want)
            checked.append(f"{impl}/{batch}")
    # the distributed layer's telemetry span carries the per-shard key
    from repro_torch.observability import TRACER, telemetry

    case = p["spmm"][13]
    a, b = _coo(case["a"]), torch.from_numpy(case["b"])
    TRACER.clear()
    with telemetry():
        batched_spmm(a, b, impl="pallas_csr", mesh=mesh)
    (ev,) = [e for e in TRACER.events()
             if e.name == "sharded_spmm/pallas_csr"]
    n = mesh.shape[0]
    assert ev.args["n_shards"] == n and ev.args["padded"] == bool(13 % n)
    assert ev.args["key"].startswith(f"b{-(-13 // n)}_"), ev.args
    return {"checked": checked}


# -- serving and GNN layers ----------------------------------------------


def _requests(raw):
    from repro_torch.serving.engine import GraphRequest

    return [GraphRequest(rows=list(r["rows"]), cols=list(r["cols"]),
                         features=r["features"], n_nodes=r["n_nodes"])
            for r in raw]


def _gcn_cfg(d: dict, **kw):
    from repro_torch.core.gcn import GCNConfig

    return GCNConfig(**{**d, **kw})


def serve(rank: int, mesh, p: dict) -> dict:
    """``GraphServeEngine(mesh=)`` waves, GAT and R-GCN forwards under the
    mesh, and ``Scheduler(mesh=)`` under a VirtualClock: each against the
    port's single-device run (bitwise) and the reference (F32_TOL); a wave
    whose composition differs between ranks raises on every rank."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core.gcn import apply_gcn
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.scheduler import (
        Scheduler,
        SchedulerConfig,
        TierPolicy,
        VirtualClock,
    )
    from repro_torch.serving.engine import GraphServeEngine

    out = {}
    cfg = _gcn_cfg(p["cfg"])
    params = params_from_jax(p["params"], cfg, device="cpu")
    geo = p["geometry"]
    for impl in p["serve_impls"]:
        c = dataclasses.replace(cfg, impl=impl)
        local = GraphServeEngine(params, c, device="cpu", **geo)
        meshed = GraphServeEngine(params, c, mesh=mesh, **geo)
        r_loc = local.run(_requests(p["requests"]))
        r_sh = meshed.run(_requests(p["requests"]))
        assert all(r.done for r in r_sh), impl
        for i, (rl, rs, want) in enumerate(zip(r_loc, r_sh, p["logits"])):
            tag = f"engine {impl} request {i}"
            same(tag, torch.from_numpy(rs.logits), torch.from_numpy(
                rl.logits))
            close(tag, torch.from_numpy(rs.logits), want)
        out[f"decision/{impl}"] = meshed.layer_decision().workload.batch
    # every rank must serve the same wave
    eng = GraphServeEngine(params, cfg, mesh=mesh, **geo)
    reqs = _requests(p["requests"])
    try:
        eng.run_wave(reqs[:2] if rank == 0 else reqs[:1])
    except ValueError as e:
        assert "different waves" in str(e), e
    else:
        raise AssertionError("a wave that differs between ranks ran")
    for bad, err in (((lambda: GraphServeEngine(
            params, cfg, mesh=mesh, device="meta", **geo)), ValueError),
                     (make_production_mesh, RuntimeError)):
        try:
            bad()
        except err:
            pass
        else:
            raise AssertionError(f"{bad} did not raise {err.__name__}")

    for layer, case in p["gnn"].items():
        c = _gcn_cfg(case["cfg"])
        prm = params_from_jax(case["params"], c, device="cpu")
        adj = [_coo(a) for a in case["adj"]]
        x, n = torch.from_numpy(case["x"]), torch.from_numpy(case["n_nodes"])
        loc = apply_gcn(prm, c, adj, x, n)
        sh = apply_gcn(prm, c, adj, x, n, mesh=mesh)
        same(f"{layer} forward", sh, loc)
        close(f"{layer} forward", sh, case["want"])

    s = p["sched"]
    scfg = _gcn_cfg(p["cfg"], impl=s["impl"])
    policy = TierPolicy.from_requests(
        [(r["n_nodes"], max(len(x) for x in r["rows"]))
         for r in s["requests"]], levels=2, batch=s["batch"])
    runs = []
    for m in (None, mesh):
        sched = Scheduler(params, scfg, tiers=policy, clock=VirtualClock(),
                          config=SchedulerConfig(flush_after=0.05),
                          service_model=lambda tier, n: 0.01 + 1e-4 * n,
                          mesh=m, device="cpu" if m is None else None)
        reqs = _requests(s["requests"])
        sched.serve(reqs, arrivals=s["arrivals"])
        waves = sorted((p_.seq, p_.served_tier.key, p_.dispatch, p_.finish)
                       for p_ in sched.completed)
        runs.append((reqs, waves, sched.metrics.summary()))
    (r_loc, w_loc, m_loc), (r_sh, w_sh, m_sh) = runs
    assert all(r.done for r in r_sh)
    assert w_sh == w_loc, (w_sh, w_loc)
    for i, (rl, rs) in enumerate(zip(r_loc, r_sh)):
        same(f"scheduler request {i}", torch.from_numpy(rs.logits),
             torch.from_numpy(rl.logits))
    out["sched_waves"] = len({w[2] for w in w_sh})
    out["sched_summary_equal"] = m_sh == m_loc
    return out


# -- training --------------------------------------------------------------


def _batches(p: dict, batch_size: int):
    from repro_torch.data.graphs import GraphDatasetSpec, batches, generate

    spec = GraphDatasetSpec(**p["spec"])
    return list(batches(generate(spec), spec, batch_size,
                        drop_remainder=False, seed=0))


def _flat(params) -> torch.Tensor:
    from repro_torch import tree

    return torch.cat([t.detach().reshape(-1) for t in tree.leaves(params)])


def train(rank: int, mesh, p: dict) -> dict:
    """``gcn_loss(mesh=)`` loss and gradients against the single-device
    step (TRAIN_TOL) and the reference's (F32_TOL); ``GCNTrainer(mesh=)``
    ``fit`` against the single-device fit (TRAIN_TOL), its parameters
    bitwise equal across ranks, a resume from a mid-run checkpoint giving
    the uninterrupted mesh run's parameters bitwise; ``fit_sampled``
    raising."""
    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.core.gcn import gcn_loss
    from repro_torch.launch.mesh import all_gather_cat
    from repro_torch.training.trainer import GCNTrainer, TrainerConfig

    tmp = Path(p["tmp"])
    cfg = _gcn_cfg(p["cfg"])
    data = _batches(p, p["batch"])
    first = data[0]
    out = {"steps": len(data), "batches": [b["x"].shape[0] for b in data]}
    for impl in p["grad_impls"]:
        c = dataclasses.replace(cfg, impl=impl)
        params = params_from_jax(p["params"], c, device="cpu")
        res = []
        for m in (None, mesh):
            live = [t.detach().requires_grad_() for t in tree.leaves(params)]
            loss, _ = gcn_loss(tree.unflatten(params, live), c, first["adj"],
                               first["x"], first["n_nodes"], first["labels"],
                               mesh=m)
            res.append((loss.detach(), torch.autograd.grad(loss, live)))
        (l_loc, g_loc), (l_sh, g_sh) = res
        assert abs(float(l_sh) - float(l_loc)) <= TRAIN_TOL, (impl, l_sh,
                                                               l_loc)
        assert abs(float(l_sh) - p["loss"]) <= TRAIN_TOL, (impl, l_sh)
        for i, (a, b, want) in enumerate(zip(g_sh, g_loc, p["grads"])):
            close(f"{impl} grad leaf {i} vs local", a, b.numpy(),
                  (TRAIN_TOL, 0.0))
            close(f"{impl} grad leaf {i} vs reference", a, want)
    for impl in p["fit_impls"]:
        c = dataclasses.replace(cfg, impl=impl)

        def fit(m, name, batches, every=100):
            tc = TrainerConfig(str(tmp / f"{impl}-{name}"), log_every=1,
                               checkpoint_every=every)
            tr = GCNTrainer(c, tcfg=tc, mesh=m,
                            device="cpu" if m is None else None)
            params, _, last = tr.fit(batches)
            return params, last

        p_loc, last_loc = fit(None, f"local{rank}", data)
        p_sh, last_sh = fit(mesh, "mesh", data, every=2)
        assert abs(last_sh["loss"] - last_loc["loss"]) <= TRAIN_TOL, (
            impl, last_sh, last_loc)
        close(f"{impl} fit params vs local", _flat(p_sh),
              _flat(p_loc).numpy(), (TRAIN_TOL, 0.0))
        every = all_gather_cat(_flat(p_sh)[None], mesh)
        same(f"{impl} params across ranks", every,
             every[:1].expand_as(every))
        # the resume: 2 steps, a new trainer on the whole stream
        fit(mesh, "resume", data[:2], every=2)
        p_res, _ = fit(mesh, "resume", data, every=2)
        same(f"{impl} resumed params", _flat(p_res), _flat(p_sh))
    tr = GCNTrainer(cfg, tcfg=TrainerConfig(str(tmp / "sampled")), mesh=mesh)
    try:
        tr.fit_sampled(None)
    except ValueError as e:
        assert "single-host" in str(e), e
    else:
        raise AssertionError("fit_sampled ran on a mesh")
    out["n_params"] = int(_flat(p_sh).numel())
    out["grad_leaves"] = len(p["grads"])
    out["world"] = math.prod(mesh.shape)
    return out


# -- on the card -------------------------------------------------------------


def card(rank: int, mesh, p: dict) -> dict:
    """The sharded forward and backward of each kernel impl of
    ``p["impls"]`` on the card against its single-device kernel: the
    row-owned SpMM kernels bitwise, the fused layers (integer-atomic row
    buckets) and their all-reduced dW and dbias within F32_TOL; each mesh
    run launches its kernel. Inputs from ``p["seed"]``, the same on every
    rank."""
    from repro_torch.core.formats import random_batch
    from repro_torch.core.graph_conv import stack_channels
    from repro_torch.distributed.spmm import sharded_fused_graph_conv
    from repro_torch.kernels import fused_graph_conv as fgc
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.kernels.ops import batched_spmm
    from repro_torch.launch.mesh import mesh_device

    dev = mesh_device(mesh)
    kernel = {"pallas_coo": batched_spmm_coo, "pallas_csr": batched_spmm_csr,
              "pallas_ell": batched_spmm_ell, "fused": fgc.fused_forward,
              "fused_hybrid": fgc.fused_hybrid_forward}
    rng = np.random.default_rng(p["seed"])
    gen = torch.Generator().manual_seed(p["seed"])

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def close_to(what, got, want):
        close(what, got.cpu(), want.cpu().numpy())

    launched = {}
    for batch in (16, 13):
        a, m_pad = random_batch(rng, batch=batch, dim=(8, 48),
                                nnz_per_row=(1, 4))
        a = a.to(dev)
        a = a.with_values(torch.where(a.values != 0,
                                      randn(*a.values.shape), 0.0))
        b, g = randn(batch, m_pad, 64), randn(batch, m_pad, 64)
        adj = [random_batch(rng, batch=batch, dim=(8, 48),
                            nnz_per_row=(1, 4))[0].to(dev) for _ in range(4)]
        rids, cids, vals, nnz = stack_channels(adj)
        m_layer = 48
        x, w, bias = randn(batch, m_layer, 62), randn(4, 62, 64) / 8, \
            randn(4, 64)
        gy = randn(batch, m_layer, 64)
        for impl in p["impls"]:
            res = []
            for m in (None, mesh):
                kernel[impl].launches = 0
                if impl.startswith("fused"):
                    def f(v, xx, ww, bb, m=m):
                        if m is None:
                            return fgc.fused_graph_conv(
                                rids, cids, v, nnz, xx, ww, bb, impl=impl)
                        return sharded_fused_graph_conv(
                            rids, cids, v, nnz, xx, ww, bb, mesh=m,
                            impl=impl)
                    leaves = [t.clone().requires_grad_()
                              for t in (vals, x, w, bias)]
                    out = f(*leaves)
                    grads = torch.autograd.grad((out * gy).sum(), leaves)
                else:
                    leaves = [a.values.clone().requires_grad_(),
                              b.clone().requires_grad_()]
                    out = batched_spmm(a.with_values(leaves[0]), leaves[1],
                                       impl=impl, k_pad=8, mesh=m)
                    grads = torch.autograd.grad((out * g).sum(), leaves)
                res.append((out.detach(), *grads))
                launched[impl] = kernel[impl].launches
                assert kernel[impl].launches > 0, (impl, m)
            for i, (loc, sh) in enumerate(zip(*res)):
                tag = f"card {impl} batch {batch} output {i}"
                if impl.startswith("fused"):
                    close_to(tag, sh, loc)
                else:
                    same(tag, sh.cpu(), loc.cpu())
    return {"launched": launched}
