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
from torch.distributed.tensor import Replicate

F32_TOL = (1e-4, 1e-5)          # tests/oracle.py TOLS["f32"]: (atol, rtol)
TRAIN_TOL = 1e-5                # the reference's mesh-trainer test


def run_ranks(fn, world: int, tmp: Path, payload, *,
              device_type: str = "cpu", shape=None) -> list:
    """Run ``fn(rank, mesh, payload)`` on ``world`` spawned ranks (on the
    CPU, or on the card: ranks sharing it take gloo), on a ("data",) mesh
    of ``world`` ranks, or a ("data", "model") mesh of ``shape``; returns
    the ranks' results in rank order."""
    tmp = Path(tmp)
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    torch.multiprocessing.spawn(
        _entry, args=(world, str(tmp), fn.__name__, device_type, shape),
        nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(tmp / f"result{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank: int, world: int, tmp: str, name: str,
           device_type: str, shape) -> None:
    from repro_torch.launch.mesh import close_ranks, init_ranks, make_mesh

    torch.set_num_threads(1)
    backend = init_ranks(rank, world, f"file://{tmp}/store",
                         device_type=device_type)
    if device_type == "cpu" or torch.cuda.device_count() < world:
        assert backend == "gloo", backend
    mesh = (make_mesh((world,), ("data",), device_type=device_type)
            if shape is None else
            make_mesh(tuple(shape), ("data", "model"),
                      device_type=device_type))
    with open(Path(tmp) / "payload.pkl", "rb") as f:
        payload = pickle.load(f)
    result = globals()[name](rank, mesh, payload)
    close_ranks()
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


# -- the LM on a (data x model) mesh (tests/test_torch_lm_mesh.py) ---------


def _lm_cfg(arch: str, fields: dict):
    from repro_torch import configs

    return dataclasses.replace(configs.get(arch).reduced(), **fields)


def _tensors(np_tree):
    from repro_torch import tree

    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), np_tree)


def _full(t_tree, specs, mesh):
    from repro_torch.distributed import lm_mesh

    return lm_mesh.gather_tree(t_tree, specs, mesh)


def _close_trees(what, got, want, tol) -> float:
    """Every leaf of ``got`` within ``tol`` (atol, rtol) of ``want``'s;
    returns the largest difference."""
    from repro_torch import tree

    worst = 0.0
    for i, (g, w) in enumerate(zip(tree.leaves(got), tree.leaves(want),
                                   strict=True)):
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), (what, i, g.shape, w.shape)
        close(f"{what} leaf {i}", g.float(), w.float().numpy(), tol)
        worst = max(worst, float((g.float() - w.float()).abs().max()))
    return worst


def _same_over_data(what, t_tree, mesh) -> None:
    """Every leaf bitwise equal on every rank of the data axis."""
    from repro_torch import tree
    from repro_torch.launch.mesh import all_gather_cat

    for i, t in enumerate(tree.leaves(t_tree)):
        every = all_gather_cat(t.reshape(1, -1), mesh, "data")
        for r in range(1, every.shape[0]):
            same(f"{what} leaf {i} on data rank {r}", every[r], every[0])


def _local_bytes(what, local, full, specs, mesh) -> int:
    """This rank's tensors hold exactly its shards' bytes (fewer than the
    full tree's where anything is split)."""
    from repro_torch import tree
    from repro_torch.distributed import lm_mesh

    want = sum(math.prod(lm_mesh.local_shape(t.shape, p, mesh))
               * t.element_size()
               for t, p in zip(tree.leaves(full), lm_mesh.spec_leaves(specs),
                               strict=True))
    got = sum(t.numel() * t.element_size() for t in tree.leaves(local))
    assert got == want, (what, got, want)
    return got


def _rel(a, b) -> float:
    """The relative L2 distance of tree ``a`` from tree ``b``."""
    from repro_torch import tree

    num = sum(float(((x - y).double() ** 2).sum())
              for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True))
    return (num / sum(float((y.double() ** 2).sum())
                      for y in tree.leaves(b))) ** 0.5


def _train_case(cfg, mesh, full_params, batches, case, opt):
    """``case``'s steps on the mesh and on one device from the same
    parameters, two ways.

    Free-running, six steps: the losses within TRAIN_TOL at every step
    (with the int8 compression, whose rounding turns a last-bit
    difference of a gradient into a whole quantum, within 2x the
    single-device noise floor where that is larger: the largest loss
    difference of the single-device run from the same run in another
    order of the same sums, the attention blocks doubled or another
    microbatch count); the gathered parameters bitwise equal on every data
    rank.

    Step by step: each mesh step starts from the single-device state
    before it (split as the mesh holds it), and the gathered parameters
    and moments after it are within TRAIN_TOL of the single-device step's
    in relative L2 distance (with the compression, or 2x the distance of
    the other-order runs from the single-device one at that step, where
    larger). Elementwise, Adam's update divides by the gradient's own
    scale, so a rounding difference of a gradient near 0 moves its
    parameter by up to lr, on one device too; a free-running comparison
    compounds that over the steps. The compression itself is held bit for
    bit by :func:`_compression_bits`.

    Returns the (mesh, one device) losses and the step-by-step
    distances."""
    from repro_torch import tree, tuning
    from repro_torch.distributed import lm_mesh
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.optim.adam import adam_init

    name = f"train {case}"
    compress = case["compress"]

    def state0(p, shards=None):
        s = adam_init(p, shards)
        if compress:
            s["ef_err"] = tree.tree_map(torch.zeros_like, s["m"])
        return s

    def copy(t):
        return tree.tree_map(torch.clone, t)

    def alone(mb, **flags):
        step = build_train_step(cfg, opt, device="cpu", microbatches=mb,
                                compress_grads=compress)
        p = copy(full_params)
        s = state0(p)
        out = [(None, copy(p), copy(s))]
        with tuning.use_flags(**flags):
            for b in batches:
                p, s, m = step(p, s, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
                out.append((float(m["loss"]), copy(p), copy(s)))
        return out

    with tuning.use_flags(fsdp=case["fsdp"]):
        step_m = build_train_step(cfg, opt, mesh=mesh, zero1=case["zero1"],
                                  microbatches=case["mb"],
                                  compress_grads=compress)
    shards = step_m.shards
    moments = {"m": shards.moments, "v": shards.moments,
               "step": tuple(Replicate() for _ in mesh.mesh_dim_names)}
    if compress:
        moments["ef_err"] = shards.moments
    one = alone(case["mb"])
    if compress:
        fl = tuning.flags()
        others = [alone(case["mb"], q_block=2 * fl.q_block,
                        kv_block=2 * fl.kv_block),
                  alone(2 if case["mb"] == 1 else 1)]
    p_m = lm_mesh.shard_tree(copy(full_params), shards.params, mesh)
    s_m = state0(p_m, shards)
    losses, dists = [], []
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        p_m, s_m, m_m = step_m(p_m, s_m, batch)
        losses.append((float(m_m["loss"]), one[i + 1][0]))
        tol = TRAIN_TOL
        if compress:
            tol = max(tol, 2 * max(abs(o[i + 1][0] - one[i + 1][0])
                                   for o in others))
        assert abs(losses[-1][0] - losses[-1][1]) <= tol, (
            name, "step", i, losses)
        _same_over_data(f"{name} params after step {i + 1}",
                        _full(p_m, shards.params, mesh), mesh)
        # one mesh step from the single-device state before it
        _, p_prev, s_prev = one[i]
        p_t = lm_mesh.shard_tree(copy(p_prev), shards.params, mesh)
        s_t = lm_mesh.map_specs(lambda t, q: lm_mesh.shard(t, q, mesh),
                                copy(s_prev), moments)
        p_t, s_t, _ = step_m(p_t, s_t, batch)
        d = (_rel(_full(p_t, shards.params, mesh), one[i + 1][1]),
             _rel(_full(s_t["m"], shards.moments, mesh), one[i + 1][2]["m"]))
        dists.append(d)
        lim = (TRAIN_TOL, TRAIN_TOL)
        if compress:
            lim = tuple(max(TRAIN_TOL, 2 * max(_rel(f(o[i + 1]), f(one[i + 1]))
                                               for o in others))
                        for f in (lambda r: r[1], lambda r: r[2]["m"]))
        assert d[0] <= lim[0] and d[1] <= lim[1], (
            name, "step", i, "params, m", d, lim)
    return {"losses": losses, "dists": dists}


def _compression_bits(cfg, mesh, grads, shards) -> None:
    """The sharded int8 compression of the single-device gradients (split
    as the moments are), gathered, equals the single-device compression bit
    for bit: the scale is the whole leaf's."""
    from repro_torch import tree
    from repro_torch.distributed import lm_mesh
    from repro_torch.distributed.compression import (
        ef_init,
        ef_int8_compress_decompress,
    )

    want = ef_int8_compress_decompress(grads, ef_init(grads))
    local = lm_mesh.shard_tree(grads, shards.moments, mesh)
    got = ef_int8_compress_decompress(
        local, tree.tree_map(lambda t: torch.zeros_like(t,
                                                        dtype=torch.float32),
                             local), shards)
    for what, g, w in zip(("dequantized", "residual"), got, want):
        g = lm_mesh.gather_tree(g, shards.moments, mesh)
        for i, (a, b) in enumerate(zip(tree.leaves(g), tree.leaves(w))):
            same(f"compression {what} leaf {i}", a, b)


def lm_mesh(rank: int, mesh, p: dict) -> dict:
    """One mesh shape's checks: the first step's loss and gradients
    (gathered) against the port on one device (TRAIN_TOL) and the
    reference's JAX ones (3x F32_TOL); 6 train steps of every case of
    ``p["cases"]`` (zero1 on and off, FSDP, compression, microbatches,
    active clipping) against one device (:func:`_train_case`); the sharded
    compression bit for bit; each rank's bytes equal to its shards'; prefill logits within TRAIN_TOL and greedy decode tokens
    identical (sequence-parallel and gathered caches); with ``p["moe"]``,
    Mixtral's balance loss and both dispatches, and LLaVA's patch mask."""
    from repro_torch import tuning
    from repro_torch.distributed import lm_mesh as lmm
    from repro_torch.distributed.steps import loss_and_grads, train_shards
    from repro_torch.optim.adam import AdamConfig, adam_init

    out = {"shape": tuple(mesh.shape)}
    cfg = _lm_cfg(p["arch"], p["fields"])
    full = _tensors(p["params"])
    first = {k: torch.from_numpy(v) for k, v in p["batches"][0].items()}
    with tuning.use_flags(**p["flags"]):
        # the first step's loss and gradients
        shards = train_shards(cfg, mesh)
        local = lmm.shard_tree(full, shards.params, mesh)
        loss_m, g_m = loss_and_grads(cfg, local, first, shards=shards)
        loss_1, g_1 = loss_and_grads(cfg, full, first)
        assert abs(float(loss_m) - float(loss_1)) <= TRAIN_TOL, (
            float(loss_m), float(loss_1))
        g_full = _full(g_m, shards.moments, mesh)
        out["grad_vs_local"] = _close_trees("grads", g_full, g_1,
                                            (TRAIN_TOL, 0.0))
        assert abs(float(loss_m) - p["ref_loss"]) <= 3 * F32_TOL[0]
        out["grad_vs_ref"] = _close_trees(
            "grads vs reference", g_full, p["ref_grads"],
            (3 * F32_TOL[0], 3 * F32_TOL[1]))
        out["param_bytes"] = _local_bytes("params", local, full,
                                          shards.params, mesh)
        state = adam_init(local, shards)
        out["moment_bytes"] = _local_bytes("moments", state["m"], full,
                                           shards.moments, mesh)
        _compression_bits(cfg, mesh, g_1, shards)
        del local, state
        # train steps
        opt = AdamConfig(lr=1e-2, grad_clip=p["clip"])
        out["losses"] = {str(c): _train_case(cfg, mesh, full, p["batches"],
                                             c, opt) for c in p["cases"]}
        # serving: prefill, then greedy decode
        out["serve"] = _serve_checks(cfg, mesh, full, p)
    if p.get("moe"):
        out["moe"] = _moe_checks(mesh, p["moe"])
    out["zoo"] = {arch: _zoo_checks(mesh, arch, p["flags"])
                  for arch in p["zoo"]}
    return out


def _zoo_checks(mesh, arch: str, flags: dict) -> dict:
    """Every family on the mesh against one device, reduced, seed 1: the
    first step's loss and gathered gradients, the prefill logits and 6
    decode steps' logits within TRAIN_TOL (Whisper's frames and LLaVA's
    patches in the batch; Zamba2's and RWKV-6's recurrent states gathered
    at use and re-split)."""
    from repro_torch import tuning
    from repro_torch.distributed import lm_mesh as lmm
    from repro_torch.distributed.steps import (
        build_decode_step,
        build_prefill,
        loss_and_grads,
        param_placements,
        train_shards,
    )
    from repro_torch.models import lm

    cfg = _lm_cfg(arch, {})
    full = lm.init_params(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    b, t, steps = 4, 16, 6
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn((b, 24, lm.AUDIO_DIM), generator=gen)
    if cfg.frontend == "vision_tiles":
        batch["patch_embeds"] = torch.randn((b, 4, lm.VISION_DIM),
                                            generator=gen)
    res = {}
    with tuning.use_flags(**flags):
        shards = train_shards(cfg, mesh)
        loss_m, g_m = loss_and_grads(
            cfg, lmm.shard_tree(full, shards.params, mesh), batch,
            shards=shards)
        loss_1, g_1 = loss_and_grads(cfg, full, batch)
        assert abs(float(loss_m) - float(loss_1)) <= TRAIN_TOL, arch
        res["grads"] = _close_trees(f"{arch} grads",
                                    _full(g_m, shards.moments, mesh), g_1,
                                    (TRAIN_TOL, 0.0))
        local = lmm.shard_tree(full, param_placements(cfg, mesh), mesh)
        got = build_prefill(cfg, mesh)(local, batch)
        want = build_prefill(cfg, device="cpu")(full, batch)
        close(f"{arch} prefill", got, want.numpy(), (TRAIN_TOL, 0.0))
        dec_m = build_decode_step(cfg, mesh, batch=b, cache_len=t, enc_len=24)
        dec_1 = build_decode_step(cfg, device="cpu")
        c_m = lm.init_decode_state(cfg, b, t, 24, mesh=mesh)
        c_1 = lm.init_decode_state(cfg, b, t, 24, device="cpu")
        worst = 0.0
        for pos in range(steps):
            tok = batch["tokens"][:, pos:pos + 1]
            lg_m, _ = dec_m(local, tok, c_m, pos)
            lg_1, _ = dec_1(full, tok, c_1, pos)
            close(f"{arch} decode at {pos}", lg_m, lg_1.numpy(),
                  (TRAIN_TOL, 0.0))
            worst = max(worst, float((lg_m - lg_1).abs().max()))
        res["decode"] = worst
    return res


def _serve_checks(cfg, mesh, full, p) -> dict:
    """Prefill logits within TRAIN_TOL; the prompt fed through decode then
    ``p["new_tokens"]`` greedy steps: logits within TRAIN_TOL each step and
    the same tokens, under ``constrain_decode`` on and off; each rank's
    cache bytes equal to its shards'."""
    from repro_torch import tuning
    from repro_torch.distributed import lm_mesh as lmm
    from repro_torch.distributed.sharding import cache_specs
    from repro_torch.distributed.steps import (
        build_decode_step,
        build_prefill,
        param_placements,
    )
    from repro_torch.models import lm

    prompt = torch.from_numpy(p["prompt"])
    b, t = prompt.shape
    local = lmm.shard_tree(full, param_placements(cfg, mesh), mesh)
    got = build_prefill(cfg, mesh)(local, {"tokens": prompt})
    want = build_prefill(cfg, device="cpu")(full, {"tokens": prompt})
    close("prefill logits", got, want.numpy(), (TRAIN_TOL, 0.0))
    res = {"prefill": float((got - want).abs().max())}
    cache_len = t + p["new_tokens"]
    for constrain in (True, False):
        with tuning.use_flags(constrain_decode=constrain):
            dec_m = build_decode_step(cfg, mesh, batch=b,
                                      cache_len=cache_len)
            dec_1 = build_decode_step(cfg, device="cpu")
            c_m = lm.init_decode_state(cfg, b, cache_len, mesh=mesh)
            c_1 = lm.init_decode_state(cfg, b, cache_len, device="cpu")
            toks, worst = [], 0.0
            tok_m = tok_1 = prompt[:, :1]
            for pos in range(t + p["new_tokens"] - 1):
                lg_m, _ = dec_m(local, tok_m, c_m, pos)
                lg_1, _ = dec_1(full, tok_1, c_1, pos)
                close(f"decode logits at {pos}", lg_m, lg_1.numpy(),
                      (TRAIN_TOL, 0.0))
                worst = max(worst, float((lg_m - lg_1).abs().max()))
                if pos + 1 < t:
                    tok_m = tok_1 = prompt[:, pos + 1:pos + 2]
                else:
                    tok_m, tok_1 = lg_m.argmax(-1), lg_1.argmax(-1)
                    assert torch.equal(tok_m, tok_1), (pos, tok_m, tok_1)
                    toks.append(tok_m[:, 0].tolist())
        full_c = lm.init_decode_state(cfg, b, cache_len, device="meta")
        res[f"constrain_decode={constrain}"] = {
            "tokens": toks, "worst": worst,
            "cache_bytes": _local_bytes("caches", c_m, full_c,
                                        cache_specs(full_c, mesh), mesh),
            "k_shape": tuple(c_m["0"]["k"].shape)}
    return res


def _moe_checks(mesh, p: dict) -> dict:
    """Mixtral: the first step's loss (its balance loss over the global
    means) and gradients, and 2 steps, under the grouped and the scatter
    dispatch (drops at a small capacity factor); LLaVA with patch
    embeddings (the loss masked past them): the same."""
    from repro_torch import tuning
    from repro_torch.distributed import lm_mesh as lmm
    from repro_torch.distributed.steps import loss_and_grads, train_shards
    from repro_torch.optim.adam import AdamConfig

    res = {}
    for name, case in p.items():
        cfg = _lm_cfg(case["arch"], case["fields"])
        full = _tensors(case["params"])
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        with tuning.use_flags(**case["flags"]):
            shards = train_shards(cfg, mesh)
            local = lmm.shard_tree(full, shards.params, mesh)
            loss_m, g_m = loss_and_grads(cfg, local, batch, shards=shards)
            loss_1, g_1 = loss_and_grads(cfg, full, batch)
            assert abs(float(loss_m) - float(loss_1)) <= TRAIN_TOL, (
                name, float(loss_m), float(loss_1))
            worst = _close_trees(f"{name} grads",
                                 _full(g_m, shards.moments, mesh), g_1,
                                 (TRAIN_TOL, 0.0))
            losses = _train_case(
                cfg, mesh, full, [case["batch"]] * 2, dict(
                    mb=1, compress=False, fsdp=False, zero1=True),
                AdamConfig(lr=1e-2, grad_clip=1.0))
        res[name] = {"loss": float(loss_m), "grad_diff": worst,
                     "losses": losses}
    return res


def lm_resume(rank: int, mesh, p: dict) -> dict:
    """``Trainer(mesh=)``: on the first mesh, train to ``p["stop"]`` with a
    checkpoint there; on the second mesh (or one device, ``mesh`` None),
    restore it (the re-sharded state, gathered, equal to the saved one bit
    for bit) and resume to ``p["steps"]``: the losses of the resumed steps
    within TRAIN_TOL of an unbroken run on one device."""
    import shutil

    from repro_torch.checkpoint.store import load_pytree
    from repro_torch.distributed import lm_mesh as lmm
    from repro_torch.launch.mesh import barrier
    from repro_torch.launch.train import synthetic_data
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = _lm_cfg(p["arch"], p["fields"])
    opt = AdamConfig(lr=1e-2, grad_clip=1.0)
    root = Path(p["root"])

    def trainer(name, total, mesh_=mesh):
        return Trainer(cfg, opt, TrainerConfig(
            checkpoint_dir=str(root / name), total_steps=total,
            checkpoint_every=p["stop"], log_every=1), mesh=mesh_,
            device="cpu" if mesh_ is None else None)

    def fit(t, start):
        losses = {}
        data = synthetic_data(cfg, p["batch"], p["seq"], start_step=start,
                              device="cpu")
        try:
            t.fit(data, on_metrics=lambda s, rec: losses.update(
                {s: rec["loss"]}))
        finally:
            data.close()
        return losses

    if p["phase"] == "save":
        t = trainer("run", p["stop"])
        fit(t, 0)
        return {"steps": t.manager.steps()}
    name = f"resume-{p['tag']}"
    if rank == 0:
        shutil.copytree(root / "run", root / name)
    if mesh is not None:
        barrier(mesh)
    t = trainer(name, p["steps"])
    params, state, start = t.restore_or_init()
    assert start == p["stop"], start
    saved = load_pytree(t._full_like(), str(root / name / f"step_{start:010d}"),
                        device="cpu")
    if mesh is not None:
        params = lmm.gather_tree(params, t.shards.params, mesh)
        state = lmm.gather_tree(state, t._state_specs(), mesh)
    for what, got, want in (("params", params, saved[0]),
                            ("state", state, saved[1])):
        from repro_torch import tree
        for i, (g, w) in enumerate(zip(tree.leaves(got), tree.leaves(want),
                                       strict=True)):
            same(f"restored {what} leaf {i}", g, w)
    resumed = fit(t, start)
    whole = fit(trainer(f"whole-{p['tag']}-{rank}", p["steps"], None), 0)
    if rank == 0:
        assert sorted(resumed) == list(range(start + 1, p["steps"] + 1))
        for s_, loss in resumed.items():
            assert abs(loss - whole[s_]) <= TRAIN_TOL, (s_, resumed, whole)
    return {"resumed": resumed, "whole": whole}
