"""The trainers: the LM ``Trainer`` (the reference's, on one device or a
mesh) and
ChemGCN training (``GCNTrainer``), the reference's ``GCNTrainer`` over
batched SpMM (§IV-D, §V-B).

``Trainer`` runs the step of :func:`repro_torch.distributed.steps.
build_train_step` (microbatches, remat, int8 error-feedback compression,
Adam with clipping) on its device, from a pull-based batch iterator. As in
the reference: the loss stays on the device and syncs only every
``log_every`` steps (and at the last), when a ``{"step", "loss", "time"}``
line is appended to ``metrics.jsonl`` in the checkpoint directory;
checkpoints every ``checkpoint_every`` steps; a SIGTERM during ``fit``
ends the loop after the current step with one final checkpoint; a restart
resumes from the newest checkpoint (the caller's iterator starts at that
step: ``synthetic_data(..., start_step=)``). ``Trainer(mesh=)`` trains on
a (data × model) ``DeviceMesh``, each rank holding its shards of the
state; checkpoints hold the full tensors, written by rank 0, so a restart
on another mesh shape (or one device) re-shards them.

One ``GCNTrainer`` step is the reference's jitted step run eagerly on the
trainer's device: value and grad of :func:`repro_torch.core.gcn.gcn_loss`,
the global gradient norm, then :func:`repro_torch.optim.adam.adam_update`
(in place). On the GPU the kernel impls run their kernels forward and
backward; on the CPU their plain versions. Loss, accuracy and gradient norm
stay tensors on the device between log points (every ``tcfg.log_every``
steps with telemetry on, and the end of each epoch), so no other step waits
for the device. Checkpoints of both trainers are the reference's format: a
checkpoint either package wrote resumes in the other.

``GCNTrainer``'s telemetry, as in the reference: every step records a ``train/step`` span
and a wall-time sample of the ``train_step_seconds`` histogram on
``registry`` (the process default unless one is passed), and counts
``train_steps_total``; the loss, accuracy, gradient-norm and graphs/s
gauges sync on the ``log_every`` cadence. All series are labelled
``{layer, impl}``. ``telemetry=False`` opts the trainer out.

``fit_sampled`` trains over the giant-graph tier's sampled minibatches
(``repro_torch.sampling.SampledNodeLoader``, DESIGN.md §14): per-layer
block-aware decisions (:meth:`GCNTrainer.block_decisions`), the blocks
moved to the device on the trainer's thread, the step of ``train_step`` on
:func:`~repro_torch.core.gcn.gcn_node_loss`, under a
``train/sampled_step`` span, with the ``train_sampled_programs`` gauge.

``GCNTrainer(mesh=)`` trains data-parallel over a ``DeviceMesh``: every rank
runs ``fit`` on the same batches, each conv layer's batch is split over the
mesh's ``"data"`` axis (``repro_torch.distributed.spmm``, whose backward
all-gathers the sharded gradients and all-reduces the fused layer's dW and
dbias), and everything else runs on global tensors, so every rank holds the
same parameters with no gradient all-reduce of its own. Rank 0 writes the
checkpoints; every rank waits for the write, then restores. ``fit_sampled``
raises on a mesh, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import time
from typing import Callable, Iterator

import torch
from torch.distributed.tensor import Replicate

from repro_torch import resolve_device, tree
from repro_torch.autotune.cost_model import precision_of
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.core.formats import BatchedCOO, validate_ell_k_pad
from repro_torch.core.gcn import (
    GCNConfig,
    check_config,
    gcn_loss,
    gcn_node_loss,
    init_gcn,
    resolve_conv_impls,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import lm_mesh
from repro_torch.distributed.steps import build_train_step, shaped_params
from repro_torch.kernels.ops import IMPLS, check_impl
from repro_torch.launch.mesh import all_reduce_max, barrier
from repro_torch.models import lm
from repro_torch.observability import TRACER, default_registry
from repro_torch.optim.adam import (
    AdamConfig,
    adam_init,
    adam_update,
    global_norm,
)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The reference's ``TrainerConfig``, its defaults included
    (``GCNTrainer`` reads the first five fields). ``checkpoint_dir`` has no
    default: the port writes only where it is told to."""

    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    total_steps: int = 100
    microbatches: int = 1
    remat: bool = False
    compress_grads: bool = False
    zero1: bool = True            # on a mesh: Adam moments split over "data"


class Trainer:
    """LM pretraining of ``cfg`` with ``opt`` on ``device`` (the current
    CUDA device unless the caller asks for another), or on every rank of
    ``mesh`` (a ``DeviceMesh``; the mesh's device, and a conflicting
    ``device=`` raises). On a mesh every rank runs ``fit`` on the same
    global batches and holds only its shards of the parameters and the
    Adam state (``distributed.steps``: ``tcfg.zero1`` splits the moments
    over "data"); rank 0 writes the metrics and the checkpoints, which hold
    the full tensors (every rank waits for the write), and a restore
    re-shards them for the current mesh, so a run saved on one mesh
    resumes on another or on one device."""

    def __init__(self, cfg: ModelConfig, opt: AdamConfig, tcfg: TrainerConfig,
                 *, mesh=None, device=None):
        self.cfg, self.opt, self.tcfg, self.mesh = cfg, opt, tcfg, mesh
        self.device = resolve_device(device, mesh)
        self.manager = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        self._step_fn = build_train_step(
            cfg, opt, mesh=mesh, microbatches=tcfg.microbatches,
            remat=tcfg.remat, compress_grads=tcfg.compress_grads,
            zero1=tcfg.zero1, device=self.device)
        self.shards = self._step_fn.shards
        self._interrupted = False

    @property
    def is_writer(self) -> bool:
        """Whether this process writes metrics and checkpoints."""
        return self.mesh is None or self.mesh.get_rank() == 0

    # -- state ---------------------------------------------------------

    def _state_specs(self) -> dict:
        """Placements of the Adam state's entries (the moments' and the
        residuals' by ``shards.moments``, ``step`` replicated)."""
        m = self.shards.moments
        specs = {"m": m, "v": m, "step": tuple(
            Replicate() for _ in self.mesh.mesh_dim_names)}
        if self.tcfg.compress_grads:
            specs["ef_err"] = m
        return specs

    def init_state(self):
        """Fresh parameters from ``tcfg.seed`` (a ``torch.Generator`` on the
        device: not the reference's numbers), zero Adam state and, with
        ``compress_grads``, zero residuals ``ef_err``; on a mesh, this
        rank's shards of them (the parameters are drawn whole, as on one
        device, then split)."""
        params = lm.init_params(
            self.cfg, generator=torch.Generator(
                device=self.device).manual_seed(self.tcfg.seed),
            device=self.device)
        if self.mesh is not None:
            params = lm_mesh.shard_tree(params, self.shards.params,
                                        self.mesh)
        opt_state = adam_init(params, self.shards)
        if self.tcfg.compress_grads:
            opt_state["ef_err"] = tree.tree_map(torch.zeros_like,
                                                opt_state["m"])
        return params, opt_state

    def restore_or_init(self):
        """(params, opt_state, step): the newest checkpoint and its step,
        or a fresh state at step 0."""
        latest = self.manager.latest_step()
        if latest is None:
            params, opt_state = self.init_state()
            return params, opt_state, 0
        if self.mesh is None:
            params, opt_state = self.manager.restore(latest,
                                                     self.init_state())
            return params, opt_state, latest
        like = self._full_like()
        params, opt_state = self.manager.restore(latest, like, device="cpu")
        params = lm_mesh.map_specs(
            lambda t, p: lm_mesh.shard(t, p, self.mesh).to(self.device),
            params, self.shards.params)
        opt_state = lm_mesh.map_specs(
            lambda t, p: lm_mesh.shard(t, p, self.mesh).to(self.device),
            opt_state, self._state_specs())
        return params, opt_state, latest

    def _full_like(self):
        """The full (params, opt_state) tree as meta tensors."""
        params = shaped_params(self.cfg)

        def f32(t):
            return torch.empty(t.shape, dtype=torch.float32, device="meta")

        state = {"m": tree.tree_map(f32, params),
                 "v": tree.tree_map(f32, params),
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
        if self.tcfg.compress_grads:
            state["ef_err"] = tree.tree_map(f32, params)
        return params, state

    def save(self, step: int, params, opt_state) -> None:
        """Checkpoint ``(params, opt_state)`` at ``step``; on a mesh every
        rank gathers the full tensors (to the host, leaf by leaf), rank 0
        writes them, and every rank returns once the write is done."""
        if self.mesh is None:
            self.manager.save(step, (params, opt_state))
            return

        def full(t, p):
            return lm_mesh.gather(t, p, self.mesh).cpu()

        whole = (lm_mesh.map_specs(full, params, self.shards.params),
                 lm_mesh.map_specs(full, opt_state, self._state_specs()))
        if self.is_writer:
            self.manager.save(step, whole)
        barrier(self.mesh)

    # -- loop ----------------------------------------------------------

    def _on_sigterm(self, *_):
        self._interrupted = True

    def _stop(self) -> bool:
        """Whether to end the loop: this process had a SIGTERM or, on a
        mesh, any rank had one (every rank stops after the same step)."""
        if self.mesh is None:
            return self._interrupted
        flag = torch.tensor([float(self._interrupted)], device=self.device)
        for axis in self.mesh.mesh_dim_names:
            flag = all_reduce_max(flag, self.mesh, axis)
        return bool(flag.item())

    def fit(self, data_iter: Iterator[dict],
            on_metrics: Callable[[int, dict], None] | None = None):
        """Train from the newest checkpoint (or step 0) to
        ``tcfg.total_steps``, one batch of ``data_iter`` a step (the global
        batch on every rank of a mesh). Returns (params, opt_state), this
        rank's shards on a mesh. The metrics file and ``on_metrics`` are
        rank 0's."""
        tcfg = self.tcfg
        params, opt_state, start = self.restore_or_init()
        old_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        log_path = os.path.join(tcfg.checkpoint_dir, "metrics.jsonl")
        step = start
        stopped = False
        try:
            for step in range(start, tcfg.total_steps):
                batch = next(data_iter)
                params, opt_state, metrics = self._step_fn(
                    params, opt_state, batch)
                if (step + 1) % tcfg.log_every == 0 or \
                        step + 1 == tcfg.total_steps:
                    loss = float(metrics["loss"])   # the sync point
                    rec = {"step": step + 1, "loss": loss,
                           "time": time.time()}
                    if self.is_writer:
                        with open(log_path, "a") as f:
                            f.write(json.dumps(rec) + "\n")
                        if on_metrics:
                            on_metrics(step + 1, rec)
                if (step + 1) % tcfg.checkpoint_every == 0:
                    self.save(step + 1, params, opt_state)
                if self._stop():
                    stopped = True
                    break
        finally:
            signal.signal(signal.SIGTERM, old_handler)
        if stopped:
            # preemption: one final durable checkpoint before returning
            self.save(step + 1, params, opt_state)
        return params, opt_state


# the ELL class, whose conversion silently drops > k_pad nnz per row
_ELL_IMPLS = tuple(i for i in IMPLS
                   if precision_of(i)[0] in ("ell", "pallas_ell"))


class GCNTrainer:
    """Trains ChemGCN with ``cfg.impl`` (``"auto"`` resolved per conv
    layer and batch shape) on ``device`` (the current CUDA device unless
    the caller asks for another; under ``mesh=``, the mesh's device, and a
    conflicting ``device=`` raises)."""

    def __init__(self, cfg: GCNConfig, opt: AdamConfig | None = None,
                 tcfg: TrainerConfig | None = None, *, mesh=None,
                 device=None, registry=None, telemetry: bool = True):
        if tcfg is None:
            raise ValueError("GCNTrainer needs a TrainerConfig with a "
                             "checkpoint_dir")
        check_config(cfg)
        check_impl(cfg.impl)
        self.cfg = cfg
        self.opt = opt or AdamConfig(lr=3e-3)
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self.manager = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        # batch shape → whether any conv layer runs an ELL-class impl there
        self._ell_by_shape: dict[tuple, bool] = {}
        self.telemetry = telemetry
        self.registry = registry if registry is not None else \
            default_registry()
        self._m_step_s = self.registry.histogram(
            "train_step_seconds", "per-step wall time (dispatch-paced)")
        self._m_steps = self.registry.counter(
            "train_steps_total", "training steps executed")
        self._m_loss = self.registry.gauge("train_loss", "last synced loss")
        self._m_acc = self.registry.gauge(
            "train_accuracy", "last synced accuracy")
        self._m_gnorm = self.registry.gauge(
            "train_grad_norm", "last synced global gradient L2 norm")
        self._m_tput = self.registry.gauge(
            "train_graphs_per_s", "graphs/s over the last log window")
        self._block_impl_memo: dict[tuple, tuple] = {}

    def _needs_ell_guard(self, batch: dict) -> bool:
        """Whether an ELL-class impl runs on this batch's shapes: pinned, or
        the resolution of any conv layer under ``auto`` (shape-keyed and
        memoized; the degree check itself runs on every such batch)."""
        cfg = self.cfg
        if cfg.k_pad is None or cfg.impl not in ("auto",) + _ELL_IMPLS:
            return False
        x = batch["x"]
        key = (x.shape[0], x.shape[1], max(a.nnz_pad for a in batch["adj"]))
        if key not in self._ell_by_shape:
            self._ell_by_shape[key] = (
                cfg.impl in _ELL_IMPLS
                or any(d.impl in _ELL_IMPLS for d in resolve_conv_impls(
                    cfg, *key, itemsize=x.element_size(),
                    device=self.device, mesh=self.mesh)))
        return self._ell_by_shape[key]

    def layer_decision(self, batch: dict):
        """The first conv layer's ``repro_torch.autotune.Decision`` for one
        training batch, as the step resolves it on the trainer's device:
        fused kernel against stacked SpMM for ``layer="gcn"``, the g-SpMM
        workload for ``"gat"`` and ``"rgcn"``; under a mesh, the per-shard
        decision. The batch may lie on the host: only its shapes are
        read."""
        adj, x = batch["adj"], batch["x"]
        nnz_pad = (max(a.nnz_pad for a in adj) if self.cfg.layer == "gcn"
                   else adj[0].row_ids.shape[1])
        return resolve_conv_impls(self.cfg, x.shape[0], x.shape[1], nnz_pad,
                                  itemsize=x.element_size(),
                                  device=self.device, mesh=self.mesh)[0]

    def init_state(self):
        """Fresh parameters from ``tcfg.seed`` (a ``torch.Generator``: not
        the reference's numbers) and zero Adam state."""
        params = init_gcn(self.cfg, device=self.device,
                          generator=torch.Generator().manual_seed(
                              self.tcfg.seed))
        return params, adam_init(params)

    def restore_or_init(self):
        """(params, state, step): the newest checkpoint in
        ``tcfg.checkpoint_dir`` and its step, or a fresh state at step 0."""
        params, state = self.init_state()
        latest = self.manager.latest_step()
        if latest is not None:
            params, state = self.manager.restore(latest, (params, state))
            return params, state, latest
        return params, state, 0

    def save(self, step: int, params, state) -> None:
        """Checkpoint ``(params, state)`` at ``step``; under a mesh rank 0
        writes and every rank returns once the write is done."""
        if self.mesh is None:
            self.manager.save(step, (params, state))
            return
        if self.mesh.get_rank() == 0:
            self.manager.save(step, (params, state))
        barrier(self.mesh)

    def place_batch(self, batch: dict) -> dict:
        """The batch's tensors on the trainer's device."""
        return {"adj": [a.to(self.device) for a in batch["adj"]],
                "x": batch["x"].to(self.device),
                "n_nodes": batch["n_nodes"].to(self.device),
                "labels": batch["labels"].to(self.device)}

    def train_step(self, params, state, batch: dict, *, on_phase=None):
        """One training step on a placed batch: (params, state, metrics),
        metrics holding 0-d tensors ``loss``, ``acc`` (before the update)
        and ``grad_norm``. ``on_phase``, a timing hook, is called with
        ``"forward"``, ``"backward"`` and ``"optimizer"`` as each part has
        been issued (its kernels may still be running)."""
        live = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, acc = gcn_loss(tree.unflatten(params, live), self.cfg,
                             batch["adj"], batch["x"], batch["n_nodes"],
                             batch["labels"], mesh=self.mesh)
        if on_phase is not None:
            on_phase("forward")
        grads = torch.autograd.grad(loss, live)
        gnorm = global_norm(grads)
        if on_phase is not None:
            on_phase("backward")
        params, state = adam_update(self.opt, params,
                                    tree.unflatten(params, grads), state)
        if on_phase is not None:
            on_phase("optimizer")
        return params, state, {"loss": loss.detach(), "acc": acc,
                               "grad_norm": gnorm}

    def _set_gauges(self, metrics: dict, labels: dict) -> None:
        """Loss, accuracy and gradient-norm gauges (a device sync when the
        values are tensors on the card)."""
        self._m_loss.set(float(metrics["loss"]), **labels)
        self._m_acc.set(float(metrics["acc"]), **labels)
        self._m_gnorm.set(float(metrics["grad_norm"]), **labels)

    def fit(self, batch_iter: Iterator[dict] | Callable, *, epochs: int = 1,
            on_metrics: Callable[[int, dict], None] | None = None,
            on_phase=None):
        """Train over ``batch_iter``: a callable returning one epoch's
        batches (``lambda e: batches(...)``), or an iterable, which is
        materialised once so that every epoch sees all of it.

        Resume: the newest checkpoint is restored and the first ``start``
        batches of the stream are skipped, so a save, kill and restart
        continues the same trajectory. Checkpoints every
        ``tcfg.checkpoint_every`` steps and once at the end. With telemetry
        on, each step runs in a ``train/step`` span and the gauges sync
        every ``tcfg.log_every`` steps and at each epoch's end. Where an
        ELL-class impl runs (pinned, or resolved by ``auto`` for the
        batch's shapes), every batch's row degrees are checked against
        ``cfg.k_pad`` before its step. ``on_metrics(epoch, record)`` gets
        the last step's loss, accuracy and gradient norm as floats after
        each epoch that trained. ``on_phase``, a timing hook, is called with ``"batch"``
        once a batch is on the device, then by :meth:`train_step`.

        Returns (params, state, the last record's loss, acc, grad_norm)."""
        params, state, start = self.restore_or_init()
        if not callable(batch_iter):
            data = (batch_iter if isinstance(batch_iter, (list, tuple))
                    else list(batch_iter))
            batch_iter = lambda epoch: data  # noqa: E731
        last = {"loss": math.nan, "acc": math.nan, "grad_norm": math.nan}
        metrics = None
        step = seen = 0
        labels = {"layer": self.cfg.layer, "impl": self.cfg.impl}
        log_every = max(self.tcfg.log_every, 1)
        win_t0, win_graphs = time.perf_counter(), 0
        for epoch in range(epochs):
            for b in batch_iter(epoch):
                seen += 1
                if seen <= start:
                    continue    # already trained before the restart
                if self._needs_ell_guard(b):
                    for a in b["adj"]:
                        validate_ell_k_pad(a, b["x"].shape[1], self.cfg.k_pad)
                placed = self.place_batch(b)
                if on_phase is not None:
                    on_phase("batch")
                if self.telemetry:
                    with TRACER.span("train/step", cat="train",
                                     args={"step": seen, **labels}):
                        t0 = time.perf_counter()
                        params, state, metrics = self.train_step(
                            params, state, placed, on_phase=on_phase)
                        self._m_step_s.observe(time.perf_counter() - t0,
                                               **labels)
                    self._m_steps.inc(**labels)
                    win_graphs += b["x"].shape[0]
                    if seen % log_every == 0:
                        # the only per-window device sync
                        self._set_gauges(metrics, labels)
                        now = time.perf_counter()
                        if now > win_t0:
                            self._m_tput.set(win_graphs / (now - win_t0),
                                             **labels)
                        win_t0, win_graphs = now, 0
                else:
                    params, state, metrics = self.train_step(
                        params, state, placed, on_phase=on_phase)
                step = seen
                if step % max(self.tcfg.checkpoint_every, 1) == 0:
                    self.save(step, params, state)
            if step > start:
                last = {k: float(v) for k, v in metrics.items()}
                if self.telemetry:
                    self._set_gauges(last, labels)
                if on_metrics is not None:
                    on_metrics(epoch + 1, {"epoch": epoch + 1, **last,
                                           "time": time.time()})
        if step > start:
            self.save(step, params, state)
        return params, state, last

    # -- the giant-graph tier (DESIGN.md §14) --------------------------

    def block_decisions(self, batch) -> tuple:
        """Per-layer ``repro_torch.autotune.Decision`` of one sampled
        minibatch, on the block-aware workload: ``block`` = the layer's
        padded dst-row count, ``max_deg`` = the sampled in-degree rounded up
        to a power of two (so the memo and tuning-cache keys stay few),
        ``k_pad=None`` (a sampled block has no ELL bound). Kernel impls are
        ranked where the trainer's device is CUDA. Memoized per (geometry,
        skew) key; host work alone."""
        from repro_torch import autotune

        blocks = batch.blocks
        m_pads = tuple(b.m_pad for b in blocks)
        n_seed = len(batch.labels)
        # per-layer dst-row bound: the next block's padded src count (dst
        # rows ARE its src prefix); the last layer's is the seed count
        dst_pads = tuple(
            min(m_pads[i], m_pads[i + 1]) if i + 1 < len(blocks)
            else min(m_pads[i], -(-n_seed // 8) * 8)
            for i in range(len(blocks)))
        max_degs = tuple(
            1 << max(b.max_deg, 1).bit_length() for b in blocks)
        key = (m_pads, tuple(b.nnz_pad for b in blocks), dst_pads, max_degs)
        if key not in self._block_impl_memo:
            allow_pallas = self.device.type == "cuda"
            decisions = []
            for i, b in enumerate(blocks):
                w = autotune.Workload(
                    batch=1, m_pad=b.m_pad, nnz_pad=b.nnz_pad, k_pad=None,
                    n_b=self.cfg.conv_widths[i],
                    itemsize=batch.x.dtype.itemsize,
                    max_deg=max_degs[i], block=dst_pads[i])
                if self.cfg.impl != "auto":
                    decisions.append(autotune.forced_decision(
                        w, self.cfg.impl))
                else:
                    decisions.append(autotune.select_impl(
                        w, allow_pallas=allow_pallas,
                        cache=autotune.default_cache()))
            self._block_impl_memo[key] = tuple(decisions)
        return self._block_impl_memo[key]

    def place_sampled(self, batch) -> dict:
        """A sampled minibatch's blocks, input rows and seed labels on the
        trainer's device (from pinned host memory without waiting, on CUDA).
        Call it on the trainer's thread."""
        cuda = self.device.type == "cuda"

        def put(t: torch.Tensor) -> torch.Tensor:
            if cuda:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=cuda)

        return {"adjs": [BatchedCOO(*(put(getattr(b.adj, f.name))
                                      for f in dataclasses.fields(b.adj)))
                         for b in batch.blocks],
                "x": put(torch.from_numpy(batch.x)),
                "labels": put(torch.from_numpy(batch.labels))}

    def sampled_step(self, params, state, placed: dict, *,
                     m_pads: tuple[int, ...], impls: tuple[str, ...],
                     on_phase=None):
        """One training step on a placed sampled minibatch, run eagerly as
        :meth:`train_step`: value and grad of ``gcn_node_loss``, the global
        norm, then ``adam_update`` in place. Returns (params, state,
        metrics) with 0-d device tensors; ``on_phase`` as in
        :meth:`train_step`."""
        live = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, acc = gcn_node_loss(tree.unflatten(params, live), self.cfg,
                                  placed["adjs"], placed["x"],
                                  placed["labels"], m_pads=m_pads,
                                  impls=impls)
        if on_phase is not None:
            on_phase("forward")
        grads = torch.autograd.grad(loss, live)
        gnorm = global_norm(grads)
        if on_phase is not None:
            on_phase("backward")
        params, state = adam_update(self.opt, params,
                                    tree.unflatten(params, grads), state)
        if on_phase is not None:
            on_phase("optimizer")
        return params, state, {"loss": loss.detach(), "acc": acc,
                               "grad_norm": gnorm}

    def fit_sampled(self, loader, *, epochs: int = 1, prefetch: bool = True,
                    on_metrics: Callable[[int, dict], None] | None = None,
                    on_phase=None):
        """Giant-graph training over ``loader``'s sampled minibatches
        (``repro_torch.sampling.SampledNodeLoader``), with ``fit``'s
        checkpoint and telemetry machinery.

        Per minibatch: the per-layer decisions (:meth:`block_decisions`),
        the batch on the device (:meth:`place_sampled`), then
        :meth:`sampled_step`. The count of distinct ``(m_pads, nnz_pads,
        impls)`` is the ``train_sampled_programs`` gauge: the eager port
        compiles nothing, but it is the reference's count of compiled
        programs, bounded by the loader's bucket ladders.

        Resume, as ``fit``: the newest checkpoint is restored and the first
        ``start`` batches are skipped; the loader's ``(seed, epoch,
        batch)``-addressed sampling makes the replayed stream bitwise the
        same, and a checkpoint either package wrote resumes in the other.
        ``prefetch`` builds the next minibatch in a worker thread (host
        work only) during the current step. ``on_phase``, a timing hook, is
        called with ``"fetched"`` once a batch to train on has arrived,
        ``"batch"`` once it is on the device, then by
        :meth:`sampled_step`. Returns (params, state, the last step's loss,
        acc and grad_norm as floats, and ``programs``)."""
        if self.mesh is not None:
            raise ValueError("fit_sampled is single-host for now: sampled "
                             "blocks have batch=1, so there is no batch "
                             "axis to shard over a mesh")
        from repro_torch.sampling import Prefetcher

        params, state, start = self.restore_or_init()
        metrics = None
        last = {"loss": math.nan, "acc": math.nan, "grad_norm": math.nan}
        labels_kw = {"layer": self.cfg.layer, "impl": self.cfg.impl}
        log_every = max(self.tcfg.log_every, 1)
        win_t0, win_nodes = time.perf_counter(), 0
        m_programs = self.registry.gauge(
            "train_sampled_programs",
            "distinct sampled-step programs (bucket-bounded)")
        programs: set[tuple] = set()
        step = seen = 0
        for epoch in range(epochs):
            batches = loader.epoch(epoch)
            if prefetch:
                batches = Prefetcher(batches, registry=self.registry)
            for b in batches:
                seen += 1
                if seen <= start:
                    continue    # already trained before the restart
                if on_phase is not None:
                    on_phase("fetched")
                decisions = self.block_decisions(b)
                impls = tuple(d.impl for d in decisions)
                m_pads = tuple(bl.m_pad for bl in b.blocks)
                programs.add((m_pads, tuple(bl.nnz_pad for bl in b.blocks),
                              impls))
                placed = self.place_sampled(b)
                if on_phase is not None:
                    on_phase("batch")
                if self.telemetry:
                    with TRACER.span("train/sampled_step", cat="train",
                                     args={"step": seen, **labels_kw}):
                        t0 = time.perf_counter()
                        params, state, metrics = self.sampled_step(
                            params, state, placed, m_pads=m_pads,
                            impls=impls, on_phase=on_phase)
                        self._m_step_s.observe(time.perf_counter() - t0,
                                               **labels_kw)
                    self._m_steps.inc(**labels_kw)
                    m_programs.set(len(programs), **labels_kw)
                    win_nodes += len(b.labels)
                    if seen % log_every == 0:
                        # the only per-window device sync
                        self._set_gauges(metrics, labels_kw)
                        now = time.perf_counter()
                        if now > win_t0:
                            self._m_tput.set(win_nodes / (now - win_t0),
                                             **labels_kw)
                        win_t0, win_nodes = now, 0
                else:
                    params, state, metrics = self.sampled_step(
                        params, state, placed, m_pads=m_pads, impls=impls,
                        on_phase=on_phase)
                step = seen
                if step % max(self.tcfg.checkpoint_every, 1) == 0:
                    self.manager.save(step, (params, state))
            if step > start:
                last = {k: float(v) for k, v in metrics.items()}
                if self.telemetry:
                    self._set_gauges(last, labels_kw)
                if on_metrics is not None:
                    on_metrics(epoch + 1, {"epoch": epoch + 1, **last,
                                           "programs": len(programs),
                                           "time": time.time()})
        if step > start:
            self.manager.save(step, (params, state))
        return params, state, {**last, "programs": len(programs)}
