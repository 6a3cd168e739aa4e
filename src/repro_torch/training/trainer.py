"""ChemGCN training (``GCNTrainer``), the reference's ``GCNTrainer`` over
batched SpMM (§IV-D, §V-B).

One step is the reference's jitted step run eagerly on the trainer's
device: value and grad of :func:`repro_torch.core.gcn.gcn_loss`, the global
gradient norm, then :func:`repro_torch.optim.adam.adam_update` (in place).
On the GPU the kernel impls run their kernels forward and backward; on the
CPU their plain versions. Loss, accuracy and gradient norm stay tensors on
the device between log points (the end of each epoch), so no step waits for
the device. Checkpoints are the reference's format: a checkpoint either
package wrote resumes in the other.

Not ported here: the reference trainer's ``mesh=`` (batch-axis sharding),
``registry=``/``telemetry=`` (observability) and ``fit_sampled`` (the
giant-graph tier); ``ROADMAP.md`` queue 1 holds them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterator

import torch

from repro_torch import resolve_device, tree
from repro_torch.autotune.cost_model import precision_of
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.core.formats import validate_ell_k_pad
from repro_torch.core.gcn import (
    GCNConfig,
    check_config,
    gcn_loss,
    init_gcn,
    resolve_conv_impls,
)
from repro_torch.kernels.ops import IMPLS, check_impl
from repro_torch.optim.adam import (
    AdamConfig,
    adam_init,
    adam_update,
    global_norm,
)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The reference's ``TrainerConfig`` fields that ``GCNTrainer`` reads.
    ``checkpoint_dir`` has no default: the port writes only where it is
    told to."""

    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    seed: int = 0


# the ELL class, whose conversion silently drops > k_pad nnz per row
_ELL_IMPLS = tuple(i for i in IMPLS
                   if precision_of(i)[0] in ("ell", "pallas_ell"))


class GCNTrainer:
    """Trains ChemGCN with ``cfg.impl`` (``"auto"`` resolved per conv
    layer and batch shape) on ``device`` (the current CUDA device unless
    the caller asks for another)."""

    def __init__(self, cfg: GCNConfig, opt: AdamConfig | None = None,
                 tcfg: TrainerConfig | None = None, *, device=None):
        if tcfg is None:
            raise ValueError("GCNTrainer needs a TrainerConfig with a "
                             "checkpoint_dir")
        check_config(cfg)
        check_impl(cfg.impl)
        self.cfg = cfg
        self.opt = opt or AdamConfig(lr=3e-3)
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.manager = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        # batch shape → whether any conv layer runs an ELL-class impl there
        self._ell_by_shape: dict[tuple, bool] = {}

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
                    device=self.device)))
        return self._ell_by_shape[key]

    def layer_decision(self, batch: dict):
        """The first conv layer's ``repro_torch.autotune.Decision`` for one
        training batch, as the step resolves it on the trainer's device:
        fused kernel against stacked SpMM for ``layer="gcn"``, the g-SpMM
        workload for ``"gat"`` and ``"rgcn"``. The batch may lie on the
        host: only its shapes are read."""
        adj, x = batch["adj"], batch["x"]
        nnz_pad = (max(a.nnz_pad for a in adj) if self.cfg.layer == "gcn"
                   else adj[0].row_ids.shape[1])
        return resolve_conv_impls(self.cfg, x.shape[0], x.shape[1], nnz_pad,
                                  itemsize=x.element_size(),
                                  device=self.device)[0]

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
                             batch["labels"])
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

    def fit(self, batch_iter: Iterator[dict] | Callable, *, epochs: int = 1,
            on_metrics: Callable[[int, dict], None] | None = None,
            on_phase=None):
        """Train over ``batch_iter``: a callable returning one epoch's
        batches (``lambda e: batches(...)``), or an iterable, which is
        materialised once so that every epoch sees all of it.

        Resume: the newest checkpoint is restored and the first ``start``
        batches of the stream are skipped, so a save, kill and restart
        continues the same trajectory. Checkpoints every
        ``tcfg.checkpoint_every`` steps and once at the end. Where an
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
                params, state, metrics = self.train_step(
                    params, state, placed, on_phase=on_phase)
                step = seen
                if step % max(self.tcfg.checkpoint_every, 1) == 0:
                    self.manager.save(step, (params, state))
            if step > start:
                last = {k: float(v) for k, v in metrics.items()}
                if on_metrics is not None:
                    on_metrics(epoch + 1, {"epoch": epoch + 1, **last,
                                           "time": time.time()})
        if step > start:
            self.manager.save(step, (params, state))
        return params, state, last
