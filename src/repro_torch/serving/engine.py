"""Wave-scheduled batched ChemGCN inference (``GraphServeEngine``).

A queue of single-molecule scoring requests becomes ONE batched forward pass
per wave of ``batch`` slots: per conv layer either one fused layer kernel
(``impl="fused"``) or one stacked ``(channels·batch)`` batched SpMM — the
paper's launch-amortization argument applied to online inference. Empty and
failed slots carry zero-nnz adjacencies and contribute nothing.

A wave is assembled on the host in numpy, moved with one copy per operand,
and run under ``torch.inference_mode()``. With ``bn_mode="sample"`` a
request's logits do not depend on which requests share its wave: bitwise on
the CPU, to the kernels' f32 tolerance on the GPU (their shared-memory
atomics add in a run-dependent order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.formats import BatchedCOO, coo_from_lists
from repro_torch.core.gcn import GCNConfig, apply_gcn, check_config
from repro_torch.kernels.ops import check_impl


@dataclasses.dataclass
class GraphRequest:
    """One molecule to score: per-channel COO triples + node features.

    ``failed``/``error`` record a per-request rejection; a failed request
    never kills its wave."""

    rows: list[np.ndarray]          # one (e,) int array per channel
    cols: list[np.ndarray]
    features: np.ndarray            # (n_nodes, n_features)
    n_nodes: int
    logits: np.ndarray | None = None
    done: bool = False
    failed: bool = False
    error: str | None = None


@dataclasses.dataclass(frozen=True)
class GraphWaveReport:
    """What one executed wave carried vs. what its geometry paid for."""

    slots: int                      # wave batch slots (engine.batch)
    n_requests: int                 # real requests placed in the wave
    n_failed: int                   # of those, rejected by validation
    real_nodes: int                 # Σ n_nodes over served requests
    real_nnz: int                   # Σ over served requests and channels
    node_capacity: int              # slots * m_pad
    nnz_capacity: int               # slots * channels * nnz_pad


@dataclasses.dataclass
class Wave:
    """One assembled wave: device operands plus the host-side accounting."""

    adj: list[BatchedCOO]
    x: torch.Tensor
    n_nodes: torch.Tensor
    served: list[tuple[int, GraphRequest]]
    report: GraphWaveReport


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)


class GraphServeEngine:
    """Wave-scheduled batched GCN inference at a fixed wave geometry
    (``batch`` slots of ``m_pad`` node rows and ``nnz_pad`` non-zeros per
    channel). ``params`` is the reference-named pytree of tensors
    (:func:`repro_torch.core.gcn.init_gcn`, ``GCN.params`` or
    :func:`repro_torch.convert.params_from_jax`); it is moved to ``device``,
    the current CUDA device unless the caller asks for another."""

    def __init__(self, params, cfg: GCNConfig, *, batch: int = 32,
                 m_pad: int = 56, nnz_pad: int = 256, device=None):
        check_config(cfg)
        check_impl(cfg.impl)
        self.cfg = cfg
        self.batch, self.m_pad, self.nnz_pad = batch, m_pad, nnz_pad
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        # only an ELL-class impl silently drops > k_pad nnz per row
        self._ell_degree_guard = (cfg.k_pad is not None
                                  and cfg.impl in ("ell", "pallas_ell"))

    def layer_decision(self):
        raise NotImplementedError(
            "layer_decision() audits the autotune, which is not ported "
            "(ROADMAP.md); the port's impl is the pinned cfg.impl")

    def compiled_programs(self):
        raise NotImplementedError(
            "compiled_programs() counts jit programs; the port runs eagerly "
            "and has none")

    def _validate(self, s: int, r: GraphRequest) -> str | None:
        """Reason this request cannot ride this engine's wave geometry, or
        None when it fits. Never raises."""
        if r.n_nodes > self.m_pad:
            return (f"request {s}: n_nodes={r.n_nodes} exceeds wave "
                    f"m_pad={self.m_pad}; needs a bigger geometry tier")
        if len(r.rows) != self.cfg.channels or len(r.cols) != self.cfg.channels:
            return (f"request {s}: {len(r.rows)} row / {len(r.cols)} col "
                    f"channels, engine expects {self.cfg.channels}")
        for ch, (rows, cols) in enumerate(zip(r.rows, r.cols)):
            if len(rows) > self.nnz_pad:
                return (f"request {s}, channel {ch}: {len(rows)} edges "
                        f"exceed wave nnz_pad={self.nnz_pad}")
            if len(rows) != len(cols):
                return (f"request {s}, channel {ch}: {len(rows)} row ids vs "
                        f"{len(cols)} col ids")
            if len(rows):
                rr, cc = np.asarray(rows), np.asarray(cols)
                if (int(rr.min()) < 0 or int(cc.min()) < 0
                        or int(rr.max()) >= r.n_nodes
                        or int(cc.max()) >= r.n_nodes):
                    return (f"request {s}, channel {ch}: edge ids outside "
                            f"[0, n_nodes={r.n_nodes})")
        if self._ell_degree_guard:
            for ch, rows in enumerate(r.rows):
                if len(rows):
                    deg = int(np.bincount(np.asarray(rows, np.int64)).max())
                    if deg > self.cfg.k_pad:
                        return (f"request {s}, channel {ch}: max row degree "
                                f"{deg} exceeds cfg.k_pad={self.cfg.k_pad} "
                                "(an ELL impl would silently drop edges)")
        return None

    def assemble(self, wave: list[GraphRequest]) -> Wave:
        """Validate and pad a wave on the host, then move its operands to
        the engine's device (the first half of :meth:`run_wave`)."""
        n = len(wave)
        if n > self.batch:
            raise ValueError(f"wave of {n} requests > {self.batch} slots")
        channels = self.cfg.channels
        x = np.zeros((self.batch, self.m_pad, self.cfg.n_features),
                     np.float32)
        n_nodes = np.zeros((self.batch,), np.int32)
        triples_by_ch = [[] for _ in range(channels)]
        served: list[tuple[int, GraphRequest]] = []
        n_failed = real_nodes = real_nnz = 0
        for s in range(self.batch):
            r = wave[s] if s < n else None
            if r is not None:
                err = self._validate(s, r)
                if err is None:
                    served.append((s, r))
                    x[s, :r.n_nodes] = r.features
                    n_nodes[s] = r.n_nodes
                    real_nodes += r.n_nodes
                    for ch in range(channels):
                        rows = np.asarray(r.rows[ch], np.int32)
                        cols = np.asarray(r.cols[ch], np.int32)
                        real_nnz += len(rows)
                        triples_by_ch[ch].append(
                            (rows, cols, np.ones(len(rows), np.float32)))
                    continue
                r.failed, r.error, r.done = True, err, False
                n_failed += 1
            for ch in range(channels):  # empty or failed slot: zero nnz
                z = np.zeros(0, np.int32)
                triples_by_ch[ch].append((z, z, np.zeros(0, np.float32)))
        adj = [coo_from_lists(t, n_rows=list(n_nodes),
                              nnz_pad=self.nnz_pad).to(self.device)
               for t in triples_by_ch]
        report = GraphWaveReport(
            slots=self.batch, n_requests=n, n_failed=n_failed,
            real_nodes=real_nodes, real_nnz=real_nnz,
            node_capacity=self.batch * self.m_pad,
            nnz_capacity=self.batch * channels * self.nnz_pad)
        return Wave(adj, torch.from_numpy(x).to(self.device),
                    torch.from_numpy(n_nodes).to(self.device), served, report)

    def forward(self, w: Wave) -> torch.Tensor:
        """The wave's batched forward on the device: logits (batch, n_tasks)
        (the second half of :meth:`run_wave`)."""
        with torch.inference_mode():
            return apply_gcn(self.params, self.cfg, w.adj, w.x, w.n_nodes)

    def run_wave(self, wave: list[GraphRequest], *,
                 on_phase=None) -> GraphWaveReport:
        """Execute ONE wave (≤ ``batch`` requests) and return its fill and
        padding accounting. ``on_phase``, a timing hook, is called with
        ``"assembled"`` after :meth:`assemble` and with ``"forward"`` once
        :meth:`forward` has returned (its kernels may still be running)."""
        w = self.assemble(wave)
        if on_phase is not None:
            on_phase("assembled")
        logits = self.forward(w)
        if on_phase is not None:
            on_phase("forward")
        logits = logits.cpu().numpy()
        for s, r in w.served:
            r.logits = logits[s]
            r.done = True
        return w.report

    def run(self, requests: list[GraphRequest]) -> list[GraphRequest]:
        """Serve ``requests`` in fixed-size waves, in order."""
        for i in range(0, len(requests), self.batch):
            self.run_wave(requests[i:i + self.batch])
        return requests
