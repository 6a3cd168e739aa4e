"""Wave-scheduled batched serving engines: LM decode waves
(``ServeEngine``) and ChemGCN inference waves (``GraphServeEngine``).

``ServeEngine`` serves a queue of prompts in waves of ``batch`` slots:
prompts are left-padded with token 0 to the wave's longest and prefilled in
lockstep through the decode step (positions shared by the wave), then
every slot decodes one token per step, greedy (argmax) or sampled at a
temperature; a slot that has its ``max_new_tokens`` stops collecting, and
the wave ends when every slot is done or the ``max_len`` window is full (a
slot cut off there is ``truncated``, not ``done``). Sampling draws from a
seeded ``torch.Generator``: its draws are not ``jax.random``'s, so the two
packages agree token for token only at temperature 0.

For ``GraphServeEngine``, a queue of single-molecule scoring requests
becomes ONE batched forward pass
per wave of ``batch`` slots: per conv layer either one fused layer kernel
(``impl="fused"``) or one stacked ``(channels·batch)`` batched SpMM — the
paper's launch-amortization argument applied to online inference — or,
for ``GCNConfig.layer="gat"``/``"rgcn"``, the GNN layer's batched ops (one
g-SpMM, and for R-GCN one grouped matmul). Empty and
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
from repro_torch.autotune.cost_model import precision_of
from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import BatchedCOO, coo_from_lists
from repro_torch.core.gcn import (
    GCNConfig,
    apply_gcn,
    check_config,
    resolve_conv_impls,
)
from repro_torch.kernels.ops import check_impl
from repro_torch.models import lm
from repro_torch.observability import TRACER


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False          # served to completion (max_new_tokens reached)
    truncated: bool = False     # cut off by the engine's max_len window


def _serve_in_waves(engine, requests: list) -> list:
    """Shared wave scheduler: slice the queue into ``engine.batch``-slot
    waves, run each through ``engine._run_wave``."""
    queue = list(requests)
    while queue:
        wave, queue = queue[:engine.batch], queue[engine.batch:]
        engine._run_wave(wave)
    return requests


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

    @property
    def max_nnz(self) -> int:
        """Largest per-channel edge count: with ``n_nodes`` the request's
        geometry, which the scheduler buckets on."""
        return max((len(r) for r in self.rows), default=0)


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


class ServeEngine:
    """LM decode waves over ``params`` (the pytree of
    :func:`repro_torch.models.lm.init_params` or
    :func:`repro_torch.convert.lm_params_from_jax`), moved to ``device``,
    the current CUDA device unless the caller asks for another. Every step
    is one :func:`~repro_torch.models.lm.decode_step` for the whole wave,
    run under ``torch.inference_mode()``."""

    def __init__(self, params, cfg: ModelConfig, *, batch: int = 4,
                 max_len: int = 128, temperature: float = 0.0, seed: int = 0,
                 device=None):
        lm.check_ported(cfg)
        self.cfg = cfg
        self.batch, self.max_len = batch, max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _decode(self, tokens, caches, pos: int):
        return lm.decode_step(self.params, self.cfg, tokens, caches, pos)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(batch, vocab) logits → (batch,) tokens on the host: argmax, or
        the Gumbel-max draw of ``softmax(logits / temperature)``."""
        if self.temperature > 0:
            u = torch.rand(logits.shape, generator=self.generator,
                           device=logits.device)
            logits = logits.float() / self.temperature - torch.log(
                -torch.log(u))
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _run_wave(self, wave: list[Request]) -> None:
        n = len(wave)
        maxp = max(len(r.prompt) for r in wave)
        toks = np.zeros((self.batch, maxp), np.int64)
        for s, r in enumerate(wave):
            toks[s, maxp - len(r.prompt):] = r.prompt    # left padding
        with torch.inference_mode():
            caches = lm.init_decode_state(self.cfg, self.batch, self.max_len,
                                          device=self.device)
            prompt = torch.from_numpy(toks).to(self.device)
            # lockstep prefill through the decode step (positions shared)
            last = None
            for i in range(maxp):
                last, caches = self._decode(prompt[:, i:i + 1], caches, i)
            pos = maxp
            cur = self._sample(last[:, 0, :])
            active = np.array([True] * n + [False] * (self.batch - n))
            for s, r in enumerate(wave):
                if r.max_new_tokens <= 0:       # zero-budget: no tokens
                    r.done = True
                    active[s] = False
                    continue
                r.out.append(int(cur[s]))
                if r.max_new_tokens <= 1:
                    r.done = True
                    active[s] = False
            while active.any() and pos < self.max_len - 1:
                step = torch.from_numpy(cur.reshape(-1, 1)).to(self.device)
                logits, caches = self._decode(step, caches, pos)
                cur = self._sample(logits[:, 0, :])
                pos += 1
                for s, r in enumerate(wave):
                    if not active[s]:
                        continue
                    r.out.append(int(cur[s]))
                    if len(r.out) >= r.max_new_tokens:
                        r.done = True
                        active[s] = False
        # slots still active hit the max_len window, not their budget
        for s, r in enumerate(wave):
            if active[s]:
                r.truncated = True
                active[s] = False

    def run(self, requests: list[Request]) -> list[Request]:
        return _serve_in_waves(self, requests)


class GraphServeEngine:
    """Wave-scheduled batched GCN inference at a fixed wave geometry
    (``batch`` slots of ``m_pad`` node rows and ``nnz_pad`` non-zeros per
    channel). ``params`` is the reference-named pytree of tensors
    (:func:`repro_torch.core.gcn.init_gcn`, ``GCN.params`` or
    :func:`repro_torch.convert.params_from_jax`); it is moved to ``device``,
    the current CUDA device unless the caller asks for another.
    ``cfg.impl="auto"`` resolves each conv layer from the wave geometry's
    workload, the same decision every wave (:meth:`layer_decision`)."""

    def __init__(self, params, cfg: GCNConfig, *, batch: int = 32,
                 m_pad: int = 56, nnz_pad: int = 256,
                 precision: str | None = None, device=None):
        if precision is not None:
            # serving's storage-policy override, as in the reference: the
            # engine's waves take it without touching the shared config
            # (it steers impl="auto"; a pinned variant carries its own)
            cfg = dataclasses.replace(cfg, precision=precision)
        check_config(cfg)
        check_impl(cfg.impl)
        self.cfg = cfg
        self.batch, self.m_pad, self.nnz_pad = batch, m_pad, nnz_pad
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        # only an ELL-class impl silently drops > k_pad nnz per row, so the
        # guard asks what this geometry runs: EVERY conv layer, each
        # resolving "auto" against its own workload. As in the reference,
        # every channel is checked, also under layer="gat", whose layers
        # read channel 0 only
        impls = {cfg.impl}
        if cfg.impl == "auto" and cfg.k_pad is not None:
            impls = {d.impl for d in resolve_conv_impls(
                cfg, batch, m_pad, nnz_pad, device=self.device)}
        self._ell_degree_guard = (
            cfg.k_pad is not None
            and any(precision_of(i)[0] in ("ell", "pallas_ell")
                    for i in impls))

    def layer_decision(self):
        """The first conv layer's ``repro_torch.autotune.Decision`` at this
        engine's wave geometry on its device: fused kernel against stacked
        SpMM for ``layer="gcn"``, the g-SpMM workload for ``"gat"`` and
        ``"rgcn"``; every wave's forward resolves the same."""
        return resolve_conv_impls(self.cfg, self.batch, self.m_pad,
                                  self.nnz_pad, device=self.device)[0]

    def compiled_programs(self) -> None:
        """Entries in this engine's jit cache, where the reference counts
        them; the port runs eagerly and has no jit cache, so this is always
        None, the reference's answer when it cannot count
        (``ProgramCache.jit_cache_sizes`` leaves such tiers out)."""
        return None

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
        :meth:`forward` has returned (its kernels may still be running).

        The whole wave runs inside a ``serve/wave`` span tagged with the
        wave geometry (the reference's); kernel-dispatch spans (telemetry
        on) nest inside it."""
        with TRACER.span("serve/wave", cat="serve", args={
                "n_requests": len(wave), "slots": self.batch,
                "m_pad": self.m_pad, "nnz_pad": self.nnz_pad,
                "channels": self.cfg.channels, "layer": self.cfg.layer,
                "impl": self.cfg.impl}):
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
