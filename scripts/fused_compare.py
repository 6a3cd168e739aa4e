#!/usr/bin/env python3
"""Time the main-path rows of the fused, batched GEMM, hybrid, grouped
matmul, ELL and COO kernels in one checkout.

    python3 scripts/fused_compare.py [--root DIR] [--only GROUP]
                                     [--save FILE | --check FILE]

Imports ``repro_torch`` and ``chip_smoke.py`` from the checkout at DIR (by
default the one this script lies in) and times, by CUDA-graph replay on
the card, rows of ``chip_smoke.py`` at their main-path shapes and inputs:
``fused_forward`` at Tox21 serving layer 1 and Reaction100 layer 2,
``fused_hybrid_forward`` at both and at the powerlaw batch,
``fused_forward_bf16`` at both; ``batched_gemm`` at Tox21 serving and
Reaction100 layer 2 (n_b 512), ``batched_gemm_large`` at m_pad 2048 x 8
and 9000 x 2; ``batched_spmm_hybrid`` and ``batched_spmm_hybrid_bf16`` at
Tox21 serving and at the powerlaw batch's first channel; the grouped
matmul (``grouped_matmul[...]``) at R-GCN Tox21 serving and training layer
1, the training step's ``dx`` at layer 2 and Reaction100 layers 1 and 2;
the batched ELL entries (f32, bf16, i8) at Tox21 serving, f32 and bf16 at
Reaction100 layer 2 (n_b 512), the large-matrix entries at m_pad 9000 x 2
and the g-SpMM entry at the R-GCN and GAT Tox21 serving shapes; the
batched COO entries at Tox21 serving (f32, bf16 with int16 ids), as dU of
the fused backward at Tox21 and Reaction100 training (n_b 64, 512), at the
powerlaw batch's first channel, and in the g-SpMM entry at the R-GCN and
GAT Tox21 serving shapes, and its large-matrix entries (f32, bf16 on int32
ids, g-SpMM (copy_lhs, mean) and (mul, max); bf16 also on int16 ids at
9000) at m_pad 9000 x 2, 2048 x 8 and the giant-graph tier's two sampled
blocks (1 x 33,792 rows, 3,072 live x 10 slots; 1 x 3,072, 512 x 5), each
also for the same bits twice and with its back-to-back, plain and library
times, bytes bound and each kernel's device time (``[detail]`` lines;
the shapes are this script's tree's, whichever ``--root``), and case 3's
``ref`` path against ``pallas_coo`` at the 33,792-row block; the batched
CSR entries at Tox21 training (forward and dB, on the transposed CSR), at
Tox21 serving (f32, bf16, i8), in the g-SpMM entry at the R-GCN Tox21 and
Reaction100 (n_b 512) and GAT serving shapes and at the powerlaw batch's
first channel, and its large-matrix entries (f32, bf16, i8) at m_pad 9000
x 2; the fused layer's large-matrix branch (f32, hybrid, bf16 entries) at
chip_smoke.py's FUSED_LARGE shapes. Each row is checked against its plain
version first (the CSR, COO large and fused large rows also for the same
bits twice). Prints one JSON line
``{"root", "card", "ms": {row: ms}}``.

To compare two trees on one card, unpack the other (``git archive``) into
a directory that ``.gitignore`` lists and run this script on both in one
call, in turns: other, this, this, other. The kernels build into each
tree's own ``build/kernels``. ``--save FILE`` keeps the outputs of the
grouped matmul, batched GEMM and CSR rows; ``--check FILE`` (on the other
tree, same inputs) prints for each of them whether this tree's output has
the same bits. ``--only GROUP`` (fused, gemm — with the hybrid rows —,
gmm, ell, coo, csr, fused_large; repeatable) times only those rows.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# the outputs that --save keeps and --check compares, {row: tensor}
OUTS = {}
# the groups of rows, in the order they run
GROUPS = ("fused", "gemm", "gmm", "ell", "coo", "csr", "fused_large")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--save", help="keep the GEMM and _gmm outputs here")
    ap.add_argument("--check", help="compare those outputs with a --save")
    ap.add_argument("--only", action="append", choices=GROUPS,
                    help="time only these groups of rows (repeatable)")
    args = ap.parse_args()
    only = set(args.only or GROUPS)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    if not torch.cuda.is_available():
        print("fused_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import stack_channels
    from repro_torch.core.formats import narrow_col_ids
    from repro_torch.core.batching import plan_hybrid
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_forward_bf16, fused_hybrid_operands, runtime_chunks
    from repro_torch.serving.engine import GraphServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    cfg = GCNConfig.tox21(impl="fused", bn_mode="sample")
    params = cs._params(cfg, 0, dev)
    wave = GraphServeEngine(params, cfg, device=dev, **cs.TOX21).assemble(
        cs._requests(GraphDatasetSpec.tox21_like(cs.TOX21["batch"], seed=0)))
    conv = params["convs"][0]
    r_cfg = GCNConfig.reaction100(impl="fused", bn_mode="sample")
    r_params = cs._params(r_cfg, 0, dev)
    rw = GraphServeEngine(r_params, r_cfg, device=dev, **cs.TOX21).assemble(
        cs._requests(GraphDatasetSpec.reaction100_like(cs.TOX21["batch"],
                                                       seed=0)))
    m_pad = cs.TOX21["m_pad"]
    x2 = torch.randn((cs.TOX21["batch"], m_pad, 512), generator=gen).to(dev)
    x2 *= (torch.arange(m_pad, device=dev)[None, :, None]
           < rw.n_nodes[:, None, None])
    conv2 = r_params["convs"][1]
    pl_adj, pl_m = cs._powerlaw_channels(dev)
    pl_x = torch.nn.functional.one_hot(
        torch.randint(0, 62, (cs.POWERLAW["batch"], pl_m), generator=gen),
        62).float().to(dev)
    cases = {"tox21": (wave.adj, wave.x, conv["w"], conv["b"]),
             "reaction100": (rw.adj, x2, conv2["w"], conv2["b"]),
             "powerlaw": (pl_adj, pl_x, conv["w"], conv["b"])}
    ms = {}
    bf = torch.bfloat16
    for tag, (adj, x, w, bias) in (cases.items() if "fused" in only
                                   else ()):
        rid, cid, val, nnz = stack_channels(adj)
        chunks = runtime_chunks(nnz)
        m = x.shape[1]
        plain = ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w, bias)
        if tag != "powerlaw":
            cs.max_err(fused_forward(rid, cid, val, chunks, x, w, bias),
                       plain, f"fused_forward[{tag}]")
            ms[f"fused_forward[{tag}]"] = cs.graph_ms(
                lambda: fused_forward(rid, cid, val, chunks, x, w, bias))
            a16 = (narrow_col_ids(rid, m), narrow_col_ids(cid, m),
                   val.to(bf), chunks, x.to(bf), w.to(bf), bias.to(bf))
            cs.max_err(fused_forward_bf16(*a16),
                       ref.fused_graph_conv_plain(*a16),
                       f"fused_forward_bf16[{tag}]", cs.BF16_KERNEL_TOL)
            ms[f"fused_forward_bf16[{tag}]"] = cs.graph_ms(
                lambda: fused_forward_bf16(*a16))
        hp = plan_hybrid(batch=x.shape[0], m_pad=m, n_b=w.shape[-1],
                         nnz_pad=rid.shape[1] * rid.shape[2])
        ops_ = fused_hybrid_operands(rid, cid, val, m, hp)
        # a tree whose operands carry the hub counts passes them on
        kw = {"hubs": ops_[6]} if len(ops_) == 7 else {}

        def hybrid():
            return fused_forward(*ops_[:4], x, w, bias, None, *ops_[4:6],
                                 **kw)

        cs.max_err(hybrid(), plain, f"fused_hybrid_forward[{tag}]")
        ms[f"fused_hybrid_forward[{tag}]"] = cs.graph_ms(hybrid)
    if "gemm" in only:
        ms.update(_gemm_hybrid_rows(cs, dev, gen, wave, conv, x2, conv2, rw,
                                    pl_adj, pl_m))
    if "gmm" in only:
        ms.update(_gmm_rows(cs, dev, gen, wave, rw))
    if "ell" in only:
        ms.update(_ell_rows(cs, dev, gen, wave, conv, x2, conv2, rw))
    if "coo" in only:
        ms.update(_coo_rows(cs, dev, gen, wave, conv, pl_adj, pl_m))
    if "csr" in only:
        ms.update(_csr_rows(cs, dev, gen, wave, conv, rw, pl_adj, pl_m))
    if "fused_large" in only:
        ms.update(_fused_large_rows(cs, dev))
    if args.save:
        torch.save({k: v.cpu() for k, v in OUTS.items()}, args.save)
    if args.check:
        kept = torch.load(args.check)
        for k, v in OUTS.items():
            same = k in kept and torch.equal(kept[k], v.cpu())
            print(f"[bits] {k}: {'same' if same else 'differ'}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(root), "card": card, "ms": ms}), flush=True)
    return 0


def _gemm_hybrid_rows(cs, dev, gen, wave, conv, x2, conv2, rw, pl_adj,
                      pl_m):
    """The GEMM and hybrid rows, {row: ms}."""
    import torch
    from repro_torch.core.batching import plan_hybrid
    from repro_torch.core.formats import coo_to_dense, narrow_col_ids
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_gemm import batched_gemm, \
        batched_gemm_large
    from repro_torch.kernels.batched_spmm_hybrid import hybrid_launch, \
        hybrid_operands

    ms = {}
    m_pad = cs.TOX21["m_pad"]
    a = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    u2 = (torch.einsum("bmn,cnf->cbmf", x2, conv2["w"])
          + conv2["b"][:, None, None, :]).reshape(-1, m_pad, 512).contiguous()
    gemms = {"tox21": (coo_to_dense(a, m_pad).contiguous(), u),
             "reaction100 layer 2": (coo_to_dense(
                 flatten_channels(rw.adj), m_pad).contiguous(), u2)}
    for tag, (dense, b) in gemms.items():
        OUTS[f"batched_gemm[{tag}]"] = got = batched_gemm(dense, b)
        cs.max_err(got, ref.batched_gemm_plain(dense, b),
                   f"batched_gemm[{tag}]")
        ms[f"batched_gemm[{tag}]"] = cs.graph_ms(
            lambda: batched_gemm(dense, b))
    for m, batch in ((2048, 8), (9000, 2)):
        dense = coo_to_dense(cs._large_coo(m, batch, 0), m).to(dev)
        b = torch.randn((batch, m, 64), generator=gen).to(dev)
        got = batched_gemm_large(dense, b)
        cs.max_err(got, torch.bmm(dense, b), f"batched_gemm_large[{m}]",
                   (1e-3, 1e-4))
        OUTS[f"batched_gemm_large[m_pad {m}]"] = got
        ms[f"batched_gemm_large[m_pad {m}]"] = cs.graph_ms(
            lambda: batched_gemm_large(dense, b), iters=10, replays=3)
        del dense, b, got
    bf = torch.bfloat16
    pl = pl_adj[0]
    pl_b = torch.randn((pl.batch, pl_m, 64), generator=gen).to(dev)
    for tag, coo, b, m in (("tox21", a, u, m_pad),
                           ("powerlaw", pl, pl_b, pl_m)):
        for dt, suffix in ((torch.float32, ""), (bf, "_bf16")):
            hp = plan_hybrid(batch=coo.batch, m_pad=m, n_b=64,
                             nnz_pad=coo.nnz_pad,
                             itemsize=2 if dt == bf else 4)
            ops_ = hybrid_operands(coo.row_ids, coo.col_ids,
                                   coo.values.to(dt), coo.nnz, m, hp)
            if dt == bf:
                ops_ = ops_[:3] + (narrow_col_ids(ops_[3], m),) + ops_[4:]
            key = f"batched_spmm_hybrid{suffix}[{tag}]"
            bt = b.to(dt)
            # ops_ carries the hub counts in a tree whose kernel takes them
            cs.max_err(hybrid_launch(*ops_, bt, plan=hp),
                       ref.batched_spmm_hybrid_plain(*ops_, bt), key,
                       cs.BF16_KERNEL_TOL if dt == bf else cs.F32_TOL)
            ms[key] = cs.graph_ms(lambda: hybrid_launch(*ops_, bt, plan=hp))
    return ms


def _gmm_rows(cs, dev, gen, wave, rw):
    """The grouped matmul rows of R-GCN's layers, {row: ms}: relation-major
    tokens (each node block repeated per relation, as ``rgcn_layer``), the
    Tox21 and Reaction100 R-GCN weights of ``chip_smoke.py``."""
    import torch
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_matmul import _gmm, _row_groups

    params = cs._params(GCNConfig.tox21(layer="rgcn", impl="ref",
                                        bn_mode="sample"), 0, dev)
    r_params = cs._params(GCNConfig.reaction100(layer="rgcn", impl="ref"),
                          0, dev)
    tb = cs._on(cs._train_batches(GraphDatasetSpec.tox21_like(
        cs.TRAIN_TOX21["n_samples"], seed=0), cs.TRAIN_TOX21["batch"])[0],
        dev)

    def tokens(x, e):
        t = x.shape[0] * x.shape[1]
        return x.reshape(1, t, -1).expand(e, t, x.shape[-1]) \
            .reshape(e * t, -1).contiguous()

    w1, w2 = params["convs"][0]["w_rel"], params["convs"][1]["w_rel"]
    t_rows = tokens(tb["x"], 4).shape[0]
    x2 = torch.randn((cs.TOX21["batch"], cs.TOX21["m_pad"], 512),
                     generator=gen).to(dev)
    cases = {
        "rgcn tox21 serving layer 1": (tokens(wave.x, 4), w1),
        "rgcn tox21 training layer 1": (tokens(tb["x"], 4), w1),
        # the step's dx: dout (relation-major rows) @ W_r^T
        "rgcn tox21 training layer 2 dx": (
            torch.randn((t_rows, 64), generator=gen).to(dev),
            w2.transpose(1, 2).contiguous()),
        "rgcn reaction100 layer 1": (tokens(rw.x, 4),
                                     r_params["convs"][0]["w_rel"]),
        "rgcn reaction100 layer 2": (tokens(x2, 4),
                                     r_params["convs"][1]["w_rel"])}
    ms = {}
    for tag, (xt, w) in cases.items():
        e = w.shape[0]
        rg = _row_groups(torch.full((e,), xt.shape[0] // e,
                                    dtype=torch.int32, device=dev),
                         xt.shape[0], e)
        key = f"grouped_matmul[{tag}]"
        OUTS[key] = got = _gmm(xt, w, rg)
        cs.max_err(got, ref.grouped_matmul_ref(xt, rg, w), key)
        ms[key] = cs.graph_ms(lambda: _gmm(xt, w, rg))
    return ms


def _ell_rows(cs, dev, gen, wave, conv, x2, conv2, rw):
    """The batched ELL rows, {row: ms}: the stacked SpMM of Tox21 serving
    layer 1 (f32, bf16 with int16 ids, i8 codes) and of Reaction100 layer
    2 (f32, bf16), the large-matrix entries at m_pad 9000 x 2 and the
    g-SpMM entry at the R-GCN (copy_lhs, mean) and GAT (mul, sum, vector
    edges) Tox21 serving shapes of ``chip_smoke.py``."""
    import torch
    from repro_torch.core.formats import coo_to_ell, max_row_degree, \
        narrow_col_ids, quantize_values_i8, row_degrees
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell, \
        batched_spmm_ell_bf16, batched_spmm_ell_i8, batched_spmm_ell_large, \
        batched_spmm_ell_large_bf16, batched_spmm_ell_large_i8
    from repro_torch.kernels.segment_softmax import segment_softmax

    bf = torch.bfloat16
    m_pad = cs.TOX21["m_pad"]
    ms = {}

    def row(key, kern, plain, tol=cs.F32_TOL):
        cs.max_err(kern(), plain(), key, tol)
        ms[key] = cs.graph_ms(kern)

    def entries(tag, coo, b, k_pad, m, large=False, i8=True):
        """f32, bf16 (and i8) entries on one stacked SpMM."""
        e = coo_to_ell(coo, m, k_pad)
        codes, scale = quantize_values_i8(coo.values)
        eq = coo_to_ell(coo.with_values(codes), m, k_pad)
        e16, eq16 = (narrow_col_ids(t, m) for t in (e.col_ids, eq.col_ids))
        eh, bh = e.values.to(bf), b.to(bf)
        f32, f16, fi8 = ((batched_spmm_ell_large, batched_spmm_ell_large_bf16,
                          batched_spmm_ell_large_i8) if large else
                         (batched_spmm_ell, batched_spmm_ell_bf16,
                          batched_spmm_ell_i8))
        name = "batched_spmm_ell_large" if large else "batched_spmm_ell"
        row(f"{name}[{tag}]", lambda: f32(e.col_ids, e.values, b),
            lambda: ref.batched_spmm_ell_plain(e.col_ids, e.values, b))
        row(f"{name}_bf16[{tag}]", lambda: f16(e16, eh, bh),
            lambda: ref.batched_spmm_ell_plain(e16, eh, bh),
            cs.BF16_KERNEL_TOL)
        if i8:
            row(f"{name}_i8[{tag}]",
                lambda: fi8(eq16, eq.values, scale, b),
                lambda: ref.batched_spmm_ell_plain(eq16, eq.values, b,
                                                   scale))

    a = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    entries("tox21", a, u, 8, m_pad)
    u2 = (torch.einsum("bmn,cnf->cbmf", x2, conv2["w"])
          + conv2["b"][:, None, None, :]).reshape(-1, m_pad, 512).contiguous()
    entries("reaction100 layer 2", flatten_channels(rw.adj), u2, 8, m_pad,
            i8=False)
    del u2
    big = cs._large_coo(9000, 2, seed=9000).to(dev)
    entries("m_pad 9000", big, torch.randn((2, 9000, 64), generator=gen).to(
        dev), int(max_row_degree(big, 9000).max().item()), 9000, large=True)
    # g-SpMM: R-GCN's (copy_lhs, mean) over the wave's relations, GAT's
    # (mul, sum) over channel 0 under 4 heads with vector edges
    h = torch.randn((a.batch, m_pad, 64), generator=gen).to(dev)
    rlen = row_degrees(a, m_pad)
    e = coo_to_ell(a, m_pad, 8)
    kw = dict(op="copy_lhs", reduce="mean")
    row("batched_spmm_ell[g-SpMM, rgcn tox21 serving]",
        lambda: batched_spmm_ell(e.col_ids, e.values, h, rlen=rlen, **kw),
        lambda: ref.batched_gspmm_ell_plain(e.col_ids, e.values, rlen, h,
                                            **kw))
    heads, d_head = 4, 16
    a0 = wave.adj[0]
    alpha = segment_softmax(torch.randn((a0.batch, a0.nnz_pad, heads),
                                        generator=gen).to(dev), a0.row_ids,
                            nnz=a0.nnz, m_pad=m_pad)

    def flat(t):
        return t.expand((heads,) + t.shape).reshape((heads * a0.batch,)
                                                    + t.shape[1:])

    e_vec = alpha.permute(2, 0, 1).reshape(heads * a0.batch, a0.nnz_pad, 1) \
        .expand(-1, -1, d_head).contiguous()
    a_gat = a0.__class__(flat(a0.row_ids), flat(a0.col_ids), e_vec,
                         flat(a0.nnz), flat(a0.n_rows))
    hg = torch.randn((heads * a0.batch, m_pad, d_head), generator=gen).to(dev)
    eg = coo_to_ell(a_gat, m_pad, 8)
    rg = row_degrees(a_gat, m_pad)
    kw = dict(op="mul", reduce="sum")
    row("batched_spmm_ell[g-SpMM, gat tox21 serving]",
        lambda: batched_spmm_ell(eg.col_ids, eg.values, hg, rlen=rg, **kw),
        lambda: ref.batched_gspmm_ell_plain(eg.col_ids, eg.values, rg, hg,
                                            **kw))
    return ms


def _coo_rows(cs, dev, gen, wave, conv, pl_adj, pl_m):
    """The COO rows of ``chip_smoke.py``, {row: ms}: the stacked SpMM of
    Tox21 serving layer 1 (f32; bf16 with int16 ids), dU = Aᵀ·dZ of the
    fused backward (ids swapped) at the first Tox21 (n_b 64) and
    Reaction100 (n_b 512) training batches, the powerlaw batch's first
    channel (hub rows), the g-SpMM entry at the R-GCN (copy_lhs, mean) and
    GAT (mul, sum, vector edges) Tox21 serving shapes, and the
    large-matrix entries (f32, bf16) at m_pad 9000 x 2."""
    import torch
    from repro_torch.core.formats import BatchedCOO, narrow_col_ids
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo, \
        batched_spmm_coo_bf16
    from repro_torch.kernels.segment_softmax import segment_softmax

    bf = torch.bfloat16
    m_pad = cs.TOX21["m_pad"]
    ms = {}

    def row(key, kern, plain, tol=cs.F32_TOL, **timed):
        cs.max_err(kern(), plain(), key, tol)
        ms[key] = cs.graph_ms(kern, **timed)

    def coo(key, a, b, **kw):
        row(key, lambda: batched_spmm_coo(a.row_ids, a.col_ids, a.values, b,
                                          **kw),
            (lambda: ref.batched_gspmm_coo_plain(
                a.row_ids, a.col_ids, a.values, a.nnz, b, op=kw["op"],
                reduce=kw["reduce"])) if kw else
            (lambda: ref.batched_spmm_coo_plain(a.row_ids, a.col_ids,
                                                a.values, b)))

    a = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    coo("batched_spmm_coo[tox21]", a, u)
    r16, k16 = (narrow_col_ids(t, m_pad) for t in (a.row_ids, a.col_ids))
    vh, uh = a.values.to(bf), u.to(bf)
    row("batched_spmm_coo_bf16[tox21]",
        lambda: batched_spmm_coo_bf16(r16, k16, vh, uh),
        lambda: ref.batched_spmm_coo_plain(r16, k16, vh, uh),
        cs.BF16_KERNEL_TOL)
    for tag, spec, train in (
            ("tox21", GraphDatasetSpec.tox21_like(
                cs.TRAIN_TOX21["n_samples"], seed=0), cs.TRAIN_TOX21),
            ("reaction100", GraphDatasetSpec.reaction100_like(
                cs.TRAIN_R100["batch"] * cs.TRAIN_R100["steps"], seed=0),
             cs.TRAIN_R100)):
        tb = cs._on(cs._train_batches(spec, train["batch"])[0], dev)
        t = flatten_channels(tb["adj"])
        at = BatchedCOO(t.col_ids, t.row_ids, t.values, t.nnz, t.n_rows)
        dz = torch.randn((t.batch, tb["x"].shape[1],
                          64 if tag == "tox21" else 512),
                         generator=gen).to(dev)
        coo(f"batched_spmm_coo[dU, {tag} training]", at, dz)
    pl = pl_adj[0]
    coo("batched_spmm_coo[powerlaw]", pl,
        torch.randn((pl.batch, pl_m, 64), generator=gen).to(dev))
    h = torch.randn((a.batch, m_pad, 64), generator=gen).to(dev)
    coo("batched_spmm_coo[g-SpMM, rgcn tox21 serving]", a, h,
        nnz=a.nnz, op="copy_lhs", reduce="mean")
    heads, d_head = 4, 16
    a0 = wave.adj[0]
    alpha = segment_softmax(torch.randn((a0.batch, a0.nnz_pad, heads),
                                        generator=gen).to(dev), a0.row_ids,
                            nnz=a0.nnz, m_pad=m_pad)

    def flat(t):
        return t.expand((heads,) + t.shape).reshape((heads * a0.batch,)
                                                    + t.shape[1:])

    e_vec = alpha.permute(2, 0, 1).reshape(heads * a0.batch, a0.nnz_pad, 1) \
        .expand(-1, -1, d_head).contiguous()
    a_gat = BatchedCOO(flat(a0.row_ids), flat(a0.col_ids), e_vec,
                       flat(a0.nnz), flat(a0.n_rows))
    coo("batched_spmm_coo[g-SpMM, gat tox21 serving]", a_gat,
        torch.randn((heads * a0.batch, m_pad, d_head), generator=gen).to(dev),
        nnz=a_gat.nnz, op="mul", reduce="sum")
    _coo_large_rows(cs, dev, gen, ms)
    return ms


def _here():
    """This script's own tree's ``chip_smoke`` (the COO large rows'
    shapes, data and bytes count), whichever tree ``--root`` times."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_us(fn, calls: int = 20) -> dict:
    """Device µs a call of each CUDA kernel that ``fn`` launches, by
    ``torch.profiler`` over ``calls`` calls after three warm ones."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        if e.device_time_total <= 0 or e.key.startswith(("aten::", "cuda")):
            continue
        name = re.search(r"(\w+)\s*[<(]",
                         e.key.replace("(anonymous namespace)", ""))
        name = name.group(1) if name else e.key
        us[name] = us.get(name, 0.0) + e.device_time_total / calls
    return us


def _coo_large_rows(cs, dev, gen, ms):
    """The COO large-matrix entries at chip_smoke's LARGE_SHAPES and
    TIER_BLOCKS (its ``_large_coo`` and ``_tier_block`` matrices, taken
    from this script's tree), n_b 64: f32, bf16 on int32 ids (and on int16
    ids at m_pad 9000, the earlier row), g-SpMM (copy_lhs, mean) and (mul,
    max), each through ``chip_smoke._measure`` (against its plain version;
    graph-replay, back-to-back, plain and library times, the bytes bound
    over the B rows the slots read), each twice for its bits (printed as
    ``[bits twice]``) and each kernel's device time a call
    (``kernels_us``: the sort and the walk, or the fill, atomics and
    finish of the earlier design); at the 33,792-row block also
    ``ops.batched_spmm`` with ``impl="ref"`` (case 3's plain path on the
    card) against ``pallas_coo`` (the f32 entry), back to back. Adds
    ``[detail]`` lines and ``ms`` entries."""
    import torch
    from repro_torch.core.formats import coo_to_dense, narrow_col_ids
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.batched_spmm_coo import \
        batched_spmm_coo_large, batched_spmm_coo_large_bf16

    bf = torch.bfloat16
    here = _here()
    shapes = [(tag, lambda m=m, n=n: here._large_coo(m, n, seed=m))
              for tag, m, n in here.LARGE_SHAPES]
    shapes += [(tag, lambda m=m, live=live, f=f: here._tier_block(
        m, live, f, seed=m)) for tag, m, live, f in here.TIER_BLOCKS]
    for tag, make in shapes:
        a = make().to(dev)
        batch, m = a.batch, int(a.n_rows.max())
        b = torch.randn((batch, m, 64), generator=gen).to(dev)
        bh, vh = b.to(bf), a.values.to(bf)
        nnz = int(a.nnz.sum().item())
        dense = coo_to_dense(a, m).contiguous()
        dense_h = dense.to(bf)
        # the B rows the slots read, once, and C written once (f32)
        io = (here._b_rows_read(a, m) + batch * m) * 64 * 4
        rid, cid = a.row_ids, a.col_ids
        # (key, kernel, plain, bytes, operations, library, bf16)
        cases = [
            (f"batched_spmm_coo_large[{tag}]",
             lambda: batched_spmm_coo_large(rid, cid, a.values, b),
             lambda: ref.batched_spmm_coo_plain(rid, cid, a.values, b),
             io + nnz * 12, 2 * nnz * 64, lambda: torch.bmm(dense, b),
             False),
            (f"batched_spmm_coo_large_bf16[{tag}, int32 ids]",
             lambda: batched_spmm_coo_large_bf16(rid, cid, vh, bh),
             lambda: ref.batched_spmm_coo_plain(rid, cid, vh, bh),
             io // 2 + nnz * 10, 2 * nnz * 64,
             lambda: torch.bmm(dense_h, bh), True)]
        if tag == "m_pad 9000":
            r16, c16 = narrow_col_ids(rid, m), narrow_col_ids(cid, m)
            cases.append((
                f"batched_spmm_coo_large_bf16[{tag}]",
                lambda: batched_spmm_coo_large_bf16(r16, c16, vh, bh),
                lambda: ref.batched_spmm_coo_plain(r16, c16, vh, bh),
                io // 2 + nnz * 6, 2 * nnz * 64,
                lambda: torch.bmm(dense_h, bh), True))
        for op, red in (("copy_lhs", "mean"), ("mul", "max")):
            kw = dict(nnz=a.nnz, op=op, reduce=red)
            cases.append((
                f"batched_spmm_coo_large[g-SpMM ({op}, {red}), {tag}]",
                lambda kw=kw: batched_spmm_coo_large(rid, cid, a.values, b,
                                                     **kw),
                lambda op=op, red=red: ref.batched_gspmm_coo_plain(
                    rid, cid, a.values, a.nnz, b, op=op, reduce=red),
                io + nnz * (8 if op == "copy_lhs" else 12) + batch * 4,
                nnz * 64 * (1 if op == "copy_lhs" else 2),
                cs._library_gspmm(a, b, a.values, op, red), False))
        rows = {}
        for key, kern, plain, nbytes, flops, library, bf16 in cases:
            bits = torch.equal(kern(), kern())
            print(f"[bits twice] {key}: {'same' if bits else 'differ'}",
                  flush=True)
            cs._measure(rows, key, key.split("[")[0], kern, plain, nbytes,
                        flops, f"{batch} x {m} rows, {nnz} real nnz, n_b 64",
                        library,
                        tol=cs.BF16_KERNEL_TOL if bf16 else cs.F32_TOL,
                        flop_rate=cs.BF16_FLOP_PER_S if bf16
                        else cs.F32_FLOP_PER_S,
                        library_tol=cs.POLICY_TOLS["bf16"] if bf16
                        else cs.F32_TOL, iters=10, replays=3)
            ms[key] = rows[key]["ms"]
            print("[detail] " + json.dumps({**{k: rows[key][k] for k in (
                "name", "ms", "stream_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "shape")},
                "kernels_us": _kernel_us(kern)}), flush=True)
        if tag == "tier block 33792":
            for impl in ("ref", "pallas_coo"):
                key = f"ops.batched_spmm[{impl}, {tag}, back-to-back]"
                ms[key] = cs.cuda_ms(lambda impl=impl: ops.batched_spmm(
                    a, b, impl=impl), iters=10)
                print(f"[case 3] {key}: {ms[key]:.4f} ms", flush=True)
        del dense, dense_h, a, b, bh
        torch.cuda.empty_cache()


def _csr_rows(cs, dev, gen, wave, conv, rw, pl_adj, pl_m):
    """The CSR rows, {row: ms}, each output kept in OUTS: the stacked SpMM
    of the first Tox21 training batch's layer 1 (forward, and dB on the
    transposed CSR), of Tox21 serving layer 1 (f32; bf16 and i8 with int16
    ids), the g-SpMM entry at the R-GCN (copy_lhs, mean) Tox21 and
    Reaction100 (n_b 512) and GAT (mul, sum, vector edges) serving shapes,
    the powerlaw batch's first channel, and the large-matrix entries (f32,
    bf16, i8) at m_pad 9000 x 2."""
    import torch
    from repro_torch.core.formats import BatchedCOO, coo_to_csr, \
        narrow_col_ids, quantize_values_i8
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr, \
        batched_spmm_csr_bf16, batched_spmm_csr_i8, batched_spmm_csr_large, \
        batched_spmm_csr_large_bf16, batched_spmm_csr_large_i8
    from repro_torch.kernels.segment_softmax import segment_softmax

    bf = torch.bfloat16
    m_pad = cs.TOX21["m_pad"]
    ms = {}

    def row(key, kern, plain, tol=cs.F32_TOL, **timed):
        OUTS[key] = got = kern()
        cs.max_err(got, plain(), key, tol)
        cs.check(torch.equal(got, kern()), f"{key}: two calls differ")
        ms[key] = cs.graph_ms(kern, **timed)

    def csr(key, a, m, b, **kw):
        c = coo_to_csr(a, m)
        row(key, lambda: batched_spmm_csr(c.rpt, c.col_ids, c.values, b,
                                          **kw),
            (lambda: ref.batched_gspmm_csr_plain(c.rpt, c.col_ids, c.values,
                                                 b, **kw)) if kw else
            (lambda: ref.batched_spmm_csr_plain(c.rpt, c.col_ids, c.values,
                                                b)))

    tb = cs._on(cs._train_batches(GraphDatasetSpec.tox21_like(
        cs.TRAIN_TOX21["n_samples"], seed=0), cs.TRAIN_TOX21["batch"])[0],
        dev)
    t = flatten_channels(tb["adj"])
    t_m = tb["x"].shape[1]
    t_u = (torch.einsum("bmn,cnf->cbmf", tb["x"], conv["w"])
           + conv["b"][:, None, None, :]).reshape(-1, t_m, 64).contiguous()
    csr("batched_spmm_csr[tox21 training]", t, t_m, t_u)
    csr("batched_spmm_csr[dB, tox21 training]",
        BatchedCOO(t.col_ids, t.row_ids, t.values, t.nnz, t.n_rows), t_m,
        torch.randn(tuple(t_u.shape), generator=gen).to(dev))
    a = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    csr("batched_spmm_csr[tox21]", a, m_pad, u)
    c = coo_to_csr(a, m_pad)
    codes, scale = quantize_values_i8(a.values)
    cq = coo_to_csr(a.with_values(codes), m_pad)
    c16 = narrow_col_ids(c.col_ids, m_pad)
    ch, uh = c.values.to(bf), u.to(bf)
    row("batched_spmm_csr_bf16[tox21]",
        lambda: batched_spmm_csr_bf16(c.rpt, c16, ch, uh),
        lambda: ref.batched_spmm_csr_plain(c.rpt, c16, ch, uh),
        cs.BF16_KERNEL_TOL)
    row("batched_spmm_csr_i8[tox21]",
        lambda: batched_spmm_csr_i8(cq.rpt, c16, cq.values, scale, u),
        lambda: ref.batched_spmm_csr_plain(cq.rpt, c16, cq.values, u, scale))
    kw = dict(op="copy_lhs", reduce="mean")
    csr("batched_spmm_csr[g-SpMM, rgcn tox21 serving]", a, m_pad,
        torch.randn((a.batch, m_pad, 64), generator=gen).to(dev), **kw)
    r = flatten_channels(rw.adj)
    csr("batched_spmm_csr[g-SpMM, rgcn reaction100 serving]", r, m_pad,
        torch.randn((r.batch, m_pad, 512), generator=gen).to(dev), **kw)
    heads, d_head = 4, 16
    a0 = wave.adj[0]
    # the attention weights on the CPU: on the card the softmax's
    # denominators add by atomics, so their bits, and the row's, would
    # change from run to run
    alpha = segment_softmax(torch.randn((a0.batch, a0.nnz_pad, heads),
                                        generator=gen), a0.row_ids.cpu(),
                            nnz=a0.nnz.cpu(), m_pad=m_pad).to(dev)

    def flat(x):
        return x.expand((heads,) + x.shape).reshape((heads * a0.batch,)
                                                    + x.shape[1:])

    e_vec = alpha.permute(2, 0, 1).reshape(heads * a0.batch, a0.nnz_pad, 1) \
        .expand(-1, -1, d_head).contiguous()
    a_gat = BatchedCOO(flat(a0.row_ids), flat(a0.col_ids), e_vec,
                       flat(a0.nnz), flat(a0.n_rows))
    csr("batched_spmm_csr[g-SpMM, gat tox21 serving]", a_gat, m_pad,
        torch.randn((heads * a0.batch, m_pad, d_head), generator=gen).to(dev),
        op="mul", reduce="sum")
    pl = pl_adj[0]
    csr("batched_spmm_csr[powerlaw]", pl, pl_m,
        torch.randn((pl.batch, pl_m, 64), generator=gen).to(dev))
    big = cs._large_coo(9000, 2, seed=9000).to(dev)
    bb = torch.randn((2, 9000, 64), generator=gen).to(dev)
    c = coo_to_csr(big, 9000)
    bq_codes, bq_scale = quantize_values_i8(big.values)
    cq = coo_to_csr(big.with_values(bq_codes), 9000)
    c16, cq16 = (narrow_col_ids(x, 9000) for x in (c.col_ids, cq.col_ids))
    ch, bbh = c.values.to(bf), bb.to(bf)
    timed = dict(iters=10, replays=3)
    row("batched_spmm_csr_large[m_pad 9000]",
        lambda: batched_spmm_csr_large(c.rpt, c.col_ids, c.values, bb),
        lambda: ref.batched_spmm_csr_plain(c.rpt, c.col_ids, c.values, bb),
        **timed)
    row("batched_spmm_csr_large_bf16[m_pad 9000]",
        lambda: batched_spmm_csr_large_bf16(c.rpt, c16, ch, bbh),
        lambda: ref.batched_spmm_csr_plain(c.rpt, c16, ch, bbh),
        cs.BF16_KERNEL_TOL, **timed)
    row("batched_spmm_csr_large_i8[m_pad 9000]",
        lambda: batched_spmm_csr_large_i8(cq.rpt, cq16, cq.values, bq_scale,
                                          bb),
        lambda: ref.batched_spmm_csr_plain(cq.rpt, cq16, cq.values, bb,
                                           bq_scale), **timed)
    return ms


def _fused_large_rows(cs, dev):
    """The fused layer's large-matrix branch, {row: ms}: the f32, hybrid
    (its head bounded by the hub counts) and bf16 entries at each of
    chip_smoke.py's FUSED_LARGE shapes, four channels of its ``_large_coo``
    matrices (the inputs of its phase_fused_large)."""
    import torch
    from repro_torch.core.batching import plan_hybrid
    from repro_torch.core.formats import narrow_col_ids
    from repro_torch.core.graph_conv import stack_channels
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_forward_bf16, fused_hybrid_operands, runtime_chunks

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    ms = {}
    for tag, m_pad, batch, n_in, n_out in cs.FUSED_LARGE:
        adj = [cs._large_coo(m_pad, batch, 20 + c).to(dev) for c in range(4)]
        rid, cid, val, nnz = stack_channels(adj)
        chunks = runtime_chunks(nnz)
        x = torch.randn((batch, m_pad, n_in), generator=gen).to(dev)
        w = (torch.randn((4, n_in, n_out), generator=gen)
             / n_in ** 0.5).to(dev)
        bias = torch.randn((4, n_out), generator=gen).to(dev)
        hp = plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_out,
                         nnz_pad=4 * rid.shape[2])
        h = fused_hybrid_operands(rid, cid, val, m_pad, hp)
        a16 = (narrow_col_ids(rid, m_pad), narrow_col_ids(cid, m_pad),
               val.to(bf), chunks, x.to(bf), w.to(bf), bias.to(bf))
        cases = (
            ("fused_forward",
             lambda: fused_forward(rid, cid, val, chunks, x, w, bias),
             lambda: ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w,
                                                bias), cs.F32_TOL),
            ("fused_hybrid_forward",
             lambda: fused_forward(*h[:4], x, w, bias, None, *h[4:6],
                                   hubs=h[6]),
             lambda: ref.fused_graph_conv_plain(*h[:4], x, w, bias, None,
                                                "none", *h[4:]), cs.F32_TOL),
            ("fused_forward_bf16", lambda: fused_forward_bf16(*a16),
             lambda: ref.fused_graph_conv_plain(*a16), cs.BF16_KERNEL_TOL))
        for name, kern, plain, tol in cases:
            key = f"{name}[large, {tag}]"
            got = kern()
            cs.max_err(got, plain(), key, tol)
            bits = torch.equal(got, kern())
            print(f"[bits twice] {key}: {'same' if bits else 'differ'}",
                  flush=True)
            ms[key] = cs.graph_ms(kern, iters=10, replays=3)
        del adj, rid, cid, val, x, h, a16
        torch.cuda.empty_cache()
    return ms


if __name__ == "__main__":
    sys.exit(main())
