#!/usr/bin/env python3
"""Time the main-path rows of the fused, batched GEMM and hybrid kernels in
one checkout.

    python3 scripts/fused_compare.py [--root DIR]

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
and the g-SpMM entry at the R-GCN and GAT Tox21 serving shapes. Each row
is checked against its plain version first. Prints one JSON line
``{"root", "card", "ms": {row: ms}}``.

To compare two trees on one card, unpack the other (``git archive``) into
a directory that ``.gitignore`` lists and run this script on both in one
call, in turns: other, this, this, other. The kernels build into each
tree's own ``build/kernels``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
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
    for tag, (adj, x, w, bias) in cases.items():
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
    ms.update(_gemm_hybrid_rows(cs, dev, gen, wave, conv, x2, conv2, rw,
                                pl_adj, pl_m))
    ms.update(_gmm_rows(cs, dev, gen, wave, rw))
    ms.update(_ell_rows(cs, dev, gen, wave, conv, x2, conv2, rw))
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
        cs.max_err(batched_gemm(dense, b), ref.batched_gemm_plain(dense, b),
                   f"batched_gemm[{tag}]")
        ms[f"batched_gemm[{tag}]"] = cs.graph_ms(
            lambda: batched_gemm(dense, b))
    for m, batch in ((2048, 8), (9000, 2)):
        dense = coo_to_dense(cs._large_coo(m, batch, 0), m).to(dev)
        b = torch.randn((batch, m, 64), generator=gen).to(dev)
        got = batched_gemm_large(dense, b)
        cs.max_err(got, torch.bmm(dense, b), f"batched_gemm_large[{m}]",
                   (1e-3, 1e-4))
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
        cs.max_err(_gmm(xt, w, rg), ref.grouped_matmul_ref(xt, rg, w), key)
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


if __name__ == "__main__":
    sys.exit(main())
