#!/usr/bin/env python3
"""Time the fused graph-conv kernel's main-path rows in one checkout.

    python3 scripts/fused_compare.py [--root DIR]

Imports ``repro_torch`` and ``chip_smoke.py`` from the checkout at DIR (by
default the one this script lies in) and times, by CUDA-graph replay on
the card, the fused rows of ``chip_smoke.py`` at their main-path shapes
and inputs: ``fused_forward`` at Tox21 serving layer 1 and Reaction100
layer 2, ``fused_hybrid_forward`` at both and at the powerlaw batch, and
``fused_forward_bf16`` at both. Each row is checked against its plain
version first. Prints one JSON line ``{"root", "card", "ms": {row: ms}}``.

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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(root), "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
