"""Port parity of the fused graph-conv layer at every size the reference
computes: the planner's case 3 against the reference's, and the port's
``fused_graph_conv`` (``fused``, ``fused_hybrid``, ``fused_bf16``) against
the reference's at m_pad 256 x n_in 512 and m_pad 1024 x n_in 62 — shapes
whose X tile does not fit one block's shared memory — on numpy inputs from
a seed, the reference's Pallas kernel in interpret mode, at
``tests/oracle.py`` TOLS of each impl's policy. On the CPU the port runs
the kernel's plain version; the hybrid head's bound by the hub count
(``hubs``) and the large-matrix plan are checked here as well.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import batching as jb
from repro.core import formats as jf
from repro.core.graph_conv import stack_channels as j_stack
from repro.kernels.fused_graph_conv import fused_graph_conv as j_fused
from repro_torch.core import batching as tb
from repro_torch.core import formats as tf
from repro_torch.core.graph_conv import stack_channels
from repro_torch.kernels import ref
from repro_torch.kernels.fused_graph_conv import (
    fused_forward,
    fused_graph_conv,
    fused_hybrid_operands,
    runtime_chunks,
)
from test_torch_formats import to_np, torch_coo

CHANNELS = 2
N_OUT = 48
# (m_pad, n_in, batch): the X tile of each is past a block's shared memory
# (256 x 512 f32 is 512 KB; 1024 x 62 is 248 KB)
SHAPES = ((256, 512, 2), (1024, 62, 1))


@pytest.mark.parametrize("m_pad", (1, 8, 56, 256, 460, 800, 1024, 3072, 8191,
                                   8192, 8193, 9000, 16384))
def test_plan_fused_graph_conv_case3_where_the_reference_has_it(m_pad):
    """Case 3 exactly where the reference's planner gives it (m_pad past
    LARGE_M), for f32 and bf16 operands and narrow to wide layers; below
    it every plan fits a block, with the panels in shared memory or, past
    ~750 rows, in the large-matrix scratch."""
    for n_in, n_out in ((62, 64), (512, 512), (512, 64), (4, 300), (12, 5)):
        for itemsize in (4, 2):
            want = jb.plan_fused_graph_conv(
                batch=4, m_pad=m_pad, n_in=n_in, n_out=n_out, channels=4,
                nnz_pad=256, itemsize=itemsize)
            got = tb.plan_fused_graph_conv(batch=4, m_pad=m_pad, n_in=n_in,
                                           n_out=n_out, itemsize=itemsize)
            assert (got.case == 3) == (want.case == 3), (got, want)
            if got.case == 3:
                continue
            assert got.p == -(-n_out // got.n_block)
            assert got.n_block <= tb.PANEL_MAX and got.smem_bytes <= \
                tb.SMEM_BYTES
            tc = tb.fused_tile_cols(got.n_block)
            ring = tb.fused_ring_bytes(
                tc, itemsize, tb.fused_tile_rows(m_pad, tc, itemsize))
            panels = 4 * tb.fused_panel_floats(m_pad, tc)
            assert got.smem_bytes == ring + (0 if got.large else panels)


@pytest.mark.parametrize("batch,m_pad,n_out,channels", [
    (8, 1024, 64, 4), (2, 3072, 64, 4), (2, 1024, 64, 8), (2, 1024, 40, 4),
    (3, 1024, 300, 2), (1, 8192, 5, 16)])
def test_fused_large_scratch_stays_within_twice_the_former_panels(
        batch, m_pad, n_out, channels):
    """The large-matrix branch's scratch holds U of every channel (batch x
    m_pad x n_out rounded up to 4 floats each) where that is at most twice
    the U_ch and accumulator panels its former design kept per block, else
    the largest group of channels that fits that budget beside one
    accumulator; the kernel reads the group back from the size alone."""
    for itemsize in (4, 2):
        plan = tb.plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=62,
                                        n_out=n_out, itemsize=itemsize)
        assert plan.large
        floats, group = tb.fused_large_scratch(
            batch=batch, channels=channels, m_pad=m_pad, n_out=n_out,
            n_block=plan.n_block)
        per_ch = batch * m_pad * (-(-n_out // 4) * 4)
        former = batch * plan.p * tb.fused_panel_floats(
            m_pad, tb.fused_tile_cols(plan.n_block))
        assert 1 <= group <= channels
        assert floats <= 2 * former
        if group == channels:
            assert floats == channels * per_ch
        else:
            assert floats == (group + 1) * per_ch
            assert (group + 2) * per_ch > 2 * former
        kernel_group = (channels if floats >= channels * per_ch
                        else floats // per_ch - 1)
        assert kernel_group == group
    # the FUSED_LARGE shapes of chip_smoke.py hold all four channels
    assert tb.fused_large_scratch(batch=8, channels=4, m_pad=1024, n_out=64,
                                  n_block=16) == (4 * 8 * 1024 * 64, 4)


@functools.lru_cache(maxsize=None)
def _layer(m_pad: int, n_in: int, batch: int):
    """Two channels of the reference's powerlaw generator (hub rows at m_pad
    256) with N(0, 1) values, and x, w, bias, residual, from one seed."""
    rng = np.random.default_rng(m_pad + n_in)
    adj = []
    for _ in range(CHANNELS):
        coo, mp = jf.random_powerlaw_batch(rng, batch=batch, dim=m_pad,
                                           avg_deg=4)
        assert mp == m_pad
        vals = np.where(to_np(coo.values) != 0,
                        rng.normal(size=coo.values.shape), 0)
        adj.append(dataclasses.replace(
            coo, values=jnp.asarray(vals.astype(np.float32))))
    x = rng.normal(size=(batch, m_pad, n_in)).astype(np.float32)
    w = (rng.normal(size=(CHANNELS, n_in, N_OUT)) / n_in ** 0.5).astype(
        np.float32)
    bias = rng.normal(size=(CHANNELS, N_OUT)).astype(np.float32)
    res = rng.normal(size=(batch, m_pad, N_OUT)).astype(np.float32)
    return adj, x, w, bias, res


@pytest.mark.parametrize("impl", ("fused", "fused_hybrid", "fused_bf16"))
@pytest.mark.parametrize("m_pad,n_in,batch", SHAPES)
def test_fused_graph_conv_matches_reference_past_the_x_tile(impl, m_pad, n_in,
                                                           batch):
    adj, x, w, bias, res = _layer(m_pad, n_in, batch)
    jr, jc, jv, jn = j_stack(adj)
    tr, tc_, tv, tn = stack_channels([torch_coo(a) for a in adj])
    dense = (x, w, bias, res)
    if impl == "fused_bf16":
        jr, jc = jr.astype(jnp.int16), jc.astype(jnp.int16)
        jv = jv.astype(jnp.bfloat16)
        jd = [jnp.asarray(a).astype(jnp.bfloat16) for a in dense]
        tr, tc_ = tf.narrow_col_ids(tr, m_pad), tf.narrow_col_ids(tc_, m_pad)
        tv = tv.to(torch.bfloat16)
        td = [torch.from_numpy(a).to(torch.bfloat16) for a in dense]
    else:
        jd = [jnp.asarray(a) for a in dense]
        td = [torch.from_numpy(a) for a in dense]
    plan = tb.plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=n_in,
                                    n_out=N_OUT, itemsize=td[0].element_size())
    assert plan.case != 3
    want = j_fused(jr, jc, jv, jn, *jd[:3], epilogue="relu", residual=jd[3],
                   interpret=True, impl=impl)
    got = fused_graph_conv(tr, tc_, tv, tn, *td[:3], epilogue="relu",
                           residual=td[3], impl=impl)
    assert got.dtype == td[0].dtype and got.shape == (batch, m_pad, N_OUT)
    atol, rtol = TOLS["bf16" if impl == "fused_bf16" else "f32"]
    np.testing.assert_allclose(got.float().numpy(),
                               to_np(want.astype(jnp.float32)), atol=atol,
                               rtol=rtol)


def test_hybrid_head_bound_is_exact():
    """``fused_hybrid_operands`` gives each sample's hub count (the rows
    with a degree over the channels of at least dmin, at most d_pad) and
    leaves the slab's rows past it zero, so the head bounded by ``hubs``
    equals the head over all d_pad rows; the plain version, like the
    kernel, drops slab rows past the bound."""
    adj, x, w, bias, res = _layer(256, 512, 2)
    rid, cid, val, nnz = stack_channels([torch_coo(a) for a in adj])
    m_pad = x.shape[1]
    hp = tb.plan_hybrid(batch=2, m_pad=m_pad, n_b=N_OUT,
                        nnz_pad=CHANNELS * rid.shape[2])
    rs, cs, vs, chunks, rank, slab, hubs = fused_hybrid_operands(
        rid, cid, val, m_pad, hp)
    deg = sum(tf.row_degrees(torch_coo(a), m_pad) for a in adj)
    assert hubs.dtype == torch.int32
    assert hubs.tolist() == (deg >= hp.dmin).sum(dim=1).clamp(
        max=hp.d_pad).tolist()
    assert 0 < int(hubs.min()) and int(hubs.max()) < hp.d_pad
    rows = torch.arange(hp.d_pad)[None, None, :, None]
    assert not slab.masked_select(rows >= hubs[:, None, None, None]).any()
    xs, ws, bs, r = map(torch.from_numpy, (x, w, bias, res))
    full = fused_forward(rs, cs, vs, chunks, xs, ws, bs, r, rank, slab,
                         epilogue="relu")
    bounded = fused_forward(rs, cs, vs, chunks, xs, ws, bs, r, rank, slab,
                            epilogue="relu", hubs=hubs)
    torch.testing.assert_close(bounded, full, rtol=0, atol=0)
    # a slab row past the bound is not read
    noisy = slab + (rows >= hubs[:, None, None, None]).float()
    torch.testing.assert_close(
        fused_forward(rs, cs, vs, chunks, xs, ws, bs, r, rank, noisy,
                      epilogue="relu", hubs=hubs), full, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs the slab"):
        fused_forward(rs, cs, vs, chunks, xs, ws, bs, hubs=hubs)
    with pytest.raises(TypeError, match="dtype"):
        fused_forward(rs, cs, vs, chunks, xs, ws, bs, r, rank, slab,
                      hubs=hubs.long())


def test_large_plan_reaches_the_kernel_and_case3_raises():
    """m_pad 1024 plans the large-matrix branch, which CUDA tensors launch
    (meta tensors reach the device check: there is no plain fallback), and
    the plain version computes it on the CPU; past LARGE_M the layer raises
    on the CPU too, as the reference's does."""
    adj, x, w, bias, res = _layer(1024, 62, 1)
    rid, cid, val, nnz = stack_channels([torch_coo(a) for a in adj])
    chunks = runtime_chunks(nnz)
    xs, ws, bs = map(torch.from_numpy, (x, w, bias))
    plan = tb.plan_fused_graph_conv(batch=1, m_pad=1024, n_in=62, n_out=N_OUT)
    assert plan.large and plan.case != 3
    got = fused_forward(rid, cid, val, chunks, xs, ws, bs, plan=plan)
    torch.testing.assert_close(
        got, ref.fused_graph_conv_plain(rid, cid, val, chunks, xs, ws, bs),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_forward(*(t.to("meta") for t in (rid, cid, val, chunks, xs, ws,
                                               bs)), plan=plan)
    m = jb.LARGE_M + 1
    ids = torch.zeros((1, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="case 3"):
        fused_graph_conv(ids, ids, torch.zeros((1, 1, 8)),
                         torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1, m, 4)), torch.zeros((1, 4, 4)),
                         torch.zeros((1, 4)))
