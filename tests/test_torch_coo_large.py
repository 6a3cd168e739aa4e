"""The COO class at the giant-graph tier's sampled blocks
(``block_caps(512, (10, 5))`` in the reference's sampling: one matrix of
33,792 rows, 3,072 of them live with 10 slots each, and one of 3,072 rows,
512 live with 5), n_b 64: the port on the CPU through ``batched_spmm`` /
``batched_gspmm`` with ``impl="pallas_coo"`` (its planner's case 3 at
both: the large-matrix entry's wrapper, whose plain version runs on CPU
tensors) against the reference's same call at f32 ``TOLS``. At 33,792 rows
the reference is at case 3 too and takes its plain per-sample path; at
3,072 its planner (a fixed row threshold, 8,192) keeps case 1 and runs its
Pallas kernel (interpret mode on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import coo_from_lists as j_coo_from_lists
from repro.core.batching import plan_batched_spmm as j_plan_batched_spmm
from repro.kernels import ops as j_ops
from repro_torch.core.batching import plan_batched_spmm
from repro_torch.core.formats import coo_from_lists
from repro_torch.kernels import ops

ATOL, RTOL = TOLS["f32"]
# (m_pad, live rows, slots a live row, the reference planner's case)
TIER_BLOCKS = ((33_792, 3_072, 10, 3), (3_072, 512, 5, 1))
CORNERS = (("mul", "sum"), ("copy_lhs", "mean"), ("mul", "max"))


def _block(m_pad, live, fanout, seed=0):
    """The block's slot lists (destinations in row order, columns drawn
    over every row, N(0, 1) values) and a (1, m_pad, 64) B, as numpy."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(live, dtype=np.int32), fanout)
    lists = [(r, rng.integers(0, m_pad, r.size).astype(np.int32),
              rng.normal(size=r.size).astype(np.float32))]
    return lists, rng.normal(size=(1, m_pad, 64)).astype(np.float32)


@pytest.mark.parametrize("m_pad,live,fanout,j_case", TIER_BLOCKS)
def test_tier_blocks_plan_case3_in_the_port(m_pad, live, fanout, j_case):
    """The port's planner (shared memory per block) gives case 3 at both
    blocks, so the card runs the COO large-matrix entries there; the
    reference's gives case 3 past 8,192 rows only."""
    assert plan_batched_spmm(batch=1, m_pad=m_pad, n_b=64).case == 3
    assert j_plan_batched_spmm(batch=1, m_pad=m_pad, n_b=64,
                               slots=live * fanout).case == j_case


@pytest.mark.parametrize("op,reduce", CORNERS)
@pytest.mark.parametrize("m_pad,live,fanout,j_case", TIER_BLOCKS)
def test_tier_blocks_pallas_coo_matches_reference(m_pad, live, fanout,
                                                  j_case, op, reduce):
    """The port's ``pallas_coo`` at the block against the reference's, the
    (mul, sum) SpMM through ``batched_spmm`` and two g-SpMM corners through
    ``batched_gspmm``, at f32 TOLS."""
    lists, b = _block(m_pad, live, fanout)
    jc, tc = j_coo_from_lists(lists, [m_pad]), coo_from_lists(lists, [m_pad])
    assert tc.nnz_pad == live * fanout
    bt = torch.from_numpy(b)
    if (op, reduce) == ("mul", "sum"):
        want = j_ops.batched_spmm(jc, jnp.asarray(b), impl="pallas_coo")
        got = ops.batched_spmm(tc, bt, impl="pallas_coo")
    else:
        want = j_ops.batched_gspmm(jc, jnp.asarray(b), op=op, reduce=reduce,
                                   impl="pallas_coo")
        got = ops.batched_gspmm(tc, bt, op=op, reduce=reduce,
                                impl="pallas_coo")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=f"{m_pad} ({op}, {reduce})")
