"""Port parity: the flash-attention kernel's wrapper (its plain version on
the CPU, ``kernels/ref.flash_attention_plain``) against the reference's
``flash_attention`` in interpret mode, on the reference test's five corners
(MHA causal, GQA, MQA with T not a multiple of the tile, window 48,
bidirectional) in f32 and bf16, from the same numpy inputs; the wrapper's
checks; and the plain version against a dense softmax. Tolerances: the
reference test's, 2e-5 (f32) and 3e-2 (bf16) absolute and relative: the
two packages tile the keys differently (the reference's ``kv_block`` per
corner, the port's 64), which changes the rounding of the online softmax
only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import KV_TILE, flash_attention

# (b, t, h, kv, hd, causal, window, the reference's q_block, kv_block)
CORNERS = {
    "mha_causal": (2, 64, 4, 4, 32, True, 0, 32, 32),
    "gqa": (1, 128, 8, 2, 16, True, 0, 64, 32),
    "mqa_ragged": (2, 96, 4, 1, 32, True, 0, 32, 32),
    "window": (1, 128, 4, 4, 32, True, 48, 32, 32),
    "bidirectional": (2, 64, 4, 2, 32, False, 0, 64, 64),
}
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(name, seed=7):
    b, t, h, kv, hd = CORNERS[name][:5]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32))


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CORNERS))
def test_flash_attention_matches_reference(name, dtype):
    causal, window, qb, kvb = CORNERS[name][5:]
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(name)
    want = jflash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                  jnp.asarray(v, jdt), causal=causal, window=window,
                  q_block=qb, kv_block=kvb, interpret=True)
    got = flash_attention(_to_torch(q, tdt), _to_torch(k, tdt),
                          _to_torch(v, tdt), causal=causal, window=window)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=f"{name} {dtype}")


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_plain_version_matches_dense_softmax(name):
    """The blocked recurrence equals one softmax over all keys, for any key
    tile (the kernel's 64, one key per tile, all keys in one tile)."""
    b, t, h, kv, hd, causal, window = CORNERS[name][:7]
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(name, seed=3))
    kk = k.repeat_interleave(h // kv, dim=2)
    vv = v.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    pos = torch.arange(t)
    mask = torch.ones((t, t), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    w = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
    dense = torch.einsum("bhqk,bkhd->bqhd", w, vv).float()
    for tile in (KV_TILE, 1, t):
        got = ref.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, window=window,
                                        kv_block=tile)
        torch.testing.assert_close(got, dense, atol=2e-5, rtol=2e-5,
                                   msg=f"{name}, key tile {tile}")


def test_wrapper_checks_and_launch_counter():
    q, k, v = (torch.from_numpy(a) for a in _inputs("gqa"))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k, v[:, :-1])
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention(q[:, :, :7].contiguous(), k, v)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], k[0], v[0])
    before = flash_attention.launches
    flash_attention(q, k, v)            # the plain version: no launch
    assert flash_attention.launches == before
    assert "flash_attention" in _build.SOURCES
    assert (_build.CSRC / "flash_attention.cu").is_file()
