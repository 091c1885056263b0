"""The port's forward gather (``ucnerf_tpu_torch/ops/gather.py``) against the
JAX package's Pallas ``take_cm`` in interpreter mode, on the cases of
``tests/test_gather.py``.

On CPU tensors the port's ``take_cm`` runs its plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Tolerance 2e-5 (f32 mode): the Pallas kernel moves
values through the MXU as a two-bf16 split (hi + residual), which recovers
f32 to ~1e-5 relative.  The bf16 mode is exact on both sides (a one-hot
contraction of bf16-rounded values), so it is compared bitwise.

``take_wsum_cm`` (the gather with the 8-corner weighted sum fused in) is held
against the same Pallas gather followed by the weighted corner sum in jnp.
Its tolerance is relative to ``mag = sum_k |w_k * row_k|``, the magnitude of
what is summed: 2e-5 x mag in f32 mode (the Pallas split, per row), and 8 ulp
(2^-23) of mag in bf16 mode, where both sides hold the same rounded rows and
only the order of the 8 f32 additions differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu.ops import gather as jgather
from ucnerf_tpu_torch.ops import gather as tgather

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _table(rng, c, rows, scale=1.0, shift=0.0):
    return (rng.normal(0, 1, (c, rows)) * scale + shift).astype(np.float32)


def _port(table, idx, bf16=False):
    before = tgather.take_cm.launches
    out = tgather.take_cm(torch.from_numpy(table), torch.from_numpy(idx),
                          bf16=bf16).numpy()
    assert tgather.take_cm.launches == before  # CPU: no kernel launch
    return out


def _pallas(table, idx, **kw):
    return np.asarray(jgather.take_cm(jnp.asarray(table), jnp.asarray(idx),
                                      interpret=True, **kw))


@pytest.mark.parametrize("rows,m,span,k", [
    (4096, 4096, 512, 512),       # uniform density ~1/row
    (1536, 8192, 512, 1024),      # dense: many lookups per window
    (16384, 1024, 512, 512),      # sparse: most windows empty
    (5000, 3000, 512, 512),       # rows not a multiple of span
    (1024, 700, 256, 256),        # m not a multiple of block_k
])
def test_take_cm_matches_pallas(rng, rows, m, span, k):
    tbl = _table(rng, 4, rows)
    idx = rng.integers(0, rows, m).astype(np.int32)
    want = _pallas(tbl, idx, span_rows=span, block_k=k)
    np.testing.assert_allclose(_port(tbl, idx), want, **TOL)


def test_take_cm_duplicate_and_boundary_indices(rng):
    rows = 2048
    special = np.array([0, 127, 128, 129, 511, 512, 513, rows - 1, rows - 1,
                        0, 512, 1024, 1535, 1536], np.int32)
    idx = np.tile(special, 40)
    tbl = _table(rng, 4, rows)
    want = _pallas(tbl, idx, span_rows=512, block_k=256)
    np.testing.assert_allclose(_port(tbl, idx), want, **TOL)


def test_take_cm_preserves_shape(rng):
    tbl = _table(rng, 4, 1024)
    idx = rng.integers(0, 1024, (16, 3, 20)).astype(np.int32)
    got = _port(tbl, idx)
    assert got.shape == (4, 16, 3, 20)
    want = _pallas(tbl, idx, span_rows=256, block_k=256)
    np.testing.assert_allclose(got, want, **TOL)


def test_take_cm_skewed_distribution(rng):
    rows = 8192
    tbl = _table(rng, 4, rows)
    idx = np.concatenate([rng.integers(0, 64, 4096),
                          rng.integers(4096, rows, 512)]).astype(np.int32)
    want = _pallas(tbl, idx, span_rows=512, block_k=512)
    np.testing.assert_allclose(_port(tbl, idx), want, **TOL)


def test_take_cm_sentinels_are_zero(rng):
    """Indices >= rows (the Pallas kernel's sentinels) give zeros, mixed
    anywhere in the stream; the sorted-stream kernel agrees."""
    rows = 1000
    tbl = _table(rng, 4, rows)
    sidx = np.concatenate([np.sort(rng.integers(0, rows, 500)),
                           np.full(12, 1024)]).astype(np.int32)
    want = np.asarray(jgather.gather_sorted_cm(
        jnp.asarray(tbl), jnp.asarray(sidx), rows, span_rows=512,
        block_k=256, interpret=True))
    np.testing.assert_allclose(_port(tbl, sidx), want, **TOL)

    mixed = rng.integers(0, rows, 600).astype(np.int32)
    at = rng.choice(600, 60, replace=False)
    mixed[at] = rows + rng.integers(0, 5000, 60)
    mixed[:2] = [rows, np.iinfo(np.int32).max]
    got = _port(tbl, mixed)
    np.testing.assert_array_equal(got[:, at], 0.0)
    np.testing.assert_array_equal(got[:, :2], 0.0)
    np.testing.assert_allclose(got, _pallas(tbl, mixed, span_rows=512,
                                            block_k=256), **TOL)


def test_take_cm_bf16_matches_single_pass(rng):
    """bf16 mode == the Pallas ``two_pass=False`` (grid_bf16_gather)."""
    rows, m = 2048, 2048
    tbl = _table(rng, 4, rows, scale=37.0, shift=11.0)
    idx = rng.integers(0, rows, m).astype(np.int32)
    rounded = _port(tbl, idx, bf16=True)
    np.testing.assert_array_equal(rounded,
                                  _pallas(tbl, idx, two_pass=False))
    exact = _port(tbl, idx)
    assert np.abs(rounded - exact).max() > 0


def test_take_cm_column_slice(rng):
    """A level's slice of a packed table, as the encoder passes it."""
    tbl = torch.from_numpy(_table(rng, 4, 3000))
    idx = torch.from_numpy(rng.integers(0, 1200, 500).astype(np.int32))
    got = tgather.take_cm(tbl[:, 1000:2200], idx)
    want = tgather.take_cm_plain(tbl[:, 1000:2200].contiguous(), idx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_take_cm_rejects_table_grad_and_other_devices(rng):
    """A table that requires grad is no longer refused: its gradient is the
    hash encoder's autograd Function (tests/test_torch_scatter.py), which
    calls take_cm on the detached table.  Other devices are refused."""
    tbl = torch.from_numpy(_table(rng, 4, 64)).requires_grad_()
    idx = torch.arange(8, dtype=torch.int32) * 5
    got = tgather.take_cm(tbl, idx)
    assert got.shape == (4, 8)
    torch.testing.assert_close(got.detach(), tbl.detach()[:, idx.long()],
                               rtol=0, atol=0)
    with torch.no_grad():
        assert tgather.take_cm(tbl, idx).shape == (4, 8)
    with pytest.raises(ValueError):
        tgather.take_cm(torch.zeros((4, 64), device="meta"),
                        torch.zeros(8, dtype=torch.int32, device="meta"))


def _wsum_inputs(rng, c, rows, n, lo=0):
    """A packed table, corner indices with sentinels mixed in, and weights
    in [0, 1) as trilinear weights are."""
    tbl = _table(rng, c, lo + rows + 37, scale=3.0, shift=0.5)
    idx = rng.integers(0, rows, (8, n)).astype(np.int32)
    at = rng.random((8, n)) < 0.05
    idx[at] = rows + rng.integers(0, 4000, int(at.sum()))
    idx[0, :2] = [rows, np.iinfo(np.int32).max]
    w = rng.random((8, n)).astype(np.float32)
    return tbl, idx, w


def _pallas_wsum(level, idx, w, bf16):
    rows = _pallas(level, idx.reshape(-1), span_rows=512, block_k=256,
                   two_pass=not bf16)
    rows = rows.reshape(level.shape[0], 8, -1)
    return (np.asarray((jnp.asarray(rows) * jnp.asarray(w)[None]).sum(axis=1)),
            (np.abs(rows) * w[None]).sum(axis=1))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,rows,n,lo", [
    (4, 2048, 1024, 0),      # the encoder's shape: 4 channels, aligned N
    (4, 1500, 1003, 700),    # a column slice; N a multiple of no block size
    (2, 1000, 77, 0),        # another channel count, N not a multiple of 4
])
def test_take_wsum_cm_matches_pallas(rng, bf16, c, rows, n, lo):
    tbl, idx, w = _wsum_inputs(rng, c, rows, n, lo)
    level = torch.from_numpy(tbl)[:, lo:lo + rows]
    assert lo == 0 or not level.is_contiguous()
    before = (tgather.take_wsum_cm.launches, tgather.take_cm.launches)
    got = tgather.take_wsum_cm(level, torch.from_numpy(idx),
                               torch.from_numpy(w), bf16=bf16).numpy()
    # CPU: no kernel launch.
    assert before == (tgather.take_wsum_cm.launches,
                      tgather.take_cm.launches)
    assert got.shape == (c, n)
    want, mag = _pallas_wsum(np.ascontiguousarray(tbl[:, lo:lo + rows]), idx,
                             w, bf16)
    tol = (8 * 2.0**-23 if bf16 else 2e-5) * mag
    assert (np.abs(got - want) <= tol + 1e-30).all(), float(
        (np.abs(got - want) / np.maximum(mag, 1e-30)).max())
    # A point whose 8 corners are all sentinels gets exactly 0.
    idx[:, 5] = rows + 3
    got = tgather.take_wsum_cm(level, torch.from_numpy(idx),
                               torch.from_numpy(w), bf16=bf16).numpy()
    np.testing.assert_array_equal(got[:, 5], 0.0)
    if bf16:  # not vacuous: the unrounded rows are elsewhere
        exact = tgather.take_wsum_cm(level, torch.from_numpy(idx),
                                     torch.from_numpy(w)).numpy()
        assert np.abs(exact - got).max() > 0


@pytest.mark.parametrize("bf16", [False, True])
def test_take_wsum_cm_one_hot_weights_are_take_cm(rng, bf16):
    """One weight 1 and seven 0: the fused gather is the plain gather of
    that corner, bitwise, and so bitwise the Pallas gather in bf16 mode."""
    tbl, idx, _ = _wsum_inputs(rng, 4, 1200, 501)
    pick = rng.integers(0, 8, (1, 501))
    w = np.zeros((8, 501), np.float32)
    np.put_along_axis(w, pick, 1.0, axis=0)
    level = torch.from_numpy(tbl)[:, :1200]
    got = tgather.take_wsum_cm(level, torch.from_numpy(idx),
                               torch.from_numpy(w), bf16=bf16).numpy()
    chosen = np.take_along_axis(idx, pick, axis=0)[0]
    np.testing.assert_array_equal(got, _port(np.ascontiguousarray(
        tbl[:, :1200]), chosen, bf16=bf16))
    if bf16:
        np.testing.assert_array_equal(got, _pallas(
            np.ascontiguousarray(tbl[:, :1200]), chosen, two_pass=False))


def test_take_wsum_cm_rejects_what_it_cannot_do(rng):
    tbl, idx, w = _wsum_inputs(rng, 4, 300, 40)
    t, i, wt = (torch.from_numpy(x) for x in (tbl, idx, w))
    # It has no backward: weights that need a gradient are refused in grad
    # mode (the encoder gathers with take_cm then), and taken without.
    with pytest.raises(ValueError):
        tgather.take_wsum_cm(t, i, wt.clone().requires_grad_())
    with torch.no_grad():
        out = tgather.take_wsum_cm(t, i, wt.clone().requires_grad_())
    torch.testing.assert_close(out, tgather.take_wsum_cm(t, i, wt), rtol=0,
                               atol=0)
    with pytest.raises(ValueError):  # 8 corners, corner-major
        tgather.take_wsum_cm(t, i[:7], wt[:7])
    with pytest.raises(ValueError):
        tgather.take_wsum_cm(t, i, wt[:, :39])
    with pytest.raises(ValueError):
        tgather.take_wsum_cm(torch.zeros((4, 64), device="meta"),
                             torch.zeros((8, 4), dtype=torch.int32,
                                         device="meta"),
                             torch.zeros((8, 4), device="meta"))
    with pytest.raises(ValueError):
        tgather.interleave_cm(t)  # a CUDA-only helper
