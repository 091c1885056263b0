"""The port's forward gather (``ucnerf_tpu_torch/ops/gather.py``) against the
JAX package's Pallas ``take_cm`` in interpreter mode, on the cases of
``tests/test_gather.py``.

On CPU tensors the port's ``take_cm`` runs its plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Tolerance 2e-5 (f32 mode): the Pallas kernel moves
values through the MXU as a two-bf16 split (hi + residual), which recovers
f32 to ~1e-5 relative.  The bf16 mode is exact on both sides (a one-hot
contraction of bf16-rounded values), so it is compared bitwise.
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
