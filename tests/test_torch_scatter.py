"""The port's hash-grid backward scatters (``ucnerf_tpu_torch/ops/scatter.py``,
K1, K2, K3, K5 and the partial scatter) and the encoder's table gradient,
against the JAX package's Pallas kernels in interpret mode.

On the CPU the port runs its plain versions (``index_add_``), which sum in
f32; the Pallas kernels split each value into two bf16 parts for the MXU
(relative error ~1e-5).  Hence rtol 2e-5 with an atol of 2e-5 x max|out| for
the cancellations of random-signed sums.  K2 rounds the fractional coords to
bf16 on both sides, so it is held to the same tolerance, and the test checks
that the comparison would fail without that rounding.  K3 rounds every
update to bf16 on both sides (``pack_bf16_pairs``, bit-identical), after which
the Pallas kernel's single bf16 matmul and the port's f32 sum are both exact
up to f32 summation order: the same tolerance.  In the encoder's bf16
backward the updates ``w * g`` are formed in f32 on each side first, and a
last-bit difference there can round a term to the other bf16 neighbour
(2^-8 of the term): at most 0.5 % of a table's entries may miss the
tolerance, each by no more than 2^-8 x max|grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.ops import scatter as jscatter
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.ops import scatter as tscatter

torch.set_num_threads(2)

RTOL = 2e-5


def _close(got, want, rtol=RTOL, atol_frac=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * scale)


def _k1_case(case, rng):
    if case == "one_row":  # every update into one row (the worst skew)
        c, m, rows = 4, 4096, 3000
        return (rng.normal(size=(c, m)).astype(np.float32),
                np.full((m,), 7, np.int32), rows, 1)
    if case == "boundaries":  # first/last and tile-boundary rows
        c, rows = 2, 2500
        idx = np.array([0, 1023, 1024, 2047, 2048, rows - 1, 0], np.int32)
        vals = np.arange(c * idx.size, dtype=np.float32).reshape(c, -1) + 1
        return vals, idx, rows, 1
    if case == "empty":
        return np.zeros((2, 0), np.float32), np.zeros((0,), np.int32), 2500, 1
    if case == "segments":  # increasing per-segment row ranges
        nseg, per = 4, 750
        idx = np.concatenate([rng.integers(s * 1000, s * 1000 + 1000, per)
                              for s in range(nseg)]).astype(np.int32)
        return (rng.normal(size=(2, nseg * per)).astype(np.float32), idx,
                4000, nseg)
    c, m, rows = case
    return (rng.normal(size=(c, m)).astype(np.float32),
            rng.integers(0, rows, m).astype(np.int32), rows, 1)


@pytest.mark.parametrize("case", [(4, 5000, 3000), (1, 2048, 1 << 15),
                                  (4, 513, 1025), "one_row", "boundaries",
                                  "empty", "segments"])
def test_scatter_add_cm_plain_matches_pallas(rng, case):
    """Duplicates, tile boundaries, an empty stream and all updates into one
    row, against the Pallas kernel with and without sort_segments."""
    vals, idx, rows, nseg = _k1_case(case, rng)
    got = tscatter.scatter_add_cm(torch.from_numpy(vals),
                                  torch.from_numpy(idx), rows)
    assert got.shape == (vals.shape[0], rows)
    for segments in sorted({1, nseg}):
        want = jscatter.scatter_add_cm(jnp.asarray(vals), jnp.asarray(idx),
                                       rows, interpret=True,
                                       sort_segments=segments)
        _close(got.numpy(), want)
    if case == "empty":
        assert float(got.abs().max()) == 0.0


def test_scatter_add_cm_writes_into_a_column_slice(rng):
    vals, idx, rows, _ = _k1_case((4, 900, 700), rng)
    buf = torch.full((4, rows + 300), 7.0)
    out = tscatter.scatter_add_cm(torch.from_numpy(vals),
                                  torch.from_numpy(idx), rows,
                                  out=buf[:, 300:])
    assert out.data_ptr() == buf[:, 300:].data_ptr()
    np.testing.assert_array_equal(buf[:, :300].numpy(), 7.0)
    want = np.zeros((4, rows))
    np.add.at(want, (slice(None), idx), vals.astype(np.float64))
    np.testing.assert_allclose(buf[:, 300:].numpy(), want, rtol=1e-5,
                               atol=1e-5)


def _dense_stream(rng, level_sizes, strides, level_len):
    """Random per-level samples whose 8 corners stay inside each level."""
    offs = np.concatenate([[0], np.cumsum(level_sizes)]).astype(np.int64)
    base = [rng.integers(0, size - (s * s + s + 1) - 1, level_len) + offs[l]
            for l, (size, s) in enumerate(zip(level_sizes, strides))]
    m = len(level_sizes) * level_len
    fracs = rng.uniform(0, 1, size=(4, m)).astype(np.float32)
    fracs[3] = 0.0
    return (rng.normal(size=(4, m)).astype(np.float32), fracs,
            np.concatenate(base).astype(np.int32), tuple(int(o) for o in offs))


def _dense_case(case, rng):
    if case == "multi_level":  # the real l0/l1 dense sizes; padding
        strides, level_len = (17, 34), 700
        g, fr, base, offs = _dense_stream(rng, (4920, 35944), strides,
                                          level_len)
        return g, fr, base, offs, strides, level_len
    # One level, all samples in one cell, corners across a tile boundary.
    level_len = 2048
    fracs = rng.uniform(0, 1, size=(4, level_len)).astype(np.float32)
    fracs[3] = 0.0
    return (rng.normal(size=(4, level_len)).astype(np.float32), fracs,
            np.full((level_len,), 4090, np.int32), (0, 8192), (17,),
            level_len)


def _dense_port(g, fr, base, offs, strides, level_len):
    return tscatter.scatter_add_dense_cm(
        torch.from_numpy(g), torch.from_numpy(fr), torch.from_numpy(base),
        offs[-1], level_len=level_len, strides=strides,
        level_offsets=offs).numpy()


@pytest.mark.parametrize("case", ["multi_level", "concentrated"])
def test_scatter_add_dense_cm_plain_matches_pallas(rng, case):
    g, fr, base, offs, strides, level_len = _dense_case(case, rng)
    got = _dense_port(g, fr, base, offs, strides, level_len)
    want = np.asarray(jscatter.scatter_add_dense_cm(
        jnp.asarray(g), jnp.asarray(fr), jnp.asarray(base), offs[-1],
        level_len=level_len, strides=strides, interpret=True))
    assert got.shape == want.shape == (4, offs[-1])
    _close(got, want)
    # Not vacuous: with f32 fracs (no bf16 rounding) the sums move by more
    # than the tolerance.
    exact = np.zeros_like(want, dtype=np.float64)
    for l, s in enumerate(strides):
        sl = slice(l * level_len, (l + 1) * level_len)
        for corner in range(8):
            w = np.ones(level_len)
            for d in range(3):
                f = fr[d, sl].astype(np.float64)
                w = w * (f if corner & (1 << d) else 1 - f)
            off = (corner & 1) + ((corner >> 1) & 1) * s \
                + ((corner >> 2) & 1) * s * s
            np.add.at(exact, (slice(None), base[sl] + off), w * g[:, sl])
    with pytest.raises(AssertionError):
        _close(exact, want)


def _grid(log2=16):
    mlp = tconfigs.tiny().nerf_mlp
    kw = dict(num_levels=mlp.grid_num_levels, level_dim=mlp.grid_level_dim,
              base_resolution=mlp.grid_base_resolution,
              desired_resolution=mlp.grid_desired_resolution,
              log2_hashmap_size=log2)
    return jhash.HashGridSpec(**kw), thash.HashGridSpec(**kw)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("hex_n", [6, 1])
def test_encode_table_and_input_grads_match_pallas(rng, monkeypatch, dense,
                                                   hex_n):
    """``encode_hex_cm``'s table and input gradients against the JAX
    encoder's custom VJP running the Pallas scatters (interpret mode), in
    exact-hex and single-query modes, with the dense-level K2 path on and
    off."""
    monkeypatch.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
    jspec, tspec = _grid()
    assert 1 <= tspec.dense_prefix < tspec.num_levels
    n = 150
    x01 = rng.uniform(-0.05, 1.05, (3, hex_n, n)).astype(np.float32)
    stds = rng.uniform(0.01, 0.3, (6, n)).astype(np.float32)
    table = rng.normal(0, 0.1, (4, tspec.table_rows)).astype(np.float32)
    cot_f = rng.normal(size=(tspec.output_dim, n)).astype(np.float32)
    cot_w = rng.normal(size=(tspec.num_levels, n)).astype(np.float32)

    def jloss(t, x):
        feats, wm = jhash.encode_hex_cm(x, jnp.asarray(stds), t, jspec,
                                        bwd_dense_sample=dense)
        return jnp.vdot(feats, cot_f) + jnp.vdot(wm, cot_w)

    want_v, (want_t, want_x) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x01))

    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x01).requires_grad_()
    feats, wm = thash.encode_hex_cm(tx, torch.from_numpy(stds), tt, tspec,
                                    bwd_dense_sample=dense)
    loss = (feats * torch.from_numpy(cot_f)).sum() + (
        wm * torch.from_numpy(cot_w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_v),
                               rtol=1e-5)
    _close(tt.grad.numpy(), want_t, rtol=1e-4, atol_frac=1e-5)
    _close(tx.grad.numpy(), want_x, rtol=2e-4, atol_frac=2e-5)
    assert float(tt.grad.abs().max()) > 0


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape", [(4, 257), (2, 1000), (8, 33)])
def test_pack_unpack_bf16_pairs_bitwise_match_jax(rng, shape):
    """Negative values, ties, denormals and overflow to inf included."""
    vals = rng.normal(size=shape).astype(np.float32)
    vals[0, :6] = [0.0, -0.0, 1e-40, -3.0e38, 3.4e38, 1.00390625]
    want = np.asarray(jscatter.pack_bf16_pairs(jnp.asarray(vals)))
    got = tscatter.pack_bf16_pairs(torch.from_numpy(vals))
    assert got.dtype == torch.int32 and got.shape == (shape[0] // 2, shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    back = tscatter.unpack_bf16_pairs(got)
    np.testing.assert_array_equal(
        back.numpy().view(np.int32),
        np.asarray(jscatter.unpack_bf16_pairs(jnp.asarray(want))).view(
            np.int32))
    np.testing.assert_array_equal(back.numpy().view(np.int32),
                                  _bf16(vals).view(np.int32))
    with pytest.raises(ValueError):
        tscatter.pack_bf16_pairs(torch.zeros((3, 4)))


@pytest.mark.parametrize("case", [(4, 5000, 3000), (2, 2048, 1 << 15),
                                  (8, 513, 1025), "one_row", "boundaries",
                                  "empty", "segments"])
def test_scatter_add_packed_cm_plain_matches_pallas(rng, case):
    vals, idx, rows, nseg = _k1_case(case, rng)
    got = tscatter.scatter_add_packed_cm(torch.from_numpy(vals),
                                         torch.from_numpy(idx), rows)
    assert got.shape == (vals.shape[0], rows)
    for segments in sorted({1, nseg}):
        want = jscatter.scatter_add_packed_cm(
            jnp.asarray(vals), jnp.asarray(idx), rows, interpret=True,
            sort_segments=segments)
        _close(got.numpy(), want)
    if case == "empty":
        assert float(got.abs().max()) == 0.0
    elif case == "one_row":
        # Not vacuous: the f32 sum of the unrounded updates is elsewhere.
        with pytest.raises(AssertionError):
            _close(tscatter.scatter_add_cm(
                torch.from_numpy(vals), torch.from_numpy(idx), rows).numpy(),
                want, atol_frac=0.0)


def test_scatter_add_packed_cm_writes_into_a_column_slice(rng):
    vals, idx, rows, _ = _k1_case((4, 900, 700), rng)
    buf = torch.full((4, rows + 300), 7.0)
    out = tscatter.scatter_add_packed_cm(
        torch.from_numpy(vals), torch.from_numpy(idx), rows,
        out=buf[:, 300:])
    assert out.data_ptr() == buf[:, 300:].data_ptr()
    np.testing.assert_array_equal(buf[:, :300].numpy(), 7.0)
    want = np.zeros((4, rows))
    np.add.at(want, (slice(None), idx), _bf16(vals).astype(np.float64))
    np.testing.assert_allclose(buf[:, 300:].numpy(), want, rtol=1e-5,
                               atol=1e-5)


def _chunked_case(case, rng):
    """(values, idx, rows, num_chunks, tile_rows, block_k): the JAX package's
    own chunked-scatter cases."""
    if case == "uneven":  # chunk length 300 is no multiple of the block
        rows, m, chunks, tile, block = 2048, 6 * 300, 6, 512, 256
    elif case == "concentrated":  # a handful of rows, hit in every chunk
        rows, m, chunks, tile, block = 4096, 8192, 8, 1024, 512
        return (np.ones((4, m), np.float32),
                (rng.integers(0, 3, m) * 1500).astype(np.int32), rows,
                chunks, tile, block)
    else:
        rows, m, chunks, tile, block = 5000, 12288, case, 1024, 512
    return (rng.normal(0, 1, (4, m)).astype(np.float32),
            rng.integers(0, rows, m).astype(np.int32), rows, chunks, tile,
            block)


@pytest.mark.parametrize("case", [1, 4, 16, "uneven", "concentrated"])
def test_scatter_add_chunked_cm_plain_matches_pallas(rng, case):
    vals, idx, rows, chunks, tile, block = _chunked_case(case, rng)
    got = tscatter.scatter_add_chunked_cm(
        torch.from_numpy(vals), torch.from_numpy(idx), rows,
        num_chunks=chunks)
    want = jscatter.scatter_add_chunked_cm(
        jnp.asarray(vals), jnp.asarray(idx), rows, num_chunks=chunks,
        tile_rows=tile, block_k=block, interpret=True)
    assert got.shape == (4, rows)
    _close(got.numpy(), want)
    with pytest.raises(ValueError):
        tscatter.scatter_add_chunked_cm(
            torch.from_numpy(vals), torch.from_numpy(idx), rows,
            num_chunks=7)


def test_sort_chunks_sorts_each_chunk_stably(rng):
    """The host half of K5: keys ascending inside each chunk, ties in
    stream order, perm local to the chunk."""
    idx = rng.integers(0, 50, 6 * 300).astype(np.int32)
    keys, perm = tscatter.sort_chunks(torch.from_numpy(idx), 6)
    keys, perm = keys.numpy().reshape(6, 300), perm.numpy().reshape(6, 300)
    for g in range(6):
        chunk = idx[g * 300:(g + 1) * 300]
        order = np.argsort(chunk, kind="stable")
        np.testing.assert_array_equal(perm[g], order)
        np.testing.assert_array_equal(keys[g], chunk[order])


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_scatter_add_partial_cm_matches_pallas(rng, chunks):
    rows, c, nseg, per = 4000, 4, 4, 1536
    idx = np.concatenate([rng.integers(s * 1000, s * 1000 + 1000, per)
                          for s in range(nseg)]).astype(np.int32)
    vals = rng.normal(0, 1, (c, nseg * per)).astype(np.float32)
    got = tscatter.scatter_add_partial_cm(
        torch.from_numpy(vals), torch.from_numpy(idx), rows,
        num_chunks=chunks, sort_segments=nseg)
    want = jscatter.scatter_add_partial_cm(
        jnp.asarray(vals), jnp.asarray(idx), rows, num_chunks=chunks,
        sort_segments=nseg, tile_rows=1024, block_k=512, interpret=True)
    _close(got.numpy(), want)
    with pytest.raises(ValueError):
        tscatter.scatter_add_partial_cm(
            torch.from_numpy(vals), torch.from_numpy(idx), rows,
            num_chunks=5, sort_segments=nseg)


def _close_but_flips(got, want, rtol, atol_frac, flips=0.005):
    """_close for all but a share `flips` of the entries, which may be off
    by up to 2^-8 x max|want| (a term rounded to the other bf16 neighbour).
    Returns the share of entries outside the tight tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    out = err > rtol * np.abs(want) + atol_frac * scale
    assert float(err.max()) <= 2.0**-8 * scale
    share = float(out.mean())
    assert share <= flips, share
    return share


@pytest.mark.parametrize("dense", [True, False])
def test_encode_bf16_backward_matches_pallas(rng, monkeypatch, dense):
    """``bwd_value_dtype='bfloat16'``: the table gradient against the JAX
    custom VJP running the packed Pallas scatter (interpret mode; its XLA
    fall-back ignores the knob).  The same comparison against the f32
    backward fails, so the rounding is exercised; the forward and the input
    gradient do not depend on the knob."""
    monkeypatch.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
    jspec, tspec = _grid()
    n = 150
    x01 = rng.uniform(-0.05, 1.05, (3, 6, n)).astype(np.float32)
    stds = rng.uniform(0.01, 0.3, (6, n)).astype(np.float32)
    table = rng.normal(0, 0.1, (4, tspec.table_rows)).astype(np.float32)
    cot_f = rng.normal(size=(tspec.output_dim, n)).astype(np.float32)

    def jgrad(value_dtype):
        def jloss(t):
            feats, _ = jhash.encode_hex_cm(
                jnp.asarray(x01), jnp.asarray(stds), t, jspec,
                bwd_dense_sample=dense, bwd_value_dtype=value_dtype)
            return jnp.vdot(feats, cot_f)
        return np.asarray(jax.grad(jloss)(jnp.asarray(table)))

    def tgrad(value_dtype):
        tt = torch.from_numpy(table).requires_grad_()
        feats, _ = thash.encode_hex_cm(
            torch.from_numpy(x01), torch.from_numpy(stds), tt, tspec,
            bwd_dense_sample=dense, bwd_value_dtype=value_dtype)
        (feats * torch.from_numpy(cot_f)).sum().backward()
        return tt.grad.numpy()

    got, want = tgrad("bfloat16"), jgrad("bfloat16")
    _close_but_flips(got, want, rtol=1e-4, atol_frac=1e-5)
    hashed = slice(tspec.offsets[tspec.dense_prefix if dense else 0], None)
    with pytest.raises(AssertionError):
        _close_but_flips(got[:, hashed], jgrad(None)[:, hashed], rtol=1e-4,
                         atol_frac=1e-5)
    if dense:  # the dense levels take K2 either way
        np.testing.assert_array_equal(
            got[:, :tspec.offsets[tspec.dense_prefix]],
            tgrad(None)[:, :tspec.offsets[tspec.dense_prefix]])


def test_encode_rejects_an_unknown_bwd_value_dtype():
    _, tspec = _grid()
    table = torch.zeros((4, tspec.table_rows), requires_grad=True)
    x01 = torch.full((3, 6, 5), 0.5)
    for bad in ("float16", "bf16", torch.bfloat16):
        with pytest.raises(ValueError):
            thash.encode_hex_cm(x01, None, table, tspec, bwd_value_dtype=bad)


@pytest.mark.parametrize("name", ["gather", "scatter", "scatter_chunked"])
def test_build_lists_the_headers_each_source_includes(name):
    """A library is rebuilt when a header its source includes changes, and
    only then: build.HEADERS names exactly the quoted includes."""
    import re

    from ucnerf_tpu_torch.ops import build

    assert name in build.SOURCES
    text = (build.CSRC / f"{name}.cu").read_text()
    included = set(re.findall(r'^#include "([^"]+)"', text, flags=re.M))
    assert included == set(build.HEADERS.get(name, ()))
