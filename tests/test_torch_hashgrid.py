"""The port's hash-grid encoder (``ucnerf_tpu_torch/ops/hashgrid.py``)
against the JAX package's ``encode_hex_cm``, in exact-hex and single-query
modes, and its table layout against the JAX ``HashGridSpec``.

Tolerance rtol 1e-5, atol 1e-6: both sides gather the same f32 rows and sum
8 weighted corners and 6 hex points in f32, in different orders.  The corner
indices, including the uint32-wrapping prime hash, must agree exactly.  The
table gradient is tested in ``tests/test_torch_scatter.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.ops import hashgrid as thash

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _specs(**kw):
    return jhash.HashGridSpec(**kw), thash.HashGridSpec(**kw)


def _mlp_spec_kwargs(mlp):
    return dict(input_dim=3, num_levels=mlp.grid_num_levels,
                level_dim=mlp.grid_level_dim,
                base_resolution=mlp.grid_base_resolution,
                desired_resolution=mlp.grid_desired_resolution,
                log2_hashmap_size=mlp.grid_log2_hashmap_size,
                init_std=mlp.grid_init_std)


@pytest.mark.parametrize("grid,rows", [("prop", 6_606_952),
                                       ("nerf", 14_995_560)])
def test_waymo_grid_layout_matches(grid, rows):
    """Offsets, sizes and the dense prefix of both Waymo grids."""
    cfg = tconfigs.waymo()
    mlp = (cfg.prop_mlp.with_grid(cfg.model.prop_desired_grid_size[0])
           if grid == "prop" else cfg.nerf_mlp)
    jspec, tspec = _specs(**_mlp_spec_kwargs(mlp))
    assert tspec.table_rows == jspec.table_rows == rows
    for attr in ("offsets", "level_sizes", "resolutions", "cuda_scales",
                 "cuda_resolutions", "dense_prefix", "dense_strides"):
        assert getattr(tspec, attr) == getattr(jspec, attr), attr
    assert tspec.dense_prefix == 3
    assert tspec.level_sizes[:3] == (4920, 35944, 274632)
    assert all(s == 2**21 for s in tspec.level_sizes[3:])


def test_configs_copy_matches():
    for name in ("waymo", "waymo_tpu", "tiny", "synthetic_quality"):
        assert (dataclasses.asdict(getattr(tconfigs, name)())
                == dataclasses.asdict(getattr(jconfigs, name)()))
    binds = ["NerfMLP.hex_single_query = True", "Config.render_subchunks = 3"]
    assert (dataclasses.asdict(tconfigs.parse_bindings(tconfigs.waymo(),
                                                       binds))
            == dataclasses.asdict(jconfigs.parse_bindings(jconfigs.waymo(),
                                                          binds)))


def test_corner_index_wraps_uint32_hash(rng):
    """Corner coordinates up to 2^14: the prime products pass 2^32 and the
    JAX side wraps them in uint32; the port masks int64 to 32 bits."""
    jspec, tspec = _specs(num_levels=6, level_dim=4, base_resolution=16,
                          desired_resolution=16384, log2_hashmap_size=12)
    coords = rng.integers(0, 2**14, (3, 4096))
    coords[:, :4] = [[0, 2**14 - 1, 1, 2**13], [0, 2**14 - 1, 2, 7],
                     [0, 2**14 - 1, 3, 2**14 - 2]]
    for level in range(tspec.num_levels):
        r = tspec.cuda_resolutions[level] + 1
        c = coords % (r + 1)
        want = np.asarray(jhash._corner_index_components(
            jspec, level, *(jnp.asarray(v, jnp.uint32) for v in c)))
        got = thash._corner_index_components(
            tspec, level, *(torch.from_numpy(v) for v in c))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert (got >= 0).all() and (got < tspec.level_sizes[level]).all()


def _inputs(rng, hex_n, m, spec):
    x01 = rng.uniform(-0.05, 1.05, (3, hex_n, m)).astype(np.float32)  # oob
    stds = rng.uniform(0.001, 0.1, (6, m)).astype(np.float32)
    table = rng.normal(0, 1.0, (spec.level_dim, spec.table_rows)).astype(
        np.float32)
    return x01, stds, table


def _encode_both(x01, stds, table, jspec, tspec, bf16=False):
    feats_j, wm_j = jhash.encode_hex_cm(
        jnp.asarray(x01), None if stds is None else jnp.asarray(stds),
        jnp.asarray(table), jspec,
        gather_dtype=jnp.bfloat16 if bf16 else None)
    with torch.no_grad():
        feats_t, wm_t = thash.encode_hex_cm(
            torch.from_numpy(x01),
            None if stds is None else torch.from_numpy(stds),
            torch.from_numpy(table), tspec, gather_bf16=bf16)
    return (feats_t.numpy(), wm_t.numpy()), (np.asarray(feats_j),
                                             np.asarray(wm_j))


GRID = dict(num_levels=6, level_dim=4, base_resolution=8,
            desired_resolution=4096, log2_hashmap_size=11)


@pytest.mark.parametrize("hex_n", [6, 1])
@pytest.mark.parametrize("bf16", [False, True])
def test_encode_hex_cm_matches_jax(rng, hex_n, bf16):
    """Dense and hashed levels, points outside the unit cube, exact-hex
    (hex_n=6) and single-query (hex_n=1) modes, f32 and bf16 gathers."""
    jspec, tspec = _specs(**GRID)
    assert 0 < tspec.dense_prefix < tspec.num_levels
    x01, stds, table = _inputs(rng, hex_n, 700, tspec)
    (ft, wt), (fj, wj) = _encode_both(x01, stds, table, jspec, tspec, bf16)
    assert ft.shape == (tspec.output_dim, 700) and wt.shape == (6, 700)
    np.testing.assert_allclose(ft, fj, **TOL)
    np.testing.assert_allclose(wt, wj, **TOL)
    oob = ((x01 < 0) | (x01 > 1)).any(axis=0).all(axis=0)
    assert oob.any()
    np.testing.assert_array_equal(ft[:, oob], 0.0)


def test_encode_hex_cm_without_stds(rng):
    jspec, tspec = _specs(**GRID)
    x01, _, table = _inputs(rng, 6, 300, tspec)
    (ft, _), (fj, _) = _encode_both(x01, None, table, jspec, tspec)
    np.testing.assert_allclose(ft, fj, **TOL)


def test_encode_hex_cm_matches_pallas_gather(rng, monkeypatch):
    """Once against the JAX encoder running its Pallas gather in
    interpreter mode (the kernel the port's CUDA gather replaces)."""
    monkeypatch.setattr(jhash, "GATHER_IMPL", "pallas_interpret")
    kw = dict(num_levels=4, level_dim=4, base_resolution=8,
              desired_resolution=512, log2_hashmap_size=10)
    jspec, tspec = _specs(**kw)
    x01, stds, table = _inputs(rng, 6, 128, tspec)
    (ft, wt), (fj, wj) = _encode_both(x01, stds, table, jspec, tspec)
    np.testing.assert_allclose(ft, fj, rtol=3e-5, atol=2e-5)
    np.testing.assert_allclose(wt, wj, **TOL)


def test_init_table_and_table_grad_raises():
    spec = thash.HashGridSpec(**GRID)
    gen = torch.Generator().manual_seed(0)
    table = thash.init_table(spec, gen)
    assert table.shape == (spec.level_dim, spec.table_rows)
    assert table.abs().max() <= spec.init_std
    table.requires_grad_()
    x01 = torch.rand((3, 6, 16), generator=gen)
    # The table gradient runs K1/K2, or K3 for the bf16-packed backward;
    # any other value of the knob raises.
    with pytest.raises(ValueError):
        thash.encode_hex_cm(x01, None, table, spec,
                            bwd_value_dtype="float16")
    thash.encode_hex_cm(x01, None, table, spec)[0].sum().backward()
    assert table.grad.shape == table.shape and table.grad.abs().max() > 0
    f32_grad, table.grad = table.grad, None
    thash.encode_hex_cm(x01, None, table, spec,
                        bwd_value_dtype="bfloat16")[0].sum().backward()
    # One bf16 rounding per update: 2^-9 relative at most per term.
    assert not torch.equal(table.grad, f32_grad)
    assert (table.grad - f32_grad).abs().max() <= (
        2.0**-8 * f32_grad.abs().max())
    with torch.no_grad():  # the render path ignores the backward knobs
        thash.encode_hex_cm(x01, None, table, spec,
                            bwd_value_dtype="bfloat16")
