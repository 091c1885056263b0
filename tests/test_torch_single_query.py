"""The flagship preset's encoder, single-query hex lookups
(``hex_single_query``: one lookup per sample at the mean of its 6 hex
points), through the port's training step against the JAX package, on the
CPU, and why its table gradients miss the step's tolerance in a few
entries.

The step: test_torch_train.py's tiny case (2^16-row hash maps, the dense
levels' per-sample backward K2) with ``hex_single_query`` on both fields,
with the f32 and with the bf16 backward, the JAX side through the Pallas
scatters in interpret mode.  Losses and every non-table gradient hold the
step's tolerance (rtol 1e-4; atol 1e-5 x max|grad|), the tables
test_torch_train.py's dense-level rule (``_table_misses``: at most 0.05 %
of the entries off, each by at most 2^-8 x max|grad|).  Measured: 40 of
the NeRF table's 687,744 entries miss the step's tolerance with the f32
backward (by up to 1.6e-3 x max|grad|), 59 with the bf16 backward, and
one of the proposal table's.

The mechanism, held sample by sample:
- the hex mean is a 6-term sum, which XLA and torch add in other orders:
  the two sides' single-query points differ by up to 6 ulps (at most 8
  held here);
- the dense levels' table gradient forms the corner weights from the
  fractional coords rounded to bf16 (K2, and the Pallas kernel it ports),
  so a frac at a rounding midpoint takes the adjacent bf16 value on one
  side: a step of 2^-8 of a corner weight.  Every missed entry of the
  dense levels is a corner row of such a sample (a frac near 0, whose bf16
  spacing is finer than the points' difference, may move by a few bf16
  steps; none of those samples' rows misses);
- with the bf16 backward each hashed-level update ``w * g`` is rounded
  once to bf16; an update within 5 % of a bf16 step of a rounding midpoint
  on the port's side can round the other way on the JAX side.  Every
  missed hashed-level entry is off by one bf16 step of such an update of
  its row and channel.  The f32 backward misses no hashed-level entry.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.ops import scatter as tscatter
from ucnerf_tpu_torch.train import step as tstep

import test_torch_grad_draws as tgd
import test_torch_train as tt

torch.set_num_threads(2)

SQ = {"hex_single_query": True}
# How far apart the two sides' hex means may lie, in ulps of the larger.
MEAN_ULPS = 8
# How near a bf16 rounding midpoint, in bf16 steps, a port-side update
# must lie to round the other way on the JAX side.
MIDPOINT_STEPS = 0.05


def _sq_case(value_dtype):
    """``tt._step_case`` with single-query lookups, recording both sides'
    single-query points (JAX's from inside its jitted gradient) and, on the
    port's side, the bf16 backward's updates as its fused K3 entry receives
    them."""
    rec_j, rec_t, packed = [], [], []
    encode_j, encode_t = jhash.encode_hex_cm, thash.encode_hex_cm
    packed_entry = tscatter.scatter_add_wsum_packed_cm

    def record_j(x01, *args, **kwargs):
        jax.debug.callback(lambda v: rec_j.append(np.asarray(v)), x01)
        return encode_j(x01, *args, **kwargs)

    def record_t(x01, *args, **kwargs):
        rec_t.append(x01.detach().numpy().copy())
        return encode_t(x01, *args, **kwargs)

    def record_packed(g, w, keys, num_rows, out=None):
        packed.append((tscatter._wsum_values(g, w).detach().clone(),
                       keys.clone(), num_rows))
        return packed_entry(g, w, keys, num_rows, out=out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "encode_hex_cm", record_j)
        mp.setattr(thash, "encode_hex_cm", record_t)
        mp.setattr(tscatter, "scatter_add_wsum_packed_cm", record_packed)
        case = tt._step_case(value_dtype, **SQ)
    model = tstep.init_model(case["cfg"], seed=0, device="cpu")
    # The JAX model's init traces each field once more, at other shapes.
    by_shape = {r.shape: r for r in rec_j}
    case["fields"] = {
        f"{name}/table": (module.grid_spec, by_shape[x.shape], x)
        for (name, module), x in zip(
            (("prop_mlp_0", model.prop_mlp_0), ("nerf_mlp", model.nerf_mlp)),
            rec_t)}
    case["packed"] = {rows: (values, keys) for values, keys, rows in packed}
    case["value_dtype"] = value_dtype
    return case


@pytest.fixture(scope="module")
def sq_f32():
    return _sq_case(None)


@pytest.fixture(scope="module")
def sq_bf16():
    return _sq_case("bfloat16")


@pytest.fixture(params=["f32", "bf16"])
def sq_case(request):
    return request.getfixturevalue(f"sq_{request.param}")


def test_single_query_step_matches_jax(sq_case):
    cfg = sq_case["cfg"]
    assert cfg.nerf_mlp.hex_single_query and cfg.prop_mlp.hex_single_query
    tt._check_losses(sq_case)
    want = dict(tt._leaves(sq_case["grads_j"]))
    got = dict(tt._leaves(sq_case["grads_t"]))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        if name.endswith("table"):
            assert tt._table_misses(g, w) <= 5e-4, name
        else:
            assert not tgd._misses(g, w, False).any(), name


def _bf16_bits(frac):
    return frac.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int32)


def _dense_flips(spec, x_j, x_t):
    """Rows of the dense levels' samples whose bf16 frac took the adjacent
    value on the other side; every other move of a bf16 frac is held to a
    frac near 0 (below 2^-8), by no more than the f32 fracs' own difference
    and a bf16 step."""
    adjacent = set()
    for level in range(spec.dense_prefix):
        rows_j, frac_j = tgd._corner_rows(spec, x_j, level)
        rows_t, frac_t = tgd._corner_rows(spec, x_t, level)
        assert (rows_j == rows_t).all(), "a sample changed cells"
        bits_j, bits_t = _bf16_bits(frac_j), _bf16_bits(frac_t)
        moved = np.abs(bits_j - bits_t)  # [3, 1, M]
        far = moved > 1
        if far.any():
            f_j, f_t = frac_j.numpy()[far], frac_t.numpy()[far]
            b_j = frac_j.to(torch.bfloat16).float().numpy()[far]
            b_t = frac_t.to(torch.bfloat16).float().numpy()[far]
            assert (np.maximum(f_j, f_t) < 2.0**-8).all()
            step = 2.0 ** (np.floor(np.log2(np.maximum(f_j, f_t))) - 7)
            assert (np.abs(b_j - b_t) <= np.abs(f_j - f_t) + step).all()
        for h, m in zip(*np.nonzero((moved == 1).any(axis=0))):
            adjacent.update(rows_t[:, h, m].tolist())
    return adjacent


def _bf16_step(v):
    """The spacing of bf16 values at |v| (v a normal float)."""
    return 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)


def test_single_query_misses_are_bf16_flips(sq_case):
    grads_t, grads_j = (dict(tt._leaves(sq_case[k]))
                        for k in ("grads_t", "grads_j"))
    bf16 = sq_case["value_dtype"] == "bfloat16"
    for name, (spec, x_j, x_t) in sq_case["fields"].items():
        assert x_t.shape == x_j.shape == (3, 1, x_t.shape[2])
        ulps = np.abs(x_j - x_t) / np.spacing(np.maximum(np.abs(x_j),
                                                         np.abs(x_t)))
        assert ulps.max() <= MEAN_ULPS, name

        got, want = grads_t[name], grads_j[name]
        miss = tgd._misses(got, want, True)
        lo = spec.offsets[spec.dense_prefix]
        assert spec.dense_prefix >= 1
        dense_missed = set(np.nonzero(miss[:, :lo])[1].tolist())
        assert dense_missed <= _dense_flips(spec, x_j, x_t), name
        if name == "nerf_mlp/table":
            assert dense_missed, "the draw no longer exercises a flip"

        hashed = list(zip(*np.nonzero(miss[:, lo:])))
        if not bf16:
            assert not hashed, name
            continue
        values, keys = sq_case["packed"][spec.table_rows - lo]
        for ch, row in hashed:
            v = values[ch, keys == row].double().numpy()
            step = _bf16_step(v)
            to_mid = np.abs(v / step - np.floor(v / step) - 0.5)
            err = abs(float(got[ch, lo + row]) - float(want[ch, lo + row]))
            tol = 1e-4 * abs(float(want[ch, lo + row])) + 2e-5 * float(
                np.abs(want).max())
            assert ((to_mid <= MIDPOINT_STEPS)
                    & (np.abs(err - step) <= tol)).any(), (name, ch, row)


def test_waymo_tpu_preset_matches_jax():
    """The port's flagship preset is the JAX package's, field for field:
    ``waymo()`` with 15 microbatches and single-query lookups on both
    fields.  ``host_microbatches=False`` (the JAX step's in-graph scan) is
    ignored by the port, which always runs its microbatches in one Python
    loop (``train/step.py``)."""
    flat = {}
    for lib in (tconfigs, jconfigs):
        tpu, base = (dataclasses.asdict(f()) for f in (lib.waymo_tpu,
                                                       lib.waymo))
        flat[lib] = tpu
        diff = {k: v for k, v in tpu.items() if v != base[k]}
        for mlp in ("nerf_mlp", "prop_mlp"):
            diff[mlp] = {k: v for k, v in tpu[mlp].items()
                         if v != base[mlp][k]}
        assert diff == {"microbatches": 15,
                        "nerf_mlp": {"hex_single_query": True},
                        "prop_mlp": {"hex_single_query": True}}
        assert tpu["host_microbatches"] is False
        for mlp in ("nerf_mlp", "prop_mlp"):
            assert tpu[mlp]["grid_bwd_dense_sample"]
            assert tpu[mlp]["disable_density_normals"]
        assert tpu["prop_mlp"]["disable_rgb"]
        assert tpu["batch_size"] % tpu["microbatches"] == 0
    assert flat[tconfigs] == flat[jconfigs]


def test_fifteen_microbatches_accumulate_the_full_batch_gradient(sq_f32,
                                                                monkeypatch):
    """The flagship's 15 microbatches, on 45 rays (3 a microbatch) of the
    single-query step, give the one-microbatch gradient: the loss and every
    leaf at rtol 1e-5 and an atol of 1e-5 x max|grad|, but a few entries of
    the tables' dense levels (16 of the NeRF table's, measured).  There the
    products of 3-ray microbatches round otherwise than those of 45 rays,
    the sample positions move by ulps, and a frac takes the adjacent bf16
    value: every such entry is a corner row of such a sample, as against
    JAX, and the tables hold the dense-level rule."""
    rng = np.random.default_rng(15)
    cfg = sq_f32["cfg"]
    batch = tt._batch(cfg, rng, rays=45)
    rand_vec = rng.normal(size=(45, 3)).astype(np.float32)
    args = (cfg, sq_f32["params"], batch, rand_vec)
    encode = thash.encode_hex_cm
    points = []

    def record(x01, *a, **kw):
        points.append(x01.detach().numpy().copy())
        return encode(x01, *a, **kw)

    monkeypatch.setattr(thash, "encode_hex_cm", record)
    runs = []
    for micro in (15, 1):
        step = tt.port_step(*args, micro)
        # The proposal field encodes first in every microbatch.
        runs.append((step, {
            f"{name}/table": np.concatenate(points[i::2], axis=2)
            for i, name in enumerate(("prop_mlp_0", "nerf_mlp"))}))
        points.clear()
    ((got, loss), x_15), ((want, loss_1), x_1) = runs
    np.testing.assert_allclose(loss, loss_1, rtol=1e-5)
    specs = {name: spec for name, (spec, _, _) in sq_f32["fields"].items()}
    for name, w in want.items():
        g = got[name]
        held = np.abs(g - w) <= 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max()
        if name.endswith("table"):
            lo = tt._hashed_from(cfg, name)
            assert held[:, lo:].all(), name
            missed = set(np.nonzero(~held[:, :lo])[1].tolist())
            assert missed <= _dense_flips(specs[name], x_1[name],
                                          x_15[name]), name
            assert tt._table_misses(g, w) <= 5e-4, name
        else:
            assert held.all(), name


def test_eval_step_ignores_the_waymo_tpu_backward_knobs(sq_f32, monkeypatch):
    """With single-query lookups, models built with the dense levels'
    per-sample backward, with the bf16 backward and with neither render
    alike and reach no scatter (the JAX eval step rebuilds its model with
    these knobs off)."""
    cfgs = [tt._train_config(tconfigs, value_dtype,
                             dict(SQ, grid_bwd_dense_sample=dense))
            for value_dtype, dense in ((None, True), ("bfloat16", True),
                                       (None, False))]
    tt.check_eval_ignores_knobs(sq_f32, cfgs, monkeypatch)
