"""Why the tiny training step's gradients miss the JAX package's on some
draws (the ROADMAP's Queue C item 4), on the CPU.

The cases: numpy seed 11 and no sky NeRF, the plain f32 step (with camera
refinement at zero deltas the step is the same: measured equal), the JAX
side through the Pallas scatters in interpret mode, on two draws:
test_torch_train.py's (the parameters before the batch) and
test_torch_cam_refine.py's (the batch first), the ROADMAP's case.  The
forward agrees to ulps (every level's sdist, weights and density within
8.3e-7), yet on the first draw 16 of the NeRF table's 687,744 gradient
entries miss the step's tolerance by up to 1.1e-4 x max|grad|, and on the
second 304 entries by up to 2.5e-3, with 15 entries of
``density_hidden.weight`` and one of its bias by up to 2.0e-3.  Two causes,
neither a port fault:

- The sample positions differ by an ulp between XLA and torch (the
  proposal resampling sums in another order).  The dense levels' table
  gradient (K2, and the Pallas kernel it ports) builds the corner weights
  from the fractional coords rounded to bf16, and a frac that sits at a
  rounding midpoint rounds to the adjacent bf16 value on the other side:
  one bf16 step of a corner weight.  The JAX package's own two backward
  routes differ by more (the XLA route does not round: 4,404 and 2,578
  entries).  All of the first draw's misses are these.
- On the second draw, one NeRF sample's pre-activation of one ``density_hidden`` unit is
  within rounding of 0 (6.3e-7 in JAX, -3.0e-7 in the port, for a unit
  whose values reach 0.43), so the ReLU passes the gradient on one side
  only: that unit's kernel column and bias, and that sample's table rows,
  take all of its contribution on one side and none on the other.

Held here: every missed table entry is a corner row of a sample whose bf16
frac flipped to the adjacent value (in the same cell) or of the kinked
sample; the ``density_hidden`` misses are the kinked unit's; the tables pass
test_torch_train.py's dense-level rule (``_table_misses``: at most 0.05 %
of the entries off, each by at most 2^-8 x max|grad|) and every other
entry and leaf the step's tolerance (rtol 1e-4, atol 1e-5 x max|grad|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.train import step as tstep

import test_torch_field_options as tfo
import test_torch_train as tt

torch.set_num_threads(2)


def _misses(got, want, table):
    scale = float(np.abs(want).max())
    return np.abs(got - want) > 1e-4 * np.abs(want) + (
        2e-5 if table else 1e-5) * scale


@pytest.fixture(scope="module", params=["params_first", "batch_first"])
def seed11(request):
    cfg_j, cfg_t = (tt._train_config(lib, model_sky=False)
                    for lib in (jconfigs, tconfigs))
    case = tfo.run_step(cfg_j, cfg_t, seed=11, impl="pallas_interpret",
                       params_first=request.param == "params_first")
    case["draw"] = request.param
    batch = jax.tree.map(jnp.asarray, case["batch"])

    # Both sides' NeRF-level positions and density_hidden pre-activations.
    rec_j = []
    encode = jhash.encode_hex_cm

    def record(x01, *args, **kwargs):
        jax.debug.callback(lambda v: rec_j.append(np.asarray(v)), x01)
        return encode(x01, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "encode_hex_cm", record)
        _, inter = case["model_j"].apply(
            {"params": case["params"]}, None, batch, 0.5,
            compute_extras=False, train=True, capture_intermediates=True,
            mutable=["intermediates"])
    h_j = np.asarray(inter["intermediates"]["nerf_mlp"]["density_hidden"]
                     ["__call__"][0])
    model = tstep.init_model(cfg_t, seed=0, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, case["params"])), strict=True)
    rec_t, h_t = [], []
    encode_t = thash.encode_hex_cm

    def record_t(x01, *args, **kwargs):
        rec_t.append(x01.detach().numpy().copy())
        return encode_t(x01, *args, **kwargs)

    hook = model.nerf_mlp.density_hidden.register_forward_hook(
        lambda m, i, o: h_t.append(o.detach().numpy().copy()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thash, "encode_hex_cm", record_t)
        model({k: tt._t(v) for k, v in case["batch"].items()}, 0.5,
              tt._t(case["rand_vec"]), train=True)
    hook.remove()
    # The NeRF field is the last level.
    case.update(x01_j=rec_j[-1], x01_t=rec_t[-1], h_j=h_j, h_t=h_t[0],
                spec=model.nerf_mlp.grid_spec)
    return case


def _corner_rows(spec, x01, level):
    xs = torch.from_numpy(np.clip(x01, 0, 1))
    idx, _, frac = thash._level_corners(spec, level, xs)
    return idx.numpy() + spec.offsets[level], frac


def test_seed11_misses_are_bf16_frac_flips_and_a_relu_kink(seed11):
    spec = seed11["spec"]
    name = "nerf_mlp/table"
    missed = set(np.nonzero(_misses(seed11["grads_t"][name],
                                    seed11["grads_j"][name], True))[1]
                 .tolist())
    assert len(missed) > 0

    # The dense levels' samples whose bf16-rounded fracs differ.
    flipped = set()
    assert spec.dense_prefix >= 1
    for level in range(spec.dense_prefix):
        rows_j, frac_j = _corner_rows(spec, seed11["x01_j"], level)
        rows_t, frac_t = _corner_rows(spec, seed11["x01_t"], level)
        assert (rows_j == rows_t).all(), "a sample changed cells"
        bits_j, bits_t = (f.to(torch.bfloat16).view(torch.int16).numpy()
                          .astype(np.int32) for f in (frac_j, frac_t))
        differ = bits_j != bits_t  # [3, H, M]
        assert (np.abs(bits_j - bits_t)[differ] == 1).all()
        for h, m in zip(*np.nonzero(differ.any(axis=0))):
            flipped.update(rows_t[:, h, m].tolist())

    # The samples whose density_hidden pre-activation has another sign.
    h_j, h_t = seed11["h_j"], seed11["h_t"]
    units, samples = np.nonzero((h_j > 0) != (h_t > 0))  # [units, M]
    for u, m in zip(units, samples):
        assert max(abs(h_j[u, m]), abs(h_t[u, m])) < 1e-5 * np.abs(
            h_j[u]).max()
    kinked = set()
    for level in range(spec.num_levels):
        rows, _ = _corner_rows(spec, seed11["x01_t"], level)
        for m in samples:
            kinked.update(rows[:, :, m].reshape(-1).tolist())

    assert missed <= flipped | kinked
    if seed11["draw"] == "params_first":
        assert not len(samples) and missed <= flipped
    else:
        assert len(samples) == 1 and missed & kinked

    for leaf, axis in (("kernel", 1), ("bias", 0)):
        name = f"nerf_mlp/density_hidden/{leaf}"
        bad = np.nonzero(_misses(seed11["grads_t"][name],
                                 seed11["grads_j"][name], False))[axis]
        assert set(bad.tolist()) <= set(units.tolist()), name
        assert len(bad) == (seed11["draw"] == "batch_first") * (
            15 if leaf == "kernel" else 1), name


def test_seed11_step_holds_the_dense_level_rule(seed11):
    units = np.unique(np.nonzero((seed11["h_j"] > 0)
                                 != (seed11["h_t"] > 0))[0])
    for name, g in seed11["grads_t"].items():
        w = seed11["grads_j"][name]
        if name.endswith("table"):
            assert tt._table_misses(g, w) <= 5e-4, name
            continue
        if name == "nerf_mlp/density_hidden/kernel":
            keep = np.setdiff1d(np.arange(w.shape[1]), units)
            g, w = g[:, keep], w[:, keep]
        elif name == "nerf_mlp/density_hidden/bias":
            keep = np.setdiff1d(np.arange(w.shape[0]), units)
            g, w = g[keep], w[keep]
        assert not _misses(g, w, False).any(), name
    for k, v in seed11["stats"]["losses"].items():
        np.testing.assert_allclose(float(v), float(seed11["losses_j"][k]),
                                   rtol=1e-4, err_msg=k)
