"""The port's camera-refinement experiment
(``ucnerf_tpu_torch/tools/cam_refine_quality.py``) against the JAX
package's ``tools/cam_refine_quality.py``, loaded from its file, on the
CPU.

- ``_rigid`` and ``_perturb``: equal arrays.
- ``residual_error``: within 1e-9 (degrees and scene units) on the same
  deltas; both evaluate ``so3_exp`` in float32 and the rest in float64.
- The tiny recipe with virtual warping: the datasets each tool sets up
  (camera 1 perturbed before the first batch, so the correspondence pool
  sees the perturbed poses) give bitwise-equal batches, the virtual fifth
  included.
- The composed configuration (camera refinement over two rig slots,
  ``contract_origin_grads``, virtual warping, single-query lookups on both
  fields, the sky NeRF and the brightness correction; test_torch_train.py's
  2^16-row hash maps and dense-level backward) for 3 steps on the tools'
  batch stream, JAX with ``key=None`` and its Pallas scatters in interpret
  mode, its hex basis handed to the port: the losses at rtol 1e-4; the
  camera deltas after the steps at rtol 1e-3 with an atol of 1e-3 x
  max|delta| (Adam's first steps are ~lr x sign(g) for each entry); the
  first step's gradients at test_torch_train.py's step tolerance (rtol
  1e-4, atol 1e-5 x max|grad|) but the columns of a ``density_hidden``
  unit at a ReLU kink (at most KINK_UNITS a field), and the tables by its
  dense-level rule (``_table_misses``).
  JAX's first gradient is read from its Adam first moment after one step
  (mu = (1 - b1) g: one more f32 rounding).  Held sample by sample: every
  table entry that misses the step's tolerance is a corner row of a
  dense-level sample whose bf16-rounded frac took the adjacent value on the
  other side (test_torch_single_query.py's mechanism) or of a sample at a
  ReLU kink (a pre-activation within rounding of 0 whose sign differs
  between the sides: the ReLU passes that sample's gradient on one side
  only, test_torch_grad_draws.py's mechanism); every missed entry of a
  ``density_hidden`` kernel or bias is a kinked unit's.  Measured: one kink,
  the proposal field's unit 34 (-4.0e-7 in JAX, 5.6e-7 in the port, for a
  unit whose values reach 0.62), its kernel column and bias 3.6e-4 x
  max|grad| off; 6 of the proposal table's 425,600 entries off.
- The tool's entry point on the CPU prints the JAX tool's summary keys; its
  default device is cuda, and without a card it raises.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.data import datasets as jdatasets
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.train import state as jstate
from ucnerf_tpu.train import step as jstep
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.data import datasets as tdatasets
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.tools import cam_refine_quality as ttool
from ucnerf_tpu_torch.train import step as tstep

import test_torch_grad_draws as tgd
import test_torch_single_query as tsq
import test_torch_train as tt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_cam_refine_quality",
        os.path.join(ROOT, "tools", "cam_refine_quality.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JTOOL = _load_jax_tool()
# The quality runs' injection: 1 degree, a translation of norm 0.045.
TRANS = [0.03, -0.03, 0.015]
DELTA = JTOOL._rigid(1.0, TRANS)
STEPS = 3
# The fields of the composed configuration (one proposal level).
FIELDS = ("prop_mlp_0", "nerf_mlp")
# At most this many density_hidden units of a field may sit at a ReLU kink
# (a sample's pre-activation within rounding of 0, on other sides).
KINK_UNITS = 2
# How far apart the two sides' single-query points may lie, in ulps of 1
# (the unit cube's coordinates).  test_torch_single_query.py holds its hex
# means to 8 ulps of each point; here the NeRF level's samples come out of
# the proposal resampling over the perturbed and virtual rays, which adds
# in another order on each side (measured: 3.5 ulps of 1, 18 ulps of a
# point near 0.2; the proposal level's 1.5 ulps of 1).
POS_ULPS = 4


@pytest.mark.parametrize("rot_deg,trans", [(1.0, TRANS), (0.0, [0, 0, 0]),
                                           (2.5, [0.1, 0.2, -0.05])])
def test_rigid_matches_jax_tool(rot_deg, trans):
    want = JTOOL._rigid(rot_deg, trans)
    got = ttool._rigid(rot_deg, trans)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _tiny(lib, **over):
    """The tools' CPU-scale recipe."""
    return lib.tiny(training_views=12, batch_size=256, **over)


def _jax_datasets(cfg):
    """The datasets the JAX tool's ``run`` sets up."""
    train = jdatasets.load_dataset("train", cfg)
    test = jdatasets.load_dataset("test", cfg)
    for ds in (train, test):
        ds.cam_num = 2
        JTOOL._perturb(ds, DELTA)
    return train, test


@pytest.mark.parametrize("split", ["train", "test"])
def test_perturb_matches_jax_tool(split):
    jd = jdatasets.load_dataset(split, _tiny(jconfigs))
    td = tdatasets.load_dataset(split, _tiny(tconfigs))
    before = td.camtoworlds.copy()
    JTOOL._perturb(jd, DELTA)
    ttool._perturb(td, DELTA)
    np.testing.assert_array_equal(td.camtoworlds, jd.camtoworlds)
    odd = np.arange(td.n_examples) % 2 == 1
    assert not np.array_equal(td.camtoworlds[odd], before[odd])
    np.testing.assert_array_equal(td.camtoworlds[~odd], before[~odd])


def _undo(delta):
    """Camera-1 deltas that undo `delta` (camera 0 at 0)."""
    from scipy.spatial.transform import Rotation

    inv = np.linalg.inv(delta.astype(np.float64))
    xi = np.zeros((2, 6), np.float32)
    xi[1, :3] = Rotation.from_matrix(inv[:3, :3]).as_rotvec()
    xi[1, 3:] = inv[:3, 3]
    return xi


@pytest.mark.parametrize("case", ["zero", "undone", "half"])
def test_residual_error_matches_jax_tool(case):
    """At the injected error (deltas at 0), near 0 (deltas that undo it)
    and between (half of those, both cameras moved)."""
    xi = {"zero": np.zeros((2, 6), np.float32), "undone": _undo(DELTA),
          "half": 0.5 * _undo(DELTA) + np.float32(1e-3)}[case]
    want = JTOOL.residual_error(xi, DELTA)
    got = ttool.residual_error(xi, DELTA)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    if case == "zero":
        np.testing.assert_allclose(got, (1.0, np.linalg.norm(TRANS)),
                                   rtol=1e-6)
    if case == "undone":
        assert got[0] < 1e-5 and got[1] < 1e-6


def test_tool_datasets_give_equal_batches():
    """The train and test datasets each tool sets up, with virtual warping:
    the batch stream's first batches (51 virtual rays of 256, from the
    correspondence pool built on the perturbed poses) and a test image."""
    jtrain, jtest = _jax_datasets(_tiny(jconfigs, virtual_poses=True))
    arm = ttool.setup(_tiny(tconfigs, virtual_poses=True), DELTA, STEPS,
                      optimize=True, origin_grads=True, device="cpu")
    tt_rng, jt_rng = (np.random.default_rng(1234) for _ in range(2))
    for _ in range(2):
        a = arm.train.sample_batch(tt_rng, 256)
        b = jtrain.sample_batch(jt_rng, 256)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pool = arm.train._warp_pool
    assert pool is not None and len(pool["src_cam_idx"]) > 0
    np.testing.assert_array_equal(pool["ref_idx"], jtrain._warp_pool[
        "ref_idx"])
    # The virtual fifth, not the fall-back to real rays: its rays leave
    # virtual cameras' centres, some of them away from every real one.
    def dist(origins, poses):
        return np.abs(origins[:, None] - poses[None, :, :3, 3]).max(
            -1).min(-1)

    virtual = a["origins"][256 - 51:]
    assert dist(virtual, arm.train.virtual_poses).max() < 1e-5
    assert dist(virtual, arm.train.camtoworlds).max() > 1e-3
    assert dist(a["origins"][:256 - 51], arm.train.camtoworlds).max() < 1e-5
    assert arm.test.n_examples == jtest.n_examples
    for i in range(arm.test.n_examples):
        a, b = arm.test.image_batch(i), jtest.image_batch(i)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _composed(lib):
    """The composed configuration at the tools' tiny size."""
    cfg = tt._train_config(lib, mlp_over={"hex_single_query": True},
                           training_views=12, batch_size=256,
                           virtual_poses=True, lr_delay_steps=0)
    assert cfg.model_sky and cfg.brightness_correction
    return cfg


def _adam_mu(opt_state):
    """The first moment of the Adam state in an optax chain's state."""
    for s in opt_state:
        if hasattr(s, "mu"):
            return s.mu
    raise AssertionError("no Adam state in the chain")


@pytest.fixture(scope="module")
def composed():
    """3 steps of the composed configuration on both sides, the same
    weights (JAX's init with its tables and zero-initialised leaves
    randomized), batches and hex basis; the NeRF and proposal fields'
    single-query points of the first step recorded on both sides."""
    rng = np.random.default_rng(13)
    cfg_j = dataclasses.replace(
        _composed(jconfigs), optimize_cameras=True, num_phys_cams=2,
        max_steps=STEPS, contract_origin_grads=True)
    jtrain, _ = _jax_datasets(cfg_j)
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, tt._randomize(params, rng))
    state_j = jstate.create_train_state(cfg_j, params)
    rand_vec = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (cfg_j.batch_size, 3), jnp.float32))

    rec_j, rec_t = [], []
    encode_j, encode_t = jhash.encode_hex_cm, thash.encode_hex_cm

    def record_j(x01, *args, **kwargs):
        jax.debug.callback(lambda v: rec_j.append(np.asarray(v)), x01)
        return encode_j(x01, *args, **kwargs)

    def record_t(x01, *args, **kwargs):
        rec_t.append(x01.detach().numpy().copy())
        return encode_t(x01, *args, **kwargs)

    losses_j, mu = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
        mp.setattr(jhash, "encode_hex_cm", record_j)
        step_j = jstep.make_train_step(model_j, cfg_j)
        data_rng = np.random.default_rng(1234)
        for step in range(1, STEPS + 1):
            batch = jax.tree.map(jnp.asarray,
                                 jtrain.sample_batch(data_rng, 256))
            frac = np.clip((step - 1) / max(STEPS - 1, 1), 0, 1)
            state_j, stats = step_j(state_j, batch, None, jnp.float32(frac))
            losses_j.append(float(stats["loss"]))
            if step == 1:
                first_batch, first_j = batch, list(rec_j)
                mu = jax.tree.map(np.asarray, _adam_mu(state_j.opt_state))
    b1 = cfg_j.adam_beta1
    grads_j = jax.tree.map(lambda m: m / np.float32(1 - b1), mu)
    # The fields' density_hidden pre-activations of the first step's
    # forward.
    _, inter = jax.jit(lambda p, b: model_j.apply(
        {"params": p}, None, b, jnp.float32(0.0), compute_extras=False,
        train=True, capture_intermediates=True,
        mutable=["intermediates"]))(params, first_batch)
    h_j = {f: np.asarray(inter["intermediates"][f]["density_hidden"]
                         ["__call__"][0]) for f in FIELDS}

    arm = ttool.setup(_composed(tconfigs), DELTA, STEPS, optimize=True,
                      origin_grads=True, device="cpu")
    arm.model.load_state_dict(convert.params_from_jax(params), strict=True)
    losses_t, grads_t, h_t = [], {}, {}

    def record_h(field):
        def hook(module, inputs, out):
            h_t.setdefault(field, out.detach().numpy().copy())
        return hook

    hooks = [getattr(arm.model, f).density_hidden.register_forward_hook(
        record_h(f)) for f in FIELDS]
    make = tstep.make_train_step

    def make_recording(model, cfg, group=None):
        inner = make(model, cfg, group)

        def train_step(state, batch, frac, **kwargs):
            state, stats = inner(state, batch, frac, **kwargs)
            losses_t.append(float(stats["loss"]))
            if not grads_t:  # the update leaves the gradients in place
                grads_t.update(convert.params_to_jax(
                    {k: p.grad.clone() for k, p in model.named_parameters()}))
            return state, stats
        return train_step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thash, "encode_hex_cm", record_t)
        mp.setattr(tstep, "make_train_step", make_recording)
        ttool.train(arm, STEPS,
                    draws=lambda step, batch: {"rand_vec": tt._t(rand_vec)})
    for hook in hooks:
        hook.remove()

    # The JAX model's init traces each field once more, at other shapes;
    # the first step's records are the last ones of their shapes.
    by_shape = {r.shape: r for r in first_j}
    fields = {f"{name}/table": (module.grid_spec, by_shape[x.shape], x)
              for (name, module), x in zip(
                  (("prop_mlp_0", arm.model.prop_mlp_0),
                   ("nerf_mlp", arm.model.nerf_mlp)), rec_t[:2])}
    return dict(cfg=arm.cfg, losses_j=losses_j, losses_t=losses_t,
                deltas_j=np.asarray(state_j.params["cam_refine"][
                    "se3_deltas"]),
                deltas_t=ttool.se3_deltas(arm),
                grads_j=grads_j, grads_t=grads_t, fields=fields, h_j=h_j,
                h_t=h_t)


def test_composed_steps_match_jax(composed):
    cfg = composed["cfg"]
    assert (cfg.optimize_cameras and cfg.contract_origin_grads
            and cfg.virtual_poses and cfg.num_phys_cams == 2
            and cfg.nerf_mlp.hex_single_query
            and cfg.prop_mlp.hex_single_query)
    np.testing.assert_allclose(composed["losses_t"], composed["losses_j"],
                               rtol=1e-4)
    assert len(composed["losses_t"]) == STEPS
    want, got = composed["deltas_j"], composed["deltas_t"]
    assert np.abs(want).max() > 0 and np.abs(want[:, 3:]).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def _kinks(composed, field):
    """(units, samples) of `field`'s density_hidden whose pre-activation
    has another sign on the two sides, each within rounding of 0 (below
    1e-5 x the unit's largest |value|)."""
    h_j, h_t = composed["h_j"][field], composed["h_t"][field]
    assert h_j.shape == h_t.shape and h_j.shape[0] == 64
    units, samples = np.nonzero((h_j > 0) != (h_t > 0))  # [units, M]
    for u, m in zip(units, samples):
        assert max(abs(h_j[u, m]), abs(h_t[u, m])) < 1e-5 * np.abs(
            h_j[u]).max(), (field, u, m)
    assert len(set(units.tolist())) <= KINK_UNITS, field
    return units, samples


def _kept(name, g, w, composed):
    """A density_hidden leaf without its kinked units' columns."""
    field, _, leaf = name.partition("/")
    if not leaf.startswith("density_hidden/"):
        return g, w
    keep = np.setdiff1d(np.arange(w.shape[-1]),
                        _kinks(composed, field)[0])
    return g[..., keep], w[..., keep]


def test_composed_first_gradients_match_jax(composed):
    """The first step's gradients: every leaf at the step's tolerance but
    the kinked units of a density_hidden layer; the tables by the
    dense-level rule."""
    want = dict(tt._leaves(composed["grads_j"]))
    got = dict(tt._leaves(composed["grads_t"]))
    assert set(got) == set(want) and "cam_refine/se3_deltas" in got
    for name, g in got.items():
        w = want[name]
        assert float(np.abs(w).max()) > 0, name
        if name.endswith("table"):
            assert tt._table_misses(g, w) <= 5e-4, name
        else:
            assert not tgd._misses(*_kept(name, g, w, composed),
                                   False).any(), name
    d = got["cam_refine/se3_deltas"]
    assert np.abs(d[:, 3:]).min() > 0  # translations learnable


def test_composed_misses_are_bf16_flips_and_relu_kinks(composed):
    """Sample by sample: the two sides' single-query points lie within
    POS_ULPS ulps of 1; every table entry that misses the step's tolerance is a
    dense level's corner row of a sample whose bf16 frac flipped, or a
    corner row of a sample at a ReLU kink; every missed density_hidden
    entry is a kinked unit's.  The draw holds a kink (the proposal field's
    unit 34 at the time of writing)."""
    grads_t, grads_j = (dict(tt._leaves(composed[k]))
                        for k in ("grads_t", "grads_j"))
    n_kinks = 0
    for field in FIELDS:
        name = f"{field}/table"
        spec, x_j, x_t = composed["fields"][name]
        assert x_t.shape == x_j.shape == (3, 1, x_t.shape[2])
        assert np.abs(x_j - x_t).max() <= POS_ULPS * np.spacing(
            np.float32(1)), name
        units, samples = _kinks(composed, field)
        n_kinks += len(samples)
        kinked = set()
        for level in range(spec.num_levels):
            rows, _ = tgd._corner_rows(spec, x_t, level)
            for m in samples:
                kinked.update(rows[:, :, m].reshape(-1).tolist())
        missed = set(np.nonzero(tgd._misses(grads_t[name], grads_j[name],
                                            True))[1].tolist())
        assert missed <= tsq._dense_flips(spec, x_j, x_t) | kinked, name
        for leaf, axis in (("kernel", 1), ("bias", 0)):
            key = f"{field}/density_hidden/{leaf}"
            bad = np.nonzero(tgd._misses(grads_t[key], grads_j[key],
                                         False))[axis]
            assert set(bad.tolist()) <= set(units.tolist()), key
    assert n_kinks > 0, "the draw no longer holds a kink"


def test_tool_runs_on_the_cpu(capsys):
    summary = ttool.main(["--device", "cpu", "--steps", "4",
                          "--arms", "off,on_og", "--log-every", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == summary
    assert set(summary) == {
        "injected_rot_deg", "injected_trans", "psnr_off", "psnr_on_og",
        "residual_rot_deg_on_og", "residual_trans_on_og"}
    assert all(np.isfinite(v) for v in summary.values())
    arms = [json.loads(line) for line in out if line.startswith("{")][:-1]
    assert [a["optimize"] for a in arms] == [False, True]
    assert "residual_rot_deg" not in arms[0]
    assert not any(arms[1]["launches"].values())  # plain versions


def test_tool_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttool.main(["--steps", "1"])
