"""The port's CER-MVS depth estimator against the JAX package: the same
numpy inputs through ``ucnerf_tpu.models.mvs`` (JAX on the CPU) and
``ucnerf_tpu_torch.models.mvs`` (torch on the CPU), the weights carried by
``convert``, module by module, then the tiny cascade end to end, its
sequence loss with every parameter gradient, and one ``cli.mvs_train`` step
against optax.

Tolerances:
- geometry, sampling, pyramid, lookup, resize and the fusion: rtol 1e-5,
  atol 1e-6 (the same f32 formulas).  ``projective_transform`` and
  ``reproject`` also invert 3x3 and 4x4 matrices, whose LU differs by an
  ulp or so between the libraries and moves a pixel coordinate by a few
  ulp of the matrix entries: an atol of 2e-4 px (measured: up to 5.5e-5 px
  in the image; 1.4e-3 px at a coordinate of 7.2e3 px, within the rtol);
- the networks (encoders, update block): rtol 1e-4, atol 1e-5 x the
  largest output (convolutions summing 9 x 64 products in another order);
- the tiny cascade (4 GRU iterations over two correlation volumes): its
  disparity and predictions at rtol 1e-4, atol 1e-5 x max|disp| (measured:
  4.4e-6 x max|disp|); the sequence loss at rtol 1e-5 (measured 1.2e-7);
  every parameter gradient at rtol 1e-3 and an atol of 1e-4 x max|grad| of
  its leaf (measured: at most 2.3e-4 x max|grad| where the rtol covers the
  rest), or of 1e-6 x the largest gradient of any leaf where that is
  larger: the biases of the convolutions that an instance norm follows,
  whose gradient is 0 but for rounding (~1e-10 on both sides).  The
  correlation encoders take more.  ``corr_encoder_0`` (a 1x1 conv with
  zero-initialised biases, then a ReLU) reads lookups that are 96 % zeros
  at the crop (the stage-0 slab lies far behind the scene), so 72 % of its
  pre-activations are exactly 0, and the ReLU's gradient where one side
  rounds to +-1e-12 and the other to 0 differs: measured 3.5 % of max|grad|
  for its kernel and bias, held to 5 %, and 4.0e-4 for
  ``corr_encoder_1``, which reads its output, held to 1e-3; with the biases
  moved off zero the two sides agree to 2e-5;
- the optimizer step, on the port's own gradients (the test above holds
  them to JAX's): rtol 1e-5, atol 1e-8 (a ten-thousandth of one Adam step
  of lr 2e-4; torch's Adam divides by sqrt(v) / sqrt(1 - b2^t) where optax
  takes sqrt(v / (1 - b2^t))).
The consistency masks compare thresholds on f32 reprojection errors, so a
pixel within an ulp of a threshold may flip: at most ``MASK_FLIPS`` of them
(measured: 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ucnerf_tpu.models.mvs import corr as jcorr
from ucnerf_tpu.models.mvs import datasets as jdatasets
from ucnerf_tpu.models.mvs import extractor as jextractor
from ucnerf_tpu.models.mvs import pipelines as jpipelines
from ucnerf_tpu.models.mvs import raft as jraft
from ucnerf_tpu.models.mvs import update as jupdate
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.cli import mvs_train
from ucnerf_tpu_torch.models.mvs import corr as tcorr
from ucnerf_tpu_torch.models.mvs import datasets as tdatasets
from ucnerf_tpu_torch.models.mvs import extractor as textractor
from ucnerf_tpu_torch.models.mvs import pipelines as tpipelines
from ucnerf_tpu_torch.models.mvs import update as tupdate

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
GEOM_TOL = dict(rtol=1e-5, atol=2e-4)
MASK_FLIPS = 4
# Gradient leaves held to more than 1e-4 x max|grad| (module docstring).
LEAF_FRAC = {"corr_encoder_0": 5e-2, "corr_encoder_1": 1e-3}
# The training crop of the tiny cascade in these tests.
CROP = (32, 48)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=None, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL),
                               err_msg=err_msg)


def _net_close(got, want, err_msg=""):
    want = np.asarray(want)
    _close(got, want, dict(rtol=1e-4, atol=1e-5 * float(np.abs(want).max())),
           err_msg)


@pytest.fixture(scope="module")
def win():
    return tdatasets.SyntheticMVSWindows(num_views=5)


@pytest.fixture(scope="module")
def dense_win():
    """~15 deg baselines (tests/test_mvs.py's fixture): enough overlap for
    the consistency checks to keep pixels."""
    return tdatasets.SyntheticMVSWindows(
        config=tconfigs.tiny(training_views=24), num_views=4)


def _feature_geometry(win, factor=4):
    """The windows' poses and intrinsics at 1/factor resolution, as
    RAFTMVS hands them to the correlation."""
    intr = win.intrinsics.copy()
    intr[:, :2] /= factor
    return win.poses, intr


def test_synthetic_windows_and_offsets_match_jax_package(win):
    jwin = jdatasets.SyntheticMVSWindows(num_views=5)
    for name in ("images", "poses", "intrinsics", "depths"):
        np.testing.assert_array_equal(getattr(win, name),
                                      getattr(jwin, name), err_msg=name)
    for got, want in zip(win.window(2), jwin.window(2)):
        np.testing.assert_array_equal(got, want)
    for nf in (6, 8, 10):
        np.testing.assert_array_equal(tdatasets.temporal_offsets(nf, 3),
                                      jdatasets.temporal_offsets(nf, 3))


def test_projective_transform_matches_jax(win, rng):
    poses, intr = _feature_geometry(win)
    disps = rng.uniform(0.05, 0.6, (3, 16, 24)).astype(np.float32)
    for src in (1, 3):
        got = tcorr.projective_transform(_t(poses), _t(intr), _t(disps), 0,
                                         src)
        want = jcorr.projective_transform(jnp.asarray(poses),
                                          jnp.asarray(intr),
                                          jnp.asarray(disps), 0, src)
        _close(got, want, GEOM_TOL)


def test_bilinear_sample_matches_jax(rng):
    img = rng.normal(size=(12, 16, 8)).astype(np.float32)
    # Inside, on the border and outside on every side.
    coords = np.stack([rng.uniform(-2, 18, (5, 40)),
                       rng.uniform(-2, 14, (5, 40))], -1).astype(np.float32)
    coords[0, :4] = [[0, 0], [15, 11], [-1, 3], [3.5, 11.5]]
    got = tcorr.bilinear_sample_nhwc(_t(img), _t(coords))
    want = jcorr.bilinear_sample_nhwc(jnp.asarray(img), jnp.asarray(coords))
    _close(got, want)


@pytest.mark.parametrize("chunk", [None, 2 * 16 * 24 * 8])
def test_build_corr_volume_matches_jax(win, rng, monkeypatch, chunk):
    """All hypotheses in one pass, and 2 a pass with a remainder of 1."""
    if chunk is not None:
        monkeypatch.setattr(tcorr, "CORR_CHUNK_ELEMS", chunk)
    poses, intr = _feature_geometry(win)
    fmaps = rng.normal(size=(4, 16, 24, 8)).astype(np.float32)
    disps = (rng.uniform(0.1, 0.4, (1, 16, 24))
             + np.linspace(-0.1, 0.1, 5)[:, None, None]).astype(np.float32)
    got = tcorr.build_corr_volume(_t(fmaps), _t(poses[:4]), _t(intr[:4]),
                                  _t(disps), (1, 2, 3))
    want = jcorr.build_corr_volume(jnp.asarray(fmaps), jnp.asarray(poses[:4]),
                                   jnp.asarray(intr[:4]), jnp.asarray(disps),
                                   (1, 2, 3))
    assert got.shape == (3, 16, 24, 5)
    _close(got, want)


def test_corr_pyramid_and_lookup_match_jax(rng):
    """Values, and the gradient of the volume (the fixed-order gather's
    backward) against JAX's for a random cotangent; the window runs off
    both ends of the hypothesis axis."""
    vol = rng.normal(size=(2, 6, 8, 16)).astype(np.float32)
    disp = rng.uniform(-0.03, 0.05, (6, 8)).astype(np.float32)
    origin = np.full((6, 8), 0.01, np.float32)
    cot = rng.normal(size=(2, 6, 8, 15)).astype(np.float32)

    def jfn(v):
        pyr = jcorr.corr_pyramid(v, num_levels=3)
        return jcorr.lookup(pyr, jnp.asarray(disp), jnp.asarray(origin),
                            0.0025, 16, radius=2)

    want, jgrad = jax.jit(lambda v, c: (jfn(v), jax.vjp(jfn, v)[1](c)[0]))(
        jnp.asarray(vol), jnp.asarray(cot))
    tvol = _t(vol).requires_grad_(True)
    pyr = tcorr.corr_pyramid(tvol, num_levels=3)
    assert [p.shape[-1] for p in pyr] == [16, 8, 4]
    for p, q in zip(pyr, jcorr.corr_pyramid(jnp.asarray(vol), 3)):
        _close(p, q)
    got = tcorr.lookup(pyr, _t(disp), _t(origin), 0.0025, 16, radius=2)
    assert got.shape == (2, 6, 8, 15)
    _close(got, want)
    got.backward(_t(cot))
    _close(tvol.grad, jgrad)


@pytest.mark.parametrize("encoder_type", ["HR", "LR"])
@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_basic_encoder_matches_jax(rng, encoder_type, norm_fn):
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    model = textractor.BasicEncoder(output_dim=16, norm_fn=norm_fn,
                                    encoder_type=encoder_type, seed=3)
    tree = convert.params_to_jax(model.state_dict())
    jmodel = jextractor.BasicEncoder(output_dim=16, norm_fn=norm_fn,
                                     encoder_type=encoder_type)
    want = jmodel.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    factor = 8 if encoder_type == "LR" else 4
    assert got.shape == (2, 32 // factor, 48 // factor, 16)
    _net_close(got, want)


@pytest.mark.parametrize("size", [5, 7])
def test_disp_encoding_matches_jax(rng, size):
    disp = rng.uniform(0, 1, (2, 9, 11, 1)).astype(np.float32)
    got = tupdate.disp_encoding(_t(disp), size)
    want = jupdate.disp_encoding(jnp.asarray(disp), size)
    assert got.shape == (2, 9, 11, size * size)
    _close(got, want, dict(rtol=0, atol=0))


@pytest.mark.parametrize("stage,aggregation", [
    (0, ("mean",)), (1, ("mean",)), (1, ("mean", "max", "std"))])
def test_update_block_matches_jax(rng, stage, aggregation):
    h, w, num, k = 8, 12, 3, 2 * (2 * 2 + 1)
    block = tupdate.UpdateBlock(num_stages=2, dim_net=16, dim_inp=16,
                                num_levels=2, radius=2,
                                aggregation=aggregation, seed=5)
    jblock = jupdate.UpdateBlock(num_stages=2, dim_net=16, dim_inp=16,
                                 num_levels=2, radius=2,
                                 aggregation=aggregation)
    net = np.tanh(rng.normal(size=(h, w, 16))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(h, w, 16)), 0).astype(np.float32)
    disp = rng.uniform(0, 0.02, (h, w)).astype(np.float32)
    corr = rng.normal(size=(num, h, w, k)).astype(np.float32)
    jnet, jdelta = jblock.apply(
        {"params": convert.params_to_jax(block.state_dict())},
        *map(jnp.asarray, (net, inp, disp, corr)), stage)
    with torch.no_grad():
        tnet, tdelta = block(_t(net), _t(inp), _t(disp), _t(corr), stage)
    _net_close(tnet, jnet)
    _net_close(tdelta, jdelta)


@pytest.fixture(scope="module")
def tiny(win):
    """The tiny cascade (the --tiny model of cli.mvs_train) drawn in the
    port, its parameters carried to the JAX model, and a cropped window."""
    model = mvs_train.build_model(tiny=True, seed=0)
    tree = {"params": convert.params_to_jax(model.state_dict())}
    jmodel = jraft.RAFTMVS(**mvs_train.TINY)
    images, poses, intr, _ = win.window(0)
    images = np.ascontiguousarray(images[:, :CROP[0], :CROP[1]])
    gt_depth = win.depths[0][:CROP[0], :CROP[1]]
    gt = np.where(gt_depth > 0, 1.0 / np.maximum(gt_depth, 1e-6), 0.0)
    return dict(model=model, tree=tree, jmodel=jmodel,
                inputs=(images, poses, intr), gt=gt.astype(np.float32))


@pytest.fixture(scope="module")
def jax_loss_and_grads(tiny):
    """JAX's sequence loss, metrics and parameter gradients of the tiny
    cascade on the crop, with its disparity and predictions (no scale)."""
    def loss_fn(p):
        disp, preds = tiny["jmodel"].apply(
            p, *map(jnp.asarray, tiny["inputs"]), return_predictions=True)
        loss, metrics = jpipelines.sequence_loss(
            preds, jnp.asarray(tiny["gt"]), gradual_weight=0.5)
        return loss, (metrics, disp, preds)

    (loss, (metrics, disp, preds)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(tiny["tree"])
    return dict(loss=loss, metrics=metrics, disp=disp, preds=preds,
                grads=grads)


@pytest.mark.parametrize("scale", [None, 2.0])
def test_raft_mvs_forward_matches_jax(tiny, jax_loss_and_grads, scale):
    args = tiny["inputs"]
    if scale is None:
        jdisp = jax_loss_and_grads["disp"]
        jpreds = jax_loss_and_grads["preds"]
    else:
        jdisp, jpreds = jax.jit(lambda p, *a: tiny["jmodel"].apply(
            p, *a, scale=jnp.float32(scale), return_predictions=True))(
                tiny["tree"], *map(jnp.asarray, args))
    with torch.no_grad():
        disp = tiny["model"](*map(_t, args), scale=scale)
        disp2, preds = tiny["model"](*map(_t, args), scale=scale,
                                     return_predictions=True)
    assert disp.shape == (CROP[0] // 4, CROP[1] // 4)
    assert torch.equal(disp, disp2) and len(preds) == len(jpreds) == 4
    _net_close(disp, jdisp)
    for got, want in zip(preds, jpreds):
        _net_close(got, want)


def test_sequence_loss_and_grads_match_jax(tiny, jax_loss_and_grads):
    jloss, jmetrics = (jax_loss_and_grads[k] for k in ("loss", "metrics"))
    model = tiny["model"]
    model.zero_grad(set_to_none=True)
    _, preds = model(*map(_t, tiny["inputs"]), return_predictions=True)
    loss, metrics = tpipelines.sequence_loss(preds, _t(tiny["gt"]),
                                             gradual_weight=0.5)
    loss.backward()
    _close(loss, jloss, dict(rtol=1e-5, atol=0))
    assert set(metrics) == set(jmetrics)
    for key, value in metrics.items():
        _close(value, jmetrics[key], dict(rtol=1e-5, atol=1e-7),
               err_msg=key)
    got = convert.params_to_jax({n: p.grad for n, p in
                                 model.named_parameters()})
    want = jax.tree_util.tree_leaves_with_path(
        jax_loss_and_grads["grads"]["params"])
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    top = max(float(np.abs(w).max()) for _, w in want)
    for path, w in want:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        name = jax.tree_util.keystr(path)
        frac = LEAF_FRAC.get(path[1].key, 1e-4)
        atol = max(frac * float(np.abs(w).max()), 1e-6 * top)
        _close(g, w, dict(rtol=1e-3, atol=atol), err_msg=name)


def test_train_step_matches_optax(tiny, jax_loss_and_grads):
    """One cli.mvs_train step (clip to global norm 1, then Adam) of the
    tiny cascade against optax's chain on the same gradients: the port's
    own, which the test above holds to JAX's (Adam's first step is
    lr x g / (|g| + eps), so a gradient's rounding would flip the step of
    its near-zero entries)."""
    lr = 2e-4
    images, poses, intr = map(_t, tiny["inputs"])
    ref = mvs_train.build_model(tiny=True, seed=0)
    _, preds = ref(images, poses, intr, return_predictions=True)
    loss, _ = tpipelines.sequence_loss(preds, _t(tiny["gt"]),
                                       gradual_weight=0.5)
    loss.backward()
    grads = {"params": convert.params_to_jax(
        {n: p.grad for n, p in ref.named_parameters()})}

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    want = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, tiny["tree"])["params"]

    model = mvs_train.build_model(tiny=True, seed=0)
    step, _ = mvs_train.make_train_step(model, lr, 0.5)
    got_loss, _ = step(images, poses, intr, _t(tiny["gt"]))
    assert float(got_loss) == float(loss.detach())
    _close(got_loss, jax_loss_and_grads["loss"], dict(rtol=1e-5, atol=0))
    got = convert.params_to_jax(model.state_dict())
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        _close(g, w, dict(rtol=1e-5, atol=1e-8),
               err_msg=jax.tree_util.keystr(path))


def test_train_steps_repeat_bitwise_on_the_cpu(tiny):
    """Two runs of 2 cli.mvs_train steps of the full-width cascade from one
    init on the tiny tests' crop, on 4 CPU threads: every parameter and
    Adam moment bitwise equal (``corr.take_rows`` adds each row's updates in
    a fixed order; indexing's own backward does not on several threads)."""
    batch = [_t(a) for a in tiny["inputs"]] + [_t(tiny["gt"])]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = []
        for _ in range(2):
            model = mvs_train.build_model(tiny=False, seed=0)
            step, adam = mvs_train.make_train_step(model, 1e-3, 0.5)
            losses = [float(step(*batch)[0]) for _ in range(2)]
            tensors = {}
            for name, p in model.named_parameters():
                tensors[name] = p.detach().clone()
                for key in ("exp_avg", "exp_avg_sq"):
                    tensors[f"{name}.{key}"] = adam.state[p][key].clone()
            runs.append((losses, tensors))
    finally:
        torch.set_num_threads(threads)
    (la, ta), (lb, tb) = runs
    assert la == lb
    assert [n for n in ta if not torch.equal(ta[n], tb[n])] == []


@pytest.mark.parametrize("src_shape,dst_shape,method", [
    ((3, 64, 96, 3), (3, 32, 48, 3), "bilinear"),   # mvs_depth's 0.5 pass
    ((97, 131), (48, 64), "bilinear"),              # odd size, down
    ((16, 24), (64, 96), "bilinear"),               # sequence_loss, up
    ((13, 17), (40, 29), "bilinear"),               # up in one axis only
    ((16, 24), (64, 96), "nearest"),                # mvs_depth's upsample
    ((13, 17), (40, 9), "nearest"),
])
def test_resize_matches_jax_image_resize(rng, src_shape, dst_shape, method):
    x = rng.uniform(0, 255, src_shape).astype(np.float32)
    got = tpipelines.resize(_t(x), dst_shape, method)
    want = jax.image.resize(jnp.asarray(x), dst_shape, method)
    assert got.shape == dst_shape
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, dict(rtol=1e-5, atol=255 * 1e-6))


def test_resize_gradient_matches_jax(rng):
    x = rng.normal(size=(8, 12)).astype(np.float32)
    cot = rng.normal(size=(32, 48)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (32, 48), "bilinear"),
                     jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    tpipelines.bilinear_resize(tx, (32, 48)).backward(_t(cot))
    _close(tx.grad, vjp(jnp.asarray(cot))[0])


def test_postprocess_and_multires_match_jax(rng):
    disp = rng.uniform(-0.5, 2.0, (16, 24)).astype(np.float32)
    disp[0, :3] = [0.0, 0.01, -0.0]
    got = tpipelines.postprocess_disp(_t(disp))
    want = jpipelines.postprocess_disp(jnp.asarray(disp))
    _close(got, want, dict(rtol=0, atol=0))
    full = rng.uniform(1, 10, (16, 24)).astype(np.float32)
    half = full * rng.uniform(0.97, 1.03, full.shape).astype(np.float32)
    np.testing.assert_array_equal(tpipelines.multires_fusion(half, full),
                                  jpipelines.multires_fusion(half, full))
    small = rng.uniform(1, 10, (8, 12)).astype(np.float32)
    _close(tpipelines.multires_fusion(small, full),
           jpipelines.multires_fusion(small, full))


def test_reproject_matches_jax(dense_win):
    d, p, k = dense_win.depths, dense_win.poses, dense_win.intrinsics
    got_z, (got_x, got_y) = tpipelines.reproject(
        _t(d[0]), _t(p[0]), _t(p[1]), _t(k[0]), _t(k[1]), _t(d[1]))
    want_z, (want_x, want_y) = jpipelines.reproject(
        *map(jnp.asarray, (d[0], p[0], p[1], k[0], k[1], d[1])))
    valid = (np.asarray(want_z) > 0) & (d[0] > 0)
    assert valid.mean() > 0.2
    for got, want in ((got_z, want_z), (got_x, want_x), (got_y, want_y)):
        _close(got.numpy()[valid], np.asarray(want)[valid], GEOM_TOL)


def test_geometric_consistency_mask_matches_jax(dense_win):
    d, p, k = dense_win.depths, dense_win.poses, dense_win.intrinsics
    src = [(d[i], p[i], k[i]) for i in (1, 2)]
    mask, fused = tpipelines.geometric_consistency_mask(
        _t(d[0]), _t(p[0]), _t(k[0]), [tuple(map(_t, v)) for v in src],
        depth_th=0.02, min_views=1)
    jmask, jfused = jpipelines.geometric_consistency_mask(
        jnp.asarray(d[0]), jnp.asarray(p[0]), jnp.asarray(k[0]),
        [tuple(map(jnp.asarray, v)) for v in src], depth_th=0.02,
        min_views=1)
    assert float(mask.float().mean()) > 0.1
    assert _flips(mask, jmask) <= MASK_FLIPS
    _close(fused, jfused)


def _flips(got, want):
    return int((np.asarray(got) != np.asarray(want)).sum())


def test_dynamic_consistency_masks_match_jax(dense_win):
    d, p, k = dense_win.depths, dense_win.poses, dense_win.intrinsics
    depth_ref = d[0].copy()
    depth_ref[10:20, 20:40] *= 3.0  # an outlier block
    src = [(s, p[i], k[i]) for i, s in zip((1, 2, 3), d[1:4])]
    mask, fused = tpipelines.dynamic_consistency_masks(
        _t(depth_ref), _t(p[0]), _t(k[0]),
        [tuple(map(_t, v)) for v in src], thre=-0.5)
    jmask, jfused = jpipelines.dynamic_consistency_masks(
        jnp.asarray(depth_ref), jnp.asarray(p[0]), jnp.asarray(k[0]),
        [tuple(map(jnp.asarray, v)) for v in src], thre=-0.5)
    assert mask.dtype == torch.bool and 0.05 < float(mask.float().mean())
    assert _flips(mask, jmask) <= MASK_FLIPS
    _close(fused, jfused)


def test_adaptive_fusion_and_point_cloud_match_jax(dense_win):
    d, p, k = dense_win.depths, dense_win.poses, dense_win.intrinsics
    pairs = [(i, [j for j in range(4) if j != i]) for i in range(4)]
    got = tpipelines.adaptive_geometric_fusion(_t(d), p, k, pairs, glb=0.3,
                                               tot_iter=6)
    want = jpipelines.adaptive_geometric_fusion(d, p, k, pairs, glb=0.3,
                                                tot_iter=6)
    assert set(got) == set(want) == {0, 1, 2, 3}
    for ref in want:
        assert got[ref][2] == want[ref][2]
        assert isinstance(got[ref][0], np.ndarray)
        assert _flips(got[ref][0], want[ref][0]) <= MASK_FLIPS
        _close(got[ref][1], want[ref][1])
    images = dense_win.images / 255.0
    # The same masks and depths in: the same numpy arithmetic out.
    xyz, rgb = tpipelines.fused_point_cloud(want, images, p, k)
    jxyz, jrgb = jpipelines.fused_point_cloud(want, images, p, k)
    assert len(xyz) > 50
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)


def test_convert_carries_conv_kernels(rng):
    """A flax conv kernel [kh, kw, in, out] becomes torch's [out, in, kh,
    kw] and back; an asymmetric 3x5 kernel gives the same convolution on
    both sides (transposed taps would not)."""
    import flax.linen as nn

    kernel = rng.normal(size=(3, 5, 2, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    dense = rng.normal(size=(6, 7)).astype(np.float32)
    tree = {"conv": {"kernel": kernel, "bias": bias},
            "dense": {"kernel": dense}}
    sd = convert.params_from_jax(tree)
    assert sd["conv.weight"].shape == (4, 2, 3, 5)
    np.testing.assert_array_equal(sd["conv.weight"][1, 0, 2, 4],
                                  kernel[2, 4, 0, 1])
    assert sd["dense.weight"].shape == (7, 6)
    back = convert.params_to_jax(sd)
    for name in ("conv", "dense"):
        for key, value in tree[name].items():
            np.testing.assert_array_equal(back[name][key], value)

    x = rng.normal(size=(1, 9, 11, 2)).astype(np.float32)
    want = nn.Conv(4, (3, 5), padding=((1, 1), (2, 2))).apply(
        {"params": tree["conv"]}, jnp.asarray(x))
    got = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), sd["conv.weight"], sd["conv.bias"],
        padding=(1, 2)).permute(0, 2, 3, 1)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
