"""The port's pose package (``ucnerf_tpu_torch.pose``) against the JAX
package's (``ucnerf_tpu.pose``) on the same numpy inputs, on the CPU.

Tolerances:
- Harris response bitwise, keypoint lists equal: both sides run the same
  shifted multiply-adds, term by term in one order, and a stable top-k.
- ``patch_descriptors`` within 1e-6: the port reduces each patch in torch
  (mean, norm), the JAX package in numpy (pairwise sum, BLAS dot).
- SuperPoint ``semi`` / ``desc`` at rtol 1e-4, atol 1e-5: cuDNN-free f32
  convolutions summed in other orders by XLA and by torch.
- ``superpoint_scores`` at rtol 1e-6 (8 ulp; 4.3e-7 measured): XLA's and
  torch's softmaxes call different ``exp`` implementations and sum the 65
  terms in other orders, so the heatmaps cannot agree bit for bit; the
  pixel shuffle moves values unchanged.  ``simple_nms`` bitwise on the
  same scores (max and compare only).  SuperPoint keypoints equal.
- Matching: equal sets.  ``epipolar_filter``, ``build_tracks``,
  ``colmap_io``: equal (copies).
- ``rigba``: the port's build of its copy of ``rigba.cc`` (the same code,
  one comment reworded) is bitwise a build of the JAX package's source
  with the JAX package's flags on the machine that runs the test.  The
  committed ``ucnerf_tpu/pose/rigba/librigba.so`` was built with
  ``-march=native`` on another CPU and rounds differently in the last bits, which the LM iterations carry to 2.8e-8 relative in a solve's
  output and 5.8e-9 absolute in ``refine_poses``' ``w2c`` (measured):
  against it, rtol 1e-7 with atol 1e-9, and atol 1e-7.
- ``refine_poses``: ``w2c`` within 1e-9 of the JAX package's with its rig
  BA built where the test runs (bitwise, measured), the same
  ``pose.json``.
"""

import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu.pose import colmap_io as jcio
from ucnerf_tpu.pose import features as jfeat
from ucnerf_tpu.pose import matching as jmatch
from ucnerf_tpu.pose import pipeline as jpipe
from ucnerf_tpu.pose import rigba as jrigba
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.ops import build
from ucnerf_tpu_torch.pose import colmap_io as tcio
from ucnerf_tpu_torch.pose import features as tfeat
from ucnerf_tpu_torch.pose import matching as tmatch
from ucnerf_tpu_torch.pose import pipeline as tpipe
from ucnerf_tpu_torch.pose import rigba as trigba

import test_pose_pipeline as scene
import test_rigba
from test_pose_pipeline import rig_scene  # noqa: F401 (the fixture)

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def perturbed(rig_scene):
    """Camera 1's relative rotation perturbed by 1.2 degrees, as in
    test_pose_pipeline.test_refinement_recovers_relative_rotation."""
    images, w2c_true, intrinsics, num_frames, num_cams, rel_true = rig_scene
    pert = scene._rot_y(1.2)
    w2c_init = w2c_true.copy()
    for s in range(num_frames):
        w2c_init[s * num_cams + 1] = (pert @ rel_true[1]
                                      @ w2c_true[s * num_cams])
    return w2c_init


def test_harris_response_bitwise(rig_scene):
    images = rig_scene[0]
    for img in images[:4]:
        want = np.asarray(jfeat.harris_response(jnp.asarray(img,
                                                            jnp.float32)))
        got = tfeat.harris_response(img, device=CPU).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_keypoints", [300, 1024, 40000])
def test_harris_keypoints_equal(rig_scene, max_keypoints):
    """Equal lists, order included; 40000 reaches past the strong corners
    into the flat regions, where many responses tie."""
    for img in rig_scene[0][:3]:
        want = jfeat.harris_keypoints(img, max_keypoints=max_keypoints)
        got = tfeat.harris_keypoints(img, max_keypoints=max_keypoints,
                                     device=CPU)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_patch_descriptors_match(rig_scene):
    """Harris keypoints, the image corners (nearly flat, edge-padded
    patches) and two flat blocks: one whose value sums exactly (a zero
    descriptor) and one whose mean rounds (a residual that the norm blows
    up to +-1/11: the two sides agree only if the mean has the same bits)."""
    img = np.array(rig_scene[0][0], np.float32)
    img[20:50, 20:60] = 0.4375
    img[60:90, 100:140] = 0.46735042
    kps = jfeat.harris_keypoints(img, max_keypoints=1024)
    kps = np.concatenate([kps, [[0, 0], [175, 127], [3, 120], [40, 35],
                                [120, 75]]]).astype(np.int32)
    want = jfeat.patch_descriptors(img, kps)
    got = tfeat.patch_descriptors(img, kps, device=CPU)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not want[-2].any()


def _superpoint_npz(tmp_path, rng):
    """A random npz in the layout of tools/convert_superpoint_weights.py."""
    arrays = {}
    for name, hw, cin, cout in tfeat._LAYERS:
        arrays[f"{name}/kernel"] = rng.normal(
            0, np.sqrt(2.0 / (hw * hw * cin)), (hw, hw, cin, cout)).astype(
                np.float32)
        arrays[f"{name}/bias"] = rng.normal(0, 0.05, (cout,)).astype(
            np.float32)
    path = str(tmp_path / "superpoint.npz")
    np.savez(path, **arrays)
    return path


def test_superpoint_forward_matches(tmp_path, rng, rig_scene):
    path = _superpoint_npz(tmp_path, rng)
    variables = jfeat.load_superpoint_params(path)
    net = tfeat.load_superpoint_params(path, device=CPU)
    assert set(convert.superpoint_params_from_npz(path)) == set(
        net.state_dict())
    img = rig_scene[0][0][None, :, :, None].astype(np.float32)
    semi_j, desc_j = jfeat.SuperPointNet().apply(variables, img)
    with torch.no_grad():
        semi_t, desc_t = net(torch.from_numpy(img))
    assert semi_t.shape == (1, 16, 22, 65) and desc_t.shape == (1, 16, 22,
                                                                256)
    np.testing.assert_allclose(semi_t.numpy(), np.asarray(semi_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j),
                               rtol=1e-4, atol=1e-5)


def test_superpoint_scores_and_nms(rng):
    semi = rng.normal(0, 3, (2, 6, 7, 65)).astype(np.float32)
    want = np.asarray(jfeat.superpoint_scores(jnp.asarray(semi)))
    got = tfeat.superpoint_scores(torch.from_numpy(semi)).numpy()
    assert got.shape == want.shape == (2, 48, 56)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # Equal values in a window too (the masks' == tests).
    scores = np.round(rng.uniform(0, 1, (2, 48, 56)), 1).astype(np.float32)
    for s in (want, scores):
        for radius in (1, 4):
            np.testing.assert_array_equal(
                tfeat.simple_nms(torch.from_numpy(s), radius).numpy(),
                np.asarray(jfeat.simple_nms(jnp.asarray(s), radius)))


def test_superpoint_detect_and_describe_equal(tmp_path, rng, rig_scene):
    path = _superpoint_npz(tmp_path, rng)
    variables = jfeat.load_superpoint_params(path)
    net = tfeat.load_superpoint_params(path, device=CPU)
    for img in rig_scene[0][:2]:
        for max_kp, thr in ((1024, 0.005), (64, 0.0)):
            kj, dj = jfeat.superpoint_detect_and_describe(
                variables, img, max_keypoints=max_kp, keypoint_threshold=thr)
            kt, dt = tfeat.superpoint_detect_and_describe(
                net, img, max_keypoints=max_kp, keypoint_threshold=thr)
            assert len(kt) > 10
            np.testing.assert_array_equal(kt, kj)
            np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-5)


def _pairs(m):
    return {tuple(int(v) for v in row) for row in np.asarray(m)}


def test_matching_random_descriptors(rng):
    def unit(n, d):
        x = rng.normal(size=(n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    d1, d2 = unit(300, 32), unit(280, 32)
    d2[:150] = d1[:150] + 0.05 * unit(150, 32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    for ratio in (0.8, 0.95):
        want = jmatch.mutual_nn_ratio_match(d1, d2, ratio=ratio)
        got = tmatch.mutual_nn_ratio_match(d1, d2, ratio=ratio, device=CPU)
        assert len(want) > 50
        assert _pairs(got) == _pairs(want)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tmatch.mutual_nn_ratio_match(
            torch.from_numpy(d1), torch.from_numpy(d2), ratio=ratio,
            device=CPU), want)


def test_matching_scene_descriptors(rig_scene):
    """Per pair and exhaustive (one product per image): the JAX package's
    sets, self-matching included."""
    images = rig_scene[0]
    descs = [jfeat.detect_and_describe(img, 400)[1] for img in images]
    want = {}
    for i in range(len(descs)):
        for j in range(i + 1, len(descs)):
            m = jmatch.mutual_nn_ratio_match(descs[i], descs[j], ratio=0.8)
            got = tmatch.mutual_nn_ratio_match(descs[i], descs[j], ratio=0.8,
                                               device=CPU)
            np.testing.assert_array_equal(got, m)
            if len(m):
                want[(i, j)] = m
    got = tmatch.exhaustive_match(descs, ratio=0.8, device=CPU)
    assert list(got) == list(want)
    for key, m in want.items():
        np.testing.assert_array_equal(got[key], m)
    same = tmatch.mutual_nn_ratio_match(descs[0], descs[0], ratio=0.99,
                                        device=CPU)
    np.testing.assert_array_equal(
        same, jmatch.mutual_nn_ratio_match(descs[0], descs[0], ratio=0.99))


def test_exhaustive_match_uneven_lists(rng):
    """Images with different keypoint counts, one with none."""
    descs = []
    for n in (40, 0, 25, 60, 33):
        x = rng.normal(size=(n, 16)).astype(np.float32)
        descs.append(x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                                    1e-8))
    base = descs[0]
    descs[3][:30] = base[:30] + 0.02 * rng.normal(size=(30, 16))
    descs[2][:20] = base[5:25] + 0.02 * rng.normal(size=(20, 16))
    for d in descs:
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-8)
    got = tmatch.exhaustive_match(descs, ratio=0.8, device=CPU)
    want = {}
    for i in range(5):
        for j in range(i + 1, 5):
            if len(descs[i]) and len(descs[j]):
                m = jmatch.mutual_nn_ratio_match(descs[i], descs[j])
                if len(m):
                    want[(i, j)] = m
    assert list(got) == list(want) and len(want) >= 2
    for key, m in want.items():
        np.testing.assert_array_equal(got[key], m)


def test_epipolar_filter_and_tracks_equal(rig_scene, perturbed):
    images, _, intrinsics, *_ = rig_scene
    feats = [jfeat.detect_and_describe(img, 400) for img in images[:4]]
    all_matches = {}
    for i in range(4):
        for j in range(i + 1, 4):
            m = jmatch.mutual_nn_ratio_match(feats[i][1], feats[j][1])
            args = (feats[i][0], feats[j][0], m, intrinsics[i],
                    intrinsics[j], perturbed[i], perturbed[j])
            want = jmatch.epipolar_filter(*args, threshold=4.0)
            got = tmatch.epipolar_filter(*args, threshold=4.0)
            np.testing.assert_array_equal(got, want)
            all_matches[(i, j)] = want
    want = jmatch.build_tracks(all_matches)
    assert len(want) > 20
    assert tmatch.build_tracks(all_matches) == want


@pytest.fixture(scope="module")
def jax_rigba_local(tmp_path_factory):
    """The JAX package's rig BA source built where the test runs, with its own
    flags, as its loader does when the library is older than the source."""
    lib = str(tmp_path_factory.mktemp("rigba") / "librigba.so")
    subprocess.run(["g++", *build.GXX_FLAGS, jrigba._SRC, "-o", lib],
                   check=True, capture_output=True)
    return lib


def _use_jax_rigba(monkeypatch, lib):
    monkeypatch.setattr(jrigba, "_LIB", lib)
    monkeypatch.setattr(jrigba, "_lib", None)


def _rigba_problem():
    rng = np.random.default_rng(3)
    sc = test_rigba._make_scene(rng, noise_px=0.5)
    rig_q, rig_t, rel_q, rel_t, pts, intr, os_, oc, op, oxy = sc
    rig_t = rig_t + rng.normal(0, 0.03, rig_t.shape)
    pts = pts + rng.normal(0, 0.05, pts.shape)
    return rig_q, rig_t, rel_q, rel_t, pts, intr, os_, oc, op, oxy


def _rigba_runs(lib):
    """solve (UC-NeRF mode, full BA) and triangulate through `lib`."""
    rig_q, rig_t, rel_q, rel_t, pts, intr, os_, oc, op, oxy = _rigba_problem()
    out = []
    for kw in (dict(fix_rel_trans=True, max_iterations=40),
               dict(fix_rig_poses=True, fix_rel_trans=True, fix_points=True,
                    max_iterations=30, huber_delta=0.0)):
        out.append(lib.solve(rig_q.copy(), rig_t.copy(), rel_q.copy(),
                             rel_t.copy(), pts.copy(), intr, os_, oc, op,
                             oxy, **kw))
    out.append(lib.triangulate(len(pts), os_, oc, op, oxy, rig_q, rig_t,
                               rel_q, rel_t, intr, max_error=2.0))
    return out


def test_rigba_port_build(monkeypatch, jax_rigba_local):
    """The port builds its own copy into its _build/ directory and never
    loads the JAX package's library; the JAX package's source built locally
    with its flags gives the same bits."""
    def code(path):  # the source without its comment lines
        with open(path) as f:
            return [ln for ln in f if not ln.lstrip().startswith("//")]
    assert code(build.CSRC / "rigba.cc") == code(jrigba._SRC)
    got = _rigba_runs(trigba)
    assert trigba._lib._name == str(build.BUILD_DIR / "librigba.so")
    committed = _rigba_runs(jrigba)
    _use_jax_rigba(monkeypatch, jax_rigba_local)
    local = _rigba_runs(jrigba)
    for g, h, c in zip(got, local, committed):
        for a, b, cc in zip(g, h, c):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, cc, rtol=1e-7, atol=1e-9)
    assert got[0][-1] > 0 and got[2][1].sum() > 20


def test_colmap_io_same_bytes(tmp_path, rng):
    cams = {1: tcio.Camera(1, "PINHOLE", 800, 600,
                           np.array([400.0, 410.0, 400.0, 300.0]))}
    ims = {3: tcio.Image(3, np.array([0.9, 0.1, 0.2, 0.3]),
                         np.array([0.1, 0.2, 0.3]), 1, "cam_1/00000000.jpg",
                         rng.uniform(0, 500, (5, 2)),
                         np.array([7, -1, 2, 3, -1], np.int64))}
    pts = {7: tcio.Point3D(7, np.array([1.0, 2.0, 3.0]),
                           np.array([10, 20, 30], np.uint8), 0.5,
                           np.array([3, 3], np.int32),
                           np.array([0, 2], np.int32))}
    for name, args in (("write_cameras_binary", (cams,)),
                       ("write_images_binary", (ims,)),
                       ("write_points3D_binary", (pts,)),
                       ("write_cameras_text", (cams,)),
                       ("write_images_text", (ims,))):
        a, b = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
        getattr(jcio, name)(*args, a)
        getattr(tcio, name)(*args, b)
        assert a.read_bytes() == b.read_bytes(), name
    back = tcio.read_images_binary(tmp_path / "t_write_images_binary")
    np.testing.assert_array_equal(back[3].xys, ims[3].xys)
    assert tcio.pair_id(5, 2) == jcio.pair_id(5, 2)


def _rel_rot_error(w2c, rig_scene):
    _, _, _, num_frames, num_cams, rel_true = rig_scene
    errs = []
    for s in range(num_frames):
        rel = w2c[s * num_cams + 1] @ np.linalg.inv(w2c[s * num_cams])
        dr = rel[:3, :3] @ rel_true[1][:3, :3].T
        errs.append(np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2,
                                                 -1, 1))))
    return float(np.mean(errs))


def test_refine_poses_and_pose_json(tmp_path, rig_scene, perturbed,
                                    monkeypatch, jax_rigba_local):
    images, _, intrinsics, num_frames, num_cams, _ = rig_scene
    kw = dict(max_keypoints=400, epipolar_px=8.0, tri_max_error=25.0,
              huber_px=2.0, ba_iterations=40)
    committed = jpipe.refine_poses(images, perturbed, intrinsics, num_frames,
                                   num_cams, **kw)
    _use_jax_rigba(monkeypatch, jax_rigba_local)
    want = jpipe.refine_poses(images, perturbed, intrinsics, num_frames,
                              num_cams, **kw)
    got = tpipe.refine_poses(images, perturbed, intrinsics, num_frames,
                             num_cams, device=CPU, **kw)
    assert got["num_points"] == want["num_points"] > 30
    np.testing.assert_allclose(got["w2c"], want["w2c"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["points"], want["points"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["w2c"], committed["w2c"], rtol=0,
                               atol=1e-7)
    assert _rel_rot_error(got["w2c"], rig_scene) < 0.5 * _rel_rot_error(
        perturbed, rig_scene)
    stats = got["stats"]
    assert set(stats["seconds"]) == {"detect", "match", "verify", "tracks",
                                     "triangulate", "ba", "scale"}
    assert stats["verified_pairs"] <= stats["matched_pairs"]
    assert stats["keypoints"] == sum(
        len(jfeat.harris_keypoints(img, 400)) for img in images)

    a, b = tmp_path / "j" / "pose.json", tmp_path / "t" / "pose.json"
    out_j = jpipe.write_pose_json(str(a), want["w2c"], num_frames, num_cams)
    out_t = tpipe.write_pose_json(str(b), want["w2c"], num_frames, num_cams)
    assert out_t == out_j and a.read_bytes() == b.read_bytes()
    assert json.loads(b.read_text()) == out_j
