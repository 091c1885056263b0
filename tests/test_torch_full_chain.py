"""tests/test_full_chain.py's three-subsystem chain through the port's
modules, on the CPU: STPR pose refinement (``ucnerf_tpu_torch.pose``) ->
``pose.json`` -> MVS depth files (``ucnerf_tpu_torch.cli.mvs_depth``) -> the
port's WaymoV2 loader -> training steps with virtual warping.

The scene, the miscalibration and the checks are the JAX test's (its
fixture's images rendered once, the on-disk segment written with Pillow, as
there).  One case more: stage 1's refined poses equal the JAX package's
``refine_poses`` on the same images, within 1e-9 (its rig BA built from its
source where the test runs, as tests/test_torch_pose.py explains).
"""

import dataclasses
import os
import pickle
import subprocess

import numpy as np
import pytest
import torch

from ucnerf_tpu.pose import pipeline as jpipe
from ucnerf_tpu.pose import rigba as jrigba
from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.data import cameras as camlib
from ucnerf_tpu_torch.data import datasets as dsets
from ucnerf_tpu_torch.data import warping
from ucnerf_tpu_torch.ops import build
from ucnerf_tpu_torch.pose import pipeline

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

import test_full_chain as chain_ref  # noqa: E402

torch.set_num_threads(2)
W, H, F = chain_ref.W, chain_ref.H, chain_ref.F
NUM_FRAMES, NUM_CAMS = chain_ref.NUM_FRAMES, chain_ref.NUM_CAMS
CAMS, CAM_OBSERVERS = chain_ref.CAMS, chain_ref.CAM_OBSERVERS
REFINE = dict(max_keypoints=400, epipolar_px=8.0, tri_max_error=25.0,
              huber_px=2.0, ba_iterations=40)


def _render_view(w2c_cv, k):
    """RGB + OpenCV z-depth of the analytic scene (the port's data layer)."""
    c2w_gl = np.linalg.inv(w2c_cv) @ warping.GL_TO_CV
    x, y = np.meshgrid(np.arange(W), np.arange(H))
    origins, dirs, _, _, _ = camlib.pixels_to_rays(
        x, y, np.linalg.inv(k)[None], c2w_gl[None, :3, :])
    rgb, depth_t, _ = dsets.synthetic_scene_color_and_depth(origins, dirs)
    dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    fwd = np.linalg.inv(w2c_cv)[:3, 2]
    z = depth_t * (dn @ fwd)
    return rgb.astype(np.float32), np.clip(z, 0, 100).astype(np.float32)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The scene, the segment on disk, and stage 1 through the port."""
    root = str(tmp_path_factory.mktemp("chain_seg"))
    k = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    rot_y = chain_ref._rot_y
    rel_true = [np.eye(4), rot_y(5.0), rot_y(-5.0)]
    rel_true[1][:3, 3] = [0.3, 0.0, 0.0]
    rel_true[2][:3, 3] = [-0.3, 0.0, 0.0]
    rel_pert = [np.eye(4), rot_y(1.2) @ rel_true[1],
                rot_y(-1.0) @ rel_true[2]]

    images_rgb, depths_gt, w2c_true, w2c_pert = [], [], [], []
    for s in range(NUM_FRAMES):
        ang = 0.08 * s
        pos = np.array([2.5 * np.sin(ang), 0.4, 2.5 * np.cos(ang)])
        c2w_gl_rig = dsets._lookat_cam_to_world(pos, (0.0, 0.0, 0.0))
        w2c_rig = np.linalg.inv(c2w_gl_rig @ warping.GL_TO_CV)
        for c in range(NUM_CAMS):
            wt = rel_true[c] @ w2c_rig
            rgb, z = _render_view(wt, k)
            images_rgb.append(rgb)
            depths_gt.append(z)
            w2c_true.append(wt)
            w2c_pert.append(rel_pert[c] @ w2c_rig)
    w2c_true, w2c_pert = np.stack(w2c_true), np.stack(w2c_pert)
    intrinsics = np.stack([k] * len(images_rgb))

    observers = {}
    for c, (cam, oid) in enumerate(zip(CAMS, CAM_OBSERVERS)):
        os.makedirs(os.path.join(root, "images", cam))
        os.makedirs(os.path.join(root, "masks", cam))
        c2ws = np.stack([np.linalg.inv(w2c_pert[s * NUM_CAMS + c])
                         for s in range(NUM_FRAMES)])
        observers[oid] = {"class_name": "Camera",
                          "data": {"intr": np.tile(k[None],
                                                   (NUM_FRAMES, 1, 1)),
                                   "c2w": c2ws}}
        for s in range(NUM_FRAMES):
            img = (np.clip(images_rgb[s * NUM_CAMS + c], 0, 1)
                   * 255).astype(np.uint8)
            Image.fromarray(img, "RGB").save(
                os.path.join(root, "images", cam, f"{s:08d}.jpg"),
                quality=97)
            np.savez(os.path.join(root, "masks", cam, f"{s:08d}.npz"),
                     np.zeros((H, W), np.uint8))
    with open(os.path.join(root, "scenario.pt"), "wb") as f:
        pickle.dump({"observers": observers}, f)

    gray = np.stack([0.299 * im[..., 0] + 0.587 * im[..., 1]
                     + 0.114 * im[..., 2] for im in images_rgb])
    out = pipeline.refine_poses(gray, w2c_pert.copy(), intrinsics,
                                NUM_FRAMES, NUM_CAMS, device="cpu", **REFINE)
    pose_json = os.path.join(root, "sparse", "0", "pose.json")
    pipeline.write_pose_json(pose_json, out["w2c"], NUM_FRAMES, NUM_CAMS)
    return dict(root=root, rel_true=rel_true, w2c_pert=w2c_pert,
                refined=out["w2c"], pose_json=pose_json, depths_gt=depths_gt,
                gray=gray, intrinsics=intrinsics)


def _rel_rot_err_deg(w2c, cam, rel_true):
    return chain_ref._rel_rot_err_deg(w2c, cam, rel_true)


def test_stage1_refinement_reduces_rig_error(chain):
    for cam in (1, 2):
        before = _rel_rot_err_deg(chain["w2c_pert"], cam, chain["rel_true"])
        after = _rel_rot_err_deg(chain["refined"], cam, chain["rel_true"])
        assert before > 0.9, before
        assert after < before * 0.5, (cam, before, after)
    assert os.path.exists(chain["pose_json"])


def test_stage1_equals_jax_refine_poses(chain, tmp_path, monkeypatch):
    lib = str(tmp_path / "librigba.so")
    subprocess.run(["g++", *build.GXX_FLAGS, jrigba._SRC, "-o", lib],
                   check=True, capture_output=True)
    monkeypatch.setattr(jrigba, "_LIB", lib)
    monkeypatch.setattr(jrigba, "_lib", None)
    want = jpipe.refine_poses(chain["gray"], chain["w2c_pert"].copy(),
                              chain["intrinsics"], NUM_FRAMES, NUM_CAMS,
                              **REFINE)
    np.testing.assert_allclose(chain["refined"], want["w2c"], rtol=0,
                               atol=1e-9)


@pytest.fixture(scope="module")
def depth_dir(chain):
    """Stage 2: the port's MVS depth CLI over the segment + pose.json, then
    ground-truth depth standing in for a trained MVS."""
    from ucnerf_tpu_torch.cli import mvs_depth
    from ucnerf_tpu_torch.models.mvs import datasets as mvs_datasets

    out_dir = os.path.join(chain["root"], "depth")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mvs_datasets.WaymoMVSWindows, "NUM_FRAMES", NUM_FRAMES)
        mvs_depth.main(["--data-dir", chain["root"],
                        "--pose-json", chain["pose_json"],
                        "--output", out_dir, "--num-cams", str(NUM_CAMS),
                        "--rescales", "1.0", "--limit", "2",
                        "--device", "cpu"])
    produced = sorted(os.listdir(out_dir))
    assert "00000000cam_1.npy" in produced
    d0 = np.load(os.path.join(out_dir, "00000000cam_1.npy"))
    assert d0.shape == (H, W) and d0.dtype == np.float32
    for s in range(NUM_FRAMES):
        for c, cam in enumerate(CAMS):
            np.save(os.path.join(out_dir, f"{s:08d}{cam}.npy"),
                    chain["depths_gt"][s * NUM_CAMS + c])
    return out_dir


@pytest.fixture(scope="module")
def nerf_config(chain, depth_dir):
    return dataclasses.replace(
        configs.tiny(),
        dataset_loader="waymov2", data_dir=chain["root"],
        depth_dir=depth_dir, refine_name=chain["pose_json"],
        cam_type=6, factor=1, load_sky_segments=True,
        virtual_poses=True, near=0.0, far=8.0, batch_size=80,
        training_views=NUM_FRAMES * NUM_CAMS)


@pytest.fixture()
def _waymo_small(monkeypatch):
    monkeypatch.setattr(dsets.WaymoV2Dataset, "NUM_FRAMES", NUM_FRAMES)
    monkeypatch.setattr(dsets.WaymoV2Dataset, "_size_override", (W, H),
                        raising=False)


def test_stage3_loader_consumes_refined_poses(chain, nerf_config,
                                              _waymo_small):
    train = dsets.load_dataset("train", nerf_config)
    assert train.disp_images is not None
    assert train.virtual_poses is not None
    w2c_cv = np.stack([np.linalg.inv(c2w @ warping.GL_TO_CV)
                       for c2w in train.camtoworlds])

    def rel_err(cam):
        errs = []
        for s in range(train.n_examples // NUM_CAMS):
            rel = w2c_cv[s * NUM_CAMS + cam] @ np.linalg.inv(
                w2c_cv[s * NUM_CAMS])
            dr = rel[:3, :3] @ chain["rel_true"][cam][:3, :3].T
            errs.append(np.degrees(np.arccos(
                np.clip((np.trace(dr) - 1) / 2, -1, 1))))
        return float(np.mean(errs))

    for cam in (1, 2):
        refined_err = _rel_rot_err_deg(chain["refined"], cam,
                                       chain["rel_true"])
        assert rel_err(cam) == pytest.approx(refined_err, abs=0.15)
        assert rel_err(cam) < _rel_rot_err_deg(
            chain["w2c_pert"], cam, chain["rel_true"]) * 0.6


def test_stage4_virtual_warp_batches(chain, nerf_config, _waymo_small):
    train = dsets.load_dataset("train", nerf_config)
    batch = train.sample_batch(np.random.default_rng(0), 80)
    assert batch["origins"].shape == (80, 3)
    assert getattr(train, "_warp_pool", None) is not None
    assert len(train._warp_pool["src_cam_idx"]) > 0
    assert np.isfinite(batch["rgb"]).all()


def test_stage5_training_learns(chain, nerf_config, _waymo_small):
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step as step_lib

    cfg = nerf_config
    train = dsets.load_dataset("train", cfg)
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    state = state_lib.create_train_state(cfg, model)
    train_step = step_lib.make_train_step(model, cfg)
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(8):
        batch = step_lib.batch_to_device(
            train.sample_batch(rng, cfg.batch_size), "cpu")
        state, stats = train_step(state, batch, 0.5, generator=gen)
        losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
