"""The port's MVS entry points on the CPU: ``cli.mvs_train`` learns on the
synthetic windows and its ``--out`` file round-trips; ``cli.mvs_depth``
over the JAX tests' miniature Waymo segment (with a ``pose.json``) writes
loader-contract ``.npy`` depth maps of image size that the port's
``WaymoV2Dataset`` reads as ``depth_dir``, and with ``--fuse`` the masks
and a point cloud; the segment's temporal windows equal the JAX package's
bitwise.  Both CLIs default to ``--device cuda`` and raise without a card.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import test_data_waymo as waymo_fixture
from ucnerf_tpu.models.mvs import datasets as jdatasets
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.cli import mvs_depth
from ucnerf_tpu_torch.cli import mvs_train
from ucnerf_tpu_torch.data import datasets as tdatasets
from ucnerf_tpu_torch.models.mvs import datasets as tmvs_datasets

torch.set_num_threads(2)


def test_mvs_train_learns_and_its_out_file_round_trips(tmp_path):
    """The JAX CLI test's check (tests/test_mvs.py): the sequence loss of a
    short tiny run falls."""
    out = str(tmp_path / "mvs.pt")
    losses = mvs_train.main(["--tiny", "--steps", "15", "--crop", "32", "48",
                             "--lr", "1e-3", "--device", "cpu", "--out", out])
    assert len(losses) == 15
    assert np.isfinite(losses).all()
    assert min(losses[-3:]) < losses[0], losses

    saved = torch.load(out, weights_only=True)
    assert saved["flags"]["tiny"] and saved["flags"]["steps"] == 15
    model = mvs_train.build_model(tiny=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(saved["state_dict"], strict=True)
    for name, value in model.state_dict().items():
        assert torch.equal(value, saved["state_dict"][name]), name
    assert any(not torch.equal(init[k], saved["state_dict"][k])
               for k in init)


@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    """The JAX tests' miniature Waymo-style segment (96x64 jpgs, 16 frames
    of 3 cameras) and a pose.json of its world-to-cam poses."""
    pytest.importorskip("PIL")
    from scipy.spatial.transform import Rotation

    root = str(tmp_path_factory.mktemp("mvs_seg_port"))
    gt = waymo_fixture._make_segment(root, np.random.default_rng(0))
    poses = {}
    for cam in waymo_fixture.CAMS:
        for f in range(waymo_fixture.N_FRAMES):
            w2c = np.linalg.inv(gt["c2ws"][cam][f])
            q = Rotation.from_matrix(w2c[:3, :3]).as_quat()  # x, y, z, w
            poses[f"{cam}/{f:08d}"] = dict(
                q_x=float(q[0]), q_y=float(q[1]), q_z=float(q[2]),
                q_w=float(q[3]), p_x=float(w2c[0, 3]), p_y=float(w2c[1, 3]),
                p_z=float(w2c[2, 3]))
    pose_json = os.path.join(root, "pose.json")
    with open(pose_json, "w") as f:
        json.dump(poses, f)
    return root, pose_json, gt


@pytest.fixture
def frames(monkeypatch):
    for lib in (jdatasets, tmvs_datasets):
        monkeypatch.setattr(lib.WaymoMVSWindows, "NUM_FRAMES",
                            waymo_fixture.N_FRAMES)
    monkeypatch.setattr(tdatasets.WaymoV2Dataset, "NUM_FRAMES",
                        waymo_fixture.N_FRAMES)


@pytest.mark.parametrize("num_frames", [6, 10])
def test_waymo_windows_match_jax_package(segment, frames, num_frames):
    root, pose_json, _ = segment
    got = tmvs_datasets.WaymoMVSWindows(root, pose_json,
                                        num_frames=num_frames)
    want = jdatasets.WaymoMVSWindows(root, pose_json, num_frames=num_frames)
    assert len(got) == len(want) == 3 * waymo_fixture.N_FRAMES
    for index in (0, 1, 20, len(want) - 1):
        assert got.window_indices(index) == want.window_indices(index)
        g, w = got[index], want[index]
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3:] == w[3:]


def _depth_argv(root, pose_json, out, *extra):
    return ["--data-dir", root, "--pose-json", pose_json, "--output", out,
            "--device", "cpu", *extra]


def test_mvs_depth_writes_loader_depths(segment, frames, tmp_path):
    """Two reference views at rescales 0.5 and 1.0 from a random init: one
    float32 .npy of image size each, finite and >= 0, which the port's
    Waymo loader reads as the segment's depth (depth <= 0.5 dropped, then
    the scene scale)."""
    root, pose_json, gt = segment
    out = str(tmp_path / "depth")
    mvs_depth.main(_depth_argv(root, pose_json, out, "--rescales", "0.5",
                               "1.0", "--limit", "2"))
    names = ["00000000cam_1", "00000000cam_2"]
    assert sorted(os.listdir(out)) == [f"{n}.npy" for n in names]
    depth_dir = str(tmp_path / "depth_dir")
    shutil.copytree(gt["depth_dir"], depth_dir)
    ours = []
    for name in names:
        d = np.load(os.path.join(out, f"{name}.npy"))
        assert d.shape == (64, 96) and d.dtype == np.float32
        assert np.isfinite(d).all() and (d >= 0).all()
        shutil.copy(os.path.join(out, f"{name}.npy"), depth_dir)
        ours.append(d)

    cfg = tconfigs.Config(dataset_loader="waymov2", data_dir=root,
                          depth_dir=depth_dir, cam_type=6, factor=20,
                          near=0.0, far=8.0)
    ds = tdatasets.load_dataset("test", cfg)
    assert ds.image_names[:3] == ["cam_1/00000000.jpg", "cam_2/00000000.jpg",
                                  "cam_3/00000000.jpg"]
    # The fixture's third view keeps its constant depth 5 + frame + camera.
    scale = ds.disp_images[2][5, 5] / 7.0
    for i, d in enumerate(ours):
        np.testing.assert_allclose(ds.disp_images[i],
                                   np.where(d <= 0.5, 0.0, d) * scale,
                                   rtol=1e-6)


def test_mvs_depth_fuses_views(segment, frames, tmp_path):
    """--fuse with the 1/8-res encoder over the first two frames' six
    reference views (each has its camera's other frame among its sources):
    masked depths, a mask per view and a PLY point cloud whose header names
    its vertex count."""
    root, pose_json, _ = segment
    out = str(tmp_path / "fused")
    mvs_depth.main(_depth_argv(root, pose_json, out, "--rescales", "1.0",
                               "--limit", "6", "--fuse",
                               "--encoder-type", "LR"))
    names = [f"{f:08d}{cam}" for f in (0, 1) for cam in waymo_fixture.CAMS]
    for name in names:
        mask = np.load(os.path.join(out, "mask", f"{name}.npy"))
        depth = np.load(os.path.join(out, f"{name}.npy"))
        assert mask.dtype == bool and mask.shape == depth.shape == (64, 96)
        assert (depth[~mask] == 0).all()
    with open(os.path.join(out, "result.ply"), "rb") as f:
        head = f.read(512)
    assert head.startswith(b"ply\n") and b"end_header\n" in head
    assert b"element vertex " in head and b"element face 0" in head


@pytest.mark.parametrize("main,argv", [
    (mvs_train.main, ["--tiny", "--steps", "1"]),
    (mvs_depth.main, ["--data-dir", ".", "--pose-json", "p.json",
                      "--output", "out"]),
])
def test_mvs_clis_default_to_the_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
