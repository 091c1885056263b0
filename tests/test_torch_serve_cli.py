"""The port's serving and extraction entry points (``cli/eval.py``,
``cli/render.py``, ``cli/extract.py``, ``cli/tsdf.py``) end to end on the
CPU, at the tiny preset, sharing one checkpoint trained by the port's
``cli/train.py``: the counterpart of ``tests/test_cli_e2e.py``.

Each CLI is held to what it writes: eval's metric dumps equal (bitwise)
what ``render_image`` and ``MetricHarness`` give for the checkpoint's
weights; render's frames, and a second call that renders nothing; extract's
PLY equal (bytewise) to what the copied ``meshing`` writes for the port's
own density volume; tsdf's PLY with faces.
"""

import os

import numpy as np
import pytest
import torch

from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.cli import eval as cli_eval
from ucnerf_tpu_torch.cli import extract as cli_extract
from ucnerf_tpu_torch.cli import render as cli_render
from ucnerf_tpu_torch.cli import train as cli_train
from ucnerf_tpu_torch.cli import tsdf as cli_tsdf
from ucnerf_tpu_torch.data import datasets
from ucnerf_tpu_torch.extraction import meshing
from ucnerf_tpu_torch.tools import eval_ckpt_step, mvs_quality
from ucnerf_tpu_torch.ops import coord as tcoord
from ucnerf_tpu_torch.train import checkpoints as ckpt
from ucnerf_tpu_torch.train import step as step_lib
from ucnerf_tpu_torch.utils import image as image_lib

torch.set_num_threads(2)

STEPS = 20
CLIS = {"eval": cli_eval, "render": cli_render, "extract": cli_extract,
        "tsdf": cli_tsdf, "train": cli_train,
        "eval_ckpt_step": eval_ckpt_step, "mvs_quality": mvs_quality}
# The flags of the entry points that take more than a preset and bindings.
EXTRA_FLAGS = {"eval_ckpt_step": ["--step", "1"]}


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "exp")
    cli_train.main(["--tiny", "--device", "cpu", "--max-steps", str(STEPS),
                    "-b", f"Config.exp_name = {path!r}",
                    "-b", f"Config.checkpoint_every = {STEPS}",
                    "-b", "Config.train_render_every = 0"])
    assert ckpt.latest_checkpoint_step(path) == STEPS
    return path


def _args(exp, *extra):
    return ["--tiny", "--device", "cpu", "-b", f"Config.exp_name = {exp!r}",
            *extra]


def _model(exp, cfg):
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    assert ckpt.restore_model(exp, model) == STEPS
    return model


def test_eval_writes_the_metrics_of_render_image(exp):
    cli_eval.main(_args(exp, "--ray-histograms"))
    cfg = configs.tiny()
    test = datasets.load_dataset("test", cfg)
    eval_step = step_lib.make_eval_step(_model(exp, cfg), cfg)
    harness = image_lib.MetricHarness()
    want = {"psnr": [], "ssim": [], "psnr_cc": [], "ssim_cc": []}
    for idx in range(test.n_examples):
        batch = test.image_batch(idx)
        rendering = step_lib.render_image(
            eval_step, batch, cfg, eval_camidx=cli_eval._eval_camidx(
                cfg, idx, test.cam_num))
        pred = np.clip(rendering["rgb"], 0, 1)
        m = harness(pred, batch["rgb"])
        m.update(harness(image_lib.color_correct(pred, batch["rgb"]),
                         batch["rgb"], name_fn=lambda s: s + "_cc"))
        for k in want:
            want[k].append(m[k])
    for key, vals in want.items():
        with open(os.path.join(exp, f"{key}_{STEPS}.txt")) as f:
            got = [float(v) for v in f.read().split()]
        assert got == vals, key
        assert np.isfinite(got).all()
    preds = os.listdir(os.path.join(exp, "test_preds"))
    for name in ("color", "depth", "acc"):
        assert len([p for p in preds if p.startswith(name)]) == \
            test.n_examples
    assert {"ray_colors_000.png", "ray_weights_000.png"} <= set(preds)


def test_render_writes_frames_and_resumes(exp):
    args = _args(exp, "-b", "Config.render_path_frames = 3")
    cli_render.main(args)
    out = os.path.join(exp, "render", f"path_renders_step_{STEPS}")
    frames = sorted(os.listdir(out))
    assert frames == sorted(f"{tag}_{i:03d}.png" for tag in
                            ("color", "depth", "acc") for i in range(3))
    stamps = {f: os.stat(os.path.join(out, f)).st_mtime_ns for f in frames}
    log = os.path.join(exp, "log_render.txt")
    before = os.path.getsize(log)
    cli_render.main(args)
    with open(log) as f:
        f.seek(before)
        again = f.read()
    assert again.count("already exists, skipping") == 3
    assert "rendered frame" not in again
    assert {f: os.stat(os.path.join(out, f)).st_mtime_ns
            for f in frames} == stamps


def test_extract_writes_the_mesh_of_its_volume(exp, tmp_path):
    cfg = configs.tiny()
    model = _model(exp, cfg)
    res, r_c = 20, 2.0
    vol = cli_extract.density_volume(model, res, r_c)
    # Other chunks change the volume only by the matmuls' rounding (the
    # field's GEMMs block by the number of points).
    np.testing.assert_allclose(
        cli_extract.density_volume(model, res, r_c, chunk=1000), vol,
        rtol=1e-6, atol=0)
    iso = float((vol.min() + vol.max()) / 2)
    out = str(tmp_path / "mesh.ply")
    cli_extract.main(_args(exp, "--resolution", str(res), "--iso-density",
                           repr(iso), "--out", out))
    # The same steps, spelled out: surface nets, the inverse contraction,
    # the clip to world radius 10.
    verts_c, faces = meshing.surface_nets(
        -(vol - iso), origin=(-r_c + r_c / res,) * 3, voxel_size=2 * r_c / res)
    verts_w = tcoord.inv_contract(torch.from_numpy(verts_c)).numpy()
    keep = np.linalg.norm(verts_w, axis=-1) < 10.0
    assert 0 < keep.sum() < len(keep)  # the clip is exercised
    remap = np.cumsum(keep) - 1
    faces = remap[faces[keep[faces].all(axis=1)]].astype(np.int32)
    verts_w = verts_w[keep]
    assert len(faces) > 0
    got_v, got_f = cli_extract.mesh_of_volume(vol, iso, r_c, 10.0, "cpu")
    np.testing.assert_array_equal(got_v, verts_w)
    np.testing.assert_array_equal(got_f, faces)
    want = str(tmp_path / "want.ply")
    meshing.write_ply(want, verts_w, faces,
                      cli_extract.vertex_colors(model, verts_w))
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_tsdf_writes_a_mesh(exp, tmp_path):
    out = str(tmp_path / "tsdf.ply")
    cli_tsdf.main(_args(exp, "--resolution", "32", "--max-views", "2",
                        "--out", out))
    with open(out, "rb") as f:
        head = f.read(300)
    assert head.startswith(b"ply")
    n_faces = int(head.split(b"element face ")[1].split(b"\n")[0])
    assert n_faces > 0


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_needs_cuda_unless_asked_for_the_cpu(name, tmp_path):
    """--device defaults to cuda, and a machine without a card raises
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    exp = str(tmp_path / "exp")
    argv = (["--steps", "1"] if name == "mvs_quality" else
            ["--tiny", "-b", f"Config.exp_name = {exp!r}"]
            + EXTRA_FLAGS.get(name, []))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name].main(argv)
