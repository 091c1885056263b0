"""The port's render-path generators (``ucnerf_tpu_torch/data/paths.py``, a
copy of the JAX package's numpy module) against ``ucnerf_tpu/data/paths.py``.

The cases mirror ``tests/test_paths.py``; every output is held bitwise
(tolerance 0: the same numpy and scipy calls on the same inputs), and the
shape and rotation properties that file checks are checked on the port's
poses too.
"""

import numpy as np
import pytest

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.data import paths as jpaths
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.data import paths as tpaths


def _orbit_poses(n=24, radius=4.0, height=1.0):
    """Synthetic inward-looking camera ring (positions on a circle)."""
    out = []
    for theta in np.linspace(0, 2 * np.pi, n, endpoint=False):
        pos = np.array([radius * np.cos(theta), radius * np.sin(theta),
                        height + 0.3 * np.sin(3 * theta)])
        out.append(jpaths.viewmatrix(pos, np.array([0, 0, 1.0]), pos))
    return np.stack(out)


def _dataset(n=12, names=None):
    class _DS:
        pass

    ds = _DS()
    ds.camtoworlds = np.concatenate(
        [_orbit_poses(n=n),
         np.broadcast_to(np.array([[0, 0, 0, 1.0]]), (n, 1, 4))], axis=1)
    ds.cam_num = 3
    if names is not None:
        ds.image_names = names
    return ds


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _assert_valid_poses(p, n):
    assert p.shape == (n, 3, 4) and p.dtype == np.float32
    rot = p[:, :3, :3]
    np.testing.assert_allclose(rot @ np.transpose(rot, (0, 2, 1)),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(rot), 1.0, atol=1e-5)


CASES = {
    "spiral": lambda m: m.generate_spiral_path(
        _orbit_poses(), np.array([0.5, 20.0]), n_frames=60),
    "ellipse_const_speed": lambda m: m.generate_ellipse_path(
        _orbit_poses(), n_frames=90, const_speed=True),
    "ellipse_flat": lambda m: m.generate_ellipse_path(
        _orbit_poses(), n_frames=30, z_variation=0.0),
    "ellipse_wavy": lambda m: m.generate_ellipse_path(
        _orbit_poses(), n_frames=30, z_variation=1.0, z_phase=0.3),
    "interpolated": lambda m: m.generate_interpolated_path(
        _orbit_poses(n=6), n_interp=20, smoothness=0.0),
    "interpolated_few_keyframes": lambda m: m.generate_interpolated_path(
        _orbit_poses(n=3), n_interp=10),
    "spline_names_exposures": lambda m: m.create_render_spline_path(
        [f"img_{i:03d}.png" for i in range(0, 8, 2)],
        [f"img_{i:03d}.png" for i in range(8)], _orbit_poses(n=8),
        exposures=np.linspace(1.0, 2.0, 8), n_interp=12),
    "interpolate_poses": lambda m: m.interpolate_poses(
        _dataset().camtoworlds[::3], 17),
    "interpolate_one_keyframe": lambda m: m.interpolate_poses(
        _dataset().camtoworlds[:1], 4),
    "render_path_from_dataset": lambda m: m.render_path_from_dataset(
        _dataset(), 9),
    "average_pose": lambda m: m.average_pose(_orbit_poses()),
    "focus_point": lambda m: m.focus_point(_orbit_poses()),
    "quaternions": lambda m: tuple(
        m._quat_to_rotmat(m._slerp(m._rotmat_to_quat(a[:3, :3]),
                                   m._rotmat_to_quat(b[:3, :3]), t))
        for a, b, t in zip(_orbit_poses(n=5), _orbit_poses(n=5)[::-1],
                           (0.0, 0.25, 0.5, 0.9, 1.0))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_path_generator_matches_jax_package(case):
    got, want = CASES[case](tpaths), CASES[case](jpaths)
    _assert_same(got, want)
    poses = got[1] if case == "spline_names_exposures" else got
    if np.ndim(poses) == 3 and np.shape(poses)[1:] == (3, 4):
        _assert_valid_poses(poses, len(poses))


@pytest.mark.parametrize("ptype", ["keyframe", "spiral", "ellipse", "spline"])
def test_generate_render_path_dispatch_matches_jax_package(ptype):
    got = tpaths.generate_render_path(
        ptype, _dataset(), tconfigs.Config(render_path_frames=24))
    want = jpaths.generate_render_path(
        ptype, _dataset(), jconfigs.Config(render_path_frames=24))
    _assert_same(got, want)
    # The keyframe path interpolates [4, 4] poses, the others give [3, 4].
    assert len(got) > 0 and got.shape[1:] == (
        (4, 4) if ptype == "keyframe" else (3, 4))
    if ptype == "keyframe":
        assert len(got) == 24


def test_generate_render_path_spline_keyframes_file(tmp_path):
    names = [f"cam_1/{i:08d}.jpg" for i in range(12)]
    kf = tmp_path / "keyframes.txt"
    kf.write_text("\n".join(names[::3]))
    kw = dict(render_path_frames=24, render_spline_keyframes=8,
              render_spline_keyframes_file=str(kf))
    got = tpaths.generate_render_path("spline", _dataset(names=names),
                                      tconfigs.Config(**kw))
    want = jpaths.generate_render_path("spline", _dataset(names=names),
                                       jconfigs.Config(**kw))
    _assert_same(got, want)
    _assert_valid_poses(got, len(got))


def test_path_errors_match_jax_package():
    names = [f"img_{i}.png" for i in range(4)]
    for mod in (tpaths, jpaths):
        with pytest.raises(ValueError):
            mod.create_render_spline_path([names[0]], names, _orbit_poses(4))
    with pytest.raises(ValueError):
        tpaths.generate_render_path("nope", _dataset(), tconfigs.Config())
