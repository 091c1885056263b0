"""ctypes bindings for the native rig bundle adjuster
(port of ``ucnerf_tpu/pose/rigba/__init__.py``, the same C API).

The port keeps its own copy of the source, ``ucnerf_tpu_torch/csrc/rigba.cc``,
which ``ops/build.py`` compiles with g++ (the JAX package's flags) into
``ucnerf_tpu_torch/_build/librigba.so`` at first use; the C API operates on
flat float64/int32 numpy arrays.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ucnerf_tpu_torch.ops import build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load("rigba")
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    up = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rigba_solve.restype = ctypes.c_int
    lib.rigba_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, dp, dp, ip, ip, ip, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rigba_triangulate.restype = ctypes.c_int
    lib.rigba_triangulate.argtypes = [
        ctypes.c_int, ctypes.c_int, ip, ip, ip, dp, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, dp, up,
    ]
    _lib = lib
    return lib


def solve(rig_qvecs, rig_tvecs, rel_qvecs, rel_tvecs, points, intrinsics,
          obs_snapshot, obs_camera, obs_point, obs_xy, *,
          fix_rig_poses=False, fix_rel_rot=False, fix_rel_trans=False,
          fix_points=False, ref_camera=0, max_iterations=50,
          huber_delta=4.0, verbose=False):
    """Run the rig BA; returns (rig_qvecs, rig_tvecs, rel_qvecs, rel_tvecs,
    points, final robust cost).  Pose and point arrays that are contiguous
    float64 are updated in place, as in the JAX package.

    The UC-NeRF configuration (`fix_trans_refine_rot`,
    bundle_adjustment.cc:1055-1061) is fix_rel_trans=True with relative
    rotations free.
    """
    lib = _load()
    arrs = dict(
        rig_qvecs=np.ascontiguousarray(rig_qvecs, np.float64),
        rig_tvecs=np.ascontiguousarray(rig_tvecs, np.float64),
        rel_qvecs=np.ascontiguousarray(rel_qvecs, np.float64),
        rel_tvecs=np.ascontiguousarray(rel_tvecs, np.float64),
        points=np.ascontiguousarray(points, np.float64),
    )
    intr = np.ascontiguousarray(intrinsics, np.float64)
    osn = np.ascontiguousarray(obs_snapshot, np.int32)
    oca = np.ascontiguousarray(obs_camera, np.int32)
    opt = np.ascontiguousarray(obs_point, np.int32)
    oxy = np.ascontiguousarray(obs_xy, np.float64)
    cost = ctypes.c_double(0.0)
    ret = lib.rigba_solve(
        len(arrs["rig_qvecs"]), len(arrs["rel_qvecs"]), len(arrs["points"]),
        len(oxy), arrs["rig_qvecs"], arrs["rig_tvecs"], arrs["rel_qvecs"],
        arrs["rel_tvecs"], arrs["points"], intr, osn, oca, opt, oxy,
        int(fix_rig_poses), int(fix_rel_rot), int(fix_rel_trans),
        int(fix_points), int(ref_camera), int(max_iterations),
        float(huber_delta), int(verbose), ctypes.byref(cost))
    if ret != 0:
        raise RuntimeError(f"rigba_solve failed: {ret}")
    return (arrs["rig_qvecs"], arrs["rig_tvecs"], arrs["rel_qvecs"],
            arrs["rel_tvecs"], arrs["points"], cost.value)


def triangulate(num_points, obs_snapshot, obs_camera, obs_point, obs_xy,
                rig_qvecs, rig_tvecs, rel_qvecs, rel_tvecs, intrinsics,
                max_error=4.0):
    """DLT triangulation with fixed poses; returns (points, valid_mask)."""
    lib = _load()
    osn = np.ascontiguousarray(obs_snapshot, np.int32)
    oca = np.ascontiguousarray(obs_camera, np.int32)
    opt = np.ascontiguousarray(obs_point, np.int32)
    oxy = np.ascontiguousarray(obs_xy, np.float64)
    rq = np.ascontiguousarray(rig_qvecs, np.float64)
    rt = np.ascontiguousarray(rig_tvecs, np.float64)
    cq = np.ascontiguousarray(rel_qvecs, np.float64)
    ct = np.ascontiguousarray(rel_tvecs, np.float64)
    intr = np.ascontiguousarray(intrinsics, np.float64)
    pts = np.zeros((num_points, 3), np.float64)
    valid = np.zeros(num_points, np.uint8)
    lib.rigba_triangulate(num_points, len(oxy), osn, oca, opt, oxy, rq, rt,
                          cq, ct, intr, len(rq), len(cq), float(max_error),
                          pts, valid)
    return pts, valid.astype(bool)
