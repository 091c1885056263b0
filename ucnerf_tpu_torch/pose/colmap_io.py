"""COLMAP model + database interop (pure Python; a copy of
``ucnerf_tpu/pose/colmap_io.py``, which is numpy, struct and sqlite3).

Replaces the reference's vendored pycolmap reader
(``nerf/internal/pycolmap/``) and the sqlite database writer
(``pose_refinement/stpr/scripts/mvs/database.py``): read/write COLMAP
cameras/images/points3D in binary and text form, and create a COLMAP-schema
sqlite database with cameras, images, keypoints, descriptors and two-view
geometries — enough to hand our features/matches to a stock COLMAP binary or
ingest its output.
"""

from __future__ import annotations

import collections
import os
import sqlite3
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height",
                                           "params"])
Image = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id",
                                         "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error",
                                             "image_ids", "point2D_idxs"])

# COLMAP camera model ids -> (name, num_params).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model, w, h = _read(f, "<iiQQ")
            num_params = CAMERA_MODELS[model][1]
            params = np.array(_read(f, "<" + "d" * num_params))
            out[cid] = Camera(cid, CAMERA_MODELS[model][0], w, h, params)
    return out


def write_cameras_binary(cameras: Dict[int, Camera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_images_binary(path) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<I")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            (cam_id,) = _read(f, "<I")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * npts),
                dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            xys = np.stack([data["x"], data["y"]], -1)
            out[iid] = Image(iid, qvec, tvec, cam_id, name.decode(), xys,
                             data["id"].copy())
    return out


def write_images_binary(images: Dict[int, Image], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<I", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<I", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def read_points3D_binary(path) -> Dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<ddd"))
            rgb = np.array(_read(f, "<BBB"))
            (err,) = _read(f, "<d")
            (tlen,) = _read(f, "<Q")
            data = np.frombuffer(f.read(8 * tlen),
                                 dtype=[("img", "<i4"), ("p2d", "<i4")])
            out[pid] = Point3D(pid, xyz, rgb, err, data["img"].copy(),
                               data["p2d"].copy())
    return out


def write_points3D_binary(points: Dict[int, Point3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *np.asarray(p.rgb, np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img, p2d in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(img), int(p2d)))


def write_cameras_text(cameras: Dict[int, Camera], path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(str(p) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def write_images_text(images: Dict[int, Image], path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(f"{x} {y} {int(pid)}"
                           for (x, y), pid in zip(im.xys, im.point3D_ids))
            f.write(pts + "\n")


# ---------------------------------------------------------------------------
# COLMAP sqlite database (schema-compatible with COLMAP 3.x).

_DB_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL, model INTEGER NOT NULL,
    width INTEGER NOT NULL, height INTEGER NOT NULL, params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
    cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
    cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
    cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
    cols INTEGER NOT NULL, data BLOB, config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * 2147483647 + image_id2


class ColmapDatabase:
    """Minimal COLMAP-schema sqlite writer (database.py equivalent)."""

    def __init__(self, path):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_DB_SCHEMA)

    def add_camera(self, model: str, width: int, height: int, params,
                   camera_id=None, prior_focal=True):
        mid = CAMERA_MODEL_IDS[model]
        blob = np.asarray(params, np.float64).tobytes()
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, mid, width, height, blob, int(prior_focal)))
        return cur.lastrowid

    def add_image(self, name, camera_id, qvec=None, tvec=None,
                  image_id=None):
        q = list(qvec) if qvec is not None else [None] * 4
        t = list(tvec) if tvec is not None else [None] * 3
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *q, *t))
        return cur.lastrowid

    def add_keypoints(self, image_id, keypoints):
        kp = np.asarray(keypoints, np.float32)
        if kp.shape[1] == 2:  # pad to COLMAP's (x, y, scale, orientation)
            kp = np.concatenate(
                [kp, np.ones((len(kp), 1), np.float32),
                 np.zeros((len(kp), 1), np.float32)], axis=1)
        self.conn.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                          (image_id, kp.shape[0], kp.shape[1], kp.tobytes()))

    def add_descriptors(self, image_id, descriptors):
        d = np.asarray(descriptors)
        self.conn.execute("INSERT INTO descriptors VALUES (?, ?, ?, ?)",
                          (image_id, d.shape[0], d.shape[1], d.tobytes()))

    def add_matches(self, image_id1, image_id2, matches):
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                          (pair_id(image_id1, image_id2), m.shape[0],
                           m.shape[1], m.tobytes()))

    def add_two_view_geometry(self, image_id1, image_id2, matches,
                              F=None, E=None, H=None, config=2):
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        eye = np.eye(3).tobytes()
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?,"
            " ?, ?)",
            (pair_id(image_id1, image_id2), m.shape[0], m.shape[1],
             m.tobytes(), config,
             np.asarray(F, np.float64).tobytes() if F is not None else eye,
             np.asarray(E, np.float64).tobytes() if E is not None else eye,
             np.asarray(H, np.float64).tobytes() if H is not None else eye,
             np.array([1.0, 0, 0, 0]).tobytes(),
             np.zeros(3).tobytes()))

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()
