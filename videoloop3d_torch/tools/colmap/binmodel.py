"""COLMAP binary sparse-model IO (cameras.bin / images.bin / points3D.bin).

Implemented from the public COLMAP binary format specification; readers
provide the subset the LLFF conversion needs (counterpart of the
reference's vendored colmap_read_model.py), plus writers used by the
roundtrip tests (the reference has no writers).

The port's own copy of ``videoloop3d_tpu/tools/colmap/binmodel.py``
(host numpy).
"""
from __future__ import annotations

import collections
import struct

import numpy as np

Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
Image = collections.namedtuple("Image",
                               ["id", "qvec", "tvec", "camera_id", "name",
                                "xys", "point3d_ids"])
Point3D = collections.namedtuple("Point3D",
                                 ["id", "xyz", "rgb", "error", "image_ids",
                                  "point2d_idxs"])

# model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def qvec_to_rotmat(q):
    """(w, x, y, z) quaternion -> 3x3 rotation (COLMAP convention)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat_to_qvec(R):
    """Inverse of qvec_to_rotmat (stable Shepperd-style extraction)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cid, model_id = _read(f, "<ii")
            width, height = _read(f, "<QQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cid] = Camera(cid, name, width, height, params)
    return out


def read_images_binary(path):
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            (iid,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * n2d),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"),
                                ("p3d", "<i8")]))
            xys = np.stack([data["x"], data["y"]], -1)
            out[iid] = Image(iid, qvec, tvec, cam_id, name.decode(), xys,
                             data["p3d"].copy())
    return out


def read_points3d_binary(path):
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (tlen,) = _read(f, "<Q")
            track = np.frombuffer(
                f.read(8 * tlen),
                dtype=np.dtype([("im", "<i4"), ("idx", "<i4")]))
            out[pid] = Point3D(pid, xyz, rgb, err, track["im"].copy(),
                               track["idx"].copy())
    return out


# --- writers (for fixtures/tests) ------------------------------------------

def write_cameras_binary(path, cameras):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = MODEL_IDS[cam.model]
            f.write(struct.pack("<ii", cam.id, mid))
            f.write(struct.pack("<QQ", cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(path, images):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(path, points):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for im, idx in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(im), int(idx)))
