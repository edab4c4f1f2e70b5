"""The port's COLMAP parsers and writers (`gaussian_splatting_torch/scene/colmap.py`)
against the JAX package's: each package reads the other's files, the
writers give the same bytes, and the analogs of test_scene_io.py's COLMAP
tests. Tolerance: everything equal (the formats are binary and text
copies of float64 values; the quaternion round trip within 1e-6, as
test_scene_io.py:102)."""

import numpy as np
import pytest

from gaussian_splatting_tpu.scene import colmap as jcolmap
from gaussian_splatting_torch.scene import colmap


def scene_records(pkg, seed=0, n_points=40):
    rng = np.random.default_rng(seed)
    cams = {
        1: pkg.ColmapCamera(id=1, model="PINHOLE", width=640, height=480,
                            params=np.array([500.0, 505.0, 320.0, 240.0])),
        3: pkg.ColmapCamera(id=3, model="SIMPLE_PINHOLE", width=33, height=17,
                            params=np.array([20.5, 16.0, 8.5])),
    }
    images = {}
    for iid, (cid, name, npts) in enumerate([(1, "img001.png", 7), (3, "b.png", 0), (1, "c.png", 3)]):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[iid + 5] = pkg.ColmapImage(
            id=iid + 5, qvec=q, tvec=rng.normal(size=3), camera_id=cid, name=name,
            xys=rng.normal(size=(npts, 2)) * 100, point3d_ids=rng.integers(-1, 1000, npts))
    xyz = rng.normal(size=(n_points, 3))
    rgb = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    err = rng.uniform(size=n_points)
    return cams, images, (xyz, rgb, err)


def write_all(pkg, d, records):
    cams, images, (xyz, rgb, err) = records
    pkg.write_cameras_binary(cams, str(d / "cameras.bin"))
    pkg.write_images_binary(images, str(d / "images.bin"))
    pkg.write_points3d_binary(xyz, rgb, err, str(d / "points3D.bin"))


def assert_same_records(got, want):
    (gc, gi, gp), (wc, wi, wp) = got, want
    assert gc.keys() == wc.keys() and gi.keys() == wi.keys()
    for k in wc:
        for f in ("id", "model", "width", "height"):
            assert getattr(gc[k], f) == getattr(wc[k], f)
        np.testing.assert_array_equal(gc[k].params, wc[k].params)
    for k in wi:
        for f in ("id", "camera_id", "name"):
            assert getattr(gi[k], f) == getattr(wi[k], f)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            a, b = getattr(gi[k], f), getattr(wi[k], f)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, f)
            np.testing.assert_array_equal(a, b)
    for a, b in zip(gp, wp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def read_all(pkg, d):
    return (pkg.read_cameras_binary(str(d / "cameras.bin")),
            pkg.read_images_binary(str(d / "images.bin")),
            pkg.read_points3d_binary(str(d / "points3D.bin")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_files_cross_packages(tmp_path, writer, monkeypatch):
    from gaussian_splatting_tpu.utils import native as jnative

    monkeypatch.setattr(jnative, "get_native", lambda: None)  # the JAX package's Python parser
    w_pkg = jcolmap if writer == "jax" else colmap
    write_all(w_pkg, tmp_path, scene_records(w_pkg))
    assert_same_records(read_all(colmap, tmp_path), read_all(jcolmap, tmp_path))


def test_writers_give_the_same_bytes(tmp_path):
    for name, pkg in (("jax", jcolmap), ("port", colmap)):
        (tmp_path / name).mkdir()
        write_all(pkg, tmp_path / name, scene_records(pkg, seed=4, n_points=257))
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def test_points3d_with_tracks(tmp_path):
    """Records with tracks of varying length (COLMAP's own files): the
    port's reader skips each track as the JAX package's does."""
    import struct

    from gaussian_splatting_tpu.utils import native as jnative

    rng = np.random.default_rng(5)
    n = 30
    xyz, rgb, err = rng.normal(size=(n, 3)), rng.integers(0, 256, (n, 3)), rng.uniform(size=n)
    with open(tmp_path / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", 100 + i, *xyz[i], *rgb[i], err[i]))
            t = int(rng.integers(0, 6))
            f.write(struct.pack("<Q", t) + rng.integers(0, 99, 2 * t).astype("<i4").tobytes())
    got = colmap.read_points3d_binary(str(tmp_path / "points3D.bin"))
    jnative_get = jnative.get_native
    try:
        jnative.get_native = lambda: None
        want = jcolmap.read_points3d_binary(str(tmp_path / "points3D.bin"))
    finally:
        jnative.get_native = jnative_get
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], xyz)


def test_text_readers_match_jax(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 640 480 500 505 320 240\n2 SIMPLE_PINHOLE 33 17 20.5 16 8.5\n")
    (tmp_path / "images.txt").write_text(
        "# Image list\n"
        "1 0.9 0.1 -0.3 0.2 1.5 -2 0.25 1 a.png\n"
        "10.5 20.25 7 -3 4.5 -1\n"
        "2 1 0 0 0 0 0 0 2 b.png\n"
        "0.5 0.5 -1\n"
        "3 0.5 0.5 0.5 0.5 1 2 3 1 c.png\n"
        "1 2 3\n")
    (tmp_path / "points3D.txt").write_text(
        "# 3D point list\n1 0.5 -1 2 255 0 12 0.75 1 2\n7 3 4 5 1 2 3 0.1\n")
    for name in ("cameras", "images"):
        got = getattr(colmap, f"read_{name}_text")(str(tmp_path / f"{name}.txt"))
        want = getattr(jcolmap, f"read_{name}_text")(str(tmp_path / f"{name}.txt"))
        assert got.keys() == want.keys()
        for k in want:
            for f, v in vars(want[k]).items():
                np.testing.assert_array_equal(getattr(got[k], f), v, err_msg=f"{name} {k} {f}")
    got = colmap.read_points3d_text(str(tmp_path / "points3D.txt"))
    want = jcolmap.read_points3d_text(str(tmp_path / "points3D.txt"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_colmap_binary_roundtrip(tmp_path):
    """test_scene_io.py:68 on the port."""
    cams = {
        1: colmap.ColmapCamera(id=1, model="PINHOLE", width=640, height=480,
                               params=np.array([500.0, 505.0, 320.0, 240.0]))
    }
    colmap.write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    back = colmap.read_cameras_binary(str(tmp_path / "cameras.bin"))
    assert back[1].model == "PINHOLE" and back[1].width == 640
    np.testing.assert_array_equal(back[1].params, cams[1].params)

    rng = np.random.default_rng(2)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    ims = {
        5: colmap.ColmapImage(
            id=5, qvec=q, tvec=rng.normal(size=3), camera_id=1, name="img001.png",
            xys=rng.normal(size=(7, 2)), point3d_ids=np.arange(7, dtype=np.int64),
        )
    }
    colmap.write_images_binary(ims, str(tmp_path / "images.bin"))
    back = colmap.read_images_binary(str(tmp_path / "images.bin"))
    assert back[5].name == "img001.png"
    np.testing.assert_allclose(back[5].qvec, q)
    np.testing.assert_array_equal(back[5].point3d_ids, ims[5].point3d_ids)

    xyz = rng.normal(size=(9, 3))
    rgb = rng.integers(0, 255, (9, 3)).astype(np.uint8)
    err = rng.uniform(size=9)
    colmap.write_points3d_binary(xyz, rgb, err, str(tmp_path / "points3D.bin"))
    x2, r2, e2 = colmap.read_points3d_binary(str(tmp_path / "points3D.bin"))
    np.testing.assert_allclose(x2, xyz)
    np.testing.assert_array_equal(r2, rgb)
    np.testing.assert_array_equal(e2, err)


@pytest.mark.parametrize("seed", [3, 11, 12])
def test_qvec_rotmat_roundtrip(seed):
    """test_scene_io.py:102 on the port, and the same matrices and
    quaternions as the JAX package's."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    R = colmap.qvec2rotmat(q)
    np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
    q2 = colmap.rotmat2qvec(R)
    np.testing.assert_array_equal(q2, jcolmap.rotmat2qvec(R))
    np.testing.assert_allclose(q2, q, atol=1e-6)
