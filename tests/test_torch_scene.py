"""The port's dataset readers and `Scene` (`gaussian_splatting_torch/scene/
{dataset_readers,scene}.py`, `utils/general.py`) against the JAX package's.

Both packages read the same files after `safe_state` (each its own copy of
the dataset directory, since the readers cache a point cloud there) and
must give, exactly: the camera names in the same (shuffled) order, R, T,
fov, sizes, `cameras_extent`, `cameras.json`, the bytes of `input.ply`,
the random Blender init, and the ground-truth images of `load_camera`
bit for bit at -r 1, 2 and the 1600-pixel width cap (PIL's resize and the
port's `utils/image_io.resize`), from PNG and from JPEG files (PIL's
decoder and the port's compiled one, `utils/jpeg.py`).
"""

import io
import json
import os
import re
import shutil
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import colmap as jcolmap
from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_tpu.scene.scene import Scene as JaxScene
from gaussian_splatting_tpu.utils import general as jgeneral
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.scene.scene import Scene
from gaussian_splatting_torch.utils import general

sys.path.insert(0, os.path.dirname(__file__))

CAM_FIELDS = ("uid", "colmap_id", "R", "T", "fovx", "fovy", "image_name", "width", "height", "image")


def orbit(i, n, width, height):
    """(R (C2W), T) of a camera on a circle around the origin."""
    a = 2 * np.pi * i / n
    pos = np.array([4 * np.sin(a), 0.3 * np.cos(3 * a), -4 * np.cos(a)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return R, -R.T @ pos


def write_colmap_dataset(d, n_views=9, width=64, height=48, seed=0):
    """A COLMAP dataset written with the JAX package's writers and PIL's
    PNG encoder: RGB, RGBA and greyscale views, one PINHOLE camera."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "sparse", "0"))
    os.makedirs(os.path.join(d, "images"))
    fx = width / (2 * np.tan(np.radians(60) / 2))
    cams = {1: jcolmap.ColmapCamera(id=1, model="PINHOLE", width=width, height=height,
                                    params=np.array([fx, fx * 1.01, width / 2, height / 2]))}
    images = {}
    for i in range(n_views):
        R, T = orbit(i, n_views, width, height)
        name = f"view_{(7 * i) % n_views:02d}.png"  # ids out of name order
        images[i + 1] = jcolmap.ColmapImage(
            id=i + 1, qvec=jcolmap.rotmat2qvec(R.T), tvec=T, camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3d_ids=np.zeros((0,), np.int64))
        channels = (3, 4, 1)[i % 3]
        px = rng.integers(0, 256, (height, width, channels)).astype(np.uint8)
        imageio.imwrite(os.path.join(d, "images", name), px[..., 0] if channels == 1 else px)
    jcolmap.write_cameras_binary(cams, os.path.join(d, "sparse/0/cameras.bin"))
    jcolmap.write_images_binary(images, os.path.join(d, "sparse/0/images.bin"))
    n = 500
    jcolmap.write_points3d_binary(rng.normal(size=(n, 3)), rng.integers(0, 256, (n, 3)),
                                  rng.uniform(size=n), os.path.join(d, "sparse/0/points3D.bin"))


def jpeg_views(n_views, width, height, seed):
    """(name, PIL save options, pixels) of `n_views` smooth noisy views, as
    JPEG: RGB 4:2:0 baseline, grey, RGB 4:2:0 progressive in turn."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(n_views):
        waves = np.stack([128 + 90 * np.sin(xx / (9 + c + i) + yy / (5 + c)) for c in range(3)], -1)
        px = np.clip(waves + rng.normal(0, 12, waves.shape), 0, 255).astype(np.uint8)
        kind = i % 3
        options = dict(quality=90, subsampling="4:2:0", progressive=kind == 2)
        yield f"view_{(7 * i) % n_views:02d}.jpg", options, px[..., :1] if kind == 1 else px


def write_jpeg_colmap_dataset(d, n_views=9, width=1640, height=36, seed=1, n_points=500):
    """A COLMAP dataset whose images are JPEG written by PIL (`jpeg_views`),
    with the JAX package's COLMAP writers, one PINHOLE camera."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "sparse", "0"))
    os.makedirs(os.path.join(d, "images"))
    fx = width / (2 * np.tan(np.radians(60) / 2))
    cams = {1: jcolmap.ColmapCamera(id=1, model="PINHOLE", width=width, height=height,
                                    params=np.array([fx, fx, width / 2, height / 2]))}
    images = {}
    for i, (name, options, px) in enumerate(jpeg_views(n_views, width, height, seed)):
        R, T = orbit(i, n_views, width, height)
        images[i + 1] = jcolmap.ColmapImage(
            id=i + 1, qvec=jcolmap.rotmat2qvec(R.T), tvec=T, camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3d_ids=np.zeros((0,), np.int64))
        Image.fromarray(px[..., 0] if px.shape[2] == 1 else px).save(
            os.path.join(d, "images", name), "JPEG", **options)
    jcolmap.write_cameras_binary(cams, os.path.join(d, "sparse/0/cameras.bin"))
    jcolmap.write_images_binary(images, os.path.join(d, "sparse/0/images.bin"))
    jcolmap.write_points3d_binary(rng.normal(size=(n_points, 3)), rng.integers(0, 256, (n_points, 3)),
                                  rng.uniform(size=n_points), os.path.join(d, "sparse/0/points3D.bin"))


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("colmap") / "scene")
    write_colmap_dataset(d)
    return d


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    from make_synthetic_scene import make_blender_scene

    d = str(tmp_path_factory.mktemp("blender") / "scene")
    make_blender_scene(d, n_train=3, n_test=2)
    return d


def both_scenes(tmp_path, monkeypatch, source, **kw):
    """The JAX and the port Scene of one dataset, each from its own copy
    and after its package's safe_state(seed 0); sys.stdout is restored."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    out = []
    for name, cls, general_mod in (("jax", JaxScene, jgeneral), ("port", Scene, general)):
        src = str(tmp_path / name / "data")
        shutil.copytree(source, src)
        general_mod.safe_state(silent=True)
        out.append(cls(source_path=src, model_path=str(tmp_path / name / "model"), **kw))
    return out


def assert_same_cameras(got, want):
    assert [c.image_name for c in got] == [c.image_name for c in want]
    for g, w in zip(got, want):
        for f in CAM_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f"{w.image_name} {f}")
            else:
                assert a == b, (w.image_name, f, a, b)


def assert_same_model_dirs(tmp_path):
    for f in ("input.ply", "cameras.json"):
        assert (tmp_path / "port/model" / f).read_bytes() == (tmp_path / "jax/model" / f).read_bytes(), f


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_scene_matches_jax(tmp_path, monkeypatch, colmap_dir, resolution):
    jscene, scene = both_scenes(tmp_path, monkeypatch, colmap_dir, eval_split=True,
                                resolution=resolution)
    assert len(scene.get_train_cameras()) == 7 and len(scene.get_test_cameras()) == 2
    assert scene.cameras_extent == jscene.cameras_extent
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())
    assert scene.get_train_cameras()[0].width == 64 // resolution
    assert_same_model_dirs(tmp_path)
    for a, b in zip((scene.info.points, scene.info.colors, scene.info.normals),
                    (jscene.info.points, jscene.info.colors, jscene.info.normals)):
        np.testing.assert_array_equal(a, b)
    names = [c.image_name for c in scene.get_train_cameras()]
    assert names != sorted(names), "the train cameras were not shuffled"


@pytest.mark.parametrize("resolution", [1, 2, -1])
def test_jpeg_colmap_scene_matches_jax(tmp_path, monkeypatch, resolution):
    """JPEG views (4:2:0, grey, progressive) 1640 wide: the port's compiled
    decoder and resize give the JAX package's images bit for bit at -r 1,
    -r 2, and -r -1, which scales them to the 1600-pixel cap."""
    src = str(tmp_path / "jpeg_colmap")
    write_jpeg_colmap_dataset(src)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())
    width = {1: 1640, 2: 820, -1: 1600}[resolution]
    assert {c.width for c in scene.get_train_cameras() + scene.get_test_cameras()} == {width}


def test_blender_jpeg_frames_match_jax(tmp_path):
    """The Blender reader on .jpg frames (`extension=".jpg"`, as a
    transforms file without extensions asks): RGB and grey frames, then
    load_camera at -r 2."""
    d = tmp_path / "scene"
    (d / "train").mkdir(parents=True)
    frames = []
    for i, (_, options, px) in enumerate(jpeg_views(3, 40, 24, seed=5)):
        Image.fromarray(px[..., 0] if px.shape[2] == 1 else px).save(d / "train" / f"r_{i}.jpg", "JPEG",
                                                                     **options)
        c2w = np.eye(4)
        c2w[:3, 3] = [0.0, 0.0, 4.0 + i]
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    got = dataset_readers._read_transforms(str(d), "transforms_train.json", False, ".jpg")
    want = jreaders._read_transforms(str(d), "transforms_train.json", False, ".jpg")
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, np.asarray(w.image))
        assert (g.width, g.height, g.image_path) == (w.width, w.height, w.image_path)
        assert_same_cameras([dataset_readers.load_camera(g, 2)], [jreaders.load_camera(w, 2)])


def test_unreadable_image_names_the_listing(tmp_path):
    """An image the port cannot read raises naming it as images.bin lists it."""
    src = str(tmp_path / "data")
    write_jpeg_colmap_dataset(src, n_views=2, width=32, height=16)
    msp = io.BytesIO()
    Image.new("1", (4, 4), 1).save(msp, "MSP")
    (tmp_path / "data" / "images" / "view_00.jpg").write_bytes(msp.getvalue())  # PIL reads MSP, the port does not
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    bad = [c for c in info.train_cameras if c.image_name == "view_00"][0]
    with pytest.raises(ValueError, match=r"'view_00.jpg' in .*images\.bin: .*view_00\.jpg: not a PNG, JPEG, BMP, "
                                         r"DIB, TIFF, WebP, GIF, PPM / PGM / PBM / PFM, TGA, JPEG 2000, QOI, "
                                         r"PCX / DCX, SGI, ICO / CUR, PSD, DDS, AVIF, BLP, FITS, FLI / FLC, FTEX, "
                                         r"GBR, ICNS or EPS file"):
        dataset_readers.load_camera(bad, 1)


def test_blender_scene_matches_jax(tmp_path, monkeypatch, blender_dir):
    """The random init is drawn from the global np.random after safe_state
    in both packages: equal points and colours, equal input.ply."""
    jscene, scene = both_scenes(tmp_path, monkeypatch, blender_dir, eval_split=True, resolution=1)
    expected_pts = int(os.environ.get("GS_TPU_BLENDER_INIT_POINTS", 100_000))
    assert scene.info.points.shape == (expected_pts, 3)
    np.testing.assert_array_equal(scene.info.points, jscene.info.points)
    np.testing.assert_array_equal(scene.info.colors, jscene.info.colors)
    assert scene.cameras_extent == jscene.cameras_extent
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())
    assert_same_model_dirs(tmp_path)
    with open(tmp_path / "port/model/cameras.json") as f:
        assert len(json.load(f)) == 5


def orbit_frames(n):
    out = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.3 * np.sin(i), 0.0, 4.0 + 0.1 * i]
        out.append(c2w.tolist())
    return out


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_every_png_form_matches_jax(tmp_path, monkeypatch, white_background):
    """read_blender_scene on a dataset whose frames take every PNG form PIL
    reads (palette at 1 to 8 bits with and without tRNS, grey at 1 to 16
    bits, 16-bit RGB, RGBA and grey + alpha, tRNS on grey and RGB, Adam7):
    PIL's convert("RGBA") through the composite, bit for bit, then
    load_camera at -r 2 for each."""
    from test_torch_image_io import form_cases

    forms = form_cases()
    d = tmp_path / "scene"
    (d / "train").mkdir(parents=True)
    frames = []
    for i, (name, data) in enumerate(forms.items()):
        (d / "train" / f"r_{i}.png").write_bytes(data)
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": orbit_frames(len(forms))[i]})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    monkeypatch.setenv("GS_TPU_BLENDER_INIT_POINTS", "50")
    infos = []
    for pkg, name in ((jreaders, "jax"), (dataset_readers, "port")):
        shutil.copytree(d, tmp_path / name)
        np.random.seed(3)
        infos.append(pkg.read_blender_scene(str(tmp_path / name), white_background, eval_split=False))
    want, got = infos
    assert len(got.train_cameras) == len(forms)
    np.testing.assert_array_equal(got.points, want.points)
    for name, g, w in zip(forms, got.train_cameras, want.train_cameras):
        np.testing.assert_array_equal(g.image, np.asarray(w.image), err_msg=name)
        assert (g.width, g.height, g.fovx, g.fovy) == (w.width, w.height, w.fovx, w.fovy), name
        assert_same_cameras([dataset_readers.load_camera(g, 2)], [jreaders.load_camera(w, 2)])


def write_png_colmap_dataset(d, views):
    """A COLMAP dataset of `views` (name -> PNG bytes) with the JAX
    package's writers, one PINHOLE camera."""
    os.makedirs(os.path.join(d, "sparse", "0"))
    os.makedirs(os.path.join(d, "images"))
    width, height = 13, 11
    cams = {1: jcolmap.ColmapCamera(id=1, model="PINHOLE", width=width, height=height,
                                    params=np.array([12.0, 12.0, width / 2, height / 2]))}
    images = {}
    for i, (name, data) in enumerate(views.items()):
        R, T = orbit(i, len(views), width, height)
        images[i + 1] = jcolmap.ColmapImage(
            id=i + 1, qvec=jcolmap.rotmat2qvec(R.T), tvec=T, camera_id=1, name=f"{name}.png",
            xys=np.zeros((0, 2)), point3d_ids=np.zeros((0,), np.int64))
        with open(os.path.join(d, "images", f"{name}.png"), "wb") as f:
            f.write(data)
    jcolmap.write_cameras_binary(cams, os.path.join(d, "sparse/0/cameras.bin"))
    jcolmap.write_images_binary(images, os.path.join(d, "sparse/0/images.bin"))
    rng = np.random.default_rng(2)
    jcolmap.write_points3d_binary(rng.normal(size=(50, 3)), rng.integers(0, 256, (50, 3)),
                                  rng.uniform(size=50), os.path.join(d, "sparse/0/points3D.bin"))


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_png_forms_match_jax(tmp_path, monkeypatch, resolution):
    """COLMAP views in the forms whose np.asarray is the picture: 16-bit
    RGB, RGBA and grey + alpha (their high bytes), Adam7 and tRNS (which
    the path ignores): the Scene's cameras equal the JAX package's."""
    from test_torch_image_io import form_cases

    forms = form_cases()
    keep = ["RGB 16-bit", "RGBA 16-bit", "grey + alpha 16-bit", "RGB 8-bit tRNS", "RGB 16-bit tRNS",
            "grey 8-bit tRNS", "Adam7 RGB 16-bit", "Adam7 RGBA 8-bit", "Adam7 grey 2-bit",
            "Adam7 RGB 8-bit tRNS", "grey 4-bit"]
    src = str(tmp_path / "png_colmap")
    write_png_colmap_dataset(src, {k.replace(" ", "_").replace("+", "p"): forms[k] for k in keep})
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(keep)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@pytest.mark.parametrize("form,mode", [("palette 8-bit", "P"), ("grey 1-bit", "1"), ("grey 16-bit", "I;16"),
                                       ("grey + alpha 8-bit", "LA")])
def test_colmap_refuses_modes_that_are_not_the_picture(tmp_path, form, mode):
    """The JAX package's COLMAP path trains on np.asarray of the resized
    image, which for these modes is palette indices, 0 or 1, 16-bit
    values, or grey and alpha as two channels: not the picture. The port
    refuses them, naming the file. A 16-bit grey + alpha PNG is mode RGBA
    in PIL (grey repeated to RGB), the picture: both packages train on it,
    and it stays in test_colmap_png_forms_match_jax."""
    from test_torch_image_io import form_cases

    src = str(tmp_path / "data")
    write_png_colmap_dataset(src, {"view": form_cases()[form]})
    path = os.path.join(src, "images", "view.png")
    assert Image.open(path).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"images\.bin: .*view\.png: .*\(mode {re.escape(mode)}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)
    jinfo = jreaders.read_colmap_scene(src, None, eval_split=False)
    gt = np.asarray(jreaders.load_camera(jinfo.train_cameras[0], 1).image)
    assert gt.max() <= 1.0  # the JAX package trains on these numbers


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_alpha_composite_matches_jax(tmp_path, white_background):
    """RGBA frames with partial alpha: the composite over the background
    and its truncation to uint8, then load_camera at -r 2."""
    rng = np.random.default_rng(4)
    d = tmp_path / "scene"
    (d / "train").mkdir(parents=True)
    frames = []
    for i in range(2):
        px = rng.integers(0, 256, (24, 40, 4)).astype(np.uint8)
        imageio.imwrite(d / "train" / f"r_{i}.png", px)
        c2w = np.eye(4)
        c2w[:3, 3] = [0.0, 0.0, 4.0 + i]
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    got = dataset_readers._read_transforms(str(d), "transforms_train.json", white_background)
    want = jreaders._read_transforms(str(d), "transforms_train.json", white_background)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, np.asarray(w.image))
        np.testing.assert_array_equal(g.R, w.R)
        np.testing.assert_array_equal(g.T, w.T)
        assert (g.fovx, g.fovy, g.width, g.height) == (w.fovx, w.fovy, w.width, w.height)
        assert_same_cameras([dataset_readers.load_camera(g, 2)], [jreaders.load_camera(w, 2)])


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("resolution", [-1, 4, 50])
def test_load_camera_policy_matches_jax(tmp_path, channels, resolution):
    """The width cap (1700 -> 1600 wide at -r -1), -r 4 and a target width
    (-r 50), on L, RGB and RGBA files: bit-equal images."""
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (40, 1700, channels)).astype(np.uint8)
    path = str(tmp_path / "wide.png")
    imageio.imwrite(path, px[..., 0] if channels == 1 else px)
    kw = dict(uid=3, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.2, fovy=0.1,
              image_path=path, image_name="wide", width=1700, height=40)
    got = dataset_readers.load_camera(dataset_readers.CameraInfo(**kw), resolution)
    want = jreaders.load_camera(jreaders.CameraInfo(**kw), resolution)
    assert_same_cameras([got], [want])
    if resolution == -1:
        assert (got.width, got.height) == (1600, 37)


def test_camera_json_and_nerfpp_norm_match_jax(colmap_dir):
    cams = dataset_readers.read_colmap_scene(colmap_dir, None, eval_split=False).train_cameras
    jcams = jreaders.read_colmap_scene(colmap_dir, None, eval_split=False).train_cameras
    assert dataset_readers.get_nerfpp_norm(cams)["radius"] == jreaders.get_nerfpp_norm(jcams)["radius"]
    for i, (c, jc) in enumerate(zip(cams, jcams)):
        assert dataset_readers.camera_to_json(i, c) == jreaders.camera_to_json(i, jc)


def test_write_colmap_scene_reads_back(tmp_path):
    """The port's dataset writer: cameras back within 1e-12, pixels bit for
    bit, points exactly, through both packages' readers."""
    from gaussian_splatting_torch.scene.cameras import Camera

    rng = np.random.default_rng(9)
    cams, images = [], []
    for i in range(4):
        R, T = orbit(i, 4, 40, 30)
        cams.append(Camera(uid=0, colmap_id=0, R=R, T=T, fovx=1.1, fovy=0.9, image=None,
                           image_name=f"v{i}", width=40, height=30))
        images.append(rng.integers(0, 256, (30, 40, 3)).astype(np.uint8))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    dataset_readers.write_colmap_scene(str(tmp_path), cams, images, pts, colors)
    for readers in (dataset_readers, jreaders):
        info = readers.read_colmap_scene(str(tmp_path), None, eval_split=False)
        assert [c.image_name for c in info.train_cameras] == ["v0", "v1", "v2", "v3"]
        for c, cam, px in zip(info.train_cameras, cams, images):
            np.testing.assert_allclose(c.R, cam.R, rtol=0, atol=1e-12)
            np.testing.assert_allclose(c.T, cam.T, rtol=0, atol=1e-12)
            assert abs(c.fovx - 1.1) < 1e-12 and abs(c.fovy - 0.9) < 1e-12
            got = readers.load_camera(c, 1).image
            np.testing.assert_array_equal(got, px.transpose(2, 0, 1).astype(np.float32) / 255.0)
        np.testing.assert_array_equal(info.points, pts)
        np.testing.assert_array_equal(info.colors, colors.astype(np.float32) / 255.0)
        os.remove(tmp_path / "sparse/0/points3D.ply")


def test_general_utils_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    for name in ("iteration_7", "iteration_30000", "iteration_200"):
        (tmp_path / name).mkdir()
    assert general.search_for_max_iteration(str(tmp_path)) == 30000
    assert jgeneral.search_for_max_iteration(str(tmp_path)) == 30000
    general.mkdir_p(str(tmp_path / "a" / "b"))
    general.mkdir_p(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    import random

    import torch

    general.safe_state(silent=True, seed=3)
    draws = (random.random(), np.random.random(), float(torch.rand(())))
    jgeneral.safe_state(silent=True, seed=3)
    torch.manual_seed(3)
    assert draws == (random.random(), np.random.random(), float(torch.rand(())))
