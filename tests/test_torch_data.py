"""The port's capture I/O and data pipeline against the JAX package's:
PNG decode and encode (imageio and PIL as the reference), PIL's NEAREST
resize, the dataparser, dataset items, the step-indexed ray batcher, the
eval image rays and the frustum-culling grid, on a synthetic capture
(tests/synthetic_data.py) in a temporary directory. Everything here is
numpy on the host: equality is exact unless a test says otherwise."""

import dataclasses
import io
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import REPO  # noqa: F401  (puts the repo root on sys.path)

from nersemble_tpu.config import DataConfig as JDataConfig
from nersemble_tpu.data import dataparser as jdp
from nersemble_tpu.data import dataset as jds
from nersemble_tpu.data import ray_batcher as jrb
from nersemble_tpu.ops.occupancy import frustum_culling_grid as j_frustum_grid
from nersemble_tpu.utils.quantization import DepthQuantizer as JDepthQuantizer
from nersemble_tpu_torch.config import DataConfig
from nersemble_tpu_torch.data import dataparser as tdp
from nersemble_tpu_torch.data import dataset as tds
from nersemble_tpu_torch.data import ray_batcher as trb
from nersemble_tpu_torch.ops.occupancy import frustum_culling_grid
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils.quantization import DepthQuantizer
from tests.synthetic_data import make_synthetic_dataset

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# (shape, dtype) of the formats a capture and the writers produce
FORMATS = {"gray8": ((29, 37), np.uint8), "rgb8": ((29, 37, 3), np.uint8),
           "rgba8": ((29, 37, 4), np.uint8), "gray16": ((29, 37), np.uint16)}


def _image(name: str, seed: int = 0) -> np.ndarray:
    """Smooth content (small differences between neighbours, so the filters
    matter) with wrap-around, in the format ``name``."""
    shape, dtype = FORMATS[name]
    rng = np.random.default_rng(seed)
    walk = np.cumsum(np.cumsum(rng.integers(-9, 10, shape), 0), 1)
    return (walk % (np.iinfo(dtype).max + 1)).astype(dtype)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode_filtered(image: np.ndarray, filters) -> bytes:
    """A PNG whose row y uses filter ``filters[y % len(filters)]``, filtered
    byte by byte as the PNG specification writes it (the reference)."""
    img = image if image.ndim == 3 else image[:, :, None]
    height, width, channels = img.shape
    bpp = channels * img.dtype.itemsize
    raw = np.frombuffer(img.astype(img.dtype.newbyteorder(">")).tobytes(),
                        np.uint8).reshape(height, width * bpp).astype(int)
    out = bytearray()
    for y in range(height):
        kind = filters[y % len(filters)]
        out.append(kind)
        for x in range(width * bpp):
            a = raw[y, x - bpp] if x >= bpp else 0
            b = raw[y - 1, x] if y > 0 else 0
            c = raw[y - 1, x - bpp] if y > 0 and x >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            out.append((raw[y, x] - pred) % 256)
    reference = png.encode(image)
    head, tail = reference.index(b"IDAT") - 4, reference.index(b"IEND") - 4
    return reference[:head] + png._chunk(b"IDAT", zlib.compress(bytes(out))) \
        + reference[tail:]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_decodes_every_filter(fmt, filters):
    image = _image(fmt, seed=len(filters) + filters[0])
    data = _encode_filtered(image, filters)
    out = png.decode(data)
    assert out.dtype == image.dtype and np.array_equal(out, image)
    assert np.array_equal(out, iio.imread(data))  # the reference reads it alike


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("writer", ["imageio", "pil"])
def test_png_decodes_what_imageio_and_pil_write(fmt, writer):
    image = _image(fmt, seed=7)
    if writer == "imageio":
        data = iio.imwrite("<bytes>", image, extension=".png")
    else:
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        data = buf.getvalue()
    out = png.decode(data)
    assert out.dtype == image.dtype and out.shape == image.shape
    assert np.array_equal(out, image)
    assert np.array_equal(out, iio.imread(data))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_png_encode_reads_back_in_imageio(fmt, tmp_path):
    image = _image(fmt, seed=3)
    png.imwrite(tmp_path / "x.png", image)
    assert np.array_equal(iio.imread(tmp_path / "x.png"), image)
    assert png.image_size(tmp_path / "x.png") == Image.open(tmp_path / "x.png").size


# ---------------------------------------------------------------------------
# NEAREST resize (PIL's rule)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((550, 802), (275, 401)), ((550, 802), (1100, 1604)),
                                     ((1604, 1100), (550, 802)), ((13, 7), (29, 5)),
                                     ((100, 100), (33, 67)), ((802, 550), (551, 549)),
                                     ((3, 3), (10, 10))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_nearest_resize_is_pils(src, dst, dtype):
    rng = np.random.default_rng(src[0] + dst[1])
    image = (rng.uniform(size=src[::-1]) * 255).astype(dtype)
    ref = np.asarray(Image.fromarray(image).resize(dst, resample=Image.NEAREST))
    out = tds.resize_nearest(image, dst)
    assert out.dtype == image.dtype and np.array_equal(out, ref)


def test_bilinear_resize_is_not_ported():
    """Kept under its old name: an rgb image of another size, which the port
    used to refuse, is now resized as the JAX dataset resizes it (PIL's
    BILINEAR; tests/test_torch_resize_capture.py holds more shapes)."""
    image = np.random.default_rng(3).integers(0, 256, (44, 32, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(image).resize((16, 22), resample=Image.BILINEAR))
    assert np.array_equal(tds._resize(image, (16, 22)), ref)
    assert np.array_equal(tds._resize(image, (16, 22)), jds._resize(image, (16, 22)))


def test_depth_quantizer_matches():
    depth = np.random.default_rng(0).uniform(0, 2.5, (20, 30)).astype(np.float32)
    depth[::3, ::4] = 0
    q = DepthQuantizer().encode(depth)
    assert np.array_equal(q, JDepthQuantizer().encode(depth))
    assert np.array_equal(DepthQuantizer().decode(q), JDepthQuantizer().decode(q))


# ---------------------------------------------------------------------------
# the data pipeline on a synthetic capture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    make_synthetic_dataset(root, n_timesteps=5)
    return str(root)


VARIANTS = {"all": {}, "start": {"start_timestep": 1, "n_timesteps": 3},
            "skip": {"skip_timesteps": 2, "n_timesteps": -1},
            "eval2": {"max_eval_timesteps": 2, "n_timesteps": -1},
            "depth": {"use_depth_maps": True, "n_timesteps": 4}}


def _configs(variant: str):
    kwargs = dict(participant_id=30, sequence_name="SYN-1", n_timesteps=5,
                  scale_factor=9.0, use_alpha_maps=True,
                  train_num_rays_per_batch=512, train_num_images_to_sample_from=6,
                  train_num_times_to_repeat_images=4)
    kwargs.update(VARIANTS[variant])
    return JDataConfig(**kwargs), DataConfig(**kwargs)


def _parsers(capture, variant):
    from nersemble_tpu.data.multi_view_data import NeRSembleDataManager as JDM
    from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager as TDM
    jcfg, tcfg = _configs(variant)
    jp = jdp.NeRSembleDataParser(jcfg, JDM(30, "SYN-1", location=capture))
    tp = tdp.NeRSembleDataParser(tcfg, TDM(30, "SYN-1", location=capture))
    return (jcfg, jp), (tcfg, tp)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dataparser_outputs_match(capture, variant, split):
    (jcfg, jp), (tcfg, tp) = _parsers(capture, variant)
    assert tcfg.n_timesteps == jcfg.n_timesteps
    assert (tp._original_w, tp._original_h) == (jp._original_w, jp._original_h) == (64, 88)
    j, t = jp.generate_outputs(split), tp.generate_outputs(split)
    assert [dataclasses.asdict(e) for e in t.entries] == \
        [dataclasses.asdict(e) for e in j.entries]
    assert np.array_equal(t.c2w, j.c2w)
    assert dataclasses.asdict(t.intrinsics) == dataclasses.asdict(j.intrinsics)
    assert np.array_equal(t.scene_box, j.scene_box) and t.scene_box.dtype == j.scene_box.dtype
    for key in ("split", "cam_ids", "image_width", "image_height", "image_paths",
                "alpha_paths", "color_correction_paths", "depth_paths", "n_timesteps"):
        assert getattr(t, key) == getattr(j, key), key
    assert (t.frustums is None) == (j.frustums is None)
    for tf, jf in zip(t.frustums or [], j.frustums or []):
        assert np.array_equal(tf.normals, jf.normals) and np.array_equal(tf.center, jf.center)


def _datasets(capture, variant, split="train"):
    (jcfg, jp), (tcfg, tp) = _parsers(capture, variant)
    return (jds.NeRSembleDataset(jp.generate_outputs(split), jcfg),
            tds.NeRSembleDataset(tp.generate_outputs(split), tcfg))


@pytest.mark.parametrize("variant,split", [("all", "train"), ("depth", "train"),
                                           ("all", "val")])
def test_dataset_items_match(capture, variant, split):
    jd, td = _datasets(capture, variant, split)
    for idx in (0, 5, len(jd) - 1):
        j, t = jd[idx], td[idx]
        assert j.keys() == t.keys()
        for key in j:
            assert t[key].dtype == j[key].dtype and np.array_equal(t[key], j[key]), key


def test_dataset_resizes_depth_maps_like_pil(capture, tmp_path):
    """A depth map stored at another size than the images is resized with
    NEAREST; both packages read the same depth."""
    jd, td = _datasets(capture, "depth")
    path = td.outputs.depth_paths[3]
    big = tmp_path / "depth.png"
    quantized = png.imread(path)
    png.imwrite(big, np.repeat(np.repeat(quantized, 3, 0), 2, 1)[:-1])
    jd.outputs.depth_paths[3] = td.outputs.depth_paths[3] = str(big)
    assert np.array_equal(td[3]["depth"], jd[3]["depth"])


@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 11, 12, 40])
def test_ray_batches_are_bit_equal(capture, step):
    """Steps inside one image set and across set boundaries (4 steps/set)."""
    jd, td = _datasets(capture, "depth")
    j = jrb.RayBatcher(jd, jd.config, seed=11).batch_for_step(step)
    t = trb.RayBatcher(td, td.config, seed=11).batch_for_step(step)
    assert j.keys() == t.keys() and {"alpha", "depth"} <= set(t)
    for key in j:
        assert t[key].dtype == j[key].dtype and np.array_equal(t[key], j[key]), key


def test_device_batches_on_the_cpu_follow_the_steps(capture):
    _, td = _datasets(capture, "all")
    batcher = trb.RayBatcher(td, td.config, seed=3)
    batches = trb.DeviceBatches(batcher, 5, "cpu")
    try:
        for step in range(5, 10):
            got = next(batches)
            want = batcher.batch_for_step(step)
            assert set(got) == {k for k in trb.DEVICE_KEYS if k in want}
            for key, value in got.items():
                assert isinstance(value, torch.Tensor)
                assert np.array_equal(value.numpy(), want[key]), (step, key)
    finally:
        batches.close()
    assert not batches._thread.is_alive()


def test_device_batches_hand_on_the_thread_failure(capture):
    _, td = _datasets(capture, "all")
    batcher = trb.RayBatcher(td, td.config, seed=3)
    td.outputs.image_paths[:] = ["/nonexistent.png"] * len(td.outputs.image_paths)
    batches = trb.DeviceBatches(batcher, 0, "cpu")
    try:
        with pytest.raises(FileNotFoundError):
            next(batches)
    finally:
        batches.close()


@pytest.mark.parametrize("image_idx", [0, 7])
def test_eval_image_rays_match(capture, image_idx):
    jd, td = _datasets(capture, "eval2", "val")
    j = jrb.EvalImageLoader(jd).image_rays(image_idx)
    t = trb.EvalImageLoader(td).image_rays(image_idx)
    assert j.keys() == t.keys()
    for key in j:
        if isinstance(j[key], np.ndarray):
            assert t[key].dtype == j[key].dtype and np.array_equal(t[key], j[key]), key
        elif key == "entry":
            assert dataclasses.asdict(t[key]) == dataclasses.asdict(j[key])
        else:
            assert t[key] == j[key], key


@pytest.mark.parametrize("min_cameras", [2, 12])
def test_frustum_culling_grid_matches(capture, min_cameras):
    (_, jp), (_, tp) = _parsers(capture, "all")
    j, t = jp.generate_outputs("train"), tp.generate_outputs("train")
    box = t.scene_box
    ours = frustum_culling_grid(t.frustums, 24, box[0], box[1], min_cameras)
    theirs = j_frustum_grid(j.frustums, 24, box[0], box[1], min_cameras)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert ours.any()
