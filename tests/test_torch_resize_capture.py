"""The port's BILINEAR resize and textured synthetic capture against the JAX
package: ``resize_bilinear`` equals PIL's ``Image.resize(..., BILINEAR)``
(what nersemble_tpu.data.dataset._resize calls) bit for bit, the dataset
reads a capture whose rgb and alpha maps are stored at another size into
the JAX dataset's arrays, and the textured, squashed capture's files decode
to tests/synthetic_data.py's."""

import json
from pathlib import Path

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image
from torch_parity import REPO  # noqa: F401  (puts the repo root on sys.path)

from nersemble_tpu.config import DataConfig as JDataConfig
from nersemble_tpu.data import dataparser as jdp
from nersemble_tpu.data import dataset as jds
from nersemble_tpu.data.multi_view_data import NeRSembleDataManager as JDM
from nersemble_tpu_torch.config import DataConfig
from nersemble_tpu_torch.data import dataparser as tdp
from nersemble_tpu_torch.data import dataset as tds
from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager as TDM
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils import synthetic_capture as tsc
from tests import synthetic_data as jsc

# (source (width, height), target (width, height)): 2x and 4x down, ratios
# that are not integers, one-pixel edges and sizes, and upscaling
RESIZE_CASES = {
    "2x-down": ((352, 256), (176, 128)),
    "4x-down": ((352, 256), (88, 64)),
    "352-to-250": ((352, 200), (250, 143)),
    "non-integer-both": ((100, 100), (33, 67)),
    "near-identity": ((550, 802), (549, 801)),
    "one-row": ((37, 1), (12, 1)),
    "one-column": ((1, 41), (1, 9)),
    "to-one-pixel": ((7, 5), (1, 1)),
    "from-one-pixel": ((1, 1), (5, 3)),
    "width-only": ((64, 88), (40, 88)),
    "height-only": ((64, 88), (64, 50)),
    "2x-up": ((64, 88), (128, 176)),
    "non-integer-up": ((13, 7), (29, 17)),
    "mixed": ((300, 20), (97, 61)),
}


@pytest.mark.parametrize("channels", [3, None], ids=["rgb", "alpha"])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_bilinear_resize_is_pils_bit_for_bit(case, channels):
    src, dst = RESIZE_CASES[case]
    rng = np.random.default_rng(sum(src) * 31 + sum(dst))
    shape = src[::-1] + ((channels,) if channels else ())
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    # a smooth ramp with hard edges, where rounding ties are more likely
    image[: shape[0] // 2] = (np.arange(src[0]) * 255 // max(src[0] - 1, 1)).astype(
        np.uint8).reshape((1, src[0]) + ((1,) if channels else ()))
    ref = np.asarray(Image.fromarray(image).resize(dst, resample=Image.BILINEAR))
    out = tds.resize_bilinear(image, dst)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    assert np.array_equal(out, ref)
    # the JAX dataset's resize is PIL's
    assert np.array_equal(tds._resize(image, dst), jds._resize(image, dst))


def test_bilinear_resize_takes_uint8_only():
    with pytest.raises(TypeError, match="uint8"):
        tds.resize_bilinear(np.zeros((4, 4), np.float32), (2, 2))


# ---------------------------------------------------------------------------
# the dataset on a capture stored at other sizes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resized_capture(tmp_path_factory):
    """A tiny capture whose alpha maps of timestep 0 are stored at 2x, 3x
    down and a non-integer size, and one rgb image at another size."""
    root = tmp_path_factory.mktemp("capture")
    jsc.make_synthetic_dataset(root, n_timesteps=2)
    frame = root / "030" / "sequences" / "SYN-1" / "frame_00000"
    alphas = sorted((frame / "alpha_map-73fps").glob("cam_*.png"))
    sizes = [(64, 88), (11, 15), (45, 70), (33, 44)]
    for path, size in zip(alphas, sizes * (len(alphas) // len(sizes))):
        alpha = iio.imread(path)
        png.imwrite(path, np.asarray(Image.fromarray(alpha).resize(size, Image.BILINEAR)))
    image = sorted((frame / "images-2x-73fps").glob("cam_*.png"))[1]
    png.imwrite(image, np.asarray(Image.fromarray(iio.imread(image)).resize(
        (50, 61), Image.BILINEAR)))
    return str(root)


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_resizes_rgb_and_alpha_like_the_jax_dataset(resized_capture, split):
    kwargs = dict(participant_id=30, sequence_name="SYN-1", n_timesteps=2,
                  scale_factor=9.0, use_alpha_maps=True, use_depth_maps=True)
    jcfg, tcfg = JDataConfig(**kwargs), DataConfig(**kwargs)
    jp = jdp.NeRSembleDataParser(jcfg, JDM(30, "SYN-1", location=resized_capture))
    tp = tdp.NeRSembleDataParser(tcfg, TDM(30, "SYN-1", location=resized_capture))
    jd = jds.NeRSembleDataset(jp.generate_outputs(split), jcfg)
    td = tds.NeRSembleDataset(tp.generate_outputs(split), tcfg)
    stored = [png.image_size(p) for p in td.outputs.alpha_paths]
    assert len(set(stored)) > 1  # some alpha maps are stored at other sizes
    for idx in range(len(jd)):
        j, t = jd[idx], td[idx]
        assert j.keys() == t.keys() and {"rgb", "alpha"} <= set(t)
        for key in j:
            assert t[key].dtype == j[key].dtype and np.array_equal(t[key], j[key]), \
                (idx, key)


# ---------------------------------------------------------------------------
# the textured capture
# ---------------------------------------------------------------------------

def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("texture,squash,style", [
    (True, 0.15, "default"), (True, 0.15, "sharp"), (True, 0.0, "sharp"),
    (False, 0.3, "default")], ids=["default-squash", "sharp-squash", "sharp", "squash"])
def test_textured_capture_matches_the_jax_generator(tmp_path, texture, squash, style):
    kwargs = dict(sequence_name="SYN-Q", n_timesteps=3, original_size=(48, 64),
                  texture=texture, squash=squash, texture_style=style)
    jmeta = jsc.make_synthetic_dataset(tmp_path / "jax", **kwargs)
    tmeta = tsc.make_synthetic_dataset(tmp_path / "port", **kwargs)
    assert tmeta["original_size"] == jmeta["original_size"]
    assert np.array_equal(tmeta["intrinsics_full"], jmeta["intrinsics_full"])
    assert all(np.array_equal(tmeta["poses"][s], jmeta["poses"][s]) for s in jmeta["poses"])
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and len(files) == 16 * 3 * 3 + 16 + 1
    for rel in files:
        ours, theirs = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".png":
            a, b = png.imread(ours), iio.imread(theirs)
            assert a.dtype == b.dtype and np.array_equal(a, b), rel
        elif rel.suffix == ".json":
            assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
        else:
            assert np.array_equal(np.load(ours), np.load(theirs)), rel


@pytest.mark.parametrize("style", ["default", "sharp"])
def test_surface_texture_and_squash_match(style):
    rng = np.random.default_rng(7)
    normals = rng.normal(size=(500, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    assert np.array_equal(tsc.surface_texture(normals, style),
                          jsc.surface_texture(normals, style))
    for t in (0.0, 0.3, 1.0):
        assert tsc.squash_factor(t, 0.15) == jsc.squash_factor(t, 0.15)


def test_write_capture_is_the_untextured_generator(tmp_path):
    """``write_capture`` (phases 12-14 of chip_smoke.py) writes the
    untextured sphere: the JAX generator's files at the same size."""
    tsc.write_capture(tmp_path / "port", 30, "SYN-W", n_timesteps=2, original_size=(40, 56))
    jsc.make_synthetic_dataset(tmp_path / "jax", 30, "SYN-W", n_timesteps=2,
                               original_size=(40, 56))
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    for rel in files:
        if rel.suffix == ".png":
            assert np.array_equal(png.imread(tmp_path / "port" / rel),
                                  iio.imread(tmp_path / "jax" / rel)), rel
