"""The port's copies of the JAX package's host-side helpers against the
originals, on the same inputs: config validation (every shipped config),
the image transforms, the native image ops, the sample grids and
segmentation colours, the run directory's html, metric lines and file
helpers. All pure numpy/PIL; no net runs."""

import glob
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from munit_tpu import config as jconfig
from munit_tpu import native as jnative
from munit_tpu.data import datasets as jdatasets
from munit_tpu.data import transforms as jT
from munit_tpu.eval import sample as jsample
from munit_tpu.eval import segmap as jsegmap
from munit_tpu.utils import html as jhtml
from munit_tpu.utils import logging as jlogging
from munit_tpu.utils import misc as jmisc
from munit_tpu_torch import config, native
from munit_tpu_torch.data import datasets
from munit_tpu_torch.data import transforms as T
from munit_tpu_torch.eval import sample, segmap
from munit_tpu_torch.utils import html, misc
from munit_tpu_torch.utils import logging as plogging

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(Path(p).relative_to(ROOT)) for p in
                 glob.glob(str(ROOT / "configs" / "**" / "*.yaml"),
                           recursive=True))


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("path", CONFIGS + ["(empty)"])
def test_config_validates_as_jax_does(path):
    """Every key the port defines, loop and data keys included, takes the
    JAX package's value, for each shipped config and for an empty one."""
    if path == "(empty)":
        want, got = jconfig.validate({}), config.validate({})
    else:
        want = jconfig.get_config(str(ROOT / path))
        got = config.get_config(str(ROOT / path))
    assert set(got) <= set(want)
    assert {k: got[k] for k in got} == {k: want[k] for k in got}
    for key in ("log_iter", "image_save_iter", "image_display_iter",
                "snapshot_save_iter", "max_iter", "num_workers",
                "synthetic_frequency", "eval_fid"):
        assert key in got


def test_flatten_opts_as_jax():
    conf = config.get_config(str(ROOT / "configs" / "config_256.yaml"))
    assert config.flatten_opts(conf) == jconfig.flatten_opts(conf)


# -------------------------------------------------------------- transforms

def _image(h, w, seed=0, c=3):
    rng = np.random.RandomState(seed)
    shape = (h, w, c) if c else (h, w)
    return Image.fromarray(rng.randint(0, 256, shape, np.uint8))


@pytest.mark.parametrize("size", [(40, 52), (52, 40), (32, 32)])
def test_resize_and_crop_params_as_jax(size):
    img = _image(*size)
    for new in (32, 36):
        a, b = T.resize_shorter(img, new), jT.resize_shorter(img, new)
        assert a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got = T.crop_params(np.random.default_rng(3), a, 32, 32)
        assert got == jT.crop_params(np.random.default_rng(3), b, 32, 32)
        h, w = np.asarray(a).shape[:2]
        assert T._crop_ij(np.random.default_rng(4), h, w, 32, 32) == \
            jT._crop_ij(np.random.default_rng(4), h, w, 32, 32)


@pytest.mark.parametrize("scale,channels", [(1, 0), (255, 0), (255, 3)])
def test_mask_to_array_as_jax(scale, channels):
    rng = np.random.RandomState(1)
    m = (rng.rand(9, 7) > 0.5).astype(np.uint8) * scale
    if channels:
        m = np.repeat(m[..., None], channels, axis=-1)
    np.testing.assert_array_equal(T.mask_to_array(m), jT.mask_to_array(m))


def test_semantic_to_classes_as_jax():
    vals = np.array([0, 29, 55, 76, 133, 149, 178, 200, 255], np.uint8)
    sem = Image.fromarray(np.resize(vals, (6, 6)))
    np.testing.assert_array_equal(T.semantic_to_classes(sem),
                                  jT.semantic_to_classes(sem))
    bad = Image.fromarray(np.full((2, 2), 7, np.uint8))
    with pytest.raises(ValueError, match="unmapped gray values"):
        T.semantic_to_classes(bad)


@pytest.mark.parametrize("uint8_out", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_cached_transforms_as_jax(train, uint8_out):
    img = np.asarray(_image(40, 52))
    mask = (np.random.RandomState(2).rand(40, 52) > 0.6).astype(np.uint8)
    got = T.image_transform_cached(np.random.default_rng(5), img, 32, 32,
                                   train, uint8_out)
    want = jT.image_transform_cached(np.random.default_rng(5), img, 32, 32,
                                     train, uint8_out)
    np.testing.assert_array_equal(got, want)
    got = T.image_mask_transform_cached(np.random.default_rng(6), img, mask,
                                        mask[:, ::-1], 32, 32, uint8_out)
    want = jT.image_mask_transform_cached(np.random.default_rng(6), img,
                                          mask, mask[:, ::-1], 32, 32,
                                          uint8_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("flip", [False, True])
def test_native_fused_transform_as_jax(flip, normalize):
    """The same C++ source and g++ flags give the same bits; without g++
    neither package has the library."""
    assert native.available() == jnative.available()
    if not native.available():
        return
    src = np.asarray(_image(45, 61, seed=7))
    assert native.resized_dims(45, 61, 32) == jnative.resized_dims(45, 61, 32)
    got = native.fused_transform(src, flip, 32, 0, 3, 32, 32, normalize)
    want = jnative.fused_transform(src, flip, 32, 0, 3, 32, 32, normalize)
    np.testing.assert_array_equal(got, want)


def test_image_mask_transform_pil_as_jax():
    img, mask = _image(40, 52), _image(40, 52, seed=3, c=0)
    got = T.image_mask_transform(np.random.default_rng(8), img, mask, 32,
                                 32, 32)
    want = jT.image_mask_transform(np.random.default_rng(8), img, mask, 32,
                                   32, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- grids, html

def test_make_grid_and_segmap_as_jax():
    rng = np.random.RandomState(4)
    imgs = rng.uniform(-1, 1, (5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(sample.make_grid(imgs, 2),
                                  jsample.make_grid(imgs, 2))
    labels = rng.randint(0, 21, (9, 8))       # 19, 20 map to black
    np.testing.assert_array_equal(segmap.decode_segmap(labels),
                                  jsegmap.decode_segmap(labels))


def test_write_2images_and_html_as_jax(tmp_path):
    rng = np.random.RandomState(5)
    outs = [rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
            for _ in range(8)]
    for name, mod_sample, mod_html in (("port", sample, html),
                                       ("jax", jsample, jhtml)):
        d = tmp_path / name
        for it in (2, 4):
            mod_sample.write_2images(outs, 2, str(d / "images"),
                                     f"train_{it:08d}")
            mod_sample.write_2images(outs, 2, str(d / "images"),
                                     f"test_{it:08d}")
        mod_sample.write_2images(outs, 2, str(d / "images"), "train_current")
        mod_html.write_html(str(d / "index.html"), 4, 2, str(d / "images"))
    for f in sorted((tmp_path / "jax" / "images").iterdir()):
        assert (tmp_path / "port" / "images" / f.name).read_bytes() == \
            f.read_bytes(), f.name
    assert (tmp_path / "port" / "index.html").read_text() == \
        (tmp_path / "jax" / "index.html").read_text()


def test_metric_lines_as_jax(tmp_path):
    rows = [({"loss_dis_total": np.float32(1.5), "lr": 1e-4}, 1),
            ({"images_per_sec": 12.25}, 2)]
    for name, mod in (("port", plogging), ("jax", jlogging)):
        logger = mod.MetricLogger(str(tmp_path / name), stdout=False)
        logger.log_parameters({"max_iter": 3})
        for m, step in rows:
            logger.log_metrics(m, step)
        logger.jsonl.close()
    got = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert got == (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert json.loads(got.splitlines()[1]) == {"step": 1,
                                               "loss_dis_total": 1.5,
                                               "lr": 1e-4}


# ------------------------------------------------------------- file helpers

def test_file_helpers_as_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    for name in ("b.png", "a.jpg", "sub/c.JPG", "skip.txt"):
        (tmp_path / name).write_bytes(b"")
    assert datasets.scan_folder(str(tmp_path)) == \
        jdatasets.scan_folder(str(tmp_path))
    lst = tmp_path / "list.txt"
    lst.write_text("x/1.jpg 3\n\n  y/2.png\n")
    assert datasets.read_filelist(str(lst)) == \
        jdatasets.read_filelist(str(lst)) == ["x/1.jpg", "y/2.png"]
    assert misc.prepare_sub_folder(str(tmp_path / "run")) == \
        jmisc.prepare_sub_folder(str(tmp_path / "run"))
    for f in ("gen_00000002.pt", "gen_00000010.pt", "dis_00000010.pt"):
        (tmp_path / "run" / "checkpoints" / f).write_bytes(b"")
    ckpt = str(tmp_path / "run" / "checkpoints")
    assert misc.get_model_list(ckpt, "gen") == \
        jmisc.get_model_list(ckpt, "gen")
    assert misc.get_model_list(str(tmp_path / "none"), "gen") is None
