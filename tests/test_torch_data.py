"""The port's data feed (munit_tpu_torch.data, munit_tpu_torch.native)
against the JAX package's: both packages' loaders read the same seeded
JPEG/PNG lists with the same seed and give bitwise-equal batches, in uint8
and float32 mode, with and without the decode cache, on the native and the
PIL path. Then the port's resume order, its error path, and its device
normalization against JAX's jitted one (within 1 ulp of 1.0 in
float32, equal after the bf16 cast); with MUNIT_LOADER_SKIP_BAD=1, the
substitution of a corrupt file in the loader and the display batch. No
net runs."""

import itertools
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from munit_tpu.data import api as japi
from munit_tpu.data.loader import device_prefetch as jax_device_prefetch
from munit_tpu_torch import native
from munit_tpu_torch.cli.train import display_batch
from munit_tpu_torch.data import api, transforms
from munit_tpu_torch.data.loader import DataLoader, device_prefetch

N_IMAGES, BATCH, BATCHES, CROP = 6, 2, 6, 32


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """6 seeded JPEGs of two aspect ratios, masks stored {0, 255} and
    {0, 1}, and their lists."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    imgs, masks = [], []
    for i in range(N_IMAGES):
        h, w = (40, 48) if i % 2 else (50, 37)
        p = root / f"img{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(p)
        m = root / f"mask{i}.png"
        scale = 255 if i % 3 else 1
        Image.fromarray((rng.rand(h, w) > 0.6).astype(np.uint8)
                        * scale).save(m)
        imgs.append(str(p))
        masks.append(str(m))
    (root / "imgs.txt").write_text("\n".join(imgs) + "\n")
    (root / "masks.txt").write_text("\n".join(masks) + "\n")
    return str(root / "imgs.txt"), str(root / "masks.txt")


def _take(loader, n=BATCHES):
    return list(itertools.islice(iter(loader), n))


def _take_and_drain(loader, n=BATCHES):
    """_take, then wait for the loader's threads to end: a decode still in
    flight would print its substitution after the test."""
    before = set(threading.enumerate())
    it = iter(loader)
    try:
        return list(itertools.islice(it, n))
    finally:
        it.close()
        for t in set(threading.enumerate()) - before:
            t.join(timeout=10)


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert w[k].dtype == g[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("cache_mb", ["2048", "0"])
@pytest.mark.parametrize("uint8", ["1", "0"])
def test_mask_loader_batches_equal_jax(lists, monkeypatch, uint8, cache_mb):
    monkeypatch.setenv("MUNIT_LOADER_UINT8", uint8)
    monkeypatch.setenv("MUNIT_CACHE_MB", cache_mb)
    kw = dict(new_size=CROP, height=CROP, width=CROP, num_workers=3, seed=5)
    want = _take(japi.get_data_loader_mask_and_im(*lists, BATCH, True, **kw))
    got = _take(api.get_data_loader_mask_and_im(*lists, BATCH, True, **kw))
    _assert_same(want, got)
    assert got[0]["image"].dtype == (np.uint8 if uint8 == "1"
                                     else np.float32)


@pytest.mark.parametrize("uint8", ["1", "0"])
@pytest.mark.parametrize("native_ops", ["1", "0"])
def test_list_loader_batches_equal_jax(lists, monkeypatch, native_ops,
                                       uint8):
    """Without the cache a list loader transforms each draw from the
    decoded image: through the native pass, or PIL when it is off."""
    monkeypatch.setenv("MUNIT_NATIVE_IMAGEOPS", native_ops)
    monkeypatch.setenv("MUNIT_LOADER_UINT8", uint8)
    monkeypatch.setenv("MUNIT_CACHE_MB", "0")
    kw = dict(new_size=CROP, height=CROP, width=CROP, num_workers=3, seed=2)
    want = _take(japi.get_data_loader_list("", lists[0], BATCH, True, **kw))
    before = dict(transforms.paths)
    got = _take(api.get_data_loader_list("", lists[0], BATCH, True, **kw))
    _assert_same(want, got)
    took = {k: transforms.paths[k] - before.get(k, 0)
            for k in ("native", "pil")}
    on = native_ops == "1" and shutil.which("g++") is not None
    assert native.available() == (shutil.which("g++") is not None)
    # the loader decodes ahead of the batches taken
    ran, other = ("native", "pil") if on else ("pil", "native")
    assert took[ran] >= BATCH * BATCHES and took[other] == 0


def test_iter_from_equals_skipping_batches(lists):
    ds = api.get_data_loader_mask_and_im(*lists, BATCH, True,
                                         new_size=CROP, height=CROP,
                                         width=CROP, num_workers=2).dataset
    loader = DataLoader(ds, BATCH, shuffle=True, num_workers=2, seed=3)
    every = _take(loader, 7)
    resumed = list(itertools.islice(loader.iter_from(4), 3))
    _assert_same(every[4:], resumed)


class _Broken:
    def __len__(self):
        return 4

    def get(self, index, rng):
        if index == 2:
            raise OSError("corrupt sample 2")
        return {"image": np.zeros((2, 2, 3), np.float32)}


def test_worker_error_reaches_the_caller():
    loader = DataLoader(_Broken(), 2, shuffle=False, num_workers=2)
    with pytest.raises(OSError, match="corrupt sample 2"):
        _take(loader, 2)


def test_device_normalization_matches_jax():
    """Every uint8 value through both packages' device_prefetch: within 1
    ulp of 1.0 in float32, equal after the bf16
    cast; masks to float32; float32 images cast to bf16 on the device."""
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    m = (x % 2).astype(np.uint8)
    f = np.linspace(-1, 1, 256, dtype=np.float32).reshape(1, 16, 16, 1)
    batch = {"image": x, "mask": m, "image_f32": f}
    for jdt, tdt in ((None, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = next(jax_device_prefetch(iter([batch]), image_dtype=jdt))
        got = next(device_prefetch(iter([batch]), "cpu",
                                   image_dtype=None if jdt is None else tdt))
        w = np.asarray(want["image"].astype(jnp.float32))
        g = got["image"].float().numpy()
        assert got["image"].dtype == tdt
        if jdt is None:
            # XLA folds (x/255)*2 into one fma: 1 ulp of [-1, 1]'s top, as
            # tests/test_loader_cache.py bounds it; the port keeps the host
            # op order exactly
            assert np.abs(g - w).max() <= np.spacing(np.float32(1))
            np.testing.assert_array_equal(
                g, (x.astype(np.float32) / 255.0) * 2.0 - 1.0)
        else:
            np.testing.assert_array_equal(g, w)
        assert got["mask"].dtype == torch.float32
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(want["mask"]))
        assert got["image_f32"].dtype == tdt
        np.testing.assert_array_equal(
            got["image_f32"].float().numpy(),
            np.asarray(want["image_f32"].astype(jnp.float32)))


# a feed closed just before the interpreter exits, as the train CLI's is
_EXIT_AFTER_CLOSE = """
import numpy as np
from munit_tpu_torch.data.loader import device_prefetch

def source():
    x = np.random.randint(0, 255, (8, 512, 512, 3), np.uint8)
    while True:
        yield {"image": x, "mask": x[..., :1]}

it = device_prefetch(source(), "cpu")
for _ in range(3):
    next(it)
it.close()
"""


def test_closed_prefetch_lets_the_process_exit():
    """Closing device_prefetch waits for its pump thread: a daemon thread
    still inside a PyTorch op when the interpreter exits aborts the process
    ("terminate called without an active exception")."""
    proc = subprocess.run([sys.executable, "-c", _EXIT_AFTER_CLOSE],
                          cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_device_prefetch_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        next(device_prefetch(iter([]), "cuda"))


def test_grain_loader_is_refused(monkeypatch):
    monkeypatch.setenv("MUNIT_LOADER", "grain")
    with pytest.raises(NotImplementedError, match="item 19"):
        api.DataLoader(_Broken(), 2, shuffle=False)


@pytest.fixture(scope="module")
def corrupt_lists(lists, tmp_path_factory):
    """The lists of ``lists`` with image 2 replaced by a file that is not
    an image."""
    root = tmp_path_factory.mktemp("corrupt")
    bad = root / "bad.jpg"
    bad.write_bytes(b"not a JPEG")
    imgs = open(lists[0]).read().split()
    imgs[2] = str(bad)
    (root / "imgs.txt").write_text("\n".join(imgs) + "\n")
    return str(root / "imgs.txt"), lists[1]


@pytest.mark.parametrize("cache_mb", ["2048", "0"])
def test_corrupt_sample_substituted_as_jax(corrupt_lists, monkeypatch,
                                           cache_mb):
    """MUNIT_LOADER_SKIP_BAD=1: both packages replace the corrupt sample by
    the next index and give bitwise-equal batches; by default the decode
    error reaches the caller."""
    monkeypatch.setenv("MUNIT_CACHE_MB", cache_mb)
    kw = dict(new_size=CROP, height=CROP, width=CROP, num_workers=3, seed=5)
    with pytest.raises(OSError):
        _take_and_drain(api.get_data_loader_mask_and_im(
            *corrupt_lists, BATCH, True, **kw))
    monkeypatch.setenv("MUNIT_LOADER_SKIP_BAD", "1")
    want = _take_and_drain(japi.get_data_loader_mask_and_im(
        *corrupt_lists, BATCH, True, **kw))
    got = _take_and_drain(api.get_data_loader_mask_and_im(
        *corrupt_lists, BATCH, True, **kw))
    _assert_same(want, got)


def test_display_batch_skips_a_corrupt_sample(corrupt_lists, monkeypatch):
    """The display batch draws images 0, 1, 3 (rng(index)) past the
    corrupt image 2 when MUNIT_LOADER_SKIP_BAD=1, as the JAX CLI's does,
    and raises by default."""
    kw = dict(new_size=CROP, height=CROP, width=CROP, num_workers=1)
    loader = api.get_data_loader_list("", corrupt_lists[0], BATCH, False,
                                      **kw)
    with pytest.raises(OSError):
        display_batch(loader, 3, "cpu")
    monkeypatch.setenv("MUNIT_LOADER_SKIP_BAD", "1")
    got = display_batch(loader, 3, "cpu")
    jds = japi.get_data_loader_list("", corrupt_lists[0], BATCH, False,
                                    **kw).dataset
    want = np.stack([jds.get(i, np.random.default_rng(i))["image"]
                     for i in (0, 1, 3)])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
