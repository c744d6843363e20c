"""The port's dataset preparation tools (``harness/prep.py``, host-only
OpenCV code) against the JAX package's: the four functions on the synthetic
inputs of tests/test_harness_real.py:103-170 write the same files, byte for
byte. The card's machine has no OpenCV, so these run on the CPU only; where
the OpenCV build lacks the EXR codec, ``.exr`` files go through a raw-array
stand-in (the ``exr`` fixture) in both packages alike."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from triangulation_in_deformable_scenes_torch.harness import prep as t_prep
from triangulation_in_deformable_scenes_tpu.harness import prep as j_prep


def _same_files(a, b):
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    assert a, "nothing written"
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(pa)


@pytest.fixture
def exr(monkeypatch, tmp_path):
    """OpenCV's EXR codec where the build has it; else ``.exr`` files are
    written and read as raw arrays (``np.save``), the same stand-in for both
    packages, so their logic is still compared byte for byte."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        ok = cv2.imwrite(str(tmp_path / "probe.exr"), np.zeros((2, 2), np.float32))
    except cv2.error:
        ok = False
    if ok:
        return
    imwrite, imread = cv2.imwrite, cv2.imread

    def write(path, im, params=None):
        if str(path).endswith(".exr"):
            with open(path, "wb") as f:
                np.save(f, im)
            return True
        return imwrite(path, im) if params is None else imwrite(path, im, params)

    def read(path, flags=cv2.IMREAD_COLOR):
        if str(path).endswith(".exr"):
            return np.load(path) if os.path.exists(path) else None
        return imread(path, flags)

    monkeypatch.setattr(cv2, "imwrite", write)
    monkeypatch.setattr(cv2, "imread", read)


def test_resize_images_same_bytes(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    cv2.imwrite(str(src / "d.png"), (np.arange(64 * 64).reshape(64, 64) % 4000).astype(np.uint16))
    cv2.imwrite(str(src / "e.png"), (np.arange(48 * 80 * 3).reshape(48, 80, 3) % 251).astype(np.uint8))
    _same_files(t_prep.resize_images(str(src), str(tmp_path / "t"), 32, 20),
                j_prep.resize_images(str(src), str(tmp_path / "j"), 32, 20))


def test_realcolon_crop_center_same_bytes(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    im = np.zeros((1080, 1440, 3), dtype=np.uint8)
    im[:, 70:1420] = 50
    im[500:520, 600:700] = (10, 200, 30)
    cv2.imwrite(str(src / "f.png"), im)
    _same_files(t_prep.realcolon_crop_center(str(src), str(tmp_path / "t")),
                j_prep.realcolon_crop_center(str(src), str(tmp_path / "j")))


def test_realcolon_resize_depths_exr_same_bytes(tmp_path, exr):
    src = tmp_path / "npy"
    src.mkdir()
    depth = np.full((992, 1344), 2.5, dtype=np.float32)
    depth[100:200, 300:400] = 1.25
    np.save(str(src / "0001.npy"), depth)
    mask = np.full((1080, 1440), 255, dtype=np.uint8)
    mask[:, :100] = 0
    mask_path = str(tmp_path / "mask.jpg")
    cv2.imwrite(mask_path, mask)
    _same_files(t_prep.realcolon_resize_depths_exr(str(src), str(tmp_path / "t"), mask_path),
                j_prep.realcolon_resize_depths_exr(str(src), str(tmp_path / "j"), mask_path))


def test_syncolon_exr_to_png_same_bytes(tmp_path, exr):
    exr_dir = tmp_path / "exr"
    exr_dir.mkdir()
    depth = np.linspace(0.1, 3.0, 64, dtype=np.float32).reshape(8, 8)
    assert cv2.imwrite(str(exr_dir / "0050.exr"), depth, [cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_FLOAT])
    _same_files(t_prep.syncolon_exr_to_png(str(exr_dir), str(tmp_path / "t")),
                j_prep.syncolon_exr_to_png(str(exr_dir), str(tmp_path / "j")))
    assert t_prep.SYNCOLON_DEPTH_SCALE == j_prep.SYNCOLON_DEPTH_SCALE
