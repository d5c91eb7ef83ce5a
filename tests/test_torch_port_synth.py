"""The port's synthetic dataset, PNG writer and ground-truth gallery against
the JAX package's: the same seed gives the same pixels (decoded by the
port's ``decode_png`` and by PIL), byte-equal JSONs and ``classes.csv``;
``save_gt_visualizations`` gives the same pixels; ``write_png`` round-trips.
PNG bytes may differ from PIL's (its zlib settings are its own)."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from uwcv_tpu.data import rasterize as j_rasterize  # noqa: E402
from uwcv_tpu.data.classes import ClassRegistry as JRegistry  # noqa: E402
from uwcv_tpu.data.superannotate import (  # noqa: E402
    get_superannotate_dicts as j_sa_dicts,
)
from uwcv_tpu.data.synthetic import generate_dataset as j_generate  # noqa: E402
from uwcv_tpu.engine.batch_inference import (  # noqa: E402
    save_gt_visualizations as j_save_gt,
)
from uwcv_tpu_torch.data.classes import ClassRegistry  # noqa: E402
from uwcv_tpu_torch.data.imageio import (  # noqa: E402
    decode_png,
    encode_png,
    write_png,
)
from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts  # noqa: E402
from uwcv_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from uwcv_tpu_torch.engine.batch_inference import (  # noqa: E402
    save_gt_visualizations,
)

SPLITS = ("Train", "Test", "INFERENCE")


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


def _decode(path):
    return decode_png(_read(path))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Both packages' datasets from one seed, at a non-square size."""
    root = tmp_path_factory.mktemp("synth")
    kw = dict(num_train=3, num_test=2, num_inference=2,
              image_size=(72, 101), seed=7)
    return (j_generate(str(root / "jax"), **kw),
            generate_dataset(str(root / "port"), **kw))


def test_same_files_in_every_split(datasets):
    j, p = datasets
    assert sorted(j) == sorted(p)
    for split in SPLITS:
        assert sorted(os.listdir(j[split])) == sorted(os.listdir(p[split]))
    assert len(os.listdir(p["Train"])) == 6          # 3 PNGs + 3 JSONs
    assert len(os.listdir(p["INFERENCE"])) == 2      # no labels


@pytest.mark.parametrize("split", SPLITS)
def test_pixels_equal_jax(datasets, split):
    """Every PNG: the port's, decoded by ``decode_png`` and by PIL, equals
    the JAX package's decoded by PIL (RGB, uint8)."""
    j, p = datasets
    names = sorted(n for n in os.listdir(p[split]) if n.endswith(".png"))
    assert names
    for name in names:
        want = np.asarray(Image.open(os.path.join(j[split], name)))
        got = _decode(os.path.join(p[split], name))
        assert got.mode == "RGB" and want.shape == (72, 101, 3)
        np.testing.assert_array_equal(got.pixels, want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(p[split], name))), want)


@pytest.mark.parametrize("split", ("Train", "Test"))
def test_jsons_byte_equal(datasets, split):
    j, p = datasets
    names = sorted(n for n in os.listdir(p[split]) if n.endswith(".json"))
    assert names
    for name in names:
        assert _read(os.path.join(p[split], name)) == _read(
            os.path.join(j[split], name))


def test_classes_csv_byte_equal(datasets):
    j, p = datasets
    assert _read(p["classes_csv"]) == _read(j["classes_csv"])


def test_synth_verb_needs_no_device(tmp_path, monkeypatch):
    """``synth`` writes the dataset without a card (none is asked for)."""
    import torch

    from uwcv_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["synth", "--root", str(tmp_path), "--train", "1", "--test",
                 "1", "--infer", "0", "--size", "40"]) == 0
    img = _decode(str(tmp_path / "Train" / "synthetic_train_000.png"))
    assert img.pixels.shape == (40, 40, 3)
    assert (tmp_path / "classes.csv").exists()


def test_gt_visualizations_equal_jax(datasets, tmp_path, monkeypatch):
    """``save_gt_visualizations`` over the Train split: the same file names
    and pixels as the JAX package's with its numpy scanline rasterizer (the
    port's only one; the JAX PIL path also draws outlines)."""
    monkeypatch.setattr(j_rasterize, "_HAS_PIL", False)
    j, p = datasets
    got = save_gt_visualizations(
        get_superannotate_dicts(p["Train"]), ClassRegistry(),
        str(tmp_path / "port"), max_images=2)
    want = j_save_gt(j_sa_dicts(j["Train"]), JRegistry(),
                     str(tmp_path / "jax"), max_images=2)
    assert [os.path.basename(x) for x in got] == [
        os.path.basename(x) for x in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        px = _decode(g).pixels
        np.testing.assert_array_equal(px, np.asarray(Image.open(w)))
        # the overlay changed some pixels of the image
        src = _decode(os.path.join(p["Train"], os.path.basename(g)
                                   .replace("_gt.png", ".png"))).pixels
        assert (px != src).any()


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 17), (2, 9, 3),
                                   (13, 31, 3), (64, 1, 3)])
def test_write_png_round_trips(tmp_path, shape):
    """Gray and RGB at odd widths: ``decode_png`` and PIL read back the
    pixels, and every chunk's CRC checks."""
    rng = np.random.default_rng(sum(shape))
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    path = write_png(str(tmp_path / "a.png"), px)
    got = _decode(path)
    assert got.mode == ("L" if px.ndim == 2 else "RGB")
    np.testing.assert_array_equal(got.pixels, px)
    pil = Image.open(path)
    assert pil.mode == got.mode
    np.testing.assert_array_equal(np.asarray(pil), px)
    assert _read(path) == encode_png(px)


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint16),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4,), np.uint8)])
def test_encode_png_rejects_other_layouts(bad):
    with pytest.raises(ValueError):
        encode_png(bad)
