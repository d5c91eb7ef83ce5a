"""The port's measurement layer against the JAX package's, on the same
numpy-seeded masks: RLE codecs, contours and the 9 descriptors, and the
report CSVs — byte for byte what the JAX package's pandas writes — plus the
host C++ (``csrc/host/uwcv_native.cpp``) against its plain numpy/scipy
versions."""

import math
import os
import sys

import numpy as np
import pytest

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from uwcv_tpu.config import MeasureConfig as JMeasureConfig  # noqa: E402
from uwcv_tpu.data.classes import ClassRegistry as JRegistry  # noqa: E402
from uwcv_tpu.measure import contours as j_contours  # noqa: E402
from uwcv_tpu.measure import descriptors as j_desc  # noqa: E402
from uwcv_tpu.measure import reports as j_reports  # noqa: E402
from uwcv_tpu.measure import rle as j_rle  # noqa: E402
from uwcv_tpu_torch.config import MeasureConfig  # noqa: E402
from uwcv_tpu_torch.data.classes import ClassRegistry  # noqa: E402
from uwcv_tpu_torch.measure import contours, descriptors, reports, rle  # noqa: E402


def _blobs(seed, h=96, w=120, n=7):
    """Ellipses, rings, a diagonal pinch and single pixels on one canvas."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), bool)
    for _ in range(n):
        cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
        ry, rx = rng.uniform(2, 18, 2)
        a = rng.uniform(0, np.pi)
        u = ((xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)) / rx
        v = (-(xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)) / ry
        r = u * u + v * v
        m |= (r <= 1) & ((r >= 0.3) if rng.random() < 0.3 else True)
    m[0, 0] = m[h - 1, w - 1] = True                  # border pixels
    m[40, 3], m[41, 4], m[40, 5] = True, True, True    # a diagonal pinch
    m |= rng.random((h, w)) > 0.995                    # lone pixels
    return m


MASKS = [_blobs(s) for s in range(4)] + [
    np.zeros((9, 13), bool), np.ones((9, 13), bool),
    np.eye(11, dtype=bool), (np.random.default_rng(9).random((30, 40)) > 0.5)]


@pytest.mark.parametrize("i", range(len(MASKS)))
def test_rle_matches_jax_and_plain(i):
    m = MASKS[i]
    got = rle.rle_encoding(m)
    assert got == rle.rle_encoding_reference(m) == j_rle.rle_encoding(m)
    assert rle.rle_encoding(m.astype(np.uint8) * 255) == got
    np.testing.assert_array_equal(rle.rle_decode(got, m.shape), m)
    np.testing.assert_array_equal(rle.rle_decode(" ".join(map(str, got)),
                                                 m.shape), m)
    assert rle.rle_encode(m) == j_rle.rle_encode(m)
    coco = rle.binary_mask_to_rle(m)
    assert coco == j_rle.binary_mask_to_rle(m)
    np.testing.assert_array_equal(rle.rle_from_coco(coco), m)


@pytest.mark.parametrize("i", range(len(MASKS)))
def test_contours_match_jax_and_plain(i):
    m = MASKS[i]
    got = contours.find_contours(m)
    plain = contours.find_contours_reference(m)
    want = j_contours.find_contours(m)
    assert len(got) == len(plain) == len(want)
    for a, b, c in zip(got, plain, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for min_area in (3, 40):
        assert len(contours.find_contours(m, min_area)) == len(
            j_contours.find_contours(m, min_area))


@pytest.mark.parametrize("ppm,min_area", [(0.85, 100.0), (2.0, 0.0)])
@pytest.mark.parametrize("i", range(4))
def test_descriptors_match_jax(i, ppm, min_area):
    got = descriptors.measure_mask(MASKS[i], ppm, min_area)
    want = j_desc.measure_mask(MASKS[i], ppm, min_area)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.as_row() == b.as_row()
        assert (a.area_px, a.centroid) == (b.area_px, b.centroid)


def _instances(seed, n=9, h=80, w=96, classes=4):
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, h, w), bool)
    for k in range(n):
        y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
        masks[k, y:y + rng.integers(8, 20), x:x + rng.integers(8, 20)] = True
    cls = rng.integers(0, classes - 1, n).astype(np.int32)   # last class empty
    return {"boxes": rng.uniform(0, 50, (n, 4)).astype(np.float32),
            "scores": rng.uniform(0, 1, n).astype(np.float32),
            "classes": cls, "masks": masks}


@pytest.mark.parametrize("names", [None, ["Scale bar", "a,b \"quoted\"",
                                          "Pores", "empty class"]])
def test_report_csvs_byte_identical_to_pandas(tmp_path, names):
    """The same predictions through both reports: ShapeDescriptor.csv and
    every Results<kw>_.csv byte for byte, the last class header-only;
    counts, histograms and moving averages equal."""
    kw = {} if names is None else {"names": names}
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    got = reports.MeasurementReport(ClassRegistry(**kw), MeasureConfig(),
                                    str(got_dir))
    want = j_reports.MeasurementReport(JRegistry(**kw), JMeasureConfig(),
                                       str(want_dir))
    for seed in range(3):
        inst = _instances(seed)
        got.add_image(inst)
        want.add_image(inst)
    paths = [got.write_shape_descriptor_csv()] + got.write_results_csvs()
    want_paths = [want.write_shape_descriptor_csv()] + \
        want.write_results_csvs()
    for a, b in zip(paths, want_paths):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
    assert got.summary() == want.summary()
    assert not got.per_class[-1].rows
    for cg, cw in zip(got.per_class, want.per_class):
        assert cg.count == cw.count
        hg, hw = cg.histograms(), cw.histograms()
        assert hg.keys() == hw.keys()
        for k in hg:
            np.testing.assert_array_equal(hg[k][0], hw[k][0])
            np.testing.assert_array_equal(hg[k][1], hw[k][1])
        assert cg.moving_averages() == cw.moving_averages()


def test_csv_floats_match_pandas(tmp_path):
    """repr-exact floats, NaN as an empty field, infinities, huge and tiny
    values, negative zero, and quoting — against pandas itself."""
    import pandas as pd

    vals = [0.1, 1.0, -0.0, 1e16, 1.2345678901234568e+17, 1e-5, 5e-324,
            float("nan"), float("inf"), -float("inf"), 123456789.125,
            0.30000000000000004, 2.0 / 3.0, math.pi * 1e-300]
    rows = [["x,y", *vals[:7]], ['q"t', *vals[7:]]]
    header = ["Class"] + [f"c{i}" for i in range(7)]
    reports.write_csv(str(tmp_path / "port.csv"), header, rows)
    pd.DataFrame(rows, columns=header).to_csv(tmp_path / "pd.csv",
                                              index=False)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "pd.csv").read_bytes()
    reports.write_csv(str(tmp_path / "empty.csv"), header, [])
    pd.DataFrame([], columns=header).to_csv(tmp_path / "pd_empty.csv",
                                            index=False)
    assert (tmp_path / "empty.csv").read_bytes() == \
        (tmp_path / "pd_empty.csv").read_bytes()


def test_moving_average_and_counts_match_jax():
    vals = np.random.default_rng(2).normal(size=11).tolist()
    assert reports.moving_average(vals, 3) == j_reports.moving_average(vals, 3)
    inst = _instances(4)
    np.testing.assert_array_equal(reports.count_instances(inst, 4),
                                  j_reports.count_instances(inst, 4))


def test_plots_need_matplotlib(tmp_path, monkeypatch):
    rep = reports.MeasurementReport(ClassRegistry(), MeasureConfig(),
                                    str(tmp_path))
    rep.add_image(_instances(5))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        rep.write_distribution_plots()
