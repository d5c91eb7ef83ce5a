"""The port's PIL-free decoder (``uwcv_tpu_torch/data/imageio.py``) and
``load_image_rgb`` against the JAX package's PIL loader, pixel for pixel:
files PIL writes (every mode and TIFF compression it can write), files
written here byte by byte (PNG filter types 0-4, 16-bit colour PNG,
big-endian and multi-strip TIFF with the horizontal predictor), and the
host C++ loops (LZW, PNG unfiltering) against their Python versions."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from uwcv_tpu.data.loader import load_image_rgb as jax_load  # noqa: E402
from uwcv_tpu_torch.data import imageio  # noqa: E402
from uwcv_tpu_torch.data.loader import load_image_rgb  # noqa: E402
from uwcv_tpu_torch.utils import native  # noqa: E402

H, W = 23, 37


def _pixels(mode, seed=0):
    rng = np.random.default_rng(seed)
    shape = {"L": (H, W), "LA": (H, W, 2), "RGB": (H, W, 3),
             "RGBA": (H, W, 4), "P": (H, W)}
    if mode == "I;16":
        return rng.integers(0, 65536, (H, W), dtype=np.uint16)
    # smooth ramps + noise: every PNG filter has something to predict
    base = np.add.outer(np.arange(H) * 5, np.arange(W) * 3) % 256
    noise = rng.integers(0, 40, shape[mode])
    return ((base.reshape(base.shape + (1,) * (len(shape[mode]) - 2))
             + noise) % 256).astype(np.uint8)


def _pil_image(mode, seed=0):
    px = _pixels(mode, seed)
    if mode == "P":
        im = Image.fromarray(px, "P")
        im.putpalette(np.random.default_rng(seed).integers(
            0, 256, 3 * 200).astype(np.uint8).tobytes())
        return im
    return Image.fromarray(px)


def _check(path):
    got = load_image_rgb(str(path))
    want = jax_load(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ files PIL writes

@pytest.mark.parametrize("mode", ["L", "I;16", "LA", "RGB", "RGBA", "P"])
def test_png_written_by_pil(tmp_path, mode):
    path = tmp_path / "a.png"
    _pil_image(mode).save(path)
    _check(path)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["L", "I;16", "LA", "RGB", "RGBA"])
def test_tiff_written_by_pil(tmp_path, mode, compression):
    path = tmp_path / "a.tif"
    _pil_image(mode, seed=1).save(path, compression=compression)
    _check(path)


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["L", "I;16", "RGB"])
def test_tiff_predictor_written_by_pil(tmp_path, mode, compression):
    path = tmp_path / "a.tif"
    _pil_image(mode, seed=2).save(path, compression=compression,
                                  tiffinfo={317: 2})
    with Image.open(path) as im:
        assert im.tag_v2.get(317) == 2
    _check(path)


@pytest.mark.parametrize("peak", [200, 40000, 3_000_000])
def test_tiff_32bit_gray_follows_the_peak_rule(tmp_path, peak):
    """PIL's mode ``I``: the JAX loader scales by the observed peak."""
    rng = np.random.default_rng(peak)
    px = rng.integers(-50, peak, (H, W)).astype(np.int32)
    px[0, 0] = peak
    path = tmp_path / "a.tif"
    Image.fromarray(px, "I").save(path)
    _check(path)


def test_jpeg_goes_through_pil_and_names_the_format_without_it(
        tmp_path, monkeypatch):
    path = tmp_path / "a.jpg"
    _pil_image("RGB").save(path, quality=90)
    _check(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG"):
        load_image_rgb(str(path))


# -------------------------------------------------- files written by hand

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(raw_rows, width, depth, ctype, filters, bpp, palette=None,
         interlace=0):
    """PNG bytes from unfiltered [h, stride] rows, row y filtered with
    filter type filters[y % len(filters)]."""
    out = []
    prev = np.zeros(raw_rows.shape[1], np.int64)
    for y, row in enumerate(raw_rows.astype(np.int64)):
        f = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0, 1: a, 2: prev, 3: (a + prev) // 2,
                4: _paeth(a, prev, c)}[f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    data = (imageio.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, len(raw_rows),
                                          depth, ctype, 0, 0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    return (data + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (2, 16),
                                         (4, 8), (4, 16), (6, 8), (6, 16),
                                         (3, 8)])
def test_png_filters_and_16bit_colour(tmp_path, ctype, depth, filters):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype * 100 + depth)
    dtype = ">u2" if depth == 16 else np.uint8
    px = rng.integers(0, 2 ** depth, (H, W, ch)).astype(dtype)
    palette = None
    if ctype == 3:
        px %= 150            # a short palette: PIL reads 150 entries
        palette = rng.integers(0, 256, (150, 3)).astype(np.uint8)
    rows = np.frombuffer(px.tobytes(), np.uint8).reshape(H, -1)
    path = tmp_path / "a.png"
    path.write_bytes(_png(rows, W, depth, ctype, filters,
                          max(1, ch * depth // 8), palette))
    _check(path)


def test_interlaced_png_raises(tmp_path):
    path = tmp_path / "a.png"
    path.write_bytes(_png(np.zeros((4, 4), np.uint8), 4, 8, 0, (0,), 1,
                          interlace=1))
    with pytest.raises(NotImplementedError, match="interlaced"):
        load_image_rgb(str(path))


def _packbits(data):
    """Literal runs of up to 128 bytes, and repeats of 3 or more."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = min(i + 128, len(data))
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff(px, bo="<", compression=1, predictor=1, rows_per_strip=None,
          extra=()):
    """Baseline TIFF bytes of px [h, w, spp] (uint8 or uint16)."""
    h, w, spp = px.shape
    depth = px.dtype.itemsize * 8
    rows_per_strip = rows_per_strip or h
    vals = px.astype(px.dtype.newbyteorder("="))
    if predictor == 2:
        vals = np.diff(vals, axis=1, prepend=np.zeros_like(vals[:, :1]))
    raw = vals.astype(px.dtype.newbyteorder(bo))
    strips = []
    for s in range(0, h, rows_per_strip):
        b = raw[s:s + rows_per_strip].tobytes()
        strips.append({1: b, 8: zlib.compress(b),
                       32773: _packbits(b)}[compression])
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    photometric = 1 if spp <= 2 else 2
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [depth] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (273, 4, offsets), (277, 3, [spp]), (278, 4, [rows_per_strip]),
               (279, 4, [len(s) for s in strips]), (284, 3, [1]),
               (317, 3, [predictor])]
    if extra:
        entries.append((338, 3, list(extra)))
    head = (b"II*\x00" if bo == "<" else b"MM\x00*")
    ifd_at = pos
    body, tail = b"", b""
    tail_at = ifd_at + 2 + 12 * len(entries) + 4
    for tag, typ, values in entries:
        fmt = "H" if typ == 3 else "I"
        packed = struct.pack(f"{bo}{len(values)}{fmt}", *values)
        if len(packed) <= 4:
            field = packed.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", tail_at + len(tail))
            tail += packed
        body += struct.pack(bo + "HHI", tag, typ, len(values)) + field
    return (head + struct.pack(bo + "I", ifd_at) + b"".join(strips)
            + struct.pack(bo + "H", len(entries)) + body
            + struct.pack(bo + "I", 0) + tail)


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", [1, 8, 32773])
@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("spp,dtype,extra", [
    (1, np.uint8, ()), (1, np.uint16, ()), (3, np.uint8, ()),
    (3, np.uint16, ()), (4, np.uint16, (2,)), (2, np.uint8, (2,))])
def test_tiff_written_by_hand(tmp_path, bo, compression, predictor, spp,
                              dtype, extra):
    """PIL applies the predictor only to LZW and deflate strips."""
    rng = np.random.default_rng(spp * 7 + compression)
    px = rng.integers(0, np.iinfo(dtype).max + 1, (H, W, spp)).astype(dtype)
    px[:, 5:15] = px[:, 5:6]         # runs, for PackBits
    path = tmp_path / "a.tif"
    path.write_bytes(_tiff(px, bo, compression, predictor=predictor,
                           rows_per_strip=5, extra=extra))
    _check(path)


def test_chip_smoke_tiff_writer_reads_as_pil_reads_it(tmp_path):
    """The 16-bit micrographs chip_smoke.py writes for its folder phase."""
    import chip_smoke

    rng = np.random.default_rng(4)
    px = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    path = tmp_path / "a.tif"
    chip_smoke.write_tiff16(str(path), px)
    with Image.open(path) as im:
        assert im.mode == "I;16"
        np.testing.assert_array_equal(np.asarray(im), px)
    _check(path)


# ------------------------------------------- host C++ against plain Python

def test_lzw_native_matches_python_on_pil_strips(tmp_path):
    for mode, seed in (("I;16", 5), ("RGB", 6), ("L", 7)):
        path = tmp_path / f"{seed}.tif"
        im = _pil_image(mode, seed)
        im.save(path, compression="tiff_lzw")
        data = path.read_bytes()
        bo = "<" if data[:2] == b"II" else ">"
        tags = imageio._tiff_tags(data, bo)
        n_out = len(np.asarray(im).tobytes())
        strip = data[tags[273][0]:tags[273][0] + tags[279][0]]
        assert len(tags[273]) == 1
        got = native.tiff_lzw_decode(strip, n_out).tobytes()
        assert got == imageio.lzw_decode_reference(strip, n_out)
        got_px = imageio.decode_tiff(data).pixels
        py_px = imageio.decode_tiff(data, lzw=imageio.lzw_decode_reference
                                    ).pixels
        np.testing.assert_array_equal(got_px, py_px)


def test_lzw_rejects_garbage():
    with pytest.raises(ValueError):
        native.tiff_lzw_decode(b"\x80\xff\xff\xff\xff", 100)


def test_png_unfilter_native_matches_python():
    rng = np.random.default_rng(8)
    for bpp in (1, 2, 3, 4, 8):
        stride = bpp * 9
        rows = rng.integers(0, 256, (12, stride + 1)).astype(np.uint8)
        rows[:, 0] = np.arange(12) % 5
        np.testing.assert_array_equal(
            native.png_unfilter(rows.reshape(-1), 12, stride, bpp),
            imageio.png_unfilter_reference(rows.reshape(-1), 12, stride, bpp))
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="filter type"):
        native.png_unfilter(rows.reshape(-1), 12, stride, bpp)


def test_png_decode_with_plain_unfilter_matches(tmp_path):
    im = _pil_image("RGBA", 9)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    a = imageio.decode_png(buf.getvalue())
    b = imageio.decode_png(buf.getvalue(),
                           unfilter=imageio.png_unfilter_reference)
    np.testing.assert_array_equal(a.pixels, b.pixels)
    assert a.mode == b.mode == "RGBA"
