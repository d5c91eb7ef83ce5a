"""PNG and baseline-TIFF decoding in numpy + ``zlib``, without PIL.

The JAX package decodes with PIL (``uwcv_tpu/data/loader.py``); the port's
card machine has no PIL, so the port reads the two formats its users store
SEM micrographs in itself.  ``decode_image`` returns the pixels in the mode
PIL would open the file in, so ``loader.load_image_rgb`` can apply the JAX
loader's conversion rules value for value:

- PNG: colour types 0/2/3/4/6 at bit depth 8, and 0/2/4/6 at 16; filter
  types 0-4; interlaced files raise ``NotImplementedError``.
- TIFF: either byte order, the first image, strips, compression none / LZW
  / deflate / PackBits, horizontal predictor 2 (with LZW and deflate, as
  libtiff applies it), 8- and 16-bit gray, gray + alpha, RGB and RGBA with
  contiguous planes, and 32-bit gray.

Modes, as PIL names them: 8-bit "L", "LA", "RGB", "RGBA" and "P" (with its
palette) are uint8; 16-bit gray is "I;16" (uint16); 32-bit gray is "I"
(int32).  16-bit colour and gray + alpha keep the high byte of each sample,
as PIL's unpackers do.  The sequential byte loops (PNG unfiltering, LZW)
run in the port's host C++ (``utils/native.py``); their Python versions
below are the plain versions for the tests.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from uwcv_tpu_torch.utils import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*")


class Decoded(NamedTuple):
    pixels: np.ndarray                  # [H, W] or [H, W, C]
    mode: str                           # PIL's name for the mode
    palette: Optional[np.ndarray] = None    # [256, 3] uint8 for mode "P"


def sniff_format(head: bytes) -> str:
    """"PNG", "TIFF", "JPEG" or "unknown" from a file's first bytes."""
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head[:4] in TIFF_SIGNATURES:
        return "TIFF"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    return "unknown"


def decode_image(data: bytes) -> Decoded:
    """A PNG or TIFF file's bytes → its pixels and mode."""
    fmt = sniff_format(data[:8])
    if fmt == "PNG":
        return decode_png(data)
    if fmt == "TIFF":
        return decode_tiff(data)
    raise ValueError(f"not a PNG or TIFF file ({fmt})")


# ------------------------------------------------------------------- PNG

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends without an IEND chunk")


def decode_png(data: bytes, unfilter=None) -> Decoded:
    """``unfilter(rows, h, stride, bpp)`` defaults to the host C++ one."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise NotImplementedError("interlaced (Adam7) PNG is not supported")
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or (
            ctype == 3 and depth != 8):
        raise NotImplementedError(
            f"PNG colour type {ctype} at bit depth {depth} is not supported "
            f"(8-bit types 0/2/3/4/6 and 16-bit types 0/2/4/6 are)")
    ch = _PNG_CHANNELS[ctype]
    nbytes = depth // 8
    stride = w * ch * nbytes
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = (unfilter or native.png_unfilter)(rows, h, stride, ch * nbytes)
    if depth == 16:
        px = rows.view(">u2").reshape(h, w, ch)
        if ctype == 0:
            return Decoded(px[..., 0].astype(np.uint16), "I;16")
        px = (px >> 8).astype(np.uint8)
    else:
        px = rows.reshape(h, w, ch)
    if ch == 1:
        px = px[..., 0]
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)      # PIL: missing entries black
        full[:len(palette)] = palette[:256]
        return Decoded(px, "P", full)
    return Decoded(px, _PNG_MODES[ctype])


def png_unfilter_reference(rows: np.ndarray, h: int, stride: int,
                           bpp: int) -> np.ndarray:
    """Plain Python PNG unfiltering (the C++ one's plain version)."""
    src = np.asarray(rows, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int64)
    for y in range(h):
        f, cur = int(src[y, 0]), src[y, 1:].astype(np.int64)
        prev = out[y - 1] if y else np.zeros(stride, np.int64)
        if f == 0:
            out[y] = cur
        elif f == 2:
            out[y] = (cur + prev) % 256
        elif f in (1, 3, 4):
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                out[y, i] = (cur[i] + pred) % 256
        else:
            raise ValueError("PNG row with an unknown filter type")
    return out.astype(np.uint8)


# ------------------------------------------------------------------ TIFF

_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}
_NONE, _LZW, _DEFLATE, _DEFLATE_OLD, _PACKBITS = 1, 5, 8, 32946, 32773


def _tiff_tags(data: bytes, bo: str) -> Dict[int, List[int]]:
    """The first IFD's integer tags: tag → list of values."""
    (offset,) = struct.unpack(bo + "I", data[4:8])
    (count,) = struct.unpack(bo + "H", data[offset:offset + 2])
    tags = {}
    for k in range(count):
        e = offset + 2 + 12 * k
        tag, typ, n = struct.unpack(bo + "HHI", data[e:e + 8])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue                   # ASCII, rationals: not needed here
        size = struct.calcsize(fmt)
        where = e + 8 if n * size <= 4 else struct.unpack(
            bo + "I", data[e + 8:e + 12])[0]
        tags[tag] = list(struct.unpack(f"{bo}{n}{fmt}",
                                       data[where:where + n * size]))
    return tags


def packbits_decode(data: bytes, n_out: int) -> bytes:
    """PackBits (TIFF compression 32773) → the first ``n_out`` bytes."""
    out, i = bytearray(), 0
    while i < len(data) and len(out) < n_out:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out[:n_out])


def lzw_decode_reference(data: bytes, n_out: int) -> bytes:
    """Plain Python TIFF LZW (the C++ one's plain version)."""
    out = bytearray()
    table: List[bytes] = []
    width, pos, old = 9, 0, None
    nbits_total = len(data) * 8
    while len(out) < n_out and pos + width <= nbits_total:
        byte, bit = divmod(pos, 8)
        chunk = int.from_bytes(data[byte:byte + 3].ljust(3, b"\0"), "big")
        code = (chunk >> (24 - bit - width)) & ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width, old = 9, None
            continue
        if old is None:
            out += table[code]
            old = table[code]
            continue
        if code < len(table):
            entry = table[code]
        elif code == len(table):
            entry = old + old[:1]
        else:
            raise ValueError("malformed LZW data in a TIFF strip")
        out += entry
        if len(table) < 4096:
            table.append(old + entry[:1])
        old = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    if len(out) < n_out:
        raise ValueError(f"LZW strip decodes to {len(out)} bytes, expected "
                         f"{n_out}")
    return bytes(out[:n_out])


def _strip_bytes(raw: bytes, compression: int, n_out: int, lzw) -> bytes:
    if compression == _NONE:
        return raw[:n_out]
    if compression == _LZW:
        return lzw(raw, n_out)
    if compression in (_DEFLATE, _DEFLATE_OLD):
        return zlib.decompress(raw)[:n_out]
    if compression == _PACKBITS:
        return packbits_decode(raw, n_out)
    raise NotImplementedError(f"TIFF compression {compression} is not "
                              f"supported (none, LZW, deflate, PackBits are)")


def decode_tiff(data: bytes, lzw=None) -> Decoded:
    """``lzw(strip, n_out)`` defaults to the host C++ decoder."""
    lzw = lzw or (lambda raw, n: native.tiff_lzw_decode(raw, n).tobytes())
    bo = "<" if data[:2] == b"II" else ">"
    tags = _tiff_tags(data, bo)
    one = lambda tag, default=None: tags.get(tag, [default])[0]
    if 322 in tags or 324 in tags:
        raise NotImplementedError("tiled TIFF is not supported")
    w, h = one(256), one(257)
    spp = one(277, 1)
    bits = tags.get(258, [1] * spp)
    photometric = one(262)
    fmt = one(339, 1)
    extra = tags.get(338, [])
    if len(set(bits)) != 1 or bits[0] not in (8, 16, 32):
        raise NotImplementedError(f"TIFF bits per sample {bits} are not "
                                  f"supported (8 or 16, 32 for gray)")
    depth = bits[0]
    if one(284, 1) != 1:
        raise NotImplementedError("TIFF with separate planes is not supported")
    if one(266, 1) != 1:
        raise NotImplementedError("TIFF fill order 2 is not supported")
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise NotImplementedError(f"TIFF predictor {predictor} is not "
                                  f"supported (1 or 2)")
    if extra and extra[0] == 1:
        raise NotImplementedError("TIFF with associated (premultiplied) "
                                  "alpha is not supported")
    if photometric == 1 and spp in (1, 2):
        mode = "L" if spp == 1 else "LA"
    elif photometric == 2 and spp in (3, 4):
        mode = "RGB" if spp == 3 else "RGBA"
    else:
        raise NotImplementedError(
            f"TIFF photometric {photometric} with {spp} samples is not "
            f"supported (gray, gray + alpha, RGB, RGBA)")
    if depth == 32 and (mode != "L" or fmt not in (1, 2)):
        raise NotImplementedError("32-bit TIFF is supported for integer "
                                  "gray only")
    if depth != 32 and fmt != 1:
        raise NotImplementedError(f"TIFF sample format {fmt} is not supported")

    dtype = np.dtype({8: "u1", 16: "u2", 32: "i4"}[depth]).newbyteorder(bo)
    stride = w * spp * dtype.itemsize
    rows_per_strip = min(one(278, h), h)
    compression = one(259, 1)
    parts = []
    for k, (off, n) in enumerate(zip(tags[273], tags[279])):
        rows = min(rows_per_strip, h - k * rows_per_strip)
        if rows <= 0:
            break
        parts.append(_strip_bytes(data[off:off + n], compression,
                                  rows * stride, lzw))
    buf = b"".join(parts)
    if len(buf) != h * stride:
        raise ValueError(f"TIFF strips hold {len(buf)} bytes, expected "
                         f"{h * stride}")
    px = np.frombuffer(buf, dtype).reshape(h, w, spp)
    px = px.astype(dtype.newbyteorder("="))
    if predictor == 2 and compression in (_LZW, _DEFLATE, _DEFLATE_OLD):
        # libtiff's predictor codecs; PIL reads an uncompressed or PackBits
        # strip as stored, whatever the tag says
        px = np.cumsum(px, axis=1, dtype=px.dtype)
    if depth == 16 and mode != "L":
        px = (px >> 8).astype(np.uint8)   # PIL keeps the high byte
        depth = 8
    if spp == 1:
        px = px[..., 0]
    if depth == 16:
        return Decoded(px, "I;16")
    if depth == 32:
        return Decoded(px, "I")
    return Decoded(px, mode)
