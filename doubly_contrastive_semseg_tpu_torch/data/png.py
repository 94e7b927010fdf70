"""PNG files without PIL: a reader on ``zlib`` + numpy, and a small writer.

``read_png`` decodes non-interlaced 8-bit PNGs of every colour type (grey,
grey + alpha, RGB, RGBA, palette) to the array ``np.array(Image.open(p))``
gives, or with ``mode="RGB"`` to ``np.array(Image.open(p).convert("RGB"))``:
alpha dropped, grey replicated, the palette looked up; and 16-bit grey
PNGs (the KITTI disparity maps, ``disparity × 256``) to uint16. Chunk CRCs
are checked as Pillow checks them. Interlaced files, 16-bit files of
other colour types and 1/2/4-bit ones raise ``NotImplementedError``: the
ACDC and Cityscapes files are 8-bit RGB frames and 8-bit grey label maps.

Unfiltering is the cost. None, Sub (a running byte sum along the row) and
Up (a byte sum down the rows) vectorise by rows. Average and Paeth read the
pixel on the left as it comes out, so a row of them is sequential; rows
with them are decoded along anti-diagonals instead, on a copy of the rows
shifted right by one pixel a row, where pixel (r, x) sits in column r + x:
its left, upper and upper-left neighbours are then in the two columns
before it, and one column is one vectorised step over all the rows.

``write_png`` writes the same file types, and 16-bit grey from uint16,
with a chosen filter, one filter a row, or ``"adaptive"``: each row's
filter chosen as Pillow's encoder chooses it, so the tests and
``chip_smoke.py`` make fixtures on a machine without PIL. A 16-bit sample
is two big-endian bytes, and the filters work on bytes, two a pixel.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels a pixel (PNG spec, table 11.1)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# Pillow's encoder (libImaging/ZipEncode.c) tries these filters on each row
# in this order and keeps the first with the least sum of |signed byte|
_ADAPTIVE_ORDER = (NONE, UP, SUB, PAETH)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _paeth(a, b, c):
    """PNG's Paeth predictor on int16 arrays."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonal(rows: np.ndarray, kinds: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Reconstruct rows (n, W, bpp) of any filters, given the row above them
    (W, bpp), along anti-diagonals. Pixel x of row r (row 0: ``prior``)
    sits at step r + 1 + x of ``sk`` (steps, rows, bpp), so its left and
    upper neighbours are at the step before it and the upper-left one two
    steps before; every other entry is 0, as PNG reads the pixels left of a
    row and above the image. The walk takes n + W steps."""
    n, w, bpp = rows.shape
    sk = np.zeros((n + w + 1, n + 1, bpp), np.int16)
    sk[1:w + 1, 0] = prior
    for r in range(n):
        sk[r + 2:r + 2 + w, r + 1] = rows[r]
    # the linear filters as (ca·a + cb·b) >> 1: None (0, 0), Sub (2, 0),
    # Up (0, 2), Average (1, 1); Paeth rows take the Paeth predictor
    ca = np.choose(kinds, [0, 2, 0, 1, 0]).astype(np.int16)[:, None]
    cb = np.choose(kinds, [0, 0, 2, 1, 0]).astype(np.int16)[:, None]
    is_paeth = (kinds == PAETH).astype(np.int16)[:, None]
    any_paeth, all_paeth = bool(is_paeth.any()), bool(is_paeth.all())
    for t in range(2, n + w + 1):
        lo, hi = max(1, t - w), min(n, t - 1)          # the rows with a pixel at step t
        a = sk[t - 1, lo:hi + 1]
        b = sk[t - 1, lo - 1:hi]
        if all_paeth:
            pred = _paeth(a, b, sk[t - 2, lo - 1:hi])
        else:
            pred = (ca[lo - 1:hi] * a + cb[lo - 1:hi] * b) >> 1
            if any_paeth:
                pred += (_paeth(a, b, sk[t - 2, lo - 1:hi]) - pred) * is_paeth[lo - 1:hi]
        f = sk[t, lo:hi + 1]
        f += pred
        f &= 255
    out = np.empty((n, w, bpp), np.uint8)
    for r in range(n):
        out[r] = sk[r + 2:r + 2 + w, r + 1]
    return out


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """PNG's five scanline filters undone (spec §9): (h, w, bpp) uint8.
    Average and Paeth rows go through the diagonal walk, together with the
    rows between them unless more than W rows of the other filters part
    them (a walk costs W steps more than its rows); the other rows go row
    by row."""
    lines = raw.reshape(h, 1 + w * bpp)
    kinds = lines[:, 0]
    if kinds.max(initial=0) > PAETH:
        raise ValueError(f"PNG filter type {int(kinds.max())} does not exist")
    data = lines[:, 1:].reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    prior = np.zeros((w, bpp), np.uint8)
    hard = np.flatnonzero(kinds >= AVERAGE)
    r = 0
    while r < h:
        nxt = hard[np.searchsorted(hard, r)] if len(hard) and hard[-1] >= r else h
        for rr in range(r, nxt):                          # rows before the next walk
            k = kinds[rr]
            if k == NONE:
                out[rr] = data[rr]
            elif k == SUB:
                np.cumsum(data[rr], axis=0, dtype=np.uint8, out=out[rr])
            else:
                np.add(data[rr], prior, out=out[rr])
            prior = out[rr]
        if nxt == h:
            break
        end = nxt                                          # the walk's last hard row
        for j in hard[np.searchsorted(hard, nxt):]:
            if j - end > w:
                break
            end = j
        out[nxt:end + 1] = _unfilter_diagonal(data[nxt:end + 1], kinds[nxt:end + 1], prior)
        prior = out[end]
        r = end + 1
    return out


def read_png(path, mode: Optional[str] = None) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced PNG as uint8: what
    ``np.array(Image.open(path))`` gives ((H, W) grey or palette indices,
    (H, W, 2) grey + alpha, (H, W, 3) RGB, (H, W, 4) RGBA), or with
    ``mode="RGB"`` what ``.convert("RGB")`` gives; a 16-bit grey PNG as
    (H, W) uint16 (Pillow's ``I;16``), without ``mode``."""
    if mode not in (None, "RGB"):
        raise ValueError(f"read_png: mode None or 'RGB', got {mode!r}")
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or compression != 0 or filtering != 0:
        raise ValueError(f"{path}: PNG colour type {color}, compression {compression}, "
                         f"filter method {filtering} do not exist")
    wide = depth == 16 and color == 0 and mode is None
    if depth != 8 and not wide:
        raise NotImplementedError(f"{path}: {depth}-bit PNG of colour type {color}; the reader "
                                  "decodes 8-bit samples and 16-bit grey")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG; the reader decodes "
                                  "non-interlaced files")
    bpp = _CHANNELS[color] * (2 if wide else 1)     # bytes a pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for {w}x{h}x{bpp}")
    pix = _unfilter(raw, h, w, bpp)
    if wide:
        return pix.view(">u2")[..., 0].astype(np.uint16)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = pix[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the {len(palette)} PLTE entries")
        return palette[idx] if mode == "RGB" else idx
    if mode == "RGB":
        if color in (0, 4):
            return np.repeat(pix[..., :1], 3, axis=2)
        return np.ascontiguousarray(pix[..., :3])
    return pix[..., 0] if bpp == 1 else pix


def _filter_rows(img: np.ndarray, kinds) -> np.ndarray:
    """Scanlines (h, 1 + w·bpp) of ``img`` (h, w, bpp), row r with filter
    ``kinds[r]``, or with ``kinds="adaptive"`` Pillow's choice for it: of
    None, Up, Sub and Paeth, in that order, the first whose filtered bytes,
    read as signed, have the least sum of magnitudes."""
    h, w, bpp = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    filtered = ((x - preds) & 255).astype(np.uint8).reshape(5, h, w * bpp)
    if isinstance(kinds, str):
        cost = np.minimum(filtered, 256 - filtered.astype(np.int32)).sum(axis=2)
        order = np.array(_ADAPTIVE_ORDER)
        kinds = order[np.argmin(cost[order], axis=0)]      # argmin keeps the first
    lines = np.empty((h, 1 + w * bpp), np.uint8)
    lines[:, 0] = kinds
    lines[:, 1:] = filtered[kinds.astype(np.int64), np.arange(h)]
    return lines


def write_png(path, img, filter_type: Union[int, Sequence[int], str] = NONE,
              palette: Optional[np.ndarray] = None) -> None:
    """Write a uint8 array as an 8-bit PNG: (H, W) grey, (H, W, 2) grey +
    alpha, (H, W, 3) RGB, (H, W, 4) RGBA, or (H, W) indices into
    ``palette`` (n, 3); or a uint16 (H, W) array as a 16-bit grey PNG.
    ``filter_type`` is one of the five filters for every row, a sequence
    with one for each row, or ``"adaptive"`` for Pillow's choice row by row
    (None on every row of a palette image)."""
    img = np.asarray(img)
    wide = img.dtype == np.uint16 and img.ndim == 2 and palette is None
    if not wide and (img.dtype != np.uint8 or img.ndim not in (2, 3)):
        raise TypeError(f"write_png: a uint8 (H, W) or (H, W, C) array or a uint16 (H, W) "
                        f"one, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    if wide:   # big-endian sample bytes, filtered as two bytes a pixel
        img = img.astype(">u2").view(np.uint8).reshape(h, w, 2)
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if bpp != 1 or not 1 <= len(palette) <= 256 or int(img.max(initial=0)) >= len(palette):
            raise ValueError("write_png: palette images are (H, W) indices into 1-256 colours")
        color = 3
    else:
        color = {1: 0, 2: 4, 3: 2, 4: 6}.get(bpp)
        if color is None:
            raise ValueError(f"write_png: {bpp} channels")
    if isinstance(filter_type, str):
        if filter_type != "adaptive":
            raise ValueError(f"write_png: filter types are 0-4 or 'adaptive', got "
                             f"{filter_type!r}")
        # Pillow writes 8-bit palette indices unfiltered
        kinds = np.zeros(h, np.uint8) if palette is not None else filter_type
    else:
        kinds = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
        if kinds.max(initial=0) > PAETH:
            raise ValueError(f"write_png: filter types are 0-4, got {filter_type}")
    lines = _filter_rows(img.reshape(h, w, 2 if wide else bpp), kinds)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    parts = [_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16 if wide else 8, color,
                                                     0, 0, 0))]
    if palette is not None:
        parts.append(chunk(b"PLTE", palette.tobytes()))
    parts += [chunk(b"IDAT", zlib.compress(lines.tobytes())), chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))
