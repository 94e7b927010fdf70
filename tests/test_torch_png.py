"""The port's PNG reader and writer (``data/png.py``) vs Pillow.

No tolerance: a decoded PNG is exact. ``read_png`` gives
``np.array(Image.open(p))`` and, with ``mode="RGB"``,
``np.array(Image.open(p).convert("RGB"))``, for files Pillow wrote (its
own choice of filters a row) and for files ``write_png`` wrote with each of
the five filters and with a different filter on consecutive rows, in grey,
grey + alpha, RGB, RGBA and palette modes, and 16-bit grey (Pillow's
``I;16``, the KITTI disparity maps) both ways. ``write_png(..., "adaptive")``
filters each row as Pillow's encoder does: the same scanline bytes. The
routes not ported raise.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png

SHAPE = (23, 37)
MODES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,), "P": ()}
# each filter on every row, then all five in turns, then runs of the
# sequential ones between the others, then Pillow's choice a row
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4,
           "mixed": [0, 1, 2, 3, 4] * 5,
           "runs": [3, 3, 4, 4, 4, 1, 2, 3, 4, 0, 4, 3] * 2,
           "adaptive": "adaptive"}


def pixels(mode, rng):
    arr = rng.integers(0, 256, SHAPE + MODES[mode]).astype(np.uint8)
    # smooth parts, where the predictors have something to predict
    arr[:, : SHAPE[1] // 2] = arr[:1, : SHAPE[1] // 2]
    if mode == "P":
        arr %= 200
    return arr


def assert_reads_like_pil(path):
    with Image.open(path) as im:
        want = np.array(im)
        want_rgb = np.array(im.convert("RGB"))
    got, got_rgb = read_png(path), read_png(path, mode="RGB")
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got_rgb.shape == want_rgb.shape
    np.testing.assert_array_equal(got_rgb, want_rgb)


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_of_pil_files(tmp_path, rng, mode):
    arr = pixels(mode, rng)
    im = Image.fromarray(arr, mode)
    if mode == "P":   # 256 colours: Pillow writes 8-bit indices
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    im.save(tmp_path / "f.png")
    assert_reads_like_pil(tmp_path / "f.png")


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("mode", list(MODES))
def test_write_png_filters_read_back(tmp_path, rng, mode, filt):
    """Pillow reads ``write_png``'s file as the pixels written, and
    ``read_png`` reads it as Pillow does."""
    arr = pixels(mode, rng)
    kinds = FILTERS[filt]
    kinds = kinds[: SHAPE[0]] if isinstance(kinds, list) else kinds
    palette = rng.integers(0, 256, (200, 3)).astype(np.uint8) if mode == "P" else None
    write_png(tmp_path / "f.png", arr, kinds, palette=palette)
    with Image.open(tmp_path / "f.png") as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.array(im), arr)
    assert_reads_like_pil(tmp_path / "f.png")


def _scanlines(path):
    """The filter byte and filtered bytes of each row: the inflated IDAT."""
    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    return zlib.decompress(b"".join(idat))


@pytest.mark.parametrize("mode", list(MODES))
def test_write_png_adaptive_filters_rows_as_pil(tmp_path, rng, mode):
    """``"adaptive"`` picks Pillow's filter on every row (its four
    candidates, its order, its ties; None on palette indices): the inflated
    scanlines are Pillow's, byte for byte, on noise, smooth ramps and flat
    rows."""
    arr = pixels(mode, rng)
    ramp = (np.arange(SHAPE[1]) * 7 + np.arange(SHAPE[0])[:, None] * 3) % 200
    arr[SHAPE[0] // 3: 2 * SHAPE[0] // 3] = ramp[SHAPE[0] // 3: 2 * SHAPE[0] // 3].reshape(
        (-1, SHAPE[1]) + (1,) * len(MODES[mode])).astype(np.uint8)
    arr[-2:] = arr[-1:, :1]
    im = Image.fromarray(arr, mode)
    palette = rng.integers(0, 256, (200, 3)).astype(np.uint8) if mode == "P" else None
    if mode == "P":
        im.putpalette(palette.tobytes())
    im.save(tmp_path / "pil.png")
    write_png(tmp_path / "port.png", arr, "adaptive", palette=palette)
    want, got = _scanlines(tmp_path / "pil.png"), _scanlines(tmp_path / "port.png")
    kinds = set(want[:: 1 + SHAPE[1] * (MODES[mode] or (1,))[0]])
    # Pillow filters palette indices with None only; the others choose
    assert kinds == {0} if mode == "P" else len(kinds) >= 3
    assert got == want
    assert_reads_like_pil(tmp_path / "port.png")


def _rewrite_ihdr(path, **fields):
    """Change IHDR fields of a PNG in place, with a valid CRC."""
    data = bytearray(open(path, "rb").read())
    names = ["width", "height", "depth", "color", "compression", "filtering", "interlace"]
    values = dict(zip(names, struct.unpack(">IIBBBBB", bytes(data[16:29]))))
    values.update(fields)
    body = struct.pack(">IIBBBBB", *(values[n] for n in names))
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    open(path, "wb").write(bytes(data))


def sixteen_bit(rng):
    arr = rng.integers(0, 65536, SHAPE).astype(np.uint16)
    arr[:, : SHAPE[1] // 2] = arr[:1, : SHAPE[1] // 2]
    arr[-1] = [0, 255, 256, 65535] * (SHAPE[1] // 4) + [1] * (SHAPE[1] % 4)   # byte edges
    return arr


def test_read_png_of_pil_16_bit_grey(tmp_path, rng):
    arr = sixteen_bit(rng)
    Image.fromarray(arr).save(tmp_path / "pil.png")
    assert Image.open(tmp_path / "pil.png").mode == "I;16"
    got = read_png(tmp_path / "pil.png")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, np.array(Image.open(tmp_path / "pil.png")))
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("filt", list(FILTERS))
def test_write_png_16_bit_grey_reads_back(tmp_path, rng, filt):
    arr = sixteen_bit(rng)
    kinds = FILTERS[filt]
    write_png(tmp_path / "port.png", arr, kinds[:SHAPE[0]] if isinstance(kinds, list) else kinds)
    im = Image.open(tmp_path / "port.png")
    assert im.mode == "I;16"
    np.testing.assert_array_equal(np.array(im), arr)
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"), arr)


def test_read_png_refuses_what_it_does_not_decode(tmp_path, rng):
    img = rng.integers(0, 256, (8, 9, 3)).astype(np.uint8)
    p = tmp_path / "f.png"
    Image.fromarray(rng.integers(0, 65535, (8, 9)).astype(np.uint16)).save(p)
    with pytest.raises(NotImplementedError, match="16-bit"):
        read_png(p, mode="RGB")                  # 16-bit grey decodes without a mode
    write_png(p, img)
    _rewrite_ihdr(p, depth=16)
    with pytest.raises(NotImplementedError, match="16-bit PNG of colour type 2"):
        read_png(p)
    im = Image.fromarray((img[..., 0] % 4), "P")
    im.putpalette(bytes(range(12)))
    im.save(p)                                   # 4 colours: Pillow writes 2-bit indices
    with pytest.raises(NotImplementedError, match="2-bit"):
        read_png(p)
    write_png(p, img)
    _rewrite_ihdr(p, interlace=1)
    with pytest.raises(NotImplementedError, match="interlaced"):
        read_png(p)
    write_png(p, img)
    data = bytearray(open(p, "rb").read())
    data[-20] ^= 0xFF                            # a byte of the IDAT payload
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(p)
    with pytest.raises(ValueError, match="mode"):
        read_png(p, mode="L")
    with pytest.raises(ValueError, match="filter types"):
        write_png(p, img, 5)
    with pytest.raises(ValueError, match="filter types"):
        write_png(p, img, "paeth")
