"""PNG decode and encode with zlib and numpy: the image I/O of the port,
which carries no imaging library (the JAX package reads and writes through
imageio and PIL).

Decodes what a capture and the writers produce: 8- and 16-bit gray, gray +
alpha, RGB and RGBA, not interlaced, with any of the five row filters.
Returns what ``imageio.v3.imread`` returns: uint8 or uint16 arrays, [H, W]
for gray and [H, W, C] otherwise. Encodes without filtering (filter 0 on
every row).

Sub depends on the pixel to the left only and runs as a running sum per
row; Average and Paeth also depend on the row above and its left
neighbour, so images with such rows are reconstructed one anti-diagonal
(y + x = const) at a time: every pixel of a diagonal depends only on the
two diagonals before it.
"""

import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> colour type


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _header(ihdr: bytes):
    """IHDR -> (width, height, bit depth, colour type, interlace)."""
    width, height, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    return width, height, depth, colour, interlace


def image_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG file, from its header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    kind, ihdr = next(_chunks(head))
    if kind != b"IHDR":
        raise ValueError(f"{path}: the first chunk is {kind!r}, not IHDR")
    return _header(ihdr)[:2]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filters: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Rows with filters None, Sub and Up only: one row at a time."""
    out = np.empty_like(data)
    prev = np.zeros(data.shape[1], np.uint8)
    for y, kind in enumerate(filters):
        row = data[y]
        if kind == 1:  # uint8 sums wrap modulo 256, as the filter does
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = row + prev
        out[y] = row
        prev = out[y]
    return out


def _unfilter_wavefront(filters: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: one anti-diagonal of pixels at a time."""
    height, stride = data.shape
    width = stride // bpp
    filt = data.reshape(height, width, bpp).astype(np.int32)
    # padded by one row above and one column on the left, both zero
    rec = np.zeros((height + 1, width + 1, bpp), np.int32)
    kinds = filters.astype(np.int32)
    for d in range(height + width - 1):
        ys = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        xs = d - ys
        a = rec[ys + 1, xs]      # left
        b = rec[ys, xs + 1]      # up
        c = rec[ys, xs]          # up-left
        kind = kinds[ys][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].reshape(height, stride).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 / uint16 array ([H, W] gray, else [H, W, C])."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16):
        raise NotImplementedError(f"PNG colour type {colour} at bit depth {depth} "
                                  f"(8- and 16-bit gray, gray+alpha, RGB, RGBA only)")
    if interlace:
        raise NotImplementedError("interlaced PNG")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not "
                         f"{height} x {stride + 1}")
    raw = raw.reshape(height, stride + 1)
    filters, rows = raw[:, 0], raw[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {filters.max()}")
    if (filters >= 3).any():
        pixels = _unfilter_wavefront(filters, rows, bpp)
    else:
        pixels = _unfilter_rows(filters, rows, bpp)
    if depth == 16:
        image = np.frombuffer(pixels.tobytes(), ">u2").astype(np.uint16)
    else:
        image = pixels
    image = image.reshape(height, width, channels)
    return image[:, :, 0] if channels == 1 else image


def imread(path) -> np.ndarray:
    return decode(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 / uint16 [H, W] or [H, W, C] (C in 1-4) -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG encode takes uint8 or uint16, not {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    height, width, channels = image.shape
    if channels not in _COLOUR_TYPE:
        raise ValueError(f"{channels} channels")
    depth = 8 * image.dtype.itemsize
    rows = np.frombuffer(image.astype(image.dtype.newbyteorder(">")).tobytes(),
                         np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth,
                       _COLOUR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def imwrite(path, image: np.ndarray) -> None:
    Path(path).write_bytes(encode(image))
