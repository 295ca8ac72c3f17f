"""A PNG writer and reader on the standard library alone (zlib and struct)
and numpy.

The writer takes 8-bit grayscale (H, W) or RGB (H, W, 3) images and writes
them non-interlaced, every scanline with filter 0. It stands in for an
imaging library's PNG encoder in the CLIs' image grids and video frames.

The reader takes what an imaging library writes for a dataset: 8-bit
grayscale, grayscale with alpha, RGB and RGBA, non-interlaced, with any of
the 5 scanline filters. It returns (H, W) or (H, W, C) uint8. An interlaced,
palette or 16-bit file raises ``ValueError``. It stands in for an imaging
library in the training dataset (``data/dataset.py``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _chunk(tag, data):
    return (struct.pack('>I', len(data)) + tag + data
            + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))


def write_png(path, image, level=6):
    """Write ``image``, uint8 (H, W) or (H, W, 3), to ``path``."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f'a PNG takes uint8 pixels, not {img.dtype}')
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f'a PNG takes (H, W) or (H, W, 3), not {img.shape}')
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(_SIGNATURE + _chunk(b'IHDR', header)
                + _chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
                + _chunk(b'IEND', b''))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> samples a pixel


def _unfilter(raw, h, w, bpp):
    """Undo the scanline filters (PNG spec 9.2): ``raw`` holds h rows of a
    filter byte and w * bpp bytes."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:      # Sub: a running sum at each byte of a pixel
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: a byte at a time
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xff
                    continue
                c = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 0xff
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f'unknown PNG filter type {kind}')
        out[y] = prev = cur
    return out


def read_png(f):
    """An image from a PNG file: a path or a binary file object."""
    if not hasattr(f, 'read'):
        with open(f, 'rb') as fh:
            return read_png(fh)
    data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError('not a PNG file')
    pos, header, idat = 8, None, []
    while pos < len(data):
        length, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'IEND':
            break
    if header is None:
        raise ValueError('a PNG without an IHDR chunk')
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f'only 8-bit gray, gray + alpha, RGB or RGBA PNGs '
                         f'are read, not bit depth {depth}, color type '
                         f'{color}')
    if interlace:
        raise ValueError('interlaced PNGs are not read')
    bpp = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b''.join(idat)), h, w, bpp)
    return img.reshape(h, w) if bpp == 1 else img.reshape(h, w, bpp)
