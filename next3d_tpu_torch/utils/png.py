"""A PNG writer on the standard library alone (zlib and struct).

8-bit grayscale (H, W) or RGB (H, W, 3) images, non-interlaced, every
scanline with filter 0. It stands in for an imaging library's PNG encoder
in the CLIs' image grids and video frames.
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
