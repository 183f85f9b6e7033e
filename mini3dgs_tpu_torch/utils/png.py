"""An 8-bit PNG codec on the standard library's zlib (no Pillow).

`decode` reads non-interlaced 8-bit greyscale, RGB and RGBA images with any
of the five row filters and checks every chunk's CRC; anything else (a
palette, 16 bits, grey with alpha, interlacing) raises ValueError.
`encode` writes the same three kinds, every row with filter 0.

Paeth and Average are sequential along a row and each row needs the one
above, so a pixel depends on its left, upper and upper-left neighbours.
`decode` therefore unfilters along anti-diagonals: pixel (r, c) waits only
for pixels on diagonals r + c - 1 and r + c - 2, so one numpy step takes a
whole diagonal, over all channels, with each row's own filter: H + W - 1
steps for an H x W image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (8 bits each)


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _unfilter(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters.  `filtered` [H, W, C] uint8, `ftype` [H]."""
    H, W, C = filtered.shape
    # Diagonal-major layout: pixel (r, c) at D[r + c + 1, r + 1], so a
    # diagonal is one contiguous row of D and the neighbours sit in the two
    # rows before it.  D[:, 0] (the row above the image) and every place
    # left of a row's first pixel stay 0, as the filters' edges want.
    D = np.zeros((H + W + 1, H + 1, C), np.int16)
    F = np.zeros((H + W + 1, H, C), np.int16)
    rows = np.arange(H)[:, None]
    diag = rows + np.arange(W)[None, :] + 1
    F[diag, rows] = filtered
    ft = ftype[:, None]
    sub, up, avg, paeth = (ft == k for k in (1, 2, 3, 4))
    for j in range(1, H + W):
        lo, hi = max(0, j - W), min(H, j)
        a = D[j - 1, lo + 1:hi + 1]          # left
        b = D[j - 1, lo:hi]                  # up
        c = D[j - 2, lo:hi]                  # upper left (D[-1] is 0)
        ac, bc = a - c, b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        pth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(sub[lo:hi], a, np.where(up[lo:hi], b, np.where(
            avg[lo:hi], (a + b) >> 1, pth * paeth[lo:hi])))
        D[j, lo + 1:hi + 1] = (F[j, lo:hi] + pred) & 255
    return D[diag, rows + 1].astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (grey) or [H, W, 3 | 4]."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (8-bit grey, RGB or RGBA, "
            "non-interlaced only)")
    C = CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError(f"PNG data holds {raw.size} bytes, not "
                         f"{H * (1 + W * C)}")
    raw = raw.reshape(H, 1 + W * C)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter {int(ftype.max())}")
    pixels = raw[:, 1:].reshape(H, W, C)
    if (ftype == 0).all():
        out = pixels.copy()
    else:
        out = _unfilter(pixels, ftype)
    return out[..., 0] if C == 1 else out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W] or [H, W, 3 | 4] -> PNG bytes (filter 0 on every
    row)."""
    arr = np.ascontiguousarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode takes uint8, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(C)
    if ctype is None:
        raise ValueError(f"encode takes 1, 3 or 4 channels, not {C}")
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           arr.reshape(H, W * C)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
