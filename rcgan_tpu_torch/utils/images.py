"""Image grids and PNG files, ported from ``rcgan_tpu/utils/images.py``
(``merge``, ``save_images``, ``save_cifar_samples``, ``to_uint8_samples``;
reference: ``mnist/utils.py:21-250``, ``cifar10/common/misc.py``).

PNGs are encoded and decoded here with zlib and struct (:func:`encode_png`,
:func:`decode_png`), and animated grey GIFs with numpy
(:func:`encode_gif`), with no image library: the serving path, the apps'
sample grids, ``utils/visualize.py`` and the MS-SSIM CLI share them.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np


def image_manifold_size(num_images: int):
    h = int(math.floor(np.sqrt(num_images)))
    w = int(math.ceil(np.sqrt(num_images)))
    if h * w != num_images:
        raise ValueError(f"a grid of {num_images} images needs a square count")
    return h, w


def merge(images: np.ndarray, size) -> np.ndarray:
    """Tile [N, H, W, C] into one [size0*H, size1*W, C] grid."""
    h, w = images.shape[1], images.shape[2]
    c = images.shape[3] if images.ndim == 4 else 1
    img = np.zeros((int(h * size[0]), int(w * size[1]), c), dtype=images.dtype)
    for idx, image in enumerate(images):
        i = idx % size[1]
        j = idx // size[1]
        img[j * h : j * h + h, i * w : i * w + w] = image.reshape(h, w, c)
    return img if c > 1 else img[..., 0]


def encode_png(arr: np.ndarray) -> bytes:
    """8-bit PNG of uint8 ``arr``: ``[H, W, 3]`` RGB or ``[H, W]`` grey."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        color, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color, channels = 2, 3
    else:
        raise ValueError(f"encode_png wants [H, W] or [H, W, 3]; got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * channels)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


# channels of the 8-bit PNG colour types decode_png takes: grey, RGB, grey
# with alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline with its PNG filter undone (None, Sub, Up, Average,
    Paeth), against the reconstructed ``prior`` line."""
    if kind == 0:
        return row
    if kind == 2:
        return (row + prior).astype(np.uint8)
    if kind == 1:  # each byte adds the reconstructed byte bpp to its left
        return np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0).astype(np.uint8).ravel()
    if kind not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {kind}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        c = up[i - bpp] if i >= bpp else 0
        pred = (a + up[i]) >> 1 if kind == 3 else _paeth(a, up[i], c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """uint8 pixels of an 8-bit, non-interlaced PNG: ``[H, W]`` grey,
    ``[H, W, 2]`` grey with alpha, ``[H, W, 3]`` RGB or ``[H, W, 4]`` RGBA
    (the counterpart of :func:`encode_png`).  The IDAT chunks are inflated
    with zlib and each scanline's filter (None, Sub, Up, Average, Paeth)
    undone; other bit depths, palettes and interlacing raise."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG: only 8-bit, non-interlaced grey/RGB/RGBA is decoded; got bit "
                         f"depth {depth}, colour type {color}, interlace {interlace}")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of scanlines for {h} rows of {stride}")
    lines = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(lines[y, 0]), lines[y, 1:], prior, bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


# A GIF's LZW code stream of literal codes only: with 8-bit pixels every
# code is 9 bits wide as long as the decoder's table stays below 512
# entries, which a clear code every GIF_RUN pixels ensures (a clear resets
# the table; the table grows by one entry per code after the first).
GIF_RUN = 250


def _gif_lzw(pixels: np.ndarray) -> bytes:
    """The image data of one frame: the LZW minimum code size (8) and the
    code stream (clear, up to GIF_RUN literals, clear, ..., end), packed
    LSB first into sub-blocks of at most 255 bytes."""
    pixels = pixels.reshape(-1).astype(np.uint16)
    n_runs = max(1, -(-len(pixels) // GIF_RUN))
    codes = np.full(len(pixels) + n_runs + 1, 256, np.uint16)  # 256: clear
    at = np.arange(len(pixels))
    codes[at + at // GIF_RUN + 1] = pixels
    codes[-1] = 257  # end of information
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return b"\x08" + blocks + b"\x00"


def encode_gif(frames, duration_ms: int = 120) -> bytes:
    """An animated GIF89a of uint8 grey frames ``[H, W]`` (or ``[H, W,
    1]``) on a 256-level grey palette, looping forever, each frame shown
    ``duration_ms``."""
    frames = [np.asarray(f) for f in frames]
    frames = [f[..., 0] if f.ndim == 3 and f.shape[-1] == 1 else f for f in frames]
    if not frames or any(f.ndim != 2 or f.dtype != np.uint8 or f.shape != frames[0].shape
                         for f in frames):
        raise ValueError("encode_gif wants uint8 grey frames [H, W] of one shape")
    h, w = frames[0].shape
    grey = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), grey,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    delay = int(round(duration_ms / 10))
    for f in frames:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_gif_lzw(f))
    out.append(b"\x3b")
    return b"".join(out)


def save_images(images: np.ndarray, size, path: str):
    """``images`` [N, H, W, C] in [0, 1] float or uint8; writes a PNG grid."""
    grid = merge(np.asarray(images), size)
    if grid.dtype != np.uint8:
        grid = (np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(grid))


def save_cifar_samples(samples_flat: np.ndarray, path: str, img_size: int = 32, img_dim: int = 3):
    """[-1, 1] flat generator output → uint8 grid PNG
    (``gan_resnet.py:829-833``)."""
    n = samples_flat.shape[0]
    imgs = ((samples_flat + 1.0) * (255.0 / 2)).astype(np.uint8)
    imgs = imgs.reshape(n, img_size, img_size, img_dim)
    save_images(imgs, image_manifold_size(n), path)


def to_uint8_samples(samples_flat: np.ndarray, img_size: int = 32, img_dim: int = 3) -> np.ndarray:
    """``((x+1)*255.99/2).astype(int)`` reshaped, as fed to the label-accuracy
    classifier (``gan_resnet.py:850-861``)."""
    out = ((samples_flat + 1.0) * (255.99 / 2)).astype(np.int32)
    return out.reshape(-1, img_size, img_size, img_dim)
