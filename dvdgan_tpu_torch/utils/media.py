"""Sample dumps: a video grid PNG and animated GIFs — the counterpart of
`dvdgan_tpu/utils/media.py`, with its layout and file names.

Written with the standard library and numpy only (a card's machine may have
neither PIL nor imageio): the PNG is 8-bit RGB, its rows deflated with
`zlib` and framed with `struct`; the GIF comes from the small encoder
below, with a fixed 3-3-2 RGB palette (each channel rounded to its nearest
palette level: 8 for red and green, 4 for blue) and LZW whose code table is
cleared before it fills.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def denorm_uint8(video: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8 (×0.5+0.5, the reference's denorm)."""
    v = (np.asarray(video, np.float32) * 0.5 + 0.5).clip(0.0, 1.0)
    return (v * 255.0 + 0.5).astype(np.uint8)


def video_grid(videos: np.ndarray, pad: int = 2) -> np.ndarray:
    """(B, T, H, W, 3) -> (B*H', T*W', 3) grid: one row per sample, one
    column per frame."""
    b, t, h, w, c = videos.shape
    out = np.zeros((b * (h + pad) + pad, t * (w + pad) + pad, c),
                   videos.dtype)
    for i in range(b):
        for j in range(t):
            y = pad + i * (h + pad)
            x = pad + j * (w + pad)
            out[y:y + h, x:x + w] = videos[i, j]
    return out


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG."""
    h, w, c = image.shape
    if c != 3 or image.dtype != np.uint8:
        raise ValueError(f"want (H, W, 3) uint8, got {image.shape} "
                         f"{image.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),      # filter: none
                           np.ascontiguousarray(image).reshape(h, w * 3)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_video_grid_png(path: str, videos: np.ndarray) -> None:
    """videos: (B, T, H, W, 3) in [-1, 1]."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(video_grid(denorm_uint8(videos))))


# the 3-3-2 palette: index rrrgggbb, each level spread over 0..255
_LEVELS = {7: np.round(np.arange(8) * 255 / 7).astype(np.uint8),
           3: np.round(np.arange(4) * 255 / 3).astype(np.uint8)}
PALETTE = np.stack([_LEVELS[7][np.arange(256) >> 5],
                    _LEVELS[7][(np.arange(256) >> 2) & 7],
                    _LEVELS[3][np.arange(256) & 3]], axis=1)


def palette_indices(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> 3-3-2 palette indices (...), each channel to
    its nearest level."""
    f = frames.astype(np.uint16)
    r = (f[..., 0] * 7 + 127) // 255
    g = (f[..., 1] * 7 + 127) // 255
    b = (f[..., 2] * 3 + 127) // 255
    return ((r << 5) | (g << 2) | b).astype(np.uint8)


_CLEAR, _END, _MAX_CODE = 256, 257, 4095


def lzw_encode(indices: bytes) -> bytes:
    """GIF LZW of 8-bit palette indices (minimum code size 8): codes of 9
    to 12 bits packed LSB first; a clear code starts the stream and is
    sent again before the table reaches 4096 entries."""
    out = bytearray()
    acc = n_bits = 0
    width = 9

    def put(code):
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += width
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    table: dict[tuple[int, int], int] = {}
    next_code = _END + 1
    put(_CLEAR)
    it = iter(indices)
    w = next(it, None)
    if w is None:
        put(_END)
        return bytes(out)
    for k in it:
        code = table.get((w, k))
        if code is not None:
            w = code
            continue
        put(w)
        if next_code < _MAX_CODE:
            table[(w, k)] = next_code
            next_code += 1
            # the decoder, one entry behind, widens its codes here too
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            put(_CLEAR)
            table.clear()
            next_code, width = _END + 1, 9
        w = k
    put(w)
    put(_END)
    if n_bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames: np.ndarray, fps: int = 8) -> bytes:
    """(T, H, W, 3) uint8 -> the bytes of a looping GIF89a, one full-size
    frame every 1/fps s on the 3-3-2 palette."""
    t, h, w, _ = frames.shape
    delay = max(1, round(100 / fps))                  # hundredths of a s
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           PALETTE.tobytes(),
           # NETSCAPE2.0: loop forever
           b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
           + b"\x00"]
    for f in palette_indices(frames):
        out += [b"\x21\xF9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                b"\x08" + _sub_blocks(lzw_encode(f.tobytes()))]
    out.append(b"\x3B")
    return b"".join(out)


def save_gif(path: str, video: np.ndarray, fps: int = 8) -> None:
    """video: (T, H, W, 3) in [-1, 1] -> animated GIF."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_gif(denorm_uint8(video), fps))


def save_batch_gifs(out_dir: str, videos: np.ndarray, step: int,
                    max_n: int = 4, fps: int = 8) -> None:
    for i in range(min(max_n, videos.shape[0])):
        save_gif(os.path.join(out_dir, f"{step}_sample{i}.gif"),
                 videos[i], fps)
