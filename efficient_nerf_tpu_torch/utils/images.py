"""Image and video output, and a PNG codec of the standard library's own.

`to8b`, `save_image` and `save_video` follow `efficient_nerf_tpu.utils.images`
(to8b as reference helpers.py:18). PNGs go through `read_png`/`write_png`,
which use `zlib` and `struct` only, so that the port reads and writes its
scenes on a machine without `imageio`. They handle 8-bit grey, grey+alpha,
RGB and RGBA, non-interlaced, and every filter type on reading; anything
else raises `ValueError` naming the feature.

`save_video` writes mp4 through `imageio` where it imports and can encode,
and `<path>.npz` (the frames, uint8) otherwise. The JAX package falls back
to the `.npz` when its mp4 writer fails; the port also does so when
`imageio` is missing.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["to8b", "save_image", "save_video", "read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def save_image(path: str, img) -> None:
    write_png(path, to8b(img))


def save_video(path: str, frames, fps: int = 30, quality: int = 8) -> str:
    """Write the frames as an mp4 at `path`, or as `<path>.npz` where
    `imageio` is missing or cannot encode; returns the path written."""
    frames = [to8b(f) for f in frames]
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(path, frames, fps=fps, quality=quality)
            return path
        except (ValueError, RuntimeError, OSError):  # no mp4 backend
            pass
    np.savez_compressed(path + ".npz", frames=np.stack(frames))
    return path + ".npz"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write an 8-bit image [H, W] or [H, W, C] (C = 1 grey, 2 grey+alpha,
    3 RGB, 4 RGBA) as a PNG, its rows unfiltered (filter type 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png writes 8-bit samples; got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4]; got {img.shape}")
    H, W, C = img.shape
    rows = np.ascontiguousarray(img).reshape(H, W * C)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOUR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, line: bytearray, prev: bytearray, bpp: int) -> None:
    """Undo one row's filter in place (PNG specification, section 9)."""
    n = len(line)
    if kind == 0:
        return
    if kind == 1:      # a running sum along each channel
        cur = np.frombuffer(bytes(line), np.uint8).reshape(-1, bpp)
        line[:] = (np.cumsum(cur, axis=0, dtype=np.int64) % 256).astype(np.uint8).tobytes()
    elif kind == 2:
        cur = np.frombuffer(bytes(line), np.uint8).astype(np.int32)
        line[:] = ((cur + np.frombuffer(bytes(prev), np.uint8)) % 256).astype(np.uint8).tobytes()
    elif kind == 3:
        for i in range(bpp):
            line[i] = (line[i] + (prev[i] >> 1)) & 0xFF
        for i in range(bpp, n):
            line[i] = (line[i] + ((line[i - bpp] + prev[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(bpp):
            line[i] = (line[i] + prev[i]) & 0xFF   # a = c = 0: Paeth picks b
        for i in range(bpp, n):
            a, b, c = line[i - bpp], prev[i], prev[i - bpp]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG row filter type {kind} does not exist (0-4)")


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced grey, grey+alpha, RGB or RGBA PNG ->
    uint8 [H, W] (grey) or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit samples are not supported (8-bit only)")
    if colour not in _CHANNELS:
        what = "palette (indexed) colour" if colour == 3 else f"colour type {colour}"
        raise ValueError(f"{path}: {what} is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    C = _CHANNELS[colour]
    stride = W * C
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, expected "
                         f"{H * (stride + 1)}")
    out = bytearray(H * stride)
    prev = bytearray(stride)
    for y in range(H):
        start = y * (stride + 1)
        line = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], line, prev, C)
        out[y * stride:(y + 1) * stride] = line
        prev = line
    img = np.frombuffer(bytes(out), np.uint8).reshape(H, W, C)
    return img[..., 0] if C == 1 else img
