"""Image and video files (ref run_nerf.py:166-169, 670, 808-809).

A small PNG codec on ``zlib``, ``struct`` and numpy, so the port reads and
writes frames with no imaging package: ``read_png`` takes 8-bit gray, gray
with alpha, RGB and RGBA, not interlaced, and undoes all five filter types
(what Pillow's and libpng's adaptive filtering write); ``write_png`` writes
the same types with filter 0. ``save_video`` writes an mp4 when ``imageio``
and its ffmpeg backend import, else the frames as PNGs, as nerf_tpu does.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from nerf_tpu_torch.utils.metrics import to8b

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples a pixel
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 ``img`` [H, W] or [H, W, C] (C = 1, 2, 3 or 4) as an
    8-bit PNG, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes 1 to 4 channels, got {C}")
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], 1)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOUR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the per-row filters: ``data`` [H, W, bpp] filtered bytes (as
    int32), ``ftype`` [H] the rows' filter types. Returns uint8 [H, W, bpp].

    Average and Paeth read the pixel to the left and the row above, so the
    pixels go in anti-diagonal fronts: every pixel of a front depends only
    on earlier fronts, and each front is one vectorised step over up to
    min(H, W) pixels, whatever the rows' filters."""
    H, W, bpp = data.shape
    if np.any(ftype > 4):
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.zeros((H + 1, W + 1, bpp), np.int32)  # a zero row above, a zero column left
    ft = ftype[:, None]
    for t in range(H + W - 1):
        ys = np.arange(max(0, t - W + 1), min(H - 1, t) + 1)
        xs = t - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        f = ft[ys]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (data[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA PNG as uint8
    [H, W] (gray) or [H, W, C], as ``imageio.imread`` returns it."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    W, H, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit, non-interlaced gray/RGB(A) PNGs are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    C = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * C)
    img = _unfilter(raw[:, 0], raw[:, 1:].reshape(H, W, C).astype(np.int32))
    return img[..., 0] if C == 1 else img


def save_png(path: str, img: np.ndarray) -> None:
    """A float image in [0, 1] as an 8-bit PNG."""
    write_png(path, to8b(np.asarray(img)))


def save_video(path: str, frames: np.ndarray, fps: int = 30, quality: int = 8) -> str:
    """Write ``frames`` [N, H, W(, C)] in [0, 1] as an mp4 (the reference's
    fps=30, quality=8) when imageio and its ffmpeg backend import; otherwise
    as ``<path without .mp4>_frames/NNN.png``, nerf_tpu's fallback. Returns
    the path written."""
    frames = to8b(np.asarray(frames))
    try:
        import imageio.v2 as imageio
        import imageio_ffmpeg  # noqa: F401  (the mp4 backend)
    except ImportError:
        outdir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(outdir, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(outdir, f"{i:03d}.png"), f)
        return outdir
    imageio.mimwrite(path, frames, fps=fps, quality=quality)
    return path
