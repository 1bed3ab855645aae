"""Host-side imaging: PNG export and video frame recording.

Counterpart of gym_pybullet_adrp_tpu/utils/rendering.py
(``export_image`` :18, ``VideoRecorder`` :39): the reference's
``BaseAviary._exportImage`` (:625-658), its PNG-frame recording in
DIRECT mode (:296-321) and the ``ffmpeg_png2mp4.sh`` asset. Frames come
from the ray-casting renderer (ops/render.py) and are numpy arrays here.
PNGs are written by ``png_bytes`` (zlib and struct of the standard
library, 8-bit RGBA, RGB or grey), so nothing here needs PIL; ``read_png``
decodes what it writes. ffmpeg is optional.
"""

import os
import struct
import subprocess
import zlib
from datetime import datetime

import numpy as np

from .enums import ImageType

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG colour type by channel count: grey, RGB, RGBA
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOUR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img) -> bytes:
    """The PNG file of a uint8 image (H, W) grey, (H, W, 3) RGB or (H, W,
    4) RGBA: 8 bits a channel, no interlace, every row filter 0 (none),
    the rows zlib-compressed."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"png_bytes: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"png_bytes: expected (H, W), (H, W, 3) or (H, W, "
                         f"4), got {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (PNG_MAGIC + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def read_png(data: bytes) -> np.ndarray:
    """The uint8 image of a PNG that ``png_bytes`` wrote (8-bit grey, RGB
    or RGBA, filter 0 on every row): (H, W, C), C = 1, 3 or 4. Raises on
    anything else."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("read_png: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"read_png: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"read_png: unsupported header {header}")
    c = _CHANNELS[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError("read_png: only filter 0 rows are read")
    return rows[:, 1:].reshape(h, w, c).copy()


def write_png(path: str, img) -> str:
    """Write ``img`` (``png_bytes``) to ``path``; returns ``path``."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))
    return path


def export_image(img_type: ImageType, img_input, path: str,
                 frame_num: int = 0):
    """Save one frame as ``path/frame_<n>.png`` (reference
    _exportImage:625-658): RGB as an RGBA image, depth and segmentation
    scaled to 0-255 grey, BW grey; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"frame_{frame_num}.png")
    img = np.asarray(img_input)
    if img_type == ImageType.RGB:
        img = img.astype("uint8")
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f"RGB frames are (H, W, 4), got {img.shape}")
        write_png(out, img)
    elif img_type in (ImageType.DEP, ImageType.SEG):
        lo, hi = np.min(img), np.max(img)
        scaled = ((img - lo) * 255 / max(hi - lo, 1e-9)).astype("uint8")
        write_png(out, scaled)
    elif img_type == ImageType.BW:
        bw = (np.sum(img[:, :, 0:2], axis=2) / 3).astype("uint8")
        write_png(out, bw)
    else:
        raise ValueError("unknown ImageType")
    return out


class VideoRecorder:
    """PNG-frame video recorder with mp4 assembly (reference :296-321 and
    assets/ffmpeg_png2mp4.sh)."""

    def __init__(self, output_folder: str = "results", fps: int = 24):
        self.fps = fps
        self.frame_num = 0
        self.path = os.path.join(
            output_folder,
            "recording_" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
        os.makedirs(self.path, exist_ok=True)

    def add_frame(self, rgba):
        export_image(ImageType.RGB, rgba, self.path, self.frame_num)
        self.frame_num += 1

    def to_mp4(self, out_name: str = "video.mp4"):
        """Assemble the frames with ffmpeg where it is installed; returns
        the mp4's path, or None (the frames stay on disk)."""
        out = os.path.join(self.path, out_name)
        cmd = ["ffmpeg", "-y", "-framerate", str(self.fps),
               "-i", os.path.join(self.path, "frame_%d.png"),
               "-c:v", "libx264", "-pix_fmt", "yuv420p", out]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            return out
        except (FileNotFoundError, subprocess.CalledProcessError):
            return None
