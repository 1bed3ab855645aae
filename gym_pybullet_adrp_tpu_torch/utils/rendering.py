"""Host-side imaging: PNG export and video frame recording.

Counterpart of gym_pybullet_adrp_tpu/utils/rendering.py
(``export_image`` :18, ``VideoRecorder`` :39): the reference's
``BaseAviary._exportImage`` (:625-658), its PNG-frame recording in
DIRECT mode (:296-321) and the ``ffmpeg_png2mp4.sh`` asset. Frames come
from the ray-casting renderer (ops/render.py) and are numpy arrays here.
PIL is imported where a PNG is written, and only there; ffmpeg is
optional.
"""

import os
import subprocess
from datetime import datetime

import numpy as np

from .enums import ImageType


def export_image(img_type: ImageType, img_input, path: str,
                 frame_num: int = 0):
    """Save one frame as ``path/frame_<n>.png`` (reference
    _exportImage:625-658); returns the file's path. Needs PIL."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"frame_{frame_num}.png")
    img = np.asarray(img_input)
    if img_type == ImageType.RGB:
        Image.fromarray(img.astype("uint8"), "RGBA").save(out)
    elif img_type in (ImageType.DEP, ImageType.SEG):
        lo, hi = np.min(img), np.max(img)
        scaled = ((img - lo) * 255 / max(hi - lo, 1e-9)).astype("uint8")
        Image.fromarray(scaled).save(out)
    elif img_type == ImageType.BW:
        bw = (np.sum(img[:, :, 0:2], axis=2) / 3).astype("uint8")
        Image.fromarray(bw).save(out)
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
