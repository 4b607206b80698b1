"""Video output of the render CLI (the port's copy of
nersemble_tpu/utils/videoio.py).

The JAX package writes an mp4 through OpenCV when it can and falls back to
a directory of numbered PNGs. The port carries no video or imaging library,
so it always writes the fallback's layout: a directory named after the
requested path without its suffix, frames ``frame_{i:05d}.png`` written by
``utils/png.py``.
"""

from pathlib import Path
from typing import List

import numpy as np

from nersemble_tpu_torch.utils import png


def write_video(path, frames: List[np.ndarray]) -> str:
    """frames: list of [H, W, 3] uint8 or [0,1] float. Returns the frame
    directory."""
    frame_dir = Path(path).with_suffix("")
    frame_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0, 1) * 255).round().astype(np.uint8)
        png.imwrite(frame_dir / f"frame_{i:05d}.png", frame)
    return str(frame_dir)
