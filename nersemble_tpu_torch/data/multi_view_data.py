"""Raw dataset access: folder-layout oracle for the multi-view video capture
(the port's copy of nersemble_tpu/data/multi_view_data.py; images are
decoded by utils/png.py instead of imageio).

Reference: src/nersemble/data_manager/multi_view_data.py:24-211. Encapsulates
all paths and codecs of the published NeRSemble dataset:

    <NERSEMBLE_DATA_PATH>/<participant:03d>/
        camera_params.json                         (world_2_cam + intrinsics)
        sequences/<sequence>/frame_<t:05d>/
            images-2x[-73fps]/cam_<serial>.png
            alpha_map[-73fps]/cam_<serial>.png
            colmap[-73fps]/depth_maps_compressed/cam_<serial>.png  (16-bit)
        annotations/<sequence>/color_correction/<serial>.npy

The reference code uses the ``-73fps`` suffixed folder names
(multi_view_data.py:131-142) while its docstring shows unsuffixed ones; we
accept either, preferring the suffixed form when both exist.
"""

import json
import re
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from nersemble_tpu_torch import env
from nersemble_tpu_torch.constants import SERIALS
from nersemble_tpu_torch.data.cameras import CameraIntrinsics
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils.quantization import DepthQuantizer

CamIdOrSerial = Union[int, str]
_FRAME_REGEX = re.compile(r"frame_(\d+)")


class CameraParams:
    def __init__(self, world_2_cam: dict, intrinsics: CameraIntrinsics):
        self.world_2_cam = world_2_cam  # serial -> [4, 4] np.ndarray (OpenCV)
        self.intrinsics = intrinsics


class NeRSembleDataManager:
    def __init__(self, participant_id: int, sequence_name: str,
                 location: Optional[str] = None):
        self._participant_id = participant_id
        self._sequence_name = sequence_name
        self._location = location or env.NERSEMBLE_DATA_PATH

    # -- folders -------------------------------------------------------------

    def get_participant_folder(self) -> str:
        return f"{self._location}/{self._participant_id:03d}"

    def get_sequence_folder(self) -> str:
        return f"{self.get_participant_folder()}/sequences/{self._sequence_name}"

    def get_timestep_folder(self, timestep: int) -> str:
        return f"{self.get_sequence_folder()}/frame_{timestep:05d}"

    def _suffixed(self, timestep: int, base: str) -> str:
        preferred = f"{self.get_timestep_folder(timestep)}/{base}-73fps"
        fallback = f"{self.get_timestep_folder(timestep)}/{base}"
        return preferred if Path(preferred).exists() else fallback

    def get_images_folder(self, timestep: int) -> str:
        return self._suffixed(timestep, "images-2x")

    def get_alpha_map_folder(self, timestep: int) -> str:
        return self._suffixed(timestep, "alpha_map")

    def get_colmap_folder(self, timestep: int) -> str:
        return self._suffixed(timestep, "colmap")

    def get_depth_maps_folder(self, timestep: int) -> str:
        return f"{self.get_colmap_folder(timestep)}/depth_maps_compressed"

    def get_annotations_folder(self) -> str:
        return f"{self.get_participant_folder()}/annotations/{self._sequence_name}"

    def get_color_correction_folder(self) -> str:
        return f"{self.get_annotations_folder()}/color_correction"

    # -- paths ---------------------------------------------------------------

    def get_image_path(self, timestep: int, cam: CamIdOrSerial) -> str:
        return f"{self.get_images_folder(timestep)}/cam_{self.cam_id_to_serial(cam)}.png"

    def get_alpha_map_path(self, timestep: int, cam: CamIdOrSerial) -> str:
        return f"{self.get_alpha_map_folder(timestep)}/cam_{self.cam_id_to_serial(cam)}.png"

    def get_depth_map_path(self, timestep: int, cam: CamIdOrSerial) -> str:
        return f"{self.get_depth_maps_folder(timestep)}/cam_{self.cam_id_to_serial(cam)}.png"

    def get_color_correction_path(self, cam: CamIdOrSerial) -> str:
        return f"{self.get_color_correction_folder()}/{self.cam_id_to_serial(cam)}.npy"

    def get_camera_params_path(self) -> str:
        return f"{self.get_participant_folder()}/camera_params.json"

    # -- assets --------------------------------------------------------------

    def load_image(self, timestep: int, cam: CamIdOrSerial) -> np.ndarray:
        return png.imread(self.get_image_path(timestep, cam))

    def load_alpha_map(self, timestep: int, cam: CamIdOrSerial) -> np.ndarray:
        return png.imread(self.get_alpha_map_path(timestep, cam))

    def depth_map_exists(self, timestep: int, cam: CamIdOrSerial) -> bool:
        return Path(self.get_depth_map_path(timestep, cam)).exists()

    def load_depth_map(self, timestep: int, cam: CamIdOrSerial) -> np.ndarray:
        quantized = png.imread(self.get_depth_map_path(timestep, cam))
        return DepthQuantizer().decode(quantized)

    def load_color_correction(self, cam: CamIdOrSerial) -> np.ndarray:
        return np.load(self.get_color_correction_path(cam))

    def load_camera_params(self) -> CameraParams:
        with open(self.get_camera_params_path()) as f:
            raw = json.load(f)
        world_2_cam = {serial: np.asarray(mat, np.float64)
                       for serial, mat in raw["world_2_cam"].items()}
        intrinsics = CameraIntrinsics.from_matrix(np.asarray(raw["intrinsics"]))
        return CameraParams(world_2_cam, intrinsics)

    # -- utility -------------------------------------------------------------

    def cam_id_to_serial(self, cam: CamIdOrSerial) -> str:
        return SERIALS[cam] if isinstance(cam, int) else cam

    def serial_to_cam_id(self, cam: CamIdOrSerial) -> int:
        return SERIALS.index(cam) if isinstance(cam, str) else cam

    def get_timesteps(self) -> List[int]:
        folder = Path(self.get_sequence_folder())
        if not folder.exists():
            return []
        timesteps = []
        for p in folder.iterdir():
            m = _FRAME_REGEX.match(p.name)
            if m:
                t = int(m.group(1))
                if Path(self.get_images_folder(t)).exists():
                    timesteps.append(t)
        return sorted(timesteps)

    def get_n_timesteps(self) -> int:
        return len(self.get_timesteps())
