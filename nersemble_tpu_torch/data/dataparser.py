"""Dataparser: builds per-split camera sets, file lists, and index maps (the
port's copy of nersemble_tpu/data/dataparser.py; the capture size is read
from the PNG header by utils/png.py instead of PIL).

Reference: src/nersemble/nerfstudio/dataparser/nersemble_dataparser.py:22-426.
- train split: first ``n_cameras`` of COMPLETE_CAM_ID_ORDER; eval split: the 4
  held-out EVALUATION_CAM_IDS.
- images are ordered timestep-major: image_idx = timestep_idx * n_cams + cam_pos.
- eval uses at most ``max_eval_timesteps`` evenly spaced effective timesteps.
- world_2_cam calibration (OpenCV) is converted to viewer-frame cam_2_world and
  scaled by ``scale_factor``; intrinsics are rescaled by 1/downscale_factor.
- per-ray supervision assets (alpha / depth maps, color corrections) are
  resolved to file paths here and loaded lazily by the dataset.
"""

from dataclasses import dataclass
from math import ceil
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from nersemble_tpu_torch.config import DataConfig
from nersemble_tpu_torch.constants import (
    COMPLETE_CAM_ID_ORDER,
    DEFAULT_SCENE_BOX,
    EVALUATION_CAM_IDS,
    ORIGINAL_IMAGE_HEIGHT,
    ORIGINAL_IMAGE_WIDTH,
    SCENE_BOXES,
    SERIALS,
)
from nersemble_tpu_torch.data.cameras import (
    CameraIntrinsics,
    Frustum,
    cam2world_viewer_to_cv,
    world2cam_cv_to_cam2world_viewer,
)
from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager
from nersemble_tpu_torch.utils import png


def scene_box(participant_id: int, scale_factor: float) -> np.ndarray:
    """[2, 3] float32: the participant's scene box (the default one for an
    unknown participant), scaled."""
    box = SCENE_BOXES.get(participant_id, DEFAULT_SCENE_BOX)
    return np.asarray(box, np.float32) * scale_factor / 9.0


@dataclass
class ImageEntry:
    image_idx: int
    cam_pos: int            # position within the split's camera list
    cam_id: int             # global camera id (index into SERIALS)
    timestep_index: int     # effective timestep index (embedding lookup)
    original_timestep: int  # frame folder id on disk
    time: float             # normalized [0, 1]


@dataclass
class DataparserOutputs:
    split: str
    cam_ids: List[int]
    c2w: np.ndarray                   # [n_cams, 4, 4] viewer-frame cam_2_world
    intrinsics: CameraIntrinsics      # at the downscaled resolution
    image_width: int
    image_height: int
    entries: List[ImageEntry]
    image_paths: List[str]
    alpha_paths: Optional[List[str]]
    color_correction_paths: Optional[List[str]]
    depth_paths: Optional[List[str]]
    scene_box: np.ndarray             # [2, 3]
    frustums: Optional[List[Frustum]] = None
    n_timesteps: int = 1

    @property
    def n_images(self) -> int:
        return len(self.entries)


class NeRSembleDataParser:
    def __init__(self, config: DataConfig,
                 data_manager: Optional[NeRSembleDataManager] = None,
                 original_image_size: Optional[Tuple[int, int]] = None):
        self.config = config
        self.data_manager = data_manager or NeRSembleDataManager(
            config.participant_id, config.sequence_name)
        if original_image_size is None:
            original_image_size = self._probe_original_size()
        self._original_w, self._original_h = original_image_size
        if config.n_timesteps == -1:
            total = self.data_manager.get_n_timesteps()
            if total == 0:
                raise FileNotFoundError(
                    f"No frame_* folders with images found under "
                    f"{self.data_manager.get_sequence_folder()}")
            config.n_timesteps = ceil(total / config.skip_timesteps)

    def _probe_original_size(self) -> Tuple[int, int]:
        """Infer the capture resolution from the first on-disk image (the
        stored images are already downscaled by ``downscale_factor``); falls
        back to the published rig's 2200x3208."""
        try:
            timesteps = self.data_manager.get_timesteps()
            if timesteps:
                path = self.data_manager.get_image_path(
                    timesteps[0], self.split_cam_ids("train")[0])
                if Path(path).exists():
                    w, h = png.image_size(path)
                    return (w * self.config.downscale_factor,
                            h * self.config.downscale_factor)
        except (OSError, ValueError):
            pass
        return ORIGINAL_IMAGE_WIDTH, ORIGINAL_IMAGE_HEIGHT

    # -- index maps (reference: nersemble_dataparser.py:66-136) -------------

    def original_timesteps(self, split: str = "train") -> List[int]:
        cfg = self.config
        timesteps = list(range(cfg.start_timestep,
                               (cfg.n_timesteps + cfg.start_timestep) * cfg.skip_timesteps,
                               cfg.skip_timesteps))[:cfg.n_timesteps]
        if split != "train" and 0 < cfg.max_eval_timesteps < len(timesteps):
            idx = np.linspace(0, len(timesteps) - 1, cfg.max_eval_timesteps, dtype=int)
            timesteps = [timesteps[i] for i in idx]
        return timesteps

    def effective_timestep_indices(self, split: str = "train") -> List[int]:
        cfg = self.config
        if split != "train" and 0 < cfg.max_eval_timesteps < cfg.n_timesteps:
            return list(np.linspace(0, cfg.n_timesteps - 1, cfg.max_eval_timesteps,
                                    dtype=int))
        return list(range(cfg.n_timesteps))

    def time_of_original_timestep(self, timestep: int) -> float:
        all_train = self.original_timesteps("train")
        lo, hi = min(all_train), max(all_train)
        if timestep <= lo or hi == lo:
            return 0.0
        return (timestep - lo) / (hi - lo)

    def time_to_original_timestep(self, time: float) -> int:
        all_train = self.original_timesteps("train")
        lo, hi = min(all_train), max(all_train)
        return int(round(time * (hi - lo))) + lo

    def split_cam_ids(self, split: str) -> List[int]:
        if split == "train":
            return COMPLETE_CAM_ID_ORDER[:self.config.n_cameras]
        return list(EVALUATION_CAM_IDS)

    # -- main ---------------------------------------------------------------

    def generate_outputs(self, split: str = "train") -> DataparserOutputs:
        cfg = self.config
        dm = self.data_manager
        cam_ids = self.split_cam_ids(split)
        originals = self.original_timesteps(split)
        effective = self.effective_timestep_indices(split)

        camera_params = dm.load_camera_params()
        c2w = np.stack([
            world2cam_cv_to_cam2world_viewer(camera_params.world_2_cam[SERIALS[cid]],
                                             cfg.scale_factor)
            for cid in cam_ids])

        intrinsics = camera_params.intrinsics.rescale(1.0 / cfg.downscale_factor)
        width = self._original_w // cfg.downscale_factor
        height = self._original_h // cfg.downscale_factor

        entries, image_paths = [], []
        alpha_paths = [] if cfg.foreground_only else None
        cc_paths = [] if cfg.use_color_correction else None
        depth_paths = [] if (cfg.use_depth_maps and split == "train") else None
        for t_pos, (orig_t, eff_t) in enumerate(zip(originals, effective)):
            for c_pos, cid in enumerate(cam_ids):
                entries.append(ImageEntry(
                    image_idx=len(entries), cam_pos=c_pos, cam_id=cid,
                    timestep_index=int(eff_t), original_timestep=int(orig_t),
                    time=self.time_of_original_timestep(orig_t)))
                image_paths.append(dm.get_image_path(orig_t, cid))
                if alpha_paths is not None:
                    alpha_paths.append(dm.get_alpha_map_path(orig_t, cid))
                if cc_paths is not None:
                    cc_paths.append(dm.get_color_correction_path(cid))
                if depth_paths is not None:
                    depth_paths.append(dm.get_depth_map_path(orig_t, cid))

        frustums = None
        if cfg.use_view_frustum_culling and split == "train":
            k = camera_params.intrinsics.to_matrix()
            frustums = [Frustum(cam2world_viewer_to_cv(pose), k,
                                (self._original_w, self._original_h))
                        for pose in c2w]

        return DataparserOutputs(
            split=split, cam_ids=cam_ids, c2w=c2w, intrinsics=intrinsics,
            image_width=width, image_height=height, entries=entries,
            image_paths=image_paths, alpha_paths=alpha_paths,
            color_correction_paths=cc_paths, depth_paths=depth_paths,
            scene_box=scene_box(cfg.participant_id, cfg.scale_factor),
            frustums=frustums,
            n_timesteps=cfg.n_timesteps)
