"""Run-folder registry and artifact layout (the port's copy of
nersemble_tpu/model_manager/base.py; evaluation images go through
utils/png.py instead of imageio).

Replaces the reference's elias-based model manager
(reference: src/nersemble/model_manager/base.py:18-301, nersemble.py:4-13).
Preserves the on-disk layout so trained runs are interchangeable:

    <NERSEMBLE_MODELS_PATH>/nersemble/NERS-XXX[-name]/
        config.yml
        checkpoints/step-NNNNNNNNN.ckpt
        evaluation/checkpoint_<n>[_max_eval_timesteps_15][_skip_timesteps_k]
                   [_no-occupancy-grid-filtering]/frame_XXXXX/cam_Y.png
                   + evaluation_result.json
"""

import json
import re
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from nersemble_tpu_torch import env
from nersemble_tpu_torch.model_manager.evaluation import NVSEvaluationResult
from nersemble_tpu_torch.utils import png

RUN_NAME_REGEX = re.compile(r"NERS-(\d+)(?:-(.*))?")
CHECKPOINT_REGEX = re.compile(r"step-(\d+)\.ckpt")


class NeRSembleModelManager:
    """Manages one run folder ``NERS-XXX[-name]``."""

    FOLDER_NAME = "nersemble"

    def __init__(self, run_name: str, models_path: Optional[str] = None):
        models_path = models_path or env.NERSEMBLE_MODELS_PATH
        self._run_name = run_name
        self._location = f"{models_path}/{self.FOLDER_NAME}/{run_name}"

    # -- identity ----------------------------------------------------------

    def get_run_name(self) -> str:
        return self._run_name

    def get_location(self) -> str:
        return self._location

    # -- config ------------------------------------------------------------

    def get_config_path(self) -> str:
        return f"{self._location}/config.yml"

    def save_config(self, config) -> None:
        config.save(self.get_config_path())

    def load_config(self):
        from nersemble_tpu_torch.config import TrainConfig
        return TrainConfig.load(self.get_config_path())

    # -- checkpoints ---------------------------------------------------------

    def get_checkpoint_folder(self) -> str:
        return f"{self._location}/checkpoints"

    def get_checkpoint_path(self, step: int) -> str:
        return f"{self.get_checkpoint_folder()}/step-{step:09d}.ckpt"

    def list_checkpoint_steps(self) -> List[int]:
        folder = Path(self.get_checkpoint_folder())
        if not folder.exists():
            return []
        steps = []
        for p in folder.iterdir():
            m = CHECKPOINT_REGEX.match(p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_checkpoint_step(self) -> Optional[int]:
        steps = self.list_checkpoint_steps()
        return steps[-1] if steps else None

    # -- evaluation artifacts ------------------------------------------------

    def get_evaluations_folder(self) -> str:
        return f"{self._location}/evaluation"

    def get_evaluation_folder(self,
                              checkpoint: Union[str, int] = -1,
                              max_eval_timesteps: int = 15,
                              skip_timesteps: Optional[int] = None,
                              use_occupancy_grid_filtering: bool = True) -> str:
        if checkpoint == -1:
            checkpoint = sorted(self.list_evaluated_checkpoint_ids())[-1]
        name_parts = []
        if max_eval_timesteps > 0:
            name_parts.append(f"max_eval_timesteps_{max_eval_timesteps}")
        if skip_timesteps is not None and skip_timesteps > 1:
            name_parts.append(f"skip_timesteps_{skip_timesteps}")
        if not use_occupancy_grid_filtering:
            name_parts.append("no-occupancy-grid-filtering")
        folder_name = f"checkpoint_{checkpoint}"
        if name_parts:
            folder_name = f"{folder_name}_{'_'.join(name_parts)}"
        return f"{self.get_evaluations_folder()}/{folder_name}"

    def get_evaluation_img_path(self, cam_id: int, checkpoint: Union[str, int] = -1,
                                timestep: int = 0, **kwargs) -> str:
        folder = self.get_evaluation_folder(checkpoint, **kwargs)
        return f"{folder}/frame_{timestep:05d}/cam_{cam_id}.png"

    def save_evaluation_img(self, cam_id: int, img: np.ndarray,
                            checkpoint: Union[str, int] = -1,
                            timestep: int = 0, **kwargs) -> None:
        path = Path(self.get_evaluation_img_path(cam_id, checkpoint, timestep, **kwargs))
        path.parent.mkdir(parents=True, exist_ok=True)
        png.imwrite(path, img)

    def load_evaluation_img(self, cam_id: int, checkpoint: Union[str, int] = -1,
                            timestep: int = 0, **kwargs) -> np.ndarray:
        return png.imread(self.get_evaluation_img_path(cam_id, checkpoint, timestep, **kwargs))

    def get_evaluation_result_path(self, checkpoint: Union[str, int] = -1, **kwargs) -> str:
        return f"{self.get_evaluation_folder(checkpoint, **kwargs)}/evaluation_result.json"

    def save_evaluation_result(self, result: NVSEvaluationResult,
                               checkpoint: Union[str, int] = -1, **kwargs) -> None:
        path = Path(self.get_evaluation_result_path(checkpoint, **kwargs))
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result.to_dict(), indent=2))

    def load_evaluation_result(self, checkpoint: Union[str, int] = -1,
                               **kwargs) -> NVSEvaluationResult:
        path = self.get_evaluation_result_path(checkpoint, **kwargs)
        return NVSEvaluationResult.from_dict(json.loads(Path(path).read_text()))

    def list_evaluated_checkpoint_ids(self) -> List[int]:
        folder = Path(self.get_evaluations_folder())
        if not folder.exists():
            return []
        ids = []
        for p in folder.iterdir():
            try:
                ids.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(set(ids))

    def list_evaluated_timesteps(self, checkpoint: int = -1, **kwargs) -> List[int]:
        folder = Path(self.get_evaluation_folder(checkpoint, **kwargs))
        timesteps = []
        for p in folder.iterdir():
            if p.is_dir() and p.name.startswith("frame_"):
                timesteps.append(int(p.name.split("_")[1]))
        return sorted(timesteps)


class NeRSembleModelFolder:
    """Auto-incrementing ``NERS-XXX[-name]`` run registry
    (reference: model_manager/base.py:283-301)."""

    def __init__(self, models_path: Optional[str] = None):
        self._models_path = models_path or env.NERSEMBLE_MODELS_PATH
        self._location = f"{self._models_path}/{NeRSembleModelManager.FOLDER_NAME}"

    def get_location(self) -> str:
        return self._location

    def list_run_names(self) -> List[str]:
        folder = Path(self._location)
        if not folder.exists():
            return []
        return sorted(p.name for p in folder.iterdir() if RUN_NAME_REGEX.match(p.name))

    def list_run_ids(self) -> List[int]:
        ids = []
        for name in self.list_run_names():
            m = RUN_NAME_REGEX.match(name)
            ids.append(int(m.group(1)))
        return sorted(ids)

    def resolve_run_name(self, run_name_or_id: Union[str, int]) -> str:
        if isinstance(run_name_or_id, str) and RUN_NAME_REGEX.match(run_name_or_id):
            return run_name_or_id
        run_id = int(run_name_or_id)
        for name in self.list_run_names():
            m = RUN_NAME_REGEX.match(name)
            if int(m.group(1)) == run_id:
                return name
        raise FileNotFoundError(f"No run with id {run_id} in {self._location}")

    def new_run(self, name: Optional[str] = None) -> NeRSembleModelManager:
        ids = self.list_run_ids()
        new_id = (ids[-1] + 1) if ids else 1
        run_name = f"NERS-{new_id:03d}" + (f"-{name}" if name else "")
        Path(f"{self._location}/{run_name}").mkdir(parents=True, exist_ok=True)
        return NeRSembleModelManager(run_name, models_path=self._models_path)

    def open_run(self, run_name_or_id: Union[str, int]) -> NeRSembleModelManager:
        run_name = self.resolve_run_name(run_name_or_id)
        return NeRSembleModelManager(run_name, models_path=self._models_path)
