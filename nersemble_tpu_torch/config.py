"""Configuration dataclasses with a YAML round trip (port of
nersemble_tpu/config.py).

Same class names, field names and defaults as the JAX package's
``nersemble_tpu/config.py`` so a config can be carried across field by field
(tests/test_torch_imports.py checks the defaults), and the same
``config.yml`` files: ``ConfigBase.to_yaml`` writes the block subset that
``yaml.safe_dump(sort_keys=False)`` writes for these dataclasses (nested
mappings, block sequences, null, booleans, ints, floats, quoted strings,
``__config__``) and ``from_yaml`` reads it back, without PyYAML. PyYAML
follows YAML 1.1, which reads ``1e-15`` as a string, so every float is
written with a ``.`` (``1.0e-15``), as PyYAML writes it. The reasoning
behind each sampling lever is documented once, in the JAX config.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# YAML: the block subset of yaml.safe_dump, both ways
# ---------------------------------------------------------------------------

# YAML 1.1's core resolvers, as PyYAML applies them to plain scalars
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _yaml_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, str):
        if "\n" in value:
            raise ValueError(f"multi-line string {value!r}")
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"no YAML form for {type(value).__name__} {value!r}")


def _yaml_lines(node, indent: int) -> List[str]:
    """Block lines of a mapping or a sequence: a mapping's sequences sit at
    the mapping's indent and nested collections start on their ``- `` line,
    as PyYAML writes them."""
    pad = " " * indent
    lines = []
    items = node.items() if isinstance(node, dict) else [(None, v) for v in node]
    for key, value in items:
        lead = f"{pad}- " if key is None else f"{pad}{key}:"
        if isinstance(value, (dict, list)) and value:
            if key is None:  # the child's first line shares the "- " line
                child = _yaml_lines(value, indent + 2)
                lines.append(lead + child[0].lstrip(" "))
                lines.extend(child[1:])
            else:
                lines.append(lead)
                lines.extend(_yaml_lines(value, indent + (2 if isinstance(value, dict) else 0)))
        else:
            text = ("{}" if isinstance(value, dict) else "[]") \
                if isinstance(value, (dict, list)) else _yaml_scalar(value)
            lines.append(lead + ("" if key is None else " ") + text)
    return lines


def dump_yaml(data: dict) -> str:
    return "\n".join(_yaml_lines(data, 0)) + "\n"


def _resolve_scalar(text: str):
    if text[:1] == "'":
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        return json.loads(text)
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower().replace("_", "")
        if low.endswith("inf"):
            return -math.inf if low.startswith("-") else math.inf
        return math.nan if low.endswith("nan") else float(low)
    if text == "{}":
        return {}
    if text == "[]":
        return []
    return text


def _split_key(content: str):
    """``key: rest`` -> (key, rest), or None when the line is no mapping entry."""
    if content[:1] in "'\"":
        end = content.index(content[0], 1)
        key, tail = _resolve_scalar(content[:end + 1]), content[end + 1:]
    else:
        match = re.match(r"([^:#]*?):(?:\s|$)", content)
        if not match:
            return None
        key, tail = match.group(1), content[len(match.group(1)):]
    if not tail.startswith(":") or (len(tail) > 1 and tail[1] != " "):
        return None
    return key, tail[1:].strip()


class _YamlReader:
    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            stripped = raw.strip()
            if not stripped or stripped.startswith("#") or stripped in ("---", "..."):
                continue
            self.lines.append([len(raw) - len(raw.lstrip(" ")), stripped])
        self.i = 0

    def _is_item(self, i: int, indent: int) -> bool:
        ind, content = self.lines[i]
        return ind == indent and (content == "-" or content.startswith("- "))

    def node(self, indent: int):
        if self._is_item(self.i, indent):
            return self.sequence(indent)
        return self.mapping(indent)

    def _scalar(self, text: str, indent: int):
        """``text`` plus the continuation lines deeper than ``indent`` (a
        long scalar folded by the writer)."""
        parts = [text]
        while self.i < len(self.lines) and self.lines[self.i][0] > indent:
            parts.append(self.lines[self.i][1])
            self.i += 1
        return _resolve_scalar(" ".join(parts))

    def _nested(self, indent: int, rest: str):
        """The value of an entry whose own line held ``rest``."""
        if rest:
            return self._scalar(rest, indent)
        if self.i < len(self.lines):
            ind = self.lines[self.i][0]
            if ind > indent or self._is_item(self.i, indent):
                return self.node(ind)
        return None

    def sequence(self, indent: int):
        out = []
        while self.i < len(self.lines) and self._is_item(self.i, indent):
            content = self.lines[self.i][1]
            rest = content[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self._nested(indent, ""))
            elif rest.startswith("- ") or rest == "-" or _split_key(rest):
                # a collection opened on the "- " line: re-read the rest as
                # a line of its own at the column where it starts
                self.lines[self.i] = [indent + len(content) - len(rest), rest]
                out.append(self.node(self.lines[self.i][0]))
            else:
                self.i += 1
                out.append(self._scalar(rest, indent))
        return out

    def mapping(self, indent: int):
        out = {}
        while self.i < len(self.lines) and self.lines[self.i][0] == indent \
                and not self._is_item(self.i, indent):
            entry = _split_key(self.lines[self.i][1])
            if entry is None:
                raise ValueError(f"YAML line {self.lines[self.i][1]!r} is not "
                                 f"a mapping entry")
            key, rest = entry
            self.i += 1
            out[key] = self._nested(indent, rest)
        return out


def load_yaml(text: str):
    reader = _YamlReader(text)
    if not reader.lines:
        return None
    data = reader.node(reader.lines[0][0])
    if reader.i != len(reader.lines):
        raise ValueError(f"YAML line {reader.lines[reader.i][1]!r} is out of place")
    return data


# ---------------------------------------------------------------------------
# dataclass <-> dict (nersemble_tpu/config.py:21-102)
# ---------------------------------------------------------------------------

def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _encode(value):
    if dataclasses.is_dataclass(value):
        return {f.name: _encode(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, Path):
        return str(value)
    return value


def _decode(tp, value):
    tp, _ = _unwrap_optional(tp)
    if value is None:
        return None
    if dataclasses.is_dataclass(tp):
        kwargs = {}
        hints = typing.get_type_hints(tp)
        for f in dataclasses.fields(tp):
            if f.name in value:
                kwargs[f.name] = _decode(hints[f.name], value[f.name])
        return tp(**kwargs)
    origin = typing.get_origin(tp)
    if origin in (list, List):
        (item_tp,) = typing.get_args(tp) or (typing.Any,)
        return [_decode(item_tp, v) for v in value]
    if origin in (tuple, Tuple):
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_decode(args[0], v) for v in value)
        if args:
            return tuple(_decode(a, v) for a, v in zip(args, value))
        return tuple(value)
    if origin in (dict, Dict):
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else typing.Any
        return {k: _decode(val_tp, v) for k, v in value.items()}
    if tp is Path:
        return Path(value)
    return value


class ConfigBase:
    """Mixin giving dataclass configs dict/YAML round-trip."""

    def to_dict(self) -> dict:
        return _encode(self)

    @classmethod
    def from_dict(cls, data: dict):
        return _decode(cls, data)

    def to_yaml(self) -> str:
        return dump_yaml({"__config__": type(self).__name__, **self.to_dict()})

    @classmethod
    def from_yaml(cls, text: str):
        data = load_yaml(text)
        data.pop("__config__", None)
        return cls.from_dict(data)

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(self.to_yaml())

    @classmethod
    def load(cls, path):
        return cls.from_yaml(Path(path).read_text())

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass
class HashEncodingConfig(ConfigBase):
    """One multiresolution hash encoding."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865
    interpolation: str = "Linear"


@dataclass
class HashEnsembleConfig(ConfigBase):
    """Ensemble of hash encodings blended by a per-timestep latent code."""

    n_hash_encodings: int = 32
    hash_encoding: HashEncodingConfig = field(default_factory=HashEncodingConfig)
    disable_initial_hash_ensemble: bool = False
    use_soft_transition: bool = False


@dataclass
class SE3DeformationFieldConfig(ConfigBase):
    """SE(3) warp field."""

    n_freq_pos: int = 7
    warp_code_dim: int = 128
    mlp_num_layers: int = 6
    mlp_layer_width: int = 128
    skip_connections: Tuple[int, ...] = (4,)


@dataclass
class SamplingConfig(ConfigBase):
    """Fixed-shape occupancy-grid ray marching and its eval levers."""

    max_samples_per_ray: int = 256
    max_candidates_per_ray: int = 1024  # -1: auto-span the scene box
    global_budget_fraction: float = 1.0
    adaptive_budget: bool = True
    adaptive_budget_headroom: float = 1.15
    adaptive_budget_interval: int = 500
    eval_coarse_prefilter: bool = True
    eval_prefilter_stride: int = 8
    eval_fine_candidates: int = 512
    eval_max_samples_per_ray: int = -1
    eval_early_stop_trans: float = 1e-4
    eval_termination_probe_stride: int = 4
    eval_probe_stride: int = 4
    eval_ray_packing: bool = True
    adaptive_budget_max_chunks: int = 1


@dataclass
class ModelConfig(ConfigBase):
    """Dynamic-NeRF model config."""

    n_timesteps: int = 1
    latent_dim_time: int = 32
    spherical_harmonics_degree: int = 0

    use_hash_ensemble: bool = False
    hash_ensemble: Optional[HashEnsembleConfig] = None

    use_deformation_field: bool = False
    deformation_field: Optional[SE3DeformationFieldConfig] = None
    use_separate_deformation_time_embedding: bool = True

    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_levels: int = 16
    base_resolution: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    use_appearance_embedding: bool = False
    appearance_embedding_dim: int = 32
    num_images: int = 0

    window_deform_begin: int = 0
    window_deform_end: int = 0
    window_hash_encodings_begin: int = 0
    window_hash_encodings_end: int = 1

    # per-sample chunk cap of the deform + field pipeline (-1: no chunking)
    max_n_samples_per_batch: int = 2 ** 16

    near_plane: float = 0.2
    far_plane: float = 1e3
    render_step_size: float = 0.011
    cone_angle: float = 0.0
    alpha_thre: float = 1e-2
    early_stop_eps: float = 0.0
    occ_thre: float = 1e-2
    disable_occupancy_grid: bool = False
    occupancy_grid_ema_decay: float = 0.95
    occupancy_grid_warmup_steps: int = 256
    grid_resolution: int = 128
    grid_levels: int = 1
    background_color: str = "white"
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    use_view_frustum_culling: bool = False
    view_frustum_culling: int = 2

    scene_box: List[List[float]] = field(
        default_factory=lambda: [[-2.5, -2.0, -2.5], [2.5, 3.0, 2.0]])

    use_masked_rgb_loss: bool = False
    alpha_mask_threshold: float = 0.5
    lambda_alpha_loss: float = 0.0
    lambda_empty_loss: float = 0.0
    lambda_near_loss: float = 0.0
    lambda_depth_loss: float = 0.0
    lambda_dist_loss: float = 0.0
    eps_depth_initial: float = 0.9
    eps_depth_final: float = 0.01
    eps_depth_begin_step: int = 0
    eps_depth_end_step: int = 10000
    dist_loss_max_rays: int = 5000

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    table_dtype: str = "bfloat16"
    use_fused_mlp: bool = True
    shard_hash_tables: bool = False


@dataclass
class OptimizerConfig(ConfigBase):
    """Adam + StepLR of one parameter group."""

    lr: float = 5e-3
    eps: float = 1e-15
    weight_decay: float = 0.0
    scheduler_step_size: int = 20000
    scheduler_gamma: float = 0.8


def default_optimizers() -> Dict[str, OptimizerConfig]:
    """The three groups of ``TrainConfig.optimizers`` in the JAX package."""
    return {
        "fields": OptimizerConfig(lr=5e-3, scheduler_gamma=0.8),
        "deformation_field": OptimizerConfig(lr=1e-3, scheduler_gamma=0.5),
        "embeddings": OptimizerConfig(lr=5e-3, scheduler_gamma=0.8),
    }


@dataclass
class DataConfig(ConfigBase):
    """Dataset + ray batching config."""

    participant_id: int = -1
    sequence_name: str = ""
    n_timesteps: int = 1
    n_cameras: int = 12
    skip_timesteps: int = 1
    start_timestep: int = 0
    max_eval_timesteps: int = 3
    downscale_factor: int = 2
    scale_factor: float = 1.0

    foreground_only: bool = True
    use_view_frustum_culling: bool = True
    use_depth_maps: bool = False
    use_color_correction: bool = True
    use_alpha_maps: bool = False
    alpha_channel_color: str = "white"

    train_num_rays_per_batch: int = 4096
    eval_num_rays_per_batch: int = 1024
    train_num_images_to_sample_from: int = 24
    train_num_times_to_repeat_images: int = 20
    max_cached_items: int = 10000
    use_cache_compression: bool = False


@dataclass
class ParallelConfig(ConfigBase):
    """The data axis of the JAX package's device mesh: its ranks (-1: every
    visible card) and the hash table's layout over them
    (``NeRSembleTrainer.table_layout``, ``parallel/``)."""

    data_axis_size: int = -1
    shard_hash_tables: bool = False
    shard_table_optimizer: bool = True
    shard_table_params: bool = True


@dataclass
class TrainConfig(ConfigBase):
    """Top-level training config (the ``config.yml`` of a run folder)."""

    run_name: str = ""
    experiment_name: str = ""
    method_name: str = "nersemble"
    project_name: str = "nersemble"
    output_dir: str = ""

    max_num_iterations: int = 300001
    steps_per_save: int = 50000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 20000
    steps_per_eval_all_images: int = 50000
    steps_per_log: int = 10
    save_only_latest_checkpoint: bool = True
    seed: int = 19980801
    vis: str = "csv"  # csv | tensorboard | none | viewer (live web viewer)
    viewer_port: int = 7007

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizers: Dict[str, OptimizerConfig] = field(default_factory=default_optimizers)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    # Resume
    load_dir: Optional[str] = None
    load_step: Optional[int] = None


def flagship_model_config(tiny: bool = False) -> ModelConfig:
    """The flagship model (32-table ensemble + 6x128 SE(3) stem), or its
    tiny test-size cut. Equal, field by field, to the JAX package's
    ``__graft_entry__._flagship_model_config``."""
    if tiny:
        hash_cfg = HashEncodingConfig(n_levels=4, n_features_per_level=2,
                                      log2_hashmap_size=10, base_resolution=4,
                                      per_level_scale=1.5)
        n_enc, latent, warp = 8, 8, 16
        layers, width = 2, 16
        sampling = SamplingConfig(max_samples_per_ray=16,
                                  max_candidates_per_ray=-1)
        grid_res = 16
    else:
        hash_cfg = HashEncodingConfig()
        n_enc, latent, warp = 32, 32, 128
        layers, width = 6, 128
        sampling = SamplingConfig(max_samples_per_ray=256,
                                  max_candidates_per_ray=-1,
                                  global_budget_fraction=0.125)
        grid_res = 128

    return ModelConfig(
        n_timesteps=8,
        latent_dim_time=latent,
        use_hash_ensemble=True,
        hash_ensemble=HashEnsembleConfig(
            n_hash_encodings=n_enc, hash_encoding=hash_cfg,
            disable_initial_hash_ensemble=True, use_soft_transition=True),
        use_deformation_field=True,
        deformation_field=SE3DeformationFieldConfig(
            warp_code_dim=warp, mlp_num_layers=layers, mlp_layer_width=width),
        grid_resolution=grid_res,
        render_step_size=0.011, near_plane=0.2, far_plane=1e3,
        sampling=sampling,
        max_n_samples_per_batch=2 ** 16 if tiny else 98304,
        use_masked_rgb_loss=True, alpha_mask_threshold=0.0,
        lambda_alpha_loss=1e-2, lambda_near_loss=1e-4, lambda_empty_loss=1e-2,
        lambda_depth_loss=1e-4, lambda_dist_loss=1e-4,
        window_deform_end=20000, window_hash_encodings_begin=40000,
        window_hash_encodings_end=80000,
    )
