"""Checkpoints in the JAX package's npz format, both ways.

A checkpoint (nersemble_tpu/engine/checkpoints.py) is a flat ``np.savez``
of ``/``-joined pytree paths: ``step``, ``params/field/table``,
``params/deformation/stem/layers/0/w``, ``opt_state/count``,
``opt_state/mu/...``, ``opt_state/nu/...``, ``grid_occs``, ``extra/...``;
lists carry a ``__seq_type__`` marker entry. Reading and writing one needs
only numpy. The arrays keep their layouts ([in, out] weights, the [E, W]
table, the 128-column head), and the port's ``state_dict`` keys are the
same paths joined with ``.``, so a port checkpoint resumes in JAX and a JAX
checkpoint resumes here. Loaded tensors go to the card unless the caller
names another device.
"""

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from nersemble_tpu_torch.engine.optimizers import AdamState
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.params import ParamTree, to_tree

_SEQ = "__seq_type__"


def _nest(flat: Dict[str, np.ndarray]):
    """Flat ``a/b/0/c`` keys -> nested dicts, with lists where a level holds
    a ``__seq_type__`` marker."""
    root: Dict = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if _SEQ in node:
            return [listify(node[str(i)]) for i in range(len(node) - 1)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> flat ``/`` keys (``_flatten`` of the JAX
    package: lists get a ``__seq_type__`` marker)."""
    flat = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            flat.update(_flatten(value, f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        flat[f"{prefix}{_SEQ}"] = np.array("list")
        for i, value in enumerate(tree):
            flat.update(_flatten(value, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def params_from_numpy(tree_or_flat: Union[Dict, list],
                      device="cuda") -> ParamTree:
    """A JAX parameter pytree as numpy arrays (nested dicts/lists), or the
    flat ``params/...`` dict of a checkpoint, -> the port's ParamTree on
    ``device``."""
    device = resolve_device(device)
    tree = tree_or_flat
    if any(isinstance(k, str) and k.startswith("params/") for k in tree):
        tree = _nest(_subtree(tree, "params/"))

    def to_tensors(node):
        if isinstance(node, dict):
            return {k: to_tensors(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [to_tensors(v) for v in node]
        return torch.from_numpy(np.array(node, dtype=np.float32))

    return ParamTree(to_tensors(tree)).to(device)


def opt_state_from_numpy(flat: Dict[str, np.ndarray], device="cuda") -> AdamState:
    """The flat ``opt_state/...`` entries of a checkpoint -> AdamState."""
    device = resolve_device(device)
    count = torch.tensor(int(flat["opt_state/count"]), dtype=torch.int32,
                         device=device)
    return AdamState(count,
                     params_from_numpy(_nest(_subtree(flat, "opt_state/mu/")), device),
                     params_from_numpy(_nest(_subtree(flat, "opt_state/nu/")), device))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path, step: int, params: ParamTree, opt_state: AdamState,
                    grid_occs: torch.Tensor,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path`` atomically in the JAX package's format."""
    write_checkpoint(path, step, to_tree(params, _numpy),
                     {"count": _numpy(opt_state.count),
                      "mu": to_tree(opt_state.mu, _numpy),
                      "nu": to_tree(opt_state.nu, _numpy)},
                     _numpy(grid_occs), extra)


def write_checkpoint(path, step: int, params: Dict, opt_state: Dict,
                     grid_occs: np.ndarray,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """``save_checkpoint`` of numpy trees (``params``; ``opt_state`` with
    ``count``, ``mu`` and ``nu``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {"step": np.asarray(step), "params": params,
             "opt_state": opt_state, "grid_occs": grid_occs}
    if extra:
        state["extra"] = extra
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(state))
    os.replace(tmp, path)


def read_flat(path, skip: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The arrays of a checkpoint, but those under the prefix ``skip``."""
    with np.load(Path(path), allow_pickle=False) as data:
        return {k: data[k] for k in data.files
                if skip is None or not k.startswith(skip)}


def _extra(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len("extra/"):]: v for k, v in flat.items()
            if k.startswith("extra/") and "__" not in k}


def load_checkpoint(path, device="cuda", load_opt: bool = True
                    ) -> Tuple[int, ParamTree, Optional[AdamState],
                               torch.Tensor, Dict]:
    """A checkpoint of either package -> (step, params, opt_state,
    grid_occs, extra); ``opt_state`` is None unless ``load_opt`` (an
    evaluation never reads the Adam moments)."""
    return state_from_flat(read_flat(path, skip=None if load_opt else "opt_state/"),
                           device, load_opt)


def state_from_flat(flat: Dict[str, np.ndarray], device="cuda",
                    load_opt: bool = True) -> Tuple[int, ParamTree,
                                                    Optional[AdamState],
                                                    torch.Tensor, Dict]:
    """``load_checkpoint`` of the arrays ``read_flat`` gave."""
    device = resolve_device(device)
    grid_occs = torch.from_numpy(
        np.asarray(flat["grid_occs"], np.float32)).to(device)
    opt_state = opt_state_from_numpy(flat, device) if load_opt else None
    return (int(flat["step"]), params_from_numpy(flat, device), opt_state,
            grid_occs, _extra(flat))


def load_jax_checkpoint(path, device="cuda") -> Tuple[ParamTree, torch.Tensor, Dict]:
    """A ``step-*.ckpt`` -> (params, grid_occs, extra), without the
    optimizer state (eval only)."""
    device = resolve_device(device)
    flat = read_flat(path)
    grid_occs = torch.from_numpy(
        np.asarray(flat["grid_occs"], np.float32)).to(device)
    return params_from_numpy(flat, device), grid_occs, _extra(flat)


def prune_old_checkpoints(folder, keep_step: int) -> None:
    """Delete every ``step-*.ckpt`` in ``folder`` but ``keep_step``'s
    (``save_only_latest_checkpoint``)."""
    folder = Path(folder)
    if not folder.exists():
        return
    for p in folder.glob("step-*.ckpt"):
        if int(p.stem.split("-")[1]) != keep_step:
            p.unlink()
