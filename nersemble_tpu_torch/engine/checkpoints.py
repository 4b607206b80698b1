"""Weights carried over from the JAX package (its npz checkpoints).

A JAX checkpoint (nersemble_tpu/engine/checkpoints.py) is a flat ``np.savez``
of ``/``-joined pytree paths: ``params/field/table``,
``params/deformation/stem/layers/0/w``, ``grid_occs``, ``extra/...``; lists
carry a ``__seq_type__`` marker entry. Reading one needs only numpy. The
arrays keep their layouts ([in, out] weights, the [E, W] table, the
128-column head), and the port's ``state_dict`` keys are the same paths
joined with ``.``.
"""

from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

from nersemble_tpu_torch.utils.params import ParamTree

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


def params_from_numpy(tree_or_flat: Union[Dict, list],
                      device="cpu") -> ParamTree:
    """A JAX parameter pytree as numpy arrays (nested dicts/lists), or the
    flat ``params/...`` dict of a checkpoint, -> the port's ParamTree."""
    tree = tree_or_flat
    if any(isinstance(k, str) and k.startswith("params/") for k in tree):
        tree = _nest({k[len("params/"):]: v for k, v in tree.items()
                      if k.startswith("params/")})

    def to_tensors(node):
        if isinstance(node, dict):
            return {k: to_tensors(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [to_tensors(v) for v in node]
        return torch.from_numpy(np.array(node, dtype=np.float32))

    return ParamTree(to_tensors(tree)).to(device)


def load_jax_checkpoint(path, device="cpu") -> Tuple[ParamTree, torch.Tensor, Dict]:
    """A JAX ``step-*.ckpt`` -> (params, grid_occs, extra). Optimizer state
    is not read (eval only)."""
    with np.load(Path(path), allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    params = params_from_numpy(flat, device)
    grid_occs = torch.from_numpy(
        np.asarray(flat["grid_occs"], np.float32)).to(device)
    extra = {k[len("extra/"):]: flat[k] for k in flat
             if k.startswith("extra/") and "__" not in k}
    return params, grid_occs, extra
