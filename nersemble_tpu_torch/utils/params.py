"""Parameter trees as ``nn.Module``s with the JAX pytree's key layout.

The JAX package keeps parameters as nested dicts/lists of arrays; its
checkpoints flatten them to ``/``-joined keys (``params/field/table``,
``params/deformation/stem/layers/0/w``; nersemble_tpu/engine/checkpoints.py
``_flatten``). ``ParamTree`` mirrors that nesting with submodules, so the
port's ``state_dict`` keys are the same keys joined with ``.``.
"""

from typing import Dict, Union

import torch
from torch import nn

Tree = Union[Dict, list, tuple, torch.Tensor]


class ParamTree(nn.Module):
    """Dict entries become parameters (tensors), submodules (dicts) or
    ``nn.ModuleList``s (lists). Parameters are created with
    ``requires_grad=False`` (rendering needs no gradients); the trainer
    turns gradients on."""

    def __init__(self, tree: Dict[str, Tree]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(value), requires_grad=False))

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters


def to_tree(params: nn.Module, fn=lambda t: t) -> Dict[str, Tree]:
    """A ParamTree -> the JAX pytree's nesting (dicts, lists for
    ``ModuleList``s) with ``fn(parameter)`` at the leaves."""
    tree: Dict[str, Tree] = {}
    for key, value in params._parameters.items():
        tree[key] = fn(value.detach())
    for key, child in params._modules.items():
        if isinstance(child, nn.ModuleList):
            tree[key] = [to_tree(c, fn) for c in child]
        else:
            tree[key] = to_tree(child, fn)
    return tree


def params_like(params: nn.Module, fn) -> ParamTree:
    """A ParamTree shaped like ``params`` with ``fn(parameter)`` as leaves."""
    return ParamTree(to_tree(params, fn))


def uniform(shape, low: float, high: float, generator: torch.Generator,
            dtype=torch.float32) -> torch.Tensor:
    """U(low, high) drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return u * (high - low) + low


def normal(shape, std: float, generator: torch.Generator,
           dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype) * std
