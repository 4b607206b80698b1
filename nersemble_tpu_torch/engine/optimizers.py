"""Per-group Adam with host-scheduled learning rates (port of
nersemble_tpu/engine/optimizers.py::fused_adam_update).

The state is ``AdamState(count, mu, nu)`` with ``mu``/``nu`` ParamTrees
shaped like the parameters, the layout of optax's ``ScaleByAdamState``
(checkpoints carry it as ``opt_state/count``, ``opt_state/mu/...``,
``opt_state/nu/...``). The update is optax's ``scale_by_adam(eps=1e-15)``
followed by a per-group learning rate, except that the gradient is squared
in f32 (as the JAX package does):

    mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
    p -= lr * (mu / c1) / (sqrt(nu / c2) + eps),  c_i = 1 - b_i^t.

``torch.optim.Adam`` puts eps inside the bias correction differently and
keeps another state layout, so it is not used. Parameters and moments are
updated in place (the JAX version returns new arrays): on the card by one
kernel over every leaf (``ops/fused_adam.py``, one pass over each byte),
on the CPU by the same formula op by op, leaf by leaf.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nersemble_tpu_torch.ops import fused_adam
from nersemble_tpu_torch.utils.params import ParamTree, params_like


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: steps taken
    mu: ParamTree
    nu: ParamTree


def init_adam(params: ParamTree) -> AdamState:
    device = next(params.parameters()).device
    return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                     params_like(params, torch.zeros_like),
                     params_like(params, torch.zeros_like))


def group_of_param(groups: Dict[str, list]) -> Dict[str, str]:
    """Invert {group: [top-level keys]} -> {top-level key: group}."""
    return {key: group for group, keys in groups.items() for key in keys}


@torch.no_grad()
def fused_adam_update(params: ParamTree, state: AdamState,
                      key_to_group: Dict[str, str], lrs: Dict[str, float],
                      b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-15,
                      row_shards: Optional[Dict[str, Tuple[slice, torch.Tensor]]] = None
                      ) -> AdamState:
    """One Adam step over every parameter with a ``.grad``, in place; the
    learning rate of a parameter is that of its top-level key's group.
    Returns the new state (its moments are the same tensors, updated).

    ``row_shards`` {name: (rows, gradient)}: parameters stepped on their
    ``rows`` only, with that gradient and moments that hold those rows (the
    moments-only ZeRO layout; their ``.grad`` is None)."""
    count = state.count + 1
    t = count.to(torch.float32)
    # scalar ** tensor: no host-to-device copy (which would sync the stream)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    mus = dict(state.mu.named_parameters())
    nus = dict(state.nu.named_parameters())
    row_shards = row_shards or {}
    leaves = []
    for name, p in params.named_parameters():
        if name in row_shards:
            rows, g = row_shards[name]
            p = p[rows]
        elif p.grad is None:
            continue
        else:
            g = p.grad
        lr = lrs[key_to_group[name.split(".")[0]]]
        leaves.append((p, g, mus[name], nus[name], lr))
    fused_adam.adam_update(leaves, c1, c2, b1, b2, eps)
    return AdamState(count, state.mu, state.nu)
