"""Seeded initial parameters of the model, made by the benchmark.

The leaves are named as the model's checkpoint keys (``field.table``,
``deformation.stem.layers.0.w``, ...) and drawn with the published
initialisations: the hash table from U(+-1e-4), linear layers from
U(+-1/sqrt(in)) (the warp head from U(+-1e-5) with a zero bias), the time
codes from N(0, 0.01/sqrt(dim)). Every uniform leaf is cut from one draw
and every normal leaf from another, made on ``device`` by one generator
seeded with the run's seed, so that the same seed gives the same weights
and the reference gets exactly what the program gets.
"""

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.nersemble_ref import grid_layout

Spec = List[Tuple[str, tuple, str, float]]  # (name, shape, kind, scale)


def _mlp(spec: Spec, prefix: str, d_in: int, d_out: int, n_layers: int,
         width: int, bias: bool, skips=()) -> None:
    for i in range(n_layers):
        if n_layers == 1:
            a, b = d_in, d_out
        elif i == 0:
            a, b = d_in, width
        elif i in skips:
            a, b = width + d_in, width
        elif i == n_layers - 1:
            a, b = width, d_out
        else:
            a, b = width, width
        s = math.sqrt(1.0 / a)
        spec.append((f"{prefix}.layers.{i}.w", (a, b), "uniform", s))
        if bias:
            spec.append((f"{prefix}.layers.{i}.b", (b,), "uniform", s))


def leaf_spec(m: Dict) -> Spec:
    """Every leaf of model ``m`` (the cell's ``model`` dict)."""
    lv = grid_layout(m)
    spec: Spec = [("field.table", (lv["entries"], lv["width"]), "uniform", 1e-4)]
    _mlp(spec, "field.mlp_base", lv["n_levels"] * lv["features"], 1 + m["geo_feat_dim"],
         m["num_layers"], m["hidden_dim"], bias=False)
    _mlp(spec, "field.mlp_head", 3 + m["geo_feat_dim"], 3, m["num_layers_color"],
         m["hidden_dim_color"], bias=False)
    if m["use_deformation_field"]:
        d = m["deformation_field"]
        d_in = 2 * 3 * d["n_freq_pos"] + 3 + d["warp_code_dim"]
        _mlp(spec, "deformation.stem", d_in, d["mlp_layer_width"], d["mlp_num_layers"],
             d["mlp_layer_width"], bias=True, skips=tuple(d["skip_connections"]))
        spec.append(("deformation.head_rv.w", (d["mlp_layer_width"], 128), "uniform", 1e-5))
        spec.append(("deformation.head_rv.b", (128,), "zeros", 0.0))
    if m["use_deformation_field"] or m["use_hash_ensemble"]:
        T = m["n_timesteps"]
        spec.append(("time_embedding", (T, m["latent_dim_time"]), "normal",
                     0.01 / math.sqrt(m["latent_dim_time"])))
        if m["use_separate_deformation_time_embedding"] and m["use_deformation_field"]:
            dim = m["deformation_field"]["warp_code_dim"]
            spec.append(("time_embedding_deformation", (T, dim), "normal",
                         0.01 / math.sqrt(dim)))
    return spec


def make(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves of ``leaf_spec(m)`` drawn from ``seed`` on ``device``."""
    spec = leaf_spec(m)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("uniform", "normal")}
    draws = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        part = draws[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        out[name] = part * (2 * scale) - scale if kind == "uniform" else part * scale
    return out


def nested(flat: Dict[str, torch.Tensor]) -> Dict:
    """``a.b.layers.0.w`` keys -> the nested dicts and lists of the model's
    parameter tree."""
    tree: Dict = {}
    for name, value in flat.items():
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            if part == "layers":
                node = node.setdefault(part, [])
                continue
            if isinstance(node, list):
                idx = int(part)
                while len(node) <= idx:
                    node.append({})
                node = node[idx]
            else:
                node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree
