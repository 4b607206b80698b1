"""The comparison that decides ``correct`` for a training cell.

Set-up hands the reference what the program got: the seed (the benchmark
draws the weights from it again), the starting grid, the configuration
and the first ``check_steps`` batches the program trained on. The batches
are the program's (its data pipeline drew them from the capture), so they
are judged first, ray by ray, against the capture's scene
(``reference/batch_check.py``). The first checked step opens with the
loop's occupancy update, which the reference works out itself from the
starting grid (the benchmark's, made from the seed) and the seeded
weights; that stage is judged alone (``occupancy``). The checked steps
then march through the grid the program's update left (the program's
state: a probe whose density lies at the threshold may fall on either
side in bfloat16, and one cell more or less changes the sample set), and
the reference works out everything else itself: the frustum grid, the
binaries, the march, the compaction to the configuration's budget, the
field, the losses, the gradients and three Adam steps. The numbers:

- ``occupancy``: the grid after the update: the widest gap of a cell's
  value from the reference's, over the grid's largest value;
- ``loss``: the widest relative gap of a step's total loss;
- ``samples``: the widest relative gap of a step's valid-sample count
  (the march) and evaluated-sample count (the compaction);
- ``grad``: the first step's gradient as Adam's first moment holds it,
  by the median leaf: each leaf's gap of its norm from the reference's,
  over the larger of the reference leaf's norm and the median leaf's, and
  the median of those gaps (the worst leaf's is a sum that cancels and
  swings from seed to seed; ``details`` reads it); ``grad.table`` the
  table's leaf alone and ``grad.embeddings`` the median of the time
  embeddings' leaves, on the same measure;
- ``update``: the parameters' change after the checked steps, by the
  median leaf likewise, over the leaves whose reference gradient reaches
  a thousandth of the median leaf's (the worst leaf is one of the warp
  field's, downstream of the positions' gradient, and swings too);
  ``update.table`` and ``update.embeddings`` likewise;
- ``render``: the first step's rendered colour, ray by ray: the norm of
  its difference from the reference's over the norm of the reference's
  departure from the white background (the gaps of norms above cannot
  part the program from the control a precision below at these seeded
  weights; this does, PERF.md);
- ``batch``: the widest gap of a batch's rays from the capture's pixels.
"""

import gc
import statistics
from typing import Dict

import numpy as np
import torch

from benchmark import weights
from benchmark.loops.train import trainer_seed
from benchmark.reference import batch_check
from benchmark.reference.nersemble_ref import (
    OCCUPANCY_EVERY,
    Reference,
    group_of,
    identity,
    step_lrs,
)

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is below this share of the median's
TABLE = "field.table"


def frustum_grid(spec: Dict, m: Dict, scale: float, device) -> torch.Tensor:
    """[G, G, G]: grid corner points inside at least ``view_frustum_culling``
    training cameras' view frustums."""
    from benchmark import capture
    ow, oh = spec["original_size"]
    k_inv = np.linalg.inv(capture.intrinsics((ow, oh)))
    rig = capture.camera_rig(spec["n_cameras"])
    box = np.asarray(m["scene_box"], np.float32)
    g = m["grid_resolution"]
    axes = [np.linspace(box[0][i], box[1][i], g) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    count = np.zeros(pts.shape[0], np.int32)
    corners = np.array([[0, 0, 1], [ow, 0, 1], [0, oh, 1], [ow, oh, 1]], np.float64)
    for cam in capture.TRAIN_CAM_IDS:
        c2w = np.linalg.inv(rig[capture.SERIALS[cam]])
        rot = capture.VIEWER_SWAP @ c2w[:3, :3]
        centre = capture.VIEWER_SWAP @ c2w[:3, 3] * scale
        tl, tr, bl, br = (rot @ (k_inv @ corners.T)).T
        normals = np.stack([np.cross(tl, tr), np.cross(tr, br),
                            np.cross(br, bl), np.cross(bl, tl)])
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        count += (((pts - centre) @ normals.T) >= 0).all(-1)
    return torch.from_numpy(count >= m["view_frustum_culling"]).reshape(g, g, g).to(device)


def binaries(m: Dict, occs: torch.Tensor, frustum) -> torch.Tensor:
    g = m["grid_resolution"]
    b = occs > torch.clamp(occs.mean(), max=m["occ_thre"])
    b = b.reshape(g, g, g)
    return b & frustum if frustum is not None else b


def run_reference(cell, quant=identity, chunk: int = 16384, program=None,
                  keep: bool = False, own_grid: bool = False) -> Dict:
    """The reference's readings over the cell's checked steps, held to
    ``program`` ({"params": after the steps, "colour": the first step's
    rendered colour, "grid": the grid after the first step's occupancy
    update}; default the program's own); ``keep``: also return the
    reference's; ``own_grid``: march through the reference's own grid."""
    m, dev, seed = cell.model_dict, cell.device, cell.seed
    ck = cell.checked
    program = program or {"params": ck["params"], "colour": ck["colour"],
                          "grid": ck["grid"]}
    first = ck["start_step"]
    if first % OCCUPANCY_EVERY or any((first + k) % OCCUPANCY_EVERY == 0
                                      for k in range(1, len(ck["batches"]))):
        raise ValueError("the checked steps open with the loop's occupancy update "
                         "and hold no other")
    ref = Reference(m, dev, quant)
    frustum = frustum_grid(cell.traffic["capture"], m, cell.scale, dev) \
        if m["use_view_frustum_culling"] else None
    params = weights.make(m, seed, dev)
    occs = ref.occupancy_update(params, cell.start_grid.to(dev), first,
                                trainer_seed(seed), chunk)
    seen = program["grid"].to(dev)
    out = {"losses": [], "samples": [], "evaluated": []}
    if seen.shape == occs.shape:
        out["occupancy"] = float((seen - occs).abs().max() / occs.abs().max().clamp(min=1e-30))
        out["occupancy_flips"] = float((binaries(m, seen, frustum)
                                        != binaries(m, occs, frustum)).float().mean())
    else:
        out["occupancy"], out["occupancy_flips"] = 1.0, 1.0
    bins = binaries(m, occs if own_grid else seen, frustum)
    start = {k: v.clone() for k, v in params.items()}
    state: Dict = {}
    for k, batch in enumerate(ck["batches"]):
        step = first + k
        loss, grads, n_valid, n_dropped, colour = ref.step(
            params, state, batch, bins, ref.budget(batch["origins"].shape[0]), step,
            trainer_seed(seed), step_lrs(cell.optimizers, step), chunk)
        out["losses"].append(loss)
        out["samples"].append(n_valid)
        out["evaluated"].append(n_valid - n_dropped)
        if k == 0:
            out["colour"] = colour
            seen = program["colour"].to(dev)
            # a program that rendered other rays than the batch's reads a full gap
            out["render"] = _norm(seen - colour) / max(_norm(1.0 - colour), 1e-30) \
                if seen.shape == colour.shape else 1.0
            out["grad_norms"] = {n: None if g is None else _norm(g) for n, g in grads.items()}
            if keep:
                out["colour"] = colour.cpu()
        del grads
    with torch.no_grad():
        out["change_norms"] = {k: _norm(params[k] - start[k]) for k in params}
        out["program_change_norms"] = {k: _norm(program["params"][k].to(dev) - start[k])
                                       for k in params}
    if keep:
        out["params"] = {k: v.detach().cpu() for k, v in params.items()}
        out["grid"] = occs.cpu()
    del params, start, state, occs, seen
    gc.collect()
    return out


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    keys = list(keys)
    if not keys:
        return {}
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def _parts(gaps: Dict[str, float], name: str) -> Dict[str, float]:
    """``<name>.table``: the table's gap; ``<name>.embeddings``: the median
    gap of the time embeddings' leaves (NaN where the leaves are missing,
    which fails the check)."""
    emb = [v for k, v in gaps.items() if group_of(k) == "embeddings"]
    return {f"{name}.table": gaps.get(TABLE, float("nan")),
            f"{name}.embeddings": statistics.median(emb) if emb else float("nan")}


def moving_leaves(ref: Dict) -> list:
    """Leaves whose first reference gradient reaches ``GRAD_FLOOR`` of the
    median leaf's."""
    grads = {k: v for k, v in ref["grad_norms"].items() if v is not None}
    median = statistics.median(grads.values())
    return [k for k, v in grads.items() if v >= GRAD_FLOOR * median]


def details(cell, ref: Dict) -> Dict:
    """What the numbers were taken from: per-step losses and counts, and
    the worst leaves' gaps (read, not compared: a leaf whose gradient is a
    sum that cancels swings from seed to seed)."""
    ck = cell.checked
    grads = {k: v for k, v in ref["grad_norms"].items() if v is not None}
    g = leaf_gaps(ck["grad_norms"], grads, grads)
    u = leaf_gaps(ref["program_change_norms"], ref["change_norms"], moving_leaves(ref))
    return {"losses_program": ck["losses"], "losses_reference": ref["losses"],
            "samples_program": ck["samples"], "samples_reference": ref["samples"],
            "grad_worst": max(g.values(), default=0.0),
            "update_worst": max(u.values(), default=0.0),
            "worst_grad_leaf": max(g, key=g.get) if g else None,
            "worst_update_leaf": max(u, key=u.get) if u else None,
            "excluded_leaves": sorted(set(grads) - set(moving_leaves(ref))),
            "dropped_program": ck["dropped"],
            "occupancy_flips": ref["occupancy_flips"]}


def numbers(cell, ref: Dict) -> Dict[str, float]:
    """The compared numbers of one run (module docstring)."""
    ck = cell.checked
    grads = {k: v for k, v in ref["grad_norms"].items() if v is not None}
    program_evaluated = [s - d for s, d in zip(ck["samples"], ck["dropped"])]
    grad_gaps = leaf_gaps(ck["grad_norms"], grads, grads)
    update_gaps = leaf_gaps(ref["program_change_norms"], ref["change_norms"],
                            moving_leaves(ref))
    return {
        "batch": batch_check.batch_error(cell),
        "occupancy": ref["occupancy"],
        "loss": max(_rel(a, b) for a, b in zip(ck["losses"], ref["losses"])),
        "samples": max([_rel(a, b) for a, b in zip(ck["samples"], ref["samples"])]
                       + [_rel(a, b) for a, b in zip(program_evaluated, ref["evaluated"])]),
        "grad": statistics.median(grad_gaps.values()),
        **_parts(grad_gaps, "grad"),
        "update": statistics.median(update_gaps.values()),
        **_parts(update_gaps, "update"),
        "render": ref["render"],
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} and whether every value is within its
    limit (a missing or non-finite value is not)."""
    checks = {k: {"value": values.get(k, float("nan")), "limit": limits[k]}
              for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": bool(ok), "checks": checks}
