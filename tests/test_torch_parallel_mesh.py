"""``nersemble_tpu_torch.parallel.mesh`` over gloo ranks (CPU tensors): the
four collectives on the ray and entry axes, their autograd versions (each
the other's backward), the ray slices and the axis size; and a process
group of one rank, which runs every collective of the parallel code path,
trains bit for bit as the plain trainer (chip_smoke.py phase 16 (a) holds
the same on the card over NCCL). Exact comparisons throughout. This module
imports no JAX: its worker runs in the spawned ranks.
"""

import numpy as np
import pytest
import torch

from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.parallel import compare, launch
from nersemble_tpu_torch.parallel.mesh import DataMesh, axis_size, pad_to_multiple
from nersemble_tpu_torch.utils import spans
from nersemble_tpu_torch.utils.cameras import synthetic_occupancy
from nersemble_tpu_torch.utils.params import to_tree


def collectives(mesh):
    """Every collective on rank-dependent inputs; JSON lists."""
    r, n = mesh.rank, mesh.size
    calls = spans.counter("comm_calls")
    x = torch.arange(4 * n, dtype=torch.float32).reshape(2 * n, 2) + 100 * r
    out = {
        "rows": [mesh.rows(8).start, mesh.rows(8).stop],
        "all_reduce": mesh.all_reduce_sum(x).tolist(),
        "all_gather": mesh.all_gather_rows(x[:2]).tolist(),
        "reduce_scatter": mesh.reduce_scatter_rows(x).tolist(),
        "broadcast": mesh.broadcast(x.clone(), src=1).tolist(),
        "object": mesh.broadcast_object({"rank": r} if r == 0 else None),
        "int64": mesh.all_gather_rows(torch.tensor([r], dtype=torch.int64)).tolist(),
    }
    a = x[:2].clone().requires_grad_(True)
    (mesh.all_gather_rows_grad(a) * (1 + torch.arange(2 * n)[:, None])).sum().backward()
    out["d_all_gather"] = a.grad.tolist()
    b = x.clone().requires_grad_(True)
    (mesh.reduce_scatter_rows_grad(b) * (1 + r)).sum().backward()
    out["d_reduce_scatter"] = b.grad.tolist()
    out["calls"] = spans.counter("comm_calls") - calls
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_over_gloo_ranks(n):
    got = launch.spawn(collectives, n, "gloo", "cpu", timeout_s=120.0)
    xs = [np.arange(4 * n, dtype=np.float32).reshape(2 * n, 2) + 100 * r
          for r in range(n)]
    assert got["rows"] == [0, 8 // n]
    np.testing.assert_array_equal(got["all_reduce"], sum(xs))
    np.testing.assert_array_equal(got["all_gather"], np.concatenate([x[:2] for x in xs]))
    np.testing.assert_array_equal(got["reduce_scatter"], sum(xs)[:2])
    np.testing.assert_array_equal(got["broadcast"], xs[1])
    assert got["object"] == {"rank": 0}
    assert got["int64"] == list(range(n))
    # d/da of sum(w * gather(a)) on rank 0 = sum over ranks of w's rows 0:2
    np.testing.assert_array_equal(got["d_all_gather"], n * np.array([[1, 1], [2, 2]]))
    # d/db of sum(c_r * scatter(b)): every rank's c in its own rows
    np.testing.assert_array_equal(
        got["d_reduce_scatter"], np.repeat(np.arange(1, n + 1), 2)[:, None] * np.ones((1, 2)))
    assert got["calls"] == 9


def test_one_rank_without_a_group_is_the_identity():
    mesh = DataMesh()
    x = torch.ones(4, 2)
    calls = spans.counter("comm_calls")
    assert mesh.size == 1 and mesh.rank == 0 and mesh.rows(4) == slice(0, 4)
    for fn in (mesh.all_reduce_sum, mesh.all_gather_rows, mesh.reduce_scatter_rows,
               mesh.broadcast, mesh.all_gather_rows_grad, mesh.reduce_scatter_rows_grad):
        assert fn(x) is x
    assert spans.counter("comm_calls") == calls


def test_axis_size_and_padding():
    assert axis_size(-1, "cpu") == 1 and axis_size(3, "cpu") == 3
    with pytest.raises(ValueError):
        axis_size(0, "cpu")
    assert [pad_to_multiple(k, 4) for k in (0, 1, 4, 5)] == [0, 4, 4, 8]
    with pytest.raises(ValueError, match="do not divide"):
        launch_rows = DataMesh()
        launch_rows.size = 3
        launch_rows.rows(8)


@pytest.mark.parametrize("layout", ["replicated", "zero3"])
def test_one_rank_group_trains_bitwise_as_the_plain_trainer(layout, tmp_path):
    """Three steps through every collective of the parallel path on a gloo
    group of one rank (ZeRO-3 on one rank keeps the table whole, as the JAX
    trainer does) equal the plain trainer's bit for bit."""
    cfg = flagship_model_config(tiny=True)
    cfg.sampling.global_budget_fraction = 0.5
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    params = to_tree(NeRSembleModel(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0)), lambda p: p.numpy())
    spec = {"config": cfg, "layout": layout, "params": params,
            "grid_occs": synthetic_occupancy(16, 0.3, seed=0),
            "batches": compare.synthetic_batches(64, 3, cfg.n_timesteps, seed=3)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the spawned CPU rank: sums split alike
    try:
        plain = compare.run_steps(None, dict(spec, out=str(tmp_path / "plain.ckpt")))
    finally:
        torch.set_num_threads(threads)
    group = launch.spawn(compare.run_steps, 1, "gloo", "cpu",
                         dict(spec, out=str(tmp_path / "group.ckpt")), timeout_s=120.0)
    assert group["loss"] == plain["loss"] and min(group["comm_ms_per_step"]) > 0
    assert plain["num_budget_dropped"][0] > 0
    a, b = read_flat(tmp_path / "plain.ckpt"), read_flat(tmp_path / "group.ckpt")
    for key in a:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_bench_projection_runs_on_the_cpu():
    """The projection's JSON line at the tiny size: the measured parts, the
    comms term labelled an estimate; no n-rank run without n cards."""
    from nersemble_tpu_torch.scripts import bench_projection
    result = bench_projection.main(["--tiny", "--device", "cpu", "--n-cards", "2",
                                    "--iters", "2", "--rays", "64"])
    extra = result["extra"]
    assert result["metric"] == "per_card_step_projection_2_cards"
    assert extra["n_rays_per_card"] == 32 and extra["device"] == "cpu"
    assert "not measured" in extra["comms_estimate_basis"]
    assert result["value"] == pytest.approx(
        extra["measured_step_ms_per_card_rays"] - extra["measured_adam_full_table_ms"]
        + extra["measured_adam_shard_ms"] + extra["estimated_comms_ms"], abs=0.02)
    assert "measured_n_rank_step" not in extra
