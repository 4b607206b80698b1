"""The port's measurement path vs the JAX package, on the CPU: the copy
kernels' plain versions against the Pallas kernels P1-P4 in interpret
mode, the alternative quad builds and fold, the train-step bench and its
inputs, and the entry points' default device.

Copies are compared bit for bit; the kernels themselves run only on the
card (tests/test_torch_kernels.py).
"""

import importlib.util
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import REPO, t

import __graft_entry__
from nersemble_tpu.ops import hash_encoding as jhe
from nersemble_tpu.ops import quad_pallas
from nersemble_tpu_torch import bench
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine import checkpoints
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops import copy_kernels, quad_kernel
from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels
from nersemble_tpu_torch.scripts import bench_quad_build
from nersemble_tpu_torch.utils.bench_data import bench_batch, bench_grid
from nersemble_tpu_torch.utils.cameras import synthetic_occupancy

TINY_LEVELS = (4, 10, 4, 1.5)   # the tiny flagship layout: 1024-row hashed levels
BLOCK_LEVELS = (6, 12, 4, 1.5)  # a padded dense level + 2048-row-multiple levels


def _load_script(name):
    """A module of the JAX package's scripts/ directory, by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


# -- P1: the row gather ------------------------------------------------------------

@pytest.mark.parametrize("depth", [8, 16, 64])  # 64 > N: the tail loop alone
def test_gather_rows_matches_pallas_gather(depth):
    E, W, N = 64, 128, 40
    rng = np.random.default_rng(0)
    table = rng.standard_normal((E, W)).astype(np.float32)
    idx = rng.integers(0, E, N).astype(np.int32)
    probe = _load_script("pallas_gather_probe")
    theirs = probe.make_pallas_gather(E, W, N, depth=depth, interpret=True)(
        jnp.asarray(idx), jnp.asarray(table).astype(jnp.bfloat16))
    ours = copy_kernels.gather_rows_plain(t(table).to(torch.bfloat16), t(idx))
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


# -- P2-P4: the quad build's cost ladder ---------------------------------------------

@pytest.fixture(scope="module")
def pallas_ladder():
    """The JAX script's ``run_diagnostics`` at the tiny level set, in
    interpret mode, each rung's output recorded: (table, {rung: output})."""
    script = _load_script("bench_quad_build")
    create = jhe.HashGridLevels.create
    outputs = []

    def record(fn, *args, iters=10):
        outputs.append(np.asarray(fn(*args)))
        return 0.0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhe.HashGridLevels, "create",
                   staticmethod(lambda *a, **k: create(*TINY_LEVELS)))
        mp.setattr(quad_pallas, "INTERPRET", True)
        mp.setattr(script, "timed", record)
        script.run_diagnostics()
    E = create(*TINY_LEVELS).total_entries // quad_pallas.BLOCK * quad_pallas.BLOCK
    table = np.random.default_rng(0).standard_normal((E, 64)).astype(np.float32)
    assert len(outputs) == 3  # 1024-row levels: no block-aligned build rung
    return t(table).to(torch.bfloat16), dict(zip(("copy", "bcast", "fetch7"), outputs))


@pytest.mark.parametrize("rung", ["copy", "bcast", "fetch7"])
def test_copy_ladder_matches_pallas_diagnostics(pallas_ladder, rung):
    table, outputs = pallas_ladder
    ours = {"copy": lambda: copy_kernels.copy_plain(table),
            "bcast": lambda: copy_kernels.bcast_quarters_plain(table),
            "fetch7": lambda: copy_kernels.fetch7_plain(*[table] * 7)}[rung]()
    np.testing.assert_array_equal(_bits(ours), _bits(outputs[rung]))


def test_fetch7_takes_quarters_from_inputs_0_1_3_5():
    seven = [torch.full((5, 8), float(i)) for i in range(7)]
    out = copy_kernels.fetch7_plain(*seven)
    assert out[:, ::8].tolist() == [[0.0, 1.0, 3.0, 5.0]] * 5


@pytest.mark.parametrize("fn", [copy_kernels.copy_cuda,
                                copy_kernels.bcast_quarters_cuda,
                                lambda x: copy_kernels.fetch7_cuda(*[x] * 7),
                                lambda x: copy_kernels.gather_rows_cuda(
                                    x, torch.zeros(3, dtype=torch.int32))])
def test_copy_kernel_wrappers_reject_cpu_tensors(fn):
    with pytest.raises(ValueError):
        fn(torch.zeros(16, 64, dtype=torch.bfloat16))


# -- the alternative quad builds and fold -----------------------------------------------

@pytest.mark.parametrize("layout", [TINY_LEVELS, BLOCK_LEVELS])
@pytest.mark.parametrize("build", ["slicepair", "doubled"])
def test_alternative_builds_match_plain_and_jax(layout, build):
    levels, jlevels = HashGridLevels.create(*layout), jhe.HashGridLevels.create(*layout)
    table = np.random.default_rng(3).standard_normal(
        (levels.total_entries, 16)).astype(np.float32)
    tb = t(table).to(torch.bfloat16)
    ours = {"slicepair": bench_quad_build.build_slicepair,
            "doubled": bench_quad_build.build_doubled}[build](tb, levels)
    assert torch.equal(ours, quad_kernel.quad_build_plain(tb, levels))
    theirs = jhe._quad_fwd_xla(jnp.asarray(table).astype(jnp.bfloat16), jlevels)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


@pytest.mark.parametrize("layout", [TINY_LEVELS, BLOCK_LEVELS])
def test_slicepair_fold_matches_plain_and_jax(layout):
    levels, jlevels = HashGridLevels.create(*layout), jhe.HashGridLevels.create(*layout)
    g = np.random.default_rng(4).standard_normal(
        (levels.total_entries, 64)).astype(np.float32)
    gb = t(g).to(torch.bfloat16)
    ours = bench_quad_build.fold_slicepair(gb, levels)
    assert torch.equal(ours, quad_kernel.quad_fold_plain(gb, levels))
    theirs = jhe._quad_bwd_xla(jnp.asarray(g).astype(jnp.bfloat16), jlevels)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


# -- the train-step bench ---------------------------------------------------------------------

def test_bench_inputs_match_bench_py():
    """bench.py's grid and batch: ``_example_rays(n, T, seed=1)`` and the
    draws of ``default_rng(0)`` after the grid."""
    n, T, G = 64, 8, 16
    rng = np.random.default_rng(0)
    occ = rng.uniform(size=(G, G, G)) < 0.05
    c = slice(G // 2 - G // 8, G // 2 + G // 8)
    occ[c, c, c] = True
    theirs = {k: np.asarray(v) for k, v in __graft_entry__._example_rays(n, T, seed=1).items()}
    theirs["rgb"] = rng.uniform(size=(n, 3)).astype(np.float32)
    theirs["alpha"] = rng.uniform(size=n).astype(np.float32)
    theirs["depth"] = rng.uniform(7.5, 9.5, n).astype(np.float32)
    np.testing.assert_array_equal(bench_grid(G).numpy(), occ.reshape(-1).astype(np.float32))
    ours = bench_batch(n, T, G, "cpu")
    for key, value in ours.items():
        np.testing.assert_array_equal(value.numpy(), theirs[key], err_msg=key)


def _run_bench(capsys, *argv):
    result = bench.main(["--tiny", "--device", "cpu", "--rays", "64",
                         "--iters", "2", *argv])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == result
    return result, out


def test_bench_prints_bench_py_json_line(capsys):
    result, _ = _run_bench(capsys)
    assert set(result) == {"metric", "value", "unit", "extra"}
    assert set(result["extra"]) == {"ray_samples_per_sec", "step_ms", "n_rays",
                                    "budget", "n_candidates", "device", "loss",
                                    "power_limit"}
    assert result["metric"] == "train_rays_per_sec_per_chip"
    assert result["unit"] == "rays/s" and result["value"] > 0
    assert result["extra"]["device"] == "cpu" and result["extra"]["n_rays"] == 64
    assert result["extra"]["budget"] == 64 * 16  # the steady-state fill caps at R*S
    assert np.isfinite(result["extra"]["loss"])


def test_bench_from_run_loads_grid_and_budget(tmp_path, capsys):
    cfg = flagship_model_config(tiny=True)
    trainer = NeRSembleTrainer(cfg, n_rays=64, seed=3, device="cpu")
    trainer.grid_occs = torch.from_numpy(synthetic_occupancy(16, 0.3, 7))
    trainer._budget = 256
    trainer.save_checkpoint(tmp_path / "checkpoints" / "step-000000001.ckpt", 1)
    trainer._budget = 512
    trainer.save_checkpoint(tmp_path / "checkpoints" / "step-000000005.ckpt", 5)
    result, out = _run_bench(capsys, "--from-run", str(tmp_path))
    assert result["extra"]["budget"] == 512
    fill = float(NeRSembleModel(cfg, "cpu").binaries(trainer.grid_occs).float().mean())
    assert f"# from-run grid: fill={fill:.4f} adapted_budget=512" in out
    assert fill != float(bench_grid(16).mean())


def test_bench_frame_prints_its_json_line(capsys):
    """scripts/bench_frame.py on the tiny config at 32x24 on the CPU: one JSON
    line with the first frame's and each round's ms, the scene hitting."""
    from nersemble_tpu_torch.scripts import bench_frame
    result = bench_frame.main(["--tiny", "--device", "cpu", "--rounds", "2"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["frame"] == [32, 24] and len(result["ms_per_frame"]) == 2
    assert result["first_frame_ms"] > 0 and result["hit_fraction"] > 0
    assert result["device"] == "cpu"


# -- the entry points default to the card ------------------------------------------------

@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "step-000000000.ckpt"
    NeRSembleTrainer(flagship_model_config(tiny=True), n_rays=64,
                     device="cpu").save_checkpoint(path, 0)
    return path


DEFAULT_DEVICE_CALLS = {
    "NeRSembleModel": lambda path: NeRSembleModel(flagship_model_config(tiny=True)),
    "NeRSembleTrainer": lambda path: NeRSembleTrainer(flagship_model_config(tiny=True)),
    "load_jax_checkpoint": lambda path: checkpoints.load_jax_checkpoint(path),
    "load_checkpoint": lambda path: checkpoints.load_checkpoint(path),
    "params_from_numpy": lambda path: checkpoints.params_from_numpy(
        dict(np.load(path))),
    "opt_state_from_numpy": lambda path: checkpoints.opt_state_from_numpy(
        dict(np.load(path))),
    "bench": lambda path: bench.main(["--tiny", "--rays", "64", "--iters", "1"]),
}


@pytest.mark.parametrize("entry", sorted(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(monkeypatch, tiny_checkpoint, entry):
    """Without CUDA, a default construction raises; it does not carry on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_DEVICE_CALLS[entry](tiny_checkpoint)
