"""The port imports without JAX, YAML or the imaging and plotting packages
(the card's Python has none of them) and without scipy until a function
needs it, its configs equal the JAX ones, and
structural rules hold in its sources (no bitcast carriers, no host syncs in
the training step and in the loop's steps outside its cadences)."""

import ast
import dataclasses
import inspect
import pkgutil
import re
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
from torch_parity import REPO

import __graft_entry__
import nersemble_tpu.config as jax_config
import nersemble_tpu_torch
import nersemble_tpu_torch.config as torch_config

PACKAGE = REPO / "nersemble_tpu_torch"
CSRC = PACKAGE / "csrc"


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        nersemble_tpu_torch.__path__, "nersemble_tpu_torch."))


# packages the JAX package uses that the card's Python does not have
BLOCKED = ("jax", "yaml", "imageio", "PIL", "matplotlib", "cv2")
# imported only inside the functions that need them (the host-side filter
# and JOD of the evaluate CLI)
LAZY = ("scipy",)


def test_imports_without_jax_and_yaml():
    names = _submodules()
    assert {"nersemble_tpu_torch.models.nersemble",
            "nersemble_tpu_torch.scripts.train_nersemble",
            "nersemble_tpu_torch.scripts.evaluate_nersemble",
            "nersemble_tpu_torch.scripts.render_nersemble",
            "nersemble_tpu_torch.scripts.view_nersemble",
            "nersemble_tpu_torch.viewer.server",
            "nersemble_tpu_torch.utils.connected_components",
            "nersemble_tpu_torch.utils.fvvdp", "nersemble_tpu_torch.utils.jod",
            "nersemble_tpu_torch.utils.lpips",
            "nersemble_tpu_torch.utils.videoio",
            "nersemble_tpu_torch.utils.synthetic_capture",
            "nersemble_tpu_torch.scripts.quality_benchmark",
            "nersemble_tpu_torch.scripts.bench_render",
            "nersemble_tpu_torch.scripts.validate_poses",
            "nersemble_tpu_torch.scripts.trained_scene",
            "nersemble_tpu_torch.scripts.bench_projection",
            "nersemble_tpu_torch.parallel.mesh",
            "nersemble_tpu_torch.parallel.launch",
            "nersemble_tpu_torch.parallel.compare"} <= set(names)
    code = ("import sys\n"
            f"for blocked in {BLOCKED + LAZY!r}:\n"
            "    sys.modules[blocked] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m in ('nersemble_tpu', 'tests') "
            "or m.startswith(('nersemble_tpu.', 'tests.'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_launch_counts_and_the_tracer_import_no_kernel_wrapper():
    """The launch counters and the tracer sit below the kernel wrappers:
    every wrapper imports them, neither imports a wrapper."""
    code = ("import sys\n"
            "import nersemble_tpu_torch.ops.launch_counts\n"
            "import nersemble_tpu_torch.utils.spans\n"
            "print(*sorted(m for m in sys.modules "
            "if m.startswith('nersemble_tpu_torch.ops.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["nersemble_tpu_torch.ops.launch_counts"]


def test_cuda_lib_run_raises_with_the_entry_name(monkeypatch):
    """``cuda_lib.run`` calls the library's entry with its arguments and
    raises, naming the entry, on a nonzero status."""
    from nersemble_tpu_torch.ops import cuda_lib

    statuses, calls = [0, 700], []

    def entry(*args):
        calls.append(args)
        return statuses.pop(0)

    monkeypatch.setattr(cuda_lib, "_library", SimpleNamespace(quad_fold=entry))
    cuda_lib.run("quad_fold", 1, 2)
    with pytest.raises(RuntimeError, match=r"^quad_fold: CUDA error 700 "):
        cuda_lib.run("quad_fold", 3, 4)
    assert calls == [(1, 2), (3, 4)]


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|yaml|imageio|PIL|matplotlib|cv2"
                         r"|nersemble_tpu|tests)\b", re.MULTILINE)
    offenders = [str(p) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("name", ["HashEncodingConfig", "HashEnsembleConfig",
                                  "SE3DeformationFieldConfig",
                                  "SamplingConfig", "ModelConfig",
                                  "OptimizerConfig"])
def test_config_defaults_match(name):
    ours = getattr(torch_config, name)()
    theirs = getattr(jax_config, name)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_default_optimizers_match():
    ours = {k: dataclasses.asdict(v)
            for k, v in torch_config.default_optimizers().items()}
    theirs = {k: dataclasses.asdict(v)
              for k, v in jax_config.TrainConfig().optimizers.items()}
    assert ours == theirs


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_config_matches(tiny):
    ours = dataclasses.asdict(torch_config.flagship_model_config(tiny))
    theirs = dataclasses.asdict(__graft_entry__._flagship_model_config(tiny))
    assert ours == theirs


def test_no_int_float_bitcasts_in_the_port():
    """Integers ride as float VALUES (timesteps in the packed ray rows),
    never as reinterpreted bits: a flush-to-zero of subnormal bit patterns
    silently zeroed every timestep on the TPU (nersemble.py:383-397)."""
    bitcast = re.compile(r"\.view\(\s*(torch\.)?(u?int\d+|float\d+|bfloat16|half)\b")
    offenders = [str(p) for p in PACKAGE.rglob("*.py")
                 if bitcast.search(p.read_text())]
    assert offenders == []
    # the CUDA sources: no int <-> float bit reinterpretation intrinsics
    # (whole 16-byte row copies as uint4 move bf16/f32 bits unchanged)
    cuda_bitcast = re.compile(r"__u?int_as_float|__float_as_u?int|"
                              r"__u?short_as_bfloat16|__bfloat16_as_u?short|"
                              r"__u?short_as_half|__half_as_u?short")
    sources = sorted(CSRC.glob("*.cu"))
    assert {p.name for p in sources} >= {"fused_mlp_fwd.cu", "fused_mlp_bwd.cu",
                                         "quad_build.cu", "quad_fold.cu"}
    assert [str(p) for p in sources if cuda_bitcast.search(p.read_text())] == []


def test_cuda_sources_include_only_the_toolkit():
    """csrc/ builds with nvcc alone: no PyTorch, JAX or XLA headers (the
    toolkit's runtime and tensor-map types, and csrc/'s own headers)."""
    allowed = {"cuda_runtime.h", "cuda_bf16.h", "stdint.h", "cuda.h",
               "cudaTypedefs.h"} | {p.name for p in CSRC.glob("*.cuh")}
    for path in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]:
        includes = set(re.findall(r'^#include\s*[<"]([^>"]+)[>"]',
                                  path.read_text(), re.MULTILINE))
        assert includes <= allowed, (path.name, includes - allowed)


# modules whose code runs inside NeRSembleTrainer.train_step
TRAIN_PATH = ["models/nersemble.py", "models/field.py", "models/deformation.py",
              "ops/fused_mlp.py", "ops/quad_kernel.py", "ops/hash_encoding.py",
              "ops/hash_ensemble.py", "ops/mlp.py", "ops/posenc.py",
              "ops/sampling.py", "ops/occupancy.py", "ops/rendering.py",
              "ops/losses.py", "ops/distortion.py", "ops/trunc_exp.py",
              "ops/sh.py", "engine/optimizers.py", "utils/se3.py",
              "utils/windows.py", "utils/metrics.py", "utils/device.py",
              "data/ray_batcher.py", "parallel/mesh.py", "utils/spans.py"]
HOST_SYNC = re.compile(r"\.(item|cpu|numpy)\(")


def test_no_host_sync_in_the_train_step():
    """ROADMAP C5: reading a device value on the host (``.item()``,
    ``.cpu()``, ``.numpy()``) waits for the GPU's queue to drain. No module on the
    train path does it; the trainer reads sample counts on the host only on
    the adaptive budget's cadence (``_maybe_adapt_budget``, through
    ``utils/spans.host_value``)."""
    offenders = [name for name in TRAIN_PATH
                 if HOST_SYNC.search((PACKAGE / name).read_text())]
    assert offenders == []
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    for method in ("train_step", "run_step", "maybe_update_occupancy",
                   "_reduce_gradients", "_batch_aux"):
        source = inspect.getsource(getattr(NeRSembleTrainer, method))
        assert not HOST_SYNC.search(source), method
        assert not re.search(r"\b(float|int|bool)\(", source), method
    assert "host_value(aux" in inspect.getsource(NeRSembleTrainer._maybe_adapt_budget)


# the loop's methods that read device values; ``train`` may call them only
# inside a cadence branch (an ``if`` on ``step % ...``) or after the loop
CADENCE_READERS = {"_log", "_eval_batch", "_eval_image", "_train_image",
                   "_eval_all_images", "save_run_checkpoint"}


def test_no_host_sync_in_the_loop_outside_its_cadences():
    """The loop's steps that log, evaluate and save nothing make no
    synchronizing call: the batch arrives through page-locked memory
    (``DeviceBatches.__next__``), host draws through ``to_device``, and
    ``train`` reads device values only through CADENCE_READERS, each
    called inside a cadence branch."""
    from nersemble_tpu_torch.data.ray_batcher import DeviceBatches
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.utils.device import to_device
    for fn in (DeviceBatches.__next__, to_device, NeRSembleTrainer.train):
        source = inspect.getsource(fn)
        assert not HOST_SYNC.search(source), fn.__name__
        assert not re.search(r"\b(float|int|bool)\(", source), fn.__name__
    assert "non_blocking=True" in inspect.getsource(DeviceBatches.__next__)
    for fn in (NeRSembleTrainer.train_step, NeRSembleTrainer.maybe_update_occupancy):
        assert "to_device(" in inspect.getsource(fn), fn.__name__
    assert "pin_memory().to(device, non_blocking=True)" in inspect.getsource(to_device)

    tree = ast.parse(textwrap.dedent(inspect.getsource(NeRSembleTrainer.train)))
    (loop,) = [node for node in ast.walk(tree) if isinstance(node, ast.For)]
    found = set()

    def visit(node, in_cadence):
        if isinstance(node, ast.If):
            in_cadence = in_cadence or any(isinstance(n, ast.Mod) for n in ast.walk(node.test))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in CADENCE_READERS:
            assert in_cadence, f"{node.func.attr} outside a cadence branch"
            found.add(node.func.attr)
        for child in ast.iter_child_nodes(node):
            visit(child, in_cadence)

    visit(loop, False)
    assert found == CADENCE_READERS


SYNC_METHODS = ("item", "cpu", "numpy", "tolist", "__bool__", "__float__", "__int__",
                "__index__")


@pytest.mark.parametrize("variant", ["flagship", "single_grid", "single_grid_static",
                                     "ensemble_static", "cone", "early_stop",
                                     "sh_appearance"])
def test_train_step_of_every_configuration_reads_no_device_value(variant, monkeypatch):
    """The scan above, run: the occupancy update and two train steps of
    each model configuration (the tiny flagship and chip_smoke.py's
    TINY_VARIANTS: the single grid, no deformation, a cone angle, early
    stop, SH + appearance) on the CPU with every Tensor method that hands a
    value to the host raising."""
    import numpy as np
    import torch

    from chip_smoke import tiny_config
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer

    cfg, _ = tiny_config(None if variant == "flagship" else variant)
    trainer = NeRSembleTrainer(cfg, n_rays=64, device="cpu")
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
    batch = {"origins": torch.tensor([[-8.0, 0.0, 0.0]]).repeat(64, 1),
             "directions": torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                                        dtype=torch.float32),
             "timesteps": torch.from_numpy(rng.integers(0, 8, 64)),
             "camera_indices": torch.from_numpy(rng.integers(0, max(cfg.num_images, 1), 64)),
             "rgb": torch.rand(64, 3), "alpha": torch.rand(64),
             "depth": torch.rand(64) * 2 + 7.5}

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"Tensor.{name} on the train path")
        return read

    for name in SYNC_METHODS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    trainer.maybe_update_occupancy(0)
    for step in (0, 1):
        total, aux = trainer.train_step(step, batch)
    monkeypatch.undo()
    assert torch.isfinite(total) and int(aux["num_samples"]) > 0


def test_parallel_train_step_reads_no_device_value(tmp_path, monkeypatch):
    """The same with the parallel code path: a gloo group of one rank in
    this process (every collective of the step runs: the gathered counts
    and rows of the compaction, the loss counts, the gradient and aux
    all-reduces) and the Tensor methods refusing as above."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from chip_smoke import tiny_config
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.parallel import compare
    from nersemble_tpu_torch.parallel.mesh import DataMesh

    from nersemble_tpu_torch.utils import spans

    cfg, _ = tiny_config(None)
    cfg.sampling.global_budget_fraction = 0.5  # the compaction runs
    calls = spans.counter("comm_calls")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        trainer = NeRSembleTrainer(cfg, n_rays=64, device="cpu",
                                   mesh=DataMesh(dist.group.WORLD, "gloo"))
        batch = {k: torch.from_numpy(v) for k, v in
                 compare.synthetic_batches(64, 1, 8, seed=0)[0].items()}

        def refuse(name):
            def read(*args, **kwargs):
                raise AssertionError(f"Tensor.{name} on the train path")
            return read

        for name in SYNC_METHODS:
            monkeypatch.setattr(torch.Tensor, name, refuse(name))
        trainer.maybe_update_occupancy(0)
        for step in (0, 1):
            total, aux = trainer.train_step(step, batch)
        monkeypatch.undo()
        assert torch.isfinite(total) and int(aux["num_samples"]) > 0
        assert int(aux["num_budget_dropped"]) > 0 and spans.counter("comm_calls") > calls
        assert np.isfinite(float(aux["psnr"]))
    finally:
        dist.destroy_process_group()


def test_viewer_round_without_requests_reads_no_device_value(tmp_path, monkeypatch):
    """The viewer over ranks between two steps with nothing pending
    (``serve_over_ranks``, a gloo group of one rank in this process): one
    host message, no render, and no Tensor method that hands a device value
    to the host."""
    import torch
    import torch.distributed as dist

    from nersemble_tpu_torch.parallel.mesh import DataMesh
    from nersemble_tpu_torch.viewer import ViewerServer, serve_over_ranks

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    server = ViewerServer(state={}, port=0)
    try:
        def refuse(name):
            def read(*args, **kwargs):
                raise AssertionError(f"Tensor.{name} in a viewer round")
            return read

        def render(params):
            raise AssertionError("a round without requests rendered")

        for name in SYNC_METHODS:
            monkeypatch.setattr(torch.Tensor, name, refuse(name))
        mesh = DataMesh(dist.group.WORLD, "gloo")
        assert [serve_over_ranks(server, mesh, render) for _ in range(3)] == [0, 0, 0]
    finally:
        monkeypatch.undo()
        server.close()
        dist.destroy_process_group()
