"""The port imports without JAX or YAML, and its configs equal the JAX ones."""

import dataclasses
import pkgutil
import re
import subprocess
import sys

import pytest
from torch_parity import REPO

import __graft_entry__
import nersemble_tpu.config as jax_config
import nersemble_tpu_torch
import nersemble_tpu_torch.config as torch_config

PACKAGE = REPO / "nersemble_tpu_torch"


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        nersemble_tpu_torch.__path__, "nersemble_tpu_torch."))


def test_imports_without_jax_and_yaml():
    names = _submodules()
    assert "nersemble_tpu_torch.models.nersemble" in names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['yaml'] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'nersemble_tpu' "
            "or m.startswith('nersemble_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|yaml|nersemble_tpu)\b",
                         re.MULTILINE)
    offenders = [str(p) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("name", ["HashEncodingConfig", "HashEnsembleConfig",
                                  "SE3DeformationFieldConfig",
                                  "SamplingConfig", "ModelConfig"])
def test_config_defaults_match(name):
    ours = getattr(torch_config, name)()
    theirs = getattr(jax_config, name)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


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
