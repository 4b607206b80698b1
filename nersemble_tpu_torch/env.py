"""Environment-variable path roots (the port's copy of nersemble_tpu/env.py).

Mirrors the reference behavior (reference: src/nersemble/env.py:1-13): paths are
read from ``~/.config/nersemble/.env`` if present, with real environment
variables taking precedence. Defaults keep everything under ``~/.cache`` so the
framework is runnable without configuration. Consumers read the module's
attributes when they are called, not when they are imported, so a caller
(or a test) can repoint them.
"""

import os
from pathlib import Path
from typing import Dict

REPO_ROOT_ENVIRONMENT_VARIABLE = "NERSEMBLE_ENV_PATH"


def _read_dotenv(path: Path) -> Dict[str, str]:
    values = {}
    if path.exists():
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            values[key.strip()] = value.strip().strip('"').strip("'")
    return values


def _resolve(name: str, default: str) -> str:
    if name in os.environ:
        return os.environ[name]
    env_dir = os.environ.get(REPO_ROOT_ENVIRONMENT_VARIABLE,
                             os.path.join(os.path.expanduser("~"), ".config", "nersemble"))
    dotenv = _read_dotenv(Path(env_dir) / ".env")
    if name in dotenv:
        return dotenv[name]
    return default


_default_root = os.path.join(os.path.expanduser("~"), ".cache", "nersemble")

NERSEMBLE_DATA_PATH = _resolve("NERSEMBLE_DATA_PATH", os.path.join(_default_root, "data"))
NERSEMBLE_MODELS_PATH = _resolve("NERSEMBLE_MODELS_PATH", os.path.join(_default_root, "models"))
NERSEMBLE_RENDERS_PATH = _resolve("NERSEMBLE_RENDERS_PATH", os.path.join(_default_root, "renders"))
