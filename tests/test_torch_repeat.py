"""ROADMAP C12: a training run repeats bit for bit in one CPU process.

chip_smoke.py phase 6b's three steps (``flagship_steps_spec``: seeded
contrast-scaled weights, bench.py's grid, a sampled occupancy update and a
budget decision at step 80000) on the tiny flagship config, run twice in
this process through ``parallel/compare.run_steps``; the SHA-256 digests
of the parameters, both Adam moments and the grid, and the losses, must be
equal. At 4096 rays the time codes' gathers see enough samples that
PyTorch's CPU backward of ``weight[index]`` took its parallel path, which
adds rows with atomics: two runs differed in ``time_embedding`` and
``time_embedding_deformation`` and their moments. On the CPU the time
codes are gathered with ``F.embedding`` (``models/nersemble._gather_rows``),
whose backward sums each row in index order. Checked at the test
process's thread count and at two threads.
"""

import pytest
import torch

import chip_smoke
import nersemble_tpu_torch.config as port_config
from nersemble_tpu_torch.parallel import compare

RAYS = 4096


def _spec(monkeypatch):
    flagship = port_config.flagship_model_config
    monkeypatch.setattr(port_config, "flagship_model_config",
                        lambda tiny=False: flagship(tiny=True))
    monkeypatch.setattr(chip_smoke, "TRAIN_RAYS", RAYS)
    spec = chip_smoke.flagship_steps_spec()
    spec.update(device="cpu", digest=True)
    return spec


@pytest.mark.parametrize("threads", [None, 2])
def test_steps_repeat_bit_for_bit_in_one_process(monkeypatch, threads):
    spec = _spec(monkeypatch)
    before = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        runs = [compare.run_steps(None, spec) for _ in range(2)]
    finally:
        torch.set_num_threads(before)
    first, second = runs
    assert len(first["loss"]) == 3 and first["num_samples"][0] > 0
    differ = [k for k, v in first["digest"].items() if second["digest"][k] != v]
    assert not differ, f"a second run differs from the first in {differ}"
    assert second["loss"] == first["loss"]
