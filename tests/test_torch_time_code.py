"""The time codes' gather on the CPU: the plan of the card kernel's tiles
(``ops/time_code.plan``), its plain version's sums (the kernel's order, in
numpy) against float64 sums, the model's CPU branch through ``F.embedding``
and the kernel's launch counter. The kernel itself is held to the plain
version on the card (tests/test_torch_kernels.py)."""

import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from nersemble_tpu_torch.models import nersemble
from nersemble_tpu_torch.ops import launch_counts, time_code


@pytest.mark.parametrize("d", [1, 6, 32, 128, 1024])
def test_the_plan_bounds_shared_memory_whatever_t_is(d):
    for t_rows in list(range(1, 65)) + [476, 1000, 2000, 4095, 4096]:
        p = time_code.plan(131072, t_rows, d)
        assert p.smem <= time_code.SMEM_BYTES <= time_code.SMEM_LIMIT
        assert p.smem == p.groups * p.rows_per_tile * p.lanes * 16
        assert p.tiles * p.rows_per_tile >= t_rows > (p.tiles - 1) * p.rows_per_tile
        assert 4 * p.blocks * t_rows * d <= max(time_code.MAX_PARTIAL_BYTES, 4 * t_rows * d)


@pytest.mark.parametrize("d", [32, 128])
def test_the_plan_takes_sixteen_timesteps_in_one_tile(d):
    """The cells' 16 timesteps: one row tile, so the gradient and the
    indices are read once."""
    p = time_code.plan(65536, 16, d)
    assert (p.tiles, p.rows_per_tile) == (1, 16)
    assert p.lanes * p.groups == time_code.THREADS and 4 * p.lanes >= d


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 65536, 93184, 372000, 10 ** 7])
@pytest.mark.parametrize("d", [6, 32, 128])
def test_the_plan_covers_every_sample_once(n, d):
    p = time_code.plan(n, 16, d)
    if n == 0:
        assert p.blocks == 0
        return
    assert 1 <= p.blocks <= time_code.MAX_BLOCKS
    assert (p.blocks - 1) * p.per_block < n <= p.blocks * p.per_block
    assert (p.per_group - 1) * p.groups < p.per_block <= p.groups * p.per_group
    assert time_code.plan(n, 16, d) == p  # a function of (N, T, D) alone


@pytest.mark.parametrize("d", [0, 1025])
def test_the_plan_refuses_widths_the_kernel_lacks(d):
    with pytest.raises(ValueError, match="rows of 1 to 1024"):
        time_code.plan(100, 16, d)


# (D, T, N, samples a ray): one tile, several tiles (476 timesteps, rows of
# 6 and 1 columns), several blocks
PLAIN_CASES = [(32, 16, 255, 32), (128, 16, 4097, 32), (6, 16, 1000, 7),
               (128, 476, 3000, 91), (32, 17, 5000, 32), (1, 3, 700, 5), (128, 16, 0, 1)]


@pytest.mark.parametrize("d,t_rows,n,per_ray", PLAIN_CASES)
def test_the_plain_sums_match_float64(d, t_rows, n, per_ray):
    g, idx = chip_smoke.time_code_inputs(n, t_rows, d, per_ray, torch.device("cpu"), seed=n)
    out = time_code.time_code_bwd_plain(g, idx, t_rows)
    assert out.shape == (t_rows, d) and out.dtype == torch.float32
    chip_smoke.time_code_check(out, g, idx, t_rows, chip_smoke.time_code_gamma(n, t_rows, d))


def test_the_plain_sums_skip_indices_outside_the_rows_and_take_a_column_slice():
    gen = torch.Generator().manual_seed(3)
    wide = torch.randn(900, 40, generator=gen)
    g = wide[:, 3:35]
    idx = torch.randint(-2, 18, (900,), generator=gen)
    keep = (idx >= 0) & (idx < 16)
    out = time_code.time_code_bwd_plain(g, idx, 16)
    chip_smoke.time_code_check(out, g[keep], idx[keep], 16,
                               chip_smoke.time_code_gamma(900, 16, 32))


def test_the_cpu_gather_goes_through_f_embedding(monkeypatch):
    """ROADMAP C12: on the CPU the time codes keep ``F.embedding``, whose
    backward sums each row in index order; the card's gather is not
    reached."""
    calls, plain = [], F.embedding

    def embedding(index, weight):
        calls.append(index.shape)
        return plain(index, weight)

    def refuse(*args):
        raise AssertionError("the CPU path reached the card's gather")

    monkeypatch.setattr(nersemble.F, "embedding", embedding)
    monkeypatch.setattr(time_code, "gather_rows", refuse)
    weight = torch.randn(16, 32, requires_grad=True)
    idx = torch.randint(0, 16, (300,))
    rows = nersemble._gather_rows(weight, idx)
    assert calls == [idx.shape] and torch.equal(rows, weight[idx])
    rows.sum().backward()
    assert torch.equal(weight.grad, torch.zeros(16, 32).index_add_(
        0, idx, torch.ones(300, 32)))


def test_the_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        time_code.time_code_bwd_cuda(torch.zeros(8, 32), torch.zeros(8, dtype=torch.int64), 16)


def test_the_launch_counter_is_registered_and_starts_at_zero():
    assert launch_counts.COUNTERS["time_code_bwd"] == (time_code, "LAUNCHES")
    assert "time_code_bwd" in launch_counts.KERNELS
    assert "time_code_bwd" not in launch_counts.FORWARD
    fresh = subprocess.run(
        [sys.executable, "-c", "from nersemble_tpu_torch.ops import launch_counts; "
                               "print(launch_counts.read()['time_code_bwd'])"],
        capture_output=True, text=True, check=True)
    assert fresh.stdout.strip() == "0"
    time_code.LAUNCHES = 5
    launch_counts.reset()
    assert launch_counts.read()["time_code_bwd"] == 0
