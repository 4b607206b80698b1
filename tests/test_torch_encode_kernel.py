"""The blended encode (kernels A3-fwd / A3-bwd): the port's plain version
against the JAX package on the CPU, the kernels against the plain version
on the card, and the routing.

CPU, against JAX (``_blended_core`` through ``hash_encode_blended``, and the
single grid's ``hash_encode``), inputs from a numpy seed, with the bounds of
tests/test_torch_train_encode.py. f32: rtol 1e-5 with an atol of 1e-5 of the
largest value. bf16: the output and the position and code gradients rtol
1e-4 (the same rounded terms summed in other orders); the table gradient
per entry within 2^-8 * k * sum|rows| for an entry reached by k rows, the
largest gap between an f32 accumulation rounded once (the port) and a bf16
accumulation (JAX's hashed levels, and its single grid's autodiff scatter),
computed from an f64 scatter of the rows; on the dense levels of the
blended encode, where both accumulate in f32, rtol 2^-7.

Card (marked ``cuda``; they skip without a CUDA device, deciding inside the
fixture): the kernels against the plain version within
``hash_encoding.MAX_ERR_REL`` / ``MEAN_ERR_REL`` for the outputs, residuals
and per-sample gradients (the residuals also bit for bit: they sum in
the plain version's order), the table gradient within one table-dtype ulp
plus the f32 error bound of its rows summed in two orders
(``compare_table_grads``); the backward twice, bit for bit; every row
width the port runs, the forward without residuals, no samples, and the
backward with its side stream against its parts run in turn. On the CPU
also the forward's combination of table runs (a binary counter) against
``_sum_tables``, bit for bit. JAX is imported only by the CPU parity
tests, so that the card, which has no JAX, collects this file:
``python -m pytest --noconftest -m cuda tests/test_torch_encode_kernel.py``.
"""

import numpy as np
import pytest
import torch

from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.ops import hash_encoding as the
from nersemble_tpu_torch.ops.quad_kernel import quad_build_plain

LEVELS = (6, 10, 4, 1.5)  # dense and 1024-row hashed levels (tests/test_ops.py)
SINGLE_LEVELS = (4, 10, 4, 2.0)  # the single grid's table: one table of 2 features


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's hash-encoding module (CPU parity tests only)."""
    pytest.importorskip("jax")
    from nersemble_tpu.ops import hash_encoding as jhe
    return jhe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tensor(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _inputs(lv, width, h, n_samples, seed):
    """A canonical [E, width] table, positions, a code [n, h] (contrast:
    values of both signs around 1) and an output gradient, from a numpy seed."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(lv.total_entries, width)).astype(np.float32)
    x = rng.uniform(size=(n_samples, 3)).astype(np.float32)
    code = (1.0 + rng.normal(size=(n_samples, h))).astype(np.float32)
    gbar = rng.normal(size=(n_samples, lv.n_levels * 2)).astype(np.float32)
    return table, x, code, gbar


def _row_mass(jhe, lv, x, code, gbar, width, fl):
    """Per quad-table element: (rows scattered into its entry, f64 sum of
    |row|), the rows being the analytic row gradient wy * u_q * code_h *
    gbar (code 1 for the single grid)."""
    import jax.numpy as jnp
    idx, wy, fx, fz = (np.asarray(a, np.float64)
                       for a in jhe.hash_grid_indices(jnp.asarray(x), lv))
    N, L = x.shape[0], lv.n_levels
    h = width // fl
    c = np.ones((N, h)) if code is None else code
    u = np.stack([(1 - fx) * (1 - fz), (1 - fx) * fz, fx * (1 - fz), fx * fz], -1)
    rows = (wy.reshape(N, 2, L)[:, :, :, None, None, None]
            * u[:, None, :, :, None, None] * c[:, None, None, None, :, None]
            * gbar.reshape(N, 1, L, 1, 1, fl))  # [N, 2, L, 4, H, fl]
    mass = np.zeros((lv.total_entries, 4 * width))
    count = np.zeros(lv.total_entries)
    np.add.at(mass, idx.astype(np.int64).reshape(-1),
              np.abs(rows).reshape(N * 2 * L, -1))
    np.add.at(count, idx.astype(np.int64).reshape(-1), 1)
    return count, mass


def _hold(jhe, lv, dtype, ours, theirs, x, code, gbar, width, fl, dense_f32):
    """``ours`` / ``theirs``: (out, d quad table, d x, d code or None)."""
    names = ("out", "d_table", "d_x", "d_code")
    if dtype == "float32":
        for name, a, b in zip(names, ours, theirs):
            if b is None:
                continue
            b = np.asarray(b, np.float32)
            assert np.abs(b).max() > 0, name
            np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max(), err_msg=name)
        return
    for i in (0, 2, 3):
        if theirs[i] is None:
            continue
        b = np.asarray(theirs[i], np.float32)
        np.testing.assert_allclose(ours[i].detach().float().numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=names[i])
    d_ours = ours[1].float().numpy()
    d_theirs = np.asarray(theirs[1], np.float32)
    count, mass = _row_mass(jhe, lv, x, code, gbar, width, fl)
    bf16_part = slice(jhe.dense_split(lv)[1] if dense_f32 else 0, None)
    if dense_f32:
        dense = slice(None, bf16_part.start)
        np.testing.assert_allclose(d_ours[dense], d_theirs[dense], rtol=2 ** -7,
                                   atol=1e-6 * np.abs(d_theirs).max())
    assert count[bf16_part].max() >= 4  # entries that sum several rows
    bound = 2.0 ** -8 * np.maximum(count[bf16_part], 1)[:, None] * mass[bf16_part]
    diff = np.abs(d_ours[bf16_part] - d_theirs[bf16_part])
    assert (diff <= bound + 1e-30).all(), float((diff / (bound + 1e-30)).max())


def _blended_case(jhe, dtype, h, n_samples, seed, columns=None):
    """hash_encode_blended in both packages on the quad table of a canonical
    [E, 2h] table, or of its logical tables ``columns`` (a rank's slice under
    the feature-sharded layout) with their columns of the code."""
    import jax
    import jax.numpy as jnp
    lv, ours_lv = jhe.HashGridLevels.create(*LEVELS), the.HashGridLevels.create(*LEVELS)
    table, x, code, gbar = _inputs(lv, 2 * h, h, n_samples, seed)
    if columns is not None:
        table = table[:, 2 * columns.start:2 * columns.stop]
        code = np.ascontiguousarray(code[:, columns])
    width = table.shape[1]
    quad = np.asarray(quad_build_plain(_tensor(table), ours_lv))
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda q, xx, c: jhe.hash_encode_blended(q, xx, c, lv, 2),
                       jnp.asarray(quad).astype(jdt), jnp.asarray(x), jnp.asarray(code))
    theirs = (out,) + vjp(jnp.asarray(gbar))
    qt = _tensor(quad, getattr(torch, dtype)).requires_grad_(True)
    xt, ct = _tensor(x).requires_grad_(True), _tensor(code).requires_grad_(True)
    ours_out = the.hash_encode_blended(qt, xt, ct, ours_lv, 2)
    ours_out.backward(_tensor(gbar))
    ours = (ours_out, qt.grad, xt.grad, ct.grad)
    _hold(jhe, lv, dtype, ours, (theirs[0], theirs[1], theirs[2], theirs[3]),
          x, code, gbar, width, 2, dense_f32=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_blended_encode_matches_jax_at_16_tables(jax_ref, dtype):
    """W4 = 128: 16 logical tables of 2 features (the dynamic quality run's
    row width)."""
    _blended_case(jax_ref, dtype, 16, 3000 if dtype == "bfloat16" else 600, seed=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_blended_encode_matches_jax_on_a_column_slice(jax_ref, dtype):
    """A rank's columns under the feature-sharded layout: logical tables 8-11
    of 16 (W4 = 32, one of four ranks), the code's columns 8-11."""
    _blended_case(jax_ref, dtype, 16, 3000 if dtype == "bfloat16" else 600,
                  seed=4, columns=slice(8, 12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_single_grid_encode_matches_jax(jax_ref, dtype):
    """W4 = 8: the single grid's one table of 2 features through
    ``hash_encode`` (JAX: autodiff through its gather)."""
    import jax
    import jax.numpy as jnp
    jhe = jax_ref
    lv = jhe.HashGridLevels.create(*SINGLE_LEVELS)
    ours_lv = the.HashGridLevels.create(*SINGLE_LEVELS)
    table, x, _, gbar = _inputs(lv, 2, 1, 3000, seed=5)
    quad = np.asarray(quad_build_plain(_tensor(table), ours_lv))
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda q, xx: jhe.hash_encode(q, xx, lv),
                       jnp.asarray(quad).astype(jdt), jnp.asarray(x))
    theirs = (out,) + vjp(jnp.asarray(gbar)) + (None,)
    qt = _tensor(quad, getattr(torch, dtype)).requires_grad_(True)
    xt = _tensor(x).requires_grad_(True)
    ours_out = the.hash_encode(qt, xt, ours_lv)
    ours_out.backward(_tensor(gbar))
    _hold(jhe, lv, dtype, (ours_out, qt.grad, xt.grad, None), theirs, x, None,
          gbar, 2, 2, dense_f32=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("column", [0, 1])
def test_plain_single_grid_column_matches_jax(jax_ref, dtype, column):
    """One rank's column of the single grid under the feature-sharded
    layout ([E, 1] of the [E, 2] table; W4 = 4): the plain quad build and
    fold against the JAX package's (``_quad_fwd_xla``, ``_quad_bwd_xla``)
    bit for bit, and ``hash_encode`` of its quad table with the column's
    output gradient, forward and gradients, at the bounds of
    test_plain_single_grid_encode_matches_jax."""
    import jax
    import jax.numpy as jnp
    from nersemble_tpu_torch.ops.quad_kernel import quad_fold_plain
    jhe = jax_ref
    lv = jhe.HashGridLevels.create(*SINGLE_LEVELS)
    ours_lv = the.HashGridLevels.create(*SINGLE_LEVELS)
    table, x, _, gbar = _inputs(lv, 2, 1, 3000, seed=5)
    col = np.ascontiguousarray(table[:, column:column + 1])
    g_col = np.ascontiguousarray(gbar.reshape(3000, lv.n_levels, 2)[:, :, column])
    dt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    quad = quad_build_plain(_tensor(col).to(dt), ours_lv)
    assert np.array_equal(quad.float().numpy(), np.asarray(
        jhe._quad_fwd_xla(jnp.asarray(col).astype(jdt), lv).astype(jnp.float32)))
    g = np.random.default_rng(6).normal(size=(lv.total_entries, 4)).astype(np.float32)
    assert np.array_equal(quad_fold_plain(_tensor(g).to(dt), ours_lv).float().numpy(),
                          np.asarray(jhe._quad_bwd_xla(jnp.asarray(g).astype(jdt), lv)
                                     .astype(jnp.float32)))
    quad = quad.float().numpy()
    out, vjp = jax.vjp(lambda q, xx: jhe.hash_encode(q, xx, lv),
                       jnp.asarray(quad).astype(jdt), jnp.asarray(x))
    theirs = (out,) + vjp(jnp.asarray(g_col)) + (None,)
    qt = _tensor(quad, dt).requires_grad_(True)
    xt = _tensor(x).requires_grad_(True)
    ours_out = the.hash_encode(qt, xt, ours_lv)
    ours_out.backward(_tensor(g_col))
    _hold(jhe, lv, dtype, (ours_out, qt.grad, xt.grad, None), theirs, x, None,
          g_col, 1, 1, dense_f32=False)


# (quad table columns, features per table, with a code): every width the port
# runs: the flagship's 32 tables, the dynamic quality run's 16, the tiny
# configuration's 8, the feature-sharded slices of 2, 4 and 8 ranks, the
# single grid and its one-feature column of 2 ranks; and table counts that
# are not a power of two or past 32 (12, 24 and 64 tables through
# --n-hash-encodings)
PORT_WIDTHS = [(256, 2, True), (128, 2, True), (64, 2, True), (32, 2, True),
               (16, 2, True), (8, 2, False), (4, 1, False), (96, 2, True),
               (192, 2, True), (512, 2, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w4,fl,with_code", PORT_WIDTHS)
def test_kernel_takes_every_width_the_port_runs(dtype, w4, fl, with_code):
    quad = torch.zeros(64, w4, dtype=dtype)
    code = torch.zeros(5, w4 // 4 // fl) if with_code else None
    assert the._kernel_shape(quad, code, 4, fl) == (w4 // 4, w4 // 4 // fl)


def _binary_counter_sum(runs):
    """A3-fwd's combination of per-run f32 sums (be_cg_runs): push each run,
    merging with the block of the same size before it, then combine the
    blocks left over, the smallest (rightmost) first."""
    stack = {}
    for r, run in enumerate(runs):
        b = 0
        while (r >> b) & 1:
            run = np.float32(stack.pop(b) + run)
            b += 1
        stack[b] = run
    total = None
    for b in sorted(stack):
        total = stack[b] if total is None else np.float32(stack[b] + total)
    return total


@pytest.mark.parametrize("n_runs", [1, 2, 3, 5, 6, 7, 8, 11, 16, 24, 32])
def test_binary_counter_is_the_plain_table_order(n_runs):
    """The forward kernel sums a CG slot's tables in runs of 8 elements and
    combines the runs as a binary counter; that must be ``_sum_tables``'
    level-by-level tree, bit for bit, for every run count it meets (W = 8
    to 256 elements per quarter)."""
    rng = np.random.default_rng(n_runs)
    fl, per_run = 2, 4  # 4 tables of 2 features per 8-element run
    terms = (rng.normal(size=(n_runs * per_run, fl))
             * 10.0 ** rng.integers(-6, 6, size=(n_runs * per_run, 1))).astype(np.float32)
    ours = []
    for f in range(fl):
        runs = []
        for r in range(n_runs):
            acc = np.float32(0.0)
            for t in terms[r * per_run:(r + 1) * per_run, f]:
                acc = np.float32(acc + t)
            runs.append(acc)
        ours.append(_binary_counter_sum(runs))
    plain = the._sum_tables(torch.from_numpy(terms), n_runs * 8).numpy()
    assert np.array_equal(np.array(ours, np.float32).view(np.uint32), plain.view(np.uint32))


@pytest.mark.parametrize("w4,fl,dtype", [(2048, 2, torch.bfloat16), (12, 1, torch.bfloat16),
                                         (48, 3, torch.bfloat16), (64, 2, torch.float16),
                                         (4, 1, torch.bfloat16)])
def test_kernel_refuses_a_shape_it_lacks_and_names_it(w4, fl, dtype):
    """Blended (with a code): rows of 4 elements (one table of one feature)
    only without a code."""
    quad = torch.zeros(64, w4, dtype=dtype)
    code = torch.zeros(5, w4 // 4 // fl)
    with pytest.raises(ValueError, match=rf"\(64, {w4}\)"):
        the._kernel_shape(quad, code, 4, fl)


@pytest.mark.parametrize("w4,fl", [(12, 3), (4, 2), (16, 2), (8, 1)])
def test_kernel_refuses_a_single_grid_shape_it_lacks(w4, fl):
    """Without a code the kernels take one table of 1, 2, 4 or 8 features:
    not 3 features, not a row that is not one whole table."""
    with pytest.raises(ValueError, match=rf"\(64, {w4}\)"):
        the._kernel_shape(torch.zeros(64, w4, dtype=torch.bfloat16), None, 4, fl)


def test_cpu_trainer_launches_no_encode_kernel(monkeypatch):
    """On CPU tensors the step's encode runs the plain version, both ways,
    and never reaches a kernel wrapper."""
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = the.blended_encode_fwd_plain, the.blended_encode_bwd_plain

    def fwd(*a, **k):
        calls["fwd"] += 1
        return plain_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return plain_bwd(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the CPU path")

    monkeypatch.setattr(the, "blended_encode_fwd_plain", fwd)
    monkeypatch.setattr(the, "blended_encode_bwd_plain", bwd)
    monkeypatch.setattr(the, "blended_encode_fwd_cuda", refuse)
    monkeypatch.setattr(the, "blended_encode_bwd_cuda", refuse)
    before = (the.LAUNCHES, the.BWD_LAUNCHES)
    trainer = NeRSembleTrainer(flagship_model_config(tiny=True), n_rays=64,
                               device="cpu")
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
    batch = {"origins": torch.tensor([[-8.0, 0.0, 0.0]]).repeat(64, 1),
             "directions": _tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                                   torch.float32),
             "timesteps": _tensor(rng.integers(0, 8, 64)),
             "rgb": _tensor(rng.uniform(size=(64, 3)), torch.float32),
             "alpha": _tensor(rng.uniform(size=64), torch.float32),
             "depth": _tensor(rng.uniform(7.5, 9.5, 64), torch.float32)}
    total, _ = trainer.run_step(0, batch)
    assert np.isfinite(float(total))
    assert calls["fwd"] > 0 and calls["bwd"] > 0
    assert (the.LAUNCHES, the.BWD_LAUNCHES) == before


# ---- on the card -------------------------------------------------------------

# (levels, canonical width, features per table, with a code, table dtype)
CARD_CASES = [
    (LEVELS, 64, 2, True, torch.bfloat16),   # the flagship's row width
    (LEVELS, 32, 2, True, torch.bfloat16),   # 16 tables
    (LEVELS, 32, 2, True, torch.float32),
    (LEVELS, 8, 2, True, torch.bfloat16),    # a feature-sharded slice
    (SINGLE_LEVELS, 2, 2, False, torch.bfloat16),
    (SINGLE_LEVELS, 2, 2, False, torch.float32),
    (LEVELS, 24, 2, True, torch.bfloat16),   # 12 tables: not a power of two
    (LEVELS, 128, 2, True, torch.float32),   # 64 tables
    (SINGLE_LEVELS, 1, 1, False, torch.bfloat16),  # one rank's column of two
    (SINGLE_LEVELS, 1, 1, False, torch.float32),
]


def _card_case(device, levels, width, fl, with_code, dtype, n_samples, seed,
               hot=False):
    lv = the.HashGridLevels.create(*levels)
    rng = np.random.default_rng(seed)
    table = _tensor(rng.normal(size=(lv.total_entries, width)), torch.float32)
    x = rng.uniform(size=(n_samples, 3))
    if hot:  # a third of the samples at one point: entries reached thousands of times
        x[: n_samples // 3] = 0.3
    x = _tensor(x, torch.float32).to(device)
    quad = quad_build_plain(table, lv).to(dtype).to(device)
    code = _tensor(1.0 + rng.normal(size=(n_samples, width // fl)),
                   torch.float32).to(device) if with_code else None
    gbar = _tensor(rng.normal(size=(n_samples, lv.n_levels * fl)),
                   torch.float32).to(device)
    entry_idx, wy, fx, fz = the.hash_grid_indices(x, lv)
    args = (quad, code, wy, fx.contiguous(), fz.contiguous(), entry_idx,
            lv.n_levels, fl, True)
    return lv, args, gbar


def _hold_kernels(args, gbar):
    """Both kernels once against the plain version (one launch each)."""
    quad, code, wy, fx, fz, entry_idx = args[:6]
    before = (the.LAUNCHES, the.BWD_LAUNCHES)
    ours = the.blended_encode_fwd_cuda(*args)
    refs = the.blended_encode_fwd_plain(*args)
    the.compare_to_plain(ours, refs, ("out", "CG", "BH"))
    # the residuals sum in the plain version's order: bit for bit
    assert torch.equal(ours[1], refs[1])
    assert (ours[2] is None and refs[2] is None) or torch.equal(ours[2], refs[2])
    g_ours = the.blended_encode_bwd_cuda(gbar, *ours[1:], code, entry_idx, wy, fx, fz,
                                         tuple(quad.shape))
    g_refs = the.blended_encode_bwd_plain(gbar, *refs[1:], code, entry_idx, wy, fx,
                                          fz, tuple(quad.shape))
    torch.cuda.synchronize()
    assert (the.LAUNCHES, the.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    the.compare_to_plain(g_ours[1:], g_refs[1:], ("d_code", "d_wy", "d_fx", "d_fz"))
    the.compare_table_grads(g_ours[0], g_refs[0], *the.table_grad_mass(
        gbar, code, entry_idx, wy, fx, fz, tuple(quad.shape), quad.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("n_samples", [1, 37, 4096])
def test_kernels_match_plain(cuda, case, n_samples):
    _, args, gbar = _card_case(cuda, *case, n_samples, seed=n_samples,
                               hot=n_samples > 100)
    _hold_kernels(args, gbar)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w4,fl,with_code", PORT_WIDTHS)
def test_kernels_match_plain_at_every_port_width(cuda, dtype, w4, fl, with_code):
    """Every row width the port runs, table counts that are not a power of
    two among them, at 301 samples: no multiple of a forward stage's
    samples (1 to 32 at these widths)."""
    levels = LEVELS if with_code else SINGLE_LEVELS
    _, args, gbar = _card_case(cuda, levels, w4 // 4, fl, with_code, dtype, 301,
                               seed=w4, hot=True)
    _hold_kernels(args, gbar)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CARD_CASES[0], CARD_CASES[4], CARD_CASES[6],
                                  CARD_CASES[7], CARD_CASES[8]])
def test_forward_without_residuals(cuda, case):
    """keep_residuals=False (the render): no CG or BH, the same output bit
    for bit."""
    _, args, _ = _card_case(cuda, *case, 4097, seed=5, hot=True)
    kept = the.blended_encode_fwd_cuda(*args)
    out, CG, BH = the.blended_encode_fwd_cuda(*args[:-1], False)
    assert CG is None and BH is None
    assert torch.equal(out, kept[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CARD_CASES[0], CARD_CASES[4], CARD_CASES[8]])
def test_kernels_take_no_samples(cuda, case):
    lv, args, gbar = _card_case(cuda, *case, 0, seed=1)
    quad, code, wy, fx, fz, entry_idx = args[:6]
    out, CG, BH = the.blended_encode_fwd_cuda(*args)
    assert out.shape == (0, lv.n_levels * case[2]) and CG.shape[0] == 0
    grads = the.blended_encode_bwd_cuda(gbar, CG, BH, code, entry_idx, wy, fx, fz,
                                        tuple(quad.shape))
    torch.cuda.synchronize()
    assert grads[0].shape == quad.shape and int(torch.count_nonzero(grads[0])) == 0
    assert all(g is None or g.shape[0] == 0 for g in grads[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CARD_CASES[0], CARD_CASES[4], CARD_CASES[8],
                                  CARD_CASES[9]])
def test_kernel_backward_is_bit_for_bit(cuda, case):
    _, args, gbar = _card_case(cuda, *case, 20000, seed=7, hot=True)
    quad, code, wy, fx, fz, entry_idx = args[:6]
    _, CG, BH = the.blended_encode_fwd_cuda(*args)
    runs = [the.blended_encode_bwd_cuda(gbar, CG, BH, code, entry_idx, wy, fx, fz,
                                        tuple(quad.shape)) for _ in range(2)]
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CARD_CASES[0], CARD_CASES[4]])
def test_kernel_backward_side_stream_is_bit_for_bit(cuda, case):
    """The hot-entry case with the table gradient zeroed on the side stream
    while the sort and the per-sample kernel run (the wrapper) against the
    same parts one after another on the current stream."""
    _, args, gbar = _card_case(cuda, *case, 20000, seed=7, hot=True)
    quad, code, wy, fx, fz, entry_idx = args[:6]
    _, CG, BH = the.blended_encode_fwd_cuda(*args)
    shape = tuple(quad.shape)
    ours = the.blended_encode_bwd_cuda(gbar, CG, BH, code, entry_idx, wy, fx, fz, shape)
    plan = the.BlendedBwdPlan(gbar, CG, BH, code, entry_idx, wy, fx, fz, shape)
    plan.zero(torch.cuda.current_stream())
    plan.sort()
    plan.sample()
    plan.chunks()
    plan.spans()
    torch.cuda.synchronize()
    for a, b in zip(ours, plan.outputs()):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_routes_to_the_kernels(cuda):
    lv, args, gbar = _card_case(cuda, *CARD_CASES[0], 512, seed=11)
    quad = args[0].detach().clone().requires_grad_(True)
    before = (the.LAUNCHES, the.BWD_LAUNCHES)
    x = torch.rand(512, 3, device=cuda, requires_grad=True)
    code = torch.rand(512, 32, device=cuda, requires_grad=True)
    the.hash_encode_blended(quad, x, code, lv, 2).backward(gbar)
    torch.cuda.synchronize()
    assert (the.LAUNCHES, the.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert quad.grad.dtype == quad.dtype and x.grad is not None and code.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_feature_columns_are_the_whole_tables_bit_for_bit(cuda, dtype):
    """The single grid's [E, 2] table and its two [E, 1] columns (what each
    of two ranks holds under the feature-sharded layout): A3-fwd on a column
    gives that feature of the whole table's output, and its CG, bit for
    bit."""
    lv, args, _ = _card_case(cuda, SINGLE_LEVELS, 2, 2, False, dtype, 4097, seed=3,
                             hot=True)
    quad, _, wy, fx, fz, entry_idx = args[:6]
    whole = the.blended_encode_fwd_cuda(*args)
    for f in range(2):
        column = quad.view(-1, 4, 2)[:, :, f].contiguous()
        out, CG, _ = the.blended_encode_fwd_cuda(column, None, wy, fx, fz, entry_idx,
                                                 lv.n_levels, 1, True)
        assert torch.equal(out, whole[0].view(-1, lv.n_levels, 2)[:, :, f])
        assert torch.equal(CG[..., 0], whole[1][..., f])


def _column_edge_case(device, dtype, n_samples, seed):
    """A one-feature column (SINGLE_LEVELS: 5120 rows, reduce blocks of
    2048) whose entry indices sit on both sides of the blocks' edges, in
    runs longer than a chunk, over more than two pass blocks of positions;
    seeded weights, table and output gradient."""
    lv = the.HashGridLevels.create(*SINGLE_LEVELS)
    rng = np.random.default_rng(seed)
    L, E = lv.n_levels, lv.total_entries
    edges = np.array(sorted({k for b in range(0, E, the.COLUMN_ROWS)
                             for k in (b - 1, b) if 0 <= k < E} | {E - 1}))
    idx = edges[rng.integers(0, edges.size, size=(n_samples, 2 * L))]
    idx[rng.uniform(size=idx.shape) < 0.3] = edges[-2]  # one key in runs across chunks
    quad = _tensor(rng.normal(size=(E, 4)), torch.float32).to(dtype).to(device)
    wy = _tensor(rng.uniform(size=(n_samples, 2 * L)), torch.float32).to(device)
    fx = _tensor(rng.uniform(size=(n_samples, L)), torch.float32).to(device)
    fz = _tensor(rng.uniform(size=(n_samples, L)), torch.float32).to(device)
    gbar = _tensor(rng.normal(size=(n_samples, L)), torch.float32).to(device)
    args = (quad, None, wy, fx, fz, _tensor(idx).to(device), L, 1, True)
    return lv, args, gbar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("inputs,n_samples", [("hot", 301), ("hot", 20000),
                                              ("edges", 2100)])
def test_column_backward_is_the_mirror_bit_for_bit(cuda, dtype, inputs, n_samples):
    """A3-bwd on quad rows of 4 elements: the table gradient equals the
    CPU mirror of its order (``column_table_grad_plain``) bit for bit: hot
    entries, keys at the reduce blocks' edges, several pass blocks, and 301
    samples (2408 positions, no multiple of 64); the per-sample gradients
    against the plain version."""
    if inputs == "hot":
        _, args, gbar = _card_case(cuda, SINGLE_LEVELS, 1, 1, False, dtype, n_samples,
                                   seed=n_samples, hot=True)
    else:
        _, args, gbar = _column_edge_case(cuda, dtype, n_samples, seed=12)
    quad, _, wy, fx, fz, entry_idx = args[:6]
    shape = tuple(quad.shape)
    _, CG, _ = the.blended_encode_fwd_cuda(*args)
    ours = the.blended_encode_bwd_cuda(gbar, CG, None, None, entry_idx, wy, fx, fz, shape)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (gbar, entry_idx, wy, fx, fz)]
    mirror = the.column_table_grad_plain(*cpu, shape, dtype)
    assert torch.equal(ours[0].cpu(), mirror)
    refs = the.blended_encode_bwd_plain(gbar, CG, None, None, entry_idx, wy, fx, fz, shape)
    the.compare_to_plain(ours[2:], refs[2:], ("d_wy", "d_fx", "d_fz"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_column_backward_parts_are_the_wrapper(cuda, dtype):
    """The column plan's parts run one after another (``sample``,
    ``order``, ``reduce``) give the wrapper's outputs bit for bit; each
    part runs again on the same scratch with the same result."""
    _, args, gbar = _card_case(cuda, SINGLE_LEVELS, 1, 1, False, dtype, 20000, seed=7,
                               hot=True)
    quad, _, wy, fx, fz, entry_idx = args[:6]
    _, CG, _ = the.blended_encode_fwd_cuda(*args)
    shape = tuple(quad.shape)
    ours = the.blended_encode_bwd_cuda(gbar, CG, None, None, entry_idx, wy, fx, fz, shape)
    plan = the.BlendedBwdPlan(gbar, CG, None, None, entry_idx, wy, fx, fz, shape)
    assert list(plan.parts()) == ["sample", "order", "reduce"]
    for _ in range(2):
        for part in plan.parts().values():
            part()
        torch.cuda.synchronize()
        for a, b in zip(ours, plan.outputs()):
            assert (a is None and b is None) or torch.equal(a, b)
