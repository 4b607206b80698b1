"""The order of A3-bwd's table gradient on quad rows of 4 elements (the
single grid's one-feature column), on the CPU.

The kernels (csrc/blended_encode.cu ``be_col_*``) order the positions with
their own least-significant-digit counting sort and sum each row's
contributions in that order. ``hash_encoding.column_*`` repeats that
arithmetic in plain PyTorch: the digits of each pass, each position's slot
(its digit's start, the counts of that digit in earlier blocks, its rank
among equal digits in its block), the reduce blocks' ranges and the
64-position piece cuts. Here the mirror is held to ``torch.sort(stable=True)``
exactly, on seeded keys with a hot key across many chunks and blocks, runs
across bucket and block edges, empty buckets, the single grid's real level
offsets and position counts that are not a multiple of 64. Its sums are
held to an independent per-row loop bit for bit, to the plain backward
(``blended_encode_bwd_plain``) within ``compare_table_grads``' bounds and
to the JAX package's ``_blended_vjp_bwd`` within the bounds of
tests/test_torch_encode_kernel.py's single-grid column test. The card
tests hold the kernels to the mirror bit for bit
(tests/test_torch_encode_kernel.py, marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from nersemble_tpu_torch.ops import hash_encoding as the
from nersemble_tpu_torch.ops.quad_kernel import quad_build_plain
from tests.test_torch_encode_kernel import SINGLE_LEVELS, _hold, _inputs, _tensor

SINGLE_GRID_ROWS = 6184960  # the single grid at the train CLI's defaults


def _single_grid_levels():
    """The single grid's layout at the train CLI's defaults: 16 levels,
    2^19 rows, resolution 16 to 2048 (every level offset a multiple of
    2048 rows)."""
    growth = float(np.exp((np.log(2048) - np.log(16)) / 15))
    return the.HashGridLevels.create(16, 19, 16, growth)


def _hot_keys(rng):
    """30,011 keys below 5000: 20,000 of them on key 77, a run across
    hundreds of chunks and every pass block."""
    keys = rng.integers(0, 5000, size=30011)
    keys[rng.permutation(30011)[:20000]] = 77
    return keys, 5000


def _edge_keys(rng):
    """Keys on both sides of bucket edges (2047 / 2048, 4095 / 4096, ...)
    in runs of random length, over four pass blocks plus 37 positions."""
    edges = np.array([2047, 2048, 4095, 4096, 6143, 6144, 8191])
    keys = edges[rng.integers(0, edges.size, size=4 * the.COLUMN_BLOCK + 37)]
    return keys, 8192


def _empty_bucket_keys(rng):
    """Keys in buckets 0, 3 and 7 of eight: empty buckets between them."""
    keys = rng.integers(0, 2048, size=5000) + 2048 * rng.choice([0, 3, 7], size=5000)
    return keys, 8 * 2048


def _single_grid_keys(rng):
    """The single grid's entry indices at its real level offsets for 2000
    samples: half uniform, a quarter in the centre block, a quarter at the
    origin (hot corners on every level)."""
    x = rng.uniform(size=(2000, 3)).astype(np.float32)
    x[1000:1500] = 0.375 + 0.25 * x[1000:1500]
    x[1500:] = 0.0
    levels = _single_grid_levels()
    entry_idx = the.hash_grid_indices(torch.from_numpy(x), levels)[0]
    return entry_idx.reshape(-1).numpy(), levels.total_entries


def _ragged_keys(rng):
    """1013 positions (no multiple of 64) over a table of 3000 rows."""
    return rng.integers(0, 3000, size=1013), 3000


KEY_CASES = {"hot": _hot_keys, "bucket edges": _edge_keys,
             "empty buckets": _empty_bucket_keys, "single grid": _single_grid_keys,
             "ragged": _ragged_keys}


def _keys(case, seed=0):
    keys, n_rows = KEY_CASES[case](np.random.default_rng(seed))
    return torch.from_numpy(np.asarray(keys, np.int64)), n_rows


@pytest.mark.parametrize("n_rows,expected", [
    (SINGLE_GRID_ROWS, [(0, 8, 256), (8, 8, 256), (16, 7, 95)]),
    (1, [(0, 1, 1)]),
    (2048, [(0, 8, 256), (8, 3, 8)]),
    (2049, [(0, 8, 256), (8, 4, 9)]),
    (2 ** 31 - 1, [(0, 8, 256), (8, 8, 256), (16, 8, 256), (24, 7, 128)])])
def test_column_passes_follow_the_kernel_plan(n_rows, expected):
    """8 bits each over the bits of the largest key, the last pass what is
    left; a digit takes only the values keys below n_rows give (csrc
    be_col_plan)."""
    assert the.column_passes(n_rows) == expected


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_column_order_is_the_stable_sort(case):
    keys, n_rows = _keys(case)
    perm, skey = the.column_order_plain(keys, n_rows)
    ref_key, ref_perm = torch.sort(keys, stable=True)
    assert torch.equal(perm, ref_perm) and torch.equal(skey, ref_key)


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_column_pass_slots_are_stable_permutations(case):
    """Each pass sends the positions to distinct slots, in digit order, and
    keeps the order of equal digits."""
    keys, n_rows = _keys(case)
    for lo, width, values in the.column_passes(n_rows):
        slot = the.column_pass_slots(keys, lo, width, values)
        assert torch.equal(torch.sort(slot)[0], torch.arange(keys.numel()))
        digit = (keys >> lo) & ((1 << width) - 1)
        assert int(digit.max()) < values
        moved = torch.empty_like(digit)
        moved[slot] = digit
        assert bool((moved[1:] >= moved[:-1]).all())
        assert torch.equal(torch.argsort(slot), torch.sort(digit, stable=True)[1])
        keys = torch.empty_like(keys).index_put_((slot,), keys)


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_column_offsets_and_piece_cuts_match_the_sort(case):
    """Each position's global sorted offset, and the pieces: cut at every
    new key and every multiple of 64 sorted positions."""
    keys, n_rows = _keys(case)
    perm, skey = the.column_order_plain(keys, n_rows)
    ref_key, ref_perm = torch.sort(keys, stable=True)
    offset = torch.empty_like(perm)
    offset[perm] = torch.arange(perm.numel())
    ref_offset = torch.empty_like(ref_perm)
    ref_offset[ref_perm] = torch.arange(ref_perm.numel())
    assert torch.equal(offset, ref_offset)
    at = np.arange(keys.numel())
    rk = ref_key.numpy()
    ref_cuts = (at % 64 == 0) | np.concatenate([[True], rk[1:] != rk[:-1]])
    assert np.array_equal(the.column_pieces(skey).numpy(), ref_cuts)
    if case == "hot":  # the hot run crosses hundreds of chunks
        assert int((skey == 77).sum()) // 64 > 300


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_column_ranges_are_the_bucket_starts(case):
    """The reduce blocks' ranges of sorted positions: the cumulative counts
    of the keys below each block's first row."""
    keys, n_rows = _keys(case)
    _, skey = the.column_order_plain(keys, n_rows)
    blocks = -(-n_rows // the.COLUMN_ROWS)
    counts = torch.bincount(keys // the.COLUMN_ROWS, minlength=blocks)
    ref = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)])
    assert torch.equal(the.column_ranges(skey, n_rows), ref)
    if case == "empty buckets":
        assert int((counts == 0).sum()) == 5


def _column_inputs(dtype, n_samples=3000, seed=8, hot=True):
    """One rank's column of the single grid (SINGLE_LEVELS): CG from the
    plain forward of a seeded [E, 1] column, indices, weights and an output
    gradient."""
    lv = the.HashGridLevels.create(*SINGLE_LEVELS)
    table, x, _, gbar = _inputs(lv, 2, 1, n_samples, seed)
    if hot:
        x[: n_samples // 3] = 0.3
    quad = quad_build_plain(_tensor(np.ascontiguousarray(table[:, :1])), lv).to(dtype)
    g = _tensor(np.ascontiguousarray(gbar.reshape(n_samples, lv.n_levels, 2)[:, :, 0]))
    entry_idx, wy, fx, fz = the.hash_grid_indices(_tensor(x), lv)
    _, CG, _ = the.blended_encode_fwd_plain(quad, None, wy, fx, fz, entry_idx,
                                            lv.n_levels, 1, True)
    return lv, x, quad, CG, g, entry_idx, wy, fx.contiguous(), fz.contiguous()


def _loop_sum(fac, keys, n_rows, dtype):
    """Per row in plain Python: its rows in position order at their offsets
    in the stable sort, cut at multiples of 64, each piece summed from zero
    in f32, the pieces added in order."""
    order = np.argsort(keys, kind="stable")
    offset = np.empty_like(order)
    offset[order] = np.arange(order.size)
    out = torch.zeros(n_rows, fac.shape[1], dtype=dtype)
    for key in np.unique(keys):
        where = np.nonzero(keys == key)[0]  # position order
        total, piece = None, np.zeros(fac.shape[1], np.float32)
        for k, p in enumerate(where):
            if k > 0 and offset[p] % 64 == 0:
                total = piece if total is None else np.float32(total + piece)
                piece = np.zeros(fac.shape[1], np.float32)
            piece = np.float32(piece + fac[p])
        total = piece if total is None else np.float32(total + piece)
        out[int(key)] = torch.from_numpy(total).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_column_mirror_sums_each_row_piece_by_piece(dtype):
    lv, _, quad, CG, g, entry_idx, wy, fx, fz = _column_inputs(dtype, n_samples=600)
    shape = tuple(quad.shape)
    ours = the.column_table_grad_plain(g, entry_idx, wy, fx, fz, shape, dtype)
    fac = the._row_gradients(g, None, wy, fx, fz, dtype).reshape(-1, 4).float().numpy()
    keys = entry_idx.reshape(-1).numpy()
    assert np.bincount(keys).max() > 64  # rows summed in several pieces
    assert torch.equal(ours, _loop_sum(fac, keys, shape[0], dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_column_mirror_sum_matches_plain_backward(dtype):
    """Against ``blended_encode_bwd_plain`` (index_add_ in its own order):
    within one table-dtype ulp plus the f32 reordering bound per entry."""
    _, _, quad, CG, g, entry_idx, wy, fx, fz = _column_inputs(dtype)
    shape = tuple(quad.shape)
    ours = the.column_table_grad_plain(g, entry_idx, wy, fx, fz, shape, dtype)
    ref = the.blended_encode_bwd_plain(g, CG, None, None, entry_idx, wy, fx, fz, shape)[0]
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    res = the.compare_table_grads(ours, ref, *the.table_grad_mass(
        g, None, entry_idx, wy, fx, fz, shape, dtype))
    assert res["entries"] == ref.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_mirror_sum_matches_jax(dtype):
    """Against the JAX package's ``_blended_vjp_bwd`` (through
    ``_blended_vjp_fwd``'s residuals; the single grid's column as one table
    of one feature with a unit code), at the bounds of
    test_plain_single_grid_column_matches_jax."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from nersemble_tpu.ops import hash_encoding as jhe
    dt = getattr(torch, dtype)
    lv, x, quad, _, g, entry_idx, wy, fx, fz = _column_inputs(dt)
    jlv = jhe.HashGridLevels.create(*SINGLE_LEVELS)
    L = jlv.n_levels
    jidx, jwy, jfx, jfz = jhe.hash_grid_indices(jnp.asarray(x), jlv)
    _, residuals = jhe._blended_vjp_fwd(
        jnp.asarray(quad.float().numpy()).astype(jnp.dtype(dtype)),
        jnp.ones((x.shape[0], 1), jnp.float32), jidx, jwy, jfx, jfz, L, 1,
        jhe.dense_split(jlv))
    theirs = jhe._blended_vjp_bwd(L, 1, jhe.dense_split(jlv), residuals,
                                  jnp.asarray(g.numpy()))[0]
    ours = the.column_table_grad_plain(g, entry_idx, wy, fx, fz, tuple(quad.shape), dt)
    _hold(jhe, jlv, dtype, (None, ours, None, None), (None, theirs, None, None), x,
          None, g.numpy(), 1, 1, dense_f32=False)
