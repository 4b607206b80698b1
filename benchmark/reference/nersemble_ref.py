"""Plain float32 reference of one NeRSemble training step, in PyTorch.

Written from the model's description, not from the port: the occupancy
grid's EMA update from seeded probes, the occupancy march with a per-ray
jitter, the slot-major compaction to the sample budget, the per-timestep
codes, the SE(3) warp (windowed positional
encoding, skip-connection MLP stem, exponential map), the hash encoding
(one grid, or an ensemble of grids blended by the time code) read by
trilinear interpolation straight from the canonical table, the density
and colour MLPs, alpha compositing over white, the six losses, autograd,
and Adam over three groups with step learning rates.

The table layout is the model's checkpoint layout: level ``l`` owns rows
``[offset_l, offset_l + size_l)``; a dense level indexes ``y + SX*x + SZ*z``
and a hashed one ``(y*P0 + x*SX + z*SZ) mod 2^M``; the x+1 and z+1
neighbours of a vertex sit a fixed stride further, wrapped inside the
level.

Everything runs in float32 with TF32 off. ``quant`` rounds the operands
that the configuration stores or computes in its compute dtype (the
table, the MLPs' inputs, weights and hidden activations), and the
gradients that flow back through them: the identity for the reference,
float8 for the control (``fake_fp8``). This module imports nothing of the
program.
"""

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

PRIMES = (2654435761, 805459861, 3674653429)
LAYOUT_BLOCK = 2048
ALIGN = 32
B1, B2 = 0.9, 0.999
ADAM_EPS = 1e-15
JITTER_STREAM, OCCUPANCY_STREAM = 0, 1
OCCUPANCY_EVERY = 16


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale per tensor that
    maps its largest magnitude to ``top``, and scaled back."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FakeFP8(torch.autograd.Function):
    """float8 e4m3 values forward and float8 e5m2 gradients backward, the
    common recipe of float8 training."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: float8 in the forward and the backward."""
    return _FakeFP8.apply(x)


# -- layout ---------------------------------------------------------------

def grid_layout(m: Dict) -> Dict:
    """Per-level scale, resolution, size, offset, strides of the model's
    table, and its row width W and features per grid F."""
    if m["use_hash_ensemble"]:
        hc = m["hash_ensemble"]["hash_encoding"]
        n_levels, log2, base, growth = (hc["n_levels"], hc["log2_hashmap_size"],
                                        hc["base_resolution"], hc["per_level_scale"])
        f = hc["n_features_per_level"]
        width = m["hash_ensemble"]["n_hash_encodings"] * f
    else:
        n_levels, log2, base = m["num_levels"], m["log2_hashmap_size"], m["base_resolution"]
        growth = float(np.exp((np.log(m["max_res"]) - np.log(base)) / (n_levels - 1)))
        f = width = 2
    max_size = 2 ** log2
    mask = max_size - 1
    lv = {k: [] for k in ("scale", "res", "size", "hashed", "offset", "sx", "sz")}
    offset = 0
    for l in range(n_levels):
        scale = base * growth ** l
        res = int(np.ceil(scale)) + 1
        sx = -(-res // ALIGN) * ALIGN
        sz = sx * res
        dense = sz * res
        if dense <= max_size:
            size, hashed = -(-dense // LAYOUT_BLOCK) * LAYOUT_BLOCK, False
        else:
            size, hashed = max_size, True
            sx = (PRIMES[1] & mask) & ~(ALIGN - 1)
            sz = (PRIMES[2] & mask) & ~(ALIGN - 1)
        for k, v in zip(lv, (float(scale), res, size, hashed, offset, sx, sz)):
            lv[k].append(v)
        offset += size
    lv.update(n_levels=n_levels, entries=offset, mask=mask, width=width, features=f)
    return lv


def corner_rows(x: torch.Tensor, lv: Dict):
    """The 8 corner rows of every level at [N, 3] positions in [0, 1] and
    their trilinear weights: (rows [N, L, 8] int64, weights [N, L, 8])."""
    dev, i64 = x.device, torch.int64
    t = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)
    scales = t(lv["scale"], x.dtype)
    res_max = t([r - 1 for r in lv["res"]], i64)
    sx, sz, size = t(lv["sx"], i64), t(lv["sz"], i64), t(lv["size"], i64)
    offset, hashed = t(lv["offset"], i64), t(lv["hashed"], torch.bool)
    pos = x[:, None, :] * scales[None, :, None] + 0.5
    cell = torch.floor(pos)
    frac = pos - cell
    cell = cell.to(i64)
    cx = torch.minimum(cell[..., 0].clamp(min=0), res_max)
    cz = torch.minimum(cell[..., 2].clamp(min=0), res_max)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    rows, weights = [], []
    for c, wy in ((0, 1.0 - fy), (1, fy)):
        cy = torch.minimum((cell[..., 1] + c).clamp(min=0), res_max)
        dense = cy + sx * cx + sz * cz
        hashed_idx = (cy * PRIMES[0] + sx * cx + sz * cz) & lv["mask"]
        local = torch.where(hashed, hashed_idx, dense)
        for stride, w in ((0, (1 - fx) * (1 - fz)), (sz, (1 - fx) * fz),
                          (sx, fx * (1 - fz)), (sx + sz, fx * fz)):
            rows.append(offset + (local + stride) % size)
            weights.append(wy * w)
    return torch.stack(rows, -1), torch.stack(weights, -1)


def encode(table: torch.Tensor, x: torch.Tensor, code: Optional[torch.Tensor],
           lv: Dict, quant: Callable) -> torch.Tensor:
    """[N, L*F] features, level-major: the trilinear sum of each level's
    corner rows, each row first blended over the ensemble's grids by
    ``code`` [N, H] (None: one grid)."""
    n, L, f = x.shape[0], lv["n_levels"], lv["features"]
    rows, w = corner_rows(x, lv)
    vals = quant(table)[rows.reshape(-1)].view(n, L, 8, -1, f)  # [n,L,8,H,F]
    if code is not None:
        vals = (vals * code[:, None, None, :, None]).sum(3)
    else:
        vals = vals[:, :, :, 0]
    return (vals * w[..., None]).sum(2).reshape(n, L * f)


# -- small pieces -----------------------------------------------------------

def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """sum_{j<i} x_j along the last axis."""
    inclusive = torch.cumsum(x, -1)
    return torch.cat([torch.zeros_like(x[..., :1]), inclusive[..., :-1]], -1)


def hann_window(value: float, n_bands: int, device) -> torch.Tensor:
    bands = torch.tensor(np.linspace(0, n_bands - 1, n_bands, dtype=np.float32),
                         device=device)
    x = torch.clamp(float(value) - bands, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(torch.pi * x))


def blend_code(code, window, n_tables, disable_initial, soft):
    if window is None:
        return code
    base = code
    if soft and window < 2.0:
        a = min(max(window - 1.0, 0.0), 1.0)
        e0 = torch.zeros_like(code)
        e0[:, 0] = 1.0
        base = a * code + (1.0 - a) * e0
    if disable_initial and window <= 1.0:
        base = torch.ones_like(code)
    return base * hann_window(window, n_tables, code.device)[None, :]


def posenc(x: torch.Tensor, n_freq: int, window: Optional[float]) -> torch.Tensor:
    scaled = 2.0 * np.pi * x
    freqs = torch.tensor((2.0 ** np.linspace(0.0, n_freq - 1, n_freq)).tolist(),
                         dtype=x.dtype, device=x.device)
    angles = (scaled[..., None] * freqs).flatten(-2)
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], -1)
    if window is not None:
        w = hann_window(window, n_freq, x.device).to(x.dtype).repeat(x.shape[-1])
        enc = torch.cat([w, w]) * enc
    return torch.cat([enc, scaled], -1)


def mlp(p: Dict, prefix: str, x: torch.Tensor, n_layers: int, out_act,
        quant: Callable, skips=()) -> torch.Tensor:
    """Linear layers ``prefix.layers.i.{w,b}`` ([in, out] weights), relu
    between them, the input concatenated again before each skip layer."""
    x_in = quant(x)
    h = x_in
    for i in range(n_layers):
        if i in skips and i > 0:
            h = torch.cat([h, x_in], -1)
        h = h @ quant(p[f"{prefix}.layers.{i}.w"])
        if f"{prefix}.layers.{i}.b" in p:
            h = h + p[f"{prefix}.layers.{i}.b"]
        if i < n_layers - 1:
            h = quant(torch.relu(h))
    if out_act == "relu":
        return torch.relu(h)
    if out_act == "sigmoid":
        return torch.sigmoid(h)
    return h


class TruncExp(torch.autograd.Function):
    """exp, with the input clamped to [-15, 15] in the derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def se3_exp_apply(screw: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """exp([v, r]) applied to points: Rodrigues with Taylor forms below
    |r|^2 = 1e-8."""
    v, r = screw[..., :3], screw[..., 3:]
    t2 = (r * r).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    cos = torch.where(small, 1.0 - t2 / 2.0 + t2 * t2 / 24.0, torch.cos(th))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (th - torch.sin(th)) / (th * t2s))
    rot = (cos[..., None] * p + a[..., None] * torch.cross(r, p, dim=-1)
           + b[..., None] * r * (r * p).sum(-1, keepdim=True))
    tr = ((1.0 - c * t2)[..., None] * v + b[..., None] * torch.cross(r, v, dim=-1)
          + c[..., None] * r * (r * v).sum(-1, keepdim=True))
    return rot + tr


def warp_offsets(p, norm, code_def, m, sched, quant):
    """The SE(3) warp's offset of AABB-normalized points (NaN rows: none)."""
    d = m["deformation_field"]
    enc = posenc(norm, d["n_freq_pos"], sched.get("window_deform"))
    h = mlp(p, "deformation.stem", torch.cat([enc, code_def], -1),
            d["mlp_num_layers"], "relu", quant, tuple(d["skip_connections"]))
    screw = quant(h) @ quant(p["deformation.head_rv.w"]) + p["deformation.head_rv.b"]
    screw = screw[:, :6]
    with torch.no_grad():
        bad_rows = torch.isnan(se3_exp_apply(screw, norm)).any(-1, keepdim=True)
    warped = se3_exp_apply(torch.where(bad_rows, torch.zeros_like(screw), screw), norm)
    return warped - norm


# -- the step ----------------------------------------------------------------

class Reference:
    """The model of configuration ``m`` (the cell's ``model`` dict) on
    ``device``; ``quant`` as in the module docstring."""

    def __init__(self, m: Dict, device, quant: Callable = identity):
        self.m, self.device, self.quant = m, torch.device(device), quant
        self.lv = grid_layout(m)
        box = np.asarray(m["scene_box"], np.float32)
        self.lo = torch.from_numpy(box[0]).to(self.device)
        self.hi = torch.from_numpy(box[1]).to(self.device)
        diag = float(np.linalg.norm(box[1] - box[0]))
        self.n_cand = (int(np.ceil(diag / m["render_step_size"])) + 127) // 128 * 128

    # schedules past their ends, learning rates of the step
    def sched(self, step: int) -> Dict[str, float]:
        m = self.m

        def ramp(a, b, begin, end):
            if end <= begin:
                return float(np.float32(b))
            frac = np.clip((step - begin) / (end - begin), 0.0, 1.0)
            return float(np.float32(a + (b - a) * frac))

        s = {}
        if m["use_deformation_field"] and m["window_deform_end"] >= 1:
            s["window_deform"] = ramp(0.0, m["deformation_field"]["n_freq_pos"],
                                      m["window_deform_begin"], m["window_deform_end"])
        if m["use_hash_ensemble"] and m["window_hash_encodings_end"] > 0:
            s["window_hash"] = ramp(1.0, m["hash_ensemble"]["n_hash_encodings"],
                                    m["window_hash_encodings_begin"],
                                    m["window_hash_encodings_end"])
        if m["lambda_empty_loss"] > 0 or m["lambda_near_loss"] > 0:
            s["eps_depth"] = ramp(m["eps_depth_initial"], m["eps_depth_final"],
                                  m["eps_depth_begin_step"], m["eps_depth_end_step"])
        return s

    def march(self, batch, binaries, jitter):
        """[R, S] sample intervals and the valid-slot mask."""
        m = self.m
        o, d = batch["origins"], batch["directions"]
        tiny = torch.where(d >= 0, 1e-12, -1e-12)
        inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
        t0, t1 = (self.lo[None] - o) * inv, (self.hi[None] - o) * inv
        t_near = torch.minimum(t0, t1).amax(-1).clamp(min=m["near_plane"])
        t_far = torch.maximum(t0, t1).amin(-1).clamp(max=m["far_plane"])
        dt, S, n = m["render_step_size"], m["sampling"]["max_samples_per_ray"], self.n_cand
        k = torch.arange(n, dtype=o.dtype, device=o.device)[None] + jitter[:, None]
        ts = t_near[:, None] + k * dt
        mids = (ts + (ts + dt)) * 0.5
        valid = mids < t_far[:, None]
        g = binaries.shape[0]
        norm = (o[:, None] + d[:, None] * mids[..., None] - self.lo) / (self.hi - self.lo)
        cell = torch.floor(norm * g).to(torch.int64)
        inside = ((cell >= 0) & (cell < g)).all(-1)
        cell = cell.clamp(0, g - 1)
        occ = binaries[cell[..., 0], cell[..., 1], cell[..., 2]] & inside
        valid = valid & occ
        # the first S valid candidates of each ray
        rank = torch.cumsum(valid.to(torch.int64), 1) - 1
        slot_of = torch.where(valid & (rank < S), rank, torch.full_like(rank, S))
        starts = torch.zeros(o.shape[0], S + 1, dtype=o.dtype, device=o.device)
        starts.scatter_(1, slot_of, ts)
        mask = torch.arange(S, device=o.device)[None] < valid.sum(1, keepdim=True).clamp(max=S)
        t_starts = starts[:, :S]
        return t_starts, t_starts + dt, mask, mask.sum()

    @staticmethod
    def compact(mask: torch.Tensor, budget: int):
        """Keep the first ``budget`` valid samples in slot-major order, the
        rays of a slot ordered by their valid count (descending, stable)."""
        R, S = mask.shape
        counts = mask.sum(1)
        order = torch.argsort(-counts, stable=True)
        place = torch.empty_like(order)
        place[order] = torch.arange(R, device=mask.device)
        per_slot = (counts[None, :] > torch.arange(S, device=mask.device)[:, None]).sum(1)
        before = torch.cumsum(per_slot, 0) - per_slot
        return mask & (before[None, :] + place[:, None] < budget)

    def field(self, p, pos, ts, dirs, sched):
        """density [n], rgb [n, 3] of world positions at timesteps (rgb None
        where ``dirs`` is None)."""
        m, q = self.m, self.quant
        code = p["time_embedding"][ts] if "time_embedding" in p else None
        if m["use_deformation_field"]:
            code_def = p["time_embedding_deformation"][ts] \
                if "time_embedding_deformation" in p else code
            norm = (pos - self.lo) / (self.hi - self.lo)
            pos = pos + warp_offsets(p, norm, code_def, m, sched, q)
        norm = (pos - self.lo) / (self.hi - self.lo)
        inside = ((norm > 0.0) & (norm < 1.0)).all(-1)
        norm = norm * inside[:, None]
        if m["use_hash_ensemble"]:
            he = m["hash_ensemble"]
            code = blend_code(code, sched.get("window_hash"), he["n_hash_encodings"],
                              he["disable_initial_hash_ensemble"], he["use_soft_transition"])
            feats = encode(p["field.table"], norm, code, self.lv, q)
        else:
            feats = encode(p["field.table"], norm, None, self.lv, q)
        h = mlp(p, "field.mlp_base", feats, m["num_layers"], None, q)
        density = TruncExp.apply(h[:, 0]) * inside
        if dirs is None:
            return density, None
        colour_in = torch.cat([(dirs + 1.0) / 2.0, h[:, 1:]], -1)
        rgb = mlp(p, "field.mlp_head", colour_in, m["num_layers_color"], "sigmoid", q)
        return density, rgb

    def budget(self, n_rays: int) -> int:
        """The compaction budget: the configuration's share of R x S, rounded
        up to a multiple of 128."""
        S = self.m["sampling"]["max_samples_per_ray"]
        frac = self.m["sampling"]["global_budget_fraction"]
        return -(-int(n_rays * S * frac) // 128) * 128 if 0 < frac < 1.0 else n_rays * S

    def _probe(self, p, idx, jitter, ts, step: int, chunk: int) -> torch.Tensor:
        """density x step size at ``jitter`` [N, 3] inside the flat cells
        ``idx`` [N], at timesteps ``ts`` [N]."""
        g = self.m["grid_resolution"]
        ijk = torch.stack([idx // (g * g), (idx // g) % g, idx % g], -1)
        pos = self.lo + (ijk.to(torch.float32) + jitter) / g * (self.hi - self.lo)
        sched = self.sched(step)
        return torch.cat([self.field(p, pos[lo:lo + chunk], ts[lo:lo + chunk], None, sched)[0]
                          for lo in range(0, idx.shape[0], chunk)]) * self.m["render_step_size"]

    @torch.no_grad()
    def probe_every_cell(self, p, seed: int, step: int, chunk: int = 16384) -> torch.Tensor:
        """A [G^3] grid state of the weights ``p``: every cell probed once,
        at a jittered point and a random timestep drawn from ``seed``, as
        the grid's warm-up updates probe it."""
        m, g = self.m, self.m["grid_resolution"]
        n, dev = g ** 3, self.device
        gen = torch.Generator().manual_seed(seed)
        jitter = torch.rand(n, 3, generator=gen).to(dev)
        ts = torch.randint(0, m["n_timesteps"], (n,), generator=gen).to(dev)
        return self._probe(p, torch.arange(n, device=dev), jitter, ts, step, chunk)

    @torch.no_grad()
    def occupancy_update(self, p, occs: torch.Tensor, step: int, seed: int,
                         chunk: int = 16384):
        """The grid state after the EMA update of ``step`` (past the grid's
        warm-up): a quarter of the cells drawn uniformly and a quarter from
        the occupied ones (inverse CDF of uniforms), each probed at a
        jittered point and a random timestep; a cell takes the largest of
        its probes' density x step size and its decayed value."""
        m, g = self.m, self.m["grid_resolution"]
        n = occs.shape[0]
        if n != g ** 3 or step < m["occupancy_grid_warmup_steps"]:
            raise ValueError("the reference updates one grid level past its warm-up")
        gen = torch.Generator().manual_seed(((2 * seed + OCCUPANCY_STREAM) << 32) + step)
        q = n // 4
        uniform = torch.randint(0, n, (q,), generator=gen)
        u = torch.rand(q, generator=gen)
        jitter = torch.rand(2 * q, 3, generator=gen)
        ts = torch.randint(0, m["n_timesteps"], (2 * q,), generator=gen)
        dev = occs.device
        occupied = occs > torch.clamp(occs.mean(), max=m["occ_thre"])
        cdf = torch.cumsum(occupied.to(torch.float32), 0)
        picked = torch.searchsorted(cdf, u.to(dev) * cdf[-1].clamp(min=1.0), right=True)
        idx = torch.cat([uniform.to(dev), picked.clamp(0, n - 1)])
        probed = self._probe(p, idx, jitter.to(dev), ts.to(dev), step, chunk)
        candidates = torch.maximum(occs[idx] * m["occupancy_grid_ema_decay"], probed)
        return occs.scatter_reduce(0, idx, candidates, reduce="amax", include_self=False)

    def losses(self, p, batch, binaries, budget: int, jitter, sched, chunk: int):
        """The six scaled losses of one batch, the valid and dropped sample
        counts, and the rendered colour of each ray."""
        m = self.m
        t_starts, t_ends, mask, n_valid = self.march(batch, binaries, jitter)
        kept = self.compact(mask, min(budget, mask.numel()))
        n_dropped = mask.sum() - kept.sum()
        R, S = mask.shape
        r_idx, s_idx = torch.nonzero(kept, as_tuple=True)
        mids = (t_starts + t_ends)[r_idx, s_idx] * 0.5
        o, d = batch["origins"][r_idx], batch["directions"][r_idx]
        pos = o + d * mids[:, None]
        ts = batch["timesteps"].to(torch.int64)[r_idx]
        dens, rgbs = [], []
        for lo in range(0, pos.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            a, b = self.field(p, pos[sl], ts[sl], d[sl], sched)
            dens.append(a)
            rgbs.append(b)
        sigma = torch.zeros(R, S, device=pos.device).index_put(
            (r_idx, s_idx), torch.cat(dens) if dens else pos.new_zeros(0))
        rgb = torch.zeros(R, S, 3, device=pos.device).index_put(
            (r_idx, s_idx), torch.cat(rgbs) if rgbs else pos.new_zeros(0, 3))
        delta = t_ends - t_starts
        keep = 1.0 - torch.exp(-sigma.detach() * delta) >= m["alpha_thre"]
        mask = kept & keep
        sigma = sigma * keep
        sd = torch.where(mask, sigma * delta, torch.zeros_like(sigma))
        trans = torch.exp(-exclusive_cumsum(sd))
        w = trans * (1.0 - torch.exp(-sd)) * mask
        acc = w.sum(-1, keepdim=True)
        colour = torch.einsum("rs,rsc->rc", w, rgb) + (1.0 - acc) * 1.0
        mid = (t_starts + t_ends) * 0.5
        depth = torch.einsum("rs,rsc->rc", w, mid[..., None]) / (acc + 1e-10)

        def masked_mean(v, sel):
            sel = sel.to(v.dtype)
            return (v * sel).sum() / sel.sum().clamp(min=1.0)

        alpha, depth_gt = batch["alpha"], batch["depth"]
        sq = (colour - batch["rgb"]) ** 2
        out = {"rgb_loss": masked_mean(sq, (alpha > m["alpha_mask_threshold"])[:, None]
                                       .expand(sq.shape))}
        out["alpha_loss"] = m["lambda_alpha_loss"] * masked_mean(
            (acc[:, 0] - alpha).abs(), alpha < 1.0)
        eps = sched.get("eps_depth", m["eps_depth_final"])
        dg = depth_gt[:, None]
        sel = (dg > 0) & (mid < dg - eps) & mask
        out["empty_loss"] = m["lambda_empty_loss"] * masked_mean(w ** 2, sel)
        sel = (dg > 0) & (dg - eps <= mid) & (mid <= dg + eps) & mask
        cum = torch.cumsum(w * mask.to(w.dtype), -1)
        std = (eps / 3.0) ** 2
        expected = 0.5 * (1.0 + torch.erf((mid - dg) / (std * math.sqrt(2.0))))
        out["near_loss"] = m["lambda_near_loss"] * masked_mean((cum - expected) ** 2, sel)
        out["depth_loss"] = m["lambda_depth_loss"] * masked_mean(
            (depth_gt - depth[:, 0]) ** 2, depth_gt > 0)
        wm = w * mask.to(w.dtype)
        a, b = exclusive_cumsum(wm), exclusive_cumsum(wm * mid)
        per_ray = 2.0 * (wm * (mid * a - b)).sum(-1) + (wm * wm * delta * mask).sum(-1) / 3.0
        rays = torch.arange(R, device=w.device) < m["dist_loss_max_rays"]
        out["dist_loss"] = m["lambda_dist_loss"] * masked_mean(per_ray, rays)
        return out, n_valid, n_dropped, colour.detach()

    def step(self, params: Dict[str, torch.Tensor], state: Dict, batch, binaries,
             budget: int, step: int, seed: int, lrs: Dict[str, float],
             chunk: int = 16384):
        """One training step in place: returns (loss, the gradient of each
        leaf (None: none), valid samples, budget-dropped samples, the rays'
        rendered colour)."""
        R = batch["origins"].shape[0]
        gen = torch.Generator().manual_seed(((2 * seed + JITTER_STREAM) << 32) + step)
        jitter = torch.rand(R, generator=gen).to(self.device)
        for v in params.values():
            v.grad = None
            v.requires_grad_(True)
        losses, n_valid, n_dropped, colour = self.losses(params, batch, binaries, budget,
                                                         jitter, self.sched(step), chunk)
        total = sum(losses.values())
        total.backward()
        grads = {k: None if v.grad is None else v.grad.detach().clone()
                 for k, v in params.items()}
        adam(params, state, lrs)
        return float(total.detach()), grads, int(n_valid), int(n_dropped), colour


def group_of(name: str) -> str:
    top = name.split(".")[0]
    if top == "field":
        return "fields"
    if top == "deformation":
        return "deformation_field"
    return "embeddings"


@torch.no_grad()
def adam(params: Dict[str, torch.Tensor], state: Dict, lrs: Dict[str, float]):
    """Adam (eps 1e-15, bias-corrected) over every leaf with a gradient."""
    state["count"] = state.get("count", 0) + 1
    t = torch.tensor(float(state["count"]))
    c1, c2 = float(1.0 - torch.pow(B1, t)), float(1.0 - torch.pow(B2, t))
    for name, p in params.items():
        if p.grad is None:
            continue
        g = p.grad
        mu = state.setdefault(("mu", name), torch.zeros_like(p))
        nu = state.setdefault(("nu", name), torch.zeros_like(p))
        mu.mul_(B1).add_((1.0 - B1) * g)
        nu.mul_(B2).add_((1.0 - B2) * torch.square(g))
        p.sub_(lrs[group_of(name)] * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))


def step_lrs(optimizers: Dict, step: int) -> Dict[str, float]:
    """StepLR of each group, rounded to float32."""
    return {k: float(np.float32(o["lr"] * o["scheduler_gamma"] ** (step // o["scheduler_step_size"])))
            for k, o in optimizers.items()}
