"""Plain float32 reference of one training step of the sequence-97
configuration (dense marching), in PyTorch.

The model is ``nersemble_ref.Reference``'s; what differs is the march and
what it keeps. With the occupancy grid off a ray samples every step inside
the scene box that at least ``view_frustum_culling`` training cameras see
(``binaries``: the frustum grid alone, no occupancy update), every one of
the ``max_samples_per_ray`` slots that a ray fills is kept (no compaction
budget), and there is no distortion loss.

A step marches the whole batch, then evaluates it in blocks of whole rays
of at most ``block_samples`` valid samples, so that the float32 field's
activations fit beside the checked state on the card. Each loss is a mean
whose count can depend on the field (the empty and near losses count the
samples the alpha threshold keeps), so a first pass without gradients
counts every term over the batch, and the second pass back-propagates each
block's sums over those counts: the gradients add up to the whole batch's.

Everything runs in float32 with TF32 off; ``quant`` as in
``nersemble_ref``. This module imports nothing of the program.
"""

import math
from typing import Dict, List, Optional

import torch

from benchmark.reference.nersemble_ref import (
    JITTER_STREAM,
    Reference,
    adam,
    exclusive_cumsum,
    identity,
)

TERMS = ("rgb_loss", "alpha_loss", "empty_loss", "near_loss", "depth_loss")


class DenseReference(Reference):
    """The sequence-97 model of configuration ``m`` on ``device``."""

    def __init__(self, m: Dict, device, quant=identity, block_samples: int = 1 << 17):
        if not m["disable_occupancy_grid"] or m["lambda_dist_loss"] != 0:
            raise ValueError("the dense reference marches with the occupancy grid "
                             "off and no distortion loss")
        super().__init__(m, device, quant)
        if m["sampling"]["max_samples_per_ray"] < self.n_cand:
            raise ValueError("the dense reference keeps every candidate of a ray")
        self.block_samples = block_samples

    def binaries(self, frustum: Optional[torch.Tensor]) -> torch.Tensor:
        """[G, G, G]: every cell, or the cells inside the frustum grid."""
        g = self.m["grid_resolution"]
        every = torch.ones(g, g, g, dtype=torch.bool, device=self.device)
        return every if frustum is None else every & frustum

    def blocks(self, counts: torch.Tensor) -> List[slice]:
        """Consecutive rays in blocks of at most ``block_samples`` valid
        samples (a ray with more is a block of its own)."""
        out, lo, held = [], 0, 0
        for r, c in enumerate(counts.tolist()):
            if r > lo and held + c > self.block_samples:
                out.append(slice(lo, r))
                lo, held = r, 0
            held += c
        out.append(slice(lo, len(counts)))
        return out

    def terms(self, p, batch, t_starts, t_ends, mask, sched, chunk: int,
              colour: bool = False):
        """Each loss's sum and count over the rays of one block
        ({name: (sum, count)}), and their rendered colour when asked."""
        m = self.m
        R, S = mask.shape
        r_idx, s_idx = torch.nonzero(mask, as_tuple=True)
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
        mask = mask & keep
        sigma = sigma * keep
        sd = torch.where(mask, sigma * delta, torch.zeros_like(sigma))
        trans = torch.exp(-exclusive_cumsum(sd))
        w = trans * (1.0 - torch.exp(-sd)) * mask
        acc = w.sum(-1, keepdim=True)
        rendered = torch.einsum("rs,rsc->rc", w, rgb) + (1.0 - acc) * 1.0
        mid = (t_starts + t_ends) * 0.5
        depth = torch.einsum("rs,rsc->rc", w, mid[..., None]) / (acc + 1e-10)

        def part(v, sel):
            sel = sel.to(v.dtype)
            return (v * sel).sum(), sel.sum()

        alpha, depth_gt = batch["alpha"], batch["depth"]
        sq = (rendered - batch["rgb"]) ** 2
        out = {"rgb_loss": part(sq, (alpha > m["alpha_mask_threshold"])[:, None]
                                .expand(sq.shape)),
               "alpha_loss": part((acc[:, 0] - alpha).abs(), alpha < 1.0)}
        eps = sched.get("eps_depth", m["eps_depth_final"])
        dg = depth_gt[:, None]
        out["empty_loss"] = part(w ** 2, (dg > 0) & (mid < dg - eps) & mask)
        sel = (dg > 0) & (dg - eps <= mid) & (mid <= dg + eps) & mask
        cum = torch.cumsum(w * mask.to(w.dtype), -1)
        std = (eps / 3.0) ** 2
        expected = 0.5 * (1.0 + torch.erf((mid - dg) / (std * math.sqrt(2.0))))
        out["near_loss"] = part((cum - expected) ** 2, sel)
        out["depth_loss"] = part((depth_gt - depth[:, 0]) ** 2, depth_gt > 0)
        return out, (rendered.detach() if colour else None)

    def scales(self) -> Dict[str, float]:
        m = self.m
        return {"rgb_loss": 1.0, "alpha_loss": m["lambda_alpha_loss"],
                "empty_loss": m["lambda_empty_loss"], "near_loss": m["lambda_near_loss"],
                "depth_loss": m["lambda_depth_loss"]}

    def step(self, params: Dict[str, torch.Tensor], state: Dict, batch, binaries,
             step: int, seed: int, lrs: Dict[str, float], chunk: int = 16384):
        """One training step in place: returns (loss, the gradient of each
        leaf (None: none), valid samples, 0 (no budget drops a sample), the
        rays' rendered colour)."""
        R = batch["origins"].shape[0]
        gen = torch.Generator().manual_seed(((2 * seed + JITTER_STREAM) << 32) + step)
        jitter = torch.rand(R, generator=gen).to(self.device)
        sched = self.sched(step)
        with torch.no_grad():
            t_starts, t_ends, mask, n_valid = self.march(batch, binaries, jitter)
        blocks = self.blocks(mask.sum(1))

        def block(rays):
            return ({k: v[rays] for k, v in batch.items()}, t_starts[rays],
                    t_ends[rays], mask[rays])

        counts = dict.fromkeys(TERMS, 0.0)
        with torch.no_grad():
            for rays in blocks:
                got, _ = self.terms(params, *block(rays), sched, chunk)
                for k, (_, n) in got.items():
                    counts[k] += float(n)
        scales = self.scales()
        for v in params.values():
            v.grad = None
            v.requires_grad_(True)
        total, colours = 0.0, []
        for rays in blocks:
            got, colour = self.terms(params, *block(rays), sched, chunk, colour=True)
            loss = sum(scales[k] * s / max(counts[k], 1.0) for k, (s, _) in got.items())
            loss.backward()
            total += float(loss.detach())
            colours.append(colour)
        grads = {k: None if v.grad is None else v.grad.detach().clone()
                 for k, v in params.items()}
        adam(params, state, lrs)
        return (float(torch.tensor(total, dtype=torch.float32)), grads, int(n_valid), 0,
                torch.cat(colours))
