"""Binary occupancy from the EMA grid state (port of
nersemble_tpu/ops/occupancy.py::occupancy_binaries; the EMA update comes
with training)."""

from typing import Optional

import torch


def occupancy_binaries(occs: torch.Tensor, occ_thre: float,
                       frustum_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[L*G^3] EMA densities -> flat binaries, threshold min(mean, occ_thre)
    like nerfacc. The frustum-culling grid masks the base level only."""
    binaries = occs > torch.clamp(occs.mean(), max=occ_thre)
    if frustum_grid is not None:
        f = frustum_grid.reshape(-1)
        binaries = binaries.clone()
        binaries[:f.shape[0]] &= f
    return binaries
