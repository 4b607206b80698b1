"""Occupancy-grid floater removal: keep the largest connected component
(the port's copy of nersemble_tpu/utils/connected_components.py).

Reference: src/nersemble/util/connected_components.py:29-139 (cc3d + scipy on
GPU tensors there; pure scipy.ndimage here — this runs once per evaluation on
the host, never on the training path). The caller hands over the grid as
numpy, one device read per run.

Pipeline: sigmoid(EMA densities) -> uint8 rescale -> gaussian blur (thins
narrow bridges) -> threshold -> 6-connected largest component -> gaussian
erosion to re-enlarge -> boolean mask ANDed into the sampling binaries.
"""

from typing import List

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _thinned(grid: np.ndarray, sigma_thinning: float) -> np.ndarray:
    """The filter's first steps: sigmoid, uint8 rescale, thinning blur."""
    import scipy.ndimage as ndi
    return ndi.gaussian_filter(((_sigmoid(grid) - 0.5) * 2 * 255).astype(np.uint8),
                               sigma=sigma_thinning)


def extract_top_k_connected_component(density_grid: np.ndarray,
                                      threshold: float = 0.6,
                                      sigma_thinning: float = 1.0,
                                      sigma_erosion: float = 2.0,
                                      k: int = 1) -> List[np.ndarray]:
    """[G, G, G] raw densities -> list of k binary component masks
    (largest last, erosion-enlarged)."""
    import scipy.ndimage as ndi

    binary = _thinned(density_grid, sigma_thinning) >= 255 * threshold

    labels, n_labels = ndi.label(binary, structure=ndi.generate_binary_structure(3, 1))
    if n_labels == 0:
        return [np.zeros_like(binary) for _ in range(k)]
    sizes = ndi.sum_labels(np.ones_like(labels), labels, range(1, n_labels + 1))
    order = np.argsort(sizes)[::-1][:k] + 1  # label ids, largest first

    components = []
    for rank, label_id in enumerate(reversed(list(order))):
        mask = labels == label_id
        if rank == len(order) - 1:  # largest component: erosion-enlarge
            # integer blur on purpose (reference connected_components.py:88
            # blurs `curr_cc * 100` as int): scipy rounds the int output, so
            # the gaussian tail dies early (1-D cutoff ~sqrt(2*ln 200) ~ 3.2
            # sigma for amplitude 100; nearer in 3-D, geometry-dependent). A
            # float blur with `> 0` would dilate to the full 4-sigma
            # truncation radius instead — measurably fatter masks around
            # floaters.
            mask = ndi.gaussian_filter(mask.astype(np.int64) * 100,
                                       sigma=sigma_erosion) > 0
        components.append(mask)
    return components


def largest_component_cells(grid_occs: np.ndarray, resolution: int,
                            threshold: float = 0.6,
                            sigma_thinning: float = 1.0) -> int:
    """Cells of the largest 6-connected component of the thresholded grid,
    before the erosion blur enlarges it (or erases it: a component of a few
    cells blurs below 1 in every integer pass and comes out empty)."""
    import scipy.ndimage as ndi
    grid = np.asarray(grid_occs).reshape(resolution, resolution, resolution)
    binary = _thinned(grid, sigma_thinning) >= 255 * threshold
    labels, n_labels = ndi.label(binary, structure=ndi.generate_binary_structure(3, 1))
    if n_labels == 0:
        return 0
    return int(np.bincount(labels.ravel())[1:].max())


def filter_occupancy_grid_mask(grid_occs: np.ndarray, resolution: int,
                               threshold: float = 0.6,
                               sigma_thinning: float = 1.0,
                               sigma_erosion: float = 5.0) -> np.ndarray:
    """[G^3] EMA densities -> [G, G, G] bool mask of the largest component.

    AND this into the sampling binaries (reference: evaluate_nersemble.py:68-73
    with threshold=0.05, sigma_erosion=7).
    """
    grid = np.asarray(grid_occs).reshape(resolution, resolution, resolution)
    largest = extract_top_k_connected_component(
        grid, threshold=threshold, sigma_thinning=sigma_thinning,
        sigma_erosion=sigma_erosion, k=1)[-1]
    mask = largest > 0
    if not mask.any():
        # Matches the reference pipeline (an empty component blanks the
        # binaries), but silent black frames are a terrible failure mode:
        # say which step emptied it. The threshold compares the POST-blur
        # grid (the thinning blur can erase a small above-threshold peak).
        import sys
        peak = float(_thinned(grid, sigma_thinning).max()) / 255
        cells = largest_component_cells(grid, resolution, threshold, sigma_thinning)
        cause = (f"max blurred occupancy {peak:.4f} < threshold {threshold}"
                 if cells == 0 else
                 f"max blurred occupancy {peak:.4f} >= threshold {threshold}, but "
                 f"the largest thresholded component, {cells} cells, was erased by "
                 f"the integer erosion blur (sigma {sigma_erosion})")
        print(f"[nersemble-torch] WARNING: occupancy CC filter kept 0 cells "
              f"({cause}); everything renders as background. The grid is likely "
              f"under-trained, or lower --occupancy-grid-filtering-threshold.",
              file=sys.stderr)
    return mask
