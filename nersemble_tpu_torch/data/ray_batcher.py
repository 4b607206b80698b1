"""Host-side ray batching (port of nersemble_tpu/data/ray_batcher.py) and
the copy of each batch to the device.

Every batch samples ``num_rays`` pixels from a working set of images
(resampled every ``repeat`` batches), gathers per-pixel supervision (rgb,
alpha, depth) and per-image metadata (timestep index, cam id, image idx),
and generates viewer-frame pinhole rays, all in numpy. ``batch_for_step``
is a pure function of (seed, step), bit-equal to the JAX package's, so a
resumed run sees the batches of the run that never stopped.

``DeviceBatches`` feeds the training loop. A ``.to("cuda")`` of pageable
memory synchronizes the stream and drains the GPU's queue (ROADMAP C5), so
a prefetch thread builds each numpy batch and copies it into a slot of a
ring of page-locked host tensors; the loop copies the slot to the device
with ``non_blocking=True`` and records an event, and the thread waits for
that event before it refills the slot. The thread never touches device
memory and the loop never waits for a copy.
"""

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from nersemble_tpu_torch.config import DataConfig
from nersemble_tpu_torch.data.dataparser import DataparserOutputs
from nersemble_tpu_torch.data.dataset import NeRSembleDataset
from nersemble_tpu_torch.utils import spans

# the batch entries the training step reads (trainer.py:435-436 of the JAX
# package)
DEVICE_KEYS = ("origins", "directions", "rgb", "timesteps", "camera_indices",
               "alpha", "depth")
PREFETCH = 2  # batches built ahead; the ring holds PREFETCH + 2 slots


def _rays_for_pixels(outputs: DataparserOutputs, cam_pos: np.ndarray,
                     ys: np.ndarray, xs: np.ndarray):
    """Vectorized pinhole rays for per-ray camera/pixel indices."""
    intr = outputs.intrinsics
    dirs_cam = np.stack([
        (xs + 0.5 - intr.cx) / intr.fx,
        -(ys + 0.5 - intr.cy) / intr.fy,
        -np.ones_like(xs, np.float64),
    ], axis=-1)
    rot = outputs.c2w[cam_pos, :3, :3]  # [R, 3, 3]
    dirs = np.einsum("rij,rj->ri", rot, dirs_cam)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = outputs.c2w[cam_pos, :3, 3]
    return origins.astype(np.float32), dirs.astype(np.float32)


class RayBatcher:
    """Step-indexed training ray batches."""

    def __init__(self, dataset: NeRSembleDataset, config: DataConfig,
                 num_rays: Optional[int] = None, seed: int = 0):
        self.dataset = dataset
        self.outputs = dataset.outputs
        self.config = config
        self.num_rays = num_rays or config.train_num_rays_per_batch
        self.images_per_set = min(config.train_num_images_to_sample_from,
                                  len(dataset))
        self.repeat = max(config.train_num_times_to_repeat_images, 1)
        self.seed = seed
        self._set_cache = None  # (set_idx, image_indices)

    # -- step-indexed RNG derivation ------------------------------------------

    def _step_rng(self, step: int) -> np.random.Generator:
        """Fresh generator for one step's pixel sampling (pure in (seed, step))."""
        return np.random.default_rng([self.seed, 0x9E3779B9, step])

    def _image_set(self, set_idx: int) -> np.ndarray:
        """The working image set for steps [set_idx*repeat, (set_idx+1)*repeat).
        Pure in (seed, set_idx); cached because consecutive steps share a set."""
        if self._set_cache is not None and self._set_cache[0] == set_idx:
            return self._set_cache[1]
        rng = np.random.default_rng([self.seed, 0x5DEECE66, set_idx])
        n = len(self.dataset)
        image_indices = rng.choice(n, size=min(self.images_per_set, n),
                                   replace=False)
        self._set_cache = (set_idx, image_indices)
        return image_indices

    # -- batch construction --------------------------------------------------

    def _make_batch(self, image_indices: np.ndarray,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
        out = self.outputs
        R = self.num_rays
        H, W = out.image_height, out.image_width

        pick = rng.integers(0, len(image_indices), R)
        img_idx = image_indices[pick]
        ys = rng.integers(0, H, R)
        xs = rng.integers(0, W, R)

        items = {int(i): self.dataset[int(i)] for i in np.unique(img_idx)}
        rgb = np.empty((R, 3), np.float32)
        has_alpha = "alpha" in next(iter(items.values()))
        has_depth = "depth" in next(iter(items.values()))
        alpha = np.empty((R,), np.float32) if has_alpha else None
        depth = np.empty((R,), np.float32) if has_depth else None
        for i, item in items.items():
            sel = img_idx == i
            rgb[sel] = item["rgb"][ys[sel], xs[sel]]
            if has_alpha:
                alpha[sel] = item["alpha"][ys[sel], xs[sel]]
            if has_depth:
                depth[sel] = item["depth"][ys[sel], xs[sel]]

        entries = out.entries
        cam_pos = np.asarray([entries[int(i)].cam_pos for i in img_idx], np.int32)
        timesteps = np.asarray([entries[int(i)].timestep_index for i in img_idx],
                               np.int32)
        cam_ids = np.asarray([entries[int(i)].cam_id for i in img_idx], np.int32)

        origins, dirs = _rays_for_pixels(out, cam_pos, ys.astype(np.float64),
                                         xs.astype(np.float64))
        batch = {
            "origins": origins,
            "directions": dirs,
            "rgb": rgb,
            "timesteps": timesteps,
            "camera_indices": img_idx.astype(np.int32),
            "cam_ids": cam_ids,
            "pixel_ys": ys.astype(np.int32),
            "pixel_xs": xs.astype(np.int32),
        }
        if alpha is not None:
            batch["alpha"] = alpha
        if depth is not None:
            batch["depth"] = depth
        return batch

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """The batch the training loop consumes at ``step`` — pure function."""
        return self._make_batch(self._image_set(step // self.repeat),
                                self._step_rng(step))

    def _generator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_for_step(step)
            step += 1


class DeviceBatches:
    """The batches of steps ``start_step, start_step + 1, ...`` on ``device``
    (the DEVICE_KEYS entries that the batch has), built ahead by a prefetch
    thread. On a CUDA device they pass through a ring of ``PREFETCH + 2``
    page-locked slots and a non-blocking copy; on the CPU the numpy arrays
    are wrapped as they are. The counters ``batch_wait_s`` and
    ``batch_copy_s`` (``utils/spans.py``) add up the host seconds
    ``__next__`` spent waiting for the thread and issuing copies (the spans
    ``loop:batch_wait`` and ``loop:batch_copy``; the thread's work is
    ``data:build``). ``close()`` stops the thread. ``rows``: the slice of
    every batch's rays to keep (a rank's share of the batch under data
    parallelism); every rank builds the whole step-indexed batch and copies
    only its rows."""

    def __init__(self, batcher: RayBatcher, start_step: int, device,
                 rows: slice = slice(None)):
        self.batcher = batcher
        self.rows = rows
        self.device = torch.device(device)
        self.step = start_step  # the step of the next batch handed out
        self._ready: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._slots = None
        if self.device.type == "cuda":
            first = batcher.batch_for_step(start_step)
            first = {k: v[rows] for k, v in first.items()}
            self._slots = [{k: torch.empty(first[k].shape, dtype=torch.from_numpy(first[k]).dtype,
                                           pin_memory=True)
                            for k in DEVICE_KEYS if k in first}
                           for _ in range(PREFETCH + 2)]
            # slot -> the event of its last copy (None: free)
            self._free: "queue.Queue" = queue.Queue()
            for i in range(len(self._slots)):
                self._free.put((i, None))
        self._thread = threading.Thread(target=self._work, args=(start_step,),
                                        daemon=True)
        self._thread.start()

    def _blocking(self, fn, *args):
        """``fn(*args, timeout=...)`` retried until it succeeds or ``close()``."""
        while not self._stop.is_set():
            try:
                return fn(*args, timeout=0.05)
            except (queue.Empty, queue.Full):
                continue
        raise _Stopped

    def _work(self, step: int) -> None:
        try:
            while not self._stop.is_set():
                with spans.span("data:build", step=step, device=False):
                    batch = self.batcher.batch_for_step(step)
                    batch = {k: v[self.rows] for k, v in batch.items()}
                    if self._slots is None:
                        item = {k: batch[k] for k in DEVICE_KEYS if k in batch}
                    else:
                        index, event = self._blocking(self._free.get)
                        while event is not None and not event.query():
                            time.sleep(1e-4)  # the slot's last copy is in flight
                        slot = self._slots[index]
                        for key, dst in slot.items():
                            dst.copy_(torch.from_numpy(batch[key]))
                        item = index
                self._blocking(self._ready.put, item)
                step += 1
        except _Stopped:
            return
        except Exception as ex:  # handed to the consumer, which raises it
            try:
                self._blocking(self._ready.put, ex)
            except _Stopped:
                return

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        step, self.step = self.step, self.step + 1
        start = time.perf_counter()
        with spans.span("loop:batch_wait", step=step, device=False):
            item = self._ready.get()
        got = time.perf_counter()
        spans.count("batch_wait_s", got - start)
        if isinstance(item, Exception):
            raise item
        with spans.span("loop:batch_copy", step=step):
            if self._slots is None:
                batch = {k: torch.from_numpy(v) for k, v in item.items()}
            else:
                batch = {k: v.to(self.device, non_blocking=True)
                         for k, v in self._slots[item].items()}
                event = torch.cuda.Event()
                event.record()
                self._free.put((item, event))
        spans.count("batch_copy_s", time.perf_counter() - got)
        return batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("the batch prefetch thread did not stop")


class _Stopped(Exception):
    """``close()`` was called while the prefetch thread waited."""


class EvalImageLoader:
    """Full-image ray generation for evaluation/render."""

    def __init__(self, dataset: NeRSembleDataset):
        self.dataset = dataset
        self.outputs = dataset.outputs

    def __len__(self):
        return len(self.dataset)

    def image_rays(self, image_idx: int) -> Dict[str, np.ndarray]:
        out = self.outputs
        entry = out.entries[image_idx]
        H, W = out.image_height, out.image_width
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        cam_pos = np.full(ys.shape, entry.cam_pos, np.int32)
        origins, dirs = _rays_for_pixels(out, cam_pos, ys.astype(np.float64),
                                         xs.astype(np.float64))
        item = self.dataset[image_idx]
        batch = {
            "origins": origins,
            "directions": dirs,
            "timesteps": np.full(ys.shape, entry.timestep_index, np.int32),
            "camera_indices": np.full(ys.shape, image_idx, np.int32),
            "gt_rgb": item["rgb"],
            "entry": entry,
            "height": H,
            "width": W,
        }
        if "alpha" in item:
            batch["gt_alpha"] = item["alpha"]
        return batch
