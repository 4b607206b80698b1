"""The render's ms/frame on chip_smoke.py's render scene: the flagship model
with seeded random weights scaled by ``utils/cameras.add_contrast`` over
bench.py's synthetic grid, 550x802 frames at timesteps 0, 3 and 7 through
``Renderer.render_image(chunk=8192)``.

    python -m nersemble_tpu_torch.scripts.bench_frame [--rounds 1]

Prints one JSON line: the first frame's ms (it builds the quad table and
warms the kernels), then each round's mean ms over the three frames (a
host clock around frames that end in their copy to the host), the hit
fraction, the card and its power limit. It imports only what the port has
had since its render path, so the same file times an older checkout of the
package: ``PYTHONPATH=<checkout> python <this file>``. ``--tiny --device
cpu`` runs the tiny config at 32x24 on the CPU (a rehearsal, not a time).
"""

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.renderer import Renderer
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.utils.bench_data import bench_grid
from nersemble_tpu_torch.utils.cameras import add_contrast, pinhole_frame
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.timing import nvidia_smi

SEED = 0
FRAME_H, FRAME_W, CHUNK = 802, 550, 8192  # chip_smoke.py's render phase
TIMESTEPS = (0, 3, 7)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="timed passes over the three frames")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config at 32x24 (CPU rehearsal)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_model_config(tiny=args.tiny)
    height, width, chunk = (32, 24, 256) if args.tiny else (FRAME_H, FRAME_W, CHUNK)
    model = NeRSembleModel(cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    renderer = Renderer(model, add_contrast(model.init_params(gen)),
                        bench_grid(cfg.grid_resolution).to(device))
    frames = [pinhole_frame(height, width, ts) for ts in TIMESTEPS]
    step = cfg.window_hash_encodings_end  # the schedule's end

    def timed(frame) -> float:
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        renderer.render_image(frame, step, chunk=chunk)
        return 1e3 * (time.perf_counter() - start)

    first_ms = timed(frames[0])
    rounds = [sum(timed(f) for f in frames) / len(frames) for _ in range(args.rounds)]
    hit = renderer.render_hit_mask(torch.from_numpy(frames[0]["origins"]).to(device),
                                   torch.from_numpy(frames[0]["directions"]).to(device))
    result = {"first_frame_ms": first_ms, "ms_per_frame": rounds,
              "frame": [height, width], "chunk": chunk,
              "hit_fraction": float(hit.float().mean()),
              "device": nvidia_smi() if cuda else "cpu"}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
