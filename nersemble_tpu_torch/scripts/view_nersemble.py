"""Live viewer CLI of the port: interactively explore a trained checkpoint
(nersemble_tpu/scripts/view_nersemble.py's flags and defaults, plus
``--device``).

Loads the run like the render CLI (config.yml + checkpoint), starts the
orbit-camera web UI (viewer/server.py), and services render requests on
the main thread until interrupted (or, for a caller, until
``max_requests`` were served). Renders use the auto budget. Runs on the
GPU unless ``--device cpu``; reads run folders written by either package.

Usage:
    python -m nersemble_tpu_torch.scripts.view_nersemble NERS-XXX-name \\
        [--port 7007] [--use-occupancy-grid-filtering]
"""

import argparse

from nersemble_tpu_torch.scripts.evaluate_nersemble import eval_trainer, open_run
from nersemble_tpu_torch.viewer import ViewerServer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_name", type=str)
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--use-occupancy-grid-filtering", action="store_true")
    p.add_argument("--occupancy-grid-filtering-threshold", type=float,
                   default=0.05)
    p.add_argument("--occupancy-grid-filtering-sigma-erosion", type=float,
                   default=7)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the GPU)")
    return p


def main(argv=None, max_requests=None):
    args = build_parser().parse_args(argv)
    manager, config = open_run(args)
    trainer = eval_trainer(config, manager, args)
    checkpoint = trainer.start_step - 1

    _, distance = trainer.viewer_defaults()
    server = ViewerServer(state={
        "run_name": manager.get_run_name(),
        "n_timesteps": config.data.n_timesteps,
        "step": checkpoint,
        "distance": distance,
    }, host=args.host, port=args.port)
    print(f"[nersemble-torch] viewing {manager.get_run_name()} "
          f"@ step {checkpoint}: {server.url}")
    served = 0
    try:
        while max_requests is None or served < max_requests:
            if server.service(
                    lambda p: trainer.viewer_render(p, checkpoint),
                    timeout=1.0):
                served += 1
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return served


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
