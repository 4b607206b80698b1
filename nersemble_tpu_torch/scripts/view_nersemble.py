"""Live viewer CLI of the port: interactively explore a trained checkpoint
(nersemble_tpu/scripts/view_nersemble.py's flags and defaults, plus
``--device``).

Loads the run like the render CLI (config.yml + checkpoint), starts the
orbit-camera web UI (viewer/server.py), and services render requests on
the main thread until interrupted (or, for a caller, until
``max_requests`` were served). Renders use the auto budget. Runs on the
GPU unless ``--device cpu``; reads run folders written by either package.
On the ranks of the run's ``config.parallel.data_axis_size`` (as the
evaluate CLI) rank 0 runs the server and every rank renders each request
(viewer/server.py ``serve_over_ranks``: each round waits up to a second for
a request); on exit rank 0 sends the other ranks the stop message.

Usage:
    python -m nersemble_tpu_torch.scripts.view_nersemble NERS-XXX-name \\
        [--port 7007] [--use-occupancy-grid-filtering]
"""

import argparse
import sys

from nersemble_tpu_torch.parallel import launch
from nersemble_tpu_torch.scripts.evaluate_nersemble import eval_trainer, open_run
from nersemble_tpu_torch.viewer import ViewerServer, serve_over_ranks


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
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    _, config = open_run(args)
    return launch.run_cli("nersemble_tpu_torch.scripts.view_nersemble", argv,
                          args.device, config.parallel.data_axis_size, max_requests)


def run(argv, mesh=None, max_requests=None):
    """The viewer of ``argv`` on this rank (``mesh`` None: one process);
    returns the requests served."""
    args = build_parser().parse_args(argv)
    manager, config = open_run(args)
    trainer = eval_trainer(config, manager, args, mesh)
    checkpoint = trainer.start_step - 1

    def render(p):
        return trainer.viewer_render(p, checkpoint)

    server = None
    if trainer.is_chief:
        _, distance = trainer.viewer_defaults()
        server = ViewerServer(state={
            "run_name": manager.get_run_name(),
            "n_timesteps": config.data.n_timesteps,
            "step": checkpoint,
            "distance": distance,
        }, host=args.host, port=args.port)
        print(f"[nersemble-torch] viewing {manager.get_run_name()} "
              f"@ step {checkpoint}: {server.url}")
    served, ended = 0, False
    try:
        if mesh is None:
            while max_requests is None or served < max_requests:
                served += server.service(render, timeout=1.0)
        elif server is None:  # until rank 0's stop message
            while (count := serve_over_ranks(None, mesh, render)) is not None:
                served += count
        else:
            while max_requests is None or served < max_requests:
                served += serve_over_ranks(server, mesh, render, timeout=1.0)
        ended = True
    except KeyboardInterrupt:
        ended = True
    finally:
        if server is not None:
            if mesh is not None and ended:  # not after a failed render
                serve_over_ranks(server, mesh, render, stop=True)
            server.close()
    return served


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
