"""CLI entry (port of ``tpu3dlm/cli.py``): the reference's
``python3 task_def.py --data <folder>``.

    python -m tpu3dlm_torch.cli --data gold_std [--config cfg] [--device cuda|cpu]
    python -m tpu3dlm_torch.cli --data maintenance

``--data gold_std`` runs the gold-standard pipeline alone; any other folder
first ensures the gold-standard pickle exists and reads back (running the
gold pipeline when it is missing or unreadable), then runs that folder's
pipeline with the maintenance compare. The config defaults to
``configs/variables.cfg`` under the working directory and is written with
the defaults when absent. ``--watch`` switches to the serving mode
(``pipeline/watch.py::ScanWatcher``: poll the data root, run each capture
as it lands) on the same device:

    python -m tpu3dlm_torch.cli --watch [--poll-interval S] [--max-scans N]
        [--watch-concurrency C] [--config cfg] [--device cuda|cpu]

``--setup`` first writes a synthetic capture into the data folder
(``data/synthetic.py::generate_scan`` on the host: the cold start of the
README's Quick start), then runs as above:

    python -m tpu3dlm_torch.cli --data gold_std --setup
    python -m tpu3dlm_torch.cli --data maintenance --setup

With ``mesh_devices = N > 1`` in the config the run is data parallel over
N ranks (``parallel/mesh.py``). With no world running, the CLI starts the N
ranks itself (spawned processes, one device each: NCCL over the cards,
gloo on the CPU) and each runs the same command; a rank that fails fails
the run. Under ``torchrun --nproc-per-node N -m tpu3dlm_torch.cli ...`` it
first joins the world torchrun started, and leaves it at the end. Rank 0
alone writes files, the default config included. ``--watch`` runs over the
world too (``pipeline/watch.py::serve_world``): rank 0 watches the data
root and every rank runs each capture's Pipeline, one capture at a time.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Processing Configuration")
    parser.add_argument("--data", type=str, default="gold_std", help="Data Folder Name.")
    parser.add_argument(
        "--config", type=str, default=None,
        help="Path to variables.cfg (default: <cwd>/configs/variables.cfg, "
        "auto-created if absent).",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to run on: cuda (default; raises without a GPU) or cpu.",
    )
    parser.add_argument("--setup", action="store_true",
                        help="Generate a synthetic scan into the data folder before running.")
    parser.add_argument("--watch", action="store_true",
                        help="Continuous serving mode: poll the data root and process new capture "
                        "folders as they land (pipeline/watch.ScanWatcher).")
    parser.add_argument("--poll-interval", type=float, default=5.0,
                        help="--watch: seconds between directory polls.")
    parser.add_argument("--max-scans", type=int, default=None,
                        help="--watch: stop after N processed scans (default: run forever).")
    parser.add_argument("--watch-concurrency", type=int, default=1,
                        help="--watch: captures processed at once (gold_std always runs alone).")
    parser.add_argument("--max-attempts", type=int, default=3,
                        help="--watch: failures tolerated per capture (with backoff) before quarantine.")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.parallel.mesh import distributed_init, leave_world

    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():  # torchrun's world
        distributed_init("env://", device=device)
        try:
            _run(args, argv, device)
        finally:
            leave_world()
        return
    _run(args, argv, device)


def _run(args, argv: list, device) -> None:
    import torch.distributed as dist

    from tpu3dlm_torch.parallel.mesh import spawn_world
    from tpu3dlm_torch.pipeline.task import load_gold_std, setup_pipeline
    from tpu3dlm_torch.utils.config import ConfigLoader, write_default_config

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    config_path = args.config or os.path.join("configs", "variables.cfg")
    if not os.path.exists(config_path) and rank0:
        logging.info("No config at %s — writing defaults.", config_path)
        write_default_config(config_path)
    _barrier()

    cfg = ConfigLoader(config_path, args.data)
    cfg_goldstd = ConfigLoader(config_path, "gold_std")

    n = getattr(cfg, "mesh_devices", 1)
    if n > 1 and not dist.is_initialized():
        spawn_world(_rank_main, n, device=device, args=(argv,))
        return

    if args.setup:
        from tpu3dlm_torch.data.synthetic import generate_scan

        data_root = os.path.dirname(os.path.dirname(cfg.pose_path))
        if rank0:
            logging.info("Generating synthetic scan under %s/%s", data_root, args.data)
            generate_scan(data_root, args.data)
        _barrier()

    if args.watch:
        from tpu3dlm_torch.pipeline.watch import watch

        watch(config_path, device=device, poll_interval=args.poll_interval, max_scans=args.max_scans,
              max_attempts=args.max_attempts, concurrency=args.watch_concurrency)
        return

    if args.data == "gold_std":
        setup_pipeline(args.data, cfg_goldstd, None, device=device)
        return
    # every rank reaches this check together, and Pipeline.run returns only
    # once rank 0's pickle is written, so the ranks take the same branches
    if not os.path.exists(cfg_goldstd.pickle_path):
        logging.info("Performing setup before maintenance check.")
        setup_pipeline("gold_std", cfg_goldstd, None, device=device)
    goldstd_var = load_gold_std(cfg_goldstd.pickle_path)
    if goldstd_var is None:
        # corrupt ≈ missing: a None baseline would silently skip the compare
        logging.error(
            "Gold-standard pickle %s is unreadable — rebuilding the gold baseline.",
            cfg_goldstd.pickle_path,
        )
        setup_pipeline("gold_std", cfg_goldstd, None, device=device)
        goldstd_var = load_gold_std(cfg_goldstd.pickle_path)
        if goldstd_var is None:
            raise RuntimeError(
                f"gold pickle {cfg_goldstd.pickle_path} is unreadable even "
                "after rebuilding the gold baseline"
            )
    logging.info("Fetched Gold-Std. Data.")
    logging.info("Executing maintenance check.")
    setup_pipeline(args.data, cfg, cfg_goldstd, goldstd_var=goldstd_var, device=device)


def _barrier() -> None:
    """Wait for the other ranks, inside a world."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _rank_main(mesh, argv: list) -> None:
    """One rank of a world the CLI started: the same command, in the world."""
    main(argv)


if __name__ == "__main__":
    main()
