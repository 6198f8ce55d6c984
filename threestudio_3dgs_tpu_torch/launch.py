"""CLI entry point, mirroring the JAX package's launcher:

    python -m threestudio_3dgs_tpu_torch.launch --config <yaml> --train [key=value ...]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without that flag it raises rather than carry on on the CPU.  ``--train``
runs ``Trainer.fit`` (from ``--resume``'s checkpoint when given) and then
the test renders; with ``--profile`` as well, the training steps run
under ``utils/profiling.py`` ``device_trace``, a ``torch.profiler`` trace
of the first steps written to ``<trial_dir>/profile`` (rank 0 alone
traces under ``torchrun``; without ``--train`` the flag does nothing).
``--validate`` and ``--test`` render the state of
``--resume``'s checkpoint, or a fresh init without one; ``--predict`` and
``--export`` follow on the trained or loaded state.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the
environment, world size above 1) each process is one rank: the group is
initialised on NCCL with the rank on ``cuda:LOCAL_RANK``, or on gloo with
``--device cpu``, the trainer shards the camera batch over the ranks
(``trainer.devices``), rank 0 alone writes, and the group is destroyed at
the end:

    torchrun --nproc-per-node N -m threestudio_3dgs_tpu_torch.launch --config <yaml> --train

A run without ``torchrun`` is unchanged."""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU"
        )
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(description="threestudio_3dgs_tpu_torch launcher")
    parser.add_argument("--config", required=True)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--export", action="store_true")
    parser.add_argument("--predict", action="store_true")
    parser.add_argument("--resume", default=None, help="a port checkpoint (.ckpt.npz)")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    parser.add_argument("--gpu", default=None, help="ignored (compat)")
    parser.add_argument(
        "--profile", action="store_true",
        help="capture a torch.profiler device trace of the first training steps",
    )
    parser.add_argument("overrides", nargs="*", help="dotlist key=value overrides")
    args = parser.parse_args(argv)

    from .parallel.mesh import initialize_distributed
    from .utils.config import load_config

    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", 1))
    owns_group = False
    if world > 1:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        owns_group = initialize_distributed("nccl" if device.type == "cuda" else "gloo")
    try:
        return _run(args, load_config(args.config, args.overrides), device)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, cfg, device):
    from .trainer import Trainer

    if args.resume:
        cfg.resume = args.resume
    if dist.is_initialized() and dist.get_world_size() > 1:
        # one trial directory for every rank: rank 0's timestamp
        stamp = [cfg.timestamp]
        dist.broadcast_object_list(stamp, src=0)
        cfg.timestamp = stamp[0]
        cfg.set_dirs()
    trainer = Trainer(cfg, device=device)
    if args.train:
        if args.profile and trainer.rank == 0:
            from .utils.profiling import device_trace

            with device_trace(os.path.join(cfg.trial_dir, "profile"), device) as prof:
                trainer.fit(resume=cfg.resume, on_step=prof.step)
        else:
            trainer.fit(resume=cfg.resume)
        trainer.test()
    elif args.validate or args.test or args.predict or args.export:
        trainer.load_state(cfg.resume)
        if args.validate:
            trainer.validate()
        elif args.test:
            trainer.test()
    if args.predict:
        trainer.predict()
    if args.export:
        trainer.export()
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
