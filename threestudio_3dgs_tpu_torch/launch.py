"""CLI entry point, mirroring the JAX package's launcher:

    python -m threestudio_3dgs_tpu_torch.launch --config <yaml> --train [key=value ...]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without that flag it raises rather than carry on on the CPU.  ``--train``
runs ``Trainer.fit`` (from ``--resume``'s checkpoint when given) and then
the test renders.  ``--validate`` and ``--test`` render the state of
``--resume``'s checkpoint, or a fresh init without one; ``--predict`` and
``--export`` follow on the trained or loaded state."""

from __future__ import annotations

import argparse

import torch


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
    parser.add_argument("overrides", nargs="*", help="dotlist key=value overrides")
    args = parser.parse_args(argv)

    from .trainer import Trainer
    from .utils.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    if args.resume:
        cfg.resume = args.resume
    trainer = Trainer(cfg, device=device)
    if args.train:
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
    return trainer


if __name__ == "__main__":
    main()
