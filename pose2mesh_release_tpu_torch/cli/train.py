"""Training CLI.

Reference: main/train.py:10-62.  Same flags as the JAX package's
(--cfg, --resume_training, --debug, --seed; --gpu is accepted and ignored),
plus --device (default cuda; cpu runs the kernels' plain versions).  The
epoch loop with per-epoch eval, checkpointing, best tracking and loss plots
lives in core.engine.Trainer.fit.

Usage: python -m pose2mesh_release_tpu_torch.cli.train --cfg x.json [--device cpu]
On a mesh (cfg TPU.data_axis x TPU.graph_axis = N devices), one process each:
    torchrun --nproc_per_node N -m pose2mesh_release_tpu_torch.cli.train --cfg x.json
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Pose2Mesh (PyTorch/CUDA)")
    p.add_argument("--cfg", type=str, default=None, help="experiment file (.json or .yml)")
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--gpu", type=str, default="", help="ignored (see --device)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..config import load_config
    from ..parallel.distributed import init_distributed

    # under torchrun: join the process group before the engine builds its mesh
    init_distributed(device=args.device)
    from ..core.engine import LiftTester, LiftTrainer, Trainer

    cfg = load_config(args.cfg)
    if args.seed is not None:
        cfg.seed = args.seed
        np.random.seed(args.seed)
    cfg.make_dirs()

    if cfg.MODEL.name == "pose2mesh_net":
        trainer = Trainer(cfg, resume=args.resume_training, debug=args.debug,
                          device=args.device)
        result = trainer.fit()
    else:  # posenet
        trainer = LiftTrainer(cfg, debug=args.debug, device=args.device)
        tester = LiftTester(cfg, debug=args.debug, device=args.device) \
            if cfg.DATASET.test_list else None
        best = float("inf")
        result = {}
        for epoch in range(1, cfg.TRAIN.end_epoch + 1):
            loss = trainer.train_epoch(epoch)
            result = {"loss": loss}
            crit = loss
            if tester is not None and tester.dataset is not None:
                ev = tester.test(epoch, state=trainer.state)
                result.update(ev)
                crit = ev.get("mpjpe", loss)
            is_best = crit < best
            best = min(best, crit)
            trainer.save(epoch, is_best=is_best)
            if trainer.primary:
                print(f"epoch {epoch}: loss {loss:.4f}" + (" (best)" if is_best else ""))
    if trainer.primary:
        print("training done:", result)
    return result


if __name__ == "__main__":
    main()
