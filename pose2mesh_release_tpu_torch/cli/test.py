"""Evaluation CLI.

Reference: main/test.py:10-33: load cfg + weights, run Tester/LiftTester.
Same flags as the JAX package's, plus --device (default cuda).

Usage: python -m pose2mesh_release_tpu_torch.cli.test --cfg x.json [--weights p.pth.tar]
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate Pose2Mesh (PyTorch/CUDA)")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--weights", type=str, default="",
                   help="checkpoint path (defaults to cfg.TEST.weight_path)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--gpu", type=str, default="", help="ignored (see --device)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..config import load_config
    from ..core.engine import LiftTester, Tester

    cfg = load_config(args.cfg)
    cfg.make_dirs()
    weights = args.weights or cfg.TEST.weight_path

    if cfg.MODEL.name == "pose2mesh_net":
        tester = Tester(cfg, load_path=weights, debug=args.debug, device=args.device)
    else:
        tester = LiftTester(cfg, load_path=weights, debug=args.debug, device=args.device)
    result = tester.test(0)
    print("evaluation done:", result)
    return result


if __name__ == "__main__":
    main()
