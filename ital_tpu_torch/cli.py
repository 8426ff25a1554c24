"""Command line of the port (``ital-tpu-torch`` console script, ``python -m ital_tpu_torch.cli``).

The same arguments as ``ital_tpu.cli`` (an .ini config plus
``SECTION.key=value`` overrides), plus ``--device``::

    python -m ital_tpu_torch.cli configs/toy.ini --device cpu
    python -m ital_tpu_torch.cli configs/mirflickr.ini EXPERIMENT.method=emoc

``--device`` defaults to ``cuda``; without a CUDA device that fails, it
never runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ital-tpu-torch",
        description="Run a simulated-feedback retrieval/regression experiment "
                    "with the PyTorch port.",
    )
    parser.add_argument("config", nargs="?", default=None, help=".ini config file")
    parser.add_argument("overrides", nargs="*", help="SECTION.key=value overrides")
    parser.add_argument("--list-strategies", action="store_true")
    parser.add_argument("--list-datasets", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    # With no config file, argparse binds the first override to ``config``.
    if args.config and "=" in args.config and "." in args.config.split("=", 1)[0]:
        args.overrides = [args.config, *args.overrides]
        args.config = None

    if args.list_strategies:
        from ital_tpu_torch.select import STRATEGIES

        print("\n".join(sorted(STRATEGIES)))
        return 0
    if args.list_datasets:
        from ital_tpu_torch.data.datasets import _FACTORIES

        print("\n".join(sorted(_FACTORIES)))
        return 0

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     f"(pass --device cpu to run on the CPU)")

    from ital_tpu_torch.runner import run_experiment, run_regression_experiment
    from ital_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, tuple(args.overrides))
    if cfg.task == "regression":
        result = run_regression_experiment(cfg, device=device)
        print(f"# dataset={result['dataset']} method={result['method']} "
              f"device={result['device']}")
        print("round  RMSE")
        for rnd, m in enumerate(result["mean_rmse"]):
            print(f"{rnd + 1:5d}  {m:.4f}")
        return 0

    result = run_experiment(cfg, device=device)
    print(f"# dataset={result['dataset']} method={result['method']} "
          f"sessions={len(result['sessions'])} device={result['device']}")
    print(f"# mean select {result['select_ms']:.2f} ms/round, "
          f"update+rank+AP {result['update_ms']:.2f} ms/round")
    print("round  MAP")
    for rnd, m in enumerate(result["map"]):
        print(f"{rnd + 1:5d}  {m:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
