"""wandb sweep registration + live-sweep control shim.

Counterpart of ``nerf_qa_tpu/tools/init_sweep.py``.

Reference behavior: scripts/init_sweep.sh registers a sweep config with
``wandb sweep`` (then agents pull trials); control.py mutates a live
sweep's parameter ranges via the wandb API (control.py:6-19).

When wandb is installed this registers the YAML and prints the agent
command; without wandb it falls back to the local GP/bayes driver
(tools/sweep.py) so the same config runs anywhere (the card's machine
has no wandb).

Usage:
  python -m nerf_qa_torch.tools.init_sweep \\
      --config nerf_qa_torch/configs/sweep-fr-logistic.yaml \\
      [--project nerf-qa-2] [--entity ...]
  python -m nerf_qa_torch.tools.init_sweep --control <sweep_id> \\
      --set parameters.lr.max=1e-3   # control.py equivalent
"""
from __future__ import annotations

import argparse
import sys

from nerf_qa_torch.tools.sweep import _parse_scalar, load_yaml


def init_sweep(config_path: str, project: str = "nerf-qa-2",
               entity: str | None = None) -> str | None:
    config = load_yaml(config_path)
    try:
        import wandb
    except ImportError:
        print("wandb not installed — run the local driver instead:\n"
              f"  python -m nerf_qa_torch.tools.sweep --config {config_path} "
              "--target fr --base-args ...", file=sys.stderr)
        return None
    sweep_id = wandb.sweep(config, project=project, entity=entity)
    print(f"sweep registered: {sweep_id}")
    print(f"run agents with: wandb agent "
          f"{(entity + '/') if entity else ''}{project}/{sweep_id}")
    return sweep_id


def control_sweep(sweep_id: str, sets: list[str], project: str,
                  entity: str | None = None) -> None:
    """Mutate a live sweep's config (control.py:6-19): each --set is a
    dotted path assignment, e.g. parameters.lr.max=1e-3."""
    import wandb

    api = wandb.Api()
    path = f"{entity}/{project}/{sweep_id}" if entity else \
        f"{project}/{sweep_id}"
    sweep = api.sweep(path)
    config = dict(sweep.config)
    for assignment in sets:
        dotted, _, value = assignment.partition("=")
        node = config
        keys = dotted.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _parse_scalar(value)
    sweep.config = config
    sweep.save()
    print(f"updated {path}: {sets}")


def main(argv=None):
    p = argparse.ArgumentParser(description="wandb sweep init/control shim")
    p.add_argument("--config", help="sweep YAML to register")
    p.add_argument("--control", help="live sweep id to mutate")
    p.add_argument("--set", action="append", default=[],
                   help="dotted config assignment (with --control)")
    p.add_argument("--project", default="nerf-qa-2")
    p.add_argument("--entity", default=None)
    args = p.parse_args(argv)
    if args.control:
        control_sweep(args.control, args.set, args.project, args.entity)
    elif args.config:
        init_sweep(args.config, args.project, args.entity)
    else:
        p.error("need --config or --control")


if __name__ == "__main__":
    main()
