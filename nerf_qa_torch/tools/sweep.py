"""Hyperparameter sweep driver.

Counterpart of ``nerf_qa_tpu/tools/sweep.py``. Reference behavior: wandb
sweeps — 9 YAML configs (wandb/*.yaml) with bayes/random/grid methods over
lr/betas/eps/epochs/weight-norm/... and logger-metric objectives (e.g.
'Test Metrics Dict/combined_score'); scripts/init_sweep.sh registers them;
control.py mutates a live sweep.

This driver reads the SAME YAML schema (method, metric, parameters with
values/min/max/distribution) and runs trials locally: grid enumerates,
random samples, 'bayes' runs a Gaussian-process expected-improvement
optimizer over the normalised parameter space, and a config with
``early_terminate: {type: hyperband}`` runs successive halving. Each trial
calls the port's ``run_fr.main`` or ``train_nr.main`` (``--target``) with
``--key value`` overrides and reads the objective from the trial's
metrics.jsonl. A trial that raises prints "trial failed" and scores None.

Without PyYAML (the card's machine has none) the configs are read by
``_mini_yaml``, which resolves the plain scalars of the sweep-config subset
as PyYAML's ``safe_load`` does (YAML 1.1: ``1e-7`` without a dot is a
string) and reads flow sequences (``[2, 3]``).

Usage:
  python -m nerf_qa_torch.tools.sweep \\
      --config nerf_qa_torch/configs/sweep-fr-logistic.yaml --target fr \\
      --max-trials 20 --base-args --data-dir <Test2 root> --scores-csv ...
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import traceback
from typing import Any, Callable

import numpy as np


def load_yaml(path: str) -> dict:
    try:
        import yaml
    except ImportError:
        return _mini_yaml(path)
    with open(path) as f:
        return yaml.safe_load(f)


def _mini_yaml(path: str) -> dict:
    """Tiny indentation-based parser covering wandb sweep configs."""
    root: dict = {}
    stack: list[tuple[int, Any]] = [(-1, root)]
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.strip().startswith("#"):
                continue
            indent = len(line) - len(line.lstrip())
            while stack and stack[-1][0] >= indent:
                stack.pop()
            parent = stack[-1][1]
            content = line.strip()
            if content.startswith("- "):
                item = _yaml_value(content[2:])
                if isinstance(parent, dict) and "__list__" not in parent:
                    parent["__list__"] = []
                parent["__list__"].append(item)
                continue
            if ":" in content:
                key, _, val = content.partition(":")
                key, val = key.strip(), val.strip()
                if val:
                    parent[key] = _yaml_value(val)
                else:
                    child: dict = {}
                    parent[key] = child
                    stack.append((indent, child))
    return _fold_lists(root)


def _fold_lists(node):
    if isinstance(node, dict):
        if set(node) == {"__list__"}:
            return [_fold_lists(v) for v in node["__list__"]]
        return {k: _fold_lists(v) for k, v in node.items()}
    return node


# PyYAML's YAML 1.1 resolvers for the plain scalars a sweep config holds
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_YAML_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_YAML_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                                "on", "On", "ON")}
_YAML_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                      "FALSE", "off", "Off", "OFF")})


def _yaml_value(s: str):
    """One flow value: a quoted string, a flow sequence or a plain
    scalar, resolved as ``yaml.safe_load`` resolves it."""
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_yaml_value(v) for v in inner.split(",")] if inner else []
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    s = s.split(" #", 1)[0].strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if _YAML_INT.fullmatch(s):
        return int(s.replace("_", ""))
    if _YAML_FLOAT.fullmatch(s):
        low = s.lower()
        if low.endswith(".nan"):
            return float("nan")
        if low.endswith(".inf"):
            return float("-inf") if s.startswith("-") else float("inf")
        return float(s.replace("_", ""))
    return s


def _parse_scalar(s: str):
    """A ``--set`` value of init_sweep's control (int, float, bool or the
    string)."""
    s = s.strip().strip("'\"")
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def sample_parameters(params: dict, rng: np.random.Generator) -> dict:
    """One random draw from a wandb-style parameters block."""
    def num(v):
        # PyYAML parses '1e-8' (no dot) as a string — coerce
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return v
        return v

    out = {}
    for name, spec in params.items():
        if not isinstance(spec, dict):
            out[name] = spec
            continue
        if "value" in spec:
            out[name] = spec["value"]
        elif "values" in spec:
            out[name] = spec["values"][int(rng.integers(len(spec["values"])))]
        elif "min" in spec and "max" in spec:
            lo, hi = float(num(spec["min"])), float(num(spec["max"]))
            dist = spec.get("distribution", "")
            if "log" in dist:
                v = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            elif isinstance(spec["min"], int) and isinstance(spec["max"], int) \
                    and "uniform" not in dist:
                v = int(rng.integers(int(lo), int(hi) + 1))
            else:
                v = float(rng.uniform(lo, hi))
            q = num(spec.get("q"))
            if q:  # quantized distributions (q_log_uniform_values etc.)
                v = float(np.round(v / q) * q)
            out[name] = v
    return out


def grid_parameters(params: dict):
    keys, value_lists = [], []
    for name, spec in params.items():
        if isinstance(spec, dict) and "values" in spec:
            keys.append(name)
            value_lists.append(spec["values"])
        elif isinstance(spec, dict) and "value" in spec:
            keys.append(name)
            value_lists.append([spec["value"]])
        else:
            keys.append(name)
            value_lists.append([spec])
    for combo in itertools.product(*value_lists):
        yield dict(zip(keys, combo))


class BayesSampler:
    """Sequential GP/expected-improvement proposer over the wandb
    parameter space.

    Parameters encode to [0,1]^d (log-scaled where the distribution is
    log; categorical 'values' by index). A zero-mean RBF-kernel GP fits
    the observed (x, objective) pairs; each proposal maximizes EI over a
    random candidate pool. The first ``n_seed`` trials are random."""

    def __init__(self, params: dict, rng: np.random.Generator,
                 maximize: bool = True, n_seed: int = 5,
                 n_candidates: int = 256):
        self.params = params
        self.rng = rng
        self.maximize = maximize
        self.n_seed = n_seed
        self.n_candidates = n_candidates
        self.xs: list[np.ndarray] = []
        self.ys: list[float] = []

    # -- encoding ---------------------------------------------------------
    def _axes(self):
        for name, spec in self.params.items():
            if isinstance(spec, dict) and "values" in spec \
                    and len(spec["values"]) > 1:
                yield name, spec
            elif isinstance(spec, dict) and "min" in spec and "max" in spec:
                yield name, spec

    def encode(self, trial: dict) -> np.ndarray:
        x = []
        for name, spec in self._axes():
            v = trial[name]
            if "values" in spec:
                k = len(spec["values"])
                try:
                    idx = spec["values"].index(v)
                except ValueError:
                    idx = 0
                x.append(idx / max(k - 1, 1))
            else:
                lo, hi = float(spec["min"]), float(spec["max"])
                if "log" in str(spec.get("distribution", "")):
                    x.append((np.log(float(v)) - np.log(lo))
                             / max(np.log(hi) - np.log(lo), 1e-12))
                else:
                    x.append((float(v) - lo) / max(hi - lo, 1e-12))
        return np.asarray(x, np.float64)

    def observe(self, trial: dict, objective: float | None) -> None:
        if objective is None or not np.isfinite(objective):
            return
        y = float(objective) if self.maximize else -float(objective)
        self.xs.append(self.encode(trial))
        self.ys.append(y)

    # -- GP posterior + EI --------------------------------------------------
    @staticmethod
    def _kernel(a: np.ndarray, b: np.ndarray, ls: float = 0.25) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / ls**2)

    def propose(self) -> dict:
        if len(self.ys) < self.n_seed:
            return sample_parameters(self.params, self.rng)
        cands = [sample_parameters(self.params, self.rng)
                 for _ in range(self.n_candidates)]
        cx = np.stack([self.encode(c) for c in cands])
        tx = np.stack(self.xs)
        ty = np.asarray(self.ys)
        mu0, sd0 = ty.mean(), max(ty.std(), 1e-8)
        tyn = (ty - mu0) / sd0
        k_tt = self._kernel(tx, tx) + 1e-4 * np.eye(len(tx))
        k_ct = self._kernel(cx, tx)
        sol = np.linalg.solve(k_tt, tyn)
        mean = k_ct @ sol
        var = 1.0 - np.einsum(
            "ij,ji->i", k_ct, np.linalg.solve(k_tt, k_ct.T)
        )
        std = np.sqrt(np.clip(var, 1e-12, None))
        best = tyn.max()
        z = (mean - best) / std
        # EI = std * (z Phi(z) + phi(z))
        from scipy.special import erf

        phi = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        cdf = 0.5 * (1 + erf(z / np.sqrt(2)))
        ei = std * (z * cdf + phi)
        return cands[int(np.argmax(ei))]


def read_objective(metrics_jsonl: str, metric_name: str) -> float | None:
    """Last logged value of the objective metric from a JSONL sink."""
    if not os.path.exists(metrics_jsonl):
        return None
    value = None
    with open(metrics_jsonl) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if metric_name in rec:
                value = rec[metric_name]
    return value


def run_sweep_hyperband(
    config: dict,
    trial_fn: Callable[[dict, str], float | None],
    max_trials: int = 20,
    output_dir: str = "./sweep",
    seed: int = 0,
    eta: int = 3,
) -> list[dict]:
    """Successive-halving early termination (the reference's
    config-early.yaml uses wandb hyperband with min_iter). Trials start at
    ``early_terminate.min_iter`` epochs; the top 1/eta of each rung are
    promoted with eta x the budget until ``max_iter`` (or the config's
    'epochs' value) is reached. trial params carry an 'epochs' override
    the target trainer consumes."""
    os.makedirs(output_dir, exist_ok=True)
    et = config.get("early_terminate", {})
    min_iter = int(et.get("min_iter", 1))
    max_iter = int(et.get("max_iter",
                          config.get("parameters", {})
                          .get("epochs", {}).get("value", min_iter * eta**2)))
    goal = config.get("metric", {}).get("goal", "maximize")
    params = config.get("parameters", {})
    rng = np.random.default_rng(seed)
    sign = 1.0 if goal == "maximize" else -1.0

    survivors = [sample_parameters(params, rng) for _ in range(max_trials)]
    history: list[dict] = []
    budget = min_iter
    rung = 0
    tid = 0
    while survivors:
        scored = []
        for trial_params in survivors:
            trial_params = dict(trial_params, epochs=int(budget))
            trial_dir = os.path.join(output_dir, f"trial_{tid:03d}")
            os.makedirs(trial_dir, exist_ok=True)
            value = trial_fn(trial_params, trial_dir)
            rec = {"trial": tid, "rung": rung, "epochs": int(budget),
                   "params": trial_params, "objective": value}
            history.append(rec)
            with open(os.path.join(output_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"rung {rung} trial {tid} (epochs {budget}): "
                  f"{trial_params} -> {value}")
            if value is not None and np.isfinite(value):
                scored.append((sign * value, trial_params))
            tid += 1
        if budget >= max_iter or len(scored) <= 1:
            break
        scored.sort(key=lambda t: -t[0])
        keep = max(1, len(scored) // eta)
        survivors = [p for _, p in scored[:keep]]
        budget = min(budget * eta, max_iter)
        rung += 1
    best = max((h for h in history if h["objective"] is not None),
               key=lambda h: sign * h["objective"], default=None)
    if best:
        print("best:", best)
    return history


def run_sweep(
    config: dict,
    trial_fn: Callable[[dict, str], float | None],
    max_trials: int = 20,
    output_dir: str = "./sweep",
    seed: int = 0,
) -> list[dict]:
    """Run trials; trial_fn(params, trial_dir) returns the objective.
    Returns the trial history in trial order (the best is printed)."""
    if config.get("early_terminate", {}).get("type") == "hyperband":
        return run_sweep_hyperband(config, trial_fn, max_trials,
                                   output_dir, seed)
    os.makedirs(output_dir, exist_ok=True)
    method = config.get("method", "random")
    metric = config.get("metric", {})
    goal = metric.get("goal", "maximize")
    params = config.get("parameters", {})
    rng = np.random.default_rng(seed)

    sampler = None
    if method == "grid":
        trials = list(itertools.islice(grid_parameters(params), max_trials))
    elif method == "bayes":
        sampler = BayesSampler(params, rng, maximize=goal == "maximize")
        trials = None  # proposed sequentially from the GP posterior
    else:  # random
        trials = [sample_parameters(params, rng) for _ in range(max_trials)]

    history = []
    for i in range(max_trials if trials is None else len(trials)):
        trial_params = sampler.propose() if sampler else trials[i]
        trial_dir = os.path.join(output_dir, f"trial_{i:03d}")
        os.makedirs(trial_dir, exist_ok=True)
        value = trial_fn(trial_params, trial_dir)
        if sampler:
            sampler.observe(trial_params, value)
        history.append({"trial": i, "params": trial_params, "objective": value})
        with open(os.path.join(output_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(history[-1]) + "\n")
        print(f"trial {i}: {trial_params} -> {value}")
    scored = [h for h in history if h["objective"] is not None]
    reverse = goal == "maximize"
    scored.sort(key=lambda h: h["objective"], reverse=reverse)
    if scored:
        print("best:", scored[0])
    return history


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description="Local sweep driver")
    p.add_argument("--config", required=True, help="wandb-style sweep YAML")
    p.add_argument("--max-trials", type=int, default=20)
    p.add_argument("--output-dir", default="./sweep")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target", default="fr", choices=["fr", "nr"])
    p.add_argument("--base-args", nargs=argparse.REMAINDER, default=[],
                   help="args passed through to the target trainer")
    args = p.parse_args(argv)
    config = load_yaml(args.config)
    metric_name = config.get("metric", {}).get("name",
                                               "Test Metrics Dict/combined_score")

    if args.target == "fr":
        from nerf_qa_torch.tools.run_fr import main as target_main
    else:
        from nerf_qa_torch.tools.train_nr import main as target_main

    def trial_fn(params: dict, trial_dir: str):
        argv = list(args.base_args)
        for k, v in params.items():
            argv += [f"--{k.replace('_', '-')}", str(v)]
        argv += ["--output-dir", trial_dir]
        try:
            target_main(argv)
        except SystemExit:
            pass
        except Exception as exc:  # a failed trial scores None; the sweep goes on
            traceback.print_exc()
            print("trial failed:", exc)
            return None
        return read_objective(os.path.join(trial_dir, "metrics.jsonl"),
                              metric_name)

    return run_sweep(config, trial_fn, args.max_trials, args.output_dir, args.seed)


if __name__ == "__main__":
    main()
