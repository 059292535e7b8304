"""The port's sweep driver (``tools/sweep.py``, ``tools/init_sweep.py`` and
its copies of the bundled configs) against the JAX package's on the CPU:
the mini YAML parser (the card's machine has no PyYAML) against
``yaml.safe_load``; the grid, random, ``bayes`` and hyperband trial
sequences for one seed against the JAX driver's, on a synthetic objective;
a two-trial FR sweep through the port's ``run_fr`` (``--device cpu``) whose
every trial returns its objective; a failed trial; and ``init_sweep``'s
fallback without wandb.

Tolerance: none; the trial sequences are numpy draws from the same seeded
generator and are held equal."""
import glob
import json
import math
import os

import numpy as np
import pytest
import yaml

from nerf_qa_torch.tools import init_sweep as tinit
from nerf_qa_torch.tools import sweep as tsweep
from nerf_qa_tpu.tools import sweep as jsweep
from nerf_qa_tpu.tools.make_synthetic_dataset import make_fr_tree

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(tsweep.__file__), "..",
                                        "configs", "*.yaml")))


def test_bundled_configs_are_the_jax_ones_with_the_ports_program():
    assert [os.path.basename(p) for p in CONFIGS] == ["sweep-fr-logistic.yaml",
                                                      "sweep-nr.yaml"]
    for path in CONFIGS:
        got = yaml.safe_load(open(path))
        want = yaml.safe_load(open(path.replace("nerf_qa_torch", "nerf_qa_tpu")))
        assert got["program"] == want["program"].replace("nerf_qa_tpu", "nerf_qa_torch")
        assert {k: v for k, v in got.items() if k != "program"} == \
            {k: v for k, v in want.items() if k != "program"}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_mini_yaml_reads_the_bundled_configs_as_pyyaml(path):
    assert tsweep._mini_yaml(path) == yaml.safe_load(open(path))


@pytest.mark.parametrize("text", ["1e-7", "1.0e-7", "1.0e+7", "0.9", "10", "-5", "+3",
                                  "1_000", "true", "off", "Yes", "~", "null", '"x y"',
                                  "'relu'", "[2, 3]", '["", "relu", "w_sum_detach"]',
                                  "[]", ".inf", "-.inf", "abc", "q_log_uniform_values"])
def test_mini_yaml_scalars_resolve_as_pyyaml(text):
    assert tsweep._yaml_value(text) == yaml.safe_load(f"k: {text}")["k"]


def test_mini_yaml_block_lists_and_nesting(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("method: grid\nparameters:\n  depth:\n    values:\n      - 2\n"
                    "      - 3\n  norm:\n    value: relu  # a comment\n"
                    "early_terminate:\n  type: hyperband\n  min_iter: 1\n")
    assert tsweep._mini_yaml(str(path)) == yaml.safe_load(path.read_text())


def _objective(params):
    """A deterministic objective of every kind of parameter the configs
    hold (a grid passes a min/max spec through as its dict: 0 then)."""
    def num(name, default):
        v = params.get(name, default)
        return 0.0 if isinstance(v, dict) else float(v)

    return -(math.log10(num("lr", 1e-4) or 1e-4) + 4.0) ** 2 + 0.1 * num("gamma", 0.9) \
        + 0.05 * ["", "relu", "w_sum_detach"].index(params.get("dists_weight_norm", ""))


@pytest.mark.parametrize("method", ["grid", "random", "bayes", "hyperband"])
def test_trial_sequence_matches_jax(method, tmp_path):
    config = yaml.safe_load(open(CONFIGS[0]))
    if method == "hyperband":
        config["early_terminate"] = {"type": "hyperband", "min_iter": 1, "max_iter": 9}
    else:
        config["method"] = method
    hist = {}
    for pkg, run in (("jax", jsweep.run_sweep), ("port", tsweep.run_sweep)):
        hist[pkg] = run(config, lambda p, d: _objective(p), max_trials=8,
                        output_dir=str(tmp_path / pkg), seed=3)
        with open(tmp_path / pkg / "history.jsonl") as f:
            assert [json.loads(line) for line in f] == json.loads(json.dumps(hist[pkg]))
    assert hist["port"] == hist["jax"]
    assert len(hist["port"]) >= (3 if method == "grid" else 8)


def test_bayes_beats_random_on_a_quadratic():
    params = {"x": {"min": 0.0, "max": 1.0, "distribution": "uniform"}}
    sampler = tsweep.BayesSampler(params, np.random.default_rng(0), maximize=False,
                                  n_seed=4)
    best = math.inf
    for _ in range(16):
        trial = sampler.propose()
        value = (trial["x"] - 0.3) ** 2
        sampler.observe(trial, value)
        best = min(best, value)
    assert best < 1e-3


@pytest.fixture(scope="module")
def fr_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep_fr"))
    return root, make_fr_tree(root, scenes=("lego", "truck", "ship", "room"),
                              methods_per_scene=2, frames=2, hw=(48, 64), seed=1,
                              dists_col=False)


def test_fr_sweep_through_run_fr(fr_tree, tmp_path):
    root, scores = fr_tree
    config = yaml.safe_load(open(CONFIGS[0]))
    config["parameters"]["epochs"] = {"value": 1}
    config["parameters"]["regression_type"] = {"value": "linear"}
    path = tmp_path / "fr.yaml"
    path.write_text(yaml.safe_dump(config))
    hist = tsweep.main(["--config", str(path), "--target", "fr", "--max-trials", "2",
                        "--output-dir", str(tmp_path / "sweep"), "--base-args",
                        "--data-dir", root, "--scores-csv", scores, "--device", "cpu",
                        "--num-workers", "0", "--folds", "2", "--batch-size", "4",
                        "--cache-stats"])
    assert len(hist) == 2
    for h in hist:
        assert h["objective"] is not None and math.isfinite(h["objective"]), h
        assert os.path.exists(tmp_path / "sweep" / f"trial_{h['trial']:03d}" / "metrics.jsonl")


def test_failed_trial_scores_none(tmp_path, capsys):
    config = {"method": "grid", "metric": {"name": "m", "goal": "maximize"},
              "parameters": {"epochs": {"value": 1}}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(config))
    hist = tsweep.main(["--config", str(path), "--target", "fr", "--max-trials", "1",
                        "--output-dir", str(tmp_path / "s"), "--base-args",
                        "--data-dir", str(tmp_path), "--scores-csv",
                        str(tmp_path / "absent.csv"), "--device", "cpu"])
    assert hist == [{"trial": 0, "params": {"epochs": 1}, "objective": None}]
    assert "trial failed" in capsys.readouterr().out


def test_init_sweep_without_wandb_points_at_the_local_driver(capsys):
    assert tinit.init_sweep(CONFIGS[0]) is None
    err = capsys.readouterr().err
    assert "wandb not installed" in err and "nerf_qa_torch.tools.sweep" in err
