"""The command line: it refuses to run without a card
and prints no result; on a card (marker ``cuda``) one small cell runs and
is correct."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

ARGS = ["--workload", "dists-256-b16", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    return proc.returncode != 0 and not any(
        line.startswith("{") for line in proc.stdout.splitlines())


def test_exits_non_zero_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(ARGS) != 0


def test_command_prints_no_result_here_or_without_the_program(tmp_path):
    assert _no_result(_run(harness.REPO))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_run(tmp_path))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    small = {"batch": 4, "pool_batches": 2, "trace_steps": 2}
    result, _ = harness.run_cell("dists-256-b16", 2**31 + 11, 1.0, True,
                                 time.perf_counter(), "cuda", small)
    assert result["correct"] and result["device"]["busy_s"] > 0
    json.dumps(result)
