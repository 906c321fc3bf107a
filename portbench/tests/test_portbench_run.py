"""``portbench/run.py`` without a card, and without the program: it fails
by name, prints no result and exits with another code than 0. Whether
there is a card is decided in each test, never at import."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
COMMAND = [sys.executable, "portbench/run.py", "--workload", "serve-10k-50", "--seed", "2147483659",
           "--seconds", "1", "--trace", "0"]


def test_without_a_card_the_run_fails_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure it")
    done = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 3
    assert done.stdout == ""
    assert "needs 1 CUDA card(s)" in done.stderr and "never falls back to the CPU" in done.stderr


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(COMMAND, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode not in (0,)
    assert done.stdout == ""
    assert "assistedmanipulation_tpu_torch, is not in" in done.stderr


def test_an_unknown_workload_is_refused():
    done = subprocess.run(COMMAND[:3] + ["no-such-cell"] + COMMAND[4:], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == "" and "no workload 'no-such-cell'" in done.stderr
