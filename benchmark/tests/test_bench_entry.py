"""The entry point: without a card a run fails and prints no result; on a
card (marked `card`, skipped without one) a short run prints a correct
result line whose last key holds the numbers compared."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

REPO = harness.HERE.parent


def _run(*args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, cwd=str(REPO), timeout=timeout)


def test_without_a_card_a_run_fails_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    r = _run("--workload", "flagship-still", "--seed", "1", "--seconds", "1", "--trace", "0",
             timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


@pytest.mark.card
def test_short_run_on_the_card(card):
    r = _run("--workload", "heavy10k-bounce", "--seed", "2147483711", "--seconds", "3",
             "--trace", "0")
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], r.stderr[-2000:]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
