"""A cell on the card, at the cell's own size, as the benchmark runs it
(``python -m pytest portbench/tests -q -m card`` on the chip). Skips here
without a CUDA device."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mistral-7b-lora-sft",
                                  "mixtral-8x7b-l16-lora-sft"])
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
