"""Fixtures of the benchmark's own tests (run from the repository root:
``python -m pytest portbench/tests -q``; the ones marked ``card`` run only
where a CUDA device is, and are the chip's).

``tiny`` builds a cell at test size: a 2-layer model of the configured
family with the real traffic files' parameters scaled down."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this test runs on the chip")
    return "cuda"


TINY = {"model_type": "mistral", "vocab_size": 256, "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 128,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 512, "sliding_window": None}
TINY_MOE = dict(TINY, model_type="mixtral", num_local_experts=4,
                num_experts_per_tok=2, router_aux_loss_coef=0.02,
                assumed={"capacity_factor": 1.25})


def traffic(name: str) -> dict:
    with open(ROOT / "portbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def tiny_train_traffic() -> dict:
    t = traffic("lora-sft-4k")
    t.update(seq_len=128, doc_length={"min": 8, "max": 128}, lora_rank=4,
             profiled_steps=1)
    return t


def tiny_serve_traffic() -> dict:
    t = traffic("docqa-open-loop")
    t.update(slots=4, slot_len=160, num_blocks=64, rate=8.0, horizon_s=1,
             drain_s=10, checked_tokens=40, profile_s=1)
    t["sessions"].update(doc_length={"min": 32, "max": 96},
                         answer_length={"min": 4, "max": 16},
                         ask_gap_mean_s=0.3,
                         question_length={"min": 4, "max": 16})
    return t


@pytest.fixture
def tiny():
    from portbench.arch import arch_of
    from portbench.run import Cell

    def make(kind="dense", dtype="float32", job=None, limits=None,
             seconds=1.0, seed=2**31 + 7):
        conf = dict(TINY_MOE if kind == "moe" else TINY, torch_dtype=dtype)
        job = job or tiny_train_traffic()
        if limits is None:
            limits = ({"logit_gap": 0.5} if job["driver"] == "serve_open_loop"
                      else {"loss_gap": 0.05, "grad_gap": 0.05,
                            "update_gap": 0.05})
        return Cell(name="tiny", arch=arch_of("tiny", conf),
                    traffic=job, limits=limits, seed=seed, seconds=seconds,
                    trace=False, t_start=time.perf_counter())

    return make
