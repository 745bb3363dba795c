"""The plain reference against the port at test size on the CPU: in
float32 both compute the same function, so the numbers that decide
``correct`` are at rounding; in bf16 the program's own rounding shows."""

import pytest

from conftest import tiny_serve_traffic


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_training_reference_follows_the_port_in_float32(tiny, kind):
    from portbench.drivers import train_sft

    res = train_sft.run(tiny(kind), "cpu")
    n = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"] and res["attempted"] > 0
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5
    # Adam's first moment is kept in bf16 by the program: its rounding
    # moves the second and third updates by about a thousandth
    assert n["update_gap"] < 5e-3


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_training_in_bf16_stays_within_the_placeholder_limits(tiny, kind):
    from portbench.drivers import train_sft

    res = train_sft.run(tiny(kind, "bfloat16"), "cpu")
    assert res["correct"], res["checks"]


def test_serving_reference_matches_the_engine_in_float32(tiny):
    from portbench.drivers import serve_open_loop

    cell = tiny(job=tiny_serve_traffic(), seconds=2.0)
    res = serve_open_loop.run(cell, "cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["detail"]["checked_tokens"] >= 40
    assert res["readings"]["prompt_tokens"] > res["readings"]["prefix_hits"] > 0
