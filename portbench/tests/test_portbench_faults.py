"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped, the rest of a run is driven at
test size on the CPU, and the fault is planted in the program."""

import pytest

from conftest import tiny_serve_traffic

BF16_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.05, "update_gap": 0.05}


def test_sound_run_is_correct(tiny):
    from portbench.drivers import train_sft

    assert train_sft.run(tiny("dense", "bfloat16", limits=BF16_LIMITS),
                         "cpu")["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    from kubeflow_rm_tpu_torch.training import optim
    from portbench.drivers import train_sft

    monkeypatch.setattr(optim.Optimizer, "update_leaf",
                        lambda self, *a, **k: None)
    res = train_sft.run(tiny("dense", "bfloat16", limits=BF16_LIMITS), "cpu")
    assert not res["correct"]
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_fails(tiny, monkeypatch):
    from kubeflow_rm_tpu_torch.training import train
    from portbench.drivers import train_sft

    real = train.loss_fn

    def half(params, batch, cfg, *a, **k):
        rows = batch["tokens"].shape[0] // 2
        return real(params, {n: t[:rows] for n, t in batch.items()}, cfg,
                    *a, **k)

    monkeypatch.setattr(train, "loss_fn", half)
    res = train_sft.run(tiny("dense", "bfloat16", limits=BF16_LIMITS), "cpu")
    assert not res["correct"]
    assert res["checks"]["grad_gap"]["value"] > BF16_LIMITS["grad_gap"]


def test_a_token_altered_where_it_is_produced_fails(tiny, monkeypatch):
    from kubeflow_rm_tpu_torch.models.generate import ContinuousBatchingEngine
    from portbench.drivers import serve_open_loop

    real = ContinuousBatchingEngine._sample

    def altered(self):
        picks = real(self)
        return {i: (t + 1) % self.cfg.vocab_size for i, t in picks.items()}

    monkeypatch.setattr(ContinuousBatchingEngine, "_sample", altered)
    cell = tiny(job=tiny_serve_traffic(), seconds=2.0)
    res = serve_open_loop.run(cell, "cpu")
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > 0.5


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_the_control_and_the_half_batch_read_above_the_program(tiny, kind):
    """The control (the reference in fp8, its adapters kept in fp8, put
    in the program's place) and the half-batch fault read against the
    float32 reference at test size, as ``portbench.calibrate`` reads them
    at the cells' size on the chip: the control's update and the fault's
    gradient lie well above a bf16 program's."""
    from portbench import compare
    from portbench.drivers import train_sft

    cell = tiny(kind, "bfloat16")
    cfg, state, W, feed = train_sft.build(cell, "cpu")
    prog = train_sft.checked_steps(cell, cfg, state, W, feed)
    ref = train_sft.reference(cell, "cpu")
    low = train_sft.reference(cell, "cpu", precision="fp8")
    half = train_sft.reference(cell, "cpu", rows=slice(0, 1))
    p = compare.train_numbers(prog, ref)
    assert compare.train_numbers(low, ref)["update_gap"] > 3 * p["update_gap"]
    assert compare.train_numbers(half, ref)["grad_gap"] > 10 * p["grad_gap"]
