"""The port's stdlib WSGI server on the CPU with the tiny preset:
health, generation through the batcher equal to ``generate_fused`` on
the same padded batch, concurrent requests coalescing into one batch,
the JAX server's 400 rules, and the ``speculative`` route (taken only
for solo, greedy, unpadded prompts longer than ``LOOKUP_N``; its tokens
equal the plain path's)."""

import threading

import numpy as np
import pytest
import torch

from kubeflow_rm_tpu_torch.models.generate import generate_fused
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params
from kubeflow_rm_tpu_torch import serve
from kubeflow_rm_tpu_torch.serve import main, make_app, request

NEW = 5


@pytest.fixture(scope="module")
def served():
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    app = make_app(cfg, params, max_new_tokens=NEW, window_ms=300.0,
                   max_batch=4, device="cpu")
    yield cfg, params, app
    app.batcher.close()


def _padded(prompts, T):
    ids = np.zeros((len(prompts), T), np.int32)
    for i, p in enumerate(prompts):
        ids[i, T - len(p):] = p
    return ids, np.asarray([T - len(p) for p in prompts], np.int32)


def test_healthz(served):
    _, _, app = served
    assert request(app, "GET", "/healthz") == (200, {"ok": True})


def test_generate_equals_generate_fused(served):
    cfg, params, app = served
    prompt = [3, 1, 4, 1, 5, 9, 2]
    status, out = request(app, "POST", "/generate", {"prompt": prompt})
    assert status == 200
    ids, pads = _padded([prompt], 16)
    ref = generate_fused(params, cfg, torch.from_numpy(ids),
                         max_new_tokens=NEW, max_len=16 + NEW,
                         pad_counts=torch.from_numpy(pads))
    assert out["tokens"] == ref[0, 16 - len(prompt):].tolist()
    assert len(out["tokens"]) == len(prompt) + NEW


def test_concurrent_requests_share_one_batch(served):
    cfg, params, app = served
    prompts = [[7] * 3, list(range(1, 18)), [42] * 9]
    results = [None] * len(prompts)
    before = app.batcher.batches_run

    def go(i):
        results[i] = request(app, "POST", "/generate", {"prompt": prompts[i]})

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert app.batcher.batches_run == before + 1
    # 3 requests -> 4 rows (a dummy), prompts bucketed to length 32
    ids, pads = _padded(prompts + [prompts[0]], 32)
    ref = generate_fused(params, cfg, torch.from_numpy(ids),
                         max_new_tokens=NEW, max_len=32 + NEW,
                         pad_counts=torch.from_numpy(pads))
    for i, (status, out) in enumerate(results):
        assert status == 200
        assert out["tokens"] == ref[i, 32 - len(prompts[i]):].tolist()


def test_sampling_request_returns_valid_tokens(served):
    cfg, _, app = served
    status, out = request(app, "POST", "/generate",
                          {"prompt": [1, 2], "temperature": 0.7, "top_k": 7})
    assert status == 200 and len(out["tokens"]) == 2 + NEW
    assert all(0 <= t < cfg.vocab_size for t in out["tokens"])


BAD = {
    "not_json": b"{nope",
    "empty_body": b"",
    "not_object": [1, 2, 3],
    "no_prompt": {"temperature": 0.0},
    "empty_prompt": {"prompt": []},
    "token_out_of_range": {"prompt": [1, 256]},
    "negative_token": {"prompt": [-1]},
    "float_token": {"prompt": [1.5]},
    "too_long": {"prompt": [1] * (128 - NEW + 1)},
    "temperature_high": {"prompt": [1], "temperature": 11},
    "temperature_string": {"prompt": [1], "temperature": "hot"},
    "top_k_zero": {"prompt": [1], "top_k": 0},
    "top_k_float": {"prompt": [1], "top_k": 2.5},
    "top_k_too_big": {"prompt": [1], "top_k": 257},
}


@pytest.mark.parametrize("name", list(BAD))
def test_bad_requests_are_400(served, name):
    _, _, app = served
    status, out = request(app, "POST", "/generate", BAD[name])
    assert status == 400 and "error" in out


def test_routing_errors(served):
    _, _, app = served
    assert request(app, "GET", "/generate")[0] == 405
    assert request(app, "POST", "/nope", {"prompt": [1]})[0] == 404


def test_make_app_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_app(LlamaConfig.tiny(), {}, max_new_tokens=1)


def test_main_selftest_on_cpu(capsys):
    assert main(["--preset", "tiny", "--device", "cpu", "--selftest",
                 "--max-new-tokens", "3"]) == 0
    assert "selftest ok: 6 tokens" in capsys.readouterr().out


def test_speculative_route_is_taken_and_equals_the_plain_path(served):
    cfg, params, app = served
    spec = make_app(cfg, params, max_new_tokens=NEW, window_ms=1.0,
                    max_batch=4, speculative=True, device="cpu")
    try:
        prompt = [7, 11, 13, 17] * 3
        status, out = request(spec, "POST", "/generate", {"prompt": prompt})
        assert status == 200 and spec.stats["speculative_requests"] == 1
        assert out == request(app, "POST", "/generate", {"prompt": prompt})[1]
        ref = generate_fused(params, cfg, torch.tensor([prompt],
                                                       dtype=torch.int32),
                             max_new_tokens=NEW)
        assert out["tokens"] == ref[0].tolist()
        # too short for the lookup, or sampled: the plain path
        for body in ({"prompt": [1, 2, 3]},
                     {"prompt": prompt, "temperature": 0.5}):
            status, out = request(spec, "POST", "/generate", body)
            assert status == 200
        assert spec.stats["speculative_requests"] == 1
    finally:
        spec.batcher.close()


def test_exact_solo_lengths_are_capped(served, monkeypatch):
    cfg, params, _ = served
    monkeypatch.setattr(serve, "EXACT_LENS_MAX", 1)
    spec = make_app(cfg, params, max_new_tokens=NEW, window_ms=1.0,
                    speculative=True, device="cpu")
    try:
        counts = []
        for n in (5, 6, 5):    # the second length is past the cap: padded
            assert request(spec, "POST", "/generate",
                           {"prompt": [9] * n})[0] == 200
            counts.append(spec.stats["speculative_requests"])
        assert counts == [1, 1, 2]
        assert spec.batcher._exact_lens == {5}
    finally:
        spec.batcher.close()


def test_main_selftest_speculative_on_cpu(capsys):
    assert main(["--preset", "tiny", "--device", "cpu", "--selftest",
                 "--speculative", "--max-new-tokens", "3"]) == 0
    assert "selftest ok: 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------
# quantized weights, text requests, HF directories
# ---------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--int8"], ["--int4"],
                                   ["--int4", "--speculative"]],
                         ids=["int8", "int4", "int4_speculative"])
def test_main_selftest_quantized_on_cpu(capsys, flags):
    assert main(["--preset", "tiny", "--device", "cpu", "--selftest",
                 "--max-new-tokens", "3", *flags]) == 0
    assert "selftest ok: 6 tokens" in capsys.readouterr().out


def test_int8_and_int4_flags_are_exclusive():
    with pytest.raises(SystemExit):
        main(["--preset", "tiny", "--device", "cpu", "--int8", "--int4"])


def test_make_app_unpacks_int4_once_at_construction(served, monkeypatch):
    """The app unpacks packed int4 when it is made and serves the
    unpacked tree: no request unpacks again, and the tokens are those
    of the per-token ``generate`` on the packed tree."""
    from kubeflow_rm_tpu_torch.models import quantize
    from kubeflow_rm_tpu_torch.models.generate import generate
    from kubeflow_rm_tpu_torch.models.quantize import quantize_params

    cfg, params, _ = served
    q4 = quantize_params(params, bits=4)
    calls = []
    unpack = quantize.unpack_int4
    monkeypatch.setattr(quantize, "unpack_int4",
                        lambda leaf: (calls.append(1), unpack(leaf))[1])
    app = make_app(cfg, q4, max_new_tokens=NEW, window_ms=1.0, device="cpu")
    made = len(calls)
    try:
        outs = [request(app, "POST", "/generate", {"prompt": [5, 6, 7]})
                for _ in range(2)]
    finally:
        app.batcher.close()
    assert made == len(q4["blocks"]) - 2 + 1     # 7 projections + head
    assert len(calls) == made
    monkeypatch.undo()
    want = generate(q4, cfg, torch.tensor([[5, 6, 7]]),
                    max_new_tokens=NEW).tolist()[0]
    assert outs == [(200, {"tokens": want})] * 2


class StubTok:
    """The minimal tokenizer of ``tests/test_examples.py``: no
    ``skip_special_tokens`` keyword."""

    def encode(self, text):
        return [ord(c) % 250 + 1 for c in text]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_text_round_trip_with_a_server_side_tokenizer():
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    app = make_app(cfg, params, max_new_tokens=3, window_ms=1.0,
                   tokenizer=StubTok(), device="cpu")
    try:
        status, body = request(app, "POST", "/generate", {"text": "hello"})
        assert status == 200, body
        assert len(body["tokens"]) == 5 + 3
        assert body["tokens"][:5] == StubTok().encode("hello")
        assert body["text"] == " ".join(str(i) for i in body["tokens"])
        status, body = request(app, "POST", "/generate", {"text": 5})
        assert status == 400 and "text" in body["error"]
        # token ids still work beside text
        status, body = request(app, "POST", "/generate", {"prompt": [1, 2]})
        assert status == 200 and "text" in body
    finally:
        app.batcher.close()
    # without a tokenizer a text request is a bad request
    app = make_app(cfg, params, max_new_tokens=3, window_ms=1.0,
                   device="cpu")
    try:
        status, body = request(app, "POST", "/generate", {"text": "hello"})
        assert status == 400 and "tokenizer" in body["error"]
    finally:
        app.batcher.close()


def test_main_serves_an_hf_directory(tmp_path, capsys):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=172,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256))
    hf.save_pretrained(tmp_path)
    assert main(["--hf-model", str(tmp_path), "--device", "cpu", "--int8",
                 "--selftest", "--max-new-tokens", "3"]) == 0
    assert "selftest ok: 6 tokens" in capsys.readouterr().out
