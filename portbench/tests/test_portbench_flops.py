"""The counts the per-layer metrics divide by, against sums by hand."""

from portbench import flops
from portbench.arch import arch_of, read_config

from conftest import ROOT


def mistral():
    return arch_of("mistral-7b", read_config(
        ROOT / "portbench" / "configs" / "mistral-7b.json"))


def mixtral():
    return arch_of("mixtral-8x7b-l16", read_config(
        ROOT / "portbench" / "configs" / "mixtral-8x7b-l16.json"))


def test_causal_pairs():
    assert flops.causal_pairs([1]) == 1
    assert flops.causal_pairs([4]) == 10          # 1 + 2 + 3 + 4
    assert flops.causal_pairs([4, 2]) == 13
    assert flops.causal_pairs([4096]) == 4096 * 4097 // 2


def test_dense_matmul_parameters():
    a = mistral()
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    mlp = 3 * 4096 * 14336
    assert flops.frozen_matmul_params(a) == 32 * (attn + mlp) + 4096 * 32768
    # every parameter but the embedding and the norm gains
    assert flops.frozen_matmul_params(a) == 7_248_023_552 - 32768 * 4096 \
        - (2 * 32 + 1) * 4096


def test_moe_counts_top_k_experts_and_the_router():
    a = mixtral()
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    moe = 2 * 3 * 4096 * 14336 + 4096 * 8
    assert flops.frozen_matmul_params(a) == 16 * (attn + moe) + 4096 * 32000


def test_lora_parameters():
    a = mistral()
    assert flops.lora_params(a, 16, ["wq", "wv"]) == \
        32 * (16 * (4096 + 4096) + 16 * (4096 + 1024))


def test_train_step_flops_by_hand():
    a = mistral()
    rows = [[4096], [1000, 3096]]
    tokens = 8192
    pairs = 4096 * 4097 // 2 + 1000 * 1001 // 2 + 3096 * 3097 // 2
    want = (4 * flops.frozen_matmul_params(a)
            + 6 * flops.lora_params(a, 16, ["wq", "wv"])) * tokens \
        + 12 * 128 * 32 * 32 * pairs
    assert flops.train_step_flops(a, rows, 16, ["wq", "wv"]) == want


def test_flash_launch_counts():
    a = mistral()
    rows = [[2048], [1024, 1024]]
    B, T, H, KVH, D = 2, 2048, 32, 8, 128
    pairs = 2048 * 2049 // 2 + 2 * (1024 * 1025 // 2)
    q, kv, lse, seg = B * T * H * D * 2, B * T * KVH * D * 2, B * H * T * 4, \
        2 * B * T * 4
    fwd = flops.flash_launch("fwd", a, rows)
    assert fwd["flops"] == 4 * D * H * pairs
    assert fwd["bytes"] == q + 2 * kv + seg + q + lse
    dq = flops.flash_launch("dq", a, rows)
    assert dq["flops"] == 6 * D * H * pairs
    assert dq["bytes"] == q + 2 * kv + q + 2 * lse + seg + q
    dkv = flops.flash_launch("dkv", a, rows)
    assert dkv["flops"] == 8 * D * H * pairs
    assert dkv["bytes"] == q + 2 * kv + q + 2 * lse + seg + 2 * kv
    for x in (fwd, dq, dkv):
        assert x["bound_s"] == max(x["flops"] / 989e12, x["bytes"] / 3.35e12)
