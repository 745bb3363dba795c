"""Models of the port. ``generate`` (the per-step loop) is reached as
``models.generate.generate``: the package attribute ``generate`` is the
submodule. ``init_params`` and ``forward_with_aux`` dispatch on the
config's family, so generic code (training) never branches on it."""

from kubeflow_rm_tpu_torch.models.convert import (
    config_from_hf, from_hf_llama, load_hf_dir, to_hf_llama,
)
from kubeflow_rm_tpu_torch.models.generate import (
    DEFAULT_CLASS_WEIGHTS,
    SLO_CLASSES,
    ContinuousBatchingEngine,
    EngineRequest,
    KVCache,
    SlotCache,
    decode_chunk,
    generate_fused,
    generate_speculative_fused,
    init_cache,
    init_slot_cache,
    slot_decode_step,
)
from kubeflow_rm_tpu_torch.models import llama as _llama
from kubeflow_rm_tpu_torch.models import mixtral as _mixtral
from kubeflow_rm_tpu_torch.models.llama import (
    LlamaConfig, forward, param_spec_shapes,
)
from kubeflow_rm_tpu_torch.models.lora import add_lora, lora_mask, merge_lora
from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig
from kubeflow_rm_tpu_torch.models.paging import (
    BlockPool,
    PagedKVCache,
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
    prefix_keys,
)
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.models.quantize import (
    init_params_quantized, quantize_params,
)


def init_params(cfg: LlamaConfig, generator, device=None, *, mesh=None,
                transform=None) -> dict:
    """Family-correct random parameters for any model config, each draw
    passed through ``transform(path, tensor)`` (``llama.init_tree``). On
    ``mesh`` every rank draws the same values and keeps only its slices
    of each draw (``sharding.Sharder``): the result is
    ``shard_params(init_params(...), mesh)``, but no rank ever holds the
    global tree, only its shards and one layer of one leaf whole (on a
    pp mesh the other stages' layers are drawn, so that every rank's
    generator stays in step, and dropped at once)."""
    family = _mixtral if isinstance(cfg, MixtralConfig) else _llama
    if mesh is None:
        return family.init_params(cfg, generator, device,
                                  transform=transform)
    from kubeflow_rm_tpu_torch.parallel.sharding import Sharder

    sharder = Sharder(mesh, cfg.n_layers)

    def cut(path, t):
        return sharder(path, t if transform is None else transform(path, t))

    return sharder.mark(family.init_params(cfg, generator, device,
                                           transform=cut,
                                           layers=sharder.layers))


def forward_with_aux(params, tokens, cfg: LlamaConfig, **kwargs):
    """Uniform forward: ``(logits, aux)``, where aux is the router
    load-balancing loss for MoE families and None for dense ones."""
    if isinstance(cfg, MixtralConfig):
        return _mixtral.forward(params, tokens, cfg, **kwargs)
    return _llama.forward_with_aux(params, tokens, cfg, **kwargs)


__all__ = [
    "BlockPool",
    "ContinuousBatchingEngine",
    "DEFAULT_CLASS_WEIGHTS",
    "EngineRequest",
    "KVCache",
    "LlamaConfig",
    "MixtralConfig",
    "PagedKVCache",
    "SLO_CLASSES",
    "SlotCache",
    "add_lora",
    "config_from_hf",
    "decode_chunk",
    "forward",
    "forward_with_aux",
    "from_hf_llama",
    "from_numpy_params",
    "generate_fused",
    "generate_speculative_fused",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "init_params_quantized",
    "init_slot_cache",
    "load_hf_dir",
    "lora_mask",
    "merge_lora",
    "paged_decode_step",
    "paged_prefill",
    "param_spec_shapes",
    "prefix_keys",
    "quantize_params",
    "slot_decode_step",
    "to_hf_llama",
]
