"""Model definitions of the port: config registry (a copy of the
reference's), layer primitives, int8/int4 quantization, the llama and
mixtral decoders, sampling, and the numpy weight bridge."""

from .configs import CONFIGS, ModelConfig, RopeScaling, get_config


def family_for(config: ModelConfig):
    """The model module (llama or mixtral) implementing this config. Both
    expose the same surface the serving stack calls —
    ``init_params_quantized``, ``fuse_params``, ``prefill``,
    ``prefill_chunk``, ``new_carry``, ``decode_step_paged``,
    ``decode_fused``, ``embed_pooled`` — so it dispatches on
    ``config.is_moe`` alone."""
    if config.is_moe:
        from . import mixtral
        return mixtral
    from . import llama
    return llama


__all__ = ["CONFIGS", "ModelConfig", "RopeScaling", "family_for",
           "get_config"]
