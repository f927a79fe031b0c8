"""Model zoo of the port: dense attention (with the vision stub),
encoder-decoder, Mamba-1, routed-MoE and MLA (with the MTP head) families
(port of ``repro/models``)."""
from .config import (AttnSpec, AudioStubSpec, BlockSpec, EncoderSpec,
                     MLASpec, ModelConfig, MoESpec, SSMSpec, VisionStubSpec,
                     reduced)
from .blocks import segments_of
from .transformer import (encode_audio, lm_apply, lm_axes, lm_cache_init,
                          lm_decode, lm_init, lm_prefill, lm_specs)

__all__ = ["AttnSpec", "AudioStubSpec", "BlockSpec", "EncoderSpec",
           "MLASpec", "ModelConfig", "MoESpec", "SSMSpec", "VisionStubSpec", "reduced",
           "segments_of", "encode_audio", "lm_apply", "lm_axes", "lm_init",
           "lm_specs", "lm_cache_init", "lm_decode", "lm_prefill"]
