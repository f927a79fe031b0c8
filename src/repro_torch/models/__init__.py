"""Model zoo of the port, dense attention (with the vision stub) and Mamba-1
families (port of ``repro/models``)."""
from .config import (AttnSpec, BlockSpec, ModelConfig, SSMSpec,
                     VisionStubSpec, reduced)
from .blocks import segments_of
from .transformer import (lm_apply, lm_axes, lm_cache_init, lm_decode,
                          lm_init, lm_prefill, lm_specs)

__all__ = ["AttnSpec", "BlockSpec", "ModelConfig", "SSMSpec",
           "VisionStubSpec", "reduced",
           "segments_of", "lm_apply", "lm_axes", "lm_init", "lm_specs",
           "lm_cache_init", "lm_decode", "lm_prefill"]
