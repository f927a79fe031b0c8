"""Model zoo of the port, dense attention and Mamba-1 families (port of
``repro/models``)."""
from .config import AttnSpec, BlockSpec, ModelConfig, SSMSpec, reduced
from .transformer import lm_apply, lm_axes, lm_init, lm_specs

__all__ = ["AttnSpec", "BlockSpec", "ModelConfig", "SSMSpec", "reduced",
           "lm_apply", "lm_axes", "lm_init", "lm_specs"]
