"""Model zoo of the port, dense attention family (port of ``repro/models``)."""
from .config import AttnSpec, BlockSpec, ModelConfig, reduced
from .transformer import lm_apply, lm_init, lm_specs

__all__ = ["AttnSpec", "BlockSpec", "ModelConfig", "reduced", "lm_apply",
           "lm_init", "lm_specs"]
