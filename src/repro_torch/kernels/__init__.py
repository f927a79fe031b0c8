"""Kernels of the port: hand-written CUDA for Hopper beside plain PyTorch
versions (port of ``repro/kernels``)."""
from . import fused_update, gossip_mix, quantize
from .fused_update import (fused_adamw_1d, fused_adamw_plain, fused_lars_1d,
                           fused_lars_plain, fused_sgd_1d, fused_sgd_plain)
from .gossip_mix import (gossip_mix_1d, gossip_mix_2d, gossip_mix_plain,
                         gossip_mix_q2d, gossip_mix_q_plain)
from .ops import (fused_adamw_bucket, fused_lars_bucket, fused_sgd_bucket,
                  gossip_mix_bucket)

__all__ = ["fused_update", "gossip_mix", "quantize", "fused_sgd_1d",
           "fused_sgd_plain", "fused_adamw_1d", "fused_adamw_plain",
           "fused_lars_1d", "fused_lars_plain", "gossip_mix_1d",
           "gossip_mix_2d", "gossip_mix_plain", "gossip_mix_q2d",
           "gossip_mix_q_plain", "fused_sgd_bucket", "fused_adamw_bucket",
           "fused_lars_bucket", "gossip_mix_bucket"]
