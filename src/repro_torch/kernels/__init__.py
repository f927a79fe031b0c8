"""Kernels of the port: hand-written CUDA for Hopper beside plain PyTorch
versions (port of ``repro/kernels``).

As in the reference, ``ssm_scan`` here is the scan entry point of ``ops``
(the Mamba mixer's ``scan_impl`` hook); its kernel, launch count included,
lives in ``ssm_scan_kernel``, beside ``ssm_scan_train``, the scan with a
hand-written backward that the chunked train scan runs on the card."""
from . import (flash_attention, fused_update, gossip_mix, quantize, ref,
               ssm_scan_kernel)
from .fused_update import (fused_adamw_1d, fused_adamw_plain, fused_lars_1d,
                           fused_lars_plain, fused_sgd_1d, fused_sgd_plain)
from .gossip_mix import (gossip_mix_1d, gossip_mix_2d, gossip_mix_out,
                         gossip_mix_plain, gossip_mix_q2d, gossip_mix_q_plain)
from .ops import (flash_mha, fused_adamw_bucket, fused_lars_bucket,
                  fused_sgd_bucket, gossip_mix_bucket, gossip_mix_flat,
                  gossip_mix_tree, ssm_scan)
from .ssm_scan_kernel import ssm_scan_chunked, ssm_scan_train

__all__ = ["flash_attention", "fused_update", "gossip_mix", "quantize", "ref",
           "ssm_scan_kernel",
           "fused_sgd_1d", "fused_sgd_plain", "fused_adamw_1d",
           "fused_adamw_plain", "fused_lars_1d", "fused_lars_plain",
           "gossip_mix_1d", "gossip_mix_2d", "gossip_mix_out",
           "gossip_mix_plain", "gossip_mix_flat", "gossip_mix_tree",
           "gossip_mix_q2d", "gossip_mix_q_plain", "fused_sgd_bucket",
           "fused_adamw_bucket", "fused_lars_bucket", "gossip_mix_bucket",
           "ssm_scan", "ssm_scan_chunked", "ssm_scan_train", "flash_mha"]
