"""GossipGraD core of the port: topologies and their mixing matrices,
buckets, the per-leaf and packed gossip engines, the async ring, protocols
and the replica simulator (port of ``repro/core``)."""
from .async_gossip import (exchange_ok, init_inbox_ring, init_wire_inbox_ring,
                           make_async_gossip_mix,
                           make_packed_async_gossip_mix,
                           make_packed_fused_async_update)
from .buckets import (LANE, BucketLayout, LeafSlot, PackedParams,
                      build_layout)
from .gossip import (exchange, linear_pairs, make_gossip_mix,
                     make_packed_fused_update, make_packed_gossip_mix,
                     packed_fused_local_update, replica_mean, wire_period,
                     wire_subset_of)
from .mixing import (consensus_contraction, is_doubly_stochastic,
                     mixing_matrix, round_matrix, spectral_gap)
from .protocols import PROTOCOLS, Protocol, make_protocol, make_ring_shuffle
from .replica_group import ReplicaGroup
from .simulate import (allreduce_mean_sim, gossip_mix_sim,
                       gossip_mix_sim_delayed, gossip_mix_sim_delayed_k,
                       gossip_mix_sim_masked, gossip_mix_sim_quantized,
                       gossip_mix_sim_quantized_k, make_async_sim_train_step,
                       make_sim_train_step, replica_variance, replicate)
from .topology import (BucketSubsetSchedule, GossipSchedule, build_schedule,
                       build_subset_schedule, diffusion_steps,
                       dissemination_partner, hypercube_partner, log2_steps,
                       reachability, ring_partner)

__all__ = ["LANE", "BucketLayout", "LeafSlot", "PackedParams", "build_layout",
           "exchange", "linear_pairs", "make_gossip_mix",
           "make_packed_fused_update", "make_packed_gossip_mix",
           "packed_fused_local_update", "replica_mean", "wire_period",
           "wire_subset_of", "exchange_ok", "init_inbox_ring",
           "init_wire_inbox_ring", "make_async_gossip_mix",
           "make_packed_async_gossip_mix", "make_packed_fused_async_update",
           "PROTOCOLS", "Protocol", "make_protocol", "make_ring_shuffle",
           "ReplicaGroup",
           "BucketSubsetSchedule", "GossipSchedule", "build_schedule",
           "build_subset_schedule", "dissemination_partner",
           "hypercube_partner", "ring_partner", "log2_steps", "reachability",
           "diffusion_steps", "mixing_matrix", "round_matrix",
           "is_doubly_stochastic", "consensus_contraction", "spectral_gap",
           "replicate", "gossip_mix_sim", "gossip_mix_sim_delayed",
           "gossip_mix_sim_delayed_k", "gossip_mix_sim_masked",
           "gossip_mix_sim_quantized", "gossip_mix_sim_quantized_k",
           "allreduce_mean_sim", "replica_variance", "make_sim_train_step",
           "make_async_sim_train_step"]
