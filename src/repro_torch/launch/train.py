"""Training launcher CLI (port of ``repro/launch/train.py``).

Takes the reference's flags plus ``--device {cuda,cpu}`` (default cuda).
Without ``--packed`` it runs the per-leaf engine, the reference's default;
``--packed`` runs the bucketed engines (fused by default). The model
follows the reference's rule (``src/repro/launch/train.py:104``): it
trains the reduced fp32 variant of ``--arch`` (``--d-model`` wide) under
``--smoke`` or whenever the process sees one device, so the port's
launcher always reduces the model, ``--smoke`` or not (``model_config``).
Per-layer remat is on as the reference's rule has it
(``src/repro/launch/train.py:131``): off under ``--smoke`` or with one
rank. ``--protocol gossip_async`` takes ``--staleness``, ``--drop-timeout`` and
``--drop-seed``; both gossip protocols take ``--wire-dtype``,
``--gossip-subset`` and ``--wire-seed`` (a compressed wire needs
``--packed``).

``--arch whisper-base`` is refused: the launcher and the Trainer feed
tokens only, as the reference's do, and an enc-dec model's loss needs
audio frames (the reference's ``lm_apply`` asserts them). Train it through
``make_train_step_bundle`` with batches that carry ``audio_frames``.

``--smoke-mesh POD,DATA,MODEL`` builds the distribution plan
``make_distribution(make_smoke_mesh(DATA, MODEL, pod=POD),
cfg.dist_mode)`` as the reference does; its ``dp`` replicas (pod x data in
``replica`` mode, pod in ``fsdp``) are stacked on the one device, and
``--packed`` runs the shard-local bucket layout when the plan shards
inside a replica (``MODEL > 1``, or fsdp's data axis); the final JSON line
prints ``num_shards``. Without ``--packed``, ``MODEL > 1`` runs the
per-leaf engine unchanged (on one device the model axis is only
placement). ``--multi-pod`` is accepted and ignored: the reference ignores
it on one device, where it always takes the smoke mesh.

When ``WORLD_SIZE`` > 1 (``torchrun``) every mesh position of
``--smoke-mesh`` is one process over ``torch.distributed`` (gloo with
``--device cpu``, NCCL on ``cuda:LOCAL_RANK``), ``WORLD_SIZE`` equal to
POD x DATA x MODEL (``launch.mesh.init_replica_group(dist=...)``). A plan
that shards inside a replica runs in-pod FSDP: under ``--packed`` each
process holds its stretch of every bucket, the forward all-gathers the
replica's stretches and the backward reduce-scatters the gradient;
without it (the per-leaf engines) each process holds its piece of every
leaf, and the forward all-gathers each leaf and the backward
reduce-scatters its gradient. The MoE layers of ``--arch
jamba-v0.1-52b`` or ``kimi-k2-1t-a32b`` split their experts over the
ranks of one batch index (``models.moe._expert_compute_manual``). The
gossip runs between the processes at the same shard position. ``--checkpoint`` and ``--resume`` work per
rank: the ranks gather to rank 0, which writes the stacked run's files,
and each restores its own row and its stretch or pieces. Only rank 0
prints; the final JSON line's ``num_shards`` is the shards a replica is
split into on the ranks (1 when stacked without ``--packed``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --smoke --smoke-mesh 1,4,1 --steps 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --smoke --packed --smoke-mesh 1,2,2 --steps 8 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --smoke-mesh 1,4,1 --steps 8 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --smoke-mesh 1,2,2 --steps 8 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --smoke --packed --smoke-mesh 2,2,2 --steps 8 --device cpu \
        --checkpoint /tmp/ck
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --arch jamba-v0.1-52b --smoke-mesh 1,2,2 --steps 2 \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.checkpoint import (checkpoint_exists, read_manifest,
                                    restore_state, save_state)
from repro_torch.configs import get_config, list_archs
from repro_torch.data import ShardedTokenDataset
from repro_torch.launch.mesh import (destroy_replica_group,
                                     init_replica_group, make_smoke_mesh,
                                     world_from_env)
from repro_torch.models import reduced
from repro_torch.optim import scale_lr_sqrt_p, sgd, step_decay
from repro_torch.train import (Trainer, init_train_state, make_distribution,
                               make_train_step_bundle)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--protocol", default="gossip",
                    choices=["gossip", "gossip_async", "agd", "every_logp",
                             "none"])
    ap.add_argument("--topology", default="dissemination",
                    choices=["dissemination", "hypercube"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--num-rotations", type=int, default=2)
    ap.add_argument("--staleness", type=int, default=1,
                    help="gossip_async inbox-ring depth k (bounded delay)")
    ap.add_argument("--drop-timeout", type=float, default=0.0, metavar="RATE")
    ap.add_argument("--drop-seed", type=int, default=0)
    ap.add_argument("--wire-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8", "fp8"])
    ap.add_argument("--gossip-subset", type=float, default=1.0, metavar="FRAC")
    ap.add_argument("--wire-seed", type=int, default=0)
    ap.add_argument("--packed", action="store_true",
                    help="bucketed persistent-buffer gossip engine")
    ap.add_argument("--fused-update", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="single-sweep fused mix+apply engine (default on "
                    "for --packed; --no-fused-update mixes after the update)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced fp32 config (the port reduces the model "
                    "anyway: its replicas share one device, and the "
                    "reference reduces on one device)")
    ap.add_argument("--smoke-mesh", default="1,1,1", metavar="POD,DATA,MODEL",
                    help="the mesh the distribution plan runs over: its "
                    "replicas stacked on the one device (or one per "
                    "process under torchrun), its in-replica axes the "
                    "shard-local bucket layout under --packed")
    ap.add_argument("--multi-pod", action="store_true",
                    help="ignored on one device, as in the reference")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint (if it exists) and "
                    "continue from its saved step; async runs resume their "
                    "ring and gossip phase (a checkpoint written at another "
                    "--staleness is mask-padded / truncated into the ring)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace):
    """The model the launcher trains: the reference reduces ``--arch`` to
    its fp32 smoke variant under ``--smoke`` or on one device
    (``src/repro/launch/train.py:104-107``), and the port always runs on
    one device. An enc-dec arch is refused: its loss needs audio frames,
    which the token pipeline does not carry."""
    cfg = get_config(args.arch)
    if cfg.encoder is not None:
        raise ValueError(
            f"--arch {args.arch} is an encoder-decoder model whose loss needs "
            "audio_frames; the launcher feeds tokens only (as the "
            "reference's): train it through make_train_step_bundle with "
            "batches that carry audio_frames")
    return dataclasses.replace(reduced(cfg, d_model=args.d_model),
                               param_dtype="float32", compute_dtype="float32")


def lr_schedule(args: argparse.Namespace, dp: int):
    """sgd's schedule: a step decay over the run, scaled by sqrt(dp) for
    ``agd`` (Krizhevsky's rule, the AGD baseline only, §7.1), as the
    reference's launcher builds it (``src/repro/launch/train.py:114-117``)."""
    lr = step_decay(args.lr, 0.1, max(args.steps // 3, 1))
    return scale_lr_sqrt_p(lr, dp) if args.protocol == "agd" else lr


def main(argv=None) -> None:
    args = parse_args(argv)
    pod, data, model = (int(x) for x in args.smoke_mesh.split(","))
    dist = make_distribution(make_smoke_mesh(data, model, pod=pod),
                             model_config(args).dist_mode)
    world = world_from_env()
    if world > 1:
        if world != pod * data * model:
            raise ValueError(f"--smoke-mesh {args.smoke_mesh} has "
                             f"{pod * data * model} positions but WORLD_SIZE "
                             f"is {world}")
        group = init_replica_group(args.device, dist=dist)
        try:
            _run(args, dist, group.device, group.rank == 0, group)
        finally:
            destroy_replica_group()
    else:
        _run(args, dist, args.device, True)


def _run(args, dist, device, report: bool, group=None) -> None:
    cfg = model_config(args)
    dp = dist.dp
    opt = sgd(lr_schedule(args, dp), momentum=0.9)
    bundle = make_train_step_bundle(
        cfg, opt, dist=dist, protocol=args.protocol, topology=args.topology,
        num_rotations=args.num_rotations, gossip_packed=args.packed,
        staleness=args.staleness, drop_rate=args.drop_timeout,
        drop_seed=args.drop_seed, wire_dtype=args.wire_dtype,
        gossip_subset=args.gossip_subset, wire_seed=args.wire_seed,
        fused_update=args.fused_update, device=device, group=group,
        remat=not (args.smoke or world_from_env() <= 1))
    state = init_train_state(cfg, opt, dist=dist, packed=args.packed,
                             layout=bundle.layout, seed=0, device=device,
                             inbox=bundle.protocol.staleness,
                             wire=bundle.wire, group=group)
    period = bundle.protocol.period
    start_step = 0
    if args.resume and args.checkpoint and checkpoint_exists(args.checkpoint):
        meta = read_manifest(args.checkpoint).get("metadata", {})
        if meta.get("protocol") not in (None, args.protocol):
            raise SystemExit(
                f"checkpoint was written by protocol {meta['protocol']!r}; "
                f"refusing to resume it as {args.protocol!r}")
        state, manifest = restore_state(args.checkpoint, state, group,
                                        bundle.pieces)
        start_step = int(manifest.get("step") or 0)
        if report:
            print(f"resumed {args.checkpoint} at step {start_step} "
                  f"(phase {start_step % period})")
    ds = ShardedTokenDataset(cfg.vocab, args.seq_len, n_shards=dp,
                             batch_per_shard=args.global_batch // dp)
    trainer = Trainer(bundle, state, ds,
                      log_every=args.log_every if report else 0)
    hist = trainer.run(args.steps, start_step=start_step)
    if report:
        print(json.dumps({"arch": cfg.name, "protocol": args.protocol,
                          "packed": args.packed, "fused": bundle.fused,
                          "dp": dp, "num_shards": next(
                              (t.num_shards for t in (bundle.layout,
                                                      bundle.pieces)
                               if t is not None), 1),
                          "staleness": bundle.protocol.staleness,
                          "wire_dtype": args.wire_dtype,
                          "gossip_subset": args.gossip_subset,
                          "final_loss": hist[-1]["loss"],
                          "first_loss": hist[0]["loss"],
                          "start_step": start_step}))
    if args.checkpoint:
        end_step = start_step + args.steps
        save_state(args.checkpoint, trainer.state,
                   metadata={"arch": cfg.name, "protocol": args.protocol,
                             "staleness": bundle.protocol.staleness,
                             "drop_timeout": args.drop_timeout,
                             "wire_dtype": args.wire_dtype,
                             "gossip_subset": args.gossip_subset,
                             "wire_seed": args.wire_seed,
                             "phase": end_step % period},
                   step=end_step, group=group, pieces=bundle.pieces)
        if report:
            print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
