#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Imports nothing of JAX or of the reference
package ``repro``. Phases, each of which fails the run on any error:

1. ``[build]`` builds the hand-written kernels (one nvcc per source, in
   parallel), and proves that ``flash_attention``'s products run on the
   tensor cores: for each kernel of its library the registers and spill
   bytes ptxas reports and the count of HGMMA (``wgmma``) instructions in
   ``cuobjdump -sass``; a spill anywhere, or a ``flash_kernel``
   instantiation with no HGMMA, fails the run, and so does a missing
   ``cuobjdump``.
2. ``[check]`` holds each kernel against its plain PyTorch version on the
   card at the smallest and the largest bucket of full-width qwen3-0.6b at
   dp=4, fp32 and bf16: the raw mix and fused SGD sweep (alpha 0.5 and 0
   static, 0.25 as a () tensor, one alpha per replica row), a bf16 partner
   on an fp32 bucket, and ``gossip_mix_q`` and the scaled fused sweep on
   int8 and fp8 wire codes. Bit equality expected. Also the wire encode on
   the card against the CPU, bit for bit. ``[check_opt]`` does the same
   for ``fused_adamw`` (raw, int8, fp8 and no partner) and ``fused_lars``
   (bf16, fp32 and no partner) on the largest bucket, static, () and
   per-row alpha.
3. ``[time]`` and ``[time_opt]`` time each kernel, its plain version, the
   PyTorch yardstick and the bound at the largest bucket in bf16 (the mix
   kernels, static and per-row alpha, and ``torch.lerp_`` in 7 interleaved
   rounds: median, min and max, and the share of the bound), the fused
   SGD sweep over all buckets, the int8 wire encode (per bucket and per
   step), ``torch._fused_adamw_`` for orientation, and the LARS norm
   prepass (largest bucket and per step).
4. ``[main]`` the first slice's path: full-width qwen3-0.6b in bf16, 4
   gossip replicas stacked on the card, packed + fused sync gossip with
   sgd, seq 256, 2 sequences per replica, 8 steps, with the kernels'
   launch counts reset before and read after, then one protocol period
   timed and one profiled (``[profile main]``).
5. ``[async_wire]`` the second slice's path on the same model:
   ``gossip_async`` (staleness 2, drop 0.2) on the int8 wire with subset
   0.5, fused, 8 steps, launch counts checked, then profiled likewise.
6. ``[adamw_wire]`` and ``[lars_main]`` the third slice's paths on the
   same model, each 8 steps with launch counts checked and profiled
   likewise: adamw on the ``async_wire`` protocol, and lars on the
   ``main`` one (with the prepass's share of the step). ``[agd_main]`` and
   ``[every_logp_main]`` the paper's baselines on the same model, fused
   (``fused_sgd`` at alpha 0, 104 launches each): the replicas
   bit-identical after every step of agd and exactly after every_logp's
   averaging steps (phase + 1 a multiple of the substeps), the replica
   mean timed alone; both then timed and profiled like ``[main]``, and
   ``[baselines]`` prints the three paths' ms/step from this call.
7. At 2 layers, 4 steps each: ``[async_unfused]`` (the async ring unfused
   on the int8 wire; ``gossip_mix_q`` launches equal the count computed
   from ``selected(phase - k)``), ``[sync_fp8]`` (the sync fused engine on
   the fp8 wire), ``[adamw_sync]`` (sync fused), ``[lars_async]``
   (gossip_async int8 subset 0.5 fused, the partner decoded before the
   prepass), ``[adamw_unfused]`` (sync, tree-level update + ``gossip_mix``)
   and ``[lars_unfused]`` (gossip_async int8 subset 0.5, tree-level update
   + ``gossip_mix_q``). ``[ckpt]`` (sync fused) and ``[ckpt_async]``
   (``async_wire``'s protocol): two straight 8-step runs, then 4 steps,
   ``save_state`` into a ``tempfile.mkdtemp()``, ``restore_state`` into a
   fresh state drawn with another seed (bit-equal to what was saved), 4
   more steps held bit for bit against the straight run when the two
   straight runs are bit-equal, else within their difference; save and
   restore seconds, bytes on disk and GB/s; ``[ckpt_async]`` also restores
   the file into a staleness-4 ring (saved slots bit-equal, new ones
   invalid). The depth is cut for the disk: 2 layers write about 6 GB.
8. ``[agree]`` small fp32 models (5 buckets) on the card and on the CPU
   (plain versions) from one init: sgd sync fused, async int8 subset 0.5
   fused and unfused, sync bf16 wire unfused; adamw and lars sync fused,
   async int8 subset 0.5 fused and sync unfused. Trajectories agree within
   rtol = atol = 2e-4, except bucket elements one wire code step apart or,
   under AdamW, at most 2 * lr * steps apart (a gradient sign flipped at
   rounding level), at most 0.1% of them.
9. ``[unfused]`` sync ``fused_update=False`` with sgd at full width and 2
   layers, so the raw mix kernel runs on its path.
10. The forward-only kernels. ``[check_ssm]`` holds ``ssm_scan`` against its
    plain loop bit for bit at (2, 4096, 8192, 16) (falcon-mamba's scan at 2 x
    4096 tokens), a ragged (3, 1000, 100, 5) and S = 1; then the scan under
    autograd (``ssm_scan_train``), its forward and its backward kernel
    (``ssm_scan_bwd.cu``) against ``ssm_scan_ref`` and ``ssm_scan_bwd_ref``
    bit for bit at (1, 4096, 8192, 16), the ragged shape, S = 1 and
    (1, 33, 7, 3). ``[check_attn]``
    holds ``flash_attention`` against its plain version
    ``flash_attention_plain`` (dense ``attention_ref``, and the reference's
    block rule for rows with no admissible key) at qwen3-0.6b's
    attention (16 heads after repeating the 8 KV heads, d 128): S = T =
    4096 causal, the same with window 1024, a non-causal S 1024 x T 4096,
    d 64 at S 512, and S 256 x T 128 with window 8 (rows 135-255 keyless),
    causal and not, at blocks (128, 128), (32, 32), (64, 128) and (128, 32),
    each in fp32 (rtol = atol = 2e-5, the reference's) and
    bf16 (one bf16 ulp of the plain output plus 2e-5), with
    ``torch.backends.cuda.matmul.allow_tf32`` logged and required False (the
    plain version's fp32 einsum would round to TF32); a block that does not
    divide S raises. ``[time_ssm]`` and ``[time_attn]`` time both, and
    ``[time_ssm]`` the scan's backward kernel at (2, 4096, 8192, 16) too,
    against their plain versions, their bounds and, for attention, PyTorch's
    ``scaled_dot_product_attention`` (a yardstick the port never calls), at
    S = 4096 and 32768, and the keyless-rows case (S 256, T 128, window 8,
    blocks 32) against its plain version. Attention's bound prices each product at the
    split-pass rate of its operands on the tensor cores (``_attn_bound``);
    the kernels line's flash entry adds ``share_of_bound`` = bound / time.
11. ``[flash_path]`` one ``flash_mha`` call on q, k, v projected by a
    full-width bf16 qwen3-0.6b attention layer (RoPE, qk-norm, GQA
    repeated), S 4096: one launch, which the kernels line's flash entry
    times (the bf16 ``[time_attn]`` times ride beside as ``*_bf16`` keys). ``[mamba_eval]`` scores falcon-mamba-7b at
    full width and depth (64 layers, random bf16 weights from seed 0) on 2 x
    4096 tokens through ``make_loss_fn(cfg, ssm_scan_impl=ssm_scan)`` under
    ``no_grad``: 64 scan launches per forward, loss within 1 of ln(vocab),
    then profiled (``[profile mamba_eval]``). ``[mamba_agree]``: the same
    model at 2 layers gives bit-identical logits with the kernel and with
    the plain loop; a reduced fp32 falcon-mamba's logits on the card agree
    with the CPU's within rtol = atol = 2e-4.

12. The per-leaf engines, the launcher's default path: ``[leaf_main]``
    main's model (28 layers, 4 replicas, bf16, seq 256, 2 sequences a
    replica, sgd on step_decay) on the per-leaf sync ``gossip`` engine as
    the launcher runs it (the mix op by op in bf16, no hand kernel: 0
    launches), 8 steps, timed and profiled like ``[main]``;
    ``[leaf_kernel]`` the same run with ``mix_impl=gossip_mix_1d`` (8 x 13
    leaves launches), then its params against ``[leaf_main]``'s, bit for
    bit (the kernel mixes in fp32 and rounds once; in bf16 the two differ
    only where a product of the mix rounds, which at alpha 0.5 none does);
    ``[leaf_mix_check]`` ``gossip_mix_1d`` on each of the 13 full-width
    leaves against its plain version and the default per-leaf mix on the
    same inputs, bit for bit; ``[leaf_async]`` per-leaf ``gossip_async``
    (staleness 2, drop 0.2), profiled. ``[leaf_agree]``: at ``[agree]``'s
    size, per-leaf with the mix kernel against packed
    ``fused_update=False`` on the card, bit for bit. ``[sim_agree]``: the port's own
    oracle ``core.simulate`` on the card, ``make_sim_train_step`` against
    the per-leaf and packed unfused gossip, agd, every_logp and none
    engines and ``make_async_sim_train_step`` (k 2, drop 0.2) against the
    per-leaf and packed unfused async engines, bit for bit; the int8 wire
    at subset 0.5, the packed async engine against
    ``gossip_mix_sim_quantized_k`` step by step, bit for bit.

13. The shard-local (hierarchical) bucket layouts. ``[hier_main]``:
    ``[main]``'s model, optimizer, batches and 8 steps under the
    distribution plan of mesh (1, 4, 2) in ``replica`` mode (dp 4, each
    replica's leaves sharded over ``model`` in 2 shard-local pieces),
    counted and profiled like ``[main]``, with the layout (``num_shards``,
    buckets, strides) and ``unpack`` alone (device ms, GB assembled, its
    byte bound); its params after the 8 steps must equal ``[main]``'s bit
    for bit, and its losses too. ``[hier_fsdp]``: ``fsdp`` on (2, 2, 2)
    (dp 2 over the pods, 4 shards), qwen3-0.6b at full width with 2
    layers, ``async_wire``'s protocol fused, 4 steps, raw and scaled
    ``fused_sgd`` launches counted. ``[hier_agree]``: [agree]'s model on the
    (2, 2, 2) fsdp layout, sync fused and unfused, async int8 subset 0.5
    fused and unfused, adamw sync fused, card against CPU under [agree]'s
    rule and, on the fp32 wire, against the flat layout on the card bit
    for bit; the port's simulator against the shard-local packed unfused
    engines (sync, async k 2 drop 0.2) and the int8 ring against
    ``gossip_mix_sim_quantized_k`` on the shard-local buckets, bit for
    bit.

14. Serving (no kernel on its path: the reference's prefill runs ``_sdpa``
    and ``ssm_assoc_scan``, its decode plain jnp; every launch count must
    stay 0). ``[serve_qwen]``: qwen3-0.6b at full width and depth (28
    layers, bf16, random weights from seed 0) in ``ServingEngine(max_seq=
    32768)``, decode_32k's cache length (30 GB of KV cache at batch 8):
    batch 8, a 512-token prompt, 32 new tokens. Two ``generate`` calls
    (equal tokens), then prefill timed (the first call apart, the median of
    3), decode ms per token (per-step CUDA events, median), tokens/s, peak
    memory, the cache's GB, the decode byte bound (every param and cache
    slot read once, the written slots and logits once) and its share, and
    one decode step profiled (``[profile serve_qwen]``: busy ms, idle
    share); the prefill's last-position logits against ``lm_apply``'s
    within two bf16 ulps of the largest logit. ``[serve_mamba]``: the same
    for falcon-mamba-7b at full width and depth (64 layers, 7.27 G params;
    the state is O(1) per layer). ``[serve_agree]``: reduced fp32 qwen3,
    qwen3 with a 4-slot sliding window (a 12-token prompt) and falcon-mamba:
    prefill and each decode step's logits and every cache leaf on the card
    against the CPU within rtol = atol = 2e-4, prefill(t[:-1]) +
    decode(t[-1]) against ``lm_apply(t)[:, -1]`` on the card within 2e-4,
    greedy tokens equal on card and CPU and in two calls on the card.
    ``[serve_llava]``: llava-next-mistral-7b at full width and depth (32
    layers, window 4096), batch 4, 2880 seeded stub image embeddings ahead
    of a 1536-token prompt (4416 prefill positions wrap the 4096-slot
    ring), ``max_seq`` 8192, 32 new tokens; ``[serve_internlm2]``:
    internlm2-20b (48 layers, GQA 48H/8KV), ``max_seq`` 32768 at batch 2
    (12.9 GB of cache), a 512-token prompt, 32 new tokens; both as
    ``[serve_qwen]`` (``serve_run``, the CPU-callable body of every serve
    phase).

15. Long-sequence training and the dense members. Each phase's body is a
    function of the config, the device and the sizes (``mamba_train_run``,
    ``sweep_check``, ``mamba_remat_run``, ``dense_train_run``,
    ``serve_run``, ``dense_agree_run``) that ``tests/test_torch_smoke_phases.py``
    runs on the CPU at toy size; the card wrappers add the launch counts,
    the kernel checks and the profiles. Every earlier train path passes
    ``remat=False`` (``_train``), as measured before remat existed.
    ``[mamba_train]``: falcon-mamba-7b at full width and depth (64 layers,
    7.27 G params, bf16), dp 1, 1 x 4096 tokens (train_4k's length, the
    batch cut from 256 for one card), remat on, the chunked scan (chunk
    256; on the card ``ssm_scan_train``'s forward and backward kernels),
    packed fused ``sgd(0.1, 0.9)``, 3 steps: the first apart, ms/step,
    tokens/s, peak, one step profiled, ``fused_sgd`` launches = 3 x 13
    buckets, ``ssm_scan_train`` 3 x 2 x 64 and ``ssm_scan_bwd`` 3 x 64; then ``fused_sgd_1d`` on
    buffers of the largest bucket's 4,294,967,296 elements (past int32
    range) and 3 fewer (the tail), bit-equal to its plain version.
    ``[mamba_remat]``: the same model at 2 layers (a depth cut), 1 x 4096,
    2 steps, remat {off, on, dots} x scan {assoc, chunked 256}: peak and
    ms/step each, params bit-equal across remat under
    ``torch.use_deterministic_algorithms(True)`` (cuBLAS made deterministic
    by ``CUBLAS_WORKSPACE_CONFIG``, set before the first product), and
    whether chunking lowered the peak. ``[dense_train]``: olmo-1b and
    stablelm-1.6b at full width and depth on ``[main]``'s cell, remat off,
    counted and profiled like ``[main]``. ``[dense_agree]``: reduced fp32
    olmo-1b, stablelm-1.6b, internlm2-20b, llava (with image embeddings) and
    falcon-mamba (remat, chunked scan) trained at dp 4 on the card and on
    the CPU under ``[agree]``'s rule; the four dense members served on both
    within 1e-5 with equal greedy tokens.

16. The encoder-decoder family and routed MoE, each a depth-cut or full
    config at full width with random bf16 weights from seed 0, each body
    CPU-callable (``dense_train_run``, ``serve_run``, ``eval_run``,
    ``jamba_train_run``, ``jamba_remat_pair``, ``combine_check``,
    ``dense_agree_run``). ``[whisper_train]``: whisper-base at full width
    and depth (6 + 6 layers) on ``[dense_train]``'s path, dp 4, 4 x 448
    tokens a replica with seeded 0.02 x N(0, 1) audio frames (1,500 a
    sequence; ``_stub_trainer_cls``), 8 steps, counted, profiled, then the
    sweep on the largest replica-stacked bucket at alpha 0.5.
    ``[serve_whisper]``: batch 8, 1,500 frames, a 16-token prompt, 64 new
    tokens, ``max_seq`` 448 (``serve_run``; the encoder's share of the
    prefill timed alone). ``[jamba_eval]``: jamba at full width, one
    hybrid unit (8 layers: 7 Mamba, attention at 4, 4 MoE), scored on 1 x
    4,096 tokens through the scan kernel (7 launches a forward), then
    ``ssm_scan`` against its plain loop at (1, 4096, 8192, 16).
    ``[serve_jamba]``: the same 8 layers served at batch 4, a 512-token
    prompt, 32 new tokens, ``max_seq`` 4,096. ``[jamba_train]``: jamba at
    2 layers (Mamba + MLP, Mamba + MoE), dp 2 on mesh (2, 1, 1) in its
    fsdp mode, 1 x 1,024 tokens a replica, remat, the chunked scan (256),
    3 steps, counted and profiled; then plain remat against
    ``remat_policy="save_moe_combine"`` under deterministic algorithms
    (peak, ms/step, params bit-equal) and the sweep on the largest
    replica-stacked bucket at alpha 0.5. ``[serve_kimi]``: kimi-k2 at one
    layer (384 experts, top-8, a shared expert), a 1,024-token prompt, 16
    new tokens, batch 1, ``moe_dropped_frac`` over the prompt, and the
    k = 8 combine recorded on the card against the CPU's on the same
    inputs, bit for bit. ``[encdec_moe_agree]``: reduced fp32 whisper
    (with frames), jamba and kimi-k2 under ``[dense_agree]``'s rule.

17. MLA and the MTP head: deepseek-v3 at full width (d 7168, 128 heads,
    q_lora 1536, kv_lora 512, nope/rope 128/64, v 128, vocab 129,280, 256
    experts top-8 and a shared one, d_ff 18,432), random bf16 weights from
    seed 0, cut in depth (671 G params do not fit one card); no kernel
    lies on its MLA or MoE path, and training runs ``fused_sgd``. Bodies
    CPU-callable (``eval_run``, ``serve_run``, ``mla_cache_bytes``,
    ``deepseek_train_run``, ``dense_agree_run``). ``[deepseek_eval]``: the
    first 4 layers (3 dense, 1 MoE) with the MTP head (its block MoE),
    26.7 G params, scoring 1 x 2,048 tokens through ``make_loss_fn``, 3
    forwards: ms, ``ce``, ``mtp_ce``, ``moe_aux``, ``moe_dropped_frac``,
    peak, the first CE within 1 of ln(vocab), one forward profiled.
    ``[serve_deepseek]``: the same 4 layers in ``ServingEngine`` (the
    absorbed-latent decode over the ``(c_kv, k_rope)`` cache): batch 4, a
    1,024-token prompt, 32 new tokens, ``max_seq`` 4,096, as
    ``[serve_kimi]`` (the k = 8 combine card against CPU), with the
    cache's bytes per token and layer beside the MHA cache of the same
    heads; the decode bound leaves out the MTP head, which decode never
    reads. ``[deepseek_train]``: 1 layer with the MTP head (its block then
    dense), 3.12 G params a replica, dp 2 on mesh (2, 1, 1) in its fsdp
    mode, sync gossip, packed fused sgd, 1 x 1,024 tokens a replica, remat
    off, 3 steps, ``fused_sgd`` launches = 3 x buckets, profiled; then the
    sweep on the largest replica-stacked bucket at alpha 0.5.
    ``[deepseek_agree]``: reduced fp32 deepseek at 4 layers under
    ``[dense_agree]``'s rule.

18. The launch tooling, each body CPU-callable (``dryrun_check_run``,
    ``comm_accounting_run``, ``mix_flat_run``, ``examples_run``).
    ``[dryrun_check]``: the dry run's own ``trace_train`` (qwen3-0.6b at
    full width, 2 replicas of 1 x 4,096 tokens, remat on: train_4k's
    sequence, the batch cut for one card) and ``trace_serve("decode")``
    (batch 8 against a 32,768 cache, ``[serve_qwen]``'s sizes), each
    counted once on ``meta`` and once on the card: FLOPs and op bytes
    equal exactly, the meta live peak within 10% of the measured peak of
    one more step, the compute term (FLOPs over 989 TFLOP/s) no larger
    than that step's device busy time, no kernel launched; the measured
    ms, busy ms and both roofline terms as shares of the measured time.
    ``[comm_accounting]``: on ``[main]``'s path (dp 4, 13 buckets) the
    bytes the exchange returns in one step equal ``wire_bytes_per_step``'s
    ``raw_bytes`` a replica; on ``async_wire``'s (int8, subset 0.5) over
    one protocol period they equal the sum of ``sent_bytes_at``, printed
    beside ``period x total_bytes``. ``[mix_flat]``: ``gossip_mix_flat``
    on 155,582,464 + 77 elements, bf16 and fp32, one launch each,
    bit-equal to the plain version, input untouched, timed against
    ``torch.lerp`` in 7 interleaved rounds; ``gossip_mix_tree`` over
    full-width qwen3-0.6b's leaves, one launch a leaf, bit-equal.
    ``[examples]``: ``quickstart --steps 20``, ``gossip_vs_agd --steps 10
    --protocols gossip,agd`` and ``serve_batched`` on the card.

19. In-pod FSDP with one process per mesh position (``fsdp_ranks_run``,
    CPU-callable; ``phase_fsdp_ranks``). The card has one GPU and NCCL
    takes one card a rank, so the four ranks of the (pod 1, data 2,
    model 2) fsdp mesh share it over gloo, which carries their CUDA
    tensors (``init_replica_group(backend="gloo")``; dp 1, so no
    point-to-point exchange, which gloo has no CUDA form of). The kernels
    are built before the ranks start, and each rank reports its record
    to this process. ``[fsdp_ranks]``: qwen3-0.6b at full width and depth
    in bf16, ``dist_mode="fsdp"``, each rank 1 x 256 tokens and only its
    stretch of every bucket, packed fused ``sgd(0.1, 0.9)`` at alpha 0, 4
    steps: rank 0's ms/step, every rank's peak, its ``fused_sgd``
    launches (4 x buckets), the bytes its in-replica all-gather and
    reduce-scatter received a step and their ms (ms/step, bytes and ms
    over one window, the steps after the first) against the dry run's
    count (``launch/roofline.py: in_replica_bytes``; equal to the padded
    stretches' bytes), and one sweep on its largest stretch bit-equal to
    the plain version. ``[fsdp_ranks_agree]``: [agree]'s reduced fp32
    model on the same mesh, the 4 ranks against the stacked shard-local
    run on the card within rtol = atol = 2e-4 (losses and gathered
    params); the ranks' checkpoint restores bit for bit in the stacked run
    and the stacked run's in the ranks. A gloo refusal of a CUDA
    collective is recorded as "not measured (needs 2+ cards)".

20. The per-leaf engines (the launcher's default path) with one process
    per mesh position (``leaf_ranks_run``, CPU-callable;
    ``phase_leaf_ranks``), on the same four gloo ranks of the (1, 2, 2)
    fsdp mesh: each rank holds its piece of every leaf, and the forward
    all-gathers each leaf and the backward reduce-scatters its gradient.
    ``[leaf_ranks]``: qwen3-0.6b at full width and depth in bf16, 1 x 256
    tokens a rank, per-leaf ``sgd(0.1, 0.9)`` with ``mix_impl=
    gossip_mix_1d`` (dp 1: no mix runs), 4 steps: rank 0's ms/step, every
    rank's peak, the bytes its per-leaf all-gathers and reduce-scatters
    received a step and their ms over one window against the padded
    pieces' bytes (asserted equal) and ``in_replica_bytes``' count, and
    one ``gossip_mix_1d`` launch on its largest piece at alpha 0.5 against
    a seeded partner, bit-equal to the plain version (its launch counted
    apart from the path's). ``[leaf_ranks_agree]``: [agree]'s reduced fp32
    model on the same mesh, per-leaf sgd and lars on the 4 ranks against
    the stacked per-leaf run on the card: losses and gathered params
    within rtol = atol = 2e-4, lars's trust ratios within rtol 2e-6, and
    the ranks' checkpoint and the stacked one restored into each other bit
    for bit.

21. Expert parallelism over ``model`` and serving over the ranks
    (``moe_ranks_run``, CPU-callable; one world of four gloo ranks of the
    (1, 2, 2) fsdp mesh, as in 19-20). ``[moe_ranks]``: jamba-v0.1-52b at
    full width (d 4096, 16 experts top-2, d_ff 14,336, vocab 65,536,
    bf16) cut to 2 of 32 layers (layer 1 carries the MoE), 1 x 256 tokens
    a rank, per-leaf ``sgd(0.1, 0.9)``, 3 steps: each rank runs its 8 of
    16 experts (``models.moe._expert_compute_manual``), gathers them over
    its batch group only and sums the partial outputs over its model
    group; the bytes of every collective a step (asserted equal to
    ``_moe_counts``, from the leaf shapes), their ms, the collectives'
    share of ms/step over one window, the peak a rank, the first loss;
    then the same steps with the experts gathered whole
    (``_no_model_group``) where four such ranks fit the card
    (``_whole_fits``; else "not measured"). ``[moe_ranks_agree]``:
    reduced fp32 jamba, packed and per-leaf (remat off, on and
    ``save_moe_combine``), 3 steps, against the stacked runs on the card
    within 1e-5, remat bit-equal, the model-group collectives of a step
    counted. ``[serve_ranks]``: the same 2-layer jamba served over the
    ranks (batch 4, 2 rows a rank, prompt 512, 32 new tokens,
    ``max_seq`` 4096): the weights' one gather (bytes against the
    pieces' count), prefill ms, decode ms a token, the peak; the
    first-token logits and greedy tokens against the one-process
    ``ServingEngine`` on the same weights; reduced fp32: tokens equal and
    logits within 1e-5. No kernel is on these paths.

22. The sequence-parallel decode cache (``seq_ranks_run``, CPU-callable;
    ``[serve_seq_ranks]``, one world of four gloo ranks of the same
    mesh): batch 1 does not split over the batch group, so each rank
    holds its stretch of every attention / MLA leaf (``serve.step.
    rank_cache_init``) and the decode attention combines the ranks'
    partial softmaxes in one all-gather a layer. qwen3-0.6b at full
    width and depth (bf16) with decode_32k's cache (``max_seq`` 32,768)
    and as long_500k's windowed variant (``resolve_config``: window
    8,192), prompt 4,096; deepseek-v3 at full width cut to its 3 dense
    MLA layers, ``max_seq`` 32,768, prompt 1,024; 32 new tokens each:
    the cache's bytes a rank against the whole, prefill ms, decode ms a
    token (CUDA events), the serving peak, the combine's bytes a token
    against the count from the shapes, the first-token logits against
    the one-process engine and how many greedy tokens agree; every rank
    bit-equal; each run's reduced fp32 twin (the windowed one a wrapping
    16-slot ring): tokens equal and logits within 1e-5. No kernel is on
    this path.

Prints each phase's wall seconds on the ``[done]`` line, the kernels' JSON
line, the card's name and power limit, and last the line ``{"ok": true,
"device": {...}}``. Exits non-zero on any failure.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet: device memory,
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12   # and bf16 on the tensor cores (dense)
DP, SEQ, PER_REPLICA = 4, 256, 2
GOSSIP_ALPHA = 0.5                   # the bundle's default mix weight
MAIN_STEPS, SHORT_STEPS, SHORT_LAYERS = 8, 4, 2
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4   # kernel checks
ASYNC_WIRE = dict(protocol="gossip_async", staleness=2, drop_rate=0.2,
                  wire_dtype="int8", gossip_subset=0.5)
AGREE_BUCKET_BYTES = 96 << 10        # 5 buckets for the small model
OPT_KERNELS = ("fused_adamw", "fused_adamw_q", "fused_lars")
KERNELS = ("gossip_mix", "gossip_mix_q", "fused_sgd", "fused_sgd_q") \
    + OPT_KERNELS + ("ssm_scan", "flash_attention", "ssm_scan_train",
                     "ssm_scan_bwd")
SSM_SHAPE = (2, 4096, 8192, 16)   # falcon-mamba's scan at 2 x 4096 tokens
SSM_BWD_CHECK_SHAPE = (1, 4096, 8192, 16)   # one sequence of it
EVAL_B, EVAL_S, EVAL_FORWARDS = 2, 4096, 3   # train_4k's length
ATTN_S, ATTN_S_LONG = 4096, 32768            # and prefill_32k's
# serving at full width: decode_32k's cache length, batch 8, a 512-token
# prompt, 32 new tokens
SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 8, 512, 32, 32768
# learning rates on step_decay: the full-width paths, and the small agree
# runs (AdamW's as the CPU tests: tests/test_torch_optim.py)
FULL_LR = {"sgd": 0.1, "adamw": 0.01, "lars": 0.1}
AGREE_LR = {"sgd": 0.1, "adamw": 1e-3, "lars": 0.1}
ADAMW_WD, LARS_WD = 0.02, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rounds_ms(fns: dict, rounds: int = 7, reps: int = 10) -> dict:
    """Each of ``fns`` timed in ``rounds`` interleaved rounds (every one in
    turn, each time the mean of ``reps`` calls by ``time_ms``): the median,
    min and max over the rounds."""
    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            ts[k].append(time_ms(fn, reps=reps, warmup=1))
    return {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
            for k, v in ts.items()}


def bound(nbytes: float, flops: float, ops_ms: float = None) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate, which is the fp32
    rate unless ``ops_ms`` gives their time at the rates of their types."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3 if ops_ms is None else ops_ms
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_build():
    """Builds every kernel; then proves that flash_attention's products run
    on the tensor cores: per instantiation, ptxas's registers and spill
    bytes and the count of HGMMA (wgmma) instructions in its SASS. Raises
    on a spill or an instantiation without HGMMA."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    for src in secs:
        for line in _build.lib_path(src).with_suffix(".log").read_text(
                ).splitlines():
            if "Used" in line and "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    src = "flash_attention.cu"
    report = _build.ptxas_report(src)
    hgmma = _build.sass_count(src, "HGMMA")
    bad, products = [], 0
    for fn, rep in report.items():
        m = re.search(r"flash_kernelILi(\d+)ELb([01])E", fn)
        name = (f"flash_kernel<{m.group(1)}, "
                f"{'fp32' if m.group(2) == '1' else '16-bit'} output>"
                if m else fn)
        row = dict(registers=rep["registers"],
                   spill_bytes=rep["spill_bytes"], hgmma=hgmma.get(fn, 0))
        log(f"[build] {src} {name}: {json.dumps(row)}")
        # the products run in flash_kernel; masked_rows_kernel (rows with no
        # admissible key) only sums v
        products += bool(m)
        if row["spill_bytes"] or (m and not row["hgmma"]):
            bad.append(name)
    if not products or bad:
        raise AssertionError(f"{src}: spills or no HGMMA in {bad or 'any'}")


def _inputs(n, dtype, gen, dev):
    mk = lambda s: (torch.randn((DP, n), generator=gen, device=dev) * s).to(dtype)
    return mk(1.0), mk(0.1), mk(1.0), mk(0.1)  # p, g, partner, mom


def _encode(x, code):
    from repro_torch.kernels.quantize import encode_wire, wire_key
    return encode_wire(x, code, keys=wire_key(0, np.arange(x.shape[0]), 0))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor on the CPU, one-byte codes as their raw bytes."""
    t = t.cpu()
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _diff(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def phase_kernels(layout, dev):
    """Bit equality with the plain versions at the main path's shapes."""
    from repro_torch.kernels import (fused_sgd_bucket, fused_sgd_plain,
                                     gossip_mix_bucket, gossip_mix_plain,
                                     gossip_mix_q_plain)
    row = torch.tensor([0.5, 0.0, 0.25, 0.5], device=dev)
    alphas = (("0.5", 0.5), ("0", 0.0), ("tensor 0.25",
                                         torch.tensor(0.25, device=dev)),
              ("per-row", row))
    err = dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(kind, tag, an, got_want_pairs):
        e = max(_diff(g, w) for g, w in got_want_pairs)
        eq = all(torch.equal(g, w) for g, w in got_want_pairs)
        err[kind] = max(err[kind], e)
        log(f"[check] {kind} {tag} alpha {an}: equal={eq} max_abs_err={e}")
        assert eq, f"{kind} disagrees with its plain version"

    def mix_and_sweep(tag, p, g, b, m, wire_kinds, mix_plain):
        mix_kind, sgd_kind = wire_kinds
        scales = b["s"] if isinstance(b, dict) else None
        partner = b["q"] if isinstance(b, dict) else b
        for an, alpha in alphas:
            want = mix_plain(p, alpha)
            got = gossip_mix_bucket(p.clone(), b, alpha)
            torch.cuda.synchronize()
            check(mix_kind, tag, an, [(got, want)])
            del got, want
            wp, wm = fused_sgd_plain(p, g, partner, m, lr=LR, alpha=alpha,
                                     momentum=MOMENTUM, weight_decay=WD,
                                     partner_scales=scales)
            gp, gm = p.clone(), m.clone()
            fused_sgd_bucket(gp, g, b, gm, lr=LR, alpha=alpha,
                             momentum=MOMENTUM, weight_decay=WD)
            torch.cuda.synchronize()
            check(sgd_kind, tag, an, [(gp, wp), (gm, wm)])
            del gp, gm, wp, wm

    for dtype in (torch.float32, torch.bfloat16):
        for n in (min(layout.bucket_sizes), max(layout.bucket_sizes)):
            p, g, b, m = _inputs(n, dtype, gen, dev)
            tag = f"{str(dtype)[6:]} ({DP}, {n})"
            mix_and_sweep(tag, p, g, b, m, ("gossip_mix", "fused_sgd"),
                          lambda a_, al: gossip_mix_plain(a_, b, al))
            if dtype == torch.float32:  # a bf16 wire on an fp32 bucket
                b16 = b.to(torch.bfloat16)
                mix_and_sweep(tag + " bf16 partner", p, g, b16, m,
                              ("gossip_mix", "fused_sgd"),
                              lambda a_, al: gossip_mix_plain(a_, b16, al))
                del b16
            for code in ("int8", "fp8"):
                enc = _encode(b, code)
                mix_and_sweep(
                    f"{tag} {code} codes", p, g, enc, m,
                    ("gossip_mix_q", "fused_sgd_q"),
                    lambda a_, al: gossip_mix_q_plain(a_, enc["q"], enc["s"],
                                                      al))
                del enc
            # the wire encode itself: card against CPU on a row slice
            x = p[:, :min(n, 1 << 20)].contiguous()
            for code in ("int8", "fp8"):
                card, cpu = _encode(x, code), _encode(x.cpu(), code)
                eq = all(torch.equal(_bits(card[k]), _bits(cpu[k]))
                         for k in ("q", "s"))
                log(f"[check] encode {code} {tag} slice {tuple(x.shape)}: "
                    f"card equals cpu={eq}")
                assert eq, "the wire encode differs between card and CPU"
            del p, g, b, m, x
            torch.cuda.empty_cache()
    return err


def phase_time(layout, dev):
    """Kernel, plain and yardstick times at the largest bucket in bf16
    (the main path's dtype), the fused sweep over all buckets, and the
    int8 encode."""
    from repro_torch.core.gossip import wire_subset_of
    from repro_torch.kernels import (fused_sgd_bucket, fused_sgd_plain,
                                     gossip_mix_bucket, gossip_mix_plain,
                                     gossip_mix_q_plain)
    from repro_torch.kernels.quantize import WireFormat
    gen = torch.Generator(device=dev).manual_seed(1)
    n = max(layout.bucket_sizes)
    p, g, b, m = _inputs(n, torch.bfloat16, gen, dev)
    enc = _encode(b, "int8")
    q, s = enc["q"], enc["s"]
    row = torch.tensor([0.5, 0.5, 0.0, 0.5], device=dev)
    elems = DP * n
    tiles = elems / 128
    # per element: the raw mix reads a, b and writes a (2 mul + 1 add); the
    # q-mix reads a (2 B), a code (1 B) and a 128th of a scale, writes a
    # (decode mul + the mix); the fused sweep reads p, g, partner, m and
    # writes p, m (the mix, m = mu*m + g, p - lr*m: 7 operations, 8 with
    # the decode)
    rounds = 7
    mix = rounds_ms({
        "gossip_mix": lambda: gossip_mix_bucket(p, b, 0.5),
        "gossip_mix_row_alpha": lambda: gossip_mix_bucket(p, b, row),
        "torch.lerp_": lambda: p.lerp_(b, 0.5),
        "gossip_mix_q": lambda: gossip_mix_bucket(p, enc, 0.5),
        "gossip_mix_q_row_alpha": lambda: gossip_mix_bucket(p, enc, row)},
        rounds=rounds)
    mix_bound = bound(3 * 2 * elems, 3 * elems)
    q_bound = bound(5 * elems + 4 * tiles, 4 * elems)
    for k, v in mix.items():
        bd = (q_bound if k.startswith("gossip_mix_q") else mix_bound)
        log(f"[time] {k} bf16 ({DP}, {n}), {rounds} interleaved rounds: "
            + json.dumps(dict(v, bound_ms=bd["bound_ms"],
                              share_of_bound=bd["bound_ms"] / v["median"])))

    def spread(key, name=None):
        name = name or key
        return {f"ms{key[len(name):]}": mix[key]["median"],
                f"ms{key[len(name):]}_min": mix[key]["min"],
                f"ms{key[len(name):]}_max": mix[key]["max"]}

    t = {
        "gossip_mix": dict(
            **spread("gossip_mix"),
            **spread("gossip_mix_row_alpha", "gossip_mix"),
            plain_ms=time_ms(lambda: gossip_mix_plain(p, b, 0.5)),
            library_ms=mix["torch.lerp_"]["median"],
            library_ms_min=mix["torch.lerp_"]["min"],
            library_ms_max=mix["torch.lerp_"]["max"], rounds=rounds,
            share_of_bound=mix_bound["bound_ms"] / mix["gossip_mix"]["median"],
            **mix_bound),
        "gossip_mix_q": dict(
            **spread("gossip_mix_q"),
            **spread("gossip_mix_q_row_alpha", "gossip_mix_q"),
            plain_ms=time_ms(lambda: gossip_mix_q_plain(p, q, s, 0.5)),
            library_ms=None, rounds=rounds,
            share_of_bound=q_bound["bound_ms"] / mix["gossip_mix_q"]["median"],
            **q_bound),
        "fused_sgd": dict(
            ms=time_ms(lambda: fused_sgd_bucket(p, g, b, m, lr=LR, alpha=0.5)),
            plain_ms=time_ms(lambda: fused_sgd_plain(p, g, b, m, lr=LR,
                                                     alpha=0.5)),
            library_ms=None,
            **bound(6 * 2 * elems, 7 * elems)),
        "fused_sgd_q": dict(
            ms=time_ms(lambda: fused_sgd_bucket(p, g, enc, m, lr=LR,
                                                alpha=0.5)),
            ms_row_alpha=time_ms(lambda: fused_sgd_bucket(p, g, enc, m, lr=LR,
                                                          alpha=row)),
            plain_ms=time_ms(lambda: fused_sgd_plain(
                p, g, q, m, lr=LR, alpha=0.5, partner_scales=s)),
            library_ms=None,
            **bound(11 * elems + 4 * tiles, 8 * elems)),
    }
    for k, v in t.items():
        log(f"[time] {k} bf16 ({DP}, {n}): " + json.dumps(v))
    del enc, q, s
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    enc_ms = time_ms(lambda: _encode(p, "int8"), reps=3, warmup=1)
    enc_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[time] encode int8 bf16 ({DP}, {n}): " + json.dumps(
        {"ms": enc_ms, "peak_extra_gb": enc_peak,
         **bound(2 * elems + elems + 4 * tiles, 0)}))
    del p, g, b, m
    torch.cuda.empty_cache()

    # every bucket of the layout, bf16: the fused sweep of one step and the
    # encode of each bucket, summed over the buckets a step sends
    bufs = [_inputs(sz, torch.bfloat16, gen, dev) for sz in layout.bucket_sizes]

    def sweep():
        for p_, g_, b_, m_ in bufs:
            fused_sgd_bucket(p_, g_, b_, m_, lr=LR, alpha=0.5)

    total = sum(DP * sz for sz in layout.bucket_sizes)
    sweep_ms = time_ms(sweep, reps=5, warmup=1)
    log(f"[time] fused_sgd sweep over all {layout.num_buckets} buckets bf16 "
        f"dp={DP}: " + json.dumps({"ms": sweep_ms,
                                   **bound(6 * 2 * total, 7 * total)}))
    per_bucket = [time_ms(lambda p_=p_: _encode(p_, "int8"), reps=2,
                          warmup=1) for p_, _, _, _ in bufs]
    sub = wire_subset_of(WireFormat("int8", ASYNC_WIRE["gossip_subset"]),
                         layout.num_buckets)
    steps = [sum(ms for ms, sel in zip(per_bucket, sub.selected(ph)) if sel)
             for ph in range(sub.period)]
    log("[time] encode int8 per step (subset "
        f"{ASYNC_WIRE['gossip_subset']}): " + json.dumps(
            {"ms_per_step": sum(steps) / len(steps), "ms_by_phase": steps,
             "ms_all_buckets": sum(per_bucket)}))
    del bufs, sweep
    torch.cuda.empty_cache()
    return t


def _adamw_coef(step: int) -> dict:
    from repro_torch.optim.optimizers import bias_correction
    return dict(lr=LR, c1=bias_correction(0.9, step + 1),
                c2=bias_correction(0.95, step + 1), weight_decay=ADAMW_WD)


def _opt_inputs(n, dtype, gen, dev):
    """p, g, partner of the bucket dtype, and fp32 m, v (v >= 0) and a
    LARS row scale, one per 128 elements."""
    p, g, b, m = _inputs(n, dtype, gen, dev)
    m = m.float()
    v = (torch.randn((DP, n), generator=gen, device=dev) * 1e-3).abs_()
    scale = torch.rand(DP * n // 128, generator=gen, device=dev) * 1e-2
    return p, g, b, m, v, scale


def phase_kernels_opt(layout, dev):
    """fused_adamw (raw, int8, fp8 and no partner) and fused_lars (bf16,
    fp32 and no partner) against their plain versions on the largest
    bucket, fp32 and bf16, static, () and per-row alpha: bit equality.
    Every case runs on copies, freed before the next (the plain AdamW chain
    holds several bucket-sized fp32 temporaries)."""
    from repro_torch.kernels import (fused_adamw_bucket, fused_adamw_plain,
                                     fused_lars_bucket, fused_lars_plain)
    row = torch.tensor([0.5, 0.0, 0.25, 0.5], device=dev)
    alphas = (("0.5", 0.5), ("tensor 0.25", torch.tensor(0.25, device=dev)),
              ("per-row", row))
    err = dict.fromkeys(OPT_KERNELS, 0.0)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = max(layout.bucket_sizes)
    coef = _adamw_coef(2)

    def check(kind, tag, an, pairs):
        e = max(_diff(g_, w_) for g_, w_ in pairs)
        eq = all(torch.equal(g_, w_) for g_, w_ in pairs)
        err[kind] = max(err[kind], e)
        log(f"[check_opt] {kind} {tag} alpha {an}: equal={eq} "
            f"max_abs_err={e}")
        assert eq, f"{kind} disagrees with its plain version"

    for dtype in (torch.float32, torch.bfloat16):
        p, g, b, m, v, scale = _opt_inputs(n, dtype, gen, dev)
        tag = f"{str(dtype)[6:]} ({DP}, {n})"
        for pname in ("raw", "int8", "fp8", "none"):
            payload = (b if pname == "raw" else None if pname == "none"
                       else _encode(b, pname))
            coded = isinstance(payload, dict)
            partner = payload["q"] if coded else payload
            scales = payload["s"] if coded else None
            for an, alpha in (alphas if payload is not None
                              else (("-", 0.0),)):
                want = fused_adamw_plain(p, g, partner, m, v, alpha=alpha,
                                         partner_scales=scales, **coef)
                got = (p.clone(), m.clone(), v.clone())
                fused_adamw_bucket(got[0], g, payload, got[1], got[2],
                                   alpha=alpha, **coef)
                torch.cuda.synchronize()
                check("fused_adamw_q" if coded else "fused_adamw",
                      f"{tag} {pname}", an, list(zip(got, want)))
                del got, want
                torch.cuda.empty_cache()
            del payload, partner, scales
        for pname in ("bf16", "fp32", "none"):
            partner = (None if pname == "none" else
                       b.to(torch.bfloat16 if pname == "bf16"
                            else torch.float32))
            for an, alpha in (alphas if partner is not None
                              else (("-", 0.0),)):
                want = fused_lars_plain(p, g, partner, m, scale, lr=LR,
                                        alpha=alpha, momentum=MOMENTUM,
                                        weight_decay=LARS_WD)
                got = (p.clone(), m.clone())
                fused_lars_bucket(got[0], g, partner, got[1], scale, lr=LR,
                                  alpha=alpha, momentum=MOMENTUM,
                                  weight_decay=LARS_WD)
                torch.cuda.synchronize()
                check("fused_lars", f"{tag} {pname} partner", an,
                      list(zip(got, want)))
                del got, want
                torch.cuda.empty_cache()
            del partner
        del p, g, b, m, v, scale
        torch.cuda.empty_cache()
    return err


def phase_time_opt(layout, dev):
    """fused_adamw and fused_lars per launch on the largest bucket in bf16
    (the full-width paths' dtype) beside their bounds and plain versions;
    torch._fused_adamw_ for orientation only (not the same function: no
    mix, decay as p * (1 - lr * wd), bf16 moments as torch.optim.AdamW
    keeps them); the LARS norm prepass per bucket and per step."""
    from repro_torch.kernels import (fused_adamw_bucket, fused_adamw_plain,
                                     fused_lars_bucket, fused_lars_plain)
    from repro_torch.optim.optimizers import _lars_row_scale
    gen = torch.Generator(device=dev).manual_seed(4)
    big = max(range(layout.num_buckets), key=lambda i: layout.bucket_sizes[i])
    n = layout.bucket_sizes[big]
    p, g, b, m, v, scale = _opt_inputs(n, torch.bfloat16, gen, dev)
    enc = _encode(b, "int8")
    b32 = b.float()
    row = torch.tensor([0.5, 0.5, 0.0, 0.5], device=dev)
    coef = _adamw_coef(2)
    lars_kw = dict(lr=LR, momentum=MOMENTUM, weight_decay=LARS_WD)
    elems = DP * n
    tiles = elems / 128
    # bytes per element (each input read once, each output written once):
    # adamw reads p, g, partner (2 B each in bf16; 1 B + 4/128 for codes)
    # and m, v (4 B each) and writes p, m, v: 24, 23.03 with int8 codes,
    # 22 with no partner. fp32 operations: the mix 3 (4 with the decode),
    # m 3, v 4, u 4 (two divisions, a root, an add), decay 2, step 2.
    # lars reads p, g, partner, m and a 128th of a scale, writes p, m:
    # 16.03 with a bf16 partner, 18.03 with fp32; operations: the mix 3,
    # decay 2, m 3, step 2.
    t = {
        "fused_adamw": dict(
            ms=time_ms(lambda: fused_adamw_bucket(p, g, b, m, v, alpha=0.5,
                                                  **coef)),
            ms_row_alpha=time_ms(lambda: fused_adamw_bucket(
                p, g, b, m, v, alpha=row, **coef)),
            ms_no_partner=time_ms(lambda: fused_adamw_bucket(
                p, g, None, m, v, alpha=0.0, **coef)),
            plain_ms=time_ms(lambda: fused_adamw_plain(p, g, b, m, v,
                                                       alpha=0.5, **coef),
                             reps=3, warmup=1),
            library_ms=None,
            bound_ms_no_partner=bound(22 * elems, 15 * elems)["bound_ms"],
            **bound(24 * elems, 18 * elems)),
        "fused_adamw_q": dict(
            ms=time_ms(lambda: fused_adamw_bucket(p, g, enc, m, v, alpha=0.5,
                                                  **coef)),
            ms_row_alpha=time_ms(lambda: fused_adamw_bucket(
                p, g, enc, m, v, alpha=row, **coef)),
            plain_ms=time_ms(lambda: fused_adamw_plain(
                p, g, enc["q"], m, v, alpha=0.5, partner_scales=enc["s"],
                **coef), reps=3, warmup=1),
            library_ms=None,
            **bound(23 * elems + 4 * tiles, 19 * elems)),
        "fused_lars": dict(
            ms=time_ms(lambda: fused_lars_bucket(p, g, b, m, scale, alpha=0.5,
                                                 **lars_kw)),
            ms_row_alpha=time_ms(lambda: fused_lars_bucket(
                p, g, b, m, scale, alpha=row, **lars_kw)),
            ms_f32_partner=time_ms(lambda: fused_lars_bucket(
                p, g, b32, m, scale, alpha=0.5, **lars_kw)),
            plain_ms=time_ms(lambda: fused_lars_plain(
                p, g, b, m, scale, alpha=0.5, **lars_kw), reps=3, warmup=1),
            library_ms=None,
            bound_ms_f32_partner=bound(18 * elems + 4 * tiles,
                                       10 * elems)["bound_ms"],
            **bound(16 * elems + 4 * tiles, 10 * elems)),
    }
    try:  # orientation only: a different function and moment dtype
        pb, gb = p.clone(), g.clone()
        mb, vb = m.to(torch.bfloat16), v.to(torch.bfloat16)
        steps = [torch.tensor(3.0, device=dev)]
        t["fused_adamw"]["torch_fused_adamw_bf16_ms"] = time_ms(
            lambda: torch._fused_adamw_(
                [pb], [gb], [mb], [vb], [], steps, lr=LR, beta1=0.9,
                beta2=0.95, weight_decay=ADAMW_WD, eps=1e-8, amsgrad=False,
                maximize=False))
        del pb, gb, mb, vb
    except Exception as exc:  # noqa: BLE001 - a yardstick, not the port
        t["fused_adamw"]["torch_fused_adamw_bf16_ms"] = f"failed: {exc}"
    for k, val in t.items():
        log(f"[time_opt] {k} bf16 ({DP}, {n}): " + json.dumps(val))

    # the LARS prepass on the largest bucket: its time and extra memory,
    # with a bf16 partner and with the fp32 partner a decoded wire gives
    pre = dict(weight_decay=LARS_WD, trust_coef=1e-3, eps=1e-9)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _lars_row_scale(layout, big, p, g, b32, alpha=row, **pre)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[time_opt] lars prepass bucket {big} ({DP}, {n}): " + json.dumps({
        "ms_bf16_partner": time_ms(lambda: _lars_row_scale(
            layout, big, p, g, b, alpha=0.5, **pre), reps=3, warmup=1),
        "ms_fp32_partner_row_alpha": time_ms(lambda: _lars_row_scale(
            layout, big, p, g, b32, alpha=row, **pre), reps=3, warmup=1),
        "peak_extra_gb_fp32_partner": peak}))
    del p, g, b, m, v, scale, enc, b32
    torch.cuda.empty_cache()

    bufs = [_inputs(sz, torch.bfloat16, gen, dev)[:3]
            for sz in layout.bucket_sizes]

    def prepass():
        for i, (p_, g_, b_) in enumerate(bufs):
            _lars_row_scale(layout, i, p_, g_, b_, alpha=0.5, **pre)

    step_ms = time_ms(prepass, reps=3, warmup=1)
    log(f"[time_opt] lars prepass per step, all {layout.num_buckets} "
        f"buckets bf16 dp={DP}: " + json.dumps({"ms": step_ms}))
    t["fused_lars"]["prepass_ms_per_step"] = step_ms
    del bufs
    torch.cuda.empty_cache()
    return t


def phase_check_ssm(dev, shapes=(SSM_SHAPE, (3, 1000, 100, 5),
                                  (2, 1, 8192, 16)),
                    bwd_shapes=(SSM_BWD_CHECK_SHAPE, (3, 1000, 100, 5),
                                (2, 1, 8192, 16), (1, 33, 7, 3))):
    """ssm_scan against its plain loop, bit for bit; then, at
    ``bwd_shapes``, the scan under autograd (``ssm_scan_train``): h against
    ``ssm_scan_ref`` and the backward kernel's (ddA, ddBx) against
    ``ssm_scan_bwd_ref``, bit for bit."""
    from repro_torch.kernels import ssm_scan, ssm_scan_train
    from repro_torch.kernels.ref import ssm_scan_bwd_ref, ssm_scan_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    err = 0.0
    for shape in shapes:
        dA = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
        dBx = torch.randn(shape, generator=gen, device=dev)
        got = ssm_scan(dA, dBx)
        want = ssm_scan_ref(dA, dBx)
        torch.cuda.synchronize()
        eq, e = torch.equal(got, want), _diff(got, want)
        err = max(err, e)
        log(f"[check_ssm] {shape}: equal={eq} max_abs_err={e}")
        assert eq, "ssm_scan disagrees with its plain version"
        del dA, dBx, got, want
        torch.cuda.empty_cache()
    bwd_err = 0.0
    for shape in bwd_shapes:
        dA = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
        dBx, dh = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(2))
        a = dA.clone().requires_grad_(True)
        b = dBx.clone().requires_grad_(True)
        h = ssm_scan_train(a, b)
        h.backward(dh)
        h = h.detach()
        fwd_eq = torch.equal(h, ssm_scan_ref(dA, dBx))
        want_a, want_b = ssm_scan_bwd_ref(dA, h, dh)
        torch.cuda.synchronize()
        eq = torch.equal(a.grad, want_a) and torch.equal(b.grad, want_b)
        e = max(_diff(a.grad, want_a), _diff(b.grad, want_b))
        bwd_err = max(bwd_err, e)
        log(f"[check_ssm] ssm_scan_train {shape}: forward_equal={fwd_eq} "
            f"backward_equal={eq} max_abs_err={e}")
        assert fwd_eq and eq, "ssm_scan_train disagrees with its plain versions"
        del dA, dBx, dh, a, b, h, want_a, want_b
        torch.cuda.empty_cache()
    return {"ssm_scan": err, "ssm_scan_bwd": bwd_err}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def _attn_qkv(gen, dev, B, S, T, d, dtype, heads, kv_heads):
    """q (B, heads, S, d); k and v drawn for kv_heads and repeated to
    heads, as GQA attention repeats them."""
    rep = heads // kv_heads
    mk = lambda h, n, sc: (torch.randn((B, h, n, d), generator=gen,
                                       device=dev) * sc).to(dtype)
    return (mk(heads, S, 0.3), mk(kv_heads, T, 0.3).repeat_interleave(rep, 1),
            mk(kv_heads, T, 1.0).repeat_interleave(rep, 1))


def _attn_agree(got, want) -> tuple:
    """(max |got - want|, within tolerance): fp32 rtol = atol = 2e-5;
    bf16 one bf16 ulp of the plain output plus 2e-5."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = (2e-5 + 2e-5 * w.abs() if got.dtype == torch.float32
           else _bf16_ulp(w) + 2e-5)
    return err.max().item(), bool((err <= lim).all())


def phase_check_attn(dev, S=ATTN_S, heads=16, kv_heads=8, d=128):
    """flash_attention against its plain version (dense attention_ref, and
    the reference's block rule for rows with no admissible key) at
    qwen3-0.6b's attention shapes, and at S 256, T 128, window 8, where
    rows 135-255 have no admissible key, for four (block_q, block_k)."""
    from repro_torch.kernels import flash_mha
    from repro_torch.kernels.flash_attention import flash_attention_plain
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"[check_attn] torch.backends.cuda.matmul.allow_tf32={tf32} (the "
        f"plain version's fp32 einsum must not round to TF32)")
    assert not tf32
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [(S, S, True, None, d, 128), (S, S, True, S // 4, d, 128),
             (S // 4, S, False, None, d, 128),
             (S // 8, S // 8, True, None, d // 2, 128)]
    cases += [(256, 128, causal, 8, d, blocks) for causal in (True, False)
              for blocks in ((128, 128), (32, 32), (64, 128), (128, 32))]
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for s_, t_, causal, window, dd, blocks in cases:
            bq, bk = blocks if isinstance(blocks, tuple) else (blocks,) * 2
            q, k, v = _attn_qkv(gen, dev, 1, s_, t_, dd, dtype, heads,
                                kv_heads)
            kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)
            got = flash_mha(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            e, ok = _attn_agree(got, want)
            err[dtype] = max(err[dtype], e)
            log(f"[check_attn] {str(dtype)[6:]} H {heads} S {s_} T {t_} d {dd} "
                f"causal={causal} window={window} blocks ({bq}, {bk}): "
                f"within_tolerance={ok} max_abs_err={e}")
            assert ok, "flash_attention disagrees with its plain version"
            del q, k, v, got, want
            torch.cuda.empty_cache()
    q = torch.zeros((1, heads, S - 1, d), device=dev)
    try:
        flash_mha(q, q, q, block_q=64)
    except ValueError as exc:
        log(f"[check_attn] S % block_q != 0 raises: {exc}")
    else:
        raise AssertionError("S % block_q != 0 did not raise")
    return {"flash_attention": err[torch.float32],
            "flash_attention_bf16": err[torch.bfloat16]}


def phase_time_ssm(dev, shape=SSM_SHAPE):
    """ssm_scan and its plain loop at falcon-mamba's scan shape. Bound:
    bytes, dA and dBx read and h written once (12 per element); no single
    PyTorch call computes a linear recurrence. Then the backward kernel of
    ``ssm_scan_train`` at the same shape against its plain loop
    ``ssm_scan_bwd_ref``. Bound: bytes, dh, dA and h read and ddA and ddBx
    written once (20 per element)."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ref import ssm_scan_bwd_ref, ssm_scan_ref
    from repro_torch.kernels.ssm_scan_kernel import _launch_bwd
    gen = torch.Generator(device=dev).manual_seed(7)
    dA = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
    dBx = torch.randn(shape, generator=gen, device=dev)
    n = dA.numel()
    t = dict(ms=time_ms(lambda: ssm_scan(dA, dBx), reps=10, warmup=2),
             plain_ms=time_ms(lambda: ssm_scan_ref(dA, dBx), reps=1,
                              warmup=1),
             library_ms=None, bytes=12 * n, **bound(12 * n, 2 * n))
    log(f"[time_ssm] {shape} fp32: " + json.dumps(t))
    h = ssm_scan(dA, dBx)
    dh = dBx
    del dBx
    tb = dict(ms=time_ms(lambda: _launch_bwd(dA, h, dh), reps=10, warmup=2),
              plain_ms=time_ms(lambda: ssm_scan_bwd_ref(dA, h, dh), reps=1,
                               warmup=1),
              library_ms=None, bytes=20 * n, **bound(20 * n, 3 * n))
    tb["share_of_bound"] = tb["bound_ms"] / tb["ms"]
    log(f"[time_ssm] ssm_scan_bwd {shape} fp32: " + json.dumps(tb))
    del dA, dh, h
    torch.cuda.empty_cache()
    return {"ssm_scan": t, "ssm_scan_bwd": tb}


def _attn_flops(B, H, S, T, d, causal) -> float:
    """Multiply-adds of q.k and p.v over the live (query, key) pairs, 2
    flops each."""
    pairs = S * (S + 1) // 2 if causal and S == T else S * T
    return 4.0 * B * H * pairs * d


def _attn_bound(q, k, v, causal) -> dict:
    """Bound of one attention call on these tensors. Bytes: q, k, v read
    once and o (q's dtype) written once. Operations: each product at the
    split-pass rate of its operands on the tensor cores: 989 TFLOP/s for two
    16-bit operands (their products are exact in fp32), 989/3 with one fp32
    operand (split into three bf16 pieces) and 989/6 with two; q.k at the
    rate of q and k, p.v at the rate of v with v (the fp32 p splits exactly
    into bf16 passes too, so this floor is low, never flattering). Also
    every product at the fp32 CUDA-core 67 TFLOP/s, the ceiling of fp32
    FMAs outside the tensor cores, as ``bound_ms_fp32_cuda_cores``."""
    B, H, S, d = q.shape
    flops = _attn_flops(B, H, S, k.shape[2], d, causal)
    rate = lambda a, b: BF16_TC_FLOPS_PER_S / (1, 3, 6)[
        (a.dtype == torch.float32) + (b.dtype == torch.float32)]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    ops_ms = (flops / 2 / rate(q, k) + flops / 2 / rate(v, v)) * 1e3
    return dict(bytes=nbytes, flops=flops, **bound(nbytes, flops, ops_ms),
                bound_ms_fp32_cuda_cores=flops / FP32_FLOPS_PER_S * 1e3)


def phase_time_attn(dev, lengths=(ATTN_S, ATTN_S_LONG), heads=16, d=128):
    """flash_mha, causal bf16, B 1 at qwen3-0.6b's heads: the kernel, the
    plain dense version (at the first length only: at 32k its fp32 score
    matrix is 4 GB per head) and scaled_dot_product_attention on the same
    tensors. The bound is bf16's, on the tensor cores; the fp32 CUDA-core
    figure rides beside it. The kernels line's flash entry takes its times
    from ``[flash_path]``'s own call; these enter it as ``*_bf16`` keys."""
    from repro_torch.kernels import flash_mha
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for i, S in enumerate(lengths):
        q, k, v = _attn_qkv(gen, dev, 1, S, S, d, torch.bfloat16, heads,
                            heads // 2)
        reps = 10 if i == 0 else 2
        t = dict(S=S, ms=time_ms(lambda: flash_mha(q, k, v), reps=reps,
                                 warmup=1),
                 plain_ms=(time_ms(lambda: attention_ref(q, k, v), reps=3,
                                   warmup=1) if i == 0 else None),
                 library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True),
                                    reps=reps, warmup=1),
                 **_attn_bound(q, k, v, True))
        log(f"[time_attn] causal bf16 B 1 H {heads} S {S} d {d}: "
            + json.dumps(t))
        out[S] = t
        del q, k, v
        torch.cuda.empty_cache()
    # rows with no admissible key: S 256, T 128, window 8, blocks 32 (rows
    # 135-255 keyless, 224-255 with no live tile); no PyTorch call gives
    # such rows the reference's value (SDPA's bool mask makes them NaN)
    q, k, v = _attn_qkv(gen, dev, 1, 256, 128, d, torch.bfloat16, heads,
                        heads // 2)
    kw = dict(causal=True, window=8, block_q=32, block_k=32)
    got = flash_mha(q, k, v, **kw)
    e, ok = _attn_agree(got, flash_attention_plain(q, k, v, **kw))
    t = dict(S=256, T=128, window=8, blocks=[32, 32], max_abs_err=e,
             within_tolerance=ok,
             ms=time_ms(lambda: flash_mha(q, k, v, **kw), reps=20),
             plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                              reps=5),
             library_ms=None)
    log(f"[time_attn] keyless rows bf16 B 1 H {heads} S 256 T 128 d {d} "
        f"causal window 8: " + json.dumps(t))
    assert ok, "flash_attention disagrees with its plain version"
    keys = ("ms", "plain_ms", "library_ms", "bound_ms",
            "bound_ms_fp32_cuda_cores")
    return {"flash_attention_bf16": {
        f"{k}_bf16" + ("" if S == lengths[0] else f"_{S}"): t[k]
        for S, t in out.items() for k in keys if t[k] is not None}}


def phase_flash_path(dev, S=ATTN_S, cfg=None):
    """One flash_mha call on q, k, v that a full-width qwen3-0.6b attention
    layer projects in bf16 (qk-norm, RoPE, which leaves q and k in fp32 as
    in the reference; the 8 KV heads repeated to 16), with the launch counts
    reset just before and read just after; then that call timed against its
    plain version and scaled_dot_product_attention (which takes one dtype:
    it gets v in fp32, made before the timing, the same values)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models.attention import _project_qkv, attn_init
    from repro_torch.models.layers import draw
    from repro_torch.tree import tree_map
    cfg = cfg or get_config("qwen3-0.6b")
    spec = cfg.blocks[0].attn
    gen = torch.Generator(device=dev).manual_seed(9)
    p = tree_map(lambda s: draw(s, gen, dev)[None],
                 attn_init(cfg.d_model, spec, torch.bfloat16))
    x = torch.randn((1, 1, S, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.arange(S, device=dev)[None]
    q, k, v = _project_qkv(p, spec, x, x, pos, pos)
    rep = spec.n_heads // spec.n_kv_heads
    q = q[0].transpose(1, 2).contiguous()                  # (1, H, S, hd)
    k, v = (t[0].repeat_interleave(rep, 2).transpose(1, 2).contiguous()
            for t in (k, v))
    torch.cuda.synchronize()
    _reset_counts()
    out = flash_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = 1
    plain = attention_ref(q, k, v)
    e, ok = _attn_agree(out, plain)
    # both against causal attention in float64, to tell the kernel's error
    # from the plain version's own fp32 rounding
    s64 = torch.einsum("bhsd,bhtd->bhst", q.double(), k.double()) \
        / math.sqrt(q.shape[-1])
    s64.masked_fill_(torch.ones(S, S, dtype=torch.bool, device=dev).triu(1),
                     float("-inf"))
    o64 = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s64, -1), v.double())
    del s64
    res = {"shape": list(q.shape), "dtypes": [str(t.dtype)[6:] for t in
                                               (q, k, v)], "launches": counts,
           "max_abs_err_vs_plain": e, "within_tolerance": ok,
           "max_abs_err_vs_float64": (out.double() - o64).abs().max().item(),
           "plain_max_abs_err_vs_float64":
               (plain.double() - o64).abs().max().item()}
    del o64, plain
    log("[flash_path] " + json.dumps(res))
    assert counts == want, (counts, want)
    assert ok and bool(torch.isfinite(out.float()).all())
    v32 = v.float()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["timing"] = dict(
        ms=time_ms(lambda: flash_mha(q, k, v, causal=True), reps=10,
                   warmup=1),
        plain_ms=time_ms(lambda: attention_ref(q, k, v), reps=3, warmup=1),
        library_ms=time_ms(lambda: sdpa(q, k, v32, is_causal=True), reps=10,
                           warmup=1),
        **_attn_bound(q, k, v, True))
    # the same values in one dtype, to tell the inputs' dtypes from their
    # values
    for dt in (torch.float32, torch.bfloat16):
        qq, kk, vv = (t.to(dt) for t in (q, k, v))
        res["timing"][f"ms_same_values_{str(dt)[6:]}"] = time_ms(
            lambda: flash_mha(qq, kk, vv, causal=True), reps=10, warmup=1)
    log("[flash_path] the path's call timed: " + json.dumps(res["timing"]))
    return res


def _eval_batch(cfg, dev, b=EVAL_B, seq=EVAL_S):
    from repro_torch.data import ShardedTokenDataset, make_replica_batches
    ds = ShardedTokenDataset(cfg.vocab, seq, n_shards=1, batch_per_shard=b)
    return {"tokens": torch.from_numpy(
        make_replica_batches(ds, 0, 1)["tokens"]).to(dev)}


def _replica_params(cfg, dev):
    """One replica's random params from seed 0, with the replica axis."""
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_map
    return tree_map(lambda w: w[None], lm_init(cfg, seed=0, device=dev))


def eval_run(cfg, dev, *, forwards=EVAL_FORWARDS, b=EVAL_B, seq=EVAL_S):
    """Score ``cfg`` through make_loss_fn with the ssm_scan kernel as its
    scan, under no_grad: the first forward and the steady ones, peak memory
    (None off the card), launches, each forward's loss and ``ce``, and the
    last one's metrics (``moe_aux``, ``moe_dropped_frac``, and ``mtp_ce``
    with an MTP head). Returns the record and the steady forward."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import tree_flatten
    _reset_peak(dev)
    t0 = time.perf_counter()
    params = _replica_params(cfg, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    leaves, _ = tree_flatten(params)
    batch = _eval_batch(cfg, dev, b, seq)
    loss_fn = make_loss_fn(cfg, ssm_scan_impl=ssm_scan)
    base = torch.cuda.memory_allocated() if _on_card(dev) else 0
    _reset_peak(dev)
    times, losses, ces = [], [], []
    with torch.no_grad():
        _sync(dev)
        _reset_counts()
        for _ in range(forwards):
            t0 = time.perf_counter()
            loss, metrics = loss_fn(params, batch)
            losses.append(float(loss[0]))   # reads the loss back: a sync
            times.append((time.perf_counter() - t0) * 1e3)
            ces.append(float(metrics["ce"][0]))
        counts = _counts()
    tokens = batch["tokens"].shape[1] * (batch["tokens"].shape[2] - 1)
    steady = sum(times[1:]) / len(times[1:])
    peak = _peak_gb(dev)
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "mamba_layers": sum(k.kind == "mamba" for k in cfg.blocks),
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "params": sum(w.numel() for w in leaves),
           "param_gb": _tree_bytes(params) / 1e9,
           "tokens_per_forward": tokens, "forwards": forwards,
           "init_s": init_s, "first_forward_ms": times[0],
           "ms_per_forward": steady, "tokens_per_s": tokens / steady * 1e3,
           "peak_mem_gb": peak,
           "peak_extra_gb": None if peak is None else peak - base / 1e9,
           "losses": losses, "ces": ces, "launches": counts,
           "ssm_scan_launches_per_forward": counts["ssm_scan"] / forwards,
           **{k: float(v[0]) for k, v in metrics.items() if k != "loss"}}
    return res, lambda: loss_fn(params, batch)


def phase_mamba_eval(dev, cfg=None, forwards=EVAL_FORWARDS, profile=True,
                     b=EVAL_B, seq=EVAL_S, name="mamba_eval"):
    """falcon-mamba-7b at full width and depth (or ``cfg``) scored on the
    card (``eval_run``): ssm_scan launches one per Mamba layer and forward
    (64 for falcon-mamba), loss within 1 of ln(vocab), one forward
    profiled."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config("falcon-mamba-7b")
    res, forward = eval_run(cfg, dev, forwards=forwards, b=b, seq=seq)
    want = dict(dict.fromkeys(KERNELS, 0),
                ssm_scan=forwards * res["mamba_layers"])
    log(f"[{name}] " + json.dumps(res))
    assert res["launches"] == want, (res["launches"], want)
    losses = res["losses"]
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    if profile:
        res["profile"] = profile_forward(name, forward,
                                         res["ms_per_forward"])
    del forward
    torch.cuda.empty_cache()
    return res


def profile_forward(name, fn, step_ms) -> dict:
    """One forward under torch.profiler (no_grad), device-side events only:
    busy time, the idle share against the unprofiled forward, the scan's
    share, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    # sort: the MoE dispatch's sorts; index: its gathers (dispatch and
    # combine) beside the embedding's
    groups = {g: sum(ms for k, ms, _ in rows if g in k.lower())
              for g in ("ssm_scan_kernel", "gemm", "nvjet", "elementwise",
                        "reduce", "cat", "sort", "index")}
    rec = {"device_busy_ms": busy, "forward_ms_unprofiled": step_ms,
           "idle_share": 1.0 - busy / step_ms, "profiled_wall_ms": wall_ms,
           "scan_share_of_busy": groups["ssm_scan_kernel"] / busy,
           "device_ops": sum(r[2] for r in rows),
           "device_ms_by_kernel_name": groups}
    log(f"[profile {name}] " + json.dumps(rec))
    _log_top(name, rows)
    return rec


def phase_mamba_agree(dev, cfg=None, b=EVAL_B, seq=EVAL_S):
    """falcon-mamba at full width and 2 layers: logits with the kernel equal
    those with the plain loop bit for bit (the ops around the scan are the
    same); a reduced fp32 falcon-mamba's logits on the card against the
    CPU's (plain loop) within rtol = atol = 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ref import ssm_scan_ref
    from repro_torch.models import lm_apply, reduced
    from repro_torch.tree import tree_map
    cfg = cfg or get_config("falcon-mamba-7b")
    short = dataclasses.replace(cfg, blocks=cfg.blocks[:SHORT_LAYERS])
    params = _replica_params(short, dev)
    tok = _eval_batch(short, dev, b, seq)["tokens"][..., :-1]
    with torch.no_grad():
        got, _ = lm_apply(params, short, tok, ssm_scan_impl=ssm_scan)
        want, _ = lm_apply(params, short, tok, ssm_scan_impl=ssm_scan_ref)
    torch.cuda.synchronize()
    eq = torch.equal(got, want)
    log(f"[mamba_agree] {SHORT_LAYERS} layers full width, logits "
        f"{tuple(got.shape)} {str(got.dtype)[6:]}: kernel equals plain={eq} "
        f"max_abs_err={_diff(got, want)}")
    assert eq, "logits through the kernel differ from the plain loop's"
    del params, got, want
    torch.cuda.empty_cache()

    small = dataclasses.replace(reduced(cfg), param_dtype="float32",
                                compute_dtype="float32")
    cpu_params = _replica_params(small, "cpu")
    tok = _eval_batch(small, "cpu", 2, 64)["tokens"][..., :-1]
    with torch.no_grad():
        want, _ = lm_apply(cpu_params, small, tok, ssm_scan_impl=ssm_scan)
        got = lm_apply(tree_map(lambda w: w.to(dev), cpu_params), small,
                       tok.to(dev), ssm_scan_impl=ssm_scan)[0].cpu()
    ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-4))
    log(f"[mamba_agree] reduced fp32 ({small.n_layers} layers, d "
        f"{small.d_model}): card vs cpu within 2e-4={ok} "
        f"max_abs_err={_diff(got, want)}")
    assert ok, "card and CPU logits disagree"


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_flatten
    return sum(w.numel() * w.element_size() for w in tree_flatten(tree)[0])


def _decode_params(params) -> dict:
    """The params a decode step reads: all but the MTP head (``mtp``),
    which only the training loss runs."""
    return {k: v for k, v in params.items() if k != "mtp"}


def _decode_bytes(cfg, params, cache, batch: int) -> int:
    """What one decode step must move: every param it reads
    (``_decode_params``) and every cache slot read once (attention reads
    all L slots whatever the fill), the token's slot of each attention
    layer (an MLA layer's latent and RoPE key) and the whole Mamba state
    written once, the logits written once."""
    from repro_torch.models import segments_of
    written = 0
    for (pattern, R), seg in zip(segments_of(cfg.blocks), cache):
        for spec, c in zip(pattern, seg):
            if spec.kind == "attn":
                k = c["kv"]["k"]
                written += 2 * R * batch * k.shape[3] * k.shape[4] \
                    * k.element_size()
            elif spec.kind == "mla":
                written += R * batch * sum(
                    x.shape[3] * x.element_size() for x in c["kv"].values())
            else:
                written += _tree_bytes(c)
    logits = batch * cfg.vocab * torch.finfo(
        params["embed"].dtype).bits // 8
    return (_tree_bytes(_decode_params(params)) + _tree_bytes(cache)
            + written + logits)


def _on_card(dev) -> bool:
    return torch.device(dev).type == "cuda"


def _sync(dev) -> None:
    if _on_card(dev):
        torch.cuda.synchronize()


def _reset_peak(dev) -> None:
    if _on_card(dev):
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(dev):
    """Peak device memory since the last reset (None off the card)."""
    return torch.cuda.max_memory_allocated() / 1e9 if _on_card(dev) else None


def _marker(dev):
    """``(mark, elapsed_ms)``: CUDA events on the card, the host clock off
    it (the CPU runs only exercise the control flow)."""
    if _on_card(dev):
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return mark, lambda a, b: a.elapsed_time(b)
    return time.perf_counter, lambda a, b: (b - a) * 1e3


def _stub_inputs(cfg, batch: int, seed: int = 1) -> dict:
    """Seeded stub inputs (normal x 0.02, numpy) of the config's frontends:
    a VLM's patch embeddings (batch, n_image_tokens, d) as
    ``image_embeds``, an enc-dec model's frame embeddings (batch, n_frames,
    d) as ``audio_frames``; none for a text-only model."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, stub, n in (("image_embeds", cfg.vision, "n_image_tokens"),
                         ("audio_frames", cfg.encoder, "n_frames")):
        if stub is not None:
            out[key] = rng.standard_normal(
                (batch, getattr(stub, n), cfg.d_model),
                dtype=np.float32) * np.float32(0.02)
    return out


def serve_run(cfg, dev, *, batch=SERVE_B, prompt=SERVE_PROMPT, new=SERVE_NEW,
              max_seq=SERVE_MAX_SEQ, profile=None, combine_check=None):
    """Serving through ``ServingEngine`` (with the config's seeded stub
    inputs: a VLM's image embeddings, prefilled ahead of the prompt; an
    enc-dec model's audio frames, which the prefill's encoder reads): two
    ``generate`` calls, then prefill timed (the first call apart, the
    median of 3 more; an encoder's share timed alone), ``new`` decode steps
    timed (per-step marks, median; tokens/s over the loop's wall time),
    peak memory, the cache, the decode byte bound; last, the prefill's
    last-position logits against ``lm_apply``'s (and an MoE model's aux
    over the prompt). ``profile(fn, step_ms)`` (the card's) profiles one
    decode step; ``combine_check(params, toks)`` runs after the timed
    windows. Returns the record and the generated tokens."""
    from repro_torch.models import (encode_audio, lm_apply, lm_cache_init,
                                    lm_decode, lm_init, lm_prefill)
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import tree_flatten, tree_map
    _reset_peak(dev)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, lm_init(cfg, seed=0, device=dev),
                           max_seq=max_seq, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    params = engine.params
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)
    toks = torch.as_tensor(prompts, dtype=torch.int64).to(dev)
    stubs = _stub_inputs(cfg, batch)
    on_dev = {k: torch.from_numpy(v).to(dev) for k, v in stubs.items()}
    n_img = stubs["image_embeds"].shape[1] if "image_embeds" in stubs else 0
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "batch": batch, "prompt": prompt, "image_tokens": n_img,
           "audio_frames": (stubs["audio_frames"].shape[1]
                            if "audio_frames" in stubs else 0),
           "new_tokens": new, "max_seq": max_seq,
           "param_gb": _tree_bytes(params) / 1e9, "init_s": init_s}
    mark, elapsed = _marker(dev)
    with torch.inference_mode():
        _reset_counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, new, **stubs)
        res["generate_first_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = engine.generate(prompts, new, **stubs)
        res["generate_s"] = time.perf_counter() - t0
        res["launches"] = _counts()
        res["generate_equal"] = bool(np.array_equal(out, again))
        cache = lm_cache_init(cfg, batch, max_seq, device=dev)
        res["cache_gb"] = _tree_bytes(cache) / 1e9
        pre = []
        for _ in range(4):
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = lm_prefill(params, cfg, toks, cache, **on_dev)
            _sync(dev)
            pre.append((time.perf_counter() - t0) * 1e3)
        res["prefill_first_ms"] = pre[0]
        res["prefill_ms"] = statistics.median(pre[1:])
        if "audio_frames" in on_dev:   # the encoder's share of the prefill
            enc = []
            for _ in range(3):
                _sync(dev)
                t0 = time.perf_counter()
                encode_audio(tree_map(lambda w: w[None], params), cfg,
                             on_dev["audio_frames"][None])
                _sync(dev)
                enc.append((time.perf_counter() - t0) * 1e3)
            res["prefill_encoder_ms"] = statistics.median(enc)
            res["prefill_decoder_ms"] = res["prefill_ms"] - statistics.median(
                enc)
        last = logits.float()
        tok = logits.argmax(-1)
        pos = torch.full((), prompt + n_img, dtype=torch.int64, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        marks = [mark()]
        for t in range(new):
            logits, cache = lm_decode(params, cfg, tok, cache, pos + t)
            tok = logits.argmax(-1)
            marks.append(mark())
        _sync(dev)
        wall = time.perf_counter() - t0
        steps = [elapsed(marks[i], marks[i + 1]) for i in range(new)]
        res["decode_ms_per_token"] = statistics.median(steps)
        res["decode_ms_min_max"] = [min(steps), max(steps)]
        res["decode_wall_ms_per_token"] = wall * 1e3 / new
        res["tokens_per_s"] = batch * new / wall
        nbytes = _decode_bytes(cfg, params, cache, batch)
        flops = 2 * batch * sum(
            w.numel() for w in tree_flatten(_decode_params(params))[0])
        res.update(decode_bytes_gb=nbytes / 1e9,
                   **bound(nbytes, flops, flops / BF16_TC_FLOPS_PER_S * 1e3))
        res["share_of_bound"] = res["bound_ms"] / res["decode_ms_per_token"]
        res["peak_mem_gb"] = _peak_gb(dev)
        if profile is not None:
            prof = profile(
                lambda: lm_decode(params, cfg, tok, cache, pos + new),
                res["decode_ms_per_token"])
            res["device_busy_ms"] = prof["device_busy_ms"]
            res["idle_share"] = prof["idle_share"]
        del cache
        if _on_card(dev):
            torch.cuda.empty_cache()
        if combine_check is not None:
            res["combine_check"] = combine_check(params, toks)
        full, aux = lm_apply(tree_map(lambda w: w[None], params), cfg,
                             toks[None], **{k: v[None]
                                            for k, v in on_dev.items()})
        full = full[0, :, -1].float()
        if any(b.moe is not None for b in cfg.blocks):
            res.update({k: float(aux[k][0]) for k in ("moe_aux",
                                                      "moe_dropped_frac")})
        res["lm_apply_max_abs_diff"] = _diff(last, full)
        res["lm_apply_bound"] = 2 * _bf16_ulp(full.abs().max()).item()
        res["prefill_logits_finite"] = bool(torch.isfinite(last).all())
    del engine, params, full
    return res, out


def phase_serve(name, cfg, dev, **sizes):
    """Full-width serving (``serve_run``) on the card: no kernel launched
    (the reference's serving path reaches none), equal tokens from two
    calls, one decode step profiled, and the prefill's last-position logits
    within two bf16 ulps of ``lm_apply``'s largest logit."""
    res, out = serve_run(cfg, dev, profile=functools.partial(
        profile_forward, name), **sizes)
    log(f"[{name}] " + json.dumps(res))
    assert res["launches"] == dict.fromkeys(KERNELS, 0), res["launches"]
    assert res["generate_equal"], "two generate calls gave other tokens"
    assert out.shape == (res["batch"], res["new_tokens"]) \
        and (out >= 0).all() and (out < cfg.vocab).all()
    assert res["prefill_logits_finite"], "non-finite prefill logits"
    assert res["lm_apply_max_abs_diff"] <= res["lm_apply_bound"], \
        (f"prefill vs lm_apply {res['lm_apply_max_abs_diff']} > "
         f"{res['lm_apply_bound']}")
    torch.cuda.empty_cache()
    return res


def _serve_models():
    """The reduced fp32 models of [serve_agree]: qwen3, qwen3 with a 4-slot
    sliding window, falcon-mamba."""
    from repro_torch.configs import get_config, with_sliding_window
    from repro_torch.models import reduced

    def small(arch):
        return dataclasses.replace(reduced(get_config(arch)),
                                   param_dtype="float32",
                                   compute_dtype="float32")
    return {"qwen3": small("qwen3-0.6b"),
            "qwen3-sw4": with_sliding_window(small("qwen3-0.6b"), 4),
            "falcon-mamba": small("falcon-mamba-7b")}


def _serve_trace(cfg, params, toks, dev, prompt, max_seq, stubs=None):
    """Prefill ``toks[:, :prompt]`` (with ``stubs``, the config's stub
    inputs: a VLM's embeddings come first), then decode the rest one at a
    time at device positions: every call's logits and caches, on the
    CPU."""
    from repro_torch.models import lm_cache_init, lm_decode, lm_prefill
    from repro_torch.tree import tree_flatten
    def copy(c):   # a snapshot: later decode steps write the caches in place
        return c.to("cpu", copy=True)

    toks = toks.to(dev)
    stubs = {k: torch.from_numpy(v).to(dev) for k, v in (stubs or {}).items()}
    n_img = stubs["image_embeds"].shape[1] if "image_embeds" in stubs else 0
    logits, cache = lm_prefill(params, cfg, toks[:, :prompt],
                               lm_cache_init(cfg, toks.shape[0], max_seq,
                                             device=dev), **stubs)
    trace = [(copy(logits), [copy(c) for c in tree_flatten(cache)[0]])]
    for t in range(prompt, toks.shape[1]):
        logits, cache = lm_decode(params, cfg, toks[:, t], cache,
                                  torch.full((), t + n_img, device=dev))
        trace.append((copy(logits), [copy(c) for c in tree_flatten(cache)[0]]))
    return trace


def phase_serve_agree(dev, batch=2, prompt=12, steps=4, max_seq=32, new=6):
    """Reduced fp32 qwen3, qwen3 with a 4-slot window (the prompt three
    windows long) and falcon-mamba: prefill and each decode step's logits
    and every cache leaf on the card against the CPU within rtol = atol =
    2e-4; prefill(t[:-1]) + decode(t[-1]) against lm_apply(t)[:, -1] on the
    card within 2e-4; greedy tokens equal on card and CPU, and in two calls
    on the card. No kernel runs."""
    from repro_torch.models import (lm_apply, lm_cache_init, lm_decode,
                                    lm_init, lm_prefill)
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import tree_map
    out = {}
    _reset_counts()
    with torch.inference_mode():
        for name, cfg in _serve_models().items():
            cpu = lm_init(cfg, seed=0, device="cpu")
            card = tree_map(lambda w: w.to(dev), cpu)
            toks = torch.as_tensor(np.random.default_rng(1).integers(
                0, cfg.vocab, (batch, prompt + steps)), dtype=torch.int64)
            err, ok = 0.0, True
            for (lw, cw), (lg, cg) in zip(
                    _serve_trace(cfg, cpu, toks, "cpu", prompt, max_seq),
                    _serve_trace(cfg, card, toks, dev, prompt, max_seq)):
                for w, g in zip([lw] + cw, [lg] + cg):
                    err = max(err, _diff(g, w))
                    ok &= bool(torch.allclose(g, w, rtol=2e-4, atol=2e-4))
            t = toks.to(dev)
            full = lm_apply(tree_map(lambda w: w[None], card), cfg,
                            t[None])[0][0, :, -1]
            _, cache = lm_prefill(card, cfg, t[:, :-1],
                                  lm_cache_init(cfg, batch, max_seq,
                                                device=dev))
            last, _ = lm_decode(card, cfg, t[:, -1], cache,
                                torch.full((), t.shape[1] - 1, device=dev))
            own = _diff(last, full)
            prompts = toks[:, :prompt].numpy().astype(np.int32)
            want = ServingEngine(cfg, cpu, max_seq, device="cpu").generate(
                prompts, new)
            eng = ServingEngine(cfg, card, max_seq, device=dev)
            got, again = eng.generate(prompts, new), eng.generate(prompts, new)
            out[name] = {
                "card_vs_cpu_max_abs_err": err, "card_vs_cpu_within": ok,
                "decode_vs_lm_apply_max_abs_err": own,
                "decode_vs_lm_apply_within": bool(torch.allclose(
                    last, full, rtol=2e-4, atol=2e-4)),
                "tokens_equal_cpu": bool(np.array_equal(got, want)),
                "tokens_equal_two_calls": bool(np.array_equal(got, again))}
    counts = _counts()
    log("[serve_agree] " + json.dumps({"models": out, "launches": counts}))
    assert counts == dict.fromkeys(KERNELS, 0), counts
    bad = {k: [c for c, v in r.items() if v is False] for k, r in out.items()}
    assert not any(bad.values()), bad
    return out


def make_optimizer(name: str, steps: int, lr: float):
    """sgd, adamw or lars on a step_decay over ``steps``, as a user builds
    them through the library API (the launcher builds only sgd)."""
    from repro_torch.optim import adamw, lars, sgd, step_decay
    sched = step_decay(lr, 0.1, max(steps // 3, 1))
    if name == "adamw":
        return adamw(sched, weight_decay=ADAMW_WD)
    if name == "lars":
        return lars(sched, momentum=MOMENTUM, weight_decay=LARS_WD)
    return sgd(sched, momentum=MOMENTUM)


def _train(cfg, *, fused, steps, dev, params=None, dp=DP, seq=SEQ,
           per_replica=PER_REPLICA, protocol="gossip", optimizer="sgd",
           lr=None, packed=True, dist=None, remat=False, **wire):
    """A bundle and its Trainer; ``packed=False`` runs the per-leaf engines
    (``wire`` may then carry ``mix_impl``, or the bundle's
    ``remat_policy`` and ``ssm_scan_impl``); ``dist`` (a distribution plan)
    replaces ``dp`` and picks the shard-local layout when it shards inside
    a replica. ``remat`` is off unless asked for (the bundle's default is
    on): the paths of earlier slices were measured without it. A VLM's or
    an enc-dec model's Trainer feeds the seeded stub inputs
    (``_stub_trainer_cls``)."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    opt = make_optimizer(optimizer, steps,
                         FULL_LR[optimizer] if lr is None else lr)
    size = dict(dist=dist) if dist is not None else dict(dp=dp)
    bundle = make_train_step_bundle(cfg, opt, protocol=protocol,
                                    gossip_packed=packed, fused_update=fused,
                                    device=dev, remat=remat, **size, **wire)
    state = init_train_state(cfg, opt, packed=packed,
                             layout=bundle.layout, seed=0, params=params,
                             device=dev, inbox=bundle.protocol.staleness,
                             wire=bundle.wire, **size)
    ds = ShardedTokenDataset(cfg.vocab, seq, n_shards=bundle.dp,
                             batch_per_shard=per_replica)
    cls = (Trainer if cfg.vision is None and cfg.encoder is None
           else _stub_trainer_cls())
    return bundle, cls(bundle, state, ds, log_every=0)


def _stub_trainer_cls():
    from repro_torch.train import Trainer

    class StubTrainer(Trainer):
        """The Trainer with the config's stub inputs in every batch (a
        VLM's image embeddings, an enc-dec model's audio frames): seeded by
        the step, (dp, b, n, d), normal x 0.02."""

        def _batch(self, step: int):
            batch = super()._batch(step)
            dp, b = batch["tokens"].shape[:2]
            for k, v in _stub_inputs(self.bundle.cfg, dp * b,
                                     seed=step).items():
                batch[k] = torch.from_numpy(v).view(
                    (dp, b) + v.shape[1:]).to(self.bundle.device)
            return batch
    return StubTrainer


def _counters():
    from repro_torch.kernels import (flash_attention, fused_update, gossip_mix,
                                     ssm_scan_kernel)
    return {"gossip_mix": gossip_mix.launches,
            "gossip_mix_q": gossip_mix.q_launches,
            "fused_sgd": fused_update.launches,
            "fused_sgd_q": fused_update.scaled_launches,
            "fused_adamw": fused_update.adamw_launches,
            "fused_adamw_q": fused_update.adamw_scaled_launches,
            "fused_lars": fused_update.lars_launches,
            "ssm_scan": ssm_scan_kernel.launches,
            "flash_attention": flash_attention.launches,
            "ssm_scan_train": ssm_scan_kernel.train_launches,
            "ssm_scan_bwd": ssm_scan_kernel.bwd_launches}


def _reset_counts():
    for c in _counters().values():
        c.reset()


def _counts():
    return {k: c.count for k, c in _counters().items()}


def _leaf_view(params):
    """Every param as a leaf tensor: a tree's leaves, or packed buckets
    through their ``unpack()`` views."""
    from repro_torch.core import PackedParams
    from repro_torch.tree import tree_flatten
    if isinstance(params, PackedParams):
        params = params.unpack()
    return [x.detach() for x in tree_flatten(params)[0]]


def _finite_buckets(trainer) -> bool:
    return all(bool(torch.isfinite(b).all()) for b in
               _leaf_view(trainer.state["params"]))


def _num_leaves(cfg) -> int:
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    return len(tree_flatten(lm_specs(cfg))[0])


def consumed(bundle, steps: int, start: int = 0) -> int:
    """Buckets that meet a partner over ``steps`` steps: the consumed
    subset ``selected(phase - k)`` (k = 0 for sync), every bucket without
    a subset."""
    from repro_torch.core.gossip import wire_subset_of
    proto, nb = bundle.protocol, bundle.layout.num_buckets
    sub = wire_subset_of(proto.wire, nb)
    if sub is None:
        return steps * nb
    return sum(int(sub.selected(s % proto.period - proto.staleness).sum())
               for s in range(start, start + steps))


def run_path(name, cfg, dev, *, fused, steps, expect, profile=False,
             keep_params=False, **proto):
    """Drive one path through Trainer with the launch counts reset just
    before and read just after; ``expect(bundle)`` gives the counts it
    must show. Returns the path's record (its counts under
    ``"launches"``; with ``keep_params`` a copy of the params after the
    counted steps under ``"params"``, on the card, or on the host with
    ``keep_params="cpu"`` so that later paths' peaks do not count it)."""
    bundle, tr = _train(cfg, fused=fused, steps=steps, dev=dev, **proto)
    impl = proto.pop("mix_impl", None)
    if impl is not None:
        proto["mix_impl"] = impl.__name__
    dist = proto.pop("dist", None)
    if dist is not None:
        proto["mesh"] = dict(dist.mesh.shape)
        proto["dist_mode"] = dist.mode
    assert bundle.fused == fused
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tr.run(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hist = tr.run(steps - 1, start_step=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()
    losses = [h["loss"] for h in hist]
    want = expect(bundle)
    lay = bundle.layout
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model, "dp": bundle.dp,
           "seq": SEQ, "per_replica": PER_REPLICA, "fused": fused,
           "optimizer": "sgd", **proto,
           "period": bundle.protocol.period,
           "num_buckets": lay.num_buckets if lay is not None else None,
           "num_shards": lay.num_shards if lay is not None else None,
           "num_leaves": _num_leaves(cfg), "losses": losses,
           "first_step_ms": (t1 - t0) * 1e3,
           "ms_per_step": (t2 - t1) * 1e3 / (steps - 1),
           "tokens_per_s": bundle.dp * PER_REPLICA * SEQ * (steps - 1)
           / (t2 - t1),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "expected_launches": want}
    log(f"[{name}] " + json.dumps(res))
    assert all(math.isfinite(v) for v in losses), "non-finite loss"
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    assert counts == want, (counts, want)
    assert _finite_buckets(tr), "non-finite parameters"
    kept = ([x.cpu() if keep_params == "cpu" else x.clone()
             for x in _leaf_view(tr.state["params"])]
            if keep_params else None)
    if profile:
        res["profile"] = profile_step(name, tr)
    if lay is not None and lay.hierarchical:   # after the timed windows
        res.update(_unpack_cost(tr.state["params"]))
        log(f"[{name}] unpack alone: " + json.dumps(
            {k: res[k] for k in ("strides", "unpack_ms", "unpack_gb",
                                 "unpack_bound_ms")}))
    del tr, bundle
    torch.cuda.empty_cache()
    if kept is not None:
        res["params"] = kept
    return res


def _unpack_cost(params) -> dict:
    """A shard-local layout's ``unpack`` alone (forward, no autograd): the
    per-shard strides, the device ms of one assembly of every leaf and the
    bytes it writes (the extra peak a forward holds until backward)."""
    lay = params.layout
    with torch.no_grad():
        ms = time_ms(lambda: lay.unpack(params.buckets), reps=5, warmup=1)
        nbytes = sum(x.numel() * x.element_size() for x in
                     _leaf_view(params))
    return {"strides": list(lay.strides), "unpack_ms": ms,
            "unpack_gb": nbytes / 1e9,
            "unpack_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3}


def profile_step(name, tr, min_steps: int = 4) -> None:
    """Whole protocol periods, at least 4 steps, timed without the
    profiler, then the same phases again under torch.profiler, after the
    counted window: the async paths' steps differ by phase (the subset
    sends the embedding bucket every other step), so both windows cover
    each phase alike.
    Device busy time is the sum of the kernels (device-side events only:
    an operator's row repeats its kernels' time), per step; the idle share
    is taken against the unprofiled window's step time, since the profiler
    slows the host. Also times the host's synthetic batch for one step.
    Tokens count the trainer's own batch (``dp`` x its sequences x seq)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import make_replica_batches
    period = tr.bundle.protocol.period
    n = period * -(-min_steps // period)   # whole periods
    step = len(tr.history)
    t0 = time.perf_counter()
    make_replica_batches(tr.dataset, step, tr.bundle.dp)
    batch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(n, start_step=step)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(n, start_step=step + n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = _device_rows(prof, n)
    busy_ms = sum(r[1] for r in rows)
    # index: the exchange's index_select and, under lars, the prepass's
    # index_add_ (indexFunc*) and gather; reduce: the prepass's row sums
    groups = {g: sum(ms for k, ms, _ in rows if g in k)
              for g in ("fused_sgd_kernel", "fused_adamw_kernel",
                        "fused_lars_kernel", "gossip_mix_kernel", "index",
                        "indexFunc", "reduce_kernel", "CatArrayBatchedCopy")}
    rec = {"steps": n, "device_busy_ms": busy_ms,
           "step_ms_unprofiled": step_ms,
           "tokens_per_s_unprofiled": _step_tokens(tr) / step_ms * 1e3,
           "idle_share": 1.0 - busy_ms / step_ms,
           "profiled_wall_ms": wall_ms,
           "device_ops_per_step": sum(r[2] for r in rows),
           "host_batch_ms": batch_ms, "device_ms_by_kernel_name": groups}
    log(f"[profile {name}] " + json.dumps(rec))
    _log_top(name, rows)
    return rec


def _step_tokens(tr) -> int:
    ds = tr.dataset
    return tr.bundle.dp * ds.batch_per_shard * ds.seq_len


def _device_rows(prof, per: int = 1):
    """(kernel, device ms, launches) per ``per`` runs, largest first, from
    the device-side events only (an operator's row would repeat its
    kernels' time), summed by name straight from the profiler's raw
    events: ``key_averages()`` first builds a Python record of every event,
    which at a Mamba train step's 475k kernels took minutes. The port's
    spans (``repro_torch.spans``) show on the device's track as ranges,
    not activity, and are left out."""
    from torch.autograd import DeviceType
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms / per, n / per) for k, (ms, n) in rows.items()),
                  key=lambda r: -r[1])


def _log_top(name, rows, k: int = 16) -> None:
    for key, ms, count in rows[:k]:
        log(f"[profile {name}] {ms:9.3f} ms  x{count:<7g} {key[:90]}")


@contextlib.contextmanager
def _bucket_bytes(nbytes: int):
    """Small buckets for the small model, so a subset has buckets to pick
    from (the tests force the same layout in both packages)."""
    import repro_torch.train.step as step_mod
    orig = step_mod.build_layout
    step_mod.build_layout = functools.partial(orig, target_bucket_bytes=nbytes)
    try:
        yield
    finally:
        step_mod.build_layout = orig


def _code_step(ref: np.ndarray, wire: str | None) -> np.ndarray:
    """0.5 (alpha) times one wire code step of each element's tile."""
    if wire is None or wire in ("fp32", "bf16"):
        return np.zeros_like(ref)
    tiles = ref.reshape(ref.shape[:-1] + (-1, 128))
    amax = np.abs(tiles).max(-1, keepdims=True)
    if wire == "int8":
        step = amax / 127.0 + 0 * tiles
    else:
        scale = amax / 448.0
        y = np.abs(tiles) / np.where(scale > 0, scale, 1.0)
        step = scale * 2.0 ** (np.floor(np.log2(np.maximum(y, 2.0 ** -6)))
                               - 3)
    return (0.5 * step).reshape(ref.shape)


def _state_items(state):
    """(name, value) of every tensor and host value of a train state in a
    fixed order, a ``PackedParams`` by its buckets."""
    from repro_torch.core import PackedParams

    def walk(node, path):
        if isinstance(node, PackedParams):
            for i, b in enumerate(node.buckets):
                yield f"{path}[{i}]", b
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{path}[{i}]")
        elif node is not None:
            yield path, node
    return list(walk(state, ""))


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(_INT_OF_SIZE[a.element_size()]),
            b.view(_INT_OF_SIZE[b.element_size()])))
    return bool(np.array_equal(a, b))


def _states_equal(got, want) -> bool:
    g, w = _state_items(got), _state_items(want)
    assert [k for k, _ in g] == [k for k, _ in w], "state structures differ"
    return all(_same_bits(x, y) for (_, x), (_, y) in zip(g, w))


def _states_diff(got, want) -> float:
    """Largest elementwise difference over the state's tensors."""
    return max((_diff(x, y) for (_, x), (_, y) in
                zip(_state_items(got), _state_items(want))
                if isinstance(x, torch.Tensor)), default=0.0)


def phase_averaging(name, cfg, dev, protocol):
    """The paper's baselines at full width, fused: ``agd`` averages the
    gradients before every sweep (alpha 0), ``every_logp`` averages the
    params after every ``substeps``-th sweep. Counted like [main], with the
    replicas' bit identity checked after every step of the counted window
    (agd: always; every_logp: exactly after the averaging steps), then
    timed and profiled like [main]; the replica mean is timed alone on a
    copy of the params."""
    from repro_torch.core import PackedParams
    from repro_torch.core.protocols import _replica_mean
    bundle, tr = _train(cfg, fused=True, steps=MAIN_STEPS, dev=dev,
                        protocol=protocol)
    sub = bundle.protocol.schedule.substeps if protocol == "every_logp" else 1
    buckets = lambda: tr.state["params"].buckets  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    same = []
    t0 = time.perf_counter()
    for s in range(MAIN_STEPS):
        tr.run(1, start_step=s)
        same.append(all(torch.equal(b, b[:1].expand_as(b))
                        for b in buckets()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts()
    want = dict(dict.fromkeys(KERNELS, 0),
                fused_sgd=MAIN_STEPS * bundle.layout.num_buckets)
    expect = [(s + 1) % sub == 0 for s in range(MAIN_STEPS)]
    copy = PackedParams([b.detach().clone() for b in buckets()],
                        bundle.layout)
    mean_ms = time_ms(lambda: _replica_mean(copy), reps=5)
    nbytes = sum(b.numel() * b.element_size() * 2 for b in copy.buckets)
    del copy
    losses = [h["loss"] for h in tr.history]
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model, "dp": DP,
           "seq": SEQ, "per_replica": PER_REPLICA, "protocol": protocol,
           "period": bundle.protocol.period, "substeps": sub,
           "num_buckets": bundle.layout.num_buckets, "losses": losses,
           "ms_per_step_checked": (t1 - t0) * 1e3 / MAIN_STEPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "expected_launches": want,
           "replicas_identical_after_step": same,
           "replica_mean_ms": mean_ms,
           "replica_mean_ms_per_step": mean_ms / sub,
           "replica_mean_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"[{name}] " + json.dumps(res))
    assert all(math.isfinite(v) for v in losses), "non-finite loss"
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    assert counts == want, (counts, want)
    assert same == expect, (same, expect)
    assert _finite_buckets(tr), "non-finite parameters"
    res["profile"] = profile_step(name, tr)
    del tr, bundle
    torch.cuda.empty_cache()
    return res


def phase_ckpt(name, cfg, dev, pad_to=None, **proto):
    """Save after 4 steps, restore into a fresh state drawn with another
    seed (every tensor, ``step`` and ``t`` bit-equal to what was saved),
    run 4 more and hold the result against a straight 8-step run: bit for
    bit when two straight runs are bit-equal on the card, else within
    their own difference. ``pad_to`` also restores the file into a ring
    of that depth: the saved slots bit-equal, the new ones invalid."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.train import Trainer, init_train_state
    half, steps = SHORT_STEPS, 2 * SHORT_STEPS

    def run(n):
        bundle, tr = _train(cfg, fused=True, steps=steps, dev=dev, **proto)
        tr.run(n)
        return bundle, tr

    def fresh(bundle, seed, inbox=None):
        return init_train_state(
            cfg, bundle.optimizer, dp=DP, packed=True, layout=bundle.layout,
            seed=seed, device=dev, wire=bundle.wire,
            inbox=bundle.protocol.staleness if inbox is None else inbox)

    _, a = run(steps)
    _, b = run(steps)
    deterministic = _states_equal(b.state, a.state)
    spread = _states_diff(b.state, a.state)
    del b
    bundle, tr = run(half)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(d, tr.state, step=half, metadata={
            "protocol": proto.get("protocol", "gossip")})
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "arrays.npz"))
        template = fresh(bundle, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest, man = restore_state(d, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
        assert man["step"] == half
        assert _states_equal(rest, tr.state), "restored state differs"
        assert all(b.requires_grad and b.is_leaf
                   and b.device.type == dev.type
                   for b in rest["params"].buckets)
        padded = None
        if pad_to:
            deep, _ = restore_state(d, fresh(bundle, seed=2, inbox=pad_to))
            old, new = tr.state["inbox"], deep["inbox"]
            k = len(old["slots"])
            assert len(new["slots"]) == pad_to and new["t"] == old["t"]
            assert _states_equal(new["slots"][:k], old["slots"])
            assert (new["valid"][:, :k] == old["valid"]).all()
            assert not new["valid"][:, k:].any()
            padded = {"from": k, "to": pad_to, "t": new["t"]}
            del deep
    finally:
        shutil.rmtree(d, ignore_errors=True)
    resumed = Trainer(bundle, rest, tr.dataset, log_every=0)
    resumed.run(half, start_step=half)
    losses = [h["loss"] for h in tr.history + resumed.history]
    straight = [h["loss"] for h in a.history]
    if deterministic:
        held = "bit-equal"
        assert losses == straight, (losses, straight)
        assert _states_equal(resumed.state, a.state), "resume differs"
        resume_diff = 0.0
    else:
        held = "within the straight runs' own difference"
        resume_diff = _states_diff(resumed.state, a.state)
        assert resume_diff <= spread, (resume_diff, spread)
    res = {"layers": cfg.n_layers, "dp": DP, "steps": f"{half}+{half}",
           **proto, "straight_runs_bit_equal": deterministic,
           "straight_runs_max_diff": spread, "resume_held": held,
           "resume_max_diff": resume_diff, "losses": losses,
           "bytes_on_disk": nbytes, "save_s": save_s,
           "restore_s": restore_s, "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "mask_pad": padded}
    log(f"[{name}] " + json.dumps(res))
    del a, tr, rest, resumed, bundle
    torch.cuda.empty_cache()
    return res


def phase_agree(dev):
    """Small fp32 runs on the card (kernels) and on the CPU (plain
    versions) from one init agree: sgd, adamw and lars."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init, reduced
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                              param_dtype="float32", compute_dtype="float32")
    init = lm_init(cfg, seed=0, device="cpu")
    steps = 4
    cases = [("sync fused", True, {}),
             ("async int8 sub0.5 fused", True, ASYNC_WIRE),
             ("async int8 sub0.5 unfused", False, ASYNC_WIRE),
             ("sync bf16-wire unfused", False, dict(wire_dtype="bf16"))]
    cases += [(f"{o} {name}", fused, dict(proto, optimizer=o))
              for o in ("adamw", "lars")
              for name, fused, proto in (("sync fused", True, {}),
                                         ("async int8 sub0.5 fused", True,
                                          ASYNC_WIRE),
                                         ("sync unfused", False, {}))]
    for name, fused, proto in cases:
        opt = proto.get("optimizer", "sgd")
        out = {}
        with _bucket_bytes(AGREE_BUCKET_BYTES):
            for d in ("cpu", dev):
                params = tree_map(lambda t, d=d: t.to(d), init)
                bundle, tr = _train(cfg, fused=fused, steps=steps, dev=d,
                                    params=params, seq=16, per_replica=2,
                                    lr=AGREE_LR[opt], **proto)
                assert bundle.layout.num_buckets == 5
                losses = [h["loss"] for h in tr.run(steps)]
                out[str(d)] = (losses, [b.detach().cpu().numpy() for b in
                                        tr.state["params"].buckets])
        (lc, bc), (lg, bg) = out["cpu"], out[str(dev)]
        rec = _assert_agree(name, opt, proto, steps, (lc, bc), (lg, bg))
        log(f"[agree] {name}: card vs cpu losses " + json.dumps(rec))


def _assert_agree(name, opt, proto, steps, cpu, card) -> dict:
    """[agree]'s rule between a CPU and a card run (losses, buckets as
    numpy): within rtol = atol = 2e-4, but for at most 0.1% of elements one
    wire code step (AdamW: 2 * lr * steps) apart."""
    (lc, bc), (lg, bg) = cpu, card
    np.testing.assert_allclose(lg, lc, rtol=2e-4, atol=2e-4)
    # AdamW's first steps move an element by about lr times the sign
    # of its gradient, which a rounding-level gradient may flip
    sign_flip = 2 * AGREE_LR[opt] * steps if opt == "adamw" else 0.0
    flips = total = 0
    for a, b in zip(bg, bc):
        bad = ~np.isclose(a, b, rtol=2e-4, atol=2e-4)
        step = _code_step(b, proto.get("wire_dtype"))
        assert (np.abs(a - b)[bad] <= step[bad] * 1.001 + sign_flip
                + 2e-4).all(), name
        flips += int(bad.sum())
        total += a.size
    assert flips <= 1e-3 * total, (name, flips, total)
    return {"cuda": lg, "cpu": lc, "code_step_or_sign_elements": flips,
            "elements": total}


def _small_cfg():
    """[agree]'s reduced fp32 qwen3-0.6b (2 layers, d 64)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                               param_dtype="float32", compute_dtype="float32")


def phase_leaf_kernel_gap(main_res, kernel_res):
    """[leaf_kernel] against [leaf_main] after the same 8 steps: the
    kernel mixes in fp32 and rounds once, the default mix rounds each bf16
    op, so the two part where a product rounds; at alpha 0.5 both products
    are exact and the runs are deterministic (``[ckpt]``'s straight runs),
    so every element must be equal."""
    diff, differ, total = 0.0, 0, 0
    for a, b in zip(kernel_res.pop("params"), main_res.pop("params")):
        d = (a.float() - b.float()).abs()
        diff = max(diff, float(d.max()))
        differ += int((d > 0).sum())
        total += d.numel()
    rec = {"max_abs_diff_params": diff, "elements_differing": differ,
           "elements": total, "losses_kernel": kernel_res["losses"],
           "losses_default": main_res["losses"]}
    log("[leaf_kernel] against [leaf_main]: " + json.dumps(rec))
    assert differ == 0 and kernel_res["losses"] == main_res["losses"], rec
    torch.cuda.empty_cache()
    return rec


def phase_leaf_mix_check(cfg, dev, dp=DP):
    """``gossip_mix_1d`` on every leaf of the per-leaf path at full width
    (the leaves of ``lm_specs(cfg)``, layers stacked, in the params' dtype,
    ``dp`` replicas, schedule row 1) against its plain version and against
    the default per-leaf mix on the same inputs, one leaf at a time: bit
    for bit (alpha 0.5: both products exact, one rounding of the sum).
    These launches are made outside the counted runs."""
    from repro_torch.core import build_schedule, make_gossip_mix
    from repro_torch.kernels import gossip_mix_1d, gossip_mix_plain
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    sched = build_schedule(dp)
    default = make_gossip_mix(sched)
    kernel = make_gossip_mix(sched, mix_impl=gossip_mix_1d)
    rf = torch.as_tensor(np.asarray(sched.recv_from(1), np.int64),
                         device=dev)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    err, shapes = 0.0, []
    for spec in tree_flatten(lm_specs(cfg))[0]:
        x = torch.randn((dp,) + tuple(spec.shape), generator=gen,
                        device=dev).to(dtype)
        flat = x.view(dp, -1)
        want = gossip_mix_plain(flat, flat.index_select(0, rf), 0.5)
        got = kernel({"w": x.clone()}, 1)["w"].view(dp, -1)
        ref = default({"w": x.clone()}, 1)["w"].view(dp, -1)
        err = max(err, float((got.float() - want.float()).abs().max()))
        assert _same_bits(got, want), (spec.shape, "vs plain")
        assert _same_bits(got, ref), (spec.shape, "vs default mix")
        shapes.append(list(spec.shape))
        del x, flat, want, got, ref
    torch.cuda.empty_cache()
    rec = {"leaves": len(shapes), "dp": dp, "dtype": cfg.param_dtype,
           "max_abs_err": err, "bit_equal": True, "shapes": shapes}
    log("[leaf_mix_check] gossip_mix_1d vs plain and default mix: "
        + json.dumps(rec))
    return rec


def phase_leaf_agree(dev, steps=SHORT_STEPS):
    """Per-leaf with the mix kernel under every leaf against packed
    ``fused_update=False`` on the card, from one init at [agree]'s size:
    the same arithmetic (fp32 mixes, the tree-level sgd), so predicted bit
    for bit; the gap and the share of differing elements are reported."""
    from repro_torch.kernels import gossip_mix_1d
    from repro_torch.models import lm_init
    cfg = _small_cfg()
    init = lm_init(cfg, seed=0, device=dev)
    runs = {}
    for name, kw in (("leaf_kernel", dict(packed=False,
                                          mix_impl=gossip_mix_1d)),
                     ("packed_unfused", dict(packed=True))):
        _, tr = _train(cfg, fused=False, steps=steps, dev=dev, params=init,
                       seq=16, per_replica=2, lr=AGREE_LR["sgd"], **kw)
        losses = [h["loss"] for h in tr.run(steps)]
        runs[name] = (losses, _leaf_view(tr.state["params"]))
    (la, pa), (lb, pb) = runs["leaf_kernel"], runs["packed_unfused"]
    same = la == lb and all(_same_bits(a, b) for a, b in zip(pa, pb))
    gap = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    rec = {"steps": steps, "bit_equal": same, "max_abs_diff_params": gap,
           "losses_leaf": la, "losses_packed": lb}
    log("[leaf_agree] per-leaf (gossip_mix_1d) vs packed unfused: "
        + json.dumps(rec))
    assert same, rec
    return rec


def _sim_run(cfg, dev, steps, protocol, init, dp=DP, **async_kw):
    """The port's simulator (core.simulate) on the card from ``init``, fed
    the Trainer's batches: losses per step and the final params."""
    from repro_torch.core import build_schedule
    from repro_torch.core import simulate as S
    from repro_torch.core.async_gossip import init_inbox_ring
    from repro_torch.data import ShardedTokenDataset, make_replica_batches
    from repro_torch.train import make_loss_fn
    opt = make_optimizer("sgd", steps, AGREE_LR["sgd"])
    sched = build_schedule(dp)
    params = S.replicate(init, dp)
    st = opt.init(params)
    ds = ShardedTokenDataset(cfg.vocab, 16, n_shards=dp, batch_per_shard=2)
    if async_kw:
        step = S.make_async_sim_train_step(make_loss_fn(cfg), opt, sched,
                                           **async_kw)
        ring = init_inbox_ring(params, async_kw["staleness"], dp)
    else:
        step = S.make_sim_train_step(make_loss_fn(cfg), opt, sched,
                                     protocol=protocol)
    losses = []
    for t in range(steps):
        toks = make_replica_batches(ds, t, dp)["tokens"]
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if async_kw:
            st, params, ring, m = step(st, params, ring, batch, t)
        else:
            st, params, m = step(st, params, batch, t)
        losses.append(float(m["loss"]))
    return losses, _leaf_view(params)


def _engine_run(cfg, dev, steps, init, **kw):
    _, tr = _train(cfg, fused=False, steps=steps, dev=dev, params=init,
                   seq=16, per_replica=2, lr=AGREE_LR["sgd"], **kw)
    losses = [h["loss"] for h in tr.run(steps)]
    return losses, _leaf_view(tr.state["params"])


def _wire_oracle_case(dev, k=2, drop=0.2, phases=6, layout=None, dp=DP):
    """The packed unfused async engine on the int8 wire at subset 0.5
    against ``gossip_mix_sim_quantized_k`` on the card, step for step from
    one state: params, the newest slot's codes and scales, ``valid``
    (``layout``: [agree]'s flat one by default)."""
    from repro_torch.core import (PackedParams, build_layout, build_schedule,
                                  make_packed_async_gossip_mix)
    from repro_torch.core import simulate as S
    from repro_torch.core.async_gossip import (exchange_ok,
                                               init_wire_inbox_ring)
    from repro_torch.kernels.quantize import WireFormat
    from repro_torch.models import lm_init
    if layout is None:
        init = lm_init(_small_cfg(), seed=0, device=dev)
        layout = build_layout(init, target_bucket_bytes=AGREE_BUCKET_BYTES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    buckets = [torch.randn((dp, n), generator=gen, device=dev)
               for n in layout.bucket_sizes]
    wire = WireFormat("int8", 0.5, seed=3)
    sched = build_schedule(dp)
    mix = make_packed_async_gossip_mix(sched, layout, staleness=k,
                                       drop_rate=drop, drop_seed=1,
                                       wire=wire)
    params = PackedParams([b.clone() for b in buckets], layout)
    ring = init_wire_inbox_ring(params, k, dp, wire)
    want, wring = [b.clone() for b in buckets], dict(ring)
    same = True
    for t in range(phases):
        ok = exchange_ok(wring["t"], np.arange(dp), 1, drop)
        want, wring = S.gossip_mix_sim_quantized_k(
            want, wring, sched.recv_from(t), wire=wire, ok=ok)
        params, ring = mix(params, ring, t)
        same &= all(_same_bits(a, b) for a, b in zip(params.buckets, want))
        for g, w in zip(ring["slots"][-1], wring["slots"][-1]):
            g = [g["q"], g["s"]] if isinstance(g, dict) else [g]
            w = [w["q"], w["s"]] if isinstance(w, dict) else [w]
            same &= all(torch.equal(a, b) for a, b in zip(g, w))
        same &= bool(np.array_equal(ring["valid"], wring["valid"]))
    return same


def phase_sim_agree(dev, steps=SHORT_STEPS):
    """The port's own oracle on the card: ``make_sim_train_step`` against
    the engines' Trainer runs (per-leaf and packed unfused gossip, agd,
    every_logp, none) and ``make_async_sim_train_step`` (k 2, drop 0.2,
    fp32 wire) against the per-leaf and packed unfused async engines, from
    one init at [agree]'s size; bit for bit, as the CPU tests find them.
    The int8 wire at subset 0.5: the packed async engine against
    ``gossip_mix_sim_quantized_k`` step by step, bit for bit; the async
    simulator's leaf-as-bucket wire (the reference's science twin, which
    no engine computes) on the card against the CPU within rtol = atol =
    2e-4."""
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_map
    cfg = _small_cfg()
    init = lm_init(cfg, seed=0, device=dev)
    async_kw = dict(staleness=2, drop_rate=0.2)
    cases = [("gossip per-leaf", "gossip", dict(packed=False), {}),
             ("gossip packed unfused", "gossip", dict(packed=True), {}),
             ("agd per-leaf", "agd", dict(packed=False, protocol="agd"), {}),
             ("every_logp per-leaf", "every_logp",
              dict(packed=False, protocol="every_logp"), {}),
             ("none per-leaf", "none", dict(packed=False, protocol="none"),
              {}),
             ("gossip_async per-leaf", None,
              dict(packed=False, protocol="gossip_async", **async_kw),
              async_kw),
             ("gossip_async packed unfused", None,
              dict(packed=True, protocol="gossip_async", **async_kw),
              async_kw)]
    out = {}
    for name, proto, kw, akw in cases:
        ls, ps = _sim_run(cfg, dev, steps, proto, init, **akw)
        le, pe = _engine_run(cfg, dev, steps, init, **kw)
        same = ls == le and all(_same_bits(a, b) for a, b in zip(pe, ps))
        gap = max(float((a - b).abs().max()) for a, b in zip(pe, ps))
        out[name] = {"bit_equal": same, "max_abs_diff_params": gap}
    out["int8 sub0.5 packed async vs gossip_mix_sim_quantized_k"] = {
        "bit_equal": _wire_oracle_case(dev)}
    wire_kw = dict(async_kw, wire_dtype="int8", gossip_subset=0.5)
    cpu_init = tree_map(lambda x: x.cpu(), init)
    lg, pg = _sim_run(cfg, dev, steps, None, init, **wire_kw)
    lc, pc = _sim_run(cfg, torch.device("cpu"), steps, None, cpu_init,
                      **wire_kw)
    close = bool(np.allclose(lg, lc, rtol=2e-4, atol=2e-4)) and all(
        np.allclose(a.cpu().numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
        for a, b in zip(pg, pc))
    out["async sim int8 sub0.5: card vs cpu"] = {"within_2e-4": close}
    log("[sim_agree] " + json.dumps(out))
    bad = [k for k, v in out.items() if not (v.get("bit_equal")
                                              or v.get("within_2e-4"))]
    assert not bad, bad
    return out


def _plan(pod: int, data: int, model: int, mode: str):
    """The distribution plan of the smoke mesh (pod, data, model)."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.train import make_distribution
    return make_distribution(make_smoke_mesh(data, model, pod=pod), mode)


def phase_hier_gap(main_res, hier_res):
    """[hier_main] against [main] after the same 8 steps: the shard-local
    layout moves bytes, not arithmetic, so every param element and loss
    must be equal."""
    differ = total = 0
    for a, b in zip(hier_res.pop("params"), main_res.pop("params")):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        ints = _INT_OF_SIZE[a.element_size()]
        differ += int((a.view(ints) != b.view(ints)).sum())
        total += a.numel()
    rec = {"elements_differing": differ, "elements": total,
           "losses_equal": hier_res["losses"] == main_res["losses"],
           "num_shards": hier_res["num_shards"],
           "num_buckets": hier_res["num_buckets"],
           "main_num_buckets": main_res["num_buckets"]}
    log("[hier_main] against [main]: " + json.dumps(rec))
    assert differ == 0 and rec["losses_equal"], rec
    torch.cuda.empty_cache()
    return rec


def phase_hier_agree(dev, steps=SHORT_STEPS):
    """[agree]'s reduced fp32 model on the fsdp (2, 2, 2) shard-local layout
    (dp 2 over the pods, 4 shards): each case on the card against the same
    on the CPU under [agree]'s rule, and, on the fp32 wire, against the
    flat layout over dp 2 on the card bit for bit; the port's simulator
    against the shard-local packed unfused engines (sync and async k 2,
    drop 0.2) on the card, and the int8 ring at subset 0.5 against
    ``gossip_mix_sim_quantized_k`` on the shard-local buckets, bit for
    bit."""
    from repro_torch.models import lm_init
    from repro_torch.train.step import _build_packed_layout
    from repro_torch.tree import tree_map
    cfg = _small_cfg()
    fsdp = _plan(2, 2, 2, "fsdp")
    init = lm_init(cfg, seed=0, device="cpu")
    cases = [("sync fused", True, {}), ("sync unfused", False, {}),
             ("async int8 sub0.5 fused", True, ASYNC_WIRE),
             ("async int8 sub0.5 unfused", False, ASYNC_WIRE),
             ("adamw sync fused", True, dict(optimizer="adamw"))]
    out = {}
    with _bucket_bytes(AGREE_BUCKET_BYTES):
        for name, fused, proto in cases:
            opt = proto.get("optimizer", "sgd")
            runs = {}
            for tag, d, dist in (("card", dev, fsdp), ("cpu", "cpu", fsdp),
                                 ("card_flat", dev, None)):
                if tag == "card_flat" and "wire_dtype" in proto:
                    continue   # the wire's tiles follow the layout
                params = tree_map(lambda t, d=d: t.to(d), init)
                bundle, tr = _train(cfg, fused=fused, steps=steps, dev=d,
                                    params=params, seq=16, per_replica=2,
                                    lr=AGREE_LR[opt], dist=dist, dp=fsdp.dp,
                                    **proto)
                assert bundle.fused == fused and bundle.dp == fsdp.dp
                assert bundle.layout.num_shards == (4 if dist else 1)
                losses = [h["loss"] for h in tr.run(steps)]
                params = tr.state["params"]
                runs[tag] = (losses, _leaf_view(params),
                             [b.detach().cpu().numpy()
                              for b in params.buckets])
            rec = _assert_agree(name, opt, proto, steps,
                                (runs["cpu"][0], runs["cpu"][2]),
                                (runs["card"][0], runs["card"][2]))
            rec["num_buckets"] = len(runs["card"][2])
            if "card_flat" in runs:
                (lh, ph, _), (lf, pf, _) = runs["card"], runs["card_flat"]
                rec["bit_equal_to_flat"] = lh == lf and all(
                    _same_bits(a, b) for a, b in zip(ph, pf))
            out[name] = rec
        layout = _build_packed_layout(fsdp, cfg)
    init = tree_map(lambda t: t.to(dev), init)
    async_kw = dict(staleness=2, drop_rate=0.2)
    for name, proto, kw, akw in (
            ("sim gossip vs packed unfused", "gossip", {}, {}),
            ("async sim vs packed unfused", None,
             dict(protocol="gossip_async", **async_kw), async_kw)):
        ls, ps = _sim_run(cfg, dev, steps, proto, init, dp=fsdp.dp, **akw)
        le, pe = _engine_run(cfg, dev, steps, init, dist=fsdp, **kw)
        out[name] = {"bit_equal": ls == le and all(
            _same_bits(a, b) for a, b in zip(pe, ps))}
    out["int8 sub0.5 ring vs gossip_mix_sim_quantized_k"] = {
        "bit_equal": _wire_oracle_case(dev, layout=layout, dp=fsdp.dp),
        "num_buckets": layout.num_buckets}
    log("[hier_agree] " + json.dumps(out))
    bad = [k for k, v in out.items()
           if v.get("bit_equal") is False or v.get("bit_equal_to_flat")
           is False]
    assert not bad, bad
    return out


# ------------------------------------------- long sequences, dense members
MAMBA_TRAIN = dict(batch=1, seq=4096, steps=3, chunk=256)   # train_4k's length
MAMBA_REMAT = dict(batch=1, seq=4096, steps=2, chunk=256)
LLAVA_SERVE = dict(batch=4, prompt=1536, new=32, max_seq=8192)
INTERNLM2_SERVE = dict(batch=2, prompt=512, new=32, max_seq=32768)
BIG_CHUNK = 1 << 28   # elements of one piece of the plain sweep


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)``, uninitialized memory
    left unfilled (filling it changes no value, only the time)."""
    import torch.utils.deterministic as det
    was, fill = (torch.are_deterministic_algorithms_enabled(),
                 det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        det.fill_uninitialized_memory = fill


def train_run(cfg, dev, *, steps, dp, seq, per_replica, **kw):
    """One packed, fused sgd run through Trainer (``_train``; ``kw`` may set
    remat, remat_policy, ssm_scan_impl, lr, params): the launch counts reset
    just before the steps and read just after, the first step apart, then
    ms/step and tokens/s, peak memory (None off the card), losses. Returns
    the record, the bundle and the trainer."""
    bundle, tr = _train(cfg, fused=True, steps=steps, dev=dev, dp=dp,
                        seq=seq, per_replica=per_replica, **kw)
    _sync(dev)
    _reset_peak(dev)
    _reset_counts()
    t0 = time.perf_counter()
    tr.run(1)
    _sync(dev)
    t1 = time.perf_counter()
    hist = tr.run(steps - 1, start_step=1)
    _sync(dev)
    t2 = time.perf_counter()
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dp": dp, "seq": seq, "per_replica": per_replica, "steps": steps,
           "remat": kw.get("remat", False),
           "remat_policy": kw.get("remat_policy"),
           "num_buckets": bundle.layout.num_buckets,
           "losses": [h["loss"] for h in hist],
           "ces": [h["ce"] for h in hist],
           **({"mtp_ces": [h["mtp_ce"] for h in hist]}
              if "mtp_ce" in hist[0] else {}),
           "first_step_ms": (t1 - t0) * 1e3,
           "ms_per_step": (t2 - t1) * 1e3 / (steps - 1),
           "tokens_per_s": dp * per_replica * seq * (steps - 1) / (t2 - t1),
           "peak_mem_gb": _peak_gb(dev), "launches": _counts()}
    return rec, bundle, tr


def _chunked(chunk: int):
    from repro_torch.models.mamba import ssm_scan_chunked_torch
    return functools.partial(ssm_scan_chunked_torch, chunk=chunk)


def _train_scan_launches(cfg, steps: int) -> dict:
    """The chunked scan's kernels over ``steps`` steps under remat on the
    card (``kernels.ssm_scan_train``): two forwards a Mamba layer (the
    forward and remat's recompute) and one backward."""
    m = sum(k.kind == "mamba" for k in cfg.blocks)
    return {"ssm_scan_train": 2 * m * steps, "ssm_scan_bwd": m * steps}


def mamba_train_run(cfg, dev, *, batch, seq, steps, chunk):
    """falcon-mamba training at dp = 1 as the reference's dry run trains it:
    remat on, the chunked scan (``ssm_scan_chunked_torch``) under autograd,
    packed fused sgd (alpha 0)."""
    rec, bundle, tr = train_run(cfg, dev, steps=steps, dp=1, seq=seq,
                                per_replica=batch, remat=True,
                                ssm_scan_impl=_chunked(chunk))
    rec["scan"] = f"chunked {chunk}"
    rec["bucket_sizes_max"] = max(bundle.layout.bucket_sizes)
    return rec, bundle, tr


def sweep_check(dev, n: int, *, lr: float, alpha: float = 0.0,
                momentum: float = MOMENTUM, chunk: int = BIG_CHUNK) -> dict:
    """``fused_sgd_1d`` on flat bf16 buffers of ``n`` elements and of
    ``n - 3`` (the ragged tail past the last vector), with a bf16 partner
    at ``alpha`` (none at alpha 0, as at dp = 1), against
    ``fused_sgd_plain`` on the same inputs, ``chunk`` elements at a time
    (the sweep is elementwise, so the pieces are the whole's values), bit
    for bit."""
    from repro_torch.kernels import fused_sgd_1d, fused_sgd_plain
    gen = torch.Generator(device=dev).manual_seed(3)
    bufs = [torch.empty(n, dtype=torch.bfloat16, device=dev)
            for _ in range(4 if alpha else 3)]
    for x, sd in zip(bufs, (1.0, 0.01, 0.01, 1.0)):
        for i in range(0, n, chunk):
            x[i:i + chunk].normal_(0.0, sd, generator=gen)
    p, g, m = bufs[:3]
    b = bufs[3] if alpha else None
    gp, gm = p.clone(), m.clone()
    out = {"n": n, "alpha": alpha, "partner": b is not None,
           "over_int32": n > 2 ** 31 - 1}
    for tag, k in (("whole", n), ("tail", n - 3)):
        gp.copy_(p)
        gm.copy_(m)
        fused_sgd_1d(gp[:k], g[:k], None if b is None else b[:k], gm[:k],
                     lr=lr, alpha=alpha, momentum=momentum)
        _sync(dev)
        eq, err = True, 0.0
        for i in range(0, k, chunk):
            j = min(i + chunk, k)
            wp, wm = fused_sgd_plain(p[i:j], g[i:j],
                                     None if b is None else b[i:j], m[i:j],
                                     lr=lr, alpha=alpha, momentum=momentum)
            eq &= torch.equal(gp[i:j], wp) and torch.equal(gm[i:j], wm)
            err = max(err, _diff(gp[i:j], wp), _diff(gm[i:j], wm))
        eq &= torch.equal(gp[k:], p[k:]) and torch.equal(gm[k:], m[k:])
        out[tag] = {"elements": k, "equal": bool(eq), "max_abs_err": err}
    return out


def phase_mamba_train(dev, cfg=None, sizes=MAMBA_TRAIN):
    """falcon-mamba-7b training at full width and depth on the card
    (``mamba_train_run``): ``fused_sgd`` launches = steps x buckets, the
    chunked scan's kernels 2 forwards and 1 backward a layer a step, finite
    losses, the first within 1 of ln(vocab), one step profiled; then the
    sweep on the largest bucket's size (past int32 range) against its plain
    version (``sweep_check``)."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config("falcon-mamba-7b")
    rec, bundle, tr = mamba_train_run(cfg, dev, **sizes)
    want = dict(dict.fromkeys(KERNELS, 0),
                fused_sgd=sizes["steps"] * bundle.layout.num_buckets,
                **_train_scan_launches(cfg, sizes["steps"]))
    rec["expected_launches"] = want
    log("[mamba_train] " + json.dumps(rec))
    assert rec["launches"] == want, (rec["launches"], want)
    assert all(math.isfinite(v) for v in rec["losses"]), "non-finite loss"
    assert abs(rec["losses"][0] - math.log(cfg.vocab)) <= 1.0, rec["losses"]
    assert _finite_buckets(tr), "non-finite parameters"
    rec["profile"] = profile_step("mamba_train", tr, min_steps=1)
    n = rec["bucket_sizes_max"]
    del tr, bundle
    torch.cuda.empty_cache()
    big = sweep_check(dev, n, lr=FULL_LR["sgd"])
    log("[mamba_train] fused_sgd on the largest bucket's size: "
        + json.dumps(big))
    assert big["over_int32"] and big["whole"]["equal"] \
        and big["tail"]["equal"], big
    rec["big_bucket"] = big
    torch.cuda.empty_cache()
    return rec


def mamba_remat_run(cfg, dev, *, batch, seq, steps, chunk):
    """Six runs at dp = 1 from one init under deterministic algorithms:
    remat off, on and "dots" x the associative and the chunked scan; each
    one's record and its buckets after the steps (on the host)."""
    cases = {}
    with _deterministic():
        for scan, impl in (("assoc", None), (f"chunked{chunk}",
                                             _chunked(chunk))):
            for name, kw in (("off", {}), ("on", dict(remat=True)),
                             ("dots", dict(remat=True,
                                           remat_policy="dots"))):
                rec, bundle, tr = train_run(
                    cfg, dev, steps=steps, dp=1, seq=seq, per_replica=batch,
                    ssm_scan_impl=impl, **kw)
                cases[(scan, name)] = (rec, [
                    b.detach().cpu() for b in tr.state["params"].buckets])
                del tr, bundle
                if _on_card(dev):
                    torch.cuda.empty_cache()
    return cases


def _remat_summary(cases) -> dict:
    out = {}
    for scan in dict.fromkeys(s for s, _ in cases):
        base = cases[(scan, "off")][1]
        out[scan] = {
            name: {"peak_mem_gb": rec["peak_mem_gb"],
                   "ms_per_step": rec["ms_per_step"],
                   "first_step_ms": rec["first_step_ms"],
                   "losses": rec["losses"],
                   "params_equal_remat_off": all(
                       _same_bits(a, b) for a, b in zip(params, base))}
            for (s, name), (rec, params) in cases.items() if s == scan}
    return out


def phase_mamba_remat(dev, cfg=None, sizes=MAMBA_REMAT):
    """falcon-mamba-7b at full width, 2 layers (a depth cut, so all six
    cases run): peak and ms/step of remat {off, on, dots} x scan {assoc,
    chunked}; under deterministic algorithms the params after the steps
    are bit-equal across the remat settings; whether chunking lowers the
    peak is reported, not assumed."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config("falcon-mamba-7b")
    short = dataclasses.replace(cfg, blocks=cfg.blocks[:SHORT_LAYERS])
    cases = mamba_remat_run(short, dev, **sizes)
    out = _remat_summary(cases)
    scans = list(out)
    out["chunked_lowers_peak"] = {
        name: out[scans[1]][name]["peak_mem_gb"] is not None
        and out[scans[1]][name]["peak_mem_gb"]
        < out[scans[0]][name]["peak_mem_gb"] for name in out[scans[0]]}
    log("[mamba_remat] " + json.dumps(out))
    bad = [(s, n) for s in scans for n, r in out[s].items()
           if not r["params_equal_remat_off"]]
    assert not bad, f"remat changed the params: {bad}"
    return out


def dense_train_run(cfg, dev, *, dp=DP, seq=SEQ, per_replica=PER_REPLICA,
                    steps=MAIN_STEPS):
    """``[main]``'s cell on another model: dp replicas stacked, sync gossip
    at ``GOSSIP_ALPHA``, packed fused sgd, remat off."""
    return train_run(cfg, dev, steps=steps, dp=dp, seq=seq,
                     per_replica=per_replica, gossip_alpha=GOSSIP_ALPHA)


def phase_dense_train(dev, archs=("olmo-1b", "stablelm-1.6b"),
                      tag="dense_train", **sizes):
    """olmo-1b and stablelm-1.6b (or ``archs``) at full width and depth on
    ``[main]``'s cell (or ``sizes``): ``fused_sgd`` launches = steps x
    buckets, losses, peak, profiled like ``[main]``; then, outside the
    counted run, the sweep on the largest replica-stacked bucket's size
    with a partner at the path's alpha against its plain version
    (``sweep_check``)."""
    from repro_torch.configs import get_config
    out = {}
    steps = sizes.get("steps", MAIN_STEPS)
    for arch in archs:
        cfg = get_config(arch)
        rec, bundle, tr = dense_train_run(cfg, dev, **sizes)
        want = dict(dict.fromkeys(KERNELS, 0),
                    fused_sgd=steps * bundle.layout.num_buckets)
        rec["expected_launches"] = want
        log(f"[{tag}] " + json.dumps(rec))
        assert rec["launches"] == want, (arch, rec["launches"], want)
        assert all(math.isfinite(v) for v in rec["losses"]), arch
        assert abs(rec["losses"][0] - math.log(cfg.vocab)) <= 1.0, arch
        assert _finite_buckets(tr), f"{arch}: non-finite parameters"
        rec["profile"] = profile_step(f"{tag} {arch}", tr)
        n = bundle.dp * max(bundle.layout.bucket_sizes)
        del tr, bundle
        torch.cuda.empty_cache()
        sweep = sweep_check(dev, n, lr=FULL_LR["sgd"], alpha=GOSSIP_ALPHA)
        log(f"[{tag}] {arch} fused_sgd on the largest bucket's size: "
            + json.dumps(sweep))
        assert sweep["partner"] and sweep["whole"]["equal"] \
            and sweep["tail"]["equal"], (arch, sweep)
        rec["sweep"] = sweep
        out[arch] = rec
        torch.cuda.empty_cache()
    return out


def _dense_models(chunk: int = 8):
    """[dense_agree]'s reduced fp32 models: the four dense members and
    falcon-mamba, the latter trained with remat and the chunked scan (a
    chunk below the sequence, so the chunks run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    def small(arch):
        return dataclasses.replace(reduced(get_config(arch)),
                                   param_dtype="float32",
                                   compute_dtype="float32")
    dense = {a: (small(a), {}) for a in ("olmo-1b", "stablelm-1.6b",
                                         "internlm2-20b",
                                         "llava-next-mistral-7b")}
    dense["falcon-mamba-7b"] = (small("falcon-mamba-7b"), dict(
        remat=True, ssm_scan_impl=_chunked(chunk)))
    return dense


def dense_agree_run(dev, *, models=None, steps=SHORT_STEPS, seq=16,
                    per_replica=2,
                    serve=dict(batch=2, prompt=12, steps=4, max_seq=32,
                               new=6)):
    """Each of ``models`` (name -> (config, the bundle's extra arguments);
    default ``_dense_models()``) trained from one init at dp = DP (sync
    fused sgd) on the CPU and on ``dev``: losses and buckets of both; each
    model with no extra arguments also served on both (prefill and each
    decode step's logits and caches, greedy tokens of ``ServingEngine``),
    with its stub inputs."""
    from repro_torch.models import lm_init
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import tree_map
    out = {}
    for name, (cfg, kw) in (models or _dense_models()).items():
        init = lm_init(cfg, seed=0, device="cpu")
        runs = {}
        for d in ("cpu", dev):
            params = tree_map(lambda t, d=d: t.to(d), init)
            bundle, tr = _train(cfg, fused=True, steps=steps, dev=d,
                                params=params, seq=seq,
                                per_replica=per_replica,
                                lr=AGREE_LR["sgd"], **kw)
            losses = [h["loss"] for h in tr.run(steps)]
            runs[str(d)] = (losses, [b.detach().cpu().numpy() for b in
                                     tr.state["params"].buckets])
        rec = {"train": {"cpu": runs["cpu"], "card": runs[str(dev)]}}
        if not kw:
            s = serve
            toks = torch.as_tensor(np.random.default_rng(1).integers(
                0, cfg.vocab, (s["batch"], s["prompt"] + s["steps"])),
                dtype=torch.int64)
            stubs = _stub_inputs(cfg, s["batch"])
            card = tree_map(lambda w: w.to(dev), init)
            with torch.inference_mode():
                traces = [_serve_trace(cfg, p, toks, d, s["prompt"],
                                       s["max_seq"], stubs)
                          for p, d in ((init, "cpu"), (card, dev))]
                prompts = toks[:, :s["prompt"]].numpy().astype(np.int32)
                tokens = [ServingEngine(cfg, p, s["max_seq"], device=d)
                          .generate(prompts, s["new"], **stubs)
                          for p, d in ((init, "cpu"), (card, dev))]
            rec["serve"] = {"traces": traces, "tokens": tokens}
        out[name] = rec
    return out


def phase_dense_agree(dev, models=None, tag="dense_agree"):
    """``dense_agree_run`` held on the card: train trajectories within
    ``[agree]``'s rule (rtol = atol = 2e-4), serving within 1e-5 with
    equal greedy tokens."""
    res = {}
    for name, rec in dense_agree_run(dev, models=models).items():
        r = {"train": _assert_agree(name, "sgd", {}, SHORT_STEPS,
                                    rec["train"]["cpu"],
                                    rec["train"]["card"])}
        if "serve" in rec:
            (cpu, card), (want, got) = (rec["serve"]["traces"],
                                        rec["serve"]["tokens"])
            err = max(_diff(g, w) for (lw, cw), (lg, cg) in zip(cpu, card)
                      for w, g in zip([lw] + cw, [lg] + cg))
            r["serve"] = {"card_vs_cpu_max_abs_err": err,
                          "tokens_equal_cpu": bool(np.array_equal(got,
                                                                  want))}
        log(f"[{tag}] {name}: " + json.dumps(r))
        assert "serve" not in r or (r["serve"]["card_vs_cpu_max_abs_err"]
                                    <= 1e-5 and r["serve"]
                                    ["tokens_equal_cpu"]), (name, r)
        res[name] = r
    return res


# ------------------------------- the encoder-decoder and routed-MoE family
WHISPER_TRAIN = dict(dp=DP, seq=448, per_replica=4, steps=MAIN_STEPS)
WHISPER_SERVE = dict(batch=8, prompt=16, new=64, max_seq=448)
JAMBA_UNIT = 8          # one hybrid unit: 7 Mamba layers, attention at 4
JAMBA_EVAL = dict(b=1, seq=4096, forwards=3)
JAMBA_SERVE = dict(batch=4, prompt=512, new=32, max_seq=4096)
JAMBA_TRAIN = dict(dp=2, seq=1024, per_replica=1, steps=3, chunk=256)
JAMBA_SSM_SHAPE = (1, 4096, 8192, 16)   # jamba's scan at 1 x 4096 tokens
KIMI_SERVE = dict(batch=1, prompt=1024, new=16, max_seq=2048)


def _depth(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers (a depth cut, widths kept)."""
    return dataclasses.replace(cfg, blocks=cfg.blocks[:n])


def jamba_train_run(cfg, dev, *, dp, seq, per_replica, steps, chunk,
                    remat_policy=None):
    """jamba training as ``[hier_fsdp]`` runs an fsdp config: the plan of
    mesh (dp, 1, 1) in the config's mode (dp gossip replicas over the
    pods), sync gossip at ``GOSSIP_ALPHA``, packed fused sgd, remat on
    (``remat_policy``), the chunked scan."""
    rec, bundle, tr = train_run(
        cfg, dev, steps=steps, dp=dp, seq=seq, per_replica=per_replica,
        dist=_plan(dp, 1, 1, cfg.dist_mode), gossip_alpha=GOSSIP_ALPHA,
        remat=True, remat_policy=remat_policy, ssm_scan_impl=_chunked(chunk))
    rec.update(scan=f"chunked {chunk}", dist_mode=cfg.dist_mode,
               bucket_sizes_max=max(bundle.layout.bucket_sizes))
    return rec, bundle, tr


def jamba_remat_pair(cfg, dev, *, dp, seq, per_replica, chunk, steps=2):
    """Plain remat and ``remat_policy="save_moe_combine"`` from one init
    under deterministic algorithms, ``steps`` each: their records and
    whether the params after the steps are bit-equal."""
    out, params = {}, {}
    with _deterministic():
        for policy in (None, "save_moe_combine"):
            rec, bundle, tr = jamba_train_run(
                cfg, dev, dp=dp, seq=seq, per_replica=per_replica,
                steps=steps, chunk=chunk, remat_policy=policy)
            out[policy or "remat"] = {
                k: rec[k] for k in ("peak_mem_gb", "ms_per_step",
                                    "first_step_ms", "losses")}
            params[policy] = [b.detach().cpu()
                              for b in tr.state["params"].buckets]
            del tr, bundle
            if _on_card(dev):
                torch.cuda.empty_cache()
    out["params_bit_equal"] = all(_same_bits(a, b) for a, b in zip(
        params[None], params["save_moe_combine"]))
    return out


def phase_jamba_train(dev, cfg=None, layers=2, sizes=JAMBA_TRAIN):
    """jamba at full width, ``layers`` layers (Mamba + MLP, Mamba + MoE),
    dp 2 on mesh (2, 1, 1) in its fsdp mode, remat on, the chunked scan:
    ``fused_sgd`` launches = steps x buckets, the scan's kernels 2 forwards
    and 1 backward a Mamba layer a step, losses, peak, one step
    profiled; then plain remat against save_moe_combine (peak, ms/step,
    params bit-equal); then the sweep on the largest replica-stacked
    bucket with a partner at alpha 0.5 (``sweep_check``)."""
    from repro_torch.configs import get_config
    cfg = _depth(cfg or get_config("jamba-v0.1-52b"), layers)
    rec, bundle, tr = jamba_train_run(cfg, dev, **sizes)
    want = dict(dict.fromkeys(KERNELS, 0),
                fused_sgd=sizes["steps"] * bundle.layout.num_buckets,
                **_train_scan_launches(cfg, sizes["steps"]))
    rec["expected_launches"] = want
    log("[jamba_train] " + json.dumps(rec))
    assert rec["launches"] == want, (rec["launches"], want)
    assert all(math.isfinite(v) for v in rec["losses"]), "non-finite loss"
    assert abs(rec["losses"][0] - math.log(cfg.vocab)) <= 1.0, rec["losses"]
    assert _finite_buckets(tr), "non-finite parameters"
    rec["profile"] = profile_step("jamba_train", tr, min_steps=1)
    n = bundle.dp * rec["bucket_sizes_max"]
    del tr, bundle
    torch.cuda.empty_cache()
    pair = jamba_remat_pair(cfg, dev, **{k: sizes[k] for k in (
        "dp", "seq", "per_replica", "chunk")})
    log("[jamba_train] remat against save_moe_combine: " + json.dumps(pair))
    assert pair["params_bit_equal"], "save_moe_combine changed the params"
    rec["save_moe_combine"] = pair
    sweep = sweep_check(dev, n, lr=FULL_LR["sgd"], alpha=GOSSIP_ALPHA)
    log("[jamba_train] fused_sgd on the largest bucket's size: "
        + json.dumps(sweep))
    assert sweep["partner"] and sweep["whole"]["equal"] \
        and sweep["tail"]["equal"], sweep
    rec["sweep"] = sweep
    torch.cuda.empty_cache()
    return rec


def phase_jamba_eval(dev, cfg=None):
    """jamba at full width, one hybrid unit (8 layers: 7 Mamba, 4 MoE),
    scored through the ssm_scan kernel (``phase_mamba_eval``: 7 launches a
    forward); then, outside the counted run, ssm_scan against its plain
    loop bit for bit at jamba's scan shape."""
    from repro_torch.configs import get_config
    cfg = _depth(cfg or get_config("jamba-v0.1-52b"), JAMBA_UNIT)
    res = phase_mamba_eval(dev, cfg, name="jamba_eval", **JAMBA_EVAL)
    res["check_ssm"] = phase_check_ssm(dev, shapes=(JAMBA_SSM_SHAPE,),
                                       bwd_shapes=())
    return res


def combine_check(cfg, dev):
    """``combine(params, toks)``: one prefill of ``toks`` with the MoE
    combine's inputs recorded (the first MoE layer's weighted slot outputs
    and inverse table), then the combine on the CPU on copies of them
    against the card's output, bit for bit (kimi's k = 8 in bf16: the add
    order is fixed, no atomics)."""
    from repro_torch.models import lm_cache_init, lm_prefill
    from repro_torch.models import moe as moe_mod

    def run(params, toks):
        seen, real = [], moe_mod._combine

        def record(ye, inv):
            out = real(ye, inv)
            if not seen:
                seen.append((ye.cpu(), inv.cpu(), out.cpu()))
            return out
        moe_mod._combine = record
        try:
            lm_prefill(params, cfg, toks, lm_cache_init(
                cfg, toks.shape[0], toks.shape[1], device=dev))
        finally:
            moe_mod._combine = real
        ye, inv, got = seen[0]
        want = real(ye, inv)
        return {"slots": ye.shape[1], "tokens": inv.shape[1],
                "top_k": inv.shape[2], "dtype": str(ye.dtype)[6:],
                "bit_equal": _same_bits(got, want),
                "max_abs_err": _diff(got.float(), want.float())}
    return run


def phase_serve_moe(name, cfg, dev, **sizes):
    """``phase_serve`` on an MoE model, with its aux over the prompt and,
    where the combine adds 3 or more slots, ``combine_check``."""
    if max(b.moe.top_k for b in cfg.blocks if b.moe is not None) > 2:
        sizes["combine_check"] = combine_check(cfg, dev)
    res = phase_serve(name, cfg, dev, **sizes)
    assert 0.0 <= res["moe_dropped_frac"] <= 1.0, res
    if "combine_check" in res:
        assert res["combine_check"]["bit_equal"], res["combine_check"]
    return res


def _encdec_moe_models():
    """[encdec_moe_agree]'s reduced fp32 models: whisper, jamba, kimi-k2."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return {a: (dataclasses.replace(reduced(get_config(a)),
                                    param_dtype="float32",
                                    compute_dtype="float32"), {})
            for a in ("whisper-base", "jamba-v0.1-52b", "kimi-k2-1t-a32b")}


# ------------------------------------------------- MLA and the MTP head
# deepseek-v3 at full width, cut in depth to fit one card: scoring and
# serving take its first 4 layers (3 dense MLA layers, then MLA + MoE; the
# MTP head's block is MoE), 26.7 G params; training takes 1 layer (the
# MTP block then dense), 3.12 G params a replica. Scoring runs 1 x 2,048
# tokens: at 4,096 the fp32 scores of 128 heads (8.6 GB a copy) and their
# mask, softmax and bf16 weights pass the card's 80 GB.
DEEPSEEK_CUT, DEEPSEEK_TRAIN_CUT = 4, 1
DEEPSEEK_EVAL = dict(b=1, seq=2048, forwards=3)
DEEPSEEK_SERVE = dict(batch=4, prompt=1024, new=32, max_seq=4096)
DEEPSEEK_TRAIN = dict(dp=2, seq=1024, per_replica=1, steps=3)


def phase_deepseek_eval(dev, cfg=None, sizes=DEEPSEEK_EVAL):
    """deepseek-v3 at full width, its first 4 layers with the MTP head,
    scored through ``make_loss_fn`` under no_grad (``eval_run``): no kernel
    on the path (MLA and the MoE are plain torch, as the reference's are
    jnp), finite losses, the first forward's CE within 1 of ln(vocab) (the
    loss adds 0.3 of the MTP head's CE), one forward profiled."""
    from repro_torch.configs import get_config
    cfg = cfg or _depth(get_config("deepseek-v3-671b"), DEEPSEEK_CUT)
    res, forward = eval_run(cfg, dev, **sizes)
    log("[deepseek_eval] " + json.dumps(res))
    assert res["launches"] == dict.fromkeys(KERNELS, 0), res["launches"]
    assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
    assert math.isfinite(res["mtp_ce"]) and res["losses"][-1] > res["ce"]
    assert abs(res["ces"][0] - math.log(cfg.vocab)) <= 1.0, res["ces"]
    assert 0.0 <= res["moe_dropped_frac"] <= 1.0, res
    res["profile"] = profile_forward("deepseek_eval", forward,
                                     res["ms_per_forward"])
    del forward
    torch.cuda.empty_cache()
    return res


def mla_cache_bytes(cfg) -> dict:
    """Decode-cache bytes per token and layer of an MLA config (its latent
    and RoPE key) beside the MHA cache its heads would need (each head's
    key, nope + rope wide, and value), in the param dtype."""
    from repro_torch.models.layers import dtype_of
    m = cfg.blocks[0].mla
    size = torch.finfo(dtype_of(cfg.param_dtype)).bits // 8
    mla = (m.kv_lora_rank + m.qk_rope_dim) * size
    mha = m.n_heads * (m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim) * size
    return {"cache_bytes_per_token_layer": mla,
            "mha_cache_bytes_per_token_layer": mha,
            "mha_over_mla": mha / mla}


def phase_serve_deepseek(dev, cfg=None, sizes=DEEPSEEK_SERVE):
    """The same 4 layers served (``phase_serve_moe``: the absorbed-latent
    decode over the ``(c_kv, k_rope)`` cache, no kernel, the k = 8 combine
    card against CPU), with the cache's bytes per token and layer beside
    the MHA cache of the same heads."""
    from repro_torch.configs import get_config
    cfg = cfg or _depth(get_config("deepseek-v3-671b"), DEEPSEEK_CUT)
    res = phase_serve_moe("serve_deepseek", cfg, dev, **sizes)
    res.update(mla_cache_bytes(cfg))
    log("[serve_deepseek] cache: " + json.dumps(
        {k: res[k] for k in ("cache_gb", "cache_bytes_per_token_layer",
                             "mha_cache_bytes_per_token_layer",
                             "mha_over_mla")}))
    return res


def deepseek_train_run(cfg, dev, *, dp, seq, per_replica, steps):
    """deepseek training as ``jamba_train_run`` runs an fsdp config (the
    plan of mesh (dp, 1, 1) in the config's mode, sync gossip at
    ``GOSSIP_ALPHA``, packed fused sgd), remat off."""
    rec, bundle, tr = train_run(
        cfg, dev, steps=steps, dp=dp, seq=seq, per_replica=per_replica,
        dist=_plan(dp, 1, 1, cfg.dist_mode), gossip_alpha=GOSSIP_ALPHA)
    rec.update(dist_mode=cfg.dist_mode,
               bucket_sizes_max=max(bundle.layout.bucket_sizes))
    return rec, bundle, tr


def phase_deepseek_train(dev, cfg=None, sizes=DEEPSEEK_TRAIN):
    """deepseek-v3 at full width, 1 layer with the MTP head, dp 2 on mesh
    (2, 1, 1) (``deepseek_train_run``): ``fused_sgd`` launches = steps x
    buckets, finite losses, the first CE within 1 of ln(vocab), one step
    profiled; then the sweep on the largest replica-stacked bucket with a
    partner at alpha 0.5 against its plain version (``sweep_check``)."""
    from repro_torch.configs import get_config
    cfg = cfg or _depth(get_config("deepseek-v3-671b"), DEEPSEEK_TRAIN_CUT)
    rec, bundle, tr = deepseek_train_run(cfg, dev, **sizes)
    want = dict(dict.fromkeys(KERNELS, 0),
                fused_sgd=sizes["steps"] * bundle.layout.num_buckets)
    rec["expected_launches"] = want
    log("[deepseek_train] " + json.dumps(rec))
    assert rec["launches"] == want, (rec["launches"], want)
    assert all(math.isfinite(v) for v in rec["losses"]), "non-finite loss"
    assert abs(rec["ces"][0] - math.log(cfg.vocab)) <= 1.0, rec["ces"]
    assert all(math.isfinite(v) for v in rec["mtp_ces"]), rec["mtp_ces"]
    assert _finite_buckets(tr), "non-finite parameters"
    rec["profile"] = profile_step("deepseek_train", tr, min_steps=1)
    n = bundle.dp * rec["bucket_sizes_max"]
    del tr, bundle
    torch.cuda.empty_cache()
    sweep = sweep_check(dev, n, lr=FULL_LR["sgd"], alpha=GOSSIP_ALPHA)
    log("[deepseek_train] fused_sgd on the largest bucket's size: "
        + json.dumps(sweep))
    assert sweep["partner"] and sweep["whole"]["equal"] \
        and sweep["tail"]["equal"], sweep
    rec["sweep"] = sweep
    torch.cuda.empty_cache()
    return rec


def _deepseek_models():
    """[deepseek_agree]'s reduced fp32 deepseek at 4 layers (the fourth and
    the MTP block MoE)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return {"deepseek-v3-671b": (dataclasses.replace(
        reduced(get_config("deepseek-v3-671b"), n_layers=4),
        param_dtype="float32", compute_dtype="float32"), {})}


# ------------------------------------------------- the launch tooling

# [dryrun_check]: train_4k's sequence at 2 replicas of 1 sequence (the batch
# cut from 256 for one card), and [serve_qwen]'s decode sizes
DRYRUN_TRAIN = dict(dp=2, seq=4096, per_replica=1)
DRYRUN_DECODE = dict(batch=SERVE_B, max_seq=SERVE_MAX_SEQ)
DRYRUN_PEAK_RTOL = 0.10
# [mix_flat]: the largest bucket's length plus a ragged tail of 77
MIX_FLAT_N = 155_582_464 + 77
EXAMPLES = dict(quick_steps=20, gva_steps=10, protocols="gossip,agd")


def _free_device(dev) -> int:
    """Release cached blocks; the bytes still allocated (0 off the card)."""
    import gc
    gc.collect()
    if not _on_card(dev):
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _busy_ms(fn) -> float:
    """Device busy ms of one ``fn()`` under torch.profiler (device-side
    events only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(r[1] for r in _device_rows(prof))


def dryrun_check_run(cfg, dev, *, dp, seq, per_replica, batch, max_seq):
    """[dryrun_check]'s body: the dry run's own functions
    (``launch.dryrun.trace_train`` at ``dp`` replicas of ``per_replica`` x
    ``seq`` tokens, remat on, and ``trace_serve("decode")`` at ``batch``
    sequences against a ``max_seq`` cache), each counted once on ``meta``
    and once on ``dev``; then one more step of the same program uncounted,
    timed, its peak above what the device held before the trace, and on
    the card its device busy time. Returns per kind the two counts, the
    measured figures and the roofline terms."""
    from repro_torch.launch.dryrun import trace_serve, trace_train
    from repro_torch.launch.roofline import H100
    cases = {
        "train": lambda d: trace_train(cfg, dp, seq, per_replica, d,
                                       remat=True),
        "decode": lambda d: trace_serve(cfg, "decode", max_seq, batch, d)}
    out = {}
    for kind, make in cases.items():
        meta = make("meta").counts
        base = _free_device(dev)
        _reset_counts()
        tr = make(dev)
        launches = _counts()
        got = tr.counts
        _sync(dev)
        _reset_peak(dev)
        mark, elapsed = _marker(dev)
        a = mark()
        tr.rerun()
        b = mark()
        _sync(dev)
        ms = elapsed(a, b)
        peak = (torch.cuda.max_memory_allocated() - base if _on_card(dev)
                else None)
        busy = _busy_ms(tr.rerun) if _on_card(dev) else None
        compute_ms = got.flops / H100.peak_flops * 1e3
        memory_ms = got.op_bytes / H100.hbm_bw * 1e3
        out[kind] = {
            "flops": {"meta": meta.flops, "device": got.flops},
            "op_bytes": {"meta": meta.op_bytes, "device": got.op_bytes},
            "n_ops": {"meta": meta.n_ops, "device": got.n_ops},
            "flops_equal": meta.flops == got.flops,
            "op_bytes_equal": meta.op_bytes == got.op_bytes,
            "meta_entry_bytes": meta.entry_bytes,
            "meta_peak_bytes": meta.peak_bytes,
            "device_counted_peak_bytes": got.peak_bytes,
            "measured_peak_bytes": peak,
            "peak_rel_err": (None if peak is None
                             else abs(meta.peak_bytes - peak) / peak),
            "trace_s": {"device": tr.seconds},
            "measured_ms": ms, "device_busy_ms": busy,
            "compute_term_ms": compute_ms, "memory_term_ms": memory_ms,
            "compute_share_of_measured": compute_ms / ms,
            "memory_share_of_measured": memory_ms / ms,
            "top_ops": got.as_dict(8)["top_ops"], "launches": launches}
        del tr
        _free_device(dev)
    return out


def phase_dryrun_check(dev, cfg=None):
    """The meta-device dry run held to a measured run of the same program
    on the card: qwen3-0.6b at full width (``dryrun_check_run`` at
    ``DRYRUN_TRAIN`` and ``DRYRUN_DECODE``). FLOPs and op bytes equal
    between ``meta`` and ``cuda`` exactly; the meta peak within 10% of
    the measured one; the compute term no larger than the measured busy
    time; no kernel launched (none lies on the dry run's program)."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config("qwen3-0.6b")
    out = dryrun_check_run(cfg, dev, **DRYRUN_TRAIN, **DRYRUN_DECODE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for kind, r in out.items():
        r["card"] = smi
        log(f"[dryrun_check] {kind}: " + json.dumps(r))
        assert r["flops_equal"] and r["op_bytes_equal"], (kind, r["flops"],
                                                          r["op_bytes"])
        assert r["peak_rel_err"] <= DRYRUN_PEAK_RTOL, (kind, r)
        assert r["compute_term_ms"] <= r["device_busy_ms"], (kind, r)
        assert r["launches"] == dict.fromkeys(KERNELS, 0), r["launches"]
    return out


def comm_accounting_run(cfg, dev, *, seq=SEQ, per_replica=PER_REPLICA):
    """[comm_accounting]'s body: the bytes the packed engines' exchange
    really returns, summed over its payload tensors (a wrapper around
    ``core.gossip.exchange`` in both engine modules), on [main]'s path
    (sync gossip, fp32 wire, fused sgd) over one step and on
    ``async_wire``'s (gossip_async int8, subset 0.5) over one protocol
    period, against ``wire_bytes_per_step`` and ``sent_bytes_at``.
    Per replica: the returned bytes over dp."""
    import repro_torch.core.async_gossip as async_mod
    import repro_torch.core.gossip as gossip_mod
    from repro_torch.core import sent_bytes_at, wire_bytes_per_step
    orig = gossip_mod.exchange
    sent = []

    def counted(x, recv_from, group=None):
        y = orig(x, recv_from, group)
        ts = list(y.values()) if isinstance(y, dict) else [y]
        sent.append(sum(t.numel() * t.element_size() for t in ts))
        return y

    out = {}
    gossip_mod.exchange = async_mod.exchange = counted
    try:
        for name, kw in (("sync_fp32", {}), ("async_int8_sub0.5",
                                             ASYNC_WIRE)):
            bundle, tr = _train(cfg, fused=True, steps=MAIN_STEPS, dev=dev,
                                seq=seq, per_replica=per_replica, **kw)
            steps = 1 if not kw else bundle.protocol.period
            sent.clear()
            tr.run(steps)
            _sync(dev)
            lay, wire = bundle.layout, bundle.wire
            acc = wire_bytes_per_step(lay, wire)
            total = sum(sent)
            exact = sum(sent_bytes_at(lay, wire, t)["total_bytes"]
                        for t in range(steps))
            rec = {"dp": bundle.dp, "num_buckets": lay.num_buckets,
                   "steps": steps, "exchanges": len(sent),
                   "returned_bytes": total,
                   "per_replica_bytes": total // bundle.dp,
                   "divides": total % bundle.dp == 0,
                   "wire_bytes_per_step": acc,
                   "sent_bytes_at_sum": exact,
                   "steps_x_total_bytes": steps * acc["total_bytes"]}
            rec["equal_sent_bytes_at"] = rec["per_replica_bytes"] == exact
            if not kw:
                rec["equal_raw_bytes"] = (rec["per_replica_bytes"]
                                          == acc["raw_bytes"])
            else:
                rec["ratio_to_steps_x_total"] = (
                    rec["per_replica_bytes"] / rec["steps_x_total_bytes"])
            out[name] = rec
            del tr, bundle
            _free_device(dev)
    finally:
        gossip_mod.exchange = async_mod.exchange = orig
    return out


def phase_comm_accounting(dev, cfg=None):
    """[comm_accounting] at full width (qwen3-0.6b, dp 4, 13 buckets):
    one sync fp32 step moves exactly ``raw_bytes`` a replica, and one
    period of the int8 subset-0.5 ring moves exactly the sum of
    ``sent_bytes_at`` over its phases; both are printed beside
    ``wire_bytes_per_step``'s averaged figure."""
    from repro_torch.configs import get_config
    out = comm_accounting_run(cfg or get_config("qwen3-0.6b"), dev)
    log("[comm_accounting] " + json.dumps(out))
    sync, wired = out["sync_fp32"], out["async_int8_sub0.5"]
    assert sync["divides"] and sync["equal_raw_bytes"], sync
    assert sync["equal_sent_bytes_at"], sync
    assert wired["divides"] and wired["equal_sent_bytes_at"], wired
    return out


def mix_flat_run(dev, n, tree_cfg, *, rounds=7, reps=10):
    """[mix_flat]'s body. ``gossip_mix_flat`` on ``n`` elements (seeded),
    bf16 and fp32, against the plain version (bit for bit) with the input
    untouched; ``gossip_mix_tree`` over ``tree_cfg``'s one-replica leaf
    tree (seeds 0 and 1) against the per-leaf plain mix, its launches
    counted; on the card the flat mix, its plain version and
    ``torch.lerp`` timed in interleaved rounds (median, min, max) beside
    the byte bound (read two buffers, write one)."""
    from repro_torch.kernels import gossip_mix_flat, gossip_mix_tree
    from repro_torch.kernels.gossip_mix import gossip_mix_plain
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_flatten
    gen = torch.Generator().manual_seed(0)
    out = {"n": n}
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.randn(n, generator=gen).to(dev, dtype)
        b = torch.randn(n, generator=gen).to(dev, dtype)
        a0 = a.clone()
        _reset_counts()
        got = gossip_mix_flat(a, b, 0.5)
        launches = _counts()["gossip_mix"]
        want = gossip_mix_plain(a, b, 0.5)
        rec = {"launches": launches,
               "equal": bool(torch.equal(_bits(got), _bits(want))),
               "max_abs_err": _diff(got, want),
               "input_untouched": bool(torch.equal(_bits(a), _bits(a0)))}
        del a0, want, got
        if _on_card(dev):
            t = rounds_ms({"kernel": lambda: gossip_mix_flat(a, b, 0.5),
                           "plain": lambda: gossip_mix_plain(a, b, 0.5),
                           "lerp": lambda: torch.lerp(a, b, 0.5)},
                          rounds=rounds, reps=reps)
            rec.update(ms=t["kernel"], plain_ms=t["plain"], lerp_ms=t["lerp"],
                       **bound(3 * n * a.element_size(), 0))
        out[str(dtype).split(".")[-1]] = rec
        del a, b
        _free_device(dev)
    pa = lm_init(tree_cfg, seed=0, device=dev)
    pb = lm_init(tree_cfg, seed=1, device=dev)
    leaves = len(tree_flatten(pa)[0])
    _reset_counts()
    got = gossip_mix_tree(pa, pb, 0.5)
    launches = _counts()["gossip_mix"]
    want = [gossip_mix_plain(x, y, 0.5) for x, y in
            zip(tree_flatten(pa)[0], tree_flatten(pb)[0])]
    out["tree"] = {
        "leaves": leaves, "launches": launches,
        "equal": all(torch.equal(_bits(g), _bits(w)) for g, w in
                     zip(tree_flatten(got)[0], want)),
        "max_abs_err": max(_diff(g, w) for g, w in
                           zip(tree_flatten(got)[0], want)),
        "elements": sum(x.numel() for x in want)}
    del pa, pb, got, want
    _free_device(dev)
    return out


def phase_mix_flat(dev):
    """``gossip_mix_flat`` / ``gossip_mix_tree`` on the card
    (``mix_flat_run`` at ``MIX_FLAT_N`` and full-width qwen3-0.6b): one
    launch per flat call, bit-equal to the plain version, input untouched;
    the tree's launches equal its leaf count."""
    from repro_torch.configs import get_config
    out = mix_flat_run(dev, MIX_FLAT_N, get_config("qwen3-0.6b"))
    log("[mix_flat] " + json.dumps(out))
    for k in ("bfloat16", "float32"):
        r = out[k]
        assert r["launches"] == 1 and r["equal"] and r["input_untouched"], r
    t = out["tree"]
    assert t["equal"] and t["launches"] == t["leaves"], t
    return out


def examples_run(dev, *, quick_steps, gva_steps, protocols):
    """[examples]'s body: the port's three examples through their
    ``main(argv)`` on ``dev``: quickstart, gossip_vs_agd and
    serve_batched."""
    from repro_torch.examples import gossip_vs_agd, quickstart, serve_batched
    d = ["--device", str(dev)]
    quick = quickstart.main(["--steps", str(quick_steps)] + d)
    gva = gossip_vs_agd.main(["--steps", str(gva_steps), "--protocols",
                              protocols] + d)
    served = serve_batched.main(d)
    return {"quickstart": {k: quick[k] for k in ("final_loss",
                                                 "replica_variance")},
            "gossip_vs_agd": gva,
            "serve_batched": {"shape": list(served["tokens"].shape),
                              "first_row": served["tokens"][0].tolist(),
                              "tok_per_s": served["tok_per_s"]}}


def phase_examples(dev):
    """The three examples on the card (``examples_run`` at ``EXAMPLES``):
    finite losses, the served tokens of the expected shape."""
    out = examples_run(dev, **EXAMPLES)
    log("[examples] " + json.dumps(out))
    losses = [out["quickstart"]["final_loss"]] + [
        r["final_loss"] for r in out["gossip_vs_agd"].values()]
    assert all(math.isfinite(v) for v in losses), losses
    assert out["serve_batched"]["shape"] == [4, 24], out["serve_batched"]
    return out


# ------------------------------------------- in-pod FSDP, one rank a process
# the slice's path: full-width qwen3-0.6b under fsdp on (pod 1, data 2,
# model 2), one process per mesh position, 1 x 256 tokens a data position
FSDP_RANKS = dict(mesh=(1, 2, 2), arch="qwen3-0.6b", seq=SEQ,
                  per_position=1, steps=SHORT_STEPS, lr=0.1)
# [fsdp_ranks_agree]: [agree]'s reduced fp32 model on the same mesh
FSDP_AGREE = dict(mesh=(1, 2, 2), arch="qwen3-0.6b", reduced=dict(d_model=64),
                  seq=16, per_position=2, steps=SHORT_STEPS,
                  lr=AGREE_LR["sgd"], bucket_bytes=AGREE_BUCKET_BYTES)
# [leaf_ranks]: the per-leaf engines (the launcher's default path) on the
# same mesh and model, each rank its piece of every leaf
LEAF_RANKS = dict(FSDP_RANKS)
# [leaf_ranks_agree]: [agree]'s reduced fp32 model, per-leaf sgd and lars
LEAF_AGREE = dict(mesh=(1, 2, 2), arch="qwen3-0.6b",
                  reduced=dict(d_model=64), seq=16, per_position=2,
                  steps=SHORT_STEPS, lr=AGREE_LR["sgd"],
                  optimizers=("sgd", "lars"))
FSDP_TIMEOUT_S = 300
# what gloo says when it has no CUDA counterpart of a collective
GLOO_REFUSAL = re.compile(r"(gloo|Gloo)[^\n]*(not supported|unsupported|"
                          r"does not support|not implemented)|"
                          r"(not supported|unsupported|not implemented)"
                          r"[^\n]*(gloo|Gloo)")

_RANK_CHILD = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.exit(cs.fsdp_rank_child(*sys.argv[2:]))
"""


def _rank_cfg(spec):
    """The model of a rank spec: ``arch`` in its dtypes (cut to its first
    ``layers``), or reduced fp32 with ``reduced``; fsdp mode, as the
    reference's e2e test forces it."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    cfg = get_config(spec["arch"])
    if spec.get("layers"):
        cfg = _depth(cfg, spec["layers"])
    if spec.get("reduced"):
        cfg = dataclasses.replace(reduced(cfg, **spec["reduced"]),
                                  param_dtype="float32",
                                  compute_dtype="float32")
    return dataclasses.replace(cfg, dist_mode="fsdp")


@contextlib.contextmanager
def _traffic(group, dev):
    """Bytes this rank receives from the others in the in-replica
    collectives while the block runs, and the host ms spent in them
    (the device synchronized before and after each call): the stretches'
    ``all_gather`` over the in-replica group, the gradient's
    ``all_to_all`` over the batch group, the ``all_gather`` over the batch
    group (expert parallelism's expert gather, and the metrics' means)
    and over the model group (its partial sums), the rest apart."""
    import torch.distributed as tdist
    moved = {"all_gather": 0, "reduce_scatter": 0, "batch_gather": 0,
             "model_sum": 0, "other": 0}
    ms = dict.fromkeys(moved, 0.0)
    ag, a2a = tdist.all_gather, tdist.all_to_all_single

    def timed(key, n, fn, *args, **kw):
        moved[key] += n
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(dev)
        ms[key] += (time.perf_counter() - t0) * 1e3
        return out

    def all_gather(parts, x, group=None, **kw):
        n = x.numel() * x.element_size() * (len(parts) - 1)
        key = ("all_gather" if group is grp.inner else
               "batch_gather" if group is grp.batch and group is not None
               else "model_sum" if group is grp.model and group is not None
               else "other")
        return timed(key, n, ag, parts, x, group=group, **kw)

    def all_to_all_single(out, x, group=None, **kw):
        size = tdist.get_world_size(group)
        n = out.numel() * out.element_size() * (size - 1) // size
        key = "reduce_scatter" if group is grp.batch else "other"
        return timed(key, n, a2a, out, x, group=group, **kw)

    grp = group
    tdist.all_gather, tdist.all_to_all_single = all_gather, all_to_all_single
    try:
        yield moved, ms
    finally:
        tdist.all_gather, tdist.all_to_all_single = ag, a2a


def _rank_trainer(cfg, spec, dist, dev, group, *, packed=True,
                  optimizer="sgd", **kw):
    """Packed fused sgd on this rank's stretches (dp 1: alpha 0), or with
    ``packed=False`` the per-leaf engine of ``optimizer`` on its pieces
    (``kw`` reaches the bundle: ``mix_impl``, ``remat`` (default off));
    ``group`` None: the stacked run of the plan."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.launch.mesh import mesh_tables
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    opt = make_optimizer(optimizer, spec["steps"], spec["lr"])
    kw.setdefault("remat", False)
    bundle = make_train_step_bundle(cfg, opt, dist=dist, gossip_packed=packed,
                                    device=dev, group=group, **kw)
    state = init_train_state(cfg, opt, dist=dist, packed=packed,
                             layout=bundle.layout, seed=0, device=dev,
                             group=group)
    rows = spec["per_position"] * mesh_tables(dist).batch_shards
    ds = ShardedTokenDataset(cfg.vocab, spec["seq"], n_shards=bundle.dp,
                             batch_per_shard=rows)
    return bundle, Trainer(bundle, state, ds, log_every=0)


def _stretch_sweep(dev, p, m, lr: float) -> dict:
    """``fused_sgd_1d`` on copies of one stretch and its momentum with a
    seeded gradient, against ``fused_sgd_plain`` on the same inputs, bit
    for bit (alpha 0, as at dp 1)."""
    from repro_torch.kernels import fused_sgd_1d, fused_sgd_plain
    p, m = p.detach().reshape(-1), m.reshape(-1)
    gen = torch.Generator(device=p.device).manual_seed(5)
    g = torch.empty_like(p).normal_(0.0, 0.01, generator=gen)
    gp, gm = p.clone(), m.clone()
    fused_sgd_1d(gp, g, None, gm, lr=lr, alpha=0.0, momentum=MOMENTUM)
    wp, wm = fused_sgd_plain(p, g, None, m, lr=lr, alpha=0.0,
                             momentum=MOMENTUM)
    _sync(dev)
    return {"elements": p.numel(),
            "equal": bool(torch.equal(gp, wp) and torch.equal(gm, wm)),
            "max_abs_err": max(_diff(gp, wp), _diff(gm, wm))}


def _rank_window(tr, group, dev, steps: int) -> dict:
    """``steps`` steps of a rank's Trainer, the launch counts reset just
    before and read just after: ms/step, the bytes its in-replica
    collectives received and their ms over the steps after the first (one
    window), the first step apart; its peak."""
    _sync(dev)
    _reset_peak(dev)
    _reset_counts()
    t0 = time.perf_counter()
    tr.run(1)
    _sync(dev)
    t1 = time.perf_counter()
    with _traffic(group, dev) as (moved, coll_ms):
        hist = tr.run(steps - 1, start_step=1)
        _sync(dev)
        t2 = time.perf_counter()
    return {"steps": steps, "losses": [h["loss"] for h in hist],
            "first_step_ms": (t1 - t0) * 1e3,
            "ms_per_step": (t2 - t1) * 1e3 / (steps - 1),
            "peak_mem_gb": _peak_gb(dev), "launches": _counts(),
            "bytes_per_step": {k: v / (steps - 1) for k, v in moved.items()},
            "collective_ms_per_step": {k: v / (steps - 1)
                                       for k, v in coll_ms.items()}}


def _rank_record(group, cfg, spec, replica_bytes: int) -> dict:
    """What every rank record names: its place, its model, its tokens and
    the dry run's count of its in-replica bytes."""
    from repro_torch.launch.roofline import in_replica_bytes
    return {"rank": group.rank, "replica": group.replica,
            "shard": group.shard, "batch_index": group.batch_index,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "dtype": cfg.param_dtype,
            "tokens_per_rank": spec["per_position"] * spec["seq"],
            "count_per_step": in_replica_bytes(
                group.num_shards, group.batch_shards, replica_bytes,
                replica_bytes)}


def _fsdp_rank_train(group, dist, dev, spec) -> dict:
    """[fsdp_ranks] on this rank (``_rank_window``), against the padded
    stretches' bytes; then its largest stretch's sweep against the plain
    version."""
    from repro_torch.kernels.quantize import dtype_bytes
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    cfg = _rank_cfg(spec)
    bundle, tr = _rank_trainer(cfg, spec, dist, dev, group)
    lay, steps = bundle.layout, spec["steps"]
    assert bundle.fused and lay.num_shards == group.num_shards
    assert all(tuple(b.shape) == (1, n) for b, n in
               zip(tr.state["params"].buckets, lay.strides))
    item = [dtype_bytes(dt) for dt in lay.bucket_dtypes]
    stretch_bytes = sum(n * i for n, i in zip(lay.strides, item))
    replica = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                  for s in tree_flatten(lm_specs(cfg))[0])
    rec = {**_rank_record(group, cfg, spec, replica),
           **_rank_window(tr, group, dev, steps),
           "num_buckets": lay.num_buckets, "strides": list(lay.strides),
           "expected_launches": dict(dict.fromkeys(KERNELS, 0),
                                     fused_sgd=steps * lay.num_buckets),
           "count_per_step_padded": {
               "all-gather_bytes": (group.num_shards - 1) * stretch_bytes,
               "reduce-scatter_bytes": (group.batch_shards - 1)
               * stretch_bytes}}
    big = max(range(lay.num_buckets), key=lambda i: lay.strides[i])
    rec["sweep"] = _stretch_sweep(dev, tr.state["params"].buckets[big],
                                  tr.state["opt"]["mom"].buckets[big],
                                  spec["lr"])
    rec["sweep"]["bucket"] = big
    del tr, bundle
    _free_device(dev)
    return rec


def _fsdp_rank_agree(group, dist, dev, spec) -> tuple:
    """[fsdp_ranks_agree] on this rank: the reduced run's losses and
    gathered leaves, its stretches after the run, a checkpoint of the
    ranks, and the stacked run's checkpoint restored into a fresh rank
    state."""
    from repro_torch.checkpoint import restore_state, save_state
    cfg = _rank_cfg(spec)
    with _bucket_bytes(spec["bucket_bytes"]):
        bundle, tr = _rank_trainer(cfg, spec, dist, dev, group)
        hist = tr.run(spec["steps"])
        save_state(spec["rank_ckpt"], tr.state, step=spec["steps"],
                   group=group)
        _, fresh = _rank_trainer(cfg, spec, dist, dev, group)
    restored, _ = restore_state(spec["stacked_ckpt"], fresh.state, group)
    arrays = {f"leaf{i}": x.float().cpu().numpy()
              for i, x in enumerate(_leaf_view(tr.state["params"]))}
    for tag, st in (("stretch", tr.state), ("restored", restored)):
        for i, b in enumerate(st["params"].buckets):
            arrays[f"{tag}{i}"] = b.detach().cpu().numpy()
    return {"losses": [h["loss"] for h in hist],
            "num_buckets": bundle.layout.num_buckets}, arrays


def fsdp_rank_child(rank, world, init, out, spec_json) -> int:
    """One rank of [fsdp_ranks] / [fsdp_ranks_agree] (or with ``kind``
    "leaf" of [leaf_ranks] / [leaf_ranks_agree], with "moe" of
    [moe_ranks] / [moe_ranks_agree] / [serve_ranks], with "seq" of
    [serve_seq_ranks]): join the gloo world
    of the mesh (CUDA tensors on the card: ``backend="gloo"``, every rank
    on the one card), run the rank's parts, write its record (JSON) and
    arrays (npz) under ``out``. Returns 1 with the traceback recorded when
    anything failed."""
    spec = json.loads(spec_json)
    res, arrays = {"rank": int(rank)}, {}
    try:
        from repro_torch.launch.mesh import (destroy_replica_group,
                                             init_replica_group)
        if spec["device"] == "cuda":
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            if spec.get("kind") in ("moe", "seq"):   # four ranks, big
                os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                      "expandable_segments:True")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        dist = _plan(*spec["ranks"]["mesh"], "fsdp")
        group = init_replica_group(spec["device"], dist=dist, backend="gloo",
                                   rank=int(rank), world_size=int(world),
                                   init_method=init,
                                   timeout_s=FSDP_TIMEOUT_S)
        parts = {"packed": (("ranks", _fsdp_rank_train),
                            ("agree", _fsdp_rank_agree)),
                 "leaf": (("ranks", _leaf_rank_train),
                          ("agree", _leaf_rank_agree)),
                 "moe": (("ranks", _moe_rank_train),
                         ("agree", _moe_rank_agree),
                         ("serve", _serve_rank)),
                 "seq": (("seq", _serve_seq_rank),)}[spec.get("kind",
                                                          "packed")]
        try:
            for key, fn in parts:
                got = fn(group, dist, group.device, spec[key])
                if isinstance(got, tuple):   # (record, arrays)
                    got, more = got
                    arrays.update(more)
                res[key] = got
        finally:
            destroy_replica_group()
    except Exception:  # noqa: BLE001 - the parent reads the traceback
        res["error"] = traceback.format_exc()
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(res, f)
    return 1 if "error" in res else 0


def _spawn_ranks(dev, world: int, spec: dict, tmp: Path) -> list:
    """Run ``fsdp_rank_child`` on every rank of the world; each rank's
    (record, arrays), by rank. Every wait has a time limit, and a rank
    that outlives it is killed."""
    init = f"file://{tmp / 'rendezvous'}"
    spec = dict(spec, device=torch.device(dev).type)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if not _on_card(dev):
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CHILD, str(Path(__file__).resolve()),
         str(r), str(world), init, str(tmp / f"rank{r}"), json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=2 * FSDP_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r, log_ in enumerate(logs):
        path = tmp / f"rank{r}"
        if not path.with_suffix(".json").exists():
            ranks.append(({"rank": r, "error": log_[-3000:]}, {}))
            continue
        with open(path.with_suffix(".json")) as f:
            rec = json.load(f)
        with np.load(str(path) + ".npz") as z:
            ranks.append((rec, dict(z)))
    return ranks


def fsdp_ranks_run(dev, *, ranks=FSDP_RANKS, agree=FSDP_AGREE) -> dict:
    """The body of [fsdp_ranks] and [fsdp_ranks_agree]: the stacked
    shard-local run of ``agree`` on ``dev`` (its losses, leaves and final
    buckets, and its checkpoint), then one gloo world of ``prod(mesh)``
    processes, each running ``ranks`` and then ``agree``, then the ranks'
    checkpoint restored into a fresh stacked state. The kernels are built
    already (``[build]``), so the ranks load them. Returns the ranks'
    records and arrays, the stacked run's, and the ranks' file restored."""
    from repro_torch.checkpoint import restore_state, save_state
    world = int(np.prod(ranks["mesh"]))
    dist = _plan(*agree["mesh"], "fsdp")
    cfg = _rank_cfg(agree)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="fsdp_ranks_", dir=ROOT / "build"))
    try:
        agree = dict(agree, rank_ckpt=str(tmp / "rank_ckpt"),
                     stacked_ckpt=str(tmp / "stacked_ckpt"))
        with _bucket_bytes(agree["bucket_bytes"]):
            bundle, tr = _rank_trainer(cfg, agree, dist, dev, None)
            stacked = {"losses": [h["loss"] for h in tr.run(agree["steps"])],
                       "leaves": [x.float().cpu().numpy()
                                  for x in _leaf_view(tr.state["params"])],
                       "buckets": [b.detach().cpu().numpy() for b in
                                   tr.state["params"].buckets],
                       "strides": list(bundle.layout.strides)}
            save_state(agree["stacked_ckpt"], tr.state, step=agree["steps"])
            _, fresh = _rank_trainer(cfg, agree, dist, dev, None)
        del tr, bundle
        _free_device(dev)
        out = {"stacked": stacked, "world": world,
               "mesh": list(ranks["mesh"]),
               "ranks": _spawn_ranks(dev, world, dict(ranks=ranks,
                                                      agree=agree), tmp)}
        if not any("error" in r for r, _ in out["ranks"]):
            state, _ = restore_state(agree["rank_ckpt"], fresh.state)
            out["rank_file_in_stacked"] = [b.detach().cpu().numpy()
                                           for b in state["params"].buckets]
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _refusal(ranks) -> str | None:
    """gloo's refusal of a CUDA collective, if that is what stopped the
    ranks."""
    for rec, _ in ranks:
        m = GLOO_REFUSAL.search(rec.get("error", ""))
        if m:
            line = [ln for ln in rec["error"].splitlines() if m.group(0) in ln]
            return (line or [m.group(0)])[-1].strip()
    return None


def _check_ranks(out: dict, dev) -> tuple:
    """The rank records of a world (``fsdp_ranks_run`` or
    ``leaf_ranks_run``) and their common summary: per rank its ms/step,
    peak, launches and bytes a step against the dry run's count. Asserts
    the measured bytes equal the padded count, the launch counts (as
    expected on the card, none off it), one replica-mean loss on every
    rank, finite losses from about ln(vocab)."""
    recs = [r["ranks"] for r, _ in out["ranks"]]
    r0 = recs[0]
    res = {"world": out["world"], "mesh": out["mesh"],
           "dist_mode": "fsdp", "backend": "gloo",
           "layers": r0["layers"], "d_model": r0["d_model"],
           "dtype": r0["dtype"], "steps": r0["steps"],
           "tokens_per_rank": r0["tokens_per_rank"],
           "losses": r0["losses"], "first_step_ms": r0["first_step_ms"],
           "ms_per_step": r0["ms_per_step"],
           "ms_per_step_by_rank": [r["ms_per_step"] for r in recs],
           "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in recs],
           "launches_by_rank": [r["launches"] for r in recs],
           "expected_launches": r0["expected_launches"],
           "bytes_per_step_by_rank": [r["bytes_per_step"] for r in recs],
           "collective_ms_per_step_by_rank": [r["collective_ms_per_step"]
                                              for r in recs],
           "count_per_step": r0["count_per_step"],
           "count_per_step_padded": r0["count_per_step_padded"]}
    for r in recs:
        want = (r["expected_launches"] if _on_card(dev)
                else dict.fromkeys(KERNELS, 0))
        assert r["launches"] == want, (r["launches"], want)
        assert r["bytes_per_step"]["all_gather"] == \
            r["count_per_step_padded"]["all-gather_bytes"], r
        assert r["bytes_per_step"]["reduce_scatter"] == \
            r["count_per_step_padded"]["reduce-scatter_bytes"], r
        assert r["losses"] == r0["losses"], "ranks report one replica mean"
    assert all(math.isfinite(v) for v in r0["losses"]), "non-finite loss"
    assert abs(r0["losses"][0] - math.log(r0["vocab"])) <= 1.0, r0["losses"]
    return recs, res


def check_fsdp_ranks(out: dict, dev) -> dict:
    """[fsdp_ranks]'s record from ``fsdp_ranks_run`` (``_check_ranks``)
    and each rank's stretch sweep, asserted bit-equal."""
    recs, res = _check_ranks(out, dev)
    res.update(num_buckets=recs[0]["num_buckets"],
               sweep_by_rank=[r["sweep"] for r in recs])
    for r in recs:
        assert r["sweep"]["equal"], r["sweep"]
    return res


def check_fsdp_agree(out: dict) -> dict:
    """[fsdp_ranks_agree]'s record: the ranks' losses and gathered leaves
    against the stacked run's within rtol = atol = 2e-4; the ranks' file
    restored in the stacked run equals their stretches bit for bit, and the
    stacked file restored in the ranks equals its chunks."""
    st = out["stacked"]
    strides = st["strides"]
    worst = 0.0
    for rec, arr in out["ranks"]:
        got = rec["agree"]["losses"]
        np.testing.assert_allclose(got, st["losses"], rtol=2e-4, atol=2e-4)
        for i, want in enumerate(st["leaves"]):
            np.testing.assert_allclose(arr[f"leaf{i}"], want, rtol=2e-4,
                                       atol=2e-4)
            worst = max(worst, float(np.abs(arr[f"leaf{i}"] - want).max()))
    by_shard = {rec["ranks"]["shard"]: arr for rec, arr in out["ranks"]}
    same_rank_file = all(
        np.array_equal(out["rank_file_in_stacked"][i],
                       np.concatenate([by_shard[s][f"stretch{i}"]
                                       for s in sorted(by_shard)], -1))
        for i in range(len(strides)))
    same_stacked_file = all(
        np.array_equal(arr[f"restored{i}"],
                       st["buckets"][i][..., rec["ranks"]["shard"] * n:
                                        (rec["ranks"]["shard"] + 1) * n])
        for rec, arr in out["ranks"] for i, n in enumerate(strides))
    res = {"losses_stacked": st["losses"],
           "losses_ranks": out["ranks"][0][0]["agree"]["losses"],
           "max_abs_diff_params": worst, "num_buckets": len(strides),
           "rank_file_restores_in_stacked_bit_equal": same_rank_file,
           "stacked_file_restores_in_ranks_bit_equal": same_stacked_file}
    assert same_rank_file and same_stacked_file, res
    return res


def _ranks_failed(out: dict, tag: str):
    """None when every rank ran; gloo's refusal of a CUDA collective as
    the "not measured" record; any other rank failure raises."""
    errors = [r for r, _ in out["ranks"] if "error" in r]
    if not errors:
        return None
    refused = _refusal(out["ranks"])
    if refused is None:
        for r in errors:
            log(f"[{tag}] rank {r['rank']}:\n{r['error']}")
        raise RuntimeError(f"[{tag}] a rank failed")
    res = {"not_measured": "needs 2+ cards", "gloo_refused": refused}
    log(f"[{tag}] " + json.dumps(res))
    return res


def phase_fsdp_ranks(out: dict, dev) -> dict:
    """[fsdp_ranks] from ``fsdp_ranks_run``'s world (``check_fsdp_ranks``):
    if gloo refused a CUDA collective the path needs, the error is
    recorded and the phase reads "not measured (needs 2+ cards)"."""
    res = _ranks_failed(out, "fsdp_ranks")
    if res is None:
        res = check_fsdp_ranks(out, dev)
        log("[fsdp_ranks] " + json.dumps(res))
    return res


def phase_fsdp_ranks_agree(out: dict) -> dict:
    """[fsdp_ranks_agree] from the same world (``check_fsdp_agree``), the
    refusal handled as in [fsdp_ranks]."""
    res = _ranks_failed(out, "fsdp_ranks_agree")
    if res is None:
        res = check_fsdp_agree(out)
        log("[fsdp_ranks_agree] " + json.dumps(res))
    return res


def _leaf_piece_mix(dev, piece) -> dict:
    """``gossip_mix_1d`` on a copy of one leaf piece, viewed ``(1, -1)``,
    at alpha 0.5 against a seeded partner of its dtype, against
    ``gossip_mix_plain`` on the same inputs, bit for bit; its launches
    counted alone (these are not the path's)."""
    from repro_torch.kernels import gossip_mix_1d, gossip_mix_plain
    a = piece.detach().reshape(1, -1)
    gen = torch.Generator(device=a.device).manual_seed(5)
    b = torch.randn(a.shape, generator=gen, device=a.device).to(a.dtype)
    want = gossip_mix_plain(a, b, GOSSIP_ALPHA)
    _reset_counts()
    got = gossip_mix_1d(a.clone(), b, GOSSIP_ALPHA)
    _sync(dev)
    return {"elements": a.numel(), "launches": _counts()["gossip_mix"],
            "equal": bool(torch.equal(got, want)),
            "max_abs_err": _diff(got, want)}


def _leaf_rank_train(group, dist, dev, spec) -> dict:
    """[leaf_ranks] on this rank: the per-leaf engine (``mix_impl=
    gossip_mix_1d``; at dp 1 no mix runs) on its pieces
    (``_rank_window``), against the padded pieces' bytes; then the kernel
    on its largest piece against the plain version."""
    from repro_torch.kernels import gossip_mix_1d
    from repro_torch.tree import tree_flatten
    cfg = _rank_cfg(spec)
    bundle, tr = _rank_trainer(cfg, spec, dist, dev, group, packed=False,
                               mix_impl=gossip_mix_1d)
    pieces = bundle.pieces
    assert bundle.layout is None and pieces.num_shards == group.num_shards
    leaves = tree_flatten(tr.state["params"])[0]
    assert all(tuple(x.shape) == (1,) + pieces.piece_shape(i, group.shard)
               for i, x in enumerate(leaves))
    sizes = [pieces.piece_len(i) * getattr(torch, dt).itemsize
             for i, dt in enumerate(pieces.leaf_dtypes)]
    replica = sum(math.prod(shp) * getattr(torch, dt).itemsize
                  for shp, dt in zip(pieces.leaf_shapes, pieces.leaf_dtypes))
    rec = {**_rank_record(group, cfg, spec, replica),
           **_rank_window(tr, group, dev, spec["steps"]),
           "leaves": len(leaves),
           "piece_elements": sum(x.numel() for x in leaves),
           "expected_launches": dict.fromkeys(KERNELS, 0),
           "count_per_step_padded": {
               "all-gather_bytes": (group.num_shards - 1) * sum(sizes),
               "reduce-scatter_bytes": (group.batch_shards - 1)
               * sum(sizes)}}
    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    rec["mix"] = _leaf_piece_mix(dev, leaves[big])
    rec["mix"]["leaf"] = big
    del tr, bundle, leaves
    _free_device(dev)
    return rec


def _leaf_rank_agree(group, dist, dev, spec) -> tuple:
    """[leaf_ranks_agree] on this rank: per optimizer the reduced run's
    losses and gathered leaves (lars: its trust ratios); after sgd its
    pieces, a checkpoint of the ranks, and the stacked run's checkpoint
    restored into a fresh rank state."""
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.tree import tree_flatten
    cfg = _rank_cfg(spec)
    rec, arrays = {}, {}
    for name in spec["optimizers"]:
        with _trust_seen() as trust:
            bundle, tr = _rank_trainer(cfg, spec, dist, dev, group,
                                       packed=False, optimizer=name)
            hist = tr.run(spec["steps"])
        rec[name] = {"losses": [h["loss"] for h in hist], "trust": trust}
        with torch.no_grad():
            whole = bundle.pieces.gather_pieces(tr.state["params"], group)
        for i, x in enumerate(tree_flatten(whole)[0]):
            arrays[f"{name}/leaf{i}"] = x.float().cpu().numpy()
        if name == "sgd":
            for i, x in enumerate(tree_flatten(tr.state["params"])[0]):
                arrays[f"piece{i}"] = x.detach().cpu().numpy()
            save_state(spec["rank_ckpt"], tr.state, step=spec["steps"],
                       group=group, pieces=bundle.pieces)
            _, fresh = _rank_trainer(cfg, spec, dist, dev, group,
                                     packed=False)
            restored, _ = restore_state(spec["stacked_ckpt"], fresh.state,
                                        group, bundle.pieces)
            for i, x in enumerate(tree_flatten(restored["params"])[0]):
                arrays[f"restored{i}"] = x.detach().cpu().numpy()
    return rec, arrays


@contextlib.contextmanager
def _trust_seen():
    """Every trust ratio lars computes while the block runs, as floats."""
    import repro_torch.optim.optimizers as O
    real, seen = O._trust, []

    def rec(wn, gn, **kw):
        t = real(wn, gn, **kw)
        seen.append(float(t))
        return t
    O._trust = rec
    try:
        yield seen
    finally:
        O._trust = real


def leaf_ranks_run(dev, *, ranks=LEAF_RANKS, agree=LEAF_AGREE) -> dict:
    """The body of [leaf_ranks] and [leaf_ranks_agree]: the stacked
    per-leaf runs of ``agree`` on ``dev`` (per optimizer its losses,
    leaves and lars's trust ratios; sgd's checkpoint), then one gloo world
    of ``prod(mesh)`` processes, each running ``ranks`` and then
    ``agree``, then the ranks' checkpoint restored into a fresh stacked
    state. Returns the ranks' records and arrays, the stacked runs' (and
    the params sgd's file holds), the ranks' file restored and the plan's
    piece table."""
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.train.step import _build_packed_layout
    from repro_torch.tree import tree_flatten
    world = int(np.prod(ranks["mesh"]))
    dist = _plan(*agree["mesh"], "fsdp")
    cfg = _rank_cfg(agree)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="leaf_ranks_", dir=ROOT / "build"))
    try:
        agree = dict(agree, rank_ckpt=str(tmp / "rank_ckpt"),
                     stacked_ckpt=str(tmp / "stacked_ckpt"))
        stacked = {}
        for name in agree["optimizers"]:
            with _trust_seen() as trust:
                _, tr = _rank_trainer(cfg, agree, dist, dev, None,
                                      packed=False, optimizer=name)
                hist = tr.run(agree["steps"])
            stacked[name] = {"losses": [h["loss"] for h in hist],
                             "trust": trust,
                             "leaves": [x.float().cpu().numpy() for x in
                                        _leaf_view(tr.state["params"])]}
            if name == "sgd":
                save_state(agree["stacked_ckpt"], tr.state,
                           step=agree["steps"])
                saved = [x.cpu() for x in _leaf_view(tr.state["params"])]
        _, fresh = _rank_trainer(cfg, agree, dist, dev, None, packed=False)
        del tr
        _free_device(dev)
        out = {"stacked": stacked, "world": world,
               "mesh": list(ranks["mesh"]), "stacked_sgd_params": saved,
               "pieces": _build_packed_layout(dist, cfg),
               "ranks": _spawn_ranks(dev, world, dict(
                   kind="leaf", ranks=ranks, agree=agree), tmp)}
        if not any("error" in r for r, _ in out["ranks"]):
            state, _ = restore_state(agree["rank_ckpt"], fresh.state)
            out["rank_file_in_stacked"] = [
                x.detach().cpu() for x in tree_flatten(state["params"])[0]]
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_leaf_ranks(out: dict, dev) -> dict:
    """[leaf_ranks]'s record from ``leaf_ranks_run`` (``_check_ranks``: no
    launch on the path at dp 1, where the per-leaf sgd step has no kernel
    and no mix runs), the pieces' sizes, and the kernel on each rank's
    largest piece, asserted bit-equal (one launch on the card, none off
    it)."""
    recs, res = _check_ranks(out, dev)
    res.update(engine="per-leaf", leaves=recs[0]["leaves"],
               piece_elements_by_rank=[r["piece_elements"] for r in recs],
               mix_by_rank=[r["mix"] for r in recs],
               count_equals_padded=all(
                   res["count_per_step"][k] == res["count_per_step_padded"][k]
                   for k in ("all-gather_bytes", "reduce-scatter_bytes")))
    for r in recs:
        assert r["mix"]["equal"], r["mix"]
        assert r["mix"]["launches"] == (1 if _on_card(dev) else 0), r["mix"]
    return res


def check_leaf_agree(out: dict) -> dict:
    """[leaf_ranks_agree]'s record: per optimizer the ranks' losses and
    gathered leaves against the stacked per-leaf run's within rtol = atol
    = 2e-4, lars's trust ratios within rtol 2e-6; the ranks' file
    restored in the stacked run holds every rank's pieces bit for bit, and
    the stacked file restored in the ranks is the stacked leaves'
    pieces."""
    st, pieces = out["stacked"], out["pieces"]
    worst, res = {}, {}
    for name, want in st.items():
        worst[name] = 0.0
        for rec, arr in out["ranks"]:
            got = rec["agree"][name]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=2e-4, atol=2e-4)
            if want["trust"]:
                np.testing.assert_allclose(got["trust"], want["trust"],
                                           rtol=2e-6)
            for i, w in enumerate(want["leaves"]):
                g = arr[f"{name}/leaf{i}"]
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
                worst[name] = max(worst[name], float(np.abs(g - w).max()))
        res[name] = {"losses_stacked": want["losses"],
                     "losses_ranks": out["ranks"][0][0]["agree"][name][
                         "losses"], "max_abs_diff_params": worst[name],
                     "trust_ratios": len(want["trust"])}

    def cut(leaf, i, s):
        return pieces.piece(leaf, i, s).numpy()
    same_rank_file = all(
        np.array_equal(arr[f"piece{i}"],
                       cut(x, i, rec["ranks"]["shard"]))
        for rec, arr in out["ranks"]
        for i, x in enumerate(out["rank_file_in_stacked"]))
    same_stacked_file = all(
        np.array_equal(arr[f"restored{i}"],
                       cut(x, i, rec["ranks"]["shard"]))
        for rec, arr in out["ranks"]
        for i, x in enumerate(out["stacked_sgd_params"]))
    res.update(rank_file_restores_in_stacked_bit_equal=same_rank_file,
               stacked_file_restores_in_ranks_bit_equal=same_stacked_file)
    assert same_rank_file and same_stacked_file, res
    return res


def phase_leaf_ranks(out: dict, dev) -> dict:
    """[leaf_ranks] from ``leaf_ranks_run``'s world (``check_leaf_ranks``),
    gloo's refusal of a CUDA collective recorded as in [fsdp_ranks]."""
    res = _ranks_failed(out, "leaf_ranks")
    if res is None:
        res = check_leaf_ranks(out, dev)
        log("[leaf_ranks] " + json.dumps(res))
    return res


def phase_leaf_ranks_agree(out: dict) -> dict:
    """[leaf_ranks_agree] from the same world (``check_leaf_agree``)."""
    res = _ranks_failed(out, "leaf_ranks_agree")
    if res is None:
        res = check_leaf_agree(out)
        log("[leaf_ranks_agree] " + json.dumps(res))
    return res


# ------------------------------ expert parallelism and serving on the ranks
# [moe_ranks]: jamba-v0.1-52b at full width (d 4096, 16 experts, top-2,
# d_ff 14,336, vocab 65,536, bf16) cut to 2 of 32 layers (layer 1 carries
# the MoE), fsdp on (1, 2, 2), 1 x 256 tokens a data position, per-leaf
# sgd(0.1, 0.9) at dp 1, 3 steps
MOE_RANKS = dict(mesh=(1, 2, 2), arch="jamba-v0.1-52b", layers=2, seq=SEQ,
                 per_position=1, steps=3, lr=0.1)
# [moe_ranks_agree]: reduced fp32 jamba on the same mesh, packed and
# per-leaf (remat off, on and save_moe_combine) against the stacked runs
MOE_AGREE = dict(mesh=(1, 2, 2), arch="jamba-v0.1-52b",
                 reduced=dict(d_model=64), seq=16, per_position=2, steps=3,
                 lr=AGREE_LR["sgd"], bucket_bytes=AGREE_BUCKET_BYTES)
MOE_AGREE_RUNS = (("leaf", False, {}), ("packed", True, {}),
                  ("leaf_remat", False, dict(remat=True)),
                  ("leaf_save", False, dict(remat=True,
                                            remat_policy="save_moe_combine")))
MOE_AGREE_TOL = 1e-5
# [serve_ranks]: the same full-width 2-layer jamba at JAMBA_SERVE's sizes
# (2 rows a rank), and reduced fp32 against the one-process engine
SERVE_RANKS = dict(mesh=(1, 2, 2), arch="jamba-v0.1-52b", layers=2,
                   **JAMBA_SERVE,
                   small=dict(reduced=dict(d_model=64), batch=4, prompt=12,
                              new=6, max_seq=32))
SERVE_RANKS_TOL = 1e-5
MOE_SLACK_GB = 2.0   # a rank's CUDA context and allocator slack


def _moe_counts(cfg, dist, group, pieces, spec, ep: bool,
                n_metrics: int) -> dict:
    """The bytes a per-leaf rank receives a step in each collective,
    counted from the leaf shapes: the non-expert pieces (every piece
    without expert parallelism) over the in-replica group, the expert
    pieces and the metrics' fp32 means over the batch group, every piece's
    gradient over the batch group, and per MoE layer the fp32 partial
    outputs forward and the token and slot-weight gradients backward over
    the model group."""
    from repro_torch.models.moe import moe_capacity
    from repro_torch.train.step import expert_dims
    dims = (expert_dims(cfg, dist, group) if ep else None) or (
        (None,) * pieces.num_leaves)
    size = [pieces.piece_len(i) * getattr(torch, dt).itemsize
            for i, dt in enumerate(pieces.leaf_dtypes)]
    expert = sum(n for n, d in zip(size, dims) if d is not None)
    rows, seq = spec["per_position"], spec["seq"]
    tokens = rows * seq * cfg.d_model
    sums = sum(4 * (2 * tokens + rows * b.moe.n_experts
                    * moe_capacity(seq, b.moe))
               for b in cfg.blocks if b.moe is not None)
    return {"all_gather": (group.num_shards - 1) * (sum(size) - expert),
            "batch_gather": (group.batch_shards - 1)
            * (expert + 4 * n_metrics),
            "reduce_scatter": (group.batch_shards - 1) * sum(size),
            "model_sum": (group.model_shards - 1) * sums if ep else 0}


def _expert_bytes(cfg) -> int:
    """The bytes of every expert leaf of one replica."""
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_flatten(lm_specs(cfg))[0]
               if "experts" in s.axes.split(","))


def _whole_fits(group, dev, cfg, ep_peak) -> str | None:
    """None when every rank can gather the experts whole on the shared
    card: the largest expert-parallel peak among the ranks plus the
    gathered experts and their gradients the rank did not hold, times the
    ranks, within the card's memory; else why not (an all-gather of the
    peaks, so that every rank decides alike)."""
    import torch.distributed as tdist
    if not _on_card(dev):
        return None
    peaks = [torch.zeros(1, dtype=torch.float64) for _ in
             range(group.world_size)]
    tdist.all_gather(peaks, torch.tensor([ep_peak], dtype=torch.float64))
    extra = 2 * _expert_bytes(cfg) * (1 - 1 / group.model_shards) / 1e9
    want = group.world_size * (max(float(p) for p in peaks) + extra
                               + MOE_SLACK_GB)
    have = torch.cuda.get_device_properties(0).total_memory / 1e9
    if want <= have:
        return None
    return (f"predicted {want:.1f} GB for {group.world_size} ranks with the "
            f"experts whole, the card has {have:.1f} GB")


def _no_model_group(group):
    """``group`` as if its model group were the rank alone: every expert
    gathered whole and run on every rank, the path without expert
    parallelism."""
    return dataclasses.replace(group, model=None, model_ranks=(group.rank,))


def _moe_rank_train(group, dist, dev, spec) -> dict:
    """[moe_ranks] on this rank: the per-leaf engine under expert
    parallelism (its ``E / M`` experts gathered over the batch group, the
    partial outputs summed over the model group), then the same steps with
    the experts gathered whole (``_no_model_group``, where the card holds
    the four ranks so): each a ``_rank_window``, its bytes against
    ``_moe_counts``, its model-group collectives counted."""
    from repro_torch.models import moe
    cfg = _rank_cfg(spec)
    E = max(b.moe.n_experts for b in cfg.blocks if b.moe is not None)
    rec = {"rank": group.rank, "shard": group.shard,
           "batch_index": group.batch_index,
           "model_index": group.model_index, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "dtype": cfg.param_dtype, "n_experts": E,
           "tokens_per_rank": spec["per_position"] * spec["seq"]}
    for tag, ep in (("ep", True), ("whole", False)):
        if not ep:
            why = _whole_fits(group, dev, cfg, rec["ep"]["peak_mem_gb"] or 0)
            if why is not None:
                rec[tag] = {"not_measured": why}
                continue
        bundle, tr = _rank_trainer(cfg, spec, dist, dev,
                                   group if ep else _no_model_group(group),
                                   packed=False)
        before = dict(moe.model_collectives)
        win = _rank_window(tr, group, dev, spec["steps"])
        n_metrics = len([k for k in tr.history[0] if k != "step"])
        win.update(
            first_loss=tr.history[0]["loss"],
            experts_a_rank=E // group.model_shards if ep else E,
            model_collectives_per_step={
                k: (v - before[k]) / spec["steps"]
                for k, v in moe.model_collectives.items()},
            count_per_step=_moe_counts(cfg, dist, group, bundle.pieces, spec,
                                       ep, n_metrics),
            collective_share=sum(win["collective_ms_per_step"].values())
            / win["ms_per_step"])
        rec[tag] = win
        del tr, bundle
        _free_device(dev)
    return rec


def _moe_rank_agree(group, dist, dev, spec) -> tuple:
    """[moe_ranks_agree] on this rank: reduced fp32 jamba, 3 steps of each
    of ``MOE_AGREE_RUNS``: the losses, the gathered params and the
    model-group collectives of the second step."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_flatten
    cfg = _rank_cfg(spec)
    rec, arrays = {}, {}
    with _bucket_bytes(spec["bucket_bytes"]):
        for tag, packed, kw in MOE_AGREE_RUNS:
            bundle, tr = _rank_trainer(cfg, spec, dist, dev, group,
                                       packed=packed, **kw)
            tr.run(1)
            before = dict(moe.model_collectives)
            tr.run(1, start_step=1)
            per_step = {k: v - before[k]
                        for k, v in moe.model_collectives.items()}
            tr.run(spec["steps"] - 2, start_step=2)
            rec[tag] = {"losses": [h["loss"] for h in tr.history],
                        "model_collectives_per_step": per_step}
            with torch.no_grad():
                whole = (tr.state["params"].unpack() if packed else
                         bundle.pieces.gather_pieces(tr.state["params"],
                                                     group))
            for i, x in enumerate(tree_flatten(whole)[0]):
                arrays[f"moe/{tag}/leaf{i}"] = x.float().cpu().numpy()
            del tr, bundle, whole
    return rec, arrays


def _serve_prompts(cfg, sizes):
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (sizes["batch"], sizes["prompt"])).astype(np.int32)


def _serve_loop(dev, params, prefill, decode, cache, toks, sizes,
                keep_logits: bool, events: bool = False) -> tuple:
    """Prefill timed (the first call apart, the median of 3 more), then
    ``new`` greedy decode steps timed on the host clock (the device
    synchronized around each), with ``events`` on the card by CUDA events
    around each step (the host clock's median kept beside them); the
    prefill's logits (and with ``keep_logits`` every decode step's), fp32
    on the host."""
    pre = []
    for _ in range(4):
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cache, toks)
        _sync(dev)
        pre.append((time.perf_counter() - t0) * 1e3)
    kept = [logits.float().cpu().numpy()]
    tok = logits.argmax(-1)
    pos = torch.full((), sizes["prompt"], dtype=torch.int64, device=dev)
    steps, host = [], []
    use_events = events and _on_card(dev)
    for t in range(sizes["new"]):
        _sync(dev)
        t0 = time.perf_counter()
        if use_events:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        logits, cache = decode(params, cache, tok, pos + t)
        tok = logits.argmax(-1)
        if use_events:
            ev[1].record()
        _sync(dev)
        host.append((time.perf_counter() - t0) * 1e3)
        steps.append(ev[0].elapsed_time(ev[1]) if use_events else host[-1])
        if keep_logits:
            kept.append(logits.float().cpu().numpy())
    timed = {"prefill_first_ms": pre[0],
             "prefill_ms": statistics.median(pre[1:]),
             "decode_ms_per_token": statistics.median(steps),
             "decode_ms_min_max": [min(steps), max(steps)]}
    if use_events:
        timed["decode_host_ms_per_token"] = statistics.median(host)
    return timed, kept


def _serve_rank(group, dist, dev, spec) -> tuple:
    """[serve_ranks] on this rank, full width and then reduced fp32: its
    pieces of the seeded weights (``serve_pieces``) gathered once into
    ``ServingEngine(dist=, group=)`` (bytes and seconds, against the
    pieces' count), ``generate`` (the global greedy tokens), then the
    serve steps over the group timed (``_serve_loop``) and the peak."""
    from repro_torch.models import lm_axes, lm_cache_init, lm_init
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                        serve_pieces)
    from repro_torch.train.step import expert_dims
    from repro_torch.tree import tree_flatten
    rec, arrays = {}, {}
    for tag, sizes in (("full", spec), ("small", spec["small"])):
        cfg = _rank_cfg(dict(spec, reduced=sizes.get("reduced")))
        table = serve_pieces(cfg, dist)
        _reset_peak(dev)
        pieces = table.cut_pieces(lm_init(cfg, seed=0, device=dev),
                                  group.shard)
        _free_device(dev)
        with _traffic(group, dev) as (moved, coll_ms):
            _sync(dev)
            t0 = time.perf_counter()
            engine = ServingEngine(cfg, pieces, sizes["max_seq"], device=dev,
                                   dist=dist, group=group)
            _sync(dev)
            gather_ms = (time.perf_counter() - t0) * 1e3
        del pieces
        dims = expert_dims(cfg, dist, group)
        size = [table.piece_len(i) * getattr(torch, dt).itemsize
                for i, dt in enumerate(table.leaf_dtypes)]
        expert = sum(n for n, d in zip(size, dims) if d is not None)
        prompts = _serve_prompts(cfg, sizes)
        rows = sizes["batch"] // group.batch_shards
        with torch.inference_mode():
            out = engine.generate(prompts, sizes["new"])
            cache = lm_cache_init(cfg, rows, sizes["max_seq"], device=dev)
            kw = dict(param_shapes=engine.params, param_axes=lm_axes(cfg),
                      cache_shapes=cache, group=group)
            timed, logits = _serve_loop(
                dev, engine.params,
                make_prefill_step(cfg, dist, **kw).step_fn,
                make_decode_step(cfg, dist, **kw).step_fn, cache,
                torch.as_tensor(prompts, dtype=torch.int64).to(dev), sizes,
                keep_logits=tag == "small")
        rec[tag] = dict(
            timed, rows_a_rank=rows, batch=sizes["batch"],
            prompt=sizes["prompt"], new_tokens=sizes["new"],
            max_seq=sizes["max_seq"], layers=cfg.n_layers,
            d_model=cfg.d_model, dtype=cfg.param_dtype,
            weight_gather_ms=gather_ms,
            weight_gather_bytes={k: moved[k] for k in ("all_gather",
                                                       "batch_gather")},
            weight_gather_count={
                "all_gather": (group.num_shards - 1) * (sum(size) - expert),
                "batch_gather": (group.batch_shards - 1) * expert},
            weight_gather_collective_ms=sum(coll_ms.values()),
            serving_weights_gb=_tree_bytes(engine.params) / 1e9,
            experts_a_rank=sorted({int(x.shape[d]) for x, d in zip(
                tree_flatten(engine.params)[0], dims) if d is not None}),
            peak_mem_gb=_peak_gb(dev))
        arrays[f"serve/{tag}/tokens"] = out
        for i, x in enumerate(logits):
            arrays[f"serve/{tag}/logits{i}"] = x
        del engine, cache
        _free_device(dev)
    return rec, arrays


def _serve_one(cfg, dev, sizes, keep_logits: bool) -> dict:
    """The one-process ``ServingEngine`` on the same seeded weights: its
    greedy tokens, and the prefill's (and with ``keep_logits`` every
    decode step's) logits from ``lm_prefill`` / ``lm_decode``."""
    from repro_torch.models import lm_cache_init, lm_decode, lm_init, lm_prefill
    from repro_torch.serve import ServingEngine
    engine = ServingEngine(cfg, lm_init(cfg, seed=0, device=dev),
                           sizes["max_seq"], device=dev)
    prompts = _serve_prompts(cfg, sizes)
    with torch.inference_mode():
        out = engine.generate(prompts, sizes["new"])
        cache = lm_cache_init(cfg, sizes["batch"], sizes["max_seq"],
                              device=dev)
        _, logits = _serve_loop(
            dev, engine.params,
            lambda p, c, t: lm_prefill(p, cfg, t, c),
            lambda p, c, t, pos: lm_decode(p, cfg, t, c, pos), cache,
            torch.as_tensor(prompts, dtype=torch.int64).to(dev), sizes,
            keep_logits)
    del engine, cache
    _free_device(dev)
    return {"tokens": out, "logits": logits}


def moe_ranks_run(dev, *, ranks=MOE_RANKS, agree=MOE_AGREE,
                  serve=SERVE_RANKS) -> dict:
    """The body of [moe_ranks], [moe_ranks_agree] and [serve_ranks]: the
    stacked reduced runs of ``agree`` on ``dev`` (packed and per-leaf:
    losses and leaves) and the one-process engine on ``serve``'s weights
    (full width and reduced), then one gloo world of ``prod(mesh)``
    processes, each running ``ranks``, ``agree`` and ``serve``. Returns
    the ranks' records and arrays and this process's runs."""
    world = int(np.prod(ranks["mesh"]))
    dist = _plan(*agree["mesh"], "fsdp")
    cfg = _rank_cfg(agree)
    stacked = {}
    with _bucket_bytes(agree["bucket_bytes"]):
        for tag, packed in (("leaf", False), ("packed", True)):
            _, tr = _rank_trainer(cfg, agree, dist, dev, None, packed=packed)
            stacked[tag] = {
                "losses": [h["loss"] for h in tr.run(agree["steps"])],
                "leaves": [x.float().cpu().numpy()
                           for x in _leaf_view(tr.state["params"])]}
            del tr
    _free_device(dev)
    one = {tag: _serve_one(_rank_cfg(dict(serve, reduced=s.get("reduced"))),
                           dev, s, keep_logits=tag == "small")
           for tag, s in (("full", serve), ("small", serve["small"]))}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="moe_ranks_", dir=ROOT / "build"))
    try:
        return {"stacked": stacked, "one": one, "world": world,
                "mesh": list(ranks["mesh"]),
                "ranks": _spawn_ranks(dev, world, dict(
                    kind="moe", ranks=ranks, agree=agree, serve=serve), tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_moe_ranks(out: dict, dev) -> dict:
    """[moe_ranks]'s record: per rank its experts (``E / M``), and for the
    expert-parallel run and the whole-expert run the bytes of each
    collective a step (asserted equal to ``_moe_counts``), their ms, the
    collectives' share of ms/step, the peak, no kernel launched; one
    replica-mean loss on every rank, the first within 1 of ln(vocab)."""
    recs = [r["ranks"] for r, _ in out["ranks"]]
    r0 = recs[0]
    for r in recs:
        assert r["ep"]["experts_a_rank"] == r["n_experts"] // 2, r["ep"]
        for tag in ("ep", "whole"):
            w = r[tag]
            if "not_measured" in w:
                continue
            for key, n in w["count_per_step"].items():
                assert w["bytes_per_step"][key] == n, (tag, key, w)
            assert w["launches"] == dict.fromkeys(KERNELS, 0), w["launches"]
            assert w["losses"] == r0[tag]["losses"], "one replica mean"
            assert math.isfinite(w["first_loss"]), w
            assert abs(w["first_loss"] - math.log(r["vocab"])) <= 1.0, w
    res = {"world": out["world"], "mesh": out["mesh"], "dist_mode": "fsdp",
           "engine": "per-leaf", "backend": "gloo", "layers": r0["layers"],
           "d_model": r0["d_model"], "vocab": r0["vocab"],
           "dtype": r0["dtype"], "n_experts": r0["n_experts"],
           "tokens_per_rank": r0["tokens_per_rank"],
           "model_index_by_rank": [r["model_index"] for r in recs]}
    for tag in ("ep", "whole"):
        if "not_measured" in r0[tag]:
            res[tag] = r0[tag]
            continue
        res[tag] = {
            "experts_a_rank": r0[tag]["experts_a_rank"],
            "first_loss": r0[tag]["first_loss"],
            "losses_window": r0[tag]["losses"],
            "ms_per_step_by_rank": [r[tag]["ms_per_step"] for r in recs],
            "first_step_ms_by_rank": [r[tag]["first_step_ms"] for r in recs],
            "collective_share_by_rank": [r[tag]["collective_share"]
                                         for r in recs],
            "bytes_per_step_by_rank": [r[tag]["bytes_per_step"]
                                       for r in recs],
            "count_per_step_by_rank": [r[tag]["count_per_step"]
                                       for r in recs],
            "collective_ms_per_step_by_rank": [
                r[tag]["collective_ms_per_step"] for r in recs],
            "model_collectives_per_step_by_rank": [
                r[tag]["model_collectives_per_step"] for r in recs],
            "peak_mem_gb_by_rank": [r[tag]["peak_mem_gb"] for r in recs]}
    return res


def check_moe_agree(out: dict) -> dict:
    """[moe_ranks_agree]'s record: the ranks' per-leaf and packed losses
    and gathered params against the stacked runs (the whole experts on
    every row) within ``MOE_AGREE_TOL``; remat on and
    ``save_moe_combine`` equal to remat off bit for bit; the model-group
    collectives of one step under each."""
    st = out["stacked"]
    worst = {}
    for rec, arr in out["ranks"]:
        got = rec["agree"]
        for tag, packed, _ in MOE_AGREE_RUNS:
            want = st["packed" if packed else "leaf"]
            np.testing.assert_allclose(got[tag]["losses"], want["losses"],
                                       rtol=MOE_AGREE_TOL, atol=MOE_AGREE_TOL)
            for i, w in enumerate(want["leaves"]):
                g = arr[f"moe/{tag}/leaf{i}"]
                np.testing.assert_allclose(g, w, rtol=MOE_AGREE_TOL,
                                           atol=MOE_AGREE_TOL)
                worst[tag] = max(worst.get(tag, 0.0),
                                 float(np.abs(g - w).max()))
        for tag in ("leaf_remat", "leaf_save"):
            assert got[tag]["losses"] == got["leaf"]["losses"], tag
            assert all(np.array_equal(arr[f"moe/{tag}/leaf{i}"],
                                      arr[f"moe/leaf/leaf{i}"])
                       for i in range(len(st["leaf"]["leaves"]))), tag
    r0 = out["ranks"][0][0]["agree"]
    return {"losses_stacked": {k: v["losses"] for k, v in st.items()},
            "losses_ranks": {k: v["losses"] for k, v in r0.items()},
            "max_abs_diff_params": worst,
            "remat_bit_equal": True,
            "model_collectives_per_step": {
                k: v["model_collectives_per_step"] for k, v in r0.items()}}


def check_serve_ranks(out: dict, dev) -> dict:
    """[serve_ranks]'s record: every rank's weight gather equal to the
    pieces' count and its ``E / M`` experts, every rank's tokens the same;
    full width: the first-token logits' largest difference from the
    one-process engine's and how many greedy tokens agree (EP's fp32
    boundary rounds bf16 otherwise); reduced fp32: tokens equal and the
    prefill and decode logits within ``SERVE_RANKS_TOL``."""
    recs = [(r["serve"], arr) for r, arr in out["ranks"]]
    res = {"world": out["world"], "mesh": out["mesh"]}
    for tag in ("full", "small"):
        one = out["one"][tag]
        r0, a0 = recs[0]
        for r, arr in recs:
            rec = r[tag]
            assert rec["weight_gather_bytes"] == rec["weight_gather_count"], \
                rec
            assert np.array_equal(arr[f"serve/{tag}/tokens"],
                                  a0[f"serve/{tag}/tokens"]), "every rank"
        got, want = a0[f"serve/{tag}/tokens"], one["tokens"]
        first = a0[f"serve/{tag}/logits0"]
        assert first.shape == one["logits"][0].shape
        assert np.isfinite(first).all()
        row = {k: r0[tag][k] for k in (
            "batch", "rows_a_rank", "prompt", "new_tokens", "max_seq",
            "layers", "d_model", "dtype", "experts_a_rank",
            "serving_weights_gb", "weight_gather_bytes",
            "weight_gather_ms", "weight_gather_collective_ms")}
        row.update(
            prefill_ms_by_rank=[r[tag]["prefill_ms"] for r, _ in recs],
            prefill_first_ms=r0[tag]["prefill_first_ms"],
            decode_ms_per_token_by_rank=[r[tag]["decode_ms_per_token"]
                                         for r, _ in recs],
            decode_ms_min_max=r0[tag]["decode_ms_min_max"],
            peak_mem_gb_by_rank=[r[tag]["peak_mem_gb"] for r, _ in recs],
            first_token_logits_max_abs_diff=_np_diff(first,
                                                     one["logits"][0]),
            greedy_tokens_equal=int((got == want).sum()),
            greedy_tokens=int(want.size))
        if tag == "small":
            assert np.array_equal(got, want), (got, want)
            for i, w in enumerate(one["logits"]):
                np.testing.assert_allclose(a0[f"serve/{tag}/logits{i}"], w,
                                           rtol=SERVE_RANKS_TOL,
                                           atol=SERVE_RANKS_TOL)
            row["logits_max_abs_diff"] = max(
                _np_diff(a0[f"serve/{tag}/logits{i}"], w)
                for i, w in enumerate(one["logits"]))
        res[tag] = row
    return res


def _np_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def phase_moe_ranks(out: dict, dev) -> dict:
    """[moe_ranks] from ``moe_ranks_run``'s world (``check_moe_ranks``),
    gloo's refusal of a CUDA collective recorded as in [fsdp_ranks]."""
    res = _ranks_failed(out, "moe_ranks")
    if res is None:
        res = check_moe_ranks(out, dev)
        log("[moe_ranks] " + json.dumps(res))
    return res


def phase_moe_ranks_agree(out: dict) -> dict:
    """[moe_ranks_agree] from the same world (``check_moe_agree``)."""
    res = _ranks_failed(out, "moe_ranks_agree")
    if res is None:
        res = check_moe_agree(out)
        log("[moe_ranks_agree] " + json.dumps(res))
    return res


def phase_serve_ranks(out: dict, dev) -> dict:
    """[serve_ranks] from the same world (``check_serve_ranks``)."""
    res = _ranks_failed(out, "serve_ranks")
    if res is None:
        res = check_serve_ranks(out, dev)
        log("[serve_ranks] " + json.dumps(res))
    return res


# ------------------------------------- the sequence-parallel decode cache
# [serve_seq_ranks]: batch 1 served over the same four gloo ranks of the
# (1, 2, 2) fsdp mesh (the batch does not split over the batch group, so
# each rank holds its stretch of every attention / MLA leaf and the
# decode attention combines the ranks' partial softmaxes): qwen3-0.6b at
# full width and depth with decode_32k's cache and as long_500k's
# windowed variant (``launch.specs.resolve_config``: window 8,192),
# prompt 4,096; deepseek-v3 at full width cut to its 3 dense MLA layers,
# prompt 1,024; 32 new tokens each. Each with its reduced fp32 twin
# against the one-process engine (``small``; the windowed twin's 16-slot
# ring wraps).
SEQ_SMALL = dict(reduced=dict(d_model=64), prompt=12, new=6, max_seq=32)
SERVE_SEQ_RANKS = dict(mesh=(1, 2, 2), runs=(
    dict(tag="qwen3_decode_32k", arch="qwen3-0.6b", batch=1, prompt=4096,
         new=32, max_seq=32768, small=SEQ_SMALL),
    dict(tag="qwen3_long_500k", arch="qwen3-0.6b", shape="long_500k",
         batch=1, prompt=4096, new=32, max_seq=524288,
         small=dict(SEQ_SMALL, window=16)),
    dict(tag="deepseek_v3", arch="deepseek-v3-671b", layers=3, batch=1,
         prompt=1024, new=32, max_seq=32768, small=SEQ_SMALL)))


def _seq_cfg(run):
    """The model of a [serve_seq_ranks] run: ``arch`` as
    ``resolve_config`` specializes it for ``shape`` (default decode_32k),
    cut to its first ``layers``; with ``reduced`` the reduced fp32 model
    instead, windowed to ``window`` where given; fsdp mode."""
    from repro_torch.configs import get_config, with_sliding_window
    from repro_torch.launch.specs import resolve_config
    from repro_torch.models import reduced
    if run.get("reduced"):
        cfg = dataclasses.replace(reduced(get_config(run["arch"]),
                                          **run["reduced"]),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        if run.get("window"):
            cfg = with_sliding_window(cfg, run["window"])
    else:
        cfg = resolve_config(run["arch"], run.get("shape", "decode_32k"))[0]
        if run.get("layers"):
            cfg = _depth(cfg, run["layers"])
    return dataclasses.replace(cfg, dist_mode="fsdp")


def _seq_sizes(run):
    """(tag, sizes) of a run at full width and of its reduced twin."""
    return ((run["tag"], run),
            (run["tag"] + "/small", dict(run, **run["small"])))


def _combine_count(cfg, seq, batch: int) -> int:
    """The bytes a rank receives a decode step in the sequence-parallel
    combine, from the shapes: per split attention layer one all-gather of
    the fp32 ``(m, l, o)`` of every row from each other member of the
    batch group, ``(H * d_v + 2 H) * 4`` bytes a row (MLA: ``d_v`` is
    the latent's ``kv_lora_rank``)."""
    from repro_torch.models.attention import cache_len
    per = 0
    for b in cfg.blocks:
        if b.kind == "attn" and not b.attn.cross:
            H, dv, window = b.attn.n_heads, b.attn.head_dim, b.attn.window
        elif b.kind == "mla":
            H, dv, window = b.mla.n_heads, b.mla.kv_lora_rank, b.mla.window
        else:
            continue
        if cache_len(seq.max_seq, window) in seq.split:
            per += (H * dv + 2 * H) * 4
    return (seq.n - 1) * batch * per


def _serve_seq_rank(group, dist, dev, spec) -> tuple:
    """[serve_seq_ranks] on this rank, every run at full width and then
    reduced fp32: its pieces of the seeded weights gathered once into
    ``ServingEngine(dist=, group=)``, ``generate`` (the global greedy
    tokens; the bytes its combine receives a token, against
    ``_combine_count``, and the host ms of its all-gathers, the device
    synchronized around each), then the serve steps on
    ``rank_cache_init``'s cache timed (``_serve_loop``, CUDA events a
    decode step), the cache's bytes against the whole cache's, the
    serving peak, the launches (no kernel serves)."""
    from repro_torch.models import lm_axes, lm_cache_init, lm_init
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                        rank_cache_init, seq_shards,
                                        serve_pieces)
    rec, arrays = {}, {}
    for run in spec["runs"]:
        for tag, sizes in _seq_sizes(run):
            cfg = _seq_cfg(sizes)
            B, max_seq = sizes["batch"], sizes["max_seq"]
            _reset_peak(dev)
            pieces = serve_pieces(cfg, dist).cut_pieces(
                lm_init(cfg, seed=0, device=dev), group.shard)
            _free_device(dev)
            engine = ServingEngine(cfg, pieces, max_seq, device=dev,
                                   dist=dist, group=group)
            del pieces
            load_peak = _peak_gb(dev)
            _free_device(dev)
            _reset_peak(dev)
            _reset_counts()
            prompts = _serve_prompts(cfg, sizes)
            with _traffic(group, dev) as (moved, coll_ms):
                out = engine.generate(prompts, sizes["new"])
            seq = seq_shards(cfg, dist, group, B, max_seq)
            with torch.inference_mode():
                cache = rank_cache_init(cfg, dist, group, B, max_seq,
                                        device=dev)
                kw = dict(param_shapes=engine.params,
                          param_axes=lm_axes(cfg), cache_shapes=cache,
                          group=group, max_seq=max_seq)
                timed, logits = _serve_loop(
                    dev, engine.params,
                    make_prefill_step(cfg, dist, **kw).step_fn,
                    make_decode_step(cfg, dist, **kw).step_fn, cache,
                    torch.as_tensor(prompts, dtype=torch.int64).to(dev),
                    sizes, keep_logits=tag.endswith("/small"), events=True)
            rec[tag] = dict(
                timed, batch=B, prompt=sizes["prompt"],
                new_tokens=sizes["new"], max_seq=max_seq,
                layers=cfg.n_layers, d_model=cfg.d_model,
                dtype=cfg.param_dtype, split_lengths=sorted(seq.split),
                cache_bytes_rank=_tree_bytes(cache),
                cache_bytes_whole=_tree_bytes(lm_cache_init(
                    cfg, B, max_seq, device="meta")),
                combine_bytes_per_token=moved["batch_gather"]
                / sizes["new"],
                combine_count_per_token=_combine_count(cfg, seq, B),
                combine_ms_per_token=coll_ms["batch_gather"] / sizes["new"],
                other_bytes=sum(v for k, v in moved.items()
                                if k != "batch_gather"),
                serving_weights_gb=_tree_bytes(engine.params) / 1e9,
                load_peak_gb=load_peak, peak_mem_gb=_peak_gb(dev),
                launches=_counts())
            arrays[f"seq/{tag}/tokens"] = out
            for i, x in enumerate(logits):
                arrays[f"seq/{tag}/logits{i}"] = x
            del engine, cache, kw
            _free_device(dev)
    return rec, arrays


def seq_ranks_run(dev, *, serve=SERVE_SEQ_RANKS) -> dict:
    """The body of [serve_seq_ranks]: the one-process engine on every
    run's seeded weights (full width and reduced), then one gloo world of
    ``prod(mesh)`` processes serving them over the sequence-parallel
    cache. Returns the ranks' records and arrays and this process's
    runs."""
    one = {}
    for run in serve["runs"]:
        for tag, sizes in _seq_sizes(run):
            one[tag] = _serve_one(_seq_cfg(sizes), dev, sizes,
                                  keep_logits=tag.endswith("/small"))
    world = int(np.prod(serve["mesh"]))
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="seq_ranks_", dir=ROOT / "build"))
    try:
        return {"one": one, "world": world, "mesh": list(serve["mesh"]),
                "ranks": _spawn_ranks(dev, world, dict(
                    kind="seq", ranks=dict(mesh=serve["mesh"]), seq=serve),
                    tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_serve_seq_ranks(out: dict, dev) -> dict:
    """[serve_seq_ranks]'s record: on every rank the same tokens and the
    same first-token logits bit for bit, finite, of the one-process
    shape; the rank's cache half the whole cache's bytes (every attention
    and MLA leaf split); the combine's bytes a token equal to
    ``_combine_count`` and no other collective while serving; no kernel
    launched. Full width: the first-token logits' largest difference from
    the one-process engine's and how many greedy tokens agree; reduced
    fp32: tokens equal and every step's logits within
    ``SERVE_RANKS_TOL``."""
    recs = [(r["seq"], arr) for r, arr in out["ranks"]]
    res = {"world": out["world"], "mesh": out["mesh"]}
    for tag, one in out["one"].items():
        r0, a0 = recs[0]
        for r, arr in recs:
            rec = r[tag]
            assert np.array_equal(arr[f"seq/{tag}/tokens"],
                                  a0[f"seq/{tag}/tokens"]), "every rank"
            assert np.array_equal(arr[f"seq/{tag}/logits0"],
                                  a0[f"seq/{tag}/logits0"]), "bit-equal"
            assert 2 * rec["cache_bytes_rank"] == rec["cache_bytes_whole"], \
                rec
            assert rec["combine_bytes_per_token"] == \
                rec["combine_count_per_token"] > 0, rec
            assert rec["other_bytes"] == 0, rec
            assert rec["launches"] == dict.fromkeys(KERNELS, 0), rec
        got, want = a0[f"seq/{tag}/tokens"], one["tokens"]
        first = a0[f"seq/{tag}/logits0"]
        assert first.shape == one["logits"][0].shape
        assert np.isfinite(first).all()
        row = {k: r0[tag][k] for k in (
            "batch", "prompt", "new_tokens", "max_seq", "layers", "d_model",
            "dtype", "split_lengths", "cache_bytes_rank",
            "cache_bytes_whole", "combine_bytes_per_token",
            "combine_count_per_token", "serving_weights_gb",
            "prefill_first_ms")}
        row["combine_ms_per_token_by_rank"] = [r[tag]["combine_ms_per_token"]
                                               for r, _ in recs]
        row.update(
            prefill_ms_by_rank=[r[tag]["prefill_ms"] for r, _ in recs],
            decode_ms_per_token_by_rank=[r[tag]["decode_ms_per_token"]
                                         for r, _ in recs],
            decode_ms_min_max=r0[tag]["decode_ms_min_max"],
            decode_host_ms_per_token=r0[tag].get(
                "decode_host_ms_per_token"),
            peak_mem_gb_by_rank=[r[tag]["peak_mem_gb"] for r, _ in recs],
            load_peak_gb_by_rank=[r[tag]["load_peak_gb"] for r, _ in recs],
            first_token_logits_max_abs_diff=_np_diff(first,
                                                     one["logits"][0]),
            greedy_tokens_equal=int((got == want).sum()),
            greedy_tokens=int(want.size))
        if tag.endswith("/small"):
            assert np.array_equal(got, want), (tag, got, want)
            for i, w in enumerate(one["logits"]):
                np.testing.assert_allclose(a0[f"seq/{tag}/logits{i}"], w,
                                           rtol=SERVE_RANKS_TOL,
                                           atol=SERVE_RANKS_TOL)
            row["logits_max_abs_diff"] = max(
                _np_diff(a0[f"seq/{tag}/logits{i}"], w)
                for i, w in enumerate(one["logits"]))
        res[tag] = row
    return res


def phase_serve_seq_ranks(dev) -> dict:
    """[serve_seq_ranks]: ``seq_ranks_run``'s world, checked
    (``check_serve_seq_ranks``); gloo's refusal of a CUDA collective is
    recorded as in [fsdp_ranks]."""
    out = seq_ranks_run(dev)
    res = _ranks_failed(out, "serve_seq_ranks")
    if res is None:
        res = check_serve_seq_ranks(out, dev)
        log("[serve_seq_ranks] " + json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import build_layout
    from repro_torch.models import lm_specs

    # deterministic cuBLAS for [mamba_remat]'s bit check; read when the
    # first cuBLAS handle is made, so before any product runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    failures = []
    seconds = {}   # wall seconds of each guarded phase, for the time limit

    def guard(name, fn, *args, **kw):
        """Run one phase; a failure is recorded and the next phase runs."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        except Exception:  # noqa: BLE001 - every phase failure is reported
            traceback.print_exc()
            log(f"[FAIL] {name}")
            failures.append(name)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return None
        finally:
            seconds[name] = round(time.perf_counter() - t0, 1)

    phase_build()
    cfg = get_config("qwen3-0.6b")
    short = dataclasses.replace(cfg, blocks=cfg.blocks[:SHORT_LAYERS])
    layout = build_layout(lm_specs(cfg))
    err = guard("check", phase_kernels, layout, dev) or {}
    err.update(guard("check_opt", phase_kernels_opt, layout, dev) or {})
    timing = guard("time", phase_time, layout, dev) or {}
    timing.update(guard("time_opt", phase_time_opt, layout, dev) or {})
    err.update(guard("check_ssm", phase_check_ssm, dev) or {})
    err.update(guard("check_attn", phase_check_attn, dev) or {})
    timing.update(guard("time_ssm", phase_time_ssm, dev) or {})
    timing.update(guard("time_attn", phase_time_attn, dev) or {})

    def none(**kw):
        return dict(dict.fromkeys(KERNELS, 0), **kw)

    main_res = guard(
        "main", run_path, "main", cfg, dev, fused=True, steps=MAIN_STEPS,
        profile=True, keep_params="cpu",
        expect=lambda b: none(fused_sgd=MAIN_STEPS * b.layout.num_buckets))
    # the shard-local layout: main's run on mesh (1, 4, 2), replica mode
    # (dp 4, each replica's leaves sharded over model in 2)
    hier_res = guard(
        "hier_main", run_path, "hier_main", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True, keep_params="cpu",
        dist=_plan(1, DP, 2, "replica"),
        expect=lambda b: none(fused_sgd=MAIN_STEPS * b.layout.num_buckets))
    if main_res is not None and hier_res is not None:
        guard("hier_main_gap", phase_hier_gap, main_res, hier_res)
    for res in (main_res, hier_res):
        if res is not None:
            res.pop("params", None)
    torch.cuda.empty_cache()
    if main_res is not None and hier_res is not None:
        log("[hier_main] against [main], one call: " + json.dumps(
            {k: {"ms_per_step": r["ms_per_step"],
                 "step_ms_unprofiled": r["profile"]["step_ms_unprofiled"],
                 "device_busy_ms": r["profile"]["device_busy_ms"],
                 "peak_mem_gb": r["peak_mem_gb"],
                 "cat_ms": r["profile"]["device_ms_by_kernel_name"][
                     "CatArrayBatchedCopy"]}
             for k, r in (("main", main_res), ("hier_main", hier_res))}))
    hier_fsdp_res = guard(
        "hier_fsdp", run_path, "hier_fsdp", short, dev, fused=True,
        steps=SHORT_STEPS, dist=_plan(2, 2, 2, "fsdp"),
        expect=lambda b: none(fused_sgd=SHORT_STEPS * b.layout.num_buckets,
                              fused_sgd_q=consumed(b, SHORT_STEPS)),
        **ASYNC_WIRE)
    async_res = guard(
        "async_wire", run_path, "async_wire", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True,
        expect=lambda b: none(fused_sgd=MAIN_STEPS * b.layout.num_buckets,
                              fused_sgd_q=consumed(b, MAIN_STEPS)),
        **ASYNC_WIRE)
    if async_res is not None and async_res["launches"]["fused_sgd"] != 104:
        failures.append(f"async_wire launches {async_res['launches']}")
    adamw_res = guard(
        "adamw_wire", run_path, "adamw_wire", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True, optimizer="adamw",
        expect=lambda b: none(fused_adamw=MAIN_STEPS * b.layout.num_buckets,
                              fused_adamw_q=consumed(b, MAIN_STEPS)),
        **ASYNC_WIRE)
    lars_res = guard(
        "lars_main", run_path, "lars_main", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True, optimizer="lars",
        expect=lambda b: none(fused_lars=MAIN_STEPS * b.layout.num_buckets))
    for name, res, key in (("adamw_wire", adamw_res, "fused_adamw"),
                           ("lars_main", lars_res, "fused_lars")):
        if res is not None and res["launches"][key] != 104:
            failures.append(f"{name} {key} launches {res['launches']}")
    if lars_res is not None and "fused_lars" in timing:
        pre = timing["fused_lars"]["prepass_ms_per_step"]
        log("[lars_main] prepass share of the step: " + json.dumps(
            {"prepass_ms_per_step": pre,
             "ms_per_step": lars_res["ms_per_step"],
             "share": pre / lars_res["ms_per_step"]}))
    agd_res = guard("agd_main", phase_averaging, "agd_main", cfg, dev,
                    "agd")
    logp_res = guard("every_logp_main", phase_averaging, "every_logp_main",
                     cfg, dev, "every_logp")
    if main_res is not None and agd_res is not None and logp_res is not None:
        log("[baselines] ms/step unprofiled, one call: " + json.dumps(
            {k: r["profile"]["step_ms_unprofiled"] for k, r in
             (("main", main_res), ("agd_main", agd_res),
              ("every_logp_main", logp_res))}))
    # the other adamw and lars paths, at 2 layers to keep the call short
    guard("adamw_sync", run_path, "adamw_sync", short, dev, fused=True,
          steps=SHORT_STEPS, optimizer="adamw",
          expect=lambda b: none(
              fused_adamw=SHORT_STEPS * b.layout.num_buckets))
    guard("lars_async", run_path, "lars_async", short, dev, fused=True,
          steps=SHORT_STEPS, optimizer="lars",
          expect=lambda b: none(
              fused_lars=SHORT_STEPS * b.layout.num_buckets),
          **ASYNC_WIRE)
    guard("adamw_unfused", run_path, "adamw_unfused", short, dev,
          fused=False, steps=SHORT_STEPS, optimizer="adamw",
          expect=lambda b: none(
              gossip_mix=SHORT_STEPS * b.layout.num_buckets))
    guard("lars_unfused", run_path, "lars_unfused", short, dev, fused=False,
          steps=SHORT_STEPS, optimizer="lars",
          expect=lambda b: none(gossip_mix_q=consumed(b, SHORT_STEPS)),
          **ASYNC_WIRE)
    q_res = guard(
        "async_unfused", run_path, "async_unfused", short, dev, fused=False,
        steps=SHORT_STEPS,
        expect=lambda b: none(gossip_mix_q=consumed(b, SHORT_STEPS)),
        **ASYNC_WIRE)
    guard("sync_fp8", run_path, "sync_fp8", short, dev, fused=True,
          steps=SHORT_STEPS,
          expect=lambda b: none(fused_sgd=SHORT_STEPS * b.layout.num_buckets,
                                fused_sgd_q=consumed(b, SHORT_STEPS)),
          wire_dtype="fp8")
    guard("ckpt", phase_ckpt, "ckpt", short, dev)
    guard("ckpt_async", phase_ckpt, "ckpt_async", short, dev, pad_to=4,
          **ASYNC_WIRE)
    guard("agree", phase_agree, dev)
    # the per-leaf engines (the launcher's default path), full width
    from repro_torch.kernels import gossip_mix_1d
    leaves = _num_leaves(cfg)
    leaf_res = guard(
        "leaf_main", run_path, "leaf_main", cfg, dev, fused=False,
        steps=MAIN_STEPS, profile=True, keep_params=True, packed=False,
        expect=lambda b: none())
    leaf_kernel_res = guard(
        "leaf_kernel", run_path, "leaf_kernel", cfg, dev, fused=False,
        steps=MAIN_STEPS, keep_params=True, packed=False,
        mix_impl=gossip_mix_1d,
        expect=lambda b: none(gossip_mix=MAIN_STEPS * leaves))
    if leaf_res is not None and leaf_kernel_res is not None:
        guard("leaf_kernel_gap", phase_leaf_kernel_gap, leaf_res,
              leaf_kernel_res)
    for res in (leaf_res, leaf_kernel_res):
        if res is not None:
            res.pop("params", None)
    torch.cuda.empty_cache()
    leaf_mix = guard("leaf_mix_check", phase_leaf_mix_check, cfg, dev) or {}
    guard("leaf_async", run_path, "leaf_async", cfg, dev, fused=False,
          steps=MAIN_STEPS, profile=True, packed=False,
          protocol="gossip_async", staleness=2, drop_rate=0.2,
          expect=lambda b: none())
    guard("leaf_agree", phase_leaf_agree, dev)
    guard("sim_agree", phase_sim_agree, dev)
    guard("hier_agree", phase_hier_agree, dev)
    unfused_res = guard(
        "unfused", run_path, "unfused", short, dev, fused=False,
        steps=SHORT_STEPS,
        expect=lambda b: none(gossip_mix=SHORT_STEPS * b.layout.num_buckets))
    flash_res = guard("flash_path", phase_flash_path, dev)
    mamba_res = guard("mamba_eval", phase_mamba_eval, dev)
    guard("mamba_agree", phase_mamba_agree, dev)
    # serving (no kernel on its path): full width, then card against CPU
    guard("serve_qwen", phase_serve, "serve_qwen", cfg, dev)
    guard("serve_mamba", phase_serve, "serve_mamba",
          get_config("falcon-mamba-7b"), dev)
    guard("serve_agree", phase_serve_agree, dev)
    # long-sequence training and the dense-attention members
    mamba_train_res = guard("mamba_train", phase_mamba_train, dev)
    guard("mamba_remat", phase_mamba_remat, dev)
    dense_res = guard("dense_train", phase_dense_train, dev)
    guard("serve_llava", phase_serve, "serve_llava",
          get_config("llava-next-mistral-7b"), dev, **LLAVA_SERVE)
    guard("serve_internlm2", phase_serve, "serve_internlm2",
          get_config("internlm2-20b"), dev, **INTERNLM2_SERVE)
    guard("dense_agree", phase_dense_agree, dev)
    # the encoder-decoder and routed-MoE family
    whisper_res = guard("whisper_train", phase_dense_train, dev,
                        archs=("whisper-base",), tag="whisper_train",
                        **WHISPER_TRAIN)
    guard("serve_whisper", phase_serve, "serve_whisper",
          get_config("whisper-base"), dev, **WHISPER_SERVE)
    jamba_eval_res = guard("jamba_eval", phase_jamba_eval, dev)
    guard("serve_jamba", phase_serve_moe, "serve_jamba",
          _depth(get_config("jamba-v0.1-52b"), JAMBA_UNIT), dev,
          **JAMBA_SERVE)
    jamba_train_res = guard("jamba_train", phase_jamba_train, dev)
    guard("serve_kimi", phase_serve_moe, "serve_kimi",
          _depth(get_config("kimi-k2-1t-a32b"), 1), dev, **KIMI_SERVE)
    guard("encdec_moe_agree", phase_dense_agree, dev,
          models=_encdec_moe_models(), tag="encdec_moe_agree")
    # MLA and the MTP head: deepseek-v3 scored, served and trained
    guard("deepseek_eval", phase_deepseek_eval, dev)
    guard("serve_deepseek", phase_serve_deepseek, dev)
    deepseek_train_res = guard("deepseek_train", phase_deepseek_train, dev)
    guard("deepseek_agree", phase_dense_agree, dev,
          models=_deepseek_models(), tag="deepseek_agree")
    # the launch tooling: the meta dry run against the card, the exchange's
    # byte accounting, the out-of-place mix and the examples
    guard("dryrun_check", phase_dryrun_check, dev)
    guard("comm_accounting", phase_comm_accounting, dev)
    mix_flat_res = guard("mix_flat", phase_mix_flat, dev)
    guard("examples", phase_examples, dev)
    # in-pod FSDP with one process per mesh position: four gloo ranks on
    # the one card (full width), then the reduced run against the stacked
    fsdp_out = guard("fsdp_ranks_run", fsdp_ranks_run, dev)
    fsdp = guard("fsdp_ranks", phase_fsdp_ranks, fsdp_out, dev)
    guard("fsdp_ranks_agree", phase_fsdp_ranks_agree, fsdp_out)
    # the per-leaf engines on the same ranks: each its piece of every leaf
    leaf_out = guard("leaf_ranks_run", leaf_ranks_run, dev)
    leaf_ranks = guard("leaf_ranks", phase_leaf_ranks, leaf_out, dev)
    guard("leaf_ranks_agree", phase_leaf_ranks_agree, leaf_out)
    # expert parallelism over model on the same ranks (full-width 2-layer
    # jamba), then serving over them
    moe_out = guard("moe_ranks_run", moe_ranks_run, dev)
    guard("moe_ranks", phase_moe_ranks, moe_out, dev)
    guard("moe_ranks_agree", phase_moe_ranks_agree, moe_out)
    guard("serve_ranks", phase_serve_ranks, moe_out, dev)
    log("[moe phases] seconds " + json.dumps(
        {k: seconds.get(k) for k in ("moe_ranks_run", "moe_ranks",
                                     "moe_ranks_agree", "serve_ranks")}))
    del moe_out
    # batch 1 over the same ranks: the sequence-parallel decode cache
    guard("serve_seq_ranks", phase_serve_seq_ranks, dev)
    if failures:
        log(f"[done] {time.perf_counter() - t_start:.1f}s; failed phases: "
            f"{failures}; phase seconds {json.dumps(seconds)}")
        return 1

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("fused_sgd", "fused_sgd.cu", "src/repro/kernels/fused_update.py:233",
         "main (sync fused)", main_res),
        ("fused_sgd_q", "fused_sgd.cu",
         "src/repro/kernels/fused_update.py:233",
         "async_wire (gossip_async int8 sub 0.5, fused; partner_scales)",
         async_res),
        ("gossip_mix", "gossip_mix.cu", "src/repro/kernels/gossip_mix.py:83",
         "unfused (sync --no-fused-update)", unfused_res),
        ("gossip_mix_q", "gossip_mix.cu",
         "src/repro/kernels/gossip_mix.py:142",
         "async_unfused (gossip_async int8 sub 0.5, unfused)", q_res),
        ("fused_adamw", "fused_adamw.cu",
         "src/repro/kernels/fused_update.py:316",
         "adamw_wire (adamw, gossip_async int8 sub 0.5, fused)", adamw_res),
        ("fused_lars", "fused_lars.cu",
         "src/repro/kernels/fused_update.py:366",
         "lars_main (lars, sync gossip, fused)", lars_res),
        ("ssm_scan", "ssm_scan.cu", "src/repro/kernels/ssm_scan.py:58",
         f"mamba_eval (falcon-mamba-7b scoring, 64 layers, {EVAL_B} x "
         f"{EVAL_S} tokens, {EVAL_FORWARDS} forwards)", mamba_res),
        ("flash_attention", "flash_attention.cu",
         "src/repro/kernels/flash_attention.py:97",
         f"flash_path (flash_mha on a bf16 qwen3-0.6b attention layer, "
         f"S {ATTN_S}, causal, fp32 q and k, bf16 v)", flash_res),
        ("ssm_scan_bwd", "ssm_scan_bwd.cu",
         "none (the reference's scan is forward-only; XLA differentiates "
         "its jnp train scan)",
         f"mamba_train (falcon-mamba-7b training, 64 layers, remat, the "
         f"chunked scan, {MAMBA_TRAIN['steps']} steps)", mamba_train_res),
    ]
    timing["flash_attention"] = flash_res["timing"]
    kernels = [dict(name=name, route="cuda", source=src + f,
                    replaces=rep, path=path, launches=res["launches"][name],
                    max_abs_err=err[name], **timing[name])
               for name, f, rep, path, res in rows]
    # the scaled AdamW launches (wire codes decoded in the sweep) ride in
    # fused_adamw's entry: their count, error and times
    by_name = {k["name"]: k for k in kernels}
    q = timing["fused_adamw_q"]
    by_name["fused_adamw"].update(
        launches_q=adamw_res["launches"]["fused_adamw_q"],
        max_abs_err=max(err["fused_adamw"], err["fused_adamw_q"]),
        max_abs_err_q=err["fused_adamw_q"], ms_q=q["ms"],
        ms_q_row_alpha=q["ms_row_alpha"], plain_ms_q=q["plain_ms"],
        bound_ms_q=q["bound_ms"])
    by_name["gossip_mix"]["launches_by_path"] = {
        "unfused": unfused_res["launches"]["gossip_mix"],
        "leaf_kernel": leaf_kernel_res["launches"]["gossip_mix"],
        "mix_flat_tree": mix_flat_res["tree"]["launches"]}
    if "launches_by_rank" in leaf_ranks:   # the ranks ran
        # the path's launches (dp 1: no mix runs), and apart from them the
        # one check launch on each rank's largest piece
        by_name["gossip_mix"]["launches_by_path"]["leaf_ranks"] = sum(
            r["gossip_mix"] for r in leaf_ranks["launches_by_rank"])
        by_name["gossip_mix"]["launches_leaf_ranks_check_by_rank"] = [
            m["launches"] for m in leaf_ranks["mix_by_rank"]]
        by_name["gossip_mix"]["max_abs_err_leaf_ranks"] = max(
            m["max_abs_err"] for m in leaf_ranks["mix_by_rank"])
    by_name["gossip_mix"]["launches"] = sum(
        by_name["gossip_mix"]["launches_by_path"].values())
    by_name["gossip_mix"]["max_abs_err_leaves"] = leaf_mix["max_abs_err"]
    # the out-of-place entry point (kernels.ops.gossip_mix_flat), bf16 on
    # the largest bucket's length plus 77
    flat = mix_flat_res["bfloat16"]
    by_name["gossip_mix"].update(
        max_abs_err_flat=max(flat["max_abs_err"],
                             mix_flat_res["float32"]["max_abs_err"],
                             mix_flat_res["tree"]["max_abs_err"]),
        ms_flat=flat["ms"]["median"], plain_ms_flat=flat["plain_ms"]["median"],
        library_ms_flat=flat["lerp_ms"]["median"],
        bound_ms_flat=flat["bound_ms"], elements_flat=MIX_FLAT_N)
    by_name["gossip_mix"]["path"] += (
        f"; leaf_kernel (per-leaf sync gossip, mix_impl=gossip_mix_1d, "
        f"{MAIN_STEPS} steps x {leaves} leaves)")
    by_name["fused_sgd"]["launches_by_path"] = {
        "main": main_res["launches"]["fused_sgd"],
        "agd_main": agd_res["launches"]["fused_sgd"],
        "every_logp_main": logp_res["launches"]["fused_sgd"],
        "hier_main": hier_res["launches"]["fused_sgd"],
        "hier_fsdp": hier_fsdp_res["launches"]["fused_sgd"],
        "mamba_train": mamba_train_res["launches"]["fused_sgd"],
        **{f"dense_train {a}": r["launches"]["fused_sgd"]
           for a, r in dense_res.items()},
        "whisper_train": whisper_res["whisper-base"]["launches"]["fused_sgd"],
        "jamba_train": jamba_train_res["launches"]["fused_sgd"],
        "deepseek_train": deepseek_train_res["launches"]["fused_sgd"]}
    if "launches_by_rank" in fsdp:   # the ranks ran (gloo carried CUDA)
        by_rank = [r["fused_sgd"] for r in fsdp["launches_by_rank"]]
        by_name["fused_sgd"]["launches_by_path"]["fsdp_ranks"] = sum(by_rank)
        by_name["fused_sgd"]["launches_fsdp_ranks_by_rank"] = by_rank
    big = mamba_train_res["big_bucket"]
    sweeps_by_path = {
        **{f"dense_train {a}": r["sweep"] for a, r in dense_res.items()},
        "whisper_train": whisper_res["whisper-base"]["sweep"],
        "jamba_train": jamba_train_res["sweep"],
        "deepseek_train": deepseek_train_res["sweep"]}
    sweeps = [big] + list(sweeps_by_path.values())
    by_name["fused_sgd"].update(
        max_abs_err=max([err["fused_sgd"]] + [
            sw[t]["max_abs_err"] for sw in sweeps for t in ("whole", "tail")]
            + [sw["max_abs_err"] for sw in fsdp.get("sweep_by_rank", [])]),
        max_abs_err_over_int32=big["whole"]["max_abs_err"],
        over_int32_elements=big["n"],
        max_abs_err_by_path={
            "mamba_train": max(big["whole"]["max_abs_err"],
                               big["tail"]["max_abs_err"]),
            **{p: max(sw["whole"]["max_abs_err"], sw["tail"]["max_abs_err"])
               for p, sw in sweeps_by_path.items()},
            **({"fsdp_ranks": max(sw["max_abs_err"]
                                  for sw in fsdp["sweep_by_rank"])}
               if "sweep_by_rank" in fsdp else {})},
        sweep_elements_by_path={
            "mamba_train": big["n"],
            **{p: sw["n"] for p, sw in sweeps_by_path.items()}})
    by_name["fused_sgd_q"]["launches_by_path"] = {
        "async_wire": async_res["launches"]["fused_sgd_q"],
        "hier_fsdp": hier_fsdp_res["launches"]["fused_sgd_q"]}
    scan = by_name["ssm_scan"]
    scan["launches_per_forward"] = mamba_res["ssm_scan_launches_per_forward"]
    scan["launches_by_path"] = {
        "mamba_eval": mamba_res["launches"]["ssm_scan"],
        "jamba_eval": jamba_eval_res["launches"]["ssm_scan"]}
    scan["launches_per_forward_by_path"] = {
        "mamba_eval": mamba_res["ssm_scan_launches_per_forward"],
        "jamba_eval": jamba_eval_res["ssm_scan_launches_per_forward"]}
    scan["launches_train_by_path"] = {
        "mamba_train": mamba_train_res["launches"]["ssm_scan_train"],
        "jamba_train": jamba_train_res["launches"]["ssm_scan_train"]}
    by_name["ssm_scan_bwd"]["launches_by_path"] = {
        "mamba_train": mamba_train_res["launches"]["ssm_scan_bwd"],
        "jamba_train": jamba_train_res["launches"]["ssm_scan_bwd"]}
    scan["max_abs_err_jamba_shape"] = jamba_eval_res["check_ssm"]["ssm_scan"]
    scan["max_abs_err"] = max(scan["max_abs_err"],
                              scan["max_abs_err_jamba_shape"])
    flash = by_name["flash_attention"]
    flash.update(max_abs_err_bf16=err["flash_attention_bf16"],
                 **timing["flash_attention_bf16"])
    flash["share_of_bound"] = flash["bound_ms"] / flash["ms"]
    for suffix in ("_bf16", f"_bf16_{ATTN_S_LONG}"):
        flash["share_of_bound" + suffix] = (flash["bound_ms" + suffix]
                                            / flash["ms" + suffix])
    log(f"[done] {time.perf_counter() - t_start:.1f}s; phase seconds "
        f"{json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
