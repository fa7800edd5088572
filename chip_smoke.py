#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py [--seed N] [--profile] [--json PATH]

Phases, each of which fails the run on any error:

1. print the card's name and power limit (``nvidia-smi``);
2. build the port's CUDA kernels from ``k8s_gpu_tpu_torch/csrc`` with
   ``nvcc``, one process per source, side by side, under the compile
   telemetry (``utils.compat.install_compile_telemetry``): a
   ``compile_telemetry`` line prints ``xla_compiles_total`` and
   ``xla_compile_seconds`` after the builds, and again at the end;
3. each kernel against its plain version at the shapes its main path
   gives it, in float32 and bf16 and with an int8 pool (a bf16 or int8
   run is also held against the plain version in float32 on the same
   values), with the error, the kernel's time, the plain version's
   time, the time of a PyTorch library call computing the same function,
   and the least time the card could take (bytes over 3.35 TB/s or
   operations over the type's peak, whichever is larger): the paged
   attention kernel (decode, admission windows, ragged GQA rows and a
   cold admission of a 512-token window from position 0, each with its
   route's design, ``cuda-splitk``, ``cuda-mma`` or ``cuda-fma``, the
   splits its row tiles took as the kernel counted them (held against
   the planner's ``tile_splits``) and the grid's splits a tile; the
   ragged, cold and ``left_pad_bf16`` cases also with poisoned trash and
   unowned blocks, ``left_pad_bf16`` being decode with every row's
   visible range from 324 and NaN in the five blocks below it; the
   verify windows of speculative serving, ``spec_verify_k{2,4,8}_bf16``
   (Sq = K + 1 over the paged spec cell's tables: starts 1025-1073, one
   window across the page boundary at 1088, one row from kv_start 197)
   and ``spec_verify_gqa_k4_bf16`` (G 4: 20 folded rows, the tensor
   cores), with poisoned trash and unowned blocks; phase 13's calls at a
   tp rank's heads, ``tp_local_h{2,4}_{decode,verify_k4}_{bf16,int8}``
   (B 8, H = KH = 2 or 4, decode and the verify window at K 4 over the
   spec cell's tables);
   decode_bf16 timed again on three pools made anew, the yardstick's
   spread), then the three flash-attention kernels (forward, dq,
   dk/dv; in bf16 all three on the tensor cores, held with terms for
   their roundings of p and ds to bf16), each alone on the same inputs
   and together through autograd with an lse cotangent, at the flagship
   training shape, at an odd and a non-causal one and at phase 4e's
   distillation shape (one 256-token row, timed: float32 as the draft
   trains, bf16 as the target's forward runs); then (3c) the three
   flash-v2 kernels the same way, with rope in the kernel, K/V at their
   KV heads and P = 2 query tiles a block, at the v2 training shape (q
   [24, 8, 2048, 128], k, v [24, 2, 2048, 128] bf16), the reference
   bench's MHA A/B shape, f32, an odd S whose tiles straddle group
   members, non-causal at P = 1, and MQA (in bf16 the backward pair takes
   one rotate-and-split pre-pass, timed on its own, and is held with the
   terms of ``reference_bwd_rounding_v2``); and in both 3b and 3c phase
   10's ring hop, a non-causal half-chunk [1, 8, 1024, 128] in bf16 with
   an lse cotangent (``ring_hop_bf16`` on v1; ``ring_hop_gqa_bf16`` on v2
   with 2 KV heads, rope outside, P 1), timed, and phase 11's calls at
   the tp-local heads, causal bf16, timed (``tp_local_bf16``: v1 at
   [4, 4, 2048, 128]; ``tp_local_gqa_bf16``: v2 at q [1, 4, 2048, 128],
   k, v [1, 1, 2048, 128], rope in the kernel, P 2, also phase 12b's
   call), and phase 12's v1 microbatch (``pp_microbatch_bf16``: [1, 8,
   2048, 128], causal bf16, timed);
4. the serving main path: the 302M flagship (vocab 16384, d_model 1024, 16
   layers, 8 heads of 128, d_ff 4096, max_seq 2048, bf16, random weights
   from ``--seed``) behind the port's ``LmServer`` on the paged pool with
   ``attn_impl="paged_kernel"``, answering HTTP ``/generate`` requests of
   a mixed-length serving traffic mix plus a pair that shares a 512-token
   prefix.  Every request must return its budget of tokens, a repeated
   greedy request the same stream, and the kernel counts are read just
   around this phase: every kernel of the path launched, no fall-back;
   after the pair's first request the burst builds no kernel library
   (``xla_compiles_total`` does not move);
   then (4b) the same flagship behind ``LmServer`` with its defaults, the
   dense KV pool (the reference's default deployment): a solo request
   (the fused cold start), ``/precache`` of a 512-token prefix, then the
   prefix itself, its pair and the mix together; every admission path
   (``cold_fused``, ``cold``, ``prefix_exact``, ``prefix_suffix``) must
   appear, and no paged kernel runs; then (4c) the paged pool with
   ``prefix_cache=False`` through ``ContinuousBatcher``: every admission a
   left-padded prefill spliced into blocks (the 700-token prompt decodes
   with kv_start 324), all ``cold``, the kernel counts read just around
   the phase; then (4d) the fleet contract: two ``LmServer``s, A and B,
   on the paged pool with the paged kernel, over HTTP: A serves a
   prompt X (a 512-token prefix and a suffix) cold and warm, X's chain
   moves to B (``/admin/export``, ``/admin/import``), B's stream of X
   equals A's warm one (a prefix hit; paged launches counted just around
   it), B's re-export holds A's bytes, a 256-token stream on A cut by an
   export resumes on B with exactly its budget, A as a prefill worker
   (``/admin/role``, 409 while busy; ``/prefill``) hands Y to B with no
   decode step, deadlines answer 504, and every request has one journal
   record with its client's golden hash; then (4e) speculative serving:
   a draft distilled from the flagship with the reference bench's recipe
   (2 layers at half width, float32, hard labels on the greedy trajectory
   of one prompt, up to 1500 steps; the flash kernels launched, no plain
   call), the dense pool's plain, spec and int8-draft batchers on four
   160-token requests (the bench's ``spec_batcher_probe``: tokens/s,
   acceptance, adapted K), the paged pool's plain, n-gram and
   distilled-draft batchers on eight 48-token requests over one shared
   1024-token prefix through the paged kernel (``cb_paged_spec``: its
   launches exactly one a layer for every kernel admission, verify
   sub-round and plain decode step, no fall-back), every budget met, and
   each spec stream equal to the plain stream of the same request on the
   same pool, or first departing where the plain logits' top-2 gap is
   under 0.25 (bf16; the plain streams' gap distribution is printed
   beside it) and, at float32 with a draft distilled against the float32
   target, under 1e-4 on both pools (dense: spec and int8 draft; paged:
   n-gram and neural); then (4f) the model lifecycle on the same
   flagship: the bf16 params and their int8 tree through a servable
   bundle (``export_servable_dir``/``load_servable_dir``: bit-equal
   leaves, the same greedy stream; bytes and seconds), a LoRA fine-tune
   (``Trainer(LoraModel(...))``, rank 8, batch 4 x 2048, flash v1 with
   full remat: launches exactly 2/1/1 a layer and step, losses falling,
   base leaves bit-identical), multi-LoRA serving behind ``LmServer``
   on the paged pool with the paged kernel (that adapter, a rank-4 one
   on wq/wv and a rank-16 one: eight requests over one 512-token
   prefix, base rows sharing its blocks and adapter rows never, launches
   exact, base streams equal to a bank-less server's and tokens/s beside
   it, adapter streams against servers on the merged weights by the
   near-tie rule in bf16 and at 1e-4 in float32, an unknown adapter
   answering 400), regex and JSON-schema constrained decoding (the
   bank's compile seconds and table bytes at V 16384; constrained texts
   in their language, free streams equal to a bank-less server's,
   launches exact) and the disaggregated prefill pool (700 and 1536
   tokens whole, 1536 chunked by 256, an adapter request; every
   handover ``precomputed``, launches exact, streams equal to the same
   requests served directly by the near-tie rule, the in-flight rows
   within their cap, and the longest gap of a 160-token stream during a
   whole, a chunked and a co-located prefill);
5. a check of the output by the repo's own means: the paged-kernel engine
   against the gather engine on one prompt (finite logits that agree);
   then (5b) the 700-token prompt left-padded to 1024: its row decoded
   on the dense cache and, spliced into blocks, through the paged kernel
   (logits within the same limit);
6. the training main path: the same flagship with f32 master weights,
   bf16 compute, flash attention and full remat, batch 24 of 2048 random
   tokens from ``--seed``, through the port's ``Trainer``: one warm-up
   step, then timed steps on the same batch (step time, tokens/s, MFU);
   every loss finite, the last below the first, and the flash kernels'
   launch counts read just around the timed steps: 2 forward (remat) and
   1 dq and 1 dk/dv per layer and step, no plain-version call; then (6b)
   the v2 training path: the same with ``n_kv_heads=2`` and the three v2
   knobs on (``flash_fuse_rope``, ``flash_kv_grouped``,
   ``flash_q_pipeline=2``), held to the same launch counts of the v2
   kernels, 3 pre-pass launches per layer and step and 0 v1 launches;
   then the same GQA configuration with the knobs off (v1 kernels, rope
   outside, K/V repeated), timed as a yardstick of the knobs; then (6c)
   the training job at the same width, depth and batch: the ``Trainer``
   with a ``GoodputLedger``, a ``PhaseProfiler`` and the step series
   runs 2 steps of ``fit``, saves a checkpoint (f32 params, AdamW's
   count and moments), takes step 3; a fresh ``Trainer`` resumes from
   the checkpoint and takes step 3 again, equal bit for bit (loss,
   params, moments) under ``torch.use_deterministic_algorithms``; the
   ledger's segments are exact (init 1, compile 1, step 2, data_wait
   3, checkpoint_save 1); the native loader gives the Python loader's
   batches byte for byte and feeds one step; ``remat_policy=
   "save_attn"`` beside ``"full"`` on both flash paths launches 1/1/1
   flash kernels a layer and step (v2: and 2 pre-passes), no plain
   call, with step ms, peak memory, and a step's loss and gradients
   held to phase 7's bf16 limits; the registry's ``lm-train``,
   ``lora-finetune`` and ``cnn-train`` run at the reference's defaults
   with falling losses, ``lm-train-ckpt`` preempted at step 5 through
   the port's ``WorkloadContext`` resumes at step 4 and ends on an
   uninterrupted run's last loss, ``psum-smoke`` runs on a world of one
   and ``dist-psum-smoke`` over two gloo ranks on the card;
7. a check of the training output by the repo's own means: the loss and
   every gradient of one step with flash attention against the same with
   plain attention, at full depth in bf16 (batch 2) and at 2 layers in
   float32; then (7b) the same for the v2 configuration against the same
   GQA configuration with the knobs off (v1, rope outside, K/V repeated);
8. Switch top-1 MoE at the flagship's widths (4 experts, capacity factor
   1.25, nothing cut: 906M parameters, 302M active a token): (8a) the
   ``Trainer`` at batch 24 x 2048 (f32 masters, bf16, flash v1, full
   remat), one warm-up and 3 timed steps, losses finite and falling,
   aux > 0 each step, flash launches 2/1/1 a layer and step and no
   plain call, ``train_mfu`` over all experts (the reference's
   convention) beside an MFU over the active parameters, the tokens
   each layer drops at capacity, then ``save_attn`` (launches 1/1/1, its
   losses against full's); (8b) bf16 behind ``LmServer`` on the paged
   pool with the paged kernel (phase 4's pair and mix, every admission
   ``cold``, launches exactly one a layer and decode step) and on the
   dense pool at its defaults, every budget met, a repeated greedy
   request stable, ``/precache`` refused as the reference refuses; (8c)
   at float32 and 2 layers, greedy streams through the paged kernel
   against the gather read's and a paged n-gram spec batcher against the
   plain streams, under the float32 near-tie rule (1e-4);
9. the Fin-Agent-Suite application on the card and the serving plane's
   spans and phase profiler: (9a) a small Markdown knowledge base
   (products, loans, cards, a FAQ; Chinese and English) ingested through
   the port's embedder into its vector store, then 1,000,000 synthetic
   1024-d unit rows drawn on the card from ``--seed`` (VectorDBBench's
   1M scale at the reference schema's width), 64 queries in L2 and IP
   each held against a float64 brute force (ids equal but for float64
   ties under 1e-6, values within 1e-4; each marketing query's KB chunk
   first), with the embedder's chunks/s (host hashing, device product),
   the flush's seconds and peak, search ms p50/p99 beside its bound and
   the resident GB; (9b) the app's HTTP server on that store with
   ``HttpLMClient`` at the flagship's ``LmServer`` (phase 4's paged pool,
   the paged kernel, phase 4's tokenizer): 16 ``/chat`` posts, 8 at a
   time, half complaints (each filed in sqlite), every answer 200 with
   its agent and a reply, paged launches > 0 and 0 fall-backs, latency
   per agent, prompt tokens, tokens/s; (9c) 8 ``/generate`` requests with
   a ``traceparent`` whose ``serve.queue_wait``, ``serve.prefill`` and
   ``serve.round`` spans are read back from the port's ``MetricsServer``
   (the rounds' tokens covering the stream), untraced submits that record
   no ``serve.`` span, ``serve_phase_share`` on ``/metrics`` and a
   ``utils.profiling.trace`` of two decode rounds (its file deleted
   after); (9d) ``TorchLMClient`` at its default model answering two
   ``/chat`` calls, greedy and sampled;
10. the parallel plane (``k8s_gpu_tpu_torch/parallel``): (10a) two NCCL
   ranks on the one card, whose refusal (or success) is printed, and
   the NCCL ``psum_smoke`` on a world of one; (10b) which collectives
   gloo takes on CUDA tensors as they are, each in its own two-rank
   cluster; then four gloo ranks on the card (the port's collectives
   copy each transfer through the host) over a dp 2 x sp 2 mesh: (10c)
   the v2 training configuration at max_seq 4096 (the flagship's widths
   at 4 of its 16 layers, 2 KV heads, ``flash_kv_grouped``; the tool
   ``tools/torch_parallel_check.py`` runs all 16), global batch 4 x 4096,
   ``grad_accum_steps`` 2, ZeRO-1, through ring attention and then
   Ulysses, a warm-up and 3 timed steps each: losses finite, falling and
   equal on every rank, step 1 within 1e-2 of one rank's step over the
   whole batch (the flash-v2 path, rope in the kernel), v2 launches
   exactly 2 x calls / calls / calls a layer, microbatch and step (ring:
   3 calls, Ulysses: 1), 0 pre-passes, 0 plain calls,
   ``flash_fallback_total{reason="sp_fused_rope"}`` one a layer and
   forward; step ms, tokens/s, MFU over the card (all four ranks' work
   against one card's peak), peak memory a rank;
   (10d) float32: ring at sp 4 and Ulysses at sp 2 (q [2, 8, 4096,
   128], GQA) output and gradients within 1e-4 of one whole-sequence
   flash-v2 call, and a 2-layer meshed step's loss, gradients and
   parameters within 1e-4 of one rank's; (10e) ``per_axis_bandwidth_probe``
   over the mesh, gloo through the host on one card (no NCCL rate);
11. the tensor and expert axes: four gloo ranks on the card again, each
   holding its shards of the parameters (heads, F and the vocabulary
   over tp, experts over ep), each run held against one rank's step
   over the whole batch: (11a) the v2 training configuration over dp 2
   x tp 2 at max_seq 2048, global batch 4 x 2048, 2 microbatches,
   ZeRO-1, a warm-up and 3 timed steps: losses finite, falling and equal
   on every rank, step 1 within 1e-2 of one rank's, v2 launches exactly
   2/1/1 a layer, microbatch and step at 4 query heads and 1 KV head
   (the forward twice under full remat), 3 rope pre-passes, 0 plain;
   step ms, tokens/s, peak memory a rank and the seconds of an extra
   step in each kind of transfer by mesh axis (tp all-reduces against
   the dp gradient all-reduce); (11b) sp 2 x tp 2 at max_seq 4096,
   global batch 2 x 4096, ring (v2, 3 calls a layer) then Ulysses (KV
   heads / tp = 1 does not divide by sp: K/V broadcast, one v1 call a
   layer, ``ulysses_kv_heads`` one a layer and forward), a warm-up and
   2 timed steps each, the same checks; (11c) phase 8's MoE (4 experts,
   capacity 1.25) over ep 2 x tp 2, max_seq 2048, global batch 4 x
   2048: the same checks on v1's launches, and the share of
   token-layers dropped within 0.5 % of one rank's; (11d) float32 at 2
   layers: dp 2 x tp 2 dense, sp 2 x tp 2 ring and dp 2 x ep 2 MoE at
   capacity 1.0 (drops > 0 and equal to one rank's), each step's loss,
   gathered gradients and update within 1e-4 of one rank's; (11e) one
   step on the multislice mesh, dp 2 over 2 slices x tp 2;
12. the pipeline axis: four gloo ranks on the card again, each holding
   its stage's blocks, the embedding and the head, each run held against
   one rank's step over the whole batch: (12a) GPipe over dp 2 x pp 2,
   v1, global batch 4 x 2048, 2 microbatches a dp group; (12b) 1F1B over
   pp 2 x tp 2, the v2 GQA configuration, 4 x 2048, 4 microbatches;
   (12c) interleaved 1F1B over pp 4 with 2 virtual stages, v1, 8 x 2048,
   8 microbatches, and classic 1F1B at pp 4 on the same batch (26 fine
   ticks against 2 x 14), each a warm-up and 2 timed steps: losses
   finite, falling and equal on every rank, step 1 within 1e-2 of one
   rank's, launches exactly ``pp_launches``'s rank by rank (a 1F1B stage
   runs a layer's forward twice a microbatch, the last virtual stage
   once), 0 plain; step ms, tokens/s, peak memory by rank and stage, the
   seconds of an extra step in each transfer by module and axis; 12a's
   mesh again at 8 microbatches, 16 x 2048, one step under each
   schedule: resident and peak GB by rank; (12d) float32 at 4 layers (8
   interleaved): GPipe, 1F1B over pp 2 x tp 2 and interleaved 1F1B, each
   step's loss, gathered gradients and update within 1e-4 of one rank's,
   the gradients of the embedding, the final norm and the head the same
   on every rank;
13. serving on a mesh: four gloo ranks on the card (``serve_ranks``),
   each holding its shards of the flagship (``SRV_LAYERS``, 8 of its 16
   layers, bf16, ``--seed``'s weights), rank 0 the leader behind a meshed ``LmServer``'s HTTP:
   (13a) tp 4 on the shared paged pool through the paged kernel at the
   rank's 2 heads, phase 4's pair and the first two requests of its
   mix, 16 tokens each, then a repeated greedy request; every budget
   met, the pair's
   second ``paged_shared``, paged launches on every rank exactly 8 x
   (kernel admissions + decode steps), 0 fall-backs; tokens/s, TTFT p50
   and max, peak GB a rank, and an extra round of 8 steps after the
   burst with each transfer timed by axis; (13b) dp 2 x tp 2 on the
   dense pool, 8 slots (4 a dp group), no paged launch; (13c) tp 4
   n-gram speculation on the paged pool, launches 8 x (kernel
   admissions + verify sub-rounds + plain steps); (13d) tp 4 with a
   two-adapter bank beside the bank-less server: base rows after the
   first share blocks, adapter rows ``cold``, base streams against the
   bank-less server's; (13f) ``ContinuousBatcher(mesh=)`` on tp 4
   paged, unshared (every admission prefills the draft row; a shared
   one zeroes it, as the reference's executor does), with the target
   as its own neural draft (a draft of random weights accepts nothing,
   and then no round advances more than one token; the target's own
   proposals are accepted, so rounds advance several tokens and carry
   the draft's rows forward: at least one accepted token is required),
   (13g) the same with ``draft_int8``, the
   verify windows' launches on every rank read from the kernel
   wrapper's count by query width, (13h) the MoE flagship (``MOE``) on
   tp 4 paged and dp 2 x tp 2 dense, a departure passing at a logit gap
   over the limit only where every rank's replay of the stream shows
   a router choice unlike one rank's, each within a tie (bf16 2^-6,
   float32 1e-5), (13i) tp 4 on int8 weights (the whole tree
   quantized, then cut), each over the SRV_NEW_B-token jobs;
   (13j) tp 4 paged streams the pair, /admin/export's blocks go into a
   one-rank torch replica whose own export must be the same bytes,
   /prefill's payload too (the replica streams the prompt over it), and
   the replica's export comes back into a new tp 4 server with an
   in-process prefill pool (``DisaggregatedLm``): the pair's second
   shares the imported blocks, the mix's two are handed over
   (``precomputed``, no kernel admission); export, /prefill and import
   ms and MB; each against one rank's streams on the whole weights by
   the near-tie rule (top-2 gap 0.25); (13e) all of them and int8 KV in
   float32 at 2 layers under the float32 rule (1e-4), and a 3-step LoRA
   fine-tune over dp 2 x tp 2 at 4 x 2048 against one rank's (losses,
   the step-1 gradients and update within 1e-4).  Phases 10 and 11 run
   ``PAR_LAYERS`` (4) of the 16 layers, phase 12 ``PP_LAYERS`` (8),
   phase 13's bf16 parts ``SRV_LAYERS`` (8).
14. The state of a meshed trainer and ``save_attn`` on every mesh: four
   gloo ranks on the card at the flagship's widths, ``STATE_LAYERS`` (2)
   deep, sequences of 1024.  (14a) dp 2 x tp 2 (v2, ZeRO-1, an EMA) trains 2
   steps and saves through ``attach_to_trainer`` shard-wise (each rank
   its blocks, each block once, and a manifest), then takes step 3; the
   checkpoint resumes onto pp 2 x tp 2 (1F1B), onto dp 4 under the fsdp
   table and, in this process, onto the card alone: the restored
   parameters, moments, EMA and count bit for bit the saved ones
   (integer fingerprints), step 3's loss within 2.4e-4 of the
   uninterrupted one on pp 2 x tp 2 and within 1e-3 on dp 4 and the
   card alone (no tp: other bf16 sums), and within 1e-5 at float32 (a
   small configuration, 2 layers, sequences of 256); each rank's bytes
   written and its device peak over the save (at most 0.01 GB above
   what it held before), the stored elements those of the whole trees,
   save and restore
   seconds, bytes, GB/s.  (14b) ``save_attn`` beside full remat on dp 2
   x tp 2, sp 2 x tp 2 (ring, Ulysses), ep 2 x tp 2 MoE and pp 2 x tp 2
   (1F1B): a rank's flash launches in one step exactly
   ``save_attn_launches`` (the forward once a layer and microbatch under
   ``save_attn``, twice under full but on 1F1B's last stage), 0 plain
   calls, the counted step's gradients within ``SAVE_ATTN_GRAD_TOL`` of
   full's by leaf, step-1 losses and the loss after one update within
   phase 7's bf16 limit of full's, peak GB a rank under each.  (14c) the CNN over
   dp 2 x tp 2 and a rank-8 LoRA over dp 2 x pp 2 (GPipe): a step each
   against one rank's.  (14d) fsdp: 14a's model on dp 2 x tp 2 with
   ``"embed"`` cut over dp (``Trainer(rules=)``, an EMA, no ZeRO-1)
   beside the default rules: each rank's flash launches in the counted
   step those of the default rules and ``save_attn_launches``, 0 plain;
   step-1 losses equal, the loss after one update within 2.4e-4 (the
   float32 twin within 1e-5); each rank's bytes at rest exactly half the
   default's, beside 14a's under ZeRO-1, and its peak GB; a checkpoint
   saved under fsdp (shard-wise, as 14a's) restored onto the card alone
   bit for bit, the next step within 1e-3; fsdp with ZeRO-1 refused at
   ``init``.  (14e) a table that moves a weight axis, ``"mlp": None``
   (the MLP whole on every tp rank), on dp 2 x tp 2 beside the default
   rules: launches as 14d's, 0 plain; losses within 1e-2 (the float32
   twin within 1e-5); in both, the whole parameters, moments and EMA
   after the counted step within 1e-5 of the default's (each leaf's gap
   over its largest element); each rank's bytes at rest those the
   table's specs give; its checkpoint restored onto the default table
   bit for bit, the next step within 2.4e-4.

It prints a ``{"kernels": [...]}`` line (each entry names the phase
that launches it; each flash entry also with its
useful TFLOP/s and ``design``: ``cuda-mma`` for the tensor-core instance
that was timed, ``cuda-fma`` for one on the CUDA cores; the paged entry
with the decode case's design, the most splits a row tile took and the
grid's splits a tile, and the same with the ms, bound and library ms of
the window, cold-admission and verify cases beside them), then as its
last
line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
port beside it, it exits non-zero and prints no result.  ``--json PATH``
also writes every measured number to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per second
KERNEL_SOURCES = ("paged_attention", "flash_attention",
                  "flash_attention_v2")
# Kernel against its plain version on the same inputs (max abs error).
# float32: both compute in f32 and differ only in summation order.  bf16
# and int8: the plain version rounds scores and probabilities to bf16 and
# the kernel keeps them in f32; the worst reading at the flagship shapes
# was 6.8e-3 (outputs there are about 0.03 in size), so this limit only
# ties the two together (where outputs are larger: one bf16 step of the
# largest value, FLASH_SAME_TYPE_REL).  The tight check of those types is
# against the plain version in float32 on the same values: the kernel
# then differs only by rounding its output to bf16, at most half a bf16
# step (2**-8 of the value), held at F32_REF_RTOL.
F32_TOL = 1e-4
BF16_TOL = 1e-2
F32_REF_ATOL, F32_REF_RTOL = 1e-5, 2.0 ** -7


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# -- phase 3: paged attention against its plain version ---------------------

def _type_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _pa_case(torch, gen, *, B, Sq, H, KH, Dh, page, t_hi, dtype, quant,
             layout, dev):
    """Pool, tables and positions for one kernel case.  ``full``: row b
    owns its own blocks and its window ends the cache; ``ragged``: rows
    own different page counts and dead table entries point at trash
    block 0; ``cold``: a cold admission, the window [0, Sq) in the row's
    first Sq / page blocks, trash past them and other tenants' blocks in
    the pool; ``left_pad``: ``full`` with every row's visible range
    starting at LEFT_PAD, as a left-padded admission leaves it; ``spec``:
    the verify windows of the paged spec cell (``spec_layout``).  Returns
    the operands and the mask of blocks some row sees: a block wholly
    below a row's kv_start is not seen."""
    MP = t_hi // page
    NB = 1 + B * MP
    q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev).to(dtype)
    pages = torch.zeros(B, MP, dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32)
    kv_start = torch.zeros(B, dtype=torch.int32)
    if layout == "spec":
        pages, start, kv_start = spec_layout(torch, B, Sq, MP, page)
    for b in range(B if layout != "spec" else 0):
        if layout == "cold":
            live = -(-Sq // page)
        elif layout == "ragged":
            live = max(1, MP - (b % 4) * (MP // 4))
        else:
            live = MP
        pages[b, :live] = torch.arange(1 + b * MP, 1 + b * MP + live)
        if layout != "cold":
            start[b] = live * page - Sq - (b % 3)
        kv_start[b] = ((b % 2) * (page // 2) if layout == "ragged"
                       else LEFT_PAD if layout == "left_pad" else 0)
    owned = torch.zeros(NB, dtype=torch.bool)
    for b in range(B):
        seen = pages[b, int(kv_start[b]) // page:]
        owned[seen[seen > 0].long()] = True
    kf = torch.randn(NB, KH, page, Dh, generator=gen, device=dev)
    vf = torch.randn(NB, KH, page, Dh, generator=gen, device=dev)
    ops = {"q": q, "pages": pages.to(dev), "start": start.to(dev),
           "kv_start": kv_start.to(dev)}
    if quant:
        from k8s_gpu_tpu_torch.serve.engine import _quantize_kv

        kq, ks = _quantize_kv(kf)
        vq, vs = _quantize_kv(vf)
        ops.update(k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        ops.update(k=kf.to(dtype), v=vf.to(dtype), k_scale=None,
                   v_scale=None)
    return ops, owned.to(dev)


# The paged spec cell (bench.py:851-872): eight requests over one shared
# 1024-token prefix (16 blocks of 64) and a one-token suffix each, 48
# tokens each, so verify windows start at 1025-1073.
SPEC_SHARED_PAGES = 16
SPEC_STARTS = (1025, 1032, 1040, 1049, 1057, 1065, 1073)
SPEC_KV_START = 197   # one row reads from 197 on (blocks 1-3 below it)


def spec_layout(torch, B, Sq, MP, page):
    """Page tables and positions of the verify windows of the paged spec
    cell: every row maps the 16 shared blocks 1-16 first and two private
    blocks after them (positions 1024-1151), trash past them; the rows'
    windows start at SPEC_STARTS, and the eighth row's window [start,
    start + Sq) straddles the page boundary at 1088; the fourth row's
    visible range starts at SPEC_KV_START."""
    pages = torch.zeros(B, MP, dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32)
    kv_start = torch.zeros(B, dtype=torch.int32)
    cross = (SPEC_SHARED_PAGES + 1) * page
    starts = list(SPEC_STARTS) + [cross - Sq // 2 - 1]
    for b in range(B):
        shared = torch.arange(1, 1 + SPEC_SHARED_PAGES)
        own = 1 + SPEC_SHARED_PAGES + 2 * b
        pages[b, :SPEC_SHARED_PAGES] = shared
        pages[b, SPEC_SHARED_PAGES:SPEC_SHARED_PAGES + 2] = torch.tensor(
            [own, own + 1])
        start[b] = starts[b % len(starts)]
    kv_start[3 % B] = SPEC_KV_START
    return pages, start, kv_start


def _poisoned(ops, owned):
    """A copy whose trash block 0 holds large values and whose unowned
    blocks hold NaN (in the scales of an int8 pool)."""
    out = dict(ops)
    foreign = ~owned
    foreign[0] = False
    if ops["k_scale"] is None:
        for key in ("k", "v"):
            t = ops[key].clone()
            t[0] = 1e4
            t[foreign] = float("nan")
            out[key] = t
    else:
        for key in ("k_scale", "v_scale"):
            t = ops[key].clone()
            t[0] = 1e4
            t[foreign] = float("nan")
            out[key] = t
    return out


def _pa_bound(ops, *, page, t_hi, Dh):
    """Least time for this call on this data: the blocks some row needs
    (a block shared by rows counts once) plus q and the output, over the
    memory rate; the unmasked positions' 4*Dh flops per query row and
    head over the peak of q's type."""
    q, pages = ops["q"], ops["pages"].cpu()
    start, kv_start = ops["start"].cpu(), ops["kv_start"].cpu()
    B, Sq, H, _ = q.shape
    KH = ops["k"].shape[1]
    need: set[int] = set()
    positions = 0
    for b in range(B):
        lo = int(kv_start[b])
        for j in range(Sq):
            hi = min(int(start[b]) + j, t_hi - 1)
            positions += max(0, hi - lo + 1)
        last = min(int(start[b]) + Sq - 1, t_hi - 1)
        for p in range(lo // page, last // page + 1):
            need.add(int(pages[b, p]))
    per_block = 2 * KH * page * Dh * ops["k"].element_size()
    if ops["k_scale"] is not None:
        per_block += 2 * KH * page * 4
    nbytes = len(need) * per_block + 2 * q.numel() * q.element_size()
    flops = 4.0 * positions * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[_type_name(q.dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _pa_library(torch, ops, *, page, t_hi):
    """Gather + scaled_dot_product_attention: a yardstick only, never
    called by the port."""
    import torch.nn.functional as F

    q, k_pool, v_pool = ops["q"], ops["k"], ops["v"]
    B, Sq, H, Dh = q.shape
    KH = k_pool.shape[1]
    p_hi = t_hi // page
    tbl = ops["pages"][:, :p_hi].long()
    k = k_pool[tbl].transpose(1, 2).reshape(B, KH, p_hi * page, Dh)
    v = v_pool[tbl].transpose(1, 2).reshape(B, KH, p_hi * page, Dh)
    if ops["k_scale"] is not None:
        ks = ops["k_scale"][tbl].transpose(1, 2).reshape(B, KH, -1)
        vs = ops["v_scale"][tbl].transpose(1, 2).reshape(B, KH, -1)
        k = k.to(q.dtype) * ks[..., None].to(q.dtype)
        v = v.to(q.dtype) * vs[..., None].to(q.dtype)
    if H != KH:
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
    t = torch.arange(p_hi * page, device=q.device)
    q_pos = ops["start"].long()[:, None] + torch.arange(Sq, device=q.device)
    mask = ((t[None, None] <= q_pos[..., None])
            & (t[None, None] >= ops["kv_start"].long()[:, None, None]))
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None], scale=Dh ** -0.5)
    return o.transpose(1, 2)


PA_SPREAD_RUNS = 3  # decode_bf16 timed again on pools made anew
TP_LOCAL_HEADS = (2, 4)  # a rank's heads of 8 at tp 4 and tp 2
SPEC_KS = (2, 4, 8)  # the draft windows adaptive K picks among
# kv_start of a 700-token prompt left-padded to its 1024 bucket (the
# serving mix's, on the unshared paged pool): five whole pages below it.
LEFT_PAD = 1024 - 700


def hold_paged(torch, pa, name, out, args, kw, design):
    """Phase 3's limits for one paged kernel output: against the plain
    version in the kernel's own type, and (bf16) against the plain
    version in float32 on the same values.  Returns (max_abs_err, its
    limit, max_abs_err against float32); raises past a limit."""
    ref = pa.paged_attention_reference(*args, **kw)
    err = float((out.float() - ref.float()).abs().max())
    f32 = args[0].dtype == torch.float32
    # A window from position 0 has rows that see a few positions, so
    # outputs the size of V (~4): one bf16 step there exceeds BF16_TOL.
    tol = F32_TOL if f32 else max(
        BF16_TOL, FLASH_SAME_TYPE_REL * float(ref.float().abs().max()))
    if not err <= tol:
        raise RuntimeError(
            f"{name}: kernel vs plain max_abs_err {err} > {tol}")
    if f32:
        return err, tol, err
    # bf16 -> f32 is exact; an int8 pool and the tables stay.  The
    # tensor-core route also rounds p * v_scale to bf16 before P V: its
    # limit adds that rounding's bound.
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref32 = pa.paged_attention_reference(*wide, **kw)
    diff = (out.float() - ref32).abs()
    err_f32 = float(diff.max())
    lim = F32_REF_ATOL + F32_REF_RTOL * ref32.abs()
    if design == "cuda-mma":
        lim = lim + pa.reference_p_rounding(*args, **kw)
    if not bool((diff <= lim).all()):
        raise RuntimeError(
            f"{name}: kernel vs float32 plain version beyond atol "
            f"{F32_REF_ATOL} + rtol {F32_REF_RTOL} (+ the p rounding on "
            f"the tensor cores; max abs {err_f32})")
    return err, tol, err_f32


def check_paged_attention(torch, seed: int) -> list[dict]:
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, B, Sq, H, KH, Dh, page, t_hi, q dtype, int8 pool, layout
        ("decode_f32", 8, 1, 8, 8, 128, 64, 2048, f32, False, "full"),
        ("decode_bf16", 8, 1, 8, 8, 128, 64, 2048, bf16, False, "full"),
        ("decode_int8", 8, 1, 8, 8, 128, 64, 2048, bf16, True, "full"),
        ("window_f32", 1, 512, 8, 8, 128, 64, 2048, f32, False, "full"),
        ("window_bf16", 1, 512, 8, 8, 128, 64, 2048, bf16, False, "full"),
        ("window_int8", 1, 512, 8, 8, 128, 64, 2048, bf16, True, "full"),
        ("gqa_ragged_f32", 8, 1, 32, 8, 128, 64, 2048, f32, False, "ragged"),
        ("gqa_ragged_bf16", 8, 1, 32, 8, 128, 64, 2048, bf16, False,
         "ragged"),
        ("gqa_ragged_int8", 8, 4, 32, 8, 128, 64, 2048, bf16, True,
         "ragged"),
        # What _admit_paged_dev gives the kernel on a cold admission: a
        # 512-token window from position 0, read bound max_seq.
        ("admit_cold_bf16", 1, 512, 8, 8, 128, 64, 2048, bf16, False,
         "cold"),
        # Decode on the unshared paged pool: every row's visible range
        # starts at LEFT_PAD; the blocks wholly below it hold NaN.
        ("left_pad_bf16", 8, 1, 8, 8, 128, 64, 2048, bf16, False,
         "left_pad"),
        # The verify windows of speculative serving (extend_multi at Sq =
        # K + 1 for K = 2, 4, 8) over the paged spec cell's tables; with
        # G = 4 and K = 4 the folded rows (20) pass 16 and take the
        # tensor cores.
        *[(f"spec_verify_k{k}_bf16", 8, k + 1, 8, 8, 128, 64, 2048, bf16,
           False, "spec") for k in SPEC_KS],
        ("spec_verify_gqa_k4_bf16", 8, 5, 32, 8, 128, 64, 2048, bf16, False,
         "spec"),
        # Phase 13's calls: a tp rank's heads of the flagship's 8 (tp 4:
        # 2, tp 2: 4), decode and the verify window at K 4, bf16 and int8
        # pools.
        *[(f"tp_local_h{h}_{kind}_{kv}", 8, sq, h, h, 128, 64, 2048, bf16,
           kv == "int8", layout)
          for h in TP_LOCAL_HEADS
          for kind, sq, layout in (("decode", 1, "full"),
                                   ("verify_k4", SPEC_K + 1, "spec"))
          for kv in ("bf16", "int8")],
    ]
    results = []
    for name, B, Sq, H, KH, Dh, page, t_hi, dtype, quant, layout in cases:
        ops, owned = _pa_case(
            torch, gen, B=B, Sq=Sq, H=H, KH=KH, Dh=Dh, page=page, t_hi=t_hi,
            dtype=dtype, quant=quant, layout=layout, dev=dev)
        args = (ops["q"], ops["k"], ops["v"], ops["pages"], ops["start"],
                ops["kv_start"])
        kw = dict(page=page, t_hi=t_hi, k_scale=ops["k_scale"],
                  v_scale=ops["v_scale"])
        cut = pa.plan(ops["q"].shape, dtype, KH, page=page, t_hi=t_hi,
                      n_sms=pa.sm_count(dev))
        design = cut.design
        before = pa.launch_count
        out = pa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        if pa.launch_count != before + 1:
            raise RuntimeError(f"{name}: the kernel was not launched")
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: non-finite kernel output")
        # The splits each row tile took, as the kernel counted them, held
        # against the planner's mirror (tile_splits); the grid has
        # cut.splits blocks a tile.
        again, used = pa._launch(*args, page, t_hi, ops["k_scale"],
                                 ops["v_scale"], count_splits=True)
        want = pa.tile_splits(
            ops["start"].tolist(), ops["kv_start"].tolist(), Sq=Sq,
            G=H // KH, rows=cut.rows, splits=cut.splits,
            min_pages=cut.min_pages, page=page, t_hi=t_hi)
        if used.tolist() != [[row] * KH for row in want]:
            raise RuntimeError(f"{name}: the kernel's splits a tile "
                               f"{used.tolist()} differ from the planner's")
        if not torch.equal(again, out):
            raise RuntimeError(f"{name}: two calls differ")
        tiles = [n for row in want for n in row]
        splits = max(tiles)
        split_hist = {str(n): tiles.count(n) for n in sorted(set(tiles))}
        err, tol, err_f32 = hold_paged(torch, pa, name, out, args, kw,
                                       design)
        if layout != "full":
            bad = _poisoned(ops, owned)
            out_p = pa.paged_attention(
                bad["q"], bad["k"], bad["v"], bad["pages"], bad["start"],
                bad["kv_start"], page=page, t_hi=t_hi,
                k_scale=bad["k_scale"], v_scale=bad["v_scale"])
            if not torch.equal(out_p, out):
                raise RuntimeError(
                    f"{name}: trash or unowned blocks changed the output")
        ms = time_cuda(torch, lambda: pa.paged_attention(*args, **kw), 50)
        plain_ms = time_cuda(
            torch, lambda: pa.paged_attention_reference(*args, **kw), 30)
        lib_ms = time_cuda(
            torch, lambda: _pa_library(torch, ops, page=page, t_hi=t_hi), 30)
        bound_ms, bound_by = _pa_bound(ops, page=page, t_hi=t_hi, Dh=Dh)
        row = {
            "case": name, "B": B, "Sq": Sq, "H": H, "KH": KH, "Dh": Dh,
            "page": page, "t_hi": t_hi, "q": _type_name(dtype),
            "kv": "int8" if quant else _type_name(dtype),
            "design": design, "splits": splits, "split_tiles": split_hist,
            "grid_splits": cut.splits,
            "max_abs_err": err, "tol": tol, "max_abs_err_vs_f32": err_f32,
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if name == "decode_bf16":
            # The yardstick's reading moves from run to run: time kernel
            # and yardstick again, each time on a pool made anew.
            del ops, args, out
            spread = []
            for _ in range(PA_SPREAD_RUNS):
                o2, _ = _pa_case(
                    torch, gen, B=B, Sq=Sq, H=H, KH=KH, Dh=Dh, page=page,
                    t_hi=t_hi, dtype=dtype, quant=quant, layout=layout,
                    dev=dev)
                a2 = (o2["q"], o2["k"], o2["v"], o2["pages"], o2["start"],
                      o2["kv_start"])
                spread.append({
                    "ms": time_cuda(
                        torch, lambda: pa.paged_attention(*a2, **kw), 50),
                    "library_ms": time_cuda(torch, lambda: _pa_library(
                        torch, o2, page=page, t_hi=t_hi), 30)})
                del o2, a2
            row["remade_pool_runs"] = spread
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


# -- phase 3b: flash attention against its plain version ---------------------

# file:line of each flash kernel's TPU original.
FLASH_KERNELS = {"flash_fwd": 111, "flash_bwd_dq": 165, "flash_bwd_dkv": 214}
FLASH_V2_KERNELS = {"flash_v2_fwd": 426, "flash_v2_bwd_dq": 482,
                    "flash_v2_bwd_dkv": 541}
ROPE_THETA = 10000.0
# Flash kernels against their plain versions.  Each kernel alone, on the
# same inputs as its plain version (reference_attention_lse's forward,
# reference_bwd_dq, reference_bwd_dkv): both compute in f32 and round
# their outputs once, so against the plain version in float32 on the same
# values an output may differ by half a step of its type plus summation
# order, |x - r| <= 2^-7 |r| + 1e-4 max|r| (float32: 1e-4 max|r|); against
# the plain version in the same type by one step of the largest value,
# max|x - r| <= 2^-6 max|r|.  The bf16 forwards (tensor cores) also round
# each probability to bf16 before the P.V product, which moves an output
# by at most 2^-8 sum_j p_j |v_j| / l (bf16's unit roundoff on each p_j):
# their out is held at 2^-7 |r| + 2^-8 (P.|V|) + 1e-4 max|r|, P.|V| being
# the float32 plain version's softmax applied to |v|.  The v1 bf16
# backward (tensor cores) rounds p before dv = p^T dO and ds before dq =
# ds k and dk = ds^T q, which moves dq, dk, dv by at most 2^-8 |dS||K|,
# 2^-8 |dS|^T|Q| and 2^-8 P^T|dO| (the same unit roundoff on each factor):
# those terms (reference_bwd_rounding, from _probs_ds of the float32
# values) are added to its limits the same way.  The v2 bf16 backward
# also takes its scores from the rotated q and k split into bf16 hi + lo
# halves (three products, off by at most 3 2^-16 scale sum_i |q_i k_i|),
# takes dS K and dS^T Q on the hi planes and rotates dq and dk back:
# reference_bwd_rounding_v2's terms (which are v1's at G 1 without rope).
# All three through autograd (out, lse and the gradients with a non-zero
# lse cotangent) against the autograd of the float32 plain version,
# relative to the largest value of each: 1e-4 in float32; in bf16 out
# 2^-7, lse 1e-5, gradients 2^-6 (the backward also takes delta from the
# bf16-rounded output).  The v2 kernels are held to the same limits:
# their plain versions rotate the f32-widened q and k with the same f32
# angle (position x exp(i c)) and the card's f32 exp/sin/cos, as the
# kernels do, so the rotation adds rounding only.
FLASH_SAME_TYPE_REL = 2.0 ** -6
FLASH_F32_RTOL, FLASH_F32_ATOL_REL = 2.0 ** -7, 1e-4
FLASH_P_ROUNDING = 2.0 ** -8
FLASH_E2E_REL = {"float32": {}, "bfloat16": {"out": 2.0 ** -7, "lse": 1e-5}}
FLASH_E2E_DEFAULT = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def _flash_flops(kind, B, H, S, D, causal) -> int:
    """Useful flops of one kernel call: the visible (query, key) pairs of
    the H query heads, 4 D (forward), 6 D (dq) or 8 D (dk/dv) each."""
    step = kind.removeprefix("flash_").removeprefix("v2_")
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return {"fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}[step] * D * pairs


def _flash_bound(kind, B, H, S, D, dtype, causal, KH=None):
    """Least time of one kernel call: its useful flops over the type's
    peak, against each input read once and each output written once over
    the memory rate (q, dO, out, dq at H heads; k, v, dk, dv at KH; lse,
    delta f32 rows).  v1 and v2 kernels alike."""
    step = kind.removeprefix("flash_").removeprefix("v2_")
    flops = _flash_flops(kind, B, H, S, D, causal)
    el = 2 if dtype == "bfloat16" else 4
    qm, kvm = B * H * S * D * el, B * (KH or H) * S * D * el
    rows = B * H * S * 4
    nbytes = {"fwd": 2 * qm + 2 * kvm + rows,             # q, k, v -> out, lse
              "bwd_dq": 3 * qm + 2 * kvm + 2 * rows,      # + dO, delta -> dq
              "bwd_dkv": 2 * qm + 4 * kvm + 2 * rows}[step]  # -> dk, dv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _sdpa_ms(torch, q, k, v, causal):
    """scaled_dot_product_attention forward, and its backward (fwd+bwd
    through autograd minus the fwd): yardsticks only, never called by the
    port.  The backward time stands against dq and dk/dv together.  K/V
    with fewer heads than q go in as they are (``enable_gqa``)."""
    import torch.nn.functional as F

    kw = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
    with torch.no_grad():
        fwd = time_cuda(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, **kw), 10)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    g = torch.ones_like(q)

    def both():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, **kw)
        torch.autograd.grad(o, (qg, kg, vg), g)

    return fwd, time_cuda(torch, both, 10) - fwd


def _flash_design(tname) -> str:
    """Which design of the flash kernels runs for an input type: every
    bf16 instance (v1 and v2, forward, dq and dk/dv) on the tensor cores
    (``cuda-mma``, csrc/flash_mma.cuh and csrc/flash_mma_bwd.cuh), every
    float32 one on the CUDA cores (``cuda-fma``)."""
    return "cuda-mma" if tname == "bfloat16" else "cuda-fma"


# The pre-pass against its plain version (reference_rope_split), each
# plane pair read back as hi + lo: each side holds the rotated value to
# 2^-16 of it (its split), so the two differ by at most 2^-15 of it, plus
# the rounding of the two f32 rotations, held at 2^-20 of the largest value
# (16 f32 ulps; a wrong angle or sign is off by O(1)).
ROPE_SPLIT_RTOL, ROPE_SPLIT_ATOL_REL = 2.0 ** -15, 2.0 ** -20


def _check_rope_split(fa, q, k, planes, theta, name) -> float:
    """Max abs error of the pre-pass's hi + lo against the plain
    version's, held at ROPE_SPLIT_RTOL |r| + ROPE_SPLIT_ATOL_REL max|r|."""
    plain = fa.reference_rope_split(q, k, theta)
    err = 0.0
    for lo_at, size in ((0, q.numel()), (2 * q.numel(), k.numel())):
        got, ref = (p[lo_at:lo_at + size].float()
                    + p[lo_at + size:lo_at + 2 * size].float()
                    for p in (planes, plain))
        diff = (got - ref).abs()
        err = max(err, float(diff.max()))
        limit = ROPE_SPLIT_RTOL * ref.abs() + ROPE_SPLIT_ATOL_REL * float(
            ref.abs().max())
        if not bool((diff <= limit).all()):
            raise RuntimeError(f"{name}: rope pre-pass vs plain version "
                               f"beyond {ROPE_SPLIT_RTOL}|r| + "
                               f"{ROPE_SPLIT_ATOL_REL} max|r| (max abs {err})")
    return err


def _max_rel(x, r):
    return float((x.float() - r.float()).abs().max() / r.float().abs().max())


def _counts(fa, launched: dict) -> dict:
    """Every flash kernel's launch count: those in ``launched``, 0 for the
    rest."""
    return {**dict.fromkeys(fa.launch_counts, 0), **launched}


def _flash_api(fa, causal, v2):
    """The kernel names, the kernels (forward, dq, dk/dv), their plain
    versions and the autograd entry of v1 (``v2`` None) or of v2 (``v2`` =
    (rope_theta, q_pipeline)), each taking (q, k, v) or (q, k, v, dO, lse,
    delta); the backward kernels also take v2's pre-pass ``planes``."""
    if v2 is None:
        return (tuple(FLASH_KERNELS),
                (lambda q, k, v: fa.flash_forward(q, k, v, causal),
                 lambda *a, planes=None: fa.flash_backward_dq(*a, causal),
                 lambda *a, planes=None: fa.flash_backward_dkv(*a, causal)),
                (lambda q, k, v: fa.reference_attention_lse(q, k, v, causal),
                 lambda *a: fa.reference_bwd_dq(*a, causal),
                 lambda *a: fa.reference_bwd_dkv(*a, causal)),
                lambda q, k, v: fa.flash_attention_lse(q, k, v, causal))
    theta, pipeline = v2
    return (tuple(FLASH_V2_KERNELS),
            (lambda q, k, v: fa.flash_v2_forward(q, k, v, causal, theta,
                                                 pipeline),
             lambda *a, planes=None: fa.flash_v2_backward_dq(
                 *a, causal, theta, pipeline, planes),
             lambda *a, planes=None: fa.flash_v2_backward_dkv(
                 *a, causal, theta, planes)),
            (lambda q, k, v: fa.reference_attention_v2_lse(q, k, v, causal,
                                                           theta),
             lambda *a: fa.reference_bwd_dq_v2(*a, causal, theta),
             lambda *a: fa.reference_bwd_dkv_v2(*a, causal, theta)),
            lambda q, k, v: fa.flash_attention_v2_lse(
                q, k, v, causal=causal, rope_theta=theta,
                q_pipeline=pipeline))


def check_flash_attention(torch, seed: int) -> list[dict]:
    cases = [
        # name, B, H, KH, S, D, dtype, causal, lse cotangent, timed
        ("flagship_bf16", 24, 8, 8, 2048, 128, "bfloat16", True, False, True),
        ("f32_b2", 2, 8, 8, 2048, 128, "float32", True, True, False),
        ("odd_s_bf16", 2, 8, 8, 1000, 128, "bfloat16", True, True, False),
        ("noncausal_f32", 2, 8, 8, 1000, 128, "float32", False, True, False),
        # Phase 4e's draft distillation: the draft trains at float32 (the
        # CUDA-core instances) and the target's forward runs bf16, both
        # at one 256-token row (no lse cotangent: the loss reads logits).
        ("distill_f32", 1, 8, 8, DISTILL_SEQ, 128, "float32", True, False,
         True),
        ("distill_bf16", 1, 8, 8, DISTILL_SEQ, 128, "bfloat16", True, False,
         True),
        RING_HOP_V1,
        TP_LOCAL_V1,
        PP_MICROBATCH_V1,
    ]
    return _flash_cases(torch, seed, [(c, None) for c in cases])


def check_flash_v2(torch, seed: int) -> list[dict]:
    """Phase 3c: every case with an lse cotangent and rope in the kernel."""
    cases = [
        # name, B, H, KH, S, D, dtype, causal, lse cotangent, timed; P
        (("train_gqa_bf16", 24, 8, 2, 2048, 128, "bfloat16", True, True,
          True), 2),
        (("bench_mha_bf16", 24, 8, 8, 2048, 128, "bfloat16", True, True,
          True), 2),
        (("f32_g4", 2, 8, 2, 2048, 128, "float32", True, True, False), 2),
        (("odd_s_g4_bf16", 2, 8, 2, 1000, 128, "bfloat16", True, True,
          False), 2),
        (("noncausal_p1_f32", 2, 8, 2, 1000, 128, "float32", False, True,
          False), 1),
        (("mqa_bf16", 2, 8, 1, 2048, 128, "bfloat16", True, True, False), 2),
    ]
    return _flash_cases(torch, seed + 5,
                        [(c, (ROPE_THETA, p)) for c, p in cases]
                        + [RING_HOP_V2, TP_LOCAL_V2])


# Phase 10's ring hops after hop 0, held in phase 3b and 3c: non-causal
# half-chunks of S / (2 sp) rows in bf16 with an lse cotangent (the
# merge's), matched heads on v1 and GQA on v2 (rope outside, P 1).
RING_HOP_V1 = ("ring_hop_bf16", 1, 8, 8, 1024, 128, "bfloat16", False, True,
               True)
RING_HOP_V2 = (("ring_hop_gqa_bf16", 1, 8, 2, 1024, 128, "bfloat16", False,
                True, True), (None, 1))


# Phase 11's kernels at the tp-local heads, held in phase 3b and 3c: a
# rank's v1 call in 11c (MoE, 8 heads over tp 2, the whole 4 x 2048
# batch: ep replicates it) and its v2 call in 11a (8 query and 2 KV heads
# over tp 2, one row a microbatch: 4 rows over dp 2 and 2 microbatches;
# rope in the kernels, P 2), causal with no lse cotangent, as training
# calls them.
TP_LOCAL_V1 = ("tp_local_bf16", 4, 4, 4, 2048, 128, "bfloat16", True, False,
               True)
TP_LOCAL_V2 = (("tp_local_gqa_bf16", 1, 4, 1, 2048, 128, "bfloat16", True,
                False, True), (ROPE_THETA, 2))


# Phase 12's v1 call, held in phase 3b: one row of a GPipe or 1F1B
# microbatch (12a, 12c: the flagship's 8 heads, causal bf16, no lse
# cotangent); 12b's v2 call is TP_LOCAL_V2's shape.
PP_MICROBATCH_V1 = ("pp_microbatch_bf16", 1, 8, 8, 2048, 128, "bfloat16",
                    True, False, True)


def check_ring_hops(torch, seed: int) -> list[dict]:
    """The ring-hop, tp-local and pipeline-microbatch cases alone
    (``tools/torch_parallel_check.py``)."""
    return _flash_cases(torch, seed, [(RING_HOP_V1, None), RING_HOP_V2,
                                      (TP_LOCAL_V1, None), TP_LOCAL_V2,
                                      (PP_MICROBATCH_V1, None)])


def _flash_cases(torch, seed, cases) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for case, v2 in cases:
        row = _flash_case(torch, gen, dev, *case, v2=v2)
        print(json.dumps(row), flush=True)
        results.append(row)
        _free(torch)
    return results


def _flash_case(torch, gen, dev, name, B, H, KH, S, D, tname, causal,
                with_glse, timed, v2=None) -> dict:
    from k8s_gpu_tpu_torch.ops import attention as fa

    dtype = getattr(torch, tname)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v, g = (rand(B, H, S, D), rand(B, KH, S, D), rand(B, KH, S, D),
                  rand(B, H, S, D))
    g_lse = (torch.randn((B, H, S), generator=gen, device=dev)
             if with_glse else torch.zeros((B, H, S), device=dev))
    row = {"case": name, "B": B, "H": H, "KH": KH, "S": S, "D": D,
           "dtype": tname, "causal": causal, "lse_cotangent": with_glse,
           "kernels": {}}
    if v2 is not None:
        row.update(rope_theta=v2[0], q_pipeline=v2[1])
    names, kernels, plains, entry = _flash_api(fa, causal, v2)

    # Each kernel alone against its plain version on the same inputs; the
    # v2 backward pair in bf16 shares one pre-pass, as in autograd.
    fa.reset_counts()
    out, lse = kernels[0](q, k, v)
    delta = ((g.float() * out.float()).sum(-1) - g_lse).contiguous()
    planes = fa._v2_planes(q, k, v2[0], None) if v2 is not None else None
    dq = kernels[1](q, k, v, g, lse, delta, planes=planes)
    dk, dv = kernels[2](q, k, v, g, lse, delta, planes=planes)
    torch.cuda.synchronize()
    if fa.launch_counts != _counts(fa, dict.fromkeys(names, 1)):
        raise RuntimeError(f"{name}: launches {fa.launch_counts}")
    prepasses = fa.prepass_counts["flash_v2_rope_split"]
    if prepasses != (2 if planes is not None else 0):
        raise RuntimeError(f"{name}: {prepasses} pre-pass launches")
    if planes is not None:
        row["rope_split_max_abs_err"] = _check_rope_split(fa, q, k, planes,
                                                          v2[0], name)
    plain = {
        names[0]: lambda *a: plains[0](*a[:3]),
        names[1]: lambda *a: (plains[1](*a, lse, delta),),
        names[2]: lambda *a: plains[2](*a, lse, delta),
    }
    got = {names[0]: (out, lse), names[1]: (dq,), names[2]: (dk, dv)}
    wide = [t.float() for t in (q, k, v, g)]
    # The tensor-core kernels' roundings of p (and ds, and v2's split and
    # hi-plane operands) to bf16, per output.
    rounding = {}
    if _flash_design(tname) == "cuda-mma":
        rounding[names[0]] = (FLASH_P_ROUNDING
                              * plains[0](*wide[:2], wide[2].abs())[0], 0.0)
        dq_t, dk_t, dv_t = (
            fa.reference_bwd_rounding(*wide, lse, delta, causal)
            if v2 is None else
            fa.reference_bwd_rounding_v2(*wide, lse, delta, causal, v2[0]))
        rounding.update({names[1]: (dq_t,), names[2]: (dk_t, dv_t)})
        del dq_t, dk_t, dv_t
    for kname in names:
        same = plain[kname](q, k, v, g)
        err = max(float((x.float() - r.float()).abs().max())
                  for x, r in zip(got[kname], same))
        for x, r in zip(got[kname], same):
            if not _max_rel(x, r) <= FLASH_SAME_TYPE_REL:
                raise RuntimeError(
                    f"{name} {kname}: kernel vs plain in {tname} "
                    f"{_max_rel(x, r)} of the largest value > "
                    f"{FLASH_SAME_TYPE_REL}")
        del same
        err32 = 0.0
        rtol = FLASH_F32_RTOL if tname == "bfloat16" else 0.0
        note = " + the rounding term" if kname in rounding else ""
        terms = rounding.pop(kname, (0.0,) * len(got[kname]))
        for x, r, term in zip(got[kname], plain[kname](*wide), terms):
            diff = (x.float() - r).abs()
            err32 = max(err32, float(diff.max()))
            limit = (rtol * r.abs() + FLASH_F32_ATOL_REL * r.abs().max()
                     + term)
            if not bool((diff <= limit).all()):
                raise RuntimeError(
                    f"{name} {kname}: kernel vs float32 plain version "
                    f"beyond {rtol}|r| + {FLASH_F32_ATOL_REL} max|r|"
                    f"{note} (max abs {float(diff.max())})")
        del terms
        row["kernels"][kname] = {"max_abs_err": err,
                                 "max_abs_err_vs_f32": err32}

    # All three through autograd, against the float32 plain version's.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o, l = entry(qg, kg, vg)
    torch.autograd.backward((o, l), (g, g_lse))
    q32, k32, v32 = (t.detach().requires_grad_() for t in wide[:3])
    o32, l32 = plains[0](q32, k32, v32)
    torch.autograd.backward((o32, l32), (wide[3], g_lse))
    e2e = {}
    for oname, x, r in (("out", o, o32), ("lse", l, l32),
                        ("dq", qg.grad, q32.grad), ("dk", kg.grad, k32.grad),
                        ("dv", vg.grad, v32.grad)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{name}: non-finite {oname}")
        e2e[oname] = _max_rel(x.detach(), r.detach())
        tol = FLASH_E2E_REL[tname].get(oname, FLASH_E2E_DEFAULT[tname])
        if not e2e[oname] <= tol:
            raise RuntimeError(f"{name}: autograd {oname} vs float32 plain "
                               f"{e2e[oname]} > {tol} of the largest value")
    row["autograd_rel_err_vs_f32"] = e2e
    del qg, kg, vg, q32, k32, v32, o, l, o32, l32, wide
    _free(torch)
    if not timed:
        return row

    # The library call on q and k rotated beforehand (the rotation is not
    # in its time).
    qr, kr = ((fa.rope_rotate(q, v2[0]), fa.rope_rotate(k, v2[0]))
              if v2 is not None and v2[0] is not None else (q, k))
    lib_fwd, lib_bwd = _sdpa_ms(torch, qr, kr, v, causal)
    del qr, kr
    args = {names[0]: (q, k, v), names[1]: (q, k, v, g, lse, delta),
            names[2]: (q, k, v, g, lse, delta)}
    kw = {names[0]: {}, names[1]: {"planes": planes},
          names[2]: {"planes": planes}}
    for kname, kernel, lib_ms in zip(names, kernels,
                                     (lib_fwd, lib_bwd, lib_bwd)):
        with torch.no_grad():
            ms = time_cuda(torch, lambda: kernel(*args[kname], **kw[kname]),
                           10, warmup=2)
            plain_ms = time_cuda(torch, lambda: plain[kname](q, k, v, g), 3,
                                 warmup=1)
        bound_ms, bound_by = _flash_bound(kname, B, H, S, D, tname, causal,
                                          KH)
        flops = _flash_flops(kname, B, H, S, D, causal)
        row["kernels"][kname].update(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound_ms,
                                     bound_by=bound_by,
                                     tflops=flops / ms / 1e9,
                                     design=_flash_design(tname))
    if planes is not None:
        # The pre-pass alone: once per forward and once per backward.
        row["rope_split_ms"] = time_cuda(
            torch, lambda: fa.flash_v2_rope_split(q, k, v2[0]), 10, warmup=2)
    return row


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _syncer(torch, dev):
    """Wait for the card; nothing to wait for on the CPU (rehearsals)."""
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


# -- phase 4: the main path ---------------------------------------------------

# (prompt tokens, max_new) of a mixed serving mix, short chat turns to long
# documents (the reference benchmark's paged-pool traffic).
TRAFFIC = [(33, 48), (120, 64), (500, 128), (1000, 200),
           (64, 32), (250, 96), (33, 48), (700, 150)]
PAGE = 64
LAYERS = 16   # the flagship's full depth


def flagship_config(torch, layers: int):
    from k8s_gpu_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=16384, d_model=1024, n_layers=layers, n_heads=8,
        n_kv_heads=0, d_head=128, d_ff=4096, max_seq=2048,
        dtype=torch.bfloat16, attn_impl="paged_kernel",
    )


def mix_blocks(cfg) -> int:
    """Phase 4's paged pool: the TRAFFIC mix's pages at their buckets plus
    8 (the pair's shared prefix needs few more), at least one
    max-length request and the trash block."""
    from k8s_gpu_tpu_torch.serve.scheduler import prompt_bucket

    used = sum(-(-(prompt_bucket(p, cfg.max_seq) + n) // PAGE) * PAGE
               for p, n in TRAFFIC)
    return max(1 + cfg.max_seq // PAGE, used // PAGE + 8)


def flagship_tokenizer(vocab_size: int):
    """BPE trained on the repo's README, then extended with byte-pair
    merges up to the model's vocabulary so every id a random-weight model
    emits decodes to text."""
    from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer

    with open(os.path.join(ROOT, "README.md"), "rb") as fh:
        text = fh.read()[:6000]
    merges = BpeTokenizer.train(text, 384).merges
    k = 0
    while 256 + len(merges) < vocab_size:
        merges.append((k % 256, (k // 256) % 256))
        k += 1
    return BpeTokenizer(merges)


def _post(port: int, path: str, body: dict, timeout: float = 600.0,
          headers: dict | None = None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _stream(port: int, body: dict, out: dict, timeout: float = 600.0,
            headers: dict | None = None, started=None):
    """POST /generate with "stream": true; records the ids, the client's
    time to first token and the end time into ``out``.  ``started``: an
    event set at the first token."""
    t0 = time.perf_counter()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    ids, ttft, summary = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            ev = json.loads(line)
            if "id" in ev:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                    if started is not None:
                        started.set()
                ids.append(ev["id"])
            else:
                summary = ev
    out.update(ids=ids, ttft_s=ttft, t_end=time.perf_counter(),
               summary=summary)


def _serve_together(port: int, jobs) -> list[dict]:
    """Stream every (prompt ids, max_new) of ``jobs`` from /generate at
    once, one client thread each."""
    return _stream_bodies(port, [{"prompt_ids": p, "max_new_tokens": n}
                                 for p, n in jobs])


def _stream_bodies(port: int, bodies) -> list[dict]:
    """Stream every /generate body at once, one client thread each."""
    outs = [dict() for _ in bodies]
    threads = [threading.Thread(target=_stream, args=(port, body, o))
               for body, o in zip(bodies, outs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    return outs


def _check_budgets(outs, budgets) -> None:
    """Every request got its budget and ended normally (an HTTP stream's
    summary says done; a batcher handle was not aborted)."""
    for i, (o, n) in enumerate(zip(outs, budgets)):
        done = (o.get("summary") or {}).get("done", not o.get("aborted"))
        if len(o.get("ids", [])) != n or not done:
            raise RuntimeError(
                f"request {i}: {len(o.get('ids', []))} of {n} tokens, "
                f"summary {o.get('summary')}")


def _serving_jobs(torch, rng, vocab: int, prefix):
    """The pair sharing ``prefix`` and the TRAFFIC mix, ids drawn from
    ``rng``."""
    def ids(n):
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    pair = [(prefix + ids(40), 64), (prefix + ids(90), 64)]
    return pair, [(ids(p), n) for p, n in TRAFFIC]


def _burst_numbers(outs, wall: float) -> dict:
    n_tok = sum(len(o["ids"]) for o in outs)
    ttfts = sorted(o["ttft_s"] for o in outs)
    return {"requests": len(outs), "generated_tokens": n_tok,
            "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_s_p50": ttfts[len(ttfts) // 2], "ttft_s_max": ttfts[-1]}


# Device kernels by class, by substrings of their names (first match).
PROFILE_CLASSES = (
    ("flash_fwd", ("flash_fwd",)), ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_v2_rope_split", ("flash_v2_rope_split",)),
    ("flash_v2_fwd", ("flash_v2_fwd",)),
    ("flash_v2_bwd_dq", ("flash_v2_bwd_dq",)),
    ("flash_v2_bwd_dkv", ("flash_v2_bwd_dkv",)),
    ("paged_attention", ("paged_attention",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    # Gathers, scatters and scans: the MoE dispatch's index copies and
    # slot cumsum, the embedding gather, the paged pool's writes.
    ("index_scan", ("index", "scan")),
)


def _start_profile(torch):
    """A torch.profiler over host and card, entered: __exit__ it."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _profile_summary(torch, prof, wall_s: float, ranges=()) -> dict:
    """Device busy share and the largest items of a profiled window: the
    kernels by device time and the host operators by self CPU time.
    ``ranges``: names of ``record_function`` ranges, whose spans on the
    device timeline are not kernels."""
    kernels, host = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if e.key in ranges:
            continue
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels.append((dev_us, e.key, e.count))
        else:
            host.append((e.self_cpu_time_total, e.key, e.count))
    busy_ms = sum(k[0] for k in kernels) / 1e3
    by_class: dict[str, float] = {}
    for dev_us, key, _ in kernels:
        cls = next((c for c, marks in PROFILE_CLASSES
                    if any(m in key.lower() for m in marks)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "device_ms_by_class": by_class,
        "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3}
                        for t, n, c in sorted(kernels, reverse=True)[:12]],
        "top_host_ops": [{"name": n[:120], "count": c, "self_ms": t / 1e3}
                         for t, n, c in sorted(host, reverse=True)[:12]],
    }


def run_main_path(torch, seed: int, layers: int, device="cuda",
                  profile: bool = False) -> dict:
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import LmServer
    from k8s_gpu_tpu_torch.utils.compat import xla_compile_count

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    tok = flagship_tokenizer(cfg.vocab_size)
    rng = torch.Generator().manual_seed(seed)
    n_blocks = mix_blocks(cfg)
    prefix = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    pair, mix = _serving_jobs(torch, rng, cfg.vocab_size, prefix)

    srv = LmServer(model, params, tok, slots=8, paged_blocks=n_blocks,
                   page_size=PAGE, attn_impl="paged_kernel",
                   max_new_tokens_cap=256, device=device).start()
    try:
        code, tk = _post(srv.port, "/tokenize", {"text": "serve the pool"})
        if code != 200 or not tk["ids"]:
            raise RuntimeError(f"/tokenize failed: {code} {tk}")
        sync()
        prof = _start_profile(torch) if profile else None
        pa.reset_counts()
        t0 = time.perf_counter()
        # The pair's first request registers the shared prefix blocks;
        # the rest, the pair's second among them, then arrive together.
        first = {}
        _stream(srv.port, {"prompt_ids": pair[0][0],
                           "max_new_tokens": pair[0][1]}, first)
        # After that warm-up the burst builds no kernel library.
        compiles = xla_compile_count()
        jobs = mix + [pair[1]]
        outs = _serve_together(srv.port, jobs)
        sync()
        wall = time.perf_counter() - t0
        compiles = xla_compile_count() - compiles
        launches, fallbacks = pa.launch_count, pa.fallback_count
        if prof is not None:
            prof.__exit__(None, None, None)
            profiled = _profile_summary(torch, prof, wall)
        admissions = dict(srv.batcher.admission_paths)
        rounds = srv.batcher._round_count
        outs = [first] + outs
        _check_budgets(outs, [pair[0][1]] + [n for _, n in jobs])
        if admissions.get("paged_shared", 0) < 1:
            raise RuntimeError(f"no shared-prefix admission: {admissions}")
        # The same greedy request twice more, alone: the same stream.  (In
        # bf16 a row's numbers depend on the batch it shares — the matrix
        # products pick kernels by batch size — so the stream it gave
        # inside the mix is compared by its common prefix only.)
        again = []
        for _ in range(2):
            code, body = _post(srv.port, "/generate",
                               {"prompt_ids": mix[1][0],
                                "max_new_tokens": mix[1][1]})
            if code != 200:
                raise RuntimeError(f"repeated request failed: {code}")
            again.append(body["ids"])
        if again[0] != again[1]:
            raise RuntimeError("a repeated greedy request changed its stream")
        in_mix = outs[2]["ids"]
        common = next((i for i, (a, b) in enumerate(zip(in_mix, again[0]))
                       if a != b), len(in_mix))
        code, text = _post(srv.port, "/generate",
                           {"prompt": "the pool serves", "max_new_tokens": 8,
                            "temperature": 0.8, "top_p": 0.9, "seed": 7})
        if code != 200 or len(text["ids"]) != 8:
            raise RuntimeError(f"sampled text request failed: {code}")
    finally:
        srv.stop()
    if launches <= 0 or fallbacks != 0:
        raise RuntimeError(f"paged_attention launches {launches}, "
                           f"fall-backs {fallbacks} on the main path")
    if compiles:
        raise RuntimeError(f"the steady burst built {compiles} kernel "
                           "libraries (xla_compiles_total)")
    extra = {"profile": profiled} if profile else {}
    return {**extra, **_burst_numbers(outs, wall),
        "layers": layers, "burst_compiles": compiles,
        "rounds": rounds, "admissions": admissions,
        "repeat_common_prefix_with_mix": common,
        "paged_attention_launches": launches,
        "paged_attention_fallbacks": fallbacks, "paged_blocks": n_blocks,
    }


# -- phase 4b: the dense pool, the reference's default deployment ------------

def _prefix_text(tok, n: int = 512) -> str:
    """Text from the README that the tokenizer encodes to exactly ``n``
    ids (what ``/precache`` takes is text)."""
    with open(os.path.join(ROOT, "README.md"), "rb") as fh:
        ids = tok.encode(fh.read()[:8000].decode("ascii", "ignore"))
    for k in range(n, min(ids.size, n + 64)):
        text = tok.decode(ids[:k].tolist())
        if tok.encode(text).size == n:
            return text
    raise RuntimeError(f"no README prefix encodes to {n} ids")


def run_dense_path(torch, seed: int, layers: int, device="cuda",
                   profile: bool = False) -> dict:
    """The flagship behind ``LmServer`` with its defaults: the dense pool
    [L, 8, KH, max_seq, Dh].  A solo request on the idle server (the
    fused cold start), then ``/precache`` of a 512-token prefix, then
    the prefix itself (``prefix_exact``), its pair (``prefix_suffix``)
    and the TRAFFIC mix (``cold``) together.  Every request must get its
    budget, every path must appear, a repeated greedy request must keep
    its stream, and no paged kernel runs."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import LmServer

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    tok = flagship_tokenizer(cfg.vocab_size)
    text = _prefix_text(tok)
    prefix = tok.encode(text).tolist()
    pair, mix = _serving_jobs(torch, torch.Generator().manual_seed(seed + 2),
                              cfg.vocab_size, prefix)
    repeat = {"prompt_ids": mix[1][0], "max_new_tokens": mix[1][1]}
    srv = LmServer(model, params, tok, slots=8, max_new_tokens_cap=256,
                   device=device).start()
    try:
        if srv.batcher.paged:
            raise RuntimeError("LmServer's default is not the dense pool")
        sync()
        pa.reset_counts()
        solo = {}
        t0 = time.perf_counter()
        _stream(srv.port, repeat, solo)
        solo_s = time.perf_counter() - t0
        paths = dict(srv.batcher.admission_paths)
        if paths != {"cold_fused": 1}:
            raise RuntimeError(f"the solo request took {paths}")
        code, body = _post(srv.port, "/precache", {"prompt": text})
        if code != 200 or body.get("cached_tokens") != len(prefix):
            raise RuntimeError(f"/precache: {code} {body}")
        code, body = _post(srv.port, "/precache", {"prompt": ""})
        if code != 400:
            raise RuntimeError(f"/precache of an empty prompt gave {code}")
        jobs = [(prefix, 64)] + pair + mix
        prof = _start_profile(torch) if profile else None
        rounds0 = srv.batcher._round_count
        t1 = time.perf_counter()
        outs = _serve_together(srv.port, jobs)
        sync()
        wall = time.perf_counter() - t1
        if prof is not None:
            prof.__exit__(None, None, None)
        rounds = srv.batcher._round_count - rounds0
        _check_budgets([solo] + outs, [mix[1][1]] + [n for _, n in jobs])
        again = [_post(srv.port, "/generate", repeat)[1]["ids"]
                 for _ in range(2)]
        admissions = dict(srv.batcher.admission_paths)
    finally:
        srv.stop()
    for path in ("cold_fused", "cold", "prefix_suffix", "prefix_exact"):
        if admissions.get(path, 0) < 1:
            raise RuntimeError(f"no {path} admission: {admissions}")
    if not again[0] == again[1] == solo["ids"]:
        raise RuntimeError("a repeated greedy request changed its stream")
    if pa.launch_count or pa.fallback_count:
        raise RuntimeError("the dense pool went through the paged kernel")
    extra = {"profile": _profile_summary(torch, prof, wall)} if profile \
        else {}
    return {**extra, **_burst_numbers(outs, wall),
            "layers": layers, "solo_request_s": solo_s,
            "solo_ttft_s": solo["ttft_s"], "rounds": rounds,
            "admissions": admissions, "prefix_tokens": len(prefix)}


# -- phase 4c: the unshared paged pool through the paged kernel ---------------

def _consume(handle, t0: float, out: dict) -> None:
    ids, ttft = [], None
    for tok in handle:
        if ttft is None:
            ttft = time.perf_counter() - t0
        ids.append(tok)
    out.update(ids=ids, ttft_s=ttft, aborted=handle.aborted)


def run_unshared_paged_path(torch, seed: int, layers: int, device="cuda",
                            profile: bool = False) -> dict:
    """The flagship on the paged pool with ``prefix_cache=False`` (the
    reference's replay A/B candidate) and the paged kernel, through
    ``ContinuousBatcher``: the pair and the TRAFFIC mix together.  Every
    admission is a left-padded prefill spliced into fresh blocks, so
    rows decode with kv_start = pad (324 for the 700-token prompt) and
    RoPE positions behind their cache positions.  Every request must get
    its budget and be admitted ``cold``, the kernel must launch, and
    nothing may fall back."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher
    from k8s_gpu_tpu_torch.serve.scheduler import prompt_bucket

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    rng = torch.Generator().manual_seed(seed + 3)
    prefix = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    pair, mix = _serving_jobs(torch, rng, cfg.vocab_size, prefix)
    jobs = pair + mix
    used = sum(-(-(prompt_bucket(len(p), cfg.max_seq) + n) // PAGE)
               for p, n in jobs)
    n_blocks = max(1 + cfg.max_seq // PAGE, used + 1)
    b = ContinuousBatcher(model, params, slots=8, paged_blocks=n_blocks,
                          page_size=PAGE, attn_impl="paged_kernel",
                          prefix_cache=False, device=device).start()
    try:
        sync()
        prof = _start_profile(torch) if profile else None
        pa.reset_counts()
        t0 = time.perf_counter()
        handles = [b.submit(p, max_new_tokens=n) for p, n in jobs]
        outs = [dict() for _ in jobs]
        threads = [threading.Thread(target=_consume, args=(h, t0, o))
                   for h, o in zip(handles, outs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        sync()
        wall = time.perf_counter() - t0
        launches, fallbacks = pa.launch_count, pa.fallback_count
        if prof is not None:
            prof.__exit__(None, None, None)
        admissions = dict(b.admission_paths)
        rounds = b._round_count
    finally:
        b.stop()
    _check_budgets(outs, [n for _, n in jobs])
    if admissions != {"cold": len(jobs)}:
        raise RuntimeError(f"admissions {admissions}: not all cold")
    if device != "cpu" and (launches <= 0 or fallbacks != 0):
        raise RuntimeError(f"paged_attention launches {launches}, "
                           f"fall-backs {fallbacks} on the unshared pool")
    extra = {"profile": _profile_summary(torch, prof, wall)} if profile \
        else {}
    return {**extra, **_burst_numbers(outs, wall),
            "layers": layers, "rounds": rounds, "admissions": admissions,
            "paged_attention_launches": launches,
            "paged_attention_fallbacks": fallbacks, "paged_blocks": n_blocks,
            "left_pad_of_700": prompt_bucket(700, cfg.max_seq) - 700}


# -- phase 4d: the fleet contract, two replicas on the one card -------------

FLEET_BLOCKS = 72
FLEET_NEW = 32        # tokens of each X and Y request
FLEET_STREAM = 256    # the migrating stream's budget
FLEET_CUT_ROUND = 2   # A's round length while that stream is cut


class _Ledger:
    """Every request the phase sends, by replica: its trace id (sent as
    ``traceparent``) and the ids the client received (None for
    ``/prefill``, whose client receives a payload)."""

    def __init__(self):
        from k8s_gpu_tpu_torch.utils.tracing import (
            SpanContext, format_traceparent, new_span_id, new_trace_id,
        )

        self._ctx = lambda: SpanContext(new_trace_id(), new_span_id())
        self._fmt = format_traceparent
        self.sent: dict[str, list] = {}

    def headers(self, replica: str, extra: dict | None = None):
        """Headers for one request to ``replica``, and its entry (the
        caller fills in ``ids``)."""
        ctx = self._ctx()
        entry = {"trace_id": ctx.trace_id, "ids": None}
        self.sent.setdefault(replica, []).append(entry)
        return {"traceparent": self._fmt(ctx), **(extra or {})}, entry

    def check(self, servers, golden_hash) -> dict:
        """One journal record a request, and its golden hash that of the
        ids the client received; no record without a request."""
        counts = {}
        for name, srv in servers.items():
            recs = srv.journal.snapshot(limit=1000)
            sent = self.sent.get(name, [])
            if len(recs) != len(sent):
                raise RuntimeError(f"{name}: {len(recs)} journal records "
                                   f"for {len(sent)} requests")
            for entry in sent:
                mine = [r for r in recs if r["trace_id"] == entry["trace_id"]]
                if len(mine) != 1:
                    raise RuntimeError(f"{name}: {len(mine)} records for "
                                       f"trace {entry['trace_id']}")
                if (entry["ids"] is not None
                        and mine[0]["golden_hash"]
                        != golden_hash(entry["ids"])):
                    raise RuntimeError(f"{name}: golden hash of trace "
                                       f"{entry['trace_id']} is not the "
                                       "client's stream's")
            counts[name] = len(recs)
        return counts


def _fleet_stream(port, ledger, replica, body, started=None, extra=None):
    """A traced streaming /generate; returns the client's view."""
    headers, entry = ledger.headers(replica, extra)
    out: dict = {}
    _stream(port, body, out, headers=headers, started=started)
    entry["ids"] = out["ids"]
    return out


def _fleet_post(port, ledger, replica, path, body, extra=None):
    headers, entry = ledger.headers(replica, extra)
    code, out = _post(port, path, body, headers=headers)
    if path == "/generate":
        entry["ids"] = out.get("ids", [])
    return code, out


def _admin(port, path, body):
    """An admin call that must succeed; returns (body, ms)."""
    t0 = time.perf_counter()
    code, out = _post(port, path, body)
    ms = (time.perf_counter() - t0) * 1e3
    if code != 200:
        raise RuntimeError(f"{path}: {code} {out}")
    return out, ms


def _in_background(fn, *args, **kw):
    th = threading.Thread(target=fn, args=args, kwargs=kw)
    th.start()
    return th


def _wait_inflight(srv, want_busy: bool, timeout: float = 600.0) -> None:
    t_end = time.time() + timeout
    while (srv.batcher.inflight_requests > 0) != want_busy:
        if time.time() > t_end:
            raise RuntimeError(f"{srv.name}: in-flight never "
                               f"{'> 0' if want_busy else '0'}")
        time.sleep(0.005)


def _set_rounds(batcher, steps: int) -> None:
    """A batcher's round length and its solo ladder, as its constructor
    derives them from ``steps_per_round``.  Between requests only."""
    batcher.steps_per_round = steps
    batcher.solo_buckets = [steps * m for m in (1, 2, 3, 4, 6, 8)]


def run_fleet_path(torch, seed: int, layers: int, device="cuda") -> dict:
    """Two of the port's ``LmServer``s, A and B, on the one card, each on
    the paged pool (72 blocks of 64, the paged kernel), driven over HTTP
    through the reference's fleet contract: A serves X (a 512-token
    prefix and a short suffix) cold and then warm; its chain moves to B
    (``/admin/export`` -> ``/admin/import``: as many blocks as A
    registered); B serves X from the moved blocks (the same stream as
    A's warm one; a prefix hit; paged launches, counted just around this
    request); B's re-export holds A's bytes; a 256-token stream on A is
    cut by an export (the migrated summary) and resumed on B (the two
    parts hold the budget); A, flipped to the prefill role (409 while a
    request is in flight), prefills Y for B with no decode step, and
    B's stream of Y equals A's once A is flipped back; ``x-request-
    deadline-ms`` of 0 and a deadline too short for a queued request
    answer 504; and each request has one journal record whose golden
    hash is that of what its client received."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import LmServer
    from k8s_gpu_tpu_torch.serve.journal import golden_hash
    from k8s_gpu_tpu_torch.serve.migrate import payload_bytes
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    tok = flagship_tokenizer(cfg.vocab_size)
    rng = torch.Generator().manual_seed(seed + 4)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    x, y, z = ids(512) + ids(24), ids(512) + ids(24), ids(100)
    servers = {name: LmServer(
        model, params, tok, slots=8, paged_blocks=FLEET_BLOCKS,
        page_size=PAGE, attn_impl="paged_kernel", max_new_tokens_cap=256,
        metrics=MetricsRegistry(), name=name,
        device=device).start() for name in ("fleet-a", "fleet-b")}
    a, b = servers["fleet-a"], servers["fleet-b"]
    a_rounds = a.batcher.steps_per_round
    led = _Ledger()
    out: dict = {"gpu": gpu_line() if device != "cpu" else "cpu"}
    try:
        # 1. A serves X cold, then warm (a prefix hit).
        a_cold = _fleet_stream(a.port, led, a.name,
                               {"prompt_ids": x, "max_new_tokens": FLEET_NEW})
        a_warm = _fleet_stream(a.port, led, a.name,
                               {"prompt_ids": x, "max_new_tokens": FLEET_NEW})
        if dict(a.batcher.admission_paths) != {"paged_cold": 1,
                                               "paged_shared": 1}:
            raise RuntimeError(f"A's admissions of X: "
                               f"{dict(a.batcher.admission_paths)}")
        # 2. X's chain moves from A to B.
        payload, export_ms = _admin(a.port, "/admin/export", {})
        registered = len(a.chain_state()["chains"])
        moved, import_ms = _admin(b.port, "/admin/import", payload)
        if not moved["imported"] == len(payload["blocks"]) == registered:
            raise RuntimeError(f"imported {moved['imported']} of "
                               f"{len(payload['blocks'])} blocks, A "
                               f"registered {registered}")
        # 3. B serves X from the moved blocks: A's warm stream.
        pa.reset_counts()
        b_warm = _fleet_stream(b.port, led, b.name,
                               {"prompt_ids": x, "max_new_tokens": FLEET_NEW})
        launches, fallbacks = pa.launch_count, pa.fallback_count
        if b_warm["ids"] != a_warm["ids"]:
            raise RuntimeError("B's stream of X is not A's warm stream")
        if b.batcher.metrics.counter("serve_prefix_cache_hits_total") < 1:
            raise RuntimeError("B's admission of X missed the moved chain")
        if device != "cpu" and (launches <= 0 or fallbacks != 0):
            raise RuntimeError(f"paged_attention launches {launches}, "
                               f"fall-backs {fallbacks} on B")
        # 4. B's re-export holds A's bytes.
        again, _ = _admin(b.port, "/admin/export", {})
        back = {e["hash"]: e["data"] for e in again["blocks"]}
        if any(back.get(e["hash"]) != e["data"] for e in payload["blocks"]):
            raise RuntimeError("B's re-export differs from A's payload")
        # 6 (before 5: A's pool then holds X and the stream's page, a
        # short export).  A 256-token stream on A, cut by an export and
        # resumed on B.  A's default rounds (a solo row up to 64 steps,
        # two rounds in flight) would finish the stream before the cut;
        # rounds of 2 steps (a solo row up to 16) keep its in-flight
        # tail short of the budget, for this step only.
        _set_rounds(a.batcher, FLEET_CUT_ROUND)
        started = threading.Event()
        cut: dict = {}
        th = _in_background(lambda: cut.update(_fleet_stream(
            a.port, led, a.name,
            {"prompt_ids": z, "max_new_tokens": FLEET_STREAM},
            started=started)))
        if not started.wait(600):
            raise RuntimeError("the stream on A never started")
        mid, mid_export_ms = _admin(a.port, "/admin/export", {})
        _, mid_import_ms = _admin(b.port, "/admin/import", mid)
        aborted, _ = _admin(a.port, "/admin/export",
                            {"abort_live": True, "include_blocks": False})
        th.join(600)
        if cut.get("summary") != {"done": False, "error": "migrated",
                                  "resume": True}:
            raise RuntimeError(f"A's stream ended {cut.get('summary')} "
                               f"after {len(cut.get('ids', []))} tokens")
        rest = _fleet_stream(
            b.port, led, b.name,
            {"prompt_ids": z + cut["ids"],
             "max_new_tokens": FLEET_STREAM - len(cut["ids"])},
            extra={"x-migrated-from": a.name})
        if (len(cut["ids"]) + len(rest["ids"]) != FLEET_STREAM
                or not rest["summary"].get("done")
                or aborted["aborted"] != 1):
            raise RuntimeError(f"migrated stream: {len(cut['ids'])} + "
                               f"{len(rest['ids'])} tokens, aborted "
                               f"{aborted['aborted']}")
        if b.batcher.metrics.counter("serve_resumed_requests_total") != 1:
            raise RuntimeError("B did not count the resumed request")
        marks = [(srv, key) for srv, key in ((a, "migrated"),
                                             (b, "migrated_from"))
                 if not any(key in r.get("extra", {})
                            for r in srv.journal.snapshot(limit=100))]
        if marks:
            raise RuntimeError(f"no {marks[0][1]} record on "
                               f"{marks[0][0].name}")
        _set_rounds(a.batcher, a_rounds)
        # 5. Disaggregated prefill: A as prefill worker for B.
        busy = _in_background(_fleet_stream, a.port, led, a.name,
                              {"prompt_ids": ids(48), "max_new_tokens": 64})
        _wait_inflight(a, True)
        code, _ = _post(a.port, "/admin/role", {"role": "prefill"})
        busy.join(600)
        if code != 409:
            raise RuntimeError(f"role flip with a request in flight: {code}")
        _wait_inflight(a, False)
        _admin(a.port, "/admin/role", {"role": "prefill"})
        steps = a.batcher.steps_taken
        t0 = time.perf_counter()
        code, pre = _fleet_post(a.port, led, a.name, "/prefill",
                                {"prompt_ids": y})
        if code != 200:
            raise RuntimeError(f"/prefill: {code} {pre}")
        handed, _ = _admin(b.port, "/admin/import", pre)
        handover_ms = (time.perf_counter() - t0) * 1e3
        if a.batcher.steps_taken != steps or handed["imported"] != 8:
            raise RuntimeError(f"prefill worker took "
                               f"{a.batcher.steps_taken - steps} decode "
                               f"rounds; B imported {handed['imported']}")
        b_y = _fleet_stream(b.port, led, b.name,
                            {"prompt_ids": y, "max_new_tokens": FLEET_NEW})
        _admin(a.port, "/admin/role", {"role": "both"})
        a_y = _fleet_stream(a.port, led, a.name,
                            {"prompt_ids": y, "max_new_tokens": FLEET_NEW})
        if b_y["ids"] != a_y["ids"]:
            raise RuntimeError("B's stream of Y is not A's")
        # 7. Deadlines: 0 at the door; too short for a queued request.
        code, _ = _fleet_post(b.port, led, b.name, "/generate",
                              {"prompt_ids": z, "max_new_tokens": 8},
                              extra={"x-request-deadline-ms": "0"})
        if code != 504:
            raise RuntimeError(f"deadline 0: {code}")
        busy = _in_background(_fleet_stream, b.port, led, b.name,
                              {"prompt_ids": ids(48), "max_new_tokens": 128})
        _wait_inflight(b, True)
        code, _ = _fleet_post(b.port, led, b.name, "/generate",
                              {"prompt_ids": z, "max_new_tokens": 8},
                              extra={"x-request-deadline-ms": "1"})
        busy.join(600)
        if code != 504:
            raise RuntimeError(f"queued request past its deadline: {code}")
        shed = [r for r in b.journal.snapshot(limit=100)
                if r["reason"] == "deadline"]
        if len(shed) != 2:
            raise RuntimeError(f"{len(shed)} deadline records on B")
        # 8. The journal: one record a request, the client's hash.
        records = led.check(servers, golden_hash)
    finally:
        for srv in servers.values():
            srv.stop()
    out.update({
        "layers": layers,
        "chain_blocks": registered,
        "export_ms": export_ms, "import_ms": import_ms,
        "payload_mb": len(payload_bytes(payload)) / 1e6,
        "ttft_s_a_cold": a_cold["ttft_s"], "ttft_s_a_warm": a_warm["ttft_s"],
        "ttft_s_b_from_moved_blocks": b_warm["ttft_s"],
        "paged_attention_launches": launches,
        "paged_attention_fallbacks": fallbacks,
        "rounds": {"ttft": a_rounds, "migrating_stream": FLEET_CUT_ROUND},
        "stream_cut_after": len(cut["ids"]),
        "stream_export_ms": mid_export_ms, "stream_import_ms": mid_import_ms,
        "stream_blocks": len(mid["blocks"]),
        "prefill_handover_ms": handover_ms,
        "journal_records": records,
    })
    return out


# -- phase 4e: speculative serving -------------------------------------------

# The reference bench's speculative probes.  spec_batcher_probe
# (bench.py:1989-2080): a draft distilled on the serving prompt's greedy
# trajectory, four requests of 160 tokens on the dense pool.
# cb_paged_spec_tokens_per_s (bench.py:851-872): eight requests over one
# shared 1024-token prefix on 49 paged blocks of 64, 48 tokens each.
SPEC_PROMPT = [3, 5, 7, 11, 13]
SPEC_NEW = 160
SPEC_K = 4
SPEC_DISTILL_STEPS = 1500
DISTILL_SEQ = 256   # the bench's distillation length (bench.py:2011-2024)
SPEC_PAGED_BLOCKS = 49
SPEC_PAGED_NEW = 48
# Greedy identity: a spec stream equals the plain stream of the same
# request, except that it may first depart where the plain logits' top-2
# gap is under this limit.  bf16: the verify reads a K+1 window through
# other matrix-product shapes than decode's one row, and two such reads
# of a bf16 model differ by up to LOGIT_TOL after 16 layers (phase 5);
# float32: summation order only.
BF16_TIE_GAP = 0.25
F32_TIE_GAP = 1e-4


def _spec_prefix(tag: int) -> list:
    """The bench's shared 1024-token prompt (bench.py:819-821)."""
    return [(j * 17 + tag * 131 + 3) % 120 + 2 for j in range(1024)]


def _run_handles(b, jobs) -> list:
    """Submit every (prompt, max_new) at once; their streams, each with
    its budget checked."""
    hs = [b.submit(p, max_new_tokens=n) for p, n in jobs]
    outs = [h.result() for h in hs]
    for h, out, (_, n) in zip(hs, outs, jobs):
        if len(out) != n or h.aborted:
            raise RuntimeError(f"{len(out)} of {n} tokens "
                               f"(aborted {h.aborted})")
    return outs


def _best_rate(torch, sync, run_once, trials: int = 3):
    """The bench's best-of-N tokens/s (bench.py:156): ``run_once`` returns
    the streams; (tokens/s of the fastest trial, its streams, the trial
    seconds)."""
    best, outs, times = None, None, []
    for _ in range(trials):
        sync()
        t0 = time.perf_counter()
        outs = run_once()
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        best = dt if best is None else min(best, dt)
    return sum(len(o) for o in outs) / best, outs, times


def _departures(torch, engine, params, jobs, plain, spec, limit) -> list:
    """Where each spec stream first departs from the plain stream of the
    same request, with the plain logits' top-2 gap there (the plain
    engine's prefill over the prompt and the plain stream before it).
    Raises when a gap is not under ``limit``."""
    found = []
    for i, ((prompt, _), a, b) in enumerate(zip(jobs, plain, spec)):
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        seq = torch.tensor([list(prompt) + list(a[:d])], dtype=torch.int32,
                           device=engine.device)
        _, logits = engine.prefill(params, seq)
        top = torch.topk(logits[0].float(), 2).values
        gap = float(top[0] - top[1])
        found.append({"request": i, "position": d, "gap": gap})
        if not gap < limit:
            raise RuntimeError(
                f"request {i}: spec departs from plain at token {d}, "
                f"where the top-2 gap {gap} is not under {limit}")
    return found


def _top2_gaps(torch, model, params, jobs, streams, limit) -> dict:
    """The distribution of the plain logits' top-2 gap at every token of
    the plain streams (the model's forward over prompt + stream), beside
    the near-tie ``limit``: how often a departure there would pass."""
    gaps = []
    for prompt, stream in {(tuple(p), tuple(o))
                           for (p, _), o in zip(jobs, streams)}:
        seq = torch.tensor([list(prompt + stream[:-1])],
                           dtype=torch.int64, device=model.device)
        with torch.no_grad():
            logits, _ = model.forward(params, seq)
        top = torch.topk(logits[0, len(prompt) - 1:].float(), 2).values
        gaps.append(top[:, 0] - top[:, 1])
    g = torch.cat(gaps)
    q = torch.quantile(g, torch.tensor([0.1, 0.5], device=g.device))
    return {"tokens": int(g.numel()), "min": float(g.min()),
            "p10": float(q[0]), "median": float(q[1]), "limit": limit,
            "share_under_limit": float((g < limit).float().mean())}


def _paged_work(b) -> dict:
    """Device work of a paged batcher that goes through the kernel, a
    launch a layer each: suffix-extend admissions, verify sub-rounds and
    plain decode steps."""
    paths = b.admission_paths
    return {"kernel_admissions": paths["paged_cold"] + paths["paged_shared"],
            "verify_subrounds": b.dispatched["verify_subrounds"],
            "decode_steps": b.dispatched["decode_steps"]}


def _spec_summary(b) -> dict:
    st = b.spec_stats
    return {"acceptance": st["acceptance"], "drafted": st["drafted"],
            "accepted": st["accepted"],
            "fallback_rounds": st["fallback_rounds"],
            "adapted_k": b._spec_k_active,
            "verify_subrounds": b.dispatched["verify_subrounds"],
            "decode_steps": b.dispatched["decode_steps"]}


def _profile_batcher(torch, b):
    """A torch.profiler entered on ``b``'s scheduler thread, between two
    rounds (its host ops are recorded only from the thread that enters
    it); stop it with ``_stop_batcher_profile``."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    b.run_quiesced(prof.__enter__)
    return prof


def _stop_batcher_profile(b, prof) -> None:
    # Stopping collects the whole trace on the scheduler thread: minutes
    # for a busy run, so the barrier waits long.
    b.run_quiesced(lambda: prof.__exit__(None, None, None), timeout_s=900)


def _profiled_run(torch, sync, b, run_once) -> dict:
    """One more run of ``run_once`` under a profiler on ``b``'s
    scheduler thread: ``_spec_profile``'s summary of it."""
    prof = _profile_batcher(torch, b)
    sync()
    t0 = time.perf_counter()
    run_once()
    sync()
    wall = time.perf_counter() - t0
    _stop_batcher_profile(b, prof)
    return _spec_profile(torch, prof, wall)


SPEC_PARTS = ("spec_draft", "spec_verify", "spec_accept")


def _spec_profile(torch, prof, wall_s: float) -> dict:
    """``_profile_summary`` plus each part of a spec sub-round (the
    executor's ``spec_draft``, ``spec_verify`` and ``spec_accept``
    ranges): the host ms inside it, the device ms of the kernels it
    launched, and its span on the device timeline (first kernel's start
    to last kernel's end, gaps included)."""
    out = _profile_summary(torch, prof, wall_s, ranges=SPEC_PARTS)
    parts = {}
    for e in prof.key_averages():
        if e.key not in SPEC_PARTS:
            continue
        dev_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
        part = parts.setdefault(e.key, {"count": 0})
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            part["device_span_ms"] = dev_us / 1e3
        else:
            part["count"] = e.count
            part["host_ms"] = e.cpu_time_total / 1e3
            part["kernel_ms"] = dev_us / 1e3
    out["spec_parts"] = parts
    return out


def _paged_spec_run(torch, model, params, draft, layers, device, sync,
                    new=SPEC_PAGED_NEW, profile=False) -> dict:
    """cb_paged_spec_tokens_per_s's cell on the paged pool through the
    paged kernel: a first request registers the shared chain, the eight
    run once to warm, then three timed runs of the eight; the kernel's
    launches are read just around each timed run and must equal one a
    layer for every kernel admission, verify sub-round and plain decode
    step, with no fall-back."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher

    shared = _spec_prefix(0)
    jobs = [(shared + [20 + i], new) for i in range(8)]
    kw = {} if draft is None else {"draft": draft, "spec_k": SPEC_K}
    b = ContinuousBatcher(model, params, slots=8,
                          paged_blocks=SPEC_PAGED_BLOCKS, page_size=PAGE,
                          attn_impl="paged_kernel", device=device,
                          **kw).start()
    runs = []
    try:
        _run_handles(b, jobs[:1])
        _run_handles(b, jobs)

        def timed():
            w0 = _paged_work(b)
            sync()
            pa.reset_counts()
            outs = _run_handles(b, jobs)
            sync()
            work = {k: v - w0[k] for k, v in _paged_work(b).items()}
            want = layers * sum(work.values())
            runs.append({**work, "launches": pa.launch_count,
                         "fallbacks": pa.fallback_count})
            if device != "cpu" and (pa.launch_count != want
                                    or pa.fallback_count):
                raise RuntimeError(
                    f"paged launches {pa.launch_count}, fall-backs "
                    f"{pa.fallback_count}; {layers} x {work} = {want}")
            return outs

        tps, outs, times = _best_rate(torch, sync, timed)
        summary = _spec_summary(b) if draft is not None else {}
        admissions = dict(b.admission_paths)
        extra = ({"profile": _profiled_run(
            torch, sync, b, lambda: _run_handles(b, jobs))}
            if profile else {})
    finally:
        b.stop()
    return {**extra, "tokens_per_s": tps, "trial_s": times,
            "timed_runs": runs, "admissions": admissions, **summary,
            "streams": outs, "jobs": jobs}


def run_spec_path(torch, seed: int, layers: int, device="cuda",
                  profile: bool = False,
                  distill_steps: int = SPEC_DISTILL_STEPS,
                  new: int = SPEC_NEW, paged_new: int = SPEC_PAGED_NEW,
                  f32_layers: int | None = None) -> dict:
    """Speculative serving of the flagship (bf16, random weights from
    ``seed``): a draft distilled with the reference bench's recipe
    (flash-kernel launches counted, 0 plain calls); the dense pool's
    plain, spec and int8-draft batchers (four 160-token requests, the
    bench's warm-ups, best of three); the paged pool's plain, n-gram and
    distilled-draft batchers over a shared 1024-token prefix through the
    paged kernel (launches exact); greedy identity of every spec stream
    against the plain stream of the same request on the same pool, by
    the near-tie rule, in bf16 (with the plain streams' top-2 gap
    distribution) and then in float32 at ``f32_layers`` (default: full
    depth) on both pools, with a draft distilled against the float32
    target."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher, distill_draft
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    out = {"layers": layers}

    # 1. The draft, distilled as bench.py:2011-2024 does.
    stats = {}
    fa.reset_counts()
    sync()
    t0 = time.perf_counter()
    dm, dp, loss = distill_draft(
        model, params, steps=distill_steps,
        seq_len=min(DISTILL_SEQ, cfg.max_seq - 8), seed=7,
        data_temperature=0.0, hard_labels=True, prompts=[SPEC_PROMPT],
        train_dtype=torch.float32, target_agreement=0.99, stats=stats)
    sync()
    out["distill"] = {
        "seconds": time.perf_counter() - t0, "steps": stats["steps"],
        "final_loss": loss, "agreement": stats["agreement"],
        "flash_launches": dict(fa.launch_counts),
        "trajectory": stats["sequences"][0],
        "flash_plain_calls": fa.plain_count,
        "draft": {"n_layers": dm.cfg.n_layers, "d_model": dm.cfg.d_model,
                  "d_ff": dm.cfg.d_ff, "dtype": _type_name(dm.cfg.dtype)},
    }
    print(json.dumps({"spec_distill": out["distill"]}), flush=True)
    if device != "cpu" and (min(fa.launch_counts[k] for k in FLASH_KERNELS)
                            <= 0 or fa.plain_count):
        raise RuntimeError(f"distillation: flash launches "
                           f"{fa.launch_counts}, plain {fa.plain_count}")

    # 2. The dense pool: spec_batcher_probe.
    engine = InferenceEngine(model, device=model.device)
    jobs = [(SPEC_PROMPT, new)] * 4
    dense = {}
    streams = {}
    trajectory = out["distill"].pop("trajectory")[len(SPEC_PROMPT):]
    for name, kw, warm in (("plain", {}, 1),
                           ("spec", {"draft": (dm, dp)}, 3),
                           ("spec_int8", {"draft": (dm, dp),
                                          "draft_int8": True}, 3)):
        if kw:
            kw["spec_k"] = SPEC_K
        b = ContinuousBatcher(model, params, slots=8, device=device,
                              **kw).start()
        try:
            _run_handles(b, jobs[:1])
            for _ in range(warm):
                _run_handles(b, jobs)
            tps, outs, times = _best_rate(
                torch, sync, lambda: _run_handles(b, jobs))
            dense[name] = {"tokens_per_s_4req": tps, "trial_s": times,
                           **(_spec_summary(b) if kw else {})}
            if profile and kw and not kw.get("draft_int8"):
                dense[name]["profile"] = _profiled_run(
                    torch, sync, b, lambda: _run_handles(b, jobs))
        finally:
            b.stop()
        streams[name] = outs
    # How far the served greedy stream follows the trajectory the draft
    # was distilled on (the engine's one-row generate): past the first
    # difference the draft meets contexts it never saw.
    dense["plain"]["follows_distilled_trajectory"] = next(
        (j for j, (x, y) in enumerate(zip(streams["plain"][0], trajectory))
         if x != y), min(len(trajectory), new))
    for name in ("spec", "spec_int8"):
        dense[name]["departures"] = _departures(
            torch, engine, params, jobs, streams["plain"], streams[name],
            BF16_TIE_GAP)
        dense[name]["vs_plain_x"] = (dense[name]["tokens_per_s_4req"]
                                     / dense["plain"]["tokens_per_s_4req"])
    dense["plain"]["top2_gaps"] = _top2_gaps(
        torch, model, params, jobs, streams["plain"], BF16_TIE_GAP)
    out["dense"] = dense
    print(json.dumps({"spec_dense": dense}), flush=True)

    # 3-5. The paged pool through the paged kernel.
    paged = {}
    for name, draft in (("plain", None), ("ngram", "ngram"),
                        ("neural", (dm, dp))):
        paged[name] = _paged_spec_run(torch, model, params, draft, layers,
                                      device, sync, paged_new,
                                      profile=profile and draft is not None)
    for name in ("ngram", "neural"):
        paged[name]["departures"] = _departures(
            torch, engine, params, paged[name]["jobs"],
            paged["plain"]["streams"], paged[name]["streams"], BF16_TIE_GAP)
        paged[name]["vs_plain_x"] = (paged[name]["tokens_per_s"]
                                     / paged["plain"]["tokens_per_s"])
    paged["plain"]["top2_gaps"] = _top2_gaps(
        torch, model, params, paged["plain"]["jobs"],
        paged["plain"]["streams"], BF16_TIE_GAP)
    for run in paged.values():
        del run["streams"], run["jobs"]
    out["paged"] = paged
    print(json.dumps({"spec_paged": paged}), flush=True)
    del model, params, engine
    _free(torch)

    # 6. Greedy identity at float32, with a draft distilled against the
    #    float32 target (so that it is accepted): the dense pool's spec
    #    and int8-draft batchers, then the paged pool.
    f32_layers = layers if f32_layers is None else f32_layers
    cfg32 = dataclasses.replace(flagship_config(torch, f32_layers),
                                dtype=torch.float32)
    model32 = TransformerLM(cfg32, device=device)
    params32 = model32.init(seed)
    engine32 = InferenceEngine(model32, device=model32.device)
    draft32 = distill_draft(
        model32, params32, steps=distill_steps,
        seq_len=min(DISTILL_SEQ, cfg32.max_seq - 8), seed=7,
        data_temperature=0.0, hard_labels=True, prompts=[SPEC_PROMPT],
        train_dtype=torch.float32, target_agreement=0.99)[:2]
    dense32, streams32 = {}, {}
    for name, kw in (("plain", {}),
                     ("spec", {"draft": draft32, "spec_k": SPEC_K}),
                     ("spec_int8", {"draft": draft32, "spec_k": SPEC_K,
                                    "draft_int8": True})):
        b = ContinuousBatcher(model32, params32, slots=8, device=device,
                              **kw).start()
        try:
            streams32[name] = _run_handles(b, jobs)
            dense32[name] = _spec_summary(b) if kw else {}
        finally:
            b.stop()
    for name in ("spec", "spec_int8"):
        dense32[name]["departures"] = _departures(
            torch, engine32, params32, jobs, streams32["plain"],
            streams32[name], F32_TIE_GAP)
    out["float32_dense"] = dense32
    print(json.dumps({"spec_float32_dense": dense32}), flush=True)
    f32 = {}
    runs = {name: _paged_spec_run(torch, model32, params32, draft,
                                  f32_layers, device, sync, paged_new)
            for name, draft in (("plain", None), ("ngram", "ngram"),
                                ("neural", draft32))}
    for name in ("ngram", "neural"):
        f32[name] = {
            "departures": _departures(
                torch, engine32, params32, runs[name]["jobs"],
                runs["plain"]["streams"], runs[name]["streams"],
                F32_TIE_GAP),
            "acceptance": runs[name]["acceptance"],
            "tokens_per_s": runs[name]["tokens_per_s"],
        }
    f32["plain_tokens_per_s"] = runs["plain"]["tokens_per_s"]
    f32["layers"] = f32_layers
    out["float32_paged"] = f32
    print(json.dumps({"spec_float32_paged": f32}), flush=True)
    return out


# -- phase 4f: the model lifecycle: bundles, LoRA, constraints, disagg --------

# 4f.3: the bank's three adapters (the one fine-tuned in 4f.2, rank 4 on
# wq/wv, rank 16 on all four targets) and eight requests over one
# 512-token prefix, two a model.  4f.4: a date and a small JSON object.
# 4f.5: the reference bench's disagg_probe shape cut to one card
# (bench.py:1416-1460): 700 and 1536 tokens prefilled whole, 1536 chunked
# by 256, an adapter request, beside a 160-token stream.
LORA_TRAIN_BATCH = 4
LORA_TRAIN_STEPS = 4
# The reference's lora-finetune recipe (train/registry.py:131-171).
LORA_TRAIN = dict(warmup_steps=1, learning_rate=5e-3)
LORA_NEW = 48
LORA_F32_NEW = 24
LORA_JOBS = (None, None, "ft", "ft", "r4", "r4", "r16", "r16")
CONSTRAINT_NEW = 32
# The constraint parser has no {n} counts (the reference's: literals,
# classes, groups, |, *, + and ?): \d{4}-\d{2}-\d{2} spelled out.
DATE_RE = r"\d\d\d\d-\d\d-\d\d"
JSON_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "n": {"type": "integer"}}}
CONSTRAINT_EOS = 0
DISAGG_NEW = 32
DISAGG_STREAM = 160
DISAGG_CHUNK = 256


def _lora_configs():
    from k8s_gpu_tpu_torch.train import LoraConfig

    return {"ft": LoraConfig(rank=8),
            "r4": LoraConfig(rank=4, targets=("wq", "wv")),
            "r16": LoraConfig(rank=16)}


def _seeded_adapter(torch, params, cfg, seed: int, b_std: float = 0.02):
    """``LoraAdapter.init`` with B drawn from ``seed`` too (B = 0 would
    serve the base model)."""
    from k8s_gpu_tpu_torch.train import LoraAdapter

    tree = LoraAdapter(cfg).init(seed, params)
    dev = tree["blocks"]["wq"]["a"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    for ab in tree["blocks"].values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen,
                              device=dev) * b_std
    return tree


def _leaves_bit_equal(torch, a: dict, b: dict) -> bool:
    from k8s_gpu_tpu_torch.serve.bundle import _flatten

    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        and torch.equal(fa[k].contiguous().view(torch.uint8),
                        fb[k].contiguous().view(torch.uint8))
        for k in fa)


def _bundle_case(torch, model, params, root, sync, prompt, **engine_kw):
    """Export, load back, compare the leaves and one greedy stream."""
    import shutil

    from k8s_gpu_tpu_torch.serve import (
        InferenceEngine, export_servable_dir, load_servable_dir,
    )

    shutil.rmtree(root, ignore_errors=True)
    sync()
    t0 = time.perf_counter()
    export_servable_dir(root, model, params)
    export_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for f in os.listdir(root))
    t0 = time.perf_counter()
    m2, p2, _ = load_servable_dir(root, device=model.device)
    sync()
    load_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if not _leaves_bit_equal(torch, p2, params):
        raise RuntimeError(f"bundle {root}: leaves differ after a round trip")
    x = torch.tensor([prompt], device=model.device)
    want, got = (InferenceEngine(m, device=model.device, **engine_kw)
                 .generate(p, x, max_new_tokens=16).tokens[0].tolist()
                 for m, p in ((model, params), (m2, p2)))
    if got != want:
        raise RuntimeError(f"bundle {root}: loaded params serve {got}, "
                           f"in-memory params {want}")
    return {"bytes": nbytes, "export_s": export_s, "load_s": load_s,
            "stream": got}


def run_bundle_path(torch, model, params, sync) -> dict:
    """4f.1: the bf16 flagship and its ``quantize_params`` tree through
    ``export_servable_dir``/``load_servable_dir`` (under the git-ignored
    build/chip/, removed after): bit-equal leaves, and one greedy stream
    from the loaded params equal to the in-memory one (int8 through
    ``int8_compute``)."""
    from k8s_gpu_tpu_torch.serve import quantize_params

    root = os.path.join(ROOT, "build", "chip", "bundles")
    prompt = [3, 5, 7, 11, 13, 17]
    out = {"bf16": _bundle_case(torch, model, params,
                                os.path.join(root, "bf16"), sync, prompt)}
    out["int8"] = _bundle_case(torch, model, quantize_params(params),
                               os.path.join(root, "int8"), sync, prompt,
                               int8_compute=True)
    return out


def run_lora_train(torch, seed: int, layers: int, params, device, sync,
                   batch: int = LORA_TRAIN_BATCH,
                   steps: int = LORA_TRAIN_STEPS) -> tuple[dict, dict]:
    """4f.2: ``Trainer(LoraModel(flagship, LoraConfig(rank=8)))`` with
    flash v1 and full remat at batch x 2048 on the frozen bf16 serving
    weights: a warm-up step (learning rate 0), then ``steps`` timed steps
    on the same batch.  Flash launches exactly 2 forward, 1 dq and 1
    dk/dv a layer and step, no plain call; losses finite and falling; the
    base leaves bit-identical afterwards.  Returns (numbers, the trained
    adapter tree)."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.serve.bundle import _flatten
    from k8s_gpu_tpu_torch.train import LoraModel, TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.lora import num_params

    cfg = flagship_train_config(torch, layers)
    lm = LoraModel(TransformerLM(cfg, device=device), params,
                   _lora_configs()["ft"])
    trainer = Trainer(lm, TrainConfig(**LORA_TRAIN), device=device)
    trainer.init(seed + 11)
    before = {k: v.clone() for k, v in _flatten(params)}
    rng = torch.Generator().manual_seed(seed + 12)
    toks = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=rng).to(device)
    x, y = toks[:, :-1], toks[:, 1:]
    first = trainer.step(x, y)
    sync()
    fa.reset_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(x, y, sync=False) for _ in range(steps)]
    sync()
    wall = time.perf_counter() - t0
    launches, plain = dict(fa.launch_counts), fa.plain_count
    losses = [first] + [float(t) for t in losses]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite LoRA loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"LoRA loss did not fall: {losses}")
    now = dict(_flatten(params))
    if any(not torch.equal(v, now[k]) for k, v in before.items()):
        raise RuntimeError("a base leaf moved during the LoRA fine-tune")
    if device != "cpu":
        want = _counts(fa, {"flash_fwd": 2 * layers * steps,
                            "flash_bwd_dq": layers * steps,
                            "flash_bwd_dkv": layers * steps})
        if launches != want or plain != 0:
            raise RuntimeError(f"LoRA flash launches {launches}, plain "
                               f"{plain}; expected {want} and 0")
    step_s = wall / steps
    tree = {"blocks": {k: {h: t.detach().clone() for h, t in ab.items()}
                       for k, ab in trainer.params["blocks"].items()}}
    return {"layers": layers, "batch": batch, "seq": cfg.max_seq,
            "rank": 8, **LORA_TRAIN,
            "adapter_params": num_params(trainer.params),
            "losses": losses, "timed_steps": steps,
            "step_ms": step_s * 1e3,
            "tokens_per_s": batch * cfg.max_seq / step_s,
            "launches": launches, "plain_calls": plain}, tree


def _served_burst(torch, srv, bodies, sync, layers, device,
                  first_alone: bool, profile: bool) -> dict:
    """One burst of ``bodies`` through ``srv`` (the first alone when
    ``first_alone``, so the rest may share its prefix blocks), with the
    paged kernel's launches read just around it and held to one a layer
    for every kernel admission and decode step, no fall-back."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    b = srv.batcher
    w0 = _paged_work(b)
    paths0 = dict(b.admission_paths)
    prof = _profile_batcher(torch, b) if profile else None
    sync()
    pa.reset_counts()
    t0 = time.perf_counter()
    outs = []
    if first_alone:
        outs.append({})
        _stream(srv.port, bodies[0], outs[0])
    outs += _stream_bodies(srv.port, bodies[len(outs):])
    sync()
    wall = time.perf_counter() - t0
    launches, fallbacks = pa.launch_count, pa.fallback_count
    if prof is not None:
        _stop_batcher_profile(b, prof)
    work = {k: v - w0[k] for k, v in _paged_work(b).items()}
    want = layers * sum(work.values())
    if device != "cpu" and (launches != want or fallbacks):
        raise RuntimeError(f"paged launches {launches}, fall-backs "
                           f"{fallbacks}; {layers} x {work} = {want}")
    paths = {k: v - paths0.get(k, 0) for k, v in b.admission_paths.items()
             if v - paths0.get(k, 0)}
    n_tok = sum(len(o["ids"]) for o in outs)
    out = {"outs": outs, "wall_s": wall, "generated_tokens": n_tok,
           "tokens_per_s": n_tok / wall, **work, "launches": launches,
           "fallbacks": fallbacks, "admissions": paths,
           "ms_per_decode_step": wall * 1e3 / max(1, work["decode_steps"])}
    if prof is not None:
        out["profile"] = _kernel_profile(prof, wall)
    return out


def _kernel_profile(prof, wall_s: float) -> dict:
    """Device ms and launches by kernel name, and the host's launch calls,
    of a profiled burst (the scheduler thread's)."""
    kernels, launch_calls = {}, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            kernels[e.key[:100]] = (dev_us / 1e3, e.count)
        elif e.key == "cudaLaunchKernel":
            launch_calls = e.count
    busy = sum(ms for ms, _ in kernels.values())
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "cuda_launch_calls": launch_calls, "kernels": kernels}


def _profile_delta(with_bank: dict, without: dict, steps_with: int,
                   steps_without: int) -> dict:
    """Per decode step: what a banked burst's kernels add over a bank-less
    one's, the largest first."""
    names = set(with_bank["kernels"]) | set(without["kernels"])
    rows = []
    for n in names:
        a_ms, a_n = with_bank["kernels"].get(n, (0.0, 0))
        b_ms, b_n = without["kernels"].get(n, (0.0, 0))
        rows.append((a_ms / steps_with - b_ms / steps_without,
                     a_n / steps_with - b_n / steps_without, n))
    rows.sort(reverse=True)
    return {
        "device_ms_per_step": (with_bank["device_busy_ms"] / steps_with,
                               without["device_busy_ms"] / steps_without),
        "launch_calls_per_step": (
            with_bank["cuda_launch_calls"] / steps_with,
            without["cuda_launch_calls"] / steps_without),
        "largest_added": [{"kernel": n, "ms_per_step": ms,
                           "launches_per_step": k}
                          for ms, k, n in rows[:8]],
    }


def _compare_streams(torch, engine, params, jobs, ref, got, limit) -> dict:
    """``got`` against ``ref`` (same requests): exact, or each first
    departure at a top-2 gap of ``ref``'s model under ``limit``."""
    return {"exact": ref == got,
            "departures": _departures(torch, engine, params, jobs, ref, got,
                                      limit)}


def run_multi_lora(torch, model, params, tok, adapters, layers, device,
                   sync, seed: int, profile: bool = False) -> dict:
    """4f.3: ``LmServer(adapters=...)`` on the paged pool with the paged
    kernel and prefix sharing: eight requests over one 512-token prefix,
    two base (the first alone, so the second shares its blocks) and two
    for each adapter, which take the unshared plan (``cold``: a
    left-padded prefill spliced into fresh blocks, as the reference
    plans adapter rows).  The same eight, as base requests, through a
    bank-less server: tokens/s beside it, and the base streams equal.
    Each adapter's streams against a bank-less batcher on its
    ``LoraAdapter.merge``d weights by the near-tie rule; an unknown
    adapter answers 400."""
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher, LmServer
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
    from k8s_gpu_tpu_torch.train import LoraAdapter

    rng = torch.Generator().manual_seed(seed + 20)
    V = model.cfg.vocab_size

    def over_a_prefix():
        prefix = torch.randint(0, V, (512,), generator=rng).tolist()
        return [(prefix + torch.randint(0, V, (16 + 4 * i,),
                                        generator=rng).tolist(),
                 LORA_NEW, name) for i, name in enumerate(LORA_JOBS)]

    # A warm-up burst over another prefix leaves this one's blocks cold.
    warm_jobs, jobs = over_a_prefix(), over_a_prefix()
    n_blocks = 1 + 2 * sum(-(-(1024 + n) // PAGE) for _, n, _ in jobs)
    kw = dict(slots=8, paged_blocks=n_blocks, page_size=PAGE,
              attn_impl="paged_kernel", max_new_tokens_cap=256,
              device=device)
    out = {}
    for label, bank in (("bankless", None), ("bank", adapters)):
        srv = LmServer(model, params, tok, adapters=bank, **kw).start()
        try:
            def bodies(js):
                return [{"prompt_ids": p, "max_new_tokens": n,
                         **({"adapter": a} if bank and a else {})}
                        for p, n, a in js]

            _served_burst(torch, srv, bodies(warm_jobs), sync, layers,
                          device, True, False)
            burst = _served_burst(torch, srv, bodies(jobs), sync, layers,
                                  device, True, False)
            if profile:
                burst["profile"] = _served_burst(
                    torch, srv, bodies(warm_jobs), sync, layers, device,
                    True, True)["profile"]
            if bank:
                code, err = _post(srv.port, "/generate", {
                    "prompt_ids": jobs[0][0], "adapter": "nope"})
                if code != 400 or "unknown adapter" not in err["error"]:
                    raise RuntimeError(f"unknown adapter: {code} {err}")
        finally:
            srv.stop()
        _check_budgets(burst["outs"], [n for _, n, _ in jobs])
        out[label] = burst
    paths = out["bank"]["admissions"]
    n_ad = sum(1 for a in LORA_JOBS if a)
    if paths != {"paged_cold": 1, "paged_shared": 1, "cold": n_ad}:
        raise RuntimeError(f"banked admissions {paths}: base rows after "
                           "the first must share, adapter rows never")
    streams = {k: [o["ids"] for o in out[k].pop("outs")]
               for k in ("bankless", "bank")}
    engine = InferenceEngine(model, device=model.device)
    base = [i for i, a in enumerate(LORA_JOBS) if a is None]
    out["base_vs_bankless"] = _compare_streams(
        torch, engine, params, [jobs[i][:2] for i in base],
        [streams["bankless"][i] for i in base],
        [streams["bank"][i] for i in base], BF16_TIE_GAP)
    out["bank_vs_bankless_x"] = (out["bank"]["tokens_per_s"]
                                 / out["bankless"]["tokens_per_s"])
    out["adapters_vs_merged"] = {}
    for name, (tree, cfg) in adapters.items():
        merged = LoraAdapter(cfg).merge(params, tree)
        idx = [i for i, a in enumerate(LORA_JOBS) if a == name]
        b = ContinuousBatcher(model, merged, slots=8, paged_blocks=n_blocks,
                              page_size=PAGE, attn_impl="paged_kernel",
                              device=device).start()
        try:
            ref = _run_handles(b, [jobs[i][:2] for i in idx])
        finally:
            b.stop()
        out["adapters_vs_merged"][name] = _compare_streams(
            torch, engine, merged, [jobs[i][:2] for i in idx], ref,
            [streams["bank"][i] for i in idx], BF16_TIE_GAP)
        del merged
    if profile:
        out["bank_cost"] = _profile_delta(
            out["bank"].pop("profile"), out["bankless"].pop("profile"),
            out["bank"]["decode_steps"], out["bankless"]["decode_steps"])
    return out


def run_multi_lora_f32(torch, seed: int, layers: int, ft_tree, device,
                       sync) -> dict:
    """4f.3 at float32, full depth: the same bank (the fine-tuned adapter
    and the two seeded ones, on float32 base weights) through a batcher
    on the paged pool with the paged kernel; each adapter's streams
    against a batcher on its merged weights, departures allowed only
    under 1e-4."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
    from k8s_gpu_tpu_torch.train import LoraAdapter

    cfg = dataclasses.replace(flagship_config(torch, layers),
                              dtype=torch.float32)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    cfgs = _lora_configs()
    adapters = {"ft": (ft_tree, cfgs["ft"]),
                "r4": (_seeded_adapter(torch, params, cfgs["r4"], seed + 21),
                       cfgs["r4"]),
                "r16": (_seeded_adapter(torch, params, cfgs["r16"],
                                        seed + 22), cfgs["r16"])}
    rng = torch.Generator().manual_seed(seed + 23)
    prefix = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    jobs = [(prefix + torch.randint(0, cfg.vocab_size, (24,),
                                    generator=rng).tolist(), LORA_F32_NEW)
            for _ in adapters]
    n_blocks = 1 + len(jobs) * (-(-(1024 + LORA_F32_NEW) // PAGE))
    kw = dict(slots=4, paged_blocks=n_blocks, page_size=PAGE,
              attn_impl="paged_kernel", device=device)
    b = ContinuousBatcher(model, params, adapters=adapters, **kw).start()
    try:
        hs = [b.submit(p, max_new_tokens=n, adapter=name)
              for (p, n), name in zip(jobs, adapters)]
        got = [h.result() for h in hs]
    finally:
        b.stop()
    engine = InferenceEngine(model, device=model.device)
    out = {"layers": layers}
    for (p, n), name, g in zip(jobs, adapters, got):
        tree, c = adapters[name]
        merged = LoraAdapter(c).merge(params, tree)
        mb = ContinuousBatcher(model, merged, **kw).start()
        try:
            ref = _run_handles(mb, [(p, n)])
        finally:
            mb.stop()
        out[name] = _compare_streams(torch, engine, merged, [(p, n)], ref,
                                     [g], F32_TIE_GAP)
    return out


def _dfa_walk(bank, cidx: int, ids) -> tuple[int, bool]:
    """(final state or -1, accepting) of ``ids`` through the bank's
    tables."""
    nxt = bank.next_state[cidx].cpu()
    state = 0
    for t in ids:
        state = int(nxt[state, t])
        if state < 0:
            return -1, False
    return state, bool(bank.accepting[cidx, state])


def run_constraints(torch, model, params, tok, layers, device, sync,
                    seed: int, profile: bool = False) -> dict:
    """4f.4: ``LmServer(constraints={"date": ..., "json":
    schema_to_regex(...)}, eos_id=...)`` on the paged pool with the
    paged kernel: the bank's compile (the server's construction) and its
    table bytes at V 16384; three requests a constraint and two free
    ones.  Each constrained text is in its language (a full match when it
    stopped before its budget, else a live DFA state); the free streams
    against a bank-less server's; paged launches exact."""
    import re

    from k8s_gpu_tpu_torch.serve import LmServer, schema_to_regex
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine

    patterns = {"date": DATE_RE, "json": schema_to_regex(JSON_SCHEMA)}
    rng = torch.Generator().manual_seed(seed + 30)
    V = model.cfg.vocab_size
    names = ("date",) * 3 + ("json",) * 3 + (None, None)
    jobs = [(torch.randint(0, V, (40 + 8 * i,), generator=rng).tolist(),
             CONSTRAINT_NEW, c) for i, c in enumerate(names)]
    n_blocks = max(1 + model.cfg.max_seq // PAGE,
                   1 + len(jobs) * (-(-(128 + CONSTRAINT_NEW) // PAGE)))
    kw = dict(slots=8, paged_blocks=n_blocks, page_size=PAGE,
              attn_impl="paged_kernel", eos_id=CONSTRAINT_EOS,
              device=device)
    out = {}
    for label, cons in (("bankless", None), ("bank", patterns)):
        t0 = time.perf_counter()
        srv = LmServer(model, params, tok, constraints=cons, **kw)
        build_s = time.perf_counter() - t0
        srv.start()
        try:
            bodies = [{"prompt_ids": p, "max_new_tokens": n,
                       **({"constraint": c} if cons and c else {})}
                      for p, n, c in jobs]
            _served_burst(torch, srv, bodies, sync, layers, device, False,
                          False)                       # warm
            burst = _served_burst(torch, srv, bodies, sync, layers, device,
                                  False, profile)
            bank = srv.batcher.cbank
        finally:
            srv.stop()
        burst["server_build_s"] = build_s
        out[label] = burst
    out["compile_s"] = out["bank"]["server_build_s"]
    out["table_bytes"] = bank.table_bytes
    out["dfa_states"] = int(bank.allowed.shape[1])
    out["vocab"] = int(bank.allowed.shape[2])
    texts = {}
    for (p, n, c), o in zip(jobs, out["bank"]["outs"]):
        if not (o.get("summary") or {}).get("done"):
            raise RuntimeError(f"constrained request failed: {o}")
        if c is None:
            continue
        ids = o["ids"]
        text = "".join(tok.decode([t]) for t in ids)
        state, accepting = _dfa_walk(bank, bank.index(c), ids)
        stopped = len(ids) < n
        ok = (accepting and re.fullmatch(patterns[c], text) is not None
              if stopped else state >= 0)
        texts.setdefault(c, []).append({"text": text, "tokens": len(ids),
                                        "stopped": stopped, "ok": ok})
        if not ok:
            raise RuntimeError(f"constraint {c}: {text!r} is not in its "
                               f"language (state {state})")
    out["texts"] = texts
    free = [i for i, c in enumerate(names) if c is None]
    streams = {k: [o["ids"] for o in out[k].pop("outs")]
               for k in ("bankless", "bank")}
    engine = InferenceEngine(model, device=model.device)
    out["free_vs_bankless"] = _compare_streams(
        torch, engine, params, [jobs[i][:2] for i in free],
        [streams["bankless"][i] for i in free],
        [streams["bank"][i] for i in free], BF16_TIE_GAP)
    if profile:
        out["bank_cost"] = _profile_delta(
            out["bank"].pop("profile"), out["bankless"].pop("profile"),
            out["bank"]["decode_steps"], out["bankless"]["decode_steps"])
    return out


def _consume_times(handle, times: list, ids: list) -> None:
    for tok in handle:
        times.append(time.perf_counter())
        ids.append(tok)


def _max_gap(times, t0: float, t1: float) -> float | None:
    """The longest gap between consecutive tokens that overlaps [t0, t1]."""
    gaps = [b - a for a, b in zip(times, times[1:]) if b >= t0 and a <= t1]
    return max(gaps) if gaps else None


def run_disagg(torch, model, params, adapters, layers, device, sync,
               seed: int) -> dict:
    """4f.5: ``DisaggregatedLm`` over a paged batcher with the paged
    kernel and the adapter bank.  A 160-token request streams while a
    1536-token prompt is prefilled whole by the pool, then again while
    another is prefilled in chunks of 256, and, as the yardstick, while
    a third is admitted by the batcher itself: the longest gap between
    the stream's tokens over each prefill (a finding, not a gate; the
    batcher runs one step a round meanwhile, as phase 4d does, so each
    token is its own round).  Then 700 tokens whole and an adapter
    request.  Every budget met, every handover
    admitted ``precomputed``, paged launches exactly one a layer for each
    kernel admission and decode step (a handover adds no kernel
    admission), the in-flight rows within their cap; the handed-over
    streams against the same requests served without disaggregation, by
    the near-tie rule."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher, DisaggregatedLm
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
    from k8s_gpu_tpu_torch.train import LoraAdapter

    rng = torch.Generator().manual_seed(seed + 40)
    V = model.cfg.vocab_size

    def ids(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    handed = [("whole_1536", ids(1536), None), ("chunked_1536", ids(1536),
                                                 None),
              ("whole_700", ids(700), None), ("adapter_600", ids(600),
                                              "r16")]
    colocated = ids(1536)
    streams_in = [ids(64), ids(64), ids(64)]
    n_blocks = 1 + sum(-(-(len(p) + DISAGG_NEW) // PAGE)
                       for _, p, _ in handed) * 2 + 3 * (
        -(-(64 + DISAGG_STREAM) // PAGE)) + 2 * (
        -(-(1536 + DISAGG_NEW) // PAGE)) + 8
    b = ContinuousBatcher(model, params, slots=8, adapters=adapters,
                          paged_blocks=n_blocks, page_size=PAGE,
                          attn_impl="paged_kernel", device=device).start()
    whole = DisaggregatedLm(model, params, batcher=b).start()
    chunked = DisaggregatedLm(model, params, batcher=b,
                              chunk_tokens=DISAGG_CHUNK).start()
    out, got = {}, {}
    try:
        # Warm both forms and the decode rounds on a short prompt.
        for d in (whole, chunked):
            d.submit(ids(300), max_new_tokens=4).result()
        b.submit(ids(64), max_new_tokens=4).result()
        sync()
        w0 = _paged_work(b)
        paths0 = dict(b.admission_paths)
        pa.reset_counts()
        b.steps_per_round, b.solo_buckets = 1, [1]
        for (label, prompt), d, s_prompt in zip(
                ((handed[0][:2]), handed[1][:2],
                 ("colocated_1536", colocated)),
                (whole, chunked, None), streams_in):
            times, s_ids = [], []
            h_s = b.submit(s_prompt, max_new_tokens=DISAGG_STREAM)
            th = threading.Thread(target=_consume_times,
                                  args=(h_s, times, s_ids))
            th.start()
            while len(times) < 8 and th.is_alive():
                time.sleep(0.001)
            t0 = time.perf_counter()
            h = (b.submit(prompt, max_new_tokens=DISAGG_NEW) if d is None
                 else d.submit(prompt, max_new_tokens=DISAGG_NEW))
            t1 = time.perf_counter()
            first = next(iter(h))
            t2 = time.perf_counter()
            got[label] = h.result()
            th.join(timeout=600)
            if len(s_ids) != DISAGG_STREAM or h_s.aborted:
                raise RuntimeError(f"stream beside {label}: {len(s_ids)} "
                                   f"of {DISAGG_STREAM} tokens")
            step = [b_ - a for a, b_ in zip(times[1:], times[2:])]
            out[label] = {
                "prefill_and_handover_s": t1 - t0,
                "handover_to_first_token_s": t2 - t1,
                "first_token": first,
                "stream_max_gap_s": _max_gap(times, t0, t2),
                "stream_median_gap_s": sorted(step)[len(step) // 2],
            }
        _set_rounds(b, 8)
        rest = {}

        def run(label, prompt, adapter):
            h = whole.submit(prompt, max_new_tokens=DISAGG_NEW,
                             adapter=adapter)
            rest[label] = h.result()

        threads = [threading.Thread(target=run, args=job)
                   for job in handed[2:]]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        got.update(rest)
        sync()
        launches, fallbacks = pa.launch_count, pa.fallback_count
        work = {k: v - w0[k] for k, v in _paged_work(b).items()}
        paths = {k: v - paths0.get(k, 0)
                 for k, v in b.admission_paths.items()
                 if v - paths0.get(k, 0)}
        # The same requests served without disaggregation.
        direct = {label: b.submit(p, max_new_tokens=DISAGG_NEW,
                                  adapter=a).result()
                  for label, p, a in handed}
    finally:
        whole.stop()
        chunked.stop()
        b.stop()
    want = layers * (work["kernel_admissions"] + work["decode_steps"])
    if device != "cpu" and (launches != want or fallbacks):
        raise RuntimeError(f"disagg paged launches {launches}, fall-backs "
                           f"{fallbacks}; {layers} x {work} = {want}")
    if paths.get("precomputed") != len(handed) or work[
            "kernel_admissions"] != len(streams_in) + 1:
        raise RuntimeError(f"disagg admissions {paths}: every handover "
                           "precomputed, only the streams admitted by the "
                           "kernel")
    for label, _, _ in handed:
        if len(got[label]) != DISAGG_NEW:
            raise RuntimeError(f"{label}: {len(got[label])} of "
                               f"{DISAGG_NEW} tokens")
    for d in (whole, chunked):
        if d.max_inflight > d.inflight_cap:
            raise RuntimeError(f"{d.max_inflight} rows in flight over a "
                               f"cap of {d.inflight_cap}")
    engine = InferenceEngine(model, device=model.device)
    cmp = {}
    for label, p, a in handed:
        ps = params if a is None else LoraAdapter(adapters[a][1]).merge(
            params, adapters[a][0])
        cmp[label] = _compare_streams(torch, engine, ps,
                                      [(p, DISAGG_NEW)], [direct[label]],
                                      [got[label]], BF16_TIE_GAP)
    out.update({"vs_direct": cmp, "admissions": paths, **work,
                "launches": launches, "fallbacks": fallbacks,
                "max_inflight": max(whole.max_inflight,
                                    chunked.max_inflight),
                "inflight_cap": whole.inflight_cap,
                "chunk_tokens": DISAGG_CHUNK})
    return out


def lifecycle_launches(out: dict) -> int:
    """The paged kernel's launches over phase 4f's counted runs."""
    runs = [out["multi_lora"][k] for k in ("bank", "bankless")]
    runs += [out["constraints"][k] for k in ("bank", "bankless")]
    return sum(r["launches"] for r in runs) + out["disagg"]["launches"]


def run_lifecycle_path(torch, seed: int, layers: int, device="cuda",
                       profile: bool = False,
                       train_batch: int = LORA_TRAIN_BATCH) -> dict:
    """Phase 4f on the bf16 flagship: bundles (4f.1), the LoRA fine-tune
    (4f.2), multi-LoRA serving in bf16 and float32 (4f.3), constrained
    decoding (4f.4) and the disaggregated prefill pool (4f.5).  Prints
    each part's line as it ends."""
    from k8s_gpu_tpu_torch.models import TransformerLM

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    tok = flagship_tokenizer(cfg.vocab_size)
    out = {"layers": layers}

    def part(key, value):
        out[key] = value
        print(json.dumps({f"lifecycle_{key}": value}), flush=True)

    part("bundle", run_bundle_path(torch, model, params, sync))
    train, ft_tree = run_lora_train(torch, seed, layers, params, device,
                                    sync, batch=train_batch)
    part("lora_train", train)
    cfgs = _lora_configs()
    adapters = {"ft": (ft_tree, cfgs["ft"]),
                "r4": (_seeded_adapter(torch, params, cfgs["r4"], seed + 21),
                       cfgs["r4"]),
                "r16": (_seeded_adapter(torch, params, cfgs["r16"],
                                        seed + 22), cfgs["r16"])}
    part("multi_lora", run_multi_lora(torch, model, params, tok, adapters,
                                      layers, device, sync, seed, profile))
    part("constraints", run_constraints(torch, model, params, tok, layers,
                                        device, sync, seed, profile))
    part("disagg", run_disagg(torch, model, params, adapters, layers,
                              device, sync, seed))
    del model, params, adapters
    if device != "cpu":
        _free(torch)
    part("multi_lora_f32", run_multi_lora_f32(torch, seed, layers, ft_tree,
                                              device, sync))
    return out


# -- phase 5: the output against the gather read -----------------------------

LOGIT_TOL = 0.25  # bf16 logits after 16 layers, two attention reads


def check_outputs(torch, seed: int, layers: int, device="cuda") -> dict:
    """The flagship engine with the kernel read against the same engine
    with the gather read, on one 300-token prompt and one decode step:
    finite logits of the right shape that agree within LOGIT_TOL.  Also
    measures kernel launches per decode step."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve.engine import (
        InferenceEngine, _empty_cache_paged,
    )

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    dev = model.device
    sync = _syncer(torch, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    n = 300
    rng = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=rng)
    prompt[:, n:] = 0
    prompt = prompt.to(dev, torch.int32)
    pages = torch.zeros(1, cfg.max_seq // PAGE, **i32)
    pages[0, :8] = torch.arange(1, 9)
    zero = torch.zeros(1, **i32)
    out = {}
    for impl in ("paged_kernel", "gather"):
        eng = InferenceEngine(model, attn_impl=impl, device=dev)
        cache = _empty_cache_paged(cfg, 9, PAGE, False, dev)
        _, logits = eng.extend_multi(params, cache, prompt, zero, zero, zero,
                                     pages=pages, page=PAGE)
        tok = logits[:, n - 1].argmax(-1).to(torch.int32)
        pos = torch.full((1,), n, **i32)
        before = pa.launch_count
        _, step = eng.decode_step_multi(params, cache, tok, pos, pos, zero,
                                        t_hi=512, pages=pages, page=PAGE)
        sync()
        out[impl] = (logits[:, :n], step, pa.launch_count - before)
    (lk, sk, per_step), (lg, sg, _) = out["paged_kernel"], out["gather"]
    if lk.shape != (1, n, cfg.vocab_size) or sk.shape != (1, cfg.vocab_size):
        raise RuntimeError(f"logit shapes {tuple(lk.shape)} {tuple(sk.shape)}")
    if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(sk).all())):
        raise RuntimeError("non-finite logits")
    err = max(float((lk - lg).abs().max()), float((sk - sg).abs().max()))
    if not err <= LOGIT_TOL:
        raise RuntimeError(f"kernel vs gather logits differ by {err}")
    if per_step != layers:
        raise RuntimeError(f"{per_step} kernel launches per decode step, "
                           f"expected {layers}")
    agree = float((lk.argmax(-1) == lg.argmax(-1)).float().mean())
    return {"logit_max_abs_err": err, "logit_tol": LOGIT_TOL,
            "argmax_agreement": agree, "launches_per_decode_step": per_step}


# -- phase 5b: a left-padded row, dense read against the paged kernel --------

LEFT_PAD_PROMPT = 700     # the mix's prompt whose bucket (1024) pads 324
LEFT_PAD_STEPS = 4


def check_left_pad_outputs(torch, seed: int, layers: int,
                           device="cuda") -> dict:
    """One 700-token prompt left-padded to its 1024 bucket and prefilled
    once; its row then decodes LEFT_PAD_STEPS steps twice from the same
    K/V: on the dense cache (the engine's plain read) and spliced into
    pool blocks as the unshared paged admission does (the paged kernel,
    kv_start = pad, RoPE = position - pad).  Finite logits of the right
    shape that agree within LOGIT_TOL, and one kernel launch a layer and
    step on the paged side."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve.engine import (
        InferenceEngine, _empty_cache_paged,
    )
    from k8s_gpu_tpu_torch.serve.scheduler import prompt_bucket

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    dev = model.device
    sync = _syncer(torch, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    n = LEFT_PAD_PROMPT
    bucket = prompt_bucket(n, cfg.max_seq)
    pad = bucket - n
    rng = torch.Generator().manual_seed(seed + 4)
    padded = torch.zeros(1, bucket, dtype=torch.int32)
    padded[0, pad:] = torch.randint(0, cfg.vocab_size, (n,), generator=rng)
    dense = InferenceEngine(model, device=dev)
    row, last = dense.prefill(params, padded.to(dev), pad)
    # The row into fresh blocks 1.., page by page (executor._splice_paged).
    n_pages = -(-(bucket + LEFT_PAD_STEPS) // PAGE)
    pool = _empty_cache_paged(cfg, 1 + n_pages, PAGE, False, dev)
    pages = torch.zeros(1, cfg.max_seq // PAGE, **i32)
    pages[0, :n_pages] = torch.arange(1, 1 + n_pages)
    q_pos = torch.arange(bucket, device=dev)
    for name, arr in pool.items():
        arr[:, pages[0, q_pos // PAGE].long(), :, q_pos % PAGE] = (
            row[name][:, 0, :, :bucket].movedim(2, 0))
    paged = InferenceEngine(model, attn_impl="paged_kernel", device=dev)
    tok = last.argmax(-1).to(torch.int32)
    start = torch.full((1,), pad, **i32)
    t_hi = cfg.max_seq
    errs, launches, agree = [], 0, 0
    for step in range(LEFT_PAD_STEPS):
        pos = torch.full((1,), bucket + step, **i32)
        rope = pos - pad
        _, ld = dense.decode_step_multi(params, row, tok, pos, rope, start,
                                        t_hi=t_hi)
        before = pa.launch_count
        _, lp = paged.decode_step_multi(params, pool, tok, pos, rope, start,
                                        t_hi=t_hi, pages=pages, page=PAGE)
        sync()
        launches += pa.launch_count - before
        if ld.shape != (1, cfg.vocab_size) or lp.shape != ld.shape:
            raise RuntimeError(f"logit shapes {tuple(ld.shape)} "
                               f"{tuple(lp.shape)}")
        if not (bool(torch.isfinite(ld).all())
                and bool(torch.isfinite(lp).all())):
            raise RuntimeError("non-finite logits")
        errs.append(float((ld - lp).abs().max()))
        agree += int(ld.argmax(-1) == lp.argmax(-1))
        tok = ld.argmax(-1).to(torch.int32)
    err = max(errs)
    if not err <= LOGIT_TOL:
        raise RuntimeError(f"dense vs paged-kernel logits differ by {err}")
    if dev.type == "cuda" and launches != layers * LEFT_PAD_STEPS:
        raise RuntimeError(f"{launches} kernel launches over "
                           f"{LEFT_PAD_STEPS} decode steps, expected "
                           f"{layers * LEFT_PAD_STEPS}")
    return {"prompt": n, "bucket": bucket, "kv_start": pad,
            "logit_max_abs_err": err, "logit_tol": LOGIT_TOL,
            "logit_err_by_step": errs, "argmax_agreement": agree,
            "steps": LEFT_PAD_STEPS, "paged_attention_launches": launches}


# -- phase 6: the training main path ---------------------------------------

TRAIN_BATCH = 24   # 24 x 2048 tokens a step, the reference bench's batch
TRAIN_STEPS = 5    # timed steps after one warm-up step


# The v2 training configuration: the flagship with 2 KV heads (G = 4, the
# geometry the reference's v2 kernels were written for) and the three v2
# knobs on.
V2_KNOBS = dict(flash_fuse_rope=True, flash_kv_grouped=True,
                flash_q_pipeline=2)
V2_OFF = dict(flash_fuse_rope=False, flash_kv_grouped=False,
              flash_q_pipeline=0)


def flagship_train_config(torch, layers: int, dtype=None, v2=False):
    """The reference bench's flagship training configuration
    (``bench.py:178-183``) with the port's own flash tile: bf16 compute,
    flash attention, full remat; with ``v2``, ``n_kv_heads=2`` and the v2
    knobs on."""
    from k8s_gpu_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=16384, d_model=1024, n_layers=layers, n_heads=8,
        n_kv_heads=2 if v2 else 0, d_head=128, d_ff=4096, max_seq=2048,
        dtype=dtype or torch.bfloat16, use_flash=True, remat=True,
        remat_policy="full", **(V2_KNOBS if v2 else {}),
    )


def run_train_path(torch, seed: int, layers: int, batch: int, steps: int,
                   device="cuda", profile: bool = False,
                   v2: bool = False, knobs: bool = True) -> dict:
    """Phase 6 (v1), 6b (``v2``: the GQA configuration with its knobs on)
    or, with ``v2`` and not ``knobs``, the same GQA configuration on the v1
    kernels with rope outside and K/V repeated."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.runner import (
        device_peak_flops, model_flops_per_step, tree_leaves,
    )

    cfg = flagship_train_config(torch, layers, v2=v2)
    if not knobs:
        cfg = dataclasses.replace(cfg, **V2_OFF)
    v2_kernels = v2 and knobs
    model = TransformerLM(cfg, device=device)
    trainer = Trainer(model, TrainConfig(warmup_steps=1), device=device)
    trainer.init(seed)
    sync = _syncer(torch, model.device)
    n_params = sum(p.numel() for p in tree_leaves(trainer.params))
    rng = torch.Generator().manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=rng).to(model.device)
    x, y = toks[:, :-1], toks[:, 1:]
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = trainer.step(x, y)                 # warm-up, learning rate 0
    warm_s = time.perf_counter() - t0
    sync()
    fa.reset_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(x, y, sync=False) for _ in range(steps)]
    sync()
    wall = time.perf_counter() - t0
    launches, plain = dict(fa.launch_counts), fa.plain_count
    prepasses = fa.prepass_counts["flash_v2_rope_split"]
    losses = [first] + [float(t) for t in losses]
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if model.device.type == "cuda" else None)
    profiled = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            trainer.step(x, y)
            sync()
            prof_wall = time.perf_counter() - t1
        profiled = _profile_summary(torch, prof, prof_wall)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    step_s = wall / steps
    flops = model_flops_per_step(cfg, n_params, batch)
    peak = device_peak_flops()
    result = {
        "layers": layers, "batch": batch, "seq": cfg.max_seq,
        "n_kv_heads": cfg.kv_heads, "v2_knobs": v2_kernels,
        "n_params": n_params,
        "losses": losses, "warmup_step_s": warm_s,
        "timed_steps": steps, "step_ms": step_s * 1e3,
        "tokens_per_s": batch * cfg.max_seq / step_s,
        "model_flops_per_step": flops, "peak_flops": peak,
        "mfu": flops / step_s / peak if peak else None,
        "peak_memory_gb": peak_gb, "launches": launches,
        "prepass_launches": prepasses, "plain_calls": plain,
    }
    if profiled is not None:
        result["profile"] = profiled
    if model.device.type == "cuda":
        fwd, dq, dkv = FLASH_V2_KERNELS if v2_kernels else FLASH_KERNELS
        want = _counts(fa, {fwd: 2 * layers * steps, dq: layers * steps,
                            dkv: layers * steps})
        # v2 in bf16 with rope: a pre-pass in each forward (2, remat) and
        # one for the backward pair.
        want_pre = 3 * layers * steps if v2_kernels else 0
        if launches != want or plain != 0 or prepasses != want_pre:
            raise RuntimeError(f"flash launches {launches}, pre-passes "
                               f"{prepasses}, plain calls {plain} on the "
                               f"training path; expected {want}, "
                               f"{want_pre} and 0")
    return result


# -- phase 6c: the training job ---------------------------------------------

# Checkpoints of phase 6c go here (git-ignored) and are deleted after.
JOB_DIR = os.path.join(ROOT, "build", "chip", "job")
# The registry workloads of phase 6c, at the reference's defaults.
JOB_WORKLOADS = ("lm-train", "lora-finetune", "cnn-train")


def _deterministic(torch, on: bool) -> None:
    """``torch.use_deterministic_algorithms`` without the NaN fill of
    fresh memory (a debugging aid that would cost the timed steps)."""
    if on:
        # cuBLAS refuses deterministic mode without a fixed workspace.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on)
    torch.utils.deterministic.fill_uninitialized_memory = not on


def _trees_equal(torch, a, b) -> bool:
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _token_file(torch, seed: int, path: str, samples: int, seq: int,
                vocab: int) -> str:
    from k8s_gpu_tpu_torch.data.loader import write_tokens

    gen = torch.Generator().manual_seed(seed)
    write_tokens(path, torch.randint(0, vocab, (samples * (seq + 1),),
                                     generator=gen).numpy())
    return path


def _loader_rate(loader, n: int) -> tuple[list, float]:
    t0 = time.perf_counter()
    out = [next(loader) for _ in range(n)]
    return out, n / (time.perf_counter() - t0)


def run_job_path(torch, seed: int, layers: int, batch: int, device="cuda",
                 job_dir: str = JOB_DIR) -> dict:
    """Phase 6c.1: the flagship ``Trainer`` with a goodput ledger, a phase
    profiler and the step series runs 2 steps through ``fit``, saves a
    checkpoint at step 2 and takes step 3; a fresh ``Trainer`` resumes
    from the checkpoint and takes step 3 again, held bit for bit (loss,
    parameters, moments) under ``torch.use_deterministic_algorithms``;
    then the native loader against the Python one over a token file from
    ``seed``, a native batch feeding one step of the resumed trainer."""
    import shutil

    from k8s_gpu_tpu_torch.data import native
    from k8s_gpu_tpu_torch.data.loader import TokenLoader
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer
    from k8s_gpu_tpu_torch.utils.goodput import GoodputLedger
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
    from k8s_gpu_tpu_torch.utils.profiler import PhaseProfiler

    cfg = flagship_train_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    sync = _syncer(torch, model.device)
    gen = torch.Generator().manual_seed(seed + 5)
    toks = torch.randint(0, cfg.vocab_size, (3, batch, cfg.max_seq + 1),
                         generator=gen)
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]    # on the host
    reg = MetricsRegistry()
    led = GoodputLedger(registry=reg)
    prof = PhaseProfiler(plane="train", registry=reg)
    shutil.rmtree(job_dir, ignore_errors=True)
    _deterministic(torch, True)
    try:
        fa.reset_counts()
        first = Trainer(model, TrainConfig(warmup_steps=1), device=device,
                        ledger=led, profiler=prof)
        first.init(seed)
        data = iter(batches)
        losses = first.fit(data, 2, log_every=1)
        ckpt, save, _ = attach_to_trainer(first, job_dir, registry=reg)
        t0 = time.perf_counter()
        save(2)
        save_s = time.perf_counter() - t0
        losses += first.fit(data, 1, log_every=1)
        mfu = global_metrics.gauge("train_mfu")
        ckpt_bytes = ckpt._step_bytes(2)
        resumed = Trainer(model, TrainConfig(warmup_steps=1), device=device)
        resumed.init(seed + 1)
        _, _, resume = attach_to_trainer(resumed, job_dir, registry=reg)
        sync()
        t0 = time.perf_counter()
        start = resume()
        sync()
        restore_s = time.perf_counter() - t0
        loss3 = resumed.step(*batches[2])
        sync()
        launches = dict(fa.launch_counts)
        plain = fa.plain_count
        same = {
            "loss": loss3 == losses[2],
            "params": _trees_equal(torch, resumed.params, first.params),
            "moments": all(_trees_equal(torch, resumed.opt_state[k],
                                        first.opt_state[k])
                           for k in ("mu", "nu")),
            "count": resumed.opt_state["count"] == first.opt_state["count"],
        }
    finally:
        _deterministic(torch, False)
        shutil.rmtree(job_dir, ignore_errors=True)
    snap = led.snapshot()
    counts = {k: v["count"] for k, v in snap["segments"].items()}
    want = {"init": 1, "compile": 1, "step": 2, "data_wait": 3,
            "checkpoint_save": 1}
    if counts != want:
        raise RuntimeError(f"ledger segments {counts}, expected {want}")
    if start != 2 or not all(same.values()):
        raise RuntimeError(f"resumed step 3 departs from the uninterrupted "
                           f"one: start {start}, equal {same}, losses "
                           f"{losses} vs {loss3}")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite job losses {losses}")
    step_s = snap["segments"]["step"]["seconds"] / 2
    shares = {dict(k)["phase"]: v
              for k, v in reg.series("train_phase_share").items()}
    phases = {ph: {"count": v["count"], "p50_ms": v["p50_s"] * 1e3}
              for ph, v in prof.snapshot()["phases"].items()}
    del first, resumed, ckpt
    _free_if(torch, model.device)

    # The native loader against the Python one, over one token file.
    path = _token_file(torch, seed + 6,
                       os.path.join(job_dir + "_tokens", "toks.bin"),
                       samples=8 * batch, seq=cfg.max_seq,
                       vocab=cfg.vocab_size)
    n = 4 * 8
    try:
        native.load()                                   # build outside
        with TokenLoader(path, cfg.max_seq, batch, seed=seed,
                         backend="python") as py, \
                TokenLoader(path, cfg.max_seq, batch, seed=seed,
                            backend="native") as nat:
            py_batches, py_rate = _loader_rate(py, n)
            nat_batches, nat_rate = _loader_rate(nat, n)
        same_bytes = all(a.tobytes() == b.tobytes()
                         for pa, pb in zip(py_batches, nat_batches)
                         for a, b in zip(pa, pb))
        if not same_bytes:
            raise RuntimeError("native batches differ from the Python ones")
        feed = Trainer(model, TrainConfig(warmup_steps=1), device=device)
        feed.init(seed)
        native_loss = feed.step(*nat_batches[0])
        if not math.isfinite(native_loss):
            raise RuntimeError(f"non-finite loss {native_loss} from a "
                               "native batch")
    finally:
        shutil.rmtree(job_dir + "_tokens", ignore_errors=True)
    return {
        "layers": layers, "batch": batch, "seq": cfg.max_seq,
        "deterministic": True,
        "losses": losses, "resumed_step3_loss": loss3, "resumed_from": start,
        "bit_equal": same,
        "ledger_segments": snap["segments"],
        "goodput_ratio_total": snap["goodput_ratio_total"],
        "residual_s": snap["residual_s"],
        "train_phase_share": shares, "train_phases": phases,
        "train_mfu": mfu,
        "step_ms": step_s * 1e3,
        "compile_step_s": snap["segments"]["compile"]["seconds"],
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
        "launches": launches, "plain_calls": plain,
        "loader": {"batches": n, "python_batches_per_s": py_rate,
                   "native_batches_per_s": nat_rate, "byte_equal": True,
                   "native_step_loss": native_loss},
    }


def _free_if(torch, dev) -> None:
    if dev.type == "cuda":
        _free(torch)


def run_save_attn_path(torch, seed: int, layers: int, batch: int,
                       device="cuda", v2: bool = False) -> dict:
    """Phase 6c.2: the flagship (``v2``: the GQA configuration with the
    three knobs) under ``remat_policy="save_attn"`` beside ``"full"``:
    for each, one warm-up and two timed steps on one batch (step ms, peak
    memory, flash launches per layer and step: 1/1/1 against 2/1/1, v2
    with 2 pre-passes against 3), then one batch-2 step's loss and
    gradients of both on the same parameters, held to phase 7's bf16
    limits."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    base = flagship_train_config(torch, layers, v2=v2)
    dev = torch.device(device)
    sync = _syncer(torch, dev)
    gen = torch.Generator().manual_seed(seed + 7)
    toks = torch.randint(0, base.vocab_size, (batch, base.max_seq + 1),
                         generator=gen).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    kernels = FLASH_V2_KERNELS if v2 else FLASH_KERNELS
    out, models = {}, {}
    timed = 2
    for policy in ("full", "save_attn"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        model = models[policy] = TransformerLM(cfg, device=dev)
        tr = Trainer(model, TrainConfig(warmup_steps=1), device=dev)
        tr.init(seed)
        tr.step(x, y)                                   # warm-up
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t0 = time.perf_counter()
        losses = [tr.step(x, y, sync=False) for _ in range(timed)]
        sync()
        wall = time.perf_counter() - t0
        launches = dict(fa.launch_counts)
        pre = fa.prepass_counts["flash_v2_rope_split"]
        plain = fa.plain_count
        fwd = 2 if policy == "full" else 1
        want = _counts(fa, {n: c * layers * timed for n, c in
                            zip(kernels, (fwd, 1, 1))})
        want_pre = (fwd + 1) * layers * timed if v2 else 0
        if dev.type == "cuda" and (launches != want or plain != 0
                                   or pre != want_pre):
            raise RuntimeError(f"{policy}: flash launches {launches}, "
                               f"pre-passes {pre}, plain calls {plain}; "
                               f"expected {want}, {want_pre} and 0")
        out[policy] = {
            # The trainer's params, moments and step alone on the card.
            "step_ms": wall / timed * 1e3,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if dev.type == "cuda" else None),
            "losses": [float(v) for v in losses],
            "launches": launches, "prepass_launches": pre,
            "plain_calls": plain,
        }
        del tr
        _free_if(torch, dev)
    # One batch-2 step's gradients of both on the parameters the trainers
    # started from (``Trainer.init(seed)`` draws ``model.init(seed)``).
    params = models["full"].init(seed, dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    grads = {policy: _loss_and_grads(torch, m, params, x[:2], y[:2])
             for policy, m in models.items()}
    (la, ga), (lb, gb) = grads["full"], grads["save_attn"]
    rel = {n: float((b.float() - a.float()).norm() / a.float().norm())
           for n, a, b in zip(_leaf_names(params), ga, gb)}
    tol = TRAIN_TOL["bfloat16"]
    if not (math.isfinite(lb) and abs(la - lb) <= tol["loss"]
            and max(rel.values()) <= tol["grad"]):
        raise RuntimeError(f"save_attn against full: loss {lb} vs {la}, "
                           f"gradient rel errors {rel}")
    out.update({"layers": layers, "batch": batch, "v2_knobs": v2,
                "loss_full": la, "loss_save_attn": lb,
                "grad_rel_err_max": max(rel.values()),
                "bit_equal": la == lb and all(torch.equal(a, b)
                                              for a, b in zip(ga, gb)),
                "tol": tol})
    del grads, ga, gb, params
    _free_if(torch, dev)
    return out


def _preempting_context(step: int, **kw):
    """The port's ``WorkloadContext`` with a heartbeat that raises
    ``WorkloadInterrupted`` once, at ``step``."""
    from k8s_gpu_tpu_torch.api import WorkloadContext, WorkloadInterrupted

    class Preempting(WorkloadContext):
        fired = False

        def heartbeat(self, s):
            super().heartbeat(s)
            if s == step and not self.fired:
                self.fired = True
                raise WorkloadInterrupted(f"preempted at step {s}")

    return Preempting(**kw)


def run_registry_path(torch, device="cuda", job_dir: str = JOB_DIR) -> dict:
    """Phase 6c.3: the registry's workloads on the card through the
    port's ``WorkloadContext``: ``lm-train``, ``lora-finetune`` and
    ``cnn-train`` at the reference's defaults (finite, falling losses);
    ``lm-train-ckpt`` at interval 2 interrupted at step 5 and run again
    (start 4, and under deterministic mode the last loss of an
    uninterrupted run, bit for bit); ``psum-smoke`` on a world of one and
    ``dist-psum-smoke`` over two gloo ranks on the card."""
    import shutil
    import types

    from k8s_gpu_tpu_torch.api import WorkloadInterrupted
    from k8s_gpu_tpu_torch.train import get_workload

    spec = types.SimpleNamespace
    out = {}
    for name in JOB_WORKLOADS:
        t0 = time.perf_counter()
        res = get_workload(name)(spec(workload_args={"device": device}), {})
        res["seconds"] = time.perf_counter() - t0
        if not (math.isfinite(res["first_loss"])
                and math.isfinite(res["last_loss"])
                and res["last_loss"] < res["first_loss"]):
            raise RuntimeError(f"{name}: {res}")
        out[name] = res
    run = get_workload("lm-train-ckpt")
    shutil.rmtree(job_dir, ignore_errors=True)
    args = {"device": device}
    _deterministic(torch, True)
    try:
        ctx = _preempting_context(5, checkpoint_dir=os.path.join(job_dir,
                                                                  "a"),
                                  checkpoint_interval=2)
        try:
            run(spec(workload_args=args), {}, ctx)
            raise RuntimeError("lm-train-ckpt was not interrupted")
        except WorkloadInterrupted:
            pass
        resumed = run(spec(workload_args=args), {}, ctx)
        straight = run(spec(workload_args=dict(
            args, checkpoint_dir=os.path.join(job_dir, "b"), interval=2)),
            {})
    finally:
        _deterministic(torch, False)
        shutil.rmtree(job_dir, ignore_errors=True)
    if not (resumed["start_step"] == 4 and resumed["resumed"]
            and resumed["last_loss"] == straight["last_loss"]):
        raise RuntimeError(f"lm-train-ckpt resumed {resumed}, "
                           f"uninterrupted {straight}")
    out["lm-train-ckpt"] = {"resumed": resumed, "uninterrupted": straight}
    # The parallel plane's two: a world of one on the card, and
    # two gloo ranks on it (NCCL refuses two ranks of one card, phase 10a).
    out["psum-smoke"] = get_workload("psum-smoke")(spec(workload_args=args),
                                                   {})
    out["dist-psum-smoke"] = get_workload("dist-psum-smoke")(
        spec(workload_args=dict(args, backend="gloo")), {})
    if not (out["psum-smoke"]["ok"] and out["psum-smoke"]["result"] == 0.0
            and out["dist-psum-smoke"] == {"processes": 2,
                                           "global_devices": 4,
                                           "psum": 6.0}):
        raise RuntimeError(f"psum workloads: {out['psum-smoke']}, "
                           f"{out['dist-psum-smoke']}")
    return out


# -- phase 8: Switch top-1 MoE at the flagship's widths ----------------------

# The repo's MoE variant, 4 experts at the default capacity factor 1.25
# (every MoE test and dry run of the reference sets it so), at the
# flagship's widths with nothing cut: 906,068,992 parameters, of which a
# token runs through 302,089,216 (one expert's MLP a layer, top-1).
MOE = dict(num_experts=4, capacity_factor=1.25)
MOE_TRAIN_STEPS = 3    # timed steps after one warm-up step
MOE_F32_LAYERS = 2     # the float32 identity runs
MOE_ID_NEW = 40        # tokens each identity request generates


def moe_active_params(cfg, n_params: int) -> int:
    """Parameters a token runs through under top-1 routing: all but E - 1
    of each layer's experts."""
    return n_params - (cfg.n_layers * (cfg.num_experts - 1) * 3
                       * cfg.d_model * cfg.d_ff)


def _recording_aux(model) -> list:
    """Wrap ``model.forward_train`` (an instance attribute): the aux loss of
    every call, as a device tensor, lands in the returned list."""
    auxes, fwd = [], model.forward_train

    def recording(params, tokens, mesh=None):
        logits, aux = fwd(params, tokens, mesh)
        auxes.append(aux.detach())
        return logits, aux

    model.forward_train = recording
    return auxes


def _counting_drops(torch, model) -> list:
    """Wrap ``model._moe_mlp``: each capped call (one layer of a prefill or
    a forward; on a mesh, of this rank's block) appends (the real tokens
    it dropped, its real tokens) as device tensors; a dropped token's MLP
    output is exactly 0."""
    drops, moe = [], model._moe_mlp

    def counting(x, lp, full_capacity=False, token_mask=None, **kw):
        y, aux = moe(x, lp, full_capacity=full_capacity,
                     token_mask=token_mask, **kw)
        if not full_capacity:
            real = (torch.ones(x.shape[:2], dtype=torch.bool,
                               device=x.device)
                    if token_mask is None else token_mask)
            drops.append((((y == 0).all(-1) & real).sum(), real.sum()))
        return y, aux

    model._moe_mlp = counting
    return drops


def run_moe_train_path(torch, seed: int, layers: int, batch: int,
                       steps: int = MOE_TRAIN_STEPS, device="cuda",
                       profile: bool = False) -> dict:
    """Phase 8a: the MoE flagship through the ``Trainer`` (f32 masters,
    bf16 compute, flash v1, full remat): one warm-up and ``steps`` timed
    steps on one batch, every loss finite and falling, aux > 0 each step,
    flash launches 2/1/1 a layer and step and no plain call; the tokens
    each layer drops at capacity 1.25 in a forward of that batch; then
    ``remat_policy="save_attn"``: one warm-up and one timed step, launches
    1/1/1, its two losses against full's first two (the warm-up's rate is
    0, so both steps see the same parameters) at phase 7's bf16 limit.
    ``profile``: one more full-remat step under torch.profiler."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.runner import (
        device_peak_flops, model_flops_per_step, tree_leaves,
    )

    base = dataclasses.replace(flagship_train_config(torch, layers), **MOE)
    dev = torch.device(device)
    sync = _syncer(torch, dev)
    gen = torch.Generator().manual_seed(seed + 11)
    toks = torch.randint(0, base.vocab_size, (batch, base.max_seq + 1),
                         generator=gen).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    peak = device_peak_flops()
    out = {"layers": layers, "batch": batch, "seq": base.max_seq, **MOE}
    for policy, timed in (("full", steps), ("save_attn", 1)):
        model = TransformerLM(dataclasses.replace(base, remat_policy=policy),
                              device=dev)
        auxes = _recording_aux(model)
        tr = Trainer(model, TrainConfig(warmup_steps=1), device=dev)
        tr.init(seed)
        n_params = sum(p.numel() for p in tree_leaves(tr.params))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = tr.step(x, y)                     # warm-up, learning rate 0
        warm_s = time.perf_counter() - t0
        sync()
        fa.reset_counts()
        t0 = time.perf_counter()
        losses = [tr.step(x, y, sync=False) for _ in range(timed)]
        sync()
        wall = time.perf_counter() - t0
        launches, plain = dict(fa.launch_counts), fa.plain_count
        losses = [first] + [float(v) for v in losses]
        aux = [float(a) for a in auxes]
        step_s = wall / timed
        run = {
            "losses": losses, "aux": aux, "warmup_step_s": warm_s,
            "timed_steps": timed, "step_ms": step_s * 1e3,
            "tokens_per_s": batch * base.max_seq / step_s,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if dev.type == "cuda" else None),
            "launches": launches, "plain_calls": plain,
        }
        if policy == "full":
            n_active = moe_active_params(base, n_params)
            flops = model_flops_per_step(base, n_params, batch)
            active = model_flops_per_step(base, n_active, batch)
            drops = _counting_drops(torch, model)
            with torch.no_grad():
                model.forward(tr.params, x)
            run.update({
                "n_params": n_params, "n_active_params": n_active,
                # The reference's convention: 6 N over all experts.
                "model_flops_per_step": flops,
                "train_mfu_all_experts": flops / step_s / peak if peak
                else None,
                # The work a token does: 6 N over the active parameters.
                "model_flops_per_step_active": active,
                "mfu_active_params": active / step_s / peak if peak
                else None,
                "tokens_dropped_per_layer": [int(d) for d, _ in drops],
                "tokens_per_layer": batch * base.max_seq,
            })
            if profile:
                prof = _start_profile(torch)
                t1 = time.perf_counter()
                tr.step(x, y)
                sync()
                prof_wall = time.perf_counter() - t1
                prof.__exit__(None, None, None)
                run["profile"] = _profile_summary(torch, prof, prof_wall)
        out[policy] = run
        fwd = 2 if policy == "full" else 1
        want = _counts(fa, {n: c * layers * timed for n, c in
                            zip(FLASH_KERNELS, (fwd, 1, 1))})
        if not all(math.isfinite(v) for v in losses + aux):
            raise RuntimeError(f"MoE {policy}: losses {losses}, aux {aux}")
        if not min(aux) > 0.0:
            raise RuntimeError(f"MoE {policy}: aux {aux} not positive")
        if dev.type == "cuda" and (launches != want or plain != 0):
            raise RuntimeError(f"MoE {policy}: flash launches {launches}, "
                               f"plain calls {plain}; expected {want}, 0")
        del tr, model
        _free_if(torch, dev)
    full, sa = out["full"], out["save_attn"]
    if not full["losses"][-1] < full["losses"][0]:
        raise RuntimeError(f"MoE loss did not fall: {full['losses']}")
    tol = TRAIN_TOL["bfloat16"]["loss"]
    gaps = [abs(a - b) for a, b in zip(sa["losses"], full["losses"])]
    out["save_attn_loss_gaps"] = gaps
    if not max(gaps) <= tol:
        raise RuntimeError(f"MoE save_attn losses {sa['losses']} against "
                           f"full's {full['losses'][:2]}: over {tol}")
    return out


def _moe_serve(torch, srv, jobs, repeat, sync, layers, profile=False):
    """Phase 8b's burst on one server: the jobs together over HTTP, the
    batcher's decode steps counted around them and the paged kernel's
    launches with them (``profile``: the burst under torch.profiler,
    entered on the scheduler thread); a repeated greedy request twice
    alone; /precache refused."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    b = srv.batcher
    sync()
    prof = _profile_batcher(torch, b) if profile else None
    steps0 = b.dispatched["decode_steps"]
    pa.reset_counts()
    t0 = time.perf_counter()
    outs = _serve_together(srv.port, jobs)
    sync()
    wall = time.perf_counter() - t0
    launches, fallbacks = pa.launch_count, pa.fallback_count
    steps = b.dispatched["decode_steps"] - steps0
    extra = {}
    if prof is not None:
        _stop_batcher_profile(b, prof)
        extra["profile"] = _profile_summary(torch, prof, wall)
    _check_budgets(outs, [n for _, n in jobs])
    again = [_post(srv.port, "/generate", repeat)[1].get("ids")
             for _ in range(2)]
    if again[0] != again[1] or len(again[0]) != repeat["max_new_tokens"]:
        raise RuntimeError("a repeated greedy MoE request changed its "
                           "stream")
    code, body = _post(srv.port, "/precache", {"prompt": "the experts"})
    if code != 400 or "MoE" not in body.get("error", ""):
        raise RuntimeError(f"/precache on an MoE server gave {code} {body}")
    return {**extra, **_burst_numbers(outs, wall), "layers": layers,
            "admissions": dict(b.admission_paths), "decode_steps": steps,
            "paged_attention_launches": launches,
            "paged_attention_fallbacks": fallbacks,
            "precache_refusal": body["error"]}


def run_moe_serve_path(torch, seed: int, layers: int, device="cuda",
                       profile: bool = False) -> dict:
    """Phase 8b: the MoE flagship in bf16 behind ``LmServer``: on the
    paged pool with the paged kernel (8 slots, phase 4's pool, pair and
    TRAFFIC mix; every admission ``cold``: MoE shares no blocks, so
    admissions wait for blocks that phase 4's pair shares; the kernel's
    launches exactly one a layer and decode step, no fall-back) and on
    the dense pool at ``LmServer``'s defaults (no paged launch).  Every
    budget met, a repeated greedy request stable, ``/precache`` answered
    with the reference's refusal, and the tokens each prefill dropped at
    capacity 1.25."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.serve import LmServer

    cfg = dataclasses.replace(flagship_config(torch, layers), **MOE)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    tok = flagship_tokenizer(cfg.vocab_size)
    rng = torch.Generator().manual_seed(seed + 13)
    prefix = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    pair, mix = _serving_jobs(torch, rng, cfg.vocab_size, prefix)
    jobs = pair + mix
    repeat = {"prompt_ids": mix[1][0], "max_new_tokens": mix[1][1]}
    n_blocks = mix_blocks(cfg)
    drops = _counting_drops(torch, model)
    out = {}
    for pool, kw in (("paged", dict(paged_blocks=n_blocks, page_size=PAGE,
                                    attn_impl="paged_kernel")),
                     ("dense", {})):
        srv = LmServer(model, params, tok, slots=8, max_new_tokens_cap=256,
                       device=device, **kw).start()
        try:
            drops.clear()
            run = _moe_serve(torch, srv, jobs, repeat, sync, layers,
                             profile)
        finally:
            srv.stop()
        # Each prefill's drops a layer, summed over the burst's prefills.
        run["prefill_tokens_dropped_per_layer"] = [
            sum(int(d) for d, _ in drops[i::layers]) for i in range(layers)]
        run["prefill_tokens"] = sum(int(n) for _, n in drops[::layers])
        out[pool] = run
        paths, launches = run["admissions"], run["paged_attention_launches"]
        if pool == "paged":
            run["paged_blocks"] = n_blocks
            if set(paths) != {"cold"}:
                raise RuntimeError(f"MoE paged admissions {paths}: not all "
                                   "cold")
            want = layers * run["decode_steps"]
            if device != "cpu" and (launches != want
                                    or run["paged_attention_fallbacks"]):
                raise RuntimeError(
                    f"MoE paged launches {launches}, fall-backs "
                    f"{run['paged_attention_fallbacks']}; {layers} x "
                    f"{run['decode_steps']} decode steps = {want}")
        elif launches or run["paged_attention_fallbacks"]:
            raise RuntimeError("the MoE dense pool went through the paged "
                               "kernel")
    return out


def _moe_identity_jobs(torch, rng, vocab: int) -> list:
    """Motifs repeated so that the n-gram draft finds matches, beside
    short and long unrepeated prompts."""
    def ids(n):
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    return ([(ids(8) * 12, MOE_ID_NEW), (ids(16) * 20, MOE_ID_NEW),
             (ids(5) * 7, MOE_ID_NEW)]
            + [(ids(p), MOE_ID_NEW) for p in (33, 120, 500)])


def _moe_forward(torch, engine, params, prompt, before) -> tuple:
    """The batcher's own MoE computation of ``prompt`` and then the
    stream ``before`` a token: the capped prefill of the left-padded
    prompt bucket, then ``before`` at full capacity (``extend_multi``,
    which routes as decode does); a prefill over both would route at
    another capacity.  On a meshed engine every rank calls it alike.
    Returns (the logits [V] at the last position, every layer's router
    at every position of the prompt and ``before``: {"expert": [L, P]
    top-1 choices, "gap": [L, P] top-2 probability gaps}, on the host)."""
    from k8s_gpu_tpu_torch.serve.scheduler import prompt_bucket

    dev, model = engine.device, engine.model
    n = len(prompt)
    bucket = prompt_bucket(n, engine.max_seq)
    route, probs = model._route_top1, []

    def recording(xt, lp):
        out = route(xt, lp)
        probs.append(out[0].float())
        return out

    def at(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    model._route_top1 = recording
    try:
        seq = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        seq[0, bucket - n:] = torch.tensor(prompt, dtype=torch.int32)
        cache, logits = engine.prefill(params, seq, bucket - n)
        if before:
            cache, ext = engine.extend_multi(
                params, cache, torch.tensor([list(before)],
                                            dtype=torch.int32, device=dev),
                at(bucket), at(n), at(bucket - n))
            logits = ext[:, -1]
    finally:
        del model._route_top1
    L = engine.cfg.n_layers
    rows = torch.stack([p[bucket - n:] for p in probs[:L]])     # [L, n, E]
    if before:
        rows = torch.cat([rows, torch.stack(probs[L:])], dim=1)
    top = torch.topk(rows, 2, dim=-1)
    return logits[0], {"expert": top.indices[..., 0].cpu(),
                       "gap": (top.values[..., 0]
                               - top.values[..., 1]).cpu()}


def _first_departure(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _moe_departures(torch, engine, params, jobs, plain, other,
                    limit) -> list:
    """``_departures`` for an MoE model: the plain logits at a departure
    come from the batcher's own computation (``_moe_forward``)."""
    found = []
    for i, ((prompt, _), a, b) in enumerate(zip(jobs, plain, other)):
        d = _first_departure(a, b)
        if d is None:
            continue
        logits, _ = _moe_forward(torch, engine, params, prompt, a[:d])
        top = torch.topk(logits.float(), 2).values
        gap = float(top[0] - top[1])
        found.append({"request": i, "position": d, "gap": gap})
        if not gap < limit:
            raise RuntimeError(
                f"request {i}: departs from plain at token {d}, where the "
                f"top-2 gap {gap} is not under {limit}")
    return found


def run_moe_identity(torch, seed: int, layers: int = MOE_F32_LAYERS,
                     device="cuda") -> dict:
    """Phase 8c: the MoE flagship in float32 at ``layers`` on the paged
    pool: greedy streams through the paged kernel against the gather
    read's, and a paged n-gram spec batcher (speculating every round)
    against the plain kernel streams, each first departing only where the
    plain logits' top-2 gap is under 1e-4 (phase 4e's float32 rule); the
    kernel batchers' launches exactly one a layer for every verify
    sub-round and decode step."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
    from k8s_gpu_tpu_torch.serve.scheduler import prompt_bucket

    cfg = dataclasses.replace(flagship_config(torch, layers), **MOE,
                              dtype=torch.float32)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    engine = InferenceEngine(model, device=model.device)
    sync = _syncer(torch, model.device)
    jobs = _moe_identity_jobs(torch, torch.Generator().manual_seed(seed + 17),
                              cfg.vocab_size)
    blocks = max(1 + cfg.max_seq // PAGE, 1 + sum(
        -(-(prompt_bucket(len(p), cfg.max_seq) + n) // PAGE)
        for p, n in jobs))
    streams, runs = {}, {}
    for name, impl, kw in (("gather", "gather", {}),
                           ("kernel", "paged_kernel", {}),
                           ("ngram", "paged_kernel",
                            {"draft": "ngram", "spec_k": SPEC_K})):
        b = ContinuousBatcher(model, params, slots=8, paged_blocks=blocks,
                              page_size=PAGE, attn_impl=impl, device=device,
                              **kw)
        if "draft" in kw:
            # Speculate every round: the gate's wall-clock measurements
            # would otherwise decide.
            b.ngram_breakeven = 0.0
            b._ngram_next_meas = {"plain": float("inf"),
                                  "spec": float("inf")}
        b.start()
        try:
            w0 = _paged_work(b)
            sync()
            pa.reset_counts()
            streams[name] = _run_handles(b, jobs)
            sync()
            work = {k: v - w0[k] for k, v in _paged_work(b).items()}
            run = {**work, "launches": pa.launch_count,
                   "fallbacks": pa.fallback_count,
                   "admissions": dict(b.admission_paths)}
            if "draft" in kw:
                run.update(_spec_summary(b))
        finally:
            b.stop()
        runs[name] = run
        want = layers * sum(work.values())
        if set(run["admissions"]) != {"cold"}:
            raise RuntimeError(f"MoE {name}: admissions {run['admissions']}")
        if device != "cpu" and impl == "paged_kernel" and (
                run["launches"] != want or run["fallbacks"]):
            raise RuntimeError(f"MoE {name}: paged launches "
                               f"{run['launches']}, fall-backs "
                               f"{run['fallbacks']}; {layers} x {work} = "
                               f"{want}")
    runs["kernel"]["departures_from_gather"] = _moe_departures(
        torch, engine, params, jobs, streams["gather"], streams["kernel"],
        F32_TIE_GAP)
    runs["ngram"]["departures_from_plain"] = _moe_departures(
        torch, engine, params, jobs, streams["kernel"], streams["ngram"],
        F32_TIE_GAP)
    if not runs["ngram"]["drafted"] > 0:
        raise RuntimeError("the MoE n-gram batcher drafted nothing")
    return {"layers": layers, "requests": len(jobs), "runs": runs}


# -- phase 9: the Fin-Agent-Suite on the card, and traced serving -----------

# The application's knowledge base: products, loans, cards and a FAQ, in
# Chinese and in English, each file one chunk under the 500/50 splitter
# (the reference's), so that an agent's prompt stays far inside the
# flagship's 2048 positions under phase 4's tokenizer, which encodes CJK
# text nearly byte by byte.
FIN_KB = {
    "products/gold.md": ("# 贵金属产品\n\n我们的贵金属产品包括黄金积存和白银账户。"
                         "黄金积存支持每日定投，起投金额为1克。"),
    "products/gold_en.md": ("# Precious metals\n\nGold savings accounts "
                            "support daily automatic investment from 1 "
                            "gram."),
    "products/loans.md": "# 贷款产品\n\n个人消费贷款年利率低至3.4%，最高额度50万元。",
    "products/loans_en.md": ("# Loans\n\nPersonal loans have annual rates "
                             "from 3.4 percent, up to 500,000 yuan."),
    "products/cards.md": "# 信用卡\n\n白金信用卡首年免年费，境外消费返现1%。",
    "products/cards_en.md": ("# Credit cards\n\nThe platinum credit card "
                             "has no annual fee in the first year and 1% "
                             "cashback abroad."),
    "faq/password.md": "# 常见问题\n\n如何重置密码？请前往设置页面点击重置。",
    "faq/password_en.md": ("# FAQ\n\nHow do I reset my password? Open "
                           "Settings and tap Reset."),
}
# Marketing queries and the file whose chunk each must retrieve first
# (cosine 0.44-0.91 on the CPU; a random unit row's is about 0.14 at best
# among a million).
FIN_MARKETING = [
    ("黄金积存支持每日定投吗？起投金额是多少？", "products/gold.md"),
    ("个人消费贷款年利率是多少，最高额度多少？", "products/loans.md"),
    ("白金信用卡首年有年费吗？境外消费返现多少？", "products/cards.md"),
    ("如何重置密码？在设置页面吗？", "faq/password.md"),
    ("Do gold savings accounts support daily automatic investment?",
     "products/gold_en.md"),
    ("What annual rates do personal loans have?", "products/loans_en.md"),
    ("Does the platinum credit card have an annual fee?",
     "products/cards_en.md"),
    ("How do I reset my password?", "faq/password_en.md"),
]
# Complaints (each carries one of the router's keywords) and their users.
FIN_COMPLAINTS = [
    ("我无法登录，人脸识别失败了，我要投诉", "user_123"),
    ("转账失败，我很不满", "u2"),
    ("I want to file a complaint about my card", "user_123"),
    ("my transfer failed twice", "u9"),
    ("手机银行登不上", "u3"),
    ("app login issue again", "user_123"),
    ("扣费有问题，我要投诉", "u4"),
    ("I am unhappy with the loan fees", "u5"),
]
# 9a's scale: VectorDBBench's 1M cases, at the 1024 dimensions the
# reference's schema fixes (智能风控解决方案.md:25, embed.py:24).  The rows
# are synthetic unit vectors drawn on the card from --seed.
FIN_ROWS = 1_000_000
FIN_BATCH = 100_000
FIN_QUERIES = 64
FIN_TOP = 3
# Exactness against float64: ids equal unless the float64 values of the
# two ids differ by under FIN_TIE; values within FIN_VALUE_TOL (float32
# sums of 1024 products of unit-row entries).
FIN_TIE = 1e-6
FIN_VALUE_TOL = 1e-4
FIN_NEW = 128          # HttpLMClient's default budget
FIN_TRACED = 8
FIN_DIR = os.path.join(ROOT, "build", "chip", "finagent")


def _write_kb(root: str) -> str:
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    for rel, text in FIN_KB.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text)
    return root


def _exact_top(torch, emb, q, k: int, metric: str, chunk: int = 131072):
    """float64 brute force over ``emb`` on its device, in chunks: the
    top ``k`` ids and values of each query row (L2: distances ascending;
    IP: scores descending)."""
    q64 = q.double()
    qsq = (q64 * q64).sum(-1, keepdim=True)
    best_v = best_i = None
    for lo in range(0, emb.shape[0], chunk):
        e = emb[lo:lo + chunk].double()
        dots = q64 @ e.T
        s = dots if metric == "IP" else -(qsq - 2.0 * dots
                                          + (e * e).sum(-1))
        v, i = torch.topk(s, min(k, s.shape[1]), dim=-1)
        i = i + lo
        if best_v is not None:
            v, j = torch.topk(torch.cat([best_v, v], -1), k, dim=-1)
            i = torch.gather(torch.cat([best_i, i], -1), -1, j)
        best_v, best_i = v, i
    if metric == "L2":
        best_v = torch.sqrt(torch.clamp(-best_v, min=0.0))
    return best_i, best_v


def _value64(torch, emb, q, ids, metric: str):
    """float64 distance (L2) or score (IP) of query row q to rows ids."""
    e = emb[ids].double()
    q64 = q.double()
    if metric == "IP":
        return e @ q64
    return torch.sqrt(((e - q64) ** 2).sum(-1))


def run_vector_path(torch, seed: int, device="cuda", rows: int = FIN_ROWS,
                    batch: int = FIN_BATCH, root: str = FIN_DIR):
    """9a: the knowledge base through the embedder, ``rows`` synthetic
    rows beside it, and FIN_QUERIES queries each metric held against a
    float64 brute force.  Returns (numbers, store, embedder)."""
    from k8s_gpu_tpu_torch.finagent import (
        SqlStore, TextEmbedder, VectorStore, ingest,
    )
    from k8s_gpu_tpu_torch.finagent.ingest import COLLECTION_NAME

    dev = torch.device(device)
    sync = _syncer(torch, dev)
    kb = _write_kb(os.path.join(root, "kb"))
    embedder = TextEmbedder(seed=seed, device=device)
    store = VectorStore(device=device)
    t0 = time.perf_counter()
    info = ingest(kb, store, SqlStore(), embedder=embedder)
    sync()
    ingest_s = time.perf_counter() - t0
    coll = store.collection(COLLECTION_NAME)
    chunks = list(coll._d.texts)
    if info["num_chunks"] != len(FIN_KB) or len(chunks) != len(FIN_KB):
        raise RuntimeError(f"ingest: {info}, {len(chunks)} chunks")
    # The embedder's two halves over the KB's chunks: the host's hashing,
    # then the device's product (after one warm-up call).
    t0 = time.perf_counter()
    feats = embedder.features(chunks)
    host_s = time.perf_counter() - t0
    embedder.project(feats)
    sync()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        embedder.project(feats)
    sync()
    dev_s = (time.perf_counter() - t0) / reps
    # The synthetic rows, batch by batch on the card, then one flush.
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    for lo in range(0, rows, batch):
        n = min(batch, rows - lo)
        x = torch.randn(n, embedder.dim, generator=gen, device=dev)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        coll.insert([f"synthetic row {lo + i}" for i in range(n)], x)
    del x
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    coll.flush()
    sync()
    flush_s = time.perf_counter() - t0
    peak_gb = ((torch.cuda.max_memory_allocated() - base) / 1e9
               if dev.type == "cuda" else None)
    emb, sq = coll._d.emb, coll._d.sq
    n_total = emb.shape[0]
    if n_total != rows + len(FIN_KB) or coll.num_entities != n_total:
        raise RuntimeError(f"{n_total} rows resident, "
                           f"{coll.num_entities} entities")
    resident_gb = (emb.numel() + sq.numel()) * 4 / 1e9
    # Queries: the app's queries through the embedder, the rest unit rows
    # drawn from the seed.
    texts = [q for q, _ in FIN_MARKETING] + [q for q, _ in FIN_COMPLAINTS]
    qs = embedder.encode_tensor(texts)
    extra = torch.randn(FIN_QUERIES - len(texts), embedder.dim,
                        generator=gen, device=dev)
    qs = torch.cat([qs, extra / torch.linalg.vector_norm(
        extra, dim=-1, keepdim=True)])
    out = {"rows": rows, "kb_chunks": len(chunks),
           "rows_are_synthetic": True, "ingest_s": ingest_s,
           "embed_host_chunks_per_s": len(chunks) / host_s,
           "embed_device_chunks_per_s": len(chunks) / dev_s,
           "flush_s": flush_s, "flush_peak_gb": peak_gb,
           "resident_gb": resident_gb}
    bound_bytes = (emb.numel() + sq.numel()) * 4 + embedder.dim * 4
    out["search_bound_ms"] = bound_bytes / HBM_BYTES_PER_S * 1e3
    for metric in ("L2", "IP"):
        coll.search(qs[0], limit=FIN_TOP, metric=metric)      # warm-up
        ref_i, ref_v = _exact_top(torch, emb, qs, FIN_TOP + 1, metric)
        ref_i, ref_v = ref_i.cpu(), ref_v.cpu()
        times, swaps, worst = [], 0, 0.0
        for qi in range(qs.shape[0]):
            t0 = time.perf_counter()
            hits = coll.search(qs[qi], limit=FIN_TOP, metric=metric)
            times.append(time.perf_counter() - t0)
            got = [h.id for h in hits]
            got64 = _value64(torch, emb, qs[qi],
                             torch.tensor(got, device=dev), metric).cpu()
            for r, h in enumerate(hits):
                want = float(ref_v[qi, r])
                if got[r] != int(ref_i[qi, r]):
                    if abs(float(got64[r]) - want) >= FIN_TIE:
                        raise RuntimeError(
                            f"{metric} query {qi} rank {r}: id {got[r]} "
                            f"(float64 {float(got64[r])!r}) against "
                            f"{int(ref_i[qi, r])} ({want!r})")
                    swaps += 1
                worst = max(worst, abs(h.distance - want))
            if worst > FIN_VALUE_TOL:
                raise RuntimeError(f"{metric} query {qi}: value off by "
                                   f"{worst} from float64")
            if qi < len(FIN_MARKETING):
                want_text = FIN_KB[FIN_MARKETING[qi][1]]
                if hits[0].text.strip() != want_text.strip():
                    raise RuntimeError(
                        f"{metric} query {FIN_MARKETING[qi][0]!r} found "
                        f"{hits[0].text[:40]!r} first, not its KB chunk")
        times.sort()
        out[metric] = {
            "search_ms_p50": times[len(times) // 2] * 1e3,
            "search_ms_p99": times[min(len(times) - 1,
                                       int(0.99 * len(times)))] * 1e3,
            "tie_swaps": swaps, "max_value_err_vs_f64": worst,
        }
    return out, store, embedder


def _post_chat(port: int, query: str, user: str, out: dict) -> None:
    t0 = time.perf_counter()
    code, body = _post(port, "/chat", {"query": query, "user_id": user})
    out.update(code=code, body=body, ms=(time.perf_counter() - t0) * 1e3)


def _metric_lines(text: str, name: str) -> dict:
    """{label value: sample} of one labelled family of an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            label = line.split('="', 1)[1].split('"', 1)[0]
            out[label] = float(line.rsplit(" ", 1)[1])
    return out


def run_finagent_serving(torch, seed: int, layers: int, store, embedder,
                         device="cuda", root: str = FIN_DIR) -> dict:
    """9b and 9c: the app over HTTP on the flagship's LmServer (paged
    pool, paged kernel), then traced /generate requests read back from
    the port's MetricsServer, untraced submits, the phase shares and a
    per-op trace of two decode rounds."""
    import shutil

    from k8s_gpu_tpu_torch.finagent import FinAgentApp, HttpLMClient
    from k8s_gpu_tpu_torch.finagent import SqlStore
    from k8s_gpu_tpu_torch.finagent.agents import (
        COMPLAINT_AGENT, MARKETING_AGENT,
    )
    from k8s_gpu_tpu_torch.finagent.server import serve_background
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import LmServer
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry
    from k8s_gpu_tpu_torch.utils.obs import MetricsServer
    from k8s_gpu_tpu_torch.utils.profiling import trace, trace_files
    from k8s_gpu_tpu_torch.utils.tracing import (
        SpanContext, format_traceparent, global_tracer, new_span_id,
        new_trace_id,
    )

    cfg = flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(seed)
    sync = _syncer(torch, model.device)
    tok = flagship_tokenizer(cfg.vocab_size)
    srv = LmServer(model, params, tok, slots=8, paged_blocks=mix_blocks(cfg),
                   page_size=PAGE, attn_impl="paged_kernel",
                   max_new_tokens_cap=256, metrics=MetricsRegistry(),
                   name="finagent-lm", device=device).start()
    obs = MetricsServer(registry=srv.batcher.metrics, journal=srv.journal,
                        profile=srv.profiler).start()
    sql = SqlStore()
    app = FinAgentApp(embedder=embedder, vectors=store, sql=sql,
                      llm=HttpLMClient(f"http://127.0.0.1:{srv.port}",
                                       max_new_tokens=FIN_NEW,
                                       timeout=600.0))
    app_srv, app_port = serve_background(app)
    out = {"layers": layers}
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{app_port}/",
                                    timeout=60) as r:
            status = json.loads(r.read())
        if status != {"status": "Fin-Agent-Suite is running."}:
            raise RuntimeError(f"/ answered {status}")
        # 9b: 16 /chat posts, 8 at a time, marketing and complaints mixed.
        jobs = []
        for (mq, _), (cq, user) in zip(FIN_MARKETING, FIN_COMPLAINTS):
            jobs += [(mq, "user_123", MARKETING_AGENT),
                     (cq, user, COMPLAINT_AGENT)]
        results = [dict() for _ in jobs]
        sync()
        pa.reset_counts()
        j0 = srv.journal.cursor
        t0 = time.perf_counter()
        for lo in (0, 8):
            threads = [_in_background(_post_chat, app_port, q, u,
                                      results[lo + i])
                       for i, (q, u, _) in enumerate(jobs[lo:lo + 8])]
            for th in threads:
                th.join(timeout=900)
        sync()
        wall = time.perf_counter() - t0
        launches, fallbacks = pa.launch_count, pa.fallback_count
        for (q, _, agent), res in zip(jobs, results):
            body = res.get("body") or {}
            if (res.get("code") != 200 or body.get("agent") != agent
                    or not isinstance(body.get("response"), str)
                    or not body["response"]):
                raise RuntimeError(f"/chat {q!r}: {res.get('code')} "
                                   f"{str(body)[:200]}")
        filed = sorted((u, d) for u, _, d, _ in sql.complaints())
        if filed != sorted((u, q) for q, u in FIN_COMPLAINTS):
            raise RuntimeError(f"complaints filed: {filed}")
        # The kernel runs on the card only (a CPU rehearsal skips this).
        on_card = model.device.type == "cuda"
        if on_card and (launches <= 0 or fallbacks != 0):
            raise RuntimeError(f"paged_attention launches {launches}, "
                               f"fall-backs {fallbacks} in 9b")
        recs = srv.journal.snapshot(limit=100, since=j0)
        if len(recs) != len(jobs):
            raise RuntimeError(f"{len(recs)} journal records for "
                               f"{len(jobs)} /chat posts")
        gen_tokens = sum(r["tokens"] for r in recs)
        by_agent = {}
        for (_, _, agent), res in zip(jobs, results):
            by_agent.setdefault(agent, []).append(res["ms"])
        out["chat"] = {
            "posts": len(jobs), "wall_s": wall,
            "generated_tokens": gen_tokens,
            "tokens_per_s": gen_tokens / wall,
            "prompt_tokens": sorted(r["prompt_tokens"] for r in recs),
            "latency_ms": {
                "marketing" if a == MARKETING_AGENT else "complaint": {
                    "p50": sorted(v)[len(v) // 2], "max": max(v)}
                for a, v in by_agent.items()},
            "paged_attention_launches": launches,
            "paged_attention_fallbacks": fallbacks,
        }
        # 9c: traced /generate requests, read back from the MetricsServer.
        pa.reset_counts()
        ctxs = [SpanContext(new_trace_id(), new_span_id())
                for _ in range(FIN_TRACED)]
        gen = [dict() for _ in ctxs]

        def traced(i):
            code, body = _post(
                srv.port, "/generate",
                {"prompt": f"{FIN_MARKETING[i][0]} ({i})",
                 "max_new_tokens": 48},
                headers={"traceparent": format_traceparent(ctxs[i])})
            gen[i].update(code=code, body=body)

        threads = [_in_background(traced, i) for i in range(FIN_TRACED)]
        for th in threads:
            th.join(timeout=900)
        _wait_inflight(srv, False)
        rounds_seen = 0
        for ctx, g in zip(ctxs, gen):
            if g.get("code") != 200:
                raise RuntimeError(f"traced /generate: {g}")
            code, body = _get_json(obs.port,
                                   f"/debug/traces?trace_id={ctx.trace_id}")
            traces = body["traces"]
            spans = [n for t in traces for r in t["tree"]
                     for n in _walk_spans(r)]
            names = [s["name"] for s in spans]
            rounds = [s for s in spans if s["name"] == "serve.round"]
            if ("serve.queue_wait" not in names
                    or "serve.prefill" not in names or not rounds):
                raise RuntimeError(f"trace {ctx.trace_id}: {names}")
            toks = sum(s["attributes"]["tokens"] for s in rounds)
            if toks < g["body"]["generated_tokens"] - 1:
                raise RuntimeError(f"trace {ctx.trace_id}: rounds carry "
                                   f"{toks} tokens of "
                                   f"{g['body']['generated_tokens']}")
            rounds_seen += len(rounds)
        # Untraced: direct submits record no serve.* span.
        global_tracer.clear()
        rng = torch.Generator().manual_seed(seed + 19)
        handles = [srv.batcher.submit(
            torch.randint(0, cfg.vocab_size, (64,), generator=rng).numpy(),
            max_new_tokens=16) for _ in range(FIN_TRACED)]
        for h in handles:
            if len(h.result()) != 16:
                raise RuntimeError("an untraced request missed its budget")
        _wait_inflight(srv, False)
        leaked = [n["name"] for t in global_tracer.traces(limit=1000)
                  for r in t["tree"] for n in _walk_spans(r)
                  if n["name"].startswith("serve.")]
        if leaked:
            raise RuntimeError(f"untraced requests recorded {leaked}")
        # The phase shares on /metrics.
        srv.profiler.export_shares()
        code, text = _get_text(obs.port, "/metrics")
        shares = _metric_lines(text, "serve_phase_share")
        want = {"admission", "paged_plan", "prefill_dispatch",
                "decode_dispatch", "decode_consume", "retire", "residual"}
        if not want <= set(shares) or sum(shares.values()) > 1.0 + 1e-9:
            raise RuntimeError(f"serve_phase_share: {shares}")
        # A per-op trace of two decode rounds, entered and left on the
        # scheduler thread (torch.profiler records that thread's ops).
        b = srv.batcher
        tdir = os.path.join(root, "trace")
        shutil.rmtree(tdir, ignore_errors=True)
        solo = b.solo_buckets
        b.solo_buckets = [b.steps_per_round]
        try:
            cm = trace(tdir)
            b.run_quiesced(cm.__enter__)
            r0 = b.steps_taken
            h = b.submit(torch.randint(0, cfg.vocab_size, (64,),
                                       generator=rng).numpy(),
                         max_new_tokens=1 + 2 * b.steps_per_round)
            h.result()
            b.run_quiesced(lambda: cm.__exit__(None, None, None),
                           timeout_s=600.0)
            traced_rounds = b.steps_taken - r0
        finally:
            b.solo_buckets = solo
        files = trace_files(tdir)
        trace_bytes = sum(os.path.getsize(f) for f in files)
        shutil.rmtree(tdir, ignore_errors=True)
        if traced_rounds != 2 or not files or trace_bytes <= 0:
            raise RuntimeError(f"trace of {traced_rounds} rounds: "
                               f"{files}, {trace_bytes} bytes")
        launches9c, fallbacks9c = pa.launch_count, pa.fallback_count
        if on_card and (launches9c <= 0 or fallbacks9c != 0):
            raise RuntimeError(f"paged_attention launches {launches9c}, "
                               f"fall-backs {fallbacks9c} in 9c")
        out["traced"] = {
            "requests": FIN_TRACED, "round_spans": rounds_seen,
            "phase_share": shares,
            "trace_file_bytes": trace_bytes, "traced_rounds": traced_rounds,
            "paged_attention_launches": launches9c,
        }
        out["paged_attention_launches"] = launches + launches9c
    finally:
        app_srv.shutdown()
        app_srv.server_close()
        obs.stop()
        srv.stop()
    return out


def run_client_path(torch, seed: int, store, embedder, device="cuda") -> dict:
    """9d: ``TorchLMClient`` at its default model in the app, two /chat
    calls: greedy, then sampled."""
    from k8s_gpu_tpu_torch.finagent import (
        FinAgentApp, SqlStore, TorchLMClient,
    )
    from k8s_gpu_tpu_torch.finagent.agents import (
        COMPLAINT_AGENT, MARKETING_AGENT,
    )
    from k8s_gpu_tpu_torch.finagent.server import serve_background

    greedy = TorchLMClient(temperature=0.0, seed=seed, device=device)
    sampled = TorchLMClient(model=greedy.model, params=greedy.params,
                            seed=seed, device=device)
    out = {}
    for name, lm, (query, user), agent in (
            ("greedy", greedy, (FIN_MARKETING[0][0], "user_123"),
             MARKETING_AGENT),
            ("sampled", sampled, FIN_COMPLAINTS[0], COMPLAINT_AGENT)):
        app = FinAgentApp(embedder=embedder, vectors=store, sql=SqlStore(),
                          llm=lm)
        srv, port = serve_background(app)
        try:
            res = {}
            _post_chat(port, query, user, res)
        finally:
            srv.shutdown()
            srv.server_close()
        body = res.get("body") or {}
        if res.get("code") != 200 or body.get("agent") != agent or (
                not isinstance(body.get("response"), str)):
            raise RuntimeError(f"9d {name}: {res}")
        out[name] = {"ms": res["ms"],
                     "response_bytes": len(body["response"].encode())}
    return out


def _walk_spans(node):
    yield node
    for c in node.get("children", ()):
        yield from _walk_spans(c)


def _get_text(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


def _get_json(port: int, path: str):
    code, text = _get_text(port, path)
    return code, json.loads(text)


def run_finagent_path(torch, seed: int, layers: int, device="cuda",
                      rows: int = FIN_ROWS, batch: int = FIN_BATCH) -> dict:
    """Phase 9: 9a, then 9b and 9c on its store, then 9d."""
    t0 = time.perf_counter()
    vec, store, embedder = run_vector_path(torch, seed, device, rows, batch)
    serving = run_finagent_serving(torch, seed, layers, store, embedder,
                                   device)
    client = run_client_path(torch, seed, store, embedder, device)
    return {"vector": vec, **serving, "client": client,
            "phase_s": time.perf_counter() - t0}


# -- phase 7: the training output against plain attention ---------------------

# One step's loss and gradients with flash attention against the same with
# plain attention (same params, same batch).  bf16 at full depth: the two
# attention paths round to bf16 at different points and the difference
# compounds through 16 layers of bf16 activations; the gradient error is
# ||g_flash - g_plain|| / ||g_plain|| per leaf.  float32 at 2 layers: the
# paths differ only in summation order.
TRAIN_TOL = {"bfloat16": {"loss": 1e-2, "grad": 5e-2},
             "float32": {"loss": 1e-5, "grad": 1e-4}}
# Phase 7b: the v2 configuration against the same GQA configuration with
# the knobs off (v1, rope outside the kernel, K/V repeated).  bf16 at full
# depth: v1 rounds the rotated q and k to bf16 and v2 keeps them in f32,
# one bf16 rounding (2^-9 relative) compounding through 16 layers as in
# phase 7.  float32 at 2 layers: v1's frequencies (pow) and v2's (exp)
# differ by an ulp, which at position 2047 turns the angle by up to ~1e-4
# rad, so q and k differ by up to ~1e-4 of their size at late positions;
# over all positions the gradients moved by 2e-5 of their norm in a CPU
# run of this check, held at 10x that.
V2_TRAIN_TOL = {"bfloat16": {"loss": 1e-2, "grad": 5e-2},
                "float32": {"loss": 1e-5, "grad": 2e-4}}


def _leaf_names(tree, prefix="") -> list[str]:
    """Paths of a nested dict's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _loss_and_grads(torch, model, params, x, y):
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    loss = model.loss(params, x, y)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.item(), grads


def check_train_outputs(torch, seed: int, layers: int, device="cuda",
                        v2: bool = False) -> dict:
    """``layers`` deep in bf16, 2 layers in float32: flash against plain
    attention, or with ``v2`` the v2 configuration against the same with
    the knobs off.  On the card, each side's flash launches are those of
    its own kernels only."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.train import Trainer

    if v2:
        sides = (("v2", V2_KNOBS, FLASH_V2_KERNELS),
                 ("v1", V2_OFF, FLASH_KERNELS))
        tols = V2_TRAIN_TOL
    else:
        sides = (("flash", {}, FLASH_KERNELS),
                 ("plain", dict(use_flash=False), {}))
        tols = TRAIN_TOL
    out = {}
    for tname, depth in (("bfloat16", layers), ("float32", 2)):
        cfg = flagship_train_config(torch, depth, getattr(torch, tname), v2)
        runs = {}
        params = None
        for side, knobs, kernels in sides:
            model = TransformerLM(dataclasses.replace(cfg, **knobs),
                                  device=device)
            if params is None:
                trainer = Trainer(model, device=device)
                trainer.init(seed + 3)
                params = trainer.params
                rng = torch.Generator().manual_seed(seed + 4)
                toks = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq + 1),
                                     generator=rng).to(model.device)
            fa.reset_counts()
            runs[side] = _loss_and_grads(torch, model, params,
                                         toks[:, :-1], toks[:, 1:])
            launched = dict(fa.launch_counts)
            want = _counts(fa, {n: c * depth for n, c in
                                zip(kernels, (2, 1, 1))})
            if model.device.type == "cuda" and launched != want:
                raise RuntimeError(f"{tname} {side}: launches {launched}, "
                                   f"expected {want}")
        (la, ga), (lb, gb) = (runs[side] for side, _, _ in sides)
        rel = {n: float((a.float() - b.float()).norm() / b.float().norm())
               for n, a, b in zip(_leaf_names(params), ga, gb)}
        tol = tols[tname]
        names = [side for side, _, _ in sides]
        if not (math.isfinite(la) and abs(la - lb) <= tol["loss"]):
            raise RuntimeError(f"{tname}: {names[0]} loss {la} vs "
                               f"{names[1]} {lb}")
        if not max(rel.values()) <= tol["grad"]:
            raise RuntimeError(f"{tname}: gradient rel errors {rel} > "
                               f"{tol['grad']}")
        out[tname] = {"layers": depth, f"loss_{names[0]}": la,
                      f"loss_{names[1]}": lb, "loss_diff": abs(la - lb),
                      "grad_rel_err": rel, "tol": tol}
        del runs, ga, gb, params
        _free(torch)
    return out


# -- phase 10: the parallel plane --------------------------------------------

# The headline run: the v2 training configuration (flagship widths, 2 KV
# heads, the v2 knobs) at max_seq 4096 over a dp 2 x sp 2 mesh of four
# ranks on the one card, global batch 4 x 4096, 2 microbatches, ZeRO-1.
PAR_WORLD = 4
# Phases 10 and 11 run at a quarter of the flagship's depth and phase 12
# at half within the whole script (the 1200 s limit; interleaved 1F1B
# over pp 4 x v 2 needs 8 layers).  The tool runs them at 16.
PAR_LAYERS = 4
PP_LAYERS = 8
PAR_SEQ = 4096
PAR_SP = 2
PAR_BATCH = 4
PAR_ACCUM = 2
PAR_STEPS = 3          # timed steps after the warm-up step
# Phase 10d: float32 sp attention and the meshed step against the whole
# sequence on one rank, relative to the largest value (phase 3's float32
# limit).
PAR_F32_TOL = 1e-4
# The least share of parameters whose update 10d holds (the rest have a
# gradient at rounding level, or none: embedding rows no token selects).
PAR_UPDATE_SHARE = 0.5
PAR_TIMEOUT = 400.0
# The collectives a gloo group is asked to run on CUDA tensors as they
# are (phase 10b): what PyTorch's gloo backend takes on the card.
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather",
                 "all_to_all_single", "send_recv")


def parallel_config(torch, layers: int, dtype=None,
                    sp_attention: str = "ring", seq: int = PAR_SEQ):
    import dataclasses

    return dataclasses.replace(
        flagship_train_config(torch, layers, dtype, v2=True),
        max_seq=seq, sp_attention=sp_attention)


def _par_tokens(torch, seed: int, cfg, batch: int = PAR_BATCH):
    """The global batch [batch, seq + 1], the same on every rank."""
    rng = torch.Generator().manual_seed(seed + 2)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=rng)


def _gloo_cuda_op(op: str) -> str:
    """One collective of two gloo ranks on CUDA tensors handed over as
    they are; "ok" when it gives the right values."""
    import torch
    import torch.distributed as dist

    me = dist.get_rank()
    x = torch.full((4,), float(me + 1), device="cuda")
    if op == "all_reduce":
        dist.all_reduce(x)
        want = [3.0] * 4
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        want = [1.0] * 4
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        x, want = torch.cat(parts), [1.0] * 4 + [2.0] * 4
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        x, want = out, [1.0, 1.0, 2.0, 2.0]
    else:
        out = torch.empty_like(x)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - me),
                dist.P2POp(dist.irecv, out, 1 - me)]):
            req.wait()
        x, want = out, [float(2 - me)] * 4
    torch.cuda.synchronize()
    got = x.cpu().tolist()
    return "ok" if got == want else f"wrong values {got}"


def _last_error(e: Exception) -> str:
    """The telling line of a failed cluster: NCCL's or gloo's own words
    where a worker's log has them."""
    lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
    for key in ("Duplicate GPU", "NCCL error", "Error", "error"):
        hits = [ln for ln in lines if key in ln]
        if hits:
            return hits[-1][:400]
    return lines[-1][:400] if lines else repr(e)


def run_parallel_probes(torch) -> dict:
    """Phase 10a-b: two NCCL ranks on the one card (NCCL's answer), the
    NCCL psum smoke on a world of one, and which collectives gloo takes
    on CUDA tensors as they are, each asked of its own two-rank cluster
    (all side by side)."""
    import functools
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    import chip_smoke
    from k8s_gpu_tpu_torch.parallel.collectives import psum_smoke
    from k8s_gpu_tpu_torch.parallel.multihost import (
        _free_port, spawn_local_cluster, workload_global_psum,
    )

    def cluster(fn, backend):
        try:
            return {"ok": True, "result": spawn_local_cluster(
                fn, 2, timeout=120.0, device="cuda", backend=backend)}
        except RuntimeError as e:
            return {"ok": False, "message": _last_error(e)}

    with ThreadPoolExecutor(1 + len(GLOO_CUDA_OPS)) as pool:
        nccl = pool.submit(cluster, functools.partial(
            workload_global_psum, device="cuda"), "nccl")
        gloo = {op: pool.submit(cluster, functools.partial(
            chip_smoke._gloo_cuda_op, op), "gloo") for op in GLOO_CUDA_OPS}
        nccl_two = nccl.result()
        gloo_ops = {op: (f.result()["result"][0] if f.result()["ok"]
                         else f"refused: {f.result()['message']}")
                    for op, f in gloo.items()}
    print(json.dumps({"parallel_nccl_two_ranks": nccl_two,
                      "gloo_cuda_ops": gloo_ops}), flush=True)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        nccl_one = psum_smoke(device="cuda")
    finally:
        dist.destroy_process_group()
    if not nccl_one["ok"]:
        raise RuntimeError(f"NCCL psum smoke on one rank: {nccl_one}")
    return {"nccl_two_ranks": nccl_two, "nccl_psum_one_rank": nccl_one,
            "gloo_cuda_ops": gloo_ops}


def one_rank_reference_loss(torch, seed: int, layers: int, seq: int,
                            device="cuda", cfg=None, batch: int = PAR_BATCH,
                            accum: int = PAR_ACCUM) -> dict:
    """Phase 10c's and 11's yardstick: the first step's loss of the same
    configuration (default: phase 10's, through the existing flash-v2
    path, rope and the P 2 pipeline in the kernels) on one rank over the
    whole batch; for an MoE ``cfg`` also the share of token-layers its
    first step dropped."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    cfg = cfg or parallel_config(torch, layers, seq=seq)
    trainer = Trainer(TransformerLM(cfg, device=device),
                      TrainConfig(warmup_steps=1, grad_accum_steps=accum),
                      device=device)
    trainer.init(seed)
    toks = _par_tokens(torch, seed, cfg, batch)
    drops = _counting_drops(torch, trainer.model) if cfg.moe else None
    t0 = time.perf_counter()
    loss = trainer.step(toks[:, :-1], toks[:, 1:])
    wall = time.perf_counter() - t0
    share = _drop_share(drops) if cfg.moe else None
    if cfg.moe:
        del trainer.model._moe_mlp
    # A second step, timed: the work of the four ranks' step on one rank
    # with the whole card and no transfer.
    t0 = time.perf_counter()
    trainer.step(toks[:, :-1], toks[:, 1:])
    step_s = time.perf_counter() - t0
    del trainer
    _free_if(torch, torch.device(device))
    return {"loss": loss, "first_step_s": wall, "step_ms": step_s * 1e3,
            **({"dropped_share": share} if cfg.moe else {})}


def _drop_share(drops) -> float:
    """The share of token-layers ``_counting_drops`` saw dropped."""
    return (sum(int(d) for d, _ in drops)
            / max(1, sum(int(n) for _, n in drops)))


# The port's transfers, by the name the timing below reports them under:
# (module, attribute) of each function that moves a tensor between ranks.
# In ``collectives``, ``all_reduce`` carries copy_to, reduce_from and
# all_reduce_sum (the tp and ep traffic) and ``all_gather`` gather_from;
# the runner's are the gradient all-reduce, the global norm's and ZeRO-1's
# gathers; the model's, the vocabulary's row max and the MoE slot counts;
# the pipeline's, 1F1B's one sum over pp (its hops are ``_ppermute``'s,
# GPipe's share and input sum ``collectives.all_reduce``'s).
_TRANSFERS = (("collectives", "_ppermute"), ("collectives", "_all_to_all"),
              ("collectives", "all_reduce"), ("collectives", "all_gather"),
              ("runner", "all_reduce"), ("runner", "all_gather"),
              ("transformer", "all_reduce"), ("transformer", "all_gather"),
              ("pipeline", "all_reduce"))


def _group_labels(mesh) -> dict:
    """{id(process group): the mesh axes it spans} for every group of
    ``mesh`` a transfer may name."""
    from k8s_gpu_tpu_torch.parallel.mesh import AXES, axis_group, axis_size

    labels = {}
    for axes in [(a,) for a in AXES] + [("dp", "sp"), ("ep", "tp"),
                                        ("pp", "tp")]:
        group = axis_group(mesh, *axes)
        if group is not None:
            labels.setdefault(id(group), ",".join(
                a for a in axes if axis_size(mesh, a) > 1))
    return labels


def _timing_transfers(torch, dev, mesh):
    """Wrap the port's transfer functions so each call adds its wall
    seconds, the card synchronized before and after (so no queued
    compute is counted), under "module.name[axes]" (the mesh axes of its
    group); returns (the seconds by name, a function that undoes the
    wrapping)."""
    from k8s_gpu_tpu_torch.models import transformer
    from k8s_gpu_tpu_torch.parallel import collectives, pipeline
    from k8s_gpu_tpu_torch.train import runner

    mods = {"collectives": collectives, "runner": runner,
            "transformer": transformer, "pipeline": pipeline}
    labels = _group_labels(mesh)
    spent: dict[str, float] = {}
    saved = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for mod, name in _TRANSFERS:
        fn = getattr(mods[mod], name)
        saved.append((mods[mod], name, fn))

        def timed(*a, _fn=fn, _name=f"{mod}.{name.lstrip('_')}", **kw):
            group = a[1] if len(a) > 1 else kw.get("group")
            key = f"{_name}[{labels.get(id(group), 'world')}]"
            sync()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                sync()
                spent[key] = spent.get(key, 0.0) + (time.perf_counter() - t0)

        setattr(mods[mod], name, timed)
    return spent, lambda: [setattr(m, n, f) for m, n, f in saved]


def _mesh_train(torch, seed: int, cfg, mesh, toks, device, *, accum: int,
                steps: int, zero1: bool = True) -> dict:
    """One rank's training run on ``mesh``, from the parameters of
    ``seed``, over the global batch ``toks`` [B, S + 1]: a warm-up step
    (learning rate 0; for an MoE model its dropped token-layers counted)
    and ``steps`` timed ones on the same batch, with this rank's flash
    launches, pre-passes, plain calls and fallbacks over the timed
    steps; then one more step with every transfer timed
    (``_timing_transfers``)."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.utils.metrics import global_metrics

    trainer = Trainer(TransformerLM(cfg, device=device),
                      TrainConfig(warmup_steps=1, grad_accum_steps=accum,
                                  zero1=zero1), device=device, mesh=mesh)
    trainer.init(seed)
    x, y = toks[:, :-1], toks[:, 1:]
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drops = _counting_drops(torch, trainer.model) if cfg.moe else None
    t0 = time.perf_counter()
    first = trainer.step(x, y)
    warm_s = time.perf_counter() - t0
    if cfg.moe:
        del trainer.model._moe_mlp
    dist.barrier()
    fa.reset_counts()

    def fallbacks():
        return {r: global_metrics.counter("flash_fallback_total", reason=r)
                for r in ("sp_fused_rope", "ulysses_kv_heads")}

    before = fallbacks()
    t0 = time.perf_counter()
    losses = [trainer.step(x, y) for _ in range(steps)]
    wall = time.perf_counter() - t0
    out = {"losses": [first] + losses, "warmup_step_s": warm_s,
           "step_s": wall / steps, "launches": dict(fa.launch_counts),
           "prepass_launches": fa.prepass_counts["flash_v2_rope_split"],
           "plain_calls": fa.plain_count,
           **{r: n - before[r] for r, n in fallbacks().items()},
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None),
           "n_params": trainer.n_params()}
    if cfg.moe:
        out["dropped_share"] = _drop_share(drops)
    # One more step with every transfer timed (the card synchronized
    # around each): where the step's wall goes.
    spent, undo = _timing_transfers(torch, trainer.device, mesh)
    dist.barrier()
    t0 = time.perf_counter()
    try:
        trainer.step(x, y)
    finally:
        undo()
    out["timed_transfer_step_s"] = time.perf_counter() - t0
    out["transfer_s"] = spent
    del trainer
    _free_if(torch, torch.device(device))
    return out


def _par_train(torch, seed: int, layers: int, seq: int, mesh,
               sp_attention: str, device) -> dict:
    """One rank's run of phase 10c (``_mesh_train``): PAR_STEPS timed
    steps of the v2 configuration at ``seq`` over PAR_BATCH rows."""
    cfg = parallel_config(torch, layers, sp_attention=sp_attention, seq=seq)
    return _mesh_train(torch, seed, cfg, mesh, _par_tokens(torch, seed, cfg),
                       device, accum=PAR_ACCUM, steps=PAR_STEPS)


def _par_block(t, mesh):
    """This rank's [B/dp, ., S/sp, .] block of a global [B, H, S, D]."""
    from k8s_gpu_tpu_torch.parallel.mesh import axis_rank, mesh_shape

    shape = mesh_shape(mesh)
    t = t.chunk(shape["dp"], 0)[axis_rank(mesh, "dp")]
    return t.chunk(shape["sp"], 2)[axis_rank(mesh, "sp")].contiguous()


def _par_attention_f32(torch, seed: int, meshes: dict, seq: int,
                       device) -> dict:
    """Phase 10d.1: float32 ring at sp 4 and Ulysses at sp 2 (GQA, the
    flagship's heads at 4096 tokens), output and q/k/v gradients against
    one whole-sequence flash-v2 call on the same inputs."""
    from k8s_gpu_tpu_torch.ops.attention import flash_attention_v2
    from k8s_gpu_tpu_torch.parallel.ring_attention import ring_attention
    from k8s_gpu_tpu_torch.parallel.ulysses import ulysses_attention

    gen = torch.Generator(device=device).manual_seed(seed + 7)
    B, H, KH, D = 2, 8, 2, 128
    q, k, v, g = (torch.randn(s, generator=gen, device=device)
                  for s in ((B, H, seq, D), (B, KH, seq, D),
                            (B, KH, seq, D), (B, H, seq, D)))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o_ref = flash_attention_v2(qr, kr, vr, causal=True)
    torch.autograd.backward(o_ref, g)
    ref = {"out": o_ref.detach(), "dq": qr.grad, "dk": kr.grad,
           "dv": vr.grad}
    out = {}
    for name, fn, mesh in (("ring_sp4", ring_attention, meshes["sp4"]),
                           ("ulysses_sp2", ulysses_attention,
                            meshes["dp2sp2"])):
        ql, kl, vl = (_par_block(t, mesh).requires_grad_()
                      for t in (q, k, v))
        o = fn(ql, kl, vl, mesh)
        torch.autograd.backward(o, _par_block(g, mesh))
        errs = {f: _max_rel(x.detach(), _par_block(ref[f], mesh))
                for f, x in (("out", o), ("dq", ql.grad), ("dk", kl.grad),
                             ("dv", vl.grad))}
        if not max(errs.values()) <= PAR_F32_TOL:
            raise RuntimeError(f"float32 {name} vs whole-sequence flash: "
                               f"{errs} > {PAR_F32_TOL}")
        out[name] = errs
    return out


def _recording_grads(trainer) -> list:
    """The gradients each step hands AdamW (after the mesh's
    all-reduce), recorded as float32 copies."""
    seen = []
    update = trainer.optimizer.update

    def record(params, grads):
        seen.append([g.detach().float().clone() for g in grads])
        update(params, grads)

    trainer.optimizer.update = record
    return seen


def _update_rel_err(theta0, meshed, one, g_meshed, g_one) -> tuple:
    """How far the meshed step's update (theta1 - theta0) is from one
    rank's, relative to the largest update of each leaf, over the
    elements whose update the gradients decide: AdamW's first update is
    about lr times the sign of each gradient, so an element whose
    gradient is within 1000x of the two sides' largest gradient
    difference (or within 100x of AdamW's eps) may move either way and
    is left out.  Returns (the largest error, the share of elements
    held)."""
    err, held, total = 0.0, 0, 0
    for p0, pm, po, gm, go in zip(theta0, meshed, one, g_meshed, g_one):
        noise = float((gm - go).abs().max())
        keep = (go.abs() > 1e3 * noise) & (go.abs() > 1e-6)
        total += keep.numel()
        if not keep.any():
            continue
        held += int(keep.sum())
        dm, do = (pm.detach() - p0)[keep], (po.detach() - p0)[keep]
        err = max(err, float((dm - do).abs().max() / do.abs().max()))
    return err, held / total


def _par_step_f32(torch, seed: int, mesh, seq: int, device) -> dict:
    """Phase 10d.2: one float32 step of 2 layers at the flagship's widths
    over the dp x sp mesh (ring, ZeRO-1, 2 microbatches) against one
    rank's step over the whole batch (``_meshed_step_f32``).  Rope stays
    outside the kernels on both sides, so they differ in summation order
    only."""
    import dataclasses

    cfg = dataclasses.replace(parallel_config(torch, 2, torch.float32,
                                              seq=seq),
                              flash_fuse_rope=False)
    return _meshed_step_f32(torch, seed, cfg, mesh,
                            _par_tokens(torch, seed + 1, cfg), PAR_ACCUM,
                            device)


def _meshed_step_f32(torch, seed: int, cfg, mesh, toks, accum: int,
                     device) -> dict:
    """One float32 step of ``cfg`` over ``mesh`` (ZeRO-1, ``accum``
    microbatches) against one rank's step over the whole batch, which
    rank 0 computes: the loss, the gradients AdamW is handed (gathered
    over tp and ep; relative to each leaf's norm) and the update each
    parameter took (``_update_rel_err``; at a learning rate of 1e-2, so
    that a float32 rounding of a parameter near 1 is 1e-5 of the
    update), every one within PAR_F32_TOL.  An update the ZeRO-1 slices
    missed, took from the wrong slice of the gradient or did not gather
    back is off by about the whole update.  Every rank's checksum of the
    gathered parameters, which must agree, comes back too, and for an
    MoE model the token-layers each side's step dropped; on a pp mesh
    also a checksum of the gathered gradients of the leaves pp leaves
    whole, which must agree on every rank."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.parallel.collectives import all_reduce
    from k8s_gpu_tpu_torch.parallel.mesh import axis_size, batch_group
    from k8s_gpu_tpu_torch.parallel.sharding import gather_params
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.runner import tree_leaves, tree_like

    # A cosine schedule without warm-up moves the parameters at step 1.
    tc = dict(warmup_steps=0, schedule="cosine", decay_steps=100,
              learning_rate=1e-2, grad_accum_steps=accum)
    x, y = toks[:, :-1], toks[:, 1:]
    meshed = Trainer(TransformerLM(cfg, device=device),
                     TrainConfig(**tc, zero1=True), device=device, mesh=mesh)
    meshed.init(seed + 3)
    grads = _recording_grads(meshed)
    drops = _counting_drops(torch, meshed.model) if cfg.moe else None
    loss = meshed.step(x, y)
    grads = tree_leaves(gather_params(
        tree_like(meshed.params, grads[0]), meshed.model.logical_axes(),
        mesh, virtual_stages=meshed.model.virtual_stages))
    leaves = tree_leaves(meshed.gathered_params())
    out = {"loss": loss,
           "checksum": float(sum(p.double().sum() for p in leaves))}
    if axis_size(mesh, "pp") > 1:
        out["replicated_grad_checksum"] = [
            float(g.double().sum()) for g, cuts in zip(grads,
                                                       meshed.leaf_cuts)
            if all(a != "pp" for _, a in cuts)]
    if cfg.moe:
        # The global batch's drops: the blocks' sums over the batch group.
        dropped = torch.tensor([float(sum(int(d) for d, _ in drops))])
        if batch_group(mesh) is not None:
            all_reduce(dropped, batch_group(mesh))
        out["dropped"] = int(dropped.item())
    if dist.get_rank() == 0:
        one = Trainer(TransformerLM(cfg, device=device), TrainConfig(**tc),
                      device=device)
        one.init(seed + 3)
        theta0 = [p.detach().clone() for p in tree_leaves(one.params)]
        ref_grads = _recording_grads(one)
        one_drops = _counting_drops(torch, one.model) if cfg.moe else None
        out["loss_one_rank"] = one.step(x, y)
        out["loss_diff"] = abs(loss - out["loss_one_rank"])
        out["grad_rel_err"] = max(
            float((a - b).norm() / b.norm())
            for a, b in zip(grads, ref_grads[0]))
        out["update_rel_err"], out["update_held_share"] = _update_rel_err(
            theta0, leaves, tree_leaves(one.params), grads, ref_grads[0])
        if cfg.moe:
            out["dropped_one_rank"] = sum(int(d) for d, _ in one_drops)
        del one, ref_grads, theta0
    del meshed, grads, leaves
    _free_if(torch, torch.device(device))
    return out


def _parallel_rank(seed: int, layers: int, seq: int, device) -> dict:
    """What each of phase 10's four gloo ranks runs."""
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.parallel.collectives import (
        per_axis_bandwidth_probe, transport,
    )
    from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    meshes = {"dp2sp2": build_mesh(MeshConfig(dp=2, sp=PAR_SP),
                                   device_type=dev.type),
              "sp4": build_mesh(MeshConfig(dp=1, sp=4),
                                device_type=dev.type)}
    out = {"rank": dist.get_rank(),
           "transport": transport(meshes["dp2sp2"].get_group("sp"), dev)}
    for sp_attention in ("ring", "ulysses"):
        out[sp_attention] = _par_train(torch, seed, layers, seq,
                                       meshes["dp2sp2"], sp_attention, dev)
    out["attention_f32"] = _par_attention_f32(torch, seed, meshes, seq, dev)
    out["step_f32"] = _par_step_f32(torch, seed, meshes["dp2sp2"], seq, dev)
    out["bandwidth"] = per_axis_bandwidth_probe(
        meshes["dp2sp2"], mib=64.0 if dev.type == "cuda" else 1.0, iters=3,
        device=dev)
    return out


def _par_launches(fa, layers: int, calls: int, accum: int = PAR_ACCUM,
                  steps: int = PAR_STEPS, kernels=FLASH_V2_KERNELS) -> dict:
    """A rank's launches over the timed steps: ``calls`` flash calls a
    layer and forward, the forward run twice (full remat), dq and dk/dv
    once a call, on the ``kernels`` (v2 by default)."""
    fwd, dq, dkv = kernels
    per = layers * accum * steps * calls
    return _counts(fa, {fwd: 2 * per, dq: per, dkv: per})


def _hold_mesh_run(phase: str, runs: list, launches, prepasses: int,
                   fallbacks: dict, one_rank_loss: float, tokens: int,
                   card_flops_s) -> dict:
    """Hold every rank's ``_mesh_train`` run and summarize them: exact
    flash launches (``launches``; None off the card) with ``prepasses``
    pre-passes and no plain call (each one for every rank, or a list of
    one a rank in rank order), the ``fallbacks`` counts, losses
    finite, falling and equal on every rank, step 1 within phase 7's
    bf16 limit of one rank's whole-batch step; step ms and tokens/s the
    slowest rank's, the MFU over the card (``card_flops_s``: the step's
    model FLOPs over the card's peak), the transfers' seconds the most of
    any rank's."""
    for i, r in enumerate(runs):
        want = launches[i] if isinstance(launches, list) else launches
        pre = prepasses[i] if isinstance(prepasses, list) else prepasses
        if want is not None and (
                r["launches"] != want or r["plain_calls"] != 0
                or r["prepass_launches"] != pre):
            raise RuntimeError(
                f"{phase}: rank {i} launched {r['launches']}, "
                f"{r['prepass_launches']} pre-passes and "
                f"{r['plain_calls']} plain calls; expected {want}, "
                f"{pre}, 0")
        got = {k: r[k] for k in fallbacks}
        if got != fallbacks:
            raise RuntimeError(f"{phase}: flash_fallback_total {got}, "
                               f"expected {fallbacks}")
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"{phase}: losses {losses}")
        if not all(b < a for a, b in zip(losses[1:], losses[2:])) \
                or not losses[-1] < losses[0]:
            raise RuntimeError(f"{phase}: loss did not fall: {losses}")
    if len({tuple(r["losses"]) for r in runs}) != 1:
        raise RuntimeError(f"{phase}: ranks disagree on the loss: "
                           f"{[r['losses'] for r in runs]}")
    diff = abs(runs[0]["losses"][0] - one_rank_loss)
    if not diff <= TRAIN_TOL["bfloat16"]["loss"]:
        raise RuntimeError(f"{phase}: step 1 loss {runs[0]['losses'][0]} "
                           f"vs one rank {one_rank_loss}")
    step_s = max(r["step_s"] for r in runs)
    peak_gb = [r["peak_memory_gb"] for r in runs]
    return {
        "losses": runs[0]["losses"], "step1_loss_diff": diff,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu_over_card": card_flops_s / step_s if card_flops_s else None,
        "warmup_step_s": max(r["warmup_step_s"] for r in runs),
        "peak_memory_gb_per_rank": (max(peak_gb) if None not in peak_gb
                                    else None),
        "launches": {k: sum(r["launches"][k] for r in runs)
                     for k in runs[0]["launches"]},
        "launches_per_rank_step": {
            k: v // (len(runs[0]["losses"]) - 1)
            for k, v in runs[0]["launches"].items()},
        "plain_calls": sum(r["plain_calls"] for r in runs),
        **{f"{k}_per_rank": runs[0][k] for k in fallbacks},
        # The extra step with each transfer timed between two
        # synchronizations: its wall and the seconds in each kind of
        # transfer (the most of any rank).
        "timed_transfer_step_s": max(r["timed_transfer_step_s"]
                                     for r in runs),
        "transfer_s": {k: max(r["transfer_s"].get(k, 0.0) for r in runs)
                       for k in sorted({k for r in runs
                                        for k in r["transfer_s"]})},
    }


def run_parallel_path(torch, seed: int, layers: int, seq: int = PAR_SEQ,
                      device="cuda") -> dict:
    """Phase 10: the parallel plane, four gloo ranks on the one card
    (``device="cpu"`` with a short ``seq`` rehearses it on the CPU: the
    plain versions, no NCCL probe, no launch counts)."""
    import functools

    import chip_smoke
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster
    from k8s_gpu_tpu_torch.train.runner import (
        device_peak_flops, model_flops_per_step,
    )

    cuda = torch.device(device).type == "cuda"
    probes = run_parallel_probes(torch) if cuda else {}
    ref = one_rank_reference_loss(torch, seed, layers, seq, device)
    t0 = time.perf_counter()
    ranks = spawn_local_cluster(
        functools.partial(chip_smoke._parallel_rank, seed, layers, seq,
                          device),
        PAR_WORLD, timeout=PAR_TIMEOUT, device=device, backend="gloo")
    cluster_s = time.perf_counter() - t0
    cfg = parallel_config(torch, layers, seq=seq)
    n_params = ranks[0]["ring"]["n_params"]
    out = {"layers": layers, "world": PAR_WORLD, "mesh": {"dp": 2,
           "sp": PAR_SP}, "global_batch": PAR_BATCH, "seq": seq,
           "grad_accum_steps": PAR_ACCUM, "zero1": True, "n_params": n_params,
           "transport": ranks[0]["transport"], "cluster_s": cluster_s,
           "one_rank_step1_loss": ref["loss"],
           "one_rank_step_ms": ref["step_ms"], **probes}
    # The four ranks share the one card.
    peak = device_peak_flops() if cuda else 0.0
    flops = model_flops_per_step(cfg, n_params, PAR_BATCH)
    for name, calls in (("ring", 1 + 2 * (PAR_SP - 1)), ("ulysses", 1)):
        out[name] = _hold_mesh_run(
            f"phase 10 {name}", [r[name] for r in ranks],
            _par_launches(fa, layers, calls) if cuda else None, 0,
            {"sp_fused_rope": layers * PAR_ACCUM * PAR_STEPS,
             "ulysses_kv_heads": 0}, ref["loss"], PAR_BATCH * seq,
            flops / peak if peak else None)
    out["attention_f32"] = {k: max(r["attention_f32"][k][f] for r in ranks
                                   for f in ranks[0]["attention_f32"][k])
                            for k in ranks[0]["attention_f32"]}
    out["step_f32"] = _hold_step_f32("phase 10d",
                                     [r["step_f32"] for r in ranks])
    out["bandwidth"] = ranks[0]["bandwidth"]
    return out


def _hold_step_f32(phase: str, step: list) -> dict:
    """Hold every rank's ``_meshed_step_f32``: the ranks' gathered
    parameters agree, and rank 0's loss, gradients and update are within
    PAR_F32_TOL of one rank's over at least PAR_UPDATE_SHARE of the
    elements; returns rank 0's."""
    if len({s["checksum"] for s in step}) != 1:
        raise RuntimeError(f"{phase}: ranks' parameters differ: {step}")
    if not (max(step[0][k] for k in ("loss_diff", "grad_rel_err",
                                     "update_rel_err")) <= PAR_F32_TOL
            and step[0]["update_held_share"] >= PAR_UPDATE_SHARE):
        raise RuntimeError(f"{phase}: meshed float32 step against one "
                           f"rank's: {step[0]}")
    return step[0]


# -- phase 11: the tensor and expert axes -------------------------------------

# Four gloo ranks on the one card again, each holding its shards.
# 11a: the v2 training configuration over dp 2 x tp 2 at max_seq 2048,
# global batch 4 x 2048, 2 microbatches, ZeRO-1 (the dry run's "dense
# dp/sp/tp zero1+accum+gqa", `__graft_entry__.py:104`, without sp).
# 11b: sp 2 x tp 2 at max_seq 4096, global batch 2 x 4096, 2
# microbatches, ring then Ulysses ("ulysses dp/sp/tp", `:115`).  11c:
# phase 8's MoE over ep 2 x tp 2 at max_seq 2048, global batch 4 x 2048
# ("moe dp/ep/tp", `:109`).  11d: float32 at 2 layers against one rank.
# 11e: one step on the multislice mesh, dp 2 over 2 slices x tp 2
# ("multislice dcn-dp x ici-tp", `:160`).
TP_SEQ = 2048
TP_BATCH = 4
TP_STEPS = 3          # 11a, 11c: timed steps after the warm-up step
TP_SP_BATCH = 2
TP_SP_STEPS = 2       # 11b, each attention
TP_SLICES = 2
# 11d's MoE at a capacity that binds (tokens are dropped), over 8 rows in
# 2 microbatches: each dp rank's microbatch holds 2 rows, so a slot
# counts the other dp block's tokens and its own earlier row's.
TP_F32_MOE = dict(num_experts=4, capacity_factor=1.0)
TP_F32_MOE_BATCH = 8
# 11c: the share of token-layers dropped against one rank's.  ep x tp
# replicates the batch, so the routing is one rank's but for the bf16
# rounding of the tp partial sums (2^-8 relative), which can flip the
# argmax of a token whose top two router probabilities are that close
# (and then the slots after it): held within half a percent.
TP_DROP_SHARE_TOL = 5e-3
TP_TIMEOUT = 700.0
TP_MESHES = {"dp2tp2": dict(dp=2, tp=2), "sp2tp2": dict(dp=1, sp=2, tp=2),
             "ep2tp2": dict(dp=1, ep=2, tp=2), "dp2ep2": dict(dp=2, ep=2)}
TP_PARTS = ("dense", "sp", "moe", "f32", "multislice")


def tp_moe_config(torch, layers: int, dtype=None, seq: int = TP_SEQ,
                  **moe):
    """Phase 8's MoE training configuration (v1 flash, 8 heads) at
    ``seq``; ``moe`` overrides its experts or capacity."""
    import dataclasses

    return dataclasses.replace(flagship_train_config(torch, layers, dtype),
                               max_seq=seq, **{**MOE, **moe})


def _tp_step_f32_cases(torch, seq: int, sp_seq: int) -> dict:
    """11d: {name: (mesh, config, rows, microbatches)}, float32 at 2
    layers.  The sp case keeps rope outside the kernels on both sides (as
    10d does); the dense one fuses it on both."""
    import dataclasses

    f32 = torch.float32
    return {
        "dense_dp2tp2": ("dp2tp2", parallel_config(torch, 2, f32, seq=seq),
                         TP_BATCH, PAR_ACCUM),
        "ring_sp2tp2": ("sp2tp2", dataclasses.replace(
            parallel_config(torch, 2, f32, seq=sp_seq),
            flash_fuse_rope=False), TP_SP_BATCH, PAR_ACCUM),
        "moe_dp2ep2": ("dp2ep2", tp_moe_config(torch, 2, f32, seq,
                                               **TP_F32_MOE),
                       TP_F32_MOE_BATCH, PAR_ACCUM),
    }


def _tensor_parallel_rank(seed: int, layers: int, seq: int, sp_seq: int,
                          device, parts=TP_PARTS) -> dict:
    """What each of phase 11's four gloo ranks runs (``parts``: which of
    TP_PARTS)."""
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.parallel.mesh import (
        MeshConfig, build_mesh, multislice_mesh,
    )
    from k8s_gpu_tpu_torch.parallel.multihost import workload_train_step

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**sizes), device_type=dev.type)
              for name, sizes in TP_MESHES.items()}
    out = {"rank": dist.get_rank()}
    if "dense" in parts:
        cfg = parallel_config(torch, layers, seq=seq)
        out["dense"] = _mesh_train(
            torch, seed, cfg, meshes["dp2tp2"], _par_tokens(torch, seed, cfg),
            dev, accum=PAR_ACCUM, steps=TP_STEPS)
    if "sp" in parts:
        for sp_attention in ("ring", "ulysses"):
            cfg = parallel_config(torch, layers, sp_attention=sp_attention,
                                  seq=sp_seq)
            out[sp_attention] = _mesh_train(
                torch, seed, cfg, meshes["sp2tp2"],
                _par_tokens(torch, seed, cfg, TP_SP_BATCH), dev,
                accum=PAR_ACCUM, steps=TP_SP_STEPS)
    if "moe" in parts:
        cfg = tp_moe_config(torch, layers, seq=seq)
        out["moe"] = _mesh_train(
            torch, seed, cfg, meshes["ep2tp2"],
            _par_tokens(torch, seed, cfg, TP_BATCH), dev, accum=1,
            steps=TP_STEPS)
    if "f32" in parts:
        out["f32"] = {
            name: _meshed_step_f32(torch, seed, cfg, meshes[mesh],
                                   _par_tokens(torch, seed + 1, cfg, rows),
                                   accum, dev)
            for name, (mesh, cfg, rows, accum) in _tp_step_f32_cases(
                torch, seq, sp_seq).items()}
    if "multislice" in parts:
        mesh = multislice_mesh(MeshConfig(dp=2, tp=2), TP_SLICES,
                               device_type=dev.type)
        out["multislice"] = workload_train_step(device=dev, mesh=mesh)
    return out


def run_tensor_parallel_path(torch, seed: int, layers: int,
                             seq: int = TP_SEQ, sp_seq: int = PAR_SEQ,
                             device="cuda", parts=TP_PARTS) -> dict:
    """Phase 11: the tensor and expert axes, four gloo ranks on the one
    card (``device="cpu"`` with short sequences rehearses it on the CPU:
    the plain versions, no launch counts).  Each run is held against one
    rank's step over the whole batch, which this process computes first
    (``one_rank_reference_loss``)."""
    import functools

    import chip_smoke
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster
    from k8s_gpu_tpu_torch.train.runner import (
        device_peak_flops, model_flops_per_step,
    )

    cuda = torch.device(device).type == "cuda"
    peak = device_peak_flops() if cuda else 0.0
    dense = parallel_config(torch, layers, seq=seq)
    sp = parallel_config(torch, layers, seq=sp_seq)
    moe = tp_moe_config(torch, layers, seq=seq)
    refs = {}
    if "dense" in parts:
        refs["dense"] = one_rank_reference_loss(torch, seed, layers, seq,
                                                device, cfg=dense)
    if "sp" in parts:
        refs["sp"] = one_rank_reference_loss(torch, seed, layers, sp_seq,
                                             device, cfg=sp,
                                             batch=TP_SP_BATCH)
    if "moe" in parts:
        refs["moe"] = one_rank_reference_loss(
            torch, seed, layers, seq, device, cfg=moe, batch=TP_BATCH,
            accum=1)
    t0 = time.perf_counter()
    ranks = spawn_local_cluster(
        functools.partial(chip_smoke._tensor_parallel_rank, seed, layers,
                          seq, sp_seq, device, parts),
        PAR_WORLD, timeout=TP_TIMEOUT, device=device, backend="gloo")
    out = {"layers": layers, "world": PAR_WORLD, "meshes": TP_MESHES,
           "cluster_s": time.perf_counter() - t0,
           "one_rank": refs}

    def hold(name, key, cfg, batch, rows_seq, launches, prepasses,
             fallbacks, ref):
        runs = [r[key] for r in ranks]
        flops = model_flops_per_step(cfg, runs[0]["n_params"], batch)
        return {"n_params": runs[0]["n_params"], **_hold_mesh_run(
            f"phase {name}", runs, launches if cuda else None, prepasses,
            fallbacks, ref["loss"], batch * rows_seq,
            flops / peak if peak else None)}

    if "dense" in parts:
        # v2 with rope in the kernels: a pre-pass a forward and one a
        # backward (the dq and dk/dv kernels share it).
        per = layers * PAR_ACCUM * TP_STEPS
        out["dense"] = hold(
            "11a", "dense", dense, PAR_BATCH, seq,
            _par_launches(fa, layers, 1, PAR_ACCUM, TP_STEPS), 3 * per,
            {"sp_fused_rope": 0, "ulysses_kv_heads": 0}, refs["dense"])
    if "sp" in parts:
        per = layers * PAR_ACCUM * TP_SP_STEPS
        # The ring keeps K/V grouped (v2, 3 calls a layer at sp 2);
        # Ulysses broadcasts them (KV heads / tp = 1 does not divide by
        # sp) and its one call a layer takes matched heads: v1.
        for name, launches, kv in (
                ("ring", _par_launches(fa, layers, 3, PAR_ACCUM,
                                       TP_SP_STEPS), 0),
                ("ulysses", _par_launches(fa, layers, 1, PAR_ACCUM,
                                          TP_SP_STEPS, FLASH_KERNELS),
                 per)):
            out[name] = hold(
                f"11b {name}", name, sp, TP_SP_BATCH, sp_seq, launches, 0,
                {"sp_fused_rope": per, "ulysses_kv_heads": kv}, refs["sp"])
    if "moe" in parts:
        out["moe"] = hold(
            "11c", "moe", moe, TP_BATCH, seq,
            _par_launches(fa, layers, 1, 1, TP_STEPS, FLASH_KERNELS), 0,
            {"sp_fused_rope": 0, "ulysses_kv_heads": 0}, refs["moe"])
        shares = {r["moe"]["dropped_share"] for r in ranks}
        share = ranks[0]["moe"]["dropped_share"]
        gap = abs(share - refs["moe"]["dropped_share"])
        out["moe"].update(dropped_share=share, dropped_share_gap=gap)
        if len(shares) != 1 or not gap <= TP_DROP_SHARE_TOL:
            raise RuntimeError(
                f"phase 11c: dropped shares {sorted(shares)} against one "
                f"rank's {refs['moe']['dropped_share']}")
    if "f32" in parts:
        out["f32"] = {}
        for name in ranks[0]["f32"]:
            step = _hold_step_f32(f"phase 11d {name}",
                                  [r["f32"][name] for r in ranks])
            if "dropped" in step and not (
                    step["dropped"] > 0
                    and step["dropped"] == step["dropped_one_rank"]):
                raise RuntimeError(
                    f"phase 11d {name}: dropped {step['dropped']} (rank "
                    f"0's block), one rank {step['dropped_one_rank']}")
            out["f32"][name] = step
    if "multislice" in parts:
        losses = {r["multislice"]["loss"] for r in ranks}
        if len(losses) != 1 or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"phase 11e: multislice losses {losses}")
        out["multislice"] = ranks[0]["multislice"]
    return out


# -- phase 12: the pipeline axis ---------------------------------------------

# Four gloo ranks on the one card again, each holding its stage's blocks.
# 12a: GPipe over dp 2 x pp 2, v1 (8 heads), global batch 4 x 2048, M = pp
# = 2 a dp group (the dry run's "pipeline gpipe dp/pp",
# `__graft_entry__.py:127`).  12b: 1F1B over pp 2 x tp 2, the v2 GQA
# configuration, 4 x 2048, M 4 ("pipeline 1f1b dp/pp/tp", `:135`, on four
# ranks).  12c: interleaved 1F1B over pp 4 with 2 virtual stages, v1, 8 x
# 2048, M 8 ("pipeline 1f1b-interleaved dp/pp v=2", `:146`), and classic
# 1F1B at pp 4 beside it on the same batch.  12a's mesh again at M 8 under
# each schedule, 16 x 2048: the peak memory a rank.  12d: float32 at 4
# layers (8 for the interleaved case) against one rank's step.
PP_STEPS = 2           # timed steps after the warm-up step
PP_TIMEOUT = 700.0
PP_MESHES = {"dp2pp2": dict(dp=2, pp=2), "pp2tp2": dict(dp=1, pp=2, tp=2),
             "pp4": dict(dp=1, pp=4)}
# name: (mesh, v2 configuration, schedule, microbatches, virtual stages,
# global batch)
PP_RUNS = {
    "gpipe_dp2pp2": ("dp2pp2", False, "gpipe", 2, 1, 4),
    "1f1b_pp2tp2": ("pp2tp2", True, "1f1b", 4, 1, 4),
    "interleaved_pp4v2": ("pp4", False, "1f1b", 8, 2, 8),
    "1f1b_pp4": ("pp4", False, "1f1b", 8, 1, 8),
}
PP_MEMORY = {"gpipe": ("dp2pp2", False, "gpipe", 8, 1, 16),
             "1f1b": ("dp2pp2", False, "1f1b", 8, 1, 16)}
PP_F32_LAYERS = 4
PP_F32_RUNS = ("gpipe_dp2pp2", "1f1b_pp2tp2", "interleaved_pp4v2")
PP_PARTS = (*PP_RUNS, "memory", "f32")


def pp_config(torch, layers: int, run, dtype=None, seq: int = TP_SEQ):
    """The flagship training configuration of a PP_RUNS entry at
    ``seq``."""
    import dataclasses

    _, v2, schedule, microbatches, virtual, _ = run
    return dataclasses.replace(
        flagship_train_config(torch, layers, dtype, v2=v2), max_seq=seq,
        pp_schedule=schedule, pp_microbatches=microbatches,
        pp_virtual_stages=virtual)


def pp_launches(fa, cfg, pp: int, stage: int, steps: int) -> tuple:
    """(flash launches, rope pre-passes) of pp rank ``stage`` over
    ``steps`` steps.  GPipe: each layer's forward twice (full remat), dq
    and dk/dv once, a microbatch.  1F1B: the forward tick and the
    backward tick's recompute, one forward on the last virtual stage,
    whose forward is fused into its backward; dq and dk/dv once.  v2
    with rope in the kernels adds one pre-pass a forward and one a
    backward."""
    v = cfg.pp_virtual_stages if cfg.pp_schedule == "1f1b" else 1
    M, S = cfg.pp_microbatches, pp * v
    lc = cfg.n_layers // S
    if cfg.pp_schedule == "gpipe":
        fwd = 2 * lc * v * M
    else:
        fwd = sum(lc * M * (1 if c * pp + stage == S - 1 else 2)
                  for c in range(v))
    bwd = lc * v * M
    v2 = cfg.flash_fuse_rope or cfg.flash_kv_grouped or \
        cfg.flash_q_pipeline > 1
    names = FLASH_V2_KERNELS if v2 else FLASH_KERNELS
    counts = dict(zip(names, (fwd * steps, bwd * steps, bwd * steps)))
    prepasses = (fwd + bwd) * steps if cfg.flash_fuse_rope else 0
    return _counts(fa, counts), prepasses


def _pp_memory(torch, seed: int, layers: int, seq: int, mesh, run,
               device) -> dict:
    """One step of ``run`` (the warm-up's learning rate 0) from a fresh
    peak: this rank's resident and peak GB, the step's seconds and the
    most stage inputs the schedule held."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.parallel import pipeline
    from k8s_gpu_tpu_torch.parallel.mesh import axis_rank
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    cfg = pp_config(torch, layers, run, seq=seq)
    trainer = Trainer(TransformerLM(cfg, device=device),
                      TrainConfig(warmup_steps=1), device=device, mesh=mesh)
    trainer.init(seed)
    toks = _par_tokens(torch, seed, cfg, run[5])
    cuda = trainer.device.type == "cuda"
    resident = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    loss = trainer.step(toks[:, :-1], toks[:, 1:])
    out = {"loss": loss, "step_s": time.perf_counter() - t0,
           "resident_gb": resident,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
           else None,
           "live_inputs": pipeline.schedule_stats["live_inputs"],
           "stage": axis_rank(mesh, "pp")}
    del trainer
    _free_if(torch, torch.device(device))
    return out


def _pipeline_rank(seed: int, layers: int, seq: int, device,
                   parts=PP_PARTS) -> dict:
    """What each of phase 12's four gloo ranks runs (``parts``: which of
    PP_PARTS)."""
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.parallel import pipeline
    from k8s_gpu_tpu_torch.parallel.mesh import (
        MeshConfig, axis_rank, build_mesh,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**sizes), device_type=dev.type)
              for name, sizes in PP_MESHES.items()}
    out = {"rank": dist.get_rank()}
    for name, run in PP_RUNS.items():
        if name not in parts:
            continue
        mesh, cfg = meshes[run[0]], pp_config(torch, layers, run, seq=seq)
        res = _mesh_train(torch, seed, cfg, mesh,
                          _par_tokens(torch, seed, cfg, run[5]), dev,
                          accum=1, steps=PP_STEPS, zero1=False)
        res.update(stage=axis_rank(mesh, "pp"),
                   ticks=pipeline.schedule_stats["ticks"],
                   live_inputs=pipeline.schedule_stats["live_inputs"])
        out[name] = res
    if "memory" in parts:
        out["memory"] = {name: _pp_memory(torch, seed, layers, seq,
                                          meshes[run[0]], run, dev)
                         for name, run in PP_MEMORY.items()}
    if "f32" in parts:
        out["f32"] = {}
        for name in PP_F32_RUNS:
            run = PP_RUNS[name]
            cfg = pp_config(torch, PP_F32_LAYERS * run[4], run,
                            torch.float32, seq)
            out["f32"][name] = _meshed_step_f32(
                torch, seed, cfg, meshes[run[0]],
                _par_tokens(torch, seed + 1, cfg, run[5]), 1, dev)
    return out


def run_pipeline_path(torch, seed: int, layers: int, seq: int = TP_SEQ,
                      device="cuda", parts=PP_PARTS) -> dict:
    """Phase 12: the pipeline axis, four gloo ranks on the one card
    (``device="cpu"`` with a short ``seq`` rehearses it on the CPU: the
    plain versions, no launch counts).  Each run is held against one rank's step over the
    whole batch, which this process computes first
    (``one_rank_reference_loss``); the runs' launches against
    ``pp_launches``, rank by rank."""
    import functools

    import chip_smoke
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster
    from k8s_gpu_tpu_torch.parallel.pipeline import (
        classic_ticks_fine, interleaved_ticks,
    )
    from k8s_gpu_tpu_torch.train.runner import (
        device_peak_flops, model_flops_per_step,
    )

    cuda = torch.device(device).type == "cuda"
    peak = device_peak_flops() if cuda else 0.0
    refs = {}
    for name, run in PP_RUNS.items():
        key = ("v2" if run[1] else "v1", run[5])
        if name in parts and key not in refs:
            refs[key] = one_rank_reference_loss(
                torch, seed, layers, seq, device,
                cfg=pp_config(torch, layers, run, seq=seq), batch=run[5],
                accum=1)
    t0 = time.perf_counter()
    ranks = spawn_local_cluster(
        functools.partial(chip_smoke._pipeline_rank, seed, layers, seq,
                          device, parts),
        PAR_WORLD, timeout=PP_TIMEOUT, device=device, backend="gloo")
    out = {"layers": layers, "world": PAR_WORLD, "meshes": PP_MESHES,
           "cluster_s": time.perf_counter() - t0,
           "one_rank": {f"{v}_batch{b}": r for (v, b), r in refs.items()}}
    for name, run in PP_RUNS.items():
        if name not in parts:
            continue
        cfg = pp_config(torch, layers, run, seq=seq)
        runs = [r[name] for r in ranks]
        pp = PP_MESHES[run[0]]["pp"]
        want = [pp_launches(fa, cfg, pp, r["stage"], PP_STEPS)
                for r in runs]
        flops = model_flops_per_step(cfg, runs[0]["n_params"], run[5])
        held = _hold_mesh_run(
            f"phase 12 {name}", runs, [w[0] for w in want] if cuda else None,
            [w[1] for w in want], {"sp_fused_rope": 0, "ulysses_kv_heads": 0},
            refs[("v2" if run[1] else "v1", run[5])]["loss"],
            run[5] * cfg.max_seq, flops / peak if peak else None)
        held.update(
            n_params=runs[0]["n_params"], microbatches=run[3],
            virtual_stages=run[4], ticks=runs[0]["ticks"],
            stage_by_rank=[r["stage"] for r in runs],
            live_inputs_by_rank=[r["live_inputs"] for r in runs],
            peak_memory_gb_by_rank=[r["peak_memory_gb"] for r in runs],
            launches_per_step_by_rank=[
                {k: v // PP_STEPS for k, v in r["launches"].items() if v}
                for r in runs])
        out[name] = held
    if "interleaved_pp4v2" in parts or "1f1b_pp4" in parts:
        out["ticks"] = {"interleaved_ticks(8,4,2)": interleaved_ticks(8, 4, 2),
                        "classic_ticks_fine(8,4)*2":
                            classic_ticks_fine(8, 4) * 2}
        print(json.dumps({"pipeline_ticks": out["ticks"]}), flush=True)
    if "memory" in parts:
        out["memory"] = {}
        for name in PP_MEMORY:
            mem = [r["memory"][name] for r in ranks]
            losses = {m["loss"] for m in mem}
            if len(losses) != 1 or not all(map(math.isfinite, losses)):
                raise RuntimeError(f"phase 12 memory {name}: losses "
                                   f"{sorted(losses)}")
            out["memory"][name] = {
                "loss": mem[0]["loss"],
                "step_s": max(m["step_s"] for m in mem),
                **{f"{k}_by_rank": [m[k] for m in mem]
                   for k in ("stage", "resident_gb", "peak_gb",
                             "live_inputs")}}
    if "f32" in parts:
        out["f32"] = {}
        for name in ranks[0]["f32"]:
            steps = [r["f32"][name] for r in ranks]
            out["f32"][name] = _hold_step_f32(f"phase 12d {name}", steps)
            sums = {tuple(st["replicated_grad_checksum"]) for st in steps}
            if len(sums) != 1:
                raise RuntimeError(
                    f"phase 12d {name}: the gradients of the leaves pp "
                    f"leaves whole differ between ranks: {sorted(sums)}")
    return out


# -- phase 13: serving on a mesh ----------------------------------------------

SRV_WORLD = 4
SRV_MESHES = {"tp4": dict(dp=1, tp=4), "dp2tp2": dict(dp=2, tp=2)}
SRV_SLOTS = 8          # 13b: 4 a dp group
SRV_MIX = 2            # phase 4's mix jobs a burst takes after the pair
# Tokens each request generates: a decode step over four ranks sharing
# the card takes 0.25-0.6 s (each transfer syncs its rank's stream),
# 40x phase 4's one-rank step, so the budgets are phase 4's cut short.
SRV_NEW = 16
SRV_REPEAT_NEW = 8     # the repeated greedy request of 13a and 13b
SRV_LORA_JOBS = (None, None, "r4", "r16")
SRV_F32_LAYERS = 2
# Within the whole script phase 13's bf16 parts (13a-13d and 13f-13j,
# one model) run half the flagship's depth: with them at 16 layers the
# script took 1030.5 s of its 1200 s limit on an H100 (PERF.md).
SRV_LAYERS = 8
SRV_LORA_TRAIN_BATCH = 4
SRV_LORA_TRAIN_STEPS = 3
SRV_LORA_TOL = 1e-4    # phase 11d's float32 limit
SRV_TIMED_STEPS = 8    # the extra round whose transfers are timed
SRV_TIMED_T_HI = 1024
SRV_TIMEOUT = 600.0
SRV_PARTS = ("tp4_paged", "dp2tp2_dense", "tp4_ngram", "tp4_bankless",
             "tp4_bank")
# 13f-13j: the drafts, MoE, int8 weights, migration and the prefill
# pool on a mesh, their requests SRV_NEW_B tokens each (phase 4's pair
# and the mix's first two, as 13a's).
SRV_B_PARTS = ("tp4_neural", "tp4_neural_int8", "tp4_moe_paged",
               "dp2tp2_moe_dense", "tp4_int8", "tp4_migrate", "tp4_disagg")
SRV_NEW_B = 8
SRV_F32_PARTS = (*SRV_PARTS, "tp4_kv_quant", *SRV_B_PARTS)
SRV_PREFILL_TAIL = 100  # 13j's /prefill prompt: the pair's prefix + this


def serving_jobs(torch, seed: int, vocab: int):
    """Phase 4's pair over one 512-token prefix and the first SRV_MIX
    requests of its mix (the same ids, from ``seed``), SRV_NEW tokens
    each."""
    rng = torch.Generator().manual_seed(seed)
    prefix = torch.randint(0, vocab, (512,), generator=rng).tolist()
    pair, mix = _serving_jobs(torch, rng, vocab, prefix)
    return [(p, SRV_NEW, None) for p, _ in pair + mix[:SRV_MIX]]


def serving_lora_jobs(torch, seed: int, vocab: int, new: int = SRV_NEW):
    """13d: two base rows and one for each adapter over one 128-token
    prefix (two pages: an adapter row prefills it whole)."""
    rng = torch.Generator().manual_seed(seed + 30)
    prefix = torch.randint(0, vocab, (128,), generator=rng).tolist()
    return [(prefix + torch.randint(0, vocab, (16 + 4 * i,),
                                    generator=rng).tolist(), new, name)
            for i, name in enumerate(SRV_LORA_JOBS)]


def serving_adapters(torch, params, seed: int) -> dict:
    cfgs = _lora_configs()
    return {name: (_seeded_adapter(torch, params, cfgs[name],
                                   seed + 21 + i), cfgs[name])
            for i, name in enumerate(("r4", "r16"))}


def _serving_knobs(part: str, n_blocks: int) -> dict:
    paged = dict(paged_blocks=n_blocks, page_size=PAGE,
                 attn_impl="paged_kernel")
    # Unshared: every admission is cold, so the draft row is prefilled
    # (any other path zeroes it, as the reference's executor does).
    spec = dict(paged, spec_k=SPEC_K, prefix_cache=False)
    return {"tp4_paged": paged, "dp2tp2_dense": {},
            "tp4_ngram": dict(paged, draft="ngram", spec_k=SPEC_K),
            "tp4_kv_quant": dict(paged, kv_quant=True),
            "tp4_bankless": paged, "tp4_bank": paged,
            "tp4_neural": spec, "tp4_neural_int8": spec,
            "tp4_moe_paged": paged, "dp2tp2_moe_dense": {},
            "tp4_int8": paged, "tp4_migrate": paged,
            "tp4_disagg": paged}[part]


def _bodies(jobs, bank: bool) -> list:
    return [{"prompt_ids": p, "max_new_tokens": n,
             **({"adapter": a} if bank and a else {})} for p, n, a in jobs]


def _timed_round(torch, b, mesh, dev) -> dict:
    """Every rank in lockstep after the server stopped: one more round of
    SRV_TIMED_STEPS decode steps over all slots (tables over the pool's
    blocks, read bound SRV_TIMED_T_HI) with every transfer timed
    (``_timing_transfers``: the card synchronized around each)."""
    import torch.distributed as dist

    mp = SRV_TIMED_T_HI // PAGE
    nb = b._dev["cache"]["k"].shape[1]
    pages = (torch.arange(b.slots * mp, dtype=torch.int32) % (nb - 1)
             + 1).reshape(b.slots, mp).to(dev)
    dist.barrier()
    spent, undo = _timing_transfers(torch, dev, mesh)
    sync = _syncer(torch, dev)
    try:
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            b._round_dev(False, SRV_TIMED_STEPS, SRV_TIMED_T_HI, pages)
        sync()
        wall = time.perf_counter() - t0
    finally:
        undo()
    return {"steps": SRV_TIMED_STEPS, "round_s": wall, "transfer_s": spent}


def _mesh_serve(torch, mesh, model, shards, tok, jobs, part: str,
                n_blocks: int, adapters=None, repeat: bool = True,
                timed: bool = False, routes: bool = False) -> dict:
    """One part of phase 13 on this rank: a meshed ``LmServer`` on its
    ``shards``; rank 0 streams ``jobs`` over HTTP together (whichever of
    a pair is planned first registers the prefix blocks the other
    shares), then with ``repeat`` the last of them twice more alone,
    SRV_REPEAT_NEW tokens (greedy: the same stream).  Every rank: its
    paged launches and fall-backs over the server's life and its peak
    memory; rank 0 also the streams, the burst's numbers, the admission
    paths and the device work that goes through the kernel.  With
    ``routes`` (MoE) every rank then replays the leader's streams
    (``_mesh_moe_routes``)."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import LmServer
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

    dev = model.device
    knobs = _serving_knobs(part, n_blocks)
    _reset_peak(torch, dev)
    pa.reset_counts()
    srv = LmServer(model, shards, tok, slots=SRV_SLOTS, mesh=mesh,
                   max_new_tokens_cap=256, adapters=adapters, device=dev,
                   metrics=MetricsRegistry(), **knobs).start()
    b = srv.batcher
    out = {}
    if srv.port is None:
        srv.wait()
    else:
        if knobs.get("draft") == "ngram":
            # Always speculate: the gate reads the leader's clock.
            b.ngram_breakeven = 0.0
            b._ngram_next_meas = {"plain": float("inf"),
                                  "spec": float("inf")}
        try:
            bodies = _bodies(jobs, adapters is not None)
            before = _collective_s(b.metrics)
            t0 = time.perf_counter()
            outs = _stream_bodies(srv.port, bodies)
            wall = time.perf_counter() - t0
            # The burst's transfers alone: not the repeats' after it.
            burst_collective_s = {
                k: v - before.get(k, 0.0)
                for k, v in _collective_s(b.metrics).items()}
            _check_budgets(outs, [n for _, n, _ in jobs])
            burst_paths = dict(b.admission_paths)
            again = []
            short = dict(bodies[-1], max_new_tokens=SRV_REPEAT_NEW)
            for _ in range(2 if repeat else 0):
                code, body = _post(srv.port, "/generate", short)
                if code != 200:
                    raise RuntimeError(f"{part}: repeated request {code}")
                again.append(body["ids"])
            if again and again[0] != again[1]:
                raise RuntimeError(f"{part}: a repeated greedy request "
                                   "changed its stream")
            out.update(_burst_numbers(outs, wall))
            out.update(streams=[o["ids"] for o in outs],
                       admissions=burst_paths,
                       all_admissions=dict(b.admission_paths),
                       work=_paged_work(b), rounds=b._round_count,
                       spec=_spec_summary(b) if b.spec_mode else None,
                       collective_s=burst_collective_s)
        finally:
            srv.stop()
    out.update(_rank_tail(torch, pa, dev))
    if timed:
        out["timed_round"] = _timed_round(torch, b, mesh, dev)
    if routes:
        out["routes"] = _mesh_moe_routes(torch, b.engine, shards, jobs,
                                         out.get("streams"))
    del srv, b
    _free_if(torch, dev)
    return out


def _mesh_moe_routes(torch, engine, shards, jobs, streams) -> list:
    """Every rank: the leader's MoE ``streams`` (sent over the world)
    replayed through this rank's meshed engine as the batcher computed
    them (``_moe_forward`` of each prompt and its stream but the last
    token): each request's routes, what 13h's near-tie witness holds
    against one rank's."""
    from k8s_gpu_tpu_torch.parallel.collectives import broadcast_object

    streams = broadcast_object(streams)
    with torch.inference_mode():
        return [_moe_forward(torch, engine, shards, p, s[:-1])[1]
                for (p, _, _), s in zip(jobs, streams)]


def _mesh_batch(torch, mesh, model, shards, jobs, part: str,
                n_blocks: int, **extra) -> dict:
    """13f-13g on this rank: ``ContinuousBatcher(mesh=)`` itself (the
    entry point that takes ``prefix_cache`` and ``draft_int8``), the
    jobs queued on rank 0 before ``start()``; the numbers
    ``_mesh_serve`` gives, TTFT from the start."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

    dev = model.device
    _reset_peak(torch, dev)
    pa.reset_counts()
    b = ContinuousBatcher(model, shards, slots=SRV_SLOTS, mesh=mesh,
                          device=dev, metrics=MetricsRegistry(),
                          **_serving_knobs(part, n_blocks), **extra)
    out = {}
    if b.is_leader:
        hs = [b.submit(p, max_new_tokens=n) for p, n, _ in jobs]
        outs = [dict() for _ in hs]
        t0 = time.perf_counter()
        b.start()
        threads = [threading.Thread(target=_consume, args=(h, t0, o))
                   for h, o in zip(hs, outs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        try:
            _check_budgets(outs, [n for _, n, _ in jobs])
            out.update(_burst_numbers(outs, wall))
            out.update(streams=[o["ids"] for o in outs],
                       admissions=dict(b.admission_paths),
                       all_admissions=dict(b.admission_paths),
                       work=_paged_work(b), rounds=b._round_count,
                       spec=_spec_summary(b))
        finally:
            b.stop()
    else:
        b.start().wait()
    out.update(_rank_tail(torch, pa, dev))
    del b
    _free_if(torch, dev)
    return out


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _rank_tail(torch, pa, dev, own: int = 0) -> dict:
    """This rank's paged launches (less ``own``: a one-rank replica's in
    the same process) and fall-backs, and its peak memory."""
    return {"launches": pa.launch_count - own,
            "launches_by_width": dict(pa.launches_by_width),
            "fallbacks": pa.fallback_count,
            "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None)}


def _timed(port: int, path: str, body: dict):
    """(code, body, ms) of a POST."""
    t0 = time.perf_counter()
    code, out = _post(port, path, body)
    return code, out, (time.perf_counter() - t0) * 1e3


def _payload_mb(payload: dict) -> float:
    from k8s_gpu_tpu_torch.serve.migrate import payload_bytes

    return len(payload_bytes(payload)) / 1e6


def prefill_prompt(torch, seed: int, jobs, vocab: int) -> list:
    """13j's /prefill prompt: the pair's 512-token prefix and a tail of
    its own."""
    rng = torch.Generator().manual_seed(seed + 60)
    return list(jobs[0][0][:512]) + torch.randint(
        0, vocab, (SRV_PREFILL_TAIL,), generator=rng).tolist()


def _ok(code: int, what: str) -> None:
    if code != 200:
        raise RuntimeError(f"phase 13j: {what} answered {code}")


def _mesh_migrate(torch, mesh, model, shards, params, tok, jobs,
                  n_blocks: int, seed: int) -> dict:
    """13j's first half on this rank: a tp 4 paged ``LmServer`` streams
    the pair, then rank 0 exports its blocks (/admin/export) and imports
    them into a one-rank torch replica on the whole ``params``, whose own
    export must be the same bytes; /prefill of a prompt over the pair's
    prefix, its payload imported into the replica, and the prompt's
    stream from both.  Returns the replica's export (``back``) for the
    second half."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import LmServer
    from k8s_gpu_tpu_torch.serve.migrate import payload_bytes
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

    dev = model.device
    knobs = _serving_knobs("tp4_migrate", n_blocks)
    _reset_peak(torch, dev)
    pa.reset_counts()
    own = 0
    srv = LmServer(model, shards, tok, slots=SRV_SLOTS, mesh=mesh,
                   max_new_tokens_cap=256, device=dev,
                   metrics=MetricsRegistry(), **knobs).start()
    b = srv.batcher
    out = {}
    if srv.port is None:
        srv.wait()
    else:
        try:
            pair = jobs[:2]
            t0 = time.perf_counter()
            outs = _stream_bodies(srv.port, _bodies(pair, False))
            wall = time.perf_counter() - t0
            _check_budgets(outs, [n for _, n, _ in pair])
            code, export, export_ms = _timed(srv.port, "/admin/export", {})
            _ok(code, "/admin/export")
            q = prefill_prompt(torch, seed, jobs, model.cfg.vocab_size)
            code, pre, prefill_ms = _timed(srv.port, "/prefill",
                                           {"prompt_ids": q})
            _ok(code, "/prefill")
            before = pa.launch_count
            one = LmServer(model, params, tok, slots=SRV_SLOTS,
                           max_new_tokens_cap=256, device=dev,
                           metrics=MetricsRegistry(), **knobs).start()
            try:
                code, imp, import_ms = _timed(one.port, "/admin/import",
                                              export)
                _ok(code, "the replica's /admin/import")
                code, back = _post(one.port, "/admin/export", {})
                _ok(code, "the replica's /admin/export")
                if payload_bytes(back) != payload_bytes(export):
                    raise RuntimeError(
                        "phase 13j: the one-rank replica's export of the "
                        "mesh's blocks is not the mesh's payload")
                code, _ = _post(one.port, "/admin/import", pre)
                _ok(code, "the replica's /admin/import of /prefill's")
                code, one_gen = _post(one.port, "/generate", {
                    "prompt_ids": q, "max_new_tokens": SRV_NEW_B})
                _ok(code, "the replica's /generate")
                one_paths = dict(one.batcher.admission_paths)
            finally:
                one.stop()
            own = pa.launch_count - before
            code, mesh_gen = _post(srv.port, "/generate", {
                "prompt_ids": q, "max_new_tokens": SRV_NEW_B})
            _ok(code, "/generate after /prefill")
            if one_paths.get("paged_shared", 0) < 1:
                raise RuntimeError(f"phase 13j: the replica did not share "
                                   f"the moved blocks: {one_paths}")
            out.update(_burst_numbers(outs, wall))
            out.update(
                streams=[o["ids"] for o in outs],
                prefill_streams=(one_gen["ids"], mesh_gen["ids"]),
                prefill_job=(q, SRV_NEW_B),
                admissions=dict(b.admission_paths),
                all_admissions=dict(b.admission_paths),
                work=_paged_work(b), rounds=b._round_count,
                export_ms=export_ms, export_mb=_payload_mb(export),
                export_blocks=len(export["blocks"]),
                prefill_ms=prefill_ms, prefill_mb=_payload_mb(pre),
                replica_import_ms=import_ms,
                replica_imported=imp.get("imported"),
                replica_paths=one_paths, byte_equal=True, back=back)
        finally:
            srv.stop()
    out.update(_rank_tail(torch, pa, dev, own))
    del srv, b
    _free_if(torch, dev)
    return out


def _mesh_disagg(torch, mesh, model, shards, tok, jobs, n_blocks: int,
                 back) -> dict:
    """13j's second half on this rank: a new tp 4 paged ``LmServer`` with
    an in-process prefill pool (``DisaggregatedLm``) on its batcher,
    built on every rank before it starts.  Rank 0 imports the replica's
    export (``back``: the blocks came home), then streams the pair's
    second over /generate (it shares the imported prefix) while the
    mix's two go through the pool (handovers: ``precomputed``)."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import DisaggregatedLm, LmServer
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

    dev = model.device
    _reset_peak(torch, dev)
    pa.reset_counts()
    srv = LmServer(model, shards, tok, slots=SRV_SLOTS, mesh=mesh,
                   max_new_tokens_cap=256, device=dev,
                   metrics=MetricsRegistry(),
                   **_serving_knobs("tp4_disagg", n_blocks))
    pool = DisaggregatedLm(model, shards, batcher=srv.batcher)
    srv.start()
    pool.start()
    b = srv.batcher
    out = {}
    if srv.port is None:
        srv.wait()
    else:
        try:
            code, imp, import_ms = _timed(srv.port, "/admin/import", back)
            _ok(code, "/admin/import into the mesh")
            outs = [dict() for _ in range(3)]
            t0 = time.perf_counter()
            http = threading.Thread(target=_stream, args=(
                srv.port, _bodies(jobs[1:2], False)[0], outs[0]))
            http.start()
            hs = [pool.submit(p, max_new_tokens=n) for p, n, _ in jobs[2:4]]
            handed_s = time.perf_counter() - t0
            threads = [threading.Thread(target=_consume, args=(h, t0, o))
                       for h, o in zip(hs, outs[1:])]
            for th in threads:
                th.start()
            for th in [http, *threads]:
                th.join(timeout=900)
            wall = time.perf_counter() - t0
            _check_budgets(outs, [n for _, n, _ in jobs[1:4]])
            paths = dict(b.admission_paths)
            if paths.get("precomputed") != 2 or paths.get(
                    "paged_shared", 0) < 1:
                raise RuntimeError(
                    f"phase 13j: admissions {paths}: two handovers and the "
                    "pair's second over the imported blocks expected")
            out.update(_burst_numbers(outs, wall))
            out.update(streams=[o["ids"] for o in outs], admissions=paths,
                       all_admissions=paths, work=_paged_work(b),
                       rounds=b._round_count, import_ms=import_ms,
                       imported=imp.get("imported"), handed_over_s=handed_s,
                       pool_max_inflight=pool.max_inflight)
        finally:
            pool.stop()
            srv.stop()
    out.update(_rank_tail(torch, pa, dev))
    del srv, b, pool
    _free_if(torch, dev)
    return out


def _collective_s(registry) -> dict:
    """The host seconds a meshed server's transfers took, by axis and op
    (``collective_seconds``; ``world`` is the descriptors' broadcast)."""
    out = {}
    for axis in ("world", "dp", "tp"):
        for op in ("broadcast", "psum", "all_gather"):
            h = registry.histogram("collective_seconds", axis=axis, op=op)
            if h is not None:
                out[f"{axis} {op}"] = h.total
    return out


SRV_LORA_TARGETS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_mlp")
# A cosine schedule without warm-up moves the adapters at step 1.
SRV_LORA_TC = dict(warmup_steps=0, schedule="cosine", decay_steps=100,
                   learning_rate=1e-2)


def _lora_trainer(torch, model, params, seed: int, mesh=None):
    """13e's fine-tune: rank 8 on every block target from a seeded
    adapter (B drawn too, so A's first gradient is not zero), recording
    the gradients AdamW is handed."""
    from k8s_gpu_tpu_torch.train import (
        LoraConfig, LoraModel, TrainConfig, Trainer,
    )

    lcfg = LoraConfig(rank=8, targets=SRV_LORA_TARGETS)
    tr = Trainer(LoraModel(model, params, lcfg), TrainConfig(**SRV_LORA_TC),
                 device=model.device, mesh=mesh)
    tr.init(params=_seeded_adapter(torch, params, lcfg, seed + 40))
    return tr, _recording_grads(tr)


def _lora_batch(torch, model, seed: int):
    rng = torch.Generator().manual_seed(seed + 41)
    toks = torch.randint(0, model.cfg.vocab_size,
                         (SRV_LORA_TRAIN_BATCH, model.cfg.max_seq + 1),
                         generator=rng).to(model.device)
    return toks[:, :-1], toks[:, 1:]


def _mesh_lora_train(torch, mesh, model, params, seed: int) -> dict:
    """13e: the fine-tune over the global batch on ``mesh`` (dp 2 x tp 2)
    and, on rank 0, one rank's over the same batch: each step's loss,
    the step-1 gradients gathered (relative to each leaf's norm) and the
    step-1 update (``_update_rel_err``: AdamW's first update is about lr
    times the sign of a gradient, so elements whose gradient is noise
    are left out), and the adapters after the last step.  Every rank:
    its flash launches and plain calls over the meshed steps."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.sharding import gather_params
    from k8s_gpu_tpu_torch.train.runner import tree_leaves, tree_like

    x, y = _lora_batch(torch, model, seed)
    meshed, grads = _lora_trainer(torch, model, params, seed, mesh)
    axes = meshed.model.logical_axes()
    fa.reset_counts()
    t0 = time.perf_counter()
    losses = [meshed.step(x, y)]
    wall1 = time.perf_counter() - t0
    g1 = tree_leaves(gather_params(tree_like(meshed.params, grads[0]),
                                   axes, mesh))
    # Copies: the leaves no axis cuts come back as the live parameters.
    theta1 = [p.clone() for p in tree_leaves(meshed.gathered_params())]
    losses += [meshed.step(x, y) for _ in range(SRV_LORA_TRAIN_STEPS - 1)]
    launches, plain = dict(fa.launch_counts), fa.plain_count
    last = tree_leaves(meshed.gathered_params())
    out = {"losses": losses, "step_s": wall1, "launches": launches,
           "plain_calls": plain}
    if dist.get_rank() == 0:
        one, one_grads = _lora_trainer(torch, model, params, seed)
        theta0 = [p.detach().clone() for p in tree_leaves(one.params)]
        ref = [one.step(x, y)]
        one1 = [p.detach().clone() for p in tree_leaves(one.params)]
        ref += [one.step(x, y) for _ in range(SRV_LORA_TRAIN_STEPS - 1)]
        out["one_rank_losses"] = ref
        out["loss_diff"] = max(abs(a - b) for a, b in zip(losses, ref))
        out["grad_rel_err"] = max(float((a - b).norm() / b.norm())
                                  for a, b in zip(g1, one_grads[0]))
        out["update_rel_err"], out["update_held_share"] = _update_rel_err(
            theta0, theta1, one1, g1, one_grads[0])
        out["adapter_max_abs_diff"] = max(
            float((a - b.detach()).abs().max())
            for a, b in zip(last, tree_leaves(one.params)))
        del one, one_grads
    del meshed, grads
    return out


def _own_shards(model, params, mesh):
    """This rank's shards of ``params`` as copies (the whole tree can
    go)."""
    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.train.runner import tree_map

    return tree_map(lambda t: t.clone(),
                    shard_params(params, model.logical_axes(), mesh))


def _serving_variants(torch, seed: int, model, params, meshes) -> dict:
    """13h-13i's trees on this rank: the MoE flagship (``MOE``) and the
    whole tree quantized, then cut; each this rank's shards."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.serve.quant import (
        quantize_params, shard_quantized,
    )
    from k8s_gpu_tpu_torch.train.runner import tree_map

    mm = TransformerLM(dataclasses.replace(model.cfg, **MOE),
                       device=model.device)
    mparams = mm.init(seed)
    return {
        "moe": (mm, {n: _own_shards(mm, mparams, m)
                     for n, m in meshes.items()}),
        "int8": tree_map(lambda t: t.clone(), shard_quantized(
            quantize_params(params), model.logical_axes(), meshes["tp4"])),
    }


def _serving_rank(seed: int, layers: int, device, tp4, dp2tp2) -> dict:
    """Phase 13 on one of the four ranks (``serve_ranks`` builds both
    meshes): 13a-13d and 13f-13j at the flagship's widths in bf16, then
    13e at SRV_F32_LAYERS in float32."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.models import TransformerLM

    meshes = {"tp4": tp4, "dp2tp2": dp2tp2}
    out = {"rank": dist.get_rank()}
    cfg = flagship_config(torch, layers)
    tok = flagship_tokenizer(cfg.vocab_size)
    for dtype, depth, parts in (
            (torch.bfloat16, layers, (*SRV_PARTS, *SRV_B_PARTS)),
            (torch.float32, SRV_F32_LAYERS, SRV_F32_PARTS)):
        cfg = dataclasses.replace(flagship_config(torch, depth), dtype=dtype)
        model = TransformerLM(cfg, device=device)
        params = model.init(seed)
        n_blocks = mix_blocks(cfg)
        jobs = serving_jobs(torch, seed, cfg.vocab_size)
        jobs_b = [(p, SRV_NEW_B, a) for p, _, a in jobs]
        ljobs = serving_lora_jobs(torch, seed, cfg.vocab_size)
        adapters = serving_adapters(torch, params, seed)
        # Each rank keeps its own shards only (copies): the whole tree
        # stays on rank 0 alone, for 13j's one-rank replica and the
        # float32 fine-tune's base.
        shards = {name: _own_shards(model, params, m)
                  for name, m in meshes.items()}
        var = _serving_variants(torch, seed, model, params, meshes)
        # 13f-13g's draft: the target itself (module docstring).
        draft = (model, shards["tp4"])
        whole = params if dist.get_rank() == 0 else None
        if dtype == torch.bfloat16:
            del params
            _free_if(torch, torch.device(device))
        res, back = {}, None
        for part in parts:
            bank = part == "tp4_bank"
            mname = "dp2tp2" if "dp2tp2" in part else "tp4"
            mesh = meshes[mname]
            m_, sh = model, shards[mname]
            if "moe" in part:
                m_, sh = var["moe"][0], var["moe"][1][mname]
            elif part == "tp4_int8":
                sh = var["int8"]
            if "neural" in part:
                res[part] = _mesh_batch(
                    torch, mesh, model, sh, jobs_b, part, n_blocks,
                    draft=draft, draft_int8=part == "tp4_neural_int8")
            elif part == "tp4_migrate":
                res[part] = _mesh_migrate(torch, mesh, model, sh, whole,
                                          tok, jobs_b, n_blocks, seed)
                back = res[part].pop("back", None)
            elif part == "tp4_disagg":
                res[part] = _mesh_disagg(torch, mesh, model, sh, tok,
                                         jobs_b, n_blocks, back)
            else:
                res[part] = _mesh_serve(
                    torch, mesh, m_, sh, tok,
                    jobs_b if part in SRV_B_PARTS
                    else ljobs if part in ("tp4_bankless", "tp4_bank")
                    else jobs,
                    part, n_blocks, adapters=adapters if bank else None,
                    repeat=dtype == torch.bfloat16 and part in (
                        "tp4_paged", "dp2tp2_dense"),
                    timed=dtype == torch.bfloat16 and part == "tp4_paged",
                    routes="moe" in part)
            dist.barrier()
        if dtype == torch.float32:
            res["lora"] = _mesh_lora_train(torch, dp2tp2, model, params,
                                           seed)
        out["bf16" if dtype == torch.bfloat16 else "f32"] = res
        del model, shards, adapters, var, whole, back, draft
        params = None
        _free_if(torch, torch.device(device))
    return out


def _one_rank_streams(torch, model, params, jobs, part: str, n_blocks: int,
                      adapters=None) -> list:
    """The same jobs through one rank's batcher on the whole weights,
    together, as the meshed burst sent them."""
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher

    knobs = _serving_knobs(part, n_blocks)
    b = ContinuousBatcher(model, params, slots=SRV_SLOTS, adapters=adapters,
                          device=model.device, **knobs).start()
    try:
        if knobs.get("draft") == "ngram":
            b.ngram_breakeven = 0.0
            b._ngram_next_meas = {"plain": float("inf"),
                                  "spec": float("inf")}
        hs = [b.submit(p, max_new_tokens=n, adapter=a if adapters else None)
              for p, n, a in jobs]
        return [h.result() for h in hs]
    finally:
        b.stop()


def _hold_launches(phase: str, runs: list, layers: int,
                   paged: bool) -> dict:
    """Every rank's paged launches over the server's life against the
    leader's kernel work (a launch a layer for each suffix-extend
    admission, verify sub-round and plain decode step), and no fall-back
    anywhere; a dense part launches nothing.  The verify windows' share
    is read from the wrapper's count by query width: a verify window is
    K + 1 wide, never 1 (a decode step) nor a power of two of at least 8
    (an admission's suffix bucket), for every K adaptive K picks."""
    work = runs[0]["work"]
    want = layers * (work["kernel_admissions"] + work["verify_subrounds"]
                     + work["decode_steps"]) if paged else 0
    want_verify = layers * work["verify_subrounds"] if paged else 0
    got = [r["launches"] for r in runs]
    verify = [sum(n for w, n in r["launches_by_width"].items()
                  if w > 1 and not (w >= 8 and w & (w - 1) == 0))
              for r in runs]
    fb = [r["fallbacks"] for r in runs]
    if (got != [want] * len(runs) or verify != [want_verify] * len(runs)
            or any(fb)):
        raise RuntimeError(f"{phase}: paged launches by rank {got} "
                           f"({verify} at verify widths), fall-backs "
                           f"{fb}; expected {want} ({want_verify}) on "
                           "each")
    return {"launches_per_rank": want, "verify_launches_per_rank": verify[0],
            "work": work}


def run_mesh_serving_path(torch, seed: int, layers: int,
                          device="cuda") -> dict:
    """Phase 13: serving on a mesh, four gloo ranks on the one card
    (``device="cpu"`` with one layer rehearses it on the CPU: the plain
    versions).  13a: tp 4 on the shared paged pool through the paged
    kernel at the rank's 2 heads, phase 4's pair and a slice of its mix
    (SRV_NEW tokens each) over the meshed ``LmServer``'s HTTP; 13b: dp 2
    x tp 2 on the dense pool, 8 slots (4 a dp group); 13c: tp 4 n-gram
    speculation on the paged pool; 13d: tp 4 with a two-adapter bank
    beside the bank-less server; 13f-13j: the neural and int8 drafts,
    MoE on both pools, int8 weights, block migration to a one-rank
    replica and back, /prefill and the in-process prefill pool (module
    docstring); 13e: all of them and int8 KV in float32 at
    SRV_F32_LAYERS, and a 3-step LoRA fine-tune over dp 2 x tp 2.  Each
    held against one rank's streams on the whole weights by the
    near-tie rule (bf16 0.25, float32 1e-4), launches rank by rank
    against the leader's kernel work."""
    import dataclasses
    import functools

    import chip_smoke
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig
    from k8s_gpu_tpu_torch.parallel.multihost import serve_ranks
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine

    t0 = time.perf_counter()
    ranks = serve_ranks(
        functools.partial(chip_smoke._serving_rank, seed, layers, device),
        MeshConfig(**SRV_MESHES["tp4"]), MeshConfig(**SRV_MESHES["dp2tp2"]),
        timeout=SRV_TIMEOUT, device=device, backend="gloo")
    out = {"layers": layers, "f32_layers": SRV_F32_LAYERS,
           "world": SRV_WORLD,
           "meshes": SRV_MESHES, "cluster_s": time.perf_counter() - t0}
    cuda = torch.device(device).type == "cuda"
    failures = []
    for key, dtype, depth, parts, gap, tie in (
            ("bf16", torch.bfloat16, layers, (*SRV_PARTS, *SRV_B_PARTS),
             BF16_TIE_GAP, BF16_ROUTER_TIE),
            ("f32", torch.float32, SRV_F32_LAYERS, SRV_F32_PARTS,
             F32_TIE_GAP, F32_ROUTER_TIE)):
        cfg = dataclasses.replace(flagship_config(torch, depth),
                                  dtype=dtype)
        model = TransformerLM(cfg, device=device)
        params = model.init(seed)
        engine = InferenceEngine(model, device=model.device)
        n_blocks = mix_blocks(cfg)
        jobs = serving_jobs(torch, seed, cfg.vocab_size)
        ljobs = serving_lora_jobs(torch, seed, cfg.vocab_size)
        adapters = serving_adapters(torch, params, seed)
        b_ref = _BRef(torch, seed, model, params, engine, n_blocks, jobs)
        res, one = {}, {}
        for part in parts:
            runs = [r[key][part] for r in ranks]
            lead = runs[0]
            phase = f"phase 13 {key} {part}"
            held = {k: v for k, v in lead.items()
                    if k not in ("streams", "launches", "fallbacks",
                                 "launches_by_width", "routes",
                                 "peak_memory_gb", "prefill_streams",
                                 "prefill_job")}
            held["peak_memory_gb_by_rank"] = [r["peak_memory_gb"]
                                              for r in runs]
            if cuda:
                hold = (functools.partial(b_ref._held, phase)
                        if part in SRV_B_PARTS else lambda fn, *a: fn(*a))
                held.update(hold(_hold_launches, phase, runs, depth,
                                 "dense" not in part))
            held["timed_round_by_rank"] = [r.get("timed_round")
                                           for r in runs[1:]]
            if part in SRV_B_PARTS:
                held.update(b_ref.hold(part, runs, gap, tie))
                res[part] = held
                continue
            if "paged" in part or part in ("tp4_ngram", "tp4_kv_quant"):
                if lead["admissions"].get("paged_shared", 0) < 1:
                    raise RuntimeError(f"{phase}: no shared-prefix "
                                       f"admission: {lead['admissions']}")
            if part == "tp4_bank":
                n_ad = sum(1 for a in SRV_LORA_JOBS if a)
                if lead["admissions"] != {"paged_cold": 1,
                                          "paged_shared": 1, "cold": n_ad}:
                    raise RuntimeError(
                        f"{phase}: admissions {lead['admissions']}: base "
                        "rows after the first must share, adapter rows "
                        "never")
                base = [i for i, a in enumerate(SRV_LORA_JOBS) if a is None]
                bankless = res["tp4_bankless"]["_streams"]
                held["base_vs_bankless"] = _compare_streams(
                    torch, engine, params, [ljobs[i][:2] for i in base],
                    [bankless[i] for i in base],
                    [lead["streams"][i] for i in base], gap)
            # One rank's streams: the plain paged server for the plain,
            # n-gram and bank-less parts (greedy streams are the plain
            # ones), its own for the dense pool, int8 KV and the bank.
            ref_part = {"tp4_ngram": "tp4_paged"}.get(part, part)
            pjobs = ljobs if part in ("tp4_bankless", "tp4_bank") else jobs
            if ref_part not in one:
                one[ref_part] = _one_rank_streams(
                    torch, model, params, pjobs, ref_part, n_blocks,
                    adapters=adapters if part == "tp4_bank" else None)
            held["vs_one_rank"] = _vs_one_rank(
                torch, engine, params, pjobs, one[ref_part],
                lead["streams"], gap,
                adapters if part == "tp4_bank" else None)
            held["_streams"] = lead["streams"]
            res[part] = held
        for held in res.values():
            held.pop("_streams", None)
        if key == "f32":
            res["lora"] = _hold_mesh_lora(ranks, cuda)
        out[key] = res
        failures += [f"{key} {f}" for f in b_ref.failures]
        del model, params, engine, adapters, b_ref
        _free_if(torch, torch.device(device))
    out["phase_s"] = time.perf_counter() - t0
    out["failures"] = failures
    return out


class _BRef:
    """13f-13j's yardsticks in the parent, one rank on the whole
    weights, each made once: the plain paged streams of the SRV_NEW_B
    jobs (a greedy stream with any draft is the plain one), the MoE
    flagship's and the int8 tree's."""

    def __init__(self, torch, seed, model, params, engine, n_blocks, jobs):
        self.torch, self.seed = torch, seed
        self.model, self.params, self.engine = model, params, engine
        self.n_blocks = n_blocks
        self.jobs = [(p, SRV_NEW_B, a) for p, _, a in jobs]
        self._one = {}
        self.failures = []

    def _streams(self, kind: str):
        """(engine, params, streams) of one rank's ``kind``: "plain",
        "moe" or "int8"."""
        import dataclasses

        if kind not in self._one:
            torch, model, params = self.torch, self.model, self.params
            if kind == "moe":
                from k8s_gpu_tpu_torch.models import TransformerLM
                from k8s_gpu_tpu_torch.serve.engine import InferenceEngine

                model = TransformerLM(dataclasses.replace(model.cfg, **MOE),
                                      device=model.device)
                params = model.init(self.seed)
                engine = InferenceEngine(model, device=model.device)
            else:
                engine = self.engine
            if kind == "int8":
                from k8s_gpu_tpu_torch.serve.quant import quantize_params

                params = quantize_params(params)
            self._one[kind] = (engine, params, _one_rank_streams(
                torch, model, params, self.jobs, "tp4_paged",
                self.n_blocks))
        return self._one[kind]

    def hold(self, part: str, runs: list, gap: float, tie: float) -> dict:
        """``part``'s checks against one rank: admissions, speculation,
        and its streams by the near-tie rule (MoE: ``_moe_held``, with
        the router ``tie``)."""
        phase = f"phase 13 {part}"
        lead = runs[0]
        paths = lead["admissions"]
        kind = ("moe" if "moe" in part else "int8" if part == "tp4_int8"
                else "plain")
        engine, params, ref = self._streams(kind)
        idx = {"tp4_migrate": [0, 1], "tp4_disagg": [1, 2, 3]}.get(
            part, range(len(self.jobs)))
        jobs = [self.jobs[i] for i in idx]
        if kind == "moe" and paths.get("paged_shared"):
            self.failures.append(f"{phase}: MoE shares no blocks: {paths}")
        if "neural" in part and paths != {"cold": len(jobs)}:
            self.failures.append(f"{phase}: a draft row not prefilled: "
                                 f"{paths}")
        elif kind != "moe" and "neural" not in part and paths.get(
                "paged_shared", 0) < 1:
            self.failures.append(f"{phase}: no shared-prefix admission: "
                                 f"{paths}")
        if "neural" in part and not lead["spec"]["drafted"]:
            self.failures.append(f"{phase}: nothing drafted: "
                                 f"{lead['spec']}")
        if part == "tp4_neural" and not lead["spec"]["accepted"]:
            self.failures.append(f"{phase}: the target as its own draft "
                                 f"had nothing accepted: {lead['spec']}")
        ref = [ref[i] for i in idx]
        if kind == "moe":
            out = {"vs_one_rank": self._moe_held(
                phase, engine, params, jobs, ref, lead["streams"], gap,
                [r["routes"] for r in runs], tie)}
        else:
            out = {"vs_one_rank": self._held(
                phase, _vs_one_rank, self.torch, engine, params, jobs, ref,
                lead["streams"], gap, None)}
        if part == "tp4_migrate":
            replica, meshed = lead["prefill_streams"]
            out["prefill_vs_replica"] = self._held(
                phase, _vs_one_rank, self.torch, engine, params,
                [(*lead["prefill_job"], None)], [replica], [meshed], gap,
                None)
        return out

    def _held(self, phase: str, fn, *args):
        """``fn(*args)``, a failed check kept in ``failures`` (with its
        phase) so that every part is measured before the run fails."""
        try:
            return fn(*args)
        except RuntimeError as e:
            self.failures.append(f"{phase}: {e}")
            return {"failed": str(e)}

    def _moe_held(self, phase, engine, params, jobs, ref, got, gap,
                  routes, tie) -> dict:
        """The near-tie rule for MoE, each departure read on the
        batcher's own computation (``_moe_forward``).  It passes at a
        top-2 logit gap under ``gap``, or where some rank's router
        (``routes``: each rank's replay of the meshed stream) chose
        another expert than one rank's at the departing token or before
        it, every such choice within ``tie`` of a tie in one rank's
        router: a tp sum moves the router's input by a rounding, and a
        flipped choice moves the logits by far more (phase 11c's dropped
        share)."""
        torch = self.torch
        out = {"exact": ref == got, "departures": []}
        for i, ((prompt, _, _), a, b) in enumerate(zip(jobs, ref, got)):
            d = _first_departure(a, b)
            if d is None:
                continue
            logits, mine = _moe_forward(torch, engine, params, prompt,
                                        a[:d])
            top = torch.topk(logits.float(), 2).values
            entry = {"request": i, "position": d,
                     "gap": float(top[0] - top[1])}
            if not entry["gap"] < gap:
                P = mine["expert"].shape[1]
                flips = sorted({
                    (layer, pos) for r in routes
                    for layer, pos in (r[i]["expert"][:, :P]
                                       != mine["expert"]).nonzero().tolist()})
                entry["router_flips"] = [
                    {"layer": layer, "position": pos,
                     "router_gap": float(mine["gap"][layer, pos])}
                    for layer, pos in flips]
                if not flips or any(f["router_gap"] >= tie
                                    for f in entry["router_flips"]):
                    self.failures.append(
                        f"{phase}: request {i} departs at token {d}, logit "
                        f"gap {entry['gap']}, router choices that differ "
                        f"from one rank's: {entry['router_flips']} (tie "
                        f"{tie})")
            out["departures"].append(entry)
        return out


# A router choice this close (top-2 probability gap) to a tie may flip
# under a tp sum: a bf16 rounding of the router's input, or a float32 one.
BF16_ROUTER_TIE = 2 ** -6
F32_ROUTER_TIE = 1e-5


def _vs_one_rank(torch, engine, params, jobs, ref, got, gap,
                 adapters) -> dict:
    """``got`` against one rank's ``ref`` by the near-tie rule, each
    request's departure gap read on the weights it was served with (an
    adapter row's: ``LoraAdapter.merge``d; ``adapters`` None: every row
    base)."""
    from k8s_gpu_tpu_torch.train import LoraAdapter

    out = {"exact": ref == got, "departures": []}
    names = [a if adapters else None for _, _, a in jobs]
    for name in sorted(set(names), key=str):
        idx = [i for i, a in enumerate(names) if a == name]
        w = params
        if name is not None:
            tree, cfg = adapters[name]
            w = LoraAdapter(cfg).merge(params, tree)
        for d in _departures(torch, engine, w, [jobs[i][:2] for i in idx],
                             [ref[i] for i in idx], [got[i] for i in idx],
                             gap):
            out["departures"].append(dict(d, request=idx[d["request"]]))
    return out


def _hold_mesh_lora(ranks, cuda: bool) -> dict:
    """13e's fine-tune on every rank: the same losses everywhere, within
    SRV_LORA_TOL of one rank's, and the step-1 gradients and update
    within it too (at least half the elements held); on the card each
    rank's flash v1 launches exact at the tp-local heads (the forward
    twice a layer and step under full remat, dq and dk/dv once) and no
    plain call."""
    from k8s_gpu_tpu_torch.ops import attention as fa

    lead = ranks[0]["f32"]["lora"]
    want = _par_launches(fa, SRV_F32_LAYERS, 1, 1, SRV_LORA_TRAIN_STEPS,
                         FLASH_KERNELS)
    for i, r in enumerate(ranks):
        got = r["f32"]["lora"]
        if cuda and (got["launches"] != want or got["plain_calls"]):
            raise RuntimeError(
                f"phase 13e LoRA: rank {i} launched {got['launches']} and "
                f"{got['plain_calls']} plain calls; expected {want}, 0")
    if any(r["f32"]["lora"]["losses"] != lead["losses"] for r in ranks):
        raise RuntimeError("phase 13e LoRA: the ranks' losses differ")
    worst = max(lead["loss_diff"], lead["grad_rel_err"],
                lead["update_rel_err"])
    if not (worst <= SRV_LORA_TOL and lead["update_held_share"] >= 0.5):
        raise RuntimeError(
            f"phase 13e LoRA over dp 2 x tp 2 against one rank: loss "
            f"{lead['loss_diff']}, gradients {lead['grad_rel_err']}, "
            f"update {lead['update_rel_err']} over "
            f"{lead['update_held_share']} of the elements; limit "
            f"{SRV_LORA_TOL}")
    return {**lead, "step_s": max(r["f32"]["lora"]["step_s"]
                                  for r in ranks),
            "launches": {k: sum(r["f32"]["lora"]["launches"][k]
                                for r in ranks) for k in lead["launches"]},
            "plain_calls": sum(r["f32"]["lora"]["plain_calls"]
                               for r in ranks),
            "batch": SRV_LORA_TRAIN_BATCH,
            "steps": SRV_LORA_TRAIN_STEPS}


# -- phase 14: the state of a meshed trainer, save_attn on every mesh ---------

# Four gloo ranks on the one card at the flagship's widths and PAR_LAYERS
# depth, sequences of STATE_SEQ (half of 2048: the whole script's time
# limit).  14a: dp 2 x tp 2 (phase 11a's v2 configuration) with ZeRO-1
# and an EMA trains STATE_STEPS steps, saves, and takes one more step;
# the checkpoint resumes onto pp 2 x tp 2 (1F1B) and, in this process,
# onto the card alone; each takes that step again.  The same at float32,
# 2 layers and STATE_F32_SEQ.  14b: save_attn beside full remat on each
# mesh of SAVE_ATTN_RUNS.  14c: the CNN over dp 2 x tp 2 and the LoRA
# model over dp 2 x pp 2 (GPipe), a step each.  14d: 14a's model and
# mesh under the fsdp rule table (STATE_FSDP) beside the default rules.
STATE_SEQ = 1024
# Within the whole script phase 14 runs 2 layers: with it at PAR_LAYERS
# (4) the script took 1058.8 s of its 1200 s limit on an H100 (PERF.md).
STATE_LAYERS = 2
STATE_BATCH = 4
STATE_STEPS = 2
# 14a's float32 run: a small configuration of the same shape (GQA with
# the v2 knobs, 2 layers), 256-token rows.
STATE_F32 = dict(vocab_size=4096, d_model=512, n_heads=4, n_kv_heads=2,
                 d_ff=1024)
STATE_F32_LAYERS = 2
STATE_F32_SEQ = 256
# The resumed step's loss against the uninterrupted one, the restored
# state being bit for bit the saved one: on pp 2 x tp 2, the same tp
# layout, bf16 within 2.4e-4 (the gap phase 11 measured on an H100
# between a tp 2 layout and one rank at step 1; 14b's step-1 losses
# too); on the card alone, a layout without tp whose bf16 sums differ
# (1.4e-4 to 3.6e-4 at 2 and 4 layers on an H100, PERF.md), within
# 1e-3; float32 within phase 7's limit.
STATE_TOL = 2.4e-4
STATE_LAYOUT_TOL = 1e-3
STATE_F32_TOL = TRAIN_TOL["float32"]["loss"]
# 14b: the counted step's gradients under save_attn against full
# remat's, the worst leaf's relative error on any rank: 0.0 on every
# mesh but the ring, whose replay differentiates through the final lse
# where full remat differentiates each hop's merge (9.0e-3 in bf16 on
# an H100, PERF.md); a replay that doubles the ring's dK reads 1.16.
SAVE_ATTN_GRAD_TOL = 2e-2
STATE_EMA = 0.99
STATE_TIMEOUT = 500.0
STATE_DIR = os.path.join(ROOT, "build", "chip", "state")
STATE_MESHES = {"dp2tp2": dict(dp=2, tp=2), "pp2tp2": dict(dp=1, pp=2, tp=2),
                "sp2tp2": dict(dp=1, sp=2, tp=2),
                "ep2tp2": dict(dp=1, ep=2, tp=2),
                "dp2pp2": dict(dp=2, pp=2), "dp4": dict(dp=4)}
# name: (mesh, configuration, global batch): phase 11's and 12b's.
SAVE_ATTN_RUNS = {
    "dp2tp2": ("dp2tp2", "v2", STATE_BATCH),
    "sp2tp2_ring": ("sp2tp2", "ring", TP_SP_BATCH),
    "sp2tp2_ulysses": ("sp2tp2", "ulysses", TP_SP_BATCH),
    "ep2tp2_moe": ("ep2tp2", "moe", STATE_BATCH),
    "1f1b_pp2tp2": ("pp2tp2", "1f1b", STATE_BATCH),
}
STATE_PARTS = ("checkpoint", "save_attn", "consumers", "fsdp", "moved")
# 14d's rule table over the defaults: the reference's fsdp switch.
STATE_FSDP = {"embed": "dp"}
# 14a's resumes on a mesh: (mesh, rules over the defaults).  dp 4 under
# fsdp has no tp, so its bf16 sums differ from dp 2 x tp 2's as the card
# alone's do: it is held within STATE_LAYOUT_TOL.
STATE_RESUMES = {"pp2tp2": ("pp2tp2", {}), "fsdp_dp4": ("dp4", STATE_FSDP)}
# 14e's table: the MLP whole on every tp rank (a weight axis moved).
STATE_MOVED = {"mlp": None}
# 14e's losses against the default table's: bf16 phase 7's limit, the
# float32 twin 1e-5 (the two differ only in the global norm's order of
# sums).
STATE_MOVED_TOL = {"": TRAIN_TOL["bfloat16"]["loss"], "_f32": 1e-5}
# 14e's whole parameters, moments and EMA after the counted step against
# the default table's, each leaf's largest gap over its largest element:
# the two tables' gradients agree before the clip, and only the global
# norm's order of sums differs, a few float32 ulps.  A gradient scaled or
# summed wrongly moves the moments by its factor.
STATE_MOVED_STATE_TOL = 1e-5
# A shard-wise save copies each block to the host: a rank's device peak
# over the save may rise by the allocator's rounding, not by a tree.
SAVE_PEAK_SLACK_GB = 0.01
CNN_BATCH = 64
STATE_LORA_RANK = 8


def state_config(torch, layers: int, kind: str, dtype=None,
                 seq: int = STATE_SEQ):
    """The configuration of a phase 14 run: phase 11a's v2 ("v2", also
    14a's), 11b's ring or Ulysses, 11c's MoE, or 12b's 1F1B; "f32",
    14a's small float32 one."""
    import dataclasses

    if kind == "f32":
        return dataclasses.replace(
            parallel_config(torch, layers, torch.float32, seq=seq),
            **STATE_F32)
    if kind in ("v2", "ring", "ulysses"):
        return parallel_config(torch, layers, dtype, seq=seq,
                               sp_attention="ring" if kind == "v2"
                               else kind)
    if kind == "moe":
        return tp_moe_config(torch, layers, dtype, seq)
    return pp_config(torch, layers, PP_RUNS["1f1b_pp2tp2"], dtype, seq)


def save_attn_launches(fa, cfg, kind: str, pp_stage: int = 0) -> tuple:
    """(flash launches, rope pre-passes) a rank makes in one step under
    ``cfg``'s remat policy, written before the first run: each attention
    call's forward once a layer and microbatch under save_attn (twice
    under full remat, but 1F1B's last stage, whose forward is fused into
    its backward tick), dq and dk/dv once.  Calls a layer: the ring at sp
    2 makes 3 (hop 0, and hop 1's two visible blocks), the rest 1.
    Kernels: v2 for the GQA configurations whose K/V stay grouped (v2,
    the ring, 1F1B), v1 for Ulysses (K/V broadcast) and the MoE model.
    Pre-passes: with rope in the kernels (never on sp, where rope is
    outside) one a forward and one a backward."""
    layers, micro = cfg.n_layers, 1
    last = False
    if kind == "1f1b":
        layers //= 2
        micro = cfg.pp_microbatches
        last = pp_stage == 1
    calls = 3 if kind == "ring" else 1
    per = layers * micro * calls
    fwd = per if cfg.remat_policy == "save_attn" or last else 2 * per
    names = FLASH_V2_KERNELS if kind in ("v2", "ring", "1f1b") \
        else FLASH_KERNELS
    pre = fwd + per if cfg.flash_fuse_rope and kind in ("v2", "1f1b") \
        else 0
    return _counts(fa, dict(zip(names, (fwd, per, per)))), pre


def _fingerprint(torch, tree) -> list:
    """Each float32 leaf's bits summed as integers, plain and weighted by
    position (mod 2^64): the same for trees equal bit for bit, whatever
    the device or the order of the sum."""
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    out = []
    for t in tree_leaves(tree):
        bits = t.detach().contiguous().view(torch.int32).reshape(-1).long()
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * weight).sum())))
    return out


def _state_prints(torch, trainer) -> dict:
    """Fingerprints of a trainer's whole parameters, moments and EMA
    (collectives on a mesh)."""
    opt = trainer.opt_state
    return {"params": _fingerprint(torch, trainer.gathered_params()),
            "mu": _fingerprint(torch, opt["mu"]),
            "nu": _fingerprint(torch, opt["nu"]),
            "ema": _fingerprint(torch, trainer.gathered_ema()),
            "count": opt["count"]}


def _state_trees(torch, trainer) -> dict | None:
    """A trainer's whole parameters, moments and EMA as host leaves by
    kind (collectives on a mesh), kept by rank 0 alone (None on the
    others)."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    opt = trainer.opt_state
    trees = {"params": trainer.gathered_params(), "mu": opt["mu"],
             "nu": opt["nu"], "ema": trainer.gathered_ema()}
    if dist.get_rank():
        return None
    # Copies: on the CPU a leaf may be the trainer's own tensor, which
    # the next step updates in place.
    return {kind: [t.detach().to("cpu", copy=True)
                   for t in tree_leaves(tree)]
            for kind, tree in trees.items()}


def _state_gaps(torch, want: dict, got: dict) -> dict:
    """For each kind of ``_state_trees``: the largest leaf's max |got -
    want| over its max |want|, and whether every leaf is equal bit for
    bit."""
    out = {}
    for kind, leaves in want.items():
        pairs = list(zip(leaves, got[kind]))
        out[kind] = {
            "rel_err": max(float((g - w).abs().max()
                                 / w.abs().max().clamp_min(1e-30))
                           for w, g in pairs),
            "bit_equal": all(torch.equal(w, g) for w, g in pairs)}
    return out


def _measured_save(torch, dev, trainer, root: str, step: int) -> dict:
    """A shard-wise save of ``trainer`` (a collective): seconds, the bytes
    this rank wrote, the step's bytes, this rank's device peak during
    the save over what it held just before (None on the CPU), and, read
    from the manifest, the elements the step's blocks store against the
    whole trees'."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer

    ckpt, save, _ = attach_to_trainer(trainer, root)
    _syncer(torch, dev)()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    dist.barrier()
    t0 = time.perf_counter()
    save(step)
    out = {"save_s": time.perf_counter() - t0,
           "save_peak_over_gb": ((torch.cuda.max_memory_allocated() - before)
                                 / 1e9 if dev.type == "cuda" else None)}
    step_dir = os.path.join(root, str(step))
    mine = os.path.join(step_dir, f"rank{dist.get_rank()}.pt")
    out["bytes_written"] = os.path.getsize(mine) if os.path.exists(mine) \
        else 0
    out["bytes"] = ckpt._step_bytes(step)
    with open(os.path.join(step_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    out["stored_elements"] = sum(
        math.prod(sum(b - a for a, b in runs) for runs in held)
        for blocks in manifest["files"].values() for held in blocks.values())
    out["whole_elements"] = sum(
        math.prod(meta["shape"]) for leaves in manifest["leaves"].values()
        for meta in leaves.values())
    out["files"] = sorted(manifest["files"])
    return out


def _measured_resume(torch, dev, cfg, tc, mesh, rules, root: str, seed: int,
                     toks) -> dict:
    """A fresh trainer of ``cfg`` (init ``seed``) on ``mesh`` under
    ``rules`` resumed from ``root``'s latest step: step, restore seconds,
    the restored state's fingerprints, the loss of a step on ``toks``."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.train import Trainer
    from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer

    tr = Trainer(TransformerLM(cfg, device=dev), tc, device=dev, mesh=mesh,
                 rules=rules)
    tr.init(seed)
    _syncer(torch, dev)()
    if mesh is not None:
        dist.barrier()
    t0 = time.perf_counter()
    step = attach_to_trainer(tr, root)[2]()
    _syncer(torch, dev)()
    out = {"step": step, "restore_s": time.perf_counter() - t0,
           "prints": _state_prints(torch, tr)}
    out["loss"] = tr.step(toks[:, :-1], toks[:, 1:])
    del tr
    _free_if(torch, dev)
    return out


def _state_checkpoint(torch, seed: int, cfg, meshes, dev, root: str,
                      batch: int) -> dict:
    """14a on one rank: dp 2 x tp 2 trains, saves shard-wise and steps
    on; then the checkpoint resumes onto each of STATE_RESUMES and steps
    again."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.parallel.sharding import DEFAULT_RULES, ParamRules
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    tc = TrainConfig(warmup_steps=1, zero1=True, ema_decay=STATE_EMA)
    toks = _par_tokens(torch, seed, cfg, batch)
    x, y = toks[:, :-1], toks[:, 1:]
    tr = Trainer(TransformerLM(cfg, device=dev), tc, device=dev,
                 mesh=meshes["dp2tp2"])
    tr.init(seed)
    losses = [tr.step(x, y) for _ in range(STATE_STEPS)]
    rest = _rest_bytes(tr)
    saved = _state_prints(torch, tr)
    out = _measured_save(torch, dev, tr, root, STATE_STEPS)
    losses.append(tr.step(x, y))
    del tr
    _free_if(torch, dev)
    out.update(losses=losses, saved_prints=saved, rest_bytes=rest,
               resumes={})
    for where, (mesh, table) in STATE_RESUMES.items():
        got = _measured_resume(
            torch, dev, cfg, dataclasses.replace(tc, zero1=not table),
            meshes[mesh], ParamRules({**DEFAULT_RULES, **table}), root,
            seed + 1, toks)
        got["state_equal"] = got.pop("prints") == saved
        out["resumes"][where] = got
    return out


def _rest_bytes(trainer) -> int:
    """The bytes a rank holds between steps: its parameters, AdamW's
    moments and the EMA."""
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    held = (tree_leaves(trainer.params) + trainer.optimizer.mu
            + trainer.optimizer.nu
            + (tree_leaves(trainer.ema) if trainer.ema is not None else []))
    return sum(t.numel() * t.element_size() for t in held)


def _state_fsdp(torch, seed: int, cfg, mesh, dev, batch: int, table=None,
                root: str | None = None, zero1_check: bool = False,
                resume_onto=None, trees: list | None = None) -> dict:
    """14d and 14e on one rank: STATE_STEPS steps of 14a's model (an EMA,
    no ZeRO-1) under the default rules plus ``table``, the last one
    counted (flash launches, peak GB, seconds), then one more (the first
    that follows an update at a learning rate above 0).  With ``root``
    the state is saved there shard-wise before it (``_measured_save``);
    ``zero1_check``: ZeRO-1 under ``table`` is tried at ``init``;
    ``resume_onto``: (mesh, table) a fresh trainer resumes that save
    onto, taking the same step; ``trees``: the state after the counted
    step is appended to it (``_state_trees``)."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.sharding import DEFAULT_RULES, ParamRules
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.runner import tree_paths

    rules = ParamRules({**DEFAULT_RULES, **(table or {})})
    toks = _par_tokens(torch, seed, cfg, batch)
    x, y = toks[:, :-1], toks[:, 1:]
    tc = TrainConfig(warmup_steps=1, ema_decay=STATE_EMA)
    tr = Trainer(TransformerLM(cfg, device=dev), tc, device=dev, mesh=mesh,
                 rules=rules)
    tr.init(seed)
    losses = [tr.step(x, y) for _ in range(STATE_STEPS - 1)]
    _syncer(torch, dev)()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    losses.append(tr.step(x, y))
    out = {"losses": losses, "step_s": time.perf_counter() - t0,
           "launches": dict(fa.launch_counts),
           "prepass_launches": fa.prepass_counts["flash_v2_rope_split"],
           "plain_calls": fa.plain_count,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if dev.type == "cuda" else None),
           "rest_bytes": _rest_bytes(tr),
           "embed_shape": tuple(tr.params["embed"].shape),
           "leaves": {p: {"shape": list(sh), "spec": [
               list(e) if isinstance(e, tuple) else e for e in sp]}
               for p, sh, sp in zip(tree_paths(tr.params), tr.shapes,
                                    tr._specs())},
           "moved": [p for p, m in zip(tree_paths(tr.params), tr.moved)
                     if m is not None]}
    if trees is not None:
        trees.append(_state_trees(torch, tr))
    if root is not None:
        out["saved_prints"] = _state_prints(torch, tr)
        out["save"] = _measured_save(torch, dev, tr, root, STATE_STEPS)
    losses.append(tr.step(x, y))
    del tr
    _free_if(torch, dev)
    if zero1_check:
        try:
            Trainer(TransformerLM(cfg, device=dev),
                    TrainConfig(warmup_steps=1, zero1=True), device=dev,
                    mesh=mesh, rules=rules).init(seed)
            out["zero1_refusal"] = None
        except ValueError as e:
            out["zero1_refusal"] = str(e)
        _free_if(torch, dev)
    if resume_onto is not None:
        onto, onto_table = resume_onto
        got = _measured_resume(
            torch, dev, cfg, tc, onto,
            ParamRules({**DEFAULT_RULES, **onto_table}), root, seed + 3,
            toks)
        got["state_equal"] = got.pop("prints") == out["saved_prints"]
        out["resumed"] = got
    return out


def _state_save_attn(torch, seed: int, cfg, kind: str, mesh, dev,
                     batch: int) -> dict:
    """14b on one rank: a warm-up step (learning rate 0) and one counted
    step from a fresh peak, then the loss after that step's update (a
    forward without gradients).  The gradients the counted step hands
    AdamW (this rank's shards) come back on the host under ``grads``:
    its update is about lr times their sign, so the losses alone would
    not show a replay that scales dK/dV or loses part of a hop's dq."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.mesh import axis_rank
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    tr = Trainer(TransformerLM(cfg, device=dev), TrainConfig(warmup_steps=1),
                 device=dev, mesh=mesh)
    tr.init(seed)
    toks = _par_tokens(torch, seed, cfg, batch)
    x, y = tr.shard_batch(toks[:, :-1], toks[:, 1:])
    first = tr.step(toks[:, :-1], toks[:, 1:])
    seen = _recording_grads(tr)
    _syncer(torch, dev)()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    tr.step(toks[:, :-1], toks[:, 1:])
    step_s = time.perf_counter() - t0
    out = {"first_loss": first, "step_s": step_s,
           "launches": dict(fa.launch_counts),
           "prepass_launches": fa.prepass_counts["flash_v2_rope_split"],
           "plain_calls": fa.plain_count,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if dev.type == "cuda" else None),
           "stage": axis_rank(mesh, "pp"),
           "grads": [g.cpu() for g in seen[0]]}
    with torch.no_grad():
        loss = tr.model.loss(tr.params, x, y, mesh=mesh)
        out["updated_loss"] = float(tr._reduce(loss, [])[0])
    del tr, seen
    _free_if(torch, dev)
    return out


def _state_consumers(torch, seed: int, layers: int, seq: int, meshes,
                     dev) -> dict:
    """14c on one rank: one step of the CNN over dp 2 x tp 2 and of the
    LoRA model over dp 2 x pp 2 (GPipe)."""
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    out = {}
    for name, (model, params, batch) in _consumer_models(
            torch, seed, layers, seq, dev).items():
        tr = _consumer_trainer(torch, model, params, dev,
                               meshes["dp2tp2" if name == "cnn"
                                      else "dp2pp2"])
        out[name] = {"loss": tr.step(*batch),
                     "shapes": [tuple(t.shape)
                                for t in tree_leaves(tr.params)]}
        del tr
        _free_if(torch, dev)
    return out


def _consumer_models(torch, seed: int, layers: int, seq: int, dev) -> dict:
    """{name: (model, starting parameters, global batch)} of 14c: the
    reference's CNN (bf16) on CNN_BATCH images, and a rank-8 LoRA on the
    flagship's attention (v1, GPipe's M 2) over STATE_BATCH rows."""
    import dataclasses

    from k8s_gpu_tpu_torch.models import CnnConfig, SmallCnn, TransformerLM
    from k8s_gpu_tpu_torch.train import LoraConfig, LoraModel

    gen = torch.Generator().manual_seed(seed + 11)
    cnn = SmallCnn(CnnConfig(), device=dev)
    images = torch.randn((CNN_BATCH, 28, 28, 1), generator=gen)
    labels = torch.randint(0, 10, (CNN_BATCH,), generator=gen)
    cfg = dataclasses.replace(flagship_train_config(torch, layers),
                              max_seq=seq, pp_schedule="gpipe")
    base_model = TransformerLM(cfg, device=dev)
    base = base_model.init(seed)
    lora = LoraModel(base_model, base, LoraConfig(rank=STATE_LORA_RANK))
    adapters = lora.init(seed + 1)
    draw = torch.Generator(device=dev).manual_seed(seed + 2)
    for ab in adapters["blocks"].values():      # B = 0 would train nothing
        ab["b"].normal_(0.0, 0.02, generator=draw)
    toks = _par_tokens(torch, seed, cfg, STATE_BATCH)
    return {"cnn": (cnn, cnn.init(seed), (images, labels)),
            "lora": (lora, adapters, (toks[:, :-1], toks[:, 1:]))}


def _consumer_trainer(torch, model, params, dev, mesh=None):
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    tr = Trainer(model, TrainConfig(warmup_steps=1), device=dev, mesh=mesh)
    tr.init(params=params)
    return tr


def _state_rank(seed: int, layers: int, seq: int, device, root: str,
                parts=STATE_PARTS) -> dict:
    """What each of phase 14's four gloo ranks runs (``parts``: which of
    STATE_PARTS)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**sizes), device_type=dev.type)
              for name, sizes in STATE_MESHES.items()}
    out = {"rank": dist.get_rank()}
    if "checkpoint" in parts:
        out["checkpoint"] = _state_checkpoint(
            torch, seed, state_config(torch, layers, "v2", seq=seq), meshes,
            dev, os.path.join(root, "bf16"), STATE_BATCH)
        out["checkpoint_f32"] = _state_checkpoint(
            torch, seed, state_config(torch, STATE_F32_LAYERS, "f32",
                                      seq=STATE_F32_SEQ),
            meshes, dev, os.path.join(root, "f32"), STATE_BATCH)
    if "save_attn" in parts:
        for name, (mesh, kind, batch) in SAVE_ATTN_RUNS.items():
            grads = {}
            for policy in ("full", "save_attn"):
                cfg = dataclasses.replace(
                    state_config(torch, layers, kind, seq=seq),
                    remat_policy=policy)
                run = _state_save_attn(torch, seed, cfg, kind, meshes[mesh],
                                       dev, batch)
                grads[policy] = run.pop("grads")
                out[f"{name}_{policy}"] = run
            # Each leaf's gradient under save_attn against full remat's,
            # relative to its norm (the shards this rank holds).
            out[f"{name}_grad_rel_err"] = max(
                float((a.double() - b.double()).norm()
                      / b.double().norm().clamp_min(1e-30))
                for a, b in zip(grads["save_attn"], grads["full"]))
            del grads
    if "consumers" in parts:
        out["consumers"] = _state_consumers(torch, seed, layers, seq,
                                            meshes, dev)
    for key, cfg in (("", state_config(torch, layers, "v2", seq=seq)),
                     ("_f32", state_config(torch, STATE_F32_LAYERS, "f32",
                                           seq=STATE_F32_SEQ))):
        held = [] if "moved" in parts else None
        if "fsdp" in parts or "moved" in parts:
            out[f"fsdp_default{key}"] = _state_fsdp(
                torch, seed, cfg, meshes["dp2tp2"], dev, STATE_BATCH,
                trees=held)
        if "fsdp" in parts:
            out[f"fsdp{key}"] = _state_fsdp(
                torch, seed, cfg, meshes["dp2tp2"], dev, STATE_BATCH,
                STATE_FSDP, os.path.join(root, f"fsdp{key}") if not key
                else None, zero1_check=not key)
        if "moved" in parts:
            out[f"moved{key}"] = _state_fsdp(
                torch, seed, cfg, meshes["dp2tp2"], dev, STATE_BATCH,
                STATE_MOVED, None if key else os.path.join(root, "moved"),
                resume_onto=None if key else (meshes["dp2tp2"], {}),
                trees=held)
            if held[0] is not None:
                out[f"moved{key}"]["state_gaps"] = _state_gaps(torch, *held)
            del held
    return out


def _one_card_resume(torch, cfg, dev, root: str, batch: int, seed: int,
                     zero1: bool = True) -> dict:
    """14a's (and 14d's) resume onto the card alone (``_measured_resume``
    without a mesh, the next step on the batch of ``seed``)."""
    from k8s_gpu_tpu_torch.train import TrainConfig

    return _measured_resume(
        torch, dev, cfg, TrainConfig(warmup_steps=1, zero1=zero1,
                                     ema_decay=STATE_EMA),
        None, None, root, seed + 2, _par_tokens(torch, seed, cfg, batch))


def run_state_path(torch, seed: int, layers: int, seq: int = STATE_SEQ,
                   device="cuda", parts=STATE_PARTS) -> dict:
    """Phase 14: a meshed trainer's checkpoints across meshes,
    ``save_attn`` on every mesh, and the CNN and LoRA model on the axes
    the reference trains them on; four gloo ranks on the one card
    (``device="cpu"`` with a short ``seq`` rehearses it on the CPU: the
    plain versions, no launch counts or memory)."""
    import dataclasses
    import functools
    import shutil

    import chip_smoke
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = spawn_local_cluster(
        functools.partial(chip_smoke._state_rank, seed, layers, seq, device,
                          STATE_DIR, parts),
        PAR_WORLD, timeout=STATE_TIMEOUT, device=device, backend="gloo")
    out = {"layers": layers, "seq": seq, "world": PAR_WORLD,
           "meshes": STATE_MESHES, "cluster_s": time.perf_counter() - t0}
    failures = []
    if "checkpoint" in parts:
        for key, cfg, tols, sub in (
                ("checkpoint", state_config(torch, layers, "v2", seq=seq),
                 (STATE_TOL, STATE_LAYOUT_TOL), "bf16"),
                ("checkpoint_f32", state_config(
                    torch, STATE_F32_LAYERS, "f32", seq=STATE_F32_SEQ),
                 (STATE_F32_TOL, STATE_F32_TOL), "f32")):
            out[key] = _hold_checkpoint(
                torch, seed, cfg, dev, [r[key] for r in ranks], tols,
                os.path.join(STATE_DIR, sub), f"14a {sub}", failures)
            print(json.dumps({f"state_{key}": out[key]}), flush=True)
    if "save_attn" in parts:
        out["save_attn"] = {}
        for name, (mesh, kind, batch) in SAVE_ATTN_RUNS.items():
            base = state_config(torch, layers, kind, seq=seq)
            held = {}
            for policy in ("full", "save_attn"):
                cfg = dataclasses.replace(base, remat_policy=policy)
                runs = [r[f"{name}_{policy}"] for r in ranks]
                if len({r["updated_loss"] for r in runs}) != 1:
                    failures.append(f"14b {name} {policy}: ranks disagree")
                for i, r in enumerate(runs):
                    want, pre = save_attn_launches(fa, cfg, kind,
                                                   r["stage"])
                    if cuda and (r["launches"] != want
                                 or r["prepass_launches"] != pre
                                 or r["plain_calls"]):
                        failures.append(
                            f"14b {name} {policy}: rank {i} launched "
                            f"{r['launches']}, {r['prepass_launches']} "
                            f"pre-passes, {r['plain_calls']} plain; "
                            f"expected {want}, {pre}, 0")
                held[policy] = {
                    "first_loss": runs[0]["first_loss"],
                    "updated_loss": runs[0]["updated_loss"],
                    "step_s": max(r["step_s"] for r in runs),
                    "peak_memory_gb_by_rank": [r["peak_memory_gb"]
                                               for r in runs],
                    "launches_by_rank": [
                        {k: v for k, v in r["launches"].items() if v}
                        for r in runs],
                    "prepasses_by_rank": [r["prepass_launches"]
                                          for r in runs]}
            gap = abs(held["save_attn"]["first_loss"]
                      - held["full"]["first_loss"])
            held["first_loss_gap"] = gap
            if not gap <= STATE_TOL:
                failures.append(f"14b {name}: step-1 loss gap {gap}")
            rel = [r[f"{name}_grad_rel_err"] for r in ranks]
            held["grad_rel_err_by_rank"] = rel
            if not max(rel) <= SAVE_ATTN_GRAD_TOL:
                failures.append(f"14b {name}: counted step's gradients "
                                f"{rel} from full remat's by leaf")
            # After one update: the ring's replay sums its blocks'
            # gradients in another order than autograd through the hops.
            upd = abs(held["save_attn"]["updated_loss"]
                      - held["full"]["updated_loss"])
            held["updated_loss_gap"] = upd
            if not upd <= TRAIN_TOL["bfloat16"]["loss"]:
                failures.append(f"14b {name}: updated loss gap {upd}")
            out["save_attn"][name] = held
    if "consumers" in parts:
        out["consumers"] = {}
        for name, (model, params, batch) in _consumer_models(
                torch, seed, layers, seq, dev).items():
            tr = _consumer_trainer(torch, model, params, dev)
            want = tr.step(*batch)
            del tr
            _free_if(torch, dev)
            got = [r["consumers"][name]["loss"] for r in ranks]
            gap = max(abs(g - want) for g in got)
            out["consumers"][name] = {
                "loss": got[0], "one_rank_loss": want, "gap": gap,
                "shapes_rank0": ranks[0]["consumers"][name]["shapes"]}
            if len(set(got)) != 1 or not gap <= TRAIN_TOL["bfloat16"]["loss"]:
                failures.append(f"14c {name}: losses {got} vs one rank's "
                                f"{want}")
    if "fsdp" in parts:
        out["fsdp"] = _hold_fsdp(torch, seed, layers, seq, dev, ranks,
                                 out.get("checkpoint"), failures)
        print(json.dumps({"state_fsdp": out["fsdp"]}), flush=True)
    if "moved" in parts:
        out["moved"] = _hold_moved(
            torch, state_config(torch, layers, "v2", seq=seq), dev, ranks,
            failures)
        print(json.dumps({"state_moved": out["moved"]}), flush=True)
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    out["failures"] = failures
    return out


def _saves(runs) -> dict:
    """What a shard-wise save's ranks measured (``_measured_save``): each
    rank's bytes written and device peak over the save, the step's
    bytes, the slowest rank's seconds, and the elements stored against
    the whole trees'."""
    first = runs[0]
    return {"bytes_written_by_rank": [r["bytes_written"] for r in runs],
            "bytes": first["bytes"], "files": first["files"],
            "save_s": max(r["save_s"] for r in runs),
            "save_gb_per_s": first["bytes"] / max(r["save_s"]
                                                  for r in runs) / 1e9,
            "save_peak_over_gb_by_rank": [r["save_peak_over_gb"]
                                          for r in runs],
            "stored_elements": first["stored_elements"],
            "whole_elements": first["whole_elements"]}


def _check_save(held: dict, what: str, failures: list) -> None:
    """A shard-wise save holds each block once (its blocks' elements are
    the whole trees'), the ranks' files add up to the step's bytes but
    the manifest, and no rank's device peak rose over the save by more
    than SAVE_PEAK_SLACK_GB."""
    if held["stored_elements"] != held["whole_elements"]:
        failures.append(f"{what}: the save stored {held['stored_elements']} "
                        f"elements of {held['whole_elements']}")
    if sum(held["bytes_written_by_rank"]) > held["bytes"]:
        failures.append(f"{what}: ranks wrote "
                        f"{held['bytes_written_by_rank']}, the step holds "
                        f"{held['bytes']}")
    peaks = [p for p in held["save_peak_over_gb_by_rank"] if p is not None]
    if peaks and max(peaks) > SAVE_PEAK_SLACK_GB:
        failures.append(f"{what}: device peak rose {peaks} GB over the save")


def _hold_checkpoint(torch, seed: int, cfg, dev, runs, tols, root: str,
                     what: str, failures: list) -> dict:
    """14a's checks over the ranks' runs; the checkpoint also resumes onto
    the card alone here."""
    first = runs[0]
    want = first["losses"][-1]
    one = _one_card_resume(torch, cfg, dev, root, STATE_BATCH, seed)
    held = {"losses": first["losses"], **_saves(runs),
            "rest_bytes": first["rest_bytes"],
            "restore_s_one_card": one["restore_s"],
            "resumed_loss_one_card": one["loss"],
            "gap_one_card": abs(one["loss"] - want),
            "tol_one_card": tols[1]}
    held["restore_gb_per_s_one_card"] = (first["bytes"] / one["restore_s"]
                                         / 1e9)
    _check_save(held, what, failures)
    if len({tuple(r["losses"]) for r in runs}) != 1:
        failures.append(f"{what}: ranks disagree")
    if not all(math.isfinite(v) for v in first["losses"]):
        failures.append(f"{what}: losses {first['losses']}")
    if one["step"] != STATE_STEPS or one["prints"] != first["saved_prints"]:
        failures.append(f"{what} one_card: the resumed state differs from "
                        "the saved one")
    if not held["gap_one_card"] <= tols[1]:
        failures.append(f"{what} one_card: resumed loss {one['loss']} vs "
                        f"{want}")
    for where in STATE_RESUMES:
        got = [r["resumes"][where] for r in runs]
        tol = tols[0] if where == "pp2tp2" else tols[1]
        loss = got[0]["loss"]
        held.update({f"restore_s_{where}": max(g["restore_s"] for g in got),
                     f"resumed_loss_{where}": loss,
                     f"gap_{where}": abs(loss - want), f"tol_{where}": tol})
        held[f"restore_gb_per_s_{where}"] = (
            first["bytes"] / held[f"restore_s_{where}"] / 1e9)
        if len({g["loss"] for g in got}) != 1:
            failures.append(f"{what} {where}: ranks disagree")
        if not all(g["state_equal"] and g["step"] == STATE_STEPS
                   for g in got):
            failures.append(f"{what} {where}: the resumed state differs "
                            "from the saved one")
        if not abs(loss - want) <= tol:
            failures.append(f"{what} {where}: resumed loss {loss} vs {want}")
    return held


def _hold_fsdp(torch, seed: int, layers: int, seq: int, dev, ranks,
               checkpoint, failures: list) -> dict:
    """14d's checks over the ranks' runs; the fsdp checkpoint resumes
    onto the card alone here."""
    from k8s_gpu_tpu_torch.ops import attention as fa

    cuda = dev.type == "cuda"
    cfg = state_config(torch, layers, "v2", seq=seq)
    want_launches, want_pre = save_attn_launches(fa, cfg, "v2")
    held = {}
    for key, tol in (("", STATE_TOL), ("_f32", STATE_F32_TOL)):
        runs = [r[f"fsdp{key}"] for r in ranks]
        base = [r[f"fsdp_default{key}"] for r in ranks]
        if len({tuple(r["losses"]) for r in runs}) != 1:
            failures.append(f"14d{key}: ranks disagree")
        gaps = [abs(a - b) for a, b in zip(runs[0]["losses"],
                                           base[0]["losses"])]
        held[f"losses{key}"] = runs[0]["losses"]
        held[f"default_losses{key}"] = base[0]["losses"]
        held[f"loss_gaps{key}"] = gaps
        held[f"tol{key}"] = tol
        if not all(math.isfinite(v) for v in runs[0]["losses"]) \
                or not max(gaps) <= tol:
            failures.append(f"14d{key}: losses {runs[0]['losses']} vs the "
                            f"default rules' {base[0]['losses']}")
        rest = [r["rest_bytes"] for r in runs]
        held[f"rest_bytes_by_rank{key}"] = rest
        held[f"default_rest_bytes_by_rank{key}"] = [b["rest_bytes"]
                                                    for b in base]
        # Every leaf of the transformer names "embed": fsdp halves all.
        if [2 * b for b in rest] != [b["rest_bytes"] for b in base]:
            failures.append(f"14d{key}: bytes at rest {rest}, not half the "
                            "default rules'")
        if key:
            continue
        held["rest_ratio"] = rest[0] / base[0]["rest_bytes"]
        if checkpoint is not None:
            held["zero1_rest_bytes"] = checkpoint["rest_bytes"]
            held["rest_ratio_to_zero1"] = rest[0] / checkpoint["rest_bytes"]
        held["embed_shape"] = runs[0]["embed_shape"]
        held["step_s"] = max(r["step_s"] for r in runs)
        held["default_step_s"] = max(b["step_s"] for b in base)
        held["peak_memory_gb_by_rank"] = [r["peak_memory_gb"] for r in runs]
        held["default_peak_memory_gb_by_rank"] = [b["peak_memory_gb"]
                                                  for b in base]
        held["launches_by_rank"] = [{k: v for k, v in r["launches"].items()
                                     if v} for r in runs]
        held["prepasses_by_rank"] = [r["prepass_launches"] for r in runs]
        for i, (r, b) in enumerate(zip(runs, base)):
            if cuda and (r["launches"] != want_launches
                         or r["launches"] != b["launches"]
                         or r["prepass_launches"] != want_pre
                         or r["plain_calls"] or b["plain_calls"]):
                failures.append(
                    f"14d: rank {i} launched {r['launches']}, "
                    f"{r['prepass_launches']} pre-passes, "
                    f"{r['plain_calls']} plain (default rules "
                    f"{b['launches']}); expected {want_launches}, "
                    f"{want_pre}, 0")
        refusals = [r["zero1_refusal"] for r in runs]
        held["zero1_refusal"] = refusals[0]
        if not all(m and "duplicate entries for `dp`" in m
                   for m in refusals):
            failures.append(f"14d: fsdp with ZeRO-1 not refused: {refusals}")
        held["save"] = _saves([r["save"] for r in runs])
        _check_save(held["save"], "14d", failures)
        one = _one_card_resume(torch, cfg, dev,
                               os.path.join(STATE_DIR, "fsdp"), STATE_BATCH,
                               seed, zero1=False)
        want = runs[0]["losses"][-1]
        loss = one["loss"]
        held.update(restore_s_one_card=one["restore_s"], next_loss=want,
                    resumed_loss_one_card=loss,
                    gap_one_card=abs(loss - want),
                    tol_one_card=STATE_LAYOUT_TOL)
        if one["step"] != STATE_STEPS \
                or one["prints"] != runs[0]["saved_prints"]:
            failures.append("14d: the state restored onto the card alone "
                            "differs from the saved one")
        if not abs(loss - want) <= STATE_LAYOUT_TOL:
            failures.append(f"14d: resumed loss {loss} vs {want}")
    return held


def _table_rest_bytes(leaves: dict, sizes: dict, kinds: int) -> int:
    """The bytes a rank holds at rest of ``kinds`` float32 copies of each
    leaf (parameters, moments, EMA) when its spec cuts each dimension
    into the product of its mesh axes' sizes: counted from the whole
    shapes and the specs alone."""
    total = 0
    for leaf in leaves.values():
        n = math.prod(leaf["shape"])
        for entry in leaf["spec"]:
            names = entry if isinstance(entry, list) else [entry]
            n //= math.prod(sizes.get(a, 1) for a in names if a)
        total += n
    return 4 * kinds * total


def _hold_moved(torch, cfg, dev, ranks, failures: list) -> dict:
    """14e's checks: the table that moves the MLP off tp against the
    default table on the same mesh."""
    from k8s_gpu_tpu_torch.ops import attention as fa

    cuda = dev.type == "cuda"
    want_launches, want_pre = save_attn_launches(fa, cfg, "v2")
    sizes = STATE_MESHES["dp2tp2"]
    held = {}
    for key, tol in STATE_MOVED_TOL.items():
        runs = [r[f"moved{key}"] for r in ranks]
        base = [r[f"fsdp_default{key}"] for r in ranks]
        gaps = [abs(a - b) for a, b in zip(runs[0]["losses"],
                                           base[0]["losses"])]
        held.update({f"losses{key}": runs[0]["losses"],
                     f"default_losses{key}": base[0]["losses"],
                     f"loss_gaps{key}": gaps, f"tol{key}": tol,
                     f"moved{key}": runs[0]["moved"]})
        if len({tuple(r["losses"]) for r in runs}) != 1:
            failures.append(f"14e{key}: ranks disagree")
        # The state after the counted step, gathered whole (rank 0's).
        state_gaps = runs[0]["state_gaps"]
        held[f"state_gaps{key}"] = state_gaps
        held["state_tol"] = STATE_MOVED_STATE_TOL
        if not all(g["rel_err"] <= STATE_MOVED_STATE_TOL
                   for g in state_gaps.values()):
            failures.append(f"14e{key}: parameters, moments or EMA "
                            f"{state_gaps} from the default table's")
        if not all(math.isfinite(v) for v in runs[0]["losses"]) \
                or not max(gaps) <= tol:
            failures.append(f"14e{key}: losses {runs[0]['losses']} vs the "
                            f"default table's {base[0]['losses']}")
        rest = [r["rest_bytes"] for r in runs]
        want_rest = _table_rest_bytes(runs[0]["leaves"], sizes, 4)
        held[f"rest_bytes_by_rank{key}"] = rest
        held[f"table_rest_bytes{key}"] = want_rest
        held[f"default_rest_bytes_by_rank{key}"] = [b["rest_bytes"]
                                                    for b in base]
        if rest != [want_rest] * len(rest) or not runs[0]["moved"]:
            failures.append(f"14e{key}: bytes at rest {rest}, the table "
                            f"says {want_rest}; moved {runs[0]['moved']}")
        if key:
            continue
        held["step_s"] = max(r["step_s"] for r in runs)
        held["default_step_s"] = max(b["step_s"] for b in base)
        held["peak_memory_gb_by_rank"] = [r["peak_memory_gb"] for r in runs]
        held["launches_by_rank"] = [{k: v for k, v in r["launches"].items()
                                     if v} for r in runs]
        for i, (r, b) in enumerate(zip(runs, base)):
            if cuda and (r["launches"] != want_launches
                         or r["launches"] != b["launches"]
                         or r["prepass_launches"] != want_pre
                         or r["plain_calls"]):
                failures.append(
                    f"14e: rank {i} launched {r['launches']}, "
                    f"{r['prepass_launches']} pre-passes, "
                    f"{r['plain_calls']} plain (default table "
                    f"{b['launches']}); expected {want_launches}, "
                    f"{want_pre}, 0")
        held["save"] = _saves([r["save"] for r in runs])
        _check_save(held["save"], "14e", failures)
        got = [r["resumed"] for r in runs]
        want = runs[0]["losses"][-1]
        held.update(restore_s_default=max(g["restore_s"] for g in got),
                    resumed_loss_default=got[0]["loss"],
                    gap_default=abs(got[0]["loss"] - want),
                    tol_default=STATE_TOL)
        if not all(g["state_equal"] and g["step"] == STATE_STEPS
                   for g in got):
            failures.append("14e: the state restored onto the default "
                            "table differs from the saved one")
        if len({g["loss"] for g in got}) != 1 \
                or not abs(got[0]["loss"] - want) <= STATE_TOL:
            failures.append(f"14e: resumed loss {got[0]['loss']} vs {want}")
    return held


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", metavar="PATH",
                    help="also write the detailed results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving main path and one extra "
                         "training step with torch.profiler (the serving "
                         "times then include the tracing cost)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from k8s_gpu_tpu_torch.ops import _build
    from k8s_gpu_tpu_torch.utils.compat import install_compile_telemetry
    from k8s_gpu_tpu_torch.utils.metrics import global_metrics

    gpu = gpu_line()
    print(gpu, flush=True)
    install_compile_telemetry()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, KERNEL_SOURCES))
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(KERNEL_SOURCES)} in {build_s:.1f} s", flush=True)
    hist = global_metrics.histogram("xla_compile_seconds")
    compiles = {"xla_compiles_total":
                global_metrics.counter("xla_compiles_total"),
                "xla_compile_seconds": hist.total if hist else 0.0,
                "build_s": build_s}
    print(json.dumps({"compile_telemetry": compiles}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = check_paged_attention(torch, args.seed)
    flash = check_flash_attention(torch, args.seed)
    flash_v2 = check_flash_v2(torch, args.seed)
    main_path = run_main_path(torch, args.seed, LAYERS, profile=args.profile)
    print(json.dumps({"main_path": main_path}), flush=True)
    _free(torch)
    dense = run_dense_path(torch, args.seed, LAYERS, profile=args.profile)
    print(json.dumps({"dense_path": dense}), flush=True)
    _free(torch)
    unshared = run_unshared_paged_path(torch, args.seed, LAYERS,
                                       profile=args.profile)
    print(json.dumps({"unshared_paged_path": unshared}), flush=True)
    _free(torch)
    fleet = run_fleet_path(torch, args.seed, LAYERS)
    print(json.dumps({"fleet_path": fleet}), flush=True)
    _free(torch)
    spec = run_spec_path(torch, args.seed, LAYERS, profile=args.profile)
    print(json.dumps({"spec_path": spec}), flush=True)
    _free(torch)
    lifecycle = run_lifecycle_path(torch, args.seed, LAYERS,
                                   profile=args.profile)
    _free(torch)
    outputs = check_outputs(torch, args.seed, LAYERS)
    print(json.dumps({"outputs": outputs}), flush=True)
    left_pad = check_left_pad_outputs(torch, args.seed, LAYERS)
    print(json.dumps({"left_pad_outputs": left_pad}), flush=True)
    _free(torch)
    train = run_train_path(torch, args.seed, LAYERS, TRAIN_BATCH, TRAIN_STEPS,
                           profile=args.profile)
    print(json.dumps({"train_path": train}), flush=True)
    _free(torch)
    train_v2 = run_train_path(torch, args.seed, LAYERS, TRAIN_BATCH,
                              TRAIN_STEPS, profile=args.profile, v2=True)
    print(json.dumps({"train_path_v2": train_v2}), flush=True)
    _free(torch)
    train_gqa_v1 = run_train_path(torch, args.seed, LAYERS, TRAIN_BATCH,
                                  TRAIN_STEPS, v2=True, knobs=False)
    print(json.dumps({"train_path_gqa_v1": train_gqa_v1}), flush=True)
    _free(torch)
    job = run_job_path(torch, args.seed, LAYERS, TRAIN_BATCH)
    print(json.dumps({"job_path": job}), flush=True)
    _free(torch)
    save_attn = run_save_attn_path(torch, args.seed, LAYERS, TRAIN_BATCH)
    print(json.dumps({"save_attn_path": save_attn}), flush=True)
    save_attn_v2 = run_save_attn_path(torch, args.seed, LAYERS, TRAIN_BATCH,
                                      v2=True)
    print(json.dumps({"save_attn_path_v2": save_attn_v2}), flush=True)
    registry = run_registry_path(torch)
    print(json.dumps({"registry_path": registry}), flush=True)
    _free(torch)
    moe_train = run_moe_train_path(torch, args.seed, LAYERS, TRAIN_BATCH,
                                   profile=args.profile)
    print(json.dumps({"moe_train_path": moe_train, "gpu": gpu}), flush=True)
    _free(torch)
    moe_serve = run_moe_serve_path(torch, args.seed, LAYERS,
                                   profile=args.profile)
    print(json.dumps({"moe_serve_path": moe_serve, "gpu": gpu}), flush=True)
    _free(torch)
    moe_identity = run_moe_identity(torch, args.seed)
    print(json.dumps({"moe_identity": moe_identity, "gpu": gpu}), flush=True)
    _free(torch)
    finagent = run_finagent_path(torch, args.seed, LAYERS)
    print(json.dumps({"finagent_path": finagent, "gpu": gpu}), flush=True)
    _free(torch)
    train_outputs = check_train_outputs(torch, args.seed, LAYERS)
    print(json.dumps({"train_outputs": train_outputs}), flush=True)
    train_v2_outputs = check_train_outputs(torch, args.seed, LAYERS, v2=True)
    print(json.dumps({"train_v2_outputs": train_v2_outputs}), flush=True)
    _free(torch)
    parallel = run_parallel_path(torch, args.seed, PAR_LAYERS)
    print(json.dumps({"parallel_path": parallel, "gpu": gpu}), flush=True)
    _free(torch)
    tensor_parallel = run_tensor_parallel_path(torch, args.seed, PAR_LAYERS)
    print(json.dumps({"tensor_parallel_path": tensor_parallel, "gpu": gpu}),
          flush=True)
    _free(torch)
    pipeline_path = run_pipeline_path(torch, args.seed, PP_LAYERS)
    print(json.dumps({"pipeline_path": pipeline_path, "gpu": gpu}),
          flush=True)
    _free(torch)
    mesh_serving = run_mesh_serving_path(torch, args.seed, SRV_LAYERS)
    print(json.dumps({"mesh_serving_path": mesh_serving, "gpu": gpu}),
          flush=True)
    if mesh_serving["failures"]:
        raise RuntimeError("phase 13: " + "; ".join(mesh_serving["failures"]))
    _free(torch)
    state = run_state_path(torch, args.seed, STATE_LAYERS)
    print(json.dumps({"state_path": state, "gpu": gpu}), flush=True)
    hist = global_metrics.histogram("xla_compile_seconds")
    compiles.update(
        xla_compiles_total_at_end=global_metrics.counter(
            "xla_compiles_total"),
        xla_compile_seconds_at_end=hist.total if hist else 0.0,
        burst_compiles=main_path["burst_compiles"])
    print(json.dumps({"compile_telemetry": compiles}), flush=True)
    if state["failures"]:
        raise RuntimeError("phase 14: " + "; ".join(state["failures"]))

    case = {r["case"]: r for r in kern}
    decode = case["decode_bf16"]
    spec_launches = {
        f"launches_spec_{name}": sum(r["launches"] for r in
                                     spec["paged"][name]["timed_runs"])
        for name in ("ngram", "neural")}
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "k8s_gpu_tpu_torch/csrc/paged_attention.cu",
        "replaces": "k8s_gpu_tpu/ops/paged_attention.py:102",
        "phase": "4 (paged serving); also 4c, 4d, 4e (verify windows), 4f "
                 "(adapter, constrained and handed-over rows), 9 (the "
                 "Fin-Agent-Suite's /chat and traced /generate), 13 "
                 "(serving on a mesh: a tp rank's 2 heads; 13f-13j the "
                 "neural and int8 drafts' verify windows, MoE, int8 "
                 "weights, moved and handed-over rows)",
        "launches": main_path["paged_attention_launches"],
        # Phase 4c's run: the unshared paged pool (left-padded rows).
        "launches_unshared_pool": unshared["paged_attention_launches"],
        # Phase 4d: B's request served from blocks moved from A.
        "launches_fleet": fleet["paged_attention_launches"],
        # Phase 4e: the three timed runs of the paged spec cell.
        **spec_launches,
        # Phase 4f: the multi-LoRA and constrained bursts (with their
        # bank-less yardsticks) and the disaggregated handovers.
        "launches_lifecycle": lifecycle_launches(lifecycle),
        # Phase 8b: the MoE flagship's paged burst; 8c: its float32
        # plain and n-gram runs (decode steps and verify windows).
        "launches_moe": moe_serve["paged"]["paged_attention_launches"],
        "launches_moe_float32": sum(
            moe_identity["runs"][name]["launches"]
            for name in ("kernel", "ngram")),
        # Phase 9b and 9c: the application's /chat posts and the traced
        # /generate requests.
        "launches_finagent": finagent["paged_attention_launches"],
        # Phase 13: each rank's launches over each meshed paged server's
        # life (the same on every rank), bf16 at 16 layers and float32
        # at 2.
        **{f"launches_mesh_serving_{key}_{part}": held["launches_per_rank"]
           for key in ("bf16", "f32")
           for part, held in mesh_serving[key].items()
           if "dense" not in part and part != "lora"},
        # Phase 13f: the verify windows at a tp 4 rank's 2 heads under
        # the neural draft (K 4, phase 3's tp_local_h2_verify_k4_bf16),
        # each rank's launches at the verify widths (the wrapper's count
        # by query width, held to one a layer and verify sub-round).
        **{f"verify_tp4_neural_{field}":
           case["tp_local_h2_verify_k4_bf16"][field]
           for field in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "design")},
        "verify_tp4_neural_launches": mesh_serving["bf16"]["tp4_neural"].get(
            "verify_launches_per_rank"),
        "max_abs_err": max(r["max_abs_err"] for r in kern),
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "design": decode["design"],
        # Splits: the most a row tile took in this run; grid_splits: the
        # blocks the grid gave each tile.
        "splits": decode["splits"],
        "grid_splits": decode["grid_splits"],
        # The admission windows, on the tensor cores, and the verify
        # windows of speculative serving.
        **{f"{key}_{field}": case[name][field]
           for key, name in (("window", "window_bf16"),
                             ("admit_cold", "admit_cold_bf16"),
                             ("left_pad", "left_pad_bf16"),
                             *((f"verify_k{k}", f"spec_verify_k{k}_bf16")
                               for k in SPEC_KS),
                             ("verify_gqa_k4", "spec_verify_gqa_k4_bf16"))
           for field in ("ms", "bound_ms", "library_ms", "design",
                         "splits", "grid_splits")},
        # Phase 13's calls at a tp rank's heads (2 at tp 4, 4 at tp 2).
        **{f"{name}_{field}": case[name][field]
           for name in case if name.startswith("tp_local_h")
           for field in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "design", "splits", "grid_splits",
                         "max_abs_err")},
    }]}
    # Phase 4e's distillation shapes, timed in phase 3b: the draft's
    # float32 training and the target's bf16 forward; phase 10's ring
    # hops, timed in phase 3b and 3c.
    distill_cases = ("distill_f32", "distill_bf16")
    for rows, top, extra, lines, source, run, sa, phase in (
            (flash, "flagship_bf16", distill_cases + (
                "ring_hop_bf16", "tp_local_bf16", "pp_microbatch_bf16"),
             FLASH_KERNELS, "flash_attention", train, save_attn,
             "6 (training); also 4e (draft distillation), 4f (LoRA "
             "fine-tune), 6c (the training job, save_attn), 8a (MoE "
             "training), 11 (the tp-local heads: Ulysses over sp 2 x tp "
             "2, MoE over ep 2 x tp 2), 12 (the pipeline's stages: GPipe "
             "over dp 2 x pp 2, interleaved and classic 1F1B over pp 4), "
             "13e (the LoRA fine-tune over dp 2 x tp 2, float32), 14b "
             "(save_attn and full on the tp-local heads: Ulysses over sp "
             "2 x tp 2, MoE over ep 2 x tp 2), 14c (the LoRA model over "
             "dp 2 x pp 2)"),
            (flash_v2, "train_gqa_bf16", ("ring_hop_gqa_bf16",
                                          "tp_local_gqa_bf16"),
             FLASH_V2_KERNELS, "flash_attention_v2", train_v2, save_attn_v2,
             "6b (v2 training); also 6c (save_attn), 10 (ring and Ulysses "
             "over dp 2 x sp 2, GQA), 11 (the tp-local heads: dp 2 x tp 2, "
             "the ring over sp 2 x tp 2), 12 (1F1B over pp 2 x tp 2), 14a "
             "(dp 2 x tp 2 and its resumes onto pp 2 x tp 2 and the card "
             "alone), 14b (save_attn and full: dp 2 x tp 2, the ring's "
             "replay over sp 2 x tp 2, 1F1B over pp 2 x tp 2), 14d (fsdp "
             "over dp 2 x tp 2)")):
        by_case = {r["case"]: r for r in rows}
        timed = by_case[top]
        for name, line in lines.items():
            distill = spec["distill"]["flash_launches"].get(name, 0)
            lora = lifecycle["lora_train"]["launches"].get(name, 0)
            kernels["kernels"].append({
                "name": name,
                "route": "cuda",
                "source": f"k8s_gpu_tpu_torch/csrc/{source}.cu",
                "replaces": f"k8s_gpu_tpu/ops/attention.py:{line}",
                "phase": phase,
                "launches": run["launches"][name],
                # Phase 6c: the job's 4 steps (v1 only) and save_attn's 2
                # timed steps.
                **({"launches_job": job["launches"][name]}
                   if job["launches"].get(name) else {}),
                "launches_save_attn": sa["save_attn"]["launches"][name],
                **({"launches_distill": distill} if distill else {}),
                **({"launches_lora": lora} if lora else {}),
                # Phase 8a: the MoE flagship's timed steps, full and
                # save_attn.
                **({"launches_moe": moe_train["full"]["launches"][name],
                    "launches_moe_save_attn":
                        moe_train["save_attn"]["launches"][name]}
                   if name in FLASH_KERNELS else {}),
                # Phase 10c: the four ranks' timed steps, ring and Ulysses.
                **({f"launches_parallel_{sp}":
                    parallel[sp]["launches"][name]
                    for sp in ("ring", "ulysses")}
                   if name in FLASH_V2_KERNELS else {}),
                # Phase 11: the four ranks' timed steps on each mesh whose
                # path runs this kernel.
                **{f"launches_tensor_parallel_{key}":
                   tensor_parallel[key]["launches"][name]
                   for key in ("dense", "ring", "ulysses", "moe")
                   if tensor_parallel[key]["launches"][name]},
                # Phase 13e: the four ranks' LoRA steps over dp 2 x tp 2.
                **({"launches_mesh_serving_lora":
                    mesh_serving["f32"]["lora"]["launches"][name]}
                   if name in FLASH_KERNELS else {}),
                # Phase 12: the four ranks' timed steps of each schedule
                # whose stages run this kernel.
                **{f"launches_pipeline_{key}":
                   pipeline_path[key]["launches"][name]
                   for key in PP_RUNS
                   if pipeline_path[key]["launches"][name]},
                # Phase 14b: the four ranks' counted step on each mesh
                # whose path runs this kernel, under each remat policy.
                **{f"launches_state_{key}_{policy}": n
                   for key, held in state["save_attn"].items()
                   for policy in ("full", "save_attn")
                   for n in [sum(r.get(name, 0) for r in
                                 held[policy]["launches_by_rank"])] if n},
                # Phase 14d: the four ranks' counted fsdp step; 14e: their
                # counted step under the moved table.
                **{f"launches_state_{key}": n for key in ("fsdp", "moved")
                   for n in [sum(r.get(name, 0) for r in
                                 state[key]["launches_by_rank"])] if n},
                "max_abs_err": max(r["kernels"][name]["max_abs_err"]
                                   for r in rows),
                **{key: timed["kernels"][name][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "tflops", "design")},
                **{f"{case}_{field}": by_case[case]["kernels"][name][field]
                   for case in extra
                   for field in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "design")},
            })
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"gpu": gpu, "build_s": build_s,
                       "compile_telemetry": compiles, "kernel_cases": kern,
                       "flash_cases": flash, "flash_v2_cases": flash_v2,
                       "main_path": main_path, "dense_path": dense,
                       "unshared_paged_path": unshared,
                       "fleet_path": fleet, "spec_path": spec,
                       "lifecycle_path": lifecycle,
                       "outputs": outputs, "left_pad_outputs": left_pad,
                       "train_path": train, "train_path_v2": train_v2,
                       "train_path_gqa_v1": train_gqa_v1,
                       "train_outputs": train_outputs,
                       "train_v2_outputs": train_v2_outputs,
                       "job_path": job, "save_attn_path": save_attn,
                       "save_attn_path_v2": save_attn_v2,
                       "registry_path": registry,
                       "moe_train_path": moe_train,
                       "moe_serve_path": moe_serve,
                       "moe_identity": moe_identity,
                       "finagent_path": finagent,
                       "parallel_path": parallel,
                       "tensor_parallel_path": tensor_parallel,
                       "pipeline_path": pipeline_path,
                       "mesh_serving_path": mesh_serving,
                       "state_path": state,
                       "device": device,
                       **kernels}, fh, indent=1)
    print(gpu, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
