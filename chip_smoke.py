#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
checks it.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (``nvidia-smi``);
  2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels: each kernel at the main path's shapes against its plain
     PyTorch version on the same inputs (bit-exact for the bit kernels, QSGD
     quantization and threshold masking, edge inputs included;
     ``max|kernel - plain| <= 1e-5 * max(1, max|plain|)`` for the fp32
     products, which differ only in summation order), with the median,
     fastest and slowest of 25 launches, each after a 256 MB read that
     leaves the L2 clean, for the kernel, its plain version and the
     ``torch.matmul`` yardstick (TF32 off; the port never calls it), and
     the card's lower bound.  The PowerSGD kernels also run on ragged,
     misaligned and transposed inputs at ranks 1, 3, 4 and 16, twice each
     (the same bits required), encode also on two streams at once (the
     bits it gives alone required), and are timed once more after a write
     flush and warm (the ``[timer]`` line).  ``popcount_votes`` is timed at
     p = 1 and 4 at both bucket shapes and p = 16 at the full one, and
     checked bit for bit at p from 1 to 512 and n from 1 to 1,000,003 on
     random, all-ones, all-zeros and pad-bits-set words, each launched
     twice (the same bits required).  The SM and memory clocks and
     the temperature are printed before and after the phase;
  4. experiments: the paper's 216-setup matrix and the 36-setup adaptive
     matrix through ``Runner(AnalyticBackend())``: 15/216 wins, all
     ``bert-base/powersgd-*`` on ``allreduce``, 0 errors, adaptive 9/36
     wins and 36/36 ties or better, every ``headline_verdicts`` row
     passing (the JAX package's numbers); then one live cell per scheme
     (PowerSGD, SignSGD, QSGD, ``ef:qsgd``, TernGrad, RandomK, MSTop-K)
     through ``Runner(MeasuredBackend(device="cuda"))`` at the full ZeRO-1
     bucket (13,107,200 elements): encode, decode and aggregate times, each
     kernel's launches equal to its count per call times the backend's
     calls, and the wire bytes, rounds and ratio that
     ``CompressionSpec.for_compressor`` derives;
  5. reference: on a small input, every compressor's aggregation on the
     card (kernels) against the same code on the CPU (plain versions),
     with the CPU's draws moved to the card through each scheme's draw
     function; one QSGD bucket aggregated on the card with PyTorch's
     sync debug mode set to error (no host-device synchronisation); and
     the reduced model's ZeRO-1 step (``none``, PowerSGD, SignSGD,
     ``reduce_to_owner_broadcast``, ``accum=2``) on the card against the
     CPU from the same start (``zero1_reference``); and the reduced
     model's overlapped ZeRO-1 PowerSGD step on the card against the CPU,
     ``serial`` against ``overlap`` bit for bit on the card, and one
     overlapped step's flushes under the sync debug mode "error"
     (``overlap_reference``); the reduced ``qwen2-moe-a2.7b``'s ZeRO-1
     PowerSGD step on the card against the CPU and its overlapped step
     ``serial`` against ``overlap`` bit for bit (``moe_reference``); one
     full-width MoE block's forward and backward under the sync debug
     mode "error" (``moe_block_syncs``); the chunked SSD against the
     sequential oracle on the card at ``zamba2-2.7b``'s head shapes, and
     one full-width Mamba2 block's forward and gradients on the card
     against the CPU in fp32 (``hybrid_reference``); one full-width zamba2
     group (the shared block with its LoRA, then 6 Mamba2 blocks) forward
     and backward with nested remat under the sync debug mode "error"
     (``hybrid_block_syncs``); the chunked mLSTM against the sequential
     oracle on the card at ``xlstm-350m``'s head shapes, one full-width
     mLSTM and one sLSTM block's forward and gradients on the card
     against the CPU in fp32, and one mLSTM block's forward and backward
     at batch 4 x 512 held under 2 GiB of added memory
     (``ssm_reference``); one full-width xLSTM group (7 mLSTM blocks and
     the sLSTM block) forward and backward with nested remat under the
     sync debug mode "error" (``ssm_block_syncs``); one full-width
     encoder block and one decoder block over a full-width memory,
     forward and gradients (the memory's included) on the card against
     the CPU in fp32 (``audio_reference``); one full-width decoder block
     forward and backward with remat under the sync debug mode "error"
     (``audio_block_syncs``); one full-width qwen2-vl block rotating by
     M-RoPE over three distinct position streams, forward and gradients
     on the card against the CPU in fp32, the card's pass under the
     sync debug mode "error" (``vlm_reference``);
  6. train: full-width ``tinyllama-1.1b`` (22 layers, random weights from
     seed 0) on a one-rank NCCL group, the aggregator pointed at the
     ``data`` axis as the tests do, batch 4 x 512 tokens.  The classic
     step (``zero1=False``, fp32 parameters, 168 buckets): 3 PowerSGD
     steps, 2 SignSGD steps, 3 QSGD steps (8 bits, error feedback on),
     then one step each of TernGrad, RandomK, MSTop-K and ``ef:qsgd``.
     The arch as configured (ZeRO-1, bf16 working parameters, one fp32
     master shard, 84 buckets): 3 steps uncompressed, 3 PowerSGD, 2
     SignSGD, 2 QSGD, one step of ``reduce_to_owner_broadcast`` and one
     of ``accum=2``.  Every loss and grad norm must be finite and each
     kernel's launch count must equal its count per step times the steps
     (``threshold_mask`` is on no path, as in the JAX package: 0).  Each
     run prints the peak of ``torch.cuda.max_memory_allocated`` per step;
     the runs named in ``PROFILED`` (here only the overlapped ZeRO-1 PowerSGD
     run below) then take one more step under ``torch.profiler``, kept out of
     the step records and launch counts; its device time is printed by layer,
     with the share of the last unprofiled step's wall time in which no kernel
     ran, and every compression kernel by name (launches, ms, us per launch).
     Then the overlapped step (``train/overlap.py``,
     ``overlap=True``: 46 leaf-aligned bf16 buckets flushed between
     backward stages on a side stream): ZeRO-1 3 steps uncompressed, 3
     PowerSGD, 3 PowerSGD ``serial``, 2 SignSGD and 2 QSGD (both run
     ``serial``: ``gather_all``), one ``reduce_to_owner_broadcast`` (runs
     ``raw``), one ``accum=2``; and 2 PowerSGD steps of the classic
     ``zero1=False`` step (90 fp32 buckets).  Each also checks the
     host-side flush order of every step (each bucket after the stage
     that completes it under ``overlap``, all after the last stage under
     ``serial``), prints, from its profiled step (ZeRO-1 PowerSGD under
     ``overlap``), the device time of each CUDA stream and
     how much of it ran while the compute stream was busy, and takes one
     more step with the sync debug mode set to warn
     and prints where the host waited for the card (both reported, not
     checked).  Then the MoE slice: ``qwen2-moe-a2.7b`` at full width (60
     routed experts top-4 of d_ff 1408, 4 shared behind a sigmoid gate,
     vocab 151,936) cut to 2 of 24 blocks (1,763,440,640 parameters), on
     ``dp_mode="ddp"``: the classic fp32 step 2 steps uncompressed and 2
     PowerSGD (270 buckets); ZeRO-1 (bf16, the fp32 router and shared
     gate riding the bf16 buckets; 135 buckets) 2 PowerSGD, 1 SignSGD,
     1 QSGD; the overlapped ZeRO-1 step (12 leaf-aligned buckets, up to
     322,701,312 elements) 2 PowerSGD under ``overlap`` and 2 under
     ``serial``, whose final states and metrics must agree bit for bit;
     the same checks as above, with finite ``moe_aux`` (no run profiled
     since the TP slice; in any breakdown the MoE routing, dispatch and
     combine are a layer of their own).  Serial == overlap is checked
     on fingerprints taken on the card (``pod_worker.fingerprint``: two
     wrapping int64 sums of each state tensor's bit patterns, the second
     of a 64-bit hash of each pattern with its position), not on a host
     copy of the state.  Then the hybrid slice
     (``family_phase("hybrid", ...)``): ``zamba2-2.7b`` at full width cut
     to ``FAMILY_LAYERS["hybrid"]`` = 24 of 54 layers (4 of its 9 groups
     of a shared block and 6 Mamba2 blocks; d_model
     2560, d_inner 5120, 80 SSD heads of 64, state 64, chunk 256, vocab
     32,000; 2,440,081,568 parameters at full depth) on its own plan (DDP,
     ZeRO-1, ``remat="full"``): ZeRO-1 2 PowerSGD steps, 1
     SignSGD, 1 QSGD; the overlapped ZeRO-1 step (leaf-aligned
     buckets) 2 PowerSGD under ``overlap`` and 2 under ``serial``, which
     must agree bit for bit; the classic fp32 step 1 step uncompressed;
     the same checks as above (no run profiled: the breakdown of one
     zamba2 step costs 40-50 s of host time).  Then
     the ssm slice (``family_phase("ssm", ...)``): ``xlstm-350m`` at full
     width cut to ``FAMILY_LAYERS["ssm"]`` = 16 of 24 layers
     (2 of its 3 groups of 7 mLSTM blocks and 1 sLSTM block, d_model
     1024, 4 heads, vocab 50,304) on its own plan (DDP,
     ZeRO-1, ``remat="full"``): ZeRO-1 2 PowerSGD steps, 1 SignSGD and
     1 QSGD;
     the overlapped ZeRO-1 step 2 PowerSGD under ``overlap`` and 2 under
     ``serial``, which must agree bit for bit; the classic fp32 step 1
     step uncompressed; the same checks, no run profiled (a step is some
     10^5 kernels).  Then the audio slice (``family_phase("audio",
     ...)``): ``seamless-m4t-medium`` at full width and depth (12 encoder
     and 12 decoder blocks, d_model 1024, 16 heads, d_ff 4096, two
     untied vocabulary tables of 256,206; 877,094,912 parameters) on its
     own plan (DDP, ZeRO-1, ``remat="full"``), each batch with a seeded
     fp32 ``enc_embeds`` (``launch.inputs.with_frontend_inputs``):
     ZeRO-1 (67 bf16 buckets) 2 PowerSGD steps, 1 SignSGD and 1 QSGD; the
     overlapped ZeRO-1 step (24 leaf-aligned buckets, the decoder's stages
     first, then the encoder's) 2 PowerSGD under ``overlap`` and 2 under
     ``serial``, which must agree bit for bit; the classic fp32 step 1 step
     uncompressed; the same checks (no run profiled since the vlm slice; the
     cross-attention, the GELU MLPs and the loss head are layers of their own
     in any breakdown).  Then the vlm slice
     (``family_phase("vlm", vlm_arch(), ...)``): ``qwen2-vl-7b`` at full
     width (d_model 3584, 28
     heads and 4 KV heads of 128, d_ff 18944, two untied vocabulary
     tables of 152,064) cut to ``VLM_LAYERS`` = 4 of 28 blocks
     (2,022,211,072 parameters), on ``dp_mode="ddp"`` with ZeRO-1 (its
     own plan is FSDP, run in phase 10), each batch with seeded fp32
     ``embeds`` and M-RoPE positions (an image of 64 patches on an 8 x 8
     grid, then text): the same runs and checks as the audio slice, no
     run profiled.  Then ``ssm_profiles``: one mLSTM block and
     the sLSTM scan over 64 tokens profiled, forward and forward plus
     backward, and scaled to one step.  Then the
     adaptive controller: ``resolve_plan`` for the full-size arch at
     n_dev = 2, batch 4 x 512, on the paper's V100 preset (fatal unless
     PowerSGD on overlapped ZeRO-1, the JAX package's decision), 3 steps
     of that plan through the same checks
     (encode 2 and decode 1 launch per bucket), and a ``BucketController``
     over its 46 buckets fed the measured step times (syncSGD from
     ``zero1 overlap none``, PowerSGD from this run): whether the
     feedback flips buckets to syncSGD is printed, not checked;
  7. checkpoint: the arch as configured (ZeRO-1, bf16 parameters, the
     classic step, PowerSGD on the data axis) at full width cut to
     ``CKPT_LAYERS`` = 6 of 22 layers (a 6 GB checkpoint) in a
     temporary directory: 3 uninterrupted steps (A); a ``Trainer`` whose
     data iterator sends SIGTERM to its own process at the second batch
     and must save step 2 and return (B); a fresh ``Trainer`` that
     restores step 2, seeks the data cursor and takes step 3 (C).  Fatal
     unless C's loss and state equal A's bit for bit (on-card
     fingerprints of every state tensor, ``state_prints``); prints
     the bytes, the save and restore seconds and the peak memory;
  8. schedules: ``overlap_bench`` at full width as one ``kind="train"``
     cell through ``MeasuredBackend`` (a process of its own), ZeRO-1
     uncompressed with the aggregator on the data axis, ``overlap``,
     ``serial`` and ``unfused`` round robin, 1 warm-up and 3 reps: the
     fastest step of each and the peak memory; then an adaptive
     ``kind="train"`` cell at one worker, fatal unless the controller
     keeps syncSGD (``adaptive_choice``);
  9. pod: ``kind="train"`` cells through ``MultiProcessBackend``, one
     ``train/pod_worker.py`` process per rank, every collective gloo
     (NCCL refuses two ranks on one card), ``tinyllama-1.1b`` at full
     width cut to 4 blocks, ZeRO-1, 25 MB buckets, batch 8 x 512: four
     cells of pod 2 x data 2 (uncompressed under ``hierarchical:data`` and
     ``allreduce``; PowerSGD over ``pod`` after a raw mean over ``data``;
     SignSGD over both axes, p = 4) and ``pod-ring-p2`` (pod 2 x data 1,
     uncompressed), ``serial`` and ``overlap`` round robin, 1 warm-up and
     1 rep (2 reps until the hybrid phase needed the time), then the
     one-rank compute offset.  Each must give finite
     losses, the same parameter bits on every rank, ``serial`` ==
     ``overlap`` bit for bit, ``hierarchical`` within fp32 tolerance of
     ``allreduce`` on one gradient bucket, the kernels' launch counts per
     compressed bucket and the backends the topology calls for; each
     worker's JSON record is printed.  Then the α–β fit
     (``calibrate_from_results``, from the H100 preset) over the three
     uncompressed cells and each cell's model-vs-measured error, printed
     and not checked (both tiers are gloo over loopback on one card).
     Then local SGD on two ranks (``launch/train.py --mesh pod
     --sync-every 2``): the parameters must agree across pods after steps
     2 and 4.  The ranks share the card's SMs, so every pod time is of
     time-sliced compute;
 10. fsdp: ``qwen2-vl-7b`` as configured (``dp_mode="fsdp"``, AdamW,
     ``remat="full"``) at full width cut to ``FSDP_LAYERS`` = 1 block
     (1,323,051,520 parameters), four ``train/pod_worker.py`` ranks on the
     card as pod 2 x data 2 (every collective gloo; the three runs as
     ``--variant``s of one torchrun group), batch 4 x 512 (one row a
     rank; two put the card past 75 GiB): HSDP
     (the parameters sharded over ``data``) with PowerSGD over ``pod`` on
     the 101 fp32 shard buckets, 2 steps (encode 2 and decode 1 launch a
     bucket and step); ZeRO-3 (``fsdp_shard_pods``) uncompressed, 1 step;
     HSDP with ``gather_quant="int8"``, 1 step, whose first loss must sit
     within 1e-2 relative of the plain gather's on the same batch.  Each
     must give finite losses, the configured axes, the same shard bits on
     the pod replicas, every gathered parameter the same on every rank
     (and, uncompressed, every unsharded leaf); each rank's peak, the
     card's memory in use and the step times are printed;
 11. tp: the ``model`` axis.  Four ``train/pod_worker.py`` ranks on the
     card as data 2 x model 2 (``--tp 2``; every collective gloo), the
     cells of ``TP_RUNS`` as ``--variant``s of one torchrun group, the
     global batch 4 x 512 of step 0 (seed 0): ``tinyllama-1.1b`` at full
     width and depth on its plan (ZeRO-1, bf16 parameters, SP on),
     PowerSGD rank 4 over ``data`` on each model rank's 42 shard buckets,
     the classic step, and the overlapped one cut to ``TP_CKPT_LAYERS`` =
     4 layers with its serial schedule run after it from the same seed
     (first loss against the 4-layer one-rank forward); ``qwen2-moe-a2.7b``
     at full width cut to ``TP_MOE_LAYERS`` = 1 block, DDP with ZeRO-1,
     30 of the 60 experts on each model rank, PowerSGD;
     ``tinyllama-1.1b`` at full width cut to ``TP_FSDP_LAYERS`` = 4
     layers with FSDP over ``data`` and TP over ``model``, uncompressed;
     ``seamless-m4t-medium`` at full width and depth on its plan (ZeRO-1,
     ``remat="full"``), the overlapped step with PowerSGD over ``data``
     on each model rank's shard buckets and its serial schedule after
     it, the frames of the global batch drawn from seed 0 as the train
     phase draws them (``launch.inputs.with_frontend_inputs``);
     ``qwen2-vl-7b`` at full width cut to ``FSDP_LAYERS`` = 1 block on
     its plan (FSDP over ``data``, TP over ``model``), uncompressed, with
     seeded fp32 ``embeds`` and M-RoPE positions; ``zamba2-2.7b`` at full
     width cut to ``TP_HYBRID_LAYERS`` = 12 layers (2 of 9 groups) on its
     plan (ZeRO-1, ``remat="full"``), the overlapped step with PowerSGD
     over ``data`` on each model rank's shard buckets (40 of the 80 SSD
     heads a rank; the shared block's gradient summed over the two
     groups and their LoRAs) and its serial schedule after it;
     ``xlstm-350m`` at full width cut to ``TP_SSM_LAYERS`` = 8 layers (1
     of 3 groups: 7 mLSTM blocks, 2 of 4 heads a rank, and the
     replicated sLSTM block) on its plan (ZeRO-1), uncompressed.  Each
     must give finite losses, the configured axes, a first loss within
     its limit (``TP_RTOL``, ``TP_MOE_RTOL``, ``TP_HYBRID_RTOL``) of the
     first loss of the one-rank ``tp = 1`` run of the train phase on the
     same seed and batch (a cell cut in depth: of a one-rank forward
     pass at its depth, ``first_loss``; the FSDP x TP cells and the xLSTM
     cell also their second loss within ``TP_STEP_RTOL`` of the same
     plan's second step on one rank, ``two_step_losses``), the same bits
     on the ranks with the same model index (gathered over ``data`` under
     FSDP), the leaves replicated over ``model`` the same bits on every
     rank, the PowerSGD launches per bucket and step, the card under 75
     GiB in use, and serial == overlap; each rank's peak and the step
     times are printed.  Two cells resume from a checkpoint (the worker's
     ``ckpt=true``): the FSDP x TP cell and ``tinyllama-1.1b`` at full
     width cut to ``TP_CKPT_LAYERS`` = 4 layers with classic ZeRO-1 and
     PowerSGD (first loss within ``TP_RTOL`` of a one-rank forward at
     that depth); each saves step 1 (its FSDP and TP leaves written
     slice by slice into the JAX package's global layout, the ZeRO-1 shards and the
     PowerSGD ``q``/``err`` rows stacked over the ranks), and a fresh
     setup restores it and takes step 2, whose loss and every rank's
     on-card state fingerprints must be the uninterrupted run's
     (``resume_identical``); the bytes, the save and restore seconds and
     the host peaks are printed.  Then this process restores the FSDP x
     TP cell's file on one rank at ``tp = 1`` with no FSDP
     (``tp_elastic``): its parameters must be the cell's gathered ones
     bit for bit, its fp32 forward on the cell's batch the cell's fp32
     forward of the saved state within ``TP_RTOL``, and its bf16 forward
     the cell's second loss within ``TP_ELASTIC_BF16_RTOL``;
 12. serve: prefill and one-token decode with a KV cache
     (``serving/``), weights from ``serve_params`` (seed 0), no
     compression kernel launched.  On one rank, bf16: ``tinyllama-1.1b``
     at full width and depth and ``qwen2-moe-a2.7b`` at full width
     (``SERVE_MOE_LAYERS``) through ``Engine.generate`` (4 requests of
     32, 100, 128 and 128 tokens, 16 new, cache 256), twice, the same
     greedy tokens required; ``qwen2-vl-7b`` (``SERVE_VLM_LAYERS``)
     through ``Model.prefill`` and ``Model.decode`` with seeded
     ``embeds`` and M-RoPE positions, 8 steps; each with prefill ms,
     decode ms a token, tokens/s and the peak printed, one
     ``Model.decode`` under the sync debug mode "error" and one more
     under the profiler (its kernels and device ms); then, on an fp32
     copy of each from the same seed (the MoE at its no-drop capacity),
     one decode step against a fresh prefill over the same tokens within
     ``SERVE_CONSIST_RTOL``.  These run alone on the card.  Then one
     torchrun group of four ranks on the card as data 2 x model 2 (this
     script's ``--serve-worker``, every collective gloo) starts while
     this process runs the one-rank runs of ``SERVE_GROUP``:
     ``tinyllama-1.1b`` TP at batch 4; at batch 1 with the cache
     context-parallel over ``data`` (a prompt of 600 in a cache of
     1024); ``qwen3-32b`` cut to 2 of 64 layers with ``serve_fsdp``;
     ``arctic-480b`` cut to 1 of 35 layers in the 2-D MoE layout
     (``serve_moe_ep_data``; no-drop capacity, a prompt of 64) in fp32
     and in bf16; prefill and 8 decode steps fed the one-rank run's
     greedy tokens, each step's logits within ``SERVE_GROUP_RTOL`` (by
     dtype) of the one-rank run's (of an MoE cell, on the rows whose
     token picked the one-rank run's experts, at most
     ``SERVE_FLIP_SHARE`` of them flipped: none in fp32), the same
     greedy tokens on
     every rank, the layout the cell names, the card under
     ``TP_CARD_GIB``.  ``python3
     chip_smoke.py --serve-probe`` measures the gaps that set both
     limits: clean in bf16 and fp32, and with faults planted
     (``serve_fault``).

The kernels are timed at the overlapped ZeRO-1 step's block and tail
buckets (the block bucket is the headline case of each record), the
classic ZeRO-1 step's and the classic fp32 step's, the MoE slice's
overlapped ZeRO-1 block and tail buckets (185,602,048 and 322,701,312
elements), the hybrid slice's (83,931,552 and 81,920,000), the ssm
slice's (26,275,896 and 63,056,896), the audio slice's (16,781,312
and 271,794,176), the vlm slice's (67,902,464 and 545,000,960), the
HSDP shard buckets (6,553,600 and the last, 6,171,136) and the TP
slice's shard buckets that no earlier shape has (``tp_layouts``: the
classic ZeRO-1 step's last, the overlapped step's largest block and
tail, the MoE slice's last, the audio and hybrid cells' overlapped
largest block and tail, the resume cell's last); the ``kernels``
line counts each kernel's launches in
the overlapped ZeRO-1 run that drives it, in the live cells
(``experiment_launches``), in the adaptive run (``adaptive_launches``),
in each MoE run (``moe_launches``), in each hybrid run
(``hybrid_launches``), in each ssm run (``ssm_launches``), in each audio
run (``audio_launches``), in each vlm run (``vlm_launches``), per pod
step, in each FSDP run's rank 0 (``fsdp_launches``) and in each TP
run's rank 0 (``tp_launches``).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a GPU the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the full-width hybrid steps free and take again a 9 GiB ZeRO-1 shard
# among others; without expandable segments the third such step of a
# process can find its 15 GiB of cached free memory too fragmented for it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, outside the tensor cores
REPS = 25
SPIN_CYCLES = 200_000            # about 0.1 ms at the H100's 1.98 GHz
FP32_RTOL = 1e-5
#: QSGD's norm and TernGrad's max|g| are reductions taken in another order
#: on the card than on the CPU; where they differ in the last bit a level
#: may move by one step on at most this share of the elements (and one).
LEVEL_SHARE = 1e-4
#: every kernel, by its launch-count name in ``build.LAUNCHES``
KERNELS = ("powersgd_encode", "powersgd_decode", "pack_signs",
           "popcount_votes", "qsgd_quantize", "threshold_mask")
#: the full-width runs that take one more step under the profiler: the
#: overlapped ZeRO-1 PowerSGD step, the paper's optimized baseline, whose
#: side stream the breakdown measures (``stream_overlap``); an overlap run
#: and the serial run compared with it (``keep``) take the same steps, so
#: both or neither are here.  No check reads a breakdown, and one costs
#: 2-18 s of host time (40-50 s for a zamba2 step, minutes for an xLSTM
#: step of some 10^5 kernels).  The TP slice took the room of the classic
#: ZeRO-1 PowerSGD run's and the MoE overlap/serial pair's (~19 s; their
#: breakdowns are in PERF.md §5)
PROFILED = ("zero1 overlap powersgd",)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, evict) -> dict:
    """Device time of ``fn`` over REPS launches, each after ``evict()``:
    the median, the fastest and the slowest (ms)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        evict()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"ms": statistics.median(times), "min": min(times),
            "max": max(times)}


def evictors(flush) -> dict:
    """Ways to empty the 50 MB L2 before a timed launch.  ``read`` sums a
    buffer five times the L2's size, so the L2 is left holding clean lines
    and the timed kernel's misses write nothing back: the timer of every
    ``ms`` this script reports.  ``write`` zeroes the buffer instead (the
    timer's earlier form): the L2 is left full of dirty lines, and the
    timed kernel's misses pay for writing them back.  ``warm`` evicts nothing,
    as on the training path, where M is written just before the encode.
    Each ends with a 0.1 ms spin on the card, so that the timed launch is
    queued before the card is free and its host-side cost stays out of
    the time."""
    import torch

    def then_spin(fn):
        return lambda: (fn(), torch.cuda._sleep(SPIN_CYCLES))
    return {"read": then_spin(flush.sum), "write": then_spin(flush.zero_),
            "warm": then_spin(lambda: None)}


def clocks(when: str) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[clocks] {when}: {smi}")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp32_err(out, ref) -> float:
    err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    if not err <= FP32_RTOL * scale:
        raise AssertionError(f"max |kernel - plain| = {err} > "
                             f"{FP32_RTOL} * {scale}")
    return err


def level_err(out, ref, step: float, what: str) -> float:
    """fp32-close, except that a level may move by one ``step`` on at most
    LEVEL_SHARE of the elements (and one)."""
    diff = (out - ref).abs()
    bad = diff > FP32_RTOL * max(1.0, ref.abs().max().item())
    n_bad = int(bad.sum())
    if n_bad > max(1, LEVEL_SHARE * ref.numel()) or (
            n_bad and not diff[bad].max().item() <= 1.001 * step + 1e-5):
        raise AssertionError(f"{what}: {n_bad} of {ref.numel()} elements "
                             f"differ, by up to {diff.max().item()} "
                             f"(one level: {step})")
    return diff.max().item()


def same_bits(a, b) -> bool:
    """Bit-for-bit equality: fp32 and bf16 compared as their bits, so
    ``-0.0`` and ``0.0`` differ and equal NaNs agree."""
    import torch
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype == b.dtype and a.dtype in bits:
        a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
    return a.shape == b.shape and bool(torch.equal(a, b))


def on_device(state, device):
    """A compressor state (NamedTuples, nested) with its tensors on
    ``device``; a ``key`` stays on the host, as the port keeps it."""
    return type(state)(*[
        on_device(v, device) if isinstance(v, tuple)
        else (v if name == "key" else v.to(device))
        for name, v in zip(state._fields, state)])


# ------------------------------------------------------------------ phases
def kernel_phase(shapes, rank):
    """Each kernel against its plain version at the main path's shapes:
    ``shapes`` lists (tag, PowerSGD rows, cols, bucket elements): the
    overlapped ZeRO-1 step's largest block bucket and its tail bucket
    first, then the classic ZeRO-1 step's full and last bucket, then the
    classic fp32 step's.
    Returns {kernel name: record}; each record's first case is the shape
    the headline numbers come from."""
    import torch

    from repro_torch.kernels import bitpack as kb
    from repro_torch.kernels import powersgd as kp
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import topk as kt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    evict = evictors(flush)["read"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = {}

    def check(name, label, kernel, plain):
        """Bit-for-bit on an edge input; not timed."""
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not same_bits(out, ref):
            raise AssertionError(f"{name} {label}: kernel != plain")
        log(f"[kernels] {name} {label}: bit-exact")

    def case(name, label, kernel, plain, library, nbytes, ops, exact):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if exact:
            if not same_bits(out, ref):
                raise AssertionError(f"{name} {label}: kernel != plain")
            err = 0.0
        else:
            err = fp32_err(out, ref)
        b_ms, b_by = bound(nbytes, ops)
        t = {"": time_ms(kernel, evict), "plain_": time_ms(plain, evict),
             "library_": time_ms(library, evict) if library else None}
        c = {"case": label, "max_abs_err": err}
        for pre, v in t.items():
            c[pre + "ms"] = v and v["ms"]
        c.update(bound_ms=b_ms, bound_by=b_by, spread_ms={
            pre + "ms": [v["min"], v["max"]] for pre, v in t.items() if v})
        log(f"[kernels] {name} {label}: " + json.dumps(c))
        recs.setdefault(name, []).append(c)

    for tag, r_, c_, _ in shapes:
        m = torch.randn(r_, c_, generator=gen, device=dev)
        q = torch.randn(c_, rank, generator=gen, device=dev)
        p = torch.randn(r_, rank, generator=gen, device=dev)
        mt = m.T
        nb = 4 * (r_ * c_ + (r_ + c_) * rank)
        ops = 2 * r_ * c_ * rank
        case("powersgd_encode", f"{tag} M@Q {r_}x{c_} r{rank}",
             lambda: kp.encode(m, q), lambda: kp.plain_encode(m, q),
             lambda: torch.matmul(m, q), nb, ops, False)
        case("powersgd_encode", f"{tag} M^T@P {c_}x{r_} (view) r{rank}",
             lambda: kp.encode(mt, p), lambda: kp.plain_encode(mt, p),
             lambda: torch.matmul(mt, p), nb, ops, False)
        case("powersgd_decode", f"{tag} P@Q^T {r_}x{c_} r{rank}",
             lambda: kp.decode(p, q), lambda: kp.plain_decode(p, q),
             lambda: torch.matmul(p, q.T), nb, ops, False)
        for label, fn in (("M@Q", lambda: kp.encode(m, q)),
                          ("M^T@P", lambda: kp.encode(mt, p)),
                          ("P@Q^T", lambda: kp.decode(p, q))):
            if not same_bits(fn(), fn()):
                raise AssertionError(f"powersgd {label} {r_}x{c_}: two "
                                     f"launches differ")
        if tag == "classic full":
            flush_check(m, q, p, flush)
        del m, q, p, mt
    powersgd_edges(gen)

    for tag, _, _, n in shapes:
        g = torch.randn(n, generator=gen, device=dev)
        g[:4] = torch.tensor([-0.0, float("nan"), 0.0, -1e-30])
        words = -(-n // 32)
        case("pack_signs", f"{tag} n={n}", lambda: kb.pack_signs(g),
             lambda: kb.plain_pack_signs(g), None, 4 * n + 4 * words, n,
             True)
        # p = 16 at the classic full bucket only, to put the scaling in p
        # on record
        for p_rows in (1, 4, 16) if tag == "classic full" else (1, 4):
            gathered = torch.stack([
                kb.pack_signs(torch.randn(n, generator=gen, device=dev))
                for _ in range(p_rows)])
            case("popcount_votes", f"{tag} n={n} p={p_rows}",
                 lambda: kb.popcount_votes(gathered, n),
                 lambda: kb.plain_popcount_votes(gathered, n), None,
                 4 * p_rows * words + 4 * n, 3 * p_rows * n, True)
        del g, gathered
    votes_edges(gen)

    for tag, _, _, n in shapes:
        g = torch.randn(n, generator=gen, device=dev)
        u = torch.rand(n, generator=gen, device=dev)
        norm = torch.linalg.vector_norm(g) + 1e-12
        for levels in (127, 1):
            # 9 bytes and about 8 fp32 operations per element
            case("qsgd_quantize", f"{tag} n={n} levels={levels}",
                 lambda: kq.quantize(g, norm, levels, u),
                 lambda: kq.plain_quantize(g, norm, levels, u), None,
                 9 * n + 4, 8 * n, True)
        if tag.startswith(("classic", "moe", "hybrid", "ssm",
                           "audio", "vlm", "hsdp")):          # no path
            # MSTop-K's 1%, from every k-th element (torch.quantile
            # takes at most 2**24)
            t = torch.quantile(g.abs()[::-(-n // 2**24)], 0.99)
            g[:5] = torch.tensor([-0.0, float("nan"), 0.0, float("-inf"),
                                  float("inf")])
            case("threshold_mask", f"{tag} n={n} t=p99",
                 lambda: kt.threshold_mask(g, t),
                 lambda: kt.plain_threshold_mask(g, t), None, 8 * n + 4,
                 2 * n, True)
        del g, u
    # edge inputs at the classic full bucket size
    n = next(n for tag, _, _, n in shapes if tag == "classic full")
    u = torch.rand(n, generator=gen, device=dev)
    zeros = torch.zeros(n, device=dev)
    one_hot = torch.zeros(n, device=dev)
    one_hot[n // 3] = -1.0                    # s == levels: no carry
    signed = torch.randn(n, generator=gen, device=dev)
    signed[::3], signed[1::3] = -0.0, 0.0
    for label, g in (("zeros", zeros), ("one-hot", one_hot),
                     ("signed zeros", signed)):
        norm = torch.linalg.vector_norm(g) + 1e-12
        for levels in (127, 1):
            check("qsgd_quantize", f"{label} levels={levels}",
                  lambda: kq.quantize(g, norm, levels, u),
                  lambda: kq.plain_quantize(g, norm, levels, u))
    q = kq.quantize(one_hot, torch.linalg.vector_norm(one_hot) + 1e-12,
                    127, u)
    if q[n // 3].item() != -127 or int((q != 0).sum()) != 1:
        raise AssertionError("qsgd_quantize: one-hot bucket is not -127")
    for tv in (0.0, -1.0, float("inf")):      # -0.0 kept where t <= 0
        t = torch.tensor(tv, device=dev)
        check("threshold_mask", f"signed zeros t={tv}",
              lambda: kt.threshold_mask(signed, t),
              lambda: kt.plain_threshold_mask(signed, t))
    del u, zeros, one_hot, signed, q
    del flush
    torch.cuda.empty_cache()
    return recs


def flush_check(m, q, p, flush) -> None:
    """The PowerSGD kernels and a read-only yardstick (``torch.sum`` of M)
    timed after each way of emptying the L2 (``evictors``), with the
    bytes bound of each; prints one ``[timer]`` line."""
    import torch

    from repro_torch.kernels import powersgd as kp
    rows, cols = m.shape
    rank = q.shape[1]
    nb = 4 * (rows * cols + (rows + cols) * rank)
    fns = {f"torch.sum {rows}x{cols}": (lambda: torch.sum(m),
                                        4 * rows * cols),
           "encode M@Q": (lambda: kp.encode(m, q), nb),
           "encode M^T@P": (lambda: kp.encode(m.T, p), nb),
           "decode P@Q^T": (lambda: kp.decode(p, q), nb)}
    out = {}
    for name, (fn, nbytes) in fns.items():
        out[name] = {how: time_ms(fn, ev)["ms"]
                     for how, ev in evictors(flush).items()}
        out[name]["bound_ms"] = bound(nbytes, 0)[0]
    log("[timer] " + json.dumps(out))


def powersgd_edges(gen) -> None:
    """encode (M@Q and the transposed view) and decode against their plain
    versions at ranks 1, 3, 4 and 16 on ragged shapes, the last bucket's
    shape, and a view whose pointer and row stride are not 16-byte aligned
    (storage offset 1, odd column count); each kernel launched twice on the
    same input must give the same bits; then ``two_streams``."""
    import torch

    from repro_torch.kernels import powersgd as kp
    dev = torch.device("cuda")

    def rand(*shape, offset=0):
        n = math.prod(shape)
        flat = torch.randn(n + offset, generator=gen, device=dev)
        return flat[offset:].view(*shape)

    n = 0
    for rank in (1, 3, 4, 16):
        for shape, offset in (((1, 127), 0), ((127, 1), 0), ((37, 129), 0),
                              ((2302, 2432), 0), ((37, 129), 1)):
            rows, cols = shape
            m = rand(rows, cols, offset=offset)
            q, p = rand(cols, rank, offset=offset), rand(rows, rank,
                                                         offset=offset)
            for label, kernel, plain in (
                    ("M@Q", lambda: kp.encode(m, q),
                     lambda: kp.plain_encode(m, q)),
                    ("M^T@P", lambda: kp.encode(m.T, p),
                     lambda: kp.plain_encode(m.T, p)),
                    ("P@Q^T", lambda: kp.decode(p, q),
                     lambda: kp.plain_decode(p, q)),
                    ("Q@P^T", lambda: kp.decode(q, p),
                     lambda: kp.plain_decode(q, p))):
                what = f"{label} {rows}x{cols} r{rank} offset {offset}"
                out = kernel()
                try:
                    fp32_err(out, plain())
                except AssertionError as e:
                    raise AssertionError(f"powersgd {what}: {e}") from None
                if not same_bits(out, kernel()):
                    raise AssertionError(f"powersgd {what}: two launches "
                                         f"differ")
                n += 1
    torch.cuda.synchronize()
    log(f"[kernels] powersgd edge cases: {n} within {FP32_RTOL} of plain, "
        f"each repeated bit for bit")
    two_streams(rand)


def two_streams(rand, rows=2560, cols=2560, rank=4, rounds=8) -> None:
    """Encodes of split plans (M@Q and M^T@P at a bucket's shape) queued
    on two streams at once, ``rounds`` of each on each: every result must
    be the bits the same encode gives alone, so the streams' arrival
    counters never meet."""
    import torch

    from repro_torch.kernels import powersgd as kp
    work = []
    for _ in range(2):
        m = rand(rows, cols)
        work += [(m, rand(cols, rank)), (m.T, rand(rows, rank))]
    alone = [kp.encode(m, x) for m, x in work]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(rounds):
        for i, (m, x) in enumerate(work):
            with torch.cuda.stream(streams[i // 2]):
                outs.append((i, kp.encode(m, x)))
    torch.cuda.synchronize()
    for i, out in outs:
        if not same_bits(out, alone[i]):
            raise AssertionError(f"powersgd encode {('M@Q', 'M^T@P')[i % 2]} "
                                 f"on stream {i // 2}: bits differ from the "
                                 f"same encode alone")
    log(f"[kernels] powersgd encode on two streams at once: {len(outs)} "
        f"launches, each the bits of the same encode alone")


#: popcount_votes card checks: rows, counts, and the most bytes the plain
#: version's int64 (p, words, 32) temporary may take (larger pairs skipped)
VOTES_PS = (1, 2, 3, 4, 5, 7, 8, 15, 16, 31, 32, 33, 64, 255, 256, 512)
VOTES_NS = (1, 31, 33, 4097, 1_000_003)
VOTES_PLAIN_BYTES = 2**31


def votes_edges(gen) -> None:
    """popcount_votes against its plain version, bit for bit, for every p
    in VOTES_PS and n in VOTES_NS: random words, random words with one word
    more than n needs, all ones (every count p), all zeros, and random words
    whose last word has every pad bit past n set.  Each is launched twice,
    the same bits required; n = 0 gives an empty result."""
    import torch

    from repro_torch.kernels import bitpack as kb
    dev = torch.device("cuda")

    def rand(p, words):
        return torch.randint(-2**31, 2**31, (p, words), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    checked, skipped = 0, []
    for p in VOTES_PS:
        for n in VOTES_NS:
            words = -(-n // 32)
            if 8 * 32 * p * words > VOTES_PLAIN_BYTES:
                skipped.append((p, n))
                continue
            padded = rand(p, words)
            if n % 32:
                padded[:, -1] |= -(1 << n % 32)
            cases = {"random": rand(p, words),
                     "spare word": rand(p, words + 1),
                     "ones": torch.full((p, words), -1, dtype=torch.int32,
                                        device=dev),
                     "zeros": torch.zeros((p, words), dtype=torch.int32,
                                          device=dev),
                     "pad bits set": padded}
            for label, w in cases.items():
                out, again = kb.popcount_votes(w, n), kb.popcount_votes(w, n)
                ref = kb.plain_popcount_votes(w, n)
                what = f"popcount_votes p={p} n={n} {label}"
                if not same_bits(out, ref):
                    raise AssertionError(f"{what}: kernel != plain")
                if not same_bits(out, again):
                    raise AssertionError(f"{what}: two launches differ")
                want = {"ones": p, "zeros": 0}.get(label)
                if want is not None and not bool((out == want).all()):
                    raise AssertionError(f"{what}: counts are not {want}")
                checked += 1
            del cases, padded
    if kb.popcount_votes(rand(3, 2), 0).numel() != 0:
        raise AssertionError("popcount_votes n=0: result not empty")
    torch.cuda.synchronize()
    log(f"[kernels] popcount_votes edge cases: {checked} bit-exact, each "
        f"launched twice with the same bits; skipped (p, n) {skipped}")


def reference_phase():
    """Every compressor's aggregation of the same buckets and state on the
    card and on the CPU (the plain versions): outputs and new state agree
    to fp32 summation order, SignSGD's signs exactly, QSGD's and
    TernGrad's levels up to one step on LEVEL_SHARE of the elements.  The
    stochastic schemes draw on the CPU, and their draw functions move the
    draws to the card, so both sides round with the same numbers.  Then
    one QSGD and one ``ef:qsgd`` bucket are aggregated on the card with
    the sync debug mode set to error."""
    import torch

    from repro_torch.core import aggregator as agg_mod
    from repro_torch.core.compression import qsgd, randomk, terngrad

    gen = torch.Generator().manual_seed(1)
    sizes = (70_000, 5_000)                 # a ragged matrix shape, a small one
    buckets = [torch.randn(n, generator=gen) for n in sizes]
    draw_fns = {(qsgd, "uniform"): qsgd.uniform,
                (terngrad, "uniform"): terngrad.uniform,
                (randomk, "indices"): randomk.indices}

    def on_cpu_then(fn):
        return lambda *a: fn(*a[:-1], "cpu").to(a[-1])
    for (mod, attr), fn in draw_fns.items():
        setattr(mod, attr, on_cpu_then(fn))
    try:
        for comp in ("powersgd", "signsgd", "qsgd", "terngrad", "randomk",
                     "mstopk", "ef:qsgd", "ef:signsgd"):
            cfg = agg_mod.AggregatorConfig(compressor=comp,
                                           compress_axes=("data",),
                                           raw_axes=())
            agg = agg_mod.GradAggregator(cfg)
            states = [live_state(agg.compressor.init_state(n, gen), n, gen)
                      for n in sizes]
            cpu_out, cpu_st = agg.aggregate_bucket_list(buckets, states)
            gpu_out, gpu_st = agg.aggregate_bucket_list(
                [b.cuda() for b in buckets],
                [on_device(s, "cuda") for s in states])
            stochastic = comp.removeprefix("ef:") in ("qsgd", "terngrad")
            for b, st, a, ref, new, new_ref in zip(
                    buckets, states, gpu_out, cpu_out, gpu_st, cpu_st):
                g = b + sum(t for t in flat_state(st)
                            if t.shape == b.shape)
                step = (g.norm().item() / 127 if "qsgd" in comp
                        else g.abs().max().item())
                pairs = [(a.cpu(), ref, "out")] + [
                    (x.cpu(), y, f"state {i}") for i, (x, y) in enumerate(
                        zip(flat_state(new), flat_state(new_ref)))]
                for x, y, what in pairs:
                    if stochastic:
                        level_err(x, y, step, f"{comp} {what}")
                    else:
                        fp32_err(x, y)
                if "signsgd" in comp and not torch.equal(a.cpu().sign(),
                                                         ref.sign()):
                    raise AssertionError(f"{comp}: signs differ from the CPU")
            log(f"[reference] {comp}: card == CPU on buckets {sizes}")
    finally:
        for (mod, attr), fn in draw_fns.items():
            setattr(mod, attr, fn)
    # the port's own draws, made on the card from the host-side key
    for comp in ("qsgd", "ef:qsgd"):
        agg = agg_mod.GradAggregator(agg_mod.AggregatorConfig(
            compressor=comp, compress_axes=("data",), raw_axes=()))
        b = buckets[0].cuda()
        st = on_device(agg.compressor.init_state(b.numel(), gen), "cuda")
        agg.aggregate_one(b, st)                           # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            agg.aggregate_one(b, st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"[reference] {comp}: one bucket aggregated on the card "
            f"without a host-device sync")


def flat_state(state) -> list:
    """The tensors of a state (NamedTuples, nested), keys left out."""
    out = []
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            out += flat_state(v)
        elif name != "key":
            out.append(v)
    return out


def state_tensors(obj) -> list:
    """Every tensor of a train state (dicts in key order, lists, tuples
    and NamedTuples in order)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in state_tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in state_tensors(v)]
    return []


def state_prints(obj) -> list:
    """A train state's fingerprints taken on the card: every tensor's
    ``pod_worker.fingerprint`` (dicts in key order, lists and tuples in
    order) and every other leaf's ``repr``.  Equal lists mean the same
    bits but with odds near 2^-64 a tensor, without a copy to the host."""
    import torch

    from repro_torch.train.pod_worker import fingerprint
    if isinstance(obj, torch.Tensor):
        return [fingerprint(obj)]
    if isinstance(obj, dict):
        return [p for k in sorted(obj) for p in [repr(k)]
                + state_prints(obj[k])]
    if isinstance(obj, (list, tuple)):
        return ["["] + [p for v in obj for p in state_prints(v)] + ["]"]
    return [repr(obj)]


def live_state(state, n: int, gen):
    """``state`` with a live error-feedback residual in every (n,) fp32
    field, as a step after the first has."""
    import torch
    for t in flat_state(state):
        if t.shape == (n,) and t.dtype == torch.float32:
            t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return state


#: kernel-name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = (
    ("compression kernels", ("encode_rows", "encode_cols",
                             "decode_kernel", "pack_kernel",
                             "votes_kernel", "quantize_kernel",
                             "threshold_mask_kernel")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "sm90_", "cutlass", "nvjet", "xmma", "cublas")),
)


#: the layers of the kernels launched inside a model's profiler ranges and
#: by the backward of the operators run there: the MoE routing, dispatch
#: and combine (``models.moe.DISPATCH`` and ``COMBINE``), the Mamba2
#: SSD scan and causal convolution (``models.mamba2.SSD`` and ``CONV``),
#: the enc-dec cross-attention (``models.encdec.CROSS``) and GELU MLPs
#: (``models.transformer.GELU_MLP``), and every family's loss head, one
#: chunk at a time (``models.transformer.LM_LOSS``)
MOE_LAYER = "moe dispatch and combine"
MAMBA_LAYER = "mamba ssd and conv"
CROSS_LAYER = "cross-attention"
GELU_LAYER = "gelu mlp"
LOSS_LAYER = "loss head"


def ranged_layers() -> dict:
    from repro_torch.models import encdec, mamba2
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    return {MOE_LAYER: (moe_mod.DISPATCH, moe_mod.COMBINE),
            MAMBA_LAYER: (mamba2.SSD, mamba2.CONV),
            CROSS_LAYER: (encdec.CROSS,), GELU_LAYER: (tf.GELU_MLP,),
            LOSS_LAYER: (tf.LM_LOSS,)}


def ranged_kernels(prof, layers: dict) -> dict:
    """layer -> kernel name -> device us of the kernels launched by the
    operators inside the layer's profiler ranges (``layers``: layer ->
    range names; their recomputation under ``remat="full"`` included) and
    by the backward nodes of those operators, found by their autograd
    sequence numbers (which count per thread, so a node matches by its
    forward thread too).  Inside a backward node an ``aten::`` operator
    with a sequence number is not the node's work (the backward runs with
    grad mode off) but a recomputation that the node set off: it counts
    only under a range of its own."""
    events = prof.events()
    layer_of = {r: layer for layer, rs in layers.items() for r in rs}
    out: dict[str, dict] = {layer: {} for layer in layers}
    seqs: dict = {}

    def add(e, layer):
        for k in getattr(e, "kernels", ()):
            out[layer][k.name] = out[layer].get(k.name, 0.0) + k.duration

    def collect(root, forward, layer):
        stack = list(root.cpu_children)
        while stack:
            e = stack.pop()
            seq = getattr(e, "sequence_nr", -1)
            if not forward and (e.name in layer_of or (
                    seq >= 0 and e.name.startswith("aten::"))):
                continue
            add(e, layer)
            if forward and seq >= 0:
                seqs[e.thread, seq] = layer
            stack.extend(e.cpu_children)
    for e in events:
        if e.name in layer_of:
            collect(e, True, layer_of[e.name])
    for e in events:
        if not e.name.startswith("autograd::engine::evaluate_function"):
            continue
        layer = seqs.get((getattr(e, "fwd_thread", e.thread),
                          getattr(e, "sequence_nr", -1)))
        if layer:
            add(e, layer)
            collect(e, False, layer)
    return out


def device_breakdown(prof, profiled_s: float, step_s: float) -> dict:
    """Device time of one profiled step by layer (ms), and the share of
    an unprofiled step's wall time ``step_s`` in which no kernel ran
    (busy time summed over the streams: exact where kernels do not
    overlap, as on the classic step's one stream; ``stream_overlap``
    gives the union for the overlapped step's two); the profiled step's
    own wall time, profiler cost included, is ``profiled_s``.  The MoE
    routing, dispatch and combine and the Mamba2 scan and convolution
    (``ranged_kernels``) are layers of their own, ``MOE_LAYER`` and
    ``MAMBA_LAYER``, and so are the cross-attention, the GELU MLPs and
    the loss head (``CROSS_LAYER``, ``GELU_LAYER``, ``LOSS_LAYER``)."""
    layers = ranged_layers()
    ranges = {r for rs in layers.values() for r in rs}
    groups: dict[str, float] = {}
    top, compression = [], []
    ranged = ranged_kernels(prof, layers)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if not us or not str(getattr(ev, "device_type", "")).endswith(
                "CUDA") or ev.key in ranges:
            continue
        name = ev.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other kernels")
        rest = us
        for layer, kernels in ranged.items():
            part = min(rest, kernels.get(ev.key, 0.0))
            if part:
                groups[layer] = groups.get(layer, 0.0) + part / 1e3
                rest -= part
        groups[group] = groups.get(group, 0.0) + rest / 1e3
        top.append((us / 1e3, ev.key[:60], ev.count))
        if group == "compression kernels":
            compression.append({"kernel": ev.key[:90], "count": ev.count,
                                "ms": us / 1e3,
                                "us_per_launch": us / ev.count})
    busy = sum(groups.values())
    top.sort(reverse=True)
    return {"step_ms": step_s * 1e3, "profiled_step_ms": profiled_s * 1e3,
            "device_busy_ms": busy,
            "idle_share": (1 - busy / (step_s * 1e3)) if busy else None,
            "by_layer_ms": groups,
            "top": [{"ms": t, "kernel": k, "count": c} for t, k, c in top[:12]],
            "compression_kernels": sorted(compression,
                                          key=lambda c: -c["ms"])}


def stream_overlap(prof) -> dict:
    """From the profiled step's device events, per CUDA stream: events,
    device ms, and the ms of it that ran while the compute stream (the
    stream with the most device time) was busy; and the union of every
    stream's busy intervals (ms), the device time that a one-stream sum
    would count twice where streams overlap."""
    per: dict = {}
    for ev in prof.events():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        sid = getattr(ev, "device_resource_id", None)
        if sid is None:
            sid = ev.thread
        per.setdefault(sid, []).append((ev.time_range.start,
                                        ev.time_range.end))

    def union(spans):
        out = []
        for lo, hi in sorted(spans):
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out
    if not per:
        return {"streams": {}}
    busy = {sid: sum(hi - lo for lo, hi in union(sp)) for sid, sp in
            per.items()}
    main = max(busy, key=busy.get)
    main_u = union(per[main])
    out = {}
    for sid, spans in per.items():
        ov = 0.0
        if sid != main:
            j = 0
            for lo, hi in union(spans):
                while j < len(main_u) and main_u[j][1] <= lo:
                    j += 1
                k = j
                while k < len(main_u) and main_u[k][0] < hi:
                    ov += min(hi, main_u[k][1]) - max(lo, main_u[k][0])
                    k += 1
        out[str(sid)] = {"events": len(spans), "ms": busy[sid] / 1e3,
                         "overlapped_ms": ov / 1e3,
                         "compute": sid == main}
    all_u = union([x for sp in per.values() for x in sp])
    return {"streams": out, "side_overlapped_ms": sum(
        v["overlapped_ms"] for v in out.values()),
        "busy_union_ms": sum(hi - lo for lo, hi in all_u) / 1e3}


def zero1_reference(steps: int = 2, lr: float = 1e-3) -> None:
    """The reduced ``tinyllama-1.1b`` (2 layers, d_model 128, vocab 512)
    with the arch's ZeRO-1 defaults, ``steps`` steps on the card and on the
    CPU from the same bf16 parameters and compressor state: ``none``,
    PowerSGD, SignSGD, ``reduce_to_owner_broadcast`` and ``accum=2``.  The
    model computes in fp32 on both sides, so the gradients differ only in
    summation order: losses within ``rtol=1e-4``; parameters within the
    AdamW rule of the CPU tests (max ``2 * lr * steps + 1e-4``, at most 2%
    of elements beyond ``lr / 2``, median at most ``lr / 50``)."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.train import train_step as ts

    arch = cfgs.reduced(cfgs.get("tinyllama-1.1b"))
    dcfg = DataConfig(vocab=arch.vocab, seq_len=32, global_batch=4, seed=1)
    runs = {"none": ({}, 1), "powersgd": (dict(compression="powersgd"), 1),
            "signsgd": (dict(compression="signsgd"), 1),
            "rtob": (dict(comm="reduce_to_owner_broadcast"), 1),
            "accum2": ({}, 2)}
    for label, (overrides, accum) in runs.items():
        out = {}
        for dev in ("cpu", "cuda"):
            setup = ts.build(arch, dev, bucket_mb=0.125, **overrides)
            setup.agg_cfg = dataclasses.replace(
                setup.agg_cfg, compress_axes=("data",), raw_axes=())
            setup.model.ctx = dataclasses.replace(
                setup.model.ctx, compute_dtype=torch.float32)
            state = ts.init_state(setup, seed=0)
            if dev == "cuda":             # the CPU run's starting point
                with torch.no_grad():
                    for p, p0 in zip(setup.model.parameters(), start):
                        p.copy_(p0)
                state = ts._fill_zero1_master(setup, state)
                state["agg"] = tuple(on_device(st, "cuda") for st in agg0)
            else:
                start = [p.detach().clone() for p in
                         setup.model.parameters()]
                agg0 = tuple(on_device(st, "cpu") for st in state["agg"])
            step = ts.make_step(setup, accum=accum)
            losses = []
            for s in range(steps):
                state, m = step(state, batch_at(dcfg, s), lr)
                losses.append(m["loss"].item())
            out[dev] = (losses, [p.detach().float().cpu()
                                 for p in setup.model.parameters()])
        (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out["cuda"]
        if not all(math.isclose(a, b, rel_tol=1e-4)
                   for a, b in zip(l_gpu, l_cpu)):
            raise AssertionError(f"zero1 {label}: losses {l_gpu} on the "
                                 f"card, {l_cpu} on the CPU")
        for a, b in zip(p_gpu, p_cpu):
            diff = (a - b).abs()
            if not (diff.max().item() <= 2 * lr * steps + 1e-4
                    and (diff > lr / 2).float().mean().item() <= 0.02
                    and diff.median().item() <= lr / 50):
                raise AssertionError(f"zero1 {label}: parameters differ by "
                                     f"up to {diff.max().item()}")
        log(f"[reference] zero1 {label}: card == CPU over {steps} steps "
            f"(losses {l_gpu})")


def overlap_reference(steps: int = 2, lr: float = 1e-3) -> None:
    """The overlapped step on the reduced ``tinyllama-1.1b`` with the
    arch's ZeRO-1 defaults and PowerSGD, from the same bf16 parameters and
    compressor state: ``steps`` steps on the CPU, ``overlap`` and
    ``serial`` on the card.  The card's overlapped run agrees with the CPU
    within ``zero1_reference``'s tolerances; on the card ``serial`` and
    ``overlap`` give the same bits (parameters, shard, compressor states,
    metrics).  Then one more overlapped step runs its flushes with the
    sync debug mode set to error: no flush may synchronise the host."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts

    arch = cfgs.reduced(cfgs.get("tinyllama-1.1b"))
    dcfg = DataConfig(vocab=arch.vocab, seq_len=32, global_batch=4, seed=1)
    start = agg0 = None
    out = {}
    for dev, schedule in (("cpu", "overlap"), ("cuda", "overlap"),
                          ("cuda", "serial")):
        setup = ts.build(arch, dev, bucket_mb=0.125, overlap=True,
                         compression="powersgd")
        setup.agg_cfg = dataclasses.replace(
            setup.agg_cfg, compress_axes=("data",), raw_axes=())
        setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                              compute_dtype=torch.float32)
        state = ts.init_state(setup, seed=0)
        if start is None:
            start = [p.detach().clone() for p in setup.model.parameters()]
            agg0 = tuple(on_device(st, "cpu") for st in state["agg"])
        else:
            with torch.no_grad():
                for p, p0 in zip(setup.model.parameters(), start):
                    p.copy_(p0)
            state = ts._fill_zero1_master(setup, state)
            state["agg"] = tuple(on_device(st, dev) for st in agg0)
        step = overlap.make_step(setup, schedule)
        metrics, orders = [], []
        for s in range(steps):
            state, m = step(state, batch_at(dcfg, s), lr)
            metrics.append(m)
            orders.append(list(step.flush_order))
        torch.cuda.synchronize()
        out[dev, schedule] = {
            "loss": [m["loss"].item() for m in metrics],
            "metrics": [v for m in metrics for v in m.values()],
            "params": [p.detach().clone() for p in
                       setup.model.parameters()],
            "shard": [t.clone() for t in state["opt"]["shard"].values()],
            "agg": [t.clone() for st in state["agg"]
                    for t in flat_state(st)],
            "order": orders, "n_buckets": setup.layout.n_buckets,
            "ready": overlap.build_layout(setup).bucket_ready}
        if (dev, schedule) == ("cuda", "overlap"):
            guarded = []
            plain_flush = overlap._Flush._flush

            def flush_no_sync(self, b, stage):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    plain_flush(self, b, stage)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                guarded.append(b)
            overlap._Flush._flush = flush_no_sync
            try:
                step(state, batch_at(dcfg, steps), lr)
            finally:
                overlap._Flush._flush = plain_flush
            torch.cuda.synchronize()
            if len(guarded) != setup.layout.n_buckets:
                raise AssertionError(f"{len(guarded)} guarded flushes")
            log(f"[reference] overlap powersgd: {len(guarded)} flushes of "
                f"one step on the side stream without a host-device sync")
        del setup, state, step
    cpu, gpu, ser = (out[k] for k in (("cpu", "overlap"), ("cuda", "overlap"),
                                      ("cuda", "serial")))
    if not all(math.isclose(a, b, rel_tol=1e-4)
               for a, b in zip(gpu["loss"], cpu["loss"])):
        raise AssertionError(f"overlap powersgd: losses {gpu['loss']} on "
                             f"the card, {cpu['loss']} on the CPU")
    for a, b in zip(gpu["params"], cpu["params"]):
        diff = (a.float().cpu() - b.float()).abs()
        if not (diff.max().item() <= 2 * lr * steps + 1e-4
                and (diff > lr / 2).float().mean().item() <= 0.02
                and diff.median().item() <= lr / 50):
            raise AssertionError(f"overlap powersgd: parameters differ by "
                                 f"up to {diff.max().item()}")
    for what in ("metrics", "params", "shard", "agg"):
        if len(gpu[what]) != len(ser[what]) or not all(
                same_bits(a, b) for a, b in zip(gpu[what], ser[what])):
            raise AssertionError(f"overlap powersgd: serial and overlap "
                                 f"{what} differ on the card")
    for run, schedule in ((gpu, "overlap"), (ser, "serial")):
        if not all(flush_order_ok(o, run["ready"], schedule)
                   for o in run["order"]):
            raise AssertionError(f"{schedule} flush order {run['order']}")
    log(f"[reference] overlap powersgd: card == CPU over {steps} steps "
        f"(losses {gpu['loss']}); serial == overlap bit for bit on the card "
        f"({gpu['n_buckets']} buckets: parameters, shard, compressor "
        f"states, metrics)")


# ---------------------------------------------------------------- the MoE
#: the MoE slice's model: full-width qwen2-moe-a2.7b cut to 2 blocks (24 at
#: full depth hold 14.3 B parameters, beyond one card's AdamW state)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_LAYERS = 2


def moe_arch():
    from repro_torch.configs import base as cfgs
    return dataclasses.replace(cfgs.get(MOE_ARCH), n_layers=MOE_LAYERS)


def moe_reference(lr: float = 1e-3) -> None:
    """The reduced ``qwen2-moe-a2.7b`` (2 layers, d_model 128, 4 experts
    top-2, one shared expert) on DDP with ZeRO-1 and PowerSGD, computing
    in fp32, from the same bf16 parameters (the router and the shared
    gate fp32) and compressor state: one classic step on the card against
    the CPU, within ``zero1_reference``'s tolerances (losses and
    ``moe_aux`` ``rtol=1e-4``); then 2 overlapped steps on the card under
    ``overlap`` and under ``serial``, which must give the same bits
    (parameters, shard, compressor states, metrics)."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts

    arch = cfgs.reduced(cfgs.get(MOE_ARCH))
    dcfg = DataConfig(vocab=arch.vocab, seq_len=32, global_batch=4, seed=1)
    start = agg0 = None
    out = {}
    for dev, schedule, steps in (("cpu", None, 1), ("cuda", None, 1),
                                 ("cuda", "overlap", 2),
                                 ("cuda", "serial", 2)):
        setup = ts.build(arch, dev, dp_mode="ddp", zero1=True,
                         bucket_mb=0.125, overlap=schedule is not None,
                         compression="powersgd")
        setup.agg_cfg = dataclasses.replace(
            setup.agg_cfg, compress_axes=("data",), raw_axes=())
        setup.model.ctx = dataclasses.replace(setup.model.ctx,
                                              compute_dtype=torch.float32)
        state = ts.init_state(setup, seed=0)
        if start is None:
            start = [p.detach().clone() for p in setup.model.parameters()]
        with torch.no_grad():
            for p, p0 in zip(setup.model.parameters(), start):
                p.copy_(p0)
        state = ts._fill_zero1_master(setup, state)
        if schedule is None:
            if agg0 is None:
                agg0 = tuple(on_device(st, "cpu") for st in state["agg"])
            state["agg"] = tuple(on_device(st, dev) for st in agg0)
        step = overlap.make_step(setup, schedule) if schedule \
            else ts.make_step(setup)
        metrics = []
        for s in range(steps):
            state, m = step(state, batch_at(dcfg, s), lr)
            metrics.append(m)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev, schedule] = {
            "loss": [m["loss"].item() for m in metrics],
            "aux": [m["moe_aux"].item() for m in metrics],
            "metrics": [v for m in metrics for v in m.values()],
            "params": [p.detach().clone() for p in
                       setup.model.parameters()],
            "state": [t.clone() for t in state_tensors(
                {k: state[k] for k in ("opt", "agg")})]}
        del setup, state, step
    cpu, gpu = out["cpu", None], out["cuda", None]
    for what in ("loss", "aux"):
        if not all(math.isclose(a, b, rel_tol=1e-4)
                   for a, b in zip(gpu[what], cpu[what])):
            raise AssertionError(f"moe zero1 powersgd: {what} {gpu[what]} "
                                 f"on the card, {cpu[what]} on the CPU")
    for a, b in zip(gpu["params"], cpu["params"]):
        diff = (a.float().cpu() - b.float()).abs()
        if not (diff.max().item() <= 2 * lr + 1e-4
                and (diff > lr / 2).float().mean().item() <= 0.02
                and diff.median().item() <= lr / 50):
            raise AssertionError(f"moe zero1 powersgd: parameters differ "
                                 f"by up to {diff.max().item()}")
    ov, se = out["cuda", "overlap"], out["cuda", "serial"]
    for what in ("metrics", "params", "state"):
        if len(ov[what]) != len(se[what]) or not all(
                same_bits(a, b) for a, b in zip(ov[what], se[what])):
            raise AssertionError(f"moe overlap powersgd: serial and "
                                 f"overlap {what} differ on the card")
    log(f"[reference] moe zero1 powersgd: card == CPU over one step (loss "
        f"{gpu['loss']}, moe_aux {gpu['aux']}); serial == overlap bit for "
        f"bit on the card over 2 steps (losses {ov['loss']})")


def moe_block_syncs() -> None:
    """One full-width MoE block (``MOE_ARCH``'s widths, bf16 parameters
    with the fp32 router and shared gate, batch 4 x 512), forward and
    backward through ``Model.stage_block`` with ``remat="full"``, under the
    sync debug mode "error": fatal if the block synchronises the host."""
    import torch

    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import (BLOCK_PREFIX, Model, leaf_dtype,
                                          param_layout)
    arch = dataclasses.replace(moe_arch(), n_layers=1)
    ctx = ShardCtx(param_dtype=torch.bfloat16)
    model = Model(arch, ctx, device="meta")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p_l = {}
    for name, shape, std in param_layout(arch):
        if name.startswith(BLOCK_PREFIX):
            t = torch.ones(shape[1:], device="cuda") if std is None else \
                std * torch.randn(shape[1:], generator=gen, device="cuda")
            p_l[name[len(BLOCK_PREFIX):]] = t.to(
                leaf_dtype(name, ctx)).requires_grad_()
    b, s = 4, 512
    x = torch.randn(b, s, arch.d_model, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    positions = torch.arange(s, device="cuda").expand(b, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = model.stage_block(p_l, x, positions)
        grads = torch.autograd.grad((y, aux), (x, *p_l.values()),
                                    (torch.ones_like(y),
                                     torch.ones_like(aux)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(g).all()) for g in grads) \
            or not math.isfinite(aux.item()):
        raise AssertionError("moe block: non-finite output or gradient")
    log(f"[reference] moe block ({arch.moe.n_experts} experts top-"
        f"{arch.moe.top_k}, d_ff {arch.d_ff}, {arch.moe.n_shared} shared, "
        f"batch {b} x {s}): forward and backward with remat under the sync "
        f"debug mode \"error\": no host sync ({ms:.1f} ms, aux "
        f"{aux.item():.4f})")


HYBRID_ARCH = "zamba2-2.7b"
#: card against CPU in fp32 (the Mamba2, xLSTM, encoder and decoder
#: blocks' forward and gradients; the chunked SSD and mLSTM against the
#: sequential ones): max |a - b| <= RTOL * |b| + SCALE * max|b|.  The
#: Mamba2 decays amplify the matmuls' rounding of dt, B and C: the CPU
#: tests measured 6.4e-5 of the largest gradient between two fp32
#: evaluations (``tests/test_torch_mamba2.py``)
CARD_RTOL, CARD_SCALE = 1e-4, 1e-4


def card_close(got, want, what: str) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    diff = (got - want).abs()
    scale = want.abs().max().item()
    if not bool((diff <= CARD_RTOL * want.abs()
                 + CARD_SCALE * scale).all()):
        raise AssertionError(f"{what}: max |card - CPU| {diff.max().item()}"
                             f" (largest entry {scale})")
    return diff.max().item() / max(scale, 1e-30)


def hybrid_block_params(arch, ctx, device, gen) -> tuple[dict, dict]:
    """Group 0's parameters (names under ``groups.``, sliced) and the
    shared block's (names under ``shared.``) of ``arch`` at its widths,
    drawn as ``Model.init_params`` draws them, with every LoRA ``b``
    nonzero so that the LoRA path is live."""
    import torch

    from repro_torch.models.model import (SHARED_PREFIX, init_leaf_,
                                          leaf_dtype, param_layout)
    p_g, shared = {}, {}
    for name, shape, init in param_layout(arch):
        if name.startswith("groups."):
            shape, out, key = shape[1:], p_g, name[len("groups."):]
        elif name.startswith(SHARED_PREFIX):
            out, key = shared, name[len(SHARED_PREFIX):]
        else:
            continue
        t = torch.empty(shape, dtype=leaf_dtype(name, ctx), device=device)
        init_leaf_(t, 0.02 if init == "zeros" else init, gen)
        out[key] = t.requires_grad_()
    return p_g, shared


def hybrid_reference() -> None:
    """On the card, the chunked SSD against the sequential oracle at the
    arch's head shapes (80 heads of 64, state 64, chunk 256, 300 steps, so
    the scan pads; a nonzero start state), outputs and final states; then
    one full-width Mamba2 block (d_model 2560, d_inner 5120, batch 1 x 512:
    two chunks) forward and gradients on the card against the same code
    on the CPU, in fp32, from the same parameters and inputs, within
    ``CARD_RTOL`` and ``CARD_SCALE``."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models import mamba2
    from repro_torch.models.layers import ShardCtx

    arch = cfgs.get(HYBRID_ARCH)
    sc = arch.ssm
    _, h, hd, n, _ = mamba2.dims(arch)
    gen = torch.Generator().manual_seed(3)
    b, l = 2, 300
    x = torch.randn(b, l, h, hd, generator=gen)
    dt = 0.1 * torch.rand(b, l, h, generator=gen)
    A = -torch.exp(torch.randn(h, generator=gen))
    Bm, Cm = (torch.randn(b, l, n, generator=gen) for _ in range(2))
    h0 = torch.randn(b, h, hd, n, generator=gen)
    args = [t.cuda() for t in (x, dt, A, Bm, Cm)]
    with torch.no_grad():
        y, hf = mamba2.ssd_chunked(*args, sc.chunk, h0=h0.cuda())
        ry, rh = mamba2.ssd_reference(*args, h0=h0.cuda())
    errs = [card_close(y, ry, "ssd_chunked y"),
            card_close(hf, rh, "ssd_chunked h")]
    log(f"[reference] hybrid ssd_chunked == ssd_reference on the card "
        f"(b {b}, l {l}, {h} heads of {hd}, state {n}, chunk {sc.chunk}; "
        f"max err / max {max(errs):.3g})")

    ctx = ShardCtx(compute_dtype=torch.float32)
    p_g, _ = hybrid_block_params(arch, ctx, "cpu",
                                 torch.Generator().manual_seed(4))
    p0 = {k[len("mamba."):]: v.detach()[0] for k, v in p_g.items()
          if k.startswith("mamba.")}
    x = torch.randn(1, 512, arch.d_model, generator=gen)
    r = torch.randn(x.shape, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev).requires_grad_() for k, v in p0.items()}
        xx = x.to(dev).requires_grad_()
        yy = mamba2.mamba_block_apply(p, xx, arch, ctx)
        grads = torch.autograd.grad((yy * r.to(dev)).sum(),
                                    (*p.values(), xx))
        out[dev] = [yy, *grads]
    names = ["y", *p0, "x"]
    errs = {nm: card_close(a, c, f"mamba block {nm}")
            for nm, a, c in zip(names, out["cuda"], out["cpu"])}
    log(f"[reference] hybrid mamba block (d_model {arch.d_model}, d_inner "
        f"{sc.expand * arch.d_model}, batch 1 x 512): card == CPU in fp32, "
        f"forward and {len(names) - 1} gradients; max err / max "
        + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))


def hybrid_block_syncs() -> None:
    """One full-width zamba2 group (the shared block with its LoRA patched
    in, then 6 Mamba2 blocks; bf16 parameters with ``A_log``, ``D`` and
    ``dt_bias`` fp32; batch 4 x 512), forward and backward through
    ``Model.stage_block`` with ``remat="full"`` (nested), under the sync
    debug mode "error": fatal if the group synchronises the host."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    arch = dataclasses.replace(cfgs.get(HYBRID_ARCH),
                               n_layers=cfgs.get(HYBRID_ARCH).ssm.attn_every)
    ctx = ShardCtx(param_dtype=torch.bfloat16)
    model = Model(arch, ctx, device="meta")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p_g, shared = hybrid_block_params(arch, ctx, "cuda", gen)
    b, s = 4, 512
    x = torch.randn(b, s, arch.d_model, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    positions = torch.arange(s, device="cuda").expand(b, s)
    leaves = (x, *p_g.values(), *shared.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = model.stage_block(p_g, x, positions, shared)
        grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(g).all()) for g in grads) \
            or not bool(torch.isfinite(y).all()):
        raise AssertionError("hybrid group: non-finite output or gradient")
    log(f"[reference] hybrid group (shared block + {arch.ssm.attn_every} "
        f"Mamba2 blocks, d_model {arch.d_model}, batch {b} x {s}): forward "
        f"and backward with nested remat under the sync debug mode "
        f"\"error\": no host sync ({ms:.1f} ms, {len(grads)} gradients)")


SSM_ARCH = "xlstm-350m"
#: an mLSTM block's forward and backward at batch 4 x 512 must add less
#: device memory than this (a three-operand einsum contracted left to
#: right builds a 2 GiB (b, t, h, v, k) tensor a chunk)
SSM_BLOCK_PEAK = 2 * 2**30


def ssm_block_params(arch, ctx, device, gen) -> dict:
    """Group 0's parameters (names under ``groups.``, sliced) of ``arch``
    at its widths, drawn as ``Model.init_params`` draws them."""
    import torch

    from repro_torch.models.model import init_leaf_, leaf_dtype, param_layout
    p_g = {}
    for name, shape, init in param_layout(arch):
        if name.startswith("groups."):
            t = torch.empty(shape[1:], dtype=leaf_dtype(name, ctx),
                            device=device)
            init_leaf_(t, init, gen)
            p_g[name[len("groups."):]] = t.requires_grad_()
    return p_g


def ssm_reference(device: str = "cuda") -> dict:
    """On the card: the chunked mLSTM against the sequential oracle at the
    arch's head shapes (4 heads, q/k 256, v 512, chunk 256, 512 steps from
    a nonzero carry), outputs and final carries; one full-width mLSTM and
    one sLSTM block (d_model 1024, batch 1 x 512) forward and gradients on
    the card against the same code on the CPU, in fp32, from the same
    parameters and inputs, within ``CARD_RTOL`` and ``CARD_SCALE``; one
    mLSTM block's forward and backward at batch 4 x 512 in bf16 (the
    training step's), whose added peak memory must stay under
    ``SSM_BLOCK_PEAK``.  Returns the printed numbers."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models import xlstm
    from repro_torch.models.layers import ShardCtx

    arch = cfgs.get(SSM_ARCH)
    _, hn, dk, dv = xlstm.mlstm_dims(arch)
    gen = torch.Generator().manual_seed(5)
    b, l = 1, 512
    q, k = (torch.randn(b, l, hn, dk, generator=gen) for _ in range(2))
    v = torch.randn(b, l, hn, dv, generator=gen)
    ig = torch.randn(b, l, hn, generator=gen)
    fg = torch.randn(b, l, hn, generator=gen) + 3.0
    carry = (torch.randn(b, hn, dv, dk, generator=gen),
             torch.randn(b, hn, dk, generator=gen),
             torch.randn(b, hn, generator=gen))
    args = [t.to(device) for t in (q, k, v, ig, fg)]
    carry = tuple(t.to(device) for t in carry)
    with torch.no_grad():
        y, (C, n, m) = xlstm.mlstm_chunked(*args, arch.ssm.chunk, carry)
        ry, (rC, rn, rm) = xlstm.mlstm_reference(*args, carry)
    # the carries are stored under their own stabilisers: compare C exp(m)
    scale = torch.exp(m - rm)
    errs = [card_close(y, ry, "mlstm_chunked y"),
            card_close(C * scale[..., None, None], rC, "mlstm_chunked C"),
            card_close(n * scale[..., None], rn, "mlstm_chunked n")]
    out = {"mlstm_chunked_err": max(errs)}
    log(f"[reference] ssm mlstm_chunked == mlstm_reference on the card (b "
        f"{b}, l {l}, {hn} heads, q/k {dk}, v {dv}, chunk {arch.ssm.chunk}, "
        f"from a carry; max err / max {max(errs):.3g})")

    ctx = ShardCtx(compute_dtype=torch.float32)
    p_g = ssm_block_params(arch, ctx, "cpu", torch.Generator().manual_seed(6))
    blocks = {"mlstm": (xlstm.mlstm_block_apply,
                        {k[len("mlstm."):]: v.detach()[0]
                         for k, v in p_g.items() if k.startswith("mlstm.")}),
              "slstm": (xlstm.slstm_block_apply,
                        {k[len("slstm."):]: v.detach()
                         for k, v in p_g.items() if k.startswith("slstm.")})}
    x = torch.randn(1, 512, arch.d_model, generator=gen)
    r = torch.randn(x.shape, generator=gen)
    for kind, (fn, p0) in blocks.items():
        res = {}
        for dev in ("cpu", device):
            p = {k: v.to(dev).requires_grad_() for k, v in p0.items()}
            xx = x.to(dev).requires_grad_()
            yy = fn(p, xx, arch, ctx)
            grads = torch.autograd.grad((yy * r.to(dev)).sum(),
                                        (*p.values(), xx))
            res[dev] = [yy, *grads]
        names = ["y", *p0, "x"]
        errs = {nm: card_close(a, c, f"{kind} block {nm}")
                for nm, a, c in zip(names, res[device], res["cpu"])}
        out[f"{kind}_block_err"] = max(errs.values())
        log(f"[reference] ssm {kind} block (d_model {arch.d_model}, batch "
            f"1 x 512): card == CPU in fp32, forward and {len(names) - 1} "
            f"gradients; max err / max "
            + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))

    bf16 = ShardCtx(param_dtype=torch.bfloat16)
    p_g = ssm_block_params(arch, bf16, device,
                           torch.Generator(device=device).manual_seed(7))
    p0 = {k[len("mlstm."):]: v.detach()[0].requires_grad_()
          for k, v in p_g.items() if k.startswith("mlstm.")}
    del p_g
    x = torch.randn(4, 512, arch.d_model, device=device,
                    dtype=torch.bfloat16).requires_grad_()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    y = xlstm.mlstm_block_apply(p0, x, arch, bf16)
    grads = torch.autograd.grad(y, (*p0.values(), x), torch.ones_like(y))
    if device == "cuda":
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - base
        out["mlstm_block_peak_gib"] = added / 2**30
        if added >= SSM_BLOCK_PEAK:
            raise AssertionError(f"mlstm block: forward and backward added "
                                 f"{added / 2**30:.2f} GiB")
        log(f"[reference] ssm mlstm block (bf16, batch 4 x 512) forward "
            f"and backward: peak {added / 2**30:.3f} GiB above the inputs "
            f"(limit {SSM_BLOCK_PEAK / 2**30:.0f} GiB)")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("mlstm block: non-finite gradient")
    return out


def ssm_block_syncs(device: str = "cuda") -> None:
    """One full-width xLSTM group (7 mLSTM blocks, then the sLSTM block;
    bf16 parameters with the gate weights and biases fp32; batch 4 x 512),
    forward and backward through ``Model.stage_block`` with
    ``remat="full"`` (nested), under the sync debug mode "error": fatal if
    the group synchronises the host."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    arch = dataclasses.replace(cfgs.get(SSM_ARCH),
                               n_layers=cfgs.get(SSM_ARCH).ssm.slstm_every)
    ctx = ShardCtx(param_dtype=torch.bfloat16)
    model = Model(arch, ctx, device="meta")
    gen = torch.Generator(device=device).manual_seed(0)
    p_g = ssm_block_params(arch, ctx, device, gen)
    b, s = 4, 512
    x = torch.randn(b, s, arch.d_model, generator=gen, device=device,
                    dtype=torch.bfloat16).requires_grad_()
    positions = torch.arange(s, device=device).expand(b, s)
    leaves = (x, *p_g.values())
    sync = device == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        y = model.stage_block(p_g, x, positions)
        grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    finally:
        if sync:
            torch.cuda.set_sync_debug_mode("default")
    if sync:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(g).all()) for g in grads) \
            or not bool(torch.isfinite(y).all()):
        raise AssertionError("ssm group: non-finite output or gradient")
    log(f"[reference] ssm group ({arch.ssm.slstm_every - 1} mLSTM blocks + "
        f"1 sLSTM block, d_model {arch.d_model}, batch {b} x {s}): forward "
        f"and backward with nested remat under the sync debug mode "
        f"\"error\": no host sync ({ms:.1f} ms, {len(grads)} gradients)")


def kernel_profile(fn) -> dict:
    """Device time (ms) and kernel count of one call of ``fn`` under the
    profiler, split into GEMMs and the rest, and its three costliest
    kernels.  The port's profiler ranges (the xLSTM ones and
    ``ranged_layers``') are left out: on the device timeline a range is
    an annotation spanning its kernels and the gaps between them, not a
    kernel."""
    import torch

    from repro_torch.models import xlstm
    ranges = {xlstm.MLSTM, xlstm.SLSTM,
              *(r for rs in ranged_layers().values() for r in rs)}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    gemm_keys = dict(KERNEL_GROUPS)["matmul"]
    out = {"ms": 0.0, "gemm_ms": 0.0, "kernels": 0}
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if not us or not str(getattr(ev, "device_type", "")).endswith(
                "CUDA") or ev.key in ranges:
            continue
        out["ms"] += us / 1e3
        out["kernels"] += ev.count
        top.append((us / 1e3, ev.key[:60], ev.count))
        if any(k in ev.key.lower() for k in gemm_keys):
            out["gemm_ms"] += us / 1e3
    out["top"] = sorted(top, reverse=True)[:3]
    return out


#: the sLSTM scan's token steps under the profiler (scaled to 512)
SSM_PROFILE_STEPS = 64


def ssm_profiles() -> dict:
    """The ssm step is not profiled whole (some 10^5 kernels, minutes of
    the profiler's own host work): one full-width mLSTM block and
    ``slstm_scan`` over ``SSM_PROFILE_STEPS`` token steps are, each
    forward alone and forward plus backward (bf16 parameters, batch 4 x
    512, the training step's dtypes).  Printed with the per-step device
    time they scale to: under the nested remat a step runs each block's
    forward three times and its backward once, the mLSTM 21 times and the
    sLSTM 3 times a step, the scan over 512 tokens (labelled "scaled", not
    measured whole)."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models import xlstm
    from repro_torch.models.layers import ShardCtx
    arch = cfgs.get(SSM_ARCH)
    ctx = ShardCtx(param_dtype=torch.bfloat16)
    p_g = ssm_block_params(arch, ctx, "cuda",
                           torch.Generator(device="cuda").manual_seed(8))
    p0 = {k[len("mlstm."):]: v.detach()[0].requires_grad_()
          for k, v in p_g.items() if k.startswith("mlstm.")}
    x = torch.randn(4, 512, arch.d_model, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    hn, hd = arch.n_heads, arch.d_model // arch.n_heads
    gates = torch.randn(4, SSM_PROFILE_STEPS, 4, hn, hd,
                        device="cuda").requires_grad_()
    r = p_g["slstm.r_gates"].detach().requires_grad_()

    def mlstm_fwd():
        return xlstm.mlstm_block_apply(p0, x, arch, ctx)

    def mlstm_both():
        y = mlstm_fwd()
        torch.autograd.grad(y, (*p0.values(), x), torch.ones_like(y))

    def slstm_fwd():
        return xlstm.slstm_scan(gates, r, hn)[0]

    def slstm_both():
        y = slstm_fwd()
        torch.autograd.grad(y, (gates, r), torch.ones_like(y))
    for fn in (mlstm_both, slstm_both):     # warm up: first-call setup
        fn()
    # the first profiled kernels of a process carry the tracer's start-up
    # (an mLSTM forward alone then reads 6.3 ms, with its backward 8.4):
    # one profile is taken and thrown away
    kernel_profile(mlstm_fwd)
    prof = {name: kernel_profile(fn) for name, fn in (
        ("mlstm fwd", mlstm_fwd), ("mlstm fwd+bwd", mlstm_both),
        ("slstm fwd", slstm_fwd), ("slstm fwd+bwd", slstm_both))}
    g = arch.n_layers // arch.ssm.slstm_every
    n_ml, n_sl = g * (arch.ssm.slstm_every - 1), g
    tok = 512 / SSM_PROFILE_STEPS

    def per_step(kind, n, scale, key):
        fwd, both = prof[f"{kind} fwd"][key], prof[f"{kind} fwd+bwd"][key]
        return n * scale * (3 * fwd + (both - fwd))
    scaled = {"mlstm_ms": per_step("mlstm", n_ml, 1, "ms"),
              "mlstm_gemm_ms": per_step("mlstm", n_ml, 1, "gemm_ms"),
              "mlstm_kernels": per_step("mlstm", n_ml, 1, "kernels"),
              "slstm_scan_ms": per_step("slstm", n_sl, tok, "ms"),
              "slstm_scan_kernels": per_step("slstm", n_sl, tok, "kernels")}
    log(f"[profile] ssm blocks (full width, bf16, batch 4 x 512; sLSTM scan "
        f"over {SSM_PROFILE_STEPS} token steps): " + json.dumps(prof))
    log(f"[profile] ssm scaled to one step ({n_ml} mLSTM blocks, {n_sl} "
        f"sLSTM scans of 512 tokens, three forwards and one backward "
        f"each; scaled, not measured whole): " + json.dumps(scaled))
    return {"measured": prof, "scaled": scaled}


AUDIO_ARCH = "seamless-m4t-medium"
#: the families whose arch runs at full width through ``family_phase``,
#: at full depth unless ``FAMILY_LAYERS`` cuts it: (tag, arch)
FAMILY_PHASES = (("hybrid", HYBRID_ARCH), ("ssm", SSM_ARCH),
                 ("audio", AUDIO_ARCH))
#: family phases cut in depth: xLSTM to 2 of its 3 groups (its steps are
#: host-bound, 4.6-8.0 s at full depth, measured on one H100), which
#: keeps the overlapped step's two stages; zamba2 to 4 of its 9 groups
#: (38.5-59.9 s at full depth, measured on one H100), for the time the
#: serve phase takes
FAMILY_LAYERS = {"ssm": 16, "hybrid": 24}


def family_arch(tag: str, name: str):
    """A family phase's arch: ``name`` at full width and depth, or cut to
    ``FAMILY_LAYERS[tag]`` layers."""
    from repro_torch.configs import base as cfgs
    if tag not in FAMILY_LAYERS:
        return name
    return dataclasses.replace(cfgs.get(name), n_layers=FAMILY_LAYERS[tag])


def audio_block_params(arch, ctx, device, gen) -> dict:
    """Layer 0's parameters of each stack (``"enc"`` and ``"dec"``: names
    under ``enc_blocks.`` and ``dec_blocks.``, sliced) of ``arch`` at its
    widths, drawn as ``Model.init_params`` draws them."""
    import torch

    from repro_torch.models.model import (DEC_PREFIX, ENC_PREFIX, init_leaf_,
                                          leaf_dtype, param_layout)
    out = {"enc": {}, "dec": {}}
    for name, shape, init in param_layout(arch):
        for kind, pre in (("enc", ENC_PREFIX), ("dec", DEC_PREFIX)):
            if name.startswith(pre):
                t = torch.empty(shape[1:], dtype=leaf_dtype(name, ctx),
                                device=device)
                init_leaf_(t, init, gen)
                out[kind][name[len(pre):]] = t.requires_grad_()
    return out


def audio_reference(device: str = "cuda") -> dict:
    """One full-width encoder block and one decoder block over a
    full-width memory (d_model 1024, 16 heads of 64, d_ff 4096; batch 1 x
    512 tokens over 512 frames), forward and the gradients of every
    parameter, the input and, for the decoder, the memory, on the card
    against the same code on the CPU, in fp32, from the same parameters
    and inputs, within ``CARD_RTOL`` and ``CARD_SCALE``.  Returns each
    block's largest error over its largest entry."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models import encdec
    from repro_torch.models.layers import ShardCtx
    arch = cfgs.get(AUDIO_ARCH)
    ctx = ShardCtx(compute_dtype=torch.float32)
    params = audio_block_params(arch, ctx, "cpu",
                                torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    x, mem, r = (torch.randn(1, 512, arch.d_model, generator=gen)
                 for _ in range(3))
    positions = torch.arange(512).expand(1, 512)
    out = {}
    for kind in ("enc", "dec"):
        res = {}
        for dev in ("cpu", device):
            p = {k: v.detach().to(dev).requires_grad_()
                 for k, v in params[kind].items()}
            xx, mm = (t.to(dev).requires_grad_() for t in (x, mem))
            pos = positions.to(dev)
            if kind == "enc":
                y = encdec.enc_block_apply(p, xx, pos, arch, ctx)
                wrt = (*p.values(), xx)
            else:
                y = encdec.dec_block_apply(p, xx, mm, pos, arch, ctx)
                wrt = (*p.values(), xx, mm)
            res[dev] = [y, *torch.autograd.grad((y * r.to(dev)).sum(), wrt)]
        names = ["y", *params[kind], "x"] + (["memory"] if kind == "dec"
                                            else [])
        errs = {nm: card_close(a, c, f"{kind} block {nm}")
                for nm, a, c in zip(names, res[device], res["cpu"])}
        out[f"{kind}_block_err"] = max(errs.values())
        log(f"[reference] audio {kind} block (d_model {arch.d_model}, "
            f"batch 1 x 512): card == CPU in fp32, forward and "
            f"{len(names) - 1} gradients; max err / max "
            + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    return out


def audio_block_syncs(device: str = "cuda") -> None:
    """One full-width decoder block (bf16 parameters; batch 4 x 512 over a
    memory of 512 frames), forward and backward through
    ``Model.stage_block`` with ``remat="full"``, the memory an input of
    the recomputation, under the sync debug mode "error": fatal if the
    block synchronises the host or a gradient (the memory's included) is
    not finite."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    arch = cfgs.get(AUDIO_ARCH)
    ctx = ShardCtx(param_dtype=torch.bfloat16)
    model = Model(arch, ctx, device="meta")
    gen = torch.Generator(device=device).manual_seed(0)
    p = audio_block_params(arch, ctx, device, gen)["dec"]
    b, s = 4, 512
    x, mem = (torch.randn(b, s, arch.d_model, generator=gen, device=device,
                          dtype=torch.bfloat16).requires_grad_()
              for _ in range(2))
    positions = torch.arange(s, device=device).expand(b, s)
    leaves = (x, mem, *p.values())
    sync = device == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        y = model.stage_block(p, x, positions, memory=mem)
        grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    finally:
        if sync:
            torch.cuda.set_sync_debug_mode("default")
    if sync:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(g).all()) for g in grads) \
            or not bool(torch.isfinite(y).all()):
        raise AssertionError("audio decoder block: non-finite output or "
                             "gradient")
    log(f"[reference] audio decoder block (d_model {arch.d_model}, batch "
        f"{b} x {s} over {s} frames): forward and backward with remat under "
        f"the sync debug mode \"error\": no host sync ({ms:.1f} ms, "
        f"{len(grads)} gradients, the memory's among them)")


VLM_ARCH = "qwen2-vl-7b"
#: the vlm one-rank phase's depth: full width, 4 of 28 blocks (28 would
#: need ~122 GB of ZeRO-1 state and weights on one rank)
VLM_LAYERS = 4
#: the vlm reference block's tokens (the CPU side runs a 233 M-parameter
#: block forward and backward in fp32)
VLM_REF_SEQ = 128


def vlm_arch():
    """``qwen2-vl-7b`` at full width cut to ``VLM_LAYERS`` blocks."""
    from repro_torch.configs import base as cfgs
    return dataclasses.replace(cfgs.get(VLM_ARCH), n_layers=VLM_LAYERS)


def vlm_reference(device: str = "cuda") -> float:
    """One full-width qwen2-vl block (d_model 3584, 28 heads and 4 KV
    heads of 128, d_ff 18944) rotating by M-RoPE over three distinct
    position streams (an image of 64 patches on an 8 x 8 grid, then
    text; batch 1 x ``VLM_REF_SEQ``), forward and the gradients of every
    parameter and the input, on the card against the same code on the
    CPU, in fp32, from the same parameters and inputs, within
    ``CARD_RTOL`` and ``CARD_SCALE``; the card's forward and backward run
    under the sync debug mode "error" (fatal on a host sync).  Returns
    the largest error over the largest entry."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.launch.inputs import vlm_positions
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import (BLOCK_PREFIX, init_leaf_,
                                          leaf_dtype, param_layout)
    arch = cfgs.get(VLM_ARCH)
    ctx = ShardCtx(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    params = {}
    for name, shape, init in param_layout(arch):
        if name.startswith(BLOCK_PREFIX):
            t = torch.empty(shape[1:], dtype=leaf_dtype(name, ctx))
            init_leaf_(t, init, gen)
            params[name[len(BLOCK_PREFIX):]] = t
    s = VLM_REF_SEQ
    x, r = (torch.randn(1, s, arch.d_model, generator=gen) for _ in range(2))
    mrope = vlm_positions(1, s)
    positions = torch.arange(s).expand(1, s)
    res = {}
    for dev in ("cpu", device):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        args = (xx, positions.to(dev), arch, ctx, mrope.to(dev))
        rr = r.to(dev)
        sync = dev != "cpu"
        if sync:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            y = tf.dense_block_apply(p, *args)
            grads = torch.autograd.grad((y * rr).sum(), (*p.values(), xx))
        finally:
            if sync:
                torch.cuda.set_sync_debug_mode("default")
        res[dev] = [y, *grads]
        del p, xx
    names = ["y", *params, "x"]
    errs = {nm: card_close(a, c, f"vlm block {nm}")
            for nm, a, c in zip(names, res[device], res["cpu"])}
    log(f"[reference] vlm block (d_model {arch.d_model}, M-RoPE sections "
        f"(16, 24, 24), batch 1 x {s}): card == CPU in fp32, forward and "
        f"{len(names) - 1} gradients, no host sync on the card; max err / "
        f"max " + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    return max(errs.values())


def hsdp_layout():
    """The HSDP phase's shard bucket layout: ``qwen2-vl-7b`` at full
    width, ``FSDP_LAYERS`` block, fp32 parameters sharded over a ``data``
    axis of 2 (``meta``; no allocation)."""
    import torch

    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    arch = dataclasses.replace(vlm_arch(), n_layers=FSDP_LAYERS)
    model = Model(arch, ShardCtx(fsdp_axes=("data",)), device="meta",
                  fsdp_size=2)
    return bucketing.layout_for(list(model.parameters()),
                                arch.plan.bucket_mb)


def family_layouts(tag: str, name: str) -> tuple[dict, list]:
    """The full-size arch ``name``'s bucket counts (classic ZeRO-1 and
    overlapped ZeRO-1, from the layouts on the ``meta`` device) and the
    kernel phase's shapes for it, tagged ``tag``: the overlapped layout's
    largest block bucket (in one stage's slice) and its largest tail
    bucket (one vocabulary table)."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.core import bucketing
    from repro_torch.core.compression.powersgd import matrix_shape
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap
    arch = cfgs.get(name) if isinstance(name, str) else name
    model = Model(arch, ShardCtx(param_dtype=torch.bfloat16), device="meta")
    ov = overlap.layout_for_model(model, arch.plan.bucket_mb)
    by_stage = list(zip(ov.layout.sizes, ov.bucket_ready))
    shapes = [(f"{tag} overlap {which}", *matrix_shape(n), n)
              for which, n in (
                  ("block", max(n for n, r in by_stage if r < ov.n_stages)),
                  ("tail", max(n for n, r in by_stage
                               if r == ov.n_stages)))]
    zero1 = bucketing.layout_for(list(model.parameters()),
                                 arch.plan.bucket_mb)
    return {"zero1": zero1.n_buckets, "overlap": ov.layout.n_buckets}, shapes


def family_phase(tag: str, name, buckets: dict, hist: dict,
                 counts: dict, **extra) -> dict:
    """The arch ``name`` (a registered name: full width and depth; or an
    ``ArchConfig``, e.g. cut in depth) on its own plan (DDP, ZeRO-1,
    ``remat="full"``; ``extra`` overrides it in every run, e.g.
    ``dp_mode="ddp"``) through ``train_phase``, each run labelled
    ``tag``: ZeRO-1 2 PowerSGD steps, 1 SignSGD and 1 QSGD; the
    overlapped ZeRO-1 step 2 PowerSGD steps under ``overlap`` and 2 under
    ``serial``, whose final states and metrics must agree bit for bit;
    the classic fp32 step 1 step uncompressed.  ``buckets`` holds the
    layouts' bucket counts (``family_layouts``); each run's records and
    launch counts go into ``hist`` and ``counts``.  Returns the runs."""
    from repro_torch.configs import base as cfgs
    arch = cfgs.get(name) if isinstance(name, str) else name
    t0 = time.perf_counter()
    nz, no = buckets["zero1"], buckets["overlap"]

    def psgd(n):
        return {"powersgd_encode": 2 * n, "powersgd_decode": n}
    runs = {  # name -> (steps, launches per step, schedule, overrides)
        f"{tag} zero1 powersgd": (2, psgd(nz), None,
                                  dict(compression="powersgd")),
        f"{tag} zero1 signsgd": (1, {"pack_signs": nz, "popcount_votes": nz},
                                 None, dict(compression="signsgd")),
        f"{tag} zero1 qsgd": (1, {"qsgd_quantize": nz}, None,
                              dict(compression="qsgd")),
        f"{tag} zero1 overlap powersgd": (2, psgd(no), "overlap",
                                          dict(compression="powersgd")),
        f"{tag} zero1 serial powersgd": (2, psgd(no), "serial",
                                         dict(compression="powersgd")),
        f"{tag} classic none": (1, {}, None, dict(zero1=False)),
    }
    kept = {}
    for label, (steps, per_step, schedule, overrides) in runs.items():
        hist[label], counts[label] = train_phase(
            label, steps, per_step, 1, schedule, arch=arch,
            keep=kept if schedule else None, **{**extra, **overrides})
    if not kept.get("same"):
        raise AssertionError(f"{tag}: serial and overlap differ at full "
                             f"width")
    log(f"[{tag}] serial == overlap at full width, by on-card "
        f"fingerprints (plain and hashed bit sums): "
        f"{len(kept['prints'])} state tensors ("
        f"{kept['elements']:,} elements) and the "
        f"metrics of {len(kept['metrics'])} steps")
    del kept
    log(f"[{tag}] phase in {time.perf_counter() - t0:.1f} s")
    return runs


def host_syncs(fn) -> list[str]:
    """Runs ``fn`` with PyTorch's sync debug mode set to warn; returns the
    Python caller (file:line) of each host-device synchronisation it made,
    in order."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def flush_order_ok(order, ready, schedule: str) -> bool:
    """The host-side flush order a schedule must give: each bucket after
    the stage that completes it (``overlap``), every bucket after the
    last stage (``serial``), none (``raw``)."""
    want = {"overlap": list(enumerate(ready)),
            "serial": [(b, max(ready)) for b in range(len(ready))],
            "raw": []}[schedule]
    return order == want


def train_phase(label: str, steps: int, per_step: dict[str, int],
                accum: int = 1, schedule: "str | None" = None,
                arch=None, keep: "dict | None" = None, **overrides):
    """Full-width training through the port's entry points, built from the
    plan of ``arch`` (full-size ``tinyllama-1.1b`` unless given) with
    ``overrides``; returns the per-step records and the launch counts of
    the run.  With ``schedule`` the step is the overlapped one
    (``overlap=True``) run under that schedule, and the host-side flush
    order of every step is checked against the layout's ``bucket_ready``.
    With ``keep`` (a dict) the fingerprints (``pod_worker.fingerprint``,
    taken on the card) of the
    final parameters, ZeRO-1 shards and compressor states and every
    step's metrics are kept in it; a second run with the same dict
    compares its own with them.  A run named in ``PROFILED`` takes one
    more step after the records, under the profiler."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.inputs import with_frontend_inputs
    from repro_torch.train import overlap
    from repro_torch.train import train_step as ts
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    from repro_torch.models.model import leaf_dtype
    from repro_torch.train.pod_worker import fingerprint
    arch = arch or cfgs.get("tinyllama-1.1b")
    wall = {"start": time.perf_counter()}
    torch.cuda.reset_peak_memory_stats()
    if schedule:
        overrides["overlap"] = True
    setup = ts.build(arch, "cuda", **overrides)
    # one rank: point the aggregator back at the size-1 data axis, as the
    # tests do, so every bucket still runs through the compressor
    setup.agg_cfg = dataclasses.replace(setup.agg_cfg,
                                        compress_axes=("data",), raw_axes=())
    dcfg = DataConfig(vocab=arch.vocab, seq_len=512, global_batch=4, seed=0)
    data = (with_frontend_inputs(arch, batch_at(dcfg, s), s)
            for s in range(steps + 1))
    tcfg = TrainerConfig(total_steps=steps, log_every=1, accum=accum,
                         schedule=ScheduleConfig(peak_lr=3e-4,
                                                 warmup_steps=1,
                                                 total_steps=steps))
    trainer = Trainer(setup, tcfg, data)
    trainer.state = ts.init_state(setup, seed=0)
    orders = []
    if schedule:
        effective = "serial" if schedule == "serial" and not setup.rtob \
            else overlap.effective_schedule(setup)
        step = overlap.make_step(setup, schedule, accum)

        def logged(*args):
            out = step(*args)
            orders.append(list(step.flush_order))
            return out
        trainer.step_fn = logged
    log(f"[train] {label}: {sum(p.numel() for p in setup.model.parameters()):,}"
        f" params of {str(setup.layout.dtype).removeprefix('torch.')}, "
        f"zero1={setup.zero1} rtob={setup.rtob} accum={accum} "
        f"comp={setup.agg_cfg.compressor}, {setup.layout.n_buckets} buckets "
        f"of {setup.layout.bucket_elems:,} (last "
        f"{setup.layout.last_elems:,}); overlap={setup.overlap} "
        f"schedule={schedule and effective}; after init "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if setup.zero1:
        shard = trainer.state["opt"]["shard"]
        if {k: (v.dtype, v.shape) for k, v in shard.items()} != {
                k: (torch.float32, (setup.layout.n_elements,))
                for k in ("master", "m", "v")}:
            raise AssertionError(f"{label}: the ZeRO-1 shards are not one "
                                 f"fp32 copy of the {setup.layout.n_elements}"
                                 f" parameters")
    kbuild.reset_launches()
    wall["built"] = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall["ran"] = time.perf_counter()
    counts = dict(kbuild.LAUNCHES)
    history = list(trainer.history)
    # one more step under the profiler, kept out of the history and counts
    extra = []
    if label in PROFILED:
        tcfg.total_steps = steps + 1
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            trainer.run()
        torch.cuda.synchronize()
        extra = [trainer.history.pop()]
        breakdown = device_breakdown(prof, extra[0]["step_s"],
                                     history[-1]["step_s"])
        if schedule:
            so = stream_overlap(prof)
            if so.get("busy_union_ms"):
                so["idle_share"] = 1 - so["busy_union_ms"] / (
                    history[-1]["step_s"] * 1e3)
            breakdown["stream_overlap"] = so
        del prof
        log(f"[profile] {label} " + json.dumps(breakdown))
    wall["profiled"] = time.perf_counter()
    if schedule:
        ready = overlap.build_layout(setup).bucket_ready
        if not all(flush_order_ok(o, ready, effective) for o in orders):
            raise AssertionError(f"{label}: flush order {orders[-1]} under "
                                 f"{effective} (bucket_ready {ready})")
        log(f"[train] {label}: flush order of {len(orders)} steps: each of "
            f"{len(ready)} buckets issued after stage "
            f"{[st for _, st in orders[-1]]} ({effective})")

        # one more step, outside the records, to see where the host waits
        def one_step():
            trainer.state, _ = trainer.step_fn(
                trainer.state,
                with_frontend_inputs(arch, batch_at(dcfg, steps + 1),
                                     steps + 1), 3e-4)
        syncs = host_syncs(one_step)
        torch.cuda.synchronize()
        log(f"[train] {label}: one more step under the sync debug mode "
            f"\"warn\": {len(syncs)} host syncs, at " + json.dumps(
                {at: syncs.count(at) for at in sorted(set(syncs))}))
    want = {k: v * steps for k, v in per_step.items()}
    for k in KERNELS:
        if counts.get(k, 0) != want.get(k, 0):
            raise AssertionError(f"{label}: {k} launched {counts.get(k, 0)} "
                                 f"times, expected {want.get(k, 0)}")
    for rec in history + extra:
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm",
                                                   "moe_aux")):
            raise AssertionError(f"{label}: non-finite metrics {rec}")
    ctx = setup.model.ctx
    if not all(p.dtype == leaf_dtype(name, ctx)
               and bool(torch.isfinite(p).all())
               for name, p in setup.model.named_parameters()):
        raise AssertionError(f"{label}: parameters not finite or not of "
                             f"their leaf dtype ({ctx.param_dtype})")
    log(f"[train] {label}: launches {counts}; peak "
        f"{max(r['peak_mem_gb'] for r in history):.2f} GiB "
        f"(torch.cuda.max_memory_allocated in a step); moe_aux "
        f"{[r['moe_aux'] for r in history]}")
    if keep is not None and "prints" in keep:
        # compare with the kept run's fingerprints, taken on the card
        keep["same"] = keep["metrics"] == [
            (r["loss"], r["grad_norm"], r["moe_aux"])
            for r in history + extra] and keep["prints"] == [
                fingerprint(t) for t in state_tensors(trainer.state)]
    elif keep is not None:
        keep["metrics"] = [(r["loss"], r["grad_norm"], r["moe_aux"])
                           for r in history + extra]
        tensors = state_tensors(trainer.state)
        keep["prints"] = [fingerprint(t) for t in tensors]
        keep["elements"] = sum(t.numel() for t in tensors)
        del tensors
    del trainer, setup, data
    if schedule:
        del step, logged
    gc.collect()
    torch.cuda.empty_cache()
    now = time.perf_counter()
    log(f"[train] {label}: wall {now - wall['start']:.1f} s (build and "
        f"init {wall['built'] - wall['start']:.1f}, steps "
        f"{wall['ran'] - wall['built']:.1f}, profiled step and its "
        f"breakdown {wall['profiled'] - wall['ran']:.1f}, the rest "
        f"{now - wall['profiled']:.1f})")
    return history, counts


# ------------------------------------------------------------- experiments
#: the analytic headline of the paper's 216-setup matrix and the adaptive
#: matrix, as the JAX package's analytic backend gives it (PERF.md)
ANALYTIC_WANT = {"setups": 216, "wins": 15, "errors": 0,
                 "adaptive": {"setups": 36, "wins": 9, "errors": 0,
                              "ties_or_beats_static": "36/36"}}
#: live cells: method -> (launches per ``encode_and_reduce`` call, per
#: ``decode`` call); ``aggregate`` makes one of each.  MSTop-K runs the
#: exact top-k (``kernels/ops.py``), as the JAX package does:
#: ``threshold_mask`` 0.
LIVE_CELLS = {
    "live:powersgd": ({"powersgd_encode": 2}, {"powersgd_decode": 1}),
    "live:signsgd": ({"pack_signs": 1}, {"popcount_votes": 1}),
    "live:qsgd": ({"qsgd_quantize": 1}, {}),
    "live:ef:qsgd": ({"qsgd_quantize": 1}, {}),
    "live:terngrad": ({}, {}),
    "live:randomk": ({}, {}),
    "live:mstopk": ({}, {}),
}


def analytic_phase() -> None:
    """The paper matrix and the adaptive matrix through
    ``Runner(AnalyticBackend())``: the headline must be ANALYTIC_WANT,
    every winner ``bert-base/powersgd-*`` on ``allreduce``, and every
    ``headline_verdicts`` row must pass."""
    from repro_torch.experiments import (AnalyticBackend, Grid, Runner,
                                         headline, headline_verdicts)
    t0 = time.perf_counter()
    results = Runner(AnalyticBackend()).run(
        list(Grid.paper_matrix()) + list(Grid.adaptive_matrix()))
    h = headline(results)
    log(f"[analytic] {len(results)} cells in "
        f"{time.perf_counter() - t0:.1f} s: {h['wins']}/{h['setups']} wins "
        f"({h['by_method']}), {h['errors']} errors; adaptive {h['adaptive']}")
    log(f"[analytic] winners: {h['winners']}")
    bad = [k for k, v in ANALYTIC_WANT.items()
           if ({k2: h[k][k2] for k2 in v} if isinstance(v, dict) else h[k])
           != v]
    if not all(w["setup"].startswith("bert-base/powersgd-")
               and w["comm"] == "allreduce" for w in h["winners"]):
        bad.append("winners")
    for claim, got, want, ok in headline_verdicts(h):
        log(f"[analytic] {'PASS' if ok else 'FAIL'} {claim}: {got} "
            f"(want {want})")
        if not ok:
            bad.append(claim)
    if bad:
        raise AssertionError(f"analytic headline: {bad}")


def live_phase(n: int) -> dict:
    """One ``kind="measured"`` cell per LIVE_CELLS method at ``n``
    elements through ``Runner(MeasuredBackend(device="cuda"))``; each
    kernel's launches must be its count per call times the calls the
    backend made, and ``wire_bytes``, ``rounds`` and ``ratio`` what
    ``CompressionSpec.for_compressor`` derives.  Returns {method: the
    cell's launches}."""
    from repro_torch.core.perfmodel.model import CompressionSpec
    from repro_torch.experiments import (ExperimentSpec, MeasuredBackend,
                                         Runner, make_live_compressor)
    from repro_torch.kernels import build as kbuild
    backend = MeasuredBackend(device="cuda")
    timed = backend.warmup + backend.reps
    calls_enc, calls_dec = 1 + 2 * timed, 2 * timed
    launches = {}
    for method, (per_enc, per_dec) in LIVE_CELLS.items():
        spec = ExperimentSpec(workload="tinyllama-1.1b zero1 bucket",
                              method=method, hardware="h100",
                              kind="measured", n_elements=n)
        kbuild.reset_launches()
        (r,) = Runner(backend).run([spec])
        got = {k: v for k, v in kbuild.LAUNCHES.items() if v}
        if not r.ok:
            raise AssertionError(f"live {method}: {r.error}")
        log(f"[live] {method}: " + json.dumps(r.metrics)
            + f"; launches {got}")
        want = {k: v * calls_enc for k, v in per_enc.items()}
        want.update({k: v * calls_dec for k, v in per_dec.items()})
        cs = CompressionSpec.for_compressor(make_live_compressor(method), n,
                                            0.0)
        m = r.metrics
        if got != want:
            raise AssertionError(f"live {method}: launches {got}, want "
                                 f"{want}")
        if (m["wire_bytes"], m["rounds"], m["ratio"]) != (
                int(cs.total_payload), len(cs.payload_bytes),
                round(cs.compression_ratio(4 * n), 1)):
            raise AssertionError(f"live {method}: wire accounting {m}")
        launches[method] = got
    return launches


#: ``overlap_bench``'s own flags for the full-width train cells
TRAIN_CELL_ARGS = ("--full-size", "--keep-data-axis", "--seq", "512",
                   "--warmup", "1", "--reps", "3")


def train_cell() -> dict:
    """``overlap_bench`` at full width through ``MeasuredBackend``: one
    ``kind="train"`` cell, one worker, ZeRO-1 uncompressed, the aggregator
    on the data axis; returns the record."""
    from repro_torch.experiments import (ExperimentSpec, MeasuredBackend,
                                         Runner)
    backend = MeasuredBackend(device="cuda", worker_args=TRAIN_CELL_ARGS)
    spec = ExperimentSpec(workload="tinyllama-1.1b", method="none",
                          hardware="h100", kind="train", procs=0, workers=1,
                          batch=4, zero1=True)
    (r,) = Runner(backend).run([spec])
    if not r.ok:
        raise AssertionError(f"train cell: {r.error}")
    return r.metrics


#: the adaptive phase: ``resolve_plan`` for full-size tinyllama-1.1b on the
#: paper's hardware preset, and the decision JAX's controller gives there
#: (tests/test_torch_adaptive.py holds this constant to it)
ADAPTIVE_WANT = {"n_dev": 2, "batch": 4, "seq": 512, "scheme": "powersgd",
                 "comm": "auto"}


def adaptive_phase(hist: dict, layout) -> tuple[list, dict]:
    """``resolve_plan`` at ``ADAPTIVE_WANT`` (fatal unless PowerSGD on
    overlapped ZeRO-1), 3 steps of the resolved plan through
    ``train_phase`` (launches checked), then a ``BucketController`` over
    ``layout``'s bucket bytes (p = 2, the paper's preset) fed the measured
    step times, after each run's first, of ``zero1 overlap none`` (as
    syncSGD) and of this run (as PowerSGD): its ``step()`` and
    ``summary()`` are printed, not checked.
    Returns the run's records and launch counts."""
    from repro_torch.adaptive import controller as actl
    from repro_torch.configs import base as cfgs
    from repro_torch.core.perfmodel import calibration as cal
    arch = cfgs.get("tinyllama-1.1b")
    want = ADAPTIVE_WANT
    plan, d = actl.resolve_plan(arch.plan, arch, want["n_dev"],
                                batch=want["batch"], seq=want["seq"])
    log(f"[adaptive] resolve_plan(n_dev={want['n_dev']}, batch "
        f"{want['batch']} x {want['seq']}, the paper's V100 preset): "
        f"scheme={d.scheme} comm={d.comm} predicted {d.t_pred * 1e3:.3f} "
        f"ms/step vs overlapped syncSGD {d.t_base * 1e3:.3f} ms/step; plan "
        f"compression={plan.compression} overlap={plan.overlap} "
        f"zero1={plan.zero1}")
    if (d.scheme, d.comm, plan.compression, plan.overlap, plan.zero1) != (
            want["scheme"], want["comm"], want["scheme"], True, True):
        raise AssertionError(f"adaptive: {d} / {plan}, expected {want} on "
                             f"overlapped ZeRO-1")
    overrides = {f.name: getattr(plan, f.name)
                 for f in dataclasses.fields(plan)
                 if getattr(plan, f.name) != getattr(arch.plan, f.name)}
    n = layout.n_buckets
    history, counts = train_phase(
        "adaptive powersgd", 3, {"powersgd_encode": 2 * n,
                                 "powersgd_decode": n}, 1, "overlap",
        **overrides)
    ctl = actl.BucketController(
        actl.workload_for_arch(arch, want["batch"], want["seq"],
                               cal.PAPER_HW), want["n_dev"], cal.PAPER_HW,
        [layout.dtype.itemsize * k for k in layout.sizes],
        actl._live_candidates(plan, cal.PAPER_HW))
    before = ctl.summary()["schemes"]
    # the steps after each run's first, which carries its one-time
    # allocations and library warm-up (9 s on a fresh process)
    for r in hist["zero1 overlap none"][1:]:
        ctl.observe("syncsgd", r["step_s"])
    for r in history[1:]:
        ctl.observe("powersgd", r["step_s"])
    changed = ctl.step()
    summary = ctl.summary()
    flipped = sum(b["scheme"] == "syncsgd" for b in summary["buckets"])
    log(f"[adaptive] controller over {n} buckets (p={want['n_dev']}): "
        f"{before} before feedback; after the measured step times step() "
        f"-> {changed}, {flipped} of {n} buckets on syncSGD (flipped: "
        f"{flipped > 0}); summary " + json.dumps(summary))
    return history, counts


def adaptive_cell() -> dict:
    """One adaptive ``kind="train"`` cell through ``MeasuredBackend`` at one
    worker, with ``train_cell``'s worker flags; fatal unless the
    controller keeps syncSGD (one worker has no communication to save)."""
    from repro_torch.experiments import (ExperimentSpec, MeasuredBackend,
                                         Runner)
    backend = MeasuredBackend(device="cuda", worker_args=TRAIN_CELL_ARGS)
    spec = ExperimentSpec(workload="tinyllama-1.1b", method="adaptive",
                          scheme="adaptive", hardware="h100", kind="train",
                          procs=0, workers=1, batch=4, zero1=True)
    (r,) = Runner(backend).run([spec])
    if not r.ok:
        raise AssertionError(f"adaptive cell: {r.error}")
    if r.metrics.get("adaptive_choice") != "syncsgd":
        raise AssertionError(f"adaptive cell chose "
                             f"{r.metrics.get('adaptive_choice')!r} at one "
                             f"worker, expected 'syncsgd'")
    return r.metrics


# ------------------------------------------------------------- checkpoint
#: the checkpoint phase: steps of each run, and the batch (from 1) while
#: whose fetch run B sends itself SIGTERM
CKPT_STEPS = 3
CKPT_KILL_AT = 2
#: the checkpoint phase's depth, 6 of tinyllama's 22 layers: at full
#: depth its 19.8 GB took two saves of ~17 s and a restore of ~15 s, at
#: 11 layers the phase 37.4-51.7 s (measured on one H100)
CKPT_LAYERS = 6


class SigtermAt:
    """The batches of ``pipeline``; sends SIGTERM to this process while it
    yields its ``at``-th batch (from 1).  Keeps the pipeline's cursor."""

    def __init__(self, pipeline, at: int):
        self.p, self.at, self.served = pipeline, at, 0

    def __iter__(self):
        return self

    def __next__(self):
        import signal
        self.served += 1
        if self.served == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return next(self.p)

    def cursor(self) -> int:
        return self.p.cursor()

    def seek(self, step: int) -> None:
        self.p.seek(step)


def checkpoint_phase() -> dict:
    """tinyllama-1.1b at full width cut to ``CKPT_LAYERS`` layers, as the
    arch configures it (ZeRO-1, bf16 parameters, the classic step) with
    PowerSGD on the size-1 data axis, in a temporary directory: run A takes ``CKPT_STEPS`` steps; run B, a
    ``Trainer`` with a checkpoint directory, gets SIGTERM from its own data
    iterator at batch ``CKPT_KILL_AT`` and must save that step and return;
    run C, a fresh ``Trainer`` on the directory, restores it and takes the
    remaining steps.  Fatal unless C's losses equal A's and C's final
    state has A's bits (``state_prints``, fingerprints taken on the
    card).  Returns the sizes and times."""
    import resource

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import base as cfgs
    from repro_torch.core import bucketing
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import train_step as ts
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = dataclasses.replace(cfgs.get("tinyllama-1.1b"),
                               n_layers=CKPT_LAYERS)
    n_buckets = bucketing.layout_for(list(Model(
        arch, ShardCtx(param_dtype=torch.bfloat16), device="meta"
    ).parameters()), arch.plan.bucket_mb).n_buckets
    dcfg = DataConfig(vocab=arch.vocab, seq_len=512, global_batch=4, seed=0)

    def trainer(ckpt_dir=None, kill_at=None):
        setup = ts.build(arch, "cuda", compression="powersgd")
        setup.agg_cfg = dataclasses.replace(
            setup.agg_cfg, compress_axes=("data",), raw_axes=())
        data = Pipeline(dcfg, prefetch=0)
        return Trainer(setup, TrainerConfig(
            total_steps=CKPT_STEPS, log_every=1, ckpt_dir=ckpt_dir,
            schedule=ScheduleConfig(peak_lr=3e-4, warmup_steps=1,
                                    total_steps=CKPT_STEPS)),
            SigtermAt(data, kill_at) if kill_at else data)

    def timed(obj, name, into):
        fn = getattr(obj, name)

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        setattr(obj, name, wrapper)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    a = trainer()
    kbuild.reset_launches()
    a.run()
    counts = dict(kbuild.LAUNCHES)
    want = {"powersgd_encode": 2 * n_buckets * CKPT_STEPS,
            "powersgd_decode": n_buckets * CKPT_STEPS}
    if {k: counts.get(k, 0) for k in KERNELS} != {
            k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"checkpoint run A: launches {counts}, "
                             f"expected {want}")
    a_loss = [r["loss"] for r in a.history]
    t0 = time.perf_counter()
    a_prints = state_prints(a.state)
    prints_s = time.perf_counter() - t0
    del a
    free()
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        disk = shutil.disk_usage(d)
        log(f"[ckpt] directory {d}: {disk.free / 1e9:.1f} GB free of "
            f"{disk.total / 1e9:.1f} GB")
        b = trainer(d, kill_at=CKPT_KILL_AT)
        saves, restores = [], []
        timed(b._manager, "save", saves)
        b.run()
        b_steps = [r["step"] for r in b.history]
        if not b.stop_requested or b_steps != list(range(1, CKPT_KILL_AT + 1)) \
                or ckpt.list_steps(d) != [CKPT_KILL_AT]:
            raise AssertionError(f"checkpoint run B: steps {b_steps}, saved "
                                 f"{ckpt.list_steps(d)}, stop "
                                 f"{b.stop_requested}")
        step_dir = os.path.join(d, f"step_{CKPT_KILL_AT:09d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        b_loss = [r["loss"] for r in b.history]
        del b
        free()
        c = trainer(d)
        timed(c._manager, "restore_latest", restores)
        timed(c._manager, "save", saves)
        c.run()
        c_steps = [r["step"] for r in c.history]
        c_loss = [r["loss"] for r in c.history]
        same = state_prints(c.state) == a_prints
        peak = torch.cuda.max_memory_allocated() / 2**30
        del c
        free()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec = {"bytes": nbytes, "save_s": saves, "restore_s": restores,
           "prints_s": prints_s, "peak_gib": peak,
           "host_peak_gib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "a_loss": a_loss, "b_loss": b_loss, "c_loss": c_loss,
           "c_steps": c_steps, "same_state": same}
    log("[ckpt] " + json.dumps(rec))
    if c_steps != list(range(CKPT_KILL_AT + 1, CKPT_STEPS + 1)) \
            or c_loss != a_loss[CKPT_KILL_AT:] \
            or b_loss != a_loss[:CKPT_KILL_AT] or not same:
        raise AssertionError("checkpoint: the resumed run is not the "
                             "uninterrupted one bit for bit")
    log(f"[ckpt] SIGTERM at batch {CKPT_KILL_AT}: saved step "
        f"{CKPT_KILL_AT} ({nbytes / 1e9:.2f} GB, {saves[0]:.1f} s), "
        f"restored in {restores[0]:.1f} s; step {CKPT_STEPS} loss and "
        f"state equal the uninterrupted run's bit for bit; peak "
        f"{peak:.2f} GiB on the card")
    return rec


#: the pod phase: tinyllama-1.1b at full width, cut to POD_LAYERS blocks so
#: that four ranks fit one card, as pod 2 x data 2; ZeRO-1 as the arch
#: configures it, 25 MB leaf-aligned buckets, batch 8 x 512 global.  The
#: worker flags that ``MultiProcessBackend`` does not set from the spec:
POD_LAYERS = 4
POD_WORKER_ARGS = ("--full-width", "--layers", str(POD_LAYERS), "--seq",
                   "512", "--bucket-mb", "25")
POD_TIMEOUT_S = 300


def pod_specs() -> dict:
    """label -> (spec, compress axes, effective schedule, launches per
    compressed bucket and step): the four groups of pod 2 x data 2, then
    ``pod-ring-p2`` (pod 2 x data 1), which makes ``alpha``, ``net_bw``
    and ``dcn_bw`` identifiable together."""
    from repro_torch.experiments import ExperimentSpec
    base = ExperimentSpec(workload="tinyllama-1.1b", method="none",
                          workers=4, procs=2, batch=8, hardware="h100",
                          kind="train", overlap=True, zero1=True)
    rep = dataclasses.replace
    return {
        "none hierarchical:data": (
            rep(base, comm="hierarchical:data", variant="pod-hier"),
            ["pod"], "overlap", {}),
        "none allreduce": (rep(base, comm="allreduce", variant="pod-ring"),
                           ["pod"], "overlap", {}),
        "powersgd pod": (rep(base, method="live:powersgd"), ["pod"],
                         "overlap",
                         {"powersgd_encode": 2, "powersgd_decode": 1}),
        "signsgd all": (rep(base, method="live:signsgd",
                            overrides=(("compress_axes", "all"),)),
                        ["pod", "data"], "serial",
                        {"pack_signs": 1, "popcount_votes": 1}),
        "pod-ring-p2": (rep(base, workers=2, comm="allreduce",
                            variant="pod-ring-p2"), ["pod"], "overlap", {}),
    }


def start_ranks(nproc: int, module: str, args) -> tuple:
    """``torchrun`` of ``module`` on ``nproc`` ranks of this host, in a
    session of its own, started and not waited for (``wait_ranks``).
    Returns (the process, its start time)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", module, *args]
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True), time.perf_counter()


def wait_ranks(started: tuple, label: str,
               timeout: float = POD_TIMEOUT_S) -> tuple[str, float]:
    """Waits for ``start_ranks``' group, killed whole if it outlives
    ``timeout`` seconds from its start; fails unless every rank exits 0.
    Returns (stdout, wall s)."""
    import signal
    proc, t0 = started
    try:
        out, err = proc.communicate(
            timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        # the whole of both streams, which a console tail would cut
        logs = os.path.join(ROOT, "chiprun_out")
        os.makedirs(logs, exist_ok=True)
        with open(os.path.join(logs, f"{label}_ranks.log"), "w") as f:
            f.write(out + "\n" + err)
        raise AssertionError(f"{label}: torchrun exited {proc.returncode} "
                             f"(both streams in chiprun_out/{label}"
                             f"_ranks.log):\n{out[-2000:]}\n{err[-6000:]}")
    return out, wall


def run_ranks(nproc: int, module: str, args, label: str,
              timeout: float = POD_TIMEOUT_S) -> tuple[str, float]:
    """``start_ranks`` then ``wait_ranks``: (stdout, wall s)."""
    return wait_ranks(start_ranks(nproc, module, args), label, timeout)


def pod_phase(kind: str) -> dict:
    """The pod cells of ``pod_specs`` on one card through
    ``Runner(MultiProcessBackend(...))``: one ``train/pod_worker.py``
    process per rank.  Each must give finite losses, the same parameter
    bits on every rank, ``serial`` == ``overlap`` bit for bit,
    ``hierarchical`` and ``gather_all`` within fp32 tolerance of
    ``allreduce`` on one gradient bucket, the kernels' launches per
    compressed bucket and step, and the backends the topology calls for;
    each worker's JSON record is printed.  Then the α–β fit
    (``calibrate_from_results`` from the H100 preset) over the
    uncompressed cells, whose wire bytes are the gradient's (a compressed
    cell's are not), and the model-vs-measured error of each: reported,
    not checked.  Then local SGD through the launcher.  Returns {label:
    the worker's record}."""
    import torch

    from repro_torch.core.perfmodel import calibration as cal
    from repro_torch.core.perfmodel.hardware import H100
    from repro_torch.experiments import (MultiProcessBackend, Runner,
                                         headline)
    cells = pod_specs()
    backend = MultiProcessBackend(reps=1, warmup=1, device="cuda",
                                  pod_timeout=POD_TIMEOUT_S,
                                  worker_args=POD_WORKER_ARGS)
    recs, results = {}, []
    for label, (spec, comp, sched, per_bucket) in cells.items():
        t0 = time.perf_counter()
        (r,) = Runner(backend).run([spec])
        if not r.ok:
            raise AssertionError(f"pod {label}: {r.error}")
        rec = dict(r.metrics, phase_wall_s=time.perf_counter() - t0)
        log(f"[pod] {label}: " + json.dumps(rec))
        share = spec.workers > torch.cuda.device_count()
        want_backends = {"pod": "gloo", "data": "gloo" if share else "nccl",
                         "world": "gloo" if share
                         else "cpu:gloo,cuda:nccl"}
        bad = []
        losses = [x for v in rec["losses"].values() for x in v]
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"losses {rec['losses']}")
        if not rec["params_identical"]:
            bad.append("parameters differ between ranks")
        if not rec["serial_equals_overlap"]:
            bad.append("serial and overlap differ")
        pc = rec["plan_check"]
        if not (pc["hierarchical_close"] and pc["gather_all_close"]):
            bad.append(f"plan check {pc}")
        if rec["backends"] != want_backends:
            bad.append(f"backends {rec['backends']}, want {want_backends}")
        if (rec["compress_axes"], rec["effective_schedule"], rec["device"],
                rec["mesh_shape"]) != (comp, sched, kind,
                                       [spec.procs,
                                        spec.workers // spec.procs]):
            bad.append("compress axes, schedule, device or mesh")
        want = {k: v * rec["n_buckets"] * rec["steps_timed"]
                for k, v in per_bucket.items()}
        if rec["launches"] != want:
            bad.append(f"launches {rec['launches']}, want {want}")
        if bad:
            raise AssertionError(f"pod {label}: " + "; ".join(bad))
        recs[label] = rec
        results.append(r)

    fit = cal.calibrate_from_results(
        [r for r in results if r.spec.is_baseline], base_hw=H100)
    hw = fit.hardware
    log(f"[fit] {fit.n_obs} uncompressed pod cells, gloo over loopback on "
        f"one {kind}: alpha={hw.alpha!r} s net_bw={hw.net_bw!r} B/s "
        f"dcn_bw={hw.dcn_bw!r} B/s")
    for row in fit.rows:
        log(f"[fit] {row['label']}: comm={row['comm']} p={row['p']} "
            f"p_intra={row['p_intra']} measured={row['t_measured_s']!r} s "
            f"model={row['t_model_s']!r} s "
            f"rel_err={row['model_rel_err']!r}")
    log(f"[fit] dcn_bw < net_bw: {hw.dcn_bw < hw.net_bw} (not checked: on "
        f"one card both tiers are gloo over loopback, so the two-tier "
        f"premise cannot show here)")
    h = headline(cal.attach_model_error(results, fit))
    log("[fit] headline measured block: " + json.dumps(h["measured"]))

    # local SGD: 2 ranks as pod 2 x data 1, the parameters averaged over
    # pod after steps 2 and 4 and checked equal there
    out, wall = run_ranks(2, "repro_torch.launch.train", (
        "--mesh", "pod", "--procs", "2", "--local-devices", "1",
        "--sync-every", "2", "--steps", "4", "--log-every", "1"),
        "local SGD")
    log(f"[pod] local SGD, reduced arch, 2 ranks, {wall:.1f} s:\n"
        + out.strip())
    for step in (2, 4):
        if f"step {step}: parameters averaged over pod; the same bits on " \
                f"every pod: True" not in out:
            raise AssertionError(f"local SGD: no agreement after step {step}")
    if "done at step 4" not in out or "nan" in out:
        raise AssertionError("local SGD: the run did not finish cleanly")
    return recs


#: the FSDP phase: four ranks of the pod worker on one card as pod 2 x
#: data 2, qwen2-vl-7b as configured (dp_mode="fsdp", AdamW,
#: remat="full") at full width cut to FSDP_LAYERS block, 25 MB shard
#: buckets, batch 4 x 512 global: one row a rank (two rows put the card
#: at 76.2 GiB in use on an H100 80GB, past the 75 GiB line)
FSDP_LAYERS = 1
FSDP_WORKER_ARGS = ("--procs", "2", "--local-devices", "2", "--arch",
                    VLM_ARCH, "--full-width", "--layers", str(FSDP_LAYERS),
                    "--batch", "4", "--seq", "512", "--bucket-mb", "25",
                    "--json", "--plan", "dp_mode=fsdp")
#: label -> (plan fields and steps of the worker's ``--variant``, FSDP
#: axes, compress axes, launches per shard bucket and step); the
#: variants run in turn in one torchrun group
FSDP_RUNS = {
    "hsdp powersgd": ("compression=powersgd,steps=2", ["data"], ["pod"],
                      {"powersgd_encode": 2, "powersgd_decode": 1}),
    "zero3 none": ("fsdp_shard_pods=true,steps=1", ["pod", "data"], [],
                   {}),
    "hsdp int8 gather": ("gather_quant=int8,steps=1", ["data"], ["pod"],
                         {}),
}
#: the int8 gather's first loss against the plain gather's, same batch
INT8_LOSS_RTOL = 1e-2


def fsdp_phase(kind: str) -> dict:
    """The FSDP cells of ``FSDP_RUNS``: one ``torchrun`` of
    ``train/pod_worker.py`` on 4 ranks of this card, running each as a
    ``--variant`` in turn.  Each must give
    finite losses, the FSDP and compress axes as configured, the same
    shard bits on the ranks with the same index along the FSDP axes,
    every gathered parameter the same on every rank, the leaves FSDP does
    not shard the same on every rank when nothing is compressed, and the
    PowerSGD launches per shard bucket and step; the int8 gather's first
    loss within ``INT8_LOSS_RTOL`` of the plain gather's on the same
    batch.  Prints each rank's peak, the card's memory in use and the
    step times.  Returns {label: the worker's record}."""
    variants = [f"--variant={label}:{fields}"
                for label, (fields, *_) in FSDP_RUNS.items()]
    out, wall = run_ranks(4, "repro_torch.train.pod_worker",
                          (*FSDP_WORKER_ARGS, *variants), "fsdp")
    got = {rec["label"]: rec
           for rec in json.loads(out.strip().splitlines()[-1])["variants"]}
    log(f"[fsdp] {len(got)} variants in one torchrun group of 4 ranks: "
        f"{wall:.1f} s")
    recs = {}
    for label, (_, fsdp, comp, per_bucket) in FSDP_RUNS.items():
        rec = got[label]
        bad = []
        if not all(math.isfinite(x) for x in rec["losses"]):
            bad.append(f"losses {rec['losses']}")
        if (rec["fsdp_axes"], rec["compress_axes"], rec["device"]) != (
                fsdp, comp, kind):
            bad.append(f"axes {rec['fsdp_axes']} / {rec['compress_axes']} "
                       f"or device {rec['device']}")
        if not rec["replicas_identical"]:
            bad.append("shard bits differ between replicas")
        if not rec["gathered_identical"]:
            bad.append("gathered parameters differ between ranks")
        if rec["method"] == "none" and not rec["unsharded_identical"]:
            bad.append("unsharded leaves differ between ranks")
        want = {k: v * rec["n_buckets"] * rec["steps_timed"]
                for k, v in per_bucket.items()}
        if rec["launches"] != want:
            bad.append(f"launches {rec['launches']}, want {want}")
        if bad:
            raise AssertionError(f"fsdp {label}: " + "; ".join(bad))
        log(f"[fsdp] {label}: {rec['n_params']:,} parameters"
            f", fsdp {rec['fsdp_axes']}, compress {rec['compress_axes']}, "
            f"{rec['n_buckets']} shard buckets of {rec['bucket_sizes'][0]:,}"
            f" (last {rec['bucket_sizes'][-1]:,}); losses {rec['losses']}; "
            f"step s {rec['step_s']}; peak GiB per rank "
            f"{rec['peak_mem_gb']}; card in use {rec['card_used_gb']:.2f} "
            f"GiB; replicas identical {rec['replicas_identical']}, gathered "
            f"identical {rec['gathered_identical']}, unsharded identical "
            f"{rec['unsharded_identical']}; launches {rec['launches']}")
        log(f"[fsdp] {label} record: " + json.dumps(rec))
        recs[label] = rec
    plain = recs["hsdp powersgd"]["losses"][0]
    quant = recs["hsdp int8 gather"]["losses"][0]
    if abs(quant - plain) > INT8_LOSS_RTOL * abs(plain):
        raise AssertionError(f"fsdp: int8 gather's first loss {quant} vs "
                             f"the plain gather's {plain}")
    log(f"[fsdp] first loss: plain gather {plain!r}, int8 gather {quant!r} "
        f"(rel {abs(quant - plain) / abs(plain):.3g}), ZeRO-3 "
        f"{recs['zero3 none']['losses'][0]!r}")
    return recs


#: the TP phase: one torchrun of the pod worker on 4 ranks of this card as
#: data 2 x model 2 (``--tp 2``, model innermost), ``tinyllama-1.1b`` at
#: full width and depth on its plan (ZeRO-1, bf16 parameters, SP on), 25
#: MB buckets, the global batch 4 x 512 of step 0 (seed 0) that the
#: one-rank runs of the train phase read first
TP_WORKER_ARGS = ("--procs", "1", "--local-devices", "2", "--tp", "2",
                  "--full-width", "--zero1", "--batch", "4", "--seq", "512",
                  "--bucket-mb", "25", "--json")
PSGD_PER_BUCKET = {"powersgd_encode": 2, "powersgd_decode": 1}
#: the MoE TP cell's depth: at the one-rank phase's 2 blocks its ZeRO-1
#: PowerSGD step held ~19.7 GiB a rank and put the card at 78.93 GiB in
#: use (measured on one H100)
TP_MOE_LAYERS = 1
#: the FSDP x TP cell's depth: at 22 layers a step took 27.8-28.7 s
#: (measured on one H100), gloo carrying every FSDP gather and
#: reduce-scatter
TP_FSDP_LAYERS = 4
#: the hybrid TP cell's depth, 2 of zamba2's 9 groups: at full depth the
#: one-rank ZeRO-1 step peaks at 68.5 GiB (measured on one H100), and four
#: ranks would put about 78 GiB on the card
TP_HYBRID_LAYERS = 12
#: the ZeRO-1 resume cell's depth: at full depth its state (the fp32
#: master/m/v shards and the PowerSGD error feedback of four ranks, the
#: bf16 parameters) would be about 24 GB on disk
TP_CKPT_LAYERS = 4
#: the TP torchrun group's time limit (its cells took 118.6 s before the
#: two resume cells, measured on one H100)
TP_TIMEOUT_S = 450
#: the ssm TP cell's depth, 1 of xLSTM's 3 groups: the sLSTM scan is
#: host-bound (~2 x 10^5 launches a one-rank step, 4.6-8.0 s, measured on
#: one H100), every model rank scans the whole sequence under SP, and
#: four processes share the host
TP_SSM_LAYERS = 8
#: the plans of the one-rank two-step references (``two_step_losses``)
FSDP_PLAN = (("dp_mode", "fsdp"), ("zero1", False))
ZERO1_PLAN = (("dp_mode", "ddp"), ("zero1", True))

#: the TP cells' relative limits on their losses against the one-rank
#: tp = 1 references, each between the gap measured on one H100 and the
#: gap there of a planted fault, the sum over ``model`` skipped in one
#: row-parallel output of the first forward (PERF.md, section 6, PR 25):
#: first losses 5.1e-6 and 6.3e-6 against 1.2e-3 and 1.2e-4; the MoE
#: cell's (local routing under SP) 3.3e-4 against 1.3e-3; the FSDP x TP
#: cell's second loss 1.4e-4 against 5.2e-2 (the activations' gradient
#: not summed over ``model``) and 1.2e-1
TP_RTOL = 3e-5
TP_MOE_RTOL = 6e-4
TP_STEP_RTOL = 2e-3
#: the hybrid cell's first-loss limit (PERF.md, section 6, PR 27): its
#: clean gap, 3.39e-5 on one H100, is bf16 rounding (each model rank
#: rounds its partial block outputs before the sum; at the reduced size
#: on the CPU the gap is 1.2e-4 in bf16 and 0 in fp32), past TP_RTOL;
#: the planted fault (A_log, D, dt_bias of model rank 0 on every rank)
#: gave 1.45e-3
TP_HYBRID_RTOL = 2e-4
#: the one-rank elastic restore's bf16 forward against the FSDP x TP
#: cell's second loss (bf16, tp 2): the same parameters, bit for bit, so
#: the gap is bf16 rounding of each model rank's partial sums, 3.53e-5 on
#: one H100 (PERF.md, section 6, PR 28); its fp32 forward is held to the
#: cell's fp32 forward of the same state within TP_RTOL
TP_ELASTIC_BF16_RTOL = 2e-4

#: label -> (the worker's ``--variant`` fields, the one-rank tp = 1
#: reference (``tp_references``): a run of the train phase by label, whose
#: first loss the cell's is held to, or for a cell cut in depth
#: ("forward", arch, layers, parameter dtype), the loss of one forward
#: pass (``first_loss``), or ("steps", arch, layers, plan), the two
#: losses of the same plan's two steps on one rank (``two_step_losses``);
#: the relative limit of each held loss, the FSDP and compress axes,
#: launches per bucket and step).  The audio and vlm cells read their
#: frontend inputs drawn once for the global batch (seed 0) as the
#: one-rank runs draw them.
TP_RUNS = {
    "tp zero1 powersgd": ("compression=powersgd,steps=2", "zero1 powersgd",
                          (TP_RTOL,), [], ["data"], PSGD_PER_BUCKET),
    # cut to TP_CKPT_LAYERS (full depth: 25.7 s of the group on one H100)
    "tp zero1 overlap powersgd": (
        f"compression=powersgd,overlap=true,serial=true,steps=2,"
        f"layers={TP_CKPT_LAYERS}",
        ("forward", "tinyllama-1.1b", TP_CKPT_LAYERS, "bfloat16"),
        (TP_RTOL,), [], ["data"], PSGD_PER_BUCKET),
    # 30 of the 60 experts on each model rank, cut to TP_MOE_LAYERS
    # blocks; under SP each model rank routes its own tokens with a
    # capacity of its own, another routing than the one-rank pass's
    "ep moe powersgd": (
        f"arch={MOE_ARCH},layers={TP_MOE_LAYERS},dp_mode=ddp,"
        f"compression=powersgd,steps=2",
        ("forward", MOE_ARCH, TP_MOE_LAYERS, "bfloat16"), (TP_MOE_RTOL,),
        [], ["data"], PSGD_PER_BUCKET),
    # uncompressed: after one update a wrong gradient shows in the loss;
    # resumed from its checkpoint of step 1 (global leaves split over
    # data and model, AdamW moments), which tp_elastic restores on one rank
    "tp fsdp none": (f"dp_mode=fsdp,zero1=false,layers={TP_FSDP_LAYERS},"
                     f"steps=2,ckpt=true",
                     ("steps", "tinyllama-1.1b", TP_FSDP_LAYERS, FSDP_PLAN),
                     (TP_RTOL, TP_STEP_RTOL), ["data"], [], {}),
    # classic ZeRO-1 PowerSGD cut to TP_CKPT_LAYERS, resumed from its
    # checkpoint of step 1: the per-rank ZeRO-1 shards and PowerSGD q/err
    # rows under TP
    "tp zero1 powersgd ckpt": (
        f"compression=powersgd,layers={TP_CKPT_LAYERS},steps=2,ckpt=true",
        ("forward", "tinyllama-1.1b", TP_CKPT_LAYERS, "bfloat16"),
        (TP_RTOL,), [], ["data"], PSGD_PER_BUCKET),
    # full width and depth on its plan (ZeRO-1, remat="full"): the
    # two-stack overlapped backward, the memory's tp_copy and the SP slice
    # of the frames and of both stacks' sinusoids
    "tp audio zero1 overlap powersgd": (
        f"arch={AUDIO_ARCH},compression=powersgd,overlap=true,serial=true,"
        f"steps=2", "audio zero1 overlap powersgd", (TP_RTOL,), [],
        ["data"], PSGD_PER_BUCKET),
    # its plan (FSDP over data, TP over model), cut to FSDP_LAYERS: the SP
    # slice of the embeds and M-RoPE under TP
    "tp vlm fsdp none": (
        f"arch={VLM_ARCH},layers={FSDP_LAYERS},dp_mode=fsdp,zero1=false,"
        f"steps=2", ("steps", VLM_ARCH, FSDP_LAYERS, FSDP_PLAN),
        (TP_RTOL, TP_STEP_RTOL), ["data"], [], {}),
    # its plan (ZeRO-1, remat="full") cut to TP_HYBRID_LAYERS: the
    # overlapped hybrid branch under TP, the shared block summed over two
    # groups with their own LoRAs, PowerSGD on the hybrid shard buckets
    "tp hybrid zero1 overlap powersgd": (
        f"arch={HYBRID_ARCH},layers={TP_HYBRID_LAYERS},compression=powersgd,"
        f"overlap=true,serial=true,steps=2",
        ("forward", HYBRID_ARCH, TP_HYBRID_LAYERS, "bfloat16"),
        (TP_HYBRID_RTOL,), [], ["data"], PSGD_PER_BUCKET),
    # its plan (ZeRO-1) cut to TP_SSM_LAYERS, uncompressed: a partial
    # gradient of a replicated leaf (the sLSTM under SP, the mLSTM q/k and
    # gates) moves no forward, only the loss after an update, and a
    # compressed step has no one-rank oracle for that loss
    "tp ssm zero1 none": (
        f"arch={SSM_ARCH},layers={TP_SSM_LAYERS},dp_mode=ddp,"
        f"compression=none,steps=2",
        ("steps", SSM_ARCH, TP_SSM_LAYERS, ZERO1_PLAN),
        (TP_RTOL, TP_STEP_RTOL), [], [], {}),
}
#: the card's memory in use that the TP phase must stay under
TP_CARD_GIB = 75.0


def first_loss(name: str, layers: int, dtype: str) -> float:
    """The first loss of full-width ``name`` cut to ``layers`` blocks on
    one rank, tp = 1: parameters of ``dtype`` drawn from seed 0 as
    ``init_state`` draws them, the global batch 4 x 512 of step 0, one
    forward pass (the reference of a TP cell cut in depth)."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import train_step as ts
    arch = dataclasses.replace(cfgs.get(name), n_layers=layers)
    model = Model(arch, ShardCtx(param_dtype=getattr(torch, dtype)),
                  device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = ts._to_device(batch_at(DataConfig(
        vocab=arch.vocab, seq_len=512, global_batch=4, seed=0), 0),
        torch.device("cuda"))
    with torch.no_grad():
        loss, ntok, _ = model.loss(batch)
        out = (loss / ntok).item()
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_step_losses(name: str, layers: int, plan: tuple) -> list[float]:
    """The two losses of full-width ``name`` cut to ``layers`` blocks on
    one rank, tp = 1, uncompressed, on ``plan`` ((field, value) pairs:
    ``FSDP_PLAN``, on one rank the replicated step, or ``ZERO1_PLAN``):
    ``init_state(seed=0)`` and two steps at lr 1e-4 on the global batch 4
    x 512 of step 0 and its frontend inputs drawn from seed 0 (a vlm
    arch's ``embeds`` and M-RoPE positions), as the pod worker runs
    them."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.launch.inputs import with_frontend_inputs
    from repro_torch.train import train_step as ts
    arch = dataclasses.replace(cfgs.get(name), n_layers=layers)
    setup = ts.build(arch, "cuda", overlap=False, compression="none",
                     **dict(plan))
    state = ts.init_state(setup, seed=0)
    batch = ts._to_device(with_frontend_inputs(arch, batch_at(DataConfig(
        vocab=arch.vocab, seq_len=512, global_batch=4, seed=0), 0), 0),
        torch.device("cuda"))
    step = ts.make_step(setup)
    out = []
    for _ in range(2):
        state, m = step(state, batch, 1e-4)
        out.append(m["loss"].item())
    del setup, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_references(hist: dict) -> dict:
    """``TP_RUNS``' references -> their losses (``hist``: the train
    phase's records by label)."""
    out = {}
    for _, ref, *_ in TP_RUNS.values():
        if isinstance(ref, str):
            out[ref] = [hist[ref][0]["loss"]]
        elif ref[0] == "forward":
            out[ref] = [first_loss(*ref[1:])]
        else:
            out[ref] = two_step_losses(*ref[1:])
    return out


def tp_layouts() -> dict:
    """The TP phase's bucket layouts on a rank of data 2 x model 2 (no
    allocation): the classic ZeRO-1 step's of ``tinyllama-1.1b``, the
    overlapped one's and the resume cell's classic ZeRO-1 one (both cut
    to ``TP_CKPT_LAYERS``), the MoE slice's classic ZeRO-1 one, and the
    overlapped ZeRO-1 ones of the audio cell (``seamless-m4t-medium``)
    and of the hybrid cell (``zamba2-2.7b`` cut to
    ``TP_HYBRID_LAYERS``)."""
    import torch

    from repro_torch.configs import base as cfgs
    from repro_torch.core import bucketing
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap
    ctx = ShardCtx(param_dtype=torch.bfloat16, tp=2, seq_parallel=True)
    dense = Model(cfgs.get("tinyllama-1.1b"), ctx, device="meta")
    moe = Model(dataclasses.replace(cfgs.get(MOE_ARCH),
                                    n_layers=TP_MOE_LAYERS), ctx,
                device="meta")
    audio = Model(cfgs.get(AUDIO_ARCH), ctx, device="meta")
    hybrid = Model(dataclasses.replace(cfgs.get(HYBRID_ARCH),
                                       n_layers=TP_HYBRID_LAYERS), ctx,
                   device="meta")
    cut = Model(dataclasses.replace(cfgs.get("tinyllama-1.1b"),
                                    n_layers=TP_CKPT_LAYERS), ctx,
                device="meta")
    return {"zero1": bucketing.layout_for(list(dense.parameters()), 25),
            "zero1 ckpt": bucketing.layout_for(list(cut.parameters()), 25),
            "overlap": overlap.layout_for_model(cut, 25),
            "moe zero1": bucketing.layout_for(list(moe.parameters()), 25),
            "audio overlap": overlap.layout_for_model(audio, 25),
            "hybrid overlap": overlap.layout_for_model(hybrid, 25)}


def tp_phase(kind: str, first: dict, ckpt_dir: str, smi: str) -> dict:
    """The TP cells of ``TP_RUNS``: one ``torchrun`` of
    ``train/pod_worker.py`` on 4 ranks of this card as data 2 x model 2,
    running each as a ``--variant`` in turn (a ``ckpt=true`` cell saves
    under ``ckpt_dir``). Each must give finite losses;
    the configured axes (``tp`` 2, SP on, the FSDP and compress axes); its
    first losses within their limits of the one-rank tp = 1 reference's
    (``first``: ``TP_RUNS``' reference -> its losses, ``tp_references``);
    the same bits on the ranks with the same model index across ``data``
    (gathered over ``data`` under FSDP); the leaves replicated over
    ``model`` the same bits on every rank; the PowerSGD launches per
    bucket and step; the card under ``TP_CARD_GIB`` in use; and the
    overlapped cell's serial schedule the same bits; a resumed cell
    ``resume_identical``.  Prints each rank's peak, the step times, the
    resumed cells' bytes, seconds and host peaks (with ``smi``, the
    card's name and power limit) and every cell's gaps before it fails on
    any.  Returns {label: the worker's record}."""
    variants = [f"--variant={label}:{fields}"
                for label, (fields, *_) in TP_RUNS.items()]
    out, wall = run_ranks(4, "repro_torch.train.pod_worker",
                          (*TP_WORKER_ARGS, "--ckpt-dir", ckpt_dir,
                           *variants), "tp", TP_TIMEOUT_S)
    got = {rec["label"]: rec
           for rec in json.loads(out.strip().splitlines()[-1])["variants"]}
    log(f"[tp] {len(got)} variants in one torchrun group of 4 ranks "
        f"(data 2 x model 2): {wall:.1f} s")
    recs, failed = {}, []
    for label, (_, ref, rtols, fsdp, comp, per_bucket) in TP_RUNS.items():
        rec = got[label]
        bad = []
        if not all(math.isfinite(x) for x in rec["losses"]):
            bad.append(f"losses {rec['losses']}")
        if (rec["tp"], rec["seq_parallel"], rec["mesh_shape"],
                rec["fsdp_axes"], rec["compress_axes"], rec["device"]) != (
                2, True, [1, 2, 2], fsdp, comp, kind):
            bad.append(f"tp {rec['tp']} sp {rec['seq_parallel']} mesh "
                       f"{rec['mesh_shape']} axes {rec['fsdp_axes']} / "
                       f"{rec['compress_axes']} or device {rec['device']}")
        want_losses = first[ref]
        gaps = [abs(got_l - want_l) / abs(want_l) for got_l, want_l
                in zip(rec["losses"], want_losses)]
        for i, (gap, rtol) in enumerate(zip(gaps, rtols)):
            if not gap <= rtol:
                bad.append(f"loss {i} {rec['losses'][i]!r} vs the one-rank "
                           f"reference's {want_losses[i]!r} ({ref}): rel "
                           f"{gap:.3g} > {rtol:g}")
        if not rec["dp_replicas_identical"]:
            bad.append("the data replicas of a model index differ")
        if not rec["model_replicated_identical"]:
            bad.append("leaves replicated over model differ")
        if rec["serial_equals_overlap"] is False:
            bad.append("serial and overlap differ")
        want = {k: v * rec["n_buckets"] * rec["steps_timed"]
                for k, v in per_bucket.items()}
        if rec["launches"] != want:
            bad.append(f"launches {rec['launches']}, want {want}")
        if rec["card_used_gb"] >= TP_CARD_GIB:
            bad.append(f"card in use {rec['card_used_gb']:.2f} GiB")
        if "ckpt=true" in TP_RUNS[label][0]:
            if rec.get("resume_identical") is not True:
                bad.append(f"resumed run not the uninterrupted one: losses "
                           f"{rec.get('resume_losses')} vs "
                           f"{rec['losses'][1:]}")
            log(f"[tp] {label} checkpoint ({smi}): step 1 "
                f"{rec.get('ckpt_bytes', 0):,} bytes, save "
                f"{rec.get('save_s', 0):.2f} s, restore "
                f"{rec.get('restore_s', 0):.2f} s (slowest rank), resumed "
                f"losses {rec.get('resume_losses')} (uninterrupted "
                f"{rec['losses'][1:]}), identical "
                f"{rec.get('resume_identical')}; host peak GiB per rank "
                f"{rec.get('host_peak_gb')}; device peak GiB per rank "
                f"{rec['peak_mem_gb']}")
        log(f"[tp] {label}: {rec['n_params']:,} parameters ({rec['arch']}, "
            f"{rec['n_layers']} layers), dp_mode {rec['dp_mode']}, zero1 "
            f"{rec['zero1']}, overlap {rec['overlap']}, fsdp "
            f"{rec['fsdp_axes']}, compress {rec['compress_axes']}, "
            f"{rec['n_buckets']} buckets of {rec['bucket_sizes'][0]:,} "
            f"(last {rec['bucket_sizes'][-1]:,}); losses {rec['losses']} "
            f"(one rank, tp 1: {want_losses!r}, rel "
            f"{[float(f'{g:.3g}') for g in gaps]}, limits {list(rtols)}); "
            f"step s {rec['step_s']}; peak GiB per rank "
            f"{rec['peak_mem_gb']}; card in use {rec['card_used_gb']:.2f} "
            f"GiB; data replicas identical {rec['dp_replicas_identical']}, "
            f"{rec['model_replicated_leaves']} model-replicated leaves "
            f"identical {rec['model_replicated_identical']}, serial == "
            f"overlap {rec['serial_equals_overlap']}; launches "
            f"{rec['launches']}")
        log(f"[tp] {label} record: " + json.dumps(rec))
        if bad:
            failed.append(f"tp {label}: " + "; ".join(bad))
        recs[label] = rec
    if failed:
        raise AssertionError(" | ".join(failed))
    return recs


def tp_elastic(rec: dict, smi: str) -> dict:
    """The FSDP x TP cell's checkpoint of step 1 (``rec``: its record,
    written at data 2 x model 2) restored in this process on one rank at
    tp = 1 with no FSDP: its parameters must be the cell's gathered ones
    bit for bit (``ckpt_prints``); its forward on the cell's batch in
    fp32 must give the cell's fp32 forward of the saved state
    (``ckpt_loss_fp32``) within ``TP_RTOL``, and in bf16 the cell's
    second loss within ``TP_ELASTIC_BF16_RTOL``.  Returns the sizes and
    times."""
    import resource

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import base as cfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import train_step as ts
    from repro_torch.train.pod_worker import fingerprint, forward_loss
    dev = torch.device("cuda", 0)
    mesh_mod.init_world(dev)
    try:
        arch = dataclasses.replace(cfgs.get("tinyllama-1.1b"),
                                   n_layers=TP_FSDP_LAYERS)
        setup = ts.build(arch, dev, overlap=False, compression="none",
                         **dict(FSDP_PLAN))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, cursor = CheckpointManager(rec["ckpt_path"], setup).restore(1)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        prints = [fingerprint(p) for p in setup.model.parameters()]
        batch = batch_at(DataConfig(vocab=arch.vocab, seq_len=512,
                                    global_batch=4, seed=0), 0)
        loss = forward_loss(setup, batch, torch.bfloat16)
        loss32 = forward_loss(setup, batch, torch.float32)
        want, want32 = rec["losses"][1], rec["ckpt_loss_fp32"]
        gap = abs(loss - want) / abs(want)
        gap32 = abs(loss32 - want32) / abs(want32)
        same = prints == [tuple(p) for p in rec["ckpt_prints"]]
        out = dict(loss=loss, want=want, gap=gap, loss_fp32=loss32,
                   want_fp32=want32, gap_fp32=gap32, params_identical=same,
                   restore_s=restore_s, cursor=cursor, tp=setup.tp,
                   fsdp_axes=list(setup.fsdp_axes),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   host_peak_gib=resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss / 2**20)
        log(f"[tp elastic] ({smi}) {rec['arch']} {rec['n_layers']} layers, "
            f"written at data 2 x model 2 with FSDP, restored on one rank "
            f"(tp {setup.tp}, fsdp {setup.fsdp_axes}) in {restore_s:.2f} s: "
            f"fp32 forward {loss32!r} vs the cell's {want32!r} (rel "
            f"{gap32:.3g}, limit {TP_RTOL:g}); bf16 forward {loss!r} vs the "
            f"cell's second loss {want!r} (rel {gap:.3g}, limit "
            f"{TP_ELASTIC_BF16_RTOL:g}); parameters the cell's gathered "
            f"bits {same}; peak {out['peak_gib']:.2f} GiB since the build, "
            f"host peak {out['host_peak_gib']:.2f} GiB (this process's, "
            f"every phase)")
        del state, setup, batch
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    bad = []
    if not (same and cursor == 1):
        bad.append(f"parameters differ from the cell's (or cursor {cursor})")
    if not gap32 <= TP_RTOL:
        bad.append(f"fp32 loss {loss32!r} vs {want32!r}: rel {gap32:.3g} > "
                   f"{TP_RTOL:g}")
    if not gap <= TP_ELASTIC_BF16_RTOL:
        bad.append(f"bf16 loss {loss!r} vs {want!r}: rel {gap:.3g} > "
                   f"{TP_ELASTIC_BF16_RTOL:g}")
    if bad:
        raise AssertionError("tp elastic: " + "; ".join(bad))
    return out


# --------------------------------------------------------------- serving
#: the serving cells' weights: ``serve_params`` from this seed
SERVE_SEED = 0
#: the one-rank Engine cells: the JAX launcher's default cache length,
#: ``max_new`` and four requests with prompts of three lengths
SERVE_CACHE = 256
SERVE_MAX_NEW = 16
SERVE_PROMPTS = (32, 100, 128, 128)
#: the MoE and vlm cells' depths, 12 of 24 and 14 of 28 blocks (at full
#: depth, 26.66 and 14.18 GiB of bf16 parameters, the cells took 7.6-14.0
#: and 3.7-4.1 s on one H100): cut first for chip_smoke's time limit
SERVE_MOE_LAYERS = 12
SERVE_VLM_LAYERS = 14
#: the vlm cell: batch 4 x 128 (an image of 64 patches, then text) and
#: the decode steps of the vlm and four-rank cells
SERVE_VLM_BATCH, SERVE_VLM_PROMPT = 4, 128
SERVE_STEPS = 8
#: the prefill -> decode consistency limit: a decode step's logits
#: against a fresh prefill over the same tokens, max |diff| over
#: max(1, max |prefill|), in fp32 (weights, compute and cache; in bf16 the
#: MoE's routing flips on near-ties and its clean gap passes the planted
#: fault's) (PERF.md §6, PR 29)
SERVE_CONSIST_RTOL = 1e-3
#: the four-rank cells on one card as data 2 x model 2, one torchrun
#: group: label -> (arch, layers (None: all), global batch, prompt,
#: cache length, dtype).  An MoE cell runs at the no-drop capacity
#: (``no_drop``), in fp32 and in bf16 (as JAX serves); its prompt of 64
#: keeps the fp32 cell under ``TP_CARD_GIB``.  In bf16 the partial sums
#: of four ranks can flip a near-tied pick (0.186 at one step of 9,
#: PR 29), so an MoE cell's rows are held where they picked the one-rank
#: run's experts (``serve_route_gaps``)
SERVE_GROUP = {
    "serve tp": ("tinyllama-1.1b", None, 4, 128, 256, "bfloat16"),
    "serve cp": ("tinyllama-1.1b", None, 1, 600, 1024, "bfloat16"),
    "serve fsdp": ("qwen3-32b", 2, 4, 128, 256, "bfloat16"),
    "serve moe2d": ("arctic-480b", 1, 4, 64, 256, "float32"),
    "serve moe2d bf16": ("arctic-480b", 1, 4, 64, 256, "bfloat16"),
}
#: each four-rank cell's logits against the one-rank run of the same
#: global parameters, every step: max |diff| over max(1, max |one rank|),
#: by dtype: clean 7.1e-3 to 2.07e-2 in bf16, 1.46e-6 to 4.11e-6 in fp32;
#: planted faults 0.354 to 0.558 (PERF.md §6, PR 29)
SERVE_GROUP_RTOL = {"bfloat16": 6e-2, "float32": 1e-4}
#: by dtype, the share of an MoE cell's rows (steps x batch) that may
#: pick other experts than the one-rank run: in bf16 a near tie flips
#: now and then, a fault before the router moves every row; in fp32 none
SERVE_FLIP_SHARE = {"bfloat16": 0.25, "float32": 0.0}
SERVE_TIMEOUT_S = 300
#: the file the main process writes once the references are saved and
#: its memory is freed: the four ranks wait for it
SERVE_READY = "references_ready"


def serve_arch(name: str, layers: "int | None" = None):
    """The full-width arch ``name``, cut to ``layers`` when given."""
    from repro_torch.configs import base as cfgs
    arch = cfgs.get(name)
    return dataclasses.replace(arch, n_layers=layers) if layers else arch


def no_drop(arch):
    """``arch`` with an MoE capacity factor of experts / top-k: every
    expert has a slot for every token, so no pick is dropped at any batch
    or mesh.  Other archs as they are."""
    if not arch.moe.n_experts:
        return arch
    return dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, capacity_factor=arch.moe.n_experts / arch.moe.top_k))


def serve_setup(arch, batch: int, cache_len: int, device,
                dtype: str = "bfloat16"):
    """``build_serve`` on the current mesh and ``serve_params`` from
    ``SERVE_SEED``: bf16 parameters, compute and cache, as the JAX
    package serves, or all fp32 with ``dtype="float32"``."""
    import torch

    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving import serve_step as ss
    dt = getattr(torch, dtype)
    setup = ss.build_serve(arch, ShapeConfig("serve", "decode", cache_len,
                                             batch), param_dtype=dt,
                           device=device, compute_dtype=dt)
    setup.cache_dtype = dt
    ss.serve_params(setup, torch.Generator(
        device=setup.device).manual_seed(SERVE_SEED))
    return setup


def serve_prompt(vocab: int, b: int, s: int, seed: int):
    import numpy as np
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def serve_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


def route_probe() -> tuple:
    """Records the router logits of every ``moe._route`` call in this
    process (fp32, the real experts, kept on the device: no host sync)
    until undone.  Returns (the list of calls, the function that takes
    the probe out)."""
    from repro_torch.models import moe
    calls, route = [], moe._route

    def probe(router_w, x, mc, e_pad):
        out = route(router_w, x, mc, e_pad)
        calls.append(out[2][:, :mc.n_experts].detach().clone())
        return out
    moe._route = probe
    return calls, lambda: setattr(moe, "_route", route)


def routed_rows(calls: list, b: int) -> list:
    """Per call of a one-layer MoE model (prefill, then each decode
    step), the (b, E) router logits of each row's last token, the one
    whose logits the call returns: at one layer the cache holds K and V
    from before the MoE, so that token's pick alone moves those logits."""
    return [c.view(b, -1, c.shape[-1])[:, -1].float().cpu() for c in calls]


def serve_route_gaps(mine, ref, mine_r, ref_r, top_k: int) -> tuple:
    """Per step, the gap of an MoE cell's logits over the rows whose last
    token picked the one-rank run's top-k experts (0 when none did), and
    the rows that picked others: (step, row, the one-rank router margin
    between its k-th and (k+1)-th logit, the largest router-logit
    difference on the row).  A pick flips only where that difference is
    at least half the margin: the witness of a near tie."""
    if not len(mine) == len(ref) == len(mine_r) == len(ref_r):
        raise AssertionError("the route check reads one router call a "
                             "model call: a one-layer MoE cell")
    held, flips = [], []
    for i, (a, b, ra, rb) in enumerate(zip(mine, ref, mine_r, ref_r)):
        pick_a = ra.topk(top_k).indices.sort(-1).values
        pick_b = rb.topk(top_k).indices.sort(-1).values
        same = (pick_a == pick_b).all(-1)
        top = rb.topk(top_k + 1).values
        for r in (~same).nonzero().flatten().tolist():
            flips.append(dict(step=i, row=r, margin=float(
                top[r, top_k - 1] - top[r, top_k]), router_diff=float(
                (ra[r] - rb[r]).abs().max())))
        held.append(serve_gap(a[same], b[same]) if bool(same.any())
                    else 0.0)
    return held, flips


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def serve_run(setup, first: dict, steps: int, fed=None,
              more=None) -> dict:
    """Prefill ``first`` (a global batch), then ``steps`` decode steps
    through ``make_prefill`` / ``make_decode``: each step feeds the
    greedy token of the last logits, or ``fed[i]`` (B,) when given;
    ``more(i)`` adds inputs to step ``i`` (the vlm positions).  Returns
    the logits of every call on the host (fp32), the greedy tokens of
    each, and the prefill and per-step decode seconds (synchronised)."""
    import numpy as np

    from repro_torch.serving import serve_step as ss
    dev = setup.device
    prefill, decode = ss.make_prefill(setup), ss.make_decode(setup)
    b = setup.global_batch
    s = next(iter(first.values())).shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(first)
    _sync(dev)
    out = {"prefill_s": time.perf_counter() - t0, "decode_s": [],
           "logits": [logits.float().cpu()], "greedy": []}
    cur = np.full((b,), s, np.int32)
    for i in range(steps):
        tok = logits[:, :setup.arch.vocab].argmax(-1).cpu().numpy()
        out["greedy"].append(tok.tolist())
        batch = {"tokens": (tok if fed is None else fed[i])[:, None],
                 "cur_len": cur}
        if more is not None:
            batch.update(more(i))
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = decode(cache, batch)
        _sync(dev)
        out["decode_s"].append(time.perf_counter() - t0)
        out["logits"].append(logits.float().cpu())
        cur = cur + 1
    out["greedy"].append(logits[:, :setup.arch.vocab].argmax(
        -1).cpu().numpy().tolist())
    return out


def serve_consistency(arch, first: dict, step: dict, whole: dict,
                      device) -> float:
    """``arch`` in fp32 (weights from ``SERVE_SEED``, compute and cache):
    a decode step after the prefill of ``first`` against a fresh prefill
    of ``whole`` (the same tokens and one more; a function of the fp32
    model for inputs that read its weights), the gap of the last
    position's logits.  The inputs are on the card already."""
    b = next(iter(first.values())).shape[0]
    setup = serve_setup(arch, b, SERVE_CACHE, device, "float32")
    model, dt = setup.model, setup.cache_dtype
    if callable(whole):
        whole = whole(model)
    _, cache = model.prefill(first, model.new_cache(b, SERVE_CACHE, dt))
    got, _ = model.decode(cache, step)
    want, _ = model.prefill(whole, model.new_cache(b, SERVE_CACHE, dt))
    del setup, model, cache
    serve_free()
    return serve_gap(got, want)


def serve_decode_probe(model, first: dict, step: dict,
                       cache_len: int) -> dict:
    """One ``Model.decode`` after a prefill, its inputs on the card
    already, under the sync debug mode "error" (fatal on a host sync);
    then the same step again under the profiler: returns its kernel count
    and device ms (``kernel_profile``)."""
    import torch
    b = next(iter(first.values())).shape[0]
    _, cache = model.prefill(first, model.new_cache(b, cache_len))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode(cache, step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return kernel_profile(lambda: model.decode(cache, step))


def decode_profile_text(prof: "dict | None", decode_ms: float) -> str:
    """The log's words for ``serve_decode_probe``'s profile beside the
    median decode step's wall ms."""
    if not prof:
        return "decode not profiled"
    return (f"one decode step under the profiler: {prof['kernels']} "
            f"kernels, {prof['ms']:.2f} device ms ({prof['gemm_ms']:.2f} "
            f"of GEMMs), idle share of the median step "
            f"{1 - prof['ms'] / decode_ms:.3f}")


def serve_free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_engine_cell(label: str, arch, smi: str,
                      device="cuda") -> dict:
    """``arch`` on one rank through the Engine: ``len(SERVE_PROMPTS)``
    requests (prompts of ``SERVE_PROMPTS`` tokens, ``SERVE_MAX_NEW`` new
    tokens each, cache ``SERVE_CACHE``), generated twice (the same greedy
    tokens required); the prefill and decode calls timed; one
    ``Model.decode`` under the sync debug mode "error" and one under the
    profiler (``serve_decode_probe``); then, on an fp32
    copy of the arch from the same seed, one decode step against a fresh
    prefill (``SERVE_CONSIST_RTOL``; the MoE family at its no-drop
    capacity: at the config's, the prompt's tokens crowd into the same
    experts and the prefill drops picks that decode keeps)."""
    import torch

    from repro_torch.serving.engine import Engine, Request
    dev = torch.device(device)
    t_cell = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup = serve_setup(arch, len(SERVE_PROMPTS), SERVE_CACHE, dev)
    setup_s = time.perf_counter() - t_cell
    model = setup.model
    rows = [serve_prompt(arch.vocab, 1, n, 100 + i)[0].tolist()
            for i, n in enumerate(SERVE_PROMPTS)]
    eng = Engine(setup)
    calls = {"prefill": [], "decode": []}

    def timed(fn, into):
        def run(*args):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(dev)
            into.append(time.perf_counter() - t0)
            return out
        return run
    eng._prefill = timed(eng._prefill, calls["prefill"])
    eng._decode = timed(eng._decode, calls["decode"])
    runs = []
    for _ in range(2):
        reqs = [Request(i, p, max_new=SERVE_MAX_NEW)
                for i, p in enumerate(rows)]
        _sync(dev)
        t0 = time.perf_counter()
        done = eng.generate(reqs)
        _sync(dev)
        runs.append(([r.out for r in done], time.perf_counter() - t0))
    tokens = sum(len(o) for o in runs[1][0])
    b, s = len(rows), 128
    toks = torch.as_tensor(serve_prompt(arch.vocab, b, s + 1, 7),
                           device=dev)
    first, whole = {"tokens": toks[:, :s]}, {"tokens": toks}
    step = {"tokens": toks[:, s:], "cur_len": torch.full(
        (b,), s, dtype=torch.int32, device=dev)}
    prof = serve_decode_probe(model, first, step, SERVE_CACHE) \
        if dev.type == "cuda" else None
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 \
        if dev.type == "cuda" else None
    del eng, setup, model
    serve_free()
    gap = serve_consistency(no_drop(arch), first, step, whole, dev)
    rec = dict(
        label=label, arch=arch.name, n_layers=arch.n_layers,
        n_params=n_params, batch=b, prompts=list(SERVE_PROMPTS),
        max_new=SERVE_MAX_NEW, cache_len=SERVE_CACHE,
        same_tokens=runs[0][0] == runs[1][0],
        prefill_ms=[1e3 * x for x in calls["prefill"]],
        decode_ms_median=1e3 * statistics.median(calls["decode"][-15:]),
        decode_ms=[1e3 * x for x in calls["decode"]],
        generate_s=[w for _, w in runs], tokens=tokens,
        tokens_per_s=tokens / runs[1][1], consistency_gap=gap,
        decode_profile=prof, setup_s=setup_s, peak_gib=peak,
        wall_s=time.perf_counter() - t_cell)
    log(f"[{label}] ({smi}) {arch.name} {arch.n_layers} layers "
        f"({n_params:,} parameters, bf16), Engine: {b} requests of "
        f"{list(SERVE_PROMPTS)} tokens, {SERVE_MAX_NEW} new, cache "
        f"{SERVE_CACHE}: prefill ms {[round(x, 2) for x in rec['prefill_ms']]}"
        f", decode ms a token (median) {rec['decode_ms_median']:.2f}, "
        f"{tokens} tokens in {runs[1][1]:.3f} s = "
        f"{rec['tokens_per_s']:.1f} tokens/s; "
        f"{decode_profile_text(prof, rec['decode_ms_median'])}; the two "
        f"runs' tokens equal {rec['same_tokens']}; decode syncs none; peak "
        f"{peak or 0:.2f} GiB; fp32 decode vs a fresh prefill {gap:.3g} "
        f"(limit {SERVE_CONSIST_RTOL:g}); setup {setup_s:.1f} s, cell "
        f"{rec['wall_s']:.1f} s; first request -> {runs[0][0][0]}")
    return rec


def serve_vlm_cell(smi: str, device="cuda") -> dict:
    """``qwen2-vl-7b`` at full width cut to ``SERVE_VLM_LAYERS`` on one
    rank through ``Model.prefill`` and ``Model.decode`` (the Engine passes
    only tokens): seeded ``embeds`` of batch ``SERVE_VLM_BATCH`` x
    ``SERVE_VLM_PROMPT`` and M-RoPE positions (an image, then text),
    ``SERVE_STEPS`` greedy decode steps at the text positions after
    them; the same sync and fp32 consistency checks as the Engine cells
    (the decoded token enters the fresh prefill as its table row)."""
    import torch

    from repro_torch.launch.inputs import vlm_positions
    dev = torch.device(device)
    t_cell = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    arch = serve_arch(VLM_ARCH, SERVE_VLM_LAYERS)
    b, s = SERVE_VLM_BATCH, SERVE_VLM_PROMPT
    setup = serve_setup(arch, b, SERVE_CACHE, dev)
    setup_s = time.perf_counter() - t_cell
    model = setup.model
    gen = torch.Generator().manual_seed(23)
    embeds = torch.randn(b, s, arch.d_model, generator=gen)
    mrope = vlm_positions(b, s + SERVE_STEPS + 1)
    run = serve_run(setup, {"embeds": embeds,
                            "mrope_positions": mrope[..., :s]},
                    SERVE_STEPS, more=lambda i: {
                        "mrope_positions": mrope[..., s + i:s + i + 1]})
    finite = all(bool(torch.isfinite(x).all()) for x in run["logits"])
    tok = torch.as_tensor(run["greedy"][0], device=dev)
    first = {"embeds": embeds.to(dev),
             "mrope_positions": mrope[..., :s].to(dev)}
    step = {"tokens": tok[:, None], "cur_len": torch.full(
        (b,), s, dtype=torch.int32, device=dev),
        "mrope_positions": mrope[..., s:s + 1].to(dev)}

    def whole(m):
        row = m.embed.table.detach()[tok][:, None].float()
        return {"embeds": torch.cat([first["embeds"], row], 1),
                "mrope_positions": mrope[..., :s + 1].to(dev)}
    prof = serve_decode_probe(model, first, step, SERVE_CACHE) \
        if dev.type == "cuda" else None
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 \
        if dev.type == "cuda" else None
    del setup, model
    serve_free()
    gap = serve_consistency(arch, first, step, whole, dev)
    total = run["prefill_s"] + sum(run["decode_s"])
    rec = dict(label="serve vlm", arch=arch.name, n_layers=arch.n_layers,
               n_params=n_params, batch=b, prompt=s, steps=SERVE_STEPS,
               finite=finite, prefill_ms=1e3 * run["prefill_s"],
               decode_ms_median=1e3 * statistics.median(run["decode_s"]),
               tokens_per_s=b * SERVE_STEPS / total, consistency_gap=gap,
               decode_profile=prof, setup_s=setup_s, peak_gib=peak,
               wall_s=time.perf_counter() - t_cell)
    log(f"[serve vlm] ({smi}) {arch.name} {arch.n_layers} layers "
        f"({n_params:,} parameters, bf16), Model.prefill of {b} x {s} "
        f"embeds with M-RoPE positions, {SERVE_STEPS} decode steps: "
        f"prefill {rec['prefill_ms']:.2f} ms, decode ms a token (median) "
        f"{rec['decode_ms_median']:.2f}, {rec['tokens_per_s']:.1f} tokens/s;"
        f" {decode_profile_text(prof, rec['decode_ms_median'])}; finite "
        f"{finite}; decode syncs none; peak {peak or 0:.2f} GiB; "
        f"fp32 decode vs a fresh prefill {gap:.3g} (limit "
        f"{SERVE_CONSIST_RTOL:g}); setup {setup_s:.1f} s, cell "
        f"{rec['wall_s']:.1f} s")
    return rec


def serve_group_inputs(label: str, dtype: str = "auto") -> tuple:
    """(arch, global batch, cache length, the prompt batch, dtype) of a
    four-rank cell; ``dtype`` "auto" is the cell's own."""
    name, layers, b, s, cache_len, own = SERVE_GROUP[label]
    arch = no_drop(serve_arch(name, layers))
    return (arch, b, cache_len, serve_prompt(arch.vocab, b, s, 31),
            own if dtype == "auto" else dtype)


def serve_references(work: str, device="cuda", dtype: str = "auto",
                     cells=tuple(SERVE_GROUP)) -> None:
    """Each four-rank cell's one-rank run (the same global parameters,
    depth, prompt and dtype; greedy decode; an MoE cell's router rows,
    ``routed_rows``) in this process, saved under ``work`` for the group
    and freed before the group goes on."""
    import torch
    for label in cells:
        arch, b, cache_len, prompt, dt = serve_group_inputs(label, dtype)
        setup = serve_setup(arch, b, cache_len, device, dt)
        calls, undo = route_probe()
        try:
            run = serve_run(setup, {"tokens": prompt}, SERVE_STEPS)
        finally:
            undo()
        ref = {"logits": run["logits"], "greedy": run["greedy"]}
        if calls:
            ref["router"] = routed_rows(calls, b)
        torch.save(ref, os.path.join(work, label.replace(" ", "_") + ".pt"))
        del setup
        serve_free()


def serve_fault(fault: str):
    """Plants ``fault`` in this process's port (monkeypatched, for the
    limits probe; ``"none"`` plants nothing): ``"off0"`` every rank's
    cache span at offset 0; ``"nolse"`` no log-sum-exp merge of the
    context-parallel attention; ``"nopsum2d"`` no sum over ``model`` after
    the 2-D layout's down projection; ``"nowrite"`` decode's token not
    written into the cache.  Returns a function that takes it out."""
    import types

    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tf
    module, name, value = {
        "none": (tf, "cache_offset", tf.cache_offset),
        "off0": (tf, "cache_offset", lambda n, ctx: 0),
        "nolse": (attention, "coll", types.SimpleNamespace(
            pmax=lambda t, axes: t, psum=lambda t, axes: t)),
        "nopsum2d": (moe, "tp_reduce", lambda x, ctx, **kw: x),
        "nowrite": (tf, "cache_write", lambda cache, k, v, st, ctx, w=(
            tf.cache_write): None if st.mode == "decode"
            else w(cache, k, v, st, ctx))}[fault]
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def serve_worker(work: str, device: str = "cuda", dtype: str = "auto",
                 fault: str = "none", cells: str = "") -> int:
    """One rank of the four-rank serving group (``torchrun``, data 2 x
    model 2, gloo): the ``SERVE_GROUP`` cells (``cells``, comma-separated,
    or all) from the same seed in ``dtype`` ("auto": each cell's own),
    fed the one-rank run's greedy tokens, with ``fault`` planted
    (``serve_fault``); rank 0 saves the logits and prints one JSON line of
    records."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    serve_fault(fault)
    dev = mesh_mod.local_device(device)
    mesh_mod.init_world(dev)
    mesh_mod.init_mesh(2, dev)
    rank = dist.get_rank()
    recs = []
    # the group starts while this script's main process still runs its
    # one-rank cells and the references; it holds the card until they end
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(work, SERVE_READY)):
        if time.perf_counter() - t0 > SERVE_TIMEOUT_S:
            raise TimeoutError("no serve references")
        time.sleep(0.2)
    try:
        for label in (cells.split(",") if cells else SERVE_GROUP):
            arch, b, cache_len, prompt, dt = serve_group_inputs(label,
                                                                dtype)
            ref = torch.load(os.path.join(
                work, label.replace(" ", "_") + ".pt"))
            fed = [np.asarray(t) for t in ref["greedy"]]
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            t0 = time.perf_counter()
            setup = serve_setup(arch, b, cache_len, dev, dt)
            setup_s = time.perf_counter() - t0
            calls, undo = route_probe()
            try:
                run = serve_run(setup, {"tokens": prompt}, SERVE_STEPS,
                                fed=fed)
            finally:
                undo()
            row0 = 0 if setup.context_parallel else \
                mesh_mod.rank(setup.dp_axes) * setup.batch_local
            everyone = [None] * dist.get_world_size()
            used = None
            if dev.type == "cuda":
                free, total = torch.cuda.mem_get_info(dev)
                used = (total - free) / 2**30
            dist.all_gather_object(everyone, dict(
                greedy=run["greedy"], used=used, row0=row0,
                router=routed_rows(calls, setup.batch_local),
                peak=(torch.cuda.max_memory_allocated(dev) / 2**30
                      if dev.type == "cuda" else None)))
            dist.barrier()
            wall = time.perf_counter() - t0
            if rank == 0:
                router = None
                if calls:       # each call's rows, placed by their ranks
                    router = [torch.zeros(b, arch.moe.n_experts)
                              for _ in everyone[0]["router"]]
                    for e in everyone:
                        for whole, part in zip(router, e["router"]):
                            whole[e["row0"]:e["row0"] + len(part)] = part
                torch.save({"logits": run["logits"], "router": router},
                           os.path.join(work, "group_" + label.replace(
                               " ", "_") + ".pt"))
                recs.append(dict(
                    label=label, arch=arch.name, n_layers=arch.n_layers,
                    dtype=dt,
                    batch=b, prompt=prompt.shape[1], cache_len=cache_len,
                    context_parallel=setup.context_parallel,
                    fsdp_axes=list(setup.ctx.fsdp_axes),
                    moe_ep_axis=setup.ctx.moe_ep_axis, tp=setup.ctx.tp,
                    cache_len_local=setup.cache_len_local,
                    same_greedy=all(e["greedy"] == everyone[0]["greedy"]
                                    for e in everyone),
                    prefill_ms=1e3 * run["prefill_s"],
                    decode_ms_median=1e3 * statistics.median(
                        run["decode_s"]),
                    setup_s=setup_s, wall_s=wall,
                    peak_gib=[e["peak"] for e in everyone],
                    card_used_gib=max((e["used"] or 0) for e in everyone)))
            del setup, run
            serve_free()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"serve": recs}), flush=True)
    return 0


SERVE_LAYOUT = {"serve tp": (False, [], None),
                "serve cp": (True, [], None),
                "serve fsdp": (False, ["data"], None),
                "serve moe2d": (False, [], "data"),
                "serve moe2d bf16": (False, [], "data")}


def serve_group(work: str, smi: str, dtype: str = "auto",
                fault: str = "none", cells=tuple(SERVE_GROUP),
                device: str = "cuda", before=None) -> tuple[dict, list]:
    """One ``torchrun`` group of four ranks on this card running
    ``cells`` (``serve_worker``) in ``dtype`` ("auto": each cell's own)
    with ``fault`` planted.  This process (which must hold no process
    group: it makes and ends its own) first runs ``before()`` (the timed
    one-rank cells, alone on the card and the host), then starts the
    ranks and, while they start, runs the cells' one-rank references,
    frees the card and lets the ranks go on (``SERVE_READY``).  Returns
    (the records by label, each with its per-step ``gaps`` to the
    reference (the MoE cells also the ``held_gaps`` and ``flips`` of
    ``serve_route_gaps``), and the failed checks: a gap over
    ``SERVE_GROUP_RTOL`` of its dtype (of an MoE cell, on the rows that
    picked the one-rank run's experts), more flipped picks than
    ``SERVE_FLIP_SHARE`` of its dtype, non-finite logits, the ranks' greedy tokens
    apart, another layout than the cell's, the card at ``TP_CARD_GIB``
    or more)."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    import signal
    started = None
    try:
        mesh_mod.init_world(torch.device(device))
        try:
            if before is not None:
                before()
            started = start_ranks(4, "chip_smoke", [
                "--serve-worker", work, device, dtype, fault,
                ",".join(cells)])
            t0 = time.perf_counter()
            serve_references(work, device, dtype, cells)
            ref_s = time.perf_counter() - t0
        finally:
            torch.distributed.destroy_process_group()
            serve_free()
        open(os.path.join(work, SERVE_READY), "w").close()
    except BaseException:
        if started is not None:
            os.killpg(started[0].pid, signal.SIGKILL)
            started[0].communicate()
        raise
    out, wall = wait_ranks(started, f"serve_{fault}", SERVE_TIMEOUT_S)
    got = {r["label"]: r for r in json.loads(
        out.strip().splitlines()[-1])["serve"]}
    log(f"[serve] {dtype}, fault {fault}: one-rank references in "
        f"{ref_s:.1f} s; {len(got)} cells in one torchrun group of 4 ranks "
        f"(data 2 x model 2) in {wall:.1f} s from its start")
    failed = []
    for label in cells:
        rec = got[label]
        stem = label.replace(" ", "_") + ".pt"
        ref = torch.load(os.path.join(work, stem))
        group = torch.load(os.path.join(work, "group_" + stem))
        mine = group["logits"]
        gaps = [serve_gap(a, b) for a, b in zip(mine, ref["logits"])]
        rec["gaps"] = held = gaps
        rtol = SERVE_GROUP_RTOL[rec["dtype"]]
        bad = []
        routed = ""
        if "router" in ref:
            top_k = serve_group_inputs(label)[0].moe.top_k
            held, flips = serve_route_gaps(mine, ref["logits"],
                                           group["router"], ref["router"],
                                           top_k)
            rec["held_gaps"], rec["flips"] = held, flips
            n_rows = len(mine) * mine[0].shape[0]
            share = SERVE_FLIP_SHARE[rec["dtype"]]
            if len(flips) > share * n_rows:
                bad.append(f"{len(flips)} of {n_rows} rows picked other "
                           f"experts than one rank (at most {share:g})")
            routed = (f"; on the rows that picked one rank's experts "
                      f"{[float(f'{g:.3g}') for g in held]}, flipped "
                      f"picks {len(flips)} of {n_rows} rows "
                      f"{json.dumps(flips)}")
        bad += [f"step {i}: {g:.3g} > {rtol:g}"
                for i, g in enumerate(held) if not g <= rtol]
        if not all(bool(torch.isfinite(x).all()) for x in mine):
            bad.append("non-finite logits")
        if not rec["same_greedy"]:
            bad.append("the ranks' greedy tokens differ")
        if (rec["context_parallel"], rec["fsdp_axes"], rec["moe_ep_axis"],
                rec["tp"]) != (*SERVE_LAYOUT[label], 2):
            bad.append(f"layout {rec}")
        if rec["card_used_gib"] >= TP_CARD_GIB:
            bad.append(f"card in use {rec['card_used_gib']:.2f} GiB")
        log(f"[{label}] ({smi}) {rec['dtype']}, fault {fault}: "
            f"{rec['arch']} "
            f"{rec['n_layers']} layers, batch {rec['batch']} x "
            f"{rec['prompt']}, cache {rec['cache_len']} "
            f"({rec['cache_len_local']} a rank), context parallel "
            f"{rec['context_parallel']}, fsdp {rec['fsdp_axes']}, experts "
            f"over {rec['moe_ep_axis']}, tp {rec['tp']}: prefill "
            f"{rec['prefill_ms']:.1f} ms, decode ms (median) "
            f"{rec['decode_ms_median']:.1f}; logits vs one rank per step "
            f"{[float(f'{g:.3g}') for g in gaps]}{routed} (limit "
            f"{rtol:g}); greedy tokens equal on every rank "
            f"{rec['same_greedy']}; peak GiB a rank "
            f"{[p and round(p, 2) for p in rec['peak_gib']]}; card in use "
            f"{rec['card_used_gib']:.2f} GiB; setup {rec['setup_s']:.1f} s, "
            f"wall_s {rec['wall_s']:.1f}")
        if bad:
            failed.append(f"{label}: " + "; ".join(bad))
    return got, failed


def serve_phase(kind: str, smi: str) -> dict:
    """The serving slice.  On one rank, alone on the card:
    ``tinyllama-1.1b`` at full width and depth and ``qwen2-moe-a2.7b`` at
    full width (``SERVE_MOE_LAYERS``) through the Engine
    (``serve_engine_cell``), ``qwen2-vl-7b`` (``SERVE_VLM_LAYERS``)
    through ``Model.prefill`` and ``Model.decode`` (``serve_vlm_cell``).
    Then the four-rank cells of ``SERVE_GROUP`` against their one-rank
    runs (``serve_group``), whose ranks start while this process runs
    the references.  No compression kernel runs.  Returns the records by
    label."""
    from repro_torch.kernels import build as kbuild
    t_phase = time.perf_counter()
    kbuild.reset_launches()
    recs = {}

    def one_rank():
        recs["serve tinyllama"] = serve_engine_cell(
            "serve tinyllama", serve_arch("tinyllama-1.1b"), smi)
        recs["serve moe"] = serve_engine_cell(
            "serve moe", serve_arch(MOE_ARCH, SERVE_MOE_LAYERS), smi)
        recs["serve vlm"] = serve_vlm_cell(smi)
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        got, failed = serve_group(work, smi, before=one_rank)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, rec in recs.items():
        if not rec.get("same_tokens", True) or not rec.get("finite", True):
            failed.append(f"{label}: the two Engine runs' tokens differ "
                          f"(or non-finite logits)")
        if not rec["consistency_gap"] <= SERVE_CONSIST_RTOL:
            failed.append(f"{label}: decode vs a fresh prefill "
                          f"{rec['consistency_gap']:.3g} > "
                          f"{SERVE_CONSIST_RTOL:g}")
    recs.update(got)
    launched = sum(kbuild.LAUNCHES.values())
    if launched:
        failed.append(f"serving launched compression kernels: "
                      f"{dict(kbuild.LAUNCHES)}")
    log(f"[serve] phase in {time.perf_counter() - t_phase:.1f} s; "
        f"compression kernel launches {launched}")
    log("[serve] records: " + json.dumps(recs))
    if failed:
        raise AssertionError(" | ".join(failed))
    return recs


def serve_probe() -> int:
    """``python3 chip_smoke.py --serve-probe``: the gaps that set the
    serve limits.  The one-rank cells (``serve_engine_cell``,
    ``serve_vlm_cell``: their fp32 decode against a fresh prefill), then
    ``serve tinyllama`` with decode's cache write skipped
    (``serve_fault``); the four-rank cells against their one-rank runs
    in bf16 and in fp32, then with a fault planted: a context-parallel
    cell with every span at offset 0 and without the log-sum-exp merge,
    the 2-D MoE cell without the sum over ``model``.  Logs every gap and
    checks nothing."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)
    for fault in ("none", "nowrite"):
        undo = serve_fault(fault)
        mesh_mod.init_world(dev)
        try:
            log(f"[serve probe] fault {fault}:")
            serve_engine_cell("serve tinyllama", serve_arch(
                "tinyllama-1.1b"), smi)
            if fault == "none":
                serve_engine_cell("serve moe", serve_arch(
                    MOE_ARCH, SERVE_MOE_LAYERS), smi)
                serve_vlm_cell(smi)
        finally:
            undo()
            torch.distributed.destroy_process_group()
            serve_free()
    for dtype, fault, cells in (
            ("bfloat16", "none", tuple(SERVE_GROUP)),
            ("float32", "none", tuple(SERVE_GROUP)),
            ("auto", "off0", ("serve cp",)),
            ("auto", "nolse", ("serve cp",)),
            ("auto", "nopsum2d", ("serve moe2d", "serve moe2d bf16"))):
        work = tempfile.mkdtemp(prefix="chip_smoke_serve_probe_")
        try:
            serve_group(work, smi, dtype, fault, cells)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.configs import base as cfgs
    from repro_torch.core import bucketing
    from repro_torch.core.compression.powersgd import matrix_shape
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    from repro_torch.train import overlap

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    path = kbuild.build()
    kbuild.lib()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")

    # the main path's shapes, from the full-size layouts (no allocation):
    # the overlapped ZeRO-1 step's leaf-aligned buckets (the largest block
    # bucket and the tail's), the arch's classic ZeRO-1 step (bf16
    # parameters) and the classic fp32 one
    arch = cfgs.get("tinyllama-1.1b")

    def meta_model(dtype):
        return Model(arch, ShardCtx(param_dtype=dtype), device="meta")
    ovs = {name: overlap.layout_for_model(meta_model(dtype),
                                          arch.plan.bucket_mb)
           for name, dtype in (("zero1", torch.bfloat16),
                               ("classic", torch.float32))}
    ov = ovs["zero1"]
    by_stage = list(zip(ov.layout.sizes, ov.bucket_ready))
    shapes = [(f"overlap {which}", *matrix_shape(n), n) for which, n in (
        ("block", max(n for n, r in by_stage if r < ov.n_stages)),
        ("tail", max(n for n, r in by_stage if r == ov.n_stages)))]
    layouts = {
        name: bucketing.layout_for(list(meta_model(dtype).parameters()),
                                   arch.plan.bucket_mb)
        for name, dtype in (("zero1", torch.bfloat16),
                            ("classic", torch.float32))}
    shapes += [(f"{name} {which}", *matrix_shape(n), n)
               for name, lay in layouts.items()
               for which, n in (("full", lay.bucket_elems),
                                ("last", lay.last_elems))]
    # the MoE slice's overlapped ZeRO-1 layout: its largest block bucket
    # (one layer's slice of an expert leaf) and its largest tail bucket
    # (one vocabulary table)
    moe = moe_arch()

    def moe_meta(dtype):
        return Model(moe, ShardCtx(param_dtype=dtype), device="meta")
    mov = overlap.layout_for_model(moe_meta(torch.bfloat16),
                                   moe.plan.bucket_mb)
    by_stage = list(zip(mov.layout.sizes, mov.bucket_ready))
    shapes += [(f"moe overlap {which}", *matrix_shape(n), n)
               for which, n in (
                   ("block", max(n for n, r in by_stage if r < mov.n_stages)),
                   ("tail", max(n for n, r in by_stage
                                if r == mov.n_stages)))]
    moe_layouts = {
        name: bucketing.layout_for(list(moe_meta(dtype).parameters()),
                                   moe.plan.bucket_mb)
        for name, dtype in (("zero1", torch.bfloat16),
                            ("classic", torch.float32))}
    family_buckets = {}
    for tag, name in FAMILY_PHASES:
        family_buckets[tag], more = family_layouts(tag,
                                                   family_arch(tag, name))
        shapes += more
    # the vlm slice: full width cut to VLM_LAYERS blocks (DDP), and the
    # HSDP phase's shard buckets (full width, FSDP_LAYERS block, fp32
    # shards over a data axis of 2)
    family_buckets["vlm"], more = family_layouts("vlm", vlm_arch())
    shapes += more
    hsdp = hsdp_layout()
    shapes += [(f"hsdp {which}", *matrix_shape(n), n)
               for which, n in (("full", hsdp.bucket_elems),
                                ("last", hsdp.last_elems))]
    # the TP slice's buckets on a rank of data 2 x model 2 that no earlier
    # shape has: the classic ZeRO-1 step's last bucket, the overlapped
    # step's largest block and tail buckets, the MoE slice's last bucket,
    # the audio and hybrid cells' overlapped largest block and tail
    # buckets
    tpl = tp_layouts()

    def block_tail(tov) -> tuple[int, int]:
        by_stage = list(zip(tov.layout.sizes, tov.bucket_ready))
        return (max(n for n, r in by_stage if r < tov.n_stages),
                max(n for n, r in by_stage if r == tov.n_stages))
    seen = {n for *_, n in shapes}
    dense_ov, audio_ov, hybrid_ov = (block_tail(tpl[k]) for k in (
        "overlap", "audio overlap", "hybrid overlap"))
    for which, n in (
            ("zero1 last", tpl["zero1"].last_elems),
            ("overlap block", dense_ov[0]), ("overlap tail", dense_ov[1]),
            ("ep zero1 last", tpl["moe zero1"].last_elems),
            ("audio overlap block", audio_ov[0]),
            ("audio overlap tail", audio_ov[1]),
            ("hybrid overlap block", hybrid_ov[0]),
            ("hybrid overlap tail", hybrid_ov[1]),
            ("zero1 ckpt last", tpl["zero1 ckpt"].last_elems)):
        if n not in seen:
            shapes.append((f"tp {which}", *matrix_shape(n), n))
            seen.add(n)
    log(f"[kernels] shapes (tag, rows, cols, n): {shapes}")
    clocks("before the kernel phase")
    recs = kernel_phase(shapes, arch.plan.powersgd_rank)
    clocks("after the kernel phase")

    torch.cuda.set_device(0)
    mesh_mod.init_world(torch.device("cuda", 0))
    try:
        # the live cells time on this one-rank group (the backend leaves
        # a caller's group alone)
        t0 = time.perf_counter()
        analytic_phase()
        live = live_phase(layouts["zero1"].bucket_elems)
        log(f"[experiments] analytic and {len(live)} live cells in "
            f"{time.perf_counter() - t0:.1f} s")
        reference_phase()
        zero1_reference()
        overlap_reference()
        moe_reference()
        moe_block_syncs()
        t0 = time.perf_counter()
        hybrid_reference()
        hybrid_block_syncs()
        log(f"[hybrid] reference and block syncs in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ssm_reference()
        ssm_block_syncs()
        log(f"[ssm] reference and block syncs in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        audio_reference()
        audio_block_syncs()
        log(f"[audio] reference and block syncs in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        vlm_reference()
        log(f"[vlm] reference in {time.perf_counter() - t0:.1f} s")
        nb, nz = layouts["classic"].n_buckets, layouts["zero1"].n_buckets
        ob, oz = (ovs[k].layout.n_buckets for k in ("classic", "zero1"))
        runs = {  # name -> (steps, launches per step, accum, build overrides)
            "powersgd": (3, {"powersgd_encode": 2 * nb,
                             "powersgd_decode": nb}, 1,
                         dict(zero1=False, compression="powersgd")),
            "signsgd": (2, {"pack_signs": nb, "popcount_votes": nb}, 1,
                        dict(zero1=False, compression="signsgd")),
            "qsgd": (3, {"qsgd_quantize": nb}, 1,
                     dict(zero1=False, compression="qsgd")),
            "terngrad": (1, {}, 1, dict(zero1=False, compression="terngrad")),
            "randomk": (1, {}, 1, dict(zero1=False, compression="randomk")),
            "mstopk": (1, {}, 1, dict(zero1=False, compression="mstopk")),
            "ef:qsgd": (1, {"qsgd_quantize": nb}, 1,
                        dict(zero1=False, compression="ef:qsgd")),
            # the arch as configured: ZeRO-1, bf16 working parameters
            "zero1 none": (3, {}, 1, {}),
            "zero1 powersgd": (3, {"powersgd_encode": 2 * nz,
                                   "powersgd_decode": nz}, 1,
                               dict(compression="powersgd")),
            "zero1 signsgd": (2, {"pack_signs": nz, "popcount_votes": nz}, 1,
                              dict(compression="signsgd")),
            "zero1 qsgd": (2, {"qsgd_quantize": nz}, 1,
                           dict(compression="qsgd")),
            "zero1 rtob": (1, {}, 1, dict(comm="reduce_to_owner_broadcast")),
            "zero1 accum2": (1, {}, 2, {}),
        }
        # the overlapped step: leaf-aligned buckets flushed between
        # backward stages on a side stream (schedule as requested)
        ov_runs = {  # name -> (steps, launches per step, accum, schedule,
            #                   build overrides)
            "zero1 overlap none": (3, {}, 1, "overlap", {}),
            "zero1 overlap powersgd": (3, {"powersgd_encode": 2 * oz,
                                           "powersgd_decode": oz}, 1,
                                       "overlap",
                                       dict(compression="powersgd")),
            "zero1 serial powersgd": (3, {"powersgd_encode": 2 * oz,
                                          "powersgd_decode": oz}, 1,
                                      "serial", dict(compression="powersgd")),
            "zero1 overlap signsgd": (2, {"pack_signs": oz,
                                          "popcount_votes": oz}, 1,
                                      "overlap", dict(compression="signsgd")),
            "zero1 overlap qsgd": (2, {"qsgd_quantize": oz}, 1, "overlap",
                                   dict(compression="qsgd")),
            "zero1 overlap rtob": (1, {}, 1, "overlap",
                                   dict(comm="reduce_to_owner_broadcast")),
            "zero1 overlap accum2": (1, {}, 2, "overlap", {}),
            "classic overlap powersgd": (2, {"powersgd_encode": 2 * ob,
                                             "powersgd_decode": ob}, 1,
                                         "overlap",
                                         dict(zero1=False,
                                              compression="powersgd")),
        }
        hist, counts = {}, {}
        for label, (steps, per_step, accum, overrides) in runs.items():
            hist[label], counts[label] = train_phase(
                label, steps, per_step, accum, **overrides)
        for label, (steps, per_step, accum, schedule, overrides) in \
                ov_runs.items():
            hist[label], counts[label] = train_phase(
                label, steps, per_step, accum, schedule, **overrides)
        # the MoE slice: full-width qwen2-moe-a2.7b cut to MOE_LAYERS
        # blocks on the DDP step (the arch's own plan is FSDP)
        t0 = time.perf_counter()
        mb, mz = (moe_layouts[k].n_buckets for k in ("classic", "zero1"))
        mo = mov.layout.n_buckets

        def psgd(n):
            return {"powersgd_encode": 2 * n, "powersgd_decode": n}
        moe_runs = {  # name -> (steps, launches per step, schedule, build
            #                   overrides beside dp_mode="ddp")
            "moe classic none": (2, {}, None, dict(zero1=False)),
            "moe classic powersgd": (2, psgd(mb), None,
                                     dict(zero1=False,
                                          compression="powersgd")),
            "moe zero1 powersgd": (2, psgd(mz), None,
                                   dict(zero1=True, compression="powersgd")),
            "moe zero1 signsgd": (1, {"pack_signs": mz,
                                      "popcount_votes": mz}, None,
                                  dict(zero1=True, compression="signsgd")),
            "moe zero1 qsgd": (1, {"qsgd_quantize": mz}, None,
                               dict(zero1=True, compression="qsgd")),
            "moe zero1 overlap powersgd": (2, psgd(mo), "overlap",
                                           dict(zero1=True,
                                                compression="powersgd")),
            "moe zero1 serial powersgd": (2, psgd(mo), "serial",
                                          dict(zero1=True,
                                               compression="powersgd")),
        }
        # the overlap run's final state is kept on the host; the serial run
        # compares its own with it
        kept = {}
        for label, (steps, per_step, schedule, overrides) in \
                moe_runs.items():
            hist[label], counts[label] = train_phase(
                label, steps, per_step, 1, schedule, arch=moe,
                keep=kept if schedule else None, dp_mode="ddp", **overrides)
        if not kept.get("same"):
            raise AssertionError("moe: serial and overlap differ at full "
                                 "width")
        log(f"[moe] serial == overlap at full width, by on-card "
            f"fingerprints (plain and hashed bit sums): "
            f"{len(kept['prints'])} state tensors ("
            f"{kept['elements']:,} elements) and the "
            f"metrics of {len(kept['metrics'])} steps")
        del kept
        log(f"[moe] phase in {time.perf_counter() - t0:.1f} s")
        family_runs = {tag: family_phase(tag, family_arch(tag, name),
                                         family_buckets[tag], hist, counts)
                       for tag, name in FAMILY_PHASES}
        # the vlm slice on one rank: DDP (the arch's own plan is FSDP,
        # whose phase runs four ranks below), ZeRO-1 as the other
        # families configure it
        family_runs["vlm"] = family_phase(
            "vlm", vlm_arch(), family_buckets["vlm"], hist, counts,
            dp_mode="ddp", zero1=True)
        t0 = time.perf_counter()
        ssm_profiles()
        log(f"[ssm] block profiles in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        hist["adaptive powersgd"], counts["adaptive powersgd"] = \
            adaptive_phase(hist, ovs["zero1"].layout)
        log(f"[adaptive] phase in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        checkpoint_phase()
        log(f"[ckpt] phase in {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    # the three schedules round robin at full width (overlap_bench), as
    # one train cell of the experiment layer, in a process of its own
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = train_cell()
    log(f"[bench] three schedules, ZeRO-1 none, 1 warm-up and 3 reps "
        f"in {time.perf_counter() - t0:.1f} s: step ms "
        f"{bench['step_ms']}; t_serial_us {bench['t_serial_us']!r}, "
        f"t_overlap_us {bench['t_overlap_us']!r}, t_unfused_us "
        f"{bench['t_unfused_us']!r}; peak {bench['peak_mem_gib']:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cell = adaptive_cell()
    log(f"[adaptive] train cell (method=adaptive, one worker) in "
        f"{time.perf_counter() - t0:.1f} s: adaptive_choice "
        f"{cell['adaptive_choice']}, method {cell['method']}, step ms "
        f"{cell['step_ms']}")
    log("[train] " + json.dumps(hist))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pod = pod_phase(kind)
    log(f"[pod] {len(pod)} cells, the fit and local SGD in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fsdp = fsdp_phase(kind)
    log(f"[fsdp] {len(fsdp)} cells in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_")
    try:
        tp = tp_phase(kind, tp_references(hist), ckpt_dir, smi)
        log(f"[tp] {len(tp)} cells in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tp_elastic(tp["tp fsdp none"], smi)
        log(f"[tp elastic] in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    serve_phase(kind, smi)

    # name -> (source, TPU kernel it replaces, the run that counts it)
    sources = {
        "powersgd_encode": ("src/repro_torch/kernels/csrc/powersgd.cu",
                            "src/repro/kernels/powersgd.py:43",
                            "zero1 overlap powersgd"),
        "powersgd_decode": ("src/repro_torch/kernels/csrc/powersgd.cu",
                            "src/repro/kernels/powersgd.py:77",
                            "zero1 overlap powersgd"),
        "pack_signs": ("src/repro_torch/kernels/csrc/bitpack.cu",
                       "src/repro/kernels/bitpack.py:35",
                       "zero1 overlap signsgd"),
        "popcount_votes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                           "src/repro/kernels/bitpack.py:72",
                           "zero1 overlap signsgd"),
        "qsgd_quantize": ("src/repro_torch/kernels/csrc/qsgd.cu",
                          "src/repro/kernels/qsgd.py:31",
                          "zero1 overlap qsgd"),
        # on no path, as in the JAX package: its launches over every run
        "threshold_mask": ("src/repro_torch/kernels/csrc/topk.cu",
                           "src/repro/kernels/topk.py:26", None),
    }
    kernels = []
    for name, (src, replaces, run) in sources.items():
        head = recs[name][0]
        launches = counts[run].get(name, 0) if run else sum(
            c.get(name, 0) for c in counts.values())
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "main_path_run": run or "none (off-path, as in the JAX package)",
            "max_abs_err": max(c["max_abs_err"] for c in recs[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "pod_launches_per_step": {
                label: rec["launches"].get(name, 0) / rec["steps_timed"]
                for label, rec in pod.items()},
            "experiment_launches": sum(c.get(name, 0)
                                       for c in live.values()),
            "adaptive_launches": counts["adaptive powersgd"].get(name, 0),
            "moe_launches": {label: counts[label].get(name, 0)
                             for label in moe_runs},
            **{f"{tag}_launches": {label: counts[label].get(name, 0)
                                   for label in runs}
               for tag, runs in family_runs.items()},
            "fsdp_launches": {label: rec["launches"].get(name, 0)
                              for label, rec in fsdp.items()},
            "tp_launches": {label: rec["launches"].get(name, 0)
                            for label, rec in tp.items()},
            "cases": recs[name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-worker"]:
        sys.exit(serve_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-probe"]:
        sys.exit(serve_probe())
    sys.exit(main())
