"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases, in
order; any failure exits non-zero:

  1. environment — torch version, the card's name and power limit, the
     TF32 switches (both off);
  2. build — the five kernel libraries (graph filter, flash attention and
     its backward, wkv and its backward), one ``nvcc`` each, all started
     together; every instance of the wgmma kernels (the flash kernels, the
     bf16 forward's and backward's and the f32 ones' split-TF32 kernels;
     the wkv forward's and backward's chunk-state passes) must hold HGMMA
     instructions, and the split-TF32 ones no local-memory loads or stores
     (``cuobjdump -sass``);
  3. kernel vs plain — the graph-filter kernel against its plain PyTorch
     version on the same inputs (numpy, seeded) at the reference's test
     shapes, at n = 129, 256 and 1000 (past the kernel's resident limit)
     and at every PAPER shape: one serve tick layer per bucket the serve
     run warms (derived from the same ``BucketSpec``) and the
     single-cohort solve; f32 within 5e-5, bf16 within
     ``ops.bf16_error_bound`` per element. At the PAPER shapes and at
     DRYRUN's n = 256 (B = 8): the kernel's device time (profiler), its
     CUDA-event time, the wrapper's host time per call, the plain
     version's time, and the split-TF32 tensor-core and f32 FFMA bounds;
  4. backward vs plain — the graph filter's gradient (dW through the
     kernel's transposed-S entry, dh) against autograd through the plain
     version at the reference's VJP shapes, n = 129, 256 and 1000, and
     the PAPER training shape (n=100, d=5130, K=2), with the dW launch's
     times there; then (3/4 additions) forward within 5e-5 and dW within
     5e-4 on the S the new paths mix with: SPARSE_SMOKE's (n = 8,
     d = 16), the quickstart's (n = 20, d = 330) and
     ``make_problem(PAPER, i)``'s for the training seeds i = 0-3;
  5. flash attention vs plain — at the reference's sweep shapes, the
     qwen3-4b prefill shape (B=4, H=32, KV=8, S=2048, dh=128) and
     gemma3-27b's two (H=32, KV=16: its local layers' window of 1024 and
     its global layers' causal call), f32 and bf16 (both wgmma kernels),
     at 10x the reference's kernel tolerance, within 1e-5 in f32 at every
     shape (the split-TF32 products keep f32 accuracy; each shape's
     largest error printed) and within ``bf16_error_bound`` in bf16, the
     fraction of it used printed; a negative control at the qwen3-4b
     shape: the plain version with cuBLAS's one-pass TF32 switched on
     must miss the 1e-5 gate; µs per launch
     (CUDA events, median), the plain version's time,
     ``scaled_dot_product_attention``'s (default dispatch, and in f32 also
     the memory-efficient backend on K/V expanded to H heads), the
     tensor-core bound and the f32 FFMA bound beside it; then at
     whisper-small's two non-causal shapes (dh=64, MHA): the encoder's
     self-attention (B=4, H=12, S=1500) and the cross-attention (448
     decoder positions to 1500 frames), f32 within 1e-5, bf16 within
     ``bf16_error_bound(..., causal=False)``, with the same times; and at
     the dense multi-card archs' shapes (H=64/KV=8, H=KV=40; B=4, S=2048,
     dh=128, causal), the same gates and times;
  5b. flash backward vs plain — dq, dk, dv of the backward kernel
     against autograd through the plain version at phase 5's shapes (f32,
     causal; the gemma3 shape windowed): each within 1e-4 of the plain
     gradient's largest entry, a rerun bit-equal; a negative control at
     the qwen3-4b shape: autograd through the plain version with cuBLAS's
     one-pass TF32 switched on must miss the same gate; at the qwen3-4b
     and gemma3 shapes µs per launch, the bound (split TF32 on the tensor
     cores; the FFMA bound and the bound of the 7 products the kernel
     runs beside it), the plain backward's time and
     ``scaled_dot_product_attention``'s backward (memory-efficient
     backend, K/V expanded); then at phase 5's two whisper shapes, the
     same gates and times; then at the cross shape with one vector added
     to every key (0, 10 and 30 times the keys' rms norm, which moves no
     gradient analytically): dq, dk, dv within 1e-4 of an f64 autograd
     step and the keys' summed dk within KEY_SUM_TOL;
  6. wkv vs plain — at the reference's sweep shapes, a port-own shape
     with a ragged last chunk (B=2, H=4, T=321, dk=64) and the rwkv6-1.6b
     prefill shape (B=4, H=32, T=2048, dk=64), y and the final state at
     20x the reference's tolerance, a rerun bit-equal; the y launch's
     grid and block (a block per (batch item, head, 64-step chunk)), µs
     per launch, plain time, bound;
  6b. wkv backward vs plain — dr, dk, dv, dw, du of the backward kernel
     against autograd through the plain version at phase 6's shapes (f32;
     decays of 1e-7 at one sweep shape and, across the first chunk
     boundary, at steps 62-66 of the ragged one), each within 1e-4 of the
     plain gradient's largest entry, a rerun bit-equal; µs per launch,
     bound and plain time at the rwkv6-1.6b shape;
  7. serve — ``FederationServer`` at PAPER width (n=100, F=512, C=10,
     L=10, K=2) built with the DEFAULT mixer, so through the kernel: 24
     requests over two buckets; the kernel's launch count must be
     ticks × L, every request's loss and accuracy must match
     ``solve_federation`` of the same cohort and seed through the plain
     filter, and its served W the plain forward on the same draws;
  7b. serve past the resident limit — a SMOKE-width ``FederationServer``
     over a bucket ladder reaching 256: federations of 200 and 150
     agents through the kernel (launches = ticks × L), each matching
     ``solve_federation`` through the plain filter;
  7c. adaptive serve — phase 7's 24 requests through
     ``FederationServer(depth="adaptive")``: at exit_threshold 0 every
     depth is L and W, final_loss and final_acc are bit-equal to phase
     7's (launches = ticks × L); at one threshold > 0 (min_layers 2)
     picked from the plain path's grad-norm ratios so that depths spread,
     every depth equals the adaptive ``solve_federation`` through the
     plain filter with each exit decision at least 1e-5 from its level,
     W and loss within 5e-5, accuracy within 1.5/(n t), launches = Σ
     layers_run < ticks × L; ms per tick beside phase 7's, and one
     profiled adaptive tick (the per-layer ``act.any()`` host reads);
  7d. async driver — the same 24 requests through ``AsyncDriver`` on a
     fresh fixed server: each result bit-equal to phase 7's, the driver's
     tick utilization;
  7e. launchers — ``launch.surf_serve`` and ``launch.surf_earlyexit`` at
     their defaults (output under build/bench_torch), gated by their own
     assertions; the early-exit frontier claim is reported
     (``--frontier report``): the reference's launcher no longer meets it
     at its own default seed either;
  7f. sharded serving — phase 7's 24 requests through
     ``FederationServer(mesh=)`` at 2, 4 and 8 shards SIMULATED on the one
     card (``devices=["cuda:0"] * s``): each result within 5e-5 of the
     unsharded server's, L launches per shard per tick, federations/s per
     shard count; then ``launch.surf_serve --simulate-shards 8`` (its
     sharded rows at 1, 2, 4, 8 shards, gated by its own parity);
  8. meta-step parity — 3 PAPER meta-steps from one ``init_state`` on
     identical draws, through the kernel (default mixer) and through the
     plain filter: θ, λ and the metrics must agree; a TF32 plain step
     must fail the same gate;
  9. train — ``train_surf(PAPER, make_meta_dataset(PAPER, 8), steps=20)``
     through the kernel: L forward and L−1 backward launches per step,
     ms per meta-step (CUDA events), meta-steps/s, peak memory, one
     profiled meta-step's device time by kernel;
  9b. scheduled training — ``make_scenario(PAPER, s, 20, seed=0)`` for
     the link-failure, dropout, markov and anneal scenarios: the graph
     filter forward (within 5e-5) and dW (within 5e-4) against the plain
     version on each S_0 and on one S_t that isolates agents; 3 PAPER
     meta-steps under the link-failure schedule kernel vs plain at phase
     8's gates; ``train_surf(PAPER, ..., steps=20,
     scenario="link-failure")`` through the kernel: L and L−1 launches
     per step, the returned S equal to ``make_problem(PAPER, 0)``'s, ms
     per meta-step beside phase 9's, peak memory;
  9c. async study — ``evaluate_async`` at PAPER width on 8 test datasets,
     n_async 10, 20, 40, seeds (0, 1), through the kernel (L launches per
     dataset and seed) and through the plain filter on the same draws
     and masks: per-layer loss within 5e-5 of max(|loss|, 1), accuracy
     within 1.5/(n t); n_async = 0 equal to ``evaluate_surf``'s per-layer
     loss and accuracy bit for bit on the same draws; ms per call;
  9e. seed-batched training — ``train_surf(PAPER, 8 datasets, steps=10,
     seeds=(0, 1, 2, 3), eval_every=5, eval_datasets=4 test datasets)``
     through the kernel: 4 × L forward and 4 × (L − 1) dW launches per
     lockstep step plus L per eval dataset per seed per snapshot;
     S_stack[i] equal to ``make_problem(PAPER, i)``'s S; states, history
     and snapshots bit-equal, row for row, to the four sequential runs;
     the last snapshot bit-equal to ``snapshot_reference`` from the
     returned θ; ms per lockstep step and per seed beside phase 9's
     meta-step, one lockstep step profiled by kernel kind (device time,
     copies, busy share), and the peak memory;
  9f. RSDUN — 3 PAPER meta-steps with robust_sigma 0.1 and 2 samples,
     kernel vs plain on the same draws and δ at phase 8's gates;
     robust_sigma 0 with 4 samples gives phase 8's kernel trajectory bit
     for bit; ms per robust meta-step beside a nominal one;
     ``train_surf`` on the robust config: L and L − 1 launches per step;

     FedAvg, FedProx, SCAFFOLD on PAPER_STAR for 25, fig. 5's learning
     rates, on the card and on the CPU from one set of numpy draws:
     per-round loss within 1e-4 of the run's largest |loss|, accuracy
     within 2/(n t), no graph-filter launch; ms per round;
  9i. agent-sharded training (shards SIMULATED on the card: they show
     the decomposition's cost, not multi-card scaling) — first the
     halo-pallas resident block (n = 25 and 20, d = 5130, h = [0, 1])
     kernel vs plain, forward within 5e-5 and dW within 5e-4, with its
     device times, bound, plain time and ``S0 @ Y``'s; then 3 PAPER
     meta-steps of mix="halo" and "halo-pallas" at 1, 2, 4 and 5 shards
     and of mix="ring" (ring variant, degree 2) at 4, each from one state
     on replayed draws, against the dense kernel path at phase 8's gate;
     halo-pallas launches shards · K · L forward and dW per step; ms per
     meta-step, peak memory and exchange rows beside the dense path's;
     one halo-pallas meta-step at 4 shards profiled by kernel kind;
     ``train_surf(mix="halo-pallas")`` at 4 shards counted from zero;
  9j. scheduled and seed-batched halo — the link-failure schedule through
     the scheduled halo-pallas mixer at 4 shards, 3 steps at phase 8's
     gate; ``train_surf(seeds=(0, 1), mix="halo")`` on a (2, 2) mesh, each
     row bit-equal to its lane's sequential run on the same mesh;
  9k. Q-sharded pools — ``train_surf(q_sharded=True)`` on 8 datasets over
     4 shards against the replicated pool (1e-5), and
     ``evaluate_async(mesh=)`` against the unsharded call;
  9g. checkpoint and resume — the quickstart config, 20 steps with
     ``checkpoint_every=5`` (under build/), resumed from step 10:
     bit-equal to the uninterrupted run, single-seed and with 4 seeds;
  9h. sparse recovery — 20 SPARSE_SMOKE meta-steps kernel vs plain from
     one state per step (phase 8's gates, the TF32 control included);
     ``train_surf(SPARSE_SMOKE)`` 20 steps through the kernel (L and
     L − 1 launches per step); ``launch.surf_serve --task sparse`` at its
     defaults, gated by its own assertions; a seed-batched sparse run
     bit-equal per row;
 10. quickstart — the config of ``examples/quickstart.py`` trained for
     250 meta-steps and evaluated on 5 unseen datasets under 4 seeds:
     ``final_acc`` must clear the reference quickstart's 0.5;
 10b. quickstart ``--seeds 4 --eval-every 50`` — 4 seeds in lockstep with
     a snapshot every 50 steps; the seed mean of ``final_acc`` must clear
     0.5; each seed's value and the snapshot curve are printed;
 11. qwen3-4b serve at full width, f32 — ``launch.serve.main`` (4 prompts
     of 2048 seeded ids, 32 new tokens, parameters from ``init_lm`` with
     a seeded generator): 36 flash launches, none of another kernel;
     then the prefill and decode steps timed (36 launches per prefill, 0
     added by decode), peak memory, the same prefill through the plain
     versions (``plain_kernels=True``): last-position logits and the
     final hidden state within 1e-3 of their largest entry, then 31
     decode steps teacher-forced on the kernel path's tokens through
     both caches at the same bound; one profiled prefill's and 4 decode
     steps' device time by kernel and the device-busy share;
 12. rwkv6-1.6b serve at full width, f32 — the same, with 24 wkv
     launches per prefill;
 13. LM training at full width, f32 — qwen3-4b cut to 4 of its 36 layers
     (f32 Adam state of the whole model, 70.6 GB, does not fit one card;
     23 trains it whole in bf16)
     and rwkv6-1.6b at full depth, B=4, S=2048, remat, ``chunked_ce=512``:
     the loss within 1e-5 relative, the gradient norm and every gradient
     tensor within 1e-3 of its largest entry, kernels against
     ``plain_kernels=True`` from the same parameters and batch (rwkv6's
     plain step at S=512, its wkv being a Python loop over T; its gates at
     least twice the plain path's distance from an f64 recurrence, as
     phase 12's; its gradients gated at 6 layers, its loss at full depth,
     where the f32 gradient of the random model is chaotic); one
     ``make_train_step`` step counted from zero: 2L
     forward (remat) and L backward launches; ms per step, tokens/s, peak
     memory and one profiled step by kernel kind;
 13b. ``launch.train.main`` on rwkv6-1.6b at full width, 20 steps, with
     ``--ckpt`` under build/, gated by its own "loss decreases"; the
     checkpoint restored bit-equal and one more step from it bit-equal to
     the step from the in-memory state;
 14. MoE and hybrid serving at full width, f32 — phase 11's run for
     deepseek-moe-16b at full depth (28 flash launches per prefill),
     llama4-scout-17b-a16e cut to 4 of its 48 layers (one 3-local :
     1-global period; 4 launches) and jamba-1.5-large-398b cut to 2 of
     its 72 layers (Mamba + dense, Mamba + MoE; no attention layer, so no
     launch), each cut to what fits 80 GB with the parity pass
     (``serve.main`` reads the cut config through this script's patch of
     its ``get_config``). The parity holds the expert choice fixed
     (``RouteReplay``: the plain run replays the kernel run's top-k) and
     prints how many (token, layer) choices would differ without it; the
     profiled prefill and decode name the MoE FFN's parts (router,
     dispatch maps, row gathers, expert GEMMs). Jamba's Mamba scan is
     timed alone (one layer: CUDA events, host clock, kernel launches);
 15. MoE training at full width — phase 13's step for deepseek-moe-16b
     cut to 4 layers (1 dense + 3 MoE), routing replayed in the parity,
     lb and z printed (they enter the loss), and a rerun of the kernel
     step's loss and gradients bit-equal;
 16. fig. 7's ablation timed — ``train_surf`` at BENCH for the four
     (constrained, init) runs over seeds 0-3 in lockstep, 150 steps each
     (of the benchmark's 700: a timing window),
     through the graph-filter kernel (L and L − 1 launches per seed and
     step), then the per-layer evaluation on the test pool: ms per
     lockstep step, launches, per-layer accuracies and the benchmark's
     mid-layer line (reported, not gated);
 17. the examples — each ``examples/*_torch.py`` run in this process as
     its command line would run it, on the card, at its defaults
     (decentralized_fl at 200 meta-steps, not 800), gated by its own
     assertions and output; ``serve_arch_torch.py`` launches flash once
     (jamba's reduced attention layer);
 18. whisper-small serving at full width and depth, f32, through
     ``launch.serve.main``: B=4, 1500 seeded frames (30 s of audio after
     the stubbed conv frontend), prompts of 416 seeded ids and 32 new
     tokens (a 448 cache, whisper's decoder context). 36 flash launches
     per prefill, 12 per kind (encoder, decoder self, cross), none in
     decode; against ``plain_kernels=True`` from the same parameters and
     frames the encoder output, last-position logits, final hidden state
     and every layer's self and cross cache within 1e-3 of the largest
     entry, then 31 decode steps teacher-forced through both caches at
     the same bound; the cross caches after decode bit-equal to the
     prefill's. Prefill ms, decode ms per token, peak memory, one
     profiled prefill's and decode's device time by kind (GEMMs; flash by
     encoder, self and cross from CUDA events around each call) and the
     busy share;
 19. whisper-small training at full depth, f32 — phase 13's step at B=4,
     1500 frames, S=448, remat, ``chunked_ce=512``: the loss within 1e-5
     relative and every gradient within 1e-3 of its largest entry
     against ``plain_kernels=True``, every encoder parameter's gradient
     nonzero (its only path to the loss is the cross-attention's dk and
     dv); one ``make_train_step`` step counted from zero: 72 forward (24
     per kind) and 36 backward flash launches; ms per step, decoder
     tokens/s, peak memory, one profiled step by kind;
 19b. ``launch.train.main(["--arch", "whisper-small", "--full",
     "--steps", "20"])`` (its defaults: B=4, S=64, 24 frames per step, no
     remat), gated by its own "loss decreases"; 36 forward and 36
     backward flash launches per step;
 20. the dense archs that need more than one card in full (qwen2-72b,
     qwen1.5-32b, chameleon-34b) served at full width through
     ``launch.serve.main``, each cut to 4 layers (phase 14's patch), as
     phase 11: one flash launch per attention layer per prefill, the
     parity pass against ``plain_kernels=True`` at phase 11's gates,
     times, peak memory and a profiled prefill and decode (phase 5 times
     the flash kernel at their two attention shapes: H=64/KV=8 and
     H=KV=40);
 21. the dry run (``launch.dryrun``): every arch x shape on the 16x16
     and 2x16x16 production meshes and SURF's DRYRUN step in its four
     mixes and its deployed solve, described on the ``meta`` device in
     worker processes; any 'error' fails, the status counts printed. Then
     where a step fits one card: qwen3-4b's prefill (B=4, S=2048, bf16)
     and DRYRUN's meta-step through the graph-filter kernel, each
     description's argument bytes and peak against the card's allocator
     (DRYRUN_ARG_TOL, DRYRUN_PEAK_TOL).
 22. gemma3-27b at full width (5 local layers of window 1024 to each
     global one; a ring cache of 1024 slots per local layer):
     22a. one period (6 layers, 5.30 B parameters) in f32 through
     ``launch.serve.main``, as phase 20: 6 flash launches per prefill (5
     windowed, 1 causal, counted by window), phase 11's parity pass, and
     after the teacher-forced decode every layer's cache, rings and full
     caches, kernel path against plain path within LLM_REL_TOL;
     22b'. a 6-layer cut in bf16 (``launch.specs.PARAM_DTYPE``): the
     kernel path's and the plain path's last-position logits and hidden
     states, each as a distance from an f32 plain forward of the same
     bf16-valued weights (max |d| / max |f32|); the kernel path's at most
     BF16_E2E_FACTOR times the plain path's;
     22b. the whole model (62 layers: 52 local, 10 global; 28.42 B
     parameters, 56.8 GB) in bf16, served through
     ``launch.steps.make_prefill_step`` / ``make_decode_step`` (what
     ``launch.serve`` runs) with bf16 caches as
     ``launch.specs.cache_spec_tree`` describes them: B=4 x 2048 ids, 32
     new tokens, 62 flash launches per prefill and none in decode; every
     flash call of that prefill held, where it is made, against
     ``attention_ref`` on its own inputs within ``ops.bf16_error_bound``
     (``FlashWindows``); prefill ms, decode ms per token, peak memory and
     a profiled prefill and decode; the greedy ids of the plain bf16 path
     beside the kernel path's (printed: the count shared and the plain
     path's top-2 margin at the first id that differs), and 22b''s
     distances at full depth (printed, not gated);
     22c. the loss and gradients of 2 local layers (window 1024 < S) in
     f32, B=4, S=2048, remat, ``chunked_ce=512``: the windowed flash
     forward and backward kernels (4 forward launches with remat's
     recompute, 2 backward) against ``plain_kernels=True`` at phase 13's
     gates; its time and peak memory. No Adam update: f32 Adam state
     does not fit one card at any depth (the untied embedding and head
     alone are 2.82 B parameters: parameters, gradients and two moments
     take about 58 GB at 2 layers, before the step's new copy).
 23. LM training in the reference's production dtype (bf16 parameters,
     ``launch.specs.PARAM_DTYPE``; Adam's moments f32) with the donated
     step (``make_train_step(donate=True)``, the reference's
     ``donate_argnums=(0, 1)``), B=4, S=2048, remat, ``chunked_ce=512``,
     lr 3e-4:
     23a. qwen3-4b at full width and depth (36 layers, 4.41 B
     parameters): one step's loss and gradients through the kernels with
     every flash backward call held, where it is made, within
     ``ops.bf16_grad_error_bound`` of the plain backward on its own
     inputs (``FlashBwdGate``), the plain bf16 step's beside it; then 10
     donated steps counted from zero (72 flash forward and 36 backward
     launches each, the bf16 entries), the reference driver's loss check
     (the mean of the last 5 below that of the first 5), ms per step,
     tokens/s, peak memory (under 80 GB) and a profiled step;
     23a'. the same cut to 4 layers: the kernel step's gradients at most
     BF16_E2E_FACTOR times as far from the f32 step of the same weights
     as the plain step's, and two donated steps bit-equal to two
     undonated ones;
     23b. rwkv6-1.6b at full width and depth in bf16: gradients of 6
     layers held as 23a''s against f32, the loss at full depth likewise
     (both at S = 512), and 10 donated steps
     with the loss check (its model widens r, k, v, w to f32 before the
     scan, as the reference does: the wkv kernels' f32 entries run).
 Phases 5b and 6b also hold the backward kernels' bf16 entries against
 autograd through the plain versions within each wrapper's
 ``bf16_grad_error_bound`` (flash at the sweep, qwen3-4b, gemma3's
 window and global and whisper's shapes; wkv at the sweep and rwkv6
 shapes) and wkv's final-state gradient (f32 and bf16), with their
 times beside SDPA's bf16 backward. Each phase prints its seconds.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): memory; f32 on the
# CUDA cores (FFMA: the graph filter and wkv); the tensor cores in bf16 and
# in TF32 (the flash kernel: bf16 products, or three TF32 products per f32
# product).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_TC_FLOP_PER_S = 989e12
PEAK_TF32_TC_FLOP_PER_S = 495e12
FLASH_F32_ERR_MAX = 1e-5     # flash f32 at every shape vs plain

F32_TOL = 5e-5       # tests/test_kernels.py: f32 forward
BF16_TOL = 5e-2      # tests/test_kernels.py: bf16 forward
VJP_TOL = 5e-4       # tests/test_kernels.py: (dS, dW, dh)
STATE_TOL = 5e-6     # tests/test_torch_train.py: θ, λ, metrics
# θ entries whose gradient is at the f32 noise floor (Adam's m differs by
# more than NOISE_REL between the two paths; see _state_err) are counted
# apart; they may be at most NOISE_SHARE of each tensor's entries, about
# twice the largest share read on an H100 (0.089% of M, PAPER step 0).
NOISE_REL, NOISE_SHARE = 1e-4, 2e-3
# The reference's shapes, then agent counts past the kernel's resident
# limit (128): S streamed through shared memory, n = 256 is DRYRUN's, 1000
# the reference kernel's "~1k agents".
LARGE_N_SHAPES = [(129, 300, 2), (256, 130, 2), (1000, 70, 2)]
TEST_SHAPES = [(8, 16, 1), (100, 650, 2), (64, 128, 4), (33, 100, 2),
               (9, 5, 1)] + LARGE_N_SHAPES
VJP_SHAPES = [(8, 16, 1), (33, 100, 2), (64, 128, 4)] + LARGE_N_SHAPES
DRYRUN_N = 256       # configs/surf_paper.py DRYRUN's agent count
LARGE_SIZES = (200, 150)    # federations served past the resident limit
MAX_BATCH = 8
SIZES = (100, 60)    # served cohorts: 16 of SIZES[0] agents, 8 of SIZES[1]
TRAIN_POOL, TRAIN_STEPS, PARITY_STEPS = 8, 20, 3
# Phase 9b: the scenarios of make_scenario (the static one aside).
SCHEDULE_SCENARIOS = ("link-failure", "dropout", "markov", "anneal")
# Phase 9c: fig. 8's stale-agent counts, 8 test datasets, 2 eval seeds.
N_ASYNC, ASYNC_POOL, ASYNC_SEEDS = (10, 20, 40), 8, (0, 1)
# Phase 9d: fig. 5's rounds and learning rates; 10 participants per
# classical round (the baselines' default), 6 local steps.
BASELINE_ROUNDS, BASELINE_ROUNDS_STAR, BASELINE_PART = 200, 25, 10
LOCAL_STEPS = 6
BASELINE_LRS = {"dgd": 0.5, "dsgd": 0.2, "dfedavgm": 0.05,
                "fedavg": 0.5, "fedprox": 0.5, "scaffold": 0.5}
BASELINE_LOSS_TOL = 1e-4     # card vs CPU, of the run's largest |loss|
QUICKSTART_STEPS = 250
# Phases 9e-10b: the training seeds of figures 5-8 (benchmarks/common.py
# TRAIN_SEEDS), 9e's run and snapshot pool, 9g's checkpoint grid, 9h's
# run length.
SEEDS = (0, 1, 2, 3)
SEED_STEPS, SEED_EVAL_EVERY, SEED_EVAL_POOL = 10, 5, 4
CKPT_STEPS, CKPT_EVERY, CKPT_RESUME = 20, 5, 10
SPARSE_STEPS = 20
# Phases 9i-9k and 7f: agent-shard counts of PAPER's n = 100 (s = 5:
# 20 agents per shard), the sharded server's shard counts.
HALO_SHARDS = (1, 2, 4, 5)
SERVE_SHARDS = (2, 4, 8)
# Flash attention: the reference's sweep shapes (B, H, KV, S, dh, window),
# the qwen3-4b prefill and a gemma3 local-layer shape; wkv: the sweep
# shapes (B, H, T, dk), a shape of the port's own whose last 64-step chunk
# is ragged (several chunks), and the rwkv6-1.6b prefill.
FLASH_SWEEP = [(1, 4, 4, 64, 32, 0), (2, 4, 2, 80, 32, 0),
               (1, 8, 2, 128, 64, 16), (1, 2, 1, 48, 16, 8)]
FLASH_QWEN = (4, 32, 8, 2048, 128, 0)
FLASH_GEMMA = (4, 32, 16, 2048, 128, 1024)
FLASH_GEMMA_GLOBAL = (4, 32, 16, 2048, 128, 0)
# Phases 5 and 20: the multi-card dense archs' prefill attention (GQA with
# 64 heads over 8 kv heads: qwen2-72b, chameleon-34b; MHA with 40 heads:
# qwen1.5-32b), causal, at phase 11's batch and prompt.
FLASH_DENSE = {"qwen2-72b/chameleon-34b": (4, 64, 8, 2048, 128, 0),
               "qwen1.5-32b": (4, 40, 40, 2048, 128, 0)}
WKV_SWEEP = [(1, 2, 32, 16), (2, 3, 50, 16), (1, 4, 64, 64), (2, 1, 17, 8)]
WKV_RAGGED = (2, 4, 321, 64)
WKV_RWKV = (4, 32, 2048, 64)
LLM_BATCH, LLM_PROMPT, LLM_TOKENS = 4, 2048, 32
LLM_REL_TOL = 1e-3   # kernel vs plain model: of the largest |entry|
# Phases 5b-6b: a backward kernel's gradients against autograd through the
# plain version, of each gradient's largest |entry| (f32 sums over up to
# 2048 keys or steps in another order; one-pass TF32 would miss it).
BWD_REL_TOL = 1e-4
# Phase 13: LM training at full width in f32 (qwen3-4b cut to 4 of its 36
# layers: with f32 Adam the full model's 70.6 GB of state does not fit one
# card; 8 before the script's time limit needed room for phase 23, which
# trains it at full depth in bf16 and compares 4 layers against f32).
TRAIN_LLMS = (("qwen3-4b", 4), ("rwkv6-1.6b", None))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_OPTS, TRAIN_LR = 4, 2048, "chunked_ce=512", 3e-4
RWKV_PARITY_SEQ = 512      # rwkv6's plain step: a Python loop over T
RWKV_PARITY_LAYERS = 6     # rwkv6's well-conditioned depth cut (phase 13)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-3
# The key projection's bias (whisper's attentions, which apply no RoPE:
# the one trained arch with QKV bias; qwen2-72b's and qwen1.5-32b's are
# rotated per position, have a gradient, and are served only) moves every
# logit of a query row by the same q·b, which softmax ignores: its
# gradient is zero but for f32 rounding (the reference's too). A gate relative to its own largest entry would compare
# two roundings, so these tensors are held to zero instead: every entry,
# in both paths, within ZERO_GRAD_TOL of the step's largest gradient entry.
ZERO_GRAD_TOL = 1e-6
# Phase 23: LM training in the reference's production dtype (bf16
# parameters, launch.specs.PARAM_DTYPE; Adam's moments f32) with the
# donated step: 23a qwen3-4b at full depth, 23a' cut to BF16_TRAIN_CUT
# layers (an f32 step of the same weights fits beside it), 23b rwkv6-1.6b
# at full depth; BF16_TRAIN_STEPS steps each.
BF16_TRAIN_ARCH = "qwen3-4b"
BF16_TRAIN_CUT = 4
BF16_TRAIN_STEPS = 10


def _key_bias(name):
    """A key projection's bias: a gradient that is zero analytically."""
    return name.endswith(".wk.b")


DRIVER_STEPS = 20          # phase 13b
# Phase 14: MoE and hybrid serving at full width, each cut in depth to
# what fits 80 GB with its plain-path parity pass (None: full depth).
SERVE_MOE = (("deepseek-moe-16b", None), ("llama4-scout-17b-a16e", 4),
             ("jamba-1.5-large-398b", 2))
# Phase 20: the dense archs that need more than one card in full, served
# at full width cut to 4 layers (qwen2-72b: 2 x 4.98 GB of embedding and
# head plus 3.51 GB per f32 layer), with phase 11's parity pass.
SERVE_DENSE = (("qwen2-72b", 4), ("qwen1.5-32b", 4), ("chameleon-34b", 4))
# Phase 5b addition: the flash backward at whisper's cross shape with one
# vector c added to every key (m times the keys' rms row norm), which
# moves no gradient analytically; the kernel's dq and dk within
# BWD_REL_TOL of an f64 autograd step at every m, and its sum over keys
# of dk (a key bias's gradient, zero analytically) within KEY_SUM_TOL of
# the f64 dk's largest entry.
DELTA_MULTIPLES = (0.0, 10.0, 30.0)
KEY_SUM_TOL = 1e-5
# Phase 21: the dry run's card checks. qwen3-4b's prefill at phase 11's
# B and S in bf16 (the dry run's parameter dtype) on a 1-device mesh: its
# described argument bytes against the allocated bytes of its parameters
# and batch (DRYRUN_ARG_TOL, relative), its described peak (arguments +
# counted live bytes of the plain path) against the same step's
# max_memory_allocated with plain_kernels=True (DRYRUN_PEAK_TOL); then
# DRYRUN's meta-step (n = 256) through the graph-filter kernel, the same
# two checks; and qwen3-4b's donated bf16 train step (the dry run's, as
# the reference donates its parameters and Adam state) cut to
# DRYRUN_TRAIN_LAYERS layers at phase 13's B and S, the same two checks.
# DRYRUN_JOBS worker processes count the grid.
DRYRUN_ARG_TOL, DRYRUN_PEAK_TOL = 0.01, 0.10
DRYRUN_TRAIN_LAYERS = 4
DRYRUN_JOBS = 8
# Phase 22: gemma3-27b. 22a serves one 5-local + 1-global period in f32
# (21.2 GB of parameters); 22b' cuts the bf16 model to the same 6 layers
# (an f32 forward of its weights fits beside it); 22c takes the loss and
# gradients of 2 local layers in f32. In 22b' the bf16 kernel path may
# be at most BF16_E2E_FACTOR times as far from the f32 forward as the
# bf16 plain path (the rule ROADMAP queue 3 item 2 holds rwkv6 to
# against f64).
GEMMA = "gemma3-27b"
GEMMA_PERIOD_LAYERS, GEMMA_CUT_LAYERS, GEMMA_TRAIN_LAYERS = 6, 6, 2
BF16_E2E_FACTOR = 2.0
# Phase 15: MoE training, deepseek-moe-16b cut to 1 dense + 3 MoE layers.
TRAIN_MOE = ("deepseek-moe-16b", 4)
# Phase 16: fig. 7's ablation at benchmarks/common.py's setup (BENCH,
# 60 training datasets, 10 test datasets, SEEDS), its META_STEPS = 700
# cut to 150: a timing window that keeps the whole script well inside its
# 1200 s limit on one H100 (the four runs take about 200 s at 700,
# about 90 s at 350).
FIG7_TRAIN_Q, FIG7_TEST_Q, FIG7_STEPS = 60, 10, 150
# Phases 5, 5b, 18, 19: whisper-small. The flash calls new to the main
# path (B, H, KV, Sq, Skv, dh), non-causal: the encoder's self-attention
# over 1500 frames and the cross-attention from the decoder's 448
# positions to them. Phase 18 serves prompts of 416 ids and 32 new tokens
# (448: whisper's decoder context); phase 19 trains at S = 448.
WHISPER = "whisper-small"
FLASH_WHISPER = {"encoder": (4, 12, 12, 1500, 1500, 64),
                 "cross": (4, 12, 12, 448, 1500, 64)}
WHISPER_PROMPT, WHISPER_TOKENS, WHISPER_SEQ = 416, 32, 448
WHISPER_DRIVER_STEPS = 20  # phase 19b
# Phase 17: each example's arguments (its defaults; decentralized_fl's
# 800 meta-steps cut to 200) and a line its output must hold.
EXAMPLE_ARGS = {
    "quickstart": ([], "quickstart OK"),
    "classical_fl": ([], "U-DGD(SURF, star) @ 8 rounds"),
    "decentralized_fl": (["--steps", "200"], "U-DGD(SURF)  @ 16 rounds"),
    "serve_federations": ([], "solved in one forward pass"),
    "serve_arch": ([], "sample ids"),
    "train_lm": (["--arch", "qwen3-4b", "--steps", "200", "--batch", "8",
                  "--seq", "128", "--lr", "3e-3"], "done: loss"),
}


def quickstart_cfg():
    """The config of ``examples/quickstart.py``."""
    from repro_torch.configs.base import SURFConfig
    return SURFConfig(n_agents=20, n_layers=8, filter_taps=2, feature_dim=32,
                      n_classes=10, batch_per_agent=8, topology="regular",
                      degree=3, eps=0.01)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def paper_shapes(cfg, spec):
    """The buckets the serve run warms, and the (B, n, d, K) of the
    filter at ``cfg``'s widths: one serve tick layer per bucket
    (B = MAX_BATCH, n = the bucket's padded agent count), then one
    single-cohort layer (B = 1, n = SIZES[0]): a solve's and a PAPER
    meta-step's."""
    d, K = cfg.head_dim, cfg.filter_taps
    buckets = spec.buckets_for([(n, cfg.test_per_agent) for n in SIZES])
    return buckets, ([(MAX_BATCH, b.n_agents, d, K) for b in buckets]
                     + [(1, SIZES[0], d, K)])


def filter_inputs(rng, B, n, d, K):
    """Row-stochastic S, Gaussian W and taps from numpy; B=0 unbatched."""
    lead = () if B == 0 else (B,)
    S = rng.random(lead + (n, n)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    W = rng.standard_normal(lead + (n, d)).astype(np.float32)
    h = (0.5 * rng.standard_normal(K + 1)).astype(np.float32)
    return [torch.tensor(x, device="cuda") for x in (S, W, h)]


def bound(nbytes, flops, flop_rate=PEAK_F32_FLOP_PER_S):
    """Least time in ms, the larger of bytes / 3.35 TB/s and operations
    over the peak rate of the units that do them (``flop_rate``: f32 FFMA
    on the CUDA cores by default), and what bounds it."""
    t_mem, t_ops = nbytes / PEAK_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem > t_ops
                                     else "operations")


def filter_bound_ms(B, n, d, K, w_bytes=4):
    """Least time for one filter call: each input read once, the output
    written once, against the 2Kn²dB operations of the S·Y products as the
    kernel computes them, three TF32 products each on the tensor cores
    (495 TFLOP/s). Returns (ms, what bounds it, and the bound of the
    2Kn²dB + (2K+1)ndB operations in f32 FFMA on the CUDA cores, the
    previous design's, in ms)."""
    B = max(B, 1)
    nbytes = 4 * B * n * n + 2 * w_bytes * B * n * d + 4 * (K + 1)
    products = 2 * K * n * n * d * B
    ms, by = bound(nbytes, 3 * products, PEAK_TF32_TC_FLOP_PER_S)
    return ms, by, bound(nbytes, products + (2 * K + 1) * n * d * B)[0]


def device_ms(fn, reps=50, key="graph_filter_kernel", tries=3):
    """The kernel's own time per launch: ``torch.profiler`` (CUPTI) device
    time of the kernels whose name holds ``key`` over ``reps`` calls (the
    profiler's second cycle, after a warm-up one), over their count; the
    wrapper's host time per call (``time.perf_counter`` over ``reps``
    calls without a synchronisation) beside it. A profile that does not
    hold exactly ``reps`` such launches is taken again, up to ``tries``
    times; if none does (CUPTI may be held by another tracer of the
    process, and then records no kernel at all), the time per call is
    taken by CUDA events over back-to-back calls instead. Returns (ms,
    host µs, how the ms was measured)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        # one warm-up cycle of the profiler, then the recorded one: CUPTI
        # may miss the first kernels of a window it has just started
        # tracing (4 of 50 at the resident block's shape)
        got = {}
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: got.update(events=p.key_averages())
                ) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total, count = 0.0, 0
        for e in got.get("events", ()):
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and key in e.key):
                total += e.self_device_time_total
                count += e.count
        if count == reps:
            return total / count / 1e3, host_us, "profiler"
        seen.append(count)
    how = (f"CUDA events over back-to-back calls; the profiler saw {seen} "
           f"{key} launches of {reps}")
    return median_ms(fn, inner=reps), host_us, how


def median_ms(fn, reps=15, inner=20, warm=5):
    """Median over ``reps`` of CUDA-event time over ``inner`` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def check_kernel(tag, paper):
    """Kernel vs plain at the test shapes, the ``paper`` shapes and a
    B = MAX_BATCH layer at DRYRUN's n; times the latter two. Returns the
    largest f32 |error| and {shape: times}."""
    from repro_torch.kernels.graph_filter import (bf16_error_bound,
                                                  graph_filter,
                                                  graph_filter_ref)
    rng = np.random.default_rng(0)
    max_err, timing = 0.0, {}
    d, K = paper[0][2], paper[0][3]
    timed = list(paper) + [(MAX_BATCH, DRYRUN_N, d, K)]
    shapes = [(0,) + s for s in TEST_SHAPES] + timed
    for B, n, d, K in shapes:
        S, W, h = filter_inputs(rng, B, n, d, K)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            Wt = W.to(dtype)
            y = graph_filter(S, Wt, h)
            torch.cuda.synchronize()
            yr = graph_filter_ref(S, Wt, h)
            err = (y.float() - yr.float()).abs().max().item()
            if not torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol):
                raise AssertionError(f"kernel != plain at B={B} n={n} d={d} "
                                     f"K={K} {dtype}: max |err| {err}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
                gate = ""
            else:
                use = _bound_use(y, yr, bf16_error_bound(yr))
                if use > 1:
                    raise AssertionError(
                        f"graph filter bf16 at B={B} n={n} d={d} K={K}: "
                        f"|err| exceeds bf16_error_bound ({use:.3f} of it)")
                gate = f"; bf16 bound use {use:.3f}"
            print(f"kernel vs plain B={B} n={n} d={d} K={K} {dtype}: "
                  f"max |err| {err:.3e} (tol {tol}{gate})")
        if (B, n, d, K) in timed:
            ms, host_us, how = device_ms(lambda: graph_filter(S, W, h))
            event_ms = median_ms(lambda: graph_filter(S, W, h))
            plain_ms = median_ms(lambda: graph_filter_ref(S, W, h))
            bound_ms, bound_by, ffma_ms = filter_bound_ms(B, n, d, K)
            timing[(B, n, d, K)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"[{tag}] graph_filter f32 B={B} n={n} d={d} K={K}: "
                  f"kernel {ms * 1e3:.2f} us device time ({how}), "
                  f"{event_ms * 1e3:.2f} us by CUDA events over back-to-back "
                  f"calls, host {host_us:.2f} us per call; bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}; split TF32 on the "
                  f"tensor cores), f32 FFMA bound {ffma_ms * 1e3:.2f} us; "
                  f"plain PyTorch version {plain_ms * 1e3:.2f} us (labelled, "
                  "no yardstick; no single PyTorch call computes this "
                  "function)")
    return max_err, timing


def check_backward(tag, paper):
    """The filter's gradient through the kernel path (dW: the
    transposed-S launch; dh: torch reductions) against autograd through
    the plain version, at the reference's VJP shapes and the ``paper``
    training shape (unbatched); times the dW launch there against the
    plain dW (the Horner filter on Sᵀ). Returns the largest dW |error|
    and the times."""
    from repro_torch.kernels.graph_filter import (graph_filter,
                                                  graph_filter_ref, ops)
    rng = np.random.default_rng(1)
    max_err, timing = 0.0, None
    for n, d, K in VJP_SHAPES + [paper]:
        S, W, h = filter_inputs(rng, 0, n, d, K)
        G = torch.tensor(rng.standard_normal((n, d)).astype(np.float32),
                         device="cuda")
        Wk, hk = W.clone().requires_grad_(True), h.clone().requires_grad_(True)
        before = graph_filter.bwd_launches
        dW, dh = torch.autograd.grad(graph_filter(S, Wk, hk), (Wk, hk), G)
        torch.cuda.synchronize()
        if graph_filter.bwd_launches != before + 1:
            raise AssertionError("the backward did not launch the kernel")
        Wp, hp = W.clone().requires_grad_(True), h.clone().requires_grad_(True)
        dWp, dhp = torch.autograd.grad(graph_filter_ref(S, Wp, hp),
                                       (Wp, hp), G)
        errs = [(a - b).abs().max().item() for a, b in ((dW, dWp),
                                                        (dh, dhp))]
        for name, a, b in (("dW", dW, dWp), ("dh", dh, dhp)):
            if not torch.allclose(a, b, atol=VJP_TOL, rtol=VJP_TOL):
                raise AssertionError(f"backward {name} != plain at n={n} "
                                     f"d={d} K={K}: max |err| {errs}")
        max_err = max(max_err, errs[0])
        print(f"backward vs plain n={n} d={d} K={K}: max |err| dW "
              f"{errs[0]:.3e}, dh {errs[1]:.3e} (tol {VJP_TOL})")
        if (n, d, K) == paper:
            ms, host_us, how = device_ms(
                lambda: ops.graph_filter_bwd(S, G, h))
            event_ms = median_ms(lambda: ops.graph_filter_bwd(S, G, h))
            plain_ms = median_ms(lambda: graph_filter_ref(S.mT, G, h))
            bound_ms, bound_by, ffma_ms = filter_bound_ms(1, n, d, K)
            timing = (ms, plain_ms, bound_ms, bound_by)
            print(f"[{tag}] graph_filter_bwd (dW) f32 n={n} d={d} K={K}: "
                  f"kernel {ms * 1e3:.2f} us device time ({how}), "
                  f"{event_ms * 1e3:.2f} us by CUDA events over back-to-back "
                  f"calls, host {host_us:.2f} us per call; bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}; split TF32 on the "
                  f"tensor cores), f32 FFMA bound {ffma_ms * 1e3:.2f} us; "
                  f"plain PyTorch version {plain_ms * 1e3:.2f} us (the Horner "
                  "filter on S^T; no single PyTorch call computes this "
                  "function)")
    return max_err, timing


def serve(tag, cfg, spec, buckets, device="cuda", sizes=SIZES):
    """Serve 24 requests (16 of ``sizes[0]`` agents, 8 of ``sizes[1]``)
    at ``cfg``'s widths through the kernel, over ``spec``'s ``buckets``
    (the ones the kernel was checked at). Returns the launch count and
    what phases 7c-7d hold against: θ, the requests with their futures,
    the summary and the profiled tick."""
    from repro_torch.core import surf, unroll
    from repro_torch.core.tasks import resolve_task
    from repro_torch.data.synthetic import sample_dataset
    from repro_torch.engine.core import TrainState
    from repro_torch.kernels.graph_filter import graph_filter, make_plain_mix
    from repro_torch.serve import FederationServer

    gen = torch.Generator(device=device).manual_seed(0)
    theta = unroll.init_udgd(gen, cfg, init="dgd")
    server = FederationServer(cfg, theta, buckets=spec,
                              max_batch=MAX_BATCH, device=device)
    warmed = server.warm([(n, cfg.test_per_agent) for n in sizes])
    if list(warmed) != list(buckets):
        raise AssertionError(f"warmed {warmed}, kernel checked at {buckets}")
    print(f"warmed buckets {warmed}")

    requests = []
    graph_filter.launches = graph_filter.bwd_launches = 0
    for i in range(24):
        n = sizes[1] if i % 3 == 2 else sizes[0]
        cfg_r = dataclasses.replace(cfg, n_agents=n)
        _, S = surf.make_problem(cfg_r, seed=i, device=device)
        ds = sample_dataset(cfg_r, seed=1000 + i)
        requests.append((cfg_r, S, ds, server.submit(S, ds, seed=i)))
    server.drain()
    launches = graph_filter.launches
    ticks = server.metrics.ticks
    if launches != ticks * cfg.n_layers or graph_filter.bwd_launches:
        raise AssertionError(f"kernel launches {launches} != ticks {ticks} "
                             f"x L {cfg.n_layers} (backward "
                             f"{graph_filter.bwd_launches})")
    print(f"graph_filter launches {launches} = {ticks} ticks x "
          f"{cfg.n_layers} layers")

    # Held against the single-cohort solve at the true shape through the
    # plain filter. Loss and W: the kernel's f32 tolerance. Accuracy: an
    # argmax over logits that agree to ~1e-6 can flip on a near-tie, so
    # at most one test row per layer may differ: 1.5 / (n t).
    task = resolve_task(cfg)
    plain = make_plain_mix()
    worst_loss, worst_acc, worst_w = 0.0, 0.0, 0.0
    for i, (cfg_r, S, ds, fut) in enumerate(requests):
        res = fut.result()
        ref = surf.solve_federation(cfg_r, TrainState(theta), S, ds, seed=i,
                                    mix_fn=plain, device=device)
        L_, n, t = cfg.n_layers, cfg_r.n_agents, cfg_r.test_per_agent
        for k in ("loss_per_layer", "acc_per_layer"):
            if res[k].shape != (L_,) or not np.isfinite(res[k]).all():
                raise AssertionError(f"request {i}: bad {k} {res[k]}")
        if res["W"].shape != (n, cfg.head_dim):
            raise AssertionError(f"request {i}: W {res['W'].shape}")
        with torch.no_grad():
            draws = unroll.featurize_cohort(
                unroll.solve_generator(i, 0, device),
                task.to_batch(ds, device), cfg_r, task=task)
            W_ref = unroll.udgd_forward(theta, S, *draws, cfg_r,
                                        mix_fn=plain,
                                        task=task)[0].cpu().numpy()
        np.testing.assert_allclose(res["W"], W_ref, atol=F32_TOL,
                                   rtol=F32_TOL)
        worst_w = max(worst_w, float(np.abs(res["W"] - W_ref).max()))
        np.testing.assert_allclose(res["loss_per_layer"],
                                   ref["loss_per_layer"],
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(res["acc_per_layer"],
                                   ref["acc_per_layer"],
                                   atol=1.5 / (n * t), rtol=0)
        worst_loss = max(worst_loss, float(np.abs(
            res["loss_per_layer"] - ref["loss_per_layer"]).max()))
        worst_acc = max(worst_acc, float(np.abs(
            res["acc_per_layer"] - ref["acc_per_layer"]).max()))
    final = [round(float(r[-1].result()["final_acc"]), 4) for r in requests]
    print(f"24 requests match solve_federation (plain filter): max |dloss| "
          f"{worst_loss:.3e}, max |dacc| {worst_acc:.3e}, max |dW| "
          f"{worst_w:.3e}; final acc {final}")
    summ = server.metrics.summary()
    summ["ms_per_tick"] = 1e3 * server.metrics.solve_time / ticks
    print(f"[{tag}] serve {cfg.n_layers} layers, d={cfg.head_dim}: "
          f"{json.dumps(summ)}")
    prof = profile_tick(tag, server, cfg, device, sizes[0])
    return launches, {"theta": theta, "requests": requests,
                      "summary": summ, "profile": prof}


def serve_large(tag, device="cuda", sizes=LARGE_SIZES):
    """Federations of ``sizes`` agents (past the kernel's resident limit)
    at SMOKE width through a ``FederationServer`` whose bucket ladder
    reaches 256, with the default mixer: the kernel's launches must be
    ticks × L, and each request's losses must match ``solve_federation``
    of the same cohort and seed through the plain filter. Returns the
    launch count."""
    from repro_torch.configs.surf_paper import SMOKE as cfg
    from repro_torch.core import surf, unroll
    from repro_torch.data.synthetic import sample_dataset
    from repro_torch.engine.core import TrainState
    from repro_torch.kernels.graph_filter import graph_filter, make_plain_mix
    from repro_torch.serve import BucketSpec, FederationServer

    gen = torch.Generator(device=device).manual_seed(0)
    theta = unroll.init_udgd(gen, cfg, init="dgd")
    server = FederationServer(cfg, theta, buckets=BucketSpec((64, 256), (4, 8)),
                              max_batch=2, device=device)
    requests = []
    graph_filter.launches = graph_filter.bwd_launches = 0
    for i, n in enumerate(sizes):
        cfg_r = dataclasses.replace(cfg, n_agents=n)
        _, S = surf.make_problem(cfg_r, seed=i, device=device)
        ds = sample_dataset(cfg_r, seed=500 + i)
        requests.append((cfg_r, S, ds, server.submit(S, ds, seed=i)))
    server.drain()
    launches, ticks = graph_filter.launches, server.metrics.ticks
    if (not launches or launches != ticks * cfg.n_layers
            or graph_filter.bwd_launches):
        raise AssertionError(f"kernel launches {launches} != ticks {ticks} "
                             f"x L {cfg.n_layers}")
    worst = 0.0
    for i, (cfg_r, S, ds, fut) in enumerate(requests):
        ref = surf.solve_federation(cfg_r, TrainState(theta), S, ds, seed=i,
                                    mix_fn=make_plain_mix(), device=device)
        got = fut.result()["loss_per_layer"]
        np.testing.assert_allclose(got, ref["loss_per_layer"], atol=F32_TOL,
                                   rtol=F32_TOL)
        worst = max(worst, float(np.abs(got - ref["loss_per_layer"]).max()))
    print(f"[{tag}] served SMOKE federations of {list(sizes)} agents "
          f"(bucket ladder to 256): graph_filter launches {launches} = "
          f"{ticks} ticks x {cfg.n_layers} layers; max |dloss| vs the plain "
          f"single-cohort solve {worst:.3e} (tol {F32_TOL})")
    return launches


def _plain_trajectory(cfg_r, theta, S, ds, seed, device):
    """One request's solve through the plain filter, layer by layer:
    the probe-batch grad-norm ratio after each layer, computed as
    ``unroll.udgd_forward_adaptive`` computes it, and each layer's W."""
    from repro_torch.core import unroll
    from repro_torch.core.tasks import resolve_task
    from repro_torch.kernels.graph_filter import make_plain_mix
    task, plain = resolve_task(cfg_r), make_plain_mix()
    batch = task.to_batch(ds, device)
    with torch.no_grad():
        W, Xl, Yl = unroll.featurize_cohort(
            unroll.solve_generator(seed, 0, device), batch, cfg_r, task=task)
        Xp, Yp = unroll.probe_batch(batch, cfg_r)
        g, Ws = [task.grad_norm(W, Xp, Yp)], []
        for l in range(cfg_r.n_layers):
            W = unroll.udgd_layer(unroll.layer_params(theta, l), S, W, Xl[l],
                                  Yl[l], cfg_r, mix_fn=plain, task=task)
            Ws.append(W)
            g.append(task.grad_norm(W, Xp, Yp))
        g = torch.stack(g)
        ratios = (g[1:] / g[:-1].clamp(min=1e-12)).cpu().numpy()
    return ratios, Ws


def _exit_depths(ratios, c, min_layers):
    """Realized depths under exit level c = 1 − threshold (the first
    layer l + 1 ≥ min_layers whose ratio reaches c, else L) and the
    smallest margin |ratio − c| over the decisions each request makes."""
    L_ = ratios.shape[1]
    depths, margin = [], math.inf
    for r in ratios:
        depth = L_
        for l in range(min_layers - 1, L_):
            margin = min(margin, abs(float(r[l]) - c))
            if r[l] >= c:
                depth = l + 1
                break
        depths.append(depth)
    return depths, margin


def tick_groups(buckets, max_batch):
    """The requests each tick admits when requests of these ``buckets``
    (in submission order) are queued at once and drained: the server's
    fullest-bucket rule, FIFO within a bucket and on ties (no deadlines;
    too few ticks for aging)."""
    queue, groups = list(enumerate(buckets)), []
    while queue:
        counts, first = {}, {}
        for pos, (_, b) in enumerate(queue):
            counts[b] = counts.get(b, 0) + 1
            first.setdefault(b, pos)
        pick = max(counts, key=lambda b: (min(counts[b], max_batch),
                                          -first[b]))
        group = [i for i, b in queue if b == pick][:max_batch]
        groups.append(group)
        queue = [(i, b) for i, b in queue if i not in group]
    return groups


def pick_threshold(ratios, min_layers, groups):
    """The exit threshold of phase 7c, chosen from the plain path's
    ratios by a fixed rule: every midpoint between two neighbouring
    ratios the requests could decide on is a candidate; keep those under
    which some tick (``groups``: the requests of each tick) ends before
    L, preferring those that leave a request at L, and take the one with
    the widest decision margin."""
    L_ = ratios.shape[1]
    vals = np.unique(ratios[:, min_layers - 1:].astype(np.float64))
    cands = []
    # midpoints, and one level under every ratio (all exit at min_layers)
    for c in np.append((vals[1:] + vals[:-1]) / 2, vals[0] - 0.01):
        if not 0.0 < c < 1.0:
            continue
        thr = 1.0 - float(c)
        depths, margin = _exit_depths(
            ratios, float(np.float32(1.0 - thr)), min_layers)
        if any(max(depths[i] for i in g) < L_ for g in groups):
            cands.append((max(depths) == L_, margin, thr, depths))
    if not cands:
        raise AssertionError("no exit threshold ends a tick before L")
    _, margin, thr, depths = max(cands, key=lambda x: (x[0], x[1]))
    return thr, depths, margin


def serve_adaptive(tag, cfg, spec, fixed, device="cuda", min_layers=2,
                   sizes=SIZES):
    """Phase 7c: the 24 requests of phase 7 through adaptive servers.

      * exit_threshold 0: every depth is L, and W, final_loss and
        final_acc are bit-equal to phase 7's fixed server; launches =
        ticks × L;
      * one threshold > 0 (``pick_threshold``): each depth equals the
        adaptive ``solve_federation`` through the plain filter, every
        exit decision of the plain path sits at least 1e-5 from the
        level, W and the loss agree within F32_TOL and the accuracy
        within 1.5/(n t); launches = Σ layers_run < ticks × L.

    Then one profiled adaptive tick. Returns the launch count."""
    from repro_torch.core import surf
    from repro_torch.engine.core import TrainState
    from repro_torch.kernels.graph_filter import graph_filter, make_plain_mix
    from repro_torch.serve import FederationServer
    theta, requests = fixed["theta"], fixed["requests"]
    L_ = cfg.n_layers
    cohorts = [(n, cfg.test_per_agent) for n in sizes]

    def run(cfg_s):
        server = FederationServer(cfg_s, theta, buckets=spec,
                                  max_batch=MAX_BATCH, depth="adaptive",
                                  device=device)
        server.warm(cohorts)
        graph_filter.launches = 0
        futs = [server.submit(S, ds, seed=i)
                for i, (_, S, ds, _) in enumerate(requests)]
        server.drain()
        return server, futs, graph_filter.launches

    # threshold 0: the fixed path bit for bit
    srv0, futs0, launches0 = run(cfg)
    if launches0 != srv0.metrics.ticks * L_:
        raise AssertionError(f"thr 0: launches {launches0} != ticks "
                             f"{srv0.metrics.ticks} x L")
    for i, ((_, _, _, ffut), afut) in enumerate(zip(requests, futs0)):
        f, a = ffut.result(), afut.result()
        if int(a["depth"]) != L_ or not all(
                np.array_equal(a[k], f[k])
                for k in ("W", "final_loss", "final_acc")):
            raise AssertionError(f"thr 0, request {i}: depth {a['depth']}, "
                                 "or W / final_loss / final_acc not "
                                 "bit-equal to the fixed server's")
    s0 = srv0.metrics.summary()
    print(f"[{tag}] 7c adaptive, exit_threshold 0: 24 requests at depth "
          f"{L_}, W and final metrics bit-equal to the fixed server; "
          f"launches {launches0} = {srv0.metrics.ticks} ticks x {L_}")

    # a threshold that spreads the depths, from the plain path's ratios
    trajs = [_plain_trajectory(cfg_r, theta, S, ds, i, device)
             for i, (cfg_r, S, ds, _) in enumerate(requests)]
    ratios = np.stack([r for r, _ in trajs])
    groups = tick_groups([spec.bucket_for(cfg_r.n_agents, cfg_r.test_per_agent)
                          for cfg_r, *_ in requests], MAX_BATCH)
    thr, predicted, margin = pick_threshold(ratios, min_layers, groups)
    if margin < 1e-5:
        raise AssertionError(f"an exit decision sits {margin:.3e} from the "
                             "level (< 1e-5)")
    cfg_t = dataclasses.replace(cfg, exit_threshold=thr,
                                min_layers=min_layers)
    srv, futs, launches = run(cfg_t)
    m = srv.metrics
    expected = sum(max(predicted[i] for i in g) for g in groups)
    if not launches == m.layers_run == expected < m.ticks * L_:
        raise AssertionError(f"launches {launches}, layers_run "
                             f"{m.layers_run}, predicted {expected}, "
                             f"ticks {m.ticks} x L")
    plain = make_plain_mix()
    worst = {"W": 0.0, "loss": 0.0, "acc": 0.0}
    for i, ((cfg_r, S, ds, _), fut, (_, Ws)) in enumerate(
            zip(requests, futs, trajs)):
        res = fut.result()
        ref = surf.solve_federation(
            dataclasses.replace(cfg_r, exit_threshold=thr,
                                min_layers=min_layers),
            TrainState(theta), S, ds, seed=i, depth="adaptive",
            mix_fn=plain, device=device)
        depth = int(res["depth"])
        if not depth == int(ref["depth"]) == predicted[i]:
            raise AssertionError(f"request {i}: depth {depth}, plain solve "
                                 f"{ref['depth']}, predicted {predicted[i]}")
        n, t = cfg_r.n_agents, cfg_r.test_per_agent
        W_ref = Ws[depth - 1].cpu().numpy()
        np.testing.assert_allclose(res["W"], W_ref, atol=F32_TOL,
                                   rtol=F32_TOL)
        np.testing.assert_allclose(res["final_loss"], ref["final_loss"],
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(res["final_acc"], ref["final_acc"],
                                   atol=1.5 / (n * t), rtol=0)
        worst["W"] = max(worst["W"], float(np.abs(res["W"] - W_ref).max()))
        worst["loss"] = max(worst["loss"], abs(float(res["final_loss"]
                                                     - ref["final_loss"])))
        worst["acc"] = max(worst["acc"], abs(float(res["final_acc"]
                                                   - ref["final_acc"])))
    summ = m.summary()
    if sum(summ["depth_hist"].values()) != len(requests):
        raise AssertionError(f"depth_hist {summ['depth_hist']}")
    fixed_s = fixed["summary"]
    rows = {"fixed (phase 7)": (fixed_s["ms_per_tick"],
                                fixed_s["federations_per_sec"], L_, 0.0),
            "adaptive thr 0": (1e3 * srv0.metrics.solve_time
                               / srv0.metrics.ticks,
                               s0["federations_per_sec"], s0["mean_depth"],
                               s0["batch_flops_saved"]),
            f"adaptive thr {thr:.6g}": (1e3 * m.solve_time / m.ticks,
                                        summ["federations_per_sec"],
                                        summ["mean_depth"],
                                        summ["batch_flops_saved"])}
    print(f"[{tag}] 7c adaptive, exit_threshold {thr!r} (min_layers "
          f"{min_layers}): depth_hist {summ['depth_hist']}, smallest exit "
          f"margin {margin:.4e} (plain path), launches {launches} = "
          f"Σ layers_run < {m.ticks} ticks x {L_}; vs the plain adaptive "
          f"solve: max |dW| {worst['W']:.3e}, |dloss| {worst['loss']:.3e}, "
          f"|dacc| {worst['acc']:.3e}")
    for name, (ms, fps, depth, saved) in rows.items():
        print(f"[{tag}] 7c {name}: {ms:.3f} ms per tick, {fps:.2f} "
              f"federations/s, mean depth {depth:.4f}, batch_flops_saved "
              f"{saved:.4f}")
    prof = profile_tick(tag, srv, cfg_t, device, sizes[0])
    fp = fixed["profile"]
    if (isinstance(fp["device_idle_ms"], float)
            and isinstance(prof["device_idle_ms"], float)
            and prof["graph_filter_launches"]):
        layers = prof["graph_filter_launches"]
        print(f"[{tag}] 7c host read cost: adaptive tick {layers} layers, "
              f"{prof['host_reads']} reads blocking "
              f"{prof['host_read_blocked_ms']:.3f} ms, device idle "
              f"{prof['device_idle_ms'] / layers:.4f} ms per layer; fixed "
              f"tick {fp['host_reads']} reads, device idle "
              f"{fp['device_idle_ms'] / L_:.4f} ms per layer")
    return launches0 + launches


def serve_async(tag, cfg, spec, fixed, device="cuda", sizes=SIZES):
    """Phase 7d: phase 7's 24 requests through ``AsyncDriver`` on a fresh
    fixed server; each result must equal the manual tick loop's (phase 7)
    bit for bit. Returns the launch count (ticks × L)."""
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.serve import AsyncDriver, FederationServer
    theta, requests = fixed["theta"], fixed["requests"]
    server = FederationServer(cfg, theta, buckets=spec, max_batch=MAX_BATCH,
                              device=device)
    server.warm([(n, cfg.test_per_agent) for n in sizes])
    graph_filter.launches = 0
    driver = AsyncDriver(server)
    try:
        driver.start()
        futs = [driver.submit(S, ds, seed=i)
                for i, (_, S, ds, _) in enumerate(requests)]
        driver.wait(futs, timeout_s=300.0)
    finally:
        driver.stop(timeout_s=300.0)
    launches, ticks = graph_filter.launches, server.metrics.ticks
    if launches != ticks * cfg.n_layers:
        raise AssertionError(f"7d launches {launches} != ticks {ticks} x L")
    for i, ((_, _, _, mfut), afut) in enumerate(zip(requests, futs)):
        m, a = mfut.result(), afut.result()
        diff = [k for k in m if not np.array_equal(m[k], a[k])]
        if diff:
            raise AssertionError(f"7d request {i}: {diff} differ from the "
                                 "manual tick loop's")
    stats = driver.stats()
    print(f"[{tag}] 7d AsyncDriver: 24 results bit-equal to the manual "
          f"tick loop; launches {launches} = {ticks} ticks x "
          f"{cfg.n_layers}; driver {json.dumps(stats)}; server "
          f"{server.metrics.summary()['federations_per_sec']:.2f} "
          "federations/s")
    return launches


def serve_sharded(tag, cfg, spec, fixed, device="cuda", sizes=SIZES):
    """Phase 7f: phase 7's 24 requests through ``FederationServer(mesh=)``
    on SERVE_SHARDS simulated shards of the card (``max_batch`` 8): each
    result within 5e-5 of the unsharded server's (phase 7;
    ``tests/test_qsharded.py``'s bound), L launches per shard per tick;
    federations/s per shard count. Then ``launch.surf_serve`` with
    ``--simulate-shards 8``: its sharded rows at 1, 2, 4 and 8 shards,
    gated by its own parity. Returns the forward launches."""
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.launch import surf_serve
    from repro_torch.serve import FederationServer
    theta, requests = fixed["theta"], fixed["requests"]
    total, rec = 0, {"unsharded": fixed["summary"]["federations_per_sec"]}
    for shards in SERVE_SHARDS:
        server = FederationServer(cfg, theta, buckets=spec,
                                  max_batch=MAX_BATCH,
                                  mesh=sim_mesh(1, shards))
        server.warm([(n, cfg.test_per_agent) for n in sizes])
        graph_filter.launches = 0
        futs = [server.submit(S, ds, seed=i)
                for i, (_, S, ds, _) in enumerate(requests)]
        server.drain()
        launches, ticks = graph_filter.launches, server.metrics.ticks
        if launches != ticks * cfg.n_layers * shards:
            raise AssertionError(f"7f launches {launches} != ticks {ticks} "
                                 f"x L x {shards} shards")
        total += launches
        worst = 0.0
        for i, ((_, _, _, mfut), sfut) in enumerate(zip(requests, futs)):
            m, r = mfut.result(), sfut.result()
            for k in ("final_loss", "final_acc", "loss_per_layer", "W"):
                d = float(np.abs(np.asarray(m[k]) - np.asarray(r[k])).max())
                worst = max(worst, d)
                if d >= 5e-5:
                    raise AssertionError(f"7f shards={shards} request {i} "
                                         f"{k} differs by {d}")
        rec[shards] = {"federations_per_sec":
                       server.metrics.summary()["federations_per_sec"],
                       "ticks": ticks, "launches": launches,
                       "max_abs_diff": worst}
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "bench_torch_sharded")
    graph_filter.launches = 0
    srv = surf_serve.main(["--out", out_dir, "--simulate-shards", "8"])
    total += graph_filter.launches
    rows = {r["shards"]: round(r["async_federations_per_sec"], 2)
            for r in srv["sharded_async"]}
    if sorted(rows) != [1, 2, 4, 8] or not all(
            r["simulated"] for r in srv["sharded_async"] if r["shards"] > 1):
        raise AssertionError(f"7f surf_serve sharded rows {rows}")
    rec["surf_serve_async_federations_per_sec"] = rows
    print(f"[{tag}] 7f sharded serving on SIMULATED shards of one card "
          f"(federations/s per shard count; results within 5e-5 of the "
          f"unsharded server): {json.dumps(rec)}")
    return total


def launchers(tag):
    """Phase 7e: ``launch.surf_serve`` and ``launch.surf_earlyexit`` at
    their defaults on the card, writing under build/bench_torch; their
    own assertions are the gates, except the early-exit frontier (claim
    3), which is reported: it is a property of the trained θ that the
    reference's launcher no longer meets at its own default seed either
    (ROADMAP queue 3). Returns the forward and dW launches."""
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.launch import surf_earlyexit, surf_serve
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "bench_torch")
    graph_filter.launches = graph_filter.bwd_launches = 0
    t0 = time.perf_counter()
    srv = surf_serve.main(["--out", out_dir])
    t1 = time.perf_counter()
    ee = surf_earlyexit.main(["--out", out_dir, "--frontier", "report"])
    t2 = time.perf_counter()
    fwd, bwd = graph_filter.launches, graph_filter.bwd_launches
    if not (fwd and bwd):
        raise AssertionError(f"7e launched forward {fwd}, dW {bwd}")
    (row,) = srv["sharded_async"]
    print(f"[{tag}] 7e surf_serve ({t1 - t0:.1f} s): "
          f"{srv['serve']['federations_per_sec']:.2f} federations/s, p50 "
          f"{srv['serve']['latency_p50_ms']:.3f} ms, p99 "
          f"{srv['serve']['latency_p99_ms']:.3f} ms, parity "
          f"{json.dumps(srv['parity'])}; async row: "
          f"{row['async_federations_per_sec']:.2f} federations/s, "
          f"tick_utilization {row['tick_utilization']:.4f}")
    print(f"[{tag}] 7e surf_earlyexit ({t2 - t1:.1f} s): fixed acc "
          f"{ee['fixed']['final_acc']:.4f}, frontier "
          f"{json.dumps(ee['fig5_frontier'])}, claim 3 "
          f"{'met' if ee['frontier_claim']['met'] else 'NOT met'} at eps "
          f"{ee['eps']}; serve depth_hist {ee['serve']['depth_hist']}")
    print(f"[{tag}] 7e launches: forward {fwd}, dW {bwd}")
    return fwd, bwd


def profile_tick(tag, server, cfg, device, n):
    """Where one full tick's device time goes: one more tick of
    ``max_batch`` n-agent requests under ``torch.profiler`` (after the
    launch count was read), device time summed by kind. The busy share
    is kernel time over the solve's wall time between two
    synchronizations; the copy of the results to the host follows the
    solve and is reported apart. Host reads of a device value
    (``aten::_local_scalar_dense``: the adaptive loop's ``act.any()``)
    are counted with the host time they block. Returns the record."""
    from repro_torch.core import surf
    from repro_torch.data.synthetic import sample_dataset
    cfg_r = dataclasses.replace(cfg, n_agents=n)
    for i in range(server.max_batch):
        _, S = surf.make_problem(cfg_r, seed=100 + i, device=device)
        server.submit(S, sample_dataset(cfg_r, seed=2000 + i), seed=i)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = server.metrics.solve_time
    with torch.profiler.profile(activities=acts) as prof:
        server.tick()
    solve_ms = 1e3 * (server.metrics.solve_time - before)
    kinds = {"graph_filter": 0.0, "gemm": 0.0, "other": 0.0, "copy": 0.0}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                  # host-side ops; kernels are counted
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = ("graph_filter" if "graph_filter_kernel" in name
                else "copy" if name.startswith(("memcpy", "memset"))
                else "gemm" if "gemm" in name else "other")
        kinds[kind] += ms
        kernels.append((round(ms, 4), e.count, e.key[:60]))
    busy = kinds["graph_filter"] + kinds["gemm"] + kinds["other"]
    reads = [e for e in prof.key_averages()
             if e.key == "aten::_local_scalar_dense"]
    out = {"solve_ms_profiled": solve_ms,
           "device_ms": kinds if busy > 0 else "not measured",
           "device_busy_share": busy / solve_ms if busy > 0
           else "not measured",
           "device_idle_ms": solve_ms - busy if busy > 0
           else "not measured",
           "host_reads": sum(e.count for e in reads),
           "host_read_blocked_ms": sum(e.cpu_time_total for e in reads) / 1e3,
           "graph_filter_launches": sum(
               e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "graph_filter_kernel" in e.key),
           "top_kernels": sorted(kernels, reverse=True)[:8]}
    print(f"[{tag}] profiled tick (B={server.max_batch}, n={n}, depth "
          f"{server.depth}): {json.dumps(out)}")
    return out


def paper_pool(cfg, device="cuda"):
    from repro_torch.core.tasks import resolve_task
    from repro_torch.data.synthetic import make_meta_dataset
    from repro_torch.data.pipeline import stack_meta_datasets
    mds = make_meta_dataset(cfg, TRAIN_POOL, seed=0)
    return mds, stack_meta_datasets(mds, resolve_task(cfg), device)


def _state_err(a, b):
    """Kernel state ``a`` against plain state ``b`` after one meta-step
    from one state. Returns (rows, ok) with one row per tensor: (name,
    max |a − b|, max |a − b| / max |b|, entries outside, noise-floor
    entries).

      * λ: every entry within STATE_TOL (atol and rtol, as the CPU tests).
      * Adam's m and v carry the step's gradient, so they hold it:
        max |a − b| ≤ STATE_TOL · max |b| for each tensor. An absolute
        STATE_TOL would not test them at PAPER size, where the clipped
        gradient's entries are about 1e-5 and v's about 1e-10.
      * θ: every entry within STATE_TOL, except where the step's gradient
        entry is at the f32 noise floor: there the two f32 evaluations of
        the gradient differ by more than NOISE_REL of Adam's m, and
        Adam's step −lr·m̂/(sqrt(v̂) + 1e-8), which is about ±lr even for
        a gradient of 1e-10, turns that noise into a θ difference of up
        to 2·lr. Those entries are counted and their share is held under
        NOISE_SHARE (a lower-precision gradient puts most entries there).
    """
    rows = [("lam", a.lam, b.lam, "entry")]
    rows += [(f"{m}.{k}", a.opt_state[m][k], b.opt_state[m][k], "scale")
             for m in ("m", "v") for k in a.theta]
    rows += [(k, a.theta[k], b.theta[k], "theta") for k in a.theta]
    out, ok = [], True
    for name, x, y, kind in rows:
        d_max = (x - y).abs().max().item()
        scale = y.abs().max().item()
        rel = d_max / scale if scale > 0 else (0.0 if d_max == 0
                                               else math.inf)
        n_bad = n_noise = 0
        if kind == "scale":
            ok = ok and d_max <= STATE_TOL * scale
        else:
            bad = ~torch.isclose(x, y, atol=STATE_TOL, rtol=STATE_TOL)
            if kind == "theta":
                ma, mb = a.opt_state["m"][name], b.opt_state["m"][name]
                noise = (ma - mb).abs() > NOISE_REL * mb.abs()
                n_noise = int(noise.sum().item())
                bad = bad & ~noise
                ok = ok and n_noise <= NOISE_SHARE * x.numel()
            n_bad = int(bad.sum().item())
            ok = ok and n_bad == 0
        out.append((name, d_max, rel, n_bad, n_noise))
    return out, ok


def _fmt_rows(rows):
    return [(n, f"{d:.3e}", f"{r:.3e}", c, z) for n, d, r, c, z in rows]


def _worst_entries(a, b, key, k=5):
    """The ``k`` entries of θ[key] that differ most, with Adam's m and
    sqrt(v) beside them."""
    diff = (a.theta[key] - b.theta[key]).abs().flatten()
    idx = torch.topk(diff, k).indices
    rows = []
    for st in (a, b):
        rows.append({"theta": st.theta[key].flatten()[idx].tolist(),
                     "m": st.opt_state["m"][key].flatten()[idx].tolist(),
                     "sqrt_v": st.opt_state["v"][key].flatten()[idx]
                     .sqrt().tolist()})
    return {"index": idx.tolist(), "kernel": rows[0], "plain": rows[1]}


def _powers_mix():
    """The plain filter summed in another f32 order, Σ_k h_k (S^k W) with
    the powers built one product at a time: a positive control for the
    parity gate (an f32-accurate filter that is not the plain one)."""
    def mix_fn(S, W, h):
        Y, P = h[0] * W, W
        for k in range(1, h.shape[0]):
            P = S @ P
            Y = Y + h[k] * P
        return Y

    mix_fn.takes_S = True
    mix_fn.tag = ("plain-powers",)
    return mix_fn


def meta_step_parity(tag, cfg, pool, device="cuda", schedule=None,
                     steps=PARITY_STEPS):
    """PARITY_STEPS meta-steps from one ``init_state`` (seed 0) on
    identical draws, through the kernel (default mixer) and through the
    plain filter, held as ``_state_err`` says. Each step starts both
    paths from the same state, the kernel path's: PAPER's first Adam
    steps drive the test loss to ~1e9 (the reference does the same at
    F=128), and chained runs would measure that chaos, not the kernel.
    The free-running difference is printed beside it. With a
    ``schedule`` (phase 9b) step t mixes with its S[t % T], as the
    training drivers do; else with ``make_problem(cfg, 0)``'s S.

    Negative control: at step 0 the plain path runs once more with TF32
    matmuls, a gradient about 1e-3 less precise; the gate must reject
    it, or it could not tell a lower-precision gradient from f32 (on
    the CPU, which has no TF32 mode, it is reported only). Beside it,
    not gated, the
    plain filter in another f32 order shows the noise floor an
    f32-accurate filter meets on the same inputs. A robust config (phase
    9f) hands both paths step t's δ from ``robust_generator(0, t)``.
    Returns the kernel path's state after ``steps`` steps."""
    from functools import partial

    from repro_torch.core import surf, unroll
    from repro_torch.engine.core import _meta_step_core, init_state
    from repro_torch.kernels.graph_filter import make_plain_mix
    _, S = surf.make_problem(cfg, seed=0, device=device)
    n_q = next(iter(pool.values())).shape[0]
    kern_s, _ = _meta_step_core(cfg)
    plain_s, _ = _meta_step_core(cfg, mix_fn=make_plain_mix())
    reorder_s, _ = _meta_step_core(cfg, mix_fn=_powers_mix())
    state = init_state(unroll.seeded_generator(0, device), cfg)
    free, ok = state, True
    for t in range(steps):
        S_t = S if schedule is None else schedule.S[t % schedule.steps]
        batch = {k: v[t % n_q] for k, v in pool.items()}
        draws = unroll.featurize_cohort(unroll.step_generator(0, t, device),
                                        batch, cfg)
        dl = ({"deltas": unroll.sample_deltas(
            unroll.robust_generator(0, t, device), cfg)}
            if kern_s.robust else {})
        kern, plain = partial(kern_s, S_t, **dl), partial(plain_s, S_t, **dl)
        reorder = partial(reorder_s, S_t, **dl)
        sk, mk = kern(state, batch, draws=draws)
        sp, mp = plain(state, batch, draws=draws)
        free, _ = plain(free, batch, draws=draws)
        rows, step_ok = _state_err(sk, sp)
        m_errs = {k: abs(mk[k].item() - mp[k].item()) for k in mk}
        m_bad = [k for k in mk if not torch.isclose(
            mk[k], mp[k], atol=STATE_TOL, rtol=STATE_TOL)]
        print(f"[{tag}] meta-step {t} kernel vs plain from one state "
              f"(tensor, max |d|, max |d| / max |plain|, outside, "
              f"noise-floor entries): {_fmt_rows(rows)}; "
              f"max |d metric| {max(m_errs.values()):.3e}, outside "
              f"{m_bad}; kernel metrics "
              f"{json.dumps({k: v.item() for k, v in mk.items()})}")
        if t == 0:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                sc, _ = plain(state, batch, draws=draws)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            rows_c, control_ok = _state_err(sc, sp)
            del sc
            print(f"[{tag}] negative control, TF32 plain vs f32 plain at "
                  f"step 0: {_fmt_rows(rows_c)}; gate "
                  f"{'passed (wrong)' if control_ok else 'rejected it'}")
            if control_ok and device != "cpu":
                raise AssertionError("the parity gate passed a TF32 "
                                     "gradient")
            # not gated: two f32 orders of the plain filter, the noise
            # floor that any f32-accurate filter meets on these inputs
            sr, _ = reorder(state, batch, draws=draws)
            rows_r, _ = _state_err(sr, sp)
            del sr
            print(f"[{tag}] f32 reorder control (plain filter as h_0 W + "
                  f"h_1 SW + h_2 S(SW)) vs plain at step 0, not gated: "
                  f"{_fmt_rows(rows_r)}")
        print(f"[{tag}] largest theta.M differences at step {t}: "
              f"{json.dumps(_worst_entries(sk, sp, 'M'))}")
        ok = ok and step_ok and not m_bad
        state = sk
    free_err = max(r[1] for r in _state_err(state, free)[0])
    print(f"[{tag}] free-running after {steps} steps (not gated): "
          f"max |d state| kernel vs plain {free_err:.3e}")
    if not ok:
        raise AssertionError("meta-step through the kernel != plain filter")
    return state


def train_paper(tag, cfg, mds, pool, device="cuda", scenario=None):
    """``train_surf`` at PAPER width through the kernel: launch counts
    (read just after), wall time, then the median meta-step time by CUDA
    events, peak memory and one profiled meta-step. With a ``scenario``
    (phase 9b) ``train_surf`` trains under ``make_scenario(cfg, scenario,
    TRAIN_STEPS, seed=0)``, must return the nominal S, and the timed
    steps mix with the schedule's S[t % T]; no step is profiled."""
    from repro_torch.core import surf, unroll
    from repro_torch.engine.core import _meta_step_core
    from repro_torch.kernels.graph_filter import graph_filter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph_filter.launches = graph_filter.bwd_launches = 0
    t0 = time.perf_counter()
    state, hist, S = surf.train_surf(cfg, mds, steps=TRAIN_STEPS,
                                     log_every=5, device=device,
                                     scenario=scenario)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = graph_filter.launches, graph_filter.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    sched = surf.make_scenario(cfg, scenario, TRAIN_STEPS, seed=0,
                               device=device)
    if sched is not None:
        _, S_nominal = surf.make_problem(cfg, seed=0, device=device)
        if not torch.equal(S, S_nominal):
            raise AssertionError("train_surf under a scenario did not "
                                 "return the nominal static S")
    want = (TRAIN_STEPS * cfg.n_layers, TRAIN_STEPS * (cfg.n_layers - 1))
    if (fwd, bwd) != want:
        raise AssertionError(f"launches forward {fwd}, backward {bwd}; "
                             f"expected {want}")
    for row in hist:
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"non-finite metrics {row}")
    print(f"[{tag}] train_surf PAPER {TRAIN_STEPS} steps, scenario "
          f"{scenario}: {wall:.3f} s "
          f"wall (first step included); launches forward {fwd} = "
          f"{TRAIN_STEPS} x {cfg.n_layers}, backward {bwd} = {TRAIN_STEPS} "
          f"x {cfg.n_layers - 1}; peak memory {peak / 2**30:.3f} GiB; "
          f"last logged {json.dumps(hist[-1])}")

    step_s, _ = _meta_step_core(cfg)

    def step(st, batch, gen):
        S_t = S if sched is None else sched.S[st.step % sched.steps]
        return step_s(S_t, st, batch, gen)

    n_q = next(iter(pool.values())).shape[0]
    times = []
    for i in range(13):
        t = state.step
        batch = {k: v[t % n_q] for k, v in pool.items()}
        gen = unroll.step_generator(0, t, device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    out = {"ms_per_meta_step": ms, "meta_steps_per_s": 1e3 / ms,
           "ms_spread": [float(np.min(times)), float(np.max(times))],
           "peak_memory_bytes": peak, "launches_forward": fwd,
           "launches_backward": bwd,
           "train_surf_wall_ms_per_step": 1e3 * wall / TRAIN_STEPS}
    print(f"[{tag}] PAPER meta-step, scenario {scenario} (median of "
          f"{len(times)} after 3 warm, CUDA events): {json.dumps(out)}")
    if sched is None:
        t = state.step
        batch = {k: v[t % n_q] for k, v in pool.items()}
        gen = unroll.step_generator(0, t, device)
        profile_step(tag, "PAPER meta-step",
                     lambda: step(state, batch, gen), device)
    return out, fwd, bwd


def profile_step(tag, label, fn, device="cuda"):
    """Device time of ``fn()`` by kernel kind under ``torch.profiler``;
    busy share = kernel time over the wall time between two
    synchronizations. Returns the printed record."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "graph_filter_kernel" in name:
            # the transposed-S (dW) instances: <float, true, ...>
            kind = ("graph_filter_bwd" if "<float, true" in name
                    else "graph_filter")
        elif name.startswith(("memcpy", "memset")):
            kind = "copy"
        elif "gemm" in name or "gemv" in name:
            kind = "gemm"
        elif "reduce" in name:
            kind = "reduce"
        elif "elementwise" in name or "vectorized" in name:
            kind = "elementwise"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + ms
        kernels.append((round(ms, 4), e.count, e.key[:70]))
    busy = sum(v for k, v in kinds.items() if k != "copy")
    out = {"wall_ms_profiled": wall_ms,
           "device_ms": kinds if busy > 0 else "not measured",
           "device_busy_share": busy / wall_ms if busy > 0
           else "not measured",
           "top_kernels": sorted(kernels, reverse=True)[:12]}
    print(f"[{tag}] profiled {label}: {json.dumps(out)}")
    return out


def check_schedule_kernel(tag, cfg, scheds, device="cuda"):
    """Phase 9b's kernel check: the filter forward and its dW against the
    plain version at the PAPER training shape (one cohort, unbatched) on
    each schedule's S_0 and on the first S_t (t >= 1, schedules in
    order) that isolates an agent (a row equal to e_i). Forward within
    F32_TOL, dW within VJP_TOL. Returns the largest errors."""
    from repro_torch.kernels.graph_filter import graph_filter, graph_filter_ref
    n, d, K = cfg.n_agents, cfg.head_dim, cfg.filter_taps
    eye = torch.eye(n, device=device)
    cases = [(f"{name} S_0", sch.S[0]) for name, sch in scheds.items()]
    isolated = next(((name, t) for name, sch in scheds.items()
                     for t in range(1, sch.steps)
                     if (sch.S[t] == eye).all(-1).any()), None)
    if isolated is None:
        raise AssertionError("no schedule isolates an agent")
    name, t = isolated
    S_iso = scheds[name].S[t]
    n_iso = int((S_iso == eye).all(-1).sum().item())
    cases.append((f"{name} S_{t} ({n_iso} isolated)", S_iso))
    rng = np.random.default_rng(4)
    worst = [0.0, 0.0]
    for label, S in cases:
        W = torch.tensor(rng.standard_normal((n, d)).astype(np.float32),
                         device=device)
        h = torch.tensor((0.5 * rng.standard_normal(K + 1)).astype(
            np.float32), device=device)
        G = torch.tensor(rng.standard_normal((n, d)).astype(np.float32),
                         device=device)
        Wk = W.clone().requires_grad_(True)
        y = graph_filter(S, Wk, h)
        (dW,) = torch.autograd.grad(y, Wk, G)
        Wp = W.clone().requires_grad_(True)
        yp = graph_filter_ref(S, Wp, h)
        (dWp,) = torch.autograd.grad(yp, Wp, G)
        torch.cuda.synchronize()
        errs = [(y - yp).abs().max().item(), (dW - dWp).abs().max().item()]
        if not (torch.allclose(y, yp, atol=F32_TOL, rtol=F32_TOL)
                and torch.allclose(dW, dWp, atol=VJP_TOL, rtol=VJP_TOL)):
            raise AssertionError(f"kernel != plain on {label}: {errs}")
        if "isolated" in label:
            # an isolated agent's row of S^k W is its own row of W
            rows = (S == eye).all(-1)
            hold = h.sum() * W[rows]
            if not torch.allclose(yp[rows], hold, atol=F32_TOL,
                                  rtol=F32_TOL):
                raise AssertionError("isolated rows do not hold their value")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        print(f"[{tag}] 9b kernel vs plain on {label}, n={n} d={d} K={K}: "
              f"max |err| forward {errs[0]:.3e} (tol {F32_TOL}), dW "
              f"{errs[1]:.3e} (tol {VJP_TOL})")
    return worst


def scheduled_training(tag, cfg, mds, pool, static_ms, device="cuda"):
    """Phase 9b: the graph filter on the scenarios' S_t, 3 scheduled
    meta-steps kernel vs plain at phase 8's gates, then ``train_surf``
    under the link-failure scenario through the kernel (counted from
    zero just before it). Returns (forward, dW launches, the record)."""
    from repro_torch.core import surf
    scheds = {name: surf.make_scenario(cfg, name, TRAIN_STEPS, seed=0,
                                       device=device)
              for name in SCHEDULE_SCENARIOS}
    errs = check_schedule_kernel(tag, cfg, scheds, device)
    meta_step_parity(tag, cfg, pool, device,
                     schedule=scheds["link-failure"])
    zero_counts()
    out, fwd, bwd = train_paper(tag, cfg, mds, pool, device,
                                scenario="link-failure")
    out["static_ms_per_meta_step"] = static_ms
    out["kernel_max_abs_err"] = {"forward": errs[0], "dW": errs[1]}
    print(f"[{tag}] 9b scheduled meta-step (link-failure, T = "
          f"{TRAIN_STEPS}) vs static (phase 9): {out['ms_per_meta_step']:.3f}"
          f" vs {static_ms:.3f} ms; peak memory "
          f"{out['peak_memory_bytes'] / 2**30:.3f} GiB")
    return fwd, bwd, out


def sim_mesh(seed_shards, agent_shards):
    """A ('seed', 'agent') mesh of shards SIMULATED on the one card: every
    shard is cuda:0, so the phases on it show the cost of the
    decomposition, not multi-card scaling."""
    from repro_torch.launch.mesh import make_surf_mesh
    return make_surf_mesh(seed_shards, agent_shards,
                          devices=["cuda:0"] * (seed_shards * agent_shards))


def _mix_parity(tag, label, cfg, pool, paths, schedule=None, device="cuda"):
    """PARITY_STEPS meta-steps from one ``init_state`` (seed 0) on one set
    of replayed draws: at each step the dense kernel path and every path
    of ``paths`` (label -> (mix_fn, shards or None)) start from the same
    state, the kernel path's, and each path's state is held against the
    kernel path's by ``_state_err`` (phase 8's gate). A halo-pallas path
    must launch shards · K · L forward and as many dW per step. Returns
    {label: {"max_state_err", "fwd", "bwd"}}."""
    from repro_torch.core import surf, unroll
    from repro_torch.engine.core import _meta_step_core, init_state
    from repro_torch.kernels.graph_filter import graph_filter
    _, S = surf.make_problem(cfg, seed=0, device=device)
    n_q = next(iter(pool.values())).shape[0]
    kern_s, _ = _meta_step_core(cfg)
    cores = {k: _meta_step_core(cfg, mix_fn=m)[0]
             for k, (m, _) in paths.items()}
    state = init_state(unroll.seeded_generator(0, device), cfg)
    out = {k: {"max_state_err": 0.0, "fwd": 0, "bwd": 0} for k in paths}
    per = cfg.filter_taps * cfg.n_layers
    ok = True
    for t in range(PARITY_STEPS):
        S_t = S if schedule is None else schedule.S[t % schedule.steps]
        batch = {k: v[t % n_q] for k, v in pool.items()}
        draws = unroll.featurize_cohort(unroll.step_generator(0, t, device),
                                        batch, cfg)
        sk, _ = kern_s(S_t, state, batch, draws=draws)
        for k, core in cores.items():
            before = (graph_filter.launches, graph_filter.bwd_launches)
            sh, _ = core(S_t, state, batch, draws=draws)
            torch.cuda.synchronize()
            fwd = graph_filter.launches - before[0]
            bwd = graph_filter.bwd_launches - before[1]
            shards = paths[k][1]
            if shards and (fwd, bwd) != (shards * per, shards * per):
                raise AssertionError(f"{label} {k} step {t}: launches "
                                     f"{(fwd, bwd)}, expected "
                                     f"{shards * per} each")
            rows, step_ok = _state_err(sh, sk)
            del sh
            rec = out[k]
            rec["fwd"] += fwd
            rec["bwd"] += bwd
            rec["max_state_err"] = max(rec["max_state_err"],
                                       max(r[1] for r in rows))
            print(f"[{tag}] {label} {k} vs dense kernel, meta-step {t} "
                  f"from one state (tensor, max |d|, max |d| / max |ref|, "
                  f"outside, noise-floor entries): {_fmt_rows(rows)}")
            ok = ok and step_ok
        state = sk
    if not ok:
        raise AssertionError(f"{label}: a sharded meta-step != the dense "
                             "kernel path")
    return out


def _ms_per_step(cfg, pool, mix_fn=None, schedule=None, device="cuda",
                 steps=4):
    """Median CUDA-event ms of ``steps`` − 1 single meta-steps (after one
    warm) through ``mix_fn`` from a fresh state, and the peak memory of
    those steps."""
    from repro_torch.core import surf, unroll
    from repro_torch.engine.core import _meta_step_core, init_state
    _, S = surf.make_problem(cfg, seed=0, device=device)
    core, _ = _meta_step_core(cfg, mix_fn=mix_fn)
    state = init_state(unroll.seeded_generator(0, device), cfg)
    n_q = next(iter(pool.values())).shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        t = state.step
        S_t = S if schedule is None else schedule.S[t % schedule.steps]
        batch = {k: v[t % n_q] for k, v in pool.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = core(S_t, state, batch,
                        unroll.step_generator(0, t, device))
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return float(np.median(times)), torch.cuda.max_memory_allocated()


def check_resident(tag, cfg, shard_counts=(4, 5)):
    """The halo-pallas resident block ``S0_loc @ Y`` at ``cfg``'s shard
    shapes (n/s agents, d = head_dim): the kernel as the 1-tap filter
    h = [0, 1] against the plain version (forward within F32_TOL, dW
    within VJP_TOL); the forward's and dW's device time (profiler), the
    bound, the plain version's time and the one PyTorch call that
    computes the same product, ``S0 @ Y``. Returns the largest errors
    and {n: times}."""
    from repro_torch.kernels.graph_filter import (graph_filter,
                                                  graph_filter_ref, ops)
    rng = np.random.default_rng(5)
    d, worst, out = cfg.head_dim, [0.0, 0.0], {}
    for s in shard_counts:
        n = cfg.n_agents // s
        S0, Y, _ = filter_inputs(rng, 0, n, d, 1)
        h = torch.tensor([0.0, 1.0], device="cuda")
        G = torch.tensor(rng.standard_normal((n, d)).astype(np.float32),
                         device="cuda")
        Yk = Y.clone().requires_grad_(True)
        yk = graph_filter(S0, Yk, h)
        (dY,) = torch.autograd.grad(yk, Yk, G)
        Yp = Y.clone().requires_grad_(True)
        yp = graph_filter_ref(S0, Yp, h)
        (dYp,) = torch.autograd.grad(yp, Yp, G)
        torch.cuda.synchronize()
        errs = [(yk - yp).abs().max().item(), (dY - dYp).abs().max().item()]
        if not (torch.allclose(yk, yp, atol=F32_TOL, rtol=F32_TOL)
                and torch.allclose(dY, dYp, atol=VJP_TOL, rtol=VJP_TOL)):
            raise AssertionError(f"resident n={n}: kernel != plain {errs}")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        with torch.no_grad():
            fwd_ms, fwd_host, how = device_ms(
                lambda: graph_filter(S0, Y, h))
            bwd_ms, _, bwd_how = device_ms(
                lambda: ops.graph_filter_bwd(S0, G, h))
            plain_ms = median_ms(lambda: graph_filter_ref(S0, Y, h))
            lib_ms = median_ms(lambda: S0 @ Y)
        bound_ms, bound_by, ffma_ms = filter_bound_ms(1, n, d, 1)
        out[n] = {"ms": fwd_ms, "dW_ms": bwd_ms, "host_us": fwd_host,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "ffma_bound_ms": ffma_ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "max_abs_err": errs}
        print(f"[{tag}] 9i resident block n={n} d={d} K=1 (h = [0, 1]): "
              f"kernel {fwd_ms * 1e3:.2f} us, dW {bwd_ms * 1e3:.2f} us "
              f"device time ({how}; dW: {bwd_how}), host {fwd_host:.2f} "
              f"us per call; "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}), f32 FFMA bound "
              f"{ffma_ms * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us; "
              f"S0 @ Y (torch.matmul) {lib_ms * 1e3:.2f} us; max |err| "
              f"forward {errs[0]:.3e}, dW {errs[1]:.3e}")
    return worst, out


def halo_training(tag, cfg, mds, pool, static_ms, device="cuda"):
    """Phase 9i: agent-sharded training at ``cfg``'s width on shards
    simulated on the card. 3 meta-steps of mix="halo" and
    mix="halo-pallas" at s in HALO_SHARDS, and of mix="ring" on the ring
    variant (degree 2) at s = 4, each from one state and one set of
    replayed draws, held against the dense kernel path by phase 8's gate
    (``_mix_parity``; halo-pallas: s · K · L forward and dW launches per
    step); then ms per meta-step and peak memory for each beside the
    dense one, the exchange rows per mixing round against the
    (s − 1) · n/s a dense gather moves, one halo-pallas s = 4 meta-step
    profiled by kernel kind; then ``train_surf(mix="halo-pallas")`` at
    s = 4 through the entry point, counted from zero.
    The resident block's kernel checks and times come first
    (``check_resident``). Returns (forward, dW launches of that run, the
    record, the resident's largest errors)."""
    from repro_torch.core import surf
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.topology.halo import halo_exchange_rows
    n, K, L = cfg.n_agents, cfg.filter_taps, cfg.n_layers
    res_err, res_times = check_resident(tag, cfg)
    _, S = surf.make_problem(cfg, seed=0, device=device)
    paths = {}
    for s in HALO_SHARDS:
        mesh = sim_mesh(1, s)
        for mix in ("halo", "halo-pallas"):
            paths[f"{mix} s={s}"] = (surf._resolve_mix(mix, mesh, cfg, S=S),
                                     s if mix == "halo-pallas" else None)
    par = _mix_parity(tag, "9i", cfg, pool, paths, device=device)
    ring_cfg = dataclasses.replace(cfg, topology="ring", degree=2)
    ring = surf._resolve_mix("ring", sim_mesh(1, 4), ring_cfg)
    par.update(_mix_parity(tag, "9i ring", ring_cfg, pool,
                           {"ring s=4": (ring, None)}, device=device))
    rec = {"dense_ms_per_meta_step": _ms_per_step(cfg, pool,
                                                   device=device)[0],
           "phase9_ms_per_meta_step": static_ms, "resident": res_times,
           "paths": {}}
    for k, (mix_fn, _) in list(paths.items()) + [("ring s=4", (ring, None))]:
        ms, peak = _ms_per_step(ring_cfg if k.startswith("ring") else cfg,
                                pool, mix_fn, device=device)
        s = int(k.split("s=")[1])
        rec["paths"][k] = {
            "ms_per_meta_step": ms, "peak_memory_bytes": peak,
            "exchange_rows": halo_exchange_rows(mix_fn.plan[1]),
            "dense_gather_rows": (s - 1) * n // s, **par[k]}
    # one halo-pallas s = 4 meta-step by kernel kind: where its time goes
    from repro_torch.core import unroll
    from repro_torch.engine.core import _meta_step_core, init_state
    core, _ = _meta_step_core(cfg, mix_fn=paths["halo-pallas s=4"][0])
    st = init_state(unroll.seeded_generator(0, device), cfg)
    batch = {k: v[0] for k, v in pool.items()}
    prof = profile_step(
        tag, "9i halo-pallas s=4 meta-step (simulated shards)",
        lambda: core(S, st, batch, unroll.step_generator(0, 0, device)),
        device)
    rec["profiled_halo_pallas_s4"] = {
        k: prof[k] for k in ("wall_ms_profiled", "device_ms",
                             "device_busy_share")}
    del paths, ring, core, st
    print(f"[{tag}] 9i agent-sharded PAPER meta-steps on SIMULATED shards "
          f"of one card (ms per meta-step median of 3 after 1 warm, CUDA "
          f"events): {json.dumps(rec)}")
    zero_counts()
    state, hist, _ = surf.train_surf(cfg, mds, steps=PARITY_STEPS,
                                     mix="halo-pallas", mesh=sim_mesh(1, 4),
                                     log_every=1)
    torch.cuda.synchronize()
    fwd, bwd = graph_filter.launches, graph_filter.bwd_launches
    want = PARITY_STEPS * 4 * K * L
    if (fwd, bwd) != (want, want):
        raise AssertionError(f"9i train_surf(halo-pallas, s=4) launches "
                             f"{(fwd, bwd)}, expected {want} each")
    if not all(np.isfinite(v) for row in hist for v in row.values()):
        raise AssertionError(f"9i non-finite metrics {hist}")
    print(f"[{tag}] 9i train_surf(PAPER, mix='halo-pallas', 4 simulated "
          f"shards, {PARITY_STEPS} steps): launches forward {fwd}, dW {bwd}"
          f" = {PARITY_STEPS} x 4 x {K} x {L} each")
    return fwd, bwd, rec, res_err


def halo_schedules_seeds(tag, cfg, mds, pool, device="cuda"):
    """Phase 9j: fig. 6's link-failure schedule through the scheduled
    halo-pallas mixer at s = 4, 3 meta-steps against the scheduled dense
    kernel path (phase 8's gate), and its ms per meta-step; then
    ``train_surf(cfg, seeds=(0, 1), mix="halo")`` on a (2, 2) simulated
    mesh for 3 steps, each seed row bit-equal to its lane's sequential run
    on the same mesh (``train_scan(mix_fn=seed_mix.lane(i))``)."""
    from repro_torch import engine as E
    from repro_torch.core import surf
    from repro_torch.topology.halo import make_scheduled_halo_mix
    from repro_torch.topology.halo import make_seed_halo_mix
    sched = surf.make_scenario(cfg, "link-failure", TRAIN_STEPS, seed=0,
                               device=device)
    mix = make_scheduled_halo_mix(sim_mesh(1, 4), "agent", sched,
                                  resident="pallas")
    par = _mix_parity(tag, "9j link-failure", cfg, pool,
                      {"halo-pallas s=4": (mix, 4)}, schedule=sched,
                      device=device)
    ms, peak = _ms_per_step(cfg, pool, mix, schedule=sched, device=device)
    dense_ms = _ms_per_step(cfg, pool, schedule=sched, device=device)[0]
    del mix
    mesh = sim_mesh(2, 2)
    seeds = (0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, hist, S_stack = surf.train_surf(cfg, mds, steps=PARITY_STEPS,
                                            seeds=seeds, mix="halo",
                                            mesh=mesh, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lanes = make_seed_halo_mix(mesh, "agent", S_stack)
    for i, s in enumerate(seeds):
        st, h = E.train_scan(cfg, S_stack[i], mds, PARITY_STEPS, seed=s,
                             mix_fn=lanes.lane(i), mesh=mesh, log_every=1)
        _states_equal(E.state_for_seed(states, i), st, f"9j seed {s} state")
        _rows_equal(hist, h, i, f"9j seed {s} history")
        del st
    rec = {"scheduled": {"ms_per_meta_step": ms, "dense_ms": dense_ms,
                         "peak_memory_bytes": peak,
                         **par["halo-pallas s=4"]},
           "seeds_wall_s": wall,
           "seed_exchange_rows": sum(len(r) for _, r, _ in lanes.plan[1])}
    print(f"[{tag}] 9j on SIMULATED shards of one card: scheduled "
          f"halo-pallas within phase 8's gate; train_surf(seeds={seeds}, "
          f"mix='halo', (2, 2) mesh) rows bit-equal to their lanes' "
          f"sequential runs; {json.dumps(rec)}")
    return rec


def qsharded_pools(tag, cfg, mds, device="cuda"):
    """Phase 9k: ``train_surf(q_sharded=True)`` on the 8-dataset pool over
    4 simulated shards against the replicated pool (θ within 1e-5; the
    select copies one dataset, so bit-equality is reported), and
    ``evaluate_async(mesh=)`` against the unsharded call (DGD-init θ,
    n_async 10). Both counted from zero: L and L − 1 launches per step,
    L per dataset. Returns (forward, dW launches, the record)."""
    from repro_torch.core import surf, unroll
    from repro_torch.data.synthetic import make_meta_dataset
    from repro_torch.engine.core import init_state
    from repro_torch.kernels.graph_filter import graph_filter
    mesh = sim_mesh(1, 4)
    ref, _, _ = surf.train_surf(cfg, mds, steps=PARITY_STEPS, log_every=0)
    ref = _on_host(ref)
    zero_counts()
    t0 = time.perf_counter()
    got, _, S = surf.train_surf(cfg, mds, steps=PARITY_STEPS, log_every=0,
                                mesh=mesh, q_sharded=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = max((got.theta[k].cpu() - ref.theta[k]).abs().max().item()
              for k in ref.theta)
    exact = all(torch.equal(got.theta[k].cpu(), ref.theta[k])
                for k in ref.theta)
    del got, ref
    if err > 1e-5:
        raise AssertionError(f"9k q_sharded theta differs by {err}")
    state = init_state(unroll.seeded_generator(0, device), cfg)
    test = make_meta_dataset(cfg, ASYNC_POOL, seed=888)
    a = surf.evaluate_async(cfg, state, S, test, 10, seed=0)
    b = surf.evaluate_async(cfg, state, S, test, 10, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    fwd, bwd = graph_filter.launches, graph_filter.bwd_launches
    L = cfg.n_layers
    want = (PARITY_STEPS * L + 2 * ASYNC_POOL * L, PARITY_STEPS * (L - 1))
    if (fwd, bwd) != want:
        raise AssertionError(f"9k launches {(fwd, bwd)}, expected {want}")
    aerr = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    if not all(np.allclose(a[k], b[k], atol=1e-5, rtol=1e-5) for k in a):
        raise AssertionError(f"9k evaluate_async(mesh=) differs: {aerr}")
    rec = {"theta_max_abs_err": err, "theta_bit_equal": exact,
           "train_wall_s": wall, "async_max_abs_err": aerr,
           "launches": list(want)}
    print(f"[{tag}] 9k Q-sharded pools on 4 SIMULATED shards of one card: "
          f"{json.dumps(rec)}")
    return fwd, bwd, rec


def async_eval(tag, cfg, device="cuda"):
    """Phase 9c: ``evaluate_async`` at ``cfg``'s width on ASYNC_POOL test
    datasets for each n_async of N_ASYNC under ASYNC_SEEDS, through the
    kernel (launches counted from zero: L per dataset and seed) and
    through the plain filter (same generators, so the same draws, and
    the same numpy masks): per-layer loss within F32_TOL of max(|loss|,
    1), accuracy within 1.5/(n t) (one flipped test row per layer). Then
    n_async = 0 (every mask False) on explicit draws must equal
    ``evaluate_surf``'s per-layer loss and accuracy on them bit for
    bit. θ is a DGD-init state (a trained PAPER θ diverges, ROADMAP
    queue 3). Returns (launches, record)."""
    from repro_torch.core import surf, unroll
    from repro_torch.core.tasks import resolve_task
    from repro_torch.data.synthetic import make_meta_dataset
    from repro_torch.engine.core import init_state
    from repro_torch.kernels.graph_filter import graph_filter, make_plain_mix
    state = init_state(unroll.seeded_generator(0, device), cfg)
    _, S = surf.make_problem(cfg, seed=0, device=device)
    test = make_meta_dataset(cfg, ASYNC_POOL, seed=888)
    L, n, t = cfg.n_layers, cfg.n_agents, cfg.test_per_agent
    launches, rec = 0, {"ms_per_call": {}, "final_acc": {}}
    worst_loss = worst_acc = 0.0
    plain = make_plain_mix()
    for na in N_ASYNC:
        masks = [surf.async_masks(cfg, ASYNC_POOL, na, seed=s)
                 for s in ASYNC_SEEDS]
        again = [surf.async_masks(cfg, ASYNC_POOL, na, seed=s)
                 for s in ASYNC_SEEDS]
        if not all(np.array_equal(a, b) and (a.sum(1) == na).all()
                   for a, b in zip(masks, again)):
            raise AssertionError(f"async masks differ at n_async={na}")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern = surf.evaluate_async(cfg, state, S, test, na,
                                   seeds=ASYNC_SEEDS, device=device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = graph_filter.launches
        want = L * ASYNC_POOL * len(ASYNC_SEEDS)
        if got != want or graph_filter.bwd_launches:
            raise AssertionError(f"9c n_async={na}: {got} launches, "
                                 f"expected {want}")
        launches += got
        ref = surf.evaluate_async(cfg, state, S, test, na,
                                  seeds=ASYNC_SEEDS, mix_fn=plain,
                                  device=device)
        if graph_filter.launches != got:
            raise AssertionError("the plain mixer launched the kernel")
        d_loss = np.abs(kern["loss_per_layer"] - ref["loss_per_layer"])
        d_acc = np.abs(kern["acc_per_layer"] - ref["acc_per_layer"])
        scale = np.maximum(np.abs(ref["loss_per_layer"]), 1.0)
        if not ((d_loss <= F32_TOL * scale).all()
                and (d_acc <= 1.5 / (n * t)).all()
                and np.isfinite(kern["loss_per_layer"]).all()):
            raise AssertionError(f"9c n_async={na}: kernel vs plain loss "
                                 f"{d_loss.max():.3e}, acc {d_acc.max():.3e}")
        worst_loss = max(worst_loss, float(d_loss.max()))
        worst_acc = max(worst_acc, float(d_acc.max()))
        rec["ms_per_call"][na] = ms
        rec["final_acc"][na] = kern["final_acc"].tolist()
    task = resolve_task(cfg)
    draws = [unroll.featurize_cohort(unroll.async_generator(0, q, device),
                                     task.to_batch(ds, device), cfg)
             for q, ds in enumerate(test)]
    sync = surf.evaluate_async(cfg, state, S, test, 0, device=device,
                               draws=draws)
    fixed = surf.evaluate_surf(cfg, state, S, test, device=device,
                               draws=draws)
    # the per-layer stacks bit for bit; the final values are the last
    # layer of the mean (as in the reference), where evaluate_surf means
    # its per-dataset finals in another order (1 ulp apart on the card)
    per_layer = ("loss_per_layer", "acc_per_layer")
    if not (all(np.array_equal(sync[k], fixed[k]) for k in per_layer)
            and sync["final_loss"] == fixed["loss_per_layer"][-1]
            and sync["final_acc"] == fixed["acc_per_layer"][-1]):
        raise AssertionError(
            "n_async = 0 != evaluate_surf on the same draws: "
            f"{ {k: float(np.abs(sync[k] - fixed[k]).max()) for k in fixed} }")
    rec.update(launches=launches, max_abs_dloss=worst_loss,
               max_abs_dacc=worst_acc, profiled_call=_profiled(
                   lambda: surf.evaluate_async(cfg, state, S, test,
                                               N_ASYNC[0], seeds=ASYNC_SEEDS,
                                               device=device), device))
    print(f"[{tag}] 9c evaluate_async PAPER, {ASYNC_POOL} datasets x seeds "
          f"{ASYNC_SEEDS}: kernel vs plain max |dloss| {worst_loss:.3e}, "
          f"max |dacc| {worst_acc:.3e}; n_async 0 == evaluate_surf per layer "
          f"(bit for bit); launches {launches}; {json.dumps(rec)}")
    return launches, rec


def _baseline_draws(name, rng, cfg, rounds, participate):
    """Phase 9d's numpy draws, in ``core.baselines``' formats."""
    n, m, b = cfg.n_agents, cfg.train_per_agent, cfg.batch_per_agent
    if name == "dgd":
        return None
    if name == "dsgd":
        return {"idx": rng.integers(0, m, (rounds, n, 1))}
    if name == "dfedavgm":
        return {"idx": rng.integers(0, m, (rounds, LOCAL_STEPS, n, b))}
    return {"sel": np.stack([rng.permutation(n)[:participate]
                             for _ in range(rounds)]),
            "idx": rng.integers(0, m, (rounds, LOCAL_STEPS, participate,
                                       b))}


def baselines_phase(tag, device="cuda"):
    """Phase 9d: the six FL baselines at PAPER width (decentralized on
    PAPER's S for BASELINE_ROUNDS rounds, classical on PAPER_STAR for
    BASELINE_ROUNDS_STAR) with fig. 5's learning rates, each on the card
    and on the CPU on one set of numpy draws: per-round loss within
    BASELINE_LOSS_TOL of the run's largest |loss|, accuracy within
    2/(n t); no graph-filter launch in the phase (the baselines mix with
    a plain S @ W, as the reference does). Returns the record."""
    from repro_torch.configs.surf_paper import PAPER, PAPER_STAR
    from repro_torch.core import baselines as BL
    from repro_torch.core import surf
    from repro_torch.data.synthetic import sample_dataset
    zero_counts()
    rec = {}
    for cfg, table, rounds in ((PAPER, BL.DECENTRALIZED, BASELINE_ROUNDS),
                               (PAPER_STAR, BL.CLASSICAL,
                                BASELINE_ROUNDS_STAR)):
        ds = sample_dataset(cfg, seed=7)
        _, S = surf.make_problem(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(9)
        W0 = (cfg.w0_mean + cfg.w0_std * rng.standard_normal(
            (cfg.n_agents, cfg.head_dim))).astype(np.float32)
        n, t = cfg.n_agents, cfg.test_per_agent
        for name, fn in table.items():
            draws = _baseline_draws(name, rng, cfg, rounds, BASELINE_PART)
            kw = {"rounds": rounds, "lr": BASELINE_LRS[name]}
            if draws is not None:
                kw["draws"] = draws
            if table is BL.CLASSICAL:
                kw["participate"] = BASELINE_PART
                args = (W0, ds, None, cfg)
            else:
                args = (S, W0, ds, None, cfg)
            warm = dict(kw, rounds=2)
            if draws is not None:
                warm["draws"] = {k: v[:2] for k, v in draws.items()}
            fn(*args, device=device, **warm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card_out = fn(*args, device=device, **kw)
            ms = 1e3 * (time.perf_counter() - t0) / rounds
            cpu_out = fn(*args, device="cpu", **kw)
            scale = float(np.abs(cpu_out["loss"]).max())
            d_loss = float(np.abs(card_out["loss"] - cpu_out["loss"]).max())
            d_acc = float(np.abs(card_out["acc"] - cpu_out["acc"]).max())
            if not (np.isfinite(card_out["loss"]).all()
                    and d_loss <= BASELINE_LOSS_TOL * scale
                    and d_acc <= 2.0 / (n * t)):
                raise AssertionError(f"9d {name}: card vs CPU loss {d_loss}"
                                     f" (scale {scale}), acc {d_acc}")
            rec[name] = {"ms_per_round": ms, "rounds": rounds,
                         "max_abs_dloss": d_loss, "loss_scale": scale,
                         "max_abs_dacc": d_acc,
                         "final_acc": float(card_out["acc"][-1])}
    if any(counts().values()):
        raise AssertionError(f"9d launched a kernel: {counts()}")
    _, S = surf.make_problem(PAPER, seed=0, device="cpu")
    ds = sample_dataset(PAPER, seed=7)
    W0 = np.zeros((PAPER.n_agents, PAPER.head_dim), np.float32)
    rec["dgd_profiled_20_rounds"] = _profiled(
        lambda: BL.run_dgd(S, W0, ds, None, PAPER, rounds=20,
                           lr=BASELINE_LRS["dgd"], device=device), device)
    print(f"[{tag}] 9d baselines at PAPER width, card vs CPU on one set of "
          f"numpy draws, no kernel launch: {json.dumps(rec)}")
    return rec


def check_slice_shapes(tag, device="cuda"):
    """Phases 3/4 additions: the filter forward (within F32_TOL) and dW
    (within VJP_TOL) against the plain version on the S the new paths
    mix with, unbatched as they launch it: SPARSE_SMOKE (n = 8, d = 16,
    K = 2; d far below one tile), the quickstart's (n = 20, d = 330) and
    ``make_problem(PAPER, i)``'s S for the four training seeds of 9e at
    d = 5130. Returns the largest errors."""
    from repro_torch.configs.surf_paper import PAPER, SPARSE_SMOKE
    from repro_torch.core import surf
    from repro_torch.kernels.graph_filter import graph_filter, graph_filter_ref
    cases = [("SPARSE_SMOKE", SPARSE_SMOKE, 0),
             ("quickstart", quickstart_cfg(), 0)]
    cases += [(f"PAPER seed {i}", PAPER, i) for i in SEEDS]
    rng = np.random.default_rng(6)
    worst = [0.0, 0.0]
    for label, cfg, seed in cases:
        _, S = surf.make_problem(cfg, seed=seed, device=device)
        n, d, K = cfg.n_agents, cfg.head_dim, cfg.filter_taps
        W, G = (torch.tensor(rng.standard_normal((n, d)).astype(np.float32),
                             device=device) for _ in range(2))
        h = torch.tensor((0.5 * rng.standard_normal(K + 1)).astype(
            np.float32), device=device)
        Wk, Wp = W.clone().requires_grad_(True), W.clone().requires_grad_(True)
        y = graph_filter(S, Wk, h)
        (dW,) = torch.autograd.grad(y, Wk, G)
        yp = graph_filter_ref(S, Wp, h)
        (dWp,) = torch.autograd.grad(yp, Wp, G)
        torch.cuda.synchronize()
        errs = [(y - yp).abs().max().item(), (dW - dWp).abs().max().item()]
        if not (torch.allclose(y, yp, atol=F32_TOL, rtol=F32_TOL)
                and torch.allclose(dW, dWp, atol=VJP_TOL, rtol=VJP_TOL)):
            raise AssertionError(f"kernel != plain on {label}: {errs}")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        print(f"[{tag}] 3/4 kernel vs plain on {label}'s S, n={n} d={d} "
              f"K={K}: max |err| forward {errs[0]:.3e} (tol {F32_TOL}), dW "
              f"{errs[1]:.3e} (tol {VJP_TOL})")
    return worst


def _states_equal(a, b, what):
    """Bit-equality of two TrainStates (every tensor leaf and the step),
    ``b`` on the card or on the host."""
    from repro_torch.checkpoint.io import flatten
    for (p, x), (_, y) in zip(flatten(a), flatten(b)):
        same = (torch.equal(x.to(y.device), y) if isinstance(x, torch.Tensor)
                else x == y)
        if not same:
            raise AssertionError(f"{what}: {p} differs")


def _on_host(state):
    """A TrainState's tensors copied to the host."""
    from repro_torch.checkpoint.io import flatten, unflatten
    return unflatten(state, iter(
        x.cpu() if isinstance(x, torch.Tensor) else x
        for _, x in flatten(state)))


def _rows_equal(batched, single, i, what):
    """Row i of a seed-batched history / snapshot list against a
    sequential run's, bit for bit."""
    if [r["step"] for r in batched] != [r["step"] for r in single]:
        raise AssertionError(f"{what}: steps differ")
    for rb, rs in zip(batched, single):
        for k in rs:
            if k != "step" and not np.array_equal(np.asarray(rb[k])[i],
                                                  rs[k]):
                raise AssertionError(f"{what}: step {rs['step']} {k}")


def seeds_paper(tag, cfg, mds, pool, static_ms, device="cuda"):
    """Phase 9e: ``train_surf(PAPER, seeds=SEEDS, eval_every)`` through
    the kernel, counted from zero: n_seeds × L forward and n_seeds ×
    (L − 1) dW launches per step plus L per eval dataset per seed per
    snapshot; S_stack[i] = make_problem(cfg, i)'s S; states, history and
    snapshots bit-equal, row for row, to the four sequential runs; the
    last snapshot bit-equal to ``snapshot_reference`` from the returned
    θ. Then ms per lockstep step (CUDA events), one lockstep step
    profiled by kernel kind, and the peak memory."""
    from repro_torch import engine as E
    from repro_torch.core import surf
    from repro_torch.core.tasks import resolve_task
    from repro_torch.data.synthetic import make_meta_dataset
    from repro_torch.engine.core import _meta_step_core
    from repro_torch.engine.scan import _Hooks, _run
    eval_ds = make_meta_dataset(cfg, SEED_EVAL_POOL, seed=123)
    n, L = len(SEEDS), cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    states, hist, snaps, S_stack = surf.train_surf(
        cfg, mds, steps=SEED_STEPS, seeds=SEEDS, eval_every=SEED_EVAL_EVERY,
        eval_datasets=eval_ds, log_every=1, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    peak = torch.cuda.max_memory_allocated()
    n_snaps = SEED_STEPS // SEED_EVAL_EVERY
    want = (SEED_STEPS * n * L + n_snaps * n * SEED_EVAL_POOL * L,
            SEED_STEPS * n * (L - 1))
    if (c["graph_filter"], c["graph_filter_bwd"]) != want:
        raise AssertionError(f"9e launches {c}, expected {want}")
    print(f"[{tag}] 9e train_surf(PAPER, {SEED_STEPS} steps, seeds {SEEDS}, "
          f"eval_every {SEED_EVAL_EVERY} on {SEED_EVAL_POOL} datasets): "
          f"{wall:.3f} s wall; launches forward {want[0]} = {SEED_STEPS} x "
          f"{n} x {L} + {n_snaps} x {n} x {SEED_EVAL_POOL} x {L}, dW "
          f"{want[1]}; peak memory {peak / 2**30:.3f} GiB ({peak / 1e9:.2f} "
          f"GB; predicted 38-40 GB)")
    for i, s in enumerate(SEEDS):
        _, S_i = surf.make_problem(cfg, seed=s, device=device)
        if not torch.equal(S_stack[i], S_i):
            raise AssertionError(f"S_stack[{i}] != make_problem(PAPER, {s})")
        st, h, sn, _ = surf.train_surf(
            cfg, mds, steps=SEED_STEPS, seed=s, eval_every=SEED_EVAL_EVERY,
            eval_datasets=eval_ds, log_every=1, device=device)
        _states_equal(E.state_for_seed(states, i), st, f"9e seed {s} state")
        _rows_equal(hist, h, i, f"9e seed {s} history")
        _rows_equal(snaps, sn, i, f"9e seed {s} snapshots")
        del st
    print(f"[{tag}] 9e rows bit-equal to the {n} sequential runs (states, "
          f"{len(hist)} history rows, {len(snaps)} snapshots)")
    ref = E.snapshot_reference(cfg, E.state_for_seed(states, 0).theta,
                               S_stack[0], eval_ds, SEEDS[0], SEED_STEPS - 1,
                               device=device)
    last = snaps[-1]
    for k, v in ref.items():
        if not np.array_equal(np.asarray(last[k])[0], v):
            raise AssertionError(f"9e snapshot {k} != snapshot_reference")
    print(f"[{tag}] 9e snapshot at step {last['step']} equals "
          f"snapshot_reference from the saved theta; final_acc by seed "
          f"{np.round(last['final_acc'], 4).tolist()}")
    # The driver's lockstep step, timed on its own: each seed's
    # engine.scan._run loop (the one train_scan_seeds advances) on fresh
    # copies of the returned rows, one meta-step each per lockstep step.
    step_s, _ = _meta_step_core(cfg)
    idle = _Hooks(cfg, "relu", None, resolve_task(cfg), device, None, 0,
                  None, None, 0, None)
    per = E.seeds._unstack(states, n, device)
    del states
    runs = [_run(step_s, S_stack[i].clone(), False, pool, per[i], s, 6,
                 device, None, None, idle) for i, s in enumerate(SEEDS)]
    per.clear()

    def lockstep():
        for run in runs:
            next(run)

    times = []
    for i in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lockstep()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    prof = profile_step(tag, f"9e lockstep step ({n} seeds)", lockstep,
                        device)
    for run in runs:
        run.close()
    del runs
    ms = float(np.median(times))
    out = {"ms_per_lockstep_step": ms, "ms_per_seed": ms / n,
           "ms_spread": [float(min(times)), float(max(times))],
           "phase9_ms_per_meta_step": static_ms,
           "profiled_device_ms": prof["device_ms"],
           "profiled_busy_share": prof["device_busy_share"],
           "peak_memory_bytes": peak, "train_surf_wall_s": wall,
           "launches_forward": want[0], "launches_backward": want[1]}
    print(f"[{tag}] 9e lockstep step (median of {len(times)} after 1 warm, "
          f"CUDA events): {json.dumps(out)}")
    return out


def robust_paper(tag, cfg, mds, pool, phase8, device="cuda"):
    """Phase 9f: RSDUN at PAPER width (σ = 0.1, 2 samples, the
    reference's test values): PARITY_STEPS meta-steps kernel vs plain on
    the same draws and δ at phase 8's gates; σ = 0 with 4 samples gives
    phase 8's kernel trajectory (``phase8``) bit for bit; the ms per
    robust meta-step; ``train_surf`` on the robust config, counted from
    zero (L and L − 1 launches per step)."""
    from functools import partial

    from repro_torch.core import surf, unroll
    from repro_torch.engine.core import _meta_step_core, init_state
    rob = dataclasses.replace(cfg, robust_sigma=0.1, robust_samples=2)
    meta_step_parity(tag, rob, pool, device)
    zero = dataclasses.replace(cfg, robust_sigma=0.0, robust_samples=4)
    step_s, _ = _meta_step_core(zero)
    _, S = surf.make_problem(cfg, seed=0, device=device)
    n_q = next(iter(pool.values())).shape[0]
    state = init_state(unroll.seeded_generator(0, device), zero)
    for t in range(PARITY_STEPS):
        batch = {k: v[t % n_q] for k, v in pool.items()}
        draws = unroll.featurize_cohort(unroll.step_generator(0, t, device),
                                        batch, zero)
        state, _ = step_s(S, state, batch, draws=draws)
    _states_equal(state, phase8, "9f sigma=0 vs phase 8's kernel trajectory")
    print(f"[{tag}] 9f robust_sigma=0, robust_samples=4: phase 8's kernel "
          f"trajectory bit for bit over {PARITY_STEPS} steps")
    del state
    rob_s, _ = _meta_step_core(rob)
    nom_s, _ = _meta_step_core(cfg)
    st0 = init_state(unroll.seeded_generator(0, device), cfg)
    batch = {k: v[0] for k, v in pool.items()}
    gen = partial(unroll.step_generator, 0, 0, device)
    dgen = partial(unroll.robust_generator, 0, 0, device)
    ms = {}
    for name, fn in (("robust", lambda: rob_s(S, st0, batch, gen(),
                                               delta_generator=dgen())),
                     ("nominal", lambda: nom_s(S, st0, batch, gen()))):
        times = []
        for i in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        ms[name] = (float(np.median(times)), float(min(times)),
                    float(max(times)))
    zero_counts()
    st, hist, _ = surf.train_surf(rob, mds, steps=PARITY_STEPS, log_every=1,
                                  device=device)
    c = counts()
    want = (PARITY_STEPS * cfg.n_layers, PARITY_STEPS * (cfg.n_layers - 1))
    if (c["graph_filter"], c["graph_filter_bwd"]) != want:
        raise AssertionError(f"9f launches {c}, expected {want}")
    print(f"[{tag}] 9f ms per meta-step (median, min, max of 5 after 1 "
          f"warm, CUDA events, same state and draws): robust {ms['robust']}"
          f", nominal {ms['nominal']}; train_surf robust {PARITY_STEPS} "
          f"steps: launches forward {want[0]}, dW {want[1]}; last logged "
          f"{json.dumps(hist[-1])}")
    return want, ms


def checkpoint_resume(tag, device="cuda"):
    """Phase 9g: the quickstart config trained CKPT_STEPS steps with
    ``checkpoint_every=CKPT_EVERY``, then resumed from step CKPT_RESUME:
    bit-equal to the uninterrupted run, single-seed and with SEEDS (not
    at PAPER width: one PAPER state is 6.37 GB on disk per seed). Written
    under build/ and removed after. Returns the launches of the
    checkpointing runs and the resumes."""
    import shutil

    from repro_torch import engine as E
    from repro_torch.core import surf
    from repro_torch.data.synthetic import make_meta_dataset
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    qs = quickstart_cfg()
    mds = make_meta_dataset(qs, 20, seed=0)
    zero_counts()
    full, hist, S = surf.train_surf(qs, mds, steps=CKPT_STEPS,
                                    log_every=5, checkpoint_every=CKPT_EVERY,
                                    checkpoint_dir=os.path.join(root, "one"),
                                    device=device)
    res, rhist = E.resume.resume_train_scan(
        qs, S, mds, CKPT_STEPS, 0, os.path.join(root, "one"),
        step=CKPT_RESUME, log_every=5, device=device)
    _states_equal(res, full, "9g single-seed resume")
    if rhist != [h for h in hist if h["step"] >= CKPT_RESUME]:
        raise AssertionError("9g resumed history differs")
    states, shist, S_stack = surf.train_surf(
        qs, mds, steps=CKPT_STEPS, seeds=SEEDS, log_every=5,
        checkpoint_every=CKPT_EVERY,
        checkpoint_dir=os.path.join(root, "seeds"), device=device)
    rs, rshist = E.resume.resume_train_scan_seeds(
        qs, S_stack, mds, CKPT_STEPS, SEEDS,
        os.path.join(root, "seeds"), step=CKPT_RESUME, log_every=5,
        device=device)
    torch.cuda.synchronize()
    c = counts()
    _states_equal(rs, states, "9g seed-batched resume")
    tail = [h for h in shist if h["step"] >= CKPT_RESUME]
    if [h["step"] for h in rshist] != [h["step"] for h in tail] or not all(
            np.array_equal(a[k], b[k]) for a, b in zip(rshist, tail)
            for k in b):
        raise AssertionError("9g seed-batched resumed history differs")
    files = sorted(os.listdir(os.path.join(root, "one")))
    shutil.rmtree(root)
    print(f"[{tag}] 9g quickstart config, {CKPT_STEPS} steps, checkpoint "
          f"every {CKPT_EVERY} ({files}), resumed from {CKPT_RESUME}: "
          f"single-seed and {len(SEEDS)}-seed runs bit-equal to the "
          f"uninterrupted ones; launches forward {c['graph_filter']}, dW "
          f"{c['graph_filter_bwd']}")
    return c["graph_filter"], c["graph_filter_bwd"]


def sparse_phase(tag, device="cuda"):
    """Phase 9h: the sparse-recovery task. 20 SPARSE_SMOKE meta-steps
    kernel vs plain from one state per step on the same draws (phase 8's
    gates, the TF32 control included); ``train_surf`` 20 steps
    through the kernel (L and L − 1 launches per step, counted from
    zero), its free-running losses beside the plain filter's;
    ``launch.surf_serve --task sparse`` at its defaults (its own
    assertions); a seed-batched sparse run bit-equal per row. Returns
    the forward and dW launches of the driven paths."""
    from repro_torch import engine as E
    from repro_torch.configs.surf_paper import SPARSE_SMOKE as cfg
    from repro_torch.core import surf
    from repro_torch.core.tasks import resolve_task
    from repro_torch.data.pipeline import stack_meta_datasets
    from repro_torch.kernels.graph_filter import make_plain_mix
    from repro_torch.launch import surf_serve
    task = resolve_task(cfg)
    mds = task.synth_datasets(cfg, 4, seed=0)
    meta_step_parity(tag, cfg, stack_meta_datasets(mds, task, device),
                     device, steps=SPARSE_STEPS)
    L, fwd, bwd = cfg.n_layers, 0, 0
    zero_counts()
    st, hist, S = surf.train_surf(cfg, mds, steps=SPARSE_STEPS, log_every=1,
                                  device=device)
    c = counts()
    want = (SPARSE_STEPS * L, SPARSE_STEPS * (L - 1))
    if (c["graph_filter"], c["graph_filter_bwd"]) != want:
        raise AssertionError(f"9h launches {c}, expected {want}")
    fwd, bwd = fwd + want[0], bwd + want[1]
    _, phist, _ = surf.train_surf(cfg, mds, steps=SPARSE_STEPS, log_every=1,
                                  device=device, mix_fn=make_plain_mix())
    dl = [abs(a["test_loss"] - b["test_loss"]) for a, b in zip(hist, phist)]
    print(f"[{tag}] 9h train_surf(SPARSE_SMOKE, {SPARSE_STEPS}): launches "
          f"{want}; test loss by step {[round(h['test_loss'], 5) for h in hist]}"
          f"; NMSE by step {[round(h['test_acc'], 4) for h in hist]}; "
          f"free-running |d test loss| kernel vs plain, max {max(dl):.3e} "
          "(not gated)")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "bench_torch_sparse")
    zero_counts()
    srv = surf_serve.main(["--out", out_dir, "--task", "sparse"])
    c = counts()
    fwd, bwd = fwd + c["graph_filter"], bwd + c["graph_filter_bwd"]
    print(f"[{tag}] 9h surf_serve --task sparse: "
          f"{srv['serve']['federations_per_sec']:.2f} federations/s, parity "
          f"{json.dumps(srv['parity'])}; launches forward "
          f"{c['graph_filter']}, dW {c['graph_filter_bwd']}")
    zero_counts()
    states, shist, S_stack = surf.train_surf(cfg, mds, steps=SPARSE_STEPS,
                                             seeds=SEEDS, log_every=1,
                                             device=device)
    c = counts()
    fwd, bwd = fwd + c["graph_filter"], bwd + c["graph_filter_bwd"]
    for i, s in enumerate(SEEDS):
        one, h, _ = surf.train_surf(cfg, mds, steps=SPARSE_STEPS, seed=s,
                                    log_every=1, device=device)
        _states_equal(E.state_for_seed(states, i), one,
                      f"9h sparse seed {s}")
        _rows_equal(shist, h, i, f"9h sparse seed {s} history")
    print(f"[{tag}] 9h seed-batched sparse run ({SEEDS}): rows bit-equal to "
          f"the sequential runs; launches forward {c['graph_filter']}, dW "
          f"{c['graph_filter_bwd']}")
    return fwd, bwd


def quickstart(tag, device="cuda"):
    """The reference quickstart's config, data and bar on the card."""
    from repro_torch.core import surf
    from repro_torch.data.synthetic import make_meta_dataset
    cfg = quickstart_cfg()
    meta_train = make_meta_dataset(cfg, 20, seed=0)
    meta_test = make_meta_dataset(cfg, 5, seed=123)
    t0 = time.perf_counter()
    state, hist, S = surf.train_surf(cfg, meta_train,
                                     steps=QUICKSTART_STEPS, log_every=50,
                                     device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = surf.evaluate_surf(cfg, state, S, meta_test, seeds=(0, 1, 2, 3),
                             device=device)
    final_acc = float(np.mean(res["final_acc"]))
    print(f"[{tag}] quickstart: {QUICKSTART_STEPS} meta-steps in "
          f"{wall:.3f} s; test_acc by logged step "
          f"{[(h['step'], round(h['test_acc'], 3)) for h in hist]}; "
          f"acc per layer {np.round(res['acc_per_layer'].mean(0), 3).tolist()}"
          f"; final_acc {final_acc:.4f} over 4 seeds x 5 datasets")
    if not final_acc > 0.5:
        raise AssertionError(f"quickstart final_acc {final_acc} <= 0.5")
    return final_acc


def quickstart_seeds(tag, device="cuda"):
    """Phase 10b: ``examples/quickstart.py --seeds 4 --eval-every 50`` on
    the card: the quickstart trained for SEEDS in lockstep with a
    snapshot every 50 steps on its 5 unseen datasets, each seed's model
    then evaluated under 4 evaluation seeds; the seed mean of
    ``final_acc`` must clear 0.5. Returns the forward and dW launches."""
    from repro_torch import engine as E
    from repro_torch.core import surf
    from repro_torch.data.synthetic import make_meta_dataset
    cfg = quickstart_cfg()
    meta_train = make_meta_dataset(cfg, 20, seed=0)
    meta_test = make_meta_dataset(cfg, 5, seed=123)
    zero_counts()
    t0 = time.perf_counter()
    states, hist, snaps, S = surf.train_surf(
        cfg, meta_train, steps=QUICKSTART_STEPS, log_every=50, seeds=SEEDS,
        eval_every=50, eval_datasets=meta_test, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    finals = [float(np.mean(surf.evaluate_surf(
        cfg, E.state_for_seed(states, i), S[i], meta_test,
        seeds=(0, 1, 2, 3), device=device)["final_acc"]))
        for i in range(len(SEEDS))]
    mean = float(np.mean(finals))
    curve = [(sn["step"], round(float(np.mean(sn["final_acc"])), 4),
              round(float(np.std(sn["final_acc"])), 4)) for sn in snaps]
    print(f"[{tag}] 10b quickstart --seeds {len(SEEDS)} --eval-every 50: "
          f"{QUICKSTART_STEPS} lockstep steps in {wall:.3f} s; final_acc by "
          f"seed {[round(f, 4) for f in finals]}, mean {mean:.4f}; snapshot "
          f"curve (step, mean, std of held-out final_acc) {curve}; launches "
          f"forward {c['graph_filter']}, dW {c['graph_filter_bwd']}")
    if not mean > 0.5:
        raise AssertionError(f"10b seed-mean final_acc {mean} <= 0.5")
    return c["graph_filter"], c["graph_filter_bwd"]


def build_all(tag):
    """Build the five kernel libraries, one ``nvcc`` each, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.graph_filter import ops as gf_ops
    from repro_torch.kernels.ssm_scan import ops as wkv_ops
    libs = {"graph_filter": gf_ops.LIB, "flash_attention": fa_ops.LIB,
            "wkv": wkv_ops.LIB, "flash_attention_bwd": fa_ops.BWD_LIB,
            "wkv_bwd": wkv_ops.BWD_LIB}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        infos = dict(zip(libs, pool.map(lambda lib: lib.build(),
                                        libs.values())))
    print(f"[{tag}] built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, info in infos.items():
        print(f"[{tag}] {info['path'].name}: {info['seconds']:.1f} s")
        print(info["log"])
    check_hgmma(tag, {name: info["path"] for name, info in infos.items()})


# The kernels that must run Hopper's warpgroup products, by library, and
# the instances each is built in: the flash kernels (the bf16 forward and
# backward, and the f32 forward's and backward's split-TF32 kernels; two
# instances, dh <= 64 and <= 128) and the wkv chunk-state passes (split
# TF32; four instances, f32 and bf16 by 16-byte and per-element loads).
HGMMA_KERNELS = {"flash_attention": (2, ("fwd_wgmma_kernel",
                                         "fwd_tf32_kernel")),
                 "flash_attention_bwd": (2, ("dkdv_wgmma_kernel",
                                             "dq_wgmma_kernel",
                                             "dkdv_tf32_kernel",
                                             "dq_tf32_kernel")),
                 "wkv": (4, ("wkv_state_kernel",)),
                 "wkv_bwd": (4, ("wkv_bwd_state_kernel",))}
# Of those, the ones whose SASS must hold no local-memory load or store.
SPILL_FREE = ("fwd_tf32_kernel", "dkdv_tf32_kernel", "dq_tf32_kernel",
              "wkv_state_kernel", "wkv_bwd_state_kernel")


def check_hgmma(tag, paths):
    """The wgmma kernels (``HGMMA_KERNELS``: the flash forward's
    ``fwd_wgmma_kernel`` in bf16 and ``fwd_tf32_kernel`` in f32, the flash
    backward's ``dkdv_wgmma_kernel`` and ``dq_wgmma_kernel`` in bf16 and
    ``dkdv_tf32_kernel`` and ``dq_tf32_kernel`` in f32, the wkv forward's
    and backward's chunk-state passes, each instance)
    hold Hopper's warpgroup products, the ``HGMMA`` instructions of their
    SASS, read with the toolkit's ``cuobjdump -sass``; the split-TF32 ones
    (``SPILL_FREE``) also no local-memory loads or stores (``LDL``/``STL``:
    spills). A kernel is matched by its
    whole mangled name (its length, then the name), so no library's count
    picks up another kernel. Fails if an instance has no HGMMA, spills or
    is missing."""
    from repro_torch.kernels._nvcc import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    for lib, (instances, kernels) in HGMMA_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(paths[lib])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        found, local, fn = {}, {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                if any(f"{len(k)}{k}I" in fn for k in kernels):
                    found[fn] = 0
                if any(f"{len(k)}{k}I" in fn for k in SPILL_FREE):
                    local[fn] = 0
            elif fn in found:
                found[fn] += "HGMMA" in line
                if fn in local:
                    local[fn] += any(f" {op}" in line for op in ("LDL",
                                                                 "STL"))
        print(f"[{tag}] 2 HGMMA instructions in each wgmma kernel of "
              f"{lib} (cuobjdump -sass): {json.dumps(found)}; local-memory "
              f"loads and stores: {json.dumps(local)}")
        if (len(found) != instances * len(kernels)
                or not all(found.values()) or any(local.values())):
            raise AssertionError(f"the wgmma kernels of {lib} lack HGMMA or "
                                 f"spill: {found}, {local}")


def counts():
    """Every kernel's launch counter."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.kernels.ssm_scan import wkv
    return {"graph_filter": graph_filter.launches,
            "graph_filter_bwd": graph_filter.bwd_launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "wkv": wkv.launches, "wkv_bwd": wkv.bwd_launches}


def zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.kernels.ssm_scan import wkv
    graph_filter.launches = graph_filter.bwd_launches = 0
    flash_attention.launches = flash_attention.bwd_launches = 0
    wkv.launches = wkv.bwd_launches = 0


def _live_pairs(S, skv, window, causal):
    """The (query, key) pairs a mask keeps: causal ones (inside the window
    where there is one), or all S · Skv of a non-causal call."""
    if not causal:
        return S * skv
    i = np.arange(S)
    return int((np.minimum(i + 1, window) if window else i + 1).sum())


def flash_bound_ms(B, H, KV, S, dh, window, elem, skv=None, causal=True):
    """Each of q (S rows), k, v (``skv`` rows, S by default) and o moved
    once; 4 dh operations per live (query, key) pair (q·k and p·v), the
    pairs that this mask keeps (causal, and inside the window where there
    is one; all of them when not causal). On the tensor cores, as the
    kernel computes them: bf16 products at 989 TFLOP/s, f32 ones as three
    TF32 products at 495 TFLOP/s. Returns (ms, what bounds it, and the
    bound of the same operations in f32 FFMA on the CUDA cores, in ms)."""
    skv = S if skv is None else skv
    flops = 4 * B * H * dh * _live_pairs(S, skv, window, causal)
    nbytes = elem * (2 * B * H * S * dh + 2 * B * KV * skv * dh)
    ms, by = (bound(nbytes, flops, PEAK_BF16_TC_FLOP_PER_S) if elem == 2
              else bound(nbytes, 3 * flops, PEAK_TF32_TC_FLOP_PER_S))
    return ms, by, bound(nbytes, flops)[0]


def wkv_bound_ms(B, H, T, dk, elem):
    """r, k, v, w read and y written once, u read, S_T (f32) written; about
    5 dk² operations per (b, h, t)."""
    nbytes = 5 * B * H * T * dk * elem + 4 * (H * dk + B * H * dk * dk)
    return bound(nbytes, 5 * B * H * T * dk * dk)


def _bound_use(out, ref, bound):
    """max over the elements of |out − ref| / bound: at most 1 passes."""
    err = (out.float() - ref.float()).abs()
    return (err / bound.clamp_min(1e-30)).max().item()


def check_flash(tag):
    """Flash kernel vs plain at the sweep, qwen3-4b, gemma3 (local and
    global) and the dense multi-card archs' shapes, f32 and bf16; times at the full-width
    shapes. Besides the reference's
    tolerances, f32 is held within FLASH_F32_ERR_MAX and bf16 within
    ``ops.bf16_error_bound`` of plain, per element. Returns the largest f32
    |error|, the qwen3-4b f32 timing, the largest bf16 |error| and the
    qwen3-4b bf16 timing (the wgmma kernel's record)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention, ops)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(2)
    max_err, timing, bf16_err, bf16_timing = 0.0, None, 0.0, None
    f32_errs = {}
    gemma = [FLASH_GEMMA, FLASH_GEMMA_GLOBAL]
    for B, H, KV, S, dh, win in (FLASH_SWEEP + [FLASH_QWEN] + gemma
                                 + list(FLASH_DENSE.values())):
        full = (B, H, KV, S, dh, win) in ([FLASH_QWEN] + gemma
                                          + list(FLASH_DENSE.values()))
        qkv32 = [torch.tensor(rng.standard_normal((B, n, S, dh)).astype(
            np.float32), device="cuda") for n in (H, KV, KV)]
        for dtype, tol in ((torch.float32, 10 * F32_TOL),
                           (torch.bfloat16, 10 * BF16_TOL)):
            q, k, v = (t.to(dtype) for t in qkv32)
            o = flash_attention(q, k, v, causal=True, window=win)
            torch.cuda.synchronize()
            o_ref = attention_ref(q, k, v, causal=True, window=win)
            err = (o.float() - o_ref.float()).abs().max().item()
            if not torch.allclose(o.float(), o_ref.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"flash kernel != plain at {(B, H, KV, S, dh, win)} "
                                     f"{dtype}: max |err| {err}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
                if err > FLASH_F32_ERR_MAX:
                    raise AssertionError(
                        f"flash f32 at {(B, H, KV, S, dh, win)}: max |err| "
                        f"{err} > {FLASH_F32_ERR_MAX} (split TF32 must keep "
                        "f32 accuracy)")
                gate = f"<= {FLASH_F32_ERR_MAX}"
            else:
                bf16_err = max(bf16_err, err)
                use = _bound_use(o, o_ref, ops.bf16_error_bound(
                    q, k, v, o_ref, causal=True, window=win))
                if use > 1:
                    raise AssertionError(
                        f"flash bf16 at {(B, H, KV, S, dh, win)}: |err| "
                        f"exceeds bf16_error_bound ({use:.3f} of it)")
                gate = f"bf16 bound use {use:.3f}"
            print(f"flash vs plain B={B} H={H} KV={KV} S={S} dh={dh} "
                  f"window={win} {dtype}: max |err| {err:.3e} (tol {tol}; "
                  f"{gate})")
            if dtype == torch.float32:
                f32_errs[str((B, H, KV, S, dh, win))] = err
            if ((B, H, KV, S, dh, win) == FLASH_QWEN
                    and dtype == torch.float32):
                print(f"[{tag}] flash f32 qwen3-4b shape: max |kernel - "
                      f"plain| {err:.3e} (<= {FLASH_F32_ERR_MAX})")
                tf32_forward_control(tag, q, k, v, win, o_ref)
            if not full:
                continue
            elem = q.element_size()
            ms = median_ms(lambda: flash_attention(q, k, v, window=win),
                           reps=7, inner=5, warm=2)
            plain_ms = median_ms(lambda: attention_ref(q, k, v, window=win),
                                 reps=3, inner=2, warm=1)
            mask = None
            if win:
                i = torch.arange(S, device="cuda")
                mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - win)
            lib_ms = median_ms(
                lambda: sdpa(q, k, v, attn_mask=mask, is_causal=not win,
                             enable_gqa=True), reps=7, inner=5, warm=2)
            eff_ms = None
            if dtype == torch.float32:
                # f32 SDPA's default dispatch takes the math fallback; the
                # memory-efficient backend takes f32 but not GQA, so K/V
                # are expanded to H heads outside the timed call.
                ke, ve = (t.repeat_interleave(H // KV, dim=1)
                          for t in (k, v))
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    eff_ms = median_ms(
                        lambda: sdpa(q, ke, ve, attn_mask=mask,
                                     is_causal=not win),
                        reps=7, inner=5, warm=2)
                del ke, ve
            bound_ms, bound_by, ffma_ms = flash_bound_ms(B, H, KV, S, dh,
                                                         win, elem)
            if (B, H, KV, S, dh, win) == FLASH_QWEN:
                if dtype == torch.float32:
                    timing = (ms, plain_ms, bound_ms, bound_by,
                              min(lib_ms, eff_ms))
                else:
                    bf16_timing = (ms, plain_ms, bound_ms, bound_by, lib_ms)
                    print(f"[{tag}] flash bf16 qwen3-4b shape: kernel "
                          f"{ms * 1e3:.1f} us, scaled_dot_product_attention "
                          f"{lib_ms * 1e3:.1f} us, tensor-core bound "
                          f"{bound_ms * 1e3:.1f} us ({bound_by})")
            eff = ("" if eff_ms is None else
                   f", memory-efficient backend {eff_ms * 1e3:.1f} us")
            print(f"[{tag}] flash_attention {dtype} B={B} H={H} KV={KV} "
                  f"S={S} dh={dh} window={win}: kernel {ms * 1e3:.1f} us, "
                  f"bound {bound_ms * 1e3:.1f} us ({bound_by}, tensor "
                  f"cores; f32 FFMA bound {ffma_ms * 1e3:.1f} us), plain "
                  f"PyTorch version {plain_ms * 1e3:.1f} us, "
                  f"scaled_dot_product_attention {lib_ms * 1e3:.1f} us"
                  f"{eff}")
        del qkv32, q, k, v, o, o_ref
        torch.cuda.empty_cache()
    print(f"[{tag}] 5 flash f32 max |kernel - plain| by shape (B, H, KV, "
          f"S, dh, window): {json.dumps(f32_errs)} (gate "
          f"{FLASH_F32_ERR_MAX})")
    return max_err, timing, bf16_err, bf16_timing


def tf32_forward_control(tag, q, k, v, win, o_ref):
    """Phase 5's negative control: the plain version with cuBLAS's
    one-pass TF32 on (restored after) must miss FLASH_F32_ERR_MAX against
    the f32 plain output ``o_ref``, so the gate tells one-pass TF32 from
    the kernel's split-TF32 accuracy at this shape."""
    from repro_torch.kernels.flash_attention import attention_ref
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        o = attention_ref(q, k, v, causal=True, window=win)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    err = (o - o_ref).abs().max().item()
    print(f"[{tag}] 5 control: one-pass TF32 (cuBLAS) plain forward, max "
          f"|TF32 - f32 plain| {err:.3e} (must exceed {FLASH_F32_ERR_MAX})")
    if err <= FLASH_F32_ERR_MAX:
        raise AssertionError(f"5 control: one-pass TF32 passed the f32 "
                             f"forward gate ({err})")


def check_wkv(tag):
    """wkv kernel vs plain (y and S_T) at the sweep and rwkv6-1.6b shapes;
    times at the latter (f32). Besides the reference's tolerances, bf16's
    y is held within ``ops.bf16_error_bound`` of plain, per element, and
    its f32 S at the f32 tolerance. Returns the largest f32 |error| and
    the timing."""
    from repro_torch.kernels.ssm_scan import ops, wkv, wkv_ref
    rng = np.random.default_rng(3)
    max_err, timing = 0.0, None
    B, H, T, dk = WKV_RWKV
    blocks, threads = ops.launch_shape(B, H, T, dk)
    want = B * H * -(-T // ops.CHUNK)
    print(f"[{tag}] wkv y launch at the rwkv6-1.6b shape: {blocks} blocks of "
          f"{threads} threads (a block per batch item, head and chunk of "
          f"{ops.CHUNK} steps; the state pass before it: {B * H} blocks)")
    if blocks != want:
        raise AssertionError(f"wkv launches {blocks} blocks at {WKV_RWKV}; "
                             f"the design runs every chunk in parallel "
                             f"({want})")
    for B, H, T, dk in WKV_SWEEP + [WKV_RAGGED, WKV_RWKV]:
        def mk():
            return 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
        r, k, v = mk(), mk(), mk()
        w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
        u = torch.tensor((0.1 * rng.standard_normal((H, dk))).astype(
            np.float32), device="cuda")
        f32 = [torch.tensor(a, device="cuda") for a in (r, k, v, w)]
        for dtype, tol in ((torch.float32, 20 * F32_TOL),
                           (torch.bfloat16, 20 * BF16_TOL)):
            args = [a.to(dtype) for a in f32]
            y, S = wkv(*args, u)
            y2, S2 = wkv(*args, u)
            torch.cuda.synchronize()
            bit_equal = torch.equal(y, y2) and torch.equal(S, S2)
            del y2, S2
            yr, Sr = wkv_ref(*args, u)
            errs = [(y.float() - yr.float()).abs().max().item(),
                    (S - Sr).abs().max().item()]
            if not (torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol)
                    and torch.allclose(S, Sr, atol=tol, rtol=tol)
                    and bit_equal):
                raise AssertionError(f"wkv kernel != plain at {(B, H, T, dk)} "
                                     f"{dtype}: max |err| y, S {errs}, rerun "
                                     f"bit-equal {bit_equal}")
            gate = ""
            if dtype == torch.float32:
                max_err = max(max_err, *errs)
            else:
                use = _bound_use(y, yr, ops.bf16_error_bound(yr))
                s_tol = 20 * F32_TOL
                if use > 1 or not torch.allclose(S, Sr, atol=s_tol,
                                                 rtol=s_tol):
                    raise AssertionError(
                        f"wkv bf16 at {(B, H, T, dk)}: y uses {use:.3f} of "
                        f"bf16_error_bound, S max |err| {errs[1]} (f32 tol "
                        f"{s_tol})")
                gate = f"; y bf16 bound use {use:.3f}, S tol {s_tol}"
            print(f"wkv vs plain B={B} H={H} T={T} dk={dk} {dtype}: max "
                  f"|err| y {errs[0]:.3e}, S {errs[1]:.3e} (tol {tol}"
                  f"{gate}); rerun bit-equal {bit_equal}")
            if (B, H, T, dk) == WKV_RWKV:
                ms = median_ms(lambda: wkv(*args, u), reps=7, inner=5,
                               warm=2)
                plain_ms = median_ms(lambda: wkv_ref(*args, u), reps=2,
                                     inner=1, warm=1)
                bound_ms, bound_by = wkv_bound_ms(B, H, T, dk,
                                                  args[0].element_size())
                if dtype == torch.float32:
                    timing = (ms, plain_ms, bound_ms, bound_by)
                print(f"[{tag}] wkv {dtype} B={B} H={H} T={T} dk={dk}: "
                      f"kernel {ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} "
                      f"us ({bound_by}), plain PyTorch version "
                      f"{plain_ms * 1e3:.1f} us (no single PyTorch call "
                      "computes this recurrence)")
    return max_err, timing


def flash_bwd_bound_ms(B, H, KV, S, dh, window, skv=None, causal=True):
    """The f32 gradient: q, k, v, o, do and the row lse read once, dq, dk,
    dv written once; 10 dh operations per live (query, key) pair (five
    products: q kᵀ and do vᵀ to rebuild P and dP, Pᵀ do, dSᵀ q, dS k). As
    three TF32 products each on the tensor cores (495 TFLOP/s), the
    forward's convention; returns (ms, what bounds it, the f32 FFMA bound
    of the same operations in ms). ``skv`` and ``causal`` as in
    ``flash_bound_ms``."""
    skv = S if skv is None else skv
    flops = 10 * B * H * dh * _live_pairs(S, skv, window, causal)
    nbytes = 4 * (4 * B * H * S * dh + 4 * B * KV * skv * dh + B * H * S)
    ms, by = bound(nbytes, 3 * flops, PEAK_TF32_TC_FLOP_PER_S)
    return ms, by, bound(nbytes, flops)[0]


def wkv_bwd_bound_ms(B, H, T, dk, elem=4):
    """r, k, v, w, dy read and dr, dk, dv, dw written once (``elem`` bytes
    each: f32 or bf16), u read and du written (f32); about 14 dk²
    operations per (b, h, t) in f32 FFMA (both entries compute in f32):
    the G update, the four gradient products and S_{t-1}'s update."""
    nbytes = elem * 9 * B * H * T * dk + 4 * 2 * H * dk
    return bound(nbytes, 14 * B * H * T * dk * dk)


def check_flash_bwd(tag):
    """Phase 5b: the flash backward kernel against autograd through the
    plain version (``attention_ref``) at the sweep, qwen3-4b and gemma3
    window-1024 shapes, f32: dq, dk and dv each within BWD_REL_TOL of the
    plain gradient's largest entry (f32 sums over up to 2048 keys in
    another order; one-pass TF32 products would miss it), and a rerun
    bit-equal (no atomics). At the two full-width shapes: µs per launch
    (CUDA events, median), the bound, the plain backward's time and
    ``scaled_dot_product_attention``'s backward (the memory-efficient
    backend on K/V expanded to H heads, as phase 5 times its forward).
    Returns the largest |error| and the qwen3-4b timing."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import attention_ref, ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(5)
    max_err, timing = 0.0, None
    for B, H, KV, S, dh, win in FLASH_SWEEP + [FLASH_QWEN, FLASH_GEMMA]:
        shape = (B, H, KV, S, dh, win)
        q, k, v, do = (torch.tensor(rng.standard_normal((B, n, S, dh)).astype(
            np.float32), device="cuda") for n in (H, KV, KV, H))
        o, lse = ops._launch(q, k, v, True, win, want_lse=True)
        grads = ops._launch_bwd(q, k, v, o, lse, do, True, win)
        again = ops._launch_bwd(q, k, v, o, lse, do, True, win)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o_ref = attention_ref(*xs, causal=True, window=win)
        ref = torch.autograd.grad(o_ref, xs, do, retain_graph=True)
        errs = {n: (g - r).abs().max().item() for n, g, r in
                zip(("dq", "dk", "dv"), grads, ref)}
        rel = {n: errs[n] / r.abs().max().item() for n, r in
               zip(("dq", "dk", "dv"), ref)}
        print(f"flash backward vs plain {shape}: max |err| "
              f"{json.dumps(errs)}, of the largest |plain| "
              f"{json.dumps(rel)}; rerun bit-equal {bit_equal}")
        if max(rel.values()) > BWD_REL_TOL or not bit_equal:
            raise AssertionError(f"flash backward at {shape}: {rel} > "
                                 f"{BWD_REL_TOL} or rerun not bit-equal")
        max_err = max(max_err, *errs.values())
        if shape == FLASH_QWEN:
            tf32_control(tag, q, k, v, do, win, ref)
        if shape in (FLASH_QWEN, FLASH_GEMMA):
            ms = median_ms(lambda: ops._launch_bwd(q, k, v, o, lse, do, True,
                                                   win), reps=5, inner=3,
                           warm=1)
            plain_ms = median_ms(lambda: torch.autograd.grad(
                o_ref, xs, do, retain_graph=True), reps=3, inner=1, warm=1)
            del o_ref, xs, ref
            torch.cuda.empty_cache()
            mask = None
            if win:
                i = torch.arange(S, device="cuda")
                mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - win)
            ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
            xe = [t.clone().requires_grad_() for t in (q, ke, ve)]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                oe = sdpa(*xe, attn_mask=mask, is_causal=not win)
                lib_ms = median_ms(lambda: torch.autograd.grad(
                    oe, xe, do, retain_graph=True), reps=5, inner=3, warm=1)
            del ke, ve, xe, oe
            bound_ms, bound_by, ffma_ms = flash_bwd_bound_ms(B, H, KV, S, dh,
                                                             win)
            if shape == FLASH_QWEN:
                timing = (ms, plain_ms, bound_ms, bound_by, lib_ms)
            print(f"[{tag}] flash_attention_bwd f32 B={B} H={H} KV={KV} "
                  f"S={S} dh={dh} window={win}: kernel {ms * 1e3:.1f} us, "
                  f"bound {bound_ms * 1e3:.1f} us ({bound_by}, split TF32 "
                  f"on the tensor cores; the kernel's 7 products "
                  f"{bound_ms * 1.4e3:.1f} us; f32 FFMA bound "
                  f"{ffma_ms * 1e3:.1f} "
                  f"us), plain PyTorch backward {plain_ms * 1e3:.1f} us, "
                  f"scaled_dot_product_attention backward (memory-efficient"
                  f", K/V expanded) {lib_ms * 1e3:.1f} us")
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return max_err, timing


def tf32_control(tag, q, k, v, do, win, ref):
    """Phase 5b's negative control: autograd through the plain version
    with cuBLAS's one-pass TF32 on (restored after) must miss BWD_REL_TOL
    against the f32 gradient ``ref``, so the gate tells one-pass TF32
    from f32 accuracy at this shape."""
    from repro_torch.kernels.flash_attention import attention_ref
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(attention_ref(*xs, causal=True,
                                                window=win), xs, do)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    rel = {n: ((g - r).abs().max() / r.abs().max()).item()
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    print(f"[{tag}] 5b control: one-pass TF32 (cuBLAS) gradient of the "
          f"plain version, of the largest |f32 plain| {json.dumps(rel)} "
          f"(must exceed {BWD_REL_TOL})")
    if max(rel.values()) <= BWD_REL_TOL:
        raise AssertionError(f"5b control: one-pass TF32 passed the "
                             f"backward gate ({rel})")


def check_wkv_bwd(tag):
    """Phase 6b: the wkv backward kernel against autograd through the plain
    version (``wkv_ref``, a loop over T) at the sweep and rwkv6-1.6b
    shapes, f32, each call as the training path through ``WKV`` makes it
    (with the chunk-start states the forward launch returned): dr, dk, dv,
    dw and du each within BWD_REL_TOL of the plain gradient's largest
    entry, and a rerun bit-equal; the first three decays of every row near
    0 (1e-7) at one sweep shape, those of steps 62-66 (across the first
    chunk boundary) at the ragged shape. µs per launch, the bound and the
    plain backward's time at the rwkv6-1.6b shape (no PyTorch call
    computes this recurrence). Returns the largest |error| and the
    timing."""
    from repro_torch.kernels.ssm_scan import ops, wkv_ref
    rng = np.random.default_rng(6)
    max_err, timing = 0.0, None
    names = ("dr", "dk", "dv", "dw", "du")
    for B, H, T, dk in WKV_SWEEP + [WKV_RAGGED, WKV_RWKV]:
        def mk():
            return 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
        r, k, v = mk(), mk(), mk()
        w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
        if (B, H, T, dk) == WKV_SWEEP[1]:
            w[..., :3, :] = 1e-7
        if (B, H, T, dk) == WKV_RAGGED:
            w[..., 62:67, :] = 1e-7      # across the first chunk boundary
        u = (0.1 * rng.standard_normal((H, dk))).astype(np.float32)
        args = [torch.tensor(a, device="cuda") for a in (r, k, v, w, u)]
        dy = torch.tensor(mk(), device="cuda")
        states = ops._launch(*args)[2]
        grads = ops._launch_bwd(*args, dy, None, states)
        again = ops._launch_bwd(*args, dy, None, states)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        xs = [a.clone().requires_grad_() for a in args]
        y_ref, _ = wkv_ref(*xs)
        ref = torch.autograd.grad(y_ref, xs, dy, retain_graph=True)
        errs = {n: (g - q).abs().max().item() for n, g, q in
                zip(names, grads, ref)}
        rel = {n: errs[n] / q.abs().max().item() for n, q in zip(names, ref)}
        print(f"wkv backward vs plain B={B} H={H} T={T} dk={dk}: max |err| "
              f"{json.dumps(errs)}, of the largest |plain| "
              f"{json.dumps(rel)}; rerun bit-equal {bit_equal}")
        if max(rel.values()) > BWD_REL_TOL or not bit_equal:
            raise AssertionError(f"wkv backward at {(B, H, T, dk)}: {rel} > "
                                 f"{BWD_REL_TOL} or rerun not bit-equal")
        max_err = max(max_err, *errs.values())
        if (B, H, T, dk) == WKV_RWKV:
            ms = median_ms(lambda: ops._launch_bwd(*args, dy, None, states),
                           reps=7, inner=5, warm=2)
            plain_ms = median_ms(lambda: torch.autograd.grad(
                y_ref, xs, dy, retain_graph=True), reps=2, inner=1, warm=1)
            bound_ms, bound_by = wkv_bwd_bound_ms(B, H, T, dk)
            timing = (ms, plain_ms, bound_ms, bound_by)
            print(f"[{tag}] wkv_bwd f32 B={B} H={H} T={T} dk={dk}: kernel "
                  f"{ms * 1e3:.1f} us, bound "
                  f"{bound_ms * 1e3:.1f} us ({bound_by}), plain PyTorch "
                  f"backward {plain_ms * 1e3:.1f} us (no single PyTorch call "
                  "computes this recurrence)")
        del xs, y_ref, ref, grads, states
        torch.cuda.empty_cache()
    return max_err, timing


def _named(tree, prefix=""):
    """(dotted name, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}.{k}".lstrip("."))
    else:
        yield prefix, tree


def _grad_rows(got, ref):
    """{name: max |got − ref| / max |ref|} per gradient tensor, the key
    biases (``_key_bias``: zero analytically) aside."""
    return {n: ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
            for (n, g), (_, r) in zip(_named(got), _named(ref))
            if not _key_bias(n)}


def _zero_grads(got, ref):
    """{name: max(|got|, |ref|) over the step's largest |ref| entry} for
    the key biases, whose gradient is zero analytically."""
    largest = max(r.abs().max().item() for _, r in _named(ref))
    return {n: max(g.abs().max().item(), r.abs().max().item()) / largest
            for (n, g), (_, r) in zip(_named(got), _named(ref))
            if _key_bias(n)}


def _global_norm(tree):
    return torch.sqrt(sum(t.square().sum() for _, t in _named(tree))).item()


class _TorchProxy:
    """``torch`` with some functions replaced, for one module's global
    name ``torch`` (``mock.patch.object(moe, "torch", ...)``)."""

    def __init__(self, **fns):
        self.__dict__.update(fns)

    def __getattr__(self, name):
        return getattr(torch, name)


class RouteReplay:
    """Holds the expert choice of the MoE layers fixed between the kernel
    path and its plain reference run (phases 14-15). Routing is
    discontinuous: the flash kernel's ~1e-6 differences from the plain
    attention can flip a near-tied top-k choice, and a flipped choice is a
    different function, not an error. Under ``record()`` every top-k of
    ``models.moe.route`` is kept in call order; under ``replay()`` each
    top-k returns the recorded indices in the same order (the weights are
    the plain path's own probabilities at those indices, renormalized by
    ``route`` as usual) and counts the tokens whose own choice differs
    (``flips``). The kernel path and the plain path make the same route
    calls in the same order (layer by layer; with remat, the forward
    then the backward's recomputes), so a FIFO pairs them."""

    def __init__(self):
        self.queue, self.flips, self.tokens = [], 0, 0

    def _patch(self, topk):
        from unittest import mock

        from repro_torch.models import moe
        return mock.patch.object(moe, "torch", _TorchProxy(topk=topk))

    def record(self):
        def topk(x, k, **kw):
            out = torch.topk(x, k, **kw)
            self.queue.append(out.indices)
            return out
        return self._patch(topk)

    def replay(self):
        def topk(x, k, **kw):
            own = torch.topk(x, k, **kw).indices
            idx = self.queue.pop(0)
            if idx.shape != own.shape:
                raise AssertionError(f"replayed route {tuple(idx.shape)} "
                                     f"!= {tuple(own.shape)}")
            self.flips += int((own != idx).any(-1).sum())
            self.tokens += own.shape[0]
            return torch.gather(x, -1, idx), idx
        return self._patch(topk)

    def done(self):
        if self.queue:
            raise AssertionError(f"{len(self.queue)} recorded routes were "
                                 "not replayed")
        return {"choices_differing_without_replay": self.flips,
                "token_layer_choices": self.tokens}


def _moe_ranges():
    """Named profiler ranges around the MoE FFN's parts (phases 14-15):
    the router (logits, softmax, top-k, losses), the dispatch maps (sort,
    counts, slot maps), the row gathers (dispatch and combine) and the
    expert GEMMs (``torch.bmm``). The ranges are siblings: on an H100 a
    range around the whole FFN read less device time than the expert
    GEMMs inside it, so none is nested. Kernels that autograd launches in
    the backward fall outside every range."""
    import contextlib
    from unittest import mock

    from repro_torch.models import moe

    def named(name, fn):
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner

    class Gather:
        apply = staticmethod(named("moe.gather", moe._Gather.apply))

    stack = contextlib.ExitStack()
    for attr, name in (("route", "moe.router"),
                       ("dispatch_maps", "moe.dispatch_maps")):
        stack.enter_context(mock.patch.object(
            moe, attr, named(name, getattr(moe, attr))))
    stack.enter_context(mock.patch.object(moe, "_Gather", Gather))
    stack.enter_context(mock.patch.object(moe, "torch", _TorchProxy(
        bmm=named("moe.expert_gemm", torch.bmm))))
    return stack


def _train_parity(tag, arch, cfg, params, batch, derived, grads_gated=True,
                  phase="13", nonzero=None):
    """Phase 13's gate: the loss and every gradient of one step's
    ``loss_and_grads`` through the kernels against ``plain_kernels=True``
    from the same parameters and batch: the loss within TRAIN_LOSS_TOL
    relative, the global gradient norm and each gradient tensor within
    TRAIN_GRAD_TOL (of the norm; of the tensor's largest entry). With
    ``derived`` (rwkv6) each gate is at least twice the plain step's own
    distance from the same step with the wkv recurrence in f64, as phase
    12 derives its hidden-state gate, and the kernel step's own distance
    from f64 is printed. Without ``grads_gated`` only the loss is gated
    and the gradients' distances are printed. ``nonzero``: a name prefix
    under which every gradient tensor of the kernel step must be nonzero
    (phase 19: the encoder's, reached only through the cross-attention's
    dk and dv), the key biases aside. Those (``_key_bias``) are held to
    zero, in both steps, within ZERO_GRAD_TOL of the largest entry."""
    from unittest import mock

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import ssm
    routes = RouteReplay()
    zero_counts()
    with routes.record():
        (lk, auxk), gk = loss_and_grads(cfg, params, batch, remat=True)
    par_counts = {k: v for k, v in counts().items() if v}
    with routes.replay():
        (lp, auxp), gp = loss_and_grads(cfg, params, batch, remat=True,
                                        plain_kernels=True)
    if {k: v for k, v in counts().items() if v} != par_counts:
        raise AssertionError(f"{phase}: the plain step launched a kernel")
    if cfg.moe is not None:
        # no float atomics on the path (the MoE's gathers, the backward
        # kernels): a rerun of the kernel step is bit-equal
        (lk2, _), gk2 = loss_and_grads(cfg, params, batch, remat=True)
        rerun_equal = lk2.item() == lk.item() and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(_named(gk2),
                                                        _named(gk)))
        del gk2
        print(f"[{tag}] {phase} {arch} MoE aux (kernels, plain): "
              f"lb {auxk['lb'].item():.6f}, {auxp['lb'].item():.6f}; "
              f"z {auxk['z'].item():.6f}, {auxp['z'].item():.6f}; routing "
              f"replayed in the plain step: {json.dumps(routes.done())}; "
              f"kernel step rerun bit-equal: {rerun_equal}")
        if not rerun_equal:
            raise AssertionError(f"{phase} {arch}: a rerun of the kernel "
                                 "step is not bit-equal")
    if nonzero is not None:
        sub = {n: g for n, g in _named(gk)
               if n.startswith(nonzero) and not _key_bias(n)}
        zero = [n for n, g in sub.items() if not g.abs().max().item() > 0]
        print(f"[{tag}] {phase} {arch} kernel-step gradients under "
              f"{nonzero!r}: {len(sub)} tensors, {len(zero)} all zero, "
              f"norm {_global_norm(sub) if sub else 0.0:.4e}")
        if not sub or zero:
            raise AssertionError(f"{phase} {arch}: gradients under "
                                 f"{nonzero!r} zero or missing: {zero}")
    rows, zeros = _grad_rows(gk, gp), _zero_grads(gk, gp)
    norm_k, norm_p = _global_norm(gk), _global_norm(gp)
    errs = {"loss_rel": abs(lk.item() - lp.item()) / abs(lp.item()),
            "grad_norm_rel": abs(norm_k - norm_p) / norm_p,
            "worst_grad": max(rows, key=rows.get),
            "worst_grad_rel": max(rows.values()),
            "grad_norm_kernel": norm_k, "grad_norm_plain": norm_p}
    if zeros:
        errs["key_bias_grads_of_largest_entry"] = max(zeros.values())
    tol = {"loss": TRAIN_LOSS_TOL, "norm": TRAIN_GRAD_TOL,
           "grads": dict.fromkeys(rows, TRAIN_GRAD_TOL)}
    if derived:
        with mock.patch.object(ssm, "wkv_ref", _wkv_f64):
            (l64, _), g64 = loss_and_grads(cfg, params, batch, remat=True,
                                           plain_kernels=True)
        floor = _grad_rows(gp, g64)
        norm_64 = _global_norm(g64)
        errs.update(plain_vs_f64_loss_rel=abs(lp.item() - l64.item())
                    / abs(lp.item()),
                    plain_vs_f64_grad_norm_rel=abs(norm_p - norm_64) / norm_p,
                    plain_vs_f64_worst_grad=max(floor, key=floor.get),
                    plain_vs_f64_worst_grad_rel=max(floor.values()),
                    kernel_vs_f64_worst_grad_rel=max(_grad_rows(gk, g64)
                                                     .values()),
                    grad_norm_f64=norm_64)
        tol = {"loss": max(TRAIN_LOSS_TOL,
                           2 * errs["plain_vs_f64_loss_rel"]),
               "norm": max(TRAIN_GRAD_TOL,
                           2 * errs["plain_vs_f64_grad_norm_rel"]),
               "grads": {n: max(TRAIN_GRAD_TOL, 2 * floor[n])
                         for n in rows}}
    del gk, gp
    if derived:
        del g64
    bad = {n: e for n, e in rows.items() if e > tol["grads"][n]}
    errs["worst_use_of_grad_tol"] = max(e / tol["grads"][n]
                                        for n, e in rows.items())
    gates = (f"grad norm tol {tol['norm']:.3e}, gradient tol "
             f"{TRAIN_GRAD_TOL}"
             f"{' or twice the plain step distance from f64' if derived else ''}"
             f"{f', key biases zero within {ZERO_GRAD_TOL}' if zeros else ''}"
             if grads_gated else "gradients not gated (printed)")
    print(f"[{tag}] {phase} {arch} ({cfg.n_layers} layers) loss and gradients, "
          f"kernels vs plain at B={batch['tokens'].shape[0]} "
          f"S={batch['tokens'].shape[1]}: {json.dumps(errs)}; loss tol "
          f"{tol['loss']:.3e}, {gates}; launches {par_counts}")
    grads_ok = (not bad and errs["grad_norm_rel"] <= tol["norm"]
                and all(z <= ZERO_GRAD_TOL for z in zeros.values()))
    if ((grads_gated and not grads_ok) or errs["loss_rel"] > tol["loss"]
            or not math.isfinite(lk.item())):
        raise AssertionError(f"{phase} {arch}: kernel step != plain step: "
                             f"{errs}; outside: {bad}")


def train_llm(tag, arch, n_layers=None, device="cuda", phase="13"):
    """Phases 13 and 15: LM training on the card at full width
    (``n_layers`` cuts the depth: qwen3-4b's 36 layers do not fit one card
    with f32 Adam, so it trains 8; deepseek-moe-16b trains 4, phase 15),
    B=TRAIN_BATCH, S=TRAIN_SEQ, remat, ``--opts TRAIN_OPTS``, on the token
    pipeline's first batch. With MoE layers the parity holds the expert
    choice fixed (``RouteReplay``) and prints lb and z, and the profile
    names the MoE FFN's parts. Phase 19 trains whisper-small at full
    depth, S=WHISPER_SEQ, with ``whisper_frames`` (1500 per row); its L
    is flash's call sites (``stack.attention_calls``: 12 encoder, 12
    decoder self, 12 cross), counted by kind (``FlashKinds``), and every
    encoder gradient of the parity's kernel step must be nonzero.

      * parity (``_train_parity``): one step's loss and gradients through
        the kernels against ``plain_kernels=True``. qwen3-4b at S=2048.
        rwkv6's plain step runs at S = RWKV_PARITY_SEQ (its wkv is a
        Python loop over T, differentiated step by step), with gates
        derived from an f64 step as phase 12's (the first positions are
        ill-conditioned, ROADMAP queue 3 item 2): the loss and gradients
        at a depth cut to RWKV_PARITY_LAYERS, then the loss at full depth.
        At 12 layers and more the f32 gradient of the randomly drawn
        model is chaotic: its norm is 1e2–1e5 and three f32 evaluations
        (the kernels, the plain recurrence, the plain recurrence with the
        bonus term summed apart as the kernel sums it) scatter 0.13–4.1
        of the largest entry around the f64 step, the kernels sometimes
        nearest (``scripts/rwkv_grad_conditioning.py`` on an H100). So at
        full depth the gradients' distances are printed, not gated; the
        backward kernel itself is held at full shape in 6b.
      * the main path: one ``make_train_step`` step through the kernels,
        counted from zero: 2L forward launches (remat: the forward and the
        recompute) and L backward launches of the layer kind's kernel,
        none of another; then ms per step (CUDA events, median of 3 after
        that warm step), tokens/s, peak memory and one profiled step's
        device time by kernel kind with the device-busy share.

    Returns (forward, backward launches of the main path, the record)."""
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models import stack as ST
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    encdec = cfg.layout == "encdec"
    B, S = TRAIN_BATCH, WHISPER_SEQ if encdec else TRAIN_SEQ
    kernel = "flash_attention" if cfg.attn is not None else "wkv"
    L = ST.attention_calls(cfg) if cfg.attn is not None else cfg.n_layers
    prev = flags.get()
    flags.parse_opts(TRAIN_OPTS)
    try:
        torch.cuda.empty_cache()
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(TokenPipeline(cfg.vocab, B, S,
                                                seed=0)).items()}
        if encdec:
            batch["frames"] = whisper_frames(cfg, B, device)
        rwkv = cfg.attn is None
        if rwkv:
            pb = {k: v[:, :RWKV_PARITY_SEQ] for k, v in batch.items()}
            cut = dataclasses.replace(cfg, n_layers=RWKV_PARITY_LAYERS)
            _train_parity(tag, arch, cut, M.init_lm(cut, 0, device=device),
                          pb, derived=True)
            torch.cuda.empty_cache()
        else:
            pb = batch
        params = M.init_lm(cfg, 0, device=device)
        n_params = sum(t.numel() for _, t in _named(params))
        _train_parity(tag, arch, cfg, params, pb, derived=rwkv,
                      grads_gated=not rwkv, phase=phase,
                      nonzero="enc." if encdec else None)

        step, opt = make_train_step(cfg, lr=TRAIN_LR, remat=True)
        opt_state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kinds = FlashKinds()
        zero_counts()
        with kinds.active():
            params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        main = counts()
        want = dict.fromkeys(main, 0)
        want[kernel], want[kernel + "_bwd"] = 2 * L, L
        if main != want or (encdec and kinds.counts != kinds.expect(cfg, 2)):
            raise AssertionError(f"{phase} {arch}: launches {main}, "
                                 f"expected {want}; by kind "
                                 f"{kinds.counts}")
        losses, times = [m["loss"].item()], []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            params, opt_state, m = step(params, opt_state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
            losses.append(m["loss"].item())
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{phase} {arch}: losses {losses}")
        ms = float(np.median(times))
        record = {"parameters": n_params, "ms_per_step": ms,
                  "flash_launches_by_kind": kinds.counts,
                  "moe_lb": m["moe_lb"].item(),
                  "ms_per_step_runs": times,
                  "tokens_per_s": B * S / (ms / 1e3),
                  "peak_memory_bytes": peak, "losses": losses,
                  "grad_norm": m["grad_norm"].item(),
                  "launches_per_step": {k: v for k, v in main.items() if v}}
        print(f"[{tag}] {phase} {arch} train step ({cfg.n_layers} layers, "
              f"{L} {kernel} call sites) B={B} S={S} "
              f"remat {TRAIN_OPTS}: {json.dumps(record)}")
        with _moe_ranges(), FlashKinds().active():
            prof = _profiled(lambda: step(params, opt_state, batch), device)
        print(f"[{tag}] {phase} {arch} profiled train step: "
              f"{json.dumps(prof)}")
    finally:
        flags.set_flags(**dataclasses.asdict(prev))
    del params, opt_state
    torch.cuda.empty_cache()
    return main[kernel], main[kernel + "_bwd"], record


def train_driver(tag, device="cuda"):
    """Phase 13b: ``launch.train.main`` on rwkv6-1.6b at full width and
    depth for DRIVER_STEPS steps at the driver's defaults (B=4, S=64, no
    remat), with ``--ckpt`` under build/, gated by its own assertion that
    the loss falls (L forward and L backward wkv launches per step). Then
    the checkpoint is restored (parameters bit-equal to the run's) and one
    more step from it is bit-equal to the same step from the run's
    in-memory parameters and Adam state. The files are removed after.
    Returns the run's (forward, backward) launches."""
    import shutil

    from repro_torch import checkpoint as CKPT
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    arch = "rwkv6-1.6b"
    cfg = get_config(arch)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_lm_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(root, "rwkv6")
    state = {}
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    losses = train.main(["--arch", arch, "--full", "--steps",
                         str(DRIVER_STEPS), "--device", device, "--ckpt",
                         path], state=state)
    wall = time.perf_counter() - t0
    main = counts()
    want = dict.fromkeys(main, 0)
    want["wkv"] = want["wkv_bwd"] = DRIVER_STEPS * cfg.n_layers
    if main != want:
        raise AssertionError(f"13b: launches {main}, expected {want}")
    t0 = time.perf_counter()
    got = CKPT.restore(path, {"params": M.init_lm(cfg, 0, device="meta"),
                              "step": 0}, device=device)
    restore_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(root, f))
               for f in os.listdir(root))
    shutil.rmtree(root)
    same = got["step"] == DRIVER_STEPS and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(_named(got["params"]),
                                                    _named(state["params"])))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
             for k, v in next(TokenPipeline(cfg.vocab, 4, 64,
                                            seed=1)).items()}
    step, _ = make_train_step(cfg, lr=3e-4, remat=False)
    pa, _, ma = step(state["params"], state["opt_state"], batch)
    del state["params"]
    pb, _, mb = step(got["params"], state["opt_state"], batch)
    equal = ma["loss"].item() == mb["loss"].item() and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(_named(pa), _named(pb)))
    print(f"[{tag}] 13b launch.train.main {arch} --full --steps "
          f"{DRIVER_STEPS}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(5-step means {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f}) in {wall:.1f} s; launches "
          f"{json.dumps({k: v for k, v in main.items() if v})}; checkpoint "
          f"{size / 1e9:.2f} GB restored in {restore_s:.1f} s, parameters "
          f"bit-equal {same}; the next step from it bit-equal {equal}")
    if not (same and equal):
        raise AssertionError("13b: the restored checkpoint's step differs")
    del got, pa, pb, state
    torch.cuda.empty_cache()
    return main["wkv"], main["wkv_bwd"]


def _rel_err(a, b):
    """max |a − b| over max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def layer_kinds(cfg):
    """Every layer's kind ('attn', 'mamba', 'rwkv'), in order."""
    from repro_torch.models import stack as ST
    return [k[0] for _, reps, body in ST.build_segments(cfg)
            for k in body for _ in range(reps)]


def serve_llm(tag, arch, kernel, device="cuda", full=True, n_layers=None,
              check_caches=False):
    """One full-width LLM served through ``launch.serve.main`` (the main
    path: its launches are the JSON record's), then its steps timed and
    held against the plain versions (phases 11-12, 14). ``kernel``
    launches once per layer of its kind per prefill (flash: attention
    layers; wkv: RWKV layers). ``n_layers`` cuts the depth (phase 14:
    what fits 80 GB): ``serve.main`` then reads the cut config, through
    this script's patch of its ``get_config`` (the package has no depth
    option). ``check_caches`` also holds every layer's cache after the
    parity's decode (phase 22a: the ring caches). Returns the main path's
    launch count of ``kernel`` and the step times. ``full=False`` serves
    the reduced config (a CPU rehearsal)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    cfg = get_config(arch) if full else get_config(arch).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B, P, N = LLM_BATCH, LLM_PROMPT, LLM_TOKENS
    L = layer_kinds(cfg).count("rwkv" if kernel == "wkv" else "attn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_lm(cfg, 0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _named(params))
    print(f"[{tag}] {arch}: init_lm {n_params / 1e9:.3f} B parameters, f32, "
          f"in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, P))

    zero_counts()
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
            "--tokens", str(N), "--device", device] + (["--full"] if full
                                                       else [])
    with mock.patch.object(serve, "get_config",
                           lambda name: cfg if full else get_config(name)):
        gen = serve.main(argv, prompts=prompts, params=params)
    main_counts = counts()
    want = dict.fromkeys(main_counts, 0)
    want[kernel] = L
    if main_counts != want or gen.shape != (B, N):
        raise AssertionError(f"serve.main: launches {main_counts}, expected "
                             f"{want}; ids {gen.shape}")
    print(f"[{tag}] {arch} serve.main: ids {gen.shape}, launches "
          f"{json.dumps(main_counts)}")

    prefill = make_prefill_step(cfg, P + N)
    decode = make_decode_step(cfg, P + N)
    tokens = torch.as_tensor(prompts, device=device)
    timing = time_serve_steps(params, prefill, decode, tokens, kernel, L)
    print(f"[{tag}] {arch} ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters) B={B} prompt={P} new={N}: "
          f"{kernel} {L} launches per prefill, 0 added by {N - 1} decode "
          f"steps; {json.dumps(timing)}")
    llm_parity(tag, arch, cfg, params, tokens, P, N, check_caches)
    profile_llm(tag, arch, params, prefill, decode, tokens, P, device)
    if "mamba" in layer_kinds(cfg):
        mamba_scan(tag, arch, cfg, params, device)
    del params
    torch.cuda.empty_cache()
    return main_counts[kernel], timing


def time_serve_steps(params, prefill, decode, tokens, kernel, L):
    """The serve steps timed (CUDA events): 3 prefills of ``tokens``
    (B, LLM_PROMPT), each launching ``kernel`` L times, then LLM_TOKENS − 1
    greedy decode steps, which launch none; the peak memory since the
    first prefill. Returns the timing record."""
    B, P, N = tokens.shape[0], tokens.shape[1], LLM_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    with torch.no_grad():
        for _ in range(3):
            cache = None
            zero_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            tok, cache = prefill(params, {"tokens": tokens})
            ev[1].record()
            torch.cuda.synchronize()
            prefill_ms.append(ev[0].elapsed_time(ev[1]))
            if counts()[kernel] != L:
                raise AssertionError(f"{kernel}: {counts()[kernel]} launches "
                                     f"per prefill, expected {L}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(N - 1):
            tok, cache = decode(params, cache, tok, P + i)
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if counts()[kernel] != L:
        raise AssertionError(f"decode launched {kernel}")
    decode_ms = ev[0].elapsed_time(ev[1])
    return {"prefill_ms": float(np.median(prefill_ms)),
            "prefill_ms_runs": prefill_ms,
            "prefill_tok_per_s": B * P / (np.median(prefill_ms) / 1e3),
            "decode_ms_per_token": decode_ms / (N - 1),
            "decode_tok_per_s": B * (N - 1) / (decode_ms / 1e3),
            "decode_wall_ms_per_token": 1e3 * wall / (N - 1),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def mamba_scan(tag, arch, cfg, params, device="cuda"):
    """Phase 14's Mamba scan: the first Mamba layer's ``mamba_full`` at the
    serve shape (B=LLM_BATCH, T=LLM_PROMPT, full width) on a seeded
    normal input, its time scan (``chunked_time_scan``: a Python loop of
    a few elementwise launches per step, host-bound by design) timed
    within it by CUDA events and the host clock, then the scan alone
    profiled: its kernel launches and device time per layer."""
    from unittest import mock

    from repro_torch.models import ssm as S
    from repro_torch.models import stack as ST
    name, j = next((name, j) for name, _, body in ST.build_segments(cfg)
                   for j, kind in enumerate(body) if kind[0] == "mamba")
    p = ST._index(params["segments"][name], 0)[f"s{j}"]["mixer"]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((LLM_BATCH, LLM_PROMPT, cfg.d_model), generator=gen,
                    device=device)
    scan, rec = S.chunked_time_scan, {}

    def timed(*args):
        rec["args"] = args
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        out = scan(*args)
        ev[1].record()
        torch.cuda.synchronize()
        rec.setdefault("scan_ms", []).append(ev[0].elapsed_time(ev[1]))
        rec.setdefault("scan_host_ms", []).append(
            1e3 * (time.perf_counter() - t0))
        return out

    layer_ms = []
    with torch.no_grad(), mock.patch.object(S, "chunked_time_scan", timed):
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            S.mamba_full(p, cfg.ssm, x)
            ev[1].record()
            torch.cuda.synchronize()
            layer_ms.append(ev[0].elapsed_time(ev[1]))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            scan(*rec["args"])
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"shape": {"B": LLM_BATCH, "T": LLM_PROMPT,
                     "d_inner": cfg.ssm.expand * cfg.d_model,
                     "d_state": cfg.ssm.d_state},
           "mamba_full_ms_runs": layer_ms, "scan_ms_runs": rec["scan_ms"],
           "scan_host_ms_runs": rec["scan_host_ms"],
           "scan_kernel_launches": sum(e.count for e in kernels),
           "scan_device_ms": sum(e.self_device_time_total
                                 for e in kernels) / 1e3}
    print(f"[{tag}] 14 {arch} Mamba scan, one layer: {json.dumps(out)}")
    del rec


def _wkv_f64(r, k, v, w, u):
    """The wkv recurrence evaluated in f64 (then rounded to f32): the
    yardstick of ``llm_parity``'s noise floor."""
    r, k, v, w, u = (a.to(torch.float64) for a in (r, k, v, w, u))
    B, H, T, dk = r.shape
    S = torch.zeros((B, H, dk, dk), dtype=torch.float64, device=r.device)
    ys = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                               S + u[..., None] * kv))
        S = w[:, :, t, :, None] * S + kv
    return torch.stack(ys, dim=2).float(), S.float()


def llm_parity(tag, arch, cfg, params, tokens, P, N, check_caches=False):
    """The prefill through the kernels against the same prefill through
    the plain versions (``plain_kernels=True``, which must launch
    nothing), then N − 1 decode steps teacher-forced on the kernel path's
    tokens through both caches. Gates, relative to the largest |entry| of
    the plain result:

      * last-position logits and every decode step's logits: LLM_REL_TOL;
      * the final hidden state at every position: LLM_REL_TOL, or, where
        the model has a recurrence (RWKV6), twice the plain f32 path's own
        distance from the same model with the recurrence evaluated in f64,
        whichever is larger. At the first positions the per-head group
        norm of a nearly rank-one y_t amplifies f32 rounding (the plain
        path is 100x further from f64 there than at the median position,
        on the CPU at reduced width), so two f32 evaluations differ there
        by more than LLM_REL_TOL; the kernel path must be no further from
        the plain one than that;
      * with ``check_caches``, every layer's cache after the last decode
        step, its K and V each: LLM_REL_TOL (``_cache_parity``)."""
    from unittest import mock

    from repro_torch.models import model as M
    from repro_torch.models import ssm
    routes = RouteReplay()
    with torch.no_grad():
        with routes.record():
            hk, ck, _ = M.forward_hidden(cfg, params, tokens,
                                         want_cache=True, cache_len=P + N)
        lk = M._logits(cfg, params, hk[:, -1:])
        before = counts()
        with routes.replay():
            hp, cp, _ = M.forward_hidden(cfg, params, tokens,
                                         want_cache=True, cache_len=P + N,
                                         plain_kernels=True)
        if counts() != before:
            raise AssertionError("the plain run launched a kernel")
        prefill_routes = routes.done()
        lp = M._logits(cfg, params, hp[:, -1:])
        scale = hp.abs().max()
        per_pos = (hk - hp).abs().amax(dim=(0, 2)) / scale
        errs = {"hidden": per_pos.max().item(),
                "hidden_first_8_positions": per_pos[:8].max().item(),
                "hidden_after_8_positions": per_pos[8:].max().item(),
                "hidden_worst_position": int(per_pos.argmax()),
                "prefill_logits": _rel_err(lk, lp)}
        hidden_tol = LLM_REL_TOL
        if cfg.attn is None:
            with mock.patch.object(ssm, "wkv_ref", _wkv_f64):
                h64, _, _ = M.forward_hidden(cfg, params, tokens,
                                          plain_kernels=True)
            errs["plain_vs_f64_recurrence"] = _rel_err(hp, h64)
            errs["kernel_vs_f64_recurrence"] = _rel_err(hk, h64)
            hidden_tol = max(hidden_tol, 2 * errs["plain_vs_f64_recurrence"])
            del h64
        finite = bool(torch.isfinite(hk).all() and torch.isfinite(lk).all())
        scales = {"max_abs_hidden": scale.item(),
                  "max_abs_logit": lp.abs().max().item()}
        del hk, hp
        tok = torch.argmax(lk, dim=-1)
        dec = []
        for i in range(N - 1):
            with routes.record():
                lk, ck = M.decode_step(cfg, params, tok, ck, P + i, P + N)
            with routes.replay():
                lp, cp = M.decode_step(cfg, params, tok, cp, P + i, P + N)
            dec.append(_rel_err(lk, lp))
            finite = finite and bool(torch.isfinite(lk).all())
            tok = torch.argmax(lk, dim=-1)
    errs["decode_logits_max"] = max(dec)
    cache_ok = True
    if check_caches:
        caches = _cache_parity(cfg, ck, cp, P + N - 2, P + N)
        cache_ok = max(caches["ring_max"], caches["full_max"]) <= LLM_REL_TOL
        print(f"[{tag}] {arch} caches after {N - 1} decode steps, kernel "
              f"path vs plain path (tol {LLM_REL_TOL}): "
              f"{json.dumps(caches)}")
    if cfg.moe is not None:
        decode_routes = routes.done()
        decode_routes["token_layer_choices"] -= prefill_routes[
            "token_layer_choices"]
        decode_routes["choices_differing_without_replay"] -= prefill_routes[
            "choices_differing_without_replay"]
        print(f"[{tag}] {arch} MoE routing replayed in the plain run: "
              f"prefill {json.dumps(prefill_routes)}; decode "
              f"{json.dumps(decode_routes)}")
    print(f"[{tag}] {arch} kernels vs plain (max |d| / max |plain|; "
          f"logits tol {LLM_REL_TOL}, hidden tol {hidden_tol:.3e}): "
          f"{json.dumps(errs)}; {json.dumps(scales)}; per decode step "
          f"{[f'{e:.2e}' for e in dec]}")
    if not (finite and cache_ok and errs["hidden"] <= hidden_tol
            and max(errs["prefill_logits"], errs["decode_logits_max"])
            <= LLM_REL_TOL):
        raise AssertionError(f"{arch}: kernel path != plain path {errs} "
                             f"(finite {finite})")


def _cache_parity(cfg, ck, cp, pos, cache_len):
    """Every attention layer's cache after decoding position ``pos``,
    kernel path ``ck`` against plain path ``cp``: max |d| / max |plain|
    of K and of V, the worst over the ring caches (a local layer whose
    window is shorter than ``cache_len``) and over the full ones apart.
    A ring's slot s holds position pos − ((pos − s) mod W) in both paths
    (``models.attention._slot_positions``); its first and last position
    are printed. A slot holding another position in one path would miss
    the gate by far (RoPE turns each key with its position)."""
    from repro_torch.models import attention as A
    from repro_torch.models import stack as ST
    out = {"ring_max": 0.0, "full_max": 0.0, "ring_layers": 0,
           "full_layers": 0}
    for name, reps, kinds in ST.build_segments(cfg):
        for j, kind in enumerate(kinds):
            if kind[0] != "attn":
                continue
            a, b = ck[name][f"s{j}"], cp[name][f"s{j}"]
            W = a["k"].shape[2]
            ring = bool(kind[2]) and W < cache_len
            key = "ring" if ring else "full"
            err = max(_rel_err(a[t][r], b[t][r]) for t in ("k", "v")
                      for r in range(reps))
            out[f"{key}_max"] = max(out[f"{key}_max"], err)
            out[f"{key}_layers"] += reps
            if ring:
                spos = A._slot_positions(pos, W, True)
                out["ring_slots"] = W
                out["ring_positions"] = [int(spos.min()), int(spos.max())]
    return out


def _kind(name):
    name = name.lower()
    if "graph_filter_kernel" in name:
        return "graph_filter"
    if any(s in name for s in ("flash_attention_kernel", "fwd_wgmma_kernel",
                               "fwd_tf32_kernel", "split_kv_kernel")):
        return "flash_attention"
    if any(s in name for s in ("dkdv_kernel", "dq_kernel", "delta_kernel",
                               "dkdv_wgmma_kernel", "dq_wgmma_kernel",
                               "dkdv_tf32_kernel", "dq_tf32_kernel",
                               "delta_tiles_kernel", "delta_f32_kernel",
                               "split_keys_kernel", "kmean_kernel",
                               "kmean_part_kernel", "kmean_sum_kernel",
                               "centre_kernel", "centre8_kernel")):
        return "flash_attention_bwd"
    if any(s in name for s in ("wkv_bwd_state_kernel", "wkv_bwd_chunk_kernel",
                               "wkv_du_kernel")):
        return "wkv_bwd"
    if any(s in name for s in ("wkv_state_kernel", "wkv_chunk_kernel")):
        return "wkv"
    if name.startswith(("memcpy", "memset")):
        return "copy"
    if any(s in name for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "gemm"
    if "reduce" in name:
        return "reduce"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    return "other"


def _profiled(fn, device):
    """Run ``fn`` under ``torch.profiler``; device time by kind, the wall
    time between two synchronizations and the device-busy share."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds, kernels, ranges = {}, [], {}
    for e in prof.key_averages():
        if e.key.startswith(("moe.", "flash.")):
            # a named range (``_moe_ranges``, ``FlashKinds``): the device
            # time of the kernels launched inside it, and its calls
            ranges.setdefault(e.key.split(".")[0], {})[e.key] = (
                e.device_time_total / 1e3, e.count)
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + ms
        kernels.append((round(ms, 4), e.count, e.key[:70]))
    busy = sum(v for k, v in kinds.items() if k != "copy")
    out = {"wall_ms_profiled": wall_ms,
           "device_ms": kinds if busy > 0 else "not measured",
           "device_busy_share": busy / wall_ms if busy > 0
           else "not measured",
           "top_kernels": sorted(kernels, reverse=True)[:10]}
    for name, rows in ranges.items():
        out[f"{name}_device_ms_and_calls"] = rows
    return out


def profile_llm(tag, arch, params, prefill, decode, tokens, P, device):
    """One profiled prefill and 4 profiled decode steps after it (with the
    MoE FFN's parts as named ranges)."""
    state = {}
    with torch.no_grad(), _moe_ranges():
        def run_prefill():
            state["tok"], state["cache"] = prefill(params, {"tokens": tokens})

        def run_decode():
            tok, cache = state["tok"], state["cache"]
            for i in range(4):
                tok, cache = decode(params, cache, tok, P + i)
        print(f"[{tag}] {arch} profiled prefill: "
              f"{json.dumps(_profiled(run_prefill, device))}")
        print(f"[{tag}] {arch} profiled 4 decode steps: "
              f"{json.dumps(_profiled(run_decode, device))}")


def fig7_ablation(tag, device="cuda", steps=None):
    """Phase 16: fig. 7's ablation (``benchmarks/fig7_ablation.py``) on the
    port, timed: ``train_surf`` at BENCH over the training seeds in
    lockstep, constrained and not, from the random and the DGD init (the
    four runs), through the graph-filter kernel; then each trained seed
    evaluated on the test pool under 4 evaluation seeds. Prints ms per
    lockstep step of each run (CUDA events over the whole ``train_surf``
    call, over ``steps``), its launches, and the per-layer accuracies
    with the benchmark's mid-layer line. The accuracies are reported, not
    gated (the benchmark asserts nothing). Returns (forward, backward)
    launches."""
    from repro_torch import engine as E
    from repro_torch.configs.surf_paper import BENCH
    from repro_torch.core import surf
    from repro_torch.data import synthetic
    steps = FIG7_STEPS if steps is None else steps
    mds = synthetic.make_meta_dataset(BENCH, FIG7_TRAIN_Q, seed=0)
    test = synthetic.make_meta_dataset(BENCH, FIG7_TEST_Q, seed=777)
    fwd = bwd = 0
    summary, rows = {}, {}
    for constrained in (True, False):
        for init in ("random", "dgd"):
            name = ("surf" if constrained else "no-constraints") + f"+{init}"
            zero_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            states, _, S_stack = surf.train_surf(
                BENCH, mds, steps=steps, seeds=SEEDS,
                constrained=constrained, log_every=0, init=init,
                device=device)
            ev[1].record()
            torch.cuda.synchronize()
            c = counts()
            want = dict.fromkeys(c, 0)
            want["graph_filter"] = steps * len(SEEDS) * BENCH.n_layers
            want["graph_filter_bwd"] = (steps * len(SEEDS)
                                        * (BENCH.n_layers - 1))
            if c != want:
                raise AssertionError(f"16 {name}: launches {c}, expected "
                                     f"{want}")
            fwd += c["graph_filter"]
            bwd += c["graph_filter_bwd"]
            acc = np.concatenate([
                surf.evaluate_surf(BENCH, E.state_for_seed(states, i),
                                   S_stack[i], test, seeds=SEEDS,
                                   device=device)["acc_per_layer"]
                for i in range(len(SEEDS))])
            fwd += counts()["graph_filter"] - c["graph_filter"]
            if not np.isfinite(acc).all():
                raise AssertionError(f"16 {name}: accuracies {acc}")
            summary[name] = acc.mean(0)
            rows[name] = {"ms_per_lockstep_step":
                          ev[0].elapsed_time(ev[1]) / steps,
                          "launches": {k: v for k, v in c.items() if v},
                          "acc_per_layer": [round(float(a), 4)
                                            for a in acc.mean(0)],
                          "acc_std_per_layer": [round(float(a), 4)
                                                for a in acc.std(0)]}
            print(f"[{tag}] 16 fig. 7 {name}: train_surf(BENCH, steps="
                  f"{steps}, seeds={SEEDS}) {json.dumps(rows[name])}")
            del states, S_stack
    mid = BENCH.n_layers // 2
    print(f"[{tag}] 16 fig. 7 mid-layer (l={mid}) acc (random init): "
          f"surf={summary['surf+random'][mid]:.3f} "
          f"no-constraints={summary['no-constraints+random'][mid]:.3f}")
    return fwd, bwd


def examples_phase(tag, device="cuda"):
    """Phase 17: each ``examples/*_torch.py`` run in this process as its
    command line would run it (``runpy`` with ``sys.argv``), on the card,
    at the arguments of EXAMPLE_ARGS (the defaults, or a shorter run where
    a default takes minutes), gated by its own assertions and by a line
    its output must hold. ``serve_arch_torch.py`` must launch flash on
    jamba's reduced attention layer (one per prefill). Returns the launch
    counts of the whole phase."""
    import contextlib
    import io
    import runpy
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "chip_smoke_train_lm_ckpt")
    total = dict.fromkeys(counts(), 0)
    for name, (argv, marker) in EXAMPLE_ARGS.items():
        path = os.path.join(root, "examples", f"{name}_torch.py")
        argv = list(argv) + (["--ckpt", ckpt] if name == "train_lm" else [])
        zero_counts()
        buf = io.StringIO()
        saved = sys.argv
        sys.argv = [path] + argv + ["--device", device]
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = saved
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        c = counts()
        print(f"[{tag}] 17 examples/{name}_torch.py {' '.join(argv)}: "
              f"{wall:.1f} s, launches "
              f"{json.dumps({k: v for k, v in c.items() if v})}; output "
              f"tail: {out.strip().splitlines()[-3:]}")
        if marker not in out:
            raise AssertionError(f"17 {name}: {marker!r} not in its output")
        if name == "serve_arch" and c["flash_attention"] != 1:
            raise AssertionError(f"17 serve_arch: flash launches {c}, "
                                 "expected 1 (jamba's reduced attention "
                                 "layer, one prefill)")
        for k, v in c.items():
            total[k] += v
    folder, base = os.path.split(ckpt)
    for f in os.listdir(folder):          # the checkpoint's .npz and .json
        if f.startswith(base):
            os.remove(os.path.join(folder, f))
    return total


def whisper_frames(cfg, B, device, n_frames=None, seed=0):
    """(B, n_frames, d) f32 frame embeddings, 0.02 N(0, 1) from a seeded
    numpy generator (the scale of the reference drivers' draw); n_frames
    defaults to ``frontend.AUDIO_FRAMES`` (30 s of audio after the stubbed
    conv frontend)."""
    from repro_torch.models import frontend
    n = frontend.AUDIO_FRAMES if n_frames is None else n_frames
    return torch.tensor((0.02 * np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model))).astype(np.float32), device=device)


class FlashKinds:
    """Names each flash-attention call of the model by its kind (phases
    18-19): the encoder's non-causal self-attention ("encoder"), the
    decoder's causal self-attention ("self") and its cross-attention
    ("cross"). The kind is read from the ``models.attention.full_attention``
    call that makes the flash call (causal, or keys and values projected
    from ``kv_x``), never from the shapes, which collide when the prompt
    is as long as the frames. Under ``active()`` every flash call made
    through ``models.attention`` is counted by kind, runs inside a
    profiler range ``flash.<kind>`` and, with ``timed``, between two CUDA
    events whose elapsed times are summed per kind (``ms()``). The calls
    still go through the wrapper, whose launch counter counts them."""

    def __init__(self):
        self.counts, self.events = {}, {}
        self._kind = None

    @staticmethod
    def expect(cfg, per_call_site=1):
        """The counts by kind of one forward (times ``per_call_site``: 2
        for a step with remat)."""
        out = {"encoder": cfg.n_encoder_layers, "self": cfg.n_layers,
               "cross": cfg.n_layers}
        return {k: per_call_site * v for k, v in out.items()}

    def active(self, timed=False):
        from contextlib import ExitStack
        from unittest import mock

        from repro_torch.kernels.flash_attention import ops
        from repro_torch.models import attention as A
        full_attention = A.full_attention

        def full(*args, causal=True, kv_x=None, **kw):
            outer, self._kind = self._kind, ("self" if causal else "encoder"
                                             if kv_x is None else "cross")
            try:
                return full_attention(*args, causal=causal, kv_x=kv_x, **kw)
            finally:
                self._kind = outer

        def call(q, k, v, causal=True, window=0):
            kind = self._kind
            if kind is None:
                raise AssertionError("a flash call outside "
                                     "models.attention.full_attention")
            self.counts[kind] = self.counts.get(kind, 0) + 1
            with torch.profiler.record_function(f"flash.{kind}"):
                if not timed:
                    return ops.flash_attention(q, k, v, causal=causal,
                                               window=window)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                o = ops.flash_attention(q, k, v, causal=causal, window=window)
                ev[1].record()
                self.events.setdefault(kind, []).append(ev)
                return o

        stack = ExitStack()
        stack.enter_context(mock.patch.object(A, "full_attention", full))
        stack.enter_context(mock.patch.object(
            A, "FA", SimpleNamespace(flash_attention=call)))
        return stack

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in evs)
                for k, evs in self.events.items()}


def check_flash_whisper(tag, device="cuda"):
    """Phase 5 at whisper-small's non-causal shapes (``FLASH_WHISPER``: the
    encoder's self-attention and the cross-attention, dh=64, MHA), f32 and
    bf16: f32 within FLASH_F32_ERR_MAX of the plain version, bf16 within
    ``ops.bf16_error_bound(..., causal=False)`` per element; µs per launch
    (CUDA events, median), the plain version's time,
    ``scaled_dot_product_attention``'s (default dispatch, and in f32 the
    memory-efficient backend) and the bound. Returns the largest f32
    |error|, {(shape name, dtype): µs and bounds} and the largest bf16
    |error|."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention, ops)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(11)
    max_err, timing, bf16_err = 0.0, {}, 0.0
    for name, (B, H, KV, Sq, Skv, dh) in FLASH_WHISPER.items():
        f32 = [torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
            np.float32), device=device) for n, s in ((H, Sq), (KV, Skv),
                                                     (KV, Skv))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in f32)
            o = flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            o_ref = attention_ref(q, k, v, causal=False)
            err = (o.float() - o_ref.float()).abs().max().item()
            if dtype == torch.float32:
                max_err = max(max_err, err)
                ok, gate = err <= FLASH_F32_ERR_MAX, f"<= {FLASH_F32_ERR_MAX}"
            else:
                bf16_err = max(bf16_err, err)
                use = _bound_use(o, o_ref, ops.bf16_error_bound(
                    q, k, v, o_ref, causal=False))
                ok, gate = use <= 1, f"bf16 bound use {use:.3f}"
            if not ok:
                raise AssertionError(f"flash {name} {(B, H, KV, Sq, Skv, dh)} "
                                     f"{dtype} non-causal: max |err| {err} "
                                     f"({gate})")
            ms = median_ms(lambda: flash_attention(q, k, v, causal=False),
                           reps=7, inner=5, warm=2)
            plain_ms = median_ms(lambda: attention_ref(q, k, v, causal=False),
                                 reps=3, inner=2, warm=1)
            lib_ms = median_ms(lambda: sdpa(q, k, v), reps=7, inner=5, warm=2)
            eff_ms = None
            if dtype == torch.float32:
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    eff_ms = median_ms(lambda: sdpa(q, k, v), reps=7,
                                       inner=5, warm=2)
            bound_ms, bound_by, ffma_ms = flash_bound_ms(
                B, H, KV, Sq, dh, 0, q.element_size(), skv=Skv, causal=False)
            timing[(name, str(dtype))] = {
                "us": 1e3 * ms, "plain_us": 1e3 * plain_ms,
                "sdpa_default_us": 1e3 * lib_ms,
                "sdpa_mem_efficient_us": None if eff_ms is None
                else 1e3 * eff_ms, "bound_us": 1e3 * bound_ms,
                "bound_by": bound_by}
            eff = ("" if eff_ms is None else
                   f", memory-efficient backend {eff_ms * 1e3:.1f} us")
            print(f"[{tag}] 5 flash_attention whisper {name} {dtype} B={B} "
                  f"H={H} KV={KV} Sq={Sq} Skv={Skv} dh={dh} non-causal: max "
                  f"|err| {err:.3e} ({gate}); kernel {ms * 1e3:.1f} us, "
                  f"bound {bound_ms * 1e3:.1f} us ({bound_by}, tensor "
                  f"cores; f32 FFMA bound {ffma_ms * 1e3:.1f} us), plain "
                  f"PyTorch version {plain_ms * 1e3:.1f} us, "
                  f"scaled_dot_product_attention {lib_ms * 1e3:.1f} us{eff}")
        del f32, q, k, v, o, o_ref
        torch.cuda.empty_cache()
    return max_err, timing, bf16_err


def check_flash_bwd_whisper(tag, device="cuda"):
    """Phase 5b at phase 5's whisper shapes, f32, non-causal: dq, dk, dv of
    the backward kernel each within BWD_REL_TOL of the plain gradient's
    largest entry (autograd through ``attention_ref``), a rerun
    bit-equal; µs per launch, the bound, the plain backward's time and
    ``scaled_dot_product_attention``'s backward (memory-efficient
    backend). Returns the largest |error| and {shape name: µs and
    bounds}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import attention_ref, ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(13)
    max_err, timing = 0.0, {}
    for name, (B, H, KV, Sq, Skv, dh) in FLASH_WHISPER.items():
        q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
            np.float32), device=device) for n, s in ((H, Sq), (KV, Skv),
                                                     (KV, Skv), (H, Sq)))
        o, lse = ops._launch(q, k, v, False, 0, want_lse=True)
        grads = ops._launch_bwd(q, k, v, o, lse, do, False, 0)
        again = ops._launch_bwd(q, k, v, o, lse, do, False, 0)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o_ref = attention_ref(*xs, causal=False)
        ref = torch.autograd.grad(o_ref, xs, do, retain_graph=True)
        errs = {n: (g - r).abs().max().item() for n, g, r in
                zip(("dq", "dk", "dv"), grads, ref)}
        rel = {n: errs[n] / r.abs().max().item() for n, r in
               zip(("dq", "dk", "dv"), ref)}
        if max(rel.values()) > BWD_REL_TOL or not bit_equal:
            raise AssertionError(f"flash backward whisper {name}: {rel} > "
                                 f"{BWD_REL_TOL} or rerun not bit-equal")
        max_err = max(max_err, *errs.values())
        ms = median_ms(lambda: ops._launch_bwd(q, k, v, o, lse, do, False, 0),
                       reps=5, inner=3, warm=1)
        plain_ms = median_ms(lambda: torch.autograd.grad(
            o_ref, xs, do, retain_graph=True), reps=3, inner=1, warm=1)
        del o_ref, xs, ref
        xe = [t.clone().requires_grad_() for t in (q, k, v)]
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            oe = sdpa(*xe)
            lib_ms = median_ms(lambda: torch.autograd.grad(
                oe, xe, do, retain_graph=True), reps=5, inner=3, warm=1)
        del xe, oe
        bound_ms, bound_by, ffma_ms = flash_bwd_bound_ms(
            B, H, KV, Sq, dh, 0, skv=Skv, causal=False)
        timing[name] = {"us": 1e3 * ms, "plain_us": 1e3 * plain_ms,
                        "sdpa_mem_efficient_us": 1e3 * lib_ms,
                        "bound_us": 1e3 * bound_ms, "bound_by": bound_by}
        print(f"[{tag}] 5b flash_attention_bwd whisper {name} f32 B={B} "
              f"H={H} KV={KV} Sq={Sq} Skv={Skv} dh={dh} non-causal: max "
              f"|err| {json.dumps(errs)}, of the largest |plain| "
              f"{json.dumps(rel)}; rerun bit-equal {bit_equal}; kernel "
              f"{ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}, split TF32 on the tensor cores; f32 FFMA bound "
              f"{ffma_ms * 1e3:.1f} us), plain PyTorch backward "
              f"{plain_ms * 1e3:.1f} us, scaled_dot_product_attention "
              f"backward (memory-efficient) {lib_ms * 1e3:.1f} us")
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return max_err, timing


def _attention64(q, k, v):
    """Non-causal softmax(q kᵀ / sqrt(dh)) v in f64, head h reading kv
    head h // G (``attention_ref`` computes in f32 whatever its inputs)."""
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    return torch.softmax((q @ k.mT) * q.shape[-1] ** -0.5, dim=-1) @ v


def flash_delta_check(tag, device="cuda"):
    """Phase 5b addition: the backward kernel at whisper's cross shape with
    one vector c added to every key (c = m · r · u: u a seeded unit
    vector, r the keys' rms row norm, m in DELTA_MULTIPLES), which moves
    no gradient analytically. Before the keys were centred, dq moved in
    proportion to m (``scripts/flash_delta_probe.py``). Gates: dq, dk
    and dv within BWD_REL_TOL of an f64 autograd step on the same f32
    inputs, and Σ_j dk_j within KEY_SUM_TOL of the f64 dk's largest
    entry, at every m; plain f32 autograd's distances printed beside."""
    from repro_torch.kernels.flash_attention import attention_ref, ops
    B, H, KV, Sq, Skv, dh = FLASH_WHISPER["cross"]
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s_, dh)).astype(
        np.float32), device=device) for n, s_ in ((H, Sq), (KV, Skv),
                                                 (KV, Skv), (H, Sq)))
    u = rng.standard_normal(dh)
    u = torch.tensor(u / np.linalg.norm(u), dtype=torch.float32,
                     device=device)
    r = k.square().sum(-1).mean().sqrt()
    rel = lambda g, g64: ((g.double() - g64).abs().max()
                          / g64.abs().max()).item()
    rows = {}
    for m in DELTA_MULTIPLES:
        kc = k + (m * r) * u
        o, lse = ops._launch(q, kc, v, False, 0, want_lse=True)
        got = ops._launch_bwd(q, kc, v, o, lse, do, False, 0)
        xs = [t.clone().requires_grad_() for t in (q, kc, v)]
        plain = torch.autograd.grad(attention_ref(*xs, causal=False), xs, do)
        x64 = [t.double().requires_grad_() for t in (q, kc, v)]
        g64 = torch.autograd.grad(_attention64(*x64), x64, do.double())
        row = {"kernel": {n: rel(g, g_) for n, g, g_ in
                          zip(("dq", "dk", "dv"), got, g64)},
               "plain": {n: rel(g, g_) for n, g, g_ in
                         zip(("dq", "dk", "dv"), plain, g64)},
               "kernel_key_sum": (got[1].double().sum(2).abs().max()
                                  / g64[1].abs().max()).item(),
               "plain_key_sum": (plain[1].double().sum(2).abs().max()
                                 / g64[1].abs().max()).item()}
        rows[m] = row
        if (max(row["kernel"].values()) > BWD_REL_TOL
                or row["kernel_key_sum"] > KEY_SUM_TOL):
            raise AssertionError(f"flash backward, keys + {m} rms x u: "
                                 f"{json.dumps(row)}")
        del o, lse, got, plain, g64, xs, x64
        torch.cuda.empty_cache()
    print(f"[{tag}] 5b flash_attention_bwd whisper cross, every key + m x "
          f"its rms norm x u: distance from f64 (of its largest |entry|) "
          f"{json.dumps(rows)}")
    return rows


def serve_whisper(tag, device="cuda", full=True):
    """Phase 18: whisper-small served at full width and depth through
    ``launch.serve.main`` (the main path: its launches are the JSON
    record's): B=LLM_BATCH, 1500 seeded frames, WHISPER_PROMPT seeded ids,
    WHISPER_TOKENS new tokens. Gates: one flash launch per encoder layer
    and two per decoder layer in each prefill (12 of each kind), none in
    decode; ``whisper_parity``. Prints prefill ms, decode ms per token,
    peak memory and one profiled prefill's and 4 decode steps' device
    time by kind, flash by kind from CUDA events around its calls.
    ``full=False`` serves the reduced config with 24 frames (a CPU
    rehearsal). Returns the main path's flash launches and the timing."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models import stack as ST
    cfg = get_config(WHISPER) if full else get_config(WHISPER).reduced()
    B, P, N = LLM_BATCH, WHISPER_PROMPT, WHISPER_TOKENS
    if not full:
        P, N = 12, 6
    L = ST.attention_calls(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_lm(cfg, 0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _named(params))
    print(f"[{tag}] 18 {WHISPER}: init_lm {n_params / 1e9:.3f} B parameters "
          f"({cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
          f"layers), f32, in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, P))
    frames = whisper_frames(cfg, B, device, None if full else 24)

    kinds = FlashKinds()
    zero_counts()
    argv = ["--arch", WHISPER, "--batch", str(B), "--prompt-len", str(P),
            "--tokens", str(N), "--device", device] + (["--full"] if full
                                                       else [])
    with kinds.active():
        gen = serve.main(argv, prompts=prompts, params=params,
                         frames=frames.cpu().numpy())
    main_counts = counts()
    want = dict.fromkeys(main_counts, 0)
    want["flash_attention"] = L
    if (main_counts != want or kinds.counts != kinds.expect(cfg)
            or gen.shape != (B, N)):
        raise AssertionError(f"18 serve.main: launches {main_counts}, "
                             f"expected {want}; by kind {kinds.counts}; ids "
                             f"{gen.shape}")
    print(f"[{tag}] 18 {WHISPER} serve.main: ids {gen.shape}, launches "
          f"{json.dumps(main_counts)}, flash by kind "
          f"{json.dumps(kinds.counts)}")

    prefill = make_prefill_step(cfg, P + N)
    decode = make_decode_step(cfg, P + N)
    batch = {"tokens": torch.as_tensor(prompts, device=device),
             "frames": frames}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    with torch.no_grad():
        for _ in range(3):
            cache = None
            zero_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            tok, cache = prefill(params, batch)
            ev[1].record()
            torch.cuda.synchronize()
            prefill_ms.append(ev[0].elapsed_time(ev[1]))
            if counts()["flash_attention"] != L:
                raise AssertionError(f"18: {counts()['flash_attention']} "
                                     f"flash launches per prefill, expected "
                                     f"{L}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(N - 1):
            tok, cache = decode(params, cache, tok, P + i)
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if counts()["flash_attention"] != L:
        raise AssertionError("18: decode launched flash_attention")
    decode_ms = ev[0].elapsed_time(ev[1])
    timing = {"prefill_ms": float(np.median(prefill_ms)),
              "prefill_ms_runs": prefill_ms,
              "prefill_tok_per_s": B * P / (np.median(prefill_ms) / 1e3),
              "prefill_frames_per_s": B * frames.shape[1]
              / (np.median(prefill_ms) / 1e3),
              "decode_ms_per_token": decode_ms / (N - 1),
              "decode_tok_per_s": B * (N - 1) / (decode_ms / 1e3),
              "decode_wall_ms_per_token": 1e3 * wall / (N - 1),
              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    print(f"[{tag}] 18 {WHISPER} B={B} frames={frames.shape[1]} prompt={P} "
          f"new={N}: flash {L} launches per prefill, 0 added by {N - 1} "
          f"decode steps; {json.dumps(timing)}")
    del cache
    whisper_parity(tag, cfg, params, batch, P, N)
    state = {}
    with torch.no_grad():
        def run_prefill():
            state["tok"], state["cache"] = prefill(params, batch)

        def run_decode():
            tok, cache = state["tok"], state["cache"]
            for i in range(4):
                tok, cache = decode(params, cache, tok, P + i)
        with FlashKinds().active():
            print(f"[{tag}] 18 {WHISPER} profiled prefill: "
                  f"{json.dumps(_profiled(run_prefill, device))}")
            print(f"[{tag}] 18 {WHISPER} profiled 4 decode steps: "
                  f"{json.dumps(_profiled(run_decode, device))}")
        timed = FlashKinds()
        with timed.active(timed=True):
            run_prefill()
        print(f"[{tag}] 18 {WHISPER} one prefill's flash device ms by kind "
              f"(CUDA events around each call): {json.dumps(timed.ms())}, "
              f"calls {json.dumps(timed.counts)}")
    del params, state
    torch.cuda.empty_cache()
    return main_counts["flash_attention"], timing


def whisper_parity(tag, cfg, params, batch, P, N):
    """Phase 18's gates, the kernel path against ``plain_kernels=True``
    (which must launch nothing) from the same parameters and frames, each
    relative to the largest |entry| of the plain result and within
    LLM_REL_TOL: the encoder's output, the final hidden state, the
    last-position logits, every layer's self and cross cache after the
    prefill; then N − 1 decode steps teacher-forced on the kernel path's
    tokens through both caches (logits, and every layer's self cache at
    the end). The kernel path's cross caches after decode must equal the
    prefill's bit for bit (decode only reads them)."""
    from repro_torch.models import model as M
    tokens, frames = batch["tokens"], batch["frames"]
    with torch.no_grad():
        ek = M.encode(cfg, params, frames)
        hk, ck, _ = M.forward_hidden(cfg, params, tokens, frames,
                                     want_cache=True, cache_len=P + N)
        before = counts()
        ep = M.encode(cfg, params, frames, plain_kernels=True)
        hp, cp, _ = M.forward_hidden(cfg, params, tokens, frames,
                                     want_cache=True, cache_len=P + N,
                                     plain_kernels=True)
        if counts() != before:
            raise AssertionError("18: the plain run launched a kernel")
        lk = M._logits(cfg, params, hk[:, -1:])
        lp = M._logits(cfg, params, hp[:, -1:])

        def cache_errs(a, b):
            """{kind: max over layers and k/v}, kind 'self' or 'cross'."""
            out = {}
            for (n, x), (_, y) in zip(_named(a), _named(b)):
                kind = n.split(".")[2]
                for layer in range(x.shape[0]):
                    out[kind] = max(out.get(kind, 0.0),
                                    _rel_err(x[layer], y[layer]))
            return out

        errs = {"encoder": _rel_err(ek, ep), "hidden": _rel_err(hk, hp),
                "prefill_logits": _rel_err(lk, lp)}
        errs.update({f"prefill_{k}_cache": v
                     for k, v in cache_errs(ck, cp).items()})
        finite = bool(torch.isfinite(hk).all() and torch.isfinite(lk).all()
                      and torch.isfinite(ek).all())
        scales = {"max_abs_encoder": ep.abs().max().item(),
                  "max_abs_hidden": hp.abs().max().item(),
                  "max_abs_logit": lp.abs().max().item()}
        cross0 = {n: t.clone() for n, t in _named(ck) if ".cross." in n}
        del ek, ep, hk, hp
        tok = torch.argmax(lk, dim=-1)
        dec = []
        for i in range(N - 1):
            lk, ck = M.decode_step(cfg, params, tok, ck, P + i, P + N)
            lp, cp = M.decode_step(cfg, params, tok, cp, P + i, P + N)
            dec.append(_rel_err(lk, lp))
            finite = finite and bool(torch.isfinite(lk).all())
            tok = torch.argmax(lk, dim=-1)
        errs["decode_logits_max"] = max(dec)
        errs["decoded_self_cache"] = cache_errs(ck, cp)["self"]
        cross_equal = all(torch.equal(t, cross0[n]) for n, t in _named(ck)
                          if n in cross0)
    print(f"[{tag}] 18 {WHISPER} kernels vs plain (max |d| / max |plain|, "
          f"tol {LLM_REL_TOL}): {json.dumps(errs)}; {json.dumps(scales)}; "
          f"per decode step {[f'{e:.2e}' for e in dec]}; cross caches after "
          f"{N - 1} decode steps bit-equal to the prefill's: {cross_equal}")
    if not (finite and cross_equal
            and max(errs.values()) <= LLM_REL_TOL):
        raise AssertionError(f"18: kernel path != plain path {errs} (finite "
                             f"{finite}, cross caches kept {cross_equal})")


def whisper_driver(tag, device="cuda"):
    """Phase 19b: ``launch.train.main`` on whisper-small at full width and
    depth for WHISPER_DRIVER_STEPS steps at the driver's defaults (B=4,
    S=64, 24 frames per step drawn by the driver, no remat), gated by its
    own assertion that the loss falls; 36 forward and 36 backward flash
    launches per step. Returns the run's (forward, backward) launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import stack as ST
    per_step = ST.attention_calls(get_config(WHISPER))
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    losses = train.main(["--arch", WHISPER, "--full", "--steps",
                         str(WHISPER_DRIVER_STEPS), "--device", device])
    wall = time.perf_counter() - t0
    main = counts()
    want = dict.fromkeys(main, 0)
    want["flash_attention"] = want["flash_attention_bwd"] = (
        WHISPER_DRIVER_STEPS * per_step)
    print(f"[{tag}] 19b launch.train.main {WHISPER} --full --steps "
          f"{WHISPER_DRIVER_STEPS}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(5-step means {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f}) in {wall:.1f} s; launches "
          f"{json.dumps({k: v for k, v in main.items() if v})}")
    if main != want:
        raise AssertionError(f"19b: launches {main}, expected {want}")
    torch.cuda.empty_cache()
    return main["flash_attention"], main["flash_attention_bwd"]


def dryrun_grid(tag, outdir=os.path.join("build", "dryrun_torch")):
    """Phase 21's description: every arch x shape on both production
    meshes, and SURF's DRYRUN step in its four mixes and its deployed
    solve on both, counted on the ``meta`` device in DRYRUN_JOBS worker
    processes (``launch.dryrun``; nothing allocated, no card touched).
    Prints the status counts; any 'error' fails."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    surf = [(multi, mix, infer) for multi in (False, True)
            for mix, infer in ((None, False), ("ring", False),
                               ("halo", False), ("halo-sched", False),
                               (None, True))]
    with ProcessPoolExecutor(DRYRUN_JOBS,
                             mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(dryrun.run_meshes, a, s_, (False, True), outdir)
                for a in ARCH_IDS for s_ in SHAPES]
        futs += [ex.submit(dryrun.run_surf, multi, outdir, mix=mix,
                           infer=infer) for multi, mix, infer in surf]
        recs = [f.result() for f in futs]
        recs = [r for rec in recs for r in (rec if isinstance(rec, list)
                                             else [rec])]
    status = {}
    for rec in recs:
        status[rec["status"]] = status.get(rec["status"], 0) + 1
    errors = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
              for r in recs if r["status"] == "error"]
    dominant = {}
    for r in recs:
        if r["status"] == "ok":
            d = r["roofline"]["dominant"]
            dominant[d] = dominant.get(d, 0) + 1
    print(f"[{tag}] 21 dry run: {len(recs)} records in "
          f"{time.perf_counter() - t0:.1f} s ({DRYRUN_JOBS} processes, "
          f"meta device, meshes 16x16 and 2x16x16, simulated): status "
          f"{json.dumps(status)}, dominant term {json.dumps(dominant)}")
    if errors:
        raise AssertionError(f"dry run errors: {errors}")
    for r in recs:
        if r["status"] == "ok" and r["mesh"] == "16x16" and (
                r["arch"] in dict(SERVE_DENSE) or r["arch"].startswith(
                    "surf")):
            terms = {k: r["roofline"][k] for k in
                     ("compute_s", "memory_s", "collective_s", "dominant")}
            print(f"[{tag}] 21 {r['arch']} {r['shape']} 16x16: per device "
                  f"{json.dumps(r['memory'])}; flops "
                  f"{r['parsed']['flops']:.4e}, bytes "
                  f"{r['parsed']['bytes']:.4e}, collectives "
                  f"{json.dumps(r['parsed']['collectives'])}; roofline "
                  f"{json.dumps(terms)}")
    return status


def _ratio_check(tag, what, described, measured, tol):
    ratio = described / measured
    print(f"[{tag}] 21 {what}: described {described:.6e} B, measured "
          f"{measured:.6e} B, ratio {ratio:.4f} (tolerance +-{tol})")
    if abs(ratio - 1) > tol:
        raise AssertionError(f"dry run {what}: ratio {ratio:.4f} outside "
                             f"1 +- {tol}")
    return ratio


def dryrun_card_checks(tag, device="cuda"):
    """Phase 21's card checks: where a step fits one card, its
    description on a 1-device mesh against the card's allocator.

      * qwen3-4b's prefill (B=LLM_BATCH, S=LLM_PROMPT, bf16 parameters):
        argument bytes against ``memory_allocated`` once its parameters
        and batch are built, the described peak (arguments + the counted
        live bytes of the plain path) against ``max_memory_allocated`` of
        the same step with ``plain_kernels=True``;
      * qwen3-4b's donated bf16 train step cut to DRYRUN_TRAIN_LAYERS
        layers (``dryrun_train_check``);
      * DRYRUN's meta-step (n = 256, dense mixing) through the
        graph-filter kernel (L forward and L − 1 dW launches): its
        arguments (state, batch, draws) and its described peak against
        the measured ones.

    Tolerances DRYRUN_ARG_TOL and DRYRUN_PEAK_TOL, relative. Returns the
    graph filter's launches (forward, backward)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.surf_paper import DRYRUN
    from repro_torch.core.tasks import resolve_task
    from repro_torch.engine import init_state, make_meta_step
    from repro_torch.launch import dryrun, surf_dryrun
    from repro_torch.launch.hlo_cost import tree_bytes
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import PARAM_DTYPE
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.topology.families import build_topology

    cfg = get_config("qwen3-4b")
    shape = ShapeConfig("prefill_2k", LLM_PROMPT, LLM_BATCH, "prefill")
    desc = dryrun.describe(cfg, shape, Mesh([["meta"]], ("data", "model")))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = M.init_lm(cfg, 0, PARAM_DTYPE, device=device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LLM_BATCH, LLM_PROMPT)), dtype=torch.int32,
        device=device)
    torch.cuda.synchronize()
    arg = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    step = make_prefill_step(cfg, LLM_PROMPT, plain_kernels=True)
    zero_counts()
    with torch.no_grad():
        tok, cache = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if any(counts().values()):
        raise AssertionError(f"plain_kernels launched {counts()}")
    _ratio_check(tag, "qwen3-4b prefill B=4 S=2048 bf16 argument bytes",
                 desc["memory"]["argument_bytes"], arg, DRYRUN_ARG_TOL)
    _ratio_check(tag, "qwen3-4b prefill peak bytes (plain path)",
                 desc["memory"]["per_device_total"], peak, DRYRUN_PEAK_TOL)
    print(f"[{tag}] 21 qwen3-4b prefill described: flops "
          f"{desc['parsed']['flops']:.4e} (matmul "
          f"{desc['parsed']['matmul_flops']:.4e}), bytes "
          f"{desc['parsed']['bytes']:.4e}, roofline "
          f"{json.dumps(desc['roofline'])}")
    del params, tokens, tok, cache, step
    torch.cuda.empty_cache()
    dryrun_train_check(tag, cfg, device)

    A, S = build_topology(DRYRUN.topology, DRYRUN.n_agents,
                          degree=DRYRUN.degree, seed=0)
    cost, inputs = surf_dryrun.count_meta_step(DRYRUN, S)
    st = inputs["state"]
    arg_desc = tree_bytes([st.theta, st.lam, st.opt_state, inputs["batch"],
                           inputs["draws"]])
    task = resolve_task(DRYRUN)
    S_t = torch.tensor(np.asarray(S), dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(gen, DRYRUN)
    n, L = DRYRUN.n_agents, DRYRUN.n_layers
    m, t_, b = DRYRUN.train_per_agent, DRYRUN.test_per_agent, \
        DRYRUN.batch_per_agent
    F_, C = task.feat_dim, DRYRUN.n_classes
    randn = lambda *shp: torch.randn(shp, generator=gen, device=device)
    labels = lambda *shp: torch.randint(0, C, shp, generator=gen,
                                        device=device)
    batch = {"Xtr": randn(n, m, F_), "Ytr": labels(n, m),
             "Xte": randn(n, t_, F_), "Yte": labels(n, t_)}
    draws = (0.1 * randn(n, task.dim), randn(L, n, b, F_), labels(L, n, b))
    torch.cuda.synchronize()
    arg = torch.cuda.memory_allocated() - base
    meta_step, _ = make_meta_step(DRYRUN, S_t)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state2, metrics = meta_step(state, batch, draws=draws)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    c = counts()
    if c["graph_filter"] != L or c["graph_filter_bwd"] != L - 1:
        raise AssertionError(f"DRYRUN meta-step launches {c}")
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise AssertionError(f"DRYRUN meta-step metrics {metrics}")
    _ratio_check(tag, "DRYRUN meta-step argument bytes", arg_desc, arg,
                 DRYRUN_ARG_TOL)
    _ratio_check(tag, "DRYRUN meta-step peak bytes (graph-filter kernel)",
                 arg_desc + cost.peak_live_bytes, peak, DRYRUN_PEAK_TOL)
    print(f"[{tag}] 21 DRYRUN meta-step: graph_filter {c['graph_filter']}, "
          f"backward {c['graph_filter_bwd']} launches; described flops "
          f"{cost.flops:.4e} (matmul {cost.matmul_flops:.4e}), bytes "
          f"{cost.bytes:.4e}")
    del state, state2, batch, draws, metrics, S_t
    torch.cuda.empty_cache()
    return c["graph_filter"], c["graph_filter_bwd"]


def dryrun_train_check(tag, cfg, device="cuda"):
    """Phase 21's train check: qwen3-4b's donated bf16 train step
    (``steps.jitted_step``'s, the reference's ``donate_argnums=(0, 1)``),
    cut to DRYRUN_TRAIN_LAYERS layers, at B=TRAIN_BATCH, S=TRAIN_SEQ on a
    1-device mesh: its described argument bytes against the allocated
    bytes of its parameters, Adam state and batch (DRYRUN_ARG_TOL), its
    per-device total (argument + temp + output − alias: the donated trees
    counted once) against ``max_memory_allocated`` of one step of
    ``make_train_step(donate=True, plain_kernels=True)`` from them
    (DRYRUN_PEAK_TOL)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import PARAM_DTYPE
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, n_layers=DRYRUN_TRAIN_LAYERS)
    shape = ShapeConfig("train_2k", TRAIN_SEQ, TRAIN_BATCH, "train")
    desc = dryrun.describe(cfg, shape, Mesh([["meta"]], ("data", "model")))
    mem = desc["memory"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = M.init_lm(cfg, 0, PARAM_DTYPE, device=device)
    step, opt = make_train_step(cfg, microbatches=desc["microbatches"],
                                plain_kernels=True, donate=True)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (TRAIN_BATCH,
                                                            TRAIN_SEQ)),
                                dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    arg = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = step(params, opt_state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if any(counts().values()) or out[0] is not params:
        raise AssertionError(f"21 train step: launches {counts()}, donated "
                             f"{out[0] is params}")
    if not math.isfinite(out[2]["loss"].item()):
        raise AssertionError(f"21 train step loss {out[2]['loss']}")
    _ratio_check(tag, f"qwen3-4b train step ({DRYRUN_TRAIN_LAYERS} layers, "
                 f"B={TRAIN_BATCH} S={TRAIN_SEQ}, bf16, donated) argument "
                 "bytes", mem["argument_bytes"], arg, DRYRUN_ARG_TOL)
    _ratio_check(tag, "qwen3-4b donated train step peak bytes (plain path)",
                 mem["per_device_total"], peak, DRYRUN_PEAK_TOL)
    print(f"[{tag}] 21 qwen3-4b donated train step described: "
          f"{json.dumps(mem)}; microbatches {desc['microbatches']}")
    del params, opt_state, batch, out, step
    torch.cuda.empty_cache()


class FlashWindows:
    """Counts each flash-attention call of the model by its window (0: a
    causal call over the whole prefix, a global layer's), phase 22. With
    ``gate`` each call is also held, where it is made, against
    ``attention_ref`` on its own inputs within ``ops.bf16_error_bound``
    per element (22b: the bf16 calls); nothing of a call is kept but the
    largest fraction of the bound used, per window (``use``). The calls
    go through the wrapper, whose counter counts them, and the kernel's
    output is what the model receives."""

    def __init__(self, gate=False):
        self.gate, self.counts, self.use = gate, {}, {}

    def active(self):
        from unittest import mock

        from repro_torch.kernels.flash_attention import attention_ref, ops
        from repro_torch.models import attention as A

        def call(q, k, v, causal=True, window=0):
            o = ops.flash_attention(q, k, v, causal=causal, window=window)
            self.counts[window] = self.counts.get(window, 0) + 1
            if self.gate:
                o_ref = attention_ref(q, k, v, causal=causal, window=window)
                use = _bound_use(o, o_ref, ops.bf16_error_bound(
                    q, k, v, o_ref, causal=causal, window=window))
                self.use[window] = max(self.use.get(window, 0.0), use)
                if not use <= 1:
                    raise AssertionError(
                        f"flash call {self.counts[window]} of window "
                        f"{window} {tuple(q.shape)} {q.dtype}: |kernel - "
                        f"plain| is {use:.3f} of bf16_error_bound")
            return o

        return mock.patch.object(A, "FA",
                                 SimpleNamespace(flash_attention=call))


def _attn_windows(cfg):
    """{window: attention layers}: one flash call each per prefill."""
    from repro_torch.models import stack as ST
    out = {}
    for _, reps, body in ST.build_segments(cfg):
        for kind in body:
            if kind[0] == "attn":
                out[kind[2]] = out.get(kind[2], 0) + reps
    return out


def serve_gemma(tag, device="cuda", full=True):
    """Phase 22a: gemma3-27b cut to one period (GEMMA_PERIOD_LAYERS: 5
    local layers, then the global one) served in f32 through
    ``launch.serve.main`` by ``serve_llm`` (phase 20's run), every flash
    call counted by window (``FlashWindows``): each prefill 5 windowed
    and 1 causal. The parity pass also holds every cache after the
    teacher-forced decode (the 5 rings of 1024 slots, the global layer's
    2080 slots). Returns the main path's flash launches."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA) if full else get_config(GEMMA).reduced()
    n_layers = GEMMA_PERIOD_LAYERS if full else None
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    per_prefill = _attn_windows(cfg)
    windows = FlashWindows()
    with windows.active():
        launches, timing = serve_llm(tag, GEMMA, "flash_attention",
                                     device=device, full=full,
                                     n_layers=n_layers, check_caches=True)
    runs = sum(windows.counts.values()) // sum(per_prefill.values())
    want = {w: runs * n for w, n in per_prefill.items()}
    print(f"[{tag}] 22a {GEMMA} ({cfg.n_layers} layers) flash calls by "
          f"window over the phase's {runs} forwards: "
          f"{json.dumps(windows.counts)} (per prefill "
          f"{json.dumps(per_prefill)}); {json.dumps(timing)}")
    if windows.counts != want or launches != sum(per_prefill.values()):
        raise AssertionError(f"22a: flash calls by window "
                             f"{windows.counts}, expected {want}; main "
                             f"path launches {launches}")
    return launches


def _forward_f32(cfg, params, tokens):
    """The plain forward in f32 of bf16 parameters: each layer's
    parameters converted to f32 just before the layer runs (the whole
    model in f32, 113.7 GB at full depth, does not fit one card), the
    embedding rows and the last position's logits from f32 copies too
    (the head converted in slices of 32768 entries). Returns (hidden
    (B, S, d) f32, last-position logits (B, 1, V) f32)."""
    from repro_torch.models import layers as L
    from repro_torch.models import stack as ST
    from repro_torch.utils.tree import _map
    f32 = lambda tree: _map(lambda t: t.float(), tree)
    x = L.embed(params["embed"], tokens).float()
    ctx = ST.Ctx(mode="full", plain_kernels=True)
    for name, reps, kinds in ST.build_segments(cfg):
        for r in range(reps):
            p = f32(ST._index(params["segments"][name], r))
            for j, kind in enumerate(kinds):
                x, _, _ = ST.apply_layer_full(cfg, kind, p[f"s{j}"], x, ctx)
            del p
    x = L.apply_norm(cfg.norm, f32(params["final_norm"]), x)
    w = (params["embed"]["table"].mT if cfg.tie_embeddings
         else params["head"]["w"])
    last = x[:, -1:]
    logits = torch.cat([last @ w[:, i:i + 32768].float()
                        for i in range(0, w.shape[1], 32768)], dim=-1)
    return x, logits


def _bf16_distances(cfg, params, tokens, hk, hp):
    """The bf16 kernel path's (``hk``) and plain path's (``hp``) final
    hidden states and last-position logits, each as max |d| / max |f32|
    from ``_forward_f32`` of the same parameters."""
    from repro_torch.models import model as M
    h32, l32 = _forward_f32(cfg, params, tokens)
    lk = M._logits(cfg, params, hk[:, -1:])
    lp = M._logits(cfg, params, hp[:, -1:])
    out = {"kernel_hidden": _rel_err(hk, h32), "plain_hidden":
           _rel_err(hp, h32), "kernel_logits": _rel_err(lk, l32),
           "plain_logits": _rel_err(lp, l32),
           "kernel_vs_plain_hidden": _rel_err(hk, hp),
           "kernel_vs_plain_logits": _rel_err(lk, lp),
           "max_abs_hidden_f32": h32.abs().max().item(),
           "max_abs_logit_f32": l32.abs().max().item()}
    del h32, l32
    return out


def bf16_cut(tag, device="cuda", full=True):
    """Phase 22b': gemma3-27b cut to GEMMA_CUT_LAYERS in bf16
    (``launch.specs.PARAM_DTYPE``; the full depth's gate): the kernel
    path's and the plain path's distances from the f32 forward of the
    same bf16-valued weights, the kernel path's at most BF16_E2E_FACTOR
    times the plain path's, on the hidden states and on the logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    cfg = get_config(GEMMA) if full else get_config(GEMMA).reduced()
    if full:
        cfg = dataclasses.replace(cfg, n_layers=GEMMA_CUT_LAYERS)
    torch.cuda.empty_cache()
    params = M.init_lm(cfg, 0, SP.PARAM_DTYPE, device=device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LLM_BATCH, LLM_PROMPT)), device=device)
    with torch.no_grad():
        hk, _, _ = M.forward_hidden(cfg, params, tokens)
        hp, _, _ = M.forward_hidden(cfg, params, tokens, plain_kernels=True)
        d = _bf16_distances(cfg, params, tokens, hk, hp)
    ok = all(d[f"kernel_{w}"] <= BF16_E2E_FACTOR * d[f"plain_{w}"]
             for w in ("hidden", "logits"))
    print(f"[{tag}] 22b' {GEMMA} ({cfg.n_layers} layers, bf16) distance "
          f"from the f32 forward of the same weights (max |d| / max |f32|;"
          f" the kernel path's at most {BF16_E2E_FACTOR}x the plain "
          f"path's): {json.dumps(d)}")
    del params, hk, hp
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"22b': the bf16 kernel path is more than "
                             f"{BF16_E2E_FACTOR}x as far from f32 as the "
                             f"plain path: {d}")


def serve_bf16(tag, device="cuda", full=True):
    """Phase 22b: gemma3-27b at full width and depth in bf16, served
    through the steps ``launch.serve`` runs (``launch.steps``; the serve
    entry point, as the reference's, takes no dtype). The main path,
    counted from zero: a prefill of LLM_BATCH x LLM_PROMPT seeded ids,
    every flash call gated where it is made (``FlashWindows(gate=True)``),
    then LLM_TOKENS - 1 greedy decode steps: one launch per attention
    layer per prefill, none in decode, and caches of
    ``launch.specs.cache_spec_tree``'s shapes and dtype. Then the times
    (CUDA events, median of 3 prefills; the decode steps), the peak
    memory, a profiled prefill and decode (busy share), the plain bf16
    path's own greedy ids beside the kernel path's, and the distances of
    both paths from the f32 forward (printed). Returns the main path's
    flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    cfg = get_config(GEMMA) if full else get_config(GEMMA).reduced()
    B, P, N = LLM_BATCH, LLM_PROMPT, LLM_TOKENS
    L = layer_kinds(cfg).count("attn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_lm(cfg, 0, SP.PARAM_DTYPE, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _named(params))
    print(f"[{tag}] 22b {GEMMA}: init_lm {n_params / 1e9:.3f} B parameters, "
          f"{SP.PARAM_DTYPE}, {cfg.n_layers} layers "
          f"{json.dumps(_attn_windows(cfg))} by window, in "
          f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)), device=device)
    prefill = steps.make_prefill_step(cfg, P + N)
    decode = steps.make_decode_step(cfg, P + N)

    gate = FlashWindows(gate=True)
    zero_counts()
    with torch.no_grad(), gate.active():
        tok, cache = prefill(params, {"tokens": tokens})
        after_prefill = counts()
        ids = [tok]
        for i in range(N - 1):
            tok, cache = decode(params, cache, tok, P + i)
            ids.append(tok)
    main = counts()
    want = dict.fromkeys(main, 0)
    want["flash_attention"] = L
    spec = {n: (tuple(t.shape), t.dtype) for n, t in
            _named(SP.cache_spec_tree(cfg, B, P + N))}
    got = {n: (tuple(t.shape), t.dtype) for n, t in _named(cache)}
    gen_k = torch.cat(ids, dim=1)
    print(f"[{tag}] 22b main path: launches {json.dumps(main)} (after the "
          f"prefill {json.dumps(after_prefill)}); flash calls by window "
          f"{json.dumps(gate.counts)}, largest share of bf16_error_bound "
          f"used by window {json.dumps(gate.use)}; caches "
          f"{len(got)} tensors, {SP.PARAM_DTYPE}; ids {tuple(gen_k.shape)}")
    if (main != want or after_prefill != want or got != spec
            or gate.counts != _attn_windows(cfg)):
        raise AssertionError(f"22b: launches {main} / {after_prefill}, "
                             f"expected {want}; calls {gate.counts}; "
                             f"caches equal to the spec: {got == spec}")
    del cache

    timing = time_serve_steps(params, prefill, decode, tokens,
                              "flash_attention", L)
    print(f"[{tag}] 22b {GEMMA} ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, bf16) B={B} prompt={P} "
          f"new={N}: {json.dumps(timing)}")
    profile_llm(tag, f"{GEMMA} bf16", params, prefill, decode, tokens, P,
                device)

    with torch.no_grad():
        hp, cp, _ = M.forward_hidden(cfg, params, tokens, want_cache=True,
                                     cache_len=P + N, plain_kernels=True)
        lp = M._logits(cfg, params, hp[:, -1:])
        top2 = [torch.topk(lp[:, 0], 2).values]
        tok = torch.argmax(lp, dim=-1).to(torch.int32)
        plain_ids = [tok]
        for i in range(N - 1):
            lp, cp = M.decode_step(cfg, params, tok, cp, P + i, P + N)
            top2.append(torch.topk(lp[:, 0], 2).values)
            tok = torch.argmax(lp, dim=-1).to(torch.int32)
            plain_ids.append(tok)
        del cp, lp
        gen_p = torch.cat(plain_ids, dim=1)
        differ = (gen_k != gen_p).nonzero().tolist()
        greedy = {"ids_shared": int((gen_k == gen_p).sum()),
                  "ids": gen_k.numel()}
        if differ:
            b, t = min(differ, key=lambda bt: (bt[1], bt[0]))
            greedy.update(first_differing_step=t, row=b,
                          plain_top2_margin=(top2[t][b, 0]
                                             - top2[t][b, 1]).item())
        print(f"[{tag}] 22b greedy ids, kernel path vs plain path (bf16, "
              f"each its own tokens; not gated): {json.dumps(greedy)}")
        hk, _, _ = M.forward_hidden(cfg, params, tokens)
        d = _bf16_distances(cfg, params, tokens, hk, hp)
    print(f"[{tag}] 22b {GEMMA} ({cfg.n_layers} layers, bf16) distance from "
          f"the f32 forward of the same weights (max |d| / max |f32|; not "
          f"gated): {json.dumps(d)}")
    del params, hk, hp
    torch.cuda.empty_cache()
    return main["flash_attention"]


def train_gemma(tag, device="cuda", full=True):
    """Phase 22c: the loss and gradients of gemma3-27b cut to
    GEMMA_TRAIN_LAYERS (both local: window 1024 < S) at full width in
    f32, B=TRAIN_BATCH, S=TRAIN_SEQ, remat, ``--opts TRAIN_OPTS``, on the
    token pipeline's first batch: ``steps.loss_and_grads``, the windowed
    flash forward and backward kernels on the path (the only model run on
    the card whose backward meets a window). Counted from zero: 2L
    forward launches (remat's recompute) and L backward ones, each call
    of window 1024; ms (CUDA events, median of 3) and the peak memory;
    then phase 13's parity against ``plain_kernels=True``. No Adam step:
    f32 Adam state does not fit one card at any depth (the untied
    embedding and head alone are 2 x 262144 x 5376 = 2.82 B parameters;
    parameters, gradients and two moments take about 58 GB at 2 layers,
    before the step's new parameters and moments). Returns the main
    path's forward and backward launches."""
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as M
    cfg = get_config(GEMMA) if full else get_config(GEMMA).reduced()
    if full:
        cfg = dataclasses.replace(cfg, n_layers=GEMMA_TRAIN_LAYERS)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    L = layer_kinds(cfg).count("attn")
    prev = flags.get()
    flags.parse_opts(TRAIN_OPTS)
    try:
        torch.cuda.empty_cache()
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(TokenPipeline(cfg.vocab, B, S,
                                                seed=0)).items()}
        params = M.init_lm(cfg, 0, device=device)
        n_params = sum(t.numel() for _, t in _named(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        windows, times = FlashWindows(), []
        for i in range(3):
            zero_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with windows.active():
                ev[0].record()
                (loss, _), grads = loss_and_grads(cfg, params, batch,
                                                  remat=True)
                ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
            if i == 0:
                main = counts()
                first = dict(windows.counts)
            del grads
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(main, 0)
        want["flash_attention"], want["flash_attention_bwd"] = 2 * L, L
        record = {"parameters": n_params, "loss": loss.item(),
                  "ms": float(np.median(times)), "ms_runs": times,
                  "tokens_per_s": B * S / (np.median(times) / 1e3),
                  "peak_memory_bytes": peak,
                  "launches": {k: v for k, v in main.items() if v},
                  "forward_calls_by_window": first}
        print(f"[{tag}] 22c {GEMMA} ({cfg.n_layers} layers, f32) loss and "
              f"gradients B={B} S={S} remat {TRAIN_OPTS}: "
              f"{json.dumps(record)}")
        want_w = {w: 2 * n for w, n in _attn_windows(cfg).items()}
        if (main != want or first != want_w
                or not math.isfinite(loss.item())):
            raise AssertionError(f"22c: launches {main}, expected {want}; "
                                 f"forward calls by window {first}, "
                                 f"expected {want_w}")
        _train_parity(tag, GEMMA, cfg, params, batch, derived=False,
                      phase="22c")
    finally:
        flags.set_flags(**dataclasses.asdict(prev))
    del params
    torch.cuda.empty_cache()
    return main["flash_attention"], main["flash_attention_bwd"]


def flash_bwd_bf16_bound_ms(B, H, KV, S, dh, window, skv=None,
                            causal=True):
    """The bf16 gradient: q, k, v, o, do (bf16) and the row lse (f32) read
    once, dq, dk, dv (bf16) written once; 10 dh operations per live (query,
    key) pair (``flash_bwd_bound_ms``'s five products), one bf16 product
    each on the tensor cores at 989 TFLOP/s. Returns (ms, what bounds
    it)."""
    skv = S if skv is None else skv
    flops = 10 * B * H * dh * _live_pairs(S, skv, window, causal)
    nbytes = 2 * (4 * B * H * S * dh + 4 * B * KV * skv * dh) + 4 * B * H * S
    return bound(nbytes, flops, PEAK_BF16_TC_FLOP_PER_S)


def _flash_bwd_bf16_case(rng, shape, device="cuda"):
    """bf16 q, k, v, do of ``shape`` (B, H, KV, Sq, Skv, dh, causal,
    window), the kernel's forward (o, lse) and backward, a rerun, and
    autograd through ``attention_ref`` on the same bf16 inputs. Returns
    (inputs, o, lse, kernel grads, the rerun bit-equal, plain leaves,
    plain output, plain grads)."""
    from repro_torch.kernels.flash_attention import attention_ref, ops
    B, H, KV, Sq, Skv, dh, causal, win = shape
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=device).to(torch.bfloat16)
        for n, s in ((H, Sq), (KV, Skv), (KV, Skv), (H, Sq)))
    o, lse = ops._launch(q, k, v, causal, win, want_lse=True)
    grads = ops._launch_bwd(q, k, v, o, lse, do, causal, win)
    again = ops._launch_bwd(q, k, v, o, lse, do, causal, win)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref = attention_ref(*xs, causal=causal, window=win)
    ref = torch.autograd.grad(o_ref, xs, do, retain_graph=True)
    return (q, k, v, do), o, lse, grads, bit_equal, xs, o_ref, ref


def check_flash_bwd_bf16(tag):
    """Phases 5b (bf16): the flash backward kernel's bf16 entry against
    autograd through ``attention_ref`` on the same bf16 inputs (f32
    arithmetic, each gradient rounded to bf16 once) at the sweep shapes,
    qwen3-4b, gemma3's window-1024 and global shapes, and whisper's
    encoder and cross shapes (non-causal, Sq ≠ Skv, dh = 64): every
    element of dq, dk and dv within ``ops.bf16_grad_error_bound`` (the
    largest fraction used at most 1), a rerun bit-equal. At the full-width
    shapes: µs per launch (CUDA events, median), the bound, the plain
    backward's time and ``scaled_dot_product_attention``'s bf16 backward
    (memory-efficient, K/V expanded to H heads; a boolean mask for the
    window). Returns (the largest |kernel − plain|, the largest fraction
    of the bound, the qwen3-4b timing, {shape: record})."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(26)
    timed = {"qwen3-4b": FLASH_QWEN, "gemma3 window": FLASH_GEMMA,
             "gemma3 global": FLASH_GEMMA_GLOBAL}
    shapes = [(B, H, KV, S, S, dh, True, w) for B, H, KV, S, dh, w
              in FLASH_SWEEP + list(timed.values())]
    shapes += [(B, H, KV, Sq, Skv, dh, False, 0)
               for B, H, KV, Sq, Skv, dh in FLASH_WHISPER.values()]
    names = {(B, H, KV, S, S, dh, True, w): n
             for n, (B, H, KV, S, dh, w) in timed.items()}
    names.update({(B, H, KV, Sq, Skv, dh, False, 0): f"whisper {n}"
                  for n, (B, H, KV, Sq, Skv, dh) in FLASH_WHISPER.items()})
    max_err, max_use, timing, records = 0.0, 0.0, None, {}
    for shape in shapes:
        B, H, KV, Sq, Skv, dh, causal, win = shape
        (q, k, v, do), o, lse, grads, bit_equal, xs, o_ref, ref = (
            _flash_bwd_bf16_case(rng, shape))
        bounds = ops.bf16_grad_error_bound(q, k, v, do, ref, causal=causal,
                                           window=win)
        use = {n: _bound_use(g, r, b) for n, g, r, b in
               zip(("dq", "dk", "dv"), grads, ref, bounds)}
        errs = {n: (g.float() - r.float()).abs().max().item()
                for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
        del bounds
        print(f"flash backward bf16 vs plain {shape}: max |err| "
              f"{json.dumps(errs)}, of bf16_grad_error_bound "
              f"{json.dumps(use)}; rerun bit-equal {bit_equal}")
        if max(use.values()) > 1 or not bit_equal:
            raise AssertionError(f"flash backward bf16 at {shape}: {use} of "
                                 "the bound, or rerun not bit-equal")
        max_err = max(max_err, *errs.values())
        max_use = max(max_use, *use.values())
        if shape in names:
            ms = median_ms(lambda: ops._launch_bwd(q, k, v, o, lse, do,
                                                   causal, win),
                           reps=5, inner=3, warm=1)
            plain_ms = median_ms(lambda: torch.autograd.grad(
                o_ref, xs, do, retain_graph=True), reps=3, inner=1, warm=1)
            del o_ref, xs, ref
            torch.cuda.empty_cache()
            mask = None
            if win:
                i = torch.arange(Sq, device="cuda")
                mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - win)
            ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
            xe = [t.clone().requires_grad_() for t in (q, ke, ve)]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                oe = sdpa(*xe, attn_mask=mask, is_causal=causal and not win)
                lib_ms = median_ms(lambda: torch.autograd.grad(
                    oe, xe, do, retain_graph=True), reps=5, inner=3, warm=1)
            del ke, ve, xe, oe
            bound_ms, bound_by = flash_bwd_bf16_bound_ms(
                B, H, KV, Sq, dh, win, skv=Skv, causal=causal)
            rec = {"us": 1e3 * ms, "plain_us": 1e3 * plain_ms,
                   "sdpa_mem_efficient_us": 1e3 * lib_ms,
                   "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
                   "of_bound": use}
            records[names[shape]] = rec
            if names[shape] == "qwen3-4b":
                timing = (ms, plain_ms, bound_ms, bound_by, lib_ms)
            print(f"[{tag}] 5b flash_attention_bwd bf16 {names[shape]} "
                  f"B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} dh={dh} causal="
                  f"{causal} window={win}: kernel {ms * 1e3:.1f} us, bound "
                  f"{bound_ms * 1e3:.1f} us ({bound_by}, bf16 on the tensor "
                  f"cores; the kernel's 7 products {bound_ms * 1.4e3:.1f} us)"
                  f", plain PyTorch backward {plain_ms * 1e3:.1f} us, "
                  f"scaled_dot_product_attention bf16 backward (memory-"
                  f"efficient, K/V expanded) {lib_ms * 1e3:.1f} us")
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return max_err, max_use, timing, records


def _wkv_case(rng, B, H, T, dk, dtype, tiny_w=False):
    """Seeded r, k, v, w (decays in (0.5, 1); with ``tiny_w`` 1e-7 at the
    first three steps of every row, and at steps 62-66 across the first
    chunk boundary where T reaches them), u, dy and a nonzero dS, on the
    card."""
    def mk():
        return 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
    if tiny_w:
        w[..., :3, :] = 1e-7
        w[..., 62:67, :] = 1e-7
    u = (0.1 * rng.standard_normal((H, dk))).astype(np.float32)
    args = [torch.tensor(a, device="cuda") for a in (r, k, v, w)]
    args = [a.to(dtype) for a in args] + [torch.tensor(u, device="cuda")]
    dy = torch.tensor(mk(), device="cuda").to(dtype)
    dS = torch.tensor(rng.standard_normal((B, H, dk, dk)).astype(np.float32),
                      device="cuda")
    return args, dy, dS


def check_wkv_bwd_bf16(tag):
    """Phase 6b (bf16 and dS): the wkv backward kernel's bf16 entry against
    autograd through ``wkv_ref`` on the same bf16 inputs at the sweep
    shapes (the first three decays near 0 at one of them) and at the
    rwkv6-1.6b shape, each call with the chunk-start states the forward
    launch returned (as ``WKV`` makes it): dr, dk, dv, dw within
    ``ops.bf16_grad_error_bound`` per element, du (f32) within BWD_REL_TOL
    of its largest entry, a rerun bit-equal. Then a nonzero cotangent on the final state S (the
    reference's scan is differentiated through it) at every sweep shape in
    f32 (each gradient within BWD_REL_TOL) and in bf16 (the bound). µs
    per launch of the bf16 entry, the
    bound and the plain backward's time at the rwkv6-1.6b shape. Returns
    (the largest |kernel − plain| of the bf16 runs, the largest fraction
    of the bound, the timing)."""
    from repro_torch.kernels.ssm_scan import ops, wkv_ref
    rng = np.random.default_rng(66)
    names = ("dr", "dk", "dv", "dw", "du")
    max_err, max_use, timing = 0.0, 0.0, None
    cases = [(s, torch.bfloat16, False)
             for s in WKV_SWEEP + [WKV_RAGGED, WKV_RWKV]]
    cases += [(s, dt, True) for s in WKV_SWEEP + [WKV_RAGGED]
              for dt in (torch.float32, torch.bfloat16)]
    for (B, H, T, dk), dtype, with_dS in cases:
        args, dy, dS = _wkv_case(rng, B, H, T, dk, dtype,
                                 tiny_w=(B, H, T, dk) in (WKV_SWEEP[1],
                                                          WKV_RAGGED))
        dS = dS if with_dS else None
        states = ops._launch(*args)[2]
        grads = ops._launch_bwd(*args, dy, dS, states)
        again = ops._launch_bwd(*args, dy, dS, states)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        xs = [a.clone().requires_grad_() for a in args]
        y_ref, S_ref = wkv_ref(*xs)
        outs, cots = ([y_ref, S_ref], [dy, dS]) if with_dS else ([y_ref],
                                                                 [dy])
        ref = torch.autograd.grad(outs, xs, cots, retain_graph=True)
        errs = {n: (g.float() - q.float()).abs().max().item()
                for n, g, q in zip(names, grads, ref)}
        rel = {n: errs[n] / q.float().abs().max().item()
               for n, q in zip(names, ref)}
        if dtype == torch.float32:
            use = {n: rel[n] / BWD_REL_TOL for n in names}
        else:
            bounds = ops.bf16_grad_error_bound(ref[:4])
            use = {n: _bound_use(g, q, b) for n, g, q, b in
                   zip(names, grads, ref, bounds)}
            use["du"] = rel["du"] / BWD_REL_TOL
            max_err = max(max_err, *errs.values())
            max_use = max(max_use, *use.values())
        gate = ("of BWD_REL_TOL" if dtype == torch.float32 else
                "of bf16_grad_error_bound (du: of BWD_REL_TOL)")
        print(f"wkv backward {str(dtype)[6:]} vs plain B={B} H={H} T={T} "
              f"dk={dk}{' with dS' if with_dS else ''}: max |err| "
              f"{json.dumps(errs)}, {gate} {json.dumps(use)}; rerun "
              f"bit-equal {bit_equal}")
        if max(use.values()) > 1 or not bit_equal:
            raise AssertionError(f"wkv backward {dtype} at {(B, H, T, dk)} "
                                 f"dS {with_dS}: {use} or rerun not "
                                 "bit-equal")
        if (B, H, T, dk) == WKV_RWKV and not with_dS:
            ms = median_ms(lambda: ops._launch_bwd(*args, dy, None, states),
                           reps=7, inner=5, warm=2)
            plain_ms = median_ms(lambda: torch.autograd.grad(
                y_ref, xs, dy, retain_graph=True), reps=2, inner=1, warm=1)
            bound_ms, bound_by = wkv_bwd_bound_ms(B, H, T, dk, elem=2)
            timing = (ms, plain_ms, bound_ms, bound_by)
            print(f"[{tag}] wkv_bwd bf16 B={B} H={H} T={T} dk={dk}: kernel "
                  f"{ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
                  f"({bound_by}), plain PyTorch backward "
                  f"{plain_ms * 1e3:.1f} us (no single PyTorch call "
                  "computes this recurrence)")
        del xs, y_ref, S_ref, ref, grads, args, dy, dS, states
        torch.cuda.empty_cache()
    return max_err, max_use, timing


class FlashBwdGate:
    """Holds each flash backward launch of the model, where it is made,
    against autograd through ``attention_ref`` on the same inputs and
    cotangent within ``ops.bf16_grad_error_bound`` per element (23a: the
    bf16 calls); nothing of a call is kept but the largest fraction of
    the bound used (``use``). The kernel's gradients are what the model
    receives."""

    def __init__(self):
        self.calls, self.use = 0, 0.0

    def active(self):
        from unittest import mock

        from repro_torch.kernels.flash_attention import attention_ref, ops
        launch = ops._launch_bwd

        def gated(q, k, v, o, lse, do, causal, window):
            grads = launch(q, k, v, o, lse, do, causal, window)
            with torch.enable_grad():
                xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                ref = torch.autograd.grad(attention_ref(
                    *xs, causal=causal, window=window), xs, do)
            del xs
            bounds = ops.bf16_grad_error_bound(q, k, v, do, ref,
                                               causal=causal, window=window)
            use = max(_bound_use(g, r, b)
                      for g, r, b in zip(grads, ref, bounds))
            del ref, bounds
            self.calls += 1
            self.use = max(self.use, use)
            if not use <= 1:
                raise AssertionError(
                    f"flash backward call {self.calls} {tuple(q.shape)} "
                    f"{q.dtype}: |kernel - plain| is {use:.3f} of "
                    "bf16_grad_error_bound")
            return grads

        return mock.patch.object(ops, "_launch_bwd", gated)


def _tree_dist(a, ref):
    """Two distances of gradient tree ``a`` from ``ref`` over all their
    tensors: ‖a − ref‖₂ / ‖ref‖₂ and max |a − ref| / max |ref|."""
    sq = nsq = 0.0
    big = dmax = 0.0
    for (_, x), (_, r) in zip(_named(a), _named(ref)):
        d = x.float() - r.float()
        sq += d.square().sum().item()
        nsq += r.float().square().sum().item()
        dmax = max(dmax, d.abs().max().item())
        big = max(big, r.float().abs().max().item())
    return {"norm_rel": math.sqrt(sq / nsq), "max_rel": dmax / big}


def _bf16_grad_distances(cfg, params, batch):
    """The gradients of the kernel step and of the plain step
    (``plain_kernels=True``) from bf16 ``params``, each as a distance from
    the f32 plain step of the same weights widened (``_tree_dist``), and
    their distance from each other; the kernel step's at most
    BF16_E2E_FACTOR times the plain step's on both measures passes.
    Returns (the distances, whether they pass)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.utils.tree import _map
    (_, _), gk = loss_and_grads(cfg, params, batch, remat=True)
    (_, _), gp = loss_and_grads(cfg, params, batch, remat=True,
                                plain_kernels=True)
    (_, _), g32 = loss_and_grads(cfg, _map(lambda t: t.float(), params),
                                 batch, remat=True, plain_kernels=True)
    d = {"kernel": _tree_dist(gk, g32), "plain": _tree_dist(gp, g32),
         "kernel_vs_plain": _tree_dist(gk, gp)}
    del gk, gp, g32
    return d, all(d["kernel"][m] <= BF16_E2E_FACTOR * d["plain"][m]
                  for m in ("norm_rel", "max_rel"))


def train_bf16(tag, arch=BF16_TRAIN_ARCH, device="cuda", full=True):
    """Phase 23a: qwen3-4b at full width and depth in bf16
    (``launch.specs.PARAM_DTYPE``; Adam's moments f32), B=TRAIN_BATCH,
    S=TRAIN_SEQ, remat, ``--opts TRAIN_OPTS``, lr TRAIN_LR.

      * gradients, before the optimizer state exists: one
        ``loss_and_grads`` through the kernels with every flash backward
        call held where it is made within ``ops.bf16_grad_error_bound``
        of the plain backward on its own inputs (``FlashBwdGate``); the
        plain bf16 step's (``plain_kernels=True``) loss and gradients
        beside it, their distances printed (23a' holds the whole step
        against f32);
      * the main path, counted from zero: BF16_TRAIN_STEPS steps of
        ``make_train_step(donate=True)``, 2L forward and L backward flash
        launches each, held to the reference driver's check (the mean
        loss of the last 5 steps below that of the first 5); ms per step
        (CUDA events, median of the steps after the first), tokens/s,
        peak memory (under 80 GB), one profiled step's device time by
        kernel kind and busy share.

    Returns (forward, backward launches of the main path, the record)."""
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import specs as SP
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    cfg = get_config(arch) if full else get_config(arch).reduced()
    L = cfg.n_layers
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if full else (2, 64)
    prev = flags.get()
    flags.parse_opts(TRAIN_OPTS)
    try:
        torch.cuda.empty_cache()
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(TokenPipeline(cfg.vocab, B, S,
                                                seed=0)).items()}
        params = M.init_lm(cfg, 0, SP.PARAM_DTYPE, device=device)
        n_params = sum(t.numel() for _, t in _named(params))
        gate = FlashBwdGate()
        zero_counts()
        with gate.active():
            (lk, _), gk = loss_and_grads(cfg, params, batch, remat=True)
        gated = counts()
        (lp, _), gp = loss_and_grads(cfg, params, batch, remat=True,
                                     plain_kernels=True)
        par = {"loss_kernel": lk.item(), "loss_plain": lp.item(),
               "kernel_vs_plain": _tree_dist(gk, gp),
               "flash_bwd_calls_gated": gate.calls,
               "largest_use_of_bf16_grad_error_bound": gate.use}
        del gk, gp
        print(f"[{tag}] 23a {arch} ({L} layers, bf16) loss and gradients, "
              f"kernels vs plain at B={B} S={S}: {json.dumps(par)}; "
              f"launches {json.dumps({k: v for k, v in gated.items() if v})}")
        if gate.calls != L or not math.isfinite(lk.item()):
            raise AssertionError(f"23a: {gate.calls} gated backward calls, "
                                 f"expected {L}; loss {lk.item()}")

        step, opt = make_train_step(cfg, lr=TRAIN_LR, remat=True,
                                    donate=True)
        opt_state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, times = [], []
        for _ in range(BF16_TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(params, opt_state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            if out[0] is not params or out[1] is not opt_state:
                raise AssertionError("23a: the donated step returned new "
                                     "trees")
            times.append(ev[0].elapsed_time(ev[1]))
            losses.append(out[2]["loss"].item())
        main = counts()
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(main, 0)
        want["flash_attention"] = 2 * L * BF16_TRAIN_STEPS
        want["flash_attention_bwd"] = L * BF16_TRAIN_STEPS
        head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
        ms = float(np.median(times[1:]))
        record = {"parameters": n_params, "ms_per_step": ms,
                  "ms_per_step_runs": times, "tokens_per_s": B * S / (ms / 1e3),
                  "peak_memory_bytes": peak, "losses": losses,
                  "loss_5_step_means": [head, tail],
                  "grad_norm": out[2]["grad_norm"].item(),
                  "launches": {k: v for k, v in main.items() if v}}
        print(f"[{tag}] 23a {arch} train steps ({L} layers, bf16, donated) "
              f"B={B} S={S} remat {TRAIN_OPTS}: {json.dumps(record)}")
        if main != want or not tail < head or not all(
                math.isfinite(x) for x in losses) or peak >= 80e9:
            raise AssertionError(f"23a: launches {main} (expected {want}), "
                                 f"5-step means {head} -> {tail}, peak "
                                 f"{peak}")
        prof = _profiled(lambda: step(params, opt_state, batch), device)
        print(f"[{tag}] 23a {arch} profiled train step: {json.dumps(prof)}")
        dev = prof["device_ms"]
        record["flash_bwd_device_ms_per_step"] = (
            dev.get("flash_attention_bwd", 0.0) if isinstance(dev, dict)
            else dev)
        print(f"[{tag}] 23a {arch} flash backward device time per step: "
              f"{record['flash_bwd_device_ms_per_step']} ms ({L} calls)")
    finally:
        flags.set_flags(**dataclasses.asdict(prev))
    del params, opt_state, out
    torch.cuda.empty_cache()
    return main["flash_attention"], main["flash_attention_bwd"], record


def bf16_train_cut(tag, arch=BF16_TRAIN_ARCH, device="cuda", full=True):
    """Phase 23a': qwen3-4b cut to BF16_TRAIN_CUT layers in bf16, phase
    23a's batch and flags: the gradients of the kernel step and of the
    plain step, each as a distance from the f32 plain step of the same
    bf16-valued weights widened (``_bf16_grad_distances``: over all
    tensors, the norm and the largest entry); the kernel step's at most
    BF16_E2E_FACTOR times the plain step's, on both. Then two
    steps of ``make_train_step(donate=True)`` and of the undonated step
    from the same parameters and Adam state: parameters and moments
    bit-equal."""
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import specs as SP
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.utils.tree import _leaves, _map
    cfg = get_config(arch) if full else get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, BF16_TRAIN_CUT))
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if full else (2, 64)
    prev = flags.get()
    flags.parse_opts(TRAIN_OPTS)
    try:
        torch.cuda.empty_cache()
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(TokenPipeline(cfg.vocab, B, S,
                                                seed=0)).items()}
        params = M.init_lm(cfg, 0, SP.PARAM_DTYPE, device=device)
        d, ok = _bf16_grad_distances(cfg, params, batch)
        step_d, opt = make_train_step(cfg, lr=TRAIN_LR, remat=True,
                                      donate=True)
        step_u, _ = make_train_step(cfg, lr=TRAIN_LR, remat=True)
        pd, od = _map(torch.clone, params), opt.init(params)
        pu, ou = params, opt.init(params)
        for _ in range(2):
            step_d(pd, od, batch)
            pu, ou, _ = step_u(pu, ou, batch)
        equal = all(torch.equal(a, b) for a, b in
                    zip(_leaves((pd, od)), _leaves((pu, ou))))
        print(f"[{tag}] 23a' {arch} ({cfg.n_layers} layers, bf16) gradient "
              f"distance from the f32 step of the same weights (the "
              f"kernel step's at most {BF16_E2E_FACTOR}x the plain "
              f"step's): {json.dumps(d)}; two donated steps bit-equal to "
              f"two undonated ones (parameters, m, v, t): {equal}")
        del pd, od, pu, ou, params
        torch.cuda.empty_cache()
    finally:
        flags.set_flags(**dataclasses.asdict(prev))
    if not ok or not equal:
        raise AssertionError(f"23a': kernel step {d['kernel']} against "
                             f"plain {d['plain']} (factor "
                             f"{BF16_E2E_FACTOR}); donated bit-equal "
                             f"{equal}")
    return d


def train_rwkv_bf16(tag, arch="rwkv6-1.6b", device="cuda", full=True):
    """Phase 23b: rwkv6-1.6b at full width and depth in bf16 (Adam's
    moments f32; 17.8 GB of state), phase 13's batch and flags. The model
    widens r, k, v and w to f32 before the scan, as the reference does,
    so the wkv kernels run their f32 entries. With the plain versions at S
    = RWKV_PARITY_SEQ (the recurrence is a Python loop over T): at
    RWKV_PARITY_LAYERS the gradients held by their distance from the f32
    step of the same weights (``_bf16_grad_distances``, as 23a'; per
    tensor, bf16's roundings put two f32-equivalent evaluations 0.1-0.2
    of a tensor's largest entry apart at this depth, past phase 13's
    per-tensor gates), and at full depth the loss (forward only): the
    kernel path's at most BF16_E2E_FACTOR times as far from the f32
    plain loss of the same weights as the plain path's; then
    the main path, counted from zero: BF16_TRAIN_STEPS donated steps, L
    forward-and-recompute pairs and L backward wkv launches each, held to
    the reference driver's loss check; ms per step, tokens/s, peak.
    Returns (forward, backward launches of the main path, the record)."""
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import specs as SP
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.utils.tree import _map
    cfg = get_config(arch) if full else get_config(arch).reduced()
    L = cfg.n_layers
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if full else (2, 64)
    seq = RWKV_PARITY_SEQ if full else S
    prev = flags.get()
    flags.parse_opts(TRAIN_OPTS)
    try:
        torch.cuda.empty_cache()
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(TokenPipeline(cfg.vocab, B, S,
                                                seed=0)).items()}
        pb = {k: v[:, :seq] for k, v in batch.items()}
        cut = dataclasses.replace(cfg, n_layers=min(L, RWKV_PARITY_LAYERS))
        d, ok = _bf16_grad_distances(cut, M.init_lm(
            cut, 0, SP.PARAM_DTYPE, device=device), pb)
        print(f"[{tag}] 23b {arch} ({cut.n_layers} layers, bf16) gradient "
              f"distance from the f32 step of the same weights at S={seq} "
              f"(the kernel step's at most {BF16_E2E_FACTOR}x the plain "
              f"step's): {json.dumps(d)}")
        if not ok:
            raise AssertionError(f"23b: kernel step {d['kernel']} against "
                                 f"plain {d['plain']}")
        torch.cuda.empty_cache()
        params = M.init_lm(cfg, 0, SP.PARAM_DTYPE, device=device)
        with torch.no_grad():
            lk, lp = (M.lm_loss(cfg, params, pb, plain_kernels=plain)[0]
                      .item() for plain in (False, True))
            l32 = M.lm_loss(cfg, _map(lambda t: t.float(), params), pb,
                            plain_kernels=True)[0].item()
        loss = {"kernel": lk, "plain": lp, "f32": l32,
                "kernel_from_f32": abs(lk - l32), "plain_from_f32":
                abs(lp - l32)}
        print(f"[{tag}] 23b {arch} ({L} layers, bf16) loss at S={seq}, "
              f"kernel and plain paths against the f32 plain path of the "
              f"same weights (the kernel's distance at most "
              f"{BF16_E2E_FACTOR}x the plain's): {json.dumps(loss)}")
        if not (math.isfinite(lk) and loss["kernel_from_f32"]
                <= BF16_E2E_FACTOR * loss["plain_from_f32"]):
            raise AssertionError(f"23b: full-depth loss {loss}")
        step, opt = make_train_step(cfg, lr=TRAIN_LR, remat=True,
                                    donate=True)
        opt_state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, times = [], []
        for _ in range(BF16_TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, _, m = step(params, opt_state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
            losses.append(m["loss"].item())
        main = counts()
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(main, 0)
        want["wkv"] = 2 * L * BF16_TRAIN_STEPS
        want["wkv_bwd"] = L * BF16_TRAIN_STEPS
        head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
        ms = float(np.median(times[1:]))
        record = {"ms_per_step": ms, "ms_per_step_runs": times,
                  "tokens_per_s": B * S / (ms / 1e3),
                  "peak_memory_bytes": peak, "losses": losses,
                  "loss_5_step_means": [head, tail],
                  "launches": {k: v for k, v in main.items() if v}}
        print(f"[{tag}] 23b {arch} train steps ({L} layers, bf16, donated) "
              f"B={B} S={S} remat {TRAIN_OPTS}: {json.dumps(record)}")
        if main != want or not tail < head or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"23b: launches {main} (expected {want}), "
                                 f"5-step means {head} -> {tail}")
    finally:
        flags.set_flags(**dataclasses.asdict(prev))
    del params, opt_state
    torch.cuda.empty_cache()
    return main["wkv"], main["wkv_bwd"], record


class PhaseClock:
    """Prints each phase's elapsed seconds and the running total."""

    def __init__(self, tag):
        self.tag = tag
        self.t0 = self.last = time.perf_counter()

    def __call__(self, phase):
        now = time.perf_counter()
        print(f"[{self.tag}] phase {phase}: {now - self.last:.1f} s "
              f"(total {now - self.t0:.1f} s)", flush=True)
        self.last = now


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.surf_paper import PAPER
    from repro_torch.serve import BucketSpec
    from repro_torch.utils.device import resolve_device

    # 1. environment
    resolve_device()
    tag = card()
    clock = PhaseClock(tag)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); card "
          f"{tag}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; bf16 reduced-precision "
          "reductions "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 must be off")

    # 2. build, all five libraries at once
    build_all(tag)
    clock("1-2")

    # 3. kernel vs plain, at every shape the serve and training runs launch
    spec = BucketSpec()
    buckets, paper = paper_shapes(PAPER, spec)
    max_err, timing = check_kernel(tag, paper)

    # 4. backward vs plain, at the reference's VJP shapes and the PAPER
    #    training shape (one cohort, unbatched)
    train_shape = (PAPER.n_agents, PAPER.head_dim, PAPER.filter_taps)
    bwd_err, bwd_timing = check_backward(tag, train_shape)

    # 3/4 additions: the S of the sparse, quickstart and seed-batched paths
    slice_err = check_slice_shapes(tag)
    max_err, bwd_err = max(max_err, slice_err[0]), max(bwd_err, slice_err[1])
    clock("3-4")

    # 5.-6. flash attention and wkv vs plain, up to the full-width shapes
    fa_err, fa_timing, fa16_err, fa16_timing = check_flash(tag)
    wh_err, _, wh16_err = check_flash_whisper(tag)
    fa_err, fa16_err = max(fa_err, wh_err), max(fa16_err, wh16_err)
    wkv_err, wkv_timing = check_wkv(tag)
    clock("5-6")

    # 5b.-6b. the backward kernels vs autograd through the plain versions,
    #     f32, then the bf16 entries (and wkv's final-state gradient)
    fab_err, fab_timing = check_flash_bwd(tag)
    fab_err = max(fab_err, check_flash_bwd_whisper(tag)[0])
    flash_delta_check(tag)
    wkvb_err, wkvb_timing = check_wkv_bwd(tag)
    fab16_err, fab16_use, fab16_timing, _ = check_flash_bwd_bf16(tag)
    wkvb16_err, wkvb16_use, wkvb16_timing = check_wkv_bwd_bf16(tag)
    clock("5b-6b")

    # 7. serve, with the default mixer
    zero_counts()
    serve_launches, fixed = serve(tag, PAPER, spec, buckets)
    clock("7")

    # 7b. serve federations past the kernel's resident limit
    zero_counts()
    large_launches = serve_large(tag)

    # 7c.-7d. the same 24 requests through adaptive servers and through
    #    the async driver
    zero_counts()
    adaptive_launches = serve_adaptive(tag, PAPER, spec, fixed)
    zero_counts()
    async_launches = serve_async(tag, PAPER, spec, fixed)

    # 7f. the same requests through request-sharded servers on simulated
    #     shards of the card, then surf_serve's sharded rows
    zero_counts()
    sharded_launches = serve_sharded(tag, PAPER, spec, fixed)
    del fixed

    # 7e. the SURF launchers at their defaults
    zero_counts()
    launch_fwd, launch_bwd = launchers(tag)
    clock("7b-7f")

    # 8.-9. meta-step parity and the training run at PAPER width
    mds, pool = paper_pool(PAPER)
    # phase 8's kernel trajectory waits for 9f on the host, so the peak
    # memory of phases 9-9e is that of their own paths
    phase8 = _on_host(meta_step_parity(tag, PAPER, pool))
    zero_counts()
    static, train_fwd, train_bwd = train_paper(tag, PAPER, mds, pool)
    if counts()["flash_attention"] or counts()["wkv"]:
        raise AssertionError(f"SURF paths launched an LLM kernel {counts()}")
    clock("8-9")

    # 9b. scheduled training at PAPER width (counts zeroed inside, just
    #     before train_surf)
    sched_fwd, sched_bwd, _ = scheduled_training(
        tag, PAPER, mds, pool, static["ms_per_meta_step"])
    if counts()["flash_attention"] or counts()["wkv"]:
        raise AssertionError(f"9b launched an LLM kernel {counts()}")

    # 9e. seed-batched PAPER training with in-loop snapshots (counts
    #     zeroed inside, just before train_surf)
    seeds_rec = seeds_paper(tag, PAPER, mds, pool,
                            static["ms_per_meta_step"])

    # 9f. RSDUN at PAPER width
    (rob_fwd, rob_bwd), _ = robust_paper(tag, PAPER, mds, pool, phase8)
    del phase8

    # 9i.-9k. the multi-device paths on shards simulated on the card:
    #     agent-sharded training (halo, halo-pallas, ring), scheduled and
    #     seed-batched halo, Q-sharded pools
    halo_fwd, halo_bwd, _, res_err = halo_training(
        tag, PAPER, mds, pool, static["ms_per_meta_step"])
    max_err, bwd_err = max(max_err, res_err[0]), max(bwd_err, res_err[1])
    halo_schedules_seeds(tag, PAPER, mds, pool)
    qsh_fwd, qsh_bwd, _ = qsharded_pools(tag, PAPER, mds)
    if counts()["flash_attention"] or counts()["wkv"]:
        raise AssertionError(f"9i-9k launched an LLM kernel {counts()}")
    del pool, mds
    clock("9b-9k")

    # 9c. the async study at PAPER width (counts zeroed per n_async)
    async_eval_launches, _ = async_eval(tag, PAPER)

    # 9d. the FL baselines at PAPER width, card against CPU
    baselines_phase(tag)

    # 9g.-9h. checkpoint and resume; the sparse-recovery task
    ckpt_fwd, ckpt_bwd = checkpoint_resume(tag)
    sparse_fwd, sparse_bwd = sparse_phase(tag)

    # 10. the quickstart's bar; 10b. with 4 seeds and snapshots
    quickstart(tag)
    qs_fwd, qs_bwd = quickstart_seeds(tag)
    if counts()["flash_attention"] or counts()["wkv"]:
        raise AssertionError(f"9e-10b launched an LLM kernel {counts()}")
    clock("9c-10b")

    # 11.-12. the LLM serving path at full width
    fa_launches, _ = serve_llm(tag, "qwen3-4b", "flash_attention")
    wkv_launches, _ = serve_llm(tag, "rwkv6-1.6b", "wkv")
    clock("11-12")

    # 13. LM training at full width (counts zeroed inside, just before each
    #     main-path step); 13b. the training driver with a checkpoint
    trained = {arch: train_llm(tag, arch, n_layers)
               for arch, n_layers in TRAIN_LLMS}
    drv_fwd, drv_bwd = train_driver(tag)
    fa_train_fwd, fa_train_bwd, _ = trained["qwen3-4b"]
    wkv_train_fwd, wkv_train_bwd, _ = trained["rwkv6-1.6b"]
    clock("13-13b")

    # 14. MoE and hybrid serving at full width (depth cut to fit 80 GB)
    moe_serve = {arch: serve_llm(tag, arch, "flash_attention",
                                 n_layers=n_layers)[0]
                 for arch, n_layers in SERVE_MOE}
    # 15. MoE training at full width (counts zeroed inside)
    moe_fwd, moe_bwd, _ = train_llm(tag, *TRAIN_MOE, phase="15")
    clock("14-15")
    # 16. fig. 7's ablation, timed; 17. the port's examples
    fig7_fwd, fig7_bwd = fig7_ablation(tag)
    clock("16")
    ex = examples_phase(tag)
    clock("17")

    # 18. whisper-small serving at full width and depth; 19. its training
    #     step (counts zeroed inside, just before the main-path step);
    #     19b. the training driver on it
    wh_serve, _ = serve_whisper(tag)
    wh_fwd, wh_bwd, _ = train_llm(tag, WHISPER, phase="19")
    whd_fwd, whd_bwd = whisper_driver(tag)
    clock("18-19b")

    # 20. the dense archs that need more than one card in full, served at
    #     full width (depth cut to 4 layers)
    dense_serve = {arch: serve_llm(tag, arch, "flash_attention",
                                   n_layers=n_layers)[0]
                   for arch, n_layers in SERVE_DENSE}
    clock("20")

    # 21. the dry run: the grid on the production meshes (meta device),
    #     then its descriptions held against the card where a step fits
    dryrun_grid(tag)
    dry_fwd, dry_bwd = dryrun_card_checks(tag)
    clock("21")

    # 22. gemma3-27b at full width: one period in f32 (22a), a 6-layer
    #     cut in bf16 against f32 (22b'), the whole model in bf16 (22b),
    #     the windowed backward (22c; counts zeroed inside, just before
    #     each main path)
    gemma_serve = serve_gemma(tag)
    bf16_cut(tag)
    gemma_bf16 = serve_bf16(tag)
    gemma_fwd, gemma_bwd = train_gemma(tag)
    clock("22")

    # 23. LM training in bf16 with the donated step: qwen3-4b at full
    #     depth (23a; counts zeroed inside, just before the main path), cut
    #     to 4 layers against f32 and the undonated step (23a'), rwkv6-1.6b
    #     at full depth (23b)
    b16_fwd, b16_bwd, _ = train_bf16(tag)
    bf16_train_cut(tag)
    rwkv16_fwd, rwkv16_bwd, _ = train_rwkv_bf16(tag)
    clock("23")

    # The graph filter's forward record's times are those of the largest
    # bucket's tick layer; its launches those of the serve runs (7-7d,
    # 7f), the launchers (7e), the training runs (9, 9b, 9e-9h, 9i's
    # halo-pallas train_surf, 9k, 10b, 16), the async studies (9c, 9k),
    # the examples (17) and the DRYRUN meta-step (21), and dW's those of
    # the launchers, the training runs, the examples and 21. Flash
    # attention's and wkv's times are
    # those of the qwen3-4b and rwkv6-1.6b prefill shapes in f32, their
    # launches those of the serve runs (one prefill each; 11-12, 14, 18,
    # 20, 22a),
    # the training steps (13, 15, 19, 22c, 23b), the drivers (13b,
    # 19b) and the examples (17); the bf16 flash forward's (the wgmma
    # kernel) its times at the qwen3-4b shape in bf16 and the launches of
    # the bf16 main paths, 22b's prefill and 23a's steps (wkv's launches
    # also count 23b's); their backward kernels' times are those
    # of the same shapes in f32, their launches those of 13, 13b, 15, 17,
    # 19, 19b, 22c and 23b (wkv: rwkv6 widens r, k, v, w to f32 before the
    # scan, as the reference does, so its bf16 training runs the f32
    # entries). The bf16 flash backward's record holds its times at the
    # qwen3-4b shape and 23a's launches; the bf16 wkv backward entry is on
    # no main path (its times are printed by 6b).
    src = "src/repro_torch/kernels/graph_filter/csrc/graph_filter.cu"
    ms, plain_ms, bound_ms, bound_by = timing[paper[0]]
    b_ms, b_plain_ms, b_bound_ms, b_bound_by = bwd_timing
    f_ms, f_plain_ms, f_bound_ms, f_bound_by, f_lib_ms = fa_timing
    f16_ms, f16_plain_ms, f16_bound_ms, f16_bound_by, f16_lib_ms = fa16_timing
    w_ms, w_plain_ms, w_bound_ms, w_bound_by = wkv_timing
    fb_ms, fb_plain_ms, fb_bound_ms, fb_bound_by, fb_lib_ms = fab_timing
    fb16 = fab16_timing
    wb_ms, wb_plain_ms, wb_bound_ms, wb_bound_by = wkvb_timing
    print(f"launches: serve run forward {serve_launches}; serve past the "
          f"resident limit forward {large_launches}; adaptive serve "
          f"forward {adaptive_launches}; async driver forward "
          f"{async_launches}; sharded serve (7f) forward "
          f"{sharded_launches}; launchers forward {launch_fwd}, backward "
          f"{launch_bwd}; training run "
          f"forward {train_fwd}, backward {train_bwd}; scheduled training "
          f"run forward {sched_fwd}, backward {sched_bwd}; async study "
          f"forward {async_eval_launches}; baselines none; seed-batched "
          f"training forward {seeds_rec['launches_forward']}, backward "
          f"{seeds_rec['launches_backward']}; robust training forward "
          f"{rob_fwd}, backward {rob_bwd}; checkpoint and resume forward "
          f"{ckpt_fwd}, backward {ckpt_bwd}; halo-pallas training (9i) "
          f"forward {halo_fwd}, backward {halo_bwd}; Q-sharded pools (9k) "
          f"forward {qsh_fwd}, backward {qsh_bwd}; sparse recovery forward "
          f"{sparse_fwd}, backward {sparse_bwd}; quickstart with seeds "
          f"forward {qs_fwd}, backward {qs_bwd}; qwen3-4b serve "
          f"flash_attention {fa_launches}; rwkv6-1.6b serve wkv "
          f"{wkv_launches}; qwen3-4b training step (13) flash_attention "
          f"{fa_train_fwd}, backward {fa_train_bwd}; rwkv6-1.6b training "
          f"step (13) wkv {wkv_train_fwd}, backward {wkv_train_bwd}; "
          f"training driver (13b) wkv {drv_fwd}, backward {drv_bwd}; "
          f"MoE and hybrid serve (14) flash_attention "
          f"{json.dumps(moe_serve)}; deepseek-moe-16b training step (15) "
          f"flash_attention {moe_fwd}, backward {moe_bwd}; fig. 7 (16) "
          f"forward {fig7_fwd}, backward {fig7_bwd}; examples (17) "
          f"{json.dumps({k: v for k, v in ex.items() if v})}; whisper-small "
          f"serve (18) flash_attention {wh_serve}; whisper-small training "
          f"step (19) flash_attention {wh_fwd}, backward {wh_bwd}; "
          f"whisper-small training driver (19b) flash_attention {whd_fwd}, "
          f"backward {whd_bwd}; dense multi-card archs serve (20) "
          f"flash_attention {json.dumps(dense_serve)}; DRYRUN meta-step "
          f"(21) forward {dry_fwd}, backward {dry_bwd}; gemma3-27b serve "
          f"f32 (22a) flash_attention {gemma_serve}; gemma3-27b serve bf16 "
          f"(22b) flash_attention {gemma_bf16}; gemma3-27b loss and "
          f"gradients (22c) flash_attention {gemma_fwd}, backward "
          f"{gemma_bwd}; qwen3-4b bf16 training (23a) flash_attention "
          f"{b16_fwd}, backward (bf16 entry) {b16_bwd}; rwkv6-1.6b bf16 "
          f"training (23b) wkv {rwkv16_fwd}, backward {rwkv16_bwd}; bf16 "
          f"backward entries against their bounds: flash "
          f"{fab16_use:.3f}, wkv {wkvb16_use:.3f} (wkv bf16 entry at the "
          f"rwkv6-1.6b shape {wkvb16_timing[0] * 1e3:.1f} us, bound "
          f"{wkvb16_timing[2] * 1e3:.1f} us, plain "
          f"{wkvb16_timing[1] * 1e3:.1f} us; max |err| {wkvb16_err:.3e})")
    print(tag)
    print(json.dumps({"kernels": [
        {"name": "graph_filter", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/graph_filter/kernel.py:27",
         "launches": (serve_launches + large_launches + adaptive_launches
                      + async_launches + launch_fwd + train_fwd
                      + sched_fwd + async_eval_launches
                      + seeds_rec["launches_forward"] + rob_fwd + ckpt_fwd
                      + sparse_fwd + qs_fwd + sharded_launches + halo_fwd
                      + qsh_fwd + fig7_fwd + ex["graph_filter"] + dry_fwd),
         "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "graph_filter_bwd", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/graph_filter/ops.py:114",
         "launches": (train_bwd + launch_bwd + sched_bwd
                      + seeds_rec["launches_backward"] + rob_bwd + ckpt_bwd
                      + sparse_bwd + qs_bwd + halo_bwd + qsh_bwd + fig7_bwd
                      + ex["graph_filter_bwd"] + dry_bwd),
         "max_abs_err": bwd_err,
         "ms": b_ms,
         "plain_ms": b_plain_ms, "bound_ms": b_bound_ms,
         "bound_by": b_bound_by, "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
         "launches": (fa_launches + fa_train_fwd + sum(moe_serve.values())
                      + moe_fwd + ex["flash_attention"] + wh_serve + wh_fwd
                      + whd_fwd + sum(dense_serve.values()) + gemma_serve
                      + gemma_fwd),
         "max_abs_err": fa_err,
         "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": f_bound_ms,
         "bound_by": f_bound_by, "library_ms": f_lib_ms},
        {"name": "flash_attention_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
         "launches": gemma_bf16 + b16_fwd, "max_abs_err": fa16_err,
         "ms": f16_ms, "plain_ms": f16_plain_ms, "bound_ms": f16_bound_ms,
         "bound_by": f16_bound_by, "library_ms": f16_lib_ms},
        {"name": "wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/ssm_scan/csrc/wkv.cu",
         "replaces": "src/repro/kernels/ssm_scan/kernel.py:24",
         "launches": (wkv_launches + wkv_train_fwd + drv_fwd + ex["wkv"]
                      + rwkv16_fwd),
         "max_abs_err": wkv_err, "ms": w_ms,
         "plain_ms": w_plain_ms, "bound_ms": w_bound_ms,
         "bound_by": w_bound_by, "library_ms": None},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:56",
         "launches": (fa_train_bwd + moe_bwd + ex["flash_attention_bwd"]
                      + wh_bwd + whd_bwd + gemma_bwd),
         "max_abs_err": fab_err, "ms": fb_ms,
         "plain_ms": fb_plain_ms, "bound_ms": fb_bound_ms,
         "bound_by": fb_bound_by, "library_ms": fb_lib_ms},
        {"name": "flash_attention_bwd_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:56",
         "launches": b16_bwd, "max_abs_err": fab16_err, "ms": fb16[0],
         "plain_ms": fb16[1], "bound_ms": fb16[2], "bound_by": fb16[3],
         "library_ms": fb16[4]},
        {"name": "wkv_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/ssm_scan/csrc/wkv_bwd.cu",
         "replaces": "src/repro/models/ssm.py:42",
         "launches": wkv_train_bwd + drv_bwd + rwkv16_bwd,
         "max_abs_err": wkvb_err,
         "ms": wb_ms, "plain_ms": wb_plain_ms, "bound_ms": wb_bound_ms,
         "bound_by": wb_bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
