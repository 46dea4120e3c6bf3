#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any phase that fails
raises, and the script exits non-zero without printing a result:

1. ``device``      the card (``nvidia-smi`` name and power limit), CUDA and nvcc.
2. ``build``       build the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. ``kernels``     each kernel against its plain PyTorch version on the card,
                   float32 and float64, at the shapes of phases 4 and 5
                   (``torch.testing.assert_close`` at rtol = atol = 1e-5 in
                   float32, 1e-12 in float64: fma contraction and summation
                   order only), with its median time, the plain version's and
                   its bound.  ``fused_step`` and ``fused_step_poly`` go
                   through every option (controller modes, tolerance shapes,
                   coefficients, ``failed``): every output is held to the
                   plain version, the error ratio to the same tolerance plus
                   its rounding floor (``repro_torch.tools.step_checks``),
                   and every output must be bitwise equal to the unfused
                   card path; each kernel's two bodies (a warp per row, a
                   block per row) bitwise equal to each other, with both
                   times beside the chosen one's (``ms_by_body``), and
                   ``fused_step``'s launches by body; each body also with
                   the optional outputs the autograd Functions ask for
                   (``errs=``; ``stages=``, ``stage_args=``): the outputs
                   bitwise those without them, the error estimate bitwise
                   ``fused_update``'s, the stages bitwise ``ref.poly_stages``
                   on the unfused card path, their arguments bitwise
                   ``stage_accum``'s.  ``stage_accum`` at
                   every stage count j = 1..7, in 16-byte chunks and entry
                   by entry (odd f, K off a 16-byte boundary);
                   ``fused_update`` timed at each stage count of the repo's
                   tableaus (s = 1, 2, 3, 4, 7), each its own bound, and
                   held at ``dense_checks.UPDATE_SHAPES`` with every
                   tableau's weights and s = 1..8, chunked and entry by
                   entry (y or K off a 16-byte boundary), and the empty
                   batch.
                   The event kernels (``masked_bisect_refine``,
                   ``fused_event_detect``, ``fused_event_commit``) at E = 2
                   over their cases (``repro_torch.tools.event_checks``) are
                   held bitwise to their plain versions, as is
                   ``interp_eval`` (its window too).  ``error_norm`` (each
                   tolerance shape its own row and bound) and
                   ``interp_eval`` are timed by body (``ms_by_body``).  The chord-Newton kernels
                   (``batched_lu_factor``, ``batched_linsolve``,
                   ``fused_newton_iter``, ``masked_newton_update``) at the
                   stiff workloads' shapes over their cases
                   (``repro_torch.tools.newton_checks``) are held to their
                   plain versions at 1e-5 / 1e-12 (the LU relative to the
                   matrix's largest entry, the permutation exactly), and the
                   card's unfused Newton iteration bitwise to its fused one.
4. ``vdp_table3``  the paper's Table 3 setup (b = 256 Van der Pol, mu = 2,
                   dopri5 then tsit5, tol 1e-5, 200 eval points, float32):
                   solved on the card and on the CPU, with exact kernel
                   launch counts.
5. ``full_width``  a neural-ODE solve at b = 1024, f = 784 (a flattened 28x28
                   image, as in continuous normalising flows on MNIST), hidden
                   width 1024, with the per-instance independence check.
6. ``fused``       ``fused=True`` (the ``fused_step`` and ``fused_step_poly``
                   kernels): vdp_table3 (float64 held to the unfused card
                   run, float32 to the CPU's fused run), full_width against
                   its unfused run, the JAX package's own fused workload
                   (``benchmarks/step_bench.py``: dy/dt = -y by
                   ``polynomial_term``) at b = 1024, f = 784 against the
                   closed form and the unfused run, every launch on the row
                   body of ``fused_step_poly`` (its ``body_launches``
                   printed; so ``fused_step``'s at full_width and
                   full_width_long, and every fused solve's on the body
                   ``fused_step_body`` picks), and full_width_long (the
                   same network with a real step count) unfused and fused:
                   ms per step, loop iterations, exact launch counts.
7. ``compiled``    the compiled front end (``core/compiled.py``,
                   ``core/graphs.py``): vdp_table3 and full_width_long (the
                   full_width network and shapes with a real step count),
                   unfused and fused, each through one ``CompiledSolver``
                   (k = 16) whose first call captures the loop as CUDA
                   graphs and whose next two replay them, every one held to
                   the eager card solve (equal step counts and status, ys
                   bitwise or within 1e-6 relative with the reason printed);
                   exact kernel launches during the capture (the warm-up
                   step and each captured block's steps) and none during a
                   replay; a second rtol through the same entry (no new
                   capture, the eager results at that rtol); a solve whose
                   buffer loads and replays run under
                   ``torch.cuda.set_sync_debug_mode("error")`` (the flag
                   reads between blocks excepted; that no step reads the
                   device is shown by the capture itself, which fails on a
                   sync); captures, replays and host reads per solve, nodes
                   per graph, the static buffers' and graph pool's bytes,
                   and ms per step eager against
                   captured at k = 1, 16 and 64; then ``sharded_solve`` over
                   two streams of the card on a ragged batch (b = 1023)
                   against the unsharded entry.
8. ``events``      the event workloads (``tools/workloads.py``), unfused and
                   fused: ``ball_terminal`` (every impact within 10 rtol of
                   sqrt(2 h0 / g)), ``vdp_marker`` (zero extra vector-field
                   evaluations; ms per step with and without the marker) and
                   ``full_width_long_events`` (25-75 % of rows stop at the
                   RMS threshold); exact launch counts, fused solves bitwise
                   equal to unfused ones, float64 card solves against the
                   CPU's.
9. ``stiff``       the stiff workloads (``DiagonallyImplicitRK``, kvaerno5):
                   ``vdp_stiff_mixed``, ``robertson_sweep`` and
                   ``allen_cahn_full`` (b = 1024), unfused and fused: every
                   row SUCCESS, exact launch counts of the four Newton
                   kernels (> 0 on their path, 0 on the other), every
                   ``fused_step`` launch on the body ``fused_step_body``
                   picks, fused equal
                   to unfused bitwise, rows 0-31 solved alone equal to the
                   same rows of the batch bitwise (all but ``n_f_evals``),
                   float64 card solves of rows 0-7 against the CPU's.
10. ``lm``         the LM serving path (``repro_torch.models``,
                   ``launch/serve``): reduced qwen2.5-14b and stablelm-3b in
                   float32 on the card against the CPU (prefill, four decode
                   steps, prefill/decode consistency, within 1e-4); then
                   full-width qwen2.5-14b in bf16 (48 layers, d = 5120, GQA
                   40/8, weights drawn on the card from seed 0) served at
                   batch 4, prompt 2048, 32 generated tokens: prefill ms,
                   decode ms per token, tokens/s, peak memory, exactly 48
                   ``flash_attention_fwd`` launches (one per layer per
                   prefill, none per decode step), finite logits, and
                   prefill(s) + decode_step against prefill(s + 1) and the
                   kernel's prefill against the plain attention's, each
                   within 0.1 of the logits' RMS.
11. ``lm_kinds``   the block kinds beyond the dense decoder
                   (``models/{moe,ssm,xlstm,frontends}.py``): the reduced
                   deepseek-moe-16b, kimi-k2, jamba, xlstm-350m,
                   whisper-large-v3 and llava-next-34b in float32 on the
                   card against the CPU (the same weights and frontend
                   embeddings; prefill, four decode steps, prefill/decode
                   consistency, within 1e-4; one flash launch per attention
                   layer per prefill, the encoder's and the cross
                   attention's included, none per decode step); then at
                   full width in bf16, weights drawn on the card from seed
                   0, each served once through ``serve.run`` (32 tokens):
                   deepseek-moe-16b (28 layers, 4 x 2048), one period of
                   jamba (8 of 32 layers, 2 x 2048), xlstm-350m (24 layers,
                   4 x 2048), whisper-large-v3 (32 + 32 layers, 4 x 1500
                   audio frames and tokens) and llava-next-34b (4 of 60
                   layers, 4 x 2048, the first 576 positions image
                   embeddings): params, init seconds, prefill ms, decode ms
                   per token, tokens/s, peak memory above start, exact
                   flash launches (28, 1, 0, 96, 4) all on the wgmma body,
                   finite logits, prefill(s) + decode against prefill(s + 1)
                   (xlstm: 256 decode steps, its mLSTM chunk; MoE layers at
                   capacity_factor = E / k, so that prefill drops nothing)
                   and the kernel's prefill against the plain attention's,
                   within 0.1 of the logits' RMS; the share of dropped
                   (token, expert) assignments per MoE layer at the served
                   config, sLSTM's seconds and share of the xlstm prefill.
12. ``train_lm``   the LM training path (``launch/train``, ``train/steps``,
                   ``optim``, ``checkpoint``, ``models/node.py``), after the
                   lm phase's model is freed: the CUDA attention backward
                   (``flash_attention_bwd``) against its plain version by
                   ``tools/attn_checks.hold`` over its cases and at the two
                   training layers (stablelm-3b's b = 2, s = 2048, 32 heads
                   of 80; and 40 / 8 heads of 128), float32 within 1e-4 of
                   the largest entry, bf16 within 2x the plain bf16
                   version's error against a float64 oracle, the forward's
                   ``lse`` within 1e-5 of the plain forward's and its output
                   bitwise the same with ``lse``; at the two layers two
                   bf16 calls bitwise equal (no atomics), each body it
                   takes (bf16: wgmma and FFMA) timed, with its three
                   kernels apart (torch.profiler), the bound and SDPA's
                   backward.
                   Path (a): full-width stablelm-3b (bf16, 2.67e9
                   parameters, weights drawn on the card) through
                   ``train.run``, three AdamW steps at batch 2 x seq 2048
                   without remat, with remat and with 8-bit moments: losses
                   (the first within 0.5 of ln 50304 + 1/2, the cross
                   entropy of the untrained model's unit-variance logits),
                   the first step's batch again after the third (its loss
                   must have fallen), ms per step by phase, peak memory,
                   exactly one backward launch per layer per step, every
                   one on the wgmma body.  Path (b): ``--ode-depth`` on the
                   same config (one block; two ODE instances of 5 242 880
                   float32 entries, bosh3, 8 steps): ode_steps, losses (the
                   first batch's fallen likewise), ms per step, peak
                   memory, the solver kernels' launches, ``error_norm``'s
                   by body (every one on the wide body) and each body's ms
                   at that width.  Then a checkpoint after step 2 restored
                   into a fresh state: steps 3-4 bitwise the uninterrupted
                   run's (reduced stablelm-3b on the card).
12a. ``examples`` the reference's examples through ``repro_torch.examples``
                   on the card: quickstart and bouncing_ball whole in float32
                   (their own asserts), and their solves from float64 states;
                   cnf_density (3 iterations at 512 points, the joint
                   adjoint) and latent_ode (5 iterations, then 2 through
                   ``SolveService``'s gradient requests, the served gradients
                   bitwise the solo solve's) in float64; train_lm three
                   AdamW steps of the example's reduced qwen2.5-14b and of
                   the reduced deepseek-moe-16b, kimi-k2, jamba, xlstm-350m,
                   whisper-large-v3 and llava-next-34b (the backward of the
                   MoE dispatch, the Mamba scan, mLSTM's chunks, sLSTM's
                   token loop, the encoder-decoder and the image positions)
                   and continuous_depth_lm three steps, float32, each from a
                   state drawn on the CPU.  Each is held to the same run on
                   the CPU, made by a process of its own started before the
                   lm phase on half of the host's cores, the main process
                   kept on the other half until the process ends
                   (``cpu_side``): float64 equal counts and within
                   1e-9; the LM runs' first step every metric (loss, cross
                   entropy, MoE balance loss, grad norm) within 1e-5
                   relative (continuous depth 1e-4), steps 2-3 the losses
                   within 1e-4 and the grad norm within 1e-3 (AdamW's
                   near-eps entries, ROADMAP C), one attention launch for
                   each call of the plain attention on the CPU.  Each
                   example's wall seconds and launches by kernel.
12b. ``dryrun``   ``launch/dryrun.py`` (counted by the same process on fake
                   tensors on a mesh of one): the reduced stablelm-3b
                   prefill's FLOPs in the reference's attention convention
                   equal to the reference's HLO count, and a Shard(1)
                   matmul and its backward on a fake 2 x 2 group equal to
                   its count by hand (the counter's patches of DTensor's
                   private names on this torch) (``tools/cost_checks.py``);
                   the stablelm-3b AdamW step at
                   2 x 2048 and the qwen2.5-14b prefill at 4 x 2048: counted
                   GFLOPs, HBM GB, model GFLOPs, the roofline terms, the ms
                   the train_lm and lm phases measured, the model-FLOP and
                   counted-FLOP utilisation against 989 TFLOP/s, and the
                   counter's peak beside the measured peak.
13. ``grad``       gradients on the card (``kernels/autograd.py``,
                   ``ScanAdjoint``, ``BacksolveAdjoint``): each of the four
                   Functions' backwards against ``torch.autograd.grad`` of
                   the plain op on the card, on the same inputs
                   (``tools/grad_checks.py``: vdp_table3's and full_width's
                   shapes, float32 at 1e-5 and float64 at 1e-12, the window
                   included), with each backward's time at full_width
                   float32 beside the plain op's; the reduced float64 twin
                   of ``full_width_train``, card against CPU (ScanAdjoint
                   with and without checkpointing, BacksolveAdjoint joint
                   and per_instance: equal step counts, gradients within
                   1e-9), and once more with the four plain ops made to
                   raise; ``full_width_train`` in float32 through
                   ``ScanAdjoint(max_steps=64, checkpoint_every=16)``, three
                   SGD steps: the loss falls, every loss and gradient is
                   finite, exactly 2 x 64 launches of each kernel (6 x of
                   ``stage_accum``) a training step, recompute included
                   (64 x without checkpointing), ms and peak memory a
                   training step with and without checkpointing, dL/dy0 of
                   rows 0-31 against a CPU run of those rows alone within
                   the float32 gradient's own global error (C-5's rule);
                   ScanAdjoint's forward loop under
                   ``torch.cuda.set_sync_debug_mode("error")``, naming any
                   synchronizing call; BacksolveAdjoint (joint) at
                   full_width(t_end=1.0), its weight gradients within 1e-3
                   (relative norm) of ScanAdjoint's, and the kernels' times
                   on its one augmented row of 3 213 072 entries.  Then the
                   paths through the nine other backwards
                   (``grad_paths``): each of them against
                   ``torch.autograd.grad`` of the plain op on the card
                   (``grad_checks.card_plain``: for the fused steps the
                   plain composition with its inner ops valued as the
                   kernels, so that the forward has the kernel's bits) at
                   vdp_table3's shape, full_width's (the fused and event
                   kernels) and allen_cahn_full's (the Newton kernels), both
                   dtypes, by ``grad_checks.rule``: the event ops entry by
                   entry within 1e-5 / 1e-12, the fused steps and Newton
                   ops each entry within 1e-5 / 1e-12 of (1 + its batch
                   row's largest), each op's entry-by-entry margin beside
                   it; the LU cases with the kernel's permutation equal to
                   LAPACK's, each backward's time at its main shape; the
                   reduced float64 twins of the three paths
                   (``full_width_train`` with ``fused=True`` and with its
                   events, ``allen_cahn_full`` unfused and factor-once) card
                   against CPU with equal step, event and Newton counts,
                   gradients within 1e-9; and at full width:
                   ``full_width_train`` through ``ScanAdjoint(fused=True)``
                   and with full_width_long_events' two events, one SGD
                   step checkpointed (its ms), then one step without
                   checkpointing, exact launches (the no-grad forward's,
                   twice with checkpointing), the fused
                   gradient within 1e-4 of the unfused one's largest entry
                   with equal step counts; the events gradient, and the
                   unfused one without events as the control, against the
                   float64 card solve at the same weights (cosine, relative
                   difference) and the float64 loss 0.01 of the way along
                   the SGD step against its linear prediction;
                   ``allen_cahn_full``'s
                   final-state gradient in y0 and lam (max_steps the eager
                   solve's iterations + 4) unfused and factor-once, two
                   runs each, exact launches, finite, peak memory under
                   16 GB.
14. ``serve_ode``  request serving (``core/serving.py``: ``SolveService``):
                   ``serve_checks.make_stream`` (decay, features 2/3/5,
                   every third request dense) in float64 on the card and on
                   the CPU (equal status and counts, ys within 1e-9); the
                   full-width stream (4096 requests of full_width_long's
                   network, half of them dense, coalesced to b = 1024)
                   served with a window of 4 and blocking, a first pass
                   each and then two timed passes each in turns: async
                   bitwise equal to sync and every pass to its first, kernel launches exactly those of the entries
                   captured (the warm-up step and each captured block's
                   steps) and none for replays, requests/s end to end,
                   pad waste, the queue/pack/device split, captures and
                   host reads per batch, each entry's static buffers and
                   graph pool, peak memory; 16 requests chosen by seed
                   solved alone (b = 1) through ``CompiledSolver``, held to
                   their served rows within the float32 global error (C-5's
                   rule); the first 2048 requests through a fused bucket
                   (``fused_step`` at capture only); a 64-request float64
                   ``GradRequest`` stream (``ScanAdjoint``) on the card
                   against the CPU within 1e-9.
15. ``distributed`` the mesh path (``distributed/``, ``launch/mesh.py``) on
                   one card: an NCCL group of one process (the phase fails
                   if NCCL or the mesh cannot be set up; there is no
                   fallback) and ``make_local_mesh(model=1)``, a (1, 1)
                   ("data", "model") mesh.  The reduced stablelm-3b and
                   deepseek-moe-16b train three AdamW steps under the mesh
                   with ``--fsdp`` (``tools/dist_checks.train_case``) against
                   the same steps without a mesh on the card: loss, cross
                   entropy and grad norm within 1e-5 relative, the
                   parameters within 5e-4, 99.9 % within 1e-6 (whether each
                   is bitwise printed), and the flash forward and backward
                   kernels launched on the local shards (2 of each a step,
                   counted by ``cuda_impl``).  Then deepseek-moe-16b at full
                   width in bf16 (4 of its 28 layers: the time limit), seed
                   0, b = 4, s = 2048, through ``serve.run`` without the
                   group and under the mesh, the MoE at capacity factor
                   E / k (bf16 router flips, ROADMAP C): every prefill takes
                   the expert-parallel ``local_map`` body and 4 flash
                   launches on the wgmma body, the mesh's prefill logits
                   within 0.1 of the logits' RMS of the unsharded ones,
                   and the prefill ms, decode ms a token and peak memory of
                   both runs.  The group is destroyed at the end.

The ``kernels`` phase also holds ``flash_attention_fwd`` to its plain version
(float32 at 2e-5, bfloat16 at 3e-2) over ragged, ``q_offset``, MQA, hd = 80
and bidirectional cases and the lm_kinds heads (20 x 64 with sq != sk, 16 x
128, 64 / 8 x 112) -- the wgmma body for bfloat16 with hd <= 128, the
FFMA body otherwise, each counted -- times it at qwen2.5-14b's layer (with
``scaled_dot_product_attention`` as the library yardstick), holds the
elimination staged in shared memory bitwise to the device-memory one (the
stiff widths, float32 and float64, with the device-memory path's time
beside the staged one's), holds ``fused_newton_iter``'s bodies (the warp
body up to f = 32, the panel substitution, the column loop) bitwise to each
other on every Newton case and times them side by side (``ms_by_body``),
holds ``masked_bisect_refine`` bitwise to its plain version at every row
segment class (f = 1-5, 783-785; aligned and unaligned coefficients),
``fused_event_detect`` at every width of its row segment (E = 1, 2, 31-33,
63, 64; every direction, NaN directions, NaN and +-0 values), and
``fused_event_commit`` at every row class of its layout (f = 1-5, 783-785;
E = 1, 3, 64; rows with no crossing, one, all tied; planes aligned, or y_new
or ev_y one entry off), ``error_norm`` at the widths around its layout
(``dense_checks.ERROR_NORM_WIDTHS``, every tolerance shape, err aligned or
one entry off; every body to the plain version and bitwise to each other,
and the warp and row bodies, patched into the unfused card path, bitwise to
both of ``fused_step``'s bodies' ratio), ``error_norm``'s wide body on its
own rows
(``dense_checks.NORM_WIDE_WIDTHS`` x ``NORM_WIDE_ROWS``, every tolerance
shape, bitwise the warp body's; patched into the unfused card path at f =
4097 and 9001, bitwise ``fused_step``'s ratio) and timed at the ODE-depth
LM's and the joint backsolve's rows, and ``interp_eval`` at the same widths (every
mask kind, out aligned or one entry off, the window with cursors inside and
past either end; both bodies bitwise), holds ``masked_newton_update`` to its plain version
and the unfused Newton iteration bitwise to the fused one at the update's
boundary widths (``newton_checks.UPDATE_WIDTHS``), prints the launch floor
(a one-element PyTorch op under the same timing rule), and holds the
substitution kernels above their old 48 KiB shared-memory limit
(f = 4096 and 8192, float64, 1e-12, equal permutations, both Newton bodies
bitwise equal).  The ``stiff`` and ``lm`` phases check that the main path
took the staged elimination, the Newton body ``newton_iter_body`` picks
(the panel substitution at allen_cahn_full) and the wgmma body; phases
``vdp_table3`` and ``full_width`` that every ``error_norm`` and
``interp_eval`` launch took the body ``error_norm_body`` and
``interp_eval_body`` pick (warp and cell at f = 2, row at f = 784).

Each phase's wall seconds (``{"phase": "timing", "ended": ...}``, the
``grad`` and ``serve_ode`` phases also by part) print as it ends, and all
of them together before the kernel summary line; last,
``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository's ``src/`` beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM (NVIDIA data sheet): HBM3 at 3.35 TB/s; float32 67 TFLOP/s and
# float64 34 TFLOP/s outside the tensor cores, bfloat16 989 TFLOP/s dense on
# them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
REPS = 50
SLEEP_CYCLES = 1_000_000  # ~0.5 ms of device time before each timed launch
SOURCES = {
    "stage_accum": "src/repro_torch/kernels/csrc/solver_kernels.cu",
    "fused_update": "src/repro_torch/kernels/csrc/solver_kernels.cu",
    "error_norm": "src/repro_torch/kernels/csrc/solver_kernels.cu",
    "interp_eval": "src/repro_torch/kernels/csrc/solver_kernels.cu",
    "fused_step": "src/repro_torch/kernels/csrc/fused_step.cu",
    "fused_step_poly": "src/repro_torch/kernels/csrc/fused_step.cu",
    "masked_bisect_refine": "src/repro_torch/kernels/csrc/events.cu",
    "fused_event_detect": "src/repro_torch/kernels/csrc/events.cu",
    "fused_event_commit": "src/repro_torch/kernels/csrc/events.cu",
    "batched_linsolve": "src/repro_torch/kernels/csrc/linalg.cu",
    "batched_lu_factor": "src/repro_torch/kernels/csrc/linalg.cu",
    "fused_newton_iter": "src/repro_torch/kernels/csrc/linalg.cu",
    "masked_newton_update": "src/repro_torch/kernels/csrc/linalg.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attn.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
}
REPLACES = {
    "stage_accum": "src/repro/kernels/pallas_impl.py:123",
    "fused_update": "src/repro/kernels/pallas_impl.py:78",
    "error_norm": "src/repro/kernels/pallas_impl.py:167",
    "interp_eval": "src/repro/kernels/pallas_impl.py:226",
    "fused_step": "src/repro/kernels/pallas_impl.py:1000",
    "fused_step_poly": "src/repro/kernels/pallas_impl.py:1058",
    "masked_bisect_refine": "src/repro/kernels/pallas_impl.py:284",
    "fused_event_detect": "src/repro/kernels/pallas_impl.py:1144",
    "fused_event_commit": "src/repro/kernels/pallas_impl.py:1205",
    "batched_linsolve": "src/repro/kernels/pallas_impl.py:370",
    "batched_lu_factor": "src/repro/kernels/pallas_impl.py:454",
    "fused_newton_iter": "src/repro/kernels/pallas_impl.py:540",
    "masked_newton_update": "src/repro/kernels/pallas_impl.py:608",
    "flash_attention_fwd": "src/repro/kernels/flash_attn.py:83",
    # No Pallas kernel: the reference differentiates its jnp attention here.
    "flash_attention_bwd": "src/repro/models/attention.py:39",
}
# fused_update is timed at each stage count of the repo's tableaus (one
# tableau each); the main path's is dopri5's s = 7.
UPDATE_TABLEAUS = {1: "euler", 2: "heun", 3: "trbdf2", 4: "bosh3", 7: "dopri5"}
MAIN_CASE = {"fused_update": "s=7 dopri5"}
# The stiff path's kernels are timed and counted at allen_cahn_full's shapes.
MAIN_SHAPE = dict.fromkeys(("batched_linsolve", "batched_lu_factor", "fused_newton_iter",
                            "masked_newton_update"), "allen_cahn_full")
# The attention kernel at the shape the lm phase's full-width serve gives it.
MAIN_SHAPE["flash_attention_fwd"] = "qwen2.5-14b_prefill"
# The attention backward at the layer the train_lm phase's full-width
# stablelm-3b gives it (b = 2, s = 2048, 32 heads of 80, bf16).
MAIN_SHAPE["flash_attention_bwd"] = "stablelm-3b_train"
MAIN_DTYPE = {"flash_attention_fwd": "bfloat16", "flash_attention_bwd": "bfloat16"}
# The flash kernel against its plain version (b, sq, sk, H, KV, hd, causal,
# q_offset): tests/test_flash_kernel.py's CASES, ragged lengths,
# chunked-prefill continuations, hd = 80 (stablelm-3b), bidirectional, and
# the head shapes of the configs beyond the dense ones.
FLASH_CASES = [
    (1, 32, 32, 2, 2, 8, True, 0), (2, 64, 64, 4, 2, 16, True, 0),
    (1, 64, 64, 4, 4, 16, False, 0), (2, 128, 128, 8, 2, 32, True, 0),
    (1, 128, 128, 4, 1, 16, True, 0), (2, 37, 37, 4, 2, 16, True, 0),
    (2, 37, 45, 4, 2, 16, True, 8), (1, 13, 45, 4, 2, 16, True, 32),
    (1, 37, 45, 4, 4, 16, False, 0), (1, 100, 300, 8, 2, 128, True, 200),
    (2, 129, 129, 32, 32, 80, True, 0), (1, 77, 77, 4, 4, 80, False, 0),
    # the lm_kinds phase's heads: whisper's 20 x 64 (bidirectional; its cross
    # attention has sq != sk), deepseek-moe-16b's 16 x 128, kimi-k2's 64 / 8 x 112
    (1, 100, 150, 20, 20, 64, False, 0), (1, 130, 130, 16, 16, 128, True, 0),
    (1, 96, 96, 64, 8, 112, True, 0),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # the reference's own tolerances


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


_SPLIT = [time.perf_counter()]


def split(part):
    """Emit the wall seconds since the last split or phase end: where a long
    phase's time goes."""
    now = time.perf_counter()
    emit("timing", part=part, seconds=now - _SPLIT[0])
    _SPLIT[0] = now


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.core import (
        FixedController,
        get_tableau,
        integral_controller,
        pid_controller,
        polynomial_term,
        solve_ivp,
    )
    from repro_torch.core.stepper import _tableau_arrays
    from repro_torch.kernels import _build, cuda_impl, ops, ref
    from repro_torch.tools import dense_checks, event_checks, newton_checks, step_checks
    from repro_torch.tools import workloads
    from repro_torch.tools.step_checks import POLY32_STATE, tolerance
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM, param_count
    from repro_torch.models import attention as model_attention

    # Wall seconds of each phase, printed as it ends and all together before
    # the kernel summary: the script has a fixed time limit, and these say
    # where it goes.
    phase_seconds, since = {}, [time.perf_counter()]
    # What the dryrun phase sets its counts against: the lm phase's prefill
    # and the train_lm phase's AdamW step, measured in this run.
    measured = {}

    def lap(name):
        now = time.perf_counter()
        phase_seconds[name], since[0], _SPLIT[0] = now - since[0], now, now
        emit("timing", ended=name, seconds=phase_seconds[name])

    dev = torch.device("cuda")
    # Full float32 products everywhere: the CPU/card comparisons below are
    # about the solver, not about TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit("device", nvidia_smi=smi, torch=torch.__version__, torch_cuda=torch.version.cuda,
         nvcc=nvcc, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    lap("device")
    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build(verbose=fresh)
    _build.load()
    emit("build", seconds=time.perf_counter() - t0, built=fresh,
         library=str(lib_path.relative_to(ROOT)), flags=" ".join(_build.NVCC_FLAGS))

    lap("build")
    # ----------------------------------------------------------- 3. kernels
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > 50 MB L2

    def median_ms(fn, reps=REPS):
        """Median of ``reps`` launches after warmup, each timed alone with CUDA
        events after the L2 cache is flushed (the main path's callers find
        large operands cold).  The device sleeps before each timed launch,
        so the host has queued the start event, the launch and the end event
        before the device reaches them: host dispatch time stays out of the
        measurement."""
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def bound_ms(nbytes, flops, dtype):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    def compare(name, got, want, dtype):
        tol = tolerance(dtype)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=lambda m: f"{name}: {m}")
        return abs_err, abs_err / max(scale, 1e-300)

    rows = []

    # The launch floor: a one-element PyTorch elementwise op timed by the same
    # rule as every kernel below (L2 flushed, the device asleep first, CUDA
    # events, median): what any launch costs under this rule.
    one = torch.zeros(1, device=dev)
    emit("kernels", check="launch floor", op="Tensor.add_ on one float32 element",
         ms=median_ms(lambda: one.add_(1.0)), reps=REPS)

    def hold_bitwise(name, got, want, _dtype):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return event_checks.assert_bitwise(name, got, want), 0.0

    def measure(kernel, shape_name, dtype, label, run_kernel, run_plain, nbytes, flops,
                check_kernel=None, compare_fn=None, run_library=None, **extra):
        """Hold the kernel against its plain version, then time both.
        ``check_kernel`` replaces ``run_kernel`` in the comparison where the
        kernel writes into one of its inputs: it runs the kernel on a copy,
        so both sides see the same inputs.  ``compare_fn`` replaces
        ``compare`` (the fused step's decision-aware comparison).
        ``run_library`` is one PyTorch call computing the same function,
        timed alone (``library_ms``)."""
        torch.cuda.synchronize()
        want = run_plain()
        got = (check_kernel or run_kernel)()
        abs_err, rel_err = (compare_fn or compare)(f"{kernel}[{label}]", got, want, dtype)
        bound, by = bound_ms(nbytes, flops, dtype)
        tol = extra.pop("tol", None) or tolerance(dtype)
        row = dict(kernel=kernel, shape=shape_name, dtype=str(dtype).split(".")[-1],
                   case=label, tol=tol, max_abs_err=abs_err, max_rel_err=rel_err,
                   kernel_ms=median_ms(run_kernel), plain_ms=median_ms(run_plain),
                   bound_ms=bound, bound_by=by,
                   library_ms=median_ms(run_library) if run_library else None, **extra)
        rows.append(row)
        emit("kernels", **row)

    gen = torch.Generator(device="cpu").manual_seed(0)
    coef_rng = np.random.default_rng(0)
    for shape_name, shp in (("vdp_table3", workloads.VDP), ("full_width", workloads.FULL)):
        b, f, n = shp["b"], shp["f"], shp["n"]
        for dtype in (torch.float32, torch.float64):
            e = torch.empty((), dtype=dtype).element_size()

            def r(*s):
                return torch.randn(*s, generator=gen, dtype=dtype).to(dev)

            y, dt, K = r(b, f), 0.1 * r(b).abs(), r(7, b, f)
            a = coef_rng.standard_normal(7)
            for j in range(1, 7):
                Kj = K[:j]
                measure("stage_accum", shape_name, dtype, f"j={j}",
                        lambda: cuda_impl.stage_accum(y, dt, Kj, a[:j]),
                        lambda: ref.stage_accum(y, dt, Kj, a[:j]),
                        e * (b * f * (j + 2) + b), 2 * (j + 1) * b * f)
            # fused_update at every stage count a tableau of the repo has,
            # with that tableau's weights; each case its own bound.
            for s, method in UPDATE_TABLEAUS.items():
                _, _, bs, be = _tableau_arrays(get_tableau(method), dtype)
                Ks = K[:s]
                measure("fused_update", shape_name, dtype, f"s={s} {method}",
                        lambda: cuda_impl.fused_update(y, Ks, dt, bs, be),
                        lambda: ref.fused_update(y, Ks, dt, bs, be),
                        e * (b * f * (s + 3) + b), (4 * s + 3) * b * f)
            err = 1e-5 * r(b, f)
            for label, (atol, rtol), tol_elems in (
                    ("tol=scalar", (1e-5, 1e-5), 0),
                    ("tol=(b,)", (1e-5 * (1 + r(b).abs()), 1e-5 * (1 + r(b).abs())), 2 * b),
                    ("tol=(b,f)", (1e-5 * (1 + r(b, f).abs()), 1e-5 * (1 + r(b, f).abs())),
                     2 * b * f)):
                measure("error_norm", shape_name, dtype, label,
                        lambda: cuda_impl.error_norm(err, y, K[1], atol, rtol),
                        lambda: ref.error_norm(err, y, K[1], atol, rtol),
                        e * (3 * b * f + tol_elems + b), 7 * b * f,
                        body=cuda_impl.error_norm_body(f),
                        ms_by_body={body: median_ms(
                            lambda body=body: cuda_impl.error_norm(err, y, K[1], atol, rtol,
                                                                   body=body))
                                    for body in cuda_impl.ERROR_NORM_BODIES})
            # A dense-output write as a step makes it: each row passes a few
            # consecutive eval points (3 here) at its own place in the grid.
            coeffs = tuple(r(b, f) for _ in range(4))
            x = torch.rand(b, n, generator=gen, dtype=dtype).to(dev)
            start = torch.randint(0, n - 3, (b,), generator=gen)
            mask = ((torch.arange(n)[None] >= start[:, None])
                    & (torch.arange(n)[None] < start[:, None] + 3)).to(dev)
            out = r(b, n, f)
            cells, rows_hit = int(mask.sum()), int(mask.any(dim=1).sum())
            # The kernel writes the masked cells of `out` in place; the check
            # runs it on a copy, so a write to an unmasked cell shows up.  Its
            # Horner rounds as the plain version's does: held bitwise.  Its
            # bound: the masked cells written, the coefficients of the rows
            # with one and the masked cells' positions read, the b * n mask
            # bytes scanned.
            measure("interp_eval", shape_name, dtype, "mask=3 of n per row",
                    lambda: cuda_impl.interp_eval(coeffs, x, mask, out),
                    lambda: ref.interp_eval(coeffs, x, mask, out),
                    e * (cells * f + 4 * rows_hit * f + cells) + b * n, 6 * cells * f,
                    check_kernel=lambda: cuda_impl.interp_eval(coeffs, x, mask, out.clone()),
                    compare_fn=hold_bitwise, held="bitwise", body=cuda_impl.interp_eval_body(f),
                    ms_by_body={body: median_ms(
                        lambda body=body: cuda_impl.interp_eval(coeffs, x, mask, out, body=body))
                                for body in cuda_impl.INTERP_BODIES})
            # The windowed write (dense_window > 0) goes through the same kernel.
            W = 8
            cursor = torch.randint(0, n - W + 1, (b,), generator=gen).to(dev)
            xw, mw = x[:, :W].contiguous(), (torch.rand(b, W, generator=gen) < 0.4).to(dev)
            hold_bitwise("interp_eval[window]",
                         cuda_impl.interp_eval(coeffs, xw, mw, out.clone(), cursor),
                         ref.interp_eval_window(coeffs, xw, mw, out, cursor), dtype)

    # error_norm's wide body at the rows it takes on the training paths: the
    # ODE-depth LM's two of s d = 5 242 880 (train_lm path (b)) and
    # full_width's joint backsolve, one row of 2 b f + p = 3 213 072 (phase
    # grad), float32, scalar tolerances; the warp body beside it (5 launches:
    # it takes 41-75 ms).  Besides the bytes, the fold's lane chains bound
    # it: f / 32 dependent fmas a lane, ~4 cycles each (chain_floor_ms at a
    # 1.98 GHz clock).
    for shape_name, (b, f) in (("ode_depth_lm", (2, 2048 * 2560)),
                               ("joint_backsolve", (1, 3213072))):
        w_gen = torch.Generator(device=dev).manual_seed(f)
        w_err, w_y0, w_y1 = (torch.randn(b, f, generator=w_gen, device=dev) for _ in range(3))
        w_err *= 1e-5
        measure("error_norm", shape_name, torch.float32, f"b={b} f={f} tol=scalar",
                lambda: cuda_impl.error_norm(w_err, w_y0, w_y1, 1e-5, 1e-5),
                lambda: ref.error_norm(w_err, w_y0, w_y1, 1e-5, 1e-5),
                4 * (3 * b * f + b), 7 * b * f, body=cuda_impl.error_norm_body(f),
                chain_floor_ms=f / 32 * 4 / 1.98e9 * 1e3,
                ms_by_body={"warp": median_ms(lambda: cuda_impl.error_norm(
                    w_err, w_y0, w_y1, 1e-5, 1e-5, body="warp"), reps=5)})
        del w_err, w_y0, w_y1

    # stage_accum at every stage count of a tableau of up to kMaxStages = 8
    # stages (j = 1..7) on both of its paths: 16-byte chunks (f % V == 0 and
    # every plane aligned) and entry by entry (an odd width; K one entry off
    # a 16-byte boundary); rows narrower than a warp share a block.
    accum_cases = 0
    for dtype in (torch.float32, torch.float64):
        for b, f, offset in ((37, 784, 0), (37, 783, 0), (37, 784, 1), (5, 1, 0), (300, 2, 1),
                             (3, 1000, 0)):
            y = torch.randn(b, f, generator=gen, dtype=dtype).to(dev)
            dt = 0.1 * torch.rand(b, generator=gen, dtype=dtype).to(dev)
            flat = torch.randn(7 * b * f + offset, generator=gen, dtype=dtype).to(dev)
            a = coef_rng.standard_normal(7)
            for j in range(1, 8):
                Kj = flat[offset:offset + j * b * f].view(j, b, f)
                compare(f"stage_accum[b={b} f={f} K offset={offset} j={j}]",
                        cuda_impl.stage_accum(y, dt, Kj, a[:j]), ref.stage_accum(y, dt, Kj, a[:j]),
                        dtype)
                accum_cases += 1
    emit("kernels", kernel="stage_accum", check="j = 1..7, chunked and entry by entry",
         cases=accum_cases, tol={"float32": tolerance(torch.float32),
                                 "float64": tolerance(torch.float64)})

    # fused_update at the widths around its layout (dense_checks.UPDATE_SHAPES)
    # with every tableau's weights and random weights at s = 1..8
    # (UPDATE_WEIGHTS), on 16-byte chunks and entry by entry (y or K one entry
    # off a 16-byte boundary), and the empty batch.
    update_cases = 0
    for dtype, (b, f), layout, weights in itertools.product(
            (torch.float32, torch.float64), dense_checks.UPDATE_SHAPES, ("aligned", "y", "K"),
            dense_checks.UPDATE_WEIGHTS):
        b_sol, b_err = dense_checks.update_weights(weights)
        y, K, dt = (torch.from_numpy(a).to(dev) for a in dense_checks.update_inputs(
            b * f + len(b_sol), b, f, len(b_sol), torch.empty((), dtype=dtype).numpy().dtype))
        if layout == "y":
            y = event_checks.unaligned(y)
        elif layout == "K":
            K = event_checks.unaligned(K)
        compare(f"fused_update[b={b} f={f} {layout} {weights}]",
                cuda_impl.fused_update(y, K, dt, b_sol, b_err),
                ref.fused_update(y, K, dt, b_sol, b_err), dtype)
        update_cases += 1
    empty = torch.empty((7, 0, 784), device=dev)
    y1, err = cuda_impl.fused_update(empty[0], empty, empty[0, :, 0], [1.0] * 7, [0.0] * 7)
    torch.cuda.synchronize()
    check(y1.shape == err.shape == (0, 784), "fused_update: the empty batch")
    emit("kernels", kernel="fused_update",
         check="UPDATE_SHAPES x UPDATE_WEIGHTS, chunked and entry by entry; empty batch",
         cases=update_cases, tol={"float32": tolerance(torch.float32),
                                  "float64": tolerance(torch.float64)})

    # The fused step kernels, against their plain versions (ref.fused_step,
    # ref.fused_step_poly) on the same card tensors, over every option:
    # float32/float64, pid (integral_controller's exponents, where b2 = b3 =
    # 0, and pid_controller's) and fixed mode, the three tolerance shapes,
    # coefficients on and off, `failed` null and set, `f0` null and set (the
    # stiff fused step passes both).  atol is picked as
    # tests/test_fused_step.py picks it, so the running rows mix accepts and
    # rejects.  The comparison rule (every output, the error ratio to its
    # rounding floor) is step_checks.hold_to_plain; each case must also be
    # bitwise equal to the unfused card path (step_checks.unfused_card), and
    # each kernel's two bodies (a warp per row, a block per row) bitwise equal
    # to each other.
    def mixed_atol(probe, running):
        """The atol at which the running rows' ratios straddle 1: ratio ~
        1/atol here, so rescale the probe's ratios (taken at atol 0.05)
        about the geometric mean of its two middle running rows."""
        live = probe[running].double().sort().values
        k = max(len(live) // 2, 1)
        mid = float((live[k - 1] * live[min(k, len(live) - 1)]).sqrt())
        return 0.05 * mid

    def tol_factors(kind, b, f, dtype):
        """1 for a scalar tolerance, else a (b,) or (b, f) factor in [1, 1.5]."""
        if kind == "scalar":
            return 1.0
        shape = (b,) if kind == "(b,)" else (b, f)
        return (1.0 + 0.5 * torch.rand(*shape, generator=gen, dtype=dtype)).to(dev)

    def step_bytes(e, b, f, planes_in, planes_out, tol_elems, failed):
        # (b,) columns: 6 read (t, t_new, dt_cur, safe_dt, prev_inv, prev2_inv),
        # 5 written (ratio, t_out, dt_out, new_inv, new_inv2); bool masks 1 B.
        return (e * (b * f * (planes_in + planes_out) + tol_elems + 11 * b)
                + b * (2 if failed else 1) + b)

    fused_checks = {}
    optional_outputs = {"fused_step": {}, "fused_step_poly": {}}

    def fused_case(kernel, shape_name, dtype, label, run_kernel, run_plain, floor_of,
                   nbytes, flops, timed, bodies=None, with_outputs=None):
        """Hold one case bitwise against the unfused card path and by
        step_checks.hold_to_plain against the plain version; time it if
        ``timed``.  ``floor_of(y1)`` gives the ratio's rounding floor.
        ``bodies``: each body's run, held bitwise to the default run (so the
        bodies to each other) and timed beside it.  ``with_outputs(body)``:
        the launch with the optional outputs the autograd Function asks for
        (``errs=``, and ``stages=``/``stage_args=`` for fused_step_poly),
        returning its outputs and ``{name: (written, expected)}``; its
        outputs must equal the default run's bitwise and each written
        tensor its expected one bitwise."""
        dt_name = str(dtype).split(".")[-1]
        name = f"{kernel}[{shape_name} {dt_name} {label}]"
        got = run_kernel()
        bits = step_checks.bitwise_mismatches(got, step_checks.unfused_card(run_plain))
        check(not bits, f"{name}: differs bitwise from the unfused card path: {bits}")
        for body, run in (bodies or {}).items():
            other = step_checks.bitwise_mismatches(run(), got)
            check(not other, f"{name}: the {body} body differs bitwise from the default: {other}")
            if with_outputs is not None:
                out, written = with_outputs(body)
                other = step_checks.bitwise_mismatches(out, got)
                check(not other, f"{name}: {body} with the optional outputs differs: {other}")
                for k, (w, want) in written.items():
                    check(torch.equal(w, want), f"{name}: {body} wrote {k} apart from {want}")
                    optional_outputs[kernel][k] = optional_outputs[kernel].get(k, 0) + 1
        floor = floor_of(run_plain()[0])
        state_tol = POLY32_STATE if kernel == "fused_step_poly" and dtype == torch.float32 else None
        held = []

        def hold(name, got, want, _dtype):
            worst, rel, edge = step_checks.hold_to_plain(name, got, want, floor, state_tol)
            held.append((worst, edge))
            return worst, rel
        if timed:
            extra = {}
            if bodies:
                counts = cuda_impl.body_launches[kernel]
                before = dict(counts)
                run_kernel()
                extra = dict(body=next(k for k in counts if counts[k] > before[k]),
                             ms_by_body={k: median_ms(run) for k, run in bodies.items()})
            measure(kernel, shape_name, dtype, label, run_kernel, run_plain, nbytes, flops,
                    compare_fn=hold, **extra)
        else:
            hold(name, run_kernel(), run_plain(), dtype)
        agg = fused_checks.setdefault((kernel, shape_name, dt_name),
                                      dict(cases=0, max_abs_err=0.0, knife_edge_rows=0))
        agg["cases"] += 1
        agg["max_abs_err"] = max(agg["max_abs_err"], held[0][0])
        agg["knife_edge_rows"] += held[0][1]

    controllers = {"pid/integral": integral_controller(), "pid/pid": pid_controller(),
                   "fixed": FixedController()}
    for shape_name, shp in (("vdp_table3", workloads.VDP), ("full_width", workloads.FULL)):
        b, f = shp["b"], shp["f"]
        for dtype in (torch.float32, torch.float64):
            e = torch.empty((), dtype=dtype).element_size()
            for cname, ctl in controllers.items():
                tab = get_tableau("rk4" if cname == "fixed" else "dopri5")
                _, _, b_sol, b_err = _tableau_arrays(tab, dtype)
                s = tab.stages
                mode = "fixed" if cname == "fixed" else "pid"
                ctrl = ctl.filter_params(tab.error_order)
                y, K, cols, failed_rows = step_checks.step_inputs(b, f, s, dtype, dev, gen)
                f0_plane = torch.randn(b, f, generator=gen, dtype=dtype).to(dev)
                err_est = cuda_impl.fused_update(y, K, cols[3], b_sol, b_err)[1]
                for kind in ("scalar", "(b,)", "(b,f)"):
                    fac = tol_factors(kind, b, f, dtype)
                    probe = ref.fused_step(y, K, K[-1], *cols, 0.05 * fac, 1e-3 * fac,
                                           b_sol=b_sol, b_err=b_err, ctrl=ctrl,
                                           want_coeffs=False, ctrl_mode=mode)[1]
                    atol, rtol = mixed_atol(probe, cols[4]) * fac, 1e-3 * fac
                    tol_elems = {"scalar": 0, "(b,)": 2 * b, "(b,f)": 2 * b * f}[kind]
                    for want_coeffs in (True, False):
                        for failed, f0 in ((None, None), (failed_rows, None),
                                           (failed_rows, f0_plane)):
                            def call(fn, failed=failed, f0=f0, want_coeffs=want_coeffs,
                                     atol=atol, rtol=rtol, **body):
                                return lambda: fn(y, K, K[-1], *cols, atol, rtol,
                                                  b_sol=b_sol, b_err=b_err, ctrl=ctrl,
                                                  want_coeffs=want_coeffs, ctrl_mode=mode,
                                                  failed=failed, f0=f0, **body)

                            def with_errs(body, call=call):
                                errs = torch.full_like(y, float("nan"))
                                out = call(cuda_impl.fused_step, body=body, errs=errs)()
                                return out, {"errs": (errs, err_est)}
                            fused_case(
                                "fused_step", shape_name, dtype,
                                f"{cname} tol={kind} coeffs={want_coeffs} "
                                f"failed={'set' if failed is not None else 'null'} "
                                f"f0={'set' if f0 is not None else 'null'}",
                                call(cuda_impl.fused_step), call(ref.fused_step),
                                lambda y1, atol=atol, rtol=rtol: step_checks.ratio_floor(
                                    y, y1, K, cols[3], b_err, atol, rtol),
                                # Inputs y and K (and f0 where set); f1 is
                                # K[s-1] (the FSAL stage), the same memory,
                                # read once.
                                step_bytes(e, b, f, s + 1 + (f0 is not None),
                                           3 + 3 * want_coeffs, tol_elems, failed is not None),
                                (4 * s + 22) * b * f,
                                timed=(cname == "pid/integral" and kind == "scalar"
                                       and want_coeffs and failed is None),
                                bodies={body: call(cuda_impl.fused_step, body=body)
                                        for body in cuda_impl.STEP_BODIES},
                                with_outputs=with_errs)
            # fused_step_poly: FSAL (dopri5), non-FSAL (heun), fixed (rk4);
            # a scalar logistic polynomial and a per-feature one.
            per_feature = tuple(np.linspace(-1.5, -0.5, f).tolist())
            for tname, cname in (("dopri5", "pid/pid"), ("heun", "pid/pid"),
                                 ("rk4", "fixed")):
                tab = get_tableau(tname)
                a, c, b_sol, b_err = _tableau_arrays(tab, dtype)
                s, ctl = tab.stages, controllers[cname]
                mode = "fixed" if cname == "fixed" else "pid"
                ctrl = ctl.filter_params(tab.error_order)
                y, _, cols, _ = step_checks.step_inputs(b, f, s, dtype, dev, gen, dt_scale=4.0)
                for pname, poly in (("logistic", (0.0, 1.0, -1.0)),
                                    ("per-feature", (0.0, per_feature))):
                    f0 = ref.poly_eval(y, poly)
                    K = ref.poly_stages(y, f0, cols[3], a, poly)
                    # What the backward reads, on the unfused card path.
                    Kc = step_checks.unfused_card(lambda: ref.poly_stages(y, f0, cols[3], a, poly))
                    Zc = torch.stack([cuda_impl.stage_accum(y, cols[3], Kc[:i], a[i, :i])
                                      for i in range(1, s)])
                    Ec = cuda_impl.fused_update(y, Kc, cols[3], b_sol, b_err)[1]
                    for kind in ("scalar", "(b,)", "(b,f)"):
                        fac = tol_factors(kind, b, f, dtype)
                        kw = dict(a=a, c=c, b_sol=b_sol, b_err=b_err, poly=poly, ctrl=ctrl,
                                  fsal=tab.fsal, ctrl_mode=mode)
                        probe = ref.fused_step_poly(y, f0, *cols, 0.05 * fac, 1e-3 * fac,
                                                    want_coeffs=False, **kw)[1]
                        atol, rtol = mixed_atol(probe, cols[4]) * fac, 1e-3 * fac
                        tol_elems = {"scalar": 0, "(b,)": 2 * b, "(b,f)": 2 * b * f}[kind]
                        for want_coeffs in (False, True):
                            def call(fn, want_coeffs=want_coeffs, atol=atol, rtol=rtol, kw=kw,
                                     **body):
                                return lambda: fn(y, f0, *cols, atol, rtol,
                                                  want_coeffs=want_coeffs, **kw, **body)

                            def with_stages(body, call=call, Kc=Kc, Zc=Zc, Ec=Ec):
                                outs = {k: torch.full_like(v, float("nan"))
                                        for k, v in (("stages", Kc), ("stage_args", Zc),
                                                     ("errs", Ec))}
                                out = call(cuda_impl.fused_step_poly, body=body, **outs)()
                                return out, {k: (outs[k], want) for k, want in
                                             (("stages", Kc), ("stage_args", Zc), ("errs", Ec))}
                            deg = len(poly) - 1
                            fused_case(
                                "fused_step_poly", shape_name, dtype,
                                f"{tname} {cname} {pname} tol={kind} coeffs={want_coeffs}",
                                call(cuda_impl.fused_step_poly), call(ref.fused_step_poly),
                                lambda y1, atol=atol, rtol=rtol, K=K: step_checks.ratio_floor(
                                    y, y1, K, cols[3], b_err, atol, rtol),
                                step_bytes(e, b, f, 2, 3 + 3 * want_coeffs, tol_elems, False)
                                + e * len(poly) * f,
                                (s * (s + 1) + 2 * deg * (s + 1) + 4 * s + 22) * b * f,
                                timed=(tname == "dopri5" and pname == "logistic"
                                       and kind == "scalar" and not want_coeffs),
                                bodies={body: call(cuda_impl.fused_step_poly, body=body)
                                        for body in cuda_impl.POLY_BODIES},
                                with_outputs=with_stages)
    for (kernel, shape_name, dt), agg in fused_checks.items():
        poly32 = kernel == "fused_step_poly" and dt == "float32"
        emit("kernels", kernel=kernel, shape=shape_name, dtype=dt, check="all options",
             tol=tolerance(getattr(torch, dt)), state_tol=POLY32_STATE if poly32 else None,
             knife_edge=step_checks.KNIFE_EDGE, bitwise_equal_to_unfused_card=True,
             bodies_bitwise_equal=list(cuda_impl.POLY_BODIES if kernel == "fused_step_poly"
                                       else cuda_impl.STEP_BODIES), **agg)
    emit("kernels", kernel="fused_step", check="launches by body over the cases above",
         body_launches=dict(cuda_impl.body_launches["fused_step"]))
    emit("kernels", check="the optional outputs the autograd Functions ask for, every case and "
         "body above: the outputs bitwise those of the launch without them; errs bitwise "
         "fused_update's, stages bitwise ref.poly_stages on the unfused card path, stage_args "
         "bitwise stage_accum's of them", launches_checked=optional_outputs)

    # The event kernels at E = 2 (one terminal, one marker event, as on the
    # main path), over the cases of tools/event_checks.py (active, inactive
    # and mixed rows; every direction; zeros at an endpoint; fired cells;
    # terminal mixes with ties in x; NaN condition values), each held
    # bitwise to its plain version on the same card tensors.  One case per
    # kernel, shape and dtype is timed: the main path's mix.  library_ms is
    # null: no single PyTorch call computes a masked bisection step with a
    # Horner evaluation, a directional sign test with a masked carry, or the
    # terminal resolution and record commit.
    event_held = {}
    E_MAIN = 2
    for shape_name, shp in (("vdp_table3", workloads.VDP), ("full_width", workloads.FULL)):
        b, f = shp["b"], shp["f"]
        for npdt in (np.float32, np.float64):
            dtype = torch.float32 if npdt == np.float32 else torch.float64
            e = np.dtype(npdt).itemsize
            held = event_held.setdefault((shape_name, npdt.__name__), [])
            for active in ("mixed", "all", "none"):
                args = event_checks.to_torch(
                    event_checks.bisect_inputs(b + f, b, f, npdt, active), dev)
                run_k = lambda args=args: cuda_impl.masked_bisect_refine(*args)
                run_p = lambda args=args: ref.masked_bisect_refine(*args)
                if active == "mixed":
                    measure("masked_bisect_refine", shape_name, dtype, f"active={active}",
                            run_k, run_p, e * (5 * b * f + 8 * b) + b, 6 * b * f,
                            compare_fn=hold_bitwise, held="bitwise")
                else:
                    held.append(hold_bitwise("masked_bisect_refine", run_k(), run_p(), dtype))
            *dargs, dirs = event_checks.to_torch(
                event_checks.detect_inputs(b + 1, b, E_MAIN, npdt), dev)
            for label, directions in (("directions=(0,+1)", dirs),
                                      ("directions=+1", (1.0,) * E_MAIN),
                                      ("directions=-1", (-1.0,) * E_MAIN)):
                run_k = lambda d=directions: cuda_impl.fused_event_detect(*dargs, directions=d)
                run_p = lambda d=directions: ref.fused_event_detect(*dargs, directions=d)
                if directions is dirs:
                    measure("fused_event_detect", shape_name, dtype, label, run_k, run_p,
                            e * 3 * b * E_MAIN + 2 * b * E_MAIN + b, 10 * b * E_MAIN,
                            compare_fn=hold_bitwise, held="bitwise")
                else:
                    held.append(hold_bitwise("fused_event_detect", run_k(), run_p(), dtype))
            for terminal in ("mixed", "all", "none"):
                *cargs, flags = event_checks.to_torch(
                    event_checks.commit_inputs(b + 2, b, f, E_MAIN, npdt, terminal), dev)
                # The kernel writes the recorded cells of ev_y in place: the
                # check runs it on a copy.
                check_k = lambda cargs=cargs, flags=flags: cuda_impl.fused_event_commit(
                    *cargs[:8], cargs[8].clone(), terminal=flags)
                run_k = lambda cargs=cargs, flags=flags: cuda_impl.fused_event_commit(
                    *cargs, terminal=flags)
                run_p = lambda cargs=cargs, flags=flags: ref.fused_event_commit(
                    *cargs, terminal=flags)
                if terminal == "mixed":
                    # Bytes this data needs: per row one (b, f) plane read for
                    # y_stop (y_new, or the stopping crossing's state) and
                    # y_stop written; y_ev read and ev_y written in the cells
                    # of the recorded crossings; the (b, E) and (b,) columns.
                    recorded = int(run_p()[6].sum())
                    nbytes = (e * (2 * b * f + 2 * recorded * f + 3 * b * E_MAIN + 2 * b)
                              + 3 * b * E_MAIN + 5 * b)
                    measure("fused_event_commit", shape_name, dtype, f"terminal={terminal}",
                            run_k, run_p, nbytes, 4 * b * E_MAIN, check_kernel=check_k,
                            compare_fn=hold_bitwise, held="bitwise", recorded=recorded)
                else:
                    held.append(hold_bitwise("fused_event_commit", check_k(), run_p(), dtype))
    emit("kernels", check="event kernels, untimed cases", bitwise_equal_to_plain=True,
         cases={f"{k[0]}/{k[1]}": len(v) for k, v in event_held.items()})
    # fused_event_detect at every width of a row's thread segment (one event
    # a thread up to E = 32, two above), b = 37 rows, every direction in one
    # batch and each alone, NaN directions, NaN and +-0 condition values,
    # mixed fired and accept; bitwise.
    detect_events = (1, 2, 31, 32, 33, 63, 64)
    for npdt in (np.float32, np.float64):
        for E in detect_events:
            *dargs, cycle = event_checks.to_torch(event_checks.detect_inputs(37 * E, 37, E, npdt),
                                                  dev)
            for directions in (cycle, (1.0,) * E, (-1.0,) * E, (0.0,) * E, (math.nan,) * E):
                event_checks.assert_bitwise(
                    f"fused_event_detect[E={E} {npdt.__name__}]",
                    cuda_impl.fused_event_detect(*dargs, directions=directions),
                    ref.fused_event_detect(*dargs, directions=directions))
    emit("kernels", check="fused_event_detect row segments", b=37, events=detect_events,
         directions="cycle 0/+1/-1, all +1, all -1, all 0, all NaN", bitwise_equal_to_plain=True)
    # masked_bisect_refine at every row-segment class: f below, at and above
    # a 16-byte chunk and around full_width's 784, b = 37 rows (not a
    # multiple of a block's rows), coefficient planes 16-byte aligned (chunks,
    # with per-row heads and tails where f is not a multiple of a chunk) and
    # one entry off (entry by entry), bitwise.
    widths = (1, 2, 3, 4, 5, 783, 784, 785)
    for npdt in (np.float32, np.float64):
        for f in widths:
            coeffs, *cols = event_checks.to_torch(
                event_checks.bisect_inputs(f, 37, f, npdt, "mixed"), dev)
            for aligned in (True, False):
                if not aligned:
                    coeffs = tuple(event_checks.unaligned(c) for c in coeffs)
                event_checks.assert_bitwise(
                    f"masked_bisect_refine[f={f} aligned={aligned}]",
                    cuda_impl.masked_bisect_refine(coeffs, *cols),
                    ref.masked_bisect_refine(coeffs, *cols))
    emit("kernels", check="masked_bisect_refine row segments", b=37, widths=widths,
         coefficients=["16-byte aligned", "one entry off"], bitwise_equal_to_plain=True)
    # error_norm and interp_eval at the widths around their layouts
    # (dense_checks.ERROR_NORM_WIDTHS: rows sharing a block, a warp, whole
    # 16-byte chunks or not), b = 37 rows.  error_norm: every tolerance shape,
    # err aligned or one entry off, every body held to the plain version and
    # bitwise to each other; the warp and row bodies patched into the unfused
    # card path give bitwise the err_ratio of both of fused_step's bodies
    # (dopri5, the same step inputs; the fold order the fused kernels share).  interp_eval:
    # every mask kind, both bodies bitwise to the plain version on a copy of
    # out; the window (W = 8 of n = 20) with cursors at 0 and n - W against
    # ref.interp_eval_window, and past either end of the buffer, where only
    # the cells inside it are written.
    dopri5 = get_tableau("dopri5")
    norm_cases = ratio_cases = interp_cases = 0
    for npdt in (np.float32, np.float64):
        dtype = torch.float32 if npdt == np.float32 else torch.float64
        _, _, b_sol, b_err = _tableau_arrays(dopri5, dtype)
        step_kw = dict(b_sol=b_sol, b_err=b_err, want_coeffs=False,
                       ctrl=pid_controller().filter_params(dopri5.error_order))
        for f in dense_checks.ERROR_NORM_WIDTHS:
            for kind in dense_checks.TOL_KINDS:
                err, y0, y1, atol, rtol = (
                    torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                    for a in dense_checks.norm_inputs(f, 37, f, npdt, kind))
                for e_in in (err, event_checks.unaligned(err)):
                    want = ref.error_norm(e_in, y0, y1, atol, rtol)
                    got = {body: cuda_impl.error_norm(e_in, y0, y1, atol, rtol, body=body)
                           for body in cuda_impl.ERROR_NORM_BODIES}
                    for body, g in got.items():
                        compare(f"error_norm[f={f} tol={kind} body={body}]", g, want, dtype)
                    check(all(torch.equal(g, got["warp"]) for g in got.values()),
                          f"error_norm[f={f} tol={kind}]: the bodies differ bitwise")
                    norm_cases += 1
            y, K, cols, _ = step_checks.step_inputs(37, f, dopri5.stages, dtype, dev, gen)
            for kind in dense_checks.TOL_KINDS:
                fac = tol_factors({"row": "(b,)", "full": "(b,f)"}.get(kind, kind), 37, f, dtype)
                args = (y, K, K[-1], *cols, 1e-4 * fac, 1e-3 * fac)
                fused = [cuda_impl.fused_step(*args, body=body, **step_kw)[1]
                         for body in cuda_impl.STEP_BODIES]
                # the wide body's ratio at its own widths below (bitwise the
                # warp body's output here, above)
                for norm_body in ("warp", "row"):
                    def unfused(norm_body=norm_body, args=args):
                        def norm(*a):
                            return cuda_impl.error_norm(*a, body=norm_body)
                        with mock.patch.object(ref, "error_norm", norm):
                            return ref.fused_step(*args, **step_kw)

                    ratio = step_checks.unfused_card(unfused)[1]
                    check(all(torch.equal(r, ratio) for r in fused),
                          f"error_norm[f={f} tol={kind} body={norm_body}]: the unfused card "
                          f"path's err_ratio differs bitwise from fused_step's")
                    ratio_cases += 1
            for kind in dense_checks.MASK_KINDS:
                coeffs, x, mask, out = (
                    tuple(torch.from_numpy(c).to(dev) for c in a) if isinstance(a, tuple)
                    else torch.from_numpy(a).to(dev)
                    for a in dense_checks.interp_inputs(f, 37, 40, f, npdt, kind))
                want = ref.interp_eval(coeffs, x, mask, out)
                for body in cuda_impl.INTERP_BODIES:
                    for dest in (out.clone(), event_checks.unaligned(out)):
                        hold_bitwise(f"interp_eval[f={f} mask={kind} body={body}]",
                                     cuda_impl.interp_eval(coeffs, x, mask, dest, body=body),
                                     want, dtype)
                        interp_cases += 1
            coeffs, x, mask, _ = (
                tuple(torch.from_numpy(c).to(dev) for c in a) if isinstance(a, tuple)
                else torch.from_numpy(a).to(dev)
                for a in dense_checks.interp_inputs(f, 6, 8, f, npdt, "run3"))
            out = torch.randn(6, 20, f, generator=gen, dtype=dtype).to(dev)
            inside = torch.tensor([0, 12, 0, 12, 5, 12], device=dev)
            past = torch.tensor([15, 19, 20, -3, -8, 40], device=dev)
            values = ref.interp_eval(coeffs, x, torch.ones_like(mask), torch.zeros_like(out[:, :8]))
            past_want = out.clone()
            for r_, w_ in mask.nonzero().tolist():
                col = int(past[r_]) + w_
                if 0 <= col < 20:
                    past_want[r_, col] = values[r_, w_]
            for body in cuda_impl.INTERP_BODIES:
                hold_bitwise(f"interp_eval[window f={f} body={body}]",
                             cuda_impl.interp_eval(coeffs, x, mask, out.clone(), inside,
                                                   body=body),
                             ref.interp_eval_window(coeffs, x, mask, out, inside), dtype)
                hold_bitwise(f"interp_eval[window past the buffer f={f} body={body}]",
                             cuda_impl.interp_eval(coeffs, x, mask, out.clone(), past, body=body),
                             past_want, dtype)
                interp_cases += 2
    emit("kernels", check="error_norm and interp_eval widths", b=37,
         widths=dense_checks.ERROR_NORM_WIDTHS, tolerances=dense_checks.TOL_KINDS,
         masks=dense_checks.MASK_KINDS, error_norm_cases=norm_cases,
         fused_ratio_bitwise_cases=ratio_cases, interp_eval_bitwise_cases=interp_cases,
         tol={"float32": tolerance(torch.float32), "float64": tolerance(torch.float64)})
    # error_norm's wide body on its own rows (dense_checks.NORM_WIDE_WIDTHS x
    # NORM_WIDE_ROWS, every tolerance shape, both dtypes; inputs drawn on the
    # card): chosen by error_norm_body and bitwise the warp body's; patched
    # into the unfused card path at f = 4097 and 9001, bitwise the err_ratio
    # of both of fused_step's bodies.  Held to the plain version where it is
    # timed (the ode_depth_lm and joint_backsolve rows below).
    wide_gen = torch.Generator(device=dev).manual_seed(29)
    wide_cases = wide_ratio_cases = 0
    for dtype in (torch.float32, torch.float64):
        for f in dense_checks.NORM_WIDE_WIDTHS:
            check(cuda_impl.error_norm_body(f) == "wide",
                  f"error_norm: f = {f} takes {cuda_impl.error_norm_body(f)}, not the wide body")
            for b in dense_checks.NORM_WIDE_ROWS:
                w_err, w_y0, w_y1 = (
                    torch.randn(b, f, generator=wide_gen, device=dev, dtype=dtype)
                    for _ in range(3))
                w_err *= 1e-4
                for kind in dense_checks.TOL_KINDS:
                    shape = {"scalar": (), "row": (b,), "full": (b, f)}[kind]
                    atol, rtol = ((1e-4, 1e-3) if not shape else
                                  (s_ * (1 + torch.rand(shape, generator=wide_gen, device=dev,
                                                        dtype=dtype)) for s_ in (1e-4, 1e-3)))
                    before = cuda_impl.body_launches["error_norm"]["wide"]
                    wide = cuda_impl.error_norm(w_err, w_y0, w_y1, atol, rtol)
                    check(cuda_impl.body_launches["error_norm"]["wide"] == before + 1
                          and torch.equal(wide, cuda_impl.error_norm(
                              w_err, w_y0, w_y1, atol, rtol, body="warp")),
                          f"error_norm[wide f={f} b={b} tol={kind} {dtype}]: not the warp "
                          f"body's bits")
                    wide_cases += 1
        _, _, b_sol, b_err = _tableau_arrays(dopri5, dtype)
        step_kw = dict(b_sol=b_sol, b_err=b_err, want_coeffs=False,
                       ctrl=pid_controller().filter_params(dopri5.error_order))
        for f in (4097, 9001):
            y, K, cols, _ = step_checks.step_inputs(37, f, dopri5.stages, dtype, dev, gen)
            for kind in dense_checks.TOL_KINDS:
                fac = tol_factors({"row": "(b,)", "full": "(b,f)"}.get(kind, kind), 37, f, dtype)
                args = (y, K, K[-1], *cols, 1e-4 * fac, 1e-3 * fac)
                fused = [cuda_impl.fused_step(*args, body=body, **step_kw)[1]
                         for body in cuda_impl.STEP_BODIES]

                def unfused(args=args, step_kw=step_kw):
                    def norm(*a):
                        return cuda_impl.error_norm(*a, body="wide")
                    with mock.patch.object(ref, "error_norm", norm):
                        return ref.fused_step(*args, **step_kw)

                ratio = step_checks.unfused_card(unfused)[1]
                check(all(torch.equal(r, ratio) for r in fused),
                      f"error_norm[wide f={f} tol={kind}]: the unfused card path's err_ratio "
                      f"differs bitwise from fused_step's")
                wide_ratio_cases += 1
    del w_err, w_y0, w_y1, wide
    emit("kernels", check="error_norm wide body", widths=dense_checks.NORM_WIDE_WIDTHS,
         rows=dense_checks.NORM_WIDE_ROWS, tolerances=dense_checks.TOL_KINDS,
         bitwise_to_warp_cases=wide_cases, fused_ratio_bitwise_cases=wide_ratio_cases)
    # fused_event_commit at every row class of its layout (a thread per
    # 16-byte chunk where the planes start 16-byte aligned and a row is whole
    # 16-byte words, entry by entry otherwise): event_checks.COMMIT_WIDTHS x
    # COMMIT_EVENTS, b = 37 rows detecting no crossing, one, all at one x (a
    # tied terminal one) or a random mix, the planes aligned or y_new / ev_y
    # one entry off; bitwise, ev_y in place.
    layouts = ("aligned", "y_new one entry off", "ev_y one entry off")
    for npdt in (np.float32, np.float64):
        for f in event_checks.COMMIT_WIDTHS:
            for E in event_checks.COMMIT_EVENTS:
                *cargs, flags = event_checks.to_torch(event_checks.commit_inputs(
                    f + E, 37, f, E, npdt, "mixed", rows="classes"), dev)
                want = ref.fused_event_commit(*cargs, terminal=flags)
                for layout in layouts:
                    a = list(cargs)
                    a[8] = (event_checks.unaligned(a[8]) if layout.startswith("ev_y")
                            else a[8].clone())
                    if layout.startswith("y_new"):
                        a[3] = event_checks.unaligned(a[3])
                    event_checks.assert_bitwise(
                        f"fused_event_commit[f={f} E={E} {npdt.__name__} {layout}]",
                        cuda_impl.fused_event_commit(*a, terminal=flags), want)
    emit("kernels", check="fused_event_commit row classes", b=37,
         widths=event_checks.COMMIT_WIDTHS, events=event_checks.COMMIT_EVENTS,
         rows="no crossing, one, all at one x (tie), random", layouts=layouts,
         bitwise_equal_to_plain=True)

    # The chord-Newton kernels at the stiff workloads' shapes (b = 1024; f =
    # 2 Van der Pol, 3 Robertson, 128 Allen-Cahn), float32 and float64, over
    # the cases of tools/newton_checks.py (a shuffled chord matrix, a zero
    # leading diagonal, tied pivots, NaN entries; mixed, all and no active
    # rows), each held to its plain version on the same card tensors by
    # newton_checks.hold: the LU to 1e-5 (float32) / 1e-12 (float64) of each
    # matrix's largest entry with the permutation equal, the rest to the same
    # tolerance relative to the plain output's largest entry (cuSOLVER and
    # the kernel eliminate in another order, so not bitwise), NaN rows
    # non-finite.  The card's unfused Newton iteration (batched_linsolve,
    # masked_newton_update) must equal its fused one (batched_lu_factor,
    # fused_newton_iter) bitwise.  fused_newton_iter gets the plain LU, so
    # both sides see the same factors.  Timed: the shuffled chord matrix
    # with mixed rows.  library_ms: torch.linalg.lu_factor (the same
    # factorization, with LAPACK pivots for a permutation) and
    # torch.linalg.solve.
    def lu_flops(f):
        return sum(m + 2 * m * m for m in range(1, f))  # divisions, then fmas

    def subst_flops(f):
        return 2 * f * (f - 1) + f

    def newton_bodies(f):
        """fused_newton_iter's bodies at width f: the column loop (the first
        design), the panel substitution, the warp body up to 32 columns."""
        return ("column", "panel") + (("warp",) if f <= cuda_impl.WARP_MAX_F else ())

    newton_held, body_ms = {}, {}
    for shape_name, f in (("vdp_stiff_mixed", 2), ("robertson_sweep", 3),
                          ("allen_cahn_full", workloads.ALLEN_CAHN["f"])):
        b = workloads.STIFF["b"]
        for npdt in (np.float32, np.float64):
            dtype = torch.float32 if npdt == np.float32 else torch.float64
            e = np.dtype(npdt).itemsize
            agg = newton_held.setdefault((shape_name, npdt.__name__),
                                         dict(cases=0, max_abs_err=0.0))
            for kind in newton_checks.KINDS:
                if (kind == "zero_diag" and f < 2) or (kind == "ties" and f < 3):
                    continue
                M, rhs, k, fk, mixed, scale = newton_checks.to_torch(
                    newton_checks.newton_inputs(f + len(kind), b, f, npdt, kind), dev)
                skip = newton_checks.nan_rows(M.cpu().numpy())
                keep = ~torch.as_tensor(skip, device=dev)
                lu_p, perm_p = ref.batched_lu_factor(M)
                lu_k, perm_k = cuda_impl.batched_lu_factor(M)
                newton_checks.lu_reconstructs(lu_k[keep], perm_k[keep], M[keep], dtype)
                for active in ("mixed", "all", "none"):
                    mask = {"mixed": mixed, "all": torch.ones_like(mixed),
                            "none": torch.zeros_like(mixed)}[active]
                    it_k = cuda_impl.fused_newton_iter(lu_p, perm_p, k, fk, mask, scale)
                    if skip.any():
                        check(not bool(torch.isfinite(it_k[1][~keep]).any()),
                              f"fused_newton_iter[{shape_name} {kind}]: a NaN row's "
                              "res_norm is finite")
                    unfused = cuda_impl.masked_newton_update(
                        k, cuda_impl.batched_linsolve(M, k - fk), mask, scale)
                    fused = cuda_impl.fused_newton_iter(lu_k, perm_k, k, fk, mask, scale)
                    check(all(torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
                              for a, c in zip(unfused, fused)),
                          f"newton[{shape_name} {npdt.__name__} {kind} {active}]: the "
                          "unfused iteration differs bitwise from the fused one")
                    # Every body fused_newton_iter has at this width gives the
                    # same bits (the warp body takes f <= 32).
                    for body in newton_bodies(f):
                        other = cuda_impl.fused_newton_iter(lu_k, perm_k, k, fk, mask, scale,
                                                            body=body)
                        check(all(torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
                                  for a, c in zip(fused, other)),
                              f"fused_newton_iter[{shape_name} {npdt.__name__} {kind} "
                              f"{active}]: the {body} body differs bitwise")
                    if kind == "chord" and active == "mixed":
                        body_ms[(shape_name, npdt.__name__)] = {
                            body: median_ms(lambda body=body, a=(lu_p, perm_p, k, fk, mask, scale):
                                            cuda_impl.fused_newton_iter(*a, body=body))
                            for body in newton_bodies(f)}

                    def hold_newton(name, got, want, _dtype, matrix=None, skip=skip):
                        got = got if isinstance(got, tuple) else (got,)
                        want = want if isinstance(want, tuple) else (want,)
                        worst = newton_checks.hold(name, got, want, npdt, matrix=matrix,
                                                   skip_rows=skip)
                        agg["cases"] += 1
                        agg["max_abs_err"] = max(agg["max_abs_err"], worst)
                        return worst, 0.0

                    it_args = (lu_p, perm_p, k, fk, mask, scale)
                    up_args = (k, rhs, mask, scale)
                    # (name, kernel, plain, library, bytes, operations, matrix)
                    cases = (
                        ("batched_lu_factor", lambda M=M: cuda_impl.batched_lu_factor(M),
                         lambda M=M: ref.batched_lu_factor(M),
                         lambda M=M: torch.linalg.lu_factor(M),
                         e * 2 * b * f * f + 4 * b * f, b * lu_flops(f), M),
                        ("batched_linsolve", lambda a=(M, rhs): cuda_impl.batched_linsolve(*a),
                         lambda a=(M, rhs): ref.batched_linsolve(*a),
                         lambda a=(M, rhs): torch.linalg.solve(*a),
                         e * (b * f * f + 2 * b * f), b * (lu_flops(f) + subst_flops(f)), None),
                        ("fused_newton_iter", lambda a=it_args: cuda_impl.fused_newton_iter(*a),
                         lambda a=it_args: ref.fused_newton_iter(*a),
                         None, e * (b * f * f + 4 * b * f + b) + 4 * b * f + b,
                         b * (subst_flops(f) + 6 * f), None),
                        ("masked_newton_update",
                         lambda a=up_args: cuda_impl.masked_newton_update(*a),
                         lambda a=up_args: ref.masked_newton_update(*a),
                         None, e * (4 * b * f + b) + b, 5 * b * f, None),
                    )
                    for name, run_k, run_p, run_lib, nbytes, flops, matrix in cases:
                        cmp = (lambda n, g, w, d, matrix=matrix, hn=hold_newton:
                               hn(n, g, w, d, matrix=matrix))
                        if kind == "chord" and active == "mixed":
                            measure(name, shape_name, dtype, f"{kind} active={active}", run_k,
                                    run_p, nbytes, flops, compare_fn=cmp, run_library=run_lib,
                                    held="newton_checks.hold")
                        else:
                            cmp(name, run_k(), run_p(), dtype)
    emit("kernels", check="newton kernels, all cases", tol={"float32": 1e-5, "float64": 1e-12},
         unfused_iteration_bitwise_equal_to_fused=True,
         cases={f"{k[0]}/{k[1]}": v for k, v in newton_held.items()})
    # masked_newton_update at the boundaries of its layout (a warp per row,
    # 128-column batches: newton_checks.UPDATE_WIDTHS), b = 37, every active
    # mask: held to its plain version by newton_checks.hold, and the unfused
    # iteration bitwise equal to fused_newton_iter (the same row norm).
    update_err = {}
    for npdt in (np.float32, np.float64):
        for f in newton_checks.UPDATE_WIDTHS:
            for active in ("mixed", "all", "none"):
                M, rhs, k, fk, mask, scale = newton_checks.to_torch(
                    newton_checks.newton_inputs(f + 700, 37, f, npdt, "chord", active), dev)
                worst = newton_checks.hold(
                    f"masked_newton_update[f={f} {active}]",
                    cuda_impl.masked_newton_update(k, rhs, mask, scale),
                    ref.masked_newton_update(k, rhs, mask, scale), npdt)
                update_err[npdt.__name__] = max(update_err.get(npdt.__name__, 0.0), worst)
                unfused = cuda_impl.masked_newton_update(
                    k, cuda_impl.batched_linsolve(M, k - fk), mask, scale)
                fused = cuda_impl.fused_newton_iter(*cuda_impl.batched_lu_factor(M), k, fk,
                                                    mask, scale)
                check(all(torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
                          for a, c in zip(unfused, fused)),
                      f"newton[f={f} {npdt.__name__} {active}]: the unfused iteration differs "
                      "bitwise from the fused one")
    emit("kernels", check="masked_newton_update widths", b=37,
         widths=newton_checks.UPDATE_WIDTHS, tol={"float32": 1e-5, "float64": 1e-12},
         max_abs_err=update_err, unfused_iteration_bitwise_equal_to_fused=True)
    # fused_newton_iter's bodies, each bitwise equal to the others on every
    # case above, timed side by side at the stiff shapes (chord, mixed rows):
    # the column loop is the first design's time.
    smem_limit = _build.load().rt_linalg_max_smem()
    for (shape_name, dt), ms in body_ms.items():
        f = {"vdp_stiff_mixed": 2, "robertson_sweep": 3}.get(shape_name, workloads.ALLEN_CAHN["f"])
        emit("kernels", check="fused_newton_iter bodies bitwise equal", kernel="fused_newton_iter",
             shape=shape_name, f=f, dtype=dt,
             chosen=cuda_impl.newton_iter_body(f, np.dtype(dt).itemsize, smem_limit),
             ms_by_body=ms)

    # The elimination staged in shared memory (the main path's at these
    # widths, cuda_impl.lu_path) against the device-memory one: factors,
    # permutation and linsolve solutions equal bit for bit over the cases of
    # tools/newton_checks.py.  The device-memory path is timed beside the
    # staged one at allen_cahn_full's shape: the earlier design's time.
    for shape_name, f in (("vdp_stiff_mixed", 2), ("robertson_sweep", 3),
                          ("allen_cahn_full", workloads.ALLEN_CAHN["f"])):
        b = workloads.STIFF["b"]
        for npdt in (np.float32, np.float64):
            timed = {}
            for kind in newton_checks.KINDS:
                if (kind == "zero_diag" and f < 2) or (kind == "ties" and f < 3):
                    continue
                M, rhs = newton_checks.to_torch(
                    newton_checks.newton_inputs(f + len(kind), b, f, npdt, kind), dev)[:2]
                for name, run in (
                        ("batched_lu_factor", lambda p, M=M: cuda_impl.batched_lu_factor(M, path=p)),
                        ("batched_linsolve",
                         lambda p, M=M, rhs=rhs: (cuda_impl.batched_linsolve(M, rhs, path=p),))):
                    staged, glob = run("staged"), run("global")
                    check(all(torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
                              for a, c in zip(staged, glob)),
                          f"{name}[{shape_name} {npdt.__name__} {kind}]: the staged elimination "
                          "differs bitwise from the device-memory one")
                    if kind == "chord" and f > 3:
                        timed[name] = {p: median_ms(lambda p=p, run=run: run(p))
                                       for p in ("staged", "global")}
            emit("kernels", check="staged elimination == device-memory elimination bitwise",
                 shape=shape_name, f=f, b=b, dtype=npdt.__name__, kinds=list(newton_checks.KINDS),
                 ms_by_path=timed or None)

    # The two substitution kernels above their old 48 KiB shared-memory limit
    # (ROADMAP C-8: they now opt in to the device's 227 KiB), float64, b = 4,
    # at f = 4096 and 8192 (chord matrices built on the card,
    # newton_checks.wide_inputs): the LU (from 1024 columns on eliminated
    # column by column over the whole card) with the plain permutation,
    # batched_linsolve and fused_newton_iter held to their plain versions at
    # 1e-12, the unfused iteration bitwise equal to the fused one.
    def wide_newton(f):
        M, rhs, k, fk, mask, scale = newton_checks.wide_inputs(f, 4, f, np.float64, dev)
        lu_p, perm_p = ref.batched_lu_factor(M)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu, perm = cuda_impl.batched_lu_factor(M)
        torch.cuda.synchronize()
        lu_s = time.perf_counter() - t0
        err = {"batched_lu_factor": newton_checks.hold(
            "batched_lu_factor", (lu, perm), (lu_p, perm_p), np.float64, matrix=M)}
        err["batched_linsolve"] = newton_checks.hold(
            "batched_linsolve", (cuda_impl.batched_linsolve(M, rhs),),
            (ref.batched_linsolve(M, rhs),), np.float64)
        it = cuda_impl.fused_newton_iter(lu_p, perm_p, k, fk, mask, scale)
        err["fused_newton_iter"] = newton_checks.hold(
            "fused_newton_iter", it, ref.fused_newton_iter(lu_p, perm_p, k, fk, mask, scale),
            np.float64)
        unfused = cuda_impl.masked_newton_update(k, cuda_impl.batched_linsolve(M, k - fk), mask,
                                                 scale)
        fused = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale)
        check(all(torch.equal(a, c) for a, c in zip(unfused, fused)),
              f"newton[wide f={f}]: the unfused iteration differs bitwise from the fused one")
        body = cuda_impl.newton_iter_body(f, 8, _build.load().rt_linalg_max_smem())
        seconds = {}
        for other in ("panel", "column"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale, body=other)
            torch.cuda.synchronize()
            seconds[other] = time.perf_counter() - t0
            check(all(torch.equal(a, c) for a, c in zip(got, fused)),
                  f"fused_newton_iter[wide f={f}]: the {other} body differs bitwise")
        emit("kernels", check="newton kernels above 48 KiB of shared memory (C-8)", b=4, f=f,
             dtype="float64", tol=1e-12, max_abs_err=err, permutation_equal=True,
             unfused_iteration_bitwise_equal_to_fused=True, lu_factor_seconds=lu_s,
             newton_iter_body=body, newton_iter_seconds_by_body=seconds,
             max_smem_bytes=_build.load().rt_linalg_max_smem())

    for f in (4096, 8192):
        wide_newton(f)

    # The attention kernel against its plain version on the same card
    # tensors (float32 at 2e-5, bfloat16 at 3e-2) over FLASH_CASES, then
    # timed at qwen2.5-14b's layer: the prefill the lm phase serves (b = 4,
    # sq = sk = 2048, H = 40, KV = 8, hd = 128, bf16; the summary's row) and
    # one long prefill (b = 1, sq = sk = 4096) in bf16 and float32.
    # bound: the causal area's operations (4 b H hd per visible query-key
    # pair) over the dtype's peak, or q, k, v and o over HBM, the larger.
    # library_ms: scaled_dot_product_attention(is_causal=True,
    # enable_gqa=True) on the same tensors in its (b, H, s, hd) layout.
    def hold_flash(name, got, want, dtype):
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    def flash_inputs(seed, b, sq, sk, H, KV, hd, dtype):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, sq, H, hd), (b, sk, KV, hd), (b, sk, KV, hd)))

    flash_held = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst, bodies = 0.0, {}
        for case in FLASH_CASES:
            b, sq, sk, H, KV, hd, causal, q_offset = case
            q, k, v = flash_inputs(sq * sk + hd, b, sq, sk, H, KV, hd, dtype)
            body = cuda_impl.flash_body(hd, dtype)
            before = cuda_impl.body_launches["flash_attention_fwd"][body]
            got = cuda_impl.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
            check(cuda_impl.body_launches["flash_attention_fwd"][body] == before + 1,
                  f"flash_attention_fwd[{case}]: the {body} body did not run")
            bodies[body] = bodies.get(body, 0) + 1
            want = ref.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                           q_chunk=32, kv_chunk=64)
            worst = max(worst, hold_flash(f"flash_attention_fwd[{case}]", got, want, dtype)[0])
        flash_held[str(dtype).split(".")[-1]] = dict(cases=len(FLASH_CASES), max_abs_err=worst,
                                                     bodies=bodies)
    emit("kernels", check="flash_attention_fwd, untimed cases", tol=FLASH_TOL,
         cases=flash_held)

    def visible_pairs(sq, sk, causal):
        return sum(min(sk, i + 1) for i in range(sq)) if causal else sq * sk

    def flash_timed(shape_name, b, s, dtype):
        H, KV, hd = 40, 8, 128  # qwen2.5-14b
        q, k, v = flash_inputs(s, b, s, s, H, KV, hd, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        e = q.element_size()
        measure("flash_attention_fwd", shape_name, dtype, f"b={b} s={s} H=40 KV=8 hd=128 causal",
                lambda: cuda_impl.flash_attention_fwd(q, k, v),
                lambda: ref.flash_attention_fwd(q, k, v, q_chunk=512, kv_chunk=1024),
                e * (2 * q.numel() + k.numel() + v.numel()),
                4 * b * H * hd * visible_pairs(s, s, True),
                compare_fn=hold_flash,
                run_library=lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                tol=FLASH_TOL[str(dtype).split(".")[-1]])

    flash_timed("qwen2.5-14b_prefill", 4, 2048, torch.bfloat16)
    flash_timed("qwen2.5-14b_long", 1, 4096, torch.bfloat16)
    flash_timed("qwen2.5-14b_long", 1, 4096, torch.float32)

    lap("kernels")
    # --------------------------------------------------------- 4. vdp_table3
    def reset_launches():
        for k in ops.launches:
            ops.launches[k] = 0
        for counts in cuda_impl.body_launches.values():
            for k in counts:
                counts[k] = 0

    def timed_solve(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_ivp(*args, **kw)
        torch.cuda.synchronize()
        return sol, (time.perf_counter() - t0) * 1e3

    def dense_bodies(label, f, launches):
        """Every error_norm and interp_eval launch of the solve just run on
        the body cuda_impl's helpers pick at width f."""
        got = {k: {body: c for body, c in cuda_impl.body_launches[k].items() if c}
               for k in ("error_norm", "interp_eval")}
        want = {"error_norm": {cuda_impl.error_norm_body(f): launches["error_norm"]},
                "interp_eval": {cuda_impl.interp_eval_body(f): launches["interp_eval"]}}
        want = {k: {body: c for body, c in v.items() if c} for k, v in want.items()}
        check(got == want, f"{label}: error_norm/interp_eval bodies {got} != {want}")
        return got

    def expected_launches(stages, iters, path="unfused", fsal=True, dense=True):
        """Launches of a solve of ``iters`` loop iterations.  ``path``:
        "unfused", "fused" (general vf) or "poly" (fused, polynomial vf)."""
        want = dict.fromkeys(ops.launches, 0)
        want["interp_eval"] = iters if dense else 0
        if path == "poly":
            want["fused_step_poly"] = iters
            return want
        want["stage_accum"] = (stages - 1) * iters
        if path == "fused":
            want["fused_step"] = iters
            want["fused_update"] = 0 if fsal else iters
        else:
            want["fused_update"] = want["error_norm"] = iters
        return want

    vf, y32, t32, kw = workloads.vdp_table3(np.float32)
    _, y64, t64, _ = workloads.vdp_table3(np.float64)
    main_path_launches = {}
    for method in ("dopri5", "tsit5"):
        kw["method"] = method
        solve_ivp(vf, y32, t32, device=dev, **kw)  # warm-up
        reset_launches()
        sol, wall = timed_solve(vf, y32, t32, device=dev, **kw)
        launches = dict(ops.launches)
        bodies = dense_bodies(f"vdp_table3/{method}", y32.shape[1], launches)
        card = convert.to_numpy(sol)
        iters = int(card.stats["n_steps"].max())
        want = expected_launches(7, iters)
        check(launches == want, f"vdp_table3/{method}: launches {launches} != {want}")
        check(bool((card.status == 0).all()), f"vdp_table3/{method}: status {card.status}")
        main_path_launches[f"vdp_table3/{method}"] = launches
        # float64, card against CPU: the same algorithm to rounding, so the
        # step counts are equal and ys agree to 1e-9.
        card64 = convert.to_numpy(solve_ivp(vf, y64, t64, device=dev, **kw))
        cpu64 = convert.to_numpy(solve_ivp(vf, y64, t64, device="cpu", **kw))
        check(np.array_equal(card64.stats["n_steps"], cpu64.stats["n_steps"])
              and np.array_equal(card64.status, cpu64.status),
              f"vdp_table3/{method}: float64 card and CPU step counts differ")
        d64 = float(np.abs(card64.ys - cpu64.ys).max())
        check(d64 <= 1e-9, f"vdp_table3/{method}: float64 card vs CPU ys differ by {d64}")
        # float32, card against CPU: rounding differs (fma, pow, summation
        # order), and at tol 1e-5 the embedded error estimate cancels to
        # ~1e-5 of the stage slopes, so a decision near err_ratio = 1 can
        # flip.  Held to: equal status, step counts within 10 %, and ys within
        # the float32 solve's own global error (its distance to a float64
        # solve at tol 1e-10), never looser than 1e-4.
        cpu = convert.to_numpy(solve_ivp(vf, y32, t32, device="cpu", **kw))
        truth = convert.to_numpy(solve_ivp(vf, y64, t64, device=dev, **{
            **kw, "atol": 1e-10, "rtol": 1e-10, "max_steps": 20000}))
        global_err = float(np.abs(card.ys - truth.ys).max())
        d32 = float(np.abs(card.ys - cpu.ys).max())
        dsteps = np.abs(card.stats["n_steps"].astype(int) - cpu.stats["n_steps"])
        same = dsteps == 0
        d32_same = float(np.abs(card.ys[same] - cpu.ys[same]).max()) if same.any() else 0.0
        check(np.array_equal(card.status, cpu.status), f"vdp_table3/{method}: status differs")
        check(np.all(dsteps <= np.ceil(0.1 * cpu.stats["n_steps"])),
              f"vdp_table3/{method}: step counts differ by up to {dsteps.max()}")
        check(d32 <= max(1e-4, global_err),
              f"vdp_table3/{method}: float32 ys differ by {d32} > {max(1e-4, global_err)}")
        emit("vdp_table3", method=method, dtype="float32", b=len(y32),
             mean_steps=float(card.stats["n_steps"].mean()), max_steps=iters, wall_ms=wall,
             ms_per_step=wall / iters, launches=launches, launches_expected=want,
             bodies=bodies, cpu_max_abs_diff=d32, global_err_vs_tol1e10=global_err,
             instances_equal_steps=int(same.sum()), max_abs_diff_equal_steps=d32_same,
             max_step_count_diff=int(dsteps.max()), float64_cpu_max_abs_diff=d64)

    lap("vdp_table3")
    # --------------------------------------------------------- 5. full_width
    vf, y0, te, kw = workloads.full_width(dev)
    b, n, f = len(y0), len(te), y0.shape[1]
    sub = convert.to_numpy(solve_ivp(vf, y0[:32], te, device=dev, **kw))
    solve_ivp(vf, y0, te, device=dev, **kw)  # warm-up at the full shape
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sol, wall = timed_solve(vf, y0, te, device=dev, **kw)
    launches = dict(ops.launches)
    bodies = dense_bodies("full_width", y0.shape[1], launches)
    main_path_launches["full_width"] = launches
    peak = torch.cuda.max_memory_allocated()
    full = convert.to_numpy(sol)
    iters = int(full.stats["n_steps"].max())
    want = expected_launches(7, iters)
    check(launches == want, f"full_width: launches {launches} != {want}")
    check(np.isfinite(full.ys).all() and full.ys.shape == (b, n, f) and (full.status == 0).all(),
          "full_width: output not finite, not of shape (b, n, f) or not SUCCESS")
    cpu_args = convert.from_numpy({k: v.cpu().numpy() for k, v in kw["args"].items()}, "cpu")
    sub_cpu = convert.to_numpy(solve_ivp(vf, y0[:32], te, device="cpu",
                                         **{**kw, "args": cpu_args}))
    indep = {}
    for label, other in (("card", sub), ("cpu", sub_cpu)):
        match = int((other.stats["n_steps"] == full.stats["n_steps"][:32]).sum())
        diff = float(np.abs(other.ys - full.ys[:32]).max())
        check(match >= 30 and diff <= 1e-3,
              f"full_width: rows 0-31 alone on the {label}: {match}/32 step counts match, "
              f"max ys diff {diff}")
        indep[label] = dict(steps_match_of_32=match, max_abs_diff=diff)
    emit("full_width", b=b, f=f, hidden=workloads.FULL["hidden"], n_eval=n, dtype="float32",
         mean_steps=float(full.stats["n_steps"].mean()), max_steps=iters, wall_ms=wall,
         ms_per_step=wall / iters, launches=launches, bodies=bodies,
         max_memory_allocated=peak,
         ys_bytes=b * n * f * 4, independence=indep)

    lap("full_width")
    # -------------------------------------------------------------- 6. fused
    # Float32 solves that are compared: equal status, per-instance step
    # counts within 10 %, ys within max(1e-4, the solve's own global error);
    # float64: equal step counts, ys within 1e-9.  Every fused solve has
    # n_fused_steps == n_steps and exact launch counts.
    def hold_f32(label, got, want, global_err):
        dsteps = np.abs(got.stats["n_steps"].astype(int) - want.stats["n_steps"])
        d = float(np.abs(got.ys - want.ys).max())
        check(np.array_equal(got.status, want.status), f"{label}: status differs")
        check(np.all(dsteps <= np.ceil(0.1 * want.stats["n_steps"])),
              f"{label}: step counts differ by up to {dsteps.max()}")
        check(d <= max(1e-4, global_err), f"{label}: ys differ by {d} > "
              f"{max(1e-4, global_err)}")
        return dict(max_abs_diff=d, global_err=global_err,
                    instances_equal_steps=int((dsteps == 0).sum()),
                    bitwise_equal=bool(np.array_equal(got.ys, want.ys)
                                       and np.array_equal(got.stats["n_steps"],
                                                          want.stats["n_steps"])))

    def step_bodies(label, n, f, itemsize=4):
        """fused_step's launches by body since the last reset: all ``n`` must
        have taken the body ``fused_step_body`` picks at width ``f``."""
        bodies = dict(cuda_impl.body_launches["fused_step"])
        body = cuda_impl.fused_step_body(f, itemsize, _build.load().rt_fused_step_max_smem())
        check(bodies[body] == n and sum(bodies.values()) == n,
              f"{label}: fused_step bodies {bodies}, want {n} {body}")
        return bodies

    def fused_solve(label, path, stages, *args, fsal=True, **kw):
        """A fused solve on the card with exact launch counts, every
        fused_step launch on the body fused_step_body picks; returns the
        numpy solution, its wall time and its launches."""
        dense = kw.get("dense", True) and len(args) > 2 and args[2] is not None
        solve_ivp(*args, device=dev, fused=True, **kw)  # warm-up
        reset_launches()
        sol, wall = timed_solve(*args, device=dev, fused=True, **kw)
        launches = dict(ops.launches)
        out = convert.to_numpy(sol)
        iters = int(out.stats["n_steps"].max())
        want = expected_launches(stages, iters, path, fsal=fsal, dense=dense)
        check(launches == want, f"{label}: launches {launches} != {want}")
        check(np.array_equal(out.stats["n_fused_steps"], out.stats["n_steps"])
              and int(out.stats["fused_fallback_reason"].max()) == 0,
              f"{label}: the fused path did not run every step")
        fused_step_bodies[label] = step_bodies(label, launches["fused_step"],
                                               args[1].shape[1], args[1].itemsize)
        return out, wall, launches

    fused_step_bodies = {}  # fused_step's launches by body, per fused solve

    # 6a. vdp_table3, dopri5 and tsit5, float32 and float64.
    vf, y32, t32, kw = workloads.vdp_table3(np.float32)
    _, y64, t64, _ = workloads.vdp_table3(np.float64)
    for method in ("dopri5", "tsit5"):
        kw["method"] = method
        f64, _, _ = fused_solve(f"fused/vdp_table3/{method}/float64", "fused", 7,
                                vf, y64, t64, **kw)
        u64 = convert.to_numpy(solve_ivp(vf, y64, t64, device=dev, **kw))
        check(np.array_equal(f64.stats["n_steps"], u64.stats["n_steps"])
              and np.array_equal(f64.status, u64.status),
              f"fused/vdp_table3/{method}: float64 fused and unfused step counts differ")
        d64 = float(np.abs(f64.ys - u64.ys).max())
        check(d64 <= 1e-9, f"fused/vdp_table3/{method}: float64 fused vs unfused {d64}")
        f32, wall, launches = fused_solve(f"fused/vdp_table3/{method}", "fused", 7,
                                          vf, y32, t32, **kw)
        u32, uwall = timed_solve(vf, y32, t32, device=dev, **kw)
        u32 = convert.to_numpy(u32)
        cpu = convert.to_numpy(solve_ivp(vf, y32, t32, device="cpu", fused=True, **kw))
        truth = convert.to_numpy(solve_ivp(vf, y64, t64, device=dev, **{
            **kw, "atol": 1e-10, "rtol": 1e-10, "max_steps": 20000}))
        iters, uiters = int(f32.stats["n_steps"].max()), int(u32.stats["n_steps"].max())
        emit("fused", workload="vdp_table3", method=method, dtype="float32",
             max_steps=iters, ms_per_step=wall / iters, unfused_ms_per_step=uwall / uiters,
             launches=launches,
             fused_step_body_launches=fused_step_bodies[f"fused/vdp_table3/{method}"],
             float64_unfused_max_abs_diff=d64,
             float64_bitwise_equal=bool(np.array_equal(f64.ys, u64.ys)),
             vs_cpu_fused=hold_f32(f"fused/vdp_table3/{method} card vs CPU", f32, cpu,
                                   float(np.abs(f32.ys - truth.ys).max())),
             vs_unfused_card=hold_f32(f"fused/vdp_table3/{method} fused vs unfused", f32,
                                      u32, float(np.abs(u32.ys - truth.ys).max())))

    # 6b. full_width: fused against unfused on the card, and rows 0-31
    # alone.  The global error is taken on rows 0-31 against a float64
    # solve at tol 1e-9.
    vf, y0, te, kw = workloads.full_width(dev)
    ffull, wall, launches = fused_solve("fused/full_width", "fused", 7, vf, y0, te, **kw)
    main_path_launches["fused/full_width"] = launches
    check(fused_step_bodies["fused/full_width"]["row"] == launches["fused_step"] > 0,
          f"fused/full_width: fused_step bodies {fused_step_bodies['fused/full_width']}, not "
          "every launch on the row body")
    args64 = {k: v.double() for k, v in kw["args"].items()}
    truth = convert.to_numpy(solve_ivp(vf, y0[:32].astype(np.float64), te.astype(np.float64),
                                       device=dev, **{**kw, "args": args64, "atol": 1e-9,
                                                      "rtol": 1e-9}))
    vs = hold_f32("fused/full_width fused vs unfused", ffull, full,
                  float(np.abs(full.ys[:32] - truth.ys).max()))
    sub = convert.to_numpy(solve_ivp(vf, y0[:32], te, device=dev, fused=True, **kw))
    match = int((sub.stats["n_steps"] == ffull.stats["n_steps"][:32]).sum())
    diff = float(np.abs(sub.ys - ffull.ys[:32]).max())
    check(match >= 30 and diff <= 1e-3, f"fused/full_width: rows 0-31 alone: {match}/32 "
          f"step counts match, max ys diff {diff}")
    iters = int(ffull.stats["n_steps"].max())
    emit("fused", workload="full_width", method="dopri5", dtype="float32", max_steps=iters,
         ms_per_step=wall / iters, launches=launches,
         fused_step_body_launches=fused_step_bodies["fused/full_width"], vs_unfused_card=vs,
         independence=dict(steps_match_of_32=match, max_abs_diff=diff))

    # 6c. The JAX package's fused workload (benchmarks/step_bench.py):
    # dy/dt = -y by polynomial_term, t in [0, 2], rtol 1e-4, atol 1e-6, dense
    # output off, y0 = linspace(0.5, 1.5), here at b = 1024, f = 784.  Held
    # to the unfused card run and to the closed form y0 * exp(-t).
    decay, yb, _, bench_kw = workloads.step_bench()
    b, f = yb.shape
    for method, ctl, dt0 in (("dopri5", pid_controller(), None),
                             ("heun", pid_controller(), None),
                             ("rk4", FixedController(), 0.01)):
        tab = get_tableau(method)
        skw = dict(bench_kw, method=method, controller=ctl, dt0=dt0)
        fsol, wall, launches = fused_solve(f"fused/step_bench/{method}", "poly", tab.stages,
                                           decay, yb, **skw)
        bodies = dict(cuda_impl.body_launches["fused_step_poly"])
        check(sum(launches.values()) == launches["fused_step_poly"],
              f"fused/step_bench/{method}: a kernel other than fused_step_poly launched")
        check(bodies["row"] == launches["fused_step_poly"],
              f"fused/step_bench/{method}: fused_step_poly's bodies {bodies}, not every launch "
              "on the row body")
        usol, uwall = timed_solve(decay, yb, device=dev, **skw)
        usol = convert.to_numpy(usol)
        exact = yb * np.exp(-2.0)
        vs = hold_f32(f"fused/step_bench/{method} fused vs unfused", fsol, usol,
                      float(np.abs(usol.ys - exact).max()))
        if method == "dopri5":
            main_path_launches["fused/step_bench"] = launches
        iters, uiters = int(fsol.stats["n_steps"].max()), int(usol.stats["n_steps"].max())
        emit("fused", workload="step_bench", method=method, b=b, f=f, dtype="float32",
             max_steps=iters, ms_per_step=wall / iters, unfused_ms_per_step=uwall / uiters,
             launches=launches, fused_step_poly_body_launches=bodies, vs_unfused_card=vs,
             exact_max_abs_err=float(np.abs(fsol.ys - exact).max()))
    # Per-feature rates with dense output on.
    rates = -np.linspace(0.5, 1.5, f)
    term = polynomial_term(0.0, rates)
    te = np.linspace(0.0, 2.0, 16, dtype=np.float32)
    skw = dict(method="dopri5", controller=pid_controller(), rtol=1e-4, atol=1e-6)
    fsol, wall, launches = fused_solve("fused/step_bench/per_feature_dense", "poly", 7, term,
                                       yb, te, **skw)
    bodies = dict(cuda_impl.body_launches["fused_step_poly"])
    check(bodies["row"] == launches["fused_step_poly"],
          f"fused/step_bench/per_feature_dense: fused_step_poly's bodies {bodies}, not every "
          "launch on the row body")
    usol = convert.to_numpy(solve_ivp(term, yb, te, device=dev, **skw))
    exact = yb[:, None, :] * np.exp(rates[None, None, :] * te[None, :, None])
    vs = hold_f32("fused/step_bench/per_feature_dense fused vs unfused", fsol, usol,
                  float(np.abs(usol.ys - exact).max()))
    emit("fused", workload="step_bench", method="dopri5", case="per-feature, dense",
         max_steps=int(fsol.stats["n_steps"].max()), launches=launches,
         fused_step_poly_body_launches=bodies, vs_unfused_card=vs,
         exact_max_abs_err=float(np.abs(fsol.ys - exact).max()))

    # 6d. full_width_long, unfused then fused: the per-step cost at a real
    # step count.
    vf, y0, te, kw = workloads.full_width_long(dev)
    long_runs = {}
    for path in ("unfused", "fused"):
        fused = path == "fused"
        solve_ivp(vf, y0, te, device=dev, fused=fused, **kw)  # warm-up
        reset_launches()
        sol, wall = timed_solve(vf, y0, te, device=dev, fused=fused, **kw)
        launches = dict(ops.launches)
        out = convert.to_numpy(sol)
        iters = int(out.stats["n_steps"].max())
        want = expected_launches(7, iters, path)
        check(launches == want, f"full_width_long/{path}: launches {launches} != {want}")
        bodies = step_bodies(f"full_width_long/{path}", want["fused_step"], y0.shape[1])
        check(bodies["row"] == want["fused_step"],
              f"full_width_long/{path}: fused_step bodies {bodies}, not every launch on the "
              "row body")
        check(np.isfinite(out.ys).all() and (out.status == 0).all(),
              f"full_width_long/{path}: output not finite or not SUCCESS")
        long_runs[path] = out
        emit("fused", workload="full_width_long", path=path, dtype="float32",
             weight_scale=workloads.LONG["weight_scale"], t_end=workloads.LONG["t_end"],
             max_steps=iters, mean_steps=float(out.stats["n_steps"].mean()),
             mean_accepted=float(out.stats["n_accepted"].mean()), wall_ms=wall,
             ms_per_step=wall / iters, launches=launches, fused_step_body_launches=bodies)
    check(np.array_equal(long_runs["fused"].stats["n_fused_steps"],
                         long_runs["fused"].stats["n_steps"]),
          "full_width_long: the fused path did not run every step")
    args64 = {k: v.double() for k, v in kw["args"].items()}
    truth = convert.to_numpy(solve_ivp(vf, y0[:32].astype(np.float64), te.astype(np.float64),
                                       device=dev, **{**kw, "args": args64, "atol": 1e-9,
                                                      "rtol": 1e-9}))
    emit("fused", workload="full_width_long", vs_unfused_card=hold_f32(
        "full_width_long fused vs unfused", long_runs["fused"], long_runs["unfused"],
        float(np.abs(long_runs["unfused"].ys[:32] - truth.ys).max())))

    lap("fused")
    # ----------------------------------------------------------- 7. compiled
    compiled_phase(dev, smi, reset_launches, expected_launches)

    lap("compiled")
    # ------------------------------------------------------------- 8. events
    # Each solve: a warm-up, then a timed run with exact launch counts --
    # detect and commit once per loop iteration, masked_bisect_refine a
    # multiple of event_bisect_iters + 1 (a bisection per event that fired
    # somewhere in a step), at most that times E per iteration, the other
    # kernels as without events (the coefficients are built on every step).
    def event_solve(label, f, y0, te, kw, fused):
        solve_ivp(f, y0, te, device=dev, fused=fused, **kw)  # warm-up
        reset_launches()
        sol, wall = timed_solve(f, y0, te, device=dev, fused=fused, **kw)
        launches = dict(ops.launches)
        out = convert.to_numpy(sol)
        iters = int(out.stats["n_steps"].max())
        want = expected_launches(7, iters, "fused" if fused else "unfused",
                                 dense=te is not None and kw.get("dense", True))
        want["fused_event_detect"] = want["fused_event_commit"] = iters
        bis = launches["masked_bisect_refine"]
        want["masked_bisect_refine"] = bis
        per = kw.get("event_bisect_iters", 30) + 1
        n_events = len(kw["events"]) if isinstance(kw["events"], tuple) else 1
        check(launches == want, f"{label}: launches {launches} != {want}")
        check(bis % per == 0 and bis <= per * n_events * iters
              and (bis > 0) == bool(out.stats["n_events"].any()),
              f"{label}: {bis} masked_bisect_refine launches, {iters} iterations")
        if fused:
            check(np.array_equal(out.stats["n_fused_steps"], out.stats["n_steps"]),
                  f"{label}: the fused path did not run every step")
        return out, wall, launches, iters

    def same_bits(a, b):
        """Solutions equal bit for bit (NaN where NaN; stats both have)."""
        fields = ("ts", "ys", "status", "event_t", "event_y", "event_mask")
        return (all(np.array_equal(getattr(a, k), getattr(b, k), equal_nan=k == "event_t")
                    for k in fields)
                and all(np.array_equal(a.stats[k], b.stats[k]) for k in a.stats
                        if k in b.stats))

    def card_vs_cpu64(label, f, y0, te, kw):
        """float64: the card takes the CPU's steps and records its events."""
        card = convert.to_numpy(solve_ivp(f, y0, te, device=dev, **kw))
        cpu = convert.to_numpy(solve_ivp(f, y0, te, device="cpu", **kw))
        check(all(np.array_equal(card.stats[k], cpu.stats[k]) for k in cpu.stats)
              and np.array_equal(card.status, cpu.status)
              and np.array_equal(card.event_mask, cpu.event_mask),
              f"{label}: float64 card and CPU steps, status or event_mask differ")
        diff = max(float(np.nan_to_num(np.abs(card.event_t - cpu.event_t)).max()),
                   float(np.abs(card.event_y - cpu.event_y).max()),
                   float(np.abs(card.ys - cpu.ys).max()))
        check(np.array_equal(np.isnan(card.event_t), np.isnan(cpu.event_t)) and diff <= 1e-9,
              f"{label}: float64 card vs CPU differ by {diff}")
        return diff

    # 8a. ball_terminal: every instance stops at its own impact time.
    f, y0, te, kw = workloads.ball_terminal(np.float32)
    runs = {}
    for fused in (False, True):
        path = "fused" if fused else "unfused"
        out, wall, launches, iters = event_solve(f"events/ball_terminal/{path}", f, y0, te,
                                                 kw, fused)
        runs[path] = out
        err = float(np.abs(out.event_t[:, 0] - np.sqrt(2.0 * y0[:, 0] / workloads.BALL["g"]))
                    .max())
        check(bool((out.status == 4).all()) and err <= 10 * kw["rtol"],
              f"events/ball_terminal/{path}: status {np.bincount(out.status)}, "
              f"max |event_t - analytic| {err}")
        emit("events", workload="ball_terminal", path=path, dtype="float32", b=len(y0),
             max_steps=iters, wall_ms=wall, ms_per_step=wall / iters, launches=launches,
             max_abs_event_t_err=err, bound=10 * kw["rtol"])
    check(same_bits(runs["fused"], runs["unfused"]),
          "events/ball_terminal: fused and unfused card solves differ")
    f, y64, te, kw = workloads.ball_terminal(np.float64)
    emit("events", workload="ball_terminal", check="fused == unfused bitwise, float32",
         float64_card_vs_cpu_max_abs_diff=card_vs_cpu64("events/ball_terminal", f, y64, te, kw))

    # 8b. vdp_marker: the marker adds zero vector-field evaluations; ms per
    # step with and without it.
    f, y0, te, kw = workloads.vdp_marker(np.float32)
    plain_kw = {k: v for k, v in kw.items() if k != "events"}
    runs = {}
    for fused in (False, True):
        path = "fused" if fused else "unfused"
        out, wall, launches, iters = event_solve(f"events/vdp_marker/{path}", f, y0, te, kw,
                                                 fused)
        runs[path] = out
        solve_ivp(f, y0, te, device=dev, fused=fused, **plain_kw)  # warm-up
        plain, pwall = timed_solve(f, y0, te, device=dev, fused=fused, **plain_kw)
        plain = convert.to_numpy(plain)
        piters = int(plain.stats["n_steps"].max())
        check(np.array_equal(plain.stats["n_f_evals"], out.stats["n_f_evals"])
              and np.array_equal(plain.ys, out.ys),
              f"events/vdp_marker/{path}: the marker changed the solve")
        emit("events", workload="vdp_marker", path=path, dtype="float32", b=len(y0),
             max_steps=iters, n_events=int(out.stats["n_events"].sum()), launches=launches,
             ms_per_step=wall / iters, ms_per_step_without_events=pwall / piters,
             marker_overhead=(wall / iters) / (pwall / piters) - 1.0,
             zero_extra_vf_evals=True)
    check(same_bits(runs["fused"], runs["unfused"]),
          "events/vdp_marker: fused and unfused card solves differ")
    f, y64, te, kw = workloads.vdp_marker(np.float64)
    emit("events", workload="vdp_marker", check="fused == unfused bitwise, float32",
         float64_card_vs_cpu_max_abs_diff=card_vs_cpu64("events/vdp_marker", f, y64, te, kw))

    # 8c. full_width_long_events: the RMS stop and the y[:, 0] marker at
    # b = 1024, f = 784, unfused and fused.
    f, y0, te, kw = workloads.full_width_long_events(dev)
    runs = {}
    for fused in (False, True):
        path = "fused" if fused else "unfused"
        out, wall, launches, iters = event_solve(f"events/full_width_long_events/{path}", f,
                                                 y0, te, kw, fused)
        runs[path] = out
        main_path_launches[f"events/full_width_long_events/{path}"] = launches
        share = float((out.status == 4).mean())
        check(np.isfinite(out.ys).all() and bool(np.isin(out.status, (0, 4)).all())
              and 0.25 <= share <= 0.75,
              f"events/full_width_long_events/{path}: EVENT share {share}, status "
              f"{np.bincount(out.status)}")
        emit("events", workload="full_width_long_events", path=path, dtype="float32",
             b=len(y0), rms_threshold=workloads.EVENTS_LONG["rms_threshold"],
             event_share=share, marker_share=float(out.event_mask[:, 1].mean()),
             max_steps=iters, mean_steps=float(out.stats["n_steps"].mean()), wall_ms=wall,
             ms_per_step=wall / iters, launches=launches)
    check(same_bits(runs["fused"], runs["unfused"]),
          "events/full_width_long_events: fused and unfused card solves differ")
    emit("events", workload="full_width_long_events", check="fused == unfused bitwise")

    lap("events")
    # ------------------------------------------------------------- 9. stiff
    # The stiff workloads (tools/workloads.py; kvaerno5, the default PID
    # controller, float32, b = 1024), unfused then fused, each timed after a
    # warm-up with exact launch counts: every batched Newton iteration is
    # one batched_linsolve and one masked_newton_update (unfused) or one
    # fused_newton_iter (fused, after one batched_lu_factor per step
    # attempt).  kvaerno5's first stage is the cache f0 and the Newton
    # iterations are its only further evaluations, so the iterations are
    # n_f_evals - 2 (the initial f0 and the initial-step probe).
    jax_cpu = {  # the JAX package on a CPU, float32 (small batches; not a check)
        "vdp_stiff_mixed": dict(b=8, t_end=2.0, loop_iterations=13,
                                n_newton_iters_per_row=[131, 195], n_jac_evals_per_row=[1, 6],
                                n_f_evals=417),
        "robertson_sweep": dict(b=2, t_end=100.0, loop_iterations=25, n_newton_iters_per_row=589,
                                n_jac_evals_per_row=17, n_f_evals=591),
        "allen_cahn_full": dict(b=4, f=128, t_end=5.0, loop_iterations=20,
                                n_newton_iters_per_row=[316, 329], n_jac_evals_per_row=[3, 5],
                                n_f_evals=335),
    }

    def stiff_launches(iters, newton, fused):
        want = dict.fromkeys(ops.launches, 0)
        want["stage_accum"] = 6 * iters  # stages 1..6 start from stage_accum
        if fused:
            want.update(batched_lu_factor=iters, fused_newton_iter=newton, fused_step=iters)
        else:
            want.update(batched_linsolve=newton, masked_newton_update=newton,
                        fused_update=iters, error_norm=iters)
        return want

    def stiff_equal(a, c, skip=()):
        """Solutions equal bit for bit in ts, ys, status and every shared
        statistic but ``skip``."""
        return (all(np.array_equal(getattr(a, k), getattr(c, k)) for k in ("ts", "ys", "status"))
                and all(np.array_equal(a.stats[k], c.stats[k]) for k in a.stats
                        if k in c.stats and k not in skip))

    def rows_of(kw, n):
        """``kw`` with a per-row ``args`` array cut to its first n rows."""
        args = kw.get("args")
        return {**kw, "args": args[:n]} if isinstance(args, np.ndarray) else kw

    def spread(x):
        return dict(mean=float(x.mean()), max=int(x.max()), min=int(x.min()))

    for name in ("vdp_stiff_mixed", "robertson_sweep", "allen_cahn_full"):
        vf, y0, te, kw = getattr(workloads, name)(np.float32)
        solve_ivp(vf, y0, te, device=dev, **kw)  # warm-up
        runs = {}
        for path in ("unfused", "fused"):
            fused = path == "fused"
            reset_launches()
            sol, wall = timed_solve(vf, y0, te, device=dev, fused=fused, **kw)
            launches = dict(ops.launches)
            out = convert.to_numpy(sol)
            iters = int(out.stats["n_steps"].max())
            newton = int(out.stats["n_f_evals"][0]) - 2
            want = stiff_launches(iters, newton, fused)
            check(launches == want, f"stiff/{name}/{path}: launches {launches} != {want}")
            # Every elimination of these widths is the staged one.
            lu_op = "batched_lu_factor" if fused else "batched_linsolve"
            paths = dict(cuda_impl.body_launches[lu_op])
            check(paths["staged"] == want[lu_op] and sum(paths.values()) == want[lu_op],
                  f"stiff/{name}/{path}: {lu_op} paths {paths}, want {want[lu_op]} staged")
            # Every fused iteration took the body newton_iter_body picks:
            # the panel substitution at allen_cahn_full, the warp body at f
            # = 2, 3.
            bodies = dict(cuda_impl.body_launches["fused_newton_iter"])
            body = cuda_impl.newton_iter_body(y0.shape[1], 4, _build.load().rt_linalg_max_smem())
            check(bodies[body] == want["fused_newton_iter"]
                  and sum(bodies.values()) == want["fused_newton_iter"],
                  f"stiff/{name}/{path}: fused_newton_iter bodies {bodies}, want "
                  f"{want['fused_newton_iter']} {body}")
            step_body = step_bodies(f"stiff/{name}/{path}", want["fused_step"], y0.shape[1])
            check(bool((out.status == 0).all()) and np.isfinite(out.ys).all(),
                  f"stiff/{name}/{path}: status {np.bincount(out.status)}")
            runs[path] = out
            main_path_launches[f"stiff/{name}/{path}"] = launches
            emit("stiff", workload=name, path=path, dtype="float32", b=len(y0), f=y0.shape[1],
                 status_counts=np.bincount(out.status, minlength=5).tolist(),
                 loop_iterations=iters, n_steps=spread(out.stats["n_steps"]),
                 n_newton_iters=spread(out.stats["n_newton_iters"]),
                 n_jac_evals=spread(out.stats["n_jac_evals"]),
                 n_f_evals=int(out.stats["n_f_evals"][0]), wall_ms=wall,
                 ms_per_step=wall / iters, launches=launches, elimination_paths=paths,
                 newton_iter_bodies=bodies, fused_step_body_launches=step_body)
        check(stiff_equal(runs["fused"], runs["unfused"]),
              f"stiff/{name}: fused and unfused card solves differ")
        # Per-instance independence, now with per-row Newton masks: rows
        # 0-31 alone take the same steps, iterations and values, bit for
        # bit; only n_f_evals (the batch's overhanging evaluations) differs.
        for path in ("unfused", "fused"):
            sub = convert.to_numpy(solve_ivp(vf, y0[:32], te, device=dev, fused=path == "fused",
                                             **rows_of(kw, 32)))
            full = runs[path]
            check(all(np.array_equal(getattr(sub, k), getattr(full, k)[:32])
                      for k in ("ts", "ys", "status"))
                  and all(np.array_equal(sub.stats[k], full.stats[k][:32]) for k in sub.stats
                          if k != "n_f_evals"),
                  f"stiff/{name}/{path}: rows 0-31 alone differ from the batch's")
        # float64: the card takes the CPU's steps, iterations and Jacobian
        # evaluations on rows 0-7, values within 1e-9.
        _, y64, _, kw64 = getattr(workloads, name)(np.float64)
        kw64 = rows_of(kw64, 8)
        cpu64 = convert.to_numpy(solve_ivp(vf, y64[:8], te, device="cpu", **kw64))
        diffs = {}
        for path in ("unfused", "fused"):
            card64 = convert.to_numpy(solve_ivp(vf, y64[:8], te, device=dev,
                                                fused=path == "fused", **kw64))
            check(np.array_equal(card64.status, cpu64.status)
                  and all(np.array_equal(card64.stats[k], cpu64.stats[k]) for k in cpu64.stats),
                  f"stiff/{name}/{path}: float64 card and CPU counts differ")
            diffs[path] = float(np.abs(card64.ys - cpu64.ys).max())
            check(diffs[path] <= 1e-9, f"stiff/{name}/{path}: float64 card vs CPU {diffs[path]}")
        ref_cpu = jax_cpu[name]
        emit("stiff", workload=name, check="fused == unfused bitwise; rows 0-31 alone bitwise",
             float64_card_vs_cpu_rows_0_7_max_abs_diff=diffs,
             mean_steps=float(runs["unfused"].stats["n_steps"].mean()),
             max_steps=int(runs["unfused"].stats["n_steps"].max()),
             jax_cpu_float32=ref_cpu,
             mean_steps_over_jax_loop_iterations=float(runs["unfused"].stats["n_steps"].mean())
             / ref_cpu["loop_iterations"])

    lap("stiff")
    # The examples phase's CPU runs and the dryrun phase's counts, in a
    # process of their own from here on (the card's phases leave the host's
    # other cores idle); read at the examples phase.
    cpu_started = start_cpu_side()
    # ---------------------------------------------------------------- 10. lm
    # The LM serving path (repro_torch.models, launch/serve).  (a) Reduced
    # qwen2.5-14b and stablelm-3b in float32, the same weights (drawn on the
    # CPU from seed 0) on the card and on the CPU: prefill logits and four
    # decode steps within 1e-4, prefill(s) + decode_step(token s) within 1e-4
    # of prefill(s + 1), one flash launch per layer per prefill and none per
    # decode step.
    torch.cuda.empty_cache()
    for arch in ("qwen2.5-14b", "stablelm-3b"):
        cfg = get_config(arch, reduced=True)
        cpu_lm = LM(cfg, device="cpu", seed=0)
        card_lm = LM(cfg, device=dev)
        card_lm.load_state_dict(cpu_lm.state_dict())
        tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 45)))
        reset_launches()
        lg, cache = card_lm.prefill({"tokens": tok[:, :37].to(dev)})
        check(ops.launches["flash_attention_fwd"] == cfg.n_layers,
              f"lm/{arch}: {ops.launches['flash_attention_fwd']} flash launches per prefill")
        lg_cpu, cache_cpu = cpu_lm.prefill({"tokens": tok[:, :37]})
        diffs = [float((lg.cpu() - lg_cpu).abs().max())]
        cache, cache_cpu = card_lm.pad_cache(cache, 41), cpu_lm.pad_cache(cache_cpu, 41)
        for i in range(4):
            pos = torch.full((2,), 37 + i)
            lg, cache = card_lm.decode_step(tok[:, 37 + i].to(dev), pos.to(dev), cache)
            lg_cpu, cache_cpu = cpu_lm.decode_step(tok[:, 37 + i], pos, cache_cpu)
            diffs.append(float((lg.cpu() - lg_cpu).abs().max()))
        check(ops.launches["flash_attention_fwd"] == cfg.n_layers,
              f"lm/{arch}: a decode step launched the flash kernel")
        # the last decode step saw tokens 0..40: prefill(tokens[:, :41])
        full_lg, _ = card_lm.prefill({"tokens": tok[:, :41].to(dev)})
        consistency = float((lg - full_lg).abs().max())
        check(max(diffs) <= 1e-4 and consistency <= 1e-4,
              f"lm/{arch}: card vs cpu {diffs}, prefill/decode consistency {consistency}")
        emit("lm", arch=cfg.name, dtype="float32", b=2, prompt=37, decode_steps=4,
             card_vs_cpu_max_abs_diff=diffs, decode_vs_prefill_max_abs_diff=consistency,
             flash_launches_per_prefill=cfg.n_layers)
        del cpu_lm, card_lm, cache, cache_cpu

    # (b) Full-width qwen2.5-14b in bf16, weights drawn on the card from seed
    # 0: serve.run at batch 4, prompt 2048, 32 generated tokens -- one
    # prefill (48 flash launches) and 31 decode steps (none) -- every logit
    # finite.  Then through the whole stack: prefill(s) + decode_step(token
    # s) against prefill(s + 1) (the kernel against the plain decode
    # attention), and the prefill with the kernel against the same prefill
    # with the plain attention on the card, both held to 0.1 of the logits'
    # RMS (||a - b|| / ||b||: bf16 rounding through 48 layers, where a
    # mask, scale or head-mapping fault moves the logits by their own size).
    cfg = get_config("qwen2.5-14b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve_args = argparse.Namespace(arch="qwen2.5-14b", reduced=False, batch=4,
                                    prompt_len=2048, gen=32, seed=0, model_parallel=1,
                                    device="cuda")
    # warm-up (kernels built, cuBLAS plans made): one prefill, one decode step
    serve.run(argparse.Namespace(**{**vars(serve_args), "gen": 2}), model=lm)
    finite = {"all": torch.ones((), dtype=torch.bool, device=dev), "steps": 0}

    def record(step, logits):
        finite["all"] &= torch.isfinite(logits).all()
        finite["steps"] += 1

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.run(serve_args, model=lm, record=record)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    main_path_launches["lm/serve"] = launches
    measured["lm/serve"] = dict(prefill_ms=out["prefill_s"] * 1e3,
                                max_memory_allocated=peak)
    want = dict.fromkeys(ops.launches, 0)
    want["flash_attention_fwd"] = cfg.n_layers
    check(launches == want, f"lm/serve: launches {launches} != {want} (48 per prefill, 0 per "
          "decode step)")
    bodies = dict(cuda_impl.body_launches["flash_attention_fwd"])
    check(bodies == {"wgmma": cfg.n_layers, "ffma": 0},
          f"lm/serve: flash bodies {bodies}, want every launch on the wgmma body")
    check(bool(finite["all"]) and finite["steps"] == serve_args.gen,
          "lm/serve: a logit is not finite")
    b, plen, gen = serve_args.batch, serve_args.prompt_len, serve_args.gen
    emit("lm", arch=cfg.name, dtype=cfg.dtype, b=b, prompt=plen, gen=gen,
         params=param_count(lm), init_s=init_s, prefill_ms=out["prefill_s"] * 1e3,
         decode_ms_per_token=out["decode_s"] * 1e3 / (gen - 1),
         tokens_per_s=(gen - 1) * b / out["decode_s"],
         prefill_tokens_per_s=b * plen / out["prefill_s"], max_memory_allocated=peak,
         launches=launches, flash_bodies=bodies, logits_finite=True,
         sample=out["tokens"][0, :8].tolist())

    def rel(a, c):
        return float((a.float() - c.float()).norm() / c.float().norm())

    prompts = torch.randint(0, cfg.vocab, (b, plen), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    s_ = plen - 1
    reset_launches()
    lg_s, cache = lm.prefill({"tokens": prompts[:, :s_]})
    cache = lm.pad_cache(cache, plen)
    check(ops.launches["flash_attention_fwd"] == cfg.n_layers, "lm: prefill launches")
    lg_dec, _ = lm.decode_step(prompts[:, s_].to(torch.int32),
                               torch.full((b,), s_, dtype=torch.int32, device=dev), cache)
    check(ops.launches["flash_attention_fwd"] == cfg.n_layers, "lm: decode launched flash")
    del cache
    lg_full, _ = lm.prefill({"tokens": prompts})
    with mock.patch.object(model_attention.ops, "flash_attention_fwd",
                           side_effect=lambda q, k, v, **kw: ref.flash_attention_fwd(q, k, v,
                                                                                    **kw)):
        lg_plain, _ = lm.prefill({"tokens": prompts})
    decode_rel, plain_rel = rel(lg_dec, lg_full), rel(lg_full, lg_plain)
    top1 = float((lg_dec.argmax(-1) == lg_full.argmax(-1)).float().mean())
    check(all(bool(torch.isfinite(x).all()) for x in (lg_s, lg_dec, lg_full, lg_plain)),
          "lm: non-finite logits")
    check(decode_rel <= 0.1 and plain_rel <= 0.1,
          f"lm: decode vs prefill {decode_rel}, kernel vs plain attention {plain_rel} (> 0.1)")
    emit("lm", arch=cfg.name, check="prefill(s) + decode_step vs prefill(s + 1); kernel vs "
         "plain attention", s=s_, bound=0.1, decode_vs_prefill_rel=decode_rel,
         decode_vs_prefill_max_abs=float((lg_dec.float() - lg_full.float()).abs().max()),
         kernel_vs_plain_prefill_rel=plain_rel,
         kernel_vs_plain_prefill_max_abs=float((lg_full.float() - lg_plain.float()).abs().max()),
         logits_rms=float(lg_full.float().pow(2).mean().sqrt()), top1_agreement=top1)
    del lm
    torch.cuda.empty_cache()

    lap("lm")
    # ---------------------------------------------------------- 11. lm_kinds
    lm_kinds_phase(dev, reset_launches)
    gc.collect()
    torch.cuda.empty_cache()

    lap("lm_kinds")
    # ----------------------------------------------------------- 12. train_lm
    train_lm_phase(dev, smi, median_ms, bound_ms, measure, reset_launches, main_path_launches,
                   measured)
    torch.cuda.empty_cache()

    lap("train_lm")
    # -------------------------------------------------------- 12a. examples
    cpu = cpu_side_result(cpu_started)
    emit("timing", part="examples/cpu_side_wait", seconds=time.perf_counter() - _SPLIT[0])
    examples_phase(dev, smi, cpu["examples"])
    gc.collect()
    torch.cuda.empty_cache()

    lap("examples")
    # ---------------------------------------------------------- 12b. dryrun
    dryrun_phase(smi, measured, cpu["dryrun"])

    lap("dryrun")
    # --------------------------------------------------------------- 13. grad
    grad_phase(dev, median_ms, reset_launches)
    torch.cuda.empty_cache()

    lap("grad")
    # ----------------------------------------------------------- 14. serve_ode
    serve_phase(dev, smi, reset_launches, expected_launches)
    torch.cuda.empty_cache()

    lap("serve_ode")
    # ------------------------------------------------------- 15. distributed
    distributed_phase(dev, smi, reset_launches)
    gc.collect()
    torch.cuda.empty_cache()

    lap("distributed")
    emit("timing", seconds_by_phase=phase_seconds, seconds=sum(phase_seconds.values()))
    # ------------------------------------------- kernel summary, then result
    summary = []
    launch_source = {"fused_step": "fused/full_width", "fused_step_poly": "fused/step_bench",
                     "masked_bisect_refine": "events/full_width_long_events/unfused",
                     "fused_event_detect": "events/full_width_long_events/unfused",
                     "fused_event_commit": "events/full_width_long_events/unfused",
                     "batched_linsolve": "stiff/allen_cahn_full/unfused",
                     "masked_newton_update": "stiff/allen_cahn_full/unfused",
                     "batched_lu_factor": "stiff/allen_cahn_full/fused",
                     "fused_newton_iter": "stiff/allen_cahn_full/fused",
                     "flash_attention_fwd": "lm/serve",
                     "flash_attention_bwd": "train_lm/a"}
    for name in REPLACES:
        mine = [r for r in rows if r["kernel"] == name]
        at_main = [r for r in mine if r["shape"] == MAIN_SHAPE.get(name, "full_width")
                   and r["dtype"] == MAIN_DTYPE.get(name, "float32")]
        main = [r for r in at_main if r["case"] == MAIN_CASE.get(name, r["case"])]
        checked = [a["max_abs_err"] for (k, _, _), a in fused_checks.items() if k == name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            # The unfused kernels count the unfused full_width run; the fused
            # ones the fused full_width run and the step_bench dopri5 run;
            # the event kernels the unfused full_width_long_events run; the
            # Newton kernels allen_cahn_full's unfused or fused run; the
            # attention the full-width serve (one prefill, 31 decode steps),
            # its backward the full-width stablelm-3b training run (3 steps).
            "launches": main_path_launches[launch_source.get(name, "full_width")][name],
            "max_abs_err": max([r["max_abs_err"] for r in mine] + checked),
            # At the full-width float32 shapes; stage_accum and error_norm are
            # the mean over their cases (j = 1..6, the three tolerance shapes),
            # fused_update and the fused kernels their main-path case (each
            # stage count of fused_update in by_case); the Newton kernels
            # at allen_cahn_full's shapes (b = 1024, f = 128); the attention
            # at the full-width serve's prefill (b = 4, s = 2048, bf16), its
            # backward at stablelm-3b's training layer (b = 2, s = 2048, bf16).
            "ms": statistics.fmean(r["kernel_ms"] for r in main),
            "plain_ms": statistics.fmean(r["plain_ms"] for r in main),
            "bound_ms": statistics.fmean(r["bound_ms"] for r in main),
            "bound_by": main[0]["bound_by"],
            "library_ms": (statistics.fmean(r["library_ms"] for r in main)
                           if main[0]["library_ms"] is not None else None),
        })
        if len(at_main) > 1:  # each case its own time and bound (error_norm's tolerances)
            summary[-1]["by_case"] = {r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                                                      bound_ms=r["bound_ms"]) for r in at_main}
        if name == "error_norm":  # the wide body on the training paths' rows
            summary[-1]["wide_rows"] = {
                r["shape"]: dict(case=r["case"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                                 bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                                 chain_floor_ms=r["chain_floor_ms"], library_ms=None,
                                 warp_ms=r["ms_by_body"]["warp"])
                for r in mine if r["shape"] in ("ode_depth_lm", "joint_backsolve")}
            summary[-1]["wide_rows"]["ode_depth_lm"]["launches"] = (
                main_path_launches["train_lm/b"]["error_norm"])
    check(all(math.isfinite(s["ms"]) for s in summary), "kernel timings are not finite")
    check(all(s["launches"] > 0 for s in summary),
          f"a kernel was not launched on its path: {[s['name'] for s in summary]}")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# The lm_kinds phase: the configs beyond the dense decoder, reduced (card
# against CPU) and at full width (arch, layers kept or None for all, batch,
# prompt).  jamba's 32 layers (51.3e9 parameters, 102.6 GB in bf16) do not
# fit one 80 GB card, nor llava's 60 (67.9 GB) beside a prefill: one period
# of jamba's 8 and 4 of llava's layers serve.  kimi-k2 runs reduced only.
KIND_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-v0.1-52b", "xlstm-350m",
              "whisper-large-v3", "llava-next-34b")
KIND_SERVES = (("deepseek-moe-16b", None, 4, 2048), ("jamba-v0.1-52b", 8, 2, 2048),
               ("xlstm-350m", None, 4, 2048), ("whisper-large-v3", None, 4, 1500),
               ("llava-next-34b", 4, 4, 2048))


def flash_layers(cfg):
    """Flash launches a prefill of ``cfg`` makes: one per attention layer,
    the encoder's and the cross attention's included."""
    n = sum(kind.startswith("attn") for kind in cfg.pattern) * cfg.n_periods
    if cfg.enc_dec:
        n += cfg.n_periods + sum(kind == "attn_cross_mlp" for kind in cfg.pattern) * cfg.n_periods
    return n


def lm_kinds_phase(dev, reset_launches):
    """Phase 11, ``lm_kinds``: MoE, Mamba, xLSTM, the encoder-decoder and
    image tokens (``models/{moe,ssm,xlstm,frontends}.py``) through the
    serving path (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_impl, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import LM, param_count, transformer
    from repro_torch.models import attention as model_attention
    from repro_torch.models.frontends import fake_audio_embeds, fake_img_embeds
    from repro_torch.models.moe import MoE, expert_capacity, route

    def frontend(cfg, b, s, device):
        out = {}
        if cfg.n_img_tokens:
            out["img_embeds"] = fake_img_embeds(cfg, b, device=device)
        if cfg.enc_dec:
            out["audio_embeds"] = fake_audio_embeds(cfg, b, s, device=device)
        return out

    def want_launches(cfg):
        want = dict.fromkeys(ops.launches, 0)
        want["flash_attention_fwd"] = flash_layers(cfg)
        return want

    # (a) The six reduced configs in float32, the same weights (drawn on the
    # CPU from seed 0) and frontend embeddings on the card and on the CPU:
    # prefill logits and four decode steps within 1e-4, prefill(s) + decode
    # within 1e-4 of prefill(s + 1), one flash launch per attention layer
    # per prefill (whisper: encoder, decoder and cross) and none per decode
    # step.  They also warm the full-width runs up.
    for arch in KIND_ARCHS:
        cfg = get_config(arch, reduced=True)
        cpu_lm = LM(cfg, device="cpu", seed=0)
        card_lm = LM(cfg, device=dev)
        card_lm.load_state_dict(cpu_lm.state_dict())
        tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 45)))
        emb = frontend(cfg, 2, 37, "cpu")
        card_emb = {k: v.to(dev) for k, v in emb.items()}
        reset_launches()
        lg, cache = card_lm.prefill({"tokens": tok[:, :37].to(dev), **card_emb})
        lg_cpu, cache_cpu = cpu_lm.prefill({"tokens": tok[:, :37], **emb})
        diffs = [float((lg.cpu() - lg_cpu).abs().max())]
        cache, cache_cpu = card_lm.pad_cache(cache, 41), cpu_lm.pad_cache(cache_cpu, 41)
        for i in range(4):
            pos = torch.full((2,), 37 + i)
            lg, cache = card_lm.decode_step(tok[:, 37 + i].to(dev), pos.to(dev), cache)
            lg_cpu, cache_cpu = cpu_lm.decode_step(tok[:, 37 + i], pos, cache_cpu)
            diffs.append(float((lg.cpu() - lg_cpu).abs().max()))
        launches = dict(ops.launches)
        check(launches == want_launches(cfg),
              f"lm_kinds/{arch}: launches {launches}, want {flash_layers(cfg)} flash launches "
              "per prefill and none per decode step")
        full_lg, _ = card_lm.prefill({"tokens": tok[:, :41].to(dev), **card_emb})
        consistency = float((lg - full_lg).abs().max())
        check(max(diffs) <= 1e-4 and consistency <= 1e-4,
              f"lm_kinds/{arch}: card vs cpu {diffs}, prefill/decode consistency {consistency}")
        emit("lm_kinds", arch=cfg.name, dtype="float32", b=2, prompt=37, decode_steps=4,
             card_vs_cpu_max_abs_diff=diffs, decode_vs_prefill_max_abs_diff=consistency,
             flash_launches_per_prefill=flash_layers(cfg))
        del cpu_lm, card_lm, cache, cache_cpu

    # (b) Full width in bf16, weights drawn on the card from seed 0, each
    # served once through serve.run (32 tokens) after the previous model is
    # freed: every logit finite, exact launches, every flash launch on the
    # wgmma body.  Then prefill(s) + n decode steps against prefill(s + n)
    # (n = 1; xlstm n = 256, since its mLSTM chunks of 256 must divide s),
    # the MoE layers at capacity_factor = E / k (C = T: prefill drops no
    # token, as decode never does), and the prefill with the kernel against
    # the same prefill with the plain attention, both within 0.1 of the
    # logits' RMS; the share of (token, expert) assignments dropped per MoE
    # layer at the served config, and sLSTM's share of the xlstm prefill.
    def rel(a, c):
        return float((a.float() - c.float()).norm() / c.float().norm())

    for arch, layers, b, plen in KIND_SERVES:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t_arch = time.perf_counter()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm = LM(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        args = argparse.Namespace(arch=arch, reduced=False, batch=b, prompt_len=plen, gen=32,
                                  seed=0, model_parallel=1, device="cuda")
        finite = {"all": torch.ones((), dtype=torch.bool, device=dev), "steps": 0}

        def record(step, logits):
            finite["all"] &= torch.isfinite(logits).all()
            finite["steps"] += 1

        reset_launches()
        out = serve.run(args, model=lm, record=record)
        launches = dict(ops.launches)
        bodies = dict(cuda_impl.body_launches["flash_attention_fwd"])
        peak = torch.cuda.max_memory_allocated() - start
        check(launches == want_launches(cfg),
              f"lm_kinds/{arch}: launches {launches}, want {flash_layers(cfg)} flash launches")
        check(bodies == {"wgmma": flash_layers(cfg), "ffma": 0},
              f"lm_kinds/{arch}: flash bodies {bodies}, want every launch on the wgmma body")
        check(bool(finite["all"]) and finite["steps"] == args.gen,
              f"lm_kinds/{arch}: a logit is not finite")
        gen = args.gen
        emit("lm_kinds", arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
             depth_cut=(f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
                        if layers is not None else None),
             b=b, prompt=plen, gen=gen, params=param_count(lm), init_s=init_s,
             prefill_ms=out["prefill_s"] * 1e3,
             decode_ms_per_token=out["decode_s"] * 1e3 / (gen - 1),
             tokens_per_s=(gen - 1) * b / out["decode_s"],
             prefill_tokens_per_s=b * plen / out["prefill_s"], max_memory_above_start=peak,
             launches=launches, flash_bodies=bodies, logits_finite=True,
             sample=out["tokens"][0, :8].tolist())

        g = torch.Generator(device=dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (b, plen), device=dev, generator=g)
        emb = frontend(cfg, b, plen, dev)
        moes = [m for m in lm.modules() if isinstance(m, MoE)]
        if moes:
            no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            check(expert_capacity(no_drop, b * plen) == b * plen, f"{arch}: C != T")
            for m in moes:
                m.cfg = no_drop
        # xlstm: its mLSTM chunks of 256 must divide s, so 256 decode steps;
        # and its random stack is chaotic in bf16 (its bf16 prefill is ~0.9
        # of the logits' RMS from the float32 prefill of the same weights,
        # printed below), so the check runs on a float32 copy.
        n, check_lm = 1, lm
        if "mlstm" in cfg.pattern:
            n, check_lm = 256, LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
            check_lm.load_state_dict(lm.state_dict())
        reset_launches()
        lg_s, cache = check_lm.prefill({"tokens": prompts[:, :plen - n], **emb})
        cache = check_lm.pad_cache(cache, plen)
        for i in range(plen - n, plen):
            lg_dec, cache = check_lm.decode_step(
                prompts[:, i].to(torch.int32), torch.full((b,), i, dtype=torch.int32, device=dev),
                cache)
        check(ops.launches["flash_attention_fwd"] == flash_layers(cfg),
              f"lm_kinds/{arch}: a decode step launched flash")
        del cache
        lg_full, _ = check_lm.prefill({"tokens": prompts[:, :plen], **emb})
        del check_lm
        for m in moes:
            m.cfg = cfg
        decode_rel = rel(lg_dec, lg_full)

        # The served config again: the drops of each MoE layer, the sLSTM
        # layers' seconds, then the same prefill with the plain attention.
        drops = []

        def count_drops(mod, inputs, _out):
            _, _, topi = route(mod.cfg, mod, inputs[0])
            counts = torch.bincount(topi.reshape(-1), minlength=mod.cfg.moe.n_experts)
            C = expert_capacity(mod.cfg, inputs[0].shape[0])
            drops.append((counts - C).clamp(min=0).sum() / topi.numel())

        hooks = [m.register_forward_hook(count_drops) for m in moes]
        slstm_s = [0.0]
        name, weights, slstm_prefill, decode = transformer.RECURRENT["slstm"]

        def timed_slstm(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = slstm_prefill(*a)
            torch.cuda.synchronize()
            slstm_s[0] += time.perf_counter() - t
            return result

        with mock.patch.dict(transformer.RECURRENT, {"slstm": (name, weights, timed_slstm, decode)}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg_served, _ = lm.prefill({"tokens": prompts, **emb})
            torch.cuda.synchronize()
            served_s = time.perf_counter() - t0
        for hook in hooks:
            hook.remove()
        plain_rel = None
        if flash_layers(cfg):
            with mock.patch.object(model_attention.ops, "flash_attention_fwd",
                                   side_effect=lambda q, k, v, **kw: ref.flash_attention_fwd(
                                       q, k, v, **kw)):
                lg_plain, _ = lm.prefill({"tokens": prompts, **emb})
            plain_rel = rel(lg_served, lg_plain)
            check(bool(torch.isfinite(lg_plain).all()), f"lm_kinds/{arch}: non-finite plain")
        check(all(bool(torch.isfinite(x).all()) for x in (lg_s, lg_dec, lg_full, lg_served)),
              f"lm_kinds/{arch}: non-finite logits")
        check(decode_rel <= 0.1 and (plain_rel is None or plain_rel <= 0.1),
              f"lm_kinds/{arch}: decode vs prefill {decode_rel}, kernel vs plain attention "
              f"{plain_rel} (> 0.1)")
        top1 = float((lg_dec.argmax(-1) == lg_full.argmax(-1)).float().mean())
        emit("lm_kinds", arch=cfg.name,
             check=f"prefill(s) + {n} decode steps vs prefill(s + {n}) (MoE: C = T; xlstm: "
             "float32); kernel vs plain attention at the served config", s=plen - n, bound=0.1,
             decode_vs_prefill_rel=decode_rel, top1_agreement=top1,
             bf16_vs_float32_prefill_rel=rel(lg_served, lg_full) if n > 1 else None,
             kernel_vs_plain_prefill_rel=plain_rel,
             logits_rms=float(lg_full.float().pow(2).mean().sqrt()),
             moe_dropped_share_by_layer=[float(d) for d in drops] or None,
             moe_capacity=expert_capacity(cfg, b * plen) if moes else None,
             prefill_s=served_s, slstm_s=slstm_s[0] if "slstm" in cfg.pattern else None,
             slstm_share=slstm_s[0] / served_s if "slstm" in cfg.pattern else None,
             seconds=time.perf_counter() - t_arch)
        del lm, lg_s, lg_dec, lg_full, lg_served, emb
        gc.collect()
        torch.cuda.empty_cache()


def distributed_phase(dev, smi, reset_launches):
    """Phase 15, ``distributed``: the mesh path on a mesh of one card (see the
    module docstring).  The unsharded full-width serve runs first, before
    the group exists (``serve.run`` shards whenever a group does)."""
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_impl, ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    from repro_torch.models import moe as model_moe
    from repro_torch.models.moe import MoE, expert_capacity
    from repro_torch.tools import dist_checks

    # (b) full-width deepseek-moe-16b in bf16, 4 of 28 layers, the MoE at
    # capacity factor E / k, served without a mesh here and under it below
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=4)
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    b, plen, gen = 4, 2048, 8
    check(expert_capacity(no_drop, b * plen) == b * plen, "distributed: C != T")
    lm = LM(cfg, device=dev, seed=0)
    for m in lm.modules():
        if isinstance(m, MoE):
            m.cfg = no_drop
    args = argparse.Namespace(arch="deepseek-moe-16b", reduced=False, batch=b, prompt_len=plen,
                              gen=gen, seed=0, model_parallel=1, device="cuda")
    runs, expert_parallel = {}, [0]
    real_ep = model_moe.moe_apply_expert_parallel

    def counted_ep(*a, **kw):
        expert_parallel[0] += 1
        return real_ep(*a, **kw)

    def serve_once(label):
        first = {}

        def record(step, logits):
            if step == 0:
                first["logits"] = logits.float().clone()

        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        expert_parallel[0] = 0
        with mock.patch.object(model_moe, "moe_apply_expert_parallel", counted_ep):
            out = serve.run(args, model=lm, record=record)
        runs[label] = dict(
            prefill_ms=out["prefill_s"] * 1e3,
            decode_ms_per_token=out["decode_s"] * 1e3 / (gen - 1),
            peak_bytes_above_start=torch.cuda.max_memory_allocated() - start,
            flash_launches=ops.launches["flash_attention_fwd"],
            flash_bodies=dict(cuda_impl.body_launches["flash_attention_fwd"]),
            expert_parallel_calls=expert_parallel[0], sharded=out.get("mesh") is not None)
        return first["logits"]

    t0 = time.perf_counter()
    plain_logits = serve_once("no_mesh")

    import logging

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)  # one rank: no peers to warn of
    rdv = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        check(dist.get_backend() == "nccl", f"distributed: backend {dist.get_backend()}")
        mesh = make_local_mesh(model=1, device="cuda")
        check(tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"),
              f"distributed: mesh {mesh}")
        emit("distributed", backend="nccl", world=dist.get_world_size(),
             mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), nvidia_smi=smi)

        mesh_logits = serve_once("mesh")
        layers = flash_layers(cfg)
        check(runs["mesh"]["sharded"] and not runs["no_mesh"]["sharded"],
              "distributed: the mesh run did not shard")
        for label, r in runs.items():
            check(r["flash_launches"] == layers
                  and r["flash_bodies"] == {"wgmma": layers, "ffma": 0},
                  f"distributed/{label}: flash {r['flash_launches']} {r['flash_bodies']}")
        check(runs["mesh"]["expert_parallel_calls"] == cfg.n_layers
              and runs["no_mesh"]["expert_parallel_calls"] == 0,
              f"distributed: expert-parallel calls {runs}")
        a, c = mesh_logits, plain_logits
        rel = float((a - c).norm() / c.norm())
        check(bool(torch.isfinite(a).all()) and rel <= 0.1,
              f"distributed: mesh vs unsharded prefill logits {rel} of their norm")
        emit("distributed", check="full-width serve, mesh (1, 1) vs no mesh", arch=cfg.name,
             dtype=cfg.dtype, layers=cfg.n_layers, depth_cut="4 of 28 layers", b=b,
             prompt=plen, gen=gen, capacity_factor=no_drop.moe.capacity_factor,
             logits_rel=rel, logits_max_abs=float((a - c).abs().max()),
             logits_rms=float(c.pow(2).mean().sqrt()),
             top1_agreement=float((a.argmax(-1) == c.argmax(-1)).float().mean()),
             bitwise=bool(torch.equal(a, c)), runs=runs, seconds=time.perf_counter() - t0)
        del lm, a, c, mesh_logits, plain_logits
        gc.collect()
        torch.cuda.empty_cache()

        # (a) reduced training under the mesh (fsdp) against no mesh
        for arch in ("stablelm-3b", "deepseek-moe-16b"):
            t0 = time.perf_counter()
            case = (arch, (1, 1), True, False, "adamw")
            out, _ = dist_checks.train_case(0, 1, None, case, device="cuda",
                                            on_mesh_start=reset_launches)
            launches = {k: ops.launches[k] for k in ("flash_attention_fwd",
                                                     "flash_attention_bwd")}
            want = dict.fromkeys(launches, flash_layers(get_config(arch, reduced=True))
                                 * dist_checks.STEPS)
            check(launches == want and sum(ops.launches.values()) == sum(want.values()),
                  f"distributed/{arch}: launches {dict(ops.launches)}, want {want}")
            rel = {k: max(abs(g[k] - r[k]) / abs(r[k]) for g, r in zip(out["got"], out["ref"]))
                   for k in ("loss", "ce_loss", "grad_norm")}
            check(all(v <= 1e-5 for v in rel.values()), f"distributed/{arch}: metrics {rel}")
            got, ref = out["params_got"][-1], out["params_ref"][-1]
            diff = np.concatenate([np.abs(got[n] - ref[n]).ravel() for n in ref])
            check(diff.max() <= 5e-4 and np.quantile(diff, 0.999) <= 1e-6,
                  f"distributed/{arch}: parameters {diff.max()}")
            emit("distributed", check="train, mesh (1, 1) fsdp vs no mesh", arch=arch, b=4,
                 s=16, steps=dist_checks.STEPS, max_rel=rel,
                 metrics_bitwise=out["got"] == out["ref"],
                 params_max_abs=float(diff.max()), params_bitwise=bool(diff.max() == 0),
                 launches_on_mesh=launches, seconds=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()


def train_lm_phase(dev, smi, median_ms, bound_ms, measure, reset_launches, main_path_launches,
                   measured):
    """Phase 12, ``train_lm``: the LM training path on the card (see the
    module docstring).  ``median_ms``, ``bound_ms``, ``measure`` and
    ``reset_launches`` are main's; the full-width run's launches go into
    ``main_path_launches["train_lm/a"]``, its ms a step and peak memory into
    ``measured["train_lm/a/adamw"]`` (for the dryrun phase)."""
    import argparse
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager, latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import cuda_impl, ops, ref
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.tools import attn_checks
    from repro_torch.train import cross_entropy_loss, init_train_state, make_train_step

    # The lm phase's qwen2.5-14b (28 GB of weights) is gone before this
    # phase: what stays allocated is the earlier phases' tensors in main's
    # scope (8.6 GB on an H100 after the lm phase).  Peaks are reported
    # above what each run starts with.
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 16 * 2**30, f"train_lm: {held} bytes still allocated before the phase")
    emit("train_lm", check="memory held before the phase", bytes=held)

    # 11a. The attention backward against its plain version
    # (tools/attn_checks.hold: float32 within 1e-4 of the largest entry,
    # bf16 within 2x the plain bf16 version's error against a float64
    # oracle), the forward's lse within 1e-5 of the plain forward's and its
    # output bitwise the same with lse; then at the two training layers,
    # both dtypes, timed: the kernel on each body it takes (and its three
    # launches apart, from the profiler), two bf16 calls bitwise equal, the
    # plain version, the bound and SDPA's backward.
    # bound: the backward's five products, 10 b H hd per visible query-key
    # pair, over the dtype's peak, or q, k, v, o, do and lse read and dq,
    # dk, dv written over HBM, the larger.
    def visible(sq, sk, causal, q_offset):
        return sum(min(sk, q_offset + i + 1) for i in range(sq)) if causal else sq * sk

    def kernel_ms(fn, names):
        """Median device ms of each kernel whose name holds one of
        ``names``, over REPS calls of ``fn`` (L2 flushed before each), from
        torch.profiler's kernel events: the backward's launches apart, as
        one call makes them."""
        from torch.profiler import ProfilerActivity, profile

        flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = {n: [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and n in e.name]
                 for n in names}
        # CUPTI may drop a record now and then (49 of 50 seen once).
        check(all(len(t) >= REPS // 2 for t in times.values()),
              f"train_lm: the profiler saw {[len(t) for t in times.values()]} launches of "
              f"{names}, want about {REPS} each")
        return {n: statistics.median(t) for n, t in times.items()}

    untimed = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = {}
        for case in attn_checks.CASES:
            q, k, v, do = attn_checks.inputs(sum(case[:6]), case, dtype, dev)
            res = attn_checks.hold(f"flash_attention_bwd[{case}]", case, dtype, q, k, v, do)
            for key in ("rel_err", "plain_rel_err", "lse_rel_err"):
                if key in res:
                    errs = res[key] if isinstance(res[key], list) else [res[key]]
                    worst[key] = max(worst.get(key, 0.0), *errs)
        untimed[str(dtype).split(".")[-1]] = dict(cases=len(attn_checks.CASES), **worst)
    emit("train_lm", check="flash_attention_bwd, untimed cases", f32_tol=attn_checks.F32_TOL,
         lse_tol=attn_checks.LSE_TOL, bf16_factor=attn_checks.BF16_FACTOR, worst=untimed)

    # The launches of each body, by the profiler: D's flash_bwd_delta_kernel,
    # then FFMA's flash_bwd_{dkdv,dq}_kernel or wgmma's
    # flash_bwd_{dkdv,dq}_wgmma_kernel.
    launch_names = {"ffma": ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                             "flash_bwd_dq_kernel"),
                    "wgmma": ("flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel",
                              "flash_bwd_dq_wgmma_kernel")}
    for shape_name, case in attn_checks.LAYERS.items():
        b, sq, sk, H, KV, hd, causal, q_offset = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attn_checks.inputs(sq + H, case, dtype, dev)
            res = attn_checks.hold(f"flash_attention_bwd[{shape_name}]", case, dtype, q, k, v,
                                   do)
            o, lse = cuda_impl.flash_attention_fwd(q, k, v, lse=True)
            bodies = [body for body in cuda_impl.FLASH_BWD_BODIES
                      if body == "ffma" or dtype == torch.bfloat16]
            repeat = None
            if dtype == torch.bfloat16:
                # no atomics: two calls of the body the path takes, the same bits
                first = cuda_impl.flash_attention_bwd(q, k, v, o, lse, do)
                second = cuda_impl.flash_attention_bwd(q, k, v, o, lse, do)
                repeat = all(torch.equal(x, y) for x, y in zip(first, second))
                check(repeat, f"flash_attention_bwd[{shape_name}]: two calls differ bitwise")
                del first, second
            e = q.element_size()
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            out_t = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=H != KV)
            do_t = do.transpose(1, 2).contiguous()
            errs = res["rel_err"]
            measure("flash_attention_bwd", shape_name, dtype, f"b={b} s={sq} H={H} KV={KV} "
                    f"hd={hd} causal",
                    lambda: cuda_impl.flash_attention_bwd(q, k, v, o, lse, do),
                    lambda: ref.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **attn_checks.plain_chunks(case)),
                    e * (3 * q.numel() + do.numel() + 2 * (k.numel() + v.numel()))
                    + 4 * lse.numel(),
                    10 * b * H * hd * visible(sq, sk, causal, q_offset),
                    compare_fn=lambda *_: (res["max_abs_err"], max(errs)),
                    run_library=lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                            retain_graph=True),
                    tol=attn_checks.F32_TOL if dtype == torch.float32
                    else f"{attn_checks.BF16_FACTOR} x plain",
                    rel_err_by_grad=dict(zip(attn_checks.NAMES, errs)),
                    plain_rel_err_by_grad=dict(zip(attn_checks.NAMES,
                                                   res.get("plain_rel_err", []))) or None,
                    body=cuda_impl.flash_bwd_body(hd, dtype),
                    ms_by_body={body: median_ms(
                        lambda body=body: cuda_impl.flash_attention_bwd(q, k, v, o, lse, do,
                                                                        body=body))
                        for body in bodies},
                    launch_ms_by_body={body: kernel_ms(
                        lambda body=body: cuda_impl.flash_attention_bwd(q, k, v, o, lse, do,
                                                                        body=body),
                        launch_names[body]) for body in bodies},
                    bitwise_repeat=repeat,
                    lse_rel_err=res["lse_rel_err"],
                    forward_with_lse_bitwise=res["out_bitwise_without_lse"])
            del q, k, v, do, o, lse, qt, kt, vt, out_t, do_t
    torch.cuda.empty_cache()

    # 11b. Path (a): full-width stablelm-3b (bf16, 32 layers, d = 2560, 32
    # heads of 80, vocab 50304) through the launcher, three AdamW steps at
    # batch 2 x seq 2048: without remat, with remat, and with 8-bit moments.
    # Each: the loss at each step, the first step's batch after the third
    # (below its loss at the first), ms per step by phase, peak memory, and
    # exactly one attention backward per layer per step (one forward, two
    # with remat).  The first loss is held within 0.5
    # of what an untrained model of the reference's initialisation gives:
    # the tied embedding (std 1/sqrt(d)) against the final norm's output
    # (unit RMS) makes logits of unit variance, and the cross entropy of
    # such logits is ln V + 1/2 in expectation (11.33, not ln V = 10.83).
    def args(**kw):
        base = dict(arch="stablelm-3b", reduced=False, steps=3, batch=2, seq=2048, lr=1e-3,
                    seed=0, model_parallel=1, fsdp=False, remat=False, ode_depth=False,
                    optimizer="adamw", ckpt_dir=None, ckpt_every=10, step_timeout=600.0,
                    log_every=1, max_restarts=0, device="cuda")
        return argparse.Namespace(**{**base, **kw})

    def run(label, **kw):
        """train.run, then the trained model's loss on the first step's
        batch: it must be below that step's loss (the same tokens; the
        steps' own losses are on three different batches, whose means
        differ by ~0.016 at 4096 tokens, as much as three warm-up steps
        move them)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_launches()
        a = args(**kw)
        out = train.run(a)
        launches = dict(ops.launches)
        bodies = {k: dict(cuda_impl.body_launches[k])
                  for k in ("flash_attention_fwd", "flash_attention_bwd", "error_norm")}
        peak = torch.cuda.max_memory_allocated() - start
        model = out.pop("state")["params"]
        params = sum(p.numel() for p in model.parameters())
        batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTokens(
            vocab=model.cfg.vocab, seq_len=a.seq, global_batch=a.batch).batch(0).items()}
        with torch.no_grad():
            logits, _ = model.forward(batch)
            out["batch0_loss_after"] = float(cross_entropy_loss(logits, batch["labels"]))
        del model, logits
        torch.cuda.empty_cache()
        losses = out["losses"]
        check(all(math.isfinite(x) for x in losses + out["grad_norms"]),
              f"train_lm/{label}: a loss or grad norm is not finite: {out['metrics']}")
        check(out["batch0_loss_after"] < losses[0],
              f"train_lm/{label}: the loss did not fall: step 1's batch {losses[0]} before, "
              f"{out['batch0_loss_after']} after {len(losses)} steps")
        return out, launches, bodies, peak, params

    cfg = get_config("stablelm-3b")
    ln_vocab = math.log(cfg.vocab)
    untrained = ln_vocab + 0.5
    for label, kw in (("a/adamw", {}), ("a/adamw_remat", {"remat": True}),
                      ("a/adamw8bit", {"optimizer": "adamw8bit"})):
        out, launches, bodies, peak, params = run(label, **kw)
        losses = out["losses"]
        check(abs(losses[0] - untrained) <= 0.5,
              f"train_lm/{label}: first loss {losses[0]} not within 0.5 of ln V + 1/2 = "
              f"{untrained}")
        n = cfg.n_layers * len(losses)
        fwd = n * (2 if kw.get("remat") else 1)
        check(launches["flash_attention_bwd"] == n and launches["flash_attention_fwd"] == fwd,
              f"train_lm/{label}: attention launches {launches['flash_attention_fwd']} / "
              f"{launches['flash_attention_bwd']}, want {fwd} / {n}")
        check(bodies["flash_attention_fwd"] == {"wgmma": fwd, "ffma": 0}
              and bodies["flash_attention_bwd"] == {"wgmma": n, "ffma": 0},
              f"train_lm/{label}: flash bodies {bodies['flash_attention_fwd']}, backward "
              f"{bodies['flash_attention_bwd']}")
        if label == "a/adamw":
            main_path_launches["train_lm/a"] = launches
            measured["train_lm/a/adamw"] = dict(step_ms=[ms["step"] for ms in out["step_ms"]],
                                                peak_bytes_above_start=peak)
        emit("train_lm", path=label, arch=cfg.name, dtype=cfg.dtype, params=params, b=2,
             seq=2048, steps=len(losses), losses=losses,
             batch0_loss_after=out["batch0_loss_after"], grad_norms=out["grad_norms"],
             lr=[m["lr"] for m in out["metrics"]], ms_per_step=out["step_ms"],
             peak_memory_above_start=peak, launches={k: v for k, v in launches.items() if v},
             flash_bodies=bodies["flash_attention_fwd"],
             flash_bwd_bodies=bodies["flash_attention_bwd"], ln_vocab=ln_vocab,
             first_loss_minus_ln_vocab=losses[0] - ln_vocab, nvidia_smi=smi)

    # 11c. Path (b): --ode-depth on the same config (n_layers = 1): each of
    # the 2 sequences one ODE instance of 2048 x 2560 = 5 242 880 float32
    # entries, bosh3 through solve_ivp_scan with max_steps = ode_steps = 8.
    # Three steps: ode_steps, loss, ms per step, peak memory, the solver
    # kernels' launches, error_norm's by body and each body's device ms at
    # this row width (the row body takes rows up to NORM_ROW_MAX_F only).
    out, launches, bodies, peak, params = run("b/ode_depth", ode_depth=True)
    check(launches["flash_attention_bwd"] > 0 and launches["error_norm"] > 0
          and launches["stage_accum"] > 0 and launches["fused_update"] > 0,
          f"train_lm/b: solver or attention kernels not launched: {launches}")
    f = 2048 * cfg.d_model
    check(bodies["error_norm"][cuda_impl.error_norm_body(f)] == launches["error_norm"]
          and bodies["flash_attention_bwd"]["wgmma"] == launches["flash_attention_bwd"],
          f"train_lm/b: error_norm bodies {bodies['error_norm']} (want every launch on "
          f"{cuda_impl.error_norm_body(f)}), backward {bodies['flash_attention_bwd']}")
    err, y0, y1 = (torch.randn(2, f, device=dev, generator=torch.Generator(device=dev)
                               .manual_seed(i)) for i in range(3))
    ms_by_body = {}
    for body in cuda_impl.ERROR_NORM_BODIES:
        try:
            cuda_impl.check_error_norm_body(body, f)
        except ValueError as exc:
            ms_by_body[body] = f"refused: {exc}"
            continue
        ms_by_body[body] = median_ms(lambda body=body: cuda_impl.error_norm(
            err, y0, y1, 1e-3, 1e-2, body=body), reps=5 if body == "warp" else REPS)
    del err, y0, y1
    main_path_launches["train_lm/b"] = launches
    emit("train_lm", path="b/ode_depth", arch=cfg.name, dtype=cfg.dtype, params=params, b=2,
         seq=2048, ode_instance_entries=f, steps=len(out["losses"]), losses=out["losses"],
         batch0_loss_after=out["batch0_loss_after"],
         ode_steps=[m["ode_steps"] for m in out["metrics"]], grad_norms=out["grad_norms"],
         ms_per_step=out["step_ms"], peak_memory_above_start=peak,
         launches={k: v for k, v in launches.items() if v},
         error_norm_bodies=bodies["error_norm"], error_norm_body=cuda_impl.error_norm_body(f),
         flash_bwd_bodies=bodies["flash_attention_bwd"],
         error_norm_ms_by_body=ms_by_body, nvidia_smi=smi)
    torch.cuda.empty_cache()

    # 11d. A checkpoint, then a resume (reduced stablelm-3b, float32, on the
    # card): four steps straight, or two, an async checkpoint, a fresh state
    # (other weights) restored from it and two more -- bitwise equal
    # parameters, moments and losses.
    rcfg = get_config("stablelm-3b", reduced=True)
    ds = SyntheticTokens(vocab=rcfg.vocab, seq_len=64, global_batch=4)
    step = make_train_step(rcfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in ds.batch(i).items()}
               for i in range(4)]

    def steps(state, lo, hi):
        losses = []
        for batch in batches[lo:hi]:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return state, losses

    straight, losses = steps(init_train_state(rcfg, 0, device=dev), 0, 4)
    half, first = steps(init_train_state(rcfg, 0, device=dev), 0, 2)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        mgr.save_async(1, train.state_tree(half))
        mgr.close()
        fresh = init_train_state(rcfg, 1, device=dev)
        train.load_state(fresh, restore(tmp, latest_step(tmp), train.state_tree(fresh)))
    resumed, second = steps(fresh, 2, 4)

    def leaves(tree):
        return [x for v in tree.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    same = all(torch.equal(a, c) for a, c in zip(leaves(train.state_tree(resumed)),
                                                 leaves(train.state_tree(straight))))
    check(same and first + second == losses,
          f"train_lm/resume: not bitwise ({first + second} vs {losses})")
    emit("train_lm", check="checkpoint after step 2, restore into a fresh state, steps 3-4 "
         "bitwise equal to the uninterrupted run", arch=rcfg.name, dtype=rcfg.dtype,
         losses=losses, bitwise=True)


# The examples phase's LM runs: the example's own config and the other
# block kinds, through the train_lm example (reduced, three steps each), and
# continuous_depth_lm.
EXAMPLE_LM_ARCHS = ("qwen2.5-14b", "deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
                    "xlstm-350m", "whisper-large-v3", "llava-next-34b")
# The dryrun phase's cells: the train_lm phase's AdamW step and the lm
# phase's prefill, each at the shape it ran.
DRYRUN_CELLS = {"stablelm-3b/train": ("stablelm-3b", dict(seq_len=2048, global_batch=2,
                                                          kind="train")),
                "qwen2.5-14b/prefill": ("qwen2.5-14b", dict(seq_len=2048, global_batch=4,
                                                            kind="prefill"))}


def example_runs(device, tmp, whole=False):
    """The examples phase's runs of ``repro_torch.examples`` on ``device``:
    {label: {"out", "seconds", "launches", "lines"}}, ``out`` as CPU tensors,
    numpy and numbers.  ``whole`` adds quickstart and bouncing_ball as the
    reference runs them (float32, their own asserts).  The LM runs start
    from a state drawn on the CPU and moved to ``device``; on the CPU each
    counts the calls of the plain attention (one kernel launch each on the
    card)."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.examples import (
        bouncing_ball,
        cnf_density,
        continuous_depth_lm,
        latent_ode,
        quickstart,
        train_lm,
    )
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.tools import cnf

    dev = torch.device(device)
    runs = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(label, fn, keep=lambda out: out):
        for k in ops.launches:
            ops.launches[k] = 0
        sync()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        sync()
        seconds = time.perf_counter() - t0
        runs[label] = dict(out=keep(out), seconds=seconds, lines=buf.getvalue().splitlines(),
                           launches={k: v for k, v in ops.launches.items() if v})

    def host(tree):
        return pytree.tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                               tree)

    def solutions(out):
        return {name: host(dict(status=sol.status, n_steps=sol.stats["n_steps"],
                                ys=pytree.tree_leaves(sol.ys))) for name, sol in out.items()}

    if whole:
        run("quickstart", lambda: quickstart.main(dev), lambda out: None)
        run("bouncing_ball", lambda: bouncing_ball.main(dev), lambda out: out["max_err"])
    y64 = torch.randn((5, 2), generator=torch.Generator().manual_seed(0)).double()
    run("quickstart/float64", lambda: quickstart.main(dev, data=y64), solutions)
    h0 = bouncing_ball.h0
    run("bouncing_ball/float64", lambda: bouncing_ball.main(
        dev, data=torch.tensor(np.stack([h0, np.zeros_like(h0)], 1))))
    params = {k: v.double() for k, v in cnf.init_mlp(torch.Generator().manual_seed(0)).items()}
    data = cnf.two_moons(torch.Generator().manual_seed(0), 512).double()
    run("cnf_density", lambda: cnf_density.main(dev, iters=3, params=params, data=data),
        lambda out: host({"nll": out["nll"], "first_grads": out["first_grads"]}))

    def latent(seed):
        p = latent_ode.init_params(torch.Generator().manual_seed(seed))
        t, x = latent_ode.make_data(torch.Generator().manual_seed(seed))
        return {k: v.double() for k, v in p.items()}, (t.double(), x.double())

    p0, d0 = latent(0)
    run("latent_ode", lambda: latent_ode.main(dev, iters=5, params=p0, data=d0),
        lambda out: out["mse"])
    p1, d1 = latent(1)
    run("latent_ode/service", lambda: latent_ode.train_through_service(
        2, device=dev, params=p1, data=d1), lambda out: host(
        {k: out[k] for k in ("losses", "served", "solo")}
        | {"n_grad_solves": out["stats"]["n_grad_solves"]}))

    real_init = train.init_train_state

    def drawn_on_cpu(cfg, seed, *, optimizer="adamw", device="cuda"):
        state = real_init(cfg, seed, optimizer=optimizer, device="cpu")
        state["params"].to(device)
        state["opt"] = pytree.tree_map(lambda t: t.to(device), state["opt"])
        return state

    def lm_run(label, fn):
        calls = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd"), 0)

        def counted(name):
            real = getattr(ref, name)

            def call(*a, **k):
                calls[name] += 1
                return real(*a, **k)
            return mock.patch.object(ref, name, call)

        with mock.patch.object(train, "init_train_state", drawn_on_cpu), \
                counted("flash_attention_fwd"), counted("flash_attention_bwd"):
            run(label, fn, lambda out: dict(losses=out["losses"], metrics=out["metrics"],
                                            step_ms=[ms["step"] for ms in out["step_ms"]]))
        runs[label]["plain_attention_calls"] = calls

    for arch in EXAMPLE_LM_ARCHS:
        lm_run(f"train_lm/{arch}", lambda arch=arch: train_lm.main(
            arch, 3, dev, f"{tmp}/{arch}/{dev.type}"))
    lm_run("continuous_depth_lm", lambda: continuous_depth_lm.main(dev, iters=3))
    return runs


def dryrun_counts():
    """The dryrun phase's counts (``launch/dryrun.py``, fake tensors on a
    mesh of one): the reduced prefill's FLOPs against the reference's, and
    ``lower_cell``'s record of each of ``DRYRUN_CELLS``."""
    from repro_torch.launch import dryrun
    from repro_torch.tools import cost_checks

    counted, as_reference = cost_checks.prefill_flops()
    got, want = cost_checks.sharded_matmul()
    out = {"prefill": dict(counted=counted, as_reference=as_reference),
           "sharded": dict(got=got, want=want)}
    for name, (arch, shape) in DRYRUN_CELLS.items():
        t0 = time.perf_counter()
        _, info = dryrun.lower_cell(arch, shape, mesh_shape=(1, 1), remat="off")
        out[name] = dict(info, count_s=time.perf_counter() - t0)
    return out


def cpu_side(path, cores):
    """``python3 chip_smoke.py --cpu-side PATH CORES``: the examples phase's
    CPU runs and the dryrun phase's counts, written to PATH
    (``torch.save``), on the host cores CORES (comma separated).  ``main``
    runs it in a process of its own beside the card's phases, so that the
    host's share of those phases overlaps them."""
    import tempfile

    cores = [int(c) for c in cores.split(",")]
    pin(cores)  # before torch starts a thread
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(len(cores))
    with tempfile.TemporaryDirectory(dir=pathlib.Path(path).parent) as tmp:
        out = {"examples": example_runs("cpu", tmp), "dryrun": dryrun_counts()}
    torch.save(out, path)
    return 0


def pin(cores):
    """Pin every thread of this process to the host cores ``cores``."""
    import os

    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except ProcessLookupError:  # a thread that has ended meanwhile
            pass


def start_cpu_side():
    """Start ``cpu_side`` in a process of its own, on the upper half of this
    process's host cores, and keep this process (every thread, and torch's
    thread count) on the lower half until ``cpu_side_result``: the card's
    phases that run meanwhile then share no core with it.  Returns (the
    process, its output path, its log path, the split).  ``main`` stops it
    on any exit."""
    import os
    import tempfile

    import torch

    cores = sorted(os.sched_getaffinity(0))
    half = len(cores) // 2
    mine, its = (cores[:half], cores[half:]) if half else (cores, cores)
    split = dict(host_cores=os.cpu_count(), main_cores=mine, cpu_side_cores=its,
                 main_threads=torch.get_num_threads())
    work = pathlib.Path(tempfile.mkdtemp(prefix="cpu_side_", dir=ROOT / "build"))
    log = open(work / "log.txt", "w")
    proc = subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()),
                             "--cpu-side", str(work / "out.pt"), ",".join(map(str, its))],
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    _CHILDREN.append(proc)
    if half:
        pin(mine)
        torch.set_num_threads(len(mine))
    emit("timing", part="cpu_side_cores", **split)
    return proc, work / "out.pt", work / "log.txt", split


_CHILDREN = []


def cpu_side_result(started, timeout=600):
    """Wait for ``start_cpu_side``'s process, give this process its cores
    and threads back, and load what the process wrote."""
    import torch

    proc, out, log, split = started
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise RuntimeError(f"the CPU side did not end in {timeout} s")
    finally:
        pin(sorted({*split["main_cores"], *split["cpu_side_cores"]}))
        torch.set_num_threads(split["main_threads"])
    if rc != 0:
        sys.stderr.write(log.read_text()[-4000:])
        raise RuntimeError(f"the CPU side exited {rc}")
    return torch.load(out, weights_only=False)


def examples_phase(dev, smi, cpu):
    """Phase 12a, ``examples``: the reference's examples through
    ``repro_torch.examples`` on the card, held to ``cpu``, the same runs on
    the CPU (``cpu_side``) (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        card = example_runs(dev, tmp, whole=True)

    def rel(got, want):
        """Largest |got - want| over max(1, |want|)."""
        got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
        want = np.asarray(want.numpy() if isinstance(want, torch.Tensor) else want, np.float64)
        check(got.shape == want.shape, f"examples: shapes {got.shape} != {want.shape}")
        return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))

    def held(label, diffs, tol):
        worst = max(diffs)
        check(worst <= tol, f"examples/{label}: card vs CPU {worst} > {tol}")
        return worst

    def launched(label, names):
        got = card[label]["launches"]
        check(all(got.get(k, 0) > 0 for k in names),
              f"examples/{label}: {[k for k in names if not got.get(k)]} not launched: {got}")
        return got

    def common(label):
        r = card[label]
        return dict(seconds=r["seconds"], launches=r["launches"], nvidia_smi=smi,
                    cpu_seconds=cpu[label]["seconds"] if label in cpu else None)

    solver = ("stage_accum", "fused_update", "error_norm")
    events = ("fused_event_detect", "fused_event_commit", "masked_bisect_refine")
    # (a) quickstart and bouncing_ball whole, float32 (their own asserts);
    # their solves from float64 states card against CPU: equal status and
    # n_steps, ys and impacts within 1e-9.
    launched("quickstart", (*solver, "interp_eval"))
    launched("bouncing_ball", events)
    diffs = []
    for name, want in cpu["quickstart/float64"]["out"].items():
        got = card["quickstart/float64"]["out"][name]
        check(torch.equal(got["status"], want["status"])
              and torch.equal(got["n_steps"], want["n_steps"]),
              f"examples/quickstart/{name}: status or n_steps differ from the CPU's")
        diffs += [rel(a, b) for a, b in zip(got["ys"], want["ys"])]
    emit("examples", example="quickstart", dtype="float32", output=card["quickstart"]["lines"][-1],
         float64_card_vs_cpu=held("quickstart", diffs, 1e-9), tol=1e-9, **common("quickstart"))
    got, want = card["bouncing_ball/float64"]["out"], cpu["bouncing_ball/float64"]["out"]
    emit("examples", example="bouncing_ball", dtype="float32",
         max_err_vs_closed_form=card["bouncing_ball"]["out"],
         output=card["bouncing_ball"]["lines"][-1],
         float64_card_vs_cpu=held("bouncing_ball", [rel(got[k], want[k]) for k in
                                                    ("impacts", "states")], 1e-9),
         tol=1e-9, **common("bouncing_ball"))

    # (b) cnf_density: 3 iterations at the reference's 512 points, float64
    # (seed 0's MLP and points, cast): every NLL and the first gradient
    # within 1e-9 of the CPU's.
    launched("cnf_density", solver)
    got, want = card["cnf_density"]["out"], cpu["cnf_density"]["out"]
    emit("examples", example="cnf_density", dtype="float64", iters=3, points=512, nll=got["nll"],
         card_vs_cpu=held("cnf_density", [rel(got["nll"], want["nll"])] + [
             rel(got["first_grads"][k], want["first_grads"][k]) for k in want["first_grads"]],
             1e-9), tol=1e-9, **common("cnf_density"))

    # (c) latent_ode: main, 5 iterations, and the service loop, 2, float64
    # (seed 0's and seed 1's draws, cast): the losses and the first served
    # gradients within 1e-9 of the CPU's (the example asserts them bitwise
    # the solo ScanAdjoint solve's on each device).
    launched("latent_ode", (*solver, "interp_eval"))
    launched("latent_ode/service", solver)
    got, want = card["latent_ode/service"]["out"], cpu["latent_ode/service"]["out"]
    check(got["n_grad_solves"] == want["n_grad_solves"] == 3 * 16,
          f"examples/latent_ode/service: {got['n_grad_solves']} gradient solves")
    emit("examples", example="latent_ode", dtype="float64", iters=5,
         mse=card["latent_ode"]["out"], service_iters=2, service_losses=got["losses"],
         n_grad_solves=got["n_grad_solves"], service=common("latent_ode/service"),
         card_vs_cpu=held("latent_ode", [rel(card["latent_ode"]["out"],
                                             cpu["latent_ode"]["out"]),
                                         rel(got["losses"], want["losses"])] + [
             rel(got[key][k], want[key][k]) for key in ("served", "solo")
             for k in want[key]], 1e-9), tol=1e-9, **common("latent_ode"))

    # (d) train_lm: the example's reduced qwen2.5-14b and the other block
    # kinds (MoE, Mamba, mLSTM / sLSTM, the encoder-decoder's and the vision
    # config's frontends), three AdamW steps from the same state, float32,
    # against the CPU's: step 1 (the same state and batch) every metric
    # within 1e-5 relative (tests/test_torch_train_kinds.py's rule: loss,
    # cross entropy, MoE balance loss, grad norm); steps 2-3 start from
    # parameters the first update moved apart where a gradient is near
    # AdamW's eps (up to half a step; ROADMAP C's AdamW rule): the losses
    # within 1e-4, the grad norm, which feels it first, within 1e-3 (jamba's
    # third step read 8.7e-6 and 1.07e-4 on an H100).  One attention launch
    # for each call of the plain attention on the CPU.  continuous_depth_lm
    # the same, its 1e-5 widened to 1e-4 (its float32 depth solve's
    # controller, C-5), the solver kernels launched.
    for label in [f"train_lm/{arch}" for arch in EXAMPLE_LM_ARCHS] + ["continuous_depth_lm"]:
        got, want = card[label], cpu[label]
        calls = want["plain_attention_calls"]
        check(all(got["launches"].get(k, 0) == n for k, n in calls.items()),
              f"examples/{label}: attention launches {got['launches']}, the CPU's calls {calls}")
        tol = 1e-4 if label == "continuous_depth_lm" else 1e-5
        rules = {"loss": (tol, 1e-4), "ce_loss": (tol, 1e-4), "moe_balance": (tol, 1e-4),
                 "grad_norm": (tol, 1e-3)}
        diffs = {}
        for key, (first, later) in rules.items():
            if key not in want["out"]["metrics"][0]:
                continue
            d = [abs(a[key] - b[key]) / abs(b[key])
                 for a, b in zip(got["out"]["metrics"], want["out"]["metrics"])]
            diffs[key] = d
            check(d[0] <= first and max(d[1:]) <= later,
                  f"examples/{label}: {key} card vs CPU {d} (step 1 <= {first}, later <= "
                  f"{later}): {[m[key] for m in got['out']['metrics']]} vs "
                  f"{[m[key] for m in want['out']['metrics']]}")
        if label == "continuous_depth_lm":
            launched(label, solver)
            check(all(m["ode_steps"] > 0 for m in got["out"]["metrics"]),
                  "examples/continuous_depth_lm: no depth step")
        emit("examples", example=label, dtype="float32", steps=len(got["out"]["losses"]),
             losses=got["out"]["losses"], card_vs_cpu_rel_by_step=diffs,
             tol={k: dict(step1=a, later=b) for k, (a, b) in rules.items() if k in diffs},
             ms_per_step=got["out"]["step_ms"], plain_attention_calls_on_cpu=calls,
             **common(label))


def dryrun_phase(smi, measured, counts):
    """Phase 12b, ``dryrun``: ``launch/dryrun.py``'s counts (``counts``, from
    ``cpu_side``) of two steps measured in this run (see the module
    docstring).  ``measured`` holds the lm and train_lm phases' times and
    peaks."""
    from repro_torch.launch import dryrun
    from repro_torch.tools import cost_checks

    # The counter on this machine's torch against the reference's HLO count
    # of the reduced prefill (tests/test_torch_dryrun.py holds the number).
    pre = counts["prefill"]
    check(pre["as_reference"] == cost_checks.REFERENCE_PREFILL_FLOPS,
          f"dryrun: the reduced prefill counts {pre['as_reference']} flops in the reference's "
          f"convention, the reference {cost_checks.REFERENCE_PREFILL_FLOPS}")
    emit("dryrun", check="reduced stablelm-3b prefill vs the reference's hlocost",
         case=cost_checks.PREFILL_CASE, counted_flops=pre["counted"],
         in_reference_convention=pre["as_reference"],
         reference_flops=cost_checks.REFERENCE_PREFILL_FLOPS)
    # The counter's patches of DTensor's private names on this machine's
    # torch: a matmul on a fake 2 x 2 group against its count by hand.
    sharded = counts["sharded"]
    check(sharded["got"] == sharded["want"],
          f"dryrun: the fake 2 x 2 DTensor matmul counts {sharded['got']}, by hand "
          f"{sharded['want']}")
    emit("dryrun", check="Shard(1) matmul and its backward on a fake 2 x 2 group vs the count "
         "by hand", **sharded["got"])
    train = measured["train_lm/a/adamw"]
    serve = measured["lm/serve"]
    against = {"stablelm-3b/train": (statistics.median(train["step_ms"][1:]),
                                     train["peak_bytes_above_start"],
                                     "train_lm a/adamw: median of steps 2-3; peak memory "
                                     "above the run's start"),
               "qwen2.5-14b/prefill": (serve["prefill_ms"], serve["max_memory_allocated"],
                                       "lm serve: the timed prefill; the whole serve's peak, "
                                       "every allocation")}
    for name, (arch, shape) in DRYRUN_CELLS.items():
        info, (ms, peak, source) = counts[name], against[name]
        r = info["roofline"]
        check(all(math.isfinite(r[k]) for k in ("compute_s", "memory_s", "collective_s")),
              f"dryrun/{name}: roofline {r}")
        s = ms / 1e3
        emit("dryrun", cell=name, **shape, mesh="1x1, fake tensors", count_s=info["count_s"],
             counted_gflops=info["per_device"]["gflops"],
             hbm_gbytes=info["per_device"]["hbm_gbytes"],
             model_gflops=info["model_gflops_global"],
             useful_flops_ratio=info["useful_flops_ratio"], roofline=r,
             roofline_bound_ms=1e3 * max(r["compute_s"], r["memory_s"], r["collective_s"]),
             measured_ms=ms, measured_source=source,
             model_flop_utilisation=info["model_gflops_global"] * 1e9 / (s * dryrun.PEAK_FLOPS),
             counted_flop_utilisation=info["per_device"]["gflops"] * 1e9
             / (s * dryrun.PEAK_FLOPS),
             peak_flops=dryrun.PEAK_FLOPS, hbm_bytes_per_s=dryrun.HBM_BW,
             argument_bytes=info["per_device_bytes"]["argument"],
             peak_estimate_bytes=info["per_device_bytes"]["peak"], measured_peak_bytes=peak,
             nvidia_smi=smi)


def compiled_phase(dev, smi, reset_launches, expected_launches):
    """Phase 7, ``compiled``: the captured solve loop on the card (see the
    module docstring).  ``smi`` is the card's name and power limit;
    ``reset_launches`` and ``expected_launches`` are main's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import AutoDiffAdjoint, CompiledSolver, Stepper, sharded_solve
    from repro_torch.kernels import ops
    from repro_torch.tools import workloads

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def held(label, got, want, skip=(),
             reason="the replayed kernels round otherwise than the eager launches"):
        """Equal step counts and status; ys bitwise, or within 1e-6 relative
        with the reason printed."""
        for k in ("n_steps", "n_accepted", "n_initialized"):
            if k not in skip:
                check(torch.equal(got.stats[k], want.stats[k]), f"{label}: {k} differs")
        check(torch.equal(got.status, want.status), f"{label}: status differs")
        bitwise = bool(torch.equal(got.ys, want.ys) and all(
            torch.equal(got.stats[k], want.stats[k]) for k in want.stats if k not in skip))
        scale = float(want.ys.abs().max())
        rel = float((got.ys - want.ys).abs().max()) / max(scale, 1e-30)
        check(bitwise or rel <= 1e-6, f"{label}: ys differ by {rel} relative")
        out = dict(bitwise=bitwise, ys_max_rel_diff=rel)
        if not bitwise:
            out["why_not_bitwise"] = reason
            print(f"compiled: {label} not bitwise, ys within {rel} relative: {reason}",
                  flush=True)
        return out

    vf, y0, te, kw = workloads.vdp_table3(np.float32)
    wide_vf, wide_y0, wide_te, wide_kw = workloads.full_width_long(dev)
    cases = [("vdp_table3", vf, y0, te, dict(rtol=kw["rtol"], atol=kw["atol"],
                                             max_steps=kw["max_steps"]), kw["args"]),
             ("full_width_long", wide_vf, wide_y0, wide_te,
              dict(rtol=wide_kw["rtol"], atol=wide_kw["atol"]), wide_kw["args"])]
    for workload, f, y, t_eval, drv_kw, args in cases:
        for path in ("unfused", "fused"):
            label = f"compiled/{workload}/{path}"
            drv = AutoDiffAdjoint(Stepper("dopri5"), fused=path == "fused", **drv_kw)

            def eager_solve(d=drv):
                return d.solve(f, y, t_eval, args=args, device=dev)

            eager_solve()  # warm-up
            eager_runs = [timed(eager_solve) for _ in range(3)]
            eager = eager_runs[0][0]
            iters = int(eager.stats["n_steps"].max())
            eager_ms = statistics.median(ms for _, ms in eager_runs)

            # 7a. One entry: the first call captures, the next two replay.
            solver = CompiledSolver(drv, donate=False, k=16)
            reset_launches()
            first, capture_ms = timed(lambda: solver.solve(f, y, t_eval, args=args,
                                                           device=dev))
            launches = dict(ops.launches)
            runner = solver.compile(f, y, t_eval, args=args, device=dev).runner
            want = expected_launches(7, 1 + sum(runner.sizes), path)
            check(launches == want, f"{label}: launches during the capture {launches} != {want}")
            vs_eager = [held(f"{label} call 1", first, eager)]
            replay_ms = []
            for i in (2, 3):
                sol, ms = timed(lambda: solver.solve(f, y, t_eval, args=args, device=dev))
                replay_ms.append(ms)
                vs_eager.append(held(f"{label} call {i}", sol, eager))
            check(dict(ops.launches) == launches,
                  f"{label}: a replay launched through a kernel wrapper")
            info = solver.cache_info()
            check((info.misses, info.hits) == (1, 3), f"{label}: cache {info}")
            per_solve = dict(captures=runner.captures, replays=runner.replays / 3,
                             host_reads=runner.reads / 3, eager_host_reads=iters)

            # 7b. A second rtol through the same entry: no new capture.
            rtol2 = drv_kw["rtol"] / 10
            captures = runner.captures
            second = solver.solve(f, y, t_eval, args=args, rtol=rtol2, device=dev)
            check(solver.cache_info().misses == 1 and runner.captures == captures,
                  f"{label}: a second rtol built or captured anew")
            at_rtol2 = held(f"{label} rtol {rtol2}", second,
                            eager_solve(dataclasses.replace(drv, rtol=rtol2)))

            # 7c. Between init and finish, the buffer loads and every
            # replay under set_sync_debug_mode("error"); the flag reads
            # between blocks may wait on the device.  A graph launch is not
            # instrumented, so what shows that no step syncs is the capture
            # itself, which raises on a sync.
            def guarded(fn):
                def call(*a, **kw):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return fn(*a, **kw)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                return call

            runner.start, runner.replay = guarded(runner.start), guarded(runner.replay)
            replays = runner.replays
            held(f"{label} sync-guarded", solver.solve(f, y, t_eval, args=args, device=dev),
                 eager)
            check(runner.replays > replays, f"{label}: no guarded replay ran")
            del runner.start, runner.replay
            nodes, pool_bytes = runner.graph_nodes(), runner.pool_bytes()
            check(all(n > 0 for n in nodes.values()) and pool_bytes > 0,
                  f"{label}: nodes {nodes}, pool {pool_bytes} bytes")

            # 7d. ms per step, eager against captured at k = 1, 16 and 64
            # (over the eager loop's iterations; a larger k runs more
            # masked steps after the last row stops).
            ms_per_step = {"eager": eager_ms / iters, "k16": statistics.median(replay_ms) / iters}
            first_call_ms = {"k16": capture_ms}
            for k in (1, 64):
                other = CompiledSolver(drv, donate=False, k=k)
                _, first_call_ms[f"k{k}"] = timed(
                    lambda s=other: s.solve(f, y, t_eval, args=args, device=dev))
                runs = [timed(lambda s=other: s.solve(f, y, t_eval, args=args, device=dev))
                        for _ in range(3)]
                for sol, _ in runs:
                    held(f"{label} k={k}", sol, eager)
                ms_per_step[f"k{k}"] = statistics.median(ms for _, ms in runs) / iters
                del other, runs
            emit("compiled", workload=workload, path=path, nvidia_smi=smi, b=int(y.shape[0]),
                 f=int(y.shape[1]), iterations=iters, k=16, per_solve=per_solve,
                 nodes_per_graph=nodes, graph_pool_bytes=pool_bytes,
                 buffer_bytes=runner.buffer_bytes,
                 first_call_ms=first_call_ms, ms_per_step=ms_per_step,
                 capture_launches=launches, capture_launches_expected=want,
                 vs_eager=vs_eager, second_rtol=dict(rtol=rtol2, **at_rtol2),
                 sync_debug_loads_and_replays="no sync", as_text=solver.compile(
                     f, y, t_eval, args=args, device=dev).as_text())
            del solver, runner, first, second, eager, eager_runs
            torch.cuda.empty_cache()

    # 7e. sharded_solve over two streams of the card on a ragged batch,
    # against the unsharded entry (all but n_f_evals: a shard stops
    # evaluating once its own rows are done).
    rng = np.random.default_rng(5)
    yb = (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((1023, 2))).astype(np.float32)
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=kw["rtol"], atol=kw["atol"],
                          max_steps=kw["max_steps"])
    whole = CompiledSolver(drv, donate=False)
    whole.solve(vf, yb, te, args=kw["args"], device=dev)
    ref, whole_ms = timed(lambda: whole.solve(vf, yb, te, args=kw["args"], device=dev))
    shard_ms = []
    for _ in range(3):
        got, ms = timed(lambda: sharded_solve([dev, dev], vf, yb, te, args=kw["args"],
                                              solver=drv))
        check(got.ys.shape == ref.ys.shape, f"compiled/sharded: shape {tuple(got.ys.shape)}")
        vs = held("compiled/sharded", got, ref, skip=("n_f_evals",),
                  reason="a shard's batch size differs from the whole batch's")
        shard_ms.append(ms)
    emit("compiled", workload="vdp_table3", case="sharded_solve([cuda:0, cuda:0]), b = 1023",
         nvidia_smi=smi, iterations=int(ref.stats["n_steps"].max()), unsharded_ms=whole_ms,
         sharded_ms=shard_ms, vs_unsharded=vs)
    torch.cuda.empty_cache()


def grad_phase(dev, median_ms, reset_launches):
    """Phase 13, ``grad``: the gradient path on the card (see the module
    docstring).  ``median_ms`` and ``reset_launches`` are main's."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.core import BacksolveAdjoint, ScanAdjoint
    from repro_torch.core.step import StepFunction
    from repro_torch.kernels import cuda_impl, ops, ref
    from repro_torch.tools import grad_checks, workloads

    FOUR = grad_checks.EXPLICIT

    # 12a. Each backward on the card against torch.autograd.grad of the plain
    # op on the card, same inputs: vdp_table3's and full_width's shapes, both
    # dtypes, every case of grad_checks (its window included); then each
    # backward's time at full_width float32 beside the plain op's.
    worst = dict.fromkeys(FOUR, 0.0)
    timed = {}
    for shape_name, shp in (("vdp_table3", workloads.VDP), ("full_width", workloads.FULL)):
        for dtype in (np.float32, np.float64):
            tdtype = torch.float32 if dtype == np.float32 else torch.float64
            for case in grad_checks.cases(shp["b"], shp["f"], shp["n"], dtype):
                op = case["op"]
                want = grad_checks.case_grads(case, grad_checks.plain(op), dev)
                got = grad_checks.case_grads(case, grad_checks.function(op), dev)
                worst[op] = max(worst[op], grad_checks.hold(f"grad/{op}[{case['label']}]",
                                                            got, want, tdtype))
                if (shape_name == "full_width" and dtype == np.float32
                        and case["label"] in ("j=6", "dopri5", "tol=scalar", "mask=run3")):
                    timed[op] = grad_checks.time_backward(case, dev, median_ms)
                del want, got
            torch.cuda.empty_cache()
    # The backward times are CUDA-event times of torch.autograd.grad; where
    # its dispatch outlasts the 0.5 ms the device sleeps first, they hold
    # host time (profile_step.py --grad gives the device time).
    emit("grad", check="backwards vs plain autograd on the card",
         tol={"float32": 1e-5, "float64": 1e-12}, max_abs_err=worst,
         backward_ms_full_width_float32=timed)

    split("grad/12a")
    # 12b. Reduced float64 twin of full_width_train, card against CPU: the
    # ScanAdjoint gradients w.r.t. y0 and every weight (with and without
    # checkpointing) and BacksolveAdjoint's, joint and per_instance.
    held = {}
    for label, kw in (("scan", dict(driver="scan")),
                      ("scan/checkpoint_every=16", dict(driver="scan", checkpoint_every=16)),
                      ("backsolve/joint", dict(driver="backsolve", mode="joint")),
                      ("backsolve/per_instance", dict(driver="backsolve", mode="per_instance"))):
        reset_launches()
        card = grad_checks.train_grads(dev, **kw)
        # The backsolve tracks the final state only: no dense output.
        used = FOUR if kw["driver"] == "scan" else FOUR[:3]
        check(all(ops.launches[k] > 0 for k in used),
              f"grad/{label}: {used} did not all launch: {dict(ops.launches)}")
        held[label] = grad_checks.hold_card_to_cpu(f"grad/{label}", card,
                                                   grad_checks.train_grads("cpu", **kw))
    # No fallback: with the four plain ops made to raise, a card gradient
    # still succeeds.
    def plain_ran(*a, **k):
        raise AssertionError("a plain op ran on the card")

    with mock.patch.multiple(ref, stage_accum=plain_ran, fused_update=plain_ran,
                             error_norm=plain_ran, interp_eval=plain_ran,
                             interp_eval_window=plain_ran):
        _, no_fallback, _ = grad_checks.train_grads(dev, rows=4)
    check(all(np.isfinite(g).all() for g in no_fallback), "grad: no-fallback gradient")
    emit("grad", check="reduced float64 twin, card vs CPU", rule=grad_checks.CARD_VS_CPU,
         max_rel_diff=held, shape=workloads.TRAIN_REDUCED, plain_ops_made_to_raise="passed")

    split("grad/12b")
    # 12c. The slice at full width: full_width_train in float32 through
    # ScanAdjoint(max_steps=64, checkpoint_every=16), three SGD steps.  Per
    # training step the forward runs every loop iteration (masked no-ops
    # included) and the backward runs each checkpointed block once more.
    vf, y0, te, kw, target = workloads.full_width_train(dev)
    weights = kw["args"]
    tr = workloads.TRAIN
    y0t = torch.as_tensor(y0, device=dev).requires_grad_()
    opt = torch.optim.SGD(list(weights.values()), lr=tr["lr"])
    tols = dict(rtol=kw["rtol"], atol=kw["atol"])

    def per_iteration(times):
        return {k: (times * {"stage_accum": 6}.get(k, 1) if k in FOUR else 0)
                for k in ops.launches}

    def train_step(every, sgd=True):
        drv = ScanAdjoint(max_steps=tr["max_steps"], checkpoint_every=every, **tols)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # What earlier phases and the weights hold is not the step's.
        held_before = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        sol = drv.solve(vf, y0t, te, args=weights, device=dev)
        loss = workloads.mse(sol.ys, target)
        opt.zero_grad()
        y0t.grad = None
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        want = per_iteration(tr["max_steps"] * (2 if every else 1))
        check(launches == want, f"grad/full_width_train: launches {launches} != {want}")
        grads = [y0t.grad, *(w.grad for w in weights.values())]
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              "grad/full_width_train: a gradient is not finite")
        check(bool(torch.isfinite(loss)), "grad/full_width_train: the loss is not finite")
        out = dict(loss=float(loss.detach()), ms=ms,
                   peak_bytes_above_start=torch.cuda.max_memory_allocated() - held_before,
                   launches=launches, max_loop_steps=int(sol.stats["n_steps"].max()),
                   rows_not_success=int((sol.status != 0).sum()),
                   grad_norm=float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads[1:]))),
                   dL_dy0=y0t.grad.detach().clone())
        if sgd:
            opt.step()
        return out

    train_step(tr["checkpoint_every"], sgd=False)  # warm-up: cuBLAS plans, the allocator
    steps = [train_step(tr["checkpoint_every"]) for _ in range(tr["steps"])]
    losses = [st["loss"] for st in steps]
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"grad/full_width_train: the loss did not fall: {losses}")
    plain = train_step(0, sgd=False)
    dl_dy0 = steps[0].pop("dL_dy0")
    for st in (*steps, plain):
        st.pop("dL_dy0", None)

    # dL/dy0 of rows 0-31 against a CPU run of rows 0-31 alone, at the
    # first step's weights (before any SGD step): the loss of the whole
    # batch is a mean, so both are scaled to the sum of squares.  The float32
    # rule, as C-5 holds ys: within the float32 gradient's own global error
    # (its distance to a float64 gradient at tol 1e-10, rows 0-31 on the
    # card), never below 1e-4 of that gradient's size -- a decision near
    # err_ratio = 1 may flip between two roundings, and moves the gradient
    # by up to that error.
    rows = 32
    b, n, f = target.shape
    card32 = dl_dy0[:rows].double().cpu().numpy() * (b * n * f)
    w0 = workloads.full_width_train("cpu")[3]["args"]

    def rows_grad(device, dtype, rtol, max_steps):
        w = {k: v.detach().to(device=device, dtype=dtype).requires_grad_() for k, v in
             w0.items()}
        y = torch.as_tensor(y0[:rows], device=device, dtype=dtype).requires_grad_()
        sol = ScanAdjoint(max_steps=max_steps, rtol=rtol, atol=rtol).solve(
            vf, y, te.astype(np.float64) if dtype == torch.float64 else te, args=w,
            device=device)
        loss = ((sol.ys - target[:rows].to(device=device, dtype=dtype)) ** 2).sum()
        return (torch.autograd.grad(loss, [y])[0].double().cpu().numpy(),
                sol.stats["n_steps"].cpu().numpy())

    cpu32, cpu_steps = rows_grad("cpu", torch.float32, kw["rtol"], tr["max_steps"])
    truth, _ = rows_grad(dev, torch.float64, 1e-10, 640)
    d32 = float(np.abs(card32 - cpu32).max())
    global_err = float(np.abs(card32 - truth).max())
    bound = max(1e-4 * float(np.abs(truth).max()), global_err)
    check(d32 <= bound, f"grad/full_width_train: dL/dy0 rows 0-31 card vs CPU {d32} > {bound}")
    emit("grad", workload="full_width_train", dtype="float32", b=b, f=f, n_eval=n,
         hidden=workloads.FULL["hidden"], max_steps=tr["max_steps"],
         checkpoint_every=tr["checkpoint_every"], lr=tr["lr"], losses=losses,
         ms_per_training_step=[st["ms"] for st in steps], steps=steps,
         without_checkpoint=plain,
         dL_dy0_rows_0_31=dict(max_abs_diff_card_vs_cpu=d32, global_err_vs_tol1e10=global_err,
                               bound=bound, scale=float(np.abs(truth).max()),
                               cpu_steps=cpu_steps.tolist()))

    split("grad/12c")
    # 12d. ScanAdjoint's forward loop with no host read: the loop of a
    # training forward (grad on, checkpointed) runs under
    # torch.cuda.set_sync_debug_mode("error") from the end of init to the
    # start of finish.  A sync raises; then the loop runs once more under
    # "warn" and every synchronizing call site is named.
    def guarded(mode):
        real_init, real_finish = StepFunction.init, StepFunction.finish

        def init(self, *a, **k):
            out = real_init(self, *a, **k)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode(mode)
            return out

        def finish(self, *a, **k):
            torch.cuda.set_sync_debug_mode(0)
            return real_finish(self, *a, **k)

        drv = ScanAdjoint(max_steps=tr["max_steps"], checkpoint_every=tr["checkpoint_every"],
                          **tols)
        with mock.patch.object(StepFunction, "init", init), \
                mock.patch.object(StepFunction, "finish", finish):
            try:
                return drv.solve(vf, y0t, te, args=weights, device=dev)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    syncs = []
    try:
        guarded("error")
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            guarded("warn")
        syncs = sorted({f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                        if "synchroniz" in str(w.message)})
    emit("grad", check="ScanAdjoint forward loop under set_sync_debug_mode('error')",
         syncs=syncs, loop_reads_nothing=not syncs)

    split("grad/12d")
    # 12e. BacksolveAdjoint (joint) at full width: full_width(t_end=1.0),
    # the MSE of y(t_end) against the target's last point.  Its weight
    # gradients against ScanAdjoint's: two discretizations of the same
    # gradient, each within the solver's tolerance of it (6.9e-5 apart in
    # relative norm on the CPU for rows 0-31); held to 1e-3.  The backward is
    # one augmented instance of 2bf + p entries.
    vf1, y01, te1, kw1 = workloads.full_width(dev)
    tgt1 = target[:, -1]

    def weight_grads(driver):
        w = {k: v.detach().clone().requires_grad_() for k, v in kw1["args"].items()}
        y = torch.as_tensor(y01, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        if driver == "scan":
            y1 = ScanAdjoint(max_steps=tr["max_steps"], **tols).solve(
                vf1, y, te1, args=w, device=dev).ys[:, -1]
        else:
            y1 = BacksolveAdjoint(mode="joint", **tols).solve(
                vf1, y, t_start=0.0, t_end=float(te1[-1]), args=w, device=dev)
        g = torch.autograd.grad(workloads.mse(y1, tgt1), list(w.values()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return torch.cat([x.reshape(-1) for x in g]).double(), ms, dict(ops.launches)

    weight_grads("backsolve")  # warm-up
    g_scan, scan_ms, _ = weight_grads("scan")
    g_bs, bs_ms, bs_launches = weight_grads("backsolve")
    check(bool(torch.isfinite(g_bs).all()), "grad/backsolve: gradient not finite")
    rel = float((g_bs - g_scan).norm() / g_scan.norm())
    check(rel <= 1e-3, f"grad/backsolve: joint vs ScanAdjoint weight gradients {rel} apart")
    aug = 2 * y01.shape[0] * y01.shape[1] + sum(v.numel() for v in kw1["args"].values())
    # The augmented instance's row through the kernels, each timed alone.
    g = torch.Generator(device="cpu").manual_seed(0)
    row = torch.randn(1, aug, generator=g).to(dev)
    K = torch.randn(7, 1, aug, generator=g).to(dev)
    dt1 = torch.full((1,), 0.1, device=dev)
    a = np.random.default_rng(0).standard_normal(7)
    wide = dict(
        error_norm=median_ms(lambda: cuda_impl.error_norm(1e-5 * row, row, K[0], 1e-5, 1e-5)),
        error_norm_body=cuda_impl.error_norm_body(aug),
        stage_accum_j6=median_ms(lambda: cuda_impl.stage_accum(row, dt1, K[:6], a[:6])),
        fused_update_s7=median_ms(lambda: cuda_impl.fused_update(row, K, dt1, a, a[::-1])))
    emit("grad", workload="full_width", driver="BacksolveAdjoint(joint)", t_end=float(te1[-1]),
         augmented_entries=aug, rel_norm_diff_vs_scan=rel, bound=1e-3,
         backsolve_ms=bs_ms, scan_ms=scan_ms, backsolve_launches=bs_launches,
         wide_row_kernels_ms=wide)

    grad_paths(dev, median_ms, reset_launches)


def grad_paths(dev, median_ms, reset_launches):
    """Phase 13, ``grad``, the paths that differentiate through the nine
    backwards of ``fused_step``, ``fused_step_poly``, the event kernels and
    the Newton kernels (see the module docstring).  ``median_ms`` and
    ``reset_launches`` are main's."""
    import numpy as np
    import torch

    from repro_torch.core import ScanAdjoint, solve_ivp
    from repro_torch.kernels import cuda_impl, ops, ref
    from repro_torch.tools import grad_checks, workloads

    NINE = grad_checks.FUSED + grad_checks.EVENTS + grad_checks.STIFF

    split("grad/12e")
    # 12f. The nine backwards on the card against torch.autograd.grad of the
    # plain op on the card (grad_checks.card_plain: the fused steps on the
    # unfused card path), same inputs, at each kernel's workload shape --
    # full_width for the fused and event kernels, allen_cahn_full for the
    # Newton kernels, vdp_table3 for all -- in both dtypes, by
    # grad_checks.hold_on_card: the event ops entry by entry; the fused steps
    # and the Newton ops in float64 each entry within tol x (1 + its batch
    # row's largest), in float32 each row's error against autograd of the
    # plain op in float64 within 2 x the float32 plain op's + tol x (1 + the
    # row's largest).  Each op's margin under its rule (the largest ratio to
    # the bound) and entry by entry (above 1 where that rule would refuse).  The LU cases with the kernel's permutation equal to LAPACK's.
    # Each backward's time at its main shape in float32 beside the plain
    # op's (torch.autograd.grad over a kept graph).
    worst = {op: {} for op in NINE}
    margin = {op: {} for op in NINE}
    rules = {op: {} for op in NINE}
    rule_margin = {op: {} for op in NINE}
    timed, cases_held = {}, 0
    shapes = (("vdp_table3", workloads.VDP["b"], workloads.VDP["f"], NINE),
              ("full_width", workloads.FULL["b"], workloads.FULL["f"],
               grad_checks.FUSED + grad_checks.EVENTS),
              ("allen_cahn_full", workloads.STIFF["b"], workloads.ALLEN_CAHN["f"],
               grad_checks.STIFF))
    main_label = {"fused_step": "dopri5/pid", "fused_step_poly": "dopri5/logistic",
                  "masked_bisect_refine": "active=mixed", "fused_event_detect": "E=3",
                  "fused_event_commit": "terminal=mixed", "batched_lu_factor": "chord",
                  "batched_linsolve": "chord", "fused_newton_iter": "chord/active=mixed",
                  "masked_newton_update": "chord/active=mixed"}
    for shape_name, b, f, ops_here in shapes:
        for dtype in (np.float32, np.float64):
            tdtype = torch.float32 if dtype == np.float32 else torch.float64
            for case in grad_checks.cases(b, f, 9, dtype, ops=ops_here):
                op = case["op"]
                if op == "batched_lu_factor":
                    A = torch.as_tensor(case["args"]["A"], device=dev)
                    check(torch.equal(cuda_impl.batched_lu_factor(A)[1],
                                      ref.batched_lu_factor(A)[1]),
                          f"grad/{op}[{case['label']}]: the kernel pivots apart from LAPACK")
                want = grad_checks.case_grads(case, grad_checks.card_plain(op), dev)
                got = grad_checks.case_grads(case, grad_checks.function(op), dev)
                key = f"{shape_name}/{dtype.__name__}"
                rules[op][dtype.__name__], err, held = grad_checks.hold_on_card(
                    f"grad/{op}[{case['label']}]", case, got, want, tdtype, dev)
                worst[op][key] = max(worst[op].get(key, 0.0), err)
                rule_margin[op][key] = max(rule_margin[op].get(key, 0.0), held)
                margin[op][key] = max(margin[op].get(key, 0.0),
                                      grad_checks.entry_margin(got, want, tdtype))
                cases_held += 1
                main = "allen_cahn_full" if op in grad_checks.STIFF else "full_width"
                if (shape_name == main and dtype == np.float32
                        and case["label"] == main_label[op]):
                    timed[op] = grad_checks.time_backward(case, dev, median_ms)
                del want, got
            torch.cuda.empty_cache()
    emit("grad", check="nine backwards vs plain autograd on the card", cases=cases_held,
         rule=rules,
         tol={"float32": 1e-5, "float64": 1e-12}, max_abs_err=worst, rule_margin=rule_margin,
         entry_margin=margin,
         backward_ms_main=timed)

    split("grad/12f")
    # 12g. The reduced float64 twins of the three paths, card against CPU:
    # equal step, event and Newton counts, gradients within 1e-9.
    twins = {"fused": lambda d: grad_checks.train_grads(d, fused=True, checkpoint_every=16),
             "events": lambda d: grad_checks.train_grads(d, events=True),
             "stiff": lambda d: grad_checks.stiff_grads(d),
             "stiff/factor_once": lambda d: grad_checks.stiff_grads(d, fused=True)}
    used = {"fused": ("fused_step", "stage_accum", "interp_eval"),
            "events": grad_checks.EVENTS, "stiff": ("batched_linsolve", "masked_newton_update"),
            "stiff/factor_once": ("batched_lu_factor", "fused_newton_iter", "fused_step")}
    held = {}
    for label, run in twins.items():
        reset_launches()
        card = run(dev)
        check(all(ops.launches[k] > 0 for k in used[label]),
              f"grad/{label}: {used[label]} did not all launch: {dict(ops.launches)}")
        cpu = run("cpu")
        held[label] = dict(max_rel_diff=grad_checks.hold_card_to_cpu(f"grad/{label}", card, cpu),
                           counts={k: int(v.sum()) for k, v in cpu[2].items()})
    emit("grad", check="reduced float64 twins of the three paths, card vs CPU",
         rule=grad_checks.CARD_VS_CPU, twins=held)

    def in_float64(path, first, data):
        """12h/12i, float64: a training step's first gradient (at the
        weights w0) against the same solve in float64 on the card at w0 --
        the same y0, grid, target and events, cast -- and the float64 loss
        along the SGD step (0.01 of lr x the gradient, the float32
        gradient's and the float64 one's) against its linear prediction
        -lr 0.01 g64 . g: a ratio near 1 says the gradient is the loss's
        slope there.  The unfused path without events is the control."""
        tols = dict(rtol=data["kw"]["rtol"], atol=data["kw"]["atol"])
        y0d = torch.as_tensor(data["y0"], device=dev).double()
        te = np.asarray(data["t_eval"], dtype=np.float64)
        target = data["target"].double()

        def solve(W):
            sol = ScanAdjoint(max_steps=tr["max_steps"], checkpoint_every=tr["checkpoint_every"],
                              events=data["kw"].get("events"), **tols).solve(
                data["vf"], y0d, te, args=W, device=dev)
            return workloads.mse(sol.ys, target), sol

        W = {k: v.double().requires_grad_() for k, v in data["w0"].items()}
        t0 = time.perf_counter()
        loss, sol = solve(W)
        g64 = torch.autograd.grad(loss, list(W.values()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(all(bool(torch.isfinite(g).all()) for g in g64), f"grad/{path}64: not finite")
        g32 = [g.double() for g in first["grads"][1:]]
        a, b = torch.cat([g.reshape(-1) for g in g32]), torch.cat([g.reshape(-1) for g in g64])
        steps64 = sol.stats["n_steps"].cpu().numpy()
        along = {}
        with torch.no_grad():
            base = float(loss)
            for label, g in (("float32", g32), ("float64", g64)):
                slope = float(sum((x * y).sum() for x, y in zip(g, g64)))
                for frac in (0.01,):
                    step = frac * tr["lr"]
                    moved = {k: W[k].detach() - step * gk for k, gk in zip(W, g)}
                    change = float(solve(moved)[0]) - base
                    along[f"{label}/{frac}"] = dict(loss_change=change, predicted=-step * slope,
                                                    ratio=change / (-step * slope))
        stopped = {} if path != "events" else dict(
            rows_stopped64=int((sol.status == 4).sum()), rows_stopped32=first["rows_stopped"])
        emit("grad", workload="full_width_train", path=path, check="float32 gradient vs "
             "the float64 card solve at the same weights; float64 loss along the SGD step",
             loss64=base, loss32=first["loss"], **stopped,
             cosine=float(a @ b / (a.norm() * b.norm())),
             rel_norm_diff=float((a - b).norm() / b.norm()),
             rows_same_n_steps=float((steps64 == first["n_steps"]).mean()),
             grad_norm32=float(a.norm()), grad_norm64=float(b.norm()), ms64=ms,
             along_sgd_step=along, lr=tr["lr"])

    split("grad/12g")
    # 12h. fused=True at full width: full_width_train through
    # ScanAdjoint(fused=True), one SGD step checkpointed and one step
    # without; exact launches (per loop iteration one fused_step, six
    # stage_accum, one interp_eval; twice with checkpointing).  Then the
    # fused gradient at the first weights against the unfused one.
    tr = workloads.TRAIN

    def train(events=False, fused=False, steps=tr["steps"]):
        vfx, y0x, tex, kwx, tgt = workloads.full_width_train(dev, events=events)
        weights = kwx["args"]
        y0t = torch.as_tensor(y0x, device=dev).requires_grad_()
        opt = torch.optim.SGD(list(weights.values()), lr=tr["lr"])
        tols = dict(rtol=kwx["rtol"], atol=kwx["atol"])

        def drv(every):
            return ScanAdjoint(max_steps=tr["max_steps"], checkpoint_every=every, fused=fused,
                               events=kwx.get("events"), **tols)

        def step(every, sgd=True):
            # The forward's launches at these weights (the bisections follow
            # the events that fire), for the exact counts.
            with torch.no_grad():
                reset_launches()
                drv(0).solve(vfx, y0t, tex, args=weights, device=dev)
                forward = dict(ops.launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_before = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            sol = drv(every).solve(vfx, y0t, tex, args=weights, device=dev)
            loss = workloads.mse(sol.ys, tgt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.zero_grad()
            y0t.grad = None
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = dict(ops.launches)
            want = {k: v * (2 if every else 1) for k, v in forward.items()}
            check(launches == want, f"grad/train: launches {launches} != {want}")
            grads = [y0t.grad, *(w.grad for w in weights.values())]
            check(all(bool(torch.isfinite(g).all()) for g in grads),
                  "grad/train: a gradient is not finite")
            out = dict(loss=float(loss.detach()), ms=(t2 - t0) * 1e3,
                       forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                       peak_bytes_above_start=torch.cuda.max_memory_allocated() - held_before,
                       launches={k: v for k, v in launches.items() if v},
                       max_loop_steps=int(sol.stats["n_steps"].max()),
                       n_steps=sol.stats["n_steps"].cpu().numpy(),
                       grads=[g.detach().clone() for g in grads])
            if events:
                out["rows_stopped"] = int((sol.status == 4).sum())
                out["events_recorded"] = int(sol.stats["n_events"].sum())
            if sgd:
                opt.step()
            return out

        step(tr["checkpoint_every"], sgd=False)  # warm-up
        w0 = {k: w.detach().clone() for k, w in weights.items()}
        first = step(tr["checkpoint_every"], sgd=False)
        runs = [step(tr["checkpoint_every"]) for _ in range(steps)]
        check(all(bool(np.isfinite(r["loss"])) for r in runs), "grad/train: a loss is not finite")
        # One step without checkpointing at the last weights, no SGD: its
        # launches are the no-grad forward's.  (The ms of a training step
        # with and without checkpointing, repeated, is profile_step.py
        # --grad's measurement.)
        without = step(0, sgd=False) if steps else None
        data = dict(vf=vfx, y0=y0x, t_eval=tex, kw=kwx, target=tgt, w0=w0)
        return first, runs, without, data

    def public(run):
        return {k: v for k, v in run.items() if k not in ("grads", "n_steps")}

    unfused_first, _, _, unfused_data = train(steps=0)
    in_float64("unfused", unfused_first, unfused_data)
    del unfused_data
    # One SGD step each for the fused and events paths: 12c's three steps
    # show the loss along training, and more steps here would repeat the
    # same exact-launch and finiteness checks (``without`` makes them at the
    # weights after the step).
    first, runs, without, _ = train(fused=True, steps=1)
    check(np.array_equal(first["n_steps"], unfused_first["n_steps"]),
          "grad/fused: step counts differ from the unfused training step")
    # The float32 rule (C-5's floor): each fused gradient within 1e-4 of the
    # unfused one's largest entry -- the two backwards sum in other orders,
    # and a decision near err_ratio = 1 may flip between two roundings.
    fused_vs = []
    for g, w in zip(first["grads"], unfused_first["grads"]):
        d = float((g - w).abs().max() / w.abs().max())
        fused_vs.append(d)
        check(d <= 1e-4, f"grad/fused: fused vs unfused gradient {d} relative")
    emit("grad", workload="full_width_train", path="fused", dtype="float32",
         max_steps=tr["max_steps"], checkpoint_every=tr["checkpoint_every"],
         losses=[r["loss"] for r in runs], steps=[public(r) for r in runs],
         without_checkpoint=public(without), fused_vs_unfused_rel=fused_vs, bound=1e-4)

    split("grad/12h")
    # 12i. events= at full width: full_width_long_events' RMS stop and marker
    # on the training solve, the same loss and SGD; exact launches (a no-grad
    # forward's at the same weights, twice with checkpointing).
    first, runs, without, data = train(events=True, steps=1)
    check(first["rows_stopped"] > 0 and first["events_recorded"] > 0,
          "grad/events: no event fired in the training solve")
    emit("grad", workload="full_width_train", path="events", dtype="float32",
         events=["rms_stop", "marker"], losses=[r["loss"] for r in runs],
         steps=[public(r) for r in runs], without_checkpoint=public(without),
         rows_stopped=first["rows_stopped"], events_recorded=first["events_recorded"])
    in_float64("events", first, data)
    del data
    torch.cuda.empty_cache()

    split("grad/12i")
    # 12j. The stiff path at full width: allen_cahn_full (b = 1024, f = 128,
    # kvaerno5, float32), the mean square of the final state differentiated
    # in y0 and lam, through ScanAdjoint with max_steps the eager card
    # solve's iterations + 4; unfused Newton and factor-once; exact launches
    # (the no-grad forward's), finite gradients, ms and peak memory (under
    # 16 GB: batched_linsolve saves no factor).
    STIFF_REPS = 2  # likewise
    vfs, y0s, _, kws = workloads.allen_cahn_full(np.float32)
    with torch.no_grad():
        eager = solve_ivp(vfs, y0s, None, device=dev, **kws)
    max_steps = int(eager.stats["n_steps"].max()) + 4
    stiff = {}
    for label, fused in (("unfused", False), ("factor_once", True)):
        with torch.no_grad():
            reset_launches()
            lam = torch.tensor(kws["args"], dtype=torch.float32, device=dev)
            ScanAdjoint(kws["method"], rtol=kws["rtol"], atol=kws["atol"], max_steps=max_steps,
                        fused=fused).solve(vfs, torch.as_tensor(y0s, device=dev), None,
                                           t_start=kws["t_start"], t_end=kws["t_end"], args=lam,
                                           device=dev)
            forward = dict(ops.launches)
        grad_checks.stiff_grads(dev, fused=fused, reduced=False, max_steps=max_steps)  # warm-up
        times = []
        for _ in range(STIFF_REPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_before = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            loss, grads, counts = grad_checks.stiff_grads(dev, fused=fused, reduced=False,
                                                          max_steps=max_steps)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - held_before
            check(dict(ops.launches) == forward,
                  f"grad/stiff/{label}: launches {dict(ops.launches)} != {forward}")
            check(all(np.isfinite(g).all() for g in grads), f"grad/stiff/{label}: not finite")
            check(peak < 16e9, f"grad/stiff/{label}: peak {peak} bytes")
        stiff[label] = dict(ms_median=statistics.median(times), ms_min=min(times),
                            ms_max=max(times), reps=len(times), peak_bytes_above_start=peak,
                            loss=loss,
                            dL_dlam=float(grads[1]),
                            launches={k: v for k, v in forward.items() if v},
                            n_steps_max=int(counts["n_steps"].max()),
                            newton_iters=int(counts["n_newton_iters"].sum()))
    emit("grad", workload="allen_cahn_full", path="stiff", dtype="float32",
         max_steps=max_steps, max_steps_rule="eager card solve's iterations + 4",
         eager_iterations=max_steps - 4, runs=stiff)



def serve_phase(dev, smi, reset_launches, expected_launches):
    """Phase 14, ``serve_ode``: the request service on the card (see the
    module docstring).  ``smi`` is the card's name and power limit;
    ``reset_launches`` and ``expected_launches`` are main's."""
    import numpy as np
    import torch

    from repro_torch.core import (AutoDiffAdjoint, CompiledSolver, GradRequest, SolveService,
                                  Stepper)
    from repro_torch.kernels import ops
    from repro_torch.tools import serve_checks as sc

    def serve(svc, reqs, split=None):
        """Every request submitted, then flushed; wall seconds to the last
        result in hand (on the host).  ``split`` receives the seconds spent
        submitting, flushing and collecting the results."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [svc.submit(r) for r in reqs]
        t1 = time.perf_counter()
        svc.flush()
        t2 = time.perf_counter()
        sols = [f.result() for f in futs]
        t3 = time.perf_counter()
        if split is not None:
            split.update(submit_s=t1 - t0, flush_s=t2 - t1, results_s=t3 - t2)
        return sols, t3 - t0

    def entries(svc):
        return [(i, e) for slots in svc._solvers.values() for i, s in enumerate(slots)
                for e in s._cache.data.values()]

    def rel_close(label, got, want, tol=1e-9):
        d = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        check(d <= tol * scale, f"{label}: differs by {d} (> {tol} x {scale})")
        return d

    def bitwise(label, got, ref):
        for i, (g, r) in enumerate(zip(got, ref)):
            same = (torch.equal(g.ys, r.ys) and torch.equal(g.ts, r.ts)
                    and torch.equal(g.status, r.status)
                    and all(torch.equal(g.stats[k], r.stats[k]) for k in r.stats))
            check(same, f"{label}: request {i} differs")

    # 13a. The reference stream in float64, card against CPU.
    reqs = sc.to_requests(sc.make_stream(96, seed=0, dense_every=3, dtype=np.float64),
                          sc.decay)
    ref_svc = SolveService(max_batch=16, max_delay=None, devices=[dev],
                           default_method="dopri5")
    card, _ = serve(ref_svc, reqs)
    host, _ = serve(SolveService(max_batch=16, max_delay=None, devices=["cpu"],
                                 default_method="dopri5"), reqs)
    worst = 0.0
    for i, (g, w) in enumerate(zip(card, host)):
        check(torch.equal(g.status, w.status), f"serve_ode/reference: status of {i}")
        for k in ("n_steps", "n_accepted"):
            check(torch.equal(g.stats[k], w.stats[k]), f"serve_ode/reference: {k} of {i}")
        worst = max(worst, rel_close(f"serve_ode/reference {i}", g.ys, w.ys))
    emit("serve_ode", stream="reference (make_stream: decay, features 2/3/5, every third "
         "dense)", dtype="float64", requests=len(reqs), vs_cpu_max_abs=worst, tol=1e-9,
         all_success=all(bool(s.success.all()) for s in card),
         **{k: ref_svc.stats()[k] for k in ("n_buckets", "n_batches", "pad_waste")})

    split("serve_ode/13a")
    # 13b/d/f. The full-width stream, with a window of 4 and blocking: four
    # passes each through one service.  Each pass launches exactly the
    # kernels of the entries it captures (the warm-up step and each block
    # of the capture) and nothing for the replays.  Which slot a batch takes
    # depends on whether the slot's entry is still in flight, so a later
    # pass may capture an entry in a slot the first pass did not need.
    S = sc.FULL_STREAM
    f, dicts = sc.full_width_stream(dev)
    reqs = sc.to_requests(dicts, f)

    def capture_launches(ents, before, path):
        want = dict.fromkeys(ops.launches, 0)
        for _, e in ents:
            if e.runner is not None and e.runner.captures > before.get(id(e), 0):
                one = expected_launches(7, 1 + sum(e.runner.sizes), path,
                                        dense=e.key[3] is not None)
                for k in want:
                    want[k] += one[k]
        return want

    def one_pass(label, svc, stream_reqs, path, ref=None):
        """One pass of ``stream_reqs`` through ``svc``: exact capture
        launches and none for replays, the pass's counters, its wall time
        split, and the peak device memory above its start; held bitwise to
        ``ref`` when given."""
        ents = entries(svc)
        before = {id(e): e.runner.captures for _, e in ents if e.runner is not None}
        reads = {id(e): e.runner.reads for _, e in ents if e.runner is not None}
        st0 = svc.stats()
        reset_launches()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        split = {}
        sols, wall = serve(svc, stream_reqs, split)
        peak = torch.cuda.max_memory_allocated() - start
        launches = dict(ops.launches)
        ents = entries(svc)
        want = capture_launches(ents, before, path)
        check(launches == want, f"{label}: launches {launches} != {want}")
        st = svc.stats()
        batches = st["n_batches"] - st0["n_batches"]
        captures = sum(e.runner.captures - before.get(id(e), 0) for _, e in ents
                       if e.runner is not None)
        host_reads = sum(e.runner.reads - reads.get(id(e), 0) for _, e in ents
                         if e.runner is not None)
        check(st["n_failed_batches"] == 0, f"{label}: a batch failed")
        check(all(bool(torch.isfinite(s.ys).all()) and bool(s.success.all()) for s in sols),
              f"{label}: output not finite or not SUCCESS")
        if ref is not None:
            bitwise(label, sols, ref)
        d = {k: st[k] - st0[k] for k in ("queue_s", "pack_s", "device_s", "n_rows",
                                         "n_pad_rows", "n_backpressure_waits")}
        return sols, dict(
            wall_s=wall, requests_per_s=len(sols) / wall, **split, batches=batches,
            launches=launches, captures=captures, captures_per_batch=captures / batches,
            host_reads_per_batch=host_reads / batches, pad_waste=d["n_pad_rows"] / d["n_rows"],
            **d, peak_inflight=st["peak_inflight"], peak_bytes_above_start=peak)

    def entry_rows(svc):
        return [dict(slot=i, dense=e.key[3] is not None, b=int(e.key[2][0][0]),
                     buffer_bytes=e.runner.buffer_bytes, pool_bytes=e.runner.pool_bytes(),
                     captures=e.runner.captures, replays=e.runner.replays,
                     host_reads=e.runner.reads)
                for i, e in entries(svc)]

    # Both services live side by side: a first pass each (it captures), then
    # timed passes in turns (async, sync, sync, async, ...), each held
    # bitwise to its service's first pass.  Only the first pass keeps its
    # solutions, so a later pass's pinned host copies reuse the memory the
    # pass before it freed, as a serving loop whose callers drop their
    # results does.
    windows = {"async": S["max_inflight"], "sync": 0}
    services = {mode: SolveService(max_batch=S["max_batch"], max_delay=None,
                                   max_inflight=window, devices=[dev])
                for mode, window in windows.items()}
    full, runs = {}, {mode: [] for mode in windows}
    for mode, svc in services.items():
        full[mode], run = one_pass(f"serve_ode/full_width/{mode} pass 1", svc, reqs, "unfused")
        runs[mode].append(run)
    bitwise("serve_ode/full_width async vs sync", full["async"], full["sync"])
    for n, mode in enumerate(["async", "sync", "sync", "async"]):
        _, run = one_pass(f"serve_ode/full_width/{mode} timed pass {n}", services[mode], reqs,
                          "unfused", ref=full[mode])
        runs[mode].append(run)
    for mode, svc in services.items():
        timed_rps = [r["requests_per_s"] for r in runs[mode][1:]]
        emit("serve_ode", stream="full_width", mode=mode, nvidia_smi=smi, requests=len(reqs),
             max_batch=S["max_batch"], max_inflight=windows[mode],
             requests_per_s_timed=timed_rps,
             requests_per_s_median=statistics.median(timed_rps),
             passes=runs[mode], entries=entry_rows(svc))
    del services, runs
    torch.cuda.empty_cache()

    split("serve_ode/13b")
    # 13c. 16 requests chosen by seed, solved alone at b = 1 through
    # CompiledSolver, against their served rows: within the float32 global
    # error of the served rows against a float64 solve at 1e-9 (C-5's rule).
    pick = sorted(np.random.default_rng(1).choice(len(reqs), 16, replace=False).tolist())
    solver = CompiledSolver(AutoDiffAdjoint(Stepper("dopri5")), donate=False)
    f64, _ = sc.full_width_stream(dev, n=1, dtype=np.float64)
    truth_drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-9, atol=1e-9)
    n_class = S["eval_points"][1]

    def truths(idx):
        """float64 solves of the requests ``idx`` as one batch (the dense
        ones on their grids padded to the class, as served)."""
        rows = [reqs[i] for i in idx]
        y0 = torch.as_tensor(np.stack([r.y0 for r in rows])).double()
        t1 = torch.tensor([float(np.float32(r.t1)) for r in rows], dtype=torch.float64)
        te = None
        if rows[0].t_eval is not None:
            te = torch.as_tensor(np.stack([np.concatenate(
                [r.t_eval, np.full(n_class - len(r.t_eval), r.t_eval[-1])]) for r in rows]))
            te = te.double()
        sol = truth_drv.solve(f64, y0, te, t_start=torch.zeros(len(rows), dtype=torch.float64),
                              t_end=t1, device=dev)
        ys = sol.ys.cpu()
        return {i: ys[j] if r.t_eval is None else ys[j, :len(r.t_eval)]
                for j, (i, r) in enumerate(zip(idx, rows))}

    truth = {}
    for dense in (False, True):
        idx = [i for i in pick if (reqs[i].t_eval is not None) == dense]
        if idx:
            truth.update(truths(idx))
    diffs, errs, step_diff = [], [], 0
    for i in pick:
        r, got = reqs[i], full["sync"][i]
        y0 = torch.as_tensor(r.y0)[None]
        te = None if r.t_eval is None else torch.as_tensor(r.t_eval)[None]
        vec = lambda v: torch.tensor([v], dtype=torch.float32)
        alone = solver.solve(f, y0, te, t_start=vec(0.0), t_end=vec(r.t1), rtol=vec(r.rtol),
                             atol=vec(r.atol), device=dev)
        check(torch.equal(alone.status.cpu(), got.status), f"serve_ode/alone {i}: status")
        errs.append(float((got.ys[0].double() - truth[i]).abs().max()))
        diffs.append(float((alone.ys.cpu() - got.ys).abs().max()))
        want_steps = int(got.stats["n_steps"][0])
        d = abs(int(alone.stats["n_steps"][0]) - want_steps)
        check(d <= int(np.ceil(0.1 * want_steps)), f"serve_ode/alone {i}: steps differ by {d}")
        step_diff = max(step_diff, d)
    global_err = max(errs)
    check(max(diffs) <= max(1e-4, global_err),
          f"serve_ode/alone: {max(diffs)} > {max(1e-4, global_err)}")
    emit("serve_ode", check="16 requests alone (b = 1) vs their served rows", requests=pick,
         max_abs_diff=max(diffs), global_err=global_err, max_step_diff=step_diff,
         rows_bitwise=sum(d == 0.0 for d in diffs))
    del solver
    torch.cuda.empty_cache()

    split("serve_ode/13c")
    # 13d. A fused bucket: the first 2048 requests through
    # AutoDiffAdjoint(Stepper("dopri5"), fused=True); fused_step launches
    # during the capture only.  Its rows within the float32 global error of
    # the unfused served rows.
    label = "serve_ode/full_width/fused"
    fused_drv = AutoDiffAdjoint(Stepper("dopri5"), fused=True)
    svc = SolveService(max_batch=S["max_batch"], max_delay=None,
                       max_inflight=S["max_inflight"], devices=[dev],
                       default_method=fused_drv)
    fused_sols, first = one_pass(f"{label} pass 1", svc, reqs[:2048], "fused")
    _, second = one_pass(f"{label} pass 2", svc, reqs[:2048], "fused", ref=fused_sols)
    check(first["launches"]["fused_step"] > 0, f"{label}: fused_step was not launched")
    d = max(float((a.ys - b.ys).abs().max()) for a, b in zip(fused_sols, full["sync"]))
    check(d <= max(1e-4, global_err), f"{label}: fused vs unfused {d}")
    emit("serve_ode", stream="full_width, first 2048, fused", nvidia_smi=smi,
         passes=[first, second], entries=entry_rows(svc), vs_unfused_max_abs=d,
         global_err=global_err)
    del svc, fused_sols, full
    torch.cuda.empty_cache()

    split("serve_ode/13d")
    # 13e. A float64 GradRequest stream (ScanAdjoint), card against CPU.
    greqs = sc.to_requests(sc.grad_stream(64, seed=2, feats=(2, 3, 5), dtype=np.float64),
                           sc.decay, cls=GradRequest)
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        svc = SolveService(max_batch=32, max_delay=None, devices=[device],
                           default_method="dopri5")
        out[name], wall = serve(svc, greqs)
        check(svc.stats()["n_grad_solves"] == len(greqs), f"serve_ode/grad/{name}: count")
    worst = dict(ys=0.0, y0=0.0, args=0.0)
    for i, ((gv, gg), (wv, wg)) in enumerate(zip(out["card"], out["cpu"])):
        check(torch.equal(gv.stats["n_steps"], wv.stats["n_steps"]),
              f"serve_ode/grad: n_steps of {i}")
        worst["ys"] = max(worst["ys"], rel_close(f"serve_ode/grad ys {i}", gv.ys, wv.ys))
        worst["y0"] = max(worst["y0"], rel_close(f"serve_ode/grad y0 {i}", gg.y0, wg.y0))
        worst["args"] = max(worst["args"], rel_close(f"serve_ode/grad args {i}", gg.args,
                                                     wg.args))
    emit("serve_ode", stream="grad (grad_stream, ScanAdjoint, float64)", requests=len(greqs),
         vs_cpu_max_abs=worst, tol=1e-9)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-side"]:
        sys.exit(cpu_side(sys.argv[2], sys.argv[3]))
    try:
        code = main()
    finally:
        for child in _CHILDREN:  # a phase failed before the CPU side was read
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.exit(code)
