#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. Print the card (``nvidia-smi`` name and power limit), PyTorch and CUDA
   versions; build ``src/repro_torch/kernels/csrc/llg_rk4.cu``,
   ``llg_write.cu``, ``analog_mac.cu``, ``fake_analog.cu`` and
   ``xnor_gemm.cu`` with one nvcc each, started together, and print the
   other instances' registers, stack and spills (``-Xptxas -v``); TF32 off.
   The SASS census of the LLG kernel and of the write kernel
   (``tools/sass_census.py``): the instructions one step issues on its
   fast path, per template instance, from which phases 1, 2b and 4
   compute the issue floor.
1. The LLG kernel against its plain PyTorch version on the card, on the
   same inputs: deterministic and thermal, chunk 0 and 64, ragged step
   budgets, two Brown sigmas, single-sublattice (MTJ) and variation rows,
   in every layout (C blocks per exit group x T threads per lane x P noise
   producers; C in 1, 2, 4, 8, 16, T = 2 for the AFMTJ, P = 1 for chunked
   thermal launches with C >= 8); the plain output is computed once per
   case and every layout is held against it.  Bound: bit-identical (rows
   0-5 max |d| 0.0, rows 6-7 equal) — tighter than the reference's own
   kernel-vs-oracle bound (atol 2e-5), since the kernel repeats the plain
   version's float32 operations in order.
2. The paper's chain at full width through the entry points a user calls:
   the Fig. 3 device writes (``simulate_write``, through the write kernel
   ``csrc/llg_write.cu``), ``wer_margined_pulse``
   (1 V, WER <= 1e-2, 128 samples) and ``evaluate_system`` for both device
   kinds, closed-form and with measured p99 write-verify timings (the
   real L1/L2/MM hierarchy: 256x256, 256x256, 512x512 subarrays; 16 rows of
   write-verify per level).  Deterministic anchors are held within 1% of
   the JAX reference's values; AFMTJ must beat MTJ on every workload.
   2b. The write kernel against its plain version ``ref_llg_write`` on the
   same inputs at every write launch of the main path (``WRITE_CASES``):
   phase 2's 1 V solves (16,000 AFMTJ steps of 0.05 ps, 40,000 MTJ steps
   of 0.1 ps; the quickstart's single write is the AFMTJ one), the
   quickstart's four-voltage sweeps (4 x 16,000 AFMTJ, 4 x 60,000 MTJ
   steps), and the reverse write.  Bound: bit-identical (final state,
   t_switch, switched, energy) over the whole horizon, so the float32
   time accumulation and the slow lanes' threshold crossings are held.
   Each timed beside the eager plain version, its operations bound and
   issue floor.
3. One reliability campaign at a study's size: 3 temperatures x 2 voltages
   x 100,000 samples = 600,000 lanes x 2,501 steps, timed.
4. Every launch shape of the main path, timed on the card and held against
   the plain version on the same inputs: the campaign of phase 3, the
   write-verify first rounds of ``evaluate_system(write_percentile=99.0)``
   (4,096 and 8,192 lanes) and the 128-sample WER ladder, for both device
   kinds.  At each shape the layout sweep (every C x T x P, each held
   bit-identical against the one plain output and timed once), then the
   old layout (C1T1: C = 1, T = 1, P = 0) and the rule's
   (``llg_rk4.layout_rule``)
   timed in turns (old, new, new, old); microseconds per step (over the
   longest lane's steps) beside the WER ladder's at C = 1, T = 1 (one live
   warp per scheduler); the operations bound and the issue floor (the
   census's fast-path instructions per lane-step x executed lane-steps
   over 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz) of both layouts.
   4b. The same at write-verify rounds of 32, 64 and 128 exit groups per
   kind (the rule's range between the main path's 16 groups and a full
   card).  Fails if the rule's layout was slower than C1T1 by more than
   3% in turns at any shape of 4 or 4b.

5. Analog MVM and model-level accuracy (kernels of
   ``src/repro_torch/kernels/csrc/analog_mac.cu``, ``fake_analog.cu`` and
   ``xnor_gemm.cu``):
   a. the bit-line MAC (B3), XNOR GEMM (B4) and fake-analog MVM (B5)
      kernels against their plain versions on the card, at the reference
      tests' odd shapes and at every full-width launch shape of qwen2-0.5b
      (M = 128 = batch 2 x seq 64; (K, N) = (896, 896) wq/wo, (896, 128)
      wk/wv, (896, 4864) w_gate/w_up, (4864, 896) w_down, (896, 151,936)
      unembed), on the operands the path builds; each timed beside its
      plain version, its bound and the one PyTorch call computing the same
      function (``torch.matmul``, beside B3 without its ADC and B4 without
      binarize; none for B5).  B5 is timed in both instances the smoke
      holds: the path's (no FET, no fail plane) and the FET + fail one (the
      ss corner's round trip and a write-BER fail plane), each beside its
      own operations bound; and the path's B5 and B3 adc 8 on the same
      operands (B3 on the g_diff B5 replays) in turns (B3, B5, B5, B3,
      device time): the smoke fails if B5 over B3 exceeds the parent
      commit's B5 over B3 (``PARENT_B5_OVER_B3``, ``tools/analog_ab.py``)
      by more than 3% at any qwen2 shape.  ``ms`` (kernel) and ``library_ms``
      (``torch.matmul``) are eager: the mean of 10 back-to-back calls after
      a warm one, CUDA events around them, host dispatch included (as the
      model's eager forwards pay it); ``ms_device`` / ``library_ms_device``
      are device times of the same calls replayed from one CUDA graph;
      ``host_us`` is the host's cost of enqueueing one call.  B4 is timed
      with float32 and bfloat16 operands.
      Bounds: B3 rtol 1e-5 / atol 1e-8 without ADC, at most 1 LSB on under
      1% of elements with it; B4 exact; B5 rtol 1e-6 / atol 1e-6 x decode
      or at most 1 LSB on under 1%; B5's raw currents bit-equal to B3's on
      the same g_diff;
   b. the path at full width through its entry points:
      ``model_accuracy_surface`` (fake, adc 4/6/8, TMR 5.0), the device
      mode twice through the programming cache (adc 8, TMR 5.0; ~2 GB under
      ``build/``, deleted at the end) and ``model_accuracy(mode="bnn")``.
      Fails unless fake vs device gives KL < 1e-4 with token match 1.0,
      the second device call is bit-identical, KL falls with adc bits, and
      every kernel launched 169 times per forward (24 x 7 linears plus the
      unembed).  Each kernel's time per forward is then its launches per
      forward at each shape, as counted in this run, times that shape's
      time from 5a, summed, eager and device, beside the same sum for
      ``torch.matmul``.

6. The example twins ``examples/torch_quickstart.py`` and
   ``torch_imc_case_study.py`` at full size through their ``run``
   functions (the Fig. 3 sweeps at 16,000 / 60,000 steps, Fig. 4 and the
   ten-arch decode mapping); every number they print is held within 1%
   (``ANCHOR_RTOL``) of the reference's own output of
   ``examples/quickstart.py`` and ``imc_case_study.py``
   (``REF_QUICKSTART``, ``REF_CASE_STUDY``); switched flags and non-finite
   values must be equal.  The printed mapping ratios do not depend on an
   arch's parameter count, so each arch's crossbar tiles (equal) and AFMTJ
   and MTJ decode time (within 1%) are held too, against the reference's
   ``map_all`` (``REF_DECODE``).

7. Process corners and the measured read path (DESIGN.md §9-§10) at full
   size, through their entry points, with the LLG and write kernels'
   counters set to 0 before and read after: ``wer_margined_pulse`` over
   tt/ss/ff for both kinds, ``write_verify_corners("afmtj", 4096, ...)``,
   ``read_disturb_campaign`` for both kinds, ``derive_refresh_policy``
   for the AFMTJ (a retention campaign of 3 corners x 3 accelerations to
   4 ns and the disturb fit, 40,001-step launches on the log horizon
   ladder) and the MTJ's retention campaign (to 8 ns, 40,001 steps) and
   disturb fit (20,001 steps; the MTJ does not escape within them, so
   the fit raises, as the reference's does),
   ``evaluate_system(kind, write_percentile=99.0, read_percentile=99.0,
   offset_sigma=5e-3)`` for both kinds and, for the AFMTJ, with
   ``refresh=policy``, the ss sample's 1 V write (the write kernel's
   conductance factor), and both twins
   (``examples/torch_variation_study.py``, ``torch_retention_study.py``)
   at full size.  Fails unless the path launched both kernels, the LLG
   kernel's VARIATION=1 instance among them, and its outputs check out
   (pulses on the ladder and no shorter than the nominal ones, the slow
   corner retrying more, a finite AFMTJ refresh interval, AFMTJ ahead of
   MTJ on every workload with measured reads, the scrub costing time and
   energy).  Then the ss writes are held bit for bit against
   ``ref_llg_write`` over 16,000 / 40,000 steps, and each new LLG launch
   family (the corner WER ladders, the ss write-verify round, the disturb
   campaigns, the disturb fits, the retention campaigns), recorded as the
   path launched it, is held in two parts, each in every layout: its
   first ``TRUNC_STEPS`` steps against the eager plain version, its whole
   horizon against the kernel's C1T1 layout, bit for bit; the whole
   horizon is timed C1T1 against the rule's layout in turns under
   ``NO_SLOWER``, beside its operations bound and issue floor.  The twins'
   numbers are held against the reference's output
   (``REF_VARIATION_STUDY``, ``REF_RETENTION_STUDY``,
   ``tools/ref_study_numbers.py``): deterministic ones within 1%,
   Monte-Carlo ones within 3 standard errors of a difference of two
   estimates at the study's sample count (binomial for counts and rates,
   1 / sqrt(escapes) in ln for escape times, propagated to the fits), the
   margined pulses on the same rung or one off.

8. The write-path and fault-cost remainder and serving at full size,
   through their entry points, with the LLG and bit-line MAC kernels'
   counters set to 0 before and read after: ``evaluate_system(kind,
   write_percentile=99.0)`` faults off (bit-equal to phase 2's) and with
   ``FaultSpec.at_rate(1e-3)`` under no repair and ``REPAIR_SPARE``
   (t_imc / e_imc = nominal x ``fault_cost_factors``, rtol 1e-12);
   ``write_error_rate(AFMTJ, 1 V, 250 ps)`` at 4,096 samples (one LLG
   launch) against ``write_error_rate_scan`` at 512 samples (plain
   PyTorch on the card) within 3 binomial standard errors of their
   difference; ``program_bits`` on a seeded 256 x 256 target (error map
   = the unverified cells); ``write_surface`` for both kinds on
   ``examples/write_path_study.py``'s grid; ``write_energy_accuracy_
   surface`` for qwen2-0.5b at 896 -> 4,864, batch 8, four WER targets
   (nmse not falling as the target loosens, energy not falling as it
   tightens; one bit-line MAC launch per target); the serving loop
   (``launch.serve.serve``) with ``ServeEngine`` on qwen2-0.5b at full
   width in float32 (5 requests, 2 slots, prompt 16, max_new 4), held to
   the serve contract of ``tests/test_system.py``, AFMTJ ahead of MTJ at
   p99 TPOT, decode == forward (the reference's 2e-2) and its first
   prefill against the same parameters on the CPU (1e-3); and the three
   twins of the slice
   (``torch_write_path_study``, ``torch_fault_study``,
   ``torch_serving_study``) in their ``--quick`` form.  Each new LLG
   launch family (the WER point, the first ``program_bits`` round, the
   AFMTJ surface's first rounds at 375 K and 0.8 / 1.2 V, the MTJ
   surface's at 0.8 V) is held bit-identical to C1T1 over its whole
   horizon in every layout, the ``program_bits`` round and the MTJ round
   also against the eager plain version over their first
   ``PHASE8_TRUNC_STEPS`` steps, and timed C1T1 against the rule's layout
   in turns under ``NO_SLOWER``.

9. The other model families (MoE, Mamba-2, the hybrid, encoder-decoder
   and the vision frontend), through the same entry points:
   a. B3, B4 and B5 against their plain versions at the new launch shapes
      (M = 128; (K, N) = (2,048, 2,048) olmoe-1b-7b's attention
      projections, (2,048, 50,304) its unembed, (1,536, 50,280)
      mamba2-780m's tied unembed), at phase 5a's bounds, each timed eager
      and graph-replayed beside ``torch.matmul`` and its bound;
   b. ``analog_path`` (phase 5b's path) on olmoe-1b-7b (16 layers, d_model
      2,048, 64 experts top-8, vocab 50,304) and mamba2-780m (48 layers,
      d_model 1,536, vocab 50,280) at full width in the default compute
      dtype: the fake surface at adc 4/6/8, device mode twice, fake adc 8,
      bnn; fails unless fake and device logits are bit-identical, the
      second device call too, KL falls with adc bits, logits are finite,
      and each kernel launched 65 (olmoe: 16 x 4 attention projections +
      the unembed) or 1 (mamba2: the tied unembed) times per forward — the
      reference routes only ``models.common.linear`` sites, so MoE routers
      and experts and the Mamba projections stay exact; then each kernel's
      time per forward from 9a's shapes;
   c. serving at full width in float32 (``serve_full_width``, phase 8's
      loop: 5 requests, 2 slots, prompt 16, max_new 4) on olmoe-1b-7b,
      mamba2-780m, seamless-m4t-large-v2 (24 + 24 layers, 1,024 encoder
      frames per request) and qwen2-vl-2b (256 vision positions, M-RoPE):
      the serve contract, AFMTJ ahead of MTJ at p99 TPOT where the arch
      keeps a KV cache, decode == forward at B 2 x S 16, and the first
      prefill against the CPU on a depth-cut copy of the same parameters
      (``CUT_REPEATS`` pattern repeats and encoder layers at full width,
      ``SERVE_CPU_ATOL``); jamba-1.5-large-398b and
      llama4-maverick-400b-a17b (398e9 parameters, not on one card) at
      their smoke configs: decode == forward, prefill + 3 decode steps
      finite.  Each model is freed before the next.

10. Training (plain PyTorch, as the reference's is jnp: no kernel on the
    path), with every kernel wrapper's launch count required unchanged
    over the phase:
    a. qwen2-0.5b at its published config (24 layers, d_model 896, vocab
       151,936, tied embedding; float32 parameters and AdamW state,
       bfloat16 compute) through ``launch.train.train``: ``TRAIN_STEPS``
       steps of B 4 x S 4,096 (train_4k's sequence; its global batch of
       256 cut to 4 for one card) in 2 microbatches, the step counter
       starting at ``TRAIN_STEP0`` (past the 100-step warmup, so the
       learning rate is the base rate); fails unless the loss and gradient
       norm are finite at every step and the last loss is below the first.
       Prints wall ms per step (host clock, every step ends in a device
       sync; the first apart), tokens/s, model FLOPs per step and their
       share of the H100 SXM data sheet's dense bf16 peak, and
       ``torch.cuda.max_memory_allocated``, beside the card's name and
       power limit;
    b. card against CPU on phase 8's ``depth_cut`` (1 repeat, full width
       and vocabulary, float32 compute, B 2 x S 64, 2 microbatches): one
       train step from shared parameters at step ``TRAIN_STEP0``, loss,
       gradient norm and moments within the ``TRAIN_CPU_*`` bounds, the
       parameters within the shares ``TRAIN_PARAM_SHARE`` /
       ``TRAIN_STEP_SHARE`` / ``TRAIN_FLIP_SHARE``; the mean of the two
       microbatches' gradients against the whole batch's
       (``TRAIN_MICRO_RTOL``);
    c. checkpoint and resume through ``train`` on the card (1 layer at full
       width, vocabulary cut to ``RESUME_VOCAB``): 4 steps saved every 2
       against 2 steps, a stop and a fresh call resuming from the
       checkpoint; the final checkpoints equal bit for bit under
       ``torch.use_deterministic_algorithms(True)`` (cuBLAS's
       ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts);
    d. one train step of each of the ten archs' smoke configs (float32) on
       the card and on the CPU: losses within ``FAMILY_LOSS_RTOL`` (jamba
       ``FAMILY_LOSS_RTOL_JAMBA``), every gradient on the card finite.

11. Campaign scale-out at a study's size (phase 3's grid, 786,432 packed
    lanes x 2,501 steps), each part failing the run on a miss:
    a. ``reduce="stream"`` at 4,096 bins (WER surface and percentiles
       bit-identical to phase 3's dense run) and 512 (WER bit-identical,
       percentiles within ``sketch_tolerance``, ``host_bytes`` at least 4x
       below dense); walls and ``host_bytes`` printed;
    b. one-slice launches (``max_cells_per_launch``): 3 launches, bit for
       bit the single launch;
    c. a ``python -c`` child (a fresh cache directory) SIGKILLs itself in
       ``on_slice_complete`` after launch 0; this process resumes:
       ``n_resumed == 1``, the crossing tensor equal to (b)'s, no claim or
       slice checkpoint left;
    d. two children, released together by a file barrier, split the
       3-launch campaign through one cache directory as a two-process
       ``CampaignMesh`` on the one card: ``n_computed`` sums to 3 and both
       crossing tensors' sha256 equal (b)'s; their startup printed;
    e. donation: the donated campaign equal to the undonated one; a
       donated ``llg_rk4_kernel`` call writes into the state block,
       bit-identical to the undonated call in every layout of phase 1's
       sweep (T = 2 included), and ``max_memory_allocated`` over one
       launch at least one (8, cells) block below the undonated launch's;
       ``write_verify("afmtj", 4096, WritePolicy(donate=True))`` equal to
       the undonated schedule;
    f. ``run_ensemble`` on 2,048 lanes over ``[cuda:0] * n``, n = 3, 5, 6:
       n devices kept (``_device_plan``), n kernel calls, equal to the
       one-device run;
    g. the twins ``torch_array_mc_sim`` (full size; Monte-Carlo numbers
       within ``MC_SIGMAS`` standard errors of ``REF_ARRAY_MC``) and
       ``torch_analog_accuracy`` (full size; within
       ``ANALOG_CARD_CPU_RTOL`` of its own CPU run, and within
       ``MC_SIGMAS`` x sqrt(2) draw spreads of ``REF_ANALOG_ACCURACY``),
       and ``torch_fault_study``'s section 4 (resumed, bit-identical).

12. Model scale-out, each part failing the run on a miss.  The ranks of
    12c and 12d start first, as child processes, so their startup
    overlaps 12a and 12b:
    a. ``analog_matmul(arr, x, devices=["cuda:0"] * n)``, n = 2 and 4, at
       qwen2-0.5b's five launch shapes (M = 128) and its unembed at M = 7,
       against the unsplit call within the reference's own bound (rtol
       1e-5, atol 1e-7; bit-equality printed), B3 launched once per
       device entry; ``mvm_accuracy`` and ``decode_projection_accuracy``
       with ``devices=`` against unsplit;
    b. a 1-rank NCCL group and a (1, 1) mesh: 2 sharded steps of
       qwen2-0.5b at phase 10a's shape (B 4 x S 4,096, 2 microbatches)
       equal 2 unsharded steps bit for bit under deterministic algorithms
       (loss, gradient norm, every parameter and moment); ms per step
       beside phase 10a's;
    c. (2, 1), (1, 2) and (2, 2) as gloo ranks sharing the card (float32
       compute, 4 of its 24 layers at full width, B 4 x S 1,024 in 2
       microbatches, steps 0-2 of lr 1e-2's warmup): each rank's
       parameter and moment bytes equal the plan's;
       loss, gradient norm, the first moment after step 1 and the
       parameters after step 2 against the one-rank steps with the same
       rows per microbatch (``SHARD_*`` bounds); each rank's startup and
       the steps' ms printed;
    d. the (2, 2) run saves at step 2 and takes step 3; the checkpoint is
       restored on ``elastic_remesh``'s (1, 2) with 4 microbatches, every
       payload shard equal bit for bit to the restored state gathered
       over the mesh, and step 3 there against the one-rank step 3.

13. The dry run, FLOP audit and roofline (``launch.dryrun``,
    ``launch.flops_audit``, ``launch.roofline``).  Child processes with no
    card (``CUDA_VISIBLE_DEVICES=""``) start with the smoke and trace on
    the meta device (``DRY_GROUPS``): every pod-mesh cell of
    jamba-1.5-large-398b (4 shapes) and llama4-maverick-400b-a17b (3) at
    full width, and 13b's cell.
    a. Each cell's record: argument bytes equal to the plan's
       (``ShardPlan.state_bytes`` and the batch or cache shards, counted
       here from the specs); argument, temp and collective bytes per rank,
       whether they fit on the card, the roofline terms and the dominant
       one printed.  Every cell must finish.
    b. qwen2-0.5b at phase 10a's shape (B 4 x S 4,096, 2 microbatches) on
       a (1, 1) ``ShardPlan``: 3 steps of ``make_train_step`` on the card,
       their peak (``max_memory_allocated`` over the allocation before the
       state) within ``PEAK_RTOL`` of the estimate (argument + temp), one
       more step's ``FlopCounterMode`` count equal to the audited FLOPs,
       ms per step against the roofline's bound.  No kernel launches over
       the phase.

Each kernel's launch counter is set to 0 before its main-path run (phases
2-3 for the LLG kernel, with its launches by layout, 2 and 6 for the
write kernel, 5b and 9b (per arch) for the analog kernels, both in phase
7, the LLG and bit-line MAC kernels in phase 8, the LLG, bit-line MAC
and XNOR kernels in phase 11, and the bit-line MAC in phase 12; phases 10
and 13 reach no kernel) and read after it (the
analog wrappers count their mainloop launches under ``launches``, and the
split-K reduce pass a split call adds under ``reduce_launches``); the
second-to-last line is the per-kernel JSON record and the last line
``{"ok": true, "device": {...}}``.  Campaign caching is off
(``use_cache=False``, and a fresh empty cache directory for the calls that
cache internally) so no result can skip the kernel.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# JAX reference values (src/repro, CPU): circuit.subarray._characterize_write
# (latency, energy) at 1 V and imc.evaluate.summarize(evaluate_system(kind))
REF_WRITE = {"afmtj": (1.2546315375505657e-10, 4.0518586749693775e-14),
             "mtj": (1.3394828579649243e-09, 3.60453610319042e-13)}
REF_SUMMARIZE = {"afmtj": (14.939246898721372, 17.41633381712113),
                 "mtj": (6.647316258326578, 3.1090744983784835)}
# the reference's own output of examples/quickstart.py and
# examples/imc_case_study.py (src/repro, CPU), unrounded: write latency [s],
# energy [J] and switched per voltage (0.5, 0.8, 1.0, 1.2 V; AFMTJ 16,000
# steps of 0.05 ps, MTJ 60,000 of 0.1 ps) and the single 1 V AFMTJ write;
# (speedup, energy saving) per Fig. 4 workload and their average; (AFMTJ
# speedup, AFMTJ energy saving, MTJ speedup) per arch of the decode mapping
REF_QUICKSTART = {
    "afmtj": dict(
        latency=[3.943773363435099e-10, 2.0646852283423556e-10,
                 1.654631570646714e-10, 1.4582750285097035e-10],
        energy=[3.217204944832609e-14, 4.318391483163278e-14,
                5.406760041309737e-14, 6.851617661901219e-14],
        switched=[True, True, True, True]),
    "mtj": dict(
        latency=[2.7385762546572323e-09, 1.7166976729043881e-09,
                 1.3794828612745391e-09, 1.1554212031583688e-09],
        energy=[1.8703739728884172e-13, 2.98256699286098e-13,
                3.740026138180502e-13, 4.50917921708191e-13],
        switched=[True, True, True, True]),
    "single": dict(latency=1.654631570646714e-10,
                   energy=5.406760041309737e-14, switched=True)}
REF_CASE_STUDY = {
    "afmtj": {
        "bnn": (55.90189065909159, 42.22361680885465),
        "img-grayscale": (7.44781335524745, 16.181309804442826),
        "img-threshold": (5.4849948017348735, 15.218533677465135),
        "mac": (3.4215699343660098, 3.5593919115326127),
        "mat_add": (16.3394095226525, 25.100157317340283),
        "rmse": (1.0398031192358088, 2.214993383091288),
        "AVERAGE": (14.939246898721372, 17.41633381712113)},
    "mtj": {
        "bnn": (14.44115370834661, 6.529868897124318),
        "img-grayscale": (5.377593939884286, 3.0294906295184436),
        "img-threshold": (4.831213381701173, 3.301866454877128),
        "mac": (2.4237826519789434, 0.6645852670752922),
        "mat_add": (12.075514260145315, 4.7152210415344635),
        "rmse": (0.7346396079031413, 0.4134147001412556),
        "AVERAGE": (6.647316258326578, 3.1090744983784835)},
    "map": {
        "gemma2-2b": (2749785.2966758288, 70.93498547430569,
                      2401722.699123776),
        "internlm2-20b": (2749785.296675829, 70.9349854743057,
                          2401722.6991237765),
        "qwen2-0.5b": (2749785.296675829, 70.9349854743057,
                       2401722.6991237765),
        "qwen3-8b": (2749785.296675829, 70.93498547430569,
                     2401722.6991237765),
        "qwen2-vl-2b": (2749785.296675829, 70.93498547430568,
                        2401722.699123777),
        "llama4-maverick-400b-a17b": (2749785.296675829, 70.93498547430568,
                                      2401722.6991237765),
        "olmoe-1b-7b": (2749785.296675829, 70.93498547430568,
                        2401722.6991237765),
        "seamless-m4t-large-v2": (2749785.296675829, 70.93498547430566,
                                  2401722.6991237765),
        "mamba2-780m": (2749785.2966758288, 70.93498547430569,
                        2401722.699123776),
        "jamba-1.5-large-398b": (2749785.2966758288, 70.9349854743057,
                                 2401722.6991237765)}}
# the reference's map_all(ARCHS) (src/repro, CPU) per arch: (crossbar
# tiles, AFMTJ t_imc [s], MTJ t_imc [s]) of one decode token.  Unlike the
# printed ratios these scale with the arch's active parameter count.
REF_DECODE = {
    "gemma2-2b": (79776.0, 9.50656028003402e-08, 1.0884270565264281e-07),
    "internlm2-20b": (606096.0, 7.222583432971695e-07,
                      8.269295091912881e-07),
    "qwen2-0.5b": (15074.5, 1.796362852754874e-08, 2.0566954552255866e-08),
    "qwen3-8b": (249952.0, 2.9785696890230937e-07, 3.410230139802619e-07),
    "qwen2-vl-2b": (47106.0, 5.613417927086875e-08, 6.426926008415302e-08),
    "llama4-maverick-400b-a17b": (432260.0, 5.151055137694927e-07,
                                  5.897556651801467e-07),
    "olmoe-1b-7b": (39120.0, 4.661760907477573e-08, 5.337352894518886e-08),
    "seamless-m4t-large-v2": (62092.875, 7.399338888238535e-08,
                              8.471666311611691e-08),
    "mamba2-780m": (23686.875, 2.82266226726247e-08, 3.231728293541847e-08),
    "jamba-1.5-large-398b": (2843342.0, 3.3882874698847386e-06,
                             3.87932506487912e-06)}
ANCHOR_RTOL = 0.01
# every layout of the LLG kernel repeats the plain version's float32
# operations in order: bit-identical (the reference's bound is 2e-5)
KERNEL_ATOL = 0.0
# (C, T, P): blocks per 512-lane exit group x threads per lane x noise
# producers (P = 1 only in chunked thermal launches, C >= 8)
LLG_LAYOUTS = ([(c, t, 0) for c in (1, 2, 4, 8, 16) for t in (1, 2)]
               + [(c, t, 1) for c in (8, 16) for t in (1, 2)])
# the rule's layout counts as no slower than C = 1, T = 1 within 3% (two
# launches of the same layout, timed in turns, differ by up to ~1%)
NO_SLOWER = 1.03
# phase 4b: exit groups per launch between the main path's and a full card
RULE_RANGE_GROUPS = (32, 64, 128)

# Operations per lane-step of the thermal kernel, by sublattice count:
# (float32 operations counted from csrc/llg_rk4.cu, its header note gives
# the breakdown; special-function-unit operations = MUFU.RCP + MUFU.RSQ per
# step in the sm_90a SASS, counted by tools/sass_census.py: one per IEEE
# division and one per sqrtf; logf/sinf/cosf issue none).  Each
# transcendental counts as one float32 operation, so the bound is a floor.
OPS_PER_LANE_STEP = {2: (606, 36), 1: (317, 20)}
# the deterministic kernel (THERMAL = false): no noise and no thermal-field
# adds in the right-hand sides, no Box-Muller square roots (llg_rk4.cu)
OPS_PER_LANE_STEP_DET = {2: (540, 33), 1: (272, 17)}
# the variation instance adds the a_J x g_scale multiply
OPS_PER_LANE_STEP_VAR = {2: (607, 36), 1: (318, 20)}
# The single-junction write kernel (csrc/llg_write.cu, its header note
# gives the breakdown): float32 operations per lane-step and MUFU (one per
# IEEE division and sqrtf), by sublattice count; the conductance factor's
# two multiplies included
WRITE_OPS_PER_LANE_STEP = {2: (545, 33), 1: (279, 17)}
# phase 2b: (kind, voltages, steps, dt, down, what), each held
# bit-identical against ref_llg_write and timed: every write launch of the
# main path (phase 2's _characterize_write, whose AFMTJ solve is also the
# quickstart's single write, and the quickstart's sweeps) and the reverse
# write (-2 V from the -z state: starting antiparallel, it draws less
# current than the forward write, and -1 V does not switch within 3,000
# steps)
QUICKSTART_VOLTS = (0.5, 0.8, 1.0, 1.2)
# the plain write of a hold runs its loop body captured once in a CUDA graph
# and replayed (the same kernels on the same inputs, without the eager
# loop's ~2-3 ms of host dispatch a step); its first PLAIN_EAGER_STEPS
# steps are held bit for bit against the eager loop itself
PLAIN_EAGER_STEPS = 1001
WRITE_CASES = [
    ("afmtj", (1.0,), 16000, 0.05e-12, True, "phase 2 / quickstart 1 V"),
    ("mtj", (1.0,), 40000, 0.1e-12, True, "phase 2"),
    ("afmtj", QUICKSTART_VOLTS, 16000, 0.05e-12, True, "quickstart sweep"),
    ("mtj", QUICKSTART_VOLTS, 60000, 0.1e-12, True, "quickstart sweep"),
    ("afmtj", (-2.0,), 3000, 0.05e-12, False, "reverse write")]
H100_FP32_OPS_S = 67e12        # NVIDIA data sheet, H100 SXM, 700 W
H100_SFU_OPS_S = 132 * 16 * 1.98e9   # 16 SFU lanes / SM / clock, boost clock
H100_INT8_OPS_S = 1979e12      # NVIDIA data sheet, H100 SXM, int8 dense
# thread-instructions per second: 132 SMs x 4 schedulers x 1 warp
# instruction (32 threads) per clock, boost clock
H100_ISSUE_S = 132 * 4 * 32 * 1.98e9

# Phase 5: qwen2-0.5b's linears at batch 2 x seq 64 (M = 128 rows)
QWEN_M = 128
QWEN_SHAPES = [(896, 896, "wq/wo"), (896, 128, "wk/wv"),
               (896, 4864, "w_gate/w_up"), (4864, 896, "w_down"),
               (896, 151936, "unembed")]
ODD_SHAPES = [(3, 200, 77), (65, 130, 190), (1, 1, 1), (129, 127, 128)]
LINEARS_PER_FORWARD = 24 * 7 + 1
# forwards each analog kernel runs in phase 5b: fake (adc 4, 6, 8 and adc 8
# again), device (twice, through the programming cache), bnn
FORWARDS = {"fake_analog": 4, "bitline_mac": 2, "xnor_gemm": 1}
# operations per element outside the product (counted from
# csrc/analog_common.cuh and csrc/fake_analog.cu): the ADC epilogue (divide,
# clip x2, multiply, round, divide, multiply) and B5's decode multiply per
# output; B5's conductance replay per (k, n) element, the path's instance
# (|wn| G_FS, + G_AP, the sign test, m t, + c) and the FET + fail one
# (|wn| G_FS, + G_AP; the FET round trip: 3 multiply, 2 add, 2 divide;
# 2 sign tests; the decode: 2 range tests, floor, int conversion, 5 bit
# tests; att_p tp - att_n tn: 2 multiply, 1 subtract), each operation
# counted once at the float32 rate, so the bound is a floor
ADC_OPS = 7
REPLAY_OPS = 5
REPLAY_OPS_FET_FAIL = 23
# The parent commit's B5 (the bit-line MAC's mainloop with the replay in
# place, before csrc/fake_analog.cu) over B3 adc 8 on the same operands,
# device time over graphs of ``turn_calls`` calls: the median of three runs
# of tools/analog_ab.py on one H100 (both kernels in one process, in
# turns; the runs agree within 0.6%).  B5 is held to no more than
# NO_SLOWER x this ratio against B3 in this run: no more than 3% slower than
# the parent's B5, with B3 as the yardstick timed beside it.
PARENT_B5_OVER_B3 = {"wq/wo": 1.2909, "wk/wv": 1.1699, "w_gate/w_up": 1.2583,
                     "w_down": 1.2510, "unembed": 1.4063}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn):
    """(result, milliseconds) of ``fn()`` timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(out_k, out_p, n_steps: int, tag: str, verbose=True) -> float:
    import torch

    d = (out_k[:6] - out_p[:6]).abs().max().item()
    mism = int((out_k[7] != out_p[7]).sum().item())
    same67 = bool(torch.equal(out_k[6], out_p[6]))
    if verbose:
        log(f"  {tag}: max|d rows0-5| = {d:.3e}, row-7 mismatches = {mism}, "
            f"crossed = {int((out_p[7] < n_steps).sum().item())}")
    if not (d <= KERNEL_ATOL and mism == 0 and same67):
        raise AssertionError(f"{tag}: kernel disagrees with its plain version "
                             f"(max|d| {d}, row-7 mismatches {mism})")
    return d


def executed_lane_steps(out, budget, n_kernel: int, chunk: int,
                        block: int) -> tuple:
    """(lane-steps the kernel integrated on these inputs, steps of the
    longest lane): a lane stops at its budget, an exit group of ``block``
    lanes at the first chunk boundary where every lane has crossed or used
    its budget."""
    import numpy as np

    row7 = out[7].double().cpu().numpy()
    bud = budget.double().cpu().numpy()
    n_chunks = -(-n_kernel // chunk)
    crossed = np.where(row7 < n_kernel, row7, np.inf)
    done_at = np.ceil(np.minimum(crossed, bud) / chunk)
    done_at = np.minimum(done_at, n_chunks)
    block_exit = done_at.reshape(-1, block).max(axis=1) * chunk
    lane_exit = np.repeat(block_exit, block)
    steps = np.minimum(bud, np.minimum(lane_exit, n_kernel))
    return int(steps.sum()), int(steps.max())


def layouts_for(nsub: int, producers: bool) -> list:
    return [(c, t, p) for c, t, p in LLG_LAYOUTS
            if (t == 1 or nsub == 2) and (p == 0 or producers)]


def layout_tag(layout) -> str:
    return "C{}T{}".format(*layout[:2]) + ("P" if layout[2] else "")


def issue_floor_ms(census: dict, lane_steps: int, thermal: bool, nsub: int,
                   layout, chunked: bool = True,
                   variation: bool = False) -> float:
    """Least milliseconds for ``lane_steps`` at the card's issue rate: the
    census's fast-path instructions per lane-step of the instance this
    launch runs, x lane-steps, over 132 x 4 x 32 x 1.98e9 per second."""
    c, t, prod = layout
    cluster = thermal and chunked and c > 1
    row = census[(thermal, variation, nsub, t, cluster, bool(prod))]
    return 1e3 * row["instructions_per_lane_step"] * lane_steps / H100_ISSUE_S


def sweep_layouts(run, out_p, n: int, nsub: int, producers: bool,
                  tag: str) -> dict:
    """Every layout of ``run(layout)`` held bit-identical against the plain
    output ``out_p`` and timed once after a warm launch: {tag: ms}."""
    times = {}
    for lay in layouts_for(nsub, producers):
        run(lay)
        out_k, ms = cuda_ms(lambda: run(lay))
        compare(out_k, out_p, n, f"{tag} {layout_tag(lay)}", verbose=False)
        times[layout_tag(lay)] = ms
    log(f"    every layout bit-identical; ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    return times


def in_turns(run, old, new) -> tuple:
    """(ms of ``old``, ms of ``new``): each the mean of two launches timed
    in turns old, new, new, old."""
    t = [cuda_ms(lambda: run(lay))[1] for lay in (old, new, new, old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def bound_ms(lane_steps: int, nsub: int, ops=OPS_PER_LANE_STEP) -> tuple:
    """(least milliseconds for ``lane_steps`` of the ``nsub`` kernel, and
    which unit bounds it: 'fp32' or 'sfu')."""
    fp32, sfu = ops[nsub]
    t_fp = fp32 * lane_steps / H100_FP32_OPS_S
    t_sfu = sfu * lane_steps / H100_SFU_OPS_S
    return 1e3 * max(t_fp, t_sfu), "fp32" if t_fp >= t_sfu else "sfu"


def phase1(torch, dev, census):
    from repro_torch.core.montecarlo import thermal_sigma
    from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
    from repro_torch.kernels import noise, ref
    from repro_torch.kernels.llg_rk4 import (layout_rule, llg_rk4_kernel,
                                             sm_count, takes_producers)

    log("phase 1: kernel vs plain version on the card")
    gen = torch.Generator(device="cpu").manual_seed(1234)
    cells = 4096

    def states(p, vlo, vhi):
        th = torch.rand(cells, generator=gen) * 0.35 + 0.05
        ph = torch.rand(cells, generator=gen) * 6.2831855
        m1 = torch.stack([th.sin() * ph.cos(), th.sin() * ph.sin(), th.cos()])
        s = torch.zeros(8, cells)
        s[0:3] = m1
        if p.n_sublattices == 2:
            s[3:6] = -m1
        s[6] = torch.linspace(vlo, vhi, cells)
        return s.to(dev)

    def thermal_kw(p, dt, n, chunk, variation=False):
        lane = torch.arange(cells)
        sigma = torch.where(lane % 2 == 0, thermal_sigma(p, dt),
                            thermal_sigma(p, dt) * math.sqrt(400.0 / 300.0))
        budget = torch.full((cells,), float(n))
        budget[lane % 5 == 0] = float(n // 3)
        budget[lane % 97 == 0] = 0.0
        kw = dict(thermal_sigma=sigma.float().to(dev),
                  seeds=noise.cell_seeds(77, cells, dev),
                  step_budget=budget.to(dev), chunk=chunk)
        if variation:
            kw["lane_params"] = torch.stack([
                p.alpha * (0.8 + 0.4 * torch.rand(cells, generator=gen)),
                p.b_aniso * (0.9 + 0.2 * torch.rand(cells, generator=gen)),
                0.85 + 0.3 * torch.rand(cells, generator=gen)]).float().to(dev)
        return kw

    cases = [
        ("afmtj deterministic 4096x400", AFMTJ_PARAMS, 0.1e-12, 400,
         (0.3, 1.2), None),
        ("mtj deterministic 4096x400", MTJ_PARAMS, 0.2e-12, 400,
         (2.0, 5.0), None),
        ("afmtj thermal chunk=0 4096x1500", AFMTJ_PARAMS, 0.1e-12, 1500,
         (0.6, 2.0), dict(chunk=0)),
        ("afmtj thermal chunk=64 4096x1500", AFMTJ_PARAMS, 0.1e-12, 1500,
         (0.6, 2.0), dict(chunk=64)),
        ("mtj (NSUB=1) thermal chunk=64 4096x3000", MTJ_PARAMS, 0.2e-12, 3000,
         (2.0, 5.0), dict(chunk=64)),
        ("afmtj variation rows chunk=64 4096x1500", AFMTJ_PARAMS, 0.1e-12,
         1500, (0.6, 2.0), dict(chunk=64, variation=True)),
    ]
    records = []
    for tag, p, dt, n, (vlo, vhi), th in cases:
        st = states(p, vlo, vhi)
        kw = {} if th is None else thermal_kw(p, dt, n, **th)
        nsub = p.n_sublattices
        prods = takes_producers(th is not None, kw.get("chunk", 0))
        rule = layout_rule(cells, nsub, sm_count(torch.cuda.current_device()),
                           prods)
        run = lambda lay: llg_rk4_kernel(st, p, dt, n, **kw,  # noqa: E731
                                         layout=lay)
        run(rule)      # warm: CUDA loads the module on its first launch
        out_k, ms_k = cuda_ms(lambda: run(rule))
        out_p, ms_p = cuda_ms(lambda: ref.ref_llg_rk4(st, p, dt, n, **kw))
        err = compare(out_k, out_p, n, f"{tag} (kernel {ms_k:.2f} ms in "
                      f"{layout_tag(rule)}, plain {ms_p:.0f} ms)")
        sweep = sweep_layouts(run, out_p, n, nsub, prods, tag)
        rec = dict(case=tag, layout=layout_tag(rule), ms=ms_k, plain_ms=ms_p,
                   max_abs_err=err, sweep_ms=sweep)
        if th is None:
            # the deterministic kernel runs every lane for all n steps
            b_ms, unit = bound_ms(cells * n, nsub, OPS_PER_LANE_STEP_DET)
            floors = {layout_tag(lay): issue_floor_ms(census, cells * n,
                                                      False, nsub, lay)
                      for lay in dict.fromkeys([(1, 1, 0), rule])}
            rec.update(lane_steps=cells * n, bound_ms=b_ms, bound_unit=unit,
                       issue_floor_ms=floors)
            log(f"    {cells * n} lane-steps -> bound {b_ms:.4f} ms ({unit});"
                f" kernel at {100 * b_ms / ms_k:.2f}% of it; issue floor "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in floors.items()))
        records.append(rec)
    return records


# phase 2's Fig. 4 results by (kind, mode), which phase 8 holds its
# faults-off calls to
PHASE2_FIG4 = {}


def phase2(torch):
    from repro_torch.circuit import subarray
    from repro_torch.core.device import simulate_write
    from repro_torch.imc import evaluate
    from repro_torch.imc.write_margin import wer_margined_pulse
    from repro_torch.imc.write_path import (measured_write_timings,
                                            nominal_pulse)
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    log("phase 2: device -> write path -> Fig. 4 at full width")
    for f in (wer_margined_pulse, measured_write_timings, nominal_pulse,
              subarray._characterize_write):
        f.cache_clear()
    assert simulate_write is subarray.simulate_write
    launches = {}
    for kind in ("afmtj", "mtj"):
        # the Fig. 3 write as the subarray model runs it (t_rc = 0); the
        # closed-form and measured evaluations below reuse this solve
        t0 = time.perf_counter()
        lat, en = subarray._characterize_write(kind, 1.0, None)
        dt_s = time.perf_counter() - t0
        log(f"  simulate_write {kind} 1 V: latency {lat * 1e12:.2f} ps, "
            f"energy {en * 1e15:.3f} fJ (with the 40 ps line charge: "
            f"{(lat + 40e-12) * 1e12:.2f} ps), {dt_s:.1f} s")
        ref_lat, ref_en = REF_WRITE[kind]
        assert abs(lat / ref_lat - 1) < ANCHOR_RTOL, (kind, lat, ref_lat)
        assert abs(en / ref_en - 1) < ANCHOR_RTOL, (kind, en, ref_en)

    results = {}
    for kind in ("afmtj", "mtj"):
        before = llg_rk4_kernel.launches
        t0 = time.perf_counter()
        pulse = wer_margined_pulse(kind, 1.0, 1e-2, use_cache=False)
        log(f"  wer_margined_pulse {kind} 1 V WER<=1e-2: {pulse * 1e12:.0f} ps "
            f"({time.perf_counter() - t0:.2f} s, "
            f"{llg_rk4_kernel.launches - before} launches)")
        for mode, kw in (("closed-form", {}),
                         ("p99 write-verify", dict(write_percentile=99.0))):
            before = llg_rk4_kernel.launches
            t0 = time.perf_counter()
            res = evaluate.evaluate_system(kind, **kw)
            n_l = llg_rk4_kernel.launches - before
            sp, es = evaluate.summarize(res)
            log(f"  evaluate_system {kind} {mode}: summarize speedup "
                f"{sp:.3f}x, energy saving {es:.3f}x "
                f"({time.perf_counter() - t0:.2f} s, {n_l} launches)")
            for name, r in res.items():
                log(f"    {name:14s} speedup {r.speedup:8.3f}x  energy saving "
                    f"{r.energy_saving:8.3f}x  write op {r.t_write_op * 1e12:8.1f}"
                    f" ps  attempts {r.write_attempts:.3f}")
            results[(kind, mode)] = res
            PHASE2_FIG4[(kind, mode)] = res
            if mode == "closed-form":
                ref_sp, ref_es = REF_SUMMARIZE[kind]
                assert abs(sp / ref_sp - 1) < ANCHOR_RTOL, (kind, sp, ref_sp)
                assert abs(es / ref_es - 1) < ANCHOR_RTOL, (kind, es, ref_es)
            else:
                launches[kind] = n_l
                assert n_l > 0, f"{kind}: write-verify never launched the kernel"
    for mode in ("closed-form", "p99 write-verify"):
        a, m = results[("afmtj", mode)], results[("mtj", mode)]
        for name in a:
            assert a[name].speedup > m[name].speedup, (mode, name)
            assert a[name].energy_saving > m[name].energy_saving, (mode, name)
    log(f"  launches per evaluate_system(write_percentile=99.0): {launches}")
    return launches


def write_inputs(torch, dev, kind: str, volts, down: bool, sample=None):
    """The write kernel's inputs as ``core.device.write_sweep`` builds
    them: the initial state on the host's formula (``llg.initial_state`` at
    the Boltzmann tilt), one lane per voltage; with a ``DeviceSample``, its
    parameters, its volume-adjusted tilt and its conductance factor."""
    from repro_torch.core import llg
    from repro_torch.core.device import thermal_theta0
    from repro_torch.imc.write_margin import params_for

    p = params_for(kind) if sample is None else sample.params
    th0 = thermal_theta0(p, None if sample is None
                         else sample.thermal_stability)
    m0 = llg.initial_state(p, theta0=th0, phi0=0.3, up=down, device=dev)
    m0 = m0.expand(len(volts), *m0.shape).contiguous()
    gs = (None if sample is None else
          torch.full((len(volts),), sample.g_scale, dtype=torch.float32,
                     device=dev))
    return p, m0, torch.tensor(volts, dtype=torch.float32, device=dev), gs


def write_bound_ms(lanes: int, steps: int, nsub: int) -> tuple:
    """(least ms for ``lanes`` x ``steps`` write lane-steps, and which
    unit bounds it: 'fp32' or 'sfu')."""
    return bound_ms(lanes * steps, nsub, WRITE_OPS_PER_LANE_STEP)


def graphed_steps(torch, step, state: tuple, n: int) -> tuple:
    """``state = step(state)`` ``n`` times: the first step eager (it caches
    the step's constants on the card), then the step captured once in a
    CUDA graph that copies its result back into its input, replayed
    ``n - 1`` times.  Every replay launches the kernels the eager step
    launches, on the same values."""
    if n == 0:
        return state
    state = tuple(t.clone() for t in step(state))
    if n == 1:
        return state
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(state)                 # warm on a side stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for dst, src in zip(state, step(state)):
            dst.copy_(src)
    for _ in range(n - 1):
        graph.replay()
    out = tuple(t.clone() for t in state)
    del graph
    return out


def plain_write(torch, m0, v, p, dt, n: int, down: bool, gs) -> tuple:
    """``ref.ref_llg_write``'s result, its loop body replayed in a CUDA
    graph (``graphed_steps``)."""
    from repro_torch.kernels import ref

    step, state = ref.llg_write_stepper(m0, v, p, dt, down, gs)
    m, _, t_sw, sw, en = graphed_steps(torch, step, state, n)
    return m, t_sw, sw, en


def phase2b(torch, dev, write_census) -> list:
    """The single-junction write kernel against its plain version on the
    card, bit-identical, at ``WRITE_CASES``: each timed beside the eager
    plain version, its operations bound and issue floor."""
    log("phase 2b: the write kernel vs ref_llg_write on the card, at every "
        "write launch of the main path")
    return [hold_write(torch, dev, write_census, *case)
            for case in WRITE_CASES]


def hold_write(torch, dev, write_census, kind, volts, n, dt, down, what,
               sample=None) -> dict:
    """One write launch held bit-identical against ``ref_llg_write`` over
    its whole horizon (with a ``DeviceSample``: its parameters and
    conductance factor; the plain loop body replayed in a CUDA graph,
    itself held bit-identical to the eager loop over the first
    ``PLAIN_EAGER_STEPS`` steps) and timed beside the graphed plain
    version, its operations bound and issue floor."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.llg_write import llg_write_kernel

    p, m0, v, gs = write_inputs(torch, dev, kind, volts, down, sample)
    llg_write_kernel(m0, v, p, dt, n, down, gs)      # warm
    got, ms = cuda_ms(lambda: llg_write_kernel(m0, v, p, dt, n, down, gs))
    lead = min(n, PLAIN_EAGER_STEPS)
    eager = ref.ref_llg_write(m0, v, p, dt, lead, down, gs)
    graphed = plain_write(torch, m0, v, p, dt, lead, down, gs)
    if not all(torch.equal(a, b) for a, b in zip(eager, graphed)):
        raise AssertionError(f"{kind} {volts}: the graph-replayed plain write "
                             f"differs from the eager loop over {lead} steps")
    want, plain_ms = cuda_ms(lambda: plain_write(torch, m0, v, p, dt, n, down,
                                                 gs))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max((a.float() - b.float()).abs().nan_to_num(0.0).max().item()
              for a, b in zip(got, want))
    tag = (f"{kind} {len(volts)} x {n} steps of {dt * 1e12:g} ps, V = "
           f"{volts} ({what})")
    nsub = p.n_sublattices
    b_ms, unit = write_bound_ms(len(volts), n, nsub)
    per_step = write_census[nsub]["instructions_per_lane_step"]
    floor = 1e3 * per_step * len(volts) * n / H100_ISSUE_S
    log(f"  {tag}: kernel {ms:.3f} ms ({1e3 * ms / n:.3f} us per step), "
        f"plain (graph-replayed step; eager over its first {lead} steps "
        f"bit-identical) {plain_ms:.0f} ms ({1e3 * plain_ms / n:.0f} us per "
        f"step); bit-identical {same}; switched {got[2].tolist()}; bound "
        f"{b_ms:.3e} ms ({unit}), issue floor {floor:.3e} ms ({per_step} "
        f"instructions per lane-step); one thread's chain: "
        f"{ms / n * 1e6 / per_step:.2f} ns per instruction")
    if not same:
        raise AssertionError(f"{tag}: the write kernel disagrees with "
                             f"ref_llg_write (max |d| {err})")
    return dict(case=tag, kind=kind, lanes=len(volts), steps=n, ms=ms,
                us_per_step=1e3 * ms / n, plain_ms=plain_ms,
                plain_us_per_step=1e3 * plain_ms / n, max_abs_err=err,
                bit_identical=same, bound_ms=b_ms, bound_unit=unit,
                issue_floor_ms=floor,
                g_scale=None if sample is None else sample.g_scale)


def phase3(torch, dev):
    import numpy as np

    from repro_torch.campaign import run_campaign
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    log("phase 3: 600,000-lane campaign")
    grid = campaign_grid()
    t0 = time.perf_counter()
    res = run_campaign(AFMTJ_PARAMS, grid, use_cache=False)
    wall = time.perf_counter() - t0
    lanes = len(grid.temperatures) * grid.cells
    wer = res.wer_surface()
    log(f"  run_campaign: {lanes} lanes x {grid.n_steps} steps in {wall:.2f} s "
        f"({lanes * grid.n_steps / wall:.4g} lane-steps/s, backend "
        f"{res.backend})")
    log(f"  wer_surface (T, V, pulse):\n{np.array2string(wer, precision=5)}")
    log(f"  latency p50/p99 [ps]:\n"
        f"{np.array2string(res.latency_percentiles() * 1e12, precision=2)}")
    assert wer.shape == (3, 2, 2) and np.isfinite(wer).all()
    assert ((wer >= 0) & (wer <= 1)).all()
    assert (np.diff(wer, axis=2) <= 0).all(), "WER must not grow with pulse"
    assert (wer[:, 1] <= wer[:, 0]).all(), "WER must not grow with voltage"
    PHASE3_DENSE.update(result=res, wall=wall)
    return llg_rk4_kernel.launches, grid, wall


def pack_shape(dev, kind: str, grid) -> dict:
    """The kernel's inputs for ``grid``, packed as ``run_campaign`` packs
    them (thermal, chunk ``EARLY_EXIT_CHUNK``)."""
    from repro_torch.campaign import pack_campaign
    from repro_torch.campaign.engine import EARLY_EXIT_CHUNK, _quantize_steps
    from repro_torch.imc.write_margin import params_for

    p = params_for(kind)
    state, seeds, sigma, budget, _ = pack_campaign(grid, p, dev)
    return dict(kind=kind, p=p, dt=grid.dt, steps=grid.n_steps,
                n_kernel=_quantize_steps(grid.n_steps), state=state,
                kw=dict(thermal_sigma=sigma, seeds=seeds, step_budget=budget,
                        chunk=EARLY_EXIT_CHUNK))


def leading_groups(shape: dict, groups: int) -> dict:
    """The launch of ``shape``'s first ``groups`` exit groups alone.  Exit
    groups never interact (each votes on its own lanes), so the plain
    output of those lanes is the leading columns of the whole block's."""
    from repro_torch.kernels.ref import CELL_TILE

    n = groups * CELL_TILE
    kw = dict(shape["kw"])
    for k in ("thermal_sigma", "seeds", "step_budget"):
        kw[k] = kw[k][:n].contiguous()
    return dict(shape, state=shape["state"][:, :n].contiguous(), kw=kw)


def plain_output(shape: dict) -> tuple:
    from repro_torch.kernels import ref

    return cuda_ms(lambda: ref.ref_llg_rk4(
        shape["state"], shape["p"], shape["dt"], shape["n_kernel"],
        **shape["kw"]))


def hold_at_shape(dev, kind: str, grid, what: str, census) -> dict:
    """Pack ``grid`` as ``run_campaign`` does and hold the kernel against
    the plain version's output on it (``hold_launch``)."""
    shape = pack_shape(dev, kind, grid)
    out_p, ms_p = plain_output(shape)
    return hold_launch(shape, out_p, ms_p, what, census)


def hold_launch(shape: dict, out_p, ms_p: float, what: str,
                census, against: str = "plain") -> dict:
    """Hold every layout of the kernel on ``shape`` against the output
    ``out_p`` of ``against`` (the plain version, computed once in
    ``ms_p``, or the kernel's C1T1 layout) and time each; then time C =
    1, T = 1 and the rule's layout in turns."""
    import torch

    from repro_torch.campaign.engine import EARLY_EXIT_CHUNK
    from repro_torch.kernels.llg_rk4 import (layout_rule, llg_rk4_kernel,
                                             sm_count, takes_producers)
    from repro_torch.kernels.ref import CELL_TILE

    kind, p, state, kw = shape["kind"], shape["p"], shape["state"], shape["kw"]
    n_kernel = shape["n_kernel"]
    nsub = p.n_sublattices
    lanes = state.shape[1]
    prods = takes_producers(True, EARLY_EXIT_CHUNK)
    rule = layout_rule(lanes, nsub, sm_count(torch.cuda.current_device()),
                       prods)
    run = lambda lay: llg_rk4_kernel(state, p, shape["dt"],  # noqa: E731
                                     n_kernel, **kw, layout=lay)
    run(rule)
    out_k = run(rule)
    tag = f"{kind} {what}: {lanes} lanes x {shape['steps']} steps"
    err = compare(out_k, out_p, n_kernel, f"{tag} (horizon {n_kernel}, rule "
                  f"layout {layout_tag(rule)}; {against} {ms_p:.0f} ms)")
    sweep = sweep_layouts(run, out_p, n_kernel, nsub, prods, tag)
    ms_old, ms_new = in_turns(run, (1, 1, 0), rule)
    steps, longest = executed_lane_steps(out_k, kw["step_budget"], n_kernel,
                                         EARLY_EXIT_CHUNK, CELL_TILE)
    var = kw.get("lane_params") is not None
    b_ms, unit = bound_ms(steps, nsub,
                          OPS_PER_LANE_STEP_VAR if var else OPS_PER_LANE_STEP)
    floor_old = issue_floor_ms(census, steps, True, nsub, (1, 1, 0),
                               variation=var)
    floor_new = issue_floor_ms(census, steps, True, nsub, rule, variation=var)
    log(f"    in turns: C1T1 {ms_old:.3f} ms, {layout_tag(rule)} "
        f"{ms_new:.3f} ms ({ms_old / ms_new:.2f}x"
        f"{'' if ms_new <= NO_SLOWER * ms_old else ', SLOWER'}); "
        f"{1e3 * ms_old / longest:.3f} / {1e3 * ms_new / longest:.3f} us per "
        f"step over the longest lane's {longest} steps")
    log(f"    executed lane-steps {steps} -> operations bound {b_ms:.4f} ms "
        f"({unit}), issue floor C1T1 {floor_old:.4f} ms, "
        f"{layout_tag(rule)} {floor_new:.4f} ms; kernel at "
        f"{100 * b_ms / ms_new:.1f}% of the bound, "
        f"{100 * floor_new / ms_new:.1f}% of its issue floor")
    return dict(kind=kind, what=what, lanes=lanes, steps=shape["steps"],
                horizon=n_kernel, layout=layout_tag(rule), ms=ms_new,
                ms_c1t1=ms_old, us_per_step=1e3 * ms_new / longest,
                us_per_step_c1t1=1e3 * ms_old / longest, longest_lane=longest,
                plain_ms=ms_p, bound_ms=b_ms, bound_unit=unit,
                issue_floor_ms=floor_new, issue_floor_ms_c1t1=floor_old,
                lane_steps=steps, max_abs_err=err, sweep_ms=sweep,
                chosen_no_slower=ms_new <= NO_SLOWER * ms_old)


def campaign_grid():
    """Phase 3's campaign: 3 temperatures x 2 voltages x 2 pulses x
    100,000 samples (600,000 lanes, 786,432 packed) x 2,501 steps."""
    from repro_torch.campaign import CampaignGrid

    return CampaignGrid(voltages=(0.6, 1.2), pulse_widths=(120e-12, 250e-12),
                        temperatures=(300.0, 350.0, 400.0), n_samples=100_000,
                        dt=0.1e-12, seed=0)


def round_grid(kind: str, n_cells: int):
    """The first write-verify round of ``n_cells`` cells of
    ``evaluate_system(write_percentile=99.0)``: the nominal x 1.5 pulse at
    the policy's voltage and dt."""
    from repro_torch.campaign import CampaignGrid
    from repro_torch.imc.write_margin import params_for
    from repro_torch.imc.write_path import WritePolicy

    policy = WritePolicy()
    return CampaignGrid(voltages=(policy.v_write,),
                        pulse_widths=(policy.resolved_pulse(kind),),
                        temperatures=(params_for(kind).temperature,),
                        n_samples=n_cells, dt=policy.resolved_dt(kind),
                        seed=policy.seed * 1009)


def main_path_shapes(dev, campaign_grid, census) -> list:
    """Every launch shape of the main path: the phase-3 campaign, the first
    write-verify rounds of the L1/L2 (16 x 256) and MM (16 x 512) levels at
    each kind's nominal x 1.5 pulse, and the 128-sample WER ladder."""
    from repro_torch.campaign import CampaignGrid
    from repro_torch.imc.write_margin import _LADDERS, DEVICE_DT, params_for

    log("phase 4: the main path's launch shapes, kernel vs plain version")
    out = [hold_at_shape(dev, "afmtj", campaign_grid, "campaign", census)]
    for kind in ("afmtj", "mtj"):
        for n_cells in (4096, 8192):
            out.append(hold_at_shape(dev, kind, round_grid(kind, n_cells),
                                     "write-verify round", census))
        grid = CampaignGrid(voltages=(1.0,), pulse_widths=_LADDERS[kind],
                            temperatures=(params_for(kind).temperature,),
                            n_samples=128, dt=DEVICE_DT[kind], seed=0)
        out.append(hold_at_shape(dev, kind, grid, "WER ladder", census))
    for x in out:
        ladder = next(y for y in out if y["kind"] == x["kind"]
                      and y["what"] == "WER ladder")
        x["us_per_step_one_warp"] = ladder["us_per_step_c1t1"]
        log(f"  {x['kind']} {x['what']} ({x['lanes']} lanes): "
            f"{x['us_per_step_c1t1']:.3f} us/step in C1T1, "
            f"{x['us_per_step']:.3f} in {x['layout']}; the one-live-warp "
            f"ladder in C1T1: {ladder['us_per_step_c1t1']:.3f} us/step")
    return out


def rule_range_shapes(dev, census) -> list:
    """Launches between the main path's largest (16 exit groups) and a full
    card, where the layout rule must also hold: write-verify rounds of 32,
    64 and 128 groups (16,384-65,536 cells: a larger array's rounds, or a
    campaign of 10,000-60,000 lanes as ``bucket_cells`` pads it) of each
    kind.  The 128-group round is packed once, its plain output computed
    once, and the smaller launches are its leading groups."""
    from repro_torch.kernels.ref import CELL_TILE

    log("phase 4b: the rule's range between 16 groups and a full card")
    out = []
    for kind in ("afmtj", "mtj"):
        shape = pack_shape(dev, kind, round_grid(
            kind, RULE_RANGE_GROUPS[-1] * CELL_TILE))
        out_p, ms_p = plain_output(shape)
        for groups in RULE_RANGE_GROUPS:
            out.append(hold_launch(leading_groups(shape, groups),
                                   out_p[:, :groups * CELL_TILE], ms_p,
                                   f"{groups}-group round", census))
    return out


def require_no_slower(records: list) -> None:
    """Fail unless the rule's layout was no slower than C1T1 (within
    ``NO_SLOWER``, timed in turns) at every shape of ``records``."""
    slower = [f"{x['kind']} {x['what']} ({x['lanes']} lanes): "
              f"{x['layout']} {x['ms']:.3f} ms vs C1T1 {x['ms_c1t1']:.3f}"
              for x in records if not x["chosen_no_slower"]]
    if slower:
        raise AssertionError("the layout rule chose a slower layout than "
                             "C1T1: " + "; ".join(slower))


# --- phase 5: analog MVM and model-level accuracy ------------------------------

def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm call,
    timed with CUDA events."""
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


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls
    captured in one CUDA graph (no host dispatch between launches), timed
    with CUDA events around its replay after a warm replay."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    del graph
    return ms


def turn_calls(ms: float) -> int:
    """Calls per CUDA graph when two kernels are timed in turns: ~2 ms of
    device time (10 to 200 calls), so a small launch's time is not the
    noise of a short graph."""
    return int(min(200, max(10, 2.0 / ms)))


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn()``: the best of three loops of
    ``calls`` calls with no synchronization inside (the cost of enqueueing
    one call; where the device is the slower, the launch queue fills and
    this reads device time instead)."""
    fn()
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / calls


def gemm_bound(m: int, k: int, n: int, extra_ops: int, n_bytes: int,
               ops_s: float = H100_FP32_OPS_S):
    """(least ms, 'operations' or 'bytes') for an (m, k) @ (k, n) product
    plus ``extra_ops`` operations at ``ops_s`` moving ``n_bytes``."""
    from repro_torch.launch.roofline import HBM_BW

    t_ops = (2 * m * k * n + extra_ops) / ops_s
    t_bytes = n_bytes / HBM_BW
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hold_close(out, plain, tag: str, rtol: float, atol: float,
               lsb=None) -> float:
    """Max |kernel - plain|.  Without ``lsb`` every element must lie within
    rtol / atol; with it (an ADC'd output) at most 1 LSB anywhere and off
    rtol / atol on under 1% of elements (a float-ulp difference in the sum
    can land on a quantizer bin edge)."""
    import torch

    if out.shape != plain.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: shape {tuple(out.shape)} / non-finite")
    diff = (out - plain).abs()
    off = diff > atol + rtol * plain.abs()
    frac = off.float().mean().item()
    d = diff.max().item()
    ok = (frac == 0.0) if lsb is None else (d <= lsb * 1.001 and frac < 0.01)
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version "
                             f"(max|d| {d:.3e}, {100 * frac:.3f}% off)")
    return d


class SizingHeld:
    """Stands in for ``model_analog.adc_aux_kernel`` while it is entered:
    launches the sizing kernel and requires its aux plane to equal
    ``ref.ref_adc_aux``'s on CPU copies of the same inputs (the real
    statistics of each product), bit for bit; ``held`` counts the
    products."""

    def __init__(self, tag: str):
        self.tag, self.held, self.first = tag, 0, None

    def __enter__(self):
        from repro_torch.imc import model_analog as ma

        self.ma, self.real = ma, ma.adc_aux_kernel
        ma.adc_aux_kernel = self
        return self

    def __exit__(self, *exc):
        self.ma.adc_aux_kernel = self.real

    def __call__(self, att_p, att_n, cell, **kw):
        import torch

        from repro_torch.kernels import ref

        aux = self.real(att_p, att_n, cell, **kw)
        if self.first is None:
            self.first = ((att_p, att_n, cell), kw)
        host = {k: v.cpu() if torch.is_tensor(v) else v
                for k, v in kw.items()}
        plain = ref.ref_adc_aux(att_p.cpu(), att_n.cpu(),
                                [c.cpu() for c in cell], **host)
        if not torch.equal(aux.cpu(), plain):
            raise AssertionError(f"adc_sizing {self.tag}: the aux plane "
                                 f"differs from ref_adc_aux's")
        self.held += 1
        return aux


def fake_operand_sets(x, w, bl, dev) -> dict:
    """{label: (operands, keyword arguments)} of B5 for ``x @ w`` as the fake
    path builds them (adc 8, TMR 5.0, IR drop, decode): "path", no FET and
    no fail plane; "fet+fail", the ss corner's FET round trip and a
    write-BER 1e-2 fail plane."""
    from repro_torch.core.params import PROCESS_CORNERS, VariationSpec
    from repro_torch.imc import analog_pipeline as ap
    from repro_torch.imc import model_analog as ma

    sets = {}
    for label, acfg in (
            ("path", ap.AnalogConfig(adc_bits=8, tmr=5.0)),
            ("fet+fail", ap.AnalogConfig(
                adc_bits=8, tmr=5.0, write_ber=1e-2, variation=VariationSpec(
                    corners=(PROCESS_CORNERS["ss"],))))):
        setup = ma.fake_setup("afmtj", acfg, dev, bl=bl)
        sets[label] = (ma.fake_operands(x, w, setup, bl),
                       dict(adc_bits=setup.adc_bits,
                            apply_fet=setup.apply_fet,
                            use_fail=setup.fail_plane))
    return sets


def model_operands(torch, dev, m: int, k: int, n: int):
    """(x, w, bit-line params) of an (m, k) @ (k, n) linear as phase 5a
    draws it: unit-normal activations, N(0, 1/k) weights, from a seed of
    the shape."""
    from repro_torch.circuit.bitline import BitlineParams

    gen = torch.Generator(device=dev).manual_seed(m * 7919 + k * 31 + n)
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    x = torch.randn(m, k, generator=gen, device=dev)
    return x, w, BitlineParams(rows=k), gen


def hold_analog_at_shape(torch, dev, m: int, k: int, n: int, what: str,
                         timed: bool) -> dict:
    """B3, B4 and B5 on the operands the model path builds for an
    (m, k) @ (k, n) linear (unit-normal activations, N(0, 1/k) weights),
    against their plain versions; B5's raw currents against B3's on the same
    g_diff; and, if ``timed``, kernel / plain / library times."""
    from repro_torch.imc import analog_pipeline as ap
    from repro_torch.imc import model_analog as ma
    from repro_torch.kernels import ref
    from repro_torch.kernels.adc_sizing import adc_aux_kernel
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel
    from repro_torch.kernels.fake_analog import (ROW_DECODE, ROW_I_MAX,
                                                 _tile_g_diff,
                                                 fake_analog_kernel)
    from repro_torch.kernels.xnor_gemm import binarize_acc, xnor_gemm_kernel

    x, w, bl, gen = model_operands(torch, dev, m, k, n)
    rec = {"shape": [m, k, n], "what": what}
    tag = f"{what} ({m}x{k} @ {k}x{n})"

    # B3 on the device path's operands (adc 8, TMR 5.0) and ideal
    cfg = ap.AnalogConfig(adc_bits=8, tmr=5.0)
    arr = ap.program_weights(w, "afmtj", cfg, device=dev)
    v, i_max, _ = ap.kernel_operands(arr, x)
    g = arr.g_diff
    err3 = hold_close(bitline_mac_kernel(v, g, 0, i_max),
                      ref.ref_bitline_mac(v, g, 0, i_max),
                      f"bitline_mac adc 0 {tag}", 1e-5, 1e-8)
    lsb = i_max / (2 ** 7 - 1)
    err3 = max(err3, hold_close(bitline_mac_kernel(v, g, 8, i_max),
                                ref.ref_bitline_mac(v, g, 8, i_max),
                                f"bitline_mac adc 8 {tag}", 1e-5, 1e-8, lsb))

    # B4 on the bnn path's operands, exact; and with a tenth of them 0
    # (the operand contract is {-1, 0, +1})
    xb, wb = binarize_acc(x, 1), binarize_acc(w, 1)
    xz = torch.where(torch.rand(m, k, generator=gen, device=dev) < 0.1, 0.0, xb)
    wz = torch.where(torch.rand(k, n, generator=gen, device=dev) < 0.1, 0.0, wb)
    for a_, w_, binarize, tie in ((xb, wb, False, 1), (xb, wb, True, -1),
                                  (xb.bfloat16(), wb.bfloat16(), False, 1),
                                  (xz, wz, True, 1), (xz, wz, False, 1),
                                  (xz.bfloat16(), wz.bfloat16(), True, -1)):
        if not torch.equal(xnor_gemm_kernel(a_, w_, binarize, tie),
                           ref.ref_xnor_gemm(a_, w_, binarize, tie)):
            raise AssertionError(f"xnor_gemm {a_.dtype} binarize={binarize} "
                                 f"{tag}: not exact")

    # B5 on the fake path's operands: the path's (no FET, no fail plane) and
    # with the ss corner's FET round trip + write-BER fail plane, each aux
    # plane sized on the card and held against the plain sizing
    err5 = 0.0
    with SizingHeld(tag) as sizing:
        fake_ops = fake_operand_sets(x, w, bl, dev)
    for label, (ops, fk) in fake_ops.items():
        out = fake_analog_kernel(*ops, **fk)
        plain = ref.ref_fake_analog(*ops, **fk)
        dec = ops[3][ROW_DECODE, 0].item()
        lsb5 = dec * ops[3][ROW_I_MAX, 0].item() / (2 ** 7 - 1)
        err5 = max(err5, hold_close(out, plain, f"fake_analog {label} {tag}",
                                    1e-6, 1e-6 * dec, lsb5))

    # B5's raw currents bit-equal to B3's on the same g_diff (no IR drop,
    # shared full scale)
    cfg0 = ap.AnalogConfig(adc_bits=8, tmr=5.0, ir_drop=False)
    arr0 = ap.program_weights(w, "afmtj", cfg0, device=dev)
    v0, im0, _ = ap.kernel_operands(arr0, x)
    setup0 = ma.fake_setup("afmtj", cfg0, dev, bl=bl, i_max=im0, decode=False)
    with sizing:
        ops0 = ma.fake_operands(x, w, setup0, bl)
    raw5 = fake_analog_kernel(*ops0, adc_bits=8)
    raw3 = bitline_mac_kernel(v0, arr0.g_diff, 8, im0)
    if not torch.equal(raw5, raw3):
        raise AssertionError(f"{tag}: fake_analog raw currents differ from "
                             f"bitline_mac's on the same g_diff")
    del xz, wz
    log(f"  {tag}: bitline_mac max|d| {err3:.3e}, xnor exact, fake_analog "
        f"max|d| {err5:.3e}, raw currents bit-equal; adc_sizing aux plane "
        f"bit-equal to the plain sizing ({sizing.held} products)")
    rec.update(bitline_mac_err=err3, fake_analog_err=err5,
               adc_sizing_held=sizing.held)
    if not timed:
        return rec

    f4 = 4
    ops_p, fk_p = fake_ops["path"]
    ops_f, fk_f = fake_ops["fet+fail"]
    reps = 10
    xh, wh = xb.bfloat16(), wb.bfloat16()
    b3_bound = gemm_bound(m, k, n, ADC_OPS * m * n, f4 * (m * k + k * n + m * n))
    b5_bound = gemm_bound(m, k, n, REPLAY_OPS * k * n + (ADC_OPS + 1) * m * n,
                          f4 * (m * k + k * n + 4 * n + m * n))
    # + the fail plane read, and the FET / decode work
    b5f_bound = gemm_bound(m, k, n, REPLAY_OPS_FET_FAIL * k * n
                           + (ADC_OPS + 1) * m * n,
                           f4 * (m * k + 2 * k * n + 4 * n + m * n))

    def b4_bound(elt: int):
        # +-1 operands: int8 tensor-core rate; bytes in the arriving dtype
        return gemm_bound(m, k, n, 0, elt * (m * k + k * n) + f4 * m * n,
                          H100_INT8_OPS_S)

    def both(key, fn):
        """{key: eager ms, key_device: graph-replayed device ms} of fn."""
        return {key: time_ms(torch, fn, reps),
                f"{key}_device": graph_ms(torch, fn, reps)}

    host = {"bitline_mac": lambda: bitline_mac_kernel(v, g, 8, i_max),
            "xnor_gemm": lambda: xnor_gemm_kernel(xb, wb),
            "fake_analog": lambda: fake_analog_kernel(*ops_p, **fk_p),
            "torch.matmul": lambda: torch.matmul(v, g)}
    rec["host_us"] = {name: host_us(torch, fn) for name, fn in host.items()}

    rec["bitline_mac"] = dict(
        **both("ms", lambda: bitline_mac_kernel(v, g, 8, i_max)),
        **both("ms_adc0", lambda: bitline_mac_kernel(v, g, 0, i_max)),
        plain_ms=time_ms(torch, lambda: ref.ref_bitline_mac(v, g, 8, i_max), 3),
        **both("library_ms", lambda: torch.matmul(v, g)),
        bound_ms=b3_bound[0], bound_by=b3_bound[1])
    rec["xnor_gemm"] = dict(
        **both("ms", lambda: xnor_gemm_kernel(xb, wb)),
        **both("ms_bf16", lambda: xnor_gemm_kernel(xh, wh)),
        plain_ms=time_ms(torch, lambda: ref.ref_xnor_gemm(xb, wb), 3),
        **both("library_ms", lambda: torch.matmul(xb, wb)),
        **both("library_ms_bf16", lambda: torch.matmul(xh, wh)),
        bound_ms=b4_bound(4)[0], bound_by=b4_bound(4)[1],
        bound_ms_bf16=b4_bound(2)[0], bound_by_bf16=b4_bound(2)[1])
    rec["fake_analog"] = dict(
        **both("ms", lambda: fake_analog_kernel(*ops_p, **fk_p)),
        **both("ms_fet_fail", lambda: fake_analog_kernel(*ops_f, **fk_f)),
        plain_ms=time_ms(torch, lambda: ref.ref_fake_analog(*ops_p, **fk_p), 3),
        library_ms=None, library_ms_device=None,
        bound_ms=b5_bound[0], bound_by=b5_bound[1],
        bound_ms_fet_fail=b5f_bound[0], bound_by_fet_fail=b5f_bound[1])
    # the path's sizing launch: 2 N reads and 8 N writes of float32
    sz_args, sz_kw = sizing.first
    sz_bound = gemm_bound(0, 0, 0, 0, f4 * 10 * n)
    rec["adc_sizing"] = dict(
        **both("ms", lambda: adc_aux_kernel(*sz_args, **sz_kw)),
        bound_ms=sz_bound[0], bound_by=sz_bound[1])
    # B5 against B3 adc 8 on the same operands (B3 on the g_diff that B5
    # replays, the path's uniform full scale), device time in turns
    g_p = _tile_g_diff(ops_p[1], ops_p[2], ops_p[3], apply_fet=False,
                       use_fail=False)
    i_max_p = ops_p[3][ROW_I_MAX, 0].item()
    turns = {"b3": lambda: bitline_mac_kernel(ops_p[0], g_p, 8, i_max_p),
             "b5": lambda: fake_analog_kernel(*ops_p, **fk_p)}
    r5 = rec["fake_analog"]
    n_turn = turn_calls(r5["ms_device"])
    t = [graph_ms(torch, turns[key], n_turn) for key in ("b3", "b5", "b5", "b3")]
    r5.update(b3_turns_ms_device=(t[0] + t[3]) / 2,
              b5_turns_ms_device=(t[1] + t[2]) / 2)
    r5["b5_over_b3"] = r5["b5_turns_ms_device"] / r5["b3_turns_ms_device"]
    r5["no_slower_than_parent"] = (
        r5["b5_over_b3"] <= NO_SLOWER * PARENT_B5_OVER_B3.get(what, math.inf))
    for name in ("bitline_mac", "xnor_gemm", "fake_analog"):
        r = rec[name]
        lib = ("" if r["library_ms"] is None else
               f", torch.matmul {r['library_ms']:.4f} ms (device "
               f"{r['library_ms_device']:.4f})")
        if "ms_adc0" in r:
            lib += (f"; kernel without ADC {r['ms_adc0']:.4f} ms (device "
                    f"{r['ms_adc0_device']:.4f})")
        log(f"    {name}: kernel {r['ms']:.4f} ms (device "
            f"{r['ms_device']:.4f}), plain {r['plain_ms']:.4f} ms{lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), device time "
            f"{100 * r['bound_ms'] / r['ms_device']:.1f}% of it")
    log("    host us per call: " + ", ".join(
        f"{name} {us:.1f}" for name, us in rec["host_us"].items()))
    log(f"    fake_analog fet+fail: kernel {r5['ms_fet_fail']:.4f} ms (device "
        f"{r5['ms_fet_fail_device']:.4f}, "
        f"{r5['ms_fet_fail_device'] / r5['ms_device']:.3f}x the path's), "
        f"bound {r5['bound_ms_fet_fail']:.4f} ms ({r5['bound_by_fet_fail']}),"
        f" device time "
        f"{100 * r5['bound_ms_fet_fail'] / r5['ms_fet_fail_device']:.1f}% of "
        f"it; in turns, device: bitline_mac adc 8 "
        f"{r5['b3_turns_ms_device']:.4f} ms, fake_analog "
        f"{r5['b5_turns_ms_device']:.4f} ms ({r5['b5_over_b3']:.4f}x; the "
        f"parent's B5 {PARENT_B5_OVER_B3.get(what, math.nan):.3f}x"
        f"{'' if r5['no_slower_than_parent'] else ', SLOWER'})")
    r = rec["adc_sizing"]
    log(f"    adc_sizing: kernel {r['ms']:.4f} ms (device {r['ms_device']:.4f})"
        f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = rec["xnor_gemm"]
    log(f"    xnor_gemm bfloat16: kernel {r['ms_bf16']:.4f} ms (device "
        f"{r['ms_bf16_device']:.4f}), torch.matmul (bf16 out) "
        f"{r['library_ms_bf16']:.4f} ms (device "
        f"{r['library_ms_bf16_device']:.4f}), bound "
        f"{r['bound_ms_bf16']:.4f} ms ({r['bound_by_bf16']}), device time "
        f"{100 * r['bound_ms_bf16'] / r['ms_bf16_device']:.1f}% of it")
    return rec


def per_forward(shapes: list, path: dict) -> dict:
    """Milliseconds per forward: each shape's time (phase 5a or 9a) times
    the launches per forward at that shape counted on the path (5b, 9b),
    summed, for every kernel variant and its ``torch.matmul`` yardstick,
    eager and device."""
    keys = {"bitline_mac adc 8": ("bitline_mac", "ms"),
            "bitline_mac adc 0": ("bitline_mac", "ms_adc0"),
            "torch.matmul float32": ("bitline_mac", "library_ms"),
            "xnor_gemm float32": ("xnor_gemm", "ms"),
            "xnor_gemm bfloat16": ("xnor_gemm", "ms_bf16"),
            "torch.matmul +-1 float32": ("xnor_gemm", "library_ms"),
            "fake_analog adc 8": ("fake_analog", "ms"),
            "fake_analog fet+fail adc 8": ("fake_analog", "ms_fet_fail"),
            "bitline_mac bound": ("bitline_mac", "bound_ms"),
            "xnor_gemm float32 bound": ("xnor_gemm", "bound_ms"),
            "fake_analog bound": ("fake_analog", "bound_ms"),
            "fake_analog fet+fail bound": ("fake_analog", "bound_ms_fet_fail")}
    timed = {tuple(x["shape"]): x for x in shapes}
    per_shape = {}
    for name, n_fwd in FORWARDS.items():
        counts = path["launch_shapes"][name]
        if set(counts) - set(timed):
            raise AssertionError(f"{name} launched at shapes the hold did not "
                                 f"time: {sorted(set(counts) - set(timed))}")
        if any(c % n_fwd for c in counts.values()):
            raise AssertionError(f"{name}: launches {dict(counts)} are not "
                                 f"{n_fwd} equal forwards")
        per_shape[name] = {s: c // n_fwd for s, c in counts.items()}
    out = {}
    for suffix in ("", "_device"):
        out["eager" if not suffix else "device"] = {
            label: sum(timed[s][name][key + ("" if key.startswith("bound_ms")
                                             else suffix)] * c
                       for s, c in per_shape[name].items())
            for label, (name, key) in keys.items()}
    out["launches_per_forward"] = {
        name: {"x".join(map(str, s)): c for s, c in sorted(d.items())}
        for name, d in per_shape.items()}
    return out


def require_b5_no_slower(shapes: list) -> None:
    """Fail unless B5 was no more than 3% slower than the parent's B5 at
    every qwen2 shape: its time over B3 adc 8's on the same operands (in
    turns, device time) within ``NO_SLOWER`` x ``PARENT_B5_OVER_B3``."""
    slower = [f"{x['what']}: fake_analog / bitline_mac "
              f"{x['fake_analog']['b5_over_b3']:.4f}, the parent's "
              f"{PARENT_B5_OVER_B3[x['what']]:.3f}"
              for x in shapes if not x["fake_analog"]["no_slower_than_parent"]]
    if slower:
        raise AssertionError("fake_analog more than 3% slower than the "
                             "parent's: " + "; ".join(slower))


def ptxas_lines(log: str) -> list:
    """The ``-Xptxas -v`` lines naming each entry function and giving its
    registers, stack and spills."""
    return [line.strip() for line in log.splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line]


def phase5_hold(torch, dev) -> list:
    log("phase 5a: analog kernels vs plain versions (odd shapes, then every "
        "full-width qwen2-0.5b launch shape, timed)")
    for m, k, n in ODD_SHAPES:
        hold_analog_at_shape(torch, dev, m, k, n, "odd shape", timed=False)
    return [hold_analog_at_shape(torch, dev, QWEN_M, k, n, what, timed=True)
            for k, n, what in QWEN_SHAPES]


def log_per_forward(fwd: dict, phase: str = "5b") -> None:
    log(f"  kernel time per forward (launches per shape counted in phase "
        f"{phase}; eager, device):")
    for label, ms in fwd["eager"].items():
        log(f"    {label}: {ms:.3f} ms, {fwd['device'][label]:.3f} ms")
    log(f"    launches per forward by shape: {fwd['launches_per_forward']}")


def analog_path(torch, dev, arch: str, linears: int) -> dict:
    """The model-level analog accuracy path of ``arch`` at full width
    (batch 2 x seq 64, random weights from seed 0) through its entry points:
    the fake surface (adc 4 / 6 / 8, TMR 5.0), the device mode twice
    through the programming cache, fake adc 8 and bnn.  The analog
    kernels' counters are set to 0 just before and read just after; fails
    unless fake and device logits are bit-identical (KL < 1e-4 with token
    match 1.0 besides), the second device call is bit-identical, KL falls
    with adc bits, every kernel launched ``linears`` times per forward and
    the sizing kernel once per fake product."""
    from repro_torch.imc import model_analog as ma
    from repro_torch.imc.analog_pipeline import AnalogConfig
    from repro_torch.kernels import adc_sizing, analog_mac
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel
    from repro_torch.kernels.fake_analog import fake_analog_kernel
    from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel
    from repro_torch.models.model import n_params as count_params

    kernels = {"bitline_mac": bitline_mac_kernel,
               "xnor_gemm": xnor_gemm_kernel,
               "fake_analog": fake_analog_kernel}
    cache_dir = ROOT / "build" / "smoke-programming-cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    analog_mac.reset_counts(*kernels.values())
    adc_sizing.reset_counts()
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    kw = dict(batch=2, seq_len=64, smoke=False)
    surf = timed("fake surface (3 forwards)", lambda: ma.model_accuracy_surface(
        arch, mode="fake", adc_bits=(4, 6, 8), tmrs=(5.0,), **kw))
    state = timed("setup", lambda: ma._setup(arch, False, 2, 64, 0))
    cfg, params, tokens, ref_logits = state
    want = (2, 64, cfg.vocab)
    if tuple(ref_logits.shape) != want or not torch.isfinite(ref_logits).all():
        raise AssertionError(f"exact logits {tuple(ref_logits.shape)} "
                             f"not finite / wrong shape")
    acfg = AnalogConfig(adc_bits=8, tmr=5.0)
    y_dev = timed("device, programming", lambda: ma.analog_model_logits(
        params, cfg, tokens, acfg, mode="device", cache_dir=str(cache_dir)))
    y_dev2 = timed("device, cache hits", lambda: ma.analog_model_logits(
        params, cfg, tokens, acfg, mode="device", cache_dir=str(cache_dir)))
    y_fake = timed("fake adc 8", lambda: ma.analog_model_logits(
        params, cfg, tokens, acfg, mode="fake"))
    bnn = timed("bnn", lambda: ma.model_accuracy(
        arch, AnalogConfig(), mode="bnn", _setup_state=state, **kw))
    launches = {name: kern.launches for name, kern in kernels.items()}
    sizing_launches = adc_sizing.adc_aux_kernel.launches
    reduce_launches = {name: kern.reduce_launches
                       for name, kern in kernels.items()}
    launch_shapes = {name: dict(kern.launch_shapes)
                     for name, kern in kernels.items()}
    cache_bytes = sum(f.stat().st_size for f in cache_dir.glob("*.npz"))
    shutil.rmtree(cache_dir, ignore_errors=True)

    n_params = count_params(params)
    log(f"  {n_params:,} parameters; programming cache {cache_bytes / 1e9:.3f}"
        f" GB (deleted)")
    for r in surf:
        log(f"  fake   adc {r.adc_bits} TMR {r.tmr}: KL {r.kl:.6f}, token "
            f"match {r.token_match:.4f}, ppl {r.ppl_analog:.1f} (exact "
            f"{r.ppl_ref:.1f})")
    kl_d, match_d, ppl_d, ppl_r = ma.logit_metrics(ref_logits, y_dev, tokens)
    log(f"  device adc 8 TMR 5.0: KL {kl_d:.6f}, token match {match_d:.4f}, "
        f"ppl {ppl_d:.1f} (exact {ppl_r:.1f})")
    log(f"  bnn: KL {bnn.kl:.6f}, token match {bnn.token_match:.4f}, ppl "
        f"{bnn.ppl_analog:.1f}")
    kl_fd, match_fd, _, _ = ma.logit_metrics(y_dev, y_fake, tokens)
    same = bool(torch.equal(y_dev, y_dev2))
    fake_is_device = bool(torch.equal(y_dev, y_fake))
    log(f"  fake vs device (adc 8): KL {kl_fd:.3e}, token match {match_fd}, "
        f"bit-identical {fake_is_device}; second device call bit-identical: "
        f"{same}")
    for name, sec in walls.items():
        log(f"  wall {name}: {sec:.2f} s")
    log(f"  launches: {launches}; of which split K (+1 reduce-pass launch "
        f"each): {reduce_launches}; adc_sizing {sizing_launches}")
    kl = {r.adc_bits: r.kl for r in surf}
    for y in (y_dev, y_fake):
        if tuple(y.shape) != want or not torch.isfinite(y).all():
            raise AssertionError("analog logits not finite / wrong shape")
    if not (abs(kl_fd) < 1e-4 and match_fd == 1.0):
        raise AssertionError(f"fake vs device: KL {kl_fd}, match {match_fd}")
    if not fake_is_device:
        raise AssertionError(f"{arch}: fake and device logits differ")
    if not same:
        raise AssertionError("device mode through the programming cache is "
                             "not bit-identical")
    if not kl[4] > kl[6] > kl[8]:
        raise AssertionError(f"KL not monotone in adc bits: {kl}")
    expect = {name: n * linears for name, n in FORWARDS.items()}
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    if sizing_launches != launches["fake_analog"]:
        raise AssertionError(f"adc_sizing launches {sizing_launches}, "
                             f"expected one per fake product "
                             f"({launches['fake_analog']})")
    return dict(launches=launches, reduce_launches=reduce_launches,
                sizing_launches=sizing_launches,
                launch_shapes=launch_shapes, walls=walls, kl=kl, kl_device=kl_d,
                match_device=match_d, kl_bnn=bnn.kl, kl_fake_vs_device=kl_fd,
                fake_is_device=fake_is_device, cache_bytes=cache_bytes,
                ppl=dict(exact=ppl_r, device=ppl_d, bnn=bnn.ppl_analog),
                n_params=n_params)


def phase5_path(torch, dev) -> dict:
    """Phase 5b: qwen2-0.5b through ``analog_path``."""
    log("phase 5b: qwen2-0.5b at full width (24 layers, d_model 896, vocab "
        "151,936, random weights from seed 0), batch 2 x seq 64, every "
        "linear through the analog MVM")
    return analog_path(torch, dev, "qwen2-0.5b", LINEARS_PER_FORWARD)


# --- phase 6: the example twins --------------------------------------------

def hold_number(got: float, want: float, what: str) -> None:
    """``got`` within ``ANCHOR_RTOL`` of the reference's ``want``; a
    non-finite ``want`` must be matched by the same non-finite value."""
    if not math.isfinite(want):
        if got != want:
            raise AssertionError(f"{what}: {got}, the reference's {want}")
    elif not abs(got / want - 1) < ANCHOR_RTOL:
        raise AssertionError(f"{what}: {got}, the reference's {want} "
                             f"(rtol {ANCHOR_RTOL})")


def hold_twins(qs: dict, cs: dict) -> float:
    """Every number the twins print against the reference's output of the
    two examples, and each arch's tiles and decode times against the
    reference's ``map_all``; returns the largest relative gap."""
    gaps = []

    def hold(got, want, what):
        hold_number(got, want, what)
        if math.isfinite(want):
            gaps.append(abs(got / want - 1))

    for kind in ("afmtj", "mtj"):
        ref = REF_QUICKSTART[kind]
        if qs[kind]["switched"] != ref["switched"]:
            raise AssertionError(f"quickstart {kind} switched "
                                 f"{qs[kind]['switched']}, the reference's "
                                 f"{ref['switched']}")
        for key in ("latency", "energy"):
            for i, (g, w) in enumerate(zip(qs[kind][key], ref[key])):
                hold(g, w, f"quickstart {kind} {key} [{i}]")
    single = REF_QUICKSTART["single"]
    if qs["single"]["switched"] != single["switched"]:
        raise AssertionError("quickstart 1 V write: switched differs")
    for key in ("latency", "energy"):
        hold(qs["single"][key], single[key], f"quickstart 1 V {key}")
    for kind in ("afmtj", "mtj"):
        if list(cs[kind]) != list(REF_CASE_STUDY[kind]):
            raise AssertionError(f"case study {kind}: rows {list(cs[kind])}")
        for name, want in REF_CASE_STUDY[kind].items():
            for g, w, what in zip(cs[kind][name], want,
                                  ("speedup", "energy saving")):
                hold(g, w, f"case study {kind} {name} {what}")
    if list(cs["map"]) != list(REF_CASE_STUDY["map"]):
        raise AssertionError(f"case study archs: {list(cs['map'])}")
    for name, want in REF_CASE_STUDY["map"].items():
        for g, w, what in zip(cs["map"][name], want,
                              ("afmtj speedup", "afmtj energy saving",
                               "mtj speedup")):
            hold(g, w, f"mapping {name} {what}")
    if list(cs["decode"]) != list(REF_DECODE):
        raise AssertionError(f"case study decode archs: {list(cs['decode'])}")
    for name, (tiles, *t_imc) in REF_DECODE.items():
        if cs["decode"][name][0] != tiles:
            raise AssertionError(f"mapping {name}: {cs['decode'][name][0]} "
                                 f"tiles, the reference's {tiles}")
        for g, w, what in zip(cs["decode"][name][1:], t_imc,
                              ("afmtj t_imc", "mtj t_imc")):
            hold(g, w, f"mapping {name} {what}")
    return max(gaps)


def phase6(torch) -> dict:
    """Both example twins at full size through their entry points
    (``run``), every printed number held within ``ANCHOR_RTOL`` of the
    reference's; the write kernel's counter is set to 0 just before and
    read just after."""
    from repro_torch.circuit import subarray
    from repro_torch.imc.write_path import nominal_pulse
    from repro_torch.kernels import llg_write

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_imc_case_study
    import torch_quickstart

    log("phase 6: the example twins at full size (quickstart: 4 voltages x "
        "16,000 AFMTJ steps and 60,000 MTJ steps; case study: Fig. 4 and "
        "the ten-arch decode mapping)")
    subarray._characterize_write.cache_clear()
    nominal_pulse.cache_clear()
    llg_write.reset_counts()
    walls = {}
    t0 = time.perf_counter()
    qs = torch_quickstart.run()
    walls["quickstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = torch_imc_case_study.run()
    walls["imc_case_study"] = time.perf_counter() - t0
    launches = llg_write.llg_write_kernel.launches
    for line in torch_quickstart.report(qs) + [""] + \
            torch_imc_case_study.report(cs):
        log("  " + line)
    log(f"  wall: quickstart {walls['quickstart']:.3f} s, case study "
        f"{walls['imc_case_study']:.3f} s; write kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("the twins never launched the write kernel")
    gap = hold_twins(qs, cs)
    log(f"  every printed number within {ANCHOR_RTOL:.0%} of the reference's "
        f"output, each arch's tiles equal and decode times within "
        f"{ANCHOR_RTOL:.0%} of its map_all (largest gap {gap:.3e})")
    return dict(launches=launches, walls=walls, max_rel_gap=gap)


# --- phase 7: process corners and the measured read path -----------------------

# the reference's own output of examples/variation_study.py and
# examples/retention_study.py at full size (src/repro, CPU), unrounded, as
# tools/ref_study_numbers.py prints it: per kind and D2D sigma the worst-T
# WER at the shortest rung and the margined pulse [s]; the retention
# campaign's reductions per (corner, T, accel), the disturb fit (with the
# escapes per rung of its campaign) and its p1 table, the refresh policy
# and Fig. 4 with and without the scrub
REF_VARIATION_STUDY = {'sigmas': [0.0, 0.1, 0.2],
 'n_samples': 64,
 'afmtj': {'wer_short': [0.25, 0.25, 0.328125],
           'pulse': [2.5e-10, 2.75e-10, 2.75e-10]},
 'mtj': {'wer_short': [0.15625, 0.234375, 0.375],
         'pulse': [2e-09, 2.2e-09, 2.5e-09]}}
REF_RETENTION_STUDY = {'retention': {'corners': ['tt', 'ss', 'ff'],
               'shape': [3, 1, 3],
               'accel_factors': [0.05, 0.1, 0.15],
               'temperatures': [300.0],
               'n_samples': 256,
               'n_steps': 40001,
               'delta_eff': [2.0000000000000004,
                             4.000000000000001,
                             6.000000000000001,
                             2.0900000000000007,
                             4.1800000000000015,
                             6.2700000000000005,
                             1.9110000000000011,
                             3.8220000000000023,
                             5.733000000000001],
               'tau_acc': [1.4798707112970711e-09,
                           2.8885648484848493e-08,
                           math.inf,
                           1.4384526970954357e-09,
                           2.8014329411764713e-08,
                           math.inf,
                           1.422708230452675e-09,
                           2.0820177777777784e-08,
                           2.540891250000001e-07],
               'n_flips': [239, 33, 0, 241, 34, 0, 243, 45, 4],
               'slope': [1.4856950764137034,
                         1.4206450354058924,
                         1.3907123119081721],
               'tau_op': [53039176.17410868,
                          282445695.054979,
                          9587756.455402568],
               'worst_tau_op': 9587756.455402568},
 'disturb': {'accel_factor': 0.1,
             'delta_acc': 4.000000000000001,
             'v_c': 0.32855042016806724,
             'beta': 3.1124614780994873,
             'sse': 0.010040885359547388,
             'voltages': [0.0, 0.05, 0.1, 0.15],
             'tau_meas': [4.060497083333334e-08,
                          6.784176724137933e-09,
                          2.9334555e-09,
                          1.3430020080321287e-09],
             'flips': [24, 116, 200, 249],
             'n_samples': 256,
             'tau0': 2.2532920979643326e-10,
             'delta_eff': [32.89764809682422,
                           23.92776185479718,
                           12.926287294537754,
                           5.994488244664807],
             'p1': [1.1452109044004869e-14,
                    9.004457918910878e-11,
                    5.399283041774112e-06,
                    0.005515424240555824]},
 'refresh': {'interval': 4.104652582477029e-06,
             'limited_by': 'disturb',
             'tau_retention': 9587756.455402568,
             'p1_read': 2.436259781515342e-10,
             'reads_max': 4.104652582477029,
             'ber_budget': 1e-09,
             'reads_per_cell_s': 1000000.0,
             'summarize': [14.939246898721372, 17.41633381712113],
             'summarize_refresh': [11.65053540466181, 8.129833387637573],
             'share': {'bnn': [0.05795583187544131, 0.04412363866865831],
                       'mat_add': [0.6502391071955498,
                                   0.9379629366599821]}}}
# the first steps of each long launch held against the eager plain version
# (3.6 ms a step on the card, whatever the lanes); the whole horizon is
# held against the kernel's C1T1 layout
TRUNC_STEPS = 4001
# Monte-Carlo holds: two independent estimates of the same quantity differ
# by at most MC_SIGMAS standard errors of their difference
MC_SIGMAS = 3.0
# the slice's corners: tt / ss / ff (core/params)
PATH_CORNERS = ("tt", "ss", "ff")


class LaunchRecorder:
    """The campaign engine's kernel entry with a record: every launch made
    while ``tag`` is set keeps a copy of its inputs under that tag (the
    launch itself goes through unchanged and is counted as ever)."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.tag = None
        self.launches = {}

    def __call__(self, state, p, dt, n_steps, switch_threshold=0.9, **kw):
        if self.tag is not None:
            assert switch_threshold == 0.9, switch_threshold
            self.launches.setdefault(self.tag, []).append(dict(
                state=state.clone(), p=p, dt=dt, n_kernel=n_steps,
                kw={k: v.clone() if hasattr(v, "clone") else v
                    for k, v in kw.items()}))
        return self.kernel(state, p, dt, n_steps, switch_threshold, **kw)


def phase7_path(torch, rec) -> dict:
    """The slice's path at full size through its entry points: the
    corner-margined pulses, the corner write-verify, the disturb campaigns,
    the refresh policies, Fig. 4 with measured reads and the scrub, the
    slow corner's write, and both twins.  The LLG and write kernels'
    counters are set to 0 just before and read just after."""
    from repro_torch.circuit import subarray
    from repro_torch.core.device import simulate_write
    from repro_torch.core.params import PROCESS_CORNERS, VariationSpec
    from repro_torch.imc import evaluate, read_path, write_margin, write_path
    from repro_torch.imc.write_margin import params_for
    from repro_torch.kernels import llg_rk4, llg_write

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_retention_study
    import torch_variation_study

    log("phase 7: process corners and the measured read path at full size")
    spec = VariationSpec(corners=tuple(PROCESS_CORNERS[c]
                                       for c in PATH_CORNERS))
    for f in (write_margin.wer_margined_pulse,
              write_path.measured_write_timings, write_path.nominal_pulse,
              subarray._characterize_write, read_path.measured_read_timings,
              read_path.derive_refresh_policy):
        f.cache_clear()
    llg_rk4.reset_counts()
    llg_write.reset_counts()
    t0 = time.perf_counter()
    walls, out = {}, dict(pulse={}, refresh={}, fig4={}, corner_write={})

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        walls[name] = time.perf_counter() - t
        return r

    for kind in ("afmtj", "mtj"):
        rec.tag = f"{kind} corner WER ladder"
        out["pulse"][kind] = timed(f"wer_margined_pulse {kind} tt/ss/ff",
                                   lambda: write_margin.wer_margined_pulse(
                                       kind, 1.0, 1e-2, use_cache=False,
                                       variation=spec))
    rec.tag = "afmtj corner write-verify"
    wv = timed("write_verify_corners afmtj 4096 tt/ss/ff",
               lambda: write_path.write_verify_corners(
                   "afmtj", 4096, write_path.WritePolicy(use_cache=False),
                   spec))
    disturb = {}
    for kind in ("afmtj", "mtj"):
        rec.tag = f"{kind} disturb campaign"
        disturb[kind] = timed(f"read_disturb_campaign {kind}",
                              lambda: read_path.read_disturb_campaign(
                                  kind, use_cache=False))
    rec.tag = "afmtj refresh policy"
    pol = timed("derive_refresh_policy afmtj",
                lambda: read_path.derive_refresh_policy("afmtj",
                                                        use_cache=False))
    out["refresh"] = pol
    # the MTJ's accelerated barriers (Delta_eff 2.25-6.75 at a ~10x slower
    # attempt time) do not escape within 8 ns: its retention campaign
    # measures no escape, and its disturb fit raises as the reference's
    # does, so no MTJ scrub interval is derived (and none charged)
    rec.tag = "mtj retention"
    ret_mtj = timed("retention_campaign mtj",
                    lambda: read_path.retention_campaign("mtj",
                                                         use_cache=False))
    out["mtj_retention_escapes"] = int(ret_mtj.n_flips.sum())
    rec.tag = "mtj disturb fit"
    try:
        timed("fit_disturb_model mtj", lambda: read_path.fit_disturb_model(
            "mtj", use_cache=False))
        out["mtj_fit"] = "fitted"
    except ValueError as e:
        out["mtj_fit"] = str(e)
    rec.tag = "evaluate_system"
    read_kw = dict(write_percentile=99.0, read_percentile=99.0,
                   offset_sigma=5e-3)
    for kind in ("afmtj", "mtj"):
        out["fig4"][kind] = timed(
            f"evaluate_system {kind} p99 write + p99 read",
            lambda: evaluate.evaluate_system(kind, **read_kw))
    out["fig4"]["afmtj+scrub"] = timed(
        "evaluate_system afmtj p99 write + p99 read + scrub",
        lambda: evaluate.evaluate_system("afmtj", refresh=pol, **read_kw))
    rec.tag = None
    for kind in ("afmtj", "mtj"):
        p = params_for(kind)
        n, dt = (16000, 0.05e-12) if kind == "afmtj" else (40000, 0.1e-12)
        before = llg_write.llg_write_kernel.launches
        w = timed(f"simulate_write {kind} 1 V ss sample",
                  lambda: simulate_write(p, 1.0, n_steps=n, dt=dt, t_rc=0.0,
                                         variation=spec.sample_device(p, 1)))
        if llg_write.llg_write_kernel.launches != before + 1:
            raise AssertionError("the corner write did not launch the write "
                                 "kernel")
        out["corner_write"][kind] = (float(w.t_switch), float(w.energy))
    rec.tag = "variation twin"
    twin_var = timed("torch_variation_study.run",
                     lambda: torch_variation_study.run(use_cache=False))
    rec.tag = "retention twin"
    twin_ret = timed("torch_retention_study.run",
                     lambda: torch_retention_study.run(use_cache=False))
    rec.tag = None
    wall = time.perf_counter() - t0
    launches = llg_rk4.llg_rk4_kernel.launches
    layouts = dict(llg_rk4.llg_rk4_kernel.launch_layouts)
    write_launches = llg_write.llg_write_kernel.launches
    for name, sec in walls.items():
        log(f"  {name}: {sec:.2f} s")
    log(f"  phase 7 path: {wall:.1f} s; LLG launches {launches}, write "
        f"kernel launches {write_launches}")
    by_layout = {f"{cells} lanes, NSUB={nsub}, {layout_tag(lay[:3])}, "
                 f"VARIATION={lay[3]}": k for (cells, nsub, *lay), k in
                 sorted(layouts.items())}
    log(f"  LLG launches of phase 7 by layout: {by_layout}")
    if launches <= 0 or write_launches <= 0:
        raise AssertionError("phase 7 never launched the LLG or the write "
                             "kernel")
    if not any(key[-1] == 1 for key in layouts):
        raise AssertionError("phase 7 never launched the VARIATION=1 "
                             "instance of the LLG kernel")
    check_phase7(out, wv, disturb)
    return dict(wall_s=wall, walls=walls, launches=launches,
                write_launches=write_launches, launch_layouts=by_layout,
                twins=dict(variation=twin_var, retention=twin_ret),
                pulse=out["pulse"], corner_write=out["corner_write"],
                refresh=dataclasses.asdict(out["refresh"]),
                mtj_retention_escapes=out["mtj_retention_escapes"],
                mtj_fit=out["mtj_fit"],
                corner_write_verify={
                    name: dict(attempts_mean=r.attempts_mean,
                               residual_ber=r.residual_ber, rounds=r.rounds,
                               energy_mean=r.energy_mean())
                    for name, r in wv.items()})


def check_phase7(out, wv, disturb) -> None:
    """What the path returned, by the repo's own means: pulses on the
    ladder and no shorter than the nominal ones, the slow corner retrying
    more, a finite AFMTJ refresh interval, no MTJ escape in its window
    (and its fit refused, as the reference's is), AFMTJ ahead of MTJ on
    every workload with measured reads, the scrub costing AFMTJ time and
    energy, disturb probabilities in [0, 1]."""
    from repro_torch.imc.write_margin import _LADDERS, wer_margined_pulse

    for kind, pulse in out["pulse"].items():
        nominal = wer_margined_pulse(kind, 1.0, 1e-2, use_cache=False)
        log(f"  {kind} margined pulse over tt/ss/ff: {pulse * 1e12:.0f} ps "
            f"(nominal {nominal * 1e12:.0f} ps)")
        if pulse not in _LADDERS[kind] or pulse < nominal:
            raise AssertionError(f"{kind}: corner pulse {pulse} vs nominal "
                                 f"{nominal}")
    for name, r in wv.items():
        log(f"  write_verify_corners afmtj {name}: attempts "
            f"{r.attempts_mean:.4f}, rounds {r.rounds}, residual BER "
            f"{r.residual_ber:.3g}, energy {r.energy_mean() * 1e15:.3f} fJ")
    if not wv["ss"].attempts_mean > wv["ff"].attempts_mean:
        raise AssertionError("the slow corner did not retry more than the "
                             "fast one")
    pol = out["refresh"]
    log(f"  derive_refresh_policy afmtj: {pol}")
    if not (0.0 < pol.interval < math.inf
            and pol.limited_by in ("retention", "disturb")):
        raise AssertionError(f"refresh policy {pol}")
    log(f"  retention_campaign mtj: {out['mtj_retention_escapes']} escapes "
        f"in its 8 ns window; fit_disturb_model mtj: {out['mtj_fit']}")
    if out["mtj_retention_escapes"] or "no zero-bias escapes" not in \
            out["mtj_fit"]:
        raise AssertionError("the MTJ escaped within its window")
    a, m = out["fig4"]["afmtj"], out["fig4"]["mtj"]
    s = out["fig4"]["afmtj+scrub"]
    for name in a:
        log(f"    {name:14s} AFMTJ speedup {a[name].speedup:8.3f}x, energy "
            f"saving {a[name].energy_saving:8.3f}x; with the scrub "
            f"{s[name].speedup:8.3f}x / {s[name].energy_saving:8.3f}x "
            f"({100 * s[name].t_refresh / s[name].t_imc:.2f}% of t_imc); "
            f"MTJ {m[name].speedup:8.3f}x / {m[name].energy_saving:8.3f}x")
        if not (a[name].speedup > m[name].speedup
                and a[name].energy_saving > m[name].energy_saving):
            raise AssertionError(f"{name}: AFMTJ does not beat MTJ")
        if not (s[name].t_refresh > 0 and s[name].t_imc > a[name].t_imc
                and s[name].e_imc > a[name].e_imc):
            raise AssertionError(f"{name}: no scrub charged")
    for kind, d in disturb.items():
        s = d.disturb_surface()
        log(f"  read_disturb_campaign {kind}: p1 (T, V, pulse) max "
            f"{s.max():.4f}, at 0.1 V {s[:, 0].max():.4f}")
        if s.shape != (2, 4, 3) or not ((s >= 0) & (s <= 1)).all():
            raise AssertionError(f"{kind}: disturb surface {s.shape}")
    for kind, (t_sw, en) in out["corner_write"].items():
        log(f"  simulate_write {kind} ss sample: t_switch {t_sw * 1e12:.2f} "
            f"ps, energy {en * 1e15:.3f} fJ")
        if not (math.isfinite(t_sw) and en > 0):
            raise AssertionError(f"{kind}: the ss write did not switch")


def phase7_launches(rec) -> list:
    """(kind, what, recorded launch) of every new launch family: the
    corner WER ladders, the ss corner's first write-verify round, the
    disturb campaigns, and the refresh policies' retention campaigns and
    disturb fits."""
    fams = []
    for kind in ("afmtj", "mtj"):
        fams.append((kind, "corner WER ladder",
                     rec.launches[f"{kind} corner WER ladder"][0]))
    rounds = rec.launches["afmtj corner write-verify"]
    ss = next(r for r in rounds if r["state"].shape[1] == 4096
              and bool((r["kw"]["lane_params"][2, 0] != 1.0).item()))
    fams.append(("afmtj", "ss write-verify round", ss))
    for kind in ("afmtj", "mtj"):
        fams.append((kind, "disturb campaign",
                     rec.launches[f"{kind} disturb campaign"][0]))
    retention, fit = rec.launches["afmtj refresh policy"][:2]
    fams += [("afmtj", "disturb fit (log horizon)", fit),
             ("afmtj", "retention (log horizon)", retention),
             ("mtj", "disturb fit (log horizon)",
              rec.launches["mtj disturb fit"][0]),
             ("mtj", "retention (log horizon)",
              rec.launches["mtj retention"][0])]
    return fams


def hold_long(kind: str, what: str, launch: dict, census,
              trunc_steps: int = TRUNC_STEPS) -> dict:
    """A launch of the slice's path held in two parts, each in every
    layout and timed C1T1 against the rule's layout in turns
    (``hold_launch``): its first ``trunc_steps`` steps against the eager
    plain version (none when ``trunc_steps`` is 0), and its whole horizon
    against the kernel's C1T1 layout, bit for bit.  Returns the whole
    horizon's record."""
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    kw = launch["kw"]
    shape = dict(kind=kind, p=launch["p"], dt=launch["dt"],
                 steps=int(kw["step_budget"].max().item()),
                 n_kernel=launch["n_kernel"], state=launch["state"], kw=kw)
    held = ms_p = None
    if trunc_steps:
        trunc = dict(shape, n_kernel=min(shape["n_kernel"], trunc_steps))
        out_p, ms_p = plain_output(trunc)
        held = hold_launch(trunc, out_p, ms_p,
                           f"{what}, first {trunc['n_kernel']} steps", census)
    out_c1, ms_c1 = cuda_ms(lambda: llg_rk4_kernel(
        shape["state"], shape["p"], shape["dt"], shape["n_kernel"], **kw,
        layout=(1, 1, 0)))
    full = hold_launch(shape, out_c1, ms_c1, f"{what}, whole horizon",
                       census, against="C1T1")
    return dict(full, variation=kw.get("lane_params") is not None,
                plain_ms=ms_p,
                plain_steps=(min(shape["n_kernel"], trunc_steps) if held
                             else None),
                max_abs_err=max(full["max_abs_err"],
                                held["max_abs_err"] if held else 0.0),
                truncated=held)


def phase7_holds(torch, dev, rec, census, write_census) -> tuple:
    """The corner writes bit for bit against ``ref_llg_write`` over their
    whole horizons, and every new LLG launch family (``hold_long``)."""
    from repro_torch.core.params import PROCESS_CORNERS, VariationSpec
    from repro_torch.imc.write_margin import params_for

    log("phase 7 holds: the ss corner's writes (g_scale) vs ref_llg_write, "
        "and every new LLG launch family")
    ss = VariationSpec(corners=(PROCESS_CORNERS["ss"],))
    writes = [hold_write(torch, dev, write_census, kind, (1.0,), n, dt, True,
                         "ss sample", ss.sample_device(params_for(kind)))
              for kind, n, dt in (("afmtj", 16000, 0.05e-12),
                                  ("mtj", 40000, 0.1e-12))]
    shapes = [hold_long(kind, what, launch, census)
              for kind, what, launch in phase7_launches(rec)]
    return writes, shapes


def _mc_hold(ok: bool, what: str, got, want, bound: str):
    log(f"    {what}: {got!r} (reference {want!r}; {bound})"
        f"{'' if ok else ' -- OUTSIDE'}")
    if not ok:
        raise AssertionError(f"{what}: {got!r}, the reference's {want!r} "
                             f"({bound})")


def hold_variation_twin(res: dict) -> None:
    """The variation twin against the reference's output: deterministic
    numbers equal, each worst-T WER within MC_SIGMAS binomial standard
    errors of a difference of two 64-sample estimates at the reference's
    rate, each margined pulse on the same rung or one rung off."""
    from torch_variation_study import LADDERS

    ref = REF_VARIATION_STUDY
    if res["sigmas"] != ref["sigmas"] or res["n_samples"] != ref["n_samples"]:
        raise AssertionError("variation twin: another size than the "
                             "reference's")
    n = ref["n_samples"]
    for kind in ("afmtj", "mtj"):
        if res[kind]["launches"] != 1:
            raise AssertionError(f"variation twin {kind}: "
                                 f"{res[kind]['launches']} launches")
        rungs = list(LADDERS[kind][0])
        for i, s in enumerate(ref["sigmas"]):
            w, g = ref[kind]["wer_short"][i], res[kind]["wer_short"][i]
            q = min(max(w, 1.0 / n), 1.0 - 1.0 / n)
            b = MC_SIGMAS * math.sqrt(2.0 * q * (1.0 - q) / n)
            _mc_hold(abs(g - w) <= b, f"variation twin {kind} sigma {s:g} "
                     f"worst-T WER", g, w, f"|d| <= {b:.3f}")
            pw, pg = ref[kind]["pulse"][i], res[kind]["pulse"][i]
            if math.isnan(pw) or math.isnan(pg):
                ok = math.isnan(pw) and math.isnan(pg)
                off = 0
            else:
                off = abs(rungs.index(pg) - rungs.index(pw))
                ok = off <= 1
            _mc_hold(ok, f"variation twin {kind} sigma {s:g} margined pulse",
                     pg, pw, "the same rung or one off")
            if off == 1:
                log(f"      one rung off: the pulse is the first rung whose "
                    f"worst-T WER <= 5e-2 at 64 samples, and a WER "
                    f"estimate's standard error there (~0.027) spans one "
                    f"rung's WER step")


def _log_bound(k_a: float, k_b: float) -> float:
    """MC_SIGMAS standard errors of ln(tau_a / tau_b) for two
    censored-exponential MLEs from k_a and k_b escapes."""
    return MC_SIGMAS * math.sqrt(1.0 / k_a + 1.0 / k_b)


def hold_retention_twin(res: dict) -> None:
    """The retention twin against the reference's output.  Deterministic
    numbers (Delta_eff, the nominal Fig. 4) within ANCHOR_RTOL; escape
    counts within MC_SIGMAS binomial standard errors (+1 for the count's
    discreteness); escape times, tau0 / tau_op, the free Arrhenius slope,
    the disturb fit's suppression at its rungs and everything downstream
    (p1, the scrub interval, Fig. 4 with the scrub) within MC_SIGMAS
    standard errors propagated from the escape counts (a censored
    exponential MLE from k escapes has ln-standard error 1 / sqrt(k))."""
    import numpy as np

    ref_r, got_r = REF_RETENTION_STUDY["retention"], res["retention"]
    for key in ("corners", "shape", "accel_factors", "temperatures",
                "n_samples", "n_steps"):
        if got_r[key] != ref_r[key]:
            raise AssertionError(f"retention twin {key}: {got_r[key]} vs "
                                 f"{ref_r[key]}")
    if got_r["launches"] != 1:
        raise AssertionError(f"retention twin: {got_r['launches']} launches")
    n = ref_r["n_samples"]
    n_c, n_t, n_f = ref_r["shape"]
    for i, (g, w) in enumerate(zip(got_r["delta_eff"], ref_r["delta_eff"])):
        hold_number(g, w, f"retention twin Delta_eff [{i}]")
    kg = np.array(got_r["n_flips"], float)
    kr = np.array(ref_r["n_flips"], float)
    for i in range(kg.size):
        b = MC_SIGMAS * math.sqrt(kg[i] * (n - kg[i]) / n
                                  + kr[i] * (n - kr[i]) / n) + 1.0
        _mc_hold(abs(kg[i] - kr[i]) <= b, f"retention twin escapes [{i}]",
                 int(kg[i]), int(kr[i]), f"|d| <= {b:.1f}")
        if kg[i] >= 3 and kr[i] >= 3:
            b = _log_bound(kg[i], kr[i])
            g, w = got_r["tau_acc"][i], ref_r["tau_acc"][i]
            _mc_hold(abs(math.log(g / w)) <= b, f"retention twin tau_acc "
                     f"[{i}]", g, w, f"|d ln| <= {b:.3f}")
    d_eff = np.array(ref_r["delta_eff"]).reshape(n_c, n_t, n_f)
    worst_b = 0.0
    for ci in range(n_c):
        for ti in range(n_t):
            sl = slice((ci * n_t + ti) * n_f, (ci * n_t + ti + 1) * n_f)
            okg, okr = kg[sl] >= 3, kr[sl] >= 3
            b = _log_bound(kg[sl][okg].sum(), kr[sl][okr].sum())
            worst_b = max(worst_b, b)
            g, w = got_r["tau_op"][ci * n_t + ti], ref_r["tau_op"][ci * n_t
                                                                  + ti]
            _mc_hold(abs(math.log(g / w)) <= b, f"retention twin tau_op "
                     f"{ref_r['corners'][ci]}", g, w, f"|d ln| <= {b:.3f}")
            x = d_eff[ci, ti]

            def s_xx(k, ok):
                xm = np.average(x[ok], weights=k[ok])
                return float((k[ok] * (x[ok] - xm) ** 2).sum())

            b = MC_SIGMAS * math.sqrt(1 / s_xx(kg[sl], okg)
                                      + 1 / s_xx(kr[sl], okr))
            g = got_r["slope"][ci * n_t + ti]
            w = ref_r["slope"][ci * n_t + ti]
            _mc_hold(abs(g - w) <= b, f"retention twin Arrhenius slope "
                     f"{ref_r['corners'][ci]}", g, w, f"|d| <= {b:.3f}")
    _mc_hold(abs(math.log(got_r["worst_tau_op"] / ref_r["worst_tau_op"]))
             <= worst_b, "retention twin worst tau_op", got_r["worst_tau_op"],
             ref_r["worst_tau_op"], f"|d ln| <= {worst_b:.3f}")

    ref_d, got_d = REF_RETENTION_STUDY["disturb"], res["disturb"]
    if got_d["voltages"] != ref_d["voltages"]:
        raise AssertionError("disturb fit: another voltage ladder")
    hold_number(got_d["accel_factor"], ref_d["accel_factor"],
                "disturb fit accel")
    hold_number(got_d["delta_acc"], ref_d["delta_acc"], "disturb fit Delta")
    k = ref_d["flips"]
    for i, (g, w) in enumerate(zip(got_d["tau_meas"], ref_d["tau_meas"])):
        if k[i] >= 3:
            b = _log_bound(k[i], k[i])
            _mc_hold(abs(math.log(g / w)) <= b, f"disturb fit tau at "
                     f"{ref_d['voltages'][i]:g} V", g, w, f"|d ln| <= {b:.3f}")
    # the fitted suppression at each biased rung: s_i = ln(tau_i/tau_0) /
    # Delta_acc has standard error sqrt(1/k_i + 1/k_0) / Delta_acc
    sig_s = {}
    for i, v in enumerate(ref_d["voltages"]):
        if v > 0 and k[i] >= 3:
            sig_s[v] = math.sqrt(1.0 / k[i] + 1.0 / k[0]) / ref_d["delta_acc"]

            def s_fit(d):
                return (1.0 - v / d["v_c"]) ** d["beta"]

            b = MC_SIGMAS * math.sqrt(2.0) * sig_s[v]
            _mc_hold(abs(s_fit(got_d) - s_fit(ref_d)) <= b,
                     f"disturb fit s({v:g} V) from V_c, beta",
                     s_fit(got_d), s_fit(ref_d), f"|d| <= {b:.3f}")
    log(f"    disturb fit V_c {got_d['v_c']:.4f} V, beta {got_d['beta']:.3f}"
        f" (reference {ref_d['v_c']:.4f} V, {ref_d['beta']:.3f}; held "
        f"through s(V) above: V_c and beta trade off along the fit's "
        f"valley)")
    k0 = sum(k for k, v in zip(kr[:n_f], ref_r["accel_factors"]) if k >= 3)
    volts = (0.02, 0.05, 0.10, 0.15)
    p1_b = {}
    for v, g_de, w_de, g_p1, w_p1 in zip(volts, got_d["delta_eff"],
                                         ref_d["delta_eff"], got_d["p1"],
                                         ref_d["p1"]):
        sig = sig_s.get(v, sig_s[min(sig_s)])
        b_de = MC_SIGMAS * math.sqrt(2.0) * 40.0 * sig
        _mc_hold(abs(g_de - w_de) <= b_de, f"disturb Delta_eff at {v:g} V",
                 g_de, w_de, f"|d| <= {b_de:.2f}")
        p1_b[v] = MC_SIGMAS * math.sqrt(2.0 * (40.0 * sig) ** 2 + 2.0 / k0)
        _mc_hold(abs(math.log(g_p1 / w_p1)) <= p1_b[v], f"disturb p1 at "
                 f"{v:g} V", g_p1, w_p1, f"|d ln| <= {p1_b[v]:.2f}")

    ref_f, got_f = REF_RETENTION_STUDY["refresh"], res["refresh"]
    if got_f["limited_by"] != ref_f["limited_by"]:
        raise AssertionError(f"refresh policy limited by "
                             f"{got_f['limited_by']}, the reference's "
                             f"{ref_f['limited_by']}")
    for i, (g, w) in enumerate(zip(got_f["summarize"], ref_f["summarize"])):
        hold_number(g, w, f"Fig. 4 average without scrub [{i}]")
    b = p1_b[0.05]
    for key in ("p1_read", "interval", "reads_max"):
        _mc_hold(abs(math.log(got_f[key] / ref_f[key])) <= b,
                 f"refresh {key}", got_f[key], ref_f[key],
                 f"|d ln| <= {b:.2f}, the bound of p1 at 0.05 V")
    _mc_hold(abs(math.log(got_f["tau_retention"] / ref_f["tau_retention"]))
             <= worst_b, "refresh tau_retention", got_f["tau_retention"],
             ref_f["tau_retention"], f"|d ln| <= {worst_b:.3f}")
    # Fig. 4 with the scrub: the reference's numbers must be what the
    # port's Fig. 4 gives at some interval within the interval's bound
    from repro_torch.imc.evaluate import evaluate_system, summarize
    from repro_torch.imc.read_path import RefreshPolicy

    lo_hi = []
    for f in (math.exp(-b), math.exp(b)):
        pol = RefreshPolicy(interval=got_f["interval"] * f,
                            limited_by=got_f["limited_by"],
                            tau_retention=got_f["tau_retention"],
                            p1_read=got_f["p1_read"],
                            reads_max=got_f["reads_max"],
                            ber_budget=got_f["ber_budget"],
                            reads_per_cell_s=got_f["reads_per_cell_s"])
        r = evaluate_system("afmtj", refresh=pol)
        lo_hi.append(dict(summarize=list(summarize(r)), share={
            name: [r[name].t_refresh / r[name].t_imc,
                   r[name].e_refresh / r[name].e_imc]
            for name in ("bnn", "mat_add")}))
    for i in range(2):
        band = sorted(x["summarize"][i] for x in lo_hi)
        w = ref_f["summarize_refresh"][i]
        _mc_hold(band[0] <= w <= band[1], f"Fig. 4 average with scrub [{i}]",
                 got_f["summarize_refresh"][i], w,
                 f"the reference's in [{band[0]:.4g}, {band[1]:.4g}], the "
                 f"port's at interval x exp(-/+{b:.2f})")
    for name in ("bnn", "mat_add"):
        for i in range(2):
            band = sorted(x["share"][name][i] for x in lo_hi)
            w = ref_f["share"][name][i]
            _mc_hold(band[0] <= w <= band[1], f"scrub share {name} [{i}]",
                     got_f["share"][name][i], w,
                     f"the reference's in [{band[0]:.4g}, {band[1]:.4g}]")


def phase7(torch, dev, census, write_census) -> dict:
    """Phase 7: the slice's path (``phase7_path``) with a launch recorder
    on the campaign engine's kernel entry, its holds (``phase7_holds``),
    the rule's layout no slower than C1T1 on every new family, and both
    twins held against the reference's output."""
    from repro_torch.campaign import engine

    cache = ROOT / "build" / "smoke-campaign-cache"
    shutil.rmtree(cache, ignore_errors=True)
    rec = LaunchRecorder(engine.llg_rk4_kernel)
    engine.llg_rk4_kernel = rec
    try:
        path = phase7_path(torch, rec)
    finally:
        engine.llg_rk4_kernel = rec.kernel
    shutil.rmtree(cache, ignore_errors=True)
    writes, shapes = phase7_holds(torch, dev, rec, census, write_census)
    require_no_slower(shapes)
    import torch_retention_study
    import torch_variation_study

    log("phase 7 twins against the reference's output:")
    for line in (torch_variation_study.report(path["twins"]["variation"])
                 + [""] + torch_retention_study.report(
                     path["twins"]["retention"])):
        log("  " + line)
    hold_variation_twin(path["twins"]["variation"])
    hold_retention_twin(path["twins"]["retention"])
    log("  every twin number within its bound")
    return dict(path, writes=writes, shapes=shapes)


# --- phase 8: the write-path and fault-cost remainder, and serving ----------

# steps of the two plain holds of phase 8 (one family per device kind); the
# eager plain B1 runs 2-3 ms a step on the card
PHASE8_TRUNC_STEPS = 1001
# fault costs: t_imc / e_imc against nominal x fault_cost_factors
FAULT_RTOL = 1e-12
# decode == forward at full width: the reference's bound
# (tests/test_models.py::test_decode_matches_forward)
DECODE_BOUND = 2e-2
# the first prefill's logits on the card against the same engine's
# parameters on the CPU (float32, TF32 off)
SERVE_CPU_ATOL = 1e-3
WER_TARGETS = (3e-1, 1e-1, 1e-2, 1e-4)


def phase8_fault_costs() -> dict:
    """``evaluate_system(kind, write_percentile=99.0)`` faults off (bit-equal
    to phase 2's) and with ``FaultSpec.at_rate(1e-3)`` under no repair and
    ``REPAIR_SPARE`` (t_imc / e_imc = nominal x the fault cost factors,
    ``array_yield`` the factor's yield)."""
    from repro_torch.imc import evaluate
    from repro_torch.imc.faults import REPAIR_SPARE, FaultSpec
    from repro_torch.imc.mapping import fault_cost_factors

    spec = FaultSpec.at_rate(1e-3)
    out = {}
    for kind in ("afmtj", "mtj"):
        nominal = evaluate.evaluate_system(kind, write_percentile=99.0)
        want = PHASE2_FIG4[(kind, "p99 write-verify")]
        for name, r in nominal.items():
            if dataclasses.asdict(r) != dataclasses.asdict(want[name]):
                raise AssertionError(f"{kind} {name}: faults-off Fig. 4 "
                                     f"differs from phase 2's")
        for repair in (None, REPAIR_SPARE):
            rname = "none" if repair is None else repair.name
            y, ovh, stretch = fault_cost_factors(spec, repair)
            res = evaluate.evaluate_system(kind, write_percentile=99.0,
                                           faults=spec, repair=repair)
            for name, r in res.items():
                n = nominal[name]
                if not (math.isclose(r.t_imc, n.t_imc * stretch,
                                     rel_tol=FAULT_RTOL)
                        and math.isclose(r.e_imc, n.e_imc * ovh,
                                         rel_tol=FAULT_RTOL)
                        and r.array_yield == y):
                    raise AssertionError(f"{kind} {name} {rname}: fault "
                                         f"charging off the factors")
            out[f"{kind} {rname}"] = dict(
                array_yield=y, cell_overhead=ovh, stretch=stretch,
                mac_speedup=res["mac"].speedup,
                mac_speedup_nominal=nominal["mac"].speedup)
            log(f"  evaluate_system {kind} p99 write, rate 1e-3, repair "
                f"{rname}: yield {y:.3e}, cell overhead {ovh:.4f}, stretch "
                f"{stretch:.4g}; mac speedup {nominal['mac'].speedup:.3f}x "
                f"-> {res['mac'].speedup:.4g}x (faults off bit-equal to "
                f"phase 2)")
    return out


def phase8_wer() -> dict:
    """``write_error_rate`` (one B1 launch) and the scan baseline on the
    card at the same point, within ``MC_SIGMAS`` binomial standard errors
    of a difference of the two estimates at the pooled rate (the
    reference's ``tests/test_campaign.py`` bound, restated for 4,096 and
    512 samples)."""
    from repro_torch.core import montecarlo
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    n_k, n_s = 4096, 512
    before = llg_rk4_kernel.launches
    t0 = time.perf_counter()
    w_k = montecarlo.write_error_rate(AFMTJ_PARAMS, 1.0, 250e-12,
                                      n_samples=n_k)
    t_k = time.perf_counter() - t0
    if llg_rk4_kernel.launches != before + 1:
        raise AssertionError("write_error_rate was not one LLG launch")
    t0 = time.perf_counter()
    w_s = montecarlo.write_error_rate_scan(AFMTJ_PARAMS, 1.0, 250e-12,
                                           n_samples=n_s)
    t_s = time.perf_counter() - t0
    pooled = (w_k * n_k + w_s * n_s) / (n_k + n_s)
    bound = MC_SIGMAS * math.sqrt(pooled * (1 - pooled) * (1 / n_k + 1 / n_s))
    log(f"  write_error_rate afmtj 1 V 250 ps: {w_k:.5f} ({n_k} samples, 1 "
        f"launch, {t_k:.2f} s); scan baseline {w_s:.5f} ({n_s} samples, "
        f"plain PyTorch on the card, {t_s:.2f} s); |d| {abs(w_k - w_s):.5f} "
        f"<= {bound:.5f}")
    if not abs(w_k - w_s) <= bound:
        raise AssertionError(f"WER {w_k} vs scan {w_s}: outside {bound}")
    return dict(wer=w_k, wer_scan=w_s, bound=bound, wall_s=t_k,
                scan_wall_s=t_s)


def phase8_writes() -> dict:
    """``program_bits`` on a seeded 256 x 256 target, ``write_surface`` for
    both kinds on ``examples/write_path_study.py``'s grid, and
    ``write_energy_accuracy_surface`` for qwen2-0.5b at its published
    decode widths (896 -> 4,864, batch 8)."""
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.imc import mapping, write_path
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel

    out = {}
    target = np.random.default_rng(8).integers(0, 2, (256, 256))
    res, err = write_path.program_bits(target, "afmtj")
    flipped = int(target.sum())
    log(f"  program_bits afmtj 256 x 256: {flipped} flipped cells, "
        f"{res.rounds} rounds, attempts {res.attempts_mean:.4f}, residual "
        f"errors {int(err.sum())}")
    if res.attempts.size != flipped or int(err.sum()) != int(
            (~res.success).sum()) or err[target == 0].any():
        raise AssertionError("program_bits: error map off the write result")
    out["program_bits"] = dict(flipped=flipped, rounds=res.rounds,
                               attempts_mean=res.attempts_mean,
                               errors=int(err.sum()))
    grid = dict(afmtj=(300.0, 375.0), mtj=(300.0,))
    for kind, temps in grid.items():
        surf = write_path.write_surface(
            kind, voltages=(0.8, 1.0, 1.2), temperatures=temps, n_cells=128,
            policy=write_path.WritePolicy(v_write=1.0, max_attempts=6))
        for ti, temp in enumerate(temps):
            log(f"  write_surface {kind} {temp:.0f} K (pulse "
                f"{surf.pulses[0] * 1e12:.0f} ps), V 0.8 / 1.0 / 1.2: "
                f"attempts {surf.attempts_mean[ti, :, 0].round(3).tolist()}, "
                f"residual BER {surf.residual_ber[ti, :, 0].tolist()}")
        if not ((surf.residual_ber >= 0) & (surf.residual_ber <= 1)).all() \
                or surf.residual_ber.shape != (len(temps), 3, 1):
            raise AssertionError(f"{kind}: write surface {surf}")
        out[f"write_surface {kind}"] = dict(
            attempts=surf.attempts_mean[..., 0].tolist(),
            residual_ber=surf.residual_ber[..., 0].tolist())
    b3 = bitline_mac_kernel.launches
    pts = mapping.write_energy_accuracy_surface(
        get_arch("qwen2-0.5b"), kind="afmtj", wer_targets=WER_TARGETS,
        policy=write_path.WritePolicy(v_write=1.0, pulse_margin=0.9),
        cap_k=896, cap_n=4864, batch=8)
    if bitline_mac_kernel.launches - b3 != len(WER_TARGETS):
        raise AssertionError("write_energy_accuracy_surface did not launch "
                             "the bit-line MAC kernel once per target")
    loose_first = [pts[t] for t in sorted(pts, reverse=True)]
    for pt in loose_first:
        log(f"    WER target {pt.wer_target:.0e}: budget "
            f"{pt.attempts_budget}, write BER {pt.write_ber:.3e}, "
            f"{pt.e_write_bit * 1e15:.2f} fJ/bit, nmse "
            f"{pt.report.nmse:.4e}, cosine {pt.report.cosine:.6f}")
    for a, b in zip(loose_first, loose_first[1:]):
        if not (a.report.nmse >= b.report.nmse
                and b.e_write_bit >= a.e_write_bit):
            raise AssertionError("the write/accuracy surface is not "
                                 "monotone in the WER target")
    out["write_accuracy"] = [dict(
        target=pt.wer_target, budget=pt.attempts_budget,
        write_ber=pt.write_ber, e_write_bit=pt.e_write_bit,
        nmse=pt.report.nmse, cosine=pt.report.cosine) for pt in loose_first]
    return out


def hold_serve_contract(stats: dict) -> None:
    """The serve contract of ``tests/test_system.py`` for 5 requests
    through 2 slots at max_new 4."""
    ok = (stats["served"] == 5 and stats["prefill_tokens"] == 5
          and stats["decode_tokens"] == 15 and stats["prefills"] >= 3
          and [len(c) for c in stats["completions"]] == [4] * 5)
    for tech in ("afmtj", "mtj", "cpu"):
        r = stats["device"][tech]
        ok = ok and r["sim_time_s"] > 0 and r["energy_j"] > 0 and \
            r["ttft_p99_s"] >= r["ttft_p50_s"] > 0
    if not ok:
        raise AssertionError(f"serve contract: {stats}")


def serve_extra(torch, cfg, batch: int, rng, device) -> dict:
    """The frontend inputs of ``cfg`` for ``batch`` sequences (encoder
    frames or vision patches, unit normals from ``rng``), as the engine
    draws them; {} for text-only archs."""
    import numpy as np

    if not cfg.frontend_positions:
        return {}
    key = "encoder_frames" if cfg.n_encoder_layers else "frontend_embeds"
    return {key: torch.from_numpy(rng.standard_normal(
        (batch, cfg.frontend_positions, cfg.d_model)).astype(np.float32)).to(
            device)}


def decode_vs_forward(torch, params, cfg, S: int = 16) -> float:
    """Max |d| between prefill(S) + one decode step and prefill(S + 1)'s last
    position, B = 2, held to ``DECODE_BOUND`` absolute + relative."""
    import numpy as np

    from repro_torch.models import model as M

    rng = np.random.default_rng(7)
    dev = params["embed"].device
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S + 1))).to(dev)
    extra = serve_extra(torch, cfg, 2, rng, dev)
    max_seq = S + 4 + (cfg.frontend_positions if "frontend_embeds" in extra
                       else 0)
    with torch.no_grad():
        _, cache = M.serve_prefill(params, cfg, dict(extra, tokens=toks[:, :S]),
                                   max_seq=max_seq)
        dec, _ = M.serve_step(params, cfg, cache, toks[:, S:S + 1])
        full, _ = M.serve_prefill(params, cfg, dict(extra, tokens=toks),
                                  max_seq=max_seq)
    gap = (dec[:, 0] - full[:, -1]).abs()
    if not bool((gap <= DECODE_BOUND + DECODE_BOUND
                 * full[:, -1].abs()).all()):
        raise AssertionError(f"{cfg.name}: decode vs forward "
                             f"{gap.max().item()}")
    return gap.max().item()


def depth_cut(params, cfg, n_repeats: int):
    """(params, cfg) of the first ``n_repeats`` pattern repeats and as many
    encoder layers, at full width (views of the stacked tensors)."""
    def head(tree, n):
        return (tree[:n] if not isinstance(tree, dict)
                else {k: head(v, n) for k, v in tree.items()})

    n_enc = min(cfg.n_encoder_layers, n_repeats)
    cut = dataclasses.replace(cfg, n_layers=n_repeats * len(cfg.pattern),
                              n_encoder_layers=n_enc)
    out = dict(params, blocks=head(params["blocks"], n_repeats))
    if n_enc:
        out["encoder"] = dict(params["encoder"],
                              blocks=head(params["encoder"]["blocks"], n_enc))
    return out, cut


def serve_full_width(torch, arch: str, cut_repeats=None) -> dict:
    """``arch`` at full width in float32 through the serving loop
    (``launch.serve.serve`` with ``ServeEngine``): 5 requests, 2 slots,
    prompt 16, max_new 4.  Holds the serve contract, AFMTJ ahead of MTJ at
    p99 TPOT where the arch keeps a KV cache, decode == forward, and the
    first prefill's logits against the same parameters on the CPU (cut to
    ``cut_repeats`` pattern repeats and encoder layers, if given, on both
    sides)."""
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.imc.cost_model import per_token_counts
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_arch(arch), compute_dtype="float32")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, 16, 4, 2, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    first = {}
    prefill = engine.prefill

    def keep_first(histories, frontends):
        out = prefill(histories, frontends)
        if not first:
            first.update(histories=[np.array(h) for h in histories],
                         frontends=list(frontends),
                         logits=engine.last_logits.clone())
        return out

    engine.prefill = keep_first
    stats = serve(cfg, engine, 5, 2, 16, 4, log=lambda m: log("  " + m))
    wall = stats["elapsed_s"]
    dev = stats["device"]
    log(f"  serving {arch} full width on the card: {wall:.3f} s for "
        f"{stats['generated_tokens']} tokens "
        f"({stats['generated_tokens'] / wall:.1f} tokens/s; parameters "
        f"{t_init:.2f} s); completions {stats['completions']}")
    hold_serve_contract(stats)
    has_kv = per_token_counts(cfg).kv_elems > 0
    log(f"  p99 TPOT afmtj {dev['afmtj']['tpot_p99_s']:.4e} s, mtj "
        f"{dev['mtj']['tpot_p99_s']:.4e} s (simulated clocks"
        f"{'' if has_kv else '; no KV cache'})")
    if has_kv and not dev["afmtj"]["tpot_p99_s"] < dev["mtj"]["tpot_p99_s"]:
        raise AssertionError("AFMTJ does not beat MTJ at p99 TPOT")

    decode_gap = decode_vs_forward(torch, engine.params, cfg)
    params, ccfg = engine.params, cfg
    card = first["logits"]
    if cut_repeats:
        params, ccfg = depth_cut(params, cfg, cut_repeats)
        with torch.no_grad():
            card, _ = M.serve_prefill(params, ccfg, engine.batch_inputs(
                first["histories"], first["frontends"]), engine.max_seq)
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_logits, _ = M.serve_prefill(
            M.params_to(params, "cpu"), ccfg, engine.batch_inputs(
                first["histories"], first["frontends"], "cpu"),
            max_seq=engine.max_seq)
    t_cpu = time.perf_counter() - t0
    cpu_gap = (card.cpu() - cpu_logits).abs().max().item()
    depth = (f"{ccfg.n_layers} layers" + (f" + {ccfg.n_encoder_layers} "
                                          f"encoder" if ccfg.n_encoder_layers
                                          else ""))
    log(f"  decode vs forward at full width: max |d| {decode_gap:.3e} "
        f"(bound {DECODE_BOUND} abs + rel); first prefill card vs CPU "
        f"({depth}, {t_cpu:.1f} s on the CPU): max |d| {cpu_gap:.3e} (bound "
        f"{SERVE_CPU_ATOL})")
    if not cpu_gap <= SERVE_CPU_ATOL:
        raise AssertionError(f"prefill card vs CPU: {cpu_gap}")
    return dict(wall_s=wall, tokens=stats["generated_tokens"],
                tokens_per_s=stats["generated_tokens"] / wall,
                init_s=t_init, decode_gap=decode_gap, cpu_gap=cpu_gap,
                cpu_check_layers=ccfg.n_layers,
                tpot_p99={t: dev[t]["tpot_p99_s"] for t in dev},
                ttft_p99={t: dev[t]["ttft_p99_s"] for t in dev},
                prefills=stats["prefills"])


def phase8_twins() -> dict:
    """The three twins of this slice in their ``--quick`` form."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_fault_study
    import torch_serving_study
    import torch_write_path_study

    out = {}
    for mod in (torch_write_path_study, torch_fault_study,
                torch_serving_study):
        t0 = time.perf_counter()
        res = mod.run(quick=True)
        wall = time.perf_counter() - t0
        for line in mod.report(res):
            log("    " + line)
        log(f"  {mod.__name__}.run(quick=True): {wall:.2f} s")
        out[mod.__name__] = dict(wall_s=wall)
    return out


def phase8_path(torch, rec) -> dict:
    """The slice's path through its entry points (the LLG and bit-line MAC
    kernels' counters set to 0 just before and read just after), the LLG
    launches recorded by family."""
    from repro_torch.circuit import subarray
    from repro_torch.imc import write_margin, write_path
    from repro_torch.kernels import analog_mac, llg_rk4
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel

    log("phase 8: the write-path and fault-cost remainder, and serving, at "
        "full size")
    for f in (write_margin.wer_margined_pulse,
              write_path.measured_write_timings, write_path.nominal_pulse,
              subarray._characterize_write):
        f.cache_clear()
    llg_rk4.reset_counts()
    analog_mac.reset_counts(bitline_mac_kernel)
    walls = {}
    out = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        walls[name] = time.perf_counter() - t
        return r

    out["fault_costs"] = timed("fault costs", phase8_fault_costs)
    rec.tag = "WER point"
    out["wer"] = timed("write_error_rate + scan", phase8_wer)
    rec.tag = "writes"
    out["writes"] = timed("program_bits + write_surface + write/accuracy",
                          phase8_writes)
    rec.tag = None
    # qwen2-0.5b (24 layers, d 896, vocab 151,936); the CPU check at full
    # depth
    out["serving"] = timed("serving", lambda: serve_full_width(
        torch, "qwen2-0.5b"))
    out["twins"] = timed("twins", phase8_twins)
    launches = llg_rk4.llg_rk4_kernel.launches
    b3 = bitline_mac_kernel.launches
    for name, sec in walls.items():
        log(f"  {name}: {sec:.2f} s")
    log(f"  phase 8 path: {sum(walls.values()):.1f} s; LLG launches "
        f"{launches}, bit-line MAC launches {b3} "
        f"({bitline_mac_kernel.reduce_launches} reduce passes)")
    if launches <= 0 or b3 <= 0:
        raise AssertionError("phase 8 never launched the LLG or the bit-line "
                             "MAC kernel")
    return dict(out, walls=walls, launches=launches, bitline_launches=b3)


def phase8_launches(rec) -> list:
    """(kind, what, recorded launch, plain steps) of every new launch
    family: the WER point, the first program_bits round, the AFMTJ
    write_surface's first rounds at 375 K and 0.8 / 1.2 V, and (the MTJ's
    plain-held family) its first round at 0.8 V."""
    def first_round(volt, pick):
        for r in rec.launches["writes"]:
            v = float(r["state"][6, 0].item())
            if abs(v - volt) < 1e-6 and pick(r):
                return r
        raise AssertionError(f"no write_surface round at {volt} V")

    writes = rec.launches["writes"]
    sig = {id(r): float(r["kw"]["thermal_sigma"].max().item())
           for r in writes}
    afmtj = [r for r in writes if r["p"].n_sublattices == 2]
    hot = max(sig[id(r)] for r in afmtj if r["state"].shape[1] <= 512)
    prog = max(afmtj, key=lambda r: r["state"].shape[1])
    fams = [("afmtj", "WER point", rec.launches["WER point"][0], 0),
            ("afmtj", "program_bits round 1", prog, PHASE8_TRUNC_STEPS)]
    for volt in (0.8, 1.2):
        fams.append(("afmtj", f"write_surface 375 K {volt} V round 1",
                     first_round(volt, lambda r: r["p"].n_sublattices == 2
                                 and sig[id(r)] == hot), 0))
    fams.append(("mtj", "write_surface 300 K 0.8 V round 1",
                 first_round(0.8, lambda r: r["p"].n_sublattices == 1),
                 PHASE8_TRUNC_STEPS))
    return fams


def phase8(torch, dev, census) -> dict:
    """Phase 8: the slice's path (``phase8_path``) with a launch recorder
    on the campaign engine's kernel entry, then every new LLG launch
    family held bit-identical to C1T1 over its whole horizon in every
    layout (two of them, one per device kind, also against the plain
    version over their first ``PHASE8_TRUNC_STEPS`` steps), the rule's
    layout no slower than C1T1."""
    from repro_torch.campaign import engine

    t0 = time.perf_counter()
    cache = ROOT / "build" / "smoke-campaign-cache"
    shutil.rmtree(cache, ignore_errors=True)
    rec = LaunchRecorder(engine.llg_rk4_kernel)
    engine.llg_rk4_kernel = rec
    try:
        path = phase8_path(torch, rec)
    finally:
        engine.llg_rk4_kernel = rec.kernel
    shutil.rmtree(cache, ignore_errors=True)
    log("phase 8 holds: every new LLG launch family")
    shapes = [hold_long(kind, what, launch, census, trunc)
              for kind, what, launch, trunc in phase8_launches(rec)]
    require_no_slower(shapes)
    log("  phase 8 launches (lanes x steps; horizon): layout, C1T1 ms, rule "
        "ms, bound ms, issue floor ms (rule), plain ms (first steps)")
    for x in shapes:
        plain = (f"{x['plain_ms']:.0f} ({x['plain_steps']})"
                 if x["plain_ms"] is not None else "-")
        log(f"    {x['kind']} {x['what']} ({x['lanes']} x {x['steps']}; "
            f"{x['horizon']}): {x['layout']}, {x['ms_c1t1']:.3f}, "
            f"{x['ms']:.3f}, {x['bound_ms']:.4f} ({x['bound_unit']}), "
            f"{x['issue_floor_ms']:.4f}, {plain}")
    total = time.perf_counter() - t0
    log(f"  phase 8 total: {total:.1f} s")
    return dict(path, shapes=shapes, total_s=total)


# --- phase 9: the other model families ---------------------------------------

# the new analog launch shapes, M = 128 (batch 2 x seq 64): olmoe-1b-7b's
# attention projections and unembed, mamba2-780m's tied unembed
FAMILY_SHAPES = [(2048, 2048, "olmoe wq/wk/wv/wo"),
                 (2048, 50304, "olmoe unembed"),
                 (1536, 50280, "mamba2 unembed (embed.T)")]
# linears through the analog MVM per forward: the reference routes only
# ``models.common.linear`` sites, so MoE routers and experts and the Mamba
# projections stay exact (16 x 4 attention projections + the unembed; the
# tied unembed alone)
FAMILY_LINEARS = {"olmoe-1b-7b": 16 * 4 + 1, "mamba2-780m": 1}
SERVE_FAMILIES = ("olmoe-1b-7b", "mamba2-780m", "seamless-m4t-large-v2",
                  "qwen2-vl-2b")
# 398e9 parameters each: not on one card (ROADMAP A12); smoke configs
SMOKE_FAMILIES = ("jamba-1.5-large-398b", "llama4-maverick-400b-a17b")
# pattern repeats (and encoder layers) of the CPU check's depth-cut copy
CUT_REPEATS = 2


def phase9_hold(torch, dev) -> list:
    log("phase 9a: analog kernels vs plain versions at the new families' "
        "launch shapes (timed)")
    t0 = time.perf_counter()
    shapes = [hold_analog_at_shape(torch, dev, QWEN_M, k, n, what,
                                   timed=True)
              for k, n, what in FAMILY_SHAPES]
    log(f"  phase 9a: {time.perf_counter() - t0:.1f} s")
    return shapes


def smoke_family(torch, dev, arch: str) -> dict:
    """``arch``'s smoke config on the card (random weights, seed 0):
    decode == forward, then a prefill of 2 x 16 tokens and 3 greedy decode
    steps, every logit finite."""
    import numpy as np

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.engine import init_serve_params
    from repro_torch.models import model as M

    cfg = smoke_config(arch)
    params = init_serve_params(cfg, 0, dev)
    gap = decode_vs_forward(torch, params, cfg)
    rng = np.random.default_rng(11)
    extra = serve_extra(torch, cfg, 2, rng, dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(dev)
    with torch.no_grad():
        logits, cache = M.serve_prefill(params, cfg, dict(extra, tokens=toks),
                                        max_seq=16 + cfg.frontend_positions
                                        + 8)
        finite = bool(torch.isfinite(logits).all())
        for _ in range(3):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = M.serve_step(params, cfg, cache, tok)
            finite = finite and bool(torch.isfinite(logits).all())
    log(f"  {arch} (smoke config, {M.n_params(params):,} parameters) on the "
        f"card: prefill + 3 decode steps finite {finite}, position "
        f"{cache['pos']}; decode vs forward max |d| {gap:.3e}")
    if not finite:
        raise AssertionError(f"{arch}: non-finite logits")
    return dict(decode_gap=gap, pos=cache["pos"])


def phase9(torch, dev, shapes: list) -> dict:
    """Phase 9: the analog accuracy path on olmoe-1b-7b and mamba2-780m at
    full width (``analog_path``: counters set to 0 before and read after
    each arch), then serving olmoe, mamba2, seamless and qwen2-vl at full
    width and jamba / llama4 at their smoke configs; each model freed
    before the next."""
    t0 = time.perf_counter()
    paths, serving, walls = {}, {}, {}
    for arch, linears in FAMILY_LINEARS.items():
        log(f"phase 9b: {arch} at full width (random weights from seed 0), "
            f"batch 2 x seq 64, {linears} linears per forward through the "
            f"analog MVM")
        t = time.perf_counter()
        path = analog_path(torch, dev, arch, linears)
        walls[f"analog {arch}"] = time.perf_counter() - t
        path["per_forward"] = per_forward(shapes, path)
        log_per_forward(path["per_forward"], "9b")
        paths[arch] = path
        torch.cuda.empty_cache()
    for arch in SERVE_FAMILIES:
        log(f"phase 9c: serving {arch} at full width (float32)")
        t = time.perf_counter()
        serving[arch] = serve_full_width(torch, arch, CUT_REPEATS)
        walls[f"serve {arch}"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    for arch in SMOKE_FAMILIES:
        t = time.perf_counter()
        serving[arch] = smoke_family(torch, dev, arch)
        walls[f"smoke {arch}"] = time.perf_counter() - t
    total = time.perf_counter() - t0
    for name, sec in walls.items():
        log(f"  phase 9 {name}: {sec:.2f} s")
    log(f"  phase 9 (b + c) total: {total:.1f} s")
    return dict(paths=paths, serving=serving, walls=walls, total_s=total)


# --- phase 10: training -----------------------------------------------------

# train_4k's 4,096-token sequence with the global batch cut from 256 to 4 to
# fit one card, in TRAIN_MICROBATCHES["qwen2-0.5b"] = 2 microbatches of 2
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
# examples/train_lm.py's rate: 8 steps of 1e-3 at 24 layers moved the
# loss ~0.25 nats on the CPU at width 256, 3e-3 ~1.1, against ~0.05 of
# batch-to-batch noise
TRAIN_LR = 3e-3
# the step counter starts past wsd_schedule's 100-step warmup (the learning
# rate is 0 at step 0) and far from its decay: lr = TRAIN_LR at every step
TRAIN_STEP0 = 100
TRAIN_TOTAL = 10000
TRAIN_STEPS = 8
# card against CPU on the depth-cut copy (float32 compute, TF32 off), one
# step from shared parameters at step TRAIN_STEP0: loss, gradient norm, the
# moments (max |d| over the leaf's largest |value|), and the updated
# parameters.  AdamW's first step from zero moments moves an element by
# ~0.45 lr x sign(g): an element whose gradient is within rounding of 0 may
# step the other way (|d| ~ 0.9 lr, "flipped"), and where |g| is near eps
# the step follows g's rounding.  So the parameters are held by shares of
# elements: more than 1e-6 relative apart (measured 4.4e-2: a step's
# rounding is 1e-6 of elements much smaller than the step), more than
# 1e-3 lr apart (6.3e-6) and flipped (6.6e-9) (first chip runs of phase 10)
TRAIN_CPU_LOSS_RTOL = 1e-5
TRAIN_CPU_NORM_RTOL = 1e-4
TRAIN_CPU_MOMENT_RTOL = 5e-4
TRAIN_PARAM_SHARE = 0.1
TRAIN_STEP_SHARE = 1e-4
TRAIN_FLIP_SHARE = 1e-6
# phase 10c's checkpoints: 1 layer at full width, the vocabulary cut so
# three saves and two restores move ~0.5 GB each, not 1.8 GB
RESUME_VOCAB = 32768
# the mean of the microbatches' gradients against the whole batch's, over
# each leaf's largest |gradient| (float32, two summation orders)
TRAIN_MICRO_RTOL = 1e-4
# every family's smoke config, card against CPU (float32): the loss
FAMILY_LOSS_RTOL = 1e-4
FAMILY_LOSS_RTOL_JAMBA = 1e-3          # ROADMAP C14


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N per token for the matmuls
    (the tied embedding counts once, as the unembed) plus the attention's
    12 L (heads x head dim) S per token — the whole S x S score matrix,
    as the chunked path computes it."""
    tokens = batch * seq
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * tokens
    return 6.0 * n_params * tokens + attn


def spec_count(cfg) -> int:
    import numpy as np

    from repro_torch._tree import tree_leaves
    from repro_torch.models import model as M

    return sum(int(np.prod(s.shape)) for s in
               tree_leaves(M.param_specs(cfg)))


def phase10_full_width(torch, smi: str) -> dict:
    """qwen2-0.5b at its published config through ``train``: TRAIN_STEPS
    steps from step TRAIN_STEP0 on B TRAIN_BATCH x S TRAIN_SEQ, 2
    microbatches; finite loss and gradient norm at every step, the last
    loss below the first."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import TRAIN_MICROBATCHES, get_arch
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamWConfig

    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("train_4k_b4", "train", TRAIN_SEQ, TRAIN_BATCH,
                        microbatches=TRAIN_MICROBATCHES[TRAIN_ARCH])
    ckpt = ROOT / "build" / "smoke-train"
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"phase 10a: {TRAIN_ARCH} at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}), float32 parameters "
        f"and AdamW state, {cfg.compute_dtype} compute; {TRAIN_STEPS} steps "
        f"from step {TRAIN_STEP0} of B {TRAIN_BATCH} x S {TRAIN_SEQ} in "
        f"{shape.microbatches} microbatches, lr {TRAIN_LR}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    hist = train(cfg, shape, AdamWConfig(lr=TRAIN_LR),
                 TRAIN_STEP0 + TRAIN_STEPS, ckpt, save_every=10 ** 9,
                 log_every=1, step0=TRAIN_STEP0, total_steps=TRAIN_TOTAL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt, ignore_errors=True)
    if [r.step for r in hist] != list(range(TRAIN_STEP0,
                                            TRAIN_STEP0 + TRAIN_STEPS)):
        raise AssertionError(f"steps {[r.step for r in hist]}")
    for r in hist:
        if not (math.isfinite(r.loss) and math.isfinite(r.grad_norm)):
            raise AssertionError(f"step {r.step}: loss {r.loss}, grad norm "
                                 f"{r.grad_norm}")
        if r.lr != float(torch.tensor(TRAIN_LR, dtype=torch.float32)):
            raise AssertionError(f"step {r.step}: lr {r.lr}")
    if not hist[-1].loss < hist[0].loss:
        raise AssertionError(f"loss did not fall: {hist[0].loss} -> "
                             f"{hist[-1].loss}")
    ms = [r.ms for r in hist[1:]]
    ms_mean = sum(ms) / len(ms)
    n_params = spec_count(cfg)
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(
        arch=TRAIN_ARCH, params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=shape.microbatches, lr=TRAIN_LR,
        steps=[r.step for r in hist], losses=[r.loss for r in hist],
        grad_norms=[r.grad_norm for r in hist],
        ms_per_step=[r.ms for r in hist], first_step_ms=hist[0].ms,
        ms_mean=ms_mean, ms_min=min(ms), ms_max=max(ms),
        tokens_per_s=tokens / (ms_mean / 1e3), model_flops_per_step=flops,
        bf16_peak_share=flops / (ms_mean / 1e3) / PEAK_FLOPS,
        max_memory_allocated=peak, allocated_before=before, wall_s=wall,
        card=smi)
    log(f"  [{smi}] loss {hist[0].loss:.4f} -> {hist[-1].loss:.4f}; grad "
        f"norm {hist[0].grad_norm:.3f} -> {hist[-1].grad_norm:.3f}")
    log(f"  [{smi}] wall per step (host clock, each step ends in a device "
        f"sync): first {hist[0].ms:.1f} ms, then mean {ms_mean:.1f} ms "
        f"(min {min(ms):.1f}, max {max(ms):.1f}) over {len(ms)} steps")
    log(f"  [{smi}] {out['tokens_per_s']:.0f} tokens/s; model FLOPs per step "
        f"{flops:.4e} ({n_params:,} parameters), "
        f"{100 * out['bf16_peak_share']:.2f}% of the H100 SXM data sheet's "
        f"dense bf16 peak (989 TFLOP/s)")
    log(f"  [{smi}] torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB "
        f"({before / 2**30:.3f} GiB of it allocated before the phase); "
        f"phase 10a wall {wall:.1f} s")
    return out


def _leaf_gap(a, b) -> float:
    """max |a - b| over max |a| (0 for an all-zero leaf equal to b)."""
    d = (a.double() - b.double()).abs().max().item()
    m = a.double().abs().max().item()
    return d / m if m > 0 else d


def phase10_card_vs_cpu(torch, dev) -> dict:
    """One train step of the depth-cut copy (1 repeat, full width and
    vocabulary, float32 compute) on the card and on the CPU from the same
    parameters at step TRAIN_STEP0 (lr > 0); then on the card the mean of
    two microbatches' gradients against the whole batch's."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import batch_at
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import data_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    full = dataclasses.replace(get_arch(TRAIN_ARCH), compute_dtype="float32")
    params, cfg = depth_cut(
        M.init_params(full, torch.Generator(dev).manual_seed(0), dev), full,
        1)
    params = M.params_to(params, dev)
    shape = ShapeConfig("cut", "train", 64, 2, microbatches=2)
    batch = batch_at(data_config(cfg, shape), 0)
    step = ST.make_train_step(cfg, shape, AdamWConfig(lr=TRAIN_LR),
                              total_steps=TRAIN_TOTAL)
    out = {}
    for where in ("cpu", dev):
        p = M.params_to(params, where)
        m, v = adamw_init(p)
        b = {k: torch.from_numpy(a).to(where) for k, a in batch.items()}
        p, m, v, _, met = step(p, m, v, TRAIN_STEP0, b)
        out[str(where)] = (M.params_to(p, "cpu"), M.params_to(m, "cpu"),
                           M.params_to(v, "cpu"),
                           {k: float(x) for k, x in met.items()})
    (pc, mc, vc, metc), (pd, md, vd, metd) = out["cpu"], out[str(dev)]
    loss_gap = abs(metd["loss"] - metc["loss"]) / abs(metc["loss"])
    norm_gap = abs(metd["grad_norm"] - metc["grad_norm"]) / metc["grad_norm"]
    moment_gap = max(_leaf_gap(a, b) for a, b in zip(
        tree_leaves(mc) + tree_leaves(vc), tree_leaves(md) + tree_leaves(vd)))
    off = n = flips = 0
    step_shares = {f: 0 for f in (1e-5, 1e-4, 1e-3, 1e-2)}
    for a, b in zip(tree_leaves(pc), tree_leaves(pd)):
        d = (a - b).abs()
        off += int((d > 1e-6 * a.abs()).sum())
        flips += int((d > 0.1 * TRAIN_LR).sum())
        for f in step_shares:
            step_shares[f] += int((d > f * TRAIN_LR).sum())
        n += a.numel()
    log(f"  parameters |d| over lr: share above " + ", ".join(
        f"{f:g}: {c / n:.2e}" for f, c in step_shares.items()))
    log(f"phase 10b: card vs CPU, one step of the depth-cut copy (1 layer, "
        f"full width and vocabulary, float32 compute, B 2 x S 64, 2 "
        f"microbatches, step {TRAIN_STEP0}, lr {metc['lr']:.3g}): loss "
        f"{metc['loss']:.6f} / {metd['loss']:.6f} (rel {loss_gap:.2e}), "
        f"grad norm {metc['grad_norm']:.6f} / {metd['grad_norm']:.6f} (rel "
        f"{norm_gap:.2e}); moments max |d| {moment_gap:.2e} of the leaf's "
        f"max; parameters {off} of {n} elements more than 1e-6 relative "
        f"apart ({off / n:.2e}), {flips} more than 0.1 lr")
    if not (loss_gap <= TRAIN_CPU_LOSS_RTOL and norm_gap <= TRAIN_CPU_NORM_RTOL
            and moment_gap <= TRAIN_CPU_MOMENT_RTOL
            and off <= TRAIN_PARAM_SHARE * n
            and step_shares[1e-3] <= TRAIN_STEP_SHARE * n
            and flips <= TRAIN_FLIP_SHARE * n and metc["lr"] > 0):
        raise AssertionError("card and CPU train steps disagree")

    whole = {k: torch.from_numpy(a).reshape(1, 2, *a.shape[2:]).to(dev)
             for k, a in batch.items()}
    split = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
    l1, g1 = ST.make_grad_step(cfg, ShapeConfig("w", "train", 64, 2))(
        params, whole)
    l2, g2 = ST.make_grad_step(cfg, shape)(params, split)
    micro_gap = max(_leaf_gap(a, b) for a, b in zip(tree_leaves(g1),
                                                    tree_leaves(g2)))
    micro_loss = abs(l2.item() - l1.item()) / abs(l1.item())
    log(f"  microbatches: mean of 2 microbatch gradients vs the whole "
        f"batch's, max |d| {micro_gap:.2e} of the leaf's max; loss rel "
        f"{micro_loss:.2e}")
    if not (micro_gap <= TRAIN_MICRO_RTOL
            and micro_loss <= TRAIN_CPU_LOSS_RTOL):
        raise AssertionError("microbatch gradients differ from the whole "
                             "batch's")
    del params, out, g1, g2
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_gap, grad_norm_rel=norm_gap,
                moment_gap=moment_gap, params_off=off, params_n=n,
                params_flipped=flips,
                step_shares={str(f): c / n for f, c in step_shares.items()},
                micro_gap=micro_gap,
                micro_loss_rel=micro_loss, loss=metd["loss"],
                wall_s=time.perf_counter() - t0)


def phase10_resume(torch) -> dict:
    """``train`` on the card, 1 layer at full width (vocabulary
    RESUME_VOCAB): 4 steps from step TRAIN_STEP0 saved every 2, against 2
    steps, a stop, and a fresh call resuming from the checkpoint at step
    TRAIN_STEP0 + 2; the final checkpoints (parameters, moments, step)
    equal bit for bit, under ``torch.use_deterministic_algorithms``."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=1,
                              vocab=RESUME_VOCAB)
    shape = ShapeConfig("resume", "train", 64, 2, microbatches=2)
    root = ROOT / "build" / "smoke-train-resume"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(save_every=2, log_every=1, step0=TRAIN_STEP0,
              total_steps=TRAIN_TOTAL)
    end = TRAIN_STEP0 + 4
    log(f"phase 10c: resume on the card ({cfg.name} cut to 1 layer and "
        f"vocabulary {cfg.vocab}, {cfg.compute_dtype} compute, B 2 x S 64, "
        f"2 microbatches, deterministic algorithms)")
    torch.use_deterministic_algorithms(True)
    try:
        train(cfg, shape, AdamWConfig(lr=TRAIN_LR), end, root / "a", **kw)
        train(cfg, shape, AdamWConfig(lr=TRAIN_LR), end - 2, root / "b",
              **kw)
        hist = train(cfg, shape, AdamWConfig(lr=TRAIN_LR), end, root / "b",
                     **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    if [r.step for r in hist] != [end - 2, end - 1]:
        raise AssertionError(f"the resumed run logged {hist}")
    like_params = tree_map(lambda s: torch.empty(0), M.param_specs(cfg))
    like = {"params": like_params, "m": like_params, "v": like_params,
            "step": torch.empty(0)}
    a = Checkpointer(root / "a" / cfg.name).restore(end, like)
    b = Checkpointer(root / "b" / cfg.name).restore(end, like)
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    unequal = sum(not torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))
    gap = max((x.double() - y.double()).abs().max().item()
              for x, y in zip(leaves_a, leaves_b))
    shutil.rmtree(root, ignore_errors=True)
    log(f"  resumed at step {end - 2}, finished at {end}: {unequal} of "
        f"{len(leaves_a)} leaves differ (max |d| {gap:.3e}); step "
        f"{int(b['step'])}")
    if unequal or int(b["step"]) != end:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    torch.cuda.empty_cache()
    return dict(leaves=len(leaves_a), unequal=unequal, max_abs_diff=gap,
                wall_s=time.perf_counter() - t0)


def phase10_families(torch, dev) -> dict:
    """One train step of every arch's smoke config (float32) on the card
    and on the CPU from the same parameters: losses within
    FAMILY_LOSS_RTOL (jamba FAMILY_LOSS_RTOL_JAMBA), every gradient on the
    card finite."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.data import batch_at
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import data_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    shape = ShapeConfig("smoke", "train", 32, 4, microbatches=2)
    out = {}
    for arch in sorted(ARCHS):
        cfg = smoke_config(arch)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = batch_at(data_config(cfg, shape), 0)
        step = ST.make_train_step(cfg, shape, AdamWConfig(lr=TRAIN_LR),
                                  total_steps=TRAIN_TOTAL)
        res = {}
        for where in ("cpu", dev):
            p = M.params_to(params, where)
            m, v = adamw_init(p)
            b = {k: torch.from_numpy(a).to(where) for k, a in batch.items()}
            *_, met = step(p, m, v, TRAIN_STEP0, b)
            res[str(where)] = {k: float(x) for k, x in met.items()}
        b = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
        _, grads = ST.make_grad_step(cfg, shape)(M.params_to(params, dev), b)
        finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        c, d = res["cpu"], res[str(dev)]
        gap = abs(d["loss"] - c["loss"]) / abs(c["loss"])
        bound = (FAMILY_LOSS_RTOL_JAMBA if arch.startswith("jamba")
                 else FAMILY_LOSS_RTOL)
        log(f"phase 10d: {arch} (smoke config): loss {c['loss']:.6f} / "
            f"{d['loss']:.6f} (rel {gap:.2e}, bound {bound:g}), grad norm "
            f"{c['grad_norm']:.5f} / {d['grad_norm']:.5f}; every gradient on "
            f"the card finite: {finite}")
        if gap > bound or not finite:
            raise AssertionError(f"{arch}: card vs CPU train step")
        out[arch] = dict(loss_rel=gap, loss=d["loss"],
                         grad_norm_cpu=c["grad_norm"],
                         grad_norm_card=d["grad_norm"])
    return dict(archs=out, wall_s=time.perf_counter() - t0)


# --- phase 11: campaign scale-out -------------------------------------------

# the reference's own output of examples/array_mc_sim.py and
# examples/analog_accuracy.py (src/repro, CPU), unrounded, as
# tools/ref_study_numbers.py --only array_mc analog_accuracy prints it; the
# array study adds the switched cells' latency std, which the holds use
REF_ARRAY_MC = {
    'rows': 64, 'cols': 64, 'n_steps': 4100, 'switched': 1.0,
    'n_switched': 4096, 'mean': 1.425544677734375e-10,
    'std': 3.4715942501893996e-11, 'p50': 1.3785e-10,
    'p99': 2.3950500000000004e-10, 'max': 2.9320000000000003e-10,
    'wer': [0.00634765625, 0.0, 0.0, 0.0], 'v_worst': 0.852343738079071,
    'pulse': 2.5e-10}
REF_ANALOG_ACCURACY = {
    'gemma2-2b': {'surface': {
        '4/0.8': [0.2207807281853262, 0.22650540043357084, 0.9045242846231297],
        '4/5.0': [0.039165034063987914, 0.040180552879649514, 0.9805308339807208],
        '6/0.8': [0.1889375147588793, 0.19383651729538945, 0.9160743352048869],
        '6/5.0': [0.012535925556589165, 0.01286097233820693, 0.9936299399412404],
        '8/0.8': [0.18721309909181127, 0.19206738887374886, 0.91714469994039],
        '8/5.0': [0.011139046109828282, 0.011427872895847957, 0.9943446505089018]},
        'bnn': [0.5504346564734367, 0.5647069982139736, 0.6601307770078042]},
    'qwen3-8b': {'surface': {
        '4/0.8': [0.28347536491710706, 0.27048414558560036, 0.886178785541028],
        '4/5.0': [0.04307607177802106, 0.04110196479848992, 0.9800276094756395],
        '6/0.8': [0.2523877447666898, 0.2408212209884871, 0.897457936999894],
        '6/5.0': [0.01616413439809475, 0.0154233581569882, 0.9923324295237143],
        '8/0.8': [0.2512759499597148, 0.2397603779465562, 0.8974794266805413],
        '8/5.0': [0.014713724846502473, 0.01403941853872067, 0.993007215164935]},
        'bnn': [0.6247110805077595, 0.5960815780179327, 0.6355650877850791]},
    'mamba2-780m': {'surface': {
        '4/0.8': [0.24985458339357108, 0.2346636529285762, 0.8986070347688979],
        '4/5.0': [0.042175560735494666, 0.039611325163934785, 0.9804593078732323],
        '6/0.8': [0.222162855472474, 0.20865555677277, 0.9078665092192832],
        '6/5.0': [0.014669264522476617, 0.013777386637720981, 0.99312756488043],
        '8/0.8': [0.2201971543613991, 0.20680936849387024, 0.9085252701443736],
        '8/5.0': [0.013429615398638416, 0.012613107048375387, 0.9936992109846798]},
        'bnn': [0.638081299534843, 0.5992865393163407, 0.6335248593268462]}}
# the relative standard deviation of the analog twin's nmse and cosine over
# projection draws (tools/analog_draw_spread.py, 12 draws, CPU; every arch
# draws the same 384 x 256 shape): the twin's torch draws and the
# reference's jax.random draws are two samples, so the twin is held within
# MC_SIGMAS x sqrt(2) x this of the reference's output (ROADMAP C18)
ANALOG_SPREAD = {'4/0.8': (0.0782, 0.007831), '4/5.0': (0.0478, 0.000902),
                 '6/0.8': (0.0698, 0.00663), '6/5.0': (0.0752, 0.000565),
                 '8/0.8': (0.0691, 0.00652), '8/5.0': (0.0788, 0.000543),
                 'bnn': (0.0342, 0.025416)}
# the analog twin on the card against the same twin's plain versions on the
# CPU, on the same draws: nmse and cosine within 1% (the ADC'd outputs may
# differ by 1 LSB on under 1% of elements, phase 5)
ANALOG_CARD_CPU_RTOL = 0.01
STREAM_BINS = (4096, 512)
DEVICE_PLAN_COUNTS = (3, 5, 6)
# a child process may take this long to import torch, reach the card and
# finish its part
CHILD_TIMEOUT_S = 300
# phase 3's dense result, kept for phase 11 (filled by phase3)
PHASE3_DENSE = {}
# the device the child processes of 11c, 11d, 12c and 12d run on
CHILD_DEVICE = "cuda"

CHILD_KILL = """
import os, signal, sys, time
sys.path.insert(0, sys.argv[2])
import torch
from repro_torch.campaign import CampaignGrid, run_campaign
from repro_torch.core.params import AFMTJ_PARAMS

grid = CampaignGrid(voltages=(0.6, 1.2), pulse_widths=(120e-12, 250e-12),
                    temperatures=(300.0, 350.0, 400.0), n_samples=100_000,
                    dt=0.1e-12, seed=0)

def die(i, n):
    if i == 0:
        os.kill(os.getpid(), signal.SIGKILL)

run_campaign(AFMTJ_PARAMS, grid, cache_dir=sys.argv[1],
             max_cells_per_launch=int(sys.argv[3]), on_slice_complete=die,
             device=sys.argv[4])
"""

CHILD_MESH = """
import hashlib, json, os, sys, time
t0 = time.perf_counter()
root, pi, src, per = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
dev = sys.argv[5]
sys.path.insert(0, src)
import numpy as np
import torch
from repro_torch.campaign import CampaignGrid, run_campaign
from repro_torch.core.params import AFMTJ_PARAMS
from repro_torch.launch.mesh import CampaignMesh

torch.zeros(1, device=dev)                     # the CUDA context
if dev == "cuda":
    from repro_torch.kernels import llg_rk4
    llg_rk4._library()                         # the built kernel library
ready = time.perf_counter() - t0
grid = CampaignGrid(voltages=(0.6, 1.2), pulse_widths=(120e-12, 250e-12),
                    temperatures=(300.0, 350.0, 400.0), n_samples=100_000,
                    dt=0.1e-12, seed=0)
open(os.path.join(root, f"ready{pi}"), "w").close()
while not os.path.exists(os.path.join(root, "go")):
    time.sleep(0.005)
t1 = time.perf_counter()
mesh = CampaignMesh(n_devices=1, process_index=pi, process_count=2,
                    claim_ttl_s=120.0, poll_s=0.01)
res = run_campaign(AFMTJ_PARAMS, grid, cache_dir=os.path.join(root, "cache"),
                   max_cells_per_launch=per, mesh=mesh, device=dev)
json.dump({"n_computed": res.n_computed, "n_launches": res.n_launches,
           "n_resumed": res.n_resumed, "from_cache": res.from_cache,
           "ready_s": ready, "run_s": time.perf_counter() - t1,
           "sha": hashlib.sha256(
               np.ascontiguousarray(res.crossing_time).tobytes()).hexdigest()},
          open(os.path.join(root, f"out{pi}.json"), "w"))
"""


def sha256_of(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase11_stream(torch, grid, dense) -> dict:
    """11a: the study grid streamed at ``STREAM_BINS``: the WER surface
    equal to the dense one bit for bit at every bin count, the percentiles
    equal with one bin per step, and with fewer bins than steps within
    ``sketch_tolerance`` and the streamed copy at least 4x below the dense
    one."""
    import numpy as np

    from repro_torch.campaign import run_campaign
    from repro_torch.core.params import AFMTJ_PARAMS

    out = {"dense_host_bytes": dense.host_bytes,
           "dense_wall_s": PHASE3_DENSE.get("wall", dense.elapsed_s)}
    qs = (10.0, 50.0, 90.0, 99.0)
    for n_bins in STREAM_BINS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_campaign(AFMTJ_PARAMS, grid, use_cache=False,
                           reduce="stream", n_bins=n_bins)
        wall = time.perf_counter() - t0
        if not res.reduced or res.crossing_time is not None:
            raise AssertionError("the streamed campaign returned lanes")
        if not np.array_equal(res.wer_surface(), dense.wer_surface()):
            raise AssertionError(f"streamed WER ({n_bins} bins) != dense")
        lp_s, lp_d = res.latency_percentiles(qs), dense.latency_percentiles(qs)
        gap = float(np.nanmax(np.abs(lp_s - lp_d)))
        tol = res.sketch_tolerance
        if n_bins >= grid.n_steps:
            if not np.array_equal(lp_s, lp_d):
                raise AssertionError("per-step-bin percentiles != dense")
        elif not gap <= tol:
            raise AssertionError(f"{n_bins}-bin percentiles {gap:.3e} s from "
                                 f"dense, tolerance {tol:.3e}")
        ratio = dense.host_bytes / res.host_bytes
        if n_bins < grid.n_steps and ratio < 4:
            raise AssertionError(f"streamed copy only {ratio:.2f}x below dense")
        how = ("bit-identical" if n_bins >= grid.n_steps else
               f"within {gap:.3e} s (tolerance {tol:.3e})")
        log(f"  11a stream, {n_bins} bins: {wall:.3f} s wall, host_bytes "
            f"{res.host_bytes} (dense {dense.host_bytes}, {ratio:.1f}x "
            f"less); WER bit-identical, percentiles {how}")
        out[f"bins_{n_bins}"] = dict(wall_s=wall, host_bytes=res.host_bytes,
                                     ratio=ratio, percentile_gap_s=gap,
                                     sketch_tolerance_s=tol)
    return out


def phase11_split_resume(torch, grid, dense) -> dict:
    """11b and 11c: the grid in one-slice launches equal to the single
    launch bit for bit; a child process SIGKILLs itself after launch 0 is
    checkpointed, and this process resumes from the checkpoint."""
    import numpy as np

    from repro_torch.campaign import bucket_cells, run_campaign
    from repro_torch.core.params import AFMTJ_PARAMS

    per = bucket_cells(grid.cells)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = run_campaign(AFMTJ_PARAMS, grid, use_cache=False,
                         max_cells_per_launch=per)
    wall_split = time.perf_counter() - t0
    if split.n_launches != 3 or split.n_computed != 3:
        raise AssertionError(f"split campaign: {split.n_launches} launches")
    if not np.array_equal(split.crossing_time, dense.crossing_time):
        raise AssertionError("the split campaign != the single launch")
    log(f"  11b split into {split.n_launches} launches of {per} lanes: "
        f"{wall_split:.3f} s wall, bit-identical to the single launch; "
        f"host_bytes {split.host_bytes}")
    cache = ROOT / "build" / "smoke-resume-cache"
    shutil.rmtree(cache, ignore_errors=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", CHILD_KILL, str(cache), str(ROOT / "src"),
         str(per), CHILD_DEVICE], capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    wall_child = time.perf_counter() - t0
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"the child was not killed: rc "
                             f"{child.returncode}\n{child.stderr[-2000:]}")
    left = sorted(p.name for p in cache.iterdir())
    t0 = time.perf_counter()
    res = run_campaign(AFMTJ_PARAMS, grid, cache_dir=str(cache),
                       max_cells_per_launch=per)
    wall_resume = time.perf_counter() - t0
    after = sorted(p.name for p in cache.iterdir())
    log(f"  11c child killed in on_slice_complete(0) after {wall_child:.2f} s "
        f"(left {left}); resume in {wall_resume:.3f} s: n_resumed "
        f"{res.n_resumed}, n_computed {res.n_computed}; cache now {after}")
    if res.n_resumed != 1 or res.n_computed != 2:
        raise AssertionError(f"resume: n_resumed {res.n_resumed}, "
                             f"n_computed {res.n_computed}")
    if not np.array_equal(res.crossing_time, split.crossing_time):
        raise AssertionError("the resumed campaign != the split one")
    if len(left) != 1 or not left[0].endswith(".npz"):
        raise AssertionError(f"the child left {left}, not one checkpoint")
    if len(after) != 1 or any(n.endswith((".claim", ".tmp")) for n in after):
        raise AssertionError(f"after resume the cache holds {after}: a claim "
                             f"or a slice checkpoint was left")
    shutil.rmtree(cache, ignore_errors=True)
    return dict(split=split, split_wall_s=wall_split,
                child_wall_s=wall_child, resume_wall_s=wall_resume,
                n_resumed=res.n_resumed)


def phase11_two_processes(split) -> dict:
    """11d: two child processes on the one card, released together by a
    file barrier, split the 3-launch campaign through one cache directory
    as a two-process ``CampaignMesh``."""
    from repro_torch.campaign import bucket_cells

    root = ROOT / "build" / "smoke-mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    per = bucket_cells(split.grid.cells)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD_MESH, str(root), str(i),
         str(ROOT / "src"), str(per), CHILD_DEVICE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        deadline = time.time() + CHILD_TIMEOUT_S
        while not all((root / f"ready{i}").exists() for i in range(2)):
            for pr in procs:
                if pr.poll() is not None:
                    raise AssertionError(f"a child died: "
                                         f"{pr.communicate()[1][-2000:]}")
            if time.time() > deadline:
                raise AssertionError("the children never became ready")
            time.sleep(0.01)
        startup = time.perf_counter() - t0
        (root / "go").touch()
        errs = [pr.communicate(timeout=CHILD_TIMEOUT_S)[1] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    wall = time.perf_counter() - t0
    if any(pr.returncode != 0 for pr in procs):
        raise AssertionError(f"a child failed: {[e[-2000:] for e in errs]}")
    outs = [json.loads((root / f"out{i}.json").read_text()) for i in range(2)]
    sha = sha256_of(split.crossing_time)
    total = sum(o["n_computed"] for o in outs)
    ready = ", ".join(f"{o['ready_s']:.2f}" for o in outs)
    log(f"  11d two processes on one card: both ready after {startup:.2f} s "
        f"(import + CUDA context + library: {ready} s), {wall:.2f} s in "
        f"all; n_computed {[o['n_computed'] for o in outs]} (sum {total}), "
        f"runs {[round(o['run_s'], 3) for o in outs]} s")
    if total != 3 or any(o["n_launches"] != 3 for o in outs):
        raise AssertionError(f"the two processes computed {total} launches")
    if any(o["sha"] != sha for o in outs):
        raise AssertionError("a process assembled another crossing tensor")
    if list(root.joinpath("cache").glob("*.claim")):
        raise AssertionError("a claim was left behind")
    shutil.rmtree(root, ignore_errors=True)
    return dict(startup_s=startup, ready_s=[o["ready_s"] for o in outs],
                run_s=[o["run_s"] for o in outs], wall_s=wall,
                n_computed=[o["n_computed"] for o in outs])


def phase11_donate(torch, dev, grid, dense) -> dict:
    """11e: the donated campaign equal to the undonated one; a donated
    kernel call writes into the state block, bit-identical to the
    undonated call in every layout, and allocates one (8, cells) block
    less; write-verify with ``WritePolicy(donate=True)`` equal to the
    undonated schedule."""
    import numpy as np

    from repro_torch.campaign import pack_campaign, run_campaign
    from repro_torch.campaign.engine import EARLY_EXIT_CHUNK, _quantize_steps
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.imc.write_path import WritePolicy, write_verify
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel, takes_producers

    don = run_campaign(AFMTJ_PARAMS, grid, use_cache=False, donate=True)
    if not np.array_equal(don.crossing_time, dense.crossing_time):
        raise AssertionError("the donated campaign != the undonated one")
    state, seeds, sigma, budget, _ = pack_campaign(grid, AFMTJ_PARAMS, dev)
    n = _quantize_steps(grid.n_steps)
    kw = dict(thermal_sigma=sigma, seeds=seeds, step_budget=budget,
              chunk=EARLY_EXIT_CHUNK)
    block = torch.empty_like(state)
    for lay in layouts_for(2, takes_producers(True, EARLY_EXIT_CHUNK)):
        want = llg_rk4_kernel(state, AFMTJ_PARAMS, grid.dt, n, **kw,
                              layout=lay)
        block.copy_(state)
        got = llg_rk4_kernel(block, AFMTJ_PARAMS, grid.dt, n, **kw,
                             layout=lay, out=block)
        torch.cuda.synchronize()
        if got.data_ptr() != block.data_ptr():
            raise AssertionError("the donated call did not write into state")
        if not torch.equal(got, want):
            raise AssertionError(f"donated != undonated in layout "
                                 f"{layout_tag(lay)}")
    del want, got
    peaks = {}
    for donate in (False, True, False, True):
        block.copy_(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r = llg_rk4_kernel(block, AFMTJ_PARAMS, grid.dt, n, **kw,
                           out=block if donate else None)
        torch.cuda.synchronize()
        peaks[donate] = torch.cuda.max_memory_allocated() - base
        del r
    one_block = 8 * state.shape[1] * 4
    delta = peaks[False] - peaks[True]
    log(f"  11e donated campaign bit-identical; donated kernel call "
        f"bit-identical in all {len(layouts_for(2, True))} layouts, writes "
        f"into the state block; peak over one launch {peaks[False]} B "
        f"undonated, {peaks[True]} B donated ({delta} B less; one block "
        f"{one_block} B)")
    if delta < one_block:
        raise AssertionError(f"donation saved {delta} B, less than one block")
    pol = WritePolicy(v_write=1.0, max_attempts=8, seed=0, use_cache=False)
    a = write_verify("afmtj", 4096, dataclasses.replace(pol, donate=True))
    b = write_verify("afmtj", 4096, pol)
    for f in ("attempts", "success", "crossing_time", "energy"):
        if not np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True):
            raise AssertionError(f"donated write-verify {f} != undonated")
    log(f"  11e write_verify('afmtj', 4096, donate=True): {a.rounds} rounds, "
        f"attempts mean {a.attempts_mean:.4f}, bit-identical to the "
        f"undonated schedule")
    return dict(peak_undonated_bytes=peaks[False],
                peak_donated_bytes=peaks[True], saved_bytes=delta,
                block_bytes=one_block, write_verify_rounds=a.rounds)


def phase11_devices(torch, dev) -> dict:
    """11f: ``run_ensemble`` on 2,048 lanes over ``[cuda:0] * n``: ``n``
    devices kept (padded, not fewer), ``n`` kernel calls, equal to the
    one-device run bit for bit."""
    import numpy as np

    from repro_torch.campaign.engine import _device_plan, run_ensemble
    from repro_torch.core import llg
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    th = torch.linspace(0.05, 0.15, 2048, device=dev)
    m0 = llg.initial_state(AFMTJ_PARAMS, th, torch.full_like(th, 0.2))
    v = torch.full((2048,), 1.0, device=dev)
    one = run_ensemble(AFMTJ_PARAMS, m0, v, 0.1e-12, 2000, seed=3, chunk=64)
    out = {}
    for n in DEVICE_PLAN_COUNTS:
        devs = [dev] * n
        got_n, cols = _device_plan(2048, devs, dev)
        before = llg_rk4_kernel.launches
        res = run_ensemble(AFMTJ_PARAMS, m0, v, 0.1e-12, 2000, seed=3,
                           chunk=64, devices=devs)
        calls = llg_rk4_kernel.launches - before
        if got_n != n or cols % (512 * n) or calls != n:
            raise AssertionError(f"{n} devices: plan {got_n} x {cols} lanes, "
                                 f"{calls} calls")
        if not (np.array_equal(res.crossing_steps, one.crossing_steps)
                and np.array_equal(res.final_state, one.final_state)):
            raise AssertionError(f"{n}-device ensemble != one device")
        out[n] = dict(plan_cols=cols, calls=calls)
    log(f"  11f run_ensemble 2,048 lanes x 2,000 steps over [cuda:0] x n: "
        + ", ".join(f"n={n}: {o['calls']} calls of {o['plan_cols'] // n} "
                    f"lanes" for n, o in out.items())
        + "; each bit-identical to one device")
    return out


def _cdf(x, at: float) -> float:
    import numpy as np

    return float(np.mean(np.asarray(x) <= at))


def hold_array_mc_twin(res: dict) -> None:
    """The array twin against the reference's output, MC_SIGMAS standard
    errors of a difference of two estimates: the switched share and each
    WER (binomial, the reference's rate floored at 1/n), the mean latency
    (the reference's std), p50 and p99 by the twin's share of switched
    cells at or below the reference's quantile (binomial at q); the
    margined pulse on the same rung or one off.  The maximum is an extreme
    order statistic with no standard error: logged, not held."""
    import numpy as np

    from repro_torch.imc.write_margin import _LADDERS

    ref = REF_ARRAY_MC
    n = ref["rows"] * ref["cols"]
    if (res["rows"], res["cols"], res["n_steps"]) != (
            ref["rows"], ref["cols"], ref["n_steps"]):
        raise AssertionError("array twin: another size than the reference's")

    def binom(got, want, what):
        q = min(max(want, 1.0 / n), 1.0 - 1.0 / n)
        b = MC_SIGMAS * math.sqrt(2.0 * q * (1.0 - q) / n)
        _mc_hold(abs(got - want) <= b, f"array twin {what}", got, want,
                 f"|d| <= {b:.4f}")

    binom(res["switched"], ref["switched"], "switched share")
    for pl, g, w in zip((250, 300, 350, 400), res["wer"], ref["wer"]):
        binom(g, w, f"WER at {pl} ps")
    b = MC_SIGMAS * math.sqrt(2.0) * ref["std"] / math.sqrt(ref["n_switched"])
    _mc_hold(abs(res["mean"] - ref["mean"]) <= b, "array twin mean latency",
             res["mean"], ref["mean"], f"|d| <= {b:.3e} s")
    t_sw = np.minimum(res["crossing_steps"], res["n_steps"]) * 0.1e-12
    ok = t_sw[res["crossing_steps"] < res["n_steps"]]
    for q, key in ((0.5, "p50"), (0.99, "p99")):
        share = _cdf(ok, ref[key] + 1e-16)
        bq = MC_SIGMAS * math.sqrt(2.0 * q * (1.0 - q) / n)
        _mc_hold(abs(share - q) <= bq, f"array twin share at or below the "
                 f"reference's {key} ({ref[key]:.4e} s; twin {key} "
                 f"{res[key]:.4e})", share, q, f"|d| <= {bq:.4f}")
    log(f"    array twin max latency {res['max']:.4e} s (reference "
        f"{ref['max']:.4e}; not held: an extreme order statistic)")
    rungs = list(_LADDERS["afmtj"])
    off = abs(rungs.index(res["pulse"]) - rungs.index(ref["pulse"]))
    _mc_hold(off <= 1 and res["v_worst"] == ref["v_worst"],
             "array twin worst-cell margined pulse", res["pulse"],
             ref["pulse"], "the same rung or one off, at the same worst drive")


def hold_analog_twin(card: dict, cpu: dict) -> float:
    """The analog twin on the card against itself on the CPU (same draws:
    within ``ANALOG_CARD_CPU_RTOL``), and against the reference's output
    (other draws: within MC_SIGMAS x sqrt(2) x ``ANALOG_SPREAD``).  Returns
    the largest card-vs-CPU relative gap."""
    worst = 0.0
    for arch, ref in REF_ANALOG_ACCURACY.items():
        rows = [(k, card[arch]["surface"][k], cpu[arch]["surface"][k], v)
                for k, v in ref["surface"].items()]
        rows.append(("bnn", card[arch]["bnn"], cpu[arch]["bnn"], ref["bnn"]))
        for key, g, c, w in rows:
            for j, what in ((1, "nmse"), (2, "cosine")):
                gap = abs(g[j] - c[j]) / abs(c[j])
                worst = max(worst, gap)
                if gap > ANALOG_CARD_CPU_RTOL:
                    raise AssertionError(
                        f"analog twin {arch} {key} {what}: card {g[j]!r}, "
                        f"CPU {c[j]!r}")
                b = (MC_SIGMAS * math.sqrt(2.0) * ANALOG_SPREAD[key][j - 1]
                     * abs(w[j]))
                _mc_hold(abs(g[j] - w[j]) <= b, f"analog twin {arch} {key} "
                         f"{what}", g[j], w[j], f"|d| <= {b:.4g}")
    return worst


def phase11_twins(torch) -> dict:
    """11g: the two new twins at full size and the fault study's section 4
    on the card, held against the reference's output."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_analog_accuracy
    import torch_array_mc_sim
    import torch_fault_study

    walls = {}
    t0 = time.perf_counter()
    arr = torch_array_mc_sim.run(use_cache=False)
    walls["torch_array_mc_sim"] = time.perf_counter() - t0
    for line in torch_array_mc_sim.report(arr):
        log("    " + line)
    hold_array_mc_twin(arr)
    t0 = time.perf_counter()
    card = torch_analog_accuracy.run()
    walls["torch_analog_accuracy"] = time.perf_counter() - t0
    for line in torch_analog_accuracy.report(card):
        log("    " + line)
    t0 = time.perf_counter()
    cpu = torch_analog_accuracy.run(device="cpu")
    walls["torch_analog_accuracy (CPU)"] = time.perf_counter() - t0
    gap = hold_analog_twin(card, cpu)
    log(f"    analog twin card vs CPU: largest relative gap {gap:.3e}")
    t0 = time.perf_counter()
    rs = torch_fault_study.resume_demo()
    walls["torch_fault_study section 4"] = time.perf_counter() - t0
    log(f"    fault study section 4: {rs}")
    if not (rs["same"] and rs["n_resumed"] == 1 and rs["n_launches"] == 2):
        raise AssertionError(f"fault study section 4: {rs}")
    log("  11g walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                     walls.items()))
    return dict(walls=walls, array_mc_elapsed_s=arr["elapsed_s"],
                analog_card_cpu_gap=gap)


def phase11(torch, dev) -> dict:
    """Phase 11, campaign scale-out at a study's size: streaming (11a),
    split launches (11b), crash and resume (11c), two processes on the one
    card (11d), donation (11e), device plans (11f), the twins (11g).  The
    LLG kernel's counter is set to 0 before the phase and read after it
    (children's launches are their own processes' and not counted)."""
    from repro_torch.campaign import run_campaign
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.kernels import analog_mac, llg_rk4
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel
    from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel

    log("phase 11: campaign scale-out (phase 3's grid: 786,432 packed lanes "
        "x 2,501 steps)")
    t0 = time.perf_counter()
    grid = campaign_grid()
    dense = PHASE3_DENSE.get("result")
    if dense is None:
        dense = run_campaign(AFMTJ_PARAMS, grid, use_cache=False)
    llg_rk4.reset_counts()
    analog_mac.reset_counts(bitline_mac_kernel)
    analog_mac.reset_counts(xnor_gemm_kernel)
    walls = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        walls[name] = time.perf_counter() - t
        return r

    stream = timed("11a", lambda: phase11_stream(torch, grid, dense))
    sr = timed("11b-c", lambda: phase11_split_resume(torch, grid, dense))
    mesh = timed("11d", lambda: phase11_two_processes(sr.pop("split")))
    donate = timed("11e", lambda: phase11_donate(torch, dev, grid, dense))
    devices = timed("11f", lambda: phase11_devices(torch, dev))
    twins = timed("11g", lambda: phase11_twins(torch))
    launches = llg_rk4.llg_rk4_kernel.launches
    layouts = {f"{cells} lanes, NSUB={nsub}, {layout_tag(lay)}": n
               for (cells, nsub, *lay), n in
               sorted(llg_rk4.llg_rk4_kernel.launch_layouts.items())}
    b3, b4 = bitline_mac_kernel.launches, xnor_gemm_kernel.launches
    total = time.perf_counter() - t0
    log(f"  phase 11 total: {total:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"); LLG launches {launches}, bit-line MAC {b3}, XNOR {b4}")
    if launches <= 0 or b3 <= 0 or b4 <= 0:
        raise AssertionError("phase 11 never launched the LLG, bit-line MAC "
                             "or XNOR kernel")
    return dict(stream=stream, resume=sr, two_processes=mesh, donate=donate,
                devices={str(k): v for k, v in devices.items()}, twins=twins,
                walls=walls, total_s=total, launches=launches,
                launch_layouts=layouts, bitline_launches=b3,
                xnor_launches=b4)


# --- phase 12: model scale-out ---------------------------------------------

# 12a: qwen2-0.5b's five launch shapes at M = 128 (phase 5) and its unembed
# at an odd M, each split over the card named n times
SPLIT_SHAPES = ([(QWEN_M, k, n, what) for k, n, what in QWEN_SHAPES]
                + [(7, 896, 151936, "unembed, M = 7")])
SPLIT_COUNTS = (2, 4)
# the reference's own bound of a split call against the unsplit one
# (tests/test_analog_pipeline.py::test_sharded_mvm_matches_single_device)
SPLIT_RTOL = 1e-5
SPLIT_ATOL = 1e-7
# 12c / 12d: qwen2-0.5b at full width on gloo ranks sharing the card, the
# global batch of phase 10a (4) in its 2 microbatches, train_4k's 4,096
# positions cut to 1,024 for the phase's time.  float32 compute and the CPU
# tests' schedule (steps 0, 1, 2 of lr 1e-2's warmup: lr 0, 1e-4, 2e-4):
# in bfloat16 a data rank's weight gradient is rounded to bfloat16 on its
# own rows' sum, not on the whole batch's, and AdamW's steps at phase 10's
# lr 3e-3 would move an element whose tiny gradient changed sign by up to
# 6e-3, so neither would test the sharding
SHARD_SEQ = 1024
# depth cut from 24 layers (never the width: d_model 896, vocabulary
# 151,936): with all 24 the whole smoke took 1,206.8 s on the H100
# machine, 208.1 s of it phase 12, past the 1,200 s it is given
SHARD_LAYERS = 4
SHARD_STEPS = 2
SHARD_LR = 1e-2
SHARD_TOTAL = 10
SHARD_MESHES = ((2, 1), (1, 2), (2, 2))
# agreement with the one-rank steps on the same shape and the same rows
# per microbatch (a data rank of a (2, *) mesh takes 1 row of each of the
# 2 microbatches, so its steps are held against 4 microbatches of 1 row;
# the one-rank step's own gradient moves by 9.39e-4 in L2 between 2
# microbatches of 2 rows and 4 of 1 at 24 layers on the card, 5.52e-3 at
# 4, printed by the phase): the loss relative; the gradient norm relative
# (wider than the CPU test's 1e-6: once a step has moved the parameters
# apart by rounding the next norm follows: 3.16e-6 at step 3 at 24 layers,
# 3.09e-5 at 4, in the first card runs); the first
# moment after step 0 (lr 0, so m is 0.1 x the clipped gradient) as |d| /
# |one rank| in L2 over the tree (gradient leaves that are zero in exact
# arithmetic, as the k bias's, hold rounding noise on both sides, so no
# bound is relative to one leaf); the parameters after step 2, the first
# that moves them and from equal parameters, at
# tests/test_torch_sharded_step.py's bounds (max |d|, share more than
# 1e-6 relative apart).  After later steps, from parameters already apart
# by rounding, AdamW flips the step of an element whose tiny gradient
# changes sign (up to 2 lr): max |d| over the lr summed over the steps
# and the share of elements more than 0.1 of the last lr apart (first card
# runs after step 3: 2.503e-4 = 1.25 lr and 4.2e-7 of the elements at 24
# layers, 2.555e-4 and 1.38e-6 at 4)
SHARD_LOSS_RTOL = 1e-6
SHARD_NORM_RTOL = 1e-4
SHARD_MOMENT_RTOL = 1e-5
SHARD_PARAM_ATOL = 1e-5
SHARD_PARAM_SHARE = 0.01
SHARD_FLIP_ATOL = 2.5
SHARD_FLIP_SHARE = 1e-5


def train_state(torch, cfg, shape, plan, dev, seed: int = 0):
    """``launch.train.train``'s starting state: ``init_params`` from
    ``seed`` on ``dev`` (this rank's shards with a plan), zero moments."""
    from repro_torch._tree import tree_map
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    if plan is not None:
        params = plan.shard(params)
    params = tree_map(lambda p: p.requires_grad_(), params)
    m, v = adamw_init(params, cfg.opt_state_dtype)
    return params, m, v


def shard_config():
    """12c / 12d's model: qwen2-0.5b's published widths, ``SHARD_LAYERS``
    layers, float32 compute."""
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch(TRAIN_ARCH), compute_dtype="float32",
                               n_layers=SHARD_LAYERS)


def run_steps(torch, cfg, shape, plan, state, steps, dev, lr=TRAIN_LR,
              total=TRAIN_TOTAL):
    """``steps`` of ``make_train_step`` (``train``'s step, sharded with a
    plan; ``wsd_schedule(step, lr, total=total)``) from step ``state[3]``
    on the pipeline's batches (this data rank's rows with a plan).
    Returns the state and per step (loss, grad norm, ms: host clock around
    the batch and the step, which ends in reading the metrics)."""
    import numpy as np

    from repro_torch.data import batch_at
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import data_config
    from repro_torch.optim import AdamWConfig

    params, m, v, step0 = state
    step_fn = ST.make_train_step(cfg, shape, AdamWConfig(lr=lr),
                                 total_steps=total, plan=plan)
    dc = data_config(cfg, shape)
    out = []
    for s in range(step0, step0 + steps):
        t0 = time.perf_counter()
        b = batch_at(dc, s)
        if plan is not None:
            b = plan.shard_batch(shape, b)
        b = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for k, a in b.items()}
        params, m, v, _, met = step_fn(params, m, v, s, b)
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    1e3 * (time.perf_counter() - t0)))
    return (params, m, v, step0 + steps), out


def phase12_split(torch, dev, smi: str) -> dict:
    """12a: ``analog_matmul(arr, x, devices=["cuda:0"] * n)`` at every
    shape of ``SPLIT_SHAPES`` against the unsplit call, B3 launched n times
    per call; ``mvm_accuracy`` and ``decode_projection_accuracy`` with
    ``devices=`` against unsplit."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.imc import analog_pipeline as ap
    from repro_torch.imc.mapping import decode_projection_accuracy
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel

    acfg = ap.AnalogConfig(adc_bits=6)
    card = "cuda:0" if dev.type == "cuda" else str(dev)
    rows = []

    def timed_ms(fn):
        """``time_ms`` of ``fn``, its launches left out of B3's counts
        (they are timing repeats, not the path's calls)."""
        counts = (bitline_mac_kernel.launches,
                  bitline_mac_kernel.reduce_launches,
                  bitline_mac_kernel.launch_shapes.copy())
        ms = time_ms(torch, fn, 10)
        (bitline_mac_kernel.launches, bitline_mac_kernel.reduce_launches,
         bitline_mac_kernel.launch_shapes) = counts
        return ms

    log("phase 12a: the analog devices= split (B3 once per entry of a "
        "device list naming the card n times; adc 6)")
    for m, k, n, what in SPLIT_SHAPES:
        x, w, _, _ = model_operands(torch, dev, m, k, n)
        arr = ap.program_weights(w, "afmtj", acfg, device=dev)
        y1 = ap.analog_matmul(arr, x)
        ms1 = timed_ms(lambda: ap.analog_matmul(arr, x))
        rec = {"shape": [m, k, n], "what": what, "unsplit_ms": ms1}
        for cnt in SPLIT_COUNTS:
            devices = [card] * cnt
            l0 = bitline_mac_kernel.launches
            r0 = bitline_mac_kernel.reduce_launches
            yn = ap.analog_matmul(arr, x, devices=devices)
            launches = bitline_mac_kernel.launches - l0
            reduces = bitline_mac_kernel.reduce_launches - r0
            tag = f"12a {what} ({m}x{k} @ {k}x{n}) over {cnt}"
            d = hold_close(yn, y1, tag, SPLIT_RTOL, SPLIT_ATOL)
            if launches != min(cnt, m):
                raise AssertionError(f"{tag}: {launches} B3 launches")
            msn = timed_ms(lambda: ap.analog_matmul(arr, x, devices=devices))
            rec[str(cnt)] = dict(max_abs_err=d, bit_equal=bool(
                torch.equal(yn, y1)), launches=launches,
                reduce_launches=reduces, ms=msn)
        log(f"  [{smi}] {what} {m}x{k} @ {k}x{n}: unsplit {ms1:.4f} ms; "
            + "; ".join(f"over {c}: {rec[str(c)]['launches']} launches "
                        f"(+{rec[str(c)]['reduce_launches']} reduce), "
                        f"{rec[str(c)]['ms']:.4f} ms, max |d| "
                        f"{rec[str(c)]['max_abs_err']:.3e}, bit-equal "
                        f"{rec[str(c)]['bit_equal']}" for c in SPLIT_COUNTS))
        rows.append(rec)
        del arr, x, w, y1, yn

    def fields(r):
        return (r.mse, r.nmse, r.cosine, r.max_abs_err)

    x, w, _, _ = model_operands(torch, dev, QWEN_M, 896, 4864)
    reports = {"mvm_accuracy 128x896 @ 896x4864": (
        ap.mvm_accuracy(w, x, cfg=acfg, device=dev),
        ap.mvm_accuracy(w, x, cfg=acfg, device=dev, devices=[card] * 4)),
        "decode_projection_accuracy qwen2-0.5b": (
        decode_projection_accuracy(get_arch(TRAIN_ARCH), device=dev),
        decode_projection_accuracy(get_arch(TRAIN_ARCH), device=dev,
                                   devices=[card] * 4))}
    for name, (r1, r4) in reports.items():
        for a, b in zip(fields(r4), fields(r1)):
            if not abs(a - b) <= SPLIT_ATOL + SPLIT_RTOL * abs(b):
                raise AssertionError(f"12a {name}: split {fields(r4)} vs "
                                     f"unsplit {fields(r1)}")
        log(f"  {name} over 4: nmse {r4.nmse:.6e} (unsplit {r1.nmse:.6e}), "
            f"cosine {r4.cosine:.8f} ({r1.cosine:.8f})")
    return dict(shapes=rows, reports={k: dict(split=fields(a),
                                              unsplit=fields(b))
                                      for k, (b, a) in reports.items()})


def phase12_nccl(torch, dev, smi: str, ms_10a: float) -> dict:
    """12b: a 1-rank NCCL group and a (1, 1) mesh; 2 sharded steps of
    qwen2-0.5b at phase 10a's shape equal 2 unsharded steps bit for bit
    (loss, gradient norm, every parameter and moment) under deterministic
    algorithms."""
    import torch.distributed as dist

    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import TRAIN_MICROBATCHES, get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharded_step import ShardPlan

    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("train_4k_b4", "train", TRAIN_SEQ, TRAIN_BATCH,
                        microbatches=TRAIN_MICROBATCHES[TRAIN_ARCH])
    root = ROOT / "build" / "smoke-nccl"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log(f"phase 12b: NCCL, 1 rank, (1, 1) mesh: {TRAIN_ARCH} at full width, "
        f"B {TRAIN_BATCH} x S {TRAIN_SEQ} in {shape.microbatches} "
        f"microbatches, 2 sharded steps against 2 unsharded from step "
        f"{TRAIN_STEP0}, deterministic algorithms")
    dist.init_process_group("nccl", init_method=f"file://{root / 'pg'}",
                            rank=0, world_size=1)
    torch.use_deterministic_algorithms(True)
    try:
        plan = ShardPlan(cfg, make_local_mesh(device_type="cuda"))
        ref, ref_m = run_steps(torch, cfg, shape, None, (*train_state(
            torch, cfg, shape, None, dev), TRAIN_STEP0), 2, dev)
        got, got_m = run_steps(torch, cfg, shape, plan, (*train_state(
            torch, cfg, shape, plan, dev), TRAIN_STEP0), 2, dev)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    unequal = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(ref[:3]), tree_leaves(got[:3])))
    n_leaves = len(tree_leaves(ref[:3]))
    same = [a[:2] == b[:2] for a, b in zip(ref_m, got_m)]
    log(f"  [{smi}] losses {[r[0] for r in got_m]} (unsharded "
        f"{[r[0] for r in ref_m]}), grad norms {[r[1] for r in got_m]}; "
        f"{unequal} of {n_leaves} parameter / moment leaves differ")
    log(f"  [{smi}] ms per step: sharded {[round(r[2], 1) for r in got_m]}, "
        f"unsharded {[round(r[2], 1) for r in ref_m]} (phase 10a's mean "
        f"{ms_10a:.1f}, deterministic algorithms off there)")
    if unequal or not all(same):
        raise AssertionError("the (1, 1) sharded step differs from the "
                             "unsharded step")
    del ref, got
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(sharded=got_m, unsharded=ref_m, leaves=n_leaves,
                unequal=unequal)


def leaf_gaps(torch, local, full_ref, plan, lr: float) -> dict:
    """This rank's shards of a tree against the same regions of the
    one-rank tensors, over the shards this rank is the first replica of
    (so the ranks' counts add up to each element once): elements, max
    |d|, the sums of d^2 and of the one-rank values squared, and the
    elements more than 1e-6 relative, more than 1e-3 ``lr`` and more than
    0.1 ``lr`` apart."""
    from repro_torch._tree import dict_leaves
    from repro_torch.launch.sharding import first_replica, shard_region

    out = dict(n=0, max_abs=0.0, d2=0.0, ref2=0.0, off_rel=0, off_lr=0,
               off_step=0)
    for x, spec, p in zip(dict_leaves(local), dict_leaves(plan.specs),
                          _leaf_paths(plan.specs)):
        if not first_replica(spec, plan.coord):
            continue
        ref = full_ref[p][shard_region(tuple(full_ref[p].shape), spec,
                                       plan.mesh, plan.coord)]
        ref = ref.to(x.device, torch.float64)
        d = (x.detach().double() - ref).abs()
        out["n"] += x.numel()
        out["max_abs"] = max(out["max_abs"], d.max().item())
        out["d2"] += torch.sum(d * d).item()
        out["ref2"] += torch.sum(ref * ref).item()
        out["off_rel"] += int((d > 1e-6 * ref.abs()).sum())
        out["off_lr"] += int((d > 1e-3 * lr).sum())
        out["off_step"] += int((d > 0.1 * lr).sum())
    return out


def _leaf_paths(tree, pre=""):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in
                _leaf_paths(tree[k], f"{pre}{k}/")]
    return [pre[:-1]]


def shard_lr(step: int) -> float:
    """The learning rate step ``step`` takes (``wsd_schedule``'s warmup)."""
    return SHARD_LR * min(step / 100, 1.0)


def sharded_child(root: str, rank: int, world: int, mesh_shape, job: dict):
    """One gloo rank of phase 12c / 12d (a child process of
    ``spawn_ranks``): its CUDA context, process group, mesh and a warm
    collective on every mesh axis, then the ready file; after the
    parent's go, the job; the rank's results in ``out<rank>.json``."""
    t0 = time.perf_counter()
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch._tree import dict_leaves
    from repro_torch.checkpoint import ShardedCheckpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharded_step import ShardPlan
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / 'pg'}",
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(mesh_shape[1], device_type=dev.type)
        for name in mesh.mesh_dim_names:
            dist.all_reduce(torch.ones(1, device=dev),
                            group=mesh.get_group(name))
        # first uses that cost seconds in a fresh process: the recompute's
        # torch.utils.checkpoint imports torch._dynamo, and cuBLAS starts
        import torch._dynamo  # noqa: F401
        torch.ones(8, 8, device=dev) @ torch.ones(8, 8, device=dev)
        out = {"rank": rank, "ready_s": time.perf_counter() - t0}
        (root / f"ready{rank}").touch()
        while not (root / "go").exists():
            time.sleep(0.005)
        t1 = time.perf_counter()
        cfg = shard_config()
        shape = ShapeConfig("shard", "train", SHARD_SEQ, TRAIN_BATCH,
                            microbatches=job["micro"])
        plan = ShardPlan(cfg, mesh)
        ckpt = ShardedCheckpointer(Path(job["ckpt"]), plan)
        refs = Path(job["refs"])
        if job["kind"] == "resume":
            like = {"params": M.abstract_params(cfg)}
            like.update(m=like["params"], v=like["params"],
                        step=torch.empty(()))
            st = ckpt.restore(job["from"], like, device=dev)
            state = (st["params"], st["m"], st["v"], int(st["step"]))
            out["restored_unequal"] = restored_unequal(torch, ckpt, plan,
                                                       st, job["from"])
        else:
            state = (*train_state(torch, cfg, shape, plan, dev), 0)
        got = {"params": sum(t.nbytes for t in dict_leaves(state[0])),
               "moments": sum(t.nbytes for t in dict_leaves(state[1])
                              + dict_leaves(state[2]))}
        if got != plan.state_bytes():
            raise AssertionError(f"rank {rank}: {got} bytes, the plan "
                                 f"says {plan.state_bytes()}")
        out["bytes"] = got
        out["steps"], out["gaps"] = [], {}
        for s, what in job["compare"]:
            state, met = run_steps(torch, cfg, shape, plan, state,
                                   s - state[3], dev, SHARD_LR, SHARD_TOTAL)
            out["steps"] += met
            ref = torch.load(refs / f"mb{job['ref_micro']}-{what}{s}.pt",
                             mmap=True, weights_only=True)
            out["gaps"][f"{what} after step {s}"] = leaf_gaps(
                torch, state[0] if what == "params" else state[1], ref,
                plan, shard_lr(s - 1))
            if s == job.get("save"):
                ckpt.save(s, {"params": state[0], "m": state[1],
                              "v": state[2], "step": torch.tensor(
                                  s, dtype=torch.int32)}, blocking=True)
        out["run_s"] = time.perf_counter() - t1
        out["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                       if dev.type == "cuda" else 0)
    finally:
        dist.destroy_process_group()
    (root / f"out{rank}.json").write_text(json.dumps(out))


def restored_unequal(torch, ckpt, plan, state, step: int) -> int:
    """Shards of a checkpoint's payloads that differ anywhere from the
    same region of the restored state, gathered over this mesh."""
    import numpy as np

    from repro_torch._tree import dict_leaves, tree_leaves_with_paths
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import shard_region, spec_entry

    d = ckpt.dir / f"step_{step}"
    man = json.loads((d / "manifest.json").read_text())
    old = MeshShape(tuple(man["mesh"]["axis_names"]),
                    tuple(man["mesh"]["shape"]))
    payloads = [torch.load(d / f"host{r}.pt", mmap=True, weights_only=True)
                for r in range(man["host_count"])]
    specs = {e["path"]: tuple(spec_entry(a) for a in e["spec"])
             for e in man["leaves"]}
    unequal = 0
    for (path, x), spec in zip(tree_leaves_with_paths(state),
                               dict_leaves(ckpt.specs_of(state))):
        p = "/".join(str(k) for k in path)
        full = plan._gather(x, spec)
        for r, payload in enumerate(payloads):
            if p in payload:
                coord = dict(zip(old.axis_names,
                                 (int(i) for i in np.unravel_index(
                                     r, old.shape))))
                part = full[shard_region(tuple(full.shape), specs[p], old,
                                         coord)]
                unequal += not torch.equal(part.cpu(), payload[p])
    return unequal


CHILD_SHARDED = (
    "import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
    "chip_smoke.sharded_child(sys.argv[2], int(sys.argv[3]), "
    "int(sys.argv[4]), json.loads(sys.argv[5]), json.loads(sys.argv[6]))")


def spawn_ranks(mesh, root: Path, job: dict) -> dict:
    """Start the ranks of ``mesh`` as child processes on the one card
    (gloo); they wait at a file barrier once ready (``release_ranks``)."""
    world = mesh[0] * mesh[1]
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD_SHARDED, str(ROOT), str(root), str(r),
         str(world), json.dumps(list(mesh)), json.dumps(job)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return dict(procs=procs, root=root, world=world, mesh=mesh, job=job,
                t0=time.perf_counter())


def kill_ranks(batch: dict) -> None:
    for pr in batch["procs"]:
        if pr.poll() is None:
            pr.kill()
            pr.wait()


def release_ranks(batch: dict) -> dict:
    """Wait until every rank of ``batch`` is ready, release them together,
    wait for them; their outputs, the time from the spawn to the release
    and the wall from the release.  A rank that fails fails the phase."""
    root, world, procs = batch["root"], batch["world"], batch["procs"]
    try:
        deadline = time.time() + CHILD_TIMEOUT_S
        while not all((root / f"ready{r}").exists() for r in range(world)):
            for pr in procs:
                if pr.poll() is not None:
                    raise AssertionError(f"a rank died: "
                                         f"{pr.communicate()[1][-3000:]}")
            if time.time() > deadline:
                raise AssertionError("the ranks never became ready")
            time.sleep(0.01)
        startup = time.perf_counter() - batch["t0"]
        t1 = time.perf_counter()
        (root / "go").touch()
        errs = [pr.communicate(timeout=CHILD_TIMEOUT_S)[1] for pr in procs]
    finally:
        kill_ranks(batch)
    if any(pr.returncode != 0 for pr in procs):
        raise AssertionError(f"a rank failed: {[e[-3000:] for e in errs]}")
    outs = [json.loads((root / f"out{r}.json").read_text())
            for r in range(world)]
    return dict(outs=outs, startup_s=startup,
                wall_s=time.perf_counter() - t1)


def hold_sharded(tag: str, run: dict, ref_steps: list, first: int,
                 smi: str) -> dict:
    """The mesh's steps (rank 0's; every rank reports the same metrics)
    against the one-rank steps from index ``first``, and its first moments
    / parameters against the one-rank ones at each compared step, all
    ranks' counts summed."""
    outs = run["outs"]
    steps = outs[0]["steps"]
    ref = ref_steps[first:first + len(steps)]
    loss_gap = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(steps, ref))
    norm_gap = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(steps, ref))
    gaps, ok = {}, loss_gap <= SHARD_LOSS_RTOL and norm_gap <= SHARD_NORM_RTOL
    for what in outs[0]["gaps"]:
        g = [o["gaps"][what] for o in outs]
        n = sum(x["n"] for x in g)
        gaps[what] = dict(
            n=n, max_abs=max(x["max_abs"] for x in g),
            rel_l2=math.sqrt(sum(x["d2"] for x in g)
                             / sum(x["ref2"] for x in g)),
            off_rel_share=sum(x["off_rel"] for x in g) / n,
            off_lr_share=sum(x["off_lr"] for x in g) / n,
            off_step_share=sum(x["off_step"] for x in g) / n)
        step = int(what.rsplit(" ", 1)[1])
        if what.startswith("m "):
            ok &= gaps[what]["rel_l2"] <= SHARD_MOMENT_RTOL
        elif step == SHARD_STEPS and first == 0:
            ok &= (gaps[what]["max_abs"] <= SHARD_PARAM_ATOL
                   and gaps[what]["off_rel_share"] <= SHARD_PARAM_SHARE)
        else:
            ok &= (gaps[what]["max_abs"]
                   <= SHARD_FLIP_ATOL * sum(map(shard_lr, range(step)))
                   and gaps[what]["off_step_share"] <= SHARD_FLIP_SHARE)
    ready = ", ".join(f"{o['ready_s']:.2f}" for o in outs)
    log(f"  [{smi}] {tag}: each rank ready (torch, CUDA context, process "
        f"group, a warm collective per axis) {ready} s after its start; "
        f"{run['wall_s']:.1f} s from the release; ms per step (rank 0) "
        f"{[round(x[2], 1) for x in steps]}; loss {[x[0] for x in steps]} "
        f"(rel gap {loss_gap:.2e}), grad norm rel gap {norm_gap:.2e}; "
        f"bytes per rank {outs[0]['bytes']}; peak "
        f"{max(o['max_memory_allocated'] for o in outs) / 2**30:.2f} GiB")
    for what, g in gaps.items():
        log(f"    {what}: max |d| {g['max_abs']:.3e}, |d| / |one rank| "
            f"{g['rel_l2']:.2e} (L2 over the tree), of {g['n']} elements "
            f"{g['off_rel_share']:.2e} more than 1e-6 relative apart, "
            f"{g['off_lr_share']:.2e} more than 1e-3 lr, "
            f"{g['off_step_share']:.2e} more than 0.1 lr")
    if not ok:
        raise AssertionError(f"{tag}: the sharded steps disagree with the "
                             "one-rank steps")
    return dict(steps=steps, loss_rel=loss_gap, grad_norm_rel=norm_gap,
                gaps=gaps, released_after_s=run["startup_s"],
                ready_s=[o["ready_s"] for o in outs],
                run_s=[o["run_s"] for o in outs], wall_s=run["wall_s"],
                bytes=outs[0]["bytes"],
                max_memory_allocated=[o["max_memory_allocated"]
                                      for o in outs])


def spawn_phase12_ranks(root: Path) -> dict:
    """Every rank of 12c / 12d, started together at the phase's start so
    their startup overlaps 12a and 12b: (2, 1), (1, 2), (2, 2) (saving at
    step ``SHARD_STEPS`` and taking one more) and the (2, 2) checkpoint's
    resume on the elastic plan's mesh with its microbatches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharded_step import elastic_remesh

    s2, s3 = SHARD_STEPS, SHARD_STEPS + 1
    base = dict(micro=2, ckpt=str(root / "ckpt"), refs=str(root / "refs"),
                device=CHILD_DEVICE, kind="train",
                compare=[(1, "m"), (s2, "params")])
    new_mesh, new_shape = elastic_remesh(
        2, MeshShape(("data", "model"), (2, 2)),
        ShapeConfig("shard", "train", SHARD_SEQ, TRAIN_BATCH,
                    microbatches=2))
    # each mesh against the one-rank step with its rows per microbatch
    jobs = {str(m): (m, dict(base, ref_micro=2 * m[0]))
            for m in SHARD_MESHES}
    jobs[str((2, 2))][1].update(compare=[(1, "m"), (s2, "params"),
                                         (s3, "params")], save=s2)
    jobs["resume"] = (new_mesh.shape, dict(
        base, kind="resume", micro=new_shape.microbatches,
        ref_micro=new_shape.microbatches * new_mesh.shape[0],
        compare=[(s3, "params")], **{"from": s2}))
    batches = {}
    try:
        for name, (mesh, job) in jobs.items():
            batches[name] = spawn_ranks(mesh, root / f"ranks-{len(batches)}",
                                        job)
    except BaseException:
        for b in batches.values():
            kill_ranks(b)
        raise
    return batches


def phase12_meshes(torch, dev, smi: str, root: Path, batches: dict) -> dict:
    """12c / 12d: the one-rank steps on the shape in 2 microbatches of 2
    rows and in 4 of 1 (a data rank's rows per microbatch), their first
    moments after step 1 and parameters after steps 2 and 3 saved for the
    ranks; then (2, 1), (1, 2) and (2, 2) released in turn, each held
    against the one-rank steps with its own rows per microbatch; then the
    resume of the (2, 2) run's checkpoint on the elastic plan's mesh."""
    from repro_torch._tree import dict_leaves, tree_leaves
    from repro_torch.configs.base import ShapeConfig

    cfg = shard_config()
    refs = root / "refs"
    refs.mkdir(parents=True)
    s2, s3 = SHARD_STEPS, SHARD_STEPS + 1
    log(f"phase 12c: {TRAIN_ARCH} at full width, depth cut ({cfg.n_layers} "
        f"layers of 24, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.compute_dtype} "
        f"compute) on gloo ranks sharing the card, B {TRAIN_BATCH} x S "
        f"{SHARD_SEQ} in 2 microbatches, steps 0-{s2} of lr {SHARD_LR}'s "
        f"warmup; meshes {SHARD_MESHES}")
    t0 = time.perf_counter()
    ref_steps, m1 = {}, {}
    for micro in (2, 4):
        shape = ShapeConfig("shard", "train", SHARD_SEQ, TRAIN_BATCH,
                            microbatches=micro)
        state = (*train_state(torch, cfg, shape, None, dev), 0)
        ref_steps[micro] = []
        for s, what in ((1, "m"), (s2, "params"), (s3, "params")):
            state, met = run_steps(torch, cfg, shape, None, state,
                                   s - state[3], dev, SHARD_LR, SHARD_TOTAL)
            ref_steps[micro] += met
            tree = state[0] if what == "params" else state[1]
            if what == "m":
                m1[micro] = [t.clone() for t in tree_leaves(tree)]
            torch.save(dict(zip(_leaf_paths(tree), (
                t.detach().cpu() for t in dict_leaves(tree)))),
                refs / f"mb{micro}-{what}{s}.pt")
        del state
    own = math.sqrt(sum(torch.sum((a.double() - b.double()) ** 2).item()
                        for a, b in zip(m1[4], m1[2]))
                    / sum(torch.sum(b.double() ** 2).item() for b in m1[2]))
    del m1
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    for micro, steps in ref_steps.items():
        log(f"  [{smi}] one rank, {micro} microbatches: losses "
            f"{[x[0] for x in steps]}, grad norms {[x[1] for x in steps]}, "
            f"ms per step {[round(x[2], 1) for x in steps]}")
    log(f"  the one-rank step's own gap, 4 microbatches of 1 row against 2 "
        f"of 2: first moment after step 1 |d| / |m| {own:.2e} (L2); "
        f"{ref_s:.1f} s with the saved tensors")
    meshes = {}
    for mesh in SHARD_MESHES:
        batch = batches[str(mesh)]
        tag = (f"12c mesh {mesh} (against {batch['job']['ref_micro']} "
               f"microbatches)" + (f"; 12d: saves at step {s2}"
                                   if mesh == (2, 2) else ""))
        meshes[str(mesh)] = hold_sharded(
            tag, release_ranks(batch), ref_steps[batch["job"]["ref_micro"]],
            0, smi)
    resume = batches["resume"]
    run = release_ranks(resume)
    unequal = [o["restored_unequal"] for o in run["outs"]]
    log(f"phase 12d: the (2, 2) checkpoint of step {s2} restored on the "
        f"elastic plan's mesh {tuple(resume['mesh'])} (microbatches 2 -> "
        f"{resume['job']['micro']}): {unequal} payload shards differ from "
        f"the restored state")
    if any(unequal):
        raise AssertionError("the restored state differs from the saved one")
    held = hold_sharded(f"12d mesh {tuple(resume['mesh'])}, step {s3}", run,
                        ref_steps[resume["job"]["ref_micro"]], s2, smi)
    return dict(one_rank=ref_steps, one_rank_s=ref_s,
                one_rank_microbatch_gap=own, meshes=meshes,
                resume=dict(held, mesh=list(resume["mesh"]),
                            restored_unequal=unequal))


def phase12(torch, dev, smi: str, ms_10a: float) -> dict:
    """Phase 12, model scale-out: the ranks of 12c / 12d started first (so
    12a's times are taken while they start), the analog split (12a), NCCL
    on one rank (12b), gloo ranks on the card (12c) and the checkpoint's
    remesh (12d); B3's launches counted over the phase."""
    from repro_torch.kernels import analog_mac
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel

    t0 = time.perf_counter()
    root = ROOT / "build" / "smoke-shard"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    batches = spawn_phase12_ranks(root)
    analog_mac.reset_counts(bitline_mac_kernel)
    walls = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        walls[name] = time.perf_counter() - t
        return r

    try:
        split = timed("12a", lambda: phase12_split(torch, dev, smi))
        b3, b3_reduce = (bitline_mac_kernel.launches,
                         bitline_mac_kernel.reduce_launches)
        nccl = timed("12b", lambda: phase12_nccl(torch, dev, smi, ms_10a))
        meshes = timed("12c-d", lambda: phase12_meshes(torch, dev, smi, root,
                                                       batches))
    finally:
        for b in batches.values():
            kill_ranks(b)
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t0
    log(f"  phase 12 total: {total:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"); bit-line MAC launches {b3} (+{b3_reduce} reduce passes)")
    if b3 <= 0:
        raise AssertionError("phase 12 never launched the bit-line MAC")
    return dict(split=split, nccl=nccl, meshes=meshes, walls=walls,
                total_s=total, bitline_launches=b3,
                bitline_reduce_launches=b3_reduce)


# --- phase 13: the dry run, FLOP audit and roofline -------------------------

# the cells the dry-run children trace, one child per group, all started
# with the smoke: jamba's train cell (16 microbatches, ~5 min on one core)
# alone, the other pod-mesh cells of the two 398e9-parameter archs and 13b's
# cell ("hold") in the other
DRY_GROUPS = (
    (("jamba-1.5-large-398b", "train_4k"),),
    (("qwen2-0.5b", "hold"),
     ("llama4-maverick-400b-a17b", "train_4k"),
     ("llama4-maverick-400b-a17b", "prefill_32k"),
     ("llama4-maverick-400b-a17b", "decode_32k"),
     ("jamba-1.5-large-398b", "prefill_32k"),
     ("jamba-1.5-large-398b", "decode_32k"),
     ("jamba-1.5-large-398b", "long_500k")),
)
# phase 13 waits for the children until this many seconds into the smoke
DRY_DEADLINE_S = 1100
HOLD_STEPS = 3
# 13b: the estimate (argument + temp) against the measured peak
PEAK_RTOL = 0.2
CHILD_DRY = (
    "import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
    "chip_smoke.dry_child(sys.argv[2], json.loads(sys.argv[3]))")


def hold_shape():
    """13b's cell: phase 10a's shape."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import TRAIN_MICROBATCHES

    return ShapeConfig("train_4k_b4", "train", TRAIN_SEQ, TRAIN_BATCH,
                       microbatches=TRAIN_MICROBATCHES[TRAIN_ARCH])


def dry_child(out: str, cells: list) -> None:
    """Trace ``cells`` on the meta device, one record each under ``out``
    (``<arch>__<shape>.json``): the reference's pod-mesh cells, and "hold"
    (13b's cell on a (1, 1) mesh)."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    for arch, shape in cells:
        if shape == "hold":
            t0 = time.perf_counter()
            cell = dryrun.build(get_arch(arch), hold_shape(),
                                MeshShape(("data", "model"), (1, 1)))
            res = dryrun.trace(cell, time.perf_counter() - t0)
        else:
            res = dryrun.run_cell(arch, shape, False, verbose=False)
        Path(out, f"{arch}__{shape}.json").write_text(json.dumps(res))


def spawn_dry_children(root: Path) -> list:
    """One child per ``DRY_GROUPS`` entry, its errors to a file under
    ``root``."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = []
    for i, group in enumerate(DRY_GROUPS):
        with open(root / f"child{i}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD_DRY, str(ROOT), str(root),
                 json.dumps(group)], env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    return procs


def stop_children(procs: list) -> None:
    for pr in procs:
        if pr.poll() is None:
            pr.kill()
            pr.wait()


def wait_dry_children(procs: list, root: Path, t_start: float) -> None:
    deadline = t_start + DRY_DEADLINE_S
    try:
        for i, pr in enumerate(procs):
            try:
                pr.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"a dry-run child was still tracing "
                    f"{DRY_DEADLINE_S} s into the smoke") from None
            if pr.returncode != 0:
                raise AssertionError(
                    f"a dry-run child failed: "
                    f"{(root / f'child{i}.err').read_text()[-3000:]}")
    finally:
        stop_children(procs)


def plan_argument_bytes(arch: str, shape_name: str) -> int:
    """Rank 0's argument bytes on the pod mesh from the plan and the
    specs: ``state_bytes`` (train), the parameter shards and the batch or
    decode cache shards, and the reference's int32 step counter (train) or
    cache position (decode)."""
    from repro_torch._tree import dict_leaves
    from repro_torch.configs.base import shape_for
    from repro_torch.configs.registry import TRAIN_MICROBATCHES, get_arch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.launch.sharded_step import ShardPlan

    cfg = get_arch(arch)
    mesh = production_mesh_shape()
    shape = shape_for(cfg, shape_name, TRAIN_MICROBATCHES[arch]
                      if shape_name == "train_4k" else None)
    plan = ShardPlan(cfg, mesh, (0, 0), kind=shape.kind)
    state = plan.state_bytes()

    def shards(tree, specs):
        return sum(math.prod(SH.local_shape(tuple(x.shape), sp, mesh))
                   * x.element_size()
                   for x, sp in zip(dict_leaves(tree), dict_leaves(specs))
                   if hasattr(x, "shape"))

    batch = ST.input_specs(cfg, shape)
    b_specs = SH.batch_shardings(mesh, shape, batch)
    if shape.kind == "train":
        return state["params"] + state["moments"] + shards(batch,
                                                           b_specs) + 4
    if shape.kind == "prefill":
        return state["params"] + shards(batch, b_specs)
    cache = ST.abstract_cache(cfg, shape)
    return (state["params"] + shards(cache, SH.cache_shardings(
        mesh, cfg, shape, cache)) + shards(batch, b_specs) + 4)


def phase13_cells(root: Path) -> dict:
    """13a: each pod-mesh cell's record held against the plan, printed
    with its roofline terms."""
    from repro_torch.launch import roofline

    log("phase 13a: the dry run of the two 398e9-parameter archs on the "
        "pod mesh (16 x 16), rank 0, traced on the meta device in child "
        "processes; roofline terms from H100 SXM data-sheet rates "
        "(analytic bounds, not card times)")
    out = {}
    for arch, shape in (c for g in DRY_GROUPS for c in g):
        if shape == "hold":
            continue
        res = json.loads((root / f"{arch}__{shape}.json").read_text())
        mem = res["memory"]
        want = plan_argument_bytes(arch, shape)
        if mem["argument_size_in_bytes"] != want:
            raise AssertionError(f"{arch} {shape}: argument bytes "
                                 f"{mem['argument_size_in_bytes']} != the "
                                 f"plan's {want}")
        a = roofline.analyze(res)
        coll = a["coll_bytes"]
        log(f"  {arch} {shape}: per rank argument "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB (= the plan's), "
            f"temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB, collectives "
            f"{coll / 1e9:.2f} GB; fits in 80 GB: "
            f"{'yes' if roofline.fits(res) else 'no'}; compute "
            f"{a['t_compute'] * 1e3:.1f} ms, memory "
            f"{a['t_memory'] * 1e3:.1f} ms, collective "
            f"{a['t_collective'] * 1e3:.1f} ms -> {a['dominant']}; FLOPs "
            f"per rank {res['flops_rank']:.4e}; traced in "
            f"{res['t_lower_s']:.1f} s")
        out[f"{arch}__{shape}"] = dict(
            memory=mem, flops_rank=res["flops_rank"],
            collectives=res["collectives"], fits=roofline.fits(res),
            t_compute=a["t_compute"], t_memory=a["t_memory"],
            t_collective=a["t_collective"], dominant=a["dominant"],
            roofline_frac=a["roofline_frac"], trace_s=res["t_lower_s"])
    return out


def phase13_hold(torch, dev, smi: str, est: dict) -> dict:
    """13b: the dry run's estimate of qwen2-0.5b's step against the step on
    the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharded_step import ShardPlan

    cfg = get_arch(TRAIN_ARCH)
    shape = hold_shape()
    mem = est["memory"]
    est_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    log(f"phase 13b: {TRAIN_ARCH} at full width, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ} in {shape.microbatches} microbatches on a (1, 1) "
        f"ShardPlan; the dry run's estimate against {HOLD_STEPS} steps on "
        f"the card")
    plan = ShardPlan(cfg, MeshShape(("data", "model"), (1, 1)), (0, 0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    req_before = torch.cuda.memory_stats().get("requested_bytes.all.current",
                                               0)
    state = (*train_state(torch, cfg, shape, plan, dev), TRAIN_STEP0)
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    steps = []
    for _ in range(HOLD_STEPS):
        # one step per call: nothing here holds a state past its step, as
        # nothing in ``train``'s loop does (a tuple kept over the loop would
        # keep the first state alive: 5.5 GB)
        state, out = run_steps(torch, cfg, shape, plan, state, 1, dev)
        steps += out
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    requested = (torch.cuda.memory_stats().get("requested_bytes.all.peak", 0)
                 - req_before)
    with FlopCounterMode(display=False) as counter:
        state, _ = run_steps(torch, cfg, shape, plan, state, 1, dev)
    flops = float(counter.get_total_flops())
    del state
    torch.cuda.empty_cache()
    ms = [r[2] for r in steps]
    ms_mean = sum(ms[1:]) / len(ms[1:])
    terms = roofline.bound_terms(est)
    frac = terms["bound"] / (ms_mean / 1e3)
    model = train_flops(cfg, spec_count(cfg), TRAIN_BATCH, TRAIN_SEQ)
    gap = est_peak / peak - 1.0
    log(f"  [{smi}] peak over the allocation before the state "
        f"{peak / 2**30:.3f} GiB against the estimate (argument "
        f"{mem['argument_size_in_bytes'] / 2**30:.3f} + temp "
        f"{mem['temp_size_in_bytes'] / 2**30:.3f}) "
        f"{est_peak / 2**30:.3f} GiB: {100 * gap:+.2f}%; over the state "
        f"(baseline {(baseline - before) / 2**30:.3f} GiB) "
        f"{(peak - (baseline - before)) / 2**30:.3f} GiB against temp; "
        f"requested bytes' peak {requested / 2**30:.3f} GiB (the allocator's "
        f"blocks unrounded); {before / 2**30:.3f} GiB allocated before the "
        f"phase")
    log(f"  [{smi}] FLOPs of a step on the card (FlopCounterMode) "
        f"{flops:.6e}, audited on meta {est['flops_rank']:.6e}")
    log(f"  [{smi}] ms per step {[round(x, 1) for x in ms]} (mean after the "
        f"first {ms_mean:.1f}); the roofline's bound {terms['bound'] * 1e3:.1f}"
        f" ms ({terms['dominant']}: compute {terms['t_compute'] * 1e3:.1f}, "
        f"memory {terms['t_memory'] * 1e3:.1f} ms) -> {100 * frac:.1f}% of "
        f"the bound reached; model FLOPs {model:.4e}, "
        f"{100 * model / (ms_mean / 1e3) / roofline.PEAK_FLOPS:.2f}% of "
        f"the dense bf16 peak")
    if abs(gap) > PEAK_RTOL:
        raise AssertionError(f"the estimate {est_peak} is {100 * gap:.1f}% "
                             f"from the measured peak {peak}")
    if flops != est["flops_rank"]:
        raise AssertionError(f"the card's step counts {flops} FLOPs, the "
                             f"audit {est['flops_rank']}")
    return dict(peak=peak, requested_peak=requested, estimate=est_peak,
                memory=mem, gap=gap, baseline=baseline - before,
                allocated_before=before,
                flops_card=flops, flops_audit=est["flops_rank"],
                ms_per_step=ms, ms_mean=ms_mean, bound_ms=terms["bound"] * 1e3,
                dominant=terms["dominant"], t_compute=terms["t_compute"],
                t_memory=terms["t_memory"], roofline_frac=frac,
                model_flops=model, card=smi)


def phase13(torch, dev, smi: str, children: list, t_start: float) -> dict:
    """Phase 13: the dry-run children's cells (13a) and the hold on the
    card (13b); no kernel wrapper launches over the phase."""
    t0 = time.perf_counter()
    before = kernel_counts()
    root = ROOT / "build" / "smoke-dryrun"
    wait_dry_children(children, root, t_start)
    waited = time.perf_counter() - t0
    cells = phase13_cells(root)
    hold = phase13_hold(torch, dev, smi, json.loads(
        (root / f"{TRAIN_ARCH}__hold.json").read_text()))
    after = kernel_counts()
    if after != before:
        raise AssertionError(f"phase 13 launched a kernel: {before} -> "
                             f"{after}")
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t0
    log(f"  phase 13 total: {total:.1f} s (waiting for the children "
        f"{waited:.1f}); kernel launches: 0")
    return dict(cells=cells, hold=hold, total_s=total, wait_s=waited)


def kernel_counts() -> dict:
    from repro_torch.kernels.adc_sizing import adc_aux_kernel
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel
    from repro_torch.kernels.fake_analog import fake_analog_kernel
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel
    from repro_torch.kernels.llg_write import llg_write_kernel
    from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel

    return {w.__name__: w.launches for w in (
        llg_rk4_kernel, llg_write_kernel, bitline_mac_kernel,
        xnor_gemm_kernel, fake_analog_kernel, adc_aux_kernel)}


def phase10(torch, dev, smi: str) -> dict:
    """Phase 10, training: full width (10a), card vs CPU and microbatches
    (10b), resume (10c), every family's backward (10d).  The training path
    reaches none of the port's kernels (the reference's reaches no Pallas
    kernel): every wrapper's launch count is the same after the phase as
    before it."""
    t0 = time.perf_counter()
    before = kernel_counts()
    full = phase10_full_width(torch, smi)
    card_cpu = phase10_card_vs_cpu(torch, dev)
    resume = phase10_resume(torch)
    families = phase10_families(torch, dev)
    after = kernel_counts()
    if after != before:
        raise AssertionError(f"training launched a kernel: {before} -> "
                             f"{after}")
    total = time.perf_counter() - t0
    log(f"  phase 10 total: {total:.1f} s (10a {full['wall_s']:.1f}, 10b "
        f"{card_cpu['wall_s']:.1f}, 10c {resume['wall_s']:.1f}, 10d "
        f"{families['wall_s']:.1f}); kernel launches during training: 0")
    return dict(full_width=full, card_vs_cpu=card_cpu, resume=resume,
                families=families, total_s=total,
                kernels_on_path=[],
                note="the training path (forward_train, its backward, AdamW) "
                     "is plain PyTorch, as the reference's is jnp with no "
                     "Pallas kernel; no kernel wrapper launched during "
                     "phase 10")


def main() -> int:
    # phase 10c's bit-equal resume runs under deterministic algorithms,
    # whose cuBLAS calls need this workspace setting before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    children = spawn_dry_children(ROOT / "build" / "smoke-dryrun")
    try:
        return run_phases(torch, t_start, children)
    finally:
        stop_children(children)


def run_phases(torch, t_start: float, children: list) -> int:
    from repro_torch.kernels import build, llg_rk4, llg_write
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    smi = nvidia_smi()
    log(f"phase 0: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; {os.cpu_count()} CPU cores; the card's memory "
        f"{torch.cuda.mem_get_info()[1]} bytes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = build.build_many(("llg_rk4", "llg_write", "analog_mac",
                                "fake_analog", "xnor_gemm", "adc_sizing"),
                               {"llg_rk4": llg_rk4.BUILD_DEFINES})
    for name, sec in t_build.items():
        log(f"  nvcc build of {name}.cu: {sec:.1f} s" if sec else
            f"  {name}.cu already built")
        if name == "llg_rk4":
            continue      # the census below gives its instances' resources
        for line in ptxas_lines(build.build_log(name)):
            log("   ", line)
    sys.path.insert(0, str(ROOT / "tools"))
    import sass_census

    census_rows = sass_census.census(*sass_census.disassemble())
    log("  SASS census of llg_rk4.cu (fast path of one step):")
    for row in census_rows:
        log("   ", sass_census.describe(row))
    census = {sass_census.key(row): row for row in census_rows}
    write_census = {row["nsub"]: row for row in sass_census.census_write(
        *sass_census.disassemble("llg_write"))}
    log("  SASS census of llg_write.cu (fast path of one step, one thread "
        "per lane):")
    for nsub, row in sorted(write_census.items()):
        log(f"    NSUB={nsub}: {row['instructions_per_lane_step']} "
            f"instructions per lane-step: {row['classes']}; MUFU "
            f"{row['mufu_per_step']}; {row.get('registers')} registers, "
            f"{row.get('spill_stores', 0)}/{row.get('spill_loads', 0)} B "
            f"spill st/ld")
    cache = ROOT / "build" / "smoke-campaign-cache"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_TORCH_CAMPAIGN_CACHE"] = str(cache)
    dev = torch.device("cuda")

    phase1_cases = phase1(torch, dev, census)
    llg_rk4.reset_counts()
    llg_write.reset_counts()
    t_phase = time.perf_counter()
    launches_ev = phase2(torch)
    write_launches_p2 = llg_write.llg_write_kernel.launches
    log(f"  phase 2: {time.perf_counter() - t_phase:.1f} s; write kernel "
        f"launches {write_launches_p2}")
    if write_launches_p2 <= 0:
        raise AssertionError("phase 2 never launched the write kernel")
    write = phase2b(torch, dev, write_census)
    main_launches, grid, wall = phase3(torch, dev)
    if main_launches <= 0:
        raise AssertionError("the main path never launched the LLG kernel")
    launch_layouts = {f"{cells} lanes, NSUB={nsub}, {layout_tag(lay)}": n
                      for (cells, nsub, *lay), n in
                      sorted(llg_rk4_kernel.launch_layouts.items())}
    log(f"  LLG launches of phases 2-3 by layout: {launch_layouts}")
    shapes = main_path_shapes(dev, grid, census)
    shutil.rmtree(cache, ignore_errors=True)
    rule_range = rule_range_shapes(dev, census)
    require_no_slower(shapes + rule_range)
    m = shapes[0]
    analog_shapes = phase5_hold(torch, dev)
    path = phase5_path(torch, dev)
    per_fwd = per_forward(analog_shapes, path)
    log_per_forward(per_fwd)
    require_b5_no_slower(analog_shapes)
    twins = phase6(torch)
    corners = phase7(torch, dev, census, write_census)
    remainder = phase8(torch, dev, census)
    family_shapes = phase9_hold(torch, dev)
    families = phase9(torch, dev, family_shapes)
    training = phase10(torch, dev, smi)
    scale = phase11(torch, dev)
    sharded = phase12(torch, dev, smi, training["full_width"]["ms_mean"])
    dry = phase13(torch, dev, smi, children, t_start)

    record = {"kernels": [{
        "name": "llg_rk4",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/llg_rk4.cu",
        "replaces": "src/repro/kernels/llg_rk4.py:318",
        # B2, the deterministic _llg_kernel, is the same kernel with
        # THERMAL = false (phase 1 holds and times it; not on the main path)
        "also_replaces": "src/repro/kernels/llg_rk4.py:287",
        "launches": main_launches,
        "max_abs_err": max(x["max_abs_err"] for x in shapes),
        "ms": m["ms"],
        "ms_c1t1": m["ms_c1t1"],
        "layout": m["layout"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": "operations",
        "issue_floor_ms": m["issue_floor_ms"],
        "library_ms": None,
        "shape": "600000 lanes (786432 padded) x 2501 steps, chunk 64",
        "launch_layouts": launch_layouts,
        "sass_census": {
            "THERMAL={:d} VARIATION={:d} NSUB={} TPL={} CLUSTER={:d} "
            "PRODUCE={:d}".format(*k): dict(
                per_lane_step=r["instructions_per_lane_step"],
                          classes=r["classes"], mufu=r["mufu_per_step"],
                          registers=r.get("registers"),
                          stack=r.get("stack"))
            for k, r in census.items()},
        "lane_steps": m["lane_steps"],
        "campaign_wall_s": wall,
        "launches_per_evaluate_system_p99": launches_ev,
        "main_path_shapes": shapes,
        "rule_range_shapes": rule_range,
        "phase1_cases": phase1_cases,
        # phase 7, the process-corner and read path: its own count (set to
        # 0 before it), by layout and variation instance, and its new
        # launch families (the first TRUNC_STEPS steps held against the
        # plain version, the whole horizon against C1T1)
        "launches_phase7": corners["launches"],
        "launch_layouts_phase7": corners["launch_layouts"],
        "phase7_shapes": corners["shapes"],
        # phase 8, the write-path / fault-cost remainder and serving: its
        # own count (set to 0 before it) and its new launch families (the
        # whole horizon against C1T1; two against the plain version over
        # their first PHASE8_TRUNC_STEPS steps)
        "launches_phase8": remainder["launches"],
        "phase8_shapes": remainder["shapes"],
        # phase 11, campaign scale-out: its own count (set to 0 before it;
        # the child processes' launches are theirs) and layouts
        "launches_phase11": scale["launches"],
        "launch_layouts_phase11": scale["launch_layouts"],
    }]}
    replaces = {"bitline_mac": "src/repro/kernels/bitline_mac.py:87",
                "xnor_gemm": "src/repro/kernels/xnor_gemm.py:76",
                "fake_analog": "src/repro/kernels/fake_analog.py:174"}
    errs = {"bitline_mac": "bitline_mac_err", "xnor_gemm": None,
            "fake_analog": "fake_analog_err"}
    sources = {"bitline_mac": "analog_mac.cu", "xnor_gemm": "xnor_gemm.cu",
               "fake_analog": "fake_analog.cu"}
    widest = analog_shapes[-1]
    phase9_counts = {name: {} for name in replaces}
    for fam in families["paths"].values():
        for name, counts in fam["launch_shapes"].items():
            for shape, c in counts.items():
                phase9_counts[name][shape] = \
                    phase9_counts[name].get(shape, 0) + c

    def shape_rows(name, shapes, counts):
        return [dict(x[name], shape=x["shape"], what=x["what"],
                     launches=counts.get(tuple(x["shape"]), 0),
                     host_us=x["host_us"][name],
                     library_host_us=(None if x[name]["library_ms"] is None
                                      else x["host_us"]["torch.matmul"]))
                for x in shapes]

    for name, line in replaces.items():
        r = widest[name]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": line,
            "launches": path["launches"][name],
            # calls that split K also launch the source's reduce_kernel
            "reduce_launches": path["reduce_launches"][name],
            # phase 8's write/accuracy surface and write-path twin (B3 only)
            **({"launches_phase8": remainder["bitline_launches"]}
               if name == "bitline_mac" else {}),
            "max_abs_err": (0.0 if errs[name] is None else
                            max(x[errs[name]] for x in analog_shapes)),
            "ms": r["ms"],
            "ms_device": r["ms_device"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_ms_device": r["library_ms_device"],
            "shape": "128 x 896 @ 896 x 151936 (unembed)",
            # phase 5's shapes with phase 5b's launches, then phase 9's
            # with phase 9b's (olmoe-1b-7b and mamba2-780m)
            "main_path_shapes": (
                shape_rows(name, analog_shapes, path["launch_shapes"][name])
                + shape_rows(name, family_shapes, phase9_counts[name])),
            "launches_phase9": {arch: fam["launches"][name] for arch, fam
                                in families["paths"].items()},
            # phase 11's analog twin (B3 analog points, B4 bnn rows)
            **({"launches_phase11": scale["bitline_launches"]}
               if name == "bitline_mac" else
               {"launches_phase11": scale["xnor_launches"]}
               if name == "xnor_gemm" else {}),
            # phase 12a's devices= split (B3 once per device entry)
            **({"launches_phase12": sharded["bitline_launches"],
                "reduce_launches_phase12":
                    sharded["bitline_reduce_launches"]}
               if name == "bitline_mac" else {}),
        })
    held = analog_shapes + family_shapes
    record["kernels"].append({
        "name": "adc_sizing",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adc_sizing.cu",
        # not a pl.pallas_call site: the reference sizes the full scale and
        # the decode gain as traced scalars in its jitted forward
        "replaces": "src/repro/imc/model_analog.py:167",
        "launches": path["sizing_launches"],
        "launches_phase9": {arch: fam["sizing_launches"] for arch, fam
                            in families["paths"].items()},
        # every sizing launch of phases 5a and 9a held bit for bit
        # (products_held counts the timed shapes')
        "max_abs_err": 0.0,
        "products_held": sum(x["adc_sizing_held"] for x in held),
        "ms": widest["adc_sizing"]["ms"],
        "ms_device": widest["adc_sizing"]["ms_device"],
        "bound_ms": widest["adc_sizing"]["bound_ms"],
        "bound_by": widest["adc_sizing"]["bound_by"],
        "library_ms": None,
        "shape": "aux plane of 128 x 896 @ 896 x 151936 (unembed)",
        "main_path_shapes": [dict(x["adc_sizing"], shape=x["shape"],
                                  what=x["what"])
                             for x in held if "adc_sizing" in x],
    })
    w = write[2]                # the quickstart's voltages, AFMTJ
    record["kernels"].append({
        "name": "llg_write",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/llg_write.cu",
        # not a pl.pallas_call site: the reference's write is this lax.scan
        "replaces": "src/repro/core/device.py:143",
        "launches": twins["launches"],
        "launches_phase2": write_launches_p2,
        "max_abs_err": max(c["max_abs_err"] for c in write),
        "ms": w["ms"],
        "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "shape": w["case"],
        "cases": write,
        "launches_phase7": corners["write_launches"],
        # the ss sample's writes: the conductance factor g_scale != 1
        "phase7_cases": corners["writes"],
        "sass_census": {f"NSUB={k}": dict(
            per_lane_step=r["instructions_per_lane_step"],
            classes=r["classes"], mufu=r["mufu_per_step"],
            registers=r.get("registers"))
            for k, r in write_census.items()},
    })
    record["twins"] = twins
    # (the twins' own numbers hold infinite escape times: logged above)
    record["phase7"] = {k: v for k, v in corners.items()
                        if k not in ("shapes", "writes", "launch_layouts",
                                     "twins")}
    record["phase8"] = {k: v for k, v in remainder.items()
                        if k != "shapes"}
    record["model_path"] = {k: v for k, v in path.items()
                            if k not in ("launches", "reduce_launches",
                                         "launch_shapes", "sizing_launches")}
    record["analog_ms_per_forward"] = per_fwd
    record["phase9"] = {
        "analog": {arch: {k: v for k, v in fam.items()
                          if k not in ("launches", "reduce_launches",
                                       "launch_shapes")}
                   for arch, fam in families["paths"].items()},
        "serving": families["serving"], "walls": families["walls"],
        "total_s": families["total_s"]}
    # phase 10: no kernel is on the training path (kernels_on_path is
    # empty); every kernel above keeps its own main-path launches
    record["training"] = training
    record["phase11"] = {k: v for k, v in scale.items()
                         if k not in ("launch_layouts",)}
    record["phase12"] = sharded
    # phase 13: the dry run reaches no kernel (every count unchanged)
    record["phase13"] = dry
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
