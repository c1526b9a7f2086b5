#!/usr/bin/env python3
"""Smoke run of rectipy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), PyTorch and CUDA.
2. build: compiles the four CUDA sources of rectipy_tpu_torch/csrc/ and the
   generic fused step's generated sources (one per template structure this
   script attaches, into rectipy_tpu_torch/_build/gen/) with nvcc (sm_90a),
   one nvcc per source, all started together, and prints the compile times
   and ptxas's register report.
3. kernel_check: the fused QIF+SFA step kernel against its plain PyTorch
   version on the same card, at N = 10,000 with the main path's coupling,
   in f32 and bf16: once with v across the threshold (the reset) and once
   with inputs on which the coupling sets v' (the matvec).
4. main_path: the bench network (qif_sfa SpikeResetNet with a seeded 10%
   row-normalised coupling, fed by a tanh node through a Linear edge) built
   through the public API, the kernel attached, and Network.run over 10,000
   steps, for a bf16 and an f32 coupling; the launch counter must equal the
   step count and the records must be finite; neuron-updates/s from the best
   of 3 timed runs.
5. fused_vs_plain: the bf16 network with and without the kernel over 2,000
   steps; the population-mean s records must agree.
6. timing: per kernel, its ms per step, the derived bound, the plain
   version's ms and torch.mv's ms (the matvec alone, a yardstick); and the
   main path's whole network step timed on the device alone, which with
   the end-to-end step gives the device's idle share.
7. train_kernel_check: the int8 matvecs (bit for bit) and the fused adam +
   requantize kernel (rtol 1e-6; wq equal away from rounding boundaries)
   against their plain versions at the training path's shapes.
8. train_path: bench.py's north-star training (QIF SpikeResetNet, N =
   10,000, T = 500, dt = 5e-3, int8_master coupling, adam lr 1e-4, 16
   epochs) through Network.fit_bptt with RECTIPY_FUSED_ADAM=on: a 2-epoch
   warm fit and one timed fit; the launch counts must be 16 adam_requant and
   8,000 of each int8 matvec per fit, the losses finite.
9. train_split_vs_fused: 4 epochs with RECTIPY_FUSED_ADAM=off and =on on
   fresh networks: epoch 0's loss equal, later ones within rtol 1e-4.
10. train_timing: one epoch split by CUDA events into the forward loop, the
   backward loop, the dW matmul and the optimizer tail; the device's idle
   share over one epoch from torch.profiler; each training kernel's ms,
   bound and plain ms.

Phases 11-14 (run after phase 6, while the main path's networks exist):

11. generic_kernel_check and generic_timing: one step of the generic fused
   step kernel against its plain version at N = 10,000 with the main
   path's coupling, in f32 and bf16 W, for every case of
   rectipy_tpu_torch.testing.GENERIC_CASES (qif_sfa, lif, ik
   MultiSpikeResetNet, qif_reset SpikeNet, the tanh RateNet in Heun's
   derivative mode, two couplings one of which targets the input); the
   qif_sfa case also on inputs where the coupling sets v' (the lost-eighth
   margin must exceed 1); then each instance's ms, bound, plain ms and
   torch.mv ms (the matvecs alone).
12. generic_path: examples/fused_kernels.py's LIF network (bf16 coupling)
   with attach_generic_fused_step and Network.run over 10,000 steps; one
   launch per step, finite records, neuron-updates/s from the best of 3.
13. generic_vs_specialized: the main path's bf16 network with the generic
   kernel in place of attach_fused_qif_step over 2,000 steps, in turns
   with the specialized one; the records must agree under fused_vs_plain's
   rule.
14. generic_ei_path: examples/ei_circuit_multi_coupling.py's E/I circuit
   (two f32 couplings through CircuitTemplate) over 2,000 steps.
The kernels line lists the instances that phases 12-14 ran.

Phases 15-17 (after phase 14; the int4 couplings and the packed-int4 kernels
of csrc/int4_matvec.cu, the counterpart of benchmarks/i4pack_microbench.py):

15. int4_kernel_check: int4_mv and int4_mv_t against their plain versions
   on the card, bit for bit: (a) on the packed W that the int4 path's
   network made in its own prep (N = 10,000); (b) the microbenchmark's own
   case at its N = 14,336 (weights in [-8, 7], x in [-127, 127], seed 0),
   also equal to x @ wt in float64; (c) a 1,001 x 999 shape with unpadded
   500-byte rows, which takes the scalar instantiations.
16. int4_path: the main path's network (phase 4) without a fused kernel,
   with coupling_dtype="int4" and, in turns, "int8" (bench.py's default),
   10,000 steps through Network.run, int4 best of 3 and int8 of 2 in
   turns; one int4_mv (or int8_mv) launch per step, finite records, the correlation of the int4 and int8
   records, each path's device-only step and idle share; then the same int4
   network on the CPU over 200 steps, held to the card's run under
   fused_vs_plain's rule (int4_path_vs_cpu, which also counts the records
   that agree bit for bit).
17. int4_timing: at N = 10,000 and 14,336, each int4 kernel's ms, bytes,
   bound and achieved bytes/s, its plain version's ms on the card and
   int8_mv/int8_mv_t on the same integers (the microbenchmark's A/B).

Phases 18-19 (after phase 10, on the training path's data):

18. int4_train_path: phase 8's network with coupling_dtype="int4_master":
   a 2-epoch warm fit and one timed 16-epoch fit; 8,000 launches each of int4_mv and
   int4_mv_t per fit, none of the int8 kernels or adam_requant; finite
   losses; ms/epoch and trained neuron-updates/s.
19. bf16_master_train_path: the same network with "bfloat16_master", 4
   epochs (no hand-written kernel: bf16 x bf16 products with float32 sums
   as a PyTorch matvec, as the JAX package leaves them to XLA).

Phases 20-24 (after phase 19; the trainers and FeedbackNetwork, through the
kernels above, at N = 10,000):

20. rls_path: FORCE learning. The main path's bf16 network (phase 4, the
   fused QIF+SFA kernel) with an identity readout of width 1 behind an RLS
   edge (beta 0.99, alpha 1, float64 P of 10,000 x 10,000): fit_rls over
   10,000 steps of bench_inputs with the target sin(2 pi 2 t),
   update_steps=10, sampling_steps=100, then Network.test on the same
   inputs from the same initial state; 10,000 kernel launches per fit,
   finite losses and weights, P symmetric; ms/step, the RLS update alone
   (cuda_ms) against its bound (P read twice and written once).
21. rls_vs_cpu: the same FORCE fit (a fresh RLS edge, from the reservoir's
   state after phase 20) on the card and on the CPU for 200 steps with
   update_steps=10: readout records and W under fused_vs_plain's rule.
22. ridge_path: fit_ridge on the same reservoir over 10,000 steps with
   sampling_steps=10 (X is 1,000 x 10,000, float32 Gram matrix and solve
   on the card), alpha = 1e-3 x the largest eigenvalue of X X^T from a
   first run of the same inputs; the predictions held to numpy's float64
   solve of the same X on the host (its dual form, (X X^T + alpha I) c = y,
   y = X X^T c) within cond x eps32 x sqrt(rows), cond from float64
   eigenvalues; then test() with the ridge readout.
23. tbptt_path: phase 8's network (int8_master) trained by fit_bptt in step
   mode on the bench data tiled to T = 2,000 with update_steps=100 (20
   chunks), adam lr 1e-4: one warm and one timed fit; 2,000 launches each of
   int8_mv and int8_mv_t per fit and none of adam_requant (step mode takes
   the split optimizer); 20 finite chunk losses; ms per chunk.
24. feedback_path: examples/feedback_populations.py as a FeedbackNetwork at
   N = 10,000 per population (two LIF populations with the generic kernel
   and a bf16 coupling, dense float32 feedforward p1 -> p2 and feedback
   p2 -> p1; the example's weights, sized for N = 100, scaled by 100/N),
   10,000 steps, best of 2; two kernel launches per step; the device-only
   step and idle share; the first 200 steps on the CPU held to the card's
   under fused_vs_plain's rule.
No kernel is added for phases 20-24; the kernels line lists the instances
they ran with their launch counts (qif_sfa_step and the int8 matvecs with
phase 6's and phase 10's timings of the same kernel, the generic kernel
checked and timed on the feedback path's node), and phase 10 adds
torch._int_mm as the int8 rows' library yardstick.

Phases 25-28 (after phase 24; the batched trials of Network.run_batch and
fit_bptt_batch, through the batched kernels int8_mm/int8_mm_t of
csrc/int8_matvec.cu, int4_mm/int4_mm_t of csrc/int4_matvec.cu, the B-row
qif_sfa_step of csrc/qif_sfa_step.cu and the B-row generic step of
csrc/generic_fused_step.cuh):

25. batch_kernel_check: at N = 10,000, int8_mm and int8_mm_t bit for bit
   against their plain versions at B = 32 and 7 (the main path's quantized
   W, per-trial activation scales); both must take their tensor-core
   routes ("mma", int8_mm_route and int8_mm_t_route; one mma_launches of
   each a call), which each line names; the B-row qif_sfa_step in f32 and bf16
   W at B = 32 and 5, on strided rows of one (B, 3N) state buffer, in the
   reset and coupling cases, held to TOL against its plain version and,
   trial by trial, against the single-row kernel; equal reset masks; the
   lost-eighth margin of the coupling case.  Each line names the kernel's
   route (rows_route): bf16 W on the tensor cores ("mma", counted apart in
   qif_sfa_step.mma_launches), f32 W on the CUDA cores' tiled kernel
   ("tiled", counted in qif_sfa_step.tiled_launches), which is also held
   to TOL against the CUDA cores' older vector instance (route code "vec", reached
   through the C entry alone) with equal reset masks.  Then
   the B-row generic step (generic_fused_rows) for LIF (K = 1), the
   E/I circuit (K = 2) and the Heun tanh RateNet (derivative mode), f32
   and bf16 W, B = 32 and 5, at N (bf16: the tensor cores, counted in
   generic_fused_rows.mma_launches; f32: the tiled CUDA-core kernel,
   counted in generic_fused_rows.tiled_launches, also held to the CUDA
   cores' vector instance it replaced, route code "vec" through the C
   entry), N - 4 for bf16 (the CUDA cores' bf16 vector route) and N - 1
   (odd: the scalar route), on the route generic_rows_route names, on
   strided state rows, held per trial to its plain version and to the
   single-trial kernel under GENERIC_TOL["reset"];
   and int4_mm/int4_mm_t bit for bit against their plain versions (and
   int4_mv/int4_mv_t on the first and last trial) at B = 32, 7 and 5, N =
   10,000 and 14,336, both on their tensor-core routes (int4_mm_route and
   int4_mm_t_route "mma", one mma_launches of each a call), which each
   line names.
26. run_batch_path: benchmarks/batch_throughput.py's network (N = 10,000
   qif_sfa, 10% fan-in of 1/(0.1 N) from seed 42, the tan etas, dt 1e-4)
   with a frozen int8 coupling: an eta sweep (offsets linspace(-2, 2, 32))
   over 32 trials on a shared (5,000, 1) drive, record_vars the population
   mean of s every 100 steps, in turns with the single-trial run, best of
   2; one int8_mm launch per step, every one on the tensor cores
   (int8_mm.mma_launches); trials 0, 15 and 31 against
   single-trial runs with their eta over 200 steps (the int8 sums are exact
   on both sides: rtol 1e-5).  Then the same with a bf16 coupling and the
   fused QIF step: one B-row launch per step, every one on the tensor
   cores (qif_sfa_step.mma_launches), the trials under fused_vs_plain's
   rule; then with a f32 coupling and the fused QIF step at its default
   weights_dtype (f32): one B-row launch per step, every one on the tiled
   kernel (qif_sfa_step.tiled_launches) and none of the single-row kernel,
   the trials under fused_vs_plain's rule, ratio_to_single against the
   single-trial f32 fused run in turns; then with a frozen int4 coupling: one int4_mm launch per
   step, every one on the tensor cores (int4_mm.mma_launches), the trials
   held as int8's.  Then the same network with an
   int4_master coupling swept per trial (4 couplings of their own, 1,000
   steps): 4,000 int4_mv launches, the first and last trial against
   single-trial runs with their coupling.  Then phase 12's LIF network
   (the generic kernel) with a bf16 coupling and, built once more, at its
   default f32 coupling, each over 32 trials of 2,000 steps of their own
   drive: one B-row launch a step (2,000), every one on the tensor cores
   (bf16) or on the tiled kernel (f32), none of the single-trial kernel;
   each trial against its single-trial run over 200 steps under
   fused_vs_plain's rule; aggregate neuron-updates/s against the
   single-trial run of the same network; then each network's B-row kernel
   alone at the path's shapes, timed in turns with its CUDA-core vector
   instance (kernel, vec, vec, kernel; the two held to each other first),
   its plain version, torch.matmul of the same W on (32, N) rows and its
   bound; the bf16 one also in turns with the 32 single-trial launches it
   replaces, the f32 one also with its probes (the ring's stream with the
   shared loads and no FMAs, without the copies of the sources, the
   ring's stream alone) and nvidia-smi's SM clock and power while it runs;
   and the E/I circuit's K = 2 step at B = 32 on the tensor cores (bf16)
   and on the tiled kernel (f32, in turns with its vector instance, and
   its probes), each with its bound and two torch.matmul.
27. batch_train_path: bench.py's ensemble phase at full size, fit_bptt_batch
   of phase 8's network (int8_master, adam lr 1e-4) on B = 32 trials of
   normal (32, 500, 10,000) float32 arrays from default_rng(7), full batch:
   a 2-epoch warm fit and a timed 8-epoch fit; 4,000 launches each of
   int8_mm and int8_mm_t per fit, all 4,000 of each on the tensor cores
   (int8_mm.mma_launches, int8_mm_t.mma_launches), and none of int8_mv(_t)
   or adam_requant;
   finite losses; ms/epoch and aggregate trained neuron-updates/s against
   phase 8's single-trial figure.  Then batch_train_vs_cpu: the same fit at
   N = 2,000, B = 4, T = 50, 2 epochs, on the card and on the CPU (losses
   rtol 1e-4; at most 1% of the weights' updates differ by more than 1% of
   lr; see BATCH_LOSS_RTOL).  Then the same ensemble with an
   int4_master coupling on the same trial arrays: a 1-epoch warm fit and a
   timed 4-epoch fit, 2,000 launches each of int4_mm and int4_mm_t (all
   2,000 of each on the tensor cores, int4_mm.mma_launches and
   int4_mm_t.mma_launches) and none of int4_mv(_t); ms/epoch and aggregate
   trained neuron-updates/s against phase 18's; and batch_train_vs_cpu for
   int4_master.
28. batch_timing: int8_mm/int8_mm_t at B = 32 (bound, plain ms,
   torch._int_mm of the same integers; for int8_mm_t its W is a column-major
   copy, so the yardstick reads W already transposed), each line with
   kernel_route and its ms in turns with its __dp4a instance on the same
   operands (tensor cores, __dp4a, __dp4a, tensor cores; the two held equal
   first), the B-row step at B = 32 in f32 and
   bf16 (bound, plain ms, torch.matmul of s by W^T; the bound takes the
   bf16 peak for a bf16 W, so that step is bound by its bytes; the line
   adds kernel_route, achieved_bytes_per_s and the ms of its probes: for
   the tensor-core route its W stream and fragment reads with and without
   the barrier between chunks; for the tiled f32 route the ring's stream
   with the shared loads and no FMAs, the kernel without the copies of s,
   and the ring's stream alone; the f32 step is timed in turns with the
   CUDA cores' vector instance, tiled, vec, vec, tiled, the two held to
   TOL["reset"] first, and nvidia-smi's SM clock and power sampled while
   it runs back to back for 1.5 s), one B = 32
   epoch split
   by CUDA events (forward loop, backward loop, dW product, adam step) and
   the device's idle share over one epoch (torch.profiler).  Then
   int4_mm/int4_mm_t at B = 32 on the main path's W quantized to int4
   (bound, plain ms, torch._int_mm of the same integers unpacked to int8),
   each in turns with the 32 int4_mv (int4_mv_t) launches it replaces and
   with its __dp4a instance (tensor cores, __dp4a, __dp4a, tensor cores;
   the two held equal first), both also at N = 14,336 (random packed
   weights: 103 MB, more than the L2 holds).
The kernels line adds int8_mm and int8_mm_t (launches of phase 27's fit),
int8_mm[run_batch_path] (launches of phase 26's int8 run, phase 28's
timing at the same shapes), the B-row step in bf16 and in f32 (launches of
phase 26's fused runs), int4_mm and int4_mm_t (launches of phase 27's int4_master
fit; each with its kernel_route), int4_mm[run_batch_path] (phase 26's
int4 run) and the B-row generic
step's tensor-core and tiled f32 instances (phase 26's two LIF runs, timed
there).

Phase 29 (run after phase 2, before any phase quantizes):

29. quant_scales_exact: PyTorch's CUDA division by a Python scalar
   multiplies by the scalar's reciprocal; on rows where that parts from
   the true division (rectipy_tpu_torch.testing.reciprocal_rows), the
   card's quantize_rows, quantize_rows_i4 and quant_vec (scales and
   integers) and the frozen coupling's source scale must equal the CPU's
   bit for bit; the line also counts the rows where the card's division
   by the Python scalars 7.0 and 127.0 parts from the CPU's (the form the
   port no longer uses).

Phases 30-32 (after phase 28; the edge family of rectipy_tpu_torch/edges.py,
computed with PyTorch operations as the JAX package computes it with XLA
operations; no kernel of its own):

30. whole_brain_path: benchmarks/whole_brain_scale.py's network at M = 998
   Jansen-Rit regions, float32, dt 1e-4, conduction speed 2 m/s (positions
   in a 0.14 m cube from default_rng(0), W = exp(-dist/0.06) normalised by
   in-strength x 40, D = rint(dist/speed/dt), a 1,157-step span, tau_e ~
   U(8e-3, 13e-3)) as a FeedbackNetwork self-edge brain -> brain; auto must
   pick the factored read (S = 15, Q = 78).  Network.run of 4,000 steps
   (sampling_steps 100), best of 3, in turns with the same network with an
   instantaneous dense f32 edge and with mode="gather", each at 2,000
   steps: ms per step, region-updates/s, the delay overhead factor, each
   network's device-only step and idle share, and the delay read alone
   (the edge step on CUDA events) against its byte bound (factored: the
   coarse and fine one-hots, the (n_in, n_out, S) intermediate written and
   read, W and the buffer, about 0.50 GB; gather: the int64 index, W and
   the buffer); one selector build per run.  The factored and gather reads give
   bit-identical records over 2,000 steps (fresh networks, no TF32); the
   card against the CPU over 200 steps under fused_vs_plain's rule;
   run_batch of 8 trials of 2,000 steps (normal inputs x 2 from
   default_rng(2)), best of 2, each trial held to its single-trial run
   over 200 steps under the same rule; peak device memory.
31. stp_feedback_path: phase 24's network (two LIF populations of N =
   10,000, bf16 couplings with the generic kernel, feedback_weights(N),
   drive 100, 10,000 steps) with both edges LinearSTP: p1 -> p2 depressing
   (U 0.5, tau_depress 5, no facilitation), the feedback p2 -> p1
   facilitating (U 0.2, tau_facil 10, tau_depress 1), in turns with the
   plain-edge network (stp, plain, plain, stp); 40,000 generic launches a
   run; both populations active (the largest window mean of s above 1e-3)
   and the STP state moved (min x of p1 -> p2 below 0.9, max u of p2 -> p1
   above 0.2 after the first run); each network's device-only step; the
   first 200 steps on the CPU held to the card's (records and the final
   (u, x)) under fused_vs_plain's rule; the kernels line gains the generic
   kernel's entry for this path.
32. edge_family_check: at n = 1,000, float32, 500 steps, an identity input
   through each edge class into a tanh population, on the card against the
   CPU under fused_vs_plain's rule: masked, per-source delay, filter, delay
   + filter, STP, and the delay matrix's onehot, factored, gather, interp
   (hat and factored2) reads and the factored and onehot reads with
   read_dtype bfloat16; then at M = 90 regions of phase 30's network a
   trainable-delay interp edge (delays x 1.1 against a teacher's records x
   1.05, 1,000 steps): the epoch loss and the gradients of weights and
   delays on the card against the CPU (FIT_LOSS_RTOL, FIT_GRAD_RTOL), and
   one fit_bptt epoch on the card, whose loss must be the same.


Phases 33-36 (PR 18, after phase 32; block-sparse couplings and edges,
ops/sparse.py and the block section of ops/quant.py, whose int8 contraction
is the hand-written kernel block_int8_mv of csrc/block_int8.cu):

33. block_int8_check: block_int8_mv bit for bit against its plain version
   on the card at B = 1, 3 and 16 trials, bs = 512, 32 and 20 (20 takes
   the kernel's 4-byte pieces), with both index forms: a node coupling's
   cols over (B, nb_in, bs) sources and a flat (nb_in * D1)-block history
   index; then block_int8_timing at the million-neuron shape (1,954 block
   rows x 4 x 512^2, random int8 operands), B = 1 and 16: its ms against
   the byte bound, its plain version's ms and the yardstick, torch.bmm in
   bf16 of the same integers (exact) over the gathered rows, float32 out.
34. sparse_scale_path: benchmarks/sparse_scale.py's network at N =
   1,000,448 (qif_sfa, dt 1e-4, fan-in 1,000, 512-neuron blocks, seed 0,
   the native sampler, asserted; the tan etas, alpha 0.05, k 15), Pulse(T,
   1, t_on=T//4, amp=3.0) as an array; Network.run of 2,000 steps with
   sampling_steps=100 and the population mean of s, coupling_dtype="int8"
   (block_int8_mv, 2,000 launches a run, asserted) in turns with
   "bfloat16" (a gather and torch.bmm), best of 3: ms/step, nu/s, the
   device's idle share, the kernel's share of the step, the block stream's
   bytes/s, the sampling and build seconds, peak device memory; the host
   float32 master is dropped after the build.  Then the SCALE_BATCH branch:
   run_batch of 16 trials (etas + linspace(-1, 1, 16)) over 500 steps in
   turns with the single trial (500 launches, asserted), trials 0 and 15
   held to single-trial runs with their eta over 100 steps (rtol 1e-5);
   and the same construction at N = 8,192 on the card against the CPU
   over 200 steps under fused_vs_plain's rule, int8 and bf16.
35. block_delay_path: benchmarks/block_delay_scale.py's network at N =
   100,352 (196 patches, fan-in 1,000, seed 0, dt 1e-3, ring delays scaled
   to 64 steps, etas 1000 + 200 N(0, 1) from default_rng(1), all coupling
   on a FeedbackNetwork self-edge, Pulse(T, 1, t_on=T//8, amp=3.0)): four
   variants in turns over 2,000 steps, best of 3: zero-delay, delayed f32,
   delayed block_dtype="bfloat16" and delayed "int8_master" (block_int8_mv
   on the gathered stack, 2,000 launches a run, asserted); ms/step, idle
   share, the edge's step alone against its byte bound, block_int8_mv
   alone at the edge's shape; two chunked runs of 1,000 steps equal to one
   of 2,000 bit for bit (f32 and int8); the delayed run differs from the
   zero-delay one; the card against the CPU at N = 8,192 over 200 steps.
36. sparse_train_check: at N = 8,192, fit_bptt (2 epochs, T = 200, sgd)
   through a block-coupled QIF node with float32 and int8_master weights on
   the chain trajectory (asserted), one plain-autograd epoch through a
   delayed f32 BlockSparseLinear edge (train="gd"), and 20 steps of a frozen
   int8_master edge's source gradient (nonzero: the STE, where the JAX
   package gives zeros), each on the card against the CPU (FIT_LOSS_RTOL,
   FIT_GRAD_RTOL).
The kernels line adds block_int8_mv (B = 1: the int8 run's launches),
block_int8_mv[B=16] (the run_batch launches) and
block_int8_mv[block_delay_path] (the int8 edge's launches, timed at its
gathered-stack shape).

PR 18 cut the depth of earlier paths so that the script, with phases 33-36,
stays well inside its time limit: the forward paths (phases 4, 12, 16, 20,
22, 24 and 31) run 10,000 steps where they ran 20,000, and phase 30's
factored network 4,000 steps where it ran 10,000; no width changed.

Each phase prints one JSON line; then come the ``kernels`` line, the card's
nvidia-smi line and, last, the contract line.  Any failed check raises and
the script exits non-zero.  Without a CUDA device it exits 2 and prints
nothing on stdout.
"""

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N = 10_000
DT = 1e-4
STEPS = 10_000  # 20,000 until PR 18 (the time limit; see the module docstring)
PLAIN_STEPS = 2_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
INT8_OPS = 1979e12  # H100 SXM data sheet, int8 (the int4 weights multiply as int8 bytes)
BF16_FLOPS = 989e12  # H100 SXM data sheet, bf16 x bf16 with f32 sums, dense


def peak_flops(w_dtype) -> float:
    """The card's peak for products whose operands are ``w_dtype``: a bf16 W
    multiplies bf16-rounded sources (bf16 peak), a float32 one runs at the
    float32 peak outside the tensor cores."""
    return BF16_FLOPS if w_dtype == torch.bfloat16 else F32_FLOPS
F64_FLOPS = 34e12  # H100 SXM data sheet, float64 outside the tensor cores
QIF_SFA = "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa"
QIF = "rectipy_tpu_torch.models.spiking_neurons.qif.qif"
LIF = "rectipy_tpu_torch.models.spiking_neurons.lif.lif"
TANH = "rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh"
KERNEL_SOURCE = "rectipy_tpu_torch/csrc/qif_sfa_step.cu"
TPU_KERNEL = "rectipy_tpu/ops/kernels.py:53"
SOURCES = ("qif_sfa_step", "int8_matvec", "adam_requant", "int4_matvec", "block_int8")
GENERIC_SOURCE = "rectipy_tpu_torch/csrc/generic_fused_step.cuh"
GENERIC_TPU_KERNEL = "rectipy_tpu/ops/generic_fused.py:46"
I4_SOURCE = "rectipy_tpu_torch/csrc/int4_matvec.cu"
I4_TPU_KERNEL = "benchmarks/i4pack_microbench.py:54"
N_I4PACK = 14_336  # i4pack_microbench.py's default N
CPU_STEPS = 200  # the int4 path's CPU comparison window
# the training path: bench.py:331-370
T_TRAIN, DT_TRAIN, EPOCHS, LR = 500, 5e-3, 16, 1e-4
WARM_EPOCHS = 2  # the warm fit of the int8_master and int4_master paths
SPLIT_VS_FUSED_RTOL = 1e-4
T_TBPTT, UPDATE_STEPS = 2_000, 100  # the step-mode path: bench data tiled, the JAX default
RIDGE_SAMPLING = 10
# kernel vs plain on the card, (rtol, atol), for the two input cases of the
# kernel check; W is the main path's in both.  Both W types take the same
# tolerance: f32 does the same f32 arithmetic, summed in another order over
# 10,000 terms; bf16 sums exact products of bf16 values in f32 (s is rounded
# to bf16 on both sides), so only the order differs there too.
# - "reset": v spread across the threshold, to hold the reset mask and the
#   epilogue.  Here the coupling adds only dt*k*s_in ~ 7.5e-4 to a v' of
#   order 100, so this case cannot see a wrong matvec.
# - "coupling": k = 1/dt and v, eta, x, inp of order 1e-3, all below the
#   threshold, so v' = s_in + O(1e-3) with s_in ~ 0.5 (a row-normalised W
#   averages s).  The tolerance on v' is then 1e-6 + 1e-5*|v'| ~ 6e-6 on
#   s_in, 1.2e-5 of it; one term of a row averages 5e-4 (a W entry is 1e-3),
#   and the check asserts that losing every eighth term fails on every row.
TOL = {"reset": (1e-5, 1e-4), "coupling": (1e-5, 1e-6)}
# The generic kernel is held to rectipy_tpu_torch.testing.GENERIC_TOL, which
# the GPU tests share: "reset" (rtol 1e-5, atol 1e-5 of each output row's
# largest entry), because the f32 sums run in another order and nvcc
# contracts a*b + c into FMAs in the tail and the update where the plain
# version rounds the product first (a few ulps of values up to ~1e4);
# "coupling" (rtol 1e-5, atol 1e-6) on the qif_sfa inputs where v' = s_in +
# O(1e-3), as TOL["coupling"] above, held to a lost-eighth margin above 1.


T_START = time.perf_counter()


def emit(obj):
    if "phase" in obj:  # the script's elapsed seconds, for its time budget
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def quant_scales_phase(dev) -> None:
    """Phase 29: every quantization scale of the port, with its integers,
    on the card against the CPU bit for bit, on rows where a product by the
    reciprocal of 7 or 127 parts from the division; and the rows where the
    card's division by the Python scalar parts from the CPU's."""
    from rectipy_tpu_torch.testing import quant_scales, reciprocal_rows

    w = torch.as_tensor(reciprocal_rows())
    card, cpu = quant_scales(w.to(dev)), quant_scales(w)
    equal = {name: all(torch.equal(got.cpu(), want) for got, want in zip(card[name], ref))
             for name, ref in cpu.items()}
    amax = torch.clamp_min(w.abs().amax(dim=-1), 1e-30)
    scalar_differs = {str(d): int(((amax.to(dev) / d).cpu() != amax / d).sum())
                      for d in (7.0, 127.0)}
    emit({"phase": "quant_scales_exact", "rows": int(w.shape[0]), "n": int(w.shape[1]),
          "bit_identical": equal, "python_scalar_division_rows_differ": scalar_differs})
    if not all(equal.values()):
        raise AssertionError(f"quantization scales differ between the card and the CPU: {equal}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def clock_and_power(fn, seconds: float = 1.5) -> dict:
    """The SM clock (MHz) and board power (W), medians of nvidia-smi's
    samples every 50 ms over the last three quarters of ``seconds`` of
    back-to-back calls of ``fn``: whether a kernel runs at the card's full
    clock or at its power limit."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=60)[0]
    rows = [[float(v) for v in line.split(",")] for line in text.splitlines() if line.strip()]
    rows = rows[len(rows) // 4:]
    if not rows:
        raise AssertionError("nvidia-smi gave no clock samples")
    return {"sm_clock_mhz": float(np.median([r[0] for r in rows])),
            "power_w": float(np.median([r[1] for r in rows])), "samples": len(rows)}


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls.

    The card first spins for ~0.1 s while the host queues every call, so the
    events time the device work alone, not the host's launch rate.  The
    calls must fit the device's launch queue (about a thousand kernels), or
    the host blocks until the spin ends."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the spin ended before the host had queued the timed calls")
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_inputs(steps: int) -> np.ndarray:
    inp = np.zeros((steps, 1), dtype=np.float32)
    inp[steps // 4: 3 * steps // 4, 0] = 3.0
    return inp


def bench_training_data(n: int):
    """bench.py's north-star training data (bench.py:334-338), seed 2."""
    rng = np.random.default_rng(2)
    W = (rng.random((n, n)) < 0.1) * (1.0 / (0.1 * n))
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    inp = rng.normal(size=(T_TRAIN, n))
    tgt = rng.normal(size=(T_TRAIN, n))
    return W, etas, inp, tgt


def build_train_net(W, etas, device=None, coupling="int8_master"):
    from rectipy_tpu_torch import Network

    net = Network(DT_TRAIN, device=device)  # default: the current CUDA device; float32
    net.add_diffeq_node("qif", QIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_op", spike_var="spike",
                        spike_def="v", spike_threshold=1e2, spike_reset=-1e2,
                        node_vars={"all/qif_op/eta": etas}, coupling_dtype=coupling,
                        train_params=["weights"])
    net.compile()
    return net


def fit(net, inp_d, tgt_d, epochs: int, mode: str):
    """One fit_bptt of ``epochs`` epochs; returns (seconds, losses)."""
    os.environ["RECTIPY_FUSED_ADAM"] = mode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = net.fit_bptt([inp_d] * epochs, [tgt_d] * epochs, optimizer="adam", lr=LR,
                       verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in obs["epoch_loss"]]
    if len(losses) != epochs or not np.all(np.isfinite(losses)):
        raise AssertionError(f"fit_bptt ({mode}): bad losses {losses}")
    return seconds, losses


def profile_device_time(fn):
    """(device busy ms, top device ops) of one call of ``fn`` under
    torch.profiler; (None, reason) when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, fills): a CPU op that
        # launches a kernel through ctypes also reports that kernel's time
        # as its own "self" device time, which would count it twice
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    if not rows:
        return None, "torch.profiler recorded no device time"
    rows.sort(key=lambda r: -r[1])
    top = [{"op": k[:80], "ms": us / 1e3, "count": c} for k, us, c in rows[:12]]
    return sum(r[1] for r in rows) / 1e3, top


def train_phases(dev, data) -> tuple:
    """Phases 7-10: the training path and its three kernels, on
    ``bench_training_data``'s ``data`` (and the seconds it took to make).
    Returns their entries of the ``kernels`` line and the path's trained
    neuron-updates/s."""
    from rectipy_tpu_torch.ops import bptt
    from rectipy_tpu_torch.ops.fused_opt import (adam_requant, adam_requant_plain,
                                                 bias_corrections)
    from rectipy_tpu_torch.ops.quant import (int8_dot_plain, int8_dot_t_plain, int8_mv,
                                             int8_mv_t, quant_vec, quantize_rows)

    from rectipy_tpu_torch.testing import ADAM_KW, ADAM_RTOL, adam_inputs, check_adam_requant

    W_np, etas, inp, tgt, data_s = data

    # ------------------------------------------------ 7. train kernel check
    W = torch.as_tensor(W_np, dtype=torch.float32, device=dev)
    wq, ws = quantize_rows(W)
    gen = torch.Generator(device=dev).manual_seed(3)
    xq, xs = quant_vec(torch.randn(N, generator=gen, device=dev))
    vq, vs = quant_vec(torch.randn(N, generator=gen, device=dev) * 1e-3)
    mv, mv_ref = int8_mv(wq, xq, ws, xs), (int8_dot_plain(wq, xq) * ws) * xs
    mv_t, mv_t_ref = int8_mv_t(wq, vq, vs), int8_dot_t_plain(wq, vq) * vs
    torch.cuda.synchronize()
    if not (torch.equal(mv, mv_ref) and torch.equal(mv_t, mv_t_ref)):
        raise AssertionError("an int8 matvec kernel differs from its plain version")
    if not (bool((mv != 0).any()) and bool((mv_t != 0).any())):
        raise AssertionError("the int8 check is vacuous: all outputs are zero")
    emit({"phase": "train_kernel_check", "kernel": "int8_mv/int8_mv_t", "n": N,
          "bit_identical": True, "wq_nonzero": int((wq != 0).sum()), "data_s": data_s})
    adam_err = 0.0
    for count in (1, 7):
        w, m, v, g, bc1, bc2, lr = adam_inputs(N, N, count, 5, dev)
        got = adam_requant(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
        torch.cuda.synchronize()
        ref = adam_requant_plain(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
        rel, at_boundary, margin = check_adam_requant(got, ref, w)
        err = max(float((a - b).abs().max()) for a, b in zip(got[:3] + (got[4],),
                                                              ref[:3] + (ref[4],)))
        adam_err = max(adam_err, err)
        emit({"phase": "train_kernel_check", "kernel": "adam_requant", "shape": [N, N],
              "count": count, "max_abs_err": err, "max_rel_err": rel, "rtol": ADAM_RTOL,
              "wq_differ": int((got[3] != ref[3]).sum()), "wq_at_rounding_boundary": at_boundary,
              "min_update_over_tolerance": margin})
        del got, ref, w, m, v, g
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 8. train path
    inp_d = torch.as_tensor(inp, dtype=torch.float32, device=dev)
    tgt_d = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    net = build_train_net(W_np, etas)
    build_s = time.perf_counter() - t0
    # a short warm fit, then one timed fit (the run's time limit)
    warm_s, warm_losses = fit(net, inp_d, tgt_d, WARM_EPOCHS, "on")
    torch.cuda.reset_peak_memory_stats()
    int8_mv.launches = int8_mv_t.launches = adam_requant.launches = 0
    seconds, losses = fit(net, inp_d, tgt_d, EPOCHS, "on")
    launches = {"adam_requant": adam_requant.launches, "int8_mv": int8_mv.launches,
                "int8_mv_t": int8_mv_t.launches}
    want = {"adam_requant": EPOCHS, "int8_mv": EPOCHS * T_TRAIN, "int8_mv_t": EPOCHS * T_TRAIN}
    if launches != want:
        raise AssertionError(f"launch counts {launches}; expected {want}")
    if net.last_fit != {"trajectory": "chain", "fused_adam": True}:
        raise AssertionError(f"the fit did not take the fused path: {net.last_fit}")
    best = seconds / EPOCHS
    emit({"phase": "train_path", "n": N, "T": T_TRAIN, "epochs": EPOCHS, "coupling": "int8_master",
          "fused_adam": "on", "build_s": build_s, "warm_fit_s": warm_s,
          "warm_epochs": WARM_EPOCHS, "fit_s": seconds, "ms_per_epoch": best * 1e3,
          "trained_neuron_updates_per_s": T_TRAIN * N / best, "launches_per_fit": launches,
          "first_loss": warm_losses[0], "last_loss": losses[-1], "losses_timed_fit": losses,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    # ----------------------------------------------- 9. split vs fused
    del net
    torch.cuda.empty_cache()
    sv = {}
    for mode in ("off", "on"):
        net = build_train_net(W_np, etas)
        seconds, losses = fit(net, inp_d, tgt_d, 4, mode)
        sv[mode] = (seconds / 4, losses)
        del net
        torch.cuda.empty_cache()
    l_off, l_fused = np.asarray(sv["off"][1]), np.asarray(sv["on"][1])
    if l_off[0] != l_fused[0]:
        raise AssertionError(f"epoch 0 losses differ: {l_off[0]} vs {l_fused[0]}")
    dev_rel = float(np.max(np.abs(l_fused - l_off) / np.abs(l_off)))
    if dev_rel > SPLIT_VS_FUSED_RTOL:
        raise AssertionError(f"split vs fused losses differ by {dev_rel} (rtol "
                             f"{SPLIT_VS_FUSED_RTOL})")
    emit({"phase": "train_split_vs_fused", "epochs": 4, "losses_off": list(l_off),
          "losses_on": list(l_fused), "max_rel_deviation": dev_rel,
          "rtol": SPLIT_VS_FUSED_RTOL, "ms_per_epoch_off": sv["off"][0] * 1e3,
          "ms_per_epoch_on": sv["on"][0] * 1e3})

    # ------------------------------------------------------ 10. timing
    net = build_train_net(W_np, etas)
    node = net.get_node("qif")
    traj_p, wkeys, preps = bptt.make_coupled_traj_prepped(node)
    p = bptt._node_pieces(node)
    args = {k: v for k, v in node.args.items() if k not in wkeys}
    Wm = node.args["weights"]
    wp = (preps[0](Wm),)
    y0 = node.y
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    # the epoch as fit_bptt runs it: the trajectory's forward, then its
    # backward (the reverse loop and the dW matmul) called by the autograd
    # engine; the dW matmul is timed again alone at the same shapes, and the
    # optimizer tail is the fused kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W_leaf = Wm.detach().requires_grad_(True)
    with torch.enable_grad():
        ev[0].record()
        _, outs = traj_p(wp, {"weights": W_leaf}, args, y0, inp_d)
        ev[1].record()
        (gW,) = torch.autograd.grad(torch.mean((outs - tgt_d) ** 2), W_leaf)
        ev[2].record()
    deltas = torch.randn((T_TRAIN, N), device=dev)
    ev[3].record()
    p.grad_ws[0](deltas, deltas)
    ev[4].record()
    bc1, bc2 = bias_corrections(1, 0.9, 0.999)
    zeros = torch.zeros_like(Wm)
    adam_requant(Wm, zeros, zeros, gW, bc1, bc2, LR, **ADAM_KW)
    ev[5].record()
    torch.cuda.synchronize()
    split_wall_s = time.perf_counter() - t0
    fwd, bwd_all, dw = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                        ev[3].elapsed_time(ev[4]))
    parts = [fwd, bwd_all - dw, dw, ev[4].elapsed_time(ev[5])]
    del outs, gW, deltas, zeros
    busy_ms, top = profile_device_time(lambda: fit(net, inp_d, tgt_d, 1, "on"))
    epoch_ms = best * 1e3
    emit({"phase": "train_timing_top_device_ops", "top": top})
    emit({"phase": "train_timing", "epoch_split_ms": dict(zip(
        ("forward_loop", "backward_loop", "dW_matmul", "optimizer_tail"), parts)),
        "split_wall_s": split_wall_s, "profiled_device_busy_ms": busy_ms,
        "ms_per_epoch": epoch_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / epoch_ms})

    # per-kernel times at the training shapes
    w, m, v, g, bc1, bc2, lr = adam_inputs(N, N, 7, 5, dev)
    entries = []
    specs = [
        ("int8_mv", "rectipy_tpu_torch/csrc/int8_matvec.cu", "rectipy_tpu/ops/quant.py:65",
         lambda: int8_mv(wq, xq, ws, xs), lambda: (int8_dot_plain(wq, xq) * ws) * xs,
         N * N + N + 4 * N + 4 + 4 * N, 2 * N * N + 2 * N, INT8_OPS, 0.0),
        ("int8_mv_t", "rectipy_tpu_torch/csrc/int8_matvec.cu", "rectipy_tpu/ops/quant.py:73",
         lambda: int8_mv_t(wq, vq, vs), lambda: int8_dot_t_plain(wq, vq) * vs,
         N * N + N + 4 + 4 * N, 2 * N * N + N, INT8_OPS, 0.0),
        ("adam_requant", "rectipy_tpu_torch/csrc/adam_requant.cu",
         "rectipy_tpu/ops/fused_opt.py:88",
         lambda: adam_requant(w, m, v, g, bc1, bc2, lr, **ADAM_KW),
         lambda: adam_requant_plain(w, m, v, g, bc1, bc2, lr, **ADAM_KW),
         29 * N * N + 4 * N, 15 * N * N + 3 * N, F32_FLOPS, adam_err),
    ]
    # the int8 rows' yardstick: torch._int_mm (int8 x int8 -> int32, which
    # needs more than 16 rows) of the activations padded to 17 rows with the
    # same int8 W, column-major as cuBLASLt takes it (W.T is a view; W for
    # the transposed product is a copy); it gives the int32 sums without the
    # scales, so it is not the same function
    int_mm = {"int8_mv": (xq.expand(17, N).contiguous(), wq.T),
              "int8_mv_t": (vq.expand(17, N).contiguous(), wq.T.contiguous().T)}
    for name, source, replaces, fn, plain, n_bytes, n_ops, peak, err in specs:
        ms = cuda_ms(fn, reps=50 if name == "adam_requant" else 200)
        plain_ms = cuda_ms(plain, reps=5)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
        library_ms, reason = None, "no single PyTorch call computes this function"
        if name in int_mm:
            a, b = int_mm[name]
            try:
                torch._int_mm(a, b)
                library_ms = cuda_ms(lambda: torch._int_mm(a, b), reps=200)
                reason = ("torch._int_mm of the activations padded to 17 rows with the same "
                          "int8 W: int32 sums without the scales, a yardstick")
            except RuntimeError as e:
                reason = f"torch._int_mm refused the shape: {str(e)[:200]}"
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": library_ms}
        entries.append(entry)
        emit({"phase": "train_timing", **entry, "bytes": n_bytes, "ops": n_ops,
              "launches_per_epoch": launches[name] // EPOCHS, "library_ms_reason": reason,
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
    del int_mm
    return entries, T_TRAIN * N / best


def lif_net(n: int, device, coupling_dtype: str = "bfloat16"):
    """examples/fused_kernels.py's network at width n: a LIF SpikeResetNet
    with a coupling W = |normal| * 0.5/n (bf16 unless ``coupling_dtype``
    says otherwise; the kernel takes the node's coupling dtype) and
    per-neuron tau ~ U(10, 15) from seed 0, eta 10, tau_s 5, threshold
    +-10, dt 1e-2; the generic kernel attached."""
    from rectipy_tpu_torch import Network, attach_generic_fused_step

    rng = np.random.default_rng(0)
    W = np.abs(rng.normal(size=(n, n))) * (0.5 / n)
    tau = rng.uniform(10.0, 15.0, size=n)
    net = Network(1e-2, device=device)
    net.add_diffeq_node("lif", LIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="lif_op", spike_var="spike",
                        reset_var="v", spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"eta": 10.0, "tau": tau, "tau_s": 5.0},
                        coupling_dtype=coupling_dtype)
    net.compile()
    attach_generic_fused_step(net.get_node("lif"))
    return net


def ei_net(n: int, device):
    """examples/ei_circuit_multi_coupling.py's circuit at width n: a tanh
    leaky integrator population with two f32 couplings into li_op/r_in,
    excitatory (fixed fan-in 10%, rows summing to 2) and inhibitory
    (-|normal| * 1.5/n), from seed 0, built through CircuitTemplate; the
    generic kernel attached.  Returns (net, seconds making W, seconds
    building the network)."""
    from rectipy_tpu_torch import (CircuitTemplate, Network, NodeTemplate,
                                   attach_generic_fused_step, random_connectivity)

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    W_exc = random_connectivity(n, n, 0.1, normalize=True, rng=rng) * 2.0
    W_inh = -np.abs(rng.normal(size=(n, n))) * (1.5 / n)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmpl = NodeTemplate.from_yaml(TANH)
    circuit = CircuitTemplate("ei", {f"p{i}": tmpl for i in range(n)})
    circuit.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W_exc)
    circuit.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W_inh)
    net = Network(1e-2, device=device)
    net.add_diffeq_node("ei", circuit, input_var="li_op/I_ext", output_var="tanh_op/r")
    net.compile()
    attach_generic_fused_step(net.get_node("ei"))
    return net, data_s, time.perf_counter() - t0


def generic_sources() -> list:
    """The generated source of every generic-kernel network of this script,
    from the same builders on CPU tensors at n = 16 (the source depends on
    the template, the node class and which parameters are per-neuron, not on
    n), so that the build phase compiles them beside the csrc/ sources."""
    from rectipy_tpu_torch.testing import GENERIC_CASES, generic_case_net

    W = np.full((16, 16), 1.0 / 16)
    nodes = [generic_case_net(case, W, "cpu")[1] for case in GENERIC_CASES]
    nodes += [lif_net(16, "cpu").get_node("lif"), ei_net(16, "cpu")[0].get_node("ei"),
              feedback_net(16, "cpu").get_node("p1")]
    return sorted({node._fused_cfg["step"].source for node in nodes})


def tail_ops(program) -> int:
    """Arithmetic operations and function calls of one neuron's tail."""
    def count(ast) -> int:
        if ast[0] in ("num", "var"):
            return 0
        if ast[0] == "neg":
            return 1 + count(ast[1])
        if ast[0] == "bin":
            return 1 + count(ast[2]) + count(ast[3])
        return 1 + sum(count(a) for a in ast[2])

    # each input placeholder adds its wiring and its external slot
    return (sum(count(ast) for ast, _ in program.algebraic.values())
            + sum(count(ast) for _, ast, _ in program.odes) + 2 * len(program.input_defaults))


def generic_instance(name: str, node, w_dtype, seed: int, launches: int, case: str = "reset",
                     report: dict = None):
    """Hold one instance of the generic kernel (a node's attached step, W in
    w_dtype) to its plain version on inputs from ``generic_inputs`` (see
    GENERIC_TOL), then time it: the kernel, the plain version and torch.mv
    of the same W (the matvecs alone).  Prints one ``generic_timing`` line
    and returns the instance's ``kernels`` entry (the coupling case is
    checked only, and returns None)."""
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step, generic_fused_step_plain
    from rectipy_tpu_torch.testing import (GENERIC_TOL, check_generic, generic_inputs,
                                           lost_eighth_margin)

    step, srcs, drive, states, vecs = generic_inputs(node, seed, coupling=case == "coupling")
    K, V, n = len(step.targets), len(step.state_order), node._fused_cfg["n"]
    Ws = [node.args[f"__w_fused_{c}__"].to(w_dtype) for c in range(K)]
    before = generic_fused_step.launches
    got = generic_fused_step(step, srcs, Ws, drive, states, vecs)
    torch.cuda.synchronize()
    if generic_fused_step.launches != before + 1:
        raise AssertionError(f"{name}: the kernel check did not launch the kernel")
    ref = generic_fused_step_plain(step, srcs, Ws, drive, states, vecs)
    err, resets = check_generic(got, ref, step, case)
    rtol, atol = GENERIC_TOL[case]
    line = {"phase": "generic_kernel_check", "instance": name, "case": case, "n": n,
            "max_abs_err": err, "rtol": rtol,
            "atol": atol if case == "coupling" else f"{atol} x row max",
            "reset_neurons": resets, **(report or {})}
    hard = any(h for _, _, h, _ in step.spike_specs) and not step.derivative
    if case == "reset" and hard and resets == 0:
        raise AssertionError(f"{name}: no neuron was reset")
    if case == "coupling":
        margin = lost_eighth_margin(step, srcs, Ws, drive, states, vecs, ref)
        if resets or margin <= 1.0:
            raise AssertionError(f"{name}: the coupling case reset neurons or would pass a "
                                 f"lost eighth of the row sums (margin {margin})")
        line["lost_eighth_min_margin"] = margin
    emit(line)
    if case == "coupling":
        return None
    ms = cuda_ms(lambda: generic_fused_step(step, srcs, Ws, drive, states, vecs), reps=200)
    plain_ms = cuda_ms(lambda: generic_fused_step_plain(step, srcs, Ws, drive, states, vecs),
                       reps=10)
    s_w = [s.to(w_dtype) for s in srcs]
    library_ms = cuda_ms(lambda: [torch.mv(W, s) for W, s in zip(Ws, s_w)], reps=200)
    # W once, the K sources, drive, V states and P per-neuron rows in, V rows out
    n_bytes = K * n * n * Ws[0].element_size() + 4 * n * (K + 1 + 2 * V + len(vecs))
    n_ops = 2 * K * n * n + n * tail_ops(node._vf.tile_program)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_flops(w_dtype)
    entry = {"name": f"generic_fused_step[{name}]", "route": "cuda", "source": GENERIC_SOURCE,
             "replaces": GENERIC_TPU_KERNEL, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
    emit({"phase": "generic_timing", **entry, "bytes": n_bytes, "ops": n_ops,
          "library_call": f"torch.mv x {K} (the matvecs alone)",
          "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
    return entry


def device_step_ms(net, x, reps: int = 50) -> float:
    """The network's whole step with input ``x`` timed on the device alone
    (no host gaps), as phase 6 times the main path's, on the parameters as
    ``Network.run`` preps them; ``reps`` steps, so that the host queues them
    within cuda_ms's spin even at 1 ms of host time each.  A plain lowered
    step (no fused kernel) launches about 75 kernels: 8 steps keep it within
    the launch queue."""
    step = net.make_step()
    state, params = net.init_state(), net._prep_params(net.parameters_pytree())
    with torch.no_grad():
        return cuda_ms(lambda: step(state, params, x), reps=reps)


def generic_phases(W_np, build_net, spec_net) -> list:
    """Phases 11-14: the generic fused step.  ``W_np`` is the main path's
    coupling, ``build_net`` builds the main path's network and ``spec_net``
    is its bf16 network with the specialized kernel.  Returns the entries of
    the ``kernels`` line: one per instance a path ran."""
    from rectipy_tpu_torch import attach_generic_fused_step
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step
    from rectipy_tpu_torch.testing import GENERIC_CASES, generic_case_net

    dev = torch.device("cuda", 0)
    # ------------------------------------------- 11. generic kernel check
    # every node class and mode at N with the main path's coupling, the
    # kernel in f32 and in bf16 W; timed per instance (phase generic_timing)
    for case in GENERIC_CASES:
        t0 = time.perf_counter()
        _, node = generic_case_net(case, W_np, dev)
        build_s = time.perf_counter() - t0
        for w_name, w_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            generic_instance(f"{case},{w_name}", node, w_dtype, 11, 0,
                             report={"build_s": build_s})
            if case == "qif_sfa":
                generic_instance(f"{case},{w_name}", node, w_dtype, 12, 0, case="coupling")
        del node
        torch.cuda.empty_cache()
    entries = []

    # --------------------------------------------------- 12. generic path
    t0 = time.perf_counter()
    net = lif_net(N, None)
    build_s = time.perf_counter() - t0
    run_kw = dict(record_output=False, record_vars=[("lif", "s", True)], sampling_steps=100,
                  verbose=False)
    inputs = np.zeros((STEPS, 1), dtype=np.float32)  # the example's zero drive, broadcast
    generic_fused_step.launches = 0
    t0 = time.perf_counter()
    obs = net.run(inputs, **run_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = generic_fused_step.launches
    if launches != STEPS:
        raise AssertionError(f"generic_path: {launches} kernel launches for {STEPS} steps")
    rec = obs.to_numpy(("lif", "s"))
    if rec.shape != (STEPS // 100,) or not np.all(np.isfinite(rec)) or not rec.max() > 0.0:
        raise AssertionError(f"generic_path: bad records (shape {rec.shape}, max {rec.max()})")
    times = []
    for _ in range(3):
        net.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = net.run(inputs, **run_kw).to_numpy(("lif", "s"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not np.all(np.isfinite(rec)):
            raise AssertionError("generic_path: non-finite records in a timed run")
    best = min(times)
    dev_ms = device_step_ms(net, torch.zeros(1, device=net.device))
    emit({"phase": "generic_path", "template": "lif", "coupling": "bfloat16", "n": N,
          "steps": STEPS, "kernel_launches": launches, "build_s": build_s,
          "first_run_s": first_s, "run_s": times, "best_s": best,
          "ms_per_step": best / STEPS * 1e3, "neuron_updates_per_s": STEPS * N / best,
          "device_step_ms": dev_ms, "device_idle_share": 1.0 - dev_ms / (best / STEPS * 1e3),
          "mean_s_range": [float(rec.min()), float(rec.max())]})
    entries.append(generic_instance("lif,bfloat16,generic_path", net.get_node("lif"),
                                    torch.bfloat16, 13, launches))
    del net, obs
    torch.cuda.empty_cache()

    # ------------------------------------------ 13. generic vs specialized
    t0 = time.perf_counter()
    gen_net = build_net("bfloat16", fused=False)
    attach_generic_fused_step(gen_net.get_node("qif"))
    build_s = time.perf_counter() - t0
    cmp_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=10,
                  verbose=False)
    short = bench_inputs(PLAIN_STEPS)
    recs, secs, counts = {}, {"specialized": [], "generic": []}, {}
    for name, net in (("specialized", spec_net), ("generic", gen_net), ("generic", gen_net),
                      ("specialized", spec_net)):
        net.reset()
        qif_sfa_step.launches = generic_fused_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = net.run(short, **cmp_kw).to_numpy(("qif", "s"))
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        recs.setdefault(name, rec)
        counts[name] = (qif_sfa_step.launches, generic_fused_step.launches)
    if counts != {"specialized": (PLAIN_STEPS, 0), "generic": (0, PLAIN_STEPS)}:
        raise AssertionError(f"generic_vs_specialized: launches (qif_sfa_step, "
                             f"generic_fused_step) {counts}")
    ref, got = recs["specialized"], recs["generic"]
    max_diff = float(np.abs(got - ref).max())
    corr = float(np.corrcoef(got, ref)[0, 1]) if ref.std() > 0 else float("nan")
    if not (corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(ref).max())):
        raise AssertionError(f"generic vs specialized: corr {corr}, max|diff| {max_diff}")
    emit({"phase": "generic_vs_specialized", "coupling": "bfloat16", "n": N,
          "steps": PLAIN_STEPS, "records": int(ref.shape[0]), "corr": corr,
          "max_abs_diff": max_diff, "max_abs_ref": float(np.abs(ref).max()),
          "build_s": build_s, "run_s": secs,
          "ms_per_step": {k: min(v) / PLAIN_STEPS * 1e3 for k, v in secs.items()}})
    entries.append(generic_instance("qif_sfa,bfloat16,generic_vs_specialized",
                                    gen_net.get_node("qif"), torch.bfloat16, 14, PLAIN_STEPS))
    del gen_net
    torch.cuda.empty_cache()

    # ------------------------------------------------- 14. generic E/I path
    net, data_s, build_s = ei_net(N, None)
    inp = (np.random.default_rng(1).normal(size=(PLAIN_STEPS, N)) * 0.1).astype(np.float32)
    ei_kw = dict(record_output=True, sampling_steps=20, verbose=False)
    runs = []
    for _ in range(2):
        net.reset()
        generic_fused_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.run(inp, **ei_kw).to_numpy("out")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        launches = generic_fused_step.launches
        if launches != PLAIN_STEPS:
            raise AssertionError(f"generic_ei_path: {launches} launches for {PLAIN_STEPS} steps")
        if out.shape != (PLAIN_STEPS // 20, N) or not np.all(np.isfinite(out)):
            raise AssertionError(f"generic_ei_path: bad records, shape {out.shape}")
    dev_ms = device_step_ms(net, torch.as_tensor(inp[0], device=net.device))
    emit({"phase": "generic_ei_path", "couplings": 2, "coupling": "float32", "n": N,
          "steps": PLAIN_STEPS, "kernel_launches": launches, "w_data_s": data_s,
          "build_s": build_s, "run_s": runs, "ms_per_step": min(runs) / PLAIN_STEPS * 1e3,
          "device_step_ms": dev_ms,
          "device_idle_share": 1.0 - dev_ms / (min(runs) / PLAIN_STEPS * 1e3),
          "neuron_updates_per_s": PLAIN_STEPS * N / min(runs),
          "rate_range": [float(out.min()), float(out.max())],
          "mean_abs_rate": float(np.abs(out).mean())})
    entries.append(generic_instance("ei,float32,generic_ei_path", net.get_node("ei"),
                                    torch.float32, 15, launches))
    del net
    torch.cuda.empty_cache()
    return entries


def int4_check(case: str, wp, ws, xq, xs, vq, vs, n_in: int, exact=None,
               report: dict = None) -> dict:
    """Hold int4_mv and int4_mv_t on (wp, ...) to their plain versions on the
    card, bit for bit (integer sums are exact in any order), and, where
    ``exact`` gives the float64 products ``(W @ xq, W.T @ vq)``, to those.
    Prints one ``int4_kernel_check`` line and returns it."""
    from rectipy_tpu_torch.ops.quant import (int4_dot_plain, int4_dot_t_plain, int4_mv,
                                             int4_mv_t, int4_vector_path)

    before = (int4_mv.launches, int4_mv_t.launches)
    out, out_t = int4_mv(wp, xq, ws, xs), int4_mv_t(wp, vq, vs, n_in)
    torch.cuda.synchronize()
    if (int4_mv.launches, int4_mv_t.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"int4_kernel_check ({case}): the kernels were not launched")
    ref, ref_t = (int4_dot_plain(wp, xq) * ws) * xs, int4_dot_t_plain(wp, vq, n_in) * vs
    if not (torch.equal(out, ref) and torch.equal(out_t, ref_t)):
        raise AssertionError(f"int4_kernel_check ({case}): a kernel differs from its plain "
                             f"version")
    if not (bool((out != 0).any()) and bool((out_t != 0).any())):
        raise AssertionError(f"int4_kernel_check ({case}): vacuous, all outputs are zero")
    line = {"phase": "int4_kernel_check", "case": case, "shape": [int(wp.shape[0]), n_in],
            "row_bytes": int(wp.shape[1]),
            "path": "vector" if int4_vector_path(wp, xq) else "scalar",
            "bit_identical_to_plain": True, **(report or {})}
    if exact is not None:
        same = (torch.equal(out.double(), exact[0]) and torch.equal(out_t.double(), exact[1]))
        if not same:
            raise AssertionError(f"int4_kernel_check ({case}): not equal to the float64 product")
        line["equal_to_float64_product"] = True
    emit(line)
    return line


def int4_phases(W_np, build_net) -> tuple:
    """Phases 15-17: the int4 kernels against their plain versions, the int4
    path (the main path's network with coupling_dtype="int4", in turns with
    "int8"), and their timing.  Returns (the int4_mv entry of the ``kernels``
    line, the N=10,000 timing of int4_mv_t for the training path's entry)."""
    from rectipy_tpu_torch.ops.quant import (int4_dot_plain, int4_dot_t_plain, int4_mv,
                                             int4_mv_t, int8_mv, int8_mv_t, pack_int4,
                                             quant_vec, unpack_int4)

    dev = torch.device("cuda", 0)
    # --------------------------------------------- 15. int4 kernel check
    # (a) the packed W that the int4 path's network made in its own prep
    t0 = time.perf_counter()
    nets = {c: build_net(c, fused=False) for c in ("int4", "int8")}
    build_s = time.perf_counter() - t0
    node = nets["int4"].get_node("qif")
    wp10, ws10 = node.prep_params(node.args)["weights__q4"], node.args["weights__scale"]
    gen = torch.Generator(device=dev).manual_seed(5)
    xq10, xs10 = quant_vec(torch.rand(N, generator=gen, device=dev))  # s-like, in [0, 1]
    vq10, vs10 = quant_vec(torch.randn(N, generator=gen, device=dev))
    int4_check("int4_path_network", wp10, ws10, xq10, xs10, vq10, vs10, N)
    # (b) i4pack_microbench.py:122-131 at its N: weights in [-8, 7] and x in
    # [-127, 127] from seed 0, against x @ wt (and wt @ x) in float64
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    wt = rng.integers(-8, 8, size=(N_I4PACK, N_I4PACK)).astype(np.int8)
    x = rng.integers(-127, 128, size=N_I4PACK).astype(np.int8)
    data_s = time.perf_counter() - t0
    w14 = torch.as_tensor(wt).to(dev).T.contiguous()  # row j of W = column j of wt
    del wt
    wp14, x14 = pack_int4(w14), torch.as_tensor(x).to(dev)
    w64, x64 = w14.double(), x14.double()
    exact = (torch.mv(w64, x64), torch.mv(w64.T, x64))
    del w64
    one = torch.ones((), dtype=torch.float32, device=dev)
    ones14 = torch.ones(N_I4PACK, dtype=torch.float32, device=dev)
    int4_check("i4pack_microbench", wp14, ones14, x14, one, x14, one, N_I4PACK, exact=exact,
               report={"data_s": data_s})
    # (c) an odd shape with unpadded rows (500 bytes, off the 16-byte grid):
    # the scalar instantiations
    g = torch.Generator(device=dev).manual_seed(6)
    w_odd = torch.randint(-8, 8, (1001, 999), generator=g, device=dev, dtype=torch.int8)
    wp_odd = pack_int4(w_odd)[:, :500].contiguous()
    xq_o, xs_o = quant_vec(torch.randn(999, generator=g, device=dev))
    vq_o, vs_o = quant_vec(torch.randn(1001, generator=g, device=dev))
    line = int4_check("odd_unpadded", wp_odd, torch.rand(1001, generator=g, device=dev) + 0.5,
                      xq_o, xs_o, vq_o, vs_o, 999)
    if line["path"] != "scalar":
        raise AssertionError("int4_kernel_check (odd_unpadded) did not take the scalar path")

    # ------------------------------------------------------ 16. int4 path
    run_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=100,
                  verbose=False)
    inputs = bench_inputs(STEPS)
    counters = {"int4": int4_mv, "int8": int8_mv}

    def path_run(c):
        int4_mv.launches = int8_mv.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = nets[c].run(inputs, **run_kw).to_numpy(("qif", "s"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        if launches != {k: (STEPS if k == c else 0) for k in counters}:
            raise AssertionError(f"int4_path ({c}): launches {launches} for {STEPS} steps")
        if rec.shape != (STEPS // 100,) or not np.all(np.isfinite(rec)):
            raise AssertionError(f"int4_path ({c}): bad records, shape {rec.shape}")
        return seconds, rec, launches[c]

    runs, recs, launches = {"int4": [], "int8": []}, {}, {}
    # in turns, int4 best of 3 and int8 of 2 (the run's time limit); the
    # kernels were built and run in phase 15
    for c in ("int4", "int8", "int4", "int8", "int4"):
        nets[c].reset()
        seconds, recs[c], launches[c] = path_run(c)
        runs[c].append(seconds)
    corr = float(np.corrcoef(recs["int4"], recs["int8"])[0, 1])
    x_t = torch.full((1,), 3.0, device=dev)
    dev_ms = {c: device_step_ms(nets[c], x_t, reps=8) for c in ("int4", "int8")}
    for c in ("int4", "int8"):
        best = min(runs[c])
        emit({"phase": "int4_path", "coupling": c, "n": N, "steps": STEPS,
              "kernel": counters[c].__name__, "kernel_launches": launches[c],
              "build_s_both": build_s, "run_s": runs[c],
              "best_s": best, "ms_per_step": best / STEPS * 1e3,
              "neuron_updates_per_s": STEPS * N / best, "device_step_ms": dev_ms[c],
              "device_idle_share": 1.0 - dev_ms[c] / (best / STEPS * 1e3),
              "mean_s_range": [float(recs[c].min()), float(recs[c].max())],
              "corr_int4_vs_int8_records": corr})
    # the same int4 network on the CPU over a short window from the card's
    # state after its last run (the population is spiking by then), held to
    # the card's run from that state under fused_vs_plain's rule
    y_end = nets["int4"].get_node("qif").y.detach().cpu().numpy()
    t0 = time.perf_counter()
    cpu_net = build_net("int4", fused=False, device="cpu")
    cpu_build_s = time.perf_counter() - t0
    cmp_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=10,
                  verbose=False)
    short = bench_inputs(CPU_STEPS)
    cmp, cmp_s = {}, {}
    for name, net in (("card", nets["int4"]), ("cpu", cpu_net)):
        net.reset({"qif": y_end})
        t0 = time.perf_counter()
        cmp[name] = net.run(short, **cmp_kw).to_numpy(("qif", "s"))
        cmp_s[name] = time.perf_counter() - t0
    ref, got = cmp["cpu"], cmp["card"]
    max_diff = float(np.abs(got - ref).max())
    cpu_corr = float(np.corrcoef(got, ref)[0, 1]) if ref.std() > 0 else float("nan")
    if not (cpu_corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(ref).max())):
        raise AssertionError(f"int4 card vs cpu: corr {cpu_corr}, max|diff| {max_diff}")
    emit({"phase": "int4_path_vs_cpu", "coupling": "int4", "n": N, "steps": CPU_STEPS,
          "records": int(ref.shape[0]), "records_equal": int((got == ref).sum()),
          "corr": cpu_corr, "max_abs_diff": max_diff,
          "max_abs_ref": float(np.abs(ref).max()), "cpu_build_s": cpu_build_s,
          "card_run_s": cmp_s["card"], "cpu_run_s": cmp_s["cpu"]})
    del cpu_net

    # ---------------------------------------------------- 17. int4 timing
    # per N: int4_mv/int4_mv_t, their plain versions, and int8_mv/int8_mv_t
    # on the same integers (i4pack_microbench.py:170-193's A/B)
    cases = {N: (wp10, ws10, xq10, xs10, vq10, vs10),
             N_I4PACK: (wp14, ones14, x14, one, x14, one)}
    timing = {}
    for n, (wp, ws, xq, xs, vq, vs) in cases.items():
        w_i8 = unpack_int4(wp, n).contiguous()  # the same integers, one per byte
        rows = {}
        for name, fn, plain, i8, i8_bytes, n_bytes in (
                ("int4_mv", lambda: int4_mv(wp, xq, ws, xs),
                 lambda: (int4_dot_plain(wp, xq) * ws) * xs,
                 lambda: int8_mv(w_i8, xq, ws, xs),
                 n * n + 9 * n + 4, n * ((n + 1) // 2) + 9 * n + 4),
                ("int4_mv_t", lambda: int4_mv_t(wp, vq, vs, n),
                 lambda: int4_dot_t_plain(wp, vq, n) * vs,
                 lambda: int8_mv_t(w_i8, vq, vs),
                 n * n + 5 * n + 4, n * ((n + 1) // 2) + 5 * n + 4)):
            ms = cuda_ms(fn, reps=200)
            plain_ms = cuda_ms(plain, reps=5)
            int8_ms = cuda_ms(i8, reps=200)
            n_ops = 2 * n * n
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS
            row = {"name": name, "n": n, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": n_bytes, "ops": n_ops, "achieved_bytes_per_s": n_bytes / (ms * 1e-3),
                   "share_of_bound": max(t_bytes, t_ops) * 1e3 / ms,
                   "int8_yardstick": name.replace("int4", "int8"), "int8_ms": int8_ms,
                   "int8_bytes": i8_bytes, "int8_over_int4": int8_ms / ms,
                   "library_ms": None,
                   "library_ms_reason": "no PyTorch call computes an int4 matvec"}
            rows[name] = row
            emit({"phase": "int4_timing", **row})
        timing[n] = rows
        del w_i8
    path_ms = min(runs["int4"]) / STEPS * 1e3
    emit({"phase": "int4_timing", "int4_path_device_step_ms": dev_ms["int4"],
          "int4_path_ms_per_step": path_ms,
          "int4_path_device_idle_share": 1.0 - dev_ms["int4"] / path_ms,
          "int4_mv_share_of_step": timing[N]["int4_mv"]["ms"] / path_ms})
    del nets, w14, wp14, x14, exact
    torch.cuda.empty_cache()
    r = timing[N]["int4_mv"]
    entry = {"name": "int4_mv[int4_path]", "route": "cuda", "source": I4_SOURCE,
             "replaces": I4_TPU_KERNEL, "launches": launches["int4"], "max_abs_err": 0.0,
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None}
    return entry, timing[N]


def int4_train_phases(dev, data, timing10) -> tuple:
    """Phases 18-19: the training path with an int4_master coupling (one
    warm and one timed 16-epoch fit) and with a bfloat16_master coupling (4
    epochs).  ``timing10`` is phase 17's N=10,000 timing.  Returns the
    int4 kernels' entries of the ``kernels`` line for this path and the
    int4_master fit's trained neuron-updates/s."""
    from rectipy_tpu_torch.ops.fused_opt import adam_requant
    from rectipy_tpu_torch.ops.quant import int4_mv, int4_mv_t, int8_mv, int8_mv_t

    W_np, etas, inp, tgt, _ = data
    inp_d = torch.as_tensor(inp, dtype=torch.float32, device=dev)
    tgt_d = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    kernels = (int4_mv, int4_mv_t, int8_mv, int8_mv_t, adam_requant)

    def counted_fit(net, epochs):
        for k in kernels:
            k.launches = 0
        seconds, losses = fit(net, inp_d, tgt_d, epochs, "on")
        return seconds, losses, {k.__name__: k.launches for k in kernels}

    # -------------------------------------------------- 18. int4_master
    t0 = time.perf_counter()
    net = build_train_net(W_np, etas, coupling="int4_master")
    build_s = time.perf_counter() - t0
    warm_s, warm_losses, _ = counted_fit(net, WARM_EPOCHS)
    seconds, losses, launches = counted_fit(net, EPOCHS)
    want = {"int4_mv": EPOCHS * T_TRAIN, "int4_mv_t": EPOCHS * T_TRAIN, "int8_mv": 0,
            "int8_mv_t": 0, "adam_requant": 0}
    if launches != want:
        raise AssertionError(f"int4_train_path: launches {launches}, expected {want}")
    if net.last_fit != {"trajectory": "chain", "fused_adam": False}:
        raise AssertionError(f"int4_train_path took {net.last_fit}")
    int4_nu = T_TRAIN * N * EPOCHS / seconds
    emit({"phase": "int4_train_path", "n": N, "T": T_TRAIN, "epochs": EPOCHS,
          "coupling": "int4_master", "build_s": build_s, "warm_fit_s": warm_s,
          "warm_epochs": WARM_EPOCHS,
          "fit_s": seconds, "ms_per_epoch": seconds / EPOCHS * 1e3,
          "trained_neuron_updates_per_s": int4_nu,
          "launches_per_fit": launches, "first_loss": warm_losses[0],
          "losses_timed_fit": losses})
    del net
    torch.cuda.empty_cache()

    # ------------------------------------------------ 19. bfloat16_master
    net = build_train_net(W_np, etas, coupling="bfloat16_master")
    seconds, losses, launches = counted_fit(net, 4)
    if any(launches.values()) or net.last_fit["trajectory"] != "chain":
        raise AssertionError(f"bf16_master_train_path: launches {launches}, {net.last_fit}")
    emit({"phase": "bf16_master_train_path", "n": N, "T": T_TRAIN, "epochs": 4,
          "coupling": "bfloat16_master", "fit_s": seconds, "ms_per_epoch": seconds / 4 * 1e3,
          "trained_neuron_updates_per_s": T_TRAIN * N * 4 / seconds, "losses": losses})
    del net
    torch.cuda.empty_cache()
    entries = []
    for name in ("int4_mv", "int4_mv_t"):
        r = timing10[name]
        entries.append({"name": f"{name}[int4_train_path]", "route": "cuda", "source": I4_SOURCE,
                        "replaces": I4_TPU_KERNEL, "launches": want[name], "max_abs_err": 0.0,
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    return entries, int4_nu


def feedback_weights(n: int) -> tuple:
    """examples/feedback_populations.py's weights at width n, drawn from seed 5
    in the example's order: the two populations' couplings (normal), the
    excitatory feedforward edge p1 -> p2 (10 x uniform) and the inhibitory
    feedback edge p2 -> p1 (-100 x uniform); every weight is scaled by 100/n,
    so that a neuron's summed input matches the example's at its n = 100."""
    rng = np.random.default_rng(5)
    scale, k = 100.0 / n, 10.0

    def draw(fn, factor):
        w = fn(size=(n, n))
        w *= factor * scale
        return w.astype(np.float32)

    Ws = [draw(rng.normal, 1.0) for _ in range(2)]
    return Ws[0], Ws[1], draw(rng.random, k), draw(rng.random, -10 * k)


def feedback_net(n: int, device, weights: tuple = None):
    """examples/feedback_populations.py as a FeedbackNetwork at width n: two
    LIF populations (the template's defaults, bf16 couplings) joined by dense
    float32 feedforward and feedback edges (``feedback_weights``); the
    generic kernel attached to both populations."""
    from rectipy_tpu_torch import FeedbackNetwork, attach_generic_fused_step

    W1, W2, W_ff, W_fb = weights if weights is not None else feedback_weights(n)
    net = FeedbackNetwork(1e-2, device=device)
    for label, W in (("p1", W1), ("p2", W2)):
        net.add_diffeq_node(label, LIF, input_var="I_ext", output_var="s", weights=W,
                            source_var="s", target_var="s_in", op="lif_op", spike_var="spike",
                            spike_def="v", coupling_dtype="bfloat16")
    net.add_edge("p1", "p2", weights=W_ff)
    net.add_edge("p2", "p1", weights=W_fb, feedback=True)
    net.compile()
    for label in ("p1", "p2"):
        attach_generic_fused_step(net.get_node(label))
    return net


def vs_cpu(name: str, card: np.ndarray, cpu: np.ndarray) -> dict:
    """fused_vs_plain's rule (correlation >= 0.999, max |diff| <= 1% of the
    largest reference value) on the card's records against the CPU's."""
    max_diff = float(np.abs(card - cpu).max())
    corr = float(np.corrcoef(card.ravel(), cpu.ravel())[0, 1]) if cpu.std() > 0 else float("nan")
    if not (corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(cpu).max())):
        raise AssertionError(f"{name}: card vs cpu corr {corr}, max|diff| {max_diff}")
    return {"corr": corr, "max_abs_diff": max_diff, "max_abs_ref": float(np.abs(cpu).max())}


def readout_phases(build_net, timing: dict) -> list:
    """Phases 20-22: FORCE (fit_rls) and the ridge readout (fit_ridge) on
    the main path's bf16 reservoir, and test().  ``timing`` is phase 6's
    ``qif_sfa_step[bfloat16]`` entry (the same kernel and W).  Returns the
    kernel's entries of the ``kernels`` line for the two paths."""
    from rectipy_tpu_torch.edges import RLS
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step

    inputs = bench_inputs(STEPS)
    target = np.sin(2 * np.pi * 2.0 * DT * np.arange(STEPS))[:, None]

    def with_readout(net):
        net.add_func_node("readout", 1, activation_function="identity")
        return net.add_edge("qif", "readout", train="rls", beta=0.99, alpha=1.0)

    def counted(fn):
        qif_sfa_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, qif_sfa_step.launches

    # ---------------------------------------------------------- 20. rls_path
    t0 = time.perf_counter()
    net = build_net("bfloat16", fused=True)
    edge = with_readout(net)
    build_s = time.perf_counter() - t0
    fit_kw = dict(update_steps=10, sampling_steps=100, verbose=False)
    net.reset()  # the fit and the test start from the same (zero) state
    obs, fit_s, launches = counted(lambda: net.fit_rls(inputs, target, **fit_kw))
    if launches != STEPS:
        raise AssertionError(f"rls_path: {launches} qif_sfa_step launches for {STEPS} steps")
    losses = obs.to_numpy("loss")
    W, P = edge.weights, edge.P
    if not (np.all(np.isfinite(losses)) and bool(torch.isfinite(W).all())
            and bool(torch.isfinite(P).all())):
        raise AssertionError("rls_path: non-finite losses, weights or P")
    asym = float((P - P.T).abs().max())
    p_max = float(P.abs().max())
    p_moved = float((P - torch.eye(N, dtype=P.dtype, device=P.device)).abs().max())
    if not asym <= 1e-10 * p_max:
        raise AssertionError(f"rls_path: P is not symmetric (max|P - P^T| = {asym})")
    y_end = net.get_node("qif").y.detach().cpu().numpy()
    net.reset()
    (obs_t, test_loss), test_s, test_launches = counted(
        lambda: net.test(inputs, target, sampling_steps=100, verbose=False))
    rec = obs_t.to_numpy("out")
    if rec.shape != (STEPS // 100, 1) or not np.all(np.isfinite(rec)):
        raise AssertionError(f"rls_path: bad test records, shape {rec.shape}")
    tgt_var = float(np.var(target[::100]))
    # the RLS update alone, on a copy of P (it downdates P in place) at the
    # reservoir's last output
    update = RLS.update_fn(edge.beta)
    P_copy = P.clone()
    x = net.get_node("qif").y[N:2 * N].to(torch.float64)
    y = torch.ones(1, dtype=torch.float64, device=x.device)
    y_hat = W @ x
    update_ms = cuda_ms(lambda: update(W, P_copy, x, y, y_hat), reps=50)
    del P_copy
    n_bytes = 3 * N * N * 8 + 8 * (4 * N + 4)  # P read twice, written once; the vectors
    n_ops = 4 * N * N + 8 * N
    update_bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F64_FLOPS) * 1e3
    step_ms = fit_s / STEPS * 1e3
    emit({"phase": "rls_path", "n": N, "steps": STEPS, "update_steps": 10, "beta": 0.99,
          "P_dtype": "float64", "kernel_launches_fit": launches,
          "kernel_launches_test": test_launches, "build_s": build_s, "fit_s": fit_s,
          "ms_per_step": step_ms, "neuron_updates_per_s": STEPS * N / fit_s,
          "rls_update_ms": update_ms, "rls_update_bound_ms": update_bound_ms,
          "rls_update_bound_by": "bytes", "rls_update_bytes": n_bytes,
          "rls_update_share_of_bound": update_bound_ms / update_ms,
          "update_share_of_step": update_ms / 10 / step_ms,
          "max_abs_P_minus_PT": asym, "max_abs_P": p_max, "max_abs_P_minus_I": p_moved,
          "fit_loss_first_last": [float(losses[1]), float(losses[-1])],
          "test_s": test_s, "test_loss": test_loss, "target_variance": tgt_var,
          "test_loss_over_target_variance": test_loss / tgt_var,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    entries = [dict(timing, name="qif_sfa_step[bfloat16,rls_path]", launches=launches)]

    # --------------------------------------------------------- 21. rls_vs_cpu
    # a fresh RLS edge on both sides, from the reservoir's state at the end
    # of the fit (the population is spiking by then)
    net.pop_edge("qif", "readout")
    net.add_edge("qif", "readout", train="rls", beta=0.99, alpha=1.0)
    t0 = time.perf_counter()
    cpu_net = build_net("bfloat16", fused=True, device="cpu")
    with_readout(cpu_net)
    cpu_build_s = time.perf_counter() - t0
    cmp, secs = {}, {}
    for name, n_ in (("card", net), ("cpu", cpu_net)):
        n_.reset({"qif": y_end})
        t0 = time.perf_counter()
        o = n_.fit_rls(inputs[:CPU_STEPS], target[:CPU_STEPS], update_steps=10,
                       sampling_steps=10, verbose=False)
        secs[name] = time.perf_counter() - t0
        cmp[name] = (o.to_numpy("out"), n_.get_edge("qif", "readout").weights.cpu().numpy())
    emit({"phase": "rls_vs_cpu", "n": N, "steps": CPU_STEPS, "update_steps": 10,
          "records": int(cmp["cpu"][0].shape[0]),
          "readout": vs_cpu("rls_vs_cpu readout", cmp["card"][0], cmp["cpu"][0]),
          "weights": vs_cpu("rls_vs_cpu weights", cmp["card"][1], cmp["cpu"][1]),
          "cpu_build_s": cpu_build_s, "card_fit_s": secs["card"], "cpu_fit_s": secs["cpu"]})
    del cpu_net, net, edge, W, P
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 22. ridge_path
    net = build_net("bfloat16", fused=True)
    net.reset()  # every run of this phase starts from the same (zero) state
    (obs, run_s, _) = counted(lambda: net.run(inputs, sampling_steps=RIDGE_SAMPLING,
                                              verbose=False))
    X = obs.to_numpy("out")
    rows = X.shape[0]
    if rows >= N:
        raise AssertionError("ridge_path: X X^T + alpha I is the dual form only for rows < N")
    X64 = X.astype(np.float64)
    K = X64 @ X64.T
    lam_max = float(np.linalg.eigvalsh(K)[-1])
    alpha = 1e-3 * lam_max
    cond = (lam_max + alpha) / alpha  # X^T X is singular (rows < N): its least eigenvalue is 0
    net.reset()
    obs, fit_s, launches = counted(lambda: net.fit_ridge(
        inputs, target, sampling_steps=RIDGE_SAMPLING, alpha=alpha, verbose=False))
    if launches != STEPS:
        raise AssertionError(f"ridge_path: {launches} qif_sfa_step launches for {STEPS} steps")
    y32 = np.asarray(obs["y"], dtype=np.float64)
    x_same = bool(np.array_equal(obs.to_numpy("out"), X))
    y_t = target[::RIDGE_SAMPLING][:rows]
    t0 = time.perf_counter()
    y64 = K @ np.linalg.solve(K + alpha * np.eye(rows), y_t)
    ref_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(y32 - y64) / np.linalg.norm(y64))
    tol = cond * float(np.finfo(np.float32).eps) * np.sqrt(rows)
    if not (tol < 0.1 and rel <= tol and np.all(np.isfinite(y32))):
        raise AssertionError(f"ridge_path: predictions off the float64 solve by {rel} "
                             f"(tolerance {tol})")
    # the Gram product and the solve alone, on the card
    Xd = torch.as_tensor(X, device=net.device)
    yd = torch.as_tensor(y_t, dtype=torch.float32, device=net.device)
    eye = alpha * torch.eye(N, device=net.device)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gram, gram_s = timed(lambda: Xd.T @ Xd + eye)
    _, solve_s = timed(lambda: torch.linalg.solve(gram, Xd.T @ yd))
    del Xd, gram, eye
    net.reset()
    (obs_t, test_loss), test_s, test_launches = counted(
        lambda: net.test(inputs, target, sampling_steps=RIDGE_SAMPLING, verbose=False))
    fit_loss = float(np.mean((y32 - y_t) ** 2))
    emit({"phase": "ridge_path", "n": N, "steps": STEPS, "sampling_steps": RIDGE_SAMPLING,
          "X_shape": [rows, N], "alpha": alpha, "lambda_max_XXt": lam_max, "cond_gram": cond,
          "rel_err_vs_float64": rel, "tolerance": tol, "X_equal_to_first_run": x_same,
          "kernel_launches_fit": launches, "kernel_launches_test": test_launches,
          "run_s": run_s, "fit_ridge_s": fit_s, "gram_s": gram_s, "solve_s": solve_s,
          "float64_host_solve_s": ref_s, "fit_loss": fit_loss, "test_s": test_s,
          "test_loss": test_loss, "target_variance": float(np.var(y_t)),
          "test_loss_over_target_variance": test_loss / float(np.var(y_t))})
    entries.append(dict(timing, name="qif_sfa_step[bfloat16,ridge_path]", launches=launches))
    del net, obs, obs_t, X, X64, K
    torch.cuda.empty_cache()
    return entries


def tbptt_phase(dev, data, timing: dict) -> list:
    """Phase 23: truncated BPTT (fit_bptt step mode) of phase 8's int8_master
    network on the bench data tiled to T_TBPTT.  ``timing`` maps phase 10's
    int8 kernel names to their entries.  Returns their entries for this
    path."""
    from rectipy_tpu_torch.ops.fused_opt import adam_requant
    from rectipy_tpu_torch.ops.quant import int8_mv, int8_mv_t

    W_np, etas, inp, tgt, _ = data
    reps = T_TBPTT // T_TRAIN
    inp_d = torch.as_tensor(np.tile(inp, (reps, 1)), dtype=torch.float32, device=dev)
    tgt_d = torch.as_tensor(np.tile(tgt, (reps, 1)), dtype=torch.float32, device=dev)
    kernels = (int8_mv, int8_mv_t, adam_requant)
    chunks = T_TBPTT // UPDATE_STEPS
    t0 = time.perf_counter()
    net = build_train_net(W_np, etas)
    build_s = time.perf_counter() - t0

    def step_fit():
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = net.fit_bptt(inp_d, tgt_d, optimizer="adam", lr=LR, update_steps=UPDATE_STEPS,
                           sampling_steps=1, record_output=False, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the loss recorded at the last step of each chunk is that chunk's
        losses = obs.to_numpy("loss")[UPDATE_STEPS - 1::UPDATE_STEPS]
        return seconds, losses, {k.__name__: k.launches for k in kernels}

    warm_s, warm_losses, _ = step_fit()
    seconds, losses, launches = step_fit()
    want = {"int8_mv": T_TBPTT, "int8_mv_t": T_TBPTT, "adam_requant": 0}
    if launches != want:
        raise AssertionError(f"tbptt_path: launches {launches}, expected {want}")
    if net.last_fit != {"trajectory": "chain", "fused_adam": False}:
        raise AssertionError(f"tbptt_path took {net.last_fit}")
    if len(losses) != chunks or not np.all(np.isfinite(losses)):
        raise AssertionError(f"tbptt_path: chunk losses {losses}")
    emit({"phase": "tbptt_path", "n": N, "T": T_TBPTT, "update_steps": UPDATE_STEPS,
          "chunks": chunks, "coupling": "int8_master", "optimizer": "adam", "lr": LR,
          "build_s": build_s, "warm_fit_s": warm_s, "fit_s": seconds,
          "ms_per_chunk": seconds / chunks * 1e3,
          "trained_neuron_updates_per_s": T_TBPTT * N / seconds,
          "launches_per_fit": launches, "chunk_losses_warm_fit": list(map(float, warm_losses)),
          "chunk_losses": list(map(float, losses))})
    del net, inp_d, tgt_d
    torch.cuda.empty_cache()
    return [dict(timing[name], name=f"{name}[tbptt_path]", launches=launches[name])
            for name in ("int8_mv", "int8_mv_t")]


def feedback_phase() -> list:
    """Phase 24: examples/feedback_populations.py at N per population.
    Returns the generic kernel's entry of the ``kernels`` line."""
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step

    t0 = time.perf_counter()
    weights = feedback_weights(N)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = feedback_net(N, None, weights)
    build_s = time.perf_counter() - t0
    inputs = np.zeros((STEPS, 1), dtype=np.float32) + 100.0  # the example's drive
    run_kw = dict(record_output=False, record_vars=[("p1", "s", True), ("p2", "s", True)],
                  sampling_steps=100, verbose=False)
    runs = []
    for _ in range(2):
        net.reset()
        generic_fused_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = net.run(inputs, **run_kw)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        launches = generic_fused_step.launches
        if launches != 2 * STEPS:
            raise AssertionError(f"feedback_path: {launches} launches for {STEPS} steps")
        recs = [obs.to_numpy((p, "s")) for p in ("p1", "p2")]
        if any(r.shape != (STEPS // 100,) or not np.all(np.isfinite(r)) for r in recs):
            raise AssertionError("feedback_path: bad records")
    best = min(runs)
    dev_ms = device_step_ms(net, torch.full((1,), 100.0, device=net.device), reps=30)
    # the first CPU_STEPS steps on the CPU, held to the card's
    short = inputs[:CPU_STEPS]
    cmp_kw = dict(run_kw, sampling_steps=10)
    t0 = time.perf_counter()
    cpu_net = feedback_net(N, "cpu", weights)
    cpu_build_s = time.perf_counter() - t0
    del weights
    cmp, secs = {}, {}
    for name, n_ in (("card", net), ("cpu", cpu_net)):
        n_.reset()
        t0 = time.perf_counter()
        o = n_.run(short, **cmp_kw)
        secs[name] = time.perf_counter() - t0
        cmp[name] = np.stack([o.to_numpy((p, "s")) for p in ("p1", "p2")])
    del cpu_net
    emit({"phase": "feedback_path", "template": "lif", "populations": 2, "coupling": "bfloat16",
          "edges": "float32 dense feedforward p1->p2 and feedback p2->p1", "n": N,
          "steps": STEPS, "kernel_launches": launches, "w_data_s": data_s, "build_s": build_s,
          "run_s": runs,
          "best_s": best, "ms_per_step": best / STEPS * 1e3,
          "neuron_updates_per_s": 2 * STEPS * N / best, "device_step_ms": dev_ms,
          "device_idle_share": 1.0 - dev_ms / (best / STEPS * 1e3),
          "mean_s_range": [float(np.min(recs)), float(np.max(recs))],
          "vs_cpu": {"steps": CPU_STEPS, "records": int(cmp["cpu"].shape[1]),
                     **vs_cpu("feedback_path card vs cpu", cmp["card"], cmp["cpu"]),
                     "cpu_build_s": cpu_build_s, "card_run_s": secs["card"],
                     "cpu_run_s": secs["cpu"]}})
    entry = generic_instance("lif,bfloat16,feedback_path", net.get_node("p1"), torch.bfloat16,
                             16, launches)
    del net
    torch.cuda.empty_cache()
    return [entry]


# ------------------------------------------------------------ phases 25-28
B_RUN, T_RUN = 32, 5_000  # run_batch_path: benchmarks/batch_throughput.py's network
B_TRAIN, TRAIN_EPOCHS = 32, 8  # batch_train_path: bench.py's ensemble phase
B_RAGGED = (7, 5)  # batch_kernel_check: a ragged B for int8_mm(_t) and the B-row step
CMP_STEPS = 200  # the run_batch trials against single-trial runs
G_B = 32  # run_batch_path's generic-kernel run: trials of PLAIN_STEPS steps
SWEPT_B, SWEPT_STEPS = 4, 1_000  # run_batch_path: a swept int4_master coupling (spikes from ~190)
I4_TRAIN_EPOCHS = 4  # batch_train_path's int4_master ensemble fit
CPU_N, CPU_B, CPU_T, CPU_EPOCHS = 2_000, 4, 50, 2  # batch_train_vs_cpu
# batch_train_vs_cpu: the card's fit (int8_mm/int8_mm_t, float32 sums in
# another order) against the CPU's (plain products).  The integer sums are
# exact on both, but the states that feed quant_vec differ in the last bits,
# so a source value can sit on the other side of a rounding boundary and
# the dynamics then part slowly; the losses are means over 1e5 terms (rtol
# 1e-4).  Adam takes steps of about lr whatever the gradient's size, so a
# weight whose gradient is near 0 may step the other way: the rule is on the
# share of weights whose update differs by more than 1% of lr (at most 1%).
BATCH_LOSS_RTOL, BATCH_W_SHARE = 1e-4, 1e-2


def batch_run_net(coupling: str, fused: bool, device=None):
    """benchmarks/batch_throughput.py's network: N = 10,000 qif_sfa, a 10%
    fan-in coupling of 1/(0.1 N) from seed 42, the tan etas, dt 1e-4; the
    drive enters I_ext directly."""
    from rectipy_tpu_torch import Network, attach_fused_qif_step

    rng = np.random.default_rng(42)
    W = (rng.random((N, N)) < 0.1) * (1.0 / (0.1 * N))
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, N + 1) - N - 1) / (N + 1))
    net = Network(DT, device=device)
    net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_sfa_op", spike_var="spike",
                        spike_def="v", spike_threshold=1e2, spike_reset=-1e2,
                        node_vars={"all/qif_sfa_op/eta": etas}, coupling_dtype=coupling)
    net.compile()
    if fused:
        attach_fused_qif_step(net.get_node("qif"))
    return net, etas


def rows_state(B: int, n: int, case: str, rng, dev):
    """B trials' (v, s, x) as rows of one (B, 3n) buffer, eta and inp (B, n),
    for the kernel check's two cases (TOL)."""
    if case == "reset":
        y = np.concatenate([rng.normal(size=(B, n)) * 80.0, rng.random((B, n)),
                            rng.random((B, n))], axis=1)
        eta, inp = rng.normal(size=(B, n)), rng.normal(size=(B, n))
    else:
        y = np.concatenate([rng.normal(size=(B, n)) * 1e-3, rng.random((B, n)),
                            rng.random((B, n)) * 1e-3], axis=1)
        eta, inp = rng.normal(size=(B, n)) * 1e-3, rng.normal(size=(B, n)) * 1e-3
    y, eta, inp = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (y, eta, inp))
    return y[:, :n], y[:, n:2 * n], y[:, 2 * n:], eta, inp


def batch_kernel_check(dev, W_np) -> dict:
    """Phase 25: int8_mm/int8_mm_t bit for bit and the B-row qif_sfa_step
    against its plain version and the single-row kernel, at N = 10,000."""
    from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step, rows_route
    from rectipy_tpu_torch.ops.quant import (int8_mm, int8_mm_plain, int8_mm_route, int8_mm_t,
                                             int8_mm_t_plain, int8_mm_t_route, quant_vec,
                                             quantize_rows)
    from rectipy_tpu_torch.testing import qif_rows_instance

    W32 = torch.as_tensor(W_np, dtype=torch.float32, device=dev)
    wq, ws = quantize_rows(W32)
    gen = torch.Generator(device=dev).manual_seed(25)
    max_err = {}
    route, route_t = int8_mm_route(N, wq.data_ptr()), int8_mm_t_route(N, wq.data_ptr())
    if (route, route_t) != ("mma", "mma"):
        raise AssertionError(f"int8_mm/int8_mm_t take the {route!r}/{route_t!r} routes at "
                             f"N={N}, not the tensor cores")
    for B in (B_TRAIN, B_RAGGED[0]):
        xq, xs = quant_vec(torch.randn((B, N), generator=gen, device=dev)
                           * torch.linspace(0.1, 10.0, B, device=dev)[:, None])
        vq, vs = quant_vec(torch.randn((B, N), generator=gen, device=dev) * 1e-3)
        mma_before = int8_mm.mma_launches, int8_mm_t.mma_launches
        got, got_t = int8_mm(wq, xq, ws, xs.reshape(-1)), int8_mm_t(wq, vq, vs.reshape(-1))
        torch.cuda.synchronize()
        if (int8_mm.mma_launches - mma_before[0], int8_mm_t.mma_launches - mma_before[1]) \
                != (1, 1):
            raise AssertionError(f"int8_mm/int8_mm_t did not launch on the tensor cores at B={B}")
        ref, ref_t = (int8_mm_plain(wq, xq) * ws) * xs, int8_mm_t_plain(wq, vq) * vs
        if not (torch.equal(got, ref) and torch.equal(got_t, ref_t)):
            raise AssertionError(f"int8_mm/int8_mm_t differ from their plain versions at B={B}")
        if not (bool((got != 0).any()) and bool((got_t != 0).any())):
            raise AssertionError("the int8_mm check is vacuous: all outputs are zero")
        emit({"phase": "batch_kernel_check", "kernel": "int8_mm/int8_mm_t", "n": N, "B": B,
              "int8_mm_route": route, "int8_mm_t_route": route_t, "bit_identical": True})
    max_err["int8_mm"] = max_err["int8_mm_t"] = 0.0
    params = dict(dt=DT, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05, thresh=100.0,
                  v_reset=-100.0)
    rng = np.random.default_rng(25)
    for name, W in (("float32", W32), ("bfloat16", W32.to(torch.bfloat16))):
        err = 0.0
        for B in (B_TRAIN, B_RAGGED[1]):
            for case in ("reset", "coupling"):
                p = dict(params, k=1.0 / DT) if case == "coupling" else params
                v, s, x, eta, inp = rows_state(B, N, case, rng, dev)
                route = rows_route(W.dtype, N, s.stride(0), W.data_ptr(), s.data_ptr())
                if route != ("mma" if name == "bfloat16" else "tiled"):
                    raise AssertionError(f"B-row {name}: route {route}")
                before = qif_sfa_step.mma_launches, qif_sfa_step.tiled_launches
                out = qif_sfa_step(v, s, x, W, eta, inp, **p)
                torch.cuda.synchronize()
                if (qif_sfa_step.mma_launches - before[0],
                        qif_sfa_step.tiled_launches - before[1]) != (int(route == "mma"),
                                                                     int(route == "tiled")):
                    raise AssertionError(f"B-row {name}: the launch did not take route {route}")
                ref = torch.stack(qif_sfa_reference_step(v, s, x, W, eta, inp, **p), dim=-2)
                rtol, atol = TOL[case]
                torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
                one_err = 0.0
                for b in range(B):  # each trial against the single-row kernel
                    one = qif_sfa_step(v[b].contiguous(), s[b].contiguous(), x[b].contiguous(),
                                       W, eta[b], inp[b], **p)
                    torch.testing.assert_close(out[b], one, rtol=rtol, atol=atol)
                    one_err = max(one_err, float((out[b] - one).abs().max()))
                mask, ref_mask = out[:, 0] == p["v_reset"], ref[:, 0] == p["v_reset"]
                if not torch.equal(mask, ref_mask):
                    raise AssertionError(f"B-row {name}, {case}: the reset masks differ")
                e = float((out - ref).abs().max())
                err = max(err, e)
                line = {"phase": "batch_kernel_check", "kernel": "qif_sfa_step[rows]",
                        "w_dtype": name, "kernel_route": route, "case": case, "n": N, "B": B,
                        "max_abs_err": e,
                        "max_abs_diff_single_row_kernel": one_err, "rtol": rtol, "atol": atol,
                        "reset_neurons": int(mask.sum())}
                if route == "tiled":  # and against the CUDA cores' vector instance
                    old = qif_rows_instance("vec", W, v, s, x, eta, inp, p)
                    torch.testing.assert_close(out, old, rtol=rtol, atol=atol)
                    if not torch.equal(mask, old[:, 0] == p["v_reset"]):
                        raise AssertionError(f"B-row {name}, {case}: the reset masks of the "
                                             f"tiled and vector instances differ")
                    line["max_abs_diff_vec_instance"] = float((out - old).abs().max())
                if case == "reset" and not bool(mask.any()):
                    raise AssertionError(f"B-row {name}: no neuron was reset")
                if case == "coupling":
                    s_cut = s.clone()
                    s_cut[:, ::8] = 0.0
                    cut = qif_sfa_reference_step(v, s_cut, x, W, eta, inp, **p)[0]
                    margin = float(((cut - ref[:, 0]).abs()
                                    / (atol + rtol * ref[:, 0].abs())).min())
                    if bool(mask.any()) or margin <= 1.0:
                        raise AssertionError(f"B-row {name}: the coupling case reset neurons "
                                             f"or would pass a lost eighth (margin {margin})")
                    line["lost_eighth_min_margin"] = margin
                emit(line)
        max_err[f"qif_sfa_step_rows[{name}]"] = err
    max_err.update(generic_rows_check(dev, W32))
    max_err.update(int4_mm_check(dev))
    return max_err


def rows_case_step(case: str):
    """The GenericStep of a generic-kernel network of this script (built on
    CPU tensors at n = 16: the step, its generated source and its scalars do
    not depend on n, and the build phase compiled that source)."""
    from rectipy_tpu_torch.testing import generic_case_net

    if case == "lif":
        node = lif_net(16, "cpu").get_node("lif")
    elif case == "ei":
        node = ei_net(16, "cpu")[0].get_node("ei")
    else:
        node = generic_case_net(case, np.full((16, 16), 1.0 / 16), "cpu")[1]
    return node._fused_cfg["step"]


def generic_route(Ws, srcs) -> str:
    """generic_rows_route of one B-row launch's operands."""
    from rectipy_tpu_torch.ops.generic_fused import generic_rows_route

    return generic_rows_route(Ws[0].dtype, srcs[0].shape[-1],
                              [t.stride(0) if t.dim() == 2 else 0 for t in srcs],
                              [t.data_ptr() for t in list(Ws) + list(srcs)])


def generic_rows_check(dev, W32) -> dict:
    """Phase 25: the B-row generic step against its plain version under
    GENERIC_TOL["reset"], trial by trial, and against the single-trial
    kernel on each trial: LIF (K = 1), the E/I circuit (K = 2) and the Heun
    tanh RateNet in derivative mode; f32 and bf16 W (the main path's, and
    for the E/I circuit's second coupling half its transpose); B_TRAIN and
    the ragged B_RAGGED[1]; at N (bf16: the tensor cores, "mma"; f32: the
    tiled CUDA-core kernel, "tiled", also held to the CUDA cores' vector
    instance it replaced, route code "vec" through the C entry), N - 4 for
    bf16 (n % 8 == 4: the CUDA cores' bf16 vector route) and N - 1 (odd:
    the scalar route), each launch on the route generic_rows_route names
    (mma_launches counts the tensor cores', tiled_launches the tiled
    kernel's).  Returns the largest error of each case, W type and
    route."""
    from rectipy_tpu_torch.ops.generic_fused import (generic_fused_rows, generic_fused_rows_plain,
                                                     generic_fused_step)
    from rectipy_tpu_torch.testing import (GENERIC_TOL, check_generic, generic_rows_instance,
                                           generic_rows_operands)

    rng = np.random.default_rng(251)
    W2 = (0.5 * W32.T).contiguous()
    errs = {}
    for case in ("lif", "ei", "tanh_heun"):
        step = rows_case_step(case)
        K = len(step.targets)
        for name, w_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for n in ((N, N - 4, N - 1) if name == "bfloat16" else (N, N - 1)):
                Ws = [W.to(w_dtype) if n == N else W[:n, :n].contiguous().to(w_dtype)
                      for W in (W32, W2)[:K]]
                want = ("scalar" if n % 4 else "tiled" if name == "float32"
                        else "mma" if n % 8 == 0 else "vec")
                for B in (B_TRAIN, B_RAGGED[1]):
                    srcs, drive, states, vecs = generic_rows_operands(step, n, B, rng, dev)
                    route = generic_route(Ws, srcs)
                    if route != want:
                        raise AssertionError(f"generic rows {case}: route {route} at n={n}, "
                                             f"{name} W, not {want}")
                    before = (generic_fused_rows.launches, generic_fused_rows.mma_launches,
                              generic_fused_rows.tiled_launches)
                    got = generic_fused_rows(step, srcs, Ws, drive, states, vecs)
                    torch.cuda.synchronize()
                    if (generic_fused_rows.launches - before[0],
                            generic_fused_rows.mma_launches - before[1],
                            generic_fused_rows.tiled_launches - before[2]) != (
                                1, int(route == "mma"), int(route == "tiled")):
                        raise AssertionError(f"generic rows {case}: the launch did not take "
                                             f"route {route}")
                    ref = generic_fused_rows_plain(step, srcs, Ws, drive, states, vecs)
                    resets, one_err = 0, 0.0
                    for b in range(B):
                        resets += check_generic(got[b], ref[b], step)[1]
                        one = generic_fused_step(step, [t[b] for t in srcs], Ws, drive[b],
                                                 [t[b].contiguous() for t in states], vecs)
                        check_generic(got[b], one, step)
                        one_err = max(one_err, float((got[b] - one).abs().max()))
                    hard = any(h for _, _, h, _ in step.spike_specs) and not step.derivative
                    if hard and resets == 0:
                        raise AssertionError(f"generic rows {case}: no neuron was reset")
                    e = float((got - ref).abs().max())
                    key = f"generic_fused_rows[{case},{name},{route}]"
                    errs[key] = max(errs.get(key, 0.0), e)
                    line = {"phase": "batch_kernel_check", "kernel": "generic_fused_rows",
                            "case": case, "couplings": K, "derivative": step.derivative,
                            "w_dtype": name, "kernel_route": route, "n": n, "B": B,
                            "max_abs_err": e, "max_abs_diff_single_trial_kernel": one_err,
                            "rtol": GENERIC_TOL["reset"][0],
                            "atol": f"{GENERIC_TOL['reset'][1]} x row max",
                            "reset_neurons": resets}
                    if route == "tiled":  # and against the CUDA cores' vector instance
                        old = generic_rows_instance(step, srcs, Ws, drive, states, vecs, "vec")()
                        for b in range(B):
                            check_generic(got[b], old[b], step)
                        line["max_abs_diff_vec_instance"] = float((got - old).abs().max())
                    emit(line)
    return errs


def int4_mm_check(dev) -> dict:
    """Phase 25: int4_mm and int4_mm_t bit for bit against their plain
    versions (and against int4_mv/int4_mv_t on the first and last trial)
    at B = B_TRAIN and B_RAGGED, N = 10,000 and the microbenchmark's
    14,336: weights over the full nibble range, per-trial activation
    scales over two decades."""
    from rectipy_tpu_torch.ops.quant import (int4_mm, int4_mm_plain, int4_mm_route, int4_mm_t,
                                             int4_mm_t_plain, int4_mm_t_route, int4_mv, int4_mv_t,
                                             pack_int4, quant_vec)

    gen = torch.Generator(device=dev).manual_seed(252)
    for n in (N, N_I4PACK):
        wp = pack_int4(torch.randint(-8, 8, (n, n), generator=gen, device=dev,
                                     dtype=torch.int8))
        ws = torch.rand(n, generator=gen, device=dev) + 0.5
        for B in (B_TRAIN,) + B_RAGGED:
            scale = torch.logspace(-1.0, 1.0, B, device=dev)[:, None]
            xq, xs = quant_vec(torch.randn((B, n), generator=gen, device=dev) * scale)
            vq, vs = quant_vec(torch.randn((B, n), generator=gen, device=dev) * scale)
            xs, vs = xs.reshape(-1), vs.reshape(-1)
            route = int4_mm_route(wp.shape[1], wp.data_ptr())
            route_t = int4_mm_t_route(wp.shape[1], wp.data_ptr())
            before = (int4_mm.launches, int4_mm.mma_launches, int4_mm_t.launches,
                      int4_mm_t.mma_launches)
            got, got_t = int4_mm(wp, xq, ws, xs), int4_mm_t(wp, vq, vs, n)
            torch.cuda.synchronize()
            if (int4_mm.launches - before[0], int4_mm_t.launches - before[2]) != (1, 1):
                raise AssertionError(f"int4_mm/int4_mm_t did not launch at B={B}, n={n}")
            # every pack_int4 output takes the tensor cores, both ways
            if route != "mma" or int4_mm.mma_launches - before[1] != 1:
                raise AssertionError(f"int4_mm took route {route} at B={B}, n={n}")
            if route_t != "mma" or int4_mm_t.mma_launches - before[3] != 1:
                raise AssertionError(f"int4_mm_t took route {route_t} at B={B}, n={n}")
            ref, ref_t = (int4_mm_plain(wp, xq) * ws) * xs[:, None], int4_mm_t_plain(
                wp, vq, n) * vs[:, None]
            if not (torch.equal(got, ref) and torch.equal(got_t, ref_t)):
                raise AssertionError(f"int4_mm/int4_mm_t differ from their plain versions at "
                                     f"B={B}, n={n}")
            for b in (0, B - 1):
                if not (torch.equal(got[b], int4_mv(wp, xq[b], ws, xs[b])) and torch.equal(
                        got_t[b], int4_mv_t(wp, vq[b], vs[b], n))):
                    raise AssertionError(f"int4_mm/int4_mm_t differ from int4_mv/int4_mv_t "
                                         f"at B={B}, n={n}, trial {b}")
            if not (bool((got != 0).any()) and bool((got_t != 0).any())):
                raise AssertionError("the int4_mm check is vacuous: all outputs are zero")
            emit({"phase": "batch_kernel_check", "kernel": "int4_mm/int4_mm_t", "n": n, "B": B,
                  "kernel_route": route, "kernel_route_t": route_t, "tensor_core_launches": 1,
                  "tensor_core_launches_t": 1, "bit_identical": True})
        del wp
    return {"int4_mm": 0.0, "int4_mm_t": 0.0}


def run_batch_phase(dev) -> tuple:
    """Phase 26: run_batch on benchmarks/batch_throughput.py's network, an
    eta sweep over B_RUN trials on a shared drive, int8 coupling (int8_mm),
    bf16 and f32 with the fused QIF step (the B-row kernel on the tensor
    cores and its tiled f32 instance) and frozen int4 (int4_mm).  Returns
    (launches by coupling, the seconds of a B_RUN run by coupling)."""
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step
    from rectipy_tpu_torch.ops.quant import int4_mm, int4_mv, int8_mm, int8_mv

    drive = bench_inputs(T_RUN)
    offsets = np.linspace(-2.0, 2.0, B_RUN)
    rec_kw = dict(record_output=False, record_vars=[("qif", "s", True)], verbose=False)
    picks = (0, B_RUN // 2 - 1, B_RUN - 1)
    launches, out = {}, {}
    # (coupling, fused step?, the batched kernel, the route every launch
    # must take, a single-row kernel that must not launch); the fused step's
    # f32 coupling is its default weights_dtype.  qif_sfa_step.launches
    # counts the single-row launches too, so its count of B-row launches on
    # the route bounds them to none.
    for coupling, fused, kernel, route, absent in (
            ("int8", False, int8_mm, "mma", int8_mv),
            ("bfloat16", True, qif_sfa_step, "mma", int8_mv),
            ("float32", True, qif_sfa_step, "tiled", int8_mv),
            ("int4", False, int4_mm, "mma", int4_mv)):
        counter = f"{route}_launches"
        t0 = time.perf_counter()
        net, etas = batch_run_net(coupling, fused)
        build_s = time.perf_counter() - t0
        sweep = torch.as_tensor(etas[None, :] + offsets[:, None], dtype=torch.float32,
                                device=dev)

        y0 = net.get_node("qif").y.clone()

        def batch(steps=T_RUN, s=100, kw=rec_kw):  # every trial from y0
            net.reset({"qif": y0})
            return net.run_batch(drive[:steps], sampling_steps=s,
                                 batch_vars={("qif", "eta"): sweep}, **kw)

        def single(steps=T_RUN, s=100, kw=rec_kw):  # from the same initial state
            net.reset({"qif": y0})
            return net.run(drive[:steps], sampling_steps=s, **kw)

        batch(CMP_STEPS)  # warm
        times = {"batch": [], "single": []}
        for _ in range(2):  # in turns, best of 2
            kernel.launches = absent.launches = 0
            setattr(kernel, counter, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batch()
            torch.cuda.synchronize()
            times["batch"].append(time.perf_counter() - t0)
            if kernel.launches != T_RUN or absent.launches != 0:
                raise AssertionError(f"run_batch_path ({coupling}): {kernel.launches} "
                                     f"{kernel.__name__} launches for {T_RUN} steps")
            # every step's product on the route (the tensor cores; f32: tiled)
            route_launches = getattr(kernel, counter)
            if route_launches != T_RUN:
                raise AssertionError(f"run_batch_path ({coupling}): {route_launches} of "
                                     f"{T_RUN} launches took the {route!r} route")
            launches[coupling] = kernel.launches
            rec = res[("qif", "s")]
            if rec.shape != (B_RUN, T_RUN // 100) or not np.all(np.isfinite(rec)):
                raise AssertionError(f"run_batch_path ({coupling}): bad records {rec.shape}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single()
            torch.cuda.synchronize()
            times["single"].append(time.perf_counter() - t0)
        best_b, best_1 = min(times["batch"]), min(times["single"])
        # trials 0, 15 and 31 against single-trial runs with their eta: the
        # whole v every 10 steps (the mean s moves little before the first
        # spikes, near step 190)
        v_kw = dict(rec_kw, record_vars=[("qif", "v", False)])
        short = batch(CMP_STEPS, 10, v_kw)[("qif", "v")]
        cmp = {}
        for b in picks:
            net.set_var("qif", "eta", etas + offsets[b])
            one = single(CMP_STEPS, 10, v_kw).to_numpy(("qif", "v"))
            if coupling in ("int8", "int4"):  # exact integer sums on both sides
                np.testing.assert_allclose(short[b], one, rtol=1e-5, atol=1e-7)
                cmp[b] = {"max_abs_diff": float(np.abs(short[b] - one).max())}
            else:  # another summation order: fused_vs_plain's rule
                cmp[b] = vs_cpu(f"run_batch_path trial {b}", short[b], one)
        nu_b, nu_1 = B_RUN * N * T_RUN / best_b, N * T_RUN / best_1
        emit({"phase": "run_batch_path", "coupling": coupling, "fused_qif_step": fused, "n": N,
              "B": B_RUN, "steps": T_RUN, "sweep": "eta + linspace(-2, 2, B)",
              "kernel": kernel.__name__, "launches": launches[coupling],
              "kernel_route": route, "route_launches": route_launches,
              **({"tensor_core_launches": route_launches} if route == "mma" else {}),
              "build_s": build_s,
              "run_batch_s": times["batch"], "run_single_s": times["single"],
              "ms_per_step": best_b / T_RUN * 1e3, "single_ms_per_step": best_1 / T_RUN * 1e3,
              "aggregate_neuron_updates_per_s": nu_b, "single_neuron_updates_per_s": nu_1,
              "ratio_to_single": nu_b / nu_1,
              "mean_s_range": [float(rec.min()), float(rec.max())],
              "trials_vs_single": {str(k): v for k, v in cmp.items()}})
        out[coupling] = best_b
        del net, sweep, y0
        torch.cuda.empty_cache()
    return launches, out


def swept_int4_phase(dev) -> dict:
    """Phase 26, continued: run_batch of benchmarks/batch_throughput.py's
    network with an int4_master coupling swept per trial through batch_vars:
    SWEPT_B couplings of their own (10% fan-in masks drawn on the card),
    quantized and packed per trial once per run, SWEPT_STEPS steps of the
    shared drive, one int4_mv per trial a step; the first and last trial
    against single-trial runs with their coupling (exact integer sums on
    both sides).  Returns the launch counts."""
    from rectipy_tpu_torch.ops.quant import int4_mm, int4_mv

    t0 = time.perf_counter()
    net, _ = batch_run_net("int4_master", False)
    gen = torch.Generator(device=dev).manual_seed(261)
    Ws = (torch.rand((SWEPT_B, N, N), generator=gen, device=dev) < 0.1).to(torch.float32)
    Ws *= 1.0 / (0.1 * N)
    build_s = time.perf_counter() - t0
    drive = bench_inputs(SWEPT_STEPS)
    y0 = net.get_node("qif").y.clone()
    kw = dict(record_output=False, record_vars=[("qif", "v", False)], sampling_steps=10,
              verbose=False)
    int4_mv.launches = int4_mm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.run_batch(drive, batch_vars={("qif", "weights"): Ws}, **kw)[("qif", "v")]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"int4_mv": int4_mv.launches, "int4_mm": int4_mm.launches}
    if launches != {"int4_mv": SWEPT_B * SWEPT_STEPS, "int4_mm": 0}:
        raise AssertionError(f"run_batch_path (swept int4): launches {launches}")
    if res.shape != (SWEPT_B, SWEPT_STEPS // 10, N) or not np.all(np.isfinite(res)):
        raise AssertionError(f"run_batch_path (swept int4): bad records {res.shape}")
    diffs = {}
    for b in (0, SWEPT_B - 1):
        net.get_node("qif").set_param("weights", Ws[b])
        net.reset({"qif": y0})
        one = net.run(drive, **kw).to_numpy(("qif", "v"))
        np.testing.assert_allclose(res[b], one, rtol=1e-5, atol=1e-7)
        diffs[str(b)] = float(np.abs(res[b] - one).max())
    if not np.abs(res[0] - res[-1]).max() > 0.0:
        raise AssertionError("run_batch_path (swept int4): the trials do not differ")
    emit({"phase": "run_batch_path", "coupling": "int4_master swept per trial", "n": N,
          "B": SWEPT_B, "steps": SWEPT_STEPS, "launches": launches, "build_s": build_s,
          "run_batch_s": run_s, "ms_per_step": run_s / SWEPT_STEPS * 1e3,
          "trials_vs_single_max_abs_diff": diffs})
    del net, Ws
    torch.cuda.empty_cache()
    return launches


def generic_batch_phase(errs: dict) -> list:
    """Phase 26, continued: phase 12's LIF network (the generic kernel) with
    a bf16 coupling (the tensor cores) and at its default f32 coupling (the
    tiled CUDA-core kernel), each built once: run_batch over G_B trials
    (generic_run_batch), then its B-row step alone at the path's shapes
    (generic_rows_timing); then the E/I circuit's K = 2 step in both types
    (ei_rows_timing).  Returns the two instances' ``kernels`` entries."""
    entries, Ws = [], {}
    for coupling, route in (("bfloat16", "mma"), ("float32", "tiled")):
        t0 = time.perf_counter()
        net = lif_net(N, None, coupling)
        build_s = time.perf_counter() - t0
        launches = generic_run_batch(net, coupling, route, build_s)
        entry, Ws[coupling] = generic_rows_timing(net, coupling, route, launches, errs)
        entries.append(entry)
        del net
        torch.cuda.empty_cache()
    ei_rows_timing(Ws)
    return entries


def generic_run_batch(net, coupling: str, route: str, build_s: float) -> int:
    """run_batch of the LIF network ``net`` (the generic kernel, W in
    ``coupling``) over G_B trials of PLAIN_STEPS steps of their own drive:
    one B-row launch a step, every one on ``route`` (generic_fused_rows'
    mma_launches or tiled_launches), none of the single-trial kernel; then
    the single-trial run of trial 0's drive, timed once over the same steps;
    each trial against a single-trial run of its drive over CMP_STEPS
    (fused_vs_plain's rule: the B-row and the single-trial kernel sum in
    other orders).  Prints the run_batch_path line; returns the launches on
    the route."""
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_rows, generic_fused_step

    ins = (np.random.default_rng(26).normal(size=(G_B, PLAIN_STEPS, 1))
           + np.linspace(0.0, 2.0, G_B)[:, None, None]).astype(np.float32)
    y0 = net.get_node("lif").y.clone()
    counter = f"{route}_launches"
    generic_fused_rows.launches = generic_fused_rows.mma_launches = 0
    generic_fused_rows.tiled_launches = generic_fused_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.run_batch(ins, record_output=False, record_vars=[("lif", "s", True)],
                        sampling_steps=100)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, route_launches = generic_fused_rows.launches, getattr(generic_fused_rows, counter)
    if (launches, route_launches, generic_fused_step.launches) != (PLAIN_STEPS, PLAIN_STEPS, 0):
        raise AssertionError(f"run_batch_path (generic, {coupling}): {launches} B-row launches "
                             f"({route_launches} on route {route!r}) and "
                             f"{generic_fused_step.launches} single-trial launches for "
                             f"{PLAIN_STEPS} steps")
    rec = res[("lif", "s")]
    if (rec.shape != (G_B, PLAIN_STEPS // 100) or not np.all(np.isfinite(rec))
            or not rec.max() > 0.0):
        raise AssertionError(f"run_batch_path (generic, {coupling}): bad records "
                             f"(shape {rec.shape})")
    # the single-trial path, timed once over the same steps
    net.reset({"lif": y0})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.run(ins[0], record_output=False, record_vars=[("lif", "s", True)], sampling_steps=100,
            verbose=False)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    net.reset({"lif": y0})  # run_batch starts every trial from the network's state
    short = net.run_batch(ins[:, :CMP_STEPS], sampling_steps=10)["out"]
    cmp = []
    for b in range(G_B):
        net.reset({"lif": y0})
        one = net.run(ins[b, :CMP_STEPS], sampling_steps=10, verbose=False).to_numpy("out")
        if one.std() > 0:
            cmp.append(vs_cpu(f"run_batch_path (generic, {coupling}) trial {b}", short[b], one)[
                "max_abs_diff"])
        else:  # a trial without a spike yet: s stays 0 in both
            np.testing.assert_array_equal(short[b], one)
            cmp.append(0.0)
    nu_b, nu_1 = G_B * N * PLAIN_STEPS / run_s, N * PLAIN_STEPS / single_s
    emit({"phase": "run_batch_path", "template": "lif", "coupling": coupling,
          "kernel": "generic_fused_rows (one B-row launch a step)", "n": N, "B": G_B,
          "steps": PLAIN_STEPS, "launches": launches, "kernel_route": route,
          counter: route_launches, "build_s": build_s, "run_batch_s": run_s,
          "run_single_s": single_s, "ms_per_step": run_s / PLAIN_STEPS * 1e3,
          "single_ms_per_step": single_s / PLAIN_STEPS * 1e3,
          "aggregate_neuron_updates_per_s": nu_b, "single_neuron_updates_per_s": nu_1,
          "ratio_to_single": nu_b / nu_1, "mean_s_range": [float(rec.min()), float(rec.max())],
          "trials_vs_single_max_abs_diff": max(cmp)})
    return route_launches


GENERIC_PROBES = (("ring_and_shared_loads_no_fma", 1), ("no_staging_of_sources", 2),
                  ("ring_stream_only", 4))  # the tiled kernel's (rows_tiled.cuh's kProbe*)


def generic_rows_timing(net, w_name: str, route: str, launches: int, errs: dict) -> tuple:
    """The LIF network's B-row step alone at the path's shapes (G_B trials'
    rows as generic_rows_operands draws them; W the network's, in
    ``w_name``) on ``route``: held to the CUDA cores' vector instance
    (route code "vec" through the C entry) under GENERIC_TOL["reset"], then
    timed in turns with it (kernel, vec, vec, kernel); its plain version,
    torch.matmul of the same W on the (G_B, N) rows and its bound.  On the
    tensor cores also in turns with the G_B single-trial launches it
    replaces; on the tiled kernel also its probes and nvidia-smi's SM clock
    and power while it runs back to back.  Returns (the ``kernels`` entry,
    W)."""
    from rectipy_tpu_torch.ops.generic_fused import (generic_fused_rows, generic_fused_rows_plain,
                                                     generic_fused_step)
    from rectipy_tpu_torch.testing import (check_generic, generic_rows_instance,
                                           generic_rows_operands)

    node = net.get_node("lif")
    step = node._fused_cfg["step"]
    W = node.args["__w_fused_0__"]
    vecs = [node.args[f"__row_{k}__"] for k in step.vec_keys]
    srcs, drive, states, _ = generic_rows_operands(step, N, G_B, np.random.default_rng(262),
                                                   W.device)

    def rows():
        return generic_fused_rows(step, srcs, [W], drive, states, vecs)

    if generic_route([W], srcs) != route:
        raise AssertionError(f"the LIF B-row step ({w_name}) takes route "
                             f"{generic_route([W], srcs)}, not {route}")
    cores = generic_rows_instance(step, srcs, [W], drive, states, vecs, "vec")
    got, other = rows(), cores()
    for b in range(G_B):  # the two instances sum in other orders
        check_generic(other[b], got[b], step)
    vec_err = float((got - other).abs().max())
    del got, other
    turns = [cuda_ms(f, reps=100) for f in (rows, cores, cores, rows)]
    ms, cores_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    extra = {"turns_ms": turns, "vec_instance_ms_in_turns": cores_ms,
             "speedup_over_vec_instance": cores_ms / ms,
             "max_abs_diff_vec_instance": vec_err}
    if route == "mma":
        # in turns with the G_B single-trial launches (at most about a
        # thousand kernels queued in cuda_ms: 20 loops of G_B)
        singles = [([t[b] for t in srcs], drive[b], [t[b].contiguous() for t in states])
                   for b in range(G_B)]

        def loop():
            for sb, db, stb in singles:
                generic_fused_step(step, sb, [W], db, stb, vecs)

        loop_turns = [cuda_ms(f, reps=r) for f, r in ((rows, 100), (loop, 20), (loop, 20),
                                                      (rows, 100))]
        loop_ms = (loop_turns[1] + loop_turns[2]) / 2
        extra.update(loop_turns_ms=loop_turns, single_trial_launches_ms_in_turns=loop_ms,
                     speedup_over_single_trial_launches=loop_ms / ms)
        del singles
    else:
        extra["probe_ms"] = {
            name: cuda_ms(generic_rows_instance(step, srcs, [W], drive, states, vecs, route,
                                                probe=probe), reps=100)
            for name, probe in GENERIC_PROBES}
        extra["clock_and_power"] = clock_and_power(rows)
    plain_ms = cuda_ms(lambda: generic_fused_rows_plain(step, srcs, [W], drive, states, vecs),
                       reps=3)
    s_w = srcs[0].to(W.dtype)
    library_ms = cuda_ms(lambda: s_w @ W.T, reps=100)
    n_bytes, n_ops, bound_ms, bound_by = rows_bound(step, [W], G_B, len(vecs),
                                                    tail_ops(node._vf.tile_program))
    name = f"generic_fused_rows[lif,{w_name},{route}]"
    entry = {"name": name, "route": "cuda", "source": GENERIC_SOURCE,
             "replaces": GENERIC_TPU_KERNEL, "launches": launches, "max_abs_err": errs[name],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
    emit({"phase": "batch_timing", **entry, "kernel_route": route, "B": G_B, "bytes": n_bytes,
          "ops": n_ops, **extra, "f32_fma_bound_ms": 2 * G_B * N * N / F32_FLOPS * 1e3,
          "library_ms_reason": f"torch.matmul of the (B, N) source rows by W^T in {w_name} "
                               f"(the products alone): a yardstick",
          "achieved_bytes_per_s": n_bytes / (ms * 1e-3), "achieved_flops": n_ops / (ms * 1e-3)})
    del srcs, drive, states, s_w
    torch.cuda.empty_cache()
    return entry, W


def rows_bound(step, Ws, B: int, P: int, ops_per_neuron: int) -> tuple:
    """Bytes and operations of one B-row generic step at N (each W, the B
    trials' K sources, drive and V states read once, their V outputs
    written once, the P per-neuron rows read once; the products and the
    tail), and the bound they give: (bytes, ops, bound ms, bound_by)."""
    K, V = len(Ws), len(step.state_order)
    n_bytes = sum(W.numel() * W.element_size() for W in Ws) + 4 * N * (B * (K + 1 + 2 * V) + P)
    n_ops = 2 * K * B * N * N + B * N * ops_per_neuron
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_flops(Ws[0].dtype)
    return n_bytes, n_ops, max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ei_rows_timing(Ws: dict) -> None:
    """The E/I circuit's B-row step (K = 2) at B = G_B for each W type of
    ``Ws`` (the LIF network's W and half its transpose): bf16 on the tensor
    cores, f32 on the tiled kernel, which is also held to the CUDA cores'
    vector instance and timed in turns with it (tiled, vec, vec, tiled),
    and whose probes are timed;
    each held to its plain version first, with its bound, its plain
    version's ms and two torch.matmul of the same W as the yardstick."""
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_rows, generic_fused_rows_plain
    from rectipy_tpu_torch.testing import (check_generic, generic_rows_instance,
                                           generic_rows_operands)

    node = ei_net(16, "cpu")[0].get_node("ei")  # the step does not depend on n
    step = node._fused_cfg["step"]
    for w_name, W in Ws.items():
        pair = [W, (0.5 * W.T).contiguous()]
        srcs, drive, states, vecs = generic_rows_operands(step, N, G_B,
                                                          np.random.default_rng(263), W.device)
        route = generic_route(pair, srcs)
        if route != ("mma" if w_name == "bfloat16" else "tiled"):
            raise AssertionError(f"the E/I B-row step ({w_name}) takes route {route}")

        def rows():
            return generic_fused_rows(step, srcs, pair, drive, states, vecs)

        got = rows()
        ref = generic_fused_rows_plain(step, srcs, pair, drive, states, vecs)
        for b in range(G_B):
            check_generic(got[b], ref[b], step)
        extra = {}
        if route == "tiled":  # in turns with the vector instance, held to it first
            cores = generic_rows_instance(step, srcs, pair, drive, states, vecs, "vec")
            old = cores()
            for b in range(G_B):
                check_generic(got[b], old[b], step)
            turns = [cuda_ms(f, reps=100) for f in (rows, cores, cores, rows)]
            ms, cores_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            extra = {"turns_ms": turns, "vec_instance_ms_in_turns": cores_ms,
                     "speedup_over_vec_instance": cores_ms / ms,
                     "max_abs_diff_vec_instance": float((got - old).abs().max()),
                     "probe_ms": {
                         name: cuda_ms(generic_rows_instance(step, srcs, pair, drive, states,
                                                             vecs, route, probe=probe), reps=100)
                         for name, probe in GENERIC_PROBES}}
            del old
        else:
            ms = cuda_ms(rows, reps=100)
        plain_ms = cuda_ms(lambda: generic_fused_rows_plain(step, srcs, pair, drive, states,
                                                            vecs), reps=3)
        s_w = [t.to(W.dtype) for t in srcs]
        library_ms = cuda_ms(lambda: [x @ w.T for x, w in zip(s_w, pair)], reps=100)
        n_bytes, n_ops, bound_ms, bound_by = rows_bound(step, pair, G_B, len(vecs),
                                                        tail_ops(node._vf.tile_program))
        emit({"phase": "batch_timing", "name": f"generic_fused_rows[ei,{w_name},{route}]",
              "kernel_route": route, "couplings": 2, "n": N, "B": G_B,
              "max_abs_err": float((got - ref).abs().max()), "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra,
              "library_ms_reason": f"two torch.matmul of the (B, N) source rows by W^T in "
                                   f"{w_name} (the products alone): a yardstick",
              "bytes": n_bytes, "ops": n_ops, "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
        del pair, srcs, drive, states, s_w, got, ref
        torch.cuda.empty_cache()


def batch_train_data(n: int, B: int, T: int, seed: int):
    """bench.py's ensemble trial arrays: normal (B, T, n) from default_rng(seed),
    float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, n)).astype(np.float32),
            rng.normal(size=(B, T, n)).astype(np.float32))


def batch_train_phase(dev, data, single_nu: float) -> tuple:
    """Phase 27: bench.py's ensemble phase at full size (fit_bptt_batch,
    B_TRAIN trials, int8_master, adam lr 1e-4, full batch), a warm fit and a
    timed one; then batch_train_vs_cpu at CPU_N.  Returns (launches, ms per
    epoch, the staged trial arrays, the network)."""
    from rectipy_tpu_torch.ops.fused_opt import adam_requant
    from rectipy_tpu_torch.ops.quant import int8_mm, int8_mm_t, int8_mv, int8_mv_t

    W_np, etas = data[0], data[1]
    t0 = time.perf_counter()
    ins, tgts = batch_train_data(N, B_TRAIN, T_TRAIN, 7)
    ins_d = torch.as_tensor(ins, device=dev)
    tgt_d = torch.as_tensor(tgts, device=dev)
    del ins, tgts
    data_s = time.perf_counter() - t0
    net = build_train_net(W_np, etas)
    kernels = (int8_mm, int8_mm_t, int8_mv, int8_mv_t, adam_requant)

    def fit_b(epochs):
        for k in kernels:
            k.launches = 0
        int8_mm.mma_launches = int8_mm_t.mma_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = net.fit_bptt_batch(ins_d, tgt_d, n_epochs=epochs, optimizer="adam", lr=LR,
                                 verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = [float(x) for x in obs["epoch_loss"]]
        if len(losses) != epochs or not np.all(np.isfinite(losses)):
            raise AssertionError(f"batch_train_path: bad losses {losses}")
        counts = {k.__name__: k.launches for k in kernels}
        counts["int8_mm_tensor_core"] = int8_mm.mma_launches
        counts["int8_mm_t_tensor_core"] = int8_mm_t.mma_launches
        return seconds, losses, counts

    warm_s, warm_losses, _ = fit_b(WARM_EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    seconds, losses, launches = fit_b(TRAIN_EPOCHS)
    want = {"int8_mm": T_TRAIN * TRAIN_EPOCHS, "int8_mm_t": T_TRAIN * TRAIN_EPOCHS,
            "int8_mv": 0, "int8_mv_t": 0, "adam_requant": 0,  # every int8_mm(_t) on "mma":
            "int8_mm_tensor_core": T_TRAIN * TRAIN_EPOCHS,
            "int8_mm_t_tensor_core": T_TRAIN * TRAIN_EPOCHS}
    if launches != want:
        raise AssertionError(f"batch_train_path: launches {launches}, expected {want}")
    if net.last_fit != {"trajectory": "chain", "fused_adam": False}:
        raise AssertionError(f"batch_train_path took {net.last_fit}")
    epoch_s = seconds / TRAIN_EPOCHS
    nu = B_TRAIN * T_TRAIN * N / epoch_s
    emit({"phase": "batch_train_path", "n": N, "T": T_TRAIN, "B": B_TRAIN,
          "epochs": TRAIN_EPOCHS, "coupling": "int8_master", "optimizer": "adam", "lr": LR,
          "batch_size": B_TRAIN, "data_s": data_s, "warm_fit_s": warm_s,
          "warm_epochs": WARM_EPOCHS, "fit_s": seconds, "ms_per_epoch": epoch_s * 1e3,
          "aggregate_trained_neuron_updates_per_s": nu,
          "single_trial_trained_neuron_updates_per_s": single_nu,
          "ratio_to_single_trial": nu / single_nu, "launches_per_fit": launches,
          "first_loss": warm_losses[0], "losses_timed_fit": losses,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    batch_train_vs_cpu("int8_master")
    return launches, epoch_s * 1e3, (ins_d, tgt_d), net


def batch_train_vs_cpu(coupling: str):
    """Phase 27, continued: the ensemble fit of ``coupling`` at CPU_N, CPU_B
    trials, CPU_T steps and CPU_EPOCHS epochs on the card and on the CPU
    (plain products), held to BATCH_LOSS_RTOL and BATCH_W_SHARE."""
    rng = np.random.default_rng(27)
    Wc = (rng.random((CPU_N, CPU_N)) < 0.1) * (1.0 / (0.1 * CPU_N))
    etas_c = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, CPU_N + 1) - CPU_N - 1)
                           / (CPU_N + 1))
    ins_c, tgt_c = batch_train_data(CPU_N, CPU_B, CPU_T, 28)
    res = {}
    for device in (None, "cpu"):
        n_ = build_train_net(Wc, etas_c, device=device, coupling=coupling)
        t0 = time.perf_counter()
        obs = n_.fit_bptt_batch(ins_c, tgt_c, n_epochs=CPU_EPOCHS, optimizer="adam", lr=LR,
                                verbose=False)
        res[device or "card"] = (np.asarray(obs["epoch_loss"]),
                                 n_.get_node("qif")["weights"].cpu().numpy(),
                                 time.perf_counter() - t0)
    (l_card, w_card, s_card), (l_cpu, w_cpu, s_cpu) = res["card"], res["cpu"]
    loss_rel = float(np.max(np.abs(l_card - l_cpu) / np.abs(l_cpu)))
    w0 = Wc.astype(np.float32)
    d_card, d_cpu = w_card - w0, w_cpu - w0
    share = float(np.mean(np.abs(d_card - d_cpu) > 0.01 * LR))
    if loss_rel > BATCH_LOSS_RTOL or share > BATCH_W_SHARE or not np.abs(d_cpu).max() > 0:
        raise AssertionError(f"batch_train_vs_cpu ({coupling}): loss rel {loss_rel}, share of "
                             f"weights whose updates differ {share}")
    emit({"phase": "batch_train_vs_cpu", "coupling": coupling, "n": CPU_N, "B": CPU_B,
          "T": CPU_T, "epochs": CPU_EPOCHS, "losses_card": [float(x) for x in l_card],
          "losses_cpu": [float(x) for x in l_cpu],
          "max_rel_loss_diff": loss_rel, "loss_rtol": BATCH_LOSS_RTOL,
          "share_of_weight_updates_differing": share, "share_limit": BATCH_W_SHARE,
          "max_abs_weight_diff": float(np.abs(w_card - w_cpu).max()),
          "max_abs_weight_update": float(np.abs(d_cpu).max()), "card_s": s_card,
          "cpu_s": s_cpu})


def batch_train_int4_phase(data, staged, int4_nu: float) -> dict:
    """Phase 27, continued: the ensemble fit with an int4_master coupling on
    the int8 fit's staged trials (B_TRAIN x T_TRAIN), a 1-epoch warm fit and
    a timed I4_TRAIN_EPOCHS-epoch one: int4_mm and int4_mm_t once a step
    each, none of int4_mv(_t); ms/epoch and aggregate trained
    neuron-updates/s beside int4_train_path's (phase 18, this call); then
    batch_train_vs_cpu for int4_master.  Returns the launches of the timed
    fit."""
    from rectipy_tpu_torch.ops.quant import int4_mm, int4_mm_t, int4_mv, int4_mv_t

    ins_d, tgt_d = staged
    net = build_train_net(data[0], data[1], coupling="int4_master")
    kernels = (int4_mm, int4_mm_t, int4_mv, int4_mv_t)

    def fit_b(epochs):
        for k in kernels:
            k.launches = 0
        int4_mm.mma_launches = int4_mm_t.mma_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = net.fit_bptt_batch(ins_d, tgt_d, n_epochs=epochs, optimizer="adam", lr=LR,
                                 verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = [float(x) for x in obs["epoch_loss"]]
        if len(losses) != epochs or not np.all(np.isfinite(losses)):
            raise AssertionError(f"batch_train_path (int4_master): bad losses {losses}")
        return seconds, losses, {k.__name__: k.launches for k in kernels}

    warm_s, warm_losses, _ = fit_b(1)
    seconds, losses, launches = fit_b(I4_TRAIN_EPOCHS)
    steps = T_TRAIN * I4_TRAIN_EPOCHS
    want = {"int4_mm": steps, "int4_mm_t": steps, "int4_mv": 0, "int4_mv_t": 0}
    if launches != want:
        raise AssertionError(f"batch_train_path (int4_master): launches {launches}, "
                             f"expected {want}")
    for k in (int4_mm, int4_mm_t):  # every product, both ways, on the tensor cores
        if k.mma_launches != steps:
            raise AssertionError(f"batch_train_path (int4_master): {k.mma_launches} of "
                                 f"{steps} {k.__name__} launches took the tensor-core route")
    if net.last_fit != {"trajectory": "chain", "fused_adam": False}:
        raise AssertionError(f"batch_train_path (int4_master) took {net.last_fit}")
    epoch_s = seconds / I4_TRAIN_EPOCHS
    nu = B_TRAIN * T_TRAIN * N / epoch_s
    emit({"phase": "batch_train_path", "n": N, "T": T_TRAIN, "B": B_TRAIN,
          "epochs": I4_TRAIN_EPOCHS, "coupling": "int4_master", "optimizer": "adam", "lr": LR,
          "batch_size": B_TRAIN, "warm_fit_s": warm_s, "warm_epochs": 1, "fit_s": seconds,
          "ms_per_epoch": epoch_s * 1e3, "aggregate_trained_neuron_updates_per_s": nu,
          "single_trial_trained_neuron_updates_per_s": int4_nu,
          "ratio_to_single_trial": nu / int4_nu, "launches_per_fit": launches,
          "int4_mm_tensor_core_launches": int4_mm.mma_launches,
          "int4_mm_t_tensor_core_launches": int4_mm_t.mma_launches,
          "first_loss": warm_losses[0], "losses_timed_fit": losses})
    del net
    torch.cuda.empty_cache()
    batch_train_vs_cpu("int4_master")
    return launches


def rows_probe_ms(route: str, W, v, s, x, eta, inp) -> dict:
    """Phase 28: ms of the B-row QIF kernel's probes (csrc/qif_sfa_step.cu
    and csrc/rows_tiled.cuh, kProbe) on the timed operands; their outputs
    are meaningless.  "mma" (the tensor cores): the kernel's W stream with
    its fragment reads and its barrier between chunks, and the same without
    the barrier (no staging of s, no products).  "tiled" (f32): the ring's
    stream and the micro-tiles' shared loads without the FMAs, the kernel
    without the copies of s, and the ring's stream alone (no loads, no
    FMAs)."""
    from rectipy_tpu_torch.ops._build import build

    lib = build("qif_sfa_step").lib
    if route == "mma":
        fn = lib.qif_sfa_rows_probe_launch
        probes = (("w_stream_fragments_barrier", 3), ("w_stream_fragments", 7))
    else:
        fn = lib.qif_sfa_rows_tiled_probe_launch
        probes = (("ring_and_shared_loads_no_fma", 1), ("no_staging_of_s", 2),
                  ("ring_stream_only", 4))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, P, P, P, P, L, L, L, L, L, P, I, I, P]
    fn.restype = I
    B, n = v.shape
    out = torch.empty((B, 3, n), dtype=torch.float32, device=v.device)
    lds = [t.stride(0) if t.dim() == 2 else 0 for t in (v, s, x, eta, inp)]
    ms = {}
    for name, probe in probes:
        def run(probe=probe):
            err = fn(probe, W.data_ptr(), v.data_ptr(), s.data_ptr(), x.data_ptr(),
                     eta.data_ptr(), inp.data_ptr(), *lds, out.data_ptr(), n, B,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"B-row probe {route} {probe}: CUDA error {err}")
        ms[name] = cuda_ms(run, reps=100)
    return ms


def dp4a_turns(name: str, fn, wq, act, scales) -> tuple:
    """Phase 28: int8_mm, int8_mm_t, int4_mm or int4_mm_t (``name``; ``fn``,
    the tensor cores) in turns with its __dp4a instance on the same operands
    (the "vec" route, called through the C launch): kernel, __dp4a, __dp4a,
    kernel.  ``wq``: the int8 or packed int4 weights; ``act``: the
    activations (xq or vq); ``scales``: int8_mm's and int4_mm's (row scale,
    activation scales), int8_mm_t's activation scales or int4_mm_t's
    (activation scales, n_in).  Returns the kernel's mean ms and the line's
    extra keys."""
    from rectipy_tpu_torch.ops import quant

    n_out, n_in = wq.shape
    B = act.shape[0]
    lib, vec = quant._lib(), quant._ROUTES["vec"]
    stream = torch.cuda.current_stream().cuda_stream
    if name == "int4_mm":
        route = quant.int4_mm_route(wq.shape[1], wq.data_ptr())
        ws, xs = scales
        n_in = act.shape[1]
        out = torch.empty((B, n_out), dtype=torch.float32, device=wq.device)

        def launch():
            return quant._lib4().int4_mm_launch(wq.data_ptr(), act.data_ptr(), ws.data_ptr(),
                                                xs.data_ptr(), out.data_ptr(), n_out, n_in,
                                                wq.shape[1], B, vec, stream)
    elif name == "int4_mm_t":
        route = quant.int4_mm_t_route(wq.shape[1], wq.data_ptr())
        vs, n_in = scales
        lib4 = quant._lib4()
        scratch = torch.empty(lib4.int4_mm_t_scratch(n_out, n_in, B, vec), dtype=torch.int32,
                              device=wq.device)
        out = torch.empty((B, n_in), dtype=torch.float32, device=wq.device)

        def launch():
            return lib4.int4_mm_t_launch(wq.data_ptr(), act.data_ptr(), vs.data_ptr(),
                                         scratch.data_ptr(), out.data_ptr(), n_out, n_in,
                                         wq.shape[1], B, vec, stream)
    elif name == "int8_mm":
        route = quant.int8_mm_route(n_in, wq.data_ptr())
        ws, xs = scales
        out = torch.empty((B, n_out), dtype=torch.float32, device=wq.device)

        def launch():
            return lib.int8_mm_launch(wq.data_ptr(), act.data_ptr(), ws.data_ptr(),
                                      xs.data_ptr(), out.data_ptr(), n_out, n_in, B, vec, stream)
    else:
        route = quant.int8_mm_t_route(n_in, wq.data_ptr())
        scratch = torch.empty(lib.int8_mm_t_scratch(n_out, n_in, B, vec), dtype=torch.int32,
                              device=wq.device)
        out = torch.empty((B, n_in), dtype=torch.float32, device=wq.device)

        def launch():
            return lib.int8_mm_t_launch(wq.data_ptr(), act.data_ptr(), scales.data_ptr(),
                                        scratch.data_ptr(), out.data_ptr(), n_out, n_in, B, vec,
                                        stream)

    def dp4a():
        err = launch()
        if err:
            raise RuntimeError(f"{name}_launch (vec): CUDA error {err}")
        return out

    if not torch.equal(dp4a(), fn()):
        raise AssertionError(f"{name}: the tensor-core and __dp4a instances differ")
    turns = [cuda_ms(f, reps=200) for f in (fn, dp4a, dp4a, fn)]
    ms, dp4a_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return ms, {"kernel_route": route, "turns_ms": turns, "dp4a_ms_in_turns": dp4a_ms,
                "speedup_over_dp4a": dp4a_ms / ms}


def batch_timing(dev, W_np, net, staged, epoch_ms: float, launches: dict, run_launches: dict,
                 errs: dict) -> list:
    """Phase 28: each new kernel's ms at the paths' shapes with its bound,
    plain ms and yardstick; one B_TRAIN epoch split by CUDA events; the
    device's idle share over one epoch."""
    from rectipy_tpu_torch.ops import bptt
    from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step, rows_route
    from rectipy_tpu_torch.ops.quant import (int8_mm, int8_mm_plain, int8_mm_t, int8_mm_t_plain,
                                             quant_vec, quantize_rows)
    from rectipy_tpu_torch.testing import qif_rows_instance
    from rectipy_tpu_torch.train import get_optimizer

    ins_d, tgt_d = staged
    B = B_TRAIN
    W32 = torch.as_tensor(W_np, dtype=torch.float32, device=dev)
    wq, ws = quantize_rows(W32)
    gen = torch.Generator(device=dev).manual_seed(28)
    xq, xs = quant_vec(torch.randn((B, N), generator=gen, device=dev))
    vq, vs = quant_vec(torch.randn((B, N), generator=gen, device=dev) * 1e-3)
    xs, vs = xs.reshape(-1), vs.reshape(-1)
    wq_cm = wq.T.contiguous().T  # column-major wq for torch._int_mm's transposed product
    entries = []
    specs = [
        ("int8_mm", "rectipy_tpu_torch/csrc/int8_matvec.cu",
         "port-only (rectipy_tpu/ops/quant.py:65 under vmap)",
         lambda: int8_mm(wq, xq, ws, xs), lambda: (int8_mm_plain(wq, xq) * ws) * xs[:, None],
         lambda: torch._int_mm(xq, wq.T),
         N * N + B * N + 4 * N + 4 * B + 4 * B * N, 2 * B * N * N, INT8_OPS,
         launches["int8_mm"]),
        ("int8_mm_t", "rectipy_tpu_torch/csrc/int8_matvec.cu",
         "port-only (rectipy_tpu/ops/quant.py:73 under vmap)",
         lambda: int8_mm_t(wq, vq, vs), lambda: int8_mm_t_plain(wq, vq) * vs[:, None],
         lambda: torch._int_mm(vq, wq_cm),
         N * N + B * N + 4 * B + 4 * B * N, 2 * B * N * N, INT8_OPS, launches["int8_mm_t"]),
    ]
    for name, source, replaces, fn, plain, lib, n_bytes, n_ops, peak, n_launch in specs:
        # the tensor cores in turns with the __dp4a instance
        ms, extra = (dp4a_turns(name, fn, wq, xq, (ws, xs)) if name == "int8_mm"
                     else dp4a_turns(name, fn, wq, vq, vs))
        plain_ms = cuda_ms(plain, reps=5)
        library_ms = cuda_ms(lib, reps=200)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": n_launch, "max_abs_err": errs[name], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": library_ms}
        entries.append(entry)
        emit({"phase": "batch_timing", **entry, **extra, "B": B, "bytes": n_bytes,
              "ops": n_ops,
              "library_ms_reason": "torch._int_mm of the same integers (int32 sums without "
                                   "the scales): a yardstick" + (
                                       "; its W is a column-major copy, transposed in memory "
                                       "beforehand" if name == "int8_mm_t" else ""),
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
        if name == "int8_mm":  # run_batch_path's instance: the same (B_RUN = B_TRAIN, N) shapes
            entries.append({**entry, "name": "int8_mm[run_batch_path]",
                            "launches": run_launches["int8"]})
    # the B-row step at the run_batch path's shapes (B_RUN trials)
    params = dict(dt=DT, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05, thresh=100.0,
                  v_reset=-100.0)
    v, s, x, eta, inp = rows_state(B_RUN, N, "reset", np.random.default_rng(28), dev)
    for name, W in (("float32", W32), ("bfloat16", W32.to(torch.bfloat16))):
        n_bytes = N * N * W.element_size() + B_RUN * N * 4 * 5 + B_RUN * N * 4 * 3
        n_ops = 2 * B_RUN * N * N + 20 * B_RUN * N
        route = rows_route(W.dtype, N, s.stride(0), W.data_ptr(), s.data_ptr())
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_flops(W.dtype)

        def kernel():
            return qif_sfa_step(v, s, x, W, eta, inp, **params)

        extra = {}
        if route == "tiled":  # in turns with the CUDA cores' vector instance, held to it first
            def vec():
                return qif_rows_instance("vec", W, v, s, x, eta, inp, params)

            torch.testing.assert_close(kernel(), vec(), rtol=TOL["reset"][0],
                                       atol=TOL["reset"][1])
            turns = [cuda_ms(f, reps=100) for f in (kernel, vec, vec, kernel)]
            ms, vec_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            extra = {"turns_ms": turns, "vec_instance_ms_in_turns": vec_ms,
                     "speedup_over_vec_instance": vec_ms / ms,
                     "clock_and_power": clock_and_power(kernel)}
        else:
            ms = cuda_ms(kernel, reps=100)
        plain_ms = cuda_ms(lambda: qif_sfa_reference_step(v, s, x, W, eta, inp, **params),
                           reps=10)
        s_w = s.contiguous().to(W.dtype)
        library_ms = cuda_ms(lambda: s_w @ W.T, reps=100)
        entry = {"name": f"qif_sfa_step_rows[{name}]", "route": "cuda",
                 "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
                 "launches": run_launches[name],
                 "max_abs_err": errs[f"qif_sfa_step_rows[{name}]"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": library_ms}
        entries.append(entry)  # the run_batch path's instances (phase 26's launches)
        emit({"phase": "batch_timing", **entry, "kernel_route": route, **extra,
              "probe_ms": rows_probe_ms(route, W, v, s, x, eta, inp), "B": B_RUN,
              "bytes": n_bytes, "ops": n_ops,
              "library_ms_reason": f"torch.matmul of the (B, N) s by W^T in {name} "
                                   f"(the products alone)",
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3),
              "achieved_flops": n_ops / (ms * 1e-3)})
    del v, s, x, eta, inp
    # one B_TRAIN epoch split by CUDA events: the trajectory's forward loop,
    # its backward loop (less the dW product), the dW product (timed alone at
    # the same shapes) and the split adam step
    node = net.get_node("qif")
    traj, wkeys = bptt.make_coupled_traj(node)
    p = bptt._node_pieces(node)
    args = {k: v for k, v in node.args.items() if k not in wkeys}
    Wm = node.args["weights"]
    y0 = net._batch_state(net.init_state(), B)["nodes"]["qif"]
    xs_tm = ins_d.transpose(0, 1).contiguous()
    opt = get_optimizer("adam", LR)
    train = {"nodes": {"qif": {"weights": Wm}}, "edges": {}}
    opt_state = opt.init(train)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    W_leaf = Wm.detach().requires_grad_(True)
    with torch.enable_grad():
        ev[0].record()
        _, outs = traj({"weights": W_leaf}, args, y0, xs_tm)
        ev[1].record()
        loss = torch.stack([torch.mean((o - t) ** 2)
                            for o, t in zip(outs.transpose(0, 1), tgt_d)]).mean()
        (gW,) = torch.autograd.grad(loss, W_leaf)
        ev[2].record()
    deltas = torch.randn((T_TRAIN, B, N), device=dev)
    ev[3].record()
    p.grad_ws[0](deltas, deltas)
    ev[4].record()
    opt.update({"nodes": {"qif": {"weights": gW}}, "edges": {}}, opt_state, train)
    ev[5].record()
    torch.cuda.synchronize()
    fwd, bwd_all, dw = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                        ev[3].elapsed_time(ev[4]))
    parts = dict(zip(("forward_loop", "backward_loop", "dW_matmul", "optimizer"),
                     (fwd, bwd_all - dw, dw, ev[4].elapsed_time(ev[5]))))
    del outs, gW, deltas, loss, xs_tm
    dw_flops = 2.0 * T_TRAIN * B * N * N
    busy_ms, top = profile_device_time(
        lambda: net.fit_bptt_batch(ins_d, tgt_d, n_epochs=1, optimizer="adam", lr=LR,
                                   verbose=False))
    emit({"phase": "batch_timing_top_device_ops", "top": top})
    emit({"phase": "batch_timing", "B": B, "epoch_split_ms": parts, "ms_per_epoch": epoch_ms,
          "dW_flops": dw_flops, "dW_achieved_flops": dw_flops / (dw * 1e-3) if dw > 0 else None,
          "dW_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
          "profiled_device_busy_ms": busy_ms,
          "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / epoch_ms})
    return entries


def int4_batch_timing(dev, W_np, train_launches: dict, run_launches: dict, errs: dict) -> list:
    """Phase 28, continued: int4_mm and int4_mm_t at N = 10,000, B = B_TRAIN
    on the main path's W quantized to int4 (bound, plain ms, and as the
    yardstick torch._int_mm of the same integers unpacked to int8: for
    int4_mm_t on a column-major copy), each in turns with the B_TRAIN
    int4_mv (int4_mv_t) launches it replaces on the same rows; both also
    in turns with their __dp4a instances, at N = 10,000 and at the
    microbenchmark's N = 14,336 (random weights over the full nibble
    range), whose 103 MB of packed W cannot stay in L2."""
    from rectipy_tpu_torch.ops.quant import (int4_mm, int4_mm_plain, int4_mm_t, int4_mm_t_plain,
                                             int4_mv, int4_mv_t, pack_int4, quant_vec,
                                             quantize_rows_i4)

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    B = B_TRAIN
    wq, ws = quantize_rows_i4(torch.as_tensor(W_np, dtype=torch.float32, device=dev))
    wp = pack_int4(wq)
    wq_cm = wq.T.contiguous().T
    gen = torch.Generator(device=dev).manual_seed(281)
    xq, xs = quant_vec(torch.randn((B, N), generator=gen, device=dev))
    vq, vs = quant_vec(torch.randn((B, N), generator=gen, device=dev) * 1e-3)
    xs, vs = xs.reshape(-1), vs.reshape(-1)
    rows_x = [xq[b] for b in range(B)]
    rows_v = [vq[b] for b in range(B)]
    packed = wp.numel()
    specs = [
        ("int4_mm", lambda: int4_mm(wp, xq, ws, xs),
         lambda: [int4_mv(wp, x, ws, xs[b]) for b, x in enumerate(rows_x)],
         lambda: (int4_mm_plain(wp, xq) * ws) * xs[:, None], lambda: torch._int_mm(xq, wq.T),
         packed + B * N + 4 * N + 4 * B + 4 * B * N),
        ("int4_mm_t", lambda: int4_mm_t(wp, vq, vs, N),
         lambda: [int4_mv_t(wp, v, vs[b], N) for b, v in enumerate(rows_v)],
         lambda: int4_mm_t_plain(wp, vq, N) * vs[:, None], lambda: torch._int_mm(vq, wq_cm),
         packed + B * N + 4 * B + 4 * B * N),
    ]
    entries = []
    for name, fn, singles, plain, lib, n_bytes in specs:
        # at most about a thousand kernels queued in cuda_ms (int4_mv_t is two)
        turns = [cuda_ms(f, reps=r) for f, r in ((fn, 200), (singles, 10), (singles, 10),
                                                 (fn, 200))]
        ms, singles_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        # the tensor cores in turns with the __dp4a instance
        ms, extra = (dp4a_turns(name, fn, wp, xq, (ws, xs)) if name == "int4_mm"
                     else dp4a_turns(name, fn, wp, vq, (vs, N)))
        plain_ms = cuda_ms(plain, reps=5)
        library_ms = cuda_ms(lib, reps=200)
        n_ops = 2 * B * N * N
        bound_ms, bound_by = bound(n_bytes, n_ops)
        entry = {"name": name, "route": "cuda", "source": I4_SOURCE, "replaces": I4_TPU_KERNEL,
                 "launches": train_launches[name], "max_abs_err": errs[name], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms, "kernel_route": extra["kernel_route"]}
        entries.append(entry)
        emit({"phase": "batch_timing", **entry, **extra, "n": N, "B": B, "bytes": n_bytes,
              "ops": n_ops, "single_row_turns_ms": turns,
              "single_row_launches_ms_in_turns": singles_ms,
              "speedup_over_single_row_launches": singles_ms / ms,
              "library_ms_reason": "torch._int_mm of the same integers unpacked to int8 "
                                   "(int32 sums without the scales): a yardstick" + (
                                       "; its W is a column-major copy, transposed in memory "
                                       "beforehand" if name == "int4_mm_t" else ""),
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
        if name == "int4_mm":  # run_batch_path's instance: the same (B_RUN = B_TRAIN, N) shapes
            entries.append({**entry, "name": "int4_mm[run_batch_path]",
                            "launches": run_launches["int4"]})
    del wq, wp, wq_cm, rows_x, rows_v
    torch.cuda.empty_cache()
    n = N_I4PACK
    wq = torch.randint(-8, 8, (n, n), generator=gen, device=dev, dtype=torch.int8)
    wp, ws = pack_int4(wq), torch.rand(n, generator=gen, device=dev) + 0.5
    wq_cm = wq.T.contiguous().T
    xq, xs = quant_vec(torch.randn((B, n), generator=gen, device=dev))
    vq, vs = quant_vec(torch.randn((B, n), generator=gen, device=dev) * 1e-3)
    xs, vs = xs.reshape(-1), vs.reshape(-1)
    specs = [
        ("int4_mm", lambda: int4_mm(wp, xq, ws, xs), xq, (ws, xs),
         lambda: (int4_mm_plain(wp, xq) * ws) * xs[:, None], lambda: torch._int_mm(xq, wq.T),
         wp.numel() + B * n + 4 * n + 4 * B + 4 * B * n),
        ("int4_mm_t", lambda: int4_mm_t(wp, vq, vs, n), vq, (vs, n),
         lambda: int4_mm_t_plain(wp, vq, n) * vs[:, None], lambda: torch._int_mm(vq, wq_cm),
         wp.numel() + B * n + 4 * B + 4 * B * n),
    ]
    for name, fn, act, scales, plain, lib, n_bytes in specs:
        ms, extra = dp4a_turns(name, fn, wp, act, scales)
        n_ops = 2 * B * n * n
        bound_ms, bound_by = bound(n_bytes, n_ops)
        emit({"phase": "batch_timing", "name": name, "n": n, "B": B, "ms": ms, **extra,
              "plain_ms": cuda_ms(plain, reps=5), "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": cuda_ms(lib, reps=200),
              "library_ms_reason": "torch._int_mm of the same integers unpacked to int8 (int32 "
                                   "sums without the scales): a yardstick" + (
                                       "; its W is a column-major copy, transposed in memory "
                                       "beforehand" if name == "int4_mm_t" else ""),
              "bytes": n_bytes, "ops": n_ops, "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
    del wq, wp, wq_cm
    torch.cuda.empty_cache()
    return entries


def batch_phases(dev, W_np, data, single_nu: float, int4_nu: float) -> list:
    """Phases 25-28 (the batched trials of run_batch and fit_bptt_batch).
    Returns the entries of the ``kernels`` line for their kernels."""
    errs = batch_kernel_check(dev, W_np)
    torch.cuda.empty_cache()
    run_launches, _ = run_batch_phase(dev)
    swept_int4_phase(dev)
    generic_entries = generic_batch_phase(errs)
    launches, epoch_ms, staged, net = batch_train_phase(dev, data, single_nu)
    i4_launches = batch_train_int4_phase(data, staged, int4_nu)
    entries = batch_timing(dev, W_np, net, staged, epoch_ms, launches, run_launches, errs)
    del staged, net
    torch.cuda.empty_cache()
    entries += int4_batch_timing(dev, W_np, i4_launches, run_launches, errs)
    entries += generic_entries
    return entries


# ------------------------------------------------------------ phases 30-32
JR = "rectipy_tpu_torch.models.mean_field.jansen_rit.jansen_rit"
WB_M, WB_DT, WB_SPEED = 998, 1e-4, 2.0  # benchmarks/whole_brain_scale.py's M=998 cell
WB_T, WB_T_SHORT, WB_B = 4_000, 2_000, 8  # WB_T 10,000 until PR 18
STP_DRIVE = 100.0  # feedback_phase's drive
FAMILY_N, FAMILY_T, FAMILY_M, FAMILY_FIT_T = 1_000, 500, 90, 1_000
# edge_family_check's fit: the card's loss and gradients (relative norm of
# the difference) against the CPU's, float32 both, whose sums run in another
# order over FAMILY_FIT_T steps.  A delay's gradient is the difference of
# neighbouring history values, so it keeps fewer digits than the weights'.
FIT_LOSS_RTOL, FIT_GRAD_RTOL = 1e-4, 5e-3


def wb_data(M: int, seed: int = 0):
    """benchmarks/whole_brain_scale.py's connectome at width M: region
    positions in a 0.14 m cube from default_rng(seed), W = exp(-dist/0.06)
    with a zero diagonal normalised by in-strength, D = rint(dist / speed /
    dt) and tau_e ~ U(8e-3, 13e-3).  Returns (W, D, tau_e, dist)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 0.14, size=(M, 3))
    dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    W = np.exp(-dist / 0.06)
    np.fill_diagonal(W, 0.0)
    W /= W.sum(axis=0, keepdims=True)  # in-strength (square W auto-transposes)
    D = np.rint(dist / WB_SPEED / WB_DT).astype(int)
    np.fill_diagonal(D, 0)
    return W, D, rng.uniform(8e-3, 13e-3, size=M), dist


def wb_net(M: int, W, taues, device, **edge_kw):
    """The whole-brain network: M Jansen-Rit regions (float32, dt 1e-4) with a
    FeedbackNetwork self-edge brain -> brain of weights 40 W; ``delays=D``
    makes it a LinearMemoryMatrix (``mode`` as given, else auto), none an
    instantaneous dense edge."""
    from rectipy_tpu_torch import FeedbackNetwork

    net = FeedbackNetwork(WB_DT, device=device)
    net.add_diffeq_node("brain", JR, weights=np.zeros((M, M)), source_var="m_py",
                        target_var="r_in", input_var="r_in", output_var="m_py",
                        node_vars={"all/jr_op/tau_e": taues})
    net.add_edge("brain", "brain", weights=40.0 * W, feedback=True, **edge_kw)
    net.compile()
    return net


def timed_run(net, inputs, **kw):
    """(seconds, Observer) of one ``Network.run``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = net.run(inputs, verbose=False, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, obs


def read_ms(edge, x) -> float:
    """The delay edge's step alone (the shift, the read and the weighted
    sum), timed on the device by CUDA events, on the prepped selectors."""
    step, params = edge.make_step(), edge.prep_params(dict(edge.params))
    buf = edge.init_state()
    with torch.no_grad():
        return cuda_ms(lambda: step(buf, params, x), reps=100)


def whole_brain_phase(dev) -> None:
    """Phase 30: benchmarks/whole_brain_scale.py's M=998 network on the card."""
    M = WB_M
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    W, D, taues, _ = wb_data(M)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nets = {"factored": wb_net(M, W, taues, dev, delays=D),
            "instantaneous": wb_net(M, W, taues, dev),
            "gather": wb_net(M, W, taues, dev, delays=D, mode="gather")}
    build_s = time.perf_counter() - t0
    edge = nets["factored"].get_edge("brain", "brain")
    Q, S = edge._fQS  # 78 and 15 at M = 998 (D1 = 1,158): 998^2 (Q + S) <= 2^27
    d1 = int(D.max()) + 1
    S_rule = max(1, int(round(np.sqrt(d1 / 5.0))))
    if (edge.mode, S) != ("factored", S_rule) or Q != -(-d1 // S) \
            or M * M * (Q + S) > 2 ** 27:
        raise AssertionError(f"whole_brain_path: auto picked {edge.mode}, Q={Q}, S={S}")
    # the host-bound loops are timed per step: 2,000 steps suffice for the
    # instantaneous and gather networks beside the factored path's 10,000
    steps = {"factored": WB_T, "instantaneous": WB_T_SHORT, "gather": WB_T_SHORT}
    inputs = {k: torch.zeros((t, M), device=dev) for k, t in steps.items()}
    kw = dict(sampling_steps=100)
    warm = {k: timed_run(net, inputs[k][:200], **kw)[0] for k, net in nets.items()}
    times = {k: [] for k in nets}
    for _ in range(3):  # in turns, best of 3
        for k, net in nets.items():
            sec, obs = timed_run(net, inputs[k], **kw)
            times[k].append(sec)
            out = obs.to_numpy("out")
            if out.shape != (steps[k] // 100, M) or not np.all(np.isfinite(out)):
                raise AssertionError(f"whole_brain_path {k}: bad records {out.shape}")
    builds = edge.selector_builds
    if builds != 4:  # one per run: never per step
        raise AssertionError(f"whole_brain_path: {builds} selector builds for 4 runs")
    ms = {k: min(v) / steps[k] * 1e3 for k, v in times.items()}
    x0 = torch.zeros(M, device=dev)
    dev_ms = {k: device_step_ms(net, x0, reps=8) for k, net in nets.items()}
    reads = {k: read_ms(nets[k].get_edge("brain", "brain"), x0) for k in ("factored", "gather")}
    # bytes each read moves a step: factored, the coarse and fine one-hots,
    # the (n_in, n_out, S) intermediate written and read, the buffer and W;
    # gather, the int64 index, W and the buffer
    f32 = 4
    read_bytes = {"factored": M * M * (Q + 3 * S) * f32 + M * Q * S * f32 + M * M * f32,
                  "gather": M * M * (8 + f32) + M * (int(D.max()) + 1) * f32}
    read_line = {k: {"ms": reads[k], "bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3,
                     "share_of_bound": b / HBM_BYTES_PER_S * 1e3 / reads[k]}
                 for k, b in read_bytes.items()}
    del nets, inputs
    torch.cuda.empty_cache()

    # factored == gather bit for bit over the same 2,000 steps (fresh networks)
    cmp_kw = dict(sampling_steps=10, record_vars=[("brain", "psp_e", False)])
    short = torch.zeros((WB_T_SHORT, M), device=dev)
    recs = {}
    for mode in ("auto", "gather"):
        net = wb_net(M, W, taues, dev, delays=D, mode=mode)
        obs = net.run(short, verbose=False, **cmp_kw)
        # the history the two buffers share (factored's is Q*S wide, gather's D1)
        recs[mode] = (obs.to_numpy("out"), obs.to_numpy(("brain", "psp_e")),
                      net.get_edge("brain", "brain").buffer[:, :d1].cpu().numpy())
        del net
    identical = all(np.array_equal(a, b) for a, b in zip(recs["auto"], recs["gather"]))
    if not identical:
        raise AssertionError("whole_brain_path: the factored and gather reads differ")
    out_range = [float(recs["auto"][0].min()), float(recs["auto"][0].max())]
    del recs

    # the card against the CPU over CPU_STEPS steps
    cmp, secs = {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        net = wb_net(M, W, taues, device, delays=D)
        t0 = time.perf_counter()
        cmp[name] = net.run(np.zeros((CPU_STEPS, M), dtype=np.float32), verbose=False,
                            sampling_steps=10).to_numpy("out")
        secs[name] = time.perf_counter() - t0
        del net
    vs = vs_cpu("whole_brain_path card vs cpu", cmp["card"], cmp["cpu"])

    # run_batch of B trials (whole_brain_scale.py's WB_BATCH branch), each
    # trial held to its single-trial run over CMP_STEPS steps
    net = wb_net(M, W, taues, dev, delays=D)
    binp = torch.as_tensor(np.random.default_rng(2).normal(size=(WB_B, WB_T_SHORT, M))
                           .astype(np.float32) * 2.0, device=dev)
    short_b = net.run_batch(binp[:, :CMP_STEPS], sampling_steps=10)["out"]  # also the warm-up
    torch.cuda.synchronize()
    b_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = net.run_batch(binp, sampling_steps=100)
        torch.cuda.synchronize()
        b_times.append(time.perf_counter() - t0)
        if res["out"].shape != (WB_B, WB_T_SHORT // 100, M) or not np.all(
                np.isfinite(res["out"])):
            raise AssertionError("whole_brain_path: bad run_batch records")
    b_best = min(b_times)
    trial_cmp = []
    for b in range(WB_B):
        single = wb_net(M, W, taues, dev, delays=D)
        ref = single.run(binp[b, :CMP_STEPS], verbose=False, sampling_steps=10).to_numpy("out")
        trial_cmp.append(vs_cpu(f"whole_brain_path trial {b}", short_b[b], ref)["max_abs_diff"])
        del single
    del net, binp
    torch.cuda.empty_cache()
    emit({"phase": "whole_brain_path", "template": "jansen_rit", "regions": M,
          "dtype": "float32", "dt": WB_DT, "speed_m_per_s": WB_SPEED,
          "delay_span_steps": int(D.max()), "distinct_delays": int(np.unique(D).size),
          "auto_mode": "factored", "Q": Q, "S": S, "w_data_s": data_s, "build_s": build_s,
          "steps": steps, "warm_200_steps_s": warm, "run_s": times, "ms_per_step": ms,
          "region_updates_per_s": {k: M / (v * 1e-3) for k, v in ms.items()},
          "delay_overhead_factor": ms["factored"] / ms["instantaneous"],
          "gather_over_factored": ms["gather"] / ms["factored"],
          "device_step_ms": dev_ms,
          "device_idle_share": {k: 1.0 - dev_ms[k] / ms[k] for k in ms},
          "delay_read": read_line, "selector_builds": builds,
          "factored_equals_gather_bit_for_bit": {"steps": WB_T_SHORT, "identical": identical},
          "out_range": out_range,
          "vs_cpu": {"steps": CPU_STEPS, **vs, "card_run_s": secs["card"],
                     "cpu_run_s": secs["cpu"]},
          "run_batch": {"B": WB_B, "steps": WB_T_SHORT, "run_s": b_times, "best_s": b_best,
                        "ms_per_step": b_best / WB_T_SHORT * 1e3,
                        "aggregate_region_updates_per_s": WB_B * WB_T_SHORT * M / b_best,
                        "ratio_to_single": WB_B * ms["factored"] / (b_best / WB_T_SHORT * 1e3),
                        "trials_vs_single_max_abs_diff": max(trial_cmp),
                        "trial_steps": CMP_STEPS},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})


def stp_feedback_net(n: int, device, weights: tuple = None):
    """feedback_net's network with both edges LinearSTP: p1 -> p2 depressing
    (U 0.5, tau_depress 5.0, no facilitation), the feedback p2 -> p1
    facilitating (U 0.2, tau_facil 10.0, tau_depress 1.0); the taus are in the
    template's time unit, 500-1,000 steps at dt 1e-2."""
    from rectipy_tpu_torch import FeedbackNetwork, attach_generic_fused_step

    W1, W2, W_ff, W_fb = weights if weights is not None else feedback_weights(n)
    net = FeedbackNetwork(1e-2, device=device)
    for label, W in (("p1", W1), ("p2", W2)):
        net.add_diffeq_node(label, LIF, input_var="I_ext", output_var="s", weights=W,
                            source_var="s", target_var="s_in", op="lif_op", spike_var="spike",
                            spike_def="v", coupling_dtype="bfloat16")
    net.add_edge("p1", "p2", weights=W_ff, U=0.5, tau_depress=5.0, tau_facil=0.0)
    net.add_edge("p2", "p1", weights=W_fb, feedback=True, U=0.2, tau_facil=10.0,
                 tau_depress=1.0)
    net.compile()
    for label in ("p1", "p2"):
        attach_generic_fused_step(net.get_node(label))
    return net


def stp_feedback_phase(dev) -> list:
    """Phase 31: feedback_phase's network with short-term plasticity on both
    edges, in turns with the plain-edge network.  Returns the generic
    kernel's entry of the ``kernels`` line."""
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step

    t0 = time.perf_counter()
    weights = feedback_weights(N)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = stp_feedback_net(N, dev, weights)
    build_s = time.perf_counter() - t0
    plain = feedback_net(N, dev, weights)
    inputs = torch.full((STEPS, 1), STP_DRIVE, device=dev)
    run_kw = dict(record_output=False, record_vars=[("p1", "s", True), ("p2", "s", True)],
                  sampling_steps=100)
    stp_edges = [net.get_edge("p1", "p2"), net.get_edge("p2", "p1")]
    initial = [e.init_state() for e in stp_edges]
    timed_run(net, inputs[:200], **run_kw)  # warm-up, then back to the initial state
    net.reset()
    for e, st in zip(stp_edges, initial):
        e.set_state(st)
    # the first run from the initial state: launches, activity, STP state; it
    # is the first of the timed turns
    generic_fused_step.launches = 0
    first_s, obs = timed_run(net, inputs, **run_kw)
    launches = generic_fused_step.launches
    if launches != 2 * STEPS:
        raise AssertionError(f"stp_feedback_path: {launches} launches for {STEPS} steps")
    recs = [obs.to_numpy((p, "s")) for p in ("p1", "p2")]
    if any(r.shape != (STEPS // 100,) or not np.all(np.isfinite(r)) for r in recs):
        raise AssertionError("stp_feedback_path: bad records")
    active = [float(r.max()) for r in recs]
    dep, fac = net.get_edge("p1", "p2"), net.get_edge("p2", "p1")
    stp_state = {"p1->p2_x_min": float(dep.x.min()), "p1->p2_u_max": float(dep.u.max()),
                 "p2->p1_u_max": float(fac.u.max()), "p2->p1_x_min": float(fac.x.min())}
    if min(active) <= 1e-3 or stp_state["p1->p2_x_min"] >= 0.9 \
            or stp_state["p2->p1_u_max"] <= 0.2:
        raise AssertionError(f"stp_feedback_path: silent populations or STP state that did not "
                             f"move: max mean s {active}, {stp_state}")
    # in turns with the plain-edge network: stp (the first run), plain, plain, stp
    timed_run(plain, inputs[:200], **run_kw)  # warm-up
    times = {"stp": [first_s], "plain": []}
    for name in ("plain", "plain", "stp"):
        n_ = net if name == "stp" else plain
        n_.reset()
        sec, o = timed_run(n_, inputs, **run_kw)
        if not all(np.all(np.isfinite(o.to_numpy((p, "s")))) for p in ("p1", "p2")):
            raise AssertionError(f"stp_feedback_path {name}: non-finite records")
        times[name].append(sec)
    ms = {k: min(v) / STEPS * 1e3 for k, v in times.items()}
    x1 = torch.full((1,), STP_DRIVE, device=dev)
    # a step of either network queues about 60 kernels: 10 steps stay
    # within cuda_ms's launch queue
    dev_ms = {"stp": device_step_ms(net, x1, reps=10), "plain": device_step_ms(plain, x1, reps=10)}
    del plain
    torch.cuda.empty_cache()
    # the card against the CPU over CPU_STEPS steps, both from the initial state
    cmp_kw = dict(run_kw, sampling_steps=10, verbose=False)
    cmp, secs = {}, {}
    fresh = stp_feedback_net(N, dev, weights)
    t0 = time.perf_counter()
    cpu_net = stp_feedback_net(N, "cpu", weights)
    cpu_build_s = time.perf_counter() - t0
    del weights
    for name, n_ in (("card", fresh), ("cpu", cpu_net)):
        t0 = time.perf_counter()
        o = n_.run(np.full((CPU_STEPS, 1), STP_DRIVE, dtype=np.float32), **cmp_kw)
        secs[name] = time.perf_counter() - t0
        cmp[name] = np.stack([o.to_numpy((p, "s")) for p in ("p1", "p2")])
        cmp[name + "_stp"] = np.concatenate([n_.get_edge("p1", "p2").x.cpu().numpy(),
                                             n_.get_edge("p2", "p1").u.cpu().numpy()])
    del cpu_net, fresh
    vs = vs_cpu("stp_feedback_path card vs cpu", cmp["card"], cmp["cpu"])
    vs_stp = vs_cpu("stp_feedback_path (u, x) card vs cpu", cmp["card_stp"], cmp["cpu_stp"])
    emit({"phase": "stp_feedback_path", "template": "lif", "populations": 2,
          "coupling": "bfloat16",
          "edges": "float32 LinearSTP p1->p2 (U 0.5, tau_depress 5) and feedback p2->p1 "
                   "(U 0.2, tau_facil 10, tau_depress 1)", "n": N, "steps": STEPS,
          "drive": STP_DRIVE, "kernel_launches": launches, "w_data_s": data_s,
          "build_s": build_s, "first_run_s": first_s, "run_s": times, "ms_per_step": ms,
          "stp_over_plain": ms["stp"] / ms["plain"],
          "neuron_updates_per_s": {k: 2 * N / (v * 1e-3) for k, v in ms.items()},
          "device_step_ms": dev_ms,
          "device_idle_share": {k: 1.0 - dev_ms[k] / ms[k] for k in ms},
          "max_mean_s": active, "stp_state_after_first_run": stp_state,
          "vs_cpu": {"steps": CPU_STEPS, "records": int(cmp["cpu"].shape[1]), **vs,
                     "stp_state": vs_stp, "cpu_build_s": cpu_build_s,
                     "card_run_s": secs["card"], "cpu_run_s": secs["cpu"]}})
    entry = generic_instance("lif,bfloat16,stp_feedback_path", net.get_node("p1"),
                             torch.bfloat16, 17, launches)
    del net
    torch.cuda.empty_cache()
    return [entry]


def family_net(n: int, device, W_rec, **edge_kw):
    """inp (identity, n) -> an edge of the family -> a tanh population of n
    (float32, dt 1e-2, coupling W_rec)."""
    from rectipy_tpu_torch import Network

    net = Network(1e-2, device=device)
    net.add_func_node("inp", n, activation_function="identity")
    net.add_diffeq_node("pop", TANH, weights=W_rec, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("inp", "pop", **edge_kw)
    net.compile()
    return net


def epoch_loss_and_grads(net, inp, tgt) -> tuple:
    """fit_bptt's epoch loss (plain autograd, mse on every step) and its
    gradients with respect to the trainable leaves, by the network's own
    step and edge prep."""
    paths = net.trainable_paths()
    params = net.parameters_pytree()
    leaves = [params[k][l][p].detach().clone().requires_grad_(True) for k, l, p in paths]
    for (k, l, p), leaf in zip(paths, leaves):
        params[k][l] = {**params[k][l], p: leaf}
    step = net.make_step()
    with torch.enable_grad():
        prepped = net._prep_edge_params(params)
        state, outs = net.init_state(), []
        for x in net._to_device(inp).unbind(0):
            state, out, _ = step(state, prepped, x)
            outs.append(out)
        loss = torch.mean((torch.stack(outs) - net._to_device(tgt)) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {"/".join(p): g.cpu().numpy() for p, g in zip(paths, grads)}


def edge_family_check(dev) -> None:
    """Phase 32: every edge class and delay read on the card against the same
    network on the CPU, and a fit through trainable delays."""
    rng = np.random.default_rng(31)
    n, T = FAMILY_N, FAMILY_T
    W_rec = (rng.normal(size=(n, n)) * (0.5 / np.sqrt(n))).astype(np.float32)
    W = (rng.normal(size=(n, n)) * (1.0 / np.sqrt(n))).astype(np.float32)
    D = rng.integers(0, 40, size=(n, n))
    inp = np.abs(rng.normal(size=(T, n))).astype(np.float32)
    cases = {
        "masked": dict(mask=(rng.random((n, n)) < 0.2).astype(np.float32)),
        "delay": dict(delays=rng.integers(0, 40, size=n)),
        "filter": dict(filter_weights=np.eye(n, dtype=np.float32) * 0.5),
        "delay_filter": dict(delays=rng.integers(0, 40, size=n),
                             filter_weights=np.eye(n, dtype=np.float32) * 0.5),
        "stp": dict(tau_facil=0.5, tau_depress=0.3, U=0.3),
        "matrix_onehot": dict(delays=D, mode="onehot"),
        "matrix_factored": dict(delays=D, mode="factored"),
        "matrix_gather": dict(delays=D, mode="gather"),
        "matrix_interp_hat": dict(delays=D + 0.3, mode="interp", interp_impl="hat"),
        "matrix_interp_factored2": dict(delays=D + 0.3, mode="interp",
                                        interp_impl="factored2"),
        "matrix_factored_bf16_read": dict(delays=D, mode="factored", read_dtype="bfloat16"),
        "matrix_onehot_bf16_read": dict(delays=D, mode="onehot", read_dtype="bfloat16"),
    }
    lines = {}
    for name, kw in cases.items():
        recs, secs = {}, {}
        for where, device in (("card", dev), ("cpu", "cpu")):
            net = family_net(n, device, W_rec, weights=W, **kw)
            t0 = time.perf_counter()
            recs[where] = net.run(inp, sampling_steps=10, verbose=False).to_numpy("out")
            secs[where] = time.perf_counter() - t0
            edge = net.get_edge("inp", "pop")
            if where == "card" and getattr(edge, "selector_builds", 1) > 1:
                raise AssertionError(f"edge_family_check {name}: selectors built per step")
            del net
        lines[name] = {"class": type(edge).__name__, "mode": getattr(edge, "mode", None),
                       **vs_cpu(f"edge_family_check {name}", recs["card"], recs["cpu"]),
                       "card_run_s": secs["card"], "cpu_run_s": secs["cpu"]}
    # one fit_bptt epoch through a trainable-delay interp edge at M regions
    M, Tf = FAMILY_M, FAMILY_FIT_T
    Wm, _, taues, dist = wb_data(M)
    dmax = int(np.ceil(1.1 * dist.max() / WB_SPEED / WB_DT))
    finp = np.random.default_rng(3).normal(size=(Tf, M)).astype(np.float32) * 5.0
    # the teacher's records (delays x 1), the student's delays x 1.1; the
    # loss and gradients of fit_bptt's epoch on both devices, then the epoch
    # itself on the card, whose loss must be the same
    fit, secs = {}, {}
    for where, device in (("cpu", "cpu"), ("card", dev)):
        net = wb_net(M, Wm, taues, device, delays=dist / WB_SPEED / WB_DT, mode="interp",
                     train="gd", train_delays=True, max_delay=dmax)
        tgt = net.run(finp, verbose=False).to_numpy("out") * 1.05
        student = wb_net(M, Wm, taues, device, delays=dist / WB_SPEED / WB_DT * 1.1,
                         mode="interp", train="gd", train_delays=True, max_delay=dmax)
        t0 = time.perf_counter()
        fit[where] = epoch_loss_and_grads(student, finp, tgt)
        secs[where] = time.perf_counter() - t0
        del net
    # the card's student and teacher records are the loop's last
    t0 = time.perf_counter()
    obs = student.fit_bptt([finp], [tgt], optimizer="adam", lr=1e-2, verbose=False)
    secs["card_fit_bptt"] = time.perf_counter() - t0
    e_c, how = float(obs["epoch_loss"][0]), student.last_fit
    impl = student.get_edge("brain", "brain")._interp_impl
    del student
    (l_c, g_c), (l_p, g_p) = fit["card"], fit["cpu"]
    grad_err = {k: float(np.linalg.norm(g_c[k] - g_p[k]) / np.linalg.norm(g_p[k])) for k in g_p}
    fit_line = {"regions": M, "steps": Tf, "interp_impl": impl, "trajectory": how["trajectory"],
                "loss": {"card": l_c, "cpu": l_p, "card_fit_bptt_epoch": e_c},
                "loss_rtol": FIT_LOSS_RTOL, "grad_rel_norm_err": grad_err,
                "grad_rtol": FIT_GRAD_RTOL,
                "grad_norm": {k: float(np.linalg.norm(v)) for k, v in g_p.items()},
                "seconds": secs}
    if (abs(l_c - l_p) > FIT_LOSS_RTOL * abs(l_p) or abs(e_c - l_c) > FIT_LOSS_RTOL * abs(l_c)
            or max(grad_err.values()) > FIT_GRAD_RTOL
            or set(g_p) != {"edges/brain->brain/weights", "edges/brain->brain/delays"}):
        raise AssertionError(f"edge_family_check fit: {fit_line}")
    emit({"phase": "edge_family_check", "n": n, "steps": T, "dtype": "float32",
          "cases": lines, "fit_bptt": fit_line})


# ------------------------------------------------------------- phases 33-36
SPARSE_N, SPARSE_BS, SPARSE_FAN_IN = 1_000_448, 512, 1_000  # benchmarks/sparse_scale.py
SPARSE_DT, SPARSE_T = 1e-4, 2_000
SPARSE_B, SPARSE_T_B = 16, 500  # sparse_scale.py's SCALE_BATCH=16 branch at SCALE_T=500
SPARSE_CMP_STEPS = 100  # the B=16 trials against single-trial runs
SMALL_N = 8_192  # the card-vs-CPU and training width: 16 block rows of 512
BD_N, BD_DMAX, BD_DT, BD_T = 100_352, 64, 1e-3, 2_000  # benchmarks/block_delay_scale.py
SPARSE_TRAIN_T, SPARSE_TRAIN_LR = 200, 0.1
BLOCK_SOURCE = "rectipy_tpu_torch/csrc/block_int8.cu"
BLOCK_REPLACES = "port-only (the XLA einsum of rectipy_tpu/ops/quant.py:258)"


def tan_etas(n: int) -> np.ndarray:
    return -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))


def pulse(steps: int, t_on: int, amp: float = 3.0) -> np.ndarray:
    """rectipy_tpu.inputs.Pulse(steps, 1, t_on=t_on, amp=amp) as an array."""
    drive = np.zeros((steps, 1), dtype=np.float32)
    drive[t_on:, 0] = amp
    return drive


def sparse_net(A, etas, coupling, device):
    """benchmarks/sparse_scale.py's network: qif_sfa with the block
    coupling ``A`` at ``coupling_dtype=coupling``, dt 1e-4."""
    from rectipy_tpu_torch import Network

    net = Network(SPARSE_DT, device=device)
    net.add_diffeq_node(
        "qif", QIF_SFA, weights=A, source_var="s", target_var="s_in", input_var="I_ext",
        output_var="s", spike_var="spike", spike_def="v", op="qif_sfa_op",
        spike_threshold=1e2, spike_reset=-1e2,
        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                   "all/qif_sfa_op/k": 15.0}, coupling_dtype=coupling)
    net.compile()
    return net


def block_bound(n_bytes: float, n_ops: float, peak: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def block_int8_timing(bq, rs, xq, idx) -> dict:
    """block_int8_mv's ms on these operands, its plain version's, its bound
    (each input read once, the float32 output written once) and the
    yardstick: torch.bmm in bf16 of the same integers (exact) over the
    gathered rows, float32 out (timed only, never on a path)."""
    from rectipy_tpu_torch.ops.quant import block_int8_mv, block_int8_mv_plain

    n_br, cb, bs, _ = bq.shape
    B = xq.shape[0]
    out = block_int8_mv(bq, rs, xq, idx)
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, block_int8_mv_plain(bq, rs, xq, idx)))
    if not equal:
        raise AssertionError(f"block_int8_mv differs from its plain version at B={B}")
    ms = cuda_ms(lambda: block_int8_mv(bq, rs, xq, idx), reps=50)
    plain_ms = cuda_ms(lambda: block_int8_mv_plain(bq, rs, xq, idx), reps=2)
    a16 = bq.reshape(n_br * cb, bs, bs).to(torch.bfloat16)
    x16 = xq[:, idx.long()].to(torch.bfloat16).permute(1, 2, 3, 0).reshape(n_br * cb, bs, B)
    library_ms = cuda_ms(lambda: torch.bmm(a16, x16, out_dtype=torch.float32), reps=20)
    del a16, x16
    n_bytes = bq.numel() + rs.numel() * 4 + xq.numel() + idx.numel() * 4 + B * n_br * bs * 4
    n_ops = 2.0 * B * n_br * cb * bs * bs
    bound_ms, bound_by = block_bound(n_bytes, n_ops, INT8_OPS)
    return {"B": B, "n": n_br * bs, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes, "ops": n_ops,
            "share_of_bound": bound_ms / ms, "achieved_bytes_per_s": n_bytes / (ms * 1e-3),
            "bit_identical": equal}


def block_int8_check(dev) -> dict:
    """Phase 33: block_int8_mv bit for bit against its plain version, and its
    timing at the million-neuron shape."""
    from rectipy_tpu_torch.ops.quant import (block_int8_mv, block_int8_mv_plain,
                                             block_int8_mv_route)

    g = torch.Generator(device=dev)
    g.manual_seed(18)

    def rint(shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)

    n_br, cb, nb_in, d1 = 6, 4, 6, 5
    cases = []
    for B in (1, 3, SPARSE_B):
        for bs in (512, 32, 20):
            bq = rint((n_br, cb, bs, bs))
            rs = torch.rand((n_br, bs), device=dev, generator=g)
            cols = torch.stack([torch.randperm(nb_in, device=dev, generator=g)[:cb]
                                for _ in range(n_br)]).to(torch.int32)
            for form in ("cols", "history"):
                if form == "cols":  # a node coupling: idx = cols over (B, nb_in, bs)
                    xq, idx = rint((B, nb_in, bs)), cols
                else:  # the edge's flat (nb_in * D1)-block history index
                    slots = torch.randint(0, d1, (n_br, cb), device=dev, generator=g)
                    xq, idx = rint((B, nb_in * d1, bs)), (cols * d1 + slots).to(torch.int32)
                before = block_int8_mv.launches
                out = block_int8_mv(bq, rs, xq, idx.contiguous())
                torch.cuda.synchronize()
                ref = block_int8_mv_plain(bq, rs, xq, idx)
                if block_int8_mv.launches != before + 1 or not torch.equal(out, ref):
                    raise AssertionError(f"block_int8_mv B={B} bs={bs} {form}: differs from "
                                         f"its plain version")
                cases.append({"B": B, "bs": bs, "index": form, "bit_identical": True,
                              "route_bytes": block_int8_mv_route(bs, bq.data_ptr(),
                                                                 xq.data_ptr())})
    # why the kernel: PyTorch has no int8 batched product on the card
    try:
        ones = torch.ones((1, 2, 2), dtype=torch.int8, device=dev)
        torch.bmm(ones, ones)
        torch.cuda.synchronize()
        torch_bmm_int8 = "ran"
    except (RuntimeError, NotImplementedError) as err:
        torch_bmm_int8 = f"{type(err).__name__}: {err}"
    emit({"phase": "block_int8_check", "n_br": n_br, "cb": cb, "cases": cases,
          "torch_bmm_int8": torch_bmm_int8})
    n_br = SPARSE_N // SPARSE_BS
    cb, bs = 4, SPARSE_BS
    bq = rint((n_br, cb, bs, bs))
    rs = torch.rand((n_br, bs), device=dev, generator=g)
    idx = torch.stack([torch.randperm(n_br, device=dev, generator=g)[:cb]
                       for _ in range(n_br)]).to(torch.int32)
    timing = {B: block_int8_timing(bq, rs, rint((B, n_br, bs)), idx) for B in (1, SPARSE_B)}
    del bq, rs, idx
    torch.cuda.empty_cache()
    emit({"phase": "block_int8_timing", "n_br": n_br, "cb": cb, "bs": bs,
          "random_int8_operands": True, "by_trials": list(timing.values())})
    return timing


def sparse_scale_phase(dev, timing: dict) -> list:
    """Phase 34: benchmarks/sparse_scale.py's N = 1,000,448 network on the
    card, int8 (block_int8_mv) in turns with bf16 (gather + torch.bmm), the
    B = 16 sweep, and the card against the CPU at N = 8,192."""
    from rectipy_tpu_torch import block_random_connectivity
    from rectipy_tpu_torch.ops.quant import block_int8_mv

    N = SPARSE_N
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A = block_random_connectivity(N, N, SPARSE_FAN_IN, block_size=SPARSE_BS, seed=0)
    sample_s = time.perf_counter() - t0
    backend = block_random_connectivity.last_backend
    if backend != "native":
        raise AssertionError(f"sparse_scale_path: the sampler took {backend}, not native")
    n_br, cb = A.cols.shape
    stored = A.blocks.size  # weights streamed a step
    etas = tan_etas(N)
    nets, build_s = {}, {}
    for coupling in ("int8", "bfloat16"):
        t0 = time.perf_counter()
        nets[coupling] = sparse_net(A, etas, coupling, dev)
        torch.cuda.synchronize()
        build_s[coupling] = time.perf_counter() - t0
    del A  # the host float32 master (8.2 GB), as sparse_scale.py drops it
    drive = torch.as_tensor(pulse(SPARSE_T, SPARSE_T // 4), device=dev)
    kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=100)
    first, launches = {}, {}
    for c, net in nets.items():
        net.reset()
        before = block_int8_mv.launches
        first[c], obs = timed_run(net, drive, **kw)
        launches[c] = block_int8_mv.launches - before
        rec = obs.to_numpy(("qif", "s"))
        if rec.shape != (SPARSE_T // 100,) or not np.all(np.isfinite(rec)):
            raise AssertionError(f"sparse_scale_path {c}: bad records {rec.shape}")
    if launches != {"int8": SPARSE_T, "bfloat16": 0}:
        raise AssertionError(f"sparse_scale_path: block_int8_mv launches {launches}")
    times, recs = {c: [] for c in nets}, {}
    for _ in range(3):  # in turns, best of 3
        for c, net in nets.items():
            net.reset()
            sec, obs = timed_run(net, drive, **kw)
            times[c].append(sec)
            recs[c] = obs.to_numpy(("qif", "s"))
            if not np.all(np.isfinite(recs[c])):
                raise AssertionError(f"sparse_scale_path {c}: non-finite records")
    ms = {c: min(v) / SPARSE_T * 1e3 for c, v in times.items()}
    x0 = torch.full((1,), 3.0, device=dev)
    dev_ms = {c: device_step_ms(net, x0, reps=8) for c, net in nets.items()}
    corr = (float(np.corrcoef(recs["int8"], recs["bfloat16"])[0, 1])
            if recs["int8"].std() > 0 and recs["bfloat16"].std() > 0 else None)

    # the B = 16 eta sweep in turns with the single trial, T = 500
    net = nets["int8"]
    sweep = np.linspace(-1.0, 1.0, SPARSE_B)[:, None] + etas[None, :]
    bvars = {("qif", "eta"): sweep}
    drive_b = drive[:SPARSE_T_B]
    net.reset()
    before = block_int8_mv.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.run_batch(drive_b, batch_vars=bvars, **kw)
    torch.cuda.synchronize()
    first_b = time.perf_counter() - t0
    launches_b = block_int8_mv.launches - before
    if launches_b != SPARSE_T_B:
        raise AssertionError(f"sparse_scale_path: {launches_b} launches for {SPARSE_T_B} "
                             f"batched steps")
    b_times, s_times = [], []
    for _ in range(3):
        net.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = net.run_batch(drive_b, batch_vars=bvars, **kw)
        torch.cuda.synchronize()
        b_times.append(time.perf_counter() - t0)
        if res[("qif", "s")].shape != (SPARSE_B, SPARSE_T_B // 100) or not np.all(
                np.isfinite(res[("qif", "s")])):
            raise AssertionError("sparse_scale_path: bad run_batch records")
        net.reset()
        s_times.append(timed_run(net, drive_b, **kw)[0])
    b_best, s_best = min(b_times), min(s_times)
    # trials 0 and B-1 against single-trial runs with their eta (the int8
    # sums are exact on both sides; the records are population means)
    cmp_in = drive[SPARSE_T // 4:SPARSE_T // 4 + SPARSE_CMP_STEPS]
    cmp_kw = dict(record_output=False, record_vars=[("qif", "v", True)], sampling_steps=10)
    net.reset()
    res = net.run_batch(cmp_in, batch_vars=bvars, **cmp_kw)[("qif", "v")]
    node, trial_diff = net.get_node("qif"), {}
    for b in (0, SPARSE_B - 1):
        net.reset()
        node.set_param("eta", sweep[b])
        single = net.run(cmp_in, verbose=False, **cmp_kw).to_numpy(("qif", "v"))
        np.testing.assert_allclose(res[b], single, rtol=1e-5, atol=1e-5 * np.abs(single).max())
        trial_diff[b] = float(np.abs(res[b] - single).max())
    node.set_param("eta", etas)
    peak = torch.cuda.max_memory_allocated()
    del nets, net, node, drive, drive_b, res
    torch.cuda.empty_cache()

    # the card against the CPU at N = 8,192 over CPU_STEPS steps
    A8 = block_random_connectivity(SMALL_N, SMALL_N, SPARSE_FAN_IN, block_size=SPARSE_BS, seed=0)
    d8 = pulse(CPU_STEPS, CPU_STEPS // 4)
    vs, v_kw = {}, dict(record_output=False, record_vars=[("qif", "v", True)], sampling_steps=10)
    for c in ("int8", "bfloat16"):
        out = {device: sparse_net(A8, tan_etas(SMALL_N), c, device).run(
            d8, verbose=False, **v_kw).to_numpy(("qif", "v")) for device in ("cpu", dev)}
        vs[c] = vs_cpu(f"sparse_scale_path {c} card vs cpu", out[dev], out["cpu"])
    step_bytes = {"int8": stored, "bfloat16": 2 * stored}
    kernel_ms = timing[1]["ms"]
    emit({"phase": "sparse_scale_path", "template": "qif_sfa", "n": N, "block_rows": n_br,
          "source_blocks": cb, "block_size": SPARSE_BS, "fan_in": SPARSE_FAN_IN, "dt": SPARSE_DT,
          "sampler": backend, "sample_s": sample_s, "build_s": build_s, "steps": SPARSE_T,
          "first_run_s": first, "run_s": times, "ms_per_step": ms,
          "neuron_updates_per_s": {c: N / (v * 1e-3) for c, v in ms.items()},
          "device_step_ms": dev_ms,
          "device_idle_share": {c: 1.0 - dev_ms[c] / ms[c] for c in ms},
          "block_int8_mv_launches": launches["int8"], "block_int8_mv_ms": kernel_ms,
          "kernel_share_of_step": kernel_ms / ms["int8"],
          "block_stream_bytes_per_step": step_bytes,
          "block_stream_bytes_per_s": {c: step_bytes[c] / (ms[c] * 1e-3) for c in ms},
          "corr_int8_bf16": corr,
          "run_batch": {"B": SPARSE_B, "steps": SPARSE_T_B, "first_run_s": first_b,
                        "run_s": b_times, "single_run_s": s_times,
                        "ms_per_step": b_best / SPARSE_T_B * 1e3,
                        "single_ms_per_step": s_best / SPARSE_T_B * 1e3,
                        "aggregate_neuron_updates_per_s": SPARSE_B * SPARSE_T_B * N / b_best,
                        "ratio_to_single": SPARSE_B * s_best / b_best,
                        "block_int8_mv_launches": launches_b,
                        "trials_vs_single_max_abs_diff": trial_diff,
                        "trial_steps": SPARSE_CMP_STEPS},
          "vs_cpu": {"n": SMALL_N, "steps": CPU_STEPS, **vs},
          "max_memory_allocated_bytes": peak})
    out = []
    for B, n_launch, name in ((1, launches["int8"], "block_int8_mv"),
                              (SPARSE_B, launches_b, f"block_int8_mv[B={SPARSE_B}]")):
        t = timing[B]
        out.append({"name": name, "route": "cuda", "source": BLOCK_SOURCE,
                    "replaces": BLOCK_REPLACES, "launches": n_launch, "max_abs_err": 0.0,
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return out


def bd_data(N: int):
    """benchmarks/block_delay_scale.py's network data: the block coupling
    (fan-in 1,000, seed 0), ring delays scaled to [0, BD_DMAX] and the
    etas 1000 + 200 N(0, 1) from default_rng(1)."""
    from rectipy_tpu_torch import block_random_connectivity

    A = block_random_connectivity(N, N, 1_000, block_size=SPARSE_BS, seed=0)
    nb = N // SPARSE_BS
    ring = np.abs(A.cols - np.arange(nb)[:, None])
    ring = np.minimum(ring, nb - ring).astype(float)
    d_blk = np.rint(ring / max(ring.max(), 1.0) * BD_DMAX).astype(int)
    etas = 1000.0 + 200.0 * np.random.default_rng(1).standard_normal(N)
    return A, d_blk, etas


def bd_net(N: int, A, d_blk, etas, device, **edge_kw):
    """All recurrent coupling on a FeedbackNetwork self-edge: a
    BlockSparseLinear with per-block delays d_blk (None: no delays)."""
    from rectipy_tpu_torch import FeedbackNetwork

    net = FeedbackNetwork(BD_DT, device=device)
    net.add_diffeq_node(
        "qif", QIF_SFA, n=N, input_var="I_ext", output_var="s", spike_var="spike",
        spike_def="v", op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                   "all/qif_sfa_op/k": 15.0})
    net.add_edge("qif", "qif", weights=A, delays=d_blk, feedback=True, **edge_kw)
    net.compile()
    return net


BD_VARIANTS = {"zero_delay": (False, {}), "delay_f32": (True, {}),
               "delay_bf16": (True, {"block_dtype": "bfloat16"}),
               "delay_int8": (True, {"block_dtype": "int8_master"})}


def block_delay_phase(dev) -> list:
    """Phase 35: benchmarks/block_delay_scale.py's N = 100,352 network, four
    variants in turns, the edge's read + contraction against its bound,
    chunked runs, and the card against the CPU at N = 8,192."""
    from rectipy_tpu_torch import block_random_connectivity
    from rectipy_tpu_torch.ops.quant import block_int8_mv

    N = BD_N
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A, d_blk, etas = bd_data(N)
    sample_s = time.perf_counter() - t0
    if block_random_connectivity.last_backend != "native":
        raise AssertionError("block_delay_path: the sampler did not take the native backend")
    nets, build_s = {}, {}
    for k, (delayed, ekw) in BD_VARIANTS.items():
        t0 = time.perf_counter()
        nets[k] = bd_net(N, A, d_blk if delayed else None, etas, dev, **ekw)
        torch.cuda.synchronize()
        build_s[k] = time.perf_counter() - t0
    n_br, cb = A.cols.shape
    drive = torch.as_tensor(pulse(BD_T, BD_T // 8), device=dev)
    kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=100)
    first, launches, first_recs = {}, {}, {}
    for k, net in nets.items():
        before = block_int8_mv.launches
        first[k], obs = timed_run(net, drive, **kw)
        launches[k] = block_int8_mv.launches - before
        first_recs[k] = obs.to_numpy(("qif", "s"))
        if first_recs[k].shape != (BD_T // 100,) or not np.all(np.isfinite(first_recs[k])):
            raise AssertionError(f"block_delay_path {k}: bad records")
    want = {k: BD_T if k == "delay_int8" else 0 for k in nets}
    if launches != want:
        raise AssertionError(f"block_delay_path: block_int8_mv launches {launches}")
    delay_effect = float(np.abs(first_recs["delay_f32"] - first_recs["zero_delay"]).max())
    if delay_effect == 0.0:
        raise AssertionError("block_delay_path: the delayed run equals the zero-delay run")
    times = {k: [] for k in nets}
    for _ in range(3):  # in turns, best of 3
        for k, net in nets.items():
            net.reset()
            sec, obs = timed_run(net, drive, **kw)
            times[k].append(sec)
            if not np.all(np.isfinite(obs.to_numpy(("qif", "s")))):
                raise AssertionError(f"block_delay_path {k}: non-finite records")
    ms = {k: min(v) / BD_T * 1e3 for k, v in times.items()}
    x0 = torch.full((1,), 3.0, device=dev)
    dev_ms = {k: device_step_ms(net, x0, reps=8) for k, net in nets.items()}
    # the edge's step alone: the history write and read and the contraction
    reads = {}
    x = torch.rand(N, device=dev)
    for k, net in nets.items():
        edge = net.get_edge("qif", "qif")
        step, params = edge.make_step(), edge.prep_params(dict(edge.params))
        state = edge.init_state()
        with torch.no_grad():
            r_ms = cuda_ms(lambda: step(state, params, x), reps=20)
        w = 1 if k == "delay_int8" else 2 if k == "delay_bf16" else 4
        # the blocks, the cb * N gathered source values, x in and y out
        n_bytes = N * cb * SPARSE_BS * w + cb * N * 4 + 2 * N * 4
        reads[k] = {"ms": r_ms, "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                    "share_of_bound": n_bytes / HBM_BYTES_PER_S * 1e3 / r_ms}
    # the kernel alone at the edge's shape: the quantized blocks over a
    # gathered (1, n_br * cb, bs) stack
    edge = nets["delay_int8"].get_edge("qif", "qif")
    bq, scale = edge.prep_params(dict(edge.params))["weights"]
    g = torch.Generator(device=dev)
    g.manual_seed(35)
    xq = torch.randint(-127, 128, (1, n_br * cb, SPARSE_BS), dtype=torch.int8, device=dev,
                       generator=g)
    idx = torch.arange(n_br * cb, dtype=torch.int32, device=dev).reshape(n_br, cb)
    k_t = block_int8_timing(bq, scale, xq, idx)
    del bq, scale, xq, edge
    peak = torch.cuda.max_memory_allocated()
    del nets
    torch.cuda.empty_cache()

    # two chunked runs of BD_T/2 steps equal one of BD_T, bit for bit
    chunked = {}
    for k in ("delay_f32", "delay_int8"):
        ekw = BD_VARIANTS[k][1]
        full = bd_net(N, A, d_blk, etas, dev, **ekw).run(drive, verbose=False, **kw)
        parts = bd_net(N, A, d_blk, etas, dev, **ekw)
        a = parts.run(drive[:BD_T // 2], verbose=False, **kw).to_numpy(("qif", "s"))
        b = parts.run(drive[BD_T // 2:], verbose=False, **kw).to_numpy(("qif", "s"))
        same = bool(np.array_equal(np.concatenate([a, b]), full.to_numpy(("qif", "s"))))
        hist = parts.get_edge("qif", "qif").init_state()
        if not same or int(hist[1]) != BD_T:
            raise AssertionError(f"block_delay_path {k}: chunked runs differ from one run")
        chunked[k] = same
        del full, parts
        torch.cuda.empty_cache()
    del A

    # the card against the CPU at N = 8,192 over CPU_STEPS steps
    A8, d8, e8 = bd_data(SMALL_N)
    drive8 = pulse(CPU_STEPS, CPU_STEPS // 8)
    v_kw = dict(record_output=False, record_vars=[("qif", "v", True)], sampling_steps=10)
    vs = {}
    for k in ("delay_f32", "delay_int8"):
        out = {device: bd_net(SMALL_N, A8, d8, e8, device, **BD_VARIANTS[k][1]).run(
            drive8, verbose=False, **v_kw).to_numpy(("qif", "v")) for device in ("cpu", dev)}
        vs[k] = vs_cpu(f"block_delay_path {k} card vs cpu", out[dev], out["cpu"])
    emit({"phase": "block_delay_path", "template": "qif_sfa", "n": N, "patches": n_br,
          "source_blocks": cb, "block_size": SPARSE_BS, "fan_in": 1_000, "dt": BD_DT,
          "d_max": BD_DMAX, "history_slots": BD_DMAX + 1, "sample_s": sample_s,
          "build_s": build_s, "steps": BD_T, "first_run_s": first, "run_s": times,
          "ms_per_step": ms, "neuron_updates_per_s": {k: N / (v * 1e-3) for k, v in ms.items()},
          "device_step_ms": dev_ms,
          "device_idle_share": {k: 1.0 - dev_ms[k] / ms[k] for k in ms},
          "edge_step": reads, "block_int8_mv_launches": launches["delay_int8"],
          "block_int8_mv_at_edge_shape": k_t, "delayed_vs_zero_delay_max_abs_diff": delay_effect,
          "chunked_equals_one_run_bit_for_bit": chunked,
          "vs_cpu": {"n": SMALL_N, "steps": CPU_STEPS, **vs},
          "max_memory_allocated_bytes": peak})
    return [{"name": "block_int8_mv[block_delay_path]", "route": "cuda",
             "source": BLOCK_SOURCE, "replaces": BLOCK_REPLACES,
             "launches": launches["delay_int8"], "max_abs_err": 0.0, "ms": k_t["ms"],
             "plain_ms": k_t["plain_ms"], "bound_ms": k_t["bound_ms"],
             "bound_by": k_t["bound_by"], "library_ms": k_t["library_ms"]}]


def rel_norm(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def sparse_train_check(dev) -> None:
    """Phase 36: fit_bptt through a block-coupled node (float32 and
    int8_master, the chain trajectory) and one epoch through a delayed f32
    BlockSparseLinear edge, on the card against the CPU; a frozen
    int8_master edge's source gradient, nonzero, against the CPU's."""
    from rectipy_tpu_torch import BlockSparseLinear, Network, block_random_connectivity

    N, T = SMALL_N, SPARSE_TRAIN_T
    A = block_random_connectivity(N, N, SPARSE_FAN_IN, block_size=SPARSE_BS, seed=0)
    rng = np.random.default_rng(18)
    etas = 20.0 + rng.random(N)  # every neuron spikes within the window
    inp = (rng.normal(size=(T, N)) * 2.0 + 5.0).astype(np.float32)
    tgt = (rng.normal(size=(T, N)) * 0.1).astype(np.float32)
    node_fits = {}
    for coupling in ("float32", "int8_master"):
        res = {}
        for device in (dev, "cpu"):
            net = Network(1e-2, device=device)
            net.add_diffeq_node("qif", QIF, weights=A, input_var="I_ext", output_var="s",
                                source_var="s", target_var="s_in", op="qif_op",
                                spike_var="spike", spike_def="v", spike_threshold=100.0,
                                spike_reset=-100.0, node_vars={"all/qif_op/eta": etas},
                                coupling_dtype=None if coupling == "float32" else coupling,
                                train_params=["weights"])
            net.compile()
            w0 = net.get_node("qif")["weights"].detach().cpu().numpy()
            t0 = time.perf_counter()
            obs = net.fit_bptt([inp] * 2, [tgt] * 2, optimizer="sgd", lr=SPARSE_TRAIN_LR,
                               verbose=False)
            seconds = time.perf_counter() - t0
            if net.last_fit["trajectory"] != "chain":
                raise AssertionError(f"sparse_train_check {coupling}: took {net.last_fit}")
            dw = net.get_node("qif")["weights"].detach().cpu().numpy() - w0
            res[str(device)] = (np.asarray(obs["epoch_loss"], dtype=np.float64), dw, seconds)
            del net
        (lc, dc, sc), (lp, dp, sp) = res[str(dev)], res["cpu"]
        loss_rtol = float(np.abs(lc - lp).max() / np.abs(lp).max())
        grad_rel = rel_norm(dc, dp)
        if not (np.all(np.isfinite(lc)) and loss_rtol <= FIT_LOSS_RTOL
                and grad_rel <= FIT_GRAD_RTOL and np.abs(dp).max() > 0):
            raise AssertionError(f"sparse_train_check {coupling}: losses {lc} vs {lp}, "
                                 f"gradient relative norm {grad_rel}")
        node_fits[coupling] = {"losses": lc.tolist(), "cpu_losses": lp.tolist(),
                               "loss_rtol": loss_rtol, "weights_grad_rel_norm": grad_rel,
                               "card_fit_s": sc, "cpu_fit_s": sp, "trajectory": "chain"}

    # one epoch through a delayed f32 BlockSparseLinear feedback edge
    A8, d8, e8 = bd_data(N)
    drive = pulse(T, T // 8)
    edge_fit = {}
    for device in (dev, "cpu"):
        net = bd_net(N, A8, d8, e8, device, train="gd")
        teacher = bd_net(N, A8, d8, e8, device).run(drive, verbose=False).to_numpy("out")
        edge = net.get_edge("qif", "qif")
        edge.weights = edge.weights * 1.05
        loss, grads = epoch_loss_and_grads(net, drive, teacher)
        obs = net.fit_bptt([drive], [teacher], optimizer="sgd", lr=1e-3, verbose=False)
        edge_fit[str(device)] = (loss, grads, float(obs["epoch_loss"][0]))
        del net
    (lc, gc, fc), (lp, gp, fp) = edge_fit[str(dev)], edge_fit["cpu"]
    g_rel = {k: rel_norm(gc[k], gp[k]) for k in gp}
    if not (abs(lc - lp) <= FIT_LOSS_RTOL * abs(lp) and abs(fc - lc) <= FIT_LOSS_RTOL * abs(lc)
            and all(v <= FIT_GRAD_RTOL for v in g_rel.values())):
        raise AssertionError(f"sparse_train_check edge: loss {lc} vs {lp} (fit {fc}), "
                             f"gradients {g_rel}")

    # a frozen int8_master edge passes source gradients (the STE's)
    src_grad = {}
    g = np.random.default_rng(36)
    xs = g.normal(size=(20, N)).astype(np.float32)
    gs = g.normal(size=(20, N)).astype(np.float32)
    for device in (dev, "cpu"):
        e = BlockSparseLinear(N, N, weights=A8, delays=d8, block_dtype="int8_master",
                              device=device)
        params, step = e.prep_params(dict(e.params)), e.make_step()
        x = torch.as_tensor(xs, device=device).requires_grad_(True)
        state, total = e.init_state(), 0.0
        for t in range(xs.shape[0]):
            state, y = step(state, params, x[t])
            total = total + (y * torch.as_tensor(gs[t], device=device)).sum()
        (gx,) = torch.autograd.grad(total, x)
        src_grad[str(device)] = gx.cpu().numpy()
    s_rel = rel_norm(src_grad[str(dev)], src_grad["cpu"])
    s_max = float(np.abs(src_grad[str(dev)]).max())
    if not (s_max > 0 and s_rel <= FIT_GRAD_RTOL):
        raise AssertionError(f"sparse_train_check: frozen int8_master source gradient max "
                             f"{s_max}, card vs cpu {s_rel}")
    emit({"phase": "sparse_train_check", "n": N, "steps": T, "epochs": 2,
          "optimizer": "sgd", "node_fits": node_fits,
          "delayed_edge_epoch": {"loss": lc, "cpu_loss": lp, "fit_loss": fc,
                                 "grad_rel_norm": g_rel},
          "frozen_int8_master_edge_source_grad": {"max_abs": s_max, "card_vs_cpu_rel_norm": s_rel,
                                                  "steps": xs.shape[0]},
          "loss_rtol": FIT_LOSS_RTOL, "grad_rtol": FIT_GRAD_RTOL})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rectipy_tpu_torch import Network, attach_fused_qif_step, random_connectivity
    from rectipy_tpu_torch.ops._build import build, build_generated
    from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    gen_sources = generic_sources()  # the generic kernel's generated sources
    jobs = [(f"rectipy_tpu_torch/csrc/{name}.cu", build, (name,)) for name in SOURCES] + [
        (f"rectipy_tpu_torch/_build/gen/ ({GENERIC_SOURCE} + a generated tail)",
         build_generated, ("generic_fused_step", src)) for src in gen_sources]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per source, together
        builds = list(pool.map(lambda job: job[1](*job[2]), jobs))
    for (source, _, _), built in zip(jobs, builds):
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit({"phase": "build", "source": source,
              "seconds": time.perf_counter() - t0, "nvcc_seconds": built.seconds,
              "library": os.path.basename(built.path), "ptxas": ptxas})

    quant_scales_phase(dev)

    # ------------------------------------------------------ 3. kernel check
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    W_np = random_connectivity(N, N, 0.1, normalize=True, rng=rng)  # bench.py's coupling
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, N + 1) - N - 1) / (N + 1))
    w_build_s = time.perf_counter() - t0
    params = dict(dt=DT, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05,
                  thresh=100.0, v_reset=-100.0)

    def on_card(arrays):
        return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]

    cases = {  # inputs (v, s, x, eta, inp) and parameters; see TOL
        "reset": (on_card([rng.normal(size=N) * 80.0, rng.random(N), rng.random(N), etas,
                           rng.normal(size=N)]), params),
        "coupling": (on_card([rng.normal(size=N) * 1e-3, rng.random(N),
                              rng.random(N) * 1e-3, rng.normal(size=N) * 1e-3,
                              rng.normal(size=N) * 1e-3]), dict(params, k=1.0 / DT)),
    }
    v, s, x, eta, inp = cases["reset"][0]  # also the timing phase's inputs
    W32 = torch.as_tensor(W_np, dtype=torch.float32).to(dev)
    Ws = {"float32": W32, "bfloat16": W32.to(torch.bfloat16)}
    max_err = {}
    for name, W in Ws.items():
        for case, (vecs, p) in cases.items():
            out = qif_sfa_step(*vecs[:3], W, *vecs[3:], **p)
            torch.cuda.synchronize()
            ref = qif_sfa_reference_step(*vecs[:3], W, *vecs[3:], **p)
            rtol, atol = TOL[case]
            for got, r in zip(out, ref):
                torch.testing.assert_close(got, r, rtol=rtol, atol=atol)
            err = max(float((g - r).abs().max()) for g, r in zip(out, ref))
            max_err[name] = max(err, max_err.get(name, 0.0))
            mask, ref_mask = out[0] == p["v_reset"], ref[0] == p["v_reset"]
            if not torch.equal(mask, ref_mask):
                raise AssertionError(f"{name}, {case}: the reset masks differ")
            line = {"phase": "kernel_check", "w_dtype": name, "case": case, "n": N,
                    "max_abs_err": err, "rtol": rtol, "atol": atol,
                    "reset_neurons": int(mask.sum()), "coupling_build_s": w_build_s}
            if case == "reset" and not bool(mask.any()):
                raise AssertionError(f"{name}: no neuron was reset")
            if case == "coupling":
                # the check's power: the same step with every eighth term of
                # each row sum lost (as a dropped partial sum of one of the
                # kernel's eight warps would lose it) must fail on every row
                s_cut = vecs[1].clone()
                s_cut[::8] = 0.0
                cut = qif_sfa_reference_step(vecs[0], s_cut, vecs[2], W, *vecs[3:], **p)[0]
                margin = float(((cut - ref[0]).abs() / (atol + rtol * ref[0].abs())).min())
                if bool(mask.any()) or margin <= 1.0:
                    raise AssertionError(f"{name}: the coupling case reset neurons or "
                                         f"would pass a lost eighth of the row sums "
                                         f"(margin {margin})")
                line.update(v_out_range=[float(ref[0].min()), float(ref[0].max())],
                            lost_eighth_min_margin=margin)
            emit(line)

    # ---------------------------------------------------------- 4. main path
    def build_net(coupling: str, fused: bool, device=None):
        net = Network(DT, device=device)  # default: the current CUDA device
        net.add_diffeq_node(
            "qif", QIF_SFA, weights=W_np, source_var="s", target_var="s_in",
            input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
            op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
            node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                       "all/qif_sfa_op/k": 15.0},
            coupling_dtype=coupling)
        net.add_func_node("inp", 1, activation_function="tanh")
        net.add_edge("inp", "qif", rng=np.random.default_rng(1))
        net.compile()
        if fused:
            attach_fused_qif_step(net.get_node("qif"))
        return net

    run_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=100,
                  verbose=False)
    inputs = bench_inputs(STEPS)
    nets, launches, step_ms = {}, {}, {}
    for coupling in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        net = build_net(coupling, fused=True)
        build_s = time.perf_counter() - t0
        qif_sfa_step.launches = 0
        t0 = time.perf_counter()
        obs = net.run(inputs, **run_kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[coupling] = qif_sfa_step.launches
        if launches[coupling] != STEPS:
            raise AssertionError(f"{coupling}: {launches[coupling]} kernel launches for "
                                 f"{STEPS} steps")
        rec = obs.to_numpy(("qif", "s"))
        if rec.shape != (STEPS // 100,) or not np.all(np.isfinite(rec)):
            raise AssertionError(f"{coupling}: bad records, shape {rec.shape}")
        times = []
        for _ in range(3):
            net.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs = net.run(inputs, **run_kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rec = obs.to_numpy(("qif", "s"))
        if not np.all(np.isfinite(rec)):
            raise AssertionError(f"{coupling}: non-finite records in a timed run")
        best = min(times)
        step_ms[coupling] = best / STEPS * 1e3
        nets[coupling] = net
        emit({"phase": "main_path", "coupling": coupling, "n": N, "steps": STEPS,
              "kernel_launches": launches[coupling], "build_s": build_s,
              "first_run_s": first_s, "run_s": times, "best_s": best,
              "ms_per_step": step_ms[coupling], "neuron_updates_per_s": STEPS * N / best,
              "mean_s_range": [float(rec.min()), float(rec.max())],
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    # ----------------------------------------------------- 5. fused vs plain
    plain = build_net("bfloat16", fused=False)
    fused = nets["bfloat16"]
    cmp_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=10,
                  verbose=False)
    short = bench_inputs(PLAIN_STEPS)
    recs = {}
    for name, net in (("plain", plain), ("fused", fused)):
        net.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs[name] = net.run(short, **cmp_kw).to_numpy(("qif", "s"))
        recs[name + "_s"] = time.perf_counter() - t0
    ref, got = recs["plain"], recs["fused"]
    max_diff = float(np.abs(got - ref).max())
    corr = float(np.corrcoef(got, ref)[0, 1]) if ref.std() > 0 else float("nan")
    if not (corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(ref).max())):
        raise AssertionError(f"fused vs plain: corr {corr}, max|diff| {max_diff}")
    emit({"phase": "fused_vs_plain", "coupling": "bfloat16", "steps": PLAIN_STEPS,
          "records": int(ref.shape[0]), "corr": corr, "max_abs_diff": max_diff,
          "max_abs_ref": float(np.abs(ref).max()), "plain_run_s": recs["plain_s"],
          "fused_run_s": recs["fused_s"]})
    del plain

    # ------------------------------------------------------------- 6. timing
    kernels = []
    for name, W in Ws.items():
        itemsize = W.element_size()
        n_bytes = N * N * itemsize + 5 * 4 * N + 3 * 4 * N  # W, 5 vectors in, 3 out
        n_ops = 2 * N * N + 20 * N  # the matvec's FMAs plus the epilogue
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_flops(W.dtype)
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ms = cuda_ms(lambda: qif_sfa_step(v, s, x, W, eta, inp, **params), reps=200)
        plain_ms = cuda_ms(lambda: qif_sfa_reference_step(v, s, x, W, eta, inp, **params),
                           reps=20)
        s_w = s.to(W.dtype)
        library_ms = cuda_ms(lambda: torch.mv(W, s_w), reps=200)
        # the main path's whole network step on the device alone (no host
        # gaps): the kernel plus the step's other small kernels
        step = nets[name].make_step()
        state, net_params = nets[name].init_state(), nets[name].parameters_pytree()
        x_t = torch.full((1,), 3.0, device=dev)
        with torch.no_grad():
            device_step_ms = cuda_ms(lambda: step(state, net_params, x_t), reps=200)
        entry = {"name": f"qif_sfa_step[{name}]", "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": TPU_KERNEL, "launches": launches[name],
                 "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        kernels.append(entry)
        emit({"phase": "timing", **entry, "bytes": n_bytes, "ops": n_ops,
              "kernel_share_of_step": ms / step_ms[name], "step_ms": step_ms[name],
              "device_step_ms": device_step_ms,
              "device_idle_share": 1.0 - device_step_ms / step_ms[name],
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})

    del Ws, W32, W, s_w, step, state, net_params, cases, v, s, x, eta, inp
    kernels += generic_phases(W_np, build_net, nets["bfloat16"])
    del nets, fused
    torch.cuda.empty_cache()
    entry, timing10 = int4_phases(W_np, build_net)
    kernels.append(entry)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = bench_training_data(N)
    data_s = time.perf_counter() - t0
    entries, train_nu = train_phases(dev, data + (data_s,))
    kernels += entries
    entries, int4_nu = int4_train_phases(dev, data + (data_s,), timing10)
    kernels += entries
    by_name = {e["name"]: e for e in kernels}
    kernels += readout_phases(build_net, by_name["qif_sfa_step[bfloat16]"])
    kernels += tbptt_phase(dev, data + (data_s,), by_name)
    kernels += feedback_phase()
    kernels += batch_phases(dev, W_np, data, train_nu, int4_nu)
    del W_np
    torch.cuda.empty_cache()
    whole_brain_phase(dev)
    kernels += stp_feedback_phase(dev)
    edge_family_check(dev)
    torch.cuda.empty_cache()
    timing = block_int8_check(dev)
    kernels += sparse_scale_phase(dev, timing)
    kernels += block_delay_phase(dev)
    sparse_train_check(dev)

    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
