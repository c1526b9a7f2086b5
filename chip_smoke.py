#!/usr/bin/env python3
"""Smoke run of rectipy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), PyTorch and CUDA.
2. build: compiles the CUDA sources of rectipy_tpu_torch/csrc/ and the
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
   through the public API, the kernel attached, and Network.run over 5,000
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
   10,000, T = 500, dt = 5e-3, int8_master coupling, adam lr 1e-4; 4
   epochs where bench.py fits 16) through Network.fit_bptt with
   RECTIPY_FUSED_ADAM=on: a 2-epoch warm fit and one timed fit; the launch
   counts must be 4 adam_requant and 2,000 of each int8 matvec per fit, the
   losses finite.
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
   with attach_generic_fused_step and Network.run over 5,000 steps; one
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
   5,000 steps through Network.run, in turns (int4, int8, int8, int4),
   best of 2 each; one int4_mv (or int8_mv) launch per step, finite records, the correlation of the int4 and int8
   records, each path's device-only step and idle share; then the same int4
   network on the CPU over 100 steps, held to the card's run under
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
   5,000 steps of bench_inputs with the target sin(2 pi 2 t),
   update_steps=10, sampling_steps=100, then Network.test on the same
   inputs from the same initial state; 5,000 kernel launches per fit,
   finite losses and weights, P symmetric; ms/step, the RLS update alone
   (cuda_ms) against its bound (P read twice and written once).
21. rls_vs_cpu: the same FORCE fit (a fresh RLS edge, from the reservoir's
   state after phase 20) on the card and on the CPU for 100 steps with
   update_steps=10: readout records and W under fused_vs_plain's rule.
22. ridge_path: fit_ridge on the same reservoir over 5,000 steps with
   sampling_steps=10 (X is 500 x 10,000, float32 Gram matrix and solve
   on the card), alpha = 1e-3 x the largest eigenvalue of X X^T from a
   first run of the same inputs; the predictions held to numpy's float64
   solve of the same X on the host (its dual form, (X X^T + alpha I) c = y,
   y = X X^T c) within cond x eps32 x sqrt(rows), cond from float64
   eigenvalues; then test() with the ridge readout.
23. tbptt_path: phase 8's network (int8_master) trained by fit_bptt in step
   mode on the bench data tiled to T = 1,000 with update_steps=100 (10
   chunks), adam lr 1e-4: one warm and one timed fit; 1,000 launches each of
   int8_mv and int8_mv_t per fit and none of adam_requant (step mode takes
   the split optimizer); 10 finite chunk losses; ms per chunk.
24. feedback_path: examples/feedback_populations.py as a FeedbackNetwork at
   N = 10,000 per population (two LIF populations with the generic kernel
   and a bf16 coupling, dense float32 feedforward p1 -> p2 and feedback
   p2 -> p1; the example's weights, sized for N = 100, scaled by 100/N),
   5,000 steps, best of 2; two kernel launches per step; the device-only
   step and idle share; steps 100-160 on the CPU, from the card's whole
   state after step 100, held to the card's under fused_vs_plain's rule,
   both populations spiking in them (the CPU's window runs and is held in
   phase 31, after its timed runs: feedback_path_vs_cpu).
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
   over 32 trials on a shared (2,500, 1) drive, record_vars the population
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
   a 2-epoch warm fit and a timed 4-epoch fit; 2,000 launches each of
   int8_mm and int8_mm_t per fit, all 2,000 of each on the tensor cores
   (int8_mm.mma_launches, int8_mm_t.mma_launches), and none of int8_mv(_t)
   or adam_requant;
   finite losses; ms/epoch and aggregate trained neuron-updates/s against
   phase 8's single-trial figure.  Then batch_train_vs_cpu: the same fit at
   N = 2,000, B = 4, T = 50, 2 epochs, on the card and on the CPU (losses
   rtol 1e-4; at most 1% of the weights' updates differ by more than 1% of
   lr; see BATCH_LOSS_RTOL).  Then the same ensemble with an
   int4_master coupling on the same trial arrays: a 1-epoch warm fit and a
   timed 2-epoch fit, 1,000 launches each of int4_mm and int4_mm_t (all
   1,000 of each on the tensor cores, int4_mm.mma_launches and
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
   pick the factored read (S = 15, Q = 78).  Network.run of 2,000 steps
   (sampling_steps 100), best of 2, in turns with the same network with an
   instantaneous dense f32 edge and with mode="gather", each at 1,000
   steps: ms per step, region-updates/s, the delay overhead factor, each
   network's device-only step and idle share, and the delay read alone
   (the edge step on CUDA events) against its byte bound (factored: the
   coarse and fine one-hots, the (n_in, n_out, S) intermediate written and
   read, W and the buffer, about 0.50 GB; gather: the int64 index, W and
   the buffer); one selector build per run.  The factored and gather reads give
   bit-identical records over 2,000 steps (fresh networks, no TF32); the
   card against the CPU over 100 steps under fused_vs_plain's rule;
   run_batch of 8 trials of 1,000 steps (normal inputs x 2 from
   default_rng(2)), best of 2, each trial held to its single-trial run
   over 200 steps under the same rule; peak device memory.
31. stp_feedback_path: phase 24's network (two LIF populations of N =
   10,000, bf16 couplings with the generic kernel, feedback_weights(N),
   drive 100, 5,000 steps) with both edges LinearSTP: p1 -> p2 depressing
   (U 0.5, tau_depress 5, no facilitation), the feedback p2 -> p1
   facilitating (U 0.2, tau_facil 10, tau_depress 1), in turns with the
   plain-edge network (stp, plain, plain, stp); 40,000 generic launches a
   run; both populations active (the largest window mean of s above 1e-3)
   and the STP state moved (min x of p1 -> p2 below 0.9, max u of p2 -> p1
   above 0.2 after the first run); each network's device-only step; the
   steps 100-160 on the CPU, from the card's whole state after step 100,
   held to the card's (records and the final (u, x)) under
   fused_vs_plain's rule, p1 spiking in them; the kernels line gains the generic
   kernel's entry for this path.
32. edge_family_check: at n = 1,000, float32, 120 steps, an identity input
   through each edge class into a tanh population, on the card against the
   CPU under fused_vs_plain's rule: masked, per-source delay, filter, delay
   + filter, STP, and the delay matrix's onehot, factored, gather, interp
   (hat and factored2) reads and the factored and onehot reads with
   read_dtype bfloat16; then at M = 90 regions of phase 30's network a
   trainable-delay interp edge (delays x 1.1 against a teacher's records x
   1.05, 500 steps): the epoch loss and the gradients of weights and
   delays on the card against the CPU (FIT_LOSS_RTOL, FIT_GRAD_RTOL), and
   one fit_bptt epoch on the card, whose loss must be the same.


Phases 33-36 (PR 18, after phase 32; block-sparse couplings and edges,
ops/sparse.py and the block section of ops/quant.py, whose int8 contraction
is the hand-written kernel block_int8_mv of csrc/block_int8.cu):

33. block_int8_check: block_int8_mv on every route its shapes allow ("mma"
   on the tensor cores, and the __dp4a routes "vec16", "vec4", "scalar")
   bit for bit against its plain version on the card at B = 1, 3, 16 and
   33 trials, bs = 512, 32 and 20 (20 takes neither "mma" nor "vec16"),
   with both index forms: a node coupling's cols over (B, nb_in, bs)
   sources and a flat (nb_in * D1)-block history index, each launch
   counted (mma_launches on "mma" alone); then block_int8_timing at the
   million-neuron shape (1,954 block rows x 4 x 512^2, random int8
   operands), B = 1, 2, 4, 8, 16 and 32: the route block_int8_mv_route
   picks in turns with the __dp4a route "vec16" (chosen, vec16, vec16,
   chosen), against the byte bound, its plain version's ms and the
   yardstick, torch.bmm in bf16 of the same integers (exact) over the
   gathered rows, float32 out.
34. sparse_scale_path: benchmarks/sparse_scale.py's network at N =
   1,000,448 (qif_sfa, dt 1e-4, fan-in 1,000, 512-neuron blocks, seed 0,
   the native sampler, asserted; the tan etas, alpha 0.05, k 15), Pulse(T,
   1, t_on=T//4, amp=3.0) as an array; Network.run of 1,000 steps with
   sampling_steps=100 and the population mean of s, coupling_dtype="int8"
   (block_int8_mv, 1,000 launches a run, asserted) in turns with
   "bfloat16" (a gather and torch.bmm), best of 2: ms/step, nu/s, the
   device's idle share, the kernel's share of the step, the block stream's
   bytes/s, the sampling and build seconds, peak device memory; the host
   float32 master is dropped after the build.  Then the SCALE_BATCH branch:
   run_batch of 16 trials (etas + linspace(-1, 1, 16)) over 500 steps in
   turns with the single trial (500 launches, asserted), trials 0 and 15
   held to single-trial runs with their eta over 100 steps (rtol 1e-5);
   every launch of the int8 run and of run_batch on the route
   block_int8_mv_route gives (mma_launches asserted); one step on the
   device alone for 1 and 16 trials, split by CUDA events into
   block_int8_mv, the sources' int8 rounding and rescale, and the rest of
   the field (block_step_split); and the same construction at N = 8,192 on
   the card against the CPU over 100 steps under fused_vs_plain's rule,
   int8 and bf16.
35. block_delay_path: benchmarks/block_delay_scale.py's network at N =
   100,352 (196 patches, fan-in 1,000, seed 0, dt 1e-3, ring delays scaled
   to 64 steps, etas 1000 + 200 N(0, 1) from default_rng(1), all coupling
   on a FeedbackNetwork self-edge, Pulse(T, 1, t_on=T//8, amp=3.0)): four
   variants in turns over 1,000 steps, best of 2: zero-delay, delayed f32,
   delayed block_dtype="bfloat16" and delayed "int8_master" (block_int8_mv
   on the gathered stack, 1,000 launches a run on the chosen route,
   asserted); ms/step, idle share, the edge's step alone against its byte
   bound, block_int8_mv alone at the edge's shape; two chunked runs of
   500 steps equal to one of 1,000 bit for bit (f32 and int8); the
   delayed run differs from the zero-delay one; the card against the CPU
   at N = 8,192 over 100 steps.
36. sparse_train_check: at N = 8,192, fit_bptt (1 epoch, T = 200, sgd)
   through a block-coupled QIF node with float32 and int8_master weights on
   the chain trajectory (asserted), one epoch through a delayed f32
   BlockSparseLinear edge (train="gd"; plain autograd's loss and gradients,
   then a fit_bptt epoch, which takes the graph trajectory,
   whose loss must be the same), and 20 steps of a frozen
   int8_master edge's source gradient (nonzero: the STE, where the JAX
   package gives zeros), each on the card against the CPU (FIT_LOSS_RTOL,
   FIT_GRAD_RTOL).
The kernels line adds block_int8_mv (B = 1: the int8 run's launches),
block_int8_mv[B=16] (the run_batch launches) and
block_int8_mv[block_delay_path] (the int8 edge's launches, timed at its
gathered-stack shape), each with the kernel_route its launches took, on
which it is timed.

PR 18 cut the depth of earlier paths so that the script, with phases 33-36,
stays well inside its time limit: the forward paths (phases 4, 12, 16, 20,
22, 24 and 31) run 10,000 steps where they ran 20,000, and phase 30's
factored network 4,000 steps where it ran 10,000; no width changed.  For
phases 37-38 the same forward paths were halved again, to 5,000 steps, and
the card-vs-CPU windows of phases 16, 21, 30, 34 and 35 to 100 steps (the
LIF feedback networks of phases 24 and 31 keep 200: their first spikes come
later); the device profiles record device activity alone.  With phases
42-44 the script ran past its time limit on a slow host, so depth was cut
once more, never width: the timed fits of phases 8 and 18 take 4 epochs
(16 before), phase 23 tiles its data to 1,000 steps (2,000), phase 26's
frozen-coupling runs take 2,500 steps (5,000), phase 27's fits 4 and 2
epochs (8 and 4), phase 30 runs 2,000 and 1,000 steps best of 2 (4,000 and
2,000, best of 3) with the factored-against-gather check kept at 2,000
steps, past the longest delay, phase 32's edge cases 250 steps (500),
phases 34 and 35 1,000 steps best of 2 (2,000, best of 3), phase 36's node fits one epoch
(two), phase 37's timed fits 2 epochs (4) and phase 41's multistart fit
1 epoch (2); phase 16 takes the best of 2 runs each; phases 24 and 31
draw their weights once, and their CPU windows end at 160 steps (200),
past the first spikes of both populations (asserted); the device
profiles read the profiler's raw events, not key_averages() (the same
rows, about 10 s faster for an epoch).  With phases 45-47 (about 55 s) the
forward paths (phases 4, 12, 16, 20, 22, 24 and 31) run 3,000 steps
(5,000), phase 26's frozen-coupling run_batch 2,000 (2,500) and the
card-vs-CPU windows of phases 16, 21, 30, 34 and 35 60 steps (100); no
width changed; and torch.export's first trace (about 10 s of imports and
set-up) runs in a thread of its own while nvcc builds the kernels.  The
first call with phases 45-47 ended its phases at 803 s on an NVIDIA H100
80GB HBM3 (phases 45-47: 52.5 s) with the forward paths at 4,000 steps
and 100-step CPU windows.

Phases 37-38 (after phase 36; the graph trajectory of
ops/graph_bptt.py, the chunked and Heun trajectories):

37. graph_train_path: benchmarks/block_delay_scale.py's trained phase
   (BD_TRAIN=1) at N = 100,352 uncut in width: the identity input of
   width 1 into qif_sfa without a coupling, a trained delayed
   BlockSparseLinear feedback self-edge (phase 35's blocks and ring
   delays), T = 500, the drive 0 then 3.0 from T/4, adam lr 1e-4, targets
   from a teacher's run, the student's blocks x 1.05; block_dtype
   "int8_master" and float32, each through the graph trajectory
   (fused_bptt="auto", asserted "graph") in turns with plain autograd
   (fused_bptt=False), one warm epoch each, then one timed fit of 2 epochs
   each (block_delay_scale.py runs 8): ms/epoch, trained nu/s, peak
   memory, losses (decreasing, graph and autograd within 1e-4),
   block_int8_mv launches (one a forward step, all on "mma", asserted);
   one epoch split by CUDA events into the forward loop, the backward
   loop, the deferred dW (timed alone) and adam, the device's idle share
   within each loop over a 100-step window (torch.profiler), the stack
   mv_t (PyTorch) per step against the backward step; then one
   remat_steps=100 fit (2 epochs) of a fresh int8_master student (its
   backward recomputes each chunk: two block_int8_mv launches a step,
   asserted) and block_int8_mv at the edge's shape.
38. graph_train_check: one epoch's loss and gradients through the graph
   trajectory on the card against the CPU and against plain autograd on
   the card (FIT_LOSS_RTOL, FIT_GRAD_RTOL): examples/multi_population_
   training.py's circuit at its sizes (200 + 100, T = 400, the teacher's
   seed 1) with a float32 coupling and an int8_master one on exc (int8_mv
   and int8_mv_t once a step, asserted), a Heun population into an Euler
   one (n = 256), and a chunked (remat_steps=50) feedback network of two
   populations of 256 with a delayed edge; then a truncated-BPTT fit
   (50-step chunks; int8_mv and int8_mv_t once a step, asserted) and a
   fit_bptt_batch (B = 4, minibatches of 2; int8_mm and int8_mm_t once a
   step, asserted) of the feedback network with an int8_master coupling
   on p1, card against CPU.
The kernels line adds block_int8_mv[graph_train_path] (the int8_master
graph fit's launches, timed at the gathered-stack shape).

Phases 39-41 (after phase 38; record_spikes, the input specs of
rectipy_tpu_torch/inputs.py, fit_es and fit_bptt_multistart; no new kernel):

39. spikes_inputs_path: phase 4's population (N = 10,000 qif_sfa, bf16 W,
   the fused QIF step) without its tanh input node, so that the drive
   reaches each neuron: Network.run of Pulse(T, 1, 30,000 from T/10 to the
   end) + Noise(T, channels=N, scale 50, seed 39) over 5,000 steps with
   record_spikes=["qif"] and sampling_steps=100, in which at least half the
   neurons spike; (a) the counts and records
   equal, bit for bit, those of the same run fed spec.materialize(dt,
   device="cuda"); (b) the fused kernel stepped by hand for 100 steps from
   the run's final state: the reader's indicator on each pre-update state
   equals v' == v_reset on every neuron, over at least N/10 spikes; (c)
   ms/step of the array and the
   spec, each with and without record_spikes, in turns (a, a+s, spec+s,
   spec, then back); (d) Noise, Wiener and Poisson materialized on the
   card within the bounds of tests/test_torch_inputs.py.
40. es_path: fit_es of the per-neuron eta of phase 39's network, 16
   candidates a generation (16 x 10,000), 8 generations of one run_batch of
   2,000 steps each (Pulse of 3,000 from step 200), sigma 100, lr 10,000,
   scored by mse on the spike counts per 100-step window against the
   counts of a run at eta + 300; the last generation's mean loss must
   fall below the first's (the search point's loss, the final B=1
   evaluation, is reported beside the starting eta's); every
   generation's run_batch takes qif_sfa_rows_mma_kernel once a step
   (asserted per call, through a wrapper of the network's run_batch), and
   so does the final B=1 evaluation; the state is unchanged and the
   kernel's copy of eta refreshed; ms per generation, aggregate
   candidate-neuron-updates/s; the B = 16 step alone (bound, plain ms,
   torch.matmul of the rows).  Then es_vs_cpu: the same fit at N = 256
   (etas about 3e4, so that neurons spike within 200 steps), 8 candidates,
   3 generations, teacher eta + 50, sigma 20, lr 200, the output
   objective with z-scores, on the card and on
   the CPU (ES_LOSS_RTOL, ES_ETA_RTOL).
41. multistart_path: phase 27's ensemble (int8_master, B = 32, T = 500,
   adam lr 1e-4, phase 27's trial arrays, kept on the host) trained by
   fit_bptt_multistart with 4 starts for 1 epoch, in turns with one
   fit_bptt_batch epoch after a warm one (batch, multistart, a multistart
   of 0 epochs that times the starts' numpy draws alone, batch): 2,000
   launches each of int8_mm and int8_mm_t, all on the tensor cores;
   ms/epoch without the draws, the ratio to the batch epoch, peak memory.
   Then multistart_vs_cpu: 3 starts at N = 1,000 (etas about 500, the
   coupling's gain 300 and init_scale 2 so that the starts part), B = 4,
   T = 50, 2 epochs,
   on the card and on the CPU: per-start losses within MS_LOSS_RTOL = 1e-6
   and the same best start, after a check that the CPU's starts part by
   more than 100 times that.
The kernels line adds qif_sfa_step[spikes_inputs_path] (phase 6's timing
of the same single-row kernel), qif_sfa_step.mma[es_path] (timed at B =
16) and int8_mm[multistart_path] / int8_mm_t[multistart_path] (phase 28's
timings at the same (32, N) shapes).

Phases 42-44 (after phase 41; plasticity: the STDP edges, fit_stdp and
fit_eprop, and the fused STDP update of csrc/stdp_update.cu, a kernel of the
port's own: the JAX package leaves the update to XLA):

42. stdp_path: benchmarks/stdp_scale.py's dense cell uncut (N = 10,000 qif
   FeedbackNetwork, the tan etas, dt 1e-4, the plastic float32 self-edge of
   U(0, 15/N) weights the only coupling, soft bounds, Poisson(1 channel,
   rate 50, amp 10, seed 1) made on the device), fit_stdp over 2,000 steps:
   a warm fit of each variant (500 steps), then in turns the kernel route
   (best of 3), the kernel forced onto its route "row" (the first design;
   1,000 steps, best of 2), the plain update (500 steps, best of 2),
   w_dtype=bfloat16, reward mode with r = 1 (hard bounds) and
   homeostasis_steps=500 (the aligned path), each best of 2; one
   stdp_update launch a step asserted (none for the plain update), every
   one on route "tile" unless "row" was forced;
   ms/step, nu/s, the weights finite and in bounds, peak memory, the idle
   share (a 200-step fit under torch.profiler), and the kernel at each
   variant's shape held to its plain version bit for bit on both routes,
   then both timed in turns against the byte bound and the plain version
   (the route the wrapper picks must have won), with route "tile"'s SASS
   instructions an entry (cuobjdump, where the toolkit has it).
43. block_stdp_path: examples/stdp_100k_blocks.py's network uncut (N =
   100,352, bs 512, fan-in 1,000, the native sampler (asserted), seed 7,
   the blocks scattered to U(0, 15/1,000), hard bounds, homeostasis every
   500 steps): a warm fit of 500 steps (the row masses pinned after it,
   rtol 1e-3), then in turns the kernel (2,000 steps), route "row" (1,000
   steps), the plain update (two fits of 250 steps), the plain update,
   route "row", the kernel; the same figures as phase 42 and the block
   tensor's bytes.
44. plasticity_check: the kernel bit for bit against its plain version in
   every variant (hard, soft, reward), layout (dense, blocks with repeated
   columns) and type (float32, float64, bfloat16) on every route each shape
   allows, at testing.STDP_CHECK_SHAPES (ragged rows of 1,003, 1,004 and
   1,000, blocks of 20, 24 and 128) and at the paths' row widths;
   fit_stdp with reward and homeostasis (every 32 steps) over 100 steps
   at float64, dense N = 256 and blocks N = 2,048 (bs 128), on the card
   and on the CPU: spike counts equal, weights and eligibility within
   1e-10; fit_eprop at full width on rls_path's network
   (its readout registered as train='eprop', instantaneous NLMS, lr 0.5,
   5,000 steps, then test()): one qif_sfa_step launch a step, ms/step, the
   test loss over the target's variance; examples/rl_online_learning.py's
   N = 200 network, card against CPU over 2,000 steps, with its feedback
   weights, normalize off and on (within 1e-9 of the largest value).
The kernels line adds stdp_update[float32,dense], [bfloat16,dense],
[float32,reward,dense] and [float32,blocks] (the kernel route's launches of
one fit of phases 42-43; each with its kernel_route, the "row" route's ms
in the same turns and the SASS count) and qif_sfa_step[bfloat16,eprop_path] (phase 6's
timing of the same kernel).

Phases 45-47 (after phase 44; the tooling: serving bundles through
torch.export with the hand-written kernels as registered operators,
checkpoints, dynamical-systems analysis; no new kernel):

45. serving_path: the main path's bf16 fused network (phase 4), exported
   with serving.export_network for requests of 1,000 steps (sampling_steps
   10), the same network as a 32-trial bundle (requests of 500 steps,
   sampling_steps 50) and phase 16's int8 network (frozen int8 coupling,
   500 steps); a fresh process, started before the exports and refusing
   to build a Network, loads the three bundles (rectipy_tpu_torch.serving;
   the op library because meta.json lists rectipy:: operators) and answers
   4 chained requests (the 4,000 steps of bench_inputs), 2 ensemble
   requests (normal + 3 drives from default_rng(45)) and 1 int8 request;
   its records equal, bit for bit, the window means of Network.run over the
   same steps from the exported state (run_batch for the ensemble), and
   its launches are 4,000 qif_sfa_step, 1,000 B-row (all on the tensor
   cores) and 500 int8_mv.  Then each bundle loaded here and timed
   against Network.run (run_batch) in turns on one request (served, run,
   run, served), with export and load seconds and bundle bytes; and the
   QIF operator's host cost a call as ops/library.py registers it
   (Library.define/impl) against a torch.library.custom_op twin, in turns
   (op_call_us, n = 1,024).  The int8 bundle's request is 500 steps.
46. checkpoint_path: phases 42-43's dense STDP cell (N = 10,000, soft
   bounds, f32, then w_dtype=bfloat16) with homeostasis_steps=300:
   fit_stdp over 500 steps of a 1,000-step Poisson drive made on the card,
   save_network, restore_network into a fresh network and fit the other
   500 steps; weights, both traces, the homeostasis target and phase and
   the population's state equal one uninterrupted 1,000-step fit bit for
   bit; save and restore seconds, snapshot bytes; 2,000 stdp_update
   launches a variant.
47. analysis_path: lyapunov_direct on benchmarks/analysis_scale.py's
   direct workload (N = 10,000 qif_sfa, f32 coupling: the main path's W,
   drive 3.0; transient 1,000, 2,000 steps, renorm 100) with the f32 fused
   kernel attached and without it, in turns over seeds 0 and 1 (kernel,
   plain, plain, kernel): 1,000 + 2 x 2,000 qif_sfa_step launches a fused
   call, exponents and seconds; lyapunov_spectrum on the tangent workload
   (N = 2,048 tanh, g 3, k 4, 5,000 steps after 1,000), timed, and the
   same call cut to 500 steps after 100 held to the CPU's float64 run (in
   a process of its own, nice 10, beside phase 46) within
   rtol 1e-2 + atol 2e-3; fixed_point + stability of the bistable MPR
   node (eta -5, J 15, both stable states) against float64 on the CPU.
The kernels line adds qif_sfa_step[bfloat16,serving_path] (phase 6's
timing of the same kernel, the served process's 4,000 launches),
qif_sfa_step_rows[bfloat16,serving_path] (phase 28's B = 32 timing, 1,000
launches), int8_mv[serving_path] (phase 10's timing, 500 launches),
stdp_update[float32,checkpoint_path] and [bfloat16,checkpoint_path]
(phase 42's timings, 2,000 launches each) and
qif_sfa_step[float32,analysis_path] (phase 6's f32 timing, the 5,000
launches of one fused lyapunov_direct call).

Phase 48 (after phase 47; the bundles of the other forward kernels, which
ops/library.py registers as operators: the generic fused step, single and
B-row, int4_mv/int4_mm and block_int8_mv; no new kernel):

48. serving_kernels_path: exported with serving.export_network and served by
   phase 45's process (a second round of bundles, announced by its own
   ready file), which builds no Network and reads no template: phase 12's
   LIF network (N = 10,000, bf16 coupling, the generic step; the bundle
   carries its generated CUDA source, which the serving process builds) for
   2 chained requests of 1,000 steps (sampling 10) of phase 12's zero
   drive, the same network as a 32-trial bundle for one request of 500
   steps of phase 26's drive (normal + linspace(0, 2); sampling 50), phase
   16's int4 network for 500 steps of bench_inputs (sampling 10), phase
   26's frozen int4 network (batch_run_net) as a 32-trial bundle for 500
   steps of 3 + normal drives from default_rng(48) (sampling 50), and phase
   34's N = 1,000,448 int8 block network (kept from phase 34: 2.0 GB of
   int8 blocks, so the max_memory_allocated_bytes of phases 35-47 include
   it; phase 34 prints memory_allocated_bytes_held_to_phase_48) for 200
   steps of its Pulse (sampling 100); the served
   records equal, bit for bit, the window means of Network.run (run_batch)
   over the same steps from the exported state, and the served process's
   launches are 2,000 generic_fused_step, 500 generic_fused_rows (all on
   the tensor cores), 500 int4_mv, 500 int4_mm (all on the tensor cores)
   and 200 block_int8_mv (all on "mma").  Then each bundle loaded here and
   served against run (run_batch) in turns on one request (served, run,
   run, served), with export and load seconds and bundle bytes; the generic
   operator's host cost a call against its wrapper's direct launch, in
   turns (generic_op_call_us, n = 1,024); and where card and CPU runs of
   the int4 network part (ROADMAP Queue 3): a one-step bundle of phase 16's
   int4 network in int4_path_vs_cpu's start state (spiking), served on the
   card and on the CPU in lockstep over that window's CPU_STEPS steps of
   bench_inputs, every state leaf compared after every step, the first
   step that parts run under an fx interpreter on both devices from the
   same inputs to name the first operation whose output differs; the
   window's records formed as Network.run forms them (from the state; the
   step's output is the s before the step) on each device and held to
   int4_path_vs_cpu's, and formed on both devices from the card's states
   alone.
The kernels line adds generic_fused_step[bfloat16,serving_kernels_path]
(phase 12's timing of the same kernel), generic_fused_rows[bfloat16,
serving_kernels_path] (phase 26's B = 32 tensor-core timing),
int4_mv[serving_kernels_path] (phase 17's), int4_mm[serving_kernels_path]
(phase 28's B = 32 timing) and block_int8_mv[serving_kernels_path] (phase
33's B = 1 timing at the million-neuron shape), each with the served
process's launches.

Phase 49 (after phase 48; multi-device runs, rectipy_tpu_torch.parallel,
on a one-rank NCCL process group; no new kernel):

49. mesh_path: torch.distributed.init_process_group("nccl", rank 0, world
   size 1, a FileStore, device_id the card) and make_mesh(1): the only mesh
   one card can form (model 1, data 1), on which run(mesh=) and
   run_batch(mesh=) take the kernels as the runs without a mesh do.  The
   main path's bf16 fused network (phase 4) over MESH_STEPS steps of
   bench_inputs, phase 16's int8 network (frozen int8 coupling, int8_mv)
   over MESH_B_STEPS, and run_batch of the bf16 fused network at MESH_B =
   32 trials (phase 26's drive, normal + linspace(0, 2)) over MESH_B_STEPS
   on the B-row tensor-core kernel; each run on the mesh and without it, in
   turns (mesh, plain, plain, mesh), from the same reset state: the records
   equal bit for bit, each mesh run's launch counter equals its steps (the
   B-row run's every launch on "mma"); the ms/step of each with and without
   the mesh and their ratio, and sharded_step_collectives a step (none on a
   model axis of one rank).  The group is destroyed at the end of the
   phase; a failure to form it fails the phase.
The kernels line adds qif_sfa_step[bfloat16,mesh_path] (phase 6's timing),
int8_mv[mesh_path] (phase 10's) and qif_sfa_step_rows[bfloat16,mesh_path]
(phase 28's B = 32 timing), each with one mesh run's launches.

Phase 50 (after phase 49; the seven trainers' mesh=, on the same kind of
one-rank NCCL process group; no new kernel):

50. mesh_train_path: init_process_group("nccl", rank 0, world size 1, a
   FileStore, device_id the card) and make_mesh(1), on which each trainer
   reduces to its fit without a mesh.  Each fit runs on the mesh and
   without it, in turns (mesh, plain, plain, mesh), each from a freshly
   built network (N = 10,000, cut in depth only): (a) phase 8's north-star
   int8_master fit_bptt, T_TRAIN steps, MT_EPOCHS = 2 epochs (phase 8: 4),
   RECTIPY_FUSED_ADAM=off in both arms, then one mesh fit under =on, which
   must equal the off fit bit for bit with no adam_requant launch (a mesh
   fit takes the split optimizer); (b) phase 27's ensemble fit_bptt_batch,
   B_TRAIN = 32 trials cut to their first MT_T = 100 steps (phase 27: 500),
   1 epoch; (c) fit_bptt_multistart on the same trials, MT_STARTS = 2
   starts (phase 41: 4; start_inits the master and a perturbation of it
   made once on the card, where phase 41 draws the starts with numpy),
   1 epoch; (d) es_path's fit_es (phase 40), ES_B =
   16 candidates, MT_ES_GENERATIONS = 2 generations of MT_ES_T = 500 steps
   (phase 40: 8 of 2,000), the teacher's spike counts made once; (e) the
   FORCE cell's fit_rls and fit_eprop (phases 20 and 44), MT_FORCE_T =
   1,000 steps each (STEPS); (f) phase 42's dense float32 soft-bound
   fit_stdp, MT_STDP_T = 1,000 steps (STDP_T).  One untimed warm fit
   without the mesh comes before each fit's turns.  Per fit: the losses,
   trained weights and records equal bit for bit across the four turns,
   the launch counters equal in every turn (int8_mv and int8_mv_t for (a);
   int8_mm and int8_mm_t for (b) and (c), every launch on "mma"; the B-row
   qif_sfa_step of (d), every launch on "mma"; qif_sfa_step for (e);
   stdp_update for (f), every launch on "tile"), no collective in any
   fit, sharded_step_collectives 0 of each; the ms/epoch or ms/step of the
   fit alone (the network's build untimed) with and without the mesh (best
   of 2) and their ratio.  The group is
   destroyed at the end of the phase; a failure to form it fails the phase.
The kernels line adds int8_mv[mesh_train_path,fit_bptt] and
int8_mv_t[...] (phase 10's timings), int8_mm and int8_mm_t
[mesh_train_path,fit_bptt_batch] and [...,fit_bptt_multistart] (phase
28's B = 32 timings), qif_sfa_step.mma[mesh_train_path,fit_es] (phase
40's), qif_sfa_step[bfloat16,mesh_train_path,fit_rls] and [...,fit_eprop]
(phase 6's) and stdp_update[float32,mesh_train_path,fit_stdp] (phase
42's), each with one mesh fit's launches.

Phase 51 (after phase 50; a model axis of two on the one card; no new
kernel):

51. mesh_quant_path: first the five kernels of the path at one rank's
   shapes (int4_mv, int4_mv_t on N / 2 = 5,000 rows of the N = 10,000
   coupling, int4_mm and int4_mm_t at B_TRAIN = 32 trials, block_int8_mv
   on 98 of the 196 block rows of the 100k example's coupling), each held
   bit for bit to its plain version and timed with it (mesh_quant_kernels).
   Then two gloo ranks, two processes (rectipy_tpu_torch.testing.
   mesh_quant_rank, a FileStore; NCCL takes one rank a device), each with
   its tensors on the card, make_mesh(MQ_MODEL = 2, device_type="cuda"),
   fit in turns with this process's fits of the same networks without a
   mesh (plain, mesh, plain, mesh; testing.mesh_quant_turns): (a)
   examples/qif_100k_sharded.py's training at its width (N = 100,352,
   block size 512, fan-in 1,000, dt 1e-3, etas 100 +- 20, int8_master
   blocks, delayed diagonal gains trained by gradient descent, the graph
   trajectory), cut in depth to MQ_SIZES' qif_T = 100 steps and 2 epochs
   (the example: 500 and 8); (b) bench.py:331-370's N = 10,000 QIF network
   with an int4_master coupling, fit_bptt, 2 epochs of int4_T = 100 of its
   T_TRAIN steps; (c) the same network's fit_bptt_batch, B_TRAIN = 32
   trials (normal, seed 7) of B_T = 100 steps, one epoch, on data 1 x
   model 2.  Per fit: each rank's launches (block_int8_mv for (a), all on
   "mma"; int4_mv and int4_mv_t for (b); int4_mm and int4_mm_t for (c), all
   on "mma") equal the steps, in every turn and in this process's fits; the
   ranks' losses and trained leaves identical (bits), each turn's equal to
   the first's; the mesh fit within MQ_TOL of the fit without a mesh (the
   largest differences printed, and whether they are 0); comm.tally() of a
   fit on each rank (the steps' collectives with the epochs' output gathers
   and the trained leaves' gather at the end); the ms/epoch of each with and
   without the mesh (best of 2) and their ratio.  gloo stages each
   collective through the host: the mesh times are no measure of NVLink.
The kernels line adds block_int8_mv[mesh_quant_path], int4_mv[...],
int4_mv_t[...], int4_mm[...] and int4_mm_t[...], each with its timing at
the rank's shapes and one rank's launches.

With phase 48 the script takes time out elsewhere, never width:
lif_net's coupling and taus (phases 12, 26 and 48) and batch_run_net's
coupling (the six networks of phases 26 and 48) are drawn once
(lif_weights, batch_run_weights), and the CPU references are cut in
depth: the LIF windows of phases 24 and 31 run steps 100-160 on the CPU
from the card's whole state after step 100 (lif_card_window; before,
steps 0-160 on both), phase 32's edge cases 120 steps (250; the delays
are below 40) and its trainable-delay fit 500 steps (1,000).  Every CPU
reference runs in this process, after the card's timed runs of its phase
and beside none of them: no timed window of the card shares the host with
a CPU reference of this script (phase 47's float64 reference beside phase
46 aside).

Each phase prints one JSON line; then come the ``kernels`` line, the card's
nvidia-smi line and, last, the contract line.  Any failed check raises and
the script exits non-zero.  Without a CUDA device it exits 2 and prints
nothing on stdout.
"""

import contextlib
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N = 10_000
DT = 1e-4
STEPS = 3_000  # 20,000, 10,000, then 5,000, before phases 33-38 and 45-47 (see the docstring)
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
SOURCES = ("qif_sfa_step", "int8_matvec", "adam_requant", "int4_matvec", "block_int8",
           "stdp_update")
GENERIC_SOURCE = "rectipy_tpu_torch/csrc/generic_fused_step.cuh"
GENERIC_TPU_KERNEL = "rectipy_tpu/ops/generic_fused.py:46"
I4_SOURCE = "rectipy_tpu_torch/csrc/int4_matvec.cu"
I4_TPU_KERNEL = "benchmarks/i4pack_microbench.py:54"
N_I4PACK = 14_336  # i4pack_microbench.py's default N
CPU_STEPS = 60  # the card-vs-CPU windows (200 before phases 37-38, 100 before 45-47)
# the LIF feedback networks' windows: p1's first spikes come at step 106
# (v = 1,000 (1 - exp(-t/10)) reaches the threshold 100) and, through the
# plain feedforward edge, p2's at about 131; both must spike in the window,
# which starts from the card's whole state after LIF_CPU_START steps
LIF_CPU_START, LIF_CPU_STEPS = 100, 60
# the training path: bench.py:331-370
T_TRAIN, DT_TRAIN, EPOCHS, LR = 500, 5e-3, 4, 1e-4  # bench.py fits 16 (the run's time limit)
WARM_EPOCHS = 2  # the warm fit of the int8_master and int4_master paths
SPLIT_VS_FUSED_RTOL = 1e-4
T_TBPTT, UPDATE_STEPS = 1_000, 100  # the step-mode path: bench data tiled, the JAX default
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


def device_rows(prof) -> list:
    """(name, device us, count) of each device-side op (kernels, copies,
    fills) of a finished torch.profiler run, summed by name from the
    profiler's raw events: the rows of key_averages() without the event
    tree it builds first (about 10 s for an epoch of a fit).  A CPU op that
    launches a kernel through ctypes also reports that kernel's time as its
    own, which would count it twice: only device events are read."""
    cuda, rows = torch.autograd.DeviceType.CUDA, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        us = ev.duration_ns() / 1e3
        if us > 0:
            total, count = rows.get(ev.name(), (0.0, 0))
            rows[ev.name()] = (total + us, count + 1)
    return [(k, us, c) for k, (us, c) in rows.items()]


def profile_device_time(fn):
    """(device busy ms, top device ops) of one call of ``fn`` under
    torch.profiler; (None, reason) when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    # device activity alone: the same kernel times at a tenth of the cost of
    # tracing the host's ops too (a fit's host trace took about 40 s)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = device_rows(prof)
    read_s = time.perf_counter() - t0
    # what the instrumentation costs: the traced call and reading its events
    emit({"phase": "profiler_cost", "traced_call_s": traced_s, "read_s": read_s,
          "device_ops": len(rows)})
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


@functools.lru_cache(maxsize=None)
def lif_weights(n: int) -> tuple:
    """lif_net's W = |normal| * 0.5/n and tau ~ U(10, 15) from seed 0, drawn
    once for phases 12, 26 and 48 (read, never written)."""
    rng = np.random.default_rng(0)
    W = np.abs(rng.normal(size=(n, n))) * (0.5 / n)
    return W, rng.uniform(10.0, 15.0, size=n)


def lif_net(n: int, device, coupling_dtype: str = "bfloat16"):
    """examples/fused_kernels.py's network at width n: a LIF SpikeResetNet
    with a coupling W = |normal| * 0.5/n (bf16 unless ``coupling_dtype``
    says otherwise; the kernel takes the node's coupling dtype) and
    per-neuron tau ~ U(10, 15) from seed 0, eta 10, tau_s 5, threshold
    +-10, dt 1e-2; the generic kernel attached."""
    from rectipy_tpu_torch import Network, attach_generic_fused_step

    W, tau = lif_weights(n)
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
    with torch.no_grad():
        step, state, params = net.step_args()
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
    line, the N=10,000 timing of int4_mv_t for the training path's entry,
    int4_path_vs_cpu's window: its start state and both devices' records)."""
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
    # in turns, best of 2 each (the run's time limit); the kernels were
    # built and run in phase 15
    for c in ("int4", "int8", "int8", "int4"):
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
    return entry, timing[N], {"y_end": y_end, "card": got, "cpu": ref}


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


@functools.lru_cache(maxsize=1)
def feedback_weights(n: int) -> tuple:
    """examples/feedback_populations.py's weights at width n, drawn from seed 5
    in the example's order: the two populations' couplings (normal), the
    excitatory feedforward edge p1 -> p2 (10 x uniform) and the inhibitory
    feedback edge p2 -> p1 (-100 x uniform); every weight is scaled by 100/n,
    so that a neuron's summed input matches the example's at its n = 100.
    Drawn once for phases 24 and 31 (the arrays are read, never written);
    stp_feedback_phase clears the cache."""
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


LIF_CMP_KW = dict(record_output=False, record_vars=[("p1", "s", True), ("p2", "s", True)],
                  sampling_steps=10, verbose=False)


def lif_card_window(net) -> dict:
    """The card's LIF window of phase 24's or phase 31's network (drive
    STP_DRIVE, the example's), from its current state: LIF_CPU_START steps,
    then the network's whole state (node and edge states and the feedback
    outputs, copied to the CPU) and the records, seconds and final STP
    state of LIF_CPU_STEPS more steps, which the CPU's run from that state
    (lif_cpu_windows) is held to."""
    from rectipy_tpu_torch.trees import rebuild

    net.run(np.full((LIF_CPU_START, 1), STP_DRIVE, dtype=np.float32), **LIF_CMP_KW)
    state = rebuild(net.init_state(), lambda path, t: t.detach().cpu().clone())
    t0 = time.perf_counter()
    o = net.run(np.full((LIF_CPU_STEPS, 1), STP_DRIVE, dtype=np.float32), **LIF_CMP_KW)
    window = {"state": state, "run_s": time.perf_counter() - t0,
              "records": np.stack([o.to_numpy((p, "s")) for p in ("p1", "p2")])}
    if hasattr(net.get_edge("p1", "p2"), "x"):
        window["stp_state"] = np.concatenate([net.get_edge("p1", "p2").x.cpu().numpy(),
                                              net.get_edge("p2", "p1").u.cpu().numpy()])
    return window


def lif_cpu_windows(weights: tuple, states: dict) -> tuple:
    """Phase 24's and phase 31's networks (``weights``: feedback_weights) on
    the CPU, each put in the card's state after LIF_CPU_START steps
    (``states["feedback"]``, ``states["stp"]``: lif_card_window's) and run
    LIF_CPU_STEPS steps of STP_DRIVE: build and run seconds; the records
    and phase 31's final (u, x)."""
    meta, arrays = {}, {}
    for name, build in (("feedback", feedback_net), ("stp", stp_feedback_net)):
        t0 = time.perf_counter()
        net = build(N, "cpu", weights)
        net._write_back(states[name])
        meta[name + "_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        o = net.run(np.full((LIF_CPU_STEPS, 1), STP_DRIVE, dtype=np.float32), **LIF_CMP_KW)
        arrays[name] = np.stack([o.to_numpy((p, "s")) for p in ("p1", "p2")])
        meta[name + "_run_s"] = time.perf_counter() - t0
        if name == "stp":
            arrays["stp_state"] = np.concatenate([net.get_edge("p1", "p2").x.numpy(),
                                                  net.get_edge("p2", "p1").u.numpy()])
        del net
    return meta, arrays


def edge_fit_student(device) -> tuple:
    """Phase 32's trainable-delay fit at FAMILY_M regions on ``device``: the
    teacher's records (delays x 1) x 1.05 and a student with the delays x
    1.1; returns (student, inputs, targets)."""
    M, Tf = FAMILY_M, FAMILY_FIT_T
    Wm, _, taues, dist = wb_data(M)
    dmax = int(np.ceil(1.1 * dist.max() / WB_SPEED / WB_DT))
    finp = np.random.default_rng(3).normal(size=(Tf, M)).astype(np.float32) * 5.0
    net = wb_net(M, Wm, taues, device, delays=dist / WB_SPEED / WB_DT, mode="interp",
                 train="gd", train_delays=True, max_delay=dmax)
    tgt = net.run(finp, verbose=False).to_numpy("out") * 1.05
    student = wb_net(M, Wm, taues, device, delays=dist / WB_SPEED / WB_DT * 1.1,
                     mode="interp", train="gd", train_delays=True, max_delay=dmax)
    return student, finp, tgt


def edge_family_cpu() -> tuple:
    """Phase 32's CPU side: every edge case's records and the trainable-delay
    fit's epoch loss and gradients."""
    n, T, W_rec, W, inp, cases = edge_family_inputs()
    meta, arrays = {}, {}
    for name, kw in cases.items():
        t0 = time.perf_counter()
        arrays[name] = family_net(n, "cpu", W_rec, weights=W, **kw).run(
            inp, sampling_steps=10, verbose=False).to_numpy("out")
        meta[name + "_s"] = time.perf_counter() - t0
    student, finp, tgt = edge_fit_student("cpu")
    t0 = time.perf_counter()
    meta["fit_loss"], grads = epoch_loss_and_grads(student, finp, tgt)
    meta["fit_s"] = time.perf_counter() - t0
    arrays.update({"grad:" + k: v for k, v in grads.items()})
    return meta, arrays


def feedback_phase() -> tuple:
    """Phase 24: examples/feedback_populations.py at N per population.
    Returns the generic kernel's entry of the ``kernels`` line and the
    card's LIF window (lif_card_window), which phase 31 holds to the CPU's."""
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
    # the window held to the CPU's in phase 31, from the initial state
    net.reset()
    card_window = lif_card_window(net)
    del weights
    emit({"phase": "feedback_path", "template": "lif", "populations": 2, "coupling": "bfloat16",
          "edges": "float32 dense feedforward p1->p2 and feedback p2->p1", "n": N,
          "steps": STEPS, "kernel_launches": launches, "w_data_s": data_s, "build_s": build_s,
          "run_s": runs,
          "best_s": best, "ms_per_step": best / STEPS * 1e3,
          "neuron_updates_per_s": 2 * STEPS * N / best, "device_step_ms": dev_ms,
          "device_idle_share": 1.0 - dev_ms / (best / STEPS * 1e3),
          "mean_s_range": [float(np.min(recs)), float(np.max(recs))],
          "vs_cpu": "held in phase 31 (feedback_path_vs_cpu)"})
    entry = generic_instance("lif,bfloat16,feedback_path", net.get_node("p1"), torch.bfloat16,
                             16, launches)
    del net
    torch.cuda.empty_cache()
    return [entry], card_window


# ------------------------------------------------------------ phases 25-28
B_RUN, T_RUN = 32, 2_000  # run_batch_path: benchmarks/batch_throughput.py's network
B_TRAIN, TRAIN_EPOCHS = 32, 4  # batch_train_path: bench.py's ensemble phase
B_RAGGED = (7, 5)  # batch_kernel_check: a ragged B for int8_mm(_t) and the B-row step
CMP_STEPS = 200  # the run_batch trials against single-trial runs
G_B = 32  # run_batch_path's generic-kernel run: trials of PLAIN_STEPS steps
SWEPT_B, SWEPT_STEPS = 4, 1_000  # run_batch_path: a swept int4_master coupling (spikes from ~190)
I4_TRAIN_EPOCHS = 2  # batch_train_path's int4_master ensemble fit
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


@functools.lru_cache(maxsize=1)
def batch_run_weights(n: int) -> np.ndarray:
    """batch_run_net's 10% fan-in coupling of 1/(0.1 n) from seed 42, drawn
    once for the six networks of phases 26 and 48 (read, never written)."""
    rng = np.random.default_rng(42)
    return (rng.random((n, n)) < 0.1) * (1.0 / (0.1 * n))


def batch_run_net(coupling: str, fused: bool, device=None):
    """benchmarks/batch_throughput.py's network: N = 10,000 qif_sfa, a 10%
    fan-in coupling of 1/(0.1 N) from seed 42, the tan etas, dt 1e-4; the
    drive enters I_ext directly."""
    from rectipy_tpu_torch import Network, attach_fused_qif_step

    W = batch_run_weights(N)
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


def batch_phases(dev, W_np, data, single_nu: float, int4_nu: float) -> tuple:
    """Phases 25-28 (the batched trials of run_batch and fit_bptt_batch).
    Returns the entries of the ``kernels`` line for their kernels and host
    copies of phase 27's trial arrays."""
    errs = batch_kernel_check(dev, W_np)
    torch.cuda.empty_cache()
    run_launches, _ = run_batch_phase(dev)
    swept_int4_phase(dev)
    generic_entries = generic_batch_phase(errs)
    launches, epoch_ms, staged, net = batch_train_phase(dev, data, single_nu)
    i4_launches = batch_train_int4_phase(data, staged, int4_nu)
    entries = batch_timing(dev, W_np, net, staged, epoch_ms, launches, run_launches, errs)
    trials = tuple(a.cpu() for a in staged)  # phase 41 trains on the same arrays
    del staged, net
    torch.cuda.empty_cache()
    entries += int4_batch_timing(dev, W_np, i4_launches, run_launches, errs)
    entries += generic_entries
    return entries, trials


# ------------------------------------------------------------ phases 30-32
JR = "rectipy_tpu_torch.models.mean_field.jansen_rit.jansen_rit"
WB_M, WB_DT, WB_SPEED = 998, 1e-4, 2.0  # benchmarks/whole_brain_scale.py's M=998 cell
WB_T, WB_T_SHORT, WB_B = 2_000, 1_000, 8  # depth cut to the run's time limit
WB_CMP_T = 2_000  # factored against gather: past the longest delay (1,156 steps)
WB_TURNS = 2  # the timed runs in turns, best of 2
STP_DRIVE = 100.0  # feedback_phase's drive
FAMILY_N, FAMILY_T, FAMILY_M, FAMILY_FIT_T = 1_000, 120, 90, 500
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
    # the host-bound loops are timed per step: WB_T_SHORT steps suffice for
    # the instantaneous and gather networks beside the factored path's WB_T
    steps = {"factored": WB_T, "instantaneous": WB_T_SHORT, "gather": WB_T_SHORT}
    inputs = {k: torch.zeros((t, M), device=dev) for k, t in steps.items()}
    kw = dict(sampling_steps=100)
    warm = {k: timed_run(net, inputs[k][:200], **kw)[0] for k, net in nets.items()}
    times = {k: [] for k in nets}
    for _ in range(WB_TURNS):  # in turns, best of WB_TURNS
        for k, net in nets.items():
            sec, obs = timed_run(net, inputs[k], **kw)
            times[k].append(sec)
            out = obs.to_numpy("out")
            if out.shape != (steps[k] // 100, M) or not np.all(np.isfinite(out)):
                raise AssertionError(f"whole_brain_path {k}: bad records {out.shape}")
    builds = edge.selector_builds
    if builds != 1 + WB_TURNS:  # one per run: never per step
        raise AssertionError(f"whole_brain_path: {builds} selector builds for "
                             f"{1 + WB_TURNS} runs")
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

    # factored == gather bit for bit over the same WB_CMP_T steps (fresh networks)
    cmp_kw = dict(sampling_steps=10, record_vars=[("brain", "psp_e", False)])
    short = torch.zeros((WB_CMP_T, M), device=dev)
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
          "factored_equals_gather_bit_for_bit": {"steps": WB_CMP_T, "identical": identical},
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


def stp_feedback_phase(dev, fb_window: dict) -> list:
    """Phase 31: feedback_phase's network with short-term plasticity on both
    edges, in turns with the plain-edge network; the card's LIF window of
    it and of phase 24's (``fb_window``; lif_card_window) held to the CPU's
    (lif_cpu_windows, after the timed runs).  Returns the generic kernel's
    entry of the ``kernels`` line."""
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
    # the card against the CPU over LIF_CPU_STEPS steps from the card's
    # state after LIF_CPU_START steps of the initial state (phase 24's
    # network too)
    fresh = stp_feedback_net(N, dev, weights)
    window = lif_card_window(fresh)
    del fresh
    meta, windows = lif_cpu_windows(weights, {"feedback": fb_window["state"],
                                              "stp": window["state"]})
    del weights
    feedback_weights.cache_clear()
    secs = {"card": window["run_s"]}
    cmp = {"card": window["records"], "card_stp": window["stp_state"]}
    fb_cpu = windows["feedback"]
    if not (fb_cpu > 0).any(axis=1).all():  # the window reaches both populations' spikes
        raise AssertionError(f"feedback_path: a population is silent over the CPU window, "
                             f"max mean s {fb_cpu.max(axis=1)}")
    emit({"phase": "feedback_path_vs_cpu", "from_step": LIF_CPU_START, "steps": LIF_CPU_STEPS,
          "records": int(fb_cpu.shape[1]),
          **vs_cpu("feedback_path card vs cpu", fb_window["records"], fb_cpu),
          "cpu_build_s": meta["feedback_build_s"], "card_run_s": fb_window["run_s"],
          "cpu_run_s": meta["feedback_run_s"]})
    cmp["cpu"], cmp["cpu_stp"] = windows["stp"], windows["stp_state"]
    secs["cpu"], cpu_build_s = meta["stp_run_s"], meta["stp_build_s"]
    # p1 spikes in the window; p2, behind the depressing edge, only later
    if not (cmp["cpu"][0] > 0).any():
        raise AssertionError("stp_feedback_path: p1 is silent over the CPU window")
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
          "vs_cpu": {"from_step": LIF_CPU_START, "steps": LIF_CPU_STEPS,
                     "records": int(cmp["cpu"].shape[1]), **vs,
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


def edge_family_inputs() -> tuple:
    """Phase 32's inputs from default_rng(31): ``(n, T, W_rec, W, inputs,
    cases)``, each case an edge's keyword arguments."""
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
    return n, T, W_rec, W, inp, cases


def edge_family_check(dev) -> None:
    """Phase 32: every edge class and delay read on the card against the same
    network on the CPU, and a fit through trainable delays (the CPU's
    records, loss and gradients from edge_family_cpu)."""
    n, T, W_rec, W, inp, cases = edge_family_inputs()
    cpu_meta, cpu = edge_family_cpu()
    lines = {}
    for name, kw in cases.items():
        net = family_net(n, dev, W_rec, weights=W, **kw)
        t0 = time.perf_counter()
        rec = net.run(inp, sampling_steps=10, verbose=False).to_numpy("out")
        card_s = time.perf_counter() - t0
        edge = net.get_edge("inp", "pop")
        if getattr(edge, "selector_builds", 1) > 1:
            raise AssertionError(f"edge_family_check {name}: selectors built per step")
        del net
        lines[name] = {"class": type(edge).__name__, "mode": getattr(edge, "mode", None),
                       **vs_cpu(f"edge_family_check {name}", rec, cpu[name]),
                       "card_run_s": card_s, "cpu_run_s": cpu_meta[name + "_s"]}
    # one fit_bptt epoch through a trainable-delay interp edge at M regions:
    # the loss and gradients of fit_bptt's epoch on both devices, then the
    # epoch itself on the card, whose loss must be the same
    M, Tf = FAMILY_M, FAMILY_FIT_T
    student, finp, tgt = edge_fit_student(dev)
    t0 = time.perf_counter()
    fit = {"card": epoch_loss_and_grads(student, finp, tgt)}
    secs = {"card": time.perf_counter() - t0}
    fit["cpu"] = (cpu_meta["fit_loss"], {k[len("grad:"):]: v for k, v in cpu.items()
                                         if k.startswith("grad:")})
    secs["cpu"] = cpu_meta["fit_s"]
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
SPARSE_DT, SPARSE_T = 1e-4, 1_000
SPARSE_B, SPARSE_T_B = 16, 500  # sparse_scale.py's SCALE_BATCH=16 branch at SCALE_T=500
SPARSE_CMP_STEPS = 100  # the B=16 trials against single-trial runs
SMALL_N = 8_192  # the card-vs-CPU and training width: 16 block rows of 512
BD_N, BD_DMAX, BD_DT, BD_T = 100_352, 64, 1e-3, 1_000  # benchmarks/block_delay_scale.py
SPARSE_TRAIN_T, SPARSE_TRAIN_LR, SPARSE_TRAIN_EPOCHS = 200, 0.1, 1
BLOCK_SOURCE = "rectipy_tpu_torch/csrc/block_int8.cu"
BLOCK_TIMING_B = (1, 2, 4, 8, SPARSE_B, 32)  # phase 33's trials at the million-neuron shape
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


DP4A_ROUTE = "vec16"  # block_int8_mv's __dp4a route at the timed shapes: the yardstick of "mma"


def block_int8_timing(bq, rs, xq, idx) -> dict:
    """block_int8_mv's ms on these operands on the route block_int8_mv_route
    picks, in turns with the __dp4a route (chosen, dp4a, dp4a, chosen; each
    route bit for bit against the plain version first), its plain version's
    ms, its bound (each input read once, the float32 output written once)
    and the yardstick: torch.bmm in bf16 of the same integers (exact) over
    the gathered rows, float32 out (timed only, never on a path)."""
    from rectipy_tpu_torch.ops.quant import (block_int8_mv, block_int8_mv_plain,
                                             block_int8_mv_route)

    n_br, cb, bs, _ = bq.shape
    B = xq.shape[0]
    route = block_int8_mv_route(bs, bq.data_ptr(), xq.data_ptr())
    ref = block_int8_mv_plain(bq, rs, xq, idx)
    turns = {route: [], DP4A_ROUTE: []}
    for r in turns:
        out = block_int8_mv(bq, rs, xq, idx, route=r)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"block_int8_mv {r} differs from its plain version at B={B}")
    del out, ref
    for r in (route, DP4A_ROUTE, DP4A_ROUTE, route):
        turns[r].append(cuda_ms(lambda: block_int8_mv(bq, rs, xq, idx, route=r), reps=50))
    ms = min(turns[route])
    plain_ms = cuda_ms(lambda: block_int8_mv_plain(bq, rs, xq, idx), reps=2)
    a16 = bq.reshape(n_br * cb, bs, bs).to(torch.bfloat16)
    x16 = xq[:, idx.long()].to(torch.bfloat16).permute(1, 2, 3, 0).reshape(n_br * cb, bs, B)
    library_ms = cuda_ms(lambda: torch.bmm(a16, x16, out_dtype=torch.float32), reps=20)
    del a16, x16
    n_bytes = bq.numel() + rs.numel() * 4 + xq.numel() + idx.numel() * 4 + B * n_br * bs * 4
    n_ops = 2.0 * B * n_br * cb * bs * bs
    bound_ms, bound_by = block_bound(n_bytes, n_ops, INT8_OPS)
    dp4a_ms = min(turns[DP4A_ROUTE])
    return {"B": B, "n": n_br * bs, "route": route, "ms": ms, "turns_ms": turns,
            "dp4a_ms": dp4a_ms, "dp4a_over_route": dp4a_ms / ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes, "ops": n_ops,
            "share_of_bound": bound_ms / ms, "dp4a_share_of_bound": bound_ms / dp4a_ms,
            "achieved_bytes_per_s": n_bytes / (ms * 1e-3), "bit_identical": True}


def block_int8_check(dev) -> dict:
    """Phase 33: block_int8_mv on every route its shapes allow, bit for bit
    against its plain version, and its timing at the million-neuron shape
    on the chosen route in turns with the __dp4a one."""
    from rectipy_tpu_torch.ops.quant import (block_int8_mv, block_int8_mv_plain,
                                             block_int8_mv_route, block_int8_mv_routes)

    g = torch.Generator(device=dev)
    g.manual_seed(18)

    def rint(shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)

    n_br, cb, nb_in, d1 = 6, 4, 6, 5
    cases = []
    for B in (1, 3, SPARSE_B, 33):
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
                idx = idx.contiguous()
                ref = block_int8_mv_plain(bq, rs, xq, idx)
                routes = block_int8_mv_routes(bs, bq.data_ptr(), xq.data_ptr())
                for route in routes:
                    before = (block_int8_mv.launches, block_int8_mv.mma_launches)
                    out = block_int8_mv(bq, rs, xq, idx, route=route)
                    torch.cuda.synchronize()
                    after = (block_int8_mv.launches, block_int8_mv.mma_launches)
                    want = (before[0] + 1, before[1] + (route == "mma"))
                    if after != want or not torch.equal(out, ref):
                        raise AssertionError(f"block_int8_mv B={B} bs={bs} {form} {route}: "
                                             f"differs from its plain version")
                cases.append({"B": B, "bs": bs, "index": form, "bit_identical": list(routes),
                              "chosen": block_int8_mv_route(bs, bq.data_ptr(), xq.data_ptr())})
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
    timing = {B: block_int8_timing(bq, rs, rint((B, n_br, bs)), idx) for B in BLOCK_TIMING_B}
    del bq, rs, idx
    torch.cuda.empty_cache()
    emit({"phase": "block_int8_timing", "n_br": n_br, "cb": cb, "bs": bs,
          "random_int8_operands": True, "by_trials": list(timing.values())})
    return timing


def block_step_split(net, B: int, bvars: dict = None) -> dict:
    """One step of the block-coupled int8 network on the device alone (CUDA
    events through cuda_ms), for 1 or B trials, split: the whole step (the
    step, states and parameters of Network.step_args, which run and
    run_batch advance); the coupling's
    product (dsl/lower.py's _frozen_block_matvec: the sources' int8
    rounding, block_int8_mv, the rescale); block_int8_mv alone at the
    step's shapes.  The rounding and rescale are the product less the
    kernel, the rest of the field the step less the product."""
    from rectipy_tpu_torch.dsl.lower import _frozen_block_matvec
    from rectipy_tpu_torch.ops.quant import block_int8_mv

    dev = net.device
    x0 = torch.full((1,), 3.0, device=dev)
    with torch.no_grad():
        if bvars is None:
            (step, state, pp), x = net.step_args(), x0
        else:
            (step, state, pp), x = net.step_args(B, bvars), x0.expand(B, 1)
        a = pp["nodes"]["qif"]
        wkey = next(k[:-len("__cols")] for k in a if k.endswith("__cols"))
        bq, scale, cols = a[wkey], a[wkey + "__scale"], a[wkey + "__cols"]
        n_br, _, bs, _ = bq.shape
        src = torch.rand((B, n_br * bs) if bvars is not None else (n_br * bs,), device=dev)
        xq = torch.randint(-127, 128, (B, n_br, bs), dtype=torch.int8, device=dev)
        step_ms = cuda_ms(lambda: step(state, pp, x), reps=8)
        product_ms = cuda_ms(lambda: _frozen_block_matvec(bq, scale, cols, src), reps=20)
        kernel_ms = cuda_ms(lambda: block_int8_mv(bq, scale, xq, cols), reps=20)
    return {"B": B, "step_ms": step_ms, "coupling_ms": product_ms, "block_int8_mv_ms": kernel_ms,
            "round_and_rescale_ms": product_ms - kernel_ms,
            "rest_of_field_ms": step_ms - product_ms}


def sparse_scale_phase(dev, timing: dict) -> tuple:
    """Phase 34: benchmarks/sparse_scale.py's N = 1,000,448 network on the
    card, int8 (block_int8_mv) in turns with bf16 (gather + torch.bmm), the
    B = 16 sweep, and the card against the CPU at N = 8,192.  Returns the
    kernels-line entries and the int8 network, which phase 48 serves."""
    from rectipy_tpu_torch import block_random_connectivity
    from rectipy_tpu_torch.ops.quant import block_int8_mv, block_int8_mv_route

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
    # the route the choice gives the int8 network's launches: its blocks'
    # address, and a fresh int8 allocation's for the sources it quantizes
    # each step (the caching allocator aligns both alike)
    a8 = nets["int8"].get_node("qif").args
    bq_ptr = next(v for k, v in a8.items() if k + "__cols" in a8).data_ptr()
    xq_ptr = torch.empty(SPARSE_BS, dtype=torch.int8, device=dev).data_ptr()
    routes = {B: block_int8_mv_route(SPARSE_BS, bq_ptr, xq_ptr) for B in (1, SPARSE_B)}
    first, launches, mma = {}, {}, {}
    for c, net in nets.items():
        net.reset()
        before = (block_int8_mv.launches, block_int8_mv.mma_launches)
        first[c], obs = timed_run(net, drive, **kw)
        launches[c] = block_int8_mv.launches - before[0]
        mma[c] = block_int8_mv.mma_launches - before[1]
        rec = obs.to_numpy(("qif", "s"))
        if rec.shape != (SPARSE_T // 100,) or not np.all(np.isfinite(rec)):
            raise AssertionError(f"sparse_scale_path {c}: bad records {rec.shape}")
    want_mma = SPARSE_T if routes[1] == "mma" else 0
    if launches != {"int8": SPARSE_T, "bfloat16": 0} or mma != {"int8": want_mma, "bfloat16": 0}:
        raise AssertionError(f"sparse_scale_path: block_int8_mv launches {launches}, on the "
                             f"tensor cores {mma} (route {routes[1]})")
    times, recs = {c: [] for c in nets}, {}
    for _ in range(2):  # in turns, best of 2
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
    before = (block_int8_mv.launches, block_int8_mv.mma_launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.run_batch(drive_b, batch_vars=bvars, **kw)
    torch.cuda.synchronize()
    first_b = time.perf_counter() - t0
    launches_b = block_int8_mv.launches - before[0]
    mma_b = block_int8_mv.mma_launches - before[1]
    if launches_b != SPARSE_T_B or mma_b != (SPARSE_T_B if routes[SPARSE_B] == "mma" else 0):
        raise AssertionError(f"sparse_scale_path: {launches_b} launches ({mma_b} on the tensor "
                             f"cores, route {routes[SPARSE_B]}) for {SPARSE_T_B} batched steps")
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
    # one step on the device alone, split (the kernel, the sources' int8
    # rounding and rescale, the rest of the field), for 1 and B trials
    split = {1: block_step_split(net, 1), SPARSE_B: block_step_split(net, SPARSE_B, bvars)}
    split_ratio = {k: split[SPARSE_B][k] / split[1][k] for k in split[1] if k != "B"}
    peak = torch.cuda.max_memory_allocated()
    block_net = nets["int8"]  # phase 48 serves it (2.0 GB of int8 blocks on the card)
    del nets, net, node, drive, drive_b, res
    torch.cuda.empty_cache()
    # what stays allocated until phase 48, chiefly block_net: the absolute
    # max_memory_allocated_bytes of phases 35-47 include it
    held = torch.cuda.memory_allocated()

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
          "block_int8_mv_route": routes[1], "block_int8_mv_mma_launches": mma["int8"],
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
                        "block_int8_mv_route": routes[SPARSE_B],
                        "block_int8_mv_mma_launches": mma_b,
                        "device_step_split": split, "split_b_over_single": split_ratio,
                        "trials_vs_single_max_abs_diff": trial_diff,
                        "trial_steps": SPARSE_CMP_STEPS},
          "vs_cpu": {"n": SMALL_N, "steps": CPU_STEPS, **vs},
          "max_memory_allocated_bytes": peak, "memory_allocated_bytes_held_to_phase_48": held})
    out = []
    for B, n_launch, name in ((1, launches["int8"], "block_int8_mv"),
                              (SPARSE_B, launches_b, f"block_int8_mv[B={SPARSE_B}]")):
        t = timing[B]
        if t["route"] != routes[B]:
            raise AssertionError(f"block_int8_mv at B={B}: timed on {t['route']}, the path "
                                 f"took {routes[B]}")
        out.append({"name": name, "route": "cuda", "source": BLOCK_SOURCE,
                    "replaces": BLOCK_REPLACES, "launches": n_launch, "max_abs_err": 0.0,
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                    "kernel_route": routes[B]})
    return out, block_net


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


def bd_net(N: int, A, d_blk, etas, device, inp: bool = False, **edge_kw):
    """All recurrent coupling on a FeedbackNetwork self-edge: a
    BlockSparseLinear with per-block delays d_blk (None: no delays).
    ``inp``: the trained phase's identity input node of width 1, joined to
    the population by the weights normal(size=(N, 1)) of default_rng(7)."""
    from rectipy_tpu_torch import FeedbackNetwork

    net = FeedbackNetwork(BD_DT, device=device)
    if inp:
        net.add_func_node("inp", 1, activation_function="identity")
    net.add_diffeq_node(
        "qif", QIF_SFA, n=N, input_var="I_ext", output_var="s", spike_var="spike",
        spike_def="v", op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                   "all/qif_sfa_op/k": 15.0})
    if inp:
        net.add_edge("inp", "qif", weights=np.random.default_rng(7).normal(
            size=(N, 1)).astype(np.float32))
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
    first, launches, mma, first_recs = {}, {}, {}, {}
    for k, net in nets.items():
        before = (block_int8_mv.launches, block_int8_mv.mma_launches)
        first[k], obs = timed_run(net, drive, **kw)
        launches[k] = block_int8_mv.launches - before[0]
        mma[k] = block_int8_mv.mma_launches - before[1]
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
    for _ in range(2):  # in turns, best of 2
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
    if mma["delay_int8"] != (BD_T if k_t["route"] == "mma" else 0):
        raise AssertionError(f"block_delay_path: {mma['delay_int8']} tensor-core launches on "
                             f"route {k_t['route']}")
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
          "block_int8_mv_mma_launches": mma["delay_int8"],
          "block_int8_mv_at_edge_shape": k_t, "delayed_vs_zero_delay_max_abs_diff": delay_effect,
          "chunked_equals_one_run_bit_for_bit": chunked,
          "vs_cpu": {"n": SMALL_N, "steps": CPU_STEPS, **vs},
          "max_memory_allocated_bytes": peak})
    return [{"name": "block_int8_mv[block_delay_path]", "route": "cuda",
             "source": BLOCK_SOURCE, "replaces": BLOCK_REPLACES,
             "launches": launches["delay_int8"], "max_abs_err": 0.0, "ms": k_t["ms"],
             "plain_ms": k_t["plain_ms"], "bound_ms": k_t["bound_ms"],
             "bound_by": k_t["bound_by"], "library_ms": k_t["library_ms"],
             "kernel_route": k_t["route"]}]


def rel_norm(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def sparse_train_runs(device) -> tuple:
    """Phase 36's work on ``device``: fit_bptt through a block-coupled node
    (float32 and int8_master, the chain trajectory), one epoch's loss and
    gradients through a delayed f32 BlockSparseLinear edge and the epoch
    itself, and a frozen int8_master edge's source gradient.  Returns the
    scalars (seconds, losses) and the arrays (per-epoch losses, weight
    updates, gradients)."""
    from rectipy_tpu_torch import BlockSparseLinear, Network, block_random_connectivity

    N, T = SMALL_N, SPARSE_TRAIN_T
    A = block_random_connectivity(N, N, SPARSE_FAN_IN, block_size=SPARSE_BS, seed=0)
    rng = np.random.default_rng(18)
    etas = 20.0 + rng.random(N)  # every neuron spikes within the window
    inp = (rng.normal(size=(T, N)) * 2.0 + 5.0).astype(np.float32)
    tgt = (rng.normal(size=(T, N)) * 0.1).astype(np.float32)
    meta, arrays = {}, {}
    for coupling in ("float32", "int8_master"):
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
        obs = net.fit_bptt([inp] * SPARSE_TRAIN_EPOCHS, [tgt] * SPARSE_TRAIN_EPOCHS,
                           optimizer="sgd", lr=SPARSE_TRAIN_LR, verbose=False)
        meta[coupling + "_fit_s"] = time.perf_counter() - t0
        if net.last_fit["trajectory"] != "chain":
            raise AssertionError(f"sparse_train_check {coupling}: took {net.last_fit}")
        arrays[coupling + "_losses"] = np.asarray(obs["epoch_loss"], dtype=np.float64)
        arrays[coupling + "_dw"] = net.get_node("qif")["weights"].detach().cpu().numpy() - w0
        del net

    # one epoch through a delayed f32 BlockSparseLinear feedback edge
    A8, d8, e8 = bd_data(N)
    drive = pulse(T, T // 8)
    net = bd_net(N, A8, d8, e8, device, train="gd")
    teacher = bd_net(N, A8, d8, e8, device).run(drive, verbose=False).to_numpy("out")
    edge = net.get_edge("qif", "qif")
    edge.weights = edge.weights * 1.05
    meta["edge_loss"], grads = epoch_loss_and_grads(net, drive, teacher)
    obs = net.fit_bptt([drive], [teacher], optimizer="sgd", lr=1e-3, verbose=False)
    meta["edge_fit_loss"] = float(obs["epoch_loss"][0])
    arrays.update({"grad:" + k: v for k, v in grads.items()})
    del net

    # a frozen int8_master edge passes source gradients (the STE's)
    g = np.random.default_rng(36)
    xs = g.normal(size=(20, N)).astype(np.float32)
    gs = g.normal(size=(20, N)).astype(np.float32)
    e = BlockSparseLinear(N, N, weights=A8, delays=d8, block_dtype="int8_master", device=device)
    params, step = e.prep_params(dict(e.params)), e.make_step()
    x = torch.as_tensor(xs, device=device).requires_grad_(True)
    state, total = e.init_state(), 0.0
    for t in range(xs.shape[0]):
        state, y = step(state, params, x[t])
        total = total + (y * torch.as_tensor(gs[t], device=device)).sum()
    (gx,) = torch.autograd.grad(total, x)
    arrays["src_grad"] = gx.cpu().numpy()
    return meta, arrays


def sparse_train_check(dev) -> None:
    """Phase 36: sparse_train_runs on the card against the CPU's: the node
    fits' losses and weight updates, the delayed
    edge's loss, gradients and fit, the frozen edge's source gradient
    (nonzero)."""
    card_meta, card = sparse_train_runs(dev)
    cpu_meta, cpu = sparse_train_runs("cpu")
    node_fits = {}
    for coupling in ("float32", "int8_master"):
        lc, lp = card[coupling + "_losses"], cpu[coupling + "_losses"]
        dc, dp = card[coupling + "_dw"], cpu[coupling + "_dw"]
        loss_rtol = float(np.abs(lc - lp).max() / np.abs(lp).max())
        grad_rel = rel_norm(dc, dp)
        if not (np.all(np.isfinite(lc)) and loss_rtol <= FIT_LOSS_RTOL
                and grad_rel <= FIT_GRAD_RTOL and np.abs(dp).max() > 0):
            raise AssertionError(f"sparse_train_check {coupling}: losses {lc} vs {lp}, "
                                 f"gradient relative norm {grad_rel}")
        node_fits[coupling] = {"losses": lc.tolist(), "cpu_losses": lp.tolist(),
                               "loss_rtol": loss_rtol, "weights_grad_rel_norm": grad_rel,
                               "card_fit_s": card_meta[coupling + "_fit_s"],
                               "cpu_fit_s": cpu_meta[coupling + "_fit_s"],
                               "trajectory": "chain"}
    lc, lp, fc = card_meta["edge_loss"], cpu_meta["edge_loss"], card_meta["edge_fit_loss"]
    g_rel = {k[len("grad:"):]: rel_norm(card[k], cpu[k]) for k in cpu if k.startswith("grad:")}
    if not (abs(lc - lp) <= FIT_LOSS_RTOL * abs(lp) and abs(fc - lc) <= FIT_LOSS_RTOL * abs(lc)
            and all(v <= FIT_GRAD_RTOL for v in g_rel.values())):
        raise AssertionError(f"sparse_train_check edge: loss {lc} vs {lp} (fit {fc}), "
                             f"gradients {g_rel}")
    s_rel = rel_norm(card["src_grad"], cpu["src_grad"])
    s_max = float(np.abs(card["src_grad"]).max())
    if not (s_max > 0 and s_rel <= FIT_GRAD_RTOL):
        raise AssertionError(f"sparse_train_check: frozen int8_master source gradient max "
                             f"{s_max}, card vs cpu {s_rel}")
    emit({"phase": "sparse_train_check", "n": SMALL_N, "steps": SPARSE_TRAIN_T,
          "epochs": SPARSE_TRAIN_EPOCHS, "optimizer": "sgd", "node_fits": node_fits,
          "delayed_edge_epoch": {"loss": lc, "cpu_loss": lp, "fit_loss": fc,
                                 "grad_rel_norm": g_rel},
          "frozen_int8_master_edge_source_grad": {"max_abs": s_max, "card_vs_cpu_rel_norm": s_rel,
                                                  "steps": card["src_grad"].shape[0]},
          "loss_rtol": FIT_LOSS_RTOL, "grad_rtol": FIT_GRAD_RTOL})


GT_T, GT_EPOCHS, GT_LR, GT_REMAT = 500, 2, 1e-4, 100  # block_delay_scale.py BD_TRAIN=1
GT_PROFILE_T = 100  # graph_train_path's profiled window of steps
GT_VARIANTS = {"int8_master": {"block_dtype": "int8_master"}, "float32": {}}
GC_T, GC_B = 400, 4  # graph_train_check: examples/multi_population_training.py's T; B trials


def epoch_loss_and_grads(net, inp, tgt, trajectory: str = "autograd", remat: int = 0) -> tuple:
    """fit_bptt's epoch loss (mse on every step) and its gradients with
    respect to the trainable leaves, through plain autograd over the
    network's own step and edge prep, or through the graph trajectory
    (``remat``: the chunked one)."""
    from rectipy_tpu_torch.ops.graph_bptt import graph_weights_args, make_graph_traj

    params = net.parameters_pytree()
    paths = net.trainable_paths()
    leaves = [params[k][l][p].detach().clone().requires_grad_(True) for k, l, p in paths]
    for (k, l, p), leaf in zip(paths, leaves):
        params[k][l] = {**params[k][l], p: leaf}
    xs, tgt = net._to_device(inp), net._to_device(tgt)
    with torch.enable_grad():
        if trajectory == "graph":
            traj, spec = make_graph_traj(net, remat_steps=remat)
            w, a = graph_weights_args(spec, params)
            _, outs = traj(w, a, net._graph_pack(spec, net.init_state()), xs)
        else:
            _, outs = net._plain_outs(net.make_step(), net._prep_edge_params(params),
                                      net.init_state(), xs)
        loss = torch.mean((outs - tgt) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {"/".join(p): g.cpu().numpy() for p, g in zip(paths, grads)}


def timed_fit(net, inp_d, tgt_d, epochs: int, **kw) -> tuple:
    """``(seconds, losses, peak bytes)`` of one fit_bptt on the card; the
    peak counts what the fit allocated above the bytes live at its start."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    obs = net.fit_bptt([inp_d] * epochs, [tgt_d] * epochs, optimizer="adam", lr=GT_LR,
                       verbose=False, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in obs["epoch_loss"]]
    if len(losses) != epochs or not np.all(np.isfinite(losses)):
        raise AssertionError(f"graph_train_path: bad losses {losses}")
    return seconds, losses, torch.cuda.max_memory_allocated() - start


def graph_epoch_split(net, inp_d, tgt_d) -> dict:
    """One epoch of the graph trajectory split by CUDA events (and the
    host's clock): the forward loop, the backward loop, the deferred dW
    contraction (timed alone at the epoch's shapes) and adam; each loop's
    device busy time from torch.profiler (the idle share within it); and the
    edge's transposed contraction (the gathered-stack mv_t, PyTorch) per
    step against the backward loop's share of a step."""
    from rectipy_tpu_torch.ops.graph_bptt import (_block_edge_ops, graph_weights_args,
                                                  make_graph_traj)
    from rectipy_tpu_torch.train import get_optimizer

    edge = net.get_edge("qif", "qif")
    prep, _, mv_t, grad_w = _block_edge_ops(edge)
    traj, spec = make_graph_traj(net)
    w, a = graph_weights_args(spec, net.parameters_pytree())
    W = w["e:qif->qif"].detach().requires_grad_(True)
    w = {**w, "e:qif->qif": W}
    C0 = net._graph_pack(spec, net.init_state())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    wall = {}
    torch.cuda.synchronize()
    with torch.enable_grad():
        t0 = time.perf_counter()
        ev[0].record()
        _, outs = traj(w, a, C0, inp_d)
        ev[1].record()
        loss = torch.mean((outs - tgt_d) ** 2)
        torch.cuda.synchronize()
        wall["forward_loop"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        (gW,) = torch.autograd.grad(loss, W)
        ev[2].record()
        torch.cuda.synchronize()
        wall["backward_loop_and_dW"] = (time.perf_counter() - t0) * 1e3
    n_br, cb, bs = edge.cols.shape[0], edge.cols.shape[1], edge.bs
    g = torch.Generator(device=inp_d.device)
    g.manual_seed(37)
    deltas = torch.randn((GT_T, n_br * bs), device=inp_d.device, generator=g)
    srcs = torch.randn((GT_T, n_br, cb, bs), device=inp_d.device, generator=g)
    ev[3].record()
    grad_w(deltas, srcs)
    ev[4].record()
    opt = get_optimizer("adam", GT_LR)
    train = {"nodes": {}, "edges": {"qif->qif": {"weights": W.detach()}}}
    opt.update({"nodes": {}, "edges": {"qif->qif": {"weights": gW}}}, opt.init(train), train)
    ev[5].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_all, dw = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                           ev[3].elapsed_time(ev[4]))
    split = {"forward_loop": fwd_ms, "backward_loop": bwd_all - dw, "deferred_dW": dw,
             "optimizer": ev[4].elapsed_time(ev[5])}
    wp = prep(W.detach())
    delta = deltas[0]
    mv_t_ms = cuda_ms(lambda: mv_t(wp, delta), reps=20)
    del deltas, srcs, outs, loss, gW
    # the device's busy time within each loop, over the first GT_PROFILE_T
    # steps (torch.profiler; the same window unprofiled gives the wall
    # time): the host's gaps between kernels
    xs_n, tg_n = inp_d[:GT_PROFILE_T], tgt_d[:GT_PROFILE_T]

    def fwd():
        return traj(w, a, C0, xs_n)[1]

    with torch.enable_grad():
        torch.autograd.grad(torch.mean((fwd() - tg_n) ** 2), W)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = fwd()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(torch.mean((outs - tg_n) ** 2), W)
        torch.cuda.synchronize()
        win_wall = {"forward_loop": (t1 - t0) * 1e3,
                    "backward_loop_and_dW": (time.perf_counter() - t1) * 1e3}
        fwd_busy, _ = profile_device_time(fwd)
        loss = torch.mean((fwd() - tg_n) ** 2)
        bwd_busy, top = profile_device_time(lambda: torch.autograd.grad(loss, W))
    del loss
    busy = {"forward_loop": fwd_busy, "backward_loop_and_dW": bwd_busy}
    idle = {k: 1.0 - v / win_wall[k] for k, v in busy.items() if v is not None}
    bwd_step = split["backward_loop"] / GT_T
    return {"epoch_split_ms": split, "host_wall_ms": wall, "profile_window_steps": GT_PROFILE_T,
            "window_wall_ms": win_wall, "window_device_busy_ms": busy,
            "device_idle_share_within": idle, "backward_top_device_ops": top,
            "mv_t_ms_per_step": mv_t_ms, "backward_loop_ms_per_step": bwd_step,
            "mv_t_share_of_backward_step": mv_t_ms / bwd_step}


def graph_train_phase(dev) -> list:
    """Phase 37: benchmarks/block_delay_scale.py's trained phase (BD_TRAIN=1)
    at N = 100,352: the delayed block feedback edge trained by fit_bptt
    through the graph trajectory in turns with plain autograd, int8_master
    and float32, then one remat_steps=100 fit of the int8_master variant."""
    from rectipy_tpu_torch import block_random_connectivity
    from rectipy_tpu_torch.ops.quant import block_int8_mv, quantize_blocks

    N, T = BD_N, GT_T
    t0 = time.perf_counter()
    A, d_blk, etas = bd_data(N)
    sample_s = time.perf_counter() - t0
    if block_random_connectivity.last_backend != "native":
        raise AssertionError("graph_train_path: the sampler did not take the native backend")
    inp_d = torch.as_tensor(pulse(T, T // 4), device=dev)
    kernel_entry = None
    for name, ekw in GT_VARIANTS.items():
        teacher = bd_net(N, A, d_blk, etas, dev, inp=True, **ekw)
        tgt_d = torch.as_tensor(teacher.run(inp_d, verbose=False).to_numpy("out"), device=dev)
        del teacher
        if float(tgt_d.abs().max()) == 0.0:
            raise AssertionError(f"graph_train_path {name}: the teacher does not spike")
        nets = {}
        for mode in ("graph", "autograd"):
            net = bd_net(N, A, d_blk, etas, dev, inp=True, train="gd", **ekw)
            edge = net.get_edge("qif", "qif")
            edge.weights = edge.weights * 1.05  # the teacher-student perturbation
            nets[mode] = net
        fused = {"graph": "auto", "autograd": False}
        warm = {m: timed_fit(net, inp_d, tgt_d, 1, fused_bptt=fused[m])[0]
                for m, net in nets.items()}
        res = {}
        for mode in ("graph", "autograd"):  # in turns, after one warm epoch each
            before = (block_int8_mv.launches, block_int8_mv.mma_launches)
            secs, losses, peak = timed_fit(nets[mode], inp_d, tgt_d, GT_EPOCHS,
                                           fused_bptt=fused[mode])
            launches = (block_int8_mv.launches - before[0],
                        block_int8_mv.mma_launches - before[1])
            if nets[mode].last_fit["trajectory"] != mode:
                raise AssertionError(f"graph_train_path {name}: {mode} took "
                                     f"{nets[mode].last_fit}")
            want = GT_EPOCHS * T if name == "int8_master" else 0
            if launches != (want, want):
                raise AssertionError(f"graph_train_path {name} {mode}: block_int8_mv launches "
                                     f"{launches}, want {want} all on mma")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"graph_train_path {name} {mode}: losses {losses}")
            res[mode] = {"fit_s": secs, "warm_fit_s": warm[mode], "losses": losses,
                         "ms_per_epoch": secs / GT_EPOCHS * 1e3,
                         "trained_neuron_updates_per_s": T * N * GT_EPOCHS / secs,
                         "peak_bytes_above_start": peak, "block_int8_mv_launches": launches[0]}
        lg, lp = np.asarray(res["graph"]["losses"]), np.asarray(res["autograd"]["losses"])
        rel = float(np.abs(lg - lp).max() / np.abs(lp).max())
        if rel > FIT_LOSS_RTOL:
            raise AssertionError(f"graph_train_path {name}: graph vs autograd losses {lg} vs "
                                 f"{lp}")
        net = nets["graph"]
        split = graph_epoch_split(net, inp_d, tgt_d)
        busy = split["window_device_busy_ms"]
        busy_ms = None  # the epoch's device time: the windows scaled to T, dW and adam
        if None not in busy.values():
            busy_ms = ((busy["forward_loop"] + busy["backward_loop_and_dW"]) * T / GT_PROFILE_T
                       + split["epoch_split_ms"]["optimizer"])
        line = {"phase": "graph_train_path", "variant": name, "n": N, "steps": T,
                "epochs_per_fit": GT_EPOCHS, "lr": GT_LR, "sample_s": sample_s,
                "graph_vs_autograd_loss_rel": rel,
                "graph_over_autograd_speed": (res["autograd"]["ms_per_epoch"]
                                              / res["graph"]["ms_per_epoch"]),
                "device_busy_ms_per_epoch": busy_ms,
                "device_idle_share": (None if busy_ms is None
                                      else 1.0 - busy_ms / res["graph"]["ms_per_epoch"]),
                **res, **split}
        if name == "int8_master":
            nets.clear()
            net = bd_net(N, A, d_blk, etas, dev, inp=True, train="gd", **ekw)  # a fresh student
            edge = net.get_edge("qif", "qif")
            edge.weights = edge.weights * 1.05
            before = (block_int8_mv.launches, block_int8_mv.mma_launches)
            secs, losses, peak = timed_fit(net, inp_d, tgt_d, 2, remat_steps=GT_REMAT)
            launches = (block_int8_mv.launches - before[0],
                        block_int8_mv.mma_launches - before[1])
            # the chunked backward recomputes each chunk's forward
            if net.last_fit["trajectory"] != "graph" or launches != (4 * T, 4 * T):
                raise AssertionError(f"graph_train_path remat: {net.last_fit}, launches "
                                     f"{launches}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"graph_train_path remat: losses {losses}")
            line["remat"] = {"remat_steps": GT_REMAT, "epochs": 2, "ms_per_epoch": secs / 2 * 1e3,
                             "trained_neuron_updates_per_s": T * N / (secs / 2),
                             "losses": losses, "peak_bytes_above_start": peak,
                             "block_int8_mv_launches": launches[0]}
            # the kernel at the edge's gathered-stack shape
            bq, scale = quantize_blocks(net.get_edge("qif", "qif").weights)
            n_br, cb = A.cols.shape
            g = torch.Generator(device=dev)
            g.manual_seed(38)
            xq = torch.randint(-127, 128, (1, n_br * cb, SPARSE_BS), dtype=torch.int8,
                               device=dev, generator=g)
            idx = torch.arange(n_br * cb, dtype=torch.int32, device=dev).reshape(n_br, cb)
            k_t = block_int8_timing(bq, scale, xq, idx)
            if k_t["route"] != "mma":
                raise AssertionError(f"graph_train_path: block_int8_mv route {k_t['route']}")
            kernel_entry = {"name": "block_int8_mv[graph_train_path]", "route": "cuda",
                            "source": BLOCK_SOURCE, "replaces": BLOCK_REPLACES,
                            "launches": res["graph"]["block_int8_mv_launches"],
                            "max_abs_err": 0.0, "ms": k_t["ms"], "plain_ms": k_t["plain_ms"],
                            "bound_ms": k_t["bound_ms"], "bound_by": k_t["bound_by"],
                            "library_ms": k_t["library_ms"], "kernel_route": k_t["route"]}
            line["block_int8_mv_at_edge_shape"] = k_t
            del bq, scale, xq
        emit(line)
        del net, nets, tgt_d
        torch.cuda.empty_cache()
    return [kernel_entry]


def gc_circuit(device, coupling=None, seed: int = 2):
    """examples/multi_population_training.py's circuit at its own sizes (the
    student's seed 2, the teacher's 1): inp (3) -> a QIF population of 200
    -> a tanh population of 100 -> a tanh readout of 2, a trained inhibitory
    feedback edge, every coupling and edge trained; ``coupling`` the QIF
    population's coupling_dtype."""
    from rectipy_tpu_torch import FeedbackNetwork

    n1, n2 = 200, 100
    rng = np.random.default_rng(0)
    etas, W_in = 3.0 + rng.random(n1), rng.normal(size=(n1, 3))
    r = np.random.default_rng(seed)
    net = FeedbackNetwork(1e-2, device=device)
    net.add_func_node("inp", 3, activation_function="identity")
    net.add_diffeq_node("exc", QIF, weights=np.abs(r.normal(size=(n1, n1))) * (2.0 / n1),
                        input_var="I_ext", output_var="s", source_var="s", target_var="s_in",
                        op="qif_op", spike_var="spike", spike_def="v", spike_threshold=100.0,
                        spike_reset=-100.0, node_vars={"all/qif_op/eta": etas},
                        coupling_dtype=coupling, train_params=["weights"])
    net.add_diffeq_node("inh", TANH, weights=r.normal(size=(n2, n2)) * 0.2,
                        input_var="li_op/I_ext", output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", train_params=["weights"])
    net.add_func_node("out", 2, activation_function="tanh")
    net.add_edge("inp", "exc", weights=W_in)
    net.add_edge("exc", "inh", weights=r.normal(size=(n2, n1)) * 0.5, train="gd")
    net.add_edge("inh", "out", weights=r.normal(size=(2, n2)) * 0.5, train="gd")
    net.add_edge("inh", "exc", weights=r.normal(size=(n1, n2)) * -0.05, feedback=True,
                 train="gd")
    net.compile()
    return net


def gc_heun(device):
    """A Heun tanh population into an Euler one, n = 256 each."""
    from rectipy_tpu_torch import Network

    rng = np.random.default_rng(38)
    net = Network(1e-2, device=device)
    for label, kw in (("p1", {"integrator": "heun"}), ("p2", {})):
        net.add_diffeq_node(label, TANH, weights=rng.normal(size=(256, 256)) * (3.0 / 256 ** 0.5),
                            input_var="li_op/I_ext", output_var="li_op/v",
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            train_params=["weights"], **kw)
    net.add_edge("p1", "p2", weights=rng.normal(size=(256, 256)) * 0.1, train="gd")
    net.compile()
    return net


def gc_feedback(device, coupling=None):
    """Two tanh populations of 256 (``coupling`` p1's coupling_dtype), a
    delayed trained edge p1 -> p2 and a trained feedback edge p2 -> p1."""
    from rectipy_tpu_torch import FeedbackNetwork

    rng = np.random.default_rng(39)
    net = FeedbackNetwork(1e-2, device=device)
    for label, c in (("p1", coupling), ("p2", None)):
        net.add_diffeq_node(label, TANH, weights=rng.normal(size=(256, 256)) * (2.0 / 256 ** 0.5),
                            input_var="li_op/I_ext", output_var="li_op/v",
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            train_params=["weights"], coupling_dtype=c)
    net.add_edge("p1", "p2", weights=rng.normal(size=(256, 256)) * 0.1, train="gd",
                 delays=(np.arange(256) % 5) + 1)
    net.add_edge("p2", "p1", weights=rng.normal(size=(256, 256)) * 0.05, feedback=True,
                 train="gd")
    net.compile()
    return net


def graph_train_check(dev) -> None:
    """Phase 38: the graph trajectory on the card against the CPU and against
    plain autograd on the card, at small sizes: one epoch's loss and
    gradients of examples/multi_population_training.py's circuit (float32
    and int8_master on the QIF population: int8_mv and int8_mv_t once per
    step, asserted), of a Heun population in a graph and of a chunked
    (remat_steps) trajectory; a truncated-BPTT fit of a feedback network and
    a fit_bptt_batch of it at B = 4, card against CPU."""
    from rectipy_tpu_torch.ops.quant import int8_mv, int8_mv_t

    rng = np.random.default_rng(40)
    t_ax = np.arange(GC_T) * 1e-2
    inp3 = np.stack([np.sin(2 * np.pi * 0.7 * t_ax), np.cos(2 * np.pi * 0.3 * t_ax),
                     np.ones(GC_T) * 2.0], axis=1).astype(np.float32)
    cases = {}

    def compare(name, build, inp, tgt, remat=0):
        res = {}
        for where, device, how in (("card", dev, "graph"), ("cpu", "cpu", "graph"),
                                   ("card_autograd", dev, "autograd")):
            net = build(device)
            before = (int8_mv.launches, int8_mv_t.launches)
            t0 = time.perf_counter()
            loss, grads = epoch_loss_and_grads(net, inp, tgt, how, remat if how == "graph" else 0)
            res[where] = (loss, grads, (int8_mv.launches - before[0],
                                        int8_mv_t.launches - before[1]),
                          time.perf_counter() - t0)
        (lc, gc, kc, sc), (lp, gp, _, sp), (la, ga, _, _) = (res["card"], res["cpu"],
                                                             res["card_autograd"])
        g_cpu = {k: rel_norm(gc[k], gp[k]) for k in gp}
        g_plain = {k: rel_norm(gc[k], ga[k]) for k in ga}
        ok = (abs(lc - lp) <= FIT_LOSS_RTOL * abs(lp) and abs(lc - la) <= FIT_LOSS_RTOL * abs(la)
              and all(v <= FIT_GRAD_RTOL for v in g_cpu.values())
              and all(v <= FIT_GRAD_RTOL for v in g_plain.values())
              and all(np.abs(g).max() > 0 for g in gp.values()))
        if not ok:
            raise AssertionError(f"graph_train_check {name}: loss {lc} / cpu {lp} / autograd "
                                 f"{la}, gradients vs cpu {g_cpu}, vs autograd {g_plain}")
        cases[name] = {"loss": lc, "cpu_loss": lp, "autograd_loss": la,
                       "grad_rel_norm_vs_cpu": g_cpu, "grad_rel_norm_vs_autograd": g_plain,
                       "int8_mv_launches": kc[0], "int8_mv_t_launches": kc[1],
                       "card_s": sc, "cpu_s": sp}
        return kc

    tgt3 = gc_circuit("cpu", seed=1).run(inp3, verbose=False).to_numpy("out")
    for coupling in (None, "int8_master"):
        launches = compare(f"circuit_{coupling or 'float32'}",
                           lambda d, c=coupling: gc_circuit(d, c), inp3, tgt3)
        want = (GC_T, GC_T) if coupling else (0, 0)
        if launches != want:
            raise AssertionError(f"graph_train_check circuit {coupling}: int8_mv/int8_mv_t "
                                 f"launches {launches}, want {want}")
    inp = (rng.normal(size=(200, 256)) * 0.5).astype(np.float32)
    tgt = (rng.normal(size=(200, 256)) * 0.1).astype(np.float32)
    compare("heun", gc_heun, inp, tgt)
    compare("remat_50", gc_feedback, inp, tgt, remat=50)

    # a truncated-BPTT fit and a fit_bptt_batch of the feedback network, p1
    # int8_master: int8_mv/int8_mv_t once a step, int8_mm/int8_mm_t once a
    # step of each minibatch's (2, 256) rows
    from rectipy_tpu_torch.ops.quant import int8_mm, int8_mm_t

    fits = {}
    ins_b = (rng.normal(size=(GC_B, 200, 256)) * 0.5).astype(np.float32)
    tgts_b = (rng.normal(size=(GC_B, 200, 256)) * 0.1).astype(np.float32)
    for device in (dev, "cpu"):
        net = gc_feedback(device, "int8_master")
        before = (int8_mv.launches, int8_mv_t.launches)
        obs = net.fit_bptt(inp, tgt, optimizer="adam", lr=1e-3, update_steps=50,
                           verbose=False)
        mv = (int8_mv.launches - before[0], int8_mv_t.launches - before[1])
        kind_s = net.last_fit["trajectory"]
        w_s = net.get_edge("p2", "p1").weights.detach().cpu().numpy()
        net_b = gc_feedback(device, "int8_master")
        before = (int8_mm.launches, int8_mm_t.launches)
        obs_b = net_b.fit_bptt_batch(ins_b, tgts_b, n_epochs=2, batch_size=2, optimizer="adam",
                                     lr=1e-3, seed=0, verbose=False)
        mm = (int8_mm.launches - before[0], int8_mm_t.launches - before[1])
        kind_b = net_b.last_fit["trajectory"]
        if (kind_s, kind_b) != ("graph", "graph"):
            raise AssertionError(f"graph_train_check fits took {kind_s}, {kind_b}")
        if device is dev and (mv != (200, 200) or mm != (800, 800)):
            raise AssertionError(f"graph_train_check fits: int8_mv/int8_mv_t {mv} (want 200 "
                                 f"each), int8_mm/int8_mm_t {mm} (want 800 each)")
        fits[str(device)] = (np.asarray(obs["loss"], dtype=float), w_s,
                             np.asarray(obs_b["train_loss"], dtype=float),
                             net_b.get_edge("p2", "p1").weights.detach().cpu().numpy())
    (ls_c, ws_c, lb_c, wb_c), (ls_p, ws_p, lb_p, wb_p) = fits[str(dev)], fits["cpu"]
    fit_line = {"int8_mv_launches": 200, "int8_mv_t_launches": 200, "int8_mm_launches": 800,
                "int8_mm_t_launches": 800,
                "tbptt_loss_rtol": float(np.abs(ls_c - ls_p).max() / np.abs(ls_p).max()),
                "tbptt_fb_weights_rel_norm": rel_norm(ws_c, ws_p),
                "batch_loss_rtol": float(np.abs(lb_c - lb_p).max() / np.abs(lb_p).max()),
                "batch_fb_weights_rel_norm": rel_norm(wb_c, wb_p),
                "tbptt_losses": ls_c[::50].tolist(), "batch_losses": lb_c.tolist()}
    if not (fit_line["tbptt_loss_rtol"] <= FIT_LOSS_RTOL
            and fit_line["batch_loss_rtol"] <= FIT_LOSS_RTOL
            and fit_line["tbptt_fb_weights_rel_norm"] <= FIT_GRAD_RTOL
            and fit_line["batch_fb_weights_rel_norm"] <= FIT_GRAD_RTOL):
        raise AssertionError(f"graph_train_check fits: {fit_line}")
    emit({"phase": "graph_train_check", "steps": GC_T, "cases": cases, "fits": fit_line,
          "batch_trials": GC_B, "loss_rtol": FIT_LOSS_RTOL, "grad_rtol": FIT_GRAD_RTOL})


# ------------------------------------------------------------ phases 39-41
SPIKE_WINDOW = 100  # the records' window (sampling_steps) of phases 39 and 40
BY_HAND_STEPS = 100  # spikes_inputs_path: the fused kernel stepped by hand
NOISE_SCALE = 50.0  # spikes_inputs_path: the per-neuron noise of the drive
# the pulse into every neuron (spike_drive) of phase 39 and of phase 40: all
# but the tan etas' far tail spike, in volleys that the coupling keeps in
# step; at 30,000 a neuron spikes once or twice in 100 steps of dt 1e-4 (the
# hand-stepped check), at 3,000 a few times in phase 40's 2,000 steps
SPIKE_DRIVE, ES_DRIVE = 30_000.0, 3_000.0
ES_B, ES_T, ES_GENERATIONS = 16, 2_000, 8  # es_path: candidates, steps, generations
ES_SHIFT, ES_SIGMA, ES_LR = 300.0, 100.0, 10_000.0  # the teacher's eta offset, sigma, lr
ES_CPU_N, ES_CPU_T, ES_CPU_GENERATIONS, ES_CPU_B = 256, 200, 3, 8  # es_vs_cpu
ES_CPU_SHIFT, ES_CPU_SIGMA, ES_CPU_LR = 50.0, 20.0, 200.0  # es_vs_cpu's teacher, sigma, lr
# es_vs_cpu: the card's bf16 kernel against the plain step on the CPU (bf16
# products, f32 sums in another order); the records part by ~1e-4 over 200
# steps (test_fused_network_on_card_matches_plain_network_on_cpu), the mse
# losses and, under z-score shaping (no ranks to reorder), the written-back
# eta move with them continuously
ES_LOSS_RTOL, ES_ETA_RTOL = 1e-3, 1e-2
MS_STARTS, MS_EPOCHS = 4, 1  # multistart_path: phase 27's ensemble, 4 starts, 1 epoch
MS_CPU_N, MS_CPU_STARTS = 1_000, 3  # multistart_vs_cpu (CPU_B trials, CPU_T steps, CPU_EPOCHS)
MS_CPU_ETA = 500.0  # multistart_vs_cpu: the etas' centre
# multistart_vs_cpu: the coupling's gain and the starts' init_scale, so that
# the perturbed W move spike times and the starts' losses part by far more
# than MS_LOSS_RTOL (8.4e-4 apart at the least on the CPU); the card's int8
# sums are exact, so card and CPU should part by float32 round-off of the
# loss means alone (1.2e-7 at gain 1)
MS_CPU_GAIN, MS_CPU_INIT_SCALE, MS_LOSS_RTOL = 300.0, 2.0, 1e-6
ES_CPU_ETA = 3e4  # es_vs_cpu: the etas' centre (a spike within ES_CPU_T steps of dt 1e-4)


def spike_net(W_np, etas, device=None, coupling: str = "bfloat16", fused: bool = True):
    """Phase 4's population (qif_sfa, its coupling, etas, alpha 0.05 and k
    15, the fused QIF step) without the tanh input node: the drive enters
    I_ext of every neuron, so a spec of N channels gives each its own noise."""
    from rectipy_tpu_torch import Network, attach_fused_qif_step

    net = Network(DT, device=device)
    net.add_diffeq_node("qif", QIF_SFA, weights=W_np, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
                        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                                   "all/qif_sfa_op/k": 15.0},
                        coupling_dtype=coupling)
    net.compile()
    if fused:
        attach_fused_qif_step(net.get_node("qif"))
    return net


def spec_statistics(dev) -> dict:
    """Phase 39 (d): Noise, Wiener and Poisson specs materialized on the card,
    held to the bounds of tests/test_torch_inputs.py."""
    from rectipy_tpu_torch.inputs import Noise, Poisson, Wiener

    z = Noise(4000, channels=8, seed=2).materialize(1e-3, torch.float64, device=dev).cpu()
    sigma, drift = 0.5, 0.2
    w = Wiener(2000, channels=16, sigma=sigma, drift=drift, seed=11).materialize(
        1e-3, torch.float64, device=dev).cpu().numpy()
    paths = Wiener(1000, channels=2048, sigma=sigma, seed=3).materialize(
        1e-3, torch.float64, device=dev).cpu().numpy()
    rate, steps = 40.0, 4000
    ev = Poisson(steps, channels=8, rate=rate, seed=2).materialize(
        1e-3, torch.float64, device=dev).cpu().numpy() > 0
    emp = ev.mean(axis=0) / 1e-3
    stats = {"noise_mean": float(z.mean()), "noise_std": float(z.std()),
             "wiener_std_over_expected": float(w.std() / (sigma / np.sqrt(1e-3))),
             "wiener_mean": float(w.mean()),
             "wiener_integral_var_over_sigma2T": float((paths.sum(axis=0) * 1e-3).var()
                                                       / sigma**2),
             "poisson_rate": [float(r) for r in emp], "poisson_rate_expected": rate}
    ok = (abs(stats["noise_mean"]) < 0.05 and abs(stats["noise_std"] - 1.0) < 0.05
          and abs(stats["wiener_std_over_expected"] - 1.0) < 0.05
          and abs(stats["wiener_mean"] - drift) < 5 * w.std() / np.sqrt(w.size)
          and abs(stats["wiener_integral_var_over_sigma2T"] - 1.0) < 0.15
          and np.all(np.abs(emp - rate) < 5 * np.sqrt(rate / (steps * 1e-3))))
    if not ok:
        raise AssertionError(f"spec statistics on the card out of bounds: {stats}")
    return stats


def spikes_inputs_phase(dev, W_np, etas, timing: dict) -> dict:
    """Phase 39: record_spikes and an on-device spec on phase 4's population
    at N = 10,000 (bf16 W, the fused QIF step): (a) the spec-driven run
    against the run fed its card materialize, bit for bit; (b) the reader
    against the kernel's own reset over BY_HAND_STEPS steps stepped by hand;
    (c) ms/step with and without record_spikes, spec and array, in turns;
    (d) the noise specs' statistics on the card.  Returns the kernels-line
    entry (phase 6's timing of the same single-row bf16 kernel, this path's
    launches)."""
    from rectipy_tpu_torch.inputs import Noise
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step

    t0 = time.perf_counter()
    net = spike_net(W_np, etas)
    build_s = time.perf_counter() - t0
    node = net.get_node("qif")
    y0 = node.y.clone()
    spec = spike_drive(STEPS, SPIKE_DRIVE) + Noise(STEPS, channels=N, scale=NOISE_SCALE,
                                                   seed=39)
    dense = spec.materialize(DT, device=dev)
    kw = dict(record_output=False, record_vars=[("qif", "s", True)],
              sampling_steps=SPIKE_WINDOW, verbose=False)

    def run(inputs, spikes: bool):
        net.reset({"qif": y0})
        return net.run(inputs, record_spikes=["qif"] if spikes else None, **kw)

    # (a) the spec against its materialized drive
    qif_sfa_step.launches = 0
    a = run(spec, True)
    torch.cuda.synchronize()
    launches = qif_sfa_step.launches
    if launches != STEPS:
        raise AssertionError(f"spikes_inputs_path: {launches} launches for {STEPS} steps")
    y_end = node.y.clone()
    b = run(dense, True)
    counts = a.to_numpy(("qif", "spikes"))
    same = {"spikes": bool(np.array_equal(counts, b.to_numpy(("qif", "spikes")))),
            "mean_s": bool(np.array_equal(a.to_numpy(("qif", "s")), b.to_numpy(("qif", "s"))))}
    if not all(same.values()) or counts.shape != (STEPS // SPIKE_WINDOW, N):
        raise AssertionError(f"spikes_inputs_path: the spec run differs from the materialized "
                             f"one {same}, counts {counts.shape}")
    spiking = int((counts.sum(axis=0) > 0).sum())
    if counts.dtype != np.int32 or spiking < N // 2:
        raise AssertionError(f"spikes_inputs_path: {spiking} of {N} neurons spiked, or the "
                             f"counts are not int32 ({counts.dtype})")

    # (b) the reader's indicator on each pre-update state against v' ==
    # v_reset of the kernel's step, every neuron, BY_HAND_STEPS steps from
    # the run's final state
    step, reader = node.make_step(), node._make_spike_reader()
    drive = spec.shifted(STEPS).drive(DT, torch.float32, dev)
    y, mismatched, total = y_end, torch.zeros((), device=dev), torch.zeros((), device=dev)
    with torch.no_grad():
        for t in range(BY_HAND_STEPS):
            spikes = reader(y) > 0
            y, _ = step(y, node.args, drive[t])
            mismatched += (spikes != (y[:N] == -1e2)).sum()
            total += spikes.sum()
    mismatched, total = int(mismatched), int(total)
    if mismatched or total < N // 10:
        raise AssertionError(f"spikes_inputs_path: the reader differs from the kernel's reset "
                             f"on {mismatched} neuron-steps ({total} spikes)")

    # (c) ms/step in turns: array or spec, with or without the spike counts
    variants = {"array": (dense, False), "array_spikes": (dense, True),
                "spec_spikes": (spec, True), "spec": (spec, False)}
    order = list(variants) + list(reversed(list(variants)))
    secs = {k: [] for k in variants}
    for k in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*variants[k])
        torch.cuda.synchronize()
        secs[k].append(time.perf_counter() - t0)
    ms = {k: min(v) / STEPS * 1e3 for k, v in secs.items()}
    stats = spec_statistics(dev)
    emit({"phase": "spikes_inputs_path", "n": N, "steps": STEPS, "coupling": "bfloat16",
          "sampling_steps": SPIKE_WINDOW, "build_s": build_s, "kernel_launches": launches,
          "spec": f"Pulse(1 channel, {SPIKE_DRIVE} from T/10 to the end) + Noise(N channels, "
                  f"scale {NOISE_SCALE}, seed 39)",
          "spec_equals_materialized": same, "total_spikes": int(counts.sum()),
          "spiking_neurons": spiking,
          "by_hand_steps": BY_HAND_STEPS, "by_hand_spikes": total,
          "by_hand_mismatched_neuron_steps": mismatched, "run_s_in_turns": secs,
          "ms_per_step": ms, "record_spikes_cost_ms_per_step": {
              "array": ms["array_spikes"] - ms["array"], "spec": ms["spec_spikes"] - ms["spec"]},
          "spec_cost_ms_per_step": {"spikes": ms["spec_spikes"] - ms["array_spikes"],
                                    "no_spikes": ms["spec"] - ms["array"]},
          "materialized_bytes": dense.numel() * dense.element_size(), "spec_statistics": stats,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return {**timing, "name": "qif_sfa_step[spikes_inputs_path]", "launches": launches}


def es_kernel_timing(dev, W) -> tuple:
    """Phase 40: the B-row step at the ES path's shapes (ES_B trials, bf16 W
    on the tensor cores) against its plain version (TOL["reset"]), its ms,
    bound, plain ms and torch.matmul of the same rows."""
    from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step, rows_route

    params = dict(dt=DT, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05, thresh=100.0,
                  v_reset=-100.0)
    v, s, x, eta, inp = rows_state(ES_B, N, "reset", np.random.default_rng(40), dev)
    route = rows_route(W.dtype, N, s.stride(0), W.data_ptr(), s.data_ptr())
    got = qif_sfa_step(v, s, x, W, eta, inp, **params)
    ref = qif_sfa_reference_step(v, s, x, W, eta, inp, **params)
    torch.testing.assert_close(got, torch.stack(ref, dim=-2), rtol=TOL["reset"][0],
                               atol=TOL["reset"][1])
    err = float((got - torch.stack(ref, dim=-2)).abs().max())
    n_bytes = N * N * W.element_size() + ES_B * N * 4 * 5 + ES_B * N * 4 * 3
    n_ops = 2 * ES_B * N * N + 20 * ES_B * N
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_flops(W.dtype)
    ms = cuda_ms(lambda: qif_sfa_step(v, s, x, W, eta, inp, **params), reps=200)
    plain_ms = cuda_ms(lambda: qif_sfa_reference_step(v, s, x, W, eta, inp, **params), reps=20)
    s_w = s.contiguous().to(W.dtype)
    library_ms = cuda_ms(lambda: s_w @ W.T, reps=200)
    entry = {"name": "qif_sfa_step.mma[es_path]", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": TPU_KERNEL, "launches": None, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
    return entry, {"kernel_route": route, "B": ES_B, "bytes": n_bytes, "ops": n_ops,
                   "library_ms_reason": "torch.matmul of the (B, N) s by W^T in bfloat16 "
                                        "(the products alone)",
                   "achieved_bytes_per_s": n_bytes / (ms * 1e-3)}


def spike_drive(T: int, amp: float):
    """Phases 39 and 40: ``amp`` into every neuron from step T // 10 to the
    end (and on past it in a shifted run)."""
    from rectipy_tpu_torch.inputs import Pulse

    return Pulse(T, channels=1, t_on=T // 10, t_off=-1, amp=amp)


def es_inputs(n: int, T: int):
    from rectipy_tpu_torch.inputs import Pulse

    return Pulse(T, channels=1, t_on=T // 4, t_off=3 * T // 4, amp=3.0)


def es_phase(dev, W_np, etas) -> dict:
    """Phase 40: fit_es of the per-neuron eta of phase 4's population (bf16
    W, the fused step) at N = 10,000: ES_B candidates a generation, each
    generation one run_batch of ES_T steps on the tensor cores, scored by
    mse on the spike counts per window against the counts of a run at eta +
    ES_SHIFT; every generation's launches and the final B=1 evaluation
    counted; the last generation's mean loss must fall below the first's;
    the search point's loss is reported beside the starting eta's; then
    es_vs_cpu.  Returns the kernels-line entry."""
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step

    net = spike_net(W_np, etas)
    drive = spike_drive(ES_T, ES_DRIVE)

    def spike_counts(eta):
        rec = net.run_batch(drive, sampling_steps=SPIKE_WINDOW, record_output=False,
                            record_spikes=["qif"], batch_vars={("qif", "eta"): eta[None]})
        return rec[("qif", "spikes")][0].astype(np.float32)

    targets = spike_counts(etas + ES_SHIFT)
    start_loss = float(np.mean((spike_counts(etas) - targets) ** 2))  # fit_es's "mse"
    calls = []
    run_batch = net._run_batch

    def counted(inputs, sampling_steps, cutoff, verbose, kwargs):
        B = int(np.shape(next(iter(kwargs["batch_vars"].values())))[0])
        qif_sfa_step.launches = qif_sfa_step.mma_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_batch(inputs, sampling_steps, cutoff, verbose, kwargs)
        torch.cuda.synchronize()
        calls.append({"B": B, "s": time.perf_counter() - t0,
                      "launches": qif_sfa_step.launches,
                      "mma_launches": qif_sfa_step.mma_launches})
        return out

    net._run_batch = counted
    y_before = net.get_node("qif").y.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = net.fit_es(drive, targets, fit_vars=[("qif", "eta")], n_generations=ES_GENERATIONS,
                     pop_size=ES_B, sigma=ES_SIGMA, lr=ES_LR, loss="mse",
                     record_spikes=["qif"], objective_key=("qif", "spikes"),
                     sampling_steps=SPIKE_WINDOW, seed=40, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    del net._run_batch
    want = [{"B": ES_B, "launches": ES_T, "mma_launches": ES_T}] * ES_GENERATIONS + [
        {"B": 1, "launches": ES_T, "mma_launches": ES_T}]
    got = [{k: c[k] for k in ("B", "launches", "mma_launches")} for c in calls]
    if got != want:
        raise AssertionError(f"es_path: run_batch calls {got}, expected {want}")
    if not torch.equal(net.get_node("qif").y, y_before):
        raise AssertionError("es_path: fit_es changed the network state")
    eta_fit = net.get_node("qif")["eta"]
    if not torch.equal(net.get_node("qif")._args["__eta_fused__"], eta_fit.float()):
        raise AssertionError("es_path: the kernel's copy of eta was not refreshed")
    mean_loss = [float(v) for v in obs["es_mean_loss"]]
    if not (np.all(np.isfinite(mean_loss)) and np.isfinite(obs["es_final_loss"])):
        raise AssertionError(f"es_path: non-finite losses {mean_loss}")
    search_loss = float(obs["es_search_point_loss"])
    # what the ES updates earned, not a best of 16: at a constant sigma the
    # candidates' mean loss (ES's smoothed objective) falls only if eta moved
    # the right way
    if not mean_loss[-1] < mean_loss[0]:
        raise AssertionError(f"es_path: the generations' mean loss did not fall: {mean_loss}")
    gen_s = [c["s"] for c in calls[:-1]]
    entry, extra = es_kernel_timing(dev, net.get_node("qif")._args["__w_fused__"])
    entry["launches"] = sum(c["mma_launches"] for c in calls)
    emit({"phase": "es_path", "n": N, "pop_size": ES_B, "steps": ES_T,
          "generations": ES_GENERATIONS, "sigma": ES_SIGMA, "lr": ES_LR,
          "teacher_eta_shift": ES_SHIFT, "objective": "mse of the spike counts per window "
          f"({SPIKE_WINDOW} steps)", "target_spikes": int(targets.sum()),
          "run_batch_calls": calls, "fit_s": fit_s, "ms_per_generation": float(
              np.mean(gen_s) * 1e3), "ms_per_generation_each": [g * 1e3 for g in gen_s],
          "final_evaluation_s": calls[-1]["s"],
          "aggregate_candidate_neuron_updates_per_s": ES_B * ES_T * N / float(np.mean(gen_s)),
          "es_mean_loss": mean_loss, "es_best_loss": [float(v) for v in obs["es_best_loss"]],
          "es_final_loss": float(obs["es_final_loss"]), "es_returned": obs["es_returned"],
          "mean_loss_fall": 1.0 - mean_loss[-1] / mean_loss[0],
          "start_loss": start_loss, "es_search_point_loss": search_loss,
          "search_point_gain": 1.0 - search_loss / start_loss,
          "spiking_target_neurons": int((targets.sum(axis=0) > 0).sum()),
          "eta_update_mean": float((eta_fit.cpu().double() - torch.as_tensor(etas)).mean()),
          "eta_update_abs_max": float((eta_fit.cpu().double()
                                       - torch.as_tensor(etas)).abs().max()),
          "mma_launches": entry["launches"],
          "kernel_timing": {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                   "max_abs_err")}, **extra,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    es_vs_cpu()
    return entry


def es_vs_cpu() -> None:
    """Phase 40, continued: the same fit at ES_CPU_N neurons, ES_CPU_T steps
    and ES_CPU_GENERATIONS generations of ES_CPU_B candidates on the card and
    on the CPU, the output objective (mse of s) with z-score shaping: the
    loss traces within ES_LOSS_RTOL, the written-back eta updates within
    ES_ETA_RTOL of the largest."""
    from rectipy_tpu_torch import random_connectivity

    n = ES_CPU_N
    rng = np.random.default_rng(4)
    W = random_connectivity(n, n, 0.1, normalize=True, rng=rng)
    etas = ES_CPU_ETA + rng.normal(size=n) * 2e3
    drive = es_inputs(n, ES_CPU_T).materialize(DT, device="cpu").numpy()
    targets = spike_net(W, etas + ES_CPU_SHIFT, device="cpu").run(
        drive, verbose=False).to_numpy("out")
    res = {}
    for device in (None, "cpu"):
        net = spike_net(W, etas, device=device)
        t0 = time.perf_counter()
        obs = net.fit_es(drive, targets, fit_vars=[("qif", "eta")],
                         n_generations=ES_CPU_GENERATIONS, pop_size=ES_CPU_B,
                         sigma=ES_CPU_SIGMA, lr=ES_CPU_LR, rank_shaping=False, seed=41,
                         verbose=False)
        res[device or "card"] = (np.asarray(obs["es_mean_loss"]), obs["es_returned"],
                                 net.get_node("qif")["eta"].cpu().double().numpy() - etas,
                                 time.perf_counter() - t0)
    (l_card, r_card, d_card, s_card), (l_cpu, r_cpu, d_cpu, s_cpu) = res["card"], res["cpu"]
    loss_rel = float(np.max(np.abs(l_card - l_cpu) / np.abs(l_cpu)))
    eta_rel = float(np.abs(d_card - d_cpu).max() / np.abs(d_cpu).max())
    if loss_rel > ES_LOSS_RTOL or eta_rel > ES_ETA_RTOL or r_card != r_cpu:
        raise AssertionError(f"es_vs_cpu: loss rel {loss_rel}, eta rel {eta_rel}, returned "
                             f"{r_card} / {r_cpu}")
    emit({"phase": "es_vs_cpu", "n": n, "steps": ES_CPU_T, "pop_size": ES_CPU_B,
          "generations": ES_CPU_GENERATIONS, "losses_card": [float(x) for x in l_card],
          "losses_cpu": [float(x) for x in l_cpu], "max_rel_loss_diff": loss_rel,
          "loss_rtol": ES_LOSS_RTOL, "eta_update_rel_diff": eta_rel, "eta_rtol": ES_ETA_RTOL,
          "es_returned": r_card, "card_s": s_card, "cpu_s": s_cpu})


def multistart_phase(dev, data, trials, by_name: dict) -> list:
    """Phase 41: fit_bptt_multistart of phase 27's ensemble (bench.py's
    network, int8_master, adam lr 1e-4, phase 27's B_TRAIN trial arrays)
    with MS_STARTS starts for MS_EPOCHS epochs, in turns with a
    fit_bptt_batch epoch of one start: int8_mm and int8_mm_t launches of the
    multistart fit, all on the tensor cores; ms per epoch (the starts' draws,
    timed by a fit of 0 epochs, taken out) and peak memory; then
    multistart_vs_cpu.  Returns the kernels-line
    entries (phase 28's timings of the same (B_TRAIN, N) shapes, this
    path's launches)."""
    from rectipy_tpu_torch.ops.quant import int8_mm, int8_mm_t

    W_np, etas = data[0], data[1]
    ins_d, tgt_d = (torch.as_tensor(a, device=dev) for a in trials)
    net = build_train_net(W_np, etas)
    net.fit_bptt_batch(ins_d, tgt_d, n_epochs=1, optimizer="adam", lr=LR, verbose=False)  # warm
    turns, launches = [], None
    # multistart_setup: a fit of 0 epochs, the starts' draws alone (the JAX
    # package's numpy draws of MS_STARTS - 1 perturbations of the 10^8 weights)
    for kind, epochs in (("batch", 1), ("multistart", MS_EPOCHS), ("multistart_setup", 0),
                         ("batch", 1)):
        for k in (int8_mm, int8_mm_t):
            k.launches = k.mma_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if kind == "batch":
            obs = net.fit_bptt_batch(ins_d, tgt_d, n_epochs=1, optimizer="adam", lr=LR,
                                     verbose=False)
        else:
            obs = net.fit_bptt_multistart(ins_d, tgt_d, n_starts=MS_STARTS, n_epochs=epochs,
                                          optimizer="adam", lr=LR, seed=41, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"int8_mm": int8_mm.launches, "int8_mm_t": int8_mm_t.launches,
                  "int8_mm_tensor_core": int8_mm.mma_launches,
                  "int8_mm_t_tensor_core": int8_mm_t.mma_launches}
        turns.append({"fit": kind, "epochs": epochs, "s": seconds, "launches": counts,
                      "epoch_loss": [float(x) for x in obs["epoch_loss"]],
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        if kind == "multistart":
            launches, ms_obs = counts, obs
    want = MS_STARTS * MS_EPOCHS * T_TRAIN
    if set(launches.values()) != {want}:
        raise AssertionError(f"multistart_path: launches {launches}, expected {want} of each, "
                             f"all on the tensor cores")
    final = np.asarray(ms_obs["start_final_loss"])
    if not np.all(np.isfinite(final)) or net.last_fit["trajectory"] != "chain":
        raise AssertionError(f"multistart_path: final losses {final}, {net.last_fit}")
    batch_ms = np.mean([t["s"] for t in turns if t["fit"] == "batch"]) * 1e3
    setup_s = turns[2]["s"]
    ms_epoch = (turns[1]["s"] - setup_s) / MS_EPOCHS * 1e3  # the draws taken out
    emit({"phase": "multistart_path", "n": N, "T": T_TRAIN, "B": B_TRAIN, "starts": MS_STARTS,
          "epochs": MS_EPOCHS, "coupling": "int8_master", "optimizer": "adam", "lr": LR,
          "turns": turns, "start_draws_s": setup_s, "fit_s": turns[1]["s"],
          "ms_per_epoch": ms_epoch, "batch_epoch_ms_in_turns": batch_ms,
          "ratio_to_batch_epoch": ms_epoch / batch_ms,
          "peak_memory_bytes": turns[1]["max_memory_allocated_bytes"],
          "peak_memory_over_batch_fit_bytes": turns[1]["max_memory_allocated_bytes"]
          - max(t["max_memory_allocated_bytes"] for t in turns if t["fit"] == "batch"),
          "start_final_loss": [float(x) for x in final],
          "best_start": int(ms_obs["best_start"][0]), "launches_per_fit": launches,
          "aggregate_trained_neuron_updates_per_s": MS_STARTS * B_TRAIN * T_TRAIN * N
          / (ms_epoch * 1e-3)})
    del ins_d, tgt_d, net
    torch.cuda.empty_cache()
    multistart_vs_cpu()
    return [{**by_name[name], "name": f"{name}[multistart_path]", "launches": launches[name]}
            for name in ("int8_mm", "int8_mm_t")]


def multistart_vs_cpu() -> None:
    """Phase 41, continued: fit_bptt_multistart of MS_CPU_STARTS starts at
    MS_CPU_N neurons, CPU_B trials, CPU_T steps and CPU_EPOCHS epochs on the
    card and on the CPU: per-start losses within MS_LOSS_RTOL and the same
    best start, where the CPU's starts part by more than 100 times that."""
    rng = np.random.default_rng(41)
    n = MS_CPU_N
    Wc = (rng.random((n, n)) < 0.1) * (MS_CPU_GAIN / (0.1 * n))
    # the tan etas raised by MS_CPU_ETA, so that most neurons spike within
    # CPU_T steps and the starts' losses part
    etas_c = MS_CPU_ETA + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    ins_c, tgt_c = batch_train_data(n, CPU_B, CPU_T, 42)
    res = {}
    for device in (None, "cpu"):
        net = build_train_net(Wc, etas_c, device=device)
        t0 = time.perf_counter()
        obs = net.fit_bptt_multistart(ins_c, tgt_c, n_starts=MS_CPU_STARTS, n_epochs=CPU_EPOCHS,
                                      optimizer="adam", lr=LR, seed=43,
                                      init_scale=MS_CPU_INIT_SCALE, verbose=False)
        res[device or "card"] = (np.asarray(obs["start_epoch_loss"]),
                                 int(obs["best_start"][0]), time.perf_counter() - t0)
    (l_card, b_card, s_card), (l_cpu, b_cpu, s_cpu) = res["card"], res["cpu"]
    loss_rel = float(np.max(np.abs(l_card - l_cpu) / np.abs(l_cpu)))
    # the comparison's power: every two starts part by 100 tolerances on the CPU
    final = np.sort(l_cpu[-1])
    parting = float(np.min(np.diff(final)) / final[0])
    if parting <= 100 * MS_LOSS_RTOL:
        raise AssertionError(f"multistart_vs_cpu: the CPU's starts part by {parting} only")
    if loss_rel > MS_LOSS_RTOL or b_card != b_cpu:
        raise AssertionError(f"multistart_vs_cpu: loss rel {loss_rel}, best start "
                             f"{b_card} / {b_cpu}")
    emit({"phase": "multistart_vs_cpu", "n": n, "B": CPU_B, "T": CPU_T, "epochs": CPU_EPOCHS,
          "starts": MS_CPU_STARTS, "start_epoch_loss_card": l_card.tolist(),
          "start_epoch_loss_cpu": l_cpu.tolist(), "max_rel_loss_diff": loss_rel,
          "loss_rtol": MS_LOSS_RTOL, "coupling_gain": MS_CPU_GAIN,
          "init_scale": MS_CPU_INIT_SCALE,
          "cpu_starts_min_rel_parting": parting, "best_start_card": b_card,
          "best_start_cpu": b_cpu,
          "card_s": s_card, "cpu_s": s_cpu})


# the plastic networks of phases 42-43: benchmarks/stdp_scale.py's dense cell
# and examples/stdp_100k_blocks.py's block network, both uncut in width
STDP_N, STDP_T, STDP_HOMEO = 10_000, 2_000, 500
STDP_WARM_T = 500  # the first fit of each network (one scaling period)
STDP_ROW_T = 1_000  # the fits on route "row", timed in turns with the default route
STDP_PLAIN_T = 500  # stdp_path's plain update: a quarter of the depth (about 7x the step)
BSTDP_N, BSTDP_BS, BSTDP_FAN = 100_352, 512, 1_000
BSTDP_PLAIN_T = 250  # block_stdp_path's plain update, two calls: one scaling period
STDP_PROFILE_T = 200  # the profiled window of the idle share
STDP_SOURCE = "rectipy_tpu_torch/csrc/stdp_update.cu"
STDP_REPLACES = "port-only (the XLA-fused update of rectipy_tpu/edges.py:957-1000)"
STDP_CHECK_T = 100  # plasticity_check: the fits held card against CPU, float64
STDP_CHECK_TOL = 1e-10  # their weights' rtol (the projection's float64 sums in another order)
EPROP_RL_N, EPROP_RL_T, EPROP_RL_TOL = 200, 2_000, 1e-9  # the RL example, card against CPU


def stdp_scale_net(n: int, device=None, blocks=None, soft: bool = True, w0=None, **edge_kw):
    """benchmarks/stdp_scale.py's network: a QIF FeedbackNetwork of n
    neurons (the tan etas, dt 1e-4) whose only coupling is the plastic
    self-edge, U(0, 15/n) dense float32 weights drawn from default_rng(7)
    (or ``blocks``, a BlockSparseCoupling of fan-in BSTDP_FAN), tau_+ = tau_-
    = 10 dt, a_+ 1e-3/scale, a_- 1.2e-3/scale, w in [0, 30/scale], scale =
    n (blocks: the fan-in); ``w0``: those dense weights, drawn once by the
    caller."""
    from rectipy_tpu_torch import FeedbackNetwork

    net = FeedbackNetwork(DT, device=device)
    net.add_diffeq_node("qif", QIF, weights=None, n=n, input_var="I_ext", output_var="s",
                        spike_var="spike", reset_var="v", spike_threshold=1e2,
                        spike_reset=-1e2, node_vars={"all/qif_op/eta": tan_etas(n)})
    if blocks is None:
        w0 = stdp_weights(n) if w0 is None else w0
        scale = n
    else:
        w0, scale = blocks, BSTDP_FAN
    net.add_edge("qif", "qif", feedback=True, train="stdp", weights=w0, tau_plus=10 * DT,
                 tau_minus=10 * DT, a_plus=1e-3 / scale, a_minus=1.2e-3 / scale, w_min=0.0,
                 w_max=30.0 / scale, soft_bounds=soft, **edge_kw)
    return net


def stdp_weights(n: int) -> np.ndarray:
    """stdp_scale.py's dense weights, U(0, 15/n) from default_rng(7)."""
    return np.random.default_rng(7).uniform(0.0, 15.0 / n, size=(n, n)).astype(np.float32)


class plain_stdp_update:
    """Within the block, the edges' updates take ops/stdp's plain version
    on the card (the plain update timed in turns with the kernel)."""

    def __enter__(self):
        from rectipy_tpu_torch.ops import stdp

        self._mod, self._kernel = stdp, stdp.stdp_update
        stdp.stdp_update = stdp.stdp_update_plain

    def __exit__(self, *exc):
        self._mod.stdp_update = self._kernel


class row_stdp_route:
    """Within the block, the kernel takes route "row" (the first design) where
    it would take "tile": the fits timed in turns with the default route."""

    def __enter__(self):
        from rectipy_tpu_torch.ops import stdp

        self._mod, self._route = stdp, stdp.stdp_update_route
        stdp.stdp_update_route = lambda *args: "row"

    def __exit__(self, *exc):
        self._mod.stdp_update_route = self._route


def stdp_drive(steps: int, offset: int = 0):
    """stdp_scale.py's drive: Poisson(steps, 1, rate 50, amp 10, seed 1),
    made on the device, shifted by ``offset`` global steps."""
    from rectipy_tpu_torch.inputs import Poisson

    return Poisson(steps, channels=1, rate=50.0, amp=10.0, seed=1).shifted(offset)


def fit_turn(net, steps: int, offset: int, how: str = "kernel", **kw) -> tuple:
    """One timed fit_stdp of ``steps`` steps, ``how`` "kernel" (the default
    route), "row" (route "row" forced) or "plain" (the plain update):
    (seconds, kernel launches, launches of route "tile", observer); the
    counts start at 0 just before the fit."""
    from rectipy_tpu_torch.ops.stdp import stdp_update

    stdp_update.launches = stdp_update.tile_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with {"kernel": contextlib.nullcontext, "row": row_stdp_route,
          "plain": plain_stdp_update}[how]():
        obs = net.fit_stdp(stdp_drive(steps, offset), sampling_steps=steps // 4, verbose=False,
                           **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, stdp_update.launches, stdp_update.tile_launches, obs


def check_fit_launches(name: str, how: str, steps: int, launches: int, tiles: int) -> None:
    """One kernel launch a step (none for the plain update), every one on
    the route the wrapper picks ("tile" at the paths' shapes) unless "row"
    was forced."""
    want = (0, 0) if how == "plain" else (steps, 0 if how == "row" else steps)
    if (launches, tiles) != want:
        raise AssertionError(f"{name} ({how}): {launches} kernel launches, {tiles} of route "
                             f"'tile', for {steps} steps")


def check_plastic_weights(name: str, edge) -> dict:
    W = edge.params["weights"]
    lo, hi = float(W.min()), float(W.max())
    if not (bool(torch.isfinite(W).all()) and lo >= edge.w_min and hi <= edge.w_max):
        raise AssertionError(f"{name}: the weights left [{edge.w_min}, {edge.w_max}] or are "
                             f"not finite ({lo}, {hi})")
    return {"w_min": lo, "w_max": hi, "w_mean": float(W.double().mean())}


@functools.lru_cache(maxsize=None)
def stdp_sass_per_entry() -> dict:
    """SASS instructions an entry of route "tile"'s main loop, by "dtype,mode,
    layout" (mode hard, soft or reward): the longest backward branch's body
    in ``cuobjdump -sass`` of the built library, over the TILE_UNROLL rows
    of 16 bytes it updates; None without cuobjdump."""
    from rectipy_tpu_torch.ops._build import build
    from rectipy_tpu_torch.ops.stdp import TILE_UNROLL

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", build("stdp_update").path], capture_output=True,
                          text=True, timeout=120).stdout
    types = {"f": ("float32", 4), "d": ("float64", 2), "13__nv_bfloat16": ("bfloat16", 8)}
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"stdp_update_tile_kernelI(\w+?)Li(\d)ELb(\d)", fn.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        loop = max((i - at[int(b, 16)] + 1 for i, (a, t) in enumerate(ins)
                    for b in re.findall(r"BRA (0x[0-9a-f]+)", t)
                    if int(b, 16) <= a and int(b, 16) in at), default=0)
        dtype, vec = types[m.group(1)]
        mode = ("hard", "soft", "reward")[int(m.group(2))]
        out[f"{dtype},{mode},{'blocks' if m.group(3) == '1' else 'dense'}"] = \
            loop / (TILE_UNROLL * vec)
    return out


def stdp_kernel_timing(name: str, edge, mode: str, launches: int, sass) -> dict:
    """The kernel at the edge's shape and type, on the edge's weights and
    traces with 30% spikes (reward: its eligibility and r = 1): both routes
    first held to the plain version bit for bit, then timed in turns (row,
    tile, tile, row), against the byte bound (W, and E, read once and
    written once; the four vectors once) and the plain version's ms.  The
    route the wrapper picks here must be "tile" and must have won.  There
    is no single PyTorch call for the update: the library yardstick is
    null."""
    from rectipy_tpu_torch.ops.stdp import stdp_update, stdp_update_plain, stdp_update_route

    W = edge.params["weights"]
    gen = torch.Generator(device=W.device).manual_seed(42)
    spk_pre = (torch.rand(edge.n_in, generator=gen, device=W.device) < 0.3).to(W.dtype)
    spk_post = (torch.rand(edge.n_out, generator=gen, device=W.device) < 0.3).to(W.dtype)
    x_pre = edge.params["x_pre"] + spk_pre
    x_post = edge.params["x_post"] + spk_post
    E = r = None
    c = edge._consts(0.99 if mode == "reward" else 0.0)
    if mode == "reward":
        E = edge.params.get("elig", torch.zeros_like(W))
        r = torch.ones((), dtype=W.dtype, device=W.device)
    args = (W, x_pre, x_post, spk_pre, spk_post, c, mode == "soft", edge._cols, E, r)
    picked = stdp_update_route(W.dtype, W.shape[-1], [t.data_ptr() for t in (
        W, x_pre, spk_pre, E) if t is not None])
    before = stdp_update.launches, stdp_update.tile_launches
    ref = stdp_update_plain(*args)
    for route in ("row", "tile"):
        got = stdp_update(*args, route=route)
        for a, b in zip(got, ref):
            if b is not None and not torch.equal(a, b):
                raise AssertionError(f"{name}: route {route!r} differs from the plain version "
                                     f"on {int((a != b).sum())} entries")
    del got, ref
    ms = {"row": [], "tile": []}
    for route in ("row", "tile", "tile", "row"):
        ms[route].append(cuda_ms(lambda: stdp_update(*args, route=route), reps=50))
    plain_ms = cuda_ms(lambda: stdp_update_plain(*args), reps=5)
    # the checks' and timings' launches are no launches of the path
    stdp_update.launches, stdp_update.tile_launches = before
    best = {k: min(v) for k, v in ms.items()}
    if picked != "tile" or best["tile"] >= best["row"]:
        raise AssertionError(f"{name}: the wrapper picks {picked!r}; in turns {ms}")
    rw = 2 if E is None else 4  # W (and E) read and written
    n_bytes = rw * W.numel() * W.element_size() + 2 * (edge.n_in + edge.n_out) * W.element_size()
    n_ops = (8 if mode != "hard" else 6) * W.numel()
    bound_ms, bound_by = block_bound(n_bytes, n_ops, F64_FLOPS if W.dtype == torch.float64
                                     else F32_FLOPS)
    layout = "blocks" if edge._cols is not None else "dense"
    key = f"{str(W.dtype).split('.')[1]},{mode},{layout}"
    return {"name": name, "route": "cuda", "source": STDP_SOURCE, "replaces": STDP_REPLACES,
            "launches": launches, "max_abs_err": 0.0, "ms": best["tile"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "none: no single PyTorch call computes the pair update",
            "kernel_route": picked, "row_ms": best["row"], "ms_in_turns": ms,
            "row_share_of_bound": bound_ms / best["row"],
            "tile_over_row": best["row"] / best["tile"],
            "sass_per_entry": None if sass is None else sass.get(key),
            "bytes": n_bytes, "share_of_bound": bound_ms / best["tile"],
            "achieved_bytes_per_s": n_bytes / (best["tile"] * 1e-3)}


def stdp_idle_share(net, steps: int, ms_per_step: float, **kw) -> dict:
    """The device's busy ms per step of a STDP_PROFILE_T-step fit under
    torch.profiler against the timed runs' wall ms per step."""
    busy_ms, top = profile_device_time(
        lambda: net.fit_stdp(stdp_drive(STDP_PROFILE_T, steps), sampling_steps=STDP_PROFILE_T,
                             verbose=False, **kw))
    if busy_ms is None:
        return {"device_idle_share": None, "reason": top}
    per_step = busy_ms / STDP_PROFILE_T
    return {"device_busy_ms_per_step": per_step, "device_idle_share": 1.0 - per_step / ms_per_step,
            "top_device_ops": top[:6]}


def stdp_phase(dev) -> list:
    """Phase 42: benchmarks/stdp_scale.py's dense cell (N = 10,000, soft
    bounds, the plastic float32 self-edge the only coupling, the Poisson
    drive) through Network.fit_stdp over STDP_T steps: one warm fit, then in
    turns the kernel route (best of 3), the kernel on route "row" (best of
    2), the plain update (STDP_PLAIN_T steps, best of 2), w_dtype=bfloat16,
    reward mode with r = 1 (hard bounds), and homeostasis_steps=STDP_HOMEO
    (the aligned, segmented path), each best of 2; one kernel launch a step
    asserted for every kernel-route fit, each on route "tile" unless "row"
    was forced, none for the plain ones; ms/step, nu/s, the weights finite
    and in bounds, the kernel's ms on both routes against its bound, the
    idle share, peak memory.  Returns the kernels-line entries."""
    t0 = time.perf_counter()
    variants = {"kernel": ({}, {}), "bfloat16": ({"w_dtype": "bfloat16"}, {}),
                "reward": ({}, {"reward": np.ones(STDP_T)}),
                "homeostasis": ({}, {"homeostasis_steps": STDP_HOMEO})}
    nets = {k: stdp_scale_net(STDP_N, soft=k != "reward", **ekw)
            for k, (ekw, _) in variants.items()}
    build_s = time.perf_counter() - t0
    offsets = dict.fromkeys(nets, 0)

    def turn(k, how="kernel", steps=None):
        steps = steps or {"plain": STDP_PLAIN_T, "row": STDP_ROW_T}.get(how, STDP_T)
        fkw = variants[k][1]
        if "reward" in fkw:
            fkw = {"reward": np.ones(steps)}
        s, launches, tiles, obs = fit_turn(nets[k], steps, offsets[k], how, **fkw)
        offsets[k] += steps
        check_fit_launches(f"stdp_path ({k})", how, steps, launches, tiles)
        return s / steps * 1e3, obs

    warm = {k: turn(k, steps=STDP_WARM_T)[0] for k in nets}  # the first call of each network
    ms = {k: [] for k in list(nets) + ["row", "plain"]}
    torch.cuda.reset_peak_memory_stats()
    for k in ("kernel", "row", "plain", "bfloat16", "reward", "homeostasis", "homeostasis",
              "reward", "bfloat16", "plain", "row", "kernel", "kernel"):
        ms[k].append(turn("kernel", k)[0] if k in ("row", "plain") else turn(k)[0])
    peak = torch.cuda.max_memory_allocated()
    best = {k: min(v) for k, v in ms.items()}
    weights = {k: check_plastic_weights(f"stdp_path ({k})", net.get_edge("qif", "qif"))
               for k, net in nets.items()}
    edge = nets["kernel"].get_edge("qif", "qif")
    idle = stdp_idle_share(nets["kernel"], offsets["kernel"], best["kernel"])
    sass = stdp_sass_per_entry()
    entries = [stdp_kernel_timing("stdp_update[float32,dense]", edge, "soft", STDP_T, sass),
               stdp_kernel_timing("stdp_update[bfloat16,dense]",
                                  nets["bfloat16"].get_edge("qif", "qif"), "soft", STDP_T, sass),
               stdp_kernel_timing("stdp_update[float32,reward,dense]",
                                  nets["reward"].get_edge("qif", "qif"), "reward", STDP_T, sass)]
    emit({"phase": "stdp_path", "n": STDP_N, "steps": STDP_T, "plain_steps": STDP_PLAIN_T,
          "dt": DT, "drive": "Poisson(1 channel, rate 50, amp 10, seed 1)",
          "build_s": build_s, "warm_ms_per_step": warm, "ms_per_step_in_turns": ms,
          "ms_per_step": best,
          "neuron_updates_per_s": {k: STDP_N / (v * 1e-3) for k, v in best.items()},
          "plain_over_kernel": best["plain"] / best["kernel"],
          "row_over_kernel": best["row"] / best["kernel"],
          "kernel_launches_per_fit": STDP_T, "tile_launches_per_fit": STDP_T, "weights": weights,
          "kernel_ms": {e["name"]: e["ms"] for e in entries},
          "kernel_row_ms": {e["name"]: e["row_ms"] for e in entries},
          "kernel_bound_ms": {e["name"]: e["bound_ms"] for e in entries},
          "sass_per_entry": sass,
          "kernel_share_of_step": entries[0]["ms"] / best["kernel"], **idle,
          "max_memory_allocated_bytes": peak})
    del nets, edge
    torch.cuda.empty_cache()
    return entries


def block_stdp_phase(dev) -> list:
    """Phase 43: examples/stdp_100k_blocks.py's network (N = 100,352, bs
    512, fan-in 1,000 from the native sampler, seed 7, the blocks scattered
    to U(0, 15/fan-in), hard bounds, homeostasis every STDP_HOMEO steps, the
    Poisson drive): a warm fit of STDP_T steps, then in turns the kernel
    (STDP_T steps, the aligned path), route "row" (STDP_T steps), the plain
    update (two fits of BSTDP_PLAIN_T steps, together one scaling period,
    so the kernel's fits stay aligned), route "row", the kernel; one launch
    a step asserted, each on route "tile" unless "row" was forced; ms/step, nu/s,
    the block tensor's bytes, the row masses pinned at a scaling step, the
    kernel against its bound, the idle share, peak memory."""
    from rectipy_tpu_torch.ops.sparse import block_random_connectivity

    t0 = time.perf_counter()
    A = block_random_connectivity(BSTDP_N, BSTDP_N, BSTDP_FAN, block_size=BSTDP_BS, seed=7)
    backend = block_random_connectivity.last_backend
    A.blocks *= np.random.default_rng(7).random(A.blocks.shape, dtype=np.float32) * 15.0
    sample_s = time.perf_counter() - t0
    if backend != "native":
        raise AssertionError(f"block_stdp_path: the sampler took {backend}, not native")
    t0 = time.perf_counter()
    net = stdp_scale_net(BSTDP_N, blocks=A, soft=False)
    del A
    build_s = time.perf_counter() - t0
    edge = net.get_edge("qif", "qif")
    mass0 = edge.params["weights"].sum(dim=(1, 3)).reshape(-1).clone()
    kw = {"homeostasis_steps": STDP_HOMEO, "record_spikes": ["qif"]}
    offset, ms, spikes = 0, {"kernel": [], "row": [], "plain": []}, 0

    def turn(how="kernel", steps=None):
        nonlocal offset, spikes
        steps = steps or {"plain": BSTDP_PLAIN_T, "row": STDP_ROW_T}.get(how, STDP_T)
        s, launches, tiles, obs = fit_turn(net, steps, offset, how, **kw)
        offset += steps
        check_fit_launches("block_stdp_path", how, steps, launches, tiles)
        spikes += int(obs.to_numpy(("qif", "spikes")).sum())
        return s / steps * 1e3

    warm = turn(steps=STDP_WARM_T)
    mass = edge.params["weights"].sum(dim=(1, 3)).reshape(-1)
    mass_rel = float(((mass - mass0).abs() / mass0.abs().clamp_min(1e-30)).max())
    torch.cuda.reset_peak_memory_stats()
    for k in ("kernel", "row", "plain", "plain", "row", "kernel"):
        ms[k].append(turn(k))
    peak = torch.cuda.max_memory_allocated()
    best = {k: min(v) for k, v in ms.items()}
    weights = check_plastic_weights("block_stdp_path", edge)
    if mass_rel > 1e-3 or spikes == 0:
        raise AssertionError(f"block_stdp_path: row masses moved by {mass_rel} after an aligned "
                             f"scaling step, or no spike ({spikes})")
    W = edge.params["weights"]
    idle = stdp_idle_share(net, offset, best["kernel"], **kw)
    sass = stdp_sass_per_entry()
    entry = stdp_kernel_timing("stdp_update[float32,blocks]", edge, "hard", STDP_T, sass)
    emit({"phase": "block_stdp_path", "n": BSTDP_N, "block_size": BSTDP_BS, "fan_in": BSTDP_FAN,
          "blocks_shape": list(W.shape), "block_tensor_bytes": W.numel() * W.element_size(),
          "steps": STDP_T, "plain_steps": [BSTDP_PLAIN_T, BSTDP_PLAIN_T],
          "homeostasis_steps": STDP_HOMEO, "sampler": backend, "sample_s": sample_s,
          "build_s": build_s, "warm_ms_per_step": warm, "ms_per_step_in_turns": ms,
          "ms_per_step": best,
          "neuron_updates_per_s": {k: BSTDP_N / (v * 1e-3) for k, v in best.items()},
          "plain_over_kernel": best["plain"] / best["kernel"],
          "row_over_kernel": best["row"] / best["kernel"], "kernel_launches_per_fit": STDP_T,
          "tile_launches_per_fit": STDP_T, "spikes": spikes,
          "row_mass_max_rel_change_after_scaling": mass_rel,
          "weights": weights, "kernel_ms": entry["ms"], "kernel_row_ms": entry["row_ms"],
          "kernel_bound_ms": entry["bound_ms"],
          "kernel_share_of_step": entry["ms"] / best["kernel"], **idle,
          "max_memory_allocated_bytes": peak})
    del net, edge, W
    torch.cuda.empty_cache()
    return [entry]


def stdp_check_net(n: int, device, blocks=None):
    """plasticity_check's fits: a float64 QIF FeedbackNetwork (etas 2,000 to
    3,000, a spike every ~60 steps of dt 1e-3) whose only coupling is a
    plastic self-edge, dense U(0, 0.2) or on ``blocks`` ((n_br, cb, bs, bs),
    cols), hard bounds [0, 0.3]."""
    from rectipy_tpu_torch import BlockSparseCoupling, FeedbackNetwork

    rng = np.random.default_rng(80)
    net = FeedbackNetwork(1e-3, device=device, dtype=torch.float64)
    net.add_diffeq_node("qif", QIF, weights=None, n=n, input_var="I_ext", output_var="s",
                        spike_var="spike", reset_var="v", spike_threshold=1e2,
                        spike_reset=-1e2,
                        node_vars={"all/qif_op/eta": rng.uniform(2000.0, 3000.0, n)})
    if blocks is None:
        w = rng.uniform(0.0, 0.2, size=(n, n))
    else:
        w = BlockSparseCoupling(rng.uniform(0.0, 0.2, blocks[0]), blocks[1])
    net.add_edge("qif", "qif", feedback=True, train="stdp", weights=w, tau_plus=2e-2,
                 tau_minus=2e-2, a_plus=5e-3, a_minus=4e-3, w_min=0.0, w_max=0.3)
    return net


def rl_net(device):
    """examples/rl_online_learning.py's network at N = EPROP_RL_N, float64:
    a tanh reservoir (k 0.1, tau U(10, 20), J0 at spectral radius 1, v
    normal) from default_rng(7), its input layer's weights from
    default_rng(8) (the example draws them unseeded), an 'rls' readout."""
    from rectipy_tpu_torch import Network

    n, rng = EPROP_RL_N, np.random.default_rng(7)
    tau = rng.uniform(10.0, 20.0, size=(n,))
    J0 = rng.standard_normal((n, n))
    J0 /= np.max(np.abs(np.linalg.eigvals(J0)))
    net = Network.from_yaml(TANH, weights=J0, dt=1e-2, source_var="tanh_op/r",
                            target_var="li_op/r_in", input_var="li_op/I_ext",
                            output_var="li_op/v", device=device, dtype=torch.float64,
                            node_vars={"all/li_op/k": 0.1, "all/li_op/tau": tau,
                                       "all/li_op/v": rng.standard_normal(n)})
    net.add_input_layer(2, weights=np.random.default_rng(8).standard_normal((n, 2)))
    net.add_output_layer(1, train="rls")
    net.compile()
    return net, rng.standard_normal((2, 1)) * 0.1


def plasticity_check(dev, build_net, timing: dict) -> dict:
    """Phase 44: (a) the stdp_update kernel against its plain version bit
    for bit for every variant, layout and type (testing.STDP_CASES) on
    every route each shape allows, at testing.STDP_CHECK_SHAPES: ragged
    rows (37 x 1,003, 1,004 and 1,000; blocks of 20, 24 and 128 with
    repeated columns) and the paths' row widths (10,000; blocks of 512);
    (b) fit_stdp
    over STDP_CHECK_T steps with reward and homeostasis (every 32 steps:
    the per-step path) on the card and on the CPU at float64, dense N = 256
    and blocks N = 2,048 (bs 128, the native sampler's columns): spike
    counts equal, weights and eligibility within STDP_CHECK_TOL, one launch
    a step; (c) fit_eprop at full width: the FORCE cell's network (rls_path:
    N = 10,000 qif_sfa, bf16, the fused step) with its readout registered
    as train='eprop' (the instantaneous NLMS rule: epsilon = delta = 0, lr
    0.5), STEPS steps, then test(): one
    qif_sfa_step launch a step, ms/step, the test loss over the target's
    variance; (d) examples/rl_online_learning.py's network card against CPU
    over EPROP_RL_T steps, with its feedback weights, normalize off and on
    (records and weights within EPROP_RL_TOL of the largest).  Returns the
    kernels-line entry of the fused step on the eprop path."""
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step
    from rectipy_tpu_torch.ops.sparse import block_random_connectivity
    from rectipy_tpu_torch.ops.stdp import stdp_update
    from rectipy_tpu_torch.testing import (STDP_CASES, STDP_CHECK_SHAPES, check_stdp,
                                           stdp_inputs, stdp_routes)

    # (a) the kernel, bit for bit, on every route each shape allows
    t0 = time.perf_counter()
    cases = {}
    for mode, layout, dtype in STDP_CASES:
        for shape in STDP_CHECK_SHAPES[layout]:
            ops = stdp_inputs(layout, dtype, 44, dev, shape)
            for route in stdp_routes(mode, ops):
                res = check_stdp(mode, ops, route)
                if res["launches"] != 1 or res["tile_launches"] != (route == "tile") \
                        or res["moved"] == 0:
                    raise AssertionError(f"plasticity_check {mode} {layout} {dtype} {shape} "
                                         f"{route}: {res}")
                cases[f"{mode},{layout},{dtype},{'x'.join(map(str, shape))},{route}"] = \
                    res["moved"]
    routes = {r: sum(k.endswith(r) for k in cases) for r in ("row", "tile")}
    emit({"phase": "plasticity_check", "part": "kernel_bit_for_bit", "cases": len(cases),
          "cases_by_route": routes, "entries_moved": cases, "s": time.perf_counter() - t0})

    # (b) fit_stdp, card against CPU
    rng = np.random.default_rng(44)
    A = block_random_connectivity(2048, 2048, 256, block_size=128, seed=44)
    fits = {"dense": (256, None), "blocks": (2048, (A.blocks.shape, A.cols))}
    for name, (n, blocks) in fits.items():
        x = (rng.random((STDP_CHECK_T, n)) < 0.05) * 30.0
        reward = rng.normal(size=STDP_CHECK_T)
        res = {}
        for device in (dev, "cpu"):
            net = stdp_check_net(n, device, blocks)
            stdp_update.launches = 0
            t0 = time.perf_counter()
            obs = net.fit_stdp(x, reward=reward, homeostasis_steps=32, sampling_steps=10,
                               record_spikes=["qif"], verbose=False)
            seconds = time.perf_counter() - t0
            edge = net.get_edge("qif", "qif")
            res[str(device)] = (obs.to_numpy(("qif", "spikes")),
                                edge.params["weights"].cpu().numpy(),
                                edge.params["elig"].cpu().numpy(), stdp_update.launches,
                                seconds)
        card, cpu = res[str(dev)], res["cpu"]
        w_rel = float(np.abs(card[1] - cpu[1]).max() / np.abs(cpu[1]).max())
        e_rel = float(np.abs(card[2] - cpu[2]).max() / np.abs(cpu[2]).max())
        if not (np.array_equal(card[0], cpu[0]) and cpu[0].sum() > 0 and card[3] == STDP_CHECK_T
                and w_rel <= STDP_CHECK_TOL and e_rel <= STDP_CHECK_TOL):
            raise AssertionError(f"plasticity_check {name}: spikes equal "
                                 f"{np.array_equal(card[0], cpu[0])} ({int(cpu[0].sum())}), "
                                 f"launches {card[3]}, W rel {w_rel}, elig rel {e_rel}")
        emit({"phase": "plasticity_check", "part": f"fit_stdp_vs_cpu[{name}]", "n": n,
              "steps": STDP_CHECK_T, "dtype": "float64", "reward": True,
              "homeostasis_steps": 32, "spikes": int(cpu[0].sum()), "spike_counts_equal": True,
              "weights_max_rel_diff": w_rel, "elig_max_rel_diff": e_rel,
              "rtol": STDP_CHECK_TOL, "kernel_launches": card[3], "card_s": card[4],
              "cpu_s": cpu[4]})

    # (c) fit_eprop on the FORCE cell's network, at full width
    inputs = bench_inputs(STEPS)
    target = np.sin(2 * np.pi * 2.0 * DT * np.arange(STEPS))[:, None]
    net = build_net("bfloat16", fused=True)
    net.add_func_node("readout", 1, activation_function="identity")
    edge = net.add_edge("qif", "readout", train="eprop", weights=np.zeros((1, N)))
    net.reset()
    qif_sfa_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = net.fit_eprop(inputs, target, lr=0.5, epsilon=0.0, delta=0.0, normalize=True,
                        sampling_steps=100, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = qif_sfa_step.launches
    losses = obs.to_numpy("loss")
    if launches != STEPS or not (np.all(np.isfinite(losses))
                                 and bool(torch.isfinite(edge.params["weights"]).all())):
        raise AssertionError(f"eprop_path: {launches} qif_sfa_step launches for {STEPS} steps, "
                             f"or non-finite losses or weights")
    net.reset()
    qif_sfa_step.launches = 0
    t0 = time.perf_counter()
    obs_t, test_loss = net.test(inputs, target, sampling_steps=100, verbose=False)
    test_s = time.perf_counter() - t0
    tgt_var = float(np.var(target[::100]))
    emit({"phase": "plasticity_check", "part": "eprop_path", "n": N, "steps": STEPS,
          "coupling": "bfloat16", "normalize": True, "lr": 0.5, "epsilon": 0.0, "delta": 0.0,
          "kernel_launches_fit": launches, "kernel_launches_test": qif_sfa_step.launches,
          "fit_s": fit_s, "ms_per_step": fit_s / STEPS * 1e3,
          "neuron_updates_per_s": STEPS * N / fit_s,
          "fit_loss_first_last": [float(losses[1]), float(losses[-1])], "test_s": test_s,
          "test_loss": test_loss, "target_variance": tgt_var,
          "test_loss_over_target_variance": test_loss / tgt_var,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del net, edge, obs, obs_t
    torch.cuda.empty_cache()

    # (d) the RL example's network, card against CPU
    f1, f2, amp = 0.2, 0.02, 0.9
    t_ax = np.linspace(0, EPROP_RL_T * 1e-2, num=EPROP_RL_T)
    inp = np.stack([np.sin(2 * np.pi * f1 * t_ax) * amp, np.sin(2 * np.pi * f2 * t_ax) * amp], 1)
    tgt = (inp[:, :1] * inp[:, 1:2]) / amp
    for normalize in (False, True):
        res = {}
        for device in (dev, "cpu"):
            net, W_fb = rl_net(device)
            t0 = time.perf_counter()
            o = net.fit_eprop(inp, tgt, update_steps=1, sampling_steps=10, feedback_weights=W_fb,
                              epsilon=0.9, delta=0.5, lr=1e-3, decay=1.0, normalize=normalize,
                              verbose=False)
            res[str(device)] = (o.to_numpy("out"), o.to_numpy("loss"),
                                net.get_edge("rnn", "output_layer").params["weights"].cpu().numpy(),
                                time.perf_counter() - t0)
        rel = {k: float(np.abs(a - b).max() / np.abs(b).max())
               for k, a, b in zip(("out", "loss", "weights"), res[str(dev)], res["cpu"])}
        if max(rel.values()) > EPROP_RL_TOL:
            raise AssertionError(f"eprop_rl_vs_cpu (normalize={normalize}): {rel}")
        emit({"phase": "plasticity_check", "part": f"eprop_rl_vs_cpu[normalize={normalize}]",
              "n": EPROP_RL_N, "steps": EPROP_RL_T, "dtype": "float64",
              "max_rel_diff": rel, "rtol": EPROP_RL_TOL, "card_s": res[str(dev)][3],
              "cpu_s": res["cpu"][3]})
    return {**timing, "name": "qif_sfa_step[bfloat16,eprop_path]", "launches": launches}


# ------------------------------------------- phases 45-47: the tooling slice
SERVE_T = 1_000  # the bf16 bundle's request length
SERVE_INT8_T = 500  # the int8 bundle's (its step takes ~1 ms on the host)
SERVE_REQUESTS = 4  # the fused bf16 bundle's chained requests (4,000 steps)
SERVE_S = 10  # their sampling_steps
SERVE_B, SERVE_B_T, SERVE_B_REQUESTS, SERVE_B_S = 32, 500, 2, 50  # the ensemble bundle
CKPT_T, CKPT_CUT, CKPT_HOMEO = 1_000, 500, 300  # fit_stdp: whole, the cut, the scaling period
LYAP_DRIVE, LYAP_TRANSIENT, LYAP_STEPS, LYAP_RENORM = 3.0, 1_000, 2_000, 100
TANGENT_N, TANGENT_K, TANGENT_G = 2_048, 4, 3.0  # analysis_scale.py's tangent workload
TANGENT_STEPS, TANGENT_TRANSIENT = 5_000, 1_000
# the CPU float64 comparison of the tangent workload: the same call on both
# sides, cut to 600 steps (the CPU takes tens of ms a step at N = 2,048);
# float32 on the card against float64 on the CPU over 6 time units of a
# chaotic flow: each exponent within 2e-3 + 1e-2 |lambda|
TANGENT_CPU_STEPS, TANGENT_CPU_TRANSIENT = 500, 100
TANGENT_TOL = dict(rtol=1e-2, atol=2e-3)
MPR = "rectipy_tpu_torch.models.mean_field.montbrio.mpr"

# the serving process: loads the bundles with rectipy_tpu_torch.serving (the
# op library is imported because meta.json lists operators), refuses to
# build a Network or read a template, answers the chained requests and
# counts the launches; one round of bundles for phase 45, one for phase 48,
# each announced by its ready file and answered by one JSON line
SERVE_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["root"])
import rectipy_tpu_torch.dsl.parser as parser
import rectipy_tpu_torch.dsl.yaml_lite as yaml_lite
import rectipy_tpu_torch.network as network

def refuse(*args, **kwargs):
    raise AssertionError("the serving process built a Network or read a template")

network.Network.__init__ = refuse
parser.load_file = yaml_lite.load_file = refuse
import torch.export.passes
from rectipy_tpu_torch.ops import generic_fused, kernels, quant
from rectipy_tpu_torch.serving import load_network

COUNTERS = {"qif_sfa_step": kernels.qif_sfa_step, "int8_mv": quant.int8_mv,
            "int8_mm": quant.int8_mm, "int4_mv": quant.int4_mv, "int4_mm": quant.int4_mm,
            "block_int8_mv": quant.block_int8_mv,
            "generic_fused_step": generic_fused.generic_fused_step,
            "generic_fused_rows": generic_fused.generic_fused_rows}
torch.cuda.set_device(0)
torch.zeros(1, device="cuda")  # the context, while the bundles are written
for rnd in cfg["rounds"]:
    t0 = time.perf_counter()
    while not os.path.exists(rnd["ready"]):
        if time.perf_counter() - t0 > 900:
            sys.exit("the bundles never came")
        time.sleep(0.05)
    res = {}
    for name, b in rnd["bundles"].items():
        t0 = time.perf_counter()
        model = load_network(b["path"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ins = np.load(b["inputs"])
        for c in COUNTERS.values():
            c.launches = 0
            if hasattr(c, "mma_launches"):
                c.mma_launches = 0
        t0 = time.perf_counter()
        outs = np.stack([model(x) for x in ins])
        serve_s = time.perf_counter() - t0
        np.save(b["out"], outs)
        res[name] = {"load_s": load_s, "serve_s": serve_s, "ops": model.meta["ops"],
                     "generic_keys": sorted(model.meta.get("generic", {})),
                     **{k: c.launches for k, c in COUNTERS.items()},
                     **{k + "_mma": c.mma_launches for k, c in COUNTERS.items()
                        if hasattr(c, "mma_launches")},
                     "finite": bool(np.isfinite(outs).all())}
        del model, outs
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
"""


def bundle_round(tmp: str, tag: str, names) -> dict:
    """The paths of one round of the serving process: its ready file and,
    for each bundle, the bundle, its inputs and the served outputs."""
    return {"ready": os.path.join(tmp, f"ready_{tag}"),
            "bundles": {name: {k: os.path.join(tmp, name + suffix) for k, suffix in
                               (("path", ""), ("inputs", "_in.npy"), ("out", "_out.npy"))}
                        for name in names}}


def child_line(child, err_path: str, what: str) -> dict:
    """A child process's next JSON line (the serving process's answer to one
    round of bundles, a CPU reference); a process that ended raises with
    its errors."""
    line = child.stdout.readline()
    if not line:
        child.wait()
        with open(err_path) as f:
            raise AssertionError(f"{what}: the serving process failed:\n{f.read()}")
    return json.loads(line)


def bundle_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


# the tangent workload on the CPU at float64 (TANGENT_CPU_* steps)
TANGENT_CPU_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
os.nice(10)  # behind the timed host loops of the card's phases
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["root"])
torch.set_num_threads(cfg["threads"])
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.analysis import lyapunov_spectrum
rng = np.random.default_rng(0)
n = cfg["n"]
W = cfg["g"] * rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
y0 = rng.standard_normal(n) * 0.5
net = Network(1e-2, dtype=torch.float64, device="cpu")
net.add_diffeq_node("pop", cfg["tanh"], weights=W, input_var="li_op/I_ext",
                    output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in",
                    node_vars={"all/li_op/tau": 1.0})
t0 = time.perf_counter()
lam = lyapunov_spectrum(net, k=cfg["k"], steps=cfg["steps"], transient=cfg["transient"],
                        y0=y0, seed=0)
print(json.dumps({"lambda": [float(v) for v in lam], "s": time.perf_counter() - t0}))
"""


def tangent_net(dev, dtype=torch.float32):
    """analysis_scale.py's tangent workload: an N = 2,048 tanh rate network,
    W = g N(0, 1)/sqrt(N) (float32 draw) and y0 = N(0, 1)/2 from
    default_rng(0), tau 1, dt 1e-2; returns (net, y0)."""
    from rectipy_tpu_torch import Network

    rng = np.random.default_rng(0)
    W = TANGENT_G * rng.standard_normal((TANGENT_N, TANGENT_N)).astype(np.float32) / np.sqrt(
        TANGENT_N)
    y0 = rng.standard_normal(TANGENT_N) * 0.5
    net = Network(1e-2, dtype=dtype, device=dev)
    net.add_diffeq_node("pop", TANH, weights=W, input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        node_vars={"all/li_op/tau": 1.0})
    return net, y0


def export_warmup() -> float:
    """torch.export's first trace of a toy program (its imports and
    set-up, about 10 s on the card's host), so that phase 45's exports time
    the network's trace alone; seconds."""
    t0 = time.perf_counter()

    class Toy(torch.nn.Module):
        def forward(self, x):
            return x * 2.0 + 1.0

    with torch.no_grad():
        torch.export.export(Toy(), (torch.zeros(4),))
    return time.perf_counter() - t0


def served_windows(per_step: torch.Tensor, s: int) -> torch.Tensor:
    """Window means of per-step outputs ``(..., T, n)`` exactly as a served
    request forms them (``serving.ServedNetwork.__call__``)."""
    axis = per_step.dim() - 2
    T = per_step.shape[axis]
    outs = per_step.contiguous().narrow(axis, 0, (T // s) * s)
    outs = outs.reshape(outs.shape[:axis] + (T // s, s) + outs.shape[axis + 1:])
    return outs.mean(dim=axis + 1)


def serve_turns(model, net, ins, batched: bool, s: int) -> dict:
    """Served against Network.run (run_batch) on the same requests, in turns
    (served, run, run, served): best seconds of each, ms per step."""
    secs = {"served": [], "run": []}
    steps = ins.shape[-2]
    for how in ("served", "run", "run", "served"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "served":
            model(ins)
        elif batched:
            net.run_batch(ins, sampling_steps=s, verbose=False)
        else:
            net.run(ins, sampling_steps=s, verbose=False)
        torch.cuda.synchronize()
        secs[how].append(time.perf_counter() - t0)
    ms = {k: min(v) / steps * 1e3 for k, v in secs.items()}
    return {"served_ms_per_step": ms["served"], "run_ms_per_step": ms["run"],
            "served_over_run": ms["served"] / ms["run"], "turn_s": secs}


def op_registration_turns(dev, n: int = 1_024, calls: int = 2_000) -> dict:
    """The host cost of one call of the QIF step's operator as
    ``ops/library.py`` registers it (``Library.define``/``impl``) and as a
    ``torch.library.custom_op`` twin of it (the same CUDA implementation,
    namespace ``rectipy_smoke``), in turns (library, custom_op, custom_op,
    library): microseconds a call over ``calls`` back-to-back calls at n =
    1,024 (a f32 W of 4 MB: the kernel takes a few microseconds, the host
    the rest), best of each."""
    from rectipy_tpu_torch.ops import kernels, library

    @torch.library.custom_op("rectipy_smoke::qif_sfa_step", mutates_args=(),
                             device_types="cuda")
    def twin(v: torch.Tensor, s: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
             eta: torch.Tensor, inp: torch.Tensor, dt: float, tau: float, tau_s: float,
             tau_x: float, k: float, alpha: float, thresh: float,
             v_reset: float) -> torch.Tensor:
        return kernels.qif_sfa_launch(v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s,
                                      tau_x=tau_x, k=k, alpha=alpha, thresh=thresh,
                                      v_reset=v_reset)

    twin.register_fake(lambda v, *args: v.new_empty((3, v.shape[-1])))
    rng = np.random.default_rng(47)
    W = torch.as_tensor(rng.random((n, n)) * 1e-3, dtype=torch.float32, device=dev)
    vecs = [torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
            for _ in range(5)]
    args = (*vecs[:3], W, *vecs[3:], DT, 1.0, 1.0, 10.0, 15.0, 0.05, 100.0, -100.0)
    ops = {"library": library.qif_sfa_step, "custom_op": twin}
    us = {k: [] for k in ops}
    with torch.no_grad():
        for name in ops:
            ops[name](*args)
        for name in ("library", "custom_op", "custom_op", "library"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                ops[name](*args)
            torch.cuda.synchronize()
            us[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {"n": n, "calls": calls, **{k: min(v) for k, v in us.items()}, "turns": us}


def checkpoint_phase(dev) -> dict:
    """Phase 46: stdp_scale.py's dense cell (phases 42-43's network, N =
    10,000, soft bounds) with homeostasis_steps=CKPT_HOMEO: fit_stdp over
    CKPT_CUT steps of a CKPT_T-step drive (made on the card), save_network,
    restore_network into a fresh network and fit the rest of the same drive;
    the weights, both traces, the homeostasis target and phase and the
    population's state equal those of one uninterrupted CKPT_T-step fit bit
    for bit; f32 and w_dtype=bfloat16.  Returns the stdp_update launches of
    each variant's two fits."""
    from rectipy_tpu_torch.checkpoint import restore_network, save_network
    from rectipy_tpu_torch.ops.stdp import stdp_update

    w0 = stdp_weights(N)
    drive = stdp_drive(CKPT_T).materialize(DT, device=dev)
    kw = dict(sampling_steps=CKPT_CUT // 2, homeostasis_steps=CKPT_HOMEO, verbose=False)
    launches, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for variant, ekw in (("float32", {}), ("bfloat16", {"w_dtype": "bfloat16"})):
            whole = stdp_scale_net(N, dev, w0=w0, **ekw)
            stdp_update.launches = 0
            whole.fit_stdp(drive, **kw)
            first = stdp_scale_net(N, dev, w0=w0, **ekw)
            first.fit_stdp(drive[:CKPT_CUT], **kw)
            path = os.path.join(tmp, variant)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_network(first, path)
            save_s = time.perf_counter() - t0
            del first
            resumed = stdp_scale_net(N, dev, w0=w0, **ekw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_network(resumed, path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            resumed.fit_stdp(drive[CKPT_CUT:], **kw)
            torch.cuda.synchronize()
            launches[variant] = stdp_update.launches
            if launches[variant] != 2 * CKPT_T:
                raise AssertionError(f"checkpoint_path ({variant}): {launches[variant]} "
                                     f"stdp_update launches for two fits of {CKPT_T} steps")
            a, b = whole.get_edge("qif", "qif"), resumed.get_edge("qif", "qif")
            pairs = {k: (a.params[k], b.params[k]) for k in ("weights", "x_pre", "x_post")}
            pairs["homeo_target"] = (a._homeo_target, b._homeo_target)
            pairs["state"] = (whole.get_node("qif").y, resumed.get_node("qif").y)
            equal = {k: bool(x.dtype == y.dtype and torch.equal(x, y)) for k, (x, y) in
                     pairs.items()}
            equal["homeo_phase"] = a._homeo_phase == b._homeo_phase
            equal["no_eligibility"] = "elig" not in b.params
            w = a.params["weights"]
            lines.append({"w_dtype": variant, "save_s": save_s, "restore_s": restore_s,
                          "snapshot_bytes": os.path.getsize(path + ".npz"),
                          "bit_identical": equal, "stdp_update_launches": launches[variant],
                          "w_moved": bool((w.float() != torch.as_tensor(
                              w0, device=dev).to(w.dtype).float()).any())})
            if not all(equal.values()):
                raise AssertionError(f"checkpoint_path ({variant}): the resumed fit parts "
                                     f"from the uninterrupted one: {equal}")
            del whole, resumed, a, b, pairs, w
            torch.cuda.empty_cache()
    emit({"phase": "checkpoint_path", "n": N, "steps": CKPT_T, "cut": CKPT_CUT,
          "homeostasis_steps": CKPT_HOMEO, "variants": lines})
    return launches


def analysis_phase(dev, W_np, etas, cpu_ref: dict) -> int:
    """Phase 47: lyapunov_direct on analysis_scale.py's direct workload (N =
    10,000 qif_sfa, the f32 coupling, drive 3.0; the main path's W) with the
    f32 fused kernel attached and without it, in turns over two seeds
    (kernel, plain, plain, kernel): the kernel's launches must be
    transient + 2 steps; lyapunov_spectrum on the tangent workload (N =
    2,048 tanh, g 3, k 4), the full call timed on the card and the cut call
    held to the CPU's float64 (run during phase 46);
    fixed_point + stability of the bistable MPR node (eta -5, J 15, both
    states) against the same at float64 on the CPU.  ``cpu_ref``: the CPU
    run's exponents and seconds.  Returns the kernel's launches in one fused
    run."""
    from rectipy_tpu_torch import Network, attach_fused_qif_step
    from rectipy_tpu_torch.analysis import (fixed_point, lyapunov_direct, lyapunov_spectrum,
                                            stability)
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step

    def direct_net(fused: bool):
        net = Network(DT, device=dev)
        net.add_diffeq_node(
            "qif", QIF_SFA, weights=W_np, source_var="s", target_var="s_in", input_var="I_ext",
            output_var="s", spike_var="spike", spike_def="v", op="qif_sfa_op",
            spike_threshold=1e2, spike_reset=-1e2,
            node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                       "all/qif_sfa_op/k": 15.0})
        net.compile()
        if fused:
            attach_fused_qif_step(net.get_node("qif"))
        return net

    nets = {"kernel": direct_net(True), "plain": direct_net(False)}
    want = LYAP_TRANSIENT + 2 * LYAP_STEPS
    lams, secs, launches = {}, {}, 0
    for how, seed in (("kernel", 0), ("plain", 0), ("plain", 1), ("kernel", 1)):
        qif_sfa_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam = lyapunov_direct(nets[how], inputs=LYAP_DRIVE, steps=LYAP_STEPS,
                              transient=LYAP_TRANSIENT, renorm=LYAP_RENORM, seed=seed)
        secs[f"{how},{seed}"] = time.perf_counter() - t0
        lams[f"{how},{seed}"] = lam
        got = qif_sfa_step.launches
        if got != (want if how == "kernel" else 0) or not np.isfinite(lam):
            raise AssertionError(f"analysis_path: lyapunov_direct ({how}, seed {seed}) "
                                 f"launched the kernel {got} times (want {want}) or read {lam}")
        launches = got if how == "kernel" else launches
    del nets

    net, y0 = tangent_net(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam_full = lyapunov_spectrum(net, k=TANGENT_K, steps=TANGENT_STEPS,
                                 transient=TANGENT_TRANSIENT, y0=y0, seed=0)
    tangent_s = time.perf_counter() - t0
    lam_cut = lyapunov_spectrum(net, k=TANGENT_K, steps=TANGENT_CPU_STEPS,
                                transient=TANGENT_CPU_TRANSIENT, y0=y0, seed=0)
    lam_cpu = np.asarray(cpu_ref["lambda"])
    np.testing.assert_allclose(lam_cut, lam_cpu, **TANGENT_TOL)
    if not (np.all(np.isfinite(lam_full)) and lam_full[0] > 0):
        raise AssertionError(f"analysis_path: the g = 3 network should be chaotic: {lam_full}")
    del net

    mpr = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        m = Network(1e-4, device=device, dtype=dtype)
        m.add_diffeq_node("mpr", MPR, weights=np.zeros((1, 1)), input_var="I_ext",
                          output_var="r", source_var="r", target_var="r_in", op="mpr_op",
                          node_vars={"all/mpr_op/eta": -5.0, "all/mpr_op/J": 15.0})
        pts = [fixed_point(m, y0=np.asarray(y), damping=0.5, max_iter=500)
               for y in ([0.01, -3.0], [1.0, 0.5])]
        mpr[str(dtype)] = ([p.double().cpu().numpy() for p in pts],
                           [stability(m, y=p) for p in pts])
    (card_pts, card_eigs), (cpu_pts, cpu_eigs) = mpr["torch.float32"], mpr["torch.float64"]
    for a, b in zip(card_pts, cpu_pts):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    for a, b in zip(card_eigs, cpu_eigs):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2)
    if np.allclose(card_pts[0], card_pts[1], rtol=1e-2):
        raise AssertionError(f"analysis_path: the two MPR starts found one state {card_pts}")
    emit({"phase": "analysis_path",
          "direct": {"n": N, "steps": LYAP_STEPS, "transient": LYAP_TRANSIENT,
                     "renorm": LYAP_RENORM, "drive": LYAP_DRIVE, "lambda": lams, "s": secs,
                     "kernel_launches": launches,
                     "kernel_minus_plain": {str(s): lams[f"kernel,{s}"] - lams[f"plain,{s}"]
                                            for s in (0, 1)},
                     "seed_spread": {how: abs(lams[f"{how},0"] - lams[f"{how},1"])
                                     for how in ("kernel", "plain")}},
          "tangent": {"n": TANGENT_N, "k": TANGENT_K, "g": TANGENT_G, "steps": TANGENT_STEPS,
                      "transient": TANGENT_TRANSIENT, "lambda": lam_full.tolist(),
                      "s": tangent_s, "ms_per_step": tangent_s / (TANGENT_STEPS
                                                                   + TANGENT_TRANSIENT) * 1e3,
                      "cut_steps": TANGENT_CPU_STEPS, "cut_transient": TANGENT_CPU_TRANSIENT,
                      "cut_lambda_card_f32": lam_cut.tolist(),
                      "cut_lambda_cpu_f64": lam_cpu.tolist(), "cpu_f64_s": cpu_ref["s"],
                      "tol": TANGENT_TOL},
          "mpr": {"fixed_points": [p.tolist() for p in card_pts],
                  "eigenvalues": [[str(e) for e in eigs] for eigs in card_eigs],
                  "cpu_f64_fixed_points": [p.tolist() for p in cpu_pts]}})
    return launches


# ------------------------------ phase 48: the bundles of the other kernels
SK_BUNDLES = ("lif", "lif_B32", "int4", "int4_B32", "block")
SK_LIF_T, SK_LIF_REQUESTS = 1_000, 2  # phase 12's LIF network: 2 chained requests
SK_B, SK_B_T = 32, 500  # the B = 32 bundles: one request each
SK_I4_T = 500  # phase 16's int4 network
SK_BLOCK_T = 200  # phase 34's N = 1,000,448 network
SK_S = {"lif": 10, "lif_B32": 50, "int4": 10, "int4_B32": 50, "block": 100}
SK_ENTRIES = {  # kernels-line entry of phase 48 <- the earlier phase's timing of it
    "generic_fused_step[bfloat16,serving_kernels_path]":
        ("generic_fused_step[lif,bfloat16,generic_path]", "lif", "generic_fused_step"),
    "generic_fused_rows[bfloat16,serving_kernels_path]":
        ("generic_fused_rows[lif,bfloat16,mma]", "lif_B32", "generic_fused_rows"),
    "int4_mv[serving_kernels_path]": ("int4_mv[int4_path]", "int4", "int4_mv"),
    "int4_mm[serving_kernels_path]": ("int4_mm[run_batch_path]", "int4_B32", "int4_mm"),
    "block_int8_mv[serving_kernels_path]": ("block_int8_mv", "block", "block_int8_mv"),
}


def generic_op_turns(dev, n: int = 1_024, calls: int = 2_000) -> dict:
    """The host cost of one call of rectipy::generic_fused_step (its
    Tensor-list arguments boxed by the dispatcher) against the eager
    wrapper's direct launch of the same kernel, in turns (operator, wrapper,
    wrapper, operator): microseconds a call over ``calls`` back-to-back
    calls of phase 12's LIF step at n = 1,024 with a f32 W of 4 MB, best of
    each."""
    from rectipy_tpu_torch.ops import library
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step
    from rectipy_tpu_torch.testing import generic_inputs

    node = lif_net(n, dev, "float32").get_node("lif")
    step, srcs, drive, states, vecs = generic_inputs(node, 48)
    Ws = [node.args["__w_fused_0__"]]
    args = library.generic_args(step, srcs, Ws, drive, states, vecs)
    calls_of = {"operator": lambda: library.generic_fused_step(*args),
                "wrapper": lambda: generic_fused_step(step, srcs, Ws, drive, states, vecs)}
    us = {k: [] for k in calls_of}
    with torch.no_grad():
        if not torch.equal(calls_of["operator"](), calls_of["wrapper"]()):
            raise AssertionError("serving_kernels_path: the generic operator and its wrapper "
                                 "part on the same inputs")
        for name in ("operator", "wrapper", "wrapper", "operator"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                calls_of[name]()
            torch.cuda.synchronize()
            us[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {"n": n, "calls": calls, **{k: min(v) for k, v in us.items()}, "turns": us}


class NodeOutputs(torch.fx.Interpreter):
    """Runs an exported program's graph and keeps every node's output."""

    def __init__(self, gm):
        super().__init__(gm)
        self.outs, self.targets = {}, {}

    def run_node(self, n):
        out = super().run_node(n)
        self.outs[n.name], self.targets[n.name] = out, n.target
        return out


def program_inputs(ep, user: list) -> list:
    """The graph's positional inputs: the user inputs, and the program's
    lifted constants, parameters and buffers where its signature puts them
    (serving._callable binds them the same way)."""
    from torch.export.graph_signature import InputKind

    user, full = iter(user), []
    for spec in ep.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            full.append(next(user))
        elif spec.target in ep.constants:
            full.append(ep.constants[spec.target])
        else:
            full.append(ep.state_dict[spec.target])
    return full


def int4_card_vs_cpu(dev, net, tmp: str, window: dict) -> dict:
    """ROADMAP Queue 3: where card and CPU runs of one int4 network part.
    ``net`` (phase 16's int4 network) is put in int4_path_vs_cpu's start
    state (``window``: phase 16's state after its card runs, and both
    devices' records of that window) and exported as a one-step bundle for
    both devices; the card and the CPU step its program in lockstep (its
    prep once) over the window's CPU_STEPS steps of bench_inputs, and every
    per-neuron state leaf and output is compared after every step.  At the
    first step where they part, the step's graph runs on both devices from
    the same (equal) inputs under an interpreter, and the first node whose
    output differs names the operation.  The window's records are formed as
    Network.run forms them (the population mean of s after steps 0, 10,
    ..., read from the state, each on its own device; sampling 10) and held
    to phase 16's on each device; then the card's states alone are averaged
    on both devices, to show what the mean's reduction order does."""
    from rectipy_tpu_torch.observer import Observer
    from rectipy_tpu_torch.serving import _load_ep, export_network, load_network
    from rectipy_tpu_torch.trees import items

    # the record's reader (s, a view of the node's state row) and the state
    # leaf it reads: the step's output is the s before the step
    (_, label, reader, _), = net._resolve_record_vars(Observer(
        dt=net.dt, record_output=False, record_vars=[("qif", "s", True)]))
    leaf = [key for key, _ in items(net.init_state())].index(("nodes", label))
    path = os.path.join(tmp, "int4_step")
    net.reset({"qif": window["y_end"]})
    export_network(net, path, T=1, n_in=1, platforms=["cuda", "cpu"])
    models = {"card": load_network(path), "cpu": load_network(path, device="cpu")}
    n_p = models["card"].meta["n_params"]
    prepped = {k: m._prepped() for k, m in models.items()}  # once: the packing is prep
    state = {k: list(m._leaves[n_p:]) for k, m in models.items()}
    x = bench_inputs(CPU_STEPS)
    first, outs, steps_parted = None, {"card": [], "cpu": []}, 0
    recs = {"card": [], "cpu": [], "card_on_cpu": []}  # Network.run's records, sampling 10
    for t in range(CPU_STEPS):
        new = {}
        with torch.no_grad():
            for k, m in models.items():
                res = m._step(*prepped[k], *state[k], torch.as_tensor(x[t], device=m.device))
                new[k], out = list(res[:-1]), res[-1]
                outs[k].append(out.cpu())
                if t % 10 == 0:
                    recs[k].append(float(reader(new[k][leaf], None).mean()))
        if t % 10 == 0:
            recs["card_on_cpu"].append(float(reader(new["card"][leaf].cpu(), None).mean()))
        pairs = [(a.cpu(), b) for a, b in zip(new["card"], new["cpu"])]
        parted = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
        if parted or not torch.equal(outs["card"][-1], outs["cpu"][-1]):
            steps_parted += 1
            if first is None:
                first = {"step": t, "state_leaves_parted": parted,
                         "neurons_parted": [int((a != b).sum()) for a, b in pairs],
                         "max_abs_diff": [float((a - b).abs().max()) for a, b in pairs],
                         "inputs_equal": all(torch.equal(a.cpu(), b) for a, b in zip(
                             state["card"], state["cpu"]))}
                # the step once more on both devices from the same inputs, every
                # node's output kept: the first that differs names the operation
                runs = {}
                for k, m in models.items():
                    ep = _load_ep(os.path.join(path, "step.pt2"), m.device, k == "cpu")
                    user = prepped[k] + state[k] + [torch.as_tensor(x[t], device=m.device)]
                    runs[k] = NodeOutputs(ep.graph_module)
                    with torch.no_grad():
                        runs[k].run(*program_inputs(ep, user))
                for name, a in runs["card"].outs.items():
                    b = runs["cpu"].outs.get(name)
                    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and \
                            not torch.equal(a.cpu(), b):
                        first["operation"] = {"node": name, "target": str(runs["card"].targets[
                            name]), "elements_parted": int((a.cpu() != b).sum()),
                            "max_abs_diff": float((a.cpu() - b).abs().max())}
                        break
        state = new
    card, cpu = torch.stack(outs["card"]), torch.stack(outs["cpu"])
    recs = {k: np.asarray(v, dtype=np.float32) for k, v in recs.items()}

    def equal(a, b):
        return int((a == b).sum())

    return {"steps": CPU_STEPS, "steps_parted": steps_parted, "first_parting": first,
            "outputs_max_abs_diff": float((card - cpu).abs().max()),
            "records": int(recs["card"].shape[0]),
            "card_records_equal_int4_path_vs_cpu_card": equal(recs["card"], window["card"]),
            "cpu_records_equal_int4_path_vs_cpu_cpu": equal(recs["cpu"], window["cpu"]),
            "int4_path_vs_cpu_records_equal": equal(window["card"], window["cpu"]),
            "int4_path_vs_cpu_max_abs_diff": float(np.abs(window["card"] - window["cpu"]).max()),
            "records_equal_card_vs_cpu": equal(recs["card"], recs["cpu"]),
            "records_equal_when_the_card_s_states_are_averaged_on_both":
                equal(recs["card"], recs["card_on_cpu"]),
            "records_max_abs_diff_from_the_reduction_alone":
                float(np.abs(recs["card"] - recs["card_on_cpu"]).max())}


def serving_kernels_phase(dev, child, rnd: dict, err_path: str, build_net, block_net,
                          int4_window: dict, by_name: dict) -> list:
    """Phase 48: the networks whose step reaches the generic fused step, the
    int4 products or the int8 block product, exported and served by phase
    45's process: phase 12's LIF network (bf16 coupling, the generic step)
    for SK_LIF_REQUESTS chained requests of SK_LIF_T steps and as a
    SK_B-trial bundle (phase 26's drive, one request of SK_B_T steps), phase
    16's int4 network (SK_I4_T steps), phase 26's frozen int4 network at SK_B
    trials (SK_B_T steps) and phase 34's N = 1,000,448 int8 block network
    (SK_BLOCK_T steps of its Pulse), written to ``rnd``'s temporary paths.
    The served records must equal the window means of Network.run (run_batch)
    over the same steps from the exported state bit for bit, with one launch
    a step, every B-row and int4_mm launch on the tensor cores and every
    block launch on "mma".  Then each bundle served against run (run_batch)
    in turns here, the generic operator's host cost a call, and where card
    and CPU runs of the int4 bundle part.  Returns the kernels-line entries."""
    from rectipy_tpu_torch.serving import export_network, load_network

    t_phase = time.perf_counter()
    bundles = rnd["bundles"]
    rng = np.random.default_rng(48)
    lif = lif_net(N, dev)
    nets = {"lif": lif, "lif_B32": lif, "int4": build_net("int4", False),
            "int4_B32": batch_run_net("int4", False, dev)[0], "block": block_net}
    block_net.reset()
    inputs = {
        "lif": np.zeros((SK_LIF_REQUESTS, SK_LIF_T, 1), dtype=np.float32),  # phase 12's drive
        "lif_B32": (rng.normal(size=(1, SK_B, SK_B_T, 1))  # phase 26's (normal + linspace)
                    + np.linspace(0.0, 2.0, SK_B)[None, :, None, None]).astype(np.float32),
        "int4": bench_inputs(SK_I4_T)[None],
        "int4_B32": (3.0 + rng.normal(size=(1, SK_B, SK_B_T, 1))).astype(np.float32),
        "block": pulse(SK_BLOCK_T, SK_BLOCK_T // 4)[None]}
    spec = {name: dict(T=inputs[name].shape[-2], sampling_steps=SK_S[name], n_in=1,
                       batch=SK_B if name.endswith("B32") else None) for name in SK_BUNDLES}
    info = {}
    for name in SK_BUNDLES:
        path = bundles[name]["path"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_network(nets[name], path, **spec[name])
        export_s = time.perf_counter() - t0
        np.save(bundles[name]["inputs"], inputs[name])
        info[name] = {"export_s": export_s, "bundle_bytes": bundle_bytes(path),
                      "files": sorted(os.listdir(path))}
    open(rnd["ready"], "w").close()
    # the references from the exported state, while the serving process
    # serves: run_batch (which leaves the state alone) before run
    refs = {}
    for name in ("lif_B32", "lif", "int4_B32", "int4", "block"):
        s, T = SK_S[name], spec[name]["T"]
        if name.endswith("B32"):
            per_step = torch.as_tensor(nets[name].run_batch(inputs[name][0], verbose=False)[
                "out"], device=dev)
            refs[name] = [served_windows(per_step, s)]
        else:
            obs = nets[name].run(np.concatenate(list(inputs[name])), verbose=False)
            per_step = torch.as_tensor(obs.to_numpy("out"), device=dev)
            refs[name] = [served_windows(c, s) for c in per_step.split(T)]
        del per_step
    seconds = {"exports_and_references": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    served = child_line(child, err_path, "serving_kernels_path")
    seconds["waiting_for_the_serving_process"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = {"lif": {"generic_fused_step": SK_LIF_T * SK_LIF_REQUESTS},
            "lif_B32": {"generic_fused_rows": SK_B_T, "generic_fused_rows_mma": SK_B_T,
                        "generic_fused_step": 0},
            "int4": {"int4_mv": SK_I4_T},
            "int4_B32": {"int4_mm": SK_B_T, "int4_mm_mma": SK_B_T, "int4_mv": 0},
            "block": {"block_int8_mv": SK_BLOCK_T, "block_int8_mv_mma": SK_BLOCK_T}}
    lines = {}
    for name in SK_BUNDLES:
        equal = check_served(f"serving_kernels_path ({name})", bundles[name]["out"],
                             refs[name], served[name], want[name])
        model = load_network(bundles[name]["path"])
        one = inputs[name][0]
        turns = serve_turns(model, nets[name], one, name.endswith("B32"), SK_S[name])
        lines[name] = {**info[name], **served[name], "bit_identical": equal,
                       "records": list(np.load(bundles[name]["out"]).shape), **turns}
        del model
        torch.cuda.empty_cache()
    del refs
    seconds["checks_and_turns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_call_us = generic_op_turns(dev)
    seconds["generic_op_turns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    int4_parting = int4_card_vs_cpu(dev, nets["int4"], os.path.dirname(bundles["int4"]["path"]),
                                    int4_window)
    seconds["int4_card_vs_cpu"] = time.perf_counter() - t0
    emit({"phase": "serving_kernels_path", "n": {"lif": N, "int4": N, "block": SPARSE_N},
          "bundles": lines, "seconds": seconds, "generic_op_call_us": op_call_us,
          "int4_card_vs_cpu": int4_parting})
    del nets, lif, block_net
    torch.cuda.empty_cache()
    return [{**by_name[src], "name": name, "launches": served[bundle][counter]}
            for name, (src, bundle, counter) in SK_ENTRIES.items()]


def tooling_phases(dev, W_np, etas, build_net, by_name: dict, block_net,
                   int4_window: dict) -> list:
    """Phases 45-48 (the serving bundles, checkpoints, the analyses, the
    bundles of the generic, int4 and block kernels).  Phase 45 exports the
    main network's bf16 fused bundle (SERVE_T steps a request, sampling
    SERVE_S), the SERVE_B-trial ensemble bundle of the same network and the
    int8 network's (phase 16's, frozen int8 coupling), and serves them in a
    fresh process that builds no Network, while this process runs the
    references (Network.run of the same 4,000 steps and run_batch) and
    phase 46; the served records must equal the references' window means
    bit for bit and the served process's launches be 4,000 single, 1,000
    B-row on the tensor cores and 500 int8_mv; then served against
    Network.run in turns.  The same process serves phase 48's bundles
    (serving_kernels_phase; ``block_net`` is phase 34's million-neuron int8
    network).  Returns the kernels-line entries."""
    from rectipy_tpu_torch.serving import export_network, load_network

    root = os.path.dirname(os.path.abspath(__file__))
    cpu_child = None
    tmp = tempfile.TemporaryDirectory()
    rounds = [bundle_round(tmp.name, "45", ("bf16", "bf16_B32", "int8")),
              bundle_round(tmp.name, "48", SK_BUNDLES)]
    bundles = rounds[0]["bundles"]
    err_path = os.path.join(tmp.name, "serve_child_err.txt")
    # the serving process starts now and waits for the bundles (its imports
    # and CUDA context overlap the exports)
    with open(err_path, "w") as err_file:
        child = subprocess.Popen([sys.executable, "-c", SERVE_CHILD, json.dumps(
            {"root": root, "rounds": rounds})], stdout=subprocess.PIPE, stderr=err_file,
            text=True)
    try:
        t_phase = time.perf_counter()
        rng = np.random.default_rng(45)
        nets = {"bf16": build_net("bfloat16", fused=True), "int8": build_net("int8", False)}
        nets["bf16_B32"] = nets["bf16"]
        inputs = {
            "bf16": bench_inputs(SERVE_T * SERVE_REQUESTS).reshape(SERVE_REQUESTS, SERVE_T, 1),
            "bf16_B32": (3.0 + rng.normal(size=(SERVE_B, SERVE_B_T * SERVE_B_REQUESTS, 1))
                         ).astype(np.float32),
            "int8": bench_inputs(SERVE_INT8_T)[None]}
        inputs["bf16_B32"] = np.stack(np.split(inputs["bf16_B32"], SERVE_B_REQUESTS, axis=1))
        spec = {"bf16": dict(T=SERVE_T, sampling_steps=SERVE_S, n_in=1),
                "bf16_B32": dict(T=SERVE_B_T, sampling_steps=SERVE_B_S, n_in=1, batch=SERVE_B),
                "int8": dict(T=SERVE_INT8_T, sampling_steps=SERVE_S, n_in=1)}
        info = {}
        for name, kw in spec.items():
            path = bundles[name]["path"]
            t0 = time.perf_counter()
            export_network(nets[name], path, **kw)
            export_s = time.perf_counter() - t0
            np.save(bundles[name]["inputs"], inputs[name])
            info[name] = {"export_s": export_s, "bundle_bytes": bundle_bytes(path),
                          "files": sorted(os.listdir(path))}
        open(rounds[0]["ready"], "w").close()
        # the references, from the exported state: run_batch first (it
        # leaves the state alone), then run
        refs = {}
        bins = np.concatenate(list(inputs["bf16_B32"]), axis=1)  # (B, 1,000, 1)
        per_step = torch.as_tensor(nets["bf16"].run_batch(bins, verbose=False)["out"],
                                   device=dev)
        refs["bf16_B32"] = [served_windows(c, SERVE_B_S)
                            for c in per_step.split(SERVE_B_T, dim=1)]
        del per_step
        for name in ("bf16", "int8"):
            obs = nets[name].run(np.concatenate(list(inputs[name])), verbose=False)
            per_step = torch.as_tensor(obs.to_numpy("out"), device=dev)
            refs[name] = [served_windows(c, SERVE_S) for c in per_step.split(spec[name]["T"])]
        ref_s = time.perf_counter() - t_phase
        # phase 47's CPU float64 reference runs beside phase 46 (nice 10),
        # and ends before anything here is timed against anything else
        cpu_child = subprocess.Popen(
            [sys.executable, "-c", TANGENT_CPU_CHILD, json.dumps({
                "root": root, "threads": 4, "n": TANGENT_N, "g": TANGENT_G, "k": TANGENT_K,
                "steps": TANGENT_CPU_STEPS, "transient": TANGENT_CPU_TRANSIENT,
                "tanh": TANH})], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        ckpt_launches = checkpoint_phase(dev)
        served = child_line(child, err_path, "serving_path")
        out, err = cpu_child.communicate(timeout=600)
        if cpu_child.returncode != 0:
            raise AssertionError(f"analysis_path: the CPU float64 run failed:\n{err}")
        cpu_ref = json.loads(out.strip().splitlines()[-1])
        want = {"bf16": ("qif_sfa_step", SERVE_T * SERVE_REQUESTS),
                "bf16_B32": ("qif_sfa_step_mma", SERVE_B_T * SERVE_B_REQUESTS),
                "int8": ("int8_mv", SERVE_INT8_T)}
        lines = {}
        for name, (counter, n_launch) in want.items():
            equal = check_served(f"serving_path ({name})", bundles[name]["out"], refs[name],
                                 served[name], {counter: n_launch})
            if name == "bf16_B32" and served[name]["qif_sfa_step"] != n_launch:
                raise AssertionError(f"serving_path ({name}): not every launch took the "
                                     f"tensor cores: {served[name]}")
            model = load_network(bundles[name]["path"])
            one = inputs[name][0]
            turns = serve_turns(model, nets[name], one, name == "bf16_B32", spec[name][
                "sampling_steps"])
            lines[name] = {**info[name], **served[name], "bit_identical": equal,
                           "records": list(np.load(bundles[name]["out"]).shape), **turns}
            del model
        op_call_us = op_registration_turns(dev)
        emit({"phase": "serving_path", "n": N, "bundles": lines,
              "reference_and_export_s": ref_s, "op_call_us": op_call_us})
        del nets, refs
        torch.cuda.empty_cache()
        lyap_launches = analysis_phase(dev, W_np, etas, cpu_ref)
        entries = serving_kernels_phase(dev, child, rounds[1], err_path, build_net, block_net,
                                        int4_window, by_name)
        child.wait(timeout=60)
    except BaseException:
        for proc in (child, cpu_child):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        raise
    finally:
        tmp.cleanup()
    return [
        {**by_name["qif_sfa_step[bfloat16]"], "name": "qif_sfa_step[bfloat16,serving_path]",
         "launches": served["bf16"]["qif_sfa_step"]},
        {**by_name["qif_sfa_step_rows[bfloat16]"],
         "name": "qif_sfa_step_rows[bfloat16,serving_path]",
         "launches": served["bf16_B32"]["qif_sfa_step"]},
        {**by_name["int8_mv"], "name": "int8_mv[serving_path]",
         "launches": served["int8"]["int8_mv"]},
        {**by_name["stdp_update[float32,dense]"], "name": "stdp_update[float32,checkpoint_path]",
         "launches": ckpt_launches["float32"]},
        {**by_name["stdp_update[bfloat16,dense]"],
         "name": "stdp_update[bfloat16,checkpoint_path]", "launches": ckpt_launches["bfloat16"]},
        {**by_name["qif_sfa_step[float32]"], "name": "qif_sfa_step[float32,analysis_path]",
         "launches": lyap_launches}] + entries


MESH_STEPS = 1_000  # mesh_path: the bf16 fused network's runs
MESH_B_STEPS = 500  # the int8 network's runs and the B = 32 run_batch
MESH_B = 32


def mesh_phase(dev, build_net, by_name: dict) -> list:
    """Phase 49 (see the docstring).  Returns the kernels-line entries."""
    import torch.distributed as dist

    from rectipy_tpu_torch.ops.kernels import qif_sfa_step
    from rectipy_tpu_torch.ops.quant import int8_mv
    from rectipy_tpu_torch.parallel import make_mesh, sharded_step_collectives

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_path_")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            device_id=dev)
    try:
        mesh = make_mesh(1)
        ins_b = (np.random.default_rng(26).normal(size=(MESH_B, MESH_B_STEPS, 1))
                 + np.linspace(0.0, 2.0, MESH_B)[:, None, None]).astype(np.float32)
        fused, int8 = build_net("bfloat16", fused=True), build_net("int8", fused=False)
        runs = (  # name, network, run, kernel, counters equal to the steps, steps, entry
            ("bf16_run", fused, "run", qif_sfa_step, ("launches",), MESH_STEPS,
             "qif_sfa_step[bfloat16]", "qif_sfa_step[bfloat16,mesh_path]"),
            ("int8_run", int8, "run", int8_mv, ("launches",), MESH_B_STEPS, "int8_mv",
             "int8_mv[mesh_path]"),
            ("bf16_run_batch_B32", fused, "run_batch", qif_sfa_step,
             ("launches", "mma_launches"), MESH_B_STEPS, "qif_sfa_step_rows[bfloat16]",
             "qif_sfa_step_rows[bfloat16,mesh_path]"))
        entries, lines = [], []
        for name, net, how, kernel, counters, steps, timing, entry in runs:
            first, times, launches = None, {"mesh": [], "plain": []}, None
            for turn in ("mesh", "plain", "plain", "mesh"):
                kw = {"mesh": mesh} if turn == "mesh" else {}
                net.reset()
                for c in counters:
                    setattr(kernel, c, 0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if how == "run":
                    obs = net.run(bench_inputs(steps), record_vars=[("qif", "s", True)],
                                  sampling_steps=10, verbose=False, **kw)
                    rec = {"out": obs.to_numpy("out"), "s": obs.to_numpy(("qif", "s"))}
                else:
                    res = net.run_batch(ins_b, record_vars=[("qif", "s", True)],
                                        sampling_steps=10, **kw)
                    rec = {"out": res["out"], "s": res[("qif", "s")]}
                torch.cuda.synchronize()
                times[turn].append(time.perf_counter() - t0)
                counts = [getattr(kernel, c) for c in counters]
                if counts != [steps] * len(counters):
                    raise AssertionError(f"mesh_path {name} ({turn}): {counters} = {counts} "
                                         f"for {steps} steps")
                launches = counts[0]
                first = first or rec  # every run from the same state: the same records
                for key, val in rec.items():
                    if not (np.all(np.isfinite(val)) and np.array_equal(val, first[key])):
                        raise AssertionError(f"mesh_path {name} ({turn}): the {key!r} records "
                                             f"are not finite or part from the first run's")
            ms = {t: min(v) / steps * 1e3 for t, v in times.items()}
            collectives = sharded_step_collectives(net, mesh) if how == "run" else None
            line = {"phase": "mesh_path", "run": name, "n": N, "steps": steps,
                    "trials": MESH_B if how == "run_batch" else 1,
                    "mesh": {"model": 1, "data": 1, "backend": "nccl"},
                    "kernel": kernel.__name__, "mesh_launches": launches,
                    "bit_identical_records": True, "records": int(first["s"].size),
                    "run_s": times, "mesh_ms_per_step": ms["mesh"],
                    "plain_ms_per_step": ms["plain"], "mesh_over_plain": ms["mesh"] / ms["plain"]}
            if collectives is not None:
                line["collectives_per_step"] = collectives
            emit(line)
            lines.append(line)
            entries.append({**by_name[timing], "name": entry, "launches": launches})
        emit({"phase": "mesh_path", "summary": True, "nvidia_smi": nvidia_smi(),
              "ms_per_step": {ln["run"]: [ln["mesh_ms_per_step"], ln["plain_ms_per_step"],
                                          ln["mesh_over_plain"]] for ln in lines},
              "seconds": time.perf_counter() - t_phase})
        return entries
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


MT_EPOCHS = 2  # mesh_train_path (a): phase 8's north-star fit, T_TRAIN steps an epoch
MT_T = 100  # (b) and (c): phase 27's B_TRAIN trials cut to their first MT_T steps
MT_STARTS = 2  # (c)
MT_ES_T, MT_ES_GENERATIONS = 500, 2  # (d): es_path's ES_B candidates
MT_FORCE_T = 1_000  # (e): the FORCE cell's fit_rls and fit_eprop
MT_STDP_T = 1_000  # (f): phase 42's dense f32 soft-bound fit


def _mt_same(name: str, turn: str, rec: dict, first: dict) -> None:
    """Every record of a turn equal to the first turn's, bit for bit, and
    finite (device tensors compared on the device)."""
    for key, val in rec.items():
        ref = first[key]
        if isinstance(val, torch.Tensor):
            same, finite = torch.equal(val, ref), bool(torch.isfinite(val.float()).all())
        else:
            val, ref = np.asarray(val), np.asarray(ref)
            same = val.shape == ref.shape and np.array_equal(val, ref)
            finite = bool(np.all(np.isfinite(val.astype(np.float64))))
        if not (same and finite):
            raise AssertionError(f"mesh_train_path {name} ({turn}): the {key!r} records are "
                                 f"not finite or part from the first fit's")


def mesh_train_phase(dev, build_net, data, trials, W_np, etas, by_name: dict) -> list:
    """Phase 50 (see the docstring).  Returns the kernels-line entries."""
    import torch.distributed as dist

    from rectipy_tpu_torch.edges import RLS
    from rectipy_tpu_torch.ops.fused_opt import adam_requant
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step
    from rectipy_tpu_torch.ops.quant import int8_mm, int8_mm_t, int8_mv, int8_mv_t
    from rectipy_tpu_torch.ops.stdp import stdp_update
    from rectipy_tpu_torch.parallel import comm, make_mesh, sharded_step_collectives

    t_phase = time.perf_counter()
    W_t, etas_t, inp_t, tgt_t = data
    inp_d, tgt_d = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (inp_t, tgt_t))
    ins_b, tgts_b = (torch.as_tensor(a[:, :MT_T], device=dev) for a in trials)
    es_drive = spike_drive(MT_ES_T, ES_DRIVE)
    force_in = bench_inputs(MT_FORCE_T)
    force_tgt = np.sin(2 * np.pi * 2.0 * DT * np.arange(MT_FORCE_T))[:, None]
    w_stdp = stdp_weights(STDP_N)

    def es_targets():
        net = spike_net(W_np, etas)
        rec = net.run_batch(es_drive, sampling_steps=SPIKE_WINDOW, record_output=False,
                            record_spikes=["qif"],
                            batch_vars={("qif", "eta"): (etas + ES_SHIFT)[None]})
        return rec[("qif", "spikes")][0].astype(np.float32)

    es_tgt = es_targets()

    # each fit: build(mesh) makes the fresh network (untimed) and returns it
    # with the fit, which returns the records
    def fit_bptt(mesh):
        net = build_train_net(W_t, etas_t)

        def run():
            obs = net.fit_bptt([inp_d] * MT_EPOCHS, [tgt_d] * MT_EPOCHS, optimizer="adam",
                               lr=LR, verbose=False, mesh=mesh)
            return {"loss": np.asarray(obs["epoch_loss"]), "W": net.get_node("qif")["weights"],
                    "trajectory": net.last_fit["trajectory"] == "chain"
                    and not net.last_fit["fused_adam"]}
        return net, run

    def fit_bptt_batch(mesh):
        net = build_train_net(W_t, etas_t)

        def run():
            obs = net.fit_bptt_batch(ins_b, tgts_b, n_epochs=1, optimizer="adam", lr=LR,
                                     verbose=False, mesh=mesh)
            return {"loss": np.asarray(obs["train_loss"]), "W": net.get_node("qif")["weights"]}
        return net, run

    # (c)'s starts: the master and a perturbation of it, made once on the card
    # (the JAX package's numpy draws of 10^8 weights take seconds a start)
    gen = torch.Generator(device=dev).manual_seed(50)
    w0 = torch.as_tensor(W_t, dtype=torch.float32, device=dev)
    starts = torch.stack([w0, w0 + 1e-4 * torch.randn(w0.shape, generator=gen, device=dev)])
    del w0

    def fit_bptt_multistart(mesh):
        net = build_train_net(W_t, etas_t)

        def run():
            obs = net.fit_bptt_multistart(ins_b, tgts_b, n_starts=MT_STARTS, n_epochs=1,
                                          start_inits={("qif", "weights"): starts},
                                          optimizer="adam", lr=LR, verbose=False, mesh=mesh)
            return {"final": np.asarray(obs["start_final_loss"]),
                    "best": np.asarray(obs["best_start"]), "W": net.get_node("qif")["weights"]}
        return net, run

    def fit_es(mesh):
        net = spike_net(W_np, etas)

        def run():
            obs = net.fit_es(es_drive, es_tgt, fit_vars=[("qif", "eta")],
                             n_generations=MT_ES_GENERATIONS, pop_size=ES_B, sigma=ES_SIGMA,
                             lr=ES_LR, loss="mse", record_spikes=["qif"],
                             objective_key=("qif", "spikes"), sampling_steps=SPIKE_WINDOW,
                             seed=50, verbose=False, mesh=mesh)
            return {"mean": np.asarray(obs["es_mean_loss"]), "final": obs["es_final_loss"],
                    "eta": net.get_node("qif")["eta"]}
        return net, run

    def force_net(rule: str):
        net = build_net("bfloat16", fused=True)
        net.add_func_node("readout", 1, activation_function="identity")
        if rule == "rls":
            return net, net.add_edge("qif", "readout", train="rls", beta=0.99, alpha=1.0)
        return net, net.add_edge("qif", "readout", train="eprop", weights=np.zeros((1, N)))

    def fit_rls(mesh):
        net, edge = force_net("rls")

        def run():
            obs = net.fit_rls(force_in, force_tgt, update_steps=10, sampling_steps=100,
                              verbose=False, mesh=mesh)
            return {"loss": obs.to_numpy("loss"), "out": obs.to_numpy("out"),
                    "W": edge.weights, "P": edge.P}
        return net, run

    def fit_eprop(mesh):
        net, edge = force_net("eprop")

        def run():
            obs = net.fit_eprop(force_in, force_tgt, lr=0.5, epsilon=0.0, delta=0.0,
                                normalize=True, sampling_steps=100, verbose=False, mesh=mesh)
            return {"loss": obs.to_numpy("loss"), "out": obs.to_numpy("out"),
                    "W": edge.params["weights"]}
        return net, run

    def fit_stdp(mesh):
        net = stdp_scale_net(STDP_N, w0=w_stdp)

        def run():
            obs = net.fit_stdp(stdp_drive(MT_STDP_T), sampling_steps=MT_STDP_T // 4,
                               verbose=False, mesh=mesh)
            e = net.get_edge("qif", "qif")
            return {"w_stats": np.stack([obs["w_mean"], obs["w_min"], obs["w_max"]]),
                    "W": e.params["weights"], "x_pre": e.params["x_pre"],
                    "x_post": e.params["x_post"]}
        return net, run

    # name, fit, counters {kernel: attributes}, expected launches per attribute
    # of one fit, unit and units a fit, and the kernels-line entries (kernel
    # -> the earlier timing of the same instance, this path's entry)
    fits = (
        ("fit_bptt", fit_bptt, {int8_mv: ("launches",), int8_mv_t: ("launches",),
                                adam_requant: ("launches",)},
         {"int8_mv": MT_EPOCHS * T_TRAIN, "int8_mv_t": MT_EPOCHS * T_TRAIN, "adam_requant": 0},
         "epoch", MT_EPOCHS, {"int8_mv": ("int8_mv", "int8_mv["),
                              "int8_mv_t": ("int8_mv_t", "int8_mv_t[")}),
        ("fit_bptt_batch", fit_bptt_batch, {int8_mm: ("launches", "mma_launches"),
                                            int8_mm_t: ("launches", "mma_launches")},
         {"int8_mm": MT_T, "int8_mm_t": MT_T}, "epoch", 1,
         {"int8_mm": ("int8_mm", "int8_mm["), "int8_mm_t": ("int8_mm_t", "int8_mm_t[")}),
        ("fit_bptt_multistart", fit_bptt_multistart,
         {int8_mm: ("launches", "mma_launches"), int8_mm_t: ("launches", "mma_launches")},
         {"int8_mm": MT_STARTS * MT_T, "int8_mm_t": MT_STARTS * MT_T}, "epoch", 1,
         {"int8_mm": ("int8_mm", "int8_mm["), "int8_mm_t": ("int8_mm_t", "int8_mm_t[")}),
        ("fit_es", fit_es, {qif_sfa_step: ("launches", "mma_launches")},
         {"qif_sfa_step": (MT_ES_GENERATIONS + 1) * MT_ES_T}, "step",
         (MT_ES_GENERATIONS + 1) * MT_ES_T,
         {"qif_sfa_step": ("qif_sfa_step.mma[es_path]", "qif_sfa_step.mma[")}),
        ("fit_rls", fit_rls, {qif_sfa_step: ("launches",)}, {"qif_sfa_step": MT_FORCE_T},
         "step", MT_FORCE_T, {"qif_sfa_step": ("qif_sfa_step[bfloat16]",
                                               "qif_sfa_step[bfloat16,")}),
        ("fit_eprop", fit_eprop, {qif_sfa_step: ("launches",)}, {"qif_sfa_step": MT_FORCE_T},
         "step", MT_FORCE_T, {"qif_sfa_step": ("qif_sfa_step[bfloat16]",
                                               "qif_sfa_step[bfloat16,")}),
        ("fit_stdp", fit_stdp, {stdp_update: ("launches", "tile_launches")},
         {"stdp_update": MT_STDP_T}, "step", MT_STDP_T,
         {"stdp_update": ("stdp_update[float32,dense]", "stdp_update[float32,")}),
    )
    tmp = tempfile.mkdtemp(prefix="mesh_train_path_")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            device_id=dev)
    mode = os.environ.get("RECTIPY_FUSED_ADAM")
    os.environ["RECTIPY_FUSED_ADAM"] = "off"  # both arms of (a); a mesh fit reads it not
    try:
        mesh = make_mesh(1)
        entries, lines = [], []
        for name, fn, counters, want, unit, units, names in fits:
            first, counts0, times = None, None, {"mesh": [], "plain": []}
            net, run = fn(None)  # one untimed warm fit: the turns all find a warm card
            run()
            del net, run
            for turn in ("mesh", "plain", "plain", "mesh"):
                for k, attrs in counters.items():
                    for a in attrs:
                        setattr(k, a, 0)
                net, run = fn(mesh if turn == "mesh" else None)
                comm.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = run()
                torch.cuda.synchronize()
                times[turn].append(time.perf_counter() - t0)
                counts = {f"{k.__name__}.{a}": getattr(k, a)
                          for k, attrs in counters.items() for a in attrs}
                tally = comm.tally()
                for k, attrs in counters.items():
                    if any(getattr(k, a) != want[k.__name__] for a in attrs):
                        raise AssertionError(f"mesh_train_path {name} ({turn}): launches "
                                             f"{counts}, expected {want} of each")
                if any(v["count"] for v in tally.values()) or rec.pop("trajectory", True) \
                        is not True:
                    raise AssertionError(f"mesh_train_path {name} ({turn}): collectives "
                                         f"{tally} or not the unfused chain trajectory")
                first, counts0 = first or rec, counts0 or counts
                _mt_same(name, turn, rec, first)
                if counts != counts0:
                    raise AssertionError(f"mesh_train_path {name}: launches {counts}, the "
                                         f"first fit's {counts0}")
                if turn == "mesh" and len(times["mesh"]) == 2:
                    coll = sharded_step_collectives(net, mesh)
                    if any(v["count"] for v in coll.values()):
                        raise AssertionError(f"mesh_train_path {name}: {coll}")
                del net, run, rec
            ms = {t: min(v) / units * 1e3 for t, v in times.items()}
            line = {"phase": "mesh_train_path", "fit": name, "n": N,
                    "mesh": {"model": 1, "data": 1, "backend": "nccl"},
                    "launches_per_fit": counts0, "bit_identical": True,
                    "collectives_per_fit": 0, "sharded_step_collectives": 0, "fit_s": times,
                    f"mesh_ms_per_{unit}": ms["mesh"], f"plain_ms_per_{unit}": ms["plain"],
                    "mesh_over_plain": ms["mesh"] / ms["plain"]}
            if name == "fit_bptt":  # one mesh fit under RECTIPY_FUSED_ADAM=on: the off fit
                os.environ["RECTIPY_FUSED_ADAM"] = "on"
                adam_requant.launches = 0
                rec = fit_bptt(mesh)[1]()
                os.environ["RECTIPY_FUSED_ADAM"] = "off"
                rec.pop("trajectory")
                _mt_same(name, "mesh, RECTIPY_FUSED_ADAM=on", rec, first)
                if adam_requant.launches:
                    raise AssertionError(f"mesh_train_path: {adam_requant.launches} "
                                         f"adam_requant launches under a mesh")
                line["fused_adam_on_equals_off"] = True
                line["fused_adam_on_adam_requant_launches"] = 0
                del rec
            del first
            torch.cuda.empty_cache()
            emit(line)
            lines.append(line)
            for kname, (timing, prefix) in names.items():
                entries.append({**by_name[timing], "launches": want[kname],
                                "name": f"{prefix}mesh_train_path,{name}]"})
        del starts
        emit({"phase": "mesh_train_path", "summary": True, "nvidia_smi": nvidia_smi(),
              "mesh_over_plain": {ln["fit"]: ln["mesh_over_plain"] for ln in lines},
              "seconds": time.perf_counter() - t_phase})
        return entries
    finally:
        if mode is None:
            os.environ.pop("RECTIPY_FUSED_ADAM", None)
        else:
            os.environ["RECTIPY_FUSED_ADAM"] = mode
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# mesh_quant_path: examples/qif_100k_sharded.py's training at its width (N =
# 100,000 rounded up to the block grid of 512), cut to qif_T steps and 2
# epochs; bench.py's N = 10,000 int4_master network, int4_T of its T_TRAIN
# steps; its ensemble, B_TRAIN trials of B_T steps
MQ_SIZES = dict(qif_n=100_352, qif_bs=512, qif_fan=1_000, qif_T=100, epochs=2, int4_n=N,
                int4_T=100, B=B_TRAIN, B_T=100)
MQ_MODEL = 2
# the mesh fits against the fits without a mesh on the card, float32: the
# losses within rtol 1e-6 (the ranks' rows of the loss's sums, a few ulps),
# the trained leaves within 1e-7 (an ulp of a weight of 1; the dW products
# of a rank's rows may sum in another order than the whole matrix's)
MQ_TOL = {fit: {"loss": 1e-6, "weights": 1e-7, "gains": 1e-7}
          for fit in ("qif_sharded", "int4_fit_bptt", "int4_fit_bptt_batch")}


def mesh_quant_kernels(dev) -> dict:
    """Phase 51's kernels at one rank's shapes (model MQ_MODEL): int4_mv and
    int4_mv_t on the rank's N / 2 rows of the N = 10,000 coupling, int4_mm
    and int4_mm_t at B_TRAIN trials, block_int8_mv on the rank's block rows
    of the 100k example's coupling; each held bit for bit to its plain
    version on the same inputs, timed with it, and bounded.  Returns the
    kernels-line entries by kernel, launches 0 (the turns fill them in)."""
    from rectipy_tpu_torch import block_random_connectivity
    from rectipy_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(51)
    rows, n, B = N // MQ_MODEL, N, MQ_SIZES["B"]
    wq = torch.randint(-7, 8, (rows, n), generator=gen, device=dev, dtype=torch.int8)
    wp, ws = quant.pack_int4(wq), torch.rand(rows, generator=gen, device=dev) + 0.5

    def q8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    xq, vq, xb, vb = q8((n,)), q8((rows,)), q8((B, n)), q8((B, rows))
    one, ones = torch.ones((), device=dev), torch.ones(B, device=dev)
    bs, n_br = MQ_SIZES["qif_bs"], MQ_SIZES["qif_n"] // MQ_SIZES["qif_bs"] // MQ_MODEL
    A = block_random_connectivity(MQ_SIZES["qif_n"], MQ_SIZES["qif_n"], MQ_SIZES["qif_fan"],
                                  block_size=bs, seed=0)
    idx = torch.as_tensor(np.asarray(A.cols)[:n_br], dtype=torch.int32, device=dev)
    cb = idx.shape[1]
    bq = q8((n_br, cb, bs, bs))
    rs = torch.rand((n_br, bs), generator=gen, device=dev) + 0.5
    xs = q8((1, 2 * n_br, bs))
    cases = {  # kernel: (call, plain, bytes, operations)
        "int4_mv": (lambda: quant.int4_mv(wp, xq, ws, one),
                    lambda: (quant.int4_dot_plain(wp, xq) * ws) * one,
                    wp.numel() + n + 4 * rows * 2, 2 * rows * n),
        "int4_mv_t": (lambda: quant.int4_mv_t(wp, vq, one, n),
                      lambda: quant.int4_dot_t_plain(wp, vq, n) * one,
                      wp.numel() + rows + 4 * n, 2 * rows * n),
        "int4_mm": (lambda: quant.int4_mm(wp, xb, ws, ones),
                    lambda: (quant.int4_mm_plain(wp, xb) * ws) * ones[:, None],
                    wp.numel() + B * n + 4 * rows + 4 * B + 4 * B * rows, 2 * B * rows * n),
        "int4_mm_t": (lambda: quant.int4_mm_t(wp, vb, ones, n),
                      lambda: quant.int4_mm_t_plain(wp, vb, n) * ones[:, None],
                      wp.numel() + B * rows + 4 * B + 4 * B * n, 2 * B * rows * n),
        "block_int8_mv": (lambda: quant.block_int8_mv(bq, rs, xs, idx),
                          lambda: quant.block_int8_mv_plain(bq, rs, xs, idx),
                          bq.numel() + 4 * rs.numel() + xs.numel() + 4 * idx.numel()
                          + 4 * n_br * bs, 2 * n_br * cb * bs * bs),
    }
    entries = {}
    for name, (call, plain, n_bytes, n_ops) in cases.items():
        got, want = call(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"mesh_quant_path: {name} parts from its plain version "
                                 f"(max |diff| {float((got - want).abs().max())})")
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS
        source = BLOCK_SOURCE if name == "block_int8_mv" else I4_SOURCE
        entries[name] = {
            "name": f"{name}[mesh_quant_path]", "route": "cuda", "source": source,
            "replaces": BLOCK_REPLACES if name == "block_int8_mv" else I4_TPU_KERNEL,
            "launches": 0, "max_abs_err": 0.0, "ms": cuda_ms(call, reps=200),
            "plain_ms": cuda_ms(plain, reps=10), "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
        emit({"phase": "mesh_quant_kernels", **entries[name],
              "rows": n_br * bs if name == "block_int8_mv" else rows, "bytes": n_bytes, "ops": n_ops,
              "library_ms_reason": "no PyTorch call computes this int4 / gathered int8 block "
                                   "product with its scales"})
    return entries


def mesh_quant_phase(dev) -> list:
    """Phase 51 (see the docstring).  Returns the kernels-line entries."""
    from rectipy_tpu_torch.testing import mesh_quant_turns

    t_phase = time.perf_counter()
    entries = mesh_quant_kernels(dev)
    tmp = tempfile.mkdtemp(prefix="mesh_quant_path_")
    try:
        reports = mesh_quant_turns(MQ_SIZES, tmp, world=MQ_MODEL, tol=MQ_TOL, timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    units = {"qif_sharded": (MQ_SIZES["epochs"], MQ_SIZES["qif_T"]),
             "int4_fit_bptt": (MQ_SIZES["epochs"], MQ_SIZES["int4_T"]),
             "int4_fit_bptt_batch": (1, MQ_SIZES["B_T"])}
    kernels = {"qif_sharded": ("block_int8_mv",), "int4_fit_bptt": ("int4_mv", "int4_mv_t"),
               "int4_fit_bptt_batch": ("int4_mm", "int4_mm_t")}
    lines = []
    for fit, rep in reports.items():
        epochs, T = units[fit]
        ms = {turn: min(rep[f"{turn}_s"]) / epochs * 1e3 for turn in ("plain", "mesh")}
        line = {"phase": "mesh_quant_path", "fit": fit,
                "mesh": {"model": MQ_MODEL, "data": 1, "backend": "gloo",
                         "ranks": "two processes on the one card"},
                "sizes": {k: v for k, v in MQ_SIZES.items()
                          if k.startswith(fit.split("_")[0]) or k in ("epochs", "B", "B_T")},
                "launches_per_rank": rep["launches"], "losses": rep["loss"],
                "bit_identical": rep["bit_identical"], "max_diffs": rep["diffs"],
                "limits": rep["limits"], "ranks_identical": True, "turns_identical": True,
                "steps_per_fit": epochs * T,
                "collectives_per_fit_by_rank": [{op: v for op, v in tally.items() if v["count"]}
                                                for tally in rep["tally"]],
                "fit_s": {"plain": rep["plain_s"], "mesh": rep["mesh_s"]},
                "plain_ms_per_epoch": ms["plain"], "mesh_ms_per_epoch": ms["mesh"],
                "mesh_over_plain": ms["mesh"] / ms["plain"],
                "note": "gloo stages every collective through the host: the mesh times are "
                        "no measure of NVLink collectives"}
        emit(line)
        lines.append(line)
        for k in kernels[fit]:
            entries[k]["launches"] = rep["launches"][f"{k}.launches"]
    emit({"phase": "mesh_quant_path", "summary": True, "nvidia_smi": nvidia_smi(),
          "mesh_over_plain": {ln["fit"]: ln["mesh_over_plain"] for ln in lines},
          "seconds": time.perf_counter() - t_phase})
    return list(entries.values())


def check_served(what: str, out_path: str, ref: list, served: dict, launches: dict) -> bool:
    """The served records (saved by the serving process) against the
    references' window means, bit for bit, and the served launch counts."""
    got = np.load(out_path)
    want = torch.stack(ref).cpu().numpy()
    if got.shape != want.shape or not served["finite"]:
        raise AssertionError(f"{what}: served {got.shape}, want {want.shape}, finite "
                             f"{served['finite']}")
    equal = bool(np.array_equal(got, want))
    counts = {k: served[k] for k in launches}
    if not equal or counts != launches:
        raise AssertionError(f"{what}: bit_identical {equal} (max |diff| "
                             f"{float(np.abs(got - want).max())}), launches {counts} (want "
                             f"{launches})")
    return equal


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rectipy_tpu_torch.ops._build import build, build_generated

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ------------------------------------------------------------- 2. build
    warm = ThreadPoolExecutor(1)  # torch.export's first trace, while nvcc runs
    warmed = warm.submit(export_warmup)
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

    emit({"phase": "export_warmup", "seconds": warmed.result()})
    warm.shutdown()
    return main_phases(dev)


def main_phases(dev) -> int:
    """Phases 29 and 3-51, the kernels line, the card's line and the
    contract line."""
    from rectipy_tpu_torch import Network, attach_fused_qif_step, random_connectivity
    from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step

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
    entry, timing10, int4_window = int4_phases(W_np, build_net)
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
    entries, fb_window = feedback_phase()
    kernels += entries
    entries, trials = batch_phases(dev, W_np, data, train_nu, int4_nu)
    kernels += entries
    torch.cuda.empty_cache()
    whole_brain_phase(dev)
    kernels += stp_feedback_phase(dev, fb_window)
    edge_family_check(dev)
    torch.cuda.empty_cache()
    timing = block_int8_check(dev)
    entries, block_net = sparse_scale_phase(dev, timing)
    kernels += entries
    kernels += block_delay_phase(dev)
    sparse_train_check(dev)
    torch.cuda.empty_cache()
    kernels += graph_train_phase(dev)
    graph_train_check(dev)
    torch.cuda.empty_cache()
    by_name = {e["name"]: e for e in kernels}
    kernels.append(spikes_inputs_phase(dev, W_np, etas, by_name["qif_sfa_step[bfloat16]"]))
    kernels.append(es_phase(dev, W_np, etas))
    kernels += multistart_phase(dev, data, trials, by_name)
    torch.cuda.empty_cache()
    kernels += stdp_phase(dev)
    kernels += block_stdp_phase(dev)
    kernels.append(plasticity_check(dev, build_net, by_name["qif_sfa_step[bfloat16]"]))
    torch.cuda.empty_cache()
    kernels += tooling_phases(dev, W_np, etas, build_net, {e["name"]: e for e in kernels},
                              block_net, int4_window)
    torch.cuda.empty_cache()
    kernels += mesh_phase(dev, build_net, {e["name"]: e for e in kernels})
    torch.cuda.empty_cache()
    kernels += mesh_train_phase(dev, build_net, data, trials, W_np, etas,
                                {e["name"]: e for e in kernels})
    torch.cuda.empty_cache()
    kernels += mesh_quant_phase(dev)

    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
