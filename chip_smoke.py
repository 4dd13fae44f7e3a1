#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from ``mf_data_locality_tpu_torch/csrc`` with nvcc;
3. compare each kernel with its plain PyTorch version on the same inputs,
   and time both beside the bound of its work: at the main paths' size
   (p=4, 2^13 cells, 1,635,075 DoFs) B1/B2 twostage + onthefly (f32 split2m
   — the tensor-core cell pass —, f32 highest and f64 — the sum-factorized
   pass with the metric rebuilt) and B3-B6 (f32 highest — the
   sum-factorized pass, B4's with the metric rebuilt —, f32 split2m except
   B4 — the tensor-core pass of B3/B5/B6 —, f64 highest); B1/B2 in each
   dense configuration of DENSE_RUNS at the p and s of its drive in phase
   5 (dense + precomputed under f32 and f64 highest — the sum-factorized
   pass, the metric streamed —, under f32 split2m at p=1, 3 — the dense
   tensor-core pass, the metric streamed —, dense + onthefly under f32
   split2m at p=2 and p=4 — the same pass, the metric rebuilt); then at
   every degree 5..11 under highest, f32 and f64, on a 105-cell box, each
   of B1-B6 (B1/B2 in every HIGH_FUSED configuration: twostage + the
   streamed metric, the metric rebuilt by jtj and by adjj, dense), and at
   the full-width points p=6 s=12 (2,738,019 DoFs) and p=8 s=11
   (3,244,995 DoFs) each kernel compared and timed in f32 (B1/B2 in the
   auto path's twostage + precomputed; also f64 at p=8); under f32 split2m
   B1/B2 in twostage (the tensor-core pass of cell_mma_hd.cuh; at p=4 with
   the metric rebuilt, cell_mma.cuh) compared at every degree 4..11 on the
   105-cell box in each configuration of SPLIT_HIGH (the metric rebuilt by
   jtj — the auto path's —, by adjj, and streamed), and compared and timed
   at p=6 s=12 and p=8 s=11 in the auto path's configuration; under the
   reduced rungs (REDUCED: split3 with an f32 state, bf16 with the bf16
   state and the bf16 metric stream; on the box also bf16 with an f32
   state) every kernel of theirs compared on the 105-cell box — B1/B2
   dense and B3/B5/B6 at p=1..4, B1/B2 twostage in each SPLIT_HIGH
   configuration at REDUCED_CMP —, B1/B2 in the fused auto path's
   configuration compared and timed at p=4 s=13 (bench.py's two variant
   configurations), p=6 s=12 and p=8 s=11, B3/B5/B6 at p=4 s=13; the
   dense tensor-core pass past p=4 (apply_mma_hd.cuh) under split2m,
   split3 and bf16 (DENSE_RUNGS; bf16 with the bf16 state and metric):
   B3/B5/B6 (B5 also on the merged solver's twostage operator) and B1/B2
   dense, the metric streamed and rebuilt, compared at every degree 5..11
   on the 105-cell box, and compared and timed at p=6 s=12 and p=8 s=11
   (B1/B2 in the fused solver's --factor dense configuration), with
   ``torch.matmul`` of the forward's bf16 product beside them under
   split2m;
4. convergence class at p=4, s=7: f64 "highest" must take 91 iterations —
   fused, merged (streamed metric and ``metric="onthefly"``) and baseline
   alike — f32 "split2m" (fused; merged with ``--windowing reshape``) and
   f32 "highest" (fused, merged, baseline) 91..94 and converge; and the
   fused solver through the auto-dispatch at the parity points of
   PARITY.md:91-123: f64 p=2 s=11 87 and p=4 s=7 91 (equal to the merged
   solver's), p=3 s=9 94..95 (on the tolerance's edge); f32 split2m p=2
   s=11 87..90, p=3 s=9 94..98 converged, or, where the rung's floor lies
   above the tolerance, at the cap within 10x the tolerance by the f64
   count with ``edge_witness`` showing the kernel's sums right; f32
   highest the f64 count + 0..3; at p=5 s=6 and p=6 s=4 f64 95 (94 on
   the tolerance's edge) and 75 for the fused auto path, the fused solver
   with the metric rebuilt (jtj, and adjj explicit), merged and baseline,
   f32 highest + 0..3 — or, for a fused solve at the cap, the f32
   recurrence's floor shown by ``stepped_readings`` (the kernel's scalars
   right, the f64 scalars carried converging); and at the same two points
   the fused solver under f32 split2m in each configuration of SPLIT_HIGH
   (the auto path first), the f64 count + 0..3, or at the cap with
   ``edge_witness``'s readings showing that floor; and PARITY_REDUCED
   (PARITY.md:91-96): the fused auto path under split3 at p=4 s=7, p=5
   s=6, p=6 s=4, under bf16 (bf16 state and metric) at p=6 s=4 and p=4
   s=7, and the merged solver under split3 at p=4 s=7; the merged solver
   under split2m (B3 on the dense tensor-core pass) at p=5 s=6 and p=6
   s=4, the f64 count + 0..3 (PARITY_SPLIT);
5. the paths, each with the kernels' launch counters zeroed just before and
   read just after:
   - the fused path ``benchmark.run_one(4, 13, solver="fused",
     precision="split2m", windowing="pieces")`` (B1, B2);
   - the JAX CLI's default path ``benchmark.run_one(4, 13,
     solver="merged", windowing="reshape", precision="highest")`` (B3);
   - the same path under f32 split2m ``benchmark.run_one(4, 13,
     solver="merged", windowing="reshape", precision="split2m")`` (B3 on
     the tensor cores);
   - the fused solver in each dense configuration of DENSE_RUNS at its p
     and s, through the auto-dispatch except split2m at p=4: at full width
     ``run_one(4, 13, solver="fused", windowing="pieces",
     precision="highest")`` (dense + precomputed) and ``run_one(2, 16, ...,
     precision="split2m")`` (dense + onthefly), the others short;
   - short runs at s=11 of the baseline solver (B3), ``--geometry
     onthefly`` (B4), ``--windowing pieces`` (B5) and ``zslab`` (B6),
     ``zslab`` under split2m (B6 on the tensor cores), and the fused solver
     under f32 highest (B1, B2 on the sum-factorized pass);
   - at p=6 s=12 and p=8 s=11 the JAX CLI's default path ``run_one(p, s,
     solver="merged", windowing="reshape", precision="highest")`` (B3)
     and the fused auto path ``run_one(p, s, solver="fused",
     windowing="pieces", precision="highest")`` (B1, B2), the fused solver
     in f64 at p=8 (short), and short runs of baseline, ``--geometry
     onthefly`` (B4), ``--windowing pieces`` (B5), ``zslab`` (B6) and the
     fused solver with the metric rebuilt (jtj); and at full depth the
     fused auto path under f32 split2m ``run_one(p, s, solver="fused",
     windowing="pieces", precision="split2m")`` (twostage + onthefly + jtj:
     B1, B2 on the tensor cores), printed beside the same point's highest
     auto path;
   - at every degree 5..11, s=6, short runs of each path, of the fused
     solver in every HIGH_FUSED configuration and, under split2m, in every
     SPLIT_HIGH configuration;
   - bench.py's split3 and bf16 lines at full depth, ``run_one(4, 13,
     solver="fused", windowing="pieces", precision="split3")`` and the
     same with ``dtype=torch.bfloat16, precision="bf16",
     metric_dtype=torch.bfloat16`` (B1, B2), each printed beside the
     split2m fused path; under each, short merged runs on reshape, pieces
     and zslab (B3, B5, B6), and the fused auto path short at p=6 s=12,
     p=8 s=11 and at every degree 5..11 (s=6);
   - the dense tensor-core pass: ``run_one(6, 12, solver="merged",
     precision="split2m")`` at full depth (B3), at p=6 s=12 and p=8 s=11
     under each rung short runs of merged reshape, pieces, zslab (B3, B5,
     B6) and the fused solver with ``factor="dense"`` (B1, B2), and at
     every degree 5..11 (s=6) under each rung merged reshape and the fused
     --factor dense, to p=8 also merged pieces and zslab and baseline on
     one windowing (reshape, pieces, zslab in turn);
   then (the checks of section 7 below) the solutions of the three p=4
   s=13 paths and of bench.py's two variant paths are checked for shape,
   finiteness, and their true residual against the solver's estimate;
6. print the kernels' JSON line (B1/B2 at f32 split2m, also with their f32
   highest and f64 times and, for each dense configuration, fields with
   its suffix — ``ms_dense``, ``launches_dense_split2m_p3``, ... — and its
   ``p_s``; B3-B6 at f32 highest, also with their f64 and (B3/B5/B6)
   split2m times; at p >= 5 fields with the suffix ``_p6``, ``_p8``
   (B1/B2 also ``_p8_f64``, and ``_split2m_p6``, ``_split2m_p8`` for the
   split2m auto path; ``_split3``, ``_bf16`` and with ``_p6``, ``_p8``
   for the reduced rungs; ``_dense_split2m_p6``, ``_dense_split3_p8``,
   ... for the dense tensor-core pass, B3's with ``matmul_ms``), each
   timed at the (p, s) of the drive that
   gives its launches; each row with the bound of its work on this card,
   from the shapes; B2 also with ``_prec_bf16``, ``_x_bf16`` and with
   ``_p6`` for section 7's runs, each beside ``ms_f32...``, the same
   run's kernel with P and x at f32), the build time and the script's
   wall time, and, last, the device JSON line;
7. run in phase 5, before its solutions' check: B2 with the
   preconditioner or x stored in bf16 (``prec_dtype``, ``x_dtype``;
   ``csrc/cg_fused_px.cu``) at STORAGE_RUNS — the production command's
   configuration at p=4 s=13 (split2m twostage + onthefly) and the auto
   path under highest at p=6 s=12 (twostage + the streamed metric): with
   x in bf16 g', d', h' and the scalars bitwise equal to the f32-x kernel
   run's and x' within one bf16 step of the plain version, with P in bf16
   the kernel against the plain version at TOL and the plain version with
   P unrounded (the control) outside it, both timed beside the f32 run and
   the bound with P or x at 2 bytes, and the fused solver driven through
   ``run_one(..., prec_dtype=, x_dtype=)`` at both points (x: the f32
   run's itCG; P: within 3); the structured and general backends at p=4
   s=13 (f32, f64): vmult against B3 (TOL_BACKEND), then ``run_one(4, 13,
   solver="merged"|"baseline", backend=...)``, the f64 itCG equal to the
   pallas path's, their rows printed; and the discretization: the
   manufactured solution solved in f64 by the merged CG through B3 at
   CONVERGENCE, the observed L2 rates >= (p + 1) - 0.35;
8. the distributed solvers (``parallel/``; ranks are processes on this
   card, joined by gloo): B2's block form (``csrc/cg_fused_block.cu``
   ``bp4_fused_iteration_block``: the Dirichlet faces by global position
   on all three axes, every ghost face filled, raw sums over the owned
   nodes, the carries) against its plain version on z-slabs (blocks of a
   (3,) mesh: one with a halo plane, one with a dummy layer) and on the
   BLOCK_CASES blocks, at p=4 and 6 under f64 and f32 highest, split2m,
   split3 and bf16 (with its state and controls), both metrics; each timed on a rank's part of its
   full width beside the unchanged B2 on a box of the same cells (fields
   ``*_slab``, ``*_slab_f64``, ``*_block2d``, ``*_block3d`` and their
   ``_f64``, ``ms_box_...``); f64 parity at p=4 s=7 on 2 and 3 z-slab
   ranks and on the (2, 2) and (2, 2, 2) meshes (fused, merged reshape,
   baseline: itCG 91 and x against the same solver on one device,
   TOL_DIST_X) with every rank's collectives counted; at the full width, 4
   ranks at p=4 s=15 (6,440,067 DoFs) — z-slabs: the merged reshape f32
   highest, fused split2m and fused split2m onthefly solves; the (2, 2)
   mesh: merged and fused split2m — and the (2, 2, 2) mesh at p=4 s=16
   (12,830,211 DoFs, 8 ranks, fused split2m onthefly), each with its row,
   collectives per iteration, the slowest rank's host seconds, launches
   (``launches_slab``, ``launches_dist``, ``launches_block2d``,
   ``launches_block3d``) and true residual, beside the single-device
   fused split2m path at s=15 (auto, and dense with the streamed metric);
   and ``dryrun_multichip(4)``'s and ``(8)``'s legs (1-8, in the
   same spawns as the 4- and 8-rank drives; B2's launches in each fused
   leg, ``launches_dryrun``); section 8's wall time.  The overlap (PR
   15): B2's layer-range form (``bp4_fused_iteration_block``'s cell pass
   over a range of cells, then its node passes) bitwise against the one
   launch and against its plain version on rank 1 of the 4 z-slabs at p=4
   s=15 and at p=6 s=12 (f64 and f32 highest, split2m dense; the metric
   streamed and rebuilt), timed at p=4 s=15 beside the one launch (the
   ``fused_cg_iteration_range`` row); B3/B5/B6 on the overlapped apply's
   layer ranges against their plain versions; at p=4 s=15 on 4 ranks the
   CLI's merged reshape f32 highest with ``--overlap`` and
   ``solve_fused(overlap=True)`` split2m dense beside the same solves
   without it in the same spawn (fused: x and history bitwise; merged:
   itCG equal, x within TOL_OVERLAP_X32), each rank's face wait an
   iteration with and without; ``--backend general --devices 4`` at p=4
   s=12 and dry-run leg 4 (the general backend, plain PyTorch); in the
   4-rank spawn also the bf16 state's solves: the CLI's merged
   solve with ``--dtype bf16`` (its count the single-device bf16 solve's,
   the JAX package's claim) and the fused solve under highest (C10's f32
   carry; within 2 of one device's);
9. bf16 storage (``utils/bf16_state_check.py``): every storage
   instantiation — the bf16 state on every rung (B1-B6; the cell passes'
   ``kSbState`` forms, B5/B6's bf16 assemble), the bf16 metric under
   highest and split2m (``kSbMetric``) — against its plain version on the
   105-cell box at p=1..5, 8, 11 with its control (the same apply without
   the bf16 store, the unrounded-d' scalars, the f32 metric), C10's f32
   carry on a z-slab (the face as stored, the control); each TIMED row at
   p=4 s=13 beside its plain version and its bound (2-byte state words;
   fields ``*_bf16state``, ``*_bf16metric``, ... of B2, B3, B5, B6), and
   the drives of B16_DRIVES: at full depth the JAX CLI's default with
   ``--dtype bf16`` (``run_one(4, 13, solver="merged",
   windowing="reshape", precision="highest", dtype=torch.bfloat16)``, B3)
   and the fused solver with a bf16 state under highest, short the others.
   The every-degree runs of phase 5 skip, at p=6 and p=8, the paths that
   the FULL_HIGH drives run there (FULL_DRIVEN);
10. the tensor-core rungs on every factorization and chain
   (``utils/tensor_rungs_check.py``): on the 105-cell box under split2m,
   split3 and bf16 (with the bf16 state and metric) B1/B2 twostage at
   p=1..3 with the metric streamed, rebuilt by adjj and by jtj
   (``cell_mma_hd.cuh``, ``cell_mma_p01.cu`` .. ``p03.cu``), B1/B2 dense
   with the metric rebuilt by jtj at p=1..5, 8, 11 (``mma_jtj.cu`` to
   p=4, ``apply_mma_pNN.cu`` from p=5), each with B2's P/x forms, and B5
   on the twostage operator at p=2, 4, against their plain versions
   (bf16: the controls that must miss); their storage forms in section 9;
   tensor_rungs_check.TIMED's rows timed beside their plain versions and
   bounds (fields ``*_twostage_split2m_p3``,
   ``*_auto_split2m_p3``, ``*_dense_jtj_split2m``, ``*_dense_adjj_split2m``
   of B1/B2); the fused solver with ``--factor twostage --precision
   split2m`` at p=3 s=14 at full depth and at the parity point p=3 s=9
   (the f64 count 94..95 + 0..3, or C8's cap with ``edge_witness``), and
   short drives of TS_DRIVES: the JAX CLI's ``--factor twostage`` at
   p=1..3 and ``--factor dense --geometry onthefly --cofactor jtj`` at
   p=4 under every tensor-core rung, and the merged solver's ``--factor
   twostage --windowing pieces`` at p=2, 4 (B5);
11. the shapes beyond BP4's, CEED BP3 (one component) and q = p + 1
   (``utils/shape_check.py``, ``csrc/shapes.cu``): the shape
   instantiations' registers and spills; on the 105-cell box at every
   degree 1..11, for BP3, q = p + 1 and both, B3-B6 and B1/B2 (dense and
   twostage, the metric streamed or rebuilt by adjj or jtj) under f32 and
   f64 highest and f32 split2m against their plain versions;
   shape_check.TIMED's rows timed beside their plain versions and bounds
   (fields ``*_bp3_p4``, ``*_bp3_p6``, ``*_q1_p4`` of B1-B6); the drives
   of SHAPE_DRIVES through ``run_one(problem=)`` — BP3 at p=4 s=15
   (2,146,689 DoFs) on the JAX CLI's default path (merged, reshape, f32
   highest: B3) and the production command (fused, split2m, pieces:
   B1/B2), BP3 at p=6 s=14 (3,613,153 DoFs) on the production command,
   q = p + 1 at p=4 s=13 (1,635,075 DoFs) on both, at full depth, and
   B4, B5, B6 short —; and the parity points of SHAPE_PARITY (f64 merged
   and fused: the JAX package's itCG exactly; f32 split2m fused + 0..3,
   or C8's cap with ``edge_witness``);
12. the JAX package's modules without a Pallas kernel, plain PyTorch in
   the port (``utils/modules_check.py``), at full width: the mass
   operator, CEED BP2 and BP1 at p=4 s=13 (1,635,075 and 545,025 DoFs;
   1^T M 1 = 2 to 1e-10 in f64, the card against the CPU to 1e-12, the
   f32 error, vmult times); the general hex mesh, an L-shaped prism of
   6,144 cells at p=4 (1,235,715 DoFs; vmult card vs CPU, a merged CG
   with the Jacobi preconditioner timed); the 2D operator on 256 x 512
   cells at p=4 (4,200,450 DoFs; vmult2d card vs CPU, 100 merged CG
   iterations); and ``profiling.trace`` with ``marker("cg_solver")``
   around 5 fused split2m iterations at p=4 s=13, ``trace_summary.
   top_ops`` listing B2's three kernels, its B2 time within 10% of
   ``kernel_breakdown``'s.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import torch

DEGREE, S, S_SHORT = 4, 13, 11
CSRC = "mf_data_locality_tpu_torch/csrc/"
# tolerances of kernel vs plain version (max |diff| / max |plain|): the two
# sum in different orders; f32 sums of ~2e2-term (B1/B2) and ~6e2-term
# (B3-B6) contractions and, for the scalars, of ~5e6 dot-product terms
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
TOL_SCAL_F32 = 1e-4
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, f32 and
# f64 CUDA cores, HBM3
PEAK_BF16, PEAK_F32, PEAK_F64, HBM_BPS = 989e12, 67e12, 34e12, 3.35e12
METRIC_FMA = 117  # adjj rebuild per q-point: J 72, adjugate 21, entries 24
# jtj rebuild per q-point: J 72, C = J^T J 18, adj(C) 12, det C 3, scale 7
METRIC_FMA_JTJ = 112
# the fused solver's configuration at p=4 under split2m (B1, B2), and its
# dense configurations (the auto-dispatch's under highest, and at p=2 under
# split2m)
FUSED = dict(factor="twostage", metric="onthefly", windowing="pieces")
DENSE_PRE = dict(factor="dense", metric="precomputed", windowing="pieces")
DENSE_OTF = dict(factor="dense", metric="onthefly", windowing="pieces")
# B1/B2 in the dense configurations: (dtype, precision, configuration, p, s,
# key suffix in the kernels line).  Phase 3 compares and times each at its
# p and s; phase 5 drives the fused solver in the same configuration at the
# same p and s, and that drive's counts are the row's launches.  The first
# two are the auto-dispatch's full-width paths; "_dense_split2m_p4" is
# explicit (split2m auto at p=4 is twostage), the others auto.
DENSE_RUNS = ((torch.float32, "highest", DENSE_PRE, 4, S, "_dense"),
              (torch.float32, "split2m", DENSE_OTF, 2, 16, "_dense_split2m"),
              (torch.float64, "highest", DENSE_PRE, 4, S, "_dense_f64"),
              (torch.float32, "split2m", DENSE_OTF, 4, S, "_dense_split2m_p4"),
              (torch.float32, "split2m", DENSE_PRE, 1, S_SHORT,
               "_dense_split2m_p1"),
              (torch.float32, "split2m", DENSE_PRE, 3, S_SHORT,
               "_dense_split2m_p3"),
              (torch.float64, "highest", DENSE_PRE, 1, S_SHORT, "_dense_f64_p1"),
              (torch.float64, "highest", DENSE_PRE, 3, S_SHORT, "_dense_f64_p3"))
FULL_WIDTH = ("_dense", "_dense_split2m")
# B1/B2 runs of phase 3: the twostage + onthefly ones fill the row's own
# fields (split2m) and its "_highest" and "_f64" ones
FUSED_RUNS = ((torch.float32, "split2m", FUSED, DEGREE, S, ""),
              (torch.float32, "highest", FUSED, DEGREE, S, "_highest"),
              (torch.float64, "highest", FUSED, DEGREE, S, "_f64"),
              *DENSE_RUNS)
# degrees 5..11 (the reference's table past p=4), "highest" f32 and f64:
# phase 3 compares every kernel with its plain version at each degree on
# the RAGGED box (105 cells, not a multiple of a block's cells), B1/B2 in
# each (factor, metric, cofactor) of HIGH_FUSED — the auto path's, the
# metric rebuilt by either chain, the dense factorization
HIGH_DEGREES = tuple(range(5, 12))
RAGGED = (3, 5, 7)
HIGH_FUSED = (("twostage", "precomputed", "adjj"),
              ("twostage", "onthefly", "jtj"),
              ("twostage", "onthefly", "adjj"),
              ("dense", "precomputed", "adjj"))
# the full-width points of p >= 5 ((p+1)^3 2^s 3 < 6e6, the ladder's top):
# (p, s, key suffix in the kernels line); p=6 runs the layout of p <= 6,
# p=8 that of fewer cells a block.  Every kernel is timed there, and the
# fused solver also in f64 at p=8
FULL_HIGH = ((6, 12, "_p6"), (8, 11, "_p8"))
FULL_DOFS = {6: 2_738_019, 8: 3_244_995}
F64_HIGH = 8
S_EVERY = 6  # phase 5's short runs of every path at every degree 5..11
# the paths of those runs that the FULL_HIGH drives run at their degrees
# (merged and baseline on each windowing, B4, the fused auto paths and
# the fused solver with the metric rebuilt by jtj), not run again there
FULL_DRIVEN = ("merged reshape", "baseline", "merged onthefly",
               "merged pieces", "merged zslab",
               "fused twostage precomputed adjj",
               "fused twostage onthefly jtj",
               "fused split2m twostage onthefly jtj")
# parity points at p >= 5 (PARITY.md:91-123): (p, s, f64 itCG allowed).
# p=5 s=6 sits on the tolerance's edge: the JAX merged residual at
# iteration 94 is 1.026e-8 res0, 2.6% above the tolerance, and by then CG
# has amplified rounding to a few percent of the residual (the JAX
# package's own structured and Pallas backends differ by 1.4e-2 at
# iteration 90), so another summation order may stop at 94
PARITY_HIGH = ((5, 6, (94, 95)), (6, 4, (75,)))
# f32 split2m past p=4: B1/B2 in twostage on the tensor cores
# (csrc/cell_mma_hd.cuh; at p=4 the rebuilt metric on cell_mma.cuh), in
# each (metric, cofactor) of SPLIT_HIGH — the auto path's jtj first, adjj,
# the streamed metric —, compared at every degree of SPLIT_CMP on the
# RAGGED box, timed and driven at FULL_HIGH in the auto path's
# configuration, driven short at every degree 5..11, and checked for itCG
# at PARITY_SPLIT: (p, s, f64 itCG), split2m + 0..3
SPLIT_HIGH = (("onthefly", "jtj"), ("onthefly", "adjj"),
              ("precomputed", "adjj"))
SPLIT_CMP = (4,) + HIGH_DEGREES
PARITY_SPLIT = ((5, 6, 95), (6, 4, 75))
# the reduced rungs: (precision, state dtype, metric dtype, key suffix) —
# split3 with an f32 state (bench.py's split3 line), bf16 with the bf16
# state and the bf16 metric stream (bench.py's bf16 line).  Phase 3
# compares every kernel of theirs with its plain version on the RAGGED box
# at p=1..4 (B1/B2 dense, B3/B5/B6) and at REDUCED_CMP (B1/B2 twostage in
# each SPLIT_HIGH configuration), and compares and times B1/B2 in the auto
# path's configuration at p=4 s=13 and at FULL_HIGH, B3/B5/B6 at p=4 s=13;
# phase 4 checks PARITY_REDUCED; phase 5 drives them.  bf16 vectors are
# held to TOL_BF16 (relative L2, max): a t value the two sum in another
# order can round to the other side of a bf16 boundary, 2^-8 of it.  The
# L2 limit lies between the readings of the rung (kernel vs plain up to
# 7.8e-5 at p=4 s=13) and of its control, split2m's product set in place
# of bf16's (3.6e-4 .. 2.6e-3 on the RAGGED box, the plain versions on the
# CPU), which every bf16 comparison here reads too and which must exceed
# it; a max limit cannot tell them apart (5.3e-3 against 1.5e-3).  The
# scalars: kernel and plain sum the same stored values in another order
# (<= 4.8e-6 on the box); sums over the unrounded d' (skipping the rounding
# point, cg_fused_kernel.py:856) move them by 7e-6..3e-3 on random inputs,
# so utils/bf16_check.rounding_point builds inputs on which they move by
# 2.9e-3 or more (the plain versions on the CPU, every degree of the box)
REDUCED = (("split3", torch.float32, None, "_split3"),
           ("bf16", torch.bfloat16, torch.bfloat16, "_bf16"))
REDUCED_CMP = (4, 5, 8, 11)
TOL_BF16 = (3e-4, 1e-2)
TOL_SCAL_BF16 = 1e-4
# the bf16 full-width solution's |b - A x| against the plain version's
# (relative; both carry the t rounding's noise in x, nearly the same)
TOL_BF16_TRUE = 5e-2
# PARITY.md:91-96: (p, s, rung, itCG allowed; None: bf16 at p=4 s=7, which
# may reach the cap, its final residual <= 1e-4 res0); merged split3 at p=4
# s=7 is the f64 count + 0..3
PARITY_REDUCED = ((4, 7, "split3", range(91, 96)),
                  (5, 6, "split3", range(95, 99)),
                  (6, 4, "split3", range(75, 79)),
                  (6, 4, "bf16", range(1, 101)),
                  (4, 7, "bf16", None))


# the tensor-core rungs' dense pass past p=4 (csrc/apply_mma_hd.cuh, one
# source a degree and rung, apply_mma_pNN.cu): (precision, B1/B2's state
# dtype, metric dtype, key suffix).  Phase 3 compares B3/B5/B6 (B5 also on
# the twostage operator of the merged solver's --windowing pieces) and
# B1/B2 dense (the metric streamed and rebuilt) with their plain versions
# at every degree 5..11 on the RAGGED box under each, bf16 with the bf16
# state and metric at TOL_BF16 (its control must miss), and times them at
# FULL_HIGH, split2m in full and split3 and bf16 short (DENSE_INNER);
# phase 4 checks the merged solver under split2m at PARITY_SPLIT; phase 5
# drives the merged solver under split2m at p=6 s=12 at full depth, the
# timed kernels' paths short at FULL_HIGH, and merged/baseline on every
# windowing and the fused solver's --factor dense short at every degree
# 5..11 on every rung (the last two paths only from p=9)
DENSE_RUNGS = (("split2m", torch.float32, None, "_dense_split2m"),
               ("split3", torch.float32, None, "_dense_split3"),
               ("bf16", torch.bfloat16, torch.bfloat16, "_dense_bf16"))
DENSE_INNER = {"split2m": 10, "split3": 3, "bf16": 3}
WINDOWINGS_EVERY = ("reshape", "pieces", "zslab")
WINDOWED_KERNEL = {"reshape": "apply_local_batched_g",
                   "pieces": "apply_lattice_pieces",
                   "zslab": "apply_lattice_zslab"}
DENSE_MAIN = (6, 12)  # the merged split2m drive at full depth


# bf16 storage (section 9): the drives of the timed storage
# instantiations, their counts the rows' launches{suffix} — (label, s,
# kernels, key suffix, run_one's keywords): at full depth the JAX CLI's
# default with --dtype bf16 (B3) and the fused solver with a bf16 state
# under highest (B1, B2); short (S_SHORT) merged and baseline with a bf16
# state on pieces and zslab (B5, B6) and under split2m and split3 (B3),
# the bf16 metric under highest and split2m (B3; B1/B2 dense, the metric
# streamed) and the fused solver with a bf16 state under split2m
BF = torch.bfloat16
B16_DRIVES = (
    ("main path, bf16 state (merged, reshape, f32 highest)", S,
     ("apply_local_batched_g",), "_bf16state",
     dict(solver="merged", windowing="reshape", precision="highest",
          dtype=BF)),
    ("fused, bf16 state, highest", S, ("matvec", "fused_cg_iteration"),
     "_bf16state", dict(solver="fused", windowing="pieces",
                        precision="highest", dtype=BF)),
    ("merged pieces, bf16 state", S_SHORT, ("apply_lattice_pieces",),
     "_bf16state", dict(solver="merged", windowing="pieces", dtype=BF)),
    ("baseline zslab, bf16 state", S_SHORT, ("apply_lattice_zslab",),
     "_bf16state", dict(solver="baseline", windowing="zslab", dtype=BF)),
    ("merged reshape, bf16 state, split2m", S_SHORT,
     ("apply_local_batched_g",), "_bf16state_split2m",
     dict(solver="merged", precision="split2m", dtype=BF)),
    ("baseline reshape, bf16 state, split3", S_SHORT,
     ("apply_local_batched_g",), "_bf16state_split3",
     dict(solver="baseline", precision="split3", dtype=BF)),
    ("fused, bf16 state, split2m", S_SHORT, ("matvec", "fused_cg_iteration"),
     "_bf16state_split2m", dict(solver="fused", windowing="pieces",
                                precision="split2m", dtype=BF)),
    ("merged reshape, bf16 metric", S_SHORT, ("apply_local_batched_g",),
     "_bf16metric", dict(solver="merged", metric_dtype=BF)),
    ("merged reshape, bf16 metric, split2m", S_SHORT,
     ("apply_local_batched_g",), "_bf16metric_split2m",
     dict(solver="merged", precision="split2m", metric_dtype=BF)),
    ("fused dense, bf16 metric", S_SHORT, ("matvec", "fused_cg_iteration"),
     "_bf16metric", dict(solver="fused", windowing="pieces", factor="dense",
                         metric="precomputed", metric_dtype=BF)),
    ("fused dense, bf16 metric, split2m", S_SHORT,
     ("matvec", "fused_cg_iteration"), "_bf16metric_split2m",
     dict(solver="fused", windowing="pieces", precision="split2m",
          factor="dense", metric="precomputed", metric_dtype=BF)),
)
# section 10: the timed rows' sources (tensor_rungs_check.TIMED's
# suffixes) and the drives whose counts are their launches (the adjj row's
# is DENSE_RUNS' "_dense_split2m_p4", the same configuration); the fused
# solver with --factor twostage under split2m at the full-width point
# p=3 s=14 ((p+1)^3 2^s 3 = 3.1M) at full depth, the auto path there short
TS_SOURCE = {"_twostage_split2m_p3": "cell_mma_p03.cu",
             "_auto_split2m_p3": "apply_mma.cuh",
             "_dense_jtj_split2m": "mma_jtj.cu",
             "_dense_adjj_split2m": "apply_mma.cuh"}
TS_FULL = (3, 14)
TS_PARITY = (3, 9, range(94, 99))
# (label, p, s, kernels, key of the launches or None, run_one's keywords):
# the fused solver's --factor twostage at p=1..3 under each rung (split2m
# its resolved metric and chain, split3 the metric rebuilt by jtj, bf16
# streamed), the dense jtj row's launches at its timed point, B5's on the
# twostage operator those of the p=4 drive
TS_DRIVES = (
    *((f"fused --factor twostage{''.join(f' {v}' for v in kw.values())}, "
       f"{rung}",
       p, S_SHORT, ("matvec", "fused_cg_iteration"), None,
       dict(solver="fused", windowing="pieces", precision=rung,
            factor="twostage", **kw))
      for rung, kw in (("split2m", {}),
                       ("split3", dict(metric="onthefly", cofactor="jtj")),
                       ("bf16", dict(metric="precomputed")))
      for p in (1, 2, 3)),
    *((f"fused --factor dense --geometry onthefly --cofactor jtj, {rung}",
       4, S if rung == "split2m" else S_SHORT,
       ("matvec", "fused_cg_iteration"),
       "_dense_jtj_split2m" if rung == "split2m" else None,
       dict(solver="fused", windowing="pieces", precision=rung,
            factor="dense", metric="onthefly", cofactor="jtj"))
      for rung in ("split2m", "split3", "bf16")),
    *(("merged --factor twostage --windowing pieces, split2m", p, S_SHORT,
       ("apply_lattice_pieces",), "_twostage_pieces",
       dict(solver="merged", windowing="pieces", precision="split2m",
            factor="twostage"))
      for p in (2, 4)),
)
# section 11, the shapes beyond BP4's (queue B 6g): the drives through
# run_one(problem=) — (label, key of the launches, components, q - p, p,
# s, kernels, full depth, run_one's keywords) — at full depth the JAX
# CLI's default path and the production command at the full-width points
# ((p+1)^3 2^s C < 6e6: BP3 p=4 s=15, p=6 s=14; q = p + 1 p=4 s=13),
# short (S_SHORT + 2 for BP3, S_SHORT for q = p + 1) B4, B5, B6
_MAIN = dict(solver="merged", precision="highest", windowing="reshape")
_PROD = dict(solver="fused", precision="split2m", windowing="pieces")
_B12 = ("matvec", "fused_cg_iteration")
SHAPE_DRIVES = (
    ("BP3 main path (merged, f32 highest, reshape)", "_bp3_p4", 1, 2, 4,
     15, ("apply_local_batched_g",), True, _MAIN),
    ("BP3 production (fused, f32 split2m, pieces)", "_bp3_p4", 1, 2, 4, 15,
     _B12, True, _PROD),
    ("BP3 production (fused, f32 split2m, pieces)", "_bp3_p6", 1, 2, 6, 14,
     _B12, True, _PROD),
    ("q=p+1 main path (merged, f32 highest, reshape)", "_q1_p4", 3, 1, 4,
     S, ("apply_local_batched_g",), True, _MAIN),
    ("q=p+1 production (fused, f32 split2m, pieces)", "_q1_p4", 3, 1, 4, S,
     _B12, True, _PROD),
    *((f"{tag} {solver} {k}", key, c, dq, 4, s, (name,), False,
       dict(solver=solver, precision="highest", windowing=w, **kw))
      for tag, key, c, dq, s in (("BP3", "_bp3_p4", 1, 2, S_SHORT + 2),
                                 ("q=p+1", "_q1_p4", 3, 1, S_SHORT))
      for k, name, solver, w, kw in (
          ("--geometry onthefly", "apply_local_batched_onthefly", "merged",
           "reshape", dict(metric="onthefly")),
          ("--windowing pieces", "apply_lattice_pieces", "merged", "pieces",
           {}),
          ("--windowing zslab", "apply_lattice_zslab", "baseline", "zslab",
           {}))),
)
SHAPE_FULL = {"_bp3_p4": 2_146_689, "_bp3_p6": 3_613_153,
              "_q1_p4": 1_635_075}
# the timed rows' sources: B3-B6 under highest and B1/B2 in the
# production configuration (twostage: cell_mma_hd.cuh at every degree)
SHAPE_SOURCE = "shapes.cu"
# the parity points: (p, s, components, q - p, the JAX package's f64
# itCG, PARITY.md's protocol)
SHAPE_PARITY = ((4, 7, 1, 2, 93), (2, 9, 1, 2, 50), (4, 7, 3, 1, 91),
                (2, 9, 3, 1, 49))
# the sources of section 9's timed rows (at p=4: the sum-factorized
# pass's storage instantiations under highest, the dense tensor-core
# pass's under split2m; B2's split2m auto configuration at p=4 with a
# bf16 state, the bf16 rung's dispatch, is dense)
B16_SOURCE = {
    ("apply_local_batched_g", "_bf16state"): "sumfac_sb.cu",
    ("apply_lattice_pieces", "_bf16state"): "sumfac_sb.cu",
    ("apply_lattice_zslab", "_bf16state"): "sumfac_sb.cu",
    ("apply_local_batched_g", "_bf16metric"): "sumfac_sb.cu",
    ("apply_local_batched_g", "_bf16metric_split2m"): "mma_sb.cu",
    ("fused_cg_iteration", "_bf16state"): "sumfac_sb.cu",
    ("fused_cg_iteration", "_bf16state_split2m"): "mma_sb.cu",
    ("fused_cg_iteration", "_bf16metric"): "sumfac_sb.cu",
    ("fused_cg_iteration", "_bf16metric_split2m"): "mma_sb.cu",
}


def sumfac_fma(p: int, q: int, n_comp: int = 3) -> int:
    """FMAs of the sum-factorized apply a cell, ``n_comp`` components (BP4
    3, BP3 1): forward x pass (S, D), y pass (3), z pass (3), and the same
    backward."""
    p1 = p + 1
    return n_comp * 2 * (2 * p1 ** 3 * q + 3 * p1 ** 2 * q ** 2
                         + 3 * p1 * q ** 3)


def bound(name: str, op, split: bool, state: torch.dtype | None = None,
          prec_word: int | None = None, x_word: int | None = None,
          n_comp: int = 3) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for the
    kernel's work on ``op``'s shapes — the larger of its bytes (inputs read
    once, outputs written once) over HBM_BPS and its operations over the
    peak of their type (under a tensor-core rung the products on the
    tensor cores in bf16, counting each of the rung's products a tile —
    split3 3, split2m 2, bf16 1 —, the rest in f32; else all at the
    working type).  The products: under a tensor-core rung the dense count
    (B3-B6, B1/B2 dense) or twostage's 2D stage (B1/B2 twostage), because
    the rung's rounding of those entries defines that function; under
    highest the sum-factorized count, the least work for the function.
    The metric: 6 q^3 words a cell streamed, at its storage's size (bf16:
    2 bytes), or 24 coefficient words a cell and its rebuild's FMAs
    (B1/B2: by their chain, adjj or jtj; B4: adjj).  ``state``: B1/B2's d
    and h storage, the apply family's u and v (bf16: 2 bytes each read and
    written); ``prec_word``,
    ``x_word``: B2's bytes a value of P and of x (prec_dtype, x_dtype).
    ``n_comp``: the vectors' components (BP4 3, BP3 1): the vectors' bytes
    and the operations scale with it, the metric's do not."""
    p, q, nc = op.degree, op.n_q, op.n_cells
    c = n_comp
    nz, ny, nx = op.n_nodes_axis
    nn, p13, q3 = nz * ny * nx, (p + 1) ** 3, q ** 3
    word = op.dtype.itemsize
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    n_prod = laplace_cuda.RUNG_PRODUCTS[op.precision]
    mword = op.metric_dtype.itemsize
    sword = (state or op.dtype).itemsize
    if name in ("matvec", "fused_cg_iteration"):
        rebuilt = op.gmetric is None
        if split and op.factor == "twostage":  # the 2D stage, tensor cores
            products = c * q * 2 * 3 * q * q * (p + 1) ** 2
            other = c * (4 * q * p13 + 9 * q3)
        elif split:  # the dense M on the tensor cores
            products = 2 * 3 * c * q3 * p13
            other = 9 * c * q3
        else:
            products = sumfac_fma(p, q, c)
            other = 9 * c * q3
        other += ((METRIC_FMA_JTJ if op.cofactor == "jtj" else METRIC_FMA)
                  * q3 if rebuilt else 0)
        # B1: d read, h written; B2: x, g, d, h read, P, x', g', d', h'
        nbytes = (2 * c * nn * sword if name == "matvec"
                  else 2 * c * nn * word + nn * (prec_word or word)
                  + 2 * c * nn * (x_word or word) + 4 * c * nn * sword)
        nbytes += 24 * nc * word if rebuilt else 6 * q3 * nc * mword
    else:  # the apply family; metric streamed, or rebuilt (B4)
        products = (2 * 3 * c * q3 * p13 if split
                    else sumfac_fma(p, q, c))
        onthefly = name == "apply_local_batched_onthefly"
        other = 9 * c * q3 + (METRIC_FMA * q3 if onthefly else 0)
        # u read and v written at the state's size (bf16: 2 bytes)
        nbytes = ((2 * c * p13 * nc if name.startswith("apply_local")
                   else 2 * c * nn)
                  * sword + ((24 * nc if onthefly else 0)
                             + (nn if name == "apply_lattice_zslab" else 0))
                  * word)
        nbytes += 0 if onthefly else 6 * q3 * nc * mword
    t_bytes = nbytes / HBM_BPS
    if split:
        t_ops = max(2 * n_prod * products * nc / PEAK_BF16,
                    2 * other * nc / PEAK_F32)
    else:
        peak = PEAK_F32 if op.dtype == torch.float32 else PEAK_F64
        t_ops = 2 * (products + other) * nc / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b| / max |b|, max |a - b|)."""
    diff = (a - b).abs().max().item()
    return diff / b.abs().max().item(), diff


def check(name: str, err: float, tol: float, quiet: bool = False) -> None:
    if not quiet:
        print(f"  {name}: max rel err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"({err:.3e} > {tol:.0e})")


def random_state(op, n: int, seed: int, n_comp: int = 3):
    gen = torch.Generator(device=op.device).manual_seed(seed)
    shape = (n_comp,) + op.n_nodes_axis
    return [(torch.randn(shape, generator=gen, device=op.device,
                         dtype=op.dtype) * op.mask).contiguous()
            for _ in range(n)]


def time_pair(kern, plain, dev, timing, inner: int = 20):
    """(kernel ms, plain ms): alternate plain, kernel, kernel, plain (the
    plain version, a yardstick of ms where the kernel takes µs, 2 x 2
    calls a side)."""
    tp1 = timing.time_per_call(plain, dev, inner=2, repeats=2)
    tk1 = timing.time_per_call(kern, dev, inner=inner, repeats=3)
    tk2 = timing.time_per_call(kern, dev, inner=inner, repeats=3)
    tp2 = timing.time_per_call(plain, dev, inner=2, repeats=2)
    return min(tk1, tk2) * 1e3, min(tp1, tp2) * 1e3


def stepped_solve(op, b, prec, carry64: bool) -> tuple[list, float]:
    """The fused solve's loop (``cg_fused.fused_merged_cg_solve``), stepped
    here with the 7 update3b sums recomputed in f64 from each iteration's
    vectors: (residual estimate / res0 by iteration, the largest relative
    error of the kernel's alpha, beta and res2 against the scalars from the
    f64 sums).  ``carry64``: those scalars go on in place of the kernel's."""
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk

    P = prec[:1].contiguous()
    g0 = (-(b * op.mask)).contiguous()
    res0 = torch.sqrt(torch.sum(g0 * g0)).item()
    scal = torch.zeros((8,), dtype=op.dtype, device=op.device)
    scal[4] = 1.0
    state = (torch.zeros_like(g0), g0, torch.zeros_like(g0),
             torch.zeros_like(g0), scal)
    spare = tuple(torch.empty_like(t) for t in state)
    work = fk.Workspace(op, b.shape[0])
    hist, err, pick = [1.0], 0.0, [0, 1, 5]
    for _ in range(100):
        _, g, d, h, new = fk.fused_cg_iteration(op, *state, P, out=spare,
                                                work=work)
        g, d, h, p64 = (t.double() for t in (g, d, h, P))
        s = torch.stack([torch.sum(d * h), torch.sum(h * h),
                         torch.sum(g * h), torch.sum(g * g),
                         torch.sum(g * p64 * h), torch.sum(h * p64 * h),
                         torch.sum(g * p64 * g),
                         torch.zeros((), dtype=torch.float64, device=g.device)])
        old = state[4].double()
        ref = fk.scalar_recurrence(s, old[0], old[1], old[4])
        err = max(err, ((new.double() - ref)[pick].abs()
                        / ref[pick].abs()).max().item())
        if carry64:
            new.copy_(ref)
        state, spare = spare, state
        res = math.sqrt(max(new[5].item(), 0.0))
        hist.append(res / res0)
        if res <= 1e-8 * res0:
            break
    return hist, err


def stepped_readings(pb, hist, n: int) -> tuple[bool, float, list]:
    """The fused solve of ``pb`` stepped with its sums recomputed in f64
    (:func:`stepped_solve`), with the kernel's scalars and with the f64 ones
    carried; prints both.  Returns (the stepped history repeats the
    solver's, ``n`` iterations and ``hist``; the kernel's alpha, beta, res2
    against the f64 sums', max rel err; the carried solve's history)."""
    op, lat = pb.op, pb.layout.n_nodes_axis
    b, prec = pb.b.reshape(pb.lattice_shape), pb.inv_diag.reshape((1,) + lat)
    mine, err = stepped_solve(op, b, prec, carry64=False)
    h64, err64 = stepped_solve(op, b, prec, carry64=True)
    same = len(mine) == n + 1 and all(
        abs(a - c / hist[0]) <= 1e-6 * a for a, c in zip(mine, hist))
    print(f"  witness: stepped solve {len(mine) - 1} iterations, history "
          f"{'equal to' if same else 'DIFFERENT from'} the solver's; kernel "
          f"alpha, beta, res2 vs the f64 sums' max rel err {err:.3e}; with "
          f"the f64 scalars carried: {len(h64) - 1} iterations, lowest "
          f"{min(h64):.3e} res0 (max rel err {err64:.3e})")
    return same, err, h64


def asymmetry(op, n_comp: int = 3) -> float:
    """|v.Au - u.Av| / (|v| |Au|) of ``op``'s matvec on random u, v of
    ``n_comp`` components."""
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk

    u, v = random_state(op, 2, seed=5, n_comp=n_comp)
    au, av = fk.matvec(op, u).double(), fk.matvec(op, v).double()
    u, v = u.double(), v.double()
    return ((torch.sum(v * au) - torch.sum(u * av)).abs()
            / (v.norm() * au.norm())).item()


def edge_witness(pb, hist, n: int, s: int, p: int) -> tuple[bool, list]:
    """Readings at a parity point where the f32 split2m fused solve did not
    converge (``n`` iterations, history ``hist``): :func:`stepped_readings`;
    the operator's asymmetry on the card, against f32 highest's at the
    same point; the plain version's solve on the CPU.  True when the
    stepped solve repeats the solver's history and the kernel's scalars
    agree with the f64 sums' to 1e-5 relative: then the floor is the
    rung's, not a fault of the kernel's sums; and the history of the solve
    with the f64 scalars carried."""
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.solvers import cg_fused

    op, lat = pb.op, pb.layout.n_nodes_axis
    shape = dict(n_components=pb.n_components, n_q=pb.n_q)
    same, err, h64 = stepped_readings(pb, hist, n)
    for precision in ("split2m", "highest"):
        o = op if precision == "split2m" else bp4.build(
            s, p, torch.float32, "highest", factor=op.factor,
            metric=op.metric, cofactor=op.cofactor, windowing="pieces",
            device=op.device, **shape).op
        print(f"  witness: asymmetry of the f32 {precision} operator on the "
              f"card {asymmetry(o, pb.n_components):.3e}")
    cpu = bp4.build(s, p, torch.float32, "split2m", factor=op.factor,
                    metric=op.metric, cofactor=op.cofactor,
                    windowing="pieces", device="cpu", **shape)
    r = cg_fused.fused_merged_cg_solve(
        cpu.op, lat, cpu.b.reshape(cpu.lattice_shape),
        cpu.inv_diag.reshape((1,) + lat))
    print(f"  witness: the plain version on the CPU: itCG {r.n_iterations}, "
          f"converged {r.converged}")
    return same and err <= 1e-5, h64


def kernel_cases(fk, la, ops, u, d, state, scal, prec):
    """(kernel call, plain call) of each kernel on the card: B3-B6 on
    ``ops["g"]`` (metric streamed) and ``ops["o"]`` (B4's, rebuilt), B1/B2
    on ``ops["f"]``; ``u`` a lattice vector, ``d`` one of B1's, ``state``
    (x, g, d, h) of B2."""
    opg, opo, opf = ops["g"], ops["o"], ops["f"]
    u_loc = la.to_cell_batches(u, opg.degree).contiguous()
    x, g, dd, h = state
    work, out = fk.Workspace(opf), torch.empty_like(d)
    bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
    return {
        "matvec": (lambda: fk.matvec(opf, d, out=out, work=work),
                   lambda: fk._matvec_plain(opf, d)),
        "fused_cg_iteration": (
            lambda: fk.fused_cg_iteration(opf, x, g, dd, h, scal, prec,
                                          out=bufs, work=work),
            lambda: fk._fused_iteration_plain(opf, x, g, dd, h, scal, prec)),
        "apply_local_batched_g": (
            lambda: la.apply_local_batched_g(opg, u_loc),
            lambda: la._batched_plain(opg, u_loc, la._metric(opg), False)),
        "apply_local_batched_onthefly": (
            lambda: la.apply_local_batched_onthefly(opo, u_loc),
            lambda: la._batched_plain(opo, u_loc, la._metric(opo), False)),
        "apply_lattice_pieces": (
            lambda: la.apply_lattice_pieces(opg, u),
            lambda: la._lattice_plain(opg, u, la._index_mask(opg))),
        "apply_lattice_zslab": (
            lambda: la.apply_lattice_zslab(opg, u),
            lambda: la._lattice_plain(opg, u, opg.mask)),
    }


def compare(name: str, got, want, dtype, tag: str,
            quiet: bool = False) -> tuple[float, float]:
    """Check a kernel's result against its plain version's (B2: the four
    vectors and the scalars); returns (max rel err, max |diff|)."""
    if name != "fused_cg_iteration":
        rel, diff = rel_err(got, want)
        check(f"{name} {tag}", rel, TOL[dtype], quiet)
        return rel, diff
    errs = [rel_err(a, b) for a, b in zip(got[:4], want[:4])]
    rel, diff = max(e[0] for e in errs), max(e[1] for e in errs)
    check(f"{name} {tag} x' g' d' h'", rel, TOL[dtype], quiet)
    scal_rel = ((got[4] - want[4]).abs() / want[4].abs().clamp_min(
        torch.finfo(dtype).tiny)).max().item()
    check(f"{name} {tag} scal", scal_rel,
          TOL_SCAL_F32 if dtype == torch.float32 else TOL[dtype], quiet)
    return rel, diff


def high_degree_ops(layout, dtype, dev, factor="twostage",
                    metric="precomputed", cofactor="adjj"):
    """B3/B5/B6's operator (dense, streamed), B4's (dense, rebuilt) and
    B1/B2's in (factor, metric, cofactor) on ``layout`` under highest."""
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    def make(**kw):
        return laplace_cuda.make_operator(layout, dtype, "highest",
                                          device=dev, **kw)
    return {"g": make(), "o": make(metric="onthefly"),
            "f": make(factor=factor, metric=metric, cofactor=cofactor,
                      windowing="pieces")}


def compare_high_degrees(fk, la, dev) -> None:
    """Phase 3 at p=5..11: each of B1-B6 against its plain version, f32
    and f64, on the RAGGED box; B1/B2 in every HIGH_FUSED configuration.
    One line per (p, dtype); raises on the first disagreement."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout

    for p in HIGH_DEGREES:
        layout = DofLayout(BoxMesh(RAGGED, 0.25), p)
        for dtype in (torch.float32, torch.float64):
            worst = {}
            for i, (factor, metric, cof) in enumerate(HIGH_FUSED):
                ops = high_degree_ops(layout, dtype, dev, factor, metric, cof)
                opf = ops["f"]
                u, d, x, g, dd, h = random_state(opf, 6, seed=10 + i)
                prec = ((random_state(opf, 1, seed=5)[0][:1].abs() + 0.5)
                        * opf.mask).contiguous()
                scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                                    dtype=dtype, device=dev)
                cases = kernel_cases(fk, la, ops, u, d, (x, g, dd, h), scal,
                                     prec)
                tag = f"p={p} {str(dtype)[6:]} {factor} {metric} {cof}"
                for name, (kern, plain) in cases.items():
                    if i and name not in ("matvec", "fused_cg_iteration"):
                        continue  # B3-B6 do not depend on B1/B2's config
                    rel, _ = compare(name, kern(), plain(), dtype, tag,
                                     quiet=True)
                    key = name if i == 0 or name.startswith("apply") else (
                        f"{name}[{factor[0]}{metric[0]}{cof[0]}]")
                    worst[key] = max(worst.get(key, 0.0), rel)
                del ops, opf, cases
            print(f"  p={p} {str(dtype)[6:]} ragged {RAGGED}: "
                  + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
            torch.cuda.empty_cache()


def time_high(fk, la, dev, timing, p: int, s: int, dtype) -> dict:
    """Each kernel at the full-width point (p, s) (B1/B2 in the fused auto
    path's twostage + the streamed metric): compared with its plain
    version, then both timed in turns.  Returns name -> ((kernel ms, plain
    ms), (bound ms, bound by), max |diff|)."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout

    ops = high_degree_ops(DofLayout(BoxMesh.from_s(s), p), dtype, dev)
    opf = ops["f"]
    u, d, x, g, dd, h = random_state(opf, 6, seed=20)
    prec = ((random_state(opf, 1, seed=5)[0][:1].abs() + 0.5)
            * opf.mask).contiguous()
    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        dtype=dtype, device=dev)
    cases = kernel_cases(fk, la, ops, u, d, (x, g, dd, h), scal, prec)
    if dtype == torch.float64:  # the fused solver's f64 drive: B1, B2
        cases = {k: cases[k] for k in ("matvec", "fused_cg_iteration")}
    out = {}
    tag = f"p={p} s={s} {str(dtype)[6:]} highest"
    for name, (kern, plain) in cases.items():
        _, diff = compare(name, kern(), plain(), dtype, tag)
        t = time_pair(kern, plain, dev, timing, inner=10)
        op = {"apply_local_batched_onthefly": ops["o"], "matvec": opf,
              "fused_cg_iteration": opf}.get(name, ops["g"])
        b = bound(name, op, split=False)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / t[0]:.3f}")
        out[name] = t, b, diff
    del ops, opf, cases
    torch.cuda.empty_cache()
    return out


def parity_high(benchmark, bp4, dev) -> None:
    """Phase 4 at the parity points of p >= 5: f64 itCG PARITY.md's (at
    p=5 s=6 95, or 94 on the tolerance's edge) for the fused solver through
    the auto-dispatch (twostage + precomputed), with the metric rebuilt
    (--geometry onthefly: twostage + onthefly + jtj; and adjj, explicit),
    merged and baseline alike; f32 highest the f64 count + 0..3, converged
    — or, for the fused solver at the cap, the f32 recurrence's floor
    shown by :func:`stepped_readings`: its history repeated, the kernel's
    scalars within 1e-5 of the f64 sums', and converged in the f64 count
    + 0..3 with the f64 scalars carried."""
    for p, s, n64 in PARITY_HIGH:
        for dtype in (torch.float64, torch.float32):
            allowed = (n64 if dtype == torch.float64
                       else range(n64[0], n64[-1] + 4))
            for label, solver, kw in (("fused auto", "fused", {}),
                                      ("fused onthefly", "fused",
                                       {"metric": "onthefly"}),
                                      ("fused onthefly adjj", "fused",
                                       {"metric": "onthefly",
                                        "cofactor": "adjj"}),
                                      ("merged", "merged", {}),
                                      ("baseline", "baseline", {})):
                windowing = "pieces" if solver == "fused" else "reshape"
                config = benchmark.resolve_config(p, solver, windowing,
                                                  "highest", dtype, **kw)
                pb = bp4.build(s, p, dtype, "highest", windowing=windowing,
                               device=dev, **dict(zip(
                                   ("factor", "metric", "cofactor"), config)))
                res = benchmark.solver_call(pb, solver)()
                print(f"p={p} s={s} {label} {str(dtype)[6:]} highest "
                      f"{config}: itCG {res.n_iterations}, converged "
                      f"{res.converged}")
                ok = res.n_iterations in allowed and res.converged
                if not ok and (dtype, solver, res.n_iterations) == (
                        torch.float32, "fused", 100):
                    same, err, h64 = stepped_readings(
                        pb, res.res_history.cpu().numpy(), 100)
                    print(f"  witness: asymmetry of the operator on the card "
                          f"{asymmetry(pb.op):.3e}")
                    ok = (same and err <= 1e-5 and h64[-1] <= 1e-8
                          and len(h64) - 1 in allowed)
                if not ok:
                    raise AssertionError(
                        f"p={p} s={s} {label} {str(dtype)[6:]}: itCG "
                        f"{res.n_iterations} not in {tuple(allowed)}")


def split_op(layout, dev, metric="onthefly", cofactor="jtj"):
    """B1/B2's operator on ``layout`` under f32 split2m in twostage (the
    auto path's at p >= 5 by default)."""
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    return laplace_cuda.make_operator(layout, torch.float32, "split2m",
                                      factor="twostage", metric=metric,
                                      cofactor=cofactor, windowing="pieces",
                                      device=dev)


def split_cases(fk, op, seed: int):
    """(kernel call, plain call) of B1 and B2 on ``op`` with random state."""
    d, x, g, dd, h = random_state(op, 5, seed=seed)
    prec = ((random_state(op, 1, seed=5)[0][:1].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        device=op.device)
    work, out = fk.Workspace(op), torch.empty_like(d)
    bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
    return {
        "matvec": (lambda: fk.matvec(op, d, out=out, work=work),
                   lambda: fk._matvec_plain(op, d)),
        "fused_cg_iteration": (
            lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                          out=bufs, work=work),
            lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal, prec))}


def compare_split_high(fk, dev) -> None:
    """Phase 3 under f32 split2m: B1 and B2 in twostage against their plain
    versions at every degree of SPLIT_CMP on the RAGGED box, in every
    (metric, cofactor) of SPLIT_HIGH.  One line per degree; raises on the
    first disagreement (TOL, and TOL_SCAL_F32 for B2's scalars)."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout

    for p in SPLIT_CMP:
        layout = DofLayout(BoxMesh(RAGGED, 0.25), p)
        worst = {}
        for i, (metric, cof) in enumerate(SPLIT_HIGH):
            op = split_op(layout, dev, metric, cof)
            for name, (kern, plain) in split_cases(fk, op, 30 + i).items():
                rel, _ = compare(name, kern(), plain(), torch.float32,
                                 f"p={p} split2m twostage {metric} {cof}",
                                 quiet=True)
                key = f"{name}[{metric[0]}{cof[0]}]"
                worst[key] = max(worst.get(key, 0.0), rel)
            del op
        print(f"  p={p} f32 split2m twostage ragged {RAGGED}: "
              + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
        torch.cuda.empty_cache()


def time_split_high(fk, dev, timing, p: int, s: int) -> dict:
    """B1 and B2 under f32 split2m in the auto path's configuration
    (twostage + onthefly + jtj) at the full-width point (p, s): compared
    with the plain versions, then both timed in turns.  Returns name ->
    ((kernel ms, plain ms), (bound ms, bound by), max |diff|)."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout

    op = split_op(DofLayout(BoxMesh.from_s(s), p), dev)
    out = {}
    tag = f"p={p} s={s} f32 split2m twostage onthefly jtj"
    for name, (kern, plain) in split_cases(fk, op, 40).items():
        _, diff = compare(name, kern(), plain(), torch.float32, tag)
        t = time_pair(kern, plain, dev, timing, inner=10)
        b = bound(name, op, split=True)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / t[0]:.3f}")
        out[name] = t, b, diff
    del op
    torch.cuda.empty_cache()
    return out


def parity_split(benchmark, bp4, dev) -> None:
    """Phase 4 under f32 split2m at p >= 5: the fused solver through the
    auto-dispatch (twostage + onthefly + jtj), with the metric rebuilt by
    adjj and with it streamed (explicit), at PARITY_SPLIT: the f64 count
    + 0..3 (PARITY.md:95,102-105,122: the JAX interpret split2m run 96-97
    at p=5 s=6, 76 at p=6 s=4), converged — or, at the cap, edge_witness's
    readings showing the f32 recurrence's floor (its history repeated, the
    kernel's scalars within 1e-5 of the f64 sums', and with the f64
    scalars carried converged in the f64 count + 0..3)."""
    for p, s, n64 in PARITY_SPLIT:
        allowed = range(n64, n64 + 4)
        for label, kw in (("fused auto", {}),
                          ("fused onthefly adjj", {"cofactor": "adjj"}),
                          ("fused precomputed", {"metric": "precomputed"})):
            config = benchmark.resolve_config(p, "fused", "pieces",
                                              "split2m", torch.float32, **kw)
            pb = bp4.build(s, p, torch.float32, "split2m",
                           windowing="pieces", device=dev, **dict(zip(
                               ("factor", "metric", "cofactor"), config)))
            res = benchmark.solver_call(pb, "fused")()
            hist = res.res_history.cpu().numpy()
            print(f"p={p} s={s} {label} f32 split2m {config}: itCG "
                  f"{res.n_iterations}, converged {res.converged}, residual "
                  f"{hist[res.n_iterations] / hist[0]:.3e} res0")
            ok = res.converged and res.n_iterations in allowed
            if not ok and res.n_iterations == 100:
                same, h64 = edge_witness(pb, hist, 100, s, p)
                ok = same and h64[-1] <= 1e-8 and len(h64) - 1 in allowed
            if not ok:
                raise AssertionError(
                    f"p={p} s={s} {label} f32 split2m: itCG "
                    f"{res.n_iterations} not in {tuple(allowed)}")


def tc_source(config, p: int) -> str:
    """The source of the tensor-core cell pass that runs ``config``
    (factor, metric, ...) at degree p."""
    if config[0] == "dense":
        return "apply_mma.cuh"
    if p == 4:
        return "cell_mma.cuh" if config[1] == "onthefly" else "cell_mma_hd.cuh"
    return f"cell_mma_p{p:02d}.cu"


def compare_rung(name: str, got, want, rung: str, tag: str,
                 quiet: bool = False, control=None) -> dict:
    """:func:`compare` at the rung's tolerance: split3 as f32; bf16 (its
    vectors, bf16 where the state is) relative L2 and max TOL_BF16, the
    scalars TOL_SCAL_BF16.  ``control`` (bf16): the plain version with
    split2m's product set in place of bf16's, what a kernel of the wrong
    rung gives; its relative L2 from the kernel's result must exceed
    TOL_BF16's, or the check could not tell the two apart.  Returns the
    readings: "rel" (max rel err), "diff" (max |diff|) and under bf16 "l2",
    "control", and "scal" for B2."""
    from mf_data_locality_tpu_torch.utils import bf16_check

    if rung != "bf16":
        rel, diff = compare(name, got, want, torch.float32, tag, quiet)
        return {"rel": rel, "diff": diff}

    def vectors(r):
        return list(r[:4]) if name == "fused_cg_iteration" else [r]

    def l2(rs, refs):
        return max(((a.double() - b.double()).norm() / b.double().norm()
                    ).item() for a, b in zip(vectors(rs), vectors(refs)))

    errs = [rel_err(a.double(), b.double())
            for a, b in zip(vectors(got), vectors(want))]
    out = {"rel": max(e[0] for e in errs), "diff": max(e[1] for e in errs),
           "l2": l2(got, want)}
    check(f"{name} {tag} rel L2", out["l2"], TOL_BF16[0], quiet)
    check(f"{name} {tag} max", out["rel"], TOL_BF16[1], quiet)
    if name == "fused_cg_iteration":
        out["scal"] = bf16_check.scal_err(got[4], want[4])
        check(f"{name} {tag} scal", out["scal"], TOL_SCAL_BF16, quiet)
    if control is not None:
        out["control"] = l2(got, control)
        if not quiet:
            print(f"  {name} {tag} control (split2m's product set): rel L2 "
                  f"{out['control']:.3e} from the kernel's (must exceed "
                  f"{TOL_BF16[0]:.0e})")
        if not out["control"] > TOL_BF16[0]:
            raise AssertionError(f"{name} {tag}: the bf16 check cannot tell "
                                 f"split2m's product set from bf16's "
                                 f"({out['control']:.3e})")
    return out


def check_rounding_point(op, seed: int, tag: str,
                         quiet: bool = False) -> float:
    """``utils/bf16_check.rounding_point``: the kernel within TOL_SCAL_BF16
    of the plain version, and the unrounded-d' variant outside it (else the
    check could not see that rounding point).  Returns the variant's
    reading."""
    from mf_data_locality_tpu_torch.utils import bf16_check

    err, control = bf16_check.rounding_point(op, seed)
    check(f"fused_cg_iteration {tag} rounding point scal", err,
          TOL_SCAL_BF16, quiet)
    if not quiet:
        print(f"  fused_cg_iteration {tag} control (the unrounded d'): scal "
              f"max rel err {control:.3e} from the kernel's (must exceed "
              f"{TOL_SCAL_BF16:.0e})")
    if not control > TOL_SCAL_BF16:
        raise AssertionError(f"{tag}: the scalars' check cannot see the "
                             f"rounding point of d' ({control:.3e})")
    return control


def reduced_cases(fk, op, state, seed: int):
    """(kernel call, plain call, control call or None) of B1 and B2 on
    ``op`` with random vectors, d and h (and B1's d) stored as ``state``
    (the control: :func:`compare_rung`'s, under bf16)."""
    d, x, g, dd, h = random_state(op, 5, seed=seed)
    d, dd, h = (t.to(state).contiguous() for t in (d, dd, h))
    prec = ((random_state(op, 1, seed=5)[0][:1].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        device=op.device)
    work, out = fk.Workspace(op), torch.empty_like(d)
    bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
    from mf_data_locality_tpu_torch.utils.bf16_check import control_op

    ctl = control_op(op) if op.precision == "bf16" else None
    return {
        "matvec": (lambda: fk.matvec(op, d, out=out, work=work),
                   lambda: fk._matvec_plain(op, d),
                   ctl and (lambda: fk._matvec_plain(ctl, d))),
        "fused_cg_iteration": (
            lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                          out=bufs, work=work),
            lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal, prec),
            ctl and (lambda: fk._fused_iteration_plain(ctl, x, g, dd, h,
                                                       scal, prec)))}


def reduced_op(p, s, rung, state, mdt, dev, config=None, layout=None):
    """B1/B2's operator under a reduced rung: the fused auto path's
    configuration at p, or ``config`` (factor, metric, cofactor)."""
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    factor, metric, cofactor = config or benchmark.resolve_config(
        p, "fused", "pieces", rung, state, metric_dtype=mdt)
    layout = layout or DofLayout(BoxMesh.from_s(s), p)
    return laplace_cuda.make_operator(
        layout, state, rung, factor=factor, metric=metric, cofactor=cofactor,
        windowing="pieces", device=dev,
        metric_dtype=mdt if metric == "precomputed" else None)


def time_reduced(fk, dev, timing, p: int, s: int, rung, state, mdt) -> dict:
    """B1 and B2 under a reduced rung in the fused auto path's
    configuration at (p, s): compared with the plain versions, then both
    timed in turns.  Returns name -> ((kernel ms, plain ms), (bound ms,
    bound by), max |diff|), and the operator's configuration under
    "config"."""
    op = reduced_op(p, s, rung, state, mdt, dev)
    out = {"config": (op.factor, op.metric, op.cofactor)}
    tag = (f"p={p} s={s} {rung} {str(state)[6:]} state {op.factor} "
           f"{op.metric} {op.cofactor}")
    for name, (kern, plain, ctl) in reduced_cases(fk, op, state,
                                                  50 + p).items():
        diff = compare_rung(name, kern(), plain(), rung, tag,
                            control=ctl and ctl())["diff"]
        t = time_pair(kern, plain, dev, timing, inner=10)
        b = bound(name, op, split=True, state=state)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / t[0]:.3f}")
        out[name] = t, b, diff
    if state == torch.bfloat16:
        check_rounding_point(op, 80 + p, tag)
    del op
    torch.cuda.empty_cache()
    return out


def apply_cases(la, op, u, u_loc) -> dict:
    """(kernel call, plain call, control call or None) of B3, B5 and B6 on
    ``op``: the lattice vector ``u`` and its cell batches ``u_loc`` (the
    control: :func:`compare_rung`'s, under bf16)."""
    from mf_data_locality_tpu_torch.utils.bf16_check import control_op

    ctl = control_op(op) if op.precision == "bf16" else None
    return {
        "apply_local_batched_g": (
            lambda: la.apply_local_batched_g(op, u_loc),
            lambda: la._batched_plain(op, u_loc, la._metric(op), True),
            ctl and (lambda: la._batched_plain(ctl, u_loc, la._metric(op),
                                               True))),
        "apply_lattice_pieces": (
            lambda: la.apply_lattice_pieces(op, u),
            lambda: la._lattice_plain(op, u, la._index_mask(op)),
            ctl and (lambda: la._lattice_plain(ctl, u, la._index_mask(op)))),
        "apply_lattice_zslab": (
            lambda: la.apply_lattice_zslab(op, u),
            lambda: la._lattice_plain(op, u, op.mask),
            ctl and (lambda: la._lattice_plain(ctl, u, op.mask)))}


def time_reduced_apply(la, dev, timing, rung, mdt) -> dict:
    """B3, B5 and B6 under a reduced rung at p=4 s=13, the metric stored as
    ``mdt``: compared with the plain versions and timed in turns."""
    from mf_data_locality_tpu_torch.models import bp4

    op = bp4.build(S, DEGREE, torch.float32, rung, factor="dense",
                   metric="precomputed", windowing="reshape", device=dev,
                   metric_dtype=mdt).op
    (u,) = random_state(op, 1, seed=3)
    u_loc = la.to_cell_batches(u, DEGREE).contiguous()
    cases = apply_cases(la, op, u, u_loc)
    out = {}
    tag = f"p={DEGREE} s={S} {rung} metric {str(op.metric_dtype)[6:]}"
    for name, (kern, plain, ctl) in cases.items():
        diff = compare_rung(name, kern(), plain(), rung, tag,
                            control=ctl and ctl())["diff"]
        t = time_pair(kern, plain, dev, timing, inner=10)
        b = bound(name, op, split=True)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / t[0]:.3f}")
        out[name] = t, b, diff
    del op, u, u_loc, cases
    torch.cuda.empty_cache()
    return out


def compare_reduced_box(fk, la, dev) -> None:
    """Phase 3 under the reduced rungs on the RAGGED box: at p=1..4 B1/B2
    dense (the metric streamed and rebuilt) and B3/B5/B6, at REDUCED_CMP
    B1/B2 twostage in every SPLIT_HIGH configuration; each rung of REDUCED
    and bf16 with an f32 state.  One line per degree: each kernel's max
    rel err, and under bf16 the largest rel L2 and scalars' err and the
    smallest readings of the controls (:func:`compare_rung`,
    :func:`check_rounding_point`); raises on the first disagreement."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    rungs = REDUCED + (("bf16", torch.float32, None, "_bf16_f32"),)
    for p in sorted(set(range(1, 5)) | set(REDUCED_CMP)):
        layout = DofLayout(BoxMesh(RAGGED, 0.25), p)
        worst, bf16 = {}, {}
        for rung, state, mdt, sfx in rungs:
            configs = ([("dense", "precomputed", "adjj"),
                        ("dense", "onthefly", "adjj")] if p <= 4 else [])
            if p in REDUCED_CMP:
                configs += [("twostage", m, c) for m, c in SPLIT_HIGH]
            for i, config in enumerate(configs):
                op = reduced_op(p, 0, rung, state, mdt, dev, config, layout)
                tag = f"p={p} {rung}{sfx} {' '.join(config)}"
                for name, (kern, plain, ctl) in reduced_cases(
                        fk, op, state, 60 + i).items():
                    r = compare_rung(name, kern(), plain(), rung, tag,
                                     quiet=True, control=ctl and ctl())
                    key = f"{name}{sfx}[{''.join(c[0] for c in config)}]"
                    worst[key] = max(worst.get(key, 0.0), r["rel"])
                    note(bf16, r)
                if state == torch.bfloat16:
                    note(bf16, {"unrounded": check_rounding_point(
                        op, 90 + i, tag, quiet=True)})
                del op
            if p <= 4:
                op = laplace_cuda.make_operator(
                    layout, torch.float32, rung, factor="dense",
                    metric="precomputed", windowing="zslab", device=dev,
                    metric_dtype=mdt)
                (u,) = random_state(op, 1, seed=70)
                u_loc = la.to_cell_batches(u, p).contiguous()
                for name, (kern, plain, ctl) in apply_cases(
                        la, op, u, u_loc).items():
                    r = compare_rung(name, kern(), plain(), rung,
                                     f"p={p} {rung}{sfx}", quiet=True,
                                     control=ctl and ctl())
                    worst[name + sfx] = max(worst.get(name + sfx, 0.0),
                                            r["rel"])
                    note(bf16, r)
                del op
        print(f"  p={p} reduced rungs ragged {RAGGED}: "
              + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
        print(f"  p={p} bf16: rel L2 <= {bf16['l2']:.2e} (tol "
              f"{TOL_BF16[0]:.0e}), scal <= {bf16['scal']:.2e} (tol "
              f"{TOL_SCAL_BF16:.0e}); controls: split2m's product set rel "
              f"L2 >= {bf16['control']:.2e}, the unrounded d' "
              f"(rounding_point) scal >= {bf16['unrounded']:.2e}")
        torch.cuda.empty_cache()


def dense_ops(layout, rung, state, mdt, dev) -> dict:
    """The dense pass's operators on ``layout`` under a tensor-core rung:
    B1/B2's in the dense factorization with the metric streamed ("p") and
    rebuilt ("o"), the apply family's (dense, streamed: "a") and the merged
    solver's on --windowing pieces from p=5 (twostage, streamed: "t"), the
    last two with an f32 state."""
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    def apply_op(factor):
        return laplace_cuda.make_operator(
            layout, torch.float32, rung, factor=factor, metric="precomputed",
            windowing="pieces", device=dev, metric_dtype=mdt)

    return {"p": reduced_op(0, 0, rung, state, mdt, dev,
                            ("dense", "precomputed", "adjj"), layout),
            "o": reduced_op(0, 0, rung, state, mdt, dev,
                            ("dense", "onthefly", "adjj"), layout),
            "a": apply_op("dense"), "t": apply_op("twostage")}


def dense_cases(fk, la, ops, state, seed: int) -> dict:
    """(kernel call, plain call, control call or None) of B1/B2 on
    ``ops["p"]`` and ``ops["o"]`` (keys ``matvec[p]``, ...), B3/B5/B6 on
    ``ops["a"]`` and B5 on ``ops["t"]`` (``apply_lattice_pieces[t]``)."""
    out = {}
    for m in ("p", "o"):
        for name, c in reduced_cases(fk, ops[m], state, seed).items():
            out[f"{name}[{m}]"] = c
    (u,) = random_state(ops["a"], 1, seed=seed + 1)
    u_loc = la.to_cell_batches(u, ops["a"].degree).contiguous()
    out.update(apply_cases(la, ops["a"], u, u_loc))
    pieces = apply_cases(la, ops["t"], u, u_loc)["apply_lattice_pieces"]
    out["apply_lattice_pieces[t]"] = pieces
    return out


def compare_dense_box(fk, la, dev) -> None:
    """Phase 3 for the dense pass at p=5..11: every case of
    :func:`dense_cases` against its plain version on the RAGGED box under
    each rung of DENSE_RUNGS (:func:`compare_rung`'s tolerances and, under
    bf16, controls; the bf16 state's rounding point,
    :func:`check_rounding_point`).  One line per degree; raises on the first
    disagreement."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout

    for p in HIGH_DEGREES:
        layout = DofLayout(BoxMesh(RAGGED, 0.25), p)
        worst, bf16 = {}, {}
        for rung, state, mdt, sfx in DENSE_RUNGS:
            ops = dense_ops(layout, rung, state, mdt, dev)
            for name, (kern, plain, ctl) in dense_cases(
                    fk, la, ops, state, 150 + p).items():
                r = compare_rung(name.split("[")[0], kern(), plain(), rung,
                                 f"p={p} {rung} dense {name}", quiet=True,
                                 control=ctl and ctl())
                key = f"{rung} {name}"
                worst[key] = max(worst.get(key, 0.0), r["rel"])
                note(bf16, r)
            if state == torch.bfloat16:
                note(bf16, {"unrounded": check_rounding_point(
                    ops["p"], 160 + p, f"p={p} {rung} dense", quiet=True)})
            del ops
        print(f"  p={p} dense tensor-core pass ragged {RAGGED}: "
              + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
        print(f"  p={p} dense bf16: rel L2 <= {bf16['l2']:.2e} (tol "
              f"{TOL_BF16[0]:.0e}), scal <= {bf16['scal']:.2e}; controls: "
              f"split2m's product set rel L2 >= {bf16['control']:.2e}, the "
              f"unrounded d' scal >= {bf16['unrounded']:.2e}")
        torch.cuda.empty_cache()


def time_dense(fk, la, dev, timing, p: int, s: int, rung, state,
               mdt) -> dict:
    """The dense pass at the full-width point (p, s) under a tensor-core
    rung: B1/B2 in the fused solver's --factor dense configuration, B3/B5/B6
    on the merged solver's dense operator, each compared with its plain
    version, then both timed in turns (DENSE_INNER launches a repeat).
    Returns name -> ((kernel ms, plain ms), (bound ms, bound by), max
    |diff|), the B1/B2 configuration under "config" and, under split2m,
    ``torch.matmul``'s time of the forward's bf16 product at the padded
    shapes, (3 Q3P, P13P) x (P13P, 3 n_cells), under "matmul_ms"."""
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    layout = DofLayout(BoxMesh.from_s(s), p)
    config = benchmark.resolve_config(p, "fused", "pieces", rung, state,
                                      factor="dense", metric_dtype=mdt)
    op = reduced_op(p, s, rung, state, mdt, dev, config, layout)
    opa = laplace_cuda.make_operator(layout, torch.float32, rung,
                                     factor="dense", metric="precomputed",
                                     windowing="reshape", device=dev,
                                     metric_dtype=mdt)
    (u,) = random_state(opa, 1, seed=170)
    u_loc = la.to_cell_batches(u, p).contiguous()
    cases = {**reduced_cases(fk, op, state, 171),
             **apply_cases(la, opa, u, u_loc)}
    out = {"config": config}
    tag = f"p={p} s={s} {rung} dense"
    for name, (kern, plain, ctl) in cases.items():
        diff = compare_rung(name, kern(), plain(), rung, tag,
                            control=ctl and ctl())["diff"]
        t = time_pair(kern, plain, dev, timing, inner=DENSE_INNER[rung])
        b = bound(name, op if name in ("matvec", "fused_cg_iteration")
                  else opa, split=True, state=state)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / t[0]:.3f}")
        out[name] = t, b, diff
    if rung == "split2m":
        q3p, p13p = laplace_cuda.mma_dims(p)
        m = torch.randn((3 * q3p, p13p), device=dev).to(torch.bfloat16)
        x = torch.randn((p13p, 3 * op.n_cells), device=dev).to(
            torch.bfloat16)
        out["matmul_ms"] = timing.time_per_call(
            lambda: torch.matmul(m, x), dev, inner=10, repeats=3) * 1e3
        print(f"  torch.matmul of the forward's bf16 product {tuple(m.shape)}"
              f" x {tuple(x.shape)} (a yardstick, not the function): "
              f"{out['matmul_ms']:.4f} ms")
        del m, x
    del op, opa, u, u_loc, cases
    torch.cuda.empty_cache()
    return out


def parity_merged_split(bp4, dev) -> None:
    """Phase 4 for the dense pass: the merged solver under f32 split2m
    (reshape, B3 on the tensor-core pass) at PARITY_SPLIT, the f64 count +
    0..3 and converged, as PARITY_SPLIT holds the fused path."""
    for p, s, n64 in PARITY_SPLIT:
        pb = bp4.build(s, p, torch.float32, "split2m", device=dev)
        res = bp4.solve_merged(pb)
        hist = res.res_history.cpu().numpy()
        print(f"p={p} s={s} merged f32 split2m (reshape, {pb.op.factor}, "
              f"{pb.op.metric}): itCG {res.n_iterations}, converged "
              f"{res.converged}, residual "
              f"{hist[res.n_iterations] / hist[0]:.3e} res0")
        if not (res.converged and res.n_iterations in range(n64, n64 + 4)):
            raise AssertionError(f"p={p} s={s} merged split2m: itCG "
                                 f"{res.n_iterations} not in "
                                 f"{n64}..{n64 + 3}")


def note(acc: dict, r: dict) -> None:
    """Fold :func:`compare_rung`'s readings ``r`` into ``acc``: the largest
    rel L2 and scalars' err, the smallest readings of the controls."""
    for k, v in r.items():
        if k in ("l2", "scal"):
            acc[k] = max(acc.get(k, 0.0), v)
        elif k in ("control", "unrounded"):
            acc[k] = min(acc.get(k, math.inf), v)


def parity_reduced(benchmark, bp4, dev) -> None:
    """Phase 4 under the reduced rungs (PARITY.md:91-96, accuracy only):
    the fused auto path at PARITY_REDUCED — split3 (f32 state) in its
    range, converged; bf16 (the bf16 state and metric) at p=6 s=4
    converged in <= 100, at p=4 s=7 converged or at the cap with its final
    residual <= 1e-4 res0 and finite — and the merged solver under split3
    (reshape, B3) at p=4 s=7, the f64 count + 0..3 (91..94)."""
    for p, s, rung, allowed in PARITY_REDUCED:
        state = torch.bfloat16 if rung == "bf16" else torch.float32
        mdt = torch.bfloat16 if rung == "bf16" else None
        config = benchmark.resolve_config(p, "fused", "pieces", rung, state,
                                          metric_dtype=mdt)
        pb = bp4.build(s, p, state, rung, windowing="pieces", device=dev,
                       metric_dtype=mdt, **dict(zip(
                           ("factor", "metric", "cofactor"), config)))
        res = benchmark.solver_call(pb, "fused")()
        hist = res.res_history.cpu().numpy()
        final = hist[res.n_iterations] / hist[0]
        print(f"p={p} s={s} fused auto {rung} ({str(state)[6:]} state) "
              f"{config}: itCG {res.n_iterations}, converged "
              f"{res.converged}, residual {final:.3e} res0")
        ok = (res.converged and res.n_iterations in allowed
              if allowed is not None
              else (res.converged or math.isfinite(final) and final <= 1e-4))
        if not ok:
            raise AssertionError(f"p={p} s={s} fused {rung}: itCG "
                                 f"{res.n_iterations}, residual {final:.3e}")
    pb = bp4.build(7, DEGREE, torch.float32, "split3", device=dev)
    res = bp4.solve_merged(pb)
    print(f"p=4 s=7 merged split3 (reshape): itCG {res.n_iterations}, "
          f"converged {res.converged}")
    if not (res.converged and res.n_iterations in range(91, 95)):
        raise AssertionError(f"p=4 s=7 merged split3: itCG "
                             f"{res.n_iterations} not in 91..94")



# B2 with the preconditioner or x stored in bf16 (the fused solver's
# prec_dtype and x_dtype, csrc/cg_fused_px.cu): (p, s, dtype, precision,
# configuration, key suffix) — the production command's configuration at
# p=4 s=13 (split2m twostage + onthefly: cell_mma.cuh) and the auto path
# under highest at p=6 s=12 (twostage + the streamed metric:
# sumfac_p06.cu).  x feeds no dot, so B2 with x in bf16 must give g', d',
# h' and the scalars bitwise equal to the f32-x kernel run beside it; x' is
# held to its plain version within one bf16 step (2^-8 of its largest
# value: the two round sums that differ in the last f32 bits); with P in
# bf16 the kernel is held to its plain version at TOL, and a control, the
# plain version with P unrounded, must miss TOL
STORAGE_RUNS = ((DEGREE, S, torch.float32, "split2m",
                 dict(factor="twostage", metric="onthefly", cofactor="adjj"),
                 ""),
                (6, 12, torch.float32, "highest",
                 dict(factor="twostage", metric="precomputed",
                      cofactor="adjj"), "_p6"))
STORAGE = (("_prec_bf16", dict(prec_dtype=torch.bfloat16)),
           ("_x_bf16", dict(x_dtype=torch.bfloat16)))
# the plain backends at p=4 s=13 against B3 (the JAX CLI's default path's
# operator) on the same vector, relative L2
TOL_BACKEND = {torch.float32: 1e-5, torch.float64: 1e-12}
# the discretization: (p, the two s), the L2 rate of the manufactured
# solution between them must reach (p + 1) - 0.35 (h halves from one s to
# the other; s = 3 at p=1 as tests/test_convergence.py, larger s at p=2,
# 4 to stay in the asymptotic range).  The merged CG's tolerance: its
# residual estimate s3 + 2 alpha s2 + alpha^2 s1 cancels to ~sqrt(eps)
# res0 (~1e-8 in f64) once the true residual is at roundoff; at p=1 the
# load is nearly an eigenvector and one step converges, so a tolerance
# under that floor runs a second step on noise, whose even-count exit
# fixup divides by a beta of roundoff size and returns a wrong x
# (ROADMAP.md queue C item C9).  1e-7 stays above the floor; at p=4 s=9
# the algebraic error is then < 1e-3 of the discretization error
CONVERGENCE = ((1, (3, 6)), (2, (6, 9)), (4, (6, 9)))
CONVERGENCE_TOL = 1e-7


def compare_storage(fk, bp4, dev, timing) -> dict:
    """B2 with bf16 P and with bf16 x at STORAGE_RUNS: the checks above,
    kernel and plain times and the bound with P or x at 2 bytes; returns
    {suffix: ((kernel ms, plain ms), bound, max |diff|), "_f32...": the
    f32 run's} and the problems, for the drives."""
    out, problems = {}, {}
    for p, s, dtype, precision, config, sfx in STORAGE_RUNS:
        pb = bp4.build(s, p, dtype, precision, windowing="pieces",
                       device=dev, **config)
        problems[sfx] = pb
        op = pb.op
        tag = f"p={p} s={s} {precision} {op.factor} {op.metric}"
        prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
        x, g, d, h = random_state(op, 4, seed=7)
        scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                            dtype=dtype, device=dev)
        pb16, xb16 = prec.to(torch.bfloat16), x.to(torch.bfloat16)
        ref = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        rx = fk.fused_cg_iteration(op, xb16, g, d, h, scal, prec)
        bitwise = all(torch.equal(a, b) for a, b in zip(ref[1:], rx[1:]))
        want_x = fk._fused_iteration_plain(op, xb16, g, d, h, scal, prec)
        xstep = ((rx[0].double() - want_x[0].double()).abs().max()
                 / want_x[0].double().abs().max()).item()
        print(f"  fused_cg_iteration {tag} x bf16: g' d' h' scal bitwise "
              f"equal to the f32-x run: {bitwise}; x' vs plain {xstep:.3e} "
              f"of its largest (tol {2.0 ** -8:.2e})")
        if not (bitwise and xstep <= 2.0 ** -8):
            raise AssertionError(f"B2 {tag} with x in bf16 is wrong")
        rp = fk.fused_cg_iteration(op, x, g, d, h, scal, pb16)
        want = fk._fused_iteration_plain(op, x, g, d, h, scal, pb16)
        _, pdiff = compare("fused_cg_iteration", rp, want, dtype,
                           tag + " P bf16")
        ctrl = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
        miss = max(rel_err(a, b)[0] for a, b in zip(rp[1:4], ctrl[1:4]))
        print(f"  fused_cg_iteration {tag} P bf16: control (P unrounded) "
              f"{miss:.3e}, must exceed {TOL[dtype]:.0e}")
        if not miss > TOL[dtype]:
            raise AssertionError(f"B2 {tag}: the P-unrounded control "
                                 "passes; bf16 P is not read")
        work = fk.Workspace(op)
        for key, xx, pp, err in (("_f32", x, prec, 0.0),
                                 ("_prec_bf16", x, pb16, pdiff),
                                 ("_x_bf16", xb16, prec,
                                  (rx[0].float() - want_x[0].float())
                                  .abs().max().item())):
            bufs = tuple(torch.empty_like(t) for t in (xx, g, d, h, scal))
            t = time_pair(
                lambda: fk.fused_cg_iteration(op, xx, g, d, h, scal, pp,
                                              out=bufs, work=work),
                lambda: fk._fused_iteration_plain(op, xx, g, d, h, scal, pp),
                dev, timing)
            b = bound("fused_cg_iteration", op, split=precision == "split2m",
                      prec_word=pp.element_size(), x_word=xx.element_size())
            out[key + sfx] = t, b, err
            print(f"  fused_cg_iteration {tag} {key[1:]}: kernel {t[0]:.4f} "
                  f"ms, plain {t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        del op, x, g, d, h, ref, rx, rp, want, want_x, ctrl, work, bufs
        torch.cuda.empty_cache()
    return out, problems


def compare_backends(bp4, la, dev) -> dict:
    """The structured and general backends' vmult against B3 (merged,
    reshape, highest: the JAX CLI's default operator) on the same vector at
    p=4 s=13, f32 and f64; returns the problems, for the drives."""
    problems = {}
    for dtype in (torch.float32, torch.float64):
        ref = bp4.build(S, DEGREE, dtype, "highest", device=dev)
        gen = torch.Generator(device=dev).manual_seed(11)
        u = torch.randn(ref.b.shape, generator=gen, device=dev, dtype=dtype)
        want = ref.a_apply_full(u)
        del ref
        for backend in ("structured", "general"):
            pb = bp4.build(S, DEGREE, dtype, device=dev, backend=backend)
            err = (torch.linalg.norm(pb.a_apply_full(u) - want)
                   / torch.linalg.norm(want)).item()
            print(f"  vmult {backend} p={DEGREE} s={S} {str(dtype)[6:]} vs "
                  f"B3: rel L2 {err:.3e} (tol {TOL_BACKEND[dtype]:.0e})")
            if not err <= TOL_BACKEND[dtype]:
                raise AssertionError(f"{backend} backend disagrees with B3")
            problems[backend, dtype] = pb
        torch.cuda.empty_cache()
    return problems


def convergence_rates(la, dev) -> list:
    """The manufactured solution sin(pi x) sin(pi y) sin(pi z) in each of
    the 3 components on the undeformed box, solved in f64 by the merged CG
    through B3 (the JAX CLI's default operator): the observed L2 rate
    between the two s of CONVERGENCE must reach (p + 1) - 0.35; each solve
    must launch B3.  Returns (p, errors, rate, launches)."""
    import numpy as np

    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
    from mf_data_locality_tpu_torch.ops import diagonal, laplace_cuda, rhs
    from mf_data_locality_tpu_torch.solvers import cg_merged

    def u1(x):
        return (np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
                * np.sin(np.pi * x[..., 2]))[..., None]

    def u3(x):
        return np.repeat(u1(x), 3, axis=-1)

    out = []
    for p, sizes in CONVERGENCE:
        errors, launches = [], 0
        for s in sizes:
            layout = DofLayout(BoxMesh.from_s(s, deformed=False), p)
            op = laplace_cuda.make_operator(layout, torch.float64,
                                            "highest", device=dev)
            lat = (3,) + layout.n_nodes_axis
            b = torch.tensor(rhs.assemble_rhs(
                layout, lambda x: 3 * np.pi ** 2 * u3(x)), device=dev)
            prec = torch.tensor(diagonal.compute_inverse_diagonal(layout),
                                device=dev)[None, :]
            la.apply_local_batched_g.launches = 0
            res = cg_merged.merged_cg_solve(
                lambda v: la.vmult(op, v.reshape(lat),
                                   constrained_identity=False)
                .reshape(v.shape), b, prec, max_iter=400,
                rel_tol=CONVERGENCE_TOL)
            launches += la.apply_local_batched_g.launches
            if not (res.converged and la.apply_local_batched_g.launches):
                raise AssertionError(f"manufactured solve p={p} s={s}: "
                                     f"converged {res.converged}")
            errors.append(rhs.l2_error(layout, res.x, u3))
        rate = math.log2(errors[0] / errors[1])
        print(f"  p={p} s={sizes}: L2 errors {errors[0]:.6e} "
              f"{errors[1]:.6e}, rate {rate:.4f} (>= {p + 1 - 0.35:.2f}), "
              f"B3 launches {launches}")
        if not rate >= p + 1 - 0.35:
            raise AssertionError(f"p={p}: L2 rate {rate:.3f} below "
                                 f"{p + 1 - 0.35}")
        out.append((p, errors, rate, launches))
    return out


# the z-slab distributed solvers (section 8).  B2's block form on z-slabs,
# blocks of a (3,) mesh (halo planes, Dirichlet faces by global position,
# the sums over the owned planes raw, the carry in h''s top plane),
# against its plain version on two slabs of the s=9 mesh (8 x 8 x 8
# cells) over 3 ranks: rank 1 (z0 = 3 layers, its top plane a halo of
# rank 2's plane 0) and rank 2 (z0 = 6, one dummy layer), at SLAB_DEGREES under each rung of SLAB_RUNGS (rung, the
# state's dtype; bf16 with its state) with the metric streamed and
# rebuilt, at each rung's tolerance (bf16 with its controls); then timed
# on rank 1's slab of DIST_FULL beside the unchanged B2 on a box of the
# same cells
SLAB_RUNGS = (("highest", torch.float64), ("highest", torch.float32),
              ("split2m", torch.float32), ("split3", torch.float32),
              ("bf16", torch.bfloat16))
SLAB_DEGREES = (4, 6)
SLAB_TIMED = (("split2m", torch.float32, ""),
              ("highest", torch.float64, "_f64"))
# f64 parity of the distributed solvers at PARITY.md's p=4 s=7 point on
# DIST_RANKS ranks (3 does not divide ncz = 4): the fused (dense, the
# metric streamed), merged (reshape: B3) and baseline solvers, each
# against the same solver on one device on the card: itCG DIST_ITCG and x
# within TOL_DIST_X max(1, |x|).  Not the 1e-11 of tests/test_dist_fused.py
# :41, whose points (s=6, p <= 3) spread by ~1e-15: here 91 iterations
# amplify rounding in x (|x| = 1231), and the JAX package's own fused
# solve on 1 and on 2 devices differs by 5.1e-10 max(1, |x|) (its merged
# by 9.1e-11; the port's plain versions on the CPU, single vs distributed,
# by 1.0e-10 fused and 3.9e-10 merged; tests/test_torch_dist_cli.py)
DIST_PARITY = (4, 7)
DIST_ITCG = 91
DIST_RANKS = (2, 3)
TOL_DIST_X = 1e-9
# the full width: 4 ranks at p=4 s=15 (6,440,067 DoFs, 32^3 cells: the
# reference's ladder top for 4 ranks, ~1.6M DoFs a rank), f32: the JAX
# CLI's default with --devices 4 (merged, reshape, highest), the
# production command with --devices 4 (fused, pieces, split2m: dense, the
# metric streamed) and the same with --geometry onthefly
DIST_FULL = (4, 15, 4)
# the (z, y) and (z, y, x) rank meshes (section 8).  B2's block form
# against its plain version on three blocks of the s=9 mesh (8 x 8 x 8
# cells): (0, 0) of a (2, 2) mesh and (0, 0, 0) of a (2, 2, 2) mesh,
# every ghost face an upper neighbour's, and (1, 0, 2) of a (2, 1, 3) mesh
# (the global top on z and x, a dummy x cell column), under SLAB_RUNGS x
# SLAB_DEGREES x both metrics; timed at MESH_FULL beside the unchanged B2
# on a box of the same cells
BLOCK_CASES = ((9, (2, 2), (0, 0)), (9, (2, 2, 2), (0, 0, 0)),
               (9, (2, 1, 3), (1, 0, 2)))
# the full-width mesh drives at p=4: (key suffix, s, mesh) — the
# reference's ladder tops, s=15 on 4 ranks (6,440,067 DoFs, 1.6M a rank:
# the merged reshape f32 highest and the fused split2m dense streamed
# solves) and s=16 = benchmark.ladder_sizes(4, n_devices=8)[-1] on 8 ranks
# (12,830,211 DoFs: the fused split2m solve with the metric rebuilt, so
# that the true residual's one-device operator needs no host metric; at
# most 100 iterations as every solve here, one timed solve where the
# 4-rank drives time two); f64 parity at DIST_PARITY on each mesh (fused,
# merged, baseline: itCG DIST_ITCG, x within TOL_DIST_X of one device)
MESH_FULL = (("_block2d", 15, (2, 2)), ("_block3d", 16, (2, 2, 2)))


def _slab_op(s, p, rank, n, state, rung, metric, dev):
    from mf_data_locality_tpu_torch.parallel import distributed

    return distributed.build_slab(s, p, rank, n, state, "pallas", rung,
                                  "pieces", metric, dev).op


def _block_op(s, p, coords, mesh, state, rung, metric, dev):
    from mf_data_locality_tpu_torch.parallel import distributed

    return distributed.build_block(s, p, coords, mesh, state, "pallas", rung,
                                   "pieces", metric, dev).op


def compare_rank_forms(fk, dev, cases, form: str) -> dict:
    """B2's block form vs its plain version on each of ``cases``
    ((label, a function (p, state dtype, rung, metric) -> op)) under
    SLAB_RUNGS x SLAB_DEGREES x both metrics, every ghost plane or face
    holding the random state; returns the largest readings a rung."""
    from mf_data_locality_tpu_torch.utils.bf16_check import control_op

    worst = {}
    for p in SLAB_DEGREES:
        for rung, state in SLAB_RUNGS:
            for metric in ("precomputed", "onthefly"):
                for k, (label, build) in enumerate(cases):
                    op = build(p, state, rung, metric)
                    x, g, d, h = random_state(op, 4, seed=70 + k)
                    d, h = d.to(state).contiguous(), h.to(state).contiguous()
                    prec = ((random_state(op, 1, seed=5)[0][:1].abs() + 0.5)
                            * op.mask).contiguous()
                    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25,
                                         0.6], dtype=op.dtype, device=dev)
                    tag = (f"{form} p={p} {rung} {str(state)[6:]} {metric} "
                           f"{label}")
                    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
                    want = fk._fused_iteration_plain(op, x, g, d, h, scal,
                                                     prec)
                    if rung == "highest":
                        err = compare("fused_cg_iteration", got, want,
                                      op.dtype, tag, quiet=True)[0]
                    else:
                        ctl = (fk._fused_iteration_plain(control_op(op), x,
                                                         g, d, h, scal, prec)
                               if rung == "bf16" else None)
                        r = compare_rung("fused_cg_iteration", got, want,
                                         rung, tag, quiet=True, control=ctl)
                        err = r.get("l2", r["rel"])
                    key = (rung, str(state)[6:])
                    worst[key] = max(worst.get(key, 0.0), err)
                    if state == torch.bfloat16:
                        check_rounding_point(op, 80 + p, tag, quiet=True)
    for (rung, state), err in worst.items():
        print(f"  fused_cg_iteration {form} form {rung} {state} (p in "
              f"{SLAB_DEGREES}, both metrics, {len(cases)} {form}s): "
              f"largest {'rel L2' if rung == 'bf16' else 'max rel err'} "
              f"{err:.3e}")
    return worst


def time_rank_form(fk, dev, timing, build, s: int, label: str) -> dict:
    """B2's block form on one rank's part (``build(rung, dtype) ->
    op``; the fused full-width configuration: dense, the metric streamed)
    under SLAB_TIMED, compared with and timed beside its plain version and
    the bound, and the unchanged B2 on a box of the same cells timed in the
    same turns; returns {suffix: ((kernel ms, plain ms), bound, max |diff|,
    box ms)}."""
    from mf_data_locality_tpu_torch.mesh.box import BoxMesh
    from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
    from mf_data_locality_tpu_torch.ops import laplace_cuda

    out = {}
    for rung, dtype, sfx in SLAB_TIMED:
        op = build(rung, dtype)
        box = laplace_cuda.make_operator(
            DofLayout(BoxMesh(op.n_cells_axis, BoxMesh.from_s(s).spacing),
                      op.degree), dtype, rung, factor="dense",
            metric="precomputed", windowing="pieces", device=dev)
        tag = f"{label} {rung} {str(dtype)[6:]}"
        x, g, d, h = random_state(op, 4, seed=9)
        prec = ((random_state(op, 1, seed=5)[0][:1].abs() + 0.5)
                * op.mask).contiguous()
        scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                            dtype=dtype, device=dev)
        _, diff = compare("fused_cg_iteration",
                          fk.fused_cg_iteration(op, x, g, d, h, scal, prec),
                          fk._fused_iteration_plain(op, x, g, d, h, scal,
                                                    prec), dtype, tag)
        work, wbox = fk.Workspace(op), fk.Workspace(box)
        bufs = tuple(torch.empty_like(t) for t in (x, g, d, h, scal))
        t = time_pair(lambda: fk.fused_cg_iteration(op, x, g, d, h, scal,
                                                    prec, out=bufs,
                                                    work=work),
                      lambda: fk._fused_iteration_plain(op, x, g, d, h, scal,
                                                        prec), dev, timing)
        t_box = min(timing.time_per_call(
            lambda: fk.fused_cg_iteration(box, x, g, d, h, scal, prec,
                                          out=bufs, work=wbox), dev,
            inner=20, repeats=3) for _ in range(2)) * 1e3
        b = bound("fused_cg_iteration", op, split=rung != "highest")
        print(f"  fused_cg_iteration {tag}: kernel {t[0]:.4f} ms, plain "
              f"{t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); the unchanged "
              f"B2 on a box of the same {op.n_cells} cells {t_box:.4f} ms")
        out[sfx] = t, b, diff, t_box
        del op, box, x, g, d, h, work, wbox, bufs
        torch.cuda.empty_cache()
    return out


def check_collectives(job, r: dict, n: int) -> None:
    """Every rank's collectives in the job's first solve, with k the split
    axes of its rank grid (z-slabs: 1): the merged and fused solvers one
    all-reduce an iteration and one for res0, the baseline 3 an iteration
    and 2; 2k shifts an operator apply (merged, baseline) or an iteration
    (fused, and k each for P's ghost faces and x's)."""
    it = r["it"]
    k = 1 if not job.blocks else sum(d > 1 for d in job.mesh_shape)
    want = ((2 + 3 * it, 2 * k * it) if job.solver == "baseline" else
            (it + 1, 2 * k * it + (2 * k if job.solver == "fused" else 0)))
    got = {(x["allreduces"], x["shifts"]) for x in r["ranks"]}
    if got != {want}:
        raise AssertionError(f"{job.solver} on {n} ranks: (all-reduces, "
                             f"shifts) {got}, expected {want}")


def _parity(ref, jobs, out, lat, where: str) -> None:
    """The f64 parity jobs' results against one device's solves."""
    for job, r in zip(jobs, out):
        want = ref[job.solver]
        xr = want.x.reshape(lat).cpu()
        err = ((r["x"] - xr).abs().max() / max(1.0, xr.abs().max())).item()
        kern = ("fused_cg_iteration" if job.solver == "fused"
                else "apply_local_batched_g")
        launched = sum(x["launches_solve"][kern] for x in r["ranks"])
        n = len(r["ranks"])
        print(f"  {job.solver} f64 p={job.degree} s={job.s} on {where}: "
              f"itCG {r['it']} (one device {want.n_iterations}), x "
              f"{err:.3e} max(1, |x|) from one device's (tol "
              f"{TOL_DIST_X:.0e}), {kern} launches {launched}")
        check_collectives(job, r, n)
        if not (r["it"] == want.n_iterations == DIST_ITCG
                and err <= TOL_DIST_X and launched == n * r["it"]):
            raise AssertionError(f"distributed {job.solver} on {where} "
                                 f"disagrees with one device")


def _drive(benchmark, label: str, job, r: dict) -> tuple[dict, object]:
    """Print a full-width drive's row, collectives, launches and the
    slowest rank's host seconds; check x's shape and finiteness.  Returns
    (its launches summed over the ranks, its row)."""
    n = len(r["ranks"])
    check_collectives(job, r, n)
    row = benchmark.dist_row(job, r)
    launches = {k: sum(x["launches"][k] for x in r["ranks"])
                for k in r["ranks"][0]["launches"]}
    it = r["it"]
    print(f"  {label} {job.precision}: {row.row()}; per iteration "
          f"{(r['allreduces'] - 1) / it:g} all-reduce, "
          f"{r['shifts'] / it:.3g} shifts (rank 0)")
    print(f"    launches (all ranks, the run with its timing): {launches}")
    ms = {k: max(x["comm_s"][k] for x in r["ranks"]) / it * 1e3
          for k in r["comm_s"]}
    print(f"    host ms an iteration (the slowest rank, first solve): wall "
          f"{max(x['wall_s'] for x in r['ranks']) / it * 1e3:.3f}; in the "
          f"collectives " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    lat = (3,) + job.nodes_axis()
    if tuple(r["x"].shape) != lat or not torch.isfinite(r["x"]).all():
        raise AssertionError(f"{label}: x is wrong")
    return launches, row


def _true_residual(fk, pb, r: dict, label: str) -> None:
    """|b - A x| of a distributed solve's x by one device's problem ``pb``
    of the same configuration, against the solve's residual estimate."""
    b = pb.b.reshape(r["x"].shape)
    x = r["x"].to(b.device).contiguous()
    ax = (pb.a_apply(x.reshape(3, -1)).reshape(x.shape)
          if pb.op.windowing == "reshape" else fk.matvec(pb.op, x))
    true_res = torch.linalg.norm(b - ax).item()
    gap = abs(true_res - r["res"]) / r["res"]
    print(f"  {label} solution: |b - Ax| {true_res:.6e} vs the estimate "
          f"{r['res']:.6e} (rel gap {gap:.2e}, tol 1e-3)")
    if not gap < 1e-3:
        raise AssertionError(f"{label}: the distributed solution's residual "
                             f"is not its estimate")


# B2's layer-range form (section 8; the overlapped fused solve's): the cell
# pass over the cell layers [0, n-1), then over [n-1, n), then one
# assemble (``fused_cg_iteration(cells=)``, ``fused_cg_assemble``),
# against the one launch bitwise and against the plain version at the
# rung's tolerance, on rank 1 of RANGE_CASES' z-slabs (p=4 s=15: 8 layers;
# p=6 s=12: 4 layers) under RANGE_RUNGS, the metric streamed and rebuilt;
# timed at DIST_FULL under SLAB_TIMED beside the one launch
RANGE_CASES = ((4, 15, 4), (6, 12, 4))  # (p, s, ranks)
RANGE_RUNGS = (("highest", torch.float64), ("highest", torch.float32),
               ("split2m", torch.float32))
# the overlapped merged solve (f32, 100 iterations, the cap) against the
# one without overlap in the same spawn: the sums at the layer seams are
# taken in another order, and CG carries the difference into x; the bound
# on max |x - x_plain| / max(1, |x|) (read: 1.14e-6, PERF.md §6)
TOL_OVERLAP_X32 = 1e-4
# --backend general --devices 4 at p=4 (section 8), short: 4,096 cells
GENERAL_S = 12


def range_iteration(fk, op, state, work, cut: int, out=None):
    """B2's layer-range form on ``state`` (x, g, d, h, scal, prec): the
    cell passes over [0, cut) and [cut, ncz), then the assemble."""
    out = out or tuple(torch.empty_like(t) for t in state[:5])
    for cells in ((0, cut), (cut, op.n_cells_axis[0])):
        fk.fused_cg_iteration(op, *state, out=out, work=work, cells=cells)
    return fk.fused_cg_assemble(op, out, state[5], state[4], work)


def _rank_state(op, dev, seed: int):
    x, g, d, h = random_state(op, 4, seed=seed)
    prec = ((random_state(op, 1, seed=5)[0][:1].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        dtype=op.dtype, device=dev)
    return x, g, d, h, scal, prec


def compare_range_form(fk, dev) -> dict:
    """The layer-range form against the one launch (bitwise) and the plain
    version at RANGE_CASES x RANGE_RUNGS x both metrics; returns the
    largest plain-version reading a rung."""
    worst = {}
    for p, s, n in RANGE_CASES:
        for rung, dtype in RANGE_RUNGS:
            for metric in ("precomputed", "onthefly"):
                op = _slab_op(s, p, 1, n, dtype, rung, metric, dev)
                state = _rank_state(op, dev, 90 + p)
                tag = (f"layer-range p={p} s={s} rank 1/{n} {rung} "
                       f"{str(dtype)[6:]} {metric}")
                one = fk.fused_cg_iteration(op, *state)
                ncz = op.n_cells_axis[0]
                for cut in (ncz - 1, 1):
                    got = range_iteration(fk, op, state, fk.Workspace(op),
                                          cut)
                    if not all(torch.equal(a, b) for a, b in zip(got, one)):
                        raise AssertionError(f"{tag}, cut {cut}: not the "
                                             f"one launch bitwise")
                want = fk._fused_iteration_plain(op, *state)
                r = (compare("fused_cg_iteration", got, want, dtype, tag,
                             quiet=True)[0] if rung == "highest" else
                     compare_rung("fused_cg_iteration", got, want, rung,
                                  tag, quiet=True)["rel"])
                key = (rung, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), r)
                del op, state, one, got, want
        torch.cuda.empty_cache()
    for (rung, dt), err in worst.items():
        print(f"  fused_cg_iteration layer-range form {rung} {dt} (rank 1 "
              f"of {[c[:2] for c in RANGE_CASES]}, both metrics, cuts n-1 "
              f"and 1): bitwise the one launch; vs plain max rel err "
              f"{err:.3e}")
    return worst


def time_range_form(fk, dev, timing) -> dict:
    """The layer-range form on rank 1 of DIST_FULL's z-slabs (dense, the
    metric streamed) under SLAB_TIMED, compared with and timed beside its
    plain version (the plain cell and assemble passes) and the one launch
    in turns; returns {suffix: ((kernel ms, plain ms), bound, max |diff|,
    one-launch ms)}."""
    p, s, n = DIST_FULL
    out = {}
    for rung, dtype, sfx in SLAB_TIMED:
        op = _slab_op(s, p, 1, n, dtype, rung, "precomputed", dev)
        state = _rank_state(op, dev, 11)
        ncz = op.n_cells_axis[0]
        work = fk.Workspace(op)
        bufs = tuple(torch.empty_like(t) for t in state[:5])
        want = fk._fused_iteration_plain(op, *state)
        _, diff = compare("fused_cg_iteration",
                          range_iteration(fk, op, state, work, ncz - 1),
                          want, dtype, f"layer-range {rung} {dtype}")

        def plain():
            fk._cells_plain(op, *state, bufs, work, 0, ncz - 1)
            fk._cells_plain(op, *state, bufs, work, ncz - 1, ncz)
            fk._assemble_plain(op, bufs, state[5], work)

        t = time_pair(lambda: range_iteration(fk, op, state, work, ncz - 1,
                                              bufs), plain, dev, timing)
        t_one = min(timing.time_per_call(
            lambda: fk.fused_cg_iteration(op, *state, out=bufs, work=work),
            dev, inner=20, repeats=3) for _ in range(2)) * 1e3
        b = bound("fused_cg_iteration", op, split=rung != "highest")
        print(f"  fused_cg_iteration layer-range form p={p} s={s} rank "
              f"1/{n} {rung} {str(dtype)[6:]} (cells [0, {ncz - 1}) + "
              f"[{ncz - 1}, {ncz}) + assemble): kernel {t[0]:.4f} ms, "
              f"plain {t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); the one "
              f"launch {t_one:.4f} ms")
        out[sfx] = t, b, diff, t_one
        del op, state, work, bufs, want
        torch.cuda.empty_cache()
    return out


def compare_sub_applies(la, dev) -> None:
    """B3/B5/B6 on rank 1 of DIST_FULL's z-slabs and on the operators of
    the overlapped apply's three layer ranges of it
    (``laplace_cuda.sub_operator``) against their plain versions, f32
    highest and split2m (on a block's lattice B5/B6 keep the faces'
    partial sums)."""
    from mf_data_locality_tpu_torch.ops import laplace_cuda
    from mf_data_locality_tpu_torch.parallel import distributed

    p, s, n = DIST_FULL
    names = {"reshape": "apply_local_batched_g",
             "pieces": "apply_lattice_pieces", "zslab": "apply_lattice_zslab"}
    worst = {}
    for rung in ("highest", "split2m"):
        for windowing, name in names.items():
            op = distributed.build_slab(s, p, 1, n, torch.float32, "pallas",
                                        rung, windowing, "precomputed",
                                        dev).op
            u = random_state(op, 1, seed=13)[0]
            ncz = op.n_cells_axis[0]
            for c0, c1 in ((0, ncz), (0, 1), (1, ncz - 1), (ncz - 1, ncz)):
                sub = laplace_cuda.sub_operator(op, c0, c1)
                us = u[:, c0 * p:c1 * p + 1].contiguous()
                got = la.apply_lattice(sub, us)
                if windowing == "reshape":  # B3 between the windowings
                    want = la.from_cell_batches(la._batched_plain(
                        sub, la.to_cell_batches(us, p), la._metric(sub),
                        True), p, sub.n_cells_axis)
                else:  # B5, B6 on the sub-range's mask
                    want = la._lattice_plain(sub, us, sub.mask)
                err = compare(name, got, want, torch.float32,
                              f"{rung} layers [{c0}, {c1})", quiet=True)[0]
                worst[name, rung] = max(worst.get((name, rung), 0.0), err)
            del op, u
    print("  B3/B5/B6 on rank 1/4 at p=4 s=15 and on the overlapped "
          "apply's layer ranges [0, 1), [1, n-1), [n-1, n) of it vs plain: "
          + ", ".join(
              f"{k[0]} {k[1]} {v:.3e}" for k, v in worst.items()))


def overlap_readings(out: dict) -> dict:
    """The overlapped drives against the ones without overlap in the same
    spawn: the fused solve bitwise (x, history, itCG), the merged one with
    itCG equal and x within TOL_OVERLAP_X32; the launches of the first
    solve (the layer-range form: two cell passes and one assemble an
    iteration a rank; the merged apply three B3 launches); each rank's
    face wait (``Comm.seconds["wait"]``) an iteration, the slowest rank's.
    Returns {"wait_ms": {label: ms}, "x_err": merged reading}."""
    import numpy as np

    n = len(out["fused"]["ranks"])
    a, b = out["fused"], out["fused_overlap"]
    if not (a["it"] == b["it"] and torch.equal(a["x"], b["x"])
            and np.array_equal(a["history"], b["history"], equal_nan=True)):
        raise AssertionError("solve_fused(overlap=True) is not the solve "
                             "without it bitwise")
    ls = {k: sum(r["launches_solve"][k] for r in b["ranks"])
          for k in ("fused_cg_iteration", "fused_cg_assemble")}
    if ls != {"fused_cg_iteration": 2 * n * b["it"],
              "fused_cg_assemble": n * b["it"]}:
        raise AssertionError(f"fused overlap launches {ls}")
    a, b = out["merged"], out["merged_overlap"]
    x_err = ((b["x"] - a["x"]).abs().max()
             / max(1.0, a["x"].abs().max().item())).item()
    nb3 = sum(r["launches_solve"]["apply_local_batched_g"]
              for r in b["ranks"])
    print(f"  overlap: fused split2m x and history bitwise the solve "
          f"without (itCG {out['fused_overlap']['it']}; B2 launches "
          f"{ls}); merged itCG {b['it']} vs {a['it']}, x {x_err:.3e} "
          f"max(1, |x|) from the solve without (tol {TOL_OVERLAP_X32:.0e}), "
          f"B3 launches {nb3} (3 layer ranges an apply)")
    if not (a["it"] == b["it"] and x_err <= TOL_OVERLAP_X32
            and nb3 == 3 * n * b["it"]):
        raise AssertionError("the overlapped merged solve disagrees")
    wait = {label: max(r["comm_s"]["wait"] for r in out[label]["ranks"])
            / out[label]["it"] * 1e3
            for label in ("merged", "merged_overlap", "fused",
                          "fused_overlap")}
    print("  face wait an iteration (the slowest rank's, first solve): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in wait.items()))
    return {"wait_ms": wait, "x_err": x_err}


def distributed_phase(benchmark, bp4, cg_fused, fk, dev) -> tuple:
    """f64 parity on DIST_RANKS z-slab ranks and on the MESH_FULL meshes,
    the DIST_FULL drives beside the single-device fused split2m path at
    the same point, the MESH_FULL drives and ``dryrun_multichip``'s legs
    on 4 and 8 ranks; returns the kernels' launches summed over each
    full-width run's ranks {job label: {kernel: n}}, its rows, and B2's
    launches summed over the ranks of each fused dry-run leg {(ranks,
    leg): n} (each must have launched it; the merged legs 1 and 5 run the
    structured backend, plain PyTorch)."""
    from mf_data_locality_tpu_torch.parallel import comm, distributed, dryrun

    Job = distributed.Job
    f64, f32 = torch.float64, torch.float32
    p, s = DIST_PARITY
    pf = bp4.build(s, p, f64, "highest", factor="dense",
                   metric="precomputed", windowing="pieces", device=dev)
    lat = (3,) + pf.layout.n_nodes_axis
    pm = bp4.build(s, p, f64, "highest", device=dev)
    ref = {"fused": cg_fused.fused_merged_cg_solve(
               pf.op, lat[1:], pf.b.reshape(lat),
               pf.inv_diag.reshape((1,) + lat[1:])),
           "merged": bp4.solve_merged(pm), "baseline": bp4.solve_baseline(pm)}
    del pf, pm
    jobs = [Job(solver, s, p, f64) for solver in ref]
    for n in DIST_RANKS:
        t0 = time.perf_counter()
        _parity(ref, jobs, distributed.launch(jobs, n, "cuda"), lat,
                f"{n} ranks")
        print(f"  ({time.perf_counter() - t0:.1f} s)")

    # one spawn a rank count: the z-slab full width and each mesh's f64
    # parity jobs and full-width drives
    launches, rows, out = {}, {}, {}
    p_full, s_full, n = DIST_FULL
    full = {n: {"merged": Job("merged", s_full, p_full, f32, timed=True,
                              solve_repeats=1),
                "fused": Job("fused", s_full, p_full, f32, "pallas",
                             "split2m", timed=True, solve_repeats=1),
                "fused_onthefly": Job("fused", s_full, p_full, f32,
                                      "pallas", "split2m",
                                      metric="onthefly", timed=True,
                                      solve_repeats=1),
                # --overlap: the CLI's merged solve, and solve_fused's
                "merged_overlap": Job("merged", s_full, p_full, f32,
                                      timed=True, solve_repeats=1,
                                      overlap=True),
                "fused_overlap": Job("fused", s_full, p_full, f32,
                                     "pallas", "split2m", timed=True,
                                     solve_repeats=1, overlap=True),
                # --backend general --devices 4, short
                "general": Job("merged", GENERAL_S, p_full, f32,
                               backend="general", timed=True,
                               solve_repeats=1, matvec_repeats=1,
                               matvec_inner=10),
                # the bf16 state (section 9): the CLI's merged solve with
                # --dtype bf16, and the fused solve (highest: C10's f32
                # carry, the JAX test's rung)
                "merged_bf16": Job("merged", s_full, p_full, BF,
                                   timed=True, solve_repeats=1,
                                   matvec_repeats=1, matvec_inner=10),
                "fused_bf16": Job("fused", s_full, p_full, BF, "pallas",
                                  "highest", timed=True, solve_repeats=1,
                                  matvec_repeats=1, matvec_inner=10)}}
    parity = {}
    for sfx, s_mesh, mesh in MESH_FULL:
        n = math.prod(mesh)
        parity[n] = [Job(solver, s, p, f64, mesh_shape=mesh)
                     for solver in ref]
        drives = full.setdefault(n, {})
        drives["fused" + sfx] = Job(
            "fused", s_mesh, p_full, f32, "pallas", "split2m",
            metric="onthefly" if len(mesh) == 3 else "precomputed",
            timed=True, solve_repeats=1,
            mesh_shape=mesh)
        if mesh == (2, 2):
            drives["merged" + sfx] = Job("merged", s_mesh, p_full, f32,
                                         timed=True, solve_repeats=1,
                                         mesh_shape=mesh)
    jobs, launches_dry = {}, {}
    for n, drives in full.items():
        t0 = time.perf_counter()
        print(f"  {comm.describe(n, 'cuda')}:")
        legs = dryrun.legs_for(n)
        res = distributed.launch(parity[n] + list(drives.values())
                                 + dryrun.jobs(n, legs), n, "cuda")
        mesh = parity[n][0].mesh_shape
        _parity(ref, parity[n], res[:3], lat,
                f"the {'x'.join(map(str, mesh))} mesh")
        for (label, job), r in zip(drives.items(), res[3:]):
            print(f"  ranks {'x'.join(map(str, job.mesh(n)))}, p={p_full} "
                  f"s={job.s}:")
            out[label], jobs[label] = r, job
            launches[label], rows[label] = _drive(benchmark, label, job, r)
        print(f"  dryrun_multichip({n}) in the same spawn:")
        dry = res[3 + len(drives):]
        dryrun.report(n, legs, dry)
        for leg, r in zip(legs, dry):
            if leg in (1, 4, 5):  # the structured and general backends
                continue
            launches_dry[n, leg] = sum(
                x["launches_solve"]["fused_cg_iteration"] for x in r["ranks"])
            if not launches_dry[n, leg]:
                raise AssertionError(f"dryrun_multichip({n}) leg {leg} "
                                     f"launched no fused_cg_iteration")
        print(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    # the solutions: |b - A x| by one device's operator of the same
    # configuration against the distributed solve's residual estimate
    pb = bp4.build(s_full, p_full, f32, "highest", device=dev)
    for label in ("merged", "merged_overlap", "merged_block2d"):
        _true_residual(fk, pb, out[label], label)
    del pb
    pb = bp4.build(s_full, p_full, f32, "split2m", factor="dense",
                   metric="onthefly", windowing="pieces", device=dev)
    _true_residual(fk, pb, out["fused_onthefly"], "fused_onthefly")
    del pb
    torch.cuda.empty_cache()
    dense_pre = bp4.build(s_full, p_full, f32, "split2m", factor="dense",
                          metric="precomputed", windowing="pieces",
                          device=dev)
    for label in ("fused", "fused_overlap", "fused_block2d"):
        _true_residual(fk, dense_pre, out[label], label)
    pb = bp4.build(MESH_FULL[1][1], p_full, f32, "split2m", factor="dense",
                   metric="onthefly", windowing="pieces", device=dev)
    _true_residual(fk, pb, out["fused_block3d"], "fused_block3d")
    del pb
    torch.cuda.empty_cache()
    for label, kw in (("one device, fused auto split2m", {}),
                      ("one device, fused dense precomputed split2m",
                       dict(factor="dense", metric="precomputed",
                            problem=dense_pre))):
        r1 = benchmark.run_one(p_full, s_full, solver="fused",
                               windowing="pieces", precision="split2m",
                               device=dev, solve_repeats=2, **kw)
        rows[label] = r1
        print(f"  {label}: {r1.row()}")
    del dense_pre
    # the bf16 state: the merged solve's count is the single-device
    # bf16 solve's (the JAX package's claim,
    # tests/test_distributed.py:326-336); the fused one within 2 of its
    # single-device solve
    pb = bp4.build(s_full, p_full, BF, "highest", device=dev)
    one = bp4.solve_merged(pb)
    n_bf16 = len(out["merged_bf16"]["ranks"])
    print(f"  merged_bf16: itCG {out['merged_bf16']['it']} on {n_bf16} "
          f"ranks, {one.n_iterations} on one device")
    if out["merged_bf16"]["it"] != one.n_iterations:
        raise AssertionError("the distributed merged bf16 solve's count is "
                             "not the single-device one's")
    cfg = dict(factor="dense", metric="precomputed", windowing="pieces")
    pb = bp4.build(s_full, p_full, BF, "highest", device=dev, **cfg)
    lat1 = (3,) + pb.layout.n_nodes_axis
    one = cg_fused.fused_merged_cg_solve(pb.op, lat1[1:], pb.b.reshape(lat1),
                                         pb.inv_diag.reshape(
                                             (1,) + lat1[1:]))
    print(f"  fused_bf16: itCG {out['fused_bf16']['it']} on {n_bf16} "
          f"ranks, {one.n_iterations} on one device")
    if abs(out["fused_bf16"]["it"] - one.n_iterations) > 2:
        raise AssertionError("the distributed fused bf16 solve is not the "
                             "single-device one")
    del pb, one
    torch.cuda.empty_cache()
    print(f"  the solutions and one device ({time.perf_counter() - t0:.1f} "
          f"s)")
    overlap = overlap_readings(out)
    for label, kern in (("merged", "apply_local_batched_g"),
                        ("merged_overlap", "apply_local_batched_g"),
                        ("fused_overlap", "fused_cg_iteration"),
                        ("fused_overlap", "fused_cg_assemble"),
                        ("fused_overlap", "apply_lattice_pieces"),
                        ("fused", "fused_cg_iteration"),
                        ("fused", "apply_lattice_pieces"),
                        ("fused_onthefly", "fused_cg_iteration"),
                        ("merged_block2d", "apply_local_batched_g"),
                        ("fused_block2d", "fused_cg_iteration"),
                        ("fused_block3d", "fused_cg_iteration"),
                        ("merged_bf16", "apply_local_batched_g"),
                        ("fused_bf16", "fused_cg_iteration")):
        if not launches[label][kern]:
            raise AssertionError(f"the distributed {label} path launched "
                                 f"no {kern}")
    return launches, rows, launches_dry, overlap


def shape_section(dev, drive, short: dict, log: str) -> tuple[dict, dict]:
    """Section 11: the shapes beyond BP4's, CEED BP3 and q = p + 1 (queue
    B 6g): the shape instantiations' registers, every kernel against its
    plain version on the box, shape_check.TIMED's rows, SHAPE_DRIVES
    through ``drive`` (main()'s: a ``run_one`` with the launch counts
    zeroed before and read after) and SHAPE_PARITY.  Returns (the timed
    rows, {key: launches})."""
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.solvers import cg_fused
    from mf_data_locality_tpu_torch.utils import shape_check as shc
    from mf_data_locality_tpu_torch.utils import timing

    t11 = time.perf_counter()
    shc.print_table(log)
    print(f"the shapes beyond BP4's (BP3, q = p + 1, both) vs plain on the "
          f"{'x'.join(map(str, shc.RAGGED))} box at p=1..11:")
    shc.report(shc.compare_all(dev))
    print(f"  ({time.perf_counter() - t11:.1f} s)")
    shape_times = shc.time_all(dev, lambda k, p: time_pair(k, p, dev, timing),
                               bound)
    launches_sh = {}
    for label, key, c, dq, p, s_d, expect, full, kw in SHAPE_DRIVES:
        dtype = torch.float32
        config = benchmark.resolve_config(p, kw["solver"], kw["windowing"],
                                          kw["precision"], dtype,
                                          **{k: v for k, v in kw.items()
                                             if k == "metric"})
        pb = bp4.build(s_d, p, dtype, kw["precision"],
                       windowing=kw["windowing"], device=dev,
                       n_components=c, n_q=p + dq,
                       **dict(zip(("factor", "metric", "cofactor"), config)))
        r = drive(f"{label} C={c} q={p + dq}", s_d, expect, degree=p,
                  into=launches_sh.setdefault(key, {}), quiet=not full,
                  problem=pb, **kw, **({} if full else short))
        if full and r.n_dofs != SHAPE_FULL[key]:
            raise AssertionError(f"{label}: {r.n_dofs} DoFs, not the "
                                 f"full-width point's {SHAPE_FULL[key]}")
        del pb
        torch.cuda.empty_cache()
    for p, s_p, c, dq, want in SHAPE_PARITY:
        for solver, precision, dtype in (("merged", "highest",
                                          torch.float64),
                                         ("fused", "highest", torch.float64),
                                         ("fused", "split2m",
                                          torch.float32)):
            w = "pieces" if solver == "fused" else "reshape"
            config = benchmark.resolve_config(p, solver, w, precision, dtype)
            pb = bp4.build(s_p, p, dtype, precision, windowing=w, device=dev,
                           n_components=c, n_q=p + dq,
                           **dict(zip(("factor", "metric", "cofactor"),
                                      config)))
            lat = pb.layout.n_nodes_axis
            if solver == "merged":
                res = bp4.solve_merged(pb)
            else:
                res = cg_fused.fused_merged_cg_solve(
                    pb.op, lat, pb.b.reshape(pb.lattice_shape),
                    pb.inv_diag.reshape((1,) + lat))
            n = res.n_iterations
            print(f"  parity p={p} s={s_p} C={c} q={p + dq} {solver} "
                  f"{str(dtype)[6:]} {precision} {config}: itCG {n} "
                  f"(JAX f64 {want}), converged {res.converged}")
            if precision == "highest":
                ok = n == want and res.converged
            else:
                ok = res.converged and want <= n <= want + 3
                if not res.converged and n == 100:
                    hist = res.res_history.cpu().numpy()
                    ok = edge_witness(pb, hist, n, s_p, p)[0]
            if not ok:
                raise AssertionError(f"parity p={p} s={s_p} C={c} "
                                     f"q={p + dq} {solver} {precision}: "
                                     f"itCG {n}, the JAX package's {want}")
            del pb
    torch.cuda.empty_cache()
    print(f"section 11: {time.perf_counter() - t11:.1f} s")
    return shape_times, launches_sh


def main() -> int:
    T0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
    from mf_data_locality_tpu_torch.ops import laplace_apply as la
    from mf_data_locality_tpu_torch.solvers import cg_fused
    from mf_data_locality_tpu_torch.utils import shape_check as shc
    from mf_data_locality_tpu_torch.utils import timing

    # name -> (wrapper, source, TPU kernel it replaces)
    kernels = {
        "matvec": (fk.matvec, "cg_fused.cu", "cg_fused_kernel.py:1116"),
        "fused_cg_iteration": (fk.fused_cg_iteration, "cg_fused.cu",
                               "cg_fused_kernel.py:1476"),
        "apply_local_batched_g": (la.apply_local_batched_g,
                                  "apply_sumfac.cuh", "laplace_pallas.py:1023"),
        "apply_local_batched_onthefly": (la.apply_local_batched_onthefly,
                                         "apply_sumfac.cuh",
                                         "laplace_pallas.py:1043"),
        "apply_lattice_pieces": (la.apply_lattice_pieces, "apply_sumfac.cuh",
                                 "laplace_pallas.py:947"),
        "apply_lattice_zslab": (la.apply_lattice_zslab, "apply_sumfac.cuh",
                                "laplace_pallas.py:664"),
    }

    def zero_counts():
        for fn, _, _ in kernels.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, (fn, _, _) in kernels.items()}

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib_path.name})")
    entry = ""  # the kernel a ptxas line is about
    regs = {}  # (tensor-core pass, NP) -> registers
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.split("for ")[-1].strip()
        elif re.search(r"[1-9]\d* bytes spill", line):
            print("  ptxas:", entry[:72], line.strip())
        elif "registers" in line and ("mma" in entry or "dense_hd" in entry):
            kern = re.search(r"(apply_mma|cells_mma_hd|cells_mma|dense_hd_"
                             r"gather|dense_hd_forward|dense_hd_backward)"
                             r"_kernel", entry)[1]
            n_prod = re.findall(r"Li(\d+)E", entry)[-1]
            regs.setdefault((kern, n_prod), []).append(
                int(re.search(r"(\d+) registers", line)[1]))
    for (kern, n_prod), r in sorted(regs.items()):
        # NP: the products a tile, and above them the storage flags and
        # the chain (bp4_operator.cuh's kSbState 4, kSbMetric 8, kJtjChain
        # 16)
        print(f"  ptxas: {kern}_kernel, NP {n_prod}, {len(r)} "
              f"instantiations: {min(r)}-{max(r)} registers")
    slowest = sorted(re.findall(r"^nvcc: (.*) ([\d.]+) s$", log, re.M),
                     key=lambda x: -float(x[1]))[:3]
    print("  slowest compiles: " + ", ".join(f"{n} {t} s"
                                             for n, t in slowest))

    print(f"(phase 3 starts at {time.perf_counter() - T0:.1f} s)")
    # -- 3. kernels vs plain versions at the main paths' size -------------
    print("kernels vs plain:")
    errs, times, errs_split, times_split, bounds = {}, {}, {}, {}, {}
    # B1-B6 at f64 highest, B1/B2 at f32 highest and in the dense
    # configurations: (kernel ms, plain ms), bound, max |diff|
    f64, highest = {}, {}
    dense = {run[-1]: {} for run in DENSE_RUNS}
    for dtype, precision, config, p, s, sfx in FUSED_RUNS:
        pb = bp4.build(s, p, dtype, precision, device=dev, **config)
        op = pb.op
        prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
        tag = (f"p={p} s={s} {str(dtype)[6:]} {precision} {op.factor} "
               f"{op.metric}")

        (d,) = random_state(op, 1, seed=1)
        _, diff = compare("matvec", fk.matvec(op, d), fk._matvec_plain(op, d),
                          dtype, tag)

        x, g, dd, h = random_state(op, 4, seed=2)
        scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                            dtype=dtype, device=dev)
        _, fdiff = compare(
            "fused_cg_iteration",
            fk.fused_cg_iteration(op, x, g, dd, h, scal, prec),
            fk._fused_iteration_plain(op, x, g, dd, h, scal, prec), dtype, tag)

        out = torch.empty_like(d)
        work = fk.Workspace(op)
        bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
        t = {"matvec": time_pair(
                 lambda: fk.matvec(op, d, out=out, work=work),
                 lambda: fk._matvec_plain(op, d), dev, timing),
             "fused_cg_iteration": time_pair(
                 lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                               out=bufs, work=work),
                 lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal,
                                                   prec), dev, timing)}
        for name, err in (("matvec", diff), ("fused_cg_iteration", fdiff)):
            b = bound(name, op, split=precision == "split2m")
            print(f"  {name} {tag}: kernel {t[name][0]:.4f} ms, plain "
                  f"{t[name][1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
            if sfx in dense:
                dense[sfx][name] = t[name], b, err
            elif dtype == torch.float64:
                f64[name] = t[name], b, err
            elif precision == "highest":
                highest[name] = t[name], b, err
            else:
                errs[name], times[name], bounds[name] = err, t[name], b
        del pb, op, d, x, g, dd, h
        out = work = bufs = None
        torch.cuda.empty_cache()

    for dtype, precision in ((torch.float32, "highest"),
                             (torch.float32, "split2m"),
                             (torch.float64, "highest")):
        tag = f"p={DEGREE} s={S} {str(dtype)[6:]} {precision}"
        ops = {"precomputed": bp4.build(S, DEGREE, dtype, precision,
                                        factor="dense", metric="precomputed",
                                        windowing="reshape", device=dev).op}
        if precision == "highest":  # B4 is exact on every rung
            ops["onthefly"] = bp4.build(S, DEGREE, dtype, precision,
                                        factor="dense", metric="onthefly",
                                        windowing="reshape", device=dev).op
        opg = ops["precomputed"]
        (u,) = random_state(opg, 1, seed=3)
        u_loc = la.to_cell_batches(u, DEGREE).contiguous()
        split = precision == "split2m"
        cases = {
            "apply_local_batched_g": (
                lambda: la.apply_local_batched_g(opg, u_loc),
                lambda: la._batched_plain(opg, u_loc, la._metric(opg),
                                          split)),
            "apply_lattice_pieces": (
                lambda: la.apply_lattice_pieces(opg, u),
                lambda: la._lattice_plain(opg, u, la._index_mask(opg))),
            "apply_lattice_zslab": (
                lambda: la.apply_lattice_zslab(opg, u),
                lambda: la._lattice_plain(opg, u, opg.mask)),
        }
        if "onthefly" in ops:
            opo = ops["onthefly"]
            cases["apply_local_batched_onthefly"] = (
                lambda: la.apply_local_batched_onthefly(opo, u_loc),
                lambda: la._batched_plain(opo, u_loc, la._metric(opo),
                                          False))
        for name, (kern, plain) in cases.items():
            rel, diff = rel_err(kern(), plain())
            check(f"{name} {tag}", rel, TOL[dtype])
            onthefly = name.endswith("onthefly")
            t = time_pair(kern, plain, dev, timing, inner=10)
            b = bound(name, opo if onthefly else opg, split)
            print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} "
                  f"ms, bound {b[0]:.4f} ms ({b[1]})")
            if dtype == torch.float64:
                f64[name] = t, b, diff
            elif precision == "highest":
                errs[name], times[name], bounds[name] = diff, t, b
            else:
                errs_split[name], times_split[name] = diff, t
                bounds[name + "_split2m"] = b
        del ops, opg, u, u_loc, cases
        torch.cuda.empty_cache()

    # p >= 5: every kernel at every degree on a small box, then at the
    # full-width points, f32 (B1/B2 also f64 at p=F64_HIGH)
    print(f"kernels vs plain at p={HIGH_DEGREES[0]}..{HIGH_DEGREES[-1]} "
          f"(highest, f32 and f64):")
    print(f"  (p >= 5 box: {time.perf_counter() - T0:.1f} s since the start)")
    compare_high_degrees(fk, la, dev)
    high = {}  # key suffix -> name -> ((ms, plain ms), bound, max |diff|)
    for p, s, sfx in FULL_HIGH:
        high[sfx] = time_high(fk, la, dev, timing, p, s, torch.float32)
        if p == F64_HIGH:
            high[sfx + "_f64"] = time_high(fk, la, dev, timing, p, s,
                                           torch.float64)
    print(f"kernels vs plain under split2m at p={SPLIT_CMP[0]}.."
          f"{SPLIT_CMP[-1]} (B1/B2 twostage, f32):")
    print(f"  (split2m twostage: {time.perf_counter() - T0:.1f} s since the start)")
    compare_split_high(fk, dev)
    split_hi = {}  # "_split2m" + p's suffix -> name -> (times, bound, diff)
    for p, s, sfx in FULL_HIGH:
        split_hi["_split2m" + sfx] = time_split_high(fk, dev, timing, p, s)
    print("kernels vs plain under split3 and bf16:")
    print(f"  (the reduced rungs: {time.perf_counter() - T0:.1f} s since the start)")
    compare_reduced_box(fk, la, dev)
    reduced = {}  # rung's suffix (+ p's) -> name -> (times, bound, diff)
    for rung, state, mdt, sfx in REDUCED:
        reduced[sfx] = time_reduced(fk, dev, timing, DEGREE, S, rung, state,
                                    mdt)
        reduced[sfx].update(time_reduced_apply(la, dev, timing, rung, mdt))
        for p, s, x in FULL_HIGH:
            reduced[sfx + x] = time_reduced(fk, dev, timing, p, s, rung,
                                            state, mdt)
    print(f"kernels vs plain, the dense tensor-core pass at p="
          f"{HIGH_DEGREES[0]}..{HIGH_DEGREES[-1]} (split2m, split3, bf16):")
    print(f"  (the dense pass: {time.perf_counter() - T0:.1f} s since the "
          f"start)")
    compare_dense_box(fk, la, dev)
    dense_hi = {}  # rung's suffix + p's -> name -> (times, bound, diff)
    for rung, state, mdt, sfx in DENSE_RUNGS:
        for p, s, x in FULL_HIGH:
            dense_hi[sfx + x] = time_dense(fk, la, dev, timing, p, s, rung,
                                           state, mdt)

    print(f"(phase 4 starts at {time.perf_counter() - T0:.1f} s)")
    # -- 4. convergence class at the parity point p=4, s=7 ---------------
    for dtype, precision, allowed in ((torch.float64, "highest", (91,)),
                                      (torch.float32, "highest",
                                       (91, 92, 93, 94)),
                                      (torch.float32, "split2m",
                                       (91, 92, 93, 94))):
        pb = bp4.build(7, DEGREE, dtype, precision, device=dev, **FUSED)
        lat = pb.layout.n_nodes_axis
        res = cg_fused.fused_merged_cg_solve(
            pb.op, lat, pb.b.reshape((3,) + lat),
            pb.inv_diag.reshape((1,) + lat))
        print(f"p=4 s=7 fused {str(dtype)[6:]} {precision}: itCG "
              f"{res.n_iterations}, converged {res.converged}")
        if res.n_iterations not in allowed or not res.converged:
            raise AssertionError(f"p=4 s=7 fused {precision}: itCG "
                                 f"{res.n_iterations} not in {allowed}")
    for dtype, precision, metric, allowed, solvers in (
            (torch.float64, "highest", "precomputed", (91,),
             ("merged", "baseline")),
            (torch.float64, "highest", "onthefly", (91,), ("merged",)),
            (torch.float32, "highest", "precomputed", (91, 92, 93, 94),
             ("merged", "baseline")),
            (torch.float32, "split2m", "precomputed", (91, 92, 93, 94),
             ("merged",))):
        pb = bp4.build(7, DEGREE, dtype, precision, factor="dense",
                       metric=metric, windowing="reshape", device=dev)
        its = {}
        for solver in solvers:
            res = benchmark.solver_call(pb, solver)()
            its[solver] = res.n_iterations
            print(f"p=4 s=7 {solver} {str(dtype)[6:]} {precision} {metric}: "
                  f"itCG {res.n_iterations}, converged {res.converged}")
            if res.n_iterations not in allowed or not res.converged:
                raise AssertionError(f"p=4 s=7 {solver} {metric}: itCG "
                                     f"{res.n_iterations} not in {allowed}")
        if dtype == torch.float64 and len(set(its.values())) > 1:
            raise AssertionError(f"merged and baseline itCG differ: {its}")

    # the fused solver through the auto-dispatch at the parity points
    # (PARITY.md:91-123): (p, s, f64 itCG allowed, split2m allowed or None).
    # p=3 s=9 sits on the tolerance's edge: JAX merged f64 stops at 95 with
    # its residual 0.3% above it, so any summation order may stop one
    # earlier.  f32 split2m levels off there at 0.9-2.4e-8 res0, about the
    # 1e-8 tolerance (the TPU stopped at 96, the plain version on the CPU
    # stops at 96): if it does not converge, edge_witness must show that the
    # kernel's sums are right and that it is the rung's floor, and the
    # residual must be within 10x the tolerance by the f64 count
    for p, s, allowed64, allowed_split in ((2, 11, (87,), range(87, 91)),
                                           (3, 9, (94, 95), range(94, 99)),
                                           (4, 7, (91,), None)):
        its = {}
        for dtype, precision in ((torch.float64, "highest"),
                                 (torch.float32, "highest"),
                                 (torch.float32, "split2m")):
            if precision == "split2m" and allowed_split is None:
                continue  # p=4 split2m: twostage + onthefly, checked above
            factor, metric, _ = benchmark.resolve_config(
                p, "fused", "pieces", precision, dtype)
            pb = bp4.build(s, p, dtype, precision, factor=factor,
                           metric=metric, windowing="pieces", device=dev)
            lat = pb.layout.n_nodes_axis
            res = cg_fused.fused_merged_cg_solve(
                pb.op, lat, pb.b.reshape((3,) + lat),
                pb.inv_diag.reshape((1,) + lat))
            n = its[(dtype, precision)] = res.n_iterations
            n64 = its[(torch.float64, "highest")]  # run first
            allowed = (allowed64 if dtype == torch.float64 else allowed_split
                       if precision == "split2m" else range(n64, n64 + 4))
            hist = res.res_history.cpu().numpy()
            at64 = hist[min(n, n64)] / hist[0]
            print(f"p={p} s={s} fused auto {str(dtype)[6:]} {precision} "
                  f"({factor}, {metric}), n_dofs {pb.n_dofs}: itCG {n}, "
                  f"converged {res.converged}, residual at it {n64} "
                  f"{at64:.3e} res0")
            ok = res.converged and n in allowed
            if not res.converged and (p, precision, n) == (3, "split2m", 100):
                ok = at64 <= 1e-7 and edge_witness(pb, hist, n, s, p)[0]
            if not ok:
                raise AssertionError(f"p={p} s={s} fused {precision}: itCG "
                                     f"{n}, converged {res.converged}; "
                                     f"allowed {tuple(allowed)}")
        if p != 3:  # fused == merged in f64 away from the tolerance's edge
            pb = bp4.build(s, p, torch.float64, "highest", device=dev)
            n = bp4.solve_merged(pb).n_iterations
            print(f"p={p} s={s} merged f64 highest: itCG {n}")
            if n != its[(torch.float64, "highest")]:
                raise AssertionError(f"p={p} s={s}: fused and merged f64 "
                                     f"itCG differ ({its}, merged {n})")
        del pb

    parity_high(benchmark, bp4, dev)
    parity_split(benchmark, bp4, dev)
    parity_reduced(benchmark, bp4, dev)
    parity_merged_split(bp4, dev)

    print(f"(phase 5 starts at {time.perf_counter() - T0:.1f} s)")
    # -- 5. the paths -----------------------------------------------------
    bw = timing.measure_hbm_bandwidth(dev)
    launches, launches_split, launches_highest = {}, {}, {}

    def drive(label, s, expect, into=launches, degree=DEGREE, quiet=False,
              **kw):
        zero_counts()
        r = benchmark.run_one(degree, s, device=dev, **kw)
        got = counts()
        share = r.dofs_per_s_per_it / (bw / 36)  # 9 f32 words/DoF (bench.py)
        if quiet:
            print(f"  {label} p={degree} s={s}: itCG {r.n_iterations} "
                  f"time/it {r.time_per_it:.3e} s launches "
                  f"{[got[name] for name in expect]}")
        else:
            print(f"{label} p={degree} s={s}: n_dofs {r.n_dofs} itCG "
                  f"{r.n_iterations} converged {r.converged} time/it "
                  f"{r.time_per_it:.6e} s DoF/s/it "
                  f"{r.dofs_per_s_per_it:.6e} time/matvec "
                  f"{r.time_per_matvec:.6e} s roofline share {share:.4f}")
            print(f"  launches: { {k: v for k, v in got.items() if v} }")
        if min(got[name] for name in expect) <= 0:
            raise AssertionError(f"{label}: a kernel of the path never "
                                 f"ran: {got}")
        if not (0 < r.n_iterations <= 100 and r.time_per_it > 0
                and r.time_per_matvec > 0):
            raise AssertionError(f"{label}: implausible row: {r}")
        if into is not None:
            into.update({name: got[name] for name in expect})
        return r

    print(f"triad {bw / 1e9:.1f} GB/s")
    r_fused = drive("fused path (f32 split2m, pieces)", S,
                    ("matvec", "fused_cg_iteration"), solver="fused",
                    precision="split2m", windowing="pieces")
    r_main = drive("main path (merged, f32 highest, reshape)", S,
                   ("apply_local_batched_g",), solver="merged",
                   precision="highest", windowing="reshape")
    r_split = drive("merged, f32 split2m, reshape", S,
                    ("apply_local_batched_g",), into=launches_split,
                    solver="merged", precision="split2m", windowing="reshape")
    short = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=5)
    # the fused solver in each dense configuration of phase 3, at its p and s
    launches_dense = {sfx: {} for sfx in dense}
    full = [r_fused, r_main, r_split]
    for dtype, precision, config, p, s, sfx in DENSE_RUNS:
        fm = (config["factor"], config["metric"])
        auto = benchmark.resolve_config(p, "fused", "pieces", precision,
                                        dtype)[:2] == fm
        r = drive(f"fused {'auto' if auto else 'explicit'}, "
                  f"{str(dtype)[6:]} {precision} {fm}", s,
                  ("matvec", "fused_cg_iteration"),
                  into=launches_dense[sfx], degree=p, solver="fused",
                  dtype=dtype, precision=precision, windowing="pieces",
                  **({} if auto else dict(zip(("factor", "metric"), fm))),
                  **({} if sfx in FULL_WIDTH else short))
        if sfx in FULL_WIDTH:
            full.append(r)
    if len(full) != 3 + len(FULL_WIDTH) or any(
            r.n_dofs != 1_635_075 for r in full):
        raise AssertionError(f"main-path rows at the wrong size: {full}")
    # B3's count in the kernels line is the main path's
    drive("baseline (reshape)", S_SHORT, ("apply_local_batched_g",),
          into=None, solver="baseline", **short)
    drive("merged --geometry onthefly", S_SHORT,
          ("apply_local_batched_onthefly",), solver="merged",
          metric="onthefly", **short)
    drive("merged --windowing pieces", S_SHORT, ("apply_lattice_pieces",),
          solver="merged", windowing="pieces", **short)
    drive("merged --windowing zslab", S_SHORT, ("apply_lattice_zslab",),
          solver="merged", windowing="zslab", **short)
    drive("merged --windowing zslab, f32 split2m", S_SHORT,
          ("apply_lattice_zslab",), into=launches_split, solver="merged",
          windowing="zslab", precision="split2m", **short)
    drive("fused, f32 highest (twostage, onthefly)", S_SHORT,
          ("matvec", "fused_cg_iteration"), into=launches_highest,
          solver="fused", precision="highest", factor="twostage",
          metric="onthefly", windowing="pieces", **short)

    # p >= 5: at each full-width point the JAX CLI's default path (B3) and
    # the fused auto path (B1, B2) at full depth, the fused solver in f64
    # at p=F64_HIGH, and short runs of the other paths of each kernel
    # (their counts are the rows' launches there) and of the fused solver
    # with the metric rebuilt (jtj)
    launches_hi = {sfx: {} for sfx in (*high, *split_hi)}
    fused_kw = dict(solver="fused", windowing="pieces", precision="highest")
    b1b2 = ("matvec", "fused_cg_iteration")
    for p, s, sfx in FULL_HIGH:
        into = launches_hi[sfx]
        rows = [drive("main path (merged, f32 highest, reshape)", s,
                      ("apply_local_batched_g",), into=into, degree=p,
                      solver="merged", precision="highest",
                      windowing="reshape"),
                drive("fused auto (f32 highest: twostage, precomputed)", s,
                      b1b2, into=into, degree=p, **fused_kw)]
        # the same point's split2m auto path (twostage + onthefly + jtj)
        r_split2m = drive("fused auto (f32 split2m: twostage, onthefly, jtj)",
                          s, b1b2, into=launches_hi["_split2m" + sfx],
                          degree=p, solver="fused", windowing="pieces",
                          precision="split2m")
        rows.append(r_split2m)
        print(f"  p={p} s={s} fused auto, split2m vs highest: time/it "
              f"{r_split2m.time_per_it:.6e} vs {rows[1].time_per_it:.6e} s, "
              f"itCG {r_split2m.n_iterations} vs {rows[1].n_iterations}, "
              f"time/matvec {r_split2m.time_per_matvec:.6e} vs "
              f"{rows[1].time_per_matvec:.6e} s")
        if p == F64_HIGH:
            drive("fused auto, f64", s, b1b2, into=launches_hi[sfx + "_f64"],
                  degree=p, dtype=torch.float64, **fused_kw, **short)
        for label, expect, kw in (
                ("baseline (reshape)", None, dict(solver="baseline")),
                ("merged --geometry onthefly",
                 ("apply_local_batched_onthefly",),
                 dict(solver="merged", metric="onthefly")),
                ("merged --windowing pieces", ("apply_lattice_pieces",),
                 dict(solver="merged", windowing="pieces")),
                ("merged --windowing zslab", ("apply_lattice_zslab",),
                 dict(solver="merged", windowing="zslab")),
                ("fused --geometry onthefly (jtj)", None,
                 dict(metric="onthefly", **fused_kw))):
            drive(label, s, expect or (("apply_local_batched_g",)
                                       if kw["solver"] == "baseline"
                                       else b1b2),
                  into=into if expect else None, degree=p, **kw, **short)
        want = FULL_DOFS[p]
        if any(r.n_dofs != want for r in rows):
            raise AssertionError(f"p={p} rows at the wrong size: {rows}")
    print(f"  (every degree: {time.perf_counter() - T0:.1f} s since the start)")
    # every degree 5..11 on a small mesh: each path, and the fused solver
    # in every HIGH_FUSED configuration; at the degrees of FULL_HIGH those
    # that the drives above ran there (FULL_DRIVEN) are not run again
    print(f"paths at every degree {HIGH_DEGREES[0]}..{HIGH_DEGREES[-1]}, "
          f"s={S_EVERY}, f32 highest:")
    tiny = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=2,
                quiet=True, into=None)
    full_p = {p for p, _, _ in FULL_HIGH}
    for p in HIGH_DEGREES:
        for label, expect, kw in (
                ("merged reshape", ("apply_local_batched_g",),
                 dict(solver="merged")),
                ("baseline", ("apply_local_batched_g",),
                 dict(solver="baseline")),
                ("merged onthefly", ("apply_local_batched_onthefly",),
                 dict(solver="merged", metric="onthefly")),
                ("merged pieces", ("apply_lattice_pieces",),
                 dict(solver="merged", windowing="pieces")),
                ("merged zslab", ("apply_lattice_zslab",),
                 dict(solver="merged", windowing="zslab")),
                *((f"fused {f} {m} {c}", b1b2,
                   dict(factor=f, metric=m, cofactor=c, **fused_kw))
                  for f, m, c in HIGH_FUSED),
                *((f"fused split2m twostage {m} {c}", b1b2,
                   dict(solver="fused", windowing="pieces",
                        precision="split2m", metric=m, cofactor=c))
                  for m, c in SPLIT_HIGH)):
            if p in full_p and label in FULL_DRIVEN:
                continue
            drive(label, S_EVERY, expect, degree=p, **kw, **tiny)

    # the reduced rungs: bench.py's split3 and bf16 lines at full depth
    # (the fused auto path at p=4 s=13), B3/B5/B6 under each (merged,
    # short), the fused auto path short at FULL_HIGH and at every degree
    # 5..11 (s=6)
    print(f"  (the reduced rungs' drives: {time.perf_counter() - T0:.1f} s "
          f"since the start)")
    launches_red = {sfx: {} for sfx in reduced}
    r_red = {}
    for rung, state, mdt, sfx in REDUCED:
        kw = dict(solver="fused", windowing="pieces", precision=rung,
                  dtype=state, metric_dtype=mdt)
        r_red[sfx] = drive(f"fused path ({rung}, {str(state)[6:]} state, "
                           f"pieces)", S, b1b2, into=launches_red[sfx], **kw)
        print(f"  {rung} vs split2m: DoF/s/it "
              f"{r_red[sfx].dofs_per_s_per_it:.6e} vs "
              f"{r_fused.dofs_per_s_per_it:.6e}, time/it "
              f"{r_red[sfx].time_per_it:.6e} vs {r_fused.time_per_it:.6e} "
              f"s, itCG {r_red[sfx].n_iterations} vs {r_fused.n_iterations}")
        for label, windowing, name in (
                ("reshape", "reshape", "apply_local_batched_g"),
                ("--windowing pieces", "pieces", "apply_lattice_pieces"),
                ("--windowing zslab", "zslab", "apply_lattice_zslab")):
            drive(f"merged {label}, {rung}", S_SHORT, (name,),
                  into=launches_red[sfx], solver="merged",
                  windowing=windowing, precision=rung, metric_dtype=mdt,
                  **short)
        for p, s, x in FULL_HIGH:
            drive(f"fused auto ({rung})", s, b1b2,
                  into=launches_red[sfx + x], degree=p, **kw, **short)
        for p in HIGH_DEGREES:
            if p not in full_p:  # FULL_HIGH's drives ran there
                drive(f"fused auto ({rung})", S_EVERY, b1b2, degree=p, **kw,
                      **tiny)

    # the dense tensor-core pass past p=4: the merged solver under split2m
    # at DENSE_MAIN at full depth (B3), and at each full-width point and
    # rung short runs of the timed kernels' paths (their counts are the
    # rows' launches there); then at every degree 5..11 on every rung the
    # merged solver on each windowing, the baseline solver on one
    # (rotating) and the fused solver's --factor dense, short (p >= 9: the
    # merged reshape and the fused paths only)
    print(f"  (the dense pass's drives: {time.perf_counter() - T0:.1f} s since the start)")
    launches_dh = {sfx: {} for sfx in dense_hi}
    r_dense_main = None
    for rung, state, mdt, sfx in DENSE_RUNGS:
        fused_dense = dict(solver="fused", windowing="pieces", precision=rung,
                           dtype=state, metric_dtype=mdt, factor="dense")
        for p, s, x in FULL_HIGH:
            into = launches_dh[sfx + x]
            for label, name, kw in (
                    ("merged reshape", "apply_local_batched_g", {}),
                    ("merged --windowing pieces (twostage: B5 on the dense "
                     "M)", "apply_lattice_pieces", dict(windowing="pieces")),
                    ("merged --windowing zslab", "apply_lattice_zslab",
                     dict(windowing="zslab"))):
                main = (rung == "split2m" and (p, s) == DENSE_MAIN
                        and name == "apply_local_batched_g")
                r = drive(f"{label}, {rung}", s, (name,), into=into,
                          degree=p, solver="merged", precision=rung,
                          metric_dtype=mdt, **kw, **({} if main else short))
                if main:
                    r_dense_main = r
            drive(f"fused --factor dense, {rung} ({str(state)[6:]} state)", s,
                  b1b2, into=into, degree=p, **fused_dense, **short)
    if r_dense_main is None or r_dense_main.n_dofs != FULL_DOFS[6]:
        raise AssertionError(f"the merged split2m drive: {r_dense_main}")
    print(f"paths at every degree {HIGH_DEGREES[0]}..{HIGH_DEGREES[-1]}, "
          f"s={S_EVERY}, the dense tensor-core pass (split2m, split3, "
          f"bf16):")
    for p in HIGH_DEGREES:
        for rung, state, mdt, sfx in DENSE_RUNGS:
            paths = [("merged reshape", ("apply_local_batched_g",),
                      dict(solver="merged")),
                     ("fused --factor dense", b1b2,
                      dict(solver="fused", windowing="pieces", dtype=state,
                           factor="dense"))]
            if p < 9:
                w = WINDOWINGS_EVERY[p % 3]
                paths += [("merged pieces", ("apply_lattice_pieces",),
                           dict(solver="merged", windowing="pieces")),
                          ("merged zslab", ("apply_lattice_zslab",),
                           dict(solver="merged", windowing="zslab")),
                          (f"baseline {w}", (WINDOWED_KERNEL[w],),
                           dict(solver="baseline", windowing=w))]
            for label, expect, kw in paths:
                if p in full_p and not label.startswith("baseline"):
                    continue  # the FULL_HIGH drives of the rung ran there
                drive(f"{label} {rung}", S_EVERY, expect, degree=p,
                      precision=rung, metric_dtype=mdt, **kw, **tiny)

    print(f"(phase 7 starts at {time.perf_counter() - T0:.1f} s)")
    # -- 7. P and x in bf16 (B2), the plain backends, the discretization --
    print("B2 with P or x stored in bf16:")
    storage, st_problems = compare_storage(fk, bp4, dev, timing)
    launches_st = {}
    for p, s, dtype, precision, config, sfx in STORAGE_RUNS:
        rows_st = {}
        for key, kw in (("_f32", {}),) + STORAGE:
            rows_st[key] = drive(
                f"fused {precision} {config['factor']} {config['metric']} "
                f"{key[1:]}", s, ("matvec", "fused_cg_iteration"),
                into=launches_st.setdefault(key + sfx, {}), degree=p,
                solver="fused", precision=precision, windowing="pieces",
                problem=st_problems[sfx], **config, **kw)
        f32_row = rows_st["_f32"]
        for key, _ in STORAGE:
            r = rows_st[key]
            print(f"  p={p} s={s} {key[1:]}: itCG {r.n_iterations} vs f32 "
                  f"{f32_row.n_iterations}, time/it {r.time_per_it:.6e} vs "
                  f"{f32_row.time_per_it:.6e} s")
            # x feeds no dot: the same count; bf16 P: within 3
            # (tests/test_cg_fused.py:332-345)
            allowed = 0 if key == "_x_bf16" else 3
            if abs(r.n_iterations - f32_row.n_iterations) > allowed:
                raise AssertionError(
                    f"p={p} s={s} {key[1:]}: itCG {r.n_iterations} vs "
                    f"{f32_row.n_iterations}")
    del st_problems
    torch.cuda.empty_cache()

    print("the structured and general backends, p=4 s=13:")
    be_problems = compare_backends(bp4, la, dev)
    itcg, hist = {}, {}
    for dtype in (torch.float32, torch.float64):
        ref = bp4.build(S, DEGREE, dtype, "highest", device=dev)
        for solver in ("merged", "baseline"):
            res = benchmark.solver_call(ref, solver)()
            itcg["pallas", solver, dtype] = res.n_iterations
            hist[solver, dtype] = res.res_history
        del ref
        for backend in ("structured", "general"):
            for solver in ("merged", "baseline"):
                zero_counts()
                r = benchmark.run_one(
                    DEGREE, S, solver=solver, dtype=dtype, backend=backend,
                    device=dev, problem=be_problems[backend, dtype],
                    solve_repeats=1, matvec_repeats=1, matvec_inner=10)
                itcg[backend, solver, dtype] = r.n_iterations
                print(f"{solver} {backend} {str(dtype)[6:]} p={DEGREE} "
                      f"s={S}: n_dofs {r.n_dofs} itCG {r.n_iterations} "
                      f"(pallas {itcg['pallas', solver, dtype]}) converged "
                      f"{r.converged} time/it {r.time_per_it:.6e} s "
                      f"DoF/s/it {r.dofs_per_s_per_it:.6e} time/matvec "
                      f"{r.time_per_matvec:.6e} s; kernel launches "
                      f"{sum(counts().values())} (plain PyTorch)")
                if not (0 < r.n_iterations <= 100 and r.time_per_it > 0
                        and r.time_per_matvec > 0):
                    raise AssertionError(f"{backend} {solver}: implausible "
                                         f"row: {r}")
                if dtype == torch.float64:
                    # the f64 count (at s=13 the cap, C4) and the whole
                    # residual history against the pallas path's (the
                    # operators agree to 1e-15 a vmult; 100 CG steps
                    # amplify that, so 1e-6 res0, far under a wrong
                    # operator's O(1))
                    h = benchmark.solver_call(be_problems[backend, dtype],
                                              solver)().res_history
                    ref_h = hist[solver, dtype]
                    n = r.n_iterations
                    dev_h = ((h[:n + 1] - ref_h[:n + 1]).abs().max()
                             / ref_h[0]).item()
                    print(f"  f64 history vs the pallas path's: max "
                          f"{dev_h:.3e} res0 (tol 1e-6)")
                    if (r.n_iterations != itcg["pallas", solver, dtype]
                            or not dev_h <= 1e-6):
                        raise AssertionError(
                            f"{backend} {solver} f64: itCG {r.n_iterations}"
                            f" (pallas {itcg['pallas', solver, dtype]}), "
                            f"history {dev_h:.3e} res0 from the pallas one")
    del be_problems
    torch.cuda.empty_cache()

    print("the discretization: manufactured solution, f64, merged CG on B3:")
    rates = convergence_rates(la, dev)

    # the three p=4 s=13 solutions: shape, finite, and their true residual
    # |b - A x| equal to the recurrence's residual estimate (at s=13 the
    # f32 solves stop at the 100-iteration cap, so the residual is not small)
    pb = bp4.build(S, DEGREE, torch.float32, "split2m", device=dev, **FUSED)
    lat = pb.layout.n_nodes_axis
    b = pb.b.reshape((3,) + lat)
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, b,
                                         pb.inv_diag.reshape((1,) + lat))
    solutions = [("fused", res, torch.linalg.norm(
        b - fk.matvec(pb.op, res.x.contiguous())).item(), (3,) + lat,
        r_fused)]
    del pb, b
    for precision, row in (("highest", r_main), ("split2m", r_split)):
        pb = bp4.build(S, DEGREE, torch.float32, precision, factor="dense",
                       metric="precomputed", windowing="reshape", device=dev)
        res = bp4.solve_merged(pb)
        solutions.append((f"merged {precision}", res, torch.linalg.norm(
            pb.b - pb.a_apply(res.x)).item(), tuple(pb.b.shape), row))
        del pb
    # and the reduced rungs' fused solutions.  bf16's true residual is not
    # its estimate: each of the solve's matvecs rounds t to bf16 (2^-9 of
    # it), and x carries that noise (0.065-0.088 |b| from the estimate for
    # the plain version on the CPU at p=4 s=9..10).  So its |b - A x|, by
    # the operator with the same bf16 matrices and an f32-class stream
    # (split2m), is held to that of the same solve on the card with the
    # plain version in place of the kernel (TOL_BF16_TRUE relative), and
    # its residual estimate to the f32 split2m fused path's at the same
    # iteration (2e-2 relative; the JAX package's own contract for it,
    # tests/test_cg_fused.py:205-212, its recurrence in the f32 class)
    for rung, state, mdt, sfx in REDUCED:
        config = dict(zip(("factor", "metric", "cofactor"),
                          reduced[sfx]["config"]))
        pb = bp4.build(S, DEGREE, state, rung, windowing="pieces",
                       device=dev, metric_dtype=mdt, **config)
        b = pb.b.reshape((3,) + lat).float()
        res = cg_fused.fused_merged_cg_solve(
            pb.op, lat, pb.b.reshape((3,) + lat),
            pb.inv_diag.reshape((1,) + lat))
        op = pb.op if rung == "split3" else bp4.build(
            S, DEGREE, torch.float32, "split2m", windowing="pieces",
            device=dev, **config).op
        true_res = torch.linalg.norm(
            b - fk.matvec(op, res.x.contiguous())).item()
        solutions.append((f"fused {rung}", res, true_res, (3,) + lat,
                          r_red[sfx]))
        if rung == "bf16":
            plain = cg_fused.fused_merged_cg_solve(
                pb.op, lat, pb.b.reshape((3,) + lat),
                pb.inv_diag.reshape((1,) + lat),
                iteration=fk._fused_iteration_plain)
            true_plain = torch.linalg.norm(
                b - fk.matvec(op, plain.x.contiguous())).item()
            gap = abs(true_res - true_plain) / true_plain
            print(f"fused bf16 solution, the plain version in place of the "
                  f"kernel: itCG {plain.n_iterations}, |b - Ax| "
                  f"{true_plain:.6e} vs estimate {plain.res_norm:.6e}; the "
                  f"kernel's |b - Ax| {true_res:.6e} (rel gap {gap:.2e}, "
                  f"tol {TOL_BF16_TRUE:.0e})")
            if not (plain.n_iterations == res.n_iterations
                    and gap < TOL_BF16_TRUE):
                raise AssertionError("fused bf16 solution: its true "
                                     "residual is not the plain version's")
            del plain
        del pb, b, op
    for label, res, true_res, shape, row in solutions:
        if label == "fused bf16":  # against the f32 split2m fused path's
            ref, tol = solutions[0][1].res_norm, 2e-2
        else:
            ref, tol = true_res, 1e-3
        gap = abs(ref - res.res_norm) / res.res_norm
        print(f"{label} solution: shape {tuple(res.x.shape)}, itCG "
              f"{res.n_iterations}, |b - Ax| {true_res:.6e} vs estimate "
              f"{res.res_norm:.6e}, checked against {ref:.6e} (rel gap "
              f"{gap:.2e}, tol {tol:.0e})")
        if tuple(res.x.shape) != shape or not torch.isfinite(res.x).all() \
                or res.n_iterations != row.n_iterations or not gap < tol:
            raise AssertionError(f"{label} solution is wrong")

    print(f"(phase 8 starts at {time.perf_counter() - T0:.1f} s)")
    # -- 8. the distributed solvers: z-slabs and rank meshes ---------------
    t8 = time.perf_counter()
    print("the distributed solvers: B2's block form vs plain:")
    compare_rank_forms(fk, dev, [
        (f"rank {rank}/3", lambda p, st, rung, m, rank=rank: _slab_op(
            9, p, rank, 3, st, rung, m, dev)) for rank in (1, 2)], "slab")
    compare_rank_forms(fk, dev, [
        (f"block {c} of {mesh}",
         lambda p, st, rung, m, s=s, mesh=mesh, c=c: _block_op(
             s, p, c, mesh, st, rung, m, dev)) for s, mesh, c in BLOCK_CASES],
        "block")
    p8, s8, n8 = DIST_FULL
    slab_t = time_rank_form(fk, dev, timing, lambda rung, dt: _slab_op(
        s8, p8, 1, n8, dt, rung, "precomputed", dev), s8,
        f"slab p={p8} s={s8} rank 1/{n8}")
    block_t = {sfx: time_rank_form(
        fk, dev, timing, lambda rung, dt, sm=sm, mesh=mesh: _block_op(
            sm, p8, (0,) * len(mesh), mesh, dt, rung, "precomputed", dev),
        sm, f"block p={p8} s={sm} {(0,) * len(mesh)} of {mesh}")
        for sfx, sm, mesh in MESH_FULL}
    print("B2's layer-range form (the overlapped fused solve's) and "
          "B3/B5/B6 on layer sub-ranges (the overlapped apply's):")
    compare_range_form(fk, dev)
    range_t = time_range_form(fk, dev, timing)
    compare_sub_applies(la, dev)
    print(f"  (the spawns: {time.perf_counter() - T0:.1f} s since the start)")
    print("the distributed solvers (ranks: processes on this card, gloo):")
    launches_dist, _, launches_dry, overlap = distributed_phase(
        benchmark, bp4, cg_fused, fk, dev)
    print(f"section 8: {time.perf_counter() - t8:.1f} s")

    # -- 9. bf16 storage: the bf16 state on every rung, the bf16 metric
    #       under highest and split2m, C10's f32 carry -------------------
    t9 = time.perf_counter()
    from mf_data_locality_tpu_torch.utils import bf16_state_check as b16

    print(f"bf16 storage: the storage instantiations vs plain on the "
          f"{'x'.join(map(str, b16.RAGGED))} box at p in {b16.DEGREES}:")
    b16.report(b16.compare_all(dev))
    print(f"  ({time.perf_counter() - t9:.1f} s)")
    b16_times = b16.time_all(
        dev, lambda k, p: time_pair(k, p, dev, timing), bound)
    launches_b16 = {}
    for label, s_d, expect, sfx, kw in B16_DRIVES:
        drive(label, s_d, expect, into=launches_b16.setdefault(sfx, {}),
              quiet=s_d != S, **kw, **({} if s_d == S else short))
    print(f"section 9: {time.perf_counter() - t9:.1f} s")

    # -- 10. the tensor-core rungs' twostage pass at p=1..3 and the jtj
    #        chain in their dense pass --------------------------------------
    t10 = time.perf_counter()
    from mf_data_locality_tpu_torch.utils import tensor_rungs_check as trc

    print(f"the tensor-core rungs' twostage pass at p=1..3 and dense jtj vs "
          f"plain on the {'x'.join(map(str, trc.RAGGED))} box:")
    trc.report(trc.compare_all(dev))
    print(f"  ({time.perf_counter() - t10:.1f} s)")
    ts_times = trc.time_all(dev, lambda k, p: time_pair(k, p, dev, timing),
                            bound)
    launches_ts = {"_dense_adjj_split2m": launches_dense["_dense_split2m_p4"]}
    p_ts, s_ts = TS_FULL
    drive("fused --factor twostage, split2m (full width)", s_ts,
          ("matvec", "fused_cg_iteration"),
          into=launches_ts.setdefault("_twostage_split2m_p3", {}),
          degree=p_ts, solver="fused", windowing="pieces",
          precision="split2m", factor="twostage")
    drive("fused auto, split2m", s_ts, ("matvec", "fused_cg_iteration"),
          into=launches_ts.setdefault("_auto_split2m_p3", {}), degree=p_ts,
          quiet=True, solver="fused", windowing="pieces",
          precision="split2m", **short)
    for label, p, s_d, expect, key, kw in TS_DRIVES:
        drive(label, s_d, expect, degree=p, quiet=True,
              into=None if key is None else launches_ts.setdefault(key, {}),
              **kw, **short)
    p, s, allowed = TS_PARITY
    config = benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                      torch.float32, factor="twostage")
    pb = bp4.build(s, p, torch.float32, "split2m", windowing="pieces",
                   device=dev, **dict(zip(("factor", "metric", "cofactor"),
                                          config)))
    lat = pb.layout.n_nodes_axis
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, pb.b.reshape((3,) + lat),
                                         pb.inv_diag.reshape((1,) + lat))
    hist = res.res_history.cpu().numpy()
    n = res.n_iterations
    print(f"p={p} s={s} fused --factor twostage f32 split2m {config}: itCG "
          f"{n}, converged {res.converged}, residual at it {allowed[1]} "
          f"{hist[min(n, allowed[1])] / hist[0]:.3e} res0")
    ok = res.converged and n in allowed
    if not res.converged and n == 100:
        ok = (hist[allowed[1]] / hist[0] <= 1e-7
              and edge_witness(pb, hist, n, s, p)[0])
    if not ok:
        raise AssertionError(f"p={p} s={s} fused --factor twostage split2m: "
                             f"itCG {n} not in {tuple(allowed)}")
    del pb
    torch.cuda.empty_cache()
    print(f"section 10: {time.perf_counter() - t10:.1f} s")

    # -- 11. the shapes beyond BP4's: CEED BP3 and q = p + 1 (queue B 6g) --
    shape_times, launches_sh = shape_section(
        dev, drive, short, log or lib_path.with_suffix(".log").read_text())

    # -- 12. the plain modules: mass, the general mesh, 2D, the trace ------
    from mf_data_locality_tpu_torch.utils import modules_check

    print("the plain modules (mass BP2/BP1, an L-shaped general mesh, 2D, "
          "the trace):")
    modules_check.run_all(dev)

    # no single PyTorch call computes any of these functions (each is a
    # fused chain of contractions, the metric apply and masking), so
    # library_ms is null throughout
    rows = []
    for name, (_, src, line) in kernels.items():
        row = {"name": name, "route": "cuda", "source": CSRC + src,
               "replaces": f"mf_data_locality_tpu/ops/{line}",
               "launches": launches[name], "max_abs_err": errs[name],
               "ms": times[name][0], "plain_ms": times[name][1],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "library_ms": None}
        if name in highest:  # B1, B2: measured at split2m, then highest
            (k, pl), (bms, by), err = highest[name]
            row.update(source_split2m=CSRC + "cell_mma.cuh",
                       source_highest=CSRC + "apply_sumfac.cuh",
                       ms_highest=k, plain_ms_highest=pl,
                       max_abs_err_highest=err, bound_ms_highest=bms,
                       bound_by_highest=by,
                       launches_highest=launches_highest[name])
        for _, precision, _, p, s, sfx in DENSE_RUNS:  # B1, B2: dense
            if name in dense[sfx]:
                (k, pl), (bms, by), err = dense[sfx][name]
                src = ("apply_mma.cuh" if precision == "split2m"
                       else "apply_sumfac.cuh")
                row.update({f"source{sfx}": CSRC + src, f"p_s{sfx}": [p, s],
                            f"ms{sfx}": k, f"plain_ms{sfx}": pl,
                            f"max_abs_err{sfx}": err, f"bound_ms{sfx}": bms,
                            f"bound_by{sfx}": by,
                            f"launches{sfx}": launches_dense[sfx][name]})
        if name in times_split:  # B3, B5, B6: the tensor-core split2m pass
            row.update(source_split2m=CSRC + "apply_mma.cuh",
                       ms_split2m=times_split[name][0],
                       plain_ms_split2m=times_split[name][1],
                       max_abs_err_split2m=errs_split[name],
                       bound_ms_split2m=bounds[name + "_split2m"][0],
                       bound_by_split2m=bounds[name + "_split2m"][1])
            if name in launches_split:
                row["launches_split2m"] = launches_split[name]
        if name in f64:  # every kernel at f64 highest
            (k, pl), (bms, by), err = f64[name]
            row.update(ms_f64=k, plain_ms_f64=pl, max_abs_err_f64=err,
                       bound_ms_f64=bms, bound_by_f64=by)
        for sfx, tab in reduced.items():  # split3, bf16
            if name not in tab:
                continue
            (k, pl), (bms, by), err = tab[name]
            p, s = next(((p, s) for p, s, x in FULL_HIGH
                         if sfx.endswith(x)), (DEGREE, S))
            row.update({f"source{sfx}": CSRC + tc_source(
                            tab["config"] if name in b1b2 else
                            ("dense", "precomputed"), p),
                        f"p_s{sfx}": [p, s], f"ms{sfx}": k,
                        f"plain_ms{sfx}": pl, f"max_abs_err{sfx}": err,
                        f"bound_ms{sfx}": bms, f"bound_by{sfx}": by,
                        f"launches{sfx}": launches_red[sfx][name]})
        for sfx, tab in dense_hi.items():  # the dense pass, p >= 5
            if name not in tab:
                continue
            (k, pl), (bms, by), err = tab[name]
            p, s = next((p, s) for p, s, x in FULL_HIGH if sfx.endswith(x))
            row.update({f"source{sfx}": CSRC + f"apply_mma_p{p:02d}.cu",
                        f"p_s{sfx}": [p, s], f"ms{sfx}": k,
                        f"plain_ms{sfx}": pl, f"max_abs_err{sfx}": err,
                        f"bound_ms{sfx}": bms, f"bound_by{sfx}": by,
                        f"launches{sfx}": launches_dh[sfx][name]})
            if name in b1b2:
                row[f"config{sfx}"] = list(tab["config"])
            if name == "apply_local_batched_g" and "matmul_ms" in tab:
                # torch.matmul of the forward's bf16 product alone: a
                # yardstick, not one call that computes the function
                row[f"matmul_ms{sfx}"] = tab["matmul_ms"]
        for sfx, times_hi in (*high.items(), *split_hi.items()):  # p >= 5
            if name not in times_hi:
                continue
            (k, pl), (bms, by), err = times_hi[name]
            p, s = next((p, s) for p, s, x in FULL_HIGH
                        if sfx.removeprefix("_split2m").startswith(x))
            src = ("cell_mma_p" if sfx.startswith("_split2m")
                   else "sumfac_p")
            row.update({f"source{sfx}": CSRC + f"{src}{p:02d}.cu",
                        f"p_s{sfx}": [p, s], f"ms{sfx}": k,
                        f"plain_ms{sfx}": pl, f"max_abs_err{sfx}": err,
                        f"bound_ms{sfx}": bms, f"bound_by{sfx}": by,
                        f"launches{sfx}": launches_hi[sfx][name]})
        if name == "fused_cg_iteration":  # B2's block form (section 8)
            for rung, dtype, sfx in SLAB_TIMED:  # on a z-slab
                (k, pl), (bms, by), err, box_ms = slab_t[sfx]
                sfx = "_slab" + sfx
                row.update({f"source{sfx}": CSRC + "cg_fused_block.cu",
                            f"p_s{sfx}": list(DIST_FULL[:2]),
                            f"config{sfx}": [rung, "dense", "precomputed"],
                            f"ms{sfx}": k, f"plain_ms{sfx}": pl,
                            f"max_abs_err{sfx}": err, f"bound_ms{sfx}": bms,
                            f"bound_by{sfx}": by, f"ms_box{sfx}": box_ms})
            row["launches_slab"] = launches_dist["fused"][name]
            row["launches_slab_onthefly"] = launches_dist["fused_onthefly"][
                name]
            for msfx, sm, mesh in MESH_FULL:  # on the meshes' blocks
                for rung, dtype, sfx in SLAB_TIMED:
                    (k, pl), (bms, by), err, box_ms = block_t[msfx][sfx]
                    key = msfx + sfx
                    row.update({f"source{key}": CSRC + "cg_fused_block.cu",
                                f"p_s{key}": [DIST_FULL[0], sm],
                                f"mesh{key}": list(mesh),
                                f"config{key}": [rung, "dense",
                                                 "precomputed"],
                                f"ms{key}": k, f"plain_ms{key}": pl,
                                f"max_abs_err{key}": err,
                                f"bound_ms{key}": bms, f"bound_by{key}": by,
                                f"ms_box{key}": box_ms})
                row[f"launches{msfx}"] = launches_dist["fused" + msfx][name]
            row["launches_dryrun"] = {f"{n}:{leg}": v for (n, leg), v
                                      in launches_dry.items()
                                      if leg in (6, 7, 8)}
        for (kname, sfx), ((k, pl), (bms, by), err, tag) in \
                b16_times.items():  # bf16 storage (section 9)
            if kname != name:
                continue
            row.update({f"source{sfx}": CSRC + B16_SOURCE[name, sfx],
                        f"config{sfx}": tag, f"ms{sfx}": k,
                        f"plain_ms{sfx}": pl, f"max_abs_err{sfx}": err,
                        f"bound_ms{sfx}": bms, f"bound_by{sfx}": by,
                        f"launches{sfx}": launches_b16[sfx][name]})
        for (kname, sfx), ((k, pl), (bms, by), err, config) in \
                ts_times.items():  # section 10
            if kname != name:
                continue
            p, s = (TS_FULL if sfx.endswith("_p3") else (DEGREE, S))
            row.update({f"source{sfx}": CSRC + TS_SOURCE[sfx],
                        f"p_s{sfx}": [p, s],
                        f"config{sfx}": ["split2m", *config],
                        f"ms{sfx}": k, f"plain_ms{sfx}": pl,
                        f"max_abs_err{sfx}": err, f"bound_ms{sfx}": bms,
                        f"bound_by{sfx}": by,
                        f"launches{sfx}": launches_ts[sfx][name]})
        for (kname, sfx), ((k, pl), (bms, by), err, config) in \
                shape_times.items():  # section 11
            if kname != name:
                continue
            _, c, dq, p, s, _ = next(t for t in shc.TIMED if t[0] == sfx)
            row.update({f"source{sfx}": CSRC + SHAPE_SOURCE,
                        f"p_s{sfx}": [p, s], f"shape{sfx}": [c, p + dq],
                        f"config{sfx}": config, f"ms{sfx}": k,
                        f"plain_ms{sfx}": pl, f"max_abs_err{sfx}": err,
                        f"bound_ms{sfx}": bms, f"bound_by{sfx}": by,
                        f"launches{sfx}": launches_sh[sfx][name]})
        if name == "apply_lattice_pieces":  # on the twostage operator
            row["launches_twostage_pieces"] = launches_ts[
                "_twostage_pieces"][name]
        if name == "fused_cg_iteration":  # the fused bf16 solve on 4 ranks
            row["launches_slab_bf16"] = launches_dist["fused_bf16"][name]
        if name == "apply_local_batched_g":
            row["launches_dist_bf16"] = launches_dist["merged_bf16"][name]
        if name == "apply_lattice_pieces":  # the fused paths' matvec column
            row["launches_dist"] = (launches_dist["fused"][name]
                                    + launches_dist["fused_onthefly"][name])
        if name == "apply_local_batched_g":  # the merged path's
            row["launches_dist"] = launches_dist["merged"][name]
            row["launches_block2d"] = launches_dist["merged_block2d"][name]
        if name == "fused_cg_iteration":  # B2 with P or x in bf16
            for p, s, _, precision, config, run in STORAGE_RUNS:
                for key, _ in STORAGE:
                    sfx = key + run
                    (k, pl), (bms, by), err = storage[sfx]
                    row.update({f"source{sfx}": CSRC + "cg_fused_px.cu",
                                f"p_s{sfx}": [p, s],
                                f"config{sfx}": [precision, config["factor"],
                                                 config["metric"]],
                                f"ms{sfx}": k, f"plain_ms{sfx}": pl,
                                f"max_abs_err{sfx}": err,
                                f"bound_ms{sfx}": bms, f"bound_by{sfx}": by,
                                f"launches{sfx}": launches_st[sfx][name],
                                f"ms_f32{sfx}": storage["_f32" + run][0][0]})
        rows.append(row)
    # B2's layer-range form (section 8): its launches those of the
    # overlapped fused drive at DIST_FULL (an assemble per iteration a
    # rank, after two cell passes), summed over its ranks
    (k, pl), (bms, by), err, one = range_t[""]
    row = {"name": "fused_cg_iteration_range", "route": "cuda",
           "source": CSRC + "cg_fused_block.cu",
           "replaces": "mf_data_locality_tpu/ops/cg_fused_kernel.py:1476",
           "launches": launches_dist["fused_overlap"]["fused_cg_assemble"],
           "max_abs_err": err, "ms": k, "plain_ms": pl, "bound_ms": bms,
           "bound_by": by, "library_ms": None,
           "p_s": list(DIST_FULL[:2]), "ranks": DIST_FULL[2],
           "config": ["split2m", "dense", "precomputed"],
           "ms_one_launch": one,
           "launches_cell_passes": launches_dist["fused_overlap"][
               "fused_cg_iteration"],
           "overlap_wait_ms": overlap["wait_ms"],
           "overlap_merged_x_err": overlap["x_err"]}
    (k, pl), (bms, by), err, one = range_t["_f64"]
    row.update(ms_f64=k, plain_ms_f64=pl, max_abs_err_f64=err,
               bound_ms_f64=bms, bound_by_f64=by, ms_one_launch_f64=one)
    rows.append(row)
    print("convergence rates: " + ", ".join(
        f"p={p} {rate:.4f}" for p, _, rate, _ in rates))
    print(f"wall time {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
