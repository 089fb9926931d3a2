"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``chgnet_tpu_torch/csrc`` and drives
fifteen paths of the port, E+F+S+M serving at the default (published 0.3.0)
width, on the card (``PATHS``): the default ``CHGNet(seed=0)``
(``fused_kernels=True``, directed bonds), ``fused_kernels=False``, the
undirected bond layout ``directed_bonds=False``, the default model with
one of three environment switches set around its path only: the fused
message-reduce (``CHGNET_TPU_MSG_REDUCE=1``), the input-stationary segment
sum and windowed gather (``CHGNET_TPU_STREAM_V2=1``, set around the batch
build too: the window plans are built under it) and the one-kernel conv
pass (``CHGNET_TPU_FUSED_PASS=1``), the undirected layout under the
one-kernel pass and under the stream-v2 switch, and bench.py's production
configuration, ``compute_dtype="bfloat16"`` with ``matmul_precision=
"default"``, on the default path and each of those six others but
``fused_kernels=False`` (``bf16``, ``directed_bonds=False bf16``, ``<switched
path> bf16``: every kernel with bf16 arguments, geometry and readout in
f32; ``BF16_PATHS``):

1. card and build: the card's name and power limit, the TF32 flags, the
   kernel build time, each kernel's registers, spills and static shared
   memory (``ptxas``'s report, names demangled by ``cu++filt``), and the
   tensor-core tails' and the one-kernel pass's serving kernels' dynamic
   shared memory, warps a block and blocks an SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
2. kernels: one recorded E+F+S+M pass of each path on the benchmark batch
   (32 perturbed 216-atom LiMnO2 supercells, ``bench.py``'s workload)
   captures every kernel call of that path with its inputs; each call is
   re-run through the kernel and through its plain PyTorch version on the
   card and compared, each output's error relative to its largest value
   (bf16 calls at ``BF16_TOL``: one bf16 rounding, gather_project_sum
   against the plain version with its route's rounding), so every kernel
   is held at every shape and type any path gives it (the switched bf16
   paths, ``NEW_BF16_PATHS``, hold every bf16 call of rows 10-14 and of the
   other kernels only the calls of a shape no earlier path held); each
   kernel's
   autograd op is checked forward and backward against the CPU (the fused
   tails as serving runs them, at the edge and angle streams' shapes, and
   also with parameter gradients and in the update's second-layer form,
   which the passes do not reach);
3. model, for each path: LiMnO2 against the port's own CPU run, then
   ``compute_batch`` on the benchmark batch, whose outputs must be finite,
   with per-graph force sums ~0 and symmetric stress; the launch counts are
   set to 0 just before that pass and read just after it, and must equal
   the path's launch set (``PATHS``), and the wrappers' counts of launches
   with bf16 arguments, read from the same pass, must be all of the conv
   stack's kernels' (rows 4-10, 13, 14: ``CONV_WRAPPERS``) and some of
   every other launched kernel's on a bf16 path (none of ``F32_ONLY``'s),
   none on an f32 path; the five switched f32 paths' outputs must
   also agree with the default path's, and the seven bf16 paths' with their
   f32 paths' at ``BF16_BARS`` (their LiMnO2 card-vs-CPU check too);
   edges/s by CUDA events;
4. a ``{"kernels": [...]}`` line: per kernel, its largest error over the
   calls of all paths, the path its times were taken on, its
   launches in one pass of that path and, summed over that pass's calls,
   its time, its plain version's time, the time of PyTorch library calls
   computing the same function (null where none does: the fused tails), and
   the least time the card could take: summed over the calls, each call's
   larger of its bytes over 3.35 TB/s and its operations' time, its matrix
   products' FLOPs over 165 TFLOP/s (495 / 3: f32-accurate 3xTF32 on the
   tensor cores) plus its elementwise FLOPs over 67 TFLOP/s (the H100 SXM
   data-sheet peaks), the FLOPs counted in the cheaper order where the
   function has two, and for the fused tails as the two diagonal blocks'
   products plus ``TAIL_OPS`` per row element of the call's form (the
   one-kernel pass also one add per part and accumulator element);
   ``gather_project_sum`` is also timed and bounded per route (short
   tables projected first, long ones gathered first), and the one-kernel
   pass per form (``forms``: the message form with its second layer, the
   update form); every row also in bf16 (``dtype``), over the bf16 calls of
   a bf16 path's pass (``BF16_ROW_PATH``), with ``bf16_launches`` (from the
   counted pass of phase 3) beside ``launches``, the
   bytes at each tensor's element size, gather_project_sum's bf16
   products at 989 TFLOP/s and the tails' (f32 by a bf16 W2) at 247.5
   (two TF32 passes; their dW2, f32 by f32, at 165: ``product_rate``);
5. profile: one pass of the default, the undirected, the message-reduce,
   the stream-v2, the one-kernel-pass, the bf16 and the undirected
   one-kernel-pass bf16 path under ``torch.profiler``, the
   device's busy share of its wall time and the kernels that take the most
   device time; the traced default, message-reduce, stream-v2 and
   one-kernel-pass passes must show their kernels by name (``PROFILED``:
   the tensor-core tails, the windowed gather; the bf16 passes their bf16
   instantiations), and the stream-v2 and
   one-kernel passes' traces none of the kernels they replaced
   (``UNPROFILED``);
6. simulation (``chgnet_tpu_torch.simulation``): (a) the pinned seed-0 MD
   traces of every ensemble and the FIRE trace (``GOLDEN_MD``,
   ``GOLDEN_FIRE``) with the SMALL model, at rtol 2e-3; (b) NVT MD of
   ``CHGNet(seed=0)`` on tools/bench_md.py's 10,240-atom workload (skin
   0.15): steps/s, capacities, rebuild stats, peak device memory, the launch
   counts of the timed steps (the default path's kernels, no other), the
   final state against a fresh exact-cutoff ``predict_structure`` (2e-5
   eV/atom, 5e-5 eV/A), every kernel call of one MD step against its plain
   version, and one traced step by kernel; (c) FIRE with the cell free over
   8 of bench.py's supercells in one batch: steps/s, each final energy
   against a fresh prediction of its last frame, the energy falling; (d)
   ``CHGNetCalculator`` equal to ``predict_structure``; (e) the host stack
   on the MD workload's structure at the MD cutoffs (6.15 / 3.15 A): the
   C++ graph builder and the numpy builder timed once each and their arrays
   held equal (ids and images exact, distances 1e-10 A), ``batch_graphs``
   timed with the host ops and with ``CHGNET_TPU_NO_HOSTOPS=1``, and the two
   host libraries' g++ builds timed in a fresh directory; (f) LBFGS,
   LBFGSLineSearch, BFGS and BFGSLineSearch over (c)'s batch for
   ``SIM_RELAXERS_STEPS`` steps each: steps/s (for BFGS also the share of
   the wall time an ``eigh`` of its [8, 657, 657] Hessian takes), the
   energy falling and each final energy against a fresh prediction of its
   last frame; then SciPyFminCG on one 216-atom supercell, its energy
   falling. The ``kernels`` line's rows gain ``sim_launches`` (the timed MD
   steps' launches) and their ``max_abs_err`` covers the MD step's calls
   too. (b) and (c) run again with the bf16 model (tools/bench_md.py's
   configuration for systems over 2,000 atoms), checked at ``BF16_BARS``,
   MD over ``SIM_MD_STEPS_BF16`` timed steps and without a trace, its
   launches with bf16 arguments checked as in phase 3; the bf16 rows'
   ``sim_launches`` and ``sim_bf16_launches`` are that run's;
7. training (``chgnet_tpu_torch.trainer``): bench.py's 32 supercells
   labelled E+F+S+M by ``CHGNet(seed=7)`` on the card (a NaN energy, force
   block and magmom block among them), ``StructureData`` ->
   ``get_train_val_test_loader`` (batches of 8, 24 / 4 / 4); (a) the first
   2 train steps of ``CHGNet(seed=0)`` (Adam, lr 1e-3, CosLR, MSE) on the
   card against the port's CPU run of the same steps, on a loader cut to 4
   structures in batches of 2 (full width): losses at rtol 1e-4, parameters
   at 2 x lr x steps and nearly every element to 1e-5, each leaf's Adam
   first moments within 1e-2 of its largest; then the same in bf16
   (``BF16_HOLD_KW``: the bf16 kernels, plain GEMMs at "highest" as on the
   CPU), bf16 on the card against bf16 on the CPU (``TRAIN_HOLD_BARS``:
   losses 5e-3, elements 1e-4, moments 5e-2); (b) every kernel call
   of one train step (forward, force backward, parameter backward) against
   its plain version, the step's launch set that of the default path, each
   kernel's time over the step's calls and, for rows 7, 9 and 14, each
   backward form (with parameter gradients, without) timed and bounded
   apart; (c) the same under ``CHGNET_TPU_FUSED_PASS=1`` (rows 13 and 14,
   and row 5, which carries the pass's second order); (b) and (c) again
   with the bf16 model (``BF16_KW``): the tails' and the one-kernel pass's
   parameter-gradient forms with bf16 arguments, each call held at
   ``bf16_tol``, the launches with bf16 arguments checked as phase 3 checks
   them; (d) one step with
   ``conv_dropout=0.1``: no fused tail launches, a finite loss; (e) one
   E+F+S+M pass with ``matmul_precision="high"`` against "highest" (TF32
   tolerance) and both times; (f) one traced train step; (g)
   ``Trainer.train`` for 2 epochs with checkpoints, each step timed by CUDA
   events: train steps/s and structures/s over epoch 2, peak device memory,
   the losses and MAEs per epoch (all finite), the checkpoint files, and a
   ``Trainer.load`` resume that carries on one more step; then (h) the same
   run of the bf16 model, its first epoch's step losses within
   ``TRAIN_BF16_LOSS_RTOL`` of the f32 run's. The ``kernels``
   line's rows gain ``train_launches`` (one train step of the row's path
   and type; 0 where that path is not trained), ``train_ms`` (that step's
   calls of the row's type; null where none) and, for rows 7, 9 and 14,
   ``train_forms``.

``python3 chip_smoke.py --compare ROOT [ROOT ...]`` times checkouts against
each other in turns on one card, each ROOT in its own process and by its
own ``chip_smoke.py`` (so a parent is timed by its own code): the kernel
build, each of its ``PATHS`` (``phase_model``) and its NVT MD run at
10,240 atoms (``phase_sim_md``), without the rest; each line goes out with
its ROOT in front.

Every line but the last also goes to ``build/chip_smoke.log`` beside the
script (``build/`` is where the kernels' libraries go). Any failure raises. The last line is the result JSON. Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 without tensor cores
# H100 SXM, f32-accurate products on the TF32 tensor cores (495 TFLOP/s
# dense): 3xTF32 takes three TF32 products for each f32 one
F32_TC_FLOPS = 495e12 / 3
# H100 SXM, products of an f32 value and a bf16 one on the TF32 tensor
# cores: the bf16 operand is exact in TF32, so two of 3xTF32's three passes
# keep f32 accuracy (the bf16 tails' silu(acc) or d_y times a bf16 W2)
F32_BF16_TC_FLOPS = 495e12 / 2
# H100 SXM, bf16 products on the tensor cores (989 TFLOP/s dense): the rate
# a product of two bf16 inputs (gather_project_sum's tables and weights)
# could run at
BF16_TC_FLOPS = 989e12
N_STRUCTS = 32  # bench.py's workload
TIMED_REPEATS = 5
MODEL_SAMPLES = 10
# f32 operations per row element (one core and one gate element) of the
# fused tails besides their block-diagonal products, counted from the
# kernels' arithmetic and charging only what each function needs: an add,
# multiply, exp or reciprocal is 1, an FMA 2; per-row work (the layer
# norms' divisions and rsqrt) is left out. sigmoid 3 (exp, add,
# reciprocal), silu 4 (sigmoid, multiply), silu' 4 more from silu's sigmoid
# s (s (1 + x (1 - s))). A two-pass layer norm takes 5 per element (sum,
# centre, square-sum FMA, scale), its backward 8 (g * scale, two sums, one
# of them an FMA, then (gz - m1 - z m2) * inv).
#   forward with y given: 2 LN 10, affine 2 FMA 4, silu 4, sigmoid 3,
#     gate 1 = 22; + resnet 1 (update, y = acc) = 23; a second layer adds
#     silu(acc) 2 x 4 and b2 2 (update w2 33); the message also
#     weights * mask 2 (34);
#   backward with y given: the recomputed 2 LN, affines, silu, sigmoid 21,
#     silu'(cn) 4, gate 1, d_cn 2, d_gn 3, 2 LN backward 16 = 47 (update,
#     y = acc); a second layer adds silu(acc) 8, b2 2, silu'(acc) 8 and
#     d_acc = d_h * silu'(acc) 2 (update w2 67); the message also g * mask,
#     its product with weights (the gate's cotangent) and d_weights 3 (70);
#   d_mask, when asked: the gate times weights, summed against g, 3;
#   parameter gradients, when asked: the LN scales' FMAs 4 and biases' sums
#     2, and db2's sums 2 with a second layer (dW2 is a third product).
TAIL_OPS = {
    ("fwd", "message"): 34, ("fwd", "update"): 23, ("fwd", "update_w2"): 33,
    ("bwd", "message"): 70, ("bwd", "update"): 47, ("bwd", "update_w2"): 67,
}
D_MASK_OPS = 3
PARAM_OPS = {False: 6, True: 8}  # by has_w2

# the f32 paths and the launches of one E+F+S+M pass of each, by kernel in
# the order of KERNELS: the model's keywords, the environment switch set
# around the path (None: none), and the counts, worked out from the model's
# code. The undirected layout adds to the default's the d2u expansions (bond
# features per angle-side layer, the two bond-weight tables, the bond
# lengths) and their backward sums, and sends AtomConv's first layers and the
# BondConv totals through the multi-gather; the message-reduce switch folds
# the 7 message layers' segment sums into their tails. Under the stream-v2
# switch all 20 segment sums are narrower than 128 floats and take the tile
# kernel, and 16 of the 17 gathers the window kernel (the atom -> graph
# cotangent is 1 float wide). Under the fused-pass switch the 9 conv layers
# (4 AtomConv, 3 BondConv, 2 AngleUpdate) take the one-kernel pass forward
# and backward in place of gather_project_sum and the four tails; in the
# undirected layout too (AtomConv's bond part gathered by d2u from the
# projected [U, 2D] table), where the multi-gather keeps only the 3 BondConv
# totals and the d2u expansions and their sums stay. The undirected layout
# under the stream-v2 switch sends its 28 segment sums narrower than 128
# floats to the tile kernel (the 4 of [E, 128] stay) and the same 16 gathers
# as the directed one to the window kernel: the d2u, u2d and u2d2 plans carry
# no windows (a block of them spans more than WINDOW_ROWS source rows in any
# crystal of a few hundred bonds), so their 11 gathers stay on gather_rows.
# bench.py's production serving configuration, the conv stack in bf16 (every
# kernel with bf16 arguments, geometry and readout sums in f32): each bf16
# path has the launch set of its f32 path
BF16_KW = dict(compute_dtype="bfloat16", matmul_precision="default")
PATHS = {
    "default": ({}, None, (20, 17, 8, 9, 7, 7, 2, 2, 0, 0, 0, 0, 0, 0)),
    "fused_kernels=False": (
        dict(fused_kernels=False), None,
        (20, 17, 8, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    "directed_bonds=False": (
        dict(directed_bonds=False), None,
        (32, 28, 8, 5, 7, 7, 2, 2, 7, 0, 0, 0, 0, 0)),
    "CHGNET_TPU_MSG_REDUCE=1": (
        {}, "CHGNET_TPU_MSG_REDUCE", (13, 17, 8, 9, 0, 7, 2, 2, 0, 7, 0, 0, 0, 0)),
    "CHGNET_TPU_STREAM_V2=1": (
        {}, "CHGNET_TPU_STREAM_V2", (0, 1, 8, 9, 7, 7, 2, 2, 0, 0, 20, 16, 0, 0)),
    "CHGNET_TPU_FUSED_PASS=1": (
        {}, "CHGNET_TPU_FUSED_PASS", (20, 17, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 9, 9)),
    "directed_bonds=False CHGNET_TPU_FUSED_PASS=1": (
        dict(directed_bonds=False), "CHGNET_TPU_FUSED_PASS",
        (32, 28, 8, 0, 0, 0, 0, 0, 3, 0, 0, 0, 9, 9)),
    "directed_bonds=False CHGNET_TPU_STREAM_V2=1": (
        dict(directed_bonds=False), "CHGNET_TPU_STREAM_V2",
        (4, 12, 8, 5, 7, 7, 2, 2, 7, 0, 28, 16, 0, 0)),
}
# the f32 paths under a switch, held to the default path's outputs
SWITCHED = [path for path, (_, switch, _) in PATHS.items() if switch]
# each bf16 path and the f32 path it is held to (BF16_BARS), in the order
# they run: the default and the undirected layout (rows 1-9 in bf16), then
# every switched path (rows 10-14 in bf16 too); each has its f32 path's
# keywords and switch, the conv stack in bf16 and the same launch set
BF16_PATHS = {"bf16": "default", "directed_bonds=False bf16": "directed_bonds=False"}
BF16_PATHS.update({f"{path} bf16": path for path in SWITCHED})
PATHS.update({
    path: (dict(PATHS[ref][0], **BF16_KW), *PATHS[ref][1:])
    for path, ref in BF16_PATHS.items()
})
# the switched bf16 paths (rows 10-14 in bf16), which hold against the
# plain versions only those rows' calls and calls of shapes no earlier path
# gave (the script's time)
NEW_BF16_PATHS = [p for p, ref in BF16_PATHS.items() if PATHS[ref][1]]
BF16_PATHS_KW = PATHS["bf16"][0]
# the path whose bf16 calls a bf16 row of the kernels line is timed on
BF16_ROW_PATH = {
    "segment_sum_csr": "bf16", "gather_rows": "bf16", "segment_sum_pair": "bf16",
    "gather_project_sum": "bf16", "gated_message_fwd": "bf16",
    "gated_message_bwd": "bf16", "gated_update_fwd": "bf16",
    "gated_update_bwd": "bf16", "gather_sum_rows": "directed_bonds=False bf16",
    "gated_message_reduce": "CHGNET_TPU_MSG_REDUCE=1 bf16",
    "segment_sum_tiles": "CHGNET_TPU_STREAM_V2=1 bf16",
    "gather_rows_window": "CHGNET_TPU_STREAM_V2=1 bf16",
    "fused_pass_fwd": "CHGNET_TPU_FUSED_PASS=1 bf16",
    "fused_pass_bwd": "CHGNET_TPU_FUSED_PASS=1 bf16",
}
# the paths traced in phase 5, and the CUDA kernels each trace must show
PROFILED = {
    "default": ("tail_fwd_tc_kernel", "tail_bwd_tc_kernel"),
    "directed_bonds=False": (),
    "CHGNET_TPU_MSG_REDUCE=1": ("tail_reduce_tc_kernel",),
    "CHGNET_TPU_STREAM_V2=1": ("gather_window_kernel",),
    "CHGNET_TPU_FUSED_PASS=1": ("pass_fwd_tc_kernel", "pass_bwd_tc_kernel"),
    "bf16": ("tail_fwd_tc_kernel<__nv_bfloat16>", "tail_bwd_tc_kernel<__nv_bfloat16",
             "gproj_tc_kernel<__nv_bfloat16>", "segment_sum_csr_kernel<__nv_bfloat16"),
    "directed_bonds=False CHGNET_TPU_FUSED_PASS=1 bf16": (
        "pass_fwd_tc_kernel<__nv_bfloat16", "pass_bwd_tc_kernel<__nv_bfloat16"),
}
# ... and the kernels it must not show: the CUDA-core one-kernel pass
# (parameter gradients only) has no place in serving, and the windowed
# gather's first kernel, which staged every window whole, is gone
UNPROFILED = {
    "CHGNET_TPU_STREAM_V2=1": ("gather_rows_window_kernel",),
    "CHGNET_TPU_FUSED_PASS=1": ("pass_fwd_kernel<", "pass_bwd_kernel<"),
    "directed_bonds=False CHGNET_TPU_FUSED_PASS=1 bf16": (
        "pass_fwd_kernel<", "pass_bwd_kernel<"),
}
MODEL_TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
# a bf16 path against its f32 path on the card, and its card run against its
# CPU run: tests/test_model.py's bf16 bars (e eV/atom, f eV/A, m mu_B); stress
# in GPa at about 5x chgnet_tpu's own bf16 gap on the CPU, 3.8e-3 GPa on 4 of
# bench.py's supercells at full width
BF16_BARS = {"e": 2e-3, "f": 2e-2, "s": 2e-2, "m": 2e-2}
# a bf16 kernel against its plain version: both widen to f32, compute in f32
# and round each output once, so they differ by at most one rounding, one
# bf16 ulp (2^-7) of an output's largest value; gathers are exact;
# gather_project_sum is held to the plain version with its route's rounding
# (gather_project_sum_route_plain): the long route rounds only the output
# (one ulp), the short route also each pair's projected table, whose
# rounding may fall on the other side of a tie from the kernel's f32 sums
# (one more ulp a pair: bf16_tol); the parameter-gradient forms of rows 7,
# 9 and 14 round sums over tens of thousands of rows that the kernel and the
# plain version add in different f32 orders, so one rounding of sums that
# differ by up to the f32 kernel's own tolerance (bf16_tol)
BF16_ULP = 2.0**-7
BF16_TOL = {
    "segment_sum_csr": BF16_ULP, "gather_rows": 0.0, "segment_sum_pair": BF16_ULP,
    "gather_project_sum": BF16_ULP, "gated_message_fwd": BF16_ULP,
    "gated_message_bwd": BF16_ULP, "gated_update_fwd": BF16_ULP,
    "gated_update_bwd": BF16_ULP, "gather_sum_rows": 0.0,
    "gated_message_reduce": BF16_ULP, "segment_sum_tiles": BF16_ULP,
    "gather_rows_window": 0.0, "fused_pass_fwd": BF16_ULP,
    "fused_pass_bwd": BF16_ULP,
}
# rows 10-14: on the paths of NEW_BF16_PATHS every bf16 call of
# theirs is held, of the other kernels only calls of a shape no earlier path
# gave
NEW_ROWS = ("gated_message_reduce", "segment_sum_tiles", "gather_rows_window",
            "fused_pass_fwd", "fused_pass_bwd")

# the simulation phase's pinned seed-0 traces: a copy of
# tests/test_golden_traces.py's (that module imports chgnet_tpu; a CPU test
# holds the two copies equal). The model's widths, then per MD ensemble the
# potential energy [eV] and temperature [K] after each of 10 runs of 3 steps,
# then FIRE's energy at each of 25 steps
GOLDEN_SMALL = dict(
    atom_fea_dim=16,
    bond_fea_dim=16,
    angle_fea_dim=16,
    num_radial=9,
    num_angular=9,
    n_conv=2,
    mlp_hidden_dims=(16,),
    atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16,
)

# (ensemble, thermostat) -> (epot [eV] every 3rd step, T [K] every 3rd step)
GOLDEN_MD = {
    ("nve", "Berendsen_inhomogeneous"): (
        [-56.184486, -56.180012, -56.174957, -56.169758, -56.16481,
         -56.160439, -56.156845, -56.154091, -56.152088, -56.150677],
        [296.647, 292.322, 287.44, 282.414, 277.63,
         273.404, 269.933, 267.268, 265.329, 263.96],
    ),
    ("nvt", "Nose-Hoover"): (
        [-56.184486, -56.180012, -56.174957, -56.16975, -56.164783,
         -56.160389, -56.156765, -56.153969, -56.151913, -56.150433],
        [296.662, 292.447, 287.882, 283.496, 279.78,
         277.138, 275.835, 275.963, 277.449, 280.12],
    ),
    ("nvt", "Berendsen"): (
        [-56.184486, -56.180008, -56.174942, -56.169716, -56.164722,
         -56.160297, -56.156651, -56.153831, -56.151756, -56.150261],
        [296.897, 293.257, 289.518, 286.069, 283.23,
         281.224, 280.141, 279.923, 280.391, 281.321],
    ),
    ("npt", "Nose-Hoover"): (
        [-56.184483, -56.17997, -56.174812, -56.169403, -56.164101,
         -56.159153, -56.154625, -56.150364, -56.146065, -56.141438],
        [296.314, 291.265, 285.435, 279.417, 273.761,
         268.907, 265.118, 262.455, 260.838, 260.175],
    ),
    ("npt", "Nose-Hoover-full"): (
        [-56.184509, -56.18013, -56.175278, -56.170406, -56.165932,
         -56.162174, -56.159309, -56.157307, -56.155941, -56.154919],
        [296.433, 291.665, 286.251, 280.753, 275.69,
         271.484, 268.398, 266.502, 265.706, 265.858],
    ),
    ("npt", "Berendsen"): (
        [-56.184486, -56.180004, -56.174934, -56.169704, -56.164707,
         -56.160275, -56.156616, -56.153786, -56.151691, -56.150173],
        [296.897, 293.256, 289.516, 286.065, 283.224,
         281.215, 280.129, 279.905, 280.364, 281.282],
    ),
}

GOLDEN_FIRE = [
    -56.177689, -56.177723, -56.177792, -56.177895, -56.178032,
    -56.178207, -56.178413, -56.178654, -56.178955, -56.17934,
    -56.179817, -56.180412, -56.181145, -56.182045, -56.18314,
    -56.184471, -56.186077, -56.187992, -56.190266, -56.192936,
    -56.196037, -56.199589, -56.203587, -56.208008, -56.212807,
]

_CSRC = "chgnet_tpu_torch/csrc/"
_TPU = "chgnet_tpu/ops/"
# per kernel: its source, the TPU kernel it replaces, the tolerance on
# max|kernel - plain| / max|plain| per output, and the path its calls,
# launches and times are taken on
KERNELS = {
    name: dict(source=_CSRC + source, replaces=_TPU + replaces, tol=tol, path=path)
    for name, source, replaces, tol, path in (
        ("segment_sum_csr", "segment_sum.cu", "stream_ops.py:135", 1e-5, "default"),
        ("gather_rows", "gather_rows.cu", "stream_ops.py:645", 0.0, "default"),
        ("segment_sum_pair", "segment_sum.cu", "stream_ops.py:257", 1e-5, "default"),
        ("gather_project_sum", "gproj.cu", "gproj.py:62", 2e-5, "default"),
        ("gated_message_fwd", "gated_message.cu", "gated_message.py:55", 1e-5,
         "default"),
        ("gated_message_bwd", "gated_message.cu", "gated_message.py:190", 1e-4,
         "default"),
        ("gated_update_fwd", "gated_message.cu", "gated_message.py:620", 1e-5,
         "default"),
        ("gated_update_bwd", "gated_message.cu", "gated_message.py:734", 1e-4,
         "default"),
        ("gather_sum_rows", "multi_gather.cu", "stream_ops.py:775", 0.0,
         "directed_bonds=False"),
        # row-order adds against the tail's rounding and float64 prefix sums
        ("gated_message_reduce", "gated_message.cu", "gated_message.py:378", 1e-5,
         "CHGNET_TPU_MSG_REDUCE=1"),
        # rows in order inside a tile, then tiles in order, against float64
        # prefix sums
        ("segment_sum_tiles", "segment_sum.cu", "stream_ops.py:1003", 1e-5,
         "CHGNET_TPU_STREAM_V2=1"),
        ("gather_rows_window", "gather_window.cu", "stream_ops.py:1109", 0.0,
         "CHGNET_TPU_STREAM_V2=1"),
        ("fused_pass_fwd", "fused_pass.cu", "fused_pass.py:157", 1e-5,
         "CHGNET_TPU_FUSED_PASS=1"),
        ("fused_pass_bwd", "fused_pass.cu", "fused_pass.py:393", 1e-4,
         "CHGNET_TPU_FUSED_PASS=1"),
    )
}


@contextlib.contextmanager
def env_switch(name: str | None):
    """The environment variable ``name`` set to 1 for the duration (nothing
    for None); it is restored afterwards."""
    saved = os.environ.get(name) if name else None
    if name:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if name and saved is None:
            os.environ.pop(name, None)
        elif name:
            os.environ[name] = saved


LOG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke.log"
)


def log(*args) -> None:
    """Print a line, and keep it in ``build/chip_smoke.log`` beside the
    script (the whole run's lines, where a terminal shows only the last)."""
    print(*args, flush=True)
    with open(LOG_PATH, "a") as fh:
        print(*args, file=fh)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, warm_up: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up unless
    ``warm_up`` is false (a plain version that already ran on the same
    inputs in its hold: it compiles nothing, and one run of the slowest
    takes seconds)."""
    if warm_up:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


# ------------------------------------------------------------ recording
class Recorder:
    """Swaps each kernel wrapper for one that logs its arguments, for one
    pass; the wrappers' own launch counts are untouched meanwhile."""

    def __init__(self):
        from chgnet_tpu_torch.ops import (
            fused_pass, gated_message, gproj, multi_gather, segment,
        )

        slots = [
            (segment, "segment_sum_csr", "segment_sum_csr"),
            (segment, "gather_rows", "gather_rows"),
            (segment, "segment_sum_pair", "segment_sum_pair"),
            (segment, "segment_sum_tiles", "segment_sum_tiles"),
            (segment, "gather_rows_window", "gather_rows_window"),
            (gproj, "gather_project_sum_kernel", "gather_project_sum"),
            (multi_gather, "gather_sum_rows", "gather_sum_rows"),
            (fused_pass, "fused_pass_fwd", "fused_pass_fwd"),
            (fused_pass, "fused_pass_bwd", "fused_pass_bwd"),
        ] + [(gated_message, name, name) for name in (
            "gated_message_fwd", "gated_message_bwd", "gated_update_fwd",
            "gated_update_bwd", "gated_message_reduce",
        )]
        self.slots = slots
        self.calls = {name: [] for *_, name in self.slots}
        self.saved = []

    def __enter__(self):
        for mod, attr, name in self.slots:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))

            def rec(*args, _orig=orig, _log=self.calls[name]):
                _log.append(args)
                return _orig(*args)

            rec.launches = rec.launches_bf16 = 0  # the wrapper counts here
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)


def _rows_valid(offsets: torch.Tensor) -> int:
    return int(offsets[-1])


def _tail_bound(name, args):
    """(bytes, product FLOPs, elementwise FLOPs) of one fused-tail call: its
    inputs read once, its outputs written once; the two diagonal blocks'
    FLOPs per product and ``TAIL_OPS`` per row element."""
    acc = args[0]
    es = acc.element_size()  # every float input and output of a call alike
    n_rows, d = acc.shape[0], acc.shape[1] // 2
    msg = name.startswith("gated_message")
    params = args[3] if msg else args[1 + (name == "gated_update_fwd")]
    has_w2 = len(params) == 7
    form = "message" if msg else "update_w2" if has_w2 else "update"
    product = 4 * n_rows * d * d if has_w2 else 0
    n_in = sum(t.numel() for t in _tensors(args))
    if name.endswith("_fwd"):
        return es * (n_in + n_rows * d), product, TAIL_OPS["fwd", form] * n_rows * d
    need_params = args[-1]
    need_mask = msg and args[-2]
    ops = TAIL_OPS["bwd", form] + (D_MASK_OPS if need_mask else 0)
    ops += PARAM_OPS[has_w2] if need_params else 0
    n_out = 2 * n_rows * d
    if msg:
        n_out += n_rows * d + (n_rows if need_mask else 0)
    n_out += sum(p.numel() for p in params) if need_params else 0
    products = (3 if need_params else 2) * product
    return es * (n_in + n_out), products, ops * n_rows * d


def _distinct_rows(tables, idxs):
    """Rows named in range, counted once per distinct table."""
    named = {}
    for t, i in zip(tables, idxs):
        ok = i[(i >= 0) & (i < t.shape[0])]
        named.setdefault(t.data_ptr(), []).append(ok)
    return sum(int(torch.unique(torch.cat(v)).numel()) for v in named.values())


def _pass_bound(name, args):
    """(bytes, product FLOPs, elementwise FLOPs) of one call of the
    one-kernel pass: the index streams,
    the distinct gathered rows of the projected tables, the aligned stream,
    weights and mask or resnet (and the cotangent), and the outputs, each
    once; the tail's products and ``TAIL_OPS``, and one add per part (the
    gathered ones, the aligned one, the bias) and accumulator element."""
    tables, idxs, aligned, b1, params, weights, mask = args[:7]
    n_rows, d = idxs[0].shape[0], tables[0].shape[1] // 2
    msg = weights is not None
    has_w2 = len(params) == 7
    form = "message" if msg else "update_w2" if has_w2 else "update"
    n_streams = len({i.data_ptr() for i in idxs})
    es = tables[0].element_size()
    idx_bytes = 4 * n_streams * n_rows
    n_in = _distinct_rows(tables, idxs) * 2 * d + 2 * d
    n_in += n_rows * 2 * d if aligned is not None else 0
    n_in += sum(p.numel() for p in params)
    n_in += n_rows * (d + 1) if msg else 0
    adds = (len(tables) + (aligned is not None) + 1) * n_rows * 2 * d
    product = 4 * n_rows * d * d if has_w2 else 0
    if name == "fused_pass_fwd":
        n_in += 0 if msg else n_rows * d  # resnet
        ops = TAIL_OPS["fwd", form] * n_rows * d + adds
        return idx_bytes + es * (n_in + n_rows * d), product, ops
    need_mask, need_params = args[8], args[9]
    n_in += n_rows * d  # the cotangent
    ops = TAIL_OPS["bwd", form] + (D_MASK_OPS if need_mask else 0)
    ops += PARAM_OPS[has_w2] + 2 if need_params else 0  # + d_b1's sums
    n_out = n_rows * 2 * d + (n_rows * d if msg else 0) + (n_rows if need_mask else 0)
    n_out += sum(p.numel() for p in params) + 2 * d if need_params else 0
    products = (3 if need_params else 2) * product
    return idx_bytes + es * (n_in + n_out), products, ops * n_rows * d + adds


def bound_and_library(name, args):
    """(bytes, product FLOPs, elementwise FLOPs, library callable or None)
    of one recorded call."""
    if name.startswith("fused_pass"):
        return (*_pass_bound(name, args), None)
    if name == "gated_message_reduce":
        # the message tail over the rows that feed a segment (the dropped
        # rows past offsets[-1] are never needed), their sum, n_out rows out
        acc, weights, mask, params, offsets = args
        d, n_out = weights.shape[1], offsets.shape[0] - 1
        nv = _rows_valid(offsets)
        n_floats = nv * (3 * d + 1) + sum(p.numel() for p in params) + n_out * d
        ops = (TAIL_OPS["fwd", "message"] + 1) * nv * d
        nbytes = acc.element_size() * n_floats + 4 * (n_out + 1)
        return nbytes, 4 * nv * d * d, ops, None
    if name == "gather_sum_rows":
        # every index stream, the distinct rows they name of every distinct
        # table, the stream, the output; one add per part and element
        tables, idxs, stream = args
        n_rows, d = idxs[0].shape[0], tables[0].shape[1]
        distinct = _distinct_rows(tables, idxs)
        n_streams = len({i.data_ptr() for i in idxs})
        n_adds = len(tables) - (stream is None)
        nbytes = 4 * n_streams * n_rows + tables[0].element_size() * (
            distinct * d + (1 + (stream is not None)) * n_rows * d)
        longs = [i.clamp(0, t.shape[0] - 1).long() for t, i in zip(tables, idxs)]

        def lib():
            out = stream
            for t, i in zip(tables, longs):
                rows = torch.index_select(t, 0, i)
                out = rows if out is None else out + rows
            return out

        return nbytes, 0, n_adds * n_rows * d, lib
    if name.startswith("gated_"):
        return (*_tail_bound(name, args), None)
    if name in ("segment_sum_csr", "segment_sum_tiles"):
        x, offsets, perm = args
        n_out, d = offsets.shape[0] - 1, x.shape[1]
        es = x.element_size()
        nv = _rows_valid(offsets)
        nbytes = nv * d * es + (nv * 4 if perm.numel() else 0)
        nbytes += (n_out + 1) * 4 + n_out * d * es
        key = _segment_ids(offsets, perm, x.shape[0])
        buf = torch.zeros((n_out + 1, d), device=x.device, dtype=x.dtype)
        return nbytes, 0, nv * d, lambda: buf.zero_().index_add_(0, key, x)
    if name == "segment_sum_pair":
        x, oa, pa, ob, pb = args
        n_out, d = oa.shape[0] - 1, x.shape[1]
        es = x.element_size()
        ka = _segment_ids(oa, pa, x.shape[0])
        kb = _segment_ids(ob, pb, x.shape[0])
        rows = int(((ka < n_out) | (kb < n_out)).sum())
        nv = _rows_valid(oa) + _rows_valid(ob)
        nbytes = rows * d * es + (_rows_valid(oa) * 4 if pa.numel() else 0)
        nbytes += (_rows_valid(ob) * 4 if pb.numel() else 0)
        nbytes += 2 * (n_out + 1) * 4 + 2 * n_out * d * es
        bufs = [torch.zeros((n_out + 1, d), device=x.device, dtype=x.dtype)
                for _ in range(2)]

        def lib():
            bufs[0].zero_().index_add_(0, ka, x)
            bufs[1].zero_().index_add_(0, kb, x)

        return nbytes, 0, nv * d, lib
    if name in ("gather_rows", "gather_rows_window"):
        src, idx = args[:2]
        d = src.shape[1]
        ok = (idx >= 0) & (idx < src.shape[0])
        nbytes = 0
        if name == "gather_rows_window":  # only rows inside their windows
            from chgnet_tpu_torch.graph.batching import WINDOW_BLOCK

            window = args[2]
            block = torch.arange(idx.shape[0], device=idx.device) // WINDOW_BLOCK
            ok &= (idx >= window[block, 0]) & (idx <= window[block, 1])
            nbytes = window.numel() * 4
        distinct = int(torch.unique(idx[ok]).numel())
        es = src.element_size()
        nbytes += idx.numel() * 4 + distinct * d * es + idx.numel() * d * es
        safe = idx.clamp(0, src.shape[0] - 1).long()
        return nbytes, 0, 0, lambda: torch.index_select(src, 0, safe)
    if name == "gather_project_sum":
        tables, idxs, ws, stream = args
        n_rows, k_out = stream.shape
        dt = tables[0].shape[1]
        uniq_t = {t.data_ptr(): t for t in tables}
        uniq_i = {i.data_ptr(): i for i in idxs}
        es = stream.element_size()
        nbytes = sum(t.numel() * es for t in uniq_t.values())
        nbytes += sum(i.numel() * 4 for i in uniq_i.values())
        nbytes += len(ws) * dt * k_out * es + 2 * n_rows * k_out * es
        # the cheaper of two orders: gather then project every row, or
        # project each distinct (table, W) once and add the gathered rows;
        # (products, adds) of each
        gather_first = (2 * n_rows * len(ws) * dt * k_out, n_rows * k_out)
        projected = {
            (t.data_ptr(), w.data_ptr()): t.shape[0] for t, w in zip(tables, ws)
        }
        project_first = (sum(2 * n * dt * k_out for n in projected.values()),
                         len(ws) * n_rows * k_out)
        rate = product_rate(name, args)
        products, adds = min(gather_first, project_first,
                             key=lambda f: _ops_ms(f, rate))
        longs = [i.long() for i in idxs]

        def lib():
            out = stream
            for t, i, w in zip(tables, longs, ws):
                out = out + torch.index_select(t, 0, i) @ w
            return out

        return nbytes, products, adds, lib
    raise KeyError(name)


def _ops_ms(flops, rate=F32_TC_FLOPS) -> float:
    """Least ms of (product FLOPs, elementwise FLOPs) on the card, products
    at ``rate``."""
    products, ops = flops
    return (products / rate + ops / F32_FLOPS) * 1e3


def product_rate(name, args) -> float:
    """The tensor cores' peak for a call's matrix products, by their
    operands' types: f32 calls multiply f32 by f32 (3xTF32); a bf16
    gather_project_sum multiplies bf16 tables by bf16 weights (the bf16
    rate); a bf16 tail multiplies an f32 value (silu(acc), d_y) by a bf16 W2
    (two TF32 passes), and its backward with parameter gradients adds one
    f32 by f32 product of the same size (dW2 from silu(acc) and d_y), so
    those calls take the rate of two products at the one and one at the
    other."""
    if call_dtype(args) != torch.bfloat16:
        return F32_TC_FLOPS
    if name == "gather_project_sum":
        return BF16_TC_FLOPS
    need_params = name.endswith("_bwd") and (
        args[9] if name == "fused_pass_bwd" else args[-1])
    if need_params:
        return 3 / (2 / F32_BF16_TC_FLOPS + 1 / F32_TC_FLOPS)
    return F32_BF16_TC_FLOPS


def call_dtype(args) -> torch.dtype:
    """The float type of a recorded call (its first float tensor's)."""
    return next(t.dtype for t in _tensors(args) if t.is_floating_point())


def _segment_ids(offsets, perm, n_rows):
    """Row-aligned segment id of every row (n_out for dropped rows)."""
    n_out = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    sorted_ids = torch.repeat_interleave(
        torch.arange(n_out, device=offsets.device), counts
    )
    ids = torch.full((n_rows,), n_out, dtype=torch.long, device=offsets.device)
    nv = sorted_ids.numel()
    rows = perm[:nv].long() if perm.numel() else torch.arange(nv, device=ids.device)
    ids[rows] = sorted_ids
    return ids


PAIR_BLOCK_ROWS = 8  # output rows of a block of segment_sum_pair_kernel


def pair_windows(args, rows: int) -> dict:
    """The rows of ``x`` that one ``segment_sum_pair`` call (``args``) reads
    for each range of ``rows`` consecutive output rows (the last range
    ragged): per range, the span from the lowest to the highest row either
    stream reads (``union``) and that of the first stream alone (``a``);
    their median, mean and largest over the ranges that read a row, the
    union's also in bytes of ``x``."""
    x, oa, pa, ob, pb = args
    n_out = oa.shape[0] - 1
    n_ranges = -(-n_out // rows)
    spans = {}
    lo = torch.full((n_ranges,), x.shape[0], dtype=torch.long, device=x.device)
    hi = torch.full((n_ranges,), -1, dtype=torch.long, device=x.device)
    for key, offsets, perm in (("a", oa, pa), ("union", ob, pb)):
        counts = (offsets[1:] - offsets[:-1]).long()
        out_row = torch.repeat_interleave(
            torch.arange(n_out, device=x.device), counts)
        nv = out_row.numel()
        src = perm[:nv].long() if perm.numel() else torch.arange(nv, device=x.device)
        lo.scatter_reduce_(0, out_row // rows, src, "amin")
        hi.scatter_reduce_(0, out_row // rows, src, "amax")
        read = hi >= 0
        spans[key] = (hi - lo + 1)[read].double()
    row_bytes = x.shape[1] * x.element_size()
    out = {"rows": rows, "ranges": int(spans["union"].numel())}
    for key, span in spans.items():
        if not span.numel():
            out[key] = dict(median=0, mean=0.0, max=0)
            continue
        out[key] = dict(median=int(span.median()), mean=float(span.mean()),
                        max=int(span.max()))
    out["union"]["max_bytes"] = out["union"]["max"] * row_bytes
    return out


# ------------------------------------------------------------- phases
def phase_card_and_build():
    from chgnet_tpu_torch.ops import build

    log("card:", card_line())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    log("tf32: torch.backends.cuda.matmul.allow_tf32 =",
        torch.backends.cuda.matmul.allow_tf32,
        "torch.backends.cudnn.allow_tf32 =", torch.backends.cudnn.allow_tf32,
        "(compute_batch turns both off while it runs)")
    t0 = time.perf_counter()
    built = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (compiled {built})")
    for name in build.SOURCES:
        log_ptxas(name, f"{build.lib_path(name)}.log")
    from chgnet_tpu_torch.ops import fused_pass, gated_message

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for lib, mod in (("gated_message", gated_message), ("fused_pass", fused_pass)):
        for kernel, (smem, warps, wave) in mod.tc_occupancy().items():
            log(f"occupancy {lib}: {kernel}: {smem} bytes dynamic shared "
                f"memory, {warps} warps a block, {wave / n_sm:g} blocks "
                f"({warps * wave / n_sm:g} warps) an SM of {n_sm}")


def log_ptxas(name: str, path: str) -> None:
    """Registers, spills and static shared memory per kernel from nvcc's
    ``-Xptxas -v`` report, the kernel names demangled by the toolkit's
    ``cu++filt``."""
    from chgnet_tpu_torch.ops import build

    if not os.path.exists(path):
        return
    rows, kernel, spills = [], None, 0
    with open(path) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                smem = re.search(r"(\d+) bytes smem", line)
                rows.append((kernel, m.group(1), spills, smem.group(1) if smem else "0"))
                kernel, spills = None, 0
    filt = os.path.join(os.path.dirname(build.nvcc()), "cu++filt")
    names = subprocess.run(
        [filt, "-p", *(r[0] for r in rows)], check=True, capture_output=True,
        text=True, timeout=60,
    ).stdout.splitlines()
    for kernel, (_, regs, spills, smem) in zip(names, rows):
        log(f"ptxas {name}: {kernel}: {regs} registers, {spills} bytes spilled, "
            f"{smem} bytes static shared memory")


def bench_structs(n: int = N_STRUCTS):
    """The first ``n`` of bench.py's perturbed 216-atom LiMnO2 supercells
    (seeds 0 .. n - 1)."""
    from chgnet_tpu_torch import ROOT
    from chgnet_tpu_torch.core.structure import Structure

    base = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    return [base.make_supercell(3).perturb(0.05, seed=seed) for seed in range(n)]


def bench_graphs(converter):
    return [converter(s, graph_id=str(seed))
            for seed, s in enumerate(bench_structs())]


def run_pass(model, batch):
    from chgnet_tpu_torch.models.chgnet import compute_batch

    return compute_batch(
        model.params, batch, config=model.config, compute_force=True,
        compute_stress=True, compute_magmom=True,
    )


def kernel_versions() -> dict:
    """Kernel name -> (kernel wrapper, its plain version)."""
    from chgnet_tpu_torch.ops import fused_pass as fp
    from chgnet_tpu_torch.ops import gated_message as gm
    from chgnet_tpu_torch.ops import gproj, multi_gather, segment

    return {
        "segment_sum_csr": (segment.segment_sum_csr, segment.segment_sum_plain),
        "gather_rows": (segment.gather_rows, segment.gather_rows_plain),
        "segment_sum_pair": (segment.segment_sum_pair,
                             segment.segment_sum_pair_plain),
        "gather_project_sum": (gproj.gather_project_sum_kernel,
                               gproj.gather_project_sum_route_plain),
        "gated_message_fwd": (gm.gated_message_fwd, gm.gated_message_plain),
        "gated_message_bwd": (gm.gated_message_bwd, gm.gated_message_bwd_plain),
        "gated_update_fwd": (gm.gated_update_fwd, gm.gated_update_plain),
        "gated_update_bwd": (gm.gated_update_bwd, gm.gated_update_bwd_plain),
        "gather_sum_rows": (multi_gather.gather_sum_rows,
                            multi_gather.gather_sum_rows_plain),
        "gated_message_reduce": (gm.gated_message_reduce,
                                 gm.gated_message_reduce_plain),
        "segment_sum_tiles": (segment.segment_sum_tiles, segment.segment_sum_plain),
        "gather_rows_window": (segment.gather_rows_window,
                               segment.gather_rows_window_plain),
        "fused_pass_fwd": (fp.fused_pass_fwd, fp.fused_pass_fwd_plain),
        "fused_pass_bwd": (fp.fused_pass_bwd, fp.fused_pass_bwd_plain),
    }


def _errors(got, want):
    """(max |got - want|, that over max |want|) of one output."""
    if not want.numel():
        return 0.0, 0.0
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / scale if scale else math.inf if err else 0.0


def _signature(name, args) -> tuple:
    """What makes two calls of a kernel alike: their float type, every
    tensor's shape and the flags (the backwards' need_mask, need_params)."""
    return (name, call_dtype(args), tuple(tuple(t.shape) for t in _tensors(args)),
            tuple(a for a in args if isinstance(a, bool)))


def phase_kernels(path, calls, counts=None, held=None, skip=False):
    """Every call recorded on one pass of ``path`` through the kernel and
    its plain version, each output's error relative to that output's
    largest value, at ``KERNELS``' tolerance for f32 calls and
    ``bf16_tol`` for bf16 ones. Every kernel the path launches (``counts``,
    in the order of ``KERNELS``; by default the path's launch set in
    ``PATHS``) must have been recorded. With ``held`` (the signatures of
    the calls held so far, which this adds to) and ``skip`` (the paths of
    ``NEW_BF16_PATHS``, the bf16 train steps) it holds only the bf16 calls
    that ``new_bf16_call`` names and the calls of a signature not held
    before. Returns the largest absolute error by kernel, under ``"<name>
    bf16"`` for the bf16 calls."""
    errors, failed = {}, []
    skip_held = held is not None and skip
    expected = dict(zip(KERNELS, counts or PATHS[path][2]))
    for name, (kern, plain) in kernel_versions().items():
        if not expected[name]:
            continue
        if not calls[name]:
            raise RuntimeError(f"{name}: no call recorded on the {path} path")
        by_type = {}
        for args in calls[name]:
            by_type.setdefault(call_dtype(args), []).append(args)
        for dtype, group in sorted(by_type.items(), key=str):
            bf16 = dtype == torch.bfloat16
            worst, worst_scaled, over, tols = 0.0, 0.0, False, set()
            n_held = 0
            for args in group:
                sig = _signature(name, args)
                if skip_held and sig in held and not (bf16 and new_bf16_call(name, args)):
                    continue
                if held is not None:
                    held.add(sig)
                n_held += 1
                got = list(_tensors([kern(*args)]))
                want = list(_tensors([plain(*args)]))
                if len(got) != len(want) or any(
                    g.dtype != w.dtype for g, w in zip(got, want)
                ):
                    raise AssertionError(f"{name}: kernel and plain outputs differ")
                tol = bf16_tol(name, args) if bf16 else KERNELS[name]["tol"]
                tols.add(tol)
                for g, w in zip(got, want):
                    err, scaled = _errors(g.float(), w.float())
                    worst = max(worst, err)
                    worst_scaled = max(worst_scaled, scaled)
                    over |= not scaled <= tol
            torch.cuda.synchronize()
            shapes = sorted({
                tuple(a.shape) for args in group for a in _tensors(args)
            })
            label = f"{name} bf16" if bf16 else name
            tol_text = "/".join(f"{t:g}" for t in sorted(tols))
            if not n_held:
                log(f"kernel {label} ({path} path): {len(group)} calls, each of "
                    "a shape an earlier path held")
                continue
            log(f"kernel {label} ({path} path): "
                f"{len(group)} calls ({n_held} held), max_abs_err {worst:.3e}, "
                f"relative {worst_scaled:.3e} (tol {tol_text}); shapes {shapes}")
            if over:
                failed.append(label)
            errors[label] = worst
    if failed:
        raise AssertionError(
            f"{path} path: disagree with their plain versions: {failed}")
    return errors


def new_bf16_call(name, args) -> bool:
    """Whether a call with bf16 arguments is held wherever it runs: rows
    10-14, or a backward's parameter-gradient form (rows 7, 9, 14)."""
    return name in NEW_ROWS or (name in PARAM_FORM and bool(args[PARAM_FORM[name]]))


def bf16_tol(name, args) -> float:
    """``BF16_TOL`` for one bf16 call; gather_project_sum's short route one
    ulp more a pair, a backward with parameter gradients the f32 kernel's
    tolerance more (``BF16_TOL``'s comment)."""
    if name in PARAM_FORM and args[PARAM_FORM[name]]:
        return BF16_TOL[name] + KERNELS[name]["tol"]
    if name != "gather_project_sum":
        return BF16_TOL[name]
    from chgnet_tpu_torch.ops import gproj

    tables, _, _, stream = args
    route = gproj.gproj_route(len(tables), tables[0].shape[0], stream.shape[1],
                              stream.element_size())
    return BF16_ULP * (1 + len(tables) if route == "short" else 1)


def bf16_calls_of(path, calls) -> dict:
    """The recorded calls with bf16 arguments of each kernel whose bf16 row
    is timed on ``path`` (``BF16_ROW_PATH``)."""
    bf16 = {name: [a for a in calls[name] if call_dtype(a) == torch.bfloat16]
            for name, row_path in BF16_ROW_PATH.items() if row_path == path}
    missing = [n for n, c in bf16.items() if not c]
    if missing:
        raise AssertionError(f"{path}: no bf16 call recorded of {missing}")
    return bf16


# the wrappers of rows 4-10, 13 and 14, which on a bf16 run launch with bf16
# arguments only (rows 1-3, 11 and 12 also carry the f32 geometry and
# readout, as in chgnet_tpu)
CONV_WRAPPERS = (
    "gather_project_sum_kernel", "gated_message_fwd", "gated_message_bwd",
    "gated_update_fwd", "gated_update_bwd", "gather_sum_rows",
    "gated_message_reduce", "fused_pass_fwd", "fused_pass_bwd",
)
# the stream wrappers that launch with f32 arguments only on a bf16 path: the
# stream-v2 path's one gather_rows launch is the readout's 1-wide atom ->
# graph cotangent, f32 on every path (the other 16 gathers take the windows)
F32_ONLY = {"CHGNET_TPU_STREAM_V2=1 bf16": ("gather_rows",)}


def read_launches() -> tuple[dict, dict]:
    """Every kernel wrapper's ``launches`` and ``launches_bf16`` since the
    last ``reset_launch_counts()``, by wrapper name."""
    from chgnet_tpu_torch import ops

    return ({fn.__name__: fn.launches for fn in ops.KERNELS},
            {fn.__name__: fn.launches_bf16 for fn in ops.KERNELS})


def check_bf16_launches(label, launches, bf16_launches, bf16: bool) -> None:
    """On a bf16 run every wrapper that launched did so with bf16 arguments
    at least once (none at all for ``F32_ONLY[label]``), and the conv
    stack's wrappers only with bf16 (``CONV_WRAPPERS``); on an f32 run none
    did."""
    log(f"{label} launches with bf16 arguments:", bf16_launches)
    if bf16:
        f32_only = F32_ONLY.get(label, ())
        wrong = [n for n, c in launches.items() if c and (
            bool(bf16_launches[n]) == (n in f32_only)
            or (n in CONV_WRAPPERS and bf16_launches[n] != c))]
    else:
        wrong = [n for n, c in bf16_launches.items() if c]
    if wrong:
        raise AssertionError(
            f"{label}: launches of the wrong storage type: {wrong}")


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def check_autograd(batch):
    """Each autograd op (forward + backward, so both directions of the
    gather/segment-sum pair) on the card against the same op on the CPU,
    at the benchmark batch's angle-stream shapes (the message tail and the
    message-reduce also at the edge stream's, the multi-gather ops at the
    undirected AtomConv's and BondConv's, the one-kernel pass in its three
    forms at the directed AtomConv's and the angle-side layers' parts);
    errors relative to each output's largest value."""
    from chgnet_tpu_torch.ops.fused_pass import fused_layer_pass
    from chgnet_tpu_torch.ops.gated_message import (
        LN_KEYS, fused_gated_message, fused_gated_message_reduce,
        fused_gated_update,
    )
    from chgnet_tpu_torch.ops.gproj import gather_project_sum
    from chgnet_tpu_torch.ops.multi_gather import gather_sum, twin_reduce
    from chgnet_tpu_torch.ops.segment import (
        plan_gather, plan_segment_sum, plan_segment_sum_pair,
    )

    n_atoms = batch.atomic_numbers.shape[0]
    n_edges = batch.atom_graph.shape[0]
    n_ang = batch.bond_graph.shape[0]
    gen = torch.Generator().manual_seed(0)
    cpu = batch.to("cpu")
    dir_i = batch.bond_graph[:, 2].contiguous()
    dir_j = batch.bond_graph[:, 4].contiguous()
    w = [torch.randn(64, 128, generator=gen) * 0.1 for _ in range(3)]
    inputs = dict(
        x=torch.randn(n_ang, 64, generator=gen),
        table=torch.randn(n_edges, 64, generator=gen),
        atom_e=torch.randn(n_edges, 64, generator=gen),
        acc=torch.randn(n_ang, 128, generator=gen),
        wts=torch.randn(n_ang, 64, generator=gen),
        mask=(torch.rand(n_ang, generator=gen) < 0.9).float(),
        acc_e=torch.randn(n_edges, 128, generator=gen),
        wts_e=torch.randn(n_edges, 64, generator=gen),
        mask_e=(torch.rand(n_edges, generator=gen) < 0.9).float(),
        atoms_p=torch.randn(n_atoms, 128, generator=gen),
        bonds_p=torch.randn(n_edges // 2, 128, generator=gen),
        edges_p=torch.randn(n_edges, 128, generator=gen),
        edges_q=torch.randn(n_edges, 128, generator=gen),
        x_e=torch.randn(n_edges, 64, generator=gen),
    )
    b1 = torch.randn(128, generator=gen) * 0.1
    tail = dict(
        w2c=torch.randn(64, 64, generator=gen) * 0.1,
        w2g=torch.randn(64, 64, generator=gen) * 0.1,
        b2=torch.randn(128, generator=gen) * 0.1,
        nc_scale=torch.randn(64, generator=gen),
        nc_bias=torch.randn(64, generator=gen) * 0.1,
        ng_scale=torch.randn(64, generator=gen),
        ng_bias=torch.randn(64, generator=gen) * 0.1,
    )
    cts = dict(
        seg=torch.randn(n_edges, 64, generator=gen),
        gat=torch.randn(n_ang, 64, generator=gen),
        pair=torch.randn(n_edges, 128, generator=gen),
        gproj=torch.randn(n_ang, 128, generator=gen),
        tail=torch.randn(n_ang, 64, generator=gen),
        tail_e=torch.randn(n_edges, 64, generator=gen),
        und=torch.randn(n_edges // 2, 64, generator=gen),
        atoms=torch.randn(n_atoms, 64, generator=gen),
    )

    def ops(dev, b, di, dj, t):
        outs = {}
        outs["segment_sum_csr"] = (
            [plan_segment_sum(t["x"], b.plan_ang_vi)], [t["x"]], [cts["seg"]])
        outs["gather_rows"] = (
            [plan_gather(t["table"], dj, b.plan_ang_vj)], [t["table"]],
            [cts["gat"]])
        outs["segment_sum_pair"] = (
            list(plan_segment_sum_pair(t["acc"], b.plan_ang_vi, b.plan_ang_vj)),
            [t["acc"]], [cts["pair"], cts["pair"] * 0.5])
        ws = [x.to(dev).requires_grad_(True) for x in w]
        outs["gather_project_sum"] = (
            [gather_project_sum(
                [(t["table"], di, b.plan_ang_vi, ws[0]),
                 (t["table"], dj, b.plan_ang_vj, ws[1]),
                 (t["atom_e"], di, b.plan_ang_vi, ws[2])], t["acc"])],
            [t["table"], t["atom_e"], t["acc"], *ws], [cts["gproj"]])
        # the fused tails with every parameter gradient; the update in
        # both forms (the main path runs only y = acc)
        tp = {k: v.to(dev).requires_grad_(True) for k, v in tail.items()}
        ln = {k: tp[k] for k in LN_KEYS}
        outs["gated_message_bwd"] = (
            [fused_gated_message(t["acc"], t["wts"], t["mask"], tp)],
            [t["acc"], t["wts"], t["mask"], *tp.values()], [cts["tail"]])
        outs["gated_update_bwd w2"] = (
            [fused_gated_update(t["acc"], t["x"], tp)],
            [t["acc"], t["x"], *tp.values()], [cts["tail"]])
        outs["gated_update_bwd"] = (
            [fused_gated_update(t["acc"], t["x"], ln)],
            [t["acc"], t["x"], *ln.values()], [cts["tail"]])
        # the tails as serving runs them: no gradient for the mask or the
        # parameters, so the backward kernels' serving instantiations
        fixed = {k: v.to(dev) for k, v in tail.items()}
        fixed_ln = {k: fixed[k] for k in LN_KEYS}
        for rows, (acc, wts, mask, ct) in {
            "E": (t["acc_e"], t["wts_e"], t["mask_e"], cts["tail_e"]),
            "A": (t["acc"], t["wts"], t["mask"], cts["tail"]),
        }.items():
            outs[f"gated_message_bwd serving {rows}"] = (
                [fused_gated_message(acc, wts, mask.detach(), fixed)],
                [acc, wts], [ct])
        outs["gated_update_bwd serving w2"] = (
            [fused_gated_update(t["acc"], t["x"], fixed)], [t["acc"], t["x"]],
            [cts["tail"]])
        outs["gated_update_bwd serving"] = (
            [fused_gated_update(t["acc"], t["x"], fixed_ln)],
            [t["acc"], t["x"]], [cts["tail"]])
        # the undirected layout's ops: AtomConv's three projected tables
        # (atoms by center and by neighbor, bonds by d2u) and BondConv's
        # two directed partial sums per bond
        center = b.atom_graph[:, 0].contiguous()
        nbr = b.atom_graph[:, 1].contiguous()
        d2u = b.directed2undirected
        outs["gather_sum_rows"] = (
            [gather_sum([(t["atoms_p"], center, b.plan_center),
                         (t["bonds_p"], d2u, b.plan_d2u),
                         (t["atoms_p"], nbr, b.plan_nbr)])],
            [t["atoms_p"], t["bonds_p"]], [cts["pair"]])
        outs["gather_sum_rows twin_reduce"] = (
            [twin_reduce(t["table"], b.undirected2directed, b.und_second, d2u,
                         b.plan_d2u)],
            [t["table"]], [cts["und"]])
        # the message-reduce as serving runs it; the random masks zero rows
        # whose keys stay in range
        outs["gated_message_reduce E"] = (
            [fused_gated_message_reduce(
                t["acc_e"], t["wts_e"], t["mask_e"].detach(), fixed, b.plan_center)],
            [t["acc_e"], t["wts_e"]], [cts["atoms"]])
        outs["gated_message_reduce A"] = (
            [fused_gated_message_reduce(
                t["acc"], t["wts"], t["mask"].detach(), fixed, b.plan_ang_vi)],
            [t["acc"], t["wts"]], [cts["seg"]])
        # the one-kernel pass with the switch on: message and both update
        # forms, at the directed AtomConv's parts (two atom tables by center
        # and neighbor, the aligned edge stream) and the angle-side layers'
        # (two edge tables by dir_i and dir_j, the aligned angle stream), as
        # serving runs it and with parameter gradients
        bias = b1.to(dev).requires_grad_(True)
        shapes = {
            "E": ([(t["atoms_p"], center, b.plan_center), (t["acc_e"], None, None),
                   (t["atoms_p"], nbr, b.plan_nbr)],
                  [t["atoms_p"], t["acc_e"]], t["wts_e"], t["mask_e"], t["x_e"],
                  cts["tail_e"]),
            "A": ([(t["edges_p"], di, b.plan_ang_vi), (t["edges_q"], dj, b.plan_ang_vj),
                   (t["acc"], None, None)],
                  [t["edges_p"], t["edges_q"], t["acc"]], t["wts"], t["mask"],
                  t["x"], cts["tail"]),
        }
        with env_switch("CHGNET_TPU_FUSED_PASS"):
            for rows, (parts, tabs, wts, mask, res_in, ct) in shapes.items():
                modes = {
                    "serving": (fixed, fixed_ln, bias.detach(), mask.detach()),
                    "params": (tp, ln, bias, mask),
                }
                for mode, (p7, p4, bb, mm) in modes.items():
                    extra = [bb, *p7.values()] if mode == "params" else []
                    outs[f"fused_pass_bwd message {mode} {rows}"] = (
                        [fused_layer_pass(parts, bb, p7, weights=wts, mask=mm)],
                        [*tabs, wts, *([mm] if mode == "params" else []), *extra],
                        [ct])
                    outs[f"fused_pass_bwd update w2 {mode} {rows}"] = (
                        [fused_layer_pass(parts, bb, p7, resnet=res_in)],
                        [*tabs, res_in, *extra], [ct])
                    extra = [bb, *p4.values()] if mode == "params" else []
                    outs[f"fused_pass_bwd update {mode} {rows}"] = (
                        [fused_layer_pass(parts, bb, p4, resnet=res_in)],
                        [*tabs, res_in, *extra], [ct])
        res = {}
        for name, (out, wrt, ct) in outs.items():
            grads = torch.autograd.grad(out, wrt, [c.to(dev) for c in ct])
            res[name] = [o.detach().cpu() for o in out] + [g.cpu() for g in grads]
        return res

    def leaves(dev):
        return {k: v.to(dev).requires_grad_(True) for k, v in inputs.items()}

    on_card = ops("cuda", batch, dir_i, dir_j, leaves("cuda"))
    on_cpu = ops(
        "cpu", cpu, dir_i.cpu(), dir_j.cpu(), leaves("cpu")
    )
    failed = []
    for name in on_card:
        worst = max(_errors(g, w_)[1] for g, w_ in zip(on_card[name], on_cpu[name]))
        tol = max(KERNELS[name.split()[0]]["tol"], 1e-5)
        log(f"autograd {name}: forward + backward vs CPU, relative err "
            f"{worst:.3e} (tol {tol:g})")
        if not worst <= tol:
            failed.append(name)
    if failed:
        raise AssertionError(f"autograd disagrees with the CPU: {failed}")


def phase_model(path, batch, n_edges, graphs):  # batch: the path's own
    """One path of ``PATHS``: LiMnO2 on the card against the CPU, then one
    pass of the benchmark batch between a reset and a read of the launch
    counts, which must equal the path's launch set, its outputs checked,
    and its edges/s. The launches with bf16 arguments, read from the same
    counts, must be all of rows 4-9's and some of every other launched
    kernel's on a bf16 path, none on an f32 path. Returns the launches,
    those with bf16 arguments and the batch's outputs."""
    from chgnet_tpu_torch import ROOT, ops
    from chgnet_tpu_torch.core.structure import Structure
    from chgnet_tpu_torch.models import CHGNet

    kwargs, switch, expect = PATHS[path]
    model = CHGNet(seed=0, device="cuda", **kwargs)
    cpu_model = CHGNet(seed=0, device="cpu", **kwargs)
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    with env_switch(switch):
        got = model.predict_structure(struct, task="efsm")
        want = cpu_model.predict_structure(struct, task="efsm")
    bars = BF16_BARS if kwargs.get("compute_dtype") == "bfloat16" else MODEL_TOL
    for key, tol in bars.items():
        err = float(np.abs(np.asarray(got[key]) - np.asarray(want[key])).max())
        log(f"{path} LiMnO2 {key}: card vs CPU max err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{path} LiMnO2 {key}: card disagrees with the CPU")
    log(f"{path} LiMnO2 e = {got['e']:.6f} eV/atom")

    with env_switch(switch):
        ops.reset_launch_counts()
        out = run_pass(model, batch)
        torch.cuda.synchronize()
        launches, bf16_launches = read_launches()
    log(f"{path} launches in one E+F+S+M pass:", launches)
    if tuple(launches.values()) != expect:
        raise AssertionError(
            f"wrong launches on the {path} path: {launches}, expected {expect}"
        )
    check_bf16_launches(path, launches, bf16_launches,
                        kwargs.get("compute_dtype") == "bfloat16")

    n_graphs = len(graphs)
    for key in ("e", "f", "s", "m"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"non-finite {key}")
    f = out["f"].cpu().numpy()
    s = out["s"].cpu().numpy()[:n_graphs]
    off, worst = 0, 0.0
    for g in graphs:
        worst = max(worst, float(np.abs(f[off: off + g.n_atoms].sum(0)).max()))
        off += g.n_atoms
    asym = float(np.abs(s - np.swapaxes(s, 1, 2)).max())
    log(f"max |sum f| per graph {worst:.3e} eV/A, max |s - s^T| {asym:.3e} GPa")
    if worst > 1e-3 or asym > 1e-3:
        raise AssertionError("force sums or stress symmetry out of bounds")
    e = out["e"].cpu().numpy()[:n_graphs]
    log(f"e mean {e.mean():.6f} eV/atom over {n_graphs} graphs")

    with env_switch(switch):
        samples = sorted(
            cuda_ms(lambda: run_pass(model, batch), 1) for _ in range(MODEL_SAMPLES)
        )
    ms = float(np.median(samples))
    n_atoms = sum(g.n_atoms for g in graphs)
    log(f"{path} E+F+S+M on {n_graphs} graphs, {n_atoms} atoms, {n_edges} directed "
        f"edges: median {ms:.3f} ms/pass over {MODEL_SAMPLES} passes "
        f"(min {samples[0]:.3f}, max {samples[-1]:.3f}), "
        f"{n_edges / ms * 1e3:.1f} edges/s ({card_line()})")
    return launches, bf16_launches, out


def check_same_outputs(path, out, ref_path, ref, bars=MODEL_TOL):
    """The batch outputs of two paths on the card, at ``bars``."""
    for key, tol in bars.items():
        err = float((out[key] - ref[key]).abs().max())
        log(f"{path} vs {ref_path} on the batch, {key}: max diff {err:.3e} "
            f"(tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{path} {key}: disagrees with the {ref_path} path")


def profile_pass(path, batch):  # batch: the path's own
    """One E+F+S+M pass of a path under torch.profiler (``profile_call``).
    Every kernel that ``PROFILED`` names for the path must appear in the
    trace, and none that ``UNPROFILED`` names."""
    from chgnet_tpu_torch.models import CHGNet

    kwargs, switch, _ = PATHS[path]
    model = CHGNet(seed=0, device="cuda", **kwargs)
    with env_switch(switch):
        profile_call(f"profile {path}", "pass", lambda: run_pass(model, batch),
                     PROFILED[path], UNPROFILED.get(path, ()))


def profile_call(label, what, fn, need=(), banned=()):
    """One call of ``fn`` (after one untraced call) under torch.profiler:
    device time by kernel and the device's busy share of the call's wall
    time. Each name in ``need`` must appear in the trace, none in
    ``banned``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms <= 0:
        log(f"{label}: the profiler recorded no device time (not measured)")
        return
    missing = [k for k in need if not any(k in e.key for e in events)]
    if missing:
        raise AssertionError(f"{label}: no device time of {missing}")
    found = [k for k in banned if any(k in e.key for e in events)]
    if found:
        raise AssertionError(f"{label}: device time of {found}")
    log(f"{label}: one traced {what} {wall_ms:.3f} ms wall, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(events)} "
        "kernel names; top by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
            f"{e.key[:110]}")


def _bounds(name, args_list):
    """Bounds of a kernel's calls: (ms by what bounds each call, bytes,
    product FLOPs, elementwise FLOPs, library callables)."""
    bound = {"bytes": 0.0, "operations": 0.0}
    totals = [0, 0, 0]
    libs = []
    for args in args_list:
        b, products, ops, lib = bound_and_library(name, args)
        for i, v in enumerate((b, products, ops)):
            totals[i] += v
        libs.append(lib)
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = _ops_ms((products, ops), product_rate(name, args))
        if t_bytes >= t_ops:
            bound["bytes"] += t_bytes
        else:
            bound["operations"] += t_ops
    return bound, *totals, libs


def _bound_text(bound, nbytes, products, ops):
    return (f"bound {bound['bytes'] + bound['operations']:.4f}: "
            f"{bound['bytes']:.4f} in calls bound by bytes, "
            f"{bound['operations']:.4f} by operations; {nbytes} B, "
            f"{products} product FLOP, {ops} elementwise FLOP")


def log_gproj_routes(args_list) -> None:
    """gather_project_sum's calls timed and bounded per route."""
    from chgnet_tpu_torch.ops import gproj

    routes = {}
    for args in args_list:
        tables, _, _, stream = args
        route = gproj.gproj_route(len(tables), tables[0].shape[0], stream.shape[1],
                                  stream.element_size())
        routes.setdefault(route, []).append(args)
    for route, group in sorted(routes.items()):
        ms = cuda_ms(
            lambda: [gproj.gather_project_sum_kernel(*a) for a in group],
            TIMED_REPEATS,
        )
        bound, nbytes, products, ops, _ = _bounds("gather_project_sum", group)
        shapes = sorted({(len(a[0]), a[0][0].shape[0], a[3].shape[0]) for a in group})
        log(f"time gather_project_sum route {route}: {ms:.4f} ms over {len(group)} "
            f"calls (pairs, S, L) {shapes}, "
            f"{_bound_text(bound, nbytes, products, ops)}")


def pass_forms(name, kern, args_list) -> dict:
    """The one-kernel pass's calls timed and bounded per form: the message
    form (with its second layer) and the update form (``weights`` None)."""
    forms = {}
    for form in ("message", "update"):
        group = [a for a in args_list if (a[5] is not None) == (form == "message")]
        if not group:
            continue
        ms = cuda_ms(lambda: [kern(*a) for a in group], TIMED_REPEATS)
        bound, nbytes, products, ops, _ = _bounds(name, group)
        forms[form] = dict(calls=len(group), ms=ms,
                           bound_ms=bound["bytes"] + bound["operations"],
                           bound_by=max(bound, key=bound.get))
        log(f"time {name} form {form}: {ms:.4f} ms over {len(group)} calls, "
            f"{_bound_text(bound, nbytes, products, ops)}")
    return forms


def timing_row(name, args_list, path, launches, err, dtype="f32") -> dict:
    """One row of the kernels line: the kernel's time over ``args_list``
    (the calls of one pass of ``path``), its plain version's and a library
    call's, its bound, its ``launches`` in that pass and its ``err``."""
    kern, plain = kernel_versions()[name]
    bound, nbytes, products, ops, libs = _bounds(name, args_list)
    label = name if dtype == "f32" else f"{name} {dtype}"
    row = dict(
        name=label,
        route="cuda",
        dtype=dtype,
        source=KERNELS[name]["source"],
        replaces=KERNELS[name]["replaces"],
        path=path,
        launches=launches,
        max_abs_err=err,
        ms=cuda_ms(lambda: [kern(*a) for a in args_list], TIMED_REPEATS),
        plain_ms=cuda_ms(lambda: [plain(*a) for a in args_list], 1, warm_up=False),
        bound_ms=bound["bytes"] + bound["operations"],
        bound_by=max(bound, key=bound.get),
        library_ms=None if libs[0] is None else cuda_ms(
            lambda: [lib() for lib in libs], TIMED_REPEATS
        ),
    )
    lib_ms = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    log(f"time {label}: {row['ms']:.4f} ms over {len(args_list)} calls "
        f"(plain {row['plain_ms']:.4f}, library {lib_ms}, "
        f"{_bound_text(bound, nbytes, products, ops)})")
    if name == "gather_project_sum":
        log_gproj_routes(args_list)
    if name == "segment_sum_pair":  # each pair of streams once
        for args in {(a[1].data_ptr(), a[3].data_ptr()): a for a in args_list}.values():
            log(f"window {label} n_out={args[1].shape[0] - 1}: "
                f"{json.dumps(pair_windows(args, PAIR_BLOCK_ROWS))}")
    if name.startswith("fused_pass"):
        row["forms"] = pass_forms(name, kern, args_list)
    return row


def phase_timing(calls, launches, bf16_launches, errors, bf16_calls):
    """The kernels line: per kernel, totals over the calls of one pass of
    its path; ``launches[path]`` are that path's counts. Rows 1-9 also in
    bf16: totals over the bf16 calls of one pass of the path
    ``bf16_calls[name]`` names (``launches`` is every launch of the
    wrapper in the counted pass of that path, ``bf16_launches`` those with
    bf16 arguments, ``bf16_launches[path]``)."""
    rows = []
    for name, (kern, _) in kernel_versions().items():
        path = KERNELS[name]["path"]
        rows.append(timing_row(name, calls[name], path,
                               launches[path][kern.__name__], errors[name]))
    for name, (path, args_list) in bf16_calls.items():
        kern = kernel_versions()[name][0]
        row = timing_row(name, args_list, path, launches[path][kern.__name__],
                         errors[f"{name} bf16"], "bf16")
        row["bf16_launches"] = bf16_launches[path][kern.__name__]
        rows.append(row)
    return rows


# the simulation phase: NVT MD at full width on tools/bench_md.py's workload
# (the (16, 10, 8) LiMnO2 supercell, 10,240 atoms, spatially sorted; 300 K
# from 300 K, 1 fs, seed 0, skin 0.15), and FIRE over the first 8 of
# bench.py's perturbed 216-atom supercells in one padded batch
SIM_MD_SCALE = (16, 10, 8)
SIM_MD_SKIN = 0.15
SIM_MD_STEPS = 50
# the bf16 run's timed steps, fewer than the f32 run's to keep the script
# under 450 s with the switched bf16 paths: MD at this size is bound by the
# host's rebuilds (PERF.md section 5), whose rate 20 steps already show
SIM_MD_STEPS_BF16 = 20
SIM_RELAX_STRUCTS = 8
SIM_RELAX_STEPS = 50
SIM_RELAX_FMAX = 0.01  # eV/A: the seed-0 model's forces there are ~0.08
SIM_RELAXERS = ("LBFGS", "LBFGSLineSearch", "BFGS", "BFGSLineSearch")
SIM_RELAXERS_STEPS = 30
SIM_SCIPY_STEPS = 30
DIST_ATOL = 1e-10  # A: the two graph builders' distances
GOLDEN_RTOL = 2e-3
SIM_E_TOL = 2e-5  # eV/atom
SIM_F_TOL = 5e-5  # eV/A


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


def check_launched(label, launches, counts) -> None:
    """Every kernel with a count in ``counts`` (the order of ``KERNELS``)
    launched at least once, and no other."""
    from chgnet_tpu_torch import ops

    wrong = [n for n, fn, c in zip(KERNELS, ops.KERNELS, counts)
             if bool(launches[fn.__name__]) != bool(c)]
    if wrong:
        raise AssertionError(f"{label}: launched against the expected set: {wrong}")


def phase_goldens():
    """(a) The pinned seed-0 traces on the card (``GOLDEN_MD``,
    ``GOLDEN_FIRE``): the SMALL model on LiMnO2, each MD ensemble 10 runs of
    3 steps, FIRE 25 steps from ``perturb(0.1, seed=3)``, at rtol 2e-3."""
    from chgnet_tpu_torch import ROOT
    from chgnet_tpu_torch.core.structure import Structure
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.simulation import MolecularDynamics, StructOptimizer

    model = CHGNet(seed=0, device="cuda", **GOLDEN_SMALL)
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    failed = []
    for (ensemble, thermostat), (want_e, want_t) in GOLDEN_MD.items():
        t0 = time.perf_counter()
        md = MolecularDynamics(
            struct, model=model, ensemble=ensemble, thermostat=thermostat,
            temperature=300.0, starting_temperature=300.0, timestep=2.0,
            taut=50.0, taup=200.0, pressure=0.0, bulk_modulus=100.0, seed=0,
        )
        es, ts = [], []
        for _ in range(10):
            md.run(3)
            es.append(float(md.state.epot[0]))
            ts.append(float(md.get_temperature()))
        err = max(_rel_err(es, want_e), _rel_err(ts, want_t))
        log(f"golden MD {ensemble} {thermostat}: 10 x run(3), max relative err "
            f"{err:.3e} (rtol {GOLDEN_RTOL:g}), {md.runtime.n_rebuilds} rebuilds, "
            f"{time.perf_counter() - t0:.1f} s")
        if not err <= GOLDEN_RTOL:
            failed.append(f"MD {ensemble} {thermostat}")
    res = StructOptimizer(model=model, optimizer_class="FIRE").relax(
        struct.perturb(0.1, seed=3), fmax=0.01, steps=25, relax_cell=True,
        assign_magmoms=False,
    )
    err = _rel_err(res["trajectory"].energies[:25], GOLDEN_FIRE)
    log(f"golden FIRE: 25 steps, max relative err {err:.3e} (rtol {GOLDEN_RTOL:g})")
    if not err <= GOLDEN_RTOL:
        failed.append("FIRE")
    if failed:
        raise AssertionError(f"golden traces off on the card: {failed}")


def phase_sim_md(model_kw=None):
    """(b) NVT MD at full width, 10,240 atoms: one chunk to warm up, then
    ``SIM_MD_STEPS`` steps (bf16: ``SIM_MD_STEPS_BF16``) between a reset and
    a read of the launch counts
    (every kernel of the default path must launch, no other); steps/s, the
    rebuild stats over those steps, peak device memory above what was
    allocated before; the final state against a fresh exact-cutoff
    ``predict_structure``; every kernel call of one MD step against its
    plain version; one traced step. With ``model_kw`` (``BF16_PATHS_KW``:
    tools/bench_md.py's configuration for systems over 2,000 atoms, bf16
    and "default") the same run of that model, its launches with bf16
    arguments checked as phase_model checks them, the final state at
    ``BF16_BARS`` and no trace. Returns (launches, those with bf16
    arguments, errors)."""
    from chgnet_tpu_torch import ROOT, ops
    from chgnet_tpu_torch.core.structure import Structure
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.simulation import MolecularDynamics, units
    from chgnet_tpu_torch.simulation.md import md_chunk
    from chgnet_tpu_torch.simulation.runtime import (
        apply_dynamic_cutoff, compute_batch_dynamic,
    )

    model_kw = model_kw or {}
    tag = "sim MD" + (" bf16" if model_kw else "")
    n_steps = SIM_MD_STEPS_BF16 if model_kw else SIM_MD_STEPS
    e_tol, f_tol = (BF16_BARS["e"], BF16_BARS["f"]) if model_kw else (SIM_E_TOL, SIM_F_TOL)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = CHGNet(seed=0, device="cuda", **model_kw)
    struct = Structure.from_file(
        f"{ROOT}/examples/mp-18767-LiMnO2.cif").make_supercell(SIM_MD_SCALE).spatial_sort()
    n_atoms = len(struct)
    t0 = time.perf_counter()
    md = MolecularDynamics(
        struct, model=model, ensemble="nvt", thermostat="Berendsen",
        temperature=300.0, starting_temperature=300.0, timestep=1.0, seed=0,
        skin=SIM_MD_SKIN,
    )
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    md.run(1)  # one chunk: the Verlet budget caps a chunk at 1 step here
    warm_s = time.perf_counter() - t0
    rt = md.runtime
    stats0, rebuilds0 = dict(rt.stats), rt.n_rebuilds
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    md.run(n_steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, bf16_launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    stats = {k: rt.stats[k] - stats0[k] for k in rt.stats}
    batch = rt.batch
    live = apply_dynamic_cutoff(
        batch._replace(frac_coords=md.state.frac, lattices=md.state.lat), model.config)
    log(f"{tag}: {n_atoms} atoms, NVT Berendsen 300 K, 1 fs, skin {SIM_MD_SKIN}, "
        f"graphs by the {rt.converter.algorithm!r} builder: "
        f"capacities N={batch.atomic_numbers.shape[0]} E={batch.atom_graph.shape[0]} "
        f"A={batch.bond_graph.shape[0]}; rows valid in the plans E "
        f"{int(batch.edge_mask.sum())} A {int(batch.angle_mask.sum())}, kept by the "
        f"dynamic cutoff E {int(live.edge_mask.sum())} A {int(live.angle_mask.sum())}")
    log(f"{tag}: set-up {setup_s:.2f} s, warm-up chunk {warm_s:.2f} s; "
        f"{n_steps} steps in {wall_s:.3f} s = {n_steps / wall_s:.4f} steps/s; "
        f"{rt.n_rebuilds - rebuilds0} rebuilds; stats over the steps "
        + json.dumps({k: round(v, 3) for k, v in stats.items()})
        + f"; peak device memory {peak / 2**30:.3f} GiB above the "
        f"{base_bytes / 2**30:.3f} GiB allocated before ({card_line()})")
    log(f"{tag}: stall_s {stats['stall_s'] / wall_s:.1%} of the wall")
    log(f"{tag} launches over {n_steps} steps:", launches)
    check_launched(tag, launches, PATHS["default"][2])
    check_bf16_launches(tag, launches, bf16_launches, bool(model_kw))

    final = md.atoms
    pred = model.predict_structure(final, task="ef")
    e_state = float(md.state.epot[0]) / n_atoms
    f_state = (md.state.accel * md.masses[:, None]
               * units.AMU_A2_FS2_TO_EV)[:n_atoms].cpu().numpy()
    e_err = abs(pred["e"] - e_state)
    f_err = float(np.abs(pred["f"] - f_state).max())
    log(f"{tag} final state vs a fresh exact-cutoff predict_structure: e err "
        f"{e_err:.3e} eV/atom (tol {e_tol:g}), f err {f_err:.3e} eV/A "
        f"(tol {f_tol:g}); e = {e_state:.6f} eV/atom, T = "
        f"{md.get_temperature():.2f} K")
    if not (e_err <= e_tol and f_err <= f_tol):
        raise AssertionError(f"{tag}: the skin state disagrees with the exact graph")

    step_batch = batch._replace(frac_coords=md.state.frac, lattices=md.state.lat)
    with Recorder() as rec:
        compute_batch_dynamic(model.params, step_batch, config=model.config,
                              compute_stress=False, compute_magmom=False)
    torch.cuda.synchronize()
    with torch.no_grad():
        errors = phase_kernels(tag + " step", rec.calls, PATHS["default"][2])
    del rec
    if model_kw:
        return launches, bf16_launches, errors

    def one_step():
        md_chunk(model.params, batch, md.state, md.md_params, md.masses, md.dof,
                 config=model.config, ensemble="nvt", thermostat="Berendsen",
                 n_steps=1, record=False)

    profile_call(f"profile MD step ({n_atoms} atoms)", "MD step", one_step,
                 PROFILED["default"])
    return launches, bf16_launches, errors


def relax_structs():
    """(c)'s batch: the first ``SIM_RELAX_STRUCTS`` of bench.py's perturbed
    216-atom supercells."""
    return bench_structs(SIM_RELAX_STRUCTS)


def run_relaxer(model, name, structs, steps, e_tol=SIM_E_TOL) -> float:
    """Relax ``structs`` in one batch with the cell free; log steps/s, and
    hold each ``final_energy`` (the last evaluated state's, one move before
    ``final_structure``) against a fresh ``predict_structure`` of the
    trajectory's last frame at ``SIM_E_TOL``, the energy falling. Returns
    the wall seconds a step."""
    from chgnet_tpu_torch.core.structure import Structure
    from chgnet_tpu_torch.simulation import StructOptimizer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = StructOptimizer(model, optimizer_class=name).relax(
        structs, fmax=SIM_RELAX_FMAX, steps=steps, relax_cell=True,
        assign_magmoms=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    n_steps = len(results[0]["trajectory"])
    tag = name + (" bf16" if model.config.compute_dtype == "bfloat16" else "")
    log(f"sim relax: {tag}, {len(structs)} x {len(structs[0])} atoms in one batch, "
        f"relax_cell, fmax {SIM_RELAX_FMAX:g}, {n_steps} steps in {wall_s:.3f} s (first graph build "
        f"included) = {n_steps / wall_s:.4f} steps/s ({card_line()})")
    frames = [
        Structure(r["trajectory"].cells[-1], s.atomic_numbers.tolist(),
                  r["trajectory"].atom_positions[-1], coords_are_cartesian=True)
        for r, s in zip(results, structs)
    ]
    preds = model.predict_structure(frames, task="e")
    worst, failed = 0.0, []
    for i, (r, p, s) in enumerate(zip(results, preds, structs)):
        err = abs(p["e"] * len(s) - r["final_energy"])
        worst = max(worst, err / len(s))
        if not (err <= e_tol * len(s)
                and r["final_energy"] < r["trajectory"].energies[0]):
            failed.append(i)
    log(f"sim relax: {tag}: final_energy vs predict_structure of the last frame: max err "
        f"{worst:.3e} eV/atom (tol {e_tol:g}); energy per atom "
        + ", ".join(f"{r['trajectory'].energies[0] / len(s):.7f} -> "
                    f"{r['final_energy'] / len(s):.7f}"
                    for r, s in zip(results, structs)))
    if failed:
        raise AssertionError(f"sim relax: {tag}: structures {failed} off or not falling")
    return wall_s / n_steps


def phase_sim_relax():
    """(c) FIRE with the cell free over ``SIM_RELAX_STRUCTS`` of bench.py's
    perturbed 216-atom supercells in one padded batch, ``SIM_RELAX_STEPS``
    steps: steps/s; each result's ``final_energy`` (the last evaluated
    state's, one move before ``final_structure``) against a fresh
    ``predict_structure`` of the trajectory's last frame; the energy falls.
    (d) ``CHGNetCalculator`` against ``predict_structure``, exactly."""
    from chgnet_tpu_torch import ROOT
    from chgnet_tpu_torch.core.structure import Structure
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.simulation import CHGNetCalculator

    model = CHGNet(seed=0, device="cuda")
    run_relaxer(model, "FIRE", relax_structs(), SIM_RELAX_STEPS)
    run_relaxer(CHGNet(seed=0, device="cuda", **BF16_PATHS_KW), "FIRE",
                relax_structs(), SIM_RELAX_STEPS, BF16_BARS["e"])

    base = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    calc = CHGNetCalculator(model)
    calc.calculate(base)
    pred = model.predict_structure(base, task="efsm")
    same = (
        calc.results["energy"] == pred["e"] * len(base)
        and np.array_equal(calc.results["forces"], pred["f"])
        and np.array_equal(calc.results["stress"], pred["s"] * calc.stress_weight)
        and np.array_equal(calc.results["magmoms"], pred["m"])
    )
    log(f"sim calculator: CHGNetCalculator(model).calculate == predict_structure "
        f"exactly: {same}")
    if not same:
        raise AssertionError("sim calculator: results differ from predict_structure")


def phase_sim_host():
    """(e) The host stack on the MD workload's structure at the MD cutoffs:
    the C++ builder and the numpy builder (neighbor list and topology) once
    each, their arrays equal; ``batch_graphs`` with the host ops and
    without them, equal; the two host libraries' g++ builds in a fresh
    directory."""
    import shutil
    import tempfile

    from chgnet_tpu_torch import ROOT
    from chgnet_tpu_torch.core.structure import Structure
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.graph.builder import build_graph_arrays
    from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
    from chgnet_tpu_torch.graph.fast import fast_graph
    from chgnet_tpu_torch.graph.neighbors import get_neighbor_list
    from chgnet_tpu_torch.models import CHGNetConfig
    from chgnet_tpu_torch.utils.native import build as native_build
    from chgnet_tpu_torch.utils.native import hostops

    cfg = CHGNetConfig()
    r_atom = cfg.atom_graph_cutoff + SIM_MD_SKIN
    r_bond = cfg.bond_graph_cutoff + SIM_MD_SKIN
    struct = Structure.from_file(
        f"{ROOT}/examples/mp-18767-LiMnO2.cif").make_supercell(SIM_MD_SCALE).spatial_sort()
    times = {}
    t0 = time.perf_counter()
    fast = fast_graph.build(struct, r_atom, r_bond)
    times["fast"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = build_graph_arrays(len(struct), *get_neighbor_list(struct, r=r_atom), r_bond)
    times["numpy"] = time.perf_counter() - t0
    same = all(
        np.array_equal(getattr(fast, f), getattr(ref, f))
        for f in ("atom_graph", "neighbor_image", "directed2undirected",
                  "undirected2directed", "bond_graph")
    )
    dist_err = float(np.abs(fast.distances - ref.distances).max())
    graph = CrystalGraphConverter(atom_graph_cutoff=r_atom, bond_graph_cutoff=r_bond)(struct)
    t0 = time.perf_counter()
    batch = batch_graphs([graph])
    times["batch"] = time.perf_counter() - t0
    with env_switch("CHGNET_TPU_NO_HOSTOPS"):
        t0 = time.perf_counter()
        batch_plain = batch_graphs([graph])
        times["batch_numpy"] = time.perf_counter() - t0
    same_batch = all(
        all(np.array_equal(a, b) for a, b in zip(x, y)) if f.startswith("plan_")
        else np.array_equal(x, y)
        for f, x, y in zip(batch._fields, batch, batch_plain)
    )
    tmp = tempfile.mkdtemp(dir=os.path.dirname(native_build.HOST_DIR))
    try:
        for name, source in (("fast_graph", fast_graph.SOURCE), ("hostops", hostops.SOURCE)):
            t0 = time.perf_counter()
            native_build.build(source, tmp)
            times[name] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    log(f"sim host: {len(struct)} atoms at {r_atom:g} / {r_bond:g} A: "
        f"{fast.n_directed} directed edges, {fast.n_angles} angles; C++ builder "
        f"{times['fast']:.3f} s, numpy builder {times['numpy']:.3f} s, arrays equal: "
        f"{same}, distances max err {dist_err:.3e} A (tol {DIST_ATOL:g}); "
        f"batch_graphs {times['batch']:.3f} s with the host ops, "
        f"{times['batch_numpy']:.3f} s without, equal: {same_batch}; g++ builds "
        f"fast_graph {times['fast_graph']:.2f} s, hostops {times['hostops']:.2f} s "
        f"({os.cpu_count()} host cores)")
    if not (same and same_batch and dist_err <= DIST_ATOL):
        raise AssertionError("sim host: the native host stack disagrees with numpy")


def phase_sim_relaxers():
    """(f) LBFGS, LBFGSLineSearch, BFGS and BFGSLineSearch over (c)'s batch,
    ``SIM_RELAXERS_STEPS`` steps each (``run_relaxer``); for BFGS the share
    of a step's wall time that one ``eigh`` of a [8, D, D] f32 Hessian like
    its own (70 I plus a rank-30 term, D = 3 * 216 + 9) takes, by CUDA
    events; then SciPyFminCG on one 216-atom supercell, the energy
    falling."""
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.simulation import StructOptimizer

    model = CHGNet(seed=0, device="cuda")
    structs = relax_structs()
    dof = 3 * len(structs[0]) + 9
    gen = torch.Generator(device="cuda").manual_seed(0)
    low = torch.randn((len(structs), dof, 30), device="cuda", generator=gen)
    hessian = 70.0 * torch.eye(dof, device="cuda") + 0.1 * low @ low.transpose(1, 2)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(hessian), 5)
    log(f"sim relax: torch.linalg.eigh of [{len(structs)}, {dof}, {dof}] f32: "
        f"{eigh_ms:.3f} ms ({card_line()})")
    for name in SIM_RELAXERS:
        step_s = run_relaxer(model, name, structs, SIM_RELAXERS_STEPS)
        if name.startswith("BFGS"):
            log(f"sim relax: {name}: eigh {eigh_ms:.3f} ms of {step_s * 1e3:.3f} ms "
                f"a step ({eigh_ms / (step_s * 1e3):.1%})")
    struct = structs[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = StructOptimizer(model, optimizer_class="SciPyFminCG").relax(
        struct, fmax=SIM_RELAX_FMAX, steps=SIM_SCIPY_STEPS, relax_cell=True,
        assign_magmoms=False)
    wall_s = time.perf_counter() - t0
    energies = res["trajectory"].energies
    log(f"sim relax: SciPyFminCG, {len(struct)} atoms, {SIM_SCIPY_STEPS} iterations at "
        f"most: {len(energies)} evaluations in {wall_s:.3f} s = "
        f"{len(energies) / wall_s:.4f} evaluations/s; energy per atom "
        f"{energies[0] / len(struct):.7f} -> {res['final_energy'] / len(struct):.7f}")
    if not res["final_energy"] < energies[0]:
        raise AssertionError("sim relax: SciPyFminCG did not lower the energy")


# phase 7: fine-tuning on the card. bench.py's 32 supercells labelled
# E+F+S+M by a seed-7 teacher on the card (stress in the dataset's VASP
# convention), a NaN energy, force block and magmom block among them as in
# tests/test_trainer.py; split 24 / 4 / 4 into batches of 8 (3 train steps an
# epoch at 1,728 atoms); CHGNet(seed=0) trained on them, Adam, CosLR, MSE
# the phase's size, model keywords (none: the default, full width) and
# device; a narrow model, a few structures and the CPU rehearse it off the
# card, every kernel by its plain version
TRAIN_STRUCTS = N_STRUCTS
TRAIN_MODEL: dict = {}
TRAIN_DEVICE = "cuda"
TRAIN_BATCH = 8
TRAIN_RATIOS = (0.75, 0.125)
TRAIN_EPOCHS = 2
TRAIN_LR = 1e-3
TRAIN_TEACHER_SEED = 7
# the CPU hold: the first train steps on the card against the port's CPU run
# from the same init, on a loader cut to 4 structures in batches of 2 (the
# width stays full; a full-width CPU step at 8 x 216 atoms takes minutes)
TRAIN_HOLD_STRUCTS, TRAIN_HOLD_BATCH = 4, 2
# the hold's bars by dtype: (losses, relative; the element gap that at most
# 1% of the parameters may exceed; each leaf's Adam first moments after the
# steps, relative to the leaf's largest). Adam's step hides a gradient's
# scale (an element moves by about lr whatever its gradient), its first
# moments (0.09 g1 + 0.1 g2 after two steps) do not. bf16 on the card
# against bf16 on the CPU rounds in other orders (kernels against the plain
# versions, cuBLAS against the CPU's GEMMs), as the port's bf16 steps
# against chgnet_tpu's do: tests/test_torch_port_bf16_switches.py's bars
TRAIN_HOLD_BARS = {"f32": (1e-4, 1e-5, 1e-2), "bf16": (5e-3, 1e-4, 5e-2)}
# the bf16 hold's model: the production bf16 conv stack and kernels with
# matmul_precision "highest", so that the card's plain GEMMs do what the
# CPU's do. Under "default" the card's f32 GEMMs take TF32 and its bf16
# GEMMs reduce in bf16, which the CPU does not: its first step's parameter
# gradients lay twice as far from f32's as the CPU's bf16 ones (median over
# leaves 1.4e-2 against 7.6e-3 of each leaf's largest), against 2.6e-3
# between card and CPU under "highest" (scripts/bf16_train_gradient_gap.py,
# NVIDIA H100 80GB HBM3, 700.00 W).
# matmul_precision sets no kernel's arithmetic: the kernels are those of
# "default"
BF16_HOLD_KW = dict(compute_dtype="bfloat16", matmul_precision="highest")
# the bf16 run's step losses over its first epoch against the f32 run's,
# relative. The MSE loss moves by 2 mean((y - label) dy) for an output gap
# dy, relatively by about 2 |dy| / |y - label|: the forces carry most of it,
# their bf16 gap (6.8e-4 eV/A on the benchmark batch, PERF.md) against a
# residual of a few 1e-2 eV/A before training, 3-7%; a narrow model on the
# CPU showed 3.6e-2 over its first 3 steps
TRAIN_BF16_LOSS_RTOL = 0.1
# matmul_precision="high" against "highest": each output's largest error
# over its largest value. TF32 products keep 10 mantissa bits (a relative
# rounding of 2^-11, 4.9e-4); forces and stress are sums of per-edge terms
# tens of times larger than themselves, so their error relative to their
# largest value is that rounding times the cancellation
TF32_TOL = 5e-2
TRAIN_DIR = os.path.join(os.path.dirname(LOG_PATH), "chip_smoke_train")
# the launch sets of one train step, in the order of KERNELS: the default
# path's; under the one-kernel pass also row 5, whose gather_sum carries the
# pass's second order (the plain composition it differentiates,
# ops/fused_pass.py _FusedPassGrads.backward)
TRAIN_LAUNCH_SETS = {
    "default": PATHS["default"][2],
    "CHGNET_TPU_FUSED_PASS=1": tuple(
        c or name == "gather_sum_rows"
        for name, c in zip(KERNELS, PATHS["CHGNET_TPU_FUSED_PASS=1"][2])),
}
# the kernels whose backward has a parameter-gradient form, and the index of
# its need_params flag among their arguments
PARAM_FORM = {"gated_message_bwd": -1, "gated_update_bwd": -1, "fused_pass_bwd": 9}


def train_data():
    """The phase's dataset and its train / val / test loaders."""
    from chgnet_tpu_torch.data import StructureData, get_train_val_test_loader
    from chgnet_tpu_torch.models import CHGNet

    t0 = time.perf_counter()
    teacher = CHGNet(seed=TRAIN_TEACHER_SEED, device=TRAIN_DEVICE, **TRAIN_MODEL)
    structs = bench_structs(TRAIN_STRUCTS)
    preds = teacher.predict_structure(structs, task="efsm", batch_size=TRAIN_BATCH)
    energies = [float(p["e"]) for p in preds]
    forces = [np.asarray(p["f"], np.float32) for p in preds]
    stresses = [np.asarray(p["s"], np.float32) * -10.0 for p in preds]
    magmoms = [np.asarray(p["m"], np.float32) for p in preds]
    energies[2] = np.nan
    forces[4] = np.full_like(forces[4], np.nan)
    magmoms[6] = np.full_like(magmoms[6], np.nan)
    data = StructureData(structures=structs, energies=energies, forces=forces,
                         stresses=stresses, magmoms=magmoms, shuffle=False)
    loaders = get_train_val_test_loader(
        data, batch_size=TRAIN_BATCH, train_ratio=TRAIN_RATIOS[0],
        val_ratio=TRAIN_RATIOS[1])
    log(f"train data: {len(structs)} x {len(structs[0])} atoms labelled by "
        f"CHGNet(seed={TRAIN_TEACHER_SEED}) on the card in "
        f"{time.perf_counter() - t0:.1f} s; splits "
        + ", ".join(str(len(ld.indices)) for ld in loaders)
        + f", batches of {TRAIN_BATCH}")
    return data, loaders


def make_trainer(device, cls=None, **model_kw):
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.trainer import Trainer

    cls = cls or Trainer
    model = CHGNet(seed=0, device=device, **TRAIN_MODEL, **model_kw)
    return cls(model=model, targets="efsm",
               optimizer="Adam", scheduler="CosLR", criterion="MSE",
               learning_rate=TRAIN_LR, epochs=TRAIN_EPOCHS, use_device=device,
               print_freq=1)


def _step(trainer, batch, targets):
    """One train step; its metrics read back (the step's one host sync)."""
    return trainer._read_metrics(trainer.train_step(*trainer._on_device(batch, targets)))


def train_launches(trainer, batch, targets):
    """The launches of one train step, and those with bf16 arguments, by
    kernel wrapper name."""
    from chgnet_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _step(trainer, batch, targets)
    torch.cuda.synchronize()
    return read_launches()


def record_train_step(label, trainer, batch, targets, counts, held=None):
    """Every kernel call of one train step (forward, force backward,
    parameter backward) held against its plain version; the launch set of a
    second step must be that of ``counts`` (the order of ``KERNELS``), no
    other, and its launches with bf16 arguments those of a bf16 run for a
    bf16 model (``check_bf16_launches``), none else. With ``held`` (the bf16
    steps) only the bf16 calls ``new_bf16_call`` names and calls of a
    signature not held before are held (``phase_kernels``). Returns (calls,
    errors, launches, those with bf16 arguments)."""
    with Recorder() as rec:
        metrics = _step(trainer, batch, targets)
    torch.cuda.synchronize()
    with torch.no_grad():
        errors = phase_kernels(label, rec.calls, counts, held, skip=held is not None)
    launches, bf16_launches = train_launches(trainer, batch, targets)
    log(f"{label}: launches in one train step:", launches)
    check_launched(label, launches, counts)
    check_bf16_launches(label, launches, bf16_launches,
                        trainer.model.config.compute_dtype == "bfloat16")
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"{label}: non-finite loss")
    return rec.calls, errors, launches, bf16_launches


def train_forms(name, kern, plain, args_list) -> dict:
    """A backward's calls timed and bounded by form: with parameter
    gradients and without (``PARAM_FORM``)."""
    forms = {}
    flag = PARAM_FORM[name]
    for form in ("params", "serving"):
        group = [a for a in args_list if bool(a[flag]) == (form == "params")]
        if not group:
            continue
        ms = cuda_ms(lambda: [kern(*a) for a in group], TIMED_REPEATS)
        plain_ms = cuda_ms(lambda: [plain(*a) for a in group], 1, warm_up=False)
        bound, nbytes, products, ops, _ = _bounds(name, group)
        forms[form] = dict(calls=len(group), ms=ms, plain_ms=plain_ms,
                           bound_ms=bound["bytes"] + bound["operations"],
                           bound_by=max(bound, key=bound.get), library_ms=None)
        log(f"time train {name} form {form}: {ms:.4f} ms over {len(group)} calls "
            f"(plain {plain_ms:.4f}, library none, "
            f"{_bound_text(bound, nbytes, products, ops)})")
    return forms


def train_timing(label, calls, dtype=torch.float32, names=None) -> dict:
    """Per kernel of a recorded train step (of ``names``, default all): its
    time summed over the step's calls of float type ``dtype``, and the
    parameter-gradient forms apart (rows 7, 9, 14)."""
    out = {}
    for name, (kern, plain) in kernel_versions().items():
        if names is not None and name not in names:
            continue
        args_list = [a for a in calls[name] if call_dtype(a) == dtype]
        if not args_list:
            continue
        ms = cuda_ms(lambda: [kern(*a) for a in args_list], TIMED_REPEATS)
        bound, nbytes, products, ops, _ = _bounds(name, args_list)
        log(f"time {label} {name}: {ms:.4f} ms over {len(args_list)} calls "
            f"({_bound_text(bound, nbytes, products, ops)})")
        out[name] = {"ms": ms}
        if name in PARAM_FORM:
            out[name]["forms"] = train_forms(name, kern, plain, args_list)
    return out


def phase_train_hold(data, loaders, **model_kw):
    """The first ``TRAIN_HOLD_STRUCTS // TRAIN_HOLD_BATCH`` train steps on
    the card against the port's CPU run of the same steps from the same
    init, in f32 or (``model_kw`` ``BF16_HOLD_KW``) bf16, at the dtype's
    ``TRAIN_HOLD_BARS``: losses; parameters after the last step at 2 x lr x
    steps (Adam moves a weight whose gradient is rounding noise by about lr
    either way) and nearly every element to the bar's gap; every leaf's
    Adam first moments."""
    from chgnet_tpu_torch.data import GraphLoader
    from chgnet_tpu_torch.models.convert import params_to_numpy
    from chgnet_tpu_torch.trainer.trainer import _leaves
    from chgnet_tpu_torch.utils.common import flatten_params

    tag = "train hold" + (" bf16" if model_kw else "")
    loss_tol, gap, mu_tol = TRAIN_HOLD_BARS["bf16" if model_kw else "f32"]
    hold = loaders[0].indices[:TRAIN_HOLD_STRUCTS]
    log(f"{tag}: cut to structures {hold.tolist()} of the train split in "
        f"batches of {TRAIN_HOLD_BATCH} (full width)")
    runs = {}
    for device in ("cpu", TRAIN_DEVICE):
        t0 = time.perf_counter()
        trainer = make_trainer(device, **model_kw)
        trainer._build_optimizer(False)
        loader = GraphLoader(data, indices=hold, batch_size=TRAIN_HOLD_BATCH,
                             shuffle=False)
        losses = [_step(trainer, b, t)["loss"] for b, t in loader]
        moments = {path: trainer.optimizer.state[leaf]["exp_avg"].cpu().numpy()
                   for path, leaf in _leaves(trainer.model.params)
                   if leaf in trainer.optimizer.state}
        runs[device] = (losses, flatten_params(params_to_numpy(trainer.model.params)),
                        moments)
        log(f"{tag} {device}: losses {losses} ({time.perf_counter() - t0:.1f} s)")
    (cpu_l, cpu_p, cpu_m), (card_l, card_p, card_m) = runs["cpu"], runs[TRAIN_DEVICE]
    loss_err = max(abs(a / b - 1) for a, b in zip(card_l, cpu_l))
    diffs = np.concatenate([np.abs(card_p[k] - cpu_p[k]).ravel() for k in cpu_p])
    bound = 2 * TRAIN_LR * len(cpu_l)
    frac = float((diffs > gap).mean())
    mu_err = {k: float(np.abs(card_m[k] - v).max() / max(np.abs(v).max(), 1e-30))
              for k, v in cpu_m.items() if np.abs(v).max() > 0 or np.abs(card_m[k]).max() > 0}
    worst = max(mu_err, key=mu_err.get)
    log(f"{tag}: card vs CPU, {len(cpu_l)} steps: losses relative err "
        f"{loss_err:.3e} (tol {loss_tol:g}); parameters max err "
        f"{diffs.max():.3e} (bound {bound:g}), {frac:.4%} of {diffs.size} over {gap:g} "
        f"(at most 1%); Adam first moments of {len(mu_err)} leaves moved, largest "
        f"relative err {mu_err[worst]:.3e} ({worst}; tol {mu_tol:g})")
    if not (loss_err <= loss_tol and diffs.max() <= bound and frac <= 0.01
            and set(card_m) == set(cpu_m) and mu_err[worst] <= mu_tol):
        raise AssertionError(f"{tag}: the card's steps disagree with the CPU's")


def phase_train_run(loaders, **model_kw):
    """``Trainer.train`` for ``TRAIN_EPOCHS`` epochs with checkpoints, each
    step timed by CUDA events; steps/s and structures/s over the last
    epoch; peak device memory; a resume from the last checkpoint that
    carries on one more step. ``model_kw``: the model's keywords
    (``BF16_KW`` for the bf16 run). Returns the trainer, whose ``steps``
    hold (epoch, start event, end event, loss) of every step."""
    from chgnet_tpu_torch.trainer import Trainer

    class TimedTrainer(Trainer):
        def train_step(self, batch, targets):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().train_step(batch, targets)
            end.record()
            epoch = len(self.training_history["e"]["train"])
            self.steps.append((epoch, start, end, out[0]))
            return out

    import shutil

    tag = "train run" + (" bf16" if model_kw else "")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    trainer = make_trainer(TRAIN_DEVICE, TimedTrainer, **model_kw)
    trainer.steps = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train(*loaders, save_dir=TRAIN_DIR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    last = [(s, e) for ep, s, e, _ in trainer.steps if ep == TRAIN_EPOCHS - 1]
    step_ms = [s.elapsed_time(e) for s, e in last]
    n_structs = TRAIN_BATCH * len(last)
    losses = {}
    for ep, *_, loss in trainer.steps:
        losses.setdefault(ep, []).append(float(loss))
    log(f"{tag}: {TRAIN_EPOCHS} epochs of {len(loaders[0])} steps in {wall:.2f} s "
        f"(validation, test and checkpoints included); epoch {TRAIN_EPOCHS}: steps "
        f"{', '.join(f'{ms:.3f}' for ms in step_ms)} ms by CUDA events = "
        f"{len(last) / sum(step_ms) * 1e3:.4f} train steps/s, "
        f"{n_structs / sum(step_ms) * 1e3:.4f} structures/s "
        f"({TRAIN_BATCH} x 216 atoms a step); peak device memory "
        f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB allocated before "
        f"({card_line()})")
    hist = trainer.training_history
    for ep in range(TRAIN_EPOCHS):
        log(f"{tag}: epoch {ep + 1}: step losses {losses.get(ep)}, MAE train "
            + json.dumps({k: hist[k]["train"][ep] for k in hist})
            + " val " + json.dumps({k: hist[k]["val"][ep] for k in hist}))
    log(f"{tag}: test MAE " + json.dumps({k: hist[k]["test"] for k in hist}))
    finite = all(np.isfinite(v) for vals in losses.values() for v in vals) and all(
        np.isfinite(hist[k][split]).all() for k in hist for split in ("train", "val", "test"))
    if not finite or len(hist["e"]["train"]) != TRAIN_EPOCHS:
        raise AssertionError(f"{tag}: a non-finite loss or MAE, or an early exit")
    files = sorted(os.listdir(TRAIN_DIR))
    log(f"{tag}: checkpoints {files}")
    ckpt = os.path.join(TRAIN_DIR, next(f for f in files if f.startswith("epoch")))
    if not (any(f.startswith("bestE_") for f in files)
            and any(f.startswith("bestF_") for f in files)):
        raise AssertionError(f"{tag}: bestE_ / bestF_ missing")
    restored = Trainer.load(ckpt, use_device=TRAIN_DEVICE)
    batch, targets = next(iter(loaders[0]))
    metrics = _step(restored, batch, targets)
    steps = {int(st["step"]) for st in restored.optimizer.state_dict()["state"].values()}
    log(f"{tag} resume: Trainer.load({os.path.basename(ckpt)}) at epoch "
        f"{restored.starting_epoch}, scheduler step {restored.scheduler_step}, "
        f"optimizer steps {steps}; one more step: loss {metrics['loss']:.6f}")
    if not (restored.starting_epoch == TRAIN_EPOCHS and np.isfinite(metrics["loss"])
            and steps == {TRAIN_EPOCHS * len(loaders[0]) + 1}
            and restored.model.config == trainer.model.config):
        raise AssertionError(f"{tag} resume: the restored trainer did not carry on")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return trainer


def phase_train():
    """Phase 7 (``chip_smoke.py`` docstring). Returns (launches of one
    default train step, per-kernel train times, errors), each for f32 and
    for bf16: ``{"f32": ..., "bf16": ...}``."""
    t_start = time.perf_counter()
    data, loaders = train_data()
    phase_train_hold(data, loaders)
    phase_train_hold(data, loaders, **BF16_HOLD_KW)
    batch, targets = next(iter(loaders[0]))
    launches, times, errors = {}, {}, {}

    # one step of the default path and one under the one-kernel pass, each in
    # f32 and in bf16 (the tails' and the pass's parameter-gradient forms)
    passes = ("fused_pass_fwd", "fused_pass_bwd")
    for dtype, kw in (("f32", {}), ("bf16", BF16_KW)):
        label = "train step" + ("" if dtype == "f32" else " bf16")
        torch_dtype = torch.bfloat16 if kw else torch.float32
        held = set() if kw else None  # the bf16 steps: what is new only
        trainer = make_trainer(TRAIN_DEVICE, **kw)
        trainer._build_optimizer(False)
        calls, errors[dtype], launches[dtype], _ = record_train_step(
            label, trainer, batch, targets, TRAIN_LAUNCH_SETS["default"], held)
        times[dtype] = train_timing(label, calls, torch_dtype)
        del calls
        with env_switch("CHGNET_TPU_FUSED_PASS"):
            fp = make_trainer(TRAIN_DEVICE, **kw)
            fp._build_optimizer(False)
            fp_label = f"{label} CHGNET_TPU_FUSED_PASS=1"
            fp_calls, fp_errors, fp_launches, _ = record_train_step(
                fp_label, fp, batch, targets,
                TRAIN_LAUNCH_SETS["CHGNET_TPU_FUSED_PASS=1"], held)
            # the pass's rows are timed on this step, every other row on the
            # default path's
            fp_times = train_timing(fp_label, fp_calls, torch_dtype, passes)
            del fp_calls, fp
        for name in passes:
            launches[dtype][name] = fp_launches[name]
            times[dtype][name] = fp_times[name]
        for name, err in fp_errors.items():
            errors[dtype][name] = max(err, errors[dtype].get(name, 0.0))
        if dtype == "f32":
            f32_trainer = trainer
        del trainer

    drop = make_trainer(TRAIN_DEVICE, conv_dropout=0.1)
    drop._build_optimizer(False)
    drop_launches, _ = train_launches(drop, batch, targets)
    drop_loss = _step(drop, batch, targets)["loss"]
    log(f"train step conv_dropout=0.1: launches {drop_launches}, loss {drop_loss:.6f}")
    check_launched("train step conv_dropout=0.1", drop_launches,
                   PATHS["fused_kernels=False"][2])
    if not np.isfinite(drop_loss):
        raise AssertionError("train step conv_dropout=0.1: non-finite loss")
    del drop

    phase_tf32(batch)
    profile_call("profile train step", "train step",
                 lambda: _step(f32_trainer, batch, targets),
                 ("tail_fwd_tc_kernel", "tail_bwd_kernel"))
    del f32_trainer
    torch.cuda.empty_cache()
    runs = {"f32": phase_train_run(loaders)}
    torch.cuda.empty_cache()
    runs["bf16"] = phase_train_run(loaders, **BF16_KW)
    # the bf16 run's step losses against the f32 run's, over the first epoch
    # (both from the same init on the same batches)
    first = {k: [float(loss) for ep, *_, loss in run.steps if ep == 0]
             for k, run in runs.items()}
    rel = max(abs(a / b - 1) for a, b in zip(first["bf16"], first["f32"]))
    log(f"train run bf16 vs f32: epoch 1 step losses {first['bf16']} against "
        f"{first['f32']}, largest relative gap {rel:.3e} (bar "
        f"{TRAIN_BF16_LOSS_RTOL:g})")
    if not rel <= TRAIN_BF16_LOSS_RTOL:
        raise AssertionError("train run bf16: its losses stray from f32's")
    del runs
    log(f"train phase: {time.perf_counter() - t_start:.0f} s")
    return launches, times, errors


def phase_tf32(host_batch):
    """One E+F+S+M pass of a train batch with ``matmul_precision="high"``
    against "highest": each output within ``TF32_TOL`` of its largest value;
    the two times side by side."""
    from chgnet_tpu_torch.models import CHGNet

    batch = host_batch.to(TRAIN_DEVICE)
    outs, times = {}, {}
    for precision in ("highest", "high"):
        model = CHGNet(seed=0, device=TRAIN_DEVICE, matmul_precision=precision,
                       **TRAIN_MODEL)
        outs[precision] = run_pass(model, batch)
        times[precision] = float(np.median(
            [cuda_ms(lambda: run_pass(model, batch), 1) for _ in range(MODEL_SAMPLES)]))
    pairs = {k: _errors(outs["high"][k], outs["highest"][k]) for k in "efsm"}
    errs = {k: rel for k, (_, rel) in pairs.items()}
    log("matmul_precision high vs highest on a train batch: max abs errors "
        + json.dumps({k: float(f"{a:.3e}") for k, (a, _) in pairs.items()})
        + " (eV/atom, eV/A, GPa, mu_B), over each output's largest value "
        + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
        + f" (tol {TF32_TOL:g}); E+F+S+M median {times['high']:.3f} ms high, "
        f"{times['highest']:.3f} ms highest ({card_line()})")
    if not all(v <= TF32_TOL for v in errs.values()):
        raise AssertionError("matmul_precision=high: outside TF32 tolerance")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    open(LOG_PATH, "w").close()
    t_start = time.perf_counter()
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.models import CHGNet

    phase_card_and_build()
    model = CHGNet(seed=0, device="cuda")
    log(f"model: {model.n_params:,} parameters, default width, "
        f"n_conv={model.config.n_conv}, fused_kernels="
        f"{model.config.fused_kernels}")
    t0 = time.perf_counter()
    graphs = bench_graphs(model.graph_converter)
    n_edges = sum(g.n_directed for g in graphs)
    batch = batch_graphs(graphs).to("cuda")
    log(f"benchmark batch: {len(graphs)} graphs, {n_edges} directed edges, "
        f"{sum(g.n_angles for g in graphs)} angles, "
        f"capacities N={batch.atomic_numbers.shape[0]} "
        f"E={batch.atom_graph.shape[0]} A={batch.bond_graph.shape[0]} "
        f"(host build {time.perf_counter() - t0:.1f} s)")
    # the stream-v2 paths' batch is built under their switch: only then do
    # the plans carry their gather windows
    with env_switch("CHGNET_TPU_STREAM_V2"):
        batch_v2 = batch_graphs(graphs).to("cuda")
    windows = {f: (tuple(getattr(batch_v2, f).window.shape),
                   getattr(batch_v2, f).window_rows)
               for f in batch_v2._fields if f.startswith("plan_")}
    log("window plans under CHGNET_TPU_STREAM_V2 ([blocks, 2] and the widest "
        "window's rows; (0,) and None absent):", windows)
    batches = {path: batch_v2 if switch == "CHGNET_TPU_STREAM_V2" else batch
               for path, (_, switch, _) in PATHS.items()}

    # every path records every kernel it runs and holds each call against
    # the plain version before the next path is recorded (NEW_BF16_PATHS:
    # only what no earlier path held); the calls a kernel's row is timed on
    # are those of its own path (KERNELS, BF16_ROW_PATH), and its error is
    # the largest over all paths
    t0 = time.perf_counter()
    calls, errors, bf16_calls, held = {}, {}, {}, set()
    for path, (kwargs, switch, _) in PATHS.items():
        t_path = time.perf_counter()
        with env_switch(switch), Recorder() as rec:
            run_pass(CHGNet(seed=0, device="cuda", **kwargs), batches[path])
        torch.cuda.synchronize()
        with torch.no_grad():
            found = phase_kernels(path, rec.calls, held=held,
                                  skip=path in NEW_BF16_PATHS)
        for name, err in found.items():
            errors[name] = max(err, errors.get(name, 0.0))
        calls.update({n: c for n, c in rec.calls.items() if KERNELS[n]["path"] == path})
        if path in BF16_PATHS:
            bf16_calls.update({
                n: (path, c) for n, c in bf16_calls_of(path, rec.calls).items()})
        del rec
        log(f"kernel phase {path}: {time.perf_counter() - t_path:.0f} s")
    check_autograd(batch)
    log(f"kernel phase: {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    launches, bf16_launches, outs = {}, {}, {}
    for path in PATHS:
        launches[path], bf16_launches[path], outs[path] = phase_model(
            path, batches[path], n_edges, graphs)
    for path in SWITCHED:
        check_same_outputs(path, outs[path], "default", outs["default"])
    for path, ref in BF16_PATHS.items():
        check_same_outputs(path, outs[path], ref, outs[ref], BF16_BARS)
    log(f"model phase: {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    with torch.no_grad():
        rows = phase_timing(calls, launches, bf16_launches, errors, bf16_calls)
    log(f"timing phase: {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    for path in PROFILED:
        profile_pass(path, batches[path])
    log(f"profile phase: {time.perf_counter() - t0:.0f} s")
    del calls, outs, batches, batch, batch_v2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"{label}: {time.perf_counter() - t:.0f} s")
        return out

    timed("sim goldens", phase_goldens)
    sim_launches, _, sim_errors = timed("sim MD f32", phase_sim_md)
    sim_launches_bf16, sim_bf16_launches, sim_errors_bf16 = timed(
        "sim MD bf16", phase_sim_md, BF16_PATHS_KW)
    timed("sim relax", phase_sim_relax)
    timed("sim host", phase_sim_host)
    timed("sim relaxers", phase_sim_relaxers)
    log(f"simulation phase: {time.perf_counter() - t0:.0f} s")
    t_launches, t_times, t_errors = phase_train()
    for row in rows:
        name = row["name"].split()[0]
        wrapper = kernel_versions()[name][0].__name__
        dtype = row["dtype"]
        if dtype == "bf16":
            row["sim_launches"] = sim_launches_bf16[wrapper]
            row["sim_bf16_launches"] = sim_bf16_launches[wrapper]
            sim_err = sim_errors_bf16.get(row["name"], 0.0)
        else:
            row["sim_launches"] = sim_launches[wrapper]
            sim_err = sim_errors.get(row["name"], 0.0)
        # the train step of the row's type (its launches count both types)
        row["train_launches"] = t_launches[dtype][wrapper]
        train = t_times[dtype].get(name)
        row["train_ms"] = train["ms"] if train else None
        if train and "forms" in train:
            row["train_forms"] = train["forms"]
        row["max_abs_err"] = max(row["max_abs_err"], sim_err,
                                 t_errors[dtype].get(row["name"], 0.0))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


# run in each ROOT of --compare, by that checkout's own chip_smoke.py
_COMPARE_CHILD = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from chgnet_tpu_torch.graph.batching import batch_graphs
from chgnet_tpu_torch.models import CHGNet
os.makedirs(os.path.dirname(cs.LOG_PATH), exist_ok=True)
open(cs.LOG_PATH, "w").close()
cs.phase_card_and_build()
graphs = cs.bench_graphs(CHGNet(seed=0, device="cuda").graph_converter)
n_edges = sum(g.n_directed for g in graphs)
batch = batch_graphs(graphs).to("cuda")
with cs.env_switch("CHGNET_TPU_STREAM_V2"):
    batch_v2 = batch_graphs(graphs).to("cuda")
for path, (_, switch, _) in cs.PATHS.items():
    own = batch_v2 if switch == "CHGNET_TPU_STREAM_V2" else batch
    cs.phase_model(path, own, n_edges, graphs)
del batch, batch_v2
cs.phase_sim_md()
"""


def compare(roots) -> int:
    """``--compare``: each root's paths and MD run, in turns."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    for root in roots:
        proc = subprocess.Popen(
            [sys.executable, "-c", _COMPARE_CHILD], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for line in proc.stdout:
            print(f"[{root}] {line}", end="", flush=True)
        if proc.wait():
            print(f"chip_smoke --compare: {root} failed with exit code "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"] and sys.argv[2:]:
        sys.exit(compare(sys.argv[2:]))
    sys.exit(main())
