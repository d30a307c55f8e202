#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_demo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Phases, one line each; any failure raises and exits non-zero:

1. require CUDA; print the device and `nvidia-smi` name and power limit;
2. build the kernels from cfd_demo_tpu_torch/csrc with nvcc;
3. hold each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes, and time both with CUDA events: 2048^2 for
   predict_div, jacobi_fused_k and correct_bc on a state after a few
   steps of the fast shape (jacobi_fused_k also bit for bit against the
   whole field's jacobi_fused_k_shard_plain at k = 16 and at a k its
   sweeps a launch do not divide); 800x264 for the rounds kernel, on the
   state phase 4 ends at, where every step runs all its outer rounds, with
   the same count of rounds and sweeps required, fed kernel 1's output
   (predict_div first held against its plain version there, as at each
   shape below where the rounds route runs it), and its cluster, slab
   and cooperative forms against each other there and on the 400x132 JS
   state (the same counts and bits), and the slab form, which the rule
   gives a 1024x512 grid, against the plain version there (the same
   counts) and the cooperative form (the same bits); on the 2048^2 production
   state after a few steps, the restrict and corr kernels at 2048^2 and
   the cc kernel on the 1023^2 level (with and without the residual);
   the res kernel on the 2047^2 production state; the FDM bottom
   solve against an f64 solve with TF32 turned on for f32 matmuls; the
   whole-substep ensemble kernel on the 64x256x96 ensemble after 20
   steps and the batched Jacobi kernel on the 8x800x264 ensemble's next
   rhs after 5, each with the same per-scene exits required, and the
   latter again with scenes flagged done, as the masked rounds call it;
   the whole-substep kernel's cluster form on that 8x800x264 state
   against the route it replaced there (the plain predictor, kernel 12
   and the masked rounds), the same rounds and the sweeps one a solve
   apart at most, both timed;
   each of these routes in its cluster form, one thread-block cluster a
   scene, held to its parent form (the block form, the cooperative form)
   bit for bit, both timed;
   the SOR kernels: the colour-split kernel at k = 8 and k = 10 on the
   2048^2 SOR state after 3 steps, the full-layout kernel on the 2047^2
   one, the whole-substep kernel's SOR form on the 16x256x96 SOR ensemble
   after 20 steps (the same per-scene exits required), and one substep of
   that form and of the plain batched SOR at B = 16 and B = 64; the
   vertex multigrid's kernels (csrc/mg.cu): on the 2048^2 and 2047^2
   multigrid states after 3 steps, the fine level after one V-cycle, the
   smoother at k = 5 and 10, the residual-restriction and the
   prolongation of the cycle's own correction (with and without the p'
   BCs); the transfers on a 33x17 level; the smoother on the 128^2 level
   (one block); the damped smoother on the 2048^2 and 800x264 legacy
   production states after 3 steps and on the 128^2 level; the JS twin's
   forms: predict_div with SECOND and QUICK faces under either semantics
   and correct_bc with the PARABOLIC and PARABOLIC_UPPER inlets under the
   JS masks, on the 2048^2 JS QUICK state after 3 steps, and the rounds
   kernel on a 400x132 JS QUICK PARABOLIC state (the same sweeps
   required, predict_div against its plain version there first); correct_div on the 2048^2 reference-mode state after 3
   steps; one MULTIGRID solve from the same (p'0, rhs) on the card and
   the CPU at 2048^2, p' held to the summed tolerances of its launches;
   the row-sharded tier's kernels: on the 2048^2 fast and SOR states
   after 3 steps cut into 4 shards, every shard's halo-extended block
   (544 rows: 512 owned, a 16-row halo) through jacobi_fused_k_shard at
   k = 10 and sor_fused_k_shard at k = 5, and each once on a column
   block, owned rows against the plain twins; predict_div and correct_bc
   on a shard's 8-row-haloed block at a nonzero row offset; the CAVITY
   instances of kernels 2, 3 and 4 (the lid-driven cavity, BASELINE
   config 2): jacobi_fused_k and correct_bc (UNIFORM and
   parabolic lids) on the 2048^2 cavity fast state after 3 steps, kernel
   2 also bit for bit against the whole field's folded twin, each beside
   its channel instance's time on the same inputs; the rounds kernel's
   cluster form on the 512^2 cavity after 20 steps and its slab form on
   the 1024^2 cavity after 20 (predict_div against its plain version on
   each state first), the same rounds and sweeps as the plain
   version required, each against the other forms that take the grid;
   kernel 3's CAVITY instance's device time a launch (torch.profiler);
   the CAVITY instances of kernels 6-9, 18 and 19 (MG_PRODUCTION under
   the cavity, each a line of its own in the JSON line, beside its
   channel instance's time on the same inputs): on the 2048^2 cavity
   production state after 3 steps, kernel 7, kernel 9 on the 1023^2
   level (east_dirichlet False) and kernel 8 with the cycle's own
   correction; kernel 6 on the 2047^2 state; kernel 19 and kernel 18's
   cavity ring on the 2048^2 legacy state, kernel 19 also on the 128^2
   level (one block);
4. run the 800x264 default scene (the Rust app's) for 50 steps with
   make_run, print steps/s and check its physical invariants;
5. run the benchmark's fast shape at 2048^2 (bench.py --mode fast):
   5 warm-up steps, then 100 timed steps under
   torch.cuda.set_sync_debug_mode("error"), print cell-updates/s;
6. the production projection (bench.py --mode production): at 2048^2,
   5 warm-up steps, then 20 timed steps; print cell-updates/s and
   V-cycles per step, and require each step's res_p <= max(tol_r, the
   noise floor) or the cycle cap, naming which; 3 steps at 2047^2 (odd:
   the res kernel); 3 steps of the 800x264 scene with MG_PRODUCTION,
   which must not launch the Jacobi rounds kernel; the ensembles
   (apps/ensemble.py): 64 scenes of 256x96, 5 warm-up steps, then 50
   timed steps under set_sync_debug_mode("error"); 8 scenes of 800x264,
   10 steps; print scene-steps/s and aggregate cell-updates/s; and
   scene k of the 64-batch after 3 steps against an unbatched run of
   that scene on the card; red/black SOR (bench.py --mode sor): at
   2048^2, 5 warm-up steps, then 100 timed under
   set_sync_debug_mode("error"); 3 steps at 2047^2 (odd: the full-layout
   kernel); 3 steps of the 800x264 scene with SOR, which must launch no
   SOR kernel and not the rounds kernel; the SOR ensemble, 16 scenes of
   256x96, 5 warm-up steps, then 50 timed under the sync check; the
   JS kit's MULTIGRID (bench.py --mode production's options with that
   solver): at 2048^2, 5 warm-up steps, then 100 timed under the sync
   check; 3 steps at 2047^2 under it too; 3 steps of the 800x264 scene
   with --solver multigrid (up to 20 outer rounds); the legacy production
   projection (--mgp-scheme legacy) at 2048^2, 5 warm-up steps, then 20
   one at a time with the V-cycles and exit of each, and 3 steps at
   800x264; the JS twin's default scene (400x132, adaptive substeps, the
   rounds kernel from a zero p'), 5 warm-up steps then 50 timed, with
   substeps per step; the 2048^2 JS QUICK PARABOLIC shape (bench.py
   --mode fast's schedule), 5 warm-up steps then 100 timed under the sync
   check; the 2048^2 reference mode with rounds_impl="pallas", 3 warm-up
   steps then 5 with the outer rounds of each, against the unfused
   route's 5 from the same state on the card; the row-sharded step on one
   card (every shard on cuda:0): 2048^2 fast and sor on 4 shards, 5
   warm-up steps then 100 timed under set_sync_debug_mode("error"), each
   beside its unsharded rate; the 800x264 default scene on 3 shards (88
   rows each, early exits, outer rounds) for 3 steps from phase 4's end
   state; 2048^2 FDM on 4 shards, 3 steps; the cavity with the cavity
   app's constants and Rust defaults at 512^2 (5 warm-up steps, then
   50), 1024^2 (3, then 10) and 2048^2 (2, then 5), the 2048^2 cavity on
   the fast schedule (5, then 100 under the sync check), a 128^2 JS
   cavity (5, then 50) and the Re = 100 cavity at 64^2 for 8000 steps,
   its centre lines within 0.06 of Ghia et al. (1982); the cavity with
   --solver mg-production (the app's constants, Rust defaults): aligned
   at 512^2 (5 warm-up steps, then 20) and 2048^2 (2, then 5), 2047^2
   (2, then 3), the legacy cycle at 512^2 (5) and 2048^2 (2, then 3),
   each step timed one at a time with the V-cycles it ran; each of these
   paths must launch exactly its kernels;
7. from the end states of 4, 5, 6 and the ensembles (2 of the 8
   800x264 scenes, 2 of the 16 SOR scenes), run 3 steps (the 2048^2 JS
   QUICK shape 2, the reference mode 1) on CUDA and on the port's CPU
   path and compare u, v, grad p and mean-removed p (the production
   projections, aligned and legacy, with their solver's own bound;
   MULTIGRID on u, v and grad p alone); from each sharded path's end
   state 3 steps sharded on the card, against 3 unsharded on the card
   and 3 on the CPU path (the 800x264 one sharded on the CPU, its
   solves exiting k sweeps apart at most); the 512^2 cavity and the
   2048^2 cavity fast shape, 3 steps on CUDA and on the CPU path; the
   1024^2 cavity at Re = 1000 and dt 1e-4 (the cavity_1024 cell's
   constants), 3 steps after 30 on the card from rest; the
   512^2 cavity production runs, aligned (3 steps) and legacy (2);
8. require every kernel of each path to have launched in that path's
   run (counts set to 0 just before it, read just after), one predict_div
   launch for each rounds-kernel launch on every path that launches the
   rounds kernel, the rounds kernel in its cluster form on the 800x264
   and 400x132 JS runs,
   kernels 2-4, 6-9, 18 and 19 in their CAVITY instances on every cavity path and never on another (kernel 4's
   cluster form at 512^2, 128^2 and 64^2, its slab form at 1024^2), and
   kernel 20 in its cluster form on the three ensemble runs (printing the
   CTAs a scene each took), the 8x800x264 run launching no other kernel.

The line before the last is a JSON object with each kernel's numbers;
the last is {"ok": true, "device": {...}}. It needs one card and no
network. ``--out`` also writes every number to a JSON file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.apps.ensemble import ensemble_scene, ensemble_state
from cfd_demo_tpu_torch.cells import (SHARDED, cavity_fast_scene, cavity_production_scene,
                                      cavity_scene, ensemble_args, fast_scene,
                                      js_default_scene,
                                      js_quick_scene, legacy_production_scene,
                                      multigrid_scene, production_scene,
                                      reference_mode_scene, reference_scene,
                                      rounds_args, sor_ensemble_scene, sor_scene,
                                      vcycles_launched)
from cfd_demo_tpu_torch.core.masks import masks_traced
from cfd_demo_tpu_torch.shard import (gather_state, make_mesh, make_run_shmap,
                                      shard_state)
from cfd_demo_tpu_torch.shard.halo import exchange_rows
from cfd_demo_tpu_torch.shard.mesh import split_rows
from cfd_demo_tpu_torch.shard.step_shmap import sor_k
from cfd_demo_tpu_torch.kernels import _build
from cfd_demo_tpu_torch.kernels import mg as kmg
from cfd_demo_tpu_torch.kernels import mgp
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.kernels.cluster import plan
from cfd_demo_tpu_torch.kernels.ensemble import (substep_batch, substep_batch_plain,
                                                 substep_batch_sor)
from cfd_demo_tpu_torch.kernels.jacobi import (jacobi_fused_k, jacobi_fused_k_folded,
                                               jacobi_fused_k_plain,
                                               jacobi_fused_k_shard,
                                               jacobi_fused_k_shard_plain, jacobi_tile)
from cfd_demo_tpu_torch.kernels.jacobi_batch import jacobi_batch, jacobi_batch_plain
from cfd_demo_tpu_torch.kernels.rounds import solve_correct_rounds, solve_correct_rounds_plain
from cfd_demo_tpu_torch.kernels.substep import (correct_bc, correct_bc_plain,
                                                correct_div, correct_div_plain,
                                                predict_div, predict_div_plain)
from cfd_demo_tpu_torch.ops import fdm
from cfd_demo_tpu_torch.kernel_times import device_us
from cfd_demo_tpu_torch.ops.poisson import (MgKit, _apply_pprime_bcs_cavity, _cc_prolong_x,
                                            _cc_vcycle, _mg_kit, _mg_vcycle, _mgp_vcycle,
                                            _smoothers, multigrid)
from cfd_demo_tpu_torch.solver.piso import (_substep_jnp, _use_fused_substep, ramped_inlet,
                                            resolve_fuse_k)
from cfd_demo_tpu_torch.validation import GHIA_STEPS, ghia_deviation, ghia_scene

EPS32 = float(np.finfo(np.float32).eps)
# p's f32 resolution. p reaches thousands on the 800x264 scene, and there
# the CUDA and CPU paths' p differ by about 3 ulps of max|p| (L2), as two
# f32 orders of the same arithmetic over some thousand sweeps do; so grad
# p is held to its golden bound plus this many ulps of max|p| over h.
GRAD_P_ULPS = 6
FAST, REF, PROD = "2048^2 fast", "800x264", "2048^2 production"
ODD, REF_PROD = "2047^2 production", "800x264 production"
ENS64, ENS8 = "ensemble 64x256x96", "ensemble 8x800x264"
SOR, SOR_ODD, REF_SOR = "2048^2 sor", "2047^2 sor", "800x264 sor"
ENS_SOR = "ensemble 16x256x96 sor"
MG, MG_ODD, REF_MG = "2048^2 multigrid", "2047^2 multigrid", "800x264 multigrid"
LEG, REF_LEG = "2048^2 production legacy", "800x264 production legacy"
JS_DEF, JS_QUICK = "400x132 js default", "2048^2 js quick"
REF_CD = "2048^2 reference correct_div"
FAST_SH, SOR_SH, REF_SH, FDM_SH = SHARDED  # the sharded paths, cells.py
CAV512, CAV1024, CAV2048 = "512^2 cavity", "1024^2 cavity", "2048^2 cavity"
CAV1024_RE1000 = "1024^2 cavity Re 1000"
CAV_FAST, CAV_JS, GHIA = "2048^2 cavity fast", "128^2 js cavity", "64^2 ghia cavity"
CAV_MGP512, CAV_MGP, CAV_MGP_ODD = ("512^2 cavity production", "2048^2 cavity production",
                                    "2047^2 cavity production")
CAV_LEG512, CAV_LEG = "512^2 cavity production legacy", "2048^2 cavity production legacy"
CAVITY_MGP_PATHS = (CAV_MGP512, CAV_MGP, CAV_MGP_ODD, CAV_LEG512, CAV_LEG)
CAVITY_PATHS = (CAV512, CAV1024, CAV2048, CAV_FAST, CAV_JS, GHIA, *CAVITY_MGP_PATHS)
# name -> (wrapper, source, the Pallas call site it replaces, the path
# whose launches the JSON line reports)
KERNELS = {
    "predict_div": (predict_div, "cfd_demo_tpu_torch/csrc/predict_div.cu",
                    "cfd_demo_tpu/kernels/substep_pallas.py:288", FAST),
    "jacobi_fused_k": (jacobi_fused_k, "cfd_demo_tpu_torch/csrc/jacobi.cu",
                       "cfd_demo_tpu/kernels/jacobi_pallas.py:1088", FAST),
    "correct_bc": (correct_bc, "cfd_demo_tpu_torch/csrc/correct_bc.cu",
                   "cfd_demo_tpu/kernels/substep_pallas.py:459", FAST),
    "rounds": (solve_correct_rounds, "cfd_demo_tpu_torch/csrc/rounds.cu",
               "cfd_demo_tpu/kernels/rounds_pallas.py:156", REF),
    "jacobi_fused_k_res": (mgp.jacobi_fused_k_res, "cfd_demo_tpu_torch/csrc/mgp.cu",
                           "cfd_demo_tpu/kernels/jacobi_pallas.py:418", ODD),
    "jacobi_fused_k_restrict": (mgp.jacobi_fused_k_restrict,
                                "cfd_demo_tpu_torch/csrc/mgp.cu",
                                "cfd_demo_tpu/kernels/jacobi_pallas.py:503", PROD),
    "jacobi_fused_k_corr": (mgp.jacobi_fused_k_corr, "cfd_demo_tpu_torch/csrc/mgp.cu",
                            "cfd_demo_tpu/kernels/jacobi_pallas.py:746", PROD),
    "cc_sweeps": (mgp.cc_sweeps, "cfd_demo_tpu_torch/csrc/mgp.cu",
                  "cfd_demo_tpu/kernels/jacobi_pallas.py:1786", PROD),
    "substep_batch": (substep_batch, "cfd_demo_tpu_torch/csrc/ensemble.cu",
                      "cfd_demo_tpu/kernels/ensemble_pallas.py:354", ENS64),
    # no path launches kernel 12 since the 8x800x264 ensemble takes kernel
    # 20 (its launches read 0); phase 3 checks it on that ensemble's rhs
    "jacobi_batch": (jacobi_batch, "cfd_demo_tpu_torch/csrc/jacobi_batch.cu",
                     "cfd_demo_tpu/kernels/jacobi_pallas.py:1599", ENS8),
    "sor_fused_k": (ksor.sor_fused_k, "cfd_demo_tpu_torch/csrc/sor.cu",
                    "cfd_demo_tpu/kernels/sor_pallas.py:428", SOR_ODD),
    "sor_fused_k_rb2": (ksor.sor_fused_k_rb2, "cfd_demo_tpu_torch/csrc/sor.cu",
                        "cfd_demo_tpu/kernels/sor_pallas.py:939", SOR),
    "substep_batch_sor": (substep_batch_sor, "cfd_demo_tpu_torch/csrc/ensemble.cu",
                          "cfd_demo_tpu/kernels/ensemble_pallas.py:354", ENS_SOR),
    # kernel 16, and kernel 10 (jacobi_pallas.py:1237), the same function
    "mg_smooth": (kmg.mg_smooth, "cfd_demo_tpu_torch/csrc/mg.cu",
                  "cfd_demo_tpu/kernels/mg_pallas.py:220", MG),
    "mg_residual_restrict": (kmg.mg_residual_restrict, "cfd_demo_tpu_torch/csrc/mg.cu",
                             "cfd_demo_tpu/kernels/mg_pallas.py:554", MG),
    "mg_prolong_add": (kmg.mg_prolong_add, "cfd_demo_tpu_torch/csrc/mg.cu",
                       "cfd_demo_tpu/kernels/mg_pallas.py:728", MG),
    "mgp_smooth": (kmg.mgp_smooth, "cfd_demo_tpu_torch/csrc/mg.cu",
                   "cfd_demo_tpu/kernels/mg_pallas.py:1063", LEG),
    "correct_div": (correct_div, "cfd_demo_tpu_torch/csrc/correct_div.cu",
                    "cfd_demo_tpu/kernels/substep_pallas.py:587", REF_CD),
    "jacobi_fused_k_shard": (jacobi_fused_k_shard, "cfd_demo_tpu_torch/csrc/jacobi.cu",
                             "cfd_demo_tpu/kernels/jacobi_pallas.py:1450", FAST_SH),
    "sor_fused_k_shard": (ksor.sor_fused_k_shard, "cfd_demo_tpu_torch/csrc/sor.cu",
                          "cfd_demo_tpu/kernels/sor_pallas.py:609", SOR_SH),
}
VERTEX = ("mg_residual_restrict", "mg_prolong_add")
# The rounds kernel's launches in its cluster and slab forms (of its
# "launches").
CLUSTER, SLAB = "rounds_cluster", "rounds_slab"
# The launches of kernels 2-4, 6-9, 18 and 19's CAVITY instances (of their
# "launches"; kernel 9's is its east_dirichlet=False form, kernel 18's its
# cavity ring).
CAVITY_OF = {k: f"{k}_cavity" for k in (
    "jacobi_fused_k", "correct_bc", "rounds", "jacobi_fused_k_res", "jacobi_fused_k_restrict",
    "jacobi_fused_k_corr", "cc_sweeps", "mg_prolong_add", "mgp_smooth")}
# The CAVITY instances of kernels 6-9, 18 and 19, each a line of its own in
# the kernels' JSON line: name -> (the kernel, the path whose launches the
# line reports).
CAVITY_LINES = {
    "jacobi_fused_k_res cavity": ("jacobi_fused_k_res", CAV_MGP_ODD),
    "jacobi_fused_k_restrict cavity": ("jacobi_fused_k_restrict", CAV_MGP),
    "jacobi_fused_k_corr cavity": ("jacobi_fused_k_corr", CAV_MGP),
    "cc_sweeps cavity": ("cc_sweeps", CAV_MGP),
    "mg_prolong_add cavity": ("mg_prolong_add", CAV_LEG),
    "mgp_smooth cavity": ("mgp_smooth", CAV_LEG),
}
FORM_OF = {SLAB: "rounds",
           **{form: kernel for kernel, form in CAVITY_OF.items()}}
# The batched kernels' launches in their cluster form (of their "launches").
BATCH_CLUSTER = {"substep_batch": "substep_batch_cluster",
                 "jacobi_batch": "jacobi_batch_cluster",
                 "substep_batch_sor": "substep_batch_sor_cluster"}
# The kernels each path must launch.
PATHS = {
    REF: ("predict_div", "rounds", CLUSTER),
    FAST: ("predict_div", "jacobi_fused_k", "correct_bc"),
    PROD: ("predict_div", "correct_bc", "jacobi_fused_k_restrict",
           "jacobi_fused_k_corr", "cc_sweeps"),
    ODD: ("predict_div", "correct_bc", "jacobi_fused_k_res", "cc_sweeps"),
    REF_PROD: ("jacobi_fused_k_restrict", "jacobi_fused_k_corr", "cc_sweeps"),
    ENS64: ("substep_batch", BATCH_CLUSTER["substep_batch"]),
    ENS8: ("substep_batch", BATCH_CLUSTER["substep_batch"]),
    SOR: ("predict_div", "sor_fused_k_rb2", "correct_bc"),
    SOR_ODD: ("predict_div", "sor_fused_k", "correct_bc"),
    REF_SOR: (),
    ENS_SOR: ("substep_batch_sor", BATCH_CLUSTER["substep_batch_sor"]),
    MG: ("predict_div", "correct_bc", "mg_smooth", *VERTEX),
    MG_ODD: ("predict_div", "correct_bc", "mg_smooth", *VERTEX),
    REF_MG: ("mg_smooth", *VERTEX),
    LEG: ("predict_div", "correct_bc", "mgp_smooth", *VERTEX),
    REF_LEG: ("mgp_smooth", *VERTEX),
    JS_DEF: ("predict_div", "rounds", CLUSTER),
    JS_QUICK: ("predict_div", "jacobi_fused_k", "correct_bc"),
    REF_CD: ("predict_div", "jacobi_fused_k", "correct_div"),
    FAST_SH: ("predict_div", "jacobi_fused_k_shard", "correct_bc"),
    SOR_SH: ("predict_div", "sor_fused_k_shard", "correct_bc"),
    REF_SH: ("predict_div", "jacobi_fused_k_shard"),
    FDM_SH: ("predict_div", "correct_bc"),
    # the cavity (BASELINE config 2): kernels 1 and 4 below 2M cells (4's
    # cluster form at 512^2, 128^2 and 64^2, its slab form at 1024^2),
    # kernels 1 and 2 on the fused route with outer rounds at 2048^2, and
    # 1-3 on the fast shape, each of 2-4 in its CAVITY instance
    CAV512: ("predict_div", "rounds", CLUSTER, CAVITY_OF["rounds"]),
    CAV1024: ("predict_div", "rounds", SLAB, CAVITY_OF["rounds"]),
    CAV2048: ("predict_div", "jacobi_fused_k", CAVITY_OF["jacobi_fused_k"]),
    CAV_FAST: ("predict_div", "jacobi_fused_k", "correct_bc",
               CAVITY_OF["jacobi_fused_k"], CAVITY_OF["correct_bc"]),
    CAV_JS: ("predict_div", "rounds", CLUSTER, CAVITY_OF["rounds"]),
    GHIA: ("predict_div", "rounds", CLUSTER, CAVITY_OF["rounds"]),
    # the cavity with MG_PRODUCTION (Rust defaults: outer rounds, so the
    # fused route at 2048^2 and 2047^2 runs kernel 1 and the plain
    # corrector): the aligned cycle's kernels (6 on the odd grid, 7 and 8
    # on the even ones, 9 on every coarse level above the stop), the
    # legacy cycle's (17, 18's cavity ring, 19), each of 6-9, 18 and 19 in
    # its CAVITY instance
    CAV_MGP512: ("jacobi_fused_k_restrict", "jacobi_fused_k_corr", "cc_sweeps",
                 *(CAVITY_OF[k] for k in ("jacobi_fused_k_restrict",
                                          "jacobi_fused_k_corr", "cc_sweeps"))),
    CAV_MGP: ("predict_div", "jacobi_fused_k_restrict", "jacobi_fused_k_corr", "cc_sweeps",
              *(CAVITY_OF[k] for k in ("jacobi_fused_k_restrict", "jacobi_fused_k_corr",
                                       "cc_sweeps"))),
    CAV_MGP_ODD: ("predict_div", "jacobi_fused_k_res", "cc_sweeps",
                  *(CAVITY_OF[k] for k in ("jacobi_fused_k_res", "cc_sweeps"))),
    CAV_LEG512: ("mgp_smooth", *VERTEX, CAVITY_OF["mgp_smooth"],
                 CAVITY_OF["mg_prolong_add"]),
    CAV_LEG: ("predict_div", "mgp_smooth", *VERTEX,
              *(CAVITY_OF[k] for k in ("mgp_smooth", "mg_prolong_add"))),
}
# Paths that must launch their kernels and no other.
EXACT_PATHS = (ENS8, SOR, SOR_ODD, REF_SOR, ENS_SOR, MG, MG_ODD, REF_MG, LEG, REF_LEG,
               JS_DEF, JS_QUICK, REF_CD, FAST_SH, SOR_SH, REF_SH, FDM_SH, *CAVITY_PATHS)
# The card's peaks (NVIDIA's H100 SXM data sheet, at the 700 W limit):
# device-memory bytes/s and f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per cell, counted from the kernels' sources: a folded
# damped sweep 9 and its |change| max 3; a folded residual 8 and its
# |r| max 2; the 2x2 restriction 1.5; the corr add 3; a cell-centred
# sweep 10; predict_div about 56 with FIRST faces (u* and v*: 25 each, the
# rhs 6), 76 with SECOND (35 each) and 106 with QUICK (50 each): each face
# once, as the function needs it; correct_bc about 20; a round's
# divergence 6 and corrector 9, and correct_div about 30 (the corrector of
# three faces).
SWEEP, SWEEP_ERR, RES, RES_MAX, RESTRICT, CORR_ADD, CC_SWEEP = 9, 3, 8, 2, 1.5, 3, 10
PREDICT, DIV_CORRECT, CORRECT_DIV = 56, 15, 30
PREDICT_BY_SCHEME = {"FIRST": PREDICT, "SECOND": 76, "QUICK": 106}
# A red/black SOR iteration: 10 a cell (two sums, four products, the rhs
# term, three adds), and its |change| max 3.
SOR_ITER = 10
# The vertex kernels, counted from csrc/mg.cu: an undamped sweep 7 a
# cell; the residual-restriction 88 a coarse cell (nine residuals of 8,
# the separable weights 16); the prolongation and add 12 a fine cell. A
# damped folded sweep is SWEEP.
MG_SWEEP, MG_RESTRICT, MG_PROLONG = 7, 88, 12
# Twice the drift of SOR's p' between two roundings of the same
# iterations, as a share of max|p'| an iteration (compare_with_cpu).
SOR_DRIFT = 2e-6


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of fn() over n calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def scaled(ref, rtol: float) -> float:
    return rtol * max(1.0, float(torch.max(torch.abs(ref))))


def grad_p_l2(pa, pb, g):
    """(L2 of the grad p difference, its bound, the bound's unit
    ulp(max|p|)/h): the larger of the x and y differences, held to the
    golden bound (tests/test_golden.py:116-141) plus GRAD_P_ULPS units."""
    pa, pb = (np.asarray(x, np.float64) for x in (pa, pb))
    l2 = lambda x: float(np.sqrt(np.mean(x ** 2)))
    dx = lambda p: np.diff(p, axis=-1) / g.dx  # a batch: over all scenes
    dy = lambda p: np.diff(p, axis=-2) / g.dy
    unit = float(np.spacing(np.float32(np.abs(pb).max()))) / min(g.dx, g.dy)
    x = max(l2(dx(pa) - dx(pb)), l2(dy(pa) - dy(pb)))
    return x, 1e-4 * max(1.0, l2(dx(pb))) + GRAD_P_ULPS * unit, unit


def compare(name, pairs, results, timing, bnd):
    """pairs: (label, kernel out, plain out, atol); bnd: bound(...).
    Checks, prints one line and records the kernel's entry (no PyTorch
    call computes any of these kernels' functions: library_ms is null)."""
    worst, parts = 0.0, []
    for label, got, ref, atol in pairs:
        d = max_abs(got, ref)
        parts.append(f"{label} max|d|={d:.3e} (tol {atol:.1e}) "
                     f"relL2={rel_l2(got, ref):.2e}")
        require(bool(torch.isfinite(got).all()), f"{name}: {label} not finite")
        require(d <= atol, f"{name}: {label} max|d| {d} > {atol}")
        worst = max(worst, d)
    ms, plain_ms = timing
    print(f"[3] {name}: " + "; ".join(parts)
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     **bnd, "library_ms": None}


def check_kernels(dev, results):
    # 2048^2 kernels on the state after 3 steps of the fast shape.
    scene = fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    u, v, dt, nu = state.u, state.v, state.dt, state.nu
    inlet = ramped_inlet(opts, state)
    sch, sem = scene.params.velocity_scheme, opts.semantics

    got = predict_div(u, v, dt, nu, g, sch, sem)
    ref = predict_div_plain(u, v, dt, nu, g, sch, sem)
    h = float(dt)
    # rhs = (u* differences)/(dx*dt): one ulp of u* is eps*|u*|/(dx*dt) there.
    uv_scale = max(1.0, float(ref[0].abs().max()), float(ref[1].abs().max()))
    rhs_tol = 4 * EPS32 * uv_scale * (1 / g.dx + 1 / g.dy) / h
    compare("predict_div", [
        ("u*", got[0], ref[0], scaled(ref[0], 1e-6)),
        ("v*", got[1], ref[1], scaled(ref[1], 1e-6)),
        ("rhs", got[2], ref[2], rhs_tol)], results,
        (time_ms(lambda: predict_div(u, v, dt, nu, g, sch, sem), 20),
         time_ms(lambda: predict_div_plain(u, v, dt, nu, g, sch, sem), 20)),
        bound(nbytes(u, v, *got, *masks_traced(g, sem, dev)[:2]), PREDICT * g.nx * g.ny))
    u_star, v_star, rhs = got

    k = 16
    pp = state.p_prime
    got = jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, k)
    ref = jacobi_fused_k_plain(pp, rhs, g.dx, g.dy, opts.jacobi_omega, k)
    # The kernel folds the divisions into f32 multipliers as the TPU
    # kernel does: a few ulps per sweep over 16 sweeps.
    compare("jacobi_fused_k", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("err", got[1], ref[1], scaled(ref[0], 1e-5))], results,
        (time_ms(lambda: jacobi_fused_k(pp, rhs, g.dx, g.dy,
                                        opts.jacobi_omega, k), 10),
         time_ms(lambda: jacobi_fused_k_plain(pp, rhs, g.dx, g.dy,
                                              opts.jacobi_omega, k), 10)),
        bound(nbytes(pp, rhs, got[0]), k * (SWEEP + SWEEP_ERR) * pp.numel()))
    # The tiled kernel is the whole field's shard twin (the Pallas kernel's
    # arithmetic) bit for bit, at k = 16 and at a k its t does not divide.
    tile = jacobi_tile()
    results["jacobi_fused_k"]["tile"] = tile
    for kk in (16, tile["sweeps"] + 5):
        a = jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, kk)
        b = jacobi_fused_k_shard_plain(pp, rhs, 0, g.ny, g.dx, g.dy, opts.jacobi_omega,
                                       kk, 0, g.ny)
        d = max(max_abs(a[0], b[0]), max_abs(a[1], b[1]))
        require(d == 0.0, f"jacobi_fused_k: k={kk} differs from the whole field's "
                f"jacobi_fused_k_shard_plain by {d}")
    print(f"[3] jacobi_fused_k: {tile['sweeps']} sweeps a launch on "
          f"{tile['rows']}x{tile['cols']} tiles ({tile['threads']} threads); "
          f"k=16 and k={tile['sweeps'] + 5} equal the whole field's "
          f"jacobi_fused_k_shard_plain bit for bit", flush=True)
    pp = got[0]

    args = (u_star, v_star, state.p, pp, u, v, dt, inlet, g,
            scene.params.inlet_profile, scene.params.flow_case, sem)
    got = correct_bc(*args)
    ref = correct_bc_plain(*args)
    compare("correct_bc", [
        (label, a, b, scaled(b, 1e-6))
        for label, a, b in zip(("u", "v", "p", "res_u", "res_v", "max_vel"),
                               got, ref)], results,
        (time_ms(lambda: correct_bc(*args), 20),
         time_ms(lambda: correct_bc_plain(*args), 20)),
        bound(nbytes(*args[:6], *got[:3], *masks_traced(g, sem, dev)[2:]),
              20 * g.nx * g.ny))

    # The rounds kernel at 800x264 on the state phase 4 ends at (55 steps),
    # where every step runs all its outer rounds, fed what the main path
    # feeds it: kernel 1's u*, v*, rhs, kernel 1 first held against its
    # plain version there. The exits are exact on both sides, so both
    # must run the same rounds and sweeps.
    scene = reference_scene()
    g = scene.grid
    state, _ = tc.make_run(scene, 55)(scene.init_state(dev))
    check_rounds_predict(scene, state, "800x264 rounds route", results)
    args = rounds_args(scene, state)
    got = solve_correct_rounds(*args)
    ref = solve_correct_rounds_plain(*args)
    counts, ref_counts = got[5].tolist(), ref[5].tolist()
    require(counts == ref_counts, f"rounds: the kernel ran {counts} (outer "
            f"rounds, sweeps), the plain version {ref_counts}")
    require(counts[0] > 0, f"rounds: no outer round ran ({counts})")
    # err, the last sweep's max|change| of p', is a difference of nearly
    # equal values: resolved to about an ulp of max|p'|, 1e-3 of err here.
    err_k, err_p = float(got[4]), float(ref[4])
    require(np.isclose(err_k, err_p, rtol=1e-2),
            f"rounds: err {err_k} vs plain {err_p}")
    gp, gp_bound, unit = grad_p_l2(got[2].cpu(), ref[2].cpu(), g)
    require(gp <= gp_bound, f"rounds: grad p L2 {gp} > {gp_bound}")
    print(f"[3] rounds: {counts[0]} outer rounds, {counts[1]} sweeps on both "
          f"sides; err {err_k:.6e} vs {err_p:.6e}; grad p L2 {gp:.3e} "
          f"({gp / unit:.2f} ulp(max|p|)/h, bound {gp_bound:.2e})", flush=True)
    # The kernel folds the sweep's divisions into multipliers, so p'
    # differs in its last bits in each of about a thousand sweeps, mostly
    # along the slowest, near-uniform mode (tests/test_golden.py:14-24):
    # p and p' are compared with the mean difference removed; u and v at
    # the bound of tests/test_ensemble_pallas.py (atol 5e-5 + rtol 1e-4).
    demean = lambda a, b: a - (a - b).mean()
    compare("rounds", [
        ("u", got[0], ref[0], 5e-5 + 1e-4 * float(ref[0].abs().max())),
        ("v", got[1], ref[1], 5e-5 + 1e-4 * float(ref[1].abs().max())),
        ("p-mean", demean(got[2], ref[2]), ref[2], scaled(ref[2], 1e-4)),
        ("p'-mean", demean(got[3], ref[3]), ref[3], scaled(ref[3], 1e-4))],
        results,
        (time_ms(lambda: solve_correct_rounds(*args), 5, warmup=1),
         time_ms(lambda: solve_correct_rounds_plain(*args), 3, warmup=1)),
        # the sweeps and rounds this state needs: a sweep with its max, and
        # per round the divergence (6) and the corrector (9)
        bound(nbytes(*args[:5], *got[:4]),
              (counts[1] * (SWEEP + SWEEP_ERR) + (counts[0] + 1) * 15)
              * g.nx * g.ny))
    check_rounds_forms(args, got, "800x264", results)
    check_rounds_refused(dev, results)


def check_rounds_refused(dev, results):
    """The rounds kernel's slab form where kernels.cluster's plan gives
    the grid no cluster (1024 x 512 cells: past 16 CTAs' strips), on
    seeded random fields (an rhs large enough that every solve runs its
    40 sweeps and all 3 outer rounds run), against the plain version: the
    same counts, u and v at the 800x264 check's bound, p and p' with the
    mean difference removed; and against the cooperative form, the same
    bits and counts, both timed."""
    grid = tc.Grid(nx=1024, ny=512, lx=8.0, ly=4.0, obstacles=(tc.Cylinder(2.0, 2.0, 0.3),))
    require(plan("rounds", 1, grid.ny, grid.nx, dev).form == "slab",
            "rounds: the plan takes another form than the slab form at 1024x512")
    scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(tc.Semantics.RUST, jacobi_iters=40,
                                                outer_corrector_rounds=3))
    gen = torch.Generator().manual_seed(21)
    mk = lambda *shape, scale=0.1: (scale * torch.randn(*shape, generator=gen)).to(dev)
    u, v, p = mk(grid.ny, grid.nx + 1), mk(grid.ny, grid.nx), mk(grid.ny, grid.nx)
    args = (u, v, p, torch.zeros_like(p), mk(grid.ny, grid.nx, scale=100.0), 0.002, 1.0,
            scene)
    n_cluster, n_slab = solve_correct_rounds.cluster_launches, solve_correct_rounds.slab_launches
    got, ref = solve_correct_rounds(*args), solve_correct_rounds_plain(*args)
    require(solve_correct_rounds.cluster_launches == n_cluster,
            "rounds 1024x512: the cluster form was launched")
    require(solve_correct_rounds.slab_launches == n_slab + 1,
            "rounds 1024x512: the slab form was not launched")
    counts, ref_counts = got[5].tolist(), ref[5].tolist()
    require(counts == ref_counts == [3, 160], f"rounds 1024x512: the slab form "
            f"ran {counts}, the plain version {ref_counts}, expected [3, 160]")
    demean = lambda a, b: a - (a - b).mean()
    errs = {"u": (max_abs(got[0], ref[0]), 5e-5 + 1e-4 * float(ref[0].abs().max())),
            "v": (max_abs(got[1], ref[1]), 5e-5 + 1e-4 * float(ref[1].abs().max())),
            "p-mean": (max_abs(demean(got[2], ref[2]), ref[2]), scaled(ref[2], 1e-4)),
            "p'-mean": (max_abs(demean(got[3], ref[3]), ref[3]), scaled(ref[3], 1e-4))}
    for name, (d, tol) in errs.items():
        require(d <= tol, f"rounds 1024x512 {name}: max|diff| {d} > {tol}")
    coop = solve_correct_rounds(*args, form="cooperative")
    require(coop[5].tolist() == counts, f"rounds 1024x512: the cooperative form ran "
            f"{coop[5].tolist()}, the slab form {counts}")
    d = max(max_abs(a, b) for a, b in zip(coop[:5], got[:5]))
    require(d == 0.0, f"rounds 1024x512: the slab and cooperative forms differ by {d}")
    entry = {"rule": "slab", "counts": counts,
             "max_abs_err": max(d for d, _ in errs.values()),
             "ms": time_ms(lambda: solve_correct_rounds(*args), 5, warmup=1),
             "cooperative_ms": time_ms(lambda: solve_correct_rounds(*args, form="cooperative"),
                                       5, warmup=1),
             "plain_ms": time_ms(lambda: solve_correct_rounds_plain(*args), 3, warmup=1)}
    results["rounds"].setdefault("forms", {})["1024x512"] = entry
    print(f"[3] rounds 1024x512 (the rule refuses the cluster form): the slab form ran "
          f"{counts} as the plain version, max|diff| {entry['max_abs_err']:.3e}, the "
          f"cooperative form's bits; {entry['ms']:.4f} ms, cooperative "
          f"{entry['cooperative_ms']:.4f}, plain {entry['plain_ms']:.4f} ms", flush=True)


def check_rounds_forms(args, got, label, results):
    """The rounds kernel's other forms on the same inputs as ``got`` (the
    form the route takes for the shape): each form that takes the grid
    (the cluster form where kernels.cluster's plan gives it a cluster,
    the slab form where its plan fits the card, the cooperative form)
    with the same counts and the same bits in u, v, p, p' and err; each
    timed."""
    g = args[-1].grid
    dev = args[0].device
    cavity = args[-1].params.flow_case == tc.FlowCase.CAVITY

    def takes(form):
        try:
            return plan("rounds", 1, g.ny, g.nx, dev, cavity=cavity, form=form)
        except ValueError:  # the form does not take the grid
            return None

    route = takes(None)
    rule, ctas = route.form, route.ctas
    forms = [f for f in ("cluster", "slab", "cooperative") if takes(f)]
    for form in forms:
        alt = solve_correct_rounds(*args, form=form)
        require(alt[5].tolist() == got[5].tolist(),
                f"rounds {label}: the {form} form ran {alt[5].tolist()}, the {rule} form "
                f"{got[5].tolist()}")
        d = max(max_abs(a, b) for a, b in zip(alt[:5], got[:5]))
        require(d == 0.0, f"rounds {label}: the {form} and {rule} forms differ by {d}")
    times = {form: time_ms(lambda: solve_correct_rounds(*args, form=form), 5, warmup=1)
             for form in forms}
    entry = results["rounds"].setdefault("forms", {})
    entry[label] = {"rule": rule, "ctas": ctas, **{f + "_ms": t for f, t in times.items()}}
    print(f"[3] rounds {label}: the {', '.join(forms)} forms give the same bits and "
          f"counts; " + ", ".join(f"{f} {t:.4f} ms" for f, t in times.items())
          + f"; the rule takes the {rule} form", flush=True)


def record(results, name, label, pairs, call, plain, bnd, n=20, n_plain=5):
    """compare() under results[name]["variants"][label]: a form of a
    kernel whose launches the JSON line counts under its kernel."""
    out = {}
    compare(f"{name} {label}", pairs, out, (time_ms(call, n), time_ms(plain, n_plain)), bnd)
    entry = out.popitem()[1]
    del entry["library_ms"]
    results[name].setdefault("variants", {})[label] = entry
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], entry["max_abs_err"])
    return entry


def check_rounds_predict(scene, state, label, results):
    """Kernel 1 where the rounds route launches it: on what rounds_args
    gives it (the state's fields, dt over the substep count), against
    predict_div_plain at the 2048^2 check's tolerances, under
    predict_div's "variants"."""
    g, sem, sch = scene.grid, scene.opts.semantics, scene.params.velocity_scheme
    u, v, nu = state.u, state.v, state.nu
    dt = state.dt / state.substeps.to(state.dt.dtype)
    call = lambda: predict_div(u, v, dt, nu, g, sch, sem)
    plain = lambda: predict_div_plain(u, v, dt, nu, g, sch, sem)
    got, ref = call(), plain()
    uv_scale = max(1.0, float(ref[0].abs().max()), float(ref[1].abs().max()))
    rhs_tol = 4 * EPS32 * uv_scale * (1 / g.dx + 1 / g.dy) / float(dt)
    record(results, "predict_div", label, [
        ("u*", got[0], ref[0], scaled(ref[0], 1e-6)),
        ("v*", got[1], ref[1], scaled(ref[1], 1e-6)),
        ("rhs", got[2], ref[2], rhs_tol)], call, plain,
        bound(nbytes(u, v, *got, *masks_traced(g, sem, u.device)[:2]),
              PREDICT_BY_SCHEME[sch.name] * g.nx * g.ny))


def check_js_kernels(dev, results):
    """Kernels 1, 3 and 4's new forms and kernel 5 on their paths' states.
    On the 2048^2 JS QUICK PARABOLIC state after 3 steps: predict_div with
    SECOND and QUICK faces under either semantics (JS: the face-position
    masks and the averaged convecting v), correct_bc with the PARABOLIC
    and PARABOLIC_UPPER inlets under the JS masks. The rounds kernel on
    the 400x132 JS QUICK PARABOLIC scene after 20 steps (the zero warm
    start, no outer rounds), the same sweeps required. correct_div on the
    2048^2 reference-mode state after 3 steps. Each form's numbers go
    under its kernel's "variants"."""
    scene = js_quick_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    u, v, dt, nu = state.u, state.v, state.dt, state.nu
    inlet = ramped_inlet(opts, state)
    h, cells = float(dt), g.nx * g.ny

    for sem in (tc.Semantics.RUST, tc.Semantics.JS):
        masks = masks_traced(g, sem, dev)
        for sch in (tc.VelocityScheme.SECOND, tc.VelocityScheme.QUICK):
            call = lambda: predict_div(u, v, dt, nu, g, sch, sem)
            plain = lambda: predict_div_plain(u, v, dt, nu, g, sch, sem)
            got, ref = call(), plain()
            uv_scale = max(1.0, float(ref[0].abs().max()), float(ref[1].abs().max()))
            rhs_tol = 4 * EPS32 * uv_scale * (1 / g.dx + 1 / g.dy) / h
            record(results, "predict_div", f"{sem.value} {sch.value}", [
                ("u*", got[0], ref[0], scaled(ref[0], 1e-6)),
                ("v*", got[1], ref[1], scaled(ref[1], 1e-6)),
                ("rhs", got[2], ref[2], rhs_tol)], call, plain,
                bound(nbytes(u, v, *got, *masks[:2]),
                      PREDICT_BY_SCHEME[sch.name] * cells))

    js = tc.Semantics.JS
    u_star, v_star, _ = predict_div(u, v, dt, nu, g, scene.params.velocity_scheme, js)
    for prof in (tc.InletProfile.PARABOLIC, tc.InletProfile.PARABOLIC_UPPER):
        args = (u_star, v_star, state.p, state.p_prime, u, v, dt, inlet, g, prof,
                tc.FlowCase.CHANNEL, js)
        got, ref = correct_bc(*args), correct_bc_plain(*args)
        record(results, "correct_bc", f"js {prof.value}", [
            (lb, a, b, scaled(b, 1e-6))
            for lb, a, b in zip(("u", "v", "p", "res_u", "res_v", "max_vel"), got, ref)],
            lambda: correct_bc(*args), lambda: correct_bc_plain(*args),
            bound(nbytes(*args[:6], *got[:3], *masks_traced(g, js, dev)[2:]),
                  20 * cells))

    # The rounds kernel's JS form on the JS twin's grid with QUICK faces and
    # the PARABOLIC inlet, fed what the rounds route feeds it.
    scene = tc.make_scene(tc.default_js_grid(), tc.SimulationParams(
        dt=0.005, viscosity=1e-6, velocity_scheme=tc.VelocityScheme.QUICK,
        inlet_profile=tc.InletProfile.PARABOLIC), tc.solver_options_for(js))
    gj = scene.grid
    init = scene.init_state(dev)
    init.step.fill_(500)  # the inlet ramp half way up (1000 steps)
    state_j, _ = tc.make_run(scene, 20)(init)
    check_rounds_predict(scene, state_j, "400x132 js quick rounds route", results)
    args = rounds_args(scene, state_j)
    got, ref = solve_correct_rounds(*args), solve_correct_rounds_plain(*args)
    counts, ref_counts = got[5].tolist(), ref[5].tolist()
    require(counts == ref_counts, f"rounds (JS): the kernel ran {counts} (outer "
            f"rounds, sweeps), the plain version {ref_counts}")
    require(counts[0] == 0, f"rounds (JS): {counts[0]} outer rounds ran")
    demean = lambda a, b: a - (a - b).mean()
    entry = record(results, "rounds", "js quick parabolic 400x132", [
        ("u", got[0], ref[0], 5e-5 + 1e-4 * float(ref[0].abs().max())),
        ("v", got[1], ref[1], 5e-5 + 1e-4 * float(ref[1].abs().max())),
        ("p-mean", demean(got[2], ref[2]), ref[2], scaled(ref[2], 1e-4)),
        ("p'-mean", demean(got[3], ref[3]), ref[3], scaled(ref[3], 1e-4))],
        lambda: solve_correct_rounds(*args), lambda: solve_correct_rounds_plain(*args),
        bound(nbytes(*args[:5], *got[:4], *masks_traced(gj, js, dev)[2:]),
              (counts[1] * (SWEEP + SWEEP_ERR) + DIV_CORRECT) * gj.nx * gj.ny),
        n=10, n_plain=3)
    entry["sweeps"] = counts[1]
    print(f"[3] rounds (JS): {counts[1]} sweeps, no outer round, on both sides",
          flush=True)
    check_rounds_forms(args, got, "400x132 js", results)

    # correct_div on the reference-mode state: what the first outer round
    # of the next step gets (u*, v* of the predictor, p and the solve's p').
    scene = reference_mode_scene(2048, "pallas")
    g = scene.grid
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    dt = state.dt
    u_star, v_star, _ = predict_div(state.u, state.v, dt, state.nu, g,
                                    scene.params.velocity_scheme, scene.opts.semantics)
    args = (u_star, v_star, state.p, state.p_prime, dt, g)
    got, ref = correct_div(*args), correct_div_plain(*args)
    uv_scale = max(1.0, float(ref[0].abs().max()), float(ref[1].abs().max()))
    compare("correct_div", [
        ("u", got[0], ref[0], scaled(ref[0], 1e-6)),
        ("v", got[1], ref[1], scaled(ref[1], 1e-6)),
        ("p", got[2], ref[2], scaled(ref[2], 1e-6)),
        ("rhs", got[3], ref[3], 4 * EPS32 * uv_scale * (1 / g.dx + 1 / g.dy) / float(dt))],
        results, (time_ms(lambda: correct_div(*args), 20),
                  time_ms(lambda: correct_div_plain(*args), 5)),
        bound(nbytes(*args[:4], *got), CORRECT_DIV * g.nx * g.ny))


def check_cavity_kernels(dev, results):
    """Kernels 2, 3 and 4's CAVITY instances where the cavity paths launch
    them, each under its kernel's "variants" beside its channel twin's
    time on the same inputs. On the 2048^2 cavity fast state after 3
    steps: kernel 2 at k = 16 against the plain sweeps with the cavity
    BCs, and bit for bit against the whole field's folded twin at k = 16
    and at a k its sweeps a launch do not divide; kernel 3 with the
    UNIFORM and the parabolic lid. Kernel 4's cluster form on the 512^2
    cavity (BASELINE config 2) after 20 steps, its slab form on the
    1024^2 one after 20, each fed what the rounds route feeds it (kernel
    1's output, kernel 1 first held against its plain version on the same
    state), the same rounds and sweeps as the plain version required, and
    the forms against each other where more than one applies."""
    scene = cavity_fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    u, v, dt, nu = state.u, state.v, state.dt, state.nu
    inlet = ramped_inlet(opts, state)
    sem, om, cells = opts.semantics, opts.jacobi_omega, g.nx * g.ny
    u_star, v_star, rhs = predict_div(u, v, dt, nu, g, scene.params.velocity_scheme, sem)
    pp, k = state.p_prime, 16
    call = lambda: jacobi_fused_k(pp, rhs, g.dx, g.dy, om, k, cavity=True)
    plain = lambda: jacobi_fused_k_plain(pp, rhs, g.dx, g.dy, om, k, _apply_pprime_bcs_cavity)
    got, ref = call(), plain()
    entry = record(results, "jacobi_fused_k", "cavity 2048^2", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("err", got[1], ref[1], scaled(ref[0], 1e-5))], call, plain,
        bound(nbytes(pp, rhs, got[0]), k * (SWEEP + SWEEP_ERR) * cells), n=10, n_plain=3)
    entry["channel_ms"] = time_ms(lambda: jacobi_fused_k(pp, rhs, g.dx, g.dy, om, k), 10)
    for kk in (16, jacobi_tile()["sweeps"] + 5):
        a = jacobi_fused_k(pp, rhs, g.dx, g.dy, om, kk, cavity=True)
        b = jacobi_fused_k_folded(pp, rhs, g.dx, g.dy, om, kk, cavity=True)
        d = max(max_abs(a[0], b[0]), max_abs(a[1], b[1]))
        require(d == 0.0, f"jacobi_fused_k cavity: k={kk} differs from the folded twin by {d}")
    print(f"[3] jacobi_fused_k cavity: equals the whole field's folded twin bit for bit "
          f"at k=16 and k={jacobi_tile()['sweeps'] + 5}; {entry['ms']:.4f} ms against the "
          f"channel instance's {entry['channel_ms']:.4f} on the same inputs", flush=True)
    pp = got[0]
    for prof in (tc.InletProfile.UNIFORM, tc.InletProfile.PARABOLIC):
        args = (u_star, v_star, state.p, pp, u, v, dt, inlet, g, prof, tc.FlowCase.CAVITY,
                sem)
        got, ref = correct_bc(*args), correct_bc_plain(*args)
        entry = record(results, "correct_bc", f"cavity {prof.value}", [
            (lb, a, b, scaled(b, 1e-6))
            for lb, a, b in zip(("u", "v", "p", "res_u", "res_v", "max_vel"), got, ref)],
            lambda: correct_bc(*args), lambda: correct_bc_plain(*args),
            bound(nbytes(*args[:6], *got[:3]), 20 * cells))
        channel = args[:10] + (tc.FlowCase.CHANNEL, sem)
        entry["channel_ms"] = time_ms(lambda: correct_bc(*channel), 20)
        # CUDA events time the wrapper's host cost here: the device's own
        # time a launch, from torch.profiler, beside the channel instance's
        entry["device_us"] = device_us(lambda: correct_bc(*args), 20, "correct_bc")
        entry["channel_device_us"] = device_us(lambda: correct_bc(*channel), 20,
                                               "correct_bc")
        print(f"[3] correct_bc cavity {prof.value}: device {entry['device_us']:.2f} us a "
              f"launch, the channel instance {entry['channel_device_us']:.2f}", flush=True)

    for n, steps, form in ((512, 20, "cluster"), (1024, 20, "slab")):
        scene = cavity_scene(n)
        state, _ = tc.make_run(scene, steps)(scene.init_state(dev))
        check_rounds_predict(scene, state, f"cavity {n}^2 rounds route", results)
        args = rounds_args(scene, state)
        taken = plan("rounds", 1, n, n, dev, cavity=True).form
        require(taken == form, f"rounds cavity {n}^2: the plan takes the {taken} form, "
                f"expected the {form} form")
        n_cluster, n_slab = (solve_correct_rounds.cluster_launches,
                             solve_correct_rounds.slab_launches)
        got, ref = solve_correct_rounds(*args), solve_correct_rounds_plain(*args)
        require((solve_correct_rounds.cluster_launches - n_cluster,
                 solve_correct_rounds.slab_launches - n_slab)
                == (int(form == "cluster"), int(form == "slab")),
                f"rounds cavity {n}^2: the {form} form was not the one launched")
        counts, ref_counts = got[5].tolist(), ref[5].tolist()
        require(counts == ref_counts, f"rounds cavity {n}^2: the kernel ran {counts} "
                f"(outer rounds, sweeps), the plain version {ref_counts}")
        demean = lambda a, b: a - (a - b).mean()
        entry = record(results, "rounds", f"cavity {n}^2 {form}", [
            ("u", got[0], ref[0], 5e-5 + 1e-4 * float(ref[0].abs().max())),
            ("v", got[1], ref[1], 5e-5 + 1e-4 * float(ref[1].abs().max())),
            ("p-mean", demean(got[2], ref[2]), ref[2], scaled(ref[2], 1e-4)),
            ("p'-mean", demean(got[3], ref[3]), ref[3], scaled(ref[3], 1e-4))],
            lambda: solve_correct_rounds(*args), lambda: solve_correct_rounds_plain(*args),
            bound(nbytes(*args[:5], *got[:4]),
                  (counts[1] * (SWEEP + SWEEP_ERR) + (counts[0] + 1) * DIV_CORRECT) * n * n),
            n=5, n_plain=2)
        entry.update({"rounds": counts[0], "sweeps": counts[1],
                      "us_a_sweep": 1e3 * entry["ms"] / counts[1]})
        print(f"[3] rounds cavity {n}^2: {counts[0]} outer rounds, {counts[1]} sweeps on "
              f"both sides ({form} form, {entry['us_a_sweep']:.3f} us a sweep)", flush=True)
        check_rounds_forms(args, got, f"cavity {n}^2", results)


def check_cavity_mgp_kernels(dev, results):
    """The CAVITY instances of kernels 6-9, 18 (its ring) and 19 where the
    cavity production paths launch them, each a line of its own in the
    kernels' JSON line, at the tolerances check_mgp_kernels and
    check_mg_kernels state for the channel instances, and timed beside
    the channel instance on the same inputs ("channel_ms"). The cavity
    app's constants with MG_PRODUCTION: on the 2048^2 state after 3 steps
    (p' and the next rhs, as the fused route feeds them), kernel 7 at
    k = 3, kernel 9 (east_dirichlet False) on the 1023^2 first coarse
    level it gives, with and without the residual, and kernel 8 fed the
    cycle's own all-Neumann correction; kernel 6 on the 2047^2 state after
    3 steps; on the 2048^2 legacy state after 3 steps, kernel 19 at k = 3
    (and on the 128^2 level, in one block) and kernel 18 with the cavity
    ring, fed the legacy cycle's own coarse correction."""
    def record_cavity(line, pairs, call, plain, channel, bnd, n=20):
        compare(line, pairs, results, (time_ms(call, n), time_ms(plain, 5)), bnd)
        results[line]["channel_ms"] = time_ms(channel, n)
        print(f"[3] {line}: {results[line]['ms']:.4f} ms against the channel instance's "
              f"{results[line]['channel_ms']:.4f} on the same inputs", flush=True)

    def fine_state(scene):
        state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
        g = scene.grid
        rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                          scene.params.velocity_scheme, scene.opts.semantics)[2]
        return state.p_prime, rhs, g.dx, g.dy

    scene = cavity_production_scene()
    opts = scene.opts
    om, k = opts.jacobi_omega, opts.mgp_smooth
    pp, rhs, dx, dy = fine_state(scene)
    denom, cells = 2 / dx ** 2 + 2 / dy ** 2, pp.numel()
    got = mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, om, k, cavity=True)
    ref = mgp.jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, om, k, cavity=True)
    tol = res_floor(ref[0], rhs, denom)
    record_cavity("jacobi_fused_k_restrict cavity", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("r_c", got[1], ref[1], tol), ("max|r|", got[2], ref[2], tol)],
        lambda: mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, om, k, cavity=True),
        lambda: mgp.jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, om, k, cavity=True),
        lambda: mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, om, k),
        bound(nbytes(pp, rhs, got[0], got[1]), (k * SWEEP + RES + RES_MAX + RESTRICT) * cells))
    p2, r_c = got[0], got[1]

    z = torch.zeros_like(r_c)
    cc_args = (2 * dx, 2 * dy, om, k, 1.5 * dx)
    got_c = mgp.cc_sweeps(z, r_c, *cc_args, True, east_dirichlet=False)
    ref_c = mgp.cc_sweeps_plain(z, r_c, *cc_args, True, east_dirichlet=False)
    record_cavity("cc_sweeps cavity", [
        ("e", got_c[0], ref_c[0], scaled(ref_c[0], 1e-5)),
        ("r", got_c[1], ref_c[1], res_floor(ref_c[0], r_c, 2 / (2 * dx) ** 2 + 2 / (2 * dy) ** 2))],
        lambda: mgp.cc_sweeps(z, r_c, *cc_args, True, east_dirichlet=False),
        lambda: mgp.cc_sweeps_plain(z, r_c, *cc_args, True, east_dirichlet=False),
        lambda: mgp.cc_sweeps(z, r_c, *cc_args, True),
        bound(nbytes(z, r_c, *got_c), (k * CC_SWEEP + RES) * r_c.numel()))
    results["cc_sweeps cavity"]["ms_no_residual"] = time_ms(
        lambda: mgp.cc_sweeps(z, r_c, *cc_args, False, east_dirichlet=False), 20)

    e_c = _cc_vcycle(r_c, 2 * dx, 2 * dy, opts, 1.5 * dx, _smoothers(opts), False)
    row = _cc_prolong_x(e_c, scene.grid.nx - 2, False).contiguous()
    got = mgp.jacobi_fused_k_corr(p2, rhs, row, dx, dy, om, k, cavity=True)
    ref = mgp.jacobi_fused_k_corr_plain(p2, rhs, row, dx, dy, om, k, cavity=True)
    require(float(got[0][0, 0]) == 0.0, "jacobi_fused_k_corr cavity: (0, 0) is not 0")
    record_cavity("jacobi_fused_k_corr cavity", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("max|r|", got[1], ref[1], res_floor(ref[0], rhs, denom)),
        ("max|p'|", got[2], ref[2], scaled(ref[0], 1e-5))],
        lambda: mgp.jacobi_fused_k_corr(p2, rhs, row, dx, dy, om, k, cavity=True),
        lambda: mgp.jacobi_fused_k_corr_plain(p2, rhs, row, dx, dy, om, k, cavity=True),
        lambda: mgp.jacobi_fused_k_corr(p2, rhs, row, dx, dy, om, k),
        bound(nbytes(p2, rhs, row, got[0]), (CORR_ADD + k * SWEEP + RES + 2 * RES_MAX) * cells))

    pp, rhs, dx, dy = fine_state(cavity_production_scene(2047))
    got = mgp.jacobi_fused_k_res(pp, rhs, dx, dy, om, k, True, cavity=True)
    ref = mgp.jacobi_fused_k_res_plain(pp, rhs, dx, dy, om, k, True, cavity=True)
    tol = res_floor(ref[0], rhs, 2 / dx ** 2 + 2 / dy ** 2)
    record_cavity("jacobi_fused_k_res cavity", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("r", got[1], ref[1], tol), ("max|r|", got[2], ref[2], tol)],
        lambda: mgp.jacobi_fused_k_res(pp, rhs, dx, dy, om, k, True, cavity=True),
        lambda: mgp.jacobi_fused_k_res_plain(pp, rhs, dx, dy, om, k, True, cavity=True),
        lambda: mgp.jacobi_fused_k_res(pp, rhs, dx, dy, om, k, True),
        bound(nbytes(pp, rhs, got[0], got[1]), (k * SWEEP + RES + RES_MAX) * pp.numel()))

    scene = cavity_production_scene(mgp_scheme="legacy")
    pp, rhs, dx, dy = fine_state(scene)
    ar_rhs = om * float(rhs.abs().max()) / (2 / dx ** 2 + 2 / dy ** 2)
    got = kmg.mgp_smooth(pp, rhs, dx, dy, om, k, cavity=True)
    ref = kmg.mgp_smooth_plain(pp, rhs, dx, dy, om, k, cavity=True)
    require(float(got[0, 0]) == 0.0, "mgp_smooth cavity: (0, 0) is not 0")
    record_cavity("mgp_smooth cavity", [("p'", got, ref, sweep_tol(k, ref, ar_rhs))],
                  lambda: kmg.mgp_smooth(pp, rhs, dx, dy, om, k, cavity=True),
                  lambda: kmg.mgp_smooth_plain(pp, rhs, dx, dy, om, k, cavity=True),
                  lambda: kmg.mgp_smooth(pp, rhs, dx, dy, om, k),
                  bound(nbytes(pp, rhs, got), k * SWEEP * pp.numel()))
    r128, dx128, dy128 = coarse_levels(rhs, dx, dy, 4)
    z = torch.zeros_like(r128)
    got = kmg.mgp_smooth(z, r128, dx128, dy128, om, k, cavity=True)
    ref = kmg.mgp_smooth_plain(z, r128, dx128, dy128, om, k, cavity=True)
    ar128 = om * float(r128.abs().max()) / (2 / dx128 ** 2 + 2 / dy128 ** 2)
    d, tol = max_abs(got, ref), sweep_tol(k, ref, ar128)
    require(bool(torch.isfinite(got).all()) and d <= tol,
            f"mgp_smooth cavity, the 128^2 level: max|d| {d} > {tol}")
    entry = results["mgp_smooth cavity"]
    entry["max_abs_err"] = max(entry["max_abs_err"], d)
    entry["ms_128_one_block"] = time_ms(
        lambda: kmg.mgp_smooth(z, r128, dx128, dy128, om, k, cavity=True), 20)
    entry["channel_ms_128_one_block"] = time_ms(
        lambda: kmg.mgp_smooth(z, r128, dx128, dy128, om, k), 20)
    print(f"[3] mgp_smooth cavity on the 128^2 level, k={k} (one block): max|d|={d:.3e} "
          f"(tol {tol:.1e}); {entry['ms_128_one_block']:.4f} ms, channel "
          f"{entry['channel_ms_128_one_block']:.4f}", flush=True)

    r_c = kmg.mg_residual_restrict(pp, rhs, dx, dy)
    e = _mgp_vcycle(torch.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts, _mg_kit(opts),
                    _apply_pprime_bcs_cavity)
    got = kmg.mg_prolong_add(e, pp, True, cavity=True)
    ref = kmg.mg_prolong_add_plain(e, pp, True, cavity=True)
    record_cavity("mg_prolong_add cavity", [("p + e", got, ref, ulp_tol(ref))],
                  lambda: kmg.mg_prolong_add(e, pp, True, cavity=True),
                  lambda: kmg.mg_prolong_add_plain(e, pp, True, cavity=True),
                  lambda: kmg.mg_prolong_add(e, pp, True),
                  bound(nbytes(e, pp, got), MG_PROLONG * pp.numel()))


def check_multigrid_solve(dev, report):
    """One MULTIGRID solve (mg_cycles V-cycles, ops/poisson.py multigrid)
    from the same (p'0, rhs) on the card and on the CPU: the 2048^2
    multigrid state after 3 steps and its next rhs. The cycles do not
    converge, so each run's p' carries its own roundings; max|d| of p' is
    held to the sum, over the launches the solve makes, of each launch's
    tolerance as phase 3 states it for that kernel (sweep_tol for a
    smoother, res_floor for a residual-restriction, ulp_tol for a
    prolongation), computed from the CPU run's own operands."""
    scene = multigrid_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                      scene.params.velocity_scheme, opts.semantics)[2]
    reset_counts()
    got = multigrid(state.p_prime, rhs, g.dx, g.dy, opts)[0]
    torch.cuda.synchronize()
    ran = {k: c for k, c in read_counts().items() if c}
    require(set(ran) == {"mg_smooth", *VERTEX},
            f"multigrid solve: launched {ran}")
    total, n = [0.0], dict.fromkeys(ran, 0)

    def smooth(p, r, dx, dy, k):
        out = kmg.mg_smooth_plain(p, r, dx, dy, k)
        total[0] += sweep_tol(k, out, float(r.abs().max()) / (2 / dx ** 2 + 2 / dy ** 2))
        n["mg_smooth"] += 1
        return out

    def restrict(p, r, dx, dy):
        total[0] += res_floor(p, r, 2 / dx ** 2 + 2 / dy ** 2)
        n["mg_residual_restrict"] += 1
        return kmg.mg_residual_restrict_plain(p, r, dx, dy)

    def prolong(e, p, bc):
        out = kmg.mg_prolong_add_plain(e, p, bc)
        total[0] += ulp_tol(out)
        n["mg_prolong_add"] += 1
        return out

    kit = MgKit(smooth, restrict, prolong, None)
    rhs_cpu = rhs.cpu()
    ref = torch.zeros_like(rhs_cpu)
    for _ in range(opts.mg_cycles):
        ref = _mg_vcycle(ref, rhs_cpu, g.dx, g.dy, opts, kit)
    require(n == ran, f"multigrid solve: the card launched {ran}, the CPU run {n}")
    d = max_abs(got.cpu(), ref)
    dd = (got.cpu() - ref).double()
    l2_dm = float(torch.sqrt(torch.mean((dd - dd.mean()) ** 2)))
    pmax = float(ref.abs().max())
    report["multigrid_one_solve"] = {"max_abs_d": d, "bound": total[0],
                                     "l2_demeaned_d": l2_dm, "max_abs_p": pmax,
                                     "launches": ran}
    print(f"[3] multigrid, one solve ({opts.mg_cycles} V-cycles) from the same (p'0, "
          f"rhs) on the card and the CPU at 2048^2: p' max|d|={d:.3e} (bound "
          f"{total[0]:.3e}, the summed tolerances of {sum(ran.values())} launches), "
          f"mean-removed L2 {l2_dm:.3e}, max|p'| {pmax:.3e}", flush=True)
    require(bool(torch.isfinite(got).all()), "multigrid solve: p' not finite")
    require(d <= total[0], f"multigrid solve: p' max|d| {d} > {total[0]}")


def same_bits(a, b) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def check_parent_form(name, label, got, parent, ctas, times, results):
    """The route's cluster form (``got``, ``ctas`` CTAs a scene) against
    the parent form on the same inputs: every output, counts included,
    to the bit. Records both times (``times``: cluster ms, parent ms)."""
    require(same_bits(got, parent), f"{name} {label}: the cluster form and the parent "
            f"form differ (max|d| {max(max_abs(a, b) for a, b in zip(got, parent))})")
    entry = results[name].setdefault("forms", {})
    entry.update({"ctas": ctas, label + "_cluster_ms": times[0],
                  label + "_parent_form_ms": times[1]})
    print(f"[3] {name} {label}: the route takes the cluster form, {ctas} CTAs a scene, "
          f"the same bits and counts as the parent form; cluster {times[0]:.4f} ms, "
          f"parent form {times[1]:.4f} ms", flush=True)


def check_ensemble_kernels(dev, results):
    """Kernels 20 and 12 on the ensembles' own states: the whole-substep
    kernel on the 64x256x96 ensemble after 20 steps, fed what the step
    feeds it; the batched Jacobi kernel on the next rhs of the 8x800x264
    ensemble after 5 steps. Both exits are exact on both sides, so each
    scene must run the same sweeps (and rounds) as the plain version.
    Each route's cluster form is also held to its parent form (the block
    form, the cooperative form) bit for bit, with and without done flags
    for kernel 12."""
    scene = ensemble_scene()
    g = scene.grid
    state, _ = tc.make_run(scene, 20)(ensemble_state(scene, 64, dev))
    args = ensemble_args(scene, state)
    got = substep_batch(*args)
    ref = substep_batch_plain(*args)
    counts, ref_counts = got[5].cpu(), ref[5].cpu()
    require(torch.equal(counts, ref_counts), f"substep_batch: the kernel ran "
            f"{counts.tolist()} (rounds, sweeps per scene), the plain version "
            f"{ref_counts.tolist()}")
    err_k, err_p = got[4].cpu().double(), ref[4].cpu().double()
    require(bool(torch.allclose(err_k, err_p, rtol=1e-2, atol=0)),
            f"substep_batch: err {err_k.tolist()} vs plain {err_p.tolist()}")
    rounds, sweeps = (int(x) for x in counts.sum(dim=0))
    print(f"[3] substep_batch 64x256x96: the same exits on both sides, per scene "
          f"{int(counts[:, 0].min())}-{int(counts[:, 0].max())} rounds and "
          f"{int(counts[:, 1].min())}-{int(counts[:, 1].max())} sweeps ({sweeps} "
          f"sweeps in all)", flush=True)
    demean = lambda a, b: a - (a - b).mean(dim=(-2, -1), keepdim=True)
    cells = g.nx * g.ny
    # u and v at the rounds kernel's bound; p and p' per scene with the
    # mean difference removed (the rounds row explains why).
    compare("substep_batch", [
        ("u", got[0], ref[0], 5e-5 + 1e-4 * float(ref[0].abs().max())),
        ("v", got[1], ref[1], 5e-5 + 1e-4 * float(ref[1].abs().max())),
        ("p-mean", demean(got[2], ref[2]), ref[2], scaled(ref[2], 1e-4)),
        ("p'-mean", demean(got[3], ref[3]), ref[3], scaled(ref[3], 1e-4))],
        results,
        (time_ms(lambda: substep_batch(*args), 5, warmup=1),
         time_ms(lambda: substep_batch_plain(*args), 2, warmup=1)),
        # this state's sweeps and rounds, and every scene's predictor
        bound(nbytes(*args[:4], *got),
              (sweeps * (SWEEP + SWEEP_ERR) + (rounds + 64) * DIV_CORRECT
               + 64 * PREDICT) * cells))
    results["substep_batch"]["sweeps_per_scene"] = counts[:, 1].tolist()
    results["substep_batch"]["rounds_per_scene"] = counts[:, 0].tolist()
    check_parent_form("substep_batch", "64x256x96", got,
                      substep_batch(*args, form="block"),
                      plan("substep_batch", 64, g.ny, g.nx, dev).ctas,
                      (results["substep_batch"]["ms"],
                       time_ms(lambda: substep_batch(*args, form="block"), 5, warmup=1)),
                      results)

    scene = ensemble_scene(800, 264)
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 5)(ensemble_state(scene, 8, dev))
    rhs = predict_div_plain(state.u, state.v, state.dt, state.nu, g,
                            scene.params.velocity_scheme, opts.semantics)[2]
    jargs = (state.p_prime, rhs, g.dx, g.dy, opts.jacobi_omega, opts.jacobi_tol,
             opts.jacobi_iters)
    got = jacobi_batch(*jargs)
    ref = jacobi_batch_plain(*jargs)
    n, n_ref = got[2].cpu(), ref[2].cpu()
    require(torch.equal(n, n_ref), f"jacobi_batch: the kernel ran {n.tolist()} "
            f"sweeps per scene, the plain version {n_ref.tolist()}")
    print(f"[3] jacobi_batch 8x800x264: sweeps per scene {n.tolist()} on both "
          f"sides", flush=True)
    compare("jacobi_batch", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("err", got[1], ref[1], scaled(ref[0], 1e-5))], results,
        (time_ms(lambda: jacobi_batch(*jargs), 10),
         time_ms(lambda: jacobi_batch_plain(*jargs), 3)),
        bound(nbytes(state.p_prime, rhs, got[0]),
              int(n.sum()) * (SWEEP + SWEEP_ERR) * g.nx * g.ny))
    results["jacobi_batch"]["sweeps_per_scene"] = n.tolist()
    coop = lambda **kw: jacobi_batch(*jargs, form="cooperative", **kw)
    check_parent_form("jacobi_batch", "8x800x264", got, coop(),
                      plan("jacobi_batch", 8, g.ny, g.nx, dev).ctas,
                      (results["jacobi_batch"]["ms"], time_ms(coop, 10)), results)
    # As a masked outer round calls it: the scenes flagged done are not
    # swept, and with all of them flagged the launch sweeps nothing.
    done = torch.arange(8, device=dev) % 2 == 0
    got = jacobi_batch(*jargs, done=done)
    require(same_bits(got, coop(done=done)),
            "jacobi_batch with done flags: the cluster form and the cooperative form differ")
    ref = jacobi_batch_plain(*jargs, done=done)
    require(got[2].tolist() == ref[2].tolist() == torch.where(done.cpu(), 0, n).tolist(),
            f"jacobi_batch with done flags: the kernel ran {got[2].tolist()} sweeps, "
            f"the plain version {ref[2].tolist()}")
    require(bool(torch.equal(got[0][done], state.p_prime[done])),
            "jacobi_batch: a scene flagged done was changed")
    d = max_abs(got[0], ref[0])
    require(d <= scaled(ref[0], 1e-5), f"jacobi_batch with done flags: p' max|d| {d}")
    # What a round costs once few scenes are left: every scene flagged, and
    # all but the last (nu 1e-2, the one that runs the most rounds).
    every = torch.ones_like(done)
    ms_done = time_ms(lambda: jacobi_batch(*jargs, done=every), 10)
    all_done = jacobi_batch(*jargs, done=every)
    require(all_done[2].sum().item() == 0, "jacobi_batch: a launch with every scene done swept")
    require(same_bits(all_done, coop(done=every)), "jacobi_batch with every scene done: "
            "the cluster form and the cooperative form differ")
    ms_done_coop = time_ms(lambda: coop(done=every), 10)
    last = every.clone()
    last[-1] = False
    ms_last = time_ms(lambda: jacobi_batch(*jargs, done=last), 10)
    ms_last_coop = time_ms(lambda: coop(done=last), 10)
    results["jacobi_batch"]["ms_all_done"] = ms_done
    results["jacobi_batch"]["ms_last_scene_only"] = ms_last
    results["jacobi_batch"]["forms"].update(
        {"all_done_parent_form_ms": ms_done_coop, "last_scene_only_parent_form_ms": ms_last_coop})
    print(f"[3] jacobi_batch with scenes 0, 2, 4, 6 flagged done: sweeps "
          f"{got[2].tolist()} on both sides, p' max|d|={d:.3e}, the cooperative form's "
          f"bits; a launch with every scene done {ms_done:.4f} ms (cooperative "
          f"{ms_done_coop:.4f}), with only scene 7 active {ms_last:.4f} ms (cooperative "
          f"{ms_last_coop:.4f}; {int(n[-1])} sweeps)", flush=True)
    # The step takes this batch to kernel 20's cluster form (one launch a
    # substep): against the route it replaced on the same inputs (the plain
    # predictor, kernel 12, the masked rounds), the same rounds per scene,
    # the sweeps one a solve apart at most (ROADMAP.md section 3's knife
    # edge), the fields at the 64x256x96 check's bounds; both timed.
    args = ensemble_args(scene, state)
    route = plan("substep_batch", 8, g.ny, g.nx, dev)
    require(route is not None, "substep_batch: the card admits no cluster for 8x800x264")
    ctas = route.ctas
    got = substep_batch(*args)
    old = _substep_jnp(scene, *args[:7])
    n, n_old = got[5].cpu(), old[5].cpu()
    require(n[:, 0].tolist() == n_old[:, 0].tolist()
            and bool(((n[:, 1] - n_old[:, 1]).abs() <= n_old[:, 0] + 1).all()),
            f"substep_batch 8x800x264: the kernel ran {n.tolist()} (rounds, sweeps per "
            f"scene), kernel 12's route {n_old.tolist()}")
    demean = lambda a, b: a - (a - b).mean(dim=(-2, -1), keepdim=True)
    diffs = {"u": (max_abs(got[0], old[0]), 5e-5 + 1e-4 * float(old[0].abs().max())),
             "v": (max_abs(got[1], old[1]), 5e-5 + 1e-4 * float(old[1].abs().max())),
             "p-mean": (max_abs(demean(got[2], old[2]), old[2]), scaled(old[2], 1e-4)),
             "p'-mean": (max_abs(demean(got[3], old[3]), old[3]), scaled(old[3], 1e-4))}
    for f, (d, tol) in diffs.items():
        require(d <= tol, f"substep_batch 8x800x264: {f} max|d| {d} > {tol} against "
                f"kernel 12's route")
    ms = time_ms(lambda: substep_batch(*args), 5, warmup=1)
    ms_old = time_ms(lambda: _substep_jnp(scene, *args[:7]), 5, warmup=1)
    results["substep_batch"]["8x800x264"] = {
        "ctas": ctas, "ms": ms, "kernel12_route_ms": ms_old,
        "rounds_per_scene": n[:, 0].tolist(), "sweeps_per_scene": n[:, 1].tolist(),
        "max_abs_vs_kernel12_route": {f: d for f, (d, _) in diffs.items()}}
    print(f"[3] substep_batch 8x800x264: the cluster form, {ctas} CTAs a scene, against "
          f"kernel 12's route: rounds {n[:, 0].tolist()} on both sides, sweeps "
          f"{n[:, 1].tolist()} (kernel 12's route {n_old[:, 1].tolist()}), "
          + ", ".join(f"{f} max|d|={d:.3e}" for f, (d, _) in diffs.items())
          + f"; {ms:.4f} ms a substep against {ms_old:.4f}", flush=True)


def check_sor_kernels(dev, results, report):
    """Kernels 15, 13 and 20's SOR form on their paths' own states: the
    colour-split kernel on the 2048^2 SOR state after 3 steps with the
    next rhs, at k = 8 (the chain's) and k = 10 (its folded last launch);
    the full-layout kernel on the 2047^2 one; kernel 20's SOR form on the
    16x256x96 SOR ensemble after 20 steps, the same per-scene exits
    required. Then one substep of that form and of the plain batched SOR
    at B = 16 and B = 64, the reading behind the port's gate."""
    for n, name in ((2048, "sor_fused_k_rb2"), (2047, "sor_fused_k")):
        scene = sor_scene(n)
        g, opts = scene.grid, scene.opts
        om = opts.sor_omega
        state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
        rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                          scene.params.velocity_scheme, opts.semantics)[2]
        pp = state.p_prime
        cells = pp.numel()
        ks = (8, 10) if name == "sor_fused_k_rb2" else (8,)
        for k in ks:
            if name == "sor_fused_k_rb2":
                split = ksor.sor_compress(pp) + ksor.sor_compress(rhs)
                call = lambda: ksor.sor_fused_k_rb2(*split, g.dx, g.dy, om, k)
                plain = lambda: ksor.sor_fused_k_rb2_plain(*split, g.dx, g.dy, om, k)
                got, ref = call(), plain()
                labels = (("red", 0), ("black", 1), ("err", 2))
                moved = nbytes(*split, got[0], got[1])
            else:
                call = lambda: ksor.sor_fused_k(pp, rhs, g.dx, g.dy, om, k)
                plain = lambda: ksor.sor_fused_k_plain(pp, rhs, g.dx, g.dy, om, k)
                got, ref = call(), plain()
                labels = (("p'", 0), ("err", 1))
                moved = nbytes(pp, rhs, got[0])
            # The kernels fold the divisions into f32 multipliers as the TPU
            # kernels do; omega = 1.7 carries those ulps over k iterations.
            scale = scaled(ref[0], 1e-5)
            key = name if k == 8 else f"{name}_k{k}"
            compare(key, [(lb, got[i], ref[i], scale) for lb, i in labels], results,
                    (time_ms(call, 10), time_ms(plain, 3)),
                    bound(moved, (k * SOR_ITER + SWEEP_ERR) * cells))
        if name == "sor_fused_k_rb2":
            k10 = results.pop(f"{name}_k10")
            results[name]["ms_k10"] = k10["ms"]
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               k10["max_abs_err"])
            # the full layout on the same state: what the colour split buys
            full = time_ms(lambda: ksor.sor_fused_k(pp, rhs, g.dx, g.dy, om, 8), 10)
            results[name]["full_layout_ms"] = full
            print(f"[3] sor_fused_k on the same 2048^2 state, k = 8: {full:.4f} ms",
                  flush=True)

    results.update(check_sor_ensemble(dev, report))


def same_arithmetic(scene, args):
    """Kernel 20's SOR solve against the full-layout kernel, which shares
    its multipliers and order of operations: one substep without outer
    rounds at tol = 0 and 50 iterations, each scene's p' against
    sor_fused_k on the plain predictor's rhs. They differ by the
    predictor's last bits alone (1e-6 of max|p'| measured on an NVIDIA
    H100 80GB HBM3, 700 W; PERF.md)."""
    g, opts = scene.grid, scene.opts
    fixed = dataclasses.replace(scene, opts=dataclasses.replace(
        opts, jacobi_tol=0.0, jacobi_iters=50, outer_corrector_rounds=0))
    u, v, _, pp0, dt, nu = args[:6]
    got = substep_batch_sor(*args[:7], fixed)[3]
    rhs = predict_div_plain(u, v, dt, nu, g, scene.params.velocity_scheme,
                            opts.semantics)[2]
    want = torch.stack([ksor.sor_fused_k(pp0[b].contiguous(), rhs[b].contiguous(),
                                         g.dx, g.dy, opts.sor_omega, 50)[0]
                        for b in range(pp0.shape[0])])
    d, tol = max_abs(got, want), scaled(want, 1e-5)
    require(d <= tol, f"substep_batch_sor against sor_fused_k: p' max|d| {d} > {tol}")
    print(f"[3] substep_batch_sor, 50 iterations, no rounds, against sor_fused_k "
          f"(the same multipliers): p' max|d|={d:.3e} (tol {tol:.1e})", flush=True)


def check_sor_ensemble(dev, report):
    scene = sor_ensemble_scene()
    g = scene.grid
    out = {}
    timing = {}
    for B in (16, 64):
        state, _ = tc.make_run(scene, 20)(ensemble_state(scene, B, dev))
        args = ensemble_args(scene, state)
        got = substep_batch_sor(*args)
        ref = substep_batch_plain(*args)
        counts, ref_counts = got[5].cpu(), ref[5].cpu()
        require(torch.equal(counts, ref_counts), f"substep_batch_sor B={B}: the kernel "
                f"ran {counts.tolist()} (rounds, iterations per scene), the plain "
                f"version {ref_counts.tolist()}")
        block = substep_batch_sor(*args, form="block")
        require(same_bits(got, block), f"substep_batch_sor B={B}: the cluster form and "
                f"the block form differ")
        ms = time_ms(lambda: substep_batch_sor(*args), 5, warmup=1)
        block_ms = time_ms(lambda: substep_batch_sor(*args, form="block"), 5, warmup=1)
        plain_ms = time_ms(lambda: substep_batch_plain(*args), 2, warmup=1)
        ctas = plan("substep_batch", B, g.ny, g.nx, dev, sor=True).ctas
        timing[B] = {"ms": ms, "plain_ms": plain_ms, "block_ms": block_ms, "ctas": ctas}
        rounds, iters = (int(x) for x in counts.sum(dim=0))
        print(f"[3] substep_batch_sor {B}x256x96 after 20 steps: the same exits on "
              f"both sides, per scene {int(counts[:, 0].min())}-"
              f"{int(counts[:, 0].max())} rounds and {int(counts[:, 1].min())}-"
              f"{int(counts[:, 1].max())} iterations; the cluster form ({ctas} CTAs a "
              f"scene) the block form's bits; kernel {ms:.4f} ms, block form "
              f"{block_ms:.4f} ms, plain batched SOR {plain_ms:.4f} ms "
              f"({plain_ms / ms:.2f}x)", flush=True)
        if B != 16:
            continue
        err_k, err_p = got[4].cpu().double(), ref[4].cpu().double()
        require(bool(torch.allclose(err_k, err_p, rtol=1e-2, atol=0)),
                f"substep_batch_sor: err {err_k.tolist()} vs plain {err_p.tolist()}")
        same_arithmetic(scene, args)
        demean = lambda a, b: a - (a - b).mean(dim=(-2, -1), keepdim=True)
        # u, v and p at the bounds of the Jacobi form (check_ensemble_kernels).
        # p' drifts from the plain version's by the multipliers' rounding,
        # which omega = 1.7 carries on: about 1e-6 max|p'| an iteration
        # (on an NVIDIA H100 80GB HBM3, 700 W: 4.5e-7 after 1 iteration,
        # 3.1e-5 after 50, 1.7e-4 after 200, at max|p'| 0.5-1.5; PERF.md),
        # so twice that a scene's iterations.
        drift = 2e-6 * int(counts[:, 1].max())
        compare("substep_batch_sor", [
            ("u", got[0], ref[0], 5e-5 + 1e-4 * float(ref[0].abs().max())),
            ("v", got[1], ref[1], 5e-5 + 1e-4 * float(ref[1].abs().max())),
            ("p-mean", demean(got[2], ref[2]), ref[2], scaled(ref[2], 1e-4)),
            ("p'-mean", demean(got[3], ref[3]), ref[3], scaled(ref[3], drift))],
            out, (ms, plain_ms),
            bound(nbytes(*args[:4], *got),
                  (iters * (SOR_ITER + SWEEP_ERR) + (rounds + B) * DIV_CORRECT
                   + B * PREDICT) * g.nx * g.ny))
        out["substep_batch_sor"]["iterations_per_scene"] = counts[:, 1].tolist()
        out["substep_batch_sor"]["rounds_per_scene"] = counts[:, 0].tolist()
        out["substep_batch_sor"]["forms"] = {"ctas": ctas, "16x256x96_cluster_ms": ms,
                                             "16x256x96_parent_form_ms": block_ms}
    report["substep_batch_sor_gate"] = timing
    return out


def res_floor(p, rhs, denom) -> float:
    """30 ulps of the residual's f32 cancellation scale
    (tests/test_projection.py:320): a kernel's multipliers and the plain
    version's divisions round its O(denom |p|) terms differently."""
    return 30 * EPS32 * (denom * float(p.abs().max()) + float(rhs.abs().max()))


def check_mgp_kernels(dev, results):
    """Kernels 6-9 on the production path's own states: 2048^2 after 3
    steps for restrict and corr, the 1023^2 level for cc, 2047^2 for res.
    Each fed what the cycle feeds it: p' (BC-consistent) and the rhs of
    the next step, the cycle's own coarse correction for corr."""
    scene = production_scene()
    g, opts = scene.grid, scene.opts
    sch, sem = scene.params.velocity_scheme, opts.semantics
    om, k = opts.jacobi_omega, opts.mgp_smooth
    dx, dy = g.dx, g.dy
    denom = 2 / dx ** 2 + 2 / dy ** 2
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g, sch, sem)[2]
    pp = state.p_prime
    cells = pp.numel()

    got = mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, om, k)
    ref = mgp.jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, om, k)
    tol = res_floor(ref[0], rhs, denom)
    compare("jacobi_fused_k_restrict", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("r_c", got[1], ref[1], tol), ("max|r|", got[2], ref[2], tol)], results,
        (time_ms(lambda: mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, om, k), 20),
         time_ms(lambda: mgp.jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, om, k), 5)),
        bound(nbytes(pp, rhs, got[0], got[1]),
              (k * SWEEP + RES + RES_MAX + RESTRICT) * cells))
    p2, r_c = got[0], got[1]

    # The cc kernel on the first coarse level: h = 2 dx, the wall 1.5 dx
    # from the last centre (ops/poisson.py _mgp_vcycle_aligned).
    z = torch.zeros_like(r_c)
    cc_args = (2 * dx, 2 * dy, om, k, 1.5 * dx)
    denom_c = 2 / (2 * dx) ** 2 + 2 / (2 * dy) ** 2 + (2 / 1.5 - 1) / (2 * dx) ** 2
    timing = {}
    for emit in (True, False):
        got_c = mgp.cc_sweeps(z, r_c, *cc_args, emit)
        ref_c = mgp.cc_sweeps_plain(z, r_c, *cc_args, emit)
        pairs = [("e", got_c[0], ref_c[0], scaled(ref_c[0], 1e-5))]
        if emit:
            pairs.append(("r", got_c[1], ref_c[1], res_floor(ref_c[0], r_c, denom_c)))
        for label, a, b, atol in pairs:
            d = max_abs(a, b)
            require(bool(torch.isfinite(a).all()), f"cc_sweeps: {label} not finite")
            require(d <= atol, f"cc_sweeps (emit_res={emit}): {label} max|d| {d} > {atol}")
        timing[emit] = (time_ms(lambda: mgp.cc_sweeps(z, r_c, *cc_args, emit), 20),
                        time_ms(lambda: mgp.cc_sweeps_plain(z, r_c, *cc_args, emit), 5))
        print(f"[3] cc_sweeps 1023^2 emit_res={emit}: "
              + "; ".join(f"{lb} max|d|={max_abs(a, b):.3e} (tol {t:.1e})"
                          for lb, a, b, t in pairs)
              + f"; kernel {timing[emit][0]:.4f} ms, plain {timing[emit][1]:.4f} ms",
              flush=True)
        if emit:
            worst = max(max_abs(a, b) for _, a, b, _ in pairs)
            results["cc_sweeps"] = {
                "max_abs_err": worst, "ms": timing[True][0], "plain_ms": timing[True][1],
                **bound(nbytes(z, r_c, *got_c), (k * CC_SWEEP + RES) * r_c.numel()),
                "library_ms": None}
    results["cc_sweeps"]["ms_no_residual"] = timing[False][0]

    e_c = _cc_vcycle(r_c, 2 * dx, 2 * dy, opts, 1.5 * dx, _smoothers(opts))
    row = _cc_prolong_x(e_c, g.nx - 2).contiguous()
    got = mgp.jacobi_fused_k_corr(p2, rhs, row, dx, dy, om, k)
    ref = mgp.jacobi_fused_k_corr_plain(p2, rhs, row, dx, dy, om, k)
    tol = res_floor(ref[0], rhs, denom)
    compare("jacobi_fused_k_corr", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("max|r|", got[1], ref[1], tol),
        ("max|p'|", got[2], ref[2], scaled(ref[0], 1e-5))], results,
        (time_ms(lambda: mgp.jacobi_fused_k_corr(p2, rhs, row, dx, dy, om, k), 20),
         time_ms(lambda: mgp.jacobi_fused_k_corr_plain(p2, rhs, row, dx, dy, om, k), 5)),
        bound(nbytes(p2, rhs, row, got[0]),
              (CORR_ADD + k * SWEEP + RES + 2 * RES_MAX) * cells))

    # The res kernel where the main path launches it: an odd grid.
    scene = production_scene(2047)
    g = scene.grid
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g, sch, sem)[2]
    pp = state.p_prime
    got = mgp.jacobi_fused_k_res(pp, rhs, g.dx, g.dy, om, k, True)
    ref = mgp.jacobi_fused_k_res_plain(pp, rhs, g.dx, g.dy, om, k, True)
    tol = res_floor(ref[0], rhs, 2 / g.dx ** 2 + 2 / g.dy ** 2)
    no_res = mgp.jacobi_fused_k_res(pp, rhs, g.dx, g.dy, om, k, False)
    require(no_res[1] is None and bool(torch.equal(no_res[0], got[0]))
            and float(no_res[2]) == float(got[2]),
            "jacobi_fused_k_res: emit_res=False changed p' or max|r|")
    compare("jacobi_fused_k_res", [
        ("p'", got[0], ref[0], scaled(ref[0], 1e-5)),
        ("r", got[1], ref[1], tol), ("max|r|", got[2], ref[2], tol)], results,
        (time_ms(lambda: mgp.jacobi_fused_k_res(pp, rhs, g.dx, g.dy, om, k, True), 20),
         time_ms(lambda: mgp.jacobi_fused_k_res_plain(pp, rhs, g.dx, g.dy, om, k,
                                                      True), 5)),
        bound(nbytes(pp, rhs, got[0], got[1]),
              (k * SWEEP + RES + RES_MAX) * pp.numel()))
    results["jacobi_fused_k_res"]["ms_no_residual"] = time_ms(
        lambda: mgp.jacobi_fused_k_res(pp, rhs, g.dx, g.dy, om, k, False), 20)


def check_fdm(dev, report):
    """The 2048^2 cycle's bottom solve (64^2, h = 32 dx, the wall 16.5 dx
    from the last centre) against an f64 solve with the same bases, with
    TF32 turned on for f32 matmuls: ops/fdm.py's products never take it.
    For contrast, the same f32 products through cuBLAS under that flag."""
    g = production_scene().grid
    args = (32 * g.dx, 32 * g.dy, 16.5 * g.dx)
    r = torch.randn((64, 64), generator=torch.Generator().manual_seed(0))
    qy, qx, s = fdm._fdm_bases(64, 64, *args, torch.device("cpu"))
    qy, qx, s = qy.double(), qx.double(), s.double()
    want = -(qy @ ((qy.T @ r.double() @ qx) * s) @ qx.T)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 for f32 matmuls
        got = fdm.fdm_solve_interior(r.to(dev), *args)
        qy32, qx32, s32 = fdm._fdm_bases(64, 64, *args, dev)
        r32 = r.to(dev)
        tf32 = -(qy32 @ ((qy32.T @ r32 @ qx32) * s32) @ qx32.T)
    finally:
        torch.set_float32_matmul_precision(before)
    scale = float(want.abs().max())
    err = float((got.cpu().double() - want).abs().max()) / scale
    err_tf32 = float((tf32.cpu().double() - want).abs().max()) / scale
    print(f"[3] fdm_solve_interior 64^2 under TF32-on flags: max|d|/max|e| "
          f"{err:.3e} (tol 1e-5) against an f64 solve; f32 cuBLAS products "
          f"there: {err_tf32:.3e}", flush=True)
    require(err <= 1e-5, f"fdm: {err} > 1e-5 relative: reduced-precision products")
    report["fdm_rel_err"], report["fdm_rel_err_f32_cublas_tf32"] = err, err_tf32


def check_invariants(scene, state, label):
    """Finite fields and the walls: CHANNEL u rows 0 and ny-1 and v row 0
    zero; CAVITY u's floor and side walls, v's row 0 and side columns
    zero, the lid moving; u zero on the BC-masked faces."""
    u, v = state.u.cpu().numpy(), state.v.cpu().numpy()
    for name, a in (("u", u), ("v", v), ("p", state.p.cpu().numpy())):
        require(bool(np.isfinite(a).all()), f"{label}: {name} not finite")
    if scene.params.flow_case == tc.FlowCase.CAVITY:
        require(not u[..., 0, :].any() and not u[..., :, 0].any() and not u[..., :, -1].any(),
                f"{label}: u's floor or side walls not 0")
        require(not v[..., :, 0].any() and not v[..., :, -1].any(),
                f"{label}: v's side columns not 0")
        require(float(u[..., -1, :].max()) > 0, f"{label}: the lid does not move")
    else:
        require(not u[..., 0, :].any() and not u[..., -1, :].any(),
                f"{label}: u rows 0/ny-1 not 0")
    require(not v[..., 0, :].any(), f"{label}: v row 0 not 0")
    require(not u[..., scene.mask_u_bc > 0].any(), f"{label}: u on mask_u_bc not 0")
    return float(u.min()), float(u.max())


def lambda_min(g, cavity=False) -> float:
    """The least eigenvalue of the folded p' operator on the interior:
    the x direction's Neumann-Dirichlet mode (the y direction's Neumann
    pair has 0), 4 sin^2(pi / (2 (2m + 1))) / dx^2 with m = nx - 2; in
    CAVITY flow, all-Neumann, the least one off the constant mode (which
    the mean-removed comparisons take out): the first Neumann-Neumann
    mode of either direction, 4 sin^2(pi / (2m)) / h^2."""
    if cavity:
        return min(4 * float(np.sin(np.pi / (2 * (n - 2)))) ** 2 / h ** 2
                   for n, h in ((g.nx, g.dx), (g.ny, g.dy)))
    m = g.nx - 2
    return 4 * float(np.sin(np.pi / (2 * (2 * m + 1)))) ** 2 / g.dx ** 2


def compare_with_cpu(scene, state_dev, label, steps=3, knife_edge=False):
    """steps of the slice on the card and on the port's CPU path from the
    same state: u, v, grad p and mean-removed p at the golden bounds
    (tests/test_golden.py:116-141), grad p with p's f32 resolution
    (grad_p_l2).

    MG_PRODUCTION solves each step's p' only to max|r| <= E, its exit
    residual (the noise floor here), so two runs' p' may differ by any d
    with A d = r1 - r2, |r1 - r2| <= E1 + E2 in each cell: rms(d) <=
    (E1 + E2) / lambda_min and rms(grad d) <= (E1 + E2) /
    sqrt(lambda_min). Summed over the steps from both runs' res_p, these
    are added to the mean-removed p and grad p bounds, and dt times the
    grad term to the u and v bounds (the corrector subtracts dt grad
    p'). They are the solver's own guarantee, not a fit to a reading.

    MULTIGRID's three cycles do not converge, and their coarse
    corrections carry each run's f32 roundings into the smoothest modes
    of p', which move p and not its gradient: its rollouts are held on
    u, v and grad p alone, and p' by one solve from the same inputs
    (check_multigrid_solve).

    With ``knife_edge`` (the ensembles, the JS twin's scene), a Jacobi or
    SOR solve with tolerance exits may stop one iteration apart on the
    two runs, at a float knife edge (ROADMAP.md section 3). That
    iteration moves p' by its own max change, below jacobi_tol; p sums
    every solve's p', so jacobi_tol times the solves the steps ran (1 +
    outer rounds a substep) is added to the mean-removed p bound. It
    matters where p is small: the 8x800x264 ensemble after 13 steps (rms
    p ~14). The 800x264 default scene (p in the thousands) is held to
    the golden bound alone.

    Red/black SOR over-relaxes (omega = 1.7), and each iteration carries
    the two devices' rounding on (PyTorch divides by a scalar through its
    reciprocal on the card): the port's kernels drift from their plain
    versions by about 1e-6 max|p'| an iteration (measured on an NVIDIA
    H100 80GB HBM3, 700 W; PERF.md), so
    each of the N iterations the steps may run adds SOR_DRIFT max|p'| to
    p' in every cell, e = SOR_DRIFT N max|p'| in all; that is added to
    the mean-removed p bound, 2 e / h to the grad p bound, and, as every
    solve's p' corrects u and v, dt x solves x e / h to theirs. The
    800x264 scene with SOR runs all its 21 solves' 50 iterations (their
    error stays far above jacobi_tol), ~1050 a step, so there the u and v
    bound is loose and p and grad p carry the check."""
    state_cpu = tc.state_from_numpy(tc.state_to_numpy(state_dev), "cpu")
    run = tc.make_run(scene, steps)
    return compare_runs(scene, run(state_dev), run(state_cpu), label, steps,
                        knife_edge, "CUDA vs CPU")


def compare_runs(scene, run_a, run_b, label, steps, knife_edge=False,
                 what="CUDA vs CPU", sweeps_apart=1):
    """The checks of compare_with_cpu on two runs' (state, diagnostics).

    ``sweeps_apart`` > 1 (with ``knife_edge``): the two runs' Jacobi
    solves may exit that many sweeps apart, as a launch-granular exit
    (the sharded step's: k sweeps a launch) does against an exact one.
    Past the exit each damped sweep changes p' by at most its last
    change, below jacobi_tol (the sweep is a max-norm contraction for
    omega <= 1), so p' may differ by sweeps_apart jacobi_tol in each cell
    at each solve: the knife-edge term is multiplied by it, and, as each
    solve's p' corrects u and v by dt grad p', 2 / h of it is added to the
    grad p bound and dt 2 / h of it to u's and v's."""
    (a, da), (b, db) = run_a, run_b
    g = scene.grid
    l2 = lambda x, y: float(np.sqrt(np.mean((x - y) ** 2)))
    rms = lambda x: max(1.0, float(np.sqrt(np.mean(x ** 2))))
    slack_uv = slack_grad = slack_p = 0.0
    if scene.params.pressure_solver == tc.PressureSolver.MG_PRODUCTION:
        e = (da.res_p.cpu().double() + db.res_p.double()).numpy()
        lam = lambda_min(g, scene.params.flow_case == tc.FlowCase.CAVITY)
        slack_p, slack_grad = e.sum() / lam, e.sum() / np.sqrt(lam)
        slack_uv = float((da.dt.cpu().double().numpy() * e).sum()) / np.sqrt(lam)
    elif knife_edge:
        # the most substeps a scene ran
        substeps = int(torch.maximum(da.substeps.cpu(), db.substeps.cpu())
                       .reshape(steps, -1).sum(dim=0).max())
        slack_p = (substeps * (1 + scene.opts.outer_corrector_rounds)
                   * scene.opts.jacobi_tol * sweeps_apart)
        if sweeps_apart > 1:
            h = min(g.dx, g.dy)
            slack_grad = 2 * slack_p / h
            slack_uv = float(da.dt.max()) * 2 * slack_p / h
    if scene.params.pressure_solver == tc.PressureSolver.SOR:
        solves = steps * (1 + scene.opts.outer_corrector_rounds)
        pmax = max(1.0, *(float(s.p_prime.abs().max()) for s in (a, b)))
        e = SOR_DRIFT * solves * max(1, scene.opts.jacobi_iters) * pmax
        h = min(g.dx, g.dy)
        slack_p += e
        slack_grad += 2 * e / h
        slack_uv += float(da.dt.max()) * solves * e / h
    out = {}
    for f in ("u", "v"):
        x, y = (getattr(s, f).cpu().double().numpy() for s in (a, b))
        out[f] = (l2(x, y), 1e-5 * rms(y) + slack_uv)
    pa, pb = (s.p.cpu().double().numpy() for s in (a, b))
    gp, gp_bound, unit = grad_p_l2(pa, pb, g)
    out["grad_p"] = (gp, gp_bound + slack_grad)
    if scene.params.pressure_solver != tc.PressureSolver.MULTIGRID:
        d = pa - pb
        d = d - d.mean(axis=(-2, -1), keepdims=True)  # each scene's own mean
        out["p_demeaned"] = (l2(d, 0.0), 1e-5 * rms(pb) + slack_p)
    if da.substeps.tolist() != db.substeps.tolist():
        raise RuntimeError(f"{label}: {what} substep counts {da.substeps.tolist()} "
                           f"vs {db.substeps.tolist()}")
    print(f"[7] {label}: {steps} steps {what}, L2 "
          + ", ".join(f"{k}={x:.3e} (bound {t:.2e})" for k, (x, t) in out.items())
          + f"; grad p {gp / unit:.2f} ulp(max|p|)/h"
          + (f"; solve terms {slack_uv:.2e} (u, v), {slack_grad:.2e} (grad p), "
             f"{slack_p:.2e} (p)" if slack_p else ""), flush=True)
    for k, (x, t) in out.items():
        require(x <= t, f"{label}: {what} {k} L2 {x} > {t}")
    return {k: x for k, (x, _) in out.items()}


def compare_cavity_re1000(dev):
    """The 1024^2 cavity at Re = 1000 and dt 1e-4 (the cavity_1024 cell's
    constants, a flow the explicit step holds, unlike the app's at this
    size): 30 steps from rest on the card, then compare_with_cpu's 3 on
    the rounds route (kernel 1, then kernel 4's slab form), whose solves
    exit at a live tolerance."""
    scene = tc.make_scene(tc.cavity_grid(1024), tc.SimulationParams(
        dt=1e-4, viscosity=1e-3, target_inlet_velocity=1.0, flow_case=tc.FlowCase.CAVITY),
        tc.solver_options_for(tc.Semantics.RUST))
    state, _ = tc.make_run(scene, 30)(scene.init_state(dev))
    return compare_with_cpu(scene, state, CAV1024_RE1000, knife_edge=True)


def take_scenes(state, idx):
    """The scenes ``idx`` of a batched state, as a batched state."""
    d = tc.state_to_numpy(state)
    return tc.state_from_numpy({k: None if a is None else a[idx]
                                for k, a in d.items()}, state.u.device)


def run_ensembles(dev, launches, report):
    """The ensemble app's two shapes (apps/ensemble.py), each path's
    launches counted; returns the end states."""
    scene = ensemble_scene()
    g, B = scene.grid, 64
    state, _ = tc.make_run(scene, 5)(ensemble_state(scene, B, dev))
    run = tc.make_run(scene, 50)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = run(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[ENS64] = read_counts()
    check_invariants(scene, state, ENS64)
    rate = B * g.nx * g.ny * 50 / sec
    report[ENS64] = {"scene_steps_per_s": B * 50 / sec, "cell_updates_per_s": rate}
    print(f"[6] {ENS64}: 50 steps in {sec:.4f} s = {B * 50 / sec:.1f} scene-steps/s, "
          f"{rate:.4e} cell-updates/s aggregate, no host sync "
          f"(set_sync_debug_mode error)", flush=True)

    # Scene k of the batch against an unbatched run of it (the rounds route).
    k = 32
    batch3, _ = tc.make_run(scene, 3)(ensemble_state(scene, B, dev))
    one = dataclasses.replace(scene.init_state(dev), nu=batch3.nu[k].clone())
    one, _ = tc.make_run(scene, 3)(one)
    diffs = {f: max_abs(getattr(batch3, f)[k], getattr(one, f))
             for f in ("u", "v")}
    for f, d in diffs.items():
        tol = scaled(getattr(one, f), 1e-5)
        require(d <= tol, f"{ENS64}: scene {k} {f} max|d| {d} > {tol} against "
                f"its unbatched run")
    dp = (batch3.p[k] - one.p).double()
    diffs["p-mean"] = float((dp - dp.mean()).abs().max())
    require(diffs["p-mean"] <= scaled(one.p, 1e-4),
            f"{ENS64}: scene {k} p-mean max|d| {diffs['p-mean']} too large")
    report[ENS64]["scene_k_vs_unbatched"] = diffs
    print(f"[6] {ENS64}: scene {k} (nu {float(one.nu):.3e}) after 3 steps against "
          f"its unbatched run on the card: "
          + ", ".join(f"{f} max|d|={d:.3e}" for f, d in diffs.items()), flush=True)

    scene8 = ensemble_scene(800, 264)
    g8, B8 = scene8.grid, 8
    init = ensemble_state(scene8, B8, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state8, _ = tc.make_run(scene8, 10)(init)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[ENS8] = read_counts()
    check_invariants(scene8, state8, ENS8)
    rate = B8 * g8.nx * g8.ny * 10 / sec
    report[ENS8] = {"scene_steps_per_s": B8 * 10 / sec, "cell_updates_per_s": rate}
    print(f"[6] {ENS8}: 10 steps in {sec:.4f} s = {B8 * 10 / sec:.1f} scene-steps/s, "
          f"{rate:.4e} cell-updates/s aggregate", flush=True)
    return (scene, state), (scene8, state8)


def timed_run(scene, state, steps, no_sync):
    """``steps`` steps from ``state``, counted from counts set to 0 and
    timed by the host clock up to a synchronize; with ``no_sync`` under
    set_sync_debug_mode("error"). Returns (state, seconds, launches)."""
    run = tc.make_run(scene, steps)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = run(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0, read_counts()


def run_sor(dev, launches, report):
    """bench.py --mode sor at 2048^2 (the colour-split chain) and 2047^2
    (the full-layout chain), the 800x264 scene with --solver sor (the
    plain solve) and the SOR ensemble at B = 16 (kernel 20's SOR form);
    returns their (scene, end state) pairs."""
    scene = sor_scene()
    n = scene.grid.nx
    state, _ = tc.make_run(scene, 5)(scene.init_state(dev))
    state, sec, launches[SOR] = timed_run(scene, state, 100, True)
    check_invariants(scene, state, SOR)
    rate = n * n * 100 / sec
    report[SOR] = {"cell_updates_per_s": rate, "steps_per_s": 100 / sec}
    print(f"[6] {SOR}: 100 steps in {sec:.4f} s = {rate:.4e} cell-updates/s "
          f"({100 / sec:.2f} steps/s), no host sync (set_sync_debug_mode error)",
          flush=True)
    out = [(scene, state)]

    scene = sor_scene(2047)
    state, sec, launches[SOR_ODD] = timed_run(scene, scene.init_state(dev), 3, True)
    check_invariants(scene, state, SOR_ODD)
    report[SOR_ODD] = {"steps_per_s": 3 / sec}
    print(f"[6] {SOR_ODD}: 3 steps from rest in {sec:.4f} s, no host sync", flush=True)
    out.append((scene, state))

    scene = tc.make_scene(tc.default_grid(), tc.SimulationParams(
        pressure_solver=tc.PressureSolver.SOR))
    init = scene.init_state(dev)
    init.step.fill_(50)  # the inlet ramp half way up
    state, sec, launches[REF_SOR] = timed_run(scene, init, 3, False)
    check_invariants(scene, state, REF_SOR)
    report[REF_SOR] = {"steps_per_s": 3 / sec}
    print(f"[6] {REF_SOR}: 3 steps in {sec:.4f} s = {3 / sec:.2f} steps/s (the plain "
          f"exact do-while, one host read an iteration), res_p "
          f"{float(state.res_p):.3e}", flush=True)
    out.append((scene, state))

    scene, B = sor_ensemble_scene(), 16
    g = scene.grid
    state, _ = tc.make_run(scene, 5)(ensemble_state(scene, B, dev))
    state, sec, launches[ENS_SOR] = timed_run(scene, state, 50, True)
    check_invariants(scene, state, ENS_SOR)
    rate = B * g.nx * g.ny * 50 / sec
    report[ENS_SOR] = {"scene_steps_per_s": B * 50 / sec, "cell_updates_per_s": rate}
    print(f"[6] {ENS_SOR}: 50 steps in {sec:.4f} s = {B * 50 / sec:.1f} scene-steps/s, "
          f"{rate:.4e} cell-updates/s aggregate, no host sync", flush=True)
    out.append((scene, state))
    return out


def sweep_tol(k, ref, rhs_scaled_max) -> float:
    """16 eps k (max|p| + max|scaled rhs|): the multipliers (the TPU
    kernels') round each sweep's terms a few ulps apart from the plain
    divisions, and Jacobi's iteration (norm <= 1) carries that without
    growth (tests/test_torch_mg.py)."""
    return 16 * EPS32 * max(k, 1) * (float(ref.abs().max()) + rhs_scaled_max)


def ulp_tol(ref) -> float:
    """The prolongation repeats its plain version's operations: 1 ulp."""
    return EPS32 * float(ref.abs().max())


def coarse_levels(rhs, dx, dy, n):
    """The rhs of the vertex hierarchy n levels below ``rhs`` (each the
    restricted residual of a zero p'), with its spacing."""
    for _ in range(n):
        rhs = kmg.mg_residual_restrict(torch.zeros_like(rhs), rhs, dx, dy)
        dx, dy = 2 * dx, 2 * dy
    return rhs, dx, dy


def check_mg_kernels(dev, results):
    """Kernels 10/16-19 on their paths' own states: on the 2048^2 and
    2047^2 multigrid states after 3 steps, the fine level after one
    V-cycle of the next solve (what the second cycle smooths) with the
    next rhs: the smoother at k = 5 and 10, the residual-restriction, and
    the prolongation of the cycle's own coarse correction (with and
    without the p' BCs); both again on a 33x17 level, and the smoother
    on the 128^2 level (one block). The damped smoother at k = 3 on the
    2048^2 and 800x264 legacy production states after 3 steps (p' and
    the next rhs), and on the 128^2 level."""
    extra = {k: {} for k in ("mg_smooth", "mg_residual_restrict", "mg_prolong_add",
                             "mgp_smooth")}
    worst = dict.fromkeys(extra, 0.0)

    def check(name, label, got, ref, tol):
        d = max_abs(got, ref)
        require(bool(torch.isfinite(got).all()), f"{name} {label}: not finite")
        require(d <= tol, f"{name} {label}: max|d| {d} > {tol}")
        worst[name] = max(worst[name], d)
        return f"max|d|={d:.3e} (tol {tol:.1e})"

    for n in (2048, 2047):
        scene = multigrid_scene(n)
        g, opts = scene.grid, scene.opts
        dx, dy = g.dx, g.dy
        state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
        rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                          scene.params.velocity_scheme, opts.semantics)[2]
        kit = _mg_kit(opts)
        p1 = _mg_vcycle(torch.zeros_like(rhs), rhs, dx, dy, opts, kit)
        br_rhs = float(rhs.abs().max()) / (2 / dx ** 2 + 2 / dy ** 2)
        cells = rhs.numel()
        for k in (5, 10):
            got = kmg.mg_smooth(p1, rhs, dx, dy, k)
            ref = kmg.mg_smooth_plain(p1, rhs, dx, dy, k)
            msg = check("mg_smooth", f"{n}^2 k={k}", got, ref, sweep_tol(k, ref, br_rhs))
            ms = time_ms(lambda: kmg.mg_smooth(p1, rhs, dx, dy, k), 10)
            plain = time_ms(lambda: kmg.mg_smooth_plain(p1, rhs, dx, dy, k), 3)
            b = bound(nbytes(p1, rhs, got), k * MG_SWEEP * cells)
            print(f"[3] mg_smooth {n}^2 k={k}: {msg}; kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
                  flush=True)
            if n == 2048 and k == 5:
                results["mg_smooth"] = {"ms": ms, "plain_ms": plain, **b,
                                        "library_ms": None}
            else:
                extra["mg_smooth"][f"ms_{n}_k{k}"] = ms
        got = kmg.mg_residual_restrict(p1, rhs, dx, dy)
        ref = kmg.mg_residual_restrict_plain(p1, rhs, dx, dy)
        msg = check("mg_residual_restrict", f"{n}^2", got, ref,
                    res_floor(p1, rhs, 2 / dx ** 2 + 2 / dy ** 2))
        ms = time_ms(lambda: kmg.mg_residual_restrict(p1, rhs, dx, dy), 20)
        plain = time_ms(lambda: kmg.mg_residual_restrict_plain(p1, rhs, dx, dy), 5)
        b = bound(nbytes(p1, rhs, got), MG_RESTRICT * got.numel())
        print(f"[3] mg_residual_restrict {n}^2: {msg}; kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
        if n == 2048:
            results["mg_residual_restrict"] = {"ms": ms, "plain_ms": plain, **b,
                                               "library_ms": None}
        else:
            extra["mg_residual_restrict"][f"ms_{n}"] = ms
        e = _mg_vcycle(torch.zeros_like(ref), ref, 2 * dx, 2 * dy, opts, kit)
        for bc in (False, True):
            got = kmg.mg_prolong_add(e, p1, bc)
            ref = kmg.mg_prolong_add_plain(e, p1, bc)
            msg = check("mg_prolong_add", f"{n}^2 bc={bc}", got, ref, ulp_tol(ref))
            ms = time_ms(lambda: kmg.mg_prolong_add(e, p1, bc), 20)
            plain = time_ms(lambda: kmg.mg_prolong_add_plain(e, p1, bc), 5)
            b = bound(nbytes(e, p1, got), MG_PROLONG * cells)
            print(f"[3] mg_prolong_add {n}^2 bc={bc}: {msg}; kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
                  flush=True)
            if n == 2048 and not bc:
                results["mg_prolong_add"] = {"ms": ms, "plain_ms": plain, **b,
                                             "library_ms": None}
            else:
                extra["mg_prolong_add"][f"ms_{n}" + ("_bc" if bc else "")] = ms
        if n == 2048:
            r128, dx128, dy128 = coarse_levels(rhs, dx, dy, 4)
            z = torch.zeros_like(r128)
            got = kmg.mg_smooth(z, r128, dx128, dy128, 5)
            ref = kmg.mg_smooth_plain(z, r128, dx128, dy128, 5)
            br128 = float(r128.abs().max()) / (2 / dx128 ** 2 + 2 / dy128 ** 2)
            msg = check("mg_smooth", "128^2 level k=5", got, ref, sweep_tol(5, ref, br128))
            ms = time_ms(lambda: kmg.mg_smooth(z, r128, dx128, dy128, 5), 20)
            extra["mg_smooth"]["ms_128_k5_one_block"] = ms
            print(f"[3] mg_smooth on the 128^2 level, k=5 (one block): {msg}; kernel "
                  f"{ms:.4f} ms", flush=True)

    # A small odd level: random p and rhs at the 64x coarser spacing.
    gen = torch.Generator().manual_seed(0)
    p = (0.01 * torch.randn((33, 17), generator=gen)).to(dev)
    r = torch.randn((33, 17), generator=gen).to(dev)
    h = 64 * 30.0 / 2048
    got = kmg.mg_residual_restrict(p, r, h, h)
    ref = kmg.mg_residual_restrict_plain(p, r, h, h)
    msg = check("mg_residual_restrict", "33x17", got, ref, res_floor(p, r, 4 / h ** 2))
    extra["mg_residual_restrict"]["ms_33x17"] = time_ms(
        lambda: kmg.mg_residual_restrict(p, r, h, h), 20)
    e = torch.randn(kmg.coarse_shape(33, 17), generator=gen).to(dev)
    msgs = [msg]
    for bc in (False, True):
        got = kmg.mg_prolong_add(e, p, bc)
        ref = kmg.mg_prolong_add_plain(e, p, bc)
        msgs.append(check("mg_prolong_add", f"33x17 bc={bc}", got, ref, ulp_tol(ref)))
    extra["mg_prolong_add"]["ms_33x17"] = time_ms(lambda: kmg.mg_prolong_add(e, p), 20)
    print(f"[3] transfers on a 33x17 level: restrict {msgs[0]}; prolong {msgs[1]}, "
          f"with the BCs {msgs[2]}", flush=True)

    for n, make in ((2048, legacy_production_scene),
                    (800, lambda: tc.make_scene(tc.default_grid(), tc.SimulationParams(
                        pressure_solver=tc.PressureSolver.MG_PRODUCTION),
                        tc.solver_options_for(tc.Semantics.RUST, mgp_scheme="legacy")))):
        scene = make()
        g, opts = scene.grid, scene.opts
        dx, dy, om, k = g.dx, g.dy, opts.jacobi_omega, opts.mgp_smooth
        init = scene.init_state(dev)
        init.step.fill_(0 if n == 2048 else 50)  # 800x264: the inlet ramp half way
        state, _ = tc.make_run(scene, 3)(init)
        rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                          scene.params.velocity_scheme, opts.semantics)[2]
        pp = state.p_prime
        ar_rhs = om * float(rhs.abs().max()) / (2 / dx ** 2 + 2 / dy ** 2)
        got = kmg.mgp_smooth(pp, rhs, dx, dy, om, k)
        ref = kmg.mgp_smooth_plain(pp, rhs, dx, dy, om, k)
        label = f"{g.nx}x{g.ny}"
        msg = check("mgp_smooth", f"{label} k={k}", got, ref, sweep_tol(k, ref, ar_rhs))
        ms = time_ms(lambda: kmg.mgp_smooth(pp, rhs, dx, dy, om, k), 20)
        plain = time_ms(lambda: kmg.mgp_smooth_plain(pp, rhs, dx, dy, om, k), 5)
        b = bound(nbytes(pp, rhs, got), k * SWEEP * pp.numel())
        print(f"[3] mgp_smooth {label} legacy state k={k}: {msg}; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
        if n == 2048:
            results["mgp_smooth"] = {"ms": ms, "plain_ms": plain, **b, "library_ms": None}
            r128, dx128, dy128 = coarse_levels(rhs, dx, dy, 4)
            z = torch.zeros_like(r128)
            got = kmg.mgp_smooth(z, r128, dx128, dy128, om, k)
            ref = kmg.mgp_smooth_plain(z, r128, dx128, dy128, om, k)
            ar128 = om * float(r128.abs().max()) / (2 / dx128 ** 2 + 2 / dy128 ** 2)
            msg = check("mgp_smooth", "128^2 level", got, ref, sweep_tol(k, ref, ar128))
            extra["mgp_smooth"]["ms_128_one_block"] = time_ms(
                lambda: kmg.mgp_smooth(z, r128, dx128, dy128, om, k), 20)
            print(f"[3] mgp_smooth on the 128^2 level, k={k} (one block): {msg}",
                  flush=True)
        else:
            extra["mgp_smooth"]["ms_800x264"] = ms
    for name, more in extra.items():
        results[name].update(more, max_abs_err=worst[name])


def run_vertex(dev, launches, report):
    """The vertex multigrid's paths: MULTIGRID at 2048^2 (5 warm-up steps,
    100 timed under set_sync_debug_mode("error")) and 2047^2 (3 steps,
    the same check), the 800x264 scene with --solver multigrid (3 steps,
    Rust defaults: up to 20 outer rounds); the legacy production
    projection at 2048^2 (5 warm-up steps, then 20 one at a time, V-cycles
    per step and each step's exit named) and 800x264 (3 steps). Returns
    their (scene, end state, label) triples."""
    out = []
    scene = multigrid_scene()
    n = scene.grid.nx
    state, _ = tc.make_run(scene, 5)(scene.init_state(dev))
    state, sec, launches[MG] = timed_run(scene, state, 100, True)
    check_invariants(scene, state, MG)
    rate = n * n * 100 / sec
    report[MG] = {"cell_updates_per_s": rate, "steps_per_s": 100 / sec,
                  "res_p": float(state.res_p)}
    print(f"[6] {MG}: 100 steps in {sec:.4f} s = {rate:.4e} cell-updates/s "
          f"({100 / sec:.2f} steps/s), no host sync (set_sync_debug_mode error); "
          f"res_p after 3 cycles {float(state.res_p):.3e}", flush=True)
    out.append((scene, state, MG))

    scene = multigrid_scene(2047)
    state, sec, launches[MG_ODD] = timed_run(scene, scene.init_state(dev), 3, True)
    check_invariants(scene, state, MG_ODD)
    report[MG_ODD] = {"steps_per_s": 3 / sec}
    print(f"[6] {MG_ODD}: 3 steps from rest in {sec:.4f} s, no host sync", flush=True)
    out.append((scene, state, MG_ODD))

    for label, params, opts in (
            (REF_MG, tc.SimulationParams(pressure_solver=tc.PressureSolver.MULTIGRID),
             tc.solver_options_for(tc.Semantics.RUST)),
            (REF_LEG, tc.SimulationParams(pressure_solver=tc.PressureSolver.MG_PRODUCTION),
             tc.solver_options_for(tc.Semantics.RUST, mgp_scheme="legacy"))):
        scene = tc.make_scene(tc.default_grid(), params, opts)
        init = scene.init_state(dev)
        init.step.fill_(50)  # the inlet ramp half way up
        state, sec, launches[label] = timed_run(scene, init, 3, False)
        check_invariants(scene, state, label)
        report[label] = {"steps_per_s": 3 / sec, "res_p": float(state.res_p)}
        print(f"[6] {label}: 3 steps in {sec:.4f} s = {3 / sec:.2f} steps/s (up to 20 "
              f"outer rounds, one host read a round), res_p {float(state.res_p):.3e}",
              flush=True)
        out.append((scene, state, label))

    scene = legacy_production_scene()
    steps = 20
    state, _ = tc.make_run(scene, 5)(scene.init_state(dev))
    step = tc.make_step(scene)
    states, diags, cycles = [state], [], []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        c0 = vcycles_launched()
        state, d = step(state)
        cycles.append(vcycles_launched() - c0)
        states.append(state)
        diags.append(d)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[LEG] = read_counts()
    check_invariants(scene, state, LEG)
    exits = production_exits(scene, states, diags, cycles)
    rate = n * n * steps / sec
    report[LEG] = {"cell_updates_per_s": rate, "steps_per_s": steps / sec,
                   "vcycles_per_step": cycles, "exits": exits,
                   "res_p": [float(d.res_p) for d in diags]}
    print(f"[6] {LEG}: {steps} steps in {sec:.4f} s = {rate:.4e} cell-updates/s "
          f"({steps / sec:.2f} steps/s); V-cycles per step {cycles} (mean "
          f"{np.mean(cycles):.2f}); exits: "
          + ", ".join(f"{e} x{exits.count(e)}" for e in dict.fromkeys(exits)),
          flush=True)
    out.append((scene, state, LEG))
    return out


def run_js(dev, launches, report):
    """The JS twin's step and kernel 5's route: the JS default scene
    (400x132, adaptive substeps, the rounds kernel from a zero p'), 5
    warm-up steps then 50 timed, with substeps per step; the 2048^2 JS
    QUICK PARABOLIC shape, 5 warm-up steps then 100 timed under
    set_sync_debug_mode("error"); the 2048^2 reference mode with
    rounds_impl="pallas", 3 warm-up steps then 5 one at a time with the
    outer rounds of each (correct_div launches less one), held against
    the unfused route's 5 steps from the same state on the card. Returns
    their (scene, end state, label) triples."""
    out = []
    scene = js_default_scene()
    g = scene.grid
    state, _ = tc.make_run(scene, 5)(scene.init_state(dev))
    run = tc.make_run(scene, 50)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, diags = run(state)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[JS_DEF] = read_counts()
    check_invariants(scene, state, JS_DEF)
    sub = diags.substeps.cpu()
    require(bool(((sub >= 1) & (sub <= scene.opts.substeps_max)).all()),
            f"{JS_DEF}: substep counts {sub.tolist()}")
    require(launches[JS_DEF]["rounds"] == int(sub.sum()),
            f"{JS_DEF}: {launches[JS_DEF]['rounds']} rounds-kernel launches for "
            f"{int(sub.sum())} substeps")
    require(state.u_prev is not None and bool(torch.isfinite(state.u_prev).all()),
            f"{JS_DEF}: u_prev missing or not finite")
    report[JS_DEF] = {"steps_per_s": 50 / sec, "substeps_per_step": sub.tolist(),
                      "res_p": float(state.res_p), "dt": float(state.dt)}
    print(f"[6] {JS_DEF}: 50 steps in {sec:.4f} s = {50 / sec:.2f} steps/s, "
          f"{float(sub.double().mean()):.2f} substeps per step (min {int(sub.min())}, "
          f"max {int(sub.max())}; one rounds-kernel launch and one host read of "
          f"the count a step), res_p {float(state.res_p):.3e}, dt "
          f"{float(state.dt):.5f}; invariants hold", flush=True)
    out.append((scene, state, JS_DEF))

    scene = js_quick_scene()
    n = scene.grid.nx
    state, _ = tc.make_run(scene, 5)(scene.init_state(dev))
    state, sec, launches[JS_QUICK] = timed_run(scene, state, 100, True)
    umin, umax = check_invariants(scene, state, JS_QUICK)
    rate = n * n * 100 / sec
    report[JS_QUICK] = {"cell_updates_per_s": rate, "steps_per_s": 100 / sec,
                        "u_range": [umin, umax]}
    # 50 sweeps from a zero p' (JS) leave most of the divergence at 2048^2,
    # and the flow grows without bound as the JAX package's does: the
    # schedule's work does not depend on the values.
    print(f"[6] {JS_QUICK}: 100 steps in {sec:.4f} s = {rate:.4e} cell-updates/s "
          f"({100 / sec:.2f} steps/s), no host sync (set_sync_debug_mode error); "
          f"u in [{umin:.4e}, {umax:.4e}]", flush=True)
    out.append((scene, state, JS_QUICK))

    scene = reference_mode_scene(2048, "pallas")
    state0, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    step = tc.make_step(scene)
    state, diags, rounds = state0, [], []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        c0 = correct_div.launches
        state, d = step(state)
        rounds.append(correct_div.launches - c0 - 1)
        diags.append(d)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[REF_CD] = read_counts()
    check_invariants(scene, state, REF_CD)
    require(launches[REF_CD]["correct_div"] == 5 + sum(rounds) and min(rounds) >= 0,
            f"{REF_CD}: correct_div launches {launches[REF_CD]['correct_div']}, "
            f"rounds {rounds}")
    rate = n * n * 5 / sec
    report[REF_CD] = {"cell_updates_per_s": rate, "steps_per_s": 5 / sec,
                      "rounds_per_step": rounds}
    print(f"[6] {REF_CD}: 5 steps in {sec:.4f} s = {rate:.4e} cell-updates/s "
          f"({5 / sec:.2f} steps/s), outer rounds per step {rounds} (one correct_div "
          f"launch and one host read a round)", flush=True)
    pallas = (state, type(diags[0])(*(torch.stack(x) for x in zip(*diags))))
    run = tc.make_run(reference_mode_scene(2048), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = run(state0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    report[REF_CD]["unfused_cell_updates_per_s"] = n * n * 5 / sec
    print(f"[6] {REF_CD}: the unfused route (rounds_impl auto: the plain corrector "
          f"and divergence) from the same state, 5 steps in {sec:.4f} s = "
          f"{n * n * 5 / sec:.4e} cell-updates/s", flush=True)
    report[REF_CD]["vs_unfused"] = compare_runs(
        scene, pallas, unfused, f"{REF_CD} vs the unfused route", 5,
        knife_edge=True, what="correct_div vs unfused, both on the card")
    out.append((scene, state, REF_CD))
    return out


def run_cavity(dev, launches, report):
    """The lid-driven cavity (BASELINE config 2) with the cavity app's
    constants (dt 0.002, viscosity 1e-2, lid 1.0) and Rust defaults: 512^2
    (5 warm-up steps, 50 timed), 1024^2 (3, then 10) and 2048^2 (2, then
    5); the 2048^2 cavity on the fast schedule (5, then 100 under
    set_sync_debug_mode("error")); a 128^2 JS cavity (5, then 50, adaptive
    substeps); the Re = 100 cavity of tests/test_physics.py at 64^2 for
    its 8000 steps, against Ghia et al. (1982) within 0.06. Returns the
    (scene, end state, label) triples of the 512^2 and fast-shape runs."""
    out = []
    runs = ((CAV512, cavity_scene(512), 5, 50, False),
            (CAV1024, cavity_scene(1024), 3, 10, False),
            (CAV2048, cavity_scene(2048), 2, 5, False),
            (CAV_FAST, cavity_fast_scene(), 5, 100, True),
            (CAV_JS, tc.make_scene(tc.cavity_grid(128), tc.SimulationParams(
                dt=0.002, viscosity=1e-2, flow_case=tc.FlowCase.CAVITY),
                tc.solver_options_for(tc.Semantics.JS)), 5, 50, False))
    for label, scene, warm, steps, no_sync in runs:
        g = scene.grid
        state, _ = tc.make_run(scene, warm)(scene.init_state(dev))
        state, sec, launches[label] = timed_run(scene, state, steps, no_sync)
        umin, umax = check_invariants(scene, state, label)
        entry = {"steps_per_s": steps / sec, "cell_updates_per_s": g.nx * g.ny * steps / sec,
                 "res_p": float(state.res_p), "u_range": [umin, umax]}
        if not _use_fused_substep(scene):
            entry["rounds_sweeps_next_step"] = solve_correct_rounds(
                *rounds_args(scene, state))[5].tolist()
        report[label] = entry
        print(f"[6] {label}: {steps} steps in {sec:.4f} s = {steps / sec:.2f} steps/s "
              f"({entry['cell_updates_per_s']:.4e} cell-updates/s)"
              + (", no host sync (set_sync_debug_mode error)" if no_sync else "")
              + (f"; the next step's rounds and sweeps {entry['rounds_sweeps_next_step']}"
                 if "rounds_sweeps_next_step" in entry else "")
              + f"; u in [{umin:.4f}, {umax:.4f}], res_p {entry['res_p']:.3e}; invariants "
              f"hold", flush=True)
        if label in (CAV512, CAV_FAST):
            out.append((scene, state, label))

    scene = ghia_scene()
    state, sec, launches[GHIA] = timed_run(scene, scene.init_state(dev), GHIA_STEPS, False)
    check_invariants(scene, state, GHIA)
    du, dv = ghia_deviation(state)
    report[GHIA] = {"steps_per_s": GHIA_STEPS / sec, "res_u": float(state.res_u),
                    "max_dev_u": du, "max_dev_v": dv}
    print(f"[6] {GHIA}: Re = 100, {GHIA_STEPS} steps in {sec:.4f} s = "
          f"{GHIA_STEPS / sec:.2f} steps/s; res_u {float(state.res_u):.3e}; max deviation "
          f"from Ghia et al. (1982): u {du:.4f}, v {dv:.4f} (bound 0.06)", flush=True)
    require(float(state.res_u) < 1e-4, f"{GHIA}: not at steady state")
    require(du < 0.06 and dv < 0.06, f"{GHIA}: deviation u {du}, v {dv} >= 0.06")
    return out


def run_cavity_production(dev, launches, report):
    """The cavity with the cavity app's constants and --solver
    mg-production (Rust defaults: up to 20 outer rounds, each a solve):
    aligned at 512^2 (5 warm-up steps, then 20) and 2048^2 (2, then 5),
    steps timed one at a time to read the V-cycles each ran; 2047^2 (odd:
    kernel 6; 2, then 3); the legacy cycle at 512^2 (5 steps from rest)
    and 2048^2 (2, then 3). Prints steps/s, cell-updates/s and V-cycles a step. With the
    app's dt the flow outgrows the explicit scheme's limit and some
    solves stop at the cycle cap, as the JAX package's do
    (tests/test_torch_cavity_mgp.py). Returns the 512^2 runs' (scene, end
    state, label) triples."""
    out = []
    runs = ((CAV_MGP512, cavity_production_scene(512), 5, 20),
            (CAV_MGP, cavity_production_scene(), 2, 5),
            (CAV_MGP_ODD, cavity_production_scene(2047), 2, 3),
            (CAV_LEG512, cavity_production_scene(512, mgp_scheme="legacy"), 0, 5),
            (CAV_LEG, cavity_production_scene(mgp_scheme="legacy"), 2, 3))
    for label, scene, warm, steps in runs:
        g = scene.grid
        state = scene.init_state(dev)
        if warm:
            state, _ = tc.make_run(scene, warm)(state)
        step = tc.make_step(scene)
        cycles, res_p = [], []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            c0 = vcycles_launched()
            state, d = step(state)
            cycles.append(vcycles_launched() - c0)
            res_p.append(d.res_p)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches[label] = read_counts()
        umin, umax = check_invariants(scene, state, label)
        require(float(state.p_prime[0, 0]) == 0.0, f"{label}: p' at the gauge cell not 0")
        rate = g.nx * g.ny * steps / sec
        report[label] = {"steps_per_s": steps / sec, "cell_updates_per_s": rate,
                         "vcycles_per_step": cycles, "res_p": [float(r) for r in res_p],
                         "u_range": [umin, umax]}
        print(f"[6] {label}: {steps} steps in {sec:.4f} s = {steps / sec:.2f} steps/s "
              f"({rate:.4e} cell-updates/s); V-cycles per step {cycles} (mean "
              f"{np.mean(cycles):.2f}, up to 20 outer rounds a step); res_p "
              f"{[float(r) for r in res_p]}; u in [{umin:.4f}, {umax:.4f}]; invariants "
              f"hold", flush=True)
        if g.nx == 512:
            out.append((scene, state, label))
    return out


def shard_blocks(x, shards, halo):
    """A global field's halo-extended row blocks, as the sharded step's
    exchange gives them (zero rows past the grid)."""
    mesh = make_mesh(shards, x.device)
    return exchange_rows(split_rows(x, mesh), mesh, halo)


def check_shard_kernels(dev, results, report):
    """Kernels 11 and 14, and the row-offset forms of 1 and 3, on the main
    paths' states: the 2048^2 fast (and SOR) state after 3 steps, its
    next rhs, cut into 4 shards of 512 rows; every shard's extended block
    (a halo8(k) = 16-row halo) through jacobi_fused_k_shard at k = 10
    (sor_fused_k_shard at k = 5), owned rows and err against the plain
    twin; then each on a column block of shard 1 (global columns
    [496, 1040), 512 owned), the 2-D tier's form. Timed on shard 1's
    block (544 x 2048). predict_div and correct_bc on shard 2's
    8-row-haloed block (row offset 1016), owned rows against their plain
    forms, timed beside the whole field's launches of phase 3."""
    shards, loc_h = 4, 8
    for solver, name, k in (("JACOBI", "jacobi_fused_k_shard", None),
                            ("SOR", "sor_fused_k_shard", None)):
        scene = fast_scene() if solver == "JACOBI" else sor_scene()
        g, opts = scene.grid, scene.opts
        state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
        rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                          scene.params.velocity_scheme, opts.semantics)[2]
        if solver == "JACOBI":
            k = resolve_fuse_k(opts, divide=opts.jacobi_iters)
            kern, plain, om, halo = (jacobi_fused_k_shard, jacobi_fused_k_shard_plain,
                                     opts.jacobi_omega, -(-k // 8) * 8)
            ops = k * (SWEEP + SWEEP_ERR)
        else:
            k = sor_k(scene)
            kern, plain, om, halo = (ksor.sor_fused_k_shard, ksor.sor_fused_k_shard_plain,
                                     opts.sor_omega, -(-2 * k // 8) * 8)
            ops = k * SOR_ITER + SWEEP_ERR
        loc = g.ny // shards
        ppx, rhsx = (shard_blocks(x, shards, halo) for x in (state.p_prime, rhs))
        pairs = []
        for s in range(shards):
            args = (ppx[s], rhsx[s], s * loc - halo, g.ny, g.dx, g.dy, om, k, halo,
                    halo + loc)
            got, ref = kern(*args), plain(*args)
            own = slice(halo, halo + loc)
            # f32 multipliers on both sides: a rounding apart, carried over k
            # iterations (omega 1.7 amplifies SOR's)
            tol = scaled(ref[0][own], 1e-5)
            pairs += [(f"shard {s} p'", got[0][own], ref[0][own], tol),
                      (f"shard {s} err", got[1], ref[1], tol)]
        c0, c1 = g.nx // 4 - halo, g.nx // 2 + halo
        cargs = (ppx[1][:, c0:c1].contiguous(), rhsx[1][:, c0:c1].contiguous(),
                 loc - halo, g.ny, g.dx, g.dy, om, k, halo, halo + loc)
        ckw = dict(col_offset=c0, gnx=g.nx, own_cols=(halo, c1 - c0 - halo))
        got, ref = kern(*cargs, **ckw), plain(*cargs, **ckw)
        own = (slice(halo, halo + loc), slice(halo, c1 - c0 - halo))
        pairs += [("column block p'", got[0][own], ref[0][own], scaled(ref[0][own], 1e-5)),
                  ("column block err", got[1], ref[1], scaled(ref[0][own], 1e-5))]
        args = (ppx[1], rhsx[1], loc - halo, g.ny, g.dx, g.dy, om, k, halo, halo + loc)
        out = kern(*args)[0]
        compare(name, pairs, results,
                (time_ms(lambda: kern(*args), 20), time_ms(lambda: plain(*args), 3)),
                bound(nbytes(ppx[1], rhsx[1], out), ops * ppx[1].numel()))
        results[name]["k"] = k
        results[name]["block"] = list(ppx[1].shape)

    # Kernels 1 and 3 at a row offset: shard 2 of 4 on the fast state.
    scene = fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    sch, sem = scene.params.velocity_scheme, opts.semantics
    loc, s = g.ny // shards, 2
    off = s * loc - loc_h
    ue, ve = (shard_blocks(x, shards, loc_h)[s] for x in (state.u, state.v))
    dt, nu = state.dt, state.nu
    got = predict_div(ue, ve, dt, nu, g, sch, sem, row_offset=off)
    ref = predict_div_plain(ue, ve, dt, nu, g, sch, sem, row_offset=off)
    own = slice(loc_h, loc_h + loc)
    uv_scale = max(1.0, float(ref[0].abs().max()), float(ref[1].abs().max()))
    rhs_tol = 4 * EPS32 * uv_scale * (1 / g.dx + 1 / g.dy) / float(dt)
    compare("predict_div row_offset", [
        ("u*", got[0][own], ref[0][own], scaled(ref[0], 1e-6)),
        ("v*", got[1][own], ref[1][own], scaled(ref[1], 1e-6)),
        ("rhs", got[2][own], ref[2][own], rhs_tol)], report,
        (time_ms(lambda: predict_div(ue, ve, dt, nu, g, sch, sem, row_offset=off), 20),
         time_ms(lambda: predict_div_plain(ue, ve, dt, nu, g, sch, sem, row_offset=off),
                 5)),
        bound(nbytes(ue, ve, *got), PREDICT * ue.numel()))
    us, vs, rhs = got
    pad = lambda x: torch.nn.functional.pad(x[s * loc:(s + 1) * loc], (0, 0, loc_h, loc_h))
    ppe = shard_blocks(state.p_prime, shards, loc_h)[s]
    args = (us, vs, pad(state.p), ppe, pad(state.u), pad(state.v), dt,
            ramped_inlet(opts, state), g, scene.params.inlet_profile,
            scene.params.flow_case, sem)
    kw = dict(row_offset=off, own_rows=(loc_h, loc_h + loc))
    got, ref = correct_bc(*args, **kw), correct_bc_plain(*args, **kw)
    compare("correct_bc row_offset", [
        (label, a[own] if a.dim() else a, b[own] if b.dim() else b, scaled(b, 1e-6))
        for label, a, b in zip(("u", "v", "p", "res_u", "res_v", "max_vel"), got, ref)],
        report,
        (time_ms(lambda: correct_bc(*args, **kw), 20),
         time_ms(lambda: correct_bc_plain(*args, **kw), 5)),
        bound(nbytes(*args[:6], *got[:3]), 20 * us.numel()))


def sharded_run(scene, state, shards, steps, no_sync):
    """``steps`` sharded steps on ``shards`` shards of one card from the
    unsharded or sharded ``state``, counted from counts set to 0 and timed
    by the host clock up to a synchronize; with ``no_sync`` under
    set_sync_debug_mode("error"). Returns (sharded state, diagnostics,
    seconds, launches)."""
    mesh = make_mesh(shards)
    if not isinstance(state.u, tuple):
        state = shard_state(state, mesh)
    run = make_run_shmap(scene, mesh, steps)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        state, diags = run(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, diags, time.perf_counter() - t0, read_counts()


def run_sharded(dev, launches, report, state_ref):
    """The row-sharded step on one card (shard/step_shmap.py; every shard
    on cuda:0): 2048^2 fast and sor on 4 shards, 5 warm-up steps then 100
    timed under the sync check, each beside its unsharded rate and with
    its shard-kernel launches counted exactly (shards x iters // k a
    step); the 800x264 default scene on 3 shards for 3 steps from phase
    4's end state ``state_ref``; 2048^2 FDM on 4 shards, 3 steps from
    rest. Returns (scene, sharded end state, shards, label) for each."""
    out = []
    for label, kernel, unsharded in (
            (FAST_SH, "jacobi_fused_k_shard", report["fast_2048_cell_updates_per_s"]),
            (SOR_SH, "sor_fused_k_shard", report[SOR]["cell_updates_per_s"])):
        make, shards, warmup, steps = SHARDED[label]
        scene = make()
        n, opts = scene.grid.nx, scene.opts
        k = (resolve_fuse_k(opts, divide=opts.jacobi_iters) if label == FAST_SH
             else sor_k(scene))
        state, _, _, _ = sharded_run(scene, scene.init_state(dev), shards, warmup, False)
        state, _, sec, launches[label] = sharded_run(scene, state, shards, steps, True)
        want = steps * shards * (opts.jacobi_iters // k)
        require(launches[label][kernel] == want,
                f"{label}: {launches[label][kernel]} {kernel} launches, not {want}")
        check_invariants(scene, gather_state(state, "cpu"), label)
        rate = n * n * steps / sec
        report[label] = {"cell_updates_per_s": rate, "steps_per_s": steps / sec,
                         "unsharded_cell_updates_per_s": unsharded, "k": k,
                         f"{kernel}_per_step": want // steps}
        print(f"[6] {label}: {steps} steps in {sec:.4f} s = {rate:.4e} cell-updates/s "
              f"({steps / sec:.2f} steps/s; unsharded {unsharded:.4e}, phases 5-6), "
              f"{shards} shards on one card, {want // steps} {kernel} launches a step "
              f"(k = {k}), no host sync (set_sync_debug_mode error)", flush=True)
        out.append((scene, state, shards, label))

    make, shards, _, _ = SHARDED[REF_SH]
    scene = make()
    state, diags, sec, launches[REF_SH] = sharded_run(scene, state_ref, shards, 3, False)
    check_invariants(scene, gather_state(state, "cpu"), REF_SH)
    k = resolve_fuse_k(scene.opts, divide=scene.opts.jacobi_iters)
    per_step = launches[REF_SH]["jacobi_fused_k_shard"] / shards / 3
    report[REF_SH] = {"steps_per_s": 3 / sec, "k": k,
                      "jacobi_fused_k_shard_per_shard_step": per_step,
                      "res_p": [float(x) for x in diags.res_p]}
    print(f"[6] {REF_SH}: 3 steps in {sec:.4f} s = {3 / sec:.2f} steps/s, {shards} shards "
          f"of {scene.grid.ny // shards} rows, {per_step:.1f} jacobi_fused_k_shard launches a "
          f"shard a step (k = {k}; early exits and outer rounds, one host read a "
          f"launch and a round), res_p {report[REF_SH]['res_p']}", flush=True)
    out.append((scene, state, shards, REF_SH))

    make, shards, _, steps = SHARDED[FDM_SH]
    scene = make()
    state, _, sec, launches[FDM_SH] = sharded_run(scene, scene.init_state(dev), shards,
                                                  steps, False)
    check_invariants(scene, gather_state(state, "cpu"), FDM_SH)
    report[FDM_SH] = {"steps_per_s": steps / sec}
    print(f"[6] {FDM_SH}: {steps} steps from rest in {sec:.4f} s (the rhs gathered and "
          f"the exact solve on one shard's device)", flush=True)
    out.append((scene, state, shards, FDM_SH))
    return out


def compare_sharded(scene, state, shards, label, steps=3):
    """3 steps from a sharded end state: sharded on the card against
    unsharded on the card, and against the CPU path (unsharded; the
    800x264 scene's sharded, whose launch-granular exits an unsharded
    run's exact ones would meet only k sweeps apart)."""
    mesh = make_mesh(shards)
    sharded = make_run_shmap(scene, mesh, steps)(state)
    a = (gather_state(sharded[0], "cpu"), sharded[1])
    whole = gather_state(state, dev_of(state))
    b = tc.make_run(scene, steps)(whole)
    ref = label == REF_SH
    k = resolve_fuse_k(scene.opts, divide=scene.opts.jacobi_iters) if ref else 1
    out = {"vs_unsharded": compare_runs(
        scene, a, b, label, steps, knife_edge=ref, sweeps_apart=k,
        what="sharded vs unsharded, both on the card")}
    cpu_start = gather_state(state, "cpu")
    if ref:
        cmesh = make_mesh(shards, "cpu")
        c = make_run_shmap(scene, cmesh, steps)(shard_state(cpu_start, cmesh))
        c = (gather_state(c[0], "cpu"), c[1])
        what = "sharded, CUDA vs CPU"
    else:
        c = tc.make_run(scene, steps)(cpu_start)
        what = "sharded CUDA vs unsharded CPU"
    out["vs_cpu"] = compare_runs(scene, a, c, label, steps, knife_edge=ref,
                                 sweeps_apart=k, what=what)
    return out


def dev_of(sharded_state):
    return sharded_state.u[0].device


def reset_counts():
    for wrapper, _, _, _ in KERNELS.values():
        wrapper.launches = 0
    for wrapper in (solve_correct_rounds, substep_batch, jacobi_batch, substep_batch_sor):
        wrapper.cluster_launches = 0
    solve_correct_rounds.slab_launches = 0
    for kernel in CAVITY_OF:
        KERNELS[kernel][0].cavity_launches = 0


def read_counts():
    counts = {name: w.launches for name, (w, _, _, _) in KERNELS.items()}
    counts[CLUSTER] = solve_correct_rounds.cluster_launches
    counts[SLAB] = solve_correct_rounds.slab_launches
    for name, key in BATCH_CLUSTER.items():
        counts[key] = KERNELS[name][0].cluster_launches
    for kernel, key in CAVITY_OF.items():
        counts[key] = KERNELS[kernel][0].cavity_launches
    return counts


def production_exits(scene, states, diags, cycles):
    """Name each step's exit: res_p below tol_r = projection_div_tol/dt
    ("tolerance"), or below the noise floor 4 eps (denom max|p'| +
    max|rhs|) with max|p'| the step's solution and rhs recomputed by the
    plain predictor ("noise floor"), or mgp_max_cycles cycles ("cycle
    cap"). Fails on any other step."""
    g, opts = scene.grid, scene.opts
    denom = 2 / g.dx ** 2 + 2 / g.dy ** 2
    out = []
    for i, d in enumerate(diags):
        s0, s1 = states[i], states[i + 1]
        rhs = predict_div_plain(s0.u, s0.v, s0.dt, s0.nu, g,
                                scene.params.velocity_scheme, opts.semantics)[2]
        tol_r = float(opts.projection_div_tol / s0.dt)
        floor = (opts.mgp_floor * EPS32
                 * (denom * float(s1.p_prime.abs().max()) + float(rhs.abs().max())))
        res = float(d.res_p)
        if res < tol_r:
            out.append("tolerance")
        elif res < floor * (1 + 1e-4):  # the floor, from a plain rhs
            out.append("noise floor")
        elif cycles[i] >= opts.mgp_max_cycles:
            out.append("cycle cap")
        else:
            raise RuntimeError(f"production step {i}: res_p {res} above tol_r "
                               f"{tol_r} and the floor {floor} after {cycles[i]} "
                               f"of {opts.mgp_max_cycles} cycles")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script measures the CUDA port and has no CPU mode")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[1] device: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    report = {"device": name, "nvidia_smi": smi}

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log").read_text()
    report["build_s"] = time.perf_counter() - t0
    print(f"[2] built/loaded {lib.name} in {report['build_s']:.1f} s "
          f"(nvcc log: {lib.with_suffix('.log')})", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip(), flush=True)

    results = {}
    check_kernels(dev, results)
    check_js_kernels(dev, results)
    check_mgp_kernels(dev, results)
    check_fdm(dev, report)
    check_ensemble_kernels(dev, results)
    check_sor_kernels(dev, results, report)
    check_mg_kernels(dev, results)
    check_multigrid_solve(dev, report)
    check_shard_kernels(dev, results, report)
    check_cavity_kernels(dev, results)
    check_cavity_mgp_kernels(dev, results)
    launches = {}

    scene_a = reference_scene()
    state_a, _ = tc.make_run(scene_a, 5)(scene_a.init_state(dev))
    run_a = tc.make_run(scene_a, 50)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state_a, diags_a = run_a(state_a)
    torch.cuda.synchronize()
    sec_a = time.perf_counter() - t0
    launches[REF] = read_counts()
    umin, umax = check_invariants(scene_a, state_a, "800x264")
    report["ref_800x264_steps_per_s"] = 50 / sec_a
    print(f"[4] 800x264 default scene: 50 steps in {sec_a:.4f} s = "
          f"{50 / sec_a:.2f} steps/s; u in [{umin:.4f}, {umax:.4f}], "
          f"res_p {float(state_a.res_p):.3e}, dt {float(state_a.dt):.5f}; "
          f"invariants hold", flush=True)

    scene_b = fast_scene()
    n = scene_b.grid.nx
    state_b, _ = tc.make_run(scene_b, 5)(scene_b.init_state(dev))
    run_b = tc.make_run(scene_b, 100)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state_b, _ = run_b(state_b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sec_b = time.perf_counter() - t0
    launches[FAST] = read_counts()
    check_invariants(scene_b, state_b, f"{n}^2 fast")
    rate = n * n * 100 / sec_b
    report["fast_2048_cell_updates_per_s"] = rate
    print(f"[5] {n}^2 fast: 100 steps in {sec_b:.4f} s = {rate:.4e} "
          f"cell-updates/s ({100 / sec_b:.2f} steps/s), no host sync "
          f"(set_sync_debug_mode error)", flush=True)

    # The production projection at 2048^2: one step at a time, to read the
    # V-cycles each ran (the exit already reads err once per cycle).
    scene_c = production_scene()
    steps_c = 20
    state_c, _ = tc.make_run(scene_c, 5)(scene_c.init_state(dev))
    step_c = tc.make_step(scene_c)
    states, diags_c, cycles = [state_c], [], []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps_c):
        c0 = vcycles_launched()
        state_c, d = step_c(state_c)
        cycles.append(vcycles_launched() - c0)
        states.append(state_c)
        diags_c.append(d)
    torch.cuda.synchronize()
    sec_c = time.perf_counter() - t0
    launches[PROD] = read_counts()
    check_invariants(scene_c, state_c, f"{n}^2 production")
    exits = production_exits(scene_c, states, diags_c, cycles)
    rate_c = n * n * steps_c / sec_c
    report["production_2048"] = {
        "cell_updates_per_s": rate_c, "steps_per_s": steps_c / sec_c,
        "vcycles_per_step": cycles, "exits": exits,
        "res_p": [float(d.res_p) for d in diags_c]}
    print(f"[6] {n}^2 production: {steps_c} steps in {sec_c:.4f} s = "
          f"{rate_c:.4e} cell-updates/s ({steps_c / sec_c:.2f} steps/s); "
          f"V-cycles per step {cycles} (mean {np.mean(cycles):.2f}); exits: "
          + ", ".join(f"{e} x{exits.count(e)}" for e in dict.fromkeys(exits)),
          flush=True)
    del states

    scene_d = production_scene(2047)
    init_d = scene_d.init_state(dev)
    torch.cuda.synchronize()
    reset_counts()
    state_d, diags_d = tc.make_run(scene_d, 3)(init_d)
    torch.cuda.synchronize()
    launches[ODD] = read_counts()
    check_invariants(scene_d, state_d, "2047^2 production")
    print(f"[6] 2047^2 production: 3 steps, res_p "
          f"{[float(x) for x in diags_d.res_p]}", flush=True)

    scene_e = tc.make_scene(tc.default_grid(), tc.SimulationParams(
        pressure_solver=tc.PressureSolver.MG_PRODUCTION))
    init_e = scene_e.init_state(dev)
    init_e.step.fill_(50)  # the inlet ramp half way up
    state_e, sec_e, launches[REF_PROD] = timed_run(scene_e, init_e, 3, False)
    check_invariants(scene_e, state_e, "800x264 production")
    require(launches[REF_PROD]["rounds"] == 0,
            "800x264 MG_PRODUCTION launched the Jacobi rounds kernel")
    report[REF_PROD] = {"steps_per_s": 3 / sec_e}
    print(f"[6] 800x264 production: 3 steps in {sec_e:.4f} s = {3 / sec_e:.2f} "
          f"steps/s, no rounds-kernel launch, res_p {float(state_e.res_p):.3e}",
          flush=True)

    (scene_f, state_f), (scene_g, state_g) = run_ensembles(dev, launches, report)
    sor_runs = run_sor(dev, launches, report)
    vertex_runs = run_vertex(dev, launches, report)
    js_runs = run_js(dev, launches, report)
    sharded_runs = run_sharded(dev, launches, report, state_a)
    cavity_runs = run_cavity(dev, launches, report)
    cavity_mgp_runs = run_cavity_production(dev, launches, report)

    report["cpu_compare"] = {
        "800x264": compare_with_cpu(scene_a, state_a, "800x264"),
        f"{n}^2 fast": compare_with_cpu(scene_b, state_b, f"{n}^2 fast"),
        f"{n}^2 production": compare_with_cpu(scene_c, state_c,
                                              f"{n}^2 production"),
        ENS64: compare_with_cpu(scene_f, state_f, ENS64, knife_edge=True),
        ENS8: compare_with_cpu(scene_g, take_scenes(state_g, [0, 7]),
                               f"{ENS8}, scenes 0 and 7", knife_edge=True)}
    for (scene, state), label in zip(sor_runs, (SOR, SOR_ODD, REF_SOR, ENS_SOR)):
        if label == ENS_SOR:
            state, label = take_scenes(state, [0, 15]), f"{ENS_SOR}, scenes 0 and 15"
        # the ensemble's solves exit at a live tolerance; the 800x264
        # scene's never reach it, and the 2048^2 and 2047^2 shapes run a
        # fixed schedule
        report["cpu_compare"][label] = compare_with_cpu(
            scene, state, label, knife_edge=label.startswith(ENS_SOR))
    for scene, state, label in vertex_runs:
        report["cpu_compare"][label] = compare_with_cpu(scene, state, label)
    # The JS twin's solves and the reference mode's exit at a live
    # tolerance; the JS QUICK shape runs a fixed schedule.
    for (scene, state, label), steps in zip(js_runs, (3, 2, 1)):
        report["cpu_compare"][label] = compare_with_cpu(
            scene, state, label, steps, knife_edge=label != JS_QUICK)
    for scene, state, shards, label in sharded_runs:
        report["cpu_compare"][label] = compare_sharded(scene, state, shards, label)
    for scene, state, label in cavity_runs:
        report["cpu_compare"][label] = compare_with_cpu(scene, state, label)
    report["cpu_compare"][CAV1024_RE1000] = compare_cavity_re1000(dev)
    # the legacy cycle's 21 solves a step run 630 V-cycles on the CPU too
    for (scene, state, label), steps in zip(cavity_mgp_runs, (3, 2)):
        report["cpu_compare"][label] = compare_with_cpu(scene, state, label, steps)

    for path, names in PATHS.items():
        counts = {k: launches[path][k] for k in names}
        print(f"[8] launches in the {path} run: {counts}", flush=True)
        for k, c in counts.items():
            require(c > 0, f"kernel {k} was not launched by the {path} run")
        if path in EXACT_PATHS:
            others = {k: c for k, c in launches[path].items()
                      if c and k not in names and FORM_OF.get(k) not in names}
            require(not others, f"the {path} run launched {others} as well")
        # the rounds route feeds each launch of kernel 4 one of kernel 1
        if "rounds" in names:
            require(launches[path]["predict_div"] == launches[path]["rounds"],
                    f"the {path} run launched predict_div {launches[path]['predict_div']} "
                    f"times for {launches[path]['rounds']} rounds-kernel launches")
    # The rounds kernel takes its cluster form on both scenes that launch
    # it: the default 800x264 scene and the JS twin's 400x132.
    for path, g in ((REF, tc.default_grid()), (JS_DEF, tc.default_js_grid())):
        require(plan("rounds", 1, g.ny, g.nx, dev).form == "cluster",
                f"kernels.cluster's plan gives the {path} grid no cluster")
        want = launches[path]["rounds"]
        require(launches[path][CLUSTER] == want,
                f"the {path} run launched the rounds kernel's cluster form "
                f"{launches[path][CLUSTER]} times of {launches[path]['rounds']}, "
                f"expected {want}")
    # The cavity paths launch kernels 2-4, 6-9, 18 and 19 in their CAVITY
    # instances alone, the channel paths never; kernel 4 takes its cluster
    # form at 512^2, 128^2 and 64^2, its slab form at 1024^2.
    for path in PATHS:
        for kernel, key in CAVITY_OF.items():
            n, want = launches[path][key], launches[path][kernel]
            want = want if path in CAVITY_PATHS else 0
            require(n == want, f"the {path} run launched {kernel}'s CAVITY instance "
                    f"{n} times of {launches[path][kernel]}, expected {want}")
    for path, n in ((CAV512, 512), (CAV1024, 1024), (CAV_JS, 128), (GHIA, 64)):
        cluster = path != CAV1024
        require((plan("rounds", 1, n, n, dev, cavity=True).form == "cluster") == cluster,
                f"the plan gives the {path} grid the wrong form")
        want = launches[path]["rounds"] if cluster else 0
        require(launches[path][CLUSTER] == want, f"the {path} run launched the rounds "
                f"kernel's cluster form {launches[path][CLUSTER]} times, expected {want}")
        want = launches[path]["rounds"] - want
        require(launches[path][SLAB] == want, f"the {path} run launched the rounds "
                f"kernel's slab form {launches[path][SLAB]} times, expected {want}")
    print(f"[8] the cavity paths launched kernels 2-4, 6-9, 18 and 19 in their CAVITY "
          f"instances only, kernel 4 in its cluster form at 512^2, 128^2 and 64^2 and its "
          f"slab form at 1024^2; no channel path launched a CAVITY instance",
          flush=True)
    # The ensembles take kernel 20's cluster form on all three paths, the
    # 8x800x264 one (beyond the block form's gate) and never kernel 12.
    for path, kernel, (batch, ny, nx) in (
            (ENS64, "substep_batch", (64, 96, 256)), (ENS8, "substep_batch", (8, 264, 800)),
            (ENS_SOR, "substep_batch_sor", (16, 96, 256))):
        n, n_cluster = launches[path][kernel], launches[path][BATCH_CLUSTER[kernel]]
        require(n_cluster == n, f"the {path} run launched {kernel}'s cluster form "
                f"{n_cluster} times of {n}")
        ctas = plan("substep_batch", batch, ny, nx, dev,
                    sor=kernel == "substep_batch_sor").ctas
        print(f"[8] the {path} run took {kernel}'s cluster form, {n} launches, "
              f"{ctas} CTAs a scene", flush=True)
    report["launches"] = launches

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[path][k], **results[k]}
               for k, (_, src, rep, path) in KERNELS.items()]
    kernels += [{"name": line, "route": "cuda", "source": KERNELS[k][1],
                 "replaces": KERNELS[k][2], "launches": launches[path][CAVITY_OF[k]],
                 **results[line]} for line, (k, path) in CAVITY_LINES.items()]
    report["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
