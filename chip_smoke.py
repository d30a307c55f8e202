#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_demo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Phases, one line each; any failure raises and exits non-zero:

1. require CUDA; print the device and `nvidia-smi` name and power limit;
2. build the kernels from cfd_demo_tpu_torch/csrc with nvcc;
3. hold each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes (2048^2 for predict_div, jacobi_fused_k and
   correct_bc on a state after a few steps; 800x264 for the rounds
   kernel, on the state phase 4 ends at, where every step runs all its
   outer rounds, with the same count of rounds and sweeps required), and
   time both with CUDA events;
4. run the 800x264 default scene (the Rust app's) for 50 steps with
   make_run, print steps/s and check its physical invariants;
5. run the benchmark's fast shape at 2048^2 (bench.py --mode fast):
   5 warm-up steps, then 100 timed steps under
   torch.cuda.set_sync_debug_mode("error"), print cell-updates/s;
6. from the end states of 4 and 5, run 3 steps on CUDA and on the
   port's CPU path and compare u, v, grad p and mean-removed p;
7. require every kernel's launch count from phases 4-5 to be above 0.

The line before the last is a JSON object with each kernel's numbers;
the last is {"ok": true, "device": {...}}. It needs one card and no
network. ``--out`` also writes every number to a JSON file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.cells import fast_scene, reference_scene, rounds_args
from cfd_demo_tpu_torch.kernels import _build
from cfd_demo_tpu_torch.kernels.jacobi import jacobi_fused_k, jacobi_fused_k_plain
from cfd_demo_tpu_torch.kernels.rounds import (solve_correct_rounds,
                                               solve_correct_rounds_plain)
from cfd_demo_tpu_torch.kernels.substep import (correct_bc, correct_bc_plain,
                                                predict_div, predict_div_plain)
from cfd_demo_tpu_torch.solver.piso import ramped_inlet

EPS32 = float(np.finfo(np.float32).eps)
# p's f32 resolution. p reaches thousands on the 800x264 scene, and there
# the CUDA and CPU paths' p differ by about 3 ulps of max|p| (L2), as two
# f32 orders of the same arithmetic over some thousand sweeps do; so grad
# p is held to its golden bound plus this many ulps of max|p| over h.
GRAD_P_ULPS = 6
KERNELS = {  # name -> (wrapper, source, the Pallas call site it replaces)
    "predict_div": (predict_div, "cfd_demo_tpu_torch/csrc/predict_div.cu",
                    "cfd_demo_tpu/kernels/substep_pallas.py:288"),
    "jacobi_fused_k": (jacobi_fused_k, "cfd_demo_tpu_torch/csrc/jacobi.cu",
                       "cfd_demo_tpu/kernels/jacobi_pallas.py:1088"),
    "correct_bc": (correct_bc, "cfd_demo_tpu_torch/csrc/correct_bc.cu",
                   "cfd_demo_tpu/kernels/substep_pallas.py:459"),
    "rounds": (solve_correct_rounds, "cfd_demo_tpu_torch/csrc/rounds.cu",
               "cfd_demo_tpu/kernels/rounds_pallas.py:156"),
}


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
    dx = lambda p: np.diff(p, axis=1) / g.dx
    dy = lambda p: np.diff(p, axis=0) / g.dy
    unit = float(np.spacing(np.float32(np.abs(pb).max()))) / min(g.dx, g.dy)
    x = max(l2(dx(pa) - dx(pb)), l2(dy(pa) - dy(pb)))
    return x, 1e-4 * max(1.0, l2(dx(pb))) + GRAD_P_ULPS * unit, unit


def compare(name, pairs, results, timing):
    """pairs: (label, kernel out, plain out, atol). Checks, prints one
    line and records the kernel's entry."""
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
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
         time_ms(lambda: predict_div_plain(u, v, dt, nu, g, sch, sem), 20)))
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
                                              opts.jacobi_omega, k), 10)))
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
         time_ms(lambda: correct_bc_plain(*args), 20)))

    # The rounds kernel at 800x264 on the state phase 4 ends at (55 steps),
    # where every step runs all its outer rounds, fed what the main path
    # feeds it: the plain predictor's u*, v*, rhs. The exits are exact on
    # both sides, so both must run the same rounds and sweeps.
    scene = reference_scene()
    g = scene.grid
    state, _ = tc.make_run(scene, 55)(scene.init_state(dev))
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
         time_ms(lambda: solve_correct_rounds_plain(*args), 3, warmup=1)))


def check_invariants(scene, state, label):
    u, v = state.u.cpu().numpy(), state.v.cpu().numpy()
    for name, a in (("u", u), ("v", v), ("p", state.p.cpu().numpy())):
        require(bool(np.isfinite(a).all()), f"{label}: {name} not finite")
    require(not u[0].any() and not u[-1].any(), f"{label}: u rows 0/ny-1 not 0")
    require(not v[0].any(), f"{label}: v row 0 not 0")
    require(not u[scene.mask_u_bc > 0].any(), f"{label}: u on mask_u_bc not 0")
    return float(u.min()), float(u.max())


def compare_with_cpu(scene, state_dev, label, steps=3):
    """steps of the slice on the card and on the port's CPU path from the
    same state: u, v, grad p and mean-removed p at the golden bounds
    (tests/test_golden.py:116-141), grad p with p's f32 resolution
    (grad_p_l2)."""
    state_cpu = tc.state_from_numpy(tc.state_to_numpy(state_dev), "cpu")
    run = tc.make_run(scene, steps)
    a, _ = run(state_dev)
    b, _ = run(state_cpu)
    g = scene.grid
    l2 = lambda x, y: float(np.sqrt(np.mean((x - y) ** 2)))
    rms = lambda x: max(1.0, float(np.sqrt(np.mean(x ** 2))))
    out = {}
    for f in ("u", "v"):
        x, y = (getattr(s, f).cpu().double().numpy() for s in (a, b))
        out[f] = (l2(x, y), 1e-5 * rms(y))
    pa, pb = (s.p.cpu().double().numpy() for s in (a, b))
    gp, gp_bound, unit = grad_p_l2(pa, pb, g)
    out["grad_p"] = (gp, gp_bound)
    d = pa - pb
    out["p_demeaned"] = (l2(d - d.mean(), 0.0), 1e-5 * rms(pb))
    print(f"[6] {label}: {steps} steps CUDA vs CPU, L2 "
          + ", ".join(f"{k}={x:.3e} (bound {t:.2e})" for k, (x, t) in out.items())
          + f"; grad p {gp / unit:.2f} ulp(max|p|)/h", flush=True)
    for k, (x, t) in out.items():
        require(x <= t, f"{label}: CUDA vs CPU {k} L2 {x} > {t}")
    return {k: x for k, (x, _) in out.items()}


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

    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0

    scene_a = reference_scene()
    state_a, _ = tc.make_run(scene_a, 5)(scene_a.init_state(dev))
    run_a = tc.make_run(scene_a, 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_a, diags_a = run_a(state_a)
    torch.cuda.synchronize()
    sec_a = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state_b, _ = run_b(state_b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sec_b = time.perf_counter() - t0
    check_invariants(scene_b, state_b, f"{n}^2 fast")
    rate = n * n * 100 / sec_b
    report["fast_2048_cell_updates_per_s"] = rate
    print(f"[5] {n}^2 fast: 100 steps in {sec_b:.4f} s = {rate:.4e} "
          f"cell-updates/s ({100 / sec_b:.2f} steps/s), no host sync "
          f"(set_sync_debug_mode error)", flush=True)

    launches = {k: w.launches for k, (w, _, _) in KERNELS.items()}
    report["cpu_compare"] = {
        "800x264": compare_with_cpu(scene_a, state_a, "800x264"),
        f"{n}^2 fast": compare_with_cpu(scene_b, state_b, f"{n}^2 fast")}

    print(f"[7] launches during phases 4-5: {launches}", flush=True)
    for k, c in launches.items():
        require(c > 0, f"kernel {k} was not launched by the main path")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], **results[k]}
               for k, (_, src, rep) in KERNELS.items()]
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
