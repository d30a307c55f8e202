"""CUDA-event times of the whole-field kernels on their 2048² states, for
comparing two checkouts of the port on one card.

    python3 -m cfd_demo_tpu_torch.kernel_times [--label NAME] [--out FILE.json]

times predict_div, jacobi_fused_k (k = 16), correct_bc, sor_fused_k and
sor_fused_k_rb2 (k = 8) as chip_smoke.py's phase 3 feeds them (the fast
and SOR shapes after 3 steps, the next rhs), each as the median of 5
means of 50 launches, and the rounds kernel on the 800x264 default
scene after 55 steps (phase 3's state, every outer round run), the
median of 5 means of 5 (and its cooperative form there, where the tree
has two forms). The script uses only entry points that every
version of the port since its SOR slice has, so it can time an older
checkout as well: run it from that checkout's root with

    PYTHONPATH=. python3 /path/to/this/cfd_demo_tpu_torch/kernel_times.py

(the older tree's package is imported and built), and alternate the two
trees in one call on the card: A, B, B, A.

    python3 -m cfd_demo_tpu_torch.kernel_times --rounds-forms [--out FILE.json]

times the rounds kernel's cluster and cooperative forms on the same
inputs (the default scene's 30 x 10 channel at ROUNDS_SHAPES after 55
steps), the measurement behind the cluster rule, and

    python3 -m cfd_demo_tpu_torch.kernel_times --tiles [--out FILE.json]

instead rebuilds csrc/jacobi.cu once for each candidate of TILES (its
kJT_* macros: sweeps a launch, thread rows, rows a thread), all nvcc's
started together, and times jacobi_fused_k at k = 16 on the same 2048²
state with each, requiring each to give the built library's bits; the
fastest was fixed as jacobi.cu's constants.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import subprocess
import sys

import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.cells import fast_scene, reference_scene, rounds_args, sor_scene
from cfd_demo_tpu_torch.kernels import _build
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.kernels.jacobi import _multipliers, jacobi_fused_k
from cfd_demo_tpu_torch.kernels.rounds import solve_correct_rounds
from cfd_demo_tpu_torch.kernels.substep import correct_bc, predict_div
from cfd_demo_tpu_torch.solver.piso import ramped_inlet

REPEATS, CALLS = 5, 50
# jacobi_fused_k's tile candidates: (sweeps a launch t, thread rows, rows
# a thread); the window is (rows x thread rows) by 128 cells, the owned
# tile that less 2t each way.
TILES = [(4, 8, 8), (4, 16, 4), (4, 16, 8), (4, 32, 4), (8, 16, 4), (8, 16, 8),
         (8, 32, 4), (8, 8, 16), (16, 16, 8), (16, 32, 4)]


def _mean_ms(fn, calls) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def median_ms(fn, calls: int = CALLS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_mean_ms(fn, calls) for _ in range(REPEATS))


def kernel_times(dev) -> dict:
    out = {}
    scene = fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    sch, sem = scene.params.velocity_scheme, opts.semantics
    u, v, dt, nu = state.u, state.v, state.dt, state.nu
    out["predict_div"] = median_ms(lambda: predict_div(u, v, dt, nu, g, sch, sem))
    us, vs, rhs = predict_div(u, v, dt, nu, g, sch, sem)
    pp = state.p_prime
    out["jacobi_fused_k"] = median_ms(
        lambda: jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, 16))
    pp = jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, 16)[0]
    args = (us, vs, state.p, pp, u, v, dt, ramped_inlet(opts, state), g,
            scene.params.inlet_profile, scene.params.flow_case, sem)
    out["correct_bc"] = median_ms(lambda: correct_bc(*args))

    scene = sor_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                      scene.params.velocity_scheme, opts.semantics)[2]
    pp, om = state.p_prime, opts.sor_omega
    out["sor_fused_k"] = median_ms(lambda: ksor.sor_fused_k(pp, rhs, g.dx, g.dy, om, 8))
    split = ksor.sor_compress(pp) + ksor.sor_compress(rhs)
    out["sor_fused_k_rb2"] = median_ms(
        lambda: ksor.sor_fused_k_rb2(*split, g.dx, g.dy, om, 8))

    scene = reference_scene()
    state, _ = tc.make_run(scene, 55)(scene.init_state(dev))
    args = rounds_args(scene, state)
    out["rounds"] = median_ms(lambda: solve_correct_rounds(*args), 5)
    if hasattr(solve_correct_rounds, "cluster_launches"):  # it has two forms
        out["rounds_cooperative_form"] = median_ms(
            lambda: solve_correct_rounds(*args, form="cooperative"), 5)
    out["rounds_counts"] = solve_correct_rounds(*args)[5].tolist()
    return out


# (ny, nx) of the default scene's channel, from the JS twin's 400x132 up
# to the Rust app's 800x264
ROUNDS_SHAPES = [(132, 400), (165, 500), (198, 600), (231, 700), (264, 800)]


def rounds_form_times(dev) -> list:
    """Both forms of the rounds kernel on the same inputs at each of
    ROUNDS_SHAPES (the cluster form where the card takes it): ms a launch
    and the sweeps it ran, median of 5 means of 5 launches each."""
    out, g = [], tc.default_grid()
    for ny, nx in ROUNDS_SHAPES:
        scene = tc.make_scene(tc.Grid(nx=nx, ny=ny, lx=g.lx, ly=g.ly, obstacles=g.obstacles))
        state, _ = tc.make_run(scene, 55)(scene.init_state(dev))
        args = rounds_args(scene, state)
        row = {"shape": [ny, nx]}
        for form in ("cluster", "cooperative"):
            try:
                counts = solve_correct_rounds(*args, form=form)[5].tolist()
            except ValueError:  # the cluster form does not take the grid
                continue
            row[form] = {"ms": median_ms(lambda: solve_correct_rounds(*args, form=form), 5),
                         "counts": counts}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def tile_times(dev) -> list:
    """jacobi_fused_k (k = 16) on the 2048² fast state with jacobi.cu
    built for each of TILES; each must give the built library's bits."""
    scene = fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                      scene.params.velocity_scheme, opts.semantics)[2]
    pp, k = state.p_prime, 16
    ny, nx = pp.shape
    ref = jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, k)
    mult = _multipliers(g.dx, g.dy, opts.jacobi_omega)
    srcs = [_build.SRC_DIR / "jacobi.cu", _build.SRC_DIR / "errors.cu"]

    def build(tile):
        name = "tile_" + "_".join(map(str, tile))
        lib = _build.BUILD_DIR / "tiles" / f"{name}.so"
        defines = [f"-DkJT_{m}={v}" for m, v in zip(("T", "BY", "R"), tile)]
        _build.compile_library(lib, srcs, [*_build.FLAGS, *defines])
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(TILES)) as pool:
        libs = list(pool.map(build, TILES))
    out = []
    for tile, path in zip(TILES, libs):
        lib = ctypes.CDLL(str(path))
        fn = lib.cfd_jacobi_fused_k
        fn.argtypes = _build._SIGNATURES["cfd_jacobi_fused_k"]
        o, t, e = torch.empty_like(pp), torch.empty_like(pp), torch.empty((), device=dev)

        def call():
            _build.check(fn(pp.data_ptr(), rhs.data_ptr(), o.data_ptr(), t.data_ptr(),
                            e.data_ptr(), ny, nx, k, *mult, _build.stream_of(pp)),
                         f"jacobi_fused_k tile {tile}")

        call()
        torch.cuda.synchronize()
        same = bool(torch.equal(o, ref[0])) and bool(torch.equal(e, ref[1]))
        log = path.with_suffix(".log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "tiled_kernel" in ln
                or ("registers" in ln and "Used" in ln)]
        out.append({"tile": tile, "ms": median_ms(call), "same_bits": same,
                    "ptxas": regs[-2:]})
        print(json.dumps(out[-1]), flush=True)
        if not same:
            raise RuntimeError(f"jacobi_fused_k tile {tile} changed the bits")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    ap.add_argument("--out", help="also write the times to this JSON file")
    ap.add_argument("--tiles", action="store_true",
                    help="time jacobi_fused_k built with each tile of TILES instead")
    ap.add_argument("--rounds-forms", action="store_true",
                    help="time the rounds kernel's two forms at ROUNDS_SHAPES instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    times = (tile_times(dev) if args.tiles else rounds_form_times(dev) if args.rounds_forms
             else kernel_times(dev))
    report = {"label": args.label, "package": tc.__file__, "nvidia_smi": smi,
              "ms": times}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
