"""CUDA-event times of the whole-field kernels on their 2048² states, for
comparing two checkouts of the port on one card.

    python3 -m cfd_demo_tpu_torch.kernel_times [--label NAME] [--out FILE.json]

times predict_div, jacobi_fused_k (k = 16), correct_bc, sor_fused_k and
sor_fused_k_rb2 (k = 8) as chip_smoke.py's phase 3 feeds them (the fast
and SOR shapes after 3 steps, the next rhs), each as the median of 5
means of 50 launches. The script uses only entry points that every
version of the port since its SOR slice has, so it can time an older
checkout as well: run it from that checkout's root with

    PYTHONPATH=. python3 /path/to/this/cfd_demo_tpu_torch/kernel_times.py

(the older tree's package is imported and built), and alternate the two
trees in one call on the card: A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.cells import fast_scene, sor_scene
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.kernels.jacobi import jacobi_fused_k
from cfd_demo_tpu_torch.kernels.substep import correct_bc, predict_div
from cfd_demo_tpu_torch.solver.piso import ramped_inlet

REPEATS, CALLS = 5, 50


def _mean_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def median_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_mean_ms(fn) for _ in range(REPEATS))


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
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    ap.add_argument("--out", help="also write the times to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    times = kernel_times(torch.device("cuda", 0))
    report = {"label": args.label, "package": tc.__file__, "nvidia_smi": smi,
              "ms": times}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
