// k damped-Jacobi sweeps on p' with folded boundary reads, CHANNEL flow.
// Replaces cfd_demo_tpu/kernels/jacobi_pallas.py jacobi_fused_k (_kernel).
// See kernels/jacobi.py for the design note; the sweep and the BC pass
// are in sweep.cuh.
#include "sweep.cuh"

// k sweeps from pp_in into `out` (pp_in is not written), ping-ponging
// through `tmp`; the last sweep writes per-block maxima to `partials`
// (size: the sweep grid's block count, see cfd_jacobi_partials), then one
// block applies the p' BCs and reduces them into err[0].
extern "C" int cfd_jacobi_partials(int ny, int nx) { return nparts(ny, nx); }

extern "C" int cfd_jacobi_fused_k(const float* pp_in, const float* rhs, float* out,
                                  float* tmp, float* partials, float* err,
                                  int ny, int nx, int k, float ax, float ay,
                                  float ar, float ac, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (k < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = run_sweeps(pp_in, rhs, out, tmp, partials, ny, nx, k,
                               ax, ay, ar, ac, st);
    if (e != cudaSuccess) return (int)e;
    bc_max_kernel<<<1, 1024, 0, st>>>(out, ny, nx, partials, nparts(ny, nx), err,
                                      nullptr, 0, nullptr);
    return (int)cudaGetLastError();
}
