// Fused predictor + divergence, FIRST upwind, Rust semantics.
// Replaces cfd_demo_tpu/kernels/substep_pallas.py predict_div_pallas
// (_kernel_pre); the math is ops/predictor.py `predict` followed by
// ops/divergence.py `divergence_rhs`. See kernels/substep.py for the design note.
#include "predict.cuh"

namespace {

// One thread per (j, i) of the (ny, nx+1) index space. rhs(j, i) needs
// u*(j, i+1) and v*(j+1, i): the thread recomputes both rather than
// staging a tile in shared memory.
__global__ void predict_div_kernel(PredArgs A) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (j >= A.ny || i > A.nx) return;
    const float dt = A.scal[0], nu = A.scal[1];
    const float us = ustar_at(A, dt, nu, j, i);
    A.u_star[(size_t)j * (A.nx + 1) + i] = us;
    if (i == A.nx) return;
    const float vs = vstar_at(A, dt, nu, j, i);
    const size_t k = (size_t)j * A.nx + i;
    A.v_star[k] = vs;
    const float du = (ustar_at(A, dt, nu, j, i + 1) - us) / A.dx;
    const float dv = (vstar_at(A, dt, nu, j + 1, i) - vs) / A.dy;
    A.rhs[k] = (du + dv) / dt;
}

}  // namespace

extern "C" int cfd_predict_div(const float* u, const float* v, const float* scal,
                               float* u_star, float* v_star, float* rhs,
                               int ny, int nx, float dx, float dy, float dx2, float dy2,
                               int n_cyl, const float* cyl_host, void* stream) {
    PredArgs A{u, v, scal, u_star, v_star, rhs, ny, nx, dx, dy, dx2, dy2,
               make_cyl(n_cyl, cyl_host)};
    dim3 block(32, 8);
    dim3 grid((nx + 1 + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    predict_div_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
