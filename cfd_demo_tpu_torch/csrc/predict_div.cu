// Fused predictor + divergence, FIRST upwind, Rust semantics.
// Replaces cfd_demo_tpu/kernels/substep_pallas.py predict_div_pallas
// (_kernel_pre); the math is ops/predictor.py `predict` followed by
// ops/divergence.py `divergence_rhs`. See kernels/substep.py for the design note.
#include "common.cuh"

namespace {

struct PredArgs {
    const float* u;   // (ny, nx+1)
    const float* v;   // (ny, nx)
    const float* scal;  // device [dt_sub, nu]
    float* u_star;    // (ny, nx+1)
    float* v_star;    // (ny, nx)
    float* rhs;       // (ny, nx)
    int ny, nx;
    float dx, dy, dx2, dy2;  // f32(dx), f32(dy), f32(dx*dx), f32(dy*dy)
    Cyl cyl;
};

// Zero-filled reads outside the array (ops/stencil.py `shifted`).
__device__ __forceinline__ float ld(const float* a, int rows, int cols, int j, int i) {
    return (j >= 0 && j < rows && i >= 0 && i < cols) ? __ldg(a + (size_t)j * cols + i) : 0.0f;
}

// u*(j, i) for i in [0, nx], exactly as ops/predictor.py computes it.
__device__ float ustar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1;
    const float uC = ld(A.u, ny, wu, j, i);
    if (!(i >= 1 && i <= nx - 1 && j >= 1 && j <= ny - 2)) return uC;
    if (mask_u_star(A.cyl, j, i, nx, A.dx, A.dy)) return 0.0f;
    const float uE = ld(A.u, ny, wu, j, i + 1), uW = ld(A.u, ny, wu, j, i - 1);
    const float uN = ld(A.u, ny, wu, j + 1, i), uS = ld(A.u, ny, wu, j - 1, i);
    const float vNE = ld(A.v, ny, nx, j + 1, i), vSE = ld(A.v, ny, nx, j, i);
    const float e = (0.5f * (uC + uE) >= 0.0f) ? uC : uE;
    const float w = (0.5f * (uW + uC) >= 0.0f) ? uW : uC;
    const float n = (vNE >= 0.0f) ? uC : uN;  // unaveraged v (model.rs:977)
    const float s = (vSE >= 0.0f) ? uS : uC;
    const float conv = (e * e - w * w) / A.dx + (vNE * n - vSE * s) / A.dy;
    const float lap = ((uE - 2.0f * uC) + uW) / A.dx2 + ((uN - 2.0f * uC) + uS) / A.dy2;
    return uC + dt * (-conv + nu * lap);
}

// v*(j, i) for i in [0, nx-1]; j = ny is v's implicit zero top row.
__device__ float vstar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1;
    if (j >= ny) return 0.0f;
    const float vC = ld(A.v, ny, nx, j, i);
    if (!(i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 1)) return vC;
    if (mask_v_star(A.cyl, j, i, A.dx, A.dy)) return 0.0f;
    const float vE = ld(A.v, ny, nx, j, i + 1), vW = ld(A.v, ny, nx, j, i - 1);
    const float vN = ld(A.v, ny, nx, j + 1, i), vS = ld(A.v, ny, nx, j - 1, i);
    const float u_e = ld(A.u, ny, wu, j, i + 1), u_w = ld(A.u, ny, wu, j, i);
    const float e = (u_e >= 0.0f) ? vC : vE;
    const float w = (u_w >= 0.0f) ? vW : vC;
    const float n = (0.5f * (vC + vN) >= 0.0f) ? vC : vN;
    const float s = (0.5f * (vS + vC) >= 0.0f) ? vS : vC;
    const float conv = (u_e * e - u_w * w) / A.dx + (n * n - s * s) / A.dy;
    const float lap = ((vE - 2.0f * vC) + vW) / A.dx2 + ((vN - 2.0f * vC) + vS) / A.dy2;
    return vC + dt * (-conv + nu * lap);
}

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
