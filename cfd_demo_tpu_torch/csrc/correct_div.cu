// Fused corrector + the next outer round's divergence (Rust outer corrector
// rounds, model.rs:696-724). Replaces cfd_demo_tpu/kernels/substep_pallas.py
// correct_div_pallas (_kernel_round); the math is ops/corrector.py `correct`
// then ops/divergence.py `divergence_rhs` of the corrected fields. See
// kernels/substep.py for the design note.
#include "common.cuh"

namespace {

struct CdArgs {
    const float* us;    // u* (ny, nx+1)
    const float* vs;    // v* (ny, nx)
    const float* p;     // (ny, nx)
    const float* pp;    // p' (ny, nx)
    const float* scal;  // device [dt_sub]
    float* u;
    float* v;
    float* p_out;
    float* rhs;         // the divergence RHS of (u, v)
    int ny, nx;
    float dx, dy;
};

// ops/corrector.py on u face (j, i), i in [0, nx].
__device__ __forceinline__ float u_corrected(const CdArgs& A, float dt, int j, int i) {
    const float s = __ldg(A.us + (size_t)j * (A.nx + 1) + i);
    if (i < 1 || i > A.nx - 1) return s;
    const size_t kp = (size_t)j * A.nx + i;
    return s - dt * (__ldg(A.pp + kp) - __ldg(A.pp + kp - 1)) / A.dx;
}

// ops/corrector.py on v face (j, i); j = ny is v's implicit zero top row.
__device__ __forceinline__ float v_corrected(const CdArgs& A, float dt, int j, int i) {
    if (j >= A.ny) return 0.0f;
    const size_t k = (size_t)j * A.nx + i;
    const float s = __ldg(A.vs + k);
    if (j < 1) return s;
    return s - dt * (__ldg(A.pp + k) - __ldg(A.pp + k - A.nx)) / A.dy;
}

// One thread per (j, i) of the (ny, nx+1) index space. rhs(j, i) needs the
// corrected u(j, i+1) and v(j+1, i): the thread recomputes both in
// registers rather than staging a tile.
__global__ void correct_div_kernel(CdArgs A) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (j >= A.ny || i > A.nx) return;
    const float dt = A.scal[0];
    const float uc = u_corrected(A, dt, j, i);
    A.u[(size_t)j * (A.nx + 1) + i] = uc;
    if (i == A.nx) return;
    const size_t k = (size_t)j * A.nx + i;
    const float vc = v_corrected(A, dt, j, i);
    A.v[k] = vc;
    A.p_out[k] = __ldg(A.p + k) + __ldg(A.pp + k);
    const float du = (u_corrected(A, dt, j, i + 1) - uc) / A.dx;
    const float dv = (v_corrected(A, dt, j + 1, i) - vc) / A.dy;
    A.rhs[k] = (du + dv) / dt;
}

}  // namespace

extern "C" int cfd_correct_div(const float* us, const float* vs, const float* p,
                               const float* pp, const float* scal, float* u, float* v,
                               float* p_out, float* rhs, int ny, int nx, float dx,
                               float dy, void* stream) {
    CdArgs A{us, vs, p, pp, scal, u, v, p_out, rhs, ny, nx, dx, dy};
    dim3 block(32, 8);
    dim3 grid((nx + 1 + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    correct_div_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
