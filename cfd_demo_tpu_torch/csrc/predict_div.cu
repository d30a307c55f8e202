// Fused predictor + divergence. Replaces
// cfd_demo_tpu/kernels/substep_pallas.py predict_div_pallas (_kernel_pre);
// the math is ops/predictor.py `predict` followed by ops/divergence.py
// `divergence_rhs`, for each scheme (FIRST, SECOND, QUICK) and semantics
// (Rust's unaveraged or JS's averaged convecting v), on the whole field or
// on a row block of a sharded one at a global row offset. See
// kernels/substep.py for the design note.
#include "predict.cuh"

namespace {

// One thread per (j, i) of the (ny, nx+1) index space. rhs(j, i) needs
// u*(j, i+1) and v*(j+1, i): the thread recomputes both rather than
// staging a tile in shared memory.
template <int S, bool AVG>
__global__ void predict_div_kernel(PredArgs A) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (j >= A.ny || i > A.nx) return;
    const float dt = A.scal[0], nu = A.scal[1];
    const float us = ustar_at<S, AVG>(A, dt, nu, j, i);
    A.u_star[(size_t)j * (A.nx + 1) + i] = us;
    if (i == A.nx) return;
    const float vs = vstar_at<S>(A, dt, nu, j, i);
    const size_t k = (size_t)j * A.nx + i;
    A.v_star[k] = vs;
    const float du = (ustar_at<S, AVG>(A, dt, nu, j, i + 1) - us) / A.dx;
    const float dv = (vstar_at<S>(A, dt, nu, j + 1, i) - vs) / A.dy;
    A.rhs[k] = (du + dv) / dt;
}

template <int S, bool AVG>
void launch(const PredArgs& A, dim3 grid, dim3 block, cudaStream_t st) {
    predict_div_kernel<S, AVG><<<grid, block, 0, st>>>(A);
}

}  // namespace

// scheme: 0 FIRST, 1 SECOND, 2 QUICK; avg: 1 for JS's averaged convecting v.
// The arrays hold ny rows, global rows [row_off, row_off + ny) of a
// gny-row grid (row_off = 0, gny = ny: the whole field); the masks hold
// the whole grid.
extern "C" int cfd_predict_div(const float* u, const float* v, const float* scal,
                               float* u_star, float* v_star, float* rhs,
                               const uint8_t* mask_u, const uint8_t* mask_v,
                               int ny, int nx, int row_off, int gny, float dx, float dy,
                               float dx2, float dy2, int scheme, int avg, void* stream) {
    PredArgs A{u, v, scal, u_star, v_star, rhs, mask_u, mask_v, ny, nx, row_off, gny,
               dx, dy, dx2, dy2};
    dim3 block(32, 8);
    dim3 grid((nx + 1 + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    cudaStream_t st = (cudaStream_t)stream;
    switch (scheme * 2 + (avg ? 1 : 0)) {
        case 0: launch<FIRST, false>(A, grid, block, st); break;
        case 1: launch<FIRST, true>(A, grid, block, st); break;
        case 2: launch<SECOND, false>(A, grid, block, st); break;
        case 3: launch<SECOND, true>(A, grid, block, st); break;
        case 4: launch<QUICK, false>(A, grid, block, st); break;
        case 5: launch<QUICK, true>(A, grid, block, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
