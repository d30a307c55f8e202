// The folded damped-Jacobi sweep on the full p' array and the p' BC
// refresh, shared by jacobi.cu and mgp.cu (CHANNEL flow).
#pragma once

#include "common.cuh"

namespace {

// Every full-array and coarse-level pass here uses 32 x 8 blocks.
constexpr int kBX = 32;
constexpr int kBY = 8;

inline dim3 grid_for(int rows, int cols) {
    return dim3((cols + kBX - 1) / kBX, (rows + kBY - 1) / kBY);
}

// Blocks of grid_for(rows, cols): the length of a block-maxima array.
inline int nparts(int rows, int cols) {
    const dim3 g = grid_for(rows, cols);
    return (int)(g.x * g.y);
}

struct SweepArgs {
    const float* src;
    const float* rhs;
    float* dst;
    float* partials;  // per-block max |delta|, or nullptr
    int ny, nx;
    float ax, ay, ar, ac;  // jacobi_pallas.py:87-94
};

// One sweep over the interior (j in [1, ny-2], i in [1, nx-2]). Boundary
// reads are folded (jacobi_pallas.py:110-135): a Neumann neighbour reads
// the cell itself and the Dirichlet outlet reads 0, so no boundary cell
// of `src` is read and boundary cells of `dst` are left unwritten.
__global__ void sweep_kernel(SweepArgs A) {
    __shared__ float sh[33];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int ny = A.ny, nx = A.nx;
    float d = 0.0f;
    if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) {
        const size_t k = (size_t)j * nx + i;
        const float c = A.src[k];
        const float E = (i == nx - 2) ? 0.0f : A.src[k + 1];
        const float W = (i == 1) ? c : A.src[k - 1];
        const float N = (j == ny - 2) ? c : A.src[k + nx];
        const float S = (j == 1) ? c : A.src[k - nx];
        const float nv = A.ax * (E + W) + A.ay * (N + S) + A.ac * c - A.ar * A.rhs[k];
        A.dst[k] = nv;
        d = fabsf(nv - c);
    }
    if (A.partials != nullptr) {
        d = block_max(d, sh);
        if (threadIdx.x == 0 && threadIdx.y == 0)
            A.partials[blockIdx.y * gridDim.x + blockIdx.x] = d;
    }
}

// k sweeps from `src` (not written), ping-ponging through `tmp` so that
// the last lands in `out`; the last one writes per-block maxima to
// `partials` when that is not null. k == 0 copies src to out.
inline cudaError_t run_sweeps(const float* src, const float* rhs, float* out,
                              float* tmp, float* partials, int ny, int nx, int k,
                              float ax, float ay, float ar, float ac,
                              cudaStream_t st) {
    if (k == 0) {
        if (src == out) return cudaSuccess;
        return cudaMemcpyAsync(out, src, sizeof(float) * (size_t)ny * nx,
                               cudaMemcpyDeviceToDevice, st);
    }
    for (int s = 0; s < k; ++s) {
        float* dst = ((k - 1 - s) & 1) ? tmp : out;
        SweepArgs A{src, rhs, dst, (s == k - 1) ? partials : nullptr, ny, nx,
                    ax, ay, ar, ac};
        sweep_kernel<<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(A);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        src = dst;
    }
    return cudaSuccess;
}

// The boundary cell b of 2 * nx + 2 * (ny - 2) (2 rows of nx, then 2
// columns of ny-2) as (j, i), and the interior cell (jj, ii) whose value
// the p' BCs copy into it (ops/poisson.py _apply_pprime_bcs, rows then
// columns: a corner takes the diagonal interior cell); false for the
// outlet column, which is 0 (Dirichlet).
__device__ __forceinline__ bool ring_cell(int b, int ny, int nx, int& j, int& i,
                                          int& jj, int& ii) {
    if (b < 2 * nx) { j = (b < nx) ? 0 : ny - 1; i = b % nx; }
    else { const int c = b - 2 * nx; j = 1 + c % (ny - 2); i = (c < ny - 2) ? 0 : nx - 1; }
    ii = (i == 0) ? 1 : i;                             // left copies column 1
    jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;    // rows first
    return i != nx - 1;
}

// The p' BCs once (ops/poisson.py _apply_pprime_bcs, rows then columns),
// written from interior values only, then the max over each of one or
// two arrays of block maxima (pb may be null). One block.
__global__ void bc_max_kernel(float* pp, int ny, int nx, const float* pa,
                              int na, float* oa, const float* pb, int nb,
                              float* ob) {
    __shared__ float sh[33];
    const int tid = threadIdx.x;
    const int nbc = 2 * nx + 2 * (ny - 2);
    for (int b = tid; b < nbc; b += blockDim.x) {
        int j, i, jj, ii;
        const bool copy = ring_cell(b, ny, nx, j, i, jj, ii);
        pp[(size_t)j * nx + i] = copy ? pp[(size_t)jj * nx + ii] : 0.0f;
    }
    float m = 0.0f;
    for (int b = tid; b < na; b += blockDim.x) m = pmax(m, pa[b]);
    m = block_max(m, sh);
    if (tid == 0) *oa = m;
    if (pb != nullptr) {
        m = 0.0f;
        for (int b = tid; b < nb; b += blockDim.x) m = pmax(m, pb[b]);
        m = block_max(m, sh);
        if (tid == 0) *ob = m;
    }
}

}  // namespace
