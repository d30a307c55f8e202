// The folded damped-Jacobi sweep and the p' BC refresh, shared by
// jacobi.cu, sor.cu, mgp.cu and mg.cu, on the whole p' array or on a block
// of it: a sharded tier's halo-extended row (or row and column) block,
// whose global rows and columns decide the interior, the folds and the BC
// cells (Block). The whole array's passes take CHANNEL or CAVITY flow (a
// template flag: the east fold and the ring; the CHANNEL instances are the
// code they were before the flag); a block's are CHANNEL only.
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

// Where a (ny, nx) array lies in the global (gny, gnx) one: local (j, i)
// is global (j + row_off, i + col_off), and offsets may be negative (a
// halo below or left of the grid). own_* are the local rows and columns
// a residual counts (a shard's own, not its halo).
struct Block {
    int row_off, col_off, gny, gnx;
    int own_lo, own_hi, own_clo, own_chi;
};

// The whole array: every cell owned.
inline Block whole(int ny, int nx) { return Block{0, 0, ny, nx, 0, ny, 0, nx}; }

// The passes below are templated on BLK: false is the whole array, where
// the block's tests reduce to the plain ones and are compiled out (the
// general form costs the whole-array sweep 12%, kernel_times.py on an
// NVIDIA H100 80GB HBM3, 700.00 W); true is a block of a sharded grid.

// True when local (j, i) is a global interior cell inside the array.
template <bool BLK>
__device__ __forceinline__ bool interior(const Block& B, int ny, int nx, int j, int i) {
    if (!BLK) return i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2;
    const int gj = j + B.row_off, gi = i + B.col_off;
    return j < ny && i < nx && gi >= 1 && gi <= B.gnx - 2 && gj >= 1 && gj <= B.gny - 2;
}

template <bool BLK>
__device__ __forceinline__ bool owned(const Block& B, int j, int i) {
    return !BLK || (j >= B.own_lo && j < B.own_hi && i >= B.own_clo && i < B.own_chi);
}

// The folded neighbours (E, W, N, S) of the interior cell (j, i) at
// index k (jacobi_pallas.py:110-135, :1343-1358): a Neumann neighbour
// reads the cell itself and the Dirichlet outlet reads 0 (CAVITY: the
// cell itself too, jacobi_pallas.py:133-134), tested on the global row
// and column, so no boundary cell is read. A neighbour past the array's
// edge (a halo's stale edge) reads the cell itself.
template <bool BLK, bool CAVITY = false>
__device__ __forceinline__ void folded(const Block& B, const float* a, int ny, int nx,
                                       int j, int i, size_t k, float c, float& E,
                                       float& W, float& N, float& S) {
    static_assert(!(BLK && CAVITY), "a block is CHANNEL only");
    if (!BLK) {
        E = (i == nx - 2) ? (CAVITY ? c : 0.0f) : a[k + 1];
        W = (i == 1) ? c : a[k - 1];
        N = (j == ny - 2) ? c : a[k + nx];
        S = (j == 1) ? c : a[k - nx];
        return;
    }
    const int gj = j + B.row_off, gi = i + B.col_off;
    E = (gi == B.gnx - 2) ? 0.0f : (i + 1 < nx) ? a[k + 1] : c;
    W = (gi == 1 || i < 1) ? c : a[k - 1];
    N = (gj == B.gny - 2 || j + 1 >= ny) ? c : a[k + nx];
    S = (gj == 1 || j < 1) ? c : a[k - nx];
}

struct SweepArgs {
    const float* src;
    const float* rhs;
    float* dst;
    float* partials;  // per-block max |delta| over owned cells, or nullptr
    int ny, nx;
    float ax, ay, ar, ac;  // jacobi_pallas.py:87-94
    Block blk;
};

// One sweep over the interior cells. Boundary reads are folded, so no
// boundary cell of `src` is read and the cells of `dst` that are not
// interior (the global ring, a halo beyond the grid) are left unwritten.
template <bool BLK, bool CAVITY = false>
__global__ void sweep_kernel(SweepArgs A) {
    __shared__ float sh[33];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int ny = A.ny, nx = A.nx;
    float d = 0.0f;
    if (interior<BLK>(A.blk, ny, nx, j, i)) {
        const size_t k = (size_t)j * nx + i;
        const float c = A.src[k];
        float E, W, N, S;
        folded<BLK, CAVITY>(A.blk, A.src, ny, nx, j, i, k, c, E, W, N, S);
        const float nv = A.ax * (E + W) + A.ay * (N + S) + A.ac * c - A.ar * A.rhs[k];
        A.dst[k] = nv;
        if (owned<BLK>(A.blk, j, i)) d = fabsf(nv - c);
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
// run_sweeps is the whole array's.
template <bool BLK, bool CAVITY = false>
inline cudaError_t run_sweeps_as(const float* src, const float* rhs, float* out,
                                 float* tmp, float* partials, int ny, int nx, int k,
                                 float ax, float ay, float ar, float ac,
                                 cudaStream_t st, Block blk) {
    if (k == 0) {
        if (src == out) return cudaSuccess;
        return cudaMemcpyAsync(out, src, sizeof(float) * (size_t)ny * nx,
                               cudaMemcpyDeviceToDevice, st);
    }
    for (int s = 0; s < k; ++s) {
        float* dst = ((k - 1 - s) & 1) ? tmp : out;
        SweepArgs A{src, rhs, dst, (s == k - 1) ? partials : nullptr, ny, nx,
                    ax, ay, ar, ac, blk};
        sweep_kernel<BLK, CAVITY><<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(A);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        src = dst;
    }
    return cudaSuccess;
}

template <bool CAVITY = false>
inline cudaError_t run_sweeps(const float* src, const float* rhs, float* out,
                              float* tmp, float* partials, int ny, int nx, int k,
                              float ax, float ay, float ar, float ac,
                              cudaStream_t st) {
    return run_sweeps_as<false, CAVITY>(src, rhs, out, tmp, partials, ny, nx, k, ax, ay,
                                        ar, ac, st, whole(ny, nx));
}

// The boundary cell b of 2 * nx + 2 * (ny - 2) (2 rows of nx, then 2
// columns of ny-2) as (j, i), and the interior cell (jj, ii) whose value
// the p' BCs copy into it (ops/poisson.py _apply_pprime_bcs, rows then
// columns: a corner takes the diagonal interior cell); false for a cell
// that is 0: the outlet column (CHANNEL, Dirichlet), or the gauge cell
// (0, 0) with the right column copying column nx-2 (CAVITY,
// _apply_pprime_bcs_cavity: the pin comes last, and (0, 0) is no other
// cell's source, so a parallel pass writes it in any order).
template <bool CAVITY = false>
__device__ __forceinline__ bool ring_cell(int b, int ny, int nx, int& j, int& i,
                                          int& jj, int& ii) {
    if (b < 2 * nx) { j = (b < nx) ? 0 : ny - 1; i = b % nx; }
    else { const int c = b - 2 * nx; j = 1 + c % (ny - 2); i = (c < ny - 2) ? 0 : nx - 1; }
    if constexpr (CAVITY) {
        ii = (i == 0) ? 1 : (i == nx - 1) ? nx - 2 : i;  // left, then right
        jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;  // rows first
        return i != 0 || j != 0;
    } else {
        ii = (i == 0) ? 1 : i;                             // left copies column 1
        jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;    // rows first
        return i != nx - 1;
    }
}

// The p' BCs once (ops/poisson.py _apply_pprime_bcs, rows then columns:
// a corner takes the diagonal interior cell, the outlet column is 0; or
// with CAVITY _apply_pprime_bcs_cavity) on the global boundary cells that
// lie in the (ny, nx) block B, written from interior values only, then
// the max over each of one or two arrays of block maxima (pb may be
// null). On the whole array (BLK false) the cells are ring_cell's. In a
// block (CHANNEL only), a cell beyond the grid, or whose interior source
// lies past the block's edge, is left as it is (a halo the caller
// discards). One block.
template <bool BLK, bool CAVITY = false>
__global__ void bc_max_kernel(float* pp, int ny, int nx, const float* pa,
                              int na, float* oa, const float* pb, int nb,
                              float* ob, Block B) {
    static_assert(!(BLK && CAVITY), "a block is CHANNEL only");
    __shared__ float sh[33];
    const int tid = threadIdx.x;
    for (int b = tid; !BLK && b < 2 * nx + 2 * (ny - 2); b += blockDim.x) {
        int j, i, jj, ii;
        const bool copy = ring_cell<CAVITY>(b, ny, nx, j, i, jj, ii);
        pp[(size_t)j * nx + i] = copy ? pp[(size_t)jj * nx + ii] : 0.0f;
    }
    for (int b = tid; BLK && b < 2 * nx + 2 * ny; b += blockDim.x) {
        int j, i;
        if (b < 2 * nx) {  // the bottom and top rows, every column
            j = ((b < nx) ? 0 : B.gny - 1) - B.row_off;
            i = b % nx;
        } else {           // the left and right columns, interior rows
            const int c = b - 2 * nx;
            j = c % ny;
            i = ((c < ny) ? 0 : B.gnx - 1) - B.col_off;
            const int gj = j + B.row_off;
            if (gj < 1 || gj > B.gny - 2) continue;
        }
        if (j < 0 || j >= ny || i < 0 || i >= nx) continue;
        const int gj = j + B.row_off, gi = i + B.col_off;
        if (gi < 0 || gi >= B.gnx) continue;
        float val = 0.0f;  // the outlet (Dirichlet)
        if (gi != B.gnx - 1) {
            const int jj = j + (gj == 0) - (gj == B.gny - 1);  // rows first
            const int ii = i + (gi == 0);                      // left copies column 1
            if (jj < 0 || jj >= ny || ii >= nx) continue;
            val = pp[(size_t)jj * nx + ii];
        }
        pp[(size_t)j * nx + i] = val;
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
