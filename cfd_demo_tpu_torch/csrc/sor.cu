// Red/black SOR on p', CHANNEL flow, in two layouts: the full (ny, nx) array
// (replaces cfd_demo_tpu/kernels/sor_pallas.py sor_fused_k, body _kernel) and
// the colour-split half-width arrays (sor_fused_k_rb2, body _kernel_rb2).
// See kernels/sor.py for the design note; bc_max_kernel is in sweep.cuh.
#include "sweep.cuh"

namespace {

// The Pallas kernels' multipliers (sor_pallas.py:75-79): bx = 1/(dx^2 denom),
// by = 1/(dy^2 denom), br = 1/denom, om = omega and omc = 1 - om in f32.
struct SorCoef {
    float bx, by, br, om, omc;
};

// One interior cell's over-relaxed update from its own value C and its
// (folded) neighbours, in the Pallas kernels' order of operations:
// (1 - om) C + om (bx (E + W) + by (N + S) - br rhs).
__device__ __forceinline__ float sor_cell(const SorCoef& c, float C, float E, float W,
                                          float N, float S, float r) {
    const float upd = c.bx * (E + W) + c.by * (N + S) - c.br * r;
    return c.omc * C + c.om * upd;
}

// One colour half in place on the full array, or on a block of it at
// global offsets (sweep.cuh Block). The threads of row j take its cells
// of that colour by the parity of the global row and column, i = 2t +
// ((gj + col_off + colour) & 1) (red: colour 0, (gj + gi) even,
// sor_pallas.py:483-494), so a shard colours its cells as the whole grid
// does. A cell reads only the other colour and itself, so the half is
// race-free. Boundary reads are folded (sor_pallas.py:84-97): a Neumann
// neighbour reads the cell itself and the outlet reads 0, so no boundary
// cell is read or written. With `partials`, each block writes the max
// |change| of its owned cells.
template <bool BLK>
__global__ void sor_half_kernel(float* pp, const float* rhs, float* partials, int ny,
                                int nx, int colour, SorCoef cf, Block B) {
    __shared__ float sh[33];
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = 2 * t + ((BLK ? j + B.row_off + B.col_off + colour : j + colour) & 1);
    float d = 0.0f;
    if (interior<BLK>(B, ny, nx, j, i)) {
        const size_t k = (size_t)j * nx + i;
        const float C = pp[k];
        float E, W, N, S;
        folded<BLK>(B, pp, ny, nx, j, i, k, C, E, W, N, S);
        const float nv = sor_cell(cf, C, E, W, N, S, rhs[k]);
        pp[k] = nv;
        if (owned<BLK>(B, j, i)) d = fabsf(nv - C);
    }
    if (partials != nullptr) {
        d = block_max(d, sh);
        if (threadIdx.x == 0 && threadIdx.y == 0)
            partials[blockIdx.y * gridDim.x + blockIdx.x] = d;
    }
}

// One colour half on the colour-split arrays (ny, nxc), nxc = nx / 2:
// `own` holds the colour updated, `oth` the other. Cell (j, t) of colour c
// is global (j, i), i = 2t + ((j + c) & 1), and a global (j, i) lies at
// half-index i >> 1 of its colour: east and west read oth[j, (i+1) >> 1]
// and oth[j, (i-1) >> 1], north and south oth[j+-1, t]. The folds test the
// global column and row.
__global__ void sor_half_rb2_kernel(float* own, const float* oth, const float* rhs_own,
                                    float* partials, int ny, int nx, int colour,
                                    SorCoef cf) {
    __shared__ float sh[33];
    const int nxc = nx >> 1;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = 2 * t + ((j + colour) & 1);
    float d = 0.0f;
    if (j >= 1 && j <= ny - 2 && i >= 1 && i <= nx - 2) {
        const size_t row = (size_t)j * nxc;
        const float C = own[row + t];
        const float E = (i == nx - 2) ? 0.0f : oth[row + ((i + 1) >> 1)];
        const float W = (i == 1) ? C : oth[row + ((i - 1) >> 1)];
        const float N = (j == ny - 2) ? C : oth[row + nxc + t];
        const float S = (j == 1) ? C : oth[row - nxc + t];
        const float nv = sor_cell(cf, C, E, W, N, S, rhs_own[row + t]);
        own[row + t] = nv;
        d = fabsf(nv - C);
    }
    if (partials != nullptr) {
        d = block_max(d, sh);
        if (threadIdx.x == 0 && threadIdx.y == 0)
            partials[blockIdx.y * gridDim.x + blockIdx.x] = d;
    }
}

// bc_max_kernel on the colour-split arrays: the p' BCs once, rows then
// columns, written from interior values only (global (j, i) is
// ((i + j) & 1 ? pb : pr)[j, i >> 1]), then the max of `na` block maxima
// into *err. One block.
__global__ void bc_max_rb2_kernel(float* pr, float* pb, int ny, int nx, const float* pa,
                                  int na, float* err) {
    __shared__ float sh[33];
    const int nxc = nx >> 1;
    auto at = [=](int j, int i) -> float* {
        return (((i + j) & 1) ? pb : pr) + (size_t)j * nxc + (i >> 1);
    };
    const int nbc = 2 * nx + 2 * (ny - 2);
    for (int b = threadIdx.x; b < nbc; b += blockDim.x) {
        int j, i;
        if (b < 2 * nx) { j = (b < nx) ? 0 : ny - 1; i = b % nx; }
        else { const int c = b - 2 * nx; j = 1 + c % (ny - 2); i = (c < ny - 2) ? 0 : nx - 1; }
        float val = 0.0f;                             // outlet (Dirichlet)
        if (i != nx - 1) {
            const int ii = (i == 0) ? 1 : i;          // left copies column 1
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;  // rows first
            val = *at(jj, ii);
        }
        *at(j, i) = val;
    }
    float m = 0.0f;
    for (int b = threadIdx.x; b < na; b += blockDim.x) m = pmax(m, pa[b]);
    m = block_max(m, sh);
    if (threadIdx.x == 0) *err = m;
}

}  // namespace

// Block maxima the last iteration writes: both halves' blocks.
extern "C" int cfd_sor_partials(int ny, int nx) { return 2 * nparts(ny, (nx + 1) / 2); }

namespace {

// k red/black iterations in place on `pp` (BC-consistent on entry), two
// launches each; the last iteration writes its block maxima to `partials`
// (cfd_sor_partials floats), then one block applies the p' BCs and
// reduces them into err[0].
template <bool BLK>
int sor_k(float* pp, const float* rhs, float* partials, float* err, int ny, int nx,
          int k, SorCoef cf, cudaStream_t st, Block blk) {
    if (k < 1 || ny < 3 || nx < 3) return (int)cudaErrorInvalidValue;
    const int np = nparts(ny, (nx + 1) / 2);
    for (int it = 0; it < k; ++it) {
        for (int colour = 0; colour < 2; ++colour) {
            float* part = (it == k - 1) ? partials + colour * np : nullptr;
            sor_half_kernel<BLK><<<grid_for(ny, (nx + 1) / 2), dim3(kBX, kBY), 0, st>>>(
                pp, rhs, part, ny, nx, colour, cf, blk);
            cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
    }
    bc_max_kernel<BLK><<<1, 1024, 0, st>>>(pp, ny, nx, partials, 2 * np, err, nullptr, 0,
                                      nullptr, blk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_sor_fused_k(float* pp, const float* rhs, float* partials, float* err,
                               int ny, int nx, int k, float bx, float by, float br,
                               float om, float omc, void* stream) {
    return sor_k<false>(pp, rhs, partials, err, ny, nx, k, SorCoef{bx, by, br, om, omc},
                        (cudaStream_t)stream, whole(ny, nx));
}

// Kernel 14 (sor_pallas.py sor_fused_k_shard, _kernel_shard): the same k
// iterations on an (ny, nx) halo-extended block (a 2k-row halo: two rings
// an iteration) whose local (0, 0) is global (row_off, col_off) of a
// (gny, gnx) grid; err counts the owned rows [own_lo, own_hi) and
// columns [own_clo, own_chi), and the caller keeps the owned rows.
extern "C" int cfd_sor_fused_k_shard(float* pp, const float* rhs, float* partials,
                                     float* err, int ny, int nx, int k, int row_off,
                                     int col_off, int gny, int gnx, int own_lo,
                                     int own_hi, int own_clo, int own_chi, float bx,
                                     float by, float br, float om, float omc,
                                     void* stream) {
    return sor_k<true>(pp, rhs, partials, err, ny, nx, k, SorCoef{bx, by, br, om, omc},
                       (cudaStream_t)stream,
                       Block{row_off, col_off, gny, gnx, own_lo, own_hi, own_clo, own_chi});
}

extern "C" int cfd_sor_rb2_partials(int ny, int nx) { return 2 * nparts(ny, nx / 2); }

// The same k iterations on the colour-split arrays, in place on pr (red)
// and pb (black), with rr and rb the split rhs; nx even.
extern "C" int cfd_sor_fused_k_rb2(float* pr, float* pb, const float* rr, const float* rb,
                                   float* partials, float* err, int ny, int nx, int k,
                                   float bx, float by, float br, float om, float omc,
                                   void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (k < 1 || ny < 3 || nx < 4 || (nx & 1)) return (int)cudaErrorInvalidValue;
    const SorCoef cf{bx, by, br, om, omc};
    const int nxc = nx / 2, np = nparts(ny, nxc);
    for (int it = 0; it < k; ++it) {
        for (int colour = 0; colour < 2; ++colour) {
            float* part = (it == k - 1) ? partials + colour * np : nullptr;
            sor_half_rb2_kernel<<<grid_for(ny, nxc), dim3(kBX, kBY), 0, st>>>(
                colour ? pb : pr, colour ? pr : pb, colour ? rb : rr, part, ny, nx,
                colour, cf);
            cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
    }
    bc_max_rb2_kernel<<<1, 1024, 0, st>>>(pr, pb, ny, nx, partials, 2 * np, err);
    return (int)cudaGetLastError();
}
