// k damped-Jacobi sweeps on p' with folded boundary reads, CHANNEL flow.
// Replaces cfd_demo_tpu/kernels/jacobi_pallas.py jacobi_fused_k (_kernel).
// See kernels/jacobi.py for the design note.
#include "common.cuh"

namespace {

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

// The p' BCs once per launch (ops/poisson.py _apply_pprime_bcs, rows then
// columns), written from interior values only, plus the max over the
// last sweep's block maxima. One block.
__global__ void bc_err_kernel(float* pp, const float* partials, int nparts,
                              float* err, int ny, int nx) {
    __shared__ float sh[33];
    const int tid = threadIdx.x;
    // boundary cells: 2 rows of nx, then 2 columns of ny-2
    const int nb = 2 * nx + 2 * (ny - 2);
    for (int b = tid; b < nb; b += blockDim.x) {
        int j, i;
        if (b < 2 * nx) { j = (b < nx) ? 0 : ny - 1; i = b % nx; }
        else { const int c = b - 2 * nx; j = 1 + c % (ny - 2); i = (c < ny - 2) ? 0 : nx - 1; }
        float val;
        if (i == nx - 1) {
            val = 0.0f;                               // outlet (Dirichlet)
        } else {
            const int ii = (i == 0) ? 1 : i;          // left copies column 1
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;  // rows first
            val = pp[(size_t)jj * nx + ii];
        }
        pp[(size_t)j * nx + i] = val;
    }
    float m = 0.0f;
    for (int b = tid; b < nparts; b += blockDim.x) m = pmax(m, partials[b]);
    m = block_max(m, sh);
    if (tid == 0) *err = m;
}

}  // namespace

// k sweeps from pp_in into `out` (pp_in is not written), ping-ponging
// through `tmp`; the last sweep writes per-block maxima to `partials`
// (size: the sweep grid's block count, see cfd_jacobi_partials), then one
// block applies the p' BCs and reduces them into err[0].
extern "C" int cfd_jacobi_partials(int ny, int nx) {
    return ((nx + 31) / 32) * ((ny + 7) / 8);
}

extern "C" int cfd_jacobi_fused_k(const float* pp_in, const float* rhs, float* out,
                                  float* tmp, float* partials, float* err,
                                  int ny, int nx, int k, float ax, float ay,
                                  float ar, float ac, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    dim3 block(32, 8);
    dim3 grid((nx + 31) / 32, (ny + 7) / 8);
    const float* src = pp_in;
    for (int s = 0; s < k; ++s) {
        float* dst = ((k - 1 - s) & 1) ? tmp : out;  // the last sweep lands in out
        SweepArgs A{src, rhs, dst, (s == k - 1) ? partials : nullptr, ny, nx,
                    ax, ay, ar, ac};
        sweep_kernel<<<grid, block, 0, st>>>(A);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        src = dst;
    }
    bc_err_kernel<<<1, 1024, 0, st>>>(out, partials, grid.x * grid.y, err, ny, nx);
    return (int)cudaGetLastError();
}
