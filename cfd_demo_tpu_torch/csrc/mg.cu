// The vertex multigrid kernels: the JS kit's V-cycle (PressureSolver.MULTIGRID)
// and the legacy MG_PRODUCTION smoother, on compact levels of any size >= 3x3.
// Replace cfd_demo_tpu/kernels/jacobi_pallas.py mg_smooth_pallas (_kernel_mg)
// and cfd_demo_tpu/kernels/mg_pallas.py mg_smooth_int (_kernel_smooth),
// mg_residual_restrict_int (_kernel_restrict), mg_prolong_add_int
// (_kernel_prolong) and mgp_smooth_int (_kernel_smooth_mgp). See
// kernels/mg.py for the design note. The p' BCs of the damped smoother and
// of the prolongation's sum take CHANNEL or CAVITY flow (a template flag,
// mg_pallas.py:998-1023; the CHANNEL instances are the code they were
// before the flag).
#include "sweep.cuh"

namespace {

// A block's shared memory on the H100 (227 KB): a level whose p', its
// second buffer and the scaled rhs fit (12 bytes a cell) runs all its
// sweeps in one block.
constexpr int kSmemBytes = 232448;
constexpr int kBlockCells = kSmemBytes / 12;
constexpr int kBlockThreads = 1024;

inline bool fits_block(int ny, int nx) { return (long long)ny * nx <= kBlockCells; }

// ---------------------------------------------------------------------------
// Undamped interior sweeps, no BCs (mg_pallas.py:106-112): the update
// bx (E + W) + by (N + S) - br rhs with the TPU kernels' multipliers
// (mg_pallas.py:100-104); boundary cells keep their values and are read.
// ---------------------------------------------------------------------------

struct VertexArgs {
    const float* src;
    const float* rhs;
    float* dst;
    int ny, nx;
    float bx, by, br;
};

// One sweep over the whole array: interior cells updated, the ring copied.
__global__ void vertex_sweep_kernel(VertexArgs A) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= A.nx || j >= A.ny) return;
    const size_t k = (size_t)j * A.nx + i;
    float v = A.src[k];
    if (i >= 1 && i <= A.nx - 2 && j >= 1 && j <= A.ny - 2)
        v = A.bx * (A.src[k + 1] + A.src[k - 1]) + A.by * (A.src[k + A.nx] + A.src[k - A.nx])
            - A.br * A.rhs[k];
    A.dst[k] = v;
}

// k sweeps of a level that fits one block: p' in two shared buffers (the
// ring in both, never written), br*rhs in a third; a barrier between
// sweeps, so that every neighbour is read before any cell is written.
__global__ void __launch_bounds__(kBlockThreads)
vertex_smooth_block_kernel(const float* p, const float* rhs, float* out, int ny,
                           int nx, int k, float bx, float by, float br) {
    extern __shared__ float sm[];
    const int n = ny * nx;
    float* a = sm;
    float* b = sm + n;
    float* r = sm + 2 * n;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const float v = p[t];
        a[t] = v;
        b[t] = v;
        r[t] = br * rhs[t];
    }
    __syncthreads();
    for (int s = 0; s < k; ++s) {
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int j = t / nx, i = t - j * nx;
            if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2)
                b[t] = bx * (a[t + 1] + a[t - 1]) + by * (a[t + nx] + a[t - nx]) - r[t];
        }
        __syncthreads();
        float* c = a;
        a = b;
        b = c;
    }
    for (int t = threadIdx.x; t < n; t += blockDim.x) out[t] = a[t];
}

// ---------------------------------------------------------------------------
// Damped sweeps with the p' BCs (mg_pallas.py:890-918): the folded sweep of
// sweep.cuh, then one BC refresh, rows then columns; CAVITY folds the east
// edge and takes the cavity's ring (the right column from column nx-2, the
// gauge cell (0, 0) pinned to 0).
// ---------------------------------------------------------------------------

// The p' BCs on an array whose interior is final (sweep.cuh ring_cell).
template <bool CAVITY>
__global__ void pprime_ring_kernel(float* pp, int ny, int nx) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= 2 * nx + 2 * (ny - 2)) return;
    int j, i, jj, ii;
    const bool copy = ring_cell<CAVITY>(b, ny, nx, j, i, jj, ii);
    pp[(size_t)j * nx + i] = copy ? pp[(size_t)jj * nx + ii] : 0.0f;
}

template <bool CAVITY>
__global__ void __launch_bounds__(kBlockThreads)
mgp_smooth_block_kernel(const float* p, const float* rhs, float* out, int ny, int nx,
                        int k, float ax, float ay, float ar, float ac) {
    extern __shared__ float sm[];
    const int n = ny * nx;
    float* a = sm;
    float* b = sm + n;
    float* r = sm + 2 * n;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        a[t] = p[t];
        r[t] = ar * rhs[t];
    }
    __syncthreads();
    for (int s = 0; s < k; ++s) {
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int j = t / nx, i = t - j * nx;
            if (i < 1 || i > nx - 2 || j < 1 || j > ny - 2) continue;
            const float c = a[t];
            const float E = (i == nx - 2) ? (CAVITY ? c : 0.0f) : a[t + 1];
            const float W = (i == 1) ? c : a[t - 1];
            const float N = (j == ny - 2) ? c : a[t + nx];
            const float S = (j == 1) ? c : a[t - nx];
            b[t] = ax * (E + W) + ay * (N + S) + ac * c - r[t];
        }
        __syncthreads();
        float* c = a;
        a = b;
        b = c;
    }
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int j = t / nx, i = t - j * nx;
        if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) out[t] = a[t];
    }
    const int nbc = 2 * nx + 2 * (ny - 2);
    for (int q = threadIdx.x; q < nbc; q += blockDim.x) {
        int j, i, jj, ii;
        const bool copy = ring_cell<CAVITY>(q, ny, nx, j, i, jj, ii);
        out[j * nx + i] = copy ? a[jj * nx + ii] : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// Transfers.
// ---------------------------------------------------------------------------

// r = rhs - A p at an interior fine cell (j, i), unfolded reads, in the
// TPU kernel's form: idx2 (E + W) + idy2 (N + S) - denom c
// (mg_pallas.py:386-398).
__device__ __forceinline__ float vertex_residual(const float* p, const float* rhs, int j,
                                                 int i, int nx, float bx, float by,
                                                 float denom) {
    const size_t k = (size_t)j * nx + i;
    return rhs[k] - (bx * (p[k + 1] + p[k - 1]) + by * (p[k + nx] + p[k - nx])
                     - denom * p[k]);
}

// One thread per coarse cell (t, s): the 9-point full weighting of the
// residual around fine (2t, 2s), separably as mg_pallas.py:404-410 takes
// it (x: 1/2 centre + 1/4 (E + W); then y: 1/2 centre + 1/4 (N + S)), on
// the coarse interior; the ring is 0, as the fine residual's boundary is
// (mg_pallas.py:33-38). Every fine cell read is interior.
__global__ void vertex_restriction_kernel(const float* p, const float* rhs, float* rc,
                                          int nx, int nyc, int nxc, float bx, float by,
                                          float denom) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    const int t = blockIdx.y * blockDim.y + threadIdx.y;
    if (s >= nxc || t >= nyc) return;
    float out = 0.0f;
    if (s >= 1 && s <= nxc - 2 && t >= 1 && t <= nyc - 2) {
        const int j = 2 * t, i = 2 * s;
        float rx[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const int jj = j + d - 1;
            const float w = vertex_residual(p, rhs, jj, i - 1, nx, bx, by, denom);
            const float c = vertex_residual(p, rhs, jj, i, nx, bx, by, denom);
            const float e = vertex_residual(p, rhs, jj, i + 1, nx, bx, by, denom);
            rx[d] = 0.5f * c + 0.25f * (e + w);
        }
        out = 0.5f * rx[1] + 0.25f * (rx[2] + rx[0]);
    }
    rc[(size_t)t * nxc + s] = out;
}

// The bilinear prolongation of e at fine (j, i), in the plain version's
// form (ops/poisson.py _mg_prolong): e0 (1 - a) + e1 a along x at the
// two coarse rows, then the same along y; the last coarse column and
// row clamp.
__device__ __forceinline__ float prolong_at(const float* e, int j, int i, int nyc,
                                            int nxc) {
    const int i0 = i >> 1, i1 = min(i0 + 1, nxc - 1);
    const int j0 = j >> 1, j1 = min(j0 + 1, nyc - 1);
    const float a = (i & 1) ? 0.5f : 0.0f;
    const float b = (j & 1) ? 0.5f : 0.0f;
    const float r0 = e[(size_t)j0 * nxc + i0] * (1.0f - a) + e[(size_t)j0 * nxc + i1] * a;
    const float r1 = e[(size_t)j1 * nxc + i0] * (1.0f - a) + e[(size_t)j1 * nxc + i1] * a;
    return r0 * (1.0f - b) + r1 * b;
}

// out = p + prolong(e) over the whole fine array; with bc, the p' BCs of
// that sum (ops/poisson.py:663): a ring cell takes the sum at the cell the
// BCs copy from (sweep.cuh ring_cell), a cell they zero 0 (the outlet
// column; CAVITY: the gauge cell (0, 0)).
template <bool CAVITY>
__global__ void vertex_prolong_add_kernel(const float* e, const float* p, float* out,
                                          int ny, int nx, int nyc, int nxc, int bc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= nx || j >= ny) return;
    const size_t k = (size_t)j * nx + i;
    int jj = j, ii = i;
    if (bc) {
        if (CAVITY ? (i == 0 && j == 0) : (i == nx - 1)) {
            out[k] = 0.0f;
            return;
        }
        ii = (i == 0) ? 1 : (CAVITY && i == nx - 1) ? nx - 2 : i;
        jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
    }
    out[k] = p[(size_t)jj * nx + ii] + prolong_at(e, jj, ii, nyc, nxc);
}

inline cudaError_t copy_level(float* out, const float* src, int ny, int nx, cudaStream_t st) {
    return cudaMemcpyAsync(out, src, sizeof(float) * (size_t)ny * nx,
                           cudaMemcpyDeviceToDevice, st);
}

inline cudaError_t allow_block_smem(const void* kernel) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
}

}  // namespace

// k undamped interior sweeps from p into out (p is not written); tmp is a
// second buffer of the same size for the levels that do not fit a block.
extern "C" int cfd_mg_smooth(const float* p, const float* rhs, float* out, float* tmp,
                             int ny, int nx, int k, float bx, float by, float br,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (ny < 3 || nx < 3 || k < 0) return (int)cudaErrorInvalidValue;
    if (k == 0) return (int)copy_level(out, p, ny, nx, st);
    cudaError_t e;
    if (fits_block(ny, nx)) {
        e = allow_block_smem((const void*)vertex_smooth_block_kernel);
        if (e != cudaSuccess) return (int)e;
        vertex_smooth_block_kernel<<<1, kBlockThreads, 12 * ny * nx, st>>>(
            p, rhs, out, ny, nx, k, bx, by, br);
        return (int)cudaGetLastError();
    }
    VertexArgs A{p, rhs, nullptr, ny, nx, bx, by, br};
    for (int s = 0; s < k; ++s) {
        A.dst = ((k - 1 - s) & 1) ? tmp : out;  // the last sweep lands in out
        vertex_sweep_kernel<<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(A);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        A.src = A.dst;
    }
    return (int)cudaSuccess;
}

// The coarse residual rc ((ny+1)/2, (nx+1)/2) of p: restricted rhs - A p.
extern "C" int cfd_mg_restrict(const float* p, const float* rhs, float* rc, int ny,
                               int nx, float bx, float by, float denom, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (ny < 3 || nx < 3) return (int)cudaErrorInvalidValue;
    const int nyc = (ny + 1) / 2, nxc = (nx + 1) / 2;
    vertex_restriction_kernel<<<grid_for(nyc, nxc), dim3(kBX, kBY), 0, st>>>(
        p, rhs, rc, nx, nyc, nxc, bx, by, denom);
    return (int)cudaGetLastError();
}

// out = p + prolong(e), e of ((ny+1)/2, (nx+1)/2); bc: 0 none, 1 the
// CHANNEL p' BCs of the sum, 2 the CAVITY ones.
extern "C" int cfd_mg_prolong_add(const float* e, const float* p, float* out, int ny,
                                  int nx, int bc, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (ny < 3 || nx < 3 || bc < 0 || bc > 2) return (int)cudaErrorInvalidValue;
    const auto kern = (bc == 2) ? vertex_prolong_add_kernel<true>
                                : vertex_prolong_add_kernel<false>;
    kern<<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(e, p, out, ny, nx, (ny + 1) / 2,
                                                      (nx + 1) / 2, bc);
    return (int)cudaGetLastError();
}

template <bool CAVITY>
cudaError_t mgp_smooth(const float* p, const float* rhs, float* out, float* tmp, int ny,
                       int nx, int k, float ax, float ay, float ar, float ac,
                       cudaStream_t st) {
    cudaError_t e;
    if (fits_block(ny, nx)) {
        e = allow_block_smem((const void*)mgp_smooth_block_kernel<CAVITY>);
        if (e != cudaSuccess) return e;
        mgp_smooth_block_kernel<CAVITY><<<1, kBlockThreads, 12 * ny * nx, st>>>(
            p, rhs, out, ny, nx, k, ax, ay, ar, ac);
        return cudaGetLastError();
    }
    e = run_sweeps<CAVITY>(p, rhs, out, tmp, nullptr, ny, nx, k, ax, ay, ar, ac, st);
    if (e != cudaSuccess) return e;
    const int nbc = 2 * nx + 2 * (ny - 2);
    pprime_ring_kernel<CAVITY><<<(nbc + 255) / 256, 256, 0, st>>>(out, ny, nx);
    return cudaGetLastError();
}

// k damped sweeps with the p' BCs from p into out: the folded sweep (no
// ring cell read) and one BC refresh. k == 0 copies p. `cavity` takes the
// CAVITY instance.
extern "C" int cfd_mgp_smooth(const float* p, const float* rhs, float* out, float* tmp,
                              int ny, int nx, int k, float ax, float ay, float ar,
                              float ac, int cavity, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (ny < 3 || nx < 3 || k < 0) return (int)cudaErrorInvalidValue;
    if (k == 0) return (int)copy_level(out, p, ny, nx, st);
    const auto run = cavity ? mgp_smooth<true> : mgp_smooth<false>;
    return (int)run(p, rhs, out, tmp, ny, nx, k, ax, ay, ar, ac, st);
}
