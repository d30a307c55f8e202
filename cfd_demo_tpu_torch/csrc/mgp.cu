// The fused smoothers of the aligned MG_PRODUCTION V-cycle, CHANNEL and
// CAVITY flow. Replace cfd_demo_tpu/kernels/jacobi_pallas.py
// jacobi_fused_k_res, jacobi_fused_k_restrict (_kernel_res),
// jacobi_fused_k_corr (_kernel_corr) and cc_sweeps_pallas (_kernel_cc).
// See kernels/mgp.py for the design note.
//
// CAVITY is a template flag (jacobi_pallas.py:133-134, :185-187): the
// fine level's east neighbour of column nx-2 reads the cell itself, and
// the ring copies column nx-2 into column nx-1 and pins (0, 0) to 0
// (sweep.cuh); the cc kernels' EAST_DIRICHLET flag (:1690, :1704) is false
// for the cavity's all-Neumann coarse levels, whose east edge mirrors. The
// CHANNEL instances are the code they were before the flags.
#include "sweep.cuh"

namespace {

struct ResArgs {
    const float* p;       // the final iterate; only its interior is read
    const float* rhs;
    float* r;             // full residual with a zero ring, or nullptr
    float* part_r;        // per-block max |r| over the interior
    float* part_p;        // per-block max |p| over the interior, or nullptr
    int ny, nx;
    float bx, by, denom;  // f32(1/dx^2), f32(1/dy^2), f32(2/dx^2 + 2/dy^2)
};

// r = rhs - A p at an interior cell with the folded reads, which equal
// the reads of the BC'd array (_kernel_res, jacobi_pallas.py:313-318).
template <bool CAVITY>
__device__ __forceinline__ float folded_residual(const float* p, const float* rhs,
                                                 int j, int i, int ny, int nx,
                                                 float bx, float by, float denom) {
    const size_t k = (size_t)j * nx + i;
    const float c = p[k];
    const float E = (i == nx - 2) ? (CAVITY ? c : 0.0f) : p[k + 1];
    const float W = (i == 1) ? c : p[k - 1];
    const float N = (j == ny - 2) ? c : p[k + nx];
    const float S = (j == 1) ? c : p[k - nx];
    return rhs[k] - (bx * (E + W) + by * (N + S) - denom * c);
}

// Over the full array: the residual of every interior cell (written when
// r is set, with 0 on the ring), block maxima of |r| and of |p|.
template <bool CAVITY>
__global__ void residual_kernel(ResArgs A) {
    __shared__ float sh[33];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    float mr = 0.0f, mp = 0.0f;
    if (i < A.nx && j < A.ny) {
        float r = 0.0f;
        if (i >= 1 && i <= A.nx - 2 && j >= 1 && j <= A.ny - 2) {
            r = folded_residual<CAVITY>(A.p, A.rhs, j, i, A.ny, A.nx, A.bx, A.by, A.denom);
            mr = fabsf(r);
            mp = fabsf(A.p[(size_t)j * A.nx + i]);
        }
        if (A.r != nullptr) A.r[(size_t)j * A.nx + i] = r;
    }
    mr = block_max(mr, sh);
    if (A.part_p != nullptr) mp = block_max(mp, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        const int b = blockIdx.y * gridDim.x + blockIdx.x;
        A.part_r[b] = mr;
        if (A.part_p != nullptr) A.part_p[b] = mp;
    }
}

// One thread per first-coarse-level cell (t, s): the residuals of its
// four fine children (2t+1..2t+2, 2s+1..2s+2), averaged as _cc_restrict
// does (x pairs, then the y pair), and block maxima of their |r|. Even
// ny and nx: the children tile the interior exactly.
template <bool CAVITY>
__global__ void restrict_kernel(const float* p, const float* rhs, float* rc,
                                float* part_r, int ny, int nx, float bx,
                                float by, float denom) {
    __shared__ float sh[33];
    const int ncy = (ny - 2) / 2, ncx = (nx - 2) / 2;
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    const int t = blockIdx.y * blockDim.y + threadIdx.y;
    float m = 0.0f;
    if (s < ncx && t < ncy) {
        const int j = 2 * t + 1, i = 2 * s + 1;
        const float r00 = folded_residual<CAVITY>(p, rhs, j, i, ny, nx, bx, by, denom);
        const float r01 = folded_residual<CAVITY>(p, rhs, j, i + 1, ny, nx, bx, by, denom);
        const float r10 = folded_residual<CAVITY>(p, rhs, j + 1, i, ny, nx, bx, by, denom);
        const float r11 = folded_residual<CAVITY>(p, rhs, j + 1, i + 1, ny, nx, bx, by,
                                                  denom);
        rc[(size_t)t * ncx + s] = 0.5f * (0.5f * (r00 + r01) + 0.5f * (r10 + r11));
        m = pmax(pmax(fabsf(r00), fabsf(r01)), pmax(fabsf(r10), fabsf(r11)));
    }
    m = block_max(m, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
        part_r[blockIdx.y * gridDim.x + blockIdx.x] = m;
}

// out = p + the y pass of the last prolongation on the interior: fine
// interior row J = 2T reads row[T] and row[T-1], J = 2T+1 row[T] and
// row[T+1], each clamped (_cc_prolong's even case, jacobi_pallas.py:
// 589-596). `row` is the x-prolonged correction, ((ny-2)/2, nx-2). The
// ring of out is not written: the folded sweeps never read it.
__global__ void corr_add_kernel(const float* p, const float* row, float* out,
                                int ny, int nx) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i < 1 || i > nx - 2 || j < 1 || j > ny - 2) return;
    const int ncy = (ny - 2) / 2, w = nx - 2;
    const int J = j - 1, I = i - 1, T = J >> 1;
    const int Tn = (J & 1) ? min(T + 1, ncy - 1) : max(T - 1, 0);
    const float e = 0.75f * row[(size_t)T * w + I] + 0.25f * row[(size_t)Tn * w + I];
    const size_t k = (size_t)j * nx + i;
    out[k] = p[k] + e;
}

struct CcArgs {
    const float* src;
    const float* rhs;
    float* dst;
    int ny, nx;
    float bx, by, om, omc;       // f32(1/dx^2), f32(1/dy^2), f32(omega), 1 - f32(omega)
    float inv_dg, inv_dg_last;   // 1/diag elsewhere and in the outlet column
    float dg, dg_last;           // the diagonal itself, for the residual
};

// Folded reads on an interior-unknown array (_kernel_cc): Neumann edges
// read the cell itself, the outlet (east) edge a 0 ghost, or without an
// outlet (EAST_DIRICHLET false: the cavity) the cell itself too.
template <bool EAST_DIRICHLET>
__device__ __forceinline__ void cc_neighbours(const CcArgs& A, int j, int i,
                                              float c, float& ew, float& ns) {
    const size_t k = (size_t)j * A.nx + i;
    const float E = (i == A.nx - 1) ? (EAST_DIRICHLET ? 0.0f : c) : A.src[k + 1];
    const float W = (i == 0) ? c : A.src[k - 1];
    const float N = (j == A.ny - 1) ? c : A.src[k + A.nx];
    const float S = (j == 0) ? c : A.src[k - A.nx];
    ew = E + W;
    ns = N + S;
}

template <bool EAST_DIRICHLET>
__global__ void cc_sweep_kernel(CcArgs A) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= A.nx || j >= A.ny) return;
    const size_t k = (size_t)j * A.nx + i;
    const float c = A.src[k];
    float ew, ns;
    cc_neighbours<EAST_DIRICHLET>(A, j, i, c, ew, ns);
    const float inv = (i == A.nx - 1) ? A.inv_dg_last : A.inv_dg;
    const float upd = (A.bx * ew + A.by * ns - A.rhs[k]) * inv;
    A.dst[k] = A.omc * c + A.om * upd;
}

// The residual of the folded cell-centred operator (src: the iterate).
template <bool EAST_DIRICHLET>
__global__ void cc_residual_kernel(CcArgs A) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= A.nx || j >= A.ny) return;
    const size_t k = (size_t)j * A.nx + i;
    const float c = A.src[k];
    float ew, ns;
    cc_neighbours<EAST_DIRICHLET>(A, j, i, c, ew, ns);
    const float dg = (i == A.nx - 1) ? A.dg_last : A.dg;
    A.dst[k] = A.rhs[k] - (A.bx * ew + A.by * ns - dg * c);
}

template <bool CAVITY>
cudaError_t mgp_res(const float* pp_in, const float* rhs, float* out, float* tmp,
                    float* r_out, float* partials, float* err, int ny, int nx, int k,
                    float ax, float ay, float ar, float ac, float bx, float by, float denom,
                    cudaStream_t st) {
    cudaError_t e = run_sweeps<CAVITY>(pp_in, rhs, out, tmp, nullptr, ny, nx, k,
                                       ax, ay, ar, ac, st);
    if (e != cudaSuccess) return e;
    ResArgs R{out, rhs, r_out, partials, nullptr, ny, nx, bx, by, denom};
    residual_kernel<CAVITY><<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(R);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    bc_max_kernel<false, CAVITY><<<1, 1024, 0, st>>>(out, ny, nx, partials, nparts(ny, nx),
                                                     err, nullptr, 0, nullptr, whole(ny, nx));
    return cudaGetLastError();
}

template <bool CAVITY>
cudaError_t mgp_restrict(const float* pp_in, const float* rhs, float* out, float* tmp,
                         float* rc, float* partials, float* err, int ny, int nx, int k,
                         float ax, float ay, float ar, float ac, float bx, float by,
                         float denom, cudaStream_t st) {
    cudaError_t e = run_sweeps<CAVITY>(pp_in, rhs, out, tmp, nullptr, ny, nx, k,
                                       ax, ay, ar, ac, st);
    if (e != cudaSuccess) return e;
    const int ncy = (ny - 2) / 2, ncx = (nx - 2) / 2;
    restrict_kernel<CAVITY><<<grid_for(ncy, ncx), dim3(kBX, kBY), 0, st>>>(
        out, rhs, rc, partials, ny, nx, bx, by, denom);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    bc_max_kernel<false, CAVITY><<<1, 1024, 0, st>>>(out, ny, nx, partials, nparts(ncy, ncx),
                                                     err, nullptr, 0, nullptr, whole(ny, nx));
    return cudaGetLastError();
}

template <bool CAVITY>
cudaError_t mgp_corr(const float* pp_in, const float* rhs, const float* row, float* out,
                     float* tmp, float* part_r, float* part_p, float* err, float* pmax_out,
                     int ny, int nx, int k, float ax, float ay, float ar, float ac, float bx,
                     float by, float denom, cudaStream_t st) {
    float* added = (k & 1) ? tmp : out;  // the sweeps then end in out
    corr_add_kernel<<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(pp_in, row, added,
                                                                 ny, nx);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = run_sweeps<CAVITY>(added, rhs, out, tmp, nullptr, ny, nx, k, ax, ay, ar, ac, st);
    if (e != cudaSuccess) return e;
    ResArgs R{out, rhs, nullptr, part_r, part_p, ny, nx, bx, by, denom};
    residual_kernel<CAVITY><<<grid_for(ny, nx), dim3(kBX, kBY), 0, st>>>(R);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int n = nparts(ny, nx);
    bc_max_kernel<false, CAVITY><<<1, 1024, 0, st>>>(out, ny, nx, part_r, n, err, part_p, n,
                                                     pmax_out, whole(ny, nx));
    return cudaGetLastError();
}

template <bool EAST_DIRICHLET>
cudaError_t cc_sweeps(CcArgs A, float* out, float* tmp, float* r_out, int k,
                      cudaStream_t st) {
    const dim3 grid = grid_for(A.ny, A.nx), block(kBX, kBY);
    cudaError_t e;
    if (k == 0) {
        e = cudaMemcpyAsync(out, A.src, sizeof(float) * (size_t)A.ny * A.nx,
                            cudaMemcpyDeviceToDevice, st);
        if (e != cudaSuccess) return e;
    }
    for (int s = 0; s < k; ++s) {
        A.dst = ((k - 1 - s) & 1) ? tmp : out;
        cc_sweep_kernel<EAST_DIRICHLET><<<grid, block, 0, st>>>(A);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        A.src = A.dst;
    }
    if (r_out != nullptr) {
        A.src = out;
        A.dst = r_out;
        cc_residual_kernel<EAST_DIRICHLET><<<grid, block, 0, st>>>(A);
    }
    return cudaGetLastError();
}

}  // namespace

// k sweeps (p' BCs folded), then the residual of the final iterate:
// written to r_out unless it is null, max|r| over the interior to err.
// partials: cfd_jacobi_partials(ny, nx) floats. `cavity` takes the
// CAVITY instance.
extern "C" int cfd_mgp_res(const float* pp_in, const float* rhs, float* out,
                           float* tmp, float* r_out, float* partials, float* err,
                           int ny, int nx, int k, float ax, float ay, float ar,
                           float ac, float bx, float by, float denom, int cavity,
                           void* stream) {
    const auto run = cavity ? mgp_res<true> : mgp_res<false>;
    return (int)run(pp_in, rhs, out, tmp, r_out, partials, err, ny, nx, k, ax, ay, ar, ac,
                    bx, by, denom, (cudaStream_t)stream);
}

// k sweeps, then the first coarse level of the residual, rc of shape
// ((ny-2)/2, (nx-2)/2), and max|r| to err. Even ny and nx.
// partials: cfd_jacobi_partials((ny-2)/2, (nx-2)/2) floats.
extern "C" int cfd_mgp_restrict(const float* pp_in, const float* rhs, float* out,
                                float* tmp, float* rc, float* partials, float* err,
                                int ny, int nx, int k, float ax, float ay, float ar,
                                float ac, float bx, float by, float denom, int cavity,
                                void* stream) {
    if ((ny | nx) & 1) return (int)cudaErrorInvalidValue;
    const auto run = cavity ? mgp_restrict<true> : mgp_restrict<false>;
    return (int)run(pp_in, rhs, out, tmp, rc, partials, err, ny, nx, k, ax, ay, ar, ac, bx,
                    by, denom, (cudaStream_t)stream);
}

// The coarse correction's y pass and add, k sweeps, then max|r| to err and
// max|p'| to pmax (over the interior, which after the BCs is the whole
// array's max: every ring value is an interior value or a 0, the outlet's
// or the cavity's gauge cell). Even ny and nx; row: ((ny-2)/2, nx-2).
// part_r, part_p: cfd_jacobi_partials(ny, nx) floats each.
extern "C" int cfd_mgp_corr(const float* pp_in, const float* rhs, const float* row,
                            float* out, float* tmp, float* part_r, float* part_p,
                            float* err, float* pmax_out, int ny, int nx, int k,
                            float ax, float ay, float ar, float ac, float bx,
                            float by, float denom, int cavity, void* stream) {
    if ((ny | nx) & 1) return (int)cudaErrorInvalidValue;
    const auto run = cavity ? mgp_corr<true> : mgp_corr<false>;
    return (int)run(pp_in, rhs, row, out, tmp, part_r, part_p, err, pmax_out, ny, nx, k,
                    ax, ay, ar, ac, bx, by, denom, (cudaStream_t)stream);
}

// k damped sweeps of the folded cell-centred operator from p_in into out
// (ping-ponging through tmp), then, when r_out is not null, the residual.
// east_dirichlet: the outlet's 0 ghost (CHANNEL), else the east edge
// mirrors (CAVITY).
extern "C" int cfd_cc_sweeps(const float* p_in, const float* rhs, float* out,
                             float* tmp, float* r_out, int ny, int nx, int k,
                             float bx, float by, float om, float omc,
                             float inv_dg, float inv_dg_last, float dg,
                             float dg_last, int east_dirichlet, void* stream) {
    CcArgs A{p_in, rhs, nullptr, ny, nx, bx, by, om, omc, inv_dg, inv_dg_last,
             dg, dg_last};
    const auto run = east_dirichlet ? cc_sweeps<true> : cc_sweeps<false>;
    return (int)run(A, out, tmp, r_out, k, (cudaStream_t)stream);
}
