// A whole PISO substep of every scene of a batch in one launch: predictor,
// divergence, a do-while Jacobi or red/black SOR solve with an exact
// per-scene exit, corrector, up to `rounds` outer corrector rounds with an
// exact exit, then the velocity BCs (Rust semantics, FIRST upwind, CHANNEL
// flow, UNIFORM inlet). Replaces cfd_demo_tpu/kernels/ensemble_pallas.py
// substep_batch_pallas (_kernel_sub, with make_jacobi_solve or
// make_sor_solve). See kernels/ensemble.py for the design note.
//
// Two forms of the same function, the same bits and counts.
//
// The cluster form (ensemble_cluster_kernel): one thread-block cluster of C
// CTAs per scene, B clusters a launch, on cluster.cuh's machinery. Each
// CTA runs the predictor (predict.cuh, FIRST, Rust) on its slab's rows,
// then the divergence, the exact-exit solve with the scene's p' in the
// cluster's shared memory (Jacobi: the shared strip sweep; SOR: a red and
// a black half, each ending in the st.async exchange of the slab's edge
// rows and the CTA's max), the corrector, the outer rounds, and the BCs.
// dt_sub, nu and the inlet come from the scene's row of scal; the counts
// are written per scene. kernels/cluster.py picks C so that the card
// holds the whole batch at once where it can.
//
// The block form (ensemble_substep_kernel), kept to compare with and for
// scenes wider than the cluster form takes (nx > 1024): one thread block
// per scene keeps the scene's p' in shared memory: Jacobi in two buffers
// it ping-pongs between sweeps, SOR in place in one (the other stages the
// outlet column for the BCs); u, v, p and the divergence in global memory
// (L2). A scene never reads another scene's data, so __syncthreads() is the
// only barrier it needs; global writes of a block are visible to that
// block after it, so in-kernel data is read with plain loads (never __ldg).
#include "cluster.cuh"
#include "predict.cuh"

namespace {

constexpr int kThreads = 1024;  // the block form's block

struct EnsArgs {
    const float* u_in;   // (B, ny, nx+1)
    const float* v_in;   // (B, ny, nx)
    const float* p_in;   // (B, ny, nx)
    const float* pp_in;  // (B, ny, nx), BC-consistent warm start
    const float* scal;   // (B, 3): dt_sub, nu, inlet
    float* u;            // out (B, ny, nx+1)
    float* v;            // out (B, ny, nx)
    float* p;            // out (B, ny, nx)
    float* pp;           // out (B, ny, nx)
    float* rhs_w;        // scratch (B, ny, nx): the divergence
    float* err_out;      // out (B,)
    int* counts;         // out (B, 2): outer rounds run, Jacobi sweeps run
    int ny, nx;
    float dx, dy, dx2, dy2;
    // Jacobi: (ax, ay, ar, ac) of jacobi_pallas.py:87-94. SOR: (bx, by, br,
    // 1 - omega) of ensemble_pallas.py:174-179, and om = omega.
    float ax, ay, ar, ac, om;
    int sor;  // 1: the red/black SOR solve, 0: Jacobi
    int iters;
    float tol;
    int rounds;
    float outer_tol;
    const uint8_t* mask_u;     // obstacle masks (ny, nx+1), (ny, nx), the same
    const uint8_t* mask_v;     // for every scene; null: no obstacles
    const uint8_t* mask_u_bc;
    const uint8_t* mask_v_bc;
};

// One scene's pointers and its shared p' buffers.
struct Sc {
    float* u;
    float* v;
    float* p;
    float* rhs;
    float* cur;    // shared: p' as the last sweep left it
    float* other;  // shared: the ping-pong buffer
    float* sh;     // shared: 33 floats for block_max
    int sweeps;
};

// ops/divergence.py into s.rhs.
__device__ void divergence(const EnsArgs& A, const Sc& s, float dt) {
    const int ny = A.ny, nx = A.nx;
    for (int k = threadIdx.x; k < ny * nx; k += blockDim.x) {
        const int j = k / nx, i = k % nx;
        const int ku = j * (nx + 1) + i;
        const float du = (s.u[ku + 1] - s.u[ku]) / A.dx;
        const float vN = (j + 1 < ny) ? s.v[k + nx] : 0.0f;
        const float dv = (vN - s.v[k]) / A.dy;
        s.rhs[k] = (du + dv) / dt;
    }
    __syncthreads();
}

// The p' BCs once on s.cur, rows then columns, from interior values only.
__device__ void pprime_bcs(const EnsArgs& A, Sc& s) {
    const int ny = A.ny, nx = A.nx;
    for (int b = threadIdx.x; b < 2 * nx + 2 * (ny - 2); b += blockDim.x) {
        int j, i;
        if (b < 2 * nx) { j = (b < nx) ? 0 : ny - 1; i = b % nx; }
        else { const int q = b - 2 * nx; j = 1 + q % (ny - 2); i = (q < ny - 2) ? 0 : nx - 1; }
        float val = 0.0f;  // outlet (Dirichlet)
        if (i != nx - 1) {
            const int ii = (i == 0) ? 1 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            val = s.cur[jj * nx + ii];
        }
        s.cur[j * nx + i] = val;
    }
    __syncthreads();
}

// ensemble_pallas.make_jacobi_solve: do-while `it == 0 or (it < iters and
// err >= tol)` over the interior with folded boundary reads, then the p'
// BCs once, rows then columns, from interior values only.
__device__ float jacobi_solve(const EnsArgs& A, Sc& s) {
    const int ny = A.ny, nx = A.nx, wi = nx - 2, n_int = (ny - 2) * (nx - 2);
    float err;
    int it = 0;
    do {
        float m = 0.0f;
        for (int q = threadIdx.x; q < n_int; q += blockDim.x) {
            const int j = 1 + q / wi, i = 1 + q % wi;
            const int k = j * nx + i;
            const float C = s.cur[k];
            const float E = (i == nx - 2) ? 0.0f : s.cur[k + 1];
            const float W = (i == 1) ? C : s.cur[k - 1];
            const float N = (j == ny - 2) ? C : s.cur[k + nx];
            const float S = (j == 1) ? C : s.cur[k - nx];
            const float nv = A.ax * (E + W) + A.ay * (N + S) + A.ac * C - A.ar * s.rhs[k];
            s.other[k] = nv;
            m = pmax(m, fabsf(nv - C));
        }
        err = block_max(m, s.sh);  // its barriers also publish `other`
        float* t = s.cur; s.cur = s.other; s.other = t;
        ++it;
    } while (it < A.iters && err >= A.tol);
    s.sweeps += it;
    pprime_bcs(A, s);
    return err;
}

// ensemble_pallas.make_sor_solve: the same do-while, each iteration the red
// half (j + i even) in place, a barrier, then the black half, which reads
// the red half's updates; boundary reads folded as in jacobi_solve. A cell
// of one colour reads only the other colour and itself, so a half is
// race-free in shared memory. Err is the block max of each cell's |change|
// at its own update.
__device__ float sor_solve(const EnsArgs& A, Sc& s) {
    const int ny = A.ny, nx = A.nx;
    const int hw = (nx - 1) / 2, n_slots = (ny - 2) * hw;  // a colour's cells a row, at most
    float err;
    int it = 0;
    do {
        float m = 0.0f;
        for (int colour = 0; colour < 2; ++colour) {
            for (int q = threadIdx.x; q < n_slots; q += blockDim.x) {
                const int j = 1 + q / hw;
                const int i = 1 + ((1 + j + colour) & 1) + 2 * (q % hw);
                if (i > nx - 2) continue;
                const int k = j * nx + i;
                const float C = s.cur[k];
                const float E = (i == nx - 2) ? 0.0f : s.cur[k + 1];
                const float W = (i == 1) ? C : s.cur[k - 1];
                const float N = (j == ny - 2) ? C : s.cur[k + nx];
                const float S = (j == 1) ? C : s.cur[k - nx];
                const float upd = A.ax * (E + W) + A.ay * (N + S) - A.ar * s.rhs[k];
                const float nv = A.ac * C + A.om * upd;
                s.cur[k] = nv;
                m = pmax(m, fabsf(nv - C));
            }
            __syncthreads();
        }
        err = block_max(m, s.sh);
        ++it;
    } while (it < A.iters && err >= A.tol);
    s.sweeps += it;
    pprime_bcs(A, s);
    return err;
}

// ops/corrector.py in place on (u, v); p = p_src + p'. Each thread reads
// and writes only its own faces of u, v and p.
__device__ void correct(const EnsArgs& A, const Sc& s, float dt, const float* p_src) {
    const int ny = A.ny, nx = A.nx;
    const float* pp = s.cur;
    for (int k = threadIdx.x; k < ny * (nx + 1); k += blockDim.x) {
        const int j = k / (nx + 1), i = k % (nx + 1);
        if (i >= 1 && i <= nx - 1)
            s.u[k] = s.u[k] - dt * (pp[j * nx + i] - pp[j * nx + i - 1]) / A.dx;
    }
    for (int k = threadIdx.x; k < ny * nx; k += blockDim.x) {
        if (k >= nx) s.v[k] = s.v[k] - dt * (pp[k] - pp[k - nx]) / A.dy;
        s.p[k] = p_src[k] + pp[k];
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads) ensemble_substep_kernel(EnsArgs A) {
    extern __shared__ float smem[];  // two (ny, nx) p' buffers
    __shared__ float sh[33];
    const int b = blockIdx.x;
    const int ny = A.ny, nx = A.nx;
    const size_t off_u = (size_t)b * ny * (nx + 1), off = (size_t)b * ny * nx;
    const float dt = A.scal[3 * b], nu = A.scal[3 * b + 1], inlet = A.scal[3 * b + 2];
    Sc s{A.u + off_u, A.v + off, A.p + off, A.rhs_w + off, smem, smem + ny * nx, sh, 0};

    // Predictor into u, v (u*, v*); the warm start into shared memory.
    const PredArgs P{A.u_in + off_u, A.v_in + off, nullptr, nullptr, nullptr, nullptr,
                     A.mask_u, A.mask_v, ny, nx, 0, ny, A.dx, A.dy, A.dx2, A.dy2};
    for (int k = threadIdx.x; k < ny * (nx + 1); k += blockDim.x)
        s.u[k] = ustar_at<FIRST, false>(P, dt, nu, k / (nx + 1), k % (nx + 1));
    for (int k = threadIdx.x; k < ny * nx; k += blockDim.x) {
        s.v[k] = vstar_at<FIRST>(P, dt, nu, k / nx, k % nx);
        s.cur[k] = A.pp_in[off + k];
    }
    __syncthreads();
    divergence(A, s, dt);
    float err = A.sor ? sor_solve(A, s) : jacobi_solve(A, s);
    correct(A, s, dt, A.p_in + off);
    // Outer rounds (model.rs:696-724): `it < rounds and err >= outer_tol`.
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        divergence(A, s, dt);
        err = A.sor ? sor_solve(A, s) : jacobi_solve(A, s);
        correct(A, s, dt, s.p);
    }
    for (int k = threadIdx.x; k < ny * nx; k += blockDim.x) A.pp[off + k] = s.cur[k];
    // BCs (ops/bc.py). The outlet copies the corrected u[:, nx-1] before the
    // solid mask may zero it: stage that column in the free buffer first.
    for (int j = threadIdx.x; j < ny; j += blockDim.x) s.other[j] = s.u[j * (nx + 1) + nx - 1];
    __syncthreads();
    for (int k = threadIdx.x; k < ny * (nx + 1); k += blockDim.x) {
        const int j = k / (nx + 1), i = k % (nx + 1);
        float val = (i == 0) ? inlet : (i == nx) ? s.other[j] : s.u[k];
        if (j == 0 || j == ny - 1) val = 0.0f;
        if (masked(A.mask_u_bc, k)) val = 0.0f;
        s.u[k] = val;
    }
    for (int k = threadIdx.x; k < ny * nx; k += blockDim.x) {
        const int j = k / nx, i = k % nx;
        if (j == 0 || masked(A.mask_v_bc, k)) s.v[k] = 0.0f;
    }
    if (threadIdx.x == 0) {
        A.err_out[b] = err;
        A.counts[2 * b] = rounds_run;
        A.counts[2 * b + 1] = s.sweeps;
    }
}

// The cluster form: cluster blockIdx.x / C takes scene b, RP rows a CTA.
template <int RT, bool RHS_SMEM, bool SOR>
__global__ void __launch_bounds__(kCThreads, 1) ensemble_cluster_kernel(EnsArgs A, int RP) {
    extern __shared__ __align__(16) float smem[];
    __shared__ unsigned cmax[3];  // the CTA's max an exchange, in rotation
    __shared__ uint64_t bars[2];
    cg::cluster_group cl = cg::this_cluster();
    const int b = blockIdx.x / (int)cl.num_blocks();
    const int ny = A.ny, nx = A.nx, tid = threadIdx.x;
    const size_t off_u = (size_t)b * ny * (nx + 1), off = (size_t)b * ny * nx;
    const float dt = A.scal[3 * b], nu = A.scal[3 * b + 1], inlet = A.scal[3 * b + 2];
    SlabSmem M;
    Slab S = slab_setup(cl, ny, nx, RP, RHS_SMEM, smem, cmax, bars, M);
    float* cur = M.cur;
    float* other = M.other;
    const int P = S.P;
    // The predictor into u, v (u*, v*) on the slab's rows; p and the warm
    // start into shared memory.
    const PredArgs PA{A.u_in + off_u, A.v_in + off, nullptr, nullptr, nullptr, nullptr,
                      A.mask_u, A.mask_v, ny, nx, 0, ny, A.dx, A.dy, A.dx2, A.dy2};
    const size_t o = (size_t)S.r0 * nx, ou = (size_t)S.r0 * (nx + 1);
    for (int q = tid; q < S.nrow * (nx + 1); q += kCThreads) {
        const int r = q / (nx + 1), i = q - r * (nx + 1);
        A.u[off_u + ou + q] = ustar_at<FIRST, false>(PA, dt, nu, S.r0 + r, i);
    }
    for (int q = tid; q < S.nrow * P; q += kCThreads) {
        const int r = q / P, i = q - r * P;
        float pp = 0.0f;  // the padding columns hold 0
        if (i < nx) {
            const size_t k = o + (size_t)r * nx + i;
            A.v[off + k] = vstar_at<FIRST>(PA, dt, nu, S.r0 + r, i);
            A.p[off + k] = A.p_in[off + k];
            pp = A.pp_in[off + k];
        }
        row_of(S, cur, r)[i] = pp;
        row_of(S, other, r)[i] = pp;
    }
    cluster_barrier();  // every slab's u* and v*, every mbarrier initialised
    const float* arr = RHS_SMEM ? M.rb : A.rhs_w + off;
    cluster_divergence<RHS_SMEM>(A, S, b, M.rb, dt);
    __syncthreads();  // the rhs, before another thread's sweep reads it
    float err = cluster_solve<RT, RHS_SMEM, SOR, false>(A, S, cmax, arr, cur, other);
    cluster_correct(A, S, b, cur, dt);
    // Outer rounds (model.rs:696-724): `it < rounds and err >= outer_tol`.
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        cluster_divergence<RHS_SMEM>(A, S, b, M.rb, dt);
        __syncthreads();
        err = cluster_solve<RT, RHS_SMEM, SOR, false>(A, S, cmax, arr, cur, other);
        cluster_correct(A, S, b, cur, dt);
    }
    for (int q = tid; q < S.nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx;
        A.pp[off + o + q] = row_of(S, cur, r)[i];
    }
    cluster_bcs(A, S, b, other, Inlet{0, A.dy, 0.0f, 0.0f}, inlet);
    if (S.rank == 0 && tid == 0) {
        A.err_out[b] = err;
        A.counts[2 * b] = rounds_run;
        A.counts[2 * b + 1] = SOR ? S.sweep / 2 : S.sweep;  // an SOR iteration: two halves
    }
}

using EnsClusterFn = void (*)(EnsArgs, int);

EnsClusterFn ensemble_cluster_fn(const SlabPlan& pl, bool sor) {
#define CFD_RT(R)                                                                          \
    case R:                                                                                \
        return pl.rhs_smem ? (sor ? ensemble_cluster_kernel<R, true, true>                 \
                                  : ensemble_cluster_kernel<R, true, false>)               \
                           : (sor ? ensemble_cluster_kernel<R, false, true>                \
                                  : ensemble_cluster_kernel<R, false, false>);
    switch (pl.rt) { CFD_RT(1) CFD_RT(2) CFD_RT(3) CFD_RT(4) CFD_RT(6) }
#undef CFD_RT
    return nullptr;
}

}  // namespace

// How many clusters of C CTAs of the cluster form (sor: its SOR solve) the
// card holds at once for (ny, nx) scenes, or minus the CUDA error; minus
// cudaErrorInvalidValue where slab_plan cannot split the scene over C
// CTAs. Sets the kernel's attributes (on the current device).
extern "C" int cfd_substep_batch_cluster_admit(int ny, int nx, int C, int sor) {
    const SlabPlan pl = slab_plan(ny, nx, C);
    if (pl.rt == 0) return -(int)cudaErrorInvalidValue;
    return cluster_admit(ensemble_cluster_fn(pl, sor != 0), C, pl.smem);
}

// The cluster form (cfd_substep_batch's arguments, then C): B clusters of
// C CTAs (kernels/cluster.py picks C). Fails (never falls back) if
// slab_plan cannot split the scene over C CTAs or the card refuses the
// launch.
extern "C" int cfd_substep_batch_cluster(
        const float* u_in, const float* v_in, const float* p_in, const float* pp_in,
        const float* scal, float* u, float* v, float* p, float* pp, float* rhs,
        float* err_out, int* counts, const uint8_t* mask_u, const uint8_t* mask_v,
        const uint8_t* mask_u_bc, const uint8_t* mask_v_bc, int B, int ny, int nx, float dx,
        float dy, float dx2, float dy2, float ax, float ay, float ar, float ac, float om,
        int sor, int iters, float tol, int rounds, float outer_tol, int C, void* stream) {
    const SlabPlan pl = slab_plan(ny, nx, C);
    if (B < 1 || pl.rt == 0) return (int)cudaErrorInvalidValue;
    EnsArgs A{u_in, v_in, p_in, pp_in, scal, u, v, p, pp, rhs, err_out, counts, ny, nx,
              dx, dy, dx2, dy2, ax, ay, ar, ac, om, sor, iters, tol, rounds, outer_tol,
              mask_u, mask_v, mask_u_bc, mask_v_bc};
    const EnsClusterFn fn = ensemble_cluster_fn(pl, sor != 0);
    cudaError_t e = cluster_attributes(fn, C);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(B, C, pl.smem, &attr);
    cfg.stream = (cudaStream_t)stream;
    e = cudaLaunchKernelEx(&cfg, fn, A, pl.rp);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The block form. Bytes of dynamic shared memory a launch on an (ny, nx)
// scene needs.
extern "C" int cfd_substep_batch_smem(int ny, int nx) {
    return (int)(2 * sizeof(float) * (size_t)ny * nx);
}

extern "C" int cfd_substep_batch(const float* u_in, const float* v_in, const float* p_in,
                                 const float* pp_in, const float* scal, float* u, float* v,
                                 float* p, float* pp, float* rhs, float* err_out,
                                 int* counts, const uint8_t* mask_u, const uint8_t* mask_v,
                                 const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                                 int B, int ny, int nx, float dx, float dy,
                                 float dx2, float dy2, float ax, float ay, float ar,
                                 float ac, float om, int sor, int iters, float tol,
                                 int rounds, float outer_tol, void* stream) {
    EnsArgs A{u_in, v_in, p_in, pp_in, scal, u, v, p, pp, rhs, err_out, counts, ny, nx,
              dx, dy, dx2, dy2, ax, ay, ar, ac, om, sor, iters, tol, rounds, outer_tol,
              mask_u, mask_v, mask_u_bc, mask_v_bc};
    const int smem = cfd_substep_batch_smem(ny, nx);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (B < 1 || ny < 3 || nx < 3 || smem + 33 * (int)sizeof(float) > optin)
        return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(ensemble_substep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ensemble_substep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
