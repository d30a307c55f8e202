// A whole PISO substep of every scene of a batch in one launch: predictor,
// divergence, a do-while Jacobi or red/black SOR solve with an exact
// per-scene exit, corrector, up to `rounds` outer corrector rounds with an
// exact exit, then the velocity BCs (Rust semantics, FIRST upwind, CHANNEL
// flow, UNIFORM inlet). Replaces cfd_demo_tpu/kernels/ensemble_pallas.py
// substep_batch_pallas (_kernel_sub, with make_jacobi_solve or
// make_sor_solve). See kernels/ensemble.py for the design note.
//
// One thread block per scene. The block keeps the scene's p' in shared
// memory: Jacobi in two buffers it ping-pongs between sweeps, SOR in place
// in one (the other stages the outlet column for the BCs); u, v, p and the
// divergence in global memory (L2). A scene never reads another scene's
// data, so __syncthreads() is the only barrier it needs; global writes of a
// block are visible to that block after it, so in-kernel data is read with
// plain loads (never __ldg).
#include "predict.cuh"

namespace {

constexpr int kThreads = 1024;

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
    float* rhs;          // scratch (B, ny, nx): the divergence
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
    Sc s{A.u + off_u, A.v + off, A.p + off, A.rhs + off, smem, smem + ny * nx, sh, 0};

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

}  // namespace

// Bytes of dynamic shared memory a launch on an (ny, nx) scene needs.
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
