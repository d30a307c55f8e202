// A batched damped-Jacobi solve, CHANNEL flow: B scenes of (ny, nx), each
// frozen at the sweep where its own max |change| drops below tol, then the
// p' BCs once, rows then columns. Replaces
// cfd_demo_tpu/kernels/jacobi_pallas.py jacobi_pallas_batch (_kernel_batch).
// See kernels/jacobi_batch.py for the design note.
//
// Two forms of the same function, the same bits and counts.
//
// The cluster form (jacobi_batch_cluster_kernel): one thread-block cluster
// of C CTAs per scene, B clusters a launch, on cluster.cuh's machinery:
// the scene's p' in the cluster's shared memory, ar * rhs there where it
// fits (else rhs from L2), the masked loop's do-while run per cluster
// with the exact exit (the order-free integer max of the bit patterns),
// the p' BCs once, then err and the sweeps written per scene. The scenes
// are independent, so there is no grid-wide barrier; a scene flagged in
// done_in only copies its pp0 (its cluster returns at once).
//
// The cooperative form (jacobi_batch_kernel), for scenes no cluster holds:
// a persistent cooperative kernel like rounds.cu's: at most one resident
// block per SM, a grid-wide barrier after each sweep, and per scene a
// rotating three-slot atomicMax for the sweep's max. Each block keeps its
// own copy of every scene's error, exit flag, sweep count and buffer
// parity in shared memory; all blocks compute them from the same slots, so
// they agree without further barriers. Data written inside the kernel is
// read with __ldcg (L2). Scenes flagged in done_in start frozen: with
// every scene flagged, the launch copies pp0 and returns after its first
// grid-wide barrier.
#include "cluster.cuh"

namespace {

constexpr int kThreads = 1024;  // the cooperative form's block

struct BatchArgs {
    const float* pp0;  // (B, ny, nx), BC-consistent
    const float* rhs;  // (B, ny, nx)
    const bool* done_in;  // (B,) scenes not to sweep, or null for none
    float* out;        // out p' (B, ny, nx); also the parity-0 buffer
    float* tmp;        // scratch (B, ny, nx): the parity-1 buffer
    float* slots;      // scratch (B, 3): per-sweep grid max, in rotation
    float* err_out;    // out (B,)
    int* n_out;        // out (B,)
    int B, ny, nx, iters;
    float tol, ax, ay, ar, ac;
};

__global__ void __launch_bounds__(kThreads) jacobi_batch_kernel(BatchArgs A) {
    // Per scene: this block's max bits, buffer parity, exit flag, sweeps, err.
    extern __shared__ int dyn[];
    int* smax = dyn;
    int* par = dyn + A.B;
    int* done = dyn + 2 * A.B;
    int* n = dyn + 3 * A.B;
    float* err = reinterpret_cast<float*>(dyn + 4 * A.B);
    __shared__ int all_done;
    cg::grid_group grid = cg::this_grid();
    const int ny = A.ny, nx = A.nx, B = A.B;
    const size_t cells = (size_t)ny * nx;
    const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t gthreads = (size_t)gridDim.x * blockDim.x;
    const int lane = threadIdx.x & 31;
    const long gwarp = (long)(gtid >> 5), nwarps = (long)(gthreads >> 5);

    for (size_t k = gtid; k < B * cells; k += gthreads) A.out[k] = A.pp0[k];
    for (size_t t = gtid; t < 3 * (size_t)B; t += gthreads) A.slots[t] = 0.0f;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
        smax[b] = 0; par[b] = 0; n[b] = 0;
        done[b] = A.done_in ? (int)A.done_in[b] : 0;
        err[b] = __int_as_float(0x7f800000);  // +inf
    }
    if (threadIdx.x == 0) all_done = 1;
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += blockDim.x)
        if (!done[b]) all_done = 0;
    grid.sync();

    // A warp takes one (scene, row, 32-column chunk) segment at a time.
    const int nch = (nx - 2 + 31) / 32;
    const long per_scene = (long)(ny - 2) * nch;
    const int iters = A.iters > 1 ? A.iters : 1;  // a do-while: one sweep at least
    for (int s = 0; s < iters && !all_done; ++s) {  // the same in every block
        for (long seg = gwarp; seg < B * per_scene; seg += nwarps) {
            const int b = (int)(seg / per_scene);
            if (done[b]) continue;  // the whole warp: one scene per segment
            const long r = seg % per_scene;
            const int j = 1 + (int)(r / nch), i = 1 + (int)(r % nch) * 32 + lane;
            const float* cur = (par[b] ? A.tmp : A.out) + b * cells;
            float* nxt = (par[b] ? A.out : A.tmp) + b * cells;
            float d = 0.0f;
            if (i <= nx - 2) {
                const size_t k = (size_t)j * nx + i;
                const float C = __ldcg(cur + k);
                const float E = (i == nx - 2) ? 0.0f : __ldcg(cur + k + 1);
                const float W = (i == 1) ? C : __ldcg(cur + k - 1);
                const float N = (j == ny - 2) ? C : __ldcg(cur + k + nx);
                const float S = (j == 1) ? C : __ldcg(cur + k - nx);
                const float nv = A.ax * (E + W) + A.ay * (N + S) + A.ac * C
                                 - A.ar * __ldg(A.rhs + b * cells + k);
                nxt[k] = nv;
                d = fabsf(nv - C);
            }
            for (int o = 16; o > 0; o >>= 1) d = pmax(d, __shfl_xor_sync(0xffffffffu, d, o));
            // d >= 0 (or +NaN): the float order is the order of the bits as ints.
            if (lane == 0 && d != 0.0f) atomicMax(smax + b, __float_as_int(d));
        }
        __syncthreads();
        for (int b = threadIdx.x; b < B; b += blockDim.x) {
            if (!done[b] && smax[b] != 0)
                atomicMax(reinterpret_cast<int*>(A.slots + 3 * b + s % 3), smax[b]);
            smax[b] = 0;
            if (blockIdx.x == 0) A.slots[3 * b + (s + 1) % 3] = 0.0f;
        }
        grid.sync();
        if (threadIdx.x == 0) all_done = 1;
        __syncthreads();
        for (int b = threadIdx.x; b < B; b += blockDim.x) {
            if (!done[b]) {
                const float e = __ldcg(A.slots + 3 * b + s % 3);
                err[b] = e;
                n[b] += 1;
                par[b] ^= 1;
                if (e < A.tol) done[b] = 1;
                else all_done = 0;
            }
        }
        __syncthreads();
    }
    // Scenes whose last sweep landed in tmp: move them to out.
    for (size_t k = gtid; k < B * cells; k += gthreads)
        if (par[k / cells]) A.out[k] = __ldcg(A.tmp + k);
    grid.sync();
    // p' BCs once, rows then columns, from interior values only.
    const int nbc = 2 * nx + 2 * (ny - 2);
    for (size_t t = gtid; t < (size_t)B * nbc; t += gthreads) {
        const int b = (int)(t / nbc), q0 = (int)(t % nbc);
        int j, i;
        if (q0 < 2 * nx) { j = (q0 < nx) ? 0 : ny - 1; i = q0 % nx; }
        else { const int q = q0 - 2 * nx; j = 1 + q % (ny - 2); i = (q < ny - 2) ? 0 : nx - 1; }
        float* o = A.out + b * cells;
        float val = 0.0f;  // outlet (Dirichlet)
        if (i != nx - 1) {
            const int ii = (i == 0) ? 1 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            val = __ldcg(o + (size_t)jj * nx + ii);
        }
        o[(size_t)j * nx + i] = val;
    }
    if (blockIdx.x == 0) {
        for (int b = threadIdx.x; b < B; b += blockDim.x) {
            A.err_out[b] = err[b];
            A.n_out[b] = n[b];
        }
    }
}

// The cluster form: cluster blockIdx.x / C solves scene b, RP rows a CTA.
template <int RT, bool RHS_SMEM>
__global__ void __launch_bounds__(kCThreads, 1) jacobi_batch_cluster_kernel(BatchArgs A,
                                                                           int RP) {
    extern __shared__ __align__(16) float smem[];
    __shared__ unsigned cmax[3];  // the CTA's max a sweep, in rotation
    __shared__ uint64_t bars[2];
    cg::cluster_group cl = cg::this_cluster();
    const int b = blockIdx.x / (int)cl.num_blocks();
    const int ny = A.ny, nx = A.nx, tid = threadIdx.x;
    const size_t base = (size_t)b * ny * nx;
    const float* pp0 = A.pp0 + base;
    float* out = A.out + base;
    if (A.done_in != nullptr && A.done_in[b]) {  // frozen: p' = pp0, err inf, 0 sweeps
        const int rank = (int)cl.block_rank();
        const int r0 = min(ny, rank * RP), r1 = min(ny, r0 + RP);
        for (size_t k = (size_t)r0 * nx + tid; k < (size_t)r1 * nx; k += kCThreads)
            out[k] = pp0[k];
        if (rank == 0 && tid == 0) {
            A.err_out[b] = __int_as_float(0x7f800000);
            A.n_out[b] = 0;
        }
        return;
    }
    SlabSmem M;
    Slab S = slab_setup(cl, ny, nx, RP, RHS_SMEM, smem, cmax, bars, M);
    float* cur = M.cur;
    float* other = M.other;
    const int P = S.P;
    const size_t o = (size_t)S.r0 * nx;
    const float* rhs = A.rhs + base;
    for (int q = tid; q < S.nrow * P; q += kCThreads) {
        const int r = q / P, i = q - r * P;
        float pp = 0.0f, rr = 0.0f;  // the padding columns hold 0
        if (i < nx) {
            const size_t k = o + (size_t)r * nx + i;
            pp = pp0[k];
            rr = A.ar * rhs[k];
        }
        row_of(S, cur, r)[i] = pp;
        row_of(S, other, r)[i] = pp;
        if (RHS_SMEM) M.rb[q] = rr;
    }
    cluster_barrier();  // every slab loaded, every mbarrier initialised
    const float err = cluster_solve<RT, RHS_SMEM, false, true>(A, S, cmax,
                                                               RHS_SMEM ? M.rb : rhs, cur,
                                                               other);
    for (int q = tid; q < S.nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx;
        out[o + q] = row_of(S, cur, r)[i];
    }
    if (S.rank == 0 && tid == 0) {
        A.err_out[b] = err;
        A.n_out[b] = S.sweep;
    }
}

using BatchClusterFn = void (*)(BatchArgs, int);

BatchClusterFn batch_cluster_kernel(const SlabPlan& pl) {
#define CFD_RT(R)                                                                          \
    case R:                                                                                \
        return pl.rhs_smem ? jacobi_batch_cluster_kernel<R, true>                          \
                           : jacobi_batch_cluster_kernel<R, false>;
    switch (pl.rt) { CFD_RT(1) CFD_RT(2) CFD_RT(3) CFD_RT(4) CFD_RT(6) }
#undef CFD_RT
    return nullptr;
}

}  // namespace

// How many clusters of C CTAs of the cluster form the card holds at once
// for (ny, nx) scenes (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error; minus cudaErrorInvalidValue where slab_plan cannot split the
// scene over C CTAs. Sets the kernel's attributes (on the current device).
extern "C" int cfd_jacobi_batch_cluster_admit(int ny, int nx, int C) {
    const SlabPlan pl = slab_plan(ny, nx, C);
    if (pl.rt == 0) return -(int)cudaErrorInvalidValue;
    return cluster_admit(batch_cluster_kernel(pl), C, pl.smem);
}

// The cluster form: B clusters of C CTAs (kernels/cluster.py picks C).
// Fails (never falls back) if slab_plan cannot split the scene over C
// CTAs or the card refuses the launch.
extern "C" int cfd_jacobi_batch_cluster(const float* pp0, const float* rhs,
                                        const bool* done_in, float* out, float* err_out,
                                        int* n_out, int B, int ny, int nx, int iters,
                                        float tol, float ax, float ay, float ar, float ac,
                                        int C, void* stream) {
    const SlabPlan pl = slab_plan(ny, nx, C);
    if (B < 1 || pl.rt == 0) return (int)cudaErrorInvalidValue;
    BatchArgs A{pp0, rhs, done_in, out, nullptr, nullptr, err_out, n_out, B, ny, nx, iters,
                tol, ax, ay, ar, ac};
    const BatchClusterFn fn = batch_cluster_kernel(pl);
    cudaError_t e = cluster_attributes(fn, C);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(B, C, pl.smem, &attr);
    cfg.stream = (cudaStream_t)stream;
    e = cudaLaunchKernelEx(&cfg, fn, A, pl.rp);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The cooperative form: one block per SM, all resident as the grid-wide barrier requires.
extern "C" int cfd_jacobi_batch(const float* pp0, const float* rhs, const bool* done_in,
                                float* out, float* tmp, float* slots, float* err_out,
                                int* n_out, int B, int ny, int nx, int iters, float tol,
                                float ax, float ay, float ar, float ac, void* stream) {
    if (B < 1 || ny < 3 || nx < 3) return (int)cudaErrorInvalidValue;
    BatchArgs A{pp0, rhs, done_in, out, tmp, slots, err_out, n_out, B, ny, nx, iters,
                tol, ax, ay, ar, ac};
    const size_t smem = 5 * sizeof(int) * (size_t)B;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
        e = cudaFuncSetAttribute(jacobi_batch_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jacobi_batch_kernel,
                                                          kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&A};
    e = cudaLaunchCooperativeKernel((const void*)jacobi_batch_kernel, dim3(sms),
                                    dim3(kThreads), args, smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
