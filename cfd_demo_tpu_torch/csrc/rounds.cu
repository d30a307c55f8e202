// The whole pressure projection of one scene in one launch: exact
// do-while Jacobi, corrector, up to `rounds` outer corrector rounds with an
// exact exit, then the velocity BCs (CHANNEL, UNIFORM or parabolic inlet,
// either semantics' BC masks; or CAVITY, a template flag of every form:
// the all-Neumann p' folds and BCs with the (0, 0) gauge, the lid and the
// walls). JS's zero warm start arrives as pp0.
// Replaces cfd_demo_tpu/kernels/rounds_pallas.py solve_correct_rounds_pallas
// (_kernel_rounds) with its in-kernel solver ensemble_pallas.make_jacobi_solve.
// See kernels/rounds.py for the design note.
//
// Three forms of the same function, the same bits and counts, chosen
// before the launch by shape (kernels/rounds.py rounds_form). A sweep of
// the rounds is a few microseconds of work, and each needs a barrier and
// a global max before the next (the exact exit).
//
// The cluster form (rounds_cluster_kernel, on cluster.cuh's machinery,
// which the batched kernels share): one thread-block cluster of C CTAs of
// 1024 threads holds p' on chip, a slab of rows a CTA, ar * rhs there too;
// each sweep's max and edge rows travel by st.async onto mbarriers, with
// no cluster-wide barrier a sweep. C and the slabs come from cluster.cuh's
// slab_plan and kernels/cluster.py's pick on the card's admission (14 CTAs
// of 20 rows at 800x264). What bounds it: the sweep's instructions on C
// SMs and the max's round trip through distributed shared memory; it
// takes every grid the pick finds a cluster for (kernels/cluster.py
// cluster_fits). `kernel_times --rounds-forms` on an NVIDIA H100 80GB
// HBM3, 700 W, 1050 sweeps, 16 CTAs (the same slabs, two CTAs idle):
// 3.28 against 3.91 ms at 800x264 and 2.50 against 3.78 at 700x231
// (PERF.md). A first version with 512 threads,
// tests a cell and a three-barrier block max took 4.39 ms at 800x264,
// versions with a cluster.sync() a sweep 5.5-7.3 ms.
//
// The slab form (rounds_slab_kernel) takes the grids no cluster holds
// (1024^2, 1024x512) up to 1024 columns: the cluster form's slabs, strips
// and folds spread over the whole card, one block of 1024 threads an SM
// in a cooperative launch (grid_slab_plan: 128 blocks of 8 rows at 1024^2
// on 132 SMs). p' stays in shared memory; a sweep's edge rows go through
// device memory (L2) to the neighbouring slabs, each block waiting only
// on its two neighbours' flags, and its max through the rotating slot
// and an arrival count, read one sweep late: the next sweep runs on
// speculation and is dropped where the max says the solve had ended. No
// grid-wide barrier a sweep (slab_solve). The p' BCs run on each slab's
// halo rows too, so a solve needs no further exchange. What bounds it:
// the handoff's round trip through L2 between neighbours, a fixed cost a
// sweep, then the strip's rows (PERF.md).
//
// The cooperative form (rounds_kernel) takes the rest (more than 1024
// columns): a persistent cooperative kernel, one resident block per SM,
// and a grid-wide barrier (cooperative_groups grid.sync) wherever the
// next phase reads what other blocks wrote; p' is swept from L2, six
// loads a cell a sweep, so at 1024^2 it is bound by L2's bandwidth (7.8
// us a sweep; 3.7 at 800x264, PERF.md).
//
// In all three, data written inside the kernel to device memory is read
// with __ldcg (L2, bypassing the non-coherent L1).
#include "cluster.cuh"

namespace {

constexpr int kThreads = 1024;

struct RoundsArgs {
    const float* us;    // u* (ny, nx+1)
    const float* vs;    // v* (ny, nx)
    const float* p_in;  // (ny, nx)
    const float* pp0;   // BC-consistent warm start (ny, nx), zeros in JS
    const float* rhs0;  // (ny, nx)
    const float* scal;  // device [dt_sub, inlet]
    float* u;           // out (ny, nx+1)
    float* v;           // out (ny, nx)
    float* p;           // out (ny, nx)
    float* pp;          // out p' (ny, nx)
    float* pp_tmp;      // scratch (ny, nx)
    float* rhs_w;       // scratch (ny, nx): the rounds' divergence
    float* slots;       // scratch [3]: per-sweep grid max, used in rotation
    float* err_out;     // out [1]
    int* counts;        // out [2]: outer rounds run, Jacobi sweeps run
    int ny, nx;
    float dx, dy, ax, ay, ar, ac;
    int iters;
    float tol;
    int rounds;
    float outer_tol;
    const uint8_t* mask_u_bc;  // (ny, nx+1) or null
    const uint8_t* mask_v_bc;  // (ny, nx) or null
    Inlet in;
};

// The grid's warps take (row, 32-column chunk) segments in turn, so a
// warp reads consecutive addresses. The body runs for cell (j, i).
#define FOR_CELLS(j0, j1, i0, i1)                                                 \
    for (int nch_ = ((i1) - (i0) + 31) / 32, seg_ = gwarp;                        \
         seg_ < ((j1) - (j0)) * nch_; seg_ += nwarps)                            \
        if (const int j = (j0) + seg_ / nch_, i = (i0) + (seg_ % nch_) * 32 + lane; \
            i < (i1))

struct Ctx {
    cg::grid_group grid;
    float* sh;
    int gwarp, nwarps, lane, gtid, gthreads;
    int sweep;  // sweeps run so far: picks the rotating max slot
};

// Max of m over the whole grid. Slot s % 3 collects this sweep's block
// maxima; slot (s+1) % 3, last read before the previous barrier, is
// cleared for the next sweep. m >= 0 (or +NaN), so the float order is
// the order of the bit patterns as ints.
__device__ float grid_max(const RoundsArgs& A, Ctx& c, float m) {
    m = block_max(m, c.sh);
    const int s = c.sweep++;
    if (threadIdx.x == 0) {
        atomicMax(reinterpret_cast<int*>(A.slots + s % 3), __float_as_int(m));
        if (blockIdx.x == 0) A.slots[(s + 1) % 3] = 0.0f;
    }
    c.grid.sync();
    return __ldcg(A.slots + s % 3);
}

// ensemble_pallas.make_jacobi_solve: do-while `it == 0 or (it < iters and
// err >= tol)`, folded boundary reads, p' BCs once after the loop (CAVITY:
// E at nx-2 reads the cell, the right column copies column nx-2, (0, 0)
// is pinned to 0). The result lands in cur; other is the ping-pong buffer.
template <bool CAVITY>
__device__ float jacobi_solve(const RoundsArgs& A, Ctx& c, const float* rhs,
                              float*& cur, float*& other) {
    const int ny = A.ny, nx = A.nx;
    const int gwarp = c.gwarp, nwarps = c.nwarps, lane = c.lane;
    float err;
    int it = 0;
    do {
        float m = 0.0f;
        FOR_CELLS(1, ny - 1, 1, nx - 1) {
            const size_t k = (size_t)j * nx + i;
            const float C = __ldcg(cur + k);
            const float E = (i == nx - 2) ? (CAVITY ? C : 0.0f) : __ldcg(cur + k + 1);
            const float W = (i == 1) ? C : __ldcg(cur + k - 1);
            const float N = (j == ny - 2) ? C : __ldcg(cur + k + nx);
            const float S = (j == 1) ? C : __ldcg(cur + k - nx);
            const float nv = A.ax * (E + W) + A.ay * (N + S) + A.ac * C - A.ar * __ldcg(rhs + k);
            other[k] = nv;
            m = pmax(m, fabsf(nv - C));
        }
        err = grid_max(A, c, m);  // its barrier also publishes `other`
        float* t = cur; cur = other; other = t;
        ++it;
    } while (it < A.iters && err >= A.tol);
    // p' BCs, rows then columns, from interior values only.
    for (int b = c.gtid; b < 2 * nx + 2 * (ny - 2); b += c.gthreads) {
        int j, i;
        if (b < 2 * nx) { j = (b < nx) ? 0 : ny - 1; i = b % nx; }
        else { const int q = b - 2 * nx; j = 1 + q % (ny - 2); i = (q < ny - 2) ? 0 : nx - 1; }
        float val = 0.0f;
        if (CAVITY || i != nx - 1) {
            const int ii = (i == 0) ? 1 : (CAVITY && i == nx - 1) ? nx - 2 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            val = __ldcg(cur + (size_t)jj * nx + ii);
        }
        if (CAVITY && i == 0 && j == 0) val = 0.0f;
        cur[(size_t)j * nx + i] = val;
    }
    c.grid.sync();
    return err;
}

// ops/corrector.py in place on (u, v, p).
__device__ void correct_inplace(const RoundsArgs& A, Ctx& c, const float* pp, float dt) {
    const int ny = A.ny, nx = A.nx;
    const int gwarp = c.gwarp, nwarps = c.nwarps, lane = c.lane;
    FOR_CELLS(0, ny, 1, nx) {
        const size_t kp = (size_t)j * nx + i;
        const size_t ku = (size_t)j * (nx + 1) + i;
        A.u[ku] = __ldcg(A.u + ku) - dt * (__ldcg(pp + kp) - __ldcg(pp + kp - 1)) / A.dx;
    }
    FOR_CELLS(0, ny, 0, nx) {
        const size_t k = (size_t)j * nx + i;
        const float ppk = __ldcg(pp + k);
        if (j >= 1) A.v[k] = __ldcg(A.v + k) - dt * (ppk - __ldcg(pp + k - nx)) / A.dy;
        A.p[k] = __ldcg(A.p + k) + ppk;
    }
    c.grid.sync();
}

// ops/divergence.py into rhs_w.
__device__ void divergence(const RoundsArgs& A, Ctx& c, float dt) {
    const int ny = A.ny, nx = A.nx;
    const int gwarp = c.gwarp, nwarps = c.nwarps, lane = c.lane;
    FOR_CELLS(0, ny, 0, nx) {
        const size_t k = (size_t)j * nx + i;
        const size_t ku = (size_t)j * (nx + 1) + i;
        const float du = (__ldcg(A.u + ku + 1) - __ldcg(A.u + ku)) / A.dx;
        const float vN = (j + 1 < ny) ? __ldcg(A.v + k + nx) : 0.0f;
        const float dv = (vN - __ldcg(A.v + k)) / A.dy;
        A.rhs_w[k] = (du + dv) / dt;
    }
    c.grid.sync();
}

template <bool CAVITY>
__global__ void __launch_bounds__(kThreads) rounds_kernel(RoundsArgs A) {
    __shared__ float sh[33];
    Ctx c{cg::this_grid(), sh, 0, 0, 0, 0, 0, 0};
    c.lane = threadIdx.x & 31;
    c.gwarp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    c.nwarps = gridDim.x * (kThreads / 32);
    c.gtid = blockIdx.x * kThreads + threadIdx.x;
    c.gthreads = gridDim.x * kThreads;
    const int gwarp = c.gwarp, nwarps = c.nwarps, lane = c.lane;
    const int ny = A.ny, nx = A.nx;
    const float dt = A.scal[0], inlet = A.scal[1];
    for (int k = c.gtid; k < ny * (nx + 1); k += c.gthreads) A.u[k] = A.us[k];
    for (int k = c.gtid; k < ny * nx; k += c.gthreads) {
        A.v[k] = A.vs[k];
        A.p[k] = A.p_in[k];
        A.pp[k] = A.pp0[k];
    }
    if (c.gtid < 3) A.slots[c.gtid] = 0.0f;
    c.grid.sync();
    float* cur = A.pp;
    float* other = A.pp_tmp;
    float err = jacobi_solve<CAVITY>(A, c, A.rhs0, cur, other);
    correct_inplace(A, c, cur, dt);
    // Outer rounds (piso.py _outer_rounds): `it < rounds and err >= outer_tol`.
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        divergence(A, c, dt);
        err = jacobi_solve<CAVITY>(A, c, A.rhs_w, cur, other);
        correct_inplace(A, c, cur, dt);
    }
    if (cur != A.pp) {
        for (int k = c.gtid; k < ny * nx; k += c.gthreads) A.pp[k] = __ldcg(cur + k);
    }
    // BCs (ops/bc.py). The outlet copies the corrected u[:, nx-1] before the
    // solid mask may zero it, so stage that column first. CAVITY: the lid
    // (A.in holds its profile), the floor and the side walls.
    if constexpr (!CAVITY) {
        for (int j = c.gtid; j < ny; j += c.gthreads)
            A.rhs_w[j] = __ldcg(A.u + (size_t)j * (nx + 1) + nx - 1);
        c.grid.sync();
    }
    FOR_CELLS(0, ny, 0, nx + 1) {
        const size_t ku = (size_t)j * (nx + 1) + i;
        float val;
        if constexpr (CAVITY) {
            val = (j == ny - 1) ? lid_at(A.in, inlet, i) : __ldcg(A.u + ku);
            if (j == 0 || i == 0 || i == nx) val = 0.0f;
        } else {
            val = (i == 0) ? inlet_at(A.in, inlet, j)
                  : (i == nx) ? __ldcg(A.rhs_w + j) : __ldcg(A.u + ku);
            if (j == 0 || j == ny - 1) val = 0.0f;
        }
        if (masked(A.mask_u_bc, ku)) val = 0.0f;
        A.u[ku] = val;
    }
    FOR_CELLS(0, ny, 0, nx) {
        const size_t k = (size_t)j * nx + i;
        if (j == 0 || (CAVITY && (i == 0 || i == nx - 1)) || masked(A.mask_v_bc, k))
            A.v[k] = 0.0f;
    }
    if (c.gtid == 0) {
        A.err_out[0] = err;
        A.counts[0] = rounds_run;
        A.counts[1] = c.sweep;
    }
}


// ---------------------------------------------------------------------------
// The cluster form (the machinery is cluster.cuh's)
// ---------------------------------------------------------------------------

// RT: slab rows a thread; RHS_SMEM: keep ar * rhs in shared memory or read
// rhs from device memory (slab_plan's rhs_smem); CAVITY: the cavity's p'
// folds and BCs and its velocity BCs.
template <int RT, bool RHS_SMEM, bool CAVITY>
__global__ void __launch_bounds__(kCThreads, 1) rounds_cluster_kernel(RoundsArgs A, int RP) {
    extern __shared__ __align__(16) float smem[];
    __shared__ unsigned cmax[3];  // the CTA's max a sweep, in rotation
    __shared__ uint64_t bars[2];
    const int ny = A.ny, nx = A.nx, tid = threadIdx.x;
    SlabSmem M;
    Slab S = slab_setup(cg::this_cluster(), ny, nx, RP, RHS_SMEM, smem, cmax, bars, M);
    float* cur = M.cur;
    float* other = M.other;
    float* rb = M.rb;  // ar * rhs, (RP, P) (RHS_SMEM)
    const int P = S.P, ncell = S.nrow * nx;
    const float dt = A.scal[0], inlet = A.scal[1];
    const size_t o = (size_t)S.r0 * nx, ou = (size_t)S.r0 * (nx + 1);
    for (int q = tid; q < S.nrow * (nx + 1); q += kCThreads) A.u[ou + q] = A.us[ou + q];
    for (int q = tid; q < S.nrow * P; q += kCThreads) {
        const int r = q / P, i = q - r * P;
        float pp = 0.0f, rr = 0.0f;  // the padding columns hold 0
        if (i < nx) {
            const size_t k = o + (size_t)r * nx + i;
            A.v[k] = A.vs[k];
            A.p[k] = A.p_in[k];
            pp = A.pp0[k];
            rr = A.ar * A.rhs0[k];
        }
        row_of(S, cur, r)[i] = pp;
        row_of(S, other, r)[i] = pp;
        if (RHS_SMEM) rb[q] = rr;
    }
    cluster_barrier();  // every slab loaded, every mbarrier initialised
    float err = cluster_solve<RT, RHS_SMEM, false, false, CAVITY>(
        A, S, cmax, RHS_SMEM ? rb : A.rhs0, cur, other);
    cluster_correct(A, S, 0, cur, dt);
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        cluster_divergence<RHS_SMEM>(A, S, 0, rb, dt);
        __syncthreads();  // the rhs, before another thread's sweep reads it
        err = cluster_solve<RT, RHS_SMEM, false, false, CAVITY>(
            A, S, cmax, RHS_SMEM ? rb : A.rhs_w, cur, other);
        cluster_correct(A, S, 0, cur, dt);
    }
    for (int q = tid; q < ncell; q += kCThreads) {
        const int r = q / nx, i = q - r * nx;
        A.pp[o + q] = row_of(S, cur, r)[i];
    }
    cluster_bcs<CAVITY>(A, S, 0, other, A.in, inlet);
    if (S.rank == 0 && tid == 0) {
        A.err_out[0] = err;
        A.counts[0] = rounds_run;
        A.counts[1] = S.sweep;
    }
}

using ClusterFn = void (*)(RoundsArgs, int);

// The instance of the kernel for cluster.cuh's slab_plan and the flow.
template <bool CAVITY>
ClusterFn rounds_cluster_instance(const SlabPlan& pl) {
#define CFD_RT(R)                                                        \
    case R:                                                              \
        return pl.rhs_smem ? rounds_cluster_kernel<R, true, CAVITY>      \
                           : rounds_cluster_kernel<R, false, CAVITY>;
    switch (pl.rt) { CFD_RT(1) CFD_RT(2) CFD_RT(3) CFD_RT(4) CFD_RT(6) }
#undef CFD_RT
    return nullptr;
}

ClusterFn rounds_cluster_fn(const SlabPlan& pl, int cavity) {
    return cavity ? rounds_cluster_instance<true>(pl) : rounds_cluster_instance<false>(pl);
}


// ---------------------------------------------------------------------------
// The slab form: the cluster form's slabs over the whole card
// ---------------------------------------------------------------------------

// How the slab form splits an (ny, nx) grid over at most `sms` blocks of
// kCThreads threads, one an SM: rows = ceil(ny / sms); rt the first of
// kSlabStrips whose row groups (1024 threads of 4 columns) cover them;
// slabs of rp rows, that rounded up to whole strips, ceil(ny / rp) blocks
// (the last may be short); p' twice with two halo rows in shared memory,
// ar * rhs beside it where it fits (rhs_smem); rt = 0 where the grid is
// beyond the form. kernels/cluster.py grid_slab_plan mirrors it.
struct GridSlabPlan {
    int rt, rp, blocks;
    bool rhs_smem;
    size_t smem;
};

inline GridSlabPlan grid_slab_plan(int ny, int nx, int sms) {
    const GridSlabPlan none{0, 0, 0, false, 0};
    if (nx > kMaxCols || ny < 3 || nx < 3 || sms < 1) return none;
    const int n4 = (nx + 3) / 4, groups = kCThreads / n4, P = 4 * n4;
    const int rows = (ny + sms - 1) / sms, need = (rows + groups - 1) / groups;
    for (int rt : kSlabStrips) {
        if (rt < need) continue;
        const int rp = rt * ((rows + rt - 1) / rt);
        const size_t base = 2 * (size_t)(rp + 2) * P * sizeof(float);
        if (base > (size_t)kSmemMax) return none;
        const size_t with_rhs = base + (size_t)rp * P * sizeof(float);
        const bool s = with_rhs <= (size_t)kSmemMax;
        return GridSlabPlan{rt, rp, (ny + rp - 1) / rp, s, s ? with_rhs : base};
    }
    return none;
}

// Block b's edge row of an exchange (a sweep, dropped ones included) in
// the halo buffer, [2 parities][blocks][bottom, top] rows of P: exchange
// x writes parity x & 1, read by the neighbours once its flag says so.
__device__ __forceinline__ float4* halo_at(float* halo, int par, int blocks, int b, int top,
                                           int P, int gi0) {
    return reinterpret_cast<float4*>(halo + ((size_t)(par * blocks + b) * 2 + top) * P + gi0);
}

// GPU-scope accesses of the PTX memory model for the slab form's flags
// and arrival counts: an acquiring load, a relaxed store, a releasing
// add, and the fence that releases what the block wrote before it.
__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
    asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The slab form's handoff state in device memory (the int32 `sync`
// buffer), each piece on a 128-byte line of its own, so that no block's
// polls and stores queue behind another's at L2: lines 0-2 the rotating
// max slots, each an arrival count and the max's bits; then block b's
// two edge flags, line 3 + 2b its bottom row's and 4 + 2b its top's,
// each the number of the last exchange published plus one.
constexpr int kLineInts = 32;

__host__ __device__ constexpr long long handoff_ints(int blocks) {
    return (long long)kLineInts * (3 + 2 * blocks);
}

struct Handoff {
    int* base;
    __device__ int* arrive(int x) const { return base + kLineInts * (x % 3); }
    __device__ unsigned* slot(int x) const {
        return reinterpret_cast<unsigned*>(base + kLineInts * (x % 3) + 1);
    }
    __device__ int* flag(int b, int top) const { return base + kLineInts * (3 + 2 * b + top); }
};

// cluster_solve (Jacobi, the exact exit) on block S.rank's slab of S.C
// blocks, the same strip, folds, invariants and arithmetic; what differs
// is how a sweep ends, with no grid-wide barrier:
//
// - Neighbour handoffs. The threads at the slab's edges write its edge
//   rows to the halo buffer; after the block's __syncthreads one thread
//   (tc) releases them (fence.acq_rel) under both edge flags, set to the
//   exchange x plus one. A thread at an edge waits (ld.acquire) only on
//   the neighbour's flag for that edge, then reads the row (__ldcg) into
//   the next buffer's halo row, which only it reads in the next sweep.
//   Reusing a parity is safe: block b writes parity x & 1 again at
//   exchange x + 2, which it starts only after acquiring its neighbour
//   n's flag of exchange x + 1; n set that flag after (program order, its
//   __syncthreads, the release) its own read of b's rows of exchange x.
//   The one exchange after which nothing is read, a dropped sweep, ends
//   a solve, and slab_correct's grid barrier follows.
// - A split-phase exit max. tc then adds the block's max to slot x % 3
//   (an exact atomicMax on the bits, in any order) and, releasing it, 1
//   to the slot's arrival count, and the block goes straight on to sweep
//   x + 1. tc reads the max of sweep x one sweep later, once the count
//   reaches the blocks (ld.acquire), before that sweep's __syncthreads,
//   which hands it to every thread. Sweep x + 1 is thus
//   speculative: where sweep x met the tolerance, every block sees the
//   same complete max and drops it: its buffer is not swapped, and the
//   strip's rows that live only in registers were also stored there as
//   sweep x left them, so p', err and the sweeps are those of the
//   do-while loop (`dropped` counts the drops, one a solve at most). No sweep runs past A.iters: after the last one the block
//   waits for its max. Block 0 clears slot (x + 1) % 3 and its count at
//   exchange x, after the count of x - 1 showed every block past its
//   read of x - 2 (or, a solve's first exchange, after a grid barrier),
//   and before its own release of x, which every block acquires before
//   it adds to exchange x + 1.
//
// The halo rows of cur hold the rows beside the slab when the solve
// starts. The p' BCs then run on the slab's rows and its two halo rows,
// from interior values only, so the halo rows hold what the neighbours'
// BCs give their edge rows and no exchange follows.
template <int RT, bool RHS_SMEM, bool CAVITY>
__device__ float slab_solve(const RoundsArgs& A, Slab& S, unsigned* cmax, float* errsh,
                            float* halo, const Handoff& H, int& dropped, const float* arr,
                            float*& cur, float*& other) {
    const int ny = A.ny, nx = A.nx, P = S.P, n4 = P / 4, nrow = S.nrow;
    const int t = threadIdx.x, lane = t & 31, g = t % n4, lr0 = RT * (t / n4);
    const int gi0 = 4 * g;
    const bool act = t < n4 * (kCThreads / n4) && lr0 < nrow;
    const bool w_shfl = lane > 0 && g > 0, e_shfl = lane < 31 && g < n4 - 1;
    const bool shared_cols = lane == 0 || lane == 31;  // read by the next warp
    bool cin[4], zero[4], mir[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        cin[q] = gi0 + q >= 1 && gi0 + q <= nx - 2;
        mir[q] = CAVITY && q > 0 && gi0 + q == nx - 1;
        zero[q] = CAVITY ? gi0 + q >= nx || (q == 0 && gi0 == nx - 1) : gi0 + q >= nx - 1;
    }
    const bool e_self = CAVITY && gi0 + 3 == nx - 2;
    unsigned tested = 0;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const int lr = lr0 + r, j = S.r0 + lr;
        if (lr >= nrow || j <= 1 || j >= ny - 2) tested |= 1u << r;
    }
    // the threads holding the slab's bottom and top rows
    const bool dn_edge = act && lr0 == 0 && S.r0 > 0;
    const bool up_edge = act && lr0 + RT == nrow && S.r0 + nrow < ny;

    float4 val[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (act && lr0 + r < nrow) {
            float4* at = reinterpret_cast<float4*>(row_of(S, cur, lr0 + r) + gi0);
            v = *at;
            if (g == 0) v.x = v.y;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (CAVITY ? zero[q] : gi0 + q == nx - 1) at4(v, q) = 0.0f;
                if (mir[q]) at4(v, q) = at4(v, q - 1);
            }
            *at = v;
        }
        val[r] = v;
    }
    __syncthreads();

    const unsigned lanes = __ballot_sync(0xffffffffu, act);
    // the thread that publishes the block's flags and max and reads the
    // grid's: the last, where it is idle, else the first of the second
    // row group's first whole warp, so that its waits and fence hold up no
    // warp of the slab's bottom edge (or, with more than two row groups,
    // of either edge)
    const bool last_idle = !(kCThreads - 1 < n4 * (kCThreads / n4) &&
                             RT * ((kCThreads - 1) / n4) < nrow);
    const int tc = last_idle ? kCThreads - 1 : 32 * ((n4 + 31) / 32);
    float err;
    int it = 0;
    bool drop = false;
    for (;;) {
        const int x = S.sweep, par = x & 1, s3 = x % 3;
        if (t == 0) cmax[(x + 1) % 3] = 0u;
        uint32_t mbits = 0;
        if (act) {
            float4 Sv = *reinterpret_cast<const float4*>(row_of(S, cur, lr0 - 1) + gi0);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const int lr = lr0 + r, j = S.r0 + lr;
                float4 C = val[r];
                const float4 Nr = (r + 1 < RT)
                    ? val[r + 1 < RT ? r + 1 : r]
                    : *reinterpret_cast<const float4*>(row_of(S, cur, lr + 1) + gi0);
                float Wl = __shfl_up_sync(lanes, C.w, 1);
                float Er = __shfl_down_sync(lanes, C.x, 1);
                const float* crow = row_of(S, cur, lr);
                if (!w_shfl) Wl = (g > 0) ? crow[gi0 - 1] : C.x;
                if (!e_shfl) Er = (g < n4 - 1) ? crow[gi0 + 4] : C.w;
                if (CAVITY && e_self) Er = C.w;
                float4 R;
                if (RHS_SMEM) {
                    R = *reinterpret_cast<const float4*>(arr + (size_t)lr * P + gi0);
                } else {
                    const float* row = arr + (size_t)min(j, ny - 1) * nx;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        at4(R, q) = (gi0 + q < nx) ? A.ar * __ldcg(row + gi0 + q) : 0.0f;
                }
                float4 out;
                if (!(tested & (1u << r))) {
                    out.x = A.ax * (Wl + C.y) + A.ay * (Nr.x + Sv.x) + A.ac * C.x - R.x;
                    out.y = A.ax * (C.x + C.z) + A.ay * (Nr.y + Sv.y) + A.ac * C.y - R.y;
                    out.z = A.ax * (C.y + C.w) + A.ay * (Nr.z + Sv.z) + A.ac * C.z - R.z;
                    out.w = A.ax * (C.z + Er) + A.ay * (Nr.w + Sv.w) + A.ac * C.w - R.w;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (zero[q]) at4(out, q) = 0.0f;
                } else {
                    const bool fn = j == ny - 2, fs = j == 1;
                    const float4 N = make_float4(fn ? C.x : Nr.x, fn ? C.y : Nr.y,
                                                 fn ? C.z : Nr.z, fn ? C.w : Nr.w);
                    const float4 So = make_float4(fs ? C.x : Sv.x, fs ? C.y : Sv.y,
                                                  fs ? C.z : Sv.z, fs ? C.w : Sv.w);
                    float4 nv;
                    nv.x = A.ax * (Wl + C.y) + A.ay * (N.x + So.x) + A.ac * C.x - R.x;
                    nv.y = A.ax * (C.x + C.z) + A.ay * (N.y + So.y) + A.ac * C.y - R.y;
                    nv.z = A.ax * (C.y + C.w) + A.ay * (N.z + So.z) + A.ac * C.z - R.z;
                    nv.w = A.ax * (C.z + Er) + A.ay * (N.w + So.w) + A.ac * C.w - R.w;
                    const bool row_in = lr < nrow && j >= 1 && j <= ny - 2;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        at4(out, q) = (row_in && cin[q]) ? at4(nv, q) : at4(C, q);
                }
                if (g == 0) out.x = out.y;
                if constexpr (CAVITY) {
#pragma unroll
                    for (int q = 1; q < 4; ++q)
                        if (mir[q]) at4(out, q) = at4(out, q - 1);
                }
                mbits = max(mbits, __float_as_uint(out.x - C.x) & 0x7fffffffu);
                mbits = max(mbits, __float_as_uint(out.y - C.y) & 0x7fffffffu);
                mbits = max(mbits, __float_as_uint(out.z - C.z) & 0x7fffffffu);
                mbits = max(mbits, __float_as_uint(out.w - C.w) & 0x7fffffffu);
                Sv = C;
                val[r] = out;
                if (r == 0 || r == RT - 1 || shared_cols)
                    *reinterpret_cast<float4*>(row_of(S, other, lr) + gi0) = out;
                else  // a row only this thread reads: its old value where a drop finds it
                    *reinterpret_cast<float4*>(row_of(S, cur, lr) + gi0) = C;
            }
            if (dn_edge) __stcg(halo_at(halo, par, S.C, S.rank, 0, P, gi0), val[0]);
            if (up_edge) __stcg(halo_at(halo, par, S.C, S.rank, 1, P, gi0), val[RT - 1]);
        }
        mbits = __reduce_max_sync(0xffffffffu, mbits);
        if (lane == 0) atomicMax(cmax + s3, mbits);
        if (t == tc && it > 0) {  // the previous sweep's max, complete
            while (ld_acquire(H.arrive(x - 1)) < S.C) {}
            errsh[(x - 1) & 1] = __uint_as_float(__ldcg(H.slot(x - 1)));
        }
        __syncthreads();
        if (t == tc) {
            if (S.rank == 0) {
                *H.slot(x + 1) = 0u;
                *H.arrive(x + 1) = 0;
            }
            fence_acq_rel();  // the edge rows and the clears, before the flags
            st_relaxed(H.flag(S.rank, 0), x + 1);
            st_relaxed(H.flag(S.rank, 1), x + 1);
            atomicMax(H.slot(x), cmax[s3]);  // after the flags: the slot's queue is not theirs
            red_release_add(H.arrive(x), 1);  // the max, before its count
        }
        ++S.sweep;
        if (it > 0 && !(errsh[(x - 1) & 1] >= A.tol)) {
            // sweep it - 1 ended the solve: drop this one, cur already whole
            err = errsh[(x - 1) & 1];
            drop = true;
            ++dropped;
            break;
        }
        if (dn_edge) {
            while (ld_acquire(H.flag(S.rank - 1, 1)) <= x) {}
            *reinterpret_cast<float4*>(row_of(S, other, -1) + gi0) =
                __ldcg(halo_at(halo, par, S.C, S.rank - 1, 1, P, gi0));
        }
        if (up_edge) {
            while (ld_acquire(H.flag(S.rank + 1, 0)) <= x) {}
            *reinterpret_cast<float4*>(row_of(S, other, nrow) + gi0) =
                __ldcg(halo_at(halo, par, S.C, S.rank + 1, 0, P, gi0));
        }
        float* tmp = cur; cur = other; other = tmp;
        if (++it >= A.iters) {  // the cap: this sweep's max, waited for
            if (t == tc) {
                while (ld_acquire(H.arrive(x)) < S.C) {}
                errsh[x & 1] = __uint_as_float(__ldcg(H.slot(x)));
            }
            __syncthreads();
            err = errsh[x & 1];
            break;
        }
    }
    // the strip whole into the last sweep's buffer
    if (act && !drop) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (r != 0 && r != RT - 1 && !shared_cols && lr0 + r < nrow)
                *reinterpret_cast<float4*>(row_of(S, cur, lr0 + r) + gi0) = val[r];
    }
    __syncthreads();
    // p' BCs on rows -1 .. nrow of the slab that lie in the grid, rows then
    // columns, from interior values only (CAVITY: the right column from
    // column nx-2, then the gauge cell (0, 0) 0); every row read is one
    // of them.
    const int lo = S.r0 > 0 ? -1 : 0, hi = nrow + (S.r0 + nrow < ny ? 1 : 0);
    for (int q = t; q < (hi - lo) * nx; q += kCThreads) {
        const int r = lo + q / nx, i = q % nx, j = S.r0 + r;
        if (j >= 1 && j <= ny - 2 && i >= 1 && i <= nx - 2) continue;
        float v = 0.0f;
        if (CAVITY || i != nx - 1) {
            const int ii = (i == 0) ? 1 : (CAVITY && i == nx - 1) ? nx - 2 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            v = row_of(S, cur, jj - S.r0)[ii];
        }
        if (CAVITY && i == 0 && j == 0) v = 0.0f;
        row_of(S, cur, r)[i] = v;
    }
    __syncthreads();
    return err;
}

// ops/corrector.py in place on (u, v, p), the slab's rows; the row below
// the slab is its halo row. Ends with a grid barrier: the next divergence
// reads v of the row above from the next slab.
__device__ void slab_correct(const RoundsArgs& A, const Slab& S, cg::grid_group& grid,
                             const float* pp, float dt) {
    const int nx = A.nx;
    for (int q = threadIdx.x; q < S.nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx, j = S.r0 + r;
        const float* row = row_of(S, pp, r);
        const float ppk = row[i];
        if (i >= 1) {
            const size_t ku = (size_t)j * (nx + 1) + i;
            A.u[ku] = __ldcg(A.u + ku) - dt * (ppk - row[i - 1]) / A.dx;
        }
        const size_t k = (size_t)j * nx + i;
        if (j >= 1) A.v[k] = __ldcg(A.v + k) - dt * (ppk - row_of(S, pp, r - 1)[i]) / A.dy;
        A.p[k] = __ldcg(A.p + k) + ppk;
    }
    grid.sync();
}

// RT, RHS_SMEM, CAVITY as the cluster form's. A cooperative launch of
// grid_slab_plan's blocks, one an SM, all resident; block b owns the RP
// rows from b RP. Its Slab holds rank b of C = the blocks, so
// cluster.cuh's divergence and BCs, which read only the slab's rows,
// run on it; its cluster handle is never used. `halo`: 4 * blocks * P
// floats (halo_at); `sync`: handoff_ints(blocks) ints (Handoff); `dropped_out`:
// the speculative sweeps dropped, one for each solve that met its
// tolerance before A.iters sweeps.
template <int RT, bool RHS_SMEM, bool CAVITY>
__global__ void __launch_bounds__(kCThreads, 1) rounds_slab_kernel(RoundsArgs A, int RP,
                                                                   float* halo, int* sync,
                                                                   int* dropped_out) {
    extern __shared__ __align__(16) float smem[];
    __shared__ unsigned cmax[3];  // the block's max a sweep, in rotation
    __shared__ float errsh[2];    // a sweep's grid max, by the parity of its exchange
    cg::grid_group grid = cg::this_grid();
    const Handoff H{sync};
    const int ny = A.ny, nx = A.nx, tid = threadIdx.x, P = (nx + 3) & ~3;
    const size_t buf = (size_t)(RP + 2) * P;
    float* cur = smem;
    float* other = smem + buf;
    float* rb = smem + 2 * buf;  // ar * rhs, (RP, P) (RHS_SMEM)
    Slab S{cg::this_cluster(), (int)blockIdx.x, (int)gridDim.x, RP, (int)blockIdx.x * RP, 0,
           P, nullptr, nullptr, 0};
    S.nrow = max(0, min(RP, ny - S.r0));
    const int ncell = S.nrow * nx;
    const float dt = A.scal[0], inlet = A.scal[1];
    const size_t o = (size_t)S.r0 * nx, ou = (size_t)S.r0 * (nx + 1);
    for (int q = tid; q < S.nrow * (nx + 1); q += kCThreads) A.u[ou + q] = A.us[ou + q];
    for (int q = tid; q < S.nrow * P; q += kCThreads) {
        const int r = q / P, i = q - r * P;
        float pp = 0.0f, rr = 0.0f;  // the padding columns hold 0
        if (i < nx) {
            const size_t k = o + (size_t)r * nx + i;
            A.v[k] = A.vs[k];
            A.p[k] = A.p_in[k];
            pp = A.pp0[k];
            rr = A.ar * A.rhs0[k];
        }
        row_of(S, cur, r)[i] = pp;
        row_of(S, other, r)[i] = pp;
        if (RHS_SMEM) rb[q] = rr;
    }
    // the rows beside the slab, the first solve's halo rows
    for (int q = tid; q < 2 * P; q += kCThreads) {
        const int r = q < P ? -1 : S.nrow, i = q % P, j = S.r0 + r;
        row_of(S, cur, r)[i] = (j >= 0 && j < ny && i < nx) ? A.pp0[(size_t)j * nx + i] : 0.0f;
    }
    if (tid < 3) cmax[tid] = 0u;
    if (tid < 2) *H.flag(blockIdx.x, tid) = 0;
    if (blockIdx.x == 0 && tid < 3) {
        *H.arrive(tid) = 0;
        *H.slot(tid) = 0u;
    }
    grid.sync();  // the slots, counts and flags cleared before any block's first sweep
    int dropped = 0;
    float err = slab_solve<RT, RHS_SMEM, CAVITY>(A, S, cmax, errsh, halo, H, dropped,
                                                 RHS_SMEM ? rb : A.rhs0, cur, other);
    slab_correct(A, S, grid, cur, dt);
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        cluster_divergence<RHS_SMEM>(A, S, 0, rb, dt);
        __syncthreads();  // the rhs, before another thread's sweep reads it
        err = slab_solve<RT, RHS_SMEM, CAVITY>(A, S, cmax, errsh, halo, H, dropped,
                                               RHS_SMEM ? rb : A.rhs_w, cur, other);
        slab_correct(A, S, grid, cur, dt);
    }
    for (int q = tid; q < ncell; q += kCThreads) {
        const int r = q / nx, i = q - r * nx;
        A.pp[o + q] = row_of(S, cur, r)[i];
    }
    cluster_bcs<CAVITY>(A, S, 0, other, A.in, inlet);
    if (blockIdx.x == 0 && tid == 0) {
        A.err_out[0] = err;
        A.counts[0] = rounds_run;
        A.counts[1] = S.sweep - dropped;
        *dropped_out = dropped;
    }
}

using SlabFn = void (*)(RoundsArgs, int, float*, int*, int*);

template <bool CAVITY>
SlabFn rounds_slab_instance(const GridSlabPlan& pl) {
#define CFD_RT(R)                                                      \
    case R:                                                            \
        return pl.rhs_smem ? rounds_slab_kernel<R, true, CAVITY>       \
                           : rounds_slab_kernel<R, false, CAVITY>;
    switch (pl.rt) { CFD_RT(1) CFD_RT(2) CFD_RT(3) CFD_RT(4) CFD_RT(6) }
#undef CFD_RT
    return nullptr;
}

}  // namespace

// One block per SM, all resident as the grid-wide barrier requires.
// `cavity` takes the CAVITY instance, whose lid (center, radius: lx / 2)
// runs along x.
extern "C" int cfd_rounds(const float* us, const float* vs, const float* p_in,
                          const float* pp0, const float* rhs0, const float* scal,
                          float* u, float* v, float* p, float* pp, float* pp_tmp,
                          float* rhs_w, float* slots, float* err_out, int* counts,
                          const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                          int ny, int nx, float dx, float dy, float ax, float ay,
                          float ar, float ac, int iters, float tol, int rounds,
                          float outer_tol, int parabolic, float center, float radius,
                          int cavity, void* stream) {
    RoundsArgs A{us, vs, p_in, pp0, rhs0, scal, u, v, p, pp, pp_tmp, rhs_w, slots,
                 err_out, counts, ny, nx, dx, dy, ax, ay, ar, ac, iters, tol, rounds,
                 outer_tol, mask_u_bc, mask_v_bc,
                 Inlet{parabolic, cavity ? dx : dy, center, radius}};
    const auto kern = cavity ? rounds_kernel<true> : rounds_kernel<false>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&A};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms), dim3(kThreads),
                                    args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// How many clusters of C CTAs of the cluster form the card holds at once
// for an (ny, nx) grid (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error; minus cudaErrorInvalidValue where slab_plan cannot split the grid
// over C CTAs. Sets the kernel's attributes (on the current device).
extern "C" int cfd_rounds_cluster_admit(int ny, int nx, int C, int cavity) {
    const SlabPlan pl = slab_plan(ny, nx, C);
    if (pl.rt == 0) return -(int)cudaErrorInvalidValue;
    return cluster_admit(rounds_cluster_fn(pl, cavity), C, pl.smem);
}

// The cluster form (the same arguments, then C): one cluster of C CTAs
// (kernels/cluster.py picks C). Fails (never falls back) if slab_plan
// cannot split the grid over C CTAs or the card refuses the launch.
extern "C" int cfd_rounds_cluster(const float* us, const float* vs, const float* p_in,
                                  const float* pp0, const float* rhs0, const float* scal,
                                  float* u, float* v, float* p, float* pp, float* pp_tmp,
                                  float* rhs_w, float* slots, float* err_out, int* counts,
                                  const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                                  int ny, int nx, float dx, float dy, float ax, float ay,
                                  float ar, float ac, int iters, float tol, int rounds,
                                  float outer_tol, int parabolic, float center,
                                  float radius, int cavity, int C, void* stream) {
    RoundsArgs A{us, vs, p_in, pp0, rhs0, scal, u, v, p, pp, pp_tmp, rhs_w, slots,
                 err_out, counts, ny, nx, dx, dy, ax, ay, ar, ac, iters, tol, rounds,
                 outer_tol, mask_u_bc, mask_v_bc,
                 Inlet{parabolic, cavity ? dx : dy, center, radius}};
    const SlabPlan pl = slab_plan(ny, nx, C);
    if (pl.rt == 0) return (int)cudaErrorInvalidValue;
    const ClusterFn fn = rounds_cluster_fn(pl, cavity);
    cudaError_t e = cluster_attributes(fn, C);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, C, pl.smem, &attr);
    cfg.stream = (cudaStream_t)stream;
    e = cudaLaunchKernelEx(&cfg, fn, A, pl.rp);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The slab form (the same arguments, then the card's SM count, the halo
// buffer of halo_n floats, the handoff buffer of sync_n ints and the
// dropped sweeps' int): grid_slab_plan's blocks in one cooperative
// launch (kernels/rounds.py routes here where no cluster holds the grid
// and the plan fits). Fails (never falls back) if the plan does not
// take the grid, a buffer is short or the card refuses the launch.
extern "C" int cfd_rounds_slab(const float* us, const float* vs, const float* p_in,
                               const float* pp0, const float* rhs0, const float* scal,
                               float* u, float* v, float* p, float* pp, float* pp_tmp,
                               float* rhs_w, float* slots, float* err_out, int* counts,
                               const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                               int ny, int nx, float dx, float dy, float ax, float ay,
                               float ar, float ac, int iters, float tol, int rounds,
                               float outer_tol, int parabolic, float center, float radius,
                               int cavity, int sms, float* halo, long long halo_n,
                               int* sync, int sync_n, int* dropped, void* stream) {
    RoundsArgs A{us, vs, p_in, pp0, rhs0, scal, u, v, p, pp, pp_tmp, rhs_w, slots,
                 err_out, counts, ny, nx, dx, dy, ax, ay, ar, ac, iters, tol, rounds,
                 outer_tol, mask_u_bc, mask_v_bc,
                 Inlet{parabolic, cavity ? dx : dy, center, radius}};
    const GridSlabPlan pl = grid_slab_plan(ny, nx, sms);
    if (pl.rt == 0 || halo_n < 4LL * pl.blocks * ((nx + 3) & ~3) ||
        sync_n < handoff_ints(pl.blocks))
        return (int)cudaErrorInvalidValue;
    const SlabFn fn = cavity ? rounds_slab_instance<true>(pl) : rounds_slab_instance<false>(pl);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
    if (e != cudaSuccess) return (int)e;
    int rp = pl.rp;
    void* args[] = {&A, &rp, &halo, &sync, &dropped};
    e = cudaLaunchCooperativeKernel((const void*)fn, dim3(pl.blocks), dim3(kCThreads), args,
                                    pl.smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
