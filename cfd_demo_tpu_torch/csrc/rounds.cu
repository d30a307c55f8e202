// The whole pressure projection of one scene in one launch: exact
// do-while Jacobi, corrector, up to `rounds` outer corrector rounds with an
// exact exit, then the velocity BCs (CHANNEL, UNIFORM or parabolic inlet,
// either semantics' BC masks). JS's zero warm start arrives as pp0.
// Replaces cfd_demo_tpu/kernels/rounds_pallas.py solve_correct_rounds_pallas
// (_kernel_rounds) with its in-kernel solver ensemble_pallas.make_jacobi_solve.
// See kernels/rounds.py for the design note.
//
// Two forms of the same function, the same bits and counts. A sweep of
// the rounds is a few microseconds of work, and each needs a barrier and
// a global max before the next (the exact exit).
//
// The cooperative form (rounds_kernel): a persistent cooperative kernel,
// one resident block per SM, and a grid-wide barrier (cooperative_groups
// grid.sync) wherever the next phase reads what other blocks wrote; p' is
// swept from L2. 3.7 us a sweep at 800x264 (PERF.md).
//
// The cluster form (rounds_cluster_kernel): one thread-block cluster of
// C = 16 CTAs of 1024 threads (8 where the card admits no 16) holds p' on
// chip. Each CTA owns a slab of rows, p' ping-ponged in its shared memory
// with two halo rows and, at C = 16, ar * rhs there too (C = 8 reads rhs
// from L2). A thread keeps 4 columns of a strip of rows as float4s in
// registers, takes E and W by shuffle and N and S from the strip or shared
// memory; the folds at column 0 and the outlet are kept as invariants of
// the stored values, so a row of interior cells runs no test a cell. A
// sweep ends with the CTA's max (a warp reduction, one shared atomic and
// one __syncthreads) and st.async stores into the other CTAs' shared
// memory (its max to every CTA, its edge rows to the slabs beside it) that
// complete a transaction count on the receiver's mbarrier, so a CTA waits
// for exactly the data it needs and there is no cluster-wide barrier a
// sweep. u, v and p stay in device memory (L2). What bounds it: the
// sweep's instructions on 16 SMs (about 85 a row of 4 cells, 4 rows a
// thread at 800x264) and the max's round trip through distributed shared
// memory; it takes every grid it can hold (kernels/rounds.py
// rounds_cluster_fits). `kernel_times --rounds-forms` on an NVIDIA H100
// 80GB HBM3, 700 W, 1050 sweeps: 3.28 against 3.91 ms at 800x264 and 2.50
// against 3.78 at 700x231 (PERF.md). A first version with 512 threads,
// tests a cell and a three-barrier block max took 4.39 ms at 800x264,
// versions with a cluster.sync() a sweep 5.5-7.3 ms.
//
// In both, data written inside the kernel to device memory is read with
// __ldcg (L2, bypassing the non-coherent L1).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
// err >= tol)`, folded boundary reads, p' BCs once after the loop. The
// result lands in cur; other is the ping-pong buffer.
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
            const float E = (i == nx - 2) ? 0.0f : __ldcg(cur + k + 1);
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
        if (i != nx - 1) {
            const int ii = (i == 0) ? 1 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            val = __ldcg(cur + (size_t)jj * nx + ii);
        }
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
    float err = jacobi_solve(A, c, A.rhs0, cur, other);
    correct_inplace(A, c, cur, dt);
    // Outer rounds (piso.py _outer_rounds): `it < rounds and err >= outer_tol`.
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        divergence(A, c, dt);
        err = jacobi_solve(A, c, A.rhs_w, cur, other);
        correct_inplace(A, c, cur, dt);
    }
    if (cur != A.pp) {
        for (int k = c.gtid; k < ny * nx; k += c.gthreads) A.pp[k] = __ldcg(cur + k);
    }
    // BCs (ops/bc.py). The outlet copies the corrected u[:, nx-1] before the
    // solid mask may zero it, so stage that column first.
    for (int j = c.gtid; j < ny; j += c.gthreads)
        A.rhs_w[j] = __ldcg(A.u + (size_t)j * (nx + 1) + nx - 1);
    c.grid.sync();
    FOR_CELLS(0, ny, 0, nx + 1) {
        const size_t ku = (size_t)j * (nx + 1) + i;
        float val = (i == 0) ? inlet_at(A.in, inlet, j)
                    : (i == nx) ? __ldcg(A.rhs_w + j) : __ldcg(A.u + ku);
        if (j == 0 || j == ny - 1) val = 0.0f;
        if (masked(A.mask_u_bc, ku)) val = 0.0f;
        A.u[ku] = val;
    }
    FOR_CELLS(0, ny, 0, nx) {
        const size_t k = (size_t)j * nx + i;
        if (j == 0 || masked(A.mask_v_bc, k)) A.v[k] = 0.0f;
    }
    if (c.gtid == 0) {
        A.err_out[0] = err;
        A.counts[0] = rounds_run;
        A.counts[1] = c.sweep;
    }
}


// ---------------------------------------------------------------------------
// The cluster form
// ---------------------------------------------------------------------------

constexpr int kCThreads = 1024;      // 64 registers a thread
constexpr int kMaxCluster = 16;
constexpr int kMaxCols = 1024;       // nx at most: P / 4 <= 256, so >= 4 row groups
constexpr int kSmemMax = 231424;     // dynamic shared memory a CTA at most (227 KB - 1 KB)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// The same shared address in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

// Asynchronous stores into another CTA's shared memory that complete a
// transaction count on its mbarrier (the receiver waits on that, not on
// a cluster barrier).
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
                 ::"r"(dst), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t dst, float4 v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
                 "[%0], {%1, %2, %3, %4}, [%5];"
                 ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The cluster barrier, release/acquire at cluster scope (PTX
// barrier.cluster's defaults; cg's cluster.sync() also invalidates L1).
// Every read here of what another CTA wrote to device memory goes
// through L2 (__ldcg).
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.aligned;\n"
                 "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A CTA's slab: rows [r0, r0 + nrow) of RP-row slabs, rank r owning the
// r-th (the last non-empty one may be short, later ones empty). Its two
// p' buffers are (RP + 2, P) with P = nx rounded up to 4 (columns nx..
// padding): local row lr at (lr + 1) P, rows -1 and nrow being the
// neighbours' edge rows, which they push there.
struct Slab {
    cg::cluster_group cl;
    int rank, C, RP, r0, nrow, P;
    float* slots;    // [2][kMaxCluster] by sweep parity: every CTA's max
    uint64_t* bar;   // [2] by sweep parity: slots and edge rows received
    int sweep;
};

__device__ __forceinline__ float* row_of(const Slab& S, float* b, int lr) {
    return b + (size_t)(lr + 1) * S.P;
}

// p' at global (j, i) of the buffer whose local base is b, through
// distributed shared memory when another CTA owns row j.
__device__ __forceinline__ float slab_at(Slab& S, const float* b, int j, int i) {
    const int owner = j / S.RP;
    const float* base = (owner == S.rank) ? b : S.cl.map_shared_rank(b, owner);
    return base[(size_t)(j - owner * S.RP + 1) * S.P + i];
}

// What a sweep's mbarrier phase receives: every CTA's max, and the edge
// rows of the slabs above and below.
__device__ __forceinline__ int sweep_bytes(const Slab& S, bool has_up, bool has_dn) {
    return 4 * S.C + 4 * S.P * ((has_up ? 1 : 0) + (has_dn ? 1 : 0));
}

__device__ __forceinline__ float& at4(float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// make_jacobi_solve on the slabs: the cooperative form's do-while, sweep
// and BC pass, the same arithmetic a cell. Thread t holds columns
// 4g .. 4g + 3 (g = t % (P / 4)) of RT slab rows from RT (t / (P / 4)) as
// float4s in registers; E and W come from the neighbouring lanes by
// shuffle (from shared memory where the lane or the row changes), N and S
// from the strip itself or the rows beside it in shared memory (the
// neighbours' edge rows included). Two folds are kept as invariants
// instead of tests: the outlet column holds 0 (E at nx - 2 reads 0) and
// column 0 holds column 1's value (W at 1 reads the cell); the BC pass
// restores both anyway. So a row of interior cells needs no test a cell:
// it is computed whole, its outlet and padding columns set back to 0 and
// column 0 to column 1 (|delta| there is then 0, or column 1's); only the
// rows next to the field's edge or past the slab take the tests. arr:
// ar * rhs in shared memory (RHS_SMEM, (RP, P)) or rhs in device memory
// (scaled here). Only what another thread reads is stored a sweep (the
// strip's edge rows, and the columns at a warp's edge); the strip is
// stored whole after the last. A sweep ends with the CTA's max (a warp
// reduction and one shared atomic, one __syncthreads) sent to every CTA
// and its edge rows to its neighbours with st.async, and a wait on its
// own mbarrier for theirs.
template <int RT, bool RHS_SMEM>
__device__ float cluster_solve(const RoundsArgs& A, Slab& S, unsigned* cmax, const float* arr,
                               float*& cur, float*& other) {
    const int ny = A.ny, nx = A.nx, P = S.P, n4 = P / 4, nrow = S.nrow;
    const int t = threadIdx.x, lane = t & 31, g = t % n4, lr0 = RT * (t / n4);
    const int gi0 = 4 * g;
    const bool act = t < n4 * (kCThreads / n4) && lr0 < nrow;
    const bool w_shfl = lane > 0 && g > 0, e_shfl = lane < 31 && g < n4 - 1;
    const bool shared_cols = lane == 0 || lane == 31;  // read by the next warp
    bool cin[4], zero[4];  // interior column; outlet or padding column
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        cin[q] = gi0 + q >= 1 && gi0 + q <= nx - 2;
        zero[q] = gi0 + q >= nx - 1;
    }
    // rows that take the tests: past the slab, or within 1 of the edge
    unsigned tested = 0;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const int lr = lr0 + r, j = S.r0 + lr;
        if (lr >= nrow || j <= 1 || j >= ny - 2) tested |= 1u << r;
    }
    const bool has_up = S.r0 + nrow < ny && nrow > 0, has_dn = S.r0 > 0 && nrow > 0;
    const uint32_t bar0 = smem_addr(S.bar), slots0 = smem_addr(S.slots);

    // The strip, with the two invariants, written back.
    float4 val[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (act && lr0 + r < nrow) {
            float4* at = reinterpret_cast<float4*>(row_of(S, cur, lr0 + r) + gi0);
            v = *at;
            if (g == 0) v.x = v.y;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (gi0 + q == nx - 1) at4(v, q) = 0.0f;
            *at = v;
        }
        val[r] = v;
    }
    __syncthreads();
    // The starting edge rows into the neighbours' halo rows.
    if (act && lr0 == 0 && has_dn)
        *reinterpret_cast<float4*>(row_of(S, S.cl.map_shared_rank(cur, S.rank - 1), S.RP)
                                   + gi0) = val[0];
    if (act && lr0 + RT >= nrow && lr0 <= nrow - 1 && has_up)
        *reinterpret_cast<float4*>(row_of(S, S.cl.map_shared_rank(cur, S.rank + 1), -1)
                                   + gi0) =
            *reinterpret_cast<const float4*>(row_of(S, cur, nrow - 1) + gi0);
    cluster_barrier();

    const unsigned lanes = __ballot_sync(0xffffffffu, act);
    const int bytes = sweep_bytes(S, has_up, has_dn);
    float err;
    int it = 0;
    do {
        const int par = S.sweep & 1, s3 = S.sweep % 3;
        const uint32_t bar = bar0 + 8 * par;
        // cleared a sweep ahead: its last readers are past this sweep's
        // start, its next writers past this sweep's __syncthreads
        if (t == 0) cmax[(S.sweep + 1) % 3] = 0u;
        uint32_t mbits = 0;  // max |delta| as the bits of a float >= 0 (or +NaN)
        if (act) {
            float4 Sv = *reinterpret_cast<const float4*>(row_of(S, cur, lr0 - 1) + gi0);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const int lr = lr0 + r, j = S.r0 + lr;
                float4 C = val[r];
                const float4 Nr = (r + 1 < RT)
                    ? val[r + 1 < RT ? r + 1 : r]
                    : *reinterpret_cast<const float4*>(row_of(S, cur, lr + 1) + gi0);
                // a lane whose neighbour does not hold the next columns of
                // the row takes W or E from shared memory instead
                float Wl = __shfl_up_sync(lanes, C.w, 1);
                float Er = __shfl_down_sync(lanes, C.x, 1);
                const float* crow = row_of(S, cur, lr);
                if (!w_shfl) Wl = (g > 0) ? crow[gi0 - 1] : C.x;
                if (!e_shfl) Er = (g < n4 - 1) ? crow[gi0 + 4] : C.w;
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
                // column 0 mirrors column 1, whose old value it holds: its
                // |delta| is column 1's
                if (g == 0) out.x = out.y;
                // |out - C| is 0 where nothing changed
                mbits = max(mbits, __float_as_uint(out.x - C.x) & 0x7fffffffu);
                mbits = max(mbits, __float_as_uint(out.y - C.y) & 0x7fffffffu);
                mbits = max(mbits, __float_as_uint(out.z - C.z) & 0x7fffffffu);
                mbits = max(mbits, __float_as_uint(out.w - C.w) & 0x7fffffffu);
                Sv = C;
                val[r] = out;
                if (r == 0 || r == RT - 1 || shared_cols)
                    *reinterpret_cast<float4*>(row_of(S, other, lr) + gi0) = out;
            }
            // this sweep's edge rows into the neighbours' next buffer
            if (lr0 == 0 && has_dn)
                st_async4(cluster_addr(smem_addr(row_of(S, other, S.RP) + gi0), S.rank - 1),
                          val[0], cluster_addr(bar, S.rank - 1));
            if (lr0 + RT == nrow && has_up)
                st_async4(cluster_addr(smem_addr(row_of(S, other, -1) + gi0), S.rank + 1),
                          val[RT - 1], cluster_addr(bar, S.rank + 1));
        }
        // the CTA's max, to every CTA of the cluster; the next sweep's
        // phase is armed first, as its data can only follow this max
        mbits = __reduce_max_sync(0xffffffffu, mbits);
        if (lane == 0) atomicMax(cmax + s3, mbits);
        __syncthreads();
        if (t == 0) mbar_expect(bar0 + 8 * (par ^ 1), bytes);
        if (t < S.C)
            st_async(cluster_addr(slots0 + 4 * (par * kMaxCluster + S.rank), t),
                     __uint_as_float(cmax[s3]), cluster_addr(bar, t));
        mbar_wait(bar, (S.sweep >> 1) & 1);
        ++S.sweep;
        const unsigned e = lane < S.C ? __float_as_uint(S.slots[par * kMaxCluster + lane]) : 0u;
        err = __uint_as_float(__reduce_max_sync(0xffffffffu, e));
        float* tmp = cur; cur = other; other = tmp;
        ++it;
    } while (it < A.iters && err >= A.tol);
    // the strip whole into the last sweep's buffer
    if (act) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (r != 0 && r != RT - 1 && !shared_cols && lr0 + r < nrow)
                *reinterpret_cast<float4*>(row_of(S, cur, lr0 + r) + gi0) = val[r];
    }
    cluster_barrier();  // the last sweep's rows, before the BC pass reads them
    // p' BCs, rows then columns, from interior values only.
    for (int q = t; q < nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx, j = S.r0 + r;
        if (j >= 1 && j <= ny - 2 && i >= 1 && i <= nx - 2) continue;
        float v = 0.0f;
        if (i != nx - 1) {
            const int ii = (i == 0) ? 1 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            v = slab_at(S, cur, jj, ii);
        }
        row_of(S, cur, r)[i] = v;
    }
    cluster_barrier();
    return err;
}

// ops/corrector.py in place on (u, v, p), the slab's rows, p' from the slabs.
__device__ void cluster_correct(const RoundsArgs& A, Slab& S, float* pp, float dt) {
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
        if (j >= 1) {
            const float below = (r > 0) ? row_of(S, pp, r - 1)[i] : slab_at(S, pp, j - 1, i);
            A.v[k] = __ldcg(A.v + k) - dt * (ppk - below) / A.dy;
        }
        A.p[k] = __ldcg(A.p + k) + ppk;
    }
    cluster_barrier();  // the next divergence reads the row above from the next slab
}

// ops/divergence.py on the slab's cells: ar * rhs into rb (RHS_SMEM), or
// rhs into rhs_w.
template <bool RHS_SMEM>
__device__ void cluster_divergence(const RoundsArgs& A, const Slab& S, float* rb, float dt) {
    const int ny = A.ny, nx = A.nx;
    for (int q = threadIdx.x; q < S.nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx, j = S.r0 + r;
        const size_t k = (size_t)j * nx + i;
        const size_t ku = (size_t)j * (nx + 1) + i;
        const float du = (__ldcg(A.u + ku + 1) - __ldcg(A.u + ku)) / A.dx;
        const float vN = (j + 1 < ny) ? __ldcg(A.v + k + nx) : 0.0f;
        const float dv = (vN - __ldcg(A.v + k)) / A.dy;
        const float x = (du + dv) / dt;
        if (RHS_SMEM) rb[(size_t)r * S.P + i] = A.ar * x;
        else A.rhs_w[k] = x;
    }
}

// RT: slab rows a thread; RHS_SMEM: keep ar * rhs in shared memory (the
// C = 16 layout) or read rhs from device memory (C = 8).
template <int RT, bool RHS_SMEM>
__global__ void __launch_bounds__(kCThreads, 1) rounds_cluster_kernel(RoundsArgs A, int RP) {
    extern __shared__ __align__(16) float smem[];
    __shared__ unsigned cmax[3];  // the CTA's max a sweep, in rotation
    __shared__ uint64_t bars[2];
    cg::cluster_group cl = cg::this_cluster();
    const int ny = A.ny, nx = A.nx, tid = threadIdx.x, P = (nx + 3) & ~3;
    const size_t buf = (size_t)(RP + 2) * P;
    float* cur = smem;
    float* other = smem + buf;
    float* rb = smem + 2 * buf;  // ar * rhs, (RP, P) (RHS_SMEM)
    float* slots = smem + (RHS_SMEM ? 2 * buf + (size_t)RP * P : 2 * buf);
    Slab S{cl, (int)cl.block_rank(), (int)cl.num_blocks(), RP, 0, 0, P, slots, bars, 0};
    S.r0 = S.rank * RP;
    S.nrow = max(0, min(RP, ny - S.r0));
    const int ncell = S.nrow * nx;
    const float dt = A.scal[0], inlet = A.scal[1];
    if (tid < 3) cmax[tid] = 0u;
    if (tid < 2)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + tid)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (tid == 0)  // the first sweep's phase (each sweep arms the next)
        mbar_expect(smem_addr(bars), sweep_bytes(S, S.r0 + S.nrow < ny && S.nrow > 0,
                                                 S.r0 > 0 && S.nrow > 0));
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
    float err = cluster_solve<RT, RHS_SMEM>(A, S, cmax, RHS_SMEM ? rb : A.rhs0, cur, other);
    cluster_correct(A, S, cur, dt);
    int rounds_run = 0;
    for (; rounds_run < A.rounds && err >= A.outer_tol; ++rounds_run) {
        cluster_divergence<RHS_SMEM>(A, S, rb, dt);
        __syncthreads();  // the rhs, before another thread's sweep reads it
        err = cluster_solve<RT, RHS_SMEM>(A, S, cmax, RHS_SMEM ? rb : A.rhs_w, cur, other);
        cluster_correct(A, S, cur, dt);
    }
    for (int q = tid; q < ncell; q += kCThreads) {
        const int r = q / nx, i = q - r * nx;
        A.pp[o + q] = row_of(S, cur, r)[i];
    }
    // BCs (ops/bc.py) on the slab's rows; the outlet copies the corrected
    // u[:, nx-1] before the solid mask may zero it, staged in `other`.
    for (int r = tid; r < S.nrow; r += kCThreads)
        other[r] = __ldcg(A.u + (size_t)(S.r0 + r) * (nx + 1) + nx - 1);
    __syncthreads();
    for (int q = tid; q < S.nrow * (nx + 1); q += kCThreads) {
        const int r = q / (nx + 1), i = q - r * (nx + 1), j = S.r0 + r;
        const size_t ku = ou + q;
        float x = (i == 0) ? inlet_at(A.in, inlet, j)
                  : (i == nx) ? other[r] : __ldcg(A.u + ku);
        if (j == 0 || j == ny - 1) x = 0.0f;
        if (masked(A.mask_u_bc, ku)) x = 0.0f;
        A.u[ku] = x;
    }
    for (int q = tid; q < ncell; q += kCThreads) {
        const size_t k = o + q;
        if (S.r0 + q / nx == 0 || masked(A.mask_v_bc, k)) A.v[k] = 0.0f;
    }
    if (S.rank == 0 && tid == 0) {
        A.err_out[0] = err;
        A.counts[0] = rounds_run;
        A.counts[1] = S.sweep;
    }
}

using ClusterFn = void (*)(RoundsArgs, int);

// How C CTAs split a grid: rt rows a thread (one of the kernel's RT),
// rp = row groups x rt rows a slab (0: beyond the cluster form), and the
// kernel. kernels/rounds.py cluster_plan mirrors it.
struct Plan {
    int rt, rp;
    size_t smem;
    ClusterFn fn;
};

constexpr int kStripRows[] = {1, 2, 3, 4, 6};  // the kernel's RT (6: C = 8 only)

ClusterFn cluster_kernel(int rt, bool rhs_smem) {
#define CFD_RT(R) \
    case R: return rhs_smem ? rounds_cluster_kernel<R, true> : rounds_cluster_kernel<R, false>;
    switch (rt) { CFD_RT(1) CFD_RT(2) CFD_RT(3) CFD_RT(4) CFD_RT(6) }
#undef CFD_RT
    return nullptr;
}

Plan cluster_plan(int ny, int nx, int C) {
    const Plan none{0, 0, 0, nullptr};
    if (nx > kMaxCols || ny < 1 || nx < 1) return none;
    const int n4 = (nx + 3) / 4, groups = kCThreads / n4, P = 4 * n4;
    const int need = ((ny + C - 1) / C + groups - 1) / groups;
    const bool s = C == 16;
    for (int rt : kStripRows) {
        if (rt < need) continue;
        const int rp = groups * rt;
        const size_t smem = ((2 * (size_t)(rp + 2) + (s ? rp : 0)) * P + 2 * kMaxCluster)
                            * sizeof(float);
        if (smem > (size_t)kSmemMax) return none;
        return Plan{rt, rp, smem, cluster_kernel(rt, s)};
    }
    return none;
}

cudaLaunchConfig_t cluster_config(int C, size_t smem, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kCThreads);
    cfg.dynamicSmemBytes = smem;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The cluster size the card admits for this grid: 16 if
// cudaOccupancyMaxActiveClusters admits one cluster of 16 at its shared
// memory, else 8 if the grid fits 8 CTAs and the card admits that; 0 if
// neither (or the grid is beyond the cluster form), with the CUDA error
// in *e. Sets the kernel's attributes (on the current device).
int query_cluster(int ny, int nx, cudaError_t* e) {
    *e = cudaSuccess;
    if (cluster_plan(ny, nx, 16).fn == nullptr) return 0;
    const int sizes[2] = {16, 8};
    for (int C : sizes) {
        const Plan pl = cluster_plan(ny, nx, C);
        if (pl.fn == nullptr) break;
        if (C == 16)
            *e = cudaFuncSetAttribute(pl.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (*e == cudaSuccess)  // every grid's buffers fit kSmemMax
            *e = cudaFuncSetAttribute(pl.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemMax);
        if (*e != cudaSuccess) return 0;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(C, pl.smem, &attr);
        int n = 0;
        *e = cudaOccupancyMaxActiveClusters(&n, (const void*)pl.fn, &cfg);
        if (*e != cudaSuccess) return 0;
        if (n >= 1) return C;
    }
    *e = cudaErrorLaunchOutOfResources;
    return 0;
}

// query_cluster's answers, kept per device and grid: the query is a host
// cost on every launch otherwise (the JS scene launches once a substep).
int pick_cluster(int ny, int nx, cudaError_t* e) {
    struct Entry { int dev, ny, nx, C; };
    static Entry cache[8];
    static int used = 0;
    int dev = 0;
    *e = cudaGetDevice(&dev);
    if (*e != cudaSuccess) return 0;
    for (int k = 0; k < used; ++k)
        if (cache[k].dev == dev && cache[k].ny == ny && cache[k].nx == nx) return cache[k].C;
    const int C = query_cluster(ny, nx, e);
    if (C != 0) cache[used < 8 ? used++ : (dev + ny + nx) % 8] = Entry{dev, ny, nx, C};
    return C;
}

}  // namespace

// One block per SM, all resident as the grid-wide barrier requires.
extern "C" int cfd_rounds(const float* us, const float* vs, const float* p_in,
                          const float* pp0, const float* rhs0, const float* scal,
                          float* u, float* v, float* p, float* pp, float* pp_tmp,
                          float* rhs_w, float* slots, float* err_out, int* counts,
                          const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                          int ny, int nx, float dx, float dy, float ax, float ay,
                          float ar, float ac, int iters, float tol, int rounds,
                          float outer_tol, int parabolic, float center, float radius,
                          void* stream) {
    RoundsArgs A{us, vs, p_in, pp0, rhs0, scal, u, v, p, pp, pp_tmp, rhs_w, slots,
                 err_out, counts, ny, nx, dx, dy, ax, ay, ar, ac, iters, tol, rounds,
                 outer_tol, mask_u_bc, mask_v_bc, Inlet{parabolic, dy, center, radius}};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rounds_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&A};
    e = cudaLaunchCooperativeKernel((const void*)rounds_kernel, dim3(sms), dim3(kThreads),
                                    args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The cluster form (same arguments): one cluster of 16 CTAs, or 8 where
// the card admits no 16. Fails (never falls back) if the grid is beyond
// the cluster form or the card refuses the launch.
extern "C" int cfd_rounds_cluster(const float* us, const float* vs, const float* p_in,
                                  const float* pp0, const float* rhs0, const float* scal,
                                  float* u, float* v, float* p, float* pp, float* pp_tmp,
                                  float* rhs_w, float* slots, float* err_out, int* counts,
                                  const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                                  int ny, int nx, float dx, float dy, float ax, float ay,
                                  float ar, float ac, int iters, float tol, int rounds,
                                  float outer_tol, int parabolic, float center,
                                  float radius, void* stream) {
    RoundsArgs A{us, vs, p_in, pp0, rhs0, scal, u, v, p, pp, pp_tmp, rhs_w, slots,
                 err_out, counts, ny, nx, dx, dy, ax, ay, ar, ac, iters, tol, rounds,
                 outer_tol, mask_u_bc, mask_v_bc, Inlet{parabolic, dy, center, radius}};
    if (cluster_plan(ny, nx, 16).fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    const int C = pick_cluster(ny, nx, &e);
    if (C == 0) return (int)e;
    const Plan pl = cluster_plan(ny, nx, C);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(C, pl.smem, &attr);
    cfg.stream = (cudaStream_t)stream;
    e = cudaLaunchKernelEx(&cfg, pl.fn, A, pl.rp);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The cluster size cfd_rounds_cluster launches for this grid (16 or 8),
// or minus the CUDA error if it would fail.
extern "C" int cfd_rounds_cluster_size(int ny, int nx) {
    if (cluster_plan(ny, nx, 16).fn == nullptr) return -(int)cudaErrorInvalidValue;
    cudaError_t e;
    const int C = pick_cluster(ny, nx, &e);
    return C ? C : -(int)e;
}
