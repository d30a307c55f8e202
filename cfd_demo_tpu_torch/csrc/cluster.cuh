// The thread-block-cluster machinery of the kernels that keep a scene's
// p' on chip: the rounds kernel's cluster form (rounds.cu), the batched
// Jacobi solve's (jacobi_batch.cu) and the whole-substep ensemble
// kernel's (ensemble.cu).
//
// One cluster of C CTAs of 1024 threads holds one scene. Each CTA owns a
// slab of rows, p' ping-ponged in its shared memory with two halo rows
// and, where it fits, ar * rhs there too (else rhs is read from L2). A
// thread keeps 4 columns of a strip of rows as float4s in registers,
// takes E and W by shuffle and N and S from the strip or shared memory;
// the folds at column 0 and the outlet are kept as invariants of the
// stored values, so a row of interior cells runs no test a cell. A sweep
// (or an SOR half) ends with the CTA's max (a warp reduction, one shared
// atomic and one __syncthreads) and st.async stores into the other CTAs'
// shared memory (its max to every CTA, its edge rows to the slabs beside
// it) that complete a transaction count on the receiver's mbarrier, so a
// CTA waits for exactly the data it needs and there is no cluster-wide
// barrier a sweep. u, v, p and the divergence stay in device memory
// (L2); data written there inside a kernel is read with __ldcg.
//
// Every piece takes the kernel's own argument struct A (read from the
// parameter bank, not copied into registers) and one scene: the fields
// u (ny, nx+1), v, p and the divergence rhs_w (ny, nx) of scene `scene`
// of A's batch (0 for one scene). A batch launches B clusters, the
// cluster's index blockIdx.x / C being the scene's.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

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
// padding): local row lr at (lr + 1) P, rows -1 and RP being the
// neighbours' edge rows, which they push there.
struct Slab {
    cg::cluster_group cl;
    int rank, C, RP, r0, nrow, P;
    float* slots;    // [2][kMaxCluster] by sweep parity: every CTA's max
    uint64_t* bar;   // [2] by sweep parity: slots and edge rows received
    int sweep;       // exchanges so far (sweeps, or SOR halves): the mbarrier phase
};

__device__ __forceinline__ float* row_of(const Slab& S, float* b, int lr) {
    return b + (size_t)(lr + 1) * S.P;
}

__device__ __forceinline__ const float* row_of(const Slab& S, const float* b, int lr) {
    return b + (size_t)(lr + 1) * S.P;
}

// p' at global (j, i) of the buffer whose local base is b, through
// distributed shared memory when another CTA owns row j.
__device__ __forceinline__ float slab_at(Slab& S, const float* b, int j, int i) {
    const int owner = j / S.RP;
    const float* base = (owner == S.rank) ? b : S.cl.map_shared_rank(b, owner);
    return base[(size_t)(j - owner * S.RP + 1) * S.P + i];
}

// What an exchange's mbarrier phase receives: every CTA's max, and the
// edge rows of the slabs above and below.
__device__ __forceinline__ int sweep_bytes(const Slab& S, bool has_up, bool has_dn) {
    return 4 * S.C + 4 * S.P * ((has_up ? 1 : 0) + (has_dn ? 1 : 0));
}

__device__ __forceinline__ float& at4(float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The shared-memory layout of a slab of RP rows: the two p' buffers,
// ar * rhs (RHS_SMEM, (RP, P)) and the maxima's slots.
struct SlabSmem {
    float* cur;
    float* other;
    float* rb;
};

// Slab S of CTA cl.block_rank() over an (ny, nx) grid cut into RP-row
// slabs in `smem`; initialises the CTA's maxima and mbarriers and arms
// the first exchange's phase. The caller loads the slab and then calls
// cluster_barrier() before any CTA sends.
__device__ __forceinline__ Slab slab_setup(cg::cluster_group cl, int ny, int nx, int RP, bool rhs_smem,
                           float* smem, unsigned* cmax, uint64_t* bars, SlabSmem& M) {
    const int P = (nx + 3) & ~3, tid = threadIdx.x;
    const size_t buf = (size_t)(RP + 2) * P;
    M.cur = smem;
    M.other = smem + buf;
    M.rb = smem + 2 * buf;
    float* slots = smem + (rhs_smem ? 2 * buf + (size_t)RP * P : 2 * buf);
    Slab S{cl, (int)cl.block_rank(), (int)cl.num_blocks(), RP, 0, 0, P, slots, bars, 0};
    S.r0 = S.rank * RP;
    S.nrow = max(0, min(RP, ny - S.r0));
    if (tid < 3) cmax[tid] = 0u;
    if (tid < 2)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + tid)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (tid == 0)  // the first exchange's phase (each exchange arms the next)
        mbar_expect(smem_addr(bars), sweep_bytes(S, S.r0 + S.nrow < ny && S.nrow > 0,
                                                 S.r0 > 0 && S.nrow > 0));
    return S;
}

// make_jacobi_solve (SOR false) or make_sor_solve (SOR true) of
// ensemble_pallas.py on the slabs, with A's ny, nx, iters, tol and
// multipliers (Jacobi: ax, ay, ar, ac of jacobi_pallas.py:87-94; SOR: bx,
// by, br, 1 - omega of ensemble_pallas.py:174-179 as ax, ay, ar, ac, and
// om = omega): the do-while `it == 0 or (it < iters and err >= tol)`
// (MASKED: the masked loop's exit, ops/poisson.py _sweep_loop's `done |=
// err < tol`, under which a NaN error sweeps on), the folded boundary
// reads, then the p' BCs once, rows then columns, from interior values
// only; the result lands in cur, other is the ping-pong buffer.
// CAVITY (Jacobi only; the rounds kernel's cavity instances): E at
// column nx-2 reads the cell itself (jacobi_pallas.py:133-134), and the
// BCs copy column nx-2 into column nx-1 and pin (0, 0) to 0.
// Thread t holds columns 4g .. 4g + 3 (g = t % (P / 4)) of RT slab rows
// from RT (t / (P / 4)) as float4s in registers; E and W come from the
// neighbouring lanes by shuffle (from shared memory where the lane or the
// row changes), N and S from the strip itself or the rows beside it in
// shared memory (the neighbours' edge rows included). A slab holds whole
// row groups (the plans make RP a multiple of RT), so no strip crosses
// into the halo row. Two folds are kept as invariants instead of tests:
// the outlet column holds 0 (E at nx - 2 reads 0) and column 0 holds
// column 1's value (W at 1 reads the cell); the BC pass restores both
// anyway. In CAVITY, where columns nx-2 and nx-1 share a float4 ((nx-1)
// % 4 != 0), column nx-1 holds column nx-2's value, one lane copy after
// each sweep, so E at nx - 2 reads the cell with no test; where column
// nx-1 is the next thread's .x it keeps the outlet's 0 and the thread
// holding nx-2 as .w takes its own .w for E (one select a row). So a row of interior cells needs no test a cell: it is computed
// whole, its outlet and padding columns set back to 0 and column 0 to
// column 1 (|delta| there is then 0, or column 1's); only the rows next
// to the field's edge or past the slab take the tests. arr: ar * rhs in
// shared memory (RHS_SMEM, (RP, P)) or rhs in device memory (scaled
// here). Only what another thread reads is stored an exchange (the
// strip's edge rows, and the columns at a warp's edge); the strip is
// stored whole after the last. An exchange (a Jacobi sweep, or an SOR
// half) ends with the CTA's max (a warp reduction and one shared atomic,
// one __syncthreads) sent to every CTA and its edge rows to its
// neighbours with st.async, and a wait on its own mbarrier for theirs.
//
// SOR: each iteration is a red half (colour 0: (j + i) even) then a black
// half, each an exchange that updates its colour's cells and passes the
// other colour through. A half reads only the other colour, which no
// thread changes in the half, so with the strip in registers and `other`
// as the next buffer it is the in-place half of ensemble.cu's block form;
// column 0, column 1's mirror, is rewritten in the half that updates
// column 1. err is the max over both halves of each cell's |change| at
// its own update. Every exchange carries every CTA's max, so no CTA runs
// more than one exchange ahead of another, as the mbarrier phases need.
template <int RT, bool RHS_SMEM, bool SOR, bool MASKED, bool CAVITY = false, typename Args>
__device__ float cluster_solve(const Args& A, Slab& S, unsigned* cmax, const float* arr,
                               float*& cur, float*& other) {
    const int ny = A.ny, nx = A.nx, P = S.P, n4 = P / 4, nrow = S.nrow;
    const int t = threadIdx.x, lane = t & 31, g = t % n4, lr0 = RT * (t / n4);
    const int gi0 = 4 * g;
    const bool act = t < n4 * (kCThreads / n4) && lr0 < nrow;
    const bool w_shfl = lane > 0 && g > 0, e_shfl = lane < 31 && g < n4 - 1;
    const bool shared_cols = lane == 0 || lane == 31;  // read by the next warp
    bool cin[4], zero[4];  // interior column; outlet or padding column
    bool mir[4];           // CAVITY: column nx-1 mirroring nx-2 in this float4
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        cin[q] = gi0 + q >= 1 && gi0 + q <= nx - 2;
        mir[q] = CAVITY && q > 0 && gi0 + q == nx - 1;
        zero[q] = CAVITY ? gi0 + q >= nx || (q == 0 && gi0 == nx - 1) : gi0 + q >= nx - 1;
    }
    const bool e_self = CAVITY && gi0 + 3 == nx - 2;  // E of .w is column nx-1's 0
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
            for (int q = 0; q < 4; ++q) {
                if (CAVITY ? zero[q] : gi0 + q == nx - 1) at4(v, q) = 0.0f;
                if (mir[q]) at4(v, q) = at4(v, q - 1);
            }
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
    bool more;
    do {
        uint32_t ebits = 0;
#pragma unroll
        for (int colour = 0; colour < (SOR ? 2 : 1); ++colour) {
            const int par = S.sweep & 1, s3 = S.sweep % 3;
            const uint32_t bar = bar0 + 8 * par;
            // cleared an exchange ahead: its last readers are past this
            // exchange's start, its next writers past its __syncthreads
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
                    // a lane whose neighbour does not hold the next columns
                    // of the row takes W or E from shared memory instead
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
                    // an SOR half's columns: (j + i) % 2 == colour, gi0 even
                    const int q0 = SOR ? ((j ^ colour) & 1) : 0;
                    float4 out;
                    if (!(tested & (1u << r))) {
                        if constexpr (SOR) {
                            float4 nv;
                            nv.x = A.ac * C.x + A.om * (A.ax * (Wl + C.y) + A.ay * (Nr.x + Sv.x) - R.x);
                            nv.y = A.ac * C.y + A.om * (A.ax * (C.x + C.z) + A.ay * (Nr.y + Sv.y) - R.y);
                            nv.z = A.ac * C.z + A.om * (A.ax * (C.y + C.w) + A.ay * (Nr.z + Sv.z) - R.z);
                            nv.w = A.ac * C.w + A.om * (A.ax * (C.z + Er) + A.ay * (Nr.w + Sv.w) - R.w);
                            out = q0 ? make_float4(C.x, nv.y, C.z, nv.w)
                                     : make_float4(nv.x, C.y, nv.z, C.w);
                        } else {
                            out.x = A.ax * (Wl + C.y) + A.ay * (Nr.x + Sv.x) + A.ac * C.x - R.x;
                            out.y = A.ax * (C.x + C.z) + A.ay * (Nr.y + Sv.y) + A.ac * C.y - R.y;
                            out.z = A.ax * (C.y + C.w) + A.ay * (Nr.z + Sv.z) + A.ac * C.z - R.z;
                            out.w = A.ax * (C.z + Er) + A.ay * (Nr.w + Sv.w) + A.ac * C.w - R.w;
                        }
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
                        if constexpr (SOR) {
                            nv.x = A.ac * C.x + A.om * (A.ax * (Wl + C.y) + A.ay * (N.x + So.x) - R.x);
                            nv.y = A.ac * C.y + A.om * (A.ax * (C.x + C.z) + A.ay * (N.y + So.y) - R.y);
                            nv.z = A.ac * C.z + A.om * (A.ax * (C.y + C.w) + A.ay * (N.z + So.z) - R.z);
                            nv.w = A.ac * C.w + A.om * (A.ax * (C.z + Er) + A.ay * (N.w + So.w) - R.w);
                        } else {
                            nv.x = A.ax * (Wl + C.y) + A.ay * (N.x + So.x) + A.ac * C.x - R.x;
                            nv.y = A.ax * (C.x + C.z) + A.ay * (N.y + So.y) + A.ac * C.y - R.y;
                            nv.z = A.ax * (C.y + C.w) + A.ay * (N.z + So.z) + A.ac * C.z - R.z;
                            nv.w = A.ax * (C.z + Er) + A.ay * (N.w + So.w) + A.ac * C.w - R.w;
                        }
                        const bool row_in = lr < nrow && j >= 1 && j <= ny - 2;
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            at4(out, q) = (row_in && cin[q] && (!SOR || (q & 1) == q0))
                                              ? at4(nv, q) : at4(C, q);
                    }
                    // column 0 mirrors column 1, whose old value it holds:
                    // its |delta| is column 1's (CAVITY: and column nx-1
                    // column nx-2's)
                    if (g == 0) out.x = out.y;
                    if constexpr (CAVITY) {
#pragma unroll
                        for (int q = 1; q < 4; ++q)
                            if (mir[q]) at4(out, q) = at4(out, q - 1);
                    }
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
                // this exchange's edge rows into the neighbours' next buffer
                if (lr0 == 0 && has_dn)
                    st_async4(cluster_addr(smem_addr(row_of(S, other, S.RP) + gi0), S.rank - 1),
                              val[0], cluster_addr(bar, S.rank - 1));
                if (lr0 + RT == nrow && has_up)
                    st_async4(cluster_addr(smem_addr(row_of(S, other, -1) + gi0), S.rank + 1),
                              val[RT - 1], cluster_addr(bar, S.rank + 1));
            }
            // the CTA's max, to every CTA of the cluster; the next
            // exchange's phase is armed first, as its data can only follow
            // this max
            mbits = __reduce_max_sync(0xffffffffu, mbits);
            if (lane == 0) atomicMax(cmax + s3, mbits);
            __syncthreads();
            if (t == 0) mbar_expect(bar0 + 8 * (par ^ 1), bytes);
            if (t < S.C)
                st_async(cluster_addr(slots0 + 4 * (par * kMaxCluster + S.rank), t),
                         __uint_as_float(cmax[s3]), cluster_addr(bar, t));
            mbar_wait(bar, (S.sweep >> 1) & 1);
            ++S.sweep;
            const unsigned e =
                lane < S.C ? __float_as_uint(S.slots[par * kMaxCluster + lane]) : 0u;
            ebits = max(ebits, __reduce_max_sync(0xffffffffu, e));
            float* tmp = cur; cur = other; other = tmp;
        }
        err = __uint_as_float(ebits);
        ++it;
        more = it < A.iters && (MASKED ? !(err < A.tol) : err >= A.tol);
    } while (more);
    // the strip whole into the last exchange's buffer
    if (act) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (r != 0 && r != RT - 1 && !shared_cols && lr0 + r < nrow)
                *reinterpret_cast<float4*>(row_of(S, cur, lr0 + r) + gi0) = val[r];
    }
    cluster_barrier();  // the last exchange's rows, before the BC pass reads them
    // p' BCs, rows then columns, from interior values only (CAVITY: the
    // right column from column nx-2, then the gauge cell (0, 0) 0).
    for (int q = t; q < nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx, j = S.r0 + r;
        if (j >= 1 && j <= ny - 2 && i >= 1 && i <= nx - 2) continue;
        float v = 0.0f;
        if (CAVITY || i != nx - 1) {
            const int ii = (i == 0) ? 1 : (CAVITY && i == nx - 1) ? nx - 2 : i;
            const int jj = (j == 0) ? 1 : (j == ny - 1) ? ny - 2 : j;
            v = slab_at(S, cur, jj, ii);
        }
        if (CAVITY && i == 0 && j == 0) v = 0.0f;
        row_of(S, cur, r)[i] = v;
    }
    cluster_barrier();
    return err;
}

// ops/corrector.py in place on scene `scene`'s (u, v, p), the slab's rows,
// p' from the slabs.
template <typename Args>
__device__ void cluster_correct(const Args& A, Slab& S, int scene, const float* pp, float dt) {
    const int ny = A.ny, nx = A.nx;
    float* u = A.u + (size_t)scene * ny * (nx + 1);
    float* v = A.v + (size_t)scene * ny * nx;
    float* p = A.p + (size_t)scene * ny * nx;
    for (int q = threadIdx.x; q < S.nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx, j = S.r0 + r;
        const float* row = row_of(S, pp, r);
        const float ppk = row[i];
        if (i >= 1) {
            const size_t ku = (size_t)j * (nx + 1) + i;
            u[ku] = __ldcg(u + ku) - dt * (ppk - row[i - 1]) / A.dx;
        }
        const size_t k = (size_t)j * nx + i;
        if (j >= 1) {
            const float below = (r > 0) ? row_of(S, pp, r - 1)[i] : slab_at(S, pp, j - 1, i);
            v[k] = __ldcg(v + k) - dt * (ppk - below) / A.dy;
        }
        p[k] = __ldcg(p + k) + ppk;
    }
    cluster_barrier();  // the next divergence reads the row above from the next slab
}

// ops/divergence.py on the slab's cells of scene `scene`: ar * rhs into
// rb (RHS_SMEM), or rhs into the scene's rhs_w.
template <bool RHS_SMEM, typename Args>
__device__ void cluster_divergence(const Args& A, const Slab& S, int scene, float* rb, float dt) {
    const int ny = A.ny, nx = A.nx;
    const float* u = A.u + (size_t)scene * ny * (nx + 1);
    const float* v = A.v + (size_t)scene * ny * nx;
    for (int q = threadIdx.x; q < S.nrow * nx; q += kCThreads) {
        const int r = q / nx, i = q - r * nx, j = S.r0 + r;
        const size_t k = (size_t)j * nx + i;
        const size_t ku = (size_t)j * (nx + 1) + i;
        const float du = (__ldcg(u + ku + 1) - __ldcg(u + ku)) / A.dx;
        const float vN = (j + 1 < ny) ? __ldcg(v + k + nx) : 0.0f;
        const float dv = (vN - __ldcg(v + k)) / A.dy;
        const float x = (du + dv) / dt;
        if (RHS_SMEM) rb[(size_t)r * S.P + i] = A.ar * x;
        else A.rhs_w[(size_t)scene * ny * nx + k] = x;
    }
}

// The velocity BCs (ops/bc.py) on the slab's rows of scene `scene`: the
// inlet (UNIFORM, or a parabola), the outlet copying the corrected
// u[:, nx-1] (staged in `stage` before the solid mask may zero it), the
// walls, A's BC masks (one for every scene). CAVITY: the lid (`in` holds
// the lid's profile, lid_at), the floor and the side walls.
template <bool CAVITY = false, typename Args>
__device__ void cluster_bcs(const Args& A, const Slab& S, int scene, float* stage,
                            const Inlet& in, float inlet) {
    const int ny = A.ny, nx = A.nx, tid = threadIdx.x;
    float* u = A.u + (size_t)scene * ny * (nx + 1);
    float* v = A.v + (size_t)scene * ny * nx;
    const size_t o = (size_t)S.r0 * nx, ou = (size_t)S.r0 * (nx + 1);
    if constexpr (!CAVITY) {
        for (int r = tid; r < S.nrow; r += kCThreads)
            stage[r] = __ldcg(u + (size_t)(S.r0 + r) * (nx + 1) + nx - 1);
        __syncthreads();
    }
    for (int q = tid; q < S.nrow * (nx + 1); q += kCThreads) {
        const int r = q / (nx + 1), i = q - r * (nx + 1), j = S.r0 + r;
        const size_t ku = ou + q;
        float x;
        if constexpr (CAVITY) {
            x = (j == ny - 1) ? lid_at(in, inlet, i) : __ldcg(u + ku);
            if (j == 0 || i == 0 || i == nx) x = 0.0f;
        } else {
            x = (i == 0) ? inlet_at(in, inlet, j) : (i == nx) ? stage[r] : __ldcg(u + ku);
            if (j == 0 || j == ny - 1) x = 0.0f;
        }
        if (masked(A.mask_u_bc, ku)) x = 0.0f;
        u[ku] = x;
    }
    for (int q = tid; q < S.nrow * nx; q += kCThreads) {
        const size_t k = o + q;
        const int i = q % nx;
        if (S.r0 + q / nx == 0 || (CAVITY && (i == 0 || i == nx - 1)) ||
            masked(A.mask_v_bc, k))
            v[k] = 0.0f;
    }
}

// ---------------------------------------------------------------------------
// Host side: the batched kernels' slab plan and cluster launches
// ---------------------------------------------------------------------------

// Rows a thread, the cluster kernels' RT.
constexpr int kSlabStrips[] = {1, 2, 3, 4, 6};

// How C CTAs split an (ny, nx) scene in the cluster kernels: rt rows a
// thread, the first of kSlabStrips whose row groups (1024 threads of 4
// columns) cover ceil(ny / C) rows; slabs of rp rows, that rounded up to
// whole strips, so no strip crosses a slab's edge; ar * rhs in shared
// memory where it fits (rhs_smem); rt = 0 where the scene is beyond the
// cluster form at C. The last slabs may be short or, where rp rounds up,
// empty. kernels/cluster.py slab_plan mirrors it.
struct SlabPlan {
    int rt, rp;
    bool rhs_smem;
    size_t smem;
};

inline SlabPlan slab_plan(int ny, int nx, int C) {
    const SlabPlan none{0, 0, false, 0};
    if (nx > kMaxCols || ny < 3 || nx < 3 || C < 1 || C > kMaxCluster) return none;
    const int n4 = (nx + 3) / 4, groups = kCThreads / n4, P = 4 * n4;
    const int rows = (ny + C - 1) / C, need = (rows + groups - 1) / groups;
    for (int rt : kSlabStrips) {
        if (rt < need) continue;
        const int rp = rt * ((rows + rt - 1) / rt);
        const size_t base = (2 * (size_t)(rp + 2) * P + 2 * kMaxCluster) * sizeof(float);
        if (base > (size_t)kSmemMax) return none;
        const size_t with_rhs = base + (size_t)rp * P * sizeof(float);
        const bool s = with_rhs <= (size_t)kSmemMax;
        return SlabPlan{rt, rp, s, s ? with_rhs : base};
    }
    return none;
}

// A launch of `clusters` clusters of C CTAs of kCThreads threads.
inline cudaLaunchConfig_t cluster_config(int clusters, int C, size_t smem,
                                         cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * C);
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

// Sets a cluster kernel's attributes for C CTAs (on the current device):
// clusters of more than 8 are non-portable; every plan's buffers fit
// kSmemMax.
template <typename Fn>
cudaError_t cluster_attributes(Fn fn, int C) {
    cudaError_t e = cudaSuccess;
    if (C > 8) e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    return e;
}

// How many clusters of C CTAs of `fn` at `smem` the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <typename Fn>
int cluster_admit(Fn fn, int C, size_t smem) {
    cudaError_t e = cluster_attributes(fn, C);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(1, C, smem, &attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
    return e == cudaSuccess ? n : -(int)e;
}

}  // namespace
