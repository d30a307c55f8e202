// k damped-Jacobi sweeps on p' with folded boundary reads. Replaces
// cfd_demo_tpu/kernels/jacobi_pallas.py jacobi_fused_k (_kernel), CHANNEL
// and CAVITY flow, and, on a sharded tier's halo-extended block (CHANNEL
// only), jacobi_fused_k_shard (_kernel_shard).
//
// jacobi_fused_k (kernel 2) is temporally blocked, as the TPU kernel's
// VMEM window was: one launch runs up to kT sweeps of a tile in shared
// memory. A sweep moves 12 bytes a cell through device memory when each
// sweep is a launch (the per-sweep kernel of sweep.cuh: 26-28 us a sweep
// at 2048^2), so the call is bound by bytes, 30x over; here a launch
// reads the tile's window of p' and rhs once and writes the owned cells
// once, and the sweeps in between touch only shared memory and
// registers. Each block owns a kTY x kTX tile and loads a kT-cell halo
// around it (the window, kWY x kWX), 16 bytes a cp.async where nx is a
// multiple of 4. Sweep s is exact on the window's cells at least s + 1
// cells from its edge, so after kT sweeps the owned cells are; the folds
// are tested on global indices, so no boundary cell is ever read. The
// window is 128 columns wide: each thread keeps kR rows of 4 columns as
// float4s in registers (its p' and ar * rhs), takes E and W from the
// neighbouring lanes by shuffle and its strip's end rows from the
// previous sweep's shared buffer, and writes the next: one barrier a
// sweep. The last launch also applies the p' BCs (each ring cell copies
// an interior cell of the same tile: tiles are clamped inside the grid,
// so none is one cell high or wide) and folds the last sweep's max |delta|
// into err with an atomicMax on the float's bits. A call of k sweeps is
// ceil(k / kT) launches, the remainder last, and one memset of err.
// What bounds it now: the sweeps' instructions and the halo's redundant
// sweeps (1.31x at the chosen tile), not bytes: 0.150 ms for k = 16 at
// 2048^2 against 0.445-0.449 ms one sweep a launch, about 4.4e9 cell
// updates a second an SM counting the halo's. The tile was chosen on the
// card with `python3 -m cfd_demo_tpu_torch.kernel_times --tiles`, which
// rebuilds this file with the kJT_* macros set; ms for k = 16 at 2048^2
// on an NVIDIA H100 80GB HBM3, 700 W, by (t, thread rows, rows a thread)
// -> owned tile:
//   (4, 8, 8) 56x120 0.1617    (4, 16, 4) 56x120 0.1905   (4, 16, 8) 120x120 0.1868
//   (4, 32, 4) 120x120 0.2025  (8, 16, 4) 48x112 0.1853   (8, 16, 8) 112x112 0.1504
//   (8, 32, 4) 112x112 0.1656  (8, 8, 16) 112x112 0.1936  (16, 16, 8) 96x96 0.1613
//   (16, 32, 4) 96x96 0.1816
// t = 8 on 512 threads of 8 rows, a 128x128 window, is the constant.
//
// CAVITY is a template flag (jacobi_pallas.py:133-134, :185-187): E at
// column nx-2 folds to the cell itself instead of the outlet's 0, and the
// last launch's ring copies column nx-2 into column nx-1 and pins (0, 0)
// to 0 (the all-Neumann system's gauge). The channel instance is the
// code it was before the flag.
//
// jacobi_fused_k_shard (kernel 11) keeps the per-sweep kernels of
// sweep.cuh; see kernels/jacobi.py for the design notes.
#include "sweep.cuh"

#ifndef kJT_T
#define kJT_T 8
#endif
#ifndef kJT_BY
#define kJT_BY 16
#endif
#ifndef kJT_R
#define kJT_R 8
#endif

namespace {

constexpr int kT = kJT_T;            // sweeps a launch, and the halo
constexpr int kTBY = kJT_BY;         // thread rows; 32 x kTBY threads
constexpr int kR = kJT_R;            // rows of a thread's strip
constexpr int kWX = 128, kWY = kTBY * kR;              // the window
constexpr int kTX = kWX - 2 * kT, kTY = kWY - 2 * kT;  // the owned tile
constexpr int kTThreads = 32 * kTBY;
constexpr size_t kSmem = 2 * sizeof(float) * kWX * kWY;
static_assert(kT % 4 == 0 && kTY >= 2, "tile too small for its halo");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ float& comp(float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The tile's first owned cell along an axis of n cells: tiles of t cells,
// the last clamped inside [0, n) (it may overlap its neighbour, which
// computes the same bits for the shared cells).
__device__ __forceinline__ int tile_origin(int b, int t, int n) {
    return min(b * t, max(n - t, 0));
}

// ts <= kT sweeps of the tile from src into dst (owned cells only).
// `last`: apply the p' BCs to the owned ring cells and fold the last
// sweep's max |delta| over owned interior cells into *err (bits).
// Thread (lane, ty) holds window columns 4 lane .. 4 lane + 3 of rows
// ty kR .. ty kR + kR - 1 as float4s; E and W come from the neighbouring
// lanes by shuffle, the strip's end rows from the previous sweep's buffer.
template <bool CAVITY>
__global__ void __launch_bounds__(kTThreads) tiled_kernel(
    const float* __restrict__ src, const float* __restrict__ rhs, float* __restrict__ dst,
    float* err, int ny, int nx, int ts, int last, float ax, float ay, float ar, float ac) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float sh[33];
    float* const buf0 = smem;
    float* const buf1 = smem + kWX * kWY;
    const int lane = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + lane;
    const int ox = tile_origin(blockIdx.x, kTX, nx), oy = tile_origin(blockIdx.y, kTY, ny);
    const int wx0 = ox - kT, wy0 = oy - kT;
    const int ox1 = min(ox + kTX, nx), oy1 = min(oy + kTY, ny);

    // The window of p' into buf0 and of rhs into buf1; zeros off the grid.
    if ((nx & 3) == 0) {  // 16-byte chunks, each wholly on or off the grid
        for (int q = tid; q < kWY * (kWX / 4); q += kTThreads) {
            const int ly = q / (kWX / 4), lx = 4 * (q % (kWX / 4));
            const int gj = wy0 + ly, gi = wx0 + lx;
            float* a = buf0 + ly * kWX + lx;
            float* b = buf1 + ly * kWX + lx;
            if (gj >= 0 && gj < ny && gi >= 0 && gi < nx) {
                const size_t k = (size_t)gj * nx + gi;
                cp_async16(a, src + k);
                cp_async16(b, rhs + k);
            } else {
                *reinterpret_cast<float4*>(a) = make_float4(0.f, 0.f, 0.f, 0.f);
                *reinterpret_cast<float4*>(b) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
    } else {
        for (int q = tid; q < kWY * kWX; q += kTThreads) {
            const int ly = q / kWX, lx = q % kWX;
            const int gj = wy0 + ly, gi = wx0 + lx;
            if (gj >= 0 && gj < ny && gi >= 0 && gi < nx) {
                const size_t k = (size_t)gj * nx + gi;
                cp_async4(buf0 + q, src + k);
                cp_async4(buf1 + q, rhs + k);
            } else {
                buf0[q] = 0.0f;
                buf1[q] = 0.0f;
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const float4* b0 = reinterpret_cast<const float4*>(buf0);
    const float4* b1 = reinterpret_cast<const float4*>(buf1);
    float4 val[kR], arr[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int q = (ty * kR + r) * (kWX / 4) + lane;
        val[r] = b0[q];
        const float4 h = b1[q];  // the sweep's ar * rhs, the same bits each sweep
        arr[r] = make_float4(ar * h.x, ar * h.y, ar * h.z, ar * h.w);
    }
    __syncthreads();  // buf1 is the first sweep's output

    // The thread's four columns: interior, owned, and their folds.
    const int gi0 = wx0 + 4 * lane;
    bool col_in[4], col_own[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        col_in[q] = gi0 + q >= 1 && gi0 + q <= nx - 2;
        col_own[q] = gi0 + q >= ox && gi0 + q < ox1;
    }

    float d = 0.0f;
    for (int s = 0; s < ts; ++s) {
        const float4* cur = reinterpret_cast<const float4*>((s & 1) ? buf1 : buf0);
        float4* nxt = reinterpret_cast<float4*>((s & 1) ? buf0 : buf1);
        const bool final_sweep = last && s == ts - 1;
        // A read past the window takes the cell itself: only cells that
        // the halo leaves inexact read it.
        float4 S = (ty > 0) ? cur[(ty * kR - 1) * (kWX / 4) + lane] : val[0];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int gj = wy0 + ty * kR + r;
            float4 C = val[r];
            float4 N = (r + 1 < kR) ? val[r + 1]
                             : (ty + 1 < kTBY) ? cur[(ty * kR + r + 1) * (kWX / 4) + lane] : C;
            float Wl = __shfl_up_sync(0xffffffffu, C.w, 1);
            float Er = __shfl_down_sync(0xffffffffu, C.x, 1);
            if (lane == 0) Wl = C.x;
            if (lane == 31) Er = C.w;
            float4 E = make_float4(C.y, C.z, C.w, Er), W = make_float4(Wl, C.x, C.y, C.z);
            const bool row_in = gj >= 1 && gj <= ny - 2;
            const bool row_own = gj >= oy && gj < oy1;
            float4 out = C;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float c = comp(C, q);
                const float e = (gi0 + q == nx - 2) ? (CAVITY ? c : 0.0f) : comp(E, q);
                const float w = (gi0 + q == 1) ? c : comp(W, q);
                const float n = (gj == ny - 2) ? c : comp(N, q);
                const float sv = (gj == 1) ? c : comp(S, q);
                const float nv = ax * (e + w) + ay * (n + sv) + ac * c - comp(arr[r], q);
                if (col_in[q] && row_in) {
                    comp(out, q) = nv;
                    if (final_sweep && col_own[q] && row_own) d = pmax(d, fabsf(nv - c));
                }
            }
            S = C;
            val[r] = out;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) nxt[(ty * kR + r) * (kWX / 4) + lane] = val[r];
        __syncthreads();
    }

    // The owned cells; in the last launch the ring cells take the p' BCs
    // from the final sweep's buffer: the interior cell they copy (rows
    // first, then columns: a corner takes the diagonal cell), the outlet 0
    // (CHANNEL) or column nx-2 and the gauge cell (0, 0) 0 (CAVITY).
    const float* fin = (ts & 1) ? buf1 : buf0;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int gj = wy0 + ty * kR + r;
        if (gj < oy || gj >= oy1) continue;
        float4 o = val[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int gi = gi0 + q;
            if (last && (gi == 0 || gi == nx - 1 || gj == 0 || gj == ny - 1)) {
                float x = 0.0f;  // the outlet (Dirichlet)
                if (CAVITY || gi != nx - 1) {
                    const int ii = (gi == 0) ? 1 : (CAVITY && gi == nx - 1) ? nx - 2 : gi;
                    const int jj = (gj == 0) ? 1 : (gj == ny - 1) ? ny - 2 : gj;
                    x = fin[(jj - wy0) * kWX + (ii - wx0)];
                }
                if (CAVITY && gi == 0 && gj == 0) x = 0.0f;
                comp(o, q) = x;
            }
        }
        const size_t k = (size_t)gj * nx + gi0;
        if ((nx & 3) == 0 && col_own[0] && col_own[3]) {
            *reinterpret_cast<float4*>(dst + k) = o;
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (col_own[q]) dst[k + q] = comp(o, q);
        }
    }
    if (last) {
        d = block_max(d, sh);
        // |delta| >= 0 (or +NaN): the float order is the bits' int order.
        if (tid == 0) atomicMax(reinterpret_cast<int*>(err), __float_as_int(d));
    }
}

}  // namespace

// Kernel 2: k sweeps from pp_in into `out` (pp_in is not written),
// ping-ponging whole launches through `tmp`; err[0] gets the last
// sweep's max |delta| over the interior. `cavity` takes the CAVITY
// instance.
extern "C" int cfd_jacobi_fused_k(const float* pp_in, const float* rhs, float* out,
                                  float* tmp, float* err, int ny, int nx, int k, float ax,
                                  float ay, float ar, float ac, int cavity, void* stream) {
    if (k < 1 || ny < 3 || nx < 3) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const auto kern = cavity ? tiled_kernel<true> : tiled_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(kern,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem);
    if (e == cudaSuccess) e = cudaMemsetAsync(err, 0, sizeof(float), st);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
    const int n = (k + kT - 1) / kT;
    const float* src = pp_in;
    for (int l = 0; l < n; ++l) {
        const int ts = (l == n - 1) ? k - (n - 1) * kT : kT;
        float* dst = ((n - 1 - l) & 1) ? tmp : out;
        kern<<<grid, dim3(32, kTBY), kSmem, st>>>(src, rhs, dst, err, ny, nx, ts, l == n - 1,
                                                 ax, ay, ar, ac);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        src = dst;
    }
    return (int)cudaSuccess;
}

// Kernel 2's tile: {sweeps a launch, owned rows, owned columns, threads}.
extern "C" int cfd_jacobi_tile(int* out) {
    out[0] = kT;
    out[1] = kTY;
    out[2] = kTX;
    out[3] = kTThreads;
    return 0;
}

// Blocks of sweep.cuh's per-sweep grid: the length of a block-maxima array.
extern "C" int cfd_jacobi_partials(int ny, int nx) { return nparts(ny, nx); }

// Kernel 11 (jacobi_pallas.py jacobi_fused_k_shard, _kernel_shard): k
// damped sweeps, one a launch (sweep.cuh), and the BC pass on an (ny, nx)
// halo-extended block whose local (0, 0) is global (row_off, col_off) of
// a (gny, gnx) grid. Interior, folds
// and the BC cells are global; err counts the owned rows [own_lo, own_hi)
// and columns [own_clo, own_chi). Cells that are not global interior
// cells or BC cells (a halo beyond the grid) come out unspecified, as
// the stale halo rows do: the caller keeps the owned rows.
extern "C" int cfd_jacobi_fused_k_shard(const float* pp_in, const float* rhs, float* out,
                                        float* tmp, float* partials, float* err, int ny,
                                        int nx, int k, int row_off, int col_off, int gny,
                                        int gnx, int own_lo, int own_hi, int own_clo,
                                        int own_chi, float ax, float ay, float ar,
                                        float ac, void* stream) {
    if (k < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const Block blk{row_off, col_off, gny, gnx, own_lo, own_hi, own_clo, own_chi};
    cudaError_t e = run_sweeps_as<true>(pp_in, rhs, out, tmp, partials, ny, nx, k,
                                        ax, ay, ar, ac, st, blk);
    if (e != cudaSuccess) return (int)e;
    bc_max_kernel<true><<<1, 1024, 0, st>>>(out, ny, nx, partials, nparts(ny, nx), err,
                                            nullptr, 0, nullptr, blk);
    return (int)cudaGetLastError();
}
