// Fused predictor + divergence. Replaces
// cfd_demo_tpu/kernels/substep_pallas.py predict_div_pallas (_kernel_pre);
// the math is ops/predictor.py `predict` followed by ops/divergence.py
// `divergence_rhs`, for each scheme (FIRST, SECOND, QUICK) and semantics
// (Rust's unaveraged or JS's averaged convecting v), on the whole field or
// on a row block of a sharded one at a global row offset. See
// kernels/substep.py for the design note.
#include "predict.cuh"

namespace {

// The tiled form's tile: kTY rows by kTX columns of cells a CTA of
// kPThreads threads (kernels/substep.py PREDICT_TILE mirrors these). With
// 31 x 32 each thread takes at most 4 of the tile's 31 x 33 u faces,
// 32 x 32 v faces and 31 x 32 cells. `kernel_times --substep-forms`
// rebuilds this file with the kPD_* macros set to time other tiles.
#ifndef kPD_TY
#define kPD_TY 31
#endif
#ifndef kPD_TX
#define kPD_TX 32
#endif
constexpr int kTY = kPD_TY, kTX = kPD_TX, kPThreads = 256;

__host__ __device__ constexpr int steps(int n) { return (n + kPThreads - 1) / kPThreads; }

// The shared-memory windows of u and v: the tile's faces and a halo of
// H cells, the scheme's reach (1 for FIRST, 2 for SECOND and QUICK); and
// the predictor masks over the tile's faces.
template <int H>
struct Win {
    static constexpr int UW = kTX + 1 + 2 * H, UR = kTY + 2 * H;  // u: cols, rows
    static constexpr int VW = kTX + 2 * H, VR = kTY + 1 + 2 * H;  // v
    static constexpr int NU = UR * UW, NV = VR * VW;
    static constexpr int NMU = kTY * (kTX + 1), NMV = (kTY + 1) * kTX;  // the faces
};

// Reads of the windows, which were zero-filled outside the arrays as `ld`
// reads: (j, i) are block-local, (j0, i0) the windows' first row and
// column, (r0, c0) the tile's. GENERIC: the tile is one of the plan's
// interior tiles.
template <int H, bool GENERIC>
struct TileLd {
    static constexpr bool kGeneric = GENERIC;
    const float* su;
    const float* sv;
    const uint8_t* smu;
    const uint8_t* smv;
    int j0, i0;
    __device__ __forceinline__ float U(int j, int i) const {
        return su[(j - j0) * Win<H>::UW + (i - i0)];
    }
    __device__ __forceinline__ float V(int j, int i) const {
        return sv[(j - j0) * Win<H>::VW + (i - i0)];
    }
    __device__ __forceinline__ bool MU(int j, int, int i) const {
        return smu[(j - j0 - H) * (kTX + 1) + (i - i0 - H)] != 0;
    }
    __device__ __forceinline__ bool MV(int j, int, int i) const {
        return smv[(j - j0 - H) * kTX + (i - i0 - H)] != 0;
    }
    __device__ __forceinline__ static float div(float x, float y) { return div_rn(x, y); }
};

// One tile: stage u over (kTY + 2H) x (kTX + 1 + 2H), v over
// (kTY + 1 + 2H) x (kTX + 2H) and the masks over the tile's faces in
// shared memory (every load of a thread issued before the first store);
// compute the tile's kTY x (kTX + 1) u* faces and (kTY + 1) x kTX v*
// faces once each, into shared memory, writing the owned ones out; then
// rhs from shared memory in ops/divergence.py's order of operations.
// An interior tile (GENERIC) loads with no bounds tests and its faces
// take no row or column test: the plan gives it only where none could
// fire.
template <int S, bool AVG, bool GENERIC>
__device__ __forceinline__ void tile_body(const PredArgs& A, float* su, float* sv,
                                          uint8_t* smu, uint8_t* smv, float* sus,
                                          float* svs) {
    constexpr int H = (S == FIRST) ? 1 : 2;
    using W = Win<H>;
    const int ny = A.ny, nx = A.nx, wu = nx + 1, gny = A.gny, tid = threadIdx.x;
    const int r0 = blockIdx.y * kTY, c0 = blockIdx.x * kTX;
    const int j0 = r0 - H, i0 = c0 - H;
    float ru[steps(W::NU)], rv[steps(W::NV)];
    uint8_t rmu[steps(W::NMU)], rmv[steps(W::NMV)];
#pragma unroll
    for (int k = 0; k < steps(W::NU); ++k) {
        const int q = tid + k * kPThreads, r = q / W::UW, c = q - r * W::UW;
        ru[k] = (q >= W::NU) ? 0.0f
                : GENERIC    ? __ldg(A.u + (size_t)(j0 + r) * wu + (i0 + c))
                             : ld(A.u, ny, wu, j0 + r, i0 + c);
    }
#pragma unroll
    for (int k = 0; k < steps(W::NV); ++k) {
        const int q = tid + k * kPThreads, r = q / W::VW, c = q - r * W::VW;
        rv[k] = (q >= W::NV) ? 0.0f
                : GENERIC    ? __ldg(A.v + (size_t)(j0 + r) * nx + (i0 + c))
                             : ld(A.v, ny, nx, j0 + r, i0 + c);
    }
    // The masks hold the whole grid: faces past it (halo rows) or past
    // the array read 0; no face that reads its mask lies there.
#pragma unroll
    for (int k = 0; k < steps(W::NMU); ++k) {
        const int q = tid + k * kPThreads, r = q / (kTX + 1), c = q - r * (kTX + 1);
        const int gj = r0 + r + A.row_off, i = c0 + c;
        rmu[k] = (q < W::NMU && A.mask_u != nullptr &&
                  (GENERIC || (gj >= 0 && gj < gny && i <= nx)))
                     ? __ldg(A.mask_u + (size_t)gj * wu + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < steps(W::NMV); ++k) {
        const int q = tid + k * kPThreads, r = q / kTX, c = q - r * kTX;
        const int gj = r0 + r + A.row_off, i = c0 + c;
        rmv[k] = (q < W::NMV && A.mask_v != nullptr &&
                  (GENERIC || (gj >= 0 && gj < gny && i < nx)))
                     ? __ldg(A.mask_v + (size_t)gj * nx + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < steps(W::NU); ++k)
        if (tid + k * kPThreads < W::NU) su[tid + k * kPThreads] = ru[k];
#pragma unroll
    for (int k = 0; k < steps(W::NV); ++k)
        if (tid + k * kPThreads < W::NV) sv[tid + k * kPThreads] = rv[k];
#pragma unroll
    for (int k = 0; k < steps(W::NMU); ++k)
        if (tid + k * kPThreads < W::NMU) smu[tid + k * kPThreads] = rmu[k];
#pragma unroll
    for (int k = 0; k < steps(W::NMV); ++k)
        if (tid + k * kPThreads < W::NMV) smv[tid + k * kPThreads] = rmv[k];
    __syncthreads();
    const TileLd<H, GENERIC> L{su, sv, smu, smv, j0, i0};
    const float dt = A.scal[0], nu = A.scal[1];
    // u faces (r0 + r, c0 + c), c in [0, kTX]: the tile owns c < kTX, and
    // the last tile also the outlet face i = nx.
    for (int k = 0; k < steps(W::NMU); ++k) {
        const int q = tid + k * kPThreads, r = q / (kTX + 1), c = q - r * (kTX + 1);
        const int j = r0 + r, i = c0 + c;
        if (q >= W::NMU) break;
        float val = 0.0f;
        if (GENERIC || (j < ny && i <= nx)) {
            val = ustar_at<S, AVG>(A, L, dt, nu, j, i);
            if (c < kTX || (!GENERIC && i == nx)) A.u_star[(size_t)j * wu + i] = val;
        }
        sus[q] = val;
    }
    // v faces (r0 + r, c0 + c), r in [0, kTY]: the tile owns r < kTY; row
    // kTY is the next tile's first (or v's implicit zero row j = ny).
    for (int k = 0; k < steps(W::NMV); ++k) {
        const int q = tid + k * kPThreads, r = q / kTX, c = q - r * kTX;
        const int j = r0 + r, i = c0 + c;
        if (q >= W::NMV) break;
        float val = 0.0f;
        if (GENERIC || i < nx) {
            val = vstar_at<S>(A, L, dt, nu, j, i);
            if (r < kTY && (GENERIC || j < ny)) A.v_star[(size_t)j * nx + i] = val;
        }
        svs[q] = val;
    }
    __syncthreads();
    for (int k = 0; k < steps(kTY * kTX); ++k) {
        const int q = tid + k * kPThreads, r = q / kTX, c = q - r * kTX;
        const int j = r0 + r, i = c0 + c;
        if (q >= kTY * kTX) break;
        if (GENERIC || (j < ny && i < nx)) {
            const float us = sus[r * (kTX + 1) + c], vs = svs[r * kTX + c];
            const float du = div_rn(sus[r * (kTX + 1) + c + 1] - us, A.dx);
            const float dv = div_rn(svs[(r + 1) * kTX + c] - vs, A.dy);
            A.rhs[(size_t)j * nx + i] = div_rn(du + dv, dt);
        }
    }
}

// The CTA's branch is uniform: tiles [fy0, fy1) x [fx0, fx1) are the
// plan's interior ones.
template <int S, bool AVG>
__global__ void __launch_bounds__(kPThreads) predict_div_tiled_kernel(PredArgs A, int fy0,
                                                                      int fy1, int fx0,
                                                                      int fx1) {
    constexpr int H = (S == FIRST) ? 1 : 2;
    using W = Win<H>;
    __shared__ float su[W::NU], sv[W::NV], sus[W::NMU], svs[W::NMV];
    __shared__ uint8_t smu[W::NMU], smv[W::NMV];
    const int by = blockIdx.y, bx = blockIdx.x;
    if (by >= fy0 && by < fy1 && bx >= fx0 && bx < fx1)
        tile_body<S, AVG, true>(A, su, sv, smu, smv, sus, svs);
    else
        tile_body<S, AVG, false>(A, su, sv, smu, smv, sus, svs);
}

template <int S, bool AVG>
void launch(const PredArgs& A, const int* fast, cudaStream_t st) {
    dim3 grid((A.nx + kTX - 1) / kTX, (A.ny + kTY - 1) / kTY);
    predict_div_tiled_kernel<S, AVG>
        <<<grid, kPThreads, 0, st>>>(A, fast[0], fast[1], fast[2], fast[3]);
}

int dispatch(const PredArgs& A, int scheme, int avg, const int* fast, cudaStream_t st) {
    switch (scheme * 2 + (avg ? 1 : 0)) {
        case 0: launch<FIRST, false>(A, fast, st); break;
        case 1: launch<FIRST, true>(A, fast, st); break;
        case 2: launch<SECOND, false>(A, fast, st); break;
        case 3: launch<SECOND, true>(A, fast, st); break;
        case 4: launch<QUICK, false>(A, fast, st); break;
        case 5: launch<QUICK, true>(A, fast, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// scheme: 0 FIRST, 1 SECOND, 2 QUICK; avg: 1 for JS's averaged convecting v.
// The arrays hold ny rows, global rows [row_off, row_off + ny) of a
// gny-row grid (row_off = 0, gny = ny: the whole field); the masks hold
// the whole grid. The plan's arguments (kernels/substep.py
// predict_tile_plan): its tile (rows, cols), which must be this file's,
// and its interior tiles [fy0, fy1) x [fx0, fx1).
extern "C" int cfd_predict_div_tiled(const float* u, const float* v, const float* scal,
                                     float* u_star, float* v_star, float* rhs,
                                     const uint8_t* mask_u, const uint8_t* mask_v, int ny,
                                     int nx, int row_off, int gny, float dx, float dy,
                                     float dx2, float dy2, int scheme, int avg, int tile_rows,
                                     int tile_cols, int fy0, int fy1, int fx0, int fx1,
                                     void* stream) {
    if (tile_rows != kTY || tile_cols != kTX) return (int)cudaErrorInvalidValue;
    PredArgs A{u, v, scal, u_star, v_star, rhs, mask_u, mask_v, ny, nx, row_off, gny,
               dx, dy, dx2, dy2};
    const int fast[4] = {fy0, fy1, fx0, fx1};
    return dispatch(A, scheme, avg, fast, (cudaStream_t)stream);
}
