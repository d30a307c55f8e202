// Fused corrector + velocity BCs + step reductions, CHANNEL flow with a
// UNIFORM, PARABOLIC or PARABOLIC_UPPER inlet and either semantics' BC masks,
// or (the one-launch form's CAVITY instance, a template flag) the
// lid-driven cavity's walls and its UNIFORM or parabolic lid.
// Replaces cfd_demo_tpu/kernels/substep_pallas.py correct_bc_pallas
// (_kernel_post). See kernels/substep.py for the design note.
//
// The arrays may be a row block of a sharded field: local row j is global
// row j + row_off of a gny-row grid. The BC rows, the inlet's rows and the
// masks (which hold the whole grid) take the global row, and the three
// reductions count the owned local rows [own_lo, own_hi) only (the
// caller discards the halo rows). The whole field is row_off = 0,
// gny = ny and every row owned.
#include "common.cuh"

namespace {

struct CorrArgs {
    const float* us;   // u* (ny, nx+1)
    const float* vs;   // v* (ny, nx)
    const float* p;    // (ny, nx)
    const float* pp;   // p' (ny, nx)
    const float* ue;   // step-entry u (ny, nx+1)
    const float* ve;   // step-entry v (ny, nx)
    const float* scal; // device [dt_sub, inlet]
    float* u;
    float* v;
    float* p_out;
    float* partials;   // 3 per block: max|u-ue|, max|v-ve|, max(|u|,|v|)
    const uint8_t* mask_u_bc;  // (ny, nx+1) or null
    const uint8_t* mask_v_bc;  // (ny, nx) or null
    int ny, nx;        // the block's rows, the grid's columns
    int row_off, gny;  // global row of local row 0; the grid's rows
    int own_lo, own_hi;
    float dx, dy;
    Inlet in;
};

// The one-launch form's CTA: kCX x kCY threads, each a column strip of
// kCR rows (kernels/substep.py CORRECT_STRIP mirrors these; `kernel_times
// --substep-forms` rebuilds this file with kCB_R set to time others).
#ifndef kCB_R
#define kCB_R 16
#endif
constexpr int kCX = 32, kCY = 8, kCR = kCB_R, kCThreads = kCX * kCY;

// The three maxima of a CTA at once: one shuffle pass over three
// registers, one shared-memory exchange. Thread 0 gets the result.
__device__ __forceinline__ void cta_max3(float m[3], float (*sh)[3]) {
    const int tid = threadIdx.x + kCX * threadIdx.y, lane = tid & 31, warp = tid >> 5;
    for (int o = 16; o > 0; o >>= 1)
        for (int c = 0; c < 3; ++c) m[c] = pmax(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
    if (lane == 0)
        for (int c = 0; c < 3; ++c) sh[warp][c] = m[c];
    __syncthreads();
    if (warp == 0) {
        for (int c = 0; c < 3; ++c) m[c] = (lane < kCThreads / 32) ? sh[lane][c] : 0.0f;
        for (int o = 16; o > 0; o >>= 1)
            for (int c = 0; c < 3; ++c)
                m[c] = pmax(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
    }
}

// One face's inputs (zeros where `in` is false): u* at the face whose
// corrected u face i takes (ic: i, or nx - 1 at the outlet), p' there and
// west of it, the entry u; for i < nx (hv) v*, p, the entry v; the BC
// masks at the global row.
struct FaceIn {
    float us, pc, pw, ue, vs, p, ve;
    bool mu, mv;
};

__device__ __forceinline__ FaceIn load_face(const CorrArgs& A, bool in, int j, int i, int ic,
                                            bool hv, bool corr) {
    const int nx = A.nx, wu = nx + 1, gj = j + A.row_off;
    const bool in_grid = gj >= 0 && gj < A.gny;
    const size_t ku = (size_t)j * wu, kv = (size_t)j * nx;
    FaceIn f;
    f.us = in ? __ldg(A.us + ku + ic) : 0.0f;
    f.pc = in ? __ldg(A.pp + kv + ic) : 0.0f;
    f.pw = (in && corr) ? __ldg(A.pp + kv + ic - 1) : 0.0f;
    f.ue = in ? __ldg(A.ue + ku + i) : 0.0f;
    f.mu = in && in_grid && A.mask_u_bc != nullptr && __ldg(A.mask_u_bc + (size_t)gj * wu + i);
    f.vs = (in && hv) ? __ldg(A.vs + kv + i) : 0.0f;
    f.p = (in && hv) ? __ldg(A.p + kv + i) : 0.0f;
    f.ve = (in && hv) ? __ldg(A.ve + kv + i) : 0.0f;
    f.mv = in && hv && in_grid && A.mask_v_bc != nullptr &&
           __ldg(A.mask_v_bc + (size_t)gj * nx + i);
    return f;
}

// A thread's strip: kCR rows of face column i from row jb, the next row's
// inputs loaded before this row's outputs are computed and stored (one
// row in flight ahead: read-only loads, issued before the stores in
// program order). Each face gets ops/corrector.py's arithmetic: the
// corrector, the BCs in ops/bc.py's order (CHANNEL: inlet, the outlet's
// copy of the corrected u[j, nx-1], no-slip rows, solid mask; CAVITY: the
// lid on row gny-1, the floor, the side walls u[:, 0] = u[:, nx] = 0 and
// v[:, 0] = v[:, nx-1] = 0, solid mask), v with p'[j-1] carried from the
// row below (0 past the block's first row, a halo row), p; owned rows
// fold into m.
template <bool CAVITY>
__device__ __forceinline__ void correct_strip(const CorrArgs& A, int jb, int i, float m[3]) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1, gny = A.gny;
    const float dt = A.scal[0], inlet = A.scal[1];
    const int ic = (i == nx) ? nx - 1 : i;
    const bool hv = i < nx, corr = i >= 1 && ic >= 1 && ic <= nx - 1;
    FaceIn cur = load_face(A, true, jb, i, ic, hv, corr);
    float pS = (jb >= 1 && hv) ? __ldg(A.pp + (size_t)(jb - 1) * nx + i) : 0.0f;
#pragma unroll 1
    for (int r = 0; r < kCR; ++r) {
        const int j = jb + r, gj = j + A.row_off;
        if (j >= ny) break;
        const FaceIn nxt = load_face(A, r + 1 < kCR && j + 1 < ny, j + 1, i, ic, hv, corr);
        const bool own = j >= A.own_lo && j < A.own_hi;
        float uval;
        if constexpr (CAVITY) {
            uval = corr ? cur.us - div_rn(dt * (cur.pc - cur.pw), A.dx) : cur.us;
            if (gj == gny - 1) uval = lid_at(A.in, inlet, i);
            if (gj == 0 || i == 0 || i == nx) uval = 0.0f;
        } else {
            if (i == 0) uval = inlet_at(A.in, inlet, gj);
            else if (corr) uval = cur.us - div_rn(dt * (cur.pc - cur.pw), A.dx);
            else uval = cur.us;
            if (gj == 0 || gj == gny - 1) uval = 0.0f;
        }
        if (cur.mu) uval = 0.0f;
        A.u[(size_t)j * wu + i] = uval;
        if (own) {
            m[0] = pmax(m[0], fabsf(uval - cur.ue));
            m[2] = pmax(m[2], fabsf(uval));
        }
        if (hv) {
            const size_t k = (size_t)j * nx + i;
            float vval = cur.vs;
            if (gj >= 1) vval = vval - div_rn(dt * (cur.pc - pS), A.dy);
            if (gj == 0) vval = 0.0f;
            if (CAVITY && (i == 0 || i == nx - 1)) vval = 0.0f;
            if (cur.mv) vval = 0.0f;
            A.v[k] = vval;
            A.p_out[k] = cur.p + cur.pc;
            if (own) {
                m[1] = pmax(m[1], fabsf(vval - cur.ve));
                m[2] = pmax(m[2], fabsf(vval));
            }
        }
        pS = cur.pc;
        cur = nxt;
    }
}

// The one-launch form: each thread a strip of kCR rows of one column; one
// fused reduction of the three maxima a CTA into `partials`; the last CTA
// to finish (a ticket: the counter's atomicAdd after a __threadfence)
// reduces the partials into red and sets the counter back to 0 for the
// next launch.
template <bool CAVITY>
__global__ void __launch_bounds__(kCThreads) correct_bc_fused_kernel(CorrArgs A,
                                                                     unsigned* ticket,
                                                                     float* red) {
    __shared__ float sh[kCThreads / 32][3];
    __shared__ bool last;
    const int i = blockIdx.x * kCX + threadIdx.x;
    const int jb = (blockIdx.y * kCY + threadIdx.y) * kCR;
    float m[3] = {0.0f, 0.0f, 0.0f};
    if (i <= A.nx && jb < A.ny) correct_strip<CAVITY>(A, jb, i, m);
    cta_max3(m, sh);
    const unsigned nctas = gridDim.x * gridDim.y;
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        float* o = A.partials + 3 * (blockIdx.y * gridDim.x + blockIdx.x);
        for (int c = 0; c < 3; ++c) o[c] = m[c];
        __threadfence();  // the partials, before the ticket that publishes them
        last = atomicAdd(ticket, 1u) == nctas - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int tid = threadIdx.x + kCX * threadIdx.y;
    for (int c = 0; c < 3; ++c) m[c] = 0.0f;
    for (unsigned b = tid; b < nctas; b += kCThreads)
        for (int c = 0; c < 3; ++c) m[c] = pmax(m[c], __ldcg(A.partials + 3 * b + c));
    cta_max3(m, sh);  // warp 0's reads of sh ended before the barrier above
    if (tid == 0) {
        for (int c = 0; c < 3; ++c) red[c] = m[c];
        *ticket = 0u;
    }
}

}  // namespace

// The one-launch form's CTAs, each writing three partials
// (kernels/substep.py correct_strip_plan).
extern "C" int cfd_correct_bc_fused_partials(int ny, int nx) {
    return ((nx + 1 + kCX - 1) / kCX) * ((ny + kCY * kCR - 1) / (kCY * kCR));
}

// The one-launch form: `ticket`, a device counter
// that is 0 before the launch and 0 after it (the partials and the
// counter belong to one launch at a time: one stream), and `cavity`: the
// CAVITY instance, whose lid (center, radius: lx / 2) runs along x.
extern "C" int cfd_correct_bc_fused(const float* us, const float* vs, const float* p,
                                    const float* pp, const float* ue, const float* ve,
                                    const float* scal, float* u, float* v, float* p_out,
                                    float* partials, unsigned* ticket, float* red,
                                    const uint8_t* mask_u_bc, const uint8_t* mask_v_bc,
                                    int ny, int nx, int row_off, int gny, int own_lo,
                                    int own_hi, float dx, float dy, int parabolic,
                                    float center, float radius, int cavity,
                                    void* stream) {
    CorrArgs A{us, vs, p, pp, ue, ve, scal, u, v, p_out, partials, mask_u_bc, mask_v_bc,
               ny, nx, row_off, gny, own_lo, own_hi, dx, dy,
               Inlet{parabolic, cavity ? dx : dy, center, radius}};
    dim3 block(kCX, kCY);
    dim3 grid((nx + 1 + kCX - 1) / kCX, (ny + kCY * kCR - 1) / (kCY * kCR));
    if (cavity)
        correct_bc_fused_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(A, ticket, red);
    else
        correct_bc_fused_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(A, ticket, red);
    return (int)cudaGetLastError();
}
