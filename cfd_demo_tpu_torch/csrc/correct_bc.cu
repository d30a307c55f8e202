// Fused corrector + velocity BCs + step reductions, CHANNEL flow with a
// UNIFORM, PARABOLIC or PARABOLIC_UPPER inlet and either semantics' BC masks.
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

// ops/corrector.py on u face (j, i).
__device__ __forceinline__ float u_corrected(const CorrArgs& A, float dt, int j, int i) {
    const size_t k = (size_t)j * (A.nx + 1) + i;
    const float s = A.us[k];
    if (i < 1 || i > A.nx - 1) return s;
    const size_t kp = (size_t)j * A.nx + i;
    return s - dt * (A.pp[kp] - A.pp[kp - 1]) / A.dx;
}

__global__ void correct_bc_kernel(CorrArgs A) {
    __shared__ float sh[33];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int ny = A.ny, nx = A.nx, gny = A.gny, gj = j + A.row_off;
    const bool in_grid = gj >= 0 && gj < gny;
    float ru = 0.0f, rv = 0.0f, vel = 0.0f;
    if (j < ny && i <= nx) {
        const bool own = j >= A.own_lo && j < A.own_hi;
        const float dt = A.scal[0], inlet = A.scal[1];
        // u: corrector, then ops/bc.py in order: inlet, outlet copy of the
        // *corrected* u[j, nx-1] (recomputed here), no-slip rows, solid mask.
        float uval;
        const size_t ku = (size_t)j * (nx + 1) + i;
        if (i == 0) uval = inlet_at(A.in, inlet, gj);
        else if (i == nx) uval = u_corrected(A, dt, j, nx - 1);
        else uval = u_corrected(A, dt, j, i);
        if (gj == 0 || gj == gny - 1) uval = 0.0f;
        if (in_grid && masked(A.mask_u_bc, (size_t)gj * (nx + 1) + i)) uval = 0.0f;
        A.u[ku] = uval;
        if (own) {
            ru = fabsf(uval - A.ue[ku]);
            vel = fabsf(uval);
        }
        if (i < nx) {
            const size_t k = (size_t)j * nx + i;
            float vval = A.vs[k];
            // p'[j-1] past the block's first row reads 0 (a halo row)
            const float pS = (j >= 1) ? A.pp[k - nx] : 0.0f;
            if (gj >= 1) vval = vval - dt * (A.pp[k] - pS) / A.dy;
            if (gj == 0) vval = 0.0f;
            if (in_grid && masked(A.mask_v_bc, (size_t)gj * nx + i)) vval = 0.0f;
            A.v[k] = vval;
            A.p_out[k] = A.p[k] + A.pp[k];
            if (own) {
                rv = fabsf(vval - A.ve[k]);
                vel = pmax(vel, fabsf(vval));
            }
        }
    }
    ru = block_max(ru, sh);
    rv = block_max(rv, sh);
    vel = block_max(vel, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        float* o = A.partials + 3 * (blockIdx.y * gridDim.x + blockIdx.x);
        o[0] = ru;
        o[1] = rv;
        o[2] = vel;
    }
}

__global__ void reduce3_kernel(const float* partials, int nblocks, float* red) {
    __shared__ float sh[33];
    float m[3] = {0.0f, 0.0f, 0.0f};
    for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
        for (int c = 0; c < 3; ++c) m[c] = pmax(m[c], partials[3 * b + c]);
    for (int c = 0; c < 3; ++c) {
        const float r = block_max(m[c], sh);
        if (threadIdx.x == 0) red[c] = r;
    }
}

}  // namespace

extern "C" int cfd_correct_bc_partials(int ny, int nx) {
    return ((nx + 1 + 31) / 32) * ((ny + 7) / 8);
}

extern "C" int cfd_correct_bc(const float* us, const float* vs, const float* p,
                              const float* pp, const float* ue, const float* ve,
                              const float* scal, float* u, float* v, float* p_out,
                              float* partials, float* red, const uint8_t* mask_u_bc,
                              const uint8_t* mask_v_bc, int ny, int nx, int row_off,
                              int gny, int own_lo, int own_hi, float dx, float dy,
                              int parabolic, float center, float radius, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    CorrArgs A{us, vs, p, pp, ue, ve, scal, u, v, p_out, partials, mask_u_bc, mask_v_bc,
               ny, nx, row_off, gny, own_lo, own_hi, dx, dy,
               Inlet{parabolic, dy, center, radius}};
    dim3 block(32, 8);
    dim3 grid((nx + 1 + 31) / 32, (ny + 7) / 8);
    correct_bc_kernel<<<grid, block, 0, st>>>(A);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    reduce3_kernel<<<1, 1024, 0, st>>>(partials, grid.x * grid.y, red);
    return (int)cudaGetLastError();
}
