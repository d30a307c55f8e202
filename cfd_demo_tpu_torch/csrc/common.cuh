// Shared device helpers for the PISO kernels (f32, row-major (rows=y, cols=x)).
//
// The library is built with -fmad=false: the JAX reference rounds every
// multiply and add separately, and a contracted a*b+c in the obstacle
// test below can move a face on the cylinder's rim across the radius,
// an O(1) error at that face.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CFD_MAX_CYL 4

// Cylinders of the scene, passed by value as a kernel argument.
// cx, cy and r2 = f32(radius**2) are rounded to f32 as the JAX package does.
struct Cyl {
    int n;
    float cx[CFD_MAX_CYL];
    float cy[CFD_MAX_CYL];
    float r2[CFD_MAX_CYL];
};

// Build a Cyl from a host array of n (cx, cy, r2) triples.
static inline Cyl make_cyl(int n, const float* host) {
    Cyl c;
    c.n = n;
    for (int k = 0; k < n; ++k) {
        c.cx[k] = host[3 * k];
        c.cy[k] = host[3 * k + 1];
        c.r2[k] = host[3 * k + 2];
    }
    return c;
}

// A max that propagates NaN like jnp.max / torch.amax (fmaxf drops it).
__device__ __forceinline__ float pmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// Cell-centre test, strict `<` (core/masks.py `_inside_any`, Rust).
__device__ __forceinline__ bool inside_any(const Cyl& c, float x, float y) {
    bool in = false;
#pragma unroll
    for (int k = 0; k < CFD_MAX_CYL; ++k) {  // constant indices: c stays in registers
        if (k < c.n) {
            float a = __fsub_rn(x, c.cx[k]);
            float b = __fsub_rn(y, c.cy[k]);
            float d2 = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
            in = in || (d2 < c.r2[k]);
        }
    }
    return in;
}

// Coordinate (idx + off) * h in f32, as `coords` in core/masks.py.
__device__ __forceinline__ float coord(int idx, float off, float h) {
    return __fmul_rn(__fadd_rn((float)idx, off), h);
}

// Rust masks (core/masks.py masks_traced). u face (j, i), i in [0, nx].
__device__ __forceinline__ bool in_cell_east_of_u(const Cyl& c, int j, int i,
                                                  int nx, float dx, float dy) {
    return i <= nx - 1 && inside_any(c, coord(i, 0.5f, dx), coord(j, 0.5f, dy));
}
__device__ __forceinline__ bool mask_u_star(const Cyl& c, int j, int i, int nx,
                                            float dx, float dy) {
    if (i < 1) return false;  // cell 0 never marks face 0
    bool in_w = inside_any(c, coord(i, -0.5f, dx), coord(j, 0.5f, dy));
    return in_w || in_cell_east_of_u(c, j, i, nx, dx, dy);
}
__device__ __forceinline__ bool mask_u_bc(const Cyl& c, int j, int i, int nx,
                                          float dx, float dy) {
    return in_cell_east_of_u(c, j, i, nx, dx, dy);
}
// v face (j, i), j in [0, ny-1] (the implicit top row is never masked).
__device__ __forceinline__ bool mask_v_bc(const Cyl& c, int j, int i,
                                          float dx, float dy) {
    return inside_any(c, coord(i, 0.5f, dx), coord(j, 0.5f, dy));
}
__device__ __forceinline__ bool mask_v_star(const Cyl& c, int j, int i,
                                            float dx, float dy) {
    if (j < 1) return false;
    bool in_s = inside_any(c, coord(i, 0.5f, dx), coord(j, -0.5f, dy));
    return in_s || mask_v_bc(c, j, i, dx, dy);
}

// Max over all threads of a block; every thread gets the result.
// `sh` holds at least 33 floats of shared memory. Contains __syncthreads.
__device__ __forceinline__ float block_max(float x, float* sh) {
    const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
    const int nthreads = blockDim.x * blockDim.y * blockDim.z;
    for (int o = 16; o > 0; o >>= 1) x = pmax(x, __shfl_xor_sync(0xffffffffu, x, o));
    __syncthreads();  // earlier readers of sh are done
    if ((tid & 31) == 0) sh[tid >> 5] = x;
    __syncthreads();
    if (tid < 32) {
        x = (tid < (nthreads + 31) / 32) ? sh[tid] : 0.0f;
        for (int o = 16; o > 0; o >>= 1) x = pmax(x, __shfl_xor_sync(0xffffffffu, x, o));
        if (tid == 0) sh[32] = x;
    }
    __syncthreads();
    return sh[32];
}
