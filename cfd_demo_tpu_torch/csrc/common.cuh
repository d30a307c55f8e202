// Shared device helpers for the PISO kernels (f32, row-major (rows=y, cols=x)).
//
// The library is built with -fmad=false: the JAX reference rounds every
// multiply and add separately, and a contracted a*b+c would round once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// A max that propagates NaN like jnp.max / torch.amax (fmaxf drops it).
__device__ __forceinline__ float pmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// x / y, correctly rounded, as the plain versions divide; a zero x over a
// positive y is x itself (IEEE: +-0 / y = +-0), returned without the
// division, whose out-of-line slow path a zero dividend takes. Fields
// that are zero over most of the grid (a flow starting from rest) divide
// zeros in most cells.
__device__ __forceinline__ float div_rn(float x, float y) {
    if (x == 0.0f && y > 0.0f) return x;
    return x / y;
}

// One face of an obstacle mask (core/masks.py masks_traced, one byte a
// face, (ny, nx+1) for u and (ny, nx) for v); null means no obstacles.
__device__ __forceinline__ bool masked(const uint8_t* m, size_t k) {
    return m != nullptr && m[k] != 0;
}

// The inlet profile (ops/bc.py inlet_profile_column): UNIFORM gives the
// ramped inlet speed; a parabola of centre c and half-width r (PARABOLIC
// or PARABOLIC_UPPER) gives max(inlet (1 - ((y - c) / r)^2), 0) at
// y = (j + 0.5) h, h = dy, in the JAX package's f32 order
// (inlet_profile_traced). The cavity's lid (lid_at) takes the same
// struct with h = dx and c = r = lx / 2.
struct Inlet {
    int parabolic;
    float h, c, r;  // the spacing along the profile, its centre and half-width
};

__device__ __forceinline__ float inlet_at(const Inlet& in, float inlet, int j) {
    if (!in.parabolic) return inlet;
    const float t = (((float)j + 0.5f) * in.h - in.c) / in.r;
    return pmax(inlet * (1.0f - t * t), 0.0f);
}

// The cavity's lid at u face i (ops/bc.py lid_profile_row, JAX
// ops/bc.py:99-110): UNIFORM gives the ramped lid speed; a parabola (either
// parabolic profile) max(lid (1 - ((x - c) / r)^2), 0) at x = i h, h = dx,
// c = r = lx / 2, in the JAX package's f32 order.
__device__ __forceinline__ float lid_at(const Inlet& in, float lid, int i) {
    if (!in.parabolic) return lid;
    const float t = ((float)i * in.h - in.c) / in.r;
    return pmax(lid * (1.0f - t * t), 0.0f);
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
