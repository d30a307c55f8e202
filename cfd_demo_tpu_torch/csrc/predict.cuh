// The FIRST-upwind Rust predictor at one face (ops/predictor.py), shared
// by predict_div.cu and ensemble.cu.
#pragma once

#include "common.cuh"

namespace {

struct PredArgs {
    const float* u;   // (ny, nx+1)
    const float* v;   // (ny, nx)
    const float* scal;  // device [dt_sub, nu]
    float* u_star;    // (ny, nx+1)
    float* v_star;    // (ny, nx)
    float* rhs;       // (ny, nx)
    int ny, nx;
    float dx, dy, dx2, dy2;  // f32(dx), f32(dy), f32(dx*dx), f32(dy*dy)
    Cyl cyl;
};

// Zero-filled reads outside the array (ops/stencil.py `shifted`).
__device__ __forceinline__ float ld(const float* a, int rows, int cols, int j, int i) {
    return (j >= 0 && j < rows && i >= 0 && i < cols) ? __ldg(a + (size_t)j * cols + i) : 0.0f;
}

// u*(j, i) for i in [0, nx], exactly as ops/predictor.py computes it.
__device__ float ustar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1;
    const float uC = ld(A.u, ny, wu, j, i);
    if (!(i >= 1 && i <= nx - 1 && j >= 1 && j <= ny - 2)) return uC;
    if (mask_u_star(A.cyl, j, i, nx, A.dx, A.dy)) return 0.0f;
    const float uE = ld(A.u, ny, wu, j, i + 1), uW = ld(A.u, ny, wu, j, i - 1);
    const float uN = ld(A.u, ny, wu, j + 1, i), uS = ld(A.u, ny, wu, j - 1, i);
    const float vNE = ld(A.v, ny, nx, j + 1, i), vSE = ld(A.v, ny, nx, j, i);
    const float e = (0.5f * (uC + uE) >= 0.0f) ? uC : uE;
    const float w = (0.5f * (uW + uC) >= 0.0f) ? uW : uC;
    const float n = (vNE >= 0.0f) ? uC : uN;  // unaveraged v (model.rs:977)
    const float s = (vSE >= 0.0f) ? uS : uC;
    const float conv = (e * e - w * w) / A.dx + (vNE * n - vSE * s) / A.dy;
    const float lap = ((uE - 2.0f * uC) + uW) / A.dx2 + ((uN - 2.0f * uC) + uS) / A.dy2;
    return uC + dt * (-conv + nu * lap);
}

// v*(j, i) for i in [0, nx-1]; j = ny is v's implicit zero top row.
__device__ float vstar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1;
    if (j >= ny) return 0.0f;
    const float vC = ld(A.v, ny, nx, j, i);
    if (!(i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 1)) return vC;
    if (mask_v_star(A.cyl, j, i, A.dx, A.dy)) return 0.0f;
    const float vE = ld(A.v, ny, nx, j, i + 1), vW = ld(A.v, ny, nx, j, i - 1);
    const float vN = ld(A.v, ny, nx, j + 1, i), vS = ld(A.v, ny, nx, j - 1, i);
    const float u_e = ld(A.u, ny, wu, j, i + 1), u_w = ld(A.u, ny, wu, j, i);
    const float e = (u_e >= 0.0f) ? vC : vE;
    const float w = (u_w >= 0.0f) ? vW : vC;
    const float n = (0.5f * (vC + vN) >= 0.0f) ? vC : vN;
    const float s = (0.5f * (vS + vC) >= 0.0f) ? vS : vC;
    const float conv = (u_e * e - u_w * w) / A.dx + (n * n - s * s) / A.dy;
    const float lap = ((vE - 2.0f * vC) + vW) / A.dx2 + ((vN - 2.0f * vC) + vS) / A.dy2;
    return vC + dt * (-conv + nu * lap);
}

}  // namespace
