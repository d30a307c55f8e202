// The predictor at one face (ops/predictor.py with the faces of
// ops/schemes.py), shared by predict_div.cu and ensemble.cu. Templated on
// the upwind scheme S and on AVG, JS's averaged convecting v.
//
// The arrays may be a row block of a sharded field: local row j is global
// row j + row_off of a gny-row grid. Loads are local (zero outside the
// block, as outside the grid); every row test (interior, the schemes'
// near-wall forms, v's implicit zero top row) and the masks, which hold
// the whole grid, take the global row. The whole field is row_off = 0,
// gny = ny.
#pragma once

#include "common.cuh"

namespace {

enum Scheme { FIRST = 0, SECOND = 1, QUICK = 2 };

struct PredArgs {
    const float* u;   // (ny, nx+1)
    const float* v;   // (ny, nx)
    const float* scal;  // device [dt_sub, nu]
    float* u_star;    // (ny, nx+1)
    float* v_star;    // (ny, nx)
    float* rhs;       // (ny, nx)
    const uint8_t* mask_u;  // predictor masks (ny, nx+1), (ny, nx), or null
    const uint8_t* mask_v;
    int ny, nx;       // the arrays' rows (the block's) and the grid's columns
    int row_off, gny;  // global row of local row 0; the grid's rows
    float dx, dy, dx2, dy2;  // f32(dx), f32(dy), f32(dx*dx), f32(dy*dy)
};

// Zero-filled reads outside the array (ops/stencil.py `shifted`).
__device__ __forceinline__ float ld(const float* a, int rows, int cols, int j, int i) {
    return (j >= 0 && j < rows && i >= 0 && i < cols) ? __ldg(a + (size_t)j * cols + i) : 0.0f;
}

// 1.5 a - 0.5 b, the second-order upwind extrapolation.
__device__ __forceinline__ float lin(float a, float b) { return 1.5f * a - 0.5f * b; }

// The faces follow ops/schemes.py term for term, e.g. QUICK's
// ((-uW + 6 uC) + 3 uE) / 8, so the kernel rounds as the plain version.

// u momentum at u face (j, i), i in [0, nx].
template <int S, bool AVG>
__device__ float ustar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1, gny = A.gny, gj = j + A.row_off;
    const float uC = ld(A.u, ny, wu, j, i);
    if (!(i >= 1 && i <= nx - 1 && gj >= 1 && gj <= gny - 2)) return uC;
    if (masked(A.mask_u, (size_t)gj * wu + i)) return 0.0f;
    const float uE = ld(A.u, ny, wu, j, i + 1), uW = ld(A.u, ny, wu, j, i - 1);
    const float uN = ld(A.u, ny, wu, j + 1, i), uS = ld(A.u, ny, wu, j - 1, i);
    const float vNE = ld(A.v, ny, nx, j + 1, i), vSE = ld(A.v, ny, nx, j, i);
    float vn = vNE, vs = vSE, vn_avg = 0.0f, vs_avg = 0.0f;
    if (AVG || S != FIRST) {
        vn_avg = 0.5f * (ld(A.v, ny, nx, j + 1, i - 1) + vNE);
        vs_avg = 0.5f * (ld(A.v, ny, nx, j, i - 1) + vSE);
    }
    if (AVG) { vn = vn_avg; vs = vs_avg; }  // index.html:396-404
    float e, w, n, s;
    if (S == FIRST) {  // model.rs:893-1026; the Rust selection: unaveraged v
        e = (0.5f * (uC + uE) >= 0.0f) ? uC : uE;
        w = (0.5f * (uW + uC) >= 0.0f) ? uW : uC;
        n = (vn >= 0.0f) ? uC : uN;
        s = (vs >= 0.0f) ? uS : uC;
    } else {
        const float uEE = ld(A.u, ny, wu, j, i + 2), uWW = ld(A.u, ny, wu, j, i - 2);
        const float uNN = ld(A.u, ny, wu, j + 2, i), uSS = ld(A.u, ny, wu, j - 2, i);
        if (S == SECOND) {  // model.rs:911-1053 / index.html:425-464
            e = (uC >= 0.0f) ? ((i > 1) ? lin(uC, uW) : uC)
                             : ((i < nx - 1) ? lin(uE, uEE) : uE);
            w = (uW >= 0.0f) ? ((i > 2) ? lin(uW, uWW) : uW) : lin(uC, uE);
            n = (vn_avg >= 0.0f) ? ((gj > 1) ? lin(uC, uS) : uC)
                                 : ((gj < gny - 2) ? lin(uN, uNN) : uN);
            s = (vs_avg >= 0.0f) ? ((gj > 1) ? lin(uS, uSS) : uS) : lin(uC, uN);
        } else {  // QUICK, index.html:471-541
            e = (uC >= 0.0f) ? ((i >= 2) ? (-uW + 6.0f * uC + 3.0f * uE) / 8.0f : lin(uC, uW))
                             : ((i <= nx - 2) ? (3.0f * uC + 6.0f * uE - uEE) / 8.0f : uE);
            w = (uW >= 0.0f) ? ((i >= 3) ? (-uWW + 6.0f * uW + 3.0f * uC) / 8.0f : lin(uW, uC))
                             : (3.0f * uW + 6.0f * uC - uE) / 8.0f;
            n = (vn_avg >= 0.0f)
                    ? ((gj >= 2) ? (-uS + 6.0f * uC + 3.0f * uN) / 8.0f : lin(uC, uS))
                    : ((gj < gny - 2) ? (3.0f * uC + 6.0f * uN - uNN) / 8.0f : uN);
            s = (vs_avg >= 0.0f)
                    ? ((gj >= 2) ? (-uSS + 6.0f * uS + 3.0f * uC) / 8.0f : lin(uS, uC))
                    : ((gj < gny - 1) ? (3.0f * uS + 6.0f * uC - uN) / 8.0f : uC);
        }
    }
    const float conv = (e * e - w * w) / A.dx + (vn * n - vs * s) / A.dy;
    const float lap = ((uE - 2.0f * uC) + uW) / A.dx2 + ((uN - 2.0f * uC) + uS) / A.dy2;
    return uC + dt * (-conv + nu * lap);
}

// v momentum at v face (j, i), i in [0, nx-1]. A row past the array reads
// 0: on the whole field that is v's implicit zero top row (j = ny). A
// block row past the grid (a halo) keeps v, as every non-interior face
// does. The convecting u is unaveraged in both semantics.
template <int S>
__device__ float vstar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    const int ny = A.ny, nx = A.nx, wu = nx + 1, gny = A.gny, gj = j + A.row_off;
    if (j >= ny) return 0.0f;
    const float vC = ld(A.v, ny, nx, j, i);
    if (!(i >= 1 && i <= nx - 2 && gj >= 1 && gj <= gny - 1)) return vC;
    if (masked(A.mask_v, (size_t)gj * nx + i)) return 0.0f;
    const float vE = ld(A.v, ny, nx, j, i + 1), vW = ld(A.v, ny, nx, j, i - 1);
    const float vN = ld(A.v, ny, nx, j + 1, i), vS = ld(A.v, ny, nx, j - 1, i);
    const float u_e = ld(A.u, ny, wu, j, i + 1), u_w = ld(A.u, ny, wu, j, i);
    const float vn_avg = 0.5f * (vC + vN), vs_avg = 0.5f * (vS + vC);
    float e, w, n, s;
    if (S == FIRST) {  // model.rs:1085-1229
        e = (u_e >= 0.0f) ? vC : vE;
        w = (u_w >= 0.0f) ? vW : vC;
        n = (vn_avg >= 0.0f) ? vC : vN;
        s = (vs_avg >= 0.0f) ? vS : vC;
    } else {
        const float vEE = ld(A.v, ny, nx, j, i + 2), vWW = ld(A.v, ny, nx, j, i - 2);
        const float vNN = ld(A.v, ny, nx, j + 2, i), vSS = ld(A.v, ny, nx, j - 2, i);
        if (S == SECOND) {  // model.rs:1098-1248 / index.html:596-633
            e = (u_e >= 0.0f) ? ((i > 0) ? lin(vC, vW) : vC)
                              : ((i < nx - 2) ? lin(vE, vEE) : vE);
            w = (u_w >= 0.0f) ? ((i > 1) ? lin(vW, vWW) : vW)
                              : ((i < nx - 1) ? lin(vC, vE) : vC);
            n = (vn_avg >= 0.0f) ? ((gj > 1) ? lin(vC, vS) : vC)
                                 : ((gj < gny - 1) ? lin(vN, vNN) : vN);
            s = (vs_avg >= 0.0f) ? ((gj > 1) ? lin(vS, vSS) : vS) : lin(vC, vN);
        } else {  // QUICK, index.html:645-711
            e = (u_e >= 0.0f) ? ((i >= 2) ? (-vW + 6.0f * vC + 3.0f * vE) / 8.0f : lin(vC, vW))
                              : ((i < nx - 2) ? (3.0f * vC + 6.0f * vE - vEE) / 8.0f : vE);
            w = (u_w >= 0.0f) ? ((i >= 3) ? (-vWW + 6.0f * vW + 3.0f * vC) / 8.0f : lin(vW, vC))
                              : (3.0f * vW + 6.0f * vC - vE) / 8.0f;
            n = (vn_avg >= 0.0f)
                    ? ((gj >= 2) ? (-vS + 6.0f * vC + 3.0f * vN) / 8.0f : lin(vC, vS))
                    : ((gj < gny - 1) ? (3.0f * vC + 6.0f * vN - vNN) / 8.0f : vN);
            s = (vs_avg >= 0.0f)
                    ? ((gj >= 2) ? (-vSS + 6.0f * vS + 3.0f * vC) / 8.0f : lin(vS, vC))
                    : ((gj < gny - 1) ? (3.0f * vS + 6.0f * vC - vN) / 8.0f : vC);
        }
    }
    const float conv = (u_e * e - u_w * w) / A.dx + (n * n - s * s) / A.dy;
    const float lap = ((vE - 2.0f * vC) + vW) / A.dx2 + ((vN - 2.0f * vC) + vS) / A.dy2;
    return vC + dt * (-conv + nu * lap);
}

}  // namespace
