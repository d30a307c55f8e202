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

// Where the face functions read u, v and the masks: a loader L gives
// U(j, i) and V(j, i) at block-local rows, zero outside the arrays as
// `ld` does; MU(j, gj, i) and MV(j, gj, i), the predictor masks' faces at
// local row j, global row gj; and div(x, y), its division (x / y, or
// common.cuh div_rn: the same bits). L::kGeneric says every face it is
// asked for lies away from the walls and the near-wall forms (the tiled
// kernel's interior tiles, kernels/substep.py `predict_tile_plan`): the
// row and column tests below are then constant and drop out. Every
// expression keeps its operand order whatever the loader, so every
// loader gives the same bits.
struct GlobalLd {  // the arrays in device memory, bounds-tested
    static constexpr bool kGeneric = false;
    const PredArgs& A;
    __device__ __forceinline__ float U(int j, int i) const {
        return ld(A.u, A.ny, A.nx + 1, j, i);
    }
    __device__ __forceinline__ float V(int j, int i) const { return ld(A.v, A.ny, A.nx, j, i); }
    __device__ __forceinline__ bool MU(int, int gj, int i) const {
        return masked(A.mask_u, (size_t)gj * (A.nx + 1) + i);
    }
    __device__ __forceinline__ bool MV(int, int gj, int i) const {
        return masked(A.mask_v, (size_t)gj * A.nx + i);
    }
    __device__ __forceinline__ static float div(float x, float y) { return x / y; }
};

// 1.5 a - 0.5 b, the second-order upwind extrapolation.
__device__ __forceinline__ float lin(float a, float b) { return 1.5f * a - 0.5f * b; }

// The faces follow ops/schemes.py term for term, e.g. QUICK's
// ((-uW + 6 uC) + 3 uE) / 8, so the kernel rounds as the plain version.

// u momentum at u face (j, i), i in [0, nx].
template <int S, bool AVG, class L>
__device__ float ustar_at(const PredArgs& A, const L& ld_, float dt, float nu, int j, int i) {
    constexpr bool G = L::kGeneric;
    const int nx = A.nx, gny = A.gny, gj = j + A.row_off;
    const float uC = ld_.U(j, i);
    if (!G && !(i >= 1 && i <= nx - 1 && gj >= 1 && gj <= gny - 2)) return uC;
    if (ld_.MU(j, gj, i)) return 0.0f;
    const float uE = ld_.U(j, i + 1), uW = ld_.U(j, i - 1);
    const float uN = ld_.U(j + 1, i), uS = ld_.U(j - 1, i);
    const float vNE = ld_.V(j + 1, i), vSE = ld_.V(j, i);
    float vn = vNE, vs = vSE, vn_avg = 0.0f, vs_avg = 0.0f;
    if (AVG || S != FIRST) {
        vn_avg = 0.5f * (ld_.V(j + 1, i - 1) + vNE);
        vs_avg = 0.5f * (ld_.V(j, i - 1) + vSE);
    }
    if (AVG) { vn = vn_avg; vs = vs_avg; }  // index.html:396-404
    float e, w, n, s;
    if (S == FIRST) {  // model.rs:893-1026; the Rust selection: unaveraged v
        e = (0.5f * (uC + uE) >= 0.0f) ? uC : uE;
        w = (0.5f * (uW + uC) >= 0.0f) ? uW : uC;
        n = (vn >= 0.0f) ? uC : uN;
        s = (vs >= 0.0f) ? uS : uC;
    } else {
        const float uEE = ld_.U(j, i + 2), uWW = ld_.U(j, i - 2);
        const float uNN = ld_.U(j + 2, i), uSS = ld_.U(j - 2, i);
        if (S == SECOND) {  // model.rs:911-1053 / index.html:425-464
            e = (uC >= 0.0f) ? ((G || i > 1) ? lin(uC, uW) : uC)
                             : ((G || i < nx - 1) ? lin(uE, uEE) : uE);
            w = (uW >= 0.0f) ? ((G || i > 2) ? lin(uW, uWW) : uW) : lin(uC, uE);
            n = (vn_avg >= 0.0f) ? ((G || gj > 1) ? lin(uC, uS) : uC)
                                 : ((G || gj < gny - 2) ? lin(uN, uNN) : uN);
            s = (vs_avg >= 0.0f) ? ((G || gj > 1) ? lin(uS, uSS) : uS) : lin(uC, uN);
        } else {  // QUICK, index.html:471-541
            e = (uC >= 0.0f)
                    ? ((G || i >= 2) ? (-uW + 6.0f * uC + 3.0f * uE) / 8.0f : lin(uC, uW))
                    : ((G || i <= nx - 2) ? (3.0f * uC + 6.0f * uE - uEE) / 8.0f : uE);
            w = (uW >= 0.0f)
                    ? ((G || i >= 3) ? (-uWW + 6.0f * uW + 3.0f * uC) / 8.0f : lin(uW, uC))
                    : (3.0f * uW + 6.0f * uC - uE) / 8.0f;
            n = (vn_avg >= 0.0f)
                    ? ((G || gj >= 2) ? (-uS + 6.0f * uC + 3.0f * uN) / 8.0f : lin(uC, uS))
                    : ((G || gj < gny - 2) ? (3.0f * uC + 6.0f * uN - uNN) / 8.0f : uN);
            s = (vs_avg >= 0.0f)
                    ? ((G || gj >= 2) ? (-uSS + 6.0f * uS + 3.0f * uC) / 8.0f : lin(uS, uC))
                    : ((G || gj < gny - 1) ? (3.0f * uS + 6.0f * uC - uN) / 8.0f : uC);
        }
    }
    const float conv = L::div(e * e - w * w, A.dx) + L::div(vn * n - vs * s, A.dy);
    const float lap = L::div((uE - 2.0f * uC) + uW, A.dx2) + L::div((uN - 2.0f * uC) + uS, A.dy2);
    return uC + dt * (-conv + nu * lap);
}

// v momentum at v face (j, i), i in [0, nx-1]. A row past the array reads
// 0: on the whole field that is v's implicit zero top row (j = ny). A
// block row past the grid (a halo) keeps v, as every non-interior face
// does. The convecting u is unaveraged in both semantics.
template <int S, class L>
__device__ float vstar_at(const PredArgs& A, const L& ld_, float dt, float nu, int j, int i) {
    constexpr bool G = L::kGeneric;
    const int nx = A.nx, gny = A.gny, gj = j + A.row_off;
    if (!G && j >= A.ny) return 0.0f;
    const float vC = ld_.V(j, i);
    if (!G && !(i >= 1 && i <= nx - 2 && gj >= 1 && gj <= gny - 1)) return vC;
    if (ld_.MV(j, gj, i)) return 0.0f;
    const float vE = ld_.V(j, i + 1), vW = ld_.V(j, i - 1);
    const float vN = ld_.V(j + 1, i), vS = ld_.V(j - 1, i);
    const float u_e = ld_.U(j, i + 1), u_w = ld_.U(j, i);
    const float vn_avg = 0.5f * (vC + vN), vs_avg = 0.5f * (vS + vC);
    float e, w, n, s;
    if (S == FIRST) {  // model.rs:1085-1229
        e = (u_e >= 0.0f) ? vC : vE;
        w = (u_w >= 0.0f) ? vW : vC;
        n = (vn_avg >= 0.0f) ? vC : vN;
        s = (vs_avg >= 0.0f) ? vS : vC;
    } else {
        const float vEE = ld_.V(j, i + 2), vWW = ld_.V(j, i - 2);
        const float vNN = ld_.V(j + 2, i), vSS = ld_.V(j - 2, i);
        if (S == SECOND) {  // model.rs:1098-1248 / index.html:596-633
            e = (u_e >= 0.0f) ? ((G || i > 0) ? lin(vC, vW) : vC)
                              : ((G || i < nx - 2) ? lin(vE, vEE) : vE);
            w = (u_w >= 0.0f) ? ((G || i > 1) ? lin(vW, vWW) : vW)
                              : ((G || i < nx - 1) ? lin(vC, vE) : vC);
            n = (vn_avg >= 0.0f) ? ((G || gj > 1) ? lin(vC, vS) : vC)
                                 : ((G || gj < gny - 1) ? lin(vN, vNN) : vN);
            s = (vs_avg >= 0.0f) ? ((G || gj > 1) ? lin(vS, vSS) : vS) : lin(vC, vN);
        } else {  // QUICK, index.html:645-711
            e = (u_e >= 0.0f)
                    ? ((G || i >= 2) ? (-vW + 6.0f * vC + 3.0f * vE) / 8.0f : lin(vC, vW))
                    : ((G || i < nx - 2) ? (3.0f * vC + 6.0f * vE - vEE) / 8.0f : vE);
            w = (u_w >= 0.0f)
                    ? ((G || i >= 3) ? (-vWW + 6.0f * vW + 3.0f * vC) / 8.0f : lin(vW, vC))
                    : (3.0f * vW + 6.0f * vC - vE) / 8.0f;
            n = (vn_avg >= 0.0f)
                    ? ((G || gj >= 2) ? (-vS + 6.0f * vC + 3.0f * vN) / 8.0f : lin(vC, vS))
                    : ((G || gj < gny - 1) ? (3.0f * vC + 6.0f * vN - vNN) / 8.0f : vN);
            s = (vs_avg >= 0.0f)
                    ? ((G || gj >= 2) ? (-vSS + 6.0f * vS + 3.0f * vC) / 8.0f : lin(vS, vC))
                    : ((G || gj < gny - 1) ? (3.0f * vS + 6.0f * vC - vN) / 8.0f : vC);
        }
    }
    const float conv = L::div(u_e * e - u_w * w, A.dx) + L::div(n * n - s * s, A.dy);
    const float lap = L::div((vE - 2.0f * vC) + vW, A.dx2) + L::div((vN - 2.0f * vC) + vS, A.dy2);
    return vC + dt * (-conv + nu * lap);
}

// The faces read from device memory (ensemble.cu).
template <int S, bool AVG>
__device__ __forceinline__ float ustar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    return ustar_at<S, AVG>(A, GlobalLd{A}, dt, nu, j, i);
}

template <int S>
__device__ __forceinline__ float vstar_at(const PredArgs& A, float dt, float nu, int j, int i) {
    return vstar_at<S>(A, GlobalLd{A}, dt, nu, j, i);
}

}  // namespace
