// k damped-Jacobi sweeps on p' with folded boundary reads, CHANNEL flow.
// Replaces cfd_demo_tpu/kernels/jacobi_pallas.py jacobi_fused_k (_kernel)
// and, on a sharded tier's halo-extended block, jacobi_fused_k_shard
// (_kernel_shard).
// See kernels/jacobi.py for the design note; the sweep and the BC pass
// are in sweep.cuh.
#include "sweep.cuh"

// k sweeps from pp_in into `out` (pp_in is not written), ping-ponging
// through `tmp`; the last sweep writes per-block maxima to `partials`
// (size: the sweep grid's block count, see cfd_jacobi_partials), then one
// block applies the p' BCs and reduces them into err[0].
extern "C" int cfd_jacobi_partials(int ny, int nx) { return nparts(ny, nx); }

namespace {

template <bool BLK>
int fused_k(const float* pp_in, const float* rhs, float* out, float* tmp, float* partials,
            float* err, int ny, int nx, int k, float ax, float ay, float ar, float ac,
            cudaStream_t st, Block blk) {
    if (k < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = run_sweeps_as<BLK>(pp_in, rhs, out, tmp, partials, ny, nx, k,
                                       ax, ay, ar, ac, st, blk);
    if (e != cudaSuccess) return (int)e;
    bc_max_kernel<BLK><<<1, 1024, 0, st>>>(out, ny, nx, partials, nparts(ny, nx), err,
                                      nullptr, 0, nullptr, blk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_jacobi_fused_k(const float* pp_in, const float* rhs, float* out,
                                  float* tmp, float* partials, float* err,
                                  int ny, int nx, int k, float ax, float ay,
                                  float ar, float ac, void* stream) {
    return fused_k<false>(pp_in, rhs, out, tmp, partials, err, ny, nx, k, ax, ay, ar, ac,
                          (cudaStream_t)stream, whole(ny, nx));
}

// Kernel 11 (jacobi_pallas.py jacobi_fused_k_shard, _kernel_shard): the
// same k sweeps and BC pass on an (ny, nx) halo-extended block whose local
// (0, 0) is global (row_off, col_off) of a (gny, gnx) grid. Interior, folds
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
    return fused_k<true>(pp_in, rhs, out, tmp, partials, err, ny, nx, k, ax, ay, ar, ac,
                         (cudaStream_t)stream,
                         Block{row_off, col_off, gny, gnx, own_lo, own_hi, own_clo, own_chi});
}
