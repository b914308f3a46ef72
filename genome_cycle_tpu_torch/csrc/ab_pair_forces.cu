// A/B copolymer pair force over sorted cell ranges, for NVIDIA Hopper (sm_90a).
//
// Replaces the fused Pallas kernel of the JAX package,
// genome_cycle_tpu/ops/pallas_kernels.py::_kernel (launched by
// ab_pair_forces_pallas).  It computes the same function,
//
//   F_i = sum_j c(r2_ij) (x_i - x_j)        over the 27 neighbour cells of i,
//   c   = a_mix * 6 e_a/d_a^2 (1 - s_a)^2  +  b_mix * 24 e_b/d_b^2 s_b^3 (1 - s_b^4)^2,
//   s   = r2/d^2,  a_mix = (a_i + a_j)/2,  b_mix = (b_i + b_j)/2,
//
// each term zero where its core (1 - s_a, 1 - s_b^4) is not positive, the self
// pair skipped, and optionally the per-bead energy (half of each pair's
// a_mix e_a (1 - s_a)^3 + b_mix e_b (1 - s_b^4)^3).  It is not the padded
// slab carried over: beads are sorted by flat cell id and a cell is the range
// [cell_start[c], cell_start[c + 1]) of that order, so there is no per-cell
// capacity, nothing can overflow and a dense cell costs only its own pairs.
//
// Design: one thread per sorted bead.  The three z-neighbours of a cell column
// are contiguous in the flat id (z runs fastest), so the 27-cell stencil is 9
// contiguous ranges; grid edges are handled by clipping the ranges, not by a
// wrap-around.  Each pair is evaluated from both ends, so there are no atomics
// and the result is bitwise reproducible.  Threads of a warp are neighbours in
// the sorted order, mostly of one cell, so their j loads coincide and are
// served as broadcasts from L1/L2.
//
// Bound: float32 arithmetic outside the tensor cores.  About 35 operations per
// candidate pair against 32 bytes read per bead (16 position + 8 factors + 4
// cell id + 4 cell start) and 12 or 16 written; at tens to hundreds of
// candidates per bead the byte time is far below the operation time.  This
// first version makes no use of shared memory and does not balance long
// ranges across threads; it is meant to be right and simple.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <bool kWithEnergy>
__global__ void __launch_bounds__(kThreads)
ab_pair_forces_kernel(const float4* __restrict__ xyz,       // (n) x, y, z, pad; sorted
                      const float2* __restrict__ ab,        // (n) a, b factors; sorted
                      const int* __restrict__ cell_id,      // (n) flat cell id; sorted
                      const int* __restrict__ cell_start,   // (cells + 1)
                      int n, int nx, int ny, int nz,
                      float e_a, float inv_da2, float e_b, float inv_db2,
                      float* __restrict__ forces,           // (n, 3); sorted order
                      float* __restrict__ energy) {         // (n) or unused
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;

    const float4 pi = xyz[i];
    const float2 fi = ab[i];
    const int c = cell_id[i];
    const int cz = c % nz;
    const int cy = (c / nz) % ny;
    const int cx = c / (nz * ny);
    const int z_lo = max(cz - 1, 0);
    const int z_hi = min(cz + 1, nz - 1);

    const float ka = 6.0f * e_a * inv_da2;
    const float kb = 24.0f * e_b * inv_db2;

    float fx = 0.0f, fy = 0.0f, fz = 0.0f, u = 0.0f;

    for (int ox = -1; ox <= 1; ++ox) {
        const int x = cx + ox;
        if (x < 0 || x >= nx) continue;
        for (int oy = -1; oy <= 1; ++oy) {
            const int y = cy + oy;
            if (y < 0 || y >= ny) continue;
            const int column = (x * ny + y) * nz;
            const int j_begin = cell_start[column + z_lo];
            const int j_end = cell_start[column + z_hi + 1];
            for (int j = j_begin; j < j_end; ++j) {
                if (j == i) continue;
                const float4 pj = xyz[j];
                const float2 fj = ab[j];
                const float dx = pi.x - pj.x;
                const float dy = pi.y - pj.y;
                const float dz = pi.z - pj.z;
                const float r2 = dx * dx + dy * dy + dz * dz;
                const float a_mix = 0.5f * (fi.x + fj.x);
                const float b_mix = 0.5f * (fi.y + fj.y);

                // softcore<2,3>: c = 6 e/d^2 (1 - s)^2, u = e (1 - s)^3
                const float core_a = fmaxf(1.0f - r2 * inv_da2, 0.0f);
                // softcore<8,3>: c = 24 e/d^2 s^3 (1 - s^4)^2, u = e (1 - s^4)^3
                const float s_b = r2 * inv_db2;
                const float s_b2 = s_b * s_b;
                const float core_b = fmaxf(1.0f - s_b2 * s_b2, 0.0f);

                const float coeff = a_mix * ka * core_a * core_a +
                                    b_mix * kb * s_b * s_b2 * core_b * core_b;
                fx += coeff * dx;
                fy += coeff * dy;
                fz += coeff * dz;
                if (kWithEnergy) {
                    u += a_mix * e_a * core_a * core_a * core_a +
                         b_mix * e_b * core_b * core_b * core_b;
                }
            }
        }
    }

    forces[3 * i + 0] = fx;
    forces[3 * i + 1] = fy;
    forces[3 * i + 2] = fz;
    if (kWithEnergy) energy[i] = 0.5f * u;
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `energy` may
// be null, which selects the force-only kernel.  Returns cudaGetLastError().
extern "C" int ab_pair_forces_launch(const void* xyz, const void* ab,
                                     const void* cell_id, const void* cell_start,
                                     int n, int nx, int ny, int nz,
                                     float e_a, float inv_da2, float e_b, float inv_db2,
                                     void* forces, void* energy, void* stream) {
    if (n <= 0) return 0;
    const dim3 grid((n + kThreads - 1) / kThreads);
    const dim3 block(kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (energy != nullptr) {
        ab_pair_forces_kernel<true><<<grid, block, 0, s>>>(
            static_cast<const float4*>(xyz), static_cast<const float2*>(ab),
            static_cast<const int*>(cell_id), static_cast<const int*>(cell_start),
            n, nx, ny, nz, e_a, inv_da2, e_b, inv_db2,
            static_cast<float*>(forces), static_cast<float*>(energy));
    } else {
        ab_pair_forces_kernel<false><<<grid, block, 0, s>>>(
            static_cast<const float4*>(xyz), static_cast<const float2*>(ab),
            static_cast<const int*>(cell_id), static_cast<const int*>(cell_start),
            n, nx, ny, nz, e_a, inv_da2, e_b, inv_db2,
            static_cast<float*>(forces), nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}
