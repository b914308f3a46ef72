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
// The three z-neighbours of a cell column are contiguous in the flat id (z
// runs fastest), so the 27-cell stencil is 9 contiguous ranges; grid edges are
// handled by clipping the ranges, not by a wrap-around.  Each pair is
// evaluated from both ends, so there are no atomics.
//
// Bound: float32 arithmetic outside the tensor cores.  About 35 operations per
// candidate pair against 32 bytes read per bead (16 position + 8 factors + 4
// cell id + 4 cell start) and 12 or 16 written; at hundreds to thousands of
// candidates per bead the byte time is far below the operation time.  The
// tensor cores are of no use: the only product, x_i . x_j, has depth 3, and the
// cutoff test needs r2 to about 1e-6 relative at coordinates of 2.4 and
// distances of 0.15, which the ten mantissa bits of TF32 do not give.
//
// Two kernels live here.
//
// ab_pair_forces_cell_kernel is the one the package runs.  What it does about
// what held the first version back:
//
// 1. A block owns a run of kRun consecutive sorted beads and works through it
//    one home cell at a time (a "segment": the beads of the run that share a
//    cell).  All beads of a segment share one stencil, so its nine ranges are
//    read once per segment, by nine threads.  The grid is ceil(rows / kRun)
//    blocks over the rows of the home range (item 6): an empty cell costs
//    nothing because no block is made for it, a cell denser than kRun is
//    spread over several blocks, and the work of a
//    block is bounded by kRun beads whatever the density, so there is no
//    capacity, no overflow and no long tail behind one dense cell.
// 2. The neighbours go through shared memory.  The nine ranges, laid end to
//    end, are cut into tiles of kTile beads (position 16 bytes, factors 8);
//    cp.async copies the next tile while this one is computed (two buffers).
// 3. Several threads per bead.  A bead's candidates are split over `lanes`
//    neighbouring threads of a warp, kLanes at least and as many more (up to
//    32) as a short segment leaves room for in the block, each striding
//    through the tile; lanes of one bead read neighbouring entries, lanes of
//    different beads the same entry (a broadcast).  The loop is compiled once
//    for each lane count, so that its stride is a constant and it unrolls into
//    shared-memory reads at fixed offsets.  The partial sums of a bead's lanes
//    are combined by a fixed-order __shfl_xor_sync reduction and stored by
//    lane 0.
//    The order of every sum is fixed by the layout alone: two launches on one
//    layout give the same bits.
// 4. Cheap rejection.  r2 and one multiply decide whether the pair lies inside
//    the larger core diameter; only then are the factors read and the two
//    softcore terms computed.  Beyond it both cores clamp to zero, so only
//    zero terms are dropped: exactly so in the plain version; here the
//    compiler fuses 1 - r2/d^2 into one multiply-add while the test rounds
//    the product, so a pair within one rounding of the diameter can be
//    dropped with a core of about 1e-7, a term of about 1e-14 of a typical
//    one.  The bead itself is not tested for in the
//    loop: at r2 = 0 its force term is exactly zero, and only the energy
//    kernel, inside the branch, leaves its own pair out.
// 5. The result is written in bead order through `order`; no un-sort pass.
// 6. A home range.  The launch covers the sorted rows [begin, end) only; the
//    rows of a padded buffer (a rank's own beads and halo bands) carry the
//    sentinel cell id num_cells, sort after every bead and lie in no range,
//    and each block clips `end` to cell_start[num_cells], the count of rows
//    that take part, before it reads a cell id.  So the launch needs no host
//    synchronisation to learn how many rows are real, and a sentinel row is
//    never a home bead (its cell_start[c + 1] would lie past the end).  The
//    caller zeroes the rows that are not written.
//
// ab_pair_forces_thread_per_bead_kernel is the first version (one thread per
// sorted bead walking its ranges in global memory, result in sorted order).
// It is kept, under its own entry point, as the yardstick the new kernel is
// timed against within one run; the package does not run it.

#include <cuda_runtime.h>

namespace {

// The work split's constants, as measured best on an H100 over the dense and
// the decondensed nucleus (tune_pair_kernel.py at the root of the repository
// times other values in copies of this file).
constexpr int kBlock = 128;       // threads a block
constexpr int kLanes = 8;         // threads a bead, at least
constexpr int kTile = 512;        // beads a shared-memory tile
constexpr int kWiden = 1;         // a short segment gives its beads more lanes
constexpr int kUnroll = 4;        // candidates a lane takes per turn of its loop
constexpr int kMinBlocks = 1;     // blocks an SM must hold (caps the registers)
constexpr int kRun = kBlock / kLanes;   // sorted beads a block owns

constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }
constexpr int kLanesShift = log2_of(kLanes);
constexpr unsigned kFullWarp = 0xffffffffu;

static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "lanes per bead: a power of two within a warp");
static_assert(kBlock % 32 == 0 && kBlock >= 32 && kBlock <= 1024, "whole warps");
static_assert(kTile >= 1 && kTile * 24 * 2 <= 48 * 1024, "two tiles fit static shared memory");

__device__ __forceinline__ void copy_async_16(void* shared, const void* global) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(shared));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(global) : "memory");
}

__device__ __forceinline__ void copy_async_8(void* shared, const void* global) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(shared));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(global) : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest group of this thread's copies is in flight.
__device__ __forceinline__ void copy_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of tile `t` of the stencil (entries [t kTile, (t + 1) kTile)
// of the nine ranges laid end to end) into one buffer.
__device__ __forceinline__ void stage_tile(int t, int total, const int* s_begin,
                                           const int* s_prefix,
                                           const float4* __restrict__ xyz,
                                           const float2* __restrict__ ab,
                                           float4* tile_xyz, float2* tile_ab) {
    const int base = t * kTile;
    const int length = min(kTile, total - base);
    for (int k = threadIdx.x; k < length; k += kBlock) {
        const int v = base + k;
        // The range that holds entry v: the last one that starts at or before
        // it (an empty range starts where the next one does).
        int r = 0;
#pragma unroll
        for (int q = 1; q < 9; ++q) r += (v >= s_prefix[q]);
        const int j = s_begin[r] + (v - s_prefix[r]);
        copy_async_16(&tile_xyz[k], &xyz[j]);
        copy_async_8(&tile_ab[k], &ab[j]);
    }
}

struct PairConstants {
    float e_a, inv_da2, e_b, inv_db2, ka, kb, inv_reach2;
};

// One bead's share of one tile: its lane takes every (1 << shift)-th entry.
// `shift` is uniform over the block; it is matched against the template
// parameter so that the stride of the loop is a compile-time constant.
template <bool kWithEnergy, int kShift>
__device__ __forceinline__ void scan_tile(int shift,
                                          const float4* __restrict__ tile_xyz,
                                          const float2* __restrict__ tile_ab,
                                          int length, int lane, int self_here,
                                          const float4 pi, const float2 fi,
                                          const PairConstants& pair,
                                          float& fx, float& fy, float& fz, float& u) {
    if constexpr (kShift < 5) {
        if (shift != kShift) {
            scan_tile<kWithEnergy, kShift + 1>(shift, tile_xyz, tile_ab, length, lane,
                                               self_here, pi, fi, pair, fx, fy, fz, u);
            return;
        }
    }
#pragma unroll kUnroll
    for (int v = lane; v < length; v += 1 << kShift) {
        const float4 pj = tile_xyz[v];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        const float r2 = dx * dx + dy * dy + dz * dz;
        // The bead itself passes (r2 = 0): its force term is exactly zero, as
        // that of any coincident bead; only its energy has to be left out.
        if (r2 * pair.inv_reach2 < 1.0f) {
            const float2 fj = tile_ab[v];
            const float a_mix = 0.5f * (fi.x + fj.x);
            const float b_mix = 0.5f * (fi.y + fj.y);

            // softcore<2,3>: c = 6 e/d^2 (1 - s)^2, u = e (1 - s)^3
            const float core_a = fmaxf(1.0f - r2 * pair.inv_da2, 0.0f);
            // softcore<8,3>: c = 24 e/d^2 s^3 (1 - s^4)^2, u = e (1 - s^4)^3
            const float s_b = r2 * pair.inv_db2;
            const float s_b2 = s_b * s_b;
            const float core_b = fmaxf(1.0f - s_b2 * s_b2, 0.0f);

            const float coeff = a_mix * pair.ka * core_a * core_a +
                                b_mix * pair.kb * s_b * s_b2 * core_b * core_b;
            fx += coeff * dx;
            fy += coeff * dy;
            fz += coeff * dz;
            if (kWithEnergy && v != self_here) {
                u += a_mix * pair.e_a * core_a * core_a * core_a +
                     b_mix * pair.e_b * core_b * core_b * core_b;
            }
        }
    }
}

template <bool kWithEnergy>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
ab_pair_forces_cell_kernel(const float4* __restrict__ xyz,        // (n) x, y, z, pad; sorted
                           const float2* __restrict__ ab,         // (n) a, b factors; sorted
                           const int* __restrict__ cell_id,       // (n) flat cell id; sorted
                           const int* __restrict__ cell_start,    // (cells + 1)
                           const long long* __restrict__ order,   // (n) sorted -> bead id
                           int begin, int end,                    // home range, sorted rows
                           int nx, int ny, int nz,
                           float e_a, float inv_da2, float e_b, float inv_db2,
                           float* __restrict__ forces,            // (n, 3); bead order
                           float* __restrict__ energy) {          // (n) bead order, or unused
    __shared__ __align__(16) float4 s_xyz[2][kTile];
    __shared__ __align__(8) float2 s_ab[2][kTile];
    __shared__ int s_begin[9];     // first sorted index of each stencil range
    __shared__ int s_prefix[10];   // entries before each range; [9] = all

    const int tid = threadIdx.x;
    // Rows past cell_start[num_cells] are padding (sentinel cell id).
    const int home_end = min(end, cell_start[nx * ny * nz]);
    const int run_begin = begin + static_cast<int>(blockIdx.x) * kRun;
    const int run_end = min(home_end, run_begin + kRun);

    const PairConstants pair = {e_a, inv_da2, e_b, inv_db2,
                                6.0f * e_a * inv_da2, 24.0f * e_b * inv_db2,
                                // Both cores vanish where r2/d^2 >= 1 for the
                                // larger diameter: with the smaller 1/d^2 the
                                // rounded quotient is the smaller one.
                                fminf(inv_da2, inv_db2)};

    int seg_begin = run_begin;
    while (seg_begin < run_end) {
        const int c = cell_id[seg_begin];
        const int seg_end = min(run_end, cell_start[c + 1]);
        const int beads = seg_end - seg_begin;

        // ---- the stencil of the home cell: nine ranges and their prefix ----
        if (tid < 32) {
            int range_begin = 0, length = 0;
            if (tid < 9) {
                const int cz = c % nz;
                const int cy = (c / nz) % ny;
                const int cx = c / (nz * ny);
                const int x = cx + tid / 3 - 1;
                const int y = cy + tid % 3 - 1;
                if (x >= 0 && x < nx && y >= 0 && y < ny) {
                    const int column = (x * ny + y) * nz;
                    range_begin = cell_start[column + max(cz - 1, 0)];
                    length = cell_start[column + min(cz + 1, nz - 1) + 1] - range_begin;
                }
            }
            int inclusive = length;
#pragma unroll
            for (int o = 1; o < 16; o <<= 1) {
                const int up = __shfl_up_sync(kFullWarp, inclusive, o);
                if (tid >= o) inclusive += up;
            }
            if (tid < 9) {
                s_begin[tid] = range_begin;
                s_prefix[tid] = inclusive - length;
            }
            if (tid == 8) s_prefix[9] = inclusive;
        }
        __syncthreads();
        const int total = s_prefix[9];

        // ---- threads to beads: `lanes` neighbouring threads a bead ---------
        int shift = kLanesShift;
        if (kWiden) {
            while (shift < 5 && (beads << (shift + 1)) <= kBlock) ++shift;
        }
        const int lanes = 1 << shift;
        const int bead = tid >> shift;
        const int lane = tid & (lanes - 1);
        const bool active = bead < beads;
        const int i = seg_begin + bead;

        float4 pi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float2 fi = make_float2(0.0f, 0.0f);
        int self = -1;   // where i itself sits among the stencil's entries
        if (active) {
            pi = xyz[i];
            fi = ab[i];
            self = s_prefix[4] + (i - s_begin[4]);
        }
        float fx = 0.0f, fy = 0.0f, fz = 0.0f, u = 0.0f;

        // ---- the tiles, the next one in flight while this one is computed ---
        const int tiles = (total + kTile - 1) / kTile;
        stage_tile(0, total, s_begin, s_prefix, xyz, ab, s_xyz[0], s_ab[0]);
        copy_async_commit();
        for (int t = 0; t < tiles; ++t) {
            if (t + 1 < tiles) {
                stage_tile(t + 1, total, s_begin, s_prefix, xyz, ab,
                           s_xyz[(t + 1) & 1], s_ab[(t + 1) & 1]);
            }
            copy_async_commit();
            copy_async_wait_all_but_newest();   // this thread's part of tile t
            __syncthreads();                    // everyone's part of tile t

            if (active) {
                scan_tile<kWithEnergy, kLanesShift>(
                    shift, s_xyz[t & 1], s_ab[t & 1], min(kTile, total - t * kTile), lane,
                    self - t * kTile, pi, fi, pair, fx, fy, fz, u);
            }
            __syncthreads();   // tile t is free to be overwritten
        }

        // ---- the lanes of a bead add up, in a fixed order -------------------
        for (int o = lanes >> 1; o > 0; o >>= 1) {
            fx += __shfl_xor_sync(kFullWarp, fx, o);
            fy += __shfl_xor_sync(kFullWarp, fy, o);
            fz += __shfl_xor_sync(kFullWarp, fz, o);
            if (kWithEnergy) u += __shfl_xor_sync(kFullWarp, u, o);
        }
        if (active && lane == 0) {
            const long long out = order[i];
            forces[3 * out + 0] = fx;
            forces[3 * out + 1] = fy;
            forces[3 * out + 2] = fz;
            if (kWithEnergy) energy[out] = 0.5f * u;
        }
        seg_begin = seg_end;
    }
}

constexpr int kThreadsPerBeadBlock = 128;

template <bool kWithEnergy>
__global__ void __launch_bounds__(kThreadsPerBeadBlock)
ab_pair_forces_thread_per_bead_kernel(
        const float4* __restrict__ xyz,       // (n) x, y, z, pad; sorted
        const float2* __restrict__ ab,        // (n) a, b factors; sorted
        const int* __restrict__ cell_id,      // (n) flat cell id; sorted
        const int* __restrict__ cell_start,   // (cells + 1)
        int n, int nx, int ny, int nz,
        float e_a, float inv_da2, float e_b, float inv_db2,
        float* __restrict__ forces,           // (n, 3); sorted order
        float* __restrict__ energy) {         // (n) or unused
    const int i = blockIdx.x * kThreadsPerBeadBlock + threadIdx.x;
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

                const float core_a = fmaxf(1.0f - r2 * inv_da2, 0.0f);
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

// Both launch on `stream`, do not synchronise and allocate nothing.  `energy`
// may be null, which selects the force-only kernel.  They return
// cudaGetLastError().

// The kernel the package runs: forces (n, 3) and energy (n) in bead order, for
// the sorted rows [begin, end) that are not padding; the other rows are left
// as they are.
extern "C" int ab_pair_forces_launch(const void* xyz, const void* ab,
                                     const void* cell_id, const void* cell_start,
                                     const void* order,
                                     int begin, int end, int nx, int ny, int nz,
                                     float e_a, float inv_da2, float e_b, float inv_db2,
                                     void* forces, void* energy, void* stream) {
    if (end <= begin) return 0;
    const dim3 grid((end - begin + kRun - 1) / kRun);
    const dim3 block(kBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (energy != nullptr) {
        ab_pair_forces_cell_kernel<true><<<grid, block, 0, s>>>(
            static_cast<const float4*>(xyz), static_cast<const float2*>(ab),
            static_cast<const int*>(cell_id), static_cast<const int*>(cell_start),
            static_cast<const long long*>(order),
            begin, end, nx, ny, nz, e_a, inv_da2, e_b, inv_db2,
            static_cast<float*>(forces), static_cast<float*>(energy));
    } else {
        ab_pair_forces_cell_kernel<false><<<grid, block, 0, s>>>(
            static_cast<const float4*>(xyz), static_cast<const float2*>(ab),
            static_cast<const int*>(cell_id), static_cast<const int*>(cell_start),
            static_cast<const long long*>(order),
            begin, end, nx, ny, nz, e_a, inv_da2, e_b, inv_db2,
            static_cast<float*>(forces), nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}

// The first version: forces (n, 3) and energy (n) in sorted order.
extern "C" int ab_pair_forces_thread_per_bead_launch(
        const void* xyz, const void* ab, const void* cell_id, const void* cell_start,
        int n, int nx, int ny, int nz,
        float e_a, float inv_da2, float e_b, float inv_db2,
        void* forces, void* energy, void* stream) {
    if (n <= 0) return 0;
    const dim3 grid((n + kThreadsPerBeadBlock - 1) / kThreadsPerBeadBlock);
    const dim3 block(kThreadsPerBeadBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (energy != nullptr) {
        ab_pair_forces_thread_per_bead_kernel<true><<<grid, block, 0, s>>>(
            static_cast<const float4*>(xyz), static_cast<const float2*>(ab),
            static_cast<const int*>(cell_id), static_cast<const int*>(cell_start),
            n, nx, ny, nz, e_a, inv_da2, e_b, inv_db2,
            static_cast<float*>(forces), static_cast<float*>(energy));
    } else {
        ab_pair_forces_thread_per_bead_kernel<false><<<grid, block, 0, s>>>(
            static_cast<const float4*>(xyz), static_cast<const float2*>(ab),
            static_cast<const int*>(cell_id), static_cast<const int*>(cell_start),
            n, nx, ny, nz, e_a, inv_da2, e_b, inv_db2,
            static_cast<float*>(forces), nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}
