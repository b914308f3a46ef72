// Contact tick: every pair closer than the contact cutoff, listed once, over
// the pair kernel's sorted cell layout, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's block contact search,
// genome_cycle_tpu/ops/block_pairs.py::block_contact_events (XLA-fused; it has
// no Pallas kernel): a fixed-capacity event list with an overflow count,
// rerun with a larger capacity when it overflows.  Here the layout is the one
// ab_pair_forces.cu walks (beads sorted by flat cell id, a cell the range
// [cell_start[c], cell_start[c + 1]), z fastest, padded rows carrying the
// sentinel id num_cells), and the search is the half stencil of
// ops/pair_kernels.py::stencil_ranges(half=True): the own column from the own
// cell up (j > i) and the four columns (0, +1), (+1, -1), (+1, 0), (+1, +1),
// so a pair is found from its lower sorted index only.
//
// One thread per sorted row of the home range [begin, end); each block clips
// `end` to cell_start[num_cells] on the device, so padded rows are never a
// home row and the launch needs no host synchronisation.  A pair with
// r2 < cutoff2 is appended as the row [lo, hi, 1] in bead ids (`order`) at a
// slot taken from one atomic counter, aggregated over the threads of a warp
// that hit together (one atomicAdd a warp a round).  Slots past `capacity`
// are counted and not written: the wrapper reads the counter (the tick's one
// host synchronisation), and reruns the pure search with more rows when the
// count exceeds them.  The order of the rows varies from launch to launch;
// the set does not.
//
// r2 is formed as ((dx dx + dy dy) + dz dz) with rounded products and sums
// (no fused multiply-add), the order the plain version
// ops/contact.py::contact_events_reference writes out, so that a pair within
// one rounding of the cutoff falls on the same side in both.
//
// Bound: the candidate walk.  A row reads its half-stencil candidates'
// positions (16 bytes each, mostly from L1/L2: the threads of a warp walk the
// same cells) and does 9 operations on each; an event writes 12 bytes.  At the
// main path's shapes the candidates (tens of millions) dominate the events
// (hundreds of thousands), so the floor is the operations, as for the pair
// kernel's distance test.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float distance2(const float4 a, const float4 b) {
    const float dx = __fsub_rn(a.x, b.x);
    const float dy = __fsub_rn(a.y, b.y);
    const float dz = __fsub_rn(a.z, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kBlock)
contact_tick_kernel(const float4* __restrict__ xyz,       // (n) x, y, z, pad; sorted
                    const int* __restrict__ cell_id,      // (n) flat cell id; sorted
                    const int* __restrict__ cell_start,   // (cells + 1)
                    const long long* __restrict__ order,  // (n) sorted -> bead id
                    int begin, int end, int nx, int ny, int nz, float cutoff2,
                    unsigned capacity,
                    int* __restrict__ events,             // (capacity, 3) [lo, hi, 1]
                    unsigned* __restrict__ count) {       // events found, all of them
    const int home_end = min(end, cell_start[nx * ny * nz]);
    const int i = begin + static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x);
    if (i >= home_end) return;

    const float4 pi = xyz[i];
    const long long id_i = order[i];
    const int c = cell_id[i];
    const int cz = c % nz;
    const int cy = (c / nz) % ny;
    const int cx = c / (nz * ny);
    const int z_hi = min(cz + 1, nz - 1);

    // The half stencil: (ox, oy) = (0, 0), (0, 1), (1, -1), (1, 0), (1, 1).
#pragma unroll 1
    for (int q = 0; q < 5; ++q) {
        const int ox = q < 2 ? 0 : 1;
        const int oy = q == 0 ? 0 : (q == 1 ? 1 : q - 3);
        const int x = cx + ox;
        const int y = cy + oy;
        if (x >= nx || y < 0 || y >= ny) continue;
        const int column = (x * ny + y) * nz;
        const int z_lo = q == 0 ? cz : max(cz - 1, 0);
        const int j_end = cell_start[column + z_hi + 1];
        for (int j = max(cell_start[column + z_lo], i + 1); j < j_end; ++j) {
            if (distance2(pi, xyz[j]) < cutoff2) {
                // The threads of the warp that hit in this round take
                // consecutive slots from one atomicAdd.
                cg::coalesced_group hit = cg::coalesced_threads();
                unsigned base = 0;
                if (hit.thread_rank() == 0) base = atomicAdd(count, hit.size());
                const unsigned slot = hit.shfl(base, 0) + hit.thread_rank();
                if (slot < capacity) {
                    const long long id_j = order[j];
                    events[3 * slot + 0] = static_cast<int>(min(id_i, id_j));
                    events[3 * slot + 1] = static_cast<int>(max(id_i, id_j));
                    events[3 * slot + 2] = 1;
                }
            }
        }
    }
}

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing.  `count`
// must hold 0 on entry; it ends holding the number of pairs found, which may
// exceed `capacity` (then only the first `capacity` rows were written).
// Returns cudaGetLastError().
extern "C" int contact_tick_launch(const void* xyz, const void* cell_id,
                                   const void* cell_start, const void* order,
                                   int begin, int end, int nx, int ny, int nz,
                                   float cutoff2, unsigned capacity,
                                   void* events, void* count, void* stream) {
    if (end <= begin) return 0;
    const dim3 grid((end - begin + kBlock - 1) / kBlock);
    contact_tick_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(xyz), static_cast<const int*>(cell_id),
        static_cast<const int*>(cell_start), static_cast<const long long*>(order),
        begin, end, nx, ny, nz, cutoff2, capacity,
        static_cast<int*>(events), static_cast<unsigned*>(count));
    return static_cast<int>(cudaGetLastError());
}
