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
// The home range is [begin, end) of the sorted rows; `end` is clipped on the
// device to cell_start[num_cells], so padded rows are never a home row and
// the launch needs no host synchronisation.  A pair with r2 < cutoff2 is
// written as the row [lo, hi, 1] in bead ids (`order`) at a slot taken from
// one counter; slots past `capacity` are counted and not written: the wrapper
// reads the counter (the tick's one host synchronisation) and reruns the pure
// search with more rows when the count exceeds them.  The order of the rows
// varies from launch to launch; the set does not.
//
// r2 is formed as ((dx dx + dy dy) + dz dz) with rounded products and sums
// (no fused multiply-add), the order the plain version
// ops/contact.py::contact_events_reference writes out, so that a pair within
// one rounding of the cutoff falls on the same side in both.
//
// Bound: the candidate walk.  A row tests its half-stencil candidates, 9
// operations each; an event writes 12 bytes.  At the main path's shapes the
// candidates (tens of millions) dominate the events (hundreds of thousands),
// so the floor is the operations, as for the pair kernel's distance test.
//
// One thread a sorted row walking its candidates in global memory reaches
// 0.02 of that floor.  Two things held it: the rows of the dense
// cells, whose threads walk many times the mean while the rest of the card
// idles, and the appends, one atomic on one global counter for every round
// of the warp that hits, a round trip to L2 that stalls the warp at about a
// third of its rounds.  So, as the pair kernel (ab_pair_forces.cu, items 1-3):
//   1. A block owns a run of kRun sorted rows and works through it one home
//      cell at a time (a segment).  The segment's rows share one half stencil,
//      five ranges read once by five threads; the grid is ceil(rows / kRun)
//      blocks, so a dense cell is spread over several blocks.
//   2. The ranges, laid end to end from the segment's first candidate on, are
//      copied in tiles of kTile positions by cp.async, the next tile in flight
//      while this one is tested (two buffers).
//   3. kLanes to 32 neighbouring threads share a row, striding through the
//      tile (the loop compiled once for each lane count); a row starts past
//      itself in its own column, which is the first range.
//   4. A hit takes a slot of a shared buffer of kEvents pairs by a
//      shared-memory atomic; the block adds its buffer to the global counter
//      once at its end, with one atomic, and writes the rows out in bead ids.
//      A hit past a full buffer (a very dense cell) takes its global slot at
//      once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;       // threads a block
constexpr int kLanes = 8;         // threads a row, at least
constexpr int kTile = 512;        // positions a shared-memory tile
constexpr int kEvents = 2048;     // pairs a block stages before it writes them
constexpr int kUnroll = 4;        // candidates a lane takes per turn of its loop
constexpr int kRun = kBlock / kLanes;   // sorted rows a block owns
constexpr int kRanges = 5;        // the half stencil's column ranges

constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }
constexpr int kLanesShift = log2_of(kLanes);
constexpr unsigned kFullWarp = 0xffffffffu;

static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "lanes per row: a power of two within a warp");
static_assert(kTile * 16 * 2 + kEvents * 8 <= 48 * 1024, "static shared memory");

__device__ __forceinline__ float distance2(const float4 a, const float4 b) {
    const float dx = __fsub_rn(a.x, b.x);
    const float dy = __fsub_rn(a.y, b.y);
    const float dz = __fsub_rn(a.z, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void copy_async_16(void* shared, const void* global) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(shared));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(global) : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest group of this thread's copies is in flight.
__device__ __forceinline__ void copy_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The sorted row of entry v of the ranges laid end to end: the last range
// that starts at or before it (an empty range starts where the next one does).
__device__ __forceinline__ int entry_row(int v, const int* s_begin, const int* s_prefix) {
    int r = 0;
#pragma unroll
    for (int q = 1; q < kRanges; ++q) r += (v >= s_prefix[q]);
    return s_begin[r] + (v - s_prefix[r]);
}

// Starts the copy of the positions of entries [first, first + length) into
// one tile buffer.
__device__ __forceinline__ void stage_tile(int first, int length, const int* s_begin,
                                           const int* s_prefix,
                                           const float4* __restrict__ xyz, float4* tile) {
    for (int k = threadIdx.x; k < length; k += kBlock) {
        copy_async_16(&tile[k], &xyz[entry_row(first + k, s_begin, s_prefix)]);
    }
}

// The shared part of the search: the event buffer and the stencil.
struct TickShared {
    int2 events[kEvents];      // (i, j) in sorted rows
    unsigned staged;           // hits so far, those past kEvents included
    unsigned base;             // the buffer's first global slot
    int begin[kRanges];        // first sorted row of each range
    int prefix[kRanges + 1];   // entries before each range; [kRanges] = all
};

__device__ __forceinline__ void write_event(int* events, unsigned slot,
                                            const long long* __restrict__ order, int i, int j) {
    const long long id_i = order[i], id_j = order[j];
    events[3 * slot + 0] = static_cast<int>(min(id_i, id_j));
    events[3 * slot + 1] = static_cast<int>(max(id_i, id_j));
    events[3 * slot + 2] = 1;
}

// One row's share of one tile: its lane takes every (1 << shift)-th entry
// from `start` on.  `shift` is uniform over the block; it is matched against
// the template parameter so that the stride of the loop is a compile-time
// constant.
template <int kShift>
__device__ __forceinline__ void scan_tile(int shift, const float4* __restrict__ tile,
                                          int start, int length, int first, const float4 pi,
                                          int i, float cutoff2, TickShared& sh,
                                          const long long* __restrict__ order,
                                          unsigned capacity, int* __restrict__ events,
                                          unsigned* __restrict__ count) {
    if constexpr (kShift < 5) {
        if (shift != kShift) {
            scan_tile<kShift + 1>(shift, tile, start, length, first, pi, i, cutoff2, sh,
                                  order, capacity, events, count);
            return;
        }
    }
#pragma unroll kUnroll
    for (int v = start; v < length; v += 1 << kShift) {
        if (distance2(pi, tile[v]) < cutoff2) {
            const int j = entry_row(first + v, sh.begin, sh.prefix);
            const unsigned at = atomicAdd(&sh.staged, 1u);
            if (at < kEvents) {
                sh.events[at] = make_int2(i, j);
            } else {
                const unsigned slot = atomicAdd(count, 1u);
                if (slot < capacity) write_event(events, slot, order, i, j);
            }
        }
    }
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
    __shared__ __align__(16) float4 s_tile[2][kTile];
    __shared__ TickShared sh;

    const int tid = threadIdx.x;
    // Rows past cell_start[num_cells] are padding (sentinel cell id).
    const int home_end = min(end, cell_start[nx * ny * nz]);
    const int run_begin = begin + static_cast<int>(blockIdx.x) * kRun;
    const int run_end = min(home_end, run_begin + kRun);
    if (tid == 0) sh.staged = 0;

    int seg_begin = run_begin;
    while (seg_begin < run_end) {
        const int c = cell_id[seg_begin];
        const int seg_end = min(run_end, cell_start[c + 1]);
        const int rows = seg_end - seg_begin;

        // ---- the half stencil of the home cell: five ranges, their prefix ----
        if (tid < 32) {
            int range_begin = 0, length = 0;
            if (tid < kRanges) {
                const int cz = c % nz;
                const int cy = (c / nz) % ny;
                const int cx = c / (nz * ny);
                // (ox, oy) = (0, 0), (0, 1), (1, -1), (1, 0), (1, 1).
                const int x = cx + (tid < 2 ? 0 : 1);
                const int y = cy + (tid == 0 ? 0 : (tid == 1 ? 1 : tid - 3));
                if (x < nx && y >= 0 && y < ny) {
                    const int column = (x * ny + y) * nz;
                    const int z_lo = tid == 0 ? cz : max(cz - 1, 0);
                    range_begin = cell_start[column + z_lo];
                    length = cell_start[column + min(cz + 1, nz - 1) + 1] - range_begin;
                }
            }
            int inclusive = length;
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) {
                const int up = __shfl_up_sync(kFullWarp, inclusive, o);
                if (tid >= o) inclusive += up;
            }
            if (tid < kRanges) {
                sh.begin[tid] = range_begin;
                sh.prefix[tid] = inclusive - length;
            }
            if (tid == kRanges - 1) sh.prefix[kRanges] = inclusive;
        }
        __syncthreads();
        // The own column's range starts at the own cell, so the segment's
        // first row sits at entry seg_begin - begin[0]: its candidates, and
        // every later row's, lie past it.
        const int skip = seg_begin - sh.begin[0] + 1;
        const int total = sh.prefix[kRanges];

        // ---- threads to rows: `lanes` neighbouring threads a row -----------
        int shift = kLanesShift;
        while (shift < 5 && (rows << (shift + 1)) <= kBlock) ++shift;
        const int lanes = 1 << shift;
        const int row = tid >> shift;
        const int lane = tid & (lanes - 1);
        const bool active = row < rows;
        const int i = seg_begin + row;
        const float4 pi = active ? xyz[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

        // ---- the tiles, the next one in flight while this one is tested -----
        const int tiles = total > skip ? (total - skip + kTile - 1) / kTile : 0;
        if (tiles > 0) {
            stage_tile(skip, min(kTile, total - skip), sh.begin, sh.prefix, xyz, s_tile[0]);
        }
        copy_async_commit();
        for (int t = 0; t < tiles; ++t) {
            const int first = skip + t * kTile;
            if (t + 1 < tiles) {
                stage_tile(first + kTile, min(kTile, total - first - kTile), sh.begin,
                           sh.prefix, xyz, s_tile[(t + 1) & 1]);
            }
            copy_async_commit();
            copy_async_wait_all_but_newest();   // this thread's part of tile t
            __syncthreads();                    // everyone's part of tile t
            if (active) {
                // Row `row` starts at entry skip + row, the entry after itself.
                scan_tile<kLanesShift>(shift, s_tile[t & 1], max(row - t * kTile, 0) + lane,
                                       min(kTile, total - first), first, pi, i, cutoff2, sh,
                                       order, capacity, events, count);
            }
            __syncthreads();   // tile t is free to be overwritten
        }
        __syncthreads();       // the stencil too, when there was no tile
        seg_begin = seg_end;
    }

    // ---- the block's pairs out, their slots taken at once -------------------
    __syncthreads();
    const unsigned staged = min(sh.staged, static_cast<unsigned>(kEvents));
    if (tid == 0 && staged > 0) sh.base = atomicAdd(count, staged);
    __syncthreads();
    for (unsigned k = tid; k < staged; k += kBlock) {
        const unsigned slot = sh.base + k;
        if (slot < capacity) write_event(events, slot, order, sh.events[k].x, sh.events[k].y);
    }
}

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing.  `count`
// must hold 0 on entry; it ends holding the number of pairs found, which may
// exceed `capacity` (then only `capacity` rows were written).  Returns
// cudaGetLastError().
extern "C" int contact_tick_launch(const void* xyz, const void* cell_id,
                                   const void* cell_start, const void* order,
                                   int begin, int end, int nx, int ny, int nz,
                                   float cutoff2, unsigned capacity,
                                   void* events, void* count, void* stream) {
    if (end <= begin) return 0;
    const dim3 grid((end - begin + kRun - 1) / kRun);
    contact_tick_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(xyz), static_cast<const int*>(cell_id),
        static_cast<const int*>(cell_start), static_cast<const long long*>(order),
        begin, end, nx, ny, nz, cutoff2, capacity,
        static_cast<int*>(events), static_cast<unsigned*>(count));
    return static_cast<int>(cudaGetLastError());
}
