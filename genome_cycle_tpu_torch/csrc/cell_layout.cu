// Cell layout: beads sorted by flat cell id, with the range starts of every
// cell, for NVIDIA Hopper (sm_90a).  ops/pair_kernels.py::build_cell_layout
// launches it on a CUDA tensor; build_cell_layout_reference is its plain
// version, field for field and bit for bit.
//
// Replaces no Pallas kernel: the JAX package leaves its layouts to XLA (a
// sort and a searchsorted, genome_cycle_tpu/ops/block_pairs.py::
// build_structure; an argsort, ops/pallas_kernels.py::assign_slots).  Eagerly,
// the plain version is about 25 launches a layout (coordinates, clamps,
// offsets, an eight-pass radix sort of int64 ids, a cell-edge arange,
// searchsorted, gathers and casts), and the layout is built every G1 step,
// tick, frame energy and relaxation step.
//
// Bound: bytes.  The layout reads positions and factors once and writes
// order, ids, positions, factors and the cell starts once, about 56 bytes a
// bead: 3.4 MB at 59,610 beads, 1 us at 3.35 TB/s.  Its time is the latency
// of a few dependent passes and the host's launches, so the design cuts
// both: one host call enqueues a memset and four kernels on the caller's
// stream, a stable counting sort with the cells as its buckets.  (CUB's
// radix sort over only the bits the grid needs, between a cell-id and a
// start-and-gather kernel, was ten device operations, 34 us of device and
// 44 us of host a layout at 59,610 beads on the H100 and its host; this is
// five, 12 us and 19 to 27 us.)
//   1. cell_id_kernel: a row's flat int32 id (clipped into its replica's
//      cube, moved to it; the sentinel num_cells for a padded row), counted
//      into its cell and its tile of kTile cells, one atomic for each
//      distinct id (tile) of a warp: neighbours along the chain share cells.  floor((x - lower) * (1 / cell)) with
//      rounded float32 operations: PyTorch divides a CUDA tensor by a host
//      scalar as a product with the scalar's float32 reciprocal, and a bead
//      on a cell's edge must land in the plain version's cell.
//   2. cell_scan_kernel, a block a tile: the counts' exclusive sums are the
//      cell starts (the tiles before it summed by one warp, then a block
//      scan), and cell_start[num_cells] the count of real rows, where the
//      padding starts.  (One block scanning every cell took 20 us at 19,683
//      cells and 126 us at 80,919.)
//   3. cell_scatter_kernel: a real row takes a slot in its cell's range in
//      no set order; a padded row its final place, after every real row in
//      row order (the padded rows of earlier blocks of step 1, summed by one
//      warp, and of this block before it), and is written out.
//   4. cell_gather_kernel: a slot's row counts the rows of its cell with a
//      lower index, and so finds its place in the stable order, the order of
//      torch.sort(stable=True); it writes its bead index, id, position
//      (float4, w = 0) and factors there.  Its work is the sum over cells of
//      the squared count: the main path's cells hold tens of beads, the
//      densest relaxation start a few hundred.
// Scratch (ids, slots, counts a cell and a tile, padded rows a block), laid out by
// cell_layout_scratch_bytes, is one buffer the caller holds and reuses;
// nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;          // rows a block in the row passes
constexpr int kTile = 1024;          // cells a block of the scan, one a thread
constexpr int kTileShift = 10;
constexpr size_t kAlign = 256;       // bytes; each scratch region starts on it
constexpr unsigned kFullWarp = 0xffffffffu;

size_t aligned(size_t bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

int row_blocks(int rows) { return (rows + kBlock - 1) / kBlock; }

int tiles(int cells) { return (cells + kTile - 1) / kTile; }

static_assert(kTile == 1 << kTileShift, "a tile is 2^kTileShift cells");

struct Scratch {
    int* keys;         // (rows) cell id of each row
    int* slots;        // (rows) the real rows, cell by cell
    int* counts;       // (cells) rows of each cell not yet given a slot
    int* tile_sums;    // (tiles) real rows of each tile, right after the counts
    int* pads;         // (blocks) padded rows of each block of the row passes
};

// Bytes of the scratch regions, each aligned.
struct ScratchBytes {
    size_t plane, counts, tile_sums, pads;
    ScratchBytes(int rows, int cells)
        : plane(aligned(sizeof(int) * static_cast<size_t>(rows))),
          counts(aligned(sizeof(int) * static_cast<size_t>(cells))),
          tile_sums(aligned(sizeof(int) * static_cast<size_t>(tiles(cells)))),
          pads(aligned(sizeof(int) * static_cast<size_t>(row_blocks(rows)))) {}
    size_t total() const { return 2 * plane + counts + tile_sums + pads; }
};

Scratch carve(void* base, const ScratchBytes& b) {
    char* p = static_cast<char*>(base);
    return Scratch{reinterpret_cast<int*>(p), reinterpret_cast<int*>(p + b.plane),
                   reinterpret_cast<int*>(p + 2 * b.plane),
                   reinterpret_cast<int*>(p + 2 * b.plane + b.counts),
                   reinterpret_cast<int*>(p + 2 * b.plane + b.counts + b.tile_sums)};
}

// The sum of values[0, n), by one whole warp; every lane gets it.
__device__ int warp_sum(const int* values, int n) {
    int sum = 0;
    for (int k = threadIdx.x & 31; k < n; k += 32) sum += values[k];
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFullWarp, sum, d);
    return sum;
}

__device__ unsigned lanes_below() { return (1u << (threadIdx.x & 31)) - 1u; }

struct Rows {          // what a row is read from, and the layout it is written to
    const float* x;    // (rows, 3)
    const float* af;   // (per_replica)
    const float* bf;
    int per_replica;
    long long* order;
    int* cell_id;
    float4* xyz;
    float2* ab;
};

__device__ void write_row(const Rows& r, int at, int row, int key) {
    r.order[at] = row;
    r.cell_id[at] = key;
    r.xyz[at] = make_float4(r.x[3 * row], r.x[3 * row + 1], r.x[3 * row + 2], 0.0f);
    const int bead = row % r.per_replica;
    r.ab[at] = make_float2(r.af[bead], r.bf[bead]);
}

__global__ void cell_id_kernel(const float* __restrict__ x, const unsigned char* __restrict__ valid,
                               int rows, int per_replica, int dims, float lower, float inv_cell,
                               int cells, int* __restrict__ keys, int* __restrict__ counts,
                               int* __restrict__ tile_sums, int* __restrict__ pads) {
    const int i = blockIdx.x * kBlock + threadIdx.x;   // no thread returns early: the
    const bool live = i < rows;                         // warp and block votes below
    const bool real = live && (valid == nullptr || valid[i]);
    int id = cells;
    if (real) {
        int c[3];
        for (int a = 0; a < 3; ++a) {
            float v = floorf(__fmul_rn(__fsub_rn(x[3 * i + a], lower), inv_cell));
            // Clipped as a float: the same cell as an int64 clamp for every
            // finite value, and NaN goes to 0 as the plain conversion does.
            v = fminf(fmaxf(v, 0.0f), static_cast<float>(dims - 1));
            c[a] = static_cast<int>(v);
        }
        c[0] += (dims + 1) * (i / per_replica);
        id = (c[0] * dims + c[1]) * dims + c[2];
    }
    if (live) keys[i] = id;
    const unsigned peers = __match_any_sync(kFullWarp, real ? id : -1);
    if (real && (peers & lanes_below()) == 0) atomicAdd(&counts[id], __popc(peers));
    const unsigned tile_peers = __match_any_sync(kFullWarp, real ? id >> kTileShift : -1);
    if (real && (tile_peers & lanes_below()) == 0) {
        atomicAdd(&tile_sums[id >> kTileShift], __popc(tile_peers));
    }
    if (pads != nullptr) {
        const int padded = __syncthreads_count(live && !real);
        if (threadIdx.x == 0) pads[blockIdx.x] = padded;
    }
}

__global__ void __launch_bounds__(kTile)
cell_scan_kernel(const int* __restrict__ counts, const int* __restrict__ tile_sums, int cells,
                 int* __restrict__ cell_start) {
    __shared__ int warp_sums[kTile / 32];
    __shared__ int tile_start;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp == 0) {
        const int before = warp_sum(tile_sums, blockIdx.x);
        if (lane == 0) tile_start = before;
    }
    const int c = blockIdx.x * kTile + threadIdx.x;
    const int own = c < cells ? counts[c] : 0;
    int inclusive = own;
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFullWarp, inclusive, d);
        if (lane >= d) inclusive += v;
    }
    if (lane == 31) warp_sums[warp] = inclusive;
    __syncthreads();
    if (warp == 0) {
        const int total = warp_sums[lane];
        int upto = total;
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFullWarp, upto, d);
            if (lane >= d) upto += v;
        }
        warp_sums[lane] = upto - total;
    }
    __syncthreads();
    const int start = tile_start + warp_sums[warp] + inclusive - own;
    if (c < cells) cell_start[c] = start;
    if (c == cells - 1) cell_start[cells] = start + own;     // the real rows
}

__global__ void cell_scatter_kernel(const int* __restrict__ keys, int rows, int cells,
                                    int* __restrict__ counts, const int* __restrict__ cell_start,
                                    const int* __restrict__ pads, int* __restrict__ slots,
                                    Rows out) {
    __shared__ int warp_pads[kBlock / 32];
    __shared__ int block_start;
    const int i = blockIdx.x * kBlock + threadIdx.x;
    const bool live = i < rows;
    const int key = live ? keys[i] : -1;
    const bool real = live && key < cells;
    // The warp's rows of one cell take a run of its slots with one atomic,
    // counted down from the cell's size.
    const unsigned peers = __match_any_sync(kFullWarp, real ? key : -1);
    const int leader = __ffs(peers) - 1;
    const int group = __popc(peers);
    int base = 0;
    if (real && (threadIdx.x & 31) == leader) base = atomicSub(&counts[key], group) - group;
    base = __shfl_sync(kFullWarp, base, leader);
    if (real) slots[cell_start[key] + base + __popc(peers & lanes_below())] = i;
    if (pads == nullptr) return;      // no padded rows; the same for the whole block
    // A padded row's place: after the real rows, the padded rows of earlier
    // blocks and those of this block before it.
    const bool padded = live && !real;
    const unsigned votes = __ballot_sync(kFullWarp, padded);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_pads[warp] = __popc(votes);
    if (warp == 0) {
        const int before = warp_sum(pads, blockIdx.x);
        if (threadIdx.x == 0) block_start = cell_start[cells] + before;
    }
    __syncthreads();
    if (padded) {
        int at = block_start + __popc(votes & lanes_below());
        for (int w = 0; w < warp; ++w) at += warp_pads[w];
        write_row(out, at, i, key);
    }
}

__global__ void cell_gather_kernel(const int* __restrict__ slots, const int* __restrict__ keys,
                                   const int* __restrict__ cell_start, int cells, Rows out) {
    const int p = blockIdx.x * kBlock + threadIdx.x;
    if (p >= cell_start[cells]) return;          // the real rows' slots only
    const int i = slots[p];
    const int key = keys[i];
    const int lo = cell_start[key], hi = cell_start[key + 1];
    int rank = 0;
    for (int q = lo; q < hi; ++q) rank += slots[q] < i;
    write_row(out, lo + rank, i, key);
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer cell_layout_launch takes for `rows` rows over
// `cells` cells.
unsigned long long cell_layout_scratch_bytes(int rows, int cells) {
    return ScratchBytes(rows, cells).total();
}

// The layout of `rows` = replicas * per_replica beads (positions (rows, 3)
// float32; factors af, bf of per_replica float32; valid: rows bytes or
// null) over a grid of nx * dims * dims cells, into order (rows int64),
// cell_id (rows int32), cell_start (cells + 1 int32), xyz (rows float4), ab
// (rows float2).  Launches on `stream`; does not synchronise.  Returns a
// CUDA error code.
int cell_layout_launch(const void* x, const void* valid, const void* af, const void* bf,
                       int rows, int per_replica, int dims, int nx, float lower, float inv_cell,
                       void* scratch, unsigned long long scratch_bytes, void* order,
                       void* cell_id, void* cell_start, void* xyz, void* ab, void* stream) {
    const long long cells = static_cast<long long>(nx) * dims * dims;
    if (rows < 0 || dims <= 0 || cells >= (1ll << 31) - 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* starts = static_cast<int*>(cell_start);
    if (rows == 0) {
        return static_cast<int>(cudaMemsetAsync(starts, 0, sizeof(int) * (cells + 1), s));
    }
    const int n_cells = static_cast<int>(cells);
    const ScratchBytes sizes(rows, n_cells);
    if (per_replica <= 0 || rows % per_replica != 0 || scratch_bytes < sizes.total()) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Scratch sc = carve(scratch, sizes);
    const Rows out{static_cast<const float*>(x), static_cast<const float*>(af),
                   static_cast<const float*>(bf), per_replica, static_cast<long long*>(order),
                   static_cast<int*>(cell_id), static_cast<float4*>(xyz),
                   static_cast<float2*>(ab)};
    int* pads = valid == nullptr ? nullptr : sc.pads;
    const int blocks = row_blocks(rows);

    // The counts and the tile sums after them, in one memset.
    const cudaError_t status = cudaMemsetAsync(
        sc.counts, 0, sizes.counts + sizeof(int) * tiles(n_cells), s);
    if (status != cudaSuccess) return static_cast<int>(status);
    cell_id_kernel<<<blocks, kBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<const unsigned char*>(valid), rows,
        per_replica, dims, lower, inv_cell, n_cells, sc.keys, sc.counts, sc.tile_sums, pads);
    cell_scan_kernel<<<tiles(n_cells), kTile, 0, s>>>(sc.counts, sc.tile_sums, n_cells, starts);
    cell_scatter_kernel<<<blocks, kBlock, 0, s>>>(sc.keys, rows, n_cells, sc.counts, starts,
                                                  pads, sc.slots, out);
    cell_gather_kernel<<<blocks, kBlock, 0, s>>>(sc.slots, sc.keys, starts, n_cells, out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
