// A chunk of Brownian-dynamics steps of one mitotic coarse system, for
// NVIDIA Hopper (sm_90a): the anaphase, the telophase or the prometaphase,
// K steps in one launch.
//
// The JAX package has no Pallas kernel for this work: each phase compiles one
// jax.lax.scan over a sampling_interval chunk of model.step into a single
// device program (the JAX package's models/anatelophase.py:185-195 and
// models/prometaphase.py:193-207).  Eager PyTorch runs each
// step as about a hundred small launches (models/anatelophase.py::forces,
// models/prometaphase.py::forces, ops/integrator.py::bd_update); this kernel
// runs the K steps of a chunk (1,000 at the reference's sampling_interval)
// as one launch.  A step computes, for every bead i:
//   - the dense softcore<2,3> repulsion over all other beads, cut at the core
//     diameter d: F_i += 6 e / d^2 sum_j max(1 - r_ij^2 / d^2, 0)^2 (x_i - x_j);
//   - the bead's own term slots, from a table built once on the host
//     (ops/mitotic.py::term_table): semispring bonds to its partners (chain
//     bonds; in prometaphase the sister cohesion too), the cosine bending of
//     every triple it belongs to in its role there (i, j or k), and the
//     kinetochore spring toward its fiber's pole;
//   - the point sources every bead feels: the telophase packing well at the
//     origin (semispring), or the prometaphase polar ejection from both poles
//     (force flux);
//   - then the update x + mu F dt + sqrt(2 mu kT dt) xi with the chunk's
//     standard normals xi, one (N, 3) slab a step.
// Each bead sums its own terms, so there is no atomic and no scatter: two
// launches give the same bits.  Forces are float32, as in the eager step; no
// term is a small difference of two large numbers (the bonds and springs
// take r - l from r = sqrt(r^2) directly), so none is widened.
//
// Bound and design.  A step is 9 N^2 operations of the distance test and the
// repulsion's arithmetic (0.18 us at 1,152 beads on 67 TFLOP/s) against 12 N
// bytes of noise read (0.004 us at 3.35 TB/s): operations.  What holds it
// instead is that a step depends on the whole last step: N is far too small
// to fill the card, and the host's launch latency (a few microseconds) would
// be the floor of a launch a step.  So:
//   - one thread-block cluster runs the whole system and all K steps; block b
//     owns rows [b P, b P + P), P = ceil(N / cluster size);
//   - every block keeps a copy of all N positions in shared memory as float4
//     (one 128-bit load a partner), double buffered: a step reads one buffer
//     and writes the other, so one cluster barrier a step is enough;
//   - `lanes` threads share a row's walk over the N beads, strided, and sum
//     it by warp shuffles (xor butterfly: every lane ends with the same bits);
//     the row's term slots and point sources are spread over the same lanes
//     before the butterfly;
//   - each row's new position is written into every block's other buffer
//     through distributed shared memory (cluster.map_shared_rank), one lane a
//     block; nothing returns to global memory until the last step, which
//     writes the output;
//   - the next step's noise rows of the block are prefetched with cp.async
//     into a second shared buffer while this step's forces are computed;
//   - the term table and the fiber arrays stay in global memory, read
//     through the read-only cache (a block reads its own rows' slots, some
//     20 KB, every step: they stay in L1).
// The cluster is kCluster = 16 blocks (the non-portable size), 16 of the
// card's 132 SMs; one cluster a system.  The walk over all pairs is spread
// over the cluster's SMs, so the step shortens with the cluster: on the H100
// a cluster of 16 ran a step 1.7 to 1.9 times as fast as one of 8, the
// portable size (PERF.md).
// Shared memory a block: 32 N + 24 ceil(N / 16) bytes, so the system must fit
// 6,938 beads in the H100's 227 KB; the wrapper states the exact capacity and
// refuses more.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The launch's arguments, filled by the wrapper (its ctypes copy,
// ops/mitotic.py::_ChunkArgs, must match field for field).
struct ChunkArgs {
    const float* x;             // (N, 3): positions at the chunk's start
    const float* noise;         // (K, N, 3): standard normals, a slab a step
    const float* mobility;      // (N,)
    const int* terms;           // (N, W, 4): each bead's term slots
    const float* fiber_spring;  // (C,): kinetochore spring K of fiber slot c
    const float* fiber_pole;    // (C, 3): its pole
    float* out;                 // (N, 3): positions at the chunk's end
    int n;                      // beads
    int steps;                  // K
    int width;                  // W, term slots a bead
    int lanes;                  // threads a row: 1, 2, 4, 8, 16 or 32
    int sources;                // point sources, 0 to 2
    int source_kind;            // kSourceSemispring, or any other: force flux
    float rep_k6;               // 6 e / d^2 of the softcore<2,3>
    float rep_inv_d2;           // 1 / d^2
    float bond_k[2];            // semispring K of bond set 0 (chain), 1 (cohesion)
    float bond_l[2];            // and its length
    float bend_e;               // cosine bending energy
    float fiber_length;         // spring length of the kinetochore fibers
    float source[2][3];         // point source positions
    float source_a;             // semispring: K; force flux: f b^2
    float source_b;             // semispring: l; force flux: b^2
    float dt;                   // timestep
    float two_t;                // 2 kT
};

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 16;   // blocks a cluster (non-portable: above 8)
// Slot kinds of the term table: {kind, a, b, c}.
constexpr int kBond = 1;      // partner a, bond set b
constexpr int kTripleI = 2;   // triple (a, b, c), this bead its i
constexpr int kTripleJ = 3;   //                   its j
constexpr int kTripleK = 4;   //                   its k
constexpr int kFiber = 5;     // fiber slot a
constexpr int kSourceSemispring = 0;   // ops/mitotic.py's SOURCE_FORCE_FLUX is 1

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ Vec sub(float4 a, float4 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ Vec sub(float4 a, Vec b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(Vec a, Vec b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ Vec scaled(float c, Vec a) { return {c * a.x, c * a.y, c * a.z}; }

// The potentials' force coefficients c(r^2), F = c (x - partner), as
// ops/potentials.py forms them.
__device__ __forceinline__ float semispring_coeff(float r2, float k, float l) {
    const float r = sqrtf(fmaxf(r2, 1e-30f));
    return r > l ? -k * (1.0f - l / r) : 0.0f;
}

__device__ __forceinline__ float spring_coeff(float r2, float k, float l) {
    const float r = sqrtf(fmaxf(r2, 1e-30f));
    return -k * (1.0f - l / r);
}

__device__ __forceinline__ float force_flux_coeff(float r2, float fb2, float b2) {
    const float r = sqrtf(fmaxf(r2, 1e-30f));
    return fb2 / (b2 * r + r * r2);
}

// The force of one term slot (or, past the table's width, one point source)
// on the bead at `row`, position `xi`, in the step's buffer `pos`.
__device__ __forceinline__ Vec slot_force(const ChunkArgs& a, const float4* pos, int row,
                                          float4 xi, int slot) {
    if (slot >= a.width) {
        const int s = slot - a.width;
        const Vec source = s ? Vec{a.source[1][0], a.source[1][1], a.source[1][2]}
                             : Vec{a.source[0][0], a.source[0][1], a.source[0][2]};
        const Vec d = sub(xi, source);
        const float r2 = dot(d, d);
        const float c = a.source_kind == kSourceSemispring
                            ? semispring_coeff(r2, a.source_a, a.source_b)
                            : force_flux_coeff(r2, a.source_a, a.source_b);
        return scaled(c, d);
    }
    const int4 t = __ldg(reinterpret_cast<const int4*>(a.terms) + row * a.width + slot);
    if (t.x == kBond) {
        const Vec d = sub(xi, pos[t.y]);
        const float k = t.z ? a.bond_k[1] : a.bond_k[0];
        const float l = t.z ? a.bond_l[1] : a.bond_l[0];
        return scaled(semispring_coeff(dot(d, d), k, l), d);
    }
    if (t.x >= kTripleI && t.x <= kTripleK) {
        // u = e (1 - a.b / |a||b|), a = x_j - x_i, b = x_k - x_j, the norm
        // product clamped at 1e-30 as ops/bonded.py::bending_forces does.
        const float4 pi = pos[t.y], pj = pos[t.z], pk = pos[t.w];
        const Vec va = sub(pj, pi), vb = sub(pk, pj);
        const float a2 = dot(va, va), b2 = dot(vb, vb), ab = dot(va, vb);
        const float product = a2 * b2;
        const float clamped = fmaxf(product, 1e-30f);
        const float scale = a.bend_e * rsqrtf(clamped);
        const float q = product > 1e-30f ? ab / clamped : 0.0f;
        const float qa = q * b2, qb = q * a2;
        // -dU/da and -dU/db.
        const Vec ga{scale * (vb.x - qa * va.x), scale * (vb.y - qa * va.y),
                     scale * (vb.z - qa * va.z)};
        const Vec gb{scale * (va.x - qb * vb.x), scale * (va.y - qb * vb.y),
                     scale * (va.z - qb * vb.z)};
        if (t.x == kTripleI) return {-ga.x, -ga.y, -ga.z};
        if (t.x == kTripleJ) return {ga.x - gb.x, ga.y - gb.y, ga.z - gb.z};
        return gb;
    }
    if (t.x == kFiber) {
        const Vec pole{__ldg(a.fiber_pole + 3 * t.y), __ldg(a.fiber_pole + 3 * t.y + 1),
                       __ldg(a.fiber_pole + 3 * t.y + 2)};
        const Vec d = sub(xi, pole);
        return scaled(spring_coeff(dot(d, d), __ldg(a.fiber_spring + t.y), a.fiber_length), d);
    }
    return {0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// Step k's noise rows of the block into `dst`, asynchronously.
__device__ __forceinline__ void prefetch_noise(const ChunkArgs& a, int k, float* dst, int row0,
                                               int rows) {
    const float* src = a.noise + (static_cast<long long>(k) * a.n + row0) * 3;
    for (int i = static_cast<int>(threadIdx.x); i < 3 * rows; i += kThreads) {
        cp_async4(dst + i, src + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_noise() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__global__ void __launch_bounds__(kThreads, 1) mitotic_chunk_kernel(const ChunkArgs a) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int blocks = static_cast<int>(cluster.num_blocks());
    const int tid = static_cast<int>(threadIdx.x);
    const int n = a.n;
    const int lanes = a.lanes;
    const int per_block = (n + blocks - 1) / blocks;
    const int row0 = rank * per_block;
    const int rows = max(0, min(n - row0, per_block));

    extern __shared__ float4 shared[];
    float4* const buffer0 = shared;
    float4* const buffer1 = shared + n;
    float* const noise_rows = reinterpret_cast<float*>(shared + 2 * n);  // 2 x per_block x 3

    for (int i = tid; i < n; i += kThreads) {
        buffer0[i] = make_float4(a.x[3 * i], a.x[3 * i + 1], a.x[3 * i + 2], 0.0f);
    }
    prefetch_noise(a, 0, noise_rows, row0, rows);
    wait_noise();
    // Every block has started (its shared memory may be written) and holds
    // the positions and its first noise rows.
    cluster.sync();

    const int items = rows * lanes;           // (row, lane) pairs of the block
    const int lane = tid & (lanes - 1);       // lanes divides 32: a row within a warp
    const int slots = a.width + a.sources;
    for (int k = 0; k < a.steps; ++k) {
        const float4* const pos = (k & 1) ? buffer1 : buffer0;
        float4* const next = (k & 1) ? buffer0 : buffer1;
        const bool last = k + 1 == a.steps;
        if (!last) prefetch_noise(a, k + 1, noise_rows + ((k + 1) & 1) * 3 * per_block, row0, rows);
        const float* const noise_k = noise_rows + (k & 1) * 3 * per_block;
        for (int base = 0; base < items; base += kThreads) {
            if (base + (tid & ~31) >= items) break;   // the whole warp is past the rows
            const int item = base + tid;
            const bool active = item < items;
            const int local = active ? item / lanes : 0;
            const int row = row0 + local;
            const float4 xi = pos[row];
            // The repulsion: this lane's stride of the walk over all beads (the
            // bead itself adds d = 0).
            float fx = 0.0f, fy = 0.0f, fz = 0.0f;
#pragma unroll 4
            for (int j = lane; j < n; j += lanes) {
                const float4 xj = pos[j];
                const float dx = xi.x - xj.x, dy = xi.y - xj.y, dz = xi.z - xj.z;
                const float r2 = dx * dx + dy * dy + dz * dz;
                const float core = fmaxf(1.0f - r2 * a.rep_inv_d2, 0.0f);
                const float c = core * core;
                fx += c * dx;
                fy += c * dy;
                fz += c * dz;
            }
            fx *= a.rep_k6;
            fy *= a.rep_k6;
            fz *= a.rep_k6;
            for (int s = lane; s < slots; s += lanes) {
                const Vec f = slot_force(a, pos, row, xi, s);
                fx += f.x;
                fy += f.y;
                fz += f.z;
            }
            for (int offset = lanes >> 1; offset > 0; offset >>= 1) {
                fx += __shfl_xor_sync(0xffffffffu, fx, offset);
                fy += __shfl_xor_sync(0xffffffffu, fy, offset);
                fz += __shfl_xor_sync(0xffffffffu, fz, offset);
            }
            if (!active) continue;
            // x + mu F dt + sqrt(2 mu kT dt) xi (ops/integrator.py::bd_update).
            const float mu = __ldg(a.mobility + row);
            const float sigma = sqrtf(a.two_t * mu * a.dt);
            const float* const xi_n = noise_k + 3 * local;
            const float4 moved = make_float4(xi.x + mu * fx * a.dt + sigma * xi_n[0],
                                             xi.y + mu * fy * a.dt + sigma * xi_n[1],
                                             xi.z + mu * fz * a.dt + sigma * xi_n[2], 0.0f);
            if (!last) {
                for (int b = lane; b < blocks; b += lanes) {
                    cluster.map_shared_rank(next, b)[row] = moved;
                }
            } else if (lane == 0) {
                a.out[3 * row] = moved.x;
                a.out[3 * row + 1] = moved.y;
                a.out[3 * row + 2] = moved.z;
            }
        }
        wait_noise();
        // Every row of the step written into every block (and the next noise
        // rows in place) before any block reads them; no block writes a
        // buffer another still reads.  After the last step it also keeps
        // every block resident until no write into its shared memory is left.
        cluster.sync();
    }
}

}  // namespace

extern "C" {

// The layout of ChunkArgs, for the wrapper to check against its own copy.
int mitotic_chunk_args_size() { return static_cast<int>(sizeof(ChunkArgs)); }

int mitotic_chunk_threads() { return kThreads; }

// Dynamic shared memory a block takes for `n` beads: two float4 position
// buffers and two buffers of its noise rows.
long long mitotic_chunk_shared_bytes(int n) {
    const long long per_block = (n + kCluster - 1) / kCluster;
    return 2LL * n * static_cast<long long>(sizeof(float4)) + 2LL * per_block * 3 * sizeof(float);
}

int mitotic_chunk_cluster() { return kCluster; }

// The most dynamic shared memory a block may ask for on `device`.
int mitotic_chunk_shared_limit(int device) {
    int bytes = 0;
    const cudaError_t status =
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (status != cudaSuccess) return -1;
    return bytes;
}

// One cluster of kCluster blocks runs args->steps steps of the system on
// `stream`; does not synchronise and allocates nothing; `args` is read on the
// host.  Returns the first CUDA error (a refused launch never runs).
int mitotic_chunk_launch(const ChunkArgs* args, void* stream) {
    if (args->n <= 0 || args->steps <= 0) return 0;
    const long long smem = mitotic_chunk_shared_bytes(args->n);
    cudaError_t status = cudaFuncSetAttribute(
        mitotic_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (status != cudaSuccess) return static_cast<int>(status);
    status = cudaFuncSetAttribute(mitotic_chunk_kernel,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (status != cudaSuccess) return static_cast<int>(status);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kCluster, 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = kCluster;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
    status = cudaLaunchKernelEx(&config, mitotic_chunk_kernel, *args);
    if (status != cudaSuccess) return static_cast<int>(status);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
