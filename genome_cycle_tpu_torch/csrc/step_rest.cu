// The O(N) rest of a Brownian-dynamics step, for NVIDIA Hopper (sm_90a):
// chain and loop bonds, the nucleolar bonds and droplet, the ellipsoidal wall
// with its per-axis reaction, and the Euler-Maruyama update.
//
// The JAX package has no Pallas kernel for this work: XLA fuses it into a few
// device kernels of each step, genome_cycle_tpu/models/interphase.py:688-712
// (_bd_step4: bonded_forces (:425, ops/bonded.py::shift_bond_forces and
// pair_bond_forces, ops/neighbor.py::pairwise_forces_dense for the droplet),
// ops/wall.py::wall_forces by jax.value_and_grad, ops/integrator.py::bd_update,
// the wall ODE).  Eager PyTorch runs it as a couple of hundred small launches,
// the wall's autograd alone about a hundred.  Here it is one thread per bead
// row of positions (R, N, 3): R replicas of one topology, each with its own
// semiaxes.  One launch computes everything _bd_step4 computes but the pair
// force.
//
// step_rest_kernel adds to a force buffer that already holds the pair force:
//   - chain bonds (i, i+1), semispring K/s^2, l*s, where bond_mask[i];
//   - loops (i, i+2), harmonic K/s^2, where loop_mask[i];
//   each bead forms its own two (four) terms from its neighbours' positions,
//   the sums shift_bond_forces forms with rolls: no atomics;
//   - the nucleolar rows (a few dozen: the NOR beads and the nucleolar
//   particles): the NOR semisprings K_nuc/s^2, l_nuc*s, each bond read by both
//   of its ends from a small table, and the droplet, a softwell<6> among the
//   targets (force cut at the cutoff, energy shifted to zero there), which a
//   target sums over the other targets itself.  Again a row sums its own
//   terms: no atomics and no scatter;
//   - the wall: d = sqrt(r2/s2) - sqrt(r2) (taken in float64), r2 = |x|^2 + eps,
//     s2 = sum x_k^2/a_k^2 + eps, the softcore<2,3>/<8,3> at half diameters
//     weighted by wall_a, wall_b inside (d > 0), the harmonic on d^2 outside,
//     and its derivatives in closed form, not by autograd: with R = sqrt(r2/s2)
//     and c = -2 dU/d(d^2) (the potentials' force coefficient),
//       dd/dx_k = x_k [(1 - r2/(a_k^2 s2)) / (R s2) - 1/sqrt(r2)],
//       dd/da_k = r2 x_k^2 / (R s2^2 a_k^3),
//       F_k = c d dd/dx_k,   reaction_k = sum over beads of c d dd/da_k.
// It writes the forces (in place, if asked), or, given the mobility and the
// noise, the new positions x + mu F dt + sqrt(2 mu kT dt) xi out of place (the
// G1 step in one launch).  The reaction and the energies (bonded, which takes
// the nucleolar terms too, and wall) are reduced per replica without atomics
// on the values, and the block that arrives last (a ticket counter per
// replica, reset by that block) adds the blocks' partials in block order and
// moves the semiaxes by the wall ODE a + rate (reaction - spring a).  Two
// launches give the same bits.
//
// The scalars that change every G1 step (the bond scale's s^2 and s, the
// wall's e_a, 1/d_a^2, e_b, 1/d_b^2 at the core scale) come by value, or, so
// that a CUDA graph of the step can replay it, from row *step_index of a
// table on the card (ops/pair_kernels.py::StepScalars, kStepRow floats a row,
// the pair kernel's four first): the last block of the last replica to finish
// (a second ticket, tickets[R], where R > 1) then advances the index for the
// next step.
// Every block has read the row before it takes its ticket.
//
// drift_limit_kernel and bd_update_kernel are the update alone
// (ops/integrator.py::bd_update): with a displacement limit (the relaxation's
// spacestep) the first takes each replica's largest |mu F| (a max: exact in
// any order) and writes its effective timestep on the device, so the step
// needs no host synchronisation; the second moves the beads.
//
// Bound and design.  The bound is bytes: a bead reads its position, force,
// noise, mobility, masks, bond rows and wall weights once (74 bytes) and
// writes 12, against some 150 operations, far below the card's 20 operations
// a byte; at the main path's 59,610 beads that is 1.3 us at 3.35 TB/s.  A
// launch of this size is held instead by its chain of latencies: the loads,
// the float64 wall, the block's sums, the ticket and the last block's pass.
// What the design does about each:
//   - the row's own data and the semiaxes are loaded first, before the one
//     barrier, so that their latency overlaps the nucleolar scan, and the
//     warps then run to the end on their own (no staging through shared
//     memory: a barrier after the loads and one before the stores made every
//     warp wait for the slowest, and timed slower);
//   - 512 threads a block, a row each: 117 blocks, one wave on 132 SMs, half
//     the tickets and partials of 256;
//   - block sums by warp shuffles (5 levels), then one warp over the 16 warps'
//     partials; the last block's pass is one warp over the blocks' partials,
//     four loads a lane in flight, no further barrier;
//   - in the wall, the float64 chain is one sqrt and one rsqrt in parallel:
//     d = sqrt(r2) (1/sqrt(s2) - 1), with s2 from 1/a_k^2 taken while the
//     row loads, in place of four dependent divisions and roots;
//   - the nucleolar rows cost a row without them nothing from memory: one
//     warp a block finds which of the table's sorted rows fall in its range
//     (a few dozen entries, from L2); a block that holds some copies the table
//     and its rows' positions to shared memory, eight loads a lane in flight,
//     and each such row makes one call, so that the rows of a warp run their
//     terms side by side (a call in the loop over the block's rows ran them
//     one after the other, some 400 dependent loads).

#include <cuda_runtime.h>

// The launch's arguments, filled by the wrapper (its ctypes copy,
// ops/step_rest.py::_RestArgs, must match field for field) and passed to the
// kernel by value.  Outside the anonymous namespace: the C entry point takes
// it, and a type of internal linkage would give that entry point internal
// linkage too.
struct RestArgs {
    const float* x;                    // (R, N, 3)
    const float* f_in;                 // (R, N, 3) forces so far, or null
    float* out;                        // (R, N, 3) forces, or new positions
    int replicas, n;
    // Chain bonds (i, i + 1) and loops (i, i + 2), row-aligned; null: none.
    const unsigned char* bond_mask;
    const float* bond_k;
    const float* bond_l;
    const unsigned char* loop_mask;
    const float* loop_k;
    float bond_s2, bond_s;             // K / s^2, l * s
    // The nucleolar table (ops/step_rest.py::nucleolar_table); null: none.
    // int32 [rows (M, sorted) | start (M + 1) | target (M) | partner (P) |
    // targets (T)], every other entry a slot k of `rows`: the partners of
    // rows[k] are partner[start[k] .. start[k + 1]), the partner's slot at
    // the end that counts the bond's energy, ~slot at the other; target[k]
    // is its index among the droplet's targets (their slots), or -1.
    const int* nuc_table;
    int nuc_rows, nuc_partners, nuc_targets;
    float nuc_k, nuc_l;                // K_nuc, l_nuc (before the bond scale)
    float drop_e, drop_inv_d2, drop_cut2, drop_u_cut;   // softwell<6>, cutoff
    // The wall; null semiaxes: none.
    const float* semiaxes;             // (R, 3)
    const float* wall_a;               // (N)
    const float* wall_b;               // (N)
    float e_a, inv_da2, e_b, inv_db2, packing_spring;
    // The update; null mobility: `out` takes the forces.
    const float* mobility;             // (N)
    const float* noise;                // (R, N, 3)
    float dt, two_t;                   // timestep, 2 kT
    // The wall ODE; null semiaxes_out: none.
    float ode_rate;                    // dt * wall mobility
    float spring[3];
    float* semiaxes_out;               // (R, 3)
    // Reductions; null partials: none asked for.
    float* partials;                   // (R, blocks, kSums)
    unsigned* tickets;                 // (R), 0 between launches
    float* reaction;                   // (R, 3) or null
    float* energy;                     // (R, 2) bonded, wall; or null
    // The step's scalars from the card; null step_rows: by value above.
    const float* step_rows;            // (K, kStepRow)
    int* step_index;                   // the row to read; advanced by the launch
};

namespace {

constexpr int kThreads = 512;                // rows a block, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kNucRows = 256;                // nucleolar rows, at most
constexpr int kNucTable = 1024;              // ints of the nucleolar table, at most
constexpr int kCopy = 8;                     // the table's loads a lane keeps in flight
constexpr int kUpdateThreads = 256;
constexpr int kSums = 5;        // reaction x, y, z; bonded energy; wall energy
constexpr int kStepRow = 16;    // floats a row of the per-step table
constexpr double kWallEps = 1e-12;
constexpr unsigned kFullWarp = 0xffffffffu;

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ Vec load3(const float* p, long long row) {
    return Vec{p[3 * row], p[3 * row + 1], p[3 * row + 2]};
}

__device__ __forceinline__ void store3(float* p, long long row, Vec v) {
    p[3 * row] = v.x;
    p[3 * row + 1] = v.y;
    p[3 * row + 2] = v.z;
}

__device__ __forceinline__ Vec plus(Vec a, Vec b) { return Vec{a.x + b.x, a.y + b.y, a.z + b.z}; }

__device__ __forceinline__ Vec minus(Vec a, Vec b) { return Vec{a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ Vec scale(float c, Vec d) { return Vec{c * d.x, c * d.y, c * d.z}; }

__device__ __forceinline__ float norm2(Vec d) { return d.x * d.x + d.y * d.y + d.z * d.z; }

// semispring: c = -k (1 - l/r) where r > l, else 0; u = k/2 max(r - l, 0)^2.
__device__ __forceinline__ float semispring(float r2, float k, float l, float& u) {
    const float r = sqrtf(fmaxf(r2, 1e-30f));
    const float stretch = fmaxf(r - l, 0.0f);
    u = 0.5f * k * stretch * stretch;
    return r > l ? -k * (1.0f - l / r) : 0.0f;
}

// Fixed-order sum over the lanes of a warp: lane 0 holds it.
__device__ __forceinline__ void warp_sum(float* v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) v[k] += __shfl_down_sync(kFullWarp, v[k], o);
    }
}

// The nucleolar terms of the row in slot k of the table into f and the bonded
// energy, from the block's copies in shared memory: the table and the
// positions of its rows; bond_s2, bond_s at the step's bond scale.
__device__ __forceinline__ void nucleolar_row(const RestArgs& a, int k, const int* table,
                                              const float* nuc_x, float bond_s2, float bond_s,
                                              Vec& f, float& energy) {
    const int* start = table + a.nuc_rows;
    const int* target = start + a.nuc_rows + 1;
    const int* partner = target + a.nuc_rows;
    const int* targets = partner + a.nuc_partners;
    const Vec p = load3(nuc_x, k);
    const float k_nuc = a.nuc_k / bond_s2;
    const float l_nuc = a.nuc_l * bond_s;
    for (int e = start[k]; e < start[k + 1]; ++e) {
        const int code = partner[e];
        const Vec d = minus(p, load3(nuc_x, code >= 0 ? code : ~code));
        float u;
        const float c = semispring(norm2(d), k_nuc, l_nuc, u);
        f = plus(f, scale(c, d));
        if (code >= 0) energy += u;
    }
    const int own = target[k];
    if (own < 0) return;
    // softwell<6>: u = -e / (1 + t), c = -6 e t / (r2 (1 + t)^2), t = (r2/d^2)^3,
    // with t / r2 = r2^2 / d^6: one division a pair.
    const float inv_d6 = a.drop_inv_d2 * a.drop_inv_d2 * a.drop_inv_d2;
    for (int q = 0; q < a.nuc_targets; ++q) {
        if (q == own) continue;
        const Vec d = minus(p, load3(nuc_x, targets[q]));
        const float r2 = norm2(d);
        if (!(r2 < a.drop_cut2)) continue;
        const float r4 = r2 * r2;
        const float inv_one_t = 1.0f / (1.0f + r4 * r2 * inv_d6);
        const float c = -6.0f * a.drop_e * r4 * inv_d6 * inv_one_t * inv_one_t;
        f = plus(f, scale(c, d));
        energy += 0.5f * (-a.drop_e * inv_one_t - a.drop_u_cut);
    }
}

__global__ void __launch_bounds__(kThreads) step_rest_kernel(const RestArgs a) {
    __shared__ int s_nuc_slot[kNucRows];     // the block's nucleolar rows
    __shared__ int s_nuc_row[kNucRows];
    __shared__ int s_nuc_count;
    __shared__ int s_nuc_table[kNucTable];   // the table, where the block has some
    __shared__ float s_nuc_x[3 * kNucRows];  // and the positions of all its rows
    __shared__ float s_warp[kWarps][kSums];

    const int r = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b0 = static_cast<int>(blockIdx.x) * kThreads;
    const int rows = min(kThreads, a.n - b0);
    const int i = b0 + tid;
    const long long base = static_cast<long long>(r) * a.n;
    const long long row = base + i;
    const bool live = tid < rows;

    // ---- this row's data and the wall's reciprocals, loaded before the -----
    // ---- barrier so that their latency overlaps the nucleolar scan ----------
    Vec p{0.0f, 0.0f, 0.0f}, f{0.0f, 0.0f, 0.0f}, xi{0.0f, 0.0f, 0.0f};
    if (live) {
        p = load3(a.x, row);
        if (a.f_in) f = load3(a.f_in, row);
        if (a.mobility) xi = load3(a.noise, row);
    }
    float ax = 1.0f, ay = 1.0f, az = 1.0f;
    if (a.semiaxes) {
        ax = a.semiaxes[3 * r];
        ay = a.semiaxes[3 * r + 1];
        az = a.semiaxes[3 * r + 2];
    }
    const Vec inv_a2{1.0f / (ax * ax), 1.0f / (ay * ay), 1.0f / (az * az)};
    const double wix = 1.0 / (static_cast<double>(ax) * ax);
    const double wiy = 1.0 / (static_cast<double>(ay) * ay);
    const double wiz = 1.0 / (static_cast<double>(az) * az);
    // The step's scalars, by value or from the step's row on the card.
    float bond_s2 = a.bond_s2, bond_s = a.bond_s;
    float e_a = a.e_a, inv_da2 = a.inv_da2, e_b = a.e_b, inv_db2 = a.inv_db2;
    if (a.step_rows) {
        const float* step_row = a.step_rows + static_cast<long long>(kStepRow) * *a.step_index;
        bond_s2 = step_row[4];
        bond_s = step_row[5];
        e_a = step_row[6];
        inv_da2 = step_row[7];
        e_b = step_row[8];
        inv_db2 = step_row[9];
    }

    // ---- the block's nucleolar rows, found by one warp ----------------------
    if (warp == 0) {
        int count = 0;
        if (a.nuc_table) {
            for (int k0 = 0; k0 < a.nuc_rows; k0 += 32) {
                const int k = k0 + lane;
                const int nuc_row = k < a.nuc_rows ? a.nuc_table[k] : -1;
                const bool mine = nuc_row >= b0 && nuc_row < b0 + rows;
                const unsigned hit = __ballot_sync(kFullWarp, mine);
                if (mine) {
                    const int at = count + __popc(hit & ((1u << lane) - 1u));
                    s_nuc_slot[at] = k;
                    s_nuc_row[at] = nuc_row;
                }
                count += __popc(hit);
            }
            // A block with nucleolar rows copies the table and the positions
            // of its rows (the wrapper holds them to kNucTable and kNucRows)
            // to shared memory, kCopy loads a lane in flight at once, so that
            // a row's terms need no dependent load from device memory.
            if (count > 0) {
                const int length = 3 * a.nuc_rows + 1 + a.nuc_partners + a.nuc_targets;
                for (int v0 = 0; v0 < length; v0 += 32 * kCopy) {
                    int held[kCopy];
#pragma unroll
                    for (int u = 0; u < kCopy; ++u) {
                        const int v = v0 + 32 * u + lane;
                        held[u] = v < length ? a.nuc_table[v] : 0;
                    }
#pragma unroll
                    for (int u = 0; u < kCopy; ++u) {
                        const int v = v0 + 32 * u + lane;
                        if (v < length) s_nuc_table[v] = held[u];
                    }
                }
                for (int k = lane; k < a.nuc_rows; k += 32) {
                    store3(s_nuc_x, k, load3(a.x, base + a.nuc_table[k]));
                }
            }
        }
        if (lane == 0) s_nuc_count = count;
    }
    __syncthreads();
    int nuc_slot = -1;
    for (int q = 0; q < s_nuc_count; ++q) {
        if (s_nuc_row[q] == i) nuc_slot = s_nuc_slot[q];
    }

    float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
        if (a.bond_mask) {
            // shift_bond_forces: row i holds the bond to i + k; bead i gets
            // f[i] - f[i - k] of f[j] = c_j (x_j - x_{j+k}).
            Vec bonded{0.0f, 0.0f, 0.0f};
            float u;
            if (i + 1 < a.n && a.bond_mask[i]) {
                const Vec d = minus(p, load3(a.x, row + 1));
                const float c = semispring(norm2(d), a.bond_k[i] / bond_s2,
                                           a.bond_l[i] * bond_s, u);
                bonded = scale(c, d);
                sums[3] += u;
            }
            if (i >= 1 && a.bond_mask[i - 1]) {
                const Vec d = minus(load3(a.x, row - 1), p);
                const float c = semispring(norm2(d), a.bond_k[i - 1] / bond_s2,
                                           a.bond_l[i - 1] * bond_s, u);
                bonded = minus(bonded, scale(c, d));
            }
            if (a.loop_mask) {
                Vec loop{0.0f, 0.0f, 0.0f};
                if (i + 2 < a.n && a.loop_mask[i]) {
                    const Vec d = minus(p, load3(a.x, row + 2));
                    const float k = a.loop_k[i] / bond_s2;
                    loop = scale(-k, d);
                    sums[3] += 0.5f * k * norm2(d);
                }
                if (i >= 2 && a.loop_mask[i - 2]) {
                    const Vec d = minus(load3(a.x, row - 2), p);
                    const float k = a.loop_k[i - 2] / bond_s2;
                    loop = minus(loop, scale(-k, d));
                }
                bonded = plus(bonded, loop);
            }
            // One call a row, the rows of a warp together: called inside the
            // loop over the block's nucleolar rows, a warp's target rows
            // would take their turns one after the other.
            if (nuc_slot >= 0) {
                nucleolar_row(a, nuc_slot, s_nuc_table, s_nuc_x, bond_s2, bond_s, bonded, sums[3]);
            }
            f = plus(f, bonded);
        }

        if (a.semiaxes) {
            // d is a small difference of two numbers of the wall's size near
            // the wall, and the steep softcore magnifies its rounding: r2, s2,
            // R and d in float64, the rest in float32 (wall_forces_analytic).
            const double wx = p.x, wy = p.y, wz = p.z;
            const double r2_wide = wx * wx + wy * wy + wz * wz + kWallEps;
            const double s2_wide = wx * wx * wix + wy * wy * wiy + wz * wz * wiz + kWallEps;
            const double root_wide = sqrt(r2_wide);
            const double inv_s_wide = rsqrt(s2_wide);
            const float d = static_cast<float>(root_wide * (inv_s_wide - 1.0));   // > 0 inside
            const float r2 = static_cast<float>(r2_wide);
            const float s2 = static_cast<float>(s2_wide);
            const float radius = static_cast<float>(root_wide * inv_s_wide);   // R
            const float root = static_cast<float>(root_wide);
            const float d2 = d * d;
            float c, u;
            if (d > 0.0f) {
                const float wa = a.wall_a[i], wb = a.wall_b[i];
                const float core_a = 1.0f - d2 * inv_da2;
                const float s_b = d2 * inv_db2;
                const float s_b2 = s_b * s_b;
                const float core_b = 1.0f - s_b2 * s_b2;
                const float ca = core_a > 0.0f ? 6.0f * e_a * inv_da2 * core_a * core_a : 0.0f;
                const float ua = core_a > 0.0f ? e_a * core_a * core_a * core_a : 0.0f;
                const float cb = core_b > 0.0f
                    ? 24.0f * e_b * inv_db2 * s_b * s_b2 * core_b * core_b : 0.0f;
                const float ub = core_b > 0.0f ? e_b * core_b * core_b * core_b : 0.0f;
                c = wa * ca + wb * cb;
                u = wa * ua + wb * ub;
            } else {
                c = -a.packing_spring;
                u = 0.5f * a.packing_spring * d2;
            }
            const float g = c * d;                    // -dU/d(d^2) 2 d
            const float inv_rs2 = 1.0f / (radius * s2);
            const float inv_root = 1.0f / root;
            const float q = r2 / s2;
            f.x += g * p.x * ((1.0f - q * inv_a2.x) * inv_rs2 - inv_root);
            f.y += g * p.y * ((1.0f - q * inv_a2.y) * inv_rs2 - inv_root);
            f.z += g * p.z * ((1.0f - q * inv_a2.z) * inv_rs2 - inv_root);
            const float h = g * q * inv_rs2;
            sums[0] = h * p.x * p.x * inv_a2.x / ax;
            sums[1] = h * p.y * p.y * inv_a2.y / ay;
            sums[2] = h * p.z * p.z * inv_a2.z / az;
            sums[4] = u;
        }

        if (a.mobility) {
            const float mu = a.mobility[i];
            const float sigma = sqrtf(a.two_t * mu * a.dt);
            f = Vec{p.x + mu * f.x * a.dt + sigma * xi.x, p.y + mu * f.y * a.dt + sigma * xi.y,
                    p.z + mu * f.z * a.dt + sigma * xi.z};
        }
        store3(a.out, row, f);
    }

    // ---- per-replica sums: the warps' partials --------------------------------
    if (a.partials == nullptr) return;
    warp_sum(sums);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) s_warp[warp][k] = sums[k];
    }
    __syncthreads();
    if (warp != 0) return;

    // ---- per-replica sums: one warp a block, then the last block's warp ------
    const int blocks = gridDim.x;
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = lane < kWarps ? s_warp[lane][k] : 0.0f;
    warp_sum(acc);
    unsigned ticket = 0;
    if (lane == 0) {
        float* mine = a.partials + (static_cast<long long>(r) * blocks + blockIdx.x) * kSums;
#pragma unroll
        for (int k = 0; k < kSums; ++k) mine[k] = acc[k];
        __threadfence();   // the partials are visible before the ticket is
        ticket = atomicAdd(&a.tickets[r], 1u);
    }
    ticket = __shfl_sync(kFullWarp, ticket, 0);
    if (ticket != static_cast<unsigned>(blocks - 1)) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int b = lane; b < blocks; b += 32) {
        const float* theirs = a.partials + (static_cast<long long>(r) * blocks + b) * kSums;
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] += __ldcg(theirs + k);
    }
    warp_sum(acc);
    if (lane == 0) {
        if (a.reaction) {
            for (int k = 0; k < 3; ++k) a.reaction[3 * r + k] = acc[k];
        }
        if (a.energy) {
            a.energy[2 * r + 0] = acc[3];
            a.energy[2 * r + 1] = acc[4];
        }
        if (a.semiaxes_out) {
            for (int k = 0; k < 3; ++k) {
                const float axis = a.semiaxes[3 * r + k];
                a.semiaxes_out[3 * r + k] = axis + a.ode_rate * (acc[k] - a.spring[k] * axis);
            }
        }
        a.tickets[r] = 0u;   // ready for the next launch
        if (a.step_index) {
            // Every block of every replica has read the step's row before its
            // ticket, so once the last replica's last block gets here: the
            // next step's row.  One replica needs no second ticket.
            if (a.replicas == 1) {
                *a.step_index += 1;
            } else if (atomicAdd(&a.tickets[a.replicas], 1u) ==
                       static_cast<unsigned>(a.replicas - 1)) {
                a.tickets[a.replicas] = 0u;
                *a.step_index += 1;
            }
        }
    }
}

// Each replica's effective timestep: dt min(spacestep / max|mu F| dt, 1).
__global__ void __launch_bounds__(1024)
drift_limit_kernel(const float* __restrict__ forces, const float* __restrict__ mobility,
                   int n, float dt, float spacestep, float* __restrict__ dt_eff) {
    __shared__ float s_max[1024];
    const int r = blockIdx.x;
    const int tid = threadIdx.x;
    const long long base = static_cast<long long>(r) * n;
    float largest = 0.0f;
    for (int i = tid; i < n; i += blockDim.x) {
        const float mu = mobility[i];
        const Vec f = load3(forces, base + i);
        const Vec v{mu * f.x, mu * f.y, mu * f.z};
        largest = fmaxf(largest, sqrtf(norm2(v)));
    }
    s_max[tid] = largest;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        if (tid < half) s_max[tid] = fmaxf(s_max[tid], s_max[tid + half]);
        __syncthreads();
    }
    if (tid == 0) {
        const float max_disp = s_max[0] * dt;
        dt_eff[r] = dt * fminf(spacestep / fmaxf(max_disp, 1e-30f), 1.0f);
    }
}

__global__ void __launch_bounds__(kUpdateThreads)
bd_update_kernel(const float* __restrict__ x, const float* __restrict__ forces,
                 const float* __restrict__ mobility, const float* __restrict__ noise,
                 int n, float dt, float two_t, const float* __restrict__ dt_eff,
                 float* __restrict__ out) {
    const int r = blockIdx.y;
    const int i = static_cast<int>(blockIdx.x) * kUpdateThreads + static_cast<int>(threadIdx.x);
    if (i >= n) return;
    const long long row = static_cast<long long>(r) * n + i;
    const float step = dt_eff ? dt_eff[r] : dt;
    const float mu = mobility[i];
    const float sigma = sqrtf(two_t * mu * step);
    const Vec p = load3(x, row), f = load3(forces, row), xi = load3(noise, row);
    out[3 * row + 0] = p.x + mu * f.x * step + sigma * xi.x;
    out[3 * row + 1] = p.y + mu * f.y * step + sigma * xi.y;
    out[3 * row + 2] = p.z + mu * f.z * step + sigma * xi.z;
}

}  // namespace

extern "C" {

// The layout of RestArgs, for the wrapper to check against its own copy.
int step_rest_args_size() { return static_cast<int>(sizeof(RestArgs)); }

// Launches on `stream`, does not synchronise and allocates nothing; `args`
// is read on the host.  `partials` holds R * step_rest_blocks(N) * 5 floats,
// `tickets` R + 1 counters.  A launch that reads the step's scalars from the
// card needs the sums (it advances the index from the last block).  Returns
// cudaGetLastError().
int step_rest_launch(const RestArgs* args, void* stream) {
    if (args->n <= 0 || args->replicas <= 0) return 0;
    if (args->step_rows != nullptr && (args->step_index == nullptr || args->partials == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((args->n + kThreads - 1) / kThreads, args->replicas);
    step_rest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}

int step_rest_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// x + mu F dt + sqrt(2 mu kT dt) xi for positions (R, N, 3), out of place.
// With `dt_eff` (R floats of scratch) the timestep is limited per replica by
// `spacestep` first.  Returns cudaGetLastError().
int bd_update_launch(const void* x, const void* forces, const void* mobility,
                     const void* noise, int replicas, int n, float dt, float two_t,
                     float spacestep, void* dt_eff, void* out, void* stream) {
    if (n <= 0 || replicas <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dt_eff != nullptr) {
        drift_limit_kernel<<<replicas, 1024, 0, s>>>(
            static_cast<const float*>(forces), static_cast<const float*>(mobility), n, dt,
            spacestep, static_cast<float*>(dt_eff));
        const int status = static_cast<int>(cudaGetLastError());
        if (status != 0) return status;
    }
    const dim3 grid((n + kUpdateThreads - 1) / kUpdateThreads, replicas);
    bd_update_kernel<<<grid, kUpdateThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(forces),
        static_cast<const float*>(mobility), static_cast<const float*>(noise), n, dt, two_t,
        static_cast<const float*>(dt_eff), static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
