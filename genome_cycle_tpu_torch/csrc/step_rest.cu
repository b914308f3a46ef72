// The O(N) rest of a Brownian-dynamics step, for NVIDIA Hopper (sm_90a):
// chain and loop bonds, the ellipsoidal wall with its per-axis reaction, and
// the Euler-Maruyama update.
//
// The JAX package has no Pallas kernel for this work: XLA fuses it into a few
// device kernels of each step, genome_cycle_tpu/models/interphase.py:688-712
// (_bd_step4: ops/bonded.py::shift_bond_forces, ops/wall.py::wall_forces by
// jax.value_and_grad, ops/integrator.py::bd_update, the wall ODE).  Eager
// PyTorch runs it as a couple of hundred small launches, the wall's autograd
// alone about a hundred.  Here it is one thread per bead row of positions
// (R, N, 3): R replicas of one topology, each with its own semiaxes.
//
// step_rest_kernel adds to a force buffer that already holds the pair force
// (and the nucleolar terms):
//   - chain bonds (i, i+1), semispring K/s^2, l*s, where bond_mask[i];
//   - loops (i, i+2), harmonic K/s^2, where loop_mask[i];
//   each bead forms its own two (four) terms from its neighbours' positions,
//   the sums shift_bond_forces forms with rolls: no atomics;
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
// G1 step in one launch).  The reaction and the bonded and wall energies are
// reduced per replica without atomics on the values: every block writes its
// partial sums (a fixed-order tree in shared memory), and the block that
// arrives last (a ticket counter per replica, reset by that block) adds the
// partials in block order.  Two launches give the same bits.  That block also
// moves the semiaxes by the wall ODE a + rate (reaction - spring a).
//
// drift_limit_kernel and bd_update_kernel are the update alone
// (ops/integrator.py::bd_update): with a displacement limit (the relaxation's
// spacestep) the first takes each replica's largest |mu F| (a max: exact in
// any order) and writes its effective timestep on the device, so the step
// needs no host synchronisation; the second moves the beads.
//
// Bound: bytes.  A bead reads its position, force, noise, mobility, masks,
// bond rows and wall weights once (about 70 bytes; the neighbours' positions
// come from cache) and writes 12, against some 150 operations: far below the
// card's 20 operations a byte.  One launch in place of a hundred is the point.

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
};

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 5;        // reaction x, y, z; bonded energy; wall energy
constexpr double kWallEps = 1e-12;

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ Vec load3(const float* p, long long row) {
    return Vec{p[3 * row], p[3 * row + 1], p[3 * row + 2]};
}

__device__ __forceinline__ Vec minus(Vec a, Vec b) { return Vec{a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ float norm2(Vec d) { return d.x * d.x + d.y * d.y + d.z * d.z; }

// semispring: c = -k (1 - l/r) where r > l, else 0; u = k/2 max(r - l, 0)^2.
__device__ __forceinline__ float semispring(float r2, float k, float l, float& u) {
    const float r = sqrtf(fmaxf(r2, 1e-30f));
    const float stretch = fmaxf(r - l, 0.0f);
    u = 0.5f * k * stretch * stretch;
    return r > l ? -k * (1.0f - l / r) : 0.0f;
}

// Fixed-order sum of one value a thread over the block; the result in [0].
__device__ __forceinline__ void block_sum(float (*s)[kThreads], const float* v) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k][tid] = v[k];
    __syncthreads();
#pragma unroll 1
    for (int half = kThreads / 2; half > 0; half >>= 1) {
        if (tid < half) {
#pragma unroll
            for (int k = 0; k < kSums; ++k) s[k][tid] += s[k][tid + half];
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads) step_rest_kernel(const RestArgs a) {
    __shared__ float s_sum[kSums][kThreads];
    __shared__ bool s_last;
    const int r = blockIdx.y;
    const int i = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
    float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

    if (i < a.n) {
        const long long base = static_cast<long long>(r) * a.n;
        const long long row = base + i;
        const Vec p = load3(a.x, row);
        Vec f = a.f_in ? load3(a.f_in, row) : Vec{0.0f, 0.0f, 0.0f};

        if (a.bond_mask) {
            // shift_bond_forces: row i holds the bond to i + k; bead i gets
            // f[i] - f[i - k] of f[j] = c_j (x_j - x_{j+k}).
            Vec own{0.0f, 0.0f, 0.0f}, prev{0.0f, 0.0f, 0.0f};
            float u;
            if (i + 1 < a.n && a.bond_mask[i]) {
                const Vec d = minus(p, load3(a.x, row + 1));
                const float c = semispring(norm2(d), a.bond_k[i] / a.bond_s2,
                                           a.bond_l[i] * a.bond_s, u);
                own = Vec{c * d.x, c * d.y, c * d.z};
                sums[3] += u;
            }
            if (i >= 1 && a.bond_mask[i - 1]) {
                const Vec d = minus(load3(a.x, row - 1), p);
                const float c = semispring(norm2(d), a.bond_k[i - 1] / a.bond_s2,
                                           a.bond_l[i - 1] * a.bond_s, u);
                prev = Vec{c * d.x, c * d.y, c * d.z};
            }
            Vec bonded = minus(own, prev);
            if (a.loop_mask) {
                Vec own2{0.0f, 0.0f, 0.0f}, prev2{0.0f, 0.0f, 0.0f};
                if (i + 2 < a.n && a.loop_mask[i]) {
                    const Vec d = minus(p, load3(a.x, row + 2));
                    const float k = a.loop_k[i] / a.bond_s2;
                    own2 = Vec{-k * d.x, -k * d.y, -k * d.z};
                    sums[3] += 0.5f * k * norm2(d);
                }
                if (i >= 2 && a.loop_mask[i - 2]) {
                    const Vec d = minus(load3(a.x, row - 2), p);
                    const float k = a.loop_k[i - 2] / a.bond_s2;
                    prev2 = Vec{-k * d.x, -k * d.y, -k * d.z};
                }
                const Vec loop = minus(own2, prev2);
                bonded = Vec{bonded.x + loop.x, bonded.y + loop.y, bonded.z + loop.z};
            }
            f = Vec{f.x + bonded.x, f.y + bonded.y, f.z + bonded.z};
        }

        if (a.semiaxes) {
            const float ax = a.semiaxes[3 * r], ay = a.semiaxes[3 * r + 1],
                        az = a.semiaxes[3 * r + 2];
            // d is a small difference of two numbers of the wall's size near
            // the wall, and the steep softcore magnifies its rounding: r2, s2,
            // R and d in float64, the rest in float32 (wall_forces_analytic).
            const Vec x2{p.x * p.x, p.y * p.y, p.z * p.z};
            const Vec a2{ax * ax, ay * ay, az * az};
            const double wx = p.x, wy = p.y, wz = p.z;
            const double wax = ax, way = ay, waz = az;
            const double r2_wide = wx * wx + wy * wy + wz * wz + kWallEps;
            const double s2_wide = wx * wx / (wax * wax) + wy * wy / (way * way)
                                 + wz * wz / (waz * waz) + kWallEps;
            const double radius_wide = sqrt(r2_wide / s2_wide);  // R: the wall along the ray
            const double root_wide = sqrt(r2_wide);
            const float d = static_cast<float>(radius_wide - root_wide);   // > 0 inside
            const float r2 = static_cast<float>(r2_wide);
            const float s2 = static_cast<float>(s2_wide);
            const float radius = static_cast<float>(radius_wide);
            const float root = static_cast<float>(root_wide);
            const float d2 = d * d;
            float c, u;
            if (d > 0.0f) {
                const float wa = a.wall_a[i], wb = a.wall_b[i];
                const float core_a = 1.0f - d2 * a.inv_da2;
                const float s_b = d2 * a.inv_db2;
                const float s_b2 = s_b * s_b;
                const float core_b = 1.0f - s_b2 * s_b2;
                const float ca = core_a > 0.0f ? 6.0f * a.e_a * a.inv_da2 * core_a * core_a : 0.0f;
                const float ua = core_a > 0.0f ? a.e_a * core_a * core_a * core_a : 0.0f;
                const float cb = core_b > 0.0f
                    ? 24.0f * a.e_b * a.inv_db2 * s_b * s_b2 * core_b * core_b : 0.0f;
                const float ub = core_b > 0.0f ? a.e_b * core_b * core_b * core_b : 0.0f;
                c = wa * ca + wb * cb;
                u = wa * ua + wb * ub;
            } else {
                c = -a.packing_spring;
                u = 0.5f * a.packing_spring * d2;
            }
            const float g = c * d;                    // -dU/d(d^2) 2 d
            const float rs2 = radius * s2;
            const float inv_root = 1.0f / root;
            const float q = r2 / s2;
            f.x += g * p.x * ((1.0f - q / a2.x) / rs2 - inv_root);
            f.y += g * p.y * ((1.0f - q / a2.y) / rs2 - inv_root);
            f.z += g * p.z * ((1.0f - q / a2.z) / rs2 - inv_root);
            const float h = g * r2 / (rs2 * s2);
            sums[0] = h * x2.x / (a2.x * ax);
            sums[1] = h * x2.y / (a2.y * ay);
            sums[2] = h * x2.z / (a2.z * az);
            sums[4] = u;
        }

        if (a.mobility) {
            const float mu = a.mobility[i];
            const float sigma = sqrtf(a.two_t * mu * a.dt);
            const Vec xi = load3(a.noise, row);
            a.out[3 * row + 0] = p.x + mu * f.x * a.dt + sigma * xi.x;
            a.out[3 * row + 1] = p.y + mu * f.y * a.dt + sigma * xi.y;
            a.out[3 * row + 2] = p.z + mu * f.z * a.dt + sigma * xi.z;
        } else {
            a.out[3 * row + 0] = f.x;
            a.out[3 * row + 1] = f.y;
            a.out[3 * row + 2] = f.z;
        }
    }

    if (a.partials == nullptr) return;
    // ---- per-replica sums: block partials, then the last block's pass -----
    const int tid = threadIdx.x;
    const int blocks = gridDim.x;
    block_sum(s_sum, sums);
    if (tid == 0) {
        float* mine = a.partials + (static_cast<long long>(r) * blocks + blockIdx.x) * kSums;
#pragma unroll
        for (int k = 0; k < kSums; ++k) mine[k] = s_sum[k][0];
        __threadfence();   // the partials are visible before the ticket is
        s_last = atomicAdd(&a.tickets[r], 1u) == static_cast<unsigned>(blocks - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int b = tid; b < blocks; b += kThreads) {
        const float* theirs = a.partials + (static_cast<long long>(r) * blocks + b) * kSums;
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] += __ldcg(theirs + k);
    }
    __syncthreads();   // s_sum is free again
    block_sum(s_sum, acc);
    if (tid == 0) {
        if (a.reaction) {
            for (int k = 0; k < 3; ++k) a.reaction[3 * r + k] = s_sum[k][0];
        }
        if (a.energy) {
            a.energy[2 * r + 0] = s_sum[3][0];
            a.energy[2 * r + 1] = s_sum[4][0];
        }
        if (a.semiaxes_out) {
            for (int k = 0; k < 3; ++k) {
                const float axis = a.semiaxes[3 * r + k];
                a.semiaxes_out[3 * r + k] =
                    axis + a.ode_rate * (s_sum[k][0] - a.spring[k] * axis);
            }
        }
        a.tickets[r] = 0u;   // ready for the next launch
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

__global__ void __launch_bounds__(kThreads)
bd_update_kernel(const float* __restrict__ x, const float* __restrict__ forces,
                 const float* __restrict__ mobility, const float* __restrict__ noise,
                 int n, float dt, float two_t, const float* __restrict__ dt_eff,
                 float* __restrict__ out) {
    const int r = blockIdx.y;
    const int i = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
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
// is read on the host.  `partials` holds R * ceil(N / 256) * 5 floats.
// Returns cudaGetLastError().
int step_rest_launch(const RestArgs* args, void* stream) {
    if (args->n <= 0 || args->replicas <= 0) return 0;
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
    const dim3 grid((n + kThreads - 1) / kThreads, replicas);
    bd_update_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(forces),
        static_cast<const float*>(mobility), static_cast<const float*>(noise), n, dt, two_t,
        static_cast<const float*>(dt_eff), static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
