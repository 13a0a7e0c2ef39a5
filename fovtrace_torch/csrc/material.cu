// The material table's lookup and its adjoint for Hopper (sm_90a).
//
//   material_gather_kernel           <- the forward of material_lookup_v,
//                                       fovtrace/kernels/intersect.py:401
//   material_adjoint_partial_kernel  <- its gradient with respect to the
//   material_adjoint_final_kernel       table (jax.vjp of the same lines)
//
// The reference is no Pallas kernel: a select chain for M <= 16 and a
// row gather above, differentiable in the table. Each shading step reads
// K columns of a small [M, K] float32 table (the concatenated material
// columns) for each of N rays, by the ray's material id, and its adjoint
// sums the rays' [K, N] cotangent into the table's M rows. A front is up
// to 2,088,960 rays (1920x1088) and M is small (4 in every procedural
// scene), so the adjoint reduces millions of rows into a handful.
//
// Both directions are bound by bytes: the gather reads N ids and writes
// K x N floats, the adjoint reads K x N floats and N ids; neither does
// more than one add per value it reads.
//
// material_gather_kernel. The table goes to shared memory once per CTA;
// each thread takes one ray, reads its id, and writes the K values of the
// id's row to the SoA block out[k * n + i], so each of the K stores of a
// warp is one coalesced 128-byte line. A warp's ids are a handful of
// distinct rows, so its shared-memory reads are broadcasts.
//
// The adjoint. Deterministic, with no atomics: the same ids and
// cotangent give the same bits on every run and every card. The rays are
// cut into fixed slices of WARP_RAYS = 512, one per warp of the first
// pass (the launch shape depends only on n). A lane holds 16 of its
// warp's ids and, column by column, 16 cotangent values in registers
// (every value read once, coalesced); for each material it sums its
// matching values in a fixed order, the warp adds the 32 lane sums by a
// fixed xor-shuffle tree (every lane ends with the same bits: each add
// sees the same two operands), and lane 0 writes the warp's partial
// partial[(m * k + c) * warps + w]. The second pass gives one warp to
// each of the M x K entries: its lanes sum the entry's partials over the
// warps in index order, strided by 32, and the same tree adds them.
// Misses are clamped to id 0 before the lookup, so their cotangents sum
// into row 0, as in the reference; padding lanes of a compacted front
// sum like any other. A slice past n reads id -1, which matches no row.
//
// Limits. The gather keeps the table in the 48 KB of shared memory a
// kernel gets without opting in: M x K <= MAX_TABLE = 12,288 floats,
// M <= 585 at the shade's K = 21 and M <= 3,072 at the surface's K = 4.
// The port's scenes hold at most 5 materials (procedural: 4; the
// reference asset directory and the JSON specs of the tests: 5; a file
// scene has one row per MTL record), and its tests at most 24. The
// wrappers refuse a larger table with an error that names the limit (the
// adjoint's partials would fit any M; it keeps the gather's limit, since
// no table gets past the gather). An id outside [0, M) traps the
// kernel (a device-side fault, as aten's index kernels assert): the
// wrapper does not read the ids back, which would stall the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// MAX_TABLE and WARP_RAYS have copies in kernels/material.py, which
// tests/test_torch_material.py holds to these lines
constexpr int MAX_TABLE = 12288;          // floats: 48 KB of shared memory
constexpr int LANE_RAYS = 16;             // rays a lane holds in the adjoint
constexpr int WARP_RAYS = 32 * LANE_RAYS;  // rays of one warp's slice

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__global__ void __launch_bounds__(THREADS)
material_gather_kernel(const int* __restrict__ ids,
                       const float* __restrict__ table,
                       float* __restrict__ out, int n, int m, int k) {
  extern __shared__ float s_table[];
  for (int j = threadIdx.x; j < m * k; j += blockDim.x) s_table[j] = table[j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  if ((unsigned)id >= (unsigned)m) __trap();
  const float* row = s_table + id * k;
  for (int c = 0; c < k; ++c) out[(size_t)c * n + i] = row[c];
}

__global__ void __launch_bounds__(THREADS)
material_adjoint_partial_kernel(const int* __restrict__ ids,
                                const float* __restrict__ g,
                                float* __restrict__ partial, int n, int m,
                                int k, int warps) {
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= warps) return;                 // whole warps only
  const int base = w * WARP_RAYS + lane;
  int id[LANE_RAYS];
#pragma unroll
  for (int j = 0; j < LANE_RAYS; ++j) {
    const int i = base + 32 * j;
    id[j] = i < n ? ids[i] : -1;
    if (i < n && (unsigned)id[j] >= (unsigned)m) __trap();
  }
  for (int c = 0; c < k; ++c) {
    const float* col = g + (size_t)c * n;
    float v[LANE_RAYS];
#pragma unroll
    for (int j = 0; j < LANE_RAYS; ++j) {
      const int i = base + 32 * j;
      v[j] = i < n ? col[i] : 0.0f;
    }
    for (int mm = 0; mm < m; ++mm) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < LANE_RAYS; ++j) s += id[j] == mm ? v[j] : 0.0f;
      s = warp_sum(s);
      if (lane == 0) partial[((size_t)mm * k + c) * warps + w] = s;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
material_adjoint_final_kernel(const float* __restrict__ partial,
                              float* __restrict__ out, int entries,
                              int warps) {
  const int e = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (e >= entries) return;
  const float* p = partial + (size_t)e * warps;
  float s = 0.0f;
  for (int w = lane; w < warps; w += 32) s += p[w];
  s = warp_sum(s);
  if (lane == 0) out[e] = s;
}

int blocks(long long items, int per_block) {
  return (int)((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each launch entry point returns the CUDA error of its launches (0 =
// success). Launches on `stream`, allocates nothing, does not synchronise.
// n >= 1, 1 <= m, 1 <= k, m * k <= MAX_TABLE.

// ids [n] i32 in [0, m), table [m, k] f32, out [k, n] f32.
int fov_material_gather(const void* ids, const void* table, void* out, int n,
                        int m, int k, void* stream) {
  if (n < 1 || m < 1 || k < 1 || m * k > MAX_TABLE)
    return (int)cudaErrorInvalidValue;
  material_gather_kernel<<<blocks(n, THREADS), THREADS,
                           (size_t)m * k * sizeof(float),
                           (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)table, (float*)out, n, m, k);
  return (int)cudaGetLastError();
}

// ids [n] i32 in [0, m), g [k, n] f32, partial [m * k * warps] f32
// scratch with warps = ceil(n / WARP_RAYS), out [m, k] f32.
int fov_material_adjoint(const void* ids, const void* g, void* partial,
                         void* out, int n, int m, int k, void* stream) {
  if (n < 1 || m < 1 || k < 1 || m * k > MAX_TABLE)
    return (int)cudaErrorInvalidValue;
  const int warps = blocks(n, WARP_RAYS);
  cudaStream_t s = (cudaStream_t)stream;
  material_adjoint_partial_kernel<<<blocks(warps, WARPS), THREADS, 0, s>>>(
      (const int*)ids, (const float*)g, (float*)partial, n, m, k, warps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  material_adjoint_final_kernel<<<blocks(m * k, WARPS), THREADS, 0, s>>>(
      (const float*)partial, (float*)out, m * k, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
