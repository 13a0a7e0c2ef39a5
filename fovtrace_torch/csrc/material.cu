// The material table's lookup and its adjoint for Hopper (sm_90a).
//
//   material_gather_kernel   <- the forward of material_lookup_v,
//                               fovtrace/kernels/intersect.py:401
//   material_adjoint_kernel  <- its gradient with respect to the table
//                               (jax.vjp of the same lines), two passes
//                               in one cooperative launch
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
// cut into fixed slices of WARP_RAYS = 512, each summed by one warp of
// the first pass (which warp does not matter). A lane holds 16 of the
// slice's ids and, column by column, 16 cotangent values in registers
// (every value read once, coalesced; the next column's loads issued
// before this column is summed); for each material it sums its matching
// values in a fixed order, the warp adds the 32 lane sums by a fixed
// xor-shuffle tree (every lane ends with the same bits: each add sees
// the same two operands), and lane 0 writes the slice's partial
// partial[(m * k + c) * slices + s]. After a grid-wide barrier the second
// pass gives one warp to each of the M x K entries: its lanes sum the
// entry's partials over the slices in index order, strided by 32 (eight
// loads issued before they are added), and the same tree adds them. Both
// passes run in one cooperative launch of as many CTAs as fit on the
// card at once, each warp taking every (CTAs x warps)-th slice, then
// entry: the barrier costs about a microsecond on the H100, less than a
// second launch. Misses are clamped to id 0 before the lookup, so their
// cotangents sum into row 0, as in the reference; padding lanes of a
// compacted front sum like any other. A slice past n reads id -1, which
// matches no row.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
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

// One slice's partials: per material and column, the sum of the
// slice's matching cotangent values (lane sums in ray order, then the
// warp's xor tree). Whole warps only.
__device__ __forceinline__ void slice_partials(const int* __restrict__ ids,
                                               const float* __restrict__ g,
                                               float* __restrict__ partial,
                                               int n, int m, int k,
                                               int slices, int s) {
  const int lane = threadIdx.x & 31;
  const int base = s * WARP_RAYS + lane;
  int id[LANE_RAYS];
  float v[LANE_RAYS], next[LANE_RAYS];
#pragma unroll
  for (int j = 0; j < LANE_RAYS; ++j) {
    const int i = base + 32 * j;
    id[j] = i < n ? ids[i] : -1;
    v[j] = i < n ? g[i] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < LANE_RAYS; ++j)
    if (base + 32 * j < n && (unsigned)id[j] >= (unsigned)m) __trap();
  for (int c = 0; c < k; ++c) {
    if (c + 1 < k) {
      const float* col = g + (size_t)(c + 1) * n;
#pragma unroll
      for (int j = 0; j < LANE_RAYS; ++j) {
        const int i = base + 32 * j;
        next[j] = i < n ? col[i] : 0.0f;
      }
    }
    for (int mm = 0; mm < m; ++mm) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < LANE_RAYS; ++j) sum += id[j] == mm ? v[j] : 0.0f;
      sum = warp_sum(sum);
      if (lane == 0) partial[((size_t)mm * k + c) * slices + s] = sum;
    }
#pragma unroll
    for (int j = 0; j < LANE_RAYS; ++j) v[j] = next[j];
  }
}

// One entry of the table's gradient: its partials summed over the slices
// in index order by each lane (strided by 32), then the xor tree.
__device__ __forceinline__ void entry_sum(const float* __restrict__ partial,
                                          float* __restrict__ out,
                                          int slices, int e) {
  const int lane = threadIdx.x & 31;
  const float* p = partial + (size_t)e * slices;
  float sum = 0.0f;
  int s = lane;
  for (; s + 32 * 7 < slices; s += 32 * 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = __ldcg(p + s + 32 * u);
#pragma unroll
    for (int u = 0; u < 8; ++u) sum += t[u];
  }
  for (; s < slices; s += 32) sum += __ldcg(p + s);
  sum = warp_sum(sum);
  if (lane == 0) out[e] = sum;
}

__global__ void __launch_bounds__(THREADS)
material_adjoint_kernel(const int* __restrict__ ids,
                        const float* __restrict__ g,
                        float* __restrict__ partial, float* __restrict__ out,
                        int n, int m, int k, int slices) {
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * warps + (threadIdx.x >> 5);
  const int stride = gridDim.x * warps;
  for (int s = first; s < slices; s += stride)
    slice_partials(ids, g, partial, n, m, k, slices, s);
  cg::this_grid().sync();
  for (int e = first; e < m * k; e += stride)
    entry_sum(partial, out, slices, e);
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

// ids [n] i32 in [0, m), g [k, n] f32, partial [m * k * slices] f32
// scratch with slices = ceil(n / WARP_RAYS), out [m, k] f32. One
// cooperative launch of the CTAs that fit on the card at once.
int fov_material_adjoint(const void* ids, const void* g, void* partial,
                         void* out, int n, int m, int k, void* stream) {
  if (n < 1 || m < 1 || k < 1 || m * k > MAX_TABLE)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, material_adjoint_kernel, THREADS, 0);
  if (err) {
    cudaGetLastError();
    return err;
  }
  int slices = blocks(n, WARP_RAYS);
  void* args[] = {&ids, &g, &partial, &out, &n, &m, &k, &slices};
  err = (int)cudaLaunchCooperativeKernel(
      (const void*)material_adjoint_kernel, sms * per, THREADS, args, 0,
      (cudaStream_t)stream);
  if (err) cudaGetLastError();
  return err;
}

}  // extern "C"
