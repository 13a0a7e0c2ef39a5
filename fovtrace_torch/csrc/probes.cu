// Probe kernels for Hopper (sm_90a): the counterparts of the JAX
// package's two TPU probe scripts. No render path runs them.
//
//   micro_kernel<V>  <- the six kernel bodies that main.make_call wraps,
//                       scripts/microbench_inner.py:70 (call :81): k_loop
//                       :89, k_slab :103, k_mm_lane :125, k_mm_lead :149,
//                       k_mm_bf :171, k_full :197
//   smem_dma_kernel  <- kernel, scripts/probe_smem_dma.py:23 (call :73)
//
// micro_kernel. The microbenchmark splits the closest-hit kernel's cost
// per live cluster into its parts. One CUDA block of 256 threads per
// 256-ray block and one thread per ray, as in closest_kernel
// (cluster_isect.cu). The block walks its first counts[i] entries of
// the flat schedule sched[i * nc + l] (cluster ids) with no front-to-back
// break, as the script does, and writes per ray the value its body
// writes:
//   LOOP     the sum of float(jc) over the entries (exact: ids < 2^16,
//            sums < 2^24)
//   SLAB     1e30, halved once per entry for which any ray of the block
//            passes the slab test against cluster jc's AABB, with upper =
//            the running value (block-uniform; one __syncthreads_or vote)
//   MM_LANE  the minimum over entries and over the cluster's 4c columns
//            of the dot products rays[r, :] . coef[:, jc * 4c + col],
//            coefficients from the cluster-strided [16, NC * 4c] layout
//   MM_LEAD  the same from the cluster-contiguous [NC, 16, 4c] layout
//   MM_BF16  MM_LEAD with rays and coefficients rounded to bf16,
//            products accumulated in float32
//   FULL     the slab cull with upper = the ray's running t, then the
//            float32 dot products and the body's epilogue: t = t_num / det
//            (a division), t > 1e-3, no t_max test; the minimum t
// The matmul variants stage each cluster's coefficient rows 0..9 in
// shared memory as one 40-value record per triangle (the record layout
// of cluster_isect.cu, copied rather than shared: the probes must stay
// what they are when the render kernels change), then run the four
// 10-term dot products per (ray, triangle) in FMA. Rows 10-15 are left
// out: the pack has zeros there, and the ray features there (t_min,
// t_max <= 1e30, 1/d clamped to +-1e12, 0) are finite, so the script's
// six extra terms are exact zeros and the sum differs from its 16-term
// one only in summation order. MM_BF16 keeps its records in bf16 (80
// bytes per triangle, five 16-byte loads instead of ten) and widens
// each value with one integer op; bf16 x bf16 products are exact in
// float32.
//
// What bounds them: the matmul variants as closest_kernel, per-thread
// FMA and shared-load issue, 40 FMAs and ten 16-byte broadcast loads per
// (ray, triangle) pair, with each cluster's slab read once per (block,
// entry) from L2 (44 clusters x 32 KB on earth). LOOP and SLAB move no
// slab: they are bound by the schedule walk's latency, a dependent load
// of the entry per step and, for SLAB, a block-wide vote. The variants
// exist to separate those costs: their time per (block, entry) step
// against closest_kernel's per visited cluster.
//
// smem_dma_kernel. The TPU probe checks the plumbing of a streaming
// kernel: per ray block, copy its schedule row from HBM into on-chip
// scalar memory with an asynchronous DMA (make_async_copy ... start /
// wait on a DMA semaphore), walk the row in a data-dependent loop, and
// store one output row at a dynamic index. Here one CUDA block of 256
// threads (one per output lane) runs a group of GROUP = 8 ray blocks in
// a loop that is not unrolled. Per sub-block one thread starts a
// cp.async.bulk copy of the row, global -> shared (Hopper's 1-D TMA
// copy, the closest match to the TPU's DMA), that completes on an
// mbarrier, the semaphore's counterpart; every thread waits on the
// barrier's phase. Both ends must be 16-byte aligned and the size a
// multiple of 16, which is why rows are padded (the script pads them to
// 128 ints for the TPU's DMA). Then
//   acc[r] += table[entry % 65536, r] * float(entry / 65536)
// for l < counts[b] (a multiply and an add, no FMA contraction: the
// library builds with --fmad=false, as the numpy reference rounds), and
// out[b, r] = acc[r] + rays[b, 0, r]. Bound by latency: per entry one
// dependent shared load and one 1 KB table row from L2 per block; the
// bytes it must move are a few MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int RAY_BLOCK = 256;
constexpr int NFEAT = 10;       // ray feature rows that meet the coefficients
constexpr int REC = 4 * NFEAT;  // coefficient values per triangle
constexpr float BIG_T = 1e30f;
constexpr float DET_EPS = 1e-12f;  // intersect.DET_EPS
constexpr int GROUP = 8;           // ray blocks per smem_dma_kernel block

enum Variant { LOOP, SLAB, MM_LANE, MM_LEAD, MM_BF16, FULL };

// one ray of a [N, 16] row: o (0:3), d (3:6), o x d (6:9), 1, t_min,
// t_max, 1/d (12:15), 0
struct Ray {
  float f[16];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int b) {
  Ray r;
  const float4* p = reinterpret_cast<const float4*>(
      rays + ((size_t)b * RAY_BLOCK + threadIdx.x) * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = p[i];
    r.f[4 * i] = v.x;
    r.f[4 * i + 1] = v.y;
    r.f[4 * i + 2] = v.z;
    r.f[4 * i + 3] = v.w;
  }
  return r;
}

// the per-ray slab test against cluster jc's AABB (cb: lo xyz, hi xyz),
// as _ray_slab: the ray enters before `upper` and before it leaves
__device__ __forceinline__ bool ray_slab(const Ray& r,
                                         const float* __restrict__ cb,
                                         float upper) {
  const float lox = (cb[0] - r.f[0]) * r.f[12];
  const float hix = (cb[3] - r.f[0]) * r.f[12];
  const float loy = (cb[1] - r.f[1]) * r.f[13];
  const float hiy = (cb[4] - r.f[1]) * r.f[13];
  const float loz = (cb[2] - r.f[2]) * r.f[14];
  const float hiz = (cb[5] - r.f[2]) * r.f[14];
  const float tenter = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)),
                             fmaxf(fminf(loz, hiz), r.f[10]));
  const float texit = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)),
                            fminf(fmaxf(loz, hiz), upper));
  return tenter <= texit;
}

// stage coefficient rows 0..9 of one cluster (row k at src + k * stride,
// 4c columns) as records rec[(j * 4 + q) * NFEAT + k] = column q * c + j
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int stride,
                                      int c, T* rec) {
  const int w4 = 4 * c;
  for (int i = threadIdx.x; i < NFEAT * w4; i += RAY_BLOCK) {
    const int k = i / w4;
    const int col = i - k * w4;
    const int q = col / c;
    const int j = col - q * c;
    rec[(j * 4 + q) * NFEAT + k] = src[(size_t)k * stride + col];
  }
}

// a triangle's 40 coefficients from a float32 record
__device__ __forceinline__ void read_rec(const float* rec, float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int i = 0; i < REC / 4; ++i) {
    const float4 v = s4[i];
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
}

// ... and from a bf16 record: a bf16 is the high half of its float32
__device__ __forceinline__ void read_rec(const uint16_t* rec, float* s) {
  const uint4* s4 = reinterpret_cast<const uint4*>(rec);
#pragma unroll
  for (int i = 0; i < REC / 8; ++i) {
    const uint4 v = s4[i];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      s[8 * i + 2 * h] = __uint_as_float(w[h] << 16);
      s[8 * i + 2 * h + 1] = __uint_as_float(w[h] & 0xFFFF0000u);
    }
  }
}

// the four 10-term dot products of one triangle record
template <typename T>
__device__ __forceinline__ void dots(const float* f, const T* rec, float& tn,
                                     float& dt, float& un, float& vn) {
  float s[REC];
  read_rec(rec, s);
  tn = 0.0f;
  dt = 0.0f;
  un = 0.0f;
  vn = 0.0f;
#pragma unroll
  for (int k = 0; k < NFEAT; ++k) {
    tn = fmaf(f[k], s[k], tn);
    dt = fmaf(f[k], s[NFEAT + k], dt);
    un = fmaf(f[k], s[2 * NFEAT + k], un);
    vn = fmaf(f[k], s[3 * NFEAT + k], vn);
  }
}

// k_full's epilogue for one triangle: t on a hit past 1e-3, else 1e30
__device__ __forceinline__ float full_t(float tn, float dt, float un,
                                        float vn) {
  const float ud = un * dt;
  const float vd = vn * dt;
  const bool big = fabsf(dt) > DET_EPS;
  const bool ok = big && ud >= 0.0f && vd >= 0.0f && ud + vd <= dt * dt;
  const float t = tn / (big ? dt : 1.0f);
  return ok && t > 1e-3f ? t : BIG_T;
}

template <int V>
__global__ void __launch_bounds__(RAY_BLOCK)
micro_kernel(const float* __restrict__ rays, const int* __restrict__ sched,
             const int* __restrict__ counts, const float* __restrict__ cb,
             const void* __restrict__ coef, float* __restrict__ out, int nc,
             int c) {
  using T = typename std::conditional<V == MM_BF16, uint16_t, float>::type;
  extern __shared__ float4 smem4[];
  T* rec = reinterpret_cast<T*>(smem4);
  const T* cf = reinterpret_cast<const T*>(coef);
  const int i = blockIdx.x;
  const int count = counts[i];
  const int* row = sched + (size_t)i * nc;
  const int w4 = 4 * c;

  Ray r;
  if constexpr (V != LOOP) r = load_ray(rays, i);
  if constexpr (V == MM_BF16) {
#pragma unroll
    for (int k = 0; k < NFEAT; ++k)
      r.f[k] = __bfloat162float(__float2bfloat16_rn(r.f[k]));
  }
  float val = V == LOOP ? 0.0f : BIG_T;
  for (int l = 0; l < count; ++l) {
    const int jc = row[l];
    if constexpr (V == LOOP) {
      val = val + (float)jc;
    } else if constexpr (V == SLAB) {
      if (__syncthreads_or(ray_slab(r, cb + (size_t)jc * 8, val)))
        val = val * 0.5f;
    } else {
      if constexpr (V == FULL) {
        // the vote is a barrier too: the last cluster's records are
        // consumed once every thread has voted
        if (!__syncthreads_or(ray_slab(r, cb + (size_t)jc * 8, val)))
          continue;
      } else {
        __syncthreads();  // the previous cluster's records are consumed
      }
      if constexpr (V == MM_LANE)
        stage(cf + (size_t)jc * w4, nc * w4, c, rec);
      else
        stage(cf + (size_t)jc * 16 * w4, w4, c, rec);
      __syncthreads();
      for (int j = 0; j < w4 / 4; ++j) {
        float tn, dt, un, vn;
        dots(r.f, rec + j * REC, tn, dt, un, vn);
        if constexpr (V == FULL)
          val = fminf(val, full_t(tn, dt, un, vn));
        else
          val = fminf(val, fminf(fminf(tn, dt), fminf(un, vn)));
      }
    }
  }
  out[(size_t)i * RAY_BLOCK + threadIdx.x] = val;
}

__global__ void __launch_bounds__(RAY_BLOCK)
smem_dma_kernel(const int* __restrict__ counts, const int* __restrict__ sched,
                const float* __restrict__ rays,
                const float* __restrict__ table, float* __restrict__ out,
                int sw) {
  extern __shared__ float4 smem4[];
  const int* row_s = reinterpret_cast<const int*>(smem4);  // [sw]
  __shared__ uint64_t bar_s;
  const unsigned bar = smem_addr(&bar_s);
  const unsigned row = smem_addr(row_s);
  const unsigned bytes = (unsigned)sw * 4u;
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
#pragma unroll 1
  for (int g = 0; g < GROUP; ++g) {
    const int b = blockIdx.x * GROUP + g;
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, bytes);
      bulk_g2s(row, sched + (size_t)b * sw, bytes, bar);
    }
    mbar_wait(bar, g & 1);  // the barrier completes one phase per copy
    const int count = counts[b];
    float acc = 0.0f;
    for (int l = 0; l < count; ++l) {
      const int e = row_s[l];
      // entries are non-negative, so % and / are the script's rem and //
      const float key = (float)(e / 65536);
      acc = acc + table[(size_t)(e % 65536) * RAY_BLOCK + threadIdx.x] * key;
    }
    out[(size_t)b * RAY_BLOCK + threadIdx.x] =
        acc + rays[(size_t)b * 16 * RAY_BLOCK + threadIdx.x];
    fence_proxy_async();
    __syncthreads();  // every thread has read the row before the next copy
  }
}

template <int V>
int launch_micro(const float* rays, const int* sched, const int* counts,
                 const float* cb, const void* coef, float* out, int nb, int nc,
                 int c, cudaStream_t stream) {
  size_t smem = 0;
  if (V != LOOP && V != SLAB)
    smem = (size_t)c * REC * (V == MM_BF16 ? sizeof(uint16_t) : sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)micro_kernel<V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  micro_kernel<V><<<nb, RAY_BLOCK, smem, stream>>>(rays, sched, counts, cb,
                                                  coef, out, nc, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the CUDA error of the launch (0 = success). Launches on
// `stream`, allocates nothing, does not synchronise.

// rays [nb * 256, 16] f32, sched [nb * nc] i32 cluster ids, counts [nb],
// cb [nc * 8] AABBs, coef in the variant's layout (NULL for loop and
// slab), out [nb * 256] f32
#define FOV_MICRO(name, V)                                                \
  int fov_micro_##name(const float* rays, const int* sched,               \
                       const int* counts, const float* cb,                \
                       const void* coef, float* out, int nb, int nc, int c, \
                       cudaStream_t stream) {                             \
    return launch_micro<V>(rays, sched, counts, cb, coef, out, nb, nc, c, \
                           stream);                                       \
  }
FOV_MICRO(loop, LOOP)
FOV_MICRO(slab, SLAB)
FOV_MICRO(mm_lane, MM_LANE)
FOV_MICRO(mm_lead, MM_LEAD)
FOV_MICRO(mm_bf16, MM_BF16)
FOV_MICRO(full, FULL)
#undef FOV_MICRO

// counts [nb] i32, sched [nb, sw] i32 (sw a multiple of 4), rays
// [nb, 16, 256] f32, table [nsc, 256] f32, out [nb, 256] f32; nb a
// multiple of GROUP
int fov_smem_dma(const int* counts, const int* sched, const float* rays,
                 const float* table, float* out, int nb, int sw,
                 cudaStream_t stream) {
  const size_t smem = (size_t)sw * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)smem_dma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  smem_dma_kernel<<<nb / GROUP, RAY_BLOCK, smem, stream>>>(counts, sched, rays,
                                                          table, out, sw);
  return (int)cudaGetLastError();
}

}  // extern "C"
