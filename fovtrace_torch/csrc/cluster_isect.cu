// Cluster ray/triangle intersection kernels for Hopper (sm_90a).
//
// Replace the two VMEM-resident Pallas kernels of
// fovtrace/kernels/pallas_isect.py:
//   closest_kernel    <- _closest_kernel   (with _closest_update,
//                                           _mt_epilogue, _bound_key)
//   occlusion_kernel  <- _occlusion_kernel (with _occlusion_update)
// They compute the same results from the same inputs: the [NB,16,256]
// ray feature blocks, the [NC,16,4c] Cramer coefficient pack, and the
// flat (M == 1) front-to-back schedule of live clusters per ray block.
//
// Design. One CUDA block of 256 threads per 256-ray block, one thread
// per ray; the ray's 10 features, t_min and t_max stay in registers. The
// block walks its schedule in order. For each cluster it stages the 10
// live coefficient rows x 4c (20 KB at c = 128) into shared memory with
// coalesced loads, transposed into one 40-float record per triangle, so
// a thread reads a triangle's four 10-term coefficient vectors as ten
// 16-byte broadcast loads. Each thread then runs the four dot products in
// float32 FMA (at least as precise as the TPU's bf16x3 split) and the
// Moller-Trumbore epilogue. The closest-hit kernel keeps a running
// (t, triangle) with a strict `<`, so ties go to the lowest lane and the
// earliest cluster; the TPU's packed (t_bits & ~127) | lane reduction
// key is not needed. After each cluster a block max of the best t gives
// the break bound, uniform across the block.
//
// What bounds it on the H100: arithmetic issue, not memory. Per (ray,
// triangle) pair it spends 40 FMAs, 10 shared-memory loads and ~15
// epilogue ops; the coefficient slab is read from device memory (it sits
// in L2: 44 clusters x 32 KB on the earth scene) once per (block,
// cluster) and reused by 256 rays. The front-to-back schedule with its
// early break is what removes work. A K = 10 contraction is too thin for
// wgmma to pay; tensor-core forms are later work.
//
// Built by nvcc with --fmad=false: the epilogue then rounds exactly like
// the plain PyTorch version; the dot products use explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 256;
constexpr int NWARP = RAY_BLOCK / 32;
constexpr int NFEAT = 10;   // ray feature rows that meet the coefficients
constexpr int REC = 4 * NFEAT;  // coefficient floats per triangle
constexpr float BIG_T = 1e30f;
constexpr float DET_EPS = 1e-12f;

// f32 bound -> quantized schedule key, +2 so rounding here can never
// break while a cluster's true entry distance is <= the bound
__device__ __forceinline__ int bound_key(float b, float scale, float t_cap) {
  return (int)(fminf(fmaxf(b, 0.0f), t_cap) * scale) + 2;
}

// block-wide max; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) r = fmaxf(r, red[w]);
  return r;
}

// stage cluster jc's coefficient rows 0..9 into per-triangle records:
// rec[(j * 4 + q) * NFEAT + k] = coef[jc][k][q * c + j]
__device__ __forceinline__ void stage_coef(const float* __restrict__ coef,
                                           int jc, int c, float* rec) {
  const int w4 = 4 * c;
  const float* src = coef + (size_t)jc * 16 * w4;
  for (int i = threadIdx.x; i < NFEAT * w4; i += RAY_BLOCK) {
    const int k = i / w4;
    const int col = i - k * w4;
    const int q = col / c;
    const int j = col - q * c;
    rec[(j * 4 + q) * NFEAT + k] = src[i];
  }
}

struct Ray {
  float f[NFEAT];
  float tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ raysT,
                                        int b) {
  Ray r;
  const float* p = raysT + (size_t)b * 16 * RAY_BLOCK + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NFEAT; ++k) r.f[k] = p[k * RAY_BLOCK];
  r.tmin = p[10 * RAY_BLOCK];
  r.tmax = p[11 * RAY_BLOCK];
  return r;
}

// Moller-Trumbore in Cramer form for one triangle record: returns hit,
// writes t and det (the _mt_epilogue of the reference)
__device__ __forceinline__ bool mt_test(const Ray& r, const float* rec,
                                        float& t, float& det) {
  float s[REC];
  const float4* s4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int i = 0; i < REC / 4; ++i) {
    const float4 v = s4[i];
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
  float tn = 0.0f, dt = 0.0f, un = 0.0f, vn = 0.0f;
#pragma unroll
  for (int k = 0; k < NFEAT; ++k) {
    tn = fmaf(r.f[k], s[k], tn);
    dt = fmaf(r.f[k], s[NFEAT + k], dt);
    un = fmaf(r.f[k], s[2 * NFEAT + k], un);
    vn = fmaf(r.f[k], s[3 * NFEAT + k], vn);
  }
  const float ud = un * dt;
  const float vd = vn * dt;
  const bool big = fabsf(dt) > DET_EPS;
  bool ok = big && ud >= 0.0f && vd >= 0.0f && ud + vd <= dt * dt;
  const float inv_det = 1.0f / (big ? dt : 1.0f);
  t = tn * inv_det;
  det = dt;
  return ok && t > r.tmin && t < r.tmax;
}

__global__ void __launch_bounds__(RAY_BLOCK)
closest_kernel(const float* __restrict__ raysT, const float* __restrict__ coef,
               const int* __restrict__ sched, const int* __restrict__ counts,
               const float* __restrict__ params, float* __restrict__ t_out,
               int* __restrict__ idx_out, int c, int sw) {
  extern __shared__ float4 smem4[];
  float* rec = reinterpret_cast<float*>(smem4);
  __shared__ float red[NWARP];
  const int b = blockIdx.x;
  const Ray r = load_ray(raysT, b);
  const float scale = params[0];
  const float t_cap = params[1];
  const float tmax_blk = block_max(r.tmax, red);
  int bound = bound_key(tmax_blk, scale, t_cap);
  const int count = counts[b];
  const int* row = sched + (size_t)b * 2 * sw;

  float best_t = BIG_T;
  int best_i = -1;
  for (int l = 0; l < count; ++l) {
    const int e = row[l];
    if ((e >> 16) > bound) break;  // front to back: nothing later is closer
    const int jc = e & 0xFFFF;
    __syncthreads();  // the previous cluster's records are consumed
    stage_coef(coef, jc, c, rec);
    __syncthreads();
    for (int j = 0; j < c; ++j) {
      float t, det;
      if (mt_test(r, rec + j * REC, t, det) && t < best_t) {
        best_t = t;
        best_i = jc * c + j;
      }
    }
    bound = bound_key(fminf(block_max(best_t, red), tmax_blk), scale, t_cap);
  }
  t_out[(size_t)b * RAY_BLOCK + threadIdx.x] = best_t;
  idx_out[(size_t)b * RAY_BLOCK + threadIdx.x] = best_i;
}

__global__ void __launch_bounds__(RAY_BLOCK)
occlusion_kernel(const float* __restrict__ raysT,
                 const float* __restrict__ coef, const float* __restrict__ aux,
                 const int* __restrict__ tflags, const int* __restrict__ sched,
                 const int* __restrict__ counts,
                 const float* __restrict__ params, float* __restrict__ ar_out,
                 float* __restrict__ ag_out, float* __restrict__ ab_out, int c,
                 int sw) {
  extern __shared__ float4 smem4[];
  float* rec = reinterpret_cast<float*>(smem4);
  float* auxs = rec + (size_t)c * REC;  // [5][c]: transp, sa rgb, 1/|n|
  __shared__ float red[NWARP];
  const int b = blockIdx.x;
  const Ray r = load_ray(raysT, b);
  const int tmax_key = bound_key(block_max(r.tmax, red), params[0], params[1]);
  const int count = counts[b];
  const int* row = sched + (size_t)b * 2 * sw;

  float ar = 1.0f, ag = 1.0f, ab = 1.0f;
  for (int l = 0; l < count; ++l) {
    const int e = row[l];
    if ((e >> 16) > tmax_key) break;  // the schedule is past every t_max
    const int jc = e & 0xFFFF;
    const bool transparent = tflags[jc] == 1;  // uniform across the block
    __syncthreads();
    stage_coef(coef, jc, c, rec);
    if (transparent) {
      const float* src = aux + (size_t)jc * 8 * c;
      for (int i = threadIdx.x; i < 5 * c; i += RAY_BLOCK) auxs[i] = src[i];
    }
    __syncthreads();
    if (transparent) {
      // product of per-hit Fresnel transmission factors
      // (refraction.cu shadow any-hit); opaque hits give 0
      for (int j = 0; j < c; ++j) {
        float t, det;
        if (!mt_test(r, rec + j * REC, t, det)) continue;
        if (auxs[j] > 0.0f) {
          const float ndi = fabsf(det) * auxs[4 * c + j];
          const float c1 = fminf(fmaxf(1.0f - ndi, 0.0f), 1.0f);
          float c5 = c1 * c1;
          c5 = c5 * c5 * c1;
          const float sr = auxs[c + j], sg = auxs[2 * c + j],
                      sb = auxs[3 * c + j];
          ar *= fminf(fmaxf(1.0f - ((1.0f - sr) + sr * c5), 0.0f), 1.0f);
          ag *= fminf(fmaxf(1.0f - ((1.0f - sg) + sg * c5), 0.0f), 1.0f);
          ab *= fminf(fmaxf(1.0f - ((1.0f - sb) + sb * c5), 0.0f), 1.0f);
        } else {
          ar *= 0.0f;
          ag *= 0.0f;
          ab *= 0.0f;
        }
      }
    } else {
      // all-opaque cluster: any hit blocks the light
      for (int j = 0; j < c; ++j) {
        float t, det;
        if (mt_test(r, rec + j * REC, t, det)) {
          ar *= 0.0f;
          ag *= 0.0f;
          ab *= 0.0f;
          break;
        }
      }
    }
    // stop once every ray of the block is fully occluded
    if (!__syncthreads_or(ar + ag + ab > 0.0f)) break;
  }
  const size_t o = (size_t)b * RAY_BLOCK + threadIdx.x;
  ar_out[o] = ar;
  ag_out[o] = ag;
  ab_out[o] = ab;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = success). Launches on
// `stream`, allocates nothing, does not synchronise.
int fov_closest_hit(const float* raysT, const float* coef, const int* sched,
                    const int* counts, const float* params, float* t_out,
                    int* idx_out, int nb, int nc, int c, int sw,
                    cudaStream_t stream) {
  (void)nc;
  const size_t smem = (size_t)c * REC * sizeof(float);
  cudaError_t err = set_smem((const void*)closest_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  closest_kernel<<<nb, RAY_BLOCK, smem, stream>>>(raysT, coef, sched, counts,
                                                  params, t_out, idx_out, c,
                                                  sw);
  return (int)cudaGetLastError();
}

int fov_occlusion(const float* raysT, const float* coef, const float* aux,
                  const int* tflags, const int* sched, const int* counts,
                  const float* params, float* ar, float* ag, float* ab, int nb,
                  int nc, int c, int sw, cudaStream_t stream) {
  (void)nc;
  const size_t smem = (size_t)c * (REC + 5) * sizeof(float);
  cudaError_t err = set_smem((const void*)occlusion_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  occlusion_kernel<<<nb, RAY_BLOCK, smem, stream>>>(
      raysT, coef, aux, tflags, sched, counts, params, ar, ag, ab, c, sw);
  return (int)cudaGetLastError();
}

}  // extern "C"
