// Cluster ray/triangle intersection kernels for Hopper (sm_90a).
//
// Replace the four Pallas kernels of fovtrace/kernels/pallas_isect.py:
//   closest_kernel           <- _closest_kernel (:518, with
//                               _closest_update, _mt_epilogue, _bound_key)
//   occlusion_kernel         <- _occlusion_kernel (:806, _occlusion_update)
//   closest_stream_kernel    <- _closest_kernel_stream (:577)
//   occlusion_stream_kernel  <- _occlusion_kernel_stream (:850)
// They compute the same results from the same inputs: the [NB,16,256]
// ray feature blocks, the [NC,16,4c] Cramer coefficient pack, and the
// front-to-back schedule of live entries per ray block. The resident
// pair takes the flat (M == 1) schedule; the streaming pair takes any M,
// walking inside each entry (supercluster sc) the members mi whose
// liveness bit is set, cluster sc*M + mi (with M == 1 every entry, the
// bitmask unread, as in the reference).
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
// The streaming pair. On the TPU the pack (65 MB for the city scene)
// cannot sit in VMEM, so each entry's [M,16,4c] slab is DMA'd into a
// two-slot scratch while the previous entry computes. On the H100 the
// pack is read from L2/HBM by every kernel; what the double buffer keeps
// off the critical path is the slab's load latency. Each block has two
// shared-memory stages of one member slab each (20 KB at c = 128; 22.5
// KB with the aux rows for occlusion) and walks the live (entry, member)
// pairs of its row in order: while it tests pair k from one stage, the
// copy of pair k+1, possibly the next entry's first member, is in flight
// into the other as 4-byte cp.async element copies that transpose the
// coefficient rows into the resident kernel's per-triangle records
// (design (b): no second copy of the pack; coalesced global reads,
// scattered shared writes). The aux rows go as 16-byte cp.async copies,
// for transparent members only. A member-granular stage, not an
// entry-granular one: two stages of M slabs would need 2*M*20 KB, 640 KB
// at M = 16 (multi forced to M > 1 in the tests), over the 227 KB a block
// may have, while one-slab stages fit every M and prefetch the next live
// slab all the same. The break and the occlusion early exit are decided
// per entry, as on the TPU (supercluster-granular bound); on a break the
// one copy still in flight is waited for before the block exits (the
// TPU's drain). Bound as the resident pair: per (ray, triangle)
// arithmetic; the copy is 20 KB per 1.3M FMAs of work (256 rays x 128
// triangles x 40).
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

// record slot of element i of a cluster's coefficient rows 0..9:
// rec[(j * 4 + q) * NFEAT + k] = coef[jc][k][q * c + j]
__device__ __forceinline__ int rec_slot(int i, int c) {
  const int w4 = 4 * c;
  const int k = i / w4;
  const int col = i - k * w4;
  const int q = col / c;
  const int j = col - q * c;
  return (j * 4 + q) * NFEAT + k;
}

// stage cluster jc's coefficient rows 0..9 into per-triangle records
__device__ __forceinline__ void stage_coef(const float* __restrict__ coef,
                                           int jc, int c, float* rec) {
  const float* src = coef + (size_t)jc * 16 * 4 * c;
  for (int i = threadIdx.x; i < NFEAT * 4 * c; i += RAY_BLOCK)
    rec[rec_slot(i, c)] = src[i];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage_coef as asynchronous copies (committed by the caller)
__device__ __forceinline__ void stage_coef_async(
    const float* __restrict__ coef, int jc, int c, float* rec) {
  const float* src = coef + (size_t)jc * 16 * 4 * c;
  for (int i = threadIdx.x; i < NFEAT * 4 * c; i += RAY_BLOCK)
    cp_async4(rec + rec_slot(i, c), src + i);
}

// aux rows 0..4 of cluster jc (transparent flag, shadow attenuation rgb,
// 1/|n|) as [5][c], asynchronously; c is a multiple of 4
__device__ __forceinline__ void stage_aux_async(const float* __restrict__ aux,
                                                int jc, int c, float* auxs) {
  const float* src = aux + (size_t)jc * 8 * c;
  for (int i = 4 * threadIdx.x; i < 5 * c; i += 4 * RAY_BLOCK)
    cp_async16(auxs + i, src + i);
}

// The live (entry, member) pairs of one schedule row, in the order the
// reference kernels test them. Block-uniform: every thread walks the
// same row.
struct PairWalk {
  const int* row;
  int sw, count, m;
  int l = -1;
  unsigned bits = 0;

  // the next pair: its entry l and global cluster id jc; false at the end
  __device__ __forceinline__ bool next(int& le, int& jc) {
    while (bits == 0) {
      if (l + 1 >= count) return false;
      ++l;
      bits = m == 1 ? 1u : (unsigned)row[sw + l];
    }
    const int mi = __ffs(bits) - 1;
    bits &= bits - 1;
    le = l;
    jc = (row[l] & 0xFFFF) * m + mi;
    return true;
  }
};

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

// one cluster's closest-hit update of the running (best_t, best_i)
__device__ __forceinline__ void closest_update(const Ray& r, const float* rec,
                                               int jc, int c, float& best_t,
                                               int& best_i) {
  for (int j = 0; j < c; ++j) {
    float t, det;
    if (mt_test(r, rec + j * REC, t, det) && t < best_t) {
      best_t = t;
      best_i = jc * c + j;
    }
  }
}

// one cluster's shadow update of the running attenuation (ar, ag, ab)
__device__ __forceinline__ void occlusion_update(const Ray& r,
                                                 const float* rec,
                                                 const float* auxs, int c,
                                                 bool transparent, float& ar,
                                                 float& ag, float& ab) {
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
}

__global__ void __launch_bounds__(RAY_BLOCK)
closest_kernel(const float* __restrict__ raysT, const float* __restrict__ coef,
               const int* __restrict__ sched, const int* __restrict__ counts,
               const float* __restrict__ params, float* __restrict__ t_out,
               int* __restrict__ idx_out, int* __restrict__ visited, int c,
               int sw) {
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
  int tested = 0;
  for (int l = 0; l < count; ++l) {
    const int e = row[l];
    if ((e >> 16) > bound) break;  // front to back: nothing later is closer
    const int jc = e & 0xFFFF;
    __syncthreads();  // the previous cluster's records are consumed
    stage_coef(coef, jc, c, rec);
    __syncthreads();
    closest_update(r, rec, jc, c, best_t, best_i);
    ++tested;
    bound = bound_key(fminf(block_max(best_t, red), tmax_blk), scale, t_cap);
  }
  t_out[(size_t)b * RAY_BLOCK + threadIdx.x] = best_t;
  idx_out[(size_t)b * RAY_BLOCK + threadIdx.x] = best_i;
  if (visited != nullptr && threadIdx.x == 0) visited[b] = tested;
}

__global__ void __launch_bounds__(RAY_BLOCK)
closest_stream_kernel(const float* __restrict__ raysT,
                      const float* __restrict__ coef,
                      const int* __restrict__ sched,
                      const int* __restrict__ counts,
                      const float* __restrict__ params,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      int* __restrict__ visited, int c, int sw, int m) {
  extern __shared__ float4 smem4[];
  // two stages of c records; stage s at smem + s * c * REC (arithmetic,
  // not an array of pointers, which a dynamic index puts on the stack)
  float* const smem = reinterpret_cast<float*>(smem4);
  const int stride = c * REC;
  __shared__ float red[NWARP];
  const int b = blockIdx.x;
  const Ray r = load_ray(raysT, b);
  const float scale = params[0];
  const float t_cap = params[1];
  const float tmax_blk = block_max(r.tmax, red);
  int bound = bound_key(tmax_blk, scale, t_cap);
  const int* row = sched + (size_t)b * 2 * sw;
  PairWalk walk{row, sw, counts[b], m};

  float best_t = BIG_T;
  int best_i = -1;
  int tested = 0;
  int l, jc;
  bool have = walk.next(l, jc);
  if (have) stage_coef_async(coef, jc, c, smem);
  cp_async_commit();
  int slot = 0, entry = -1;
  while (have) {
    const int lc = l, jcc = jc;
    // front to back, decided per entry: nothing later is closer. Entries
    // skipped since the last check had no live member, and their keys
    // are <= this one's
    if (lc != entry) {
      if ((row[lc] >> 16) > bound) break;
      entry = lc;
    }
    have = walk.next(l, jc);  // prefetch the next pair into the other stage
    if (have) stage_coef_async(coef, jc, c, smem + (slot ^ 1) * stride);
    cp_async_commit();
    cp_async_wait<1>();  // this pair's slab has landed (own copies) ...
    __syncthreads();     // ... and every thread's
    closest_update(r, smem + slot * stride, jcc, c, best_t, best_i);
    ++tested;
    if (!have || l != lc)  // the entry's last live member
      bound = bound_key(fminf(block_max(best_t, red), tmax_blk), scale, t_cap);
    __syncthreads();  // the stage is consumed before it is refilled
    slot ^= 1;
  }
  cp_async_wait<0>();  // drain the copy a break leaves in flight
  t_out[(size_t)b * RAY_BLOCK + threadIdx.x] = best_t;
  idx_out[(size_t)b * RAY_BLOCK + threadIdx.x] = best_i;
  if (visited != nullptr && threadIdx.x == 0) visited[b] = tested;
}

__global__ void __launch_bounds__(RAY_BLOCK)
occlusion_kernel(const float* __restrict__ raysT,
                 const float* __restrict__ coef, const float* __restrict__ aux,
                 const int* __restrict__ tflags, const int* __restrict__ sched,
                 const int* __restrict__ counts,
                 const float* __restrict__ params, float* __restrict__ ar_out,
                 float* __restrict__ ag_out, float* __restrict__ ab_out,
                 int* __restrict__ visited, int c, int sw) {
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
  int tested = 0;
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
    occlusion_update(r, rec, auxs, c, transparent, ar, ag, ab);
    ++tested;
    // stop once every ray of the block is fully occluded
    if (!__syncthreads_or(ar + ag + ab > 0.0f)) break;
  }
  const size_t o = (size_t)b * RAY_BLOCK + threadIdx.x;
  ar_out[o] = ar;
  ag_out[o] = ag;
  ab_out[o] = ab;
  if (visited != nullptr && threadIdx.x == 0) visited[b] = tested;
}

__global__ void __launch_bounds__(RAY_BLOCK)
occlusion_stream_kernel(const float* __restrict__ raysT,
                        const float* __restrict__ coef,
                        const float* __restrict__ aux,
                        const int* __restrict__ tflags,
                        const int* __restrict__ sched,
                        const int* __restrict__ counts,
                        const float* __restrict__ params,
                        float* __restrict__ ar_out, float* __restrict__ ag_out,
                        float* __restrict__ ab_out, int* __restrict__ visited,
                        int c, int sw, int m) {
  extern __shared__ float4 smem4[];
  // stage s at smem + s * c * (REC + 5): c records of REC floats, then
  // the [5][c] aux rows
  float* const smem = reinterpret_cast<float*>(smem4);
  const int stride = c * (REC + 5);
  __shared__ float red[NWARP];
  const int b = blockIdx.x;
  const Ray r = load_ray(raysT, b);
  const int tmax_key = bound_key(block_max(r.tmax, red), params[0], params[1]);
  const int* row = sched + (size_t)b * 2 * sw;
  PairWalk walk{row, sw, counts[b], m};

  float ar = 1.0f, ag = 1.0f, ab = 1.0f;
  int tested = 0;
  int l, jc;
  bool have = walk.next(l, jc);
  if (have) {
    stage_coef_async(coef, jc, c, smem);
    if (tflags[jc] == 1) stage_aux_async(aux, jc, c, smem + c * REC);
  }
  cp_async_commit();
  int slot = 0, entry = -1;
  while (have) {
    const int lc = l, jcc = jc;
    if (lc != entry) {
      if ((row[lc] >> 16) > tmax_key) break;  // past every t_max
      entry = lc;
    }
    have = walk.next(l, jc);
    if (have) {
      float* nxt = smem + (slot ^ 1) * stride;
      stage_coef_async(coef, jc, c, nxt);
      if (tflags[jc] == 1) stage_aux_async(aux, jc, c, nxt + c * REC);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cur = smem + slot * stride;
    occlusion_update(r, cur, cur + c * REC, c, tflags[jcc] == 1, ar, ag, ab);
    ++tested;
    // after each entry: stop once every ray of the block is fully
    // occluded (a block-wide barrier either way)
    if (!have || l != lc) {
      if (!__syncthreads_or(ar + ag + ab > 0.0f)) break;
    } else {
      __syncthreads();
    }
    slot ^= 1;
  }
  cp_async_wait<0>();  // drain the copy a break leaves in flight
  const size_t o = (size_t)b * RAY_BLOCK + threadIdx.x;
  ar_out[o] = ar;
  ag_out[o] = ag;
  ab_out[o] = ab;
  if (visited != nullptr && threadIdx.x == 0) visited[b] = tested;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Each returns the CUDA error of the launch (0 = success). Launches on
// `stream`, allocates nothing, does not synchronise. `visited` may be
// NULL; else it receives the member clusters each block tested. The
// resident kernels take the flat schedule and ignore m.
int fov_closest_hit(const float* raysT, const float* coef, const int* sched,
                    const int* counts, const float* params, float* t_out,
                    int* idx_out, int* visited, int nb, int c, int sw, int m,
                    cudaStream_t stream) {
  (void)m;
  const size_t smem = (size_t)c * REC * sizeof(float);
  cudaError_t err = set_smem((const void*)closest_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  closest_kernel<<<nb, RAY_BLOCK, smem, stream>>>(
      raysT, coef, sched, counts, params, t_out, idx_out, visited, c, sw);
  return (int)cudaGetLastError();
}

int fov_closest_hit_stream(const float* raysT, const float* coef,
                           const int* sched, const int* counts,
                           const float* params, float* t_out, int* idx_out,
                           int* visited, int nb, int c, int sw, int m,
                           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)c * REC * sizeof(float);
  cudaError_t err = set_smem((const void*)closest_stream_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  closest_stream_kernel<<<nb, RAY_BLOCK, smem, stream>>>(
      raysT, coef, sched, counts, params, t_out, idx_out, visited, c, sw, m);
  return (int)cudaGetLastError();
}

int fov_occlusion(const float* raysT, const float* coef, const float* aux,
                  const int* tflags, const int* sched, const int* counts,
                  const float* params, float* ar, float* ag, float* ab,
                  int* visited, int nb, int c, int sw, int m,
                  cudaStream_t stream) {
  (void)m;
  const size_t smem = (size_t)c * (REC + 5) * sizeof(float);
  cudaError_t err = set_smem((const void*)occlusion_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  occlusion_kernel<<<nb, RAY_BLOCK, smem, stream>>>(
      raysT, coef, aux, tflags, sched, counts, params, ar, ag, ab, visited, c,
      sw);
  return (int)cudaGetLastError();
}

int fov_occlusion_stream(const float* raysT, const float* coef,
                         const float* aux, const int* tflags,
                         const int* sched, const int* counts,
                         const float* params, float* ar, float* ag, float* ab,
                         int* visited, int nb, int c, int sw, int m,
                         cudaStream_t stream) {
  const size_t smem = 2 * (size_t)c * (REC + 5) * sizeof(float);
  cudaError_t err = set_smem((const void*)occlusion_stream_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  occlusion_stream_kernel<<<nb, RAY_BLOCK, smem, stream>>>(
      raysT, coef, aux, tflags, sched, counts, params, ar, ag, ab, visited, c,
      sw, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
