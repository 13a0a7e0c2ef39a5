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
// The resident pair. One CUDA block of 256 threads per 256-ray block,
// one thread per ray; the ray's 10 features, t_min and t_max stay in
// registers. The block walks its schedule in order. For each cluster it
// stages the 10 live coefficient rows x 4c (20 KB at c = 128) into
// shared memory with coalesced loads, transposed into one 40-float
// record per triangle, so a thread reads a triangle's four 10-term
// coefficient vectors as ten 16-byte broadcast loads. Each thread then
// runs the four dot products in float32 FMA (at least as precise as the
// TPU's bf16x3 split) and the Moller-Trumbore epilogue. The closest-hit
// kernel keeps a running (t, triangle) with a strict `<`, so ties go to
// the lowest lane and the earliest cluster; the TPU's packed
// (t_bits & ~127) | lane reduction key is not needed. After each
// cluster a block max of the best t gives the break bound, uniform
// across the block.
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
// two-slot scratch while the previous entry computes. Here:
// - Records. Rows 0-9 of the pack are laid out once per pack as
//   per-triangle records rec[jc][j][q*10 + k] (triangle_records in
//   kernels/cluster_isect.py), so a member is one contiguous c x 160-byte
//   slab (20 KB at c = 128); a transparent member's aux rows 0-4 already
//   are one 20c-byte slab of the [NC,8,c] aux.
// - Ring. Thread 0 walks the block's live (entry, member) pairs in the
//   reference's order and copies each slab with one 1-D bulk (TMA) copy
//   into a ring of up to 4 stages, each with a full and an empty
//   mbarrier (tma.cuh), running up to 3 pairs ahead; every warp waits on
//   a stage's full barrier and arrives on its empty one when done. The
//   copy costs the other threads no instructions.
// - Tiling. Each thread holds R = 4 rays and takes every R-th
//   triangle of a member; the R lanes that share rays sit in one warp.
//   One record read (ten 16-byte shared loads) feeds 40 R FMAs. Each
//   pair's arithmetic is mt_test's in the same order (fmaf over k = 0..9,
//   --fmad=false), so its t, det and hit are bit for bit the resident
//   kernel's; the division runs only for a pair inside the triangle's
//   edges, in one branch per triangle that few take.
// - Merge. Closest hit: a lane keeps a (t, id) per ray over its
//   triangles, and the lanes of a ray merge them by shuffles at the end
//   of each entry (merge_closest): the strict-`<` minimum over the walk,
//   ties to the earliest member and lowest lane, exactly. Occlusion:
//   opaque hits zero a ray in any order; a transparent member's Fresnel
//   factors are multiplied per lane, then the lanes' products into the
//   attenuation in lane order. That may round unlike the resident
//   kernel's one sequential product, by a few ulp at most, and only for a
//   ray that meets two factors after the first.
// - Exits per warp, by the argument of the resident block break: a
//   schedule key lower-bounds the entry distance of every ray of the
//   block, and bound_key adds 2 against rounding. Closest hit: a warp
//   stops once the next entry's key exceeds bound_key of its rays'
//   largest merged best t (or t_max). Occlusion: once the key exceeds
//   bound_key of their largest t_max, or every one of them is fully
//   occluded (zero stays zero under factors clamped to [0, 1]); the
//   opaque test leaves a member once every ray of the warp is hit, a
//   warp-uniform check. A stopped warp still arrives on the ring, and
//   thread 0 stops staging once no warp's bound admits the next entry.
// - Heavy blocks. A ray block with more than HEAVY = 64 live entries is
//   split over SPLIT = 8 CTAs of 32 rays each (Tile, place): its walk,
//   which alone can outlast every other block (hundreds of member
//   clusters on city's bounce-0 rays against a mean near 10), then runs
//   on SPLIT SMs. Each CTA owns its rays, so nothing is merged across
//   CTAs. The grid holds the split CTAs of every ray block, since the host
//   does not know which blocks are heavy; those of a light block return
//   at once.
// Bound, as the resident pair, by per-pair arithmetic issue: 20 KB of
// records per (block, member) feed 256 x 128 pairs.
//
// Built by nvcc with --fmad=false: the epilogue then rounds exactly like
// the plain PyTorch version; the dot products use explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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

// ---------------------------------------------------------- streaming pair
constexpr int RING = 4;            // most stages in a block's ring
constexpr unsigned ALL = 0xffffffffu;
constexpr int SLOT_TRANSPARENT = 1;  // slot flags
constexpr int SLOT_LAST = 2;         // the entry's last live member
// stage bytes up to which a ring keeps RING stages; two blocks of 256
// threads then share an SM
constexpr size_t RING_SMEM = 113 * 1024;
// rays per thread (4 ran 13-32% faster than 2 on city's main-path shapes)
constexpr int R = 4;
// a ray block with more than HEAVY live entries is heavy: its rays are
// split over SPLIT CTAs of RAY_BLOCK / SPLIT
constexpr int HEAVY = 64;
constexpr int SPLIT = 8;

// warp-wide max; every lane gets the result
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(ALL, v, o));
  return v;
}

__device__ __forceinline__ float max_of(const float (&v)[R]) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i) r = fmaxf(r, v[i]);
  return r;
}

// v[i] for i == g, without a dynamic index into registers
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[R], int g) {
  T r = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i)
    if (g == i) r = v[i];
  return r;
}

// Where a CTA's threads sit. The grid holds SPLIT CTAs for each of the
// first `nsplit` ray blocks (nb, or 0 where no block may split) as if it
// were heavy (more than `heavy_at` live entries: HEAVY on the render
// path), first so that they start first, then one CTA per ray block as if
// it were light; a CTA whose ray block is of the other kind returns at
// once. Each thread holds R rays and the gw lanes of a ray group share
// them, each lane taking triangles g, g + gw, ... of every member. A
// light block's CTA takes its 256 rays with gw = R; a heavy block's CTA
// takes RAY_BLOCK / SPLIT of them with gw = SPLIT * R, so the block's
// walk runs on SPLIT SMs at once. Either way a warp holds whole groups.
struct Tile {
  int b;          // ray block
  int gw;         // lanes per ray group: each lane takes triangles g + gw k
  int g;          // this lane's place in its group
  int q0;         // the block's index of this thread's first ray
  unsigned lead;  // the first lane of every group in a warp, as a bitmask
};

__device__ __forceinline__ bool place(const int* __restrict__ counts,
                                      int heavy_at, int nsplit, Tile& t) {
  const int x = blockIdx.x;
  const bool heavy_cta = x < SPLIT * nsplit;
  t.b = heavy_cta ? x / SPLIT : x - SPLIT * nsplit;
  if ((counts[t.b] > heavy_at) != heavy_cta) return false;
  t.gw = heavy_cta ? SPLIT * R : R;
  t.g = threadIdx.x % t.gw;
  t.q0 = (heavy_cta ? x % SPLIT * (RAY_BLOCK / SPLIT) : 0) +
         threadIdx.x / t.gw * R;
  t.lead = 0;
  for (int k = 0; k < 32; k += t.gw) t.lead |= 1u << k;
  return true;
}

// A block's ring of record stages: the state beside the stages
// themselves (dynamic shared memory, `stages` x stage bytes).
struct Ring {
  uint64_t full[RING];   // the stage's copy has landed: 1 arrival + bytes
  uint64_t empty[RING];  // every warp is done with the stage: NWARP arrivals
  int4 slot[RING];       // what the stage holds: cluster id (-1: the walk
                         // has ended), entry, entry key, SLOT_* flags
  int wbound[NWARP];     // each warp's bound key; -1 once it has stopped
  int wtested[NWARP];    // member clusters each warp computed
};

__device__ __forceinline__ void publish_bound(Ring& rs, int w, int v) {
  reinterpret_cast<volatile int*>(rs.wbound)[w] = v;
}

// Barriers and every warp's first bound; a block barrier follows.
__device__ __forceinline__ void ring_open(Ring& rs, int bound) {
  if ((threadIdx.x & 31) == 0) rs.wbound[threadIdx.x >> 5] = bound;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_addr(&rs.full[s]), 1);
      mbar_init(smem_addr(&rs.empty[s]), NWARP);
    }
  }
  __syncthreads();
}

// Thread 0's side of the ring. It walks the block's live (entry, member)
// pairs and puts pair n into stage n % stages with one bulk copy of the
// member's records (and a second of its aux rows 0-4 for a transparent
// member in occlusion), once every warp has released pair n - stages.
// It writes the end instead once the walk is over or the next entry's key
// exceeds every warp's bound: bounds only fall and keys only rise, so no
// warp would compute that entry or a later one (a bound read before a
// warp lowered it is larger, so it can only delay the end).
struct Producer {
  PairWalk walk;
  const float* rec;    // [NC, c, REC]
  const float* aux;    // [NC, 8, c], nullptr for closest hit
  const int* tflags;   // [NC]
  unsigned stage0, stage_bytes;
  int c, stages;
  bool have = false, ended = false;
  int l = 0, jc = 0;   // the walk's next pair

  __device__ __forceinline__ void issue(Ring& rs, int n) {
    if (ended) return;
    const int s = n % stages;
    if (n >= stages)
      mbar_wait(smem_addr(&rs.empty[s]), (n / stages - 1) & 1);
    int hi = -1;
    const volatile int* wb = rs.wbound;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) hi = max(hi, wb[w]);
    const unsigned full = smem_addr(&rs.full[s]);
    const int key = have ? walk.row[l] >> 16 : 0;
    if (!have || key > hi) {
      rs.slot[s] = make_int4(-1, 0, 0, 0);
      mbar_arrive(full);  // completes the phase: no bytes expected
      ended = true;
      return;
    }
    const int lc = l, jcc = jc;
    have = walk.next(l, jc);
    const bool tr = aux != nullptr && tflags[jcc] == 1;
    rs.slot[s] = make_int4(jcc, lc, key,
                           (tr ? SLOT_TRANSPARENT : 0) |
                               (!have || l != lc ? SLOT_LAST : 0));
    const unsigned rec_bytes = (unsigned)c * REC * sizeof(float);
    const unsigned aux_bytes = (unsigned)c * 5 * sizeof(float);
    const unsigned dst = stage0 + (unsigned)s * stage_bytes;
    mbar_expect_tx(full, rec_bytes + (tr ? aux_bytes : 0u));
    bulk_g2s(dst, rec + (size_t)jcc * c * REC, rec_bytes, full);
    if (tr)
      bulk_g2s(dst + rec_bytes, aux + (size_t)jcc * 8 * c, aux_bytes, full);
  }

  // pairs 0 .. stages - 2, before the first wait on the ring
  __device__ __forceinline__ void prime(Ring& rs) {
    have = walk.next(l, jc);
    for (int n = 0; n + 1 < stages; ++n) issue(rs, n);
  }
};

// every warp has finished with the stage
__device__ __forceinline__ void ring_release(Ring& rs, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(smem_addr(&rs.empty[s]));
}

// rays q0 .. q0 + R - 1 of block b: features, t_min, t_max
__device__ __forceinline__ void load_rays(const float* __restrict__ raysT,
                                          int b, int q0, float (&f)[R][NFEAT],
                                          float (&tmin)[R], float (&tmax)[R]) {
  const float* p = raysT + (size_t)b * 16 * RAY_BLOCK + q0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < NFEAT; ++k) f[i][k] = p[k * RAY_BLOCK + i];
    tmin[i] = p[10 * RAY_BLOCK + i];
    tmax[i] = p[11 * RAY_BLOCK + i];
  }
}

// The four 10-term dot products of one triangle record with R rays: one
// record read (ten 16-byte loads) feeds 40 R FMAs, each sum in the order
// of mt_test
__device__ __forceinline__ void dots(const float (&f)[R][NFEAT],
                                     const float* rec, float (&tn)[R],
                                     float (&dt)[R], float (&un)[R],
                                     float (&vn)[R]) {
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
#pragma unroll
  for (int i = 0; i < R; ++i) {
    tn[i] = 0.0f;
    dt[i] = 0.0f;
    un[i] = 0.0f;
    vn[i] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NFEAT; ++k) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      tn[i] = fmaf(f[i][k], s[k], tn[i]);
      dt[i] = fmaf(f[i][k], s[NFEAT + k], dt[i]);
      un[i] = fmaf(f[i][k], s[2 * NFEAT + k], un[i]);
      vn[i] = fmaf(f[i][k], s[3 * NFEAT + k], vn[i]);
    }
  }
}

// mt_test's edge tests on one pair's dot products: inside the triangle
// with a usable det. Most pairs fail them; mt_test's t, which needs the
// division, matters only for those that pass
__device__ __forceinline__ bool inside(float dt, float un, float vn) {
  const float ud = un * dt;
  const float vd = vn * dt;
  return (fabsf(dt) > DET_EPS) & (ud >= 0.0f) & (vd >= 0.0f) &
         (ud + vd <= dt * dt);
}

// mt_test's t for a pair inside the edges, where its 1 / (big ? det : 1)
// is 1 / det: the same rounding
__device__ __forceinline__ float hit_t(float tn, float dt) {
  return tn * (1.0f / dt);
}

// one member's closest-hit update over this thread's triangles j = g,
// g + gw, ...: a running (t, id) per ray, strict `<`, lanes ascending.
// The division and the update run in one branch per triangle, taken
// only when one of the thread's R pairs is inside the edges
__device__ __forceinline__ void closest_member(
    const float (&f)[R][NFEAT], const float (&tmin)[R], const float (&tmax)[R],
    const float* slab, int base, int c, const Tile& tl, float (&bt)[R],
    int (&bi)[R]) {
  for (int j = tl.g; j < c; j += tl.gw) {
    float tn[R], dt[R], un[R], vn[R];
    dots(f, slab + j * REC, tn, dt, un, vn);
    bool in[R], any = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      in[i] = inside(dt[i], un[i], vn[i]);
      any = any || in[i];
    }
    if (!any) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!in[i]) continue;
      const float t = hit_t(tn[i], dt[i]);
      if (t > tmin[i] && t < tmax[i] && t < bt[i]) {
        bt[i] = t;
        bi[i] = base + j;
      }
    }
  }
}

// The gw lanes of a ray group agree on each ray's (t, id): the least t,
// ties to the least id. Merged at the end of each entry: a lane's state
// then differs from the last merge only by a t strictly below it, so two
// lanes tie only on candidates of this entry, whose order (member, then
// lane) is that of their ids sc * M * c + mi * c + j. That is the
// sequential kernel's strict-`<` minimum over the walk.
__device__ __forceinline__ void merge_closest(float (&bt)[R], int (&bi)[R],
                                              int gw) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    for (int o = 1; o < gw; o <<= 1) {
      const float to = __shfl_xor_sync(ALL, bt[i], o);
      const int io = __shfl_xor_sync(ALL, bi[i], o);
      if (to < bt[i] || (to == bt[i] && io < bi[i])) {
        bt[i] = to;
        bi[i] = io;
      }
    }
  }
}

// from a ballot over the warp: is some lane of every ray group set?
__device__ __forceinline__ bool every_group(unsigned bits, const Tile& tl) {
  for (int o = 1; o < tl.gw; o <<= 1) bits |= bits >> o;
  return (bits & tl.lead) == tl.lead;
}

// one member's shadow update of the running attenuation (ar, ag, ab);
// every lane of a ray group holds the same values before and after
__device__ __forceinline__ void occlusion_member(
    const float (&f)[R][NFEAT], const float (&tmin)[R], const float (&tmax)[R],
    const float* slab, int c, const Tile& tl, bool transparent, float (&ar)[R],
    float (&ag)[R], float (&ab)[R]) {
  if (transparent) {
    // this lane's triangles' Fresnel factors (refraction.cu shadow
    // any-hit; opaque hits give 0), then the group's partial products
    // into the attenuation in lane order
    const float* auxs = slab + c * REC;  // [5][c]: transp, sa rgb, 1/|n|
    float pr[R], pg[R], pb[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pr[i] = pg[i] = pb[i] = 1.0f;
    for (int j = tl.g; j < c; j += tl.gw) {
      float tn[R], dt[R], un[R], vn[R];
      dots(f, slab + j * REC, tn, dt, un, vn);
      bool in[R], any = false;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        in[i] = inside(dt[i], un[i], vn[i]);
        any = any || in[i];
      }
      if (!any) continue;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!in[i]) continue;
        const float t = hit_t(tn[i], dt[i]);
        if (!(t > tmin[i] && t < tmax[i])) continue;
        if (auxs[j] > 0.0f) {
          const float ndi = fabsf(dt[i]) * auxs[4 * c + j];
          const float c1 = fminf(fmaxf(1.0f - ndi, 0.0f), 1.0f);
          float c5 = c1 * c1;
          c5 = c5 * c5 * c1;
          const float sr = auxs[c + j], sg = auxs[2 * c + j],
                      sb = auxs[3 * c + j];
          pr[i] *= fminf(fmaxf(1.0f - ((1.0f - sr) + sr * c5), 0.0f), 1.0f);
          pg[i] *= fminf(fmaxf(1.0f - ((1.0f - sg) + sg * c5), 0.0f), 1.0f);
          pb[i] *= fminf(fmaxf(1.0f - ((1.0f - sb) + sb * c5), 0.0f), 1.0f);
        } else {
          pr[i] *= 0.0f;
          pg[i] *= 0.0f;
          pb[i] *= 0.0f;
        }
      }
    }
    const int first = (threadIdx.x & 31) & ~(tl.gw - 1);
    for (int q = 0; q < tl.gw; ++q) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ar[i] *= __shfl_sync(ALL, pr[i], first + q);
        ag[i] *= __shfl_sync(ALL, pg[i], first + q);
        ab[i] *= __shfl_sync(ALL, pb[i], first + q);
      }
    }
  } else {
    // all-opaque member: any hit blocks the light. The warp leaves the
    // member's triangles together, once every one of its rays is hit by
    // some lane of its group or was dark already; it looks only after a
    // step in which some lane had a pair inside the edges
    bool hit[R], dark[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hit[i] = false;
      dark[i] = !(ar[i] + ag[i] + ab[i] > 0.0f);
    }
    for (int j = tl.g; j < c; j += tl.gw) {
      float tn[R], dt[R], un[R], vn[R];
      dots(f, slab + j * REC, tn, dt, un, vn);
      bool in[R], any = false;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        in[i] = inside(dt[i], un[i], vn[i]);
        any = any || in[i];
      }
      if (!__any_sync(ALL, any)) continue;
      bool done = true;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (in[i]) {
          const float t = hit_t(tn[i], dt[i]);
          hit[i] = hit[i] || (t > tmin[i] && t < tmax[i]);
        }
        done = every_group(__ballot_sync(ALL, hit[i] || dark[i]), tl) && done;
      }
      if (done) break;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      bool any = hit[i];
#pragma unroll
      for (int o = 1; o < tl.gw; o <<= 1)
        any = __shfl_xor_sync(ALL, (int)any, o) != 0 || any;
      if (any) {
        ar[i] *= 0.0f;
        ag[i] *= 0.0f;
        ab[i] *= 0.0f;
      }
    }
  }
}

// The work counts, into zeroed outputs (a heavy block's CTAs add up):
// visited, the member clusters the block tested (some warp computed
// them: each warp computes a prefix of the walk); ray_visited, rays x
// member clusters its warps computed, so ray_visited * c is the pairs
__device__ __forceinline__ void count_tested(Ring& rs, const Tile& tl,
                                             int tested, int* visited,
                                             int* ray_visited) {
  if (visited == nullptr && ray_visited == nullptr) return;
  if ((threadIdx.x & 31) == 0) rs.wtested[threadIdx.x >> 5] = tested;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int most = 0, sum = 0;
  for (int v = 0; v < NWARP; ++v) {
    most = max(most, rs.wtested[v]);
    sum += rs.wtested[v];
  }
  const int rays_per_warp = 32 / tl.gw * R;
  if (visited != nullptr) atomicMax(visited + tl.b, most);
  if (ray_visited != nullptr)
    atomicAdd(ray_visited + tl.b, sum * rays_per_warp);
}

__global__ void __launch_bounds__(RAY_BLOCK, 2)
closest_stream_kernel(const float* __restrict__ raysT,
                      const float* __restrict__ rec,
                      const int* __restrict__ sched,
                      const int* __restrict__ counts,
                      const float* __restrict__ params,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      int* __restrict__ visited, int* __restrict__ ray_visited,
                      int c, int sw, int m, int stages, int heavy_at,
                      int nsplit) {
  extern __shared__ float4 smem4[];
  const float* const ring = reinterpret_cast<const float*>(smem4);
  __shared__ Ring rs;
  Tile tl;
  if (!place(counts, heavy_at, nsplit, tl)) return;
  const int b = tl.b;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float f[R][NFEAT], tmin[R], tmax[R];
  load_rays(raysT, b, tl.q0, f, tmin, tmax);
  const float scale = params[0];
  const float t_cap = params[1];
  const float tmax_w = warp_max(max_of(tmax));
  int bound = bound_key(tmax_w, scale, t_cap);
  const int stride = c * REC;
  Producer prod{PairWalk{sched + (size_t)b * 2 * sw, sw, counts[b], m},
                rec, nullptr, nullptr, smem_addr(smem4),
                (unsigned)(stride * sizeof(float)), c, stages};
  ring_open(rs, bound);
  if (threadIdx.x == 0) prod.prime(rs);

  float bt[R];
  int bi[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    bt[i] = BIG_T;
    bi[i] = -1;
  }
  int tested = 0, entry = -1, s = 0;
  unsigned phase = 0;
  bool active = true;
  for (int k = 0;; ++k) {
    if (threadIdx.x == 0) prod.issue(rs, k + stages - 1);
    __syncwarp();
    mbar_wait(smem_addr(&rs.full[s]), phase);
    const int4 d = rs.slot[s];
    if (d.x < 0) break;
    // front to back, decided per warp and entry: a key above the bound
    // of the warp's largest best t (or t_max) means no triangle of this
    // entry or a later one is closer for any of its rays
    if (active && d.y != entry) {
      entry = d.y;
      if (d.z > bound) {
        active = false;
        if (lane == 0) publish_bound(rs, w, -1);
      }
    }
    if (active) {
      closest_member(f, tmin, tmax, ring + s * stride, d.x * c, c, tl, bt,
                        bi);
      ++tested;
      if (d.w & SLOT_LAST) {
        merge_closest(bt, bi, tl.gw);
        bound = bound_key(fminf(warp_max(max_of(bt)), tmax_w), scale,
                          t_cap);
        if (lane == 0) publish_bound(rs, w, bound);
      }
    }
    ring_release(rs, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  // every copy has landed: each warp waited on every stage up to the end
  merge_closest(bt, bi, tl.gw);
  if (tl.g < R) {
    t_out[(size_t)b * RAY_BLOCK + tl.q0 + tl.g] = pick(bt, tl.g);
    idx_out[(size_t)b * RAY_BLOCK + tl.q0 + tl.g] = pick(bi, tl.g);
  }
  count_tested(rs, tl, tested, visited, ray_visited);
}

__global__ void __launch_bounds__(RAY_BLOCK, 2)
occlusion_stream_kernel(const float* __restrict__ raysT,
                        const float* __restrict__ rec,
                        const float* __restrict__ aux,
                        const int* __restrict__ tflags,
                        const int* __restrict__ sched,
                        const int* __restrict__ counts,
                        const float* __restrict__ params,
                        float* __restrict__ ar_out, float* __restrict__ ag_out,
                        float* __restrict__ ab_out, int* __restrict__ visited,
                        int* __restrict__ ray_visited, int c, int sw, int m,
                        int stages, int heavy_at, int nsplit) {
  extern __shared__ float4 smem4[];
  const float* const ring = reinterpret_cast<const float*>(smem4);
  __shared__ Ring rs;
  Tile tl;
  if (!place(counts, heavy_at, nsplit, tl)) return;
  const int b = tl.b;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float f[R][NFEAT], tmin[R], tmax[R];
  load_rays(raysT, b, tl.q0, f, tmin, tmax);
  const int tkey = bound_key(warp_max(max_of(tmax)), params[0], params[1]);
  const int stride = c * (REC + 5);  // c records, then the [5][c] aux rows
  Producer prod{PairWalk{sched + (size_t)b * 2 * sw, sw, counts[b], m},
                rec, aux, tflags, smem_addr(smem4),
                (unsigned)(stride * sizeof(float)), c, stages};
  ring_open(rs, tkey);
  if (threadIdx.x == 0) prod.prime(rs);

  float ar[R], ag[R], ab[R];
#pragma unroll
  for (int i = 0; i < R; ++i) ar[i] = ag[i] = ab[i] = 1.0f;
  int tested = 0, entry = -1, s = 0;
  unsigned phase = 0;
  bool active = true;
  for (int k = 0;; ++k) {
    if (threadIdx.x == 0) prod.issue(rs, k + stages - 1);
    __syncwarp();
    mbar_wait(smem_addr(&rs.full[s]), phase);
    const int4 d = rs.slot[s];
    if (d.x < 0) break;
    // the schedule is past every t_max of the warp's rays
    if (active && d.y != entry) {
      entry = d.y;
      if (d.z > tkey) {
        active = false;
        if (lane == 0) publish_bound(rs, w, -1);
      }
    }
    if (active) {
      occlusion_member(f, tmin, tmax, ring + s * stride, c, tl,
                          (d.w & SLOT_TRANSPARENT) != 0, ar, ag, ab);
      ++tested;
      // every ray of the warp fully occluded: zero stays zero under
      // factors clamped to [0, 1]
      bool lit = false;
#pragma unroll
      for (int i = 0; i < R; ++i) lit = lit || ar[i] + ag[i] + ab[i] > 0.0f;
      if (!__any_sync(ALL, lit)) {
        active = false;
        if (lane == 0) publish_bound(rs, w, -1);
      }
    }
    ring_release(rs, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if (tl.g < R) {
    const size_t o = (size_t)b * RAY_BLOCK + tl.q0 + tl.g;
    ar_out[o] = pick(ar, tl.g);
    ag_out[o] = pick(ag, tl.g);
    ab_out[o] = pick(ab, tl.g);
  }
  count_tested(rs, tl, tested, visited, ray_visited);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ring stages for one stage of `stage` bytes: RING while two blocks of
// RING stages share an SM, else fewer, down to 2
int ring_stages(size_t stage) {
  int s = RING;
  while (s > 2 && s * stage > RING_SMEM) --s;
  return s;
}

// The grid: SPLIT CTAs for each of the first nsplit ray blocks, then one
// per ray block (see place)
int launch_closest_stream(const float* raysT, const float* rec,
                          const int* sched, const int* counts,
                          const float* params, float* t_out, int* idx_out,
                          int* visited, int* ray_visited, int nb, int c,
                          int sw, int m, int heavy_at, int nsplit,
                          cudaStream_t stream) {
  const size_t stage = (size_t)c * REC * sizeof(float);
  const int stages = ring_stages(stage);
  const size_t smem = stages * stage;
  cudaError_t err = set_smem((const void*)closest_stream_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  closest_stream_kernel<<<SPLIT * nsplit + nb, RAY_BLOCK, smem, stream>>>(
      raysT, rec, sched, counts, params, t_out, idx_out, visited, ray_visited,
      c, sw, m, stages, heavy_at, nsplit);
  return (int)cudaGetLastError();
}

int launch_occlusion_stream(const float* raysT, const float* rec,
                            const float* aux, const int* tflags,
                            const int* sched, const int* counts,
                            const float* params, float* ar, float* ag,
                            float* ab, int* visited, int* ray_visited, int nb,
                            int c, int sw, int m, int heavy_at, int nsplit,
                            cudaStream_t stream) {
  const size_t stage = (size_t)c * (REC + 5) * sizeof(float);
  const int stages = ring_stages(stage);
  const size_t smem = stages * stage;
  cudaError_t err = set_smem((const void*)occlusion_stream_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  occlusion_stream_kernel<<<SPLIT * nsplit + nb, RAY_BLOCK, smem, stream>>>(
      raysT, rec, aux, tflags, sched, counts, params, ar, ag, ab, visited,
      ray_visited, c, sw, m, stages, heavy_at, nsplit);
  return (int)cudaGetLastError();
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

// The streaming pair takes the triangle records rec [NC, c, 40] (see
// triangle_records in kernels/cluster_isect.py) in place of the pack;
// `visited` and `ray_visited` (either may be NULL) must be zeroed, and
// ray_visited receives rays x member clusters computed per block. Ray
// blocks with more than HEAVY live entries are split over SPLIT CTAs.
int fov_closest_hit_stream(const float* raysT, const float* rec,
                           const int* sched, const int* counts,
                           const float* params, float* t_out, int* idx_out,
                           int* visited, int* ray_visited, int nb, int c,
                           int sw, int m, cudaStream_t stream) {
  return launch_closest_stream(raysT, rec, sched, counts, params, t_out,
                               idx_out, visited, ray_visited, nb, c, sw, m,
                               HEAVY, nb, stream);
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

int fov_occlusion_stream(const float* raysT, const float* rec,
                         const float* aux, const int* tflags,
                         const int* sched, const int* counts,
                         const float* params, float* ar, float* ag, float* ab,
                         int* visited, int* ray_visited, int nb, int c,
                         int sw, int m, cudaStream_t stream) {
  return launch_occlusion_stream(raysT, rec, aux, tflags, sched, counts,
                                 params, ar, ag, ab, visited, ray_visited, nb,
                                 c, sw, m, HEAVY, nb, stream);
}

// For tests and measurement only: the streaming pair with the split
// forced. A ray block splits when it has more than `heavy_at` live
// entries (-1: every block), and only the first `nsplit` blocks (nb or 0)
// get the SPLIT CTAs a split needs; with nsplit = nb and no heavy block,
// those CTAs all return at once.
int fov_closest_hit_stream_split(const float* raysT, const float* rec,
                                 const int* sched, const int* counts,
                                 const float* params, float* t_out,
                                 int* idx_out, int* visited, int* ray_visited,
                                 int nb, int c, int sw, int m, int heavy_at,
                                 int nsplit, cudaStream_t stream) {
  return launch_closest_stream(raysT, rec, sched, counts, params, t_out,
                               idx_out, visited, ray_visited, nb, c, sw, m,
                               heavy_at, nsplit, stream);
}

int fov_occlusion_stream_split(const float* raysT, const float* rec,
                               const float* aux, const int* tflags,
                               const int* sched, const int* counts,
                               const float* params, float* ar, float* ag,
                               float* ab, int* visited, int* ray_visited,
                               int nb, int c, int sw, int m, int heavy_at,
                               int nsplit, cudaStream_t stream) {
  return launch_occlusion_stream(raysT, rec, aux, tflags, sched, counts,
                                 params, ar, ag, ab, visited, ray_visited, nb,
                                 c, sw, m, heavy_at, nsplit, stream);
}

}  // extern "C"
