// The environment map's bilinear lookup and its adjoint for Hopper
// (sm_90a).
//
//   envmap_lookup_kernel        <- the taps and bilerp of envmap_lookup_v,
//                                  fovtrace/render/shade.py:41
//   envmap_dxy_kernel           <- its gradient with respect to the
//                                  continuous texel coordinates (fx, fy)
//   envmap_adjoint_max_kernel   <- its gradient with respect to the map
//   envmap_adjoint_sum_kernel      (jax.vjp of the same lines), in three
//   envmap_adjoint_final_kernel    passes
//
// The reference is no Pallas kernel: one row gather from an [H*W, 12]
// quad table (a TPU workaround) whose transpose is XLA's scatter-add. A
// miss looks up the lat-long map at continuous texel coordinates
// (fx, fy), computed from the ray's direction in torch
// (render/shade.py): four edge-clamped taps, bilinear weights, times
// `scale`. A front is up to 2,088,960 rays (1920x1088); earth's map is
// 64 x 128 x 3 (98 KB), a file scene's HDR up to 800 x 1600 x 3.
//
// All five kernels are bound by bytes: the lookup reads fx, fy and writes
// three floats a ray (20 B), d(fx, fy) reads fx, fy and the [3, N]
// cotangent and writes two floats (28 B), the adjoint reads fx, fy and
// the cotangent (20 B) twice and writes the map once; none does more than
// a few dozen float operations per ray.
//
// The forward and d(fx, fy) keep the plain version's op order
// (kernels/envmap.py), so that they equal it bit for bit on the card:
//   x0 = clamp(floor(fx), 0, w - 1) through a 64-bit integer (a NaN casts
//   to 0), wx = fx - x0, x1 = min(x0 + 1, w - 1), and likewise in y;
//   top = fma(c00, 1 - wx, c01 * wx), bottom = fma(c10, 1 - wx, c11 * wx),
//   out = fma(top, 1 - wy, bottom * wy), then * scale;
//   per channel, gs = g * scale, gt = gs * (1 - wy), gb = gs * wy, and
//   d fx += gb * c11, -= gb * c10, += gt * c01, -= gt * c00,
//   d fy += gs * bottom, -= gs * top, one by one, channel 2 first (the
//   order in which autograd added them through the four-gather
//   expression the render path ran before, whose CPU bits it keeps).
// fma is the plain version's mathx.fma (addcmul on the card: one fused
// multiply-add), which the build's --fmad=false keeps apart from the
// other products and sums.
//
// The adjoint. Deterministic, with no float atomics: each texel channel
// (entry) sums its rays' terms g_c * scale * (1 - wy) * (1 - wx) (and the
// other three taps' weights, in the plain version's op order) as 64-bit
// fixed-point integers, whose sum is the same in any order. Pass 1 takes
// the largest |term| of each entry (an integer atomicMax on the float's
// bits; inf and NaN order above every finite value); pass 2 rounds each
// term to the nearest multiple of 2^(E - B), with 2^E the entry's power
// of two above its largest term, and adds the integers; pass 3 scales
// the sum back to float. B = 62 - ceil(log2(4 n)): an entry sums at most
// four terms a ray, each at most 2^B units, so the sum fits in 63 bits.
// Each term is then exact to 2^-B of the entry's largest (B = 39 at the
// 1920x1088 front, 48 at the CPU tests' 4,096 rays), and the sum is
// exact before its one rounding to float; the error against the exact
// sum is at most (terms) x 2^(E - B - 1). An entry with an inf term
// gives +inf or -inf (NaN if both signs), with a NaN term NaN, as the
// plain version's float sums do.
//
// Rays whose twelve terms are all zero (a hit's cotangent is 0: the
// lookup's value is used only where the ray missed) add nothing. A
// view's misses are coherent (neighbouring pixels, a few hundred
// texels), so most of a warp's consecutive rays share their base texel
// (y0, x0) and with it the texels of all four taps: each run of such
// lanes first reduces its terms (a segmented shuffle scan: max, integer
// sum) and its last lane makes the run's atomics; scattered rays
// (diffuse bounces) make runs of one. Integer sums and maxima do not
// depend on that grouping, so the bits do not either.
//
// Limits: n < 2^31 rays, h * w < 2^31 texels; the scratch holds a 64-bit
// sum and a 32-bit max per entry (12 B x 3 h w).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;   // |term| bits above: NaN

struct Taps {
  int x0, x1, y0, y1;
  float wx, wy;
};

__device__ __forceinline__ int clamp_index(float f, int hi) {
  // torch.clamp(torch.floor(f).to(torch.int64), 0, hi)
  const long long v = (long long)floorf(f);
  return (int)(v < 0 ? 0 : v > hi ? hi : v);
}

__device__ __forceinline__ Taps taps(float fx, float fy, int h, int w) {
  Taps t;
  t.x0 = clamp_index(fx, w - 1);
  t.y0 = clamp_index(fy, h - 1);
  t.wx = fx - (float)t.x0;
  t.wy = fy - (float)t.y0;
  t.x1 = min(t.x0 + 1, w - 1);
  t.y1 = min(t.y0 + 1, h - 1);
  return t;
}

// the plain version's mathx.fma(x, y, z) = x * y + z
__device__ __forceinline__ float fma_rn(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}

struct Corners {
  float c00, c01, c10, c11;
};

__device__ __forceinline__ Corners corners(const float* __restrict__ env,
                                           const Taps& t, int w, int c) {
  const float* r0 = env + (size_t)t.y0 * w * 3 + c;
  const float* r1 = env + (size_t)t.y1 * w * 3 + c;
  return {__ldg(r0 + (size_t)t.x0 * 3), __ldg(r0 + (size_t)t.x1 * 3),
          __ldg(r1 + (size_t)t.x0 * 3), __ldg(r1 + (size_t)t.x1 * 3)};
}

__global__ void __launch_bounds__(THREADS)
envmap_lookup_kernel(const float* __restrict__ fx,
                     const float* __restrict__ fy,
                     const float* __restrict__ env, float* __restrict__ out,
                     int n, int h, int w, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps(fx[i], fy[i], h, w);
  const float ax = 1.0f - t.wx, ay = 1.0f - t.wy;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Corners k = corners(env, t, w, c);
    const float top = fma_rn(k.c00, ax, k.c01 * t.wx);
    const float bottom = fma_rn(k.c10, ax, k.c11 * t.wx);
    out[(size_t)c * n + i] = fma_rn(top, ay, bottom * t.wy) * scale;
  }
}

__global__ void __launch_bounds__(THREADS)
envmap_dxy_kernel(const float* __restrict__ fx, const float* __restrict__ fy,
                  const float* __restrict__ env, const float* __restrict__ g,
                  float* __restrict__ dfx, float* __restrict__ dfy, int n,
                  int h, int w, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps(fx[i], fy[i], h, w);
  const float ax = 1.0f - t.wx, ay = 1.0f - t.wy;
  float sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int c = 2; c >= 0; --c) {
    const Corners k = corners(env, t, w, c);
    const float top = fma_rn(k.c00, ax, k.c01 * t.wx);
    const float bottom = fma_rn(k.c10, ax, k.c11 * t.wx);
    const float gs = g[(size_t)c * n + i] * scale;
    const float gt = gs * ay, gb = gs * t.wy;
    // the products added one by one, channel 2 first (the plain
    // version's order, autograd's through the four-gather expression)
    sx = c == 2 ? gb * k.c11 : sx + gb * k.c11;
    sx = sx - gb * k.c10;
    sx = sx + gt * k.c01;
    sx = sx - gt * k.c00;
    sy = c == 2 ? gs * bottom : sy + gs * bottom;
    sy = sy - gs * top;
  }
  dfx[i] = sx;
  dfy[i] = sy;
}

// One ray's twelve adjoint terms, tap-major (00, 01, 10, 11) then channel,
// with the texel of each tap. The products in the plain version's order:
// gs = g * scale, gt = gs * (1 - wy), gb = gs * wy, then gt * (1 - wx),
// gt * wx, gb * (1 - wx), gb * wx.
struct Terms {
  int texel[4];
  float v[12];
  bool any;   // a nonzero term (NaN counts)
};

__device__ __forceinline__ Terms ray_terms(const float* __restrict__ fx,
                                           const float* __restrict__ fy,
                                           const float* __restrict__ g,
                                           int i, int n, int h, int w,
                                           float scale) {
  Terms r;
  r.any = false;
  if (i >= n) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.v[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.texel[k] = 0;
    return r;
  }
  const Taps t = taps(fx[i], fy[i], h, w);
  const float ax = 1.0f - t.wx;
  r.texel[0] = t.y0 * w + t.x0;
  r.texel[1] = t.y0 * w + t.x1;
  r.texel[2] = t.y1 * w + t.x0;
  r.texel[3] = t.y1 * w + t.x1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gs = g[(size_t)c * n + i] * scale;
    const float gt = gs * (1.0f - t.wy), gb = gs * t.wy;
    r.v[0 * 3 + c] = gt * ax;
    r.v[1 * 3 + c] = gt * t.wx;
    r.v[2 * 3 + c] = gb * ax;
    r.v[3 * 3 + c] = gb * t.wx;
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) r.any |= r.v[j] != 0.0f;
  return r;
}

// A warp's runs of consecutive lanes that share a base texel (y0, x0),
// and so the texels of all four taps: `head` where a run starts, the
// run's first lane, and `tail` where it ends. Lanes without a nonzero
// term get the key -1 (their runs add nothing).
struct Run {
  int key, start;
  bool tail;
};

__device__ __forceinline__ Run warp_run(const Terms& r) {
  const int lane = threadIdx.x & 31;
  Run u;
  u.key = r.any ? r.texel[0] : -1;
  const int prev = __shfl_up_sync(FULL, u.key, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != u.key);
  u.start = 31 - __clz(heads & (FULL >> (31 - lane)));
  u.tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  return u;
}

// The inclusive scan of `v` over the lane's run (Hillis-Steele: after the
// step of offset o a lane holds its run's values from lane - 2o + 1 on);
// the run's tail ends with the whole run's. Exact for max, or and integer
// sums, whose result does not depend on the grouping.
template <class T, class Op>
__device__ __forceinline__ T run_scan(T v, int start, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL, v, o);
    if (lane - o >= start) v = op(v, u);
  }
  return v;
}

__device__ __forceinline__ unsigned mag_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;   // |v|, NaN above inf
}

__global__ void __launch_bounds__(THREADS)
envmap_adjoint_max_kernel(const float* __restrict__ fx,
                          const float* __restrict__ fy,
                          const float* __restrict__ g,
                          unsigned* __restrict__ mx, int n, int h, int w,
                          float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Terms r = ray_terms(fx, fy, g, i, n, h, w, scale);
  const Run u = warp_run(r);
  if (!__any_sync(FULL, u.key >= 0)) return;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const unsigned m = run_scan(mag_bits(r.v[j]), u.start,
                                [](unsigned a, unsigned b) {
                                  return a > b ? a : b;
                                });
    if (u.tail && u.key >= 0 && m)
      atomicMax(mx + (size_t)r.texel[j / 3] * 3 + j % 3, m);
  }
}

// The entry's fixed-point exponent: its largest finite |term| < 2^e.
__device__ __forceinline__ int entry_exponent(unsigned m) {
  int e;
  frexpf(__uint_as_float(m), &e);
  return e;
}

// A term in units of 2^(e - B) of its entry, rounded to the nearest
// integer (ties to even); nothing for an entry whose largest term is
// inf or NaN (those are flagged apart).
__device__ __forceinline__ long long fixed(float v, unsigned m, int bits) {
  if (m >= INF_BITS || v == 0.0f) return 0;
  return __float2ll_rn(ldexpf(v, bits - entry_exponent(m)));
}

__global__ void __launch_bounds__(THREADS)
envmap_adjoint_sum_kernel(const float* __restrict__ fx,
                          const float* __restrict__ fy,
                          const float* __restrict__ g,
                          const unsigned* __restrict__ mx,
                          unsigned long long* __restrict__ sum, int n, int h,
                          int w, float scale, int bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Terms r = ray_terms(fx, fy, g, i, n, h, w, scale);
  const Run u = warp_run(r);
  if (!__any_sync(FULL, u.key >= 0)) return;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const size_t e = (size_t)r.texel[j / 3] * 3 + j % 3;
    const unsigned m = u.key >= 0 ? mx[e] : 0u;   // the same in a run
    const long long q = run_scan(
        fixed(r.v[j], m, bits), u.start,
        [](long long a, long long b) { return a + b; });
    if (u.tail && u.key >= 0 && q && m < INF_BITS)
      atomicAdd(sum + e, (unsigned long long)q);
    if (__any_sync(FULL, m == INF_BITS)) {
      // the signs of an inf entry's inf terms: 1 for +inf, 2 for -inf
      const unsigned f = m == INF_BITS && isinf(r.v[j])
                             ? (r.v[j] > 0.0f ? 1u : 2u) : 0u;
      const unsigned fl = run_scan(f, u.start, [](unsigned a, unsigned b) {
        return a | b;
      });
      if (u.tail && fl) atomicOr(sum + e, (unsigned long long)fl);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
envmap_adjoint_final_kernel(const unsigned* __restrict__ mx,
                            const unsigned long long* __restrict__ sum,
                            float* __restrict__ out, long long entries,
                            int bits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  const unsigned m = mx[e];
  const unsigned long long s = sum[e];
  float v;
  if (m > INF_BITS) {
    v = __uint_as_float(0x7fc00000u);
  } else if (m == INF_BITS) {
    v = s == 1 ? __uint_as_float(INF_BITS)
        : s == 2 ? -__uint_as_float(INF_BITS)
                 : __uint_as_float(0x7fc00000u);
  } else if (m == 0) {
    v = 0.0f;
  } else {
    v = ldexpf(__ll2float_rn((long long)s), entry_exponent(m) - bits);
  }
  out[e] = v;
}

long long blocks(long long items, int per_block) {
  return (items + per_block - 1) / per_block;
}

bool valid(int n, int h, int w) {
  return n >= 1 && h >= 1 && w >= 1 && (long long)h * w < (1LL << 31);
}

// B: 4 n terms of at most 2^B units sum within 2^62
int fixed_bits(int n) {
  int b = 0;
  while ((1LL << b) < 4LL * n) ++b;
  return 62 - b;
}

}  // namespace

extern "C" {

// Each entry point returns the CUDA error of its launches (0 = success).
// Launches on `stream`, allocates nothing, does not synchronise.
// 1 <= n < 2^31, h, w >= 1, h * w < 2^31.

// fx, fy [n] f32, env [h, w, 3] f32, out [3, n] f32.
int fov_envmap_lookup(const void* fx, const void* fy, const void* env,
                      void* out, int n, int h, int w, float scale,
                      void* stream) {
  if (!valid(n, h, w)) return (int)cudaErrorInvalidValue;
  envmap_lookup_kernel<<<(unsigned)blocks(n, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const float*)fx, (const float*)fy, (const float*)env, (float*)out, n,
      h, w, scale);
  return (int)cudaGetLastError();
}

// fx, fy [n] f32, env [h, w, 3] f32, g [3, n] f32, dfx, dfy [n] f32.
int fov_envmap_dxy(const void* fx, const void* fy, const void* env,
                   const void* g, void* dfx, void* dfy, int n, int h, int w,
                   float scale, void* stream) {
  if (!valid(n, h, w)) return (int)cudaErrorInvalidValue;
  envmap_dxy_kernel<<<(unsigned)blocks(n, THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const float*)fx, (const float*)fy, (const float*)env, (const float*)g,
      (float*)dfx, (float*)dfy, n, h, w, scale);
  return (int)cudaGetLastError();
}

// fx, fy [n] f32, g [3, n] f32, scratch [3 h w] u64 sums then [3 h w]
// u32 maxima (12 x 3 h w bytes, 8-byte aligned; zeroed here), out
// [h, w, 3] f32.
int fov_envmap_adjoint(const void* fx, const void* fy, const void* g,
                       void* scratch, void* out, int n, int h, int w,
                       float scale, void* stream) {
  if (!valid(n, h, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long entries = 3LL * h * w;
  unsigned long long* sum = (unsigned long long*)scratch;
  unsigned* mx = (unsigned*)(sum + entries);
  const int bits = fixed_bits(n);
  int err = (int)cudaMemsetAsync(scratch, 0, 12 * (size_t)entries, s);
  if (err) return err;
  const unsigned grid = (unsigned)blocks(n, THREADS);
  envmap_adjoint_max_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)fx, (const float*)fy, (const float*)g, mx, n, h, w,
      scale);
  if ((err = (int)cudaGetLastError())) return err;
  envmap_adjoint_sum_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)fx, (const float*)fy, (const float*)g, mx, sum, n, h, w,
      scale, bits);
  if ((err = (int)cudaGetLastError())) return err;
  envmap_adjoint_final_kernel<<<(unsigned)blocks(entries, THREADS), THREADS,
                                0, s>>>(mx, sum, (float*)out, entries, bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
