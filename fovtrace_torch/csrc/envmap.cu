// The environment map's bilinear lookup and its adjoint for Hopper
// (sm_90a).
//
//   envmap_lookup_kernel        <- the taps and bilerp of envmap_lookup_v,
//                                  fovtrace/render/shade.py:41
//   envmap_dxy_kernel           <- its gradient with respect to the
//                                  continuous texel coordinates (fx, fy)
//   envmap_adjoint_kernel       <- its gradient with respect to the map
//                                  (jax.vjp of the same lines), three
//                                  passes in one cooperative launch
//
// The reference is no Pallas kernel: one row gather from an [H*W, 12]
// quad table (a TPU workaround) whose transpose is XLA's scatter-add. A
// miss looks up the lat-long map at continuous texel coordinates
// (fx, fy), computed from the ray's direction in torch
// (render/shade.py): four edge-clamped taps, bilinear weights, times
// `scale`. A front is up to 2,088,960 rays (1920x1088); earth's map is
// 64 x 128 x 3 (98 KB), a file scene's HDR up to 800 x 1600 x 3.
//
// All three kernels are bound by bytes: the lookup reads fx, fy and
// writes three floats a ray (20 B), d(fx, fy) reads fx, fy and the [3, N]
// cotangent and writes two floats (28 B), the adjoint reads fx, fy and
// the cotangent (20 B) twice (the second time mostly from the 50 MB L2)
// and writes the map once; none does more than a few dozen float
// operations per ray.
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
// The three passes run in one cooperative launch of
// envmap_adjoint_kernel<SHARED>, a grid-wide barrier between them (each
// ~1.1 us on the H100, where three more launches and a memset cost
// more): one CTA of ADJ_THREADS per SM, persistent; each CTA takes a
// contiguous range of the rays, each of its warps a contiguous part of
// that, whose lanes take every 32nd ray, the next one's loads in flight
// while a lane adds one. A lane keeps a run: while its
// rays share a base texel (y0, x0), and with it the entries of all four
// taps, it reduces their twelve terms in registers (max; integer sum)
// and reads the run's twelve entry scales once; when the base texel
// changes it flushes the run. Rays whose cotangent is 0 with finite
// coordinates (a hit's: the lookup's value is used only where the ray
// missed) add nothing and end no run. A view's misses are coherent
// (neighbouring pixels, a few hundred texels), so a warp's lanes mostly
// flush one run together: the warp then reduces it first (REDUX; a
// 64-bit sum in three 21-bit pieces) and one lane adds it, where at
// least AGGREGATE_MIN lanes flush the same run; scattered rays (diffuse
// bounces) flush lane by lane. A term's scale is a multiply by
// 2^(B - E), exact as ldexpf is, but for the rare entries whose largest
// term is subnormal, below 2^(B - 128) or inf / NaN, which take ldexpf
// and the inf flags. The constants were measured on the H100: more rays
// a lane in flight, 768 or 1,024 threads, and warp sums by shuffles or
// over fewer lanes all ran slower.
//
// SHARED, where the map fits (3 h w, rounded up to a multiple of 4, x
// SHARED_ENTRY_BYTES within the card's opt-in shared memory a block,
// `adjoint_route`; 64x128 takes 221,184 of the H100's 232,448 bytes):
// the runs flush into a private copy a CTA in shared memory, the 32-bit
// maxima in the first pass, then the 64-bit sums as two 32-bit words (a
// low word's carry goes to the high one: a 64-bit shared-memory
// atomicAdd is a compare-and-swap loop on sm_90, the 32-bit ones are
// single instructions) beside a byte a entry that codes its scale
// (`scale_code`). Each CTA then adds only the entries it touched to the
// global scratch, one integer atomic each. No block holds a larger map (a
// file scene's HDR, up to 800x1600: 3.84M entries): GLOBAL runs flush
// into the global scratch directly. Integer sums and maxima do not depend
// on the grouping, so both routes give the same bits, and the same as
// any other grouping of the same terms.
//
// Limits: n < 2^31 rays, h * w < 2^31 texels; the scratch holds a 64-bit
// sum and a 32-bit max per entry (12 B x 3 h w), which the kernel zeroes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// ---- the map's adjoint ------------------------------------------------------
// ADJ_THREADS, SHARED_ENTRY_BYTES and AGGREGATE_MIN have copies in
// kernels/envmap.py, which tests/test_torch_envmap.py holds to these
// lines
constexpr int ADJ_THREADS = 512;       // threads of an adjoint CTA
constexpr int SHARED_ENTRY_BYTES = 9;  // a sum's two words, a scale code
constexpr int AGGREGATE_MIN = 16;      // lanes of a run the warp reduces

struct AdjointArgs {
  const float* fx;
  const float* fy;
  const float* g;
  unsigned* mx;              // [3 h w] the bits of the largest |term|
  unsigned long long* sum;   // [3 h w] fixed-point sums (inf: signs)
  float* out;                // [h, w, 3]
  int n, h, w, bits;
  float scale;
};

__device__ __forceinline__ unsigned mag_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;   // |v|, NaN above inf
}

// The entry's fixed-point exponent: its largest finite |term| < 2^e.
__device__ __forceinline__ int entry_exponent(unsigned m) {
  int e;
  frexpf(__uint_as_float(m), &e);
  return e;
}

// An entry's scale code from the bits m of its largest |term|: the biased
// float exponent of the multiplier 2^(bits - e), e = entry_exponent(m),
// that takes its terms to fixed point (bits + 253 - (m >> 23) for a normal
// m), or 0 where they take the slow way (ldexpf; inf flags): an inf or
// NaN m, a subnormal m or none, or a multiplier above 2^127. Where it is
// not 0, v * 2^(bits - e) is exact, as ldexpf(v, bits - e) is, or
// (subnormal) rounds to the integer 0 as that does.
__device__ __forceinline__ unsigned scale_code(unsigned m, int bits) {
  const int b = (int)(m >> 23);   // the biased exponent of a normal m
  return m < INF_BITS && b >= 1 && b >= bits - 1 ? (unsigned)(bits + 253 - b)
                                                 : 0u;
}

// clamp(floor(f), 0, hi) as `taps` computes it through a 64-bit integer,
// in float for maps under 2^23 texels a side: hi = w - 1 is exact there,
// fmaxf takes a NaN to 0 as the integer cast does, + 0.0f makes -0 a +0;
// the index from the float's bits (f + 2^23 is exact below 2^23).
__device__ __forceinline__ float clamp_floor(float f, float hi) {
  return fminf(fmaxf(floorf(f), 0.0f), hi) + 0.0f;
}

__device__ __forceinline__ int float_index(float x) {
  return __float_as_int(x + 8388608.0f) - 0x4b000000;
}

// The inclusive run state of a lane: the base texel (y0 < 0: none) and,
// per term, the max of |term| (pass 0) or the sum of its fixed-point
// integers with the run's twelve multipliers (pass 1).
template <int PASS>
struct Run {
  int y0 = -1, x0 = 0;
  unsigned m[12];    // pass 0 only (the other's arrays are left unused)
  long long q[12];   // pass 1 only
  float f[12];       // pass 1 only
  unsigned slow = 0;   // terms whose entry takes the slow way
};

// Where the adjoint's runs go: a CTA's shared-memory copy (SHARED) or the
// global scratch.
template <bool SHARED>
struct Sink {
  AdjointArgs a;
  unsigned* lo;             // shared: maxima, then the sums' low words
  unsigned* hi;             // shared: the sums' high words
  unsigned char* code;      // shared: each entry's scale code

  __device__ __forceinline__ size_t entry(const int y0, const int x0,
                                          int j) const {
    const int t = j / 3;
    const int y = t & 2 ? min(y0 + 1, a.h - 1) : y0;
    const int x = t & 1 ? min(x0 + 1, a.w - 1) : x0;
    return ((size_t)y * a.w + x) * 3 + j % 3;
  }
  // A run's twelve maxima (0: none) added to the sink.
  __device__ __forceinline__ void max_run(int y0, int x0,
                                          const unsigned (&m)[12]) const {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      if (!m[j]) continue;
      if (SHARED) atomicMax(lo + entry(y0, x0, j), m[j]);
      else atomicMax(a.mx + entry(y0, x0, j), m[j]);
    }
  }
  // A run's twelve sums (0: none) added to the sink. Shared: each 64-bit
  // sum as two words, the low word's carry to the high one; the twelve
  // low words' atomics are issued before any carry is needed, so that
  // their round trips overlap.
  __device__ __forceinline__ void add_run(int y0, int x0,
                                          const long long (&q)[12]) const {
    if (SHARED) {
      unsigned old[12];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        old[j] = q[j] ? atomicAdd(lo + entry(y0, x0, j), (unsigned)q[j]) : 0u;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const unsigned ql = (unsigned)q[j];
        const unsigned up = (unsigned)((unsigned long long)q[j] >> 32) +
                            (old[j] + ql < old[j] ? 1u : 0u);
        if (q[j] && up) atomicAdd(hi + entry(y0, x0, j), up);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j)
        if (q[j]) atomicAdd(a.sum + entry(y0, x0, j), (unsigned long long)q[j]);
    }
  }
  __device__ __forceinline__ void flag(size_t e, unsigned f) const {
    if (SHARED) atomicOr(lo + e, f);
    else atomicOr(a.sum + e, (unsigned long long)f);
  }
  __device__ __forceinline__ unsigned code_of(size_t e) const {
    return SHARED ? code[e] : scale_code(__ldcg(a.mx + e), a.bits);
  }
};

// A term of an entry that takes the slow way (scale code 0): an inf / NaN
// entry flags its inf terms' signs (1 for +inf, 2 for -inf) and adds
// nothing; the others round ldexpf(v, bits - e).
template <bool SHARED>
__device__ __forceinline__ long long slow_term(const Sink<SHARED>& k,
                                               size_t e, float v) {
  if (v == 0.0f) return 0;
  const unsigned m = __ldcg(k.a.mx + e);
  if (m >= INF_BITS) {
    if (isinf(v)) k.flag(e, v > 0.0f ? 1u : 2u);
    return 0;
  }
  return __float2ll_rn(ldexpf(v, k.a.bits - entry_exponent(m)));
}

// The lanes with `want` add their runs to the sink. Warp-collective. The
// lowest such lane's run is reduced across the warp first (REDUX; a
// 64-bit sum in three 21-bit pieces, whose sums fit in 32 bits), while
// at least AGGREGATE_MIN lanes share it; the rest add lane by lane.
template <bool SHARED, int PASS>
__device__ __forceinline__ void flush(const Sink<SHARED>& k, bool want,
                                      const Run<PASS>& r) {
  unsigned pend = __ballot_sync(FULL, want);
  if (!pend) return;
  const int lane = threadIdx.x & 31;
  const int key = r.y0 * k.a.w + r.x0;
  while (true) {
    const int lead = __ffs(pend) - 1;
    const int lk = __shfl_sync(FULL, key, lead);
    const unsigned grp = __ballot_sync(FULL, want && key == lk);
    if (__popc(grp) < AGGREGATE_MIN) break;
    const bool in = (grp >> lane) & 1u;
    if (PASS == 0) {
      unsigned m[12];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        m[j] = __reduce_max_sync(FULL, in ? r.m[j] : 0u);
      if (lane == lead) k.max_run(r.y0, r.x0, m);
    } else {
      long long q[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const unsigned long long u = in ? (unsigned long long)r.q[j] : 0ull;
        const int p0 = __reduce_add_sync(FULL, (int)(u & 0x1fffffu));
        const int p1 = __reduce_add_sync(FULL, (int)((u >> 21) & 0x1fffffu));
        const int p2 = __reduce_add_sync(FULL, (int)((long long)u >> 42));
        q[j] = (long long)(((unsigned long long)(long long)p2 << 42) +
                           ((unsigned long long)p1 << 21) +
                           (unsigned long long)p0);
      }
      if (lane == lead) k.add_run(r.y0, r.x0, q);
    }
    pend &= ~grp;
    if (!pend) return;
  }
  if ((pend >> lane) & 1u) {
    if (PASS == 0) k.max_run(r.y0, r.x0, r.m);
    else k.add_run(r.y0, r.x0, r.q);
  }
}

// One ray of a lane: its twelve terms (in the plain version's op order)
// into the lane's run, which it first flushes if the ray starts another.
// Warp-collective (the flush).
template <bool SHARED, int PASS>
__device__ __forceinline__ void add_ray(const Sink<SHARED>& k, Run<PASS>& r,
                                        float fx, float fy, float g0,
                                        float g1, float g2, bool narrow,
                                        float w1f, float h1f) {
  const AdjointArgs& a = k.a;
  const float gs[3] = {g0 * a.scale, g1 * a.scale, g2 * a.scale};
  // no term: a zero cotangent at finite coordinates (zero weights times
  // finite ones)
  const bool live = !(gs[0] == 0.0f && gs[1] == 0.0f && gs[2] == 0.0f &&
                      isfinite(fx) && isfinite(fy));
  int y0 = 0, x0 = 0;
  float v[12];
  if (live) {
    float wx, wy;
    if (narrow) {
      const float xf = clamp_floor(fx, w1f);
      const float yf = clamp_floor(fy, h1f);
      x0 = float_index(xf);
      y0 = float_index(yf);
      wx = fx - xf;
      wy = fy - yf;
    } else {
      const Taps t = taps(fx, fy, a.h, a.w);
      x0 = t.x0;
      y0 = t.y0;
      wx = t.wx;
      wy = t.wy;
    }
    const float ax = 1.0f - wx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gt = gs[c] * (1.0f - wy), gb = gs[c] * wy;
      v[0 * 3 + c] = gt * ax;
      v[1 * 3 + c] = gt * wx;
      v[2 * 3 + c] = gb * ax;
      v[3 * 3 + c] = gb * wx;
    }
  }
  const bool start = live && (y0 != r.y0 || x0 != r.x0);
  flush<SHARED, PASS>(k, start && r.y0 >= 0, r);
  if (start) {
    r.y0 = y0;
    r.x0 = x0;
    r.slow = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      if (PASS == 0) {
        r.m[j] = 0u;
      } else {
        r.q[j] = 0;
        r.f[j] = __uint_as_float(k.code_of(k.entry(y0, x0, j)) << 23);
        r.slow |= r.f[j] == 0.0f ? 1u << j : 0u;
      }
    }
  }
  if (!live) return;
  if (PASS == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.m[j] = max(r.m[j], mag_bits(v[j]));
  } else if (!r.slow) {   // every run but the rare slow one: no branches
#pragma unroll
    for (int j = 0; j < 12; ++j) r.q[j] += __float2ll_rn(v[j] * r.f[j]);
  } else {
#pragma unroll 1
    for (int j = 0; j < 12; ++j) {
      float vj = v[0], fj = r.f[0];
#pragma unroll
      for (int i = 1; i < 12; ++i)
        if (j == i) vj = v[i], fj = r.f[i];
      const long long q = (r.slow >> j) & 1u
                              ? slow_term(k, k.entry(y0, x0, j), vj)
                              : __float2ll_rn(vj * fj);
#pragma unroll
      for (int i = 0; i < 12; ++i)
        if (j == i) r.q[i] += q;
    }
  }
}

// A ray's inputs.
struct Ray {
  float fx, fy, g0, g1, g2;
};

// A pass over the CTA's rays: each warp a contiguous part of the CTA's
// range, its lanes every 32nd ray; every lane runs the same iterations
// (past the end: no rays). One ray an iteration, the next one's loads in
// flight while it is added (deeper queues in registers spilled, and L2
// prefetches further ahead gained nothing, on the H100).
template <bool SHARED, int PASS>
__device__ __forceinline__ void adjoint_pass(const Sink<SHARED>& k) {
  const AdjointArgs& a = k.a;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long c0 = (long long)a.n * blockIdx.x / gridDim.x;
  const long long c1 = (long long)a.n * (blockIdx.x + 1) / gridDim.x;
  const long long w0 = c0 + (c1 - c0) * warp / warps;
  const long long w1 = c0 + (c1 - c0) * (warp + 1) / warps;
  const int steps = (int)((w1 - w0 + 31) / 32);
  // maps under 2^23 texels a side take the clamp in float
  const bool narrow = a.w <= (1 << 23) && a.h <= (1 << 23);
  const float w1f = (float)(a.w - 1), h1f = (float)(a.h - 1);
  auto load = [&](int t) {
    const long long i = w0 + 32LL * t + lane;
    const bool in = i < w1;
    return Ray{in ? __ldg(a.fx + i) : 0.0f, in ? __ldg(a.fy + i) : 0.0f,
               in ? __ldg(a.g + i) : 0.0f,
               in ? __ldg(a.g + (size_t)a.n + i) : 0.0f,
               in ? __ldg(a.g + 2 * (size_t)a.n + i) : 0.0f};
  };
  Ray next = load(0);
  Run<PASS> r;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const Ray x = next;
    next = load(t + 1);
    add_ray<SHARED, PASS>(k, r, x.fx, x.fy, x.g0, x.g1, x.g2, narrow, w1f,
                          h1f);
  }
  flush<SHARED, PASS>(k, r.y0 >= 0, r);
}

// An entry's value from its largest |term|'s bits and its sum.
__device__ __forceinline__ float final_value(unsigned m,
                                             unsigned long long s,
                                             int bits) {
  if (m > INF_BITS) return __uint_as_float(0x7fc00000u);
  if (m == INF_BITS)
    return s == 1 ? __uint_as_float(INF_BITS)
           : s == 2 ? -__uint_as_float(INF_BITS)
                    : __uint_as_float(0x7fc00000u);
  if (m == 0) return 0.0f;
  return ldexpf(__ll2float_rn((long long)s), entry_exponent(m) - bits);
}

// The entries of an h x w map, rounded up to a multiple of 4: the SHARED
// copy's arrays are that long, so that each is read and cleared 16 bytes
// at a time.
__host__ __device__ __forceinline__ long long padded_entries(long long h,
                                                             long long w) {
  return (3 * h * w + 3) / 4 * 4;
}

// The adjoint's three passes in one cooperative launch (see the top of
// this file). SHARED needs padded_entries x SHARED_ENTRY_BYTES of dynamic
// shared memory: the words (maxima, then the sums' low words), the sums'
// high words, the scale codes.
template <bool SHARED>
__global__ void __launch_bounds__(ADJ_THREADS)
envmap_adjoint_kernel(AdjointArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const long long entries = 3LL * a.h * a.w;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = first; e < entries; e += stride) {
    a.mx[e] = 0u;
    a.sum[e] = 0ull;
  }
  // SHARED: the copy's quads of entries (a padding entry stays 0)
  const int quads = SHARED ? (int)(padded_entries(a.h, a.w) / 4) : 0;
  Sink<SHARED> k{a, (unsigned*)smem, (unsigned*)smem + 4 * quads,
                 smem + 32 * (size_t)quads};
  uint4* lo4 = (uint4*)k.lo;
  uint4* hi4 = (uint4*)k.hi;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (SHARED) {
    for (int q = threadIdx.x; q < quads; q += blockDim.x) lo4[q] = zero;
    __syncthreads();
  } else {
    grid.sync();   // the global scratch zeroed
  }
  adjoint_pass<SHARED, 0>(k);
  if (SHARED) {
    grid.sync();   // the global scratch zeroed, every CTA's maxima done
    // entry by entry, a warp's atomics on 32 neighbouring words
    for (int e0 = threadIdx.x; e0 < 4 * quads; e0 += 4 * blockDim.x) {
      unsigned m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        m[u] = e < 4 * quads ? k.lo[e] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (m[u]) atomicMax(a.mx + e0 + u * blockDim.x, m[u]);
    }
  }
  grid.sync();     // the maxima complete
  if (SHARED) {
    // the scale codes of the entries this CTA's terms reach (a term of
    // another entry is 0 here and needs none; the global maxima's loads
    // issued sixteen at a time), then the sums cleared
    for (int e0 = threadIdx.x; e0 < 4 * quads; e0 += 16 * blockDim.x) {
      unsigned m[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * blockDim.x;
        m[u] = e < 4 * quads && k.lo[e] ? __ldcg(a.mx + e) : 0u;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < 4 * quads)
          k.code[e] = m[u] ? (unsigned char)scale_code(m[u], a.bits) : 0;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      lo4[q] = zero;
      hi4[q] = zero;
    }
    __syncthreads();
  }
  adjoint_pass<SHARED, 1>(k);
  if (SHARED) {
    __syncthreads();
    for (int e0 = threadIdx.x; e0 < 4 * quads; e0 += 4 * blockDim.x) {
      unsigned lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        lo[u] = e < 4 * quads ? k.lo[e] : 0u;
        hi[u] = e < 4 * quads ? k.hi[e] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        if (!(lo[u] | hi[u])) continue;
        // an inf / NaN entry's word holds its inf signs
        if (!k.code[e] && __ldcg(a.mx + e) >= INF_BITS)
          atomicOr(a.sum + e, (unsigned long long)lo[u]);
        else
          atomicAdd(a.sum + e, (unsigned long long)hi[u] << 32 | lo[u]);
      }
    }
  }
  grid.sync();     // the sums complete
  // four entries a thread at a time, their loads issued together
  for (long long e0 = first; e0 < entries; e0 += 4 * stride) {
    unsigned m[4];
    unsigned long long s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long e = e0 + u * stride;
      m[u] = e < entries ? __ldcg(a.mx + e) : 0u;
      s[u] = e < entries ? __ldcg(a.sum + e) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long e = e0 + u * stride;
      if (e < entries) a.out[e] = final_value(m[u], s[u], a.bits);
    }
  }
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

// The card's SM count and opt-in shared memory a block, read once a
// device, and whether the SHARED kernel's limit is raised to it.
struct Card {
  int sms = 0, optin = 0;
  bool raised = false;
};

Card& card() {
  static Card cards[64];
  int dev = 0;
  cudaGetDevice(&dev);
  Card& c = cards[dev & 63];
  if (!c.sms) {
    cudaDeviceGetAttribute(&c.optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return c;
}

// 0 (SHARED) where a CTA's shared memory holds the map's sums, their high
// words and scale codes, else 1 (GLOBAL); kernels/envmap.py
// `adjoint_route` is its copy
int adjoint_route(long long h, long long w, long long optin) {
  return padded_entries(h, w) * SHARED_ENTRY_BYTES <= optin ? 0 : 1;
}

// One cooperative launch of the adjoint on `route`, its grid the CTAs
// that fit on the card at once; a CTA that does not fit (SHARED on too
// large a map) is launched all the same, and the runtime refuses it.
int launch_adjoint(const AdjointArgs& a, int route, cudaStream_t s) {
  Card& c = card();
  const void* fn = route == 0 ? (const void*)envmap_adjoint_kernel<true>
                              : (const void*)envmap_adjoint_kernel<false>;
  const size_t bytes =
      route == 0 ? (size_t)padded_entries(a.h, a.w) * SHARED_ENTRY_BYTES : 0;
  int err = 0;
  if (route == 0 && !c.raised) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.optin);
    if (err) {
      cudaGetLastError();
      return err;
    }
    c.raised = true;
  }
  int per = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, fn, ADJ_THREADS, bytes);
  if (err) {
    cudaGetLastError();
    return err;
  }
  AdjointArgs arg = a;
  void* args[] = {&arg};
  err = (int)cudaLaunchCooperativeKernel(fn, c.sms * (per > 0 ? per : 1),
                                         ADJ_THREADS, args, bytes, s);
  if (err) cudaGetLastError();   // a refused launch leaves no error behind
  return err;
}

int adjoint(const void* fx, const void* fy, const void* g, void* scratch,
            void* out, int n, int h, int w, float scale, int route,
            void* stream) {
  if (!valid(n, h, w) || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  const long long entries = 3LL * h * w;
  unsigned long long* sum = (unsigned long long*)scratch;
  unsigned* mx = (unsigned*)(sum + entries);
  const AdjointArgs a{(const float*)fx, (const float*)fy, (const float*)g,
                      mx, sum, (float*)out, n, h, w, fixed_bits(n), scale};
  return launch_adjoint(a, route, (cudaStream_t)stream);
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
// [h, w, 3] f32. One cooperative launch, on the route adjoint_route
// picks for this card.
int fov_envmap_adjoint(const void* fx, const void* fy, const void* g,
                       void* scratch, void* out, int n, int h, int w,
                       float scale, void* stream) {
  return adjoint(fx, fy, g, scratch, out, n, h, w, scale,
                 adjoint_route(h, w, card().optin), stream);
}

// The same on a route the caller names: 0 SHARED, 1 GLOBAL (tests: both
// give the same bits; SHARED on a map that no block holds is refused).
int fov_envmap_adjoint_forced(const void* fx, const void* fy, const void* g,
                              void* scratch, void* out, int n, int h, int w,
                              float scale, int route, void* stream) {
  return adjoint(fx, fy, g, scratch, out, n, h, w, scale, route, stream);
}

// The route fov_envmap_adjoint takes for an h x w map on this card: 0
// SHARED, 1 GLOBAL.
int fov_envmap_adjoint_route(int h, int w) {
  return adjoint_route(h, w, card().optin);
}

}  // extern "C"
