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
// per live cluster into its parts, so it runs on closest_kernel's
// skeleton (cluster_isect.cu, copied rather than shared: the probes must
// stay what they are when the render kernels change; only tma.cuh is
// shared). Each ray block walks its first counts[i] entries of the flat
// schedule sched[i * nc + l] (cluster ids) with no front-to-back break,
// as the script does, and writes per ray the value its body writes:
//   LOOP     the sum of float(jc) over the entries (exact: ids < 2^16,
//            sums < 2^24)
//   SLAB     1e30, halved once per entry for which any ray of the block
//            passes the slab test against cluster jc's AABB, with upper =
//            the running value (block-uniform)
//   MM_LANE  the minimum over entries and over the cluster's 4c columns
//            of the dot products rays[r, :] . coef[:, jc * 4c + col],
//            coefficients from the cluster-strided [16, NC * 4c] layout
//   MM_LEAD  the same from the cluster-contiguous [NC, 16, 4c] layout
//   MM_BF16  MM_LEAD with rays and coefficients rounded to bf16, products
//            accumulated in float32
//   FULL     the slab cull with upper = each ray's running t, then the
//            float32 dot products and the body's epilogue: t = t_num / det
//            (a division), t > 1e-3, no t_max test; the minimum t
//
// The skeleton. Persistent CTAs, as many as fit at once: one CTA per ray
// block would pay a launch, the ray loads and an exposed first copy for
// the ~1.8 live clusters of an earth block. Each CTA takes ray blocks
// from a ticket counter in the order the host gives (most live entries
// first, so no long walk starts last) and computes each whole, so no
// result depends on the grid or the order. A ninth, producer warp walks
// the (block, entry) pairs: per block it takes a ticket, loads the
// block's count and the first 32 entries of its row in one warp-wide
// load, and feeds a ring of up to 4 shared-memory stages, each with a
// full and an empty mbarrier (tma.cuh). A block's first slot is its ray
// tile ([256, 16] f32, one 16 KB bulk copy), then one slot per entry with
// the variant's tile: LOOP none (the slot carries the id), SLAB the 32-byte
// AABB, MM_LEAD rows 0-9 of [NC, 16, 4c] (one 20 KB copy), MM_LANE the
// same rows out of [16, NC * 4c] (ten 2 KB copies: that is what separates
// the two layouts now), FULL rows 0-9 and the AABB, MM_BF16 all 16 bf16
// rows (one 16 KB copy). The eight computing warps only wait, compute and
// release: no computing thread stages a tile.
//
// The f32 bodies. The coefficient tile lands as [10][4c] rows and is read
// in place: a 16-byte load of row k gives four consecutive columns, and
// each thread holds R = 4 rays, so one load feeds 16 FMAs and the 40
// values of a (ray, triangle) pair come in 2.5 loads, as in closest_kernel,
// without a transpose that some thread would have to run per stage. The
// price is registers: MM_* keep 4 columns x 4 rays of sums (a running
// minimum needs no grouping by triangle), FULL 4 triangles x 4 columns x
// 4 rays = 64, so FULL runs one CTA per SM (167 registers) and the MM
// bodies two (95-96). The GW = 4 lanes that share a thread's rays take
// every GW-th chunk of four columns (MM_*) or four triangles (FULL) and
// merge their minima by shuffles. FULL divides only for a pair inside the edges,
// in one branch per chunk that few take: the value is the body's.
// Dot products are fmaf over k = 0..9 (--fmad=false): rows 10-15 of the
// pack are zero, and the ray features there (t_min, t_max <= 1e30, 1/d
// clamped to +-1e12, 0) are finite, so the script's six extra terms are
// exact zeros and the sum differs from its 16-term one only in order.
//
// The slab vote (SLAB, FULL) stays block-wide, as in the script: each
// thread tests one ray (its lane's among the four it holds, with upper =
// that ray's merged running value) and bar.red.or over the 256 computing
// threads (named barrier 1; the producer warp runs apart) gives the vote.
//
// MM_BF16 on the tensor cores: mma.sync.m16n8k16, bf16 in, f32 out. A is
// the block's rays, [256 x 16], all 16 feature rows rounded as the plain
// version rounds them (round to nearest even). B is the cluster's [16 x
// 4c] bf16 tile as it lands. The output is a minimum over all 4c columns,
// so which column an MMA column stands for is free: n-tile j of column
// group m takes, in lane group g, column m * 64 + 8 g + j. Then a lane's B
// values for 8 n-tiles are 16 contiguous bytes of one row, the 8 lanes of
// a row read 128 contiguous bytes and the four rows of a load four
// wavefronts, with no conflict; byte permutes pair the rows into
// fragments. Each warp holds four 16-row A tiles in registers (64 rays)
// and takes every other column group, so one B fragment feeds four MMAs
// (its loads and permutes per MMA halve against two tiles); the two warps
// of a ray meet through shared memory at the block's end. One K = 16 step per (m-tile, n-tile) with a
// zero accumulator; the minimum runs on the accumulator fragments, then by
// quad shuffles.
//
// What bounds them on the H100: the f32 dot-product bodies, FMA issue
// (40 FMAs, 2.5 shared loads and 7 other instructions per pair in MM_*,
// each cluster's 20 KB read once per (block, entry) from L2); MM_BF16 the
// minimum over the accumulators: four FMNMX for each MMA, which the tensor
// cores cannot take over; LOOP the producer's walk, a ticket, the block,
// its count and a row load per block (dependent L2 round trips); SLAB the
// bytes of the ray tiles. The variants separate those costs: their time
// per (block, entry) step against closest_kernel's per visited cluster.
//
// smem_dma_kernel. The TPU probe checks the plumbing of a streaming
// kernel: per ray block, copy its schedule row from HBM into on-chip
// scalar memory with an asynchronous DMA (make_async_copy ... start /
// wait on a DMA semaphore), walk the row in a data-dependent loop, and
// store one output row at a dynamic index:
//   out[b, r] = sum over l < counts[b] of table[e % 65536, r] *
//               float(e / 65536) + rays[b, 0, r],   e = sched[b, l]
// a multiply and an add per entry, in order (--fmad=false, as the numpy
// check rounds). Here:
// - Persistent CTAs of 16 independent warps. Each warp walks (ray block,
//   lane slice) items: a slice is L = 64 of the 256 lanes, two a thread
//   (8-byte loads); a CTA keeps its slice of the table, [NSC, 64], in
//   shared memory, loaded once by bulk copies of one row slice each (170
//   KB at the city shape, 16 KB at the script's), so an entry's table
//   read is a shared load, not 1 KB from L2 per block. Where the slice
//   does not fit beside the rings (NSC > 700: dma_lanes), the second
//   path: L = 256, eight lanes a thread, the table read from global
//   memory (L2), chosen by size and said by the wrapper.
// - Only the live prefix is copied: ceil16(4 counts[b]) bytes of the row,
//   in chunks of up to 64 entries (256 bytes), each a cp.async.bulk that
//   completes on its stage's mbarrier; a block's first chunk also brings
//   the slice of its ray row 0. A warp keeps a ring of 6 chunk stages, its
//   lane 0 issuing the next chunk as soon as the warp has walked one, so
//   up to 6 copies are in flight while it walks. Chunks, not rows, make
//   the rings fit beside the table: a whole padded row is 3 KB at the
//   city shape. A row's last chunk writes the output row.
// - The walk takes eight entries at a time with no branch among them, so
//   their eight table loads issue together (with a branch per entry the
//   compiler sinks each load under it, and the entries' loads, multiplies
//   and adds run one chain after another).
// - Items go round robin over the CTAs of a slice and their warps, in
//   ascending block order unless the host passes an order (a ticket sort
//   costs the call more than the kernel takes); the warp's lanes load 32
//   items' blocks and counts at a time. With fewer CTAs than slices a CTA
//   takes several slices in turn, reloading the table.
// What bounds it at the city rows: the table slices' load (22.5 MB from
// L2 over 132 SMs) before the first entry, the static round robin, which
// leaves the busiest warp far more entries than the mean one
// (probe_smem_dma.warp_entries), and the instructions an entry costs a
// warp for its 2 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "tma.cuh"

namespace {

constexpr int RAY_BLOCK = 256;
constexpr int NWARP = RAY_BLOCK / 32;    // computing warps
constexpr int THREADS = RAY_BLOCK + 32;  // and the producer warp
constexpr int NFEAT = 10;  // ray feature rows that meet the coefficients
constexpr int R = 4;       // rays per thread in the f32 bodies
constexpr int GW = 4;      // lanes that share a thread's rays
constexpr float BIG_T = 1e30f;
constexpr float DET_EPS = 1e-12f;  // intersect.DET_EPS
constexpr int RING = 4;            // most stages in a ring
constexpr size_t RING_SMEM = 200 * 1024;  // most bytes of a ring
constexpr unsigned ALL = 0xffffffffu;
constexpr int SLOT_END = -1;   // slot.x: the CTA's work has ended
constexpr int SLOT_RAYS = -2;  // a ray block starts: (_, b, live entries)
constexpr unsigned RAY_TILE_BYTES = RAY_BLOCK * 16 * sizeof(float);
constexpr unsigned BOX_BYTES = 8 * sizeof(float);

enum Variant { LOOP, SLAB, MM_LANE, MM_LEAD, MM_BF16, FULL };

// ------------------------------------------------------------ micro_kernel
// bytes of one entry's tile in the variant's stage
__host__ __device__ constexpr unsigned entry_bytes(int v, int c) {
  return v == LOOP      ? 0u
         : v == SLAB    ? BOX_BYTES
         : v == MM_BF16 ? 16u * 4u * c * 2u
         : v == FULL    ? NFEAT * 4u * c * 4u + BOX_BYTES
                        : NFEAT * 4u * c * 4u;
}

struct Ring {
  uint64_t full[RING];   // the stage's copies have landed: 1 arrival + bytes
  uint64_t empty[RING];  // every computing warp is done: NWARP arrivals
  int4 slot[RING];       // what the stage holds (x: cluster id or SLOT_*)
};

// the per-ray slab test against an AABB (box: lo xyz, hi xyz), as
// _ray_slab: the ray enters before `upper` and before it leaves
__device__ __forceinline__ bool ray_slab(const float (&o)[3], float tmin,
                                         const float (&inv)[3],
                                         const float* box, float upper) {
  const float lox = (box[0] - o[0]) * inv[0];
  const float hix = (box[3] - o[0]) * inv[0];
  const float loy = (box[1] - o[1]) * inv[1];
  const float hiy = (box[4] - o[1]) * inv[1];
  const float loz = (box[2] - o[2]) * inv[2];
  const float hiz = (box[5] - o[2]) * inv[2];
  const float tenter = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)),
                             fmaxf(fminf(loz, hiz), tmin));
  const float texit = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)),
                            fminf(fmaxf(loz, hiz), upper));
  return tenter <= texit;
}

// OR of v over the 256 computing threads (named barrier 1)
__device__ __forceinline__ bool block_or(bool v) {
  int r;
  asm volatile(
      "{\n .reg .pred p, q;\n"
      " setp.ne.s32 p, %1, 0;\n"
      " bar.red.or.pred q, 1, %2, p;\n"
      " selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((int)v), "n"(RAY_BLOCK)
      : "memory");
  return r != 0;
}

// v[i] for i == g, without a dynamic index into registers
__device__ __forceinline__ float pick(const float (&v)[R], int g) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i)
    if (g == i) r = v[i];
  return r;
}

// the GW lanes of a ray group agree on each ray's minimum
__device__ __forceinline__ void merge_min(float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    for (int o = 1; o < GW; o <<= 1)
      v[i] = fminf(v[i], __shfl_xor_sync(ALL, v[i], o));
}

// k_full's edge tests on one pair's dot products
__device__ __forceinline__ bool inside(float dt, float un, float vn) {
  const float ud = un * dt;
  const float vd = vn * dt;
  return (fabsf(dt) > DET_EPS) & (ud >= 0.0f) & (vd >= 0.0f) &
         (ud + vd <= dt * dt);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D = A B (+ 0): one m16n8k16 bf16 MMA with float32 accumulation
__device__ __forceinline__ void mma_bf16(const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, float (&d)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
      " {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

struct MicroArgs {
  const float* rays;       // [nb * 256, 16]
  const int* sched;        // [nb * nc]
  const int* counts;       // [nb]
  const float* cb;         // [nc * 8]
  const void* coef;        // the variant's layout
  const long long* order;  // ray blocks in ticket order (NULL: ascending)
  int* ticket;             // the next ticket (zeroed by the host)
  float* out;              // [nb * 256]
  int nb, nc, c, stages;
  unsigned stage_bytes;
};

// The producer warp: every slot, up to the end. All 32 lanes walk the
// same blocks (the row's entries are spread over them); lane 0 waits on
// the ring and issues the copies.
template <int V>
__device__ void produce(Ring& rs, const MicroArgs& a, unsigned stage0) {
  const int lane = threadIdx.x & 31;
  const unsigned w4 = 4u * a.c;
  int n = 0;  // the next slot
  // lane 0: stage of slot n, once every computing warp has released it
  auto acquire = [&](unsigned& dst, unsigned& full) {
    const int s = n % a.stages;
    if (n >= a.stages)
      mbar_wait(smem_addr(&rs.empty[s]), (n / a.stages - 1) & 1);
    dst = stage0 + (unsigned)s * a.stage_bytes;
    full = smem_addr(&rs.full[s]);
    ++n;
    return s;
  };
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(a.ticket, 1);
    t = __shfl_sync(ALL, t, 0);
    if (t >= a.nb) break;
    const int b = a.order != nullptr ? (int)a.order[t] : t;
    const int* row = a.sched + (size_t)b * a.nc;
    const int count = a.counts[b];
    int e = lane < a.nc ? row[lane] : 0;  // in flight while the tile goes
    if (lane == 0) {
      unsigned dst, full;
      const int s = acquire(dst, full);
      rs.slot[s] = make_int4(SLOT_RAYS, b, count, 0);
      if (V == LOOP || count == 0) {
        mbar_arrive(full);  // completes the phase: no bytes expected
      } else {
        mbar_expect_tx(full, RAY_TILE_BYTES);
        bulk_g2s(dst, a.rays + (size_t)b * RAY_BLOCK * 16, RAY_TILE_BYTES,
                 full);
      }
    }
    for (int l = 0; l < count; ++l) {
      if (l > 0 && (l & 31) == 0) e = l + lane < a.nc ? row[l + lane] : 0;
      const int jc = __shfl_sync(ALL, e, l & 31);
      if (lane != 0) continue;
      unsigned dst, full;
      const int s = acquire(dst, full);
      rs.slot[s] = make_int4(jc, 0, 0, 0);
      if constexpr (V == LOOP) {
        mbar_arrive(full);
      } else if constexpr (V == SLAB) {
        mbar_expect_tx(full, BOX_BYTES);
        bulk_g2s(dst, a.cb + (size_t)jc * 8, BOX_BYTES, full);
      } else if constexpr (V == MM_LANE) {
        const float* cf = static_cast<const float*>(a.coef);
        const unsigned row_bytes = w4 * 4u;
        mbar_expect_tx(full, NFEAT * row_bytes);
        for (int k = 0; k < NFEAT; ++k)
          bulk_g2s(dst + k * row_bytes,
                   cf + (size_t)k * a.nc * w4 + (size_t)jc * w4, row_bytes,
                   full);
      } else if constexpr (V == MM_BF16) {
        const __nv_bfloat16* cf = static_cast<const __nv_bfloat16*>(a.coef);
        const unsigned bytes = 16u * w4 * 2u;
        mbar_expect_tx(full, bytes);
        bulk_g2s(dst, cf + (size_t)jc * 16 * w4, bytes, full);
      } else {  // MM_LEAD, FULL: rows 0-9 are contiguous
        const float* cf = static_cast<const float*>(a.coef);
        const unsigned bytes = NFEAT * w4 * 4u;
        mbar_expect_tx(full, bytes + (V == FULL ? BOX_BYTES : 0u));
        bulk_g2s(dst, cf + (size_t)jc * 16 * w4, bytes, full);
        if (V == FULL)
          bulk_g2s(dst + bytes, a.cb + (size_t)jc * 8, BOX_BYTES, full);
      }
    }
  }
  if (lane == 0) {
    unsigned dst, full;
    const int s = acquire(dst, full);
    rs.slot[s] = make_int4(SLOT_END, 0, 0, 0);
    mbar_arrive(full);
  }
}

// The computing threads' state per variant and what they do with a slot.
// f32 bodies: thread tid holds rays q0 .. q0 + 3 of the block (q0 = tid &
// ~3; lane g = tid & 3 of its group takes every GW-th chunk) and tests
// ray tid = q0 + g in the slab vote.
template <int V>
struct Body;

template <>
struct Body<LOOP> {
  float val;
  __device__ void start(const float*) { val = 0.0f; }
  __device__ void entry(int jc, const float*, int) { val = val + (float)jc; }
  __device__ void finish(float* out) { out[threadIdx.x] = val; }
};

// the slab features of ray q of a [256, 16] ray tile
struct SlabRay {
  float o[3], tmin, inv[3];
  __device__ void load(const float* tile, int q) {
    const float4* p = reinterpret_cast<const float4*>(tile + q * 16);
    const float4 v0 = p[0], v2 = p[2], v3 = p[3];
    o[0] = v0.x;
    o[1] = v0.y;
    o[2] = v0.z;
    tmin = v2.z;
    inv[0] = v3.x;
    inv[1] = v3.y;
    inv[2] = v3.z;
  }
};

template <>
struct Body<SLAB> {
  SlabRay sr;
  float val;
  __device__ void start(const float* tile) {
    val = BIG_T;
    if (tile != nullptr) sr.load(tile, threadIdx.x);
  }
  __device__ void entry(int, const float* box, int) {
    if (block_or(ray_slab(sr.o, sr.tmin, sr.inv, box, val))) val = val * 0.5f;
  }
  __device__ void finish(float* out) { out[threadIdx.x] = val; }
};

// rays q0 .. q0 + R - 1 of a [256, 16] ray tile: features 0..9
__device__ __forceinline__ void load_features(const float* tile, int q0,
                                              float (&f)[R][NFEAT]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4* p = reinterpret_cast<const float4*>(tile + (q0 + i) * 16);
    const float4 v0 = p[0], v1 = p[1];
    const float2 v2 = reinterpret_cast<const float2*>(p + 2)[0];
    f[i][0] = v0.x;
    f[i][1] = v0.y;
    f[i][2] = v0.z;
    f[i][3] = v0.w;
    f[i][4] = v1.x;
    f[i][5] = v1.y;
    f[i][6] = v1.z;
    f[i][7] = v1.w;
    f[i][8] = v2.x;
    f[i][9] = v2.y;
  }
}

// MM_LANE, MM_LEAD: the minimum over columns; the tile is [10][4c]
template <int V>
struct MmBody {
  float f[R][NFEAT], mn[R];
  __device__ void start(const float* tile) {
#pragma unroll
    for (int i = 0; i < R; ++i) mn[i] = BIG_T;
    if (tile != nullptr) load_features(tile, threadIdx.x & ~(GW - 1), f);
  }
  __device__ void entry(int, const float* rows, int c) {
    const int w4 = 4 * c;
    for (int ch = threadIdx.x & (GW - 1); ch < c; ch += GW) {
      float acc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
      for (int k = 0; k < NFEAT; ++k) {
        const float4 v =
            *reinterpret_cast<const float4*>(rows + k * w4 + 4 * ch);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][0] = fmaf(f[i][k], v.x, acc[i][0]);
          acc[i][1] = fmaf(f[i][k], v.y, acc[i][1]);
          acc[i][2] = fmaf(f[i][k], v.z, acc[i][2]);
          acc[i][3] = fmaf(f[i][k], v.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        mn[i] = fminf(mn[i], fminf(fminf(acc[i][0], acc[i][1]),
                                   fminf(acc[i][2], acc[i][3])));
    }
  }
  __device__ void finish(float* out) {
    merge_min(mn);
    out[threadIdx.x] = pick(mn, threadIdx.x & (GW - 1));
  }
};
template <>
struct Body<MM_LANE> : MmBody<MM_LANE> {};
template <>
struct Body<MM_LEAD> : MmBody<MM_LEAD> {};

template <>
struct Body<FULL> {
  float f[R][NFEAT], val[R];
  SlabRay sr;
  __device__ void start(const float* tile) {
#pragma unroll
    for (int i = 0; i < R; ++i) val[i] = BIG_T;
    if (tile != nullptr) {
      load_features(tile, threadIdx.x & ~(GW - 1), f);
      sr.load(tile, threadIdx.x);
    }
  }
  __device__ void entry(int, const float* rows, int c) {
    const int g = threadIdx.x & (GW - 1);
    const int w4 = 4 * c;
    // every lane of a group holds its rays' merged running t
    if (!block_or(ray_slab(sr.o, sr.tmin, sr.inv, rows + NFEAT * w4,
                           pick(val, g))))
      return;
    for (int tc = g; tc < c / 4; tc += GW) {  // triangles 4 tc .. 4 tc + 3
      float acc[4][4][R];                     // [t_num, det, u, v][tri][ray]
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < R; ++i) acc[q][j][i] = 0.0f;
#pragma unroll
      for (int k = 0; k < NFEAT; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              rows + k * w4 + q * c + 4 * tc);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[q][0][i] = fmaf(f[i][k], v.x, acc[q][0][i]);
            acc[q][1][i] = fmaf(f[i][k], v.y, acc[q][1][i]);
            acc[q][2][i] = fmaf(f[i][k], v.z, acc[q][2][i]);
            acc[q][3][i] = fmaf(f[i][k], v.w, acc[q][3][i]);
          }
        }
      }
      bool in[4][R], any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < R; ++i) {
          in[j][i] = inside(acc[1][j][i], acc[2][j][i], acc[3][j][i]);
          any = any || in[j][i];
        }
      if (!any) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (!in[j][i]) continue;
          const float t = acc[0][j][i] / acc[1][j][i];
          if (t > 1e-3f) val[i] = fminf(val[i], t);
        }
    }
    merge_min(val);
  }
  __device__ void finish(float* out) {
    out[threadIdx.x] = pick(val, threadIdx.x & (GW - 1));
  }
};

// Warp w holds rays 64 (w % 4) .. + 63 as four 16-row A tiles and takes
// the column groups m of parity w / 4, so each B fragment it loads feeds
// four MMAs; lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of
// each tile, and the minimum of its accumulator columns for those rows.
// The two warps of a ray meet at the block's end through shared memory.
template <>
struct Body<MM_BF16> {
  uint32_t a[4][4];
  float mn[4][2];
  float (*half)[RAY_BLOCK];  // [2][256]: the odd column groups' minima
  int par = 0;               // which of the two the block writes
  __device__ void start(const float* tile) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) mn[mt][0] = mn[mt][1] = BIG_T;
    if (tile == nullptr) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* r0 = tile + (ray0() + mt * 16 + g) * 16;
      const float* r1 = r0 + 8 * 16;
      const float2 x0 = *reinterpret_cast<const float2*>(r0 + 2 * t);
      const float2 x1 = *reinterpret_cast<const float2*>(r1 + 2 * t);
      const float2 x2 = *reinterpret_cast<const float2*>(r0 + 2 * t + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(r1 + 2 * t + 8);
      a[mt][0] = pack_bf16(x0.x, x0.y);
      a[mt][1] = pack_bf16(x1.x, x1.y);
      a[mt][2] = pack_bf16(x2.x, x2.y);
      a[mt][3] = pack_bf16(x3.x, x3.y);
    }
  }
  // the warp's first ray
  __device__ static int ray0() { return ((threadIdx.x >> 5) & 3) * 64; }
  __device__ void entry(int, const float* stage, int c) {
    const int w4 = 4 * c;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* bt = reinterpret_cast<const __nv_bfloat16*>(stage);
    for (int m = threadIdx.x >> 7; m < w4 / 64; m += 2) {
      const int col = m * 64 + g * 8;
      const uint4 r0 = *reinterpret_cast<const uint4*>(bt + 2 * t * w4 + col);
      const uint4 r1 =
          *reinterpret_cast<const uint4*>(bt + (2 * t + 1) * w4 + col);
      const uint4 r2 =
          *reinterpret_cast<const uint4*>(bt + (2 * t + 8) * w4 + col);
      const uint4 r3 =
          *reinterpret_cast<const uint4*>(bt + (2 * t + 9) * w4 + col);
      const uint32_t k0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t k1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t k8[4] = {r2.x, r2.y, r2.z, r2.w};
      const uint32_t k9[4] = {r3.x, r3.y, r3.z, r3.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // rows (2t, 2t + 1) and (2t + 8, 2t + 9) of column m 64 + 8 g + j
        const unsigned sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t b0 = __byte_perm(k0[j >> 1], k1[j >> 1], sel);
        const uint32_t b1 = __byte_perm(k8[j >> 1], k9[j >> 1], sel);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float d[4];
          mma_bf16(a[mt], b0, b1, d);
          mn[mt][0] = fminf(mn[mt][0], fminf(d[0], d[1]));
          mn[mt][1] = fminf(mn[mt][1], fminf(d[2], d[3]));
        }
      }
    }
  }
  __device__ void finish(float* out) {
    const int lane = threadIdx.x & 31;
    const bool odd = threadIdx.x >= 128;
    float v[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[mt][h] = mn[mt][h];
        v[mt][h] = fminf(v[mt][h], __shfl_xor_sync(ALL, v[mt][h], 1));
        v[mt][h] = fminf(v[mt][h], __shfl_xor_sync(ALL, v[mt][h], 2));
        if (odd && (lane & 3) == 0)
          half[par][ray0() + mt * 16 + h * 8 + (lane >> 2)] = v[mt][h];
      }
    // the two halves alternate, so a warp that runs ahead into the next
    // block's end cannot overwrite what this one still reads
    block_or(false);
    if (!odd && (lane & 3) == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = ray0() + mt * 16 + h * 8 + (lane >> 2);
          out[q] = fminf(v[mt][h], half[par][q]);
        }
    }
    par ^= 1;
  }
};

template <int V>
__global__ void __launch_bounds__(THREADS, V == FULL ? 1 : 2)
micro_kernel(MicroArgs a) {
  extern __shared__ float4 smem4[];
  const float* const ring = reinterpret_cast<const float*>(smem4);
  __shared__ Ring rs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_addr(&rs.full[s]), 1);
      mbar_init(smem_addr(&rs.empty[s]), NWARP);
    }
  }
  __syncthreads();
  if (threadIdx.x >= RAY_BLOCK) {  // the producer warp
    produce<V>(rs, a, smem_addr(smem4));
    return;
  }
  const int stride = (int)(a.stage_bytes / sizeof(float));
  Body<V> body;
  if constexpr (V == MM_BF16) {
    __shared__ float half[2][RAY_BLOCK];
    body.half = half;
  }
  int b = -1, s = 0;
  unsigned phase = 0;
  for (;;) {
    mbar_wait(smem_addr(&rs.full[s]), phase);
    const int4 d = rs.slot[s];
    const float* stage = ring + s * stride;
    if (d.x < 0) {
      // the block before is done
      if (b >= 0) body.finish(a.out + (size_t)b * RAY_BLOCK);
      if (d.x == SLOT_END) break;
      b = d.y;
      body.start(V != LOOP && d.z > 0 ? stage : nullptr);
    } else {
      body.entry(d.x, stage, a.c);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(smem_addr(&rs.empty[s]));
    if (++s == a.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  // every copy has landed: each warp waited on every slot up to the end
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// As many CTAs of `fn` as fit on the current card at once with `smem`
// bytes of dynamic shared memory, worked out once per kernel, size and
// card. A function has one shared-memory limit, whatever the size of a
// launch, so the limit set here only ever rises: a launch at a size seen
// before never finds it lowered by one at a smaller size.
cudaError_t fitting_ctas(const void* fn, int threads, size_t smem, int& n) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int>, int> fits;
  static std::map<std::pair<const void*, int>, size_t> limits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& limit = limits[std::make_pair(fn, dev)];
  if (smem > limit) {
    err = set_smem(fn, smem);
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  const auto key = std::make_tuple(fn, smem, dev);
  auto it = fits.find(key);
  if (it == fits.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                          smem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return err;
    it = fits.emplace(key, per_sm * sms).first;
  }
  n = it->second;
  return cudaSuccess;
}

// micro_kernel<V>'s ring at cluster width c: stages of the larger of a ray
// tile (none for LOOP) and an entry's tile, RING of them while they fit
// in RING_SMEM, else fewer, down to 2.
template <int V>
struct Micro {
  unsigned stage;
  int stages;
  size_t smem;
  explicit Micro(int c) {
    stage = entry_bytes(V, c);
    if (V != LOOP && stage < RAY_TILE_BYTES) stage = RAY_TILE_BYTES;
    stages = RING;
    while (stages > 2 && stages * (size_t)stage > RING_SMEM) --stages;
    smem = stages * (size_t)stage;
  }
  // the persistent grid: as many CTAs as fit (at most nb), or `forced`
  cudaError_t grid(int nb, int forced, int& ctas) const {
    cudaError_t err =
        fitting_ctas((const void*)micro_kernel<V>, THREADS, smem, ctas);
    if (err != cudaSuccess) return err;
    if (forced > 0) ctas = forced;
    if (ctas > nb) ctas = nb;
    return cudaSuccess;
  }
};

template <int V>
int launch_micro(const float* rays, const int* sched, const int* counts,
                 const float* cb, const void* coef, const long long* order,
                 int* ticket, float* out, int nb, int nc, int c, int forced,
                 cudaStream_t stream) {
  const Micro<V> k(c);
  int ctas = 0;
  const cudaError_t err = k.grid(nb, forced, ctas);
  if (err != cudaSuccess) return (int)err;
  const MicroArgs a{rays, sched, counts, cb, coef, order, ticket, out,
                    nb,   nc,    c,      k.stages, k.stage};
  micro_kernel<V><<<ctas, THREADS, k.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int V>
int micro_ctas(int nb, int c) {
  int ctas = 0;
  const cudaError_t err = Micro<V>(c).grid(nb, 0, ctas);
  return err == cudaSuccess ? ctas : -(int)err;
}

// --------------------------------------------------------- smem_dma_kernel
constexpr int DMA_WARPS = 16;
constexpr int DMA_THREADS = DMA_WARPS * 32;
constexpr int DMA_CH = 64;   // entries per chunk stage (256 bytes)
constexpr int DMA_RING = 6;  // chunk stages per warp
// dynamic shared memory the kernel may take: 227 KB less 4 KB for its
// static barriers and slot records
constexpr size_t DMA_SMEM = 227 * 1024 - 4096;

// the warps' rings for slices of L lanes: a stage holds a chunk's entries
// and the L floats of its block's ray row 0
__host__ __device__ constexpr size_t dma_stage_bytes(int lanes) {
  return DMA_CH * sizeof(int) + lanes * sizeof(float);
}
constexpr size_t dma_ring_bytes(int lanes) {
  return (size_t)DMA_WARPS * DMA_RING * dma_stage_bytes(lanes);
}

// lanes of the table slice a CTA keeps in shared memory for nsc rows: 64
// where [nsc, 64] fits beside the rings (nsc <= 700), else 0 (the table
// stays in global memory)
constexpr int DMA_LANES = 64;
int dma_lanes(int nsc) {
  const size_t need = (size_t)nsc * DMA_LANES * sizeof(float) +
                      dma_ring_bytes(DMA_LANES);
  return need <= DMA_SMEM ? DMA_LANES : 0;
}

// LPT consecutive floats from p (LPT * 4-byte aligned)
template <int LPT>
__device__ __forceinline__ void load_lanes(const float* p, float (&x)[LPT]) {
  if constexpr (LPT == 1) {
    x[0] = *p;
  } else if constexpr (LPT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < LPT / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  }
}

template <int LPT>
__device__ __forceinline__ void store_lanes(float* p, const float (&x)[LPT]) {
  if constexpr (LPT == 1) {
    *p = x[0];
  } else if constexpr (LPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < LPT / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// LPT lanes per thread, so slices of L = 32 LPT lanes; TABLE_SMEM: the
// CTA's table slice in shared memory, else read from global memory
template <int LPT, bool TABLE_SMEM>
__global__ void __launch_bounds__(DMA_THREADS, 1)
smem_dma_kernel(const int* __restrict__ counts, const int* __restrict__ sched,
                const float* __restrict__ rays,
                const float* __restrict__ table,
                const long long* __restrict__ order, float* __restrict__ out,
                int nb, int sw, int nsc) {
  constexpr int L = 32 * LPT;
  constexpr int S = RAY_BLOCK / L;  // slices
  constexpr int STAGE = (int)(dma_stage_bytes(L) / sizeof(int));
  extern __shared__ float4 smem4[];
  int* const rings = reinterpret_cast<int*>(smem4);  // [warp][stage][STAGE]
  float* const table_s = reinterpret_cast<float*>(
      rings + DMA_WARPS * DMA_RING * STAGE);  // [nsc][L]
  __shared__ uint64_t full[DMA_WARPS][DMA_RING];
  __shared__ int4 meta[DMA_WARPS][DMA_RING];  // block, l0, entries, last
  __shared__ uint64_t table_bar;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < DMA_WARPS; ++i)
      for (int s = 0; s < DMA_RING; ++s) mbar_init(smem_addr(&full[i][s]), 1);
    mbar_init(smem_addr(&table_bar), 1);
  }
  __syncthreads();
  int* const ring = rings + w * DMA_RING * STAGE;
  // warp-uniform ring counters, kept across slices so parities stay right
  int issued = 0, consumed = 0;
  unsigned table_phase = 0;
  const int grid = (int)gridDim.x;
  const int nv = grid > S ? grid : S;  // virtual CTAs: one slice each
  for (int v = blockIdx.x; v < nv; v += grid) {
    const int slice = v % S;
    const int per_slice = (nv - slice + S - 1) / S;
    const int lane0 = slice * L + lane * LPT;  // this thread's first lane
    const unsigned tb = smem_addr(&table_bar);
    if constexpr (TABLE_SMEM) {
      fence_proxy_async();
      __syncthreads();  // every warp is done with the slice before
      if (threadIdx.x == 0) mbar_expect_tx(tb, (unsigned)(nsc * L * 4));
      __syncthreads();
      for (int r = threadIdx.x; r < nsc; r += DMA_THREADS)
        bulk_g2s(smem_addr(table_s + r * L),
                 table + (size_t)r * RAY_BLOCK + slice * L, L * 4, tb);
    }
    // this warp's items: positions first, first + step, ... of the order
    const int first = (v / S) * DMA_WARPS + w;
    const int step = per_slice * DMA_WARPS;
    // producer cursor: item k's block, count and next entry; the lanes
    // hold 32 items' blocks and counts, from item `base` on
    int k = 0, pb = -1, pc = 0, pl = 0, base = -32, my_b = 0, my_c = 0;
    auto issue = [&]() -> bool {
      if (pb < 0) {
        if (first + k * step >= nb) return false;
        if (k - base >= 32) {
          base = k;
          const int p = first + (k + lane) * step;
          my_b = p >= nb ? 0 : order != nullptr ? (int)order[p] : p;
          my_c = p < nb ? counts[my_b] : 0;
        }
        pb = __shfl_sync(ALL, my_b, k - base);
        pc = __shfl_sync(ALL, my_c, k - base);
        pl = 0;
      }
      const int n = min(pc - pl, DMA_CH);
      const int s = issued % DMA_RING;
      if (lane == 0) {
        meta[w][s] = make_int4(pb, pl, n, pl + n >= pc);
        const unsigned fb = smem_addr(&full[w][s]);
        const unsigned dst = smem_addr(ring + s * STAGE);
        const unsigned bytes = (4u * n + 15u) & ~15u;
        // a block's first chunk brings the slice of its ray row 0 too
        mbar_expect_tx(fb, bytes + (pl == 0 ? L * 4u : 0u));
        if (bytes) bulk_g2s(dst, sched + (size_t)pb * sw + pl, bytes, fb);
        if (pl == 0)
          bulk_g2s(dst + DMA_CH * 4, rays + (size_t)pb * 16 * RAY_BLOCK +
                   slice * L, L * 4, fb);
      }
      ++issued;
      pl += n;
      if (pl >= pc) {
        pb = -1;
        ++k;
      }
      return true;
    };
    float acc[LPT], ray0[LPT];
    while (issued - consumed < DMA_RING && issue()) {
    }
    if constexpr (TABLE_SMEM) {  // the first copies are in flight
      mbar_wait(tb, table_phase);
      table_phase ^= 1u;
    }
    while (consumed < issued) {
      const int s = consumed % DMA_RING;
      mbar_wait(smem_addr(&full[w][s]), (consumed / DMA_RING) & 1);
      const int4 m = meta[w][s];
      const size_t o = (size_t)m.x * RAY_BLOCK + lane0;
      const int* ent = ring + s * STAGE;
      if (m.y == 0) {  // the block's first chunk
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[j] = 0.0f;
        load_lanes<LPT>(reinterpret_cast<const float*>(ent + DMA_CH) +
                            lane * LPT, ray0);
      }
      // Eight entries at a time, with no branch among them, so that their
      // table loads all issue before the first add; the adds run in entry
      // order. An entry past the chunk's end (the stage holds stale words
      // there) reads row 0 and adds +0, which leaves the sum's bits as they
      // are: the sum starts at +0 and a rounded sum is -0 only from two -0.
      for (int l = 0; l < m.z; l += 8) {
        const int4 ea = *reinterpret_cast<const int4*>(ent + l);
        const int4 eb = *reinterpret_cast<const int4*>(ent + l + 4);
        const int es[8] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
        float key[8], x[8][LPT];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = l + u < m.z ? es[u] : 0;
          // entries are non-negative: >> and & are the script's // and
          // rem; the key, below 2^15, converts exactly through the bits of
          // 2^23 + key (no conversion unit)
          key[u] = __int_as_float(0x4B000000 | (e >> 16)) - 8388608.0f;
          const int row = e & 0xFFFF;
          if constexpr (TABLE_SMEM)
            load_lanes<LPT>(table_s + row * L + lane * LPT, x[u]);
          else
            load_lanes<LPT>(table + (size_t)row * RAY_BLOCK + lane0, x[u]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const bool live = l + u < m.z;
#pragma unroll
          for (int j = 0; j < LPT; ++j)
            acc[j] = acc[j] + (live ? x[u][j] * key[u] : 0.0f);
        }
      }
      if (m.w) {
        float r[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) r[j] = acc[j] + ray0[j];
        store_lanes<LPT>(out + o, r);
      }
      fence_proxy_async();
      __syncwarp();  // the stage is read before the next copy into it
      ++consumed;
      issue();
    }
  }
}

template <int LPT, bool TABLE_SMEM>
struct Dma {
  static const void* fn() {
    return (const void*)smem_dma_kernel<LPT, TABLE_SMEM>;
  }
  static size_t smem(int nsc) {
    return dma_ring_bytes(32 * LPT) +
           (TABLE_SMEM ? (size_t)nsc * 32 * LPT * sizeof(float) : 0);
  }
  // as many CTAs as fit, or `forced`; at most the slices' share of the
  // blocks, DMA_WARPS items a CTA
  static cudaError_t grid(int nb, int nsc, int forced, int& ctas) {
    cudaError_t err = fitting_ctas(fn(), DMA_THREADS, smem(nsc), ctas);
    if (err != cudaSuccess) return err;
    if (forced > 0) ctas = forced;
    const int slices = RAY_BLOCK / (32 * LPT);
    const int most = slices * ((nb + DMA_WARPS - 1) / DMA_WARPS);
    if (ctas > most) ctas = most;
    return cudaSuccess;
  }
  static int launch(const int* counts, const int* sched, const float* rays,
                    const float* table, const long long* order, float* out,
                    int nb, int sw, int nsc, int forced, cudaStream_t stream) {
    int ctas = 0;
    const cudaError_t err = grid(nb, nsc, forced, ctas);
    if (err != cudaSuccess) return (int)err;
    smem_dma_kernel<LPT, TABLE_SMEM><<<ctas, DMA_THREADS, smem(nsc), stream>>>(
        counts, sched, rays, table, order, out, nb, sw, nsc);
    return (int)cudaGetLastError();
  }
  static int ctas(int nb, int nsc) {
    int n = 0;
    const cudaError_t err = grid(nb, nsc, 0, n);
    return err == cudaSuccess ? n : -(int)err;
  }
};

// the kernel path for nsc table rows: F(Dma<LPT, TABLE_SMEM>), a slice
// of DMA_LANES lanes in shared memory or all 256 from global memory
template <typename F>
int by_lanes(int nsc, F f) {
  if (dma_lanes(nsc)) return f(Dma<DMA_LANES / 32, true>());
  return f(Dma<RAY_BLOCK / 32, false>());
}

}  // namespace

extern "C" {

// Each launch entry point returns the CUDA error of the launch (0 =
// success). Launches on `stream`, allocates nothing, does not synchronise.

// rays [nb * 256, 16] f32, sched [nb * nc] i32 cluster ids, counts [nb],
// cb [nc * 8] AABBs, coef in the variant's layout (NULL for loop and
// slab), the ray blocks in ticket order (`order`, [nb] int64, a
// permutation; NULL: ascending) through `ticket`, one zeroed int32; out
// [nb * 256] f32.
// c a multiple of 16; rays, cb and coef 16-byte aligned. ctas: the
// persistent grid (1 .. nb), 0 for as many CTAs as fit.
#define FOV_MICRO(name, V)                                                   \
  int fov_micro_##name(const float* rays, const int* sched,                  \
                       const int* counts, const float* cb, const void* coef, \
                       const long long* order, int* ticket, float* out,      \
                       int nb, int nc, int c, int ctas,                      \
                       cudaStream_t stream) {                                \
    return launch_micro<V>(rays, sched, counts, cb, coef, order, ticket,     \
                           out, nb, nc, c, ctas, stream);                    \
  }
FOV_MICRO(loop, LOOP)
FOV_MICRO(slab, SLAB)
FOV_MICRO(mm_lane, MM_LANE)
FOV_MICRO(mm_lead, MM_LEAD)
FOV_MICRO(mm_bf16, MM_BF16)
FOV_MICRO(full, FULL)
#undef FOV_MICRO

// The persistent grid micro_kernel<variant> (0 .. 5 in the order above)
// takes for nb ray blocks of cluster width c, or minus the CUDA error.
int fov_micro_ctas(int variant, int nb, int c) {
  switch (variant) {
    case LOOP:
      return micro_ctas<LOOP>(nb, c);
    case SLAB:
      return micro_ctas<SLAB>(nb, c);
    case MM_LANE:
      return micro_ctas<MM_LANE>(nb, c);
    case MM_LEAD:
      return micro_ctas<MM_LEAD>(nb, c);
    case MM_BF16:
      return micro_ctas<MM_BF16>(nb, c);
    case FULL:
      return micro_ctas<FULL>(nb, c);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

// counts [nb] i32, sched [nb, sw] i32 (sw a multiple of 4), rays
// [nb, 16, 256] f32, table [nsc, 256] f32, the ray blocks in the order the
// CTAs take them (`order`, [nb] int64, a permutation; NULL: ascending),
// out [nb, 256] f32; sched, rays and table 16-byte aligned. ctas: the
// persistent grid, 0 for as many as fit.
int fov_smem_dma(const int* counts, const int* sched, const float* rays,
                 const float* table, const long long* order, float* out,
                 int nb, int sw, int nsc, int ctas, cudaStream_t stream) {
  return by_lanes(nsc, [&](auto k) {
    return k.launch(counts, sched, rays, table, order, out, nb, sw, nsc, ctas,
                    stream);
  });
}

// The lanes of the table slice a CTA keeps in shared memory for nsc
// rows, 0 if it reads the table from global memory.
int fov_smem_dma_lanes(int nsc) { return dma_lanes(nsc); }

// smem_dma_kernel's layout, into out[0..4]: warps per CTA, entries per
// chunk stage, chunk stages per warp, lanes of a table slice, and the
// dynamic shared memory a CTA may take (bytes). Returns 0.
int fov_smem_dma_layout(int* out) {
  out[0] = DMA_WARPS;
  out[1] = DMA_CH;
  out[2] = DMA_RING;
  out[3] = DMA_LANES;
  out[4] = (int)DMA_SMEM;
  return 0;
}

// The persistent grid smem_dma_kernel takes, or minus the CUDA error.
int fov_smem_dma_ctas(int nb, int nsc) {
  return by_lanes(nsc, [&](auto k) { return k.ctas(nb, nsc); });
}

}  // extern "C"
