// Cluster ray/triangle intersection kernels for Hopper (sm_90a).
//
// Replace the four Pallas kernels of fovtrace/kernels/pallas_isect.py:
//   closest_kernel           <- _closest_kernel (:518, with its update,
//                               epilogue and bound-key helpers)
//   occlusion_kernel         <- _occlusion_kernel (:806, with its update)
//   closest_stream_kernel    <- _closest_kernel_stream (:577)
//   occlusion_stream_kernel  <- _occlusion_kernel_stream (:850)
// They compute the same results from the same inputs: the [NB,16,256]
// ray feature blocks, the Cramer coefficients of each triangle, and the
// front-to-back schedule of live entries per ray block. The resident
// pair takes the flat (M == 1) schedule; the streaming pair takes any M,
// walking inside each entry (supercluster sc) the members mi whose
// liveness bit is set, cluster sc*M + mi (with M == 1 every entry, the
// bitmask unread, as in the reference).
//
// Both pairs read the coefficients as per-triangle records: rows 0-9 of
// the pack laid out once per pack as rec[jc][j][q*10 + k]
// (triangle_records in kernels/cluster_isect.py), so a cluster is one
// contiguous c x 160-byte slab (20 KB at c = 128); a transparent
// cluster's aux rows 0-4 already are one 20c-byte slab of the [NC,8,c]
// aux. One producer thread copies each slab with one 1-D bulk (TMA) copy
// into a ring of up to 4 shared-memory stages, each with a full and an
// empty mbarrier (tma.cuh), running up to 3 stages ahead (4 for a
// producer warp); every computing warp waits on a stage's full barrier
// and arrives on its empty one when done. The copy costs the other
// threads no instructions.
//
// The inner loop, shared by both pairs:
// - Tiling. Each thread holds R = 4 rays and takes every gw-th triangle
//   of a cluster; the gw lanes that share rays sit in one warp. One record
//   read (ten 16-byte shared loads) feeds 40 R FMAs (dots: fmaf over k =
//   0..9, --fmad=false, so every kernel rounds a pair alike); the division
//   runs only for a pair inside the triangle's edges, in one branch per
//   triangle that few take.
// - Merge. Closest hit: a lane keeps a (t, id) per ray over its
//   triangles, and the lanes of a ray merge them by shuffles at the end
//   of each entry (merge_closest): the strict-`<` minimum over the walk,
//   ties to the earliest member and lowest lane, exactly; the TPU's packed
//   (t_bits & ~127) | lane reduction key is not needed. Occlusion: opaque
//   hits zero a ray in any order; a transparent member's Fresnel factors
//   are multiplied per lane, then the lanes' products into the attenuation
//   in lane order. That may round unlike one sequential product, by a few
//   ulp at most, and only for a ray that meets two factors after the first.
// - Exits per warp: a schedule key lower-bounds the entry distance of
//   every ray of the block, and bound_key adds 2 against rounding.
//   Closest hit: a warp stops once the next entry's key exceeds bound_key
//   of its rays' largest merged best t (or t_max). Occlusion: once the key
//   exceeds bound_key of their largest t_max, or every one of them is
//   fully occluded (zero stays zero under factors clamped to [0, 1]); the
//   opaque test leaves a member once every ray of the warp is hit, a
//   warp-uniform check. A stopped warp still arrives on the ring, and
//   the producer stops staging a block's entries once no warp's bound
//   admits the next one.
//
// The resident pair: persistent CTAs. Earth's ray blocks test ~1.5
// clusters each, so a kernel with one CTA per ray block pays a launch, a
// barrier setup, an exposed first copy and the ray loads for ~1.5
// clusters of work. Here the grid holds as many CTAs as fit on the card
// at once; each takes ray blocks one after another from a ticket counter,
// in an order the host gives (the most live entries first, so that no
// long walk starts last), and computes each whole, so the results do not
// depend on the grid or the order. One producer walks the (block, entry)
// pairs of the CTA's successive blocks through one ring: a block's first
// slot is its ray tile (rows 0-11, 12 KB, copied like a slab), which the
// 8 computing warps read from shared memory, and block k+1's copies are
// in flight while block k's last entries compute. In closest hit the
// producer is a ninth warp, whose ticket, order and schedule loads wait
// on L2 off the computing warps' path; occlusion, which cannot give up
// the registers a ninth warp costs (RESIDENT_BOUNDS), uses thread 0 of
// warp 0, the streaming pair's way. Bounds only
// fall within a block but rise again at the next, and the producer runs
// ahead of the warps, so each warp publishes its bound tagged with its
// block's sequence number in the CTA: a bound tagged with an older block
// means "this warp has not started the block", which admits every entry.
// The CTA's end is a slot with no bytes; no copy is in flight at exit.
//
// The streaming pair. On the TPU the pack (65 MB for the city scene)
// cannot sit in VMEM, so each entry's [M,16,4c] slab is DMA'd into a
// two-slot scratch while the previous entry computes. Here one CTA per ray
// block walks the block's live (entry, member) pairs through the ring and
// merges each entry at its last live member. Heavy blocks: a ray block
// with more than HEAVY = 64 live entries is split over SPLIT = 8 CTAs of
// 32 rays each (Tile, place): its walk, which alone can outlast every
// other block (hundreds of member clusters on city's bounce-0 rays
// against a mean near 10), then runs on SPLIT SMs. Each CTA owns its
// rays, so nothing is merged across CTAs. The grid holds the split CTAs
// of every ray block, since the host does not know which blocks are
// heavy; those of a light block return at once.
//
// What bounds them on the H100: arithmetic issue, not memory. Per (ray,
// triangle) pair, 40 FMAs, 2.5 shared loads and ~10 other instructions
// on the path most pairs take; a cluster's 20 KB of records feed 256 x
// 128 pairs (earth's 44 clusters sit in L2). The front-to-back schedule
// with its exits is what removes work. A K = 10 contraction is too thin
// for wgmma to pay; tensor-core forms are later work.
//
// Built by nvcc with --fmad=false: the epilogue then rounds exactly like
// the plain PyTorch version; the dot products use explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "tma.cuh"

namespace {

constexpr int RAY_BLOCK = 256;
constexpr int NWARP = RAY_BLOCK / 32;
constexpr int NFEAT = 10;   // ray feature rows that meet the coefficients
constexpr int REC = 4 * NFEAT;  // coefficient floats per triangle
constexpr float BIG_T = 1e30f;
constexpr float DET_EPS = 1e-12f;
constexpr int RING = 4;            // most stages in a block's ring
constexpr unsigned ALL = 0xffffffffu;
constexpr int SLOT_TRANSPARENT = 1;  // slot flags
constexpr int SLOT_LAST = 2;         // the entry's last live member
// stage bytes up to which a ring keeps RING stages; two blocks of 256
// threads then share an SM
constexpr size_t RING_SMEM = 113 * 1024;
// rays per thread (4 ran 13-32% faster than 2 on city's main-path shapes)
constexpr int R = 4;

// f32 bound -> quantized schedule key, +2 so rounding here can never
// break while a cluster's true entry distance is <= the bound
__device__ __forceinline__ int bound_key(float b, float scale, float t_cap) {
  return (int)(fminf(fmaxf(b, 0.0f), t_cap) * scale) + 2;
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

// Where a thread's rays sit. Each thread holds R rays and the gw lanes of
// a ray group share them, each lane taking triangles g, g + gw, ... of
// every member; a warp holds whole groups.
struct Tile {
  int b;          // ray block
  int gw;         // lanes per ray group: each lane takes triangles g + gw k
  int g;          // this lane's place in its group
  int q0;         // the block's index of this thread's first ray
  unsigned lead;  // the first lane of every group in a warp, as a bitmask
};

// the groups of gw lanes, the CTA's rays starting at block index q_base
__device__ __forceinline__ void set_groups(Tile& t, int gw, int q_base) {
  t.gw = gw;
  t.g = threadIdx.x % gw;
  t.q0 = q_base + threadIdx.x / gw * R;
  t.lead = 0;
  for (int k = 0; k < 32; k += gw) t.lead |= 1u << k;
}

// A warp's work counts for its block, into zeroed outputs (the warps of
// a block, and of a split block's CTAs, add theirs up): visited, the
// member clusters the block tested (some warp computed them: each warp
// computes a prefix of the walk); ray_visited, rays x member clusters its
// warps computed, so ray_visited * c is the pairs
__device__ __forceinline__ void count_tested(const Tile& tl, int tested,
                                             int* visited, int* ray_visited) {
  if ((threadIdx.x & 31) != 0) return;
  if (visited != nullptr) atomicMax(visited + tl.b, tested);
  if (ray_visited != nullptr)
    atomicAdd(ray_visited + tl.b, tested * (32 / tl.gw * R));
}

// A block's ring of record stages: the state beside the stages
// themselves (dynamic shared memory, `stages` x stage bytes).
struct Ring {
  uint64_t full[RING];   // the stage's copy has landed: 1 arrival + bytes
  uint64_t empty[RING];  // every warp is done with the stage: NWARP arrivals
  int4 slot[RING];       // what the stage holds (see each pair's producer)
  int wbound[NWARP];     // each warp's bound key; -1 once it has stopped
};

__device__ __forceinline__ void publish_bound(Ring& rs, int w, int v) {
  reinterpret_cast<volatile int*>(rs.wbound)[w] = v;
}

// Barriers and every warp's first bound; a block barrier follows.
__device__ __forceinline__ void ring_open(Ring& rs, int bound) {
  if ((threadIdx.x & 31) == 0 && threadIdx.x < RAY_BLOCK)
    rs.wbound[threadIdx.x >> 5] = bound;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_addr(&rs.full[s]), 1);
      mbar_init(smem_addr(&rs.empty[s]), NWARP);
    }
  }
  __syncthreads();
}

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
// record read (ten 16-byte loads) feeds 40 R FMAs, each sum in k order
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

// The reference's edge tests (_mt_epilogue) on one pair's dot products:
// inside the triangle with a usable det. Most pairs fail them; the t,
// which needs the division, matters only for those that pass
__device__ __forceinline__ bool inside(float dt, float un, float vn) {
  const float ud = un * dt;
  const float vd = vn * dt;
  return (fabsf(dt) > DET_EPS) & (ud >= 0.0f) & (vd >= 0.0f) &
         (ud + vd <= dt * dt);
}

// _mt_epilogue's t for a pair inside the edges, where its
// 1 / (|det| > eps ? det : 1) is 1 / det: the same rounding
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

// every lane of the warp is lit by none of its rays
__device__ __forceinline__ bool warp_dark(const float (&ar)[R],
                                          const float (&ag)[R],
                                          const float (&ab)[R]) {
  bool lit = false;
#pragma unroll
  for (int i = 0; i < R; ++i) lit = lit || ar[i] + ag[i] + ab[i] > 0.0f;
  return !__any_sync(ALL, lit);
}

// ----------------------------------------------------------- resident pair
// slot.x of a resident ring: a cluster id, or one of these
constexpr int SLOT_END = -1;   // the CTA's work has ended
constexpr int SLOT_RAYS = -2;  // a ray block starts: (_, b, live entries)
constexpr int RAY_ROWS = 12;   // a ray tile: the features, t_min, t_max
constexpr unsigned RAY_TILE_BYTES = RAY_ROWS * RAY_BLOCK * sizeof(float);
constexpr int TAG_MASK = 0x7FFF;

// A warp's published bound: its block's sequence number in the CTA (mod
// 2^15: the producer runs at most RING slots, so RING blocks, ahead of
// any warp) above the bound key + 1 (-1, stopped, is 0)
__device__ __forceinline__ int tagged(int seq, int bound) {
  return ((seq & TAG_MASK) << 16) | (bound + 1);
}

// The producer's walk over the CTA's blocks, in shared memory: registers
// are the scarcer resource, and no other thread reads it.
struct BlockWalk {
  const int* row;  // the current block's schedule row
  int count;       // its live entries
  int l;           // its next entry
  int seq;         // its sequence number in the CTA
  int n;           // the next slot to issue
  int ended;       // the end slot is issued
};

// The producer's side of a resident ring. Slot n goes to stage n % stages,
// once every warp has released slot n - stages. While the current block
// has an entry left that some warp may still compute, the slot holds that
// entry's records (x: cluster id, z: key, w: SLOT_TRANSPARENT for a
// transparent cluster in occlusion, with its aux rows after the records);
// otherwise the next ray block starts (x: SLOT_RAYS, y: block, z: live
// entries) with its ray tile (no bytes for a block with none), or, with
// no ticket left, the CTA ends (x: SLOT_END).
struct Feed {
  const float* raysT;  // [NB, 16, 256]
  const float* rec;    // [NC, c, REC]
  const float* aux;    // [NC, 8, c], nullptr for closest hit
  const int* tflags;   // [NC]
  const int* sched;
  const int* counts;
  const long long* order;  // ray blocks in ticket order
  int* ticket;             // the next ticket (zeroed by the host)
  BlockWalk& st;
  unsigned stage0, stage_bytes;
  int c, sw, nb, stages;

  // Would some warp compute the current block's entry with this key? A
  // bound tagged with an older block is no bound: that warp has not
  // started the block. A stale read of a warp's own bound is larger, so
  // it can only delay the end.
  __device__ __forceinline__ bool admits(const Ring& rs, int key) const {
    const volatile int* wb = rs.wbound;
    const int tag = st.seq & TAG_MASK;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const int v = wb[w];
      if ((v >> 16) != tag || (v & 0xFFFF) - 1 >= key) return true;
    }
    return false;
  }

  __device__ __forceinline__ void issue(Ring& rs) {
    if (st.ended) return;
    const int n = st.n++;
    const int s = n % stages;
    if (n >= stages)
      mbar_wait(smem_addr(&rs.empty[s]), (n / stages - 1) & 1);
    const unsigned full = smem_addr(&rs.full[s]);
    const unsigned dst = stage0 + (unsigned)s * stage_bytes;
    if (st.l < st.count) {
      const int e = st.row[st.l];
      if (admits(rs, e >> 16)) {
        const int jc = e & 0xFFFF;
        const bool tr = aux != nullptr && tflags[jc] == 1;
        rs.slot[s] = make_int4(jc, st.l, e >> 16, tr ? SLOT_TRANSPARENT : 0);
        ++st.l;
        const unsigned rec_bytes = (unsigned)c * REC * sizeof(float);
        const unsigned aux_bytes = (unsigned)c * 5 * sizeof(float);
        mbar_expect_tx(full, rec_bytes + (tr ? aux_bytes : 0u));
        bulk_g2s(dst, rec + (size_t)jc * c * REC, rec_bytes, full);
        if (tr)
          bulk_g2s(dst + rec_bytes, aux + (size_t)jc * 8 * c, aux_bytes, full);
        return;
      }
    }
    const int t = atomicAdd(ticket, 1);
    if (t >= nb) {
      rs.slot[s] = make_int4(SLOT_END, 0, 0, 0);
      mbar_arrive(full);  // completes the phase: no bytes expected
      st.ended = 1;
      return;
    }
    const int b = (int)order[t];
    st.row = sched + (size_t)b * 2 * sw;
    st.count = counts[b];
    st.l = 0;
    ++st.seq;
    rs.slot[s] = make_int4(SLOT_RAYS, b, st.count, 0);
    if (st.count == 0) {
      mbar_arrive(full);
      return;
    }
    mbar_expect_tx(full, RAY_TILE_BYTES);
    bulk_g2s(dst, raysT + (size_t)b * 16 * RAY_BLOCK, RAY_TILE_BYTES, full);
  }

  // The walk's state and the ring; a block barrier follows (ring_open).
  __device__ __forceinline__ void open(Ring& rs) {
    if (threadIdx.x == 0) st = BlockWalk{nullptr, 0, 0, -1, 0, 0};
    ring_open(rs, tagged(TAG_MASK, -1));  // no warp has started a block
  }
  // Thread 0 as the producer: slots 0 .. stages - 2 before its first
  // wait on the ring (`prime`), then one slot per slot it consumes.
  __device__ __forceinline__ void prime(Ring& rs) {
    for (int k = 0; k + 1 < stages; ++k) issue(rs);
  }
  // The producer warp's lane 0: every slot, up to the end.
  __device__ __forceinline__ void run(Ring& rs) {
    while (!st.ended) issue(rs);
  }
};

// The resident tile: every ray block whole in one CTA, R rays per thread,
// groups of R lanes.
__device__ __forceinline__ Tile resident_tile() {
  Tile t;
  t.b = -1;
  set_groups(t, R, 0);
  return t;
}

// Two CTAs per SM. The register file is four banks of 16,384, one per
// warp scheduler, and a warp's registers sit in one bank: 16 warps (thread
// 0 as the producer) may take 128 registers a thread, 18 (8 computing
// warps and a producer warp) put 5 on some bank and may take 96. Closest
// hit runs in 96 without spills and takes the producer warp; occlusion's
// loop needs more (it spills at 96) and takes thread 0.
constexpr int CLOSEST_THREADS = RAY_BLOCK + 32;
constexpr int OCCLUSION_THREADS = RAY_BLOCK;

__global__ void __launch_bounds__(CLOSEST_THREADS, 2)
closest_kernel(const float* __restrict__ raysT, const float* __restrict__ rec,
               const int* __restrict__ sched, const int* __restrict__ counts,
               const long long* __restrict__ order, int* __restrict__ ticket,
               const float* __restrict__ params, float* __restrict__ t_out,
               int* __restrict__ idx_out, int* __restrict__ visited,
               int* __restrict__ ray_visited, int nb, int c, int sw,
               int stages, unsigned stage_bytes) {
  extern __shared__ float4 smem4[];
  const float* const ring = reinterpret_cast<const float*>(smem4);
  __shared__ Ring rs;
  __shared__ BlockWalk walk;
  Feed feed{raysT, rec, nullptr, nullptr, sched, counts, order, ticket, walk,
            smem_addr(smem4), stage_bytes, c, sw, nb, stages};
  Tile tl = resident_tile();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = params[0];
  const float t_cap = params[1];
  const int stride = (int)(stage_bytes / sizeof(float));
  feed.open(rs);
  if (threadIdx.x >= RAY_BLOCK) {  // the producer warp
    if (threadIdx.x == RAY_BLOCK) feed.run(rs);
    return;
  }

  float f[R][NFEAT], tmin[R], tmax[R], bt[R], tmax_w = 0.0f;
  int bi[R];
  int seq = -1, tested = 0, bound = -1, s = 0;
  unsigned phase = 0;
  bool active = false;
  for (;;) {
    mbar_wait(smem_addr(&rs.full[s]), phase);
    const int4 d = rs.slot[s];
    if (d.x < 0) {
      // the block before is done: its results and counts
      if (tl.b >= 0) {
        if (tl.g < R) {
          t_out[(size_t)tl.b * RAY_BLOCK + tl.q0 + tl.g] = pick(bt, tl.g);
          idx_out[(size_t)tl.b * RAY_BLOCK + tl.q0 + tl.g] = pick(bi, tl.g);
        }
        count_tested(tl, tested, visited, ray_visited);
      }
      if (d.x == SLOT_END) break;
      tl.b = d.y;
      ++seq;
      tested = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        bt[i] = BIG_T;
        bi[i] = -1;
      }
      active = d.z > 0;
      if (active) {
        load_rays(ring + s * stride, 0, tl.q0, f, tmin, tmax);
        tmax_w = warp_max(max_of(tmax));
        bound = bound_key(tmax_w, scale, t_cap);
      }
      if (lane == 0) publish_bound(rs, w, tagged(seq, active ? bound : -1));
    } else if (active) {
      // front to back: a key above the bound of the warp's largest best t
      // (or t_max) means no triangle of this entry or a later one is
      // closer for any of its rays
      if (d.z > bound) {
        active = false;
        if (lane == 0) publish_bound(rs, w, tagged(seq, -1));
      } else {
        closest_member(f, tmin, tmax, ring + s * stride, d.x * c, c, tl, bt,
                       bi);
        ++tested;
        merge_closest(bt, bi, tl.gw);  // every entry is its own last member
        bound = bound_key(fminf(warp_max(max_of(bt)), tmax_w), scale, t_cap);
        if (lane == 0) publish_bound(rs, w, tagged(seq, bound));
      }
    }
    ring_release(rs, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  // every copy has landed: each warp waited on every slot up to the end
}

__global__ void __launch_bounds__(OCCLUSION_THREADS, 2)
occlusion_kernel(const float* __restrict__ raysT,
                 const float* __restrict__ rec, const float* __restrict__ aux,
                 const int* __restrict__ tflags, const int* __restrict__ sched,
                 const int* __restrict__ counts,
                 const long long* __restrict__ order, int* __restrict__ ticket,
                 const float* __restrict__ params, float* __restrict__ ar_out,
                 float* __restrict__ ag_out, float* __restrict__ ab_out,
                 int* __restrict__ visited, int* __restrict__ ray_visited,
                 int nb, int c, int sw, int stages, unsigned stage_bytes) {
  extern __shared__ float4 smem4[];
  const float* const ring = reinterpret_cast<const float*>(smem4);
  __shared__ Ring rs;
  __shared__ BlockWalk walk;
  Feed feed{raysT, rec, aux, tflags, sched, counts, order, ticket, walk,
            smem_addr(smem4), stage_bytes, c, sw, nb, stages};
  Tile tl = resident_tile();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = (int)(stage_bytes / sizeof(float));
  feed.open(rs);
  if (threadIdx.x == 0) feed.prime(rs);

  float f[R][NFEAT], tmin[R], tmax[R], ar[R], ag[R], ab[R];
  int seq = -1, tested = 0, tkey = -1, s = 0;
  unsigned phase = 0;
  bool active = false;
  for (;;) {
    if (threadIdx.x == 0) feed.issue(rs);
    __syncwarp();
    mbar_wait(smem_addr(&rs.full[s]), phase);
    const int4 d = rs.slot[s];
    if (d.x < 0) {
      if (tl.b >= 0) {
        if (tl.g < R) {
          const size_t o = (size_t)tl.b * RAY_BLOCK + tl.q0 + tl.g;
          ar_out[o] = pick(ar, tl.g);
          ag_out[o] = pick(ag, tl.g);
          ab_out[o] = pick(ab, tl.g);
        }
        count_tested(tl, tested, visited, ray_visited);
      }
      if (d.x == SLOT_END) break;
      tl.b = d.y;
      ++seq;
      tested = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) ar[i] = ag[i] = ab[i] = 1.0f;
      active = d.z > 0;
      if (active) {
        load_rays(ring + s * stride, 0, tl.q0, f, tmin, tmax);
        tkey = bound_key(warp_max(max_of(tmax)), params[0], params[1]);
      }
      if (lane == 0) publish_bound(rs, w, tagged(seq, active ? tkey : -1));
    } else if (active) {
      // the schedule is past every t_max of the warp's rays
      if (d.z > tkey) {
        active = false;
      } else {
        occlusion_member(f, tmin, tmax, ring + s * stride, c, tl,
                         (d.w & SLOT_TRANSPARENT) != 0, ar, ag, ab);
        ++tested;
        active = !warp_dark(ar, ag, ab);
      }
      if (!active && lane == 0) publish_bound(rs, w, tagged(seq, -1));
    }
    ring_release(rs, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// ---------------------------------------------------------- streaming pair
// a ray block with more than HEAVY live entries is heavy: its rays are
// split over SPLIT CTAs of RAY_BLOCK / SPLIT
constexpr int HEAVY = 64;
constexpr int SPLIT = 8;

// Where a CTA's threads sit. The grid holds SPLIT CTAs for each of the
// first `nsplit` ray blocks (nb, or 0 where no block may split) as if it
// were heavy (more than `heavy_at` live entries: HEAVY on the render
// path), first so that they start first, then one CTA per ray block as if
// it were light; a CTA whose ray block is of the other kind returns at
// once. A light block's CTA takes its 256 rays with gw = R; a heavy
// block's CTA takes RAY_BLOCK / SPLIT of them with gw = SPLIT * R, so the
// block's walk runs on SPLIT SMs at once.
__device__ __forceinline__ bool place(const int* __restrict__ counts,
                                      int heavy_at, int nsplit, Tile& t) {
  const int x = blockIdx.x;
  const bool heavy_cta = x < SPLIT * nsplit;
  t.b = heavy_cta ? x / SPLIT : x - SPLIT * nsplit;
  if ((counts[t.b] > heavy_at) != heavy_cta) return false;
  set_groups(t, heavy_cta ? SPLIT * R : R,
             heavy_cta ? x % SPLIT * (RAY_BLOCK / SPLIT) : 0);
  return true;
}

// Thread 0's side of a streaming ring. It walks the block's live (entry,
// member) pairs and puts pair n into stage n % stages with one bulk copy
// of the member's records (and a second of its aux rows 0-4 for a
// transparent member in occlusion), once every warp has released pair
// n - stages; the slot holds the cluster id, entry, entry key and
// SLOT_* flags. It writes the end instead (cluster id -1) once the walk is
// over or the next entry's key exceeds every warp's bound: bounds only
// fall and keys only rise, so no warp would compute that entry or a later
// one (a bound read before a warp lowered it is larger, so it can only
// delay the end).
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
  count_tested(tl, tested, visited, ray_visited);
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
      if (warp_dark(ar, ag, ab)) {
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
  count_tested(tl, tested, visited, ray_visited);
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

// The resident kernel of `occlusion` at cluster width c: its function,
// threads, stage bytes (a cluster's records, and aux rows for occlusion,
// or a ray tile, whichever is larger) and stages.
struct Resident {
  const void* fn;
  size_t stage, smem;
  int stages, threads;
  Resident(bool occlusion, int c) {
    fn = occlusion ? (const void*)occlusion_kernel
                   : (const void*)closest_kernel;
    threads = occlusion ? OCCLUSION_THREADS : CLOSEST_THREADS;
    stage = (size_t)c * (REC + (occlusion ? 5 : 0)) * sizeof(float);
    if (stage < RAY_TILE_BYTES) stage = RAY_TILE_BYTES;
    stages = ring_stages(stage);
    smem = stages * stage;
  }

  // The persistent grid: as many CTAs as fit on the current card at once
  // (at most nb), or `forced` of them (1 .. nb; 0: as many as fit). What
  // fits, and the kernel's shared-memory setting, are worked out once per
  // kernel, c and card: the render path launches each kernel many times
  // a frame from a host that is already the frame's bottleneck.
  cudaError_t grid(int nb, int forced, int& ctas) const {
    static std::mutex mu;
    static std::map<std::tuple<const void*, size_t, int>, int> fits;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(fn, smem, dev);
    auto it = fits.find(key);
    if (it == fits.end()) {
      int sms = 0, per_sm = 0;
      err = set_smem(fn, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                            threads, smem);
      if (err == cudaSuccess && per_sm < 1)
        err = cudaErrorInvalidConfiguration;
      if (err != cudaSuccess) return err;
      it = fits.emplace(key, per_sm * sms).first;
    }
    ctas = forced > 0 ? forced : it->second;
    if (ctas > nb) ctas = nb;
    return cudaSuccess;
  }
};

int launch_closest(const float* raysT, const float* rec, const int* sched,
                   const int* counts, const long long* order, int* ticket,
                   const float* params, float* t_out, int* idx_out,
                   int* visited, int* ray_visited, int nb, int c, int sw,
                   int forced, cudaStream_t stream) {
  const Resident k(false, c);
  int ctas = 0;
  cudaError_t err = k.grid(nb, forced, ctas);
  if (err != cudaSuccess) return (int)err;
  closest_kernel<<<ctas, k.threads, k.smem, stream>>>(
      raysT, rec, sched, counts, order, ticket, params, t_out, idx_out,
      visited, ray_visited, nb, c, sw, k.stages, (unsigned)k.stage);
  return (int)cudaGetLastError();
}

int launch_occlusion(const float* raysT, const float* rec, const float* aux,
                     const int* tflags, const int* sched, const int* counts,
                     const long long* order, int* ticket, const float* params,
                     float* ar, float* ag, float* ab, int* visited,
                     int* ray_visited, int nb, int c, int sw, int forced,
                     cudaStream_t stream) {
  const Resident k(true, c);
  int ctas = 0;
  cudaError_t err = k.grid(nb, forced, ctas);
  if (err != cudaSuccess) return (int)err;
  occlusion_kernel<<<ctas, k.threads, k.smem, stream>>>(
      raysT, rec, aux, tflags, sched, counts, order, ticket, params, ar, ag,
      ab, visited, ray_visited, nb, c, sw, k.stages, (unsigned)k.stage);
  return (int)cudaGetLastError();
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
// `stream`, allocates nothing, does not synchronise. Both pairs take the
// triangle records rec [NC, c, 40] (see triangle_records in
// kernels/cluster_isect.py) in place of the pack. `visited` and
// `ray_visited` (either may be NULL) must be zeroed: visited receives the
// member clusters each block tested, ray_visited rays x member clusters
// its warps computed.
//
// The resident pair takes the flat schedule, and the ray blocks in ticket
// order (`order`, [NB] int64, a permutation) through `ticket`, one zeroed
// int32.
int fov_closest_hit(const float* raysT, const float* rec, const int* sched,
                    const int* counts, const long long* order, int* ticket,
                    const float* params, float* t_out, int* idx_out,
                    int* visited, int* ray_visited, int nb, int c, int sw,
                    cudaStream_t stream) {
  return launch_closest(raysT, rec, sched, counts, order, ticket, params,
                        t_out, idx_out, visited, ray_visited, nb, c, sw, 0,
                        stream);
}

int fov_occlusion(const float* raysT, const float* rec, const float* aux,
                  const int* tflags, const int* sched, const int* counts,
                  const long long* order, int* ticket, const float* params,
                  float* ar, float* ag, float* ab, int* visited,
                  int* ray_visited, int nb, int c, int sw,
                  cudaStream_t stream) {
  return launch_occlusion(raysT, rec, aux, tflags, sched, counts, order,
                          ticket, params, ar, ag, ab, visited, ray_visited,
                          nb, c, sw, 0, stream);
}

// The persistent grid the resident kernel of `occlusion` (0 or 1) takes
// for nb ray blocks of cluster width c, or minus the CUDA error.
int fov_resident_ctas(int occlusion, int nb, int c) {
  int ctas = 0;
  const cudaError_t err = Resident(occlusion != 0, c).grid(nb, 0, ctas);
  return err == cudaSuccess ? ctas : -(int)err;
}

// For tests and measurement only: the resident pair on a grid of `ctas`
// CTAs (1 .. nb; 0: as many as fit, as above).
int fov_closest_hit_grid(const float* raysT, const float* rec,
                         const int* sched, const int* counts,
                         const long long* order, int* ticket,
                         const float* params, float* t_out, int* idx_out,
                         int* visited, int* ray_visited, int nb, int c,
                         int sw, int ctas, cudaStream_t stream) {
  return launch_closest(raysT, rec, sched, counts, order, ticket, params,
                        t_out, idx_out, visited, ray_visited, nb, c, sw, ctas,
                        stream);
}

int fov_occlusion_grid(const float* raysT, const float* rec, const float* aux,
                       const int* tflags, const int* sched, const int* counts,
                       const long long* order, int* ticket,
                       const float* params, float* ar, float* ag, float* ab,
                       int* visited, int* ray_visited, int nb, int c, int sw,
                       int ctas, cudaStream_t stream) {
  return launch_occlusion(raysT, rec, aux, tflags, sched, counts, order,
                          ticket, params, ar, ag, ab, visited, ray_visited,
                          nb, c, sw, ctas, stream);
}

// The streaming pair takes any M. Ray blocks with more than HEAVY live
// entries are split over SPLIT CTAs.
int fov_closest_hit_stream(const float* raysT, const float* rec,
                           const int* sched, const int* counts,
                           const float* params, float* t_out, int* idx_out,
                           int* visited, int* ray_visited, int nb, int c,
                           int sw, int m, cudaStream_t stream) {
  return launch_closest_stream(raysT, rec, sched, counts, params, t_out,
                               idx_out, visited, ray_visited, nb, c, sw, m,
                               HEAVY, nb, stream);
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
