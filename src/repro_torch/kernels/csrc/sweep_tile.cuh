// Tile machinery of the P2H sweep kernels for Hopper (sm_90a): a ring of
// tile slabs filled by 1-D bulk copies (TMA, cp.async.bulk + mbarrier), the
// per-tile point masks, a register-tiled f32 FMA over one slab, and the
// insertion of a slab's candidates into a sorted running top-k.
//
// A tile is (n0, dp) values of one element type (f32, or the bf16 / int8
// probe planes), rows contiguous, dp * sizeof(element) a multiple of 16
// bytes; a slab is kSlab of its rows.  A block of BQ queries scores a pass
// of up to four slabs at once, one per warp pair (kPairThreads threads),
// each thread owning QM queries x PM points (Micro<BQ>: 8 x 8 at BQ = 64);
// every score is one f32 accumulator summed by fmaf over the columns in
// ascending order from 0, bf16 and int8 values widened to f32 as they are
// read (exactly: a bf16 is the top half of an f32, an int8 an integer).
// Shared memory serves 128 requested bytes a cycle per SM whatever the
// broadcast, so the FMAs per byte a thread loads, QM * PM / (4 (QM + PM)),
// decide whether the FMA pipes or the loads bound the pass: 1 at 8 x 8,
// 0.5 at 4 x 4.  The candidates overwrite their slab, and one warp per
// query inserts them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sweep_tile {

constexpr int kThreads = 256;
constexpr int kSlab = 64;              // tile rows per ring stage
constexpr int kPairThreads = 64;       // threads scoring one slab
constexpr int kCandPitch = kSlab + 1;  // a slab's candidates, per query
constexpr int kMaxStages = 4;          // = the warp pairs of a block
constexpr int kProducer = kThreads - 32;  // the thread that issues loads
// The warp pair that runs each round's exchange -- pushes the top-k to
// the other CTAs, waits at the cluster barrier, computes lambda -- while
// the others score; it scores too only when a pass has four slabs.
constexpr int kRoundPair = kMaxStages - 1;
constexpr unsigned kFull = 0xffffffffu;

// Probe modes: the element type of points and queries.  0 f32; 1 bf16
// (held as its 16 bits); 2 int8.
template <int MODE>
struct Elem {
  using type = float;
};
template <>
struct Elem<1> {
  using type = uint16_t;
};
template <>
struct Elem<2> {
  using type = int8_t;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// Four consecutive values from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// Bytes of one ring stage: a slab of kSlab x dp elements of `esize`
// bytes, later the slab's candidates (BQ rows of kCandPitch floats).
__host__ __device__ inline int stage_bytes(int bq, int dp, int esize) {
  const int cand = (bq * kCandPitch + 3) / 4 * 16;
  return kSlab * dp * esize > cand ? kSlab * dp * esize : cand;
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// one thread: arrive on `bar` expecting `bytes`, then copy them
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  // order this block's earlier generic accesses to the stage before the
  // async proxy writes it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the two halves of a cluster barrier (every thread of every CTA); a
// thread whose writes the other CTAs must see arrives with release
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ slab ring
// `stages` buffers of `stride` bytes (a slab of kSlab rows of `rowb` bytes,
// later its candidates), one mbarrier each.  Slabs are consumed in the
// order they were issued; slab number `seq` lives in stage seq % stages and
// completes that stage's barrier phase seq / stages.
struct SlabRing {
  unsigned char* buf;
  uint64_t* bar;
  int stages, rowb, stride;

  __device__ unsigned char* stage(int seq) const {
    return buf + (size_t)(seq % stages) * stride;
  }
  __device__ float* cand(int seq) const {
    return reinterpret_cast<float*>(stage(seq));
  }
  __device__ void wait(int seq) const {
    uint64_t* b = &bar[seq % stages];
    const unsigned parity = (seq / stages) & 1;
    while (!mbar_try_wait(b, parity)) {
    }
  }
  __device__ void issue(int seq, const unsigned char* src, int rows) const {
    bulk_load(stage(seq), src, (unsigned)rows * rowb, &bar[seq % stages]);
  }
};

// The producer's side, held by one thread (kProducer): the slabs of visit
// entries first, first + step, ... < n, each entry with the rows `rows[j]`
// (up to its last non-pad point), issued in order.  The next entry's leaf
// and rows are loaded one entry ahead, so an entry boundary does not wait
// on them.  `seq` counts the slabs issued since the launch began; a new
// visit list (`begin`) keeps it, so the ring's phases carry over.
struct SlabStream {
  const int* visit;
  const int* rows;
  const unsigned char* pts;
  int n, step, n0, rowb;
  int j, leaf, nrows, slab;  // the entry being issued
  int next_leaf, next_rows;
  int seq;  // slabs issued so far

  __device__ void load_next() {
    const int jn = j + step;
    if (jn < n) {
      next_leaf = visit[jn];
      next_rows = rows[jn];
    }
  }
  __device__ void begin(const int* visit_, const int* rows_,
                        const unsigned char* pts_, int n_, int first,
                        int step_, int n0_, int rowb_) {
    visit = visit_;
    rows = rows_;
    pts = pts_;
    n = n_;
    step = step_;
    n0 = n0_;
    rowb = rowb_;
    j = first;
    slab = 0;
    leaf = j < n ? visit[j] : 0;
    nrows = j < n ? rows[j] : 0;
    load_next();
  }
  // issue slabs while fewer than `limit` have been issued
  __device__ void fill(const SlabRing& ring, int limit) {
    while (seq < limit && j < n) {
      if (slab * kSlab >= nrows) {  // next entry
        j += step;
        leaf = next_leaf;
        nrows = next_rows;
        slab = 0;
        load_next();
        continue;
      }
      const int r = min(kSlab, nrows - slab * kSlab);
      ring.issue(seq, pts + ((size_t)leaf * n0 + slab * kSlab) * rowb, r);
      ++seq;
      ++slab;
    }
  }
};

// ------------------------------------------------------------ the bounds
// Per (query, tile) terms, computed once per tile: lambda, |<q, c>|, |q|,
// the cone terms q_cos and q_sin, whether the node test leaves the query
// active, the k-th of the union of the CTAs' top-ks at the round's start
// (lambda before the cap), and for the low-precision probes the
// dequantisation scale sq * tile_scale and the slack
// |q| * slack_a + sq * slack_b that widens each score.
struct QueryTerms {
  float *lam, *aip, *qn, *qcos, *qsin, *ukth, *scale, *err;
  int* act;
};

// A stored |acc| as the mode's candidate value: f32 as is; bf16 widened by
// the slack; int8 dequantised, then widened (round-to-nearest intrinsics,
// no contraction, as the plain version's separate tensor ops).
template <int MODE>
__device__ __forceinline__ float probe_value(float a, float scale,
                                             float err) {
  if constexpr (MODE == 0) return a;
  if constexpr (MODE == 1) return __fadd_rn(a, err);
  return __fadd_rn(fabsf(__fmul_rn(a, scale)), err);
}

__device__ __forceinline__ float cone_cases(float qc, float qs, float xc,
                                            float xs) {
  const float a = __fsub_rn(__fmul_rn(qc, xc), __fmul_rn(qs, xs));
  const float b = __fadd_rn(__fmul_rn(qc, xc), __fmul_rn(qs, xs));
  return (a > 0.f && qc > 0.f && xc > 0.f) ? a : (b < 0.f ? -b : 0.f);
}

// ------------------------------------------------ the register-tiled FMA
template <int BQ>
struct Micro {
  static constexpr int QM = BQ >= 32 ? 8 : (BQ >= 16 ? 4 : (BQ >= 8 ? 2 : 1));
  static constexpr int PM = BQ / QM;  // 8 x 8 at 64, 8 x 4 at 32, ...
  static constexpr int QG = BQ / QM;
  static constexpr int PG = kSlab / PM;
  static_assert(QG * PG == kPairThreads, "one warp pair per slab");
};

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ float lane_of(const float4& a, int c) {
  return c == 0 ? a.x : (c == 1 ? a.y : (c == 2 ? a.z : a.w));
}

// Scores of one slab by one warp pair (`ptid` 0..63, named barrier
// `bar_id`): thread (tq, tp) owns queries tq*QM + i and slab rows tp + PG*j;
// qT is the block's queries transposed and widened (dp x BQ f32); the slab
// is kSlab rows x dp values of type T.  Scores need no lambda, so a slab is
// scored before its round's lambda is known.  Once the pair has read the
// slab, the scores overwrite its stage: cand[qi * kCandPitch + p] =
// |<q, x>| (the odd pitch puts a warp's stores in distinct banks).  Rows
// beyond what was loaded are scored from stale data and never inserted.
template <int BQ, typename T>
__device__ __forceinline__ void score_slab(unsigned char* stage,
                                           const float* __restrict__ qT,
                                           int dp, int ptid, int bar_id) {
  using M = Micro<BQ>;
  const int tq = ptid / M::PG, tp = ptid % M::PG;
  float acc[M::QM][M::PM];
#pragma unroll
  for (int i = 0; i < M::QM; ++i)
#pragma unroll
    for (int j = 0; j < M::PM; ++j) acc[i][j] = 0.f;
  const T* xr = reinterpret_cast<const T*>(stage) + (size_t)tp * dp;
  const float* qc = qT + tq * M::QM;
#pragma unroll 1
  for (int c = 0; c < dp; c += 4) {
    float4 xv[M::PM];
#pragma unroll
    for (int j = 0; j < M::PM; ++j)
      xv[j] = load4(xr + (size_t)j * M::PG * dp + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float qv[M::QM];
      load_vec<M::QM>(qv, qc + (c + cc) * BQ);
#pragma unroll
      for (int j = 0; j < M::PM; ++j) {
        const float x = lane_of(xv[j], cc);
#pragma unroll
        for (int i = 0; i < M::QM; ++i) acc[i][j] = fmaf(qv[i], x, acc[i][j]);
      }
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "n"(kPairThreads)
               : "memory");  // the pair is done reading the slab
  float* cand = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int j = 0; j < M::PM; ++j)
#pragma unroll
    for (int i = 0; i < M::QM; ++i)
      cand[(tq * M::QM + i) * kCandPitch + tp + j * M::PG] =
          fabsf(acc[i][j]);
}

// ---------------------------------------------------------- the top-k
// Insert `v` (id `id`) into the sorted top-k `td`/`ti` of K values,
// warp-wide; entries <= v stay ahead of it.  Needs v < td[K - 1].
__device__ __forceinline__ void topk_insert(float* td, int* ti, int K,
                                            float v, int id, int lane) {
  int pos = 0;
  for (int e0 = 0; e0 < K; e0 += 32)
    pos += __popc(__ballot_sync(kFull, e0 + lane < K && td[e0 + lane] <= v));
  for (int e0 = ((K - 1) / 32) * 32; e0 >= 0; e0 -= 32) {
    const int e = e0 + lane;
    const bool shift = e < K && e > pos;
    float nv = 0.f;
    int ni = 0;
    if (shift) {
      nv = td[e - 1];
      ni = ti[e - 1];
    }
    __syncwarp();
    if (shift) {
      td[e] = nv;
      ti[e] = ni;
    } else if (e == pos) {
      td[e] = v;
      ti[e] = id;
    }
    __syncwarp();
  }
}

// The running top-k of one query while one warp inserts a pass into it:
// with K <= 32 in registers (lane e holds entry e, an insertion is a ballot
// and two shuffles), else in shared memory (topk_insert).  Both keep the
// same order: entries <= a new value stay ahead of it.
struct WarpTopK {
  float* td;
  int* ti;
  int K, lane;
  bool reg;
  float rd, kth;  // lane's entry (registers), the k-th
  int ri;

  __device__ void load(float* td_, int* ti_, int K_, int lane_) {
    td = td_, ti = ti_, K = K_, lane = lane_;
    reg = K <= 32;
    if (reg) {
      rd = lane < K ? td[lane] : INFINITY;
      ri = lane < K ? ti[lane] : -1;
    }
    kth = td[K - 1];
  }
  // Needs w < kth.
  __device__ void insert(float w, int id) {
    if (reg) {
      const int pos = __popc(__ballot_sync(kFull, lane < K && rd <= w));
      const float ud = __shfl_up_sync(kFull, rd, 1);
      const int ui = __shfl_up_sync(kFull, ri, 1);
      if (lane < K && lane > pos) {
        rd = ud;
        ri = ui;
      } else if (lane == pos) {
        rd = w;
        ri = id;
      }
      kth = __shfl_sync(kFull, rd, K - 1);
    } else {
      topk_insert(td, ti, K, w, id, lane);
      kth = td[K - 1];
    }
  }
  __device__ void store() const {
    if (reg && lane < K) {
      td[lane] = rd;
      ti[lane] = ri;
    }
  }
};

// The point tables of a pass's rows: ids (-1: pad), and for the bounds
// rx, x_cos, x_sin.
struct Points {
  const int* ids;
  const float *rx, *xc, *xs;
  int rows;  // valid rows of the pass; the rest are pads
};

// One warp per active query: the pass's scores (stages seq0, seq0 + 1, ...,
// as the mode's candidate values, probe_value) that beat the query's k-th and that the point bounds keep -- not a pad,
// point ball bound (Corollary 1) and point cone bound (Theorem 3) below the
// round's lambda -- enter its sorted top-k in row order, so the set kept
// is the k smallest of (top-k, kept candidates) with ties to the lower
// index.  A score above the round's union k-th is dropped: the union
// already holds k values at or below it, so it can reach neither a later
// lambda nor the final merge, and the CTA's own k-th, looser by a factor
// of the split, would let it in.  The bounds are evaluated only for the
// scores left, which after warm-up are few; all the pass's values are
// loaded before the first test, so the common case costs one round of
// loads and ballots.
template <int BQ, int MODE>
__device__ __forceinline__ void insert_pass(const SlabRing& ring, int seq0,
                                            int np, const Points& pts,
                                            const QueryTerms& t, int use_ball,
                                            int use_cone, float* topd,
                                            int* topi, int K, int warp,
                                            int lane) {
  constexpr int QW = BQ >= 8 ? BQ / 8 : 1;  // queries per warp
  constexpr int H = 2 * kMaxStages;         // 32-row halves of a pass
  // every load of the warp's queries first, then one ballot per query
  float v[QW][H];
  bool beats[QW];
#pragma unroll
  for (int u = 0; u < QW; ++u) {
    const int qi = warp + 8 * u;
    const bool live = qi < BQ && t.act[qi];
    const float kth = live ? topd[qi * K + K - 1] : -INFINITY;
    const float ukth = live ? t.ukth[qi] : -INFINITY;
    float scale = 0.f, err = 0.f;
    if constexpr (MODE != 0) {
      scale = live ? t.scale[qi] : 0.f;
      err = live ? t.err[qi] : 0.f;
    }
    bool b = false;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float* cd = ring.cand(seq0 + h / 2) + qi * kCandPitch;
      v[u][h] = live && h < 2 * np
                    ? probe_value<MODE>(cd[32 * (h & 1) + lane], scale, err)
                    : INFINITY;
      b |= v[u][h] < kth && v[u][h] <= ukth;
    }
    beats[u] = __any_sync(kFull, b);
  }
#pragma unroll
  for (int u = 0; u < QW; ++u) {
    if (!beats[u]) continue;  // warp-uniform: the common case
    const int qi = warp + 8 * u;
    WarpTopK top;
    top.load(topd + qi * K, topi + qi * K, K, lane);
    const float lam = t.lam[qi], aip = t.aip[qi], qn = t.qn[qi];
    const float qc = t.qcos[qi], qs = t.qsin[qi], ukth = t.ukth[qi];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int row = 32 * h + lane;
      bool ok = v[u][h] < top.kth && v[u][h] <= ukth && row < pts.rows &&
                pts.ids[row] >= 0;
      if (ok && use_ball)
        ok = fmaxf(__fsub_rn(aip, __fmul_rn(qn, pts.rx[row])), 0.f) < lam;
      if (ok && use_cone)
        ok = cone_cases(qc, qs, pts.xc[row], pts.xs[row]) < lam;
      // Every lane left in m beats the current k-th: an insertion lowers
      // the k-th, and the lanes it no longer admits leave m at once (they
      // could never enter later), so a tile met with an open top-k costs
      // one ballot per insertion, not one step per candidate.
      unsigned m = __ballot_sync(kFull, ok);
      while (m) {  // row 32 h + b of the pass
        const int b = __ffs(m) - 1;
        top.insert(__shfl_sync(kFull, v[u][h], b), pts.ids[32 * h + b]);
        m &= (m - 1) & __ballot_sync(kFull, v[u][h] < top.kth);
      }
    }
    top.store();
  }
}

// The k-th smallest value of S sorted lists of K values (list s at
// lists[s * stride]), S <= 8; ties go to the lower list.  Each list's head
// and the value after it live in registers; a step picks the least head by
// selects (no branch: the lanes of a warp pick different lists) and issues
// one load, whose value is filed at the next step, so no step waits on it.
__device__ __forceinline__ float kth_of_lists(const float* lists, int S,
                                              int stride, int K) {
  int h[8];
  float v[8], nx[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    h[s] = 0;
    v[s] = s < S ? lists[s * stride] : INFINITY;
    nx[s] = s < S && K > 1 ? lists[s * stride + 1] : INFINITY;
  }
  float m = INFINITY, pend = INFINITY;
  int pb = -1;  // the list whose value `pend` is
  for (int step = 0; step < K; ++step) {
#pragma unroll
    for (int s = 0; s < 8; ++s) nx[s] = s == pb ? pend : nx[s];
    int b = 0, hb = h[0];
    m = v[0];
#pragma unroll
    for (int s = 1; s < 8; ++s) {
      const bool less = v[s] < m;
      m = less ? v[s] : m;
      b = less ? s : b;
      hb = less ? h[s] : hb;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      v[s] = s == b ? nx[s] : v[s];
      h[s] = s == b ? hb + 1 : h[s];
    }
    pend = hb + 2 < K ? lists[b * stride + hb + 2] : INFINITY;
    pb = b;
  }
  return m;
}

}  // namespace sweep_tile
