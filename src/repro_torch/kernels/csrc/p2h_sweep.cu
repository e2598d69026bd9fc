// Fused P2HNNS leaf sweep for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/p2h_scan.py:55
// (p2h_sweep_kernel).  Per block of `bq` queries it walks the leaf tiles in
// the block's preference order `visit`; a tile is skipped (and counted)
// when the node ball bound (Theorem 2) is >= lambda for every query of the
// block; otherwise its points are masked by the pad id -1, the point ball
// bound (Corollary 1) and the point cone bound (Theorem 3), scored as
// |<q, x>| in f32 and merged into a running top-k.  Output: each query's
// exact top-k of the visited tiles' points, sorted ascending, under `cap`.
//
// What bounds it on an H100: f32 operations.  Cell 1 (1,000,000 x 128
// planted, 1024 queries, k = 10) needs 2 * 1024 * 10^6 * 129 = 2.64e11 f32
// operations on its non-pad rows: 3.94 ms at the 67 TFLOP/s f32 peak.  At
// bq = 64 the 16 query blocks read each tile 16 times, ~8.5 GB, 2.5 ms at
// 3.35 TB/s, so operations, not bytes, set the floor.
//
// What the design does about it.
//   1. Query blocks of up to 64 (bq = 64 on the card's main path): each
//      tile row read from memory serves 64 queries.
//   2. A split visit list.  A query block is one thread block cluster of
//      `split` CTAs; in round r CTA s takes visit entry r * split + s, so
//      every CTA gets promising tiles early, and each keeps its own sorted
//      top-k.  At each round's start every CTA pushes its top-k into every
//      CTA's shared memory (distributed shared memory, a buffer per round
//      parity) and arrives at the cluster barrier; lambda = min(cap, k-th
//      smallest of the union of the CTAs' top-ks), what one walker would
//      have after the same tiles: a valid bound, the same on every run, so
//      the skip test, the bounds and the skip counts are deterministic.
//      One barrier per round, split into arrive and wait around the
//      round's first scores (below), so a CTA that is ahead scores instead
//      of waiting; one warp pair (kRoundPair) pushes, waits and computes
//      lambda while the others score, and scores itself only when a pass
//      has four slabs.  At the end CTA rank 0 merges the top-ks (lower rank
//      first on ties) and sums the skip counts.  The wrapper picks the
//      largest split <= 8 that fits the SMs and keeps every cluster in the
//      first wave (cudaOccupancyMaxActiveClusters: on an H100 SXM 17
//      clusters of 6 fit but only 15 of 7 or 8, so 16 query blocks take
//      6).  The launch is cudaLaunchKernelEx with a cluster dimension; a
//      refused launch is an error returned to the caller.
//   3. Loads overlap compute.  A tile arrives as 64-row slabs (64 x 132 x
//      4 B = 33.8 KB) through a ring of 2-4 stages in dynamic shared
//      memory, by 1-D bulk copies (cp.async.bulk) completing on one
//      mbarrier per stage, issued by one producer thread as stages free.
//      Only the slabs up to a tile's last non-pad row are loaded; the next
//      tiles' slabs load while this one is finished.  The point tables (ids,
//      rx, x_cos, x_sin, by cp.async) and the per-query node terms load one
//      round ahead.  A slab of a tile that then skips is wasted bytes and
//      FMAs, never a wrong answer.
//   4. Register-tiled f32 FMA (sweep_tile.cuh, score_slab).  Shared memory
//      serves 128 requested bytes a cycle per SM, broadcast or not, so a
//      4 x 4 tile per thread (one FMA per byte loaded: 0.5) is load-bound;
//      at bq = 64 each warp pair scores one slab, each thread 8 queries x 8
//      rows (FMAs = bytes), reading 16-byte vectors: queries transposed
//      (dp x bq), points row-major with a 132-float pitch (33 x 16 B, odd:
//      eight rows in eight bank groups).  Four pairs score four slabs at
//      once.  Each score is one f32 accumulator, fmaf(q[c], x[c], acc) for
//      c = 0 .. dp-1 in order from 0: no TF32, no tensor cores, the bits of
//      a column-ordered f32 sum.  Scores need no lambda, so a round's first
//      slabs are scored between the barrier's arrive and wait.
//   5. Cheap bounds and top-k.  q_cos and q_sin once per (query, tile).  The
//      scores overwrite their slab; one warp per query loads all of a
//      pass's scores, and only those that beat the query's current k-th and
//      are not above the round's union k-th (a larger one can reach no
//      later lambda and no answer) -- after warm-up a handful -- are
//      tested against the pad id and the point bounds (round-to-nearest
//      intrinsics, no FMA contraction, like the plain version's separate
//      tensor ops) and inserted, in row order, into the sorted top-k: the
//      set kept is the k smallest of (top-k, kept candidates), ties to the
//      lowest index.  For k <= 32 the warp holds the query's top-k in
//      registers while it inserts (a ballot and two shuffles each), since
//      a tile met by an open top-k inserts dozens of values per query.
//
// ptxas -v (sm_90a, -O3, CUDA 12.8) for the main path's instance, bq = 64:
// 255 registers, no spill stores or loads, no static shared memory;
// __launch_bounds__(256, 1): one CTA per SM, 256 x 255 registers of the
// SM's 65,536.  Its dynamic shared memory at cell 1 (dp = 132, k = 10,
// split = 6, 4 stages) is 214,832 bytes of the 232,448 a block may use.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sweep_tile;

struct Params {
  const int* visit;         // (nqb, n_visit)
  const int* vrows;         // (nqb, n_visit): rows to the last non-pad one
  const float* queries;     // (B, dp)
  const float* qnorm;       // (B,)
  const float* cap;         // (B,)
  const float* leaf_ip;     // (B, L)
  const float* leaf_lb;     // (B, L)
  const float* leaf_cnorm;  // (L,)
  const float* pts;         // (L, n0, dp)
  const int* ids;           // (L, n0)
  const float* rx;          // (L, n0)
  const float* xc;          // (L, n0)
  const float* xs;          // (L, n0)
  float* out_d;             // (B, k)
  int* out_i;               // (B, k)
  int* out_s;               // (nqb,)
  int L, n0, dp, n_visit, k, split, stages;
  int use_ball, use_cone;
};

// Byte offsets of one CTA's dynamic shared memory.
struct Layout {
  size_t bars, misc, terms, ring, qT, lists, topd, topi, ids, rx, xc, xs,
      total;
};

__host__ __device__ inline size_t up16(size_t b) {
  return (b + 15) & ~size_t(15);
}

__host__ __device__ inline Layout layout(int bq, int split, int n0, int dp,
                                         int k, int stages) {
  Layout l;
  size_t o = 0;
  const size_t n0r = (size_t)((n0 + kSlab - 1) / kSlab) * kSlab;
  const size_t bk = (size_t)bq * k;
  l.bars = o, o += up16(kMaxStages * 8);
  l.misc = o, o += 16;  // the skip count
  l.terms = o, o += up16(8 * 4 * (size_t)bq);  // 7 floats + 1 int per query
  l.ring = o, o += up16((size_t)stages * stage_bytes(bq, dp, 4));
  l.qT = o, o += up16((size_t)dp * bq * 4);
  // every CTA's top-k of a round's start, by round parity
  l.lists = o, o += up16(2 * (size_t)split * bk * 4);
  l.topd = o, o += up16(bk * 4);
  l.topi = o, o += up16(bk * 4);
  l.ids = o, o += up16(2 * n0r * 4);  // the point tables, by round parity
  l.rx = o, o += up16(2 * n0r * 4);
  l.xc = o, o += up16(2 * n0r * 4);
  l.xs = o, o += up16(2 * n0r * 4);
  l.total = o;
  return l;
}

template <int BQ>
__global__ void __launch_bounds__(kThreads, 1) p2h_sweep_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.split;
  const int s = (int)cluster.block_rank();
  const int qb = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = p.n0, dp = p.dp, K = p.k, BK = BQ * p.k;
  const int n0r = ((n0 + kSlab - 1) / kSlab) * kSlab;
  const Layout l = layout(BQ, S, n0, dp, K, p.stages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  int* misc = reinterpret_cast<int*>(smem + l.misc);
  float* tf = reinterpret_cast<float*>(smem + l.terms);
  const QueryTerms t{tf,          tf + BQ, tf + 2 * BQ, tf + 3 * BQ,
                     tf + 4 * BQ, tf + 7 * BQ, nullptr,  nullptr,
                     reinterpret_cast<int*>(tf + 6 * BQ)};
  float* t_cap = tf + 5 * BQ;
  float* qT = reinterpret_cast<float*>(smem + l.qT);
  float* lists = reinterpret_cast<float*>(smem + l.lists);
  float* topd = reinterpret_cast<float*>(smem + l.topd);
  int* topi = reinterpret_cast<int*>(smem + l.topi);
  int* s_ids = reinterpret_cast<int*>(smem + l.ids);
  float* s_rx = reinterpret_cast<float*>(smem + l.rx);
  float* s_xc = reinterpret_cast<float*>(smem + l.xc);
  float* s_xs = reinterpret_cast<float*>(smem + l.xs);
  const SlabRing ring{smem + l.ring, bars, p.stages, dp * 4,
                      stage_bytes(BQ, dp, 4)};

  const float* qsrc = p.queries + (size_t)qb * BQ * dp;
  for (int e = tid; e < BQ * dp; e += kThreads) {
    const int qi = e / dp, c = e - qi * dp;
    qT[c * BQ + qi] = qsrc[e];
  }
  for (int e = tid; e < BK; e += kThreads) {
    topd[e] = INFINITY;
    topi[e] = -1;
  }
  if (tid < BQ) {
    t.qn[tid] = p.qnorm[qb * BQ + tid];
    t_cap[tid] = p.cap[qb * BQ + tid];
  }
  const int* visit = p.visit + (size_t)qb * p.n_visit;
  const int* vrows = p.vrows + (size_t)qb * p.n_visit;
  SlabStream stream;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
    misc[0] = 0;
  }
  cluster.sync();  // the barriers are set and every CTA of the cluster runs
  if (tid == kProducer) {
    stream.seq = 0;
    stream.begin(visit, vrows,
                 reinterpret_cast<const unsigned char*>(p.pts), p.n_visit,
                 s, S, n0, dp * 4);
    stream.fill(ring, p.stages);
  }

  const int pair = warp >> 1, ptid = tid & (kPairThreads - 1);
  const bool round_pair = pair == kRoundPair;
  const int lt = tid - kRoundPair * kPairThreads;  // a lambda thread's query
  // What a round needs before its barrier is fetched one round ahead: the
  // visit entry and its rows two rounds ahead, the node terms and the point
  // tables (cp.async into the buffer of the round's parity) one round ahead.
  auto entry = [&](int r, int& leaf, int& rows) {
    const int j = r * S + s;
    leaf = j < p.n_visit ? visit[j] : -1;
    rows = j < p.n_visit ? vrows[j] : 0;
  };
  auto fetch = [&](int r, int leaf, int rows, float& ip, float& lb,
                   float& cn) {
    if (leaf < 0) return;
    const size_t base = (size_t)leaf * n0, off = (size_t)(r & 1) * n0r;
    for (int pt = tid; pt < rows; pt += kThreads) {
      cp_async4(&s_ids[off + pt], p.ids + base + pt);
      if (p.use_ball) cp_async4(&s_rx[off + pt], p.rx + base + pt);
      if (p.use_cone) {
        cp_async4(&s_xc[off + pt], p.xc + base + pt);
        cp_async4(&s_xs[off + pt], p.xs + base + pt);
      }
    }
    if (lt >= 0 && lt < BQ) {
      const size_t o = (size_t)(qb * BQ + lt) * p.L + leaf;
      ip = p.leaf_ip[o];
      lb = p.leaf_lb[o];
      cn = p.leaf_cnorm[leaf];
    }
  };
  int leaf_c, rows_c, leaf_n, rows_n;
  float ip_c = 0.f, lb_c = INFINITY, cn_c = 1.f;
  float ip_n = 0.f, lb_n = INFINITY, cn_n = 1.f;
  entry(0, leaf_c, rows_c);
  entry(1, leaf_n, rows_n);
  fetch(0, leaf_c, rows_c, ip_c, lb_c, cn_c);

  int cseq = 0, nskip = 0;
  const int rounds = (p.n_visit + S - 1) / S;
  for (int r = 0; r < rounds; ++r) {
    const bool has = leaf_c >= 0;
    const int nslab = (rows_c + kSlab - 1) / kSlab;
    const int off = (r & 1) * n0r;
    float* lists_r = lists + (size_t)(r & 1) * S * BK;
    // The round pair pushes this CTA's sorted top-k (final: every
    // insertion ends in a barrier) into every CTA's lists of the round.
    if (round_pair) {
      if (BK % 4 == 0) {  // 16-byte remote stores
        for (int rs = 0; rs < S; ++rs) {
          float4* dst = reinterpret_cast<float4*>(
              cluster.map_shared_rank(lists_r + s * BK, rs));
          const float4* src = reinterpret_cast<const float4*>(topd);
          for (int e = ptid; e < BK / 4; e += kPairThreads) dst[e] = src[e];
        }
      } else {
        for (int rs = 0; rs < S; ++rs) {
          float* dst = cluster.map_shared_rank(lists_r + s * BK, rs);
          for (int e = ptid; e < BK; e += kPairThreads) dst[e] = topd[e];
        }
      }
      cluster_arrive();
    } else {
      cluster_arrive_relaxed();
    }
    // Scores need no lambda: the first pass's slabs are scored while the
    // round pair waits for the other CTAs (a tile that then skips wasted
    // them).  One warp pair per slab; the scores overwrite their slab.
    if (pair < min(p.stages, nslab)) {
      ring.wait(cseq + pair);
      score_slab<BQ, float>(ring.stage(cseq + pair), qT, dp, ptid, 1 + pair);
    }
    cluster_wait();  // at once for all but the round pair
    bool act = false;
    if (round_pair && lt < BQ) {  // every CTA's top-k of the round's start
      const float kth = kth_of_lists(lists_r + lt * K, S, BK, K);
      const float lam = fminf(kth, t_cap[lt]);
      act = has && lb_c < lam;
      t.lam[lt] = lam;
      t.ukth[lt] = kth;
      t.act[lt] = act;
      t.aip[lt] = fabsf(ip_c);
      if (p.use_cone) {
        const float qn = t.qn[lt];
        const float qc = __fdiv_rn(ip_c, fmaxf(cn_c, 1e-12f));
        t.qcos[lt] = qc;
        t.qsin[lt] = sqrtf(
            fmaxf(__fsub_rn(__fmul_rn(qn, qn), __fmul_rn(qc, qc)), 0.f));
      }
    }
    cp_async_wait_all();  // this round's point tables
    const int any = __syncthreads_or(act);
    if (has && !any) ++nskip;
    // the next round's tables and node terms load while this one finishes
    int leaf_nn, rows_nn;
    entry(r + 2, leaf_nn, rows_nn);
    fetch(r + 1, leaf_n, rows_n, ip_n, lb_n, cn_n);
    // passes of up to `stages` slabs: scored (the first already was), the
    // kept scores inserted, the stages handed back to the loads
    for (int i0 = 0; i0 < nslab; i0 += p.stages) {
      const int np = min(p.stages, nslab - i0);
      if (i0 > 0 && any) {
        if (pair < np) {
          ring.wait(cseq + pair);
          score_slab<BQ, float>(ring.stage(cseq + pair), qT, dp, ptid, 1 + pair);
        }
        __syncthreads();  // every score is written
      }
      if (any) {
        const int o = off + i0 * kSlab;
        const Points pts{s_ids + o, s_rx + o, s_xc + o, s_xs + o,
                         rows_c - i0 * kSlab};
        insert_pass<BQ, 0>(ring, cseq, np, pts, t, p.use_ball, p.use_cone,
                        topd, topi, K, warp, lane);
        __syncthreads();  // and read
      }
      if (tid == kProducer) {
        if (i0 > 0 && !any)  // a skipped tile's later slabs: let them land
          for (int g = 0; g < np; ++g) ring.wait(cseq + g);
        stream.fill(ring, cseq + np + p.stages);
      }
      cseq += np;
    }
    leaf_c = leaf_n, rows_c = rows_n, ip_c = ip_n, lb_c = lb_n, cn_c = cn_n;
    leaf_n = leaf_nn, rows_n = rows_nn;
  }

  __syncthreads();
  if (tid == 0) misc[0] = nskip;
  cluster.sync();  // every top-k is final
  if (s == 0) {
    if (tid < BQ) {  // merge the split sorted top-ks, lower rank first
      const float* ld[8];
      const int* li[8];
      int h[8];
      float v[8];
#pragma unroll
      for (int rs = 0; rs < 8; ++rs) {
        h[rs] = 0;
        ld[rs] = rs < S ? cluster.map_shared_rank(topd, rs) + tid * K : topd;
        li[rs] = rs < S ? cluster.map_shared_rank(topi, rs) + tid * K : topi;
        v[rs] = rs < S ? ld[rs][0] : INFINITY;
      }
      float* od = p.out_d + (size_t)(qb * BQ + tid) * K;
      int* oi = p.out_i + (size_t)(qb * BQ + tid) * K;
      for (int e = 0; e < K; ++e) {
        int b = 0;
        float m = v[0];
#pragma unroll
        for (int rs = 1; rs < 8; ++rs)
          if (v[rs] < m) {
            m = v[rs];
            b = rs;
          }
#pragma unroll
        for (int rs = 0; rs < 8; ++rs)
          if (rs == b) {
            od[e] = m;
            oi[e] = li[rs][h[rs]];
            ++h[rs];
            v[rs] = (rs < S && h[rs] < K) ? ld[rs][h[rs]] : INFINITY;
          }
      }
    }
    if (tid == 0) {
      int total = 0;
      for (int rs = 0; rs < S; ++rs)
        total += cluster.map_shared_rank(misc, rs)[0];
      p.out_s[qb] = total;
    }
  }
  cluster.sync();  // the other CTAs' shared memory outlives rank 0's reads
}

template <int BQ>
cudaLaunchConfig_t config(const Params& p, int nqb, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nqb * p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BQ>
cudaError_t launch(const Params& p, int nqb, cudaStream_t stream) {
  const size_t smem =
      layout(BQ, p.split, p.n0, p.dp, p.k, p.stages).total;
  cudaError_t err = cudaFuncSetAttribute(
      p2h_sweep_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<BQ>(p, nqb, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, p2h_sweep_kernel<BQ>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BQ>
int max_clusters(const Params& p) {
  const size_t smem =
      layout(BQ, p.split, p.n0, p.dp, p.k, p.stages).total;
  if (cudaFuncSetAttribute(p2h_sweep_kernel<BQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<BQ>(p, 1, smem, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)p2h_sweep_kernel<BQ>,
                                     &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
long long p2h_sweep_smem_bytes(int bq, int split, int n0, int dp, int k,
                               int stages) {
  return (long long)layout(bq, split, n0, dp, k, stages).total;
}

// Largest dynamic shared memory a block may opt in to on `device`.
int p2h_sweep_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Clusters of `split` CTAs the current device runs at once at these shapes
// (-1 on error or an unsupported bq).
int p2h_sweep_max_clusters(int bq, int split, int n0, int dp, int k,
                           int stages) {
  Params p{};
  p.n0 = n0, p.dp = dp, p.k = k, p.split = split, p.stages = stages;
  switch (bq) {
    case 1: return max_clusters<1>(p);
    case 2: return max_clusters<2>(p);
    case 4: return max_clusters<4>(p);
    case 8: return max_clusters<8>(p);
    case 16: return max_clusters<16>(p);
    case 32: return max_clusters<32>(p);
    case 64: return max_clusters<64>(p);
    default: return -1;
  }
}

// Launches the sweep on `stream`; returns the launch's CUDA error (0 on
// success).  bq must be 1, 2, 4, 8, 16, 32 or 64; split 1, 2, 4 or 8 (the
// cluster size; another value is refused by the launch); n0 <= 1024; dp a
// multiple of 4; pts 16-byte aligned; stages 2..4.  The caller checks all
// of these and the shared memory.
int p2h_sweep_launch(const void* visit, const void* queries,
                     const void* qnorm, const void* cap, const void* leaf_ip,
                     const void* leaf_lb, const void* leaf_cnorm,
                     const void* pts, const void* ids, const void* rx,
                     const void* xc, const void* xs, const void* vrows,
                     void* out_d, void* out_i, void* out_s, int nqb, int bq,
                     int split, int L, int n0, int dp, int n_visit, int k,
                     int use_ball, int use_cone, int stages, void* stream) {
  if (stages < 2 || stages > kMaxStages) return (int)cudaErrorInvalidValue;
  Params p{(const int*)visit,    (const int*)vrows,     (const float*)queries,
           (const float*)qnorm,  (const float*)cap,     (const float*)leaf_ip,
           (const float*)leaf_lb, (const float*)leaf_cnorm,
           (const float*)pts,    (const int*)ids,       (const float*)rx,
           (const float*)xc,     (const float*)xs,      (float*)out_d,
           (int*)out_i,          (int*)out_s,           L,
           n0,                   dp,                    n_visit,
           k,                    split,                 stages,
           use_ball,             use_cone};
  cudaStream_t s = (cudaStream_t)stream;
  switch (bq) {
    case 1: return (int)launch<1>(p, nqb, s);
    case 2: return (int)launch<2>(p, nqb, s);
    case 4: return (int)launch<4>(p, nqb, s);
    case 8: return (int)launch<8>(p, nqb, s);
    case 16: return (int)launch<16>(p, nqb, s);
    case 32: return (int)launch<32>(p, nqb, s);
    case 64: return (int)launch<64>(p, nqb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
