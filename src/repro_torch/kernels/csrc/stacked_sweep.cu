// Stacked (segment-parallel) P2HNNS leaf sweep for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/stacked_sweep.py:622
// (stacked_sweep_kernel).  It computes what that kernel computes: the tile
// step of p2h_sweep.cu over N stacked segments of one snapshot.  Per block
// of `bq` queries, segment after segment:
//   * the running top-k restarts from the seed planes seed_d/seed_i (cold
//     +inf/-1, or pass A's per-segment state on the two-pass main sweep),
//     and the skip counter restarts at 0;
//   * each visited tile takes lambda = min(k-th of the running top-k,
//     k-th of glob, cap), where glob is the block's in-launch global
//     top-k of values, seeded once from global_seed;
//   * a tile is skipped (and counted) when the node ball bound is >=
//     lambda for every query of the block: pad and dead tiles carry a +inf
//     bound, so they are always skipped, and, having no valid row, are
//     never loaded; otherwise points are masked by the pad id -1, the point
//     ball bound and the point cone bound, scored and inserted into the
//     running top-k;
//   * after the segment's last visited tile its top-k is written out and
//     its values are folded into glob, so later segments prune against a
//     tighter lambda.
// Segments run in order inside a block, as the TPU grid runs them: glob
// threads through them.  Probe modes (template parameter MODE): 0 f32;
// 1 bf16 and 2 int8 points and queries, each score widened by
// |q| * slack_a + sq * slack_b (int8 first dequantised by sq * tile_scale).
//
// What bounds it on an H100: f32 operations.  Cell 2's pass B (8 segments
// of 125,000 points x 129 columns, 1024 queries) needs about 2.6e11 f32
// operations on the valid rows of the tiles it scans: about 3.9 ms at the
// 67 TFLOP/s f32 peak; at bq = 64 the 16 query blocks read the ~1 GB of
// tiles 16 times, ~2.5 ms at 3.35 TB/s.  So operations set the floor.
//
// What the design does about it: the tile engine of p2h_sweep.cu
// (sweep_tile.cuh), with the segment loop around it.
//   1. Query blocks of up to 64 (bq = 64 on the card's main path).
//   2. A query block is one thread block cluster of `split` CTAs.  Inside
//      segment n, in round r CTA s takes visit entry r * split + s and
//      keeps its own sorted top-k; each round every CTA pushes its top-k
//      into every CTA's shared memory (distributed shared memory, by round
//      parity), and lambda = min(cap folded with glob, k-th of the union):
//      what one walker would have after the same tiles, so skips are
//      deterministic.  Segment boundaries are round boundaries: the
//      cluster synchronises, every CTA merges the CTAs' top-ks (lower rank
//      first on ties), rank 0 writes segment n's planes and skip count
//      (summed over the CTAs), every CTA folds the merged values into its
//      copy of glob (kept sorted; the copies stay equal), the cluster
//      synchronises again, and the CTAs restart from segment n + 1's seed
//      planes -- the seed goes to rank 0, the others start cold, so each
//      seed value enters exactly one CTA.
//   3. Loads overlap compute: 64-row slabs by cp.async.bulk on mbarriers
//      through a 2-4 stage ring, only up to a tile's last non-pad row; the
//      point tables and node terms load one round ahead.  The ring's phase
//      count runs on across segments.  A tile whose skip is decided only
//      at its round may have had its first slabs loaded (wasted work,
//      never a wrong answer); a tile without a valid row never is.
//   4. Register-tiled f32 FMA, 8 queries x 8 rows per thread of a warp
//      pair, fmaf over the columns in ascending order: no TF32, no tensor
//      cores.  The bf16 and int8 probe slabs are widened to f32 as they
//      are read, so all three modes run this one engine: a bf16 product is
//      exact in f32, so the column-ordered FMA gives the bits of an f32
//      sum of exact products; int8 values widen to integers, and
//      |sum| <= dp * 127^2 < 2^24, so every partial sum is an exact integer
//      and the f32 sum is the int32 dot, dequantised as
//      float(acc) * (sq * tile_scale).  The slack, the dequantisation and
//      the bounds use round-to-nearest intrinsics (no contraction), like
//      the plain version's separate tensor ops.
//   5. Bounds tested only for the scores that beat the query's k-th, inside
//      the insertion, and for k <= 32 the top-k held in registers while a
//      warp inserts: every segment starts 5 of 6 CTAs cold, and a cold
//      tile inserts dozens of values per query.
//
// ptxas -v (sm_90a, -O3, CUDA 12.8) for the main path's instance, bq = 64,
// f32: 255 registers, no spill stores or loads, no static shared memory
// (bf16: 242, int8: 249, neither spills); __launch_bounds__(256, 1): one
// CTA per SM.  Its dynamic shared memory at cell 2 (dp = 132, k = 10,
// split = 6, 4 stages) is 218,672 bytes of the 232,448 a block may use.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sweep_tile;

struct Params {
  const int* visit;         // (N, nqb, n_visit)
  const int* vrows;         // (N, nqb, n_visit): rows to the last non-pad one
  const void* queries;      // (B, dp) f32 | bf16 | int8
  const float* qnorm;       // (B,)
  const float* sq;          // (B,)  int8 query scale (0 otherwise)
  const float* cap;         // (B,)
  const float* gseed;       // (B, k)
  const float* seed_d;      // (N, B, k)
  const int* seed_i;        // (N, B, k)
  const float* leaf_ip;     // (N, B, L)
  const float* leaf_lb;     // (N, B, L)
  const float* leaf_cnorm;  // (N, L)
  const float* tile_scale;  // (N, L)
  const float* slack_a;     // (N, L)
  const float* slack_b;     // (N, L)
  const void* pts;          // (N, L, n0, dp) f32 | bf16 | int8
  const int* ids;           // (N, L, n0)
  const float* rx;          // (N, L, n0)
  const float* xc;          // (N, L, n0)
  const float* xs;          // (N, L, n0)
  float* out_d;             // (N, B, k)
  int* out_i;               // (N, B, k)
  int* out_s;               // (N, nqb)
  int N, nqb, L, n0, dp, n_visit, k, split, stages;
  int use_ball, use_cone;
};

// Byte offsets of one CTA's dynamic shared memory.
struct Layout {
  size_t bars, misc, terms, ring, qT, lists, topd, topi, glob, ids, rx, xc,
      xs, total;
};

__host__ __device__ inline size_t up16(size_t b) {
  return (b + 15) & ~size_t(15);
}

constexpr int kTerms = 12;  // per-query term slots (floats)

__host__ __device__ inline Layout layout(int bq, int split, int n0, int dp,
                                         int k, int stages, int esize) {
  Layout l;
  size_t o = 0;
  const size_t n0r = (size_t)((n0 + kSlab - 1) / kSlab) * kSlab;
  const size_t bk = (size_t)bq * k;
  l.bars = o, o += up16(kMaxStages * 8);
  l.misc = o, o += 16;  // the segment's skip count
  l.terms = o, o += up16((size_t)kTerms * 4 * bq);
  l.ring = o, o += up16((size_t)stages * stage_bytes(bq, dp, esize));
  l.qT = o, o += up16((size_t)dp * bq * 4);
  // every CTA's top-k of a round's start, by round parity; at a segment's
  // end, scratch for the merge and the glob fold
  l.lists = o, o += up16(2 * (size_t)split * bk * 4);
  l.topd = o, o += up16(bk * 4);
  l.topi = o, o += up16(bk * 4);
  l.glob = o, o += up16(bk * 4);
  l.ids = o, o += up16(2 * n0r * 4);  // the point tables, by round parity
  l.rx = o, o += up16(2 * n0r * 4);
  l.xc = o, o += up16(2 * n0r * 4);
  l.xs = o, o += up16(2 * n0r * 4);
  l.total = o;
  return l;
}

__host__ __device__ inline int elem_size(int mode) {
  return mode == 0 ? 4 : (mode == 1 ? 2 : 1);
}

// Stable insertion sort of K (value, id) pairs, by value (one thread).
__device__ __forceinline__ void sort_pairs(float* d, int* id, int K) {
  for (int a = 1; a < K; ++a) {
    const float v = d[a];
    const int w = id ? id[a] : 0;
    int b = a - 1;
    while (b >= 0 && d[b] > v) {
      d[b + 1] = d[b];
      if (id) id[b + 1] = id[b];
      --b;
    }
    d[b + 1] = v;
    if (id) id[b + 1] = w;
  }
}

template <int BQ, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    stacked_sweep_kernel(Params p) {
  using T = typename Elem<MODE>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.split;
  const int s = (int)cluster.block_rank();
  const int qb = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = p.n0, dp = p.dp, K = p.k, BK = BQ * p.k, L = p.L;
  const int n0r = ((n0 + kSlab - 1) / kSlab) * kSlab;
  const size_t B = (size_t)p.nqb * BQ;
  const size_t row0 = (size_t)qb * BQ;  // the block's first query row
  const Layout l =
      layout(BQ, S, n0, dp, K, p.stages, (int)sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  int* misc = reinterpret_cast<int*>(smem + l.misc);
  float* tf = reinterpret_cast<float*>(smem + l.terms);
  const QueryTerms t{tf,          tf + BQ,     tf + 2 * BQ, tf + 3 * BQ,
                     tf + 4 * BQ, tf + 7 * BQ, tf + 8 * BQ, tf + 9 * BQ,
                     reinterpret_cast<int*>(tf + 6 * BQ)};
  float* t_capg = tf + 5 * BQ;  // cap folded with glob, per segment
  float* t_cap = tf + 10 * BQ;
  float* t_sq = tf + 11 * BQ;
  float* qT = reinterpret_cast<float*>(smem + l.qT);
  float* lists = reinterpret_cast<float*>(smem + l.lists);
  float* topd = reinterpret_cast<float*>(smem + l.topd);
  int* topi = reinterpret_cast<int*>(smem + l.topi);
  float* glob = reinterpret_cast<float*>(smem + l.glob);
  int* s_ids = reinterpret_cast<int*>(smem + l.ids);
  float* s_rx = reinterpret_cast<float*>(smem + l.rx);
  float* s_xc = reinterpret_cast<float*>(smem + l.xc);
  float* s_xs = reinterpret_cast<float*>(smem + l.xs);
  const int rowb = dp * (int)sizeof(T);
  const SlabRing ring{smem + l.ring, bars, p.stages, rowb,
                      stage_bytes(BQ, dp, (int)sizeof(T))};

  const T* qsrc = reinterpret_cast<const T*>(p.queries) + row0 * dp;
  for (int e = tid; e < BQ * dp; e += kThreads) {
    const int qi = e / dp, c = e - qi * dp;
    qT[c * BQ + qi] = widen(qsrc[e]);
  }
  if (tid < BQ) {
    t.qn[tid] = p.qnorm[row0 + tid];
    t_cap[tid] = p.cap[row0 + tid];
    t_sq[tid] = p.sq[row0 + tid];
    float* g = glob + tid * K;
    for (int e = 0; e < K; ++e) g[e] = p.gseed[(row0 + tid) * K + e];
    sort_pairs(g, nullptr, K);
  }
  SlabStream stream;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
  }
  if (tid == kProducer) stream.seq = 0;
  cluster.sync();  // the barriers are set and every CTA of the cluster runs

  const int pair = warp >> 1, ptid = tid & (kPairThreads - 1);
  const bool round_pair = pair == kRoundPair;
  const int lt = tid - kRoundPair * kPairThreads;  // a lambda thread's query
  const unsigned char* pts_all = reinterpret_cast<const unsigned char*>(p.pts);
  int cseq = 0;  // slabs consumed since the launch began

  for (int n = 0; n < p.N; ++n) {
    const size_t seg_b = (size_t)n * B;  // row of (N, B, .) planes
    const size_t tile0 = (size_t)n * L;  // row of (N, L, .) planes
    const size_t vbase = ((size_t)n * p.nqb + qb) * p.n_visit;
    const int* visit = p.visit + vbase;
    const int* vrows = p.vrows + vbase;
    // the segment's start: rank 0 takes its seed planes (sorted, stably),
    // the other CTAs start cold; the cap takes glob's k-th
    if (tid < BQ) {
      float* td = topd + tid * K;
      int* ti = topi + tid * K;
      const size_t o = (seg_b + row0 + tid) * K;
      for (int e = 0; e < K; ++e) {
        td[e] = s == 0 ? p.seed_d[o + e] : INFINITY;
        ti[e] = s == 0 ? p.seed_i[o + e] : -1;
      }
      if (s == 0) sort_pairs(td, ti, K);
      t_capg[tid] = fminf(t_cap[tid], glob[tid * K + K - 1]);
    }
    __syncthreads();
    if (tid == kProducer) {
      stream.begin(visit, vrows, pts_all + tile0 * n0 * rowb, p.n_visit, s,
                   S, n0, rowb);
      stream.fill(ring, cseq + p.stages);
    }

    // What a round needs before its barrier is fetched one round ahead:
    // the visit entry and its rows two rounds ahead, the node terms and the
    // point tables (cp.async into the buffer of the round's parity) one
    // round ahead.
    auto entry = [&](int r, int& leaf, int& rows) {
      const int j = r * S + s;
      leaf = j < p.n_visit ? visit[j] : -1;
      rows = j < p.n_visit ? vrows[j] : 0;
    };
    // node terms of one tile for the lambda thread's query: <q, c>, the
    // node ball bound, |c|, and the probe's tile scale and slack terms
    struct Node {
      float ip, lb, cn, qs, sa, sb;
    };
    auto fetch = [&](int r, int leaf, int rows, Node& nd) {
      if (leaf < 0) return;
      const size_t base = (tile0 + leaf) * n0, off = (size_t)(r & 1) * n0r;
      for (int pt = tid; pt < rows; pt += kThreads) {
        cp_async4(&s_ids[off + pt], p.ids + base + pt);
        if (p.use_ball) cp_async4(&s_rx[off + pt], p.rx + base + pt);
        if (p.use_cone) {
          cp_async4(&s_xc[off + pt], p.xc + base + pt);
          cp_async4(&s_xs[off + pt], p.xs + base + pt);
        }
      }
      if (lt >= 0 && lt < BQ) {
        const size_t o = (seg_b + row0 + lt) * L + leaf;
        nd.ip = p.leaf_ip[o];
        nd.lb = p.leaf_lb[o];
        nd.cn = p.leaf_cnorm[tile0 + leaf];
        if constexpr (MODE != 0) {
          nd.qs = p.tile_scale[tile0 + leaf];
          nd.sa = p.slack_a[tile0 + leaf];
          nd.sb = p.slack_b[tile0 + leaf];
        }
      }
    };
    int leaf_c, rows_c, leaf_n, rows_n;
    Node nd_c{0.f, INFINITY, 1.f, 1.f, 0.f, 0.f}, nd_n = nd_c;
    entry(0, leaf_c, rows_c);
    entry(1, leaf_n, rows_n);
    fetch(0, leaf_c, rows_c, nd_c);

    int nskip = 0;
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
      // round pair waits for the other CTAs.
      if (pair < min(p.stages, nslab)) {
        ring.wait(cseq + pair);
        score_slab<BQ, T>(ring.stage(cseq + pair), qT, dp, ptid, 1 + pair);
      }
      cluster_wait();
      bool act = false;
      if (round_pair && lt < BQ) {  // every CTA's top-k of the round's start
        const float kth = kth_of_lists(lists_r + lt * K, S, BK, K);
        const float lam = fminf(kth, t_capg[lt]);
        const float qn = t.qn[lt];
        act = has && nd_c.lb < lam;
        t.lam[lt] = lam;
        t.ukth[lt] = kth;
        t.act[lt] = act;
        t.aip[lt] = fabsf(nd_c.ip);
        if (p.use_cone) {
          const float qc = __fdiv_rn(nd_c.ip, fmaxf(nd_c.cn, 1e-12f));
          t.qcos[lt] = qc;
          t.qsin[lt] = sqrtf(
              fmaxf(__fsub_rn(__fmul_rn(qn, qn), __fmul_rn(qc, qc)), 0.f));
        }
        if constexpr (MODE != 0) {
          const float sq = t_sq[lt];
          t.scale[lt] = __fmul_rn(sq, nd_c.qs);
          t.err[lt] = __fadd_rn(__fmul_rn(qn, nd_c.sa), __fmul_rn(sq, nd_c.sb));
        }
      }
      cp_async_wait_all();  // this round's point tables
      const int any = __syncthreads_or(act);
      if (has && !any) ++nskip;
      // the next round's tables and node terms load while this one finishes
      int leaf_nn, rows_nn;
      entry(r + 2, leaf_nn, rows_nn);
      fetch(r + 1, leaf_n, rows_n, nd_n);
      for (int i0 = 0; i0 < nslab; i0 += p.stages) {
        const int np = min(p.stages, nslab - i0);
        if (i0 > 0 && any) {
          if (pair < np) {
            ring.wait(cseq + pair);
            score_slab<BQ, T>(ring.stage(cseq + pair), qT, dp, ptid,
                              1 + pair);
          }
          __syncthreads();  // every score is written
        }
        if (any) {
          const int o = off + i0 * kSlab;
          const Points pts{s_ids + o, s_rx + o, s_xc + o, s_xs + o,
                           rows_c - i0 * kSlab};
          insert_pass<BQ, MODE>(ring, cseq, np, pts, t, p.use_ball,
                                p.use_cone, topd, topi, K, warp, lane);
          __syncthreads();  // and read
        }
        if (tid == kProducer) {
          if (i0 > 0 && !any)  // a skipped tile's later slabs: let them land
            for (int g = 0; g < np; ++g) ring.wait(cseq + g);
          stream.fill(ring, cseq + np + p.stages);
        }
        cseq += np;
      }
      leaf_c = leaf_n, rows_c = rows_n, nd_c = nd_n;
      leaf_n = leaf_nn, rows_n = rows_nn;
    }

    // The segment's end: merge the CTAs' top-ks, write the planes, fold
    // the merged values into glob.
    __syncthreads();
    if (tid == 0) misc[0] = nskip;
    cluster.sync();  // every top-k of the segment is final
    if (tid < BQ) {
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
      float* mrg = lists + tid * K;         // the merged values
      float* fold = lists + BK + tid * K;   // glob's next values
      float* od = p.out_d + (seg_b + row0 + tid) * K;
      int* oi = p.out_i + (seg_b + row0 + tid) * K;
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
            if (s == 0) {
              od[e] = m;
              oi[e] = li[rs][h[rs]];
            }
            mrg[e] = m;
            ++h[rs];
            v[rs] = (rs < S && h[rs] < K) ? ld[rs][h[rs]] : INFINITY;
          }
      }
      // glob <- the K smallest of glob and the merged values, sorted
      float* g = glob + tid * K;
      for (int e = 0, a = 0, b = 0; e < K; ++e)  // a + b = e < K
        fold[e] = g[a] <= mrg[b] ? g[a++] : mrg[b++];
      for (int e = 0; e < K; ++e) g[e] = fold[e];
    }
    if (s == 0 && tid == 0) {
      int total = 0;
      for (int rs = 0; rs < S; ++rs)
        total += cluster.map_shared_rank(misc, rs)[0];
      p.out_s[(size_t)n * p.nqb + qb] = total;
    }
    cluster.sync();  // the remote reads are done before the next segment
  }
}

template <int BQ, int MODE>
cudaLaunchConfig_t config(const Params& p, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nqb * p.split);
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

template <int BQ, int MODE>
size_t smem_of(const Params& p) {
  return layout(BQ, p.split, p.n0, p.dp, p.k, p.stages, elem_size(MODE))
      .total;
}

template <int BQ, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_of<BQ, MODE>(p);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_sweep_kernel<BQ, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<BQ, MODE>(p, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, stacked_sweep_kernel<BQ, MODE>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BQ, int MODE>
int max_clusters(const Params& p) {
  const size_t smem = smem_of<BQ, MODE>(p);
  if (cudaFuncSetAttribute(stacked_sweep_kernel<BQ, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  Params one = p;
  one.nqb = 1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<BQ, MODE>(one, smem, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, (void*)stacked_sweep_kernel<BQ, MODE>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// Dispatch `fn<BQ, MODE>` on the runtime block size and mode; `bad` for an
// unsupported pair.
#define STACKED_DISPATCH(fn, bad, ...)                        \
  switch (mode * 100 + bq) {                                  \
    case 1: return fn<1, 0>(__VA_ARGS__);                     \
    case 2: return fn<2, 0>(__VA_ARGS__);                     \
    case 4: return fn<4, 0>(__VA_ARGS__);                     \
    case 8: return fn<8, 0>(__VA_ARGS__);                     \
    case 16: return fn<16, 0>(__VA_ARGS__);                   \
    case 32: return fn<32, 0>(__VA_ARGS__);                   \
    case 64: return fn<64, 0>(__VA_ARGS__);                   \
    case 101: return fn<1, 1>(__VA_ARGS__);                   \
    case 102: return fn<2, 1>(__VA_ARGS__);                   \
    case 104: return fn<4, 1>(__VA_ARGS__);                   \
    case 108: return fn<8, 1>(__VA_ARGS__);                   \
    case 116: return fn<16, 1>(__VA_ARGS__);                  \
    case 132: return fn<32, 1>(__VA_ARGS__);                  \
    case 164: return fn<64, 1>(__VA_ARGS__);                  \
    case 201: return fn<1, 2>(__VA_ARGS__);                   \
    case 202: return fn<2, 2>(__VA_ARGS__);                   \
    case 204: return fn<4, 2>(__VA_ARGS__);                   \
    case 208: return fn<8, 2>(__VA_ARGS__);                   \
    case 216: return fn<16, 2>(__VA_ARGS__);                  \
    case 232: return fn<32, 2>(__VA_ARGS__);                  \
    case 264: return fn<64, 2>(__VA_ARGS__);                  \
    default: return bad;                                      \
  }

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes (mode: 0 f32, 1 bf16,
// 2 int8).
long long stacked_sweep_smem_bytes(int mode, int bq, int split, int n0,
                                   int dp, int k, int stages) {
  return (long long)layout(bq, split, n0, dp, k, stages, elem_size(mode))
      .total;
}

// Largest dynamic shared memory a block may opt in to on `device`.
int stacked_sweep_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Clusters of `split` CTAs the current device runs at once at these shapes
// (-1 on error or an unsupported bq or mode).
int stacked_sweep_max_clusters(int mode, int bq, int split, int n0, int dp,
                               int k, int stages) {
  Params p{};
  p.n0 = n0, p.dp = dp, p.k = k, p.split = split, p.stages = stages;
  p.nqb = 1;
  STACKED_DISPATCH(max_clusters, -1, p)
}

// Launches the stacked sweep on `stream`; returns the launch's CUDA error
// (0 on success).  mode: 0 f32, 1 bf16, 2 int8.  bq must be 1, 2, 4, 8, 16,
// 32 or 64; split 1..8 (the cluster size; another value is refused by the
// launch); n0 <= 1024; dp * element size a multiple of 16; pts 16-byte
// aligned; stages 2..4.  The caller checks all of these and the shared
// memory.
int stacked_sweep_launch(
    const void* visit, const void* vrows, const void* queries,
    const void* qnorm, const void* sq, const void* cap, const void* gseed,
    const void* seed_d, const void* seed_i, const void* leaf_ip,
    const void* leaf_lb, const void* leaf_cnorm, const void* tile_scale,
    const void* slack_a, const void* slack_b, const void* pts,
    const void* ids, const void* rx, const void* xc, const void* xs,
    void* out_d, void* out_i, void* out_s, int mode, int N, int nqb, int bq,
    int split, int L, int n0, int dp, int n_visit, int k, int use_ball,
    int use_cone, int stages, void* stream) {
  if (stages < 2 || stages > kMaxStages) return (int)cudaErrorInvalidValue;
  Params p{(const int*)visit,        (const int*)vrows,
           queries,                  (const float*)qnorm,
           (const float*)sq,         (const float*)cap,
           (const float*)gseed,      (const float*)seed_d,
           (const int*)seed_i,       (const float*)leaf_ip,
           (const float*)leaf_lb,    (const float*)leaf_cnorm,
           (const float*)tile_scale, (const float*)slack_a,
           (const float*)slack_b,    pts,
           (const int*)ids,          (const float*)rx,
           (const float*)xc,         (const float*)xs,
           (float*)out_d,            (int*)out_i,
           (int*)out_s,              N,
           nqb,                      L,
           n0,                       dp,
           n_visit,                  k,
           split,                    stages,
           use_ball,                 use_cone};
  cudaStream_t s = (cudaStream_t)stream;
  STACKED_DISPATCH(launch, (int)cudaErrorInvalidValue, p, s)
}

}  // extern "C"
