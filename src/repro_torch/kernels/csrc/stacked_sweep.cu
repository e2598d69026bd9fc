// Stacked (segment-parallel) P2HNNS leaf sweep for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel repro/kernels/stacked_sweep.py::
// stacked_sweep_kernel.  It computes what that kernel computes: the tile
// step of p2h_sweep.cu with a leading segment axis over N stacked segments
// of one snapshot.  Per block of `bq` queries, segment after segment:
//   * the running top-k restarts from the seed planes seed_d/seed_i (cold
//     +inf/-1, or pass A's per-segment state on the two-pass main sweep),
//     and the skip counter restarts at 0;
//   * each visited tile takes lambda = min(max of the running top-k,
//     max of glob, cap), where glob is the block's in-launch global top-k
//     of values, seeded once from global_seed;
//   * a tile is skipped (and counted) when the node ball bound is >=
//     lambda for every query of the block: pad and dead tiles carry a +inf
//     bound, so they are always skipped and never read; otherwise points
//     are masked by the pad id -1, the point ball bound and the point cone
//     bound, scored and inserted into the unsorted running top-k;
//   * after the segment's last visited tile its top-k is written out and
//     its values are folded into glob (k argmin/argmax passes, ties to the
//     lowest index), so later segments prune against a tighter lambda.
// Segments run in order inside a block, as the TPU grid runs them: glob
// threads through them, and the skip counts equal the TPU kernel's.
//
// Probe modes (template parameter MODE):
//   0 f32   scores are f32 FMA dot products, as in p2h_sweep.cu;
//   1 bf16  bf16 points and queries, widened to f32 (each product is exact
//           in f32) and summed with f32 FMA;
//   2 int8  int8 points and queries, summed exactly in int32 (__dp4a) and
//           dequantised as float(acc) * (sq * tile_scale).
// Both low-precision modes widen each score by qnorm*slack_a + sq*slack_b,
// inside a live tile only, so a degenerate scale of a pad tile never
// reaches a score.  Low-precision points are read at their own width: one
// 8-byte load per 4 bf16 values, one 4-byte load per 4 int8 values.
//
// What bounds it on an H100.  A scanned tile is n0 x dp values read for
// bq = 8 queries (f32: 4 flop per byte), far under the card's f32 rate per
// byte of device memory, and lambda tightens tile by tile and segment by
// segment, so the walk inside a block is sequential: the kernel is bound by
// the latency of each tile's dependent steps, as p2h_sweep.cu is.
//
// What the design does about it: one thread block per query block
// (grid = nqb), one thread per tile point; a skipped tile is never loaded
// (the any-query-active test comes before any tile byte is read); only the
// prefix of rows some query keeps is staged (rows are sorted by descending
// rx); rows are staged in 32-column chunks with vector loads.  Exactness:
// no TF32 and no tensor cores; bound and slack arithmetic uses
// round-to-nearest intrinsics (no FMA contraction), like the plain
// version's separate tensor ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tile columns staged in shared memory at a time
constexpr int kPitch = kChunk + 1;          // f32 staging row pitch (floats)
constexpr int kPitchI = kChunk / 4 + 1;     // int8 staging row pitch (ints)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* visit;         // (N, nqb, n_visit)
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
  int N, nqb, L, n0, dp, n_visit, k;
  int use_ball, use_cone;
};

__host__ __device__ inline size_t smem_floats(int bq, int n0, int dp, int k) {
  // queries | staged rows | candidates | top-k dists | top-k ids | glob |
  // fold scratch
  return (size_t)bq * dp + (size_t)n0 * kPitch + (size_t)bq * n0 +
         4 * (size_t)bq * k;
}

__device__ __forceinline__ float cone_cases(float qc, float qs, float xc,
                                            float xs) {
  const float a = __fsub_rn(__fmul_rn(qc, xc), __fmul_rn(qs, xs));
  const float b = __fadd_rn(__fmul_rn(qc, xc), __fmul_rn(qs, xs));
  return (a > 0.f && qc > 0.f && xc > 0.f) ? a : (b < 0.f ? -b : 0.f);
}

// Warp-wide (min, lowest index) over v[0..n) and (max, lowest index) over
// w[0..m); every lane gets the results.
__device__ __forceinline__ void warp_argmin_argmax(const float* v, int n,
                                                   const float* w, int m,
                                                   int lane, float& mn,
                                                   int& amn, float& mx,
                                                   int& amx) {
  mn = INFINITY;
  amn = INT32_MAX;
  for (int e = lane; e < n; e += 32) {
    const float x = v[e];
    if (x < mn) { mn = x; amn = e; }
  }
  mx = -INFINITY;
  amx = INT32_MAX;
  for (int e = lane; e < m; e += 32) {
    const float x = w[e];
    if (x > mx) { mx = x; amx = e; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(kFull, mn, off);
    const int oa = __shfl_xor_sync(kFull, amn, off);
    if (om < mn || (om == mn && oa < amn)) { mn = om; amn = oa; }
    const float ow = __shfl_xor_sync(kFull, mx, off);
    const int ob = __shfl_xor_sync(kFull, amx, off);
    if (ow > mx || (ow == mx && ob < amx)) { mx = ow; amx = ob; }
  }
}

template <int BQ, int MODE>
__global__ void __launch_bounds__(1024) stacked_sweep_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                          // BQ * dp (MODE 2: packed)
  float* s_x = s_q + BQ * p.dp;               // n0 * kPitch
  float* s_cand = s_x + p.n0 * kPitch;        // BQ * n0
  float* s_topd = s_cand + BQ * p.n0;         // BQ * k
  int* s_topi = (int*)(s_topd + BQ * p.k);    // BQ * k
  float* s_glob = (float*)(s_topi + BQ * p.k);  // BQ * k
  float* s_fold = s_glob + BQ * p.k;          // BQ * k
  int* s_qi = (int*)s_q;                      // int8 queries, 4 per int
  int* s_xi = (int*)s_x;                      // int8 rows, 4 per int
  __shared__ float s_qn[BQ], s_sq[BQ], s_cap[BQ], s_capg[BQ], s_lam[BQ],
      s_ip[BQ];
  __shared__ int s_active[BQ];
  __shared__ int s_nlive;

  const int qb = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n0 = p.n0, dp = p.dp, k = p.k, L = p.L;
  const int dp4 = dp >> 2;
  const size_t B = (size_t)p.nqb * BQ;
  const size_t row0 = (size_t)qb * BQ;  // the block's first query row
  const float inf = INFINITY;

  if (MODE == 0) {
    const float* q = (const float*)p.queries + row0 * dp;
    for (int e = tid; e < BQ * dp; e += blockDim.x) s_q[e] = q[e];
  } else if (MODE == 1) {
    const __nv_bfloat16* q = (const __nv_bfloat16*)p.queries + row0 * dp;
    for (int e = tid; e < BQ * dp; e += blockDim.x)
      s_q[e] = __bfloat162float(q[e]);
  } else {
    const int* q = (const int*)((const int8_t*)p.queries + row0 * dp);
    for (int e = tid; e < BQ * dp4; e += blockDim.x) s_qi[e] = q[e];
  }
  for (int e = tid; e < BQ * k; e += blockDim.x)
    s_glob[e] = p.gseed[row0 * k + e];
  if (tid < BQ) {
    s_qn[tid] = p.qnorm[row0 + tid];
    s_sq[tid] = p.sq[row0 + tid];
    s_cap[tid] = p.cap[row0 + tid];
  }
  __syncthreads();

  for (int s = 0; s < p.N; ++s) {
    const size_t brow = (size_t)s * B + row0;  // row of (N, B, .) planes
    for (int e = tid; e < BQ * k; e += blockDim.x) {
      s_topd[e] = p.seed_d[brow * k + e];
      s_topi[e] = p.seed_i[brow * k + e];
    }
    // glob changes only between segments: fold it into the cap once
    for (int qi = warp; qi < BQ; qi += nwarps) {
      float m = -inf;
      for (int e = lane; e < k; e += 32) m = fmaxf(m, s_glob[qi * k + e]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      if (lane == 0) s_capg[qi] = fminf(s_cap[qi], m);
    }
    int nskip = 0;
    __syncthreads();

    const int* visit = p.visit + ((size_t)s * p.nqb + qb) * p.n_visit;
    for (int j = 0; j < p.n_visit; ++j) {
      const int leaf = visit[j];
      const size_t tl = (size_t)s * L + leaf;  // tile of (N, L, .) planes
      // (a) lambda and the node ball bound test, one warp per query
      for (int qi = warp; qi < BQ; qi += nwarps) {
        float m = -inf;
        for (int e = lane; e < k; e += 32) m = fmaxf(m, s_topd[qi * k + e]);
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        if (lane == 0) {
          const float lam = fminf(m, s_capg[qi]);
          const size_t r = (brow + qi) * L + leaf;
          s_lam[qi] = lam;
          s_ip[qi] = p.leaf_ip[r];
          s_active[qi] = p.leaf_lb[r] < lam;
        }
      }
      if (tid == 0) s_nlive = 0;
      __syncthreads();
      if (!__syncthreads_or(tid < BQ ? s_active[tid] : 0)) {
        ++nskip;  // no tile byte is read for a skipped tile
        continue;
      }

      // (b) point masks: bit qi of keep = point kept for query qi
      const int pt = tid;
      unsigned keep = 0;
      if (pt < n0) {
        const size_t t = tl * n0 + pt;
        if (p.ids[t] >= 0) {
          const float prx = p.use_ball ? p.rx[t] : 0.f;
          const float pxc = p.use_cone ? p.xc[t] : 0.f;
          const float pxs = p.use_cone ? p.xs[t] : 0.f;
          const float cn = fmaxf(p.leaf_cnorm[tl], 1e-12f);
#pragma unroll
          for (int qi = 0; qi < BQ; ++qi) {
            if (!s_active[qi]) continue;
            const float lam = s_lam[qi], ip = s_ip[qi], qn = s_qn[qi];
            bool ok = true;
            if (p.use_ball) {
              const float pb =
                  fmaxf(__fsub_rn(fabsf(ip), __fmul_rn(qn, prx)), 0.f);
              ok = pb < lam;
            }
            if (ok && p.use_cone) {
              const float qcos = __fdiv_rn(ip, cn);
              const float qsin = sqrtf(fmaxf(
                  __fsub_rn(__fmul_rn(qn, qn), __fmul_rn(qcos, qcos)), 0.f));
              ok = cone_cases(qcos, qsin, pxc, pxs) < lam;
            }
            if (ok) keep |= 1u << qi;
          }
        }
        if (keep) atomicMax(&s_nlive, pt + 1);
      }
      __syncthreads();
      const int nlive = s_nlive;
      if (nlive == 0) {  // every point of the tile is pruned for every query
        __syncthreads();  // all have read s_nlive before (a) resets it
        continue;
      }

      // (c) scores over the live prefix, staged in kChunk-column chunks
      float acc[BQ];
      int acci[BQ];
#pragma unroll
      for (int qi = 0; qi < BQ; ++qi) {
        acc[qi] = 0.f;
        acci[qi] = 0;
      }
      const size_t tile0 = tl * n0 * dp;  // first element of the tile
      for (int c0 = 0; c0 < dp; c0 += kChunk) {
        const int vpr = min(kChunk, dp - c0) >> 2;  // 4-value vectors a row
        for (int e = tid; e < nlive * vpr; e += blockDim.x) {
          const int r = e / vpr, v = e - r * vpr;
          const size_t at = tile0 + (size_t)r * dp + c0 + 4 * v;
          if (MODE == 0) {
            const float4 x4 =
                *reinterpret_cast<const float4*>((const float*)p.pts + at);
            float* dst = s_x + r * kPitch + 4 * v;
            dst[0] = x4.x;
            dst[1] = x4.y;
            dst[2] = x4.z;
            dst[3] = x4.w;
          } else if (MODE == 1) {
            const uint2 raw = *reinterpret_cast<const uint2*>(
                (const __nv_bfloat16*)p.pts + at);
            const __nv_bfloat162 lo =
                *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
            const __nv_bfloat162 hi =
                *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
            float* dst = s_x + r * kPitch + 4 * v;
            dst[0] = __low2float(lo);
            dst[1] = __high2float(lo);
            dst[2] = __low2float(hi);
            dst[3] = __high2float(hi);
          } else {
            s_xi[r * kPitchI + v] =
                *reinterpret_cast<const int*>((const int8_t*)p.pts + at);
          }
        }
        __syncthreads();
        if (keep) {
          if (MODE == 2) {
            const int* xr = s_xi + pt * kPitchI;
            const int* qc = s_qi + (c0 >> 2);
            for (int v = 0; v < vpr; ++v) {
              const int xv = xr[v];
#pragma unroll
              for (int qi = 0; qi < BQ; ++qi)
                acci[qi] = __dp4a(xv, qc[qi * dp4 + v], acci[qi]);
            }
          } else {
            const float* xr = s_x + pt * kPitch;
            const float* qc = s_q + c0;
            const int cw = vpr * 4;
            for (int c = 0; c < cw; ++c) {
              const float xv = xr[c];
#pragma unroll
              for (int qi = 0; qi < BQ; ++qi)
                acc[qi] = fmaf(qc[qi * dp + c], xv, acc[qi]);
            }
          }
        }
        __syncthreads();
      }

      // (d) candidates: +inf where a query does not keep the point;
      // low-precision scores are dequantised and widened by the slack
      if (pt < n0) {
        float qs = 1.f, sa = 0.f, sb = 0.f;
        if (MODE != 0) {
          qs = p.tile_scale[tl];
          sa = p.slack_a[tl];
          sb = p.slack_b[tl];
        }
#pragma unroll
        for (int qi = 0; qi < BQ; ++qi) {
          float v = inf;
          if ((keep >> qi) & 1u) {
            if (MODE == 0) {
              v = fabsf(acc[qi]);
            } else {
              const float raw =
                  MODE == 1 ? acc[qi]
                            : __fmul_rn(__int2float_rn(acci[qi]),
                                        __fmul_rn(s_sq[qi], qs));
              const float err = __fadd_rn(__fmul_rn(s_qn[qi], sa),
                                          __fmul_rn(s_sq[qi], sb));
              v = __fadd_rn(fabsf(raw), err);
            }
          }
          s_cand[qi * n0 + pt] = v;
        }
      }
      __syncthreads();

      // (e) k argmin-insert passes into the unsorted top-k, one warp per
      // query; they stop at the first pass that inserts nothing, since
      // every later pass would insert nothing too
      for (int qi = warp; qi < BQ; qi += nwarps) {
        if (!s_active[qi]) continue;  // every candidate is +inf
        float* cd = s_cand + qi * n0;
        float* td = s_topd + qi * k;
        int* ti = s_topi + qi * k;
        for (int pass = 0; pass < k; ++pass) {
          float m, wv;
          int am, wa;
          warp_argmin_argmax(cd, n0, td, k, lane, m, am, wv, wa);
          if (!(m < wv)) break;  // warp-uniform
          if (lane == 0) {
            td[wa] = m;
            ti[wa] = p.ids[tl * n0 + am];
            cd[am] = inf;
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }

    // the segment's outputs, then its top-k values folded into glob
    for (int e = tid; e < BQ * k; e += blockDim.x) {
      p.out_d[brow * k + e] = s_topd[e];
      p.out_i[brow * k + e] = s_topi[e];
      s_fold[e] = s_topd[e];
    }
    if (tid == 0) p.out_s[(size_t)s * p.nqb + qb] = nskip;
    __syncthreads();
    for (int qi = warp; qi < BQ; qi += nwarps) {
      float* cd = s_fold + qi * k;
      float* g = s_glob + qi * k;
      for (int pass = 0; pass < k; ++pass) {
        float m, wv;
        int am, wa;
        warp_argmin_argmax(cd, k, g, k, lane, m, am, wv, wa);
        if (!(m < wv)) break;  // warp-uniform
        if (lane == 0) {
          g[wa] = m;
          cd[am] = inf;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

template <int BQ, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int threads = ((p.n0 + 31) / 32) * 32;
  const size_t smem = smem_floats(BQ, p.n0, p.dp, p.k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_sweep_kernel<BQ, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stacked_sweep_kernel<BQ, MODE><<<p.nqb, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_bq(const Params& p, int bq, cudaStream_t s) {
  switch (bq) {
    case 1: return launch<1, MODE>(p, s);
    case 2: return launch<2, MODE>(p, s);
    case 4: return launch<4, MODE>(p, s);
    case 8: return launch<8, MODE>(p, s);
    case 16: return launch<16, MODE>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long stacked_sweep_smem_bytes(int bq, int n0, int dp, int k) {
  return (long long)(smem_floats(bq, n0, dp, k) * sizeof(float));
}

// Largest dynamic shared memory a block may opt in to on `device`.
int stacked_sweep_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Launches the stacked sweep on `stream`; returns cudaGetLastError() after
// the launch (0 on success).  mode: 0 f32, 1 bf16, 2 int8.  bq must be 1,
// 2, 4, 8 or 16; n0 <= 1024; dp a multiple of 4; pts 16-byte aligned.  The
// caller checks all of these.
int stacked_sweep_launch(
    const void* visit, const void* queries, const void* qnorm,
    const void* sq, const void* cap, const void* gseed, const void* seed_d,
    const void* seed_i, const void* leaf_ip, const void* leaf_lb,
    const void* leaf_cnorm, const void* tile_scale, const void* slack_a,
    const void* slack_b, const void* pts, const void* ids, const void* rx,
    const void* xc, const void* xs, void* out_d, void* out_i, void* out_s,
    int mode, int N, int nqb, int bq, int L, int n0, int dp, int n_visit,
    int k, int use_ball, int use_cone, void* stream) {
  Params p{(const int*)visit,       queries,
           (const float*)qnorm,     (const float*)sq,
           (const float*)cap,       (const float*)gseed,
           (const float*)seed_d,    (const int*)seed_i,
           (const float*)leaf_ip,   (const float*)leaf_lb,
           (const float*)leaf_cnorm, (const float*)tile_scale,
           (const float*)slack_a,   (const float*)slack_b,
           pts,                     (const int*)ids,
           (const float*)rx,        (const float*)xc,
           (const float*)xs,        (float*)out_d,
           (int*)out_i,             (int*)out_s,
           N, nqb, L, n0, dp, n_visit, k, use_ball, use_cone};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return (int)launch_bq<0>(p, bq, s);
    case 1: return (int)launch_bq<1>(p, bq, s);
    case 2: return (int)launch_bq<2>(p, bq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
