// Fused P2HNNS leaf sweep for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/p2h_scan.py::p2h_sweep_kernel.  It
// computes what that kernel computes, per block of `bq` queries: walk the
// leaf tiles in the block's preference order `visit`; for each tile take
// lambda = min(max of the running top-k, cap) per query; skip the tile (and
// count the skip) when the node ball bound (Theorem 2) is >= lambda for
// every query of the block; otherwise mask points by the pad id -1, the
// point ball bound (Corollary 1) and the point cone bound (Theorem 3),
// score |<q, x>| in f32 and make k argmin-insert passes into the unsorted
// running top-k.
//
// What bounds it on an H100.  Each scanned tile is n0 x dp f32 values read
// for bq = 8 queries: 2*bq flops per 4 bytes, about 4 flop per byte, far
// under the card's ~20 f32 flop per byte of device memory, so re-reading
// tiles is memory-bound.  The tile walk is also sequential inside a block,
// because lambda tightens tile by tile.
//
// What the design does about it.
//   * One thread block per query block (grid = nqb); the TPU's sequential
//     tile grid axis is a loop inside the block.  One thread per tile point.
//   * A skipped tile is not loaded at all: the any-query-active test
//     (__syncthreads_or) comes before any tile byte is read.  The TPU
//     kernel still DMAs it.
//   * Inside a live tile, points are sorted by descending rx, so the point
//     ball bound keeps a prefix of the tile; only the rows up to the last
//     point some query keeps are staged, and pad rows (id -1) are never
//     scored.
//   * Rows are staged through shared memory in 32-column chunks with
//     16-byte loads, neighbouring threads on neighbouring addresses; the
//     scoring reads the chunk with a 33-float row pitch (no bank
//     conflicts) and broadcasts the query values.
//   * Scores are plain f32 FMA dot products: no TF32, no tensor cores, so
//     every distance is a full-precision f32 value.  Bound arithmetic uses
//     round-to-nearest intrinsics (no FMA contraction), like the plain
//     version's separate tensor ops.
//   * Top-k insertion: one warp per query; argmin over the candidates and
//     argmax over the running top-k take the lowest index on ties (as
//     jnp.argmin/argmax do); the passes stop at the first one that inserts
//     nothing, since every later pass would insert nothing too.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tile columns staged in shared memory at a time
constexpr int kPitch = kChunk + 1;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* visit;         // (nqb, n_visit)
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
  int L, n0, dp, n_visit, k;
  int use_ball, use_cone;
};

__host__ __device__ inline size_t smem_floats(int bq, int n0, int dp, int k) {
  // queries | staged rows | candidates | top-k dists | top-k ids
  return (size_t)bq * dp + (size_t)n0 * kPitch + (size_t)bq * n0 +
         2 * (size_t)bq * k;
}

__device__ __forceinline__ float cone_cases(float qc, float qs, float xc,
                                            float xs) {
  const float a = __fsub_rn(__fmul_rn(qc, xc), __fmul_rn(qs, xs));
  const float b = __fadd_rn(__fmul_rn(qc, xc), __fmul_rn(qs, xs));
  return (a > 0.f && qc > 0.f && xc > 0.f) ? a : (b < 0.f ? -b : 0.f);
}

template <int BQ>
__global__ void __launch_bounds__(1024) p2h_sweep_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                          // BQ * dp
  float* s_x = s_q + BQ * p.dp;               // n0 * kPitch
  float* s_cand = s_x + p.n0 * kPitch;        // BQ * n0
  float* s_topd = s_cand + BQ * p.n0;         // BQ * k
  int* s_topi = (int*)(s_topd + BQ * p.k);    // BQ * k
  __shared__ float s_qn[BQ], s_cap[BQ], s_lam[BQ], s_ip[BQ];
  __shared__ int s_active[BQ];
  __shared__ int s_nlive;

  const int qb = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n0 = p.n0, dp = p.dp, k = p.k;
  const float inf = INFINITY;

  for (int e = tid; e < BQ * dp; e += blockDim.x)
    s_q[e] = p.queries[(size_t)qb * BQ * dp + e];
  for (int e = tid; e < BQ * k; e += blockDim.x) {
    s_topd[e] = inf;
    s_topi[e] = -1;
  }
  if (tid < BQ) {
    s_qn[tid] = p.qnorm[qb * BQ + tid];
    s_cap[tid] = p.cap[qb * BQ + tid];
  }
  int nskip = 0;
  __syncthreads();

  for (int j = 0; j < p.n_visit; ++j) {
    const int leaf = p.visit[(size_t)qb * p.n_visit + j];
    // (a) lambda and the node ball bound test, one warp per query
    for (int qi = warp; qi < BQ; qi += nwarps) {
      float m = -inf;
      for (int e = lane; e < k; e += 32) m = fmaxf(m, s_topd[qi * k + e]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      if (lane == 0) {
        const float lam = fminf(m, s_cap[qi]);
        const size_t r = (size_t)(qb * BQ + qi) * p.L + leaf;
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
      const size_t t = (size_t)leaf * n0 + pt;
      if (p.ids[t] >= 0) {
        const float prx = p.use_ball ? p.rx[t] : 0.f;
        const float pxc = p.use_cone ? p.xc[t] : 0.f;
        const float pxs = p.use_cone ? p.xs[t] : 0.f;
        const float cn = fmaxf(p.leaf_cnorm[leaf], 1e-12f);
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
#pragma unroll
    for (int qi = 0; qi < BQ; ++qi) acc[qi] = 0.f;
    const float* tile = p.pts + (size_t)leaf * n0 * dp;
    for (int c0 = 0; c0 < dp; c0 += kChunk) {
      const int vpr = min(kChunk, dp - c0) >> 2;  // float4 per row
      for (int e = tid; e < nlive * vpr; e += blockDim.x) {
        const int r = e / vpr, v = e - r * vpr;
        const float4 x4 = *reinterpret_cast<const float4*>(
            tile + (size_t)r * dp + c0 + 4 * v);
        float* dst = s_x + r * kPitch + 4 * v;
        dst[0] = x4.x;
        dst[1] = x4.y;
        dst[2] = x4.z;
        dst[3] = x4.w;
      }
      __syncthreads();
      if (keep) {
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
      __syncthreads();
    }

    // (d) candidates: +inf where a query does not keep the point
    if (pt < n0) {
#pragma unroll
      for (int qi = 0; qi < BQ; ++qi)
        s_cand[qi * n0 + pt] = (keep >> qi) & 1u ? fabsf(acc[qi]) : inf;
    }
    __syncthreads();

    // (e) k argmin-insert passes into the unsorted top-k, one warp per query
    for (int qi = warp; qi < BQ; qi += nwarps) {
      if (!s_active[qi]) continue;  // every candidate is +inf
      float* cd = s_cand + qi * n0;
      float* td = s_topd + qi * k;
      int* ti = s_topi + qi * k;
      for (int pass = 0; pass < k; ++pass) {
        float m = inf;
        int am = INT32_MAX;
        for (int e = lane; e < n0; e += 32) {
          const float v = cd[e];
          if (v < m) { m = v; am = e; }
        }
        float wv = -inf;
        int wa = INT32_MAX;
        for (int e = lane; e < k; e += 32) {
          const float v = td[e];
          if (v > wv) { wv = v; wa = e; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float om = __shfl_xor_sync(kFull, m, off);
          const int oa = __shfl_xor_sync(kFull, am, off);
          if (om < m || (om == m && oa < am)) { m = om; am = oa; }
          const float ow = __shfl_xor_sync(kFull, wv, off);
          const int ob = __shfl_xor_sync(kFull, wa, off);
          if (ow > wv || (ow == wv && ob < wa)) { wv = ow; wa = ob; }
        }
        if (!(m < wv)) break;  // warp-uniform: no later pass inserts either
        if (lane == 0) {
          td[wa] = m;
          ti[wa] = p.ids[(size_t)leaf * n0 + am];
          cd[am] = inf;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * k; e += blockDim.x) {
    p.out_d[(size_t)qb * BQ * k + e] = s_topd[e];
    p.out_i[(size_t)qb * BQ * k + e] = s_topi[e];
  }
  if (tid == 0) p.out_s[qb] = nskip;
}

template <int BQ>
cudaError_t launch(const Params& p, int nqb, cudaStream_t stream) {
  const int threads = ((p.n0 + 31) / 32) * 32;
  const size_t smem = smem_floats(BQ, p.n0, p.dp, p.k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      p2h_sweep_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  p2h_sweep_kernel<BQ><<<nqb, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long p2h_sweep_smem_bytes(int bq, int n0, int dp, int k) {
  return (long long)(smem_floats(bq, n0, dp, k) * sizeof(float));
}

// Largest dynamic shared memory a block may opt in to on `device`.
int p2h_sweep_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Launches the sweep on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  bq must be 1, 2, 4, 8 or 16; n0 <= 1024; dp a
// multiple of 4; pts 16-byte aligned.  The caller checks all of these.
int p2h_sweep_launch(const void* visit, const void* queries,
                     const void* qnorm, const void* cap, const void* leaf_ip,
                     const void* leaf_lb, const void* leaf_cnorm,
                     const void* pts, const void* ids, const void* rx,
                     const void* xc, const void* xs, void* out_d, void* out_i,
                     void* out_s, int nqb, int bq, int L, int n0, int dp,
                     int n_visit, int k, int use_ball, int use_cone,
                     void* stream) {
  Params p{(const int*)visit,  (const float*)queries, (const float*)qnorm,
           (const float*)cap,  (const float*)leaf_ip, (const float*)leaf_lb,
           (const float*)leaf_cnorm, (const float*)pts, (const int*)ids,
           (const float*)rx,   (const float*)xc,      (const float*)xs,
           (float*)out_d,      (int*)out_i,           (int*)out_s,
           L, n0, dp, n_visit, k, use_ball, use_cone};
  cudaStream_t s = (cudaStream_t)stream;
  switch (bq) {
    case 1: return (int)launch<1>(p, nqb, s);
    case 2: return (int)launch<2>(p, nqb, s);
    case 4: return (int)launch<4>(p, nqb, s);
    case 8: return (int)launch<8>(p, nqb, s);
    case 16: return (int)launch<16>(p, nqb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
