// CCM flash attention for Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ccm_attention.py
// (ccm_flash_attention, body _kernel): full-sequence attention of
// q (B, Hq, Sq, D) over k/v (B, Hkv, Sk, D) under the CCM mask
//     (k_idx <= q_idx) & ((k_seg == q_seg) | k_comp) & k_valid,
// GQA by h // (Hq / Hkv) with no repetition, fully masked rows exactly 0.
// The TPU kernel has no backward (JAX trains through a dense jnp attend);
// here the training path runs this kernel, so its gradient is a kernel
// too: FlashAttention-2's recomputation from the saved per-row
// log-sum-exp.  Python wrapper: repro_torch/kernels/ccm_attention.py.
//
// What bounds it on the H100: at the training shape (B 4, H 32, S 1216,
// D 128, bf16) the bytes of q, k, v and o (159 MB, 0.048 ms at 3.35 TB/s)
// outweigh the bf16 tensor-core time of the visible products.  This
// kernel is the simple first port: float32 CUDA-core arithmetic from
// shared memory, no tensor cores, so it is bound by shared-memory
// bandwidth and FMA issue, far above that bound.  What the design does:
//   * one block per (q tile, q head, lane) in the forward and the dQ
//     pass, one block per (k tile, kv head, lane) in the dK/dV pass; the
//     TPU's sequential k grid axis becomes a loop inside the block;
//   * the CCM tile skip is exact and shared by all three kernels
//     (tile_visible): a (q tile, k tile) pair is skipped before its
//     loads when no key of it is visible to any q row of it, so the work
//     follows the mask's block sparsity (<COMP> columns + diagonal);
//   * tiles are read from global memory with 8-element vector loads
//     through explicit (lane, head, token) element strides, so the
//     (B, S, H, D) activations of the model are read without a transpose
//     copy, and staged as float32 in shared memory with a padded row
//     (D + 4) so float4 reads of a key row are free of bank conflicts;
//   * backward = two launches, no atomics (deterministic): the dQ pass
//     also writes Delta = rowsum(dO * O); the dK/dV pass then loops over
//     the q tiles and the G query heads of its kv head.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_D 256
#define NWARPS 4
#define NT (NWARPS * 32)
#define ROWS 4                  // q rows per warp
#define BQ (NWARPS * ROWS)      // q rows per tile
#define BK 32                   // keys per tile
#define KPW (BK / NWARPS)       // keys per warp in the dK/dV pass
#define NEG_INF_F (-1e30f)

struct CcmParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                   // (B, Hq, Sq) float32, contiguous
  const void* dout;             // backward only
  void* dq;
  void* dk;
  void* dv;
  float* delta;                 // (B, Hq, Sq) float32, contiguous
  const int* q_idx;
  const int* q_seg;
  const int* k_idx;
  const int* k_seg;
  const int* k_comp;
  const int* k_valid;           // null = every key valid
  long long q_b, q_h, q_s;      // element strides (lane, head, token)
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  long long do_b, do_h, do_s;
  long long dq_b, dq_h, dq_s;
  long long dk_b, dk_h, dk_s;
  long long dv_b, dv_h, dv_s;
  long long qm_b, km_b;         // lane strides of the metadata (0 shared)
  int B, Hq, Hkv, Sq, Sk, D;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4* v = reinterpret_cast<const float4*>(p);
  float4 a = v[0], b = v[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + R) of a (token-strided) matrix into float32 shared
// memory with leading dimension ld; rows at or past `limit` are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          long long tok_stride, int row0,
                                          int R, int limit, int D) {
  const int D8 = D >> 3;
  for (int i = threadIdx.x; i < R * D8; i += NT) {
    int r = i / D8, d = (i - r * D8) * 8, row = row0 + r;
    float x[8];
    if (row < limit) {
      load8(base + row * tok_stride + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * ld + d);
    o[0] = make_float4(x[0], x[1], x[2], x[3]);
    o[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// Metadata of one tile in shared memory.  Padded q rows see no key; keys
// past Sk or with k_valid == 0 are never visible.
struct TileMeta {
  int qidx[BQ], qseg[BQ];
  int kidx[BK], kseg[BK], kcomp[BK], kok[BK];
};

__device__ __forceinline__ void load_q_meta(TileMeta& t, const CcmParams& p,
                                            int b, int q0) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    int row = q0 + r;
    bool in = row < p.Sq;
    t.qidx[r] = in ? p.q_idx[b * p.qm_b + row] : -(1 << 30);
    t.qseg[r] = in ? p.q_seg[b * p.qm_b + row] : -3;
  }
}

__device__ __forceinline__ void load_k_meta(TileMeta& t, const CcmParams& p,
                                            int b, int k0) {
  for (int j = threadIdx.x; j < BK; j += NT) {
    int pos = k0 + j;
    bool in = pos < p.Sk;
    long long o = b * p.km_b + pos;
    t.kidx[j] = in ? p.k_idx[o] : (1 << 30);
    t.kseg[j] = in ? p.k_seg[o] : -2;
    t.kcomp[j] = in ? (p.k_comp[o] != 0) : 0;
    t.kok[j] = in && (p.k_valid == nullptr || p.k_valid[o] != 0);
  }
}

__device__ __forceinline__ bool visible(const TileMeta& t, int r, int j) {
  return t.kok[j] && t.kidx[j] <= t.qidx[r] &&
         (t.kseg[j] == t.qseg[r] || t.kcomp[j]);
}

// The CCM tile skip, shared by the forward and both backward passes:
// true iff some key of the tile is visible to some q row of the tile.
// Call with the tile's metadata in shared memory, from every thread.
__device__ __forceinline__ bool tile_visible(const TileMeta& t) {
  int vis = 0;
  for (int e = threadIdx.x; e < BQ * BK; e += NT) {
    int r = e / BK, j = e - r * BK;
    vis |= visible(t, r, j);
  }
  return __syncthreads_or(vis) != 0;
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, q head, lane)
// ---------------------------------------------------------------------------
template <typename QT, int NC>
__global__ void __launch_bounds__(NT)
ccm_attention_fwd_kernel(const __grid_constant__ CcmParams p) {
  const int D = p.D, LD = D + 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rbase = warp * ROWS;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [BQ][D]
  float* Ks = qs + BQ * D;                         // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  TileMeta& tm = *reinterpret_cast<TileMeta*>(Vs + BK * LD);

  const QT* q = static_cast<const QT*>(p.q) + b * p.q_b + h * p.q_h;
  const QT* k = static_cast<const QT*>(p.k) + b * p.k_b + hk * p.k_h;
  const QT* v = static_cast<const QT*>(p.v) + b * p.v_b + hk * p.v_h;
  load_rows(qs, D, q, p.q_s, q0, BQ, p.Sq, D);
  load_q_meta(tm, p, b, q0);

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (p.Sk + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();                     // previous tile fully consumed
    load_k_meta(tm, p, b, k0);
    __syncthreads();
    if (!tile_visible(tm)) continue;
    load_rows(Ks, LD, k, p.k_s, k0, BK, p.Sk, D);
    load_rows(Vs, LD, v, p.v_s, k0, BK, p.Sk, D);
    __syncthreads();

    // this lane's key against the warp's ROWS q rows
    const int j = lane;
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(Ks + j * LD);
    for (int d4 = 0; d4 < (D >> 2); ++d4) {
      float4 kd = kr[d4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float4 qd = reinterpret_cast<const float4*>(qs + (rbase + i) * D)[d4];
        s[i] += qd.x * kd.x + qd.y * kd.y + qd.z * kd.z + qd.w * kd.w;
      }
    }
    float pr[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      bool mk = visible(tm, rbase + i, j);
      float sc = mk ? s[i] * p.scale : NEG_INF_F;
      float m_new = fmaxf(m[i], warp_max(sc));
      float alpha = expf(m[i] - m_new);
      pr[i] = mk ? expf(sc - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pr[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    for (int jj = 0; jj < BK; ++jj) {
      float pj[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pj[i] = __shfl_sync(0xffffffffu, pr[i], jj);
      const float* vr = Vs + jj * LD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int d = lane + 32 * c;
        if (d < D) {
          float vd = vr[d];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][c] += pj[i] * vd;
        }
      }
    }
  }

  QT* o = static_cast<QT*>(p.o) + b * p.o_b + h * p.o_h;
  float* lse = p.lse + ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int row = q0 + rbase + i;
    if (row >= p.Sq) continue;
    // a fully masked row has l == 0 and acc == 0: it gives exactly 0
    float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int d = lane + 32 * c;
      if (d < D) store_out(o + row * p.o_s + d, acc[i][c] * inv);
    }
    if (lane == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

// scores s = q.k and dp = dO.v of this lane's key j against the warp's
// ROWS q rows, then P = exp(s * scale - lse) and dS = P (dp - Delta).
__device__ __forceinline__ void scores_bwd(
    const float* qs, const float* dos, const float* Ks, const float* Vs,
    int D, int LD, int rbase, int j, const TileMeta& tm, const float* lse_s,
    const float* del_s, float scale, float pr[ROWS], float ds[ROWS]) {
  float s[ROWS], dp[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) { s[i] = 0.f; dp[i] = 0.f; }
  const float4* kr = reinterpret_cast<const float4*>(Ks + j * LD);
  const float4* vr = reinterpret_cast<const float4*>(Vs + j * LD);
  for (int d4 = 0; d4 < (D >> 2); ++d4) {
    float4 kd = kr[d4], vd = vr[d4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float4 qd = reinterpret_cast<const float4*>(qs + (rbase + i) * D)[d4];
      float4 gd = reinterpret_cast<const float4*>(dos + (rbase + i) * D)[d4];
      s[i] += qd.x * kd.x + qd.y * kd.y + qd.z * kd.z + qd.w * kd.w;
      dp[i] += gd.x * vd.x + gd.y * vd.y + gd.z * vd.z + gd.w * vd.w;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int r = rbase + i;
    bool mk = visible(tm, r, j);
    pr[i] = mk ? expf(s[i] * scale - lse_s[r]) : 0.f;
    ds[i] = pr[i] * (dp[i] - del_s[r]);
  }
}

// ---------------------------------------------------------------------------
// backward pass 1: dQ and Delta, one block per (q tile, q head, lane)
// ---------------------------------------------------------------------------
template <typename QT, int NC>
__global__ void __launch_bounds__(NT)
ccm_attention_bwd_dq_kernel(const __grid_constant__ CcmParams p) {
  const int D = p.D, LD = D + 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rbase = warp * ROWS;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [BQ][D]
  float* dos = qs + BQ * D;                        // [BQ][D]
  float* Ks = dos + BQ * D;                        // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* lse_s = Vs + BK * LD;                     // [BQ]
  float* del_s = lse_s + BQ;                       // [BQ]
  TileMeta& tm = *reinterpret_cast<TileMeta*>(del_s + BQ);

  const QT* q = static_cast<const QT*>(p.q) + b * p.q_b + h * p.q_h;
  const QT* k = static_cast<const QT*>(p.k) + b * p.k_b + hk * p.k_h;
  const QT* v = static_cast<const QT*>(p.v) + b * p.v_b + hk * p.v_h;
  const QT* o = static_cast<const QT*>(p.o) + b * p.o_b + h * p.o_h;
  const QT* dout = static_cast<const QT*>(p.dout) + b * p.do_b + h * p.do_h;
  const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
  load_rows(qs, D, q, p.q_s, q0, BQ, p.Sq, D);
  load_rows(dos, D, dout, p.do_s, q0, BQ, p.Sq, D);
  load_q_meta(tm, p, b, q0);
  __syncthreads();                       // dO tile complete
  // Delta = rowsum(dO * O), O as stored; one warp per row
  for (int r = warp; r < BQ; r += NWARPS) {
    int row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq)
      for (int d = lane; d < D; d += 32)
        acc += dos[r * D + d] * to_f32(o[row * p.o_s + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      del_s[r] = acc;
      lse_s[r] = row < p.Sq ? p.lse[rowbase + row] : 0.f;
      if (row < p.Sq) p.delta[rowbase + row] = acc;
    }
  }

  float dq[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  const int nk = (p.Sk + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_k_meta(tm, p, b, k0);
    __syncthreads();
    if (!tile_visible(tm)) continue;
    load_rows(Ks, LD, k, p.k_s, k0, BK, p.Sk, D);
    load_rows(Vs, LD, v, p.v_s, k0, BK, p.Sk, D);
    __syncthreads();
    float pr[ROWS], ds[ROWS];
    scores_bwd(qs, dos, Ks, Vs, D, LD, rbase, lane, tm, lse_s, del_s,
               p.scale, pr, ds);
    for (int jj = 0; jj < BK; ++jj) {
      float dj[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dj[i] = __shfl_sync(0xffffffffu, ds[i], jj);
      const float* kr = Ks + jj * LD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int d = lane + 32 * c;
        if (d < D) {
          float kd = kr[d];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) dq[i][c] += dj[i] * kd;
        }
      }
    }
  }

  QT* dqp = static_cast<QT*>(p.dq) + b * p.dq_b + h * p.dq_h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int row = q0 + rbase + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int d = lane + 32 * c;
      if (d < D) store_out(dqp + row * p.dq_s + d, dq[i][c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass 2: dK and dV, one block per (k tile, kv head, lane),
// looping over the q tiles and the G query heads of the kv head
// ---------------------------------------------------------------------------
template <typename QT, int NC>
__global__ void __launch_bounds__(NT)
ccm_attention_bwd_dkdv_kernel(const __grid_constant__ CcmParams p) {
  const int D = p.D, LD = D + 4;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = p.Hq / p.Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rbase = warp * ROWS, kbase = warp * KPW;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);     // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* qs = Vs + BK * LD;                        // [BQ][D]
  float* dos = qs + BQ * D;                        // [BQ][D]
  float* Ps = dos + BQ * D;                        // [BQ][BK]
  float* dSs = Ps + BQ * BK;                       // [BQ][BK]
  float* lse_s = dSs + BQ * BK;                    // [BQ]
  float* del_s = lse_s + BQ;                       // [BQ]
  TileMeta& tm = *reinterpret_cast<TileMeta*>(del_s + BQ);

  const QT* k = static_cast<const QT*>(p.k) + b * p.k_b + hk * p.k_h;
  const QT* v = static_cast<const QT*>(p.v) + b * p.v_b + hk * p.v_h;
  load_rows(Ks, LD, k, p.k_s, k0, BK, p.Sk, D);
  load_rows(Vs, LD, v, p.v_s, k0, BK, p.Sk, D);
  load_k_meta(tm, p, b, k0);

  float dk[KPW][NC], dv[KPW][NC];
#pragma unroll
  for (int j = 0; j < KPW; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) { dk[j][c] = 0.f; dv[j][c] = 0.f; }

  const int nq = (p.Sq + BQ - 1) / BQ;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_q_meta(tm, p, b, q0);
    __syncthreads();
    if (!tile_visible(tm)) continue;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const QT* q = static_cast<const QT*>(p.q) + b * p.q_b + h * p.q_h;
      const QT* dout = static_cast<const QT*>(p.dout) + b * p.do_b + h * p.do_h;
      const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
      __syncthreads();                   // previous head's tiles consumed
      load_rows(qs, D, q, p.q_s, q0, BQ, p.Sq, D);
      load_rows(dos, D, dout, p.do_s, q0, BQ, p.Sq, D);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        int row = q0 + r;
        lse_s[r] = row < p.Sq ? p.lse[rowbase + row] : 0.f;
        del_s[r] = row < p.Sq ? p.delta[rowbase + row] : 0.f;
      }
      __syncthreads();
      float pr[ROWS], ds[ROWS];
      scores_bwd(qs, dos, Ks, Vs, D, LD, rbase, lane, tm, lse_s, del_s,
                 p.scale, pr, ds);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        Ps[(rbase + i) * BK + lane] = pr[i];
        dSs[(rbase + i) * BK + lane] = ds[i];
      }
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        float gd[NC], qd[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          int d = lane + 32 * c;
          gd[c] = d < D ? dos[i * D + d] : 0.f;
          qd[c] = d < D ? qs[i * D + d] : 0.f;
        }
#pragma unroll
        for (int jk = 0; jk < KPW; ++jk) {
          float pv = Ps[i * BK + kbase + jk], sv = dSs[i * BK + kbase + jk];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[jk][c] += pv * gd[c];
            dk[jk][c] += sv * qd[c];
          }
        }
      }
    }
  }

  QT* dkp = static_cast<QT*>(p.dk) + b * p.dk_b + hk * p.dk_h;
  QT* dvp = static_cast<QT*>(p.dv) + b * p.dv_b + hk * p.dv_h;
#pragma unroll
  for (int jk = 0; jk < KPW; ++jk) {
    int pos = k0 + kbase + jk;
    if (pos >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int d = lane + 32 * c;
      if (d < D) {
        store_out(dkp + pos * p.dk_s + d, dk[jk][c] * p.scale);
        store_out(dvp + pos * p.dv_s + d, dv[jk][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename Kern>
static int set_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename QT, int NC>
static int fwd(const CcmParams& p, cudaStream_t s) {
  const int LD = p.D + 4;
  size_t smem = (size_t)(BQ * p.D + 2 * BK * LD) * sizeof(float) + sizeof(TileMeta);
  int e = set_smem(ccm_attention_fwd_kernel<QT, NC>, smem);
  if (e) return e;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  ccm_attention_fwd_kernel<QT, NC><<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename QT, int NC>
static int bwd(const CcmParams& p, cudaStream_t s) {
  const int LD = p.D + 4;
  size_t smem1 = (size_t)(2 * BQ * p.D + 2 * BK * LD + 2 * BQ) * sizeof(float)
                 + sizeof(TileMeta);
  int e = set_smem(ccm_attention_bwd_dq_kernel<QT, NC>, smem1);
  if (e) return e;
  dim3 g1((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  ccm_attention_bwd_dq_kernel<QT, NC><<<g1, NT, smem1, s>>>(p);
  e = (int)cudaGetLastError();
  if (e) return e;
  size_t smem2 = (size_t)(2 * BK * LD + 2 * BQ * p.D + 2 * BQ * BK + 2 * BQ)
                 * sizeof(float) + sizeof(TileMeta);
  e = set_smem(ccm_attention_bwd_dkdv_kernel<QT, NC>, smem2);
  if (e) return e;
  dim3 g2((p.Sk + BK - 1) / BK, p.Hkv, p.B);
  ccm_attention_bwd_dkdv_kernel<QT, NC><<<g2, NT, smem2, s>>>(p);
  return (int)cudaGetLastError();
}

static bool bad(const CcmParams& p) {
  return p.D <= 0 || p.D > MAX_D || (p.D & 7) || p.Hkv <= 0 ||
         p.Hq % p.Hkv || p.B <= 0 || p.Sq <= 0 || p.Sk <= 0;
}

// Returns a cudaError_t code (0 = launched).  bf16: every tensor is bf16
// (else float32); lse/delta are float32.
extern "C" int ccm_attention_fwd_launch(const CcmParams* params, int bf16,
                                        int device, void* stream) {
  const CcmParams& p = *params;
  if (bad(p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (p.D <= 64) return fwd<__nv_bfloat16, 2>(p, s);
    if (p.D <= 128) return fwd<__nv_bfloat16, 4>(p, s);
    return fwd<__nv_bfloat16, 8>(p, s);
  }
  if (p.D <= 64) return fwd<float, 2>(p, s);
  if (p.D <= 128) return fwd<float, 4>(p, s);
  return fwd<float, 8>(p, s);
}

extern "C" int ccm_attention_bwd_launch(const CcmParams* params, int bf16,
                                        int device, void* stream) {
  const CcmParams& p = *params;
  if (bad(p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (p.D <= 64) return bwd<__nv_bfloat16, 2>(p, s);
    if (p.D <= 128) return bwd<__nv_bfloat16, 4>(p, s);
    return bwd<__nv_bfloat16, 8>(p, s);
  }
  if (p.D <= 64) return bwd<float, 2>(p, s);
  if (p.D <= 128) return bwd<float, 4>(p, s);
  return bwd<float, 8>(p, s);
}

extern "C" int ccm_attention_abi_size() { return (int)sizeof(CcmParams); }
