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
// outweigh the bf16 tensor-core time of the visible products.
//
// Two routes, chosen by the dtype (both backward passes are two launches
// with no atomics, so the gradients are deterministic):
//   float32: CUDA-core kernels (the float32 cross-checks).  float32 FMAs
//     out of shared memory on 16-row x 32-key tiles, an exact per-tile
//     visibility vote (tile_visible) before each tile's loads.
//   bf16: tensor-core kernels (the training path).  FlashAttention-2 on
//     mma.sync.m16n8k16 (bf16 in, float32 accumulated), 64-row q tiles
//     (4 warps x 16 rows) against 64-key tiles; fragments by ldmatrix;
//     K/V (and, in the dK/dV pass, Q/dO) tiles double-buffered by
//     cp.async in 16-byte pieces through the (lane, head, token) element
//     strides, so the model's (B, S, H, D) activations are read in place;
//     the online softmax in registers; P and dS rounded to bf16 for their
//     products; a head dim that is not a multiple of 16 zero-pads the
//     last k-step.  The mask is split into two disjoint parts,
//         D = causal & same segment & !comp & valid   (natural stream)
//         C = causal & comp & valid                   (<COMP> stream),
//     whose union is the CCM mask.  The natural stream is the key tiles
//     in their order; the <COMP> stream is the lane's comp & valid keys
//     compacted into tiles of their own (a row gather), so the sparse
//     <COMP> columns cost whole tiles of visible keys instead of one
//     column of every dense tile.  The wrapper plans both streams on the
//     device (no host synchronisation): a key table per tile slot
//     (position, k_idx or KBIG where the stream hides the key, k_seg,
//     flags), the key tiles each q tile visits (exact: each has a visible
//     pair) and the q tiles that see each key tile.  The dQ pass walks
//     the forward's plan; the dK/dV pass runs one block per (key tile of
//     either stream, kv head, lane), <COMP> tiles first (their q lists
//     are the longest), over just the q tiles and the G q heads that see
//     it, and writes the dK/dV rows its stream owns.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"   // cp.async, ldmatrix, mma.sync helpers

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
  // bf16 route only: the two-stream plan (the wrapper's plan(); NT = nk + nc)
  const int* ktab;              // (P, NT * 64, 4): position, k_idx or KBIG,
                                //   k_seg, flags (F_ANY, F_OWN)
  const int* q_tiles;           // (P, nq, NT) key tiles each q tile visits
  const int* q_count;           // (P, nq)
  const int* k_tiles;           // (P, NT, nq) q tiles that see each key tile
  const int* k_count;           // (P, NT)
  int plan_lanes;               // P: 1 (shared metadata) or B
  int nq, nk, nc;               // q tiles, natural and <COMP> key tiles
};

// ===========================================================================
// float32 route: CUDA cores
// ===========================================================================

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

// ===========================================================================
// bf16 route: tensor cores, cp.async, the natural and <COMP> tile streams
// ===========================================================================

#define TB 64                   // q rows of a q tile = keys of a key tile
#define KBIG INT_MAX            // k_idx of a key its stream does not show
#define QNONE (-(1 << 30))      // q_idx of a padded q row: sees no key
#define F_ANY 1                 // key-table flag: every segment sees it
#define F_OWN 2                 // key-table flag: its stream writes dK/dV
#define LOG2E 1.4426950408889634f
#define LN2 0.6931471805599453f

typedef __nv_bfloat16 bf16;

// [TB] rows from row0 of a token-strided bf16 matrix into shared memory
// (row stride rse elements) by cp.async; rows at or past `limit` are 0.
__device__ __forceinline__ void tile_rows_async(bf16* dst, int rse,
                                                const bf16* base,
                                                long long tok, int row0,
                                                int limit, int D, int nth) {
  const int nch = D >> 3, per = nth / nch, c = threadIdx.x % nch;
  if (threadIdx.x >= per * nch) return;
  for (int r = threadIdx.x / nch; r < TB; r += per) {
    bf16* d = dst + r * rse + c * 8;
    if (row0 + r < limit)
      cp_async16(d, base + (row0 + r) * tok + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The K and V rows of a key tile at its key-table positions (cp.async);
// a key its stream does not show is zeroed, so P = 0 never meets a NaN.
__device__ __forceinline__ void key_rows_async(bf16* kst, bf16* vst, int rse,
                                               const int4* km, const bf16* k,
                                               long long kt, const bf16* v,
                                               long long vt, int D, int nth) {
  const int nch = D >> 3, per = nth / nch, c = threadIdx.x % nch;
  if (threadIdx.x >= per * nch) return;
  for (int j = threadIdx.x / nch; j < TB; j += per) {
    const int4 m = km[j];
    bf16* kd = kst + j * rse + c * 8;
    bf16* vd = vst + j * rse + c * 8;
    if (m.y != KBIG) {
      cp_async16(kd, k + m.x * kt + c * 8);
      cp_async16(vd, v + m.x * vt + c * 8);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The key-table entries of tile slot `tile` (16 bytes a key, threads < TB).
__device__ __forceinline__ void ktab_async(int4* dst, const int* ktab,
                                           long long lane_base, int tile) {
  if (threadIdx.x < TB)
    cp_async16(dst + threadIdx.x,
               ktab + (lane_base + (long long)tile * TB + threadIdx.x) * 4);
}

// Zero the head-dim pad [D, D + 8) of `rows` rows when D is not a
// multiple of 16: the last k-step of a product over D reads it.
__device__ __forceinline__ void zero_pad(bf16* base, int rows, int rse, int D,
                                         int nth) {
  if (!(D & 8)) return;
  for (int r = threadIdx.x; r < rows; r += nth)
    *reinterpret_cast<uint4*>(base + r * rse + D) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ bool shows(const int4& m, int qi, int qg) {
  return m.y <= qi && ((m.w & F_ANY) || m.z == qg);
}

// S (+)= A B^T over the head dim for one warp: A's 16 rows at `a_rows`,
// B's KC rows at `b_rows` (both row stride rse), s[KC / 8][4] accumulators.
template <int NKS, int NKT>
__device__ __forceinline__ void qk_tile(float s[NKT][4], const bf16* a_rows,
                                        const bf16* b_rows, int rse, int nks,
                                        int lane) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    if (ks < nks) {
      uint32_t a[4];
      ldsm_x4(a, a_rows + (lane & 15) * rse + ks * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int n2 = 0; n2 < NKT / 2; ++n2) {
        uint32_t bb[4];
        ldsm_x4(bb, b_rows + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) * rse +
                        ks * 16 + 8 * ((lane >> 3) & 1));
        mma16816(s[2 * n2], a, bb[0], bb[1]);
        mma16816(s[2 * n2 + 1], a, bb[2], bb[3]);
      }
    }
  }
}

// acc[n] += P V for one warp: P the warp's 16 x KC accumulators (rounded
// to bf16), V's KC rows at `v_rows` read transposed; n-tiles [n0, n0 + NN)
// below ndt.
template <int NKT, int NN>
__device__ __forceinline__ void pv_tile(float acc[NN][4], float s[NKT][4],
                                        const bf16* v_rows, int rse, int n0,
                                        int ndt, int lane) {
#pragma unroll
  for (int kk = 0; kk < NKT / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      if (n0 + n < ndt) {
        uint32_t bb[2];
        ldsm_x2_t(bb, v_rows + (kk * 16 + (lane & 15)) * rse + (n0 + n) * 8);
        mma16816(acc[n], a, bb[0], bb[1]);
      }
    }
  }
}

struct QLayout {               // forward and dQ pass, byte offsets
  int rse, q, dout, ring, meta, qm, list, total;
  __host__ __device__ QLayout(int D, int nt, bool bwd) {
    rse = ((D + 15) & ~15) + 8;              // row stride, elements
    q = 0;                                   // bf16 [TB][rse]
    dout = q + TB * rse * 2;                 // bf16 [TB][rse] (dQ pass)
    ring = dout + (bwd ? TB * rse * 2 : 0);  // bf16 [2][K|V][TB][rse]
    meta = ring + 4 * TB * rse * 2;          // int4 [3][TB] key tables
    qm = meta + 3 * TB * 16;                 // q_idx, q_seg, lse2, delta [TB]
    list = qm + 4 * TB * 4;                  // int [nt] key tiles to visit
    total = list + nt * 4;
  }
};

// What the forward and the dQ pass share: the block's q tile (and dO),
// its plan, and the pipeline over the planned key tiles.  Per tile i:
// wait for K/V(i) and the key table of i + 1, one barrier, then start
// the copies of K/V(i + 1) and the key table of i + 2 before computing
// tile i.
struct QBlock {
  int b, h, q0, n, rse;
  long long lane_base;
  bf16 *qs, *dos, *ring;
  int4* meta;
  int *qidx, *qseg, *list;
  float *lse2, *dls;
  const bf16 *k, *v;
};

__device__ __forceinline__ QBlock q_block(const CcmParams& p, uint8_t* sm,
                                          bool bwd) {
  QBlock B;
  const int nts = p.nk + p.nc, qt = blockIdx.x;
  B.b = blockIdx.z;
  B.h = blockIdx.y;
  B.q0 = qt * TB;
  const long long pb = p.plan_lanes > 1 ? B.b : 0;
  const QLayout L(p.D, nts, bwd);
  B.rse = L.rse;
  B.qs = reinterpret_cast<bf16*>(sm + L.q);
  B.dos = reinterpret_cast<bf16*>(sm + L.dout);
  B.ring = reinterpret_cast<bf16*>(sm + L.ring);
  B.meta = reinterpret_cast<int4*>(sm + L.meta);
  B.qidx = reinterpret_cast<int*>(sm + L.qm);
  B.qseg = B.qidx + TB;
  B.lse2 = reinterpret_cast<float*>(B.qseg + TB);
  B.dls = B.lse2 + TB;
  B.list = reinterpret_cast<int*>(sm + L.list);
  B.lane_base = pb * nts * TB;
  B.n = p.q_count[pb * p.nq + qt];
  const int hk = B.h / (p.Hq / p.Hkv);
  B.k = static_cast<const bf16*>(p.k) + B.b * p.k_b + hk * p.k_h;
  B.v = static_cast<const bf16*>(p.v) + B.b * p.v_b + hk * p.v_h;

  const int* lg = p.q_tiles + (pb * p.nq + qt) * nts;
  for (int i = threadIdx.x; i < B.n; i += 128) B.list[i] = lg[i];
  tile_rows_async(B.qs, B.rse,
                  static_cast<const bf16*>(p.q) + B.b * p.q_b + B.h * p.q_h,
                  p.q_s, B.q0, p.Sq, p.D, 128);
  if (bwd)
    tile_rows_async(B.dos, B.rse,
                    static_cast<const bf16*>(p.dout) + B.b * p.do_b +
                        B.h * p.do_h,
                    p.do_s, B.q0, p.Sq, p.D, 128);
  zero_pad(B.qs, bwd ? 2 * TB : TB, B.rse, p.D, 128);
  zero_pad(B.ring, 4 * TB, B.rse, p.D, 128);
  const long long rowbase = ((long long)B.b * p.Hq + B.h) * p.Sq;
  for (int r = threadIdx.x; r < TB; r += 128) {
    const int row = B.q0 + r;
    const bool in = row < p.Sq;
    B.qidx[r] = in ? p.q_idx[B.b * p.qm_b + row] : QNONE;
    B.qseg[r] = in ? p.q_seg[B.b * p.qm_b + row] : -3;
    if (bwd) B.lse2[r] = in ? p.lse[rowbase + row] * LOG2E : 0.f;
  }
  __syncthreads();                           // the list
  if (B.n > 0) ktab_async(B.meta, p.ktab, B.lane_base, B.list[0]);
  cp_commit();
  cp_wait<0>();
  __syncthreads();                           // q (dO) tile, key table 0
  return B;
}

// start the copies of K/V of tile 0 and the key table of tile 1 (after
// the prologue)
__device__ __forceinline__ void q_pipe_start(const CcmParams& p,
                                             const QBlock& B) {
  if (B.n > 0)
    key_rows_async(B.ring, B.ring + TB * B.rse, B.rse, B.meta, B.k, p.k_s,
                   B.v, p.v_s, p.D, 128);
  if (B.n > 1) ktab_async(B.meta + TB, p.ktab, B.lane_base, B.list[1]);
  cp_commit();
}

// top of step i: tile i's K/V and key table are resident afterwards
__device__ __forceinline__ void q_pipe_step(const CcmParams& p,
                                            const QBlock& B, int i) {
  cp_wait<0>();
  __syncthreads();
  if (i + 1 < B.n) {
    bf16* kst = B.ring + 2 * ((i + 1) & 1) * TB * B.rse;
    key_rows_async(kst, kst + TB * B.rse, B.rse, B.meta + ((i + 1) % 3) * TB,
                   B.k, p.k_s, B.v, p.v_s, p.D, 128);
  }
  if (i + 2 < B.n)
    ktab_async(B.meta + ((i + 2) % 3) * TB, p.ktab, B.lane_base,
               B.list[i + 2]);
  cp_commit();
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, q head, lane); KC keys per softmax step
// ---------------------------------------------------------------------------
template <int DMAX, int KC>
__global__ void __launch_bounds__(128, 1)
ccm_attention_fwd_mma_kernel(const __grid_constant__ CcmParams p) {
  constexpr int NDT = DMAX / 8, NKS = DMAX / 16, NKT = KC / 8;
  const int D = p.D, ndt = D >> 3, nks = (D + 15) >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  extern __shared__ __align__(16) uint8_t sm[];
  const QBlock B = q_block(p, sm, false);
  const int rse = B.rse, r0 = warp * 16 + g;
  const int qi[2] = {B.qidx[r0], B.qidx[r0 + 8]};
  const int qg[2] = {B.qseg[r0], B.qseg[r0 + 8]};
  q_pipe_start(p, B);
  const float sl2 = p.scale * LOG2E;
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const bf16* qw = B.qs + warp * 16 * rse;

  for (int i = 0; i < B.n; ++i) {
    q_pipe_step(p, B, i);
    const int4* km = B.meta + (i % 3) * TB;
    const bf16* kst = B.ring + 2 * (i & 1) * TB * rse;
    const bf16* vst = kst + TB * rse;
#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += KC) {
      float s[NKT][4];
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      qk_tile<NKS, NKT>(s, qw, kst + c0 * rse, rse, nks, lane);
      // this stream's mask, online softmax (base 2) over the KC keys
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const bool vis = shows(km[c0 + n * 8 + 2 * tq + (e & 1)], qi[hh], qg[hh]);
          s[n][e] = vis ? s[n][e] * sl2 : -INFINITY;
          mx[hh] = fmaxf(mx[hh], s[n][e]);
        }
      }
      float alpha[2], mu[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(mrow[hh], mx[hh]);
        mu[hh] = m_new == -INFINITY ? 0.f : m_new;
        alpha[hh] = exp2f(mrow[hh] - mu[hh]);
        mrow[hh] = m_new;
        lrow[hh] *= alpha[hh];
      }
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - mu[e >> 1]);  // masked: exp2(-inf) = 0
          lrow[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
      pv_tile<NKT, NDT>(o, s, vst + c0 * rse, rse, 0, ndt, lane);
    }
  }
  cp_wait<0>();

  bf16* out = static_cast<bf16*>(p.o) + B.b * p.o_b + B.h * p.o_h;
  float* lse = p.lse + ((long long)B.b * p.Hq + B.h) * p.Sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = lrow[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    // a row that saw no key has l == 0 and o == 0: exactly 0
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = B.q0 + r0 + 8 * hh;
    if (row >= p.Sq) continue;
    bf16* orow = out + row * p.o_s;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n < ndt)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
    if (tq == 0) lse[row] = l > 0.f ? (mrow[hh] + log2f(l)) * LN2 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward pass 1: dQ and Delta = rowsum(dO * O), the forward's tiling
// ---------------------------------------------------------------------------
template <int DMAX, int KC>
__global__ void __launch_bounds__(128, 1)
ccm_attention_bwd_dq_mma_kernel(const __grid_constant__ CcmParams p) {
  constexpr int NDT = DMAX / 8, NKS = DMAX / 16, NKT = KC / 8;
  const int D = p.D, ndt = D >> 3, nks = (D + 15) >> 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  extern __shared__ __align__(16) uint8_t sm[];
  const QBlock B = q_block(p, sm, true);
  const int rse = B.rse, r0 = warp * 16 + g;
  {  // Delta, two threads a row, O as stored
    const int r = tid >> 1, row = B.q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const bf16* orow = static_cast<const bf16*>(p.o) + B.b * p.o_b +
                         B.h * p.o_h + row * p.o_s;
      for (int c = tid & 1; c < ndt; c += 2) {
        const uint4 ou = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 du = *reinterpret_cast<const uint4*>(B.dos + r * rse + c * 8);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ou);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(oh[e]), d = __bfloat1622float2(dh[e]);
          acc += a.x * d.x + a.y * d.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (!(tid & 1)) {
      B.dls[r] = acc;
      if (row < p.Sq) p.delta[((long long)B.b * p.Hq + B.h) * p.Sq + row] = acc;
    }
  }
  q_pipe_start(p, B);
  __syncthreads();                           // Delta
  const int qi[2] = {B.qidx[r0], B.qidx[r0 + 8]};
  const int qg[2] = {B.qseg[r0], B.qseg[r0 + 8]};
  const float l2[2] = {B.lse2[r0], B.lse2[r0 + 8]};
  const float dl[2] = {B.dls[r0], B.dls[r0 + 8]};
  const float sl2 = p.scale * LOG2E;
  float dq[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const bf16* qw = B.qs + warp * 16 * rse;
  const bf16* dw = B.dos + warp * 16 * rse;

  for (int i = 0; i < B.n; ++i) {
    q_pipe_step(p, B, i);
    const int4* km = B.meta + (i % 3) * TB;
    const bf16* kst = B.ring + 2 * (i & 1) * TB * rse;
    const bf16* vst = kst + TB * rse;
#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += KC) {
      float s[NKT][4], dp[NKT][4];
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[n][e] = 0.f; dp[n][e] = 0.f; }
      qk_tile<NKS, NKT>(s, qw, kst + c0 * rse, rse, nks, lane);
      qk_tile<NKS, NKT>(dp, dw, vst + c0 * rse, rse, nks, lane);
      // P = exp(S scale - lse) on this stream's mask, dS = P (dP - Delta)
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const bool vis = shows(km[c0 + n * 8 + 2 * tq + (e & 1)], qi[hh], qg[hh]);
          const float pr = vis ? exp2f(s[n][e] * sl2 - l2[hh]) : 0.f;
          s[n][e] = pr * (dp[n][e] - dl[hh]);
        }
      }
      pv_tile<NKT, NDT>(dq, s, kst + c0 * rse, rse, 0, ndt, lane);  // dQ += dS K
    }
  }
  cp_wait<0>();

  bf16* dqp = static_cast<bf16*>(p.dq) + B.b * p.dq_b + B.h * p.dq_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = B.q0 + r0 + 8 * hh;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n < ndt)
        *reinterpret_cast<__nv_bfloat162*>(dqp + row * p.dq_s + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(dq[n][2 * hh] * p.scale,
                                  dq[n][2 * hh + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass 2: dK and dV, one block per (key tile of either stream,
// kv head, lane), <COMP> tiles first; warp w owns keys 16 (w % 4) .. + 16
// and, with WD = 2 (D > 128, 8 warps), the head-dim half w / 4 of dK/dV
// ---------------------------------------------------------------------------
struct KLayout {               // byte offsets
  int rse, kv, ring, qm, meta, list, total;
  __host__ __device__ KLayout(int D, int nq) {
    rse = ((D + 15) & ~15) + 8;
    kv = 0;                                  // bf16 [K|V][TB][rse]
    ring = kv + 2 * TB * rse * 2;            // bf16 [2][Q|dO][TB][rse]
    qm = ring + 4 * TB * rse * 2;            // [2] q_idx, q_seg, lse, delta [TB]
    meta = qm + 2 * 4 * TB * 4;              // int4 [TB] the tile's key table
    list = meta + TB * 16;                   // int [nq] q tiles that see it
    total = list + nq * 4;
  }
};

template <int DMAX, int WD>
__global__ void __launch_bounds__(128 * WD, 1)
ccm_attention_bwd_dkdv_mma_kernel(const __grid_constant__ CcmParams p) {
  constexpr int NTH = 128 * WD, NDH = DMAX / 8 / WD, NKS = DMAX / 16;
  const int D = p.D, ndt = D >> 3, nks = (D + 15) >> 4;
  const int BH = p.B * p.Hkv, slot = blockIdx.x / BH;
  const int b = (blockIdx.x - slot * BH) / p.Hkv;
  const int hk = blockIdx.x - slot * BH - b * p.Hkv;
  const int nts = p.nk + p.nc, G = p.Hq / p.Hkv;
  const int tile = slot < p.nc ? p.nk + slot : slot - p.nc;
  const long long pb = p.plan_lanes > 1 ? b : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kw0 = (warp & 3) * 16, n0 = (warp >> 2) * NDH;
  const KLayout L(D, p.nq);
  const int rse = L.rse;
  extern __shared__ __align__(16) uint8_t sm[];
  bf16* kvs = reinterpret_cast<bf16*>(sm + L.kv);
  bf16* ring = reinterpret_cast<bf16*>(sm + L.ring);
  int4* meta = reinterpret_cast<int4*>(sm + L.meta);
  int* list = reinterpret_cast<int*>(sm + L.list);
  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_b + hk * p.dk_h;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_b + hk * p.dv_h;

  const int n = p.k_count[pb * nts + tile];
  if (tid < TB)
    meta[tid] = *reinterpret_cast<const int4*>(
        p.ktab + ((pb * nts + tile) * TB + tid) * 4);
  __syncthreads();
  if (n == 0) {            // no q row sees the tile: its own rows get 0
    const int nch = D >> 3;
    for (int i = tid; i < TB * nch; i += NTH) {
      const int j = i / nch, c = i - j * nch;
      const int4 m = meta[j];
      if (m.w & F_OWN) {
        *reinterpret_cast<uint4*>(dkp + m.x * p.dk_s + c * 8) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dvp + m.x * p.dv_s + c * 8) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int* lg = p.k_tiles + (pb * nts + tile) * p.nq;
  for (int i = tid; i < n; i += NTH) list[i] = lg[i];
  zero_pad(kvs, 2 * TB, rse, D, NTH);
  zero_pad(ring, 4 * TB, rse, D, NTH);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_b + hk * p.k_h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_b + hk * p.v_h;
  key_rows_async(kvs, kvs + TB * rse, rse, meta, kg, p.k_s, vg, p.v_s, D, NTH);
  __syncthreads();                           // the list

  // Q, dO and the rows' q_idx, q_seg, lse, Delta of step `it` (q tile
  // list[it / G], q head hk * G + it % G) into ring stage st
  auto load_step = [&](int it, int st) {
    const int q0 = list[it / G] * TB, h = hk * G + it % G;
    bf16* qst = ring + 2 * st * TB * rse;
    tile_rows_async(qst, rse, static_cast<const bf16*>(p.q) + b * p.q_b + h * p.q_h,
                    p.q_s, q0, p.Sq, D, NTH);
    tile_rows_async(qst + TB * rse, rse,
                    static_cast<const bf16*>(p.dout) + b * p.do_b + h * p.do_h,
                    p.do_s, q0, p.Sq, D, NTH);
    int* qi = reinterpret_cast<int*>(sm + L.qm) + st * 4 * TB;
    const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
    for (int r = tid; r < TB; r += NTH) {
      const int row = q0 + r;
      if (row < p.Sq) {
        cp_async4(qi + r, p.q_idx + b * p.qm_b + row);
        cp_async4(qi + TB + r, p.q_seg + b * p.qm_b + row);
        cp_async4(qi + 2 * TB + r, p.lse + rowbase + row);
        cp_async4(qi + 3 * TB + r, p.delta + rowbase + row);
      } else {
        qi[r] = QNONE;
        qi[TB + r] = -3;
        qi[2 * TB + r] = 0;                  // lse, delta: 0.0f
        qi[3 * TB + r] = 0;
      }
    }
  };
  load_step(0, 0);
  cp_commit();

  // this thread's key rows kw0 + g, kw0 + g + 8
  const int4 km[2] = {meta[kw0 + g], meta[kw0 + g + 8]};
  const float sl2 = p.scale * LOG2E;
  float dk[NDH][4], dv[NDH][4];
#pragma unroll
  for (int j = 0; j < NDH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk[j][e] = 0.f; dv[j][e] = 0.f; }
  const bf16* kw = kvs + kw0 * rse;
  const bf16* vw = kvs + (TB + kw0) * rse;

  const int steps = n * G;
  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < steps) load_step(it + 1, st ^ 1);
    cp_commit();
    const bf16* qst = ring + 2 * st * TB * rse;
    const bf16* dost = qst + TB * rse;
    const int* qi = reinterpret_cast<const int*>(sm + L.qm) + st * 4 * TB;
    const int* qs = qi + TB;
    const float* ls = reinterpret_cast<const float*>(qi + 2 * TB);
    const float* ds = ls + TB;
#pragma unroll 1
    for (int qc = 0; qc < TB; qc += 32) {
      float sT[4][4], dpT[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) { sT[j][e] = 0.f; dpT[j][e] = 0.f; }
      // the chunk's q rows 8 j + 2 t + u of this thread, read before the
      // products so that their latency hides under them
      int rq[4][2], rg[4][2];
      float rl[4][2], rd[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = qc + j * 8 + 2 * tq + u;
          rq[j][u] = qi[col];
          rg[j][u] = qs[col];
          rl[j][u] = ls[col] * LOG2E;
          rd[j][u] = ds[col];
        }
      qk_tile<NKS, 4>(sT, kw, qst + qc * rse, rse, nks, lane);    // K Q^T
      qk_tile<NKS, 4>(dpT, vw, dost + qc * rse, rse, nks, lane);  // V dO^T
      // P^T and dS^T: rows this warp's keys, columns the chunk's q rows
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e & 1;
          const bool vis = shows(km[e >> 1], rq[j][u], rg[j][u]);
          const float pr = vis ? exp2f(sT[j][e] * sl2 - rl[j][u]) : 0.f;
          dpT[j][e] = pr * (dpT[j][e] - rd[j][u]);
          sT[j][e] = pr;
        }
      }
      pv_tile<4, NDH>(dv, sT, dost + qc * rse, rse, n0, ndt, lane);  // dV += P^T dO
      pv_tile<4, NDH>(dk, dpT, qst + qc * rse, rse, n0, ndt, lane);  // dK += dS^T Q
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!(km[hh].w & F_OWN)) continue;
    const long long pos = km[hh].x;
#pragma unroll
    for (int j = 0; j < NDH; ++j) {
      const int d = (n0 + j) * 8 + 2 * tq;
      if (n0 + j < ndt) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + pos * p.dk_s + d) =
            __floats2bfloat162_rn(dk[j][2 * hh] * p.scale,
                                  dk[j][2 * hh + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + pos * p.dv_s + d) =
            __floats2bfloat162_rn(dv[j][2 * hh], dv[j][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
#define SMEM_MAX 232448         // dynamic shared memory a block may use

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

// the bf16 route's plan must match the shapes (see the wrapper's plan())
static bool bad_plan(const CcmParams& p) {
  return !p.ktab || !p.q_tiles || !p.q_count || !p.k_tiles || !p.k_count ||
         p.nq != (p.Sq + TB - 1) / TB || p.nk != (p.Sk + TB - 1) / TB ||
         p.nc < 0 || (p.plan_lanes != 1 && p.plan_lanes != p.B);
}

template <int DMAX, int KC>
static int fwd_mma(const CcmParams& p, cudaStream_t s) {
  const size_t smem = QLayout(p.D, p.nk + p.nc, false).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int e = set_smem(ccm_attention_fwd_mma_kernel<DMAX, KC>, smem);
  if (e) return e;
  dim3 grid(p.nq, p.Hq, p.B);
  ccm_attention_fwd_mma_kernel<DMAX, KC><<<grid, 128, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DMAX, int KC, int WD>
static int bwd_mma(const CcmParams& p, cudaStream_t s) {
  const size_t smem1 = QLayout(p.D, p.nk + p.nc, true).total;
  const size_t smem2 = KLayout(p.D, p.nq).total;
  if (smem1 > SMEM_MAX || smem2 > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int e = set_smem(ccm_attention_bwd_dq_mma_kernel<DMAX, KC>, smem1);
  if (e) return e;
  dim3 g1(p.nq, p.Hq, p.B);
  ccm_attention_bwd_dq_mma_kernel<DMAX, KC><<<g1, 128, smem1, s>>>(p);
  e = (int)cudaGetLastError();
  if (e) return e;
  e = set_smem(ccm_attention_bwd_dkdv_mma_kernel<DMAX, WD>, smem2);
  if (e) return e;
  const long long nblk = (long long)(p.nk + p.nc) * p.B * p.Hkv;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ccm_attention_bwd_dkdv_mma_kernel<DMAX, WD>
      <<<(unsigned)nblk, 128 * WD, smem2, s>>>(p);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched).  bf16: every tensor is bf16
// and the plan is set (the tensor-core route); else float32 (the
// CUDA-core route).  lse/delta are float32.
extern "C" int ccm_attention_fwd_launch(const CcmParams* params, int bf16,
                                        int device, void* stream) {
  const CcmParams& p = *params;
  if (bad(p) || (bf16 && bad_plan(p))) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (p.D <= 64) return fwd_mma<64, 64>(p, s);
    if (p.D <= 128) return fwd_mma<128, 64>(p, s);
    return fwd_mma<256, 32>(p, s);
  }
  if (p.D <= 64) return fwd<float, 2>(p, s);
  if (p.D <= 128) return fwd<float, 4>(p, s);
  return fwd<float, 8>(p, s);
}

extern "C" int ccm_attention_bwd_launch(const CcmParams* params, int bf16,
                                        int device, void* stream) {
  const CcmParams& p = *params;
  if (bad(p) || (bf16 && bad_plan(p))) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (p.D <= 64) return bwd_mma<64, 64, 1>(p, s);
    if (p.D <= 128) return bwd_mma<128, 64, 1>(p, s);
    return bwd_mma<256, 32, 2>(p, s);
  }
  if (p.D <= 64) return bwd<float, 2>(p, s);
  if (p.D <= 128) return bwd<float, 4>(p, s);
  return bwd<float, 8>(p, s);
}

extern "C" int ccm_attention_abi_size() { return (int)sizeof(CcmParams); }
