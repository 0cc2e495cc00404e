// Segmented flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (segmented_flash_attention, body _kernel).  A q tile attends an ordered
// list of in-place KV segments [mem | cache(:length) | self] with ONE
// running softmax (m, l, acc) in float32 across all segments; nothing is
// concatenated.  Python wrapper: repro_torch/kernels/decode_attention.py.
//
// What bounds it on the H100: at decode (Sq = 1) every key and value is
// read once per q head, so it is bound by device-memory bytes; at prefill
// (Sq in the hundreds) by the float32 operations of the two products.
// What the design does about it:
//   * one block per (lane, q head, q tile); the TPU's sequential k grid
//     axis is a loop inside the block over segments, then k tiles;
//   * a tile at or past the segment's per-lane valid length is never
//     loaded, and a tile whose keys are all masked for every q row of the
//     block (the CCM precheck) is skipped before its K/V loads: decode
//     work scales with cache occupancy, not capacity, with no host sync;
//   * K/V are read with 8-element vector loads and dequantized (int8 with
//     float32 per-(token, head) scales) into float32 shared-memory tiles;
//   * Sq <= 2 (decode) uses four warps that split each 128-key tile and
//     merge their partial softmax states at the end, so a block with one
//     q row keeps all its warps busy.  B * Hq blocks still fill the 132
//     SMs poorly at decode (128 blocks for B=4, Hq=32): a split-K layout
//     across blocks is the next step and is not done here.
// Segments are described by pointers plus explicit element strides for
// their lane, layer, token and head axes, so one code path reads
// (B,S,H,D), layer-major (L,B,S,H,D) and lane-major (B,L,S,H,D) stacks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_SEGS 4
#define MAX_D 256
#define NWARPS 4
#define NTHREADS (NWARPS * 32)
#define NEG_INF_F (-1e30f)

enum KvType { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2 };

struct SegDesc {
  const void* k;
  const void* v;
  const float* k_scale;     // int8 only
  const float* v_scale;
  const int* len_ptr;       // (B,) per-lane valid length, or null -> len
  const int* layer_ptr;     // (B,) per-lane layer id, or null -> layer
  const int* idx;           // per-token metadata; null = memory-like keys
  const int* seg;
  const int* comp;
  const int* valid;         // null = all valid
  long long k_lane, k_layer, k_tok, k_head;   // element strides
  long long v_lane, v_layer, v_tok, v_head;
  long long s_lane, s_layer, s_tok, s_head;   // scale strides (k and v)
  long long meta_lane;      // lane stride of idx/seg/comp (0 = shared)
  long long valid_lane;
  int len;
  int layer;
  int S;                    // tokens in the segment (capacity)
  int kv_type;
};

struct AttnParams {
  SegDesc seg[MAX_SEGS];
  const void* q;
  void* o;
  const int* q_idx;
  const int* q_seg;
  long long q_lane, q_tok, q_head;
  long long o_lane, o_tok, o_head;
  long long qm_lane;        // lane stride of q_idx/q_seg (0 = shared)
  int nseg, B, Sq, Hq, Hkv, D;
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

// 8 consecutive elements at element offset `off`, as float32.
__device__ __forceinline__ void load8(const void* base, long long off,
                                      int type, float scale, float out[8]) {
  if (type == KV_F32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    float4 a = p[0], b = p[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if (type == KV_BF16) {
    uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
    uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(base) + off);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = static_cast<float>(c[e]) * scale;
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

// ROWS q rows per warp; KSPLIT warps share one q row group and split each
// k tile between them.  Block: NWARPS warps, BQ = (NWARPS/KSPLIT)*ROWS q
// rows, BK = 32*KSPLIT keys per tile.
template <typename QT, int ROWS, int KSPLIT>
__global__ void __launch_bounds__(NTHREADS)
segmented_attention_kernel(const __grid_constant__ AttnParams p) {
  constexpr int BQ = (NWARPS / KSPLIT) * ROWS;
  constexpr int BK = 32 * KSPLIT;
  constexpr int NC = MAX_D / 32;
  const int D = p.D;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks_id = warp % KSPLIT, rbase = (warp / KSPLIT) * ROWS;

  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][D]
  float* Ks = qs + BQ * D;                   // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);             // [BK][D]
  int* kidx = reinterpret_cast<int*>(Vs + BK * D);
  int* kseg = kidx + BK;
  int* kcomp = kseg + BK;
  int* kok = kcomp + BK;
  int* qidx = kok + BK;
  int* qseg = qidx + BQ;

  const QT* q = static_cast<const QT*>(p.q);
  for (int i = tid; i < BQ * D; i += NTHREADS) {
    int r = i / D, d = i - r * D, row = q0 + r;
    qs[i] = row < p.Sq
        ? to_f32(q[b * p.q_lane + row * p.q_tok + h * p.q_head + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    int row = q0 + r;
    // padded q rows see no key (idx far below every key index)
    qidx[r] = row < p.Sq ? p.q_idx[b * p.qm_lane + row] : -(1 << 30);
    qseg[r] = row < p.Sq ? p.q_seg[b * p.qm_lane + row] : -3;
  }
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int si = 0; si < p.nseg; ++si) {
    const SegDesc& sd = p.seg[si];
    int len = sd.len_ptr ? sd.len_ptr[b] : sd.len;
    len = min(len, sd.S);
    if (len <= 0) continue;
    const long long layer = sd.layer_ptr ? sd.layer_ptr[b] : sd.layer;
    const long long kb = b * sd.k_lane + layer * sd.k_layer + hk * sd.k_head;
    const long long vb = b * sd.v_lane + layer * sd.v_layer + hk * sd.v_head;
    const long long sb = b * sd.s_lane + layer * sd.s_layer + hk * sd.s_head;
    const bool info = sd.idx != nullptr;
    const int ntiles = (len + BK - 1) / BK;

    for (int t = 0; t < ntiles; ++t) {
      const int start = t * BK;
      __syncthreads();                       // previous tile fully consumed
      int vis = 0;
      for (int j = tid; j < BK; j += NTHREADS) {
        int pos = start + j;
        int ok = pos < len;
        int ki = -1, kg = 0, kc = 1;
        if (info && ok) {
          ki = sd.idx[b * sd.meta_lane + pos];
          kg = sd.seg[b * sd.meta_lane + pos];
          kc = sd.comp[b * sd.meta_lane + pos] != 0;
          if (sd.valid) ok = sd.valid[b * sd.valid_lane + pos] != 0;
        }
        kidx[j] = ki; kseg[j] = kg; kcomp[j] = kc; kok[j] = ok;
        if (ok) {
          for (int r = 0; r < BQ; ++r)
            vis |= (ki <= qidx[r]) && (kg == qseg[r] || kc);
        }
      }
      // CCM tile precheck: no visible key for any q row -> skip the tile
      if (!__syncthreads_or(vis)) continue;

      const int D8 = D >> 3;
      for (int i = tid; i < BK * D8; i += NTHREADS) {
        int j = i / D8, d = (i - j * D8) * 8, pos = start + j;
        float kv8[8], vv8[8];
        if (kok[j]) {
          float ksc = 1.f, vsc = 1.f;
          if (sd.kv_type == KV_INT8) {
            ksc = sd.k_scale[sb + pos * sd.s_tok];
            vsc = sd.v_scale[sb + pos * sd.s_tok];
          }
          load8(sd.k, kb + pos * sd.k_tok + d, sd.kv_type, ksc, kv8);
          load8(sd.v, vb + pos * sd.v_tok + d, sd.kv_type, vsc, vv8);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) { kv8[e] = 0.f; vv8[e] = 0.f; }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          Ks[j * (D + 1) + d + e] = kv8[e];
          Vs[j * D + d + e] = vv8[e];
        }
      }
      __syncthreads();

      // this lane's key in the tile, scored against the warp's q rows
      const int j = ks_id * 32 + lane;
      float s[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
      const float* kr = Ks + j * (D + 1);
      for (int d = 0; d < D; ++d) {
        float kd = kr[d];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) s[i] += qs[(rbase + i) * D + d] * kd;
      }
      float pr[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        int r = rbase + i;
        bool mk = kok[j] && (kidx[j] <= qidx[r]) &&
                  (kseg[j] == qseg[r] || kcomp[j]);
        float sc = mk ? s[i] * p.scale : NEG_INF_F;
        float m_new = fmaxf(m[i], warp_max(sc));
        float alpha = expf(m[i] - m_new);
        pr[i] = mk ? expf(sc - m_new) : 0.f;
        l[i] = l[i] * alpha + warp_sum(pr[i]);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
      for (int jj = 0; jj < 32; ++jj) {
        float pj[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) pj[i] = __shfl_sync(0xffffffffu, pr[i], jj);
        const float* vr = Vs + (ks_id * 32 + jj) * D;
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
  }

  QT* o = static_cast<QT*>(p.o);
  if (KSPLIT > 1) {
    // merge the KSPLIT partial softmax states of each q row
    __syncthreads();
    float* red = smem;                       // [KSPLIT][BQ][D + 2]
    const int W = D + 2;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float* e = red + (ks_id * BQ + rbase + i) * W;
      if (lane == 0) { e[0] = m[i]; e[1] = l[i]; }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int d = lane + 32 * c;
        if (d < D) e[2 + d] = acc[i][c];
      }
    }
    __syncthreads();
    if (ks_id != 0) return;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      int r = rbase + i;
      float mm = NEG_INF_F;
      for (int k = 0; k < KSPLIT; ++k) mm = fmaxf(mm, red[(k * BQ + r) * W]);
      float ll = 0.f;
      for (int k = 0; k < KSPLIT; ++k) {
        const float* e = red + (k * BQ + r) * W;
        ll += e[1] * expf(e[0] - mm);
      }
      l[i] = ll;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int d = lane + 32 * c;
        float a = 0.f;
        if (d < D) {
          for (int k = 0; k < KSPLIT; ++k) {
            const float* e = red + (k * BQ + r) * W;
            a += e[2 + d] * expf(e[0] - mm);
          }
        }
        acc[i][c] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int row = q0 + rbase + i;
    if (row >= p.Sq) continue;
    // a fully masked row has l == 0 and acc == 0: it gives exactly 0
    float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int d = lane + 32 * c;
      if (d < D)
        store_out(o + b * p.o_lane + row * p.o_tok + h * p.o_head + d,
                  acc[i][c] * inv);
    }
  }
}

template <typename QT, int ROWS, int KSPLIT>
static int launch(const AttnParams& p, cudaStream_t stream) {
  constexpr int BQ = (NWARPS / KSPLIT) * ROWS;
  constexpr int BK = 32 * KSPLIT;
  size_t floats = (size_t)BQ * p.D + (size_t)BK * (p.D + 1) + (size_t)BK * p.D;
  size_t red = (size_t)KSPLIT * BQ * (p.D + 2);
  if (red > floats) floats = red;
  size_t smem = floats * sizeof(float) + (4 * BK + 2 * BQ) * sizeof(int);
  static size_t smem_set = 48 * 1024;   // largest opt-in made so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        segmented_attention_kernel<QT, ROWS, KSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  segmented_attention_kernel<QT, ROWS, KSPLIT>
      <<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched).  q_bf16: q and o are bf16
// (else float32).
extern "C" int segmented_attention_launch(const AttnParams* params,
                                          int q_bf16, int device,
                                          void* stream) {
  const AttnParams& p = *params;
  if (p.D <= 0 || p.D > MAX_D || (p.D & 7) || p.nseg < 1 ||
      p.nseg > MAX_SEGS || p.Hkv <= 0 || p.Hq % p.Hkv)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool decode = p.Sq <= 2 && p.D <= 128;
  if (q_bf16)
    return decode ? launch<__nv_bfloat16, 1, 4>(p, s)
                  : launch<__nv_bfloat16, 4, 1>(p, s);
  return decode ? launch<float, 1, 4>(p, s) : launch<float, 4, 1>(p, s);
}

extern "C" int segmented_attention_abi_size() { return (int)sizeof(AttnParams); }
