// Segmented flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (segmented_flash_attention, body _kernel).  A q tile attends an ordered
// list of in-place KV segments [mem | cache(:length) | self] with ONE
// running softmax (m, l, acc) in float32 across all segments; nothing is
// concatenated.  Python wrapper: repro_torch/kernels/decode_attention.py.
//
// What bounds it on the H100: at decode (Sq <= 2) the device-memory bytes
// of K and V (every valid key read once per kv head); at prefill (Sq in
// the hundreds) about equally the bytes and the two products' tensor-core
// operations.
//
// Common to every route: segments are pointers plus element strides for
// their lane, layer, token and head axes, so one code path reads
// (B,S,H,D), layer-major (L,B,S,H,D) and lane-major (B,L,S,H,D) stacks;
// per-lane lengths and layer ids are read on the device (no host sync); a
// tile at or past a segment's valid length is never loaded, and a tile
// with no key visible to any q row of the block (the exact CCM precheck)
// is skipped before its K/V loads; int8 K/V are dequantized with float32
// per-(token, head) scales; a fully masked row gives exactly 0.
//
// Three routes, chosen by the wrapper from q's dtype and Sq:
//   0. float32 q: segmented_attention_kernel<ROWS, KSPLIT>, CUDA cores,
//      float32 shared-memory tiles (the float32 cross-checks; 4 warps
//      split each key tile at Sq <= 2).
//   1. bf16 q, Sq <= 2 (decode): segmented_attention_splitk_kernel,
//      flash-decoding.  Grid (B * Hkv * head groups, n_split): a block
//      serves the G q heads of one kv head (K/V read once per kv head)
//      over 1/n_split of the lane's valid keys, with K/V in their storage
//      type in a 2-stage cp.async ring; its partial (m, l, acc) goes to a
//      float32 scratch and the last block of the (lane, kv head) combines
//      them in the same launch.  The wrapper picks n_split from the
//      segments' capacities: about 4 blocks per SM, >= 64 keys a split.
//   2. bf16 q, Sq > 2: segmented_attention_mma_kernel, FlashAttention-2
//      on mma.sync.m16n8k16 with bf16 K/V tiles double-buffered in shared
//      memory and the online softmax in registers.
// A bf16 call with float32 K/V is refused (cudaErrorInvalidValue; the
// wrapper raises before the launch).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"   // cp.async, ldmatrix, mma.sync helpers

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
template <int ROWS, int KSPLIT>
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

  const float* q = static_cast<const float*>(p.q);
  for (int i = tid; i < BQ * D; i += NTHREADS) {
    int r = i / D, d = i - r * D, row = q0 + r;
    qs[i] = row < p.Sq
        ? q[b * p.q_lane + row * p.q_tok + h * p.q_head + d] : 0.f;
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

  float* o = static_cast<float*>(p.o);
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
        o[b * p.o_lane + row * p.o_tok + h * p.o_head + d] = acc[i][c] * inv;
    }
  }
}

template <int ROWS, int KSPLIT>
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
        segmented_attention_kernel<ROWS, KSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  segmented_attention_kernel<ROWS, KSPLIT>
      <<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 q: pieces shared by the split-K decode and the mma.sync routes
// ---------------------------------------------------------------------------

#define TK 64                 // keys per tile of the mma.sync route
#define TKD 32                // keys per tile of the split-K decode route
#define MAX_SPLITS 32
#define SPLIT_ROWS 16         // q rows (heads x Sq) per split-K block, at most
#define LOG2E 1.4426950408889634f

// Per-block view of the segment list: for segment si the block reads the
// lane's keys [lo, hi) (the split-K route's share; the whole valid prefix
// otherwise) at element offsets kb / vb (K, V) and sb (int8 scales).
struct SegView {
  int lo[MAX_SEGS], hi[MAX_SEGS];
  long long kb[MAX_SEGS], vb[MAX_SEGS], sb[MAX_SEGS];
};

// Valid keys of segment si for lane b: min(length, capacity), >= 0.
__device__ __forceinline__ int seg_count(const SegDesc& sd, int b) {
  int len = sd.len_ptr ? sd.len_ptr[b] : sd.len;
  return max(0, min(len, sd.S));
}

// Thread 0 fills `v` for lane b and kv head hk.  The lane's valid keys,
// flattened over the segments in order, are cut into n_split equal
// chunks of ceil(total / n_split); split `split` takes its chunk.
// (n_split = 1: every valid key.)  repro_torch/kernels/decode_attention.py
// split_bounds is the same formula.
__device__ void seg_view(const AttnParams& p, int b, int hk, int split,
                         int n_split, SegView& v) {
  int total = 0;
  for (int si = 0; si < p.nseg; ++si) total += seg_count(p.seg[si], b);
  const int chunk = (total + n_split - 1) / n_split;
  const int k0 = min(split * chunk, total), k1 = min(k0 + chunk, total);
  int off = 0;
  for (int si = 0; si < p.nseg; ++si) {
    const SegDesc& sd = p.seg[si];
    const int n = seg_count(sd, b);
    v.lo[si] = min(max(k0 - off, 0), n);
    v.hi[si] = min(max(k1 - off, 0), n);
    off += n;
    const long long layer = sd.layer_ptr ? sd.layer_ptr[b] : sd.layer;
    v.kb[si] = b * sd.k_lane + layer * sd.k_layer + hk * sd.k_head;
    v.vb[si] = b * sd.v_lane + layer * sd.v_layer + hk * sd.v_head;
    v.sb[si] = b * sd.s_lane + layer * sd.s_layer + hk * sd.s_head;
  }
}

// Step (si, start) to the first tile start at or after it that holds a
// key of the block's range; false past the last segment.
__device__ __forceinline__ bool next_tile(const AttnParams& p,
                                          const SegView& v, int& si,
                                          int& start) {
  while (si < p.nseg && start >= v.hi[si]) {
    ++si;
    if (si < p.nseg) start = v.lo[si];
  }
  return si < p.nseg;
}

// Key metadata of one tile, in shared memory.
struct TileMeta {
  int idx[TK], seg[TK], comp[TK], ok[TK];
  float ks[TK], vs[TK];      // int8 scales (1 otherwise)
  int full;                  // every key ok and seen by every q row
};

// A summary of a block's valid q rows: the least and largest q_idx, and
// whether they all share one segment id (seg).
struct QRows {
  int lo, hi, uniform, seg;
};

// Threads 0..tk-1 load the metadata of keys [start, start + tk) of
// segment si (keys at or past hi, and invalid keys, are not ok).  Returns,
// to every thread, whether any ok key is visible to any of the nq query
// rows: the CCM tile precheck (idx <= q_idx and (same segment or <COMP>)).
// With a row summary qr, that test is decided from it where it can be
// (a key past every row's idx, a <COMP> key, rows of one segment) and
// t.full is set: whether every key is ok and seen by every valid row.
__device__ bool tile_meta(const AttnParams& p, const SegView& v, int b,
                          int si, int start, int tk, TileMeta& t,
                          const int* qidx, const int* qseg, int nq,
                          const QRows* qr = nullptr) {
  const SegDesc& sd = p.seg[si];
  int vis = 0, full = 1;
  const int j = threadIdx.x;
  if (j < tk) {
    const int pos = start + j;
    int ok = pos < v.hi[si];
    int ki = -1, kg = 0, kc = 1;
    if (ok && sd.idx) {
      const long long mo = b * sd.meta_lane + pos;
      ki = sd.idx[mo];
      kg = sd.seg[mo];
      kc = sd.comp[mo] != 0;
      if (sd.valid) ok = sd.valid[b * sd.valid_lane + pos] != 0;
    }
    float ks = 1.f, vs = 1.f;
    if (ok && sd.kv_type == KV_INT8) {
      ks = sd.k_scale[v.sb[si] + pos * sd.s_tok];
      vs = sd.v_scale[v.sb[si] + pos * sd.s_tok];
    }
    t.idx[j] = ki; t.seg[j] = kg; t.comp[j] = kc; t.ok[j] = ok;
    t.ks[j] = ks; t.vs[j] = vs;
    const bool own = qr && (kc || (qr->uniform && kg == qr->seg));
    if (!ok || (qr && ki > qr->hi))
      vis = 0;
    else if (own)
      vis = 1;                        // the row of the largest idx sees it
    else if (!qr || !qr->uniform)
      for (int r = 0; r < nq && !vis; ++r)
        vis = (ki <= qidx[r]) && (kg == qseg[r] || kc);
    full = ok && own && ki <= qr->lo;
  }
  const bool any = __syncthreads_or(vis) != 0;
  if (qr) {
    const int all = __syncthreads_and(full);
    if (threadIdx.x == 0) t.full = all;
  }
  return any;
}

// First tile of tk keys from (si, start) on whose keys some query row
// sees; its metadata lands in t.  Uniform across the block.
__device__ __forceinline__ bool find_tile(const AttnParams& p,
                                          const SegView& v, int b, int& si,
                                          int& start, int tk, TileMeta& t,
                                          const int* qidx, const int* qseg,
                                          int nq,
                                          const QRows* qr = nullptr) {
  while (next_tile(p, v, si, start)) {
    if (tile_meta(p, v, b, si, start, tk, t, qidx, qseg, nq, qr))
      return true;
    start += tk;
  }
  return false;
}

// ---------------------------------------------------------------------------
// route 1: split-K decode (bf16 q, Sq <= 2)
// ---------------------------------------------------------------------------
//
// Grid (B * Hkv * hgroups, n_split).  A block serves hpb q heads of one
// kv head (all G of them unless G * Sq > SPLIT_ROWS) over its share of the
// lane's valid keys, so K/V are read once per kv head.  K/V tiles of TKD
// keys stay in their storage type (bf16, or int8 with the float32 scales
// applied to the dot products and probabilities) in a 2-stage
// shared-memory ring filled by cp.async; dot products and the softmax run
// in float32.  QK: lane j of warp w dots every 4th 8-element chunk
// (from the w-th) of key j against every q row.  Softmax: warp w owns rows
// w, w + 4, ..., a key per lane.  PV: thread (dim pair, key group)
// accumulates its pair over a key group.  Tiles of 32 keys keep the
// ring at 35 KB (hd 128), so 4-5 blocks share an SM.
// The partials (m, l, acc) of every split go to a float32 scratch; the
// last block of a (lane, kv head) to finish (an atomic counter, reset by
// that block) combines them in the same launch.

struct DecLayout {           // byte offsets into dynamic shared memory
  int rs, ring, qf, sp, pp, alpha, meta, view, tok, ml, total;
  __host__ __device__ DecLayout(int D, int RM) {
    rs = 2 * D + ((D / 8) % 2 == 0 ? 16 : 32);   // odd multiple of 16 B
    ring = 0;                                    // [K0|K1|V0|V1][TKD][rs]
    qf = ring + 4 * TKD * rs;                    // float [RM][D]
    sp = qf + RM * D * 4;                        // float [4][RM][TKD]
    pp = sp + 4 * RM * TKD * 4;                  // float [RM][TKD]
    alpha = pp + RM * TKD * 4;                   // float [RM]
    meta = (alpha + RM * 4 + 15) & ~15;          // TileMeta [2]
    view = meta + 2 * (int)sizeof(TileMeta);     // SegView
    tok = (view + (int)sizeof(SegView) + 15) & ~15;  // int [2] idx, [2] seg
    ml = tok + 16;                               // float [RM][2]
    total = ml + RM * 8;
  }
};

// 8 consecutive K or V elements of a ring row as float32 (bf16 or int8).
__device__ __forceinline__ void row8(const uint8_t* row, int c, bool i8,
                                     float f[8]) {
  if (i8) {
    uint2 u = *reinterpret_cast<const uint2*>(row + c * 8);
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(e[i]);
  } else {
    uint4 u = *reinterpret_cast<const uint4*>(row + c * 16);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// Issue the loads of a tile's K and V rows into ring stage `st` (raw
// storage bytes, 8 elements per copy); keys that are not ok are zeroed.
__device__ __forceinline__ void dec_issue(const AttnParams& p,
                                          const SegView& v, int si,
                                          int start, const TileMeta& t,
                                          uint8_t* kst, uint8_t* vst, int rs) {
  const SegDesc& sd = p.seg[si];
  const int nch = p.D >> 3;
  const bool i8 = sd.kv_type == KV_INT8;
  const int es = i8 ? 1 : 2;
  for (int i = threadIdx.x; i < TKD * nch; i += blockDim.x) {
    const int j = i / nch, c = i - j * nch;
    uint8_t* kd = kst + j * rs + c * 8 * es;
    uint8_t* vd = vst + j * rs + c * 8 * es;
    if (t.ok[j]) {
      const long long pos = start + j;
      const uint8_t* ks = static_cast<const uint8_t*>(sd.k) +
                          (v.kb[si] + pos * sd.k_tok + c * 8) * es;
      const uint8_t* vs = static_cast<const uint8_t*>(sd.v) +
                          (v.vb[si] + pos * sd.v_tok + c * 8) * es;
      if (i8) {
        cp_async8(kd, ks);
        cp_async8(vd, vs);
      } else {
        cp_async16(kd, ks);
        cp_async16(vd, vs);
      }
    } else if (i8) {
      *reinterpret_cast<uint2*>(kd) = make_uint2(0, 0);
      *reinterpret_cast<uint2*>(vd) = make_uint2(0, 0);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(128, 4)
segmented_attention_splitk_kernel(const __grid_constant__ AttnParams p,
                                  int n_split, int hpb, int hgroups,
                                  float* __restrict__ part,
                                  int* __restrict__ counters) {
  constexpr int RI = (RM + 3) / 4;           // rows per warp
  const int D = p.D, G = p.Hq / p.Hkv, Sq = p.Sq;
  const int bx = blockIdx.x, split = blockIdx.y;
  const int hg = bx % hgroups, hk = (bx / hgroups) % p.Hkv;
  const int b = bx / (hgroups * p.Hkv);
  const int h0 = hk * G + hg * hpb;
  const int R = min(hpb, G - hg * hpb) * Sq;  // q rows of the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DecLayout L(D, RM);
  extern __shared__ __align__(16) uint8_t sm[];
  float* qf = reinterpret_cast<float*>(sm + L.qf);
  float* sp = reinterpret_cast<float*>(sm + L.sp);
  float* pp = reinterpret_cast<float*>(sm + L.pp);
  float* alpha_s = reinterpret_cast<float*>(sm + L.alpha);
  TileMeta* meta = reinterpret_cast<TileMeta*>(sm + L.meta);
  SegView& view = *reinterpret_cast<SegView*>(sm + L.view);
  int* tq = reinterpret_cast<int*>(sm + L.tok);          // idx[2], seg[2]
  float* ml = reinterpret_cast<float*>(sm + L.ml);

  if (tid == 0) seg_view(p, b, hk, split, n_split, view);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  for (int i = tid; i < R * D; i += 128) {
    const int r = i / D, d = i - r * D, g = r / Sq, tok = r - g * Sq;
    qf[i] = __bfloat162float(
        q[b * p.q_lane + tok * p.q_tok + (h0 + g) * p.q_head + d]);
  }
  if (tid < Sq) {
    tq[tid] = p.q_idx[b * p.qm_lane + tid];
    tq[2 + tid] = p.q_seg[b * p.qm_lane + tid];
  }
  __syncthreads();

  const float sl2 = p.scale * LOG2E;         // softmax in base 2
  float mrow[RI], lrow[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) { mrow[i] = -INFINITY; lrow[i] = 0.f; }
  const int NP = D / 2, NKG = min(4, 128 / NP);
  const int dp = tid % NP, kg = tid / NP;
  const bool pv = kg < NKG;
  float acc[RM][2];
#pragma unroll
  for (int r = 0; r < RM; ++r) { acc[r][0] = 0.f; acc[r][1] = 0.f; }

  int si = 0, start = view.lo[0], st = 0;
  bool have = find_tile(p, view, b, si, start, TKD, meta[0], tq, tq + 2,
                        Sq);
  if (have)
    dec_issue(p, view, si, start, meta[0], sm, sm + 2 * TKD * L.rs, L.rs);
  cp_commit();
  while (have) {
    int nsi = si, nstart = start + TKD;
    const bool nhave = find_tile(p, view, b, nsi, nstart, TKD, meta[st ^ 1],
                                 tq, tq + 2, Sq);
    if (nhave)
      dec_issue(p, view, nsi, nstart, meta[st ^ 1], sm + (st ^ 1) * TKD * L.rs,
                sm + (2 + (st ^ 1)) * TKD * L.rs, L.rs);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const TileMeta& t = meta[st];
    const uint8_t* kst = sm + st * TKD * L.rs;
    const uint8_t* vst = sm + (2 + st) * TKD * L.rs;
    const bool i8 = p.seg[si].kv_type == KV_INT8;
    const int ntk = min(TKD, view.hi[si] - start);
    {   // S = q K^T: warp `part` dots every 4th 8-element chunk of lane j's key
      const int j = lane, part = warp;
      float s[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) s[r] = 0.f;
      const uint8_t* kr = kst + j * L.rs;
      for (int c = part; c < (D >> 3); c += 4) {
        float kf[8];
        row8(kr, c, i8, kf);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < R) {
            const float4 a = *reinterpret_cast<const float4*>(qf + r * D + c * 8);
            const float4 bq = *reinterpret_cast<const float4*>(qf + r * D + c * 8 + 4);
            s[r] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                    bq.x * kf[4] + bq.y * kf[5] + bq.z * kf[6] + bq.w * kf[7];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
        if (r < R) sp[(part * RM + r) * TKD + j] = s[r];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {   // online softmax, warp per row
      const int r = warp + 4 * i;
      if (r < R) {
        const int tok = r % Sq;
        const int qi = tq[tok], qs = tq[2 + tok];
        const int j = lane;
        const bool vis = t.ok[j] && t.idx[j] <= qi &&
                         (t.seg[j] == qs || t.comp[j]);
        const float sc = vis ? (sp[r * TKD + j] + sp[(RM + r) * TKD + j] +
                                sp[(2 * RM + r) * TKD + j] +
                                sp[(3 * RM + r) * TKD + j]) * t.ks[j] * sl2
                             : -INFINITY;
        const float m_new = fmaxf(mrow[i], warp_max(sc));
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(mrow[i] - mu);
        const float psum = vis ? exp2f(sc - mu) : 0.f;
        pp[r * TKD + j] = psum * t.vs[j];
        lrow[i] = lrow[i] * alpha + warp_sum(psum);
        mrow[i] = m_new;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    if (pv) {                         // acc = alpha * acc + P V
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < R) {
          const float a = alpha_s[r];
          acc[r][0] *= a;
          acc[r][1] *= a;
        }
      }
      for (int j = kg; j < ntk; j += NKG) {
        float2 vv;
        if (i8) {
          const int8_t* e = reinterpret_cast<const int8_t*>(vst + j * L.rs) + 2 * dp;
          vv = make_float2(static_cast<float>(e[0]), static_cast<float>(e[1]));
        } else {
          vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              vst + j * L.rs + 4 * dp));
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < R) {
            const float pr = pp[r * TKD + j];
            acc[r][0] += pr * vv.x;
            acc[r][1] += pr * vv.y;
          }
        }
      }
    }
    __syncthreads();                  // stage st is free for the next loads
    si = nsi; start = nstart; have = nhave; st ^= 1;
  }
  cp_wait<0>();

  // sum the key groups' accumulators (the ring is free now)
  float* red = reinterpret_cast<float*>(sm);            // [NKG][RM][D]
  if (pv) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < R) {
        red[(kg * RM + r) * D + 2 * dp] = acc[r][0];
        red[(kg * RM + r) * D + 2 * dp + 1] = acc[r][1];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = warp + 4 * i;
    if (r < R && lane == 0) { ml[2 * r] = mrow[i]; ml[2 * r + 1] = lrow[i]; }
  }
  __syncthreads();
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  if (n_split == 1) {
    for (int e = tid; e < R * D; e += 128) {
      const int r = e / D, d = e - r * D, g = r / Sq, tok = r - g * Sq;
      float a = 0.f;
      for (int k = 0; k < NKG; ++k) a += red[(k * RM + r) * D + d];
      const float l = ml[2 * r + 1];
      // a row that saw no key has l == 0 and acc == 0: exactly 0
      o[b * p.o_lane + tok * p.o_tok + (h0 + g) * p.o_head + d] =
          __float2bfloat16(l > 0.f ? a / l : 0.f);
    }
    return;
  }
  const int W = D + 2;
  float* mine = part + (long long)(bx * n_split + split) * SPLIT_ROWS * W;
  for (int e = tid; e < R * D; e += 128) {
    const int r = e / D, d = e - r * D;
    float a = 0.f;
    for (int k = 0; k < NKG; ++k) a += red[(k * RM + r) * D + d];
    mine[r * W + 2 + d] = a;
  }
  if (tid < R) {
    const float l = ml[2 * tid + 1];
    mine[tid * W] = l > 0.f ? ml[2 * tid] : -INFINITY;   // empty: -inf, 0
    mine[tid * W + 1] = l;
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(&counters[bx], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: out = sum_s w_s acc_s / sum_s w_s l_s, with
  // w_s = 2^(m_s - max m) over the splits that saw a key
  const float* all = part + (long long)bx * n_split * SPLIT_ROWS * W;
  float* wts = red;                                      // [R][MAX_SPLITS]
  float* tot = red + SPLIT_ROWS * MAX_SPLITS;            // [R]
  if (tid < R) {
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) {
      const float* e = all + (s * SPLIT_ROWS + tid) * W;
      if (__ldcg(e + 1) > 0.f) mx = fmaxf(mx, __ldcg(e));
    }
    float lt = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* e = all + (s * SPLIT_ROWS + tid) * W;
      const float l = __ldcg(e + 1);
      const float w = l > 0.f ? exp2f(__ldcg(e) - mx) : 0.f;
      wts[tid * MAX_SPLITS + s] = w;
      lt += w * l;
    }
    tot[tid] = lt;
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += 128) {
    const int r = e / D, d = e - r * D, g = r / Sq, tok = r - g * Sq;
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += wts[r * MAX_SPLITS + s] * __ldcg(all + (s * SPLIT_ROWS + r) * W + 2 + d);
    const float lt = tot[r];
    o[b * p.o_lane + tok * p.o_tok + (h0 + g) * p.o_head + d] =
        __float2bfloat16(lt > 0.f ? a / lt : 0.f);
  }
  if (tid == 0) counters[bx] = 0;     // ready for the next launch
}

// ---------------------------------------------------------------------------
// route 2: FlashAttention-2 on mma.sync (bf16 q, Sq > 2)
// ---------------------------------------------------------------------------
//
// Grid (ceil(Sq / 64), Hq, B); 4 warps, 16 q rows each.  K/V tiles of TK
// keys in bf16 shared memory (rows padded to an odd number of 16-byte
// units: ldmatrix without bank conflicts), double-buffered: bf16 keys by
// cp.async, int8 keys dequantized into bf16 as they are stored.  S = Q K^T
// and O += P V run on mma.sync.m16n8k16 (bf16 in, float32 accumulated),
// fragments by ldmatrix (.trans for V); P is rounded to bf16 for the PV
// product, its row sums stay float32.  The CCM mask is built per element
// from the tile's metadata, except on a tile that every valid q row sees
// whole (decided, with the tile precheck, from a summary of the block's
// rows: least and largest q_idx, one segment or not); the per-lane
// length bound is as in route 1.  A head dim that is not a multiple of 16
// is zero-padded in the last k-step of Q K^T.

struct MmaLayout {           // byte offsets into dynamic shared memory
  int rse, q, ring, meta, view, qm, qr, total;
  __host__ __device__ MmaLayout(int D) {
    rse = ((D + 15) & ~15) + 8;                  // row stride, elements
    q = 0;                                       // bf16 [64][rse]
    ring = q + 64 * rse * 2;                     // bf16 [2][K|V][TK][rse]
    meta = ring + 4 * TK * rse * 2;              // TileMeta [2]
    view = meta + 2 * (int)sizeof(TileMeta);     // SegView
    qm = (view + (int)sizeof(SegView) + 15) & ~15;   // int [64] idx, [64] seg
    qr = qm + 2 * 64 * 4;                        // QRows
    total = qr + (int)sizeof(QRows);
  }
};

// Stage a tile's K and V rows as bf16 (cp.async for bf16 keys; int8 keys
// dequantized with their scales, four chunks' loads in flight per
// thread); keys that are not ok are zeroed.
__device__ __forceinline__ void mma_issue(const AttnParams& p,
                                          const SegView& v, int si,
                                          int start, const TileMeta& t,
                                          __nv_bfloat16* kst,
                                          __nv_bfloat16* vst, int rse) {
  const SegDesc& sd = p.seg[si];
  const int nch = p.D >> 3, n = TK * nch;
  if (sd.kv_type != KV_INT8) {
    // thread t copies chunk t % nch of rows t / nch, t / nch + per, ...
    const int per = blockDim.x / nch, c = threadIdx.x % nch;
    if (threadIdx.x >= per * nch) return;
    for (int j = threadIdx.x / nch; j < TK; j += per) {
      __nv_bfloat16* kd = kst + j * rse + c * 8;
      __nv_bfloat16* vd = vst + j * rse + c * 8;
      if (t.ok[j]) {
        const long long pos = start + j;
        cp_async16(kd, static_cast<const __nv_bfloat16*>(sd.k) + v.kb[si] +
                           pos * sd.k_tok + c * 8);
        cp_async16(vd, static_cast<const __nv_bfloat16*>(sd.v) + v.vb[si] +
                           pos * sd.v_tok + c * 8);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int8_t* kg = static_cast<const int8_t*>(sd.k);
  const int8_t* vg = static_cast<const int8_t*>(sd.v);
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * step) {
    uint2 ku[4], vu[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {        // loads first ...
      const int i = i0 + u * step, j = i / nch, c = i - j * nch;
      ku[u] = vu[u] = make_uint2(0, 0);
      if (i < n && t.ok[j]) {
        const long long pos = start + j;
        ku[u] = *reinterpret_cast<const uint2*>(kg + v.kb[si] + pos * sd.k_tok + c * 8);
        vu[u] = *reinterpret_cast<const uint2*>(vg + v.vb[si] + pos * sd.v_tok + c * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {        // ... then dequantize and store
      const int i = i0 + u * step, j = i / nch, c = i - j * nch;
      if (i >= n) break;
      const int8_t* ke = reinterpret_cast<const int8_t*>(&ku[u]);
      const int8_t* ve = reinterpret_cast<const int8_t*>(&vu[u]);
      uint4 kp, vp;
      uint32_t* kw = reinterpret_cast<uint32_t*>(&kp);
      uint32_t* vw = reinterpret_cast<uint32_t*>(&vp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kw[e] = pack_bf16(ke[2 * e] * t.ks[j], ke[2 * e + 1] * t.ks[j]);
        vw[e] = pack_bf16(ve[2 * e] * t.vs[j], ve[2 * e + 1] * t.vs[j]);
      }
      *reinterpret_cast<uint4*>(kst + j * rse + c * 8) = kp;
      *reinterpret_cast<uint4*>(vst + j * rse + c * 8) = vp;
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(128)
segmented_attention_mma_kernel(const __grid_constant__ AttnParams p) {
  constexpr int NDT = DMAX / 8, NKS = DMAX / 16;
  const int D = p.D, ndt = D / 8, nks = (D + 15) / 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const MmaLayout L(D);
  const int rse = L.rse;
  extern __shared__ __align__(16) uint8_t sm[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sm + L.q);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(sm + L.ring);
  TileMeta* meta = reinterpret_cast<TileMeta*>(sm + L.meta);
  SegView& view = *reinterpret_cast<SegView*>(sm + L.view);
  int* qidx = reinterpret_cast<int*>(sm + L.qm);
  int* qseg = qidx + 64;
  QRows* qr = reinterpret_cast<QRows*>(sm + L.qr);

  if (tid == 0) seg_view(p, b, hk, 0, 1, view);
  // the q tile by cp.async (its own group, ahead of the first K/V tile;
  // rows past Sq and the head-dim pad are 0) and its metadata; the K pad
  // columns of both stages are zeroed once (never loaded)
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int qch = rse >> 3;
  for (int i = tid; i < 64 * qch; i += 128) {
    const int r = i / qch, c = i - r * qch, row = q0 + r;
    __nv_bfloat16* dst = qs + r * rse + c * 8;
    if (row < p.Sq && c < (D >> 3))
      cp_async16(dst, q + b * p.q_lane + row * p.q_tok + h * p.q_head + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_commit();
  const int pad = rse - 8 - D;
  for (int i = tid; i < 2 * TK * pad; i += 128) {
    const int j = i / pad, d = D + (i - j * pad);
    const int stg = j / TK, jj = j - stg * TK;
    ring[(2 * stg) * TK * rse + jj * rse + d] = zero;    // K rows only
  }
  for (int r = tid; r < 64; r += 128) {
    const int row = q0 + r;
    // padded q rows see no key (idx far below every key index)
    qidx[r] = row < p.Sq ? p.q_idx[b * p.qm_lane + row] : -(1 << 30);
    qseg[r] = row < p.Sq ? p.q_seg[b * p.qm_lane + row] : -3;
  }
  __syncthreads();
  if (warp == 0) {                    // the valid rows' summary
    const int n = min(64, p.Sq - q0);
    int lo = INT_MAX, hi = INT_MIN, uni = 1;
    for (int r = lane; r < n; r += 32) {
      lo = min(lo, qidx[r]);
      hi = max(hi, qidx[r]);
      uni &= qseg[r] == qseg[0];
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    uni = __reduce_and_sync(0xffffffffu, uni);
    if (lane == 0) *qr = QRows{lo, hi, uni, qseg[0]};
  }
  __syncthreads();

  const int r0 = warp * 16 + g;               // this thread's rows r0, r0 + 8
  const int qi[2] = {qidx[r0], qidx[r0 + 8]};
  const int qg[2] = {qseg[r0], qseg[r0 + 8]};
  const float sl2 = p.scale * LOG2E;
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  int si = 0, start = 0, st = 0;
  bool have = find_tile(p, view, b, si, start, TK, meta[0], qidx, qseg, 64,
                        qr);
  if (have)
    mma_issue(p, view, si, start, meta[0], ring, ring + TK * rse, rse);
  cp_commit();
  while (have) {
    int nsi = si, nstart = start + TK;
    const bool nhave = find_tile(p, view, b, nsi, nstart, TK, meta[st ^ 1],
                                 qidx, qseg, 64, qr);
    if (nhave)
      mma_issue(p, view, nsi, nstart, meta[st ^ 1],
                ring + 2 * (st ^ 1) * TK * rse,
                ring + (2 * (st ^ 1) + 1) * TK * rse, rse);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const TileMeta& t = meta[st];
    const __nv_bfloat16* kst = ring + 2 * st * TK * rse;
    const __nv_bfloat16* vst = ring + (2 * st + 1) * TK * rse;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks < nks) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * rse + ks * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t bb[4];
          ldsm_x4(bb, kst + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) * rse +
                          ks * 16 + 8 * ((lane >> 3) & 1));
          mma16816(s[2 * n2], a, bb[0], bb[1]);
          mma16816(s[2 * n2 + 1], a, bb[2], bb[3]);
        }
      }
    }
    // CCM mask (none on a tile every row sees whole), online softmax
    // (base 2) over the tile's keys
    const bool full = t.full;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tq + (e & 1), hh = e >> 1;
        const bool vis = full || (t.ok[j] && t.idx[j] <= qi[hh] &&
                                  (t.seg[j] == qg[hh] || t.comp[j]));
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
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        s[n][e] = exp2f(s[n][e] - mu[hh]);       // masked: exp2(-inf) = 0
        lrow[hh] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    // O += P V: P's accumulator fragments are the A fragments of the
    // 16-key k-steps (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        if (n < ndt) {
          uint32_t bb[2];
          ldsm_x2_t(bb, vst + (kk * 16 + (lane & 15)) * rse + n * 8);
          mma16816(o[n], a, bb[0], bb[1]);
        }
      }
    }
    __syncthreads();                  // stage st is free for the next loads
    si = nsi; start = nstart; have = nhave; st ^= 1;
  }
  cp_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = lrow[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    // a row that saw no key has l == 0 and o == 0: exactly 0
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = q0 + r0 + 8 * hh;
    if (row >= p.Sq) continue;
    __nv_bfloat16* orow = out + b * p.o_lane + row * p.o_tok + h * p.o_head;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n < ndt)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  }
}

// dynamic shared memory above 48 KiB needs an opt-in per kernel
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t& set) {
  if (bytes <= set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}

template <int RM>
static int launch_splitk(const AttnParams& p, int n_split, int hpb,
                         int hgroups, float* part, int* counters,
                         cudaStream_t s) {
  static size_t set = 48 * 1024;
  const size_t smem = DecLayout(p.D, RM).total;
  cudaError_t e = allow_smem(segmented_attention_splitk_kernel<RM>, smem, set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.B * p.Hkv * hgroups, n_split);
  segmented_attention_splitk_kernel<RM><<<grid, 128, smem, s>>>(
      p, n_split, hpb, hgroups, part, counters);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int launch_mma(const AttnParams& p, cudaStream_t s) {
  static size_t set = 48 * 1024;
  const size_t smem = MmaLayout(p.D).total;
  cudaError_t e = allow_smem(segmented_attention_mma_kernel<DMAX>, smem, set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + 63) / 64, p.Hq, p.B);
  segmented_attention_mma_kernel<DMAX><<<grid, 128, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched).  route 0: float32 q and o;
// routes 1 (split-K decode, Sq <= 2) and 2 (mma.sync): bf16 q and o with
// bf16 or int8 K/V.  Route 1 takes n_split (<= MAX_SPLITS), hpb q heads
// per block (hpb * Sq <= SPLIT_ROWS) in hgroups groups of a kv head, and,
// when n_split > 1, a float32 scratch of B * Hkv * hgroups * n_split *
// SPLIT_ROWS * (D + 2) and B * Hkv * hgroups int32 counters that are 0.
extern "C" int segmented_attention_launch(const AttnParams* params, int route,
                                          int n_split, int hpb, int hgroups,
                                          void* part, void* counters,
                                          int device, void* stream) {
  const AttnParams& p = *params;
  if (p.D <= 0 || p.D > MAX_D || (p.D & 7) || p.nseg < 1 ||
      p.nseg > MAX_SEGS || p.Hkv <= 0 || p.Hq % p.Hkv || route < 0 ||
      route > 2)
    return (int)cudaErrorInvalidValue;
  if (route > 0)
    for (int si = 0; si < p.nseg; ++si)
      if (p.seg[si].kv_type == KV_F32) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const bool decode = p.Sq <= 2 && p.D <= 128;
    return decode ? launch<1, 4>(p, s) : launch<4, 1>(p, s);
  }
  if (route == 1) {
    const int G = p.Hq / p.Hkv;
    if (p.Sq > 2 || n_split < 1 || n_split > MAX_SPLITS || hpb < 1 ||
        hpb > G || hpb * p.Sq > SPLIT_ROWS || hgroups != (G + hpb - 1) / hpb ||
        (n_split > 1 && (!part || !counters)))
      return (int)cudaErrorInvalidValue;
    float* pt = static_cast<float*>(part);
    int* ct = static_cast<int*>(counters);
    return hpb * p.Sq <= 2 ? launch_splitk<2>(p, n_split, hpb, hgroups, pt, ct, s)
                           : launch_splitk<16>(p, n_split, hpb, hgroups, pt, ct, s);
  }
  return p.D <= 64 ? launch_mma<64>(p, s)
       : p.D <= 128 ? launch_mma<128>(p, s) : launch_mma<256>(p, s);
}

extern "C" int segmented_attention_abi_size() { return (int)sizeof(AttnParams); }
