// CCM merge-mode running mean over time for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/kv_merge.py:65
// (kv_cummean, body _cummean_kernel), the running mean that merge-mode
// parallel training folds the <COMP> groups into:
//   forward  out[n, t, :] = (sum_{i<=t} h[n, i, :]) / (t+1),
//   reverse  dh[n, t, :]  = sum_{j>=t} g[n, j, :] / (j+1)   (its gradient),
// accumulated in float32 and rounded once to the output's dtype.  One
// launch covers the k and the v groups of a layer together.  Python
// wrapper: repro_torch/kernels/kv_merge.py (kv_cummean_launch).
//
// What bounds it on the H100: device-memory bytes -- per element each
// input is read once and each output written once, against 2
// floating-point operations; there is no reuse, so no shared-memory
// tiles and no tensor cores.  T is short (16 steps at the paper's
// layout) and the columns are many (B * m * H * D), so the work is wide
// and shallow: what the design has to do is keep enough bytes in flight
// across all 132 SMs.  What the design does about it:
//   * each thread owns one 16-byte column vector of one outer row and
//     walks T itself, so the running sum stays in registers and no
//     element index is ever divided;
//   * the loads of CHUNK steps are all issued before the running sums
//     use any of them (held raw in registers), then the CHUNK outputs are
//     stored as 16-byte vectors; longer T loops over chunks.  At the
//     training shape (k + v, (4, 16, 32768) bf16 each: 256 blocks of 128
//     threads, about two per SM) this runs at about 0.73 of the bytes
//     bound on an H100 SXM (scripts/kv_merge_probe.py --cummean): 256
//     threads read 2-4% faster there but 6-8% slower on one (1, 16,
//     131072) tensor; 64 and 512 threads, shorter chunks, 8-byte
//     vectors, cache-streaming loads, the T split below and a grid
//     capped at one or two blocks per SM that loops were no faster;
//   * TSPLIT threads may share one column vector, each taking its own
//     CHUNK steps of a span of TSPLIT * CHUNK: they exchange their
//     chunk totals through shared memory, so the card has TSPLIT times
//     the threads at the same bytes in flight per thread.  TSPLIT is 1:
//     2 measured 1.3x slower and 4 no faster (the probe's variants);
//   * block (x, y, z) takes column block x of row y of tensor z: the k
//     and the v tensor are one launch, each an (N, T, R) array with its
//     own row and step strides and unit column stride, so the strided
//     <COMP> groups of a (B, S, H, D) activation and a gradient that is a
//     slice of a larger one are read in place; the outputs are
//     contiguous (N, T, R);
//   * an R that is not a multiple of the vector width, or a base or
//     stride that is not 16-byte aligned, takes the one-element path
//     (VEC = 1), chosen once per launch by the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 128
#define CHUNK 16
#define TSPLIT 1
#define VEC_BYTES 16

struct CumMeanParams {
  const void* h[2];         // (N, T, R) inputs, strides below
  void* out[2];             // contiguous (N, T, R) outputs
  long long s_n[2];         // input strides, in elements
  long long s_t[2];
  long long R;              // columns
  int N, T;
  int n_tensors;            // 1 or 2 (k and v)
  int reverse;              // 0: running mean; 1: its gradient
  int bf16;                 // element type: 1 bf16, 0 float32
  int vec;                  // elements per access: 16 bytes' worth or 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// The raw register type of one access of BYTES bytes.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// Block (x, y, z): column blocks x, x + gridDim.x, ... of rows y,
// y + gridDim.y, ... of tensor z.  Thread i takes column access
// xb * COLS + i % COLS of the row and steps part * CHUNK, ... of each
// span of TSPLIT * CHUNK (part = i / COLS), walked from t = 0 up
// (forward) or from t = T - 1 down (reverse).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
kv_cummean_kernel(const __grid_constant__ CumMeanParams p) {
  using R_t = typename Raw<VEC * (int)sizeof(T)>::type;
  constexpr int COLS = NTHREADS / TSPLIT;
  constexpr int SPAN = TSPLIT * CHUNK;
  const int z = blockIdx.z;
  const T* __restrict__ h = static_cast<const T*>(p.h[z]);
  T* __restrict__ out = static_cast<T*>(p.out[z]);
  const long long s_n = p.s_n[z], s_t = p.s_t[z], R = p.R;
  const int T_ = p.T, rev = p.reverse;
  const int col = threadIdx.x % COLS, part = threadIdx.x / COLS;
  const long long n_acc = R / VEC, n_blk = (n_acc + COLS - 1) / COLS;
  for (long long n = blockIdx.y; n < p.N; n += gridDim.y)
  for (long long xb = blockIdx.x; xb < n_blk; xb += gridDim.x) {
    const long long j = xb * COLS + col;
    const bool live = j < n_acc;
    const T* src = h + n * s_n + j * VEC;
    T* dst = out + n * T_ * R + j * VEC;
    float carry[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) carry[k] = 0.0f;
    for (int base = 0; base < T_; base += SPAN) {
      const int w0 = base + part * CHUNK;     // this thread's first step
      R_t raw[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int w = w0 + c;
        if (live && w < T_) {
          const int t = rev ? T_ - 1 - w : w;
          raw[c] = *reinterpret_cast<const R_t*>(src + t * s_t);
        }
      }
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = carry[k];
      if constexpr (TSPLIT > 1) {
        // each part's chunk total, then every earlier part's added in
        __shared__ float tot[TSPLIT][COLS][VEC];
        float loc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) loc[k] = 0.0f;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const int w = w0 + c;
          if (live && w < T_) {
            const T* e = reinterpret_cast<const T*>(&raw[c]);
            const float s = rev ? 1.0f / (float)(T_ - w) : 1.0f;
#pragma unroll
            for (int k = 0; k < VEC; ++k) loc[k] += to_f32(e[k]) * s;
          }
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) tot[part][col][k] = loc[k];
        __syncthreads();
#pragma unroll
        for (int q = 0; q < TSPLIT; ++q) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float v = tot[q][col][k];
            if (q < part) acc[k] += v;
            carry[k] += v;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int w = w0 + c;
        if (live && w < T_) {
          const int t = rev ? T_ - 1 - w : w;
          const float inv = 1.0f / (float)(t + 1);
          const T* e = reinterpret_cast<const T*>(&raw[c]);
          R_t o;
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (rev) {
              acc[k] += to_f32(e[k]) * inv;
              oe[k] = from_f32<T>(acc[k]);
            } else {
              acc[k] += to_f32(e[k]);
              oe[k] = from_f32<T>(acc[k] * inv);
            }
          }
          *reinterpret_cast<R_t*>(dst + t * R) = o;
        }
      }
      if constexpr (TSPLIT == 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) carry[k] = acc[k];
      }
    }
  }
}

// One block per column block and row, so no block loops in practice; the
// loops in the kernel cover grids past the hardware's limits.
template <typename T>
static cudaError_t launch_typed(const CumMeanParams& p, cudaStream_t st) {
  constexpr int FULL = VEC_BYTES / (int)sizeof(T);
  const int vec = p.vec == 1 ? 1 : FULL;
  constexpr int COLS = NTHREADS / TSPLIT;
  long long blocks = (p.R / vec + COLS - 1) / COLS;
  const unsigned rows = p.N > 65535 ? 65535u : (unsigned)p.N;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  dim3 grid((unsigned)blocks, rows, (unsigned)p.n_tensors);
  if (vec == 1)
    kv_cummean_kernel<T, 1><<<grid, NTHREADS, 0, st>>>(p);
  else
    kv_cummean_kernel<T, FULL><<<grid, NTHREADS, 0, st>>>(p);
  return cudaGetLastError();
}

extern "C" int kv_cummean_launch(const CumMeanParams* params, int device,
                                 void* stream) {
  const CumMeanParams& p = *params;
  const int full = 16 / (p.bf16 ? 2 : 4);
  if (p.n_tensors < 1 || p.n_tensors > 2 || p.N < 1 || p.T < 1 ||
      p.R < 1 || (p.vec != full && p.vec != 1) || p.R % p.vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = p.bf16 ? launch_typed<__nv_bfloat16>(p, st)
             : launch_typed<float>(p, st);
  return (int)e;
}

extern "C" int kv_cummean_abi_size() { return (int)sizeof(CumMeanParams); }
