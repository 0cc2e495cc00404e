// Fused conditional-LoRA matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/cond_lora.py
// (cond_lora_matmul, body _kernel):
//     y = x @ W (+ bias) + gate * ((x @ A^T) @ B) * scale
// x (M, K), W (K, N), A (r, K), B (r, N), gate (M,) float32, r <= 64.
// Python wrapper: repro_torch/kernels/cond_lora.py.
//
// What bounds it on the H100: at the ingest shape (M = 288, K = N = 4096)
// the bytes (W read once) and the operations take about the same least
// time; this first version runs its products on the CUDA cores in float32,
// so it is bound by their operations, far from either limit.
// What the design does: one block per 64 x 64 output tile; shared-memory
// tiles of x and W are converted to float32 and each thread accumulates a
// 4 x 4 sub-tile in registers over the K loop.  The rank-r product x @ A^T
// of the block's 64 rows accumulates in the SAME K loop from the same x
// tile, and the epilogue adds gate * (xa @ B_tile) * scale, so the LoRA
// delta costs no second pass over x and no extra launch.  Tensor cores
// (wgmma), TMA and split-K are left to a later version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define BM 64
#define BN 64
#define BKT 16
#define NT 256
#define MAX_R 64
#define XA_PER_T (BM * MAX_R / NT)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
cond_lora_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ a, const T* __restrict__ bl,
                 const float* __restrict__ gate, const T* __restrict__ bias,
                 T* __restrict__ y, int M, int N, int K, int r, float scale) {
  __shared__ float xs[BKT][BM + 1];      // x tile, transposed
  __shared__ float ws[BKT][BN];
  __shared__ float as[MAX_R][BKT + 1];   // A tile (r x BKT)
  __shared__ float xa_s[BM][MAX_R + 1];  // epilogue: x @ A^T of the tile
  __shared__ float bs[MAX_R][BN];        // epilogue: B tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xa[XA_PER_T];
#pragma unroll
  for (int u = 0; u < XA_PER_T; ++u) xa[u] = 0.f;
  const int n_xa = BM * r;               // (row, rank) entries of the tile

  for (int k0 = 0; k0 < K; k0 += BKT) {
    for (int i = tid; i < BM * BKT; i += NT) {
      int mm = i / BKT, kk = i % BKT;
      int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? to_f32(x[(long long)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BKT * BN; i += NT) {
      int kk = i / BN, nn = i % BN;
      int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N) ? to_f32(w[(long long)gk * N + gn]) : 0.f;
    }
    for (int i = tid; i < r * BKT; i += NT) {
      int rr = i / BKT, kk = i % BKT;
      int gk = k0 + kk;
      as[rr][kk] = gk < K ? to_f32(a[(long long)rr * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKT; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
    }
#pragma unroll
    for (int u = 0; u < XA_PER_T; ++u) {
      int e = tid + u * NT;
      if (e < n_xa) {
        int mm = e / r, rr = e % r;
        float s = 0.f;
#pragma unroll
        for (int kk = 0; kk < BKT; ++kk) s += xs[kk][mm] * as[rr][kk];
        xa[u] += s;
      }
    }
    __syncthreads();
  }

  // epilogue: delta = (xa @ B_tile) * scale, gated per row
#pragma unroll
  for (int u = 0; u < XA_PER_T; ++u) {
    int e = tid + u * NT;
    if (e < n_xa) xa_s[e / r][e % r] = xa[u];
  }
  for (int i = tid; i < r * BN; i += NT) {
    int rr = i / BN, nn = i % BN, gn = n0 + nn;
    bs[rr][nn] = gn < N ? to_f32(bl[(long long)rr * N + gn]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int mm = ty * 4 + i, gm = m0 + mm;
    if (gm >= M) continue;
    float g = gate[gm] * scale;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int nn = tx * 4 + j, gn = n0 + nn;
      if (gn >= N) continue;
      float d = 0.f;
      for (int rr = 0; rr < r; ++rr) d += xa_s[mm][rr] * bs[rr][nn];
      float v = acc[i][j] + g * d;
      if (bias) v += to_f32(bias[gn]);
      store_out(y + (long long)gm * N + gn, v);
    }
  }
}

// Returns a cudaError_t code (0 = launched).  bf16: every T operand is
// bf16 (else float32); gate is always float32; bias may be null.
extern "C" int cond_lora_launch(const void* x, const void* w, const void* a,
                                const void* b, const float* gate,
                                const void* bias, void* y, int M, int N,
                                int K, int r, float scale, int bf16,
                                int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || r <= 0 || r > MAX_R)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    typedef __nv_bfloat16 T;
    cond_lora_kernel<T><<<grid, NT, 0, s>>>(
        (const T*)x, (const T*)w, (const T*)a, (const T*)b, gate,
        (const T*)bias, (T*)y, M, N, K, r, scale);
  } else {
    cond_lora_kernel<float><<<grid, NT, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)a, (const float*)b,
        gate, (const float*)bias, (float*)y, M, N, K, r, scale);
  }
  return (int)cudaGetLastError();
}
