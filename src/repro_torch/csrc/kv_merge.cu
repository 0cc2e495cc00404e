// CCM merge-mode memory update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/kv_merge.py:27
// (kv_merge_update, body _merge_kernel): the online g_update
//   Mem(t) = (1 - a_t) Mem(t-1) + a_t h(t),
// a_t = 1/t (arithmetic mean) or the EMA alpha, computed in float32 and
// rounded once to mem's dtype, IN PLACE.  One launch covers a whole
// g_update: the k and the v memory together, every lane with its own a_t.
// Python wrapper: repro_torch/kernels/kv_merge.py.
//
// What bounds it on the H100: device-memory bytes -- per element and
// tensor mem is read once, h read once and mem written once (3 passes),
// against 3 floating-point operations.  What the design does about it:
//   * each tensor is an (outer0, outer1, inner) array: mem contiguous,
//     h with two outer strides of its own and a unit inner stride, so the
//     lane-major transpose of an (L, B, m, Hkv, hd) h is read in place
//     and the caller makes no copy; the lane is outer0 or outer1, so
//     lane-major and layer-major memories both take per-lane weights;
//   * mem and h may be float32 or bf16 independently (no cast copy);
//   * block (x, y, z) takes chunk x of row y of tensor z, so a row's base
//     address and its lane's weight are worked out once per block and
//     no element index is ever divided; neighbouring threads touch
//     neighbouring 16-byte vectors (coalesced), and each thread keeps
//     UNROLL independent 16-byte loads of mem and of h in flight, held
//     raw in registers (63 at bf16, 4 blocks of 256 per SM: 1024 blocks
//     at the online shape are about two waves of the 132 SMs).  A grid
//     capped at 4-16 blocks per SM, other block sizes and unrolls, and
//     no cache-streaming hints all measured within 2% of this
//     on an H100 SXM (scripts/kv_merge_probe.py), at about 0.8 of the
//     bytes bound;
//   * an inner run that is not a multiple of the vector width, or a base
//     or stride that is not 16-byte aligned, takes the one-element path
//     (VEC = 1), chosen once per launch by the wrapper;
//   * the weights (at most MAX_LANES) travel by value in the launch's
//     parameter struct: no host-to-device copy precedes a launch.
// No shared memory and no tensor cores: there is no reuse.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LANES 256
#define NTHREADS 256
#define UNROLL 4

struct MergeParams {
  void* mem[2];             // contiguous (outer0, outer1, inner)
  const void* h[2];         // (outer0, outer1, inner), strides below
  long long h_s0[2];        // h's outer strides, in elements
  long long h_s1[2];
  long long inner;          // elements per (outer0, outer1) row
  int outer0, outer1;
  int n_tensors;            // 1 or 2 (k and v)
  int lane_axis;            // 0: lane = outer0; 1: lane = outer1; -1: a[0]
  int n_lanes;              // weights in a[]
  int mem_bf16, h_bf16;     // element types: 1 bf16, 0 float32
  int vec;                  // elements per thread access: the full width or 1
  float a[MAX_LANES];
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

// 16-byte accesses; every byte is touched once, so they stream past L1.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void st16(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// Block (x, y, z): chunks x, x + gridDim.x, ... of rows y, y + gridDim.y,
// ... of tensor z.  A chunk is NTHREADS * UNROLL accesses of VEC
// elements; thread t takes accesses t, t + NTHREADS, ... of it.  With
// VEC > 1 an access is VEC * sizeof(T) bytes as whole 16-byte vectors,
// held raw in registers from load to use.
template <typename TM, typename TH, int VEC>
__global__ void __launch_bounds__(NTHREADS)
kv_merge_kernel(const __grid_constant__ MergeParams p) {
  constexpr int NM = VEC > 1 ? VEC * (int)sizeof(TM) / 16 : 1;
  constexpr int NH = VEC > 1 ? VEC * (int)sizeof(TH) / 16 : 1;
  const int z = blockIdx.z;
  TM* __restrict__ mem = static_cast<TM*>(p.mem[z]);
  const TH* __restrict__ h = static_cast<const TH*>(p.h[z]);
  const long long rows = (long long)p.outer0 * p.outer1;
  const long long n_acc = p.inner / VEC;           // accesses per row
  const long long chunk = (long long)NTHREADS * UNROLL;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const int i0 = (int)(row / p.outer1), i1 = (int)(row % p.outer1);
    const float a = p.a[p.lane_axis == 0 ? i0 : p.lane_axis == 1 ? i1 : 0];
    const float b = 1.0f - a;
    TM* mrow = mem + row * p.inner;
    const TH* hrow = h + i0 * p.h_s0[z] + i1 * p.h_s1[z];
    for (long long base = (long long)blockIdx.x * chunk; base < n_acc;
         base += (long long)gridDim.x * chunk) {
      if constexpr (VEC > 1) {
        uint4 mr[UNROLL][NM], hr[UNROLL][NH];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = base + (long long)u * NTHREADS + threadIdx.x;
          if (j < n_acc) {
#pragma unroll
            for (int q = 0; q < NM; ++q)
              mr[u][q] = ld16(mrow + j * VEC + q * (16 / sizeof(TM)));
#pragma unroll
            for (int q = 0; q < NH; ++q)
              hr[u][q] = ld16(hrow + j * VEC + q * (16 / sizeof(TH)));
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = base + (long long)u * NTHREADS + threadIdx.x;
          if (j < n_acc) {
            const TM* me = reinterpret_cast<const TM*>(mr[u]);
            const TH* he = reinterpret_cast<const TH*>(hr[u]);
            uint4 out[NM];
            TM* oe = reinterpret_cast<TM*>(out);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              oe[k] = from_f32<TM>(b * to_f32(me[k]) + a * to_f32(he[k]));
#pragma unroll
            for (int q = 0; q < NM; ++q)
              st16(mrow + j * VEC + q * (16 / sizeof(TM)), out[q]);
          }
        }
      } else {
        TM mv[UNROLL];
        TH hv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = base + (long long)u * NTHREADS + threadIdx.x;
          if (j < n_acc) {
            mv[u] = mrow[j];
            hv[u] = hrow[j];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = base + (long long)u * NTHREADS + threadIdx.x;
          if (j < n_acc)
            mrow[j] = from_f32<TM>(b * to_f32(mv[u]) + a * to_f32(hv[u]));
        }
      }
    }
  }
}

// The full vector width: 16 bytes of the narrower element type.  One
// block per chunk and row, so no block loops in practice; the loops in the
// kernel cover grids past the hardware's limits.
template <typename TM, typename TH>
static cudaError_t launch_typed(const MergeParams& p, cudaStream_t st) {
  constexpr int FULL = 16 / (sizeof(TM) < sizeof(TH) ? sizeof(TM)
                                                      : sizeof(TH));
  const int vec = p.vec == FULL ? FULL : 1;
  const long long n_acc = p.inner / vec;
  const long long chunk = (long long)NTHREADS * UNROLL;
  long long chunks = (n_acc + chunk - 1) / chunk;
  long long rows = (long long)p.outer0 * p.outer1;
  if (rows > 65535) rows = 65535;
  if (chunks > 0x7fffffffLL) chunks = 0x7fffffffLL;
  dim3 grid((unsigned)chunks, (unsigned)rows, (unsigned)p.n_tensors);
  if (vec == FULL)
    kv_merge_kernel<TM, TH, FULL><<<grid, NTHREADS, 0, st>>>(p);
  else
    kv_merge_kernel<TM, TH, 1><<<grid, NTHREADS, 0, st>>>(p);
  return cudaGetLastError();
}

extern "C" int kv_merge_launch(const MergeParams* params, int device,
                               void* stream) {
  const MergeParams& p = *params;
  const int full = 16 / ((p.mem_bf16 || p.h_bf16) ? 2 : 4);
  if (p.n_tensors < 1 || p.n_tensors > 2 || p.outer0 < 1 || p.outer1 < 1 ||
      p.inner < 1 || p.n_lanes < 1 || p.n_lanes > MAX_LANES ||
      p.lane_axis < -1 || p.lane_axis > 1 ||
      (p.lane_axis == 0 && p.n_lanes != p.outer0) ||
      (p.lane_axis == 1 && p.n_lanes != p.outer1) ||
      (p.vec != full && p.vec != 1) || p.inner % p.vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.mem_bf16 && p.h_bf16)
    e = launch_typed<__nv_bfloat16, __nv_bfloat16>(p, st);
  else if (p.mem_bf16)
    e = launch_typed<__nv_bfloat16, float>(p, st);
  else if (p.h_bf16)
    e = launch_typed<float, __nv_bfloat16>(p, st);
  else
    e = launch_typed<float, float>(p, st);
  return (int)e;
}

extern "C" int kv_merge_abi_size() { return (int)sizeof(MergeParams); }
