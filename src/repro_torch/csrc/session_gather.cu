// Session-arena row gather / scatter for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels repro/kernels/session_gather.py
// (session_gather and session_scatter, body _copy_kernel / _scatter_kernel):
//   gather  : rows[i]      = slab[ids[i]]   (pack a batch out of the arena)
//   scatter : slab[ids[i]] = rows[i]        (unpack it back, in place)
// Python wrapper: repro_torch/kernels/session_gather.py.
//
// What bounds it on the H100: device-memory bytes and nothing else -- each
// selected row is read once and written once, with no arithmetic (bound =
// 2 * B * row_bytes / 3.35 TB/s).  What the design does about it:
//   * every slab leaf is an (S, row_bytes) byte matrix, so one kernel
//     serves bf16, float32, int8 and int32 leaves alike;
//   * the grid is (B, column chunks): block (i, c) copies chunk c of row
//     i, so even B = 1 puts thousands of blocks on the 132 SMs for an
//     LLaMA-7B cache row (64 MiB) and no block waits on another;
//   * threads move 16-byte vectors when both row bases and row_bytes are
//     16-byte aligned (the arena's leaves always are), else 8-, 4-, 2- or
//     1-byte units -- the widest the alignment allows, chosen once per
//     launch by the wrapper; neighbouring threads touch neighbouring
//     addresses, so every warp access is coalesced;
//   * the slot ids come from the host, which holds them as a Python list
//     anyway: up to MAX_IDS of them travel by value in the kernel's
//     parameter struct, so no host-to-device copy precedes a launch.
// Duplicate destination ids in a scatter (batch pad lanes all aim at the
// arena's scratch row) race; any one writer per byte wins, as on the TPU.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_IDS 256
#define NTHREADS 256
#define UNROLL 4

struct CopyParams {
  const char* src;          // gather: the slab; scatter: the packed rows
  char* dst;                // gather: the packed rows; scatter: the slab
  long long row_bytes;
  int n;                    // rows to copy (B)
  int scatter;              // 0: dst[i] <- src[ids[i]]; 1: dst[ids[i]] <- src[i]
  int unit;                 // bytes per thread access: 16, 8, 4, 2 or 1
  int ids[MAX_IDS];
};

template <typename U>
__device__ __forceinline__ void copy_row(const char* __restrict__ src,
                                         char* __restrict__ dst,
                                         long long row_bytes) {
  const long long n_units = row_bytes / (long long)sizeof(U);
  const long long chunk = (long long)NTHREADS * UNROLL;   // units per block
  const U* s = reinterpret_cast<const U*>(src);
  U* d = reinterpret_cast<U*>(dst);
  for (long long base = (long long)blockIdx.y * chunk; base < n_units;
       base += (long long)gridDim.y * chunk) {
    U v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      long long j = base + (long long)u * NTHREADS + threadIdx.x;
      if (j < n_units) v[u] = s[j];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      long long j = base + (long long)u * NTHREADS + threadIdx.x;
      if (j < n_units) d[j] = v[u];
    }
  }
}

// One kernel per direction (SCATTER), so a profile tells them apart.
template <bool SCATTER>
__global__ void __launch_bounds__(NTHREADS)
session_copy_kernel(const CopyParams p) {
  const int i = blockIdx.x;
  const long long src_row = SCATTER ? i : p.ids[i];
  const long long dst_row = SCATTER ? p.ids[i] : i;
  const char* src = p.src + src_row * p.row_bytes;
  char* dst = p.dst + dst_row * p.row_bytes;
  switch (p.unit) {   // uniform across the launch: no divergence
    case 16: copy_row<uint4>(src, dst, p.row_bytes); break;
    case 8: copy_row<uint2>(src, dst, p.row_bytes); break;
    case 4: copy_row<uint32_t>(src, dst, p.row_bytes); break;
    case 2: copy_row<uint16_t>(src, dst, p.row_bytes); break;
    default: copy_row<uint8_t>(src, dst, p.row_bytes); break;
  }
}

extern "C" int session_copy_launch(const CopyParams* params, int device,
                                   void* stream) {
  const CopyParams& p = *params;
  if (p.n < 1 || p.n > MAX_IDS || p.row_bytes <= 0 ||
      (p.unit != 16 && p.unit != 8 && p.unit != 4 && p.unit != 2 &&
       p.unit != 1) || p.row_bytes % p.unit)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long chunk_bytes = (long long)NTHREADS * UNROLL * p.unit;
  long long chunks = (p.row_bytes + chunk_bytes - 1) / chunk_bytes;
  if (chunks > 65535) chunks = 65535;     // the y loop covers the rest
  dim3 grid((unsigned)p.n, (unsigned)chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.scatter)
    session_copy_kernel<true><<<grid, NTHREADS, 0, st>>>(p);
  else
    session_copy_kernel<false><<<grid, NTHREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int session_copy_abi_size() { return (int)sizeof(CopyParams); }
