// Fused conditional-LoRA matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/cond_lora.py
// (cond_lora_matmul, body _kernel):
//     y = x @ W (+ bias) + gate * ((x @ A^T) @ B) * scale
// x (M, K), W (K, N), A (r, K), B (r, N), gate (M,) float32, r <= 64.
// Python wrapper: repro_torch/kernels/cond_lora.py.
//
// What bounds it on the H100: at an online ingest (M = 288, K = N = 4096)
// the bytes (W read once, 33.5 MB) and the tensor-core operations take
// about the same least time (~0.01 ms); at a training step (M = 4864) the
// operations (0.16 ms at the bf16 peak).
//
// Two routes, chosen by the operands' dtype (not a fallback):
//   * bf16: cond_lora_wgmma_kernel.  Each block computes a 128 x 128
//     tile of y.  One producer thread keeps a ring of 4 shared-memory
//     stages full with TMA loads (cp.async.bulk.tensor, 128-byte swizzle,
//     completion on an mbarrier per stage): a 128 x 64 x tile, the
//     64 x 128 W tile as two 64-column boxes (W is (K, N), N contiguous:
//     an MN-major B operand that wgmma reads through its transpose bit,
//     so W is never copied), and the r_pad x 64 A tile (K-major).  Two
//     consumer warpgroups (64 rows each) run wgmma.mma_async m64n128k16
//     into float32 registers and, on the SAME x stage, r_pad / 8 more
//     m64n8k16 products against A, so x @ A^T accumulates in the k-loop
//     with no second pass over x and no extra launch (the TPU kernel's
//     fusion).  A stage is released to the producer once the products
//     of the next stage have been issued (wgmma.wait_group 1).  The
//     epilogue adds gate[row] * scale * (xa @ B_tile) on the CUDA cores
//     in float32 (r_pad multiply-adds per gated output), then the bias,
//     rounds once to bf16 and stores, masking the ragged M and N edges;
//     TMA's out-of-bounds zero fill pads the ragged M and K edges of the
//     loads.  Blocks walk the M-tiles of one N-column together, so the
//     re-reads of a W column hit the 50 MB L2 and W comes from HBM about
//     once.  Tensor maps are built on the host per call (W differs per
//     layer) and passed as __grid_constant__ parameters; the encoder is
//     fetched through cudaGetDriverEntryPoint, so the library needs no
//     -lcuda.  Takes any M, N, K >= 1 with K % 8 == 0 and N % 8 == 0
//     (TMA's 16-byte row strides); the wrapper zero-pads A and B to
//     r_pad = 8, 16, 32 or 64 rows (one instantiation each: a runtime
//     rank made ptxas serialize the wgmma chain).
//   * float32: cond_lora_kernel, the CUDA-core kernel: 64 x 64
//     output tiles, float32 shared-memory tiles, a 4 x 4 sub-tile per
//     thread, the rank-r product in the same K loop.  It serves the
//     float32 cross-checks; TF32 tensor cores would not meet their 1e-3
//     tolerance.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// float32: the CUDA-core route
// ---------------------------------------------------------------------------

#define FBM 64
#define FBN 64
#define BKT 16
#define NT 256
#define MAX_R 64
#define XA_PER_T (FBM * MAX_R / NT)

__global__ void __launch_bounds__(NT)
cond_lora_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ a, const float* __restrict__ bl,
                 const float* __restrict__ gate,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int M, int N, int K, int r, float scale) {
  __shared__ float xs[BKT][FBM + 1];      // x tile, transposed
  __shared__ float ws[BKT][FBN];
  __shared__ float as[MAX_R][BKT + 1];   // A tile (r x BKT)
  __shared__ float xa_s[FBM][MAX_R + 1];  // epilogue: x @ A^T of the tile
  __shared__ float bs[MAX_R][FBN];        // epilogue: B tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xa[XA_PER_T];
#pragma unroll
  for (int u = 0; u < XA_PER_T; ++u) xa[u] = 0.f;
  const int n_xa = FBM * r;               // (row, rank) entries of the tile

  for (int k0 = 0; k0 < K; k0 += BKT) {
    for (int i = tid; i < FBM * BKT; i += NT) {
      int mm = i / BKT, kk = i % BKT;
      int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < BKT * FBN; i += NT) {
      int kk = i / FBN, nn = i % FBN;
      int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0.f;
    }
    for (int i = tid; i < r * BKT; i += NT) {
      int rr = i / BKT, kk = i % BKT;
      int gk = k0 + kk;
      as[rr][kk] = gk < K ? a[(long long)rr * K + gk] : 0.f;
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
  for (int i = tid; i < r * FBN; i += NT) {
    int rr = i / FBN, nn = i % FBN, gn = n0 + nn;
    bs[rr][nn] = gn < N ? bl[(long long)rr * N + gn] : 0.f;
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
      if (bias) v += bias[gn];
      y[(long long)gm * N + gn] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the TMA + wgmma route
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128;              // rows per block: 2 consumer warpgroups
constexpr int BN = 128;              // columns per block
constexpr int BK = 64;               // k per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int X_BYTES = BM * BK * 2;             // 16 KiB
constexpr int W_BOX = BK * 64 * 2;               // one 64-column W box, 8 KiB
constexpr int W_BYTES = 2 * W_BOX;


struct Smem {                        // byte offsets from the 1024-aligned base
  int stage, bars, xa, bt, total;
  __host__ __device__ explicit Smem(int rp) {
    stage = X_BYTES + W_BYTES + rp * BK * 2;   // x | W | A, a 1024-multiple
    bars = STAGES * stage;                     // full[STAGES], empty[STAGES]
    xa = bars + 2 * STAGES * 8;                // float [BM][rp + 1]
    bt = xa + BM * (rp + 1) * 4;               // bf16 [rp][BN]
    total = bt + rp * BN * 2 + 1024;           // + alignment of the base
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// 2-D TMA load of one box at (c0 = inner, c1 = outer) into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands
// (x, A): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// 16-deep k-step advances the start address by 32 bytes.  The MN-major
// W tile: two 64-column boxes 8 KiB apart (LBO), 8 k-rows 1024 bytes
// apart (SBO); the k-step advances by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
       | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
       | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D (64 x 128, float32, in registers) += A (64 x 16, K-major) * B (16 x 128, MN-major),
// both bf16 in shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128_t(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 8, float32, in registers) += A (64 x 16, K-major) * B (16 x 8, K-major),
// both bf16 in shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n8(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <int NR>                    // rank r_pad = 8 * NR (1, 2, 4 or 8)
__global__ void __launch_bounds__(THREADS, 1)
cond_lora_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_a,
                       const __nv_bfloat16* __restrict__ bl,   // (rp, N)
                       const float* __restrict__ gate,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y,
                       int M, int N, int K, float scale, int m_tiles) {
  constexpr int rp = 8 * NR;
  const Smem L(rp);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  float* xa_s = reinterpret_cast<float*>(smem + L.xa);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + L.bt);

  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if (tid == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* st = smem + s * L.stage;
        mbar_expect_tx(&full[s], L.stage);
        tma_load(st, &tm_x, &full[s], kt * BK, m0);
        tma_load(st + X_BYTES, &tm_w, &full[s], n0, kt * BK);
        tma_load(st + X_BYTES + W_BOX, &tm_w, &full[s], n0 + 64, kt * BK);
        tma_load(st + X_BYTES + W_BYTES, &tm_a, &full[s], kt * BK, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [wg * 64, wg * 64 + 64) of the tile
  float acc[64];
  float xa[NR][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) xa[j][i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t st = smem_u32(smem + s * L.stage);
    const uint32_t xs = st + wg * 64 * 128;
    const uint32_t ws = st + X_BYTES;
    const uint32_t as = st + X_BYTES + W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc(xs + kk * 32, 16, 1024);
      wgmma_m64n128_t(acc, da, desc(ws + kk * 2048, W_BOX, 1024));
#pragma unroll
      for (int j = 0; j < NR; ++j)
        wgmma_m64n8(xa[j], da, desc(as + j * 1024 + kk * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();          // the previous stage's products are done
    if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // epilogue.  Accumulator layout of m64nNk16: thread (warp w, lane l)
  // holds rows w*16 + l/4 (+8) and columns 8j + 2(l%4) (+1).
  const int warp = tid / 32, lane = tid % 32;
  const int lrow = wg * 64 + warp * 16 + lane / 4;     // row in the tile
  const int lcol = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xa_s[(lrow + 8 * (i / 2)) * (rp + 1) + 8 * j + lcol + (i % 2)] = xa[j][i];
  for (int e = threadIdx.x; e < rp * (BN / 8); e += CONSUMERS * 128) {
    const int rr = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n0 + c8 < N)
      v = *reinterpret_cast<const uint4*>(bl + (long long)rr * N + n0 + c8);
    *reinterpret_cast<uint4*>(b_s + rr * BN + c8) = v;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS * 128) : "memory");

  float g[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + lrow + 8 * h;
    g[h] = row < M ? gate[row] * scale : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int c = jj * 8 + lcol, col = n0 + c;
    if (col >= N) continue;           // N % 8 == 0: col + 1 < N as well
    float2 bv = make_float2(0.f, 0.f);
    if (bias)
      bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + lrow + 8 * h;
      if (row >= M) continue;
      float v0 = acc[jj * 4 + 2 * h], v1 = acc[jj * 4 + 2 * h + 1];
      if (g[h] != 0.f) {
        const float* xr = xa_s + (lrow + 8 * h) * (rp + 1);
        float d0 = 0.f, d1 = 0.f;
#pragma unroll 4
        for (int rr = 0; rr < rp; ++rr) {
          const float2 b2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(b_s + rr * BN + c));
          d0 += xr[rr] * b2.x;
          d1 += xr[rr] * b2.y;
        }
        v0 += g[h] * d0;
        v1 += g[h] * d1;
      }
      *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
          __floats2bfloat162_rn(v0 + bv.x, v1 + bv.y);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (outer, inner) matrix, boxes of (box_outer, 64).
static bool make_map(CUtensorMap* m, const void* ptr, uint64_t inner,
                     uint64_t outer, uint32_t box_outer) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  cuuint64_t dims[2] = {inner, outer};
  cuuint64_t strides[1] = {inner * 2};
  cuuint32_t box[2] = {64, box_outer};
  cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NR>
static int launch_tc(const CUtensorMap& mx, const CUtensorMap& mw,
                     const CUtensorMap& ma, const void* b, const float* gate,
                     const void* bias, void* y, int M, int N, int K,
                     float scale, cudaStream_t s) {
  const Smem L(8 * NR);
  static bool allowed = false;       // the opt-in above 48 KiB, once
  if (!allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        cond_lora_wgmma_kernel<NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  cond_lora_wgmma_kernel<NR><<<m_tiles * n_tiles, THREADS, L.total, s>>>(
      mx, mw, ma, (const __nv_bfloat16*)b, gate, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)y, M, N, K, scale, m_tiles);
  return (int)cudaGetLastError();
}
}  // namespace tc

// Returns a cudaError_t code (0 = launched; -1: a tensor map could not be
// built).  bf16: every operand but gate is bf16, K % 8 == 0, N % 8 == 0,
// r in {8, 16, 32, 64} (A and B zero-padded) and 16-byte aligned data: the
// wgmma route.  Otherwise float32: the CUDA-core route.  gate is always
// float32; bias may be null.
extern "C" int cond_lora_launch(const void* x, const void* w, const void* a,
                                const void* b, const float* gate,
                                const void* bias, void* y, int M, int N,
                                int K, int r, float scale, int bf16,
                                int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || r <= 0 || r > MAX_R)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    CUtensorMap mx, mw, ma;
    if (!tc::make_map(&mx, x, K, M, tc::BM) ||
        !tc::make_map(&mw, w, N, K, tc::BK) ||
        !tc::make_map(&ma, a, K, r, r))
      return -1;
    switch (r) {
      case 8: return tc::launch_tc<1>(mx, mw, ma, b, gate, bias, y, M, N, K, scale, s);
      case 16: return tc::launch_tc<2>(mx, mw, ma, b, gate, bias, y, M, N, K, scale, s);
      case 32: return tc::launch_tc<4>(mx, mw, ma, b, gate, bias, y, M, N, K, scale, s);
      case 64: return tc::launch_tc<8>(mx, mw, ma, b, gate, bias, y, M, N, K, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  cond_lora_kernel<<<grid, NT, 0, s>>>(
      (const float*)x, (const float*)w, (const float*)a, (const float*)b,
      gate, (const float*)bias, (float*)y, M, N, K, r, scale);
  return (int)cudaGetLastError();
}
