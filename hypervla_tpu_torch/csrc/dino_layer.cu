// DINOv2 serving trunk for Hopper (sm_90a): the kernels one transformer
// layer of the bs=1 serving trunk is made of.
//
// Replaces the Pallas TPU kernel hypervla_tpu/ops/dino_layer.py::
// dino_layers_serving (body `_kernel`), and computes what its shared
// numeric spec `_serving_layer_body` says: LayerNorm statistics and softmax
// in fp32, every dot as bf16 operands with an fp32 sum rounded once to bf16,
// biases added in bf16, exact GELU evaluated in fp32, LayerScale residuals
// in bf16. The wrapper (hypervla_tpu_torch/ops/dino_layer.py) launches, per
// layer: LN1, GEMM (QKV), attention, GEMM (out-proj + residual), LN2,
// GEMM (fc1 + GELU), GEMM (fc2 + residual).
//
// What bounds the trunk on this card: one step reads the ~170 MB of stacked
// bf16 weights once against ~44 GFLOP (2 x 86M params x 257 tokens), about
// 260 FLOP per byte, under the H100's ~295 FLOP/byte ridge: the floor is the
// weight read (~51 us at 3.35 TB/s). The GEMM is a pipelined `wgmma` kernel
// (see its note below). The LayerNorm and the attention are still their
// simple first versions: one block per row; K and V of one head held in
// shared memory, fp32 FMAs on the CUDA cores.
//
// The training layer (hypervla_tpu_torch/ops/dino_layer_train.py) and the
// training LayerNorm (ops/layer_norm.py) launch the same LayerNorm and GEMM
// at M = B*S rows: for them the LayerNorm also takes fp32 rows, and the
// GEMM has a second output, a no-bias form and an fp32 output (below).
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
// round an fp32 value to the nearest bf16 and back
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------- LayerNorm -------------------------------
// One block per row. flax fast variance: var = max(E[x^2] - mu^2, 0), then
// ((x - mu) * rsqrt(var + eps)) * scale + bias in fp32, rounded once to the
// input's type T (bf16 in the trunks; fp32 too for the training LayerNorm
// of ops/layer_norm.py, whose forward this kernel is).

constexpr int LN_THREADS = 256;

__device__ __forceinline__ float ln_load(const bf16* p) { return bf(*p); }
__device__ __forceinline__ float ln_load(const float* p) { return *p; }
__device__ __forceinline__ void ln_store(bf16* p, float v) { *p = tobf(v); }
__device__ __forceinline__ void ln_store(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(LN_THREADS) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int d, float eps) {
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float v = ln_load(xr + i);
    s += v;
    s2 += v * v;
  }
  __shared__ float red[2][LN_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < LN_THREADS / 32 ? red[0][lane] : 0.f;
    s2 = lane < LN_THREADS / 32 ? red[1][lane] : 0.f;
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][0] = s;
      red[1][0] = s2;
    }
  }
  __syncthreads();
  const float mu = red[0][0] / (float)d;
  const float var = fmaxf(red[1][0] / (float)d - mu * mu, 0.f);
  const float rs = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float y = (ln_load(xr + i) - mu) * rs;
    ln_store(orow + i, y * scale[i] + bias[i]);
  }
}

// ---------------------------- GEMM + epilogue ----------------------------
// out[M, N] = epilogue(A[M, K] @ B), A row-major (lda), B either [K, N]
// row-major (ldb) or, with TRANS_B, stored as B^T [N, K] row-major (ldb) —
// fc2 keeps W2^T and contracts on its dim 1. bf16 operands, fp32 sum.
// Epilogue, in order: round the fp32 sum to bf16; add bf16(bias) where a
// bias is given; then
//   EPI_NONE:     nothing
//   EPI_GELU:     x * 0.5 * (1 + erf(x / sqrt 2)) in fp32, rounded to bf16
//   EPI_RESIDUAL: residual + bf16(layer_scale) * y, each op rounded to bf16
//   EPI_F32:      none of the above: the fp32 sum itself, written as fp32
//                 (the layer backward's LayerNorm cotangents)
// With out2, EPI_GELU and EPI_RESIDUAL also write y as it was before the
// GELU or the LayerScale multiply: the residuals the training layer saves
// (ops/dino_layer_train.py), so that the saving forward and the plain one
// are the same arithmetic.
//
// What bounds it: at the training shape (M = 16448) the product is bound by
// operations (233 GFLOP a layer forward), at the serving shape (M = 257) by
// the weight read. The design is a Hopper one: the product runs on `wgmma`
// (m64nNk16, bf16 operands from shared memory, the fp32 sum in registers), fed
// by a ring of shared-memory stages that 16-byte `cp.async` groups (or TMA)
// fill while earlier stages are multiplied. A stage holds a BM x 64 tile of A
// and a 64 x BN tile of B in the 128-byte-swizzled layout the `wgmma`
// descriptor names: rows of 128 bytes, the 16-byte chunk c of row r stored at
// chunk c ^ (r & 7). A, and B with TRANS_B, are K-major (a row is 64 values of
// K); B as [K, N] is MN-major (a row is 64 values of N at one k, one 8 KB
// sub-tile per 64 columns) and the descriptor's transpose bit reads it as it
// lies, so neither form needs a transposed copy. Rows past M and columns past
// K are zero-filled (`cp.async` with a source size of 0; TMA clips its box).
// The epilogue starts from the accumulator registers: thread (warp w, lane 4g
// + t) of a warpgroup holds rows 16w + g and 16w + g + 8 and, for each
// 8-column group j, columns 8j + 2t and 8j + 2t + 1. The fp32 sums are staged
// once through the (by then free) ring so that bias, layer_scale, residual,
// out and out2 are read and written 16 bytes a thread along rows.
//
// This kernel's tile is 64 x 64 (one warpgroup, four stages): it serves
// small M, where the number of blocks matters more than the tile, and any N
// that is no multiple of 256; there K may be split over gridDim.z into fp32
// partial sums that `splitk_finish_kernel` adds in a fixed order before the
// same epilogue (no atomics; the sum is still rounded once). Large M with N
// a multiple of 256 (every product of the training layer) takes
// `gemm_tma_kernel` below: the same descriptors and epilogue on a 128 x 256
// tile, the ring filled by TMA from a producer warp. What is still open: a
// persistent grid that overlaps a tile's epilogue with the next tile's
// products (with K = 768 the epilogue is as long as the 12 k-tiles), and
// TMA stores.

constexpr int BK = 64;  // a stage's depth: one 128-byte swizzled row
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_F32 = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; without `pred` nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared-memory matrix descriptor of `wgmma` for a 128-byte-swizzled
// tile: start address, leading and stride byte offsets (each without its 4
// low bits), layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A . B for one k-step of 16: A 64 x 16 K-major, B 16 x N K-major or,
// with TNSP_B, MN-major; `accumulate` 0 overwrites d.
template <int TNSP_B>
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TNSP_B));
}
template <int TNSP_B>
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TNSP_B));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&y)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]),
                 pack2(y[6], y[7]));
}
__device__ __forceinline__ void load8(float (&y)[8], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  y[0] = a.x, y[1] = a.y, y[2] = a.z, y[3] = a.w;
  y[4] = b.x, y[5] = b.y, y[6] = b.z, y[7] = b.w;
}

// The epilogue of eight neighbouring columns (n a multiple of 8) of row m,
// from their fp32 sums v: 16-byte loads and stores throughout.
template <int EPI>
__device__ __forceinline__ void gemm_epilogue(
    const float (&v)[8], int m, int n, int N, const float* __restrict__ bias,
    const bf16* __restrict__ residual, const float* __restrict__ layer_scale,
    void* __restrict__ out, bf16* __restrict__ out2) {
  const size_t o = (size_t)m * N + n;
  if constexpr (EPI == EPI_F32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = rbf(v[i]);
    if (bias) {
      float b[8];
      load8(b, bias + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = rbf(y[i] + rbf(b[i]));
    }
    if (EPI != EPI_NONE && out2) store8(out2 + o, y);
    if (EPI == EPI_GELU) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = y[i] * (0.5f * (1.f + erff(y[i] * 0.70710678118654752f)));
    } else if (EPI == EPI_RESIDUAL) {
      float ls[8];
      load8(ls, layer_scale + n);
      const uint4 r = *reinterpret_cast<const uint4*>(residual + o);
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 rr =
            *reinterpret_cast<const __nv_bfloat162*>(&rw[i]);
        y[2 * i] = __low2float(rr) + rbf(rbf(ls[2 * i]) * y[2 * i]);
        y[2 * i + 1] =
            __high2float(rr) + rbf(rbf(ls[2 * i + 1]) * y[2 * i + 1]);
      }
    }
    store8(static_cast<bf16*>(out) + o, y);
  }
}

// gemm_kernel's tile: 64 x 64 outputs a block, one warpgroup, four stages
// of a 64-row A tile and a 64-column B tile each.
constexpr int BM = 64, BN = 64, GEMM_THREADS = 128, STAGES = 4;
constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// 1 KB of slack to align the ring to the swizzle's 1024-byte period
constexpr int GEMM_SMEM_BYTES = STAGES * STAGE_BYTES + 1024;

// grid (N / BN, ceil(M / BM), splits). With SPLIT the block multiplies its
// share of the k-tiles and writes the fp32 sums to partial[z][M][N].
template <bool TRANS_B, int EPI, bool SPLIT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, float* __restrict__ partial, int M, int N,
    int K) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int my_tiles = SPLIT ? k_tiles / (int)gridDim.z : k_tiles;
  const int first_tile = SPLIT ? (int)blockIdx.z * my_tiles : 0;

  auto load_stage = [&](int stage, int tile) {
    const uint32_t sa = ring + stage * STAGE_BYTES;
    const uint32_t sb = sa + A_BYTES;
    const int k0 = tile * BK;
    for (int v = tid; v < BM * 8; v += GEMM_THREADS) {
      const int r = v >> 3, c = v & 7;
      const bool in = m0 + r < M && k0 + c * 8 < K;
      const bf16* src = in ? A + (size_t)(m0 + r) * lda + k0 + c * 8 : A;
      cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4), src, in);
    }
    if (TRANS_B) {
      for (int v = tid; v < BN * 8; v += GEMM_THREADS) {
        const int r = v >> 3, c = v & 7;
        const bool in = k0 + c * 8 < K;
        const bf16* src = in ? B + (size_t)(n0 + r) * ldb + k0 + c * 8 : B;
        cp_async16(sb + r * 128 + ((c ^ (r & 7)) << 4), src, in);
      }
    } else {
      for (int v = tid; v < BK * 8; v += GEMM_THREADS) {
        const int r = v >> 3, c = v & 7;
        const bool in = k0 + r < K;
        const bf16* src = in ? B + (size_t)(k0 + r) * ldb + n0 + c * 8 : B;
        cp_async16(sb + r * 128 + ((c ^ (r & 7)) << 4), src, in);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < my_tiles) load_stage(s, first_tile + s);
    cp_async_commit();
  }
  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    // the copies above went through the generic proxy; wgmma reads shared
    // memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the stage tile i - 1 was multiplied from is free: every warp waited
    // for its wgmma before this barrier
    if (i + STAGES - 1 < my_tiles)
      load_stage((i + STAGES - 1) % STAGES, first_tile + i + STAGES - 1);
    cp_async_commit();

    const uint32_t sa = ring + (i % STAGES) * STAGE_BYTES;
    // K-major tiles: 1024 bytes from one 8-row group to the next; the
    // MN-major B tile: the same from one 8-k group to the next
    const uint64_t da = wgmma_desc(sa, 16, 1024);
    const uint64_t db = wgmma_desc(sa + A_BYTES, TRANS_B ? 16 : 8192, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // a k-step is 32 bytes along a K-major row, 16 rows of an MN-major
      // tile; the descriptor's address is in 16-byte units
      wgmma_k16<TRANS_B ? 0 : 1>(acc, da + kk * 2,
                                 db + (TRANS_B ? kk * 2 : kk * 128),
                                 (i | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // The sums go through shared memory (the ring is free now) so that
  // global memory sees 16-byte accesses along rows.
  constexpr int LDC = BN + 4;  // fp32 row of the staged tile
  float* Cs = reinterpret_cast<float*>(gemm_smem +
                                       (ring - smem_u32(gemm_smem)));
  __syncthreads();
  {
    const int warp = tid >> 5, lane = tid & 31;
    float* crow = Cs + (warp * 16 + (lane >> 2)) * LDC + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(crow + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(crow + 8 * LDC + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int v = tid; v < BM * (BN / 8); v += GEMM_THREADS) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) break;
    float sums[8];
    load8(sums, Cs + r * LDC + c);
    if (SPLIT)
      gemm_epilogue<EPI_F32>(sums, m, n, N, nullptr, nullptr, nullptr,
                             partial + (size_t)blockIdx.z * M * N, nullptr);
    else
      gemm_epilogue<EPI>(sums, m, n, N, bias, residual, layer_scale, out,
                         out2);
  }
}

// One thread per eight columns: adds the splits' partial sums in order,
// then the epilogue.
template <int EPI>
__global__ void __launch_bounds__(256) splitk_finish_kernel(
    const float* __restrict__ partial, int splits,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, int M, int N) {
  const size_t first = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  const size_t total = (size_t)M * N;
  if (first >= total) return;
  float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    float part[8];
    load8(part, partial + s * total + first);
#pragma unroll
    for (int i = 0; i < 8; ++i) sums[i] += part[i];
  }
  gemm_epilogue<EPI>(sums, (int)(first / N), (int)(first % N), N, bias,
                     residual, layer_scale, out, out2);
}

// The large-M kernel: a 128 x 256 tile, one producer warpgroup of which one
// thread keeps TMA loads of the next k-tiles in flight, two consumer
// warpgroups that multiply the tiles that have arrived (m64n256k16, each
// 64 x 256 of the tile, 128 accumulator registers a thread; `setmaxnreg`
// moves the producer's registers to them). TMA writes the same 128-byte
// swizzle the descriptors name, zero-fills rows past M and columns past K,
// and reports to the stage's `full` barrier; a consumer warp releases a
// stage to its `empty` barrier once the wgmma that read it has completed,
// one k-tile behind the one it has just issued. The epilogue is the one of
// gemm_kernel, staged through the ring by the 256 consumer threads.

constexpr int TMA_BM = 128, TMA_BN = 256, TMA_STAGES = 4;
constexpr int TMA_A_BYTES = TMA_BM * 128, TMA_B_BYTES = TMA_BN * 128;
constexpr int TMA_STAGE_BYTES = TMA_A_BYTES + TMA_B_BYTES;
// ring, 1 KB to align it, 2 x TMA_STAGES 8-byte barriers
constexpr int TMA_SMEM_BYTES = TMA_STAGES * TMA_STAGE_BYTES + 1024 + 64;

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival, and `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of the given parity has completed. A
// barrier that never completes traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}
// One box of the tensor map, its corner at (inner, outer), into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int inner,
                                            int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// grid (N / 256, ceil(M / 128)); 384 threads.
template <bool TRANS_B, int EPI>
__global__ void __launch_bounds__(384, 1) gemm_tma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, int M, int N, int K) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + TMA_STAGES * TMA_STAGE_BYTES;
  const uint32_t empty = full + 8 * TMA_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * TMA_BM, n0 = blockIdx.x * TMA_BN;
  const int k_tiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % TMA_STAGES;
        // the stage's previous tile (i - TMA_STAGES) has been multiplied
        if (i >= TMA_STAGES)
          mbar_wait(empty + 8 * s, (i / TMA_STAGES - 1) & 1);
        const uint32_t sa = ring + s * TMA_STAGE_BYTES;
        const uint32_t sb = sa + TMA_A_BYTES;
        mbar_expect_tx(full + 8 * s, TMA_STAGE_BYTES);
        tma_load_2d(sa, &map_a, full + 8 * s, i * BK, m0);
        if (TRANS_B) {
          tma_load_2d(sb, &map_b, full + 8 * s, i * BK, n0);
        } else {
#pragma unroll
          for (int j = 0; j < TMA_BN / 64; ++j)
            tma_load_2d(sb + j * 8192, &map_b, full + 8 * s, n0 + 64 * j,
                        i * BK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[TMA_BN / 2];
#pragma unroll
    for (int i = 0; i < TMA_BN / 2; ++i) acc[i] = 0.f;
    const int lane = tid & 31;
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % TMA_STAGES;
      mbar_wait(full + 8 * s, (i / TMA_STAGES) & 1);
      const uint32_t sa = ring + s * TMA_STAGE_BYTES;
      const uint64_t da = wgmma_desc(sa + wg * (64 * 128), 16, 1024);
      const uint64_t db = TRANS_B
                              ? wgmma_desc(sa + TMA_A_BYTES, 16, 1024)
                              : wgmma_desc(sa + TMA_A_BYTES, 8192, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_k16<TRANS_B ? 0 : 1>(acc, da + kk * 2,
                                   db + (TRANS_B ? kk * 2 : kk * 128),
                                   (i | kk) != 0);
      wgmma_commit();
      // tile i - 1's wgmma has completed: its stage may be refilled
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % TMA_STAGES));
    }
    wgmma_wait<0>();

    constexpr int LDC = TMA_BN + 4;  // fp32 row of the staged tile
    float* Cs = reinterpret_cast<float*>(gemm_smem +
                                         (ring - smem_u32(gemm_smem)));
    // barrier 1: the 256 consumer threads only
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    {
      const int warp = (tid >> 5) & 3;
      float* crow = Cs + (wg * 64 + warp * 16 + (lane >> 2)) * LDC +
                    2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < TMA_BN / 8; ++j) {
        *reinterpret_cast<float2*>(crow + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(crow + 8 * LDC + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int v = tid; v < TMA_BM * (TMA_BN / 8); v += 256) {
      const int r = v / (TMA_BN / 8), c = (v % (TMA_BN / 8)) * 8;
      if (m0 + r >= M) break;
      float sums[8];
      load8(sums, Cs + r * LDC + c);
      gemm_epilogue<EPI>(sums, m0 + r, n0 + c, N, bias, residual, layer_scale,
                         out, out2);
    }
  }
}

// ------------------------------- Attention -------------------------------
// Softmax attention of one head over all S tokens, head dim 64, no mask.
// One block per (head, 32 query rows); K and V of the head sit in dynamic
// shared memory (rows padded to 66 bf16 so lanes reading different keys
// hit different banks). One warp per query row: q is scaled by 0.125 in
// bf16; each score is an fp32 dot rounded to bf16; softmax in fp32 with the
// probabilities rounded to bf16; P.V summed in fp32, rounded to bf16.

constexpr int HD = 64;
constexpr int KV_LD = HD + 2;
constexpr int ATT_WARPS = 8;
constexpr int ATT_ROWS = 32;

__global__ void __launch_bounds__(ATT_WARPS * 32) attention_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int S,
    int hidden) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KV_LD;
  float* Ps = reinterpret_cast<float*>(Vs + (size_t)S * KV_LD);
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * ATT_ROWS;
  const int ld = 3 * hidden;

  for (int i = threadIdx.x; i < S * (HD / 2); i += blockDim.x) {
    const int s = i / (HD / 2), c = (i % (HD / 2)) * 2;
    const bf16* src = qkv + (size_t)s * ld + h * HD + c;
    *reinterpret_cast<uint32_t*>(&Ks[s * KV_LD + c]) =
        *reinterpret_cast<const uint32_t*>(src + hidden);
    *reinterpret_cast<uint32_t*>(&Vs[s * KV_LD + c]) =
        *reinterpret_cast<const uint32_t*>(src + 2 * hidden);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = Ps + (size_t)warp * S;
  for (int r = warp; r < ATT_ROWS; r += ATT_WARPS) {
    const int m = row0 + r;
    if (m >= S) break;
    const bf16* qrow = qkv + (size_t)m * ld + h * HD;
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = rbf(bf(qrow[d]) * 0.125f);

    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const bf16* kr = Ks + (size_t)j * KV_LD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const __nv_bfloat162 kv =
            *reinterpret_cast<const __nv_bfloat162*>(kr + d);
        acc = fmaf(q[d], __low2float(kv), acc);
        acc = fmaf(q[d + 1], __high2float(kv), acc);
      }
      const float sc = rbf(acc);
      p[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) p[j] = rbf(p[j] / sum);
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(
          Vs + (size_t)j * KV_LD + 2 * lane);
      o0 = fmaf(pj, __low2float(vv), o0);
      o1 = fmaf(pj, __high2float(vv), o1);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * hidden + h * HD +
                                       2 * lane) =
        __floats2bfloat162_rn(o0, o1);
    __syncwarp();
  }
}

// ----------------------------- C interface ------------------------------

// Launches one instantiation; the first launch of each raises its dynamic
// shared-memory limit above the 48 KB default.
template <bool TRANS_B, int EPI, bool SPLIT>
static cudaError_t launch_gemm(dim3 grid, cudaStream_t stream, const bf16* a,
                               int lda, const bf16* b, int ldb,
                               const float* bias, const bf16* residual,
                               const float* layer_scale, void* out,
                               bf16* out2, float* partial, int m, int n,
                               int k) {
  auto kernel = gemm_kernel<TRANS_B, EPI, SPLIT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, stream>>>(
      a, lda, b, ldb, bias, residual, layer_scale, out, out2, partial, m, n,
      k);
  return cudaGetLastError();
}

template <bool TRANS_B>
static cudaError_t launch_gemm_epilogue(int epilogue, dim3 grid,
                                        cudaStream_t stream, const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        const float* bias,
                                        const bf16* residual,
                                        const float* layer_scale, void* out,
                                        bf16* out2, int m, int n, int k) {
#define LAUNCH_GEMM(EPI)                                                  \
  return launch_gemm<TRANS_B, EPI, false>(grid, stream, a, lda, b, ldb,   \
                                          bias, residual, layer_scale,    \
                                          out, out2, nullptr, m, n, k)
  switch (epilogue) {
    case EPI_GELU: LAUNCH_GEMM(EPI_GELU);
    case EPI_RESIDUAL: LAUNCH_GEMM(EPI_RESIDUAL);
    case EPI_F32: LAUNCH_GEMM(EPI_F32);
    default: LAUNCH_GEMM(EPI_NONE);
  }
#undef LAUNCH_GEMM
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time: the CUDA runtime
// has loaded it into the process, and this library links the runtime only.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = (EncodeTiledFn)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// The map of a row-major bf16 matrix (rows x cols, row stride ld values)
// cut into boxes of box_rows x 64 columns, 128-byte swizzled in shared
// memory; what a box reaches past the matrix is filled with zeros.
static bool make_tensor_map(CUtensorMap* map, const bf16* base, int rows,
                            int cols, int ld, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TRANS_B, int EPI>
static cudaError_t launch_gemm_tma(cudaStream_t stream, const bf16* a,
                                   int lda, const bf16* b, int ldb,
                                   const float* bias, const bf16* residual,
                                   const float* layer_scale, void* out,
                                   bf16* out2, int m, int n, int k) {
  CUtensorMap map_a, map_b;
  // B^T is (n, k) in boxes of 256 rows; B is (k, n) in boxes of 64 rows
  if (!make_tensor_map(&map_a, a, m, k, lda, TMA_BM) ||
      !(TRANS_B ? make_tensor_map(&map_b, b, n, k, ldb, TMA_BN)
                : make_tensor_map(&map_b, b, k, n, ldb, 64)))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tma_kernel<TRANS_B, EPI>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n / TMA_BN, (m + TMA_BM - 1) / TMA_BM);
  kernel<<<grid, 384, TMA_SMEM_BYTES, stream>>>(
      map_a, map_b, bias, residual, layer_scale, out, out2, m, n, k);
  return cudaGetLastError();
}

template <bool TRANS_B>
static cudaError_t launch_gemm_tma_epilogue(int epilogue, cudaStream_t stream,
                                            const bf16* a, int lda,
                                            const bf16* b, int ldb,
                                            const float* bias,
                                            const bf16* residual,
                                            const float* layer_scale,
                                            void* out, bf16* out2, int m,
                                            int n, int k) {
#define LAUNCH_TMA(EPI)                                                   \
  return launch_gemm_tma<TRANS_B, EPI>(stream, a, lda, b, ldb, bias,      \
                                       residual, layer_scale, out, out2, \
                                       m, n, k)
  switch (epilogue) {
    case EPI_GELU: LAUNCH_TMA(EPI_GELU);
    case EPI_RESIDUAL: LAUNCH_TMA(EPI_RESIDUAL);
    case EPI_F32: LAUNCH_TMA(EPI_F32);
    default: LAUNCH_TMA(EPI_NONE);
  }
#undef LAUNCH_TMA
}

static cudaError_t launch_splitk_finish(int epilogue, cudaStream_t stream,
                                        const float* partial, int splits,
                                        const float* bias,
                                        const bf16* residual,
                                        const float* layer_scale, void* out,
                                        bf16* out2, int m, int n) {
  const size_t groups = (size_t)m * n / 8;
  const unsigned blocks = (unsigned)((groups + 255) / 256);
#define LAUNCH_FINISH(EPI)                                     \
  splitk_finish_kernel<EPI><<<blocks, 256, 0, stream>>>(       \
      partial, splits, bias, residual, layer_scale, out, out2, m, n); \
  break
  switch (epilogue) {
    case EPI_GELU: LAUNCH_FINISH(EPI_GELU);
    case EPI_RESIDUAL: LAUNCH_FINISH(EPI_RESIDUAL);
    case EPI_F32: LAUNCH_FINISH(EPI_F32);
    default: LAUNCH_FINISH(EPI_NONE);
  }
#undef LAUNCH_FINISH
  return cudaGetLastError();
}

extern "C" {

// x and out are fp32 with `is_f32`, else bf16.
int dino_layer_norm(const void* x, const void* scale, const void* bias,
                    void* out, int rows, int d, float eps, int is_f32,
                    void* stream) {
  if (is_f32)
    layer_norm_kernel<float><<<rows, LN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)scale, (const float*)bias,
        (float*)out, d, eps);
  else
    layer_norm_kernel<bf16><<<rows, LN_THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)out,
        d, eps);
  return (int)cudaGetLastError();
}

// block_n 256 selects the TMA kernel's 128 x 256 tile (n % 256 == 0), else
// the tile is 64 x 64 (n % 64 == 0); with split_k > 1 (64 x 64 only;
// split_k divides the number of 64-deep k-tiles) `partial` is fp32 scratch
// of split_k * m * n.
int dino_gemm(const void* a, int lda, const void* b, int ldb, int trans_b,
              const void* bias, const void* residual, const void* layer_scale,
              void* out, void* out2, int m, int n, int k, int epilogue,
              int block_n, int split_k, void* partial, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16 *pa = (const bf16*)a, *pb = (const bf16*)b;
  const float *pbias = (const float*)bias, *pls = (const float*)layer_scale;
  const bf16* pres = (const bf16*)residual;
  if (block_n == TMA_BN)
    return (int)(trans_b ? launch_gemm_tma_epilogue<true>(
                               epilogue, st, pa, lda, pb, ldb, pbias, pres,
                               pls, out, (bf16*)out2, m, n, k)
                         : launch_gemm_tma_epilogue<false>(
                               epilogue, st, pa, lda, pb, ldb, pbias, pres,
                               pls, out, (bf16*)out2, m, n, k));
  const dim3 grid(n / BN, (m + BM - 1) / BM, split_k);
  if (split_k == 1)
    return (int)(trans_b ? launch_gemm_epilogue<true>(
                               epilogue, grid, st, pa, lda, pb, ldb, pbias,
                               pres, pls, out, (bf16*)out2, m, n, k)
                         : launch_gemm_epilogue<false>(
                               epilogue, grid, st, pa, lda, pb, ldb, pbias,
                               pres, pls, out, (bf16*)out2, m, n, k));
  const cudaError_t err =
      trans_b ? launch_gemm<true, EPI_F32, true>(
                    grid, st, pa, lda, pb, ldb, nullptr, nullptr, nullptr,
                    nullptr, nullptr, (float*)partial, m, n, k)
              : launch_gemm<false, EPI_F32, true>(
                    grid, st, pa, lda, pb, ldb, nullptr, nullptr, nullptr,
                    nullptr, nullptr, (float*)partial, m, n, k);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_splitk_finish(epilogue, st, (const float*)partial,
                                   split_k, pbias, pres, pls, out,
                                   (bf16*)out2, m, n);
}

int dino_attention(const void* qkv, void* out, int seq, int hidden,
                   void* stream) {
  const size_t smem = (size_t)2 * seq * KV_LD * sizeof(bf16) +
                      (size_t)ATT_WARPS * seq * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hidden / HD, (seq + ATT_ROWS - 1) / ATT_ROWS);
  attention_kernel<<<grid, ATT_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, seq, hidden);
  return (int)cudaGetLastError();
}

}  // extern "C"
