// Differentiable attention for Hopper (sm_90a): a forward and a backward
// that never write the probabilities P to global memory.
//
// Replaces no Pallas kernel of this repository: it is the counterpart of
// hypervla_tpu/ops/flash_attention.py::mha_flash_trainable, which on a TPU
// calls jax's library flash attention (whose VJP recomputes P) and
// elsewhere runs an einsum attention. What it computes is that einsum
// function and its VJP, with their rounding points, for T = bf16 or fp32
// inputs over (batch, seq, heads, head_dim):
//   forward   qs = fp32(q) * scale (scale = fp32(1 / sqrt(d)));
//             s = qs . fp32(k)^T in fp32; m = max s; e = exp(s - m);
//             n = sum e; p = e / n; o = T(T(p) . v) with an fp32 sum;
//   backward  dv = T(T(p)^T . g); dp = fp32(T(g . v^T));
//             r = sum_k (dp * (1 / (n * n))) * e;
//             ds = (dp / n - r) * e in fp32;
//             dq = T(fp32(ds . k) * scale); dk = T(ds^T . qs).
// For fp32 inputs every T is the identity.
//
// The forward saves only the row max m and the row sum n (fp32, B x H x S)
// beside q, k, v. Because p is rounded after the division by n, the
// forward takes two sweeps over the keys: the first finds m and n (the
// streaming maximum and rescaled sum), the second recomputes s and p and
// multiplies T(p) by v. The backward is two kernels:
//   * the dq kernel, one block per query block, sweeps the keys twice:
//     first for the row term r (which cannot come from rowsum(g * o), as
//     o was built from the rounded p and rounded again), then for dq; it
//     writes each row's (-m log2(e), 1 / n, r) to a scratch;
//   * the dk/dv kernel, one block per key block, loops over the query
//     tiles and reads those row terms.
// Every sum runs in a fixed order: no atomics, and two runs repeat bit for
// bit.
//
// bf16 inputs run on the bf16 tensor cores without changing the function,
// because a product of two bf16 values is exact in fp32. An fp32 operand
// is split into three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), whose sum is x exactly, each term one more product
// into the same fp32 sum: ds in dq and dk (ds is fp32 in the function),
// and qs where the scale is no power of two (head dims 32, 128). Where it
// is one (16, 64), qs = q * scale exactly: the products take q itself and
// the fp32 scores (and dk) are multiplied by the scale after, which is the
// same value.
//
// The bf16 kernels are a design for Hopper (the first version ran
// `mma.sync` on 64 x 64 tiles with one stage of loads):
//   * Tiles cut to the live extent. A block holds 64 rows (queries for the
//     forward and dq, keys for dk/dv), or 32 or 16 where 64-row blocks
//     would leave multiprocessors idle (ops/flash_attention_train.py::
//     flash_train_plan: serving's 12 heads of 257 tokens take 204 blocks
//     of 16). A block whose live rows fill its four warps multiplies on
//     `wgmma` (m64nNk16, one warpgroup); any other block multiplies each
//     warp with live rows on `mma.sync.m16n8k16` from the same shared
//     tiles, and a warp whose rows all lie past S does no products. The
//     last key (dk/dv: query) tile's products are 16, 32, 48 or 64 wide and
//     its exponentials skip the 8-key groups past S: at S = 257 a head's
//     score tiles are 272 x 264 against 257^2 (1.09x; the first version's
//     320^2, 1.55x).
//   * A ring of two stages: tile i + 1 lands while tile i is multiplied
//     (K and V in the forward and the dq kernel; q's terms, g and the row
//     terms in the dk/dv kernel). Where d is the tiles' width (64, 128) and
//     the operands are 16-byte aligned, one thread copies a stage by TMA
//     (a 3-D map, batch by batch, so that a box past S arrives as zeros)
//     and every thread waits on the stage's `mbarrier`. Otherwise the
//     threads copy it by 16-byte `cp.async`, zero-filling past S (plain
//     loads where d is no multiple of 8 or an operand is unaligned), a
//     thread's chunks a fixed stride apart so that the index arithmetic is
//     done once. Two stages leave room for the three or four blocks a
//     multiprocessor holds; three measured slower. The tiles are 128-byte
//     swizzled, the layout of TMA's SWIZZLE_128B and of `wgmma`'s
//     descriptors, and are read in place as K-major operands (the scores,
//     dp) or MN-major ones (P.V, ds.K, P^T.g, ds^T.qs).
//   * The dk/dv kernel computes its tiles in the keys' orientation, s^T =
//     K . qs^T and dp^T = V . g^T, so that P^T and ds^T are, register for
//     register, the A operands of dv and dk: nothing is transposed through
//     shared memory. Its scores sum in another order than the forward's, so
//     its e may differ from the forward's in the last bits; the kernels'
//     bounds against the plain versions hold (tests/
//     test_torch_flash_trainable_cuda.py, chip_smoke.py).
//   * qs's terms are formed once per query block. Where there are three,
//     the dq kernel also writes them to a scratch that the dk/dv kernel
//     loads; where there is one, every kernel takes q itself.
//   * e = 2^(x cl + nml): one FMA and `ex2.approx`; p = e * (1 / n) and
//     ds = (dp * (1 / n) - r) * e, 1 / n rounded once a row. The forward and
//     both backward kernels form e by this one formula.
//   * ptxas reports every bf16 kernel's `wgmma`s serialized (C7520): the
//     branches that cut the last tile's products and the warp path of a
//     partial block put them on paths it cannot prove uniform. A build
//     without either had none; dropping the cuts of the register-operand
//     products alone timed level (tools/flash_train_ab.py), and each
//     product group is waited on before its results are used anyway.
//   * Registers (`-Xptxas -v`): at head dims up to 64 the forward holds four
//     blocks a multiprocessor (125 registers), each backward kernel three
//     (168; dq spills 16 bytes, dk/dv 344); at 128 one block each (182,
//     241 and 255 registers, dk/dv spilling 188 bytes). More registers
//     and fewer blocks measured slower.
// Measured (tools/flash_train_ab.py, NVIDIA H100 80GB HBM3, 700.00 W): at
// (64, 257, 12, 64) the forward takes 0.159 ms of device time and the
// backward 0.332 + 0.341 (the first version, in the same run: 0.455 and
// 0.683 + 1.348; scaled_dot_product_attention 0.089 and 0.265; the bounds
// 0.031 and 0.053, bytes). The function makes them recompute (two score
// sweeps in the forward; s and dp three times in the backward), some 2x
// and 2.7x SDPA's work. What set the time was the copies' instructions
// and latency more than the exponentials (`PERF.md`): the strided
// `cp.async` and TMA cut it; what is left is each block's product, wait,
// exponentials and next product in turn.
//
// fp32 inputs run on fp32 FMAs (no TF32): the same three kernels with a
// warp owning 4 rows (forward, dq) or 4 keys (dk/dv) and a lane two keys
// or two queries of a 64-wide tile, every dot an FMA chain over the head
// dim in one order, so the recomputed scores are the forward's bit for
// bit there. They are the first version's, unchanged, and slower than the
// plain cuBLAS version (ROADMAP.md).
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream and returns cudaGetLastError().

#include "mma_sync.cuh"  // bf16, ldsm_x4(_trans), mma_bf16, quad_*, cp_async,
                         // wgmma_desc, wgmma_fence/commit/wait

constexpr int TILE = 64;         // rows of a shared-memory tile
constexpr int TC_THREADS = 128;  // one warpgroup: 4 warps x 16 rows
constexpr float NEG = -1e30f;    // a masked key's score
constexpr float LOG2E = 1.4426950408889634f;

constexpr int STAGES = 2;        // the load ring's depth

// Blocks a multiprocessor should hold (`__launch_bounds__`; ptxas caps
// each kernel's registers to fit them): at head dims up to 64, four
// forward blocks (at most 128 registers) and three of each backward kernel
// (168); at 128 one.
template <int DK>
struct Occupancy {
  static constexpr int FWD = DK == 128 ? 1 : 4;
  static constexpr int DQ = DK == 128 ? 1 : 3;
  static constexpr int DKDV = DK == 128 ? 1 : 3;
};

// The bf16 tiles of a head dim zero-padded to DK = 64 or 128 columns (a
// head dim up to 32 takes 64: its score products spend two of their four
// k-steps on zero columns, and the source builds one instantiation fewer):
// DN = DK columns as DN / 64 sub-tiles of TILE rows x 128 bytes; the chunk c
// (values 8c .. 8c + 7) of row r of a sub-tile lies at chunk c ^ (r & 7),
// the layout `wgmma`'s descriptors name (layout type 1) and `ldmatrix`
// reads with the same XOR.
template <int DK>
struct Tiles {
  static constexpr int DN = DK;
  static constexpr int BYTES = TILE * DN * 2;
};

// Byte offset of chunk c of row r in a swizzled tile.
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)((c >> 3) * (TILE * 128) + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// p0, p1 as three packed bf16 pairs whose sum is (p0, p1) exactly.
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(p0, hf.x), r1 = __fsub_rn(p1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// e = exp(s - m) from the product's raw sum x (s = x * sc, sc the scale
// where the products took q itself, else 1) as 2^(x cl + nml), cl = fp32(sc
// log2(e)), nml = -(x_max cl): one FMA and one ex2. Every kernel forms e
// this way, and x_max = m / sc exactly, so the backward's recomputed e is
// the forward's wherever its score is.
__device__ __forceinline__ float expo(float x, float cl, float nml) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmaf_rn(x, cl, nml)));
  return y;
}

// Sets the entries of a warp's 16 x 64 tile whose columns lie at or past
// `live` to x.
__device__ __forceinline__ void mask_cols(float (&s)[32], int live, float x) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (8 * j + 2 * t + (i & 1) >= live) s[4 * j + i] = x;
}

// cp.async and plain stores write shared memory through the generic
// proxy, `wgmma` reads it through the async one
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

typedef float F4[4];
__device__ __forceinline__ F4& acc4(float* x, int j) {
  return *reinterpret_cast<F4*>(x + 4 * j);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ------------------------------ wgmma ------------------------------------

// d (+)= A . B^T for one k-step of 16, A (64 rows) and B (N rows) K-major
// in shared memory; d holds N / 2 of its 32 values. `accumulate` 0
// overwrites.
template <int N>
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t da,
                                      uint64_t db, int accumulate);
// d += A . B for one k-step of 16: A a warp's 16 rows x 16 in registers
// (the A operand of `mma.m16n8k16`), B (16 rows x N) MN-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t db,
                                      int accumulate);

template <>
__device__ __forceinline__ void wg_ss<16>(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_ss<32>(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_ss<48>(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_ss<64>(float (&d)[32], uint64_t da,
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
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_rs<64>(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_rs<128>(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


// A K-major tile's descriptor at k-step ks: 32 bytes along a swizzled
// row, the next sub-tile every four steps.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int ks) {
  return wgmma_desc(addr, 16, 1024) +
         (uint64_t)((ks >> 2) * (TILE * 128 / 16) + (ks & 3) * 2);
}
// An MN-major tile's (its rows are the product's inner dimension)
// descriptor from row k0, a multiple of 16: 1024 bytes from one 8-row
// group to the next, a sub-tile from one 64 columns to the next.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int k0) {
  return wgmma_desc(addr + k0 * 128, TILE * 128, 1024);
}

// ------------------------------ products ---------------------------------

// s = sum over nt terms t of A_t . B_t^T, A_t the 64 x DK tile at a + t *
// astep, B_t the 16 * n16 rows of the tile at b + t * bstep: the scores (A
// = qs's terms, B = K, or in the dk/dv kernel A = K, B = qs's terms) and
// dp (g and V). The warpgroup's wgmma; the caller fences, commits, waits.
template <int DK>
__device__ __forceinline__ void wg_nt(float (&s)[32], uint32_t a,
                                      uint32_t astep, uint32_t b,
                                      uint32_t bstep, int nt, int n16) {
  for (int t = 0; t < nt; ++t)
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      const uint64_t da = desc_k(a + t * astep, ks);
      const uint64_t db = desc_k(b + t * bstep, ks);
      const int acc = t | ks;
      if (n16 == 4)
        wg_ss<64>(s, da, db, acc);
      else if (n16 == 3)
        wg_ss<48>(s, da, db, acc);
      else if (n16 == 2)
        wg_ss<32>(s, da, db, acc);
      else
        wg_ss<16>(s, da, db, acc);
    }
}

// The same for one warp's 16 rows of A (rows 16 * warp ..) on
// `mma.sync.m16n8k16`: a block whose rows do not fill the warpgroup.
template <int DK>
__device__ __forceinline__ void warp_nt(float (&s)[32], uint32_t a,
                                        uint32_t astep, uint32_t b,
                                        uint32_t bstep, int nt, int n16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  // A: matrix l / 8 at rows +8 for 1, 3 and columns +8 for 2, 3; B (its
  // rows the product's columns): rows +8 for 2, 3, columns +8 for 1, 3
  const int ar = 16 * warp + (lane & 15), ac = lane >> 4;
  const int br = (lane & 7) + ((lane >> 4) << 3), bc = (lane >> 3) & 1;
  for (int t = 0; t < nt; ++t)
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t af[4];
      ldsm4(af, a + t * astep + sw(ar, 2 * ks + ac));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        if (jp < n16) {
          uint32_t bf[4];
          ldsm4(bf, b + t * bstep + sw(16 * jp + br, 2 * ks + bc));
          mma_bf16(acc4(s, 2 * jp), af, bf[0], bf[1]);
          mma_bf16(acc4(s, 2 * jp + 1), af, bf[2], bf[3]);
        }
    }
}

// acc += a . B[k0 .. k0 + 16) over DN columns for one warp: a its 16 rows
// x 16 of B's rows, B MN-major, read by `ldmatrix.trans`.
template <int DN>
__device__ __forceinline__ void warp_nn(float (&acc)[DN / 2],
                                        const uint32_t (&a)[4], uint32_t b,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  // matrix l / 8: rows +8 for 1, 3; columns +8 for 2, 3
  const int br = k0 + (lane & 7) + (((lane >> 3) & 1) << 3), bc = lane >> 4;
#pragma unroll
  for (int dp = 0; dp < DN / 16; ++dp) {
    uint32_t bf[4];
    ldsm4_t(bf, b + sw(br, 2 * dp + bc));
    mma_bf16(acc4(acc, 2 * dp), a, bf[0], bf[1]);
    mma_bf16(acc4(acc, 2 * dp + 1), a, bf[2], bf[3]);
  }
}

// The A operand of columns [16 kk, 16 kk + 16) of a warp's 16 x 64 tile:
// a0, a1 rows g, g + 8 of columns 16kk + 2t..; a2, a3 the same 8 on.
__device__ __forceinline__ void frag(uint32_t (&a)[4], const float (&x)[32],
                                     int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}
__device__ __forceinline__ void frag3(uint32_t (&hi)[4], uint32_t (&mid)[4],
                                      uint32_t (&lo)[4], const float (&x)[32],
                                      int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[i], mid[i], lo[i]);
}

// ------------------------------ tiles ------------------------------------

// Rows [r0, r0 + TILE) of one head (row stride ld, columns [0, d)) into the
// swizzled tile at byte offset dst of shared memory sm; rows at or past lim
// and columns at or past d are zero. vec: 16-byte cp.async, landing at a
// later wait; else plain loads.
template <int DN>
__device__ __forceinline__ void load_tile(unsigned char* sm, uint32_t dst,
                                          const bf16* src, long long ld,
                                          int r0, int lim, int d, bool vec) {
  if (vec) {
    // a thread copies chunk c of rows r, r + step, ...: step is a multiple
    // of 8, so the chunk's swizzled place moves by step rows each time
    constexpr int CH = DN / 8, STEP = TC_THREADS / CH;
    const int c = threadIdx.x % CH, r = threadIdx.x / CH;
    const uint32_t s0 = smem_u32(sm) + dst + sw(r, c);
    const bf16* g0 = src + (long long)(r0 + r) * ld + 8 * c;
    const int left = 8 * c < d ? lim - r0 - r : 0;  // rows to copy from r
#pragma unroll
    for (int j = 0; j < TILE / STEP; ++j) {
      const bool in = j * STEP < left;
      cp_async16(s0 + j * STEP * 128, in ? g0 + j * STEP * ld : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * DN; i += TC_THREADS) {
      const int r = i / DN, c = i % DN;
      *reinterpret_cast<bf16*>(sm + dst + sw(r, c >> 3) + 2 * (c & 7)) =
          r0 + r < lim && c < d ? src[(long long)(r0 + r) * ld + c]
                                : __float2bfloat16_rn(0.f);
    }
  }
}

// One tile of a slab's row-major bf16 matrix by TMA (ring_map): its DN /
// 64 boxes of 64 columns from (col, row) on into the swizzled sub-tiles at
// dst (a shared address), counted on `bar`. Rows past the slab's S arrive
// as zeros, as cp.async fills them.
template <int DN>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int slab) {
#pragma unroll
  for (int sub = 0; sub < DN / 64; ++sub)
    tma_load_3d(dst + sub * TILE * 128, map, bar, col + 64 * sub, row, slab);
}

// The ring's barriers (one a stage, for TMA), armed before any copy.
__device__ __forceinline__ void init_ring(uint64_t* full, int tma) {
  if (tma && threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Waits until item `it` of the ring has landed and every thread is done
// with item it - 1, whose stage the caller refills next.
__device__ __forceinline__ void ring_next(uint64_t* full, int it, int tma) {
  cp_async_wait<STAGES - 2>();
  if (tma) mbar_wait(smem_u32(&full[it % STAGES]), (it / STAGES) & 1);
  fence_async_smem();
  __syncthreads();
}

// The three bf16 terms of qs = fp32(q) * scale for rows [r0, r0 + TILE)
// into three tiles BYTES apart at dst; rows at or past lim and columns at
// or past d are zero. With out, each live row's terms also go there, term
// t of row r at out[(t * S + r) * DN ..], for the dk/dv kernel.
template <int DN>
__device__ __forceinline__ void form_q_terms(unsigned char* sm, uint32_t dst,
                                             const bf16* src, long long ld,
                                             int r0, int lim, int d,
                                             float scale, bf16* out, int S) {
  constexpr int TB = TILE * DN * 2;
  for (int i = threadIdx.x; i < TILE * DN; i += TC_THREADS) {
    const int r = i / DN, c = i % DN;
    const bool in = r0 + r < lim;
    const float x =
        in && c < d
            ? __fmul_rn(__bfloat162float(src[(long long)(r0 + r) * ld + c]),
                        scale)
            : 0.f;
    const bf16 hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    const bf16 mid = __float2bfloat16_rn(r1);
    const bf16 lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    bf16* at = reinterpret_cast<bf16*>(sm + dst + sw(r, c >> 3) + 2 * (c & 7));
    at[0] = hi;
    at[TB / 2] = mid;
    at[TB] = lo;
    if (out && in) {
      const long long o = (long long)(r0 + r) * DN + c;
      out[o] = hi;
      out[(long long)S * DN + o] = mid;
      out[2LL * S * DN + o] = lo;
    }
  }
}

// Row `row` of a warp's 64-column accumulator (rows g, g + 8: r = 0, 1),
// columns below d, times mul, as bf16 (vec: pairs, d a multiple of 8).
template <int DN>
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[DN / 2],
                                          int r, int d, float mul, bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float a = __fmul_rn(acc[4 * j + 2 * r], mul);
    const float b = __fmul_rn(acc[4 * j + 2 * r + 1], mul);
    if (vec) {
      if (col < d) *reinterpret_cast<uint32_t*>(dst + col) = pack2(a, b);
    } else {
      if (col < d) dst[col] = __float2bfloat16_rn(a);
      if (col + 1 < d) dst[col + 1] = __float2bfloat16_rn(b);
    }
  }
}

// Shared memory of the three kernels: a 1 KB margin to align the tiles to
// the swizzle's 1024-byte period, then (in tiles of BYTES) the forward's
// nt q terms and a ring of (K, V) stages; the dq kernel's q terms, g and
// (K, V) stages; the dk/dv kernel's K, V and stages of nt q terms, g and
// 64 row terms (1 KB).
template <int DK>
__host__ __device__ constexpr int smem_fwd(int nt) {
  return 1024 + (nt + 2 * STAGES) * Tiles<DK>::BYTES;
}
template <int DK>
__host__ __device__ constexpr int smem_dq(int nt) {
  return 1024 + (nt + 1 + 2 * STAGES) * Tiles<DK>::BYTES;
}
template <int DK>
__host__ __device__ constexpr int smem_dkdv(int nt) {
  return 1024 + 2 * Tiles<DK>::BYTES +
         STAGES * ((nt + 1) * Tiles<DK>::BYTES + 1024);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - smem_u32(raw) % 1024u) % 1024u);
}

// ---------------------------- bf16 forward ------------------------------

// grid (ceil(S / rows), batch * heads), 128 threads; rows 64, 32 or 16.
template <int DK>
__global__ void __launch_bounds__(TC_THREADS, Occupancy<DK>::FWD)
    fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ mo,
    float* __restrict__ no, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, int heads, int S, int d,
    float scale, int nt, int vec, int tma, int rows) {
  using T = Tiles<DK>;
  constexpr int DN = T::DN, TB = T::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t su = smem_u32(sm), ring = nt * TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int q0 = blockIdx.x * rows, live = min(rows, S - q0);
  const bool wg = live > 48, wlive = 16 * warp < live;
  // with one term qs = q * scale exactly, a power of two: the products
  // take q, and the scores are their sums times sc
  const float sc = nt == 1 ? scale : 1.f, cl = sc * LOG2E;
  __shared__ uint64_t full[STAGES];
  init_ring(full, tma);
  if (nt == 1)
    load_tile<DN>(sm, 0, q + base, ld, q0, q0 + live, d, vec);
  else
    form_q_terms<DN>(sm, 0, q + base, ld, q0, q0 + live, d, scale, nullptr,
                     S);

  // items [0, tiles): K for the row stats; [tiles, 2 tiles): K and V
  const int tiles = (S + TILE - 1) / TILE, items = 2 * tiles;
  auto fetch = [&](int it) {
    if (it < items) {
      const int stage = it % STAGES, k0 = (it % tiles) * TILE;
      const uint32_t st = ring + stage * 2 * TB;
      if (!tma) {
        load_tile<DN>(sm, st, k + base, ld, k0, S, d, vec);
        if (it >= tiles)
          load_tile<DN>(sm, st + TB, v + base, ld, k0, S, d, vec);
      } else if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&full[stage]);
        mbar_expect_tx(bar, (it >= tiles ? 2 : 1) * TB);
        tma_tile<DN>(su + st, &map_k, bar, h * d, k0, b);
        if (it >= tiles)
          tma_tile<DN>(su + st + TB, &map_v, bar, h * d, k0, b);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  // m: the row max of the raw sums until the end
  float m[2] = {NEG, NEG}, n[2] = {0.f, 0.f}, nml[2], rn[2];
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < items; ++it) {
    ring_next(full, it, tma);
    fetch(it + STAGES - 1);
    const uint32_t kt = su + ring + (it % STAGES) * 2 * TB, vt = kt + TB;
    const int k0 = (it % tiles) * TILE, klive = min(TILE, S - k0);
    const int n16 = (klive + 15) >> 4;
    float s[32];
    if (wg) {
      wgmma_fence();
      wg_nt<DK>(s, su, TB, kt, 0, nt, n16);
      wgmma_commit();
      wgmma_wait<0>();
    } else if (wlive) {
      warp_nt<DK>(s, su, TB, kt, 0, nt, n16);
    }
    if (!wlive) continue;  // (a block on wgmma has no such warp)
    // the last tile's keys past S: their 8-key groups are skipped, the
    // rest of the group masked
    if (klive < TILE) mask_cols(s, klive, NEG);
    if (it < tiles) {
      // sweep 1: the row max and the row sum, rescaled as the max grows
      float tmax[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j < klive)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tmax[i >> 1] = fmaxf(tmax[i >> 1], s[4 * j + i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = fmaxf(m[r], quad_max(tmax[r]));
        const float nmx = -(mx * cl);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < klive)
            part += expo(s[4 * j + 2 * r], cl, nmx) +
                    expo(s[4 * j + 2 * r + 1], cl, nmx);
        n[r] = __fmaf_rn(n[r], expo(m[r], cl, nmx), part);
        m[r] = mx;
      }
      continue;
    }
    if (it == tiles)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        n[r] = quad_sum(n[r]);
        rn[r] = __frcp_rn(n[r]);
        nml[r] = -(m[r] * cl);
      }
    // sweep 2: p = e / n rounded to bf16, o += p . v
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[4 * j + i] = 8 * j < klive
                           ? __fmul_rn(expo(s[4 * j + i], cl, nml[i >> 1]),
                                       rn[i >> 1])
                           : 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(pa[kk], s, kk);
    if (wg) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < n16) wg_rs<DN>(acc, pa[kk], desc_mn(vt, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < n16) warp_nn<DN>(acc, pa[kk], vt, 16 * kk);
    }
  }
  if (!wlive) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * warp + g + 8 * r;
    if (rr >= live) continue;
    const int row = q0 + rr;
    store_row<DN>(o + base + (long long)row * ld, acc, r, d, 1.f, vec);
    if (t == 0) {
      mo[(long long)bh * S + row] = __fmul_rn(m[r], sc);
      no[(long long)bh * S + row] = n[r];
    }
  }
}

// ---------------------------- bf16 backward -----------------------------

// grid (ceil(S / rows), batch * heads), 128 threads: dq; the row terms
// (-m log2(e), 1 / n, r) for the dk/dv kernel, r = sum (dp / (n n)) e;
// with three q terms, the terms themselves (qx, (batch * heads, 3, S, DN)).
template <int DK>
__global__ void __launch_bounds__(TC_THREADS, Occupancy<DK>::DQ)
    bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    float4* __restrict__ rs, bf16* __restrict__ qx, bf16* __restrict__ dq,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, int heads, int S, int d,
    float scale, int nt, int vec, int tma, int rows) {
  using T = Tiles<DK>;
  constexpr int DN = T::DN, TB = T::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t su = smem_u32(sm), gt = nt * TB, ring = gt + TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int q0 = blockIdx.x * rows, live = min(rows, S - q0);
  const bool wg = live > 48, wlive = 16 * warp < live;
  const float sc = nt == 1 ? scale : 1.f, cl = sc * LOG2E;
  __shared__ uint64_t full[STAGES];
  init_ring(full, tma);
  if (nt == 1)
    load_tile<DN>(sm, 0, q + base, ld, q0, q0 + live, d, vec);
  else
    form_q_terms<DN>(sm, 0, q + base, ld, q0, q0 + live, d, scale,
                     qx + (long long)bh * 3 * S * DN, S);
  load_tile<DN>(sm, gt, gr + base, ld, q0, q0 + live, d, vec);

  float nml[2], rn[2], nis[2], rr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    const bool in = row < live;
    const float m = in ? mo[(long long)bh * S + q0 + row] : 0.f;
    const float n = in ? no[(long long)bh * S + q0 + row] : 1.f;
    nml[r] = -(__fmul_rn(m, __frcp_rn(sc)) * cl);  // m / sc: exact
    rn[r] = __frcp_rn(n);
    nis[r] = __fdiv_rn(1.f, __fmul_rn(n, n));
    rr[r] = 0.f;
  }

  // items [0, tiles): K and V for r; [tiles, 2 tiles): K and V for dq
  const int tiles = (S + TILE - 1) / TILE, items = 2 * tiles;
  auto fetch = [&](int it) {
    if (it < items) {
      const int stage = it % STAGES, k0 = (it % tiles) * TILE;
      const uint32_t st = ring + stage * 2 * TB;
      if (!tma) {
        load_tile<DN>(sm, st, k + base, ld, k0, S, d, vec);
        load_tile<DN>(sm, st + TB, v + base, ld, k0, S, d, vec);
      } else if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&full[stage]);
        mbar_expect_tx(bar, 2 * TB);
        tma_tile<DN>(su + st, &map_k, bar, h * d, k0, b);
        tma_tile<DN>(su + st + TB, &map_v, bar, h * d, k0, b);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < items; ++it) {
    ring_next(full, it, tma);
    fetch(it + STAGES - 1);
    const uint32_t kt = su + ring + (it % STAGES) * 2 * TB, vt = kt + TB;
    const int k0 = (it % tiles) * TILE, klive = min(TILE, S - k0);
    const int n16 = (klive + 15) >> 4;
    const bool sweep0 = it < tiles;
    float s[32], dp[32];
    if (wg) {
      wgmma_fence();
      wg_nt<DK>(s, su, TB, kt, 0, nt, n16);
      wg_nt<DK>(dp, su + gt, 0, vt, 0, 1, n16);
      wgmma_commit();
      wgmma_wait<0>();
    } else if (wlive) {
      warp_nt<DK>(s, su, TB, kt, 0, nt, n16);
      warp_nt<DK>(dp, su + gt, 0, vt, 0, 1, n16);
    }
    if (wlive) {
      if (klive < TILE) mask_cols(s, klive, NEG);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= klive) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[4 * j + i] = 0.f;
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const float e = expo(s[4 * j + i], cl, nml[r]);
          const float dpb = bf16_round(dp[4 * j + i]);
          if (sweep0)
            rr[r] = __fadd_rn(rr[r], __fmul_rn(__fmul_rn(dpb, nis[r]), e));
          else
            s[4 * j + i] =
                __fmul_rn(__fsub_rn(__fmul_rn(dpb, rn[r]), rr[r]), e);
        }
      }
    }
    if (sweep0) {
      if (it == tiles - 1)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rr[r] = quad_sum(rr[r]);
          const int row = 16 * warp + g + 8 * r;
          if (t == 0 && row < live)
            rs[(long long)bh * S + q0 + row] =
                make_float4(nml[r], rn[r], rr[r], 0.f);
        }
      continue;
    }
    // sweep 2: dq += ds . k, ds as three bf16 terms
    if (!wg && !wlive) continue;
    uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag3(hi[kk], mid[kk], lo[kk], s, kk);
    if (wg) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < n16) {
          const uint64_t db = desc_mn(kt, 16 * kk);
          wg_rs<DN>(acc, hi[kk], db, 1);
          wg_rs<DN>(acc, mid[kk], db, 1);
          wg_rs<DN>(acc, lo[kk], db, 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < n16) {
          warp_nn<DN>(acc, hi[kk], kt, 16 * kk);
          warp_nn<DN>(acc, mid[kk], kt, 16 * kk);
          warp_nn<DN>(acc, lo[kk], kt, 16 * kk);
        }
    }
  }
  if (!wlive) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row < live)
      store_row<DN>(dq + base + (long long)(q0 + row) * ld, acc, r, d, scale,
                    vec);
  }
}

// grid (ceil(S / rows), batch * heads), 128 threads: a block owns `rows`
// keys and computes its tiles in the keys' orientation, s^T = K . qs^T and
// dp^T = V . g^T with the keys as rows, so that P^T and ds^T are, register
// for register, the A operands of dv += P^T . g and dk += ds^T . qs.
template <int DK>
__global__ void __launch_bounds__(TC_THREADS, Occupancy<DK>::DKDV)
    bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ gr,
    const float4* __restrict__ rs, const bf16* __restrict__ qx,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_g, int heads, int S, int d,
    float scale, int nt, int vec, int tma, int rows) {
  using T = Tiles<DK>;
  constexpr int DN = T::DN, TB = T::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t su = smem_u32(sm), ring = 2 * TB;
  const uint32_t SB = (nt + 1) * TB + 1024;  // a stage: q terms, g, row terms
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int k0 = blockIdx.x * rows, live = min(rows, S - k0);
  const bool wg = live > 48, wlive = 16 * warp < live;
  const float sc = nt == 1 ? scale : 1.f, cl = sc * LOG2E;
  __shared__ uint64_t full[STAGES];
  init_ring(full, tma);
  load_tile<DN>(sm, 0, k + base, ld, k0, k0 + live, d, vec);
  load_tile<DN>(sm, TB, v + base, ld, k0, k0 + live, d, vec);

  const int tiles = (S + TILE - 1) / TILE;
  const float4* rsh = rs + (long long)bh * S;
  auto fetch = [&](int it) {
    if (it < tiles) {
      const int stage = it % STAGES, j0 = it * TILE;
      const uint32_t st = ring + stage * SB;
      if (!tma) {
        if (nt == 1)
          load_tile<DN>(sm, st, q + base, ld, j0, S, d, vec);
        else
          for (int term = 0; term < 3; ++term)
            load_tile<DN>(sm, st + term * TB,
                          qx + ((long long)bh * 3 + term) * S * DN, DN, j0,
                          S, DN, true);
        load_tile<DN>(sm, st + nt * TB, gr + base, ld, j0, S, d, vec);
      } else if (threadIdx.x == 0) {
        // q's rows (one term) or the three terms' rows of the scratch
        const uint32_t bar = smem_u32(&full[stage]);
        mbar_expect_tx(bar, (nt + 1) * TB);
        for (int term = 0; term < nt; ++term)
          tma_tile<DN>(su + st + term * TB, &map_q, bar,
                       nt == 1 ? h * d : 0, j0, nt == 1 ? b : bh * 3 + term);
        tma_tile<DN>(su + st + nt * TB, &map_g, bar, h * d, j0, b);
      }
      for (int i = threadIdx.x; i < TILE; i += TC_THREADS) {
        const bool in = j0 + i < S;
        cp_async16(su + st + (nt + 1) * TB + 16 * i, in ? rsh + j0 + i : rsh,
                   in);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  float dka[DN / 2], dva[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dka[i] = dva[i] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    ring_next(full, it, tma);
    fetch(it + STAGES - 1);
    const uint32_t qt = su + ring + (it % STAGES) * SB, gs = qt + nt * TB;
    const float4* stats =
        reinterpret_cast<const float4*>(sm + ring + (it % STAGES) * SB +
                                        (nt + 1) * TB);
    const int qlive = min(TILE, S - it * TILE), n16 = (qlive + 15) >> 4;
    float s[32], dp[32];
    if (wg) {
      wgmma_fence();
      wg_nt<DK>(s, su, 0, qt, TB, nt, n16);
      wg_nt<DK>(dp, su + TB, 0, gs, 0, 1, n16);
      wgmma_commit();
      wgmma_wait<0>();
    } else if (wlive) {
      warp_nt<DK>(s, su, 0, qt, TB, nt, n16);
      warp_nt<DK>(dp, su + TB, 0, gs, 0, 1, n16);
    } else {
      continue;
    }
    // P^T and ds^T: a thread's keys g, g + 8 of its warp, queries 8j +
    // 2t..; a query past S has p and ds 0 (its q and g rows are zeros)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= qlive) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[4 * j + i] = dp[4 * j + i] = 0.f;
        continue;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qc = 8 * j + 2 * t + hh;
        const float4 st = stats[qc];  // -m log2(e), 1 / n, r; 0 past S
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + hh;
          const float e = expo(s[i], cl, st.x);
          const bool in = qc < qlive;
          s[i] = in ? __fmul_rn(e, st.y) : 0.f;
          dp[i] = in ? __fmul_rn(__fsub_rn(__fmul_rn(bf16_round(dp[i]),
                                                     st.y),
                                           st.z),
                                 e)
                     : 0.f;
        }
      }
    }
    uint32_t pa[4][4], hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      frag(pa[kk], s, kk);
      frag3(hi[kk], mid[kk], lo[kk], dp, kk);
    }
    if (wg) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < n16) {
          wg_rs<DN>(dva, pa[kk], desc_mn(gs, 16 * kk), 1);
          for (int term = 0; term < nt; ++term) {
            const uint64_t db = desc_mn(qt + term * TB, 16 * kk);
            wg_rs<DN>(dka, hi[kk], db, 1);
            wg_rs<DN>(dka, mid[kk], db, 1);
            wg_rs<DN>(dka, lo[kk], db, 1);
          }
        }
      wgmma_commit();
      wgmma_wait<0>();
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < n16) {
          warp_nn<DN>(dva, pa[kk], gs, 16 * kk);
          for (int term = 0; term < nt; ++term) {
            warp_nn<DN>(dka, hi[kk], qt + term * TB, 16 * kk);
            warp_nn<DN>(dka, mid[kk], qt + term * TB, 16 * kk);
            warp_nn<DN>(dka, lo[kk], qt + term * TB, 16 * kk);
          }
        }
    }
  }
  if (!wlive) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= live) continue;
    const long long at = base + (long long)(k0 + row) * ld;
    store_row<DN>(dv + at, dva, r, d, 1.f, vec);
    store_row<DN>(dk + at, dka, r, d, sc, vec);
  }
}

// ------------------------------ fp32 FMAs -------------------------------

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_R = 4;                   // rows (or keys) of a warp
constexpr int F_ROWS = F_WARPS * F_R;    // of a block
constexpr int F_KT = 64;                 // keys (or queries) of a tile
constexpr int F_MAXJ = 4;                // head dims of a lane: d <= 128

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

// The dot of a (d values) and b, an FMA chain in column order: the one
// order every fp32 kernel takes for scores and dp.
__device__ __forceinline__ float dot_chain(const float* a, const float* b,
                                           int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = __fmaf_rn(a[c], b[c], s);
  return s;
}

// Rows [r0, r0 + rows) of one head into a (rows, lds) fp32 tile, times
// `mul`; rows at or past S are zero.
__device__ __forceinline__ void load_f32(float* dst, int lds,
                                         const float* src, long long ld,
                                         int r0, int rows, int S, int d,
                                         float mul) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dst[r * lds + c] =
        r0 + r < S ? __fmul_rn(src[(long long)(r0 + r) * ld + c], mul) : 0.f;
  }
}

// grid (ceil(S / 32), batch * heads), 256 threads: a warp's 4 rows, a
// lane's keys lane and lane + 32 of each tile.
__global__ void __launch_bounds__(F_THREADS) fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ mo,
    float* __restrict__ no, int heads, int S, int d, float scale) {
  extern __shared__ float fsm[];
  const int kp = d + 1;
  float* Ks = fsm;                    // [F_KT][kp]
  float* Vs = Ks + F_KT * kp;         // [F_KT][kp]
  float* Qs = Vs + F_KT * kp;         // [F_ROWS][d], scaled
  float* Ps = Qs + F_ROWS * d;        // [F_ROWS][F_KT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int row0 = blockIdx.x * F_ROWS + warp * F_R;
  load_f32(Qs, d, q + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, scale);
  const float* qw = Qs + warp * F_R * d;
  float* pw = Ps + warp * F_R * F_KT;
  float m[F_R], n[F_R], acc[F_R][F_MAXJ];
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    m[rr] = NEG;
    n[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) acc[rr][j] = 0.f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep)
    for (int k0 = 0; k0 < S; k0 += F_KT) {
      __syncthreads();
      load_f32(Ks, kp, k + base, ld, k0, F_KT, S, d, 1.f);
      if (sweep == 1) load_f32(Vs, kp, v + base, ld, k0, F_KT, S, d, 1.f);
      __syncthreads();
      const bool la = k0 + lane < S, lb = k0 + lane + 32 < S;
#pragma unroll
      for (int rr = 0; rr < F_R; ++rr) {
        const float sa = la ? dot_chain(qw + rr * d, Ks + lane * kp, d) : NEG;
        const float sb =
            lb ? dot_chain(qw + rr * d, Ks + (lane + 32) * kp, d) : NEG;
        if (sweep == 0) {
          const float mx = fmaxf(m[rr], warp_max(fmaxf(sa, sb)));
          const float part = warp_sum(__fadd_rn(expf(__fsub_rn(sa, mx)),
                                                expf(__fsub_rn(sb, mx))));
          n[rr] = __fadd_rn(__fmul_rn(n[rr], expf(__fsub_rn(m[rr], mx))),
                            part);
          m[rr] = mx;
        } else {
          pw[rr * F_KT + lane] =
              la ? __fdiv_rn(expf(__fsub_rn(sa, m[rr])), n[rr]) : 0.f;
          pw[rr * F_KT + lane + 32] =
              lb ? __fdiv_rn(expf(__fsub_rn(sb, m[rr])), n[rr]) : 0.f;
        }
      }
      if (sweep == 0) continue;
      __syncwarp();
      for (int kk = 0; kk < F_KT; ++kk)
#pragma unroll
        for (int j = 0; j < F_MAXJ; ++j) {
          const int c = lane + 32 * j;
          if (c >= d) continue;
          const float vv = Vs[kk * kp + c];
#pragma unroll
          for (int rr = 0; rr < F_R; ++rr)
            acc[rr][j] = __fmaf_rn(pw[rr * F_KT + kk], vv, acc[rr][j]);
        }
      __syncwarp();
    }
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = row0 + rr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) o[base + (long long)row * ld + c] = acc[rr][j];
    }
    if (lane == 0) {
      mo[(long long)bh * S + row] = m[rr];
      no[(long long)bh * S + row] = n[rr];
    }
  }
}

// grid (ceil(S / 32), batch * heads), 256 threads: dq and r.
__global__ void __launch_bounds__(F_THREADS) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    float* __restrict__ ro, float* __restrict__ dq, int heads, int S, int d,
    float scale) {
  extern __shared__ float fsm[];
  const int kp = d + 1;
  float* Ks = fsm;                 // [F_KT][kp]
  float* Vs = Ks + F_KT * kp;      // [F_KT][kp]
  float* Qs = Vs + F_KT * kp;      // [F_ROWS][d], scaled
  float* Gs = Qs + F_ROWS * d;     // [F_ROWS][d]
  float* Ds = Gs + F_ROWS * d;     // [F_ROWS][F_KT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int row0 = blockIdx.x * F_ROWS + warp * F_R;
  load_f32(Qs, d, q + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, scale);
  load_f32(Gs, d, gr + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, 1.f);
  const float* qw = Qs + warp * F_R * d;
  const float* gw = Gs + warp * F_R * d;
  float* dw = Ds + warp * F_R * F_KT;
  float m[F_R], n[F_R], nis[F_R], r[F_R], acc[F_R][F_MAXJ];
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = row0 + rr;
    m[rr] = row < S ? mo[(long long)bh * S + row] : 0.f;
    n[rr] = row < S ? no[(long long)bh * S + row] : 1.f;
    nis[rr] = __fdiv_rn(1.f, __fmul_rn(n[rr], n[rr]));
    r[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) acc[rr][j] = 0.f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < S; k0 += F_KT) {
      __syncthreads();
      load_f32(Ks, kp, k + base, ld, k0, F_KT, S, d, 1.f);
      load_f32(Vs, kp, v + base, ld, k0, F_KT, S, d, 1.f);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < F_R; ++rr)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = lane + 32 * hh;
          float val = 0.f;
          if (k0 + key < S) {
            const float s = dot_chain(qw + rr * d, Ks + key * kp, d);
            const float dp = dot_chain(gw + rr * d, Vs + key * kp, d);
            const float e = expf(__fsub_rn(s, m[rr]));
            if (sweep == 0)
              r[rr] = __fadd_rn(r[rr],
                                __fmul_rn(__fmul_rn(dp, nis[rr]), e));
            else
              val = __fmul_rn(__fsub_rn(__fdiv_rn(dp, n[rr]), r[rr]), e);
          }
          if (sweep == 1) dw[rr * F_KT + key] = val;
        }
      if (sweep == 0) continue;
      __syncwarp();
      for (int kk = 0; kk < F_KT; ++kk)
#pragma unroll
        for (int j = 0; j < F_MAXJ; ++j) {
          const int c = lane + 32 * j;
          if (c >= d) continue;
          const float kv = Ks[kk * kp + c];
#pragma unroll
          for (int rr = 0; rr < F_R; ++rr)
            acc[rr][j] = __fmaf_rn(dw[rr * F_KT + kk], kv, acc[rr][j]);
        }
      __syncwarp();
    }
    if (sweep == 0)
#pragma unroll
      for (int rr = 0; rr < F_R; ++rr) r[rr] = warp_sum(r[rr]);
  }
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = row0 + rr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d)
        dq[base + (long long)row * ld + c] = __fmul_rn(acc[rr][j], scale);
    }
    if (lane == 0) ro[(long long)bh * S + row] = r[rr];
  }
}

// grid (ceil(S / 32), batch * heads), 256 threads: a warp's 4 keys, a
// lane's queries lane and lane + 32 of each tile.
__global__ void __launch_bounds__(F_THREADS) bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    const float* __restrict__ ro, float* __restrict__ dk,
    float* __restrict__ dv, int heads, int S, int d, float scale) {
  extern __shared__ float fsm[];
  const int kp = d + 1;
  float* Kb = fsm;                  // [F_ROWS][d], the block's keys
  float* Vb = Kb + F_ROWS * d;      // [F_ROWS][d]
  float* Qs = Vb + F_ROWS * d;      // [F_KT][kp], scaled
  float* Gs = Qs + F_KT * kp;       // [F_KT][kp]
  float* St = Gs + F_KT * kp;       // [3][F_KT]: m, n, r
  float* Ps = St + 3 * F_KT;        // [F_ROWS][F_KT]
  float* Ds = Ps + F_ROWS * F_KT;   // [F_ROWS][F_KT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int key0 = blockIdx.x * F_ROWS + warp * F_R;
  load_f32(Kb, d, k + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, 1.f);
  load_f32(Vb, d, v + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, 1.f);
  const float* kw = Kb + warp * F_R * d;
  const float* vw = Vb + warp * F_R * d;
  float* pw = Ps + warp * F_R * F_KT;
  float* dw = Ds + warp * F_R * F_KT;
  float dka[F_R][F_MAXJ], dva[F_R][F_MAXJ];
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr)
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) dka[rr][j] = dva[rr][j] = 0.f;
  for (int q0 = 0; q0 < S; q0 += F_KT) {
    __syncthreads();
    load_f32(Qs, kp, q + base, ld, q0, F_KT, S, d, scale);
    load_f32(Gs, kp, gr + base, ld, q0, F_KT, S, d, 1.f);
    for (int i = threadIdx.x; i < F_KT; i += blockDim.x) {
      const bool in = q0 + i < S;
      St[i] = in ? mo[(long long)bh * S + q0 + i] : 0.f;
      St[F_KT + i] = in ? no[(long long)bh * S + q0 + i] : 1.f;
      St[2 * F_KT + i] = in ? ro[(long long)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F_R; ++rr)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = lane + 32 * hh;
        float p = 0.f, ds = 0.f;
        if (q0 + qi < S && key0 + rr < S) {
          const float s = dot_chain(Qs + qi * kp, kw + rr * d, d);
          const float dp = dot_chain(Gs + qi * kp, vw + rr * d, d);
          const float m = St[qi], n = St[F_KT + qi], r = St[2 * F_KT + qi];
          const float e = expf(__fsub_rn(s, m));
          p = __fdiv_rn(e, n);
          ds = __fmul_rn(__fsub_rn(__fdiv_rn(dp, n), r), e);
        }
        pw[rr * F_KT + qi] = p;
        dw[rr * F_KT + qi] = ds;
      }
    __syncwarp();
    for (int qq = 0; qq < F_KT; ++qq)
#pragma unroll
      for (int j = 0; j < F_MAXJ; ++j) {
        const int c = lane + 32 * j;
        if (c >= d) continue;
        const float gv = Gs[qq * kp + c], qv = Qs[qq * kp + c];
#pragma unroll
        for (int rr = 0; rr < F_R; ++rr) {
          dva[rr][j] = __fmaf_rn(pw[rr * F_KT + qq], gv, dva[rr][j]);
          dka[rr][j] = __fmaf_rn(dw[rr * F_KT + qq], qv, dka[rr][j]);
        }
      }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = key0 + rr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        dk[base + (long long)row * ld + c] = dka[rr][j];
        dv[base + (long long)row * ld + c] = dva[rr][j];
      }
    }
  }
}


// ------------------------------- launches -------------------------------

// The launch plan comes from the caller (ops/flash_attention_train.py::
// flash_train_plan): rows of a forward and dq block, keys of a dk/dv block,
// and each kernel's dynamic shared memory. A plan that disagrees with the
// kernels' own layout is refused, not launched.
static bool rows_ok(int rows) {
  return rows == 16 || rows == 32 || rows == TILE;
}

// The tensor map of `slabs` contiguous (S, cols) bf16 matrices (a batch's
// rows, or one head's q term in the scratch) read in 64 x 64 boxes, for the
// ring's TMA copies: a box's rows past S are zeros, never the next slab's.
// Only where a tile row is one head's whole row (d is the tiles' width) and
// 16-byte copies are allowed; false where the encoder in libcuda refuses
// it, and the kernels then take `cp.async`.
static bool ring_map(CUtensorMap* map, const bf16* base, int S, int cols,
                     long long slabs, int d, int dn, int vec) {
  return vec && d == dn && slabs <= INT32_MAX &&
         make_tensor_map_3d(map, base, S, cols, cols, TILE, (int)slabs,
                            (long long)S * cols);
}

template <typename K>
static cudaError_t launch_with(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int DK>
static int fwd_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                  float* m, float* n, int batch, int heads, int S, int d,
                  float scale, int nt, int vec, int rows, int smem,
                  cudaStream_t stream) {
  if (!rows_ok(rows) || smem != smem_fwd<DK>(nt))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_with(fwd_tc_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int DN = Tiles<DK>::DN;
  CUtensorMap map_k{}, map_v{};
  const int tma = ring_map(&map_k, k, S, heads * d, batch, d, DN, vec) &&
                  ring_map(&map_v, v, S, heads * d, batch, d, DN, vec);
  const dim3 grid((S + rows - 1) / rows, batch * heads);
  fwd_tc_kernel<DK><<<grid, TC_THREADS, smem, stream>>>(
      q, k, v, o, m, n, map_k, map_v, heads, S, d, scale, nt, vec, tma, rows);
  return (int)cudaGetLastError();
}

template <int DK>
static int bwd_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                  const float* m, const float* n, float4* rs, bf16* qx,
                  bf16* dq, bf16* dk, bf16* dv, int batch, int heads, int S,
                  int d, float scale, int nt, int vec, int rows, int smem_q,
                  int smem_k, cudaStream_t stream) {
  if (!rows_ok(rows) || smem_q != smem_dq<DK>(nt) ||
      smem_k != smem_dkdv<DK>(nt) || (nt != 1 && !qx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_with(bwd_dq_tc_kernel<DK>, smem_q);
  if (err != cudaSuccess) return (int)err;
  constexpr int DN = Tiles<DK>::DN;
  CUtensorMap map_k{}, map_v{}, map_q{}, map_g{};
  int tma = ring_map(&map_k, k, S, heads * d, batch, d, DN, vec) &&
            ring_map(&map_v, v, S, heads * d, batch, d, DN, vec);
  const dim3 grid((S + rows - 1) / rows, batch * heads);
  bwd_dq_tc_kernel<DK><<<grid, TC_THREADS, smem_q, stream>>>(
      q, k, v, g, m, n, rs, qx, dq, map_k, map_v, heads, S, d, scale, nt,
      vec, tma, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_with(bwd_dkdv_tc_kernel<DK>, smem_k);
  if (err != cudaSuccess) return (int)err;
  // q itself, or its three terms in the scratch, batch * heads * 3 slabs of
  // (S, DN)
  tma = (nt == 1 ? ring_map(&map_q, q, S, heads * d, batch, d, DN, vec)
                 : ring_map(&map_q, qx, S, DN, 3LL * batch * heads, d, DN,
                            vec)) &&
        ring_map(&map_g, g, S, heads * d, batch, d, DN, vec);
  bwd_dkdv_tc_kernel<DK><<<grid, TC_THREADS, smem_k, stream>>>(
      q, k, v, g, rs, qx, dk, dv, map_q, map_g, heads, S, d, scale, nt, vec,
      tma, rows);
  return (int)cudaGetLastError();
}

static int smem_fwd_f32(int d) {
  return (int)sizeof(float) * (2 * F_KT * (d + 1) + F_ROWS * (d + F_KT));
}
static int smem_dq_f32(int d) {
  return (int)sizeof(float) * (2 * F_KT * (d + 1) + F_ROWS * (2 * d + F_KT));
}
static int smem_dkdv_f32(int d) {
  return (int)sizeof(float) * (2 * F_ROWS * d + 2 * F_KT * (d + 1) +
                               3 * F_KT + 2 * F_ROWS * F_KT);
}

extern "C" {

// The widest head the kernels take.
int flash_trainable_max_head_dim() { return 32 * F_MAXJ; }

// q, k, v, o: contiguous (batch, S, heads, d), all bf16 (is_f32 0) or all
// fp32; m, n: (batch, heads, S) fp32, the row max and row sum. nt: the
// bf16 terms of fp32(q) * scale (1 where scale is a power of two, else
// 3); vec: 16-byte loads (d % 8 == 0, every operand 16-byte aligned);
// rows, smem: the plan (fp32: 32 rows).
int mha_flash_trainable_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* n, int batch,
                            int heads, int S, int d, float scale, int is_f32,
                            int nt, int vec, int rows, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    if (rows != F_ROWS || smem != smem_fwd_f32(d))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((S + F_ROWS - 1) / F_ROWS, batch * heads);
    cudaError_t err = launch_with(fwd_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fwd_f32_kernel<<<grid, F_THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, m, n,
        heads, S, d, scale);
    return (int)cudaGetLastError();
  }
#define FWD_TC(DK)                                                          \
  return fwd_tc<DK>((const bf16*)q, (const bf16*)k, (const bf16*)v,         \
                    (bf16*)o, m, n, batch, heads, S, d, scale, nt, vec,     \
                    rows, smem, s)
  if (d <= 64) FWD_TC(64);
  FWD_TC(128);
#undef FWD_TC
}

// g, dq, dk, dv: contiguous (batch, S, heads, d) in the inputs' type; m, n
// from the forward; rs: a scratch the dq kernel writes and the dk/dv kernel
// reads, (batch, heads, S) x 4 fp32 for bf16 (the row terms), (batch,
// heads, S) fp32 for fp32 (r); qx: with three q terms in bf16, a (batch *
// heads, 3, S, the head dim padded to 64 or 128) bf16 scratch for them,
// else null. rows, smem_q, smem_k: the plan. Two launches, in that order.
int mha_flash_trainable_bwd(const void* q, const void* k, const void* v,
                            const void* g, const float* m, const float* n,
                            void* rs, void* qx, void* dq, void* dk, void* dv,
                            int batch, int heads, int S, int d, float scale,
                            int is_f32, int nt, int vec, int rows,
                            int smem_q, int smem_k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    if (rows != F_ROWS || smem_q != smem_dq_f32(d) ||
        smem_k != smem_dkdv_f32(d))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((S + F_ROWS - 1) / F_ROWS, batch * heads);
    cudaError_t err = launch_with(bwd_dq_f32_kernel, smem_q);
    if (err != cudaSuccess) return (int)err;
    bwd_dq_f32_kernel<<<grid, F_THREADS, smem_q, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)g,
        m, n, (float*)rs, (float*)dq, heads, S, d, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_with(bwd_dkdv_f32_kernel, smem_k);
    if (err != cudaSuccess) return (int)err;
    bwd_dkdv_f32_kernel<<<grid, F_THREADS, smem_k, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)g,
        m, n, (const float*)rs, (float*)dk, (float*)dv, heads, S, d, scale);
    return (int)cudaGetLastError();
  }
#define BWD_TC(DK)                                                          \
  return bwd_tc<DK>((const bf16*)q, (const bf16*)k, (const bf16*)v,         \
                    (const bf16*)g, m, n, (float4*)rs, (bf16*)qx, (bf16*)dq, \
                    (bf16*)dk, (bf16*)dv, batch, heads, S, d, scale, nt,    \
                    vec, rows, smem_q, smem_k, s)
  if (d <= 64) BWD_TC(64);
  BWD_TC(128);
#undef BWD_TC
}

}  // extern "C"
