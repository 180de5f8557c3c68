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
// fp32 inputs run on the same bf16 tensor cores (no TF32, no FMA chains):
// every fp32 operand of a product (qs, k, v, g, p, ds) is split into its
// three bf16 terms, and a product a . b is the fp32 sum of the six term
// products a_i . b_j with i + j <= 2 (the three left out are each below
// 2^-23 |a||b|), the small ones first and hi . hi last, into the one
// accumulator (tests/test_torch_flash_trainable.py emulates it: within
// 0.17 of the 1e-5 bound). The three kernels keep the bf16 kernels'
// sweeps, ring, swizzled tiles, orientation and e, each operand tile a
// group of its three term tiles:
//   * the tiles a block keeps (the forward's qs; the dq kernel's qs and g;
//     the dk/dv kernel's k and v) are split as they load, 8 values a
//     thread in two 16-byte loads, all of a thread's loads issued first
//     (one value a load where d is no multiple of 8 or a row unaligned;
//     every tile so measured 1.3x slower in the backward). The ring's operands (k, v; in the dk/dv kernel g, qs)
//     come from a bf16 scratch of their terms: a split kernel writes k's
//     and v's before each entry point's kernels, the dq kernel qs's and
//     g's as it forms them;
//   * a ring item is one operand's three term tiles (24 KB at head dims up
//     to 64): the forward's k for the row stats, then k and v of each tile
//     (p kept in registers between); the dq kernel's v (dp, kept) then k of
//     each tile, in each of its two sweeps; the dk/dv kernel's g (dp^T,
//     kept) then qs with its row terms, at which dv += P^T . g reads g's
//     stage before the ring refills it, and dk += ds^T . qs follows;
//   * every block holds 64 rows (keys) on `wgmma`, whole 64-key products,
//     rows past S multiplied as zeros: no `mma.sync` path beside it, no
//     cut last tile, because ptxas serializes every `wgmma` of a kernel
//     where one lies on a path it cannot prove uniform (C7520), which
//     measured 1.8x (forward) and 1.9x (backward) slower. The exponentials
//     skip the 8-key groups past S.
//   * Registers (`-Xptxas -v`): forward 167 (three blocks a multiprocessor
//     at head dims up to 64), dq 189 and dk/dv 216 (two, as their shared
//     memory allows); at 128 one block, 215, 223 and 254 (dk/dv spills 20
//     bytes).
// Measured (tools/flash_train_ab.py --dtype float32, NVIDIA H100 80GB
// HBM3, 700.00 W): at (64, 257, 12, 64) the forward takes 0.095 ms of
// device time to split k and v and 0.292 in its kernel, the backward 0.094
// + 0.571 (dq) + 0.439 (dk/dv), against 3.149 and 5.241 + 3.704 for the
// FMA kernels they replace and 0.630 and 1.547 for
// scaled_dot_product_attention. Splitting k's and v's fp32 tiles in
// shared memory inside the forward's ring, each block its own (two blocks
// a multiprocessor), took 0.528 against these 0.387.
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

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// The three bf16 terms of qs = fp32(q) * scale (q bf16 or fp32; the fp32
// kernels form k's, v's and g's the same way, scale 1) for rows [r0, r0 +
// TILE) into three tiles BYTES apart at dst; rows at or past lim and
// columns at or past d are zero. With out, each live row's terms also go
// there, term t of row r at out[(t * S + r) * DN ..], for the dk/dv kernel.
template <int DN, typename T>
__device__ __forceinline__ void form_q_terms(unsigned char* sm, uint32_t dst,
                                             const T* src, long long ld,
                                             int r0, int lim, int d,
                                             float scale, bf16* out, int S) {
  constexpr int TB = TILE * DN * 2;
  for (int i = threadIdx.x; i < TILE * DN; i += TC_THREADS) {
    const int r = i / DN, c = i % DN;
    const bool in = r0 + r < lim;
    const float x =
        in && c < d
            ? __fmul_rn(to_f32(src[(long long)(r0 + r) * ld + c]), scale)
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

// --------------------------- fp32 on bf16 terms ---------------------------

// The fp32 kernels multiply on the same tensor cores: every fp32 operand of
// a product (qs, k, v, g, p, ds) is split into its three bf16 terms, and a
// product a . b is the fp32 sum of the six term products a_i . b_j with i +
// j <= 2 (the three left out are each below 2^-23 |a||b|), the small ones
// first, hi . hi last, into one accumulator. A pair p of the six takes
// term pair_a(p) of a and pair_b(p) of b.
__device__ __forceinline__ int pair_a(int p) {
  return p == 0 ? 2 : p == 2 || p == 3 ? 1 : 0;
}
__device__ __forceinline__ int pair_b(int p) {
  return p == 1 ? 2 : p == 2 || p == 4 ? 1 : 0;
}

// s = sum over the six pairs of A_i . B_j^T, A_i the 64 x DK tile at a + i
// TB, B_j the 64-row tile at b + j TB, both K-major: the scores and dp, on
// the warpgroup's `wgmma`, waited on.
template <int DK>
__device__ __forceinline__ void nt_pairs(float (&s)[32], uint32_t a,
                                         uint32_t b) {
  constexpr uint32_t TB = Tiles<DK>::BYTES;
  wgmma_fence();
#pragma unroll 1
  for (int p = 0; p < 6; ++p) {
    const uint32_t ap = a + pair_a(p) * TB, bp = b + pair_b(p) * TB;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      wg_ss<64>(s, desc_k(ap, ks), desc_k(bp, ks), p | ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// acc += x . B over the six pairs, x a warp's 16 x 64 fp32 tile (split
// here into its terms, the A operands in registers), B's 64 rows of terms
// MN-major at b + j TB: P.V, ds.K, P^T.g, ds^T.qs; waited on.
template <int DK>
__device__ __forceinline__ void rs_pairs(float (&acc)[DK / 2],
                                         const float (&x)[32], uint32_t b) {
  constexpr uint32_t TB = Tiles<DK>::BYTES;
  uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) frag3(hi[kk], mid[kk], lo[kk], x, kk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d0 = desc_mn(b, 16 * kk), d1 = desc_mn(b + TB, 16 * kk),
                   d2 = desc_mn(b + 2 * TB, 16 * kk);
    wg_rs<DK>(acc, lo[kk], d0, 1);
    wg_rs<DK>(acc, hi[kk], d2, 1);
    wg_rs<DK>(acc, mid[kk], d1, 1);
    wg_rs<DK>(acc, mid[kk], d0, 1);
    wg_rs<DK>(acc, hi[kk], d1, 1);
    wg_rs<DK>(acc, hi[kk], d0, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// Row `r` of a warp's fp32 accumulator (rows g, g + 8: r = 0, 1), columns
// below d, times mul.
template <int DN>
__device__ __forceinline__ void store_row_f32(float* dst,
                                              const float (&acc)[DN / 2],
                                              int r, int d, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float a = __fmul_rn(acc[4 * j + 2 * r], mul);
    const float b = __fmul_rn(acc[4 * j + 2 * r + 1], mul);
    if (col + 1 < d && !(d & 1)) {
      *reinterpret_cast<float2*>(dst + col) = make_float2(a, b);
    } else {
      if (col < d) dst[col] = a;
      if (col + 1 < d) dst[col + 1] = b;
    }
  }
}

// form_q_terms for an fp32 source whose rows are 16-byte aligned and d a
// multiple of 8 (vec), else form_q_terms itself: a thread's chunks of 8
// values are loaded together (two 16-byte loads each), then split, and
// each term's chunk stored whole, here and to out.
template <int DN>
__device__ __forceinline__ void form_terms_f32(unsigned char* sm,
                                               uint32_t dst, const float* src,
                                               long long ld, int r0, int lim,
                                               int d, float scale, bf16* out,
                                               int S, int vec) {
  if (!vec) {
    form_q_terms<DN>(sm, dst, src, ld, r0, lim, d, scale, out, S);
    return;
  }
  constexpr int TB = TILE * DN * 2, CH = DN / 8;
  constexpr int PER = TILE * CH / TC_THREADS;
  float y[PER][8];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * TC_THREADS, r = idx / CH, c = idx % CH;
    if (r0 + r < lim && 8 * c < d) {
      load8(y[i], src + (long long)(r0 + r) * ld + 8 * c);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) y[i][j] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * TC_THREADS, r = idx / CH, c = idx % CH;
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split3(__fmul_rn(y[i][2 * j], scale), __fmul_rn(y[i][2 * j + 1], scale),
             hi[j], mid[j], lo[j]);
    const uint4 h = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    const uint4 m = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    const uint4 l = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    unsigned char* at = sm + dst + sw(r, c);
    *reinterpret_cast<uint4*>(at) = h;
    *reinterpret_cast<uint4*>(at + TB) = m;
    *reinterpret_cast<uint4*>(at + 2 * TB) = l;
    if (out && r0 + r < lim) {
      bf16* o = out + (long long)(r0 + r) * DN + 8 * c;
      *reinterpret_cast<uint4*>(o) = h;
      *reinterpret_cast<uint4*>(o + (long long)S * DN) = m;
      *reinterpret_cast<uint4*>(o + 2LL * S * DN) = l;
    }
  }
}

// The scratch of the fp32 route: slot i of (4, batch * heads, 3, S, DN)
// bf16 holds the terms of k (0), v (1), qs (2) and g (3), term t of row r
// of head bh at ((i * BH + bh) * 3 + t) * S + r rows of DN.
__device__ __forceinline__ long long term_slab(int slot, int bh) {
  return ((long long)slot * gridDim.y + bh) * 3;
}

// One ring item of the fp32 route: rows [r0, r0 + TILE) of the three term
// tiles of slab `slab` of the scratch x into the stage at st (an offset of
// sm), by TMA (the scratch's map, counted on `bar`) or by cp.async.
template <int DN>
__device__ __forceinline__ void fetch_terms(unsigned char* sm, uint32_t st,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int tma,
                                            const bf16* x, long long slab,
                                            int r0, int S) {
  constexpr int TB = Tiles<DN>::BYTES;
  if (!tma) {
    for (int term = 0; term < 3; ++term)
      load_tile<DN>(sm, st + term * TB, x + (slab + term) * S * DN, DN, r0,
                    S, DN, true);
  } else if (threadIdx.x == 0) {
    const uint32_t b = smem_u32(bar);
    mbar_expect_tx(b, 3 * TB);
    for (int term = 0; term < 3; ++term)
      tma_tile<DN>(smem_u32(sm) + st + term * TB, map, b, 0, r0,
                   (int)(slab + term));
  }
}

// Blocks a multiprocessor holds on the fp32 route (the shared memory of
// fp32_smem allows no more): at head dims up to 64, three forward blocks
// and two of each backward kernel; at 128 one.
template <int DK>
struct F32Occupancy {
  static constexpr int FWD = DK == 128 ? 1 : 3;
  static constexpr int BWD = DK == 128 ? 1 : 2;
};

// Dynamic shared memory of the fp32 kernels: the 1 KB margin, then (in
// groups of three term tiles) the forward's qs and STAGES ring stages; the
// dq kernel's qs, g and stages; the dk/dv kernel's k, v and stages with 64
// row terms (1 KB) each.
template <int DK>
__host__ __device__ constexpr int smem_fwd_f32() {
  return 1024 + 3 * (1 + STAGES) * Tiles<DK>::BYTES;
}
template <int DK>
__host__ __device__ constexpr int smem_dq_f32() {
  return 1024 + 3 * (2 + STAGES) * Tiles<DK>::BYTES;
}
template <int DK>
__host__ __device__ constexpr int smem_dkdv_f32() {
  return 1024 + 6 * Tiles<DK>::BYTES + STAGES * (3 * Tiles<DK>::BYTES + 1024);
}

// The terms of k and v (batch, S, heads, d) fp32 into the scratch's slots
// 0 and 1 (blockIdx.z). A thread splits 8 columns of a row (vec: two
// 16-byte loads); columns at or past d are zero.
template <int DN>
__global__ void split_terms_kernel(const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   bf16* __restrict__ xs, int heads, int S,
                                   int d, int vec) {
  constexpr int CH = DN / 8;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * CH) return;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int r = i / CH, c0 = (i % CH) * 8;
  const float* src = (blockIdx.z ? v : k) +
                     ((long long)b * S + r) * heads * d + (long long)h * d;
  float y[8];
  if (vec && c0 < d) {
    load8(y, src + c0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = c0 + j < d ? src[c0 + j] : 0.f;
  }
  uint32_t hi[4], mid[4], lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    split3(y[2 * j], y[2 * j + 1], hi[j], mid[j], lo[j]);
  bf16* out = xs + (term_slab(blockIdx.z, bh) * S + r) * DN + c0;
  const long long term = (long long)S * DN;
  *reinterpret_cast<uint4*>(out) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(out + term) =
      make_uint4(mid[0], mid[1], mid[2], mid[3]);
  *reinterpret_cast<uint4*>(out + 2 * term) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// ---------------------------- fp32 forward ------------------------------

// grid (ceil(S / 64), batch * heads), 128 threads, 64 rows a block. k's
// and v's terms come from the scratch's slots 0 and 1, qs's are formed
// here. Items [0, tiles): k for the row stats; then k, v of each tile.
template <int DK>
__global__ void __launch_bounds__(TC_THREADS, F32Occupancy<DK>::FWD)
    fwd_f32_kernel(
    const float* __restrict__ q, const bf16* __restrict__ xs,
    float* __restrict__ o, float* __restrict__ mo, float* __restrict__ no,
    const __grid_constant__ CUtensorMap map_x, int heads, int S, int d,
    float scale, int vec, int tma) {
  constexpr int DN = DK, GB = 3 * Tiles<DK>::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t su = smem_u32(sm), ring = GB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int q0 = blockIdx.x * TILE, live = min(TILE, S - q0);
  const float cl = LOG2E;
  __shared__ uint64_t full[STAGES];
  init_ring(full, tma);
  form_terms_f32<DN>(sm, 0, q + base, ld, q0, q0 + live, d, scale, nullptr,
                     S, vec);

  const int tiles = (S + TILE - 1) / TILE, items = 3 * tiles;
  auto fetch = [&](int it) {
    if (it < items) {
      const int stage = it % STAGES;
      const bool is_v = it >= tiles && ((it - tiles) & 1);
      const int k0 = (it < tiles ? it : (it - tiles) >> 1) * TILE;
      fetch_terms<DN>(sm, ring + stage * GB, &map_x, &full[stage], tma, xs,
                      term_slab(is_v, bh), k0, S);
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  float m[2] = {NEG, NEG}, n[2] = {0.f, 0.f}, nml[2], rn[2];
  float acc[DN / 2], p[32];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < items; ++it) {
    ring_next(full, it, tma);
    fetch(it + STAGES - 1);
    const uint32_t xt = su + ring + (it % STAGES) * GB;
    const int k0 = (it < tiles ? it : (it - tiles) >> 1) * TILE;
    const int klive = min(TILE, S - k0);
    if (it >= tiles && ((it - tiles) & 1)) {
      rs_pairs<DK>(acc, p, xt);  // o += p . v
      continue;
    }
    float s[32];
    nt_pairs<DK>(s, su, xt);
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
    // sweep 2: p = e / n, kept for the v item
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[4 * j + i] = 8 * j < klive
                           ? __fmul_rn(expo(s[4 * j + i], cl, nml[i >> 1]),
                                       rn[i >> 1])
                           : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * warp + g + 8 * r;
    if (rr >= live) continue;
    const int row = q0 + rr;
    store_row_f32<DN>(o + base + (long long)row * ld, acc, r, d, 1.f);
    if (t == 0) {
      mo[(long long)bh * S + row] = m[r];
      no[(long long)bh * S + row] = n[r];
    }
  }
}

// ---------------------------- fp32 backward -----------------------------

// grid (ceil(S / 64), batch * heads), 128 threads: dq, the row terms
// (-m log2(e), 1 / n, r) and the terms of qs and g (scratch slots 2, 3),
// which it forms; k's and v's come from slots 0 and 1. Two sweeps over the
// keys (r, then dq), each tile an item of v (dp, kept) then one of k.
template <int DK>
__global__ void __launch_bounds__(TC_THREADS, F32Occupancy<DK>::BWD)
    bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    float4* __restrict__ rs, bf16* __restrict__ xs, float* __restrict__ dq,
    const __grid_constant__ CUtensorMap map_x, int heads, int S, int d,
    float scale, int vec, int tma) {
  constexpr int DN = DK, GB = 3 * Tiles<DK>::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t su = smem_u32(sm), gt = GB, ring = 2 * GB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int q0 = blockIdx.x * TILE, live = min(TILE, S - q0);
  const float cl = LOG2E;
  __shared__ uint64_t full[STAGES];
  init_ring(full, tma);
  form_terms_f32<DN>(sm, 0, q + base, ld, q0, q0 + live, d, scale,
                     xs + term_slab(2, bh) * S * DN, S, vec);
  form_terms_f32<DN>(sm, gt, gr + base, ld, q0, q0 + live, d, 1.f,
                     xs + term_slab(3, bh) * S * DN, S, vec);

  float nml[2], rn[2], nis[2], rr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    const bool in = row < live;
    const float m = in ? mo[(long long)bh * S + q0 + row] : 0.f;
    const float n = in ? no[(long long)bh * S + q0 + row] : 1.f;
    nml[r] = -(m * cl);
    rn[r] = __frcp_rn(n);
    nis[r] = __fdiv_rn(1.f, __fmul_rn(n, n));
    rr[r] = 0.f;
  }

  const int tiles = (S + TILE - 1) / TILE, items = 4 * tiles;
  auto fetch = [&](int it) {
    if (it < items) {
      const int stage = it % STAGES, k0 = ((it >> 1) % tiles) * TILE;
      fetch_terms<DN>(sm, ring + stage * GB, &map_x, &full[stage], tma, xs,
                      term_slab(!(it & 1), bh), k0, S);
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  float acc[DN / 2], dp[32];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < items; ++it) {
    ring_next(full, it, tma);
    fetch(it + STAGES - 1);
    const uint32_t xt = su + ring + (it % STAGES) * GB;
    const int tile = (it >> 1) % tiles, k0 = tile * TILE;
    const int klive = min(TILE, S - k0);
    const bool sweep0 = it < 2 * tiles;
    if (!(it & 1)) {
      nt_pairs<DK>(dp, su + gt, xt);  // dp = g . v^T
      continue;
    }
    float s[32];
    nt_pairs<DK>(s, su, xt);
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
        if (sweep0)
          rr[r] = __fadd_rn(rr[r],
                            __fmul_rn(__fmul_rn(dp[4 * j + i], nis[r]), e));
        else
          s[4 * j + i] =
              __fmul_rn(__fsub_rn(__fmul_rn(dp[4 * j + i], rn[r]), rr[r]),
                        e);
      }
    }
    if (sweep0) {
      if (tile == tiles - 1)
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
    rs_pairs<DK>(acc, s, xt);  // sweep 2: dq += ds . k
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row < live)
      store_row_f32<DN>(dq + base + (long long)(q0 + row) * ld, acc, r, d,
                        scale);
  }
}

// grid (ceil(S / 64), batch * heads), 128 threads: a block owns 64 keys,
// forms their k and v terms, and works in the keys' orientation (as the
// bf16 kernel does). Each query tile is an item of g's terms (dp^T =
// V . g^T, kept) and then one of qs's terms with the row terms, at which
// dv += P^T . g reads g's stage before the ring refills it and dk += ds^T
// . qs follows.
template <int DK>
__global__ void __launch_bounds__(TC_THREADS, F32Occupancy<DK>::BWD)
    bwd_dkdv_f32_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float4* __restrict__ rs, const bf16* __restrict__ xs,
    float* __restrict__ dk, float* __restrict__ dv,
    const __grid_constant__ CUtensorMap map_x, int heads, int S, int d,
    int vec, int tma) {
  constexpr int DN = DK, GB = 3 * Tiles<DK>::BYTES, SB = GB + 1024;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t su = smem_u32(sm), vt = GB, ring = 2 * GB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int k0 = blockIdx.x * TILE, live = min(TILE, S - k0);
  const float cl = LOG2E;
  __shared__ uint64_t full[STAGES];
  init_ring(full, tma);
  form_terms_f32<DN>(sm, 0, k + base, ld, k0, k0 + live, d, 1.f, nullptr, S,
                     vec);
  form_terms_f32<DN>(sm, vt, v + base, ld, k0, k0 + live, d, 1.f, nullptr,
                     S, vec);

  const int tiles = (S + TILE - 1) / TILE, items = 2 * tiles;
  const float4* rsh = rs + (long long)bh * S;
  auto fetch = [&](int it) {
    if (it < items) {
      const int stage = it % STAGES, j0 = (it >> 1) * TILE;
      const uint32_t st = ring + stage * SB;
      fetch_terms<DN>(sm, st, &map_x, &full[stage], tma, xs,
                      term_slab(it & 1 ? 2 : 3, bh), j0, S);
      if (it & 1)
        for (int i = threadIdx.x; i < TILE; i += TC_THREADS) {
          const bool in = j0 + i < S;
          cp_async16(su + st + GB + 16 * i, in ? rsh + j0 + i : rsh, in);
        }
    }
    cp_async_commit();
  };
  fetch(0);

  float dka[DN / 2], dva[DN / 2], dp[32];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dka[i] = dva[i] = 0.f;
  for (int it = 0; it < items; ++it) {
    ring_next(full, it, tma);
    const uint32_t xt = su + ring + (it % STAGES) * SB;
    const int qlive = min(TILE, S - (it >> 1) * TILE);
    if (!(it & 1)) {
      fetch(it + 1);
      nt_pairs<DK>(dp, su + vt, xt);  // dp^T = V . g^T
      continue;
    }
    float s[32];
    nt_pairs<DK>(s, su, xt);
    // P^T and ds^T: a thread's keys g, g + 8 of its warp, queries 8j +
    // 2t..; a query past S has p and ds 0
    const float4* stats =
        reinterpret_cast<const float4*>(sm + ring + (it % STAGES) * SB + GB);
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
        const float4 st = stats[qc];  // -m log2(e), 1 / n, r
        const bool in = qc < qlive;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + hh;
          const float e = expo(s[i], cl, st.x);
          s[i] = in ? __fmul_rn(e, st.y) : 0.f;
          dp[i] = in ? __fmul_rn(__fsub_rn(__fmul_rn(dp[i], st.y), st.z), e)
                     : 0.f;
        }
      }
    }
    // dv += P^T . g from the previous item's stage
    rs_pairs<DK>(dva, s, su + ring + ((it + 1) % STAGES) * SB);
    __syncthreads();  // every warp is done with g's stage: refill it
    fetch(it + 1);
    rs_pairs<DK>(dka, dp, xt);  // dk += ds^T . qs
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= live) continue;
    const long long at = base + (long long)(k0 + row) * ld;
    store_row_f32<DN>(dv + at, dva, r, d, 1.f);
    store_row_f32<DN>(dk + at, dka, r, d, 1.f);
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

// The scratch's tensor map: `slots` operands' terms, batch * heads * 3
// slabs of (S, DN) each (false where the encoder refuses it: cp.async).
template <int DN>
static bool scratch_map(CUtensorMap* map, const bf16* xs, int S, int slots,
                        long long bh) {
  const long long slabs = slots * bh * 3;
  return slabs <= INT32_MAX &&
         make_tensor_map_3d(map, xs, S, DN, DN, TILE, (int)slabs,
                            (long long)S * DN);
}

// k's and v's terms into the scratch's slots 0 and 1.
template <int DN>
static cudaError_t split_kv(const float* k, const float* v, bf16* xs,
                            int batch, int heads, int S, int d, int vec,
                            cudaStream_t stream) {
  constexpr int THREADS = 256;
  const dim3 grid((S * (DN / 8) + THREADS - 1) / THREADS, batch * heads, 2);
  split_terms_kernel<DN><<<grid, THREADS, 0, stream>>>(k, v, xs, heads, S, d,
                                                       vec);
  return cudaGetLastError();
}

// The fp32 kernels take 64-row blocks only, all on `wgmma` (a block past
// S multiplies its zero rows too): a `mma.sync` path beside it would put
// the `wgmma`s on paths ptxas cannot prove uniform, and it serializes them.
template <int DK>
static int fwd_f32(const float* q, const float* k, const float* v, float* o,
                   float* m, float* n, bf16* xs, int batch, int heads, int S,
                   int d, float scale, int vec, int rows, int smem,
                   cudaStream_t stream) {
  if (rows != TILE || smem != smem_fwd_f32<DK>() || !xs)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_with(fwd_f32_kernel<DK>, smem);
  if (err == cudaSuccess)
    err = split_kv<DK>(k, v, xs, batch, heads, S, d, vec, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map{};
  const int tma = scratch_map<DK>(&map, xs, S, 2, (long long)batch * heads);
  const dim3 grid((S + TILE - 1) / TILE, batch * heads);
  fwd_f32_kernel<DK><<<grid, TC_THREADS, smem, stream>>>(
      q, xs, o, m, n, map, heads, S, d, scale, vec, tma);
  return (int)cudaGetLastError();
}

template <int DK>
static int bwd_f32(const float* q, const float* k, const float* v,
                   const float* g, const float* m, const float* n, float4* rs,
                   bf16* xs, float* dq, float* dk, float* dv, int batch,
                   int heads, int S, int d, float scale, int vec, int rows,
                   int smem_q, int smem_k, cudaStream_t stream) {
  if (rows != TILE || smem_q != smem_dq_f32<DK>() ||
      smem_k != smem_dkdv_f32<DK>() || !xs)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_with(bwd_dq_f32_kernel<DK>, smem_q);
  if (err == cudaSuccess) err = launch_with(bwd_dkdv_f32_kernel<DK>, smem_k);
  if (err == cudaSuccess)
    err = split_kv<DK>(k, v, xs, batch, heads, S, d, vec, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map{};
  const int tma = scratch_map<DK>(&map, xs, S, 4, (long long)batch * heads);
  const dim3 grid((S + TILE - 1) / TILE, batch * heads);
  bwd_dq_f32_kernel<DK><<<grid, TC_THREADS, smem_q, stream>>>(
      q, g, m, n, rs, xs, dq, map, heads, S, d, scale, vec, tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_f32_kernel<DK><<<grid, TC_THREADS, smem_k, stream>>>(
      k, v, rs, xs, dk, dv, map, heads, S, d, vec, tma);
  return (int)cudaGetLastError();
}

extern "C" {

// The widest head the kernels take.
int flash_trainable_max_head_dim() { return 128; }

// q, k, v, o: contiguous (batch, S, heads, d), all bf16 (is_f32 0) or all
// fp32; m, n: (batch, heads, S) fp32, the row max and row sum. nt: the
// bf16 terms of fp32(q) * scale in the bf16 kernels (1 where scale is a
// power of two, else 3); vec: 16-byte loads (d % 8 == 0, every operand
// 16-byte aligned); xs: for fp32, a (2, batch * heads, 3, S, the head dim
// padded to 64 or 128) bf16 scratch for k's and v's terms, else null;
// rows, smem: the plan.
int mha_flash_trainable_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* n, void* xs, int batch,
                            int heads, int S, int d, float scale, int is_f32,
                            int nt, int vec, int rows, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
#define FWD_F32(DK)                                                          \
  return fwd_f32<DK>((const float*)q, (const float*)k, (const float*)v,      \
                     (float*)o, m, n, (bf16*)xs, batch, heads, S, d, scale,  \
                     vec, rows, smem, s)
    if (d <= 64) FWD_F32(64);
    FWD_F32(128);
#undef FWD_F32
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
// from the forward; rs: a (batch, heads, S) x 4 fp32 scratch of row terms
// that the dq kernel writes and the dk/dv kernel reads; qx: for bf16 with
// three q terms a (batch * heads, 3, S, the head dim padded to 64 or 128)
// bf16 scratch for them, for fp32 a (4, batch * heads, 3, S, padded) one
// for the terms of k, v, qs and g, else null. rows, smem_q, smem_k: the
// plan. bf16: two launches, dq's then dk/dv's; fp32: the split of k and v
// before them.
int mha_flash_trainable_bwd(const void* q, const void* k, const void* v,
                            const void* g, const float* m, const float* n,
                            void* rs, void* qx, void* dq, void* dk, void* dv,
                            int batch, int heads, int S, int d, float scale,
                            int is_f32, int nt, int vec, int rows,
                            int smem_q, int smem_k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
#define BWD_F32(DK)                                                          \
  return bwd_f32<DK>((const float*)q, (const float*)k, (const float*)v,      \
                     (const float*)g, m, n, (float4*)rs, (bf16*)qx,          \
                     (float*)dq, (float*)dk, (float*)dv, batch, heads, S, d, \
                     scale, vec, rows, smem_q, smem_k, s)
    if (d <= 64) BWD_F32(64);
    BWD_F32(128);
#undef BWD_F32
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
