// Forward online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hypervla_tpu/ops/flash_attention.py::
// flash_attention (body `_flash_kernel`) and computes what it computes: q, k
// and v are widened to fp32, q is scaled by 1/sqrt(d) in fp32, the scores,
// the probabilities and both products stay in fp32 (P is never rounded to
// the input type), the softmax is the streaming one (running row maximum
// and row sum, the accumulator rescaled as the maximum grows), and the
// output is rounded once to q's type. That is another function than the
// training attention of fused_attention.cu, which rounds scores and P to
// bf16 for the tensor cores, so this kernel multiplies with fp32 FMAs.
//
// What bounds it on this card: operations. One head of the serving step
// (257 x 257 x 64) reads ~0.1 MB and does 34 MFLOP in fp32; at batch 64 the
// 768 heads do 13 GFLOP against 67 TFLOP/s of fp32 outside the tensor cores.
// At the serving shape (12 heads) the launch itself is most of the time.
//
// Design: one block takes 32 query rows of one head (8 warps x 4 rows) and
// walks the keys in tiles of 64, K and V of a tile staged in shared memory
// as fp32. For the scores a lane owns two keys of the tile and keeps four
// rows' partial dots, so each K value read from shared memory feeds four
// FMAs; for P.V a lane owns head dims lane, lane + 32, ... and each V value
// feeds four rows. Nothing is padded: the key loop ends at kv_len, and the
// keys of the last tile past it are masked with -1e30 as the TPU kernel
// masks its padding. Heads are read in place through strides ((B, S, heads,
// d) needs no transpose), and Lq may differ from Lk. The TPU kernel's
// 128-row blocks and 128-padded sequences are not carried over.
//
// Plain C interface (loaded with ctypes). The entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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

constexpr int FA_WARPS = 8;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_R = 4;                  // query rows per warp
constexpr int FA_ROWS = FA_WARPS * FA_R; // query rows per block
constexpr int FA_KT = 64;                // keys per tile: two per lane
constexpr int FA_MAXDPL = 4;             // head dims per lane: d <= 128
constexpr float FA_NEG_INF = -1e30f;

// Strides in elements; the head dim has stride 1.
struct FaStrides {
  long long batch, head, row;
};

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, FaStrides sq, FaStrides sk, FaStrides sv,
    FaStrides so, int heads, int q_len, int kv_len, int d, float sm_scale) {
  extern __shared__ float smem[];
  const int kpad = d + 1;  // lanes on neighbouring keys hit different banks
  float* Ks = smem;                       // FA_KT x (d + 1)
  float* Vs = Ks + FA_KT * kpad;          // FA_KT x d
  float* Qs = Vs + FA_KT * d;             // FA_ROWS x d, scaled
  float* Ps = Qs + FA_ROWS * d;           // FA_ROWS x FA_KT

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row0 = blockIdx.x * FA_ROWS;
  const T* qh = q + b * sq.batch + h * sq.head;
  const T* kh = k + b * sk.batch + h * sk.head;
  const T* vh = v + b * sv.batch + h * sv.head;
  T* oh = out + b * so.batch + h * so.head;

  for (int idx = tid; idx < FA_ROWS * d; idx += FA_THREADS) {
    const int r = idx / d, c = idx % d;
    Qs[idx] = row0 + r < q_len
                  ? ld(qh + (long long)(row0 + r) * sq.row + c) * sm_scale
                  : 0.f;
  }

  float row_max[FA_R], row_sum[FA_R], acc[FA_R][FA_MAXDPL];
#pragma unroll
  for (int rr = 0; rr < FA_R; ++rr) {
    row_max[rr] = FA_NEG_INF;
    row_sum[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < FA_MAXDPL; ++j) acc[rr][j] = 0.f;
  }
  const float* qw = Qs + warp * FA_R * d;
  float* pw = Ps + warp * FA_R * FA_KT;

  for (int k0 = 0; k0 < kv_len; k0 += FA_KT) {
    __syncthreads();  // the previous tile has been read (and Qs is written)
    for (int idx = tid; idx < FA_KT * d; idx += FA_THREADS) {
      const int r = idx / d, c = idx % d;
      const bool live = k0 + r < kv_len;
      Ks[r * kpad + c] =
          live ? ld(kh + (long long)(k0 + r) * sk.row + c) : 0.f;
      Vs[idx] = live ? ld(vh + (long long)(k0 + r) * sv.row + c) : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[FA_R][2];
#pragma unroll
    for (int rr = 0; rr < FA_R; ++rr) s[rr][0] = s[rr][1] = 0.f;
    const float* ka = Ks + lane * kpad;
    const float* kb = Ks + (lane + 32) * kpad;
    for (int c = 0; c < d; ++c) {
      const float k_a = ka[c], k_b = kb[c];
#pragma unroll
      for (int rr = 0; rr < FA_R; ++rr) {
        const float qv = qw[rr * d + c];
        s[rr][0] = fmaf(qv, k_a, s[rr][0]);
        s[rr][1] = fmaf(qv, k_b, s[rr][1]);
      }
    }
    const bool live_a = k0 + lane < kv_len, live_b = k0 + lane + 32 < kv_len;
#pragma unroll
    for (int rr = 0; rr < FA_R; ++rr) {
      const float sa = live_a ? s[rr][0] : FA_NEG_INF;
      const float sb = live_b ? s[rr][1] : FA_NEG_INF;
      const float new_max = fmaxf(row_max[rr], warp_max(fmaxf(sa, sb)));
      const float correction = expf(row_max[rr] - new_max);
      const float pa = expf(sa - new_max), pb = expf(sb - new_max);
      row_sum[rr] = row_sum[rr] * correction + warp_sum(pa + pb);
      row_max[rr] = new_max;
#pragma unroll
      for (int j = 0; j < FA_MAXDPL; ++j) acc[rr][j] *= correction;
      pw[rr * FA_KT + lane] = pa;
      pw[rr * FA_KT + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P . V, a lane owning head dims lane, lane + 32, ...
    for (int kk = 0; kk < FA_KT; ++kk) {
      float vv[FA_MAXDPL];
#pragma unroll
      for (int j = 0; j < FA_MAXDPL; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < d ? Vs[kk * d + c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < FA_R; ++rr) {
        const float p = pw[rr * FA_KT + kk];
#pragma unroll
        for (int j = 0; j < FA_MAXDPL; ++j)
          acc[rr][j] = fmaf(p, vv[j], acc[rr][j]);
      }
    }
    __syncwarp();  // P has been read before the next tile overwrites it
  }

#pragma unroll
  for (int rr = 0; rr < FA_R; ++rr) {
    const int row = row0 + warp * FA_R + rr;
    if (row >= q_len) continue;
#pragma unroll
    for (int j = 0; j < FA_MAXDPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) st(oh + (long long)row * so.row + c, acc[rr][j] / row_sum[rr]);
    }
  }
}

extern "C" {

// The widest head the kernel takes.
int flash_attention_max_head_dim() { return 32 * FA_MAXDPL; }

// q, out: (batch, q_len, heads, d); k, v: (batch, kv_len, heads, d), each
// read through its (batch, head, row) strides in elements, the head dim
// contiguous. is_f32: all four fp32, else bf16. sm_scale multiplies q.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, long long q_sb, long long q_sh,
                        long long q_sr, long long k_sb, long long k_sh,
                        long long k_sr, long long v_sb, long long v_sh,
                        long long v_sr, long long o_sb, long long o_sh,
                        long long o_sr, int batch, int heads, int q_len,
                        int kv_len, int d, float sm_scale, int is_f32,
                        void* stream) {
  const FaStrides sq{q_sb, q_sh, q_sr}, sk{k_sb, k_sh, k_sr},
      sv{v_sb, v_sh, v_sr}, so{o_sb, o_sh, o_sr};
  const dim3 grid((q_len + FA_ROWS - 1) / FA_ROWS, batch * heads);
  const size_t smem =
      sizeof(float) * (FA_KT * (2 * d + 1) + FA_ROWS * (d + FA_KT));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (is_f32) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<float><<<grid, FA_THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, sq,
        sk, sv, so, heads, q_len, kv_len, d, sm_scale);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<bf16><<<grid, FA_THREADS, smem, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, sq, sk,
        sv, so, heads, q_len, kv_len, d, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
