// Flash attention (forward) with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (entry flash_attention_fwd, wrapped by repro.kernels.ops.flash_attention
// and called from repro.models.attention under use_pallas=True):
//
//     out[b, t, h] = softmax_s(scale * q[b, t, h] . k[b, s, h / group]) v[...]
//
// over the columns s that are valid: s < S, and for causal attention
// s <= t, and with a window s > t - window.  Layout is the model's:
// q and out (B, T, H, dh), k and v (B, S, KV, dh), all contiguous.
// repro_torch/kernels/flash_attention.py holds the plain version, which
// runs on CPU tensors and takes the same tiles in the same order.
//
// Arithmetic, kept from the reference: q is scaled by dh^-0.5 in float32
// before the dot; every product and sum is float32 whatever the input
// type; NEG_INF = -2e38 is finite, so a fully masked tile gives p = 1 for
// every column and the first valid tile multiplies that garbage by
// alpha = exp(-2e38 - m) = 0; the output is acc / max(l, 1e-30) rounded to
// the input type.
//
// What bounds it on an H100: operations.  4 T S dh H B flops (halved by a
// causal mask) against (2 T H + 2 S KV) dh B elements moved.  This first
// version does the products on the float32 units outside the tensor cores
// (the reference's float32 arithmetic), so it runs far from the bf16
// tensor-core bound; wgmma and TMA are later work.  Design:
//   * one block of 256 threads per (64-row q tile, head, batch); the q
//     tile, scaled, sits in shared memory for the whole block;
//   * the block walks the 64-column K/V tiles in order.  With a causal
//     mask it skips the tiles that are masked for every row of its q tile
//     (past the diagonal, or before the window): for a row that has a
//     valid column, such a tile adds exactly nothing (p = 0 after the
//     row's first valid tile, or garbage that the first valid tile zeroes),
//     so skipping them changes no bit of the result;
//   * a K tile is loaded into shared memory (float32), each thread
//     computes a 4 x 4 block of the 64 x 64 logits (rows ty + 16i, columns
//     tx + 16j, float4 reads along dh), masks them, and the 16 threads of a
//     row group reduce the row max and sum with warp shuffles; the running
//     (m, l) are kept per row in registers (identical in the 16 threads);
//   * p goes to shared memory, the V tile replaces the K tile, and each
//     thread scales its 4 rows x dh/16 columns of acc (in registers) by
//     alpha and adds p V to them.
//   * ragged T and S are bound-checked: rows past T are computed on zeros
//     and never written; columns past S read as zeros and are masked.
//   * the dot products use explicit fused multiply-adds (__fmaf_rn): the
//     library is built with -fmad=false, which the event-sim kernel's
//     exactness needs, and which would otherwise split every product here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;        // q-tile rows
constexpr int BK = 64;        // K/V-tile columns
constexpr int THREADS = 256;  // 16 x 16
constexpr int PS = BK + 4;    // row stride of the p tile (floats)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Max or sum over the 16 lanes of a half warp (the threads of one row group).
__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Row stride of the q and K/V tiles (floats): 16-byte rows, no bank conflicts.
__host__ __device__ constexpr int row_stride(int dh) { return dh + 4; }

__host__ __device__ constexpr int shared_bytes(int dh) {
  return (int)sizeof(float) * (BQ * row_stride(dh) + BK * row_stride(dh) + BQ * PS);
}

// Rows [row0, row0 + BQ) of one (b, h).  T_len, S_len: sequence lengths;
// H, KV: head counts; window 0 = none.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int T_len,
                 int S_len, int H, int KV, int causal, int window, float scale) {
  constexpr int QS = row_stride(DH);
  constexpr int DJ = DH / 16;  // acc columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;            // BQ x QS, scaled q
  float* skv = sq + BQ * QS;   // BK x QS, the K tile, then the V tile
  float* sp = skv + BK * QS;   // BQ x PS, p

  const int row0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH, t = row0 + r;
    float x = 0.f;
    if (t < T_len) x = to_f32(q[((size_t)(b * (size_t)T_len + t) * H + h) * DH + d]) * scale;
    sq[r * QS + d] = x;
  }

  // K/V tiles to visit
  const int nk = (S_len + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    const int last_row = min(row0 + BQ, T_len) - 1;
    kt_hi = min(nk, last_row / BK + 1);
    if (window > 0) kt_lo = max(0, row0 - window + 1) / BK;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int col0 = kt * BK;
    __syncthreads();  // the previous V tile and the q tile are settled
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int c = e / DH, d = e % DH, s = col0 + c;
      skv[c * QS + d] =
          s < S_len ? to_f32(k[((size_t)(b * (size_t)S_len + s) * KV + kvh) * DH + d]) : 0.f;
    }
    __syncthreads();

    float s_[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_[i][j] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&skv[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_[i][j] = __fmaf_rn(qa[i].x, kb[j].x, s_[i][j]);
          s_[i][j] = __fmaf_rn(qa[i].y, kb[j].y, s_[i][j]);
          s_[i][j] = __fmaf_rn(qa[i].z, kb[j].z, s_[i][j]);
          s_[i][j] = __fmaf_rn(qa[i].w, kb[j].w, s_[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        bool valid = col < S_len;
        if (causal) valid = valid && col <= row;
        if (window > 0) valid = valid && col > row - window;
        if (!valid) s_[i][j] = NEG_INF;
        mx = fmaxf(mx, s_[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s_[i][j] - m_new);
        sp[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done with the K tile; p is written

    for (int e = tid; e < BK * DH; e += THREADS) {
      const int c = e / DH, d = e % DH, s = col0 + c;
      skv[c * QS + d] =
          s < S_len ? to_f32(v[((size_t)(b * (size_t)S_len + s) * KV + kvh) * DH + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha[i];
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sp[(ty + 16 * i) * PS + c]);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float v0 = skv[c * QS + d], v1 = skv[(c + 1) * QS + d];
        const float v2 = skv[(c + 2) * QS + d], v3 = skv[(c + 3) * QS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = __fmaf_rn(pa[i].x, v0, acc[i][j]);
          acc[i][j] = __fmaf_rn(pa[i].y, v1, acc[i][j]);
          acc[i][j] = __fmaf_rn(pa[i].z, v2, acc[i][j]);
          acc[i][j] = __fmaf_rn(pa[i].w, v3, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty + 16 * i;
    if (t >= T_len) continue;
    const float inv_l = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)(b * (size_t)T_len + t) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store_out(&o[tx + 16 * j], acc[i][j] / inv_l);
  }
}

template <typename T, int DH>
int launch_typed(const void* q, const void* k, const void* v, void* out, int B,
                 int T_len, int S_len, int H, int KV, int causal, int window,
                 cudaStream_t st) {
  constexpr int bytes = shared_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<T, DH><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), T_len, S_len, H, KV, causal, window,
      (float)(1.0 / sqrt((double)DH)));  // float32(dh ** -0.5), as the reference
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out, int B,
              int T_len, int S_len, int H, int KV, int causal, int window,
              cudaStream_t st) {
  switch (dh) {
    case 16: return launch_typed<T, 16>(q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
    case 32: return launch_typed<T, 32>(q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
    case 64: return launch_typed<T, 64>(q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
    case 128: return launch_typed<T, 128>(q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, k, v and out alike).  Launches on
// `stream` and returns the cudaError_t.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int T_len,
                                      int S_len, int H, int KV, int dh, int causal,
                                      int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, B, T_len, S_len, H, KV, causal,
                                    window, st);
  return (int)cudaErrorInvalidValue;
}
