// WKV6 recurrence: the RWKV6 time-mix scan with a (dh x dh) state per
// (batch, head).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan.py::_wkv_kernel
// (entry wkv6_scan, wrapped by repro.kernels.ops.wkv6_scan), and runs the
// reference model's _wkv_scan (src/repro/models/rwkv.py), of which the TPU
// kernel is the zero-state case.  Per (b, h), i the key index and j the
// value index, all arithmetic in float32:
//
//     y_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//     S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]
//
// Layout: r, k, v, w and y (B, T, H, dh), the model's own layout (no
// transpose); u (H, dh) float32; the state (B, H, dh, dh) float32, S[i, j]
// at i * dh + j.  The state in is optional (null: start from zero) and the
// final state is written out; in and out may be the same buffer, so the
// state is updated in place in a cache.  repro_torch/kernels/linear_scan.py
// holds the plain version (a loop over T, step for step the reference's
// _wkv_scan), which runs on CPU tensors.
//
// Types: r, k and v share one element type, w has its own and so has y:
// float32 throughout; bf16 throughout (the ops path); or bf16 r/k/v with
// float32 w and y (the model path in bf16), so the wrapper casts nothing.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// dependence along T.  Each (b, h) is one chain of T state updates; the
// full-width prefill (B 2, H 64) has 128 such chains for 132 SMs, each of
// 2 048 steps of 64 x 64 multiply-adds.  Design (simple and right; a
// chunked, tensor-core form is later work):
//   * one block per (h, b), one thread per value column j: the thread
//     keeps S[:, j] in registers (dh floats, dh a template parameter);
//   * r, k, v and w of a tile of TILE timesteps are staged in shared memory
//     as float32 (each row of dh values read once, coalesced), so a step
//     reads r_t[i], k_t[i] and w_t[i] as broadcasts and v_t[j] from its
//     own bank;
//   * u lives in shared memory; y_t[j] is stored as each step ends.
//   * The multiply-adds are __fmaf_rn: the library is built with
//     -fmad=false, which would otherwise split every one of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;  // timesteps staged per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_y(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TI, typename TW, typename TY, int DH>
__global__ void __launch_bounds__(DH)
    wkv6_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                const TI* __restrict__ v, const TW* __restrict__ w,
                const float* __restrict__ u, const float* state_in, float* state_out,
                TY* __restrict__ y, int T, int H) {
  __shared__ float sr[TILE][DH], sk[TILE][DH], sv[TILE][DH], sw[TILE][DH];
  __shared__ float su[DH];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t row = (size_t)H * DH;  // elements from one timestep to the next
  const size_t base = (size_t)b * T * row + (size_t)h * DH + j;
  const size_t sbase = ((size_t)b * H + h) * DH * DH + j;

  float S[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = state_in ? state_in[sbase + (size_t)i * DH] : 0.f;
  su[j] = u[h * DH + j];

  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int nt = min(TILE, T - t0);
    __syncthreads();  // the previous tile is consumed
    for (int t = 0; t < nt; ++t) {
      const size_t off = base + (size_t)(t0 + t) * row;
      sr[t][j] = to_f32(r[off]);
      sk[t][j] = to_f32(k[off]);
      sv[t][j] = to_f32(v[off]);
      sw[t][j] = to_f32(w[off]);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vj = sv[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float kv = sk[t][i] * vj;
        acc = __fmaf_rn(sr[t][i], __fmaf_rn(su[i], kv, S[i]), acc);
        S[i] = __fmaf_rn(sw[t][i], S[i], kv);
      }
      store_y(&y[base + (size_t)(t0 + t) * row], acc);
    }
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) state_out[sbase + (size_t)i * DH] = S[i];
}

template <typename TI, typename TW, typename TY, int DH>
int launch_typed(const void* r, const void* k, const void* v, const void* w, const float* u,
                 const float* state_in, float* state_out, void* y, int B, int T, int H,
                 cudaStream_t st) {
  wkv6_kernel<TI, TW, TY, DH><<<dim3(H, B), DH, 0, st>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k), static_cast<const TI*>(v),
      static_cast<const TW*>(w), u, state_in, state_out, static_cast<TY*>(y), T, H);
  return (int)cudaGetLastError();
}

template <typename TI, typename TW, typename TY>
int launch_dh(int dh, const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* state_in, float* state_out, void* y, int B, int T,
              int H, cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch_typed<TI, TW, TY, 16>(r, k, v, w, u, state_in, state_out, y, B, T, H, st);
    case 32:
      return launch_typed<TI, TW, TY, 32>(r, k, v, w, u, state_in, state_out, y, B, T, H, st);
    case 64:
      return launch_typed<TI, TW, TY, 64>(r, k, v, w, u, state_in, state_out, y, B, T, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dtype codes 0 = float32, 1 = bfloat16, for (r/k/v, w, y): (0, 0, 0),
// (1, 1, 1) or (1, 0, 0).  u is float32 (H, dh); state_in may be null (a
// zero state) and may equal state_out.  dh in {16, 32, 64}; T >= 1.
// Launches on `stream` and returns the cudaError_t.
extern "C" int wkv6_launch(int in_dtype, int w_dtype, int y_dtype, const void* r,
                           const void* k, const void* v, const void* w, const float* u,
                           const float* state_in, float* state_out, void* y, int B, int T,
                           int H, int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || state_out == nullptr) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && w_dtype == 0 && y_dtype == 0)
    return launch_dh<float, float, float>(dh, r, k, v, w, u, state_in, state_out, y, B, T, H,
                                          st);
  if (in_dtype == 1 && w_dtype == 1 && y_dtype == 1)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        dh, r, k, v, w, u, state_in, state_out, y, B, T, H, st);
  if (in_dtype == 1 && w_dtype == 0 && y_dtype == 0)
    return launch_dh<__nv_bfloat16, float, float>(dh, r, k, v, w, u, state_in, state_out, y,
                                                  B, T, H, st);
  return (int)cudaErrorInvalidValue;
}
