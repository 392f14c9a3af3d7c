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
// holds the plain versions (a loop over T, step for step the reference's
// _wkv_scan, and the chunked algorithm below in float32), which run on CPU
// tensors.
//
// Types: r, k and v share one element type, w has its own and so has y:
// float32 throughout; bf16 throughout (the ops path); or bf16 r/k/v with
// float32 w and y (the model path in bf16), so the wrapper casts nothing.
//
// Two kernels; the wrapper picks one from T alone.
//
// wkv6_kernel, the sequential scan (T < 64: the engine's decode steps and
// short admissions).  One block per (h, b), one thread per value column j
// holding S[:, j] in registers; r, k, v and w of TILE timesteps staged in
// shared memory as float32.  Each step is a chain of dh dependent FMAs, so
// a long T is bound by that chain (128 chains of 2 048 steps at the
// prefill shape, on 132 SMs).
//
// wkv6_chunked_kernel, the chunked scan (T >= 64).  The recurrence runs
// once per chunk of C timesteps, and inside a chunk its work is four
// matrix products on the tensor cores (gated linear attention's
// "secondary-level chunking", Yang et al. 2023, section 4).  For a chunk
// that starts at state S0, with D(a, b)[i] = prod_{a <= tau < b} w_tau[i]
// (1 when empty):
//
//   y_t = (r_t . D(0, t))^T S0                            inter-chunk
//       + sum_{s < t} [sum_i r_t[i] D(s+1, t)[i] k_s[i]] v_s      intra
//       + (sum_i r_t[i] u[i] k_t[i]) v_t                  bonus diagonal
//   S_C = diag(D(0, C)) S0 + sum_{s < C} (k_s . D(s+1, C)) v_s^T
//
// Numerics: no factor exceeds 1 and nothing is divided.  Every decay
// factor is a running product of w over a range of at most 16 steps, or a
// product of such; the cumulative-log-difference form would turn w = 0
// into NaN and lose a small decay after a large one.  With the chunk cut
// into sub-chunks of 16 and Q, P, G the in-sub-chunk prefix, suffix and
// total products, for t in sub-chunk a and s in sub-chunk b:
//   * b < a:  D(s+1, t) = P_s . prod_{b < c < a} G_c . Q_t, so that block
//     of the intra matrix A is (r Q)_a diag(mid) (k P)_b^T, a product of
//     16 x dh by dh x 16 on the tensor cores;
//   * b = a:  the 16 x 16 diagonal block is cut at its midpoint m: its
//     lower-left 8 x 8 quadrant, D(s+1, t) = D(s+1, m) . D(m, t), is a
//     product on the tensor cores; its two diagonal quadrants run on the
//     CUDA cores, each k_s carried forward as a running product
//     k_s . D(s+1, t);
//   * D(0, t) = prod_{c < a} G_c . Q_t and D(s+1, C) = P_s . prod_{c > b} G_c.
// The products A V, (r D(0,.)) S0 and (k D(.+1, C))^T V and the
// off-diagonal blocks run on mma.sync.m16n8k8 in TF32 with float32
// accumulation, split ("3xTF32", as CUTLASS's fast float32 GEMM): each
// float32 operand is hi + lo, two TF32 numbers, and a.b is taken as
// hi.hi + hi.lo + lo.hi.  A bf16 operand (v on the model path) is exact
// in TF32, so its products take two terms.
//
// Layout on the chip: one block of 8 warps per (value-column slice, h, b)
// walks its chunks in order, in three phases between syncs: (1) the decay
// factors; (2) the off-diagonal blocks and quadrants of A and the state
// update on the tensor cores, the diagonal quadrants on the CUDA cores;
// (3) y = A V + (r D(0,.)) S0.  The state lives in the warps' accumulator
// fragments, copied into shared memory at the start of each chunk for
// the inter-chunk product.  r, k, v and w of the next chunk are copied
// into shared memory by cp.async while the current chunk computes (two
// buffers; a ragged last chunk is zero-filled and its w read as 1).  One
// launch per call.  What bounds it: at the prefill shape (B 2, T 2 048,
// 64 heads of 64) the bytes (r/k/v/w in, y out) need 0.071 ms at
// 3.35 TB/s and the products, each once, 0.013 ms at the TF32 rate; but
// 128 blocks, one per SM, walk 32 chunks each in sequence, and each
// chunk's phases are latency- and issue-bound with 2 warps per SM
// sub-partition (0.28 ms on an H100 at 700 W, 4x the byte bound;
// tools/wkv_ablation.py times each part).
//
// Build-time choices, for tools/wkv_ablation.py only (the library is built
// with the defaults): WKV_CHUNK (C, 32 or 64), WKV_SPLIT_TF32 (0: plain
// TF32, one product), WKV_JBLOCKS (1, 2 or 4 blocks per (b, h), each a
// slice of the value columns, the intra matrix A computed in each)
// and WKV_ASYNC_COPY (0: each chunk's copy is waited for as soon as
// issued).
//
// The multiply-adds are __fmaf_rn: the library is built with -fmad=false,
// which would otherwise split every one of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef WKV_CHUNK
#define WKV_CHUNK 64
#endif
#ifndef WKV_SPLIT_TF32
#define WKV_SPLIT_TF32 1
#endif
#ifndef WKV_JBLOCKS
#define WKV_JBLOCKS 1
#endif
#ifndef WKV_ASYNC_COPY
#define WKV_ASYNC_COPY 1
#endif

#define TF32_SPLIT WKV_SPLIT_TF32
#include "tf32_mma.cuh"

namespace {

constexpr int TILE = 32;  // timesteps staged per tile (sequential kernel)

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

// ---------------------------------------------------------------- chunked

constexpr int NW = 8;              // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int SUB = 16;            // sub-chunk: the diagonal blocks' size

// N (8 or 16) consecutive elements of a staged row, 16-byte aligned, as
// float32.
template <int N>
__device__ __forceinline__ void load_row(float (&out)[N], const float* p) {
#pragma unroll
  for (int e = 0; e < N / 4; ++e) {
    const float4 q = reinterpret_cast<const float4*>(p)[e];
    out[4 * e] = q.x;
    out[4 * e + 1] = q.y;
    out[4 * e + 2] = q.z;
    out[4 * e + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void load_row(float (&out)[N], const __nv_bfloat16* p) {
#pragma unroll
  for (int e = 0; e < N / 8; ++e) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[e];
    const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      out[8 * e + 2 * m] = __uint_as_float(wd[m] << 16);
      out[8 * e + 2 * m + 1] = __uint_as_float(wd[m] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of one block, in bytes: two buffers of the chunk's staged
// rows (r, k, w full width; v the block's slice of value columns, its rows
// padded by 32 bytes so that the B fragments of v load without bank
// conflicts), then float32 arrays: R = r Q, K = k P (C x (dh + 4)); the
// half-sub-chunk factors R2 = r D(16 a + 8, t) of each sub-chunk's second
// half and K2 = k D(s + 1, 16 a + 8) of its first half (C/2 x (dh + 4));
// the intra matrix A (C x (C + 4)), the state S (dh x (DJ + 8)), and the
// per-column vectors G (sub-chunk totals), H (prefix products of G) and u.
template <typename TI, typename TW, int D, int C, int DJ>
struct Layout {
  static constexpr int NSUB = C / SUB;
  static constexpr int RS = D + 4, AS = C + 4, SS = DJ + 8;  // float strides
  static constexpr int R_ROW = D * (int)sizeof(TI);           // staged row bytes
  static constexpr int V_ROW = DJ * (int)sizeof(TI) + 32;
  static constexpr int W_ROW = D * (int)sizeof(TW);
  static constexpr int RAW_R = 0, RAW_K = C * R_ROW, RAW_V = 2 * C * R_ROW,
                       RAW_W = RAW_V + C * V_ROW, RAW = RAW_W + C * W_ROW;
  static constexpr int F_R = 2 * RAW, F_K = F_R + C * RS * 4, F_R2 = F_K + C * RS * 4,
                       F_K2 = F_R2 + C / 2 * RS * 4, F_A = F_K2 + C / 2 * RS * 4,
                       F_S = F_A + C * AS * 4, F_G = F_S + D * SS * 4,
                       F_H = F_G + NSUB * D * 4, F_U = F_H + NSUB * D * 4,
                       BYTES = F_U + D * 4;
};

template <typename T>
__device__ __forceinline__ const T* row_at(const unsigned char* buf, int off, int row_bytes,
                                           int t) {
  return reinterpret_cast<const T*>(buf + off + t * row_bytes);
}

// Issue the copies of chunk rows [t0, t0 + C) into one staging buffer: rows
// at or past T are zero-filled (their w is read as 1 where it matters).
template <typename TI, typename TW, int D, int C, int DJ>
__device__ __forceinline__ void issue_chunk(unsigned char* buf, const TI* r, const TI* k,
                                            const TI* v, const TW* w, int b, int h, int j0,
                                            int t0, int T, int H) {
  using L = Layout<TI, TW, D, C, DJ>;
  const int rows = min(C, T - t0);
  const int tid = threadIdx.x;
  constexpr int PR = D * (int)sizeof(TI) / 16, PV = DJ * (int)sizeof(TI) / 16,
                PW = D * (int)sizeof(TW) / 16;
  auto src_row = [&](int t) { return ((size_t)b * T + t0 + min(t, rows - 1)) * H + h; };
  for (int q = tid; q < C * PR; q += NTHREADS) {
    const int t = q / PR, p = q % PR;
    const size_t off = src_row(t) * D * sizeof(TI) + p * 16;
    const int n = t < rows ? 16 : 0;
    cp_async16(buf + L::RAW_R + t * L::R_ROW + p * 16,
               reinterpret_cast<const unsigned char*>(r) + off, n);
    cp_async16(buf + L::RAW_K + t * L::R_ROW + p * 16,
               reinterpret_cast<const unsigned char*>(k) + off, n);
  }
  for (int q = tid; q < C * PV; q += NTHREADS) {
    const int t = q / PV, p = q % PV;
    const size_t off = (src_row(t) * D + j0) * sizeof(TI) + p * 16;
    cp_async16(buf + L::RAW_V + t * L::V_ROW + p * 16,
               reinterpret_cast<const unsigned char*>(v) + off, t < rows ? 16 : 0);
  }
  for (int q = tid; q < C * PW; q += NTHREADS) {
    const int t = q / PW, p = q % PW;
    const size_t off = src_row(t) * D * sizeof(TW) + p * 16;
    cp_async16(buf + L::RAW_W + t * L::W_ROW + p * 16,
               reinterpret_cast<const unsigned char*>(w) + off, t < rows ? 16 : 0);
  }
  cp_async_commit();
}

template <typename TI, typename TW, typename TY, int D, int C, int NJ>
__global__ void __launch_bounds__(NTHREADS, 1)
    wkv6_chunked_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                        const TI* __restrict__ v, const TW* __restrict__ w,
                        const float* __restrict__ u, const float* state_in,
                        float* state_out, TY* __restrict__ y, int T, int H) {
  constexpr int DJ = D / NJ;
  using L = Layout<TI, TW, D, C, DJ>;
  constexpr int NSUB = L::NSUB, RS = L::RS, AS = L::AS, SS = L::SS;
  constexpr bool V_EXACT = std::is_same<TI, __nv_bfloat16>::value;
  // y tiles: NSUB row blocks x NT column tiles of 8, in NG groups of NPT
  constexpr int NT = DJ / 8;
  constexpr int NG = (NW / NSUB < NT) ? NW / NSUB : NT, NPT = NT / NG;
  // state tiles: MS row blocks of 16 x NT column tiles, in SG groups of NPS
  constexpr int MS = D / 16;
  constexpr int SG = (NW / MS < NT) ? NW / MS : NT, NPS = NT / SG;
  // diagonal blocks: NI lanes per (sub-chunk, column s), IW key indices
  // each, IW = 8 where 16 would leave threads idle
  constexpr int IW = NSUB * SUB * (D / 16) >= NTHREADS ? 16 : 8, NI = D / IW;
  // off-diagonal blocks: one warp per (pair, column half) where the warps
  // suffice, else per pair
  constexpr int NPAIR = NSUB * (NSUB - 1) / 2, NH = NW >= 2 * NPAIR ? 1 : 2;
  static_assert(C % SUB == 0 && NSUB <= NW && DJ % 16 == 0 && MS * SG <= NW, "shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sR = reinterpret_cast<float*>(smem + L::F_R);
  float* sK = reinterpret_cast<float*>(smem + L::F_K);
  float* sR2 = reinterpret_cast<float*>(smem + L::F_R2);  // row 8 a + t - 8, t >= 8
  float* sK2 = reinterpret_cast<float*>(smem + L::F_K2);  // row 8 a + s, s < 8
  float* sA = reinterpret_cast<float*>(smem + L::F_A);
  float* sS = reinterpret_cast<float*>(smem + L::F_S);
  float* sG = reinterpret_cast<float*>(smem + L::F_G);
  float* sH = reinterpret_cast<float*>(smem + L::F_H);
  float* su = reinterpret_cast<float*>(smem + L::F_U);

  const int jb = blockIdx.x, h = blockIdx.y, b = blockIdx.z, j0 = jb * DJ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int n_chunks = (T + C - 1) / C;

  // the state: this warp's tiles of S[:, j0 : j0 + DJ] in accumulator
  // layout, rows 16 ms + g (+8), columns 8 n + 2 t4 (+1); copied into sS
  // at the start of each chunk for its inter-chunk product
  const bool owns_state = warp < MS * SG;
  const int ms = warp / SG, sn0 = (warp % SG) * NPS;
  float st[NPS][4];
  const size_t sbase = ((size_t)b * H + h) * D * D + j0;
#pragma unroll
  for (int x = 0; x < NPS; ++x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * ms + g + (e >> 1) * 8, j = 8 * (sn0 + x) + 2 * t4 + (e & 1);
      st[x][e] = (owns_state && state_in) ? state_in[sbase + (size_t)i * D + j] : 0.f;
    }
  }
  for (int i = tid; i < D; i += NTHREADS) su[i] = u[h * D + i];

#if WKV_ASYNC_COPY
  issue_chunk<TI, TW, D, C, DJ>(smem, r, k, v, w, b, h, j0, 0, T, H);
#endif
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C, nt = min(C, T - t0);
    unsigned char* buf = smem + (c & 1) * L::RAW;
#if WKV_ASYNC_COPY
    cp_async_wait_all();
    __syncthreads();  // chunk c staged; the other buffer is free
    if (c + 1 < n_chunks)
      issue_chunk<TI, TW, D, C, DJ>(smem + ((c + 1) & 1) * L::RAW, r, k, v, w, b, h, j0,
                                    t0 + C, T, H);
#else
    __syncthreads();
    issue_chunk<TI, TW, D, C, DJ>(buf, r, k, v, w, b, h, j0, t0, T, H);
    cp_async_wait_all();
    __syncthreads();
#endif
    auto R = [&](int t) { return row_at<TI>(buf, L::RAW_R, L::R_ROW, t); };
    auto K = [&](int t) { return row_at<TI>(buf, L::RAW_K, L::R_ROW, t); };
    auto V = [&](int t) { return row_at<TI>(buf, L::RAW_V, L::V_ROW, t); };
    auto W = [&](int t) { return row_at<TW>(buf, L::RAW_W, L::W_ROW, t); };

    // 1. the state S0 into sS (the previous chunk's products have read
    // it); decays, one thread per (column i, sub-chunk a, direction): R =
    // r Q, R2 and the sub-chunk's total G forward, K = k P and K2 backward,
    // as running products (w read as 1 past T)
    if (owns_state) {
#pragma unroll
      for (int x = 0; x < NPS; ++x) {
        const int jj = 8 * (sn0 + x) + 2 * t4, i = 16 * ms + g;
        store2(&sS[i * SS + jj], st[x][0], st[x][1]);
        store2(&sS[(i + 8) * SS + jj], st[x][2], st[x][3]);
      }
    }
    for (int q = tid; q < 2 * D * NSUB; q += NTHREADS) {
      const int i = q % D, a = (q / D) % NSUB, t0a = SUB * a;
      float run = 1.f, run2 = 1.f;
      if (q < D * NSUB) {
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          const float x = to_f32(R(t0a + t)[i]), wt = t0a + t < nt ? to_f32(W(t0a + t)[i]) : 1.f;
          sR[(t0a + t) * RS + i] = x * run;
          run *= wt;
          if (t >= SUB / 2) {
            sR2[(t0a / 2 + t - SUB / 2) * RS + i] = x * run2;
            run2 *= wt;
          }
        }
        sG[a * D + i] = run;
      } else {
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s) {
          const float x = to_f32(K(t0a + s)[i]), ws = t0a + s < nt ? to_f32(W(t0a + s)[i]) : 1.f;
          sK[(t0a + s) * RS + i] = x * run;
          run *= ws;
          if (s < SUB / 2) {
            sK2[(t0a / 2 + s) * RS + i] = x * run2;
            run2 *= ws;
          }
        }
      }
    }
    __syncthreads();

    // 2a. per column: H[a] = D(0, 16 a)
    for (int i = tid; i < D; i += NTHREADS) {
      float hp = 1.f;
      for (int a = 0; a < NSUB; ++a) {
        sH[a * D + i] = hp;
        hp *= sG[a * D + i];
      }
    }
    // 2b. off-diagonal blocks of A on the tensor cores, for b < a:
    // A[t, s] = sum_i R[t, i] mid[i] K[s, i], mid = prod_{b < c < a} G_c
    for (int q = warp; q < NPAIR * (2 / NH); q += NW) {
      int a = 1, bb = q / (2 / NH);
      while (bb >= a) bb -= a++;
      const int m0 = SUB * a, s0 = SUB * bb + (NH == 1 ? 8 * (q & 1) : 0);
      float acc[NH][4] = {}, lo[NH][4] = {}, mid[D / 8][2];
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        mid[kk][0] = mid[kk][1] = 1.f;
        for (int cc = bb + 1; cc < a; ++cc) {
          mid[kk][0] *= sG[cc * D + 8 * kk + t4];
          mid[kk][1] *= sG[cc * D + 8 * kk + t4 + 4];
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        const float mid0 = mid[k0 / 8][0], mid1 = mid[k0 / 8][1];
        const float av[4] = {sR[(m0 + g) * RS + k0 + t4], sR[(m0 + g + 8) * RS + k0 + t4],
                             sR[(m0 + g) * RS + k0 + t4 + 4],
                             sR[(m0 + g + 8) * RS + k0 + t4 + 4]};
        const Frag<4> fa = split_frag<false>(av);
#pragma unroll
        for (int nh = 0; nh < NH; ++nh) {
          const float* kr = &sK[(s0 + 8 * nh + g) * RS + k0 + t4];
          const float bv[2] = {kr[0] * mid0, kr[4] * mid1};
          mma_split<false, false>(acc[nh], lo[nh], fa, split_frag<false>(bv));
        }
      }
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) {
        float* out = &sA[(m0 + g) * AS + s0 + 8 * nh + 2 * t4];
        store2(out, acc[nh][0] + lo[nh][0], acc[nh][1] + lo[nh][1]);
        store2(out + 8 * AS, acc[nh][2] + lo[nh][2], acc[nh][3] + lo[nh][3]);
      }
    }
    // 2q. the lower-left quadrant of each diagonal block on the tensor
    // cores: t in the sub-chunk's second half, s in its first,
    // A[t, s] = sum_i R2[t, i] K2[s, i] (D(s+1, t) split at 16 a + 8);
    // rows 8..15 of the m16 tile are zero
    for (int a = (warp + NW - NPAIR * (2 / NH) % NW) % NW; a < NSUB; a += NW) {
      float acc[4] = {}, lo[4] = {};
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        const float* rr = &sR2[(SUB / 2 * a + g) * RS + k0 + t4];
        const float* kr = &sK2[(SUB / 2 * a + g) * RS + k0 + t4];
        const float av[4] = {rr[0], 0.f, rr[4], 0.f}, bv[2] = {kr[0], kr[4]};
        mma_split<false, false>(acc, lo, split_frag<false>(av), split_frag<false>(bv));
      }
      store2(&sA[(SUB * a + SUB / 2 + g) * AS + SUB * a + 2 * t4], acc[0] + lo[0],
             acc[1] + lo[1]);
    }
    // 2s. the state update on this warp's tiles, in registers (sS keeps S0
    // for this chunk's products): S <- diag(D(0, C)) S + (K Tl)^T V,
    // Tl[b] = D(16 b + 16, C) = prod_{c > b} G_c
    if (owns_state) {
      const int i0 = 16 * ms + g, i1 = i0 + 8;
      float tl[NSUB][2], d0 = 1.f, d1 = 1.f;
#pragma unroll
      for (int a = NSUB - 1; a >= 0; --a) {
        tl[a][0] = d0;
        tl[a][1] = d1;
        d0 *= sG[a * D + i0];
        d1 *= sG[a * D + i1];
      }
      float lo[NPS][4] = {};
#pragma unroll
      for (int x = 0; x < NPS; ++x) {
        st[x][0] *= d0;
        st[x][1] *= d0;
        st[x][2] *= d1;
        st[x][3] *= d1;
      }
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        const float tl0 = tl[k0 / SUB][0], tl1 = tl[k0 / SUB][1];
        const float av[4] = {sK[(k0 + t4) * RS + i0] * tl0, sK[(k0 + t4) * RS + i1] * tl1,
                             sK[(k0 + t4 + 4) * RS + i0] * tl0,
                             sK[(k0 + t4 + 4) * RS + i1] * tl1};
        const Frag<4> fa = split_frag<false>(av);
#pragma unroll
        for (int x = 0; x < NPS; ++x) {
          const int n = 8 * (sn0 + x) + g;
          const float bv[2] = {to_f32(V(k0 + t4)[n]), to_f32(V(k0 + t4 + 4)[n])};
          mma_split<false, V_EXACT>(st[x], lo[x], fa, split_frag<V_EXACT>(bv));
        }
      }
#pragma unroll
      for (int x = 0; x < NPS; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[x][e] += lo[x][e];
    }
    // 2c. the two diagonal quadrants of each diagonal block on the CUDA
    // cores, NI lanes per (sub-chunk a, column s), IW key indices each:
    // A[t, s] for s < t in the same half of the sub-chunk, k_s carried
    // forward as k_s . D(s+1, t); the bonus u on the diagonal; zeros above
    // it and in the upper-right quadrant.  Every lane walks the 8 rows of
    // its half (predicated), so the rows' loads and dot products overlap;
    // the sums over the NI lanes come after.
    for (int q = tid; q < NSUB * SUB * NI; q += NTHREADS) {  // whole warps
      constexpr int HALF = SUB / 2;
      const int ic = q % NI, s = (q / NI) % SUB, a = q / (NI * SUB);
      const int i0 = IW * ic, ts = SUB * a + s, tb = SUB * a + s / HALF * HALF;
      float kq[IW], x[IW], part[HALF];
      load_row(kq, K(ts) + i0);
      load_row(x, R(ts) + i0);
      float bonus = 0.f;
#pragma unroll
      for (int e = 0; e < IW; ++e) bonus = __fmaf_rn(x[e], su[i0 + e] * kq[e], bonus);
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const bool on = tb + t > ts;
        load_row(x, R(tb + t) + i0);
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int e = 0; e < IW / 2; ++e) {
          p0 = __fmaf_rn(x[e], kq[e], p0);
          p1 = __fmaf_rn(x[e + IW / 2], kq[e + IW / 2], p1);
        }
        part[t] = on ? p0 + p1 : (tb + t == ts ? bonus : 0.f);
        load_row(x, W(tb + t) + i0);
#pragma unroll
        for (int e = 0; e < IW; ++e) kq[e] = on ? kq[e] * x[e] : kq[e];
      }
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
#pragma unroll
        for (int o = 1; o < NI; o <<= 1) part[t] += __shfl_xor_sync(0xffffffffu, part[t], o);
      }
      if (ic == 0) {
#pragma unroll
        for (int t = 0; t < HALF; ++t) sA[(tb + t) * AS + ts] = part[t];
        if (s >= HALF) {
#pragma unroll
          for (int t = 0; t < HALF; ++t) sA[(SUB * a + t) * AS + ts] = 0.f;
        }
      }
    }
    __syncthreads();

    // 3. y = A V + (R H) S0 for rows of sub-chunk a and NPT column tiles
    const float* S0 = sS;
    for (int q = warp; q < NSUB * NG; q += NW) {
      const int a = q / NG, n0 = (q % NG) * NPT, m0 = SUB * a;
      float acc[NPT][4] = {}, lo[NPT][4] = {};
      for (int kb = 0; kb <= a; ++kb) {
#pragma unroll
        for (int k0 = SUB * kb; k0 < SUB * kb + SUB; k0 += 8) {
          const float av[4] = {sA[(m0 + g) * AS + k0 + t4], sA[(m0 + g + 8) * AS + k0 + t4],
                               sA[(m0 + g) * AS + k0 + t4 + 4],
                               sA[(m0 + g + 8) * AS + k0 + t4 + 4]};
          const Frag<4> fa = split_frag<false>(av);
#pragma unroll
          for (int x = 0; x < NPT; ++x) {
            const int n = 8 * (n0 + x) + g;
            const float bv[2] = {to_f32(V(k0 + t4)[n]), to_f32(V(k0 + t4 + 4)[n])};
            mma_split<false, V_EXACT>(acc[x], lo[x], fa, split_frag<V_EXACT>(bv));
          }
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        const float h0 = sH[a * D + k0 + t4], h1 = sH[a * D + k0 + t4 + 4];
        const float av[4] = {sR[(m0 + g) * RS + k0 + t4] * h0,
                             sR[(m0 + g + 8) * RS + k0 + t4] * h0,
                             sR[(m0 + g) * RS + k0 + t4 + 4] * h1,
                             sR[(m0 + g + 8) * RS + k0 + t4 + 4] * h1};
        const Frag<4> fa = split_frag<false>(av);
#pragma unroll
        for (int x = 0; x < NPT; ++x) {
          const int n = 8 * (n0 + x) + g;
          const float bv[2] = {S0[(k0 + t4) * SS + n], S0[(k0 + t4 + 4) * SS + n]};
          mma_split<false, false>(acc[x], lo[x], fa, split_frag<false>(bv));
        }
      }
#pragma unroll
      for (int x = 0; x < NPT; ++x) {
        const int j = j0 + 8 * (n0 + x) + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = m0 + g + 8 * hh;
          if (t < nt)
            store2(&y[(((size_t)b * T + t0 + t) * H + h) * D + j],
                   acc[x][2 * hh] + lo[x][2 * hh], acc[x][2 * hh + 1] + lo[x][2 * hh + 1]);
        }
      }
    }
  }
  if (owns_state) {
#pragma unroll
    for (int x = 0; x < NPS; ++x) {
      const int jj = 8 * (sn0 + x) + 2 * t4, i = 16 * ms + g;
      store2(&state_out[sbase + (size_t)i * D + jj], st[x][0], st[x][1]);
      store2(&state_out[sbase + (size_t)(i + 8) * D + jj], st[x][2], st[x][3]);
    }
  }
}

template <typename TI, typename TW, typename TY, int DH>
int launch_chunked(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* state_in, float* state_out, void* y, int B,
                   int T, int H, cudaStream_t st) {
  constexpr int NJ = WKV_JBLOCKS < DH / 16 ? WKV_JBLOCKS : DH / 16;
  constexpr int BYTES = Layout<TI, TW, DH, WKV_CHUNK, DH / NJ>::BYTES;
  auto kernel = wkv6_chunked_kernel<TI, TW, TY, DH, WKV_CHUNK, NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(NJ, H, B), NTHREADS, BYTES, st>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k), static_cast<const TI*>(v),
      static_cast<const TW*>(w), u, state_in, state_out, static_cast<TY*>(y), T, H);
  return (int)cudaGetLastError();
}

template <typename TI, typename TW, typename TY>
int launch_dh(bool chunked, int dh, const void* r, const void* k, const void* v,
              const void* w, const float* u, const float* state_in, float* state_out,
              void* y, int B, int T, int H, cudaStream_t st) {
#define WKV_CASE(DH)                                                                   \
  case DH:                                                                             \
    return chunked ? launch_chunked<TI, TW, TY, DH>(r, k, v, w, u, state_in, state_out, \
                                                    y, B, T, H, st)                    \
                   : launch_typed<TI, TW, TY, DH>(r, k, v, w, u, state_in, state_out, y, \
                                                  B, T, H, st);
  switch (dh) {
    WKV_CASE(16)
    WKV_CASE(32)
    WKV_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WKV_CASE
}

int launch_any(bool chunked, int in_dtype, int w_dtype, int y_dtype, const void* r,
               const void* k, const void* v, const void* w, const float* u,
               const float* state_in, float* state_out, void* y, int B, int T, int H, int dh,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || state_out == nullptr) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && w_dtype == 0 && y_dtype == 0)
    return launch_dh<float, float, float>(chunked, dh, r, k, v, w, u, state_in, state_out, y,
                                          B, T, H, st);
  if (in_dtype == 1 && w_dtype == 1 && y_dtype == 1)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        chunked, dh, r, k, v, w, u, state_in, state_out, y, B, T, H, st);
  if (in_dtype == 1 && w_dtype == 0 && y_dtype == 0)
    return launch_dh<__nv_bfloat16, float, float>(chunked, dh, r, k, v, w, u, state_in,
                                                  state_out, y, B, T, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dtype codes 0 = float32, 1 = bfloat16, for (r/k/v, w, y): (0, 0, 0),
// (1, 1, 1) or (1, 0, 0).  u is float32 (H, dh); state_in may be null (a
// zero state) and may equal state_out.  dh in {16, 32, 64}; T >= 1.
// Launches on `stream` and returns the cudaError_t.  wkv6_launch runs the
// sequential kernel; wkv6_chunked_launch the chunked one, whose r, k, v and
// w must be 16-byte aligned.
extern "C" int wkv6_launch(int in_dtype, int w_dtype, int y_dtype, const void* r,
                           const void* k, const void* v, const void* w, const float* u,
                           const float* state_in, float* state_out, void* y, int B, int T,
                           int H, int dh, void* stream) {
  return launch_any(false, in_dtype, w_dtype, y_dtype, r, k, v, w, u, state_in, state_out, y,
                    B, T, H, dh, stream);
}

extern "C" int wkv6_chunked_launch(int in_dtype, int w_dtype, int y_dtype, const void* r,
                                   const void* k, const void* v, const void* w,
                                   const float* u, const float* state_in, float* state_out,
                                   void* y, int B, int T, int H, int dh, void* stream) {
  return launch_any(true, in_dtype, w_dtype, y_dtype, r, k, v, w, u, state_in, state_out, y,
                    B, T, H, dh, stream);
}

