// Flash attention (forward) with an online softmax, its products on the
// tensor cores in split TF32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (entry flash_attention_fwd, wrapped by repro.kernels.ops.flash_attention
// and called from repro.models.attention under use_pallas=True) for float32
// at d_head 16, 32, 64, 80, 128 and 168 and bf16 at 16, 32, 80 and 168 (bf16
// at 64 and 128 runs flash_attention_sm90.cu):
//
//     out[b, t, h] = softmax_s(scale * q[b, t, h] . k[b, s, h / group]) v[...]
//
// over the columns s that are valid: s < S, and for causal attention
// s <= t, and with a window s > t - window.  Layout is the model's:
// q and out (B, T, H, dh), k and v (B, S, KV, dh), all contiguous and
// 16-byte aligned.  repro_torch/kernels/flash_attention.py holds the plain
// version, which runs on CPU tensors: the same algorithm over the same
// K/V tiles, in float32.
//
// Arithmetic, kept from the reference: q is scaled by dh^-0.5 in float32
// before the dot; p stays float32; NEG_INF = -2e38 is finite, so a fully
// masked tile gives p = 1 for every column and the first valid tile
// multiplies that garbage by alpha = exp(-2e38 - m) = 0; the output is
// acc / max(l, 1e-30) rounded to the input type.  Two differences, each
// well inside the reference's float32 tolerance of 2e-5: the products run
// in split TF32 (tf32_mma.cuh: three mma per float32 product, two where K
// or V is bf16, ~2^-21 relative), and exp is the fast ex2-based __expf.
//
// What bounds it on an H100: operations.  4 T S dh H B flops (halved by a
// causal mask), each taken three times by the split, against
// (2 T H + 2 S KV) dh B elements moved.  Each mma.sync here comes with
// about six other instructions (the split, the fragment reads, the
// softmax), issued by two warps per SM sub-partition: the kernel is bound
// by instruction issue and latency rather than by the tensor cores
// (tools/flash_f32_ablation.py times each choice).  Design:
//   * one block of 8 warps per (head, 128-row q tile, batch), each warp 16
//     rows; the grid runs heads fastest, then q tiles from the last (the
//     longest under a causal mask) to the first, then batches, so the long
//     blocks start first and the blocks in flight share one batch's K/V
//     in L2;
//   * the q tile, scaled, sits in shared memory as float32; the K and V
//     tiles (64 columns; 32 above d_head 128, where two stages of 64 do not
//     fit beside the q tile) land by 16-byte cp.async in two stages, the
//     next tile's copy issued after the tile's one barrier and in flight
//     while this tile's products run; bf16 tiles land as bf16 and are
//     widened as their fragments are read;
//   * S = q K^T by mma.m16n8k8 over d_head in steps of 8.  Inside each step
//     the k index is permuted (k = j reads d = 2j, k = j + 4 reads d = 2j + 1),
//     so that each q and K fragment is one 8-byte shared-memory read;
//   * the online softmax runs on S's accumulator fragments in registers:
//     masks from absolute indices (skipped for a tile wholly valid for the
//     warp's rows), the row max over a quad by two shuffles, l summed per
//     thread and over the quad once at the end;
//   * P V takes p from S's accumulator layout as A fragments with no data
//     movement, by permuting the K/V index of the product the same way
//     (k = j is column 2j of the tile, k = j + 4 column 2j + 1); V's B
//     fragments read those rows;
//   * the split is paid in registers, as each fragment is read (each K and
//     V element split once per warp), in integer operations (split_frag,
//     tf32_mma.cuh);
//     S's small terms go to their own accumulators, added before the
//     softmax, P V's straight into O;
//   * with a causal mask the block skips the K/V tiles that are masked for
//     every row of its q tile (past the diagonal, or before the window),
//     and each warp the products of the tiles masked for its 16 rows: for a
//     row that has a valid column such a tile adds exactly nothing, so
//     skipping them changes no bit of the result;
//   * ragged T and S: rows past T are computed on zeros and never written;
//     columns past S land as zeros (cp.async with no source bytes) and are
//     masked.
// Row strides are padded so that every fragment read is free of bank
// conflicts.  tools/flash_f32_ablation.py times copies of this file with
// one of these choices changed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#define TF32_SPLIT 1
#include "tf32_mma.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NW = 8;  // warps per block
constexpr int THREADS = NW * 32;
constexpr int MAX_SHARED = 232448;  // per block on sm_90

// K/V-tile columns at head width dh.
__host__ __device__ constexpr int tile_cols(int dh) { return dh > 128 ? 32 : 64; }

// Row strides in elements: q and K rows are read 8 bytes a lane at (row g,
// column 2t), which is conflict-free when the stride is 8 or 24 mod 32
// words; float V rows are read 4 bytes a lane at (row 2t, column g), which
// wants a stride of 4 or 12 mod 16.  bf16 tiles use the q/K stride for
// both (16-byte rows, conflict-free for both patterns).
__host__ __device__ constexpr int qk_stride(int dh) { return dh + (dh % 16 == 0 ? 8 : 16); }
template <typename T>
__host__ __device__ constexpr int v_stride(int dh) {
  return sizeof(T) == 4 ? dh + 4 : qk_stride(dh);
}

template <typename T, int DH>
struct Tiles {
  static constexpr int BQ = NW * 16;   // q-tile rows, 16 per warp
  static constexpr int BK = tile_cols(DH);
  static constexpr int SQ = qk_stride(DH);   // floats
  static constexpr int SK = qk_stride(DH);   // elements of T
  static constexpr int SV = v_stride<T>(DH);
  static constexpr bool EXACT = sizeof(T) == 2;  // bf16 K/V are exact in TF32
  static constexpr int Q_BYTES = BQ * SQ * 4;
  static constexpr int K_BYTES = BK * SK * (int)sizeof(T);
  static constexpr int V_BYTES = BK * SV * (int)sizeof(T);
  static constexpr int BYTES = Q_BYTES + 2 * (K_BYTES + V_BYTES);  // q; two stages of K, V
  static_assert(DH % 8 == 0 && BK % 8 == 0, "mma steps of 8");
  static_assert(DH * sizeof(T) % 16 == 0, "16-byte copies");
  static_assert(BYTES <= MAX_SHARED, "tiles exceed shared memory");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// Two consecutive elements (8- or 4-byte aligned) as float32.
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Issue the copy of rows [col0, col0 + BK) of one (b, kv head) of k or v
// (src: its row 0; rows row_step elements apart) into a tile of stride
// STRIDE; rows at or past S_len land as zeros.
template <typename T, int DH, int BK, int STRIDE>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int col0, int S_len,
                                          int row_step) {
  constexpr int PER16 = 16 / (int)sizeof(T);
  constexpr int CPR = DH / PER16;  // 16-byte pieces per row
  for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, p = c % CPR, s = col0 + r;
    const bool in = s < S_len;
    cp_async16(dst + r * STRIDE + p * PER16, src + (size_t)(in ? s : 0) * row_step + p * PER16,
               in ? 16 : 0);
  }
}

// One (head, q tile, batch).  T_len, S_len: sequence lengths; H, KV: head
// counts; window 0 = none.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int T_len,
                 int S_len, int H, int KV, int causal, int window, float scale) {
  using L = Tiles<T, DH>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int SQ = L::SQ, SK = L::SK, SV = L::SV;
  constexpr int NT = BK / 8;  // n-tiles of S, k-steps of P V
  constexpr int KS = DH / 8;  // k-steps of S, n-tiles of the output
  constexpr bool EXACT = L::EXACT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  T* sk0 = reinterpret_cast<T*>(smem + L::Q_BYTES);
  T* sv0 = reinterpret_cast<T*>(smem + L::Q_BYTES + 2 * L::K_BYTES);

  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest q tiles first
  const int row0 = qt * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // K/V tiles to visit
  const int nk = (S_len + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    const int last_row = min(row0 + BQ, T_len) - 1;
    kt_hi = min(nk, last_row / BK + 1);
    if (window > 0) kt_lo = max(0, row0 - window + 1) / BK;
  }
  const int row_step = KV * DH;
  const T* kb = k + ((size_t)b * S_len * KV + kvh) * DH;
  const T* vb = v + ((size_t)b * S_len * KV + kvh) * DH;
  if (kt_lo < kt_hi) {
    copy_tile<T, DH, BK, SK>(sk0, kb, kt_lo * BK, S_len, row_step);
    copy_tile<T, DH, BK, SV>(sv0, vb, kt_lo * BK, S_len, row_step);
  }
  cp_async_commit();

  // the q tile, scaled in float32, while the first K/V tile is in flight
  for (int e = threadIdx.x; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH, row = row0 + r;
    float x = 0.f;
    if (row < T_len) x = to_f32(q[((size_t)(b * (size_t)T_len + row) * H + h) * DH + d]) * scale;
    sq[r * SQ + d] = x;
  }

  const int wrow = row0 + warp * 16;  // the warp's rows: wrow + g and + 8
  const float* q0 = sq + (warp * 16 + g) * SQ + 2 * t;
  const float* q1 = q0 + 8 * SQ;

  float o[KS][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    T* sk = sk0 + st * (BK * SK);
    T* sv = sv0 + st * (BK * SV);
    cp_async_wait_all();
    // This tile (and, the first time, the q tile) has landed for every
    // thread, and every warp is done with the previous tile, whose stage
    // takes the next tile's copy: one barrier per tile.
    __syncthreads();
    if (kt + 1 < kt_hi) {
      copy_tile<T, DH, BK, SK>(sk0 + (st ^ 1) * (BK * SK), kb, (kt + 1) * BK, S_len, row_step);
      copy_tile<T, DH, BK, SV>(sv0 + (st ^ 1) * (BK * SV), vb, (kt + 1) * BK, S_len, row_step);
      cp_async_commit();
    }

    // A tile masked for all the warp's rows (past their diagonal, or before
    // their window) adds exactly nothing: the warp skips its products.
    const int col0 = kt * BK;
    const bool skip = causal &&
                      (col0 > wrow + 15 || (window > 0 && col0 + BK - 1 <= wrow - window));
    if (!skip) {
      // S = q K^T: element (row g / g + 8, column 8j + 2t + e % 2) of s[j]
      float s[NT][4], slo[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = slo[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float2 x0 = ld_pair(q0 + 8 * kk), x1 = ld_pair(q1 + 8 * kk);
        const float qa[4] = {x0.x, x1.x, x0.y, x1.y};
        const Frag<4> fa = split_frag<false>(qa);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 y = ld_pair(sk + (8 * j + g) * SK + 8 * kk + 2 * t);
          const float kv[2] = {y.x, y.y};
          mma_split<false, EXACT>(s[j], slo[j], fa, split_frag<EXACT>(kv));
        }
      }

      // masks and the online softmax, on the fragments
      const bool whole = col0 + BK <= S_len && (!causal || col0 + BK - 1 <= wrow) &&
                         (window <= 0 || col0 > wrow + 15 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += slo[j][e];
          if (!whole) {
            const int col = col0 + 8 * j + 2 * t + (e & 1), row = wrow + g + (e < 2 ? 0 : 8);
            bool valid = col < S_len;
            if (causal) valid = valid && col <= row;
            if (window > 0) valid = valid && col > row - window;
            if (!valid) s[j][e] = NEG_INF;
          }
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      Frag<4> pf[NT];  // p as the A fragments of P V
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - m[e / 2]);
          l[e / 2] += s[j][e];
        }
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        pf[j] = split_frag<false>(pa);
      }

      // O = alpha O + P V; the small terms go straight into O, whose KS
      // independent n-tiles per k-step keep the tensor cores fed
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const int at = (8 * j + 2 * t) * SV + 8 * n + g;
          const float vv[2] = {to_f32(sv[at]), to_f32(sv[at + SV])};
          mma_split<false, EXACT>(o[n], o[n], pf[j], split_frag<EXACT>(vv));
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    const int row = wrow + g + 8 * r;
    if (row >= T_len) continue;
    T* dst = out + ((size_t)(b * (size_t)T_len + row) * H + h) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n) store_pair(dst + 8 * n, o[n][2 * r] / lr, o[n][2 * r + 1] / lr);
  }
}

template <typename T, int DH>
int launch_typed(const void* q, const void* k, const void* v, void* out, int B,
                 int T_len, int S_len, int H, int KV, int causal, int window,
                 cudaStream_t st) {
  using L = Tiles<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (T_len + L::BQ - 1) / L::BQ, B);
  flash_kernel<T, DH><<<grid, THREADS, L::BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), T_len, S_len, H, KV, causal, window,
      (float)(1.0 / sqrt((double)DH)));  // float32(dh ** -0.5), as the reference
  return (int)cudaGetLastError();
}

#define FLASH_ARGS q, k, v, out, B, T_len, S_len, H, KV, causal, window, st

}  // namespace

// dtype 0 = float32 (d_head 16, 32, 64, 80, 128, 168), 1 = bfloat16 (d_head
// 16, 32, 80, 168), q, k, v and out alike.  Launches on `stream` and
// returns the cudaError_t.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int T_len,
                                      int S_len, int H, int KV, int dh, int causal,
                                      int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch_typed<float, 16>(FLASH_ARGS);
      case 32: return launch_typed<float, 32>(FLASH_ARGS);
      case 64: return launch_typed<float, 64>(FLASH_ARGS);
      case 80: return launch_typed<float, 80>(FLASH_ARGS);
      case 128: return launch_typed<float, 128>(FLASH_ARGS);
      case 168: return launch_typed<float, 168>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 16: return launch_typed<__nv_bfloat16, 16>(FLASH_ARGS);
      case 32: return launch_typed<__nv_bfloat16, 32>(FLASH_ARGS);
      case 80: return launch_typed<__nv_bfloat16, 80>(FLASH_ARGS);
      case 168: return launch_typed<__nv_bfloat16, 168>(FLASH_ARGS);
    }
  }
  return (int)cudaErrorInvalidValue;
}
