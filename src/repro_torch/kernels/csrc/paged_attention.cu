// Paged decode attention: one query token per sequence over a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel
// (entry paged_attention, wrapped by repro.kernels.ops.paged_attention):
//
//     out[b, h] = softmax_s(scale * q[b, h] . K_b[s, kv]) V_b[s, kv]
//
// with kv = h / group, K_b / V_b the pages block_table[b, :] of the pool
// laid end to end, and positions s >= seq_lens[b] masked.  Layout: q and
// out (B, H, dh); pages_k / pages_v (P, page, KV, dh), the serving
// engine's pool of one layer; block_table (B, n_pages) int32; seq_lens
// (B,) int32; all contiguous.  repro_torch/kernels/paged_attention.py
// holds the plain version (ref.paged_attention_ref: gather, then a masked
// softmax), which runs on CPU tensors.
//
// Arithmetic, kept from the reference: q is scaled by dh^-0.5 in float32
// before the dot; products and sums are float32; masked positions take the
// finite NEG_INF = -2e38 and are walked page by page with an online
// softmax, so seq_len == 0 (every position masked) gives p = 1 everywhere:
// the uniform mean of V over the table's pages, not NaN.
//
// What bounds it on an H100: bytes.  Each page of K and V is read once
// (2 page KV dh elements per page) for 4 group dh flops per position.
// Design:
//   * one block per (kv head, b), dh threads: thread d owns column d of
//     every query head of the group (its acc in registers);
//   * the block copies its block-table row to shared memory and walks the
//     pages in order, a step of up to 64 tokens (64 / page whole pages) at
//     a time.  The K and V rows of a step (this kv head's dh columns of
//     each token) are copied into shared memory with 16-byte cp.async
//     copies, double-buffered: the copies of step s + 1 are in flight
//     while step s is computed, so the device memory stays busy;
//   * each of the group x tokens logits of a step is one thread's dot
//     product, read from the staged K rows 16 bytes at a time (the rows are
//     padded by 16 bytes, so a quarter warp reads eight rows without a bank
//     conflict); then one warp per query head takes the step's max,
//     rescales its running (m, l) and turns the logits into p in place;
//     then every thread adds p V to its columns;
//   * with seq_len > 0 the pages past seq_len are not read: every
//     position there is masked, so p = exp(-2e38 - m) = 0 and the page
//     adds exactly nothing.  With seq_len == 0 every page is read, as the
//     uniform mean needs.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int MAX_GROUP = 8;
constexpr int STEP = 64;  // tokens per step, at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// Row stride of a staged K/V row (elements): dh plus 16 bytes.
__host__ __device__ constexpr int row_stride(int elem, int dh) { return dh + 16 / elem; }

// Dynamic shared memory of one block (bytes): two K and two V step buffers
// in the input type, then float32 scaled q, logits / p, and the per-head
// (m, l, alpha), then the block-table row.
__host__ __device__ constexpr int kv_bytes(int elem, int dh) {
  return 4 * STEP * row_stride(elem, dh) * elem;
}
__host__ __device__ constexpr int shared_bytes(int elem, int dh, int group, int n_pages) {
  return kv_bytes(elem, dh) + 4 * (group * dh + group * STEP + 3 * group) + 4 * n_pages;
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ pages_k,
                 const T* __restrict__ pages_v, const int* __restrict__ block_table,
                 const int* __restrict__ seq_lens, T* __restrict__ out, int H, int KV,
                 int page, int n_pages, float scale) {
  constexpr int NWARPS = DH / 32;
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int RS = row_stride((int)sizeof(T), DH);
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = H / KV;
  T* kbuf = reinterpret_cast<T*>(smem);              // 2 x STEP x RS
  T* vbuf = kbuf + 2 * STEP * RS;                    // 2 x STEP x RS
  float* sq = reinterpret_cast<float*>(vbuf + 2 * STEP * RS);  // group x DH
  float* ss = sq + group * DH;                       // group x STEP
  float* sm = ss + group * STEP;                     // group: running max
  float* sl = sm + group;                            // group: running sum
  float* sa = sl + group;                            // group: this step's alpha
  int* sbt = reinterpret_cast<int*>(sa + group);     // n_pages

  const int kv = blockIdx.x, b = blockIdx.y;
  const int d = threadIdx.x, warp = d / 32, lane = d % 32;
  for (int g = 0; g < group; ++g)
    sq[g * DH + d] = to_f32(q[((size_t)b * H + kv * group + g) * DH + d]) * scale;
  for (int i = d; i < n_pages; i += DH) sbt[i] = block_table[(size_t)b * n_pages + i];
  if (d < group) {
    sm[d] = NEG_INF;
    sl[d] = 0.f;
  }
  const int len = seq_lens[b];
  const int n_visit = len <= 0 ? n_pages : min(n_pages, (len + page - 1) / page);
  const int pps = max(1, STEP / page);  // pages per step
  const int n_steps = (n_visit + pps - 1) / pps;
  __syncthreads();

  // issue the copies of step s into buffer s & 1
  auto issue = [&](int s) {
    const int p0 = s * pps;
    const int nt = min(pps, n_visit - p0) * page;
    T* kb = kbuf + (s & 1) * STEP * RS;
    T* vb = vbuf + (s & 1) * STEP * RS;
    for (int vi = d; vi < nt * (DH / VEC); vi += DH) {
      const int tt = vi / (DH / VEC), col = (vi % (DH / VEC)) * VEC;
      const size_t off =
          (((size_t)sbt[p0 + tt / page] * page + tt % page) * KV + kv) * DH + col;
      __pipeline_memcpy_async(kb + tt * RS + col, pages_k + off, 16);
      __pipeline_memcpy_async(vb + tt * RS + col, pages_v + off, 16);
    }
    __pipeline_commit();
  };

  float acc[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.f;

  if (n_steps > 0) issue(0);
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      issue(s + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // every thread's copies of step s have landed
    const int pos0 = s * pps * page;
    const int nt = min(pps, n_visit - s * pps) * page;
    const T* kb = kbuf + (s & 1) * STEP * RS;
    const T* vb = vbuf + (s & 1) * STEP * RS;

    for (int e = d; e < group * nt; e += DH) {
      const int g = e / nt, t = e % nt;
      const float* qg = sq + g * DH;
      const T* kt = kb + t * RS;
      float x = 0.f;
#pragma unroll
      for (int dd = 0; dd < DH; dd += VEC) {
        alignas(16) T kv8[VEC];
        *reinterpret_cast<uint4*>(kv8) = *reinterpret_cast<const uint4*>(kt + dd);
#pragma unroll
        for (int u = 0; u < VEC; ++u) x = __fmaf_rn(qg[dd + u], to_f32(kv8[u]), x);
      }
      ss[g * STEP + t] = pos0 + t < len ? x : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < group; g += NWARPS) {
      float* sg = ss + g * STEP;
      float mx = NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sg[t]);
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[g] = alpha;
        sl[g] = sl[g] * alpha + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
      if (g >= group) break;
      const float* pg = ss + g * STEP;
      float pv = 0.f;
      for (int t = 0; t < nt; ++t) pv = __fmaf_rn(pg[t], to_f32(vb[t * RS + d]), pv);
      acc[g] = acc[g] * sa[g] + pv;
    }
    __syncthreads();  // buffer s & 1 and the logits are free again
  }

#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    if (g >= group) break;
    store_out(&out[((size_t)b * H + kv * group + g) * DH + d], acc[g] / fmaxf(sl[g], 1e-30f));
  }
}

template <typename T, int DH>
int launch_typed(const void* q, const void* pk, const void* pv, const int* bt,
                 const int* sl, void* out, int B, int H, int KV, int page, int n_pages,
                 cudaStream_t st) {
  const int bytes = shared_bytes((int)sizeof(T), DH, H / KV, n_pages);
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  paged_kernel<T, DH><<<dim3(KV, B), DH, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv), bt, sl,
      static_cast<T*>(out), H, KV, page, n_pages,
      (float)(1.0 / sqrt((double)DH)));  // float32(dh ** -0.5), as the reference
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* pk, const void* pv, const int* bt,
              const int* sl, void* out, int B, int H, int KV, int page, int n_pages,
              cudaStream_t st) {
  switch (dh) {
    case 32: return launch_typed<T, 32>(q, pk, pv, bt, sl, out, B, H, KV, page, n_pages, st);
    case 64: return launch_typed<T, 64>(q, pk, pv, bt, sl, out, B, H, KV, page, n_pages, st);
    case 128: return launch_typed<T, 128>(q, pk, pv, bt, sl, out, B, H, KV, page, n_pages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory one block needs: the wrapper checks it against the
// card's limit before launching.
extern "C" int paged_attention_shared_bytes(int elem_bytes, int dh, int group, int n_pages) {
  return shared_bytes(elem_bytes, dh, group, n_pages);
}

// dtype 0 = float32, 1 = bfloat16 (q, pages and out alike); H / KV <= 8;
// page <= 64; the pages 16-byte aligned.  Launches on `stream` and
// returns the cudaError_t.
extern "C" int paged_attention_launch(int dtype, const void* q, const void* pages_k,
                                      const void* pages_v, const int* block_table,
                                      const int* seq_lens, void* out, int B, int H, int KV,
                                      int dh, int page, int n_pages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KV != 0 || H / KV > MAX_GROUP || page > STEP) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dh<float>(dh, q, pages_k, pages_v, block_table, seq_lens, out, B, H, KV,
                            page, n_pages, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, pages_k, pages_v, block_table, seq_lens, out, B,
                                    H, KV, page, n_pages, st);
  return (int)cudaErrorInvalidValue;
}
