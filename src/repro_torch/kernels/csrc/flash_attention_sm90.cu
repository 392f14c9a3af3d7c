// Flash attention (forward) in bf16 on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (entry flash_attention_fwd, wrapped by repro.kernels.ops.flash_attention
// and called from repro.models.attention under use_pallas=True) for bf16
// inputs with d_head 64 or 128; csrc/flash_attention.cu keeps float32
// inputs and bf16 at d_head 16/32.  It computes
//
//     out[b, t, h] = softmax_s(scale * q[b, t, h] . k[b, s, h / group]) v[...]
//
// over the valid columns s (s < S; causal: s <= t; window: s > t - window),
// in the model's layout: q and out (B, T, H, dh), k and v (B, S, KV, dh),
// bf16, contiguous.  repro_torch/kernels/flash_attention.py holds the plain
// version, which follows this arithmetic on the same 128-column tiles.
//
// Arithmetic.  The logits q . k are bf16 products summed in float32 by
// the tensor cores (exact products; the sum order is the hardware's), then
// multiplied by scale * log2(e) in float32 (the reference scales q by
// dh^-0.5 before the dot; the two differ by float32 rounding), so the
// softmax runs in base 2 with ex2.approx: p = 2^(x - m).  NEG_INF = -2e38
// is finite, as in the reference: a fully masked tile gives p = 1 for every
// column and the first valid tile multiplies that by alpha = 2^(-2e38 - m)
// = 0.  The running (m, l) are float32; l sums the float32 p.  p is rounded
// to bf16 for the P V product (the one arithmetic change from the
// reference's kernel, which keeps p in float32; its chunked path rounds p
// to bf16 too); O accumulates in float32, and the output is
// O / max(l, 1e-30) rounded to bf16.
//
// What bounds it on an H100: operations.  4 B H dh pairs flops (pairs: the
// (row, column) pairs that are valid, T (T + 1) / 2 with a causal mask) at
// the 989 TFLOP/s of bf16 tensor cores, against 2 (B T H + B S KV) dh bf16
// elements moved: at the prefill shape (B 4, H 16, KV 8, T = S = 2048,
// dh 128) 68.7 GFLOP in 0.0695 ms against 0.030 ms of bytes.  A block
// reads each K/V tile for 128 q rows, so the tiles cross from L2 to the SMs
// many times over (570 MB at that shape): that traffic, not the tensor
// cores, is what holds this design back.  Design:
//   * persistent blocks, one per SM, of three warpgroups: warpgroups 0 and
//     1 compute, 64 q rows each; warpgroup 2 is the producer, one thread
//     of which issues every copy (setmaxnreg moves registers from the
//     producer, 24 a thread, to the consumers, 240).  A work item is a
//     (128-row q tile, head, batch); the items are ordered longest first
//     (q tiles from the last) and dealt to the blocks round by round in
//     snake order, so every block gets a like share of the long diagonal
//     rows of causal attention, and one item's epilogue and the next
//     item's first copies overlap;
//   * the producer copies each item's q tile into one of two q buffers and
//     then its 128-column K and V tiles into a ring (two stages at dh 128,
//     four at dh 64) with TMA (cp.async.bulk.tensor, 64-column boxes,
//     128-byte swizzle, rows past S and T filled with zeros), each load
//     completing on its own mbarrier; it refills a q buffer or a stage
//     when its "empty" mbarrier has one arrival from each consumer
//     warpgroup;
//   * a consumer warpgroup computes S = Q K^T with wgmma.m64n128k16 (both
//     operands K-major in shared memory, float32 accumulator in registers),
//     scales and, on the tiles that cross the diagonal, the window's edge
//     or S, masks it; takes the row max over the four threads that share a
//     row (two shuffles), rescales its running (m, l, O) and forms p; packs
//     p to bf16 in registers, where the accumulator's layout is the A
//     operand's, and adds P V with wgmma.m64n{dh}k16 (A from registers, V
//     from shared memory in its stored MN-major layout through the
//     descriptor's transpose bit).  The two consumer warpgroups overlap one
//     another's softmax and products on the SM's tensor cores;
//   * with a causal mask an item visits only the K/V tiles that hold a
//     valid column for one of its rows: a tile past the diagonal or before
//     the window adds exactly nothing to a row that has a valid column
//     (p = 0 after the row's first valid tile, or garbage that the first
//     valid tile zeroes), so skipping it changes no bit of the result;
//   * rows past T are computed on zeros and never written; the output is
//     stored from registers as bf16 pairs;
//   * every mbarrier wait traps after ~10 s of clock, so a fault in the
//     pipeline ends the launch with an error instead of hanging the card.
// The library is built with -fmad=false (the event-sim kernel's exactness
// needs it): the softmax's multiplies and adds here are separate roundings.

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 128;        // q rows per work item: two consumer warpgroups of 64
constexpr int BK = 128;        // K/V-tile columns
constexpr int THREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int SWC = 64;        // bf16 columns in one 128-byte swizzled row
constexpr long long WAIT_LIMIT = 20000000000LL;  // clocks (~10 s) before a wait traps

// K/V ring stages: at dh 128 two are all that fit beside two q tiles
__host__ __device__ constexpr int stages(int dh) { return dh == 64 ? 4 : 2; }
__host__ __device__ constexpr int q_bytes(int dh) { return BQ * dh * 2; }
__host__ __device__ constexpr int tile_bytes(int dh) { return BK * dh * 2; }
// two q tiles, the K and V ring, the mbarriers, and 1 KB to align the base
// to the 1024 bytes of the 128-byte swizzle pattern
__host__ __device__ constexpr int shared_bytes(int dh) {
  return 1024 + 2 * q_bytes(dh) + 2 * stages(dh) * tile_bytes(dh) + 8 * (4 + 3 * stages(dh));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > WAIT_LIMIT) asm volatile("trap;");
}

// One TMA box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, float32) = A (64 x 16) B (16 x 128) [+ D]: A and B bf16 in shared
// memory, both K-major (128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16) B (16 x 64): A bf16 in registers (the
// accumulator layout of wgmma_ss), B bf16 in shared memory, MN-major
// (128-byte swizzle), read through the descriptor's transpose bit.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16) B (16 x 128): A bf16 in registers (the
// accumulator layout of wgmma_ss), B bf16 in shared memory, MN-major
// (128-byte swizzle), read through the descriptor's transpose bit.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// One work item: q rows [row0, row0 + BQ) of head h of batch b, and the
// K/V tiles [kt_lo, kt_lo + n_tiles) that hold a valid column for them.
struct Item {
  int row0, h, b, kvh, kt_lo, n_tiles;
};

// Item r of the list ordered longest first: q tiles from the last, each
// over every (b, h).
__device__ __forceinline__ Item item_at(int r, int nq, int B, int H, int KV, int T_len,
                                        int S_len, int causal, int window) {
  Item w;
  const int bh = r % (B * H);
  w.row0 = (nq - 1 - r / (B * H)) * BQ;
  w.h = bh % H;
  w.b = bh / H;
  w.kvh = w.h / (H / KV);
  const int nk = (S_len + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    const int last_row = min(w.row0 + BQ, T_len) - 1;
    kt_hi = min(nk, last_row / BK + 1);
    if (window > 0) kt_lo = max(0, w.row0 - window + 1) / BK;
  }
  w.kt_lo = kt_lo;
  w.n_tiles = kt_hi - kt_lo;
  return w;
}

// A persistent block (one per SM) takes the items of the longest-first
// list round by round, gridDim.x to a round, in snake order (forward in
// even rounds, backward in odd ones), so every block gets a like share of
// long and short items.  Producer and consumers walk the same sequence.
__device__ __forceinline__ int item_index(int k) {
  return k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                      int B, int T_len, int S_len, int H, int KV, int causal, int window,
                      float scale_log2) {
  constexpr int STAGES = stages(DH);
  constexpr int NCB = DH / SWC;             // 64-column boxes in a row of dh
  constexpr int Q_WG = 64 * DH * 2;         // bytes of one warpgroup's q rows
  constexpr int Q_TILE = q_bytes(DH);
  constexpr int TILE = tile_bytes(DH);
  constexpr int BOX_Q = 64 * 128;           // bytes of a 64-row box
  constexpr int BOX_KV = BK * 128;          // bytes of a BK-row box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + 2 * Q_TILE;
  uint8_t* sv = sk + STAGES * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * TILE);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  const int nq = (T_len + BQ - 1) / BQ;
  const int n_items = B * H * nq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 2);  // one arrival per consumer warpgroup
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy, a q tile per item into the
    // item's half of the q buffer, then its K/V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int kv = 0;  // K/V tiles issued so far, over every item
      for (int it = 0;; ++it) {
        const int r = item_index(it);
        if (r >= n_items) break;
        const Item w = item_at(r, nq, B, H, KV, T_len, S_len, causal, window);
        const int qs = it & 1;
        if (it >= 2) mbar_wait(&q_empty[qs], ((it >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[qs], Q_TILE);
        for (int g = 0; g < 2; ++g)
          for (int c = 0; c < NCB; ++c)
            tma_load(sq + qs * Q_TILE + g * Q_WG + c * BOX_Q, &tm_q, &q_full[qs], c * SWC, w.h,
                     w.row0 + 64 * g, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++kv) {
          const int st = kv % STAGES;
          const int col0 = (w.kt_lo + i) * BK;
          if (kv >= STAGES) mbar_wait(&kv_empty[st], (kv / STAGES - 1) & 1);
          mbar_expect_tx(&k_full[st], TILE);
          for (int c = 0; c < NCB; ++c)
            tma_load(sk + st * TILE + c * BOX_KV, &tm_k, &k_full[st], c * SWC, w.kvh, col0, w.b);
          mbar_expect_tx(&v_full[st], TILE);
          for (int c = 0; c < NCB; ++c)
            tma_load(sv + st * TILE + c * BOX_KV, &tm_v, &v_full[st], c * SWC, w.kvh, col0, w.b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: q rows [row0 + 64 wg, row0 + 64 wg + 64) of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);  // this thread's first column in each 8
    float o[DH / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    int kv = 0;  // K/V tiles consumed so far, over every item
    for (int it = 0;; ++it) {
      const int r = item_index(it);
      if (r >= n_items) break;
      const Item w = item_at(r, nq, B, H, KV, T_len, S_len, causal, window);
      const int qs = it & 1;
      const int rw0 = w.row0 + 64 * wg;
      const int r_lo = rw0 + 16 * warp + lane / 4;  // this thread's rows: r_lo, r_lo + 8
      const int r_hi = r_lo + 8;
      const uint8_t* sq_wg = sq + qs * Q_TILE + wg * Q_WG;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

      mbar_wait(&q_full[qs], (it >> 1) & 1);
      for (int i = 0; i < w.n_tiles; ++i, ++kv) {
        const int st = kv % STAGES;
        const uint32_t parity = (kv / STAGES) & 1;
        const int col0 = (w.kt_lo + i) * BK;

        // S = Q K^T
        mbar_wait(&k_full[st], parity);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss_n128(s, sw128_desc(sq_wg + (kk / 4) * BOX_Q + (kk % 4) * 32, 16, 1024),
                        sw128_desc(sk + st * TILE + (kk / 4) * BOX_KV + (kk % 4) * 32, 16, 1024),
                        kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        if (i == w.n_tiles - 1 && t == 0) mbar_arrive(&q_empty[qs]);  // q no longer read

        // logits in base 2; the mask where the tile crosses the diagonal,
        // the window's edge or S
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] *= scale_log2;
        const bool masked = col0 + BK > S_len || (causal && col0 + BK - 1 > rw0) ||
                            (window > 0 && col0 <= rw0 + 63 - window);
        if (masked) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int col = col0 + 8 * (e / 4) + cq + (e & 1);
            const int row = (e & 2) ? r_hi : r_lo;
            bool valid = col < S_len;
            if (causal) valid = valid && col <= row;
            if (window > 0) valid = valid && col > row - window;
            if (!valid) s[e] = NEG_INF;
          }
        }

        // online softmax over the four threads of each row
        float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j] = ex2(s[4 * j] - mn_lo);
          s[4 * j + 1] = ex2(s[4 * j + 1] - mn_lo);
          s[4 * j + 2] = ex2(s[4 * j + 2] - mn_hi);
          s[4 * j + 3] = ex2(s[4 * j + 3] - mn_hi);
          sum_lo += s[4 * j] + s[4 * j + 1];
          sum_hi += s[4 * j + 2] + s[4 * j + 3];
        }
        l_lo = l_lo * a_lo + sum_lo;  // this thread's share; summed over the row at the end
        l_hi = l_hi * a_hi + sum_hi;

        // P in bf16: the accumulator's (row, column) layout is the A operand's
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= a_lo;
          o[4 * j + 1] *= a_lo;
          o[4 * j + 2] *= a_hi;
          o[4 * j + 3] *= a_hi;
        }

        // O += P V
        mbar_wait(&v_full[st], parity);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<DH>(o, pa[kk], sw128_desc(sv + st * TILE + kk * 16 * 128, BOX_KV, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        if (t == 0) mbar_arrive(&kv_empty[st]);
      }

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
      __nv_bfloat16* o_lo = out + ((size_t)((size_t)w.b * T_len + r_lo) * H + w.h) * DH + cq;
      __nv_bfloat16* o_hi = out + ((size_t)((size_t)w.b * T_len + r_hi) * H + w.h) * DH + cq;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        if (r_lo < T_len)
          *reinterpret_cast<uint32_t*>(o_lo + 8 * j) =
              pack_bf16(o[4 * j] / d_lo, o[4 * j + 1] / d_lo);
        if (r_hi < T_len)
          *reinterpret_cast<uint32_t*>(o_hi + 8 * j) =
              pack_bf16(o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (batch, seq, heads, dh) bf16 array read in boxes of
// 64 columns x `rows` positions of one head, 128-byte swizzled; positions
// past `seq` read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int seq,
              int heads, int dh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)seq * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SWC, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B, int T_len, int S_len,
              int H, int KV, int causal, int window, cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, T_len, H, DH, 64) ||
      !make_map(encode, &tk, k, B, S_len, KV, DH, BK) ||
      !make_map(encode, &tv, v, B, S_len, KV, DH, BK))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = shared_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long items = (long long)B * H * ((T_len + BQ - 1) / BQ);
  const int grid = (int)(items < sms ? items : sms);  // persistent: at most one block per SM
  const double scale = 1.0 / sqrt((double)DH);  // float32(dh ** -0.5), as the reference
  flash_sm90_kernel<DH><<<grid, THREADS, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, T_len, S_len, H, KV, causal, window,
      (float)scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, dh), k and v (B, S, KV, dh), out (B, T, H, dh): bf16,
// contiguous, 16-byte aligned; dh 64 or 128.  Launches on `stream` and
// returns the cudaError_t.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* out, int B, int T_len, int S_len, int H, int KV,
                                           int dh, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_dh<64>(q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
  if (dh == 128) return launch_dh<128>(q, k, v, out, B, T_len, S_len, H, KV, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
