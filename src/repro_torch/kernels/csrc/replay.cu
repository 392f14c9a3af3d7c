// Replay kernel: one (capacity, seed) lane's full trace replay per warp.
//
// Replaces the TPU kernel src/repro/kernels/replay.py::_replay_kernel
// (launched by _pallas_grid, entry replay_grid_pallas).  Each block is one
// warp and replays the whole request stream of one lane through one policy
// of the flat engine (repro_torch/cache/flat.py holds the plain version),
// fusing the delayed-hit classifier through a per-key fetch-expiry table.
// Per request it writes: hit, evicted key, packed op vector
// (delink | head<<1 | tail<<9 | scan<<12) and class.
//
// What bounds it on an H100: neither bytes nor operations, but the serial
// dependence between consecutive requests of a lane: request t+1 reads the
// cache state request t wrote.  Its measure is the chain's latency, about
// one dependent shared-memory load (~30 cycles) per list step.
//
// Design.
//   * One lane leader (thread 0) runs the policy steps; the chain's state
//     is in its registers (sizes, list heads and tails, hand) and in the
//     lane's arrays.  The other threads work off the chain: per 32
//     requests they load the next 32 keys, coins and windows in one
//     coalesced access (into registers, a batch ahead) and store each
//     output field once.  __syncwarp() is the only barrier.
//   * The flat engine's masked argmins become lists.  Every write of `ts`
//     there stamps `now` and then increments it, so the occupied slots of
//     one mask have distinct stamps, and the masked argmin is the tail of
//     a list ordered by stamp: a doubly linked list (prv = older, nxt =
//     newer) per mask, kept in O(1) per step.  `ts` and `now` are not
//     kept: only the order they encode reaches an output.
//       LRU / FIFO / Prob-LRU: one recency list.  CLOCK: one queue with
//       reinsertion.  SLRU: B (aux 0) and T (aux 1).  S3-FIFO: S (aux 0),
//       M (aux 1), ghost membership as a per-key count of ring entries,
//       the first free slot from a two-level free bitmap.  SIEVE: one
//       insertion-ordered list walked by the hand.
//   * The argmin form's edges are kept: an argmin over an empty mask
//     returns slot 0, whatever that slot holds (flat.py's _min_slot), and
//     a first-free search with no free slot returns slot 0 too.  The
//     sizes are the flat engine's registers, updated as it updates them,
//     so that every branch is taken as there; each write to a slot's
//     key, membership bit or stamp moves the slot between lists exactly
//     as the masks move.  These edges occur only on lanes of capacity
//     <= 0 and on S3-FIFO lanes with no main queue (small_frac >= 1).
//   * State layout (LAYOUT): the per-key tables (expiry, key2slot, ghost
//     counts) and the slot arrays in shared memory, links and key2slot
//     int16 (ALL_SHARED), or, when they do not fit in one block's shared
//     memory, all in device memory with int32 links (ALL_GLOBAL).  The
//     device-memory scratch is the wrapper's, per lane.
//
// Exactness: int32 arithmetic as the reference (outputs, windows, the
// packed op vector, whose fields spill into each other exactly as
// flat.pack_ops lets them); prob_lru compares u >= q in float32 with q
// rounded on the host.  The dropped stamps assume fewer than 2^30
// stamps per lane (the reference's own SIEVE bias assumes it too).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int NIL = -1;
constexpr int FAR_PAST = -(1 << 30);
constexpr int P_CAP = 0, P_MAX_SCAN = 1, P_PROT_CAP = 2, P_S_CAP = 3,
              P_M_CAP = 4, P_GHOST_CAP = 5, N_PARAMS = 6;
// policy ids: the order of repro_torch.cache.flat.POLICY_IDS
constexpr int LRU = 0, FIFO = 1, PROB_LRU = 2, CLOCK = 3, SLRU = 4,
              S3FIFO = 5, SIEVE = 6;
// where the lane's state lives (repro_torch.kernels.replay.LAYOUTS)
constexpr int ALL_SHARED = 0, ALL_GLOBAL = 1;

constexpr int WARP = 32;
// staging of one batch of 32 requests: key, u, window in; four outputs
constexpr int STAGE_INTS = 7 * WARP;
constexpr long long STAGE_BYTES = 4 * STAGE_INTS;

__host__ __device__ constexpr bool uses_bit(int pol) {
  return pol == CLOCK || pol == S3FIFO || pol == SIEVE;
}
__host__ __device__ constexpr bool uses_aux(int pol) {
  return pol == SLRU || pol == S3FIFO;
}
__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) & ~15LL;
}
__host__ __device__ constexpr long long map_words(long long pad) {
  return (pad + 31) / 32;
}

// Bytes of the per-key region: expiry (int32), key2slot (link), and the
// ghost counts (link, S3-FIFO).
__host__ __device__ constexpr long long key_region(int pol, long long ks,
                                                   int link) {
  return align16(4 * ks) + align16(link * ks) +
         (pol == S3FIFO ? align16(link * ks) : 0);
}

// Bytes of the per-slot region: slot2key (int32); S3-FIFO's ghost ring
// (int32) and free bitmaps (one bit per slot, one per bitmap word); the
// links (prv, nxt); the reference bit and the membership bit (bytes).
__host__ __device__ constexpr long long slot_region(int pol, long long pad,
                                                    int link) {
  return align16(4 * pad) + 2 * align16(link * pad) +
         (pol == S3FIFO ? align16(4 * pad) + align16(4 * map_words(pad)) +
                              align16(4 * map_words(map_words(pad)))
                        : 0) +
         (uses_bit(pol) ? align16(pad) : 0) + (uses_aux(pol) ? align16(pad) : 0);
}

__host__ __device__ constexpr int link_bytes(int layout) {
  return layout == ALL_GLOBAL ? 4 : 2;
}

// (shared bytes per block, device-memory scratch bytes per lane)
__host__ __device__ constexpr long long region_bytes(int pol, long long ks,
                                                     long long pad, int layout,
                                                     bool scratch) {
  const int lb = link_bytes(layout);
  const long long state = key_region(pol, ks, lb) + slot_region(pol, pad, lb);
  if (scratch) return layout == ALL_SHARED ? 0 : state;
  return STAGE_BYTES + (layout == ALL_SHARED ? state : 0);
}

// Wait here for the values of loads issued above: they are then issued
// together, and the compiler cannot sink one into the branch that uses it
// (where its latency would add to the chain's).
__device__ __forceinline__ void issued_one(int v) { asm volatile("" ::"r"(v)); }
template <class... T>
__device__ __forceinline__ void issued(T... v) {
  (issued_one(v), ...);
}

// ---- shared-memory access by 32-bit addresses in the shared window.
// A C++ pointer into shared memory is a generic address, which the
// compiler rebuilds from the block's window base (an S2UR of
// SR_CgaCtaId) wherever it does not keep it in a register, and then on
// the chain; an Arr keeps the 32-bit address and loads and stores with
// ld.shared / st.shared, in program order.
template <class T>
using Val = std::conditional_t<std::is_same_v<T, uint32_t>, uint32_t, int>;

__device__ __forceinline__ int lds32(uint32_t a) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ int lds16(uint32_t a) {
  int v;
  asm volatile("ld.shared.s16 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ int lds8(uint32_t a) {
  int v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts16(uint32_t a, int v) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts8(uint32_t a, int v) {
  asm volatile("st.shared.b8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
// ---- end of shared-memory access

template <class T>
struct SharedRef {
  uint32_t a;
  __device__ __forceinline__ operator Val<T>() const {
    if constexpr (sizeof(T) == 4) return (Val<T>)lds32(a);
    else if constexpr (sizeof(T) == 2) return lds16(a);
    else return lds8(a);
  }
  __device__ __forceinline__ SharedRef& operator=(Val<T> v) {
    if constexpr (sizeof(T) == 4) sts32(a, (int)v);
    else if constexpr (sizeof(T) == 2) sts16(a, v);
    else sts8(a, v);
    return *this;
  }
  __device__ __forceinline__ SharedRef& operator+=(Val<T> v) {
    return *this = (Val<T>)(*this) + v;
  }
  __device__ __forceinline__ SharedRef& operator-=(Val<T> v) {
    return *this = (Val<T>)(*this) - v;
  }
  __device__ __forceinline__ SharedRef& operator|=(Val<T> v) {
    return *this = (Val<T>)(*this) | v;
  }
  __device__ __forceinline__ SharedRef& operator&=(Val<T> v) {
    return *this = (Val<T>)(*this) & v;
  }
};

// An array of the lane's state: in shared memory (SHARED) or device memory.
template <class T, bool SHARED>
struct Arr {
  T* p;
  __device__ __forceinline__ T& operator[](int i) const { return p[i]; }
};
template <class T>
struct Arr<T, true> {
  uint32_t a;
  __device__ __forceinline__ SharedRef<T> operator[](int i) const {
    return SharedRef<T>{a + (uint32_t)i * (uint32_t)sizeof(T)};
  }
};

// Where the next array of a region starts: a 32-bit shared address or a
// device-memory pointer.
template <class T>
__device__ __forceinline__ Arr<T, true> carve(uint32_t& a, long long n) {
  const Arr<T, true> out{a};
  a += (uint32_t)align16(n * (long long)sizeof(T));
  return out;
}
template <class T>
__device__ __forceinline__ Arr<T, false> carve(unsigned char*& p, long long n) {
  const Arr<T, false> out{reinterpret_cast<T*>(p)};
  p += align16(n * (long long)sizeof(T));
  return out;
}

struct List {
  int head, tail, n;  // newest slot, oldest slot, length
};

struct Out {
  int hit, evicted, delink, head, tail, scan;
};

template <int POL, class Link, bool SH>
struct Lane {
  // per key (in shared memory when SH)
  Arr<int, SH> exp;    // fetch expiry (fused classifier)
  Arr<Link, SH> k2s;   // slot of each key, NIL when absent
  Arr<Link, SH> gcnt;  // S3-FIFO: entries of the key in the ghost ring
  // per slot
  Arr<int, SH> s2k;         // key in each slot, NIL when free
  Arr<int, SH> ghost;       // S3-FIFO ghost ring
  Arr<uint32_t, SH> free0;  // S3-FIFO: bit s%32 of word s/32 set: s is free
  Arr<uint32_t, SH> free1;  // S3-FIFO: bit w%32 of word w/32 set: free0[w] != 0
  Arr<Link, SH> prv;  // the next older slot of the slot's list, NIL at the tail
  Arr<Link, SH> nxt;  // the next newer slot, NIL at the head
  Arr<uint8_t, SH> bit;  // reference bit
  Arr<uint8_t, SH> aux;  // SLRU in_T / S3-FIFO in_M
  // parameters
  int cap, max_scan, prot_cap, s_cap, m_cap, ghost_cap;
  float q;
  // registers (the flat engine's, but for now)
  int size, size_t_, size_s, size_m, gpos, hand, free_lo, holes;
  List a;  // the policy's list; SLRU's B, S3-FIFO's S
  List b;  // SLRU's T, S3-FIFO's M

  template <class C>
  __device__ void carve_keys(C c, int ks) {
    exp = carve<int>(c, ks);
    k2s = carve<Link>(c, ks);
    if (POL == S3FIFO) gcnt = carve<Link>(c, ks);
  }

  template <class C>
  __device__ void carve_slots(C c, int pad) {
    s2k = carve<int>(c, pad);
    if (POL == S3FIFO) {
      ghost = carve<int>(c, pad);
      free0 = carve<uint32_t>(c, map_words(pad));
      free1 = carve<uint32_t>(c, map_words(map_words(pad)));
    }
    prv = carve<Link>(c, pad);
    nxt = carve<Link>(c, pad);
    if (uses_bit(POL)) bit = carve<uint8_t>(c, pad);
    if (uses_aux(POL)) aux = carve<uint8_t>(c, pad);
  }

  // All threads of the warp: the reference's initial state.
  __device__ void init(int ks, int pad, int lane) {
    for (int i = lane; i < ks; i += WARP) {
      exp[i] = FAR_PAST;
      k2s[i] = (Link)NIL;
      if (POL == S3FIFO) gcnt[i] = 0;
    }
    for (int i = lane; i < pad; i += WARP) {
      s2k[i] = NIL;
      if (POL == S3FIFO) ghost[i] = NIL;
      if (uses_bit(POL)) bit[i] = 0;
      if (uses_aux(POL)) aux[i] = 0;
    }
    if (POL == S3FIFO) {
      const int w0 = (int)map_words(pad), w1 = (int)map_words(w0);
      for (int w = lane; w < w0; w += WARP) {
        const int left = pad - 32 * w;
        free0[w] = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
      }
      for (int w = lane; w < w1; w += WARP) {
        const int left = w0 - 32 * w;
        free1[w] = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
      }
    }
    size = size_t_ = size_s = size_m = gpos = free_lo = 0;
    holes = max(cap, 0);  // cap <= pad
    hand = NIL;
    a = List{NIL, NIL, 0};
    b = List{NIL, NIL, 0};
  }

  // ---- list primitives (leader only)
  __device__ __forceinline__ void push_head(List& L, int s) {
    prv[s] = (Link)L.head;
    nxt[s] = (Link)NIL;
    if (L.head != NIL) nxt[L.head] = (Link)s;
    else L.tail = s;
    L.head = s;
    L.n += 1;
  }

  // unlink s, whose links p (older) and n (newer) the caller loaded
  __device__ __forceinline__ void unlink_at(List& L, int p, int n) {
    if (p != NIL) nxt[p] = (Link)n;
    else L.tail = n;
    if (n != NIL) prv[n] = (Link)p;
    else L.head = p;
    L.n -= 1;
  }

  __device__ __forceinline__ void unlink(List& L, int s) {
    unlink_at(L, prv[s], nxt[s]);
  }

  // unlink the tail, whose successor n the caller loaded
  __device__ __forceinline__ void pop_tail(List& L, int n) {
    L.tail = n;
    if (n != NIL) prv[n] = (Link)NIL;
    else L.head = NIL;
    L.n -= 1;
  }

  // the slot's stamp becomes the newest: it moves to its list's head
  __device__ __forceinline__ void to_head(List& L, int s) {
    if (s != L.head) {
      unlink(L, s);
      push_head(L, s);
    }
  }

  // the masked argmin: the list's tail, slot 0 when the mask is empty
  __device__ __forceinline__ static int tail_or_0(const List& L) {
    return L.n > 0 ? L.tail : 0;
  }

  // SLRU / S3-FIFO: the list an occupied slot is on follows its aux bit
  __device__ __forceinline__ void unlink_occupied(int s) {
    if (aux[s]) unlink(b, s);
    else unlink(a, s);
  }
  __device__ __forceinline__ void to_head_occupied(int s) {
    if (aux[s]) to_head(b, s);
    else to_head(a, s);
  }

  // ---- S3-FIFO free bitmap: first free slot (slot 0 when none).  `holes`
  // counts the free slots below the capacity that the bitmap holds.
  __device__ __forceinline__ void mark_free(int s) {
    const int w = s >> 5;
    free0[w] |= 1u << (s & 31);
    free1[w >> 5] |= 1u << (w & 31);
    free_lo = min(free_lo, w >> 5);
    holes += s < cap ? 1 : 0;
  }
  __device__ __forceinline__ void mark_used(int s) {
    const int w = s >> 5;
    const uint32_t v = free0[w] & ~(1u << (s & 31));
    free0[w] = v;
    if (v == 0) free1[w >> 5] &= ~(1u << (w & 31));
    holes -= s < cap ? 1 : 0;
  }
  // free1[j] is 0 for every j < free_lo
  __device__ __forceinline__ int first_free(int n1) {
    int j = free_lo;
    uint32_t v = 0;
    for (; j < n1; ++j) {
      v = free1[j];
      if (v != 0) break;
    }
    free_lo = j;
    if (j == n1) return 0;
    const int w = 32 * j + __ffs(v) - 1;
    return 32 * w + __ffs(free0[w]) - 1;
  }

  // Each step loads the slots a miss would touch next (a list's tail, the
  // hand) beside the key's lookup, before it knows whether it hits: the
  // lookup and those loads then wait once, not one after the other.

  // ---- LRU / FIFO / Prob-LRU
  __device__ __forceinline__ Out list_step(int key, float u) {
    const int tl = tail_or_0(a);
    const int t_key = s2k[tl], t_nxt = nxt[tl];
    const int slot = k2s[key];
    issued(slot, t_key, t_nxt);
    if (slot != NIL) {
      const bool re = POL == LRU ? true : POL == FIFO ? false : (u >= q);
      if (re) to_head(a, slot);
      return Out{1, NIL, re, re, 0, 0};
    }
    const bool evict = size >= cap;
    int s = size, old = NIL;
    if (evict) {
      s = tl;
      old = t_key;
      // the reference clears key max(old, 0): key 0 when the slot is empty
      k2s[max(old, 0)] = (Link)NIL;
      if (old != NIL) pop_tail(a, t_nxt);
    }
    k2s[key] = (Link)s;
    s2k[s] = key;
    push_head(a, s);
    size = min(size + 1, cap);
    return Out{0, old, 0, 1, evict, 0};
  }

  // ---- CLOCK
  __device__ __forceinline__ Out clock_step(int key) {
    int s = tail_or_0(a);
    int s_bit = bit[s], s_key = s2k[s], s_nxt = nxt[s];
    const int slot = k2s[key];
    issued(slot, s_bit, s_key, s_nxt);
    if (slot != NIL) {
      bit[slot] = 1;
      return Out{1, NIL, 0, 0, 0, 0};
    }
    Out o{0, NIL, 0, 1, 0, 0};
    if (size >= cap) {
      int scans = 0;
      while (s_bit && scans < max_scan) {
        // reinsert the tail at the head, its bit cleared
        bit[s] = 0;
        scans += 1;
        if (a.n > 1) {
          pop_tail(a, s_nxt);
          push_head(a, s);
          s = a.tail;
          s_bit = bit[s];
          s_key = s2k[s];
          s_nxt = nxt[s];
        } else {
          s_bit = 0;  // a list of one (or none): the same slot again
        }
      }
      if (s_key != NIL) {
        k2s[s_key] = (Link)NIL;
        pop_tail(a, s_nxt);
      }
      o.evicted = s_key;
      o.head += scans;
      o.tail = 1;
      o.scan = scans;
    } else {
      s = size;
    }
    k2s[key] = (Link)s;
    s2k[s] = key;
    bit[s] = 0;
    push_head(a, s);
    size = min(size + 1, cap);
    return o;
  }

  // ---- SLRU: B = a (aux 0), T = b (aux 1)
  __device__ __forceinline__ Out slru_step(int key) {
    const int bt = tail_or_0(a);
    const int bt_key = s2k[bt], bt_nxt = nxt[bt];
    const int slot = k2s[key];
    issued(slot, bt_key, bt_nxt);
    if (slot != NIL) {
      const int in_t = aux[slot], p = prv[slot], n = nxt[slot];
      if (in_t) {
        if (slot != b.head) {
          unlink_at(b, p, n);
          push_head(b, slot);
        }
        return Out{1, NIL, 1, 1, 0, 0};
      }
      // promote to T's head; demote T's tail to B's head when T
      // overflows (T then holds two slots at least: the tail is another)
      unlink_at(a, p, n);
      aux[slot] = 1;
      push_head(b, slot);
      const bool demote = size_t_ + 1 > prot_cap;
      if (demote) {
        const int t = b.tail;
        unlink(b, t);
        aux[t] = 0;
        push_head(a, t);
      }
      size_t_ += demote ? 0 : 1;
      return Out{1, NIL, 1, 1 + demote, demote, 0};
    }
    const bool evict = size >= cap;
    int s = size, old = NIL;
    if (evict) {
      if (a.n > 0) {  // B's tail
        s = bt;
        old = bt_key;
        pop_tail(a, bt_nxt);
      } else {  // T's tail when B is empty; slot 0 when both are
        s = tail_or_0(b);
        old = s2k[s];
        if (old != NIL) unlink(b, s);
        size_t_ -= aux[s];
      }
      if (old != NIL) k2s[old] = (Link)NIL;
    }
    k2s[key] = (Link)s;
    s2k[s] = key;
    aux[s] = 0;
    push_head(a, s);
    size = min(size + 1, cap);
    return Out{0, old, 0, 1, evict, 0};
  }

  // ---- S3-FIFO: S = a (aux 0), M = b (aux 1), ghost ring.  m_* hold M's
  // tail (its bit, key and successor); `freed` is the slot this request
  // frees, which the bitmap learns of only if the request does not take
  // it back.  Returns whether M was empty (the reference's scan then
  // works on slot 0, whatever it holds).
  __device__ __forceinline__ bool s3_evict_m(Out& o, int& freed, int m_bit,
                                             int m_key, int m_nxt) {
    int scans = 0, s = tail_or_0(b);
    const bool empty = b.n == 0;
    if (!empty) {
      while (m_bit && scans < max_scan) {
        bit[s] = 0;
        scans += 1;
        if (b.n > 1) {
          pop_tail(b, m_nxt);
          push_head(b, s);
          s = b.tail;
          m_bit = bit[s];
          m_key = s2k[s];
          m_nxt = nxt[s];
        } else {
          m_bit = 0;
        }
      }
      k2s[m_key] = (Link)NIL;
      pop_tail(b, m_nxt);
    } else {
      for (;;) {
        if (!(bit[s] && scans < max_scan)) break;
        if (s2k[s] != NIL) to_head_occupied(s);
        bit[s] = 0;
        scans += 1;
      }
      m_key = s2k[s];
      if (m_key != NIL) {
        k2s[m_key] = (Link)NIL;
        unlink_occupied(s);
      }
    }
    if (m_key != NIL) {
      s2k[s] = NIL;
      freed = s;
    }
    aux[s] = 0;
    size_m -= 1;
    o.evicted = m_key;
    o.head += scans;
    o.tail += 1;
    o.scan += scans;
    return empty;
  }

  __device__ __forceinline__ Out s3fifo_step(int key, int n1) {
    const int st = tail_or_0(a), mt = tail_or_0(b);
    const int s_bit = bit[st], s_key = s2k[st], s_nxt = nxt[st];
    const int m_bit = bit[mt], m_key = s2k[mt], m_nxt = nxt[mt];
    const int g = ghost[gpos];
    const int slot = k2s[key];
    const int ghosts = gcnt[key];
    issued(slot, ghosts, s_bit, s_key, s_nxt, m_bit, m_key, m_nxt, g);
    const bool in_ghost = ghosts != 0;
    if (slot != NIL) {
      bit[slot] = 1;
      return Out{1, NIL, 0, 0, 0, 0};
    }
    Out o{0, NIL, 0, 0, 0, 0};
    int freed = NIL;
    if (in_ghost && size_m >= m_cap) s3_evict_m(o, freed, m_bit, m_key, m_nxt);
    if (!in_ghost && size_s >= s_cap) {
      const int t = st;  // S's tail; slot 0 when S is empty
      if (s_bit) {
        // promote S's tail to M's head, making room in M first
        const bool m_empty = size_m >= m_cap &&
                             s3_evict_m(o, freed, m_bit, m_key, m_nxt);
        if (a.n > 0 && !m_empty) {
          pop_tail(a, s_nxt);
          push_head(b, t);
        } else if (s2k[t] != NIL) {
          unlink_occupied(t);
          push_head(b, t);
        }
        aux[t] = 1;
        bit[t] = 0;
        size_s -= 1;
        size_m += 1;
        o.head += 1;
        o.tail += 1;
      } else {
        // evict S's tail into the ghost ring
        if (s_key != NIL) {
          k2s[s_key] = (Link)NIL;
          if (a.n > 0) pop_tail(a, s_nxt);
          else unlink_occupied(t);
          s2k[t] = NIL;
          freed = t;
        }
        if (g != NIL) gcnt[g] -= 1;
        ghost[gpos] = s_key;
        if (s_key != NIL) gcnt[s_key] += 1;
        gpos = gpos + 1 == ghost_cap ? 0 : gpos + 1;
        size_s -= 1;
        o.tail += 1;
        o.evicted = s_key;
      }
    }
    // place: the next warm-up slot while filling, else the first free one
    int s;
    if (size >= cap && freed != NIL && freed < cap && holes == 0) {
      s = freed;  // the only free slot below the capacity
    } else {
      if (freed != NIL) mark_free(freed);
      s = size < cap ? size : first_free(n1);
      if (s2k[s] != NIL) unlink_occupied(s);
      else mark_used(s);
    }
    k2s[key] = (Link)s;
    s2k[s] = key;
    aux[s] = in_ghost;
    bit[s] = 0;
    if (in_ghost) push_head(b, s);
    else push_head(a, s);
    size_s += in_ghost ? 0 : 1;
    size_m += in_ghost ? 1 : 0;
    size = min(size + 1, cap);
    o.head += 1;
    return o;
  }

  // ---- SIEVE: the hand walks from old to new and wraps to the tail
  __device__ __forceinline__ Out sieve_step(int key) {
    int s = hand != NIL ? hand : tail_or_0(a);
    int s_bit = bit[s], s_key = s2k[s], s_prv = prv[s], s_nxt = nxt[s];
    const int slot = k2s[key];
    issued(slot, s_bit, s_key, s_prv, s_nxt);
    if (slot != NIL) {
      bit[slot] = 1;
      return Out{1, NIL, 0, 0, 0, 0};
    }
    Out o{0, NIL, 0, 1, 0, 0};
    if (size >= cap) {
      int scans = 0, new_hand = NIL;
      if (a.n > 0) {
        // clear set bits up to the first clear one; after a full cycle
        // every bit is clear and the walk is back at its start
        while (s_bit) {
          bit[s] = 0;
          scans += 1;
          s = s_nxt != NIL ? s_nxt : a.tail;
          s_bit = bit[s];
          s_key = s2k[s];
          s_prv = prv[s];
          s_nxt = nxt[s];
        }
        new_hand = s_nxt;  // NIL at the head: restart from the tail
      }
      if (s_key != NIL) {
        k2s[s_key] = (Link)NIL;
        unlink_at(a, s_prv, s_nxt);
      }
      hand = new_hand;
      o.evicted = s_key;
      o.tail = 1;
      o.scan = scans;
    } else {
      s = size;
    }
    k2s[key] = (Link)s;
    s2k[s] = key;
    bit[s] = 0;
    push_head(a, s);
    size = min(size + 1, cap);
    return o;
  }

  __device__ __forceinline__ Out step(int key, float u, int n1) {
    if constexpr (POL == LRU || POL == FIFO || POL == PROB_LRU) {
      return list_step(key, u);
    } else if constexpr (POL == CLOCK) {
      return clock_step(key);
    } else if constexpr (POL == SLRU) {
      return slru_step(key);
    } else if constexpr (POL == S3FIFO) {
      return s3fifo_step(key, n1);
    } else {
      return sieve_step(key);
    }
  }
};

template <int POL, int LAYOUT>
__global__ void __launch_bounds__(WARP)
    replay_kernel(const int* __restrict__ pvecs, const float* __restrict__ qs,
                  const int* __restrict__ keys, const float* __restrict__ us,
                  const int* __restrict__ wins, int* __restrict__ hits,
                  int* __restrict__ evicted, int* __restrict__ ops,
                  int* __restrict__ cls, unsigned char* __restrict__ scratch,
                  int n_t, int key_space, int pad) {
  using Link = std::conditional_t<LAYOUT == ALL_GLOBAL, int, int16_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* const stage = reinterpret_cast<int*>(smem);
  int* const in_key = stage;
  float* const in_u = reinterpret_cast<float*>(stage + WARP);
  int* const in_win = stage + 2 * WARP;
  int* const out_hit = stage + 3 * WARP;
  int* const out_ev = stage + 4 * WARP;
  int* const out_ops = stage + 5 * WARP;
  int* const out_cls = stage + 6 * WARP;

  const int lane = threadIdx.x;
  const size_t l = blockIdx.x;
  const int lb = link_bytes(LAYOUT);
  const long long kb = key_region(POL, key_space, lb);
  Lane<POL, Link, LAYOUT == ALL_SHARED> L;
  if constexpr (LAYOUT == ALL_SHARED) {
    const uint32_t shared_state =
        (uint32_t)__cvta_generic_to_shared(smem) + (uint32_t)STAGE_BYTES;
    L.carve_keys(shared_state, key_space);
    L.carve_slots(shared_state + (uint32_t)kb, pad);
  } else {
    unsigned char* const mine =
        scratch + l * (kb + slot_region(POL, pad, lb));
    L.carve_keys(mine, key_space);
    L.carve_slots(mine + kb, pad);
  }
  const int* p = pvecs + l * N_PARAMS;
  L.cap = p[P_CAP];
  L.max_scan = p[P_MAX_SCAN];
  L.prot_cap = p[P_PROT_CAP];
  L.s_cap = p[P_S_CAP];
  L.m_cap = p[P_M_CAP];
  L.ghost_cap = p[P_GHOST_CAP];
  L.q = qs[l];
  L.init(key_space, pad, lane);
  const int n1 = (int)map_words(map_words(pad));
  __syncwarp();

  const size_t row = l * (size_t)n_t;
  // a batch ahead, in registers: request base + lane
  int k_next = 0, w_next = 0;
  float u_next = 0.0f;
  if (lane < n_t) {
    k_next = keys[row + lane];
    u_next = us[row + lane];
    w_next = wins[row + lane];
  }
  for (int base = 0; base < n_t; base += WARP) {
    in_key[lane] = k_next;
    in_u[lane] = u_next;
    in_win[lane] = w_next;
    const int ahead = base + WARP + lane;
    if (ahead < n_t) {
      k_next = keys[row + ahead];
      u_next = us[row + ahead];
      w_next = wins[row + ahead];
    }
    __syncwarp();
    if (lane == 0) {
      const int cnt = min(WARP, n_t - base);
      int key = in_key[0];
      for (int i = 0; i < cnt; ++i) {
        const int t = base + i;
        const int key_after = in_key[min(i + 1, WARP - 1)];
        const float u = in_u[i];
        const int w = in_win[i];
        const int e = L.exp[key];
        const Out o = L.step(key, u, n1);
        // fused delayed-hit classification (classify_inflight)
        const bool outstanding = t <= e;
        if (!outstanding && !o.hit) L.exp[key] = t + w;
        out_hit[i] = o.hit;
        out_ev[i] = o.evicted;
        out_ops[i] = o.delink | (o.head << 1) | (o.tail << 9) | (o.scan << 12);
        out_cls[i] = outstanding ? 2 : (o.hit ? 1 : 0);
        key = key_after;
      }
    }
    __syncwarp();
    const int t = base + lane;
    if (t < n_t) {
      hits[row + t] = out_hit[lane];
      evicted[row + t] = out_ev[lane];
      ops[row + t] = out_ops[lane];
      cls[row + t] = out_cls[lane];
    }
  }
}

// ---- host side

template <int POL, int LAYOUT>
int launch_as(const int* pvecs, const float* qs, const int* keys,
              const float* us, const int* wins, int* hits, int* evicted,
              int* ops, int* cls, unsigned char* scratch,
              long long scratch_bytes, int lanes, int n_t, int key_space,
              int pad, cudaStream_t stream) {
  const long long shared = region_bytes(POL, key_space, pad, LAYOUT, false);
  const long long need =
      (long long)lanes * region_bytes(POL, key_space, pad, LAYOUT, true);
  if (shared > 232448 || scratch_bytes < need ||
      (LAYOUT != ALL_GLOBAL && pad > 32768))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      replay_kernel<POL, LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 0 || n_t == 0) return 0;
  replay_kernel<POL, LAYOUT><<<lanes, WARP, shared, stream>>>(
      pvecs, qs, keys, us, wins, hits, evicted, ops, cls, scratch, n_t,
      key_space, pad);
  return (int)cudaGetLastError();
}

template <int POL>
int launch_policy(int layout, const int* pvecs, const float* qs,
                  const int* keys, const float* us, const int* wins,
                  int* hits, int* evicted, int* ops, int* cls,
                  unsigned char* scratch, long long scratch_bytes, int lanes,
                  int n_t, int key_space, int pad, cudaStream_t s) {
  switch (layout) {
    case ALL_SHARED:
      return launch_as<POL, ALL_SHARED>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, scratch, scratch_bytes, lanes, n_t, key_space, pad, s);
    case ALL_GLOBAL:
      return launch_as<POL, ALL_GLOBAL>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, scratch, scratch_bytes, lanes, n_t, key_space, pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of one block's shared memory (scratch = 0) or of one lane's
// device-memory scratch (scratch = 1) in a layout; -1 for a bad policy.
extern "C" long long replay_bytes(int policy, long long key_space,
                                  long long pad, int layout, int scratch) {
  if (policy < LRU || policy > SIEVE || layout < ALL_SHARED ||
      layout > ALL_GLOBAL)
    return -1;
  return region_bytes(policy, key_space, pad, layout, scratch != 0);
}

// Launch one warp per lane on `stream`; returns the cudaError_t.
extern "C" int replay_launch(int policy, int layout, const int* pvecs,
                             const float* qs, const int* keys, const float* us,
                             const int* wins, int* hits, int* evicted,
                             int* ops, int* cls, void* scratch,
                             long long scratch_bytes, int lanes, int n_t,
                             int key_space, int pad, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<unsigned char*>(scratch);
  switch (policy) {
    case LRU:
      return launch_policy<LRU>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    case FIFO:
      return launch_policy<FIFO>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    case PROB_LRU:
      return launch_policy<PROB_LRU>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    case CLOCK:
      return launch_policy<CLOCK>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    case SLRU:
      return launch_policy<SLRU>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    case S3FIFO:
      return launch_policy<S3FIFO>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    case SIEVE:
      return launch_policy<SIEVE>(layout, pvecs, qs, keys, us, wins, hits, evicted, ops, cls, sc, scratch_bytes, lanes, n_t, key_space, pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
