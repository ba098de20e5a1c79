// One optimal Huffman table per row, as one warp builds it: the merge of
// the reference's BuildOptimalTable, the length histogram and its
// rebalance to 16 bits, the (code size, symbol) ranks, the canonical codes
// and the DHT order (src/enc.cc:1311-1487 and :433-463).
//
// Bit-exact contract: the results equal the port's plain PyTorch version,
// ops/huffman_device.optimal_code_luts_plain, itself held against the JAX
// package.  Frequencies are int32 and add with wraparound, as there.
//
// The row is written once, as `table_row`, over a Warp policy of 32 lanes:
// `each(f)` runs f(lane, state) for the lanes, and the collectives (sum,
// min, ballot, broadcast, scan, equal-key counts, sync) combine the lanes'
// values.  merge_codesizes.cu supplies a policy on warp intrinsics, one
// lane a thread; a host build supplies one that loops over 32 lane states,
// so the same algorithm runs with g++ in the tests.  Everything here is
// __host__ __device__ (tests supply empty __host__/__device__ definitions),
// but table_row, which is SJ_TABLE_FN: merge_codesizes.cu narrows it to
// __device__, so that its policy needs no host bodies.
//
// The merge, as the reference sorts keys (freq << 9 | symbol): each step
// absorbs the node with the smallest (frequency, slot) key into the node
// with the next smallest, which keeps its slot; every leaf in either
// subtree gains a bit.  A fake symbol (slot `size`, frequency 1) is first
// absorbed into the smallest real symbol, since the reference appends it to
// its sorted keys without sorting again.  Each lane keeps its share of the
// live keys sorted in registers: the two smallest of the row are the
// smallest of the lanes' first keys, then of the lanes' first keys but the
// winner's, which offers its second.  The lanes that held them pop them;
// the merged key re-enters the lane that held the second, by a sorted
// insertion of two min/max operations a place.  Keys are 64-bit: the
// frequency's bit pattern with its sign flipped, over the slot, which
// orders wrapped sums as the int32 comparisons of the reference do.
#pragma once

#include <stdint.h>

#ifndef SJ_HD
#ifdef __CUDACC__
#define SJ_HD __host__ __device__ __forceinline__
#else
#define SJ_HD __host__ __device__ inline
#endif
#endif
#ifndef SJ_TABLE_FN
#define SJ_TABLE_FN SJ_HD
#endif

namespace sjpeg {

constexpr int kTableLanes = 32;
constexpr int kLaneSlots = 9;        // slot lane + 32 j, j < 9: 288 >= 257
constexpr int kMaxTableSize = 256;   // symbols a row may have
constexpr int kMaxBits = 32;         // code sizes clamp here
constexpr int kCodeBits = 16;        // and rebalance to this

// (frequency, slot) keys of any int32 frequencies
struct Key {
  using T = uint64_t;
  static constexpr T kNone = ~(uint64_t)0;
  SJ_HD static T make(int32_t freq, int slot) {
    return ((uint64_t)((uint32_t)freq ^ 0x80000000u) << 32) | (uint32_t)slot;
  }
  SJ_HD static int slot(T k) { return (int)(uint32_t)k; }
  SJ_HD static T merged(T small, T big) {
    const uint32_t f = (uint32_t)(small >> 32) + (uint32_t)(big >> 32) -
                       0x80000000u;      // the int32 sum, wrapping
    return ((uint64_t)f << 32) | (uint32_t)big;
  }
};

template <typename T>
SJ_HD T min_of(T a, T b) { return a < b ? a : b; }
template <typename T>
SJ_HD T max_of(T a, T b) { return a < b ? b : a; }

// One lane's registers.  key: its live keys, ascending, kNone past them;
// slot lane + 32 j: comp (its component) and cs (its code size), and bit j
// of `real` (a present symbol); pos[j]: where symbol lane + 32 j lands in
// the DHT order; count: lane l's count of codes of length l + 1; lead:
// set on the first lane of a rank chunk's lanes of one code size.
struct TableLane {
  Key::T key[kLaneSlots];
  int32_t comp[kLaneSlots];
  int32_t cs[kLaneSlots];
  int32_t pos[kLaneSlots];
  uint32_t real;
  int32_t count;
  int32_t lead;
};

// A warp's shared scratch.
struct TableShared {
  int32_t hist[kMaxBits];     // codes per length, then ranks' running starts
  int32_t bits16[kCodeBits];
  uint32_t first[kCodeBits];  // first code of each length
  int32_t cume[kCodeBits];    // codes shorter than each length
  int32_t syms[kMaxTableSize];
};

// One row: [width] int32 frequencies (symbols 0..size-1; width > size) ->
// lut [lut_size] packed (code << 16 | length) bit patterns, bits [16],
// nb_syms [1], syms [size].
struct TableRow {
  const int32_t* freq;
  int32_t* lut;
  int32_t* bits;
  int32_t* nb_syms;
  int32_t* syms;
  int size;
  int lut_size;
};

// Ascending x[0..n-1] with x[n-1] free (kNone) -> v inserted in order.
template <typename T>
SJ_HD void insert_sorted(T (&x)[kLaneSlots], T v) {
#pragma unroll
  for (int j = kLaneSlots - 1; j > 0; --j)
    x[j] = max_of(x[j - 1], min_of(x[j], v));
  x[0] = min_of(x[0], v);
}

// This lane's offer for the second smallest key, once the smallest is r1.
SJ_HD Key::T second_offer(const TableLane& s, Key::T r1) {
  return s.key[0] == r1 ? s.key[1] : s.key[0];
}

// One merge step in this lane: r1 (smallest key) is absorbed into r2 (next
// smallest).  Pops whichever of them it holds (they lead its list) and
// re-inserts the merged node where r2 was; the code-size update is
// `relabel`.
SJ_HD void take(TableLane& s, Key::T r1, Key::T r2) {
  using T = Key::T;
  const bool has1 = s.key[0] == r1;
  const bool has2 = (has1 ? s.key[1] : s.key[0]) == r2;
  T y[kLaneSlots];
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    const T next = j + 1 < kLaneSlots ? s.key[j + 1] : Key::kNone;
    y[j] = has2 ? next : s.key[j];
  }
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    const T next = j + 1 < kLaneSlots ? y[j + 1] : Key::kNone;
    s.key[j] = has1 ? next : y[j];
  }
  insert_sorted(s.key, has2 ? Key::merged(r1, r2) : Key::kNone);
}

// Every slot whose component is i1 or i2 gains a bit and joins i1.
SJ_HD void relabel(TableLane& s, int i1, int i2) {
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    const bool m = s.comp[j] == i1 || s.comp[j] == i2;
    s.cs[j] += m ? 1 : 0;
    s.comp[j] = m ? i1 : s.comp[j];
  }
}

// Lane `lane`'s slots of a row: present symbols, their keys sorted, each
// slot its own component with no bits yet.
SJ_HD void load_lane(TableLane& s, int lane, const int32_t* freq,
                     int size) {
  s.real = 0;
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) s.key[j] = Key::kNone;
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    const int slot = lane + kTableLanes * j;
    const int32_t f = slot < size ? freq[slot] : 0;
    s.comp[j] = slot;
    s.cs[j] = 0;
    s.pos[j] = 0;
    if (f > 0) s.real |= 1u << j;
    insert_sorted(s.key, f > 0 ? Key::make(f, slot) : Key::kNone);
  }
}

// Index of the highest set bit of m, -1 for none.
SJ_HD int highest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return 31 - __clz((int)m);
#else
  return m ? 31 - __builtin_clz(m) : -1;
#endif
}

// The change to length index i's count when the rebalance moves a pair of
// codes of length index l up (l - 1 gains one) and splits a code of length
// index k (k + 1 gains two; k = -1: none was found, index 0 gains two).
SJ_HD int32_t rebalance_delta(int i, int l, int k) {
  return 2 * (i == k + 1) - (i == k) + (i == l - 1) - 2 * (i == l);
}

// First code and count of shorter codes at length index l, from bits16,
// with the int32 wraparound of the reference's counters.
SJ_HD void first_code(const int32_t* bits16, int l, uint32_t& first,
                      int32_t& cume) {
  uint32_t f = 0, c = 0;
  for (int m = 0; m < l; ++m) {
    f = (f + (uint32_t)bits16[m]) << 1;
    c += (uint32_t)bits16[m];
  }
  first = f;
  cume = (int32_t)c;
}

// How many cumulative counts cums[l] (codes of length <= l + 1) are at most
// position p: the code at p has length index min(that, 15).
SJ_HD int lengths_before(const int32_t (&cums)[kCodeBits], int32_t p) {
  int n = 0;
#pragma unroll
  for (int l = 0; l < kCodeBits; ++l) n += cums[l] <= p ? 1 : 0;
  return n;
}

// Packed (code << 16) | len of position p, with n = lengths_before(p) and
// length index min(n, 15).
SJ_HD uint32_t packed_code(const TableShared& sh, int n, int32_t p,
                           uint32_t len) {
  const int l = n < kCodeBits - 1 ? n : kCodeBits - 1;
  const uint32_t code = sh.first[l] + (uint32_t)p - (uint32_t)sh.cume[l];
  return (code << 16) | len;
}

// The whole table of one row.  Warp provides, for f(lane, TableLane&):
// each(f); sum(f) (uint32); min(f) (Key::T); ballot(f); shfl(f, src)
// (int32); scan(f, g): g(lane, state, inclusive prefix sum of f);
// match(f, g): g(lane, state, lower lanes with the same f, lanes with it);
// add(int32_t* p, v): a shared counter shared by the lanes; sync().
template <typename Warp>
SJ_TABLE_FN void table_row(Warp& w, TableShared& sh, const TableRow& row) {
  using T = Key::T;
  const int size = row.size;

  // ---- merge -----------------------------------------------------------
  w.each([&](int lane, TableLane& s) { load_lane(s, lane, row.freq, size); });
  const int nb = (int)w.sum([&](int, TableLane& s) {
    uint32_t n = 0;
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) n += (s.real >> j) & 1u;
    return n;
  });
  // The code-size update of one merge in every lane, and of the fake's
  // slot in a warp-uniform copy: reading it back from its lane's register
  // array by a run-time index would put the arrays in local memory.
  int fake_comp = size, fake_cs = 0;
  auto relabel_all = [&](int i1, int i2) {
    w.each([&](int, TableLane& s) { relabel(s, i1, i2); });
    if (fake_comp == i1 || fake_comp == i2) {
      ++fake_cs;
      fake_comp = i1;
    }
  };
  int i1 = -1, i2 = -1;     // the last merge, relabelled one step late
  if (nb > 0) {             // the fake joins the smallest real symbol
    const T r1 = Key::make(1, size);
    const T r2 = w.min([&](int, TableLane& s) { return s.key[0]; });
    w.each([&](int, TableLane& s) { take(s, r1, r2); });
    i1 = Key::slot(r2);
    i2 = size;
  }
  const int steps = size - 1 > 1 ? size - 1 : 1;
  for (int step = 0, left = nb; step < steps && left > 1; ++step, --left) {
    const T r1 = w.min([&](int, TableLane& s) { return s.key[0]; });
    relabel_all(i1, i2);
    const T r2 = w.min([&](int, TableLane& s) { return second_offer(s, r1); });
    w.each([&](int, TableLane& s) { take(s, r1, r2); });
    i1 = Key::slot(r2);
    i2 = Key::slot(r1);
  }
  relabel_all(i1, i2);
  w.each([&](int lane, TableLane& s) {
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {   // clamp; 0 off the tree
      const bool active = ((s.real >> j) & 1u) ||
                          lane + kTableLanes * j == size;
      s.cs[j] = active ? min_of(s.cs[j], (int32_t)kMaxBits) : 0;
    }
  });
  const int32_t cs_fake = min_of(fake_cs, (int32_t)kMaxBits);

  // ---- length histogram (lane l: length l + 1) -------------------------
  w.each([&](int lane, TableLane&) { sh.hist[lane] = 0; });
  w.sync();
  w.each([&](int, TableLane& s) {
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j)
      if (s.cs[j] > 0) w.add(&sh.hist[s.cs[j] - 1], 1);
  });
  w.sync();
  w.each([&](int lane, TableLane& s) { s.count = sh.hist[lane]; });
  w.sync();

  // ---- ranks: stable (code size, symbol) order of the real symbols -----
  // real symbols of each length (the fake taken out), their running
  // starts, and the fake's place: after every real code no longer than
  // its own
  auto real_count = [&](int lane, TableLane& s) {
    return s.count - (lane == cs_fake - 1 ? 1 : 0);
  };
  w.scan(real_count, [&](int lane, TableLane& s, int32_t incl) {
    sh.hist[lane] = incl - real_count(lane, s);
    s.pos[0] = incl;        // parked until the fake's place is read
  });
  const int32_t fake_pos = cs_fake > 0 ? w.shfl([&](int, TableLane& s) {
    return s.pos[0];
  }, cs_fake - 1) : 0;
  w.sync();
  // 32 symbols a round; unrolled, so that j indexes registers
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    if (kTableLanes * j < size) {
      auto key = [&](int, TableLane& s) {
        return ((s.real >> j) & 1u) ? s.cs[j] : 0;
      };
      w.match(key, [&](int, TableLane& s, int lower, int same) {
        const bool real = (s.real >> j) & 1u;
        if (real) s.pos[j] = sh.hist[s.cs[j] - 1] + lower;
        s.lead = real && lower == 0 ? same : 0;
      });
      w.sync();
      w.each([&](int, TableLane& s) {
        if (s.lead) sh.hist[s.cs[j] - 1] += s.lead;
      });
      w.sync();
    }
  }

  // ---- rebalance to 16 bits (lane l: length l + 1) ---------------------
  if (w.ballot([&](int lane, TableLane& s) {
        return lane >= kCodeBits && s.count != 0;
      })) {
    for (int l = kMaxBits - 1; l >= kCodeBits; --l) {
      // the reference's walk down stops at the first NONZERO count, which
      // may have gone negative
      while (w.shfl([&](int, TableLane& s) { return s.count; }, l) > 0) {
        const uint32_t nz = w.ballot([&](int lane, TableLane& s) {
          return lane <= l - 2 && s.count != 0;
        });
        const int k = highest_bit(nz);
        w.each([&](int lane, TableLane& s) {
          s.count += rebalance_delta(lane, l, k);
        });
      }
    }
  }
  // drop the fake from the longest populated length
  const uint32_t nz16 = w.ballot([&](int lane, TableLane& s) {
    return lane < kCodeBits && s.count != 0;
  });
  const int mx = nz16 ? highest_bit(nz16) : 0;
  w.each([&](int lane, TableLane& s) {
    if (lane < kCodeBits)
      sh.bits16[lane] = nb > 0 ? s.count - (lane == mx ? 1 : 0) : 0;
  });
  w.sync();

  // ---- canonical codes -------------------------------------------------
  w.each([&](int lane, TableLane&) {
    if (lane < kCodeBits) first_code(sh.bits16, lane, sh.first[lane],
                                     sh.cume[lane]);
  });
  w.each([&](int lane, TableLane&) {
    for (int s = lane; s < size; s += kTableLanes) sh.syms[s] = 0;
  });
  w.sync();
  w.each([&](int lane, TableLane& s) {
    int32_t cums[kCodeBits];
#pragma unroll
    for (int l = 0; l < kCodeBits; ++l) cums[l] = sh.cume[l] + sh.bits16[l];
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      const int sym = lane + kTableLanes * j;
      if (sym >= size) continue;
      const bool real = (s.real >> j) & 1u;
      const int32_t p = s.pos[j] + (s.pos[j] >= fake_pos ? 1 : 0);
      const bool ok = real && p < nb;
      uint32_t packed = 0;
      if (ok) {
        const int n = lengths_before(cums, p);
        packed = packed_code(sh, n, p, (uint32_t)n + 1);
        sh.syms[p] = sym;
      }
      if (sym == 0 && fake_pos < nb && (!ok || fake_pos > p)) {
        // the reference inserts a 0 at the fake's place, and the later of
        // symbol 0's two writes to the LUT wins
        const int n = lengths_before(cums, fake_pos);
        packed = packed_code(sh, n, fake_pos,
                             (uint32_t)min_of(n, kCodeBits - 1) + 1);
      }
      if (sym < row.lut_size) row.lut[sym] = (int32_t)packed;
    }
    for (int sym = size + lane; sym < row.lut_size; sym += kTableLanes)
      row.lut[sym] = 0;
    if (lane < kCodeBits) row.bits[lane] = sh.bits16[lane];
    if (lane == 0) *row.nb_syms = nb;
  });
  w.sync();
  w.each([&](int lane, TableLane&) {
    for (int s = lane; s < size; s += kTableLanes) row.syms[s] = sh.syms[s];
  });
}

}  // namespace sjpeg
